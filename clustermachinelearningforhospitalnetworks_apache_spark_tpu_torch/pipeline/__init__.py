"""The hospital pipeline: its model stage."""
