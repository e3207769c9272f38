"""The hospital pipeline, end to end (``run_pipeline``), and its window
and model stage alone."""
