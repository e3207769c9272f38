"""Evaluators."""
