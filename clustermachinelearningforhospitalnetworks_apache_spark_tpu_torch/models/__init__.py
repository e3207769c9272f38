"""Estimators and models."""
