"""The hospital pipeline, end to end (``run_pipeline``), and its window
and model stage alone; and ``Pipeline`` / ``PipelineModel``, the
composable stage chains."""

from .hospital_pipeline import PipelineResult, run_pipeline
from .ml_pipeline import Pipeline, PipelineModel, load_pipeline_model

__all__ = ["Pipeline", "PipelineModel", "PipelineResult", "load_pipeline_model",
           "run_pipeline"]
