"""Model selection: parameter grids, cross-validation and the train /
validation split."""

from .tuning import (
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)

__all__ = [
    "CrossValidator",
    "CrossValidatorModel",
    "ParamGridBuilder",
    "TrainValidationSplit",
    "TrainValidationSplitModel",
]
