"""Host-side tables, schemas, the seeded split, and the SQL engine: the
parser, the planner, the numpy interpreter and the compiled executor
over columns on the card."""

from .schema import (
    FEATURE_COLS,
    FLOAT,
    INT,
    LABEL_COL,
    STRING,
    TIMESTAMP,
    Field,
    Schema,
    hospital_event_schema,
)
from .split import random_split, split_indices, train_test_split
from .table import Table

__all__ = [
    "FEATURE_COLS", "FLOAT", "INT", "LABEL_COL", "STRING", "TIMESTAMP", "Field", "Schema",
    "Table", "hospital_event_schema", "random_split", "split_indices", "train_test_split",
]
