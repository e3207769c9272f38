"""Schema types: named, typed columns, and the hospital event schema
(copied from the JAX package's ``core/schema.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

STRING = "string"
TIMESTAMP = "timestamp"
INT = "int"
FLOAT = "float"  # stored float64 host-side, cast on device

_NUMPY_DTYPES = {
    STRING: np.dtype(object),
    TIMESTAMP: np.dtype("datetime64[ns]"),
    INT: np.dtype(np.int64),
    FLOAT: np.dtype(np.float64),
}

_NUMERIC = {INT, FLOAT}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str
    #: False compiles to a not-null check in ``quality.RowValidator``
    nullable: bool = True

    def __post_init__(self) -> None:
        if self.dtype not in _NUMPY_DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}; one of {sorted(_NUMPY_DTYPES)}")

    @property
    def numpy_dtype(self) -> np.dtype:
        return _NUMPY_DTYPES[self.dtype]

    @property
    def is_numeric(self) -> bool:
        return self.dtype in _NUMERIC


@dataclass(frozen=True)
class Schema:
    """Ordered collection of named, typed fields."""

    fields: tuple[Field, ...]

    def __init__(self, fields: Iterable[Field | tuple[str, str]]):
        norm = tuple(f if isinstance(f, Field) else Field(*f) for f in fields)
        names = [f.name for f in norm]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in {names}")
        object.__setattr__(self, "fields", norm)

    def __iter__(self) -> Iterator[Field]:
        return iter(self.fields)

    def __len__(self) -> int:
        return len(self.fields)

    def __contains__(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"no field {name!r}; schema has {self.names}")

    def add(self, f: Field | tuple[str, str]) -> "Schema":
        f = f if isinstance(f, Field) else Field(*f)
        return Schema(self.fields + (f,))

    def select(self, names: Iterable[str]) -> "Schema":
        return Schema(tuple(self.field(n) for n in names))


def hospital_event_schema() -> Schema:
    """The reference script's streaming schema: 7 declared fields."""
    return Schema(
        [
            ("hospital_id", STRING),
            ("event_time", TIMESTAMP),
            ("admission_count", INT),
            ("current_occupancy", INT),
            ("emergency_visits", INT),
            ("seasonality_index", FLOAT),
            ("length_of_stay", FLOAT),
        ]
    )


#: the reference script's 4 feature columns and its regression label
FEATURE_COLS = (
    "admission_count",
    "current_occupancy",
    "emergency_visits",
    "seasonality_index",
)
LABEL_COL = "length_of_stay"
