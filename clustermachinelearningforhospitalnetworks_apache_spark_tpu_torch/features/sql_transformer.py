"""SQLTransformer — a pipeline stage that runs a SQL statement against its
input table (the JAX package's ``features/sql_transformer.py``).

Parity with ``pyspark.ml.feature.SQLTransformer``: the statement names
the incoming dataset ``__THIS__`` and the output is the query's result.
It runs through ``core.sql.execute``'s dispatcher: the canonical shapes
(``SELECT *, (v1 + v2) AS v3 FROM __THIS__``, numeric filters) run
compiled as torch ops on ``device`` (default the card), the rest on the
numpy interpreter (``explain`` shows which, per plan node).  JOINs reach
the tables passed in ``tables``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.table import Table
from ..io.model_io import register_model

_THIS = "__THIS__"


@register_model("SQLTransformer")
@dataclass(frozen=True)
class SQLTransformer:
    statement: str = "SELECT * FROM __THIS__"
    # extra named tables the statement may JOIN against (not persisted:
    # as in Spark, only the statement round-trips)
    tables: dict = field(default_factory=dict, compare=False)

    def __post_init__(self):
        if _THIS not in self.statement:
            raise ValueError(
                f"SQLTransformer statement must reference {_THIS}; got {self.statement!r}"
            )

    def _artifacts(self):
        if self.tables:
            # with no session catalog, a reloaded JOIN stage could never
            # resolve its extra tables: refuse instead of saving a dud
            raise ValueError(
                "SQLTransformer with extra `tables` cannot be persisted "
                f"(the statement references {sorted(self.tables)} which "
                "have no catalog to reload from); inline the data or "
                "re-attach tables after load"
            )
        return ("SQLTransformer", {"statement": self.statement}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(statement=params["statement"])

    def _resolver(self, table: Table):
        def resolve(name: str) -> Table:
            if name == "__this__":
                return table
            if name in self.tables:
                return self.tables[name]
            raise KeyError(
                f"unknown table {name!r}; the statement sees {_THIS} and "
                f"{sorted(self.tables) or 'no extra tables'}"
            )

        return resolve

    def transform(self, table: Table, device=None) -> Table:
        """The statement's result over ``table``; a compiled plan runs on
        ``device`` (default the card)."""
        from ..core.sql import execute

        if not isinstance(table, Table):
            raise TypeError(f"SQLTransformer transforms a Table; got {type(table).__name__}")
        return execute(self.statement.replace(_THIS, "__this__"), self._resolver(table),
                       device=device)

    def explain(self, table: Table) -> dict:
        """The planner's view of this stage's statement against ``table``:
        route, fingerprint, per-node supported / fallback decisions."""
        from ..core.sql import explain

        return explain(self.statement.replace(_THIS, "__this__"), self._resolver(table))
