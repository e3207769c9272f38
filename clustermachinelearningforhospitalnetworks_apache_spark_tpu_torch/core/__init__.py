"""Host-side tables, schemas, the seeded split, and the SQL engine: the
parser, the planner, the numpy interpreter and the compiled executor
over columns on the card."""
