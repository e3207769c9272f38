"""Host-side tables, schemas and the seeded split."""
