"""Host-side tables (the subset the assembler needs)."""
