"""Feature stages: assembler and standard scaler."""
