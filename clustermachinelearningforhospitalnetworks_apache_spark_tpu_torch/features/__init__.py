"""Feature stages: assembler, standard scaler and binarizer."""
