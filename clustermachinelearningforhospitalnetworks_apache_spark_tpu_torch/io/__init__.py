"""Host I/O: the strict CSV reader and the writer, and model artifacts (save, load,
crash-safe swap, CRC32C integrity) in the JAX package's format."""
