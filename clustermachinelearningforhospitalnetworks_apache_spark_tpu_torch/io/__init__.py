"""Host I/O: the strict CSV reader."""
