"""Host I/O: the CSV reader and writer, LIBSVM files, and model artifacts
(save, load, crash-safe swap, CRC32C integrity) and fit checkpoints in
the JAX package's format."""

from .csv import read_csv, read_csv_dir, write_csv
from .fit_checkpoint import FitCheckpointer
from .integrity import crc32c, crc32c_hex
from .libsvm import read_libsvm, write_libsvm
from .model_io import (
    CorruptArtifactError,
    artifact_fingerprint,
    attach_data_profile,
    load_data_profile,
    load_model,
    register_model,
    save_model,
)
from .native import native_available

__all__ = [
    "CorruptArtifactError", "FitCheckpointer", "artifact_fingerprint", "attach_data_profile",
    "crc32c", "crc32c_hex", "load_data_profile", "load_model", "native_available",
    "read_csv", "read_csv_dir", "read_libsvm", "register_model", "save_model", "write_csv",
    "write_libsvm",
]
