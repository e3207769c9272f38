"""Model persistence — the JAX package's ``io/model_io.py``, same format.

Parity with MLlib's ``model.write().overwrite().save(path)`` at reference
``mllearnforhospitalnetwork.py:241-243`` (SURVEY.md §3.5): Spark writes
Parquet coefficient/tree-node files plus JSON metadata to HDFS.  Here a
model artifact is a directory containing

    metadata.json   — model class, framework version, params,
                      integrity manifest (CRC32C + size per payload),
                      optional data_profile (training-time feature
                      sketches — the drift-detection reference)
    arrays.npz      — every ndarray leaf of the model's pytree

with the same overwrite-or-fail-if-exists semantics.  A registry maps the
class name in metadata back to the Python class on load, so
``load_model(path)`` round-trips any registered model.

The file names, metadata keys, ``model_class`` tags and the payloads'
keys, dtypes and shapes are the JAX package's, so a directory written by
either package loads in the other (``np.savez`` of equal arrays writes
equal bytes).  Loading only reads numpy arrays; the loaded model computes
on the device its inputs lie on.

Durability contract (the fault sites are the JAX package's, so one
``FaultPlan`` kills a save of either package at the same boundary):

* a save is **staged** into ``<path>.staging`` and installed with two
  renames (displace the old artifact to ``<path>.old``, install the new
  one) — a crash at any point leaves either the previous committed
  artifact or the new one recoverable, never a half-written mix;
* :func:`load_model` repairs a crashed swap (restores a displaced
  artifact whose replacement never landed) before reading;
* payload bytes are checksummed (CRC32C) into the metadata manifest at
  save and verified at load, so bit rot or truncation raises a typed
  :class:`CorruptArtifactError` at the boundary instead of a shape error
  deep inside a model.
"""

from __future__ import annotations

import io as _io
import json
import os
import shutil
from typing import Any, Callable

import numpy as np

from ..utils.faults import fault_point, mangle_bytes
from ..utils.logging import get_logger
from ..version import __version__
from .integrity import checksum_record, verify_bytes

log = get_logger("io")


class CorruptArtifactError(RuntimeError):
    """A persisted artifact failed integrity verification (checksum/size
    mismatch, unreadable payload, torn metadata)."""

_REGISTRY: dict[str, Callable[[dict, dict], Any]] = {}

METADATA_FILE = "metadata.json"
ARRAYS_FILE = "arrays.npz"

#: model_class tag of the composite pipeline artifact (pipeline/ml_pipeline
#: .py) — defined here so load_model and PipelineModel share one constant
#: without an import cycle.
PIPELINE_CLASS = "PipelineModel"

#: Composite artifacts (directory layouts beyond metadata+arrays) register a
#: ``(path, meta) -> model`` loader here so ``load_model`` dispatches them
#: uniformly.  Values are import-path strings resolved lazily to avoid
#: module cycles: "pkg.module:ClassName" → ClassName.load(path, _meta=meta).
#: OneVsRest and the tuning models register themselves where they are
#: defined (``register_composite``).
_COMPOSITE_LOADERS: dict[str, str] = {
    PIPELINE_CLASS: "clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.pipeline.ml_pipeline:PipelineModel",
}


def register_composite(name: str, import_path: str) -> None:
    """Register a composite artifact class (``"pkg.module:Class"``) whose
    ``load(path, _meta=meta)`` rebuilds it."""
    _COMPOSITE_LOADERS[name] = import_path


def is_composite(obj: Any) -> bool:
    """True when ``obj`` saves through its own registered composite layout
    (PipelineModel, CrossValidatorModel, …) rather than metadata+arrays."""
    return type(obj).__name__ in _COMPOSITE_LOADERS and hasattr(obj, "save")


def validate_persistable(obj: Any, label: str = "model") -> None:
    """Raise TypeError if ``obj`` (or, recursively, anything inside a
    composite) cannot be saved — called BEFORE touching any target path so
    a failed save never destroys an existing artifact.  ``label`` carries
    the path context ("stage 0 → bestModel …") into the error."""
    deep = getattr(obj, "_validate_persistable", None)
    if deep is not None:
        deep(prefix=f"{label} → ")
    elif not (hasattr(obj, "_artifacts") or is_composite(obj)):
        raise TypeError(
            f"{label} ({type(obj).__name__}) is not persistable "
            "(no _artifacts); register it with io.model_io"
        )


def _load_composite(name: str, path: str, meta: dict) -> Any:
    import importlib

    mod_name, cls_name = _COMPOSITE_LOADERS[name].split(":")
    cls = getattr(importlib.import_module(mod_name), cls_name)
    return cls.load(path, _meta=meta)


def register_model(name: str):
    """Class decorator: register a ``from_artifacts(metadata, arrays)``
    constructor under ``name`` for ``load_model``."""

    def deco(cls):
        _REGISTRY[name] = cls.from_artifacts
        cls._artifact_name = name
        return cls

    return deco


def fsync_dir(path: str) -> None:
    """fsync a directory, so that a rename inside it survives power loss
    and not only a crash of the process: the one copy that the artifact
    swap, the streaming checkpoint and the unbounded table's sink use."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


#: sentinel dropped by prepare_artifact_dir and removed by
#: finalize_artifact_dir — its presence marks a torn in-place save
INCOMPLETE_SENTINEL = ".incomplete"


def repair_artifact_dir(path: str) -> None:
    """Undo/finish a crashed save so the committed artifact (if any) is
    loadable again:

    * ``<path>`` carrying the :data:`INCOMPLETE_SENTINEL` is a torn
      in-place (composite) save — discard it;
    * a committed artifact displaced to ``<path>.old`` whose replacement
      never landed (or was just discarded) IS the artifact — restore it.
    """
    old = path + ".old"
    if os.path.isdir(path) and os.path.exists(
        os.path.join(path, INCOMPLETE_SENTINEL)
    ):
        shutil.rmtree(path)
        log.warning("discarded torn artifact from crashed save", path=path)
    if os.path.exists(old) and not os.path.exists(path):
        os.replace(old, path)
        log.warning("restored displaced artifact after crashed save", path=path)


def prepare_artifact_dir(path: str, overwrite: bool) -> None:
    """Overwrite-or-fail semantics shared by the composite artifact
    writers (pipelines, CV/TVS selection models, OneVsRest), which write
    their layouts in place: the previous committed artifact is DISPLACED
    to ``<path>.old`` (not destroyed), and the fresh directory carries a
    sentinel until :func:`finalize_artifact_dir` commits it — so a crash
    anywhere in between leaves the previous artifact recoverable."""
    repair_artifact_dir(path)
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(f"{path} exists and overwrite=False")
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(path, old)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, INCOMPLETE_SENTINEL), "w") as f:
        f.write("")


def finalize_artifact_dir(path: str) -> None:
    """Commit an in-place (composite) save: drop the sentinel, make the
    removal durable, then discard the displaced previous artifact."""
    sentinel = os.path.join(path, INCOMPLETE_SENTINEL)
    if os.path.exists(sentinel):
        os.remove(sentinel)
    fsync_dir(path)
    shutil.rmtree(path + ".old", ignore_errors=True)


def write_metadata(path: str, meta: dict) -> None:
    """Atomic metadata.json write (tmp file + rename + fsync)."""
    tmp = path + ".tmp_meta"
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2, default=_json_default)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, METADATA_FILE))


def _npz_bytes(arrays: dict[str, np.ndarray]) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def save_model(
    path: str,
    name: str,
    metadata: dict,
    arrays: dict[str, np.ndarray],
    overwrite: bool = True,
    data_profile: dict | None = None,
) -> None:
    """Crash-consistent save: stage, checksum, then swap in two renames.

    Either the previous committed artifact or the new one survives a
    crash at any byte boundary — never a torn mix of the two.

    ``data_profile`` (a ``quality.DataProfile.to_dict()``) rides in the
    manifest so serving can rebuild the training-time distribution
    reference with :func:`load_data_profile`."""
    repair_artifact_dir(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists and overwrite=False")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)

    staging = path + ".staging"
    if os.path.exists(staging):
        shutil.rmtree(staging)
    os.makedirs(staging)
    fault_point("model_io.save.arrays", path=path)
    data = _npz_bytes(arrays)
    with open(os.path.join(staging, ARRAYS_FILE), "wb") as f:
        # the manifest checksums the INTENDED bytes; corrupt rules mangle
        # only what reaches the disk — exactly the failure CRC32C catches
        f.write(mangle_bytes("model_io.save.arrays", data, path=path))
        f.flush()
        os.fsync(f.fileno())
    fault_point("model_io.save.meta", path=path)
    meta = {
        "model_class": name,
        "framework_version": __version__,
        "params": metadata,
        "integrity": {ARRAYS_FILE: checksum_record(data)},
    }
    if data_profile is not None:
        meta["data_profile"] = data_profile
    write_metadata(staging, meta)
    fsync_dir(staging)

    # the swap: displace-then-install, each step atomic, recoverable from
    # any crash point by repair_artifact_dir
    fault_point("model_io.save.swap", path=path)
    old = None
    if os.path.exists(path):
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(path, old)
    os.replace(staging, path)
    fsync_dir(parent)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def attach_data_profile(path: str, data_profile: dict) -> None:
    """Add/replace the training-data profile in a saved artifact's
    manifest (atomic metadata rewrite).  The normal route for fitted
    models whose ``save()`` predates the profile parameter: save, then
    attach."""
    repair_artifact_dir(path)
    meta_path = os.path.join(path, METADATA_FILE)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptArtifactError(
            f"artifact metadata at {path!r} is unreadable: {e}"
        ) from e
    meta["data_profile"] = data_profile
    write_metadata(path, meta)
    fsync_dir(path)


def load_data_profile(path: str) -> dict | None:
    """The training-data profile saved in an artifact's manifest, or
    None when the artifact predates profiles.  Serving reads this to arm
    per-model drift monitors and input guards."""
    repair_artifact_dir(path)
    try:
        with open(os.path.join(path, METADATA_FILE)) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return None
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptArtifactError(
            f"artifact metadata at {path!r} is unreadable: {e}"
        ) from e
    return meta.get("data_profile")


def artifact_fingerprint(path: str) -> str | None:
    """Content identity of a saved artifact: the CRC32C already in its
    integrity manifest (None for composite/legacy artifacts without one).
    The lifecycle controller uses it as the model id in journal entries
    and health snapshots, and tests use it to assert a rollback left the
    prior artifact byte-for-byte untouched — without re-reading payloads.
    """
    repair_artifact_dir(path)
    try:
        with open(os.path.join(path, METADATA_FILE)) as f:
            meta = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    rec = (meta.get("integrity") or {}).get(ARRAYS_FILE)
    return None if rec is None else str(rec.get("crc32c"))


def load_model(path: str) -> Any:
    """Load any saved artifact, verifying content checksums when the
    manifest carries them.  Raises :class:`CorruptArtifactError` on torn
    metadata, checksum/size mismatch, or an unreadable payload — and
    repairs a crashed save's displaced artifact first."""
    repair_artifact_dir(path)
    try:
        with open(os.path.join(path, METADATA_FILE)) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptArtifactError(
            f"artifact metadata at {path!r} is unreadable: {e}"
        ) from e
    if meta.get("model_class") in _COMPOSITE_LOADERS:
        # composite artifact (own directory layout): delegate so load_model
        # works uniformly on anything save()d by the framework
        return _load_composite(meta["model_class"], path, meta)
    integrity = meta.get("integrity") or {}
    arrays_path = os.path.join(path, ARRAYS_FILE)
    arrays: dict[str, np.ndarray] = {}
    if os.path.exists(arrays_path):
        with open(arrays_path, "rb") as f:
            data = f.read()
        rec = integrity.get(ARRAYS_FILE)
        if rec is not None:
            problem = verify_bytes(data, rec)
            if problem is not None:
                raise CorruptArtifactError(
                    f"artifact payload {ARRAYS_FILE} at {path!r} failed "
                    f"integrity verification ({problem})"
                )
        try:
            with np.load(_io.BytesIO(data), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:  # noqa: BLE001 — any npz decode failure is
            # corruption from the caller's point of view
            raise CorruptArtifactError(
                f"artifact payload {ARRAYS_FILE} at {path!r} is undecodable: {e!r}"
            ) from e
    name = meta["model_class"]
    if name not in _REGISTRY:
        raise KeyError(f"no registered model class {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](meta["params"], arrays)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
