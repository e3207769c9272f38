"""Mid-training checkpoint/resume for iterative fits (the JAX package's
``io/fit_checkpoint.py``, same layout, so either package resumes a
checkpoint the other wrote).

A preempted KMeans, GaussianMixture or out-of-core forest fit resumes
from its last committed iteration (or tree level) instead of starting
over.  The commit discipline is the stream WAL's, scaled to arrays:

    <dir>/step-<n>/arrays.npz + meta.json     — the state at iteration n
    <dir>/COMMIT                              — {step, signature}, written
                                                 last via atomic rename

A checkpoint is visible only after COMMIT lands, so a crash at any point
leaves either the previous commit or the new one, never a torn state.
``signature`` holds every parameter that shapes the trajectory
(estimator, k, seed, a fingerprint of the data, …); resuming against a
different signature raises instead of continuing the wrong run.  The
fault sites (``fit_ckpt.save.arrays``, ``fit_ckpt.save.commit``,
``fit_ckpt.post_commit``, ``fit_ckpt.resume``) and the CRC32C record of
the payload are the JAX package's.
"""

from __future__ import annotations

import hashlib
import io as _io
import json
import os
import shutil

import numpy as np
import torch

from ..utils.faults import fault_point, mangle_bytes
from ..utils.logging import get_logger
from .integrity import checksum_record, verify_bytes
from .model_io import CorruptArtifactError

log = get_logger("io")

COMMIT_FILE = "COMMIT"


def _host(a) -> np.ndarray:
    """A numpy array, CPU tensor or CUDA tensor as contiguous host bytes."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a))


def data_fingerprint(x, w=None, sample: int = 1024) -> str:
    """Cheap deterministic identity of a dataset: the hash of an evenly
    strided row sample (the rows at the same ``linspace`` indices, in
    their own dtype, as the JAX package hashes them).  A row-sharded
    :class:`~..parallel.sharding.MeshArray` is sampled over its global
    padded rows, each row read from the shard that holds it, so the
    signature is the JAX package's for the same rows and mesh shape.
    Estimators put it in the checkpoint signature so resuming against
    different data of the same shape raises."""
    from ..parallel.sharding import MeshArray, rows_at

    n = x.shape[0]
    idx = np.linspace(0, max(n - 1, 0), num=min(sample, n), dtype=np.int64)

    def rows(a):
        if isinstance(a, MeshArray):
            return _host(rows_at(a, idx))
        if isinstance(a, torch.Tensor):
            return _host(a[torch.from_numpy(idx).to(a.device)])
        return _host(a[idx])

    h = hashlib.sha1(rows(x).tobytes())
    if w is not None:
        h.update(rows(w).tobytes())
    return h.hexdigest()[:16]


def array_fingerprint(a) -> str:
    """Identity hash of one array (warm-start state and other
    trajectory-shaping inputs go into checkpoint signatures through it)."""
    return hashlib.sha1(_host(a).tobytes()).hexdigest()[:16]


def fsync_dir(path: str) -> None:
    """fsync a directory so renames inside it survive power loss, not just
    a process crash."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".")


class FitCheckpointer:
    """Commit-then-prune checkpointer for an iterative fit.

    ``keep`` commits are retained (≥ 1) so a crash during a save never
    destroys the only resumable state.  Single writer: a directory belongs
    to one live fit at a time; construction repairs what a crashed save
    left behind."""

    def __init__(self, path: str, signature: dict, keep: int = 2):
        self.path = path
        self.signature = signature
        self.keep = max(keep, 1)
        os.makedirs(path, exist_ok=True)
        self._recover_crashed_save()

    def _recover_crashed_save(self) -> None:
        """Restore a displaced committed step whose replacement never
        landed, then drop leftover staging directories."""
        repaired = False
        for name in os.listdir(self.path):
            if name.startswith(".old-step-"):
                step_dir = os.path.join(self.path, name.replace(".old-", "", 1))
                old_dir = os.path.join(self.path, name)
                if not os.path.exists(step_dir):
                    # crash between displacing the old step and installing
                    # the new one: the displaced copy is the real state
                    os.replace(old_dir, step_dir)
                    repaired = True
                else:
                    shutil.rmtree(old_dir, ignore_errors=True)
        if repaired:
            # durable before a later save displaces or prunes again
            fsync_dir(self.path)
        for name in os.listdir(self.path):
            if name.startswith(".tmp-step-"):
                shutil.rmtree(os.path.join(self.path, name), ignore_errors=True)

    # -- write ----------------------------------------------------------
    def save(self, step: int, arrays: dict, extra: dict | None = None) -> None:
        """Persist iteration ``step``.  ``arrays`` values are arrays or
        tensors (on any device); ``extra`` is small JSON state."""
        step_dir = os.path.join(self.path, f"step-{step}")
        tmp_dir = os.path.join(self.path, f".tmp-step-{step}")
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        fault_point("fit_ckpt.save.arrays", path=self.path, step=step)
        buf = _io.BytesIO()
        np.savez(buf, **{k: _host(v) for k, v in arrays.items()})
        data = buf.getvalue()
        with open(os.path.join(tmp_dir, "arrays.npz"), "wb") as f:
            # checksum the intended bytes, mangle only what hits the disk
            f.write(mangle_bytes("fit_ckpt.save.arrays", data, path=self.path))
            f.flush()
            os.fsync(f.fileno())
        _atomic_write_json(
            os.path.join(tmp_dir, "meta.json"),
            {
                "step": step,
                "extra": extra or {},
                "integrity": {"arrays.npz": checksum_record(data)},
            },
        )
        old_dir = None
        if os.path.exists(step_dir):
            # a re-save of a committed step displaces it, so a crash before
            # the new COMMIT still leaves a resumable copy
            old_dir = os.path.join(self.path, f".old-step-{step}")
            if os.path.exists(old_dir):
                shutil.rmtree(old_dir)
            os.replace(step_dir, old_dir)
        os.replace(tmp_dir, step_dir)
        fsync_dir(self.path)
        # the commit point: everything above is invisible until this lands
        fault_point("fit_ckpt.save.commit", path=self.path, step=step)
        _atomic_write_json(
            os.path.join(self.path, COMMIT_FILE),
            {"step": step, "signature": self.signature},
        )
        fault_point("fit_ckpt.post_commit", path=self.path, step=step)
        if old_dir is not None:
            shutil.rmtree(old_dir, ignore_errors=True)
        self._prune(keep_latest=step)

    def _prune(self, keep_latest: int) -> None:
        # step dirs newer than the commit point are orphans of a crashed
        # save: delete them rather than count them toward ``keep``
        for s in self._step_dirs():
            if s > keep_latest:
                shutil.rmtree(os.path.join(self.path, f"step-{s}"), ignore_errors=True)
        steps = sorted(s for s in self._step_dirs() if s <= keep_latest)
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            if s != keep_latest:
                shutil.rmtree(os.path.join(self.path, f"step-{s}"), ignore_errors=True)

    def _step_dirs(self) -> list[int]:
        out = []
        for name in os.listdir(self.path):
            if name.startswith("step-"):
                try:
                    out.append(int(name.split("-", 1)[1]))
                except ValueError:
                    pass
        return out

    # -- read -----------------------------------------------------------
    def _load_step(self, step: int):
        """Read and verify one committed step; raises CorruptArtifactError
        on a checksum or size mismatch, torn meta or an undecodable
        payload."""
        step_dir = os.path.join(self.path, f"step-{step}")
        try:
            with open(os.path.join(step_dir, "meta.json")) as f:
                meta = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CorruptArtifactError(
                f"step-{step} meta.json at {self.path!r} is unreadable: {e}"
            ) from e
        with open(os.path.join(step_dir, "arrays.npz"), "rb") as f:
            data = f.read()
        rec = (meta.get("integrity") or {}).get("arrays.npz")
        if rec is not None:
            problem = verify_bytes(data, rec)
            if problem is not None:
                raise CorruptArtifactError(
                    f"step-{step} arrays.npz at {self.path!r} failed "
                    f"integrity verification ({problem})"
                )
        try:
            with np.load(_io.BytesIO(data), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:  # noqa: BLE001 — any decode failure is corruption
            raise CorruptArtifactError(
                f"step-{step} arrays.npz at {self.path!r} is undecodable: {e!r}"
            ) from e
        return arrays, meta.get("extra", {})

    def resume(self):
        """→ (step, arrays dict, extra dict) from the last commit, or None
        without one.  Raises ValueError on a signature mismatch.  A
        corrupted committed step falls back to the newest older retained
        step that verifies; only when none does is CorruptArtifactError
        raised."""
        commit_path = os.path.join(self.path, COMMIT_FILE)
        if not os.path.exists(commit_path):
            return None
        # a crash here is a crash during recovery: a second resume must
        # land on the identical step
        fault_point("fit_ckpt.resume", path=self.path)
        with open(commit_path) as f:
            commit = json.load(f)
        if commit.get("signature") != self.signature:
            raise ValueError(
                "fit checkpoint signature mismatch: the checkpoint at "
                f"{self.path!r} was written by a different training config "
                f"({commit.get('signature')!r} != {self.signature!r}); "
                "point checkpoint_dir at a fresh directory or delete it"
            )
        committed = int(commit["step"])
        candidates = sorted((s for s in self._step_dirs() if s <= committed), reverse=True)
        last_err: CorruptArtifactError | None = None
        for step in candidates:
            try:
                arrays, extra = self._load_step(step)
            except (CorruptArtifactError, OSError) as e:
                last_err = e if isinstance(e, CorruptArtifactError) else (
                    CorruptArtifactError(str(e))
                )
                log.warning(
                    "corrupt fit-checkpoint step, trying previous commit",
                    path=self.path, step=step, error=str(e),
                )
                continue
            if step != committed:
                log.warning(
                    "resumed from older intact step after corruption",
                    path=self.path, committed=committed, resumed=step,
                )
            return step, arrays, extra
        raise last_err or CorruptArtifactError(
            f"no intact committed step found at {self.path!r}"
        )

    def clear(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)


__all__ = ["FitCheckpointer", "array_fingerprint", "data_fingerprint", "fsync_dir"]
