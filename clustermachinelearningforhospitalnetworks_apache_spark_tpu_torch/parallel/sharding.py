"""Sharding: host numpy → padded, weighted tensors over a mesh (the JAX
package's ``parallel/sharding.py``).

Rows are laid out over the mesh's ``data`` axis as XLA lays out
``P("data")``: rows are padded to ``pad_rows(n, D)`` for ``D`` data shards,
shard *i* holds the contiguous padded rows ``[i·n_pad/D, (i+1)·n_pad/D)``,
and the pad rows sit at the end with weight 0, so every weighted reduction
ignores them.  The valid rows keep their global indices, so
:func:`sample_valid_rows` (and with it the k-means++ init) draws the same
rows on every mesh shape.

A mesh of one shard gives the single-device :class:`~..data.DeviceDataset`
unchanged (every path that ran before the mesh existed stays bit-identical),
unless a process group is active: then every fit is a group fit and its
data a :class:`ShardedDataset` of one shard.  A larger mesh gives a
:class:`ShardedDataset`: a (data, model) array of per-entry
``DeviceDataset``s (the rows are replicated over the model axis; a repeated
device holds them once) plus the mesh.  Under a process group each process
holds only the entries it owns.

:class:`MeshArray` is the port's sharded tensor: a global shape, a spec
(as ``Partitioner.spec`` resolves it) and the part of each local mesh
entry on its device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data import (  # noqa: F401  (re-exported: the reference's names)
    DeviceDataset,
    batch_rows,
    pad_slots,
    padded_slots,
    slot_mask,
    stack_ragged,
)
from ..data import device_dataset as _single_device_dataset
from ..data import sample_valid_rows as _single_sample_valid_rows
from ..data import unpad as _single_unpad
from . import distributed
from .collectives import gather_shards, ordered_sum
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, NamedSharding, default_mesh, single_device_mesh


class MeshArray:
    """A tensor laid out over a mesh: ``blocks[i, j]`` is the part that
    mesh entry (i, j) holds on its device (``None`` where another process
    owns the entry), split along each dimension the spec names and whole
    along the others."""

    def __init__(self, sharding: NamedSharding, shape: tuple, blocks: np.ndarray):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.blocks = blocks

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return next(b for b in self.blocks.flat if b is not None).dtype

    def block(self, i: int, j: int = 0) -> torch.Tensor | None:
        return self.blocks[i, j]

    def data_blocks(self) -> list:
        """Each data shard's part on its model-0 entry (``None`` where not
        local), in data-shard order."""
        return [self.blocks[i, 0] for i in range(self.blocks.shape[0])]

    def map_data(self, fn) -> "MeshArray":
        """``fn`` on each local data shard's part → a row-aligned
        MeshArray laid out over the data axis (replicated over the model
        axis; a repeated device holds it once)."""
        out = np.empty(self.blocks.shape, dtype=object)
        for i in self.mesh.local_data_shards():
            r = fn(self.blocks[i, 0])
            for j in range(self.blocks.shape[1]):
                out[i, j] = r.to(self.mesh.device(i, j))
        first = next(b for b in out.flat if b is not None)
        n = self.shape[0]
        return MeshArray(NamedSharding(self.mesh, (DATA_AXIS,) + (None,) * (first.dim() - 1)),
                         (n,) + tuple(first.shape[1:]), out)

    def numpy(self) -> np.ndarray:
        """The whole array on the host (gathered over the process group
        when one is active)."""
        spec = self.spec + (None,) * (self.ndim - len(self.spec))
        model_dim = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
        rows = []
        for i in range(self.blocks.shape[0]):
            if self.blocks[i, 0] is None:
                rows.append(None)
                continue
            parts = ([self.blocks[i, 0]] if model_dim is None else
                     [self.blocks[i, j].to(self.blocks[i, 0].device)
                      for j in range(self.blocks.shape[1])])
            rows.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=model_dim))
        if DATA_AXIS not in spec:
            return next(r for r in rows if r is not None).cpu().numpy()
        gathered = gather_shards(rows, self.mesh)
        return torch.cat([g.cpu() for g in gathered], dim=spec.index(DATA_AXIS)).numpy()

    def __repr__(self) -> str:
        return f"MeshArray(shape={self.shape}, spec={self.spec}, mesh={self.mesh.shape})"


def place(value, sharding: NamedSharding) -> MeshArray:
    """Split ``value`` (numpy or a tensor) along the dimensions the spec
    names onto each local mesh entry's device; whole dimensions are copied.
    A part already on its device is a view, and a repeated device holds
    each distinct part once."""
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    shape = tuple(value.shape)
    D, M = mesh.devices.shape
    sizes = {DATA_AXIS: D, MODEL_AXIS: M}
    for dim, ax in enumerate(spec):
        if ax is not None and shape[dim] % sizes[ax]:
            raise ValueError(
                f"dimension {dim} of {shape} does not split over {sizes[ax]} {ax!r} shards")
    blocks = np.empty((D, M), dtype=object)
    parts: dict = {}
    for i, j in np.ndindex(D, M):
        if not mesh.is_local(i, j):
            continue
        idx = []
        for dim, ax in enumerate(spec):
            if ax is None:
                idx.append(slice(None))
            else:
                step = shape[dim] // sizes[ax]
                pos = i if ax == DATA_AXIS else j
                idx.append(slice(pos * step, (pos + 1) * step))
        dev = mesh.device(i, j)
        key = (str(dev), tuple((s.start, s.stop) for s in idx))
        if key not in parts:
            part = value[tuple(idx)]
            if not isinstance(part, torch.Tensor):
                part = torch.from_numpy(np.ascontiguousarray(part))
            parts[key] = part.to(dev).contiguous()
        blocks[i, j] = parts[key]
    return MeshArray(NamedSharding(mesh, spec), shape, blocks)


def uses_shards(mesh: Mesh) -> bool:
    """True when data on ``mesh`` is a :class:`ShardedDataset`: more than
    one entry, or a process group (whose fits are group fits)."""
    return mesh.size > 1 or distributed.group_active()


class ShardedDataset:
    """A padded, weighted design matrix over a mesh: entry (i, j) holds
    data shard i as a :class:`~..data.DeviceDataset` on its device.
    ``x`` / ``y`` / ``w`` are the row-sharded :class:`MeshArray` views."""

    def __init__(self, mesh: Mesh, blocks: np.ndarray):
        self.mesh = mesh
        self.blocks = blocks

    @property
    def shards(self) -> tuple:
        """Each data shard's DeviceDataset on its model-0 entry (``None``
        where another process owns it)."""
        return tuple(self.blocks[i, 0] for i in range(self.blocks.shape[0]))

    def shard(self, i: int, j: int = 0) -> DeviceDataset | None:
        return self.blocks[i, j]

    def _view(self, name: str, spec: tuple) -> MeshArray:
        arr = np.empty(self.blocks.shape, dtype=object)
        for ij in np.ndindex(self.blocks.shape):
            if self.blocks[ij] is not None:
                arr[ij] = getattr(self.blocks[ij], name)
        first = next(a for a in arr.flat if a is not None)
        shape = (self.n_padded,) + tuple(first.shape[1:])
        return MeshArray(NamedSharding(self.mesh, spec), shape, arr)

    @property
    def x(self) -> MeshArray:
        return self._view("x", (DATA_AXIS, None))

    @property
    def y(self) -> MeshArray:
        return self._view("y", (DATA_AXIS,))

    @property
    def w(self) -> MeshArray:
        return self._view("w", (DATA_AXIS,))

    @property
    def n_padded(self) -> int:
        first = next(b for b in self.blocks.flat if b is not None)
        return first.n_padded * self.blocks.shape[0]

    @property
    def n_features(self) -> int:
        return next(b for b in self.blocks.flat if b is not None).n_features

    def count(self) -> torch.Tensor:
        """Σw over every shard (ascending shard order) as a 0-d tensor."""
        return ordered_sum([None if s is None else s.count() for s in self.shards], self.mesh)

    def __repr__(self) -> str:
        return (f"ShardedDataset(n_padded={self.n_padded}, n_features={self.n_features}, "
                f"mesh={self.mesh.shape})")


def map_shards(ds: ShardedDataset, fn) -> ShardedDataset:
    """``fn`` (DeviceDataset → DeviceDataset) on each local entry of
    ``ds`` where it lies: a transform's shard-by-shard form.  An entry
    that holds the same rows as its data shard's first (a repeated
    device) reuses that entry's result."""
    blocks = np.empty(ds.blocks.shape, dtype=object)
    done: dict = {}
    for i, j in np.ndindex(blocks.shape):
        b = ds.blocks[i, j]
        if b is not None:
            if id(b.x) not in done:
                done[id(b.x)] = fn(b)
            blocks[i, j] = done[id(b.x)]
    return ShardedDataset(ds.mesh, blocks)


def place_dataset(xp: np.ndarray, yp: np.ndarray, wp: np.ndarray, mesh: Mesh) -> ShardedDataset:
    """Padded host (or device) rows, labels and weights (``n_pad``
    divisible by the data axis) → a :class:`ShardedDataset`: shard i the
    contiguous rows ``[i·n_pad/D, (i+1)·n_pad/D)``."""
    x = place(xp, NamedSharding(mesh, (DATA_AXIS, None)))
    y = place(yp, NamedSharding(mesh, (DATA_AXIS,)))
    w = place(wp, NamedSharding(mesh, (DATA_AXIS,)))
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for ij in np.ndindex(blocks.shape):
        if x.blocks[ij] is not None:
            blocks[ij] = DeviceDataset(x=x.blocks[ij], y=y.blocks[ij], w=w.blocks[ij])
    return ShardedDataset(mesh, blocks)


def shard_dataset(ds: DeviceDataset, mesh: Mesh) -> ShardedDataset:
    """A single-device dataset laid out over ``mesh``: its padded rows (plus
    weight-0 rows up to ``pad_rows(n_padded, D)``) split into the data
    shards; a shard already on its device is a view, not a copy."""
    D = mesh.shape[DATA_AXIS]
    n = ds.n_padded
    extra = pad_rows(n, D) - n
    x, y, w = ds.x, ds.y, ds.w
    if extra:
        x = torch.cat([x, torch.zeros((extra, x.shape[1]), dtype=x.dtype, device=x.device)])
        y = torch.cat([y, torch.zeros((extra,), dtype=y.dtype, device=y.device)])
        w = torch.cat([w, torch.zeros((extra,), dtype=w.dtype, device=w.device)])
    return place_dataset(x, y, w, mesh)


#: below this many rows a device, a micro-batch runs on one device
#: (``microbatch_mesh``; the ``CMLHN_STREAM_SHARD_MIN_ROWS`` env var overrides)
DEFAULT_SHARD_MIN_ROWS_PER_DEVICE = 65536


def microbatch_mesh(n_rows: int, mesh: Mesh | None = None,
                    min_rows_per_device: int | None = None) -> Mesh:
    """The mesh a streaming micro-batch should run on: ``mesh`` when every
    device gets ≥ ``min_rows_per_device`` rows, else a one-entry mesh over
    its first device."""
    mesh = mesh or default_mesh()
    if min_rows_per_device is None:
        min_rows_per_device = int(
            os.environ.get("CMLHN_STREAM_SHARD_MIN_ROWS", DEFAULT_SHARD_MIN_ROWS_PER_DEVICE)
        )
    if mesh.size > 1 and n_rows < min_rows_per_device * mesh.shape[DATA_AXIS]:
        return single_device_mesh(mesh.devices.flat[0])
    return mesh


def mesh_of_dataset(ds) -> Mesh | None:
    """The mesh a dataset lives on: a ShardedDataset's, or a one-entry mesh
    over a DeviceDataset's device."""
    if isinstance(ds, ShardedDataset):
        return ds.mesh
    if isinstance(ds, DeviceDataset):
        return single_device_mesh(ds.x.device)
    return None


def place_replicated(mesh: Mesh, state: tuple) -> tuple:
    """Each non-``None`` entry of ``state`` replicated onto ``mesh``."""
    return tuple(None if s is None else replicate(s, mesh) for s in state)


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Rows over the data axis, features replicated."""
    return NamedSharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def pad_rows(n: int, multiple: int) -> int:
    """Smallest padded length >= n divisible by ``multiple`` (min 1 row/shard)."""
    if n == 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def chunk_layout(n_loc: int, target: int) -> tuple[int, int]:
    """(n_chunks, chunk) covering ``n_loc`` rows with static shapes."""
    chunk = min(max(target, 1), n_loc) if n_loc > 0 else 1
    n_chunks = -(-n_loc // chunk) if n_loc > 0 else 1
    return n_chunks, chunk


def chunked_pad(x: torch.Tensor, w: torch.Tensor, n_chunks: int, chunk: int):
    """Shard-local ``(n_loc, d)`` rows + weights padded to
    ``n_chunks*chunk`` and reshaped to ``(n_chunks, chunk, d)`` /
    ``(n_chunks, chunk)``; pad rows get weight 0."""
    pad = n_chunks * chunk - x.shape[0]
    xc = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(n_chunks, chunk, x.shape[1])
    wc = torch.nn.functional.pad(w, (0, pad)).reshape(n_chunks, chunk)
    return xc, wc


def pad_block_host(arr: np.ndarray, rows: int, dtype=np.float32) -> np.ndarray:
    """``arr`` zero-extended along axis 0 to ``rows`` (host)."""
    arr = np.asarray(arr)
    out = np.zeros((rows,) + arr.shape[1:], dtype=dtype)
    out[: arr.shape[0]] = arr
    return out


def shard_rows(x, mesh: Mesh | None = None) -> MeshArray:
    """A row-major array laid out over the data axis (already padded to a
    multiple of it, :func:`pad_rows`)."""
    mesh = mesh or default_mesh()
    return place(x, NamedSharding(mesh, (DATA_AXIS,) + (None,) * (np.ndim(x) - 1)))


def replicate(x, mesh: Mesh | None = None) -> MeshArray:
    """``x`` whole on every mesh entry's device."""
    mesh = mesh or default_mesh()
    return place(x, NamedSharding(mesh, ()))


def device_dataset(x, y=None, device=None, weights=None, mesh: Mesh | None = None):
    """Pad a host design matrix onto ``mesh`` (a :class:`ShardedDataset`;
    one shard gives the single-device DeviceDataset), or onto ``device``
    (default the card) without one."""
    if mesh is None:
        return _single_device_dataset(x, y, device=device, weights=weights)
    if device is not None:
        raise ValueError("pass a mesh or a device, not both")
    if not uses_shards(mesh):
        return _single_device_dataset(x, y, device=mesh.device(0, 0), weights=weights)
    # padded and weighted on the host as for one device, then split: an
    # empty input's one pad row becomes one a shard, as pad_rows(0, D) is D
    return shard_dataset(_single_device_dataset(x, y, device="cpu", weights=weights), mesh)


def unpad(values, n: int) -> np.ndarray:
    """A row-aligned result (a tensor or a MeshArray) on the host with
    padding stripped."""
    if isinstance(values, MeshArray):
        return values.numpy()[:n]
    return _single_unpad(values, n)


def rows_at(a: MeshArray, idx: np.ndarray) -> torch.Tensor:
    """The rows of a row-sharded MeshArray at global padded indices
    ``idx`` (ascending), on the host: each read on the shard that holds it,
    gathered in data-shard order (over the process group when one is
    active)."""
    D = a.mesh.shape[DATA_AXIS]
    per = a.shape[0] // D
    owner = idx // per
    counts = np.bincount(owner, minlength=D)
    top = max(int(counts.max()), 1) if len(counts) else 1
    parts = []
    for i, blk in enumerate(a.data_blocks()):
        if blk is None:
            parts.append(None)
            continue
        loc = torch.from_numpy(idx[owner == i] - i * per).to(blk.device)
        rows = torch.zeros((top,) + tuple(blk.shape[1:]), dtype=blk.dtype, device=blk.device)
        rows[: loc.numel()] = blk[loc]
        parts.append(rows)
    got = gather_shards(parts, a.mesh)
    return torch.cat([g[: counts[i]].cpu() for i, g in enumerate(got)])


def sample_valid_rows(ds, size: int, seed: int) -> np.ndarray:
    """A uniform sample of ≤ ``size`` valid rows on the host, as float64:
    ``default_rng(seed).choice`` over the valid rows' global indices, then
    sorted, so every mesh shape draws the same rows.  Only the weights and
    the sampled rows leave the devices."""
    if not isinstance(ds, ShardedDataset):
        return _single_sample_valid_rows(ds, size, seed)
    mesh = ds.mesh
    ws = gather_shards([None if s is None else s.w for s in ds.shards], mesh)
    w = torch.cat([p.cpu() for p in ws])
    valid_idx = np.flatnonzero(w.numpy() > 0)
    if valid_idx.size == 0:
        return np.empty((0, ds.n_features), dtype=np.float64)
    if valid_idx.size > size:
        rng = np.random.default_rng(seed)
        valid_idx = np.sort(rng.choice(valid_idx, size=size, replace=False))
    return rows_at(ds.x, valid_idx).numpy().astype(np.float64)
