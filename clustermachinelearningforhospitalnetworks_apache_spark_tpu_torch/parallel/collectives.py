"""Collective reductions over a mesh's data axis (the JAX package's
``parallel/collectives.py``).

Spark runs every distributed reduction of the reference through
``treeAggregate``; the JAX package through XLA's ``psum``.  The port's
``psum`` is a sum in ascending data-shard order: each shard's partials are
folded left to right, ``((s0 + s1) + s2) + …``, in float32 where the
partials are float32.

Across processes it is an ``all_gather`` of each shard's partials followed
by the same ordered fold on every rank — not an ``all_reduce``, whose order
(NCCL's ring, gloo's algorithms) is not the ascending order.  So a fit over
processes is bit-equal to the same fit in one process on the same mesh
shape, and every rank holds the same bits: the port's rule of determinism
without atomics (ROADMAP "Decided"), carried across shards.  A Lloyd step's
statistics are k·d + k + 1 floats (8.2 KB at k=256, d=8), so the gather
moves next to nothing.

Under a process group the collectives are SPMD: every rank calls them, in
the same order, and every rank owns at least one data shard of the mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from . import distributed
from .mesh import DATA_AXIS, Mesh, default_mesh


def gather_shards(parts: Sequence[torch.Tensor | None], mesh: Mesh) -> list[torch.Tensor]:
    """Every data shard's part, in data-shard order, on this process's
    first local shard's device.  ``parts[i]`` is shard i's tensor where
    this process owns it, else ``None``; all parts have one shape and
    dtype.  In one process this only moves the parts; under a process
    group it is one ``all_gather`` of each rank's parts."""
    D = mesh.shape[DATA_AXIS]
    if len(parts) != D:
        raise ValueError(f"{len(parts)} parts for {D} data shards")
    if not distributed.group_active() or len(mesh.local_data_shards()) == D:
        # one process, or a mesh this process owns whole: nothing to gather
        missing = [i for i, p in enumerate(parts) if p is None]
        if missing:
            raise ValueError(f"data shards {missing} have no part and no process group holds them")
        home = parts[0].device
        return [p.to(home) for p in parts]
    import torch.distributed as dist

    ctx = distributed.current()
    owners = [mesh.process(i, 0) for i in range(D)]
    per_rank = [[i for i in range(D) if owners[i] == r] for r in range(ctx.num_processes)]
    mine = per_rank[ctx.process_id]
    if any(not shards for shards in per_rank):
        raise ValueError(
            f"every process of the group must own a data shard of the mesh; owners {owners}")
    ref = parts[mine[0]]
    tdev = distributed.transport_device()
    send = torch.zeros((max(len(s) for s in per_rank),) + tuple(ref.shape), dtype=ref.dtype,
                       device=tdev)
    for s, i in enumerate(mine):
        send[s] = parts[i].to(tdev)
    recv = [torch.empty_like(send) for _ in range(ctx.num_processes)]
    dist.all_gather(recv, send)
    out: list = [None] * D
    for r, shards in enumerate(per_rank):
        for s, i in enumerate(shards):
            out[i] = recv[r][s].to(ref.device)
    return out


def ordered_sum(parts: Sequence[torch.Tensor | None], mesh: Mesh) -> torch.Tensor:
    """Σ over the data shards in ascending order, ``((p0 + p1) + p2) + …``,
    the same bits on every rank (see :func:`gather_shards`)."""
    got = gather_shards(parts, mesh)
    acc = got[0]
    for p in got[1:]:
        acc = acc + p
    return acc


def psum_data(parts: Sequence[torch.Tensor | None], mesh: Mesh | None = None) -> torch.Tensor:
    """The data axis' psum: :func:`ordered_sum`."""
    return ordered_sum(parts, mesh or default_mesh())


def pmean_data(parts: Sequence[torch.Tensor | None], mesh: Mesh | None = None) -> torch.Tensor:
    mesh = mesh or default_mesh()
    return ordered_sum(parts, mesh) / mesh.shape[DATA_AXIS]


def _flatten(tree) -> tuple[list, Callable[[list], Any]]:
    """(leaves, rebuild) of a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        keys = list(tree)
        subs = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        subs = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(s[0]) for s in subs]

    def rebuild(leaves):
        out, at = [], 0
        for (_, fn), n in zip(subs, sizes):
            out.append(fn(leaves[at:at + n]))
            at += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return [leaf for s in subs for leaf in s[0]], rebuild


def _shard_of(value, i: int):
    """Data shard i of a sharded input (a ShardedDataset's DeviceDataset,
    a MeshArray's part), or the value itself."""
    from .sharding import MeshArray, ShardedDataset

    if isinstance(value, ShardedDataset):
        return value.shard(i)
    if isinstance(value, MeshArray):
        return value.block(i)
    return value


def tree_aggregate(seq_op: Callable[[Any], Any], dataset_shards: Any, mesh: Mesh | None = None,
                   in_spec=None) -> Any:
    """Spark ``treeAggregate``: map each local data shard through
    ``seq_op`` (a nest of tensors: the sufficient statistics), then sum
    every leaf over the data shards in ascending order (:func:`ordered_sum`).

    ``dataset_shards`` is a ShardedDataset, a MeshArray, or a nest of
    MeshArrays laid out over ``mesh``'s data axis.  ``in_spec`` is the
    reference's and must be the rows layout (``None`` or ``("data",)``)."""
    from .sharding import MeshArray, ShardedDataset

    if in_spec is not None and tuple(in_spec) != (DATA_AXIS,):
        raise NotImplementedError(f"tree_aggregate lays rows over the data axis; got {in_spec}")
    inputs, rebuild_in = _flatten(dataset_shards)
    if mesh is None:
        mesh = next((v.mesh for v in inputs if isinstance(v, (MeshArray, ShardedDataset))),
                    None) or default_mesh()
    return aggregate_shards(lambda i: seq_op(rebuild_in([_shard_of(v, i) for v in inputs])),
                            mesh)


def aggregate_shards(stats_of: Callable[[int], Any], mesh: Mesh) -> Any:
    """The shard-sum rule of every fit and evaluator over a mesh:
    ``stats_of(i)`` (a nest of tensors, the sufficient statistics) once a
    local data shard ``i``, then every leaf :func:`ordered_sum`'d over the
    data shards in ascending order.  Leaves of one dtype travel in one
    gather: each shard's leaves are flattened into one vector, summed and
    cut back, and as the sum is elementwise the bits are those of one
    ``ordered_sum`` a leaf."""
    per_shard: list = [None] * mesh.shape[DATA_AXIS]
    for i in mesh.local_data_shards():
        per_shard[i] = _flatten(stats_of(i))
    leaves, rebuild = next(p for p in per_shard if p is not None)
    if len({t.dtype for t in leaves}) > 1:
        return rebuild([ordered_sum([None if p is None else p[0][k] for p in per_shard], mesh)
                        for k in range(len(leaves))])
    tot = ordered_sum([None if p is None else torch.cat([t.reshape(-1) for t in p[0]])
                       for p in per_shard], mesh)
    sums, at = [], 0
    for t in leaves:
        sums.append(tot[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return rebuild(sums)


def global_sum(x, w=None, dtype=torch.float32) -> torch.Tensor:
    """Σ x (× w) in ``dtype``: a MeshArray's shards each summed on its
    device, then in ascending shard order; a plain tensor in one sum."""
    from .sharding import MeshArray

    if isinstance(x, MeshArray):
        parts = []
        for i, xi in enumerate(x.data_blocks()):
            if xi is None:
                parts.append(None)
                continue
            v = xi.to(dtype)
            if w is not None:
                v = v * w.block(i).to(dtype)
            parts.append(v.sum())
        return ordered_sum(parts, x.mesh)
    x = torch.as_tensor(x).to(dtype)
    if w is not None:
        x = x * torch.as_tensor(w).to(dtype)
    return x.sum()
