"""One declarative partitioner: every sharding decision as ordered rules
(the JAX package's ``parallel/partitioner.py``).

A :class:`Partitioner` holds an ordered list of ``(path-pattern →
logical-axis tuple)`` rules.  ``spec(path)`` walks the rules in order,
first match wins, unmatched paths get the family default (replicated);
logical axes (``data`` / ``model`` / ``tenant`` / ``replica``) resolve
through an alias table to mesh axes, so the same rule table serves a CPU
test mesh, one card and a multi-process mesh.  Resolution is cached per
(family, path, ndim[, mesh]).

The port's spec is the reference's ``PartitionSpec`` as a plain tuple of
mesh-axis names and ``None`` (equal to ``tuple(PartitionSpec(...))``);
``put(path, value, mesh)`` splits a tensor along the resolved dimensions
onto the mesh entries' devices (``sharding.place``), copying replicated
dimensions, and ``partition_devices`` splits a device list along the
replica axis for the serving fleet.

Registered families (the reference's table): ``rows``, ``kmeans``,
``gmm``, ``trees``, ``streaming_kmeans``, ``bisecting``, ``distance``,
``clustering_eval``, ``farm``, ``sql`` and ``fleet``.  In this slice the
port's KMeans fit places its centers through ``kmeans``; the other
families resolve as the reference's do and wait for their estimators'
mesh slice.

Host code: the rule tables are plain tuples, and torch is imported only
by ``put``, so the fleet's placement imports this module on any host.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from .mesh import DATA_AXIS, MODEL_AXIS

# --------------------------------------------------------------------------
# Logical axes
# --------------------------------------------------------------------------

#: logical axis vocabulary — rules name THESE, never mesh axes directly
DATA = "data"
MODEL = "model"
TENANT = "tenant"
REPLICA = "replica"
LOGICAL_AXES = (DATA, MODEL, TENANT, REPLICA)

#: default logical→physical mapping.  ``tenant`` is unsharded by default
#: (the CPU proxy and single-chip farms vmap over tenants on one device);
#: a tenant-bucketed pod registers a family with ``{TENANT: DATA_AXIS}``
#: and the same rule table shards the stack.  ``replica`` never maps to a
#: mesh axis — it partitions the DEVICE LIST (see :func:`partition_devices`).
DEFAULT_ALIASES: dict[str, str | None] = {
    DATA: DATA_AXIS,
    MODEL: MODEL_AXIS,
    TENANT: None,
    REPLICA: None,
}


def _match(pattern: str, path: str) -> bool:
    """fnmatch-style glob over "/"-joined tree paths (``*`` spans
    segments — rule authors keep patterns shallow on purpose)."""
    import fnmatch

    return fnmatch.fnmatchcase(path, pattern)


@dataclass(frozen=True)
class Rule:
    """One ordered rule: paths matching ``pattern`` get ``axes`` — a
    tuple of logical axis names (or ``None`` for an explicitly
    replicated dimension).  Trailing dimensions beyond ``len(axes)``
    are replicated (the ``ndim`` pad in :meth:`Partitioner.spec`)."""

    pattern: str
    axes: tuple[str | None, ...]

    def __post_init__(self):
        for a in self.axes:
            if a is not None and a not in LOGICAL_AXES:
                raise ValueError(
                    f"rule {self.pattern!r}: unknown logical axis {a!r}; "
                    f"one of {LOGICAL_AXES}"
                )


class Partitioner:
    """Ordered rules → partition specs, resolved once and cached.

    ``spec(path, ndim)`` is the universal entry;
    ``sharding(path, mesh, ndim)`` wraps it in a ``NamedSharding``
    descriptor; ``put(path, value, mesh)`` is the one-call placement
    most call sites want."""

    def __init__(
        self,
        family: str,
        rules: Sequence[Rule | tuple[str, tuple]],
        default: tuple[str | None, ...] = (),
        aliases: Mapping[str, str | None] | None = None,
    ):
        self.family = family
        self.rules: tuple[Rule, ...] = tuple(
            r if isinstance(r, Rule) else Rule(r[0], tuple(r[1]))
            for r in rules
        )
        self.default = tuple(default)
        self.aliases = dict(DEFAULT_ALIASES)
        if aliases:
            self.aliases.update(aliases)
        self._spec_cache: dict[tuple, Any] = {}
        self._lock = threading.Lock()

    # ---------------------------------------------------------- resolution
    def match(self, path: str) -> Rule | None:
        """First matching rule in registration order, or None (default)."""
        for r in self.rules:
            if _match(r.pattern, path):
                return r
        return None

    def axes_for(self, path: str) -> tuple[str | None, ...]:
        r = self.match(path)
        return r.axes if r is not None else self.default

    def spec(self, path: str, ndim: int | None = None):
        """The resolved partition spec for ``path``.

        ``ndim`` pads the spec with replicated trailing dims to exactly
        ``ndim`` entries (a full-rank spec, as the reference's); it is an
        error for a rule to name more axes than the value has dims.
        Cached per (path, ndim) — rule matching and alias resolution
        run once per distinct lookup, not per batch.  → a tuple of mesh
        axis names and ``None``."""
        key = (path, ndim)
        spec = self._spec_cache.get(key)
        if spec is not None:
            return spec
        axes = self.axes_for(path)
        if ndim is not None:
            if len(axes) > ndim:
                raise ValueError(
                    f"{self.family}:{path!r} rule names {len(axes)} axes "
                    f"but the value has ndim={ndim}"
                )
            axes = axes + (None,) * (ndim - len(axes))
        resolved = tuple(
            self.aliases.get(a) if a is not None else None for a in axes
        )
        spec = tuple(resolved)
        with self._lock:
            self._spec_cache[key] = spec
        return spec

    def sharding(self, path: str, mesh=None, ndim: int | None = None):
        """``NamedSharding(mesh, spec(path, ndim))`` — mesh defaults to
        the cluster-aware default (the host-major mesh once
        ``distributed.initialize`` has made a process group, else the
        process default mesh)."""
        return _named_sharding(
            self, mesh if mesh is not None else active_mesh(),
            path, ndim,
        )

    def put(self, path: str, value, mesh=None):
        """Place ``value`` (numpy or a tensor) on the mesh under this
        family's rule for ``path``: a :class:`~.sharding.MeshArray` whose
        entry (i, j) holds its part on that entry's device."""
        from .sharding import place

        ndim = getattr(value, "ndim", None)
        return place(value, self.sharding(path, mesh, ndim=ndim))

    def shard_tree(self, tree, mesh=None, prefix: str = ""):
        """Place every array leaf of a (possibly nested) dict by its
        "/"-joined path — the whole-state entry used by checkpoint
        restore and the distributed bootstrap."""
        if isinstance(tree, Mapping):
            return {
                k: self.shard_tree(
                    v, mesh, f"{prefix}/{k}" if prefix else str(k)
                )
                for k, v in tree.items()
            }
        return self.put(prefix, tree, mesh)

    # ---------------------------------------------------------- geometry
    def data_shards(self, mesh) -> int:
        """Physical size of the logical data axis on ``mesh`` — the row
        divisibility unit every padded batch honors."""
        phys = self.aliases.get(DATA)
        if phys is None or phys not in mesh.shape:
            return 1
        return int(mesh.shape[phys])

    def round_rows(self, n: int, mesh=None) -> int:
        """``n`` rounded UP to a multiple of the data-axis size — the
        one chunk/block multiple serving and out-of-core streaming
        formerly derived from ``mesh.shape`` independently."""
        m = self.data_shards(mesh if mesh is not None else active_mesh())
        return -(-int(n) // m) * m

    def describe(self) -> list[dict]:
        """Rule table as data (docs/debugging): pattern → axes rows in
        match order, then the default."""
        rows = [
            {"pattern": r.pattern, "axes": list(r.axes)} for r in self.rules
        ]
        rows.append({"pattern": "<default>", "axes": list(self.default)})
        return rows


# --------------------------------------------------------------------------
# Mesh-level resolution cache
# --------------------------------------------------------------------------

_SHARDING_CACHE: dict[tuple, Any] = {}
_SHARDING_LOCK = threading.Lock()


def _named_sharding(pt: Partitioner, mesh, path: str, ndim: int | None):
    key = (pt.family, path, ndim, mesh)
    s = _SHARDING_CACHE.get(key)
    if s is None:
        from .mesh import NamedSharding

        s = NamedSharding(mesh, pt.spec(path, ndim))
        with _SHARDING_LOCK:
            _SHARDING_CACHE[key] = s
    return s


def resolution_cache_size() -> int:
    """Observability/testing: distinct (family, path, ndim, mesh)
    resolutions currently cached."""
    return len(_SHARDING_CACHE)


def active_mesh():
    """The cluster-aware default mesh: under an initialized multi-process
    runtime the host-major mesh (``parallel.distributed.cluster_mesh``);
    otherwise the ordinary process-local default."""
    from .distributed import cluster_mesh
    from .mesh import default_mesh

    m = cluster_mesh()
    return m if m is not None else default_mesh()


# --------------------------------------------------------------------------
# Replica axis: partitioning the device LIST (fleet placement)
# --------------------------------------------------------------------------

def partition_devices(
    devices: Sequence[Any], n_replicas: int
) -> tuple[tuple[Any, ...], ...]:
    """Partition a device list along the logical replica axis: a
    contiguous even split (remainder spread over the first replicas);
    with fewer devices than replicas, round-robined single-device
    slices (the oversubscribed CPU-proxy topology — callers log it).

    The serving fleet's split (``serve/fleet/placement.py`` imports it
    from here), declared next to data/model/tenant instead of being
    private fleet arithmetic."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    devs = tuple(devices)
    if not devs:
        raise ValueError("no devices to partition into replica slices")
    if n_replicas > len(devs):
        return tuple(
            (devs[i % len(devs)],) for i in range(n_replicas)
        )
    per, extra = divmod(len(devs), n_replicas)
    out, start = [], 0
    for i in range(n_replicas):
        width = per + (1 if i < extra else 0)
        out.append(devs[start : start + width])
        start += width
    return tuple(out)


# --------------------------------------------------------------------------
# Family registry
# --------------------------------------------------------------------------

_FAMILIES: dict[str, Partitioner] = {}
_REGISTRY_LOCK = threading.Lock()


def register_family(
    name: str,
    rules: Sequence[Rule | tuple[str, tuple]],
    default: tuple[str | None, ...] = (),
    aliases: Mapping[str, str | None] | None = None,
) -> Partitioner:
    """Register (or re-register) a family's rule table.  Re-registering
    drops that family's cached resolutions — a test that installs toy
    rules cannot leak stale shardings into the next test."""
    pt = Partitioner(name, rules, default=default, aliases=aliases)
    with _REGISTRY_LOCK:
        _FAMILIES[name] = pt
    with _SHARDING_LOCK:
        for key in [k for k in _SHARDING_CACHE if k[0] == name]:
            del _SHARDING_CACHE[key]
    return pt


def family(name: str) -> Partitioner:
    """The registered partitioner for ``name`` — loud on unknown
    families: a typo'd family silently defaulting to replicated would
    un-shard a model without failing a single test."""
    try:
        return _FAMILIES[name]
    except KeyError:
        raise KeyError(
            f"no partitioner family {name!r}; registered: "
            f"{sorted(_FAMILIES)}"
        ) from None


# --------------------------------------------------------------------------
# Built-in rule tables (the former call sites, one per family)
# --------------------------------------------------------------------------

#: generic row-parallel batches: (n, d) matrices and (n,) vectors shard
#: over the data axis, everything else replicates
register_family("rows", [
    ("batch/*", (DATA,)),
])

#: Lloyd's algorithm: batch over data, center state over the model axis,
#: psum'd statistics land model-sharded, scalars replicate
register_family("kmeans", [
    ("batch/*", (DATA,)),
    ("state/*", (MODEL,)),
    ("stats/*", (MODEL,)),
])

#: EM fit: batch over data, all parameters/hyperparameters replicated;
#: predict's per-row outputs ride the data axis
register_family("gmm", [
    ("batch/*", (DATA,)),
    ("rows/*", (DATA,)),
])

#: histogram trees: everything column-major — the ROW axis is dim 1 of
#: the (T, n) binned matrix / label / weight / bootstrap stacks
register_family("trees", [
    ("cols/*", (None, DATA)),
])

#: streaming drain: ragged batches stacked to (B, R, d) — rows are dim 1
register_family("streaming_kmeans", [
    ("stack/*", (None, DATA)),
])

#: bisecting kmeans: row-parallel batch, replicated split state
register_family("bisecting", [
    ("batch/*", (DATA,)),
])

#: chunked assignment kernel: rows over data, centers replicated
register_family("distance", [
    ("rows/*", (DATA,)),
    ("const/*", ()),
])

#: silhouette evaluator: all three operands row-aligned over data
register_family("clustering_eval", [
    ("rows/*", (DATA,)),
])

#: model farm: tenant-stacked (T, R, d) arrays.  TENANT aliases to None
#: here (single-runtime vmap over tenants); a tenant-bucketed pod
#: re-registers with ``aliases={TENANT: DATA_AXIS}`` and the same rules
#: shard the stack — the placement decision is this table, not farm code
register_family("farm", [
    ("stack/*", (TENANT,)),
])

#: SQL device-column buckets: replicated onto the (single-device) SQL
#: executor mesh — the compiled-query row buckets never shard
register_family("sql", [
    ("column", ()),
])

#: serving fleet: no array axes — the replica axis partitions the device
#: list itself (see :func:`partition_devices`)
register_family("fleet", [])
