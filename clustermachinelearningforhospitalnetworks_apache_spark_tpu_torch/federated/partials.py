"""The mergeable-partials contract (the JAX package's
``federated/partials.py``): one shape for every cross-silo statistic.

Host code, numpy only, copied from the reference almost line for line so
that merges, noise draws and journal payloads are ``==`` across the two
packages:

* :class:`Partials` — a named bundle of summation-mergeable arrays (plus
  an optional non-summation ``payload`` for sketch-like families), tagged
  with the silo, round, and the parameter version it was computed
  against, JSON round-trippable (f32→f64→f32 is exact) for the round
  journal;
* :func:`merge_partials` — the canonical **zero-initialized ascending-
  silo-order left fold**, the reduction shape of the estimators' own
  chunk folds (zero init, sequential f32 adds): results never depend on
  arrival order, only on silo ids;
* a family registry so non-summation families (``profile`` merges the
  port's :class:`~..quality.sketches.DataProfile` by Chan's
  parallel-moments rule, ``*.init`` families concatenate candidates) ride
  the same entry point;
* :func:`apply_clipped_noise` — the optional clipped-Gaussian (DP-style)
  knob applied at the ship boundary, with the reference's
  ``default_rng([seed, round, crc32(silo)])`` draws.

``models/`` imports this module, never the reverse.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field, replace
from typing import Callable, Mapping, Sequence

import numpy as np

__all__ = [
    "Partials", "FitState", "NoiseConfig", "merge_partials",
    "register_family", "family_mode", "apply_clipped_noise",
    "merge_profiles",
]


# --------------------------------------------------------------- payloads
def _array_payload(a: np.ndarray) -> dict:
    """JSON-exact array encoding: float32→float64 widening is exact, and
    JSON floats round-trip float64 exactly, so journaled partials restore
    bit-identical f32 arrays."""
    a = np.asarray(a)
    return {
        "dtype": a.dtype.name,
        "shape": list(a.shape),
        "data": a.astype(np.float64).ravel().tolist()
        if a.dtype.kind == "f"
        else a.ravel().tolist(),
    }


def _array_from_payload(p: Mapping) -> np.ndarray:
    return np.asarray(p["data"], dtype=p["dtype"]).reshape(p["shape"])


# --------------------------------------------------------------- Partials
@dataclass(frozen=True)
class Partials:
    """One silo's (or one merged round's) sufficient statistics.

    ``stats`` holds the summation-mergeable arrays; ``payload`` holds a
    family-specific non-summation body (e.g. a serialized
    :class:`~..quality.sketches.DataProfile`).  ``state_version`` pins
    the parameter version the statistics were computed against — merged
    partials from different versions describe different E-steps and must
    never fold together (enforced by :func:`merge_partials`)."""

    family: str
    stats: dict[str, np.ndarray] = field(default_factory=dict)
    payload: dict | None = None
    n_rows: float = 0.0          # Σw this partial summarizes
    silo_id: str = ""
    round_id: int = -1
    state_version: int = -1      # -1 = stateless family
    noised: bool = False         # clipped-noise applied at the ship boundary
    sources: tuple[str, ...] = ()  # contributing silo ids after a merge

    def to_payload(self) -> dict:
        return {
            "family": self.family,
            "stats": {k: _array_payload(v) for k, v in self.stats.items()},
            "payload": self.payload,
            "n_rows": self.n_rows,
            "silo_id": self.silo_id,
            "round_id": self.round_id,
            "state_version": self.state_version,
            "noised": self.noised,
            "sources": list(self.sources),
        }

    @classmethod
    def from_payload(cls, p: Mapping) -> "Partials":
        return cls(
            family=p["family"],
            stats={k: _array_from_payload(v) for k, v in p["stats"].items()},
            payload=p.get("payload"),
            n_rows=float(p["n_rows"]),
            silo_id=p["silo_id"],
            round_id=int(p["round_id"]),
            state_version=int(p["state_version"]),
            noised=bool(p.get("noised", False)),
            sources=tuple(p.get("sources", ())),
        )


@dataclass(frozen=True)
class FitState:
    """Coordinator-side fit state between rounds — the journaled unit.

    ``version`` counts applied rounds (it doubles as the
    ``state_version`` silo partials must carry to fold into the next
    update); ``params`` are the current model parameters as host arrays;
    ``meta`` carries family scalars (previous log-likelihood, accumulated
    row mass, …) that must survive a coordinator crash."""

    family: str
    version: int
    params: dict[str, np.ndarray] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    def to_payload(self) -> dict:
        return {
            "family": self.family,
            "version": self.version,
            "params": {k: _array_payload(v) for k, v in self.params.items()},
            "meta": self.meta,
        }

    @classmethod
    def from_payload(cls, p: Mapping) -> "FitState":
        return cls(
            family=p["family"],
            version=int(p["version"]),
            params={k: _array_from_payload(v) for k, v in p["params"].items()},
            meta=dict(p["meta"]),
        )


# --------------------------------------------------------- family registry
#: family -> merge mode: "sum" (zero-init ascending fold, the default),
#: "concat" (stack stats arrays along axis 0 — init-candidate families),
#: or a callable (sorted_parts) -> merged stats/payload override.
_FAMILY_MODES: dict[str, str | Callable] = {}


def register_family(name: str, mode: str | Callable = "sum") -> None:
    """Register a partials family's merge discipline.  Unregistered
    families default to ``"sum"`` — the bit-reproducible fold."""
    if isinstance(mode, str) and mode not in ("sum", "concat"):
        raise ValueError(f"unknown merge mode {mode!r}")
    _FAMILY_MODES[name] = mode


def family_mode(name: str) -> str | Callable:
    return _FAMILY_MODES.get(name, "sum")


def _merge_profile_payloads(parts: Sequence[Partials]) -> dict:
    """Ascending-silo-order DataProfile merge (Chan's parallel moments —
    exact counts, deterministic merged moments)."""
    from ..quality.sketches import DataProfile

    merged = DataProfile.from_dict(parts[0].payload)
    for p in parts[1:]:
        merged = merged.merge(DataProfile.from_dict(p.payload))
    return merged.to_dict()


register_family("linear")
register_family("kmeans")
register_family("gmm")
register_family("kmeans.init", "concat")
register_family("gmm.init", "concat")
register_family("profile", _merge_profile_payloads)


# ------------------------------------------------------------------ merge
def merge_partials(
    parts: Sequence[Partials],
    weights: Mapping[str, float] | None = None,
) -> Partials:
    """Merge per-silo partials into one — the coordinator's fold.

    The fold is **zero-initialized and ascends by silo id**, independent
    of arrival order, so a straggler that lands last produces the same
    bits as one that lands first.  For summation families the zero init
    + sequential f32 adds reproduce a chunk fold of zero-initialized
    chunks exactly (GaussianMixture's ``_em_pass``; including the +0 init
    absorbing any −0 partial), which is the bit-parity contract the tests
    pin.

    ``weights`` (silo id → scalar) is the per-silo contribution
    weighting: each silo's arrays and row mass scale by its weight
    before folding.  ``None`` (the default) skips the multiply entirely,
    keeping the fold pure adds — weighting is a modeling knob and
    forfeits bit-parity with the pooled fit."""
    if not parts:
        raise ValueError("merge_partials needs at least one partial")
    parts = sorted(parts, key=lambda p: p.silo_id)
    fam = parts[0].family
    ver = parts[0].state_version
    for p in parts[1:]:
        if p.family != fam:
            raise ValueError(
                f"cannot merge family {p.family!r} into {fam!r}"
            )
        if p.state_version != ver:
            raise ValueError(
                f"partials from different state versions ({p.state_version}"
                f" vs {ver}) describe different parameter sets — stale "
                "partials fold into a round of their own version or not "
                "at all"
            )
    keys = list(parts[0].stats)
    for p in parts[1:]:
        if list(p.stats) != keys:
            raise ValueError(
                f"stats keys differ across silos: {list(p.stats)} vs {keys}"
            )

    def scaled(p: Partials, k: str) -> np.ndarray:
        a = p.stats[k]
        if weights is None:
            return a
        w = np.asarray(weights.get(p.silo_id, 1.0), dtype=a.dtype)
        return a * w

    mode = family_mode(fam)
    payload = None
    if callable(mode):
        payload = mode(parts)
        stats = {}
    elif mode == "concat":
        stats = {
            k: np.concatenate([np.atleast_1d(scaled(p, k)) for p in parts])
            for k in keys
        }
    else:
        stats = {}
        for k in keys:
            acc = np.zeros_like(parts[0].stats[k])
            for p in parts:
                acc = acc + scaled(p, k)
            stats[k] = acc
    n_rows = 0.0
    for p in parts:
        w = 1.0 if weights is None else float(weights.get(p.silo_id, 1.0))
        n_rows += p.n_rows * w
    return Partials(
        family=fam,
        stats=stats,
        payload=payload,
        n_rows=n_rows,
        silo_id="<merged>",
        round_id=parts[0].round_id,
        state_version=ver,
        noised=any(p.noised for p in parts),
        sources=tuple(p.silo_id for p in parts),
    )


def merge_profiles(parts: Sequence[Partials]):
    """Sugar: merge ``profile``-family partials and return the
    :class:`~..quality.sketches.DataProfile` itself."""
    from ..quality.sketches import DataProfile

    merged = merge_partials(parts)
    return DataProfile.from_dict(merged.payload)


# ------------------------------------------------------------------ noise
@dataclass(frozen=True)
class NoiseConfig:
    """Clipped-Gaussian knob applied to shipped partials (DP-*style*).

    The statistics' global L2 norm is clipped to ``clip_norm`` and
    elementwise Gaussian noise with σ = ``clip_norm · noise_multiplier``
    is added, seeded deterministically by (seed, silo, round) so a
    re-collected partial ships identical bytes.  **Caveats** (docs
    §Federated fit): this is the DP-SGD *mechanism* without the
    *accounting* — no (ε, δ) claim is made; counts and weight masses in
    the statistics are noised along with the moments (consumers guard
    denominators), while ``n_rows`` itself ships exactly for quorum
    accounting.  Any noise (or clipping that binds) forfeits bit-parity
    with the pooled fit by design."""

    clip_norm: float = 1e6
    noise_multiplier: float = 0.0
    seed: int = 0


def apply_clipped_noise(part: Partials, cfg: NoiseConfig) -> Partials:
    """Clip + noise one silo's float statistics at the ship boundary."""
    floats = {k: v for k, v in part.stats.items() if v.dtype.kind == "f"}
    if not floats:
        return part
    sq = 0.0
    for v in floats.values():
        sq += float(np.sum(np.asarray(v, np.float64) ** 2))
    norm = float(np.sqrt(sq))
    scale = min(1.0, cfg.clip_norm / max(norm, 1e-30))
    rng = np.random.default_rng(
        [cfg.seed & 0xFFFFFFFF, part.round_id & 0xFFFFFFFF,
         zlib.crc32(part.silo_id.encode())]
    )
    sigma = cfg.clip_norm * cfg.noise_multiplier
    out = dict(part.stats)
    changed = scale < 1.0 or sigma > 0.0
    for k, v in floats.items():
        nv = np.asarray(v, np.float64) * scale
        if sigma > 0.0:
            nv = nv + rng.normal(0.0, sigma, size=v.shape)
        out[k] = nv.astype(v.dtype)
    if not changed:
        return part
    return replace(part, stats=out, noised=True)
