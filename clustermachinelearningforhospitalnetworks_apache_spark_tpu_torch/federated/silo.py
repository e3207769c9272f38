"""One hospital silo: private data + the local half of the partials loop
(the JAX package's ``federated/silo.py``).

A :class:`Silo` owns a private table (never shipped) and knows how to run
the port's ingestion stack on it — firewall → unbounded table → assembler
— via :meth:`Silo.from_csv`.  The coordinator only ever asks it for
:class:`~.partials.Partials`: per-round sufficient statistics
(:meth:`compute_partials`), init candidates (:meth:`init_partials`), and
data-quality sketches (:meth:`profile_partials`).  Rows stay put.

A silo computes on its own ``device`` (default the card, resolved when the
silo is made, so a silo meant for a missing card raises there); a
:class:`~..data.DeviceDataset` as ``data`` stays on the device it lies on
and is not copied again each round.  The reference's ``mesh`` is kept and
ignored.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Any, Sequence

import numpy as np

from ..data import DeviceDataset
from ..device import resolve_device
from ..features.assembler import AssembledTable, VectorAssembler
from ..quality.firewall import DataFirewall
from ..quality.sketches import DataProfile
from ..streaming.unbounded_table import UnboundedTable
from .partials import NoiseConfig, Partials, apply_clipped_noise

__all__ = ["Silo"]


@dataclass
class Silo:
    """A cross-silo participant.

    ``data`` is whatever :func:`~..models.base.as_device_dataset` accepts
    — an :class:`~..features.assembler.AssembledTable`, a bare matrix, an
    ``(X, y[, w])`` tuple, or a DeviceDataset.  ``weight`` is the silo's
    *contribution weight* surfaced to the coordinator's weighting knob (it
    is NOT applied here — weighting happens in the merge, where it is
    explicit that it forfeits bit-parity)."""

    silo_id: str
    data: Any
    label_col: str | None = None
    #: the reference's mesh; accepted and ignored (one device a silo)
    mesh: Any = None
    weight: float = 1.0
    #: collect-side call counter — a resumed round must NOT recompute
    #: partials a crashed coordinator already journaled
    compute_calls: int = 0
    received_versions: list = field(default_factory=list)
    received_models: list = field(default_factory=list)
    #: where this silo's statistics run (default the card)
    device: Any = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------ ingest
    @classmethod
    def from_csv(
        cls,
        silo_id: str,
        path: str,
        schema,
        feature_cols: Sequence[str],
        label_col: str | None = None,
        mesh: Any = None,
        weight: float = 1.0,
        table_dir: str | None = None,
        device=None,
    ) -> "Silo":
        """Stand a silo up from a raw CSV drop through the full local
        stack: firewall validation, durable unbounded-table commit, then
        vector assembly (host work).  This is each hospital's on-prem
        pipeline — the federated layer starts *after* it."""
        firewall = DataFirewall(schema)
        res = firewall.ingest_file(path, header=True)
        if table_dir is None:
            table_dir = os.path.join(
                os.path.dirname(os.path.abspath(path)), f"_silo_{silo_id}"
            )
        ub = UnboundedTable(path=table_dir, schema=schema)
        ub.append_batch(res.table, batch_id=0)
        committed = ub.read()
        assembled = VectorAssembler(list(feature_cols)).transform(committed)
        return cls(
            silo_id=silo_id, data=assembled, label_col=label_col,
            mesh=mesh, weight=weight, device=device,
        )

    # ----------------------------------------------------------- compute
    def compute_partials(
        self,
        estimator,
        state,
        round_id: int,
        final: bool = False,
        noise: NoiseConfig | None = None,
    ) -> Partials:
        """One round's local work: sufficient statistics over the private
        table on this silo's device, stamped with this silo and round.
        The optional clipped-noise knob applies here, at the ship boundary
        — nothing leaves the silo un-noised when it is set."""
        self.compute_calls += 1
        p = estimator.partial_fit_stats(
            self.data, label_col=self.label_col, mesh=self.mesh,
            state=state, final=final, device=self.device,
        )
        p = replace(p, silo_id=self.silo_id, round_id=round_id)
        if noise is not None:
            p = apply_clipped_noise(p, noise)
        return p

    def init_partials(self, estimator, round_id: int = 0) -> Partials:
        """Local init candidates (k-means++/GMM seeding material)."""
        self.compute_calls += 1
        p = estimator.local_init_stats(
            self.data, label_col=self.label_col, mesh=self.mesh, device=self.device
        )
        return replace(p, silo_id=self.silo_id, round_id=round_id)

    def profile_partials(
        self,
        reference: DataProfile | None = None,
        names: Sequence[str] | None = None,
        bins: int = 32,
    ) -> Partials:
        """Sketch the private feature matrix as a ``profile`` partial.

        Sketch merges require identical bin edges, so profiles are built
        two-phase: the coordinator takes the first silo's (ascending id)
        profile as the *reference*, and every other silo folds its rows
        into :meth:`DataProfile.like`-shaped empty sketches."""
        x = np.asarray(self.feature_matrix(), dtype=np.float64)
        if reference is not None:
            prof = DataProfile.like(reference).update_matrix(x)
        else:
            if names is None:
                names = [f"f{j}" for j in range(x.shape[1])]
            prof = DataProfile.from_matrix(x, names, bins=bins)
        return Partials(
            family="profile", payload=prof.to_dict(),
            n_rows=float(x.shape[0]), silo_id=self.silo_id,
        )

    def feature_matrix(self) -> np.ndarray:
        """The silo's valid feature rows on the host."""
        if isinstance(self.data, AssembledTable):
            return self.data.features
        if isinstance(self.data, DeviceDataset):
            return self.data.x[self.data.w > 0].cpu().numpy()
        if isinstance(self.data, tuple):
            return np.asarray(self.data[0])
        return np.asarray(self.data)

    @property
    def n_features(self) -> int:
        """Feature width, read without copying device rows to the host."""
        if isinstance(self.data, DeviceDataset):
            return int(self.data.n_features)
        return int(np.asarray(self.feature_matrix()).shape[1])

    @property
    def n_rows(self) -> int:
        if isinstance(self.data, DeviceDataset):
            return int((self.data.w > 0).sum())
        return int(np.asarray(self.feature_matrix()).shape[0])

    # --------------------------------------------------------- broadcast
    def receive_state(self, state) -> None:
        self.received_versions.append(state.version)

    def receive_model(self, model) -> None:
        self.received_models.append(model)
