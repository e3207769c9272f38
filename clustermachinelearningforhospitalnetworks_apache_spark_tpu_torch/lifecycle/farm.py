"""Drifted-subset retraining for model farms — the lifecycle loop at
fleet granularity (the JAX package's ``lifecycle/farm.py``).

The single-model loop (``lifecycle/controller.py``) retrains THE model
when ITS traffic drifts.  A farm inverts the economics: with 4k
hospitals in one artifact, retraining the whole farm because three
hospitals changed their admission coding wastes 99.9% of the work —
and per-tenant PSI is already free, because the farm's artifact carries
every tenant's training-time sketches (``farm/profiles.py``).  So the
farm cycle is: score live windows per tenant → refit ONLY the drifted
subset (``ModelFarmModel.refit``'s masked scatter, global slot frozen)
→ save the successor artifact → optionally hot-swap it behind the
serving name with the same pre-warmed ``swap_model`` primitive the
single-model promotion path uses.  Every untouched tenant's parameters
are byte-identical across the swap by construction.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from ..farm.drift import drifted_tenants
from ..obs import trace as _trace
from ..obs.registry import global_registry
from ..quality.sketches import PSI_DRIFT
from ..utils.logging import get_logger

log = get_logger("lifecycle")


def retrain_drifted(
    model,
    data: Mapping[str, Any],
    live: Mapping[str, np.ndarray] | None = None,
    threshold: float = PSI_DRIFT,
    min_rows: int = 16,
    save_path: str | None = None,
    server=None,
    serving_name: str | None = None,
    device=None,
):
    """One farm lifecycle cycle: detect → masked refit → persist → swap.

    ``data`` maps tenant id → that tenant's CURRENT training data (the
    refit source, e.g. a window query per hospital); ``live`` maps
    tenant id → the recent raw feature rows to SCORE (defaults to the
    feature matrix of ``data`` — retrain-on-what-you'd-score).  Only
    tenants in ``data`` are considered.  Returns ``(model', report)``
    where ``model'`` is the successor farm (``model`` itself when
    nothing drifted) and ``report`` lists the drifted tenants with
    their PSI scores.  The refit runs on ``device`` (default the card);
    the scores are host work.
    """
    # one id space: drifted_tenants str()-normalizes, so the refit-data
    # lookup must too (int/np tenant ids from a DB would otherwise read
    # as "no refit data" for exactly the tenants that drifted)
    data = {str(t): v for t, v in data.items()}
    if live is None:
        live = {
            t: (v[0] if isinstance(v, tuple) else v) for t, v in data.items()
        }
    else:
        live = {str(t): v for t, v in live.items()}
    with _trace.span("lifecycle.retrain", {"kind": "farm"}) as sp:
        drifted = drifted_tenants(
            model, live, threshold=threshold, min_rows=min_rows
        )
        report = {
            "drifted": dict(drifted),
            "scored": len(live),
            "threshold": threshold,
        }
        reg = global_registry()
        reg.set("farm.drifted_tenants", float(len(drifted)))
        if not drifted:
            return model, report
        missing = [t for t in drifted if t not in data]
        if missing:
            raise KeyError(
                f"drifted tenants {missing} have no refit data in `data`"
            )
        new_model = model.refit({t: data[t] for t in drifted}, device=device)
        if sp.trace_id is not None:
            sp.note("drifted", len(drifted))
        if save_path is not None:
            new_model.save(save_path)
            report["saved"] = save_path
        if server is not None:
            if serving_name is None:
                raise ValueError("server= requires serving_name=")
            # the single-model promotion primitive: pre-warmed executable,
            # atomic flip, breaker reset — the farm rides it unchanged
            server.swap_model(serving_name, new_model)
            report["swapped"] = serving_name
        log.info(
            "farm drifted-subset retrain",
            drifted=len(drifted), scored=len(live),
        )
        return new_model, report
