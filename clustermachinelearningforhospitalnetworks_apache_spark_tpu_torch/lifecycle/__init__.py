"""Continuous learning: drift-triggered warm retrain, shadow/canary
promotion, chaos-hardened lifecycle controller (the JAX package's
``lifecycle/``).

* :mod:`journal`   — CRC-verified WAL of state transitions (the spine)
* :mod:`feedback`  — served predictions + outcomes re-enter ingest
* :mod:`promotion` — shadow scorer, parity gate, canary router
* :mod:`controller`— the SERVING → … → PROMOTED | ROLLED_BACK machine
* :mod:`farm`      — drifted-subset retraining for model farms

The journal, the feedback spool, the gates and the canary router are host
code and take no ``device=``; the retrain and the served, shadow and
canary predicts run on the retrainer's and the server's devices.
"""

from .controller import (
    KMeansRetrainer,
    LifecycleController,
    STATE_CANARY,
    STATE_DRIFT_SUSPECTED,
    STATE_PROMOTED,
    STATE_RETRAINING,
    STATE_ROLLED_BACK,
    STATE_SERVING,
    STATE_SHADOW,
    STATES,
    kmeans_cost,
)
from .farm import retrain_drifted
from .feedback import FeedbackBuffer, OUTCOME_COL, PREDICTION_COL, feedback_schema
from .journal import LifecycleJournal
from .promotion import CanaryRouter, GateDecision, ParityGate, ShadowScorer

__all__ = [
    "CanaryRouter",
    "FeedbackBuffer",
    "GateDecision",
    "KMeansRetrainer",
    "LifecycleController",
    "LifecycleJournal",
    "OUTCOME_COL",
    "PREDICTION_COL",
    "ParityGate",
    "retrain_drifted",
    "STATES",
    "STATE_CANARY",
    "STATE_DRIFT_SUSPECTED",
    "STATE_PROMOTED",
    "STATE_RETRAINING",
    "STATE_ROLLED_BACK",
    "STATE_SERVING",
    "STATE_SHADOW",
    "ShadowScorer",
    "feedback_schema",
    "kmeans_cost",
]
