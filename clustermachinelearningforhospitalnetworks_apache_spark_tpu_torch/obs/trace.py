"""Span-based tracing threaded through the real unit-of-work chain.

A **span** is one timed, named piece of work: ``{trace_id, span_id,
parent_id, name, t0, dur_s, thread, attrs}``.  Spans nest through a
``contextvars.ContextVar``, so a streaming batch's span automatically
parents the SQL query it dispatches, the fit stages the update runs,
and the lifecycle transition it triggers — and one ``trace_id`` queried
from the span log reconstructs the whole ingest→SQL→fit→serve→promotion
timeline (:func:`timeline`; ``examples/observability_demo.py`` walks
one end to end).

Cost discipline (the ``utils/faults.py`` uninstalled-site rule): with
no :class:`Tracer` installed, :func:`span` returns a shared no-op
singleton — no allocation, two attribute loads and an ``is None`` test
— so the serve hot path pays nothing for instrumentation it isn't
using.

Durability: spans are buffered and appended to a JSONL log through the
same append/torn-tail discipline as the streaming WAL and the lifecycle
journal (``streaming/wal.py``) — a crash mid-flush costs at most the
batch being written, and readers skip torn lines.  The
:class:`~.flight_recorder.FlightRecorder` ring is fed on every span end
while a tracer is installed, so a postmortem dump carries the spans
leading up to the failure.

Instrumentation registry: :data:`REGISTERED_SPANS` is the literal set
of span names the codebase emits and :data:`SITE_COVERAGE` maps every
named fault site to the span under which it fires in the instrumented
end-to-end chain.  Both are the JAX package's literals, which its
``tools/check_obs.py`` cross-checks against that package's source; the
port keeps them equal, so the two packages share one span vocabulary.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Iterator

from . import flight_recorder as _flight

#: every span name the instrumentation emits.  ``stage.*`` covers the
#: dynamic StageClock sink (``stage.<clock-stage-name>``).  Keep it a
#: pure literal, equal to the JAX package's.
REGISTERED_SPANS = (
    "stream.batch",
    "stream.quarantine",
    "stage.*",
    "sql.query",
    "sql.view.maintain",  # per-commit delta fold into a materialized view
    "sql.view.serve",     # answering a query/read from view state
    "serve.request",
    "lifecycle.transition",
    "lifecycle.retrain",
    "lifecycle.promote",
    "lifecycle.rollback",
    "lifecycle.feedback",
    "farm.fit",          # model-farm fleet fit (one dispatch, T tenants)
    "farm.refit",        # drifted-subset masked refit
    "farm.predict",      # tenant-routed predict (host convenience path)
    "fleet.request",     # serving-fleet front door: admission→route→answer
    "fleet.promote",     # atomic fleet-wide swap (every replica or none)
    "fleet.proc",        # replica worker-process spawn/kill (proc fleet)
    "router.route",      # the routing decision (policy, chosen replica)
    "obs.demo",          # example/bench root spans
    "fed.round",         # one federated fit round: collect→merge→fit→broadcast
    "soak.run",          # one compressed-day soak run (root of the E2E trace)
    "table.seal",        # cold batches → sealed CRC-manifested segment
    "table.retire",      # superseded part files deleted under retention
    "table.scrub",       # segment CRC audit: quarantine + rebuild rot
    "tune.store",        # autotuner trial-store durable commit
    "tune.select",       # one live-retune decision: select→journal→apply
)

#: fault site (fnmatch glob) → the registered span that encloses or
#: records it in the instrumented pipelines (the JAX package's
#: ``tools/check_obs.py`` fails when a fault site in that source has no
#: entry here, or an entry points at an unregistered span).
SITE_COVERAGE = {
    "stream.after_*": "stream.batch",
    "source.read_file": "stream.batch",
    "sink.write_part": "stream.batch",
    "wal.append": "stream.batch",
    "ingest.csv_text": "stream.batch",
    "serve.predict": "serve.request",
    "fit_ckpt.*": "lifecycle.retrain",
    "model_io.save.*": "lifecycle.retrain",
    "lifecycle.journal.append": "lifecycle.transition",
    "lifecycle.retrain.commit": "lifecycle.retrain",
    "lifecycle.shadow.start": "lifecycle.retrain",
    "lifecycle.registry.flip": "lifecycle.promote",
    "lifecycle.registry.swap": "lifecycle.promote",
    "lifecycle.rollback": "lifecycle.rollback",
    "lifecycle.feedback.*": "lifecycle.feedback",
    "fleet.swap.*": "fleet.promote",
    "fleet.proc.*": "fleet.proc",   # worker spawn / rpc mangle / SIGKILL
    "sql.view.maintain": "sql.view.maintain",
    "fed.round.*": "fed.round",
    "soak.schedule.tick": "soak.run",      # chaos-event dispatch point
    "soak.phase.transition": "soak.run",   # diurnal phase boundary
    "soak.report.commit": "soak.run",      # SoakReport atomic-write commit
    "soak.replica.kill": "soak.run",       # replica-kill postmortem notify
    "table.seal.*": "table.seal",          # stage (segment+manifest) / commit
    "table.retire.commit": "table.retire",  # log-first part retirement
    "table.scrub.repair": "table.scrub",   # quarantine-and-rebuild point
    "tune.store.commit": "tune.store",     # trial merge atomic-write commit
    "tune.select.apply": "tune.select",    # between retune intent and apply
}

_CTX: contextvars.ContextVar = contextvars.ContextVar("obs_trace", default=None)


# span/trace ids: a per-process random base + a monotone counter — the
# uniqueness of urandom at ~10x less hot-path cost (ids are minted twice
# per root span; ``next()`` on a count is atomic under the GIL)
_ID_BASE = os.urandom(4).hex()
_ID_COUNT = itertools.count(1)


def _new_id() -> str:
    return f"{_ID_BASE}{next(_ID_COUNT) & 0xFFFFFFFF:08x}"


class Tracer:
    """Span sink: buffers finished spans, flushes them as JSONL.

    ``path=None`` keeps every span in memory (tests, short demos);
    with a path, spans land in batches of ``flush_every`` through ONE
    torn-tail-repaired append + fsync (``streaming/wal.append_lines``),
    so per-span cost stays amortized.  ``close()``/``flush()`` drain
    the buffer; :func:`active` does it on scope exit.

    ``flush_every`` trades postmortem completeness for hot-path cost:
    each flush is an fsync, and on a 1-core host an fsync every 256
    request spans measurably taxes the serve path it is observing.
    Spans are *telemetry* — the crash story is the flight recorder's
    CRC-dumped ring, so losing an unflushed tail to a crash costs
    visibility, never correctness.
    """

    def __init__(self, path: str | None = None, flush_every: int = 2048):
        self.path = path
        self.flush_every = max(int(flush_every), 1)
        self.spans: list[dict] = []      # in-memory (path=None) transcript
        self.emitted = 0
        self.dropped = 0
        self._buf: list[dict] = []
        self._lock = threading.Lock()
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)

    def emit(self, span: dict) -> None:
        flush = False
        with self._lock:
            self.emitted += 1
            if self.path is None:
                if len(self.spans) < 1_000_000:
                    self.spans.append(span)
                else:
                    self.dropped += 1
            else:
                self._buf.append(span)
                flush = len(self._buf) >= self.flush_every
        try:  # the ring is bounded and lock-light; never let it raise
            _flight._RECORDER.note_span(span)
        except Exception:  # noqa: BLE001 — observability must not break work
            pass
        if flush:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf or self.path is None:
            return
        from ..streaming.wal import append_lines  # lazy: avoids import cycle

        append_lines(self.path, buf, site=None)

    def close(self) -> None:
        self.flush()


class _NoopSpan:
    """The uninstalled-tracer singleton: every operation a real span
    supports, at the cost of a method call — and zero allocation."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, key: str, value) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = (
        "name", "attrs", "trace_id", "span_id", "parent_id",
        "_tracer", "_token", "_t0", "_t0_epoch",
    )

    def __init__(self, tracer: Tracer, name: str, attrs: dict | None):
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self._tracer = tracer
        parent = _CTX.get()
        if parent is None:
            self.trace_id = _new_id()
            self.parent_id = None
        else:
            self.trace_id, self.parent_id = parent
        self.span_id = _new_id()
        self._token = None
        self._t0 = 0.0
        self._t0_epoch = 0.0

    def __enter__(self) -> "_Span":
        self._token = _CTX.set((self.trace_id, self.span_id))
        self._t0 = time.perf_counter()
        self._t0_epoch = time.time()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        self._tracer.emit({
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0": self._t0_epoch,
            "dur_s": dur,
            "thread": threading.current_thread().name,
            "attrs": self.attrs,
        })
        return False

    def note(self, key: str, value) -> None:
        """Attach one attribute (positional on purpose: the hot path
        must not build kwargs dicts when tracing is off)."""
        self.attrs[key] = value


# ---------------------------------------------------------------- install
_TRACER: Tracer | None = None


def install(tracer: Tracer) -> Tracer:
    global _TRACER
    _TRACER = tracer
    return tracer


def clear() -> None:
    global _TRACER
    t, _TRACER = _TRACER, None
    if t is not None:
        t.close()


@contextmanager
def active(tracer: Tracer) -> Iterator[Tracer]:
    """``with trace.active(Tracer(path)): ...`` — installed for the
    block, flushed and uninstalled on exit."""
    install(tracer)
    try:
        yield tracer
    finally:
        clear()


def enabled() -> bool:
    return _TRACER is not None


def span(name: str, attrs: dict | None = None):
    """Open a span (use as a context manager).  With no tracer installed
    this returns the shared no-op singleton: no allocation, ever."""
    t = _TRACER
    if t is None:
        return _NOOP
    return _Span(t, name, attrs)


def record_span(name: str, dur_s: float, attrs: dict | None = None) -> None:
    """Emit an already-timed span (no context push) as a child of the
    current context — the StageClock sink: a clock stage that just
    finished becomes span ``stage.<name>`` under whatever unit of work
    is in flight on this thread.  No-op (one load + None test) when no
    tracer is installed."""
    t = _TRACER
    if t is None:
        return
    parent = _CTX.get()
    trace_id, parent_id = (parent if parent is not None else (_new_id(), None))
    t.emit({
        "trace_id": trace_id,
        "span_id": _new_id(),
        "parent_id": parent_id,
        "name": name,
        "t0": time.time() - dur_s,
        "dur_s": dur_s,
        "thread": threading.current_thread().name,
        "attrs": dict(attrs) if attrs else {},
    })


def current_trace_id() -> str | None:
    ctx = _CTX.get()
    return None if ctx is None else ctx[0]


# ---------------------------------------------------------------- reading
_SPAN_KEYS = ("trace_id", "span_id", "name", "t0", "dur_s")


def read_spans(path: str) -> list[dict]:
    """All intact spans from a span log — the WAL reader (torn/corrupt
    lines skipped; a crash mid-flush never hides earlier spans) plus a
    span-shape filter."""
    from ..streaming.wal import read_lines  # lazy: avoids import cycle

    return [
        o for o in read_lines(path)
        if isinstance(o, dict) and all(k in o for k in _SPAN_KEYS)
    ]


def timeline(spans: list[dict], trace_id: str) -> list[dict]:
    """One trace's spans in start order — the reconstructed end-to-end
    story of a unit of work (ingest → SQL → fit → serve → promotion)."""
    return sorted(
        (s for s in spans if s.get("trace_id") == trace_id),
        key=lambda s: (s["t0"], s["dur_s"]),
    )


def format_timeline(spans: list[dict]) -> str:
    """Human-readable rendering of :func:`timeline` output."""
    if not spans:
        return "(no spans)"
    t_base = min(s["t0"] for s in spans)
    lines = []
    by_id = {s["span_id"]: s for s in spans}

    def depth(s: dict) -> int:
        d, p = 0, s.get("parent_id")
        while p in by_id and d < 32:
            d, p = d + 1, by_id[p].get("parent_id")
        return d

    for s in spans:
        attrs = ", ".join(
            f"{k}={v}" for k, v in sorted((s.get("attrs") or {}).items())
        )
        lines.append(
            f"+{s['t0'] - t_base:8.3f}s {'  ' * depth(s)}{s['name']}"
            f" [{s['dur_s'] * 1e3:.1f} ms]{('  ' + attrs) if attrs else ''}"
        )
    return "\n".join(lines)


def by_name(spans: list[dict]) -> dict[str, int]:
    out: dict[str, int] = {}
    for s in spans:
        out[s["name"]] = out.get(s["name"], 0) + 1
    return out
