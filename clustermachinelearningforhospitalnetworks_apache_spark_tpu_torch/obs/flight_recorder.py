"""Crash flight recorder: a bounded ring of recent events, dumped on
failure.

The postmortem half of the observability layer: while the system runs, cheap
``note()`` calls append recent activity — span ends (fed by the
tracer), fault-rule fires, quarantines, breaker transitions, journal
hops — into a fixed-size in-memory ring.  When something *breaks*, the
ring plus a metrics snapshot is dumped atomically to disk, so every
failure leaves an artifact answering "what was the system doing in the
seconds before this?".

Dump triggers (wired at the source, not polled):

* **breaker trip/open**   — ``serve/breaker.py`` on any transition to OPEN
* **poison-batch quarantine** — ``streaming/microbatch.py::_quarantine``
* **lifecycle rollback**  — ``lifecycle/controller.py::_rollback``
* **InjectedCrash**       — ``utils/faults.py``: the exception's
  constructor itself dumps, so every chaos-matrix kill (fault-rule
  crashes, torn WAL writes, test-raised crashes) leaves a postmortem
  no matter which code path raised it.  ``tools/run_chaos.sh`` asserts
  the dumps exist and round-trip for its whole kill matrix.

Dump integrity: the payload is serialized canonically (key-sorted,
separator-pinned — the ``lifecycle/journal.py`` convention) and wrapped
with its CRC32C (``io/integrity.py``); :func:`read_dump` verifies
before trusting, so a torn or bit-rotted postmortem reads as corrupt
instead of as evidence.  The write is tmp-file + atomic rename.

Always on: the ring is a few hundred small dicts (bounded deque), and
``note()`` is a lock + append — cheap enough to leave armed in
production, the whole point of a flight recorder.  ``CMLHN_FLIGHT_DIR``
overrides the dump directory (default: a per-process tempdir path).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from collections import deque

#: ring capacity: enough context to read a story, small enough to dump
#: in one write
DEFAULT_CAPACITY = 256

_SAFE = re.compile(r"[^a-zA-Z0-9_.-]+")


def default_dump_dir() -> str:
    env = os.environ.get("CMLHN_FLIGHT_DIR")
    if env:
        return env
    return os.path.join(
        tempfile.gettempdir(), f"cmlhn_flight-{os.getpid()}"
    )


#: dump-directory bound: a breaker that re-opens every recovery cycle
#: under sustained drift (an expected state) must not fill the
#: disk with postmortems — oldest dumps evict past this count
DEFAULT_MAX_DUMPS = 256


class FlightRecorder:
    """Bounded event ring + atomic CRC32C postmortem dumps."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        dump_dir: str | None = None,
        max_dumps: int = DEFAULT_MAX_DUMPS,
    ):
        self.capacity = max(int(capacity), 8)
        self.dump_dir = dump_dir
        self.max_dumps = max(int(max_dumps), 1)
        self.events: deque = deque(maxlen=self.capacity)
        self.dumps = 0
        self.dump_failures = 0
        self.last_dump_path: str | None = None
        self._lock = threading.Lock()
        self._seq = 0
        self._in_dump = threading.local()

    # ------------------------------------------------------------ record
    def note(self, kind: str, name: str, **attrs) -> None:
        """Append one event to the ring (cheap; never raises)."""
        evt = {
            "t": round(time.time(), 6),
            "kind": kind,
            "name": name,
            "thread": threading.current_thread().name,
        }
        if attrs:
            evt["attrs"] = attrs
        with self._lock:
            self.events.append(evt)

    def note_span(self, span: dict) -> None:
        """Tracer fast path: fold a finished span into the ring without
        rebuilding it (the span dict is already immutable-by-convention
        once emitted) — kwargs-free on purpose, it runs per span."""
        with self._lock:
            self.events.append({
                "t": span["t0"] + span["dur_s"],
                "kind": "span",
                "name": span["name"],
                "attrs": {
                    "trace_id": span["trace_id"], "dur_s": span["dur_s"],
                },
            })

    # ------------------------------------------------------------- dump
    def dump(
        self, reason: str, site: str | None = None,
        attrs: dict | None = None,
    ) -> str | None:
        """Write the postmortem artifact; returns its path (None when the
        dump itself failed — counted, never raised: the recorder must
        not turn a failure into a worse one).  ``attrs`` is a dict, not
        ``**kwargs``, so trigger attributes can never collide with the
        ``reason``/``site`` parameters.  Reentrancy-guarded: a crash
        raised *while dumping* does not recurse."""
        if getattr(self._in_dump, "active", False):
            return None
        self._in_dump.active = True
        try:
            return self._dump(reason, site, attrs or {})
        except Exception:  # noqa: BLE001 — postmortem capture is best-effort
            self.dump_failures += 1
            return None
        finally:
            self._in_dump.active = False

    def _dump(self, reason: str, site: str | None, attrs: dict) -> str:
        from ..io.integrity import crc32c_hex  # lazy: keeps import light

        with self._lock:
            events = list(self.events)
            self._seq += 1
            seq = self._seq
        try:
            from .export import json_snapshot

            metrics = json_snapshot()
        except Exception:  # noqa: BLE001 — a broken collector must not
            # cost the postmortem its event ring
            metrics = {"error": "metrics snapshot failed"}
        try:
            from .trace import current_trace_id

            trace_id = current_trace_id()
        except Exception:  # noqa: BLE001
            trace_id = None
        payload = {
            "reason": str(reason),
            "site": site,
            "trigger": {k: v for k, v in attrs.items()},
            "time": round(time.time(), 6),
            "pid": os.getpid(),
            "seq": seq,
            "trace_id": trace_id,
            "events": events,
            "metrics": metrics,
        }
        body = json.dumps(
            payload, sort_keys=True, separators=(",", ":"), default=str
        )
        record = {"crc32c": crc32c_hex(body.encode()), "payload": payload}
        d = self.dump_dir or default_dump_dir()
        os.makedirs(d, exist_ok=True)
        tag = _SAFE.sub("_", (site or reason))[:48]
        path = os.path.join(d, f"flight-{os.getpid()}-{seq:04d}-{tag}.json")
        tmp = path + ".tmp"
        # The flight recorder is a best-effort OBSERVER of the
        # durability story, not a member of it: a postmortem
        # lost to power loss costs evidence, never state, and routing
        # it through the sanctioned helpers would put an fsync_dir on
        # the breaker-trip path this module exists to keep cheap.
        with open(tmp, "w") as f:
            json.dump(
                record, f, sort_keys=True, separators=(",", ":"), default=str
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.dumps += 1
        self.last_dump_path = path
        # bound the directory: evict oldest dumps past max_dumps (names
        # sort by pid+seq, so lexicographic order is write order per
        # process; eviction is best-effort — a raced unlink is fine)
        existing = sorted(
            f for f in os.listdir(d)
            if f.startswith("flight-") and f.endswith(".json")
        )
        for stale in existing[: max(0, len(existing) - self.max_dumps)]:
            try:
                os.unlink(os.path.join(d, stale))
            except OSError:
                pass
        return path

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "events_buffered": len(self.events),
                "capacity": self.capacity,
                "dumps": self.dumps,
                "dump_failures": self.dump_failures,
                "last_dump_path": self.last_dump_path,
            }


def read_dump(path: str) -> dict:
    """Load + CRC-verify one postmortem; raises ``ValueError`` on a
    mismatched or malformed artifact (corruption must be loud here — a
    silently-wrong postmortem is worse than none)."""
    from ..io.integrity import crc32c_hex

    with open(path) as f:
        record = json.load(f)
    if not isinstance(record, dict) or "payload" not in record:
        raise ValueError(f"{path}: not a flight-recorder dump")
    body = json.dumps(
        record["payload"], sort_keys=True, separators=(",", ":"), default=str
    )
    got = crc32c_hex(body.encode())
    want = record.get("crc32c")
    if got != want:
        raise ValueError(
            f"{path}: crc32c mismatch ({got} computed, {want} recorded)"
        )
    return record["payload"]


# ---------------------------------------------------------------- install
_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def install(rec: FlightRecorder) -> FlightRecorder:
    global _RECORDER
    _RECORDER = rec
    return rec


def note(kind: str, name: str, **attrs) -> None:
    _RECORDER.note(kind, name, **attrs)


def notify(kind: str, site: str, **attrs) -> str | None:
    """A dump trigger fired: record it in the ring AND write the
    postmortem.  Never raises."""
    try:
        _RECORDER.note(kind, site, **attrs)
        return _RECORDER.dump(kind, site=site, attrs=attrs)
    except Exception:  # noqa: BLE001 — see dump()
        return None


def crash_dump(exc: BaseException) -> None:
    """Called from ``InjectedCrash.__init__``: every simulated process
    death dumps the ring at the moment of death, tagged with the site
    that killed it.  Never raises (a recorder bug must not change what
    the chaos test observes)."""
    try:
        site = getattr(exc, "site", None) or "injected_crash"
        _RECORDER.note("injected_crash", site, message=str(exc))
        _RECORDER.dump(
            "injected_crash", site=site, attrs={"message": str(exc)}
        )
    except Exception:  # noqa: BLE001
        pass
