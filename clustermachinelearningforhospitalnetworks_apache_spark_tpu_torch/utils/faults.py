"""Deterministic fault injection: the chaos half of the durability story.

The streaming WAL, fit checkpoints, and artifact writers all claim
crash-consistency; this module is how those claims get *exercised*.  A
:class:`FaultPlan` is a seedable list of rules ("the 3rd append to the
offsets log tears at byte 7", "the first two reads of f.csv raise an IO
error", "every serve-predict call fails for a while") that production code
consults at named **fault sites** via the module-level hooks below.  With
no plan installed the hooks are a single ``is None`` check — zero cost on
the hot path.

Sites are plain strings, matched with ``fnmatch`` globs so a rule can hit
one site (``"wal.append"``) or a family (``"fit_ckpt.*"``).  Each hook
passes keyword context (path, batch id, …) that a rule's optional ``when``
predicate can filter on — e.g. tear only the commits log, not the offsets
log.

Actions:

* ``fail``   — raise :class:`FaultError` (an ``OSError``: retryable, the
  shape of a flaky disk/NFS/object-store call)
* ``crash``  — raise :class:`InjectedCrash`.  It subclasses
  ``BaseException`` deliberately: retry loops and self-healing handlers
  catch ``Exception``, so an injected *process death* propagates through
  them exactly like a real ``kill -9`` ends the process — the test harness
  catches it at the top and "restarts".
* ``delay``  — sleep (latency spike / straggler)
* ``corrupt``— flip bits in a payload passed through :func:`mangle_bytes`
* ``tear``   — report a byte offset to :func:`torn_point`; the writer
  persists exactly that prefix and raises :class:`InjectedCrash`
* ``disk_full`` — the failure that actually kills long-lived
  stores: ``ENOSPC``.  A rule carries a deterministic byte budget
  (``after_bytes``); byte-charging writers consult :func:`enospc_point`
  with each payload's length, and the write that crosses the budget
  persists exactly the bytes that still fit (short write) and then
  raises ``OSError(ENOSPC)`` at the fsync — the shape a full disk
  really produces.  Plain :func:`fault_point` sites raise ``ENOSPC``
  outright once the budget is spent (``after_bytes=0`` means
  immediately), so one rule family covers both "this write crosses the
  cliff" and "the disk is already full at this boundary".

Data-plane corruption — the faults a *producer* commits rather
than a disk: rules that rewrite CSV text passed through
:func:`corrupt_data` at the ingest boundary (site ``ingest.csv_text``).
All are seeded from the plan's ``seed`` (plus the rule's fire count), so
a chaos test replays the identical dirty bytes every run:

* ``mangle_field``   — replace a sample of fields with unparseable junk
* ``shuffle_columns``— permute the column order (header included — the
  drift the schema reconciler must undo)
* ``unit_scale``     — multiply one numeric column by a factor (the
  classic silent hours→minutes unit change)
* ``nan_burst``      — blank a contiguous run of one column's values

Lifecycle sites — the continuous-learning controller (the JAX package's
``lifecycle/``; a later slice of the port) names a fault site at every
state-transition boundary, so the chaos matrix can kill the loop anywhere
and assert it self-heals:

* ``lifecycle.journal.append``  — before a transition's WAL entry lands
* ``lifecycle.retrain.commit``  — after the candidate artifact commits,
  before the SHADOW transition is journaled
* ``lifecycle.shadow.start``    — arming the candidate for shadow scoring
* ``lifecycle.registry.flip``   — the promotion decision, pre-journal
* ``lifecycle.registry.swap``   — applying the flip to the live server
* ``lifecycle.rollback``        — refusing a candidate, pre-journal
* ``lifecycle.feedback.flush``  — spooled feedback rows → ingest CSV
* ``lifecycle.feedback.compact``— after flush commit, before the WAL
  compaction (the double-flush hazard window)

Everything is counted (calls per site, fires per rule) so tests can assert
a fault actually happened — a chaos test whose fault never fired proves
nothing.

The site names and rule vocabulary are the JAX package's letter for
letter (``utils/faults.py``), so one :class:`FaultPlan` drives the chaos
tests of both packages.  The port has no flight recorder yet: a crash
raises without a postmortem dump, and fired rules are not noted in a
ring buffer.
"""

from __future__ import annotations

import errno
import fnmatch
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Iterator, Sequence


class FaultError(OSError):
    """Injected transient IO failure — retryable by design."""


def enospc_error(site: str, wrote: int = 0) -> OSError:
    """The ``OSError`` a full disk raises — real ``errno.ENOSPC``, so
    production handlers that special-case disk exhaustion see exactly
    what the kernel would hand them."""
    return OSError(
        errno.ENOSPC,
        f"injected ENOSPC at {site} ({wrote} bytes persisted)",
    )


class InjectedCrash(BaseException):
    """Simulated process death at a fault site.

    ``BaseException`` so no ``except Exception`` self-healing path can
    swallow it: code that survives an InjectedCrash by catching it would
    also "survive" a power cut, which is a lie.  ``site`` names the
    fault site that killed the process.
    """

    def __init__(self, *args, site: str | None = None):
        super().__init__(*args)
        self.site = site


#: rule actions that rewrite ingest data rather than raising/sleeping
DATA_ACTIONS = ("mangle_field", "shuffle_columns", "unit_scale", "nan_burst")


@dataclass
class FaultRule:
    site: str                                  # fnmatch pattern
    action: str                                # fail|crash|delay|corrupt|tear|data
    after: int = 0                             # skip this many matching calls
    times: int | None = 1                      # fire at most this many (None=∞)
    error: Callable[[], BaseException] | None = None
    delay_s: float = 0.0
    at_byte: int | None = None                 # tear/corrupt offset
    flip_mask: int = 0xFF                      # corrupt: XOR'd into the byte
    when: Callable[[dict], bool] | None = None # extra context predicate
    # data-corruption parameters (DATA_ACTIONS only)
    rate: float = 0.02                         # mangle_field: per-field prob
    columns: tuple[str, ...] | None = None     # restrict to these columns
    factor: float = 1000.0                     # unit_scale multiplier
    burst_len: int = 8                         # nan_burst row run length
    seen: int = 0                              # matching calls observed
    fired: int = 0                             # times actually fired
    bytes_seen: int = 0                        # disk_full: bytes charged so far

    def matches(self, site: str, ctx: dict) -> bool:
        if not fnmatch.fnmatchcase(site, self.site):
            return False
        return self.when is None or bool(self.when(ctx))

    def take(self) -> bool:
        """Count a matching call; True when the rule fires on it."""
        self.seen += 1
        if self.seen <= self.after:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        self.fired += 1
        return True


class FaultPlan:
    """A seedable, inspectable set of fault rules.

    ``seed`` exists for future probabilistic rules and so two plans built
    the same way are interchangeable; every rule here is
    deterministic-by-count, which is what kill-and-resume tests need
    (the *n*-th write tears, every run).
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rules: list[FaultRule] = []
        self.calls: dict[str, int] = {}        # site -> hook invocations
        self.log: list[tuple[str, str]] = []   # (site, action) fire history
        self._lock = threading.RLock()

    # ------------------------------------------------------------ authoring
    def _add(self, rule: FaultRule) -> "FaultPlan":
        self.rules.append(rule)
        return self

    def fail(
        self,
        site: str,
        times: int | None = 1,
        after: int = 0,
        error: Callable[[], BaseException] | None = None,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        return self._add(FaultRule(site, "fail", after, times, error=error, when=when))

    def crash(
        self, site: str, after: int = 0,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        return self._add(FaultRule(site, "crash", after, 1, when=when))

    def delay(
        self, site: str, seconds: float, times: int | None = 1, after: int = 0,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        return self._add(FaultRule(site, "delay", after, times, delay_s=seconds, when=when))

    def corrupt(
        self, site: str, at_byte: int = 0, flip_mask: int = 0xFF,
        times: int | None = 1, after: int = 0,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        return self._add(
            FaultRule(site, "corrupt", after, times, at_byte=at_byte,
                      flip_mask=flip_mask, when=when)
        )

    def tear(
        self, site: str, at_byte: int, after: int = 0,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        return self._add(FaultRule(site, "tear", after, 1, at_byte=at_byte, when=when))

    def disk_full(
        self, site: str, after_bytes: int = 0,
        times: int | None = 1, after: int = 0,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        """ENOSPC once ``after_bytes`` have been charged at matching
        sites.  Byte-charging writers (:func:`enospc_point`) get a short
        write — exactly the bytes that still fit land on disk — then the
        error at the fsync; plain :func:`fault_point` sites raise once
        the budget is spent (``after_bytes=0``: the disk is already
        full).  Deterministic by byte count, so a kill-and-resume test
        replays the identical ENOSPC every run."""
        return self._add(FaultRule(
            site, "disk_full", after, times, at_byte=after_bytes, when=when,
        ))

    # ------------------------------------------------- data corruption
    def mangle_fields(
        self, site: str, rate: float = 0.02,
        columns: Sequence[str] | None = None,
        times: int | None = None, after: int = 0,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        """Replace ~``rate`` of the (optionally ``columns``-restricted)
        fields with unparseable junk."""
        return self._add(FaultRule(
            site, "mangle_field", after, times, rate=rate,
            columns=None if columns is None else tuple(columns), when=when,
        ))

    def shuffle_columns(
        self, site: str, times: int | None = 1, after: int = 0,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        """Permute the column order (header and rows together)."""
        return self._add(FaultRule(site, "shuffle_columns", after, times, when=when))

    def unit_scale(
        self, site: str, column: str, factor: float = 1000.0,
        times: int | None = None, after: int = 0,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        """Multiply every parseable value of ``column`` by ``factor``."""
        return self._add(FaultRule(
            site, "unit_scale", after, times, columns=(column,),
            factor=factor, when=when,
        ))

    def nan_burst(
        self, site: str, column: str, length: int = 8,
        times: int | None = None, after: int = 0,
        when: Callable[[dict], bool] | None = None,
    ) -> "FaultPlan":
        """Blank a contiguous run of ``length`` rows in ``column``."""
        return self._add(FaultRule(
            site, "nan_burst", after, times, columns=(column,),
            burst_len=length, when=when,
        ))

    # ------------------------------------------------------------ inspection
    def fired(self, site_pattern: str = "*") -> int:
        with self._lock:
            return sum(
                1 for s, _ in self.log if fnmatch.fnmatchcase(s, site_pattern)
            )

    # ------------------------------------------------------------ runtime
    def check(self, site: str, ctx: dict) -> None:
        """Hook for fail/crash/delay rules — called by :func:`fault_point`.
        A ``disk_full`` rule whose byte budget is spent raises ENOSPC
        here too: past the cliff, every durable boundary sees it."""
        delay = 0.0
        boom: BaseException | None = None
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            for r in self.rules:
                if r.action not in ("fail", "crash", "delay", "disk_full"):
                    continue
                if r.action == "disk_full" and r.bytes_seen < (r.at_byte or 0):
                    continue  # budget not yet spent: no ENOSPC here yet
                if not (r.matches(site, ctx) and r.take()):
                    continue
                if r.action == "disk_full":
                    self.log.append((site, "disk_full"))
                    boom = enospc_error(site)
                    break
                self.log.append((site, r.action))
                if r.action == "delay":
                    delay += r.delay_s
                elif r.action == "crash":
                    boom = InjectedCrash(
                        f"injected crash at {site}", site=site
                    )
                    break
                else:
                    boom = (r.error or (lambda: FaultError(
                        f"injected IO error at {site}"
                    )))()
                    break
        if delay:
            time.sleep(delay)
        if boom is not None:
            raise boom

    def mangle(self, site: str, data: bytes, ctx: dict) -> bytes:
        """Hook for corrupt rules — flip a byte of the payload in flight."""
        with self._lock:
            for r in self.rules:
                if r.action != "corrupt":
                    continue
                if not (r.matches(site, ctx) and r.take()):
                    continue
                self.log.append((site, "corrupt"))
                if not data:
                    continue
                i = min(r.at_byte or 0, len(data) - 1)
                data = data[:i] + bytes([data[i] ^ (r.flip_mask & 0xFF)]) + data[i + 1:]
        return data

    def has_data_rules(self, site: str) -> bool:
        """Any (not-yet-exhausted) data-corruption rule aimed at ``site``?
        The ingest fast path uses this as its one-branch gate."""
        with self._lock:
            return any(
                r.action in DATA_ACTIONS
                and fnmatch.fnmatchcase(site, r.site)
                and (r.times is None or r.fired < r.times)
                for r in self.rules
            )

    def corrupt_data(self, site: str, text: str, ctx: dict) -> str:
        """Hook for data-corruption rules: rewrite CSV ``text`` (header
        line + data lines) per the matching rules, deterministically
        seeded from (plan seed, rule order, fire count)."""
        fired_rules = []
        with self._lock:
            for i, r in enumerate(self.rules):
                if r.action in DATA_ACTIONS and r.matches(site, ctx) and r.take():
                    self.log.append((site, r.action))
                    # snapshot the fire count INSIDE the lock: concurrent
                    # callers must each get their own deterministic seed
                    fired_rules.append((i, r, r.fired))
        for i, r, fired in fired_rules:
            # int-tuple hash is PYTHONHASHSEED-independent → deterministic
            rng = random.Random(hash((self.seed, i, fired)))
            text = _apply_data_rule(r, text, rng)
        return text

    def torn_point(self, site: str, length: int, ctx: dict) -> int | None:
        """Hook for tear rules → byte count to persist before "dying"."""
        with self._lock:
            for r in self.rules:
                if r.action != "tear":
                    continue
                if not (r.matches(site, ctx) and r.take()):
                    continue
                self.log.append((site, "tear"))
                cut = r.at_byte or 0
                if cut < 0:  # negative = from the end (-1: all but last byte)
                    cut += length
                return max(0, min(cut, length))
        return None

    def enospc_point(self, site: str, length: int, ctx: dict) -> int | None:
        """Hook for disk_full rules on byte-charging writers → how many
        of ``length`` bytes fit before the injected ENOSPC (``None`` =
        the whole write fits / no rule).  Charges the rule's byte budget
        either way, so the budget is a property of the *disk*, not of
        which write happens to observe it."""
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            for r in self.rules:
                if r.action != "disk_full" or not r.matches(site, ctx):
                    continue
                budget = r.at_byte or 0
                fit = max(0, budget - r.bytes_seen)
                r.bytes_seen += length
                if fit >= length:
                    continue  # this write still fits entirely
                if not r.take():
                    continue  # times exhausted: space was "freed"
                self.log.append((site, "disk_full"))
                return min(fit, length)
        return None


# ------------------------------------------------------- data corruption
#: the junk token mangle_field writes — unparseable as float/int/timestamp
MANGLE_TOKEN = "x#!corrupt"


def _apply_data_rule(r: FaultRule, text: str, rng: random.Random) -> str:
    """Rewrite one CSV payload (header + rows) per one data rule."""
    trailing_nl = text.endswith("\n")
    lines = text.split("\n")
    if trailing_nl:
        lines = lines[:-1]
    if len(lines) < 2:  # header only (or empty): nothing to corrupt
        return text
    header = lines[0].split(",")
    rows = [ln.split(",") for ln in lines[1:]]
    col_idx = {name.strip(): j for j, name in enumerate(header)}

    def targets() -> list[int]:
        if r.columns is None:
            return list(range(len(header)))
        return [col_idx[c] for c in r.columns if c in col_idx]

    if r.action == "mangle_field":
        cols = targets()
        for row in rows:
            for j in cols:
                if j < len(row) and rng.random() < r.rate:
                    row[j] = MANGLE_TOKEN
    elif r.action == "shuffle_columns":
        perm = list(range(len(header)))
        while True:  # insist on a non-identity permutation
            rng.shuffle(perm)
            if perm != list(range(len(header))) or len(header) < 2:
                break
        header = [header[j] for j in perm]
        rows = [
            [row[j] if j < len(row) else "" for j in perm] for row in rows
        ]
    elif r.action == "unit_scale":
        for j in targets():
            for row in rows:
                if j < len(row):
                    try:
                        row[j] = repr(float(row[j]) * r.factor)
                    except (TypeError, ValueError):
                        pass  # unparseable cell: leave as-is
    elif r.action == "nan_burst":
        start = rng.randrange(max(1, len(rows) - r.burst_len + 1))
        for row in rows[start : start + r.burst_len]:
            for j in targets():
                if j < len(row):
                    row[j] = ""
    out = [",".join(header)] + [",".join(row) for row in rows]
    return "\n".join(out) + ("\n" if trailing_nl else "")


# ---------------------------------------------------------------- install
_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan) -> None:
    global _ACTIVE
    _ACTIVE = plan


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextmanager
def active(plan: FaultPlan) -> Iterator[FaultPlan]:
    """``with faults.active(plan): ...`` — installed for the block only."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def fault_point(site: str, **ctx) -> None:
    """Named injection site: raises/sleeps per the active plan (no-op
    without one).  Production code calls this at every boundary whose
    crash-consistency is part of the durability contract."""
    p = _ACTIVE
    if p is not None:
        p.check(site, ctx)


def mangle_bytes(site: str, data: bytes, **ctx) -> bytes:
    """Pass a payload through the active plan's corrupt rules."""
    p = _ACTIVE
    return data if p is None else p.mangle(site, data, ctx)


def torn_point(site: str, length: int, **ctx) -> int | None:
    """How many of ``length`` bytes a torn write should persist (None =
    no tear planned).  The caller writes that prefix, fsyncs, and raises
    :class:`InjectedCrash`."""
    p = _ACTIVE
    return None if p is None else p.torn_point(site, length, ctx)


def enospc_point(site: str, length: int, **ctx) -> int | None:
    """How many of ``length`` bytes fit before an injected ENOSPC
    (``None`` = no disk_full rule fires).  The caller persists exactly
    that prefix (the short write a real full disk leaves), fsyncs it,
    and raises :func:`enospc_error` — the torn-tail repair downstream
    already knows how to survive the partial line."""
    p = _ACTIVE
    return None if p is None else p.enospc_point(site, length, ctx)


def corrupt_data(site: str, text: str, **ctx) -> str:
    """Pass CSV text through the active plan's data-corruption rules
    (mangle_field / shuffle_columns / unit_scale / nan_burst)."""
    p = _ACTIVE
    return text if p is None else p.corrupt_data(site, text, ctx)


def data_rules_active(site: str) -> bool:
    """True when the active plan holds live data-corruption rules for
    ``site`` — the ingest fast path drops to the text-reading salvage
    parser only then, so clean production reads stay on the native scan."""
    p = _ACTIVE
    return p is not None and p.has_data_rules(site)
