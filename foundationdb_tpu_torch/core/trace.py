"""Structured trace events (ref: flow/Trace.h TraceEvent).

JSONL instead of the reference's XML; same shape: typed events with
severity, machine-readable details, per-process files with size-based
rolling + retained-file pruning (ref: openTraceFile, flow/Trace.h:243),
and suppression of floods.

TraceBatch-style micro events share the sink (ref: flow/Trace.h:55-60
g_traceBatch.addEvent/addAttach — the per-transaction debug-ID events the
commit path emits for a sampled fraction of transactions, stitched across
processes by the IDs): `trace_txn_event` emits one `TransactionDebug`
micro event carrying a debug ID plus a Location naming the hop
(GRV.Reply, Commit.BatchFormed, Resolver.Submit, ...), and
`trace_txn_attach` records one ID joining another's scope (a transaction
joining a commit batch), so a single client-drawn ID reconstructs the
full cross-process, cross-batch timeline.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

SevDebug = 5
SevInfo = 10
SevWarn = 20
SevWarnAlways = 30
SevError = 40


class TraceFindResult(list):
    """`TraceSink.find` result: the retained matching events, plus how
    many events of the type were trimmed out of the in-memory window
    (`truncated` > 0 means the list is NOT the full history — `count()`
    still is, via the retained totals)."""

    truncated: int = 0


class TraceSink:
    """Collects events in memory; optionally appends JSONL to a file.

    With `roll_size` > 0 the file rolls when it exceeds that many bytes:
    the active file is renamed to `<path>.<seq>` and a fresh one opened,
    and only the newest `max_retained - 1` rolled files are kept (the
    active file is the retained set's first member) — the reference's
    rolled trace files (openTraceFile's rollsize/maxLogsSize)."""

    # Per-type flood suppression: after this many events of one type, further
    # ones are dropped and counted (a TraceEventsSuppressed event is emitted
    # once per suppressed type). SevError and above are never suppressed.
    TYPE_LIMIT = 25_000

    # SevError+ events retained verbatim regardless of memory trims (the
    # seed sweeps' allowlist check reads these; bounded so a SevError
    # flood cannot eat the heap).
    ERROR_KEEP = 256

    def __init__(self, path: Optional[str] = None, keep_in_memory: bool = True,
                 memory_limit: int = 100_000, roll_size: int = 0,
                 max_retained: int = 10):
        self.path = path
        self.keep = keep_in_memory
        self.memory_limit = memory_limit
        self.roll_size = roll_size
        self.max_retained = max(1, max_retained)
        self.events: list[dict] = []
        self._type_counts: dict[str, int] = {}
        self.suppressed: dict[str, int] = {}
        # Per-type counts of events dropped from the in-memory window by
        # the trim (find() flags these so long-run assertions and the cli
        # trace verbs know the window is partial).
        self.trimmed: dict[str, int] = {}
        # Exact SevError+ record, immune to trimming (bounded).
        self.error_count = 0
        self.error_events: list[dict] = []
        # Operator-facing identity of the hosting process (role@address on
        # deployed role hosts) — stamped into trace-query replies.
        self.process_name = ""
        self._fh = None
        self._file_bytes = 0
        self._roll_seq = 0
        if path:
            if os.path.exists(path):
                self._file_bytes = os.path.getsize(path)
            for old in self._rolled_files():
                self._roll_seq = max(self._roll_seq, old[0])
            self._fh = open(path, "a", buffering=1)

    # -- file lifecycle --
    def _rolled_files(self) -> list[tuple[int, str]]:
        """(seq, path) of existing rolled files of this sink, sorted."""
        out = []
        base = os.path.basename(self.path)
        d = os.path.dirname(self.path) or "."
        if not os.path.isdir(d):
            return []
        for name in os.listdir(d):
            if name.startswith(base + "."):
                suffix = name[len(base) + 1:]
                if suffix.isdigit():
                    out.append((int(suffix), os.path.join(d, name)))
        return sorted(out)

    def _roll(self) -> None:
        self._fh.close()
        self._roll_seq += 1
        os.replace(self.path, f"{self.path}.{self._roll_seq}")
        # Retention: the active file plus the newest max_retained - 1
        # rolled files survive; older rolls are pruned.
        rolled = self._rolled_files()
        for _seq, p in rolled[: max(0, len(rolled) - (self.max_retained - 1))]:
            try:
                os.remove(p)
            except OSError:  # pragma: no cover - racing an external prune
                pass
        self._fh = open(self.path, "a", buffering=1)
        self._file_bytes = 0

    def emit(self, event: dict) -> None:
        etype = event.get("Type", "")
        sev = event.get("Severity", 0)
        n = self._type_counts.get(etype, 0) + 1
        self._type_counts[etype] = n
        if n > self.TYPE_LIMIT and sev < SevError:
            if etype not in self.suppressed:
                self.suppressed[etype] = 0
                self.emit({"Type": "TraceEventsSuppressed", "Severity": SevWarn,
                           "SuppressedType": etype})
            self.suppressed[etype] += 1
            return
        if sev >= SevError:
            self.error_count += 1
            if len(self.error_events) < self.ERROR_KEEP:
                self.error_events.append(event)
        if self.keep:
            self.events.append(event)
            if len(self.events) > self.memory_limit:
                cut = self.memory_limit // 2
                for e in self.events[:cut]:
                    t = e.get("Type", "")
                    self.trimmed[t] = self.trimmed.get(t, 0) + 1
                del self.events[:cut]
        if self._fh:
            line = json.dumps(event, default=str) + "\n"
            self._fh.write(line)
            self._file_bytes += len(line)
            if self.roll_size and self._file_bytes >= self.roll_size:
                self._roll()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def count(self, event_type: str) -> int:
        """EXACT number of events of the type this sink accepted (emitted
        minus flood-suppressed) — backed by the retained per-type totals,
        so it stays correct after the in-memory window trims old events
        (`self.events` alone undercounts on long runs)."""
        return (self._type_counts.get(event_type, 0)
                - self.suppressed.get(event_type, 0))

    def type_counts(self) -> dict[str, int]:
        """Per-type accepted totals for every event type this sink ever
        saw — the coverage-signature feed (workloads/tester.py): the TYPE
        SET is what the swarm buckets on, and it survives window trims
        and flood suppression by construction."""
        return {t: n - self.suppressed.get(t, 0)
                for t, n in self._type_counts.items()}

    def find(self, event_type: str) -> TraceFindResult:
        """Matching events still in the in-memory window. The result's
        `truncated` attribute is the number of matching events the memory
        trim dropped — nonzero means assertions over the CONTENTS must
        not assume completeness (use `count()` for totals)."""
        out = TraceFindResult(
            e for e in self.events if e.get("Type") == event_type
        )
        out.truncated = self.trimmed.get(event_type, 0)
        return out

    def has_severity(self, at_least: int) -> list[dict]:
        if at_least >= SevError:
            # The dedicated record is trim-immune (bounded at ERROR_KEEP;
            # error_count carries the exact total).
            return [e for e in self.error_events
                    if e.get("Severity", 0) >= at_least]
        return [e for e in self.events if e.get("Severity", 0) >= at_least]


_global_sink = TraceSink()


def global_sink() -> TraceSink:
    return _global_sink


def set_global_sink(sink: TraceSink) -> TraceSink:
    global _global_sink
    _global_sink = sink
    return sink


def _event_time() -> Optional[float]:
    """Event timestamp: sim time under simulation (bit-reproducible per
    seed); wall-clock UNIX time on real loops so one machine's processes
    stitch onto a single comparable timeline (the flight recorder's
    cross-process ordering contract)."""
    try:
        from .runtime import current_loop

        loop = current_loop()
    except RuntimeError:
        return None
    if loop.is_simulated():
        return loop.now()
    import time as _time

    # fdblint: allow[det-wall-clock] -- real-clock tier only: the is_simulated() branch above pins sim loops to deterministic sim time; wall time is what makes separate OS processes' trace files stitch onto one timeline.
    return _time.time()


class TraceEvent:
    """Fluent structured event: TraceEvent("CommitBatch").detail("Txns", n).log()."""

    __slots__ = ("_event", "_sink", "_logged")

    def __init__(self, event_type: str, severity: int = SevInfo, sink: Optional[TraceSink] = None):
        self._event: dict[str, Any] = {
            "Type": event_type, "Severity": severity, "Time": _event_time(),
        }
        self._sink = sink or _global_sink
        self._logged = False

    def detail(self, key: str, value: Any) -> "TraceEvent":
        self._event[key] = value
        return self

    def error(self, err: BaseException) -> "TraceEvent":
        self._event["Error"] = getattr(err, "name", type(err).__name__)
        self._event["ErrorCode"] = getattr(err, "code", None)
        if self._event["Severity"] < SevWarn:
            self._event["Severity"] = SevWarn
        return self

    def log(self) -> None:
        if not self._logged:
            self._logged = True
            self._sink.emit(self._event)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.log()


# -- TraceBatch micro events (ref: flow/Trace.h:55-60 addEvent/addAttach) --

def new_debug_id() -> str:
    """Draw a debug ID for transaction sampling. Under simulation the ID
    comes from the loop's seeded PRNG (same seed => same IDs => the
    flight-recorder event chain replays bit-identically); on the real
    tier it is OS entropy, the analogue of the reference drawing debug
    IDs from g_nondeterministicRandom — many client processes must not
    mint colliding IDs just because their loops share a default seed."""
    from .runtime import current_loop

    loop = current_loop()
    if loop.is_simulated():
        return str(loop.random.random_unique_id())
    # fdblint: allow[det-random] -- quarantined nondeterminism (the reference's g_nondeterministicRandom): real-clock tier only, the is_simulated() branch above keeps sim IDs seeded.
    return os.urandom(16).hex()


def trace_txn_event(location: str, debug_id, **details) -> None:
    """One flight-recorder micro event (ref: g_traceBatch.addEvent):
    Type=TransactionDebug, the hop name in Location, the sampled
    transaction/batch ID in DebugID. No-op without a debug ID, so call
    sites stay unconditional on the hot path."""
    if not debug_id:
        return
    ev = TraceEvent("TransactionDebug", severity=SevDebug)
    ev.detail("Location", location).detail("DebugID", str(debug_id))
    for k, v in details.items():
        ev.detail(k, v)
    ev.log()


def trace_txn_attach(debug_id, attached_to, **details) -> None:
    """Attach event (ref: g_traceBatch.addAttach — CommitAttachID): the
    sampled transaction `debug_id` joined the scope identified by
    `attached_to` (a proxy commit batch), so a trace query for the
    transaction's ID can follow the batch's downstream events too."""
    if not debug_id or not attached_to:
        return
    ev = TraceEvent("TransactionAttach", severity=SevDebug)
    ev.detail("DebugID", str(debug_id)).detail("To", str(attached_to))
    for k, v in details.items():
        ev.detail(k, v)
    ev.log()
