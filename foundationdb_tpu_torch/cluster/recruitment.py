"""Worker recruitment (the port's copy of foundationdb_tpu/cluster/
recruitment.py): the controller-side worker registry + the
fitness-ranked role placement both tiers recruit by (ref:
fdbserver/ClusterController.actor.cpp:1445 getWorkerForRoleInDatacenter
ranking workers by ProcessClass fitness; fdbserver/worker.actor.cpp:481
registrationClient — every worker re-registers with the controller
forever, and registration doubles as the liveness heartbeat;
flow/ProcessClass.h machineClassFitness).

Three pieces, shared by the sim topology AND the multiprocess tier so
their placement can never diverge (the same contract as
replica_set_for_tag):

- ``fitness_for(process_class, role)``: the reference's
  Best/Good/Acceptable/WorstFit/NeverAssign ladder per (class, role).
- ``select_workers(candidates, role, count)``: THE ranker. Deterministic
  total order — (fitness, penalty, dc, index, worker_id) — so ties break
  by locality/index, never by dict or set iteration order (fdblint's
  det-recruit-order rule guards this file).
- ``WorkerRegistry``: the controller's registry of live workers,
  heartbeat-leased via the failure monitor's detection server
  (failure_monitor.FailureDetectionServer): every registration feeds a
  beat; a worker silent past WORKER_LEASE_TIMEOUT drops out of
  candidacy. ``recruit`` raises ``RecruitmentStalled`` when no candidate
  exists — recovery parks in a named ``recruiting_<role>`` state
  (visible in status json and TraceEvents) and ``wait_for_worker``
  resumes it the instant a worker registers.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Iterable, Optional

from ..core.errors import OperationFailed
from ..core.knobs import SERVER_KNOBS
from ..core.runtime import current_loop
from ..core.trace import TraceEvent


class Fitness(IntEnum):
    """(ref: ProcessClass::Fitness — lower ranks first; NeverAssign is an
    exclusion, not a preference.)"""

    BEST = 0
    GOOD = 1
    ACCEPTABLE = 2
    WORST_FIT = 3
    NEVER_ASSIGN = 4


def normalize_class(process_class: Optional[str]) -> str:
    """Canonical process class: numbered failure-domain classes collapse
    onto their kind (``log1`` -> ``log``, ``resolver0`` -> ``resolver``),
    and the multiprocess ``txn`` class is the transaction bundle."""
    pc = (process_class or "unset").lower().rstrip("0123456789")
    return {"txn": "transaction", "": "unset"}.get(pc, pc)


# Per-role fitness of each process class (ref: machineClassFitness,
# flow/ProcessClass.h — matching class Best, stateless Good, unset
# Acceptable, a stateful class recruited OUT of its role WorstFit, and
# tester/coordinator never assigned). "transaction" is the bundled
# per-generation txn system (master+proxy+resolver+ratekeeper) the sim
# topology places on one machine and the multiprocess txn host serves.
_B, _G, _A, _W = (Fitness.BEST, Fitness.GOOD, Fitness.ACCEPTABLE,
                  Fitness.WORST_FIT)
_FITNESS: dict[str, dict[str, Fitness]] = {
    "master": {"transaction": _B, "stateless": _G, "unset": _A},
    "proxy": {"proxy": _B, "transaction": _G, "stateless": _G, "unset": _A},
    "resolver": {"resolver": _B, "stateless": _G, "transaction": _G,
                 "unset": _A},
    "transaction": {"transaction": _B, "stateless": _G, "unset": _A},
    "log": {"log": _B, "transaction": _G, "unset": _A},
    "storage": {"storage": _B, "unset": _A},
}
_NEVER = ("test", "tester", "coordinator")


def fitness_for(process_class: Optional[str], role: str) -> Fitness:
    pc = normalize_class(process_class)
    if pc in _NEVER:
        return Fitness.NEVER_ASSIGN
    return _FITNESS.get(role, {}).get(pc, Fitness.WORST_FIT)


@dataclass
class WorkerInfo:
    """One registered worker (ref: WorkerDetails — interface + process
    class + locality held by the controller)."""

    worker_id: str
    process_class: str = "unset"
    machine_id: str = ""
    address: str = ""
    dc: int = 0
    index: int = 0       # locality tie-break slot (machine/host index)
    penalty: int = 0     # soft demotions: stale lease, protected machine
    last_seen: float = 0.0
    pinned: bool = False  # the controller's own process: lease-exempt


def select_workers(candidates: Iterable[WorkerInfo], role: str,
                   count: int = 1,
                   max_fitness: Fitness = Fitness.WORST_FIT
                   ) -> list[WorkerInfo]:
    """THE shared ranker: best-fitness-first placement with a TOTAL
    deterministic order. NeverAssign classes are excluded outright; ties
    break by (penalty, dc, index, worker_id) — locality and id, never
    container order, so the same registry content ranks identically no
    matter the registration history (the sim replay + operator
    debuggability contract).

    `max_fitness` bounds how bad a candidate may be: the sim topology
    places the in-process txn bundle on ANY machine (WorstFit included,
    like the reference's workers, which can host every role), while the
    multiprocess tier recruits at BEST only — a role host serves only
    its own class's endpoints, so a storage worker can never host the
    resolver fleet no matter how desperate recruitment gets."""
    ranked = []
    for w in candidates:
        fit = fitness_for(w.process_class, role)
        if fit > max_fitness:
            continue
        ranked.append((int(fit), w.penalty, w.dc, w.index, w.worker_id, w))
    ranked.sort(key=lambda t: t[:5])
    return [t[5] for t in ranked[:count]]


def select_replacement_hosts(candidates: Iterable[WorkerInfo], role: str,
                             count: int = 1,
                             max_fitness: Fitness = Fitness.WORST_FIT,
                             exclude_machines: Iterable[str] = (),
                             ) -> list[WorkerInfo]:
    """Placement of a REPLACEMENT durable-role host (log/storage
    re-recruitment, machine drains): the shared ranker with a failure-
    domain exclusion — a machine already hosting a replica of the role's
    serving set (or the machine being drained/buried) must not receive
    another copy, or one machine loss would eat two replicas the
    replication policy placed apart. Same total deterministic order as
    select_workers; the fdblint det-recruit pack anchors on this function
    too, so the sim tier's durable-role placement cannot silently unwire
    from the shared path."""
    excluded = frozenset(exclude_machines)
    pool = [w for w in candidates if w.machine_id not in excluded]
    return select_workers(pool, role, count, max_fitness=max_fitness)


class RecruitmentStalled(OperationFailed):
    """No candidate worker for a role: recovery must PARK in a named
    ``recruiting_<role>`` state — visible in status json and TraceEvents,
    resumed the instant a worker registers — never a silent hang or a
    crash loop (the reference's betterMasterExists/recruitment-failure
    wait, ClusterController.actor.cpp)."""

    def __init__(self, role: str, detail: str = ""):
        self.role = role
        super().__init__(
            f"recruiting_{role}: no candidate worker"
            + (f" ({detail})" if detail else "")
        )

    @property
    def state_name(self) -> str:
        return f"recruiting_{self.role}"


class WorkerRegistry:
    """The controller's worker registry (ref: the id->WorkerInfo map on
    the cluster controller, ClusterController.actor.cpp). Liveness is a
    heartbeat lease ARBITRATED BY the failure monitor: every
    registration feeds a beat into an embedded FailureDetectionServer
    whose sweep runs at the WORKER_LEASE_TIMEOUT horizon, and candidacy
    requires both a fresh lease and not-failed status."""

    def __init__(self, lease_timeout: Optional[float] = None):
        from .failure_monitor import FailureDetectionServer

        self._lease = lease_timeout
        self._workers: dict[str, WorkerInfo] = {}
        self.failure_server = FailureDetectionServer(
            timeout=lambda: self.lease_timeout
        )
        # Bumped on every registration while a stall is active (and on
        # every NEW worker): parked recoveries wake instantly.
        from ..core.actors import AsyncVar

        self._change: AsyncVar = AsyncVar(0)
        self._bumps = 0
        self.stalls: dict[str, float] = {}   # role -> stalled-since
        # role -> {detail, awaiting, candidates}: WHY the stall isn't
        # draining (which worker class/tag is awaited + how many live
        # candidates exist), for status json and `cli.py recruitment`.
        self.stall_info: dict[str, dict] = {}
        self.stalls_total = 0
        self.recruits_total = 0

    @property
    def lease_timeout(self) -> float:
        return (self._lease if self._lease is not None
                else SERVER_KNOBS.WORKER_LEASE_TIMEOUT)

    # -- lifecycle (the embedded failure server's sweep actor) --
    def start(self) -> None:
        self.failure_server.start()

    def stop(self) -> None:
        self.failure_server.stop()

    # -- registration (== the heartbeat) --
    def register(self, worker_id: str, process_class: str = "unset",
                 address: str = "", machine_id: str = "", dc: int = 0,
                 index: int = 0, penalty: int = 0,
                 pinned: bool = False) -> float:
        """Upsert + beat. Returns the heartbeat interval the controller
        expects (the registration reply's lease contract)."""
        now = current_loop().now()
        w = self._workers.get(worker_id)
        fresh = w is None
        if fresh:
            w = WorkerInfo(worker_id)
            self._workers[worker_id] = w
            TraceEvent("WorkerRegistered").detail(
                "Worker", worker_id
            ).detail("Class", process_class).detail(
                "Machine", machine_id
            ).log()
        w.process_class = process_class
        w.address = address or w.address
        w.machine_id = machine_id or w.machine_id
        w.dc, w.index, w.penalty, w.pinned = dc, index, penalty, pinned
        w.last_seen = now
        self.failure_server.beat(worker_id)
        if fresh or self.stalls:
            self._bump()
        return SERVER_KNOBS.WORKER_HEARTBEAT_INTERVAL

    def forget(self, worker_id: str) -> None:
        """Drop a worker that failed a recruitment confirm: faster than
        waiting out its lease; a live worker re-registers on its next
        beat and loses nothing."""
        if self._workers.pop(worker_id, None) is not None:
            TraceEvent("WorkerForgotten", severity=30).detail(
                "Worker", worker_id
            ).log()

    def _bump(self) -> None:
        self._bumps += 1
        self._change.set(self._bumps)

    # -- liveness --
    def is_live(self, worker_id: str) -> bool:
        w = self._workers.get(worker_id)
        if w is None:
            return False
        if w.pinned:
            return True
        if worker_id in self.failure_server.state.failed:
            return False
        return (current_loop().now() - w.last_seen) <= self.lease_timeout

    def workers(self) -> list[WorkerInfo]:
        return [w for _k, w in sorted(self._workers.items())]

    def live_workers(self) -> list[WorkerInfo]:
        return [w for w in self.workers() if self.is_live(w.worker_id)]

    # -- recruitment --
    def best_worker(self, role: str,
                    max_fitness: Fitness = Fitness.WORST_FIT
                    ) -> Optional[WorkerInfo]:
        got = select_workers(self.live_workers(), role, 1,
                             max_fitness=max_fitness)
        return got[0] if got else None

    def recruit(self, role: str, count: int = 1,
                max_fitness: Fitness = Fitness.WORST_FIT
                ) -> list[WorkerInfo]:
        """Rank the live registered workers for `role`; raises
        RecruitmentStalled (and records the named stall) when fewer than
        `count` candidates exist."""
        got = select_workers(self.live_workers(), role, count,
                             max_fitness=max_fitness)
        if len(got) < count:
            self.note_stall(
                role, detail=f"{len(got)}/{count} candidates, "
                             f"{len(self._workers)} registered",
                awaiting=role, candidates=len(got),
            )
            raise RecruitmentStalled(
                role, f"{len(got)}/{count} candidates"
            )
        self.note_resumed(role)
        self.recruits_total += 1
        TraceEvent("RoleRecruited").detail("Role", role).detail(
            "Workers", ",".join(w.worker_id for w in got)
        ).detail(
            "Fitness", int(fitness_for(got[0].process_class, role))
        ).log()
        return got

    # -- stall bookkeeping (also used by callers whose stall source is
    #    not the registry, e.g. an unreachable log quorum) --
    def note_stall(self, role: str, detail: str = "",
                   awaiting: Optional[str] = None,
                   candidates: Optional[int] = None) -> None:
        """Record a named recruiting_<role> stall. `awaiting` names the
        worker class / storage tag the stall waits on and `candidates`
        the number of live candidates ranked — the two facts an operator
        needs to see WHY the stall isn't draining (surfaced in status
        json and `cli.py recruitment`). Re-noting an active stall only
        refreshes that context (the stalled-since clock keeps running)."""
        self.stall_info[role] = {
            "detail": detail,
            "awaiting": awaiting if awaiting is not None else role,
            "candidates": candidates,
        }
        if role in self.stalls:
            return
        self.stalls[role] = current_loop().now()
        self.stalls_total += 1
        TraceEvent("RecruitmentStalled", severity=30).detail(
            "Role", role
        ).detail("State", f"recruiting_{role}").detail(
            "Awaiting", awaiting if awaiting is not None else role
        ).detail(
            "Candidates", -1 if candidates is None else candidates
        ).detail("Detail", detail).log()

    def note_resumed(self, role: str) -> None:
        since = self.stalls.pop(role, None)
        self.stall_info.pop(role, None)
        if since is not None:
            TraceEvent("RecruitmentResumed").detail("Role", role).detail(
                "StalledS", round(current_loop().now() - since, 3)
            ).log()

    async def wait_for_worker(self, timeout_s: Optional[float] = None) -> None:
        """Park a stalled recovery: wakes on the next registration bump,
        bounded by the stall-retry delay so a candidate whose
        registration raced the stall is still picked up."""
        from ..core.actors import timeout as _timeout

        await _timeout(
            self._change.on_change(),
            timeout_s if timeout_s is not None
            else SERVER_KNOBS.RECRUITMENT_STALL_RETRY_DELAY,
            None,
        )

    # -- observability (the `recruitment` block of status json) --
    def status(self) -> dict:
        now = current_loop().now()
        return {
            "lease_timeout": self.lease_timeout,
            "workers": [
                {
                    "id": w.worker_id,
                    "class": w.process_class,
                    "machine": w.machine_id,
                    "address": w.address,
                    "live": self.is_live(w.worker_id),
                    "pinned": w.pinned,
                    "age_s": round(now - w.last_seen, 3),
                }
                for w in self.workers()
            ],
            "stalls": {
                role: round(now - since, 3)
                for role, since in sorted(self.stalls.items())
            },
            # WHY each stall isn't draining: the awaited worker class /
            # tag and the live candidate count (None = not computed by
            # the caller) — `cli.py recruitment` renders these.
            "stall_details": {
                role: {
                    "age_s": round(now - self.stalls.get(role, now), 3),
                    **self.stall_info.get(role, {}),
                }
                for role in sorted(self.stalls)
            },
            "stalls_total": self.stalls_total,
            "recruits_total": self.recruits_total,
        }
