"""Composable replica-placement policies (ref: fdbrpc/ReplicationPolicy.h).

The reference expresses redundancy modes as policy trees: `single` =
PolicyOne, `double`/`triple` = PolicyAcross(n, "zoneid", PolicyOne),
`three_datacenter` = PolicyAnd(Across(3, "dcid", One), Across(3, "zoneid",
One)) (fdbrpc/ReplicationPolicy.h:99 PolicyOne, :119 PolicyAcross, :160
PolicyAnd; DatabaseConfiguration.cpp builds the trees from config keys).
The same tree drives two questions:

- `select_replicas(candidates, already)` — build a replica set satisfying
  the policy (team building, recruitment);
- `validate(replicas)` — does this set satisfy the policy (per-commit
  quorum checks, team health)?

Selection is deterministic given the caller's DeterministicRandom, so
simulation replays identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class LocalityData:
    """Indexed locality attributes of one process (ref: fdbrpc/Locality.h;
    keys mirror LocalityData::keyZoneId/keyDcId/keyMachineId/keyProcessId)."""

    processid: str = ""
    zoneid: str = ""
    machineid: str = ""
    dcid: str = ""
    data_hall: str = ""

    def get(self, key: str) -> str:
        return getattr(self, key)


@dataclass(frozen=True)
class Replica:
    """One placement candidate: an opaque id plus its locality."""

    id: str
    locality: LocalityData


class ReplicationPolicy:
    """Base policy (ref: IReplicationPolicy, fdbrpc/ReplicationPolicy.h:42)."""

    name = "Policy"

    def num_replicas(self) -> int:
        raise NotImplementedError

    def validate(self, replicas: Sequence[Replica]) -> bool:
        raise NotImplementedError

    def select_replicas(
        self,
        candidates: Sequence[Replica],
        already: Sequence[Replica] = (),
        random=None,
    ) -> Optional[list[Replica]]:
        """Return a minimal list of NEW replicas (drawn from candidates,
        disjoint from `already`) such that already+new validates; None if
        impossible (ref: selectReplicas, ReplicationPolicy.cpp)."""
        raise NotImplementedError

    def __repr__(self):
        return self.describe()

    def describe(self) -> str:
        return self.name


def _shuffled(items: list, random) -> list:
    items = list(items)
    if random is None:
        return items
    # Fisher-Yates on the deterministic PRNG.
    for i in range(len(items) - 1, 0, -1):
        j = random.random_int(0, i + 1)
        items[i], items[j] = items[j], items[i]
    return items


class PolicyOne(ReplicationPolicy):
    """Any single replica satisfies (ref: ReplicationPolicy.h:99)."""

    name = "One"

    def num_replicas(self) -> int:
        return 1

    def validate(self, replicas: Sequence[Replica]) -> bool:
        return len(replicas) >= 1

    def select_replicas(self, candidates, already=(), random=None):
        if already:
            return []
        pool = _shuffled(list(candidates), random)
        return [pool[0]] if pool else None


class PolicyAcross(ReplicationPolicy):
    """`count` groups with distinct values of `attrib`, each group
    satisfying `subpolicy` (ref: ReplicationPolicy.h:119)."""

    def __init__(self, count: int, attrib: str, subpolicy: ReplicationPolicy):
        self.count = count
        self.attrib = attrib
        self.subpolicy = subpolicy

    def describe(self) -> str:
        return f"Across({self.count}, {self.attrib}, {self.subpolicy.describe()})"

    def num_replicas(self) -> int:
        return self.count * self.subpolicy.num_replicas()

    def _groups(self, replicas: Sequence[Replica]) -> dict[str, list[Replica]]:
        groups: dict[str, list[Replica]] = {}
        for r in replicas:
            key = r.locality.get(self.attrib)
            if key:
                groups.setdefault(key, []).append(r)
        return groups

    def validate(self, replicas: Sequence[Replica]) -> bool:
        ok = sum(
            1
            for members in self._groups(replicas).values()
            if self.subpolicy.validate(members)
        )
        return ok >= self.count

    def select_replicas(self, candidates, already=(), random=None):
        already = list(already)
        cand_groups = self._groups(candidates)
        used_ids = {r.id for r in already}
        chosen: list[Replica] = []
        # Groups already satisfied by `already` count toward the quota.
        satisfied = {
            key
            for key, members in self._groups(already).items()
            if self.subpolicy.validate(members)
        }
        need = self.count - len(satisfied)
        if need <= 0:
            return []
        for key in _shuffled(
            [k for k in cand_groups if k not in satisfied], random
        ):
            avail = [r for r in cand_groups[key] if r.id not in used_ids]
            prior = [r for r in already if r.locality.get(self.attrib) == key]
            sub = self.subpolicy.select_replicas(avail, prior, random)
            if sub is None:
                continue
            chosen.extend(sub)
            used_ids.update(r.id for r in sub)
            need -= 1
            if need == 0:
                return chosen
        return None


class PolicyAnd(ReplicationPolicy):
    """All subpolicies satisfied by the same set (ref:
    ReplicationPolicy.h:160)."""

    def __init__(self, *policies: ReplicationPolicy):
        self.policies = list(policies)

    def describe(self) -> str:
        return "And(" + ", ".join(p.describe() for p in self.policies) + ")"

    def num_replicas(self) -> int:
        return max((p.num_replicas() for p in self.policies), default=0)

    def validate(self, replicas: Sequence[Replica]) -> bool:
        return all(p.validate(replicas) for p in self.policies)

    def select_replicas(self, candidates, already=(), random=None):
        """Greedy: satisfy subpolicies in descending num_replicas order,
        feeding each selection into the next as `already` (the reference's
        PolicyAnd::selectReplicas sorts the same way,
        ReplicationPolicy.cpp)."""
        already = list(already)
        chosen: list[Replica] = []
        for p in sorted(
            self.policies, key=lambda p: p.num_replicas(), reverse=True
        ):
            sub = p.select_replicas(candidates, already + chosen, random)
            if sub is None:
                return None
            chosen.extend(sub)
        return chosen


# -- redundancy-mode factory (ref: fdbserver/DatabaseConfiguration.cpp) --

def policy_for_mode(mode: str) -> ReplicationPolicy:
    if mode == "single":
        return PolicyOne()
    if mode == "double":
        return PolicyAcross(2, "zoneid", PolicyOne())
    if mode == "triple":
        return PolicyAcross(3, "zoneid", PolicyOne())
    if mode == "two_datacenter":
        # The two-region layout's team mode: every team spans both DCs
        # (so a whole-datacenter loss leaves a serving replica while the
        # log tier fails over to the remote log set). The reference
        # expresses its region configs with the same Across-dcid tree.
        return PolicyAnd(
            PolicyAcross(2, "dcid", PolicyOne()),
            PolicyAcross(2, "zoneid", PolicyOne()),
        )
    if mode == "three_datacenter":
        return PolicyAnd(
            PolicyAcross(3, "dcid", PolicyOne()),
            PolicyAcross(3, "zoneid", PolicyOne()),
        )
    if mode == "three_data_hall":
        return PolicyAcross(3, "data_hall", PolicyOne())
    raise ValueError(f"unknown redundancy mode {mode!r}")
