"""Seeded, declarative chaos scenarios — the nemesis schedule.

The port's copy of ``kubeshare_tpu/chaos/scenarios.py``.

A :class:`Scenario` is a timeline of :class:`ChaosAction` records in
*virtual seconds*; the orchestrator replays the same timeline in the
``sim --chaos`` virtual-time loop and (for the transport scenarios)
against the real socket stack.  Timelines are deterministic per
``(name, seed)``: jitter comes from a ``random.Random`` keyed on both,
so the same seed always yields the identical schedule, report, and
MTTR samples — the acceptance bar CI's chaos-matrix gates on.

Action vocabulary (executed by ``orchestrator.ChaosRunner``):

``submit``            enqueue fractional pods (params: count, request)
``submit_gang``       enqueue one gang (params: name, headcount, request,
                      optional class — labels the gang's SLO class)
``preempt_on``        attach a PreemptionPolicy to the gang coordinator
                      and every mirrored token scheduler (params:
                      grace_ms, hold_s — optional gang auto-hold
                      stretch) — enables gang-aware preemption for the
                      rest of the run
``node_down``         lose a node: health veto + eviction
``node_up``           node returns healthy
``flap``              heartbeat flap: N down/up toggles (params: count,
                      period_s) — the detector must not thrash
``registry_restart``  rebuild the registry from its journal mid-lease
                      and assert replay idempotency
``registry_partition`` registry writes fail for the window (params:
                      duration_s) — binding publishes must roll back
``autopilot_apply``   run one plan+apply cycle (races whatever else is
                      in the window)
``ledger_idle``       feed the chip-time ledger a synthetic mostly-idle
                      grant window for a namespace's bound pods — the
                      rightsizer's shrink signal at virtual speed
                      (params: duration_s, active_frac)
``rightsize_apply``   run one rightsizer plan+apply cycle (shrinks,
                      rollback rails, pack moves — doc/autopilot.md,
                      Rightsizing)
``resize_gang``       elastic-resize a running gang's sub-mesh to
                      ``target_chips`` chips through the journaled
                      plan→pause→restate→flip→resume machine
                      (doc/elastic.md); target is the gang name in the
                      ``chaos`` namespace (or a full ``ns/name``).
                      Refusals (cooldown, no capacity mid-eviction) are
                      recorded outcomes, not violations
``serve_submit``      admit serving requests (params: tenant, count)
``park`` / ``resume`` freeze a serving tenant into a manifest / replay it
``servable_crash``    the shared servable raises for the window (params:
                      duration_s) — riders must fail loudly, never hang
``shard_commit_fail`` arm the sharded plane's mid-commit failure: the
                      next cross-shard gang commit dies after ``at``
                      members, exercising trial-book rollback (no-op on
                      the single-lock dispatcher)
``ha_enable``         stand up the HA plane (doc/ha.md): follower
                      registry tailing the op-stream, warm-standby
                      scheduler, epoch-fenced leadership on both
                      dispatchers
``leader_silence``    the primary scheduler stops entirely for the
                      window (params: duration_s) — no steps, no lease
                      renewals; the standby's takeover clock
``registry_leader_kill`` kill the primary registry abruptly and promote
                      the follower; clients fail over, bounded-lag ops
                      are lost by design, single-writer must hold
"""

from __future__ import annotations

import random
import zlib
from dataclasses import dataclass, field


@dataclass
class ChaosAction:
    at_s: float
    action: str
    target: str = ""
    params: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"at_s": round(self.at_s, 3), "action": self.action,
                "target": self.target, "params": dict(self.params)}


@dataclass
class Scenario:
    name: str
    description: str
    actions: list
    #: recovery bound: the cluster must reconverge within this many
    #: virtual seconds of the last fault action (recovery verifier)
    converge_bound_s: float = 60.0

    @property
    def fault_window_end_s(self) -> float:
        return max((a.at_s for a in self.actions), default=0.0)

    def to_dict(self) -> dict:
        return {"name": self.name,
                "actions": [a.to_dict() for a in self.actions],
                "converge_bound_s": self.converge_bound_s}


def _rng(name: str, seed: int) -> random.Random:
    """Deterministic per (name, seed) — crc32, not hash(): str hashing
    is salted per process and would break cross-run determinism."""
    return random.Random((zlib.crc32(name.encode()) << 16) ^ (seed & 0xffff)
                         ^ (seed << 40))


def _j(rng: random.Random, base: float, spread: float = 0.3) -> float:
    """Jitter a timestamp: base + U[0, spread) virtual seconds."""
    return base + rng.random() * spread


# -- the six composite scenarios ----------------------------------------


def node_crash_flap(seed: int) -> Scenario:
    """A node dies while another node's heartbeat flaps — eviction and
    the flap damper must not fight (doc/health.md)."""
    r = _rng("node-crash-flap", seed)
    return Scenario(
        "node-crash-flap",
        "node crash + heartbeat flap on a second node",
        [
            ChaosAction(0.0, "submit", params={"count": 6, "request": 0.5}),
            ChaosAction(_j(r, 1.0), "node_down", "host-0"),
            ChaosAction(_j(r, 1.2), "flap", "host-1",
                        {"count": 3, "period_s": round(
                            0.4 + r.random() * 0.4, 3)}),
            ChaosAction(_j(r, 6.0), "node_up", "host-0"),
        ])


def registry_restart_mid_lease(seed: int) -> Scenario:
    """The registry restarts from its journal while leases are live and
    bindings are being published — replay must be idempotent."""
    r = _rng("registry-restart-mid-lease", seed)
    return Scenario(
        "registry-restart-mid-lease",
        "registry journal restart while leases + bindings are live",
        [
            ChaosAction(0.0, "submit", params={"count": 5, "request": 0.4}),
            ChaosAction(_j(r, 1.0), "registry_restart"),
            ChaosAction(_j(r, 1.5), "submit",
                        params={"count": 3, "request": 0.4,
                                "prefix": "late"}),
            ChaosAction(_j(r, 2.5), "registry_restart"),
        ])


def proxy_kill_windowed_put(seed: int) -> Scenario:
    """The execution backend dies mid-window.  In virtual time the
    shared servable crashes for a window (riders must fail loudly —
    exactly-once); the live variant (tests/test_chaos.py) drives a real
    ChipProxy ``crash()`` during a chunked put and checks HBM
    conservation across journal recovery."""
    r = _rng("proxy-kill-windowed-put", seed)
    crash_at = _j(r, 1.0)
    return Scenario(
        "proxy-kill-windowed-put",
        "backend killed mid-put; riders fail loudly, HBM conserved",
        [
            ChaosAction(0.0, "serve_submit",
                        params={"tenant": "t-put", "count": 4}),
            ChaosAction(crash_at, "servable_crash",
                        params={"duration_s": round(
                            1.0 + r.random() * 0.5, 3)}),
            ChaosAction(_j(r, crash_at + 0.1, 0.2), "serve_submit",
                        params={"tenant": "t-put", "count": 4}),
        ])


def autopilot_vs_eviction(seed: int) -> Scenario:
    """An autopilot apply batch races a node eviction — rollback rails
    and the journal must keep moves atomic, no double-move."""
    r = _rng("autopilot-vs-eviction", seed)
    return Scenario(
        "autopilot-vs-eviction",
        "autopilot apply racing a node eviction",
        [
            ChaosAction(0.0, "submit", params={"count": 8, "request": 0.6}),
            ChaosAction(0.2, "submit",
                        params={"count": 8, "request": 0.4, "prefix": "b"}),
            # delete the 0.6 wave -> fragmentation the planner will chase
            ChaosAction(0.4, "delete_prefix", "pod"),
            ChaosAction(_j(r, 1.0), "autopilot_apply"),
            ChaosAction(_j(r, 1.05, 0.1), "node_down", "host-1"),
            ChaosAction(_j(r, 5.0), "node_up", "host-1"),
        ])


def park_during_migration(seed: int) -> Scenario:
    """A serving tenant is parked while the cluster is mid-eviction
    (the migration path) — the manifest must stay resumable and no
    admitted request may vanish."""
    r = _rng("park-during-migration", seed)
    park_at = _j(r, 1.0)
    return Scenario(
        "park-during-migration",
        "serving park during a node eviction/migration window",
        [
            ChaosAction(0.0, "submit", params={"count": 4, "request": 0.5}),
            ChaosAction(0.0, "serve_submit",
                        params={"tenant": "t-park", "count": 6}),
            ChaosAction(park_at, "serve_submit",
                        params={"tenant": "t-park", "count": 5}),
            ChaosAction(park_at, "node_down", "host-0"),
            ChaosAction(park_at + 0.01, "park", "t-park"),
            ChaosAction(_j(r, park_at + 1.0), "resume", "t-park"),
            ChaosAction(_j(r, park_at + 2.0), "node_up", "host-0"),
        ])


def partition_during_gang_bind(seed: int) -> Scenario:
    """The registry partitions away exactly while a gang is binding —
    publishes fail, reservations must roll back, and the gang stays
    all-or-nothing."""
    r = _rng("partition-during-gang-bind", seed)
    part_at = _j(r, 0.5, 0.2)
    return Scenario(
        "partition-during-gang-bind",
        "registry partition during gang bind",
        [
            ChaosAction(0.0, "submit", params={"count": 2, "request": 0.3}),
            ChaosAction(part_at, "registry_partition",
                        params={"duration_s": round(
                            1.0 + r.random() * 0.5, 3)}),
            ChaosAction(part_at + 0.01, "submit_gang",
                        params={"name": "ring", "headcount": 4,
                                "request": 0.5}),
        ])


def gang_grant_vs_eviction(seed: int) -> Scenario:
    """A gang is actively taking coordinated token grants (its sub-mesh
    shared with fractional singles) when one of its host nodes dies —
    the gang-grant-atomicity invariant must hold through eviction,
    rebind on the surviving capacity, and the node's return: no sample
    may ever see the gang holding a strict subset of its member chips
    outside a reserve window (doc/gang.md)."""
    r = _rng("gang-grant-vs-eviction", seed)
    down_at = _j(r, 1.0)
    return Scenario(
        "gang-grant-vs-eviction",
        "node eviction racing live gang-atomic token grants",
        [
            # co-tenant singles share the gang's chips — the contention
            # that makes uncoordinated per-chip grants skew
            ChaosAction(0.0, "submit", params={"count": 2, "request": 0.3}),
            ChaosAction(0.1, "submit_gang",
                        params={"name": "ring", "headcount": 4,
                                "request": 0.5}),
            ChaosAction(down_at, "node_down", "host-1"),
            ChaosAction(_j(r, down_at + 4.0), "node_up", "host-1"),
            ChaosAction(_j(r, down_at + 5.0), "delete_prefix", "pod"),
        ])


def preemption_vs_migration(seed: int) -> Scenario:
    """A latency gang preempts a best-effort gang on the same sub-mesh
    while the autopilot migrates and one of the hosts dies — preemption
    marks must never open a partial-grant window (gang-grant atomicity),
    the ledger must stay conserved through preempted tails, and the
    cluster must still reconverge (doc/gang.md)."""
    r = _rng("preemption-vs-migration", seed)
    down_at = _j(r, 1.5)
    return Scenario(
        "preemption-vs-migration",
        "gang preemption racing autopilot migration and a node death",
        [
            ChaosAction(0.0, "preempt_on",
                        params={"grace_ms": 50.0, "hold_s": 0.5}),
            # co-tenant singles keep the rest of the mesh contended
            ChaosAction(0.0, "submit", params={"count": 2, "request": 0.3}),
            # 0.6 + 0.4 pack onto the same chips: the latency gang's
            # sub-mesh fully overlaps the best-effort gang's, so its
            # coordinated grants contend chip-for-chip
            ChaosAction(0.1, "submit_gang",
                        params={"name": "flood-ring", "headcount": 4,
                                "request": 0.6}),
            ChaosAction(_j(r, 0.5, 0.2), "submit_gang",
                        params={"name": "lat-ring", "headcount": 4,
                                "request": 0.4, "class": "latency"}),
            ChaosAction(_j(r, 1.0), "autopilot_apply"),
            ChaosAction(down_at, "node_down", "host-1"),
            ChaosAction(_j(r, down_at + 3.0), "node_up", "host-1"),
        ])


def cross_shard_gang_commit_fail(seed: int) -> Scenario:
    """A gang too wide for any single shard subtree goes through the
    optimistic cross-shard trial-book→commit — and the commit is shot
    mid-flight (``shard_commit_fail``).  The rollback must leave every
    shard whole (cross-shard gang atomicity), the retry must land the
    gang, and late riders must still spill onto the leftover capacity.
    On a single-lock run the injection is a no-op and the gang binds
    directly — the scenario stays green in both planes."""
    r = _rng("cross-shard-gang-commit-fail", seed)
    return Scenario(
        "cross-shard-gang-commit-fail",
        "mid-commit shard failure during a cross-shard gang bind",
        [
            ChaosAction(0.0, "shard_commit_fail", params={"at": 2}),
            # headcount 6 whole-chip members on 2 subtrees x 4 chips:
            # no single subtree holds it -> the cross-shard protocol
            ChaosAction(0.1, "submit_gang",
                        params={"name": "wide-ring", "headcount": 6,
                                "request": 1.0}),
            ChaosAction(_j(r, 2.0), "submit",
                        params={"count": 2, "request": 0.3,
                                "prefix": "rider"}),
        ])


def resize_mid_eviction(seed: int) -> Scenario:
    """The rightsizer's shrink batch (sustained granted-idle ledger
    signal) races a node eviction — the resize re-booking, the
    whole-plan rollback rail and the eviction/rebind path must never
    tear a booking, double-book a chip, or push a chip's effective
    token sum past 1.0; a second cycle then plans against the
    half-evicted cluster and must stay inert or consistent."""
    r = _rng("resize-mid-eviction", seed)
    rz_at = _j(r, 4.2)
    return Scenario(
        "resize-mid-eviction",
        "rightsize shrink batch racing a node eviction",
        [
            ChaosAction(0.0, "submit",
                        params={"count": 6, "request": 0.6,
                                "namespace": "rz"}),
            # manufacture the sustained granted-idle window the shrink
            # signal needs (real ledger account rows, synthetic chips)
            ChaosAction(_j(r, 4.0, 0.1), "ledger_idle", "rz",
                        {"duration_s": 4.0, "active_frac": 0.1}),
            ChaosAction(rz_at, "rightsize_apply"),
            ChaosAction(_j(r, rz_at + 0.05, 0.1), "node_down",
                        "host-1"),
            ChaosAction(_j(r, rz_at + 1.0), "ledger_idle", "rz",
                        {"duration_s": 1.0, "active_frac": 0.1}),
            # the shrink-spacing rail inhibits a second shrink this
            # close; the cycle still plans (and may pack) against the
            # half-evicted cluster
            ChaosAction(_j(r, rz_at + 1.5), "rightsize_apply"),
            ChaosAction(_j(r, rz_at + 4.0), "node_up", "host-1"),
        ])


def resize_mid_churn(seed: int) -> Scenario:
    """A live gang's sub-mesh is elastically grown and then shrunk
    while the cluster churns around it — a host dies and returns and an
    autopilot batch migrates across the same window.  The elastic flip
    must never tear a member's booking or double-book a chip, the
    gang-grant-atomicity invariant must hold through every pause/resume
    (a refused resize — cooldown, no capacity mid-eviction — is an
    outcome, not a violation), and the journal must land each resize as
    exactly old-mesh or new-mesh (doc/elastic.md)."""
    r = _rng("resize-mid-churn", seed)
    grow_at = _j(r, 1.0)
    return Scenario(
        "resize-mid-churn",
        "elastic gang grow+shrink racing node churn and autopilot",
        [
            # co-tenant singles contend for the chips the grow wants
            ChaosAction(0.0, "submit", params={"count": 2, "request": 0.3}),
            ChaosAction(0.1, "submit_gang",
                        params={"name": "elastic-ring", "headcount": 4,
                                "request": 0.5}),
            ChaosAction(grow_at, "resize_gang", "elastic-ring",
                        {"target_chips": 4}),
            ChaosAction(_j(r, grow_at + 0.05, 0.1), "node_down",
                        "host-1"),
            ChaosAction(_j(r, grow_at + 0.5), "autopilot_apply"),
            # shrink the survivor onto one chip while half the fleet is
            # gone (may refuse on cooldown — an outcome, not a tear)
            ChaosAction(_j(r, grow_at + 1.0), "resize_gang",
                        "elastic-ring", {"target_chips": 1}),
            ChaosAction(_j(r, grow_at + 3.0), "node_up", "host-1"),
            ChaosAction(_j(r, grow_at + 4.0), "resize_gang",
                        "elastic-ring", {"target_chips": 2}),
        ])


def registry_leader_kill_mid_bind_publish(seed: int) -> Scenario:
    """The registry leader is killed abruptly while bindings are being
    published — the follower promotes with whatever its cursor reached
    (bounded-lag: trailing ops are lost by design), clients fail over,
    and the scheduler keeps its leadership across the registry failover
    (the ``leader:scheduler`` lease replicated with a restart-grace
    TTL).  The single-writer invariant must hold on the survivor and
    the late wave must bind through the promoted registry."""
    r = _rng("registry-leader-kill-mid-bind-publish", seed)
    kill_at = _j(r, 0.6, 0.4)
    return Scenario(
        "registry-leader-kill-mid-bind-publish",
        "registry leader killed mid bind-publish; follower promotes",
        [
            ChaosAction(0.0, "ha_enable"),
            ChaosAction(0.2, "submit", params={"count": 4,
                                               "request": 0.5}),
            ChaosAction(kill_at, "registry_leader_kill"),
            ChaosAction(_j(r, kill_at + 0.1, 0.2), "submit",
                        params={"count": 3, "request": 0.4,
                                "prefix": "late"}),
        ])


def partition_with_standby_takeover(seed: int) -> Scenario:
    """The primary scheduler is partitioned from the registry past the
    leadership TTL: its publishes roll back, its lease expires, the
    warm standby takes over at the next epoch and replays the bound
    set.  When the partition heals, the deposed primary's first fenced
    write (or refused renewal) must FREEZE it — writes from at most one
    epoch ever land, no bound pod is lost, no chip double-booked."""
    r = _rng("partition-with-standby-takeover", seed)
    part_at = _j(r, 0.8, 0.3)
    return Scenario(
        "partition-with-standby-takeover",
        "primary partitioned past the lease TTL; standby takes over, "
        "deposed leader freezes",
        [
            ChaosAction(0.0, "ha_enable"),
            ChaosAction(0.1, "submit", params={"count": 4,
                                               "request": 0.5}),
            ChaosAction(part_at, "registry_partition",
                        params={"duration_s": round(
                            2.5 + r.random() * 0.5, 3)}),
            ChaosAction(part_at + 0.1, "submit",
                        params={"count": 3, "request": 0.4,
                                "prefix": "late"}),
        ])


BUILDERS = {
    "node-crash-flap": node_crash_flap,
    "registry-restart-mid-lease": registry_restart_mid_lease,
    "proxy-kill-windowed-put": proxy_kill_windowed_put,
    "autopilot-vs-eviction": autopilot_vs_eviction,
    "park-during-migration": park_during_migration,
    "partition-during-gang-bind": partition_during_gang_bind,
    "gang-grant-vs-eviction": gang_grant_vs_eviction,
    "preemption-vs-migration": preemption_vs_migration,
    "cross-shard-gang-commit-fail": cross_shard_gang_commit_fail,
    "resize-mid-eviction": resize_mid_eviction,
    "resize-mid-churn": resize_mid_churn,
    "registry-leader-kill-mid-bind-publish":
        registry_leader_kill_mid_bind_publish,
    "partition-with-standby-takeover": partition_with_standby_takeover,
}


def build(name: str, seed: int) -> Scenario:
    try:
        return BUILDERS[name](seed)
    except KeyError:
        raise KeyError("unknown chaos scenario %r (have: %s)"
                       % (name, ", ".join(sorted(BUILDERS)))) from None


def all_scenarios(seed: int) -> list:
    return [b(seed) for b in BUILDERS.values()]
