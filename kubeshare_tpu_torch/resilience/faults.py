"""Deterministic, seedable fault injection for the isolation transport.

A copy of ``kubeshare_tpu/resilience/faults.py``: the same specs, the same
decisions for the same spec, seed and order of hook calls, and the same
``KUBESHARE_FAULTS`` / ``KUBESHARE_FAULT_SEED`` grammar. A process installs
one :class:`Injector` (in tests, or from the environment for a fault
drill) and the hooks consult it at fixed points:

- ``kill_conn_after_frames=N`` — the Nth frame *sent* by a matching
  client :class:`~..isolation.protocol.Connection` breaks the connection
  right after the bytes leave (the request may or may not have been
  handled: the ambiguity replay resolves);
- ``drop_reply_seq=K`` — the server's writer discards the reply tagged
  ``_seq == K`` (once): a lost reply, not a wedged server;
- ``crash_proxy_after_chunks=N`` — the Nth ``put_chunk`` the proxy
  handles crashes it (listener and every connection die, no cleanup
  runs: only the journal is left);
- ``delay_writer_ms=D`` — every server write batch sleeps first.

The control-plane hooks (heartbeat suppression and flapping, registry
and scheduler-service partitions) come along unchanged for the control
plane that will read them. :func:`compose` runs several specs at once:
every sub-injector is consulted on every call, decisions OR together,
writer delays add; ``KUBESHARE_FAULTS`` takes ``;``-separated groups.

This module imports nothing of ``isolation`` (the dependency points the
other way), and every decision is made under a lock from seeded state.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class FaultSpec:
    """What to inject. Zero/empty fields are inert."""

    #: break a client connection right after its Nth sent frame (1-based;
    #: 0 disables). Counted across all matching connections.
    kill_conn_after_frames: int = 0
    #: only connections whose ``fault_tag`` equals this are counted for
    #: ``kill_conn_after_frames``; empty matches every tagged-or-not
    #: connection.
    kill_conn_tag: str = ""
    #: fire the connection kill this many times (a reconnecting client
    #: can be killed again on its replacement connection).
    kill_conn_repeat: int = 1
    #: server writer drops the reply whose ``_seq`` equals this (once;
    #: 0 disables).
    drop_reply_seq: int = 0
    #: proxy hard-crashes on its Nth handled ``put_chunk`` (0 disables).
    crash_proxy_after_chunks: int = 0
    #: every server write batch sleeps this long first (0 disables).
    delay_writer_ms: float = 0.0
    #: suppress heartbeats from this node ("*" matches every node;
    #: empty disables).
    suppress_heartbeats_node: str = ""
    #: let this many beats through before suppression starts (0 =
    #: suppress from the first beat).
    suppress_heartbeats_after: int = 0
    #: flapping node: alternate flap_beats delivered / flap_beats
    #: suppressed for this node (empty disables).
    flap_node: str = ""
    flap_beats: int = 0
    #: fail the next N RegistryClient HTTP attempts with a transport
    #: error (0 disables).
    partition_registry_ops: int = 0
    #: fail the next N scheduler ServiceClient HTTP attempts with a
    #: transport error (0 disables) — the bridge-side partition the
    #: chaos plane drills (doc/chaos.md).
    drop_service_ops: int = 0
    #: seed for any randomized decision; fixed default keeps unseeded
    #: runs reproducible too.
    seed: int = 0


class Injector:
    """One process-wide fault decision engine over a :class:`FaultSpec`.

    All counters live here (not in the transport), guarded by one lock:
    the decisions are a pure function of the spec, the seed, and the
    order of hook calls — rerunning the same workload replays the same
    faults.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._mu = threading.Lock()
        self._rng = random.Random(spec.seed)
        self._frames = 0
        self._kills = 0
        self._chunks = 0
        self._dropped = False
        self._beats: dict[str, int] = {}     # per-node heartbeat count
        self._partitioned = 0                # registry ops failed so far
        self._service_dropped = 0            # service ops failed so far

    # -- client connection: frames sent ---------------------------------

    def should_kill_connection(self, tag: str, nframes: int) -> bool:
        """Called after a client connection wrote ``nframes`` frames.
        True → the caller must break the connection now."""
        spec = self.spec
        if not spec.kill_conn_after_frames:
            return False
        if spec.kill_conn_tag and tag != spec.kill_conn_tag:
            return False
        with self._mu:
            if self._kills >= spec.kill_conn_repeat:
                return False
            before = self._frames
            self._frames += int(nframes)
            # fire when the cumulative count crosses the threshold;
            # reset the frame counter so repeat kills need N more frames
            if (before < spec.kill_conn_after_frames
                    <= self._frames):
                self._kills += 1
                self._frames = 0
                return True
            return False

    # -- server writer ---------------------------------------------------

    def should_drop_reply(self, seq) -> bool:
        spec = self.spec
        if not spec.drop_reply_seq or seq is None:
            return False
        with self._mu:
            if self._dropped:
                return False
            if int(seq) == spec.drop_reply_seq:
                self._dropped = True
                return True
            return False

    def writer_delay_s(self) -> float:
        return max(self.spec.delay_writer_ms, 0.0) / 1000.0

    # -- control plane ---------------------------------------------------

    def should_suppress_heartbeat(self, node: str) -> bool:
        """Called per heartbeat a publisher is about to send; True → the
        beat must be silently dropped. Counts are per node, so one
        injector can drill one node while the rest of the fleet beats."""
        spec = self.spec
        suppress = spec.suppress_heartbeats_node and \
            spec.suppress_heartbeats_node in ("*", node)
        flap = spec.flap_node == node and spec.flap_beats > 0
        if not suppress and not flap:
            return False
        with self._mu:
            beat = self._beats.get(node, 0)
            self._beats[node] = beat + 1
        if suppress and beat >= spec.suppress_heartbeats_after:
            return True
        # flapping: K beats delivered, K suppressed, repeating
        return flap and (beat // spec.flap_beats) % 2 == 1

    def should_partition_registry(self) -> bool:
        """Called per RegistryClient HTTP attempt; True → the attempt
        must fail as if the network dropped it."""
        spec = self.spec
        if not spec.partition_registry_ops:
            return False
        with self._mu:
            if self._partitioned >= spec.partition_registry_ops:
                return False
            self._partitioned += 1
            return True

    def should_drop_service_call(self) -> bool:
        """Called per scheduler ServiceClient HTTP attempt; True → the
        attempt must fail as if the connection was refused."""
        spec = self.spec
        if not spec.drop_service_ops:
            return False
        with self._mu:
            if self._service_dropped >= spec.drop_service_ops:
                return False
            self._service_dropped += 1
            return True

    # -- proxy worker ----------------------------------------------------

    def should_crash_proxy(self) -> bool:
        """Called per handled ``put_chunk``; True exactly once, on the
        Nth call."""
        spec = self.spec
        if not spec.crash_proxy_after_chunks:
            return False
        with self._mu:
            self._chunks += 1
            return self._chunks == spec.crash_proxy_after_chunks


class CompositeInjector:
    """Several simultaneous fault specs behind one hook protocol.

    Every sub-injector is consulted on every hook call — each spec's
    counters advance as if it were installed alone, so composing spec A
    with spec B never shifts A's kill points (the property the chaos
    scenarios and the CI fault-matrix both lean on). Boolean decisions
    OR together; writer delays add.
    """

    def __init__(self, injectors):
        self.injectors: list[Injector] = list(injectors)

    @property
    def specs(self) -> list[FaultSpec]:
        return [inj.spec for inj in self.injectors]

    def _any(self, method: str, *args) -> bool:
        # consult EVERY sub-injector (no short-circuit): the decision
        # counters must advance identically whether or not a sibling
        # already fired this call
        fired = False
        for inj in self.injectors:
            fired = getattr(inj, method)(*args) or fired
        return fired

    def should_kill_connection(self, tag: str, nframes: int) -> bool:
        return self._any("should_kill_connection", tag, nframes)

    def should_drop_reply(self, seq) -> bool:
        return self._any("should_drop_reply", seq)

    def writer_delay_s(self) -> float:
        return sum(inj.writer_delay_s() for inj in self.injectors)

    def should_suppress_heartbeat(self, node: str) -> bool:
        return self._any("should_suppress_heartbeat", node)

    def should_partition_registry(self) -> bool:
        return self._any("should_partition_registry")

    def should_drop_service_call(self) -> bool:
        return self._any("should_drop_service_call")

    def should_crash_proxy(self) -> bool:
        return self._any("should_crash_proxy")


def compose(*parts) -> "Injector | CompositeInjector | None":
    """Build one injector from specs and/or injectors. One part passes
    through unwrapped (an ``Injector`` composed alone IS that injector —
    single-spec callers see identical behavior); several wrap into a
    :class:`CompositeInjector`."""
    injectors = [p if isinstance(p, (Injector, CompositeInjector))
                 else Injector(p) for p in parts]
    flat: list = []
    for inj in injectors:
        flat.extend(inj.injectors if isinstance(inj, CompositeInjector)
                    else [inj])
    if not flat:
        return None
    return flat[0] if len(flat) == 1 else CompositeInjector(flat)


_active: Injector | CompositeInjector | None = None
_install_mu = threading.Lock()


def install(injector: "Injector | CompositeInjector | None") -> None:
    """Install (or clear, with None) the process-wide injector."""
    global _active
    with _install_mu:
        _active = injector


def uninstall() -> None:
    install(None)


def active() -> "Injector | CompositeInjector | None":
    """The installed injector, or None. The hot-path check is one global
    read — with no injector installed the hooks cost nothing measurable."""
    return _active


def parse_spec(raw: str, default_seed: int = 0) -> FaultSpec:
    """One spec group: comma-separated ``key=value`` pairs matching
    :class:`FaultSpec` fields, e.g. ``kill_conn_after_frames=5,
    drop_reply_seq=3``."""
    kwargs: dict = {}
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        key, _, value = item.partition("=")
        key = key.strip()
        if key in ("kill_conn_tag", "suppress_heartbeats_node",
                   "flap_node"):
            kwargs[key] = value.strip()
        elif key == "delay_writer_ms":
            kwargs[key] = float(value)
        elif key in ("kill_conn_after_frames", "kill_conn_repeat",
                     "drop_reply_seq", "crash_proxy_after_chunks", "seed",
                     "suppress_heartbeats_after", "flap_beats",
                     "partition_registry_ops", "drop_service_ops"):
            kwargs[key] = int(value)
        else:
            raise ValueError(f"unknown fault field {key!r}")
    kwargs.setdefault("seed", default_seed)
    return FaultSpec(**kwargs)


def from_env(environ=None) -> "Injector | CompositeInjector | None":
    """Build an injector from ``KUBESHARE_FAULTS`` and
    ``KUBESHARE_FAULT_SEED``. Returns None when unset.

    ``;`` separates simultaneous spec groups (a composition); a group
    without its own ``seed=`` derives ``KUBESHARE_FAULT_SEED + index``
    so identical sibling specs never share a random stream. A single
    group (no ``;``) builds the same plain :class:`Injector` as ever.
    """
    env = os.environ if environ is None else environ
    raw = env.get("KUBESHARE_FAULTS", "").strip()
    if not raw:
        return None
    base_seed = int(env.get("KUBESHARE_FAULT_SEED", "0"))
    groups = [g for g in (part.strip() for part in raw.split(";")) if g]
    specs = [parse_spec(g, default_seed=base_seed + i)
             for i, g in enumerate(groups)]
    return compose(*specs)
