"""Per-pod manager: the bridge between a workload's gate and the device's
token scheduler.

Counterpart of ``kubeshare_tpu/isolation/podmgr.py`` (gem-pmgr parity):
one process per sharing pod, spawned and killed by the node launcher as
the pod appears in and leaves the per-device client list
(``launcher.py:34-66``), configured by ``SCHEDULER_IP``/
``SCHEDULER_PORT``/``KUBESHARE_TPU_POD_MANAGER_PORT``/
``KUBESHARE_TPU_POD_NAME``. The workload's
:class:`~.client.ExecutionGate` dials the manager's port; the manager
registers the pod on the token scheduler at startup, relays token
traffic, and unregisters on exit — so a dead pod manager (crashed pod)
frees the pod's share without scheduler-side timeouts. The JAX package's
native twin (``native/podmgr_relay.cpp``) is not ported.
"""

from __future__ import annotations

import os
import random
import time

from ..constants import ENV_POD_MANAGER_PORT, ENV_POD_NAME
from ..resilience.reconnect import (ReconnectPolicy, SessionLost,
                                    backoff_delays)
from ..utils.logger import get_logger
from . import protocol

log = get_logger("podmgr")


class PodManager:
    """Relay server: workload gate ⇄ (this) ⇄ token scheduler.

    Each downstream (gate) connection gets its own upstream connection to
    the scheduler, attached to the pod's one registered client — a single
    shared upstream would deadlock the device the moment two gate
    connections exist (a blocked ``acquire`` holds the channel, so the
    other gate's ``release`` can never get through). Per-connection token
    state is tracked so a workload that dies while *holding* the token has
    it released on disconnect, charged at wall time up to its quota.
    """

    #: bounded budget for the relay's break-and-reconnect: a scheduler
    #: restart is ridden out in place (as the JAX package's relays do), a
    #: scheduler that stays down surfaces as SessionLost on the gate
    RECONNECT = ReconnectPolicy(max_attempts=5, base_delay_s=0.05,
                                max_delay_s=0.5, dial_timeout_s=2.0)

    def __init__(self, scheduler_host: str, scheduler_port: int,
                 pod_name: str, request: float, limit: float,
                 connect_timeout: float | None = None):
        self.pod_name = pod_name
        self.request = request
        self.limit = limit
        self._sched_addr = (scheduler_host, scheduler_port)
        self._up = protocol.Connection(scheduler_host, scheduler_port,
                                       timeout=connect_timeout)
        self._up.call({"op": "register", "name": pod_name,
                       "request": request, "limit": limit})
        # registration done: this connection just holds the ownership
        # (its drop is the crash-cleanup signal) — drop the dial deadline
        self._up.sock.settimeout(None)
        self._server: protocol.FramedServer | None = None

    def serve(self, host: str = "127.0.0.1", port: int = 0
              ) -> protocol.FramedServer:
        self._server = protocol.serve_framed(host, port, self._handle,
                                             self._cleanup)
        log.info("pod manager for %s on %s:%d (request=%.2f limit=%.2f)",
                 self.pod_name, host, self._server.server_address[1],
                 self.request, self.limit)
        return self._server

    @property
    def port(self) -> int:
        if self._server is None:
            raise RuntimeError("pod manager is not serving")
        return self._server.server_address[1]

    def _handle(self, req: dict, state: dict) -> dict:
        op = req.get("op")
        if op == "register":
            # The gate introduces itself; identity is fixed to this pod —
            # a pod manager serves exactly its own pod.
            return {"ok": True, "name": self.pod_name}
        if op not in ("acquire", "renew", "release", "usage"):
            return {"ok": False, "error": f"unknown op {op!r}"}
        up = state.get("up")
        if up is None:
            up = protocol.Connection(*self._sched_addr)
            up.call({"op": "attach", "name": self.pod_name})
            state["up"] = up
        fwd = dict(req, name=self.pod_name)
        try:
            reply, _ = up.call(fwd)
        except OSError:
            # Transport error: Connection.call closed the socket.
            # Break-and-reconnect IN PLACE: re-dial with bounded backoff,
            # re-attach, and retry this op once on the fresh channel, so a
            # scheduler restart is
            # invisible to the gate. Only an exhausted budget (or a second
            # failure on the fresh channel) surfaces.
            state["up"] = None
            up = self._redial_upstream()
            state["up"] = up
            if state.get("holding"):
                # The scheduler does NOT crash-release on an attached
                # connection's death — this pod still holds the token. Its
                # usage since the grant went down with the old channel, so
                # release with the conservative wall-time charge and start
                # fresh: a renew becomes a plain acquire (its release half
                # already happened here).
                state["holding"] = False
                try:
                    up.call({"op": "release", "name": self.pod_name,
                             "used_ms": self._wall_charge(state)})
                except (OSError, RuntimeError):
                    pass
                if op == "renew":
                    fwd = {"op": "acquire", "name": self.pod_name}
                    if "timeout" in req:
                        fwd["timeout"] = req["timeout"]
            try:
                reply, _ = up.call(fwd)
            except OSError:
                # the fresh channel died too: disarm and surface
                state["up"] = None
                if op in ("acquire", "renew"):
                    state["holding"] = False
                raise
        except RuntimeError:
            # Upstream said ok:false (e.g. renew's re-request timed out).
            # The scheduler's renew releases the old token BEFORE
            # re-requesting, so a failed acquire/renew means this pod no
            # longer holds anything — leaving ``holding`` armed would
            # crash-release (and double-charge) stale quota on a later
            # disconnect.
            if op in ("acquire", "renew"):
                state["holding"] = False
            raise
        if op in ("acquire", "renew"):
            # hold only on a real grant
            if reply.get("quota_ms") is not None:
                state["holding"] = True
                state["quota_ms"] = float(reply["quota_ms"])
                state["grant_t"] = time.monotonic()
            else:
                state["holding"] = False
        elif op == "release":
            state["holding"] = False
        return reply

    @staticmethod
    def _wall_charge(state: dict) -> float:
        """What a holder that cannot report is charged: wall time since
        its grant, capped at the quota — conservative for limit
        enforcement (a crash-looping pod must not run rings around its
        limit by never reporting)."""
        elapsed = (time.monotonic() - state.get("grant_t", 0.0)) * 1000.0
        return min(max(elapsed, 0.0), state.get("quota_ms", 0.0))

    def _redial_upstream(self) -> protocol.Connection:
        """Bounded re-dial + re-attach to the token scheduler. Raises
        :class:`SessionLost` when the budget runs out."""
        delays = backoff_delays(self.RECONNECT, random.Random())
        last: Exception | None = None
        for attempt in range(self.RECONNECT.max_attempts):
            time.sleep(next(delays))
            try:
                up = protocol.Connection(
                    *self._sched_addr, timeout=self.RECONNECT.dial_timeout_s)
            except OSError as exc:
                last = exc
                continue
            try:
                up.call({"op": "attach", "name": self.pod_name})
            except (OSError, RuntimeError) as exc:
                up.close()
                last = exc
                continue
            up.sock.settimeout(None)
            log.info("upstream to %s:%d re-attached after %d attempt(s)",
                     self._sched_addr[0], self._sched_addr[1], attempt + 1)
            return up
        raise SessionLost(
            f"token scheduler at {self._sched_addr[0]}:"
            f"{self._sched_addr[1]} unreachable: {last}")

    def _cleanup(self, state: dict) -> None:
        up = state.get("up")
        if state.get("holding") and up is not None:
            # the workload died holding the token: crash-release
            try:
                up.call({"op": "release", "name": self.pod_name,
                         "used_ms": self._wall_charge(state)})
            except (OSError, RuntimeError):
                pass
        if up is not None:
            up.close()

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        try:
            self._up.call({"op": "unregister", "name": self.pod_name})
        except (OSError, RuntimeError):
            pass
        self._up.close()


def main(argv=None) -> None:
    """CLI with gem-pmgr's env contract (``launcher.py:41-56``). Prints
    ``READY <port>`` once it serves."""
    import argparse

    from ..utils import ready_until_signal

    parser = argparse.ArgumentParser(prog="kubeshare_tpu_torch.isolation.podmgr")
    parser.add_argument("--scheduler-ip",
                        default=os.environ.get("SCHEDULER_IP", "127.0.0.1"))
    parser.add_argument("--scheduler-port", type=int,
                        default=int(os.environ.get("SCHEDULER_PORT", "0")))
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get(ENV_POD_MANAGER_PORT, "0")))
    parser.add_argument("--pod-name",
                        default=os.environ.get(ENV_POD_NAME, ""))
    parser.add_argument("--request", type=float,
                        default=float(os.environ.get("POD_REQUEST", "0")))
    parser.add_argument("--limit", type=float,
                        default=float(os.environ.get("POD_LIMIT", "0")))
    args = parser.parse_args(argv)

    # Retry the initial register: the launcher brings the token scheduler
    # (the device's proxy) and the pod managers up concurrently. A 2 s
    # deadline per attempt bounds the whole loop (~10 s against an address
    # that refuses). A "duplicate client" refusal is transient in the
    # launcher's kill-then-respawn path (the old owner's disconnect may not
    # be reaped yet) and retries too; any other refusal fails fast.
    mgr = None
    last: Exception | None = None
    last_was_refusal = False
    for _ in range(40):
        try:
            mgr = PodManager(args.scheduler_ip, args.scheduler_port,
                             args.pod_name, args.request, args.limit,
                             connect_timeout=2.0)
            break
        except OSError as exc:
            last, last_was_refusal = exc, False
        except RuntimeError as exc:   # the scheduler ANSWERED with a refusal
            if "duplicate client" not in str(exc):
                raise SystemExit(f"register failed: {exc}")
            last, last_was_refusal = exc, True
        time.sleep(0.25)
    if mgr is None:
        if last_was_refusal:
            raise SystemExit(
                f"scheduler at {args.scheduler_ip}:{args.scheduler_port} "
                f"kept refusing registration: {last}")
        raise SystemExit(
            f"cannot reach scheduler at {args.scheduler_ip}:"
            f"{args.scheduler_port}: {last}")
    server = mgr.serve(port=args.port)
    ready_until_signal(f"READY {server.server_address[1]}")
    mgr.close()


if __name__ == "__main__":
    main()
