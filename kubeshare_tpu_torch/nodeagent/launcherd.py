"""The per-node launcher daemon — process lifecycle for the isolation
runtime.

Counterpart of ``kubeshare_tpu/nodeagent/launcherd.py`` (parity with the
reference's gemini-scheduler container, ``launcher-multigpus.sh:22-40`` +
``launcher.py``): one long-lived scheduler process per device, a watch on
the per-device client files, and one pod-manager process spawned or killed
per client entry (``launcher.py:34-66``, kill = process group).

GPU shape: the per-device process is the port's :mod:`..isolation.proxy`
pinned to its card by ``CUDA_VISIBLE_DEVICES``; it embeds the token
scheduler and serves execution on ``SCHD_PORT_START + i`` and token
traffic for pod managers on a sibling port. Watching is mtime polling (the
files are written atomically, so a poll never sees a torn file). With
``--registry-host`` the CLI also publishes the node's heartbeat lease to
the telemetry registry, as the JAX daemon does; its remote-write option is
not ported yet.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading

from .. import constants as C
from ..utils.logger import get_logger
from .files import read_chip_clients

log = get_logger("launcherd")

DEFAULT_POLL_S = 0.5
TOKEN_PORT_OFFSET = 1000


def exec_port_map(chip_ids: list[str]) -> dict[str, int]:
    """device → proxy execution port, by discovery order (gem-schd's
    49901+i rule, ``launcher.py:27-29``)."""
    return {chip: C.SCHD_PORT_START + i for i, chip in enumerate(chip_ids)}


def _daemon_env() -> dict:
    # the node's own daemons are never metered, whatever the launcher's
    # environment carries
    return dict(os.environ, **{C.ENV_ATTACH_MODE: "off"})


def default_proxy_cmd(chip_id: str, index: int, exec_port: int,
                      token_port: int) -> tuple[list[str], dict]:
    """The real per-device command (gem-schd launch parity,
    ``launcher.py:22-32``), pinned to device ``index`` of the launcher's
    own view (an entry of its ``CUDA_VISIBLE_DEVICES`` when that is set)."""
    env = _daemon_env()
    visible = [d for d in env.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if d.strip()]
    env["CUDA_VISIBLE_DEVICES"] = visible[index] if visible else str(index)
    cmd = [sys.executable, "-m", "kubeshare_tpu_torch.isolation.proxy",
           "-P", str(exec_port), "-S", str(token_port)]
    return cmd, env


def default_pmgr_cmd(name: str, port: int, request: float, limit: float,
                     token_port: int) -> tuple[list[str], dict]:
    """The real pod-manager command (gem-pmgr env contract,
    ``launcher.py:41-56``): the port's Python :mod:`..isolation.podmgr`.
    The JAX package's native C++ relay is not ported: the manager relays
    one renew a quota, and no measurement shows that hop's cost."""
    env = _daemon_env()
    env.update({
        "SCHEDULER_IP": "127.0.0.1",
        "SCHEDULER_PORT": str(token_port),
        C.ENV_POD_MANAGER_PORT: str(port),
        C.ENV_POD_NAME: name,
        "POD_REQUEST": str(request),
        "POD_LIMIT": str(limit),
    })
    return [sys.executable, "-m", "kubeshare_tpu_torch.isolation.podmgr"], env


class LauncherDaemon:
    """Supervise per-device proxies + per-client pod managers."""

    def __init__(self, chip_ids: list[str], base_dir: str = C.SCHEDULER_DIR,
                 poll_s: float = DEFAULT_POLL_S,
                 proxy_cmd=default_proxy_cmd, pmgr_cmd=default_pmgr_cmd,
                 spawn_proxies: bool = True):
        self.chip_ids = list(chip_ids)
        self.base_dir = base_dir
        self.poll_s = poll_s
        self.proxy_cmd = proxy_cmd
        self.pmgr_cmd = pmgr_cmd
        self.spawn_proxies = spawn_proxies
        self.exec_ports = exec_port_map(self.chip_ids)
        self._proxies: dict[str, subprocess.Popen] = {}
        # (chip_id, client name) -> (port, process)
        self._managers: dict[tuple[str, str], tuple[int, subprocess.Popen]] = {}
        self._mtimes: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- process helpers ---------------------------------------------------

    def _spawn(self, cmd: list[str], env: dict) -> subprocess.Popen:
        return subprocess.Popen(cmd, env=env, start_new_session=True)

    def _kill(self, proc: subprocess.Popen) -> None:
        """Kill the whole process group (``launcher.py:58-66`` parity — a
        pod manager's children must not outlive it)."""
        if proc.poll() is not None:
            return
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def token_port(self, chip_id: str) -> int:
        return self.exec_ports[chip_id] + TOKEN_PORT_OFFSET

    # -- reconciliation ----------------------------------------------------

    def ensure_proxies(self) -> None:
        if not self.spawn_proxies:
            return
        for i, chip_id in enumerate(self.chip_ids):
            proc = self._proxies.get(chip_id)
            if proc is not None and proc.poll() is None:
                continue
            if proc is not None:
                log.warning("proxy for %s died (rc=%s); restarting",
                            chip_id, proc.returncode)
            cmd, env = self.proxy_cmd(chip_id, i, self.exec_ports[chip_id],
                                      self.token_port(chip_id))
            self._proxies[chip_id] = self._spawn(cmd, env)
            log.info("proxy for %s on port %d", chip_id,
                     self.exec_ports[chip_id])

    def reconcile_chip(self, chip_id: str) -> None:
        """Diff desired client entries against running managers
        (``update_podmanager``, launcher.py:34-66)."""
        desired = {e.name: e for e in
                   read_chip_clients(chip_id, self.base_dir) if e.port}
        running = {name: pm for (chip, name), pm in self._managers.items()
                   if chip == chip_id}
        for name, (port, proc) in running.items():
            entry = desired.get(name)
            if entry is None or entry.port != port or proc.poll() is not None:
                self._kill(proc)
                del self._managers[(chip_id, name)]
                log.info("manager for %s on %s stopped", name, chip_id)
        for name, entry in desired.items():
            if (chip_id, name) in self._managers:
                continue
            cmd, env = self.pmgr_cmd(name, entry.port, entry.request,
                                     entry.limit, self.token_port(chip_id))
            self._managers[(chip_id, name)] = (entry.port,
                                               self._spawn(cmd, env))
            log.info("manager for %s on %s port %d", name, chip_id,
                     entry.port)

    def poll_once(self) -> list[str]:
        """One watch tick: restart dead proxies, reconcile devices whose
        files changed (or whose managers died). Returns the reconciled
        devices."""
        self.ensure_proxies()
        changed = []
        config_dir = os.path.join(self.base_dir, "config")
        for chip_id in self.chip_ids:
            path = os.path.join(config_dir, chip_id.replace("/", "_"))
            try:
                mtime = os.stat(path).st_mtime
            except OSError:
                continue
            dead = any(chip == chip_id and proc.poll() is not None
                       for (chip, _), (_, proc) in self._managers.items())
            if self._mtimes.get(path) == mtime and not dead:
                continue
            self._mtimes[path] = mtime
            self.reconcile_chip(chip_id)
            changed.append(chip_id)
        return changed

    def run_forever(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.poll_once()

    def start(self) -> "LauncherDaemon":
        self.poll_once()
        self._thread = threading.Thread(target=self.run_forever, daemon=True,
                                        name="launcherd")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        for _, proc in self._managers.values():
            self._kill(proc)
        self._managers.clear()
        for proc in self._proxies.values():
            self._kill(proc)
        self._proxies.clear()


def main(argv=None) -> None:
    """``python -m kubeshare_tpu_torch.nodeagent.launcherd [--base-dir D]
    [--registry-host H --registry-port N]`` — supervise one proxy per
    visible CUDA device (``--backend fake`` for a fake fleet) and the pod
    managers its client files ask for; with a registry, beat the node's
    lease there too (the launcher is the node's liveness: if it dies, the
    lease stops renewing). Prints ``READY`` once the first reconcile ran
    and the heartbeat started."""
    import argparse

    from ..topology.discovery import discover_chips
    from ..utils import default_node_name, ready_until_signal

    parser = argparse.ArgumentParser(
        prog="kubeshare_tpu_torch.nodeagent.launcherd")
    parser.add_argument("--node", default=default_node_name())
    parser.add_argument("--base-dir", default=C.SCHEDULER_DIR)
    parser.add_argument("--backend", default="auto")
    parser.add_argument("--poll", type=float, default=DEFAULT_POLL_S)
    parser.add_argument("--registry-host", default="",
                        help="publish heartbeat leases to this telemetry "
                             "registry; empty = no heartbeating "
                             "(standalone launcher)")
    parser.add_argument("--registry-port", type=int,
                        default=C.REGISTRY_PORT)
    parser.add_argument("--lease-ttl", type=float, default=C.LEASE_TTL_S)
    args = parser.parse_args(argv)

    chips = discover_chips(args.backend, host=args.node)
    daemon = LauncherDaemon([c.chip_id for c in chips],
                            base_dir=args.base_dir, poll_s=args.poll)
    daemon.start()
    heartbeat = None
    if args.registry_host:
        from ..telemetry.heartbeat import Heartbeater
        from ..telemetry.registry import RegistryClient

        heartbeat = Heartbeater(
            RegistryClient(args.registry_host, args.registry_port),
            args.node, ttl_s=args.lease_ttl).start()
    try:
        ready_until_signal("READY")
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        daemon.stop()


if __name__ == "__main__":
    main()
