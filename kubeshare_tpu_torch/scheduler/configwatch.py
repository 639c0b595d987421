"""Topology-config file watching.

The port's copy of ``kubeshare_tpu/scheduler/configwatch.py``.

Parity with ``pkg/scheduler/config.go:122-136``: the reference watches the
cluster topology YAML with fsnotify and **exits the process** on change,
relying on the container restart to rebuild all state (comment: restart
is the only safe way to rewire the cell trees mid-flight). Here the
default action is the same deliberate exit; an in-process callback can be
supplied instead — useful with auto-derived configs and for tests.

No inotify in the stdlib: mtime+size polling, cheap at 1 Hz for one file.
"""

from __future__ import annotations

import os
import threading

from ..utils.logger import get_logger

log = get_logger("configwatch")

DEFAULT_POLL_S = 1.0


def _restart_process() -> None:  # pragma: no cover - kills the process
    log.warning("topology config changed; exiting for a clean rebuild "
                "(config.go:129-135 parity)")
    os._exit(0)


class ConfigWatcher:
    """Poll one file; fire ``on_change`` when it changes."""

    def __init__(self, path: str, on_change=_restart_process,
                 poll_s: float = DEFAULT_POLL_S):
        self.path = path
        self.on_change = on_change
        self.poll_s = poll_s
        self._sig = self._signature()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _signature(self):
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        return (st.st_mtime, st.st_size)

    def check_once(self) -> bool:
        sig = self._signature()
        if sig == self._sig:
            return False
        self._sig = sig
        log.info("config %s changed", self.path)
        self.on_change()
        return True

    def run_forever(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.check_once()

    def start(self) -> "ConfigWatcher":
        self._thread = threading.Thread(target=self.run_forever, daemon=True,
                                        name="configwatch")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
