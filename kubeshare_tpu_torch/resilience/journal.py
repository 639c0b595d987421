"""Durable per-session state for the chip proxy.

Counterpart of ``kubeshare_tpu/resilience/journal.py``. The proxy keeps
every session's state in memory; this journal is the optional on-disk
mirror that survives a proxy crash. One JSON manifest per session, keyed
by its resume token, and sidecar files for the bulky parts:

```
<dir>/<token>.json               # manifest (atomic tmp + rename)
<dir>/<token>.g<gen>.npy         # one per device tensor, numpy only
<dir>/<token>.prog<exec_id>.bin  # a saved program's bytes
```

Unlike the JAX proxy's buffers, a port buffer can change in place: the
exported train step runs fused Adam on its parameters and returns them.
So a tensor's sidecar is never rewritten. A changed tensor goes to a new
sidecar under a fresh *generation* ``gen``; the manifest's atomic rename
switches every handle on that tensor to it, and the old sidecar is
deleted after. A crash anywhere leaves a manifest whose sidecars, reply
cache and request watermark describe one moment.

Recovery trusts these files no more than a tenant's request: tokens and
generations are numbers and hex the journal makes itself (a manifest
names no path), sidecars load with ``allow_pickle=False`` and are held to
the manifest's shape and dtype, and programs go back through the proxy's
compile checks (:mod:`..isolation.exported`, :mod:`..isolation.programs`).

Every write is best-effort: a failure degrades durability and is logged,
never raised into the live session. With ``dirpath=None`` every method is
a no-op. The journal's size on disk is the ``kubeshare_proxy_journal_
bytes`` gauge, kept as a running total of the files it writes and deletes
(a listing per write, as the JAX journal makes, would cost the port's
per-step sidecars a directory scan each).
"""

from __future__ import annotations

import json
import os
import re
import threading

import numpy as np

from ..obs import metrics as obs_metrics
from ..utils.logger import get_logger

log = get_logger("journal")

_JOURNAL_BYTES = obs_metrics.default_registry().gauge(
    "kubeshare_proxy_journal_bytes",
    "Total on-disk size of the proxy's session journal (manifests + "
    "buffer/program sidecars).")

_TOKEN = re.compile(r"[0-9a-f]{32}")


def valid_token(token) -> bool:
    """A resume token as the proxy mints it (``uuid4().hex``)."""
    return isinstance(token, str) and _TOKEN.fullmatch(token) is not None


class SessionJournal:
    """On-disk session journal; see the module docstring."""

    def __init__(self, dirpath: str | None = None):
        self.dirpath = dirpath
        self._mu = threading.Lock()
        #: bytes written since this journal was opened (manifests and
        #: sidecars), what a run pays for its durability
        self.bytes_written = 0
        #: bytes of each file in the directory, and their sum
        self._sizes: dict[str, int] = {}
        self._total = 0
        if dirpath:
            os.makedirs(dirpath, exist_ok=True)
            for name in os.listdir(dirpath):
                try:
                    self._sized(name, os.path.getsize(self._path(name)))
                except OSError:
                    pass

    def _sized(self, name: str, size: int | None) -> None:
        """``name`` now holds ``size`` bytes (None: deleted); the gauge
        follows the running total."""
        with self._mu:
            old = (self._sizes.pop(name, 0) if size is None
                   else self._sizes.get(name, 0))
            if size is not None:
                self._sizes[name] = size
            self._total += (size or 0) - old
            total = self._total
        _JOURNAL_BYTES.set(value=float(total))

    @property
    def enabled(self) -> bool:
        return bool(self.dirpath)

    # -- paths -----------------------------------------------------------

    def _path(self, name: str) -> str:
        return os.path.join(self.dirpath, name)

    @staticmethod
    def buffer_name(token: str, gen: int) -> str:
        return f"{token}.g{int(gen)}.npy"

    @staticmethod
    def program_name(token: str, exec_id: int) -> str:
        return f"{token}.prog{int(exec_id)}.bin"

    def _write(self, name: str, write) -> bool:
        """``write(file)`` into ``name`` through a tmp file, fsynced and
        renamed; False (logged) when it failed."""
        path = self._path(name)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                write(f)
                f.flush()
                os.fsync(f.fileno())
                size = f.tell()
            os.replace(tmp, path)
        except OSError as exc:
            log.warning("journal write of %s failed: %s", name, exc)
            return False
        with self._mu:
            self.bytes_written += size
        self._sized(name, size)
        return True

    # -- writes ----------------------------------------------------------

    def checkpoint(self, manifest: dict) -> None:
        """Write a session's manifest atomically: a crash mid-write leaves
        the previous manifest, never a torn one."""
        if not self.enabled:
            return
        data = json.dumps(manifest).encode()
        self._write(f"{manifest['token']}.json", lambda f: f.write(data))

    def save_buffer(self, token: str, gen: int, array: np.ndarray) -> None:
        if not self.enabled:
            return
        self._write(self.buffer_name(token, gen),
                    lambda f: np.save(f, array, allow_pickle=False))

    def drop_buffer(self, token: str, gen: int) -> None:
        if self.enabled:
            name = self.buffer_name(token, gen)
            try:
                os.unlink(self._path(name))
            except OSError:
                pass
            self._sized(name, None)

    def save_program(self, token: str, exec_id: int, blob) -> None:
        if self.enabled:
            self._write(self.program_name(token, exec_id),
                        lambda f: f.write(bytes(blob)))

    def purge(self, token: str) -> None:
        """Remove every file of a session (dropped, moved away, or
        expired)."""
        if not self.enabled:
            return
        try:
            names = os.listdir(self.dirpath)
        except OSError:
            return
        for name in names:
            if name.startswith(f"{token}."):
                try:
                    os.unlink(self._path(name))
                except OSError:
                    pass
                self._sized(name, None)

    # -- reads -----------------------------------------------------------

    def load_buffer(self, token: str, gen: int) -> np.ndarray:
        return np.load(self._path(self.buffer_name(token, gen)),
                       allow_pickle=False)

    def load_program(self, token: str, exec_id: int) -> bytes:
        with open(self._path(self.program_name(token, exec_id)), "rb") as f:
            return f.read()

    def size(self) -> int:
        """Bytes on disk now."""
        if not self.enabled:
            return 0
        total = 0
        for name in os.listdir(self.dirpath):
            try:
                total += os.path.getsize(self._path(name))
            except OSError:
                pass
        return total

    def recover(self) -> list[dict]:
        """Manifests of every journaled session, for a proxy restart. A
        manifest that does not parse, or whose token the proxy did not
        mint, is skipped with a warning (one bad session must not keep
        the card from coming back); files no manifest references (a write
        a crash interrupted, a generation already replaced) are
        deleted."""
        if not self.enabled:
            return []
        try:
            names = sorted(os.listdir(self.dirpath))
        except OSError:
            return []
        manifests: list[dict] = []
        referenced: set[str] = set()
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(self._path(name)) as f:
                    manifest = json.load(f)
                token = manifest["token"]
                if not valid_token(token) or name != f"{token}.json":
                    raise ValueError(f"token {token!r} is not one the "
                                     f"proxy minted")
                files = {self.buffer_name(token, int(b["gen"]))
                         for b in manifest.get("buffers", ())}
                files |= {self.program_name(token, int(p["exec_id"]))
                          for p in manifest.get("programs", ())
                          if "spec" not in p}
            except (OSError, ValueError, KeyError, TypeError) as exc:
                log.warning("skipping journal manifest %s: %s", name, exc)
                continue
            manifests.append(manifest)
            referenced |= files | {name}
        for name in names:
            if name.endswith(".tmp") or (not name.endswith(".json")
                                         and name not in referenced):
                try:
                    os.unlink(self._path(name))
                except OSError:
                    pass
                self._sized(name, None)
        return manifests
