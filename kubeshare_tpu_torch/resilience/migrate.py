"""Live migration of proxy sessions, driven from outside both proxies.

Counterpart of ``kubeshare_tpu/resilience/migrate.py``, without its
metrics and trace spans. A migration is three conversations and a
tombstone:

1. **freeze** — ``migrate_begin`` on the source kicks the session's
   connection and marks it migrating: while its bytes are in flight a
   resume waits a moment for the move, then is refused with a retryable
   error;
2. **copy** — ``export_session`` hands over the manifest (identity,
   replay state, buffers, programs); each tensor streams source →
   destination in chunks (``export_buffer`` slices on one side,
   ``import_buffer_*`` staging on the other; handles that name one tensor
   travel once and name one tensor again), and each program travels
   with its original ``exec_id`` (a saved program as its bytes, through
   the destination's compile checks; a registered one as its spec), so
   the client's handles and exec ids stay valid;
3. **flip** — ``migrate_finish`` drops the source's copy and leaves a
   ``moved`` tombstone: a client that resumes at the old address is
   sent to the new one and replays there.

Losing the migration before ``migrate_finish`` (the one destructive step,
run last) leaves the source authoritative: the mover unfreezes it with
``migrate_abort`` (best effort: a source that is gone needs none), and the
client resumes there. The mover holds the session's resume token, which
is the capability; it is a client of neither proxy.
"""

from __future__ import annotations

import time

from ..isolation import protocol
from ..utils.logger import get_logger

log = get_logger("migrate")


def migrate_session(source_addr: tuple, dest_addr: tuple, token: str, *,
                    drain: bool = False, chunk_bytes: int = 8 << 20,
                    timeout: float = 30.0) -> dict:
    """Move the session ``token`` from ``source_addr`` to ``dest_addr``.
    Returns the migrated manifest with ``moved``, ``duration_s`` and
    ``bytes`` (tensor and program bytes copied). ``drain=True`` first stops
    the source admitting sessions (evacuating the card)."""
    t0 = time.monotonic()
    src = protocol.Connection(source_addr[0], int(source_addr[1]),
                              timeout=timeout)
    try:
        dst = protocol.Connection(dest_addr[0], int(dest_addr[1]),
                                  timeout=timeout)
    except BaseException:
        src.close()
        raise
    moved = 0
    frozen = False
    try:
        if drain:
            src.call({"op": "drain"})
        src.call({"op": "migrate_begin", "token": token})
        frozen = True
        rep, _ = src.call({"op": "export_session", "token": token})
        manifest = rep["manifest"]
        dst.call({"op": "import_session", "manifest": manifest})
        for spec in manifest.get("buffers", ()):
            if spec.get("alias_of") is None:
                moved += _copy_buffer(src, dst, token, spec, chunk_bytes)
        for spec in manifest.get("programs", ()):
            exec_id = int(spec["exec_id"])
            prep, blob = src.call({"op": "export_program", "token": token,
                                   "exec_id": exec_id})
            msg = {"op": "import_program", "token": token,
                   "exec_id": exec_id, "ncarry": prep.get("ncarry")}
            if "spec" in prep:
                msg.update(spec=prep["spec"], in_meta=prep["in_meta"])
                dst.call(msg)
            else:
                moved += len(blob)
                dst.call(msg, blob=bytes(blob))
        # the point of no return: the source's copy drops, the tombstone
        # goes up
        src.call({"op": "migrate_finish", "token": token,
                  "moved": [dest_addr[0], int(dest_addr[1])]})
    except BaseException:
        if frozen:
            try:
                src.call({"op": "migrate_abort", "token": token})
            except (OSError, RuntimeError):
                pass
        raise
    finally:
        src.close()
        dst.close()
    duration = time.monotonic() - t0
    log.info("migrated session %r (%d buffers, %d programs, %d bytes) "
             "%s:%d -> %s:%d in %.3fs", manifest.get("name"),
             len(manifest.get("buffers", ())),
             len(manifest.get("programs", ())), moved,
             source_addr[0], int(source_addr[1]),
             dest_addr[0], int(dest_addr[1]), duration)
    return dict(manifest, moved=[dest_addr[0], int(dest_addr[1])],
                duration_s=duration, bytes=moved)


def _copy_buffer(src: protocol.Connection, dst: protocol.Connection,
                 token: str, spec: dict, chunk_bytes: int) -> int:
    """Stream one tensor source → destination, each exported slice sent
    on at once as an import chunk (never whole on the mover). Returns the
    bytes moved."""
    handle = int(spec["handle"])
    off, total, sid = 0, None, None
    while total is None or off < total:
        length = chunk_bytes if total is None else min(chunk_bytes,
                                                       total - off)
        rep, blob = src.call({"op": "export_buffer", "token": token,
                              "handle": handle, "offset": off,
                              "length": length})
        total = int(rep["total"])
        if sid is None:
            brep, _ = dst.call({"op": "import_buffer_begin",
                                "token": token, "handle": handle,
                                "nbytes": total})
            sid = brep["staging"]
        dst.call({"op": "import_buffer_chunk", "token": token,
                  "staging": sid, "offset": off}, blob=blob)
        off += memoryview(blob).nbytes
    dst.call({"op": "import_buffer_commit", "token": token,
              "staging": sid})
    return total
