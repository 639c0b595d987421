"""Live migration of proxy sessions, driven from outside both proxies.

Counterpart of ``kubeshare_tpu/resilience/migrate.py``. A migration is
three conversations and a tombstone:

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

Migrations are counted by outcome (``kubeshare_migrations_total``) and
timed (``kubeshare_migration_duration_seconds``); with a ``trace_id`` the
move is a ``migrate`` span with a ``migrate.buffer`` span per tensor, and
the id rides both admin connections.
"""

from __future__ import annotations

import time

from ..isolation import protocol
from ..obs import metrics as obs_metrics
from ..obs.trace import get_tracer
from ..utils.logger import get_logger

log = get_logger("migrate")

_MIGRATIONS = obs_metrics.default_registry().counter(
    "kubeshare_migrations_total",
    "Session migrations by outcome.", labels=("outcome",))
_MIG_DUR = obs_metrics.default_registry().histogram(
    "kubeshare_migration_duration_seconds",
    "End-to-end session migration time (freeze -> copy -> flip).",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))


def migrate_session(source_addr: tuple, dest_addr: tuple, token: str, *,
                    drain: bool = False, chunk_bytes: int = 8 << 20,
                    timeout: float = 30.0, trace_id: str = "") -> dict:
    """Move the session ``token`` from ``source_addr`` to ``dest_addr``.
    Returns the migrated manifest with ``moved``, ``duration_s`` and
    ``bytes`` (tensor and program bytes copied). ``drain=True`` first stops
    the source admitting sessions (evacuating the card)."""
    t0 = time.monotonic()
    tracer = get_tracer() if trace_id else None
    span = (tracer.begin("migrate", trace_id, src=f"{source_addr[0]}:"
                         f"{source_addr[1]}", dst=f"{dest_addr[0]}:"
                         f"{dest_addr[1]}") if tracer else None)
    src = dst = None
    try:
        src = protocol.Connection(source_addr[0], int(source_addr[1]),
                                  timeout=timeout, trace_id=trace_id)
        dst = protocol.Connection(dest_addr[0], int(dest_addr[1]),
                                  timeout=timeout, trace_id=trace_id)
    except BaseException:
        if src is not None:
            src.close()
        _failed(tracer, span)
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
                moved += _copy_buffer(src, dst, token, spec, chunk_bytes,
                                      tracer, trace_id, span)
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
        _failed(tracer, span)
        raise
    finally:
        src.close()
        dst.close()
    duration = time.monotonic() - t0
    _MIGRATIONS.inc("moved")
    _MIG_DUR.observe(value=duration)
    if span is not None:
        span.attrs["outcome"] = "moved"
        span.attrs["buffers"] = len(manifest.get("buffers", ()))
        span.attrs["programs"] = len(manifest.get("programs", ()))
        tracer.finish(span)
    log.info("migrated session %r (%d buffers, %d programs, %d bytes) "
             "%s:%d -> %s:%d in %.3fs", manifest.get("name"),
             len(manifest.get("buffers", ())),
             len(manifest.get("programs", ())), moved,
             source_addr[0], int(source_addr[1]),
             dest_addr[0], int(dest_addr[1]), duration)
    return dict(manifest, moved=[dest_addr[0], int(dest_addr[1])],
                duration_s=duration, bytes=moved)


def _failed(tracer, span) -> None:
    _MIGRATIONS.inc("failed")
    if span is not None:
        span.attrs["outcome"] = "failed"
        tracer.finish(span)


def _copy_buffer(src: protocol.Connection, dst: protocol.Connection,
                 token: str, spec: dict, chunk_bytes: int, tracer,
                 trace_id: str, parent) -> int:
    """Stream one tensor source → destination, each exported slice sent
    on at once as an import chunk (never whole on the mover). Returns the
    bytes moved."""
    handle = int(spec["handle"])
    sub = (tracer.begin("migrate.buffer", trace_id,
                        parent_id=parent.span_id if parent else "",
                        handle=handle) if tracer else None)
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
    if sub is not None:
        sub.attrs["nbytes"] = total
        tracer.finish(sub)
    return total
