"""Run a function on n gloo ranks, n processes on the CPU — the port's
fake multi-device backend.

Counterpart of ``kubeshare_tpu/utils/virtualcpu.py``. The JAX package
fakes several chips as virtual CPU devices in ONE process
(``force_virtual_cpu``, which sets XLA's host device count); that has no
counterpart here, since the port runs one process per device. Instead
:class:`RankPool` starts n processes joined in one ``torch.distributed``
gloo group (a TCP store on a free port of this host) and runs functions
on all of them at once. The functions are pickled by reference, so they
must live at the top level of a module the workers can import.
"""

from __future__ import annotations

import multiprocessing
import socket
import traceback
from datetime import timedelta

#: seconds a rank waits in a collective (and at the rendezvous) before
#: it fails, so a mismatched collective ends a run rather than hangs it
RANK_TIMEOUT_S = 60.0
#: torch threads a rank runs: one, so that n ranks beside other work on
#: the host do not oversubscribe its cores
RANK_THREADS = 1


def free_port() -> int:
    """A TCP port the OS has free on this host right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, conn) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(RANK_THREADS)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=timedelta(seconds=RANK_TIMEOUT_S))
        conn.send(("ready", None))
    except Exception:
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            task = conn.recv()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except Exception:
                conn.send(("err", traceback.format_exc()))
    except EOFError:
        pass
    finally:
        dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank raised, or did not answer in time; ``errors`` holds each
    failing rank's traceback."""

    def __init__(self, errors: dict):
        self.errors = errors
        first = next(iter(errors.items()))
        super().__init__(f"rank {first[0]} failed:\n{first[1]}")


class RankPool:
    """``n`` processes in one gloo group; :meth:`run` calls
    ``fn(*args, **kwargs)`` on every rank and returns the results in rank
    order. A failed run (a rank raised, or one timed out) closes the pool:
    the group may be left mid-collective."""

    def __init__(self, n: int):
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self.n = n
        self._conns, self._procs = [], []
        for rank in range(n):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker, daemon=True,
                               args=(rank, n, port, child))
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self._collect()

    def _collect(self) -> list:
        results, errors = [], {}
        for rank, conn in enumerate(self._conns):
            if not conn.poll(RANK_TIMEOUT_S + 30.0):
                errors[rank] = f"no answer in {RANK_TIMEOUT_S + 30.0} s"
                results.append(None)
                continue
            kind, value = conn.recv()
            if kind == "err":
                errors[rank] = value
            results.append(value)
        if errors:
            self.close()
            raise RankError(errors)
        return results

    def run(self, fn, *args, **kwargs) -> list:
        if not self._procs:
            raise RuntimeError("rank pool is closed")
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        return self._collect()

    def close(self) -> None:
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        for proc in self._procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

