"""Client side of the isolation runtime.

Counterpart of ``kubeshare_tpu/isolation/client.py``'s
:class:`ProxyClient`: the stand-in for the card in a client that never
owns it. The client stages its state on the host with numpy, ``put``s it,
and runs registered programs (:mod:`.programs`) on the proxy; tensors live
there as handles (:class:`RemoteBuffer`), so a training loop transfers
its parameters once.

Lockstep connection only; the pipelined transport, reconnect-and-resume,
``ExecutionGate`` and ``HbmCap`` are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import protocol
from .protocol import load_array


@dataclass(frozen=True)
class RemoteBuffer:
    """A device-resident tensor on the proxy."""

    handle: int
    shape: tuple[int, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(
            self.dtype).itemsize


class RemoteLoop:
    """A compiled loop program (see :meth:`ProxyClient.compile_loop`).

    ``new_carry, aux = loop(n, carry, *consts)`` runs up to ``n`` steps on
    the proxy in one token-gated burst; :meth:`chain` runs toward ``n``
    steps as a server-side chain of bursts. The old carry's handles are
    consumed (the proxy updates the carry in place); consts persist.
    """

    def __init__(self, client: "ProxyClient", exec_id: int, carry_def,
                 out_meta: list, ncarry: int, naux: int):
        self._client = client
        self._exec_id = exec_id
        self._carry_def = carry_def
        self.out_meta = out_meta
        self._ncarry = ncarry
        self._naux = naux
        #: steps the proxy actually ran on the last call — it may clamp a
        #: long burst to keep one dispatch near the scheduling quantum
        self.last_n = 0
        #: the per-burst clamp inside the last call (equals last_n for a
        #: plain call) — the burst controller's steady state
        self.last_burst = 0

    def __call__(self, n: int, carry, *consts):
        return self._dispatch(int(n), carry, consts, chain=False)

    def chain(self, n: int, carry, *consts):
        """Run toward ``n`` steps with server-side burst chaining. May stop
        early; ``last_n`` reports the steps run."""
        return self._dispatch(int(n), carry, consts, chain=True)

    def _dispatch(self, n: int, carry, consts, chain: bool):
        if n < 1:
            raise ValueError(f"loop count must be >= 1, got {n}")
        leaves = tree_leaves((carry, *consts))
        if not all(isinstance(x, RemoteBuffer) for x in leaves):
            raise TypeError("RemoteLoop args must be device-resident "
                            "(put them first)")
        msg = {"op": "execute", "name": self._client.name,
               "exec_id": self._exec_id,
               "args": [b.handle for b in leaves],
               "donate": [b.handle for b in leaves[:self._ncarry]]}
        msg["chain_steps" if chain else "repeat"] = n
        reply, _ = self._client._conn.call(msg)
        self.last_n = int(reply["repeat"])
        self.last_burst = int(reply.get("burst", self.last_n))
        out = [RemoteBuffer(h, tuple(shape), dtype)
               for h, (shape, dtype) in zip(reply["handles"], self.out_meta)]
        new_carry = tree_unflatten(self._carry_def, out[:self._ncarry])
        aux = out[self._ncarry:]
        return new_carry, (aux[0] if self._naux == 1 else tuple(aux))


class ProxyClient:
    """Connection to a :class:`~.proxy.ChipProxy` for one named client."""

    def __init__(self, host: str, port: int, name: str, request: float,
                 limit: float, memory: int = 0,
                 timeout: float | None = None):
        self.name = name
        self._conn = protocol.Connection(host, port, timeout=timeout)
        reply, _ = self._conn.call({"op": "register", "name": name,
                                    "request": request, "limit": limit,
                                    "memory": memory})
        self.platforms: list[str] = reply["platforms"]
        self.device: str = reply.get("device", "")

    # -- buffers -------------------------------------------------------------

    def put(self, array) -> RemoteBuffer:
        """Upload a host (numpy) array."""
        reply, _ = self._conn.call(
            {"op": "put", "name": self.name},
            blob=protocol.dump_array_parts(np.asarray(array)))
        return RemoteBuffer(reply["handle"], tuple(reply["shape"]),
                            reply["dtype"])

    def get(self, buf: RemoteBuffer) -> np.ndarray:
        _, blob = self._conn.call({"op": "get", "name": self.name,
                                   "handle": buf.handle})
        return load_array(blob)

    def free(self, *bufs) -> None:
        handles = [b.handle for b in tree_leaves(bufs)
                   if isinstance(b, RemoteBuffer)]
        if handles:
            self._conn.call({"op": "free", "name": self.name,
                             "handles": handles})

    def put_tree(self, tree):
        """Upload a tree of host arrays → same-shaped tree of buffers."""
        return tree_map(self.put, tree)

    def get_tree(self, tree):
        return tree_map(
            lambda b: self.get(b) if isinstance(b, RemoteBuffer) else b, tree)

    # -- programs ------------------------------------------------------------

    def compile_loop(self, spec: dict, carry, *consts) -> RemoteLoop:
        """Compile the registered program ``spec`` as a loop program over
        ``carry`` (a tree of :class:`RemoteBuffer`) and ``consts``; only
        their shapes and dtypes are sent."""
        carry_leaves, carry_def = tree_flatten(carry)
        leaves = carry_leaves + tree_leaves(consts)
        if not all(isinstance(x, RemoteBuffer) for x in leaves):
            raise TypeError("compile_loop args must be device-resident "
                            "(put them first)")
        reply, _ = self._conn.call({
            "op": "compile", "name": self.name, "spec": spec,
            "ncarry": len(carry_leaves),
            "in_meta": [[list(b.shape), b.dtype] for b in leaves]})
        return RemoteLoop(self, reply["exec_id"], carry_def,
                          reply["out_meta"], len(carry_leaves),
                          int(reply["naux"]))

    def usage(self) -> dict:
        reply, _ = self._conn.call({"op": "usage", "name": self.name})
        return reply

    def close(self) -> None:
        try:
            self._conn.call({"op": "unregister", "name": self.name})
        except (OSError, RuntimeError):
            pass  # connection already gone: the proxy drops the session
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
