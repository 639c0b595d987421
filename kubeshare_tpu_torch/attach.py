"""Transparent attach: route an UNMODIFIED PyTorch workload through the
isolation runtime, driven by environment variables alone.

Counterpart of ``kubeshare_tpu/attach.py``. The reference reaches zero
touch by injecting ``LD_PRELOAD=libgemhook.so.1`` and ``POD_MANAGER_PORT``
into the pod (``pkg/scheduler/pod.go:445-457``); the hook intercepts the
CUDA driver API. Here a ``sitecustomize`` shim
(``kubeshare_tpu_torch/_shim/sitecustomize.py``), put on the container's
``PYTHONPATH`` by the node agent, calls :func:`attach_if_env` before the
workload's first line runs.

Two modes, chosen from the injected env, as the JAX package chooses:

**Proxy** mode (``KUBESHARE_TPU_CHIP_PROXY_PORT`` set; the default): the
process never owns a card. Every CUDA device is hidden from it
(``CUDA_VISIBLE_DEVICES=""``, the JAX package's ``JAX_PLATFORMS=cpu``),
and ``torch.compile`` is replaced: a compiled function is traced
abstractly on its first call for each tree structure, leaf shape and
dtype, and non-tensor argument values — exported (:mod:`.isolation.
exported`), compiled on the node's :class:`~.isolation.proxy.ChipProxy`
and run there, one token-gated burst a call. What a call returns are
:class:`RemoteTensor` handles that stay on the card and thread into the
next call; reading one (``float(loss)``, ``.numpy()``) fetches it. Host
tensors passed in are uploaded for the call. What is not forwarded fails
loudly (:func:`_guard_proxy_surface`): CUDA in the process and
``torch.distributed.init_process_group`` raise, rather than computing on
the client's CPU. ``torch.compile`` of an ``nn.Module`` raises too:
functions only.

**Gate** mode (``KUBESHARE_TPU_POD_MANAGER_PORT`` set, no proxy port):
Gemini's model. The process keeps its card and shares it by time slices:

- every aten op the process dispatches, on any device and any thread,
  passes an :class:`~.isolation.client.ExecutionGate` first, through a
  ``TorchDispatchMode`` (the counterpart of the JAX meter's
  ``EvalTrace.process_primitive`` hook). The gate charges the wall time
  between calls and renews its token when the quota is spent, blocking
  the process until the token comes back;
- a ``torch.compile``'d callable is gated as one unit, with the meter
  suspended inside it, as the JAX package gates a jitted call and skips
  the meter inside a trace;
- a memory grant arms :class:`~.isolation.client.HbmCap`: host→device
  copies are pre-charged before their bytes land, and the allocator is
  polled at the ops between;
- the chip grant (``TPU_VISIBLE_CHIPS``) is pinned as
  ``CUDA_VISIBLE_DEVICES`` before CUDA initializes.

What the meter does not see: the hand-written kernels launch through
``ctypes`` and pass no dispatch mode; they are charged through elapsed
time and the gate's drain of the device queue before each renew. Threads
started with ``threading`` after attach are metered (a ``threading``
profile hook enters the meter on them); threads started before it, or
through ``_thread`` directly, are not.

Gang membership is not ported: a gate-mode or whole-device env that asks
for it stops the process (``SystemExit``) instead of letting it run
unmetered. Whole-device pods (no manager or proxy port) attach nothing;
their grant is still pinned.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading

from . import constants as C
from .utils.logger import get_logger

log = get_logger("attach")

_state_lock = threading.Lock()
_active: "_AttachState | None" = None
_meter_cls = None


class _AttachState:
    def __init__(self, mode: str, real_compile, gate=None, meter=None,
                 prev_profile=None, shim=None, restore=None):
        self.mode = mode
        self.real_compile = real_compile
        self.gate = gate
        self.meter = meter
        #: the ``threading`` profile hook in place before attach
        self.prev_profile = prev_profile
        #: proxy mode: the connection and ``torch.compile``'s stand-in
        self.shim = shim
        #: proxy mode: what detach puts back, ``[(object, attr, value)]``
        #: (``value`` None for an env var that was unset)
        self.restore = restore or []


# --- proxy mode -----------------------------------------------------------------

class RemoteTensor:
    """A tensor on the chip proxy, posing as the result of a compiled
    call. It travels back into further compiled calls as a handle;
    materializing it (``float``, ``.item()``, ``.numpy()``) fetches the
    bytes. The tensor a tenant holds is on the proxy's card, so it has no
    device of this process: operations other than the reads below belong
    inside a compiled function."""

    def __init__(self, shim: "_ProxyShim", buf):
        self._shim = shim
        self.buf = buf

    @property
    def shape(self):
        import torch

        return torch.Size(self.buf.shape)

    @property
    def dtype(self):
        from .isolation.programs import torch_dtype

        return torch_dtype(self.buf.dtype)

    @property
    def ndim(self) -> int:
        return len(self.buf.shape)

    def numel(self) -> int:
        n = 1
        for d in self.buf.shape:
            n *= d
        return n

    def size(self, dim: int | None = None):
        return self.shape if dim is None else self.shape[dim]

    def numpy(self):
        return self._shim.fetch(self.buf)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def item(self):
        return self.numpy().item()

    def tolist(self):
        return self.numpy().tolist()

    def __float__(self):
        return float(self.item())

    def __int__(self):
        return int(self.item())

    def __bool__(self):
        return bool(self.item())

    def __index__(self):
        return int(self.item())

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return format(repr(self), spec)

    def __repr__(self):
        return (f"RemoteTensor(shape={tuple(self.buf.shape)}, "
                f"dtype={self.dtype})")

    def __del__(self):
        # no I/O here: __del__ may run on any thread, in the middle of a
        # protocol call; the shim frees queued handles before its next call
        try:
            self._shim.queue_free(self.buf)
        except Exception:
            pass


class _ProxyShim:
    """Owns the connection to the proxy and stands in for
    ``torch.compile``. The client is built with its defaults, as the JAX
    package builds it: a pipelined, resumable session, so a tenant rides
    out a dropped connection, a proxy restarted from its journal and a
    move to another proxy by itself."""

    def __init__(self, host: str, port: int, name: str, request: float,
                 limit: float, memory: int):
        from .isolation.client import ProxyClient

        self.client = ProxyClient(host, port, name, request, limit,
                                  memory=memory)
        self._pending_free: list = []
        self._lock = threading.Lock()

    def queue_free(self, buf) -> None:
        with self._lock:
            self._pending_free.append(buf)

    def flush_frees(self) -> None:
        """Send the queued frees without waiting for their reply."""
        with self._lock:
            bufs, self._pending_free = self._pending_free, []
        if bufs:
            try:
                self.client.free(*bufs, wait=False)
            except Exception:
                pass

    def fetch(self, buf):
        self.flush_frees()
        return self.client.get(buf)

    def compile(self, model=None, **kwargs):
        """``torch.compile``'s stand-in: options are accepted and unused
        (the proxy runs the exported graph as it is)."""
        if model is None:                 # decorator-with-arguments form
            return lambda m: self.compile(m, **kwargs)
        import torch

        if isinstance(model, torch.nn.Module):
            raise TypeError(_PROXY_SURFACE_MSG.format(
                api="compile(<nn.Module>)") + " Compile a function of the "
                "module's parameters instead (torch.func.functional_call), "
                "passing them as arguments.")
        return _RemoteCompiledFunction(self, model)

    def close(self) -> None:
        try:
            self.client.close()
        except Exception:
            pass


#: where a tensor leaf goes among a compiled call's baked-in arguments
_TENSOR = object()


def _under_trace(leaves) -> bool:
    """True when a call happens inside an enclosing trace (the export of
    another compiled function): its arguments are fake tensors."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(x, (FakeTensor, torch.fx.Proxy)) for x in leaves)


class _RemoteCompiledFunction:
    """Stand-in for a ``torch.compile``'d function: on its first call for
    each key — the arguments' tree structure, each tensor leaf's shape and
    dtype, and the value of every non-tensor leaf, baked into the trace as
    ``static_argnums`` are in the JAX package — it exports the function
    and compiles it on the proxy; every call runs there."""

    def __init__(self, shim: _ProxyShim, fn):
        self._shim = shim
        self._fn = fn
        self._cache: dict = {}
        self.__wrapped__ = fn

    def __call__(self, *args, **kwargs):
        import numpy as np
        import torch

        from .isolation.client import RemoteBuffer
        from .utils.tree import tree_flatten, tree_map

        leaves, treedef = tree_flatten((args, kwargs))
        if _under_trace(leaves):
            return self._fn(*args, **kwargs)   # inline, as a nested jit
        self._shim.flush_frees()
        tensors, statics, key = [], list(leaves), [treedef]
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, RemoteTensor):
                leaf = leaf.buf
            if isinstance(leaf, (RemoteBuffer, torch.Tensor, np.ndarray)):
                tensors.append(leaf)
                statics[i] = _TENSOR
                # "float32" whether a host tensor's, an array's or a
                # handle's: the first call's host tensors and the next
                # call's handles share one program
                key.append((tuple(leaf.shape),
                            str(leaf.dtype).removeprefix("torch.")))
            else:
                key.append(("static", type(leaf).__name__, leaf))
        key = tuple(key)
        exe = self._cache.get(key)
        if exe is None:
            exe = self._cache[key] = self._compile(treedef, statics,
                                                   tensors)
        out = exe(*tensors)
        return tree_map(lambda b: RemoteTensor(self._shim, b)
                        if isinstance(b, RemoteBuffer) else b, out)

    def _compile(self, treedef, statics: list, tensors: list):
        """Export the function over the tensor leaves, the non-tensor ones
        (``statics``, with a marker where a tensor goes) baked in."""
        from .utils.tree import tree_unflatten

        fn = self._fn

        def program(*flat):
            it = iter(flat)
            full = [next(it) if x is _TENSOR else x for x in statics]
            args, kwargs = tree_unflatten(treedef, full)
            return fn(*args, **kwargs)

        return self._shim.client.compile(program, *tensors)


_PROXY_SURFACE_MSG = (
    "kubeshare-tpu: torch.{api} is not supported under proxy attach — this "
    "process has no CUDA device (they are hidden from it) and the card is "
    "owned by the node's chip proxy. Put device work in a function "
    "compiled with torch.compile (forwarded to the card); see README "
    "'Supported PyTorch surface under proxy attach'. What is not forwarded "
    "fails loudly rather than computing on the client's CPU.")


def _guard_proxy_surface(torch) -> list:
    """Replace what proxy mode does not forward with loud failures, as
    the JAX package's ``_guard_proxy_surface`` does: CUDA initialization
    (a CUDA tensor, ``.cuda()``, ``torch.cuda.set_device``… each goes
    through ``torch.cuda._lazy_init``) and
    ``torch.distributed.init_process_group``. Returns what to restore."""
    import torch.distributed as dist

    def cuda_fail(*a, **k):
        raise RuntimeError(_PROXY_SURFACE_MSG.format(api="cuda"))

    def dist_fail(*a, **k):
        raise RuntimeError(_PROXY_SURFACE_MSG.format(
            api="distributed.init_process_group") + " For multi-card "
            "training, run as a gang of whole-device pods.")

    restore = [(torch.cuda, "_lazy_init", torch.cuda._lazy_init)]
    torch.cuda._lazy_init = cuda_fail
    if dist.is_available():
        restore.append((dist, "init_process_group", dist.init_process_group))
        dist.init_process_group = dist_fail
    return restore


def attach_proxy(host: str, port: int, name: str, request: float,
                 limit: float, memory: int = 0) -> None:
    """Hide every CUDA device from this process and forward its
    ``torch.compile``'d calls to the chip proxy at ``host:port``. Must run
    before the process initializes CUDA: if it has, this stops the
    process (fails closed) — its work would not all pass the proxy."""
    global _active
    with _state_lock:
        if _active is not None:
            raise RuntimeError(f"already attached ({_active.mode})")
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            raise SystemExit(
                "kubeshare-tpu: CUDA was initialized before proxy attach; "
                "refusing to run with a device of its own beside the proxy")
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            shim = _ProxyShim(host, port, name, request, limit, memory)
        except BaseException:
            _set_env("CUDA_VISIBLE_DEVICES", visible)
            raise
        import torch

        restore = [(os.environ, "CUDA_VISIBLE_DEVICES", visible),
                   (torch, "compile", torch.compile),
                   *_guard_proxy_surface(torch)]
        real_compile = torch.compile
        torch.compile = shim.compile
        _active = _AttachState("proxy", real_compile, shim=shim,
                               restore=restore)
        # a clean exit unregisters at once, so the proxy frees the
        # session's buffers (detach is idempotent)
        atexit.register(detach)
        log.info("attached (proxy mode) to %s:%d as %s (request=%.2f "
                 "limit=%.2f)", host, port, name, request, limit)


def _set_env(key: str, value: str | None) -> None:
    if value is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = value


# --- gate mode ------------------------------------------------------------------


def _h2d_bytes(func, args, kwargs) -> int:
    """Bytes the aten op ``func`` is about to copy from the host onto a
    CUDA device (``_to_copy`` to a CUDA device, ``copy_`` into a CUDA
    tensor), else 0."""
    import torch

    aten = torch.ops.aten
    if func is aten._to_copy.default:
        src, dev = args[0], kwargs.get("device")
        if dev is None or torch.device(dev).type != "cuda" or src.is_cuda:
            return 0
        dtype = kwargs.get("dtype") or src.dtype
        return src.numel() * dtype.itemsize
    if func is aten.copy_.default:
        dst, src = args[0], args[1]
        if (dst.is_cuda and isinstance(src, torch.Tensor)
                and not src.is_cuda):
            return dst.numel() * dst.element_size()
    return 0


def _meter_class():
    """The dispatch mode, defined at first use: importing this module must
    not import torch (the shim imports it in every process of the node)."""
    global _meter_cls
    if _meter_cls is None:
        from torch.utils._python_dispatch import TorchDispatchMode

        class OpMeter(TorchDispatchMode):
            """Gates every aten op dispatched under it (see the module
            docstring). Inert once ``active`` is cleared, so a thread that
            still carries it after :func:`detach` runs unmetered work at
            the mode's bare cost."""

            def __init__(self, gate, hbm):
                super().__init__()
                self.gate = gate
                self.hbm = hbm
                self.active = True
                # re-entrancy guard: the gate's own work must never
                # recurse into the meter
                self._inside = threading.local()

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if self.active and not getattr(self._inside, "on", False):
                    self._inside.on = True
                    try:
                        if self.hbm is not None:
                            nbytes = _h2d_bytes(func, args, kwargs)
                            if nbytes:
                                self.hbm.check(extra_bytes=nbytes)
                        self.gate()   # charge elapsed; acquire/renew (may block)
                        if self.hbm is not None:
                            self.hbm.maybe_check()
                    finally:
                        self._inside.on = False
                return func(*args, **kwargs)

        _meter_cls = OpMeter
    return _meter_cls


def _gate_compile(torch, real_compile, gate, hbm):
    """``torch.compile`` whose result is gated as one unit per call."""
    from torch.utils._python_dispatch import _disable_current_modes

    def gated(fn):
        def run(*args, **kwargs):
            gate()   # waits for the previous compiled call, charges, renews
            if hbm is not None:
                hbm.check()
            with _disable_current_modes():
                out = fn(*args, **kwargs)
            gate.note_dispatch(out)   # charged through completion next
            return out

        run.__wrapped__ = fn
        return run

    def gated_compile(model=None, **kwargs):
        if model is None:                 # decorator-with-arguments form
            return lambda m: gated_compile(m, **kwargs)
        compiled = real_compile(model, **kwargs)
        if isinstance(compiled, torch.nn.Module):
            # keep the module (parameters, state_dict): gate its forward
            compiled.forward = gated(compiled.forward)
            return compiled
        return gated(compiled)

    return gated_compile


def attach_gate(host: str, port: int, name: str, request: float,
                limit: float, memory: int = 0) -> None:
    """Token-gate every aten op and every compiled call of this process,
    which keeps its card. ``memory`` > 0 arms the memory cap; where the
    process has no CUDA allocator stats, that refuses to start (fails
    closed)."""
    global _active
    with _state_lock:
        if _active is not None:
            raise RuntimeError(f"already attached ({_active.mode})")
        import torch
        from torch.utils._python_dispatch import _push_mode

        from .isolation.client import ExecutionGate, HbmCap

        gate = ExecutionGate.connect(host, port, name, request, limit)
        hbm = None
        if memory > 0:
            hbm = HbmCap(memory)
            try:
                hbm.check()   # startup probe: no stats → SystemExit here
            except BaseException:
                gate.close()
                gate._conn.close()   # hang up: the pod manager unregisters
                raise
        meter = _meter_class()(gate, hbm)
        real_compile = torch.compile
        torch.compile = _gate_compile(torch, real_compile, gate, hbm)
        prev_profile = threading.getprofile()

        def enter_meter(frame, event, arg):
            # first event of a new thread: meter it, then hand the thread
            # back to the hook that was there before
            sys.setprofile(prev_profile)
            if meter.active:
                _push_mode(meter)
            if prev_profile is not None:
                prev_profile(frame, event, arg)

        threading.setprofile(enter_meter)
        _push_mode(meter)
        _active = _AttachState("gate", real_compile, gate=gate,
                               meter=meter, prev_profile=prev_profile)
        atexit.register(detach)   # release the token on a clean exit
        log.info("attached (gate mode) to %s:%d as %s", host, port, name)


def _pin_visible_devices() -> bool:
    """Translate the scheduler's chip grant (global chip ids whose trailing
    field is the per-host index, topology/chip.make_chip_id) into
    ``CUDA_VISIBLE_DEVICES``, before CUDA initializes. A grant that is
    present but unparsable or empty stops the process: running without a
    pin would initialize every device of the host, co-tenants' included.
    An existing ``CUDA_VISIBLE_DEVICES`` is left as it is (the grant is
    still checked)."""
    chips = os.environ.get(C.ENV_VISIBLE_CHIPS, "")
    if not chips:
        return False
    try:
        # a carved grant suffixes each chip with its mesh coordinate
        # ("chip@x.y"): the index lives on the chip id proper
        indices = [str(int(c.partition("@")[0].rsplit("-", 1)[1]))
                   for c in chips.split(",") if c]
    except (IndexError, ValueError):
        raise SystemExit(
            f"kubeshare-tpu: cannot parse local device indices from "
            f"{C.ENV_VISIBLE_CHIPS}={chips!r}; refusing to start without "
            f"a device pin (would expose co-tenants' devices)") from None
    if not indices:
        raise SystemExit(
            f"kubeshare-tpu: {C.ENV_VISIBLE_CHIPS}={chips!r} parses to an "
            f"empty device set; refusing to start without a device pin")
    if os.environ.get("CUDA_VISIBLE_DEVICES"):
        return False
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise SystemExit(
            "kubeshare-tpu: CUDA was initialized before the device pin; "
            "refusing to run on devices outside the grant")
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(indices)
    return True


def attach_if_env() -> str:
    """Entry point of the sitecustomize shim: attach as the injected env
    asks (a no-op without it), in the JAX package's order. Returns the
    mode activated: ``"proxy"``, ``"gate"``, ``"distributed"`` (a
    whole-device gang member that joined its group), ``"visible"`` (no
    metering, but the grant was pinned — the whole-device path) or
    ``""``."""
    mode = os.environ.get(C.ENV_ATTACH_MODE, "").lower()
    if mode == "off" or _active is not None:
        return ""
    pinned = _pin_visible_devices()
    proxy_port = int(os.environ.get(C.ENV_CHIP_PROXY_PORT, "0") or 0)
    mgr_port = int(os.environ.get(C.ENV_POD_MANAGER_PORT, "0") or 0)
    if mode == "proxy" and not proxy_port:
        log.warning("attach mode 'proxy' requested but %s unset",
                    C.ENV_CHIP_PROXY_PORT)
        return ""
    # both endpoints are node-local (the launcher spawns the proxy and the
    # pod manager on the workload's own node)
    host = os.environ.get("KUBESHARE_TPU_ATTACH_HOST", "") or "127.0.0.1"
    name = os.environ.get(C.ENV_POD_NAME, "") or f"pid-{os.getpid()}"
    request = float(os.environ.get(C.ENV_TPU_REQUEST, "0") or 0)
    limit = float(os.environ.get(C.ENV_TPU_LIMIT, "0") or 0) or max(
        request, 1.0)
    request = request or limit
    memory = int(os.environ.get(C.ENV_TPU_MEMORY, "0") or 0)
    if mode == "gate" and not mgr_port:
        log.warning("attach mode 'gate' requested but %s unset",
                    C.ENV_POD_MANAGER_PORT)
        return ""
    if proxy_port and mode in ("", "proxy"):
        # the proxy owns the device: its executions are forwarded there,
        # so there is no local device to rank in a gang — never joins
        attach_proxy(host, proxy_port, name, request, limit, memory)
        return "proxy"
    if mgr_port and mode in ("", "gate"):
        attach_gate(host, mgr_port, name, request, limit, memory)
        # a gate-mode pod owns its device, so a fractional gang still
        # trains one model across its members (metered by tokens)
        _join_gang_or_die()
        return "gate"
    # whole-device pod (no manager port): nothing to meter; the pin
    # confines the process, and a gang member joins its group
    if _join_gang_or_die():
        return "distributed"
    return "visible" if pinned else ""


def _join_gang_or_die() -> bool:
    """Join the gang's ``torch.distributed`` group when the gang env is
    present (:func:`~kubeshare_tpu_torch.parallel.runner.
    distributed_init_from_env`). A member whose rendezvous FAILS exits 1
    rather than train solo: the rest of the gang waits for its rank, and
    only a restart retries. SystemExit passes the shim's guard. Off-gang
    it returns False before importing anything (the ``parallel`` package
    imports torch, which a plain process must not pay for)."""
    if not all(os.environ.get(k) for k in (C.ENV_COORDINATOR,
                                           C.ENV_NUM_PROCESSES,
                                           C.ENV_PROCESS_ID)):
        return False
    from .parallel.runner import distributed_init_from_env

    try:
        return distributed_init_from_env()
    except Exception as exc:
        log.error("gang member failed its rendezvous: %s — exiting so "
                  "the restart can retry", exc)
        raise SystemExit(1) from exc


def detach() -> None:
    """Undo the attach (tests, graceful shutdown). Gate mode: the meter
    goes inert and leaves this thread, ``torch.compile`` and the thread
    hook are restored, the token is released. Proxy mode: the session is
    unregistered (the proxy frees its buffers), and ``torch.compile``,
    the guarded surface and ``CUDA_VISIBLE_DEVICES`` are restored."""
    global _active
    with _state_lock:
        state = _active
        if state is None:
            return
        if state.mode == "proxy":
            state.shim.close()
            for obj, attr, value in reversed(state.restore):
                if obj is os.environ:
                    _set_env(attr, value)
                else:
                    setattr(obj, attr, value)
            _active = None
            return
        import torch
        from torch.utils._python_dispatch import (_get_current_dispatch_mode,
                                                  _pop_mode)

        state.meter.active = False
        if _get_current_dispatch_mode() is state.meter:
            _pop_mode()
        torch.compile = state.real_compile
        threading.setprofile(state.prev_profile)
        state.gate.close()
        _active = None


def active_mode() -> str:
    return _active.mode if _active is not None else ""


def gate_stats() -> dict:
    """The attached gate's totals (:meth:`ExecutionGate.stats`), or an
    empty dict when this process is not gated."""
    state = _active
    return state.gate.stats() if state is not None and state.gate else {}


def proxy_usage() -> dict:
    """The proxy session's ``usage`` reply (``exec_count``,
    ``exec_ms_total``, ``used_ms``…); as ``last_compile``, the client's
    record of its last compile (blob bytes, export and compile seconds);
    and as ``transport``, its connection's (features, reconnects that
    resumed the session, requests replayed). An empty dict when this
    process is not proxy-attached."""
    state = _active
    if state is None or state.shim is None:
        return {}
    client = state.shim.client
    return dict(client.usage(), last_compile=client.last_compile,
                transport=client.transport())


def real_compile():
    """The genuine ``torch.compile`` even while the attach (either mode)
    has replaced the public attribute."""
    state = _active
    if state is not None:
        return state.real_compile
    import torch

    return torch.compile
