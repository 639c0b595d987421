"""Transparent attach: route an UNMODIFIED PyTorch workload through the
isolation runtime, driven by environment variables alone.

Counterpart of ``kubeshare_tpu/attach.py``. The reference reaches zero
touch by injecting ``LD_PRELOAD=libgemhook.so.1`` and ``POD_MANAGER_PORT``
into the pod (``pkg/scheduler/pod.go:445-457``); the hook intercepts the
CUDA driver API. Here a ``sitecustomize`` shim
(``kubeshare_tpu_torch/_shim/sitecustomize.py``), put on the container's
``PYTHONPATH`` by the node agent, calls :func:`attach_if_env` before the
workload's first line runs.

The port has **gate** mode (``KUBESHARE_TPU_POD_MANAGER_PORT`` set):
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

**Proxy** mode (``KUBESHARE_TPU_CHIP_PROXY_PORT``) and gang membership are
not ported: an env that asks for either stops the process
(``SystemExit``) instead of letting it run unmetered. Whole-device pods
(no manager port) attach nothing; their grant is still pinned.
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
    def __init__(self, mode: str, gate, meter, real_compile, prev_profile):
        self.mode = mode
        self.gate = gate
        self.meter = meter
        self.real_compile = real_compile
        #: the ``threading`` profile hook in place before attach
        self.prev_profile = prev_profile


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
        _active = _AttachState("gate", gate, meter, real_compile,
                               prev_profile)
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


def _refuse_unported(what: str) -> None:
    raise SystemExit(
        f"kubeshare-tpu: the pod's env asks for {what}, which the PyTorch "
        f"port does not have yet; refusing to run unmetered")


def attach_if_env() -> str:
    """Entry point of the sitecustomize shim: attach as the injected env
    asks (a no-op without it). Returns the mode activated: ``"gate"``,
    ``"visible"`` (no metering, but the grant was pinned — the
    whole-device path) or ``""``."""
    mode = os.environ.get(C.ENV_ATTACH_MODE, "").lower()
    if mode == "off" or _active is not None:
        return ""
    pinned = _pin_visible_devices()
    proxy_port = int(os.environ.get(C.ENV_CHIP_PROXY_PORT, "0") or 0)
    mgr_port = int(os.environ.get(C.ENV_POD_MANAGER_PORT, "0") or 0)
    if mode == "proxy" or (proxy_port and mode == ""):
        _refuse_unported("proxy attach (the chip proxy forwarding its "
                         "compiled calls)")
    if all(os.environ.get(k) for k in (C.ENV_COORDINATOR,
                                       C.ENV_NUM_PROCESSES,
                                       C.ENV_PROCESS_ID)):
        _refuse_unported("a gang join (distributed rendezvous)")
    if mode == "gate" and not mgr_port:
        log.warning("attach mode 'gate' requested but %s unset",
                    C.ENV_POD_MANAGER_PORT)
        return ""
    if mgr_port:
        # the pod manager is node-local (the launcher spawns it on the
        # workload's own node)
        host = os.environ.get("KUBESHARE_TPU_ATTACH_HOST", "") or "127.0.0.1"
        name = os.environ.get(C.ENV_POD_NAME, "") or f"pid-{os.getpid()}"
        request = float(os.environ.get(C.ENV_TPU_REQUEST, "0") or 0)
        limit = float(os.environ.get(C.ENV_TPU_LIMIT, "0") or 0) or max(
            request, 1.0)
        request = request or limit
        memory = int(os.environ.get(C.ENV_TPU_MEMORY, "0") or 0)
        attach_gate(host, mgr_port, name, request, limit, memory)
        return "gate"
    return "visible" if pinned else ""


def detach() -> None:
    """Undo the attach (tests, graceful shutdown): the meter goes inert
    and leaves this thread, ``torch.compile`` and the thread hook are
    restored, the token is released."""
    global _active
    with _state_lock:
        state = _active
        if state is None:
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
    return state.gate.stats() if state is not None else {}


def real_compile():
    """The genuine ``torch.compile`` even while the attach has replaced
    the public attribute."""
    state = _active
    if state is not None:
        return state.real_compile
    import torch

    return torch.compile
