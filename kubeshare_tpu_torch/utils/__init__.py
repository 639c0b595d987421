def default_node_name() -> str:
    """The node identity daemons key their data with: ``$NODE_NAME``
    (injected by the deploy manifests) over the kernel hostname, as in
    ``kubeshare_tpu.utils``."""
    import os
    import socket

    return os.environ.get("NODE_NAME") or socket.gethostname()


class _Stop(Exception):
    pass


def _raise_stop(*_) -> None:
    raise _Stop


def ready_until_signal(ready: str) -> None:
    """Print ``ready`` and block the main thread until SIGTERM or SIGINT.

    The handlers are in place before the line is printed, so a parent that
    signals as soon as it reads it never meets the default action. They
    raise rather than set an Event: a handler that calls ``Event.set`` can
    run while the interrupted main thread holds that Event's lock inside
    ``Event.wait``, and then waits on itself for ever. Once a signal came,
    the default actions are back, so a second one ends a stuck shutdown.
    The main thread wakes every 0.2 s rather than waiting in ``pause``: a
    signal sent to the process may be taken by another thread, whose
    C-level handler only flags it for the main thread, which would then
    sleep on (every handler of the process runs there, SIGHUP's too).
    """
    import signal
    import time

    sigs = (signal.SIGTERM, signal.SIGINT)
    for sig in sigs:
        signal.signal(sig, _raise_stop)
    try:
        print(ready, flush=True)
        while True:
            time.sleep(0.2)
    except _Stop:
        pass
    finally:
        for sig in sigs:
            signal.signal(sig, signal.SIG_DFL)
