"""Zero-touch attach shim of the PyTorch port — the LD_PRELOAD
equivalent.

The node agent puts this directory (and the port's package) on the
workload container's ``PYTHONPATH``; Python imports ``sitecustomize`` at
interpreter startup, before any workload code runs. With no kubeshare env
present this is a no-op, so the shim is safe to install globally.

Failure policy (as ``kubeshare_tpu/_shim/sitecustomize.py``): when the
env REQUESTS an attach and it cannot be made, the process must DIE — a pod
silently running unmetered after a manager outage is an isolation breach.
``SystemExit`` from the attach (a bad device grant, a gang member whose
rendezvous failed, a memory grant it cannot enforce, CUDA initialized
before a proxy attach) passes through; any other failure — a proxy or pod manager that
does not answer — becomes one here.
Processes without kubeshare env are untouched.
"""

import os


def _attach_requested() -> bool:
    # Env names are HARDCODED (the values of kubeshare_tpu_torch/
    # constants.py): the shim must not depend on the package it guards —
    # if that package is broken or missing on the node, this check still
    # has to work so the pod dies instead of running unmetered.
    if os.environ.get("KUBESHARE_TPU_ATTACH", "").lower() == "off":
        return False
    return bool(os.environ.get("KUBESHARE_TPU_CHIP_PROXY_PORT")
                or os.environ.get("KUBESHARE_TPU_POD_MANAGER_PORT")
                or os.environ.get("TPU_VISIBLE_CHIPS"))


try:
    from kubeshare_tpu_torch.attach import attach_if_env

    attach_if_env()
except SystemExit:
    raise  # the attach's own fail-closed paths
except Exception:
    import sys
    import traceback

    print("kubeshare-tpu attach shim failed:", file=sys.stderr)
    traceback.print_exc()
    if _attach_requested():
        raise SystemExit(
            "kubeshare-tpu: attach was requested by the pod's env but "
            "failed — refusing to run unmetered (fix the node's pod "
            "manager; the pod will restart)")
