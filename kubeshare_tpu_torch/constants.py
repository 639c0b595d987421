"""Constants of the port, with the names and values of
``kubeshare_tpu.constants``.

The environment names are the ones the JAX control plane injects into a
bound pod, so a pod bound by today's scheduler attaches to the port
unchanged; they keep their ``TPU`` spelling until the port has a control
plane of its own.
"""

DOMAIN = "sharedtpu/"

# Workload class for priority isolation: a "latency" request waiting
# behind a "best-effort" holder preempts it (preempt/). Absent =
# best-effort.
POD_CLASS = DOMAIN + "class"
TPU_CLASSES = ("latency", "best-effort")

# --- environment contract into the workload container -----------------------
# (≙ NVIDIA_VISIBLE_DEVICES / POD_MANAGER_PORT / POD_NAME injection,
# pod.go:435-457). The chip grant: global chip ids whose trailing field is
# the per-host device index ("<model>-<host>-<index>", comma-separated).
ENV_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"
ENV_POD_MANAGER_PORT = "KUBESHARE_TPU_POD_MANAGER_PORT"
ENV_POD_NAME = "KUBESHARE_TPU_POD_NAME"

# Transparent-attach contract (≙ the LD_PRELOAD zero-touch contract,
# pod.go:445-457): the sitecustomize shim reads these (kubeshare_tpu_torch/
# attach.py). ENV_CHIP_PROXY_PORT asks for proxy attach (the default mode
# when it is set).
ENV_CHIP_PROXY_PORT = "KUBESHARE_TPU_CHIP_PROXY_PORT"
ENV_TPU_REQUEST = "KUBESHARE_TPU_REQUEST"
ENV_TPU_LIMIT = "KUBESHARE_TPU_LIMIT"
ENV_TPU_MEMORY = "KUBESHARE_TPU_MEM"
ENV_ATTACH_MODE = "KUBESHARE_TPU_ATTACH"  # proxy | gate | off (default auto)

# The chip proxy's durable session journal (proxy.py ``--journal-dir``):
# a directory where every resumable session is mirrored, so a restarted
# proxy brings its tenants' sessions back. Unset: no journal.
ENV_JOURNAL_DIR = "KUBESHARE_JOURNAL_DIR"

# Gang/distributed contract: the port has no gang runtime yet, so a pod
# that carries all three of these is refused rather than trained solo.
ENV_GROUP_NAME = "KUBESHARE_TPU_GROUP"
ENV_NUM_PROCESSES = "KUBESHARE_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "KUBESHARE_TPU_PROCESS_ID"
ENV_COORDINATOR = "KUBESHARE_TPU_COORDINATOR"

# Node actuation directory (pkg/config/config.go:19-22): per-chip client
# lists consumed by the node launcher daemon.
SCHEDULER_DIR = "/var/lib/kubeshare-tpu/scheduler"

# Per-device scheduler ports (launcher.py:27-29): the proxy of device i
# serves execution on SCHD_PORT_START + i.
SCHD_PORT_START = 49901

# --- token scheduler (Gemini parity: -q 300 -m 20 -w 10000) ----------------
#: sliding accounting window of the token scheduler, in milliseconds
WINDOW_MS = 10000.0
#: quota a grant carries when the client has that much allowance left
BASE_QUOTA_MS = 300.0
#: smallest quota worth granting; below it a client waits for its window
MIN_QUOTA_MS = 20.0
