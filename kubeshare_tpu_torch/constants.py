"""Constants of the port, with the names and values of
``kubeshare_tpu.constants``.

The label grammar (``sharedtpu/``) and the environment names are the
ones the JAX control plane reads and injects, so the port's scheduler is
held against the JAX one on the same labels, and a pod bound by either
attaches to the port unchanged. They keep their ``TPU`` spelling until
the port's control plane renames them (``sharedgpu/``,
``CUDA_VISIBLE_DEVICES``).
"""

DOMAIN = "sharedtpu/"

# --- user-facing labels -----------------------------------------------------
# Coscheduling pod group (constants.go:6-11).
POD_GROUP_NAME = DOMAIN + "group_name"
POD_GROUP_HEADCOUNT = DOMAIN + "group_headcount"
POD_GROUP_THRESHOLD = DOMAIN + "group_threshold"

# Pod priority: 0 = opportunistic, 1-100 = guarantee (constants.go:13-15).
# Pods in the same group must share a priority.
POD_PRIORITY = DOMAIN + "priority"

# Upper limit / guaranteed fraction of device compute time over the
# accounting window (constants.go:16-19). Fractions in (0, 1] share a
# device; integers > 1 request whole devices.
POD_TPU_LIMIT = DOMAIN + "tpu_limit"
POD_TPU_REQUEST = DOMAIN + "tpu_request"

# Device memory request in bytes (constants.go:20-21).
POD_TPU_MEMORY = DOMAIN + "tpu_mem"

# Device model constraint, the model discovery reports (constants.go:22-23).
POD_TPU_MODEL = DOMAIN + "tpu_model"

# Scheduling deadline in seconds: a pod still unbound this long after
# submit resolves "timed-out". 0/absent = no deadline.
POD_DEADLINE = DOMAIN + "deadline"

# Per-tenant service-level objectives, comma-separated, e.g.
# "grant-wait-p99<=50ms,availability>=99.9" (obs/slo.py).
POD_SLO = DOMAIN + "slo"

# Workload class for priority isolation: a "latency" request waiting
# behind a "best-effort" holder preempts it (preempt/). Absent =
# best-effort.
POD_CLASS = DOMAIN + "class"
TPU_CLASSES = ("latency", "best-effort")

# --- scheduler-written annotations (constants.go:25-27) ---------------------
POD_TPU_CHIP_ID = DOMAIN + "tpu_chip_id"     # ≙ sharedgpu/gpu_uuid
POD_CELL_ID = DOMAIN + "cell_id"
POD_GROUP_RANK = DOMAIN + "group_rank"       # survives engine restarts
POD_MANAGER_PORT = DOMAIN + "tpu_manager_port"

# --- environment contract into the workload container -----------------------
# (≙ NVIDIA_VISIBLE_DEVICES / POD_MANAGER_PORT / POD_NAME injection,
# pod.go:435-457). The chip grant: global chip ids whose trailing field is
# the per-host device index ("<model>-<host>-<index>", comma-separated).
ENV_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"
# Node mesh shape ("2x4") beside a carved TPU_VISIBLE_CHIPS value (entries
# "chip@x.y"); absent for the plain form, which every GPU node gets.
ENV_MESH_SHAPE = "KUBESHARE_TPU_MESH"
ENV_POD_MANAGER_PORT = "KUBESHARE_TPU_POD_MANAGER_PORT"
ENV_POD_NAME = "KUBESHARE_TPU_POD_NAME"
ENV_SCHEDULER_IP = "KUBESHARE_TPU_SCHEDULER_IP"

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

# Gang/distributed contract: the scheduler injects the gang's size and
# this member's rank; the COORDINATOR address (host:port of rank 0) is
# wired by the manifest and consumed by parallel.runner, which joins one
# torch.distributed group; the rendezvous waits at most TIMEOUT_S.
ENV_GROUP_NAME = "KUBESHARE_TPU_GROUP"
ENV_NUM_PROCESSES = "KUBESHARE_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "KUBESHARE_TPU_PROCESS_ID"
ENV_COORDINATOR = "KUBESHARE_TPU_COORDINATOR"
ENV_RENDEZVOUS_TIMEOUT_S = "KUBESHARE_TPU_RENDEZVOUS_TIMEOUT_S"

# Library path (cmd/kubeshare-query-ip/main.go:22-34): the control-plane
# address file the query-ip init helper writes.
LIBRARY_PATH = "/var/lib/kubeshare-tpu/library"
SCHEDULER_IP_FILE = LIBRARY_PATH + "/schedulerIP.txt"

# Node actuation directory (pkg/config/config.go:19-22): per-chip client
# lists consumed by the node launcher daemon.
SCHEDULER_DIR = "/var/lib/kubeshare-tpu/scheduler"

# Node label that opts a node into sharing (≙ SharedGPU=true,
# pkg/scheduler/node.go:18-26).
NODE_SHARED_TPU_LABEL = "SharedTPU"

# Pod-manager port pool: 512 ports from 50050 per node
# (pkg/scheduler/scheduler.go:351, node.go:11-15).
POD_MANAGER_PORT_START = 50050
POD_MANAGER_PORT_RANGE = 512

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

# Name under which the scheduler registers (scheduler.go:35-56's
# Name = "kubeshare-scheduler").
SCHEDULER_NAME = "kubeshare-tpu-scheduler"

# Well-known control-plane service ports (deploy/registry.yaml,
# deploy/scheduler.yaml; ≙ the reference's collector 9004 / aggregator
# 9005 ports).
REGISTRY_PORT = 9006
SCHEDULER_PORT = 9007

# Health plane defaults: the lease TTL plays the role of the reference's
# Prometheus scrape staleness.
LEASE_TTL_S = 5.0            # heartbeat lease lifetime
HEALTH_MISS_THRESHOLD = 3    # missed TTLs before a suspect node is dead
HEALTH_RECOVER_K = 3         # consecutive fresh beats to leave quarantine
HEALTH_QUARANTINE_S = 30.0   # minimum hold-down after a death
