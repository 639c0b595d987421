# Build/test entry points (reference Makefile parity: it builds 5 Go
# binaries; here the native core + image + checks).

PY ?= python

.PHONY: all native test bench bench-proxy bench-recovery bench-health bench-autopilot bench-rightsize bench-elastic bench-slo bench-serving bench-fleet bench-chaos bench-gang bench-contention bench-preempt bench-profile bench-replay bench-shard bench-failover image clean obs-check
.PHONY: native-torch test-torch smoke-torch obs-check-torch image-torch

all: native

native: kubeshare_tpu/isolation/native/_build/libtokensched.so \
        kubeshare_tpu/isolation/native/_build/podmgr_relay

kubeshare_tpu/isolation/native/_build/libtokensched.so: kubeshare_tpu/isolation/native/tokensched.cpp
	mkdir -p $(dir $@)
	g++ -O2 -shared -fPIC -std=c++17 $< -o $@

kubeshare_tpu/isolation/native/_build/podmgr_relay: kubeshare_tpu/isolation/native/podmgr_relay.cpp
	mkdir -p $(dir $@)
	g++ -O2 -pthread -std=c++17 $< -o $@

# Fast lane (< 3 min): everything but the compile-heavy/multi-process
# tests. `make test-all` is the full suite; `make test-slow` only the
# heavy lane (run both before release-grade changes).
test:
	$(PY) -m pytest tests/ -x -q -m "not slow"

test-all:
	$(PY) -m pytest tests/ -x -q

test-slow:
	$(PY) -m pytest tests/ -x -q -m slow

# Observability plane gate: exposition-format lint (incl. exemplar
# syntax round-trip), trace-propagation + SLO/burn-rate + TSDB/critpath
# tests, the self-validating 3-pod smoke, a flight-recorder smoke — a
# sim replay with an injected slow tenant must dump a parseable JSONL
# black box — and the fleet smoke: remote-write from three pushers,
# one GET /query per aggregation, critical-path assembly across >= 3
# processes (doc/observability.md).
obs-check:
	$(PY) -m pytest tests/test_obs.py tests/test_trace_propagation.py \
		tests/test_slo.py tests/test_tsdb.py tests/test_critpath.py \
		tests/test_ledger.py -x -q
	$(PY) scripts/trace_demo.py
	JAX_PLATFORMS=cpu $(PY) -m kubeshare_tpu.sim.simulator --synthetic 300 \
		--slo 'queue-wait-p99<=500ms,availability>=99' \
		--slow-tenant 'tenant-1@100:5' \
		--flight-dump /tmp/kubeshare-flight-smoke.jsonl > /dev/null
	$(PY) -c "from kubeshare_tpu.obs.flight import parse_dump_jsonl; \
		d = parse_dump_jsonl(open('/tmp/kubeshare-flight-smoke.jsonl').read()); \
		assert d['entries'], 'empty flight dump'; \
		print('flight dump ok: %d entries' % len(d['entries']))"
	JAX_PLATFORMS=cpu $(PY) scripts/fleet_smoke.py

bench:
	$(PY) bench.py

# Transport micro-bench (doc/isolation-wire.md): prints fresh numbers,
# deltas vs the committed baseline, and refreshes bench_proxy.json.
bench-proxy:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_proxy.py \
		--baseline bench_proxy.json --write bench_proxy.json

# Recovery micro-bench (doc/isolation-wire.md, resume/replay section):
# reconnect latency p50/p99, replay throughput across a kill, and
# end-to-end live-migration time; refreshes bench_recovery.json.
bench-recovery:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_recovery.py \
		--baseline bench_recovery.json --write bench_recovery.json

# Health-plane micro-bench (doc/health.md): detection latency p50/p99,
# evict->rebound end to end, poll + admission cost; refreshes
# bench_health.json.
bench-health:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_health.py \
		--baseline bench_health.json --write bench_health.json

# Autopilot micro-bench (doc/autopilot.md): seeded churn convergence
# (fragmentation reduction, move/rollback counts, plan latency) and
# elastic reclaim (lend ratio, revoke latency); refreshes
# bench_autopilot.json.
bench-autopilot:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_autopilot.py \
		--baseline bench_autopilot.json --write bench_autopilot.json

# Rightsizer bench (doc/autopilot.md, Rightsizing): the seeded churn
# scenario with the SLO-driven capacity controller in the loop vs the
# static declared shares; --check gates the every-SLO-met,
# zero-new-alerts, >=30% chip-equivalent reduction, zero-rollback and
# disabled-controller replay-clean bars, then refreshes
# bench_rightsize.json.
bench-rightsize:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_rightsize.py --check \
		--baseline bench_rightsize.json --write bench_rightsize.json

# Elastic-plane bench (doc/elastic.md): goodput across the 2->4->1
# demand ramp vs the clairvoyant static oracle, resize pause p99 vs a
# whole-gang migration flip, resize-mid-churn chaos seeds and the
# disabled bit-identity bar, then refreshes bench_elastic.json.
bench-elastic:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_elastic.py --check \
		--baseline bench_elastic.json --write bench_elastic.json

# SLO-plane micro-bench (doc/observability.md): evaluator cost per
# observation, exemplar surcharge, and burn-to-alert detection latency
# in deterministic virtual time; refreshes bench_slo.json.
bench-slo:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_slo.py \
		--baseline bench_slo.json --write bench_slo.json

# Serving-plane bench (doc/serving.md): live tinymlp serving through a
# real proxy session at target QPS, plus deterministic virtual-time
# saturation/class-priority phases; --check gates the isolation-error
# (<5%), shed-correctness (no admitted request dropped) and
# latency-class-p99 bars, then refreshes bench_serving.json.
bench-serving:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_serving.py --check \
		--baseline bench_serving.json --write bench_serving.json

# Fleet telemetry bench (doc/observability.md): server-side remote-write
# ingest cost at 1k samples/push, GET /query latency over 16 instances
# x 10 min retention, and critical-path coverage on the sim's
# deterministic traces; --check gates the <1ms ingest, <10ms query p50
# and >=95% coverage bars, then refreshes bench_fleet.json.
bench-fleet:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_fleet.py --check \
		--baseline bench_fleet.json --write bench_fleet.json

# Chaos-plane bench (doc/chaos.md): the deterministic multi-fault
# scenario suite across >= 3 seeds in virtual time; --check gates
# zero invariant violations, full reconvergence and the per-scenario
# MTTR roof, then refreshes bench_chaos.json.
bench-chaos:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_chaos.py --check \
		--baseline bench_chaos.json --write bench_chaos.json

# Gang-plane bench (doc/gang.md): coordinated vs uncoordinated grant
# throughput for a 4-chip SPMD gang sharing its sub-mesh with a
# best-effort co-tenant, a gang-atomic migration e2e with a
# partial-grant-window sampler, and the gang chaos scenario across
# >= 3 seeds; --check gates the >=1.5x speedup, zero-partial-window
# and zero-violation bars, then refreshes bench_gang.json.
bench-gang:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_gang.py --check \
		--baseline bench_gang.json --write bench_gang.json

# Contention-attribution bench (doc/observability.md): a latency-class
# tenant against a work-conserving best-effort flooder on one shared
# chip through the full token-scheduler façade with the chip-time
# ledger + blame graph attached, plus the deterministic sim
# --contention replay; --check gates the flooder-top-blamed,
# ledger-conservation (<=1%) and blame-vs-histogram (<=5%) bars, then
# refreshes bench_contention.json.
bench-contention:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_contention.py --check \
		--baseline bench_contention.json --write bench_contention.json

# Preemption-plane bench (doc/isolation-wire.md, doc/gang.md): a
# latency tenant behind a work-conserving best-effort flooder, single
# chip and 4-chip gang, with the preemption policy on; --check gates
# the <10% grant-to-completion p99 inflation, >=90% throughput,
# >=5x blame-to-flooder collapse, gang-atomicity and never-mid-execute
# bars, then refreshes bench_preempt.json.
bench-preempt:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_preempt.py --check \
		--baseline bench_preempt.json --write bench_preempt.json

# Contention-profiler bench (doc/observability.md, "Locks, phases, and
# profiles"): profiler overhead on the bench_health admission-check hot
# loop, dispatcher phase-attribution coverage, and tracked-wait accuracy
# under sim --churn load vs a direct timing harness; --check gates the
# <=2% overhead, >=95% coverage, dispatcher-top-contended and <=10%
# wait-accuracy bars, then refreshes bench_profile.json.
bench-profile:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_profile.py --check \
		--baseline bench_profile.json --write bench_profile.json

# Decision-replay bench (doc/replay.md): record a churn workload's
# decision trace, replay it through the same and a perturbed build;
# --check gates record->replay bit-identity, a non-empty named diff
# on the perturbation, the 1h-trace-in-<60s replay speed bar and the
# <=2%-of-admission recorder overhead bar, then refreshes
# bench_replay.json.
bench-replay:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_replay.py --check \
		--baseline bench_replay.json --write bench_replay.json

# Sharded-dispatch bench (doc/sharding.md): the 1k-node / 100k-pod
# churn stream driven closed-loop through 1/2/4/8 cell-keyed shards;
# --check gates the >=3x 4-shard throughput bar, p99-placement-no-
# worse, flat per-shard lock wait, and the shard-equivalence replay
# gate (plus 1-shard bit-identity), then refreshes bench_shard.json.
bench-shard:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_shard.py --check \
		--baseline bench_shard.json --write bench_shard.json

# Control-plane HA bench (doc/ha.md): seeded scheduler kills and
# registry-leader kills under virtual clocks; --check gates takeover
# and registry-failover MTTR p99 under 3x the health plane's node-death
# detection (bench_health.json), replication lag inside its advertised
# bound, and the per-bind fence check at <=2% of one admission check,
# then refreshes bench_failover.json.
bench-failover:
	JAX_PLATFORMS=cpu $(PY) scripts/bench_failover.py --check \
		--baseline bench_failover.json --write bench_failover.json

image:
	docker build -f docker/Dockerfile -t kubeshare-tpu:latest .

# --- the PyTorch/CUDA port (kubeshare_tpu_torch/, doc/deploy_torch.md) ---

# Every CUDA library of kubeshare_tpu_torch/csrc/ for sm_90a (one nvcc
# each, in parallel; no card needed) and the token scheduler's native
# core (g++), into kubeshare_tpu_torch/_build/. Each is otherwise built
# at its first use.
native-torch:
	$(PY) -m kubeshare_tpu_torch.ops.build
	$(PY) -c "from kubeshare_tpu_torch.isolation import native; \
		native.build('tokensched')"

# The port's CPU tests (parity with the JAX package, which they import;
# the card-only ones skip without a card: `pytest -m cuda
# tests/test_torch_cuda.py` on one).
test-torch:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_torch_*.py -q -m "not slow"

# The port's main paths on one CUDA card, each kernel against its plain
# version; exits non-zero without a card.
smoke-torch:
	$(PY) chip_smoke.py

# obs-check for the port: its observability tests, the self-validating
# 3-pod trace smoke, a flight dump from the port's simulator, and the
# fleet smoke.
obs-check-torch:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/test_torch_obs.py \
		tests/test_torch_obs_runtime.py -x -q
	$(PY) scripts/torch_trace_demo.py
	dump=$$(mktemp "$${TMPDIR:-/tmp}/kubeshare-torch-flight.XXXXXX"); \
	trap 'rm -f "$$dump"' EXIT; \
	$(PY) -m kubeshare_tpu_torch.sim.simulator --synthetic 300 \
		--slo 'queue-wait-p99<=500ms,availability>=99' \
		--slow-tenant 'tenant-1@100:5' \
		--flight-dump "$$dump" > /dev/null && \
	$(PY) -c "import sys; \
		from kubeshare_tpu_torch.obs.flight import parse_dump_jsonl; \
		d = parse_dump_jsonl(open(sys.argv[1]).read()); \
		assert d['entries'], 'empty flight dump'; \
		print('flight dump ok: %d entries' % len(d['entries']))" "$$dump"
	$(PY) scripts/torch_fleet_smoke.py

image-torch:
	docker build -f docker/Dockerfile.torch -t kubeshare-tpu-torch:latest .

clean:
	rm -rf kubeshare_tpu/isolation/native/_build kubeshare_tpu_torch/_build
