"""The port's gang runner, gang checkpoints and gang CLI on the CPU.

``distributed_init_from_env`` joins real rank processes from the gang env
(the shim's path: whole-device members, gloo off the card); the backend
rule is held on UUID lists; ``KUBESHARE_TPU_MESH``'s node mesh shape is
the pinned divergence from the JAX ``gang_mesh``; ``verify_shared_path``,
the sharded DCP save and restore, and a two-rank CLI resume run on gloo
ranks (``utils.virtualcpu.RankPool``, ``torch_ranks.py``, or processes of
their own through the shim).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch.distributed.tensor import Replicate

import jax

import torch_ranks as ranks
from kubeshare_tpu.parallel import runner as jrunner
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.models import checkpoint as ck
from kubeshare_tpu_torch.obs import metrics as tmetrics
from kubeshare_tpu_torch.obs import trace as ttrace
from kubeshare_tpu_torch.parallel import runner
from kubeshare_tpu_torch.utils.virtualcpu import RankPool, free_port

REPO = Path(__file__).resolve().parent.parent
SHIM = REPO / "kubeshare_tpu_torch" / "_shim"
GANG_ENV = (C.ENV_COORDINATOR, C.ENV_NUM_PROCESSES, C.ENV_PROCESS_ID,
            C.ENV_RENDEZVOUS_TIMEOUT_S, C.ENV_MESH_SHAPE, C.ENV_VISIBLE_CHIPS,
            C.ENV_CHIP_PROXY_PORT, C.ENV_POD_MANAGER_PORT, C.ENV_ATTACH_MODE)


@pytest.fixture(scope="module")
def pool2():
    with RankPool(2) as pool:
        yield pool


def _rank_env(port: int, rank: int, world: int = 2, **extra) -> dict:
    """A whole-device gang member's env: the shim first on PYTHONPATH."""
    env = {k: v for k, v in os.environ.items() if k not in GANG_ENV}
    env.update({C.ENV_COORDINATOR: f"127.0.0.1:{port}",
                C.ENV_NUM_PROCESSES: str(world),
                C.ENV_PROCESS_ID: str(rank),
                C.ENV_RENDEZVOUS_TIMEOUT_S: "60",
                "PYTHONPATH": os.pathsep.join([str(SHIM), str(REPO)]),
                "OMP_NUM_THREADS": "1"})
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _ranks(args, envs, timeout=120):
    procs = [subprocess.Popen([sys.executable, *args], env=env,
                              cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for env in envs]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def test_init_is_a_noop_off_gang():
    assert runner.distributed_init_from_env(env={}) is False
    assert jrunner.distributed_init_from_env(env={}) is False
    assert runner.backend() == "" and runner.backend_reason() == ""
    partial_env = {C.ENV_COORDINATOR: "h:1", C.ENV_NUM_PROCESSES: "2"}
    assert runner.distributed_init_from_env(env=partial_env) is False


_MEMBER = """
import torch, torch.distributed as dist
from kubeshare_tpu_torch import attach
from kubeshare_tpu_torch.parallel import runner
assert attach.active_mode() == "" and dist.is_initialized()
m = runner.gang_mesh(device_type="cpu")
h = runner.gang_mesh(hybrid=True, device_type="cpu")
x = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(x)
print("MEMBER", dist.get_rank(), dist.get_world_size(), runner.backend(),
      tuple(m.mesh_dim_names), tuple(m.mesh.shape),
      tuple(h.mesh_dim_names), tuple(h.mesh.shape), float(x))
"""


def test_two_members_join_from_the_env():
    """Two processes with the gang env join through the shim (whole-
    device members) and build the gang's mesh: gloo, its reason logged,
    the default (dp=2, tp=1) mesh and, forced hybrid on one host, a dcn
    axis over the processes. A malformed timeout warns and is ignored."""
    port = free_port()
    envs = [_rank_env(port, r, **{C.ENV_RENDEZVOUS_TIMEOUT_S: "soon"})
            for r in range(2)]
    results = _ranks(["-c", _MEMBER], envs)
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, err[-3000:]
        assert (f"MEMBER {rank} 2 gloo ('dp', 'tp') (2, 1) "
                f"('dcn', 'dp', 'tp') (2, 1, 1) 3.0") in out
        assert "backend gloo: rank(s) [0, 1] have no CUDA device" in err
        assert "ignoring malformed KUBESHARE_TPU_RENDEZVOUS_TIMEOUT_S" in err


def test_a_failed_rendezvous_exits_the_member():
    """A member alone in a gang of two times out at the rendezvous and the
    shim stops it with exit code 1 before any workload code runs."""
    env = _rank_env(free_port(), 1, **{C.ENV_RENDEZVOUS_TIMEOUT_S: "2"})
    (rc, out, err), = _ranks(["-c", "print('RAN SOLO')"], [env], timeout=90)
    assert rc == 1
    assert "RAN SOLO" not in out
    assert "failed its rendezvous" in err


@pytest.mark.parametrize("uuids,want", [
    (["GPU-a", "GPU-b"], ("nccl", "every rank holds its own CUDA device")),
    (["GPU-a"], ("nccl", "every rank holds its own CUDA device")),
    (["GPU-a", "GPU-a"], ("gloo", "ranks [0, 1] share device GPU-a")),
    (["GPU-a", ""], ("gloo", "rank(s) [1] have no CUDA device")),
    (["", ""], ("gloo", "rank(s) [0, 1] have no CUDA device"))])
def test_the_backend_rule(uuids, want):
    name, why = runner.decide_backend(uuids)
    assert (name, why[:len(want[1])]) == want


def test_a_node_mesh_shape_is_not_an_axis_spec(monkeypatch):
    """The divergence, pinned against the JAX package: the engine injects
    ``KUBESHARE_TPU_MESH=2x4`` as the node's mesh shape; JAX's gang_mesh
    parses it as axes and raises, the port's builds the default mesh, or
    the carved one when the carve names every rank."""
    monkeypatch.delenv(C.ENV_VISIBLE_CHIPS, raising=False)
    monkeypatch.setenv("KUBESHARE_TPU_MESH", "2x4")
    with pytest.raises(ValueError, match="bad KUBESHARE_TPU_MESH entry "
                                         "'2x4'"):
        jrunner.gang_mesh()
    mesh = runner.gang_mesh(device_type="cpu")
    assert tuple(mesh.mesh_dim_names) == ("dp", "tp")
    assert tuple(mesh.mesh.shape) == (1, 1)
    monkeypatch.setenv(C.ENV_VISIBLE_CHIPS, "TPU-v5e-host-3@1.3")
    carved = runner.gang_mesh(device_type="cpu")
    assert tuple(carved.mesh.shape) == (1, 1)
    monkeypatch.setenv(C.ENV_VISIBLE_CHIPS, "TPU-v5e-host-3@1.7")
    from kubeshare_tpu_torch.gang.carve import CarveError
    with pytest.raises(CarveError, match="outside mesh axis"):
        runner.gang_mesh(device_type="cpu")     # validated against 2x4
    monkeypatch.delenv(C.ENV_VISIBLE_CHIPS)
    # an axis spec is still an axis spec, with JAX's checks and messages
    for spec, match in (("dp=1,tp=1,sp=1", None),
                        ("dp=2,tp", "bad KUBESHARE_TPU_MESH entry 'tp'"),
                        ("dp=1,sp=1", "must name a 'tp' axis"),
                        ("2x4,dp=1", "bad KUBESHARE_TPU_MESH entry '2x4'")):
        monkeypatch.setenv("KUBESHARE_TPU_MESH", spec)
        if match is None:
            mesh = runner.gang_mesh(device_type="cpu")
            assert tuple(mesh.mesh_dim_names) == ("dp", "tp", "sp")
            with pytest.raises(ValueError, match="remove one"):
                runner.gang_mesh(dp=1, device_type="cpu")
            continue
        with pytest.raises(ValueError, match=match):
            runner.gang_mesh(device_type="cpu")
        with pytest.raises(ValueError, match=match):
            jrunner.gang_mesh()


def test_step_timer_and_timed_range_as_in_jax():
    """Each timed step lands in ``kubeshare_runner_step_seconds`` under its
    phase, and as a ``step`` span when a trace id is given — in both
    packages."""
    from kubeshare_tpu.obs import metrics as jmetrics
    from kubeshare_tpu.obs import trace as jtrace

    seen = {}
    for name, run, metrics, trace in (("port", runner, tmetrics, ttrace),
                                      ("jax", jrunner, jmetrics, jtrace)):
        tracer = trace.install_tracer(trace.Tracer())
        hist = metrics.default_registry().get(
            "kubeshare_runner_step_seconds")
        before = hist.snapshot("parity")[2]
        assert list(run.timed_range(3, phase="parity",
                                    trace_id="t-1")) == [0, 1, 2]
        with run.step_timer("parity"):
            pass
        spans = tracer.spans("t-1")
        seen[name] = (hist.snapshot("parity")[2] - before,
                      [(s.name, s.attrs.get("step")) for s in spans])
        trace.install_tracer(None)
    assert seen["port"] == seen["jax"] == (
        4, [("step", 0), ("step", 1), ("step", 2)])


def test_verify_shared_path(pool2, tmp_path):
    """A path both ranks see passes; per-rank private directories raise
    ``SystemExit`` on EVERY rank, naming the rank that cannot see rank 0's
    probe."""
    shared = str(tmp_path / "shared" / "ck")
    assert pool2.run(ranks.shared_path, [shared, shared], 5.0) == \
        [None, None]
    assert not os.path.exists(shared + ".shared-probe")
    private = [str(tmp_path / f"rank{r}" / "ck") for r in range(2)]
    got = pool2.run(ranks.shared_path, private, 0.5)
    for msg in got:
        assert "is NOT shared storage (process(es) [1] cannot see rank " \
               "0's probe)" in msg


def test_gang_checkpoint_saves_shards_and_reshards(pool2, tmp_path):
    """Saved over tp = 2 (each rank writes its shards into one directory,
    rank 0 commits and promotes), restored over dp = 2 into that layout:
    the step and every param come back whole."""
    from kubeshare_tpu_torch.models import transformer as ttrans

    params = ttrans.init(1, seq_len=16, vocab=64, dim=32, layers=1)
    path = str(tmp_path / "ck")
    pool2.run(ranks.gang_checkpoint, path, {"dp": 1, "tp": 2}, params, True)
    files = sorted(os.listdir(path))
    assert ".metadata" in files and len(
        [f for f in files if f.endswith(".distcp")]) == 2
    assert not os.path.exists(path + ".staging")
    step, got, places = pool2.run(ranks.gang_checkpoint, path,
                                  {"dp": 2, "tp": 1}, params, False)[0]
    assert step == 7
    for a, b in zip(ck.tree_flatten(params)[0], got):
        np.testing.assert_array_equal(b, a)
    # the like-tree's layout: nothing split over dp (tp is of size 1)
    assert all(isinstance(pl[0], Replicate) for pl in places)


def _cli(steps: int, path: str):
    return ["-m", "kubeshare_tpu_torch.models.tinymlp", "--device", "cpu",
            "--steps", str(steps), "--checkpoint", path,
            "--checkpoint-every", "2"]


def test_a_two_rank_cli_resumes_from_its_gang_checkpoint(tmp_path):
    """tinymlp's CLI as two gang members (joined by the shim): 4 steps
    saved every 2, then the same command with 6 steps resumes at step 4
    on both ranks, with no warm-up, and both report one global loss."""
    path = str(tmp_path / "ck")
    port = free_port()
    first = _ranks(_cli(4, path), [_rank_env(port, r) for r in range(2)])
    for rc, out, err in first:
        assert rc == 0, err[-3000:]
        assert "tinymlp: 4 steps in" in out
    port = free_port()
    second = _ranks(_cli(6, path), [_rank_env(port, r) for r in range(2)])
    losses = set()
    for rc, out, err in second:
        assert rc == 0, err[-3000:]
        assert f"tinymlp: resumed at step 4 from {path}, 0 warm-up " \
               f"steps" in out
        assert "tinymlp: 2 steps in" in out
        losses.add(out.rsplit("final loss", 1)[1].strip())
    assert len(losses) == 1


def test_gang_meshes_over_four_ranks():
    """``gang_mesh`` over four gloo ranks: the square default (dp=2,
    tp=2); forced hybrid on one host, a dcn axis over the processes; and
    ``make_hybrid_mesh`` over two groups of two — the shapes JAX gives
    for the same counts."""
    from kubeshare_tpu.parallel import mesh as jmesh
    with RankPool(4) as pool:
        got = pool.run(ranks.mesh_layouts)
    j = jmesh.make_mesh(jax.devices()[:4])
    jh = jmesh.make_hybrid_mesh([jax.devices()[:2], jax.devices()[2:4]])
    for rank, layout in enumerate(got):
        assert layout["gang"][:2] == (j.axis_names, j.devices.shape)
        assert layout["hybrid"][:2] == (("dcn", "dp", "tp"), (4, 1, 1))
        assert layout["made"][:2] == (jh.axis_names, jh.devices.shape)
        assert layout["hybrid"][2] == (rank, 0, 0)
