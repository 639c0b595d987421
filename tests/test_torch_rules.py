"""Rules of the port: it imports neither JAX nor the JAX package, and its
entry points never fall back to the CPU when CUDA is asked for and absent.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "kubeshare_tpu")


def _port_files():
    files = sorted((ROOT / "kubeshare_tpu_torch").rglob("*.py"))
    return (files + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("torch_*.py")))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for want in ("kubeshare_tpu_torch/ops/fused_adam.py",
                 "kubeshare_tpu_torch/ops/flash_attention.py",
                 "kubeshare_tpu_torch/models/transformer.py",
                 "kubeshare_tpu_torch/models/cifar10.py",
                 "kubeshare_tpu_torch/models/vgg.py",
                 "kubeshare_tpu_torch/models/resnet.py",
                 "kubeshare_tpu_torch/models/lstm.py",
                 "kubeshare_tpu_torch/models/checkpoint.py",
                 "kubeshare_tpu_torch/ops/moe.py",
                 "kubeshare_tpu_torch/isolation/proxy.py",
                 "kubeshare_tpu_torch/isolation/podmgr.py",
                 "kubeshare_tpu_torch/attach.py",
                 "kubeshare_tpu_torch/_shim/sitecustomize.py",
                 "kubeshare_tpu_torch/resilience/reconnect.py",
                 "kubeshare_tpu_torch/nodeagent/files.py",
                 "kubeshare_tpu_torch/nodeagent/launcherd.py",
                 "kubeshare_tpu_torch/topology/chip.py",
                 "kubeshare_tpu_torch/topology/discovery.py",
                 "kubeshare_tpu_torch/topology/cell.py",
                 "kubeshare_tpu_torch/topology/cellconfig.py",
                 "kubeshare_tpu_torch/scheduler/engine.py",
                 "kubeshare_tpu_torch/telemetry/registry.py",
                 "kubeshare_tpu_torch/telemetry/collector.py",
                 "kubeshare_tpu_torch/telemetry/aggregator.py",
                 "kubeshare_tpu_torch/nodeagent/configd.py",
                 "kubeshare_tpu_torch/nodeagent/queryip.py",
                 "kubeshare_tpu_torch/obs/decisions.py",
                 "kubeshare_tpu_torch/chaos/invariants.py",
                 "kubeshare_tpu_torch/gang/coordinator.py",
                 "kubeshare_tpu_torch/telemetry/remote_write.py",
                 "kubeshare_tpu_torch/scheduler/healthwatch.py",
                 "kubeshare_tpu_torch/scheduler/configwatch.py",
                 "kubeshare_tpu_torch/scheduler/dispatcher.py",
                 "kubeshare_tpu_torch/scheduler/service.py",
                 "kubeshare_tpu_torch/scheduler/bridge.py",
                 "kubeshare_tpu_torch/scheduler/webhook.py",
                 "kubeshare_tpu_torch/scheduler/shard.py",
                 "kubeshare_tpu_torch/ha/__init__.py",
                 "kubeshare_tpu_torch/ha/leadership.py",
                 "kubeshare_tpu_torch/ha/replication.py",
                 "kubeshare_tpu_torch/ha/standby.py",
                 "kubeshare_tpu_torch/doctor.py",
                 "kubeshare_tpu_torch/topcli.py",
                 "kubeshare_tpu_torch/parallel/__init__.py",
                 "kubeshare_tpu_torch/parallel/mesh.py",
                 "kubeshare_tpu_torch/parallel/runner.py",
                 "kubeshare_tpu_torch/parallel/ringattention.py",
                 "kubeshare_tpu_torch/parallel/ulysses.py",
                 "kubeshare_tpu_torch/parallel/pipeline.py",
                 "kubeshare_tpu_torch/parallel/collectives.py",
                 "kubeshare_tpu_torch/utils/virtualcpu.py",
                 "kubeshare_tpu_torch/autopilot/__init__.py",
                 "kubeshare_tpu_torch/autopilot/cooldown.py",
                 "kubeshare_tpu_torch/autopilot/elastic.py",
                 "kubeshare_tpu_torch/autopilot/planner.py",
                 "kubeshare_tpu_torch/autopilot/rebalancer.py",
                 "kubeshare_tpu_torch/autopilot/controller.py",
                 "kubeshare_tpu_torch/elastic/__init__.py",
                 "kubeshare_tpu_torch/elastic/orchestrator.py",
                 "kubeshare_tpu_torch/elastic/restate.py",
                 "kubeshare_tpu_torch/elastic/trainer.py",
                 "kubeshare_tpu_torch/elastic/sim.py",
                 "scripts/torch_elastic_runs.py",
                 "scripts/torch_gang_backlog.py",
                 "chip_smoke.py", "scripts/torch_step_profile.py",
                 "scripts/torch_gate_pairs.py"):
        assert want in names
    for kernel in ("fused_adam", "flash_attention"):
        assert (ROOT / f"kubeshare_tpu_torch/csrc/{kernel}.cu").exists()


def test_every_jax_module_has_a_counterpart():
    """Each ``.py`` of ``kubeshare_tpu/`` has its counterpart at the same
    path under ``kubeshare_tpu_torch/``."""
    jax_root = ROOT / "kubeshare_tpu"
    missing = sorted(
        p.relative_to(jax_root).as_posix() for p in jax_root.rglob("*.py")
        if not (ROOT / "kubeshare_tpu_torch"
                / p.relative_to(jax_root)).exists())
    assert missing == []


def test_shim_imports_only_the_ports_attach():
    """The shim runs in every process of the node: it may import the
    standard library and ``kubeshare_tpu_torch.attach``, nothing else."""
    path = ROOT / "kubeshare_tpu_torch/_shim/sitecustomize.py"
    tree = ast.parse(path.read_text())
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            modules.add(node.module)
    assert modules == {"os", "sys", "traceback",
                       "kubeshare_tpu_torch.attach"}


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_yaml_is_imported_only_inside_load_config():
    """The card's machine has no PyYAML: of the port, only
    ``cellconfig.load_config`` imports it, inside the function."""
    for path in _port_files():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                continue
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            assert "yaml" not in names or path.name == "cellconfig.py", path
    tree = ast.parse((ROOT / "kubeshare_tpu_torch/topology/cellconfig.py")
                     .read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any(a.name == "yaml" for n in top
                   if isinstance(n, ast.Import) for a in n.names)
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "load_config")
    assert any(isinstance(n, ast.Import) and n.names[0].name == "yaml"
               for n in ast.walk(fn))


@pytest.fixture
def no_cuda(monkeypatch):
    # decided inside the fixture: this machine may or may not have a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_run_training_without_device_raises(no_cuda):
    from kubeshare_tpu_torch.models import common, tinymlp

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.run_training(tinymlp.init, tinymlp.loss_fn, tinymlp.batch_fn,
                            steps=1)


def test_chip_proxy_without_device_raises(no_cuda):
    from kubeshare_tpu_torch.isolation.proxy import ChipProxy

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ChipProxy()


def test_resolve_device(no_cuda):
    from kubeshare_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_model_cli_defaults_to_cuda(no_cuda):
    from kubeshare_tpu_torch.models import common, tinymlp

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.main_cli("tinymlp", tinymlp.init, tinymlp.loss_fn,
                        tinymlp.batch_fn, argv=["--steps", "1"])


def test_transformer_entry_points_default_to_cuda(no_cuda):
    from kubeshare_tpu_torch.models import common, transformer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.run_training(transformer.init, transformer.flash_loss_fn,
                            transformer.batch_fn, steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.main_cli("transformer", transformer.init, transformer.loss_fn,
                        transformer.batch_fn, argv=["--steps", "1"])


@pytest.mark.parametrize("name", ["mnist", "cifar10", "lstm", "resnet", "vgg",
                                  "transformer", "tinymlp"])
def test_every_model_cli_defaults_to_cuda(no_cuda, name):
    """Each model's CLI and ``run_training`` raise without a card when no
    device is given, before any parameter is made."""
    from kubeshare_tpu_torch.models import MODEL_NAMES, common, get_model

    assert name in MODEL_NAMES
    mod = get_model(name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.main_cli(name, mod.init, mod.loss_fn, mod.batch_fn,
                        argv=["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.run_training(mod.init, mod.loss_fn, mod.batch_fn, steps=1,
                            checkpoint="unused", profile_dir="unused")


def test_profile_writes_a_trace_on_the_cpu(tmp_path):
    """``--profile DIR`` wraps the timed loop in ``torch.profiler`` and
    writes its trace into DIR: the timed steps' ops, not the warm-up's,
    from the second timed step on (the first is the profiler's own
    warm-up), each step a ``ProfilerStep#N`` span."""
    import json

    from kubeshare_tpu_torch.models import common, tinymlp

    res = common.main_cli("tinymlp", tinymlp.init, tinymlp.loss_fn,
                          tinymlp.batch_fn,
                          argv=["--device", "cpu", "--steps", "3",
                                "--profile", str(tmp_path / "prof")])
    assert res.steps == 3
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    steps = sorted(e["name"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("ProfilerStep#"))
    assert steps == ["ProfilerStep#1", "ProfilerStep#2"], steps
    mms = [e for e in events if e.get("name") == "aten::mm"]
    # tinymlp's step: 2 matmuls forward, 3 backward (none for the input)
    assert len(mms) == len(steps) * 5, len(mms)


_GANG_RANK = """
import sys, torch.distributed as dist
from kubeshare_tpu_torch.models import common, tinymlp
dist.init_process_group("gloo", init_method=sys.argv[1], rank=int(sys.argv[2]),
                        world_size=2)
try:
    r = common.main_cli("tinymlp", tinymlp.init, tinymlp.loss_fn,
                        tinymlp.batch_fn, argv=["--device", "cpu", "--steps",
                                                "1", "--checkpoint",
                                                sys.argv[3]])
    print("SAVED", r.steps)
finally:
    dist.destroy_process_group()
"""


def test_checkpoint_in_a_gang_is_refused_naming_its_item(tmp_path):
    """Under a two-rank gloo group ``--checkpoint`` is no longer refused:
    both ranks train over the gang's mesh and write ONE committed
    checkpoint (every rank's shards, ``.metadata`` last), which a single
    process then restores, at its step."""
    import os
    import socket
    import subprocess
    import sys

    from kubeshare_tpu_torch.models import checkpoint as ck
    from kubeshare_tpu_torch.models import common, tinymlp
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    ckpt = tmp_path / "ck"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GANG_RANK, f"tcp://127.0.0.1:{port}",
         str(rank), str(ckpt)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "SAVED 1" in out, out + err
    assert (ckpt / ".metadata").is_file()
    assert not (tmp_path / "ck.staging").exists()
    like = common.to_device(tinymlp.init(0), "cpu")
    _, state, step = ck.load_checkpoint(ckpt, like, fused_adam().init(like))
    assert step == 1 and float(state["count"]) == 3.0   # 2 warm-up + 1


def test_parallel_entry_points_default_to_cuda(no_cuda):
    """A mesh's tensors live on the card unless the caller says the CPU:
    ``make_mesh`` and ``gang_mesh`` default to cuda, and training over such
    a mesh raises without a card, before any collective."""
    from kubeshare_tpu_torch.models import common, tinymlp
    from kubeshare_tpu_torch.parallel import mesh, runner

    assert mesh.make_mesh(range(1)).device_type == "cuda"
    assert runner.gang_mesh().device_type == "cuda"
    assert mesh.make_mesh(range(1), device_type="cpu").device_type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.run_training(tinymlp.init, tinymlp.loss_fn, tinymlp.batch_fn,
                            steps=1, mesh=mesh.make_mesh(range(1)))


def test_flash_attention_runs_on_cuda_or_cpu_only():
    from kubeshare_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros(1, 16, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)


def test_the_elastic_trainer_defaults_to_cuda(no_cuda):
    """The elastic data plane's meshes live on the card unless the caller
    says the CPU, and a trainer raises without a card before any state is
    laid out."""
    from kubeshare_tpu_torch.elastic import ElasticTrainer
    from kubeshare_tpu_torch.models import tinymlp
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ElasticTrainer(tinymlp.loss_fn, fused_adam(), tinymlp.init(0),
                       devices=[0])


def test_the_control_planes_import_without_torch():
    """The service, doctor and topcli load the autopilot and the elastic
    orchestrator as control plane: neither pulls in torch, so neither
    initialises CUDA or torch.distributed."""
    import subprocess
    import sys

    probe = ("import sys\n"
             "import kubeshare_tpu_torch.autopilot\n"
             "import kubeshare_tpu_torch.elastic\n"
             "import kubeshare_tpu_torch.elastic.orchestrator\n"
             "import kubeshare_tpu_torch.elastic.sim\n"
             "import kubeshare_tpu_torch.scheduler.service\n"
             "print(sorted(m for m in sys.modules\n"
             "             if m == 'torch' or m.startswith('torch.')))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
