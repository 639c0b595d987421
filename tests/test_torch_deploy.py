"""The port made deployable: its manifests (``deploy/torch/``), image
(``docker/Dockerfile.torch``), standalone backend
(``tools/launch_backend_torch.py``), observability scripts, examples
(``examples/torch/``) and Makefile targets, on the CPU.

Every manifest's containers run modules of the port whose parsers take
the manifest's flags, and the placement daemons start from the
manifests' own argv (through ``chip_smoke.place_argv``, the table phase
5i starts them with on the card) and stop on SIGTERM. The objects are the
JAX manifests' but for images, commands and how a node sees its cards.
This file imports no JAX."""

import argparse
import copy
import importlib
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import yaml

import chip_smoke
from kubeshare_tpu_torch import constants as C
from kubeshare_tpu_torch.nodeagent.launcherd import TOKEN_PORT_OFFSET
from kubeshare_tpu_torch.scheduler.engine import SchedulerEngine
from kubeshare_tpu_torch.scheduler.labels import parse_pod_labels
from kubeshare_tpu_torch.topology.discovery import FakeTopology

REPO = Path(__file__).resolve().parent.parent
DEPLOY = REPO / "deploy"
TORCH_DEPLOY = DEPLOY / "torch"
MANIFESTS = sorted(TORCH_DEPLOY.glob("*.yaml"))
EXAMPLES = REPO / "examples" / "torch"
FAMILIES = sorted((EXAMPLES / "families").rglob("*.yaml"))
WORKLOADS = sorted(EXAMPLES.glob("*.yaml")) + FAMILIES
H100 = "NVIDIA-H100-80GB-HBM3"
# every file the port's deployment added: none may use JAX or the JAX
# package as a module
ADDED = sorted([*MANIFESTS, *EXAMPLES.rglob("*.yaml"),
                REPO / "docker" / "Dockerfile.torch",
                REPO / "tools" / "launch_backend_torch.py",
                REPO / "scripts" / "torch_trace_demo.py",
                REPO / "scripts" / "torch_fleet_smoke.py",
                REPO / "doc" / "deploy_torch.md"])
JAX_AS_MODULE = re.compile(
    r"\b(import|from)\s+(jax|kubeshare_tpu)\b|\bjax\[|\bjax\.[a-z]"
    r"|-m\s+jax\b|\bkubeshare_tpu\.[a-z]|[\"']kubeshare_tpu[\"']")


def docs(path: Path) -> list:
    return [d for d in yaml.safe_load_all(path.read_text()) if d]


def containers(doc: dict) -> list:
    """The containers and init containers of a workload object."""
    spec = doc.get("spec", {})
    pod = spec.get("template", {}).get("spec", spec)
    return pod.get("initContainers", []) + pod.get("containers", [])


def commands(path: Path) -> list:
    """``(object name, container name, command)`` of every container."""
    return [(d["metadata"]["name"], c["name"], c["command"])
            for d in docs(path) for c in containers(d) if "command" in c]


COMMANDS = [(p, obj, name, cmd) for p in MANIFESTS
            for obj, name, cmd in commands(p)]


class _Parsed(Exception):
    pass


def _parses(monkeypatch, module: str, argv: list) -> argparse.Namespace:
    """Run ``module``'s CLI up to its own ``parse_args`` of ``argv``: a
    flag it does not take exits 2 there (pytest sees SystemExit)."""
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    mod = importlib.import_module(module)
    with pytest.raises(_Parsed) as got:
        if module.startswith("kubeshare_tpu_torch.models."):
            from kubeshare_tpu_torch.models import common

            common.main_cli(module.rsplit(".", 1)[1], mod.init, mod.loss_fn,
                            mod.batch_fn, argv=argv)
        else:
            mod.main(argv)
    return got.value.args[0]


def _has_main(module: str) -> bool:
    spec = importlib.util.find_spec(module)
    return (spec is not None and spec.origin is not None
            and 'if __name__ == "__main__":' in Path(spec.origin).read_text())


# --- the manifests -------------------------------------------------------------

def test_every_jax_manifest_has_its_counterpart():
    assert ({p.name for p in MANIFESTS}
            == {p.name for p in DEPLOY.glob("*.yaml")})


@pytest.mark.parametrize("path", MANIFESTS, ids=lambda p: p.name)
def test_manifest_parses(path):
    for doc in docs(path):
        assert "kind" in doc and "metadata" in doc, path.name


@pytest.mark.parametrize("path, obj, name, cmd", COMMANDS,
                         ids=[f"{p.stem}-{n}" for p, _, n, _ in COMMANDS])
def test_every_command_is_a_port_module_taking_its_flags(path, obj, name,
                                                         cmd, monkeypatch):
    assert cmd[:2] == ["python", "-m"], cmd
    module = cmd[2]
    assert module.startswith("kubeshare_tpu_torch."), cmd
    assert _has_main(module), module
    _parses(monkeypatch, module, cmd[3:])


def _masked(doc: dict) -> dict:
    """A manifest object with what the port changes taken out: images,
    commands, env, resources and the runtime class."""
    doc = copy.deepcopy(doc)
    spec = doc.get("spec", {})
    pod = spec.get("template", {}).get("spec", spec)
    if isinstance(pod, dict):
        pod.pop("runtimeClassName", None)
    for c in containers(doc):
        for key in ("image", "command", "env", "resources"):
            c.pop(key, None)
    return doc


@pytest.mark.parametrize("path", MANIFESTS, ids=lambda p: p.name)
def test_objects_are_the_jax_manifests_but_images_and_commands(path):
    """Names, namespaces, labels, selectors, ports, node selectors,
    hostPaths, probes and the webhook's rules are the wire contract."""
    ours, theirs = docs(path), docs(DEPLOY / path.name)
    assert [_masked(d) for d in ours] == [_masked(d) for d in theirs]
    for mine, jax_doc in zip(ours, theirs):
        for c, jc in zip(containers(mine), containers(jax_doc)):
            if "image" in c:
                assert c["image"] == "kubeshare-tpu-torch:latest"
            # the JAX env stays; a node daemon adds the card's visibility
            assert all(e in c.get("env", []) for e in jc.get("env", []))


@pytest.mark.parametrize("path", [p for p in MANIFESTS if p.name in (
    "collector.yaml", "node-daemon.yaml")], ids=lambda p: p.name)
def test_node_daemons_see_the_cards_through_the_nvidia_runtime(path):
    """No device-plugin claim (it would take the cards from the pool);
    the NVIDIA runtime exposes every card, and the node daemons discover
    them as CUDA devices."""
    for doc in docs(path):
        pod = doc["spec"]["template"]["spec"]
        assert pod["runtimeClassName"] == "nvidia"
        for c in pod["containers"]:
            assert "resources" not in c
            assert {"name": "NVIDIA_VISIBLE_DEVICES",
                    "value": "all"} in c["env"]
            if c["name"] in ("collector", "configd", "launcherd"):
                args = c["command"][3:]
                assert args[args.index("--backend") + 1] == "cuda"


def test_monitoring_scrape_wiring_matches_ports():
    """Every /metrics endpoint of the port is scraped: ServiceMonitor
    ports resolve to named Service ports at the port's well-known numbers
    (the counterpart of tests/test_examples.py's check)."""
    services: dict[str, dict] = {}
    monitors: list[dict] = []
    for path in MANIFESTS:
        for doc in docs(path):
            if doc.get("kind") == "Service":
                app = (doc["metadata"].get("labels") or {}).get("app")
                if app:
                    services[app] = {p["name"]: p["port"]
                                     for p in doc["spec"]["ports"]}
            elif doc.get("kind") == "ServiceMonitor":
                monitors.append(doc)
    assert len(monitors) == 3
    expected = {"kubeshare-tpu-collector": 9004,
                "kubeshare-tpu-registry": C.REGISTRY_PORT,
                "kubeshare-tpu-scheduler": C.SCHEDULER_PORT}
    for mon in monitors:
        app = mon["spec"]["selector"]["matchLabels"]["app"]
        ports = services.get(app)
        assert ports is not None, f"no Service with app={app}"
        for ep in mon["spec"]["endpoints"]:
            assert ep["path"] == "/metrics"
            assert ep["port"] in ports, (app, ep["port"], ports)
            assert ports[ep["port"]] == expected[app]


def test_webhook_manifest_covers_all_optin_keys():
    """A pod carrying any opt-in label of the port is mutated, and the
    webhook fails closed (no isolation bypass)."""
    (cfg,) = [d for d in docs(TORCH_DEPLOY / "webhook.yaml")
              if d.get("kind") == "MutatingWebhookConfiguration"]
    keys = set()
    for wh in cfg["webhooks"]:
        assert wh["failurePolicy"] == "Fail"
        for expr in wh["objectSelector"]["matchExpressions"]:
            assert expr["operator"] == "Exists"
            keys.add(expr["key"])
    assert keys == {C.POD_TPU_LIMIT, C.POD_TPU_REQUEST, C.POD_GROUP_NAME}


@pytest.mark.parametrize("path", MANIFESTS, ids=lambda p: p.name)
def test_the_smokes_reader_gives_every_command(path):
    """``chip_smoke.manifest_commands`` (no PyYAML on the card's machine)
    reads each container's command as YAML does."""
    got = chip_smoke.manifest_commands(str(path))
    assert got == {name: cmd for _, name, cmd in commands(path)}


# --- 5i's table: the manifests' argv on one host ----------------------------------

HOST = {"registry_port": 1234, "node": "tpu-host-0", "scheduler_dir": "/sd",
        "services": "http://a:1,http://b:2", "api": "http://api:3"}


@pytest.mark.parametrize("label", sorted(chip_smoke.PLACE_MANIFESTS))
def test_place_argv_changes_only_the_tables_flags(label, tmp_path):
    """A daemon's argv is its manifest's with only the table's flags
    changed (to this host's value, or left out with theirs for None) and
    5i's own flags appended."""
    manifest, container, flags, extra = chip_smoke.PLACE_MANIFESTS[label]
    cmd = chip_smoke.manifest_commands(str(TORCH_DEPLOY / manifest))[container]
    got = chip_smoke.place_argv(str(REPO), str(tmp_path), label, **HOST)
    fmt = dict(HOST, label=label, dir=str(tmp_path / label))
    n = len(got) - len(extra)
    assert got[n:] == [x.format(**fmt) for x in extra]

    def others(args):
        out, i = [], 0
        while i < len(args):
            if args[i] in flags:
                i += 2
            else:
                out.append(args[i])
                i += 1
        return out

    assert others(got[:n]) == others(cmd[2:])
    for flag, value in flags.items():
        if value is None:
            assert flag not in got[:n]
        elif value == "{port}":
            assert int(got[got.index(flag) + 1]) > 0
        else:
            assert got[got.index(flag) + 1] == value.format(**fmt)


def _wait_line(proc, log: Path, prefix: str, exact: bool = False,
               timeout: float = 90.0) -> str:
    """The first line of ``log`` starting with ``prefix`` (with ``exact``,
    that very line: several processes may write the log)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for line in log.read_text().splitlines():
            if line == prefix or (not exact and line.startswith(prefix)):
                return line
        assert proc.poll() is None, log.read_text()[-3000:]
        time.sleep(0.05)
    raise AssertionError(f"no {prefix!r}: {log.read_text()[-3000:]}")


def test_the_placement_daemons_start_from_their_manifests(tmp_path):
    """The registry and its follower, the collector and configd (a fake
    node: this host has no card), the two services with 5i's flags, the
    bridge (over a fake kube-apiserver) and the webhook, each from its
    manifest's argv with this host's values, reach READY and exit 0 on
    SIGTERM."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")}
    env.update(PYTHONPATH=str(REPO), KUBESHARE_TPU_FAKE_TOPOLOGY="1:1")
    procs: dict = {}
    values = {"node": "tpu-host-0", "scheduler_dir": str(tmp_path / "sd")}
    api = chip_smoke.FakeKubeApi()

    def start(label):
        argv = chip_smoke.place_argv(str(REPO), str(tmp_path), label,
                                     **values)
        if "--backend" in argv:           # this host's discovery
            argv[argv.index("--backend") + 1] = "fake"
        log = tmp_path / f"{label}.log"
        with open(log, "w") as out:
            procs[label] = (subprocess.Popen(
                [sys.executable, "-m", *argv], env=env, cwd=REPO,
                stdout=out, stderr=subprocess.STDOUT), log)

    def ready(label):
        return _wait_line(*procs[label], "READY")

    try:
        start("registry")
        values["registry_port"] = int(ready("registry").split()[1])
        for label in ("follower", "collector", "configd", "webhook",
                      *chip_smoke.PLACE_SERVICES):
            start(label)
        urls = [f"http://127.0.0.1:{ready(h).split()[1]}"
                for h in chip_smoke.PLACE_SERVICES]
        values.update(services=",".join(urls), api=api.url)
        start("bridge")
        for label in procs:
            ready(label)
        assert (tmp_path / "registry" / "registry.jsonl").exists()
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        rcs = {}
        for label, (proc, log) in procs.items():
            try:
                rcs[label] = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs[label] = proc.wait()
        api.close()
    assert rcs == {label: 0 for label in procs}, {
        label: (tmp_path / f"{label}.log").read_text()[-2000:]
        for label, rc in rcs.items() if rc}


# --- 5i's dry-run check --------------------------------------------------------------

def _trace(*entries):
    return [dict(e, seq=i) for i, e in enumerate(entries)]


def test_a_plane_move_fails_the_dry_run_and_a_dispatcher_bind_is_logged():
    """Of the pods placed at both reads, one whose last decision is the
    dispatcher placing it on its new node, bound there within the reads,
    is the dispatcher's: a retried pod's bind, or a pending gang pair
    booked across shards (the chip runs' case: the gang entry carries its
    protocol's start, before the reads; its members' binds come at the
    commit). A plane's move or resize, a bind outside the window or
    elsewhere, no decision, or any change to a pod the plan names is the
    plan's."""
    before = {p: ("fake-node-50", ["c0"], 1.0) for p in
              ("bg/bound", "bg/pair-0", "bg/moved", "bg/resized", "bg/old",
               "bg/elsewhere", "bg/silent", "bg/named", "bg/late-0",
               "bg/same")}
    after = dict(before)
    for p in ("bg/bound", "bg/moved", "bg/old", "bg/elsewhere", "bg/silent",
              "bg/named", "bg/late-0"):
        after[p] = ("fake-node-33", ["c1"], 1.0)
    after["bg/pair-0"] = ("fake-node-1", ["c2"], 1.0)
    after["bg/resized"] = ("fake-node-50", ["c0"], 0.5)
    after["bg/new"] = ("fake-node-1", ["c3"], 1.0)      # bound between
    entries = _trace(
        {"kind": "preempt", "t": 8.0, "pod": "bg/pair-0",
         "node": "fake-node-57", "victims": ["bg/opp"]},
        {"kind": "outcome", "t": 10.5, "pod": "bg/bound", "status": "bound",
         "node": "fake-node-33"},
        {"kind": "outcome", "t": 10.6, "pod": "bg/pair-0", "status": "bound",
         "node": "fake-node-1"},
        {"kind": "gang-cross-shard", "t": 9.9, "gang": "bg/pair",
         "members": {"bg/pair-0": "fake-node-1", "bg/pair-1": "fake-node-50"}},
        {"kind": "outcome", "t": 9.5, "pod": "bg/late-0", "status": "bound",
         "node": "fake-node-33"},
        {"kind": "gang-cross-shard", "t": 9.4, "gang": "bg/late",
         "members": {"bg/late-0": "fake-node-33"}},
        {"kind": "move", "t": 10.7, "pod": "bg/moved", "src": "fake-node-50",
         "dst": "fake-node-33"},
        {"kind": "resize", "t": 10.7, "pod": "bg/resized", "chip": "c0"},
        {"kind": "outcome", "t": 9.0, "pod": "bg/old", "status": "bound",
         "node": "fake-node-33"},
        {"kind": "outcome", "t": 10.8, "pod": "bg/elsewhere",
         "status": "bound", "node": "fake-node-7"},
        {"kind": "outcome", "t": 10.8, "pod": "bg/named", "status": "bound",
         "node": "fake-node-33"})
    plan = {"resizes": [], "moves": [{"pod": "bg/named", "to": "x"}]}
    replaced, wrong = chip_smoke.dry_run_changes(plan, before, after, entries,
                                                 (10.0, 11.0))
    assert [r["pod"] for r in replaced] == ["bg/bound", "bg/pair-0"]
    assert replaced[1]["decision"]["kind"] == "gang-cross-shard"
    assert [w["pod"] for w in wrong] == ["bg/elsewhere", "bg/late-0",
                                         "bg/moved", "bg/named", "bg/old",
                                         "bg/resized", "bg/silent"]
    assert all(w["decision"] is None for w in wrong)
    assert chip_smoke.dry_run_changes(plan, before, before, entries,
                                      (10.0, 11.0)) == ([], [])


# --- the image, the tool, the scripts, the Makefile ------------------------------------

@pytest.mark.parametrize("path", ADDED, ids=lambda p: str(p.relative_to(REPO)))
def test_no_added_file_uses_jax_or_the_jax_package(path):
    hits = [line for line in path.read_text().splitlines()
            if JAX_AS_MODULE.search(line)]
    assert hits == [], hits


def test_the_torch_dockerfile_copies_the_port_and_builds_its_kernels():
    text = (REPO / "docker" / "Dockerfile.torch").read_text()
    lines = [x.strip() for x in text.splitlines()
             if x.strip() and not x.lstrip().startswith("#")]
    copies = [x.split()[1] for x in lines if x.startswith("COPY ")]
    assert copies == ["kubeshare_tpu_torch", "tools"]
    (env,) = [x for x in lines if x.startswith("ENV PYTHONPATH=")]
    root = "/workspace/kubeshare-tpu"
    assert env.split("=", 1)[1].split(":") == [
        root, f"{root}/kubeshare_tpu_torch/_shim"]
    assert re.search(r"^ARG BASE=\S*pytorch\S*-py3$", text, re.M)
    assert "python -m kubeshare_tpu_torch.ops.build" in text
    assert "native.build('tokensched')" in text
    assert not [x for x in lines if "jax" in x.lower()]   # installs none


def test_the_build_cli_names_every_kernel_library():
    """What the image builds: one library a ``csrc/*.cu``, the smoke's
    list."""
    from kubeshare_tpu_torch.ops import build

    assert build.libraries() == sorted(chip_smoke.KERNELS)


def test_the_makefile_names_the_port():
    out = subprocess.run(
        ["make", "-n", "-C", str(REPO), "native-torch", "test-torch",
         "smoke-torch", "obs-check-torch", "image-torch", "clean"],
        capture_output=True, text=True, check=True).stdout
    assert "-m kubeshare_tpu_torch.ops.build" in out
    assert "tests/test_torch_*.py" in out
    assert "chip_smoke.py" in out
    assert "scripts/torch_trace_demo.py" in out
    assert "scripts/torch_fleet_smoke.py" in out
    assert "docker build -f docker/Dockerfile.torch" in out
    assert "rm -rf kubeshare_tpu/isolation/native/_build " \
           "kubeshare_tpu_torch/_build" in out


@pytest.mark.parametrize("script", ["torch_trace_demo.py",
                                    "torch_fleet_smoke.py"])
def test_the_obs_scripts_keep_their_promises(script, tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / script), "--out",
         str(tmp_path)], capture_output=True, text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)}, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ok" in out.stdout.lower()


def test_the_standalone_backend_plumbs_its_config_and_grants_a_gate(
        tmp_path):
    """``tools/launch_backend_torch.py --device cpu``: the JSON line of
    its config, then a proxy on the CPU and the client's pod manager, to
    which a gate registers and is granted the token; SIGTERM stops the
    tool and every process it started."""
    from kubeshare_tpu_torch.isolation.client import ExecutionGate

    port = chip_smoke._free_port()
    start = chip_smoke._free_port_pair()
    cfg = {"chips": ["GPU-0"],
           "clients": [{"name": "ns/a", "chip": "GPU-0", "request": 0.5,
                        "limit": 1.0, "port": port}]}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    log = tmp_path / "tool.log"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KUBESHARE_TPU_")}
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "tools" / "launch_backend_torch.py"),
             "--config", str(tmp_path / "cfg.json"), "--base-dir",
             str(tmp_path), "--device", "cpu", "--port-start", str(start)],
            stdout=out, stderr=subprocess.STDOUT, cwd=REPO, env=env)
    try:
        info = json.loads(_wait_line(proc, log, "{"))
        assert info == {"base_dir": str(tmp_path),
                        "exec_ports": {"GPU-0": start},
                        "token_ports": {"GPU-0": start + TOKEN_PORT_OFFSET},
                        "manager_ports": {"ns/a": port}}
        _wait_line(proc, log, f"READY {port}", exact=True)
        gate = ExecutionGate.connect("127.0.0.1", port, "ns/a", 0.5, 1.0,
                                     barrier=lambda: None)
        try:
            gate()
            assert gate.stats()["acquires"] == 1
        finally:
            gate.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0, log.read_text()[-3000:]
    for p in (start, start + TOKEN_PORT_OFFSET, port):     # nothing left serving
        with chip_smoke.socket.socket() as s:
            assert s.connect_ex(("127.0.0.1", p)) != 0, p


# --- the examples ----------------------------------------------------------------------

def pod_docs(path: Path):
    """One pod a Pod, a Job's or Deployment's replica (as
    tests/test_examples.py counts them)."""
    for doc in docs(path):
        if doc.get("kind") == "Pod":
            yield doc
        elif doc.get("kind") in ("Job", "Deployment"):
            replicas = int(doc["spec"].get("replicas", 1) or 1)
            for i in range(replicas):
                tpl = copy.deepcopy(doc["spec"]["template"])
                suffix = f"-{i}" if replicas > 1 else ""
                tpl["metadata"]["name"] = doc["metadata"]["name"] + suffix
                yield tpl


def labels_of(doc) -> dict:
    return {str(k): str(v)
            for k, v in (doc["metadata"].get("labels") or {}).items()}


def test_every_jax_workload_example_has_its_counterpart():
    """The top-level model pods and every family, with the same labels
    (the device-model pin names the card)."""
    src = REPO / "examples"
    theirs = [p for p in sorted(src.glob("*.yaml"))
              + sorted((src / "families").rglob("*.yaml"))
              if any(c.get("command", [""])[0] == "python"
                     for d in docs(p) for c in containers(d))]
    for path in theirs:
        rel = path.relative_to(src)
        mine = EXAMPLES / str(rel).replace("gang-jax-distributed",
                                          "gang-distributed")
        a = [labels_of(d) for d in pod_docs(mine)]
        b = [labels_of(d) for d in pod_docs(path)]
        for la, lb in zip(a, b):
            if C.POD_TPU_MODEL in lb:
                assert la.pop(C.POD_TPU_MODEL) == H100
                lb.pop(C.POD_TPU_MODEL)
        assert a == b, rel


@pytest.mark.parametrize("path", WORKLOADS,
                         ids=lambda p: str(p.relative_to(EXAMPLES)))
def test_workload_example_validates_and_runs_the_port(path, monkeypatch):
    pods = list(pod_docs(path))
    assert pods
    for doc in pods:
        pr = parse_pod_labels("default", doc["metadata"]["name"],
                              labels_of(doc))
        if path in FAMILIES:
            assert doc["spec"]["schedulerName"] == C.SCHEDULER_NAME
        if pr.needs_tpu:
            assert pr.limit > 0
    for doc in docs(path):
        for c in containers(doc):
            cmd = c["command"]
            assert c["image"] == "kubeshare-tpu-torch:latest"
            assert cmd[:2] == ["python", "-m"]
            assert cmd[2].startswith("kubeshare_tpu_torch.models.")
            _parses(monkeypatch, cmd[2], cmd[3:])


def _engine(hosts=4, mesh=(2, 2), model=H100) -> SchedulerEngine:
    eng = SchedulerEngine()
    by_host: dict = {}
    for chip in FakeTopology(hosts=hosts, mesh=mesh, model=model).chips():
        by_host.setdefault(chip.host, []).append(chip)
    for host, chips in by_host.items():
        eng.add_node(host, chips)
    return eng


@pytest.mark.parametrize("path", FAMILIES,
                         ids=lambda p: str(p.relative_to(EXAMPLES)))
def test_family_places_on_a_fake_fleet(path):
    """Every family's pods fit, together, on a fake fleet of 4 nodes of 4
    H100s through the port's engine, without oversubscribing a device,
    and the documented semantics hold."""
    eng = _engine()
    placed = [eng.submit("default", doc["metadata"]["name"], labels_of(doc))
              for doc in pod_docs(path)]
    for pod in placed:
        eng.schedule(pod)
        assert pod.node_name, f"{path.name}: {pod.name} not placed"
    for leaf in eng.leaf_cells.values():
        assert leaf.available >= -1e-9
        assert leaf.free_memory >= 0
    if path.name == "mixed-tier.yaml":
        by_name = {p.name: p for p in placed}
        scav = by_name["mixed-scavenger"]
        others = {c for p in placed if p is not scav for c in p.chip_ids}
        assert set(scav.chip_ids) & others
    if path.name == "resnet-2x2chip.yaml":
        a, b = placed
        assert not (set(a.chip_ids) & set(b.chip_ids))


def _trace_file(d: Path, steps, skew: float = 0.0) -> str:
    """A chrome trace in ``d`` as ``run_training``'s profiler writes one:
    a ``ProfilerStep#N`` span a step on the host's clock (from 1: step 0
    was the warm-up) and each step's kernels (``steps``: a list of
    kernel names a step) on the card's, ``skew`` µs off the host's."""
    events, t = [], 1000.0
    for n, names in enumerate(steps, 1):
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": f"ProfilerStep#{n}", "ts": t, "dur": 900.0})
        for i, name in enumerate(names):
            events.append({"ph": "X", "cat": "kernel", "name": name,
                           "ts": t + skew + 10.0 + 20.0 * i, "dur": 5.0})
        t += 1000.0
    d.mkdir()
    (d / "host_1.1.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    return str(d)


def test_the_smoke_reads_a_trace_from_its_third_traced_step(tmp_path):
    """5j's and 5m's trace reading: the first two traced steps are left
    out (the first may lack a kernel that ran, its Adam launch too), the
    later ones are read, cut on the card's clock at each step's last Adam
    launch (a host span's offset to the kernels' times does not move a
    kernel between steps), and a kernel missing there still shows in the
    exact per-step count."""
    step = ["embed", "flash_fwd_mma_kernel<32, true>",
            "flash_dq_mma_kernel<32, true>", "flash_dkv_mma_kernel<32, true>",
            "adam_multi_tensor_kernel"]
    short = [k for k in step if not k.startswith("flash_fwd")]
    no_adam = [k for k in step if not k.startswith("adam")]
    each = {"fused_adam": 1.0, "flash_fwd": 1.0, "flash_dq": 1.0,
            "flash_dkv": 1.0, "flash_prep": 0.0}
    for i, skew in enumerate((0.0, -300.0, 400.0)):
        for j, first in enumerate((short, no_adam)):
            got = chip_smoke._trace_summary(
                _trace_file(tmp_path / f"a{i}{j}", [first] + [step] * 5,
                            skew), 6, 1)
            assert got["ours"] == each, (skew, first)
            assert got["kernels"] == 5.0 and got["device_ms"] == 0.025
            assert got["steps"] == 4
    got = chip_smoke._trace_summary(
        _trace_file(tmp_path / "b", [step, step, step, short, step, step]),
        6, 1)
    assert got["ours"]["flash_fwd"] == 0.75
    two = step + ["adam_multi_tensor_kernel"]      # two Adam tables
    got = chip_smoke._trace_summary(
        _trace_file(tmp_path / "c", [short] + [two] * 5, -300.0), 6, 2)
    assert got["ours"]["fused_adam"] == 2.0 and got["ours"]["flash_fwd"] == 1
    with pytest.raises(SystemExit):      # not the steps it should hold
        chip_smoke._trace_summary(_trace_file(tmp_path / "d", [step] * 5),
                                  6, 1)