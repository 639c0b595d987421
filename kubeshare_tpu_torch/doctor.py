"""Deploy-time health checks: ``python -m kubeshare_tpu_torch.doctor``.

The port's copy of ``kubeshare_tpu/doctor.py``. Its chip check probes
the CUDA card with torch, and its discovery check runs the port's
``cuda`` discovery; with no card both fail, and neither reports the CPU
as a chip. The HTTP probes are the reference's.

The reference's deploy doc has the operator hand-verify each plane before
installing the next (Prometheus endpoints, the ``gpu_capacity`` metric —
``doc/deploy.md:137-146``); this command runs those checks in one shot:

1. **chip** — does torch see a CUDA card, and how fast is a trivial
   op on it plus a host read, CUDA start-up included? (Probed in a
   subprocess with a timeout: a wedged driver hangs inside C where no
   Python timeout reaches.)
2. **discovery** — do the cards enumerate, with model/memory?
3. **registry** — is the telemetry bus reachable; does ``/metrics``
   render; how many capacity/requirement records live there?
4. **scheduler** — is the service reachable; does ``/state`` show nodes?
5. **node files** — does the per-chip client-list directory exist?
6. **leases** — does the registry's ``/leases`` endpoint answer (the
   health plane's wire, ``doc/health.md``)?
7. **heartbeat** — is THIS node's lease fresh (age < its TTL)? A deployed
   agent whose beats aren't landing is exactly a silent future eviction.
8. **fleetquery / pushfresh** — does the registry's ``GET /query``
   evaluate a fleet aggregation, and is every remote-writing instance's
   newest sample younger than two push intervals
   (``doc/observability.md``)? Lag is a *warn*: the TSDB stales the
   instance on its own.
9. **clockskew** — |local clock − registry clock| < TTL/4. Lease ages are
   computed on the registry's clock, so the health plane itself tolerates
   any skew — but a drifting node corrupts every *other* cross-host
   timestamp (capacity ages, trace spans), and TTL/4 is where an operator
   eyeballing ages starts drawing wrong conclusions.

Each check prints ``ok`` / ``fail`` / ``skip`` with one diagnostic line;
exit code is non-zero when any check fails. Network checks default to the
deploy manifests' well-known service addresses (in-cluster DNS inside a
pod, localhost on a bare host) so a zero-flag run on a deployed node
checks every plane — pass ``--registry none`` / ``--scheduler none`` on a
dev box that deliberately runs no cluster.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import urllib.request

from . import constants as C

#: the repo root, put on the probes' ``PYTHONPATH``
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(code: str, timeout_s: float) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH", "")) if p)
    return subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True,
                          timeout=timeout_s, env=env)


def _result(name: str, status: str, detail: str) -> bool:
    print(f"{name:<12} {status:<5} {detail}")
    return status != "fail"


def check_chip(timeout_s: float) -> bool:
    probe = ("import time; t0=time.time(); import torch\n"
             "if not torch.cuda.is_available():\n"
             "    raise SystemExit('no CUDA card visible to torch')\n"
             "x = float(torch.ones(8, device='cuda').sum())\n"
             "print('cuda', torch.cuda.get_device_name(0), "
             "round((time.time()-t0)*1000), 'ms')")
    try:
        proc = _probe(probe, timeout_s)
    except subprocess.TimeoutExpired:
        return _result("chip", "fail",
                       f"CUDA init hung > {timeout_s:.0f}s — driver "
                       "wedged? (retry later; develop on cpu)")
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout).strip().splitlines()
        return _result("chip", "fail", tail[-1] if tail else "unknown")
    return _result("chip", "ok", proc.stdout.strip())


def check_discovery(chip_ok: bool, timeout_s: float) -> bool:
    if os.environ.get("KUBESHARE_TPU_FAKE_TOPOLOGY"):
        from .topology.discovery import discover_chips
        try:
            chips = discover_chips("fake")
        except Exception as exc:
            return _result("discovery", "fail",
                           f"{type(exc).__name__}: {exc}")
        if not chips:
            return _result("discovery", "fail", "fake topology is empty")
        return _result("discovery", "ok",
                       f"(fake) {len(chips)} chip(s); first: "
                       f"{chips[0].chip_id}")
    if not chip_ok:
        # Live discovery initializes CUDA — on a wedged driver that
        # hangs where no timeout can reach.
        return _result("discovery", "skip",
                       "chip unreachable; set KUBESHARE_TPU_FAKE_TOPOLOGY "
                       "to exercise the fake path")
    probe = ("from kubeshare_tpu_torch.topology.discovery import "
             "discover_chips; cs = discover_chips('cuda'); c = cs[0]; "
             "print(len(cs), c.chip_id, c.memory >> 30, c.coords)")
    try:
        proc = _probe(probe, timeout_s)
    except subprocess.TimeoutExpired:
        return _result("discovery", "fail", "hung — driver wedged?")
    if proc.returncode != 0:
        tail = (proc.stderr or proc.stdout).strip().splitlines()
        return _result("discovery", "fail", tail[-1] if tail else "unknown")
    # A runtime may interleave banners/logs into stdout; the probe's own
    # line is the last one.  Parse defensively — a report tool
    # must never die with a traceback mid-report.
    lines = proc.stdout.strip().splitlines()
    try:
        n, chip_id, gib, coords = lines[-1].split(maxsplit=3)
    except (IndexError, ValueError):
        return _result("discovery", "fail",
                       f"unexpected probe output: {proc.stdout!r:.200}")
    return _result("discovery", "ok",
                   f"{n} chip(s); first: {chip_id} {gib}GiB coords={coords}")


def _get(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode()


# Well-known service addresses from the deploy manifests
# (deploy/registry.yaml:57,63 / deploy/scheduler.yaml:42,47) — the doctor
# defaults to these so a zero-flag run on a deployed node checks every
# plane instead of skipping (the reference's deploy-time list is mandatory
# reading, doc/deploy.md:137-146).  In-cluster we use service DNS; on a
# bare host the master components are expected on localhost.  Pass
# ``--registry none`` / ``--scheduler none`` to skip explicitly.
def _default_addr(service: str, port: int) -> str:
    if os.environ.get("KUBERNETES_SERVICE_HOST"):
        return f"{service}.kube-system.svc:{port}"
    return f"127.0.0.1:{port}"


def _refused(exc: Exception) -> bool:
    return "refused" in str(exc).lower()


def check_registry(addr: str, timeout_s: float,
                   defaulted: bool = False) -> bool:
    if not addr or addr == "none":
        return _result("registry", "skip", "--registry none")
    from .telemetry.registry import RegistryClient
    host, _, port = addr.partition(":")
    try:
        # The real client path — the doctor validates what consumers use.
        body = RegistryClient(host, int(port), timeout=timeout_s).metrics()
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            # Zero-flag run on a dev box with no cluster: a refused
            # DEFAULT address is "nothing deployed here", not a failure —
            # the exit-0 contract automation may rely on. An
            # explicit --registry flag still fails loudly.
            return _result("registry", "skip",
                           f"{addr} refused (no cluster on this host; "
                           "pass --registry to require it)")
        return _result("registry", "fail", f"{addr}: {exc}")
    cap = body.count("tpu_capacity{")
    req = body.count("tpu_requirement{")
    return _result("registry", "ok",
                   f"{addr}: {cap} capacity / {req} requirement records")


def check_scheduler(addr: str, timeout_s: float,
                    defaulted: bool = False) -> bool:
    if not addr or addr == "none":
        return _result("scheduler", "skip", "--scheduler none")
    try:
        state = json.loads(_get(f"http://{addr}/state", timeout_s))
        nodes = state.get("nodes", state) if isinstance(state, dict) \
            else state
        n = len(nodes)
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("scheduler", "skip",
                           f"{addr} refused (no cluster on this host; "
                           "pass --scheduler to require it)")
        return _result("scheduler", "fail", f"{addr}: {exc}")
    return _result("scheduler", "ok", f"{addr}: {n} node(s) in the engine")


def check_autopilot(addr: str, timeout_s: float,
                    defaulted: bool = False) -> bool:
    """Autopilot plane probe (doc/autopilot.md): ``/autopilot`` must
    answer; a detached autopilot is a skip (the plane is opt-in via
    ``--autopilot``), an attached one reports its fragmentation score."""
    if not addr or addr == "none":
        return _result("autopilot", "skip", "--scheduler none")
    try:
        state = json.loads(_get(f"http://{addr}/autopilot", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("autopilot", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("autopilot", "skip",
                           "scheduler predates /autopilot")
        return _result("autopilot", "fail", f"{addr}: {exc}")
    if not state.get("attached"):
        return _result("autopilot", "skip",
                       "not attached (start the scheduler with "
                       "--autopilot to enable)")
    frag = state.get("fragmentation", 0.0)
    return _result(
        "autopilot", "ok",
        f"{addr}: {'enabled' if state.get('enabled') else 'DISABLED'}, "
        f"fragmentation {frag:.4f}, {state.get('cycles', 0)} cycle(s), "
        f"{state.get('applied_total', 0)} applied / "
        f"{state.get('rolled_back_total', 0)} rolled back")


def check_rightsize(addr: str, timeout_s: float,
                    defaulted: bool = False) -> bool:
    """Rightsizer probe (doc/autopilot.md, Rightsizing): ``/rightsize``
    must answer; a detached rightsizer is a skip (opt-in via
    ``--rightsize``). An attached one fails on rollbacks outnumbering
    applies — the controller is thrashing against a fleet that keeps
    refusing its plans — and reports burn/share state otherwise."""
    if not addr or addr == "none":
        return _result("rightsize", "skip", "--scheduler none")
    try:
        state = json.loads(_get(f"http://{addr}/rightsize", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("rightsize", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("rightsize", "skip",
                           "scheduler predates /rightsize")
        return _result("rightsize", "fail", f"{addr}: {exc}")
    if not state.get("attached"):
        return _result("rightsize", "skip",
                       "not attached (start the scheduler with "
                       "--rightsize to enable)")
    applied = state.get("applied_total", 0)
    rolled = state.get("rolled_back_total", 0)
    if rolled > max(applied, 0):
        return _result(
            "rightsize", "fail",
            f"{rolled} rollback(s) vs {applied} applied — the "
            "controller is thrashing (see the resize journal)")
    eq = state.get("chip_equivalents") or {}
    return _result(
        "rightsize", "ok",
        f"{addr}: {'enabled' if state.get('enabled') else 'DISABLED'}, "
        f"{state.get('cycles', 0)} cycle(s), {applied} applied / "
        f"{rolled} rolled back, chip-equivalents "
        f"{eq.get('current', 0.0):g}/{eq.get('declared', 0.0):g} "
        "booked/declared")


def check_elastic(addr: str, timeout_s: float,
                  defaulted: bool = False) -> bool:
    """Elastic training-plane probe (doc/elastic.md): ``/elastic`` must
    answer; a detached orchestrator is a skip (opt-in via
    ``--elastic``). An attached one fails when rollbacks outnumber
    applied resizes — plans keep passing trial-booking then dying at
    restate or flip, which means every attempt pauses a live gang for
    nothing."""
    if not addr or addr == "none":
        return _result("elastic", "skip", "--scheduler none")
    try:
        state = json.loads(_get(f"http://{addr}/elastic", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("elastic", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("elastic", "skip",
                           "scheduler predates /elastic")
        return _result("elastic", "fail", f"{addr}: {exc}")
    if not state.get("attached"):
        return _result("elastic", "skip",
                       "not attached (start the scheduler with "
                       "--elastic to enable)")
    by = state.get("by_outcome") or {}
    applied = by.get("applied", 0)
    rolled = by.get("rolled_back", 0)
    if rolled > max(applied, 0):
        return _result(
            "elastic", "fail",
            f"{rolled} rolled-back resize(s) vs {applied} applied — "
            "gangs are being paused for resizes that never land (see "
            "the elastic journal)")
    gangs = state.get("gangs") or {}
    return _result(
        "elastic", "ok",
        f"{addr}: {'enabled' if state.get('enabled') else 'DISABLED'}, "
        f"{state.get('resizes_total', 0)} resize(s), {applied} applied "
        f"/ {rolled} rolled back, {len(gangs)} gang(s)")


def check_serving(addr: str, timeout_s: float,
                  defaulted: bool = False) -> bool:
    """Serving-plane probe (doc/serving.md): ``/serving`` must answer;
    no attached front door is a skip (the plane runs where the serving
    process does), an attached one reports queues and shed totals."""
    if not addr or addr == "none":
        return _result("serving", "skip", "--scheduler none")
    try:
        state = json.loads(_get(f"http://{addr}/serving", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("serving", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("serving", "skip",
                           "scheduler predates /serving")
        return _result("serving", "fail", f"{addr}: {exc}")
    if not state.get("attached"):
        return _result("serving", "skip",
                       "no front door attached (see doc/serving.md)")
    totals = state.get("totals", {})
    return _result(
        "serving", "ok",
        f"{addr}: {len(state.get('tenants', {}))} tenant(s), "
        f"{totals.get('queued', 0)} queued, "
        f"{totals.get('admitted', 0)} admitted / "
        f"{totals.get('shed', 0)} shed, "
        f"{state.get('batches', 0)} batch(es)")


def check_invariants(addr: str, timeout_s: float,
                     defaulted: bool = False) -> bool:
    """Chaos-plane probe (doc/chaos.md): ``/invariants`` must answer
    and report a clean catalog — a live violation (double-booked chip,
    torn gang, serving accounting drift) is a correctness failure, not
    a capacity problem, and always fails the doctor."""
    if not addr or addr == "none":
        return _result("invariants", "skip", "--scheduler none")
    try:
        snap = json.loads(_get(f"http://{addr}/invariants", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("invariants", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("invariants", "skip",
                           "scheduler predates /invariants")
        return _result("invariants", "fail", f"{addr}: {exc}")
    violations = snap.get("violations", [])
    if violations:
        worst = violations[0]
        return _result(
            "invariants", "fail",
            f"{len(violations)} violation(s), first: "
            f"{worst.get('invariant')}: {worst.get('detail')}")
    return _result(
        "invariants", "ok",
        f"{addr}: clean ({', '.join(snap.get('checked', []))}; "
        f"{snap.get('bound', 0)} bound / {snap.get('pending', 0)} "
        f"pending)")


def check_gangs(addr: str, timeout_s: float,
                defaulted: bool = False) -> bool:
    """Gang-plane probe (doc/gang.md): ``/gangs`` must answer — the
    coordinator snapshot IS the liveness signal (it takes the same lock
    every grant does) — and no gang may be stuck mid-reservation."""
    if not addr or addr == "none":
        return _result("gangs", "skip", "--scheduler none")
    try:
        snap = json.loads(_get(f"http://{addr}/gangs", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("gangs", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("gangs", "skip", "scheduler predates /gangs")
        return _result("gangs", "fail", f"{addr}: {exc}")
    gangs = snap.get("gangs", {}) if isinstance(snap, dict) else {}
    reserving = [gid for gid, g in gangs.items()
                 if g.get("state") == "reserving"]
    if reserving:
        return _result(
            "gangs", "fail",
            f"{len(reserving)} gang(s) stuck reserving "
            f"({', '.join(sorted(reserving))}) — partial grants held past "
            "the reserve window?")
    held = sum(1 for g in gangs.values() if g.get("state") == "held")
    return _result(
        "gangs", "ok",
        f"{addr}: coordinator live, {len(gangs)} gang(s) "
        f"({held} held), {len(snap.get('chips', []))} chip(s) attached")


def check_ledger(addr: str, timeout_s: float,
                 defaulted: bool = False) -> bool:
    """Contention-plane probe (doc/observability.md): ``/ledger`` must
    answer, and the chip-time ledger's own conservation property —
    per-state seconds summing to elapsed time within 1% on every chip —
    must hold (the accounting that blames tenants must itself add up)."""
    if not addr or addr == "none":
        return _result("ledger", "skip", "--scheduler none")
    try:
        snap = json.loads(_get(f"http://{addr}/ledger", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("ledger", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("ledger", "skip", "scheduler predates /ledger")
        return _result("ledger", "fail", f"{addr}: {exc}")
    chips = snap.get("chips", {}) if isinstance(snap, dict) else {}
    broken = []
    for cid, c in chips.items():
        elapsed = float(c.get("elapsed_s", 0.0))
        accounted = sum(float(v) for v in c.get("by_state", {}).values())
        if abs(accounted - elapsed) > max(0.01 * max(elapsed, 1e-9), 1e-6):
            broken.append(cid)
    if broken:
        return _result(
            "ledger", "fail",
            f"conservation violated on {len(broken)} chip(s) "
            f"({', '.join(sorted(broken))}) — per-state sums != elapsed")
    edges = len((snap.get("blame") or {}).get("edges", []))
    return _result(
        "ledger", "ok",
        f"{addr}: {len(chips)} chip timeline(s) conserve, "
        f"{edges} blame edge(s)")


def check_preempt(addr: str, timeout_s: float,
                  defaulted: bool = False) -> bool:
    """Preemption-plane probe (doc/isolation-wire.md): ``/preempt``
    must answer; when a policy is attached its class ladder must rank
    ``latency`` above ``best-effort`` (otherwise SLO classes are
    decorative) — a detached policy is a valid deployment, not a
    failure."""
    if not addr or addr == "none":
        return _result("preempt", "skip", "--scheduler none")
    try:
        snap = json.loads(_get(f"http://{addr}/preempt", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("preempt", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("preempt", "skip",
                           "scheduler predates /preempt")
        return _result("preempt", "fail", f"{addr}: {exc}")
    if not snap.get("attached"):
        return _result("preempt", "ok",
                       f"{addr}: no policy attached "
                       "(preemption disabled — scheduler runs pure FIFO"
                       "/stride)")
    ladder = snap.get("class_priority", {})
    if ladder.get("latency", 0) <= ladder.get("best-effort", 0):
        return _result(
            "preempt", "fail",
            "class ladder does not rank latency above best-effort "
            f"({ladder}) — SLO classes are decorative")
    stats = snap.get("stats", {})
    return _result(
        "preempt", "ok",
        f"{addr}: policy attached (grace {snap.get('grace_ms')}ms), "
        f"{stats.get('preemptions', 0)} preemption(s), "
        f"{stats.get('yields', 0)} boundary yield(s)")


def check_prof(addr: str, timeout_s: float,
               defaulted: bool = False) -> bool:
    """Contention-profiler probe (doc/observability.md "Locks, phases,
    and profiles"): ``/prof`` must answer, and the dispatcher's phase
    attribution must sum to >= 95% of measured under-lock span time —
    validated client-side so a scheduler whose phase brackets drifted
    out of :meth:`Dispatcher._step_inner` cannot self-report health."""
    if not addr or addr == "none":
        return _result("prof", "skip", "--scheduler none")
    try:
        snap = json.loads(_get(f"http://{addr}/prof", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("prof", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("prof", "skip", "scheduler predates /prof")
        return _result("prof", "fail", f"{addr}: {exc}")
    if not snap.get("enabled", True):
        return _result("prof", "skip",
                       f"{addr}: profiler disabled (--no-prof)")
    disp = (snap.get("phases") or {}).get("dispatcher")
    if not disp or not disp.get("spans"):
        return _result("prof", "ok",
                       f"{addr}: profiler live, no dispatcher steps yet")
    span_s = float(disp.get("span_seconds", 0.0))
    accounted = sum(float(v) for v in (disp.get("phases") or {}).values())
    coverage = accounted / span_s if span_s > 0 else 1.0
    if coverage < 0.95:
        return _result(
            "prof", "fail",
            f"phase attribution covers {coverage * 100:.1f}% of "
            f"{span_s:.3f}s under the dispatcher lock (< 95%) — a "
            "phase bracket drifted out of Dispatcher._step_inner")
    locks = snap.get("locks", [])
    top = locks[0]["name"] if locks else "none"
    return _result(
        "prof", "ok",
        f"{addr}: {disp['spans']} step(s), phases cover "
        f"{coverage * 100:.1f}%, {len(locks)} tracked lock(s), "
        f"top contended: {top}")


def check_decisions(addr: str, timeout_s: float,
                    defaulted: bool = False) -> bool:
    """Decision-recorder probe (doc/replay.md): ``/decisions`` must
    answer with a live ring — the recorder is always on, so a missing
    or empty-capacity state on a current scheduler is a wiring
    regression, not a skip."""
    if not addr or addr == "none":
        return _result("decisions", "skip", "--scheduler none")
    try:
        state = json.loads(_get(f"http://{addr}/decisions", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("decisions", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("decisions", "skip",
                           "scheduler predates /decisions")
        return _result("decisions", "fail", f"{addr}: {exc}")
    if not state.get("attached") or not state.get("capacity"):
        return _result("decisions", "fail",
                       f"{addr}: decision recorder not attached — the "
                       "replay plane is wired in "
                       "SchedulerService.__init__, this is a regression")
    kinds = state.get("kinds", {})
    return _result(
        "decisions", "ok",
        f"{addr}: {state.get('seq', 0)} decision(s) recorded "
        f"({state.get('ring_len', 0)}/{state.get('capacity')} in ring, "
        f"{state.get('dropped', 0)} dropped, "
        f"{len(kinds)} kind(s))")


def check_ha(addr: str, timeout_s: float,
             defaulted: bool = False) -> bool:
    """Control-plane HA probe (doc/ha.md): ``/ha`` must answer; a
    scheduler outside any election is a skip (HA is opt-in via
    ``--ha-holder``). A participating scheduler fails when it claims
    the lease yet its dispatcher is frozen (a leader that cannot
    place), or when its registry's replication follower is out of sync
    beyond the advertised lag bound."""
    if not addr or addr == "none":
        return _result("ha", "skip", "--scheduler none")
    try:
        state = json.loads(_get(f"http://{addr}/ha", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            return _result("ha", "skip",
                           f"{addr} refused (no cluster on this host)")
        if "404" in str(exc):
            return _result("ha", "skip", "scheduler predates /ha")
        return _result("ha", "fail", f"{addr}: {exc}")
    if not state.get("attached"):
        return _result("ha", "skip",
                       "not in an election (start the scheduler with "
                       "--ha-holder to enable)")
    role = state.get("role", "?")
    epoch = state.get("epoch", 0)
    if role == "leader" and state.get("frozen"):
        return _result("ha", "fail",
                       f"{addr}: holds leader:scheduler at epoch "
                       f"{epoch} but the dispatcher is FROZEN "
                       f"({state.get('last_error') or 'fenced?'}) — a "
                       "leader that cannot place pods")
    repl = state.get("replication") or {}
    lag, bound = repl.get("lag_s"), repl.get("lag_bound_s")
    if (lag is not None and bound is not None
            and not repl.get("in_sync") and float(lag) > float(bound)):
        return _result("ha", "fail",
                       f"{addr}: replication {float(lag):.1f}s behind "
                       f"(bound {float(bound):.1f}s) — a takeover now "
                       "would lose that window")
    detail = (f"{addr}: {role} at epoch {epoch}, "
              f"{state.get('takeovers', 0)} takeover(s)")
    if lag is not None:
        detail += f", replication lag {float(lag):.1f}s"
    return _result("ha", "ok", detail)


def check_slo(addr: str, timeout_s: float,
              defaulted: bool = False) -> bool:
    """SLO-plane probe (doc/observability.md): ``/slo`` must answer and
    report no firing burn-rate alerts; ``/flightrecorder`` must answer
    with a live ring (capacity > 0) — the black box is always on, so an
    empty state is a wiring regression, not a skip."""
    if not addr or addr == "none":
        _result("slo", "skip", "--scheduler none")
        return _result("flightrecorder", "skip", "--scheduler none")
    try:
        state = json.loads(_get(f"http://{addr}/slo", timeout_s))
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            _result("slo", "skip",
                    f"{addr} refused (no cluster on this host)")
            return _result("flightrecorder", "skip", "no scheduler")
        if "404" in str(exc):
            _result("slo", "skip", "scheduler predates /slo")
            return _result("flightrecorder", "skip",
                           "scheduler predates /flightrecorder")
        _result("flightrecorder", "skip", "/slo unreachable")
        return _result("slo", "fail", f"{addr}: {exc}")
    tenants = state.get("tenants", {})
    firing = [(t, o["objective"]) for t, objs in tenants.items()
              for o in objs if o.get("firing")]
    if firing:
        ok = _result("slo", "fail",
                     f"{len(firing)} objective(s) FIRING: " +
                     ", ".join(f"{t}:{o}" for t, o in firing[:3]))
    else:
        n_obj = sum(len(objs) for objs in tenants.values())
        ok = _result("slo", "ok",
                     f"{addr}: {len(tenants)} tenant(s), {n_obj} "
                     "objective(s), none firing")
    try:
        rec = json.loads(_get(f"http://{addr}/flightrecorder", timeout_s))
    except Exception as exc:
        return _result("flightrecorder", "fail", f"{addr}: {exc}") and ok
    if not rec.get("capacity"):
        return _result("flightrecorder", "fail",
                       "recorder reports zero capacity — black box "
                       "disabled?") and ok
    return _result(
        "flightrecorder", "ok",
        f"ring {rec.get('ring_len', 0)}/{rec.get('capacity')} "
        f"entries, {len(rec.get('dumps', []))} retained dump(s), "
        f"{rec.get('dropped', 0)} dropped") and ok


def check_fleet(addr: str, timeout_s: float,
                defaulted: bool = False) -> bool:
    """Telemetry-plane probes (doc/observability.md): ``/query`` must
    evaluate a fleet aggregation registry-side, and every live pushing
    instance must be fresh — a newest sample older than two push
    intervals means that process's remote-writer is wedged. Freshness
    lag is a *warn* (passing): the TSDB marks the instance stale on
    its own at ``stale_after_s``, and already-stale instances are
    visibly retired rather than re-flagged here."""
    if not addr or addr == "none":
        _result("fleetquery", "skip", "--registry none")
        _result("pushfresh", "skip", "--registry none")
        return True
    from .telemetry.registry import RegistryClient
    from .telemetry.remote_write import DEFAULT_PUSH_PERIOD_S
    host, _, port = addr.partition(":")
    client = RegistryClient(host, int(port), timeout=timeout_s)
    try:
        res = client.query("kubeshare_remote_write_pushes_total",
                           agg="increase", window_s=60.0)
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            _result("fleetquery", "skip",
                    f"{addr} refused (no cluster on this host)")
            _result("pushfresh", "skip", "no registry")
            return True
        if "404" in str(exc):
            _result("fleetquery", "skip", "registry predates /query")
            _result("pushfresh", "skip", "registry predates /instances")
            return True
        _result("pushfresh", "skip", "/query unreachable")
        return _result("fleetquery", "fail", f"{addr}: {exc}")
    ok = _result("fleetquery", "ok",
                 f"{addr}: {res.get('series_matched', 0)} series matched, "
                 f"{len(res.get('groups', []))} group(s)")
    try:
        inst = client.instances()
    except Exception as exc:
        return _result("pushfresh", "fail", f"{addr}: {exc}") and ok
    instances = inst.get("instances", [])
    if not instances:
        _result("pushfresh", "skip",
                "no instance has remote-written yet (scheduler pushes "
                "by default; chipproxy --remote-write; launcherd "
                "--registry-host)")
        return ok
    limit = 2.0 * DEFAULT_PUSH_PERIOD_S
    lagging = [i for i in instances
               if not i.get("stale") and i.get("age_s", 0.0) > limit]
    retired = sum(1 for i in instances if i.get("stale"))
    if lagging:
        worst = max(lagging, key=lambda i: i.get("age_s", 0.0))
        return _result(
            "pushfresh", "warn",
            f"{len(lagging)} instance(s) past {limit:.0f}s (2 push "
            f"intervals); worst {worst['instance']} at "
            f"{worst['age_s']:.1f}s — remote-writer wedged?") and ok
    return _result(
        "pushfresh", "ok",
        f"{len(instances) - retired} instance(s) fresh (< {limit:.0f}s)"
        + (f", {retired} stale/retired" if retired else "")) and ok


def check_leases(addr: str, timeout_s: float, node: str,
                 defaulted: bool = False) -> bool:
    """Three health-plane probes against one ``/leases`` read: endpoint
    reachable, this node's lease fresh, clock skew < TTL/4."""
    import time

    if not addr or addr == "none":
        _result("leases", "skip", "--registry none")
        _result("heartbeat", "skip", "--registry none")
        _result("clockskew", "skip", "--registry none")
        return True
    from .telemetry.registry import RegistryClient
    host, _, port = addr.partition(":")
    local_now = time.time()
    try:
        body = RegistryClient(host, int(port), timeout=timeout_s).leases()
    except Exception as exc:
        if defaulted and _refused(exc) \
                and not os.environ.get("KUBERNETES_SERVICE_HOST"):
            _result("leases", "skip",
                    f"{addr} refused (no cluster on this host)")
            _result("heartbeat", "skip", "no registry")
            _result("clockskew", "skip", "no registry")
            return True
        _result("heartbeat", "skip", "lease endpoint unreachable")
        _result("clockskew", "skip", "lease endpoint unreachable")
        return _result("leases", "fail", f"{addr}: {exc}")
    leases = body.get("leases", {}) if isinstance(body, dict) else {}
    server_now = body.get("now") if isinstance(body, dict) else None
    ok = _result("leases", "ok",
                 f"{addr}: {len(leases)} lease(s) published")

    lease = leases.get(node)
    if lease is None:
        _result("heartbeat", "skip",
                f"no lease for this node ({node}) — heartbeater not "
                "running here")
    else:
        age, ttl = float(lease.get("age_s", 0.0)), \
            float(lease.get("ttl_s", C.LEASE_TTL_S))
        if age < ttl:
            ok &= _result("heartbeat", "ok",
                          f"{node}: lease age {age:.1f}s < ttl {ttl:.0f}s "
                          f"(epoch {lease.get('epoch')})")
        else:
            ok &= _result("heartbeat", "fail",
                          f"{node}: lease STALE ({age:.1f}s >= ttl "
                          f"{ttl:.0f}s) — the healthwatch will evict "
                          "this node")

    if server_now is None:
        _result("clockskew", "skip", "registry predates /leases 'now'")
    else:
        ttl = (float(leases[node]["ttl_s"]) if node in leases
               else C.LEASE_TTL_S)
        skew = abs(local_now - float(server_now))
        limit = ttl / 4.0
        if skew < limit:
            ok &= _result("clockskew", "ok",
                          f"|local - registry| = {skew:.2f}s < ttl/4 "
                          f"({limit:.2f}s)")
        else:
            ok &= _result("clockskew", "fail",
                          f"|local - registry| = {skew:.2f}s >= ttl/4 "
                          f"({limit:.2f}s) — fix NTP before trusting "
                          "cross-host timestamps")
    return ok


def check_node_files(base_dir: str) -> bool:
    cfg = os.path.join(base_dir, "config")
    if not os.path.isdir(base_dir):
        return _result("nodefiles", "skip", f"{base_dir} absent (no node "
                       "agent on this host)")
    if not os.path.isdir(cfg):
        # Base dir without config/ = a node agent that died mid-setup —
        # the exact broken state this check exists to surface.
        return _result("nodefiles", "fail",
                       f"{base_dir} exists but has no config/ directory")
    return _result("nodefiles", "ok",
                   f"{base_dir}: {len(os.listdir(cfg))} per-chip client "
                   "file(s)")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="kubeshare_tpu_torch.doctor",
                                     description=__doc__)
    parser.add_argument(
        "--registry",
        default=os.environ.get("KUBESHARE_TPU_REGISTRY", ""),
        help="registry host:port; defaults to the deploy manifest's "
             "service (or localhost); 'none' to skip")
    parser.add_argument(
        "--scheduler",
        default=os.environ.get("KUBESHARE_TPU_SCHEDULER", ""),
        help="scheduler service host:port; defaults to the deploy "
             "manifest's service (or localhost); 'none' to skip")
    parser.add_argument("--base-dir", default=C.SCHEDULER_DIR)
    parser.add_argument("--chip-timeout", type=float, default=45.0)
    parser.add_argument("--skip-chip", action="store_true",
                        help="don't touch the card (e.g. while the "
                             "isolation runtime owns it)")
    args = parser.parse_args(argv)
    # Defaulted addresses downgrade connection-refused to "skip" on a
    # non-Kubernetes host (a zero-flag dev-box run must keep exiting 0 —
    # the dev-box contract); explicit flags always fail loudly.
    reg_defaulted = not args.registry
    sched_defaulted = not args.scheduler
    registry = args.registry or _default_addr("kubeshare-tpu-registry",
                                              C.REGISTRY_PORT)
    scheduler = args.scheduler or _default_addr("kubeshare-tpu-scheduler",
                                                C.SCHEDULER_PORT)

    ok = True
    chip_ok = False
    if args.skip_chip:
        _result("chip", "skip", "--skip-chip")
    else:
        chip_ok = check_chip(args.chip_timeout)
        ok &= chip_ok
    ok &= check_discovery(chip_ok, args.chip_timeout)
    ok &= check_registry(registry, 5.0, defaulted=reg_defaulted)
    ok &= check_fleet(registry, 5.0, defaulted=reg_defaulted)
    ok &= check_scheduler(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_autopilot(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_rightsize(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_elastic(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_serving(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_slo(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_invariants(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_gangs(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_ledger(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_preempt(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_prof(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_decisions(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_ha(scheduler, 5.0, defaulted=sched_defaulted)
    ok &= check_node_files(args.base_dir)
    from .utils import default_node_name
    ok &= check_leases(registry, 5.0, default_node_name(),
                       defaulted=reg_defaulted)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
