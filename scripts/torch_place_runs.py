#!/usr/bin/env python3
"""Phase 5i of ``chip_smoke.py`` on one card, alone or taken apart.

    python3 scripts/torch_place_runs.py [--mem-ab] [--out result.json]

Needs one CUDA card and runs from anywhere in a checkout. It builds the
kernels, then:

- by default, runs ``chip_smoke.place_phase`` once — the port's registry,
  collector, configd, scheduler service, pod-event bridge and admission
  webhook as processes beside a fake kube-apiserver, the service over the
  card's node and 63 fake ones with 2,000 background pods, two labels-only
  0.5 LM pods bound to the card through the webhook, the apiserver and
  the bridge and run as gate-mode tenants with the env of their pod
  objects, a delete, the node's death and a fresh collector's stop —
  and prints its numbers (every check as the smoke's);
- with ``--mem-ab``, runs 5i's tenant pair through phase 5e's node path
  without and with the memory grant (``KUBESHARE_TPU_MEM``, 20 GiB) in
  the tenants' env, with the registry, collector and configd down or up
  (``+daemons``), in the order of MEM_AB_ORDER, which gives each variant
  a turn early and late; each pair trains 10 s past warm-up and is read
  as 5e reads a pair. It separates what the memory grant costs a gated
  tenant from what the daemons beside it do.

Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEM_AB_ORDER = ("plain", "mem", "plain+daemons", "mem+daemons",
                "mem+daemons", "plain+daemons", "mem", "plain")
MEM_AB_SECONDS = 10.0


def mem_ab(cs, root: str) -> list:
    """The memory-grant A/B (see the module docstring): one row a pair."""
    from kubeshare_tpu_torch import constants as C

    node = cs._Node(root)
    rows, daemons = [], {}

    def pair(variant: str) -> None:
        names = [(f"ab/{variant}-{len(rows)}-{s}", seed)
                 for s, seed in (("a", 10), ("b", 11))]
        ports = node.clients([(n, cs.PLACE_REQUEST) for n, _ in names])
        envs = {}
        for n, _ in names:
            envs[n] = {C.ENV_POD_MANAGER_PORT: str(ports[n]),
                       C.ENV_POD_NAME: n,
                       C.ENV_TPU_REQUEST: str(cs.PLACE_REQUEST),
                       C.ENV_TPU_LIMIT: "1.0",
                       C.ENV_VISIBLE_CHIPS: node.chip.chip_id}
            if variant.startswith("mem"):
                envs[n][C.ENV_TPU_MEMORY] = str(cs.PLACE_MEM)
        recs = node.run([(n, seed, ports[n], cs.PLACE_REQUEST)
                         for n, seed in names], MEM_AB_SECONDS, True,
                        pod_envs=envs)
        reading = cs.pair_reading(recs, [(n, seed, cs.PLACE_REQUEST)
                                         for n, seed in names])
        cs.check_pair(variant, reading)
        row = {"variant": variant,
               "steps_per_sec": list(reading["steps_per_sec"].values()),
               "aggregate_steps_per_sec": reading["aggregate_steps_per_sec"],
               "window_s": reading["window_s"],
               "lifetime_held_share_a": reading["lifetime_held_share_a"],
               "charged_ms_per_step": [g["charged_ms"] for g in
                                       reading["gate_per_step"].values()]}
        cs.log(f"mem-ab: {json.dumps(row)}")
        rows.append(row)

    def set_daemons(up: bool) -> None:
        if up and not daemons:
            daemons["registry"] = cs._start_daemon(
                root, node.base, "registry", [
                    "kubeshare_tpu_torch.telemetry.registry", "--host",
                    "127.0.0.1", "--port", "0"])
            port = int(cs._wait_ready(daemons["registry"][1],
                                      "the registry").split()[1])
            args = ["--registry-port", str(port), "--node", node.chip.host,
                    "--backend", "cuda"]
            daemons["collector"] = cs._start_daemon(
                root, node.base, "collector", [
                    "kubeshare_tpu_torch.telemetry.collector", *args])
            daemons["configd"] = cs._start_daemon(
                root, node.base, "configd", [
                    "kubeshare_tpu_torch.nodeagent.configd", *args,
                    "--base-dir", os.path.join(node.base, "configd"),
                    "--period", "0.1"])
            for label in ("collector", "configd"):
                cs._wait_ready(daemons[label][1], f"the {label}")
        elif not up:
            for label in ("collector", "configd", "registry"):
                if label in daemons:
                    proc, log_path = daemons.pop(label)
                    cs._stop_daemon(proc, label, log_path)

    try:
        node.start()
        for variant in MEM_AB_ORDER:
            set_daemons(variant.endswith("+daemons"))
            pair(variant)
        set_daemons(False)
    finally:
        for proc, _ in daemons.values():
            proc.kill()
            proc.wait()
        node.stop()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_place_runs.py")
    parser.add_argument("--mem-ab", action="store_true",
                        help="the memory-grant A/B instead of phase 5i")
    parser.add_argument("--out", default="",
                        help="also write the result here (JSON)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_place_runs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubeshare_tpu_torch.models import transformer
    from kubeshare_tpu_torch.ops import fused_adam as fa

    card = cs.card_line()
    cs.log(f"card: {card}")
    # the tenants' first launches must not race two builds of one library
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(cs._timed_build, cs.KERNELS))
    if args.mem_ab:
        result = {"card": card, "mem_ab": mem_ab(cs, ROOT)}
    else:
        result = {"card": card, "placement": cs.place_phase(
            ROOT, fa.tree_launches(transformer.init(0)),
            transformer.LAYERS)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
