#!/usr/bin/env python3
"""Repeated uneven gate pairs on one card: how the tenants' start-up,
which their first step holds the token through, moves the pair's shares.

    python3 scripts/torch_gate_startup.py [--order plain,cuda-first,...]
        [--ahead] [--busy N] [--records DIR] [--out result.json]

Needs one CUDA card and runs from anywhere in a checkout. It builds the
kernels, then drives ``chip_smoke.py``'s node path (phase 5e) and runs its
uneven pair (requests 0.25 and 0.75, limit 1.0 each) once for each entry
of ``--order``: ``plain`` runs ``chip_smoke.py``'s own tenants;
``cuda-first`` runs tenants that set up CUDA's context and cuBLAS before
their first aten op, the first one the gate meters, and then train as
``chip_smoke.py``'s do (this script's ``--tenant`` mode). With ``--ahead``
each round's tenants are started ahead of it and go together once both
are ready, as phase 5e starts them; ``--busy N`` keeps N processes
spinning on the host's cores through the rounds (a loaded host).
``--records DIR`` writes each round's tenant records there. The two
tenants train ``chip_smoke.py``'s GATE_PAIR_S past the later warm-up of
the two, as 5e's pairs do.

For each round it reports each tenant's first step: the ms it held the
token and its wall seconds from the process's start; the first tenant's
share of the token held over its life, of the token held in the common
window and of the window's steps; the start-up debt still owed at the
window's start (the scheduler's virtual times, held ms over request, read
from the tenants' gate totals: the ms the second tenant must hold before
the first one is granted again by stride alone); the first tenant's share
of the token in each half of the window; the most the second tenant was
charged in one accounting window by the scheduler's ``usage`` op (its
cap is the whole window); and whether phase 5e's check passes.
Prints one JSON object as its last line and exits 1 if a round failed
the check.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("plain", "cuda-first")


def cuda_first_tenant(out: str, seconds: float, seed: int,
                      go: str = "") -> int:
    """``chip_smoke.tenant`` after CUDA's context and cuBLAS are set up,
    none of which dispatches an aten op; the seconds it took go into the
    record as ``cuda_setup_s``. ``go`` as ``chip_smoke.tenant`` takes it."""
    t0 = time.monotonic()
    import torch

    torch.cuda.init()
    torch.cuda.synchronize()
    torch.cuda.current_blas_handle()
    setup_s = time.monotonic() - t0
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    rc = cs.tenant(out, seconds, seed, False, go=go)
    with open(out) as f:
        rec = json.load(f)
    rec["cuda_setup_s"] = setup_s
    with open(out, "w") as f:
        json.dump(rec, f)
    return rc


def _held_at(cs, rec: dict, t: float) -> float:
    """A tenant's lifetime held ms by its gate at its last step end at or
    before ``t`` (0 before its first)."""
    i = sum(1 for e in rec["ends"] if e <= t) - 1
    return rec["gate"][i][cs.GATE_TOTALS.index("charged_ms")] if i >= 0 \
        else 0.0


def _busy() -> None:
    while True:
        pass


def round_reading(cs, pair: dict, entries) -> dict:
    reading = cs.pair_reading(pair, entries)
    charged = cs.GATE_TOTALS.index("charged_ms")
    start = max(r["ends"][cs._warm(r)] for r in pair.values())
    end = min(r["ends"][-1] for r in pair.values())
    (a, _, req_a), (b, _, req_b) = entries
    # both tenants joined the scheduler at one virtual time
    debt = req_b * (_held_at(cs, pair[a], start) / req_a
                    - _held_at(cs, pair[b], start) / req_b)
    mid = (start + end) / 2
    halves = []
    for t0, t1 in ((start, mid), (mid, end)):
        got = {n: _held_at(cs, pair[n], t1) - _held_at(cs, pair[n], t0)
               for n in (a, b)}
        halves.append(got[a] / (got[a] + got[b]))
    try:
        cs.check_pair("uneven", reading)
        passed = True
    except SystemExit:
        passed = False
    return {
        "first_step_held_ms": reading["first_step_held_ms"],
        "first_step_wall_s": {n: r["ends"][0] - r["started"]
                              for n, r in pair.items()},
        "cuda_setup_s": {n: r.get("cuda_setup_s") for n, r in pair.items()},
        "held_ms_to_window_end": {
            n: r["gate"][sum(1 for t in r["ends"] if t <= end) - 1][charged]
            for n, r in pair.items()},
        "lifetime_held_share_a": reading["lifetime_held_share_a"],
        "gate_held_share_a": reading["gate_held_share_a"],
        "share_a": reading["share_a"],
        "window_s": reading["window_s"],
        "debt_ms_at_window_start": debt,
        "gate_held_share_a_by_half": halves,
        "max_charged_ms_per_window_b": max(
            (u for _, u in pair[b]["usage"]), default=float("nan")),
        "passed": passed,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_gate_startup.py")
    parser.add_argument("--order",
                        default="plain,cuda-first,plain,cuda-first",
                        help="the rounds' tenants, comma-separated: "
                             + " or ".join(VARIANTS))
    parser.add_argument("--ahead", action="store_true",
                        help="start each round's tenants ahead of it and "
                             "let them go together, as phase 5e does")
    parser.add_argument("--busy", type=int, default=0,
                        help="processes spinning on the host's cores "
                             "through the rounds")
    parser.add_argument("--records", default="",
                        help="write each round's tenant records here")
    parser.add_argument("--out", default="",
                        help="also write the result here (JSON)")
    parser.add_argument("--tenant", default="", help=argparse.SUPPRESS)
    parser.add_argument("--seconds", type=float, default=0.0,
                        help=argparse.SUPPRESS)
    parser.add_argument("--seed", type=int, default=0,
                        help=argparse.SUPPRESS)
    parser.add_argument("--go", default="", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.tenant:
        return cuda_first_tenant(args.tenant, args.seconds, args.seed,
                                 args.go)
    order = args.order.split(",")
    if any(v not in VARIANTS for v in order):
        parser.error(f"--order takes {' and '.join(VARIANTS)}")

    import torch

    if not torch.cuda.is_available():
        print("torch_gate_startup: no CUDA device", file=sys.stderr)
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
    adam_per_step = fa.tree_launches(transformer.init(0))
    entries = cs.GATE_PAIRS["uneven"]
    node = cs._Node(ROOT)
    smoke_file = cs.__file__
    rounds = []
    busy = []
    t0 = time.perf_counter()
    try:
        cs.log(f"gate: proxy {node.start()}")
        ctx = multiprocessing.get_context("spawn")
        for _ in range(args.busy):
            busy.append(ctx.Process(target=_busy, daemon=True))
            busy[-1].start()
        for i, variant in enumerate(order):
            # _Node.spawn starts each tenant as ``<cs.__file__> --tenant``
            cs.__file__ = (os.path.abspath(__file__)
                           if variant == "cuda-first" else smoke_file)
            # the tenants write their record, ``.ready`` and ``.warm``
            # beside it under the node's dir: a round's are gone before
            # the next one's tenants start, which take the same names
            for n, *_ in entries:
                out = os.path.join(node.base, n.replace("/", "_") + ".json")
                for path in (out, out + ".ready", out + ".warm"):
                    if os.path.exists(path):
                        os.remove(path)
            try:
                ports = node.clients([(n, req) for n, _, req in entries])
                run = node.spawn([(n, seed, ports[n], req)
                                  for n, seed, req in entries],
                                 cs.GATE_PAIR_S, True, meet=True,
                                 go=(os.path.join(node.base, f"go-{i}")
                                     if args.ahead else ""))
            finally:
                cs.__file__ = smoke_file
            if args.ahead:
                cs._wait_ready_runs([run])
            pair = node.collect(run)
            if args.records:
                os.makedirs(args.records, exist_ok=True)
                with open(os.path.join(args.records, f"round-{i}.json"),
                          "w") as f:
                    json.dump(pair, f)
            for name, rec in pair.items():
                cs._check_tenant(name, rec, True, adam_per_step,
                                 transformer.LAYERS)
            got = dict(variant=variant, **round_reading(cs, pair, entries))
            rounds.append(got)
            cs.log(f"round {len(rounds) - 1}: {json.dumps(got)}")
    finally:
        for p in busy:
            p.kill()
        node.stop()
    result = {"card": card, "ahead": args.ahead, "busy": args.busy,
              "rounds": rounds,
              "seconds": time.perf_counter() - t0}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    cs.log(f"card: {card}")
    print(json.dumps(result), flush=True)
    return 0 if all(r["passed"] for r in rounds) else 1


if __name__ == "__main__":
    sys.exit(main())
