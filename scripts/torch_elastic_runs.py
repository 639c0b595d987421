#!/usr/bin/env python3
"""Phase 5l of ``chip_smoke.py`` on one card, alone.

    python3 scripts/torch_elastic_runs.py [--out result.json]

Needs one CUDA card and runs from anywhere in a checkout. It builds the
kernels, then runs ``chip_smoke.quota_phase`` (a proxy with the native
token scheduler and an ``ElasticQuota``: an idle lender's headroom lent to
a borrower pinned at its limit, both training the full-width flash LM, and
revoked inside the lender's next demand; then 5l-rightsize on the same
proxy and clients: a ``Rightsizer`` grows the borrower, which misses its
step-time objective, and shrinks the lender, now holding its grants
idle, through the card's scheduler) and ``chip_smoke.elastic_phase``
(four gloo ranks on the card: the flash LM resized 2 -> 4 -> 1 ranks
mid-run by an ``ElasticOrchestrator``, held to the unresized run, then a
checkpoint restate onto one rank). Every check is the smoke's. Prints one
JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_elastic_runs.py")
    parser.add_argument("--out", default="",
                        help="also write the result here (JSON)")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_elastic_runs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubeshare_tpu_torch.models import transformer
    from kubeshare_tpu_torch.ops import fused_adam as fa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"card: {card}")
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(cs._timed_build, cs.KERNELS))
    adam = fa.tree_launches(transformer.init(0))
    result = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    result["quota"] = cs.quota_phase(torch.device("cuda", 0), adam,
                                     transformer.LAYERS)
    result["rightsize"] = result["quota"].pop("rightsize")
    cs.log(f"5l-quota: {json.dumps(result['quota'], default=str)}")
    cs.log(f"5l-rightsize: {json.dumps(result['rightsize'], default=str)}")
    result["elastic"] = cs.elastic_phase(ROOT, adam, transformer.LAYERS)
    cs.log(f"5l-elastic: {json.dumps(result['elastic'], default=str)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1, default=str)
    print(json.dumps(result, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
