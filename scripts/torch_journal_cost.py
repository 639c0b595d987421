#!/usr/bin/env python3
"""What the chip proxy's session journal costs one step of the full-width
LM, taken apart, on the card.

    python3 scripts/torch_journal_cost.py [--rounds 3] [--dir D]

After an in-place train step the proxy journals every tensor the step
changed — the LM's parameters and both Adam moments, 139 tensors, 63.9 MB
— each to a sidecar of its own (``resilience/journal.py``: a tmp file,
``np.save``, fsync, rename). This times, per round, on the LM's tensors
on the card: the device → host copies (the proxy's ``_to_host``), the
journal's own writes (``SessionJournal.save_buffer``), the same ``.npy``
writes without fsync, and all the tensors in one ``.npz`` with one fsync.
The sidecars go under ``--dir`` (default: a temporary directory, where
``chip_smoke.py`` 5g keeps its journal). Prints one JSON line per round
and the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_journal_cost.py")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--dir", default=None,
                        help="where the sidecars go (a temporary "
                             "directory by default)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_journal_cost: no CUDA device; this script runs on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from kubeshare_tpu_torch.isolation.proxy import _to_host
    from kubeshare_tpu_torch.models import common, transformer
    from kubeshare_tpu_torch.ops.fused_adam import fused_adam
    from kubeshare_tpu_torch.resilience.journal import SessionJournal
    from kubeshare_tpu_torch.utils.tree import tree_leaves

    dev = torch.device("cuda")
    params = common.to_device(transformer.init(0), dev)
    tensors = tree_leaves((params, fused_adam(1e-3).init(params)))
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    token = "0" * 32
    for r in range(args.rounds):
        root = tempfile.mkdtemp(prefix="kubeshare-journal-cost-",
                                dir=args.dir)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hosts = [_to_host(t) for t in tensors]
            copy_ms = _ms(t0)
            journal = SessionJournal(os.path.join(root, "journal"))
            t0 = time.perf_counter()
            for gen, arr in enumerate(hosts):
                journal.save_buffer(token, gen, arr)
            journal_ms = _ms(t0)
            plain = os.path.join(root, "plain")
            os.makedirs(plain)
            t0 = time.perf_counter()
            for gen, arr in enumerate(hosts):
                with open(os.path.join(plain, f"{gen}.npy"), "wb") as f:
                    np.save(f, arr, allow_pickle=False)
            unsynced_ms = _ms(t0)
            t0 = time.perf_counter()
            with open(os.path.join(root, "one.npz"), "wb") as f:
                np.savez(f, *hosts)
                f.flush()
                os.fsync(f.fileno())
            one_file_ms = _ms(t0)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps({
            "round": r, "tensors": len(tensors), "bytes": nbytes,
            "device_to_host_ms": copy_ms,
            "journal_save_buffer_ms": journal_ms,
            "npy_unsynced_ms": unsynced_ms,
            "one_npz_one_fsync_ms": one_file_ms}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
