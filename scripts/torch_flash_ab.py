#!/usr/bin/env python3
"""The bf16 flash forward at head dims 64 and 128 of this checkout against
other checkouts', on one card, in turns.

    python3 scripts/torch_flash_ab.py --other DIR [--other DIR ...]
                                      [--rounds 2] [--out f.json]

Each ``DIR`` is another checkout of the repository (its
``kubeshare_tpu_torch/csrc`` is all that is read), for example the parent
commit unpacked with ``git archive`` into an ignored directory. Each
checkout's wide library (``csrc/flash_attention_wide.cu``) is built by
``nvcc`` with ``ops/build.py``'s flags into a directory of its own (the
builds run together) and loaded with ``ctypes``; every forward is called
through its C entry point ``kst_flash_fwd``, with the same arguments, on
the same inputs. At each shape (the LM's (8, 256, 8, 64) and
(8, 256, 8, 128), and (1, 8192, 8, 128); bf16, causal) each is first
held to the plain forward at ``KERNEL_TOL``, then timed as
``chip_smoke.cuda_time_ms`` times a kernel (the L2 cache flushed before
each call) in turns: the others, this, this, the others in reverse,
``--rounds`` times; then the host's time of one call of the entry point
(``chip_smoke.host_time_ms``: what the C side adds, such as encoding
tensor maps, without the op's Python). Prints the card, each time, and
one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 256, 8, 64), (8, 256, 8, 128), (1, 8192, 8, 128))


def build_wide(checkout: str, out_dir: str) -> str:
    """The wide library of ``checkout``, built into ``out_dir``."""
    from kubeshare_tpu_torch.ops import build

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libflash_attention_wide.so")
    src = os.path.join(checkout, "kubeshare_tpu_torch", "csrc",
                       "flash_attention_wide.cu")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
                           src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {checkout}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib


def forward(lib: ctypes.CDLL):
    """``fwd(q, k, v, o, lse)``: the library's forward, bf16 causal, on
    the current stream; raises on a nonzero return."""
    import torch

    fn = lib.kst_flash_fwd
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.restype = i32
    fn.argtypes = [ptr] * 5 + [ptr, i32] + [i32] * 8 + [ctypes.c_float, ptr]

    def fwd(q, k, v, o, lse):
        b, s, h, d = q.shape
        strides = [st for x in (q, k, v) for st in x.stride()[:3]] + [0] * 3
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), (ctypes.c_longlong * 12)(*strides), 1, b, h,
                k.shape[2], s, k.shape[1], d, 1, 0, 1.0 / math.sqrt(d),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"kst_flash_fwd returned {rc}")
    return fwd


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="torch_flash_ab.py")
    parser.add_argument("--other", required=True, action="append",
                        help="another checkout's root (repeatable)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from kubeshare_tpu_torch.ops import flash_attention as fl

    card = cs.card_line()
    cs.log(f"card: {card}")
    others = [os.path.abspath(d) for d in args.other]
    roots = {f"other{i}": d for i, d in enumerate(others)}
    roots["this"] = ROOT
    from kubeshare_tpu_torch.ops import build

    out_dirs = {name: os.path.join(build.BUILD_DIR, "ab", name)
                for name in roots}
    for name, d in roots.items():
        cs.log(f"{name}: {d}")
    with ThreadPoolExecutor(len(roots)) as pool:
        libs = dict(zip(roots, pool.map(build_wide, roots.values(),
                                        out_dirs.values())))
    fwds = {name: forward(ctypes.CDLL(path)) for name, path in libs.items()}
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    atol, rtol = fl.KERNEL_TOL[torch.float32]
    result: dict = {"card": card, "checkouts": roots, "shapes": {}}
    for shape in SHAPES:
        b, s, h, d = shape
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            "float32")).to(dev, torch.bfloat16) for _ in range(3))
        ro, rlse = fl.flash_fwd_reference(q, k, v, True, None,
                                          1.0 / math.sqrt(d))
        o = torch.empty(shape, dtype=torch.float32, device=dev)
        lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
        for name, fwd in fwds.items():
            fwd(q, k, v, o, lse)
            torch.cuda.synchronize()
            for got, want in ((o, ro), (lse, rlse)):
                err = (got - want).abs()
                cs.check(bool((err <= atol + rtol * want.abs()).all()),
                         f"{name} forward at {shape} disagrees with the "
                         f"plain one: max abs err {float(err.max())}")
        del ro, rlse
        iters = 5 if s > 1024 else 50
        runs: dict = {name: [] for name in roots}
        names = [n for n in roots if n != "this"]
        for _ in range(args.rounds):
            for name in names + ["this", "this"] + names[::-1]:
                runs[name].append(cs.cuda_time_ms(
                    lambda f=fwds[name]: f(q, k, v, o, lse), iters, flush))
        host = {name: cs.host_time_ms(
            lambda f=fwds[name]: f(q, k, v, o, lse), 4 * iters)
            for name in roots}
        result["shapes"][str(shape)] = {
            "runs_ms": runs,
            "min_ms": {name: min(x) for name, x in runs.items()},
            "host_ms": host}
        cs.log(f"forward at {shape} bf16 causal: " + "; ".join(
            f"{name} " + ", ".join(f"{x:.5f}" for x in runs[name]) + " ms"
            for name in roots) + "; host ms a call " + ", ".join(
            f"{name} {x:.4f}" for name, x in host.items()))
    cs.log(f"card: {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
