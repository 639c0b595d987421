"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
``ctypes``. Nothing here includes PyTorch's headers, so a build takes
seconds rather than minutes.

Libraries are built at first use into ``kubeshare_tpu_torch/_build/`` (an
ignored directory) and rebuilt when their source, or a source it
includes, is newer. Nothing is built at import: the CPU tests import every
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

#: IEEE division and square root (no --use_fast_math), and no contraction
#: of a*b+c into one FMA, so the kernels round exactly where their plain
#: PyTorch versions round, operation by operation.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "CUDA kernels are built on the machine with "
                           "the card")
    return path


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(SRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _sources(src: str) -> list[str]:
    """``src`` and the files of ``csrc/`` it includes (``#include
    "..."``; one level: flash_attention_wide.cu and
    flash_attention_256.cu include flash_attention.cu,
    flash_backward_wide.cuh and flash_forward_wide.cuh)."""
    with open(src) as f:
        names = re.findall(r'^#include "([^"]+)"', f.read(), re.M)
    return [src] + [os.path.join(SRC_DIR, n) for n in names]


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < max(map(os.path.getmtime,
                                               _sources(src))))


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into its library. Returns the compiler
    output (the ptxas register/spill report)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    src, lib = _paths(name)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                           f"{proc.returncode}\n{proc.stdout}")
    # atomic publish: a concurrent loader never sees half a file
    os.replace(tmp, lib)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build(name)
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
    return lib


def libraries() -> list[str]:
    """Every library of ``csrc/``: one a ``.cu`` (a ``.cuh`` is included
    by them)."""
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


def main() -> None:
    """``python -m kubeshare_tpu_torch.ops.build``: build every library,
    one ``nvcc`` each, all at once, and print each one's ptxas report.
    Needs ``nvcc`` and no card: an image builds its kernels here so that
    its pods do not at first use."""
    from concurrent.futures import ThreadPoolExecutor

    names = libraries()
    with ThreadPoolExecutor(len(names)) as pool:
        for name, report in zip(names, pool.map(build, names)):
            print(f"== {name}: {_paths(name)[1]}\n{report}", flush=True)


if __name__ == "__main__":
    main()
