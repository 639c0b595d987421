"""Host C++ of the isolation runtime, built with ``g++`` at first use.

``<name>.cpp`` here is compiled into ``kubeshare_tpu_torch/_build/
lib<name>.so`` (an ignored directory, shared with the kernels of
:mod:`kubeshare_tpu_torch.ops.build`), rebuilt when its source is newer,
and loaded with ``ctypes`` over a plain C interface. Nothing is built at
import.

Unlike the JAX package's builder (``kubeshare_tpu/isolation/native``),
which falls back to Python quietly when ``g++`` fails, a failed build
raises with the compiler's output: the Python core is had only by asking
for it (``native=False``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(_HERE, f"{name}.cpp"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def build(name: str) -> None:
    """Compile ``<name>.cpp`` into its library; raise with the compiler's
    output when it fails."""
    src, lib = _paths(name)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"native build of {name} failed: g++ not found "
                           f"(ask for the Python core with native=False)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build of {name} failed: g++ exit "
                           f"{proc.returncode}\n{proc.stdout}")
    # atomic publish: a concurrent loader never sees half a file
    os.replace(tmp, lib)


def load_library(name: str) -> ctypes.CDLL:
    """The library of ``<name>.cpp``, built first if missing or stale."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src, path = _paths(name)
            if (not os.path.exists(path)
                    or os.path.getmtime(path) < os.path.getmtime(src)):
                build(name)
            lib = ctypes.CDLL(path)
            _libs[name] = lib
    return lib
