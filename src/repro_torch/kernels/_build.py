"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

in ``build/`` beside this file (listed in ``.gitignore``). ``<hash>``
covers the source, the headers in ``csrc/`` and the flags, so an edited
source is rebuilt and never mistaken for an old library. All missing
libraries are built at once, one ``nvcc`` process per source, started
together. A failed build raises with the compiler's output; nothing
falls back to another path. ``ptxas`` register and spill counts are
kept in ``build/<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["BUILD_DIR", "CSRC", "build_all", "check", "load", "nvcc_path"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (searched PATH and $CUDA_HOME/bin); the port's "
            "CUDA kernels are built from csrc/ on the machine with the card"
        )
    return path


def _sources() -> dict[str, str]:
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    }


def _lib_path(name: str, src: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{name: library path}``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    libs, procs = {}, {}
    for name, src in _sources().items():
        lib = _lib_path(name, src)
        libs[name] = lib
        if os.path.isfile(lib):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                [nvcc, *FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        with open(os.path.splitext(libs[name])[0] + ".log", "w") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            libs = build_all()
            if name not in libs:
                raise RuntimeError(f"no kernel source csrc/{name}.cu")
            lib = ctypes.CDLL(libs[name])
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
