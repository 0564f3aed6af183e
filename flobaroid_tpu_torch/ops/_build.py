"""Build and load the port's native libraries.

Each `csrc/<name>.cu` exposes a plain C interface; it is compiled with
nvcc for Hopper (sm_90a) into `build/flobaroid_tpu_torch/lib<name>.so`
under the repository root at first use, and loaded with ctypes. Host
libraries (the triangle-mesh distance library of `native/`) are compiled
the same way with g++. A stamp file next to each library holds the hash
of the source and the flags, so an edited source is rebuilt. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "flobaroid_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc output per library (ptxas register/smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _compile(name: str, src: pathlib.Path, compiler, flags: list[str]) -> pathlib.Path:
    """Compile src into build/flobaroid_tpu_torch/lib<name>.so unless an
    up-to-date build exists; `compiler` is called only for a build.
    Raises on any compiler error."""
    lib = BUILD_DIR / f"lib{name}.so"
    stamp = BUILD_DIR / f"lib{name}.stamp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
    cmd = [compiler(), *flags, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[name] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed for {src}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def build_library(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu with nvcc (see `_compile`)."""
    return _compile(name, CSRC / f"{name}.cu", _nvcc, NVCC_FLAGS)


def build_host_library(name: str, src: pathlib.Path) -> pathlib.Path:
    """Compile the C++ source src with g++ (see `_compile`)."""
    def gxx() -> str:
        found = shutil.which("g++")
        if not found:
            raise RuntimeError("g++ not found: the host library needs a C++ compiler to build")
        return found

    return _compile(name, src, gxx, GXX_FLAGS)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (cached per process)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name)))
        _loaded[name] = lib
    return lib
