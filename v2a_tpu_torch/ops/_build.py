"""Builds the hand-written CUDA kernels in `v2a_tpu_torch/csrc/` and loads
them with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface (`_build/lib<name>-<hash>.so`; the hash
covers the source and the shared headers, so an edited source rebuilds).
Nothing is built at import: the first launch of a kernel builds it, and
`build_all()` builds every source at once, one `nvcc` process per source,
all started together.

The host-side C++ in `v2a_tpu_torch/native/` (the replay buffers' episode
store) builds the same way with g++ (`load_host`), into the same directory,
keyed by the same kind of hash.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NATIVE = os.path.join(os.path.dirname(CSRC), "native")
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc's -Xptxas -v report) of builds done in this process
build_log: Dict[str, tuple] = {}


def sources() -> List[str]:
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC, "*.cu"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for p in [os.path.join(CSRC, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    ):
        with open(p, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Starts nvcc for one source; returns (process, tmp path, out path, t0)
    or None when the library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + [
        "-I", CSRC, "-o", tmp, os.path.join(CSRC, name + ".cu"),
    ]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    build_log[name] = (time.perf_counter() - t0, log)


def build_all() -> Dict[str, tuple]:
    """Compiles every `csrc/*.cu` in parallel; returns `build_log`."""
    with _lock:
        started = {n: _start(n) for n in sources()}
        for n, st in started.items():
            if st is not None:
                _finish(n, st)
    return build_log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            st = _start(name)
            if st is not None:
                _finish(name, st)
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def _host_lib_path(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(NATIVE, name + ".cpp"), "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(HOST_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for `v2a_tpu_torch/native/<name>.cpp`, built with
    g++ on first use; raises with the compiler's output when the build
    fails."""
    with _lock:
        lib = _libs.get("host:" + name)
        if lib is None:
            out = _host_lib_path(name)
            src = os.path.join(NATIVE, name + ".cpp")
            if not os.path.exists(out):
                cxx = shutil.which("g++") or shutil.which("c++")
                if cxx is None:
                    raise RuntimeError(f"no C++ compiler (g++) to build {src}")
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [cxx] + HOST_FLAGS + ["-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {src}:\n{proc.stdout}")
                os.replace(tmp, out)
                build_log[name] = (time.perf_counter() - t0, proc.stdout)
            lib = ctypes.CDLL(out)
            _libs["host:" + name] = lib
        return lib
