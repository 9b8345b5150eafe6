"""Build the port's CUDA kernel with nvcc and load it with ctypes.

`ops/csrc/blocked_attn_fwd.cu` compiles into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The library goes to `build/kernels/` beside the package (a directory that
.gitignore lists), named by a hash of its source, so an edited source is
rebuilt at its next use and a stale library is never loaded. The build
happens at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                       "blocked_attn_fwd.cu")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    path: str        # the shared library
    seconds: float   # wall time of the nvcc run, 0.0 if it was built before
    log: str         # nvcc's output (ptxas registers / shared memory)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernel")


def build() -> Built:
    """Compile `blocked_attn_fwd.cu` unless it is built already. Raises if
    nvcc fails."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    path = os.path.join(_BUILD_DIR, f"libblocked_attn_fwd-{digest}.so")
    if os.path.exists(path):
        return Built(path, 0.0, "")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for blocked_attn_fwd "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)
    return Built(path, seconds, proc.stdout)


def load() -> ctypes.CDLL:
    """The kernel library, built first if needed."""
    return ctypes.CDLL(build().path)
