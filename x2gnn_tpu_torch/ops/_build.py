"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `ops/csrc/<name>.cu` compiles into a shared library of its own with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The libraries go to `build/kernels/` beside the package (a directory that
.gitignore lists), each named by a hash of its source, so an edited source
is rebuilt at its next use and a stale library is never loaded. A build
happens at first use; `build_all` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
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


def sources() -> Dict[str, str]:
    """{kernel library name: source path} for every .cu under csrc/."""
    return {f[:-3]: os.path.join(_CSRC, f)
            for f in sorted(os.listdir(_CSRC)) if f.endswith(".cu")}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _library_path(name: str) -> str:
    with open(sources()[name], "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=None) -> Dict[str, Built]:
    """Compile the named kernel libraries (all by default) that are not
    built yet, one nvcc process per source, all started together. Raises
    if any nvcc fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    out, running = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = _library_path(name)
        if os.path.exists(path):
            out[name] = Built(path, 0.0, "")
            continue
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, srcs[name]],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path)
    failed = []
    for name, (proc, tmp, path) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode})"
                          f":\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = Built(path, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name` (a source csrc/<name>.cu), built first if
    needed."""
    return ctypes.CDLL(build_all([name])[name].path)
