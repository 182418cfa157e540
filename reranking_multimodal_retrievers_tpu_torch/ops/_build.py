"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface (no PyTorch headers), so it
compiles in seconds into its own shared library under ``build/torch_kernels/``
at the repository root (listed in ``.gitignore``). All sources are compiled
in parallel, one ``nvcc`` per source. A library is rebuilt only when the hash
of its source, the shared headers (every ``csrc/*.cuh``) and the flags
changes. A failed build raises.

Nothing here runs at import time: the first kernel launch, or an explicit
:func:`build_all`, triggers the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = {"maxsim": "maxsim.cu", "attention": "attention.cu", "maxsim_int8": "maxsim_int8.cu",
           "attention_f32": "attention_f32.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any header
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing; returns the seconds
    spent. The compiler's register and shared-memory report goes to
    ``<library>.log`` beside each library."""
    with _lock:
        t0 = time.perf_counter()
        todo = {n: _target(n) for n in SOURCES if not _target(n).exists()}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name, out in todo.items():
                tmp = out.with_suffix(f".tmp{os.getpid()}.so")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
            failed = []
            for name, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                out.with_suffix(".log").write_bytes(log)
                if proc.returncode != 0:
                    failed.append(f"{name}: {log.decode(errors='replace')[-4000:]}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``SOURCES[name]``, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
