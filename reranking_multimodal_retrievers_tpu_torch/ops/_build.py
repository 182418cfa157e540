"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file has a plain C interface (no PyTorch headers), so it
compiles in seconds into a shared library under ``build/torch_kernels/``
at the repository root (listed in ``.gitignore``). K2's two per-width
sources are each built into one library a group of head widths
(``K2_GROUPS``); its generic kernel (``attention_any.cu``, every other
head width) into one a dtype. All libraries
are compiled in parallel, one ``nvcc`` each. A library is rebuilt only when
the hash of its source, the shared headers (every ``csrc/*.cuh``) and its
flags changes. A failed build raises.

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
# K2's head widths by library suffix: every multiple of 16 from the first to
# the last, given to nvcc as K2_HD_FIRST and K2_HD_LAST (a -D list would be
# split at its commas), so that the groups compile in parallel
K2_GROUPS = {"": (64, 80), "_narrow": (16, 48), "_wide": (96, 128)}
K2_SOURCES = ("attention", "attention_f32")  # bf16 and fp32
# K2's generic kernel by dtype: bf16 and fp32 compile in parallel
K2_ANY = {"attention_any": 0, "attention_any_f32": 1}
SOURCES = {"maxsim": "maxsim.cu", "maxsim_int8": "maxsim_int8.cu",
           **{name: "attention_any.cu" for name in K2_ANY},
           **{src + group: f"{src}.cu" for src in K2_SOURCES for group in K2_GROUPS}}
DEFINES = {**{src + group: (f"-DK2_HD_FIRST={first}", f"-DK2_HD_LAST={last}")
              for src in K2_SOURCES for group, (first, last) in K2_GROUPS.items()},
           **{name: (f"-DK2_ANY_FP32={fp32}",) for name, fp32 in K2_ANY.items()}}
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


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + DEFINES.get(name, ())


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any header
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
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
                cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / SOURCES[name])]
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
