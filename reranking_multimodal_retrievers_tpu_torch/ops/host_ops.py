"""Host-side runtime ops over numpy arrays (port of ``ops/host_ops.py``):
ctypes bindings for the C++ library ``csrc/host_ops.cpp``.

The library is built at first use with ``g++ -O3 -march=native`` into
``build/torch_kernels/`` at the repository root (listed in ``.gitignore``).
Its name holds a hash of the source, the flags and the host's CPU (its
model and feature flags, as ``/proc/cpuinfo`` gives them): ``-march=native``
code built on one machine may not run on another, so a library built
elsewhere is never loaded. A failed build raises with the compiler's
message; nothing falls back to numpy. The numpy versions (``*_reference``)
are the JAX package's fallbacks, reached only when a caller asks for them.

On tied scores the two top-k versions order differently, as in the JAX
package: the library's heap (``std::greater`` over ``(score, index)``
pairs) keeps, among the ties at the k-th place, whichever the scan leaves
in the heap and lists a group of equal scores from the highest index down;
the reference is a stable sort (lowest index first).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32, _i32, _i64, _u8 = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int32,
                                                      ctypes.c_int64, ctypes.c_uint8))
_SIGNATURES = {
    "segmented_maxsim": [_f32, _i32, ctypes.c_int64, ctypes.c_int64, _f32],
    "segmented_lookup": [_f32, _i64, _i32, ctypes.c_int64, ctypes.c_int64, _f32],
    "top_k_indices": [_f32, ctypes.c_int64, ctypes.c_int64, _i64],
    "pack_bits": [_u8, ctypes.c_int64, _u8],
    "unpack_bits": [_u8, ctypes.c_int64, _u8],
}


def host_key() -> str:
    """What ``-march=native`` code depends on: the machine type and the
    first CPU's model name and feature flags."""
    parts = [platform.machine()]
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.split(":", 1)[0].strip() in ("model name", "flags"):
                parts.append(line.strip())
            elif not line.strip() and len(parts) > 1:
                break  # the end of the first processor's block
    return "\n".join(parts)


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode() + b"\0" + host_key().encode())
    return BUILD_DIR / f"host_ops-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [os.environ.get("CXX", "g++"), *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"building {SOURCE.name}: {cmd[0]} not found") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL:
    """The loaded library, built first if its file is missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def segmented_maxsim_host(scores: np.ndarray, doclens: np.ndarray) -> np.ndarray:
    """Per-doc MaxSim totals over packed scores ``[total_tokens, L_q]``
    (``doclens`` rows a doc, in order); a doc of no rows totals 0."""
    scores = np.ascontiguousarray(scores, np.float32)
    doclens = np.ascontiguousarray(doclens, np.int32)
    if scores.ndim != 2 or doclens.ndim != 1 or (doclens < 0).any():
        raise ValueError(f"scores {scores.shape}, doclens {doclens.shape}: want 2-D scores "
                         "and 1-D non-negative lengths")
    if int(doclens.sum(dtype=np.int64)) > scores.shape[0]:
        raise ValueError(f"doclens sum to {int(doclens.sum())} rows, scores have "
                         f"{scores.shape[0]}")
    out = np.empty(len(doclens), np.float32)
    _load().segmented_maxsim(_ptr(scores, _f32), _ptr(doclens, _i32), len(doclens),
                             scores.shape[1], _ptr(out, _f32))
    return out


def segmented_maxsim_reference(scores: np.ndarray, doclens: np.ndarray) -> np.ndarray:
    scores = np.ascontiguousarray(scores, np.float32)
    out = np.zeros(len(doclens), np.float32)
    off = 0
    for i, n in enumerate(doclens):
        if n:
            out[i] = scores[off:off + n].max(axis=0).sum()
        off += n
    return out


def segmented_lookup_host(src: np.ndarray, offsets: np.ndarray,
                          lengths: np.ndarray) -> np.ndarray:
    """Rows ``src[o:o + n]`` of each ``(o, n)``, packed one after another."""
    src = np.ascontiguousarray(src, np.float32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int32)
    if src.ndim != 2 or offsets.shape != lengths.shape or offsets.ndim != 1:
        raise ValueError(f"src {src.shape}, offsets {offsets.shape}, lengths {lengths.shape}")
    if len(lengths) and ((lengths < 0).any() or (offsets < 0).any()
                         or (offsets + lengths > src.shape[0]).any()):
        raise ValueError(f"a segment lies outside src's {src.shape[0]} rows")
    out = np.empty((int(lengths.sum(dtype=np.int64)), src.shape[1]), np.float32)
    _load().segmented_lookup(_ptr(src, _f32), _ptr(offsets, _i64), _ptr(lengths, _i32),
                             len(lengths), src.shape[1], _ptr(out, _f32))
    return out


def segmented_lookup_reference(src: np.ndarray, offsets: np.ndarray,
                               lengths: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(src, np.float32)
    if not int(np.sum(lengths)):
        return np.zeros((0, src.shape[1]), np.float32)
    return np.concatenate([src[o:o + n] for o, n in zip(offsets, lengths)])


def top_k_host(scores: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``min(k, len(scores))`` largest scores, highest
    first (ties: see the module's docstring)."""
    scores = np.ascontiguousarray(scores, np.float32)
    if scores.ndim != 1:
        raise ValueError(f"scores {scores.shape}: want a vector")
    k = max(0, min(int(k), len(scores)))
    out = np.empty(k, np.int64)
    if k:  # the heap's scan reads its top, which k = 0 leaves empty
        _load().top_k_indices(_ptr(scores, _f32), len(scores), k, _ptr(out, _i64))
    return out


def top_k_reference(scores: np.ndarray, k: int) -> np.ndarray:
    scores = np.ascontiguousarray(scores, np.float32)
    return np.argsort(-scores, kind="stable")[:min(k, len(scores))]


def pack_bits_host(bits: np.ndarray) -> np.ndarray:
    """0/1 values packed 8 a byte, most significant bit first
    (``np.packbits``)."""
    bits = np.ascontiguousarray(np.asarray(bits).astype(np.uint8).reshape(-1))
    out = np.empty((len(bits) + 7) // 8, np.uint8)
    _load().pack_bits(_ptr(bits, _u8), len(bits), _ptr(out, _u8))
    return out


def pack_bits_reference(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits).astype(np.uint8))


def unpack_bits_host(packed: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` bits of ``packed``, one 0/1 byte each."""
    packed = np.ascontiguousarray(packed, np.uint8).reshape(-1)
    if not 0 <= n <= 8 * len(packed):
        raise ValueError(f"{n} bits asked of {len(packed)} bytes")
    out = np.empty(n, np.uint8)
    _load().unpack_bits(_ptr(packed, _u8), n, _ptr(out, _u8))
    return out


def unpack_bits_reference(packed: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(np.asarray(packed, np.uint8))[:n]
