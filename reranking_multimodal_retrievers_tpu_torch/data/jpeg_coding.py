"""The JPEG codings beside Huffman-coded DCT, decoded as libjpeg-turbo 3.1
(PIL 12.1's) decodes them, for ``image_io.decode_jpeg``:

- arithmetic-coded DCT, sequential (SOF9) and progressive (SOF10): the QM
  decoder of T.81 Annex D (``jdarith.c``'s ``arith_decode``, its
  probability table ``jaricom.c``, ``QE`` below), the DC and AC models of
  Annex F.1.4 (DC conditioning on the last difference's category, bounds L
  and U; AC magnitude bins switched at K) and the progressive models of
  Annex G.1.3 (DC and AC first scans, refinement bits on a fixed 0.5
  estimate), with the conditioning of a DAC marker. The coefficients feed
  ``image_io``'s dequantization, block smoothing, IDCT and colour path.
- lossless (SOF3), Huffman-coded: each sample's difference from one of the
  seven predictors of T.81 H.1.2.1 (the first row of a restart interval
  predicts from the left, each row's first sample from above, the very
  first from ``2^(P - Pt - 1)``), modulo 2^16, then scaled by the point
  transform (``jdlossls.c``, ``jdpred.c``, ``jdlhuff.c``). There is no DCT.

A marker inside an arithmetic-coded segment ends it; the decoder then reads
zeros, as T.81 (and ``jdarith.c``) specify.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# T.81 Table D.2 (Qe, next index after an LPS, after an MPS, MPS switch),
# and libjpeg's entry 113: a fixed estimate of 0.5 that never moves
QE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
]
FIXED = 113  # the state of the fixed 0.5 estimate
_QE = [q for q, _, _, _ in QE]
# the state byte after an LPS / an MPS: next index | MPS bit (flipped on a switch)
_AFTER_LPS = [nl | (sw << 7) for _, nl, _, sw in QE]
_AFTER_MPS = [nm for _, _, nm, _ in QE]
DC_BINS, AC_BINS = 64, 256
# conditioning defaults (T.81 F.1.4.4): DC bounds L, U; AC bound K
DEFAULT_DC_LU = (0, 1)
DEFAULT_AC_K = 5


class QMDecoder:
    """T.81's arithmetic decoder over one entropy-coded segment's unstuffed
    bytes (zeros past its end); ``decode(stats, i)`` decodes a decision
    with the estimate in ``stats[i]`` (a state byte: index | MPS << 7)."""

    __slots__ = ("data", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.pos, self.c, self.a, self.ct = data, 0, 0, 0, -16

    def decode(self, stats, i: int) -> int:
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                data = self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
                c = (c << 8) | data
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000  # two bytes in: A becomes 0x10000 below
            a <<= 1
        sv = stats[i]
        qe = _QE[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                stats[i] = (sv & 0x80) ^ _AFTER_MPS[sv & 0x7F]
            else:
                a = qe
                stats[i] = (sv & 0x80) ^ _AFTER_LPS[sv & 0x7F]
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 0x80) ^ _AFTER_LPS[sv & 0x7F]
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ _AFTER_MPS[sv & 0x7F]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _dc_diff(dec: QMDecoder, st: List[int], ctx: int, lu: Tuple[int, int]):
    """One DC difference (F.1.4.4.1, Figures F.19-F.24) at context ``ctx``;
    returns (difference, next context)."""
    if not dec.decode(st, ctx):
        return 0, 0
    sign = dec.decode(st, ctx + 1)
    s = ctx + 2 + sign
    m = dec.decode(st, s)
    if m:
        s = 20
        while dec.decode(st, s):
            m <<= 1
            if m == 0x8000:
                raise ValueError("JPEG: corrupt arithmetic-coded DC magnitude")
            s += 1
    lo, hi = lu
    if m < (1 << lo) >> 1:
        nctx = 0
    elif m > (1 << hi) >> 1:
        nctx = 12 + 4 * sign
    else:
        nctx = 4 + 4 * sign
    v = m
    s += 14
    while m > 1:
        m >>= 1
        if dec.decode(st, s):
            v |= m
    v += 1
    return (-v if sign else v), nctx


def _ac_value(dec: QMDecoder, st: List[int], fixed: List[int], s: int, k: int, kx: int) -> int:
    """The sign and magnitude of a nonzero AC coefficient at ``k``
    (Figures F.21-F.24), its bins from ``s``."""
    sign = dec.decode(fixed, 0)
    s += 2
    m = dec.decode(st, s)
    if m and dec.decode(st, s):
        m <<= 1
        s = 189 if k <= kx else 217
        while dec.decode(st, s):
            m <<= 1
            if m == 0x8000:
                raise ValueError("JPEG: corrupt arithmetic-coded AC magnitude")
            s += 1
    v = m
    s += 14
    while m > 1:
        m >>= 1
        if dec.decode(st, s):
            v |= m
    v += 1
    return -v if sign else v


def _wrap16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def arith_interval(seg: bytes, units, flats, zigzag: Sequence[int], *, ss: int = 0,
                   se: int = 63, ah: int = 0, al: int = 0, progressive: bool = False,
                   dc_lu: Dict[int, Tuple[int, int]] = None, ac_k: Dict[int, int] = None):
    """Decode one restart interval ``seg`` of an arithmetic-coded scan into
    the flat coefficient lists (natural order): ``units`` [(component, DC
    table, AC table, coefficient offset)] in order. The statistics, DC
    predictions and contexts start afresh, as at a scan's start or a
    restart (``jdarith.c``'s ``process_restart``)."""
    dc_lu, ac_k = dc_lu or {}, ac_k or {}
    dec = QMDecoder(seg)
    fixed = [FIXED]
    dc_stats: Dict[int, List[int]] = {}
    ac_stats: Dict[int, List[int]] = {}
    last: Dict[int, int] = {}
    ctx: Dict[int, int] = {}
    for c, td, ta, base in units:
        flat = flats[c]
        if not progressive or (ss == 0 and ah == 0):  # a DC difference
            st = dc_stats.setdefault(td, [0] * DC_BINS)
            v, ctx[c] = _dc_diff(dec, st, ctx.get(c, 0), dc_lu.get(td, DEFAULT_DC_LU))
            last[c] = _wrap16(last.get(c, 0) + v)
            flat[base] = last[c] << al if progressive else last[c]
            if progressive:
                continue
        elif ss == 0:  # DC refinement: one bit a block
            if dec.decode(fixed, 0):
                flat[base] |= 1 << al
            continue
        st = ac_stats.setdefault(ta, [0] * AC_BINS)
        kx = ac_k.get(ta, DEFAULT_AC_K)
        start = ss if progressive else 1
        end = se if progressive else 63
        if progressive and ah:
            _ac_refine(dec, st, fixed, flat, base, zigzag, start, end, al)
            continue
        k = start
        while k <= end:
            s = 3 * (k - 1)
            if dec.decode(st, s):  # end of block
                break
            while not dec.decode(st, s + 1):
                s += 3
                k += 1
                if k > end:
                    raise ValueError("JPEG: corrupt arithmetic-coded AC run")
            v = _ac_value(dec, st, fixed, s, k, kx)
            flat[base + zigzag[k]] = v << al if progressive else v
            k += 1


def _ac_refine(dec: QMDecoder, st: List[int], fixed: List[int], flat, base: int,
               zigzag: Sequence[int], ss: int, se: int, al: int) -> None:
    """An AC refinement scan's bits for one block (Figure G.11)."""
    p1, m1 = 1 << al, -1 << al
    kex = se
    while kex > 0 and not flat[base + zigzag[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        s = 3 * (k - 1)
        if k > kex and dec.decode(st, s):
            break
        while True:
            at = base + zigzag[k]
            coef = flat[at]
            if coef:
                if dec.decode(st, s + 2):
                    flat[at] = coef + (m1 if coef < 0 else p1)
                break
            if dec.decode(st, s + 1):
                flat[at] = m1 if dec.decode(fixed, 0) else p1
                break
            s += 3
            k += 1
            if k > se:
                raise ValueError("JPEG: corrupt arithmetic-coded AC refinement")
        k += 1


# ---------------------------------------------------------------- lossless
def lossless_interval(seg: bytes, comps: Sequence[Tuple[int, list]], samples, rows: range,
                      width: int, predictor: int, pt: int, precision: int) -> None:
    """Decode the sample rows ``rows`` of a Huffman-coded lossless scan
    (one restart interval, ``seg``) into ``samples[c]`` (int64 [H, W]),
    for ``comps`` [(component, Huffman lookup)] interleaved sample by
    sample. The interval's first row predicts from the left, the first
    sample from ``2^(precision - pt - 1)``."""
    from .image_io import _Bits

    bits = _Bits(seg)
    first_pred = 1 << (precision - pt - 1)
    for n, y in enumerate(rows):
        cur = {c: [0] * width for c, _ in comps}
        above = {c: samples[c][y - 1] for c, _ in comps} if n else None
        for x in range(width):
            for c, lut in comps:
                s = bits.huff(lut)
                if s == 0:
                    diff = 0
                elif s == 16:
                    diff = 32768
                else:
                    diff = bits.extend(s)
                row = cur[c]
                if n == 0:
                    pred = row[x - 1] if x else first_pred
                elif x == 0:
                    pred = int(above[c][0]) >> pt
                else:
                    ra, rb, rc = row[x - 1], int(above[c][x]) >> pt, int(above[c][x - 1]) >> pt
                    pred = (ra if predictor == 1 else rb if predictor == 2 else
                            rc if predictor == 3 else ra + rb - rc if predictor == 4 else
                            ra + ((rb - rc) >> 1) if predictor == 5 else
                            rb + ((ra - rc) >> 1) if predictor == 6 else (ra + rb) >> 1)
                row[x] = (pred + diff) & 0xFFFF
        for c, _ in comps:
            samples[c][y] = np.asarray(cur[c], np.int64) << pt
