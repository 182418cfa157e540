"""Zstandard decompression (RFC 8878) without the ``zstandard`` package (the
card's machine has none): the codec of parquet pages that polars writes by
default and pyarrow on request.

:func:`decompress` takes one or more frames, and skippable frames, one after
the other, and returns their content joined:

- Frame header: content size, window, single segment; a dictionary id other
  than 0 raises (parquet writes none). The optional content checksum (the low
  32 bits of XXH64) is checked.
- Blocks: raw, RLE and compressed.
- Literals: raw, RLE, Huffman-coded with 1 or 4 streams (the tree given as
  direct 4-bit weights or FSE-compressed weights) and treeless (the previous
  block's tree).
- Sequences: literal lengths, offsets and match lengths each by a
  predefined, RLE, FSE-compressed or repeated table, with the three repeat
  offsets.

Bitstreams that zstd reads backwards are read as forward MSB-first streams
over their bytes reversed. A Huffman stream is decoded in numpy: the symbol
and length at every bit position by one table lookup, then the chain of
positions from the start by pointer doubling. The sequences are decoded in
Python, a sequence at a time.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50  # 0x184D2A50 .. 0x184D2A5F

# literal-length and match-length codes: (baseline, extra bits)
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
    (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]
# the predefined distributions (RFC 8878, 3.1.1.3.2.2) and their accuracy logs
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
               -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1], 5)
_MAX_SYMBOL = {"ll": 35, "of": 31, "ml": 52}
_MAX_LOG = {"ll": 9, "of": 8, "ml": 9}


class ZstdError(ValueError):
    """A malformed or unsupported zstd stream."""


# ----------------------------------------------------------------- bit readers
class _Forward:
    """Little-endian, LSB-first bits of ``buf`` from byte ``pos`` (FSE table
    descriptions)."""

    def __init__(self, buf: bytes, pos: int, end: int):
        self.buf, self.bit, self.end = buf, pos * 8, end

    def peek(self, n: int) -> int:
        byte = self.bit >> 3
        word = int.from_bytes(self.buf[byte:min(byte + 8, self.end)], "little")
        return (word >> (self.bit & 7)) & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.bit += n
        if self.bit > self.end * 8:
            raise ZstdError("an FSE table description runs past its block")

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.skip(n)
        return v


class _Backward:
    """A zstd backward bitstream: its bits from the last byte's padding
    marker down to bit 0 of its first byte, read as MSB-first bits of the
    bytes reversed. Reads past the start give zeros; ``overflow`` tells."""

    def __init__(self, stream: bytes):
        if not stream or stream[-1] == 0:
            raise ZstdError("a backward bitstream without its end marker")
        self.buf = stream[::-1] + bytes(8)
        self.bit = 9 - stream[-1].bit_length()  # past the leading zeros and the marker
        self.total = len(stream) * 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.bit
        self.bit = p + n
        byte = p >> 3
        word = int.from_bytes(self.buf[byte:byte + 8], "big")
        return (word >> (64 - (p & 7) - n)) & ((1 << n) - 1)

    @property
    def overflow(self) -> bool:
        return self.bit > self.total

    @property
    def done(self) -> bool:
        return self.bit == self.total


# ----------------------------------------------------------------------- FSE
def _read_fse_description(buf: bytes, pos: int, end: int, max_symbol: int,
                          max_log: int) -> Tuple[List[int], int, int]:
    """(normalised counts, accuracy log, position after the description)."""
    br = _Forward(buf, pos, end)
    log = br.read(4) + 5
    if log > max_log:
        raise ZstdError(f"an FSE accuracy log of {log} (at most {max_log})")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts: List[int] = []
    while remaining > 1 and len(counts) <= max_symbol:
        mx = 2 * threshold - 1 - remaining
        low = br.peek(nbits - 1)
        if low & (threshold - 1) < mx:
            value = low & (threshold - 1)
            br.skip(nbits - 1)
        else:
            value = br.peek(nbits) & (2 * threshold - 1)
            if value >= threshold:
                value -= mx
            br.skip(nbits)
        count = value - 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if count == 0:
            while True:
                rep = br.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("an FSE table description whose counts do not sum to its table")
    return counts, log, (br.bit + 7) // 8


def _fse_table(counts: List[int], log: int) -> Tuple[List[int], List[int], List[int]]:
    """The decoding table of normalised ``counts``: per state its symbol,
    the bits to read and the baseline of the next state."""
    size = 1 << log
    symbol = [0] * size
    nxt = [0] * len(counts)
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("an FSE table that does not spread over its states")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = symbol[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        nbits[u] = nb
        base[u] = (x << nb) - size
    return symbol, nbits, base


_DEFAULTS = {"ll": _fse_table(*LL_DEFAULT), "ml": _fse_table(*ML_DEFAULT),
             "of": _fse_table(*OF_DEFAULT)}
_DEFAULT_LOG = {"ll": LL_DEFAULT[1], "ml": ML_DEFAULT[1], "of": OF_DEFAULT[1]}


# ------------------------------------------------------------------- Huffman
def _huffman_weights(buf: bytes, pos: int) -> Tuple[List[int], int]:
    """The weights of a Huffman tree description at ``pos`` (the last
    symbol's implied) and the position after it."""
    head = buf[pos]
    pos += 1
    if head >= 128:  # direct: 4 bits a weight, two a byte, high nibble first
        n = head - 127
        raw = buf[pos:pos + (n + 1) // 2]
        weights = [w for b in raw for w in (b >> 4, b & 15)][:n]
        pos += (n + 1) // 2
    else:  # FSE-compressed weights, two interleaved states
        end = pos + head
        counts, log, at = _read_fse_description(buf, pos, end, 255, 6)
        symbol, nbits, base = _fse_table(counts, log)
        br = _Backward(buf[at:end])
        s1, s2 = br.read(log), br.read(log)
        weights = []
        while True:
            if len(weights) > 255:
                raise ZstdError("too many Huffman weights")
            weights.append(symbol[s1])
            s1 = base[s1] + br.read(nbits[s1])
            if br.overflow:
                weights.append(symbol[s2])
                break
            weights.append(symbol[s2])
            s2 = base[s2] + br.read(nbits[s2])
            if br.overflow:
                weights.append(symbol[s1])
                break
        pos = end
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("a Huffman tree with no weight")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights that leave no power of two for the last symbol")
    weights.append(rest.bit_length())
    if max_bits > 11:
        raise ZstdError(f"a Huffman tree {max_bits} bits deep (at most 11)")
    return weights, pos


def _huffman_table(weights: List[int]) -> Tuple[np.ndarray, np.ndarray, int]:
    """(symbol, bits) for every ``max_bits``-bit prefix, and ``max_bits``."""
    max_bits = sum(1 << (w - 1) for w in weights if w).bit_length() - 1
    size = 1 << max_bits
    sym = np.zeros(size, np.uint8)
    nb = np.zeros(size, np.int64)
    rank = [0] * (max_bits + 2)
    for w in weights:
        if w:
            rank[w] += 1
    start, nxt = [0] * (max_bits + 2), 0
    for w in range(1, max_bits + 1):
        start[w] = nxt
        nxt += rank[w] << (w - 1)
    for s, w in enumerate(weights):
        if w:
            n = 1 << (w - 1)
            sym[start[w]:start[w] + n] = s
            nb[start[w]:start[w] + n] = max_bits + 1 - w
            start[w] += n
    return sym, nb, max_bits


def _huffman_stream(stream: bytes, count: int, table) -> np.ndarray:
    """``count`` symbols of one backward Huffman stream, which they must
    consume exactly."""
    if count == 0:
        return np.zeros(0, np.uint8)
    sym, nb, max_bits = table
    if not stream or stream[-1] == 0:
        raise ZstdError("a Huffman stream without its end marker")
    bits = np.unpackbits(np.frombuffer(stream[::-1], np.uint8))[9 - stream[-1].bit_length():]
    T = len(bits)
    padded = np.concatenate([bits, np.zeros(max_bits, np.uint8)]).astype(np.int64)
    peek = np.zeros(T + 1, np.int64)
    for k in range(max_bits):
        peek = (peek << 1) | padded[k:k + T + 1]
    length = nb[peek]
    nxt = np.minimum(np.arange(T + 1) + length, T)
    # position of symbol i: next applied i times to 0, by pointer doubling
    idx = np.arange(count)
    at = np.zeros(count, np.int64)
    jump, j = nxt, 0
    while (1 << j) < count:
        sel = ((idx >> j) & 1).astype(bool)
        at[sel] = jump[at[sel]]
        jump = jump[jump]
        j += 1
    last = at[-1]
    if last + length[last] != T or (count > 1 and np.any(at[1:] <= at[:-1])):
        raise ZstdError("a Huffman stream that does not end with its last symbol")
    return sym[peek[at]]


# -------------------------------------------------------------------- frames
class _Frame:
    """What a frame's blocks share: the previous Huffman table and FSE
    tables, the repeat offsets, and the frame's output so far."""

    def __init__(self, out: bytearray):
        self.out = out
        self.start = len(out)
        self.huffman = None
        self.tables = {}
        self.rep = [1, 4, 8]


def _literals(f: _Frame, buf: bytes, pos: int, end: int) -> Tuple[bytes, int]:
    b0 = buf[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) | (buf[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) | (buf[pos + 1] << 4) | (buf[pos + 2] << 12), pos + 3
        if kind == 0:
            if pos + size > end:
                raise ZstdError("raw literals run past their block")
            return buf[pos:pos + size], pos + size
        return bytes([buf[pos]]) * size, pos + 1
    nhead, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    h = int.from_bytes(buf[pos:pos + nhead], "little")
    mask = (1 << bits) - 1
    size, csize = (h >> 4) & mask, (h >> (4 + bits)) & mask
    pos += nhead
    stop = pos + csize
    if stop > end:
        raise ZstdError("compressed literals run past their block")
    if kind == 2:
        weights, pos = _huffman_weights(buf, pos)
        f.huffman = _huffman_table(weights)
    elif f.huffman is None:
        raise ZstdError("treeless literals without an earlier Huffman tree")
    if fmt == 0:  # one stream
        lit = _huffman_stream(buf[pos:stop], size, f.huffman)
    else:
        s1, s2, s3 = struct.unpack_from("<HHH", buf, pos)
        pos += 6
        part = (size + 3) // 4
        sizes = [part, part, part, size - 3 * part]
        if sizes[3] < 0 or pos + s1 + s2 + s3 > stop:
            raise ZstdError("a four-stream literal section of impossible sizes")
        bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, stop]
        lit = np.concatenate([_huffman_stream(buf[bounds[i]:bounds[i + 1]], sizes[i],
                                              f.huffman) for i in range(4)])
    return lit.tobytes(), stop


def _table(f: _Frame, name: str, mode: int, buf: bytes, pos: int, end: int):
    if mode == 0:
        t = (_DEFAULTS[name], _DEFAULT_LOG[name])
    elif mode == 1:  # RLE: one symbol, no bits
        s = buf[pos]
        pos += 1
        if s > _MAX_SYMBOL[name]:
            raise ZstdError(f"an RLE {name} symbol {s}")
        t = (([s], [0], [0]), 0)
    elif mode == 2:
        counts, log, pos = _read_fse_description(buf, pos, end, _MAX_SYMBOL[name],
                                                 _MAX_LOG[name])
        t = (_fse_table(counts, log), log)
    else:
        if name not in f.tables:
            raise ZstdError(f"a repeated {name} table without an earlier one")
        t = f.tables[name]
    f.tables[name] = t
    return t, pos


def _sequences(f: _Frame, buf: bytes, pos: int, end: int, lit: bytes) -> None:
    out = f.out
    b0 = buf[pos]
    if b0 == 0:
        out += lit
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + buf[pos + 1], pos + 2
    else:
        nseq, pos = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00, pos + 3
    modes = buf[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence compression modes")
    (ll_sym, ll_nb, ll_base), ll_log = (t := _table(f, "ll", modes >> 6, buf, pos, end))[0]
    pos = t[1]
    (of_sym, of_nb, of_base), of_log = (t := _table(f, "of", (modes >> 4) & 3, buf, pos, end))[0]
    pos = t[1]
    (ml_sym, ml_nb, ml_base), ml_log = (t := _table(f, "ml", (modes >> 2) & 3, buf, pos, end))[0]
    pos = t[1]
    br = _Backward(buf[pos:end])
    read = br.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    rep = f.rep
    lp = 0
    for i in range(nseq):
        of_code, ll_code, ml_code = of_sym[of_s], ll_sym[ll_s], ml_sym[ml_s]
        if of_code > 31:
            raise ZstdError(f"an offset code of {of_code}")
        value = (1 << of_code) + read(of_code)
        base, nb = ML_CODES[ml_code]
        ml = base + read(nb)
        base, nb = LL_CODES[ll_code]
        ll = base + read(nb)
        if value > 3:
            offset = value - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            k = value if ll else value + 1
            if k == 1:
                offset = rep[0]
            elif k == 2:
                offset = rep[1]
                rep[1], rep[0] = rep[0], offset
            elif k == 3:
                offset = rep[2]
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
            else:
                offset = rep[0] - 1
                if offset == 0:
                    raise ZstdError("a repeat offset of 0")
                rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        if i != nseq - 1:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lp + ll > len(lit):
            raise ZstdError("a sequence takes more literals than the block has")
        out += lit[lp:lp + ll]
        lp += ll
        start = len(out) - offset
        if start < f.start:
            raise ZstdError(f"a match {offset} bytes back, before the frame's start")
        if ml <= offset:
            out += out[start:start + ml]
        else:
            out += (bytes(out[start:]) * (ml // offset + 1))[:ml]
    if not br.done:
        raise ZstdError("a sequence bitstream not consumed exactly")
    out += lit[lp:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("the reserved bit of a frame header is set")
    if not single:
        pos += 1  # window descriptor: the whole frame stays in memory here
    nd = (0, 1, 2, 4)[dict_flag]
    if nd and int.from_bytes(data[pos:pos + nd], "little"):
        raise NotImplementedError("a zstd frame that needs a dictionary, which this reader "
                                  "does not take")
    pos += nd
    nf = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size: Optional[int] = None
    if nf:
        size = int.from_bytes(data[pos:pos + nf], "little") + (256 if nf == 2 else 0)
        pos += nf
    f = _Frame(out)
    while True:
        if pos + 3 > len(data):
            raise ZstdError("a zstd frame cut short")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, bsize = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            if pos + bsize > len(data):
                raise ZstdError("a raw block cut short")
            out += data[pos:pos + bsize]
            pos += bsize
        elif kind == 1:
            out += bytes([data[pos]]) * bsize
            pos += 1
        elif kind == 2:
            end = pos + bsize
            if end > len(data):
                raise ZstdError("a compressed block cut short")
            lit, at = _literals(f, data, pos, end)
            _sequences(f, data, at, end, lit)
            pos = end
        else:
            raise ZstdError("a block of the reserved type")
        if last:
            break
    if size is not None and len(out) - f.start != size:
        raise ZstdError(f"a frame of {len(out) - f.start} bytes, its header says {size}")
    if checksum:
        (want,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if xxh64(bytes(out[f.start:])) & 0xFFFFFFFF != want:
            raise ZstdError("a zstd frame whose content checksum does not match")
    return pos


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data`` (skippable frames
    skipped), joined."""
    out = bytearray()
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("trailing bytes after the last zstd frame")
        (magic,) = struct.unpack_from("<I", data, pos)
        if magic == MAGIC:
            pos = _frame(data, pos + 4, out)
        elif magic & 0xFFFFFFF0 == _SKIPPABLE:
            (n,) = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + n
        else:
            raise ZstdError(f"not a zstd frame: magic {magic:#010x} at byte {pos}")
    return bytes(out)


# -------------------------------------------------------------------- XXH64
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M, 31) * _P1) & _M


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the hash zstd's content checksum keeps 32 bits of)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed, (seed - _P1) & _M]
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for i in range(0, len(lanes), 4):
            v[0] = _round(v[0], lanes[i])
            v[1] = _round(v[1], lanes[i + 1])
            v[2] = _round(v[2], lanes[i + 2])
            v[3] = _round(v[3], lanes[i + 3])
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M
        p = (n // 32) * 32
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while p + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _M
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ ((k * _P1) & _M), 23) * _P2 + _P3) & _M
        p += 4
    while p < n:
        h = (_rotl(h ^ ((data[p] * _P5) & _M), 11) * _P1) & _M
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    return h ^ (h >> 32)
