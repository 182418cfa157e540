"""Brotli decompression (RFC 7932) without the ``brotli`` package (the
card's machine has none): the codec of parquet pages that pyarrow writes
with ``compression="brotli"``.

:func:`decompress` reads one stream:

- The stream header (the window size, 10 to 24 bits; the large-window
  extension raises).
- Meta-blocks: metadata (skipped), uncompressed and compressed.
- Compressed meta-blocks: block types and counts for literals, commands
  and distances; simple and complex prefix codes (the code-length code,
  runs of repeated and zero lengths); literal context modes (LSB6, MSB6,
  UTF8, signed) and context maps (run-length coded zeros, the inverse
  move-to-front transform); postfix and direct distance codes and the
  four-entry ring buffer of distances.
- The static dictionary (122,784 bytes, committed zlib-compressed beside
  this module as ``brotli_dictionary.bin.z``; ``tests/fixtures/
  make_brotli_dictionary.py`` writes it and states its SHA-256, which is
  checked on load) with the 121 word transforms of RFC 7932 Appendix B,
  written out below.

Prefix codes are decoded by one table lookup on the next bits (LSB
first); the literals and commands run in Python, one at a time.
"""

from __future__ import annotations

import hashlib
import zlib
from pathlib import Path
from typing import List, Optional, Tuple

DICTIONARY_FILE = Path(__file__).with_name("brotli_dictionary.bin.z")
DICTIONARY_SIZE = 122_784
DICTIONARY_SHA256 = "20e42eb1b511c21806d4d227d07e5dd06877d8ce7b3a817f378f313653f35c70"
# words of each length in the dictionary, as bits (RFC 7932, 8)
NDBITS = [0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10, 9, 9, 8, 7, 7, 8, 7, 7, 6, 6, 5, 5]
DOFFSET = [0] * 25
for _n in range(4, 24):
    DOFFSET[_n + 1] = DOFFSET[_n] + _n * (1 << NDBITS[_n])
del _n

# transform kinds: 0 identity, 1-9 omit the last n bytes, 10 uppercase the
# first letter, 11 uppercase all, 12-20 omit the first n - 11 bytes
_UPPER_FIRST, _UPPER_ALL, _OMIT_FIRST = 10, 11, 11
# (prefix, transform, suffix) of RFC 7932 Appendix B, by transform id
_T = [
    ("", 0, ""), ("", 0, " "), (" ", 0, " "), ("", 12, ""), ("", 10, " "), ("", 0, " the "),
    (" ", 0, ""), ("s ", 0, " "), ("", 0, " of "), ("", 10, ""), ("", 0, " and "),
    ("", 13, ""), ("", 1, ""), (", ", 0, " "), ("", 0, ", "), (" ", 10, " "), ("", 0, " in "),
    ("", 0, " to "), ("e ", 0, " "), ("", 0, "\""), ("", 0, "."), ("", 0, "\">"),
    ("", 0, "\n"), ("", 3, ""), ("", 0, "]"), ("", 0, " for "), ("", 14, ""), ("", 2, ""),
    ("", 0, " a "), ("", 0, " that "), (" ", 10, ""), ("", 0, ". "), (".", 0, ""),
    (" ", 0, ", "), ("", 15, ""), ("", 0, " with "), ("", 0, "'"), ("", 0, " from "),
    ("", 0, " by "), ("", 16, ""), ("", 17, ""), (" the ", 0, ""), ("", 4, ""),
    ("", 0, ". The "), ("", 11, ""), ("", 0, " on "), ("", 0, " as "), ("", 0, " is "),
    ("", 7, ""), ("", 1, "ing "), ("", 0, "\n\t"), ("", 0, ":"), (" ", 0, ". "),
    ("", 0, "ed "), ("", 20, ""), ("", 18, ""), ("", 6, ""), ("", 0, "("), ("", 10, ", "),
    ("", 8, ""), ("", 0, " at "), ("", 0, "ly "), (" the ", 0, " of "), ("", 5, ""),
    ("", 9, ""), (" ", 10, ", "), ("", 10, "\""), (".", 0, "("), ("", 11, " "),
    ("", 10, "\">"), ("", 0, "=\""), (" ", 0, "."), (".com/", 0, ""), (" the ", 0, " of the "),
    ("", 10, "'"), ("", 0, ". This "), ("", 0, ","), (".", 0, " "), ("", 10, "("),
    ("", 10, "."), ("", 0, " not "), (" ", 0, "=\""), ("", 0, "er "), (" ", 11, " "),
    ("", 0, "al "), (" ", 11, ""), ("", 0, "='"), ("", 11, "\""), ("", 10, ". "),
    (" ", 0, "("), ("", 0, "ful "), (" ", 10, ". "), ("", 0, "ive "), ("", 0, "less "),
    ("", 11, "'"), ("", 0, "est "), (" ", 10, "."), ("", 11, "\">"), (" ", 0, "='"),
    ("", 10, ","), ("", 0, "ize "), ("", 11, "."), ("\xa0", 0, ""), (" ", 0, ","),
    ("", 10, "=\""), ("", 11, "=\""), ("", 0, "ous "), ("", 11, ", "), ("", 10, "='"),
    (" ", 10, ","), (" ", 11, "=\""), (" ", 11, ", "), ("", 11, ","), ("", 11, "("),
    ("", 11, ". "), (" ", 11, "."), ("", 11, "='"), (" ", 11, ". "), (" ", 10, "=\""),
    (" ", 11, "='"), (" ", 10, "='"),
]
# the prefixes and suffixes as UTF-8 (U+00A0 is the two bytes C2 A0)
TRANSFORMS = [(p.encode("utf-8"), t, s.encode("utf-8")) for p, t, s in _T]
del _T

# the literal context lookup tables (RFC 7932, 7.1)
_LUT0 = ([0] * 9 + [4, 4, 0, 0, 4, 0, 0] + [0] * 16
         + [8, 12, 16, 12, 12, 20, 12, 16, 24, 28, 12, 12, 32, 12, 36, 12]
         + [44] * 10 + [32, 32, 24, 40, 28, 12]
         + [12, 48, 52, 52, 52, 48, 52, 52, 52, 48, 52, 52, 52, 52, 52, 48]
         + [52, 52, 52, 52, 52, 48, 52, 52, 52, 52, 52, 24, 12, 28, 12, 12]
         + [12, 56, 60, 60, 60, 56, 60, 60, 60, 56, 60, 60, 60, 60, 60, 56]
         + [60, 60, 60, 60, 60, 56, 60, 60, 60, 60, 60, 24, 12, 28, 12, 0]
         + [0, 1] * 32 + [2, 3] * 32)
_LUT1 = ([0] * 32 + [0] + [1] * 15 + [2] * 10 + [1] * 6 + [1] + [2] * 26 + [1] * 5
         + [1] + [3] * 26 + [1] * 4 + [0] + [0] * 96 + [2] * 32)
_LUT2 = [0] + [1] * 15 + [2] * 48 + [3] * 64 + [4] * 64 + [5] * 48 + [6] * 15 + [7]


def _context_tables() -> List[bytes]:
    """The context id of (p1, p2) for each mode (LSB6, MSB6, UTF8, signed):
    a 65,536-entry table each, indexed p1 * 256 + p2."""
    out = []
    for mode in range(4):
        t = bytearray(65536)
        for p1 in range(256):
            base = p1 * 256
            if mode == 0:
                t[base:base + 256] = bytes([p1 & 0x3F]) * 256
            elif mode == 1:
                t[base:base + 256] = bytes([p1 >> 2]) * 256
            elif mode == 2:
                t[base:base + 256] = bytes(_LUT0[p1] | _LUT1[p2] for p2 in range(256))
            else:
                t[base:base + 256] = bytes((_LUT2[p1] << 3) | _LUT2[p2] for p2 in range(256))
        out.append(bytes(t))
    return out


_CONTEXTS: Optional[List[bytes]] = None
_DICTIONARY: Optional[bytes] = None

# insert-and-copy cells: (insert code base, copy code base, implicit distance 0)
_CELLS = [(0, 0, True), (0, 8, True), (0, 0, False), (0, 8, False), (8, 0, False),
          (8, 8, False), (0, 16, False), (16, 0, False), (8, 16, False), (16, 8, False),
          (16, 16, False)]
INSERT_CODES = [(0, 0), (1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (6, 1), (8, 1), (10, 2),
                (14, 2), (18, 3), (26, 3), (34, 4), (50, 4), (66, 5), (98, 5), (130, 6),
                (194, 7), (322, 8), (578, 9), (1090, 10), (2114, 12), (6210, 14), (22594, 24)]
COPY_CODES = [(2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (7, 0), (8, 0), (9, 0), (10, 1),
              (12, 1), (14, 2), (18, 2), (22, 3), (30, 3), (38, 4), (54, 4), (70, 5), (102, 5),
              (134, 6), (198, 7), (326, 8), (582, 9), (1094, 10), (2118, 24)]
BLOCK_COUNTS = [(1, 2), (5, 2), (9, 2), (13, 2), (17, 3), (25, 3), (33, 3), (41, 3), (49, 4),
                (65, 4), (81, 4), (97, 4), (113, 5), (145, 5), (177, 5), (209, 5), (241, 6),
                (305, 6), (369, 7), (497, 8), (753, 9), (1265, 10), (2289, 11), (4337, 12),
                (8433, 13), (16625, 24)]
# (insert length, copy length, extra bits, implicit distance) of each command symbol
_COMMANDS = []
for _sym in range(704):
    _ib, _cb, _implicit = _CELLS[_sym >> 6]
    _ins, _cop = INSERT_CODES[_ib + ((_sym >> 3) & 7)], COPY_CODES[_cb + (_sym & 7)]
    _COMMANDS.append((_ins, _cop, _implicit))
del _sym, _ib, _cb, _implicit, _ins, _cop
# the order in which the code-length code's lengths are read, and the fixed
# code they are read with: (length, value) by the next 4 bits
_CL_ORDER = [1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15]
_CL_LEN = [2, 2, 2, 3, 2, 2, 2, 4, 2, 2, 2, 3, 2, 2, 2, 4]
_CL_VAL = [0, 4, 3, 2, 0, 4, 3, 1, 0, 4, 3, 2, 0, 4, 3, 5]


class BrotliError(ValueError):
    """A malformed or unsupported Brotli stream."""


def dictionary() -> bytes:
    """The static dictionary, checked against its length and SHA-256."""
    global _DICTIONARY
    if _DICTIONARY is None:
        data = zlib.decompress(DICTIONARY_FILE.read_bytes())
        if len(data) != DICTIONARY_SIZE or hashlib.sha256(data).hexdigest() != DICTIONARY_SHA256:
            raise BrotliError(f"{DICTIONARY_FILE.name}: not RFC 7932's dictionary")
        _DICTIONARY = data
    return _DICTIONARY


class _Bits:
    """LSB-first bits of ``data``; past its end, zeros (and ``overrun``)."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.acc, self.n = data, 0, 0, 0

    def _fill(self, need: int) -> None:
        while self.n < need:
            chunk = self.data[self.pos:self.pos + 8]
            self.pos += 8
            if not chunk and self.pos > len(self.data) + 64:
                raise BrotliError("truncated stream")
            self.acc |= int.from_bytes(chunk.ljust(8, b"\0"), "little") << self.n
            self.n += 64

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.n < n:
            self._fill(n)
        v = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.n -= n
        return v

    def peek(self, n: int) -> int:
        if self.n < n:
            self._fill(n)
        return self.acc & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        self.acc >>= n
        self.n -= n

    def align(self) -> None:
        """Drop the bits up to the next byte boundary (they must be 0)."""
        r = self.n & 7
        if self.read(r):
            raise BrotliError("non-zero padding bits")

    def take_bytes(self, n: int) -> bytes:
        """``n`` whole bytes, after :meth:`align`."""
        out = bytearray()
        while self.n >= 8 and n > 0:
            out.append(self.read(8))
            n -= 1
        # the accumulator is empty (n was a multiple of 8): read straight on
        start = self.pos - self.n // 8 if self.n else self.pos
        self.acc, self.n = 0, 0
        out += self.data[start:start + n]
        if start + n > len(self.data):
            raise BrotliError("truncated uncompressed meta-block")
        self.pos = start + n
        return bytes(out)


class _Code:
    """A prefix code as a lookup table over its longest code's bits."""

    __slots__ = ("bits", "table")

    def __init__(self, lengths: List[int]):
        used = [(l, s) for s, l in enumerate(lengths) if l]
        if not used:
            raise BrotliError("a prefix code with no symbol")
        if len(used) == 1:
            self.bits, self.table = 0, [(used[0][1], 0)]
            return
        self.bits = max(l for l, _ in used)
        size = 1 << self.bits
        table: List[Optional[Tuple[int, int]]] = [None] * size
        code = 0
        prev_len = 0
        for length, sym in sorted(used):
            code <<= length - prev_len
            prev_len = length
            rev = int(f"{code:0{length}b}"[::-1], 2)
            entry = (sym, length)
            for i in range(rev, size, 1 << length):
                table[i] = entry
            code += 1
        if code != 1 << prev_len:
            raise BrotliError("an incomplete or over-full prefix code")
        self.table = table

    def read(self, bits: _Bits) -> int:
        if self.bits == 0:
            return self.table[0][0]
        sym, length = self.table[bits.peek(self.bits)]
        bits.skip(length)
        return sym


def _alphabet_bits(size: int) -> int:
    return max(1, (size - 1).bit_length())


def _read_code(bits: _Bits, alphabet: int) -> _Code:
    """A prefix code over ``alphabet`` symbols (RFC 7932, 3.4-3.5)."""
    hskip = bits.read(2)
    lengths = [0] * alphabet
    if hskip == 1:  # a simple prefix code
        nsym = bits.read(2) + 1
        width = _alphabet_bits(alphabet)
        syms = [bits.read(width) for _ in range(nsym)]
        if any(s >= alphabet for s in syms) or len(set(syms)) != nsym:
            raise BrotliError("a simple prefix code with a bad symbol")
        if nsym == 1:
            lengths[syms[0]] = 1  # one symbol: no bits
            code = _Code(lengths)
            return code
        shape = {2: [1, 1], 3: [1, 2, 2], 4: [2, 2, 2, 2]}[nsym]
        if nsym == 4 and bits.read(1):
            shape = [1, 2, 3, 3]
        for s, l in zip(syms, shape):
            lengths[s] = l
        return _Code(lengths)
    # a complex prefix code: the code-length code first
    cl = [0] * 18
    space, num = 32, 0
    for i in range(hskip, 18):
        v = bits.peek(4)
        bits.skip(_CL_LEN[v])
        v = _CL_VAL[v]
        cl[_CL_ORDER[i]] = v
        if v:
            space -= 32 >> v
            num += 1
            if space <= 0:
                break
    if not (num == 1 or space == 0):
        raise BrotliError("a bad code-length code")
    clcode = _Code(cl)
    sym, prev, repeat, repeat_len, space = 0, 8, 0, 0, 32768
    while sym < alphabet and space > 0:
        v = clcode.read(bits)
        if v < 16:
            repeat = 0
            lengths[sym] = v
            sym += 1
            if v:
                prev = v
                space -= 32768 >> v
            continue
        extra = 2 if v == 16 else 3
        new_len = prev if v == 16 else 0
        if repeat_len != new_len:
            repeat, repeat_len = 0, new_len
        old = repeat
        if repeat > 0:
            repeat = (repeat - 2) << extra
        repeat += bits.read(extra) + 3
        delta = repeat - old
        if sym + delta > alphabet:
            raise BrotliError("a code-length run past the alphabet")
        for _ in range(delta):
            lengths[sym] = repeat_len
            sym += 1
        if repeat_len:
            space -= delta << (15 - repeat_len)
    if space != 0:
        raise BrotliError("an incomplete or over-full prefix code")
    return _Code(lengths)


def _var_uint8(bits: _Bits) -> int:
    """NBLTYPES/NTREES: 1 to 256."""
    if not bits.read(1):
        return 1
    n = bits.read(3)
    return (1 << n) + bits.read(n) + 1


def _block_count(bits: _Bits, code: _Code) -> int:
    base, extra = BLOCK_COUNTS[code.read(bits)]
    return base + bits.read(extra)


def _context_map(bits: _Bits, size: int, ntrees: int) -> bytes:
    """A context map of ``size`` entries over ``ntrees`` trees (RFC 7932, 7.3)."""
    if ntrees < 2:
        return bytes(size)
    rle_max = bits.read(4) + 1 if bits.read(1) else 0
    code = _read_code(bits, ntrees + rle_max)
    out = bytearray()
    while len(out) < size:
        v = code.read(bits)
        if v == 0:
            out.append(0)
        elif v <= rle_max:
            out += bytes((1 << v) + bits.read(v))
        else:
            out.append(v - rle_max)
    if len(out) > size:
        raise BrotliError("a context map run past its end")
    if bits.read(1):  # the inverse move-to-front transform
        mtf = list(range(256))
        for i, v in enumerate(out):
            value = mtf[v]
            out[i] = value
            if v:
                del mtf[v]
                mtf.insert(0, value)
    return bytes(out)


class _Blocks:
    """One category's block types and counts (RFC 7932, 6)."""

    __slots__ = ("n", "type_code", "count_code", "type", "left", "rb")

    def __init__(self, bits: _Bits):
        self.n = _var_uint8(bits)
        self.type, self.rb = 0, [1, 0]
        if self.n >= 2:
            self.type_code = _read_code(bits, self.n + 2)
            self.count_code = _read_code(bits, 26)
            self.left = _block_count(bits, self.count_code)
        else:
            self.type_code = self.count_code = None
            self.left = 1 << 30

    def switch(self, bits: _Bits) -> None:
        t = self.type_code.read(bits)
        t = self.rb[0] if t == 0 else self.rb[1] + 1 if t == 1 else t - 2
        if t >= self.n:
            t -= self.n
        self.rb = [self.rb[1], t]
        self.type = t
        self.left = _block_count(bits, self.count_code)


def _transform(word: bytes, tid: int) -> bytes:
    prefix, kind, suffix = TRANSFORMS[tid]
    w = bytearray(word)
    if 1 <= kind <= 9:
        w = w[:max(0, len(w) - kind)]
    elif kind >= 12:
        w = w[kind - _OMIT_FIRST:]
    elif kind in (_UPPER_FIRST, _UPPER_ALL):
        i = 0
        while i < len(w):
            c = w[i]
            if c < 0xC0:
                if 97 <= c <= 122:
                    w[i] ^= 32
                step = 1
            elif c < 0xE0:
                if i + 1 < len(w):
                    w[i + 1] ^= 32
                step = 2
            else:
                if i + 2 < len(w):
                    w[i + 2] ^= 5
                step = 3
            if kind == _UPPER_FIRST:
                break
            i += step
    return prefix + bytes(w) + suffix


def _window_bits(bits: _Bits) -> int:
    if not bits.read(1):
        return 16
    n = bits.read(3)
    if n:
        return 17 + n
    m = bits.read(3)
    if m == 1:
        raise BrotliError("the large-window extension is not read")
    return 8 + m if m else 17


def decompress(data: bytes) -> bytes:
    """The bytes of one Brotli stream."""
    global _CONTEXTS
    if _CONTEXTS is None:
        _CONTEXTS = _context_tables()
    bits = _Bits(bytes(data))
    max_backward = (1 << _window_bits(bits)) - 16
    out = bytearray()
    dist_rb = [16, 15, 11, 4]  # the last distance is dist_rb[-1]
    while True:
        last = bits.read(1)
        if last and bits.read(1):  # ISLASTEMPTY
            break
        nibbles = bits.read(2)
        if nibbles == 3:  # a metadata block
            if bits.read(1):
                raise BrotliError("reserved bit set")
            nbytes = bits.read(2)
            skip = bits.read(8 * nbytes) + 1 if nbytes else 0
            bits.align()
            bits.take_bytes(skip)
            if last:
                break
            continue
        mlen = bits.read(4 * (nibbles + 4)) + 1
        if not last and bits.read(1):  # ISUNCOMPRESSED
            bits.align()
            out += bits.take_bytes(mlen)
            continue
        _meta_block(bits, mlen, out, dist_rb, max_backward)
        if last:
            break
    return bytes(out)


def _meta_block(bits: _Bits, mlen: int, out: bytearray, dist_rb: List[int],
                max_backward: int) -> None:
    lit, cmd, dst = _Blocks(bits), _Blocks(bits), _Blocks(bits)
    npostfix = bits.read(2)
    ndirect = bits.read(4) << npostfix
    modes = [bits.read(2) for _ in range(lit.n)]
    ntrees_l = _var_uint8(bits)
    cmap_l = _context_map(bits, 64 * lit.n, ntrees_l)
    ntrees_d = _var_uint8(bits)
    cmap_d = _context_map(bits, 4 * dst.n, ntrees_d)
    lit_codes = [_read_code(bits, 256) for _ in range(ntrees_l)]
    cmd_codes = [_read_code(bits, 704) for _ in range(cmd.n)]
    dist_codes = [_read_code(bits, 16 + ndirect + (48 << npostfix)) for _ in range(ntrees_d)]
    postfix_mask = (1 << npostfix) - 1
    contexts = _CONTEXTS
    words = None
    end = len(out) + mlen
    ctx_table = contexts[modes[0]]
    lit_base = 0
    while len(out) < end:
        if cmd.left == 0:
            cmd.switch(bits)
        cmd.left -= 1
        (ibase, iextra), (cbase, cextra), implicit = _COMMANDS[cmd_codes[cmd.type].read(bits)]
        insert = ibase + bits.read(iextra)
        copy = cbase + bits.read(cextra)
        for _ in range(insert):
            if lit.left == 0:
                lit.switch(bits)
                ctx_table = contexts[modes[lit.type]]
                lit_base = 64 * lit.type
            lit.left -= 1
            n = len(out)
            p1 = out[n - 1] if n else 0
            p2 = out[n - 2] if n > 1 else 0
            code = lit_codes[cmap_l[lit_base + ctx_table[(p1 << 8) | p2]]]
            out.append(code.read(bits))
        if len(out) >= end:
            if len(out) > end:
                raise BrotliError("literals past the meta-block's length")
            break
        if implicit:
            dcode = 0
        else:
            if dst.left == 0:
                dst.switch(bits)
            dst.left -= 1
            dctx = 3 if copy > 4 else copy - 2
            dcode = dist_codes[cmap_d[4 * dst.type + dctx]].read(bits)
        if dcode < 16:
            if dcode < 4:
                distance = dist_rb[-1 - dcode]
            else:
                base = dist_rb[-1] if dcode < 10 else dist_rb[-2]
                k = (dcode - 4) % 6
                distance = base + (-1 - k // 2 if k % 2 == 0 else 1 + k // 2)
            if distance <= 0:
                raise BrotliError("a distance of zero or less")
        elif dcode < 16 + ndirect:
            distance = dcode - 15
        else:
            d = dcode - ndirect - 16
            ndistbits = 1 + (d >> (npostfix + 1))
            hcode = d >> npostfix
            offset = ((2 + (hcode & 1)) << ndistbits) - 4
            distance = ((offset + bits.read(ndistbits)) << npostfix) + (d & postfix_mask) \
                + ndirect + 1
        max_distance = min(len(out), max_backward)
        if distance > max_distance:  # a static dictionary word
            if not 4 <= copy <= 24:
                raise BrotliError(f"a dictionary reference of length {copy}")
            if words is None:
                words = dictionary()
            address = distance - max_distance - 1
            word_id = address & ((1 << NDBITS[copy]) - 1)
            tid = address >> NDBITS[copy]
            if tid >= len(TRANSFORMS):
                raise BrotliError(f"transform {tid}")
            at = DOFFSET[copy] + copy * word_id
            word = _transform(words[at:at + copy], tid)
            if len(out) + len(word) > end:
                raise BrotliError("a dictionary word past the meta-block's length")
            out += word
            continue
        if dcode != 0:
            dist_rb.append(distance)
            del dist_rb[0]
        if len(out) + copy > end:
            raise BrotliError("a copy past the meta-block's length")
        start = len(out) - distance
        if distance >= copy:
            out += out[start:start + copy]
        else:  # an overlapping copy repeats the last `distance` bytes
            chunk = out[start:]
            reps, rest = divmod(copy, distance)
            out += chunk * reps + chunk[:rest]
