"""Write ``reranking_multimodal_retrievers_tpu_torch/data/brotli_dictionary.bin.z``:
Brotli's static dictionary (RFC 7932, Appendix A), zlib-compressed, as the
port's decoder (``data/brotli.py``) loads it.

The dictionary is taken from the Brotli C library's shared library
``libbrotlicommon`` (found by ``ctypes.util.find_library``, or the path
given as the first argument), which embeds it and hands it out through
``BrotliGetDictionary()``. Nothing is downloaded. The script checks the
length (122,784 bytes) and the SHA-256 below, which RFC 7932 states for
the dictionary, and that its first word is ``time``, before it writes.

    python tests/fixtures/make_brotli_dictionary.py [path/to/libbrotlicommon.so.1]
"""

import ctypes
import ctypes.util
import hashlib
import sys
import zlib
from pathlib import Path

SIZE = 122_784
SHA256 = "20e42eb1b511c21806d4d227d07e5dd06877d8ce7b3a817f378f313653f35c70"
OUT = (Path(__file__).resolve().parents[2] / "reranking_multimodal_retrievers_tpu_torch"
       / "data" / "brotli_dictionary.bin.z")


class _Dictionary(ctypes.Structure):
    # common/dictionary.h: BrotliDictionary
    _fields_ = [("size_bits_by_length", ctypes.c_uint8 * 32),
                ("offsets_by_length", ctypes.c_uint32 * 32),
                ("data_size", ctypes.c_size_t),
                ("data", ctypes.POINTER(ctypes.c_uint8))]


def extract(library: str) -> bytes:
    lib = ctypes.CDLL(library)
    lib.BrotliGetDictionary.restype = ctypes.POINTER(_Dictionary)
    d = lib.BrotliGetDictionary().contents
    data = ctypes.string_at(d.data, d.data_size)
    if len(data) != SIZE or hashlib.sha256(data).hexdigest() != SHA256:
        raise SystemExit(f"{library}: the dictionary found is not RFC 7932's "
                         f"({len(data)} bytes, sha256 {hashlib.sha256(data).hexdigest()})")
    if not data.startswith(b"timedownlifeleftback"):
        raise SystemExit(f"{library}: the dictionary does not start with its first words")
    return data


def main(argv) -> int:
    library = argv[1] if len(argv) > 1 else ctypes.util.find_library("brotlicommon")
    if not library:
        raise SystemExit("no libbrotlicommon found: give its path")
    OUT.write_bytes(zlib.compress(extract(library), 9))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes) from {library}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
