"""bcolz rootdir reader with no bcolz dependency (a copy of
fr_tpu/data/bcolz_reader.py).

The reference stores its LFW-family validation sets as bcolz carrays
(reference utils/data_partial.py:67: `bcolz.carray(rootdir=..., mode='r')`).
bcolz is an unmaintained package that does not build on modern Pythons, but
its on-disk format is simple: JSON metadata plus one blosc-compressed chunk
per file:

    <rootdir>/
      meta/sizes      {"shape": [...], "nbytes": N, "cbytes": ...}
      meta/storage    {"dtype": ..., "cparams": {...}, "chunklen": ...}
      data/__0.blp    raw C-Blosc chunk (16-byte header + compressed blocks)
      data/__1.blp    ...

This module parses that layout directly and decompresses the chunks through
the system C-Blosc library (libblosc.so.1) via ctypes, the genuine decoder,
so every codec/shuffle/split combination bcolz can produce (blosclz, lz4,
zlib, zstd, byte/bit shuffle) round-trips exactly. The library is looked up
at the first call; without it `blosc_available()` is False and
data/pairs.py reads the `.npy`/`.npz` layout instead.
"""

from __future__ import annotations

import ast
import ctypes
import ctypes.util
import json
from pathlib import Path
from typing import Optional

import numpy as np

_BLOSC: Optional[ctypes.CDLL] = None
_BLOSC_TRIED = False


def load_blosc() -> Optional[ctypes.CDLL]:
    """The system C-Blosc, or None if the shared library is absent."""
    global _BLOSC, _BLOSC_TRIED
    if _BLOSC_TRIED:
        return _BLOSC
    _BLOSC_TRIED = True
    candidates = []
    found = ctypes.util.find_library("blosc")
    if found:
        candidates.append(found)
    candidates += ["libblosc.so.1", "libblosc.so", "libblosc.dylib"]
    for name in candidates:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        lib.blosc_decompress_ctx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        lib.blosc_compress_ctx.restype = ctypes.c_int
        lib.blosc_compress_ctx.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        lib.blosc_cbuffer_sizes.restype = None
        lib.blosc_cbuffer_sizes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)]
        _BLOSC = lib
        return _BLOSC
    return None


def blosc_available() -> bool:
    return load_blosc() is not None


def decompress_chunk(buf: bytes) -> bytes:
    """Decompress one raw blosc chunk (the content of a .blp file)."""
    lib = load_blosc()
    if lib is None:
        raise RuntimeError("libblosc not found — cannot decode blosc chunks")
    if len(buf) < 16:
        raise ValueError(f"blosc chunk shorter than its 16-byte header "
                         f"({len(buf)} bytes)")
    nbytes = ctypes.c_size_t()
    cbytes = ctypes.c_size_t()
    blocksize = ctypes.c_size_t()
    src = ctypes.create_string_buffer(buf, len(buf))
    lib.blosc_cbuffer_sizes(src, ctypes.byref(nbytes), ctypes.byref(cbytes),
                            ctypes.byref(blocksize))
    if nbytes.value == 0 or cbytes.value > len(buf):
        raise ValueError(f"corrupt blosc chunk (nbytes={nbytes.value}, "
                         f"cbytes={cbytes.value}, file={len(buf)} bytes)")
    out = ctypes.create_string_buffer(nbytes.value)
    rc = lib.blosc_decompress_ctx(src, out, nbytes.value, 1)
    if rc != nbytes.value:
        raise ValueError(f"blosc_decompress_ctx failed (rc={rc}, "
                         f"expected {nbytes.value})")
    return out.raw


def compress_chunk(data: bytes, typesize: int, cname: str = "blosclz",
                   clevel: int = 5, shuffle: int = 1) -> bytes:
    """Compress bytes into one blosc chunk (test fixtures / pack tooling)."""
    lib = load_blosc()
    if lib is None:
        raise RuntimeError("libblosc not found")
    src = ctypes.create_string_buffer(data, len(data))
    dest = ctypes.create_string_buffer(len(data) + 16 + 64)
    rc = lib.blosc_compress_ctx(clevel, shuffle, typesize, len(data), src,
                                dest, len(dest), cname.encode(), 0, 1)
    if rc <= 0:
        raise ValueError(f"blosc_compress_ctx failed (rc={rc})")
    return dest.raw[:rc]


def _parse_dtype(spec) -> np.dtype:
    """Parse the `meta/storage` dtype field across bcolz's variants.

    bcolz 1.x `write_meta` stores `repr(self.dtype)[6:-1]` — i.e. the text
    inside `dtype(...)`, WITH python-repr quoting: a plain base dtype
    serialises as `"'float32'"` (quotes embedded in the JSON string) and a
    compound atom as `"('<f4', (3, 112, 112))"`. Older/hand-written
    rootdirs use the bare `str(dtype)` form (`"float32"`). All three parse
    here: bare names via np.dtype, repr-quoted strings and atom tuples via
    ast.literal_eval."""
    s = str(spec)
    try:
        return np.dtype(s)
    except (TypeError, ValueError):
        pass
    return np.dtype(ast.literal_eval(s))


def read_carray(rootdir: str) -> np.ndarray:
    """Read a persistent bcolz carray rootdir into a numpy array."""
    root = Path(rootdir)
    meta = root / "meta"
    data = root / "data"
    if not meta.is_dir() or not data.is_dir():
        raise FileNotFoundError(f"{rootdir} is not a bcolz rootdir "
                                "(missing meta/ or data/)")
    sizes = json.loads((meta / "sizes").read_text())
    storage = json.loads((meta / "storage").read_text())
    shape = tuple(sizes["shape"])
    nbytes = int(sizes["nbytes"])
    dtype = _parse_dtype(storage["dtype"])
    # normalise a compound atom dtype into base dtype + trailing dims
    if dtype.subdtype is not None:
        base, sub = dtype.subdtype
        if len(shape) == 1:
            shape = shape + tuple(sub)
        dtype = base

    chunk_files = sorted(
        (p for p in data.iterdir()
         if p.name.startswith("__") and p.suffix == ".blp"
         and p.stem[2:].isdigit()),
        key=lambda p: int(p.stem[2:]))
    # bcolz names chunks data/__0.blp .. data/__{n-1}.blp contiguously
    # (carray_ext chunks._chunk_file_name); a gap means a damaged or
    # unknown layout — concatenating across it would silently misalign
    # every row after the hole, so fail loudly instead.
    indices = [int(p.stem[2:]) for p in chunk_files]
    if indices != list(range(len(indices))):
        raise ValueError(
            f"bcolz rootdir {rootdir}: non-contiguous chunk files "
            f"{[p.name for p in chunk_files]} — unknown layout variant")
    out = np.empty(nbytes, np.uint8)
    off = 0
    for f in chunk_files:
        raw = decompress_chunk(f.read_bytes())
        take = min(len(raw), nbytes - off)   # final chunk may be padded
        out[off:off + take] = np.frombuffer(raw, np.uint8, count=take)
        off += take
        if off >= nbytes:
            break
    if off < nbytes:
        raise ValueError(
            f"bcolz rootdir {rootdir}: chunks supply {off} of {nbytes} bytes "
            f"— unknown layout variant; convert it to the .npy layout with "
            f"bcolz installed")
    return out.view(dtype).reshape(shape)
