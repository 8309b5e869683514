"""The port's native host library (a copy of fr_tpu/native), loaded via
ctypes: threaded f64 pair and cross scoring, a u8 row gather and a libjpeg
decode pool. Host code; nothing here runs on the GPU.

``fr_native.cpp`` is compiled with g++ at first use, with libjpeg when it
links and else without, into ``fr_tpu_torch/_build/native/`` under a name
that hashes the source, the flags and the host CPU's feature flags
(``-march=native``), so an edit, or a copy of the tree on another machine,
rebuilds. The build goes to a temporary file that is renamed into place, so
processes that build at once never load a half-written library. Every entry
point returns None when the library is absent (no g++, a failed build, or
``FR_TPU_NO_NATIVE`` set in the environment), and its callers then take
their numpy path. Whether the library loaded is decided once per process,
at the first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "fr_native.cpp"
BUILD_DIR = _HERE.parent / "_build" / "native"
_BASE_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
               "-pthread")
# the libjpeg decode pool first; else scoring and gather alone
_VARIANTS = (("-DFR_HAVE_JPEG", "-ljpeg"), ())
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

NUM_BINS = 100001


def _cpu_features() -> bytes:
    """What -march=native compiles for: the CPU's feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.encode()
    except OSError:
        pass
    return platform.machine().encode()


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(_BASE_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    digest.update(_cpu_features())
    return BUILD_DIR / f"libfr_native_{digest.hexdigest()[:16]}.so"


def _compile() -> Optional[Path]:
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    for extra in _VARIANTS:
        try:
            subprocess.run(["g++", *_BASE_FLAGS, str(_SRC), "-o", str(tmp),
                            *extra], check=True, capture_output=True,
                           timeout=240)
        except (OSError, subprocess.SubprocessError):  # no g++, no libjpeg
            continue
        os.replace(tmp, so)
        return so
    tmp.unlink(missing_ok=True)
    return None


def load() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None without it."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("FR_TPU_NO_NATIVE"):
            return None
        so = _compile()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.pair_score_f32.argtypes = [f32p, f32p, u8p, i64, i64, f64p, f64p,
                                       f64p]
        lib.cross_score_f32.argtypes = [f32p, i64p, i64, i64, f64p, f64p,
                                        f64p, f64p]
        lib.gather_u8.argtypes = [u8p, i64p, i64, i64, u8p]
        lib.has_jpeg.restype = ctypes.c_int
        lib.decode_jpegs_rgb.argtypes = [u8p, i64p, i64, i64, u8p, u8p]
        lib.decode_jpegs_rgb.restype = i64
        _LIB = lib
        return _LIB


def available() -> bool:
    return load() is not None


def jpeg_available() -> bool:
    lib = load()
    return lib is not None and bool(lib.has_jpeg())


def pair_score_native(e1: np.ndarray, e2: np.ndarray, labels: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(genuine histogram, imposter histogram, scores) in f64, or None."""
    lib = load()
    if lib is None:
        return None
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    lab = np.ascontiguousarray(np.asarray(labels).astype(bool).astype(
        np.uint8))
    n, d = e1.shape
    hg = np.zeros(NUM_BINS, np.float64)
    hi = np.zeros(NUM_BINS, np.float64)
    scores = np.zeros(n, np.float64)
    lib.pair_score_f32(e1, e2, lab, n, d, hg, hi, scores)
    return hg, hi, scores


def cross_score_native(emb: np.ndarray, labels: np.ndarray
                       ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]]:
    """(genuine histogram, imposter histogram, scores, pair labels) over
    every pair i > j, i outer, or None."""
    lib = load()
    if lib is None:
        return None
    emb = np.ascontiguousarray(emb, np.float32)
    lab = np.ascontiguousarray(labels, np.int64)
    n, d = emb.shape
    total = n * (n - 1) // 2
    hg = np.zeros(NUM_BINS, np.float64)
    hi = np.zeros(NUM_BINS, np.float64)
    scores = np.zeros(total, np.float64)
    plab = np.zeros(total, np.float64)
    lib.cross_score_f32(emb, lab, n, d, hg, hi, scores, plab)
    return hg, hi, scores, plab


def decode_jpegs_native(blobs, out_size: int) -> Optional[np.ndarray]:
    """Threaded libjpeg decode + bilinear resize of a batch of raw JPEG byte
    strings → (n, out_size, out_size, 3) uint8 RGB. None if the decode pool
    is absent or any image failed (the caller falls back to cv2)."""
    lib = load()
    if lib is None or not lib.has_jpeg():
        return None
    n = len(blobs)
    offsets = np.zeros(n + 1, np.int64)
    for i, b in enumerate(blobs):
        offsets[i + 1] = offsets[i] + len(b)
    blob = np.frombuffer(b"".join(blobs), np.uint8)
    if blob.size == 0:
        return None
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    n_ok = lib.decode_jpegs_rgb(blob, offsets, n, out_size,
                                out.reshape(n, -1), ok)
    if int(n_ok) != n:
        return None
    return out


def gather_u8_native(images: np.ndarray, index: np.ndarray
                     ) -> Optional[np.ndarray]:
    """images[index] for a uint8 (N, ...) array by a threaded memcpy, or
    None."""
    lib = load()
    if lib is None:
        return None
    images = np.ascontiguousarray(images)
    idx = np.ascontiguousarray(index, np.int64)
    item = int(np.prod(images.shape[1:]))
    out = np.empty((len(idx),) + images.shape[1:], np.uint8)
    lib.gather_u8(images.reshape(len(images), -1), idx, len(idx), item,
                  out.reshape(len(idx), -1))
    return out
