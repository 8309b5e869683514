"""Build and load the package's CUDA kernels.

The sources under ``fr_tpu_torch/csrc/`` have a plain C interface. At first
use each is compiled with nvcc for sm_90a into an object file, all of them
at once in parallel, and the objects are linked into one shared library
under ``fr_tpu_torch/_build/`` (listed in .gitignore), named by a hash of
the sources and flags so an edit rebuilds. The library is loaded with
ctypes: every pointer and the stream pass as ``c_void_p``. A missing nvcc or
a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("window_attn_fwd.cu", "window_attn_bwd.cu", "window_attn_stats.cu",
           "window_attn_spatial.cu", "window_attn_qkv.cu", "margin_ce.cu",
           "sparse_rows.cu", "batch_norm.cu", "global_attn.cu")
# included by the sources; hashed too
HEADERS = ("window_attn_common.cuh", "window_attn_bwd.cuh",
           "window_attn_tc.cuh")
# -Xptxas -v writes each kernel's registers, shared memory and spills to
# the build log next to the library.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.is_file():
            path = str(candidate)
    if path is None:
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                           "(default /usr/local/cuda); the CUDA kernels of "
                           "fr_tpu_torch cannot be built")
    return path


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfr_tpu_torch_{digest.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile the sources unless this exact build exists; returns the
    library's path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
            for name, obj in zip(SOURCES, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=900)
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} (exit code {proc.returncode}):\n"
                              f"{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link (exit code {proc.returncode}):\n"
                          f"{proc.stderr}")
    build_log_path().write_text("\n".join(log))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)   # atomic: a concurrent process never loads half a file
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64, f64 = ctypes.c_longlong, ctypes.c_double
    margin = [i32, f32, f32, f32, f32, f32, f32]   # kind, s, cos_m .. m
    signatures = {
        "window_attn_fwd": [vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32,
                            i32, i32, vp],
        "window_attn_bwd": [vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32,
                            i32, i32, i32, i32, vp],
        "window_attn_fwd_tc": [vp, vp, vp, vp, vp, i64, i32, i32, i32, i32,
                               i32, i32, i32, vp],
        "window_attn_bwd_tc": [vp, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32,
                               i32, i32, i32, i32, vp],
        "window_attn_fwd_stats": [vp, vp, vp, vp, vp, vp, i64, i32, i32, i32,
                                  i32, i32, i32, i32, vp],
        "window_attn_bwd_stats": [vp, vp, vp, vp, vp, vp, vp, i64, i32, i32,
                                  i32, i32, i32, vp],
        "window_attn_fwd_stats_tc": [*[vp] * 6, i64, *[i32] * 7, vp],
        "window_attn_bwd_stats_tc": [*[vp] * 7, i64, *[i32] * 5, vp],
        "window_attn_stats_tc_occupancy": [i32, i32, i32, i32, i32],
        "window_attn_spatial_fwd": [vp, vp, vp, vp, vp, i64, i32, i32, i32,
                                    i32, i32, i32, i32, i32, vp],
        "window_attn_spatial_bwd": [vp, vp, vp, vp, vp, vp, vp, vp, i64, i32,
                                    i32, i32, i32, i32, i32, i32, vp],
        "window_attn_spatial_fwd_tc": [vp, vp, vp, vp, vp, i64, i32, i32, i32,
                                       i32, i32, i32, i32, vp],
        "window_attn_spatial_bwd_tc": [vp, vp, vp, vp, vp, vp, vp, vp, i64,
                                       i32, i32, i32, i32, i32, i32, i32, vp],
        "window_attn_fwd_tc_occupancy": [i32, i32, i32, i32],
        "window_attn_bwd_tc_occupancy": [i32, i32, i32, i32],
        "window_attn_spatial_tc_occupancy": [i32, i32, i32, i32, i32],
        "window_attn_qkv_fwd": [vp, vp, vp, vp, vp, vp, vp, i64, i32, i32,
                                i32, i32, i32, i32, i32, vp],
        "window_attn_qkv_fwd_tc": [vp, vp, vp, vp, vp, vp, vp, i64, i32, i32,
                                   i32, i32, i32, i32, i32, vp],
        "window_attn_qkv_tc_occupancy": [i32, i32, i32, i32, i32],
        "window_attn_qkv_bwd_tc": [*[vp] * 14, i64, *[i32] * 7, vp],
        "window_attn_qkv_bwd_tc_occupancy": [i32, i32, i32, i32, i32],
        "window_attn_qkv_bwd": [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                vp, vp, i64, i32, i32, i32, i32, i32, i32,
                                i32, vp],
        "margin_ce_stats": [vp, vp, vp, vp, i32, i32, i32, i32, *margin, i32,
                            vp, vp, vp, vp, vp],
        "margin_ce_grad_emb": [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                               *margin, i32, vp, vp, vp],
        "margin_ce_grad_w": [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                             *margin, vp, vp],
        "margin_ce_grad_emb_tc": [*[vp] * 7, i32, i32, i32, i32, *margin,
                                  i32, vp, vp, i32, vp],
        "margin_ce_grad_w_tc": [*[vp] * 7, i32, i32, i32, i32, *margin, vp,
                                i32, vp],
        "margin_ce_grad_emb_tc_occupancy": [i32, i32],
        "margin_ce_stats_tc": [vp, vp, vp, vp, i32, i32, i32, i32, *margin,
                               i32, vp, vp, vp, vp, vp],
        "margin_ce_stats_tc_occupancy": [i32],
        "grouped_gather": [vp, vp, vp, i64, i64, i64, vp],
        "grouped_update_sgd": [vp, vp, vp, vp, i64, i64, i64, f64, f64, f64,
                               vp],
        "grouped_update_adamw": [vp, vp, vp, vp, vp, i64, i64, i64, f64, f64,
                                 f64, f64, f64, f64, f64, vp],
        "bn_scratch": [i32, i64, ctypes.POINTER(i64),
                       ctypes.POINTER(i32)],
        "bn_forward": [vp, vp, i32, i64, i64, *[vp] * 7, i64, vp, f64, f64,
                       f64, i32, vp],
        "bn_backward": [vp, vp, vp, i32, i64, i64, *[vp] * 7, i64, vp, i32,
                        i32, vp],
        "bn_eval": [vp, vp, i32, i64, i64, vp, vp, vp, vp, f64, i32, vp],
        "global_attn_fwd": [vp, vp, vp, i32, i32, i32, i32, i64, i64, f32,
                            vp],
        "global_attn_bwd": [vp, vp, vp, vp, i32, i32, i32, i32, i64, i64,
                            f32, vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raises when a launch entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
