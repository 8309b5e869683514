#!/usr/bin/env python3
"""Card measurements of the margin-CE statistics kernel (row 9 of ROADMAP
§2) beside chip_smoke.py, for PERF.md. Needs one CUDA card and a checkout
of the repository; bf16 ArcFace at the ms1m_arcface_122 head (128, 512,
26,007) and the webface42m head (128, 512, 205,952; the step's own labels
and column mask), as chip_smoke.phase_margin_ce makes them.

    python3 fr_tpu_torch/tools/ce_probe.py stats
    python3 fr_tpu_torch/tools/ce_probe.py parts

stats   device time (torch.profiler) of each kernel that one call of the
        stats runs on the tensor-core body, and of the cuBLAS product
        emb @ W.T (not the same function), beside the CUDA-event time of
        back-to-back calls (which holds the wrapper's host time where the
        kernels take less); the byte bound and the
        tensor-core body's time per class tile of a CTA.
parts   what the tensor-core kernel's time is made of: builds copies of
        csrc/margin_ce.cu with one part taken out or changed (the online
        softmax, the mma product, both; every W tile
        copied from the split's first one, so that W comes from L2) into
        libraries of their own and gives each one's device time. The copies compute nothing
        right; only the whole kernel is checked.

Each prints its lines and, last, one JSON object of its numbers. A failed
launch raises.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _setup():
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        raise SystemExit("ce_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch, chip_smoke


def _heads(torch, cs):
    """(K, (emb, w, labels, col_valid), cfg) at both heads, bf16 ArcFace."""
    from fr_tpu_torch.heads.partial_fc import PFCConfig

    gen = torch.Generator(device="cuda").manual_seed(2)
    for n, d, k in (cs.CE_SHAPE, cs.CE_WEBFACE_SHAPE):
        def unit(*shape):
            x = torch.randn(*shape, device="cuda", generator=gen)
            return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        emb, w = unit(n, d), unit(k, d)
        if (n, d, k) == cs.CE_WEBFACE_SHAPE:
            labels, cv = cs._webface_ce_columns(gen)
        else:
            labels = torch.randint(-1, k - 3, (n,), device="cuda",
                                   generator=gen)
            cv = torch.arange(k, device="cuda") < k - 3
        cfg = PFCConfig(num_classes=k, embedding_size=d, margin="ArcFace",
                        s=30.0, m=0.35, mixed_precision=True)
        yield k, (emb, w, labels, cv), cfg


def _device_ms(torch, call, reps: int = 20) -> dict:
    """{kernel name: device ms per call} over ``reps`` calls after three,
    from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def _short(name):
    """A kernel's name without its namespace, template arguments and
    parameters."""
    import re
    found = re.search(r"([A-Za-z_]\w*)\s*(?:<.*?>)?\(",
                      name.replace("(anonymous namespace)::", ""))
    return found.group(1) if found else name[:48]


def stats(torch, cs):
    from fr_tpu_torch.ops import fused_pfc as F

    out = {}
    for k, args, cfg in _heads(torch, cs):
        def call():
            return F.margin_ce_stats(*args, cfg)
        kernels = _device_ms(torch, call)
        row = {"tensor_cores": {
            "device_ms": sum(kernels.values()),
            "events_ms": cs.time_ms(call),
            "kernels": {_short(n): v for n, v in kernels.items()}}}
        emb, w = args[:2]
        row["cublas_device_ms"] = sum(_device_ms(
            torch, lambda: emb @ w.t()).values())
        bound, by = cs._ce_bound("margin_ce_stats", (128, 512, k))
        splits = F.tc_splits(128, k, torch.cuda.get_device_properties(
            0).multi_processor_count)
        tiles = -(-k // 64) / splits
        tc = row["tensor_cores"]
        print(f"[stats] K={k:,}: tensor cores {tc['device_ms']:.4f} ms of "
              f"device time ({tc['kernels']}), events {tc['events_ms']:.4f}; "
              f"cuBLAS emb @ W.T "
              f"{row['cublas_device_ms']:.4f}; bound {bound:.4f} ({by}); "
              f"{tiles:.1f} class tiles a CTA, "
              f"{1e3 * tc['device_ms'] / tiles:.2f} us a tile")
        out[k] = row
    return out


# (name, [(text of csrc/margin_ce.cu, its replacement)]): the parts taken
# out of margin_ce_stats_tc_kernel
_PARTS = {
    "whole": [],
    "no_softmax": [(
        "    tc_stats_fold(raw, c, label, mg, m, d, t);\n",
        "    d[0] += raw[0][0] + raw[1][1] + raw[2][2] + raw[3][3];\n")],
    "no_mma": [(
        "    tc_logits64(raw, es, ws + grp * kTcTile * ld, wr, D);\n",
        "    for (int j = 0; j < 32; ++j)\n"
        "      raw[j / 4][j % 4] = __bfloat162float(\n"
        "          ws[grp * kTcTile * ld + threadIdx.x + 32 * j]);\n")],
    "w_from_l2": [(
        "      stats_copy_rows(ws + (i & 1) * kTcTile * ld, w, tile * kTcTile,",
        "      stats_copy_rows(ws + (i & 1) * kTcTile * ld, w, "
        "t_begin * kTcTile,")],
}
_PARTS["copies_only"] = _PARTS["no_softmax"] + _PARTS["no_mma"]


def _part_libraries():
    """{part: (library, nvcc's log)}: each copy of csrc/margin_ce.cu built
    by its own nvcc, all at once, under the gitignored build directory."""
    from fr_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "ce_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in _PARTS.items():
        src = (_build.CSRC / "margin_ce.cu").read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"ce_probe: part {name}: the text to "
                                 f"replace is not in margin_ce.cu once")
            src = src.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"ce_probe: part {name}: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.margin_ce_stats_tc.argtypes = [vp, vp, vp, vp, *[i32] * 5,
                                           *[f32] * 6, i32, *[vp] * 5]
        lib.margin_ce_stats_tc.restype = i32
        libs[name] = (lib, log)
    return libs


def parts(torch, cs):
    from fr_tpu_torch.ops import fused_pfc as F
    from fr_tpu_torch.ops._build import check_launch, load_library

    slots = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    libs = _part_libraries()
    for k, args, cfg in _heads(torch, cs):
        emb, w, labels, cv, N, K, D, code = F._operands(*args, cfg)
        splits = F.tc_splits(N, K, slots)
        partial = torch.empty((3, splits, N), device="cuda")
        mdt = torch.empty((3, N), device="cuda")
        row = {}
        for name, (lib, _) in libs.items():
            def call(lib=lib, name=name):
                err = lib.margin_ce_stats_tc(
                    emb.data_ptr(), w.data_ptr(), labels.data_ptr(),
                    cv.data_ptr(), N, K, D, code, *F._margin_args(cfg),
                    splits, partial.data_ptr(), mdt[0].data_ptr(),
                    mdt[1].data_ptr(), mdt[2].data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                check_launch(load_library(), err, name)
            kernels = _device_ms(torch, call)
            row[name] = next(v for n, v in kernels.items()
                             if "margin_ce_stats_tc_kernel" in n)
            if name == "whole":
                ref = F.margin_ce_stats_reference(*args, cfg)
                call()
                rel = cs._ce_stats_rel(tuple(mdt), ref)
                if rel > cs.CE_STATS_RTOL:
                    raise SystemExit(f"ce_probe: the whole kernel is off "
                                     f"by {rel}")
        print(f"[parts] K={k:,}: margin_ce_stats_tc_kernel device ms "
              + ", ".join(f"{n} {v:.4f}" for n, v in row.items()))
        out[k] = row
    for name, (_, log) in libs.items():
        print(f"[parts] {name}: " + "; ".join(
            f"{kernel} {regs} registers, spills {st}/{ld} B"
            for kernel, _, regs, st, ld in cs._ptxas_table(log)
            if "stats_tc" in kernel))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=("stats", "parts"))
    args = parser.parse_args()
    torch, cs = _setup()
    result = {"stats": stats, "parts": parts}[args.what](torch, cs)
    print(cs.nvidia_smi())
    print(json.dumps({args.what: result}))


if __name__ == "__main__":
    main()
