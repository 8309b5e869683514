#!/usr/bin/env python3
"""Card measurements of the window-attention kernels beside chip_smoke.py,
for PERF.md. Needs one CUDA card and a checkout of the repository; bf16, at
the main path's shapes (chip_smoke.py's SHAPES, PERHEAD_SHAPES,
GROUPED_SHAPES, SPATIAL_SHAPES), CUDA events (chip_smoke.time_ms).

    python3 fr_tpu_torch/tools/attn_probe.py rows [--device] [--root DIR]
    python3 fr_tpu_torch/tools/attn_probe.py lanes
    python3 fr_tpu_torch/tools/attn_probe.py bwd
    python3 fr_tpu_torch/tools/attn_probe.py errors
    python3 fr_tpu_torch/tools/attn_probe.py mask
    python3 fr_tpu_torch/tools/attn_probe.py sass [--root DIR]

rows    each tensor-core and entry-fused row's time over its main-path mix
        (rows 1-4, 17, 17b, 18, 18b: the 12 AlterNet50 sites of one call;
        5-8: one Swin50 plus one EffiAlter_m call; 15, 16: one Swin50 call
        on the grouped route; rows 3, 4, 7, 8 are the stats pair, the
        backward fed the forward's p), from the checkout at --root
        (default: this one), and a SHA-256 of each row's outputs on its
        seeded inputs. To
        compare two trees on one card, run them in turns in one call:
        parent, change, change, parent; equal digests show that they
        compute the same bits. With --device a row's time is its kernels'
        device time (torch.profiler), not CUDA events over back-to-back
        calls, which hold the wrapper's host time where a call's kernels
        take less.
lanes   row 18's tensor-core forward per AlterNet50 site at every window
        lane count that fits, the count the wrapper picks, F.linear + row 1
        and F.linear alone.
bwd     row 18b's tensor-core backward per AlterNet50 site at every window
        lane count that fits (with the occupancy API's CTAs per SM), the
        count the wrapper picks, its kernels by part (chip_smoke's
        _qkv_bwd_parts: attend, dx, dW, sums, other) and the hybrid
        backward.
errors  row 18's tensor-core body against the plain version, at
        w = 0.1·randn and w = randn/√C: max-abs error, max |ref| and the
        share of output elements that differ.
mask    rows 1 and 18 at the AlterNet50 shapes with no mask, the shift
        mask (0 / −100), the same at −10, and zeros.
sass    builds the library of --root and prints a SHA-256 of each
        tensor-core attention kernel's machine code (cuobjdump -sass), to
        show that two trees compile a kernel to the same instructions.

Each prints its lines and, last, one JSON object of its numbers. A failed
launch raises.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import math
import sys
from pathlib import Path


def _setup(root):
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        raise SystemExit("attn_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch, chip_smoke


def _alternet_sites(cs, torch, gen):
    """(name, masked, sites, heads, (qkv, scale, bias16, g, mask, nW),
    (x, w, b)) at the AlterNet50 shapes: qkv ~ N(0, 1) for rows 1/2, and
    for row 18 x ~ N(0, 1), w = randn/√C (so qkv ~ N(0, 1) too) and b."""
    for name, bw, n, heads, res, ws, n_un, n_m in cs.SHAPES:
        c = heads * 32
        for masked, count in ((False, n_un), (True, n_m)):
            qkv, scale, bias16, g, mask, nw = cs._attention_inputs(
                bw, n, heads, res, ws, masked, torch.bfloat16, gen)
            x = torch.randn(bw, n, c, device="cuda",
                            generator=gen).to(torch.bfloat16)
            w = torch.randn(3 * c, c, device="cuda",
                            generator=gen) / math.sqrt(c)
            b = 0.1 * torch.randn(3 * c, device="cuda", generator=gen)
            yield (name, masked, count, heads, (qkv, scale, bias16, g, mask,
                                                nw), (x, w, b))


def _device_ms(torch, call, reps: int = 10) -> float:
    """Device ms per call: the time of the CUDA work in a torch.profiler
    trace of ``reps`` calls after one, divided by ``reps``."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / reps


def rows(torch, cs, device=False):
    from fr_tpu_torch.models.swin_common import shifted_window_mask
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.ops import fused_window_attn_variants as V

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(21)
    t = {k: 0.0 for k in ("1", "2", "3", "4", "5", "6", "7", "8", "15", "16",
                          "17", "17b", "18", "18b")}
    digest = {k: hashlib.sha256() for k in t}

    def timed(key, call):
        """call()'s time; the bits of its outputs go into the row's
        digest."""
        out = call()
        for o in out if isinstance(out, tuple) else (out,):
            if o is not None:
                digest[key].update(o.float().cpu().numpy().tobytes())
        return _device_ms(torch, call) if device else cs.time_ms(call)

    for _, _, count, heads, (qkv, scale, bias16, g, mask, nw), (
            x, w, b) in _alternet_sites(cs, torch, gen):
        t["1"] += count * timed("1", lambda: F.fused_window_attention_packed(
            qkv, scale, bias16, heads, nw, mask, out_dtype=bf))
        t["2"] += count * timed("2", lambda: F.window_attention_backward(
            qkv, scale, bias16, g, heads, nw, mask))
        t["3"] += count * timed("3", lambda: F.window_attention_forward_stats(
            qkv, scale, bias16, heads, nw, mask, out_dtype=bf))
        p = F.window_attention_forward_stats(qkv, scale, bias16, heads, nw,
                                             mask, out_dtype=bf)[1]
        t["4"] += count * timed("4", lambda: F.window_attention_backward_stats(
            qkv, scale, p, g, heads))
        t["18"] += count * timed("18", lambda: (
            V.fused_window_attention_packed_qkv(
                x, w, b, scale, bias16, heads, nw, mask, out_dtype=bf)))
        t["18b"] += count * timed("18b", lambda: V.qkv_attention_backward(
            x, w, b, scale, bias16, g, heads, nw, mask))
    for shape in cs.PERHEAD_SHAPES:
        *_, n_swin, n_effi = shape
        qkv, scale, bias16, g, mask, nw = cs._perhead_inputs(shape, bf, gen)
        heads = shape[2]
        t["5"] += (n_swin + n_effi) * timed(
            "5", lambda: F.fused_window_attention(qkv, scale, bias16, heads,
                                                  nw, mask, out_dtype=bf))
        t["6"] += (n_swin + n_effi) * timed(
            "6", lambda: F.window_attention_backward(qkv, scale, bias16, g,
                                                     heads, nw, mask))
        t["7"] += (n_swin + n_effi) * timed(
            "7", lambda: F.window_attention_forward_stats(
                qkv, scale, bias16, heads, nw, mask, out_dtype=bf))
        p = F.window_attention_forward_stats(qkv, scale, bias16, heads, nw,
                                             mask, out_dtype=bf)[1]
        t["8"] += (n_swin + n_effi) * timed(
            "8", lambda: F.window_attention_backward_stats(qkv, scale, p, g,
                                                           heads))
    for name, bw, heads, nw, sites in cs.GROUPED_SHAPES:
        qkv, scale, bias16, g, mask, nw = cs._perhead_inputs(
            (name, bw, heads, 32, nw, False), bf, gen)
        t["15"] += sites * timed("15", lambda: (
            F.fused_window_attention_packed(qkv, scale, bias16, heads, nw,
                                            mask, out_dtype=bf,
                                            head_group=4)))
        t["16"] += sites * timed("16", lambda: F.window_attention_backward(
            qkv, scale, bias16, g, heads, nw, mask))
    for name, res, ws, heads, n_un, n_m in cs.SPATIAL_SHAPES:
        c = heads * 32
        for masked, count in ((False, n_un), (True, n_m)):
            if count == 0:
                continue
            mask = (torch.from_numpy(shifted_window_mask(
                res, res, ws, ws // 2)).cuda() if masked else None)
            qkv = torch.randn(128, res, res, 3 * c, device="cuda",
                              generator=gen).to(bf)
            scale = torch.empty(heads, device="cuda").uniform_(
                5.0, 20.0, generator=gen)
            bias16 = 16 * torch.sigmoid(torch.randn(
                heads, ws * ws, ws * ws, device="cuda", generator=gen))
            g = torch.randn(128, res, res, c, device="cuda", generator=gen)
            t["17"] += count * timed(
                "17", lambda: V.fused_window_attention_spatial(
                    qkv, scale, bias16, heads, ws, mask))
            t["17b"] += count * timed(
                "17b", lambda: V.spatial_attention_backward(
                    qkv, scale, bias16, g, heads, ws, mask))
    print(f"[rows] {Path(cs.__file__).parent}: " + ", ".join(
        f"row {k} {v:.4f}" for k, v in t.items()) + " ms")
    bits = {k: h.hexdigest()[:16] for k, h in digest.items()}
    print("[rows] outputs' SHA-256: " + ", ".join(
        f"row {k} {v}" for k, v in bits.items()))
    return {"root": str(Path(cs.__file__).parent), "ms": t, "bits": bits}


def lanes(torch, cs):
    import torch.nn.functional as Fn

    from fr_tpu_torch.ops import _build
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.ops import fused_window_attn_variants as V

    bf = torch.bfloat16
    lib = _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(22)
    pick = V.qkv_tc_lanes
    out = {}
    for name, masked, count, heads, (_, scale, bias16, _, mask, nw), (
            x, w, b) in _alternet_sites(cs, torch, gen):
        _, n, c = x.shape

        def call():
            return V.fused_window_attention_packed_qkv(
                x, w, b, scale, bias16, heads, nw, mask, out_dtype=bf)

        def chain():
            q = Fn.linear(x, w.to(bf)) + b.to(bf)
            return F.fused_window_attention_packed(q, scale, bias16, heads,
                                                   nw, mask, out_dtype=bf)
        t, per_sm = {}, {}
        for lanes_ in range(1, V._QKV_MAX_LANES + 1):
            if V._qkv_tc_smem_bytes(n, c, c // heads, masked,
                                    lanes_) > 227 * 1024:
                break
            per_sm[lanes_] = lib.window_attn_qkv_tc_occupancy(
                n, c, heads, int(masked), lanes_)
            if per_sm[lanes_] <= 0:
                continue
            V.qkv_tc_lanes = lambda *a, _l=lanes_: _l
            V._qkv_tc_launch.cache_clear()
            t[f"L{lanes_}"] = cs.time_ms(call)
        V.qkv_tc_lanes = pick
        V._qkv_tc_launch.cache_clear()
        chosen = V._qkv_tc_launch(0, n, c, heads, masked)[0]
        t["chosen"] = cs.time_ms(call)
        t["linear_row1"] = cs.time_ms(chain)
        t["linear"] = cs.time_ms(lambda: Fn.linear(x, w.to(bf)) + b.to(bf))
        key = f"{name} {'masked' if masked else 'unmasked'}"
        out[key] = {"sites": count, "lanes": chosen, "ctas_per_sm": per_sm,
                    "ms": t}
        print(f"[lanes] {key} x{tuple(x.shape)} h{heads}: CTAs an SM by "
              f"lanes {per_sm}, chosen {chosen}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in t.items()) + " ms", flush=True)
    mix = {k: sum(v["sites"] * v["ms"][k] for v in out.values())
           for k in ("L1", "chosen", "linear_row1", "linear")}
    print("[lanes] 12-site mix: " + ", ".join(
        f"{k} {v:.4f}" for k, v in mix.items()) + " ms")
    return {"sites": out, "mix": mix}


def bwd(torch, cs):
    from fr_tpu_torch.ops import _build
    from fr_tpu_torch.ops import fused_window_attn_variants as V

    lib = _build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(23)
    pick = V.qkv_tc_lanes
    out = {}
    for name, masked, count, heads, (_, scale, bias16, g, mask, nw), (
            x, w, b) in _alternet_sites(cs, torch, gen):
        _, n, c = x.shape

        def call():
            return V.qkv_attention_backward(x, w, b, scale, bias16, g, heads,
                                            nw, mask)
        t, per_sm = {}, {}
        for lanes_ in range(1, V._QKV_MAX_LANES + 1):
            if V._qkv_bwd_tc_smem_bytes(n, c, c // heads, masked,
                                        lanes_) > 227 * 1024:
                break
            per_sm[lanes_] = lib.window_attn_qkv_bwd_tc_occupancy(
                n, c, heads, int(masked), lanes_)
            if per_sm[lanes_] <= 0:
                continue
            V.qkv_tc_lanes = lambda *a, _l=lanes_: _l
            V._qkv_tc_launch.cache_clear()
            t[f"L{lanes_}"] = cs.time_ms(call)
        V.qkv_tc_lanes = pick
        V._qkv_tc_launch.cache_clear()
        chosen = V._qkv_tc_launch(0, n, c, heads, masked, True)[0]
        t["chosen"] = cs.time_ms(call)
        t["hybrid"] = cs.time_ms(lambda: V.hybrid_backward(
            x, w, b, scale, bias16, g, heads, nw, mask))
        parts = cs._qkv_bwd_parts(call)
        key = f"{name} {'masked' if masked else 'unmasked'}"
        out[key] = {"sites": count, "lanes": chosen, "ctas_per_sm": per_sm,
                    "ms": t, "parts": parts}
        print(f"[bwd] {key} x{tuple(x.shape)} h{heads}: CTAs an SM by lanes "
              f"{per_sm}, chosen {chosen}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in t.items()) + " ms; parts "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + " ms",
              flush=True)
    mix = {k: sum(v["sites"] * v["ms"][k] for v in out.values())
           for k in ("L1", "chosen", "hybrid")}
    mix.update({k: sum(v["sites"] * v["parts"][k] for v in out.values())
                for k in ("attend", "dx", "dw", "sums", "other")})
    print("[bwd] 12-site mix: " + ", ".join(
        f"{k} {v:.4f}" for k, v in mix.items()) + " ms")
    return {"sites": out, "mix": mix}


def errors(torch, cs):
    from fr_tpu_torch.ops import fused_window_attn_variants as V

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for name, masked, _, heads, (_, scale, bias16, _, mask, nw), (
            x, w1, b) in _alternet_sites(cs, torch, gen):
        c = x.shape[2]
        for label, w in (("0.1*randn", 0.1 * w1 * math.sqrt(c)),
                         ("randn/sqrt(C)", w1)):
            def call():
                return V.fused_window_attention_packed_qkv(
                    x, w, b, scale, bias16, heads, nw, mask, out_dtype=bf)
            ref = V.window_attention_qkv_reference(x, w, b, scale, bias16,
                                                   heads, mask, bf).float()
            route, tc = cs._route_of(call)
            torch.cuda.synchronize()
            key = f"{name} {'masked' if masked else 'unmasked'} w={label}"
            out[key] = {
                "max_ref": ref.abs().max().item(),
                "err_tensor_cores": (tc.float() - ref).abs().max().item(),
                "differ_tensor_cores": (tc.float() != ref).float().mean()
                .item()}
            print(f"[errors] {key} ({route}): " + ", ".join(
                f"{k} {v:.3e}" for k, v in out[key].items()), flush=True)
    return out


def mask(torch, cs):
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.ops import fused_window_attn_variants as V

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for name, masked, _, heads, (qkv, scale, bias16, _, m, nw), (
            x, w, b) in _alternet_sites(cs, torch, gen):
        if not masked:
            continue
        t = {}
        for label, mk, k in (("none", None, 1), ("-100", m, nw),
                             ("-10", m / 10, nw), ("zeros", m * 0, nw)):
            t[f"row1 {label}"] = cs.time_ms(
                lambda: F.fused_window_attention_packed(
                    qkv, scale, bias16, heads, k, mk, out_dtype=bf))
            t[f"row18 {label}"] = cs.time_ms(
                lambda: V.fused_window_attention_packed_qkv(
                    x, w, b, scale, bias16, heads, k, mk, out_dtype=bf))
        out[name] = t
        print(f"[mask] {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + " ms", flush=True)
    return out


def sass(torch, cs):
    import re
    import subprocess

    from fr_tpu_torch.ops import _build

    so = _build.build()
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    # nvcc names each source's anonymous namespace with a hash that differs
    # between checkouts; it appears in kernel names and call targets
    anon = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+")
    out = {}
    for part in re.split(r"\n\s*Function : ", anon.sub(r"ANON_\1", text))[1:]:
        name, body = part.split("\n", 1)
        if re.search(r"window_attn_(fwd|bwd|qkv_fwd|qkv_bwd)(_stats)?"
                     r"_tc_kernel", name):
            # the instruction lines only (each carries a /* */ comment)
            code = "\n".join(ln for ln in body.splitlines() if "/*" in ln)
            out[name.strip()] = hashlib.sha256(code.encode()).hexdigest()[:16]
    for name, digest in sorted(out.items()):
        print(f"[sass] {digest} {name}")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", choices=("rows", "lanes", "bwd", "errors",
                                         "mask", "sass"))
    parser.add_argument("--device", action="store_true",
                        help="rows: device time (torch.profiler) in place "
                        "of CUDA events over back-to-back calls")
    parser.add_argument("--root", default=Path(__file__).resolve()
                        .parents[2], help="the checkout to measure")
    args = parser.parse_args()
    torch, cs = _setup(args.root)
    result = {"rows": functools.partial(rows, device=args.device),
              "lanes": lanes, "bwd": bwd, "errors": errors, "mask": mask,
              "sass": sass}[args.what](torch, cs)
    print(cs.nvidia_smi())
    print(json.dumps({args.what: result}))


if __name__ == "__main__":
    main()
