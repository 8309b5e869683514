#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (fr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs no flag

Phases; any failure exits non-zero and prints no result:
 1. require CUDA and the port's sources;
 2. build the CUDA kernels from fr_tpu_torch/csrc (one nvcc per source, in
    parallel, sm_90a) and print each kernel's registers and spills;
 3. hold every kernel against its plain PyTorch version and time both, and
    the nearest library call (F.scaled_dot_product_attention, not the same
    function): the window-attention forward and backward at the AlterNet50
    shapes (192 px, 128 images), masked and unmasked, bf16 and f32; the
    three margin-softmax CE kernels at the ms1m_arcface_122 head (128 rows,
    emd 512, 26,007 sampled columns), ArcFace and CosFace, bf16 and f32;
    [kernel_perhead] the same forward and backward kernels at the Swin50
    and EffiAlter_m N=49 shapes (112 px, 128 images; head dims 32 and 38)
    and a shift-masked one; [kernel_stats] the stored-stats forward and
    backward at the N=49 and AlterNet50 shapes, against their plain
    versions and the recompute kernels, with bitwise repeatable sums;
 4. [main] drive the serving path once through the CLI (--mode test,
    AlterNet50 at full width: 192 px, emd 512, bf16; 256 synthetic pairs,
    64 pairs per call): forward launches = 12 per encoder call, finite
    unit-norm embeddings, the ROC report; then time the embedding step at
    128 images per call;
 5. hold full-width AlterNet50 against fr_tpu's golden embeddings
    (tests/data/alternet50_golden.npz): f32 with TF32 off, and bf16;
 6. [train] drive the training CLI (--mode train, AlterNet50 at full width,
    bf16, b=128, 128 synthetic classes × 8 images, 6 epochs): 12 forward
    and 12 backward attention launches per step, a finite loss whose last
    epoch's mean is below the first's, the ROC report at epoch 5, the
    encoder snapshot;
 7. [train_full_head] FaceRecognitionTask.training_step at the full
    ms1m_arcface_122 head (86,690 classes, sample_rate 0.3, b=128, random
    images and labels), use_fused off and then on from the same seed: each
    margin-CE kernel launches once per fused step, the first 3 losses agree
    to 2e-2 relative; ms per step and images/s for both;
 8. [train_golden] two SGD steps of full-width AlterNet50 in f32 (TF32 off)
    against fr_tpu's training golden (tests/data/alternet50_train_golden.npz);
    [alternet50] three training steps with FR_ATTN_STORED_STATS=1 against
    =0: the packed entry's stats kernels launch, the losses agree to 1e-3;
    one f32 encoder backward under each arm: every parameter's gradient
    agrees norm-wise to 1e-3;
 9. [swin50] and [effialter_m], each at full width (112 px, emd 512, bf16):
    the serving CLI (14 and 4 per-head launches per encoder call), the
    goldens (tests/data/{swin50,effialter_m}_golden.npz: f32 max-abs 1e-3,
    bf16 per-row cosine 0.99), the training CLI (b=128, 10 epochs: 14/14
    and 4/4 forward/backward launches per step, a finite loss whose last
    epoch is below the first), and three training steps with
    FR_ATTN_STORED_STATS=1 against =0 (stats launches seen, losses within
    1e-3 relative, f32 encoder gradients norm-wise within 1e-3; the
    variable is restored);
10. [swin50_train_golden] two SGD steps of full-width Swin50 in f32 against
    tests/data/swin50_train_golden.npz;
11. [profile] torch.profiler over 5 training steps of Swin50 and of
    EffiAlter_m (bf16, b=128, the full ms1m head at sample_rate 0.3): wall
    per step, device busy, idle share, launches per step, time by family.

Every kernel's launches in the JSON line are counted on its main path
(phases 4, 6, 7, 8 and 9), each run with the counts set to 0 just before it.

The last three lines are the kernel JSON line, the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "alternet50_golden.npz"
TRAIN_GOLDEN = ROOT / "tests" / "data" / "alternet50_train_golden.npz"
F32_TOL = 5e-5      # kernel vs plain version, TF32 off
BF16_TOL = 3.2e-2   # two bf16 ulps at |x| < 4: p and the output round to bf16
# margin-CE kernels vs plain versions: statistics rtol 1e-4 (logit rounding
# ×s=30 through exp); gradients norm-wise 1e-4 (f32) and 1e-2 (bf16: coeff
# rounds to bf16 before the products)
CE_STATS_RTOL = 1e-4
CE_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
CE_SHAPE = (128, 512, 26007)   # ms1m_arcface_122: b, emd, int(0.3·86,690)
# AlterNet50 at 192 px, 128 images: (stage, B·nW, N, heads, resolution,
# window, launches per encoder call unmasked, masked)
SHAPES = [("stage2", 2048, 36, 4, 24, 6, 1, 1),
          ("stage3", 512, 36, 8, 12, 6, 4, 4),
          ("stage4", 512, 9, 16, 6, 3, 1, 1)]
CLI_ARGS = ["--config", "ms1m_arcface_122", "--mode", "test",
            "--network", "AlterNet50", "--synthetic", "--test_b", "64",
            "--device", "cuda"]
TRAIN_ARGS = ["--config", "ms1m_arcface_122", "--mode", "train",
              "--network", "AlterNet50", "--synthetic", "--num_epoch", "6",
              "--device", "cuda"]
FULL_HEAD_SAMPLE_RATE = 0.3   # ms1m_arcface_122's own sample_rate
SWIN_TRAIN_GOLDEN = ROOT / "tests" / "data" / "swin50_train_golden.npz"
NET_GOLDENS = [ROOT / "tests" / "data" / f"{n}_golden.npz"
               for n in ("swin50", "effialter_m")]
# Swin50 and EffiAlter_m at 112 px, 128 images, N = 49: (name, B·nW, heads,
# head dim, windows per image, shift-masked, launches per Swin50 encoder
# call, per EffiAlter_m call). Swin50 stage 4 and EffiAlter_m stage 7 share
# one shape; the masked case is the shift-3 mask over 14×14, reached at
# other image sizes only.
PERHEAD_SHAPES = [("swin50_s3", 512, 8, 32, 4, False, 4, 0),
                  ("n49_h16", 128, 16, 32, 1, False, 10, 2),
                  ("effialter_m_s6", 128, 8, 38, 1, False, 0, 2),
                  ("swin50_s3_masked", 512, 8, 32, 4, True, 0, 0)]
# attention launches per encoder call (and per training step, backward)
NET_LAUNCHES = {"AlterNet50": 12, "Swin50": 14, "EffiAlter_m": 4}
# the training CLI's epochs for Swin50 and EffiAlter_m: the 5 warm-up
# epochs and 5 of cosine decay (at 6, EffiAlter_m's last epoch sat only 0.05
# below its first, after the warm-up's rise)
NET_EPOCHS = 10


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)


def phase_build():
    from fr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> "
          f"{_build.library_path().relative_to(ROOT)}")
    for line in _build.build_log_path().read_text().splitlines():
        if ("Compiling entry function" in line or "registers" in line
                or "spill" in line):
            print(f"[build] {line.strip()}")


def phase_kernel():
    """Kernel vs plain version; returns (max error, per-call ms table)."""
    import torch
    from fr_tpu_torch.models.swin_common import shifted_window_mask
    from fr_tpu_torch.ops.fused_window_attn import (
        fused_window_attention_packed as kernel, window_attention_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, times = 0.0, {}
    for name, bw, n, heads, res, ws, _, _ in SHAPES:
        c = heads * 32
        for masked in (False, True):
            mask = (torch.from_numpy(shifted_window_mask(res, res, ws, ws // 2)
                                     ).cuda() if masked else None)
            nw = mask.shape[0] if masked else 1
            for dt, tol in ((torch.bfloat16, BF16_TOL),
                            (torch.float32, F32_TOL)):
                qkv = torch.randn(bw, n, 3 * c, device="cuda",
                                  generator=gen).to(dt)
                scale = torch.exp(torch.empty(heads, device="cuda").uniform_(
                    1.609, 2.996, generator=gen))          # ln 5 .. ln 20
                bias16 = 16 * torch.sigmoid(torch.randn(
                    heads, n, n, device="cuda", generator=gen))
                args = (qkv, scale, bias16, heads)
                out = kernel(*args, nw, mask, out_dtype=dt)
                torch.cuda.synchronize()
                ref = window_attention_reference(*args, mask, dt)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()),
                      f"{name} kernel output is not finite")
                err = (out.float() - ref.float()).abs().max().item()
                ms = time_ms(lambda: kernel(*args, nw, mask, out_dtype=dt))
                plain = time_ms(lambda: window_attention_reference(
                    *args, mask, dt))
                lib = (_library_fwd_ms(qkv, scale, bias16, mask, heads)
                       if dt == torch.bfloat16 else None)
                tag = f"{name} {'masked' if masked else 'unmasked'} " \
                      f"{str(dt).split('.')[-1]}"
                print(f"[kernel] {tag:26s} ({bw},{n},{3 * c}) "
                      f"max_abs_err {err:.3e} (tol {tol:g})  kernel "
                      f"{ms:.4f} ms  plain {plain:.4f} ms" +
                      (f"  sdpa {lib:.4f} ms" if lib is not None else ""))
                check(err <= tol, f"{tag}: error {err} > {tol}")
                worst = max(worst, err)
                times[(name, masked, dt)] = (ms, plain, lib)
    return worst, times


def _attention_inputs(bw, n, heads, res, ws, masked, dt, gen):
    import torch
    from fr_tpu_torch.models.swin_common import shifted_window_mask

    c = heads * 32
    mask = (torch.from_numpy(shifted_window_mask(res, res, ws, ws // 2)
                             ).cuda() if masked else None)
    qkv = torch.randn(bw, n, 3 * c, device="cuda", generator=gen).to(dt)
    scale = torch.empty(heads, device="cuda").uniform_(5.0, 20.0,
                                                      generator=gen)
    bias16 = 16 * torch.sigmoid(torch.randn(heads, n, n, device="cuda",
                                            generator=gen))
    g = torch.randn(bw, n, c, device="cuda", generator=gen).to(dt)
    return qkv, scale, bias16, g, mask, (mask.shape[0] if masked else 1)


def phase_kernel_bwd():
    """Backward kernel vs plain version; returns (max error, per-call ms
    table). Tolerance: f32 5e-5·max(|ref|, 1), bf16 two bf16 ulps of the
    largest |ref|."""
    import math
    import torch
    from fr_tpu_torch.ops.fused_window_attn import (
        window_attention_backward as kernel,
        window_attention_backward_reference as plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst, times = 0.0, {}
    for name, bw, n, heads, res, ws, _, _ in SHAPES:
        for masked in (False, True):
            for dt in (torch.bfloat16, torch.float32):
                qkv, scale, bias16, g, mask, nw = _attention_inputs(
                    bw, n, heads, res, ws, masked, dt, gen)
                ours = kernel(qkv, scale, bias16, g, heads, nw, mask)
                torch.cuda.synchronize()
                ref = plain(qkv, scale, bias16, g, heads, mask)
                tag = f"{name} {'masked' if masked else 'unmasked'} " \
                      f"{str(dt).split('.')[-1]}"
                errs = []
                for t_name, a, b in zip(("dqkv", "dscale", "dbias"), ours,
                                        ref):
                    check(bool(torch.isfinite(a).all()),
                          f"{tag} {t_name} is not finite")
                    mag = b.float().abs().max().item()
                    tol = (F32_TOL * max(mag, 1.0) if dt == torch.float32
                           else 2.0 * 2.0 ** (math.floor(math.log2(mag)) - 7))
                    err = (a.float() - b.float()).abs().max().item()
                    check(err <= tol, f"{tag} {t_name}: error {err} > {tol}")
                    errs.append(f"{t_name} {err:.2e}/{tol:.1e}")
                    worst = max(worst, err)
                ms = time_ms(lambda: kernel(qkv, scale, bias16, g, heads, nw,
                                            mask))
                plain_ms = time_ms(lambda: plain(qkv, scale, bias16, g,
                                                 heads, mask))
                lib = (_library_bwd_ms(qkv, scale, bias16, mask, heads, g)
                       if dt == torch.bfloat16 else None)
                print(f"[kernel_bwd] {tag:26s} err/tol {', '.join(errs)}  "
                      f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms" +
                      (f"  sdpa {lib:.4f} ms" if lib is not None else ""))
                times[(name, masked, dt)] = (ms, plain_ms, lib)
    again = kernel(qkv, scale, bias16, g, heads, nw, mask)
    check(all(torch.equal(a, b) for a, b in zip(ours, again)),
          "the backward kernel's sums changed between two runs")
    return worst, times


def phase_margin_ce():
    """The three margin-CE kernels vs their plain versions at the
    ms1m_arcface_122 head; returns ({kernel: max abs error}, {kernel: (ms,
    plain ms)} in bf16 ArcFace)."""
    import torch
    from fr_tpu_torch.heads.partial_fc import PFCConfig
    from fr_tpu_torch.ops import fused_pfc as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"margin_ce_stats": 0.0, "margin_ce_grad_emb": 0.0,
             "margin_ce_grad_w": 0.0}
    times = {}
    for margin, (n, d, k), dt in (
            ("ArcFace", CE_SHAPE, torch.bfloat16),
            ("ArcFace", CE_SHAPE, torch.float32),
            ("CosFace", CE_SHAPE, torch.bfloat16),
            ("ArcFace", (10, 40, 131), torch.float32)):
        def unit(*shape):
            x = torch.randn(*shape, device="cuda", generator=gen)
            return (x / x.norm(dim=1, keepdim=True)).to(dt)
        emb, w = unit(n, d), unit(k, d)
        labels = torch.randint(-1, k - 3, (n,), device="cuda", generator=gen)
        cv = torch.arange(k, device="cuda") < k - 3
        g = torch.rand(n, device="cuda", generator=gen) + 0.5
        cfg = PFCConfig(num_classes=k, embedding_size=d, margin=margin,
                        s=30.0, m=0.35,
                        mixed_precision=dt == torch.bfloat16)
        args = (emb, w, labels, cv)
        stats = F.margin_ce_stats(*args, cfg)
        ref = F.margin_ce_stats_reference(*args, cfg)
        torch.cuda.synchronize()
        for a, b in zip(stats, ref):
            rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
            check(rel <= CE_STATS_RTOL, f"{margin} {dt} stats rel {rel}")
        loss = lambda mdt: -torch.log(torch.clamp_min(  # noqa: E731
            mdt[2] / mdt[1], 1e-30))
        stats_err = (loss(stats) - loss(ref)).abs().max().item()
        m, dd, _ = ref
        ge = F.margin_ce_grad_emb(*args, m, dd, g, cfg)
        gw = F.margin_ce_grad_w(*args, m, dd, g, cfg)
        rge, rgw = F.margin_ce_backward_reference(*args, m, dd, g, cfg)
        torch.cuda.synchronize()
        tol = CE_GRAD_RTOL[str(dt).split(".")[-1]]
        errs = {"margin_ce_stats": stats_err}
        for name, a, b in (("margin_ce_grad_emb", ge, rge),
                           ("margin_ce_grad_w", gw, rgw)):
            check(bool(torch.isfinite(a).all()), f"{name} is not finite")
            rel = ((a - b).norm() / b.norm()).item()
            check(rel <= tol, f"{margin} {dt} {name}: norm-wise {rel} > {tol}")
            errs[name] = (a - b).abs().max().item()
        for name, err in errs.items():
            worst[name] = max(worst[name], err)
        tag = f"{margin} ({n},{d},{k}) {str(dt).split('.')[-1]}"
        print(f"[margin_ce] {tag:32s} loss err {stats_err:.2e}, grad_emb "
              f"{errs['margin_ce_grad_emb']:.2e}, grad_w "
              f"{errs['margin_ce_grad_w']:.2e} (max abs)")
        if (n, d, k) == CE_SHAPE and dt == torch.bfloat16 \
                and margin == "ArcFace":
            def plain_emb():
                c = F.margin_ce_coeff_reference(*args, m, dd, g, cfg)
                return c.to(dt).float() @ w.float()

            def plain_w():
                c = F.margin_ce_coeff_reference(*args, m, dd, g, cfg)
                return c.to(dt).float().t() @ emb.float()
            pairs = {
                "margin_ce_stats": (lambda: F.margin_ce_stats(*args, cfg),
                                    lambda: F.margin_ce_stats_reference(
                                        *args, cfg)),
                "margin_ce_grad_emb": (lambda: F.margin_ce_grad_emb(
                    *args, m, dd, g, cfg), plain_emb),
                "margin_ce_grad_w": (lambda: F.margin_ce_grad_w(
                    *args, m, dd, g, cfg), plain_w)}
            for name, (kern, plain) in pairs.items():
                times[name] = (time_ms(kern), time_ms(plain))
                print(f"[margin_ce] {name:20s} kernel {times[name][0]:.4f} "
                      f"ms  plain {times[name][1]:.4f} ms")
    return worst, times


class _EncoderCalls:
    """Counts forward calls of one encoder class (AlterNet by default) in
    training and in eval mode."""

    def __init__(self, cls=None):
        import torch
        from fr_tpu_torch.models.alternet import AlterNet

        cls = cls or AlterNet
        self.counts = {"train": 0, "eval": 0}

        def hook(module, args, output):
            if isinstance(module, cls):
                self.counts["train" if module.training else "eval"] += 1

        self.handle = torch.nn.modules.module.register_module_forward_hook(
            hook)

    def close(self):
        self.handle.remove()


def phase_main_path():
    """The CLI's serving path; returns (kernel launches, encoder calls)."""
    import numpy as np
    from fr_tpu_torch.ops.fused_window_attn import \
        fused_window_attention_packed as kernel
    from fr_tpu_torch.cli.main import main as cli_main

    calls = _EncoderCalls()
    captured = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            kernel.launches = 0
            msg = cli_main(CLI_ARGS + ["--save_root", tmp])
            launches = kernel.launches
    finally:
        calls.close()
    n_calls = calls.counts["eval"]
    print(f"[main] encoder calls {n_calls}, kernel launches {launches}")
    check(n_calls >= 1 and launches == 12 * n_calls,
          f"{launches} launches for {n_calls} encoder calls, expected 12 "
          f"per call")
    report = captured.getvalue()
    check('[Test with "synthetic"]' in report and "- EER" in report,
          "the ROC report was not printed")
    e1, e2 = msg["synthetic"].embeddings
    emb = np.concatenate([e1, e2])
    check(emb.shape == (512, 512), f"embeddings {emb.shape}")
    check(bool(np.isfinite(emb).all()), "embeddings are not finite")
    norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
    print(f"[main] embeddings {emb.shape} finite, max | |e| - 1 | "
          f"{norm_err:.2e}; accuracy {msg['synthetic'].acc:.2f}%; mean "
          f"{msg['synthetic'].infer_time:.2f} ms per call of 128 images, "
          f"host to host")
    check(norm_err <= 1e-4, "embeddings are not unit-norm")
    return launches, n_calls


def phase_throughput(network: str = "AlterNet50"):
    """Embedding step at 128 images per call, bf16, images already on the
    card."""
    import torch
    from fr_tpu_torch.cli.main import build_conf, parse_args
    from fr_tpu_torch.models import build_encoder
    from fr_tpu_torch.models.common import init_weights
    from fr_tpu_torch.train.step import make_embed_step

    args = CLI_ARGS[:CLI_ARGS.index("--network") + 1] + [network] + \
        CLI_ARGS[CLI_ARGS.index("--network") + 2:]
    conf = build_conf(parse_args(args))
    encoder = init_weights(build_encoder(conf)).cuda()
    embed = make_embed_step(conf, encoder, "cuda")
    x = torch.randn(128, conf.img_size, conf.img_size, 3, device="cuda")
    ms = time_ms(lambda: embed(x), iters=10, warmup=3)
    print(f"[throughput] {network} bf16 {conf.img_size} px, 128 images per "
          f"call: {ms:.2f} ms per call, {128e3 / ms:.1f} imgs/s")
    return ms


def phase_golden():
    import numpy as np
    import torch
    from fr_tpu_torch.configs.base import Config
    from fr_tpu_torch.models.alternet import ALTERNET_PLANS, AlterNet
    from fr_tpu_torch.ops.fused_window_attn import \
        fused_window_attention_packed as kernel
    from fr_tpu_torch.train.step import make_embed_step
    from fr_tpu_torch.utils.golden import golden_images, seeded_state_dict

    golden = np.load(GOLDEN)
    seed, ref = int(golden["seed"]), golden["embeddings"]
    images = golden_images(seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        model = AlterNet(*ALTERNET_PLANS["AlterNet50"], img_size=192,
                         emd_size=512, compute_dtype=dtype)
        model.load_state_dict(seeded_state_dict(model, seed), strict=True)
        embed = make_embed_step(Config(img_size=192), model.cuda(), "cuda")
        before = kernel.launches
        out = embed(images).cpu().numpy()
        check(kernel.launches - before == 12, "golden run missed the kernel")
        if dtype == torch.float32:
            err = float(np.abs(out - ref).max())
            print(f"[golden] f32 (TF32 off) max_abs_err {err:.3e} (tol 1e-3)")
            check(err <= 1e-3, f"f32 golden error {err}")
        else:
            cos = np.sum(out * ref, axis=1) / (
                np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
            print(f"[golden] bf16 min per-row cosine {cos.min():.5f} "
                  f"(tol 0.99)")
            check(cos.min() >= 0.99, f"bf16 golden cosine {cos.min()}")


def phase_train():
    """The training CLI at full width; returns (forward launches, backward
    launches, steps)."""
    import numpy as np
    from fr_tpu_torch.cli.main import build_conf, parse_args
    from fr_tpu_torch.cli.main import main as cli_main
    from fr_tpu_torch.ops.fused_window_attn import (
        fused_window_attention_packed as fwd, window_attention_backward as bwd)

    args = parse_args(TRAIN_ARGS)
    conf = build_conf(args)
    expected = conf.num_epoch * (args.synthetic_classes * 8 // conf.b)
    calls = _EncoderCalls()
    captured = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            t0 = time.perf_counter()
            fwd.launches = bwd.launches = 0
            task = cli_main(TRAIN_ARGS + ["--save_root", tmp])
            launches = fwd.launches, bwd.launches
            wall = time.perf_counter() - t0
            snapshots = sorted(p.name for p in Path(tmp).glob("*/*.npz"))
    finally:
        calls.close()
    steps, evals = calls.counts["train"], calls.counts["eval"]
    print(f"[train] {steps} steps, {evals} eval encoder calls, forward "
          f"launches {launches[0]}, backward launches {launches[1]}, "
          f"{wall:.1f} s for the whole run")
    check(steps == expected, f"{steps} training steps, expected {expected}")
    check(launches[1] == 12 * steps,
          f"{launches[1]} backward launches for {steps} steps, expected 12 "
          f"per step")
    check(launches[0] == 12 * (steps + evals),
          f"{launches[0]} forward launches for {steps + evals} encoder "
          f"calls, expected 12 per call")
    losses = [h["train_loss"] for h in task.history]
    print(f"[train] epoch mean losses {[round(x, 4) for x in losses]}")
    check(len(losses) == 6 and bool(np.isfinite(losses).all()),
          "the training loss is not finite")
    check(losses[-1] < losses[0], "the last epoch's loss is not below the "
          "first's")
    report = captured.getvalue()
    check('[Validation with "synthetic"]' in report and "- EER" in report
          and task.history[4]["val_acc"] is not None,
          "the ROC report was not printed at epoch 5")
    check(snapshots == ["5_epoch_encoder.npz"],
          f"encoder snapshots {snapshots}, expected the epoch-5 one")
    return launches[0], launches[1], steps


def phase_train_full_head(steps: int = 3, timed: int = 10):
    """training_step at the full ms1m_arcface_122 head, use_fused off then
    on from the same seed; returns the margin-CE launches of the fused
    run."""
    import torch
    from fr_tpu_torch.cli.main import build_conf, parse_args
    from fr_tpu_torch.ops import fused_pfc as F
    from fr_tpu_torch.train.task import FaceRecognitionTask

    args = parse_args(TRAIN_ARGS)
    conf = build_conf(args)
    # fr_tpu's load_config re-flattens the loss table over the config's own
    # sample_rate 0.3 (ROADMAP §3); the head is run at the config's value
    conf.sample_rate = FULL_HEAD_SAMPLE_RATE
    dev = args.device
    gen = torch.Generator(device=dev).manual_seed(3)
    n = steps + timed
    images = torch.randint(0, 256, (n, conf.b, conf.img_size, conf.img_size,
                                    3), dtype=torch.uint8, device=dev,
                           generator=gen)
    labels = torch.randint(0, conf.n_classes, (n, conf.b), device=dev,
                           generator=gen)
    kernels = (F.margin_ce_stats, F.margin_ce_grad_emb, F.margin_ce_grad_w)
    losses, launches = {}, None
    for fused in (False, True):
        conf.use_fused = fused
        task = FaceRecognitionTask(conf, stage="train", device=dev, seed=0)
        for k in kernels:
            k.launches = 0
        losses[fused] = [task.training_step((images[i], labels[i]))[
            "loss"].item() for i in range(steps)]
        counts = [k.launches for k in kernels]
        t0 = time.perf_counter()
        for i in range(steps, n):
            out = task.training_step((images[i], labels[i]))
        out["loss"].item()
        ms = (time.perf_counter() - t0) * 1e3 / timed
        print(f"[train_full_head] use_fused={fused}: {conf.n_classes:,} "
              f"classes, {task.pfc_cfg.num_sample:,} sampled, b={conf.b}: "
              f"losses {[round(x, 4) for x in losses[fused]]}; {ms:.2f} ms "
              f"per step, {conf.b * 1e3 / ms:.1f} imgs/s (host clock over "
              f"{timed} steps); margin-CE launches {counts}")
        check(counts == ([steps] * 3 if fused else [0, 0, 0]),
              f"margin-CE launches {counts} over {steps} steps with "
              f"use_fused={fused}")
        if fused:
            launches = counts
        del task
    for a, b in zip(losses[False], losses[True]):
        check(abs(a - b) <= 2e-2 * abs(a),
              f"fused loss {b} vs plain {a}: beyond 2e-2 relative")
    return launches


def phase_train_golden():
    import numpy as np
    import torch
    from fr_tpu_torch.ops.fused_window_attn import \
        window_attention_backward as bwd
    from fr_tpu_torch.utils.golden import run_train_golden

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = np.load(TRAIN_GOLDEN)
    before = bwd.launches
    ours = run_train_golden(int(golden["seed"]), "cuda")
    check(bwd.launches - before == 24, "the golden run missed the backward "
          "kernel")
    check(list(ours["update_names"]) == list(golden["update_names"]),
          "the golden's tensors differ from the model's")
    rel = {k: float(np.max(np.abs(ours[k] - golden[k]) / np.abs(golden[k])))
           for k in ("losses", "grad_norms", "update_norms")}
    print(f"[train_golden] f32 (TF32 off) losses {ours['losses']} vs "
          f"{golden['losses']}; max rel: losses {rel['losses']:.2e}, grad "
          f"norms {rel['grad_norms']:.2e} (tol 1e-3), update norms "
          f"{rel['update_norms']:.2e} (tol 5e-2)")
    check(rel["losses"] <= 1e-3 and rel["grad_norms"] <= 1e-3,
          "training golden: loss or grad norm beyond 1e-3")
    check(rel["update_norms"] <= 5e-2, "training golden: update norms "
          "beyond 5e-2")


# ---------------------------------------------------------------------------
# Slice 3: the per-head entry (rows 5-6), the stored-stats kernels (rows 3,
# 4, 7, 8), Swin50 and EffiAlter_m.
# ---------------------------------------------------------------------------

def _perhead_inputs(shape, dt, gen):
    """qkv, scale, bias16, g, mask, nW at one of PERHEAD_SHAPES (N = 49; the
    mask is the shift-3 SW-MSA mask over 14×14)."""
    import torch
    from fr_tpu_torch.models.swin_common import shifted_window_mask

    _, bw, heads, hd, nw, masked, *_ = shape
    c = heads * hd
    qkv = torch.randn(bw, 49, 3 * c, device="cuda", generator=gen).to(dt)
    scale = torch.empty(heads, device="cuda").uniform_(5.0, 20.0,
                                                      generator=gen)
    bias16 = 16 * torch.sigmoid(torch.randn(heads, 49, 49, device="cuda",
                                            generator=gen))
    g = torch.randn(bw, 49, c, device="cuda", generator=gen).to(dt)
    mask = (torch.from_numpy(shifted_window_mask(14, 14, 7, 3)).cuda()
            if masked else None)
    return qkv, scale, bias16, g, mask, nw


def _packed_inputs(shape, dt, gen):
    """The same at one of the AlterNet50 SHAPES, masked."""
    _, bw, n, heads, res, ws, *_ = shape
    return _attention_inputs(bw, n, heads, res, ws, True, dt, gen)


def _sdpa_args(qkv, scale, bias16, mask, heads):
    """The nearest library call's inputs: F.scaled_dot_product_attention on
    L2-normalised q̂ (scale folded in) and k̂, bias16 + mask as a float
    attn_mask, scale 1. Not the same function: no bf16 rounding of q̂, k̂
    and p where fr_tpu rounds, and SDPA's own softmax."""
    import torch
    bw, n, c3 = qkv.shape
    hd = c3 // 3 // heads
    t = qkv.reshape(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4).float()
    q = torch.nn.functional.normalize(t[0], dim=-1) * scale[None, :, None,
                                                            None]
    k = torch.nn.functional.normalize(t[1], dim=-1)
    bias = bias16[None].expand(bw, heads, n, n)
    if mask is not None:
        nw = mask.shape[0]
        bias = (bias.reshape(bw // nw, nw, heads, n, n)
                + mask[None, :, None]).reshape(bw, heads, n, n)
    dt = qkv.dtype
    return (q.to(dt).contiguous(), k.to(dt).contiguous(),
            t[2].to(dt).contiguous(), bias.to(dt).contiguous())


def _library_fwd_ms(qkv, scale, bias16, mask, heads):
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, bias = _sdpa_args(qkv, scale, bias16, mask, heads)
    return time_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=1.0))


def _library_bwd_ms(qkv, scale, bias16, mask, heads, g):
    """SDPA's backward: its forward-and-backward less its forward."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, bias = _sdpa_args(qkv, scale, bias16, mask, heads)
    go = g.reshape(q.shape[0], q.shape[2], heads, -1).permute(0, 2, 1, 3)
    fwd = time_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=1.0))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))

    def both():
        out = sdpa(q, k, v, attn_mask=bias, scale=1.0)
        torch.autograd.grad(out, (q, k, v), go)
    return max(time_ms(both) - fwd, 0.0)


def _attn_bound_ms(bw, n, c, heads, dt, kind, n_mask):
    """The least time of one call: the larger of its bytes (each input read
    once, each output written once) over 3.35 TB/s and its products' flops
    over the card's peak for the input type (989 TFLOP/s bf16, 67 TFLOP/s
    f32). kind: fwd, bwd, fwd_stats, bwd_stats; n_mask: the mask's windows
    (0 without one). The products per (window, head): forward 2 (q̂k̂ᵀ, p·v),
    recompute backward 5 (the scores again, dp, dv, dq̂, dk̂), stats backward
    4, each 2·N²·hd flops."""
    import torch
    es = 2 if dt == torch.bfloat16 else 4
    qkv, out = bw * n * 3 * c * es, bw * n * c * es   # g is out's size
    p = bw * heads * n * n * 4
    scale, bias, mask = heads * 4, heads * n * n * 4, n_mask * n * n * 4
    sums = heads * (n * n + 1) * 4              # dbias and dscale
    nbytes = {"fwd": qkv + scale + bias + mask + out,
              "fwd_stats": qkv + scale + bias + mask + out + p,
              "bwd": qkv + scale + bias + mask + out + qkv + sums,
              "bwd_stats": qkv + scale + p + out + qkv + sums}[kind]
    products = {"fwd": 2, "fwd_stats": 2, "bwd": 5, "bwd_stats": 4}[kind]
    flops = products * 2 * bw * n * n * c
    peak = 989e12 if dt == torch.bfloat16 else 67e12
    t_bytes, t_ops = nbytes / 3.35e12, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check_grads(tag, ours, ref, dt):
    """f32 5e-5·max(|ref|, 1); bf16 two bf16 ulps of the largest |ref|.
    Returns the largest max-abs error."""
    import math
    import torch
    worst = 0.0
    for t_name, a, b in zip(("dqkv", "dscale", "dbias"), ours, ref):
        check(bool(torch.isfinite(a).all()), f"{tag} {t_name} is not finite")
        mag = b.float().abs().max().item()
        tol = (F32_TOL * max(mag, 1.0) if dt == torch.float32
               else 2.0 * 2.0 ** (math.floor(math.log2(mag)) - 7))
        err = (a.float() - b.float()).abs().max().item()
        check(err <= tol, f"{tag} {t_name}: error {err} > {tol}")
        worst = max(worst, err)
    return worst


def phase_kernel_perhead():
    """Rows 5-6: the forward and recompute-backward kernels at the N=49
    shapes against their plain versions; returns (max error fwd, max error
    bwd, {shape: times}) with times in bf16."""
    import torch
    from fr_tpu_torch.ops import fused_window_attn as F

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst_f = worst_b = 0.0
    times = {}
    for shape in PERHEAD_SHAPES:
        name, heads = shape[0], shape[2]
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            qkv, scale, bias16, g, mask, nw = _perhead_inputs(shape, dt, gen)
            args = (qkv, scale, bias16, heads)
            out = F.fused_window_attention(*args, nw, mask, out_dtype=dt)
            torch.cuda.synchronize()
            ref = F.window_attention_reference(*args, mask, dt)
            check(bool(torch.isfinite(out.float()).all()),
                  f"{name} per-head output is not finite")
            err = (out.float() - ref.float()).abs().max().item()
            tag = f"{name} {str(dt).split('.')[-1]}"
            check(err <= tol, f"[kernel_perhead] {tag}: error {err} > {tol}")
            worst_f = max(worst_f, err)
            ours = F.window_attention_backward(qkv, scale, bias16, g, heads,
                                               nw, mask)
            torch.cuda.synchronize()
            plain = F.window_attention_backward_reference(
                qkv, scale, bias16, g, heads, mask)
            worst_b = max(worst_b, _check_grads(f"[kernel_perhead] {tag}",
                                                ours, plain, dt))
            t = {"fwd": time_ms(lambda: F.fused_window_attention(
                     *args, nw, mask, out_dtype=dt)),
                 "fwd_plain": time_ms(lambda: F.window_attention_reference(
                     *args, mask, dt)),
                 "bwd": time_ms(lambda: F.window_attention_backward(
                     qkv, scale, bias16, g, heads, nw, mask)),
                 "bwd_plain": time_ms(
                     lambda: F.window_attention_backward_reference(
                         qkv, scale, bias16, g, heads, mask))}
            t["fwd_lib"] = _library_fwd_ms(qkv, scale, bias16, mask, heads)
            t["bwd_lib"] = _library_bwd_ms(qkv, scale, bias16, mask, heads,
                                           g)
            print(f"[kernel_perhead] {tag:22s} {tuple(qkv.shape)} h{heads} "
                  f"fwd err {err:.2e} kernel {t['fwd']:.4f} plain "
                  f"{t['fwd_plain']:.4f} sdpa {t['fwd_lib']:.4f} ms; bwd "
                  f"kernel {t['bwd']:.4f} plain {t['bwd_plain']:.4f} sdpa "
                  f"{t['bwd_lib']:.4f} ms")
            if dt == torch.bfloat16:
                times[name] = t
    return worst_f, worst_b, times


def phase_kernel_stats():
    """Rows 3-4 and 7-8: the stored-stats kernels against their plain
    versions and against the recompute kernels, at the N=49 shapes and the
    AlterNet50 packed shapes; bitwise repeatable sums. Returns (max error
    fwd, max error bwd, {shape: bf16 times})."""
    import torch
    from fr_tpu_torch.ops import fused_window_attn as F

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst_f = worst_b = 0.0
    times = {}
    cases = ([(s, _perhead_inputs) for s in PERHEAD_SHAPES]
             + [(s, _packed_inputs) for s in SHAPES])
    for shape, make in cases:
        name = shape[0]
        for dt, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            qkv, scale, bias16, g, mask, nw = make(shape, dt, gen)
            heads = scale.shape[0]
            tag = f"{name} {str(dt).split('.')[-1]}"
            out, p = F.window_attention_forward_stats(
                qkv, scale, bias16, heads, nw, mask, out_dtype=dt)
            grads = F.window_attention_backward_stats(qkv, scale, p, g, heads)
            torch.cuda.synchronize()
            ref_out, ref_p = F.window_attention_forward_stats_reference(
                qkv, scale, bias16, heads, mask, dt)
            recompute_out = F.fused_window_attention(qkv, scale, bias16,
                                                     heads, nw, mask,
                                                     out_dtype=dt)
            for other in (ref_out, recompute_out):
                err = (out.float() - other.float()).abs().max().item()
                check(err <= tol, f"[kernel_stats] {tag} out: {err} > {tol}")
                worst_f = max(worst_f, err)
            # bf16: a q̂ or k̂ element can round to the neighbouring bf16
            # value where the card's rsqrt and the plain version's differ
            # in the last f32 digit (tests/test_torch_window_attn_stats_cuda)
            p_err = (p - ref_p).norm().item() / ref_p.norm().item()
            check(p_err <= (1e-6 if dt == torch.float32 else 1e-3),
                  f"[kernel_stats] {tag} p: norm-wise {p_err}")
            plain = F.window_attention_backward_stats_reference(
                qkv, scale, ref_p, g, heads)
            recompute = F.window_attention_backward(qkv, scale, bias16, g,
                                                    heads, nw, mask)
            torch.cuda.synchronize()
            if dt == torch.float32:
                worst_b = max(worst_b, _check_grads(
                    f"[kernel_stats] {tag}", grads, plain, dt))
                _check_grads(f"[kernel_stats] {tag} vs recompute", grads,
                             recompute, dt)
            else:
                # bf16 norm-wise 1e-2; dscale from the row-sum identity over
                # bf16-rounded ds·scale, 3e-2·max(|ref|, 1) as fr_tpu's own
                # stored-stats test holds it
                for other in (plain, recompute):
                    for t_name, a, b in zip(("dqkv", "dscale", "dbias"),
                                            grads, other):
                        a, b = a.float(), b.float()
                        check(bool(torch.isfinite(a).all()),
                              f"[kernel_stats] {tag} {t_name} not finite")
                        if t_name == "dscale":
                            err = (a - b).abs().max().item()
                            ok = err <= 3e-2 * max(b.abs().max().item(), 1.0)
                        else:
                            err = ((a - b).norm() / b.norm()).item()
                            ok = err <= 1e-2
                        check(ok, f"[kernel_stats] {tag} {t_name}: {err}")
                worst_b = max(worst_b, max(
                    (a.float() - b.float()).abs().max().item()
                    for a, b in zip(grads, plain)))
            again = F.window_attention_backward_stats(qkv, scale, p, g, heads)
            check(torch.equal(again[1], grads[1])
                  and torch.equal(again[2], grads[2]),
                  f"[kernel_stats] {tag}: dscale/dbias changed between runs")
            if dt == torch.bfloat16:
                t = {"fwd": time_ms(lambda: F.window_attention_forward_stats(
                         qkv, scale, bias16, heads, nw, mask, out_dtype=dt)),
                     "fwd_plain": time_ms(
                         lambda: F.window_attention_forward_stats_reference(
                             qkv, scale, bias16, heads, mask, dt)),
                     "bwd": time_ms(lambda: F.window_attention_backward_stats(
                         qkv, scale, p, g, heads)),
                     "bwd_plain": time_ms(
                         lambda: F.window_attention_backward_stats_reference(
                             qkv, scale, ref_p, g, heads)),
                     "bwd_recompute": time_ms(
                         lambda: F.window_attention_backward(
                             qkv, scale, bias16, g, heads, nw, mask))}
                t["fwd_lib"] = _library_fwd_ms(qkv, scale, bias16, mask,
                                               heads)
                t["bwd_lib"] = _library_bwd_ms(qkv, scale, bias16, mask,
                                               heads, g)
                times[name] = t
                print(f"[kernel_stats] {tag:22s} {tuple(qkv.shape)} h{heads}"
                      f" fwd_stats {t['fwd']:.4f} (plain {t['fwd_plain']:.4f})"
                      f" bwd_stats {t['bwd']:.4f} (plain {t['bwd_plain']:.4f},"
                      f" recompute kernel {t['bwd_recompute']:.4f}) ms")
            else:
                print(f"[kernel_stats] {tag:22s} out, p, grads within "
                      f"tolerance; sums bitwise repeatable")
    return worst_f, worst_b, times


def _net_args(network, mode):
    args = ["--config", "ms1m_arcface_122", "--mode", mode, "--network",
            network, "--synthetic", "--device", "cuda"]
    return args + (["--test_b", "64"] if mode == "test"
                   else ["--num_epoch", str(NET_EPOCHS)])


def _net_class(network):
    from fr_tpu_torch.models.effialternet import EffNetV2
    from fr_tpu_torch.models.swinv2 import Swin
    return Swin if network.startswith("Swin") else EffNetV2


def _reset(counters):
    for fn, attr in counters:
        setattr(fn, attr, 0)


def phase_network(network):
    """[swin50] / [effialter_m]: the serving CLI, the goldens, the training
    CLI and the stats switch at full width. Returns the per-head launches
    of the serving and training runs {attr: count} and the stats launches
    of the switch run."""
    import numpy as np
    import torch
    from fr_tpu_torch.cli.main import main as cli_main
    from fr_tpu_torch.configs.base import Config
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.train.step import make_embed_step
    from fr_tpu_torch.utils.golden import (golden_encoder, golden_images,
                                           seeded_state_dict)

    from fr_tpu_torch.utils.jax_import import export_encoder_npz

    tag = f"[{network.lower()}]"
    per_call = NET_LAUNCHES[network]
    perhead = [(F.fused_window_attention, "launches"),
               (F.fused_window_attention, "backward_launches")]
    golden = np.load(ROOT / "tests" / "data" / f"{network.lower()}_golden.npz")
    seed, ref = int(golden["seed"]), golden["embeddings"]
    # serving CLI on the golden's seeded weights, through an fr_tpu-layout
    # snapshot (--ckpt_path): at its own random init EffiAlter_m's eval-mode
    # output is ~1e-14, below l2_normalize's 1e-12 guard
    calls = _EncoderCalls(_net_class(network))
    captured = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            model = golden_encoder(network)
            model.load_state_dict(seeded_state_dict(model, seed), strict=True)
            ckpt = str(Path(tmp) / "seeded.npz")
            export_encoder_npz(ckpt, model, 0, network, 112)
            del model
            _reset(perhead)
            msg = cli_main(_net_args(network, "test") + [
                "--save_root", tmp, "--ckpt_path", ckpt])
            serve = F.fused_window_attention.launches
    finally:
        calls.close()
    n_calls = calls.counts["eval"]
    print(f"{tag} serving: {n_calls} encoder calls, per-head forward "
          f"launches {serve}")
    check(n_calls >= 1 and serve == per_call * n_calls,
          f"{tag} {serve} launches for {n_calls} calls, expected {per_call} "
          f"per call")
    check('[Test with "synthetic"]' in captured.getvalue(),
          f"{tag} the ROC report was not printed")
    emb = np.concatenate(msg["synthetic"].embeddings)
    check(emb.shape == (512, 512) and bool(np.isfinite(emb).all()),
          f"{tag} embeddings {emb.shape} not finite")
    norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
    check(norm_err <= 1e-4, f"{tag} embeddings are not unit-norm")
    print(f"{tag} embeddings {emb.shape} finite, max | |e| - 1 | "
          f"{norm_err:.2e}; mean {msg['synthetic'].infer_time:.2f} ms per "
          f"call of 128 images, host to host")

    # goldens, f32 (TF32 off) and bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        model = golden_encoder(network, dtype)
        model.load_state_dict(seeded_state_dict(model, seed), strict=True)
        embed = make_embed_step(Config(img_size=112), model.cuda(), "cuda")
        before = F.fused_window_attention.launches
        out = embed(golden_images(seed, img_size=112)).cpu().numpy()
        check(F.fused_window_attention.launches - before == per_call,
              f"{tag} golden run missed the per-head kernel")
        if dtype == torch.float32:
            err = float(np.abs(out - ref).max())
            print(f"{tag} golden f32 (TF32 off) max_abs_err {err:.3e} "
                  f"(tol 1e-3)")
            check(err <= 1e-3, f"{tag} f32 golden error {err}")
        else:
            cos = np.sum(out * ref, axis=1) / (
                np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
            print(f"{tag} golden bf16 min per-row cosine {cos.min():.5f} "
                  f"(tol 0.99)")
            check(cos.min() >= 0.99, f"{tag} bf16 golden cosine {cos.min()}")
        del model, embed
    phase_throughput(network)

    # training CLI
    calls = _EncoderCalls(_net_class(network))
    captured = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            t0 = time.perf_counter()
            _reset(perhead)
            task = cli_main(_net_args(network, "train") + ["--save_root",
                                                           tmp])
            fwd, bwd = (getattr(f, a) for f, a in perhead)
            wall = time.perf_counter() - t0
    finally:
        calls.close()
    steps, evals = calls.counts["train"], calls.counts["eval"]
    losses = [h["train_loss"] for h in task.history]
    print(f"{tag} training: {steps} steps, {evals} eval calls, per-head "
          f"launches forward {fwd}, backward {bwd}; epoch losses "
          f"{[round(x, 4) for x in losses]}; {wall:.1f} s")
    check(steps == NET_EPOCHS * 8, f"{tag} {steps} training steps")
    check(bwd == per_call * steps, f"{tag} {bwd} backward launches for "
          f"{steps} steps")
    check(fwd == per_call * (steps + evals), f"{tag} {fwd} forward launches "
          f"for {steps + evals} encoder calls")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"{tag} training loss {losses}")
    del task
    stats = phase_stats_switch(network)
    return {"serve": serve, "train_fwd": fwd, "train_bwd": bwd}, stats


def phase_stats_switch(network, steps: int = 3):
    """Three training_steps with FR_ATTN_STORED_STATS=1 against =0 from one
    seed (b=128, bf16, the CLI's synthetic head): the stats kernels launch
    once per attention site and step, the losses agree to 1e-3 relative;
    then the arms' encoder gradients (``_stats_switch_grads``). The
    variable is restored. Returns the stats kernels' launches."""
    import os
    import torch
    from fr_tpu_torch.cli.main import build_conf, parse_args
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.train.task import FaceRecognitionTask

    tag = f"[{network.lower()}]"
    entry = (F.fused_window_attention_packed if network == "AlterNet50"
             else F.fused_window_attention)
    counters = [(entry, "stats_launches"), (entry, "stats_backward_launches")]
    args = parse_args(_net_args(network, "train"))
    conf = build_conf(args)
    conf.n_classes = args.synthetic_classes
    gen = torch.Generator(device="cuda").manual_seed(6)
    images = torch.randint(0, 256, (steps, conf.b, conf.img_size,
                                    conf.img_size, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    labels = torch.randint(0, conf.n_classes, (steps, conf.b),
                           device="cuda", generator=gen)
    saved = os.environ.get("FR_ATTN_STORED_STATS")
    losses, launches = {}, None
    try:
        for arm in ("0", "1"):
            os.environ["FR_ATTN_STORED_STATS"] = arm
            task = FaceRecognitionTask(conf, stage="train", device="cuda",
                                       seed=0)
            _reset(counters)
            losses[arm] = [task.training_step((images[i], labels[i]))[
                "loss"].item() for i in range(steps)]
            counts = [getattr(f, a) for f, a in counters]
            if arm == "1":
                launches = counts
            del task
    finally:
        if saved is None:
            os.environ.pop("FR_ATTN_STORED_STATS", None)
        else:
            os.environ["FR_ATTN_STORED_STATS"] = saved
    per_call = NET_LAUNCHES[network]
    _stats_switch_grads(network, tag)
    print(f"{tag} FR_ATTN_STORED_STATS=0 losses "
          f"{[round(x, 5) for x in losses['0']]}, =1 "
          f"{[round(x, 5) for x in losses['1']]}; stats launches {launches}")
    check(launches == [per_call * steps] * 2,
          f"{tag} stats launches {launches}, expected {per_call * steps}")
    for a, b in zip(losses["0"], losses["1"]):
        check(abs(a - b) <= 1e-3 * abs(a), f"{tag} stats-arm loss {b} vs "
              f"recompute {a}: beyond 1e-3 relative")
    return launches


def _stats_switch_grads(network, tag, n_img: int = 8):
    """One encoder backward with FR_ATTN_STORED_STATS=1 against =0: the
    golden's seeded full-width weights, f32 with TF32 off, train mode, a
    fixed random projection of the L2-normalised embeddings as the loss, one
    dropout seed. Every parameter's gradient agrees norm-wise to 1e-3, above
    a floor of 1e-5 of the largest gradient norm (gradients that a
    BatchNorm cancels); the attention parameters' gradients are dqkv
    (qkv, q_bias, v_bias), dbias (cpb_mlp) and dscale (logit_scale), so a
    stats backward wired wrongly into the model fails here. The variable is
    left as it was."""
    import os
    import numpy as np
    import torch
    from fr_tpu_torch.configs.base import default_img_size
    from fr_tpu_torch.models.common import l2_normalize
    from fr_tpu_torch.utils.golden import (golden_encoder, golden_images,
                                           seeded_state_dict)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = golden_encoder(network, train=True)
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    model.cuda().train()
    x = torch.from_numpy(golden_images(0, n_img, default_img_size(network))
                         ).cuda()
    r = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n_img, 512)).astype(np.float32)).cuda()
    names, params = zip(*model.named_parameters())
    saved = os.environ.get("FR_ATTN_STORED_STATS")
    grads = {}
    try:
        for arm in ("0", "1"):
            os.environ["FR_ATTN_STORED_STATS"] = arm
            gen = torch.Generator(device="cuda").manual_seed(8)
            loss = (l2_normalize(model(x, gen).float()) * r).sum()
            grads[arm] = torch.autograd.grad(loss, params)
    finally:
        if saved is None:
            os.environ.pop("FR_ATTN_STORED_STATS", None)
        else:
            os.environ["FR_ATTN_STORED_STATS"] = saved
    norms = [float(g.norm()) for g in grads["0"]]
    diffs = [float((a - b).norm()) for a, b in zip(grads["1"], grads["0"])]
    floor = 1e-5 * max(norms)
    worst, groups = 0.0, {}
    for name, n0, d in zip(names, norms, diffs):
        worst = max(worst, max(d - floor, 0.0) / max(n0, 1e-30))
        for group in ("qkv", "q_bias", "v_bias", "cpb_mlp", "logit_scale"):
            if f".{group}" in name:
                rel, small = groups.get(group, (0.0, float("inf")))
                groups[group] = (max(rel, d / max(n0, 1e-30)),
                                 min(small, n0 / max(norms)))
    print(f"{tag} stats-arm gradients (f32, {n_img} images): worst norm-wise "
          f"difference beyond the floor {worst:.2e} (tol 1e-3); per group "
          f"(worst rel, smallest norm / largest): " + ", ".join(
              f"{k} {v[0]:.1e} {v[1]:.1e}" for k, v in groups.items()))
    check(len(groups) == 5, f"{tag} attention parameters {sorted(groups)}")
    check(worst <= 1e-3, f"{tag} stats-arm encoder gradients differ from "
          f"the recompute arm's: {worst:.2e} norm-wise")
    del model


def phase_swin50_train_golden():
    import numpy as np
    import torch
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.utils.golden import run_train_golden

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = np.load(SWIN_TRAIN_GOLDEN)
    before = F.fused_window_attention.backward_launches
    ours = run_train_golden(int(golden["seed"]), "cuda", "Swin50")
    check(F.fused_window_attention.backward_launches - before == 28,
          "the Swin50 golden run missed the per-head backward kernel")
    check(list(ours["update_names"]) == list(golden["update_names"]),
          "the golden's tensors differ from the model's")
    rel = {k: float(np.max(np.abs(ours[k] - golden[k]) / np.abs(golden[k])))
           for k in ("losses", "grad_norms")}
    # update norms: rel 5e-2 plus 1e-3 of the largest update, for tensors
    # whose gradient the next BatchNorm cancels (tests/test_torch_swin_train)
    floor = 1e-3 * golden["update_norms"].max()
    upd = float(np.max(np.maximum(
        np.abs(ours["update_norms"] - golden["update_norms"]) - floor, 0.0)
        / golden["update_norms"]))
    print(f"[swin50_train_golden] f32 (TF32 off) losses {ours['losses']} vs "
          f"{golden['losses']}; max rel: losses {rel['losses']:.2e}, grad "
          f"norms {rel['grad_norms']:.2e} (tol 1e-3), update norms beyond "
          f"{floor:.1e} {upd:.2e} (tol 5e-2)")
    check(rel["losses"] <= 1e-3 and rel["grad_norms"] <= 1e-3,
          "Swin50 training golden: loss or grad norm beyond 1e-3")
    check(upd <= 5e-2, "Swin50 training golden: update norms beyond 5e-2")


def phase_profile(network, warmup: int = 3, steps: int = 5):
    """torch.profiler over ``steps`` training steps after ``warmup`` (b=128,
    bf16, the full ms1m_arcface_122 head at sample_rate 0.3, use_fused
    off): wall per step (host clock, synchronised), device busy (the union
    of the kernels' intervals), idle share, kernel launches per step and
    device time by family."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fr_tpu_torch.cli.main import build_conf, parse_args
    from fr_tpu_torch.train.task import FaceRecognitionTask

    conf = build_conf(parse_args(_net_args(network, "train")))
    conf.sample_rate = FULL_HEAD_SAMPLE_RATE
    gen = torch.Generator(device="cuda").manual_seed(7)
    images = torch.randint(0, 256, (conf.b, conf.img_size, conf.img_size, 3),
                           dtype=torch.uint8, device="cuda", generator=gen)
    labels = torch.randint(0, conf.n_classes, (conf.b,), device="cuda",
                           generator=gen)
    task = FaceRecognitionTask(conf, stage="train", device="cuda", seed=0)
    for _ in range(warmup):
        task.training_step((images, labels))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        task.training_step((images, labels))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            task.training_step((images, labels))
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3 / steps
    families, by_name = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        fam = _family(e.name)
        families[fam] = families.get(fam, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    print(f"[profile] {network} bf16 b={conf.b}, {conf.n_classes:,} classes "
          f"at sample_rate {conf.sample_rate}: wall {wall:.2f} ms per step "
          f"unprofiled ({conf.b * 1e3 / wall:.1f} imgs/s), device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall:.3f}, "
          f"{len(kernels) / steps:.0f} kernel launches per step")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {network}   {fam:28s} {ms:8.3f} ms/step "
              f"{100 * ms / max(busy_ms, 1e-9):5.1f}%")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] {network}   top: {ms:8.3f} ms/step "
              f"[{_family(name)}] {name[:90]}")
    del task


def _family(name):
    n = name.lower()
    for fam, keys in (("port attention kernels", ("window_attn", "window_sum")),
                      ("port margin-CE kernels", ("margin_ce",)),
                      ("cuDNN BatchNorm", ("bn_", "batch_norm", "batchnorm")),
                      ("convolution", ("conv", "implicit", "dgrad", "wgrad",
                                       "depthwise", "xmma_fprop")),
                      ("GEMM", ("gemm", "cutlass", "cublas", "sm90_xmma")),
                      ("reduction", ("reduce",)),
                      ("copy and cast", ("copy", "cast", "cat", "fill")),
                      ("elementwise", ("elementwise", "vectorized"))):
        if any(k in n for k in keys):
            return fam
    return "other"


def _perhead_mix(times, key):
    """One Swin50 encoder call plus one EffiAlter_m call: the 18-launch mix
    of the per-head sites."""
    return sum(times[name][key] * (n_swin + n_effi)
               for name, _, _, _, _, _, n_swin, n_effi in PERHEAD_SHAPES)


def _perhead_bound(kind):
    import torch
    total = 0.0
    for name, bw, heads, hd, nw, masked, n_swin, n_effi in PERHEAD_SHAPES:
        ms, by = _attn_bound_ms(bw, 49, heads * hd, heads, torch.bfloat16,
                                kind, nw if masked else 0)
        total += ms * (n_swin + n_effi)
    return total, by


def _packed_bound(kind):
    import torch
    total = 0.0
    for name, bw, n, heads, res, ws, n_unmasked, n_masked in SHAPES:
        for n_mask, count in ((0, n_unmasked), ((res // ws) ** 2, n_masked)):
            ms, by = _attn_bound_ms(bw, n, heads * 32, heads, torch.bfloat16,
                                    kind, n_mask)
            total += ms * count
    return total, by


def _ce_bound(kind):
    """The margin-CE kernels at CE_SHAPE in bf16: stats reads emb, W,
    labels (int64), col_valid and writes m, d, t; the two gradients also
    read m, d and g and write (N, D) or (K, D) f32. Products: the logits
    (2·N·K·D), and for a gradient also coeff·W or coeffᵀ·emb."""
    n, d, k = CE_SHAPE
    inputs = n * d * 2 + k * d * 2 + n * 8 + k
    nbytes = {"margin_ce_stats": inputs + 3 * n * 4,
              "margin_ce_grad_emb": inputs + 3 * n * 4 + n * d * 4,
              "margin_ce_grad_w": inputs + 3 * n * 4 + k * d * 4}[kind]
    flops = (2 if kind == "margin_ce_stats" else 4) * n * k * d
    t_bytes, t_ops = nbytes / 3.35e12, flops / 989e12
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _mix(times, dtype):
    """Per encoder call (forward) or per step (backward) at 128 images: the
    12-launch mix of the AlterNet50 attention sites."""
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for name, *_, n_unmasked, n_masked in SHAPES:
        for masked, count in ((False, n_unmasked), (True, n_masked)):
            for key, value in zip(total, times[(name, masked, dtype)]):
                total[key] += count * value
    return total


def _entry(name, source, line, launches, err, ms, plain_ms, bound, lib):
    return {"name": name, "route": "cuda",
            "source": f"fr_tpu_torch/csrc/{source}",
            "replaces": f"fr_tpu/ops/{line}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}


def main() -> None:
    import torch
    check(torch.cuda.is_available(), "torch finds no CUDA device")
    for path in (GOLDEN, TRAIN_GOLDEN, SWIN_TRAIN_GOLDEN, *NET_GOLDENS):
        check(path.is_file(), f"{path} is missing: run from a checkout of "
              f"the repository")
    import fr_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    print(f"[device] {nvidia_smi()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    phase_build()
    worst_fwd, times_fwd = phase_kernel()
    worst_bwd, times_bwd = phase_kernel_bwd()
    worst_ce, times_ce = phase_margin_ce()
    worst_ph_f, worst_ph_b, times_ph = phase_kernel_perhead()
    worst_st_f, worst_st_b, times_st = phase_kernel_stats()
    # each main path runs with its counts set to 0 just before it
    launches_fwd, _ = phase_main_path()
    phase_throughput()
    phase_golden()
    _, launches_bwd, _ = phase_train()
    launches_ce = phase_train_full_head()
    phase_train_golden()
    packed_stats = phase_stats_switch("AlterNet50")
    perhead = {"fwd": 0, "bwd": 0}
    perhead_stats = [0, 0]
    for network in ("Swin50", "EffiAlter_m"):
        counts, stats = phase_network(network)
        perhead["fwd"] += counts["serve"] + counts["train_fwd"]
        perhead["bwd"] += counts["train_bwd"]
        perhead_stats = [a + b for a, b in zip(perhead_stats, stats)]
    phase_swin50_train_golden()
    for network in ("Swin50", "EffiAlter_m"):
        phase_profile(network)

    fwd = _mix(times_fwd, torch.bfloat16)
    bwd = _mix(times_bwd, torch.bfloat16)
    attn = "fused_window_attn.py"
    kernels = [
        _entry("window_attn_fwd", "window_attn_fwd.cu",
               f"{attn}:1572", launches_fwd, worst_fwd, fwd["ms"],
               fwd["plain_ms"], _packed_bound("fwd"), fwd["library_ms"]),
        _entry("window_attn_bwd", "window_attn_bwd.cu",
               f"{attn}:1717", launches_bwd, worst_bwd, bwd["ms"],
               bwd["plain_ms"], _packed_bound("bwd"), bwd["library_ms"])]
    for name, line, count in zip(
            ("margin_ce_stats", "margin_ce_grad_emb", "margin_ce_grad_w"),
            (308, 406, 425), launches_ce):
        kernels.append(_entry(name, "margin_ce.cu", f"fused_pfc.py:{line}",
                              count, worst_ce[name], times_ce[name][0],
                              times_ce[name][1], _ce_bound(name), None))
    for kind, line, count, err, src in (
            ("fwd", 1909, perhead["fwd"], worst_ph_f, "window_attn_fwd.cu"),
            ("bwd", 2002, perhead["bwd"], worst_ph_b, "window_attn_bwd.cu")):
        kernels.append(_entry(
            f"window_attn_{kind} (per-head entry)", src, f"{attn}:{line}",
            count, err, _perhead_mix(times_ph, kind),
            _perhead_mix(times_ph, f"{kind}_plain"), _perhead_bound(kind),
            _perhead_mix(times_ph, f"{kind}_lib")))
    stats_mix = {k: _perhead_mix(times_st, k) for k in times_st[
        PERHEAD_SHAPES[0][0]]}
    packed_mix = {k: sum(times_st[name][k] * (n_unmasked + n_masked)
                         for name, *_, n_unmasked, n_masked in SHAPES)
                  for k in stats_mix}
    for kind, i, err in (("fwd", 0, worst_st_f), ("bwd", 1, worst_st_b)):
        for entry, lines, counts, mix, bound in (
                ("per-head", (731, 790), perhead_stats, stats_mix,
                 _perhead_bound(f"{kind}_stats")),
                ("packed", (1298, 1367), packed_stats, packed_mix,
                 _packed_bound(f"{kind}_stats"))):
            kernels.append(_entry(
                f"window_attn_{kind}_stats ({entry} entry)",
                "window_attn_stats.cu", f"{attn}:{lines[i]}", counts[i], err,
                mix[kind], mix[f"{kind}_plain"], bound, mix[f"{kind}_lib"]))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its "
              f"main path")
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
