#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (fr_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs no flag

Phases; any failure exits non-zero and prints no result:
 1. require CUDA and the port's sources;
 2. build the CUDA kernels from fr_tpu_torch/csrc (one nvcc per source, in
    parallel, sm_90a) and print each kernel's registers and spills;
 3. hold every kernel against its plain PyTorch version and time both: the
    window-attention forward and backward at the AlterNet50 shapes (192 px,
    128 images), masked and unmasked, bf16 and f32; the three margin-softmax
    CE kernels at the ms1m_arcface_122 head (128 rows, emd 512, 26,007
    sampled columns), ArcFace and CosFace, bf16 and f32;
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
    against fr_tpu's training golden (tests/data/alternet50_train_golden.npz).

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
                tag = f"{name} {'masked' if masked else 'unmasked'} " \
                      f"{str(dt).split('.')[-1]}"
                print(f"[kernel] {tag:26s} ({bw},{n},{3 * c}) "
                      f"max_abs_err {err:.3e} (tol {tol:g})  kernel "
                      f"{ms:.4f} ms  plain {plain:.4f} ms")
                check(err <= tol, f"{tag}: error {err} > {tol}")
                worst = max(worst, err)
                times[(name, masked, dt)] = (ms, plain)
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
                print(f"[kernel_bwd] {tag:26s} err/tol {', '.join(errs)}  "
                      f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
                times[(name, masked, dt)] = (ms, plain_ms)
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
    """Counts AlterNet forward calls in training and in eval mode."""

    def __init__(self):
        import torch
        from fr_tpu_torch.models.alternet import AlterNet

        self.counts = {"train": 0, "eval": 0}

        def hook(module, args, output):
            if isinstance(module, AlterNet):
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


def phase_throughput():
    """Embedding step at 128 images per call, images already on the card."""
    import torch
    from fr_tpu_torch.cli.main import build_conf, parse_args
    from fr_tpu_torch.models import build_encoder
    from fr_tpu_torch.models.common import init_weights
    from fr_tpu_torch.train.step import make_embed_step

    conf = build_conf(parse_args(CLI_ARGS))
    encoder = init_weights(build_encoder(conf)).cuda()
    embed = make_embed_step(conf, encoder, "cuda")
    x = torch.randn(128, conf.img_size, conf.img_size, 3, device="cuda")
    ms = time_ms(lambda: embed(x), iters=10, warmup=3)
    print(f"[throughput] AlterNet50 bf16 {conf.img_size} px, 128 images per "
          f"call: {ms:.2f} ms per call, {128e3 / ms:.1f} imgs/s")
    return ms


def phase_golden():
    import numpy as np
    import torch
    from fr_tpu.configs.base import Config
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


def _mix(times, dtype):
    """Per encoder call (forward) or per step (backward) at 128 images: the
    12-launch mix of the AlterNet50 attention sites."""
    total = {"ms": 0.0, "plain_ms": 0.0}
    for name, *_, n_unmasked, n_masked in SHAPES:
        for masked, count in ((False, n_unmasked), (True, n_masked)):
            ms, plain = times[(name, masked, dtype)]
            total["ms"] += count * ms
            total["plain_ms"] += count * plain
    return total


def main() -> None:
    import torch
    check(torch.cuda.is_available(), "torch finds no CUDA device")
    for path in (GOLDEN, TRAIN_GOLDEN):
        check(path.is_file(), f"{path} is missing: run from a checkout of "
              f"the repository")
    import fr_tpu_torch  # noqa: F401  (fails outside a checkout)

    print(f"[device] {nvidia_smi()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    phase_build()
    worst_fwd, times_fwd = phase_kernel()
    worst_bwd, times_bwd = phase_kernel_bwd()
    worst_ce, times_ce = phase_margin_ce()
    launches_fwd, _ = phase_main_path()
    phase_throughput()
    phase_golden()
    _, launches_bwd, _ = phase_train()
    launches_ce = phase_train_full_head()
    phase_train_golden()

    fwd = _mix(times_fwd, torch.bfloat16)
    bwd = _mix(times_bwd, torch.bfloat16)
    kernels = [
        {"name": "window_attn_fwd", "route": "cuda",
         "source": "fr_tpu_torch/csrc/window_attn_fwd.cu",
         "replaces": "fr_tpu/ops/fused_window_attn.py:1572",
         "launches": launches_fwd, "max_abs_err": worst_fwd, **fwd},
        {"name": "window_attn_bwd", "route": "cuda",
         "source": "fr_tpu_torch/csrc/window_attn_bwd.cu",
         "replaces": "fr_tpu/ops/fused_window_attn.py:1717",
         "launches": launches_bwd, "max_abs_err": worst_bwd, **bwd}]
    for name, line, count in zip(
            ("margin_ce_stats", "margin_ce_grad_emb", "margin_ce_grad_w"),
            (308, 406, 425), launches_ce):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fr_tpu_torch/csrc/margin_ce.cu",
            "replaces": f"fr_tpu/ops/fused_pfc.py:{line}",
            "launches": count, "max_abs_err": worst_ce[name],
            "ms": times_ce[name][0], "plain_ms": times_ce[name][1]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
