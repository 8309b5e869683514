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
    shapes (192 px, 128 images), masked and unmasked, bf16 and f32 (bf16
    on the tensor-core kernels, f32 on the CUDA-core ones, each call's
    route checked; the backward's sums bitwise equal over two runs); the
    margin-softmax CE kernels at the ms1m_arcface_122 head (128 rows,
    emd 512, 26,007 sampled columns), ArcFace and CosFace, bf16 and f32,
    at the webface42m head (205,952 columns, the labels and the column
    mask made as its step makes them) and at small ragged shapes: the
    bf16 calls of all three (the statistics, row 9, and the backward pair,
    rows 10 and 11) on the tensor cores (each call's body checked, two
    calls bitwise equal), f32 and D = 40 on the CUDA cores; rows 9-11
    timed at both heads beside their plain versions and the cuBLAS products
    they contain; the backward pair with two coefficient terms (the plain
    CE's) at both heads and the vit_l_wf42m head against its two-term plain
    twin (1e-4 norm-wise, which the one-term body fails; two calls bitwise
    equal) and timed beside it; the plain CE's route on the kernels (the
    stats and the two-term pair) timed at the vit_l_wf42m and r100_wf42m
    heads beside the plain CE in PyTorch, and counted in one ViT-L
    training step;
    [kernel_perhead] the same forward and backward kernels at the Swin50
    and EffiAlter_m N=49 shapes (112 px, 128 images; head dims 32 and 38)
    and a shift-masked one; [kernel_stats] the stored-stats forward and
    backward at the N=49 and AlterNet50 shapes, bf16 on the tensor cores,
    f32 and an odd head dim on the CUDA cores, each call's route checked:
    against their plain versions and the recompute kernels (on the tensor
    cores out and dqkv equal to the row-1/row-2 kernels' bits), p and the
    sums bitwise repeatable; times beside the recompute kernels and SDPA;
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
    images and labels) from one seed, in three arms: use_fused off with
    the plain CE kept in PyTorch, off (the plain CE on the margin-CE
    kernels, its backward with two coefficient terms), and on: each
    margin-CE kernel launches once per step in the kernel arms, every
    launch on its tensor-core body, none in the PyTorch arm; the first 3
    losses of the kernel arms against the PyTorch arm's, the first within
    1e-4 (the plain CE on the kernels) or 2e-2 (fused), the rest within
    2e-2; ms per step and images/s for each arm;
 8. [train_golden] two SGD steps of full-width AlterNet50 in f32 (TF32 off)
    against fr_tpu's training golden (tests/data/alternet50_train_golden.npz);
    [alternet50] three training steps with FR_ATTN_STORED_STATS=1 against
    =0 on the tensor cores: the packed entry's stats kernels launch, every
    launch on the tensor cores, the losses agree to 1e-3; one f32 encoder
    backward under each arm (the CUDA-core bodies): every parameter's
    gradient agrees norm-wise to 1e-3;
 9. [swin50] and [effialter_m], each at full width (112 px, emd 512, bf16):
    the serving CLI (14 and 4 per-head launches per encoder call), the
    goldens (tests/data/{swin50,effialter_m}_golden.npz: f32 max-abs 1e-3,
    bf16 per-row cosine 0.99), the training CLI (b=128, 10 epochs: 14/14
    and 4/4 forward/backward launches per step, a finite loss whose last
    epoch is below the first), and three training steps with
    FR_ATTN_STORED_STATS=1 against =0 on the tensor cores (stats launches
    seen, every launch on the tensor cores, losses within 1e-3 relative,
    f32 encoder gradients norm-wise within 1e-3; the variable is
    restored);
10. [swin50_train_golden] two SGD steps of full-width Swin50 in f32 against
    tests/data/swin50_train_golden.npz;
11. [kernel_sparse_rows] the grouped gather, SGD and AdamW kernels against
    their plain versions on the WebFace42M table (2,059,968 × 512 f32,
    3,218 groups of 64 from a seed, the first and the last group forced in)
    and at a small shape (block 4, D 128): gather bit-exact, updates to
    rtol 1e-5 / atol 1e-6 (fused multiply-adds), unsampled rows bitwise
    unchanged, the same bits on two runs, on inputs that make every term
    of both rules larger than the tolerance; times, byte bounds, and
    torch.index_select as the gather's library call, timed against the
    gather in 7 alternating turns (medians and spreads);
    [kernel_batch_norm] the BatchNorm kernels (csrc/batch_norm.cu) in
    bf16 at IR-ResNet100's stem, layer-3 and BN1d shapes (b=256) and
    AlterNet50's stem (b=128, 192 px): bn_stats + bn_apply, the backward
    pair through autograd and bn_eval against the plain version (one bf16
    ulp), their device time (profiler) beside their byte bounds (4, 6 and
    4 B an element at 3.35 TB/s), the plain version and cuDNN's f32 batch
    norm between two casts (the library path the port no longer calls),
    over activations cycled past the L2; the main paths ([main], [train],
    [resnet100], [webface42m]) count the kernels' launches by entry point
    from 0: 2 forward and 2 backward a training BatchNorm call, 1 an eval
    call, and one layout copy an IR-ResNet100 training step (the last
    BN2d's gradient, NCHW from the flatten);
    [kernel_global_attn] the global-attention kernels
    (csrc/global_attn.cu) at ViT-L's training layer (384 images, 136
    tokens, 8 heads of 96, bf16, read from and written to the packed qkv
    projection): forward and backward against the plain versions of their
    arithmetic (relative norm 2^-8 and 2^-7) and the f32 plain route, two
    runs bitwise equal, device times (profiler) beside their bounds, the
    plain versions' and flash SDPA's (library_ms; the port never calls
    it); ViT-L's encoder forward and backward on 16 images: one forward
    and one backward launch a block;
12. [resnet100] the serving CLI of webface42m at full width (IR-ResNet100,
    112 px, emd 512, bf16), the embedding golden
    (tests/data/resnet100_golden.npz) and the embed throughput;
13. [webface42m] FaceRecognitionTask.training_step of the webface42m config
    (ResNet100, 2,059,906 classes, sample_rate 0.1, sample_block 64, b=128,
    bf16, SGD, random images and labels), in the three margin-CE arms of
    phase 7 from one seed: finite losses, held as there, every margin-CE
    launch on its tensor-core body, one gather and one grouped SGD update per step, every
    label's group among the drawn groups and only drawn rows changed, ms per step, images/s, peak memory; three steps
    with AdamW; then sample_block 1 (per-row sampling of the same head)
    timed beside it;
14. [resnet100_train_golden] two SGD steps of ResNet100 under a
    block-sampled head in f32 against tests/data/resnet100_train_golden.npz,
    the stored groups fed through sample_gidx;
15. [resume] the training CLI (ResNet100 at full width, bf16, sample_block
    4, sample_rate 0.5) for 7 epochs in one run, then the same command with
    --resume from that run's epoch-5 save: the final encoder and head are
    bitwise equal;
    [multi_gpu] (a) the training CLI (webface42m, ResNet100, sample_block
    64, 6 epochs) under torchrun, one process over NCCL at mesh (1, 1),
    against the same command without --distributed in this process: the same
    groups drawn at every step (a weak check: --synthetic's 128 classes make
    2 groups of 64, and 1 is drawn), losses within 1e-5 relative (the strong
    one), a snapshot in each; (b) two ranks of a (1, 2) mesh sharing the
    card over gloo (gloo's CUDA collectives checked first), each a
    webface42m task at full width with use_fused (a 1,030,016 x 512 shard,
    1,609 groups a step): the margin-CE kernels on the tensor cores and the
    grouped gather and SGD update once per step per rank, only drawn rows
    changed at step 1, the ranks' encoders bitwise equal after each of 3
    steps, step 1 (64 images, rank 1 taking them and their labels reversed,
    no augmentation) against the mean of one process's steps on each rank's
    images fed the union of the shards' groups (loss 1e-5 and grad_norm 1e-3
    relative, each shard's head-row gradient 5e-3 norm-wise, bf16's rounding
    of the kernels' gradient output at about 2e-3; how far those two steps
    part is printed: the batch order's effect in bf16); ms per step and peak
    memory by rank; and each rank's stripe of a card-resident corpus (515
    seeded 112-px images, DeviceCorpusLoader at process_count 2, global
    batch 128): for two epochs every local batch equal to the rows of
    fr_tpu's draw recomputed here with numpy (sha256 of the bytes), the
    same global labels on both ranks and the expected ones, each rank
    holding only its 257 rows. The ranks are this script, run with a
    private first argument;
    [host_libs] which of cv2, pandas, TensorBoard, libblosc, libjpeg and
    g++ the machine has, and whether the native host library built, with
    JPEG or not;
    [data_folder] (cv2) 1,024 JPEGs (128 classes x 8, 192 px) and a
    validation pair root of 256 pairs at 112 px (a bcolz rootdir with
    libblosc, else .npy), then the training CLI with --data_dir
    (AlterNet50 at full width, bf16, b=128, 6 epochs); [data_packed] the
    same corpus as images.npy / labels.npy / classes.json, then
    --packed_dir and --packed_dir --device_corpus: in each run 48 steps,
    12 + 12 tensor-core launches per step and 12 per validation call,
    every step's images on the card (through the prefetch, or gathered
    there with no prefetch for the device corpus), a finite loss whose
    last epoch is below the first, the ROC report at epoch 5, the
    snapshot, imgs/s by epoch; [eval_data] the pair test (--test_b 64)
    over that root from the epoch-5 .npz and from a .pth that
    export_encoder_pth wrote of the same weights (bit-equal embeddings,
    identical reports), the cross test over a csv set of 1,024 JPEGs
    (cv2 and pandas) and the synthetic cross test (12 launches per
    encoder call), and on the card pair_score_device (scores within 1e-5
    of the host's f64, equal totals) and cross_score_device (equal
    totals; cumulative histograms within the count of host scores near a
    bin edge). A phase whose library is absent prints "not run: <library>
    absent";
    [kernel_variants] rows 15-18 against their plain versions: the packed
    entry's grouped route (head_group 4) at Swin50's N=49 shapes, its
    forward and backward once more under autograd with the counts set to
    0 (the path that launches rows 15/16; no model takes it); the spatial
    kernels at the AlterNet50 shapes and Swin50's window-7 ones, beside
    partition + row-1/row-2 kernel + reverse; the entry-fused forward and
    all-in-kernel backward at the AlterNet50 shapes (the bf16 forward on
    the tensor cores, route checked), beside F.linear + the row-1 kernel
    and the hybrid backward, their sums repeated bit for bit; masked and
    unmasked, bf16 and f32; and bf16 at C = 72, beyond the tensor-core
    tile, both on the CUDA cores;
    [alternet50_spatial] / [alternet50_entry_fused] full-width AlterNet50
    through the spatial route and the entry-fused route (hybrid and
    all-in-kernel backward): the golden, three bf16 training steps against
    the windows route (losses 1e-3 relative, 12 + 12 launches per step on
    the route's counters; every forward on the tensor cores, and the
    backward too except the all-in-kernel one), ms per step, one f32
    encoder backward
    (gradients norm-wise 1e-3), a torch.profiler breakdown of the route's
    step; every switch restored;
    [alternet_sep50] the serving CLI (1 packed + 9 per-head launches per
    call), the golden, a 6-epoch training CLI run; [alternet_v1_50] the
    serving CLI at --img_size 112 and the golden; [dw_taps] EffiAlter_m
    with DepthwiseTaps against the depthwise conv (f32, 1e-5);
    [tools] the four user tools: 64 JPEGs of 250 px through
    fd_processing (the Haar cascade where cv2 has objdetect and a cascade
    is found, else the centre crop; it says which), pack_dataset over the
    crops, tools/embed.py with full-width AlterNet50 at 192 px in bf16 from
    an .npz and from a .pth of the same weights (bit-equal to each other
    and to make_embed_step on the same batches, unit norm, 12 row-1
    tensor-core launches per encoder call, counted from 0 just before),
    convert_bcolz where libblosc is present; [profile_cli] the training
    CLI (AlterNet50, bf16, b=128) with --profile 2: the Chrome trace holds
    two profiler steps and 24 launches each of the row-1 and row-2
    tensor-core kernels, and whether TBLog/ was written;
    [bench] python -m fr_tpu_torch.bench over four of its seven rows
    (alternet50, webface42m_head, embed_r100, r100_realdata), 5 timed
    steps, one repeat: its JSON line, every row with imgs/s > 0, a
    non-null mfu and this card's name, and the attention and sparse-row
    rows' kernel launches per step (12 + 12, 1 + 1);
16. [profile] torch.profiler over 5 training steps of Swin50 and of
    EffiAlter_m (bf16, b=128, the full ms1m head at sample_rate 0.3), of
    AlterNet50 and Swin50 with FR_ATTN_STORED_STATS=1 (the stats arm on the
    tensor cores), and of the webface42m step of phase 13 at sample_block
    64 and 1, and with use_fused on (that step at 64, and AlterNet50's at
    the full ms1m head), the three margin-CE kernels on the tensor cores:
    wall per step, device busy, idle share, launches per step, time by
    family, and the head's device time inside the step (the kernels
    launched in train/step.py's pfc_head:* ranges).

Every kernel's launches in the JSON line are counted on its main path
(phases 4, 6, 7, 8, 9 and 13; rows 15/16 on [kernel_variants]'s driven
calls, rows 17/18 on [alternet50_spatial] and [alternet50_entry_fused],
rows 3/4 and 7/8 on the stats switch of phases 8 and 9; rows 9-11 on
phase 7's fused arm), each run with the counts set to 0 just before it.
On those paths every launch of the attention forward and backward must
take the tensor-core kernels (fused_window_attn.route_launches, set to 0
with the counts): 12 + 12 per AlterNet50 step, 14 + 14 per Swin50 step, 4 + 4 per
EffiAlter_m step, the stats arm's too; on the entry-fused route 12 + 12
with the hybrid backward and 12 + 0 with the all-in-kernel one (its
backward is a CUDA-core kernel of its own). The CUDA-core bodies are
held against their plain versions by the f32 and out-of-tile bf16 calls
of phase 3 and [kernel_variants], and run in f32 by the goldens and the
stats switch's encoder gradients.

The last three lines are the kernel JSON line, the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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
# rounds to bf16 before the products); the tensor-core pair with two
# coefficient terms against the plain twin with two (f32 products of the
# f32 sum of the terms) 1e-4, which the one-term body fails (~1e-3)
CE_STATS_RTOL = 1e-4
CE_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
CE_GRAD_2TERM_RTOL = 1e-4
CE_SHAPE = (128, 512, 26007)   # ms1m_arcface_122: b, emd, int(0.3·86,690)
CE_WEBFACE_SHAPE = (128, 512, 205952)   # webface42m at sample_block 64
CE_VIT_L_SHAPE = (384, 512, 617984)   # vit_l_wf42m: b 384, 0.3 in groups
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
R100_GOLDEN = ROOT / "tests" / "data" / "resnet100_golden.npz"
R100_TRAIN_GOLDEN = ROOT / "tests" / "data" / "resnet100_train_golden.npz"
# webface42m: 2,059,906 classes in groups of 64 at sample_rate 0.1. fr_tpu's
# load_config resets the config's own sample_rate to 1.0 unless it is passed
# (ROADMAP §3), so it is passed.
WEBFACE_ARGS = ["--config", "webface42m", "--network", "ResNet100",
                "--sample_rate", "0.1", "--synthetic", "--device", "cuda"]
WEBFACE_BLOCK = 64
# updates against their plain versions: nvcc contracts mom·buf + g and the
# AdamW sums into fused multiply-adds, the plain version rounds each product
ROWS_RTOL, ROWS_ATOL = 1e-5, 1e-6
# tables read and written per sampled row: (in, out)
ROWS_TRAFFIC = {"grouped_gather": (1, 1), "grouped_update_sgd": (3, 2),
                "grouped_update_adamw": (4, 3)}
ROWS_FLOPS = {"grouped_gather": 0, "grouped_update_sgd": 6,
              "grouped_update_adamw": 16}   # per element
RESUME_EPOCHS = 7


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


def _routes():
    from fr_tpu_torch.ops.fused_window_attn import route_launches
    return route_launches


def _reset_routes():
    routes = _routes()
    for key in routes:
        routes[key] = 0


def _check_routes(tag, fwd, bwd):
    """Since the last _reset_routes, ``fwd`` forward and ``bwd`` backward
    launches went through the tensor-core kernels and none through the
    CUDA-core ones."""
    r = _routes()
    print(f"{tag} tensor-core launches: forward {r['fwd_tensor_cores']}, "
          f"backward {r['bwd_tensor_cores']} (CUDA-core "
          f"{r['fwd_cuda_cores']}, {r['bwd_cuda_cores']})")
    check(r == {"fwd_tensor_cores": fwd, "fwd_cuda_cores": 0,
                "bwd_tensor_cores": bwd, "bwd_cuda_cores": 0},
          f"{tag} launches by route {r}, expected {fwd} forward and {bwd} "
          f"backward on the tensor cores")


def _route_of(call):
    """Runs call() and returns the body its one launch took: "tensor_cores"
    or "cuda_cores"."""
    before = dict(_routes())
    out = call()
    moved = [k for k, v in _routes().items() if v != before[k]]
    check(len(moved) == 1, f"one launch expected, the routes moved {moved}")
    return moved[0].split("_", 1)[1], out


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)


def _ptxas_table(log):
    """[(kernel, template arguments, registers, spill stores, spill loads)]
    from nvcc's -Xptxas -v lines, one entry per compiled kernel."""
    import re
    table, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d([a-z_]+_kernel)(I.*?E+v)?", m.group(1))
            args = (k.group(2) if k else None) or ""
            parts = [a or b or c for a, b, c in re.findall(
                r"Li(\d+)E|Lb(\d)E|(WindowRows|SpatialRows|__nv_bfloat16)",
                args)]
            name = (k.group(1) if k else m.group(1), ",".join(parts))
            spills = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table.append((*name, int(m.group(1)), *spills))
            name = None
    return table


def phase_build():
    """Builds the kernels and prints one line per compiled kernel: its
    registers and spills (nvcc -Xptxas -v). The tensor-core kernels'
    template arguments are <tiles of 16 tokens, tiles of 16 head channels,
    row layout>."""
    from fr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> "
          f"{_build.library_path().relative_to(ROOT)}")
    table = _ptxas_table(_build.build_log_path().read_text())
    for kernel in ("window_attn_fwd_tc_kernel", "window_attn_bwd_tc_kernel",
                   "window_attn_fwd_stats_tc_kernel",
                   "window_attn_bwd_stats_tc_kernel",
                   "window_attn_qkv_fwd_tc_kernel",
                   "window_attn_qkv_bwd_tc_kernel",
                   "window_attn_qkv_grad_mma_kernel",
                   "margin_ce_stats_tc_kernel",
                   "margin_ce_grad_emb_tc_kernel",
                   "margin_ce_grad_w_tc_kernel", "bn_stats_kernel",
                   "bn_apply_kernel", "bn_bwd_reduce_kernel",
                   "bn_bwd_apply_kernel", "global_attn_fwd_kernel",
                   "global_attn_bwd_kernel"):
        check(any(k == kernel for k, *_ in table),
              f"the build log lists no {kernel}")
    for kernel, args, regs, st, ld in table:
        print(f"[build] {kernel}<{args}>: {regs} registers, spill stores "
              f"{st} B, loads {ld} B")


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
                route, out = _route_of(
                    lambda: kernel(*args, nw, mask, out_dtype=dt))
                torch.cuda.synchronize()
                ref = window_attention_reference(*args, mask, dt)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()),
                      f"{name} kernel output is not finite")
                err = (out.float() - ref.float()).abs().max().item()
                ms = time_ms(lambda: kernel(*args, nw, mask, out_dtype=dt))
                plain = time_ms(lambda: window_attention_reference(
                    *args, mask, dt))
                bf16 = dt == torch.bfloat16
                lib = (_library_fwd_ms(qkv, scale, bias16, mask, heads)
                       if bf16 else None)
                tag = f"{name} {'masked' if masked else 'unmasked'} " \
                      f"{str(dt).split('.')[-1]}"
                print(f"[kernel] {tag:26s} ({bw},{n},{3 * c}) "
                      f"max_abs_err {err:.3e} (tol {tol:g})  kernel "
                      f"({route}) {ms:.4f} ms  plain {plain:.4f} ms" +
                      (f"  sdpa {lib:.4f} ms" if bf16 else ""))
                check(route == ("tensor_cores" if bf16 else "cuda_cores"),
                      f"{tag} took the {route} body")
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
                route, ours = _route_of(
                    lambda: kernel(qkv, scale, bias16, g, heads, nw, mask))
                torch.cuda.synchronize()
                bf16 = dt == torch.bfloat16
                check(route == ("tensor_cores" if bf16 else "cuda_cores"),
                      f"{name} backward took the {route} body")
                again = kernel(qkv, scale, bias16, g, heads, nw, mask)
                check(all(torch.equal(a, b) for a, b in zip(ours, again)),
                      f"{name} the backward's sums changed between two runs")
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
                       if bf16 else None)
                print(f"[kernel_bwd] {tag:26s} err/tol {', '.join(errs)}  "
                      f"kernel ({route}) {ms:.4f} ms  plain {plain_ms:.4f} "
                      f"ms" + (f"  sdpa {lib:.4f} ms" if bf16 else "") +
                      "; sums bitwise equal over two runs")
                times[(name, masked, dt)] = (ms, plain_ms, lib)
    return worst, times


def _webface_ce_columns(gen):
    """The target columns and the column mask of one webface42m step at
    sample_block 64, made as the step makes them: 128 labels over all
    2,059,906 classes (one in the partly padded last group, so that the
    mask has False columns), the groups drawn for them, the labels' columns
    among the expanded index, and col_valid = idx < num_classes."""
    import torch
    from fr_tpu_torch.heads.partial_fc import (PFCConfig, label_columns,
                                               sample_groups,
                                               shard_group_masks)
    from fr_tpu_torch.ops.sparse_rows import expand_group_index

    cfg = PFCConfig(2059906, 512, sample_rate=0.1, sample_block=WEBFACE_BLOCK)
    labels = torch.randint(0, cfg.num_classes, (CE_WEBFACE_SHAPE[0],),
                           device="cuda", generator=gen)
    labels[0] = cfg.num_classes - 1
    gidx = sample_groups(cfg, gen, *shard_group_masks(cfg, 0, labels,
                                                      labels >= 0))
    idx = expand_group_index(gidx, cfg.sample_block)
    cols, cv = label_columns(cfg, labels, idx), idx < cfg.num_classes
    check(idx.shape[0] == CE_WEBFACE_SHAPE[2] and bool((cols >= 0).all())
          and int((~cv).sum()) == cfg.num_classes_padded - cfg.num_classes,
          "[margin_ce] the webface42m columns")
    return cols, cv


CE_BWD = ("margin_ce_grad_emb", "margin_ce_grad_w")
CE_KERNELS = ("margin_ce_stats", *CE_BWD)


def _ce_launches(tc):
    """route_launches of the margin-CE kernels on one body, in CE_KERNELS
    order."""
    from fr_tpu_torch.ops.fused_pfc import route_launches
    body = "tensor_cores" if tc else "cuda_cores"
    return [route_launches[f"{k[len('margin_ce_'):]}_{body}"]
            for k in CE_KERNELS]


def _reset_ce_routes():
    from fr_tpu_torch.heads.partial_fc import shard_softmax_ce
    from fr_tpu_torch.ops.fused_pfc import route_launches
    for key in route_launches:
        route_launches[key] = 0
    shard_softmax_ce.routes.clear()


def phase_margin_ce():
    """The three margin-CE kernels vs their plain versions at the
    ms1m_arcface_122 head, at the webface42m head (205,952 columns, the
    step's own labels and column mask) and at small ragged shapes. Every
    call's body is checked (bf16 with D % 16 == 0 on the tensor cores, f32
    and D = 40 on the CUDA cores: those are the CUDA-core kernels' checks),
    and the tensor-core results repeat bit for bit. Timed at both heads,
    bf16 ArcFace: each row, its plain version and the cuBLAS products it
    contains (not the same function: no margin, softmax or coeff). At the
    two heads and ViT-L's (CE_2TERM_SHAPES) the backward pair also runs
    with two coefficient terms, the plain CE's (_ce_two_terms), timed by
    the profiler beside its plain twin. Returns ({kernel: max abs error;
    the statistics' is the loss's}, {(kernel, K): {"ms", "plain_ms",
    "cublas_ms"}}); the tensor-core kernels carry the suffix _tc, the
    two-term bodies _tc_2term (errors) and _2term (times)."""
    import torch
    from fr_tpu_torch.heads.partial_fc import PFCConfig
    from fr_tpu_torch.ops import fused_pfc as F

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = dict.fromkeys((*CE_KERNELS, *(f"{k}_tc" for k in CE_KERNELS),
                           *(f"{k}_tc_2term" for k in CE_BWD)), 0.0)
    times = {}
    for margin, (n, d, k), dt in (
            ("ArcFace", CE_SHAPE, torch.bfloat16),
            ("ArcFace", CE_SHAPE, torch.float32),
            ("CosFace", CE_SHAPE, torch.bfloat16),
            ("ArcFace", CE_WEBFACE_SHAPE, torch.bfloat16),
            ("ArcFace", CE_WEBFACE_SHAPE, torch.float32),
            ("CosFace", CE_VIT_L_SHAPE, torch.bfloat16),
            ("CosFace", (130, 512, 131), torch.bfloat16),
            ("ArcFace", (10, 48, 300), torch.bfloat16),
            ("ArcFace", (10, 48, 65), torch.bfloat16),
            ("ArcFace", (10, 40, 131), torch.bfloat16),
            ("ArcFace", (10, 40, 131), torch.float32)):
        def unit(*shape):
            x = torch.randn(*shape, device="cuda", generator=gen)
            return (x / x.norm(dim=1, keepdim=True)).to(dt)
        emb, w = unit(n, d), unit(k, d)
        if (n, d, k) == CE_WEBFACE_SHAPE:
            labels, cv = _webface_ce_columns(gen)
        else:
            labels = torch.randint(-1, k - 3, (n,), device="cuda",
                                   generator=gen)
            cv = torch.arange(k, device="cuda") < k - 3
        g = torch.rand(n, device="cuda", generator=gen) + 0.5
        g[5] = 0.0   # a row under the 1e-30 clamp
        cfg = PFCConfig(num_classes=k, embedding_size=d, margin=margin,
                        s=30.0, m=0.35,
                        mixed_precision=dt == torch.bfloat16)
        args = (emb, w, labels, cv)
        ref = F.margin_ce_stats_reference(*args, cfg)
        tag = f"{margin} ({n},{d},{k}) {str(dt).split('.')[-1]}"
        tc = F.tensor_core_route(dt, d)
        suffix = "_tc" if tc else ""
        _reset_ce_routes()
        stats = F.margin_ce_stats(*args, cfg)
        torch.cuda.synchronize()
        check(_ce_launches(tc) == [1, 0, 0]
              and _ce_launches(not tc) == [0, 0, 0],
              f"[margin_ce] {tag}: stats took {dict(F.route_launches)}")
        if tc:
            again = F.margin_ce_stats(*args, cfg)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(stats, again)),
                  f"[margin_ce] {tag}: two tensor-core stats calls differ")
        stats_rel = _ce_stats_rel(stats, ref)
        check(stats_rel <= CE_STATS_RTOL, f"[margin_ce] {tag} "
              f"margin_ce_stats{suffix}: elementwise rel {stats_rel} > "
              f"{CE_STATS_RTOL}")
        stats_err = _ce_loss_err(stats, ref)
        worst["margin_ce_stats" + suffix] = max(
            worst["margin_ce_stats" + suffix], stats_err)
        m, dd, _ = ref
        rge, rgw = F.margin_ce_backward_reference(*args, m, dd, g, cfg)
        tol = CE_GRAD_RTOL[str(dt).split(".")[-1]]
        _reset_ce_routes()
        out = (F.margin_ce_grad_emb(*args, m, dd, g, cfg),
               F.margin_ce_grad_w(*args, m, dd, g, cfg))
        torch.cuda.synchronize()
        check(_ce_launches(tc) == [0, 1, 1]
              and _ce_launches(not tc) == [0, 0, 0],
              f"[margin_ce] {tag}: the backward took "
              f"{dict(F.route_launches)}")
        if tc:
            again = (F.margin_ce_grad_emb(*args, m, dd, g, cfg),
                     F.margin_ce_grad_w(*args, m, dd, g, cfg))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"[margin_ce] {tag}: two tensor-core calls differ")
            del again
        rels = {}
        for name, a, b in zip(CE_BWD, out, (rge, rgw)):
            check(bool(torch.isfinite(a).all()),
                  f"{name}{suffix} is not finite")
            rel = ((a - b).norm() / b.norm()).item()
            check(rel <= tol, f"{tag} {name}{suffix}: norm-wise {rel} > "
                  f"{tol}")
            worst[name + suffix] = max(worst[name + suffix],
                                       (a - b).abs().max().item())
            rels[name + suffix] = rel
        print(f"[margin_ce] {tag:32s} loss err {stats_err:.2e}; stats "
              f"elementwise against the plain version (tol "
              f"{CE_STATS_RTOL:g}): margin_ce_stats{suffix} {stats_rel:.1e}"
              f"; gradients norm-wise (tol {tol:g}): " + ", ".join(
                  f"{key} {v:.1e}" for key, v in rels.items()))
        if tc and (n, d, k) in CE_2TERM_SHAPES:
            _ce_two_terms(tag, args, m, dd, g, cfg, out, worst)
        if (n, d, k) in (CE_SHAPE, CE_WEBFACE_SHAPE) \
                and dt == torch.bfloat16 and margin == "ArcFace":
            coeff = F.margin_ce_coeff_reference(*args, m, dd, g, cfg).to(dt)

            def plain(name, terms=1):
                c = F.coeff_terms(F.margin_ce_coeff_reference(
                    *args, m, dd, g, cfg), dt, terms)
                return (c @ w.float() if name == "margin_ce_grad_emb"
                        else c.t() @ emb.float())
            product = {"margin_ce_grad_emb": lambda: coeff @ w,
                       "margin_ce_grad_w": lambda: coeff.t() @ emb}
            cublas = {nm: lambda p=p: (emb @ w.t(), p())
                      for nm, p in product.items()}
            kern = {"margin_ce_grad_emb": F.margin_ce_grad_emb,
                    "margin_ce_grad_w": F.margin_ce_grad_w}
            call = lambda: F.margin_ce_stats(*args, cfg)  # noqa: E731
            times[("margin_ce_stats", k)] = {
                "ms": time_ms(call),
                "plain_ms": time_ms(lambda: F.margin_ce_stats_reference(
                    *args, cfg)),
                "cublas_ms": time_ms(lambda: emb @ w.t())}
            for name in CE_BWD:
                call = lambda f=kern[name]: f(  # noqa: E731
                    *args, m, dd, g, cfg)
                times[(name, k)] = {
                    "ms": time_ms(call),
                    "plain_ms": time_ms(lambda nm=name: plain(nm)),
                    "cublas_ms": time_ms(cublas[name])}
                # the two-term body, device time by the profiler; its
                # cuBLAS products: the logits and one per term
                call = lambda f=kern[name]: f(  # noqa: E731
                    *args, m, dd, g, cfg, 2)
                times[(name + "_2term", k)] = {
                    "ms": _device_ms(call),
                    "plain_ms": _device_ms(lambda nm=name: plain(nm, 2)),
                    "cublas_ms": _device_ms(lambda nm=name: (
                        cublas[nm](), product[nm]()))}
            del coeff
        del emb, w, stats, ref, rge, rgw, out
        torch.cuda.empty_cache()

    def bound(name, k):
        return "bound {:.4f} ({})".format(*_ce_bound(name, (128, 512, k)))

    def share(name, k, ms):
        return 100 * _ce_bound(name, (128, 512, k))[0] / ms
    print("[margin_ce] row 9, bf16 ArcFace, tensor cores against the plain "
          "version and the cuBLAS product emb @ W.T (not the same "
          "function): " + "; ".join(
              f"K={k:,} {t['ms']:.4f} ms ({share(nm, k, t['ms']):.1f}% of "
              f"bound), plain {t['plain_ms']:.4f}, "
              f"cuBLAS {t['cublas_ms']:.4f}, {bound(nm, k)}"
              for (nm, k), t in times.items() if nm == "margin_ce_stats"))
    print("[margin_ce] rows 10/11, bf16 ArcFace, tensor cores against the "
          "plain version and the cuBLAS products (not the same function): "
          + "; ".join(
              f"row {10 + CE_BWD.index(nm)} K={k:,} {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f}, cuBLAS "
              f"{t['cublas_ms']:.4f}, {bound(nm, k)}"
              for (nm, k), t in times.items() if nm in CE_BWD))
    print("[margin_ce] rows 10/11 with two coefficient terms (the plain "
          "CE's), bf16 ArcFace, device ms (profiler) against the two-term "
          "plain twin and the cuBLAS products (the logits, one per term): "
          + "; ".join(
              f"row {10 + CE_BWD.index(nm[:-6])} K={k:,} {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f}, cuBLAS {t['cublas_ms']:.4f}, "
              "bound {:.4f} ({})".format(*_ce_bound(nm[:-6], (128, 512, k),
                                                    terms=2))
              for (nm, k), t in times.items() if nm.endswith("_2term")))
    _ce_plain_route()
    print(f"[margin_ce] {time.perf_counter() - t0:.1f} s")
    return worst, times


# the heads at which [margin_ce] checks the two-term backward pair
CE_2TERM_SHAPES = (CE_SHAPE, CE_WEBFACE_SHAPE, CE_VIT_L_SHAPE)


def _ce_two_terms(tag, args, m, dd, g, cfg, one_term, worst):
    """The backward pair with two coefficient terms (the plain CE's) at one
    case of [margin_ce]: one launch each on the two-term body per call, two
    calls bit for bit equal, within CE_GRAD_2TERM_RTOL norm-wise of the
    two-term plain twin, which the one-term results (one_term) exceed."""
    import torch
    from fr_tpu_torch.ops import fused_pfc as F

    ref = F.margin_ce_backward_reference(*args, m, dd, g, cfg, terms=2)
    _reset_ce_routes()
    out = [(F.margin_ce_grad_emb(*args, m, dd, g, cfg, 2),
            F.margin_ce_grad_w(*args, m, dd, g, cfg, 2)) for _ in range(2)]
    torch.cuda.synchronize()
    launches = {key: v for key, v in F.route_launches.items() if v}
    check(launches == {"grad_emb_tensor_cores_2term": 2,
                       "grad_w_tensor_cores_2term": 2},
          f"[margin_ce] {tag}: two two-term backward calls took {launches}")
    check(all(torch.equal(a, b) for a, b in zip(*out)),
          f"[margin_ce] {tag}: two two-term calls differ")
    rels = {}
    for name, a, a1, b in zip(CE_BWD, out[0], one_term, ref):
        key = name + "_tc_2term"
        check(bool(torch.isfinite(a).all()), f"{key} is not finite")
        rel = ((a - b).norm() / b.norm()).item()
        rel1 = ((a1 - b).norm() / b.norm()).item()
        check(rel <= CE_GRAD_2TERM_RTOL < rel1, f"[margin_ce] {tag} {key}: "
              f"norm-wise {rel} from the two-term twin, the one-term body "
              f"{rel1} (limit {CE_GRAD_2TERM_RTOL:g}: two terms within it, "
              f"one beyond)")
        worst[key] = max(worst[key], (a - b).abs().max().item())
        rels[key] = (rel, rel1)
    print(f"[margin_ce] {tag:32s} two coefficient terms, norm-wise against "
          f"the two-term twin (tol {CE_GRAD_2TERM_RTOL:g}): " + ", ".join(
              f"{key} {r:.1e} (the one-term body {r1:.1e})"
              for key, (r, r1) in rels.items()))


# the train cells' heads the plain CE runs at: (cell, N, D, K, margin, s, m)
CE_PLAIN_HEADS = (("vit_l_wf42m", 384, 512, 617984, "CosFace", 64.0, 0.4),
                  ("r100_wf42m", 256, 512, 411968, "CosFace", 64.0, 0.4))


def _ce_plain_route():
    """The plain CE (use_fused off) on the card at the CE_PLAIN_HEADS:
    device ms (profiler) of its three launches on the kernels (the stats,
    the pair with two coefficient terms), and of the whole CE, forward and
    backward through shard_softmax_ce from the f32 rows, on the kernels and
    in plain PyTorch (plain_kernel_route patched off), whose per-sample
    losses agree to 1e-4 relative. Then one ViT-L training step
    (_vit_l_step): 1 stats, 1 + 1 two-term launches, every CE call on the
    kernels. Returns {cell: {part: ms}}."""
    import torch
    from fr_tpu_torch.heads import partial_fc as P
    from fr_tpu_torch.models.common import l2_normalize
    from fr_tpu_torch.ops import fused_pfc as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for cell, n, d, k, margin, s, m in CE_PLAIN_HEADS:
        cfg = P.PFCConfig(num_classes=k, embedding_size=d, margin=margin,
                          s=s, m=m, mixed_precision=True)
        emb = l2_normalize(torch.randn(n, d, device="cuda", generator=gen))
        w = 0.01 * torch.randn(k, d, device="cuda", generator=gen)
        labels = torch.randint(0, k, (n,), device="cuda", generator=gen)
        cv = torch.arange(k, device="cuda") < k - 40
        args = (emb.to(torch.bfloat16), l2_normalize(w).to(torch.bfloat16),
                labels, cv)
        md, dd, _ = F.margin_ce_stats(*args, cfg)
        g = torch.full((n,), 1.0 / n, device="cuda")
        ms = {"stats": _device_ms(lambda: F.margin_ce_stats(*args, cfg),
                                  iters=10),
              "grad_emb_2term": _device_ms(lambda: F.margin_ce_grad_emb(
                  *args, md, dd, g, cfg, 2), iters=10),
              "grad_w_2term": _device_ms(lambda: F.margin_ce_grad_w(
                  *args, md, dd, g, cfg, 2), iters=10)}
        e, ww = emb.requires_grad_(True), w.requires_grad_(True)

        def ce():
            loss = P.shard_softmax_ce(cfg, e, labels, ww, cv)
            torch.autograd.grad(loss.mean(), [e, ww])
            return loss.detach()
        losses = {}
        for route in ("plain_kernels", "plain_torch"):
            with _ce_arm(route):
                losses[route] = ce()
                ms[f"ce_{route}"] = _device_ms(ce, iters=5)
                check(set(P.shard_softmax_ce.routes) == {route},
                      f"[margin_ce] {cell}: the CE took "
                      f"{dict(P.shard_softmax_ce.routes)}, not {route}")
        rel = ((losses["plain_kernels"] - losses["plain_torch"]).abs()
               / losses["plain_torch"]).max().item()
        check(rel <= 1e-4, f"[margin_ce] {cell}: the plain CE's losses on "
              f"the kernels and in PyTorch differ by {rel} relative")
        print(f"[margin_ce] plain CE at the {cell} head ({n}, {d}, {k:,}) "
              f"{margin}, device ms (profiler): stats {ms['stats']:.3f}, "
              f"grad_emb two-term {ms['grad_emb_2term']:.3f}, grad_w "
              f"two-term {ms['grad_w_2term']:.3f}; the CE forward and "
              f"backward on the kernels {ms['ce_plain_kernels']:.3f} against "
              f"{ms['ce_plain_torch']:.3f} in plain PyTorch; losses "
              f"{rel:.1e} relative apart")
        out[cell] = ms
        del emb, w, e, ww, args, md, dd, losses
        torch.cuda.empty_cache()
    loss, _ = _vit_l_step("[margin_ce]")
    launches = {key: v for key, v in F.route_launches.items() if v}
    routes = dict(P.shard_softmax_ce.routes)
    print(f"[margin_ce] one ViT-L training step: margin-CE launches "
          f"{launches}, CE routes {routes}, loss {loss:.4f}")
    check(launches == {"stats_tensor_cores": 1,
                       "grad_emb_tensor_cores_2term": 1,
                       "grad_w_tensor_cores_2term": 1}
          and routes == {"plain_kernels": 1} and math.isfinite(loss),
          f"[margin_ce] ViT-L step: launches {launches}, routes {routes}, "
          f"loss {loss}")
    return out


def _ce_stats_rel(a, b):
    """The largest elementwise relative difference of (m, d, t) a from b."""
    return max(((x - y).abs() / y.abs().clamp_min(1e-30)).max().item()
               for x, y in zip(a, b))


def _ce_loss_err(a, b):
    """The largest difference of the losses −log(t/d) that a and b give."""
    import torch

    def loss(mdt):
        return -torch.log(torch.clamp_min(mdt[2] / mdt[1], 1e-30))
    return (loss(a) - loss(b)).abs().max().item()


class _EncoderCalls:
    """Counts forward calls of one encoder class (AlterNet by default) in
    training and in eval mode, and of BatchNorm modules (``bn_train``,
    ``bn_eval``)."""

    def __init__(self, cls=None):
        import torch
        from fr_tpu_torch.models.alternet import AlterNet
        from fr_tpu_torch.models.common import _FlaxBatchNorm

        cls = cls or AlterNet
        self.counts = {"train": 0, "eval": 0, "bn_train": 0, "bn_eval": 0}

        def hook(module, args, output):
            if isinstance(module, cls):
                self.counts["train" if module.training else "eval"] += 1
            elif isinstance(module, _FlaxBatchNorm):
                self.counts["bn_train" if module.training else "bn_eval"] += 1

        self.handle = torch.nn.modules.module.register_module_forward_hook(
            hook)

    def close(self):
        self.handle.remove()


def phase_main_path():
    """The CLI's serving path; returns (kernel launches, encoder calls, the
    BatchNorm kernels' launches by entry point)."""
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
            _zero_bn()
            _reset_routes()
            msg = cli_main(CLI_ARGS + ["--save_root", tmp])
            launches = kernel.launches
    finally:
        calls.close()
    n_calls = calls.counts["eval"]
    print(f"[main] encoder calls {n_calls}, kernel launches {launches}")
    bn = _bn_launches("[main]", calls, 0)
    _check_routes("[main]", launches, 0)
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
    return launches, n_calls, bn


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
    launches, steps, the BatchNorm kernels' launches by entry point)."""
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
            _zero_bn()
            _reset_routes()
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
    # AlterNet50's BatchNorms all see (M, C) rows, gradients too
    bn = _bn_launches("[train]", calls, 0)
    check(steps == expected, f"{steps} training steps, expected {expected}")
    _check_routes("[train]", *launches)
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
    return launches[0], launches[1], steps, bn


# the margin-CE arms of the training phases, each named by the route its
# CE calls take (shard_softmax_ce.routes): (name, use_fused)
CE_ARMS = (("plain_torch", False), ("plain_kernels", False), ("fused", True))
# the margin-CE launches by body of each arm's step, at a bf16 D 512 head
CE_ARM_BODIES = {
    "plain_torch": (),
    "plain_kernels": ("stats_tensor_cores", "grad_emb_tensor_cores_2term",
                      "grad_w_tensor_cores_2term"),
    "fused": ("stats_tensor_cores", "grad_emb_tensor_cores",
              "grad_w_tensor_cores")}


@contextlib.contextmanager
def _ce_arm(arm):
    """Within it, the plain CE of the plain_torch arm (CE_ARMS) stays in
    PyTorch on the card (fused_pfc.plain_kernel_route patched off); the
    margin-CE counters are cleared on entry. The arm's use_fused is the
    caller's to set."""
    from fr_tpu_torch.ops import fused_pfc as F
    route = F.plain_kernel_route
    if arm == "plain_torch":
        F.plain_kernel_route = lambda emb, cfg: False
    _reset_ce_routes()
    try:
        yield
    finally:
        F.plain_kernel_route = route


def _ce_arm_launches():
    """The margin-CE launches by body and the CE calls by route since
    _reset_ce_routes(), the bodies and routes with a count only."""
    from fr_tpu_torch.heads.partial_fc import shard_softmax_ce
    from fr_tpu_torch.ops.fused_pfc import route_launches
    return ({k: v for k, v in route_launches.items() if v},
            {k: v for k, v in shard_softmax_ce.routes.items() if v})


def _check_ce_arms(tag, losses, launches, steps):
    """Each arm launched each margin-CE kernel of its bodies (CE_ARM_BODIES)
    once per step (of its ``steps``) and no other (launches: {arm:
    _ce_arm_launches()}), every CE call on its arm's route; the losses of
    the plain CE on the kernels sit within 1e-4 of the plain CE in PyTorch
    at the first step (the same weights) and within 2e-2 after, the fused
    CE's within 2e-2."""
    expect = {arm: (dict.fromkeys(CE_ARM_BODIES[arm], steps), {arm: steps})
              for arm, _ in CE_ARMS}
    check(launches == expect, f"{tag} the margin-CE launches and CE routes "
          f"by arm {launches} over {steps} steps, not {expect}")
    plain = losses["plain_torch"]
    for arm, first in (("plain_kernels", 1e-4), ("fused", 2e-2)):
        for i, (a, b) in enumerate(zip(plain, losses[arm])):
            tol = first if i == 0 else 2e-2
            check(abs(a - b) <= tol * abs(a), f"{tag} loss {i} of the "
                  f"{arm} CE {b} vs the plain CE in PyTorch {a}: beyond "
                  f"{tol:g} relative")
    print(f"{tag} losses " + ", ".join(
        f"{arm} {[round(x, 4) for x in v]}" for arm, v in losses.items()))


def phase_train_full_head(steps: int = 3, timed: int = 10):
    """training_step at the full ms1m_arcface_122 head from one seed, in
    the three arms of CE_ARMS: use_fused off with the plain CE kept in
    PyTorch, off (the plain CE on the kernels, two coefficient terms), and
    on. Launches and losses as _check_ce_arms says; ms per step. Returns
    the launches of the stats and the two-term pair (suffixes _tc,
    _tc_2term) in the plain_kernels arm, the main path's, and of the
    one-term pair (_tc) in the fused arm, each over ``steps`` steps."""
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
    losses, routes = {}, {}
    for arm, fused in CE_ARMS:
        conf.use_fused = fused
        with _ce_arm(arm):
            task = FaceRecognitionTask(conf, stage="train", device=dev,
                                       seed=0)
            for k in kernels:
                k.launches = 0
            losses[arm] = [task.training_step((images[i], labels[i]))[
                "loss"].item() for i in range(steps)]
            counts = [k.launches for k in kernels]
            routes[arm] = _ce_arm_launches()
            t0 = time.perf_counter()
            for i in range(steps, n):
                out = task.training_step((images[i], labels[i]))
            out["loss"].item()
            ms = (time.perf_counter() - t0) * 1e3 / timed
        print(f"[train_full_head] use_fused={fused}, the CE {arm}: "
              f"{conf.n_classes:,} classes, {task.pfc_cfg.num_sample:,} "
              f"sampled, b={conf.b}: losses "
              f"{[round(x, 4) for x in losses[arm]]}; {ms:.2f} ms per step, "
              f"{conf.b * 1e3 / ms:.1f} imgs/s (host clock over {timed} "
              f"steps); margin-CE launches {counts}")
        want = [0] * 3 if arm == "plain_torch" else [steps] * 3
        check(counts == want, f"margin-CE launches {counts} over {steps} "
              f"steps in the {arm} arm")
        del task
    _check_ce_arms("[train_full_head]", losses, routes, steps)
    main, fused = routes["plain_kernels"][0], routes["fused"][0]
    return {"margin_ce_stats_tc": main["stats_tensor_cores"],
            "margin_ce_grad_emb_tc": fused["grad_emb_tensor_cores"],
            "margin_ce_grad_w_tc": fused["grad_w_tensor_cores"],
            "margin_ce_grad_emb_tc_2term":
                main["grad_emb_tensor_cores_2term"],
            "margin_ce_grad_w_tc_2term": main["grad_w_tensor_cores_2term"]}


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
            bf16 = dt == torch.bfloat16
            want = "tensor_cores" if bf16 else "cuda_cores"
            route, out = _route_of(lambda: F.fused_window_attention(
                *args, nw, mask, out_dtype=dt))
            check(route == want, f"[kernel_perhead] {name} took {route}")
            torch.cuda.synchronize()
            ref = F.window_attention_reference(*args, mask, dt)
            check(bool(torch.isfinite(out.float()).all()),
                  f"{name} per-head output is not finite")
            err = (out.float() - ref.float()).abs().max().item()
            tag = f"{name} {str(dt).split('.')[-1]}"
            check(err <= tol, f"[kernel_perhead] {tag}: error {err} > {tol}")
            worst_f = max(worst_f, err)
            route, ours = _route_of(lambda: F.window_attention_backward(
                qkv, scale, bias16, g, heads, nw, mask))
            check(route == want, f"[kernel_perhead] {name} backward took "
                  f"{route}")
            torch.cuda.synchronize()
            plain = F.window_attention_backward_reference(
                qkv, scale, bias16, g, heads, mask)
            worst_b = max(worst_b, _check_grads(f"[kernel_perhead] {tag}",
                                                ours, plain, dt))
            again = F.window_attention_backward(qkv, scale, bias16, g, heads,
                                                nw, mask)
            check(all(torch.equal(a, b) for a, b in zip(ours, again)),
                  f"[kernel_perhead] {tag}: the backward's sums changed "
                  f"between two runs")
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
                  f"({route}) fwd err {err:.2e} kernel {t['fwd']:.4f} plain "
                  f"{t['fwd_plain']:.4f} sdpa {t['fwd_lib']:.4f} ms; bwd "
                  f"kernel {t['bwd']:.4f} plain {t['bwd_plain']:.4f} sdpa "
                  f"{t['bwd_lib']:.4f} ms")
            if bf16:
                times[name] = t
    return worst_f, worst_b, times


def _stats_case(tag, qkv, scale, bias16, g, mask, nw, dt):
    """One shape of [kernel_stats] on the body its call takes (the tensor
    cores for bf16 on their tile, the CUDA cores for f32 and beyond it):
    the route of both launches, out and p against the plain version, out
    against the recompute forward's and dq/dk/dv against the recompute
    backward's (bit for bit on the tensor cores: the same helpers in the
    same order), the gradients against the plain version and the
    recompute kernel, p, dscale and dbias bitwise repeatable. Returns
    (body, out, p, grads, forward error, backward error)."""
    import torch
    from fr_tpu_torch.ops import fused_window_attn as F

    heads = scale.shape[0]
    bf16 = dt == torch.bfloat16
    tol = BF16_TOL if bf16 else F32_TOL
    body, (out, p) = _route_of(lambda: F.window_attention_forward_stats(
        qkv, scale, bias16, heads, nw, mask, out_dtype=dt))
    want = ("tensor_cores" if F.tensor_core_route(
        dt, qkv.shape[1], qkv.shape[2] // 3 // heads) else "cuda_cores")
    check(body == want, f"[kernel_stats] {tag} forward took {body}")
    route, grads = _route_of(lambda: F.window_attention_backward_stats(
        qkv, scale, p, g, heads))
    check(route == want, f"[kernel_stats] {tag} backward took {route}")
    torch.cuda.synchronize()
    ref_out, ref_p = F.window_attention_forward_stats_reference(
        qkv, scale, bias16, heads, mask, dt)
    recompute_out = F.fused_window_attention(qkv, scale, bias16, heads, nw,
                                             mask, out_dtype=dt)
    err_f = 0.0
    for other in (ref_out, recompute_out):
        err = (out.float() - other.float()).abs().max().item()
        check(err <= tol, f"[kernel_stats] {tag} out: {err} > {tol}")
        err_f = max(err_f, err)
    # bf16: a q̂ or k̂ element can round to the neighbouring bf16 value where
    # the card's rsqrt and the plain version's differ in the last f32 digit
    # (tests/test_torch_window_attn_stats_cuda)
    p_err = (p - ref_p).norm().item() / ref_p.norm().item()
    check(p_err <= (1e-6 if dt == torch.float32 else 1e-3),
          f"[kernel_stats] {tag} p: norm-wise {p_err}")
    plain = F.window_attention_backward_stats_reference(qkv, scale, ref_p, g,
                                                        heads)
    recompute = F.window_attention_backward(qkv, scale, bias16, g, heads, nw,
                                            mask)
    torch.cuda.synchronize()
    if dt == torch.float32:
        err_b = _check_grads(f"[kernel_stats] {tag}", grads, plain, dt)
        _check_grads(f"[kernel_stats] {tag} vs recompute", grads, recompute,
                     dt)
    else:
        # bf16 norm-wise 1e-2; dscale from the row-sum identity over
        # bf16-rounded ds·scale, 3e-2·max(|ref|, 1) as fr_tpu's own
        # stored-stats test holds it
        for other in (plain, recompute):
            for t_name, a, b in zip(("dqkv", "dscale", "dbias"), grads,
                                    other):
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
        err_b = max((a.float() - b.float()).abs().max().item()
                    for a, b in zip(grads, plain))
    if body == "tensor_cores":
        check(torch.equal(out, recompute_out), f"[kernel_stats] {tag} out "
              f"differs from the row-1 kernel's bits")
        check(torch.equal(grads[0], recompute[0]), f"[kernel_stats] {tag} "
              f"dqkv differs from the row-2 kernel's bits")
    again_out, again_p = F.window_attention_forward_stats(
        qkv, scale, bias16, heads, nw, mask, out_dtype=dt)
    again = F.window_attention_backward_stats(qkv, scale, p, g, heads)
    check(torch.equal(again_p, p) and torch.equal(again_out, out),
          f"[kernel_stats] {tag}: out or p changed between runs")
    check(torch.equal(again[1], grads[1]) and torch.equal(again[2], grads[2]),
          f"[kernel_stats] {tag}: dscale/dbias changed between runs")
    dbias_rel = ((grads[2] - recompute[2]).norm()
                 / recompute[2].norm()).item()
    print(f"[kernel_stats] {tag:30s} ({body}) out err {err_f:.2e}, p "
          f"norm-wise {p_err:.1e}, grads max-abs {err_b:.2e}; against the "
          f"recompute kernel: dbias norm-wise {dbias_rel:.1e}, dscale "
          f"{(grads[1] - recompute[1]).abs().max().item():.2e}"
          + ("; out and dqkv its bits" if body == "tensor_cores" else "")
          + "; p, dscale, dbias repeat bitwise")
    return body, out, p, grads, err_f, err_b


def phase_kernel_stats():
    """Rows 3-4 and 7-8: the stored-stats kernels at the N=49 shapes and
    the AlterNet50 packed shapes (_stats_case): bf16 on the tensor cores,
    f32 on the CUDA cores, and an odd head dim (33, bf16) beyond the
    tensor-core tile, on the CUDA cores. Times, bf16: the tensor-core
    body, the plain versions, the recompute kernels (rows 1/2 and 5/6) and
    SDPA's forward and backward. Returns ({body: max error fwd},
    {body: max error bwd}, {shape: bf16 times})."""
    import torch
    from fr_tpu_torch.ops import fused_window_attn as F

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst_f = {"tensor_cores": 0.0, "cuda_cores": 0.0}
    worst_b = dict(worst_f)
    times = {}
    cases = ([(s, _perhead_inputs) for s in PERHEAD_SHAPES]
             + [(s, _packed_inputs) for s in SHAPES])
    for shape, make in cases:
        name = shape[0]
        for dt in (torch.bfloat16, torch.float32):
            qkv, scale, bias16, g, mask, nw = make(shape, dt, gen)
            heads = scale.shape[0]
            tag = f"{name} {str(dt).split('.')[-1]}"
            body, out, p, grads, ef, eb = _stats_case(
                tag, qkv, scale, bias16, g, mask, nw, dt)
            worst_f[body] = max(worst_f[body], ef)
            worst_b[body] = max(worst_b[body], eb)
            if dt != torch.bfloat16:
                continue

            def fwd():
                return F.window_attention_forward_stats(
                    qkv, scale, bias16, heads, nw, mask, out_dtype=dt)

            def bwd():
                return F.window_attention_backward_stats(qkv, scale, p, g,
                                                         heads)
            t = {"fwd": time_ms(fwd), "bwd": time_ms(bwd),
                 "fwd_plain": time_ms(
                     lambda: F.window_attention_forward_stats_reference(
                         qkv, scale, bias16, heads, mask, dt)),
                 "bwd_plain": time_ms(
                     lambda: F.window_attention_backward_stats_reference(
                         qkv, scale, p, g, heads)),
                 "fwd_recompute": time_ms(lambda: F.fused_window_attention(
                     qkv, scale, bias16, heads, nw, mask, out_dtype=dt)),
                 "bwd_recompute": time_ms(lambda: F.window_attention_backward(
                     qkv, scale, bias16, g, heads, nw, mask))}
            t["fwd_lib"] = _library_fwd_ms(qkv, scale, bias16, mask, heads)
            t["bwd_lib"] = _library_bwd_ms(qkv, scale, bias16, mask, heads,
                                           g)
            times[name] = t
            print(f"[kernel_stats] {tag:22s} {tuple(qkv.shape)} h{heads} ms: "
                  f"fwd_stats {t['fwd']:.4f} (plain {t['fwd_plain']:.4f}, "
                  f"recompute fwd "
                  f"{t['fwd_recompute']:.4f}, sdpa {t['fwd_lib']:.4f}); "
                  f"bwd_stats {t['bwd']:.4f} (plain {t['bwd_plain']:.4f}, "
                  f"recompute bwd "
                  f"{t['bwd_recompute']:.4f}, sdpa {t['bwd_lib']:.4f})")
    # bf16 beyond the tile: head dim 33 is odd, so the CUDA-core bodies
    qkv, scale, bias16, g, mask, nw = _attention_inputs(
        64, 36, 4, 12, 6, True, torch.bfloat16, gen)
    qkv = torch.randn(64, 36, 3 * 132, device="cuda", generator=gen).to(
        torch.bfloat16)
    g = torch.randn(64, 36, 132, device="cuda", generator=gen).to(
        torch.bfloat16)
    _stats_case("N36 hd33 bf16", qkv, scale, bias16, g, mask, nw,
                torch.bfloat16)
    print(f"[kernel_stats] {time.perf_counter() - t0:.1f} s")
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
            _reset_routes()
            msg = cli_main(_net_args(network, "test") + [
                "--save_root", tmp, "--ckpt_path", ckpt])
            serve = F.fused_window_attention.launches
    finally:
        calls.close()
    n_calls = calls.counts["eval"]
    print(f"{tag} serving: {n_calls} encoder calls, per-head forward "
          f"launches {serve}")
    _check_routes(f"{tag} serving:", serve, 0)
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
            _reset_routes()
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
    _check_routes(f"{tag} training:", fwd, bwd)
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
    seed (b=128, bf16, the CLI's synthetic head), on the tensor cores. The
    stats arm shares the recompute arm's forward arithmetic bit for bit, so
    the stats kernels launch once per attention site and step, every launch
    on the tensor cores (route_launches), and the losses agree to 1e-3
    relative. Then the arms' f32 encoder gradients, on the CUDA cores
    (``_stats_switch_grads``). The variable is restored. Returns [stats
    forward launches, stats backward launches]."""
    import os
    import torch
    from fr_tpu_torch.cli.main import build_conf, parse_args
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.train.task import FaceRecognitionTask

    t0 = time.perf_counter()
    tag = f"[{network.lower()}]"
    entry = (F.fused_window_attention_packed if network == "AlterNet50"
             else F.fused_window_attention)
    counters = [(entry, "stats_launches"), (entry, "stats_backward_launches")]
    per_call = NET_LAUNCHES[network]
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
    losses = {}
    try:
        for stats in ("0", "1"):
            os.environ["FR_ATTN_STORED_STATS"] = stats
            task = FaceRecognitionTask(conf, stage="train", device="cuda",
                                       seed=0)
            _reset(counters)
            _reset_routes()
            losses[stats] = [task.training_step((images[i], labels[i]))[
                "loss"].item() for i in range(steps)]
            del task
            _check_routes(f"{tag} FR_ATTN_STORED_STATS={stats}:",
                          per_call * steps, per_call * steps)
            if stats == "1":
                launches = [getattr(f, a) for f, a in counters]
    finally:
        if saved is None:
            os.environ.pop("FR_ATTN_STORED_STATS", None)
        else:
            os.environ["FR_ATTN_STORED_STATS"] = saved
    _stats_switch_grads(network, tag)
    recompute, stats = losses["0"], losses["1"]
    print(f"{tag} on the tensor cores: FR_ATTN_STORED_STATS=0 losses "
          f"{[round(x, 5) for x in recompute]}, =1 "
          f"{[round(x, 5) for x in stats]}; stats launches {launches}")
    check(launches == [per_call * steps] * 2,
          f"{tag} stats launches {launches}, expected {per_call * steps}")
    for a, b in zip(recompute, stats):
        check(abs(a - b) <= 1e-3 * abs(a), f"{tag} stats-arm loss {b} vs "
              f"recompute {a}: beyond 1e-3 relative")
    print(f"{tag} stats switch: {time.perf_counter() - t0:.1f} s")
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



# ---------------------------------------------------------------------------
# Slice 5: the grouped sparse-row kernels (rows 12-14), ResNet100, the
# webface42m training step, checkpoints with exact resume.
# ---------------------------------------------------------------------------

def _rows_bound(name, ng, block, d):
    """The least time of one call: the sampled rows of every table read and
    written once plus the ids, over 3.35 TB/s; or its f32 flops over 67
    TFLOP/s, whichever is larger."""
    n_in, n_out = ROWS_TRAFFIC[name]
    nbytes = (n_in + n_out) * ng * block * d * 4 + ng * 8
    t_bytes = nbytes / 3.35e12
    t_ops = ROWS_FLOPS[name] * ng * block * d / 67e12
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def _alternate(kernel, library, turns: int = 7):
    """Row 12 against torch.index_select, timed in turns (kernel, library,
    library, kernel, ...) so that both see the same state of the card:
    prints each one's median, its spread (max − min over the turns) and
    whether the kernel is slower by more than the larger spread; returns
    the two medians."""
    import statistics
    runs = {"grouped_gather": [], "index_select": []}
    for turn in range(turns):
        order = (("grouped_gather", kernel), ("index_select", library))
        for name, call in (order if turn % 2 == 0 else order[::-1]):
            runs[name].append(time_ms(call))
    med = {k: statistics.median(v) for k, v in runs.items()}
    spread = {k: max(v) - min(v) for k, v in runs.items()}
    gap = med["grouped_gather"] - med["index_select"]
    print(f"[kernel_sparse_rows] row 12 against torch.index_select, {turns} "
          f"turns in alternation: grouped_gather median "
          f"{med['grouped_gather']:.4f} ms (spread "
          f"{spread['grouped_gather']:.4f}), index_select "
          f"{med['index_select']:.4f} ms (spread "
          f"{spread['index_select']:.4f}); the kernel is "
          + ("slower beyond the spread" if gap > max(spread.values())
             else "not slower beyond the spread")
          + f" (median gap {gap:+.4f} ms)")
    return med["grouped_gather"], med["index_select"]


def phase_kernel_sparse_rows():
    """Rows 12-14 against their plain versions; returns ({kernel: max abs
    error}, {kernel: (ms, plain ms, library ms or None)}, {kernel: bound})
    with the times and bounds at the webface42m table."""
    import torch
    from fr_tpu_torch.configs.base import Config
    from fr_tpu_torch.heads.partial_fc import PFCConfig
    from fr_tpu_torch.ops import sparse_rows as R

    cfg = PFCConfig(2059906, 512, sample_rate=0.1, sample_block=WEBFACE_BLOCK)
    check((cfg.num_classes_padded, cfg.num_sample, cfg.num_sample_groups)
          == (2059968, 205952, 3218), "PFCConfig at webface42m")
    # N(0, 1) tables and gradients, a weight decay of 5e-2 and step count 3:
    # every term of both rules (wd·w, mom·buf, (1-β2)·g², lr·wd·w, the bias
    # corrections) then moves the result by far more than the tolerance, so
    # a kernel that drops or mis-scales one of them fails
    conf = Config(wd=5e-2, mom=0.9, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = dict.fromkeys(ROWS_TRAFFIC, 0.0)
    times, bounds = {}, {}
    cases = (("small", 1000, 128, 4, 25),
             ("webface42m", cfg.num_classes_padded, 512, WEBFACE_BLOCK,
              cfg.num_sample_groups))
    for tag, c, d, block, ng in cases:
        total = c // block
        inner = torch.randperm(total - 2, generator=gen,
                               device="cuda")[:ng - 2] + 1
        gidx = torch.sort(torch.cat([inner, torch.tensor(
            [0, total - 1], device="cuda")])).values
        idx = R.expand_group_index(gidx, block)
        touched = torch.zeros(c, dtype=torch.bool, device="cuda")
        touched[idx] = True
        rand = lambda *shape: torch.randn(*shape, device="cuda",  # noqa: E731
                                          generator=gen)
        w, a, b = rand(c, d), rand(c, d), rand(c, d).abs_()
        grad = rand(ng * block, d)
        timed = tag == "webface42m"

        out = R.grouped_gather(w, gidx, block)
        torch.cuda.synchronize()
        check(torch.equal(out, R.grouped_gather_reference(w, gidx, block))
              and torch.equal(out[-block:], w[-block:]),
              f"[kernel_sparse_rows] {tag}: the gather is not bit-exact")
        del out
        if timed:
            gather, select = _alternate(
                lambda: R.grouped_gather(w, gidx, block),
                lambda: torch.index_select(w, 0, idx))
            times["grouped_gather"] = (
                gather, time_ms(lambda: R.grouped_gather_reference(
                    w, gidx, block)), select)

        for optimizer, name, start in (
                ("SGD", "grouped_update_sgd", {"weight": w, "momentum": a}),
                ("AdamW", "grouped_update_adamw",
                 {"weight": w, "exp_avg": a, "exp_avg_sq": b})):
            def run(kernel):
                t = {k: v.clone() for k, v in start.items()}
                slots = {k: v for k, v in t.items() if k != "weight"}
                if kernel:
                    R.grouped_update(optimizer, conf, t["weight"], slots,
                                     gidx, grad, 0.05, 3, block)
                elif optimizer == "SGD":
                    R.grouped_update_sgd_reference(
                        t["weight"], slots, gidx, grad, 0.05, conf.wd,
                        conf.mom, block)
                else:
                    R.grouped_update_adamw_reference(
                        t["weight"], slots, gidx, grad, 0.05, conf.wd,
                        *conf.betas, conf.eps, 3, block)
                torch.cuda.synchronize()
                return t

            ours, again = run(True), run(True)
            check(all(torch.equal(ours[k], again[k]) for k in ours),
                  f"[kernel_sparse_rows] {tag} {optimizer}: two runs differ")
            del again
            for k, t in ours.items():
                changed = (t != start[k]).any(dim=1)
                check(not bool((changed & ~touched).any()),
                      f"[kernel_sparse_rows] {tag} {optimizer}: an unsampled "
                      f"row of {k} changed")
                check(bool(changed[idx].all()), f"[kernel_sparse_rows] {tag} "
                      f"{optimizer}: a sampled row of {k} did not change")
            ref = run(False)
            for k in ours:
                x, y = ours[k].index_select(0, idx), ref[k].index_select(0,
                                                                         idx)
                err = (x - y).abs()
                check(bool((err <= ROWS_ATOL + ROWS_RTOL * y.abs()).all()),
                      f"[kernel_sparse_rows] {tag} {optimizer} {k}: max abs "
                      f"error {err.max().item():.3e}")
                worst[name] = max(worst[name], err.max().item())
            if timed:
                slots = {k: v for k, v in ours.items() if k != "weight"}
                rslots = {k: v for k, v in ref.items() if k != "weight"}
                plain = (R.grouped_update_sgd_reference if optimizer == "SGD"
                         else R.grouped_update_adamw_reference)
                extra = ((conf.wd, conf.mom) if optimizer == "SGD"
                         else (conf.wd, *conf.betas, conf.eps, 3))
                times[name] = (
                    time_ms(lambda: R.grouped_update(
                        optimizer, conf, ours["weight"], slots, gidx, grad,
                        0.05, 3, block)),
                    time_ms(lambda: plain(ref["weight"], rslots, gidx, grad,
                                          0.05, *extra, block)), None)
            del ours, ref
        print(f"[kernel_sparse_rows] {tag:10s} table ({c:,}, {d}) f32, {ng:,} "
              f"groups of {block} (first and last in): gather bit-exact; "
              f"max abs err SGD {worst['grouped_update_sgd']:.2e}, AdamW "
              f"{worst['grouped_update_adamw']:.2e} (rtol {ROWS_RTOL:g}, atol "
              f"{ROWS_ATOL:g}); unsampled rows bitwise unchanged; two runs "
              f"equal")
        if timed:
            for name, (ms, plain_ms, lib) in times.items():
                bound_ms, by, nbytes = _rows_bound(name, ng, block, d)
                bounds[name] = (bound_ms, by)
                print(f"[kernel_sparse_rows] {name:22s} kernel {ms:.4f} ms "
                      f"({nbytes / ms / 1e6:,.0f} GB/s)  plain {plain_ms:.4f} "
                      f"ms  bound {bound_ms:.4f} ms ({nbytes / 1e6:,.1f} MB, "
                      f"{by})" + (f"  index_select {lib:.4f} ms"
                                  if lib is not None else ""))
        del w, a, b, grad
    torch.cuda.empty_cache()
    return worst, times, bounds


# BatchNorm shapes of the main paths: IR-ResNet100 at batch 256 and 112 px
# (the stem, layer 3, the BN1d) and AlterNet50 at batch 128 and 192 px (the
# stem), as (N, C, H, W) or (N, C)
BN_SHAPES = {"IR-ResNet100 stem": (256, 64, 112, 112),
             "IR-ResNet100 layer3": (256, 256, 14, 14),
             "IR-ResNet100 BN1d": (256, 512),
             "AlterNet50 stem": (128, 64, 96, 96)}
# compulsory bytes an element in bf16: the forward reads x and writes y; the
# backward reads x and dy and writes dx; eval reads x and writes y
BN_BYTES = {"fwd": 4, "bwd": 6, "eval": 4}
BN_COLD_BYTES = 100e6   # activations cycled per timing: twice the 50 MB L2
BN_TOL = 2.0 ** -7      # one bf16 ulp, relative (tests/test_torch_batch_norm.py)


def _device_ms(call, iters: int = 20, warmup: int = 3) -> float:
    """Device time of call() by the profiler: every kernel, copy and fill it
    launches, over iters calls after a warm-up. CUDA events around calls
    that launch little would time the host's launching instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / iters / 1e3


def phase_kernel_batch_norm():
    """[kernel_batch_norm] the BatchNorm kernels (csrc/batch_norm.cu) in
    bf16 at the BN_SHAPES: the training forward (bn_stats + bn_apply), the
    backward pair through autograd on the statistics the forward saved, and
    bn_eval, each one's device time (profiler) beside its byte bound at
    3.35 TB/s, the plain version and the library path (cuDNN's f32 batch
    norm between two casts, which the port no longer calls), each cycled
    over enough activations to exceed the L2. The output and dx are held
    against the plain version to one bf16 ulp (relative). Returns {(shape,
    kind): (ms, plain ms, library ms, bound ms, max abs error)}."""
    import math

    import torch
    import torch.nn.functional as F
    from fr_tpu_torch.ops import batch_norm as B

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    times, worst = {}, dict.fromkeys(BN_BYTES, 0.0)
    for tag, shape in BN_SHAPES.items():
        c, numel = shape[1], math.prod(shape)
        copies = max(1, math.ceil(BN_COLD_BYTES / (2 * numel)))
        rows = (shape[0], *shape[2:], c)

        def draw():
            out = [(torch.randn(rows, device=dev, generator=gen) * 1.5 + 0.3)
                   .to(torch.bfloat16) for _ in range(copies)]
            # 4-D: NCHW views of channels_last storage, as the models have
            return [t.permute(0, 3, 1, 2) if t.dim() == 4 else t for t in out]

        xs, dys = draw(), draw()
        weight = torch.rand(c, device=dev, generator=gen) + 0.5
        bias = torch.rand(c, device=dev, generator=gen) - 0.5

        def running():
            """Running statistics of one side's own: a graph that saved
            them stays valid while another side updates its own."""
            return (torch.zeros(c, device=dev), torch.ones(c, device=dev),
                    torch.zeros((), dtype=torch.int64, device=dev))

        sides = {
            "kernel": lambda x, training, st: B.batch_norm(
                x, st[0], st[1], weight, bias, st[2], training, 0.1, 1e-5),
            "plain": lambda x, training, st: B.batch_norm_reference(
                x, st[0], st[1], weight, bias, st[2], training, 0.1, 1e-5),
            "library": lambda x, training, st: F.batch_norm(
                x.float(), st[0], st[1], weight, bias, training, 0.1,
                1e-5).to(torch.bfloat16)}
        stats = {side: running() for side in sides}

        def cycled(fn):
            turn = [0]

            def call():
                turn[0] = (turn[0] + 1) % copies
                return fn(turn[0])
            return call

        def errors(kind, ours, want):
            """The largest absolute error, and the check against one bf16
            ulp of each element (a floor of 1e-5 of the largest)."""
            ours, want = ours.float(), want.float()
            err = (ours - want).abs()
            rel = err / want.abs().clamp_min(1e-5 * float(want.abs().max()))
            worst[kind] = max(worst[kind], float(rel.max()))
            return float(err.max())

        errs = {}
        with torch.no_grad():
            for kind in ("fwd", "eval"):
                training = kind == "fwd"
                # eval: both on the kernel side's running statistics
                errs[kind] = errors(
                    kind, sides["kernel"](xs[0], training, stats["kernel"]),
                    sides["plain"](xs[0], training,
                                   stats["plain" if training else "kernel"]))
                times[(tag, kind)] = tuple(
                    _device_ms(cycled(lambda i, fn=fn, st=stats[side]: fn(
                        xs[i], training, st)))
                    for side, fn in sides.items())
        # the backward: each side's graph of a training forward, built once
        # a copy, and autograd.grad of x through it
        graphs = {}
        for side, fn in sides.items():
            graphs[side] = []
            for x in xs:
                x = x.detach().requires_grad_(True)
                graphs[side].append((fn(x, True, stats[side]), x))

        def backward(side, i):
            y, x = graphs[side][i]
            return torch.autograd.grad(y, x, dys[i], retain_graph=True)[0]

        errs["bwd"] = errors("bwd", backward("kernel", 0),
                             backward("plain", 0))
        times[(tag, "bwd")] = tuple(
            _device_ms(cycled(lambda i, side=side: backward(side, i)))
            for side in sides)
        del graphs, xs, dys
        for kind in BN_BYTES:
            ms, plain_ms, lib_ms = times[(tag, kind)]
            nbytes = BN_BYTES[kind] * numel
            bound = nbytes / 3.35e12 * 1e3
            times[(tag, kind)] = (ms, plain_ms, lib_ms, bound, errs[kind])
            print(f"[kernel_batch_norm] {tag:20s} {'x'.join(map(str, shape))}"
                  f" {kind:4s} kernel {ms:.4f} ms ({nbytes / ms / 1e6:,.0f} "
                  f"GB/s, {100 * bound / ms:.1f}% of the bound {bound:.4f} "
                  f"ms)  plain {plain_ms:.4f} ms  library {lib_ms:.4f} ms  "
                  f"max_abs_err {errs[kind]:.3e}")
    torch.cuda.empty_cache()
    for kind, err in worst.items():
        check(err <= BN_TOL, f"[kernel_batch_norm] {kind}: relative error "
              f"{err:.3e} beyond one bf16 ulp")
    print("[kernel_batch_norm] largest error relative to the plain version: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (limit {BN_TOL:g})")
    return times


# ViT-L's training layer: images, kept tokens, heads, head dim
GA_SHAPE = (384, 136, 8, 96)
# the kernels against the plain versions of their arithmetic, relative
# norm: both round P (and dS) to bf16 at the same places, so what differs
# is the f32 sums' order and the roundings it flips (tests/test_torch_vit.py)
GA_TOL = {"fwd": 2.0 ** -8, "bwd": 2.0 ** -7}
# bf16 bytes a layer, in units of B·L·D: q, k, v read and o written
# forward; q, k, v and dO read and dq, dk, dv written backward
GA_BYTES = {"fwd": 8, "bwd": 14}
GA_PRODUCTS = {"fwd": 2, "bwd": 5}   # L × L × d products


def phase_kernel_global_attn():
    """[kernel_global_attn] the global-attention kernels (csrc/global_attn.cu)
    at ViT-L's training layer (GA_SHAPE, bf16, the packed projection): the
    forward and the backward against the plain versions of their arithmetic
    (attention_forward_plain, attention_backward_plain on the kernel's
    log-sum-exp; relative norm within GA_TOL) and the f32 plain route,
    two runs bitwise equal; their device time (profiler) beside their
    bound (the larger of GA_BYTES·B·L·D bf16 bytes at 3.35 TB/s and
    2·B·H·L²·d flops a product at 989 TFLOP/s), the plain versions' and,
    as library_ms only, PyTorch's flash SDPA forward and backward, which
    the port never calls; the kernels' dq, dk and dv at 16 images with
    tokens GA_NEAR_MEAN about their mean, within GA_NEAR_MEAN_TOL of
    float64 (flash's backward, which takes each row's Σ P·dP from the bf16
    output, printed beside them); then a ViT-L training step through the
    port's entry (load_config → FaceRecognitionTask → make_train_step, the
    vit_l_wf42m cell's settings at GA_STEP_BATCH images, bf16), counting
    one forward and one backward launch a block. Returns ({kind: (ms,
    plain ms, library ms, bound ms, bound by, error)}, {kind: launches in
    the training step})."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from fr_tpu_torch.ops import global_attn as G

    dev = torch.device("cuda")
    b, n, h, d = GA_SHAPE
    dim, scale = h * d, d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(23)
    qkv = torch.randn((b, n, 3 * dim), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    dout = torch.randn((b, n, dim), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    q, k, v = G.split_heads(qkv, h)
    dout_h = dout.reshape(b, n, h, d).transpose(1, 2)

    def rel(a, ref):
        return float((a.float() - ref.float()).norm() / ref.float().norm())

    with torch.no_grad():
        out, lse = G.global_attn_forward(qkv, h, scale)
        again = G.global_attn_forward(qkv, h, scale)
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              "[kernel_global_attn] two forward runs differ")
        o_plain, lse_plain = G.attention_forward_plain(q, k, v, scale)
        errs = {"fwd": rel(G.merge_heads(o_plain), out)}
        lse_err = float((lse - lse_plain).abs().max())
        ref_err = {"fwd": rel(out, G.attention_reference_packed(qkv.float(), h, scale))}
        dqkv = G.global_attn_backward(qkv, lse, dout, h, scale)
        check(torch.equal(dqkv, G.global_attn_backward(qkv, lse, dout, h, scale)),
              "[kernel_global_attn] two backward runs differ")
        grads = G.attention_backward_plain(q, k, v, lse, dout_h, scale)
        plain = torch.stack([t.transpose(1, 2) for t in grads], 2).reshape(
            b, n, 3 * dim)
        errs["bwd"] = rel(dqkv, plain)
        del grads, plain
    ref = qkv.float().requires_grad_(True)
    (want,) = torch.autograd.grad(G.attention_reference_packed(ref, h, scale), ref, dout.float())
    ref_err["bwd"] = rel(dqkv, want)
    del ref, want
    print(f"[kernel_global_attn] {b}x{n}x{h}x{d}: relative to the plain "
          f"versions fwd {errs['fwd']:.2e}, bwd {errs['bwd']:.2e} (limits "
          f"{GA_TOL['fwd']:g}, {GA_TOL['bwd']:g}), lse max abs {lse_err:.2e}; "
          f"to the f32 plain route fwd {ref_err['fwd']:.2e}, bwd "
          f"{ref_err['bwd']:.2e}")
    for kind in GA_TOL:
        check(errs[kind] <= GA_TOL[kind], f"[kernel_global_attn] {kind}: "
              f"{errs[kind]:.3e} from the plain version")
    check(lse_err <= 1e-4, f"[kernel_global_attn] lse off by {lse_err:.3e}")

    def library_bwd():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            o = torch.nn.functional.scaled_dot_product_attention(
                *leaves, scale=scale)
        return o, leaves

    lib_graph = library_bwd()
    calls = {
        "fwd": (lambda: G.global_attn_forward(qkv, h, scale),
                lambda: G.attention_forward_plain(q, k, v, scale),
                lambda: library_bwd()[0]),
        "bwd": (lambda: G.global_attn_backward(qkv, lse, dout, h, scale),
                lambda: G.attention_backward_plain(q, k, v, lse, dout_h,
                                                   scale),
                lambda: torch.autograd.grad(lib_graph[0], lib_graph[1],
                                            dout_h, retain_graph=True))}
    times = {}
    for kind, (kernel, plain_fn, library) in calls.items():
        with torch.no_grad() if kind == "fwd" else contextlib.nullcontext():
            ms, plain_ms, lib_ms = (_device_ms(fn, iters=10)
                                    for fn in (kernel, plain_fn, library))
        nbytes = GA_BYTES[kind] * b * n * dim * 1.0
        flops = GA_PRODUCTS[kind] * 2.0 * b * h * n * n * d
        bound, by = max((nbytes / 3.35e12 * 1e3, "bytes"),
                        (flops / 989e12 * 1e3, "flops"))
        times[kind] = (ms, plain_ms, lib_ms, bound, by, errs[kind])
        print(f"[kernel_global_attn] {kind}: kernel {ms:.4f} ms "
              f"({100 * bound / ms:.1f}% of the bound {bound:.4f} ms, {by}; "
              f"{nbytes / ms / 1e6:,.0f} GB/s, {flops / ms / 1e9:,.1f} "
              f"TFLOP/s)  plain {plain_ms:.4f} ms  library (flash SDPA, not "
              f"called by the port) {lib_ms:.4f} ms")
    del lib_graph, calls, qkv, dout, q, k, v, dout_h, out, lse, dqkv
    torch.cuda.empty_cache()

    errs_near, flash_near = _global_attn_near_mean(dev)
    print(f"[kernel_global_attn] tokens {GA_NEAR_MEAN} about their mean at "
          f"{GA_NEAR_MEAN_SHAPE}: dq, dk, dv relative to float64 "
          + ", ".join(f"{e:.3e}" for e in errs_near)
          + f" (limit {GA_NEAR_MEAN_TOL}); flash SDPA's backward "
          + ", ".join(f"{e:.3e}" for e in flash_near))
    check(max(errs_near) <= GA_NEAR_MEAN_TOL, f"[kernel_global_attn] near "
          f"the mean: dq, dk, dv off by {errs_near}")
    torch.cuda.empty_cache()
    return times, _global_attn_step_launches()


# tokens spread about a mean they share, as in ViT-L's deeper blocks at
# the benchmark's weights, where dq and dk are second-order small: the
# kernels' gradients against float64 (tests/test_torch_vit.py)
GA_NEAR_MEAN_SHAPE = (16, 8, 136, 96)
GA_NEAR_MEAN = 0.03
GA_NEAR_MEAN_TOL = 0.25
GA_STEP_BATCH = 128


def _global_attn_near_mean(dev):
    """Relative errors of the kernels' (dq, dk, dv) and of flash SDPA's
    against autograd in float64, at GA_NEAR_MEAN_SHAPE (B, H, L, d), bf16
    tokens GA_NEAR_MEAN about their mean."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from fr_tpu_torch.ops import global_attn as G

    b, h, n, d = GA_NEAR_MEAN_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(4)

    def near_mean():
        mean = torch.randn((b, h, 1, d), generator=gen, device=dev)
        return (mean + GA_NEAR_MEAN * torch.randn(
            (b, h, n, d), generator=gen, device=dev)).to(torch.bfloat16)

    q, k, v = (near_mean() for _ in range(3))
    dout = torch.randn((b, h, n, d), generator=gen, device=dev).to(
        torch.bfloat16)
    qkv = torch.stack([t.transpose(1, 2) for t in (q, k, v)], 2).reshape(
        b, n, 3 * h * d)
    with torch.no_grad():
        _, lse = G.global_attn_forward(qkv, h, scale)
        got = G.split_heads(G.global_attn_backward(
            qkv, lse, G.merge_heads(dout), h, scale), h)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                             scale=scale)
    flash = torch.autograd.grad(o, leaves, dout)
    wide = [t.double().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(G.attention_reference(*wide, scale), wide,
                               dout.double())

    def rel(a, ref):
        return float((a.double() - ref).norm() / ref.norm())

    return ([rel(a, w) for a, w in zip(got, want)],
            [rel(a, w) for a, w in zip(flash, want)])


def _vit_l_step(tag):
    """One ViT-L training step through the port's entry, at the vit_l_wf42m
    cell's settings (benchmark/configs/vit_l_wf42m.json, program.overrides)
    but GA_STEP_BATCH images, bf16, after one step of warm-up, with the
    global-attention kernels' counters, the margin-CE route_launches and
    shard_softmax_ce.routes cleared before it. Returns (loss, blocks)."""
    import torch
    from fr_tpu_torch.configs import load_config
    from fr_tpu_torch.ops import global_attn as G
    from fr_tpu_torch.train.task import FaceRecognitionTask

    conf = load_config("webface42m", network="ViT_L", metric="CosFace",
                       loss_s=64.0, loss_m=0.4, optimizer="AdamW", lr=0.001,
                       wd=0.1, sample_rate=0.3, sample_block=64,
                       b=GA_STEP_BATCH, use_fused=False)
    check(conf.mixed_precision and conf.n_classes == 2059906,
          f"{tag} the ViT-L step is not webface42m in bf16")
    task = FaceRecognitionTask(conf, stage="train", device="cuda", seed=0)
    task.epoch = conf.warmup_steps
    gen = torch.Generator(device="cuda").manual_seed(29)
    batches = [(torch.randint(0, 256, (conf.b, conf.img_size, conf.img_size,
                                       3), dtype=torch.uint8, device="cuda",
                              generator=gen),
                torch.randint(0, conf.n_classes, (conf.b,), device="cuda",
                              generator=gen)) for _ in range(2)]
    task.training_step(batches[0])
    torch.cuda.synchronize()
    G.global_attention.launches.clear()
    G.global_attention.kernel_launches.clear()
    _reset_ce_routes()
    loss = float(task.training_step(batches[1])["loss"])
    torch.cuda.synchronize()
    depth = len(task.encoder.blocks)
    del task, batches
    torch.cuda.empty_cache()
    return loss, depth


def _global_attn_step_launches():
    """The global-attention kernels' launches in one ViT-L training step
    (_vit_l_step); checks one forward and one backward launch a block,
    every attention call on the kernels, and a finite loss."""
    from fr_tpu_torch.ops import global_attn as G

    loss, depth = _vit_l_step("[kernel_global_attn]")
    launches = dict(G.global_attention.kernel_launches)
    print(f"[kernel_global_attn] ViT-L training step (load_config → task → "
          f"make_train_step, {GA_STEP_BATCH} images, AdamW): kernel launches "
          f"{launches} for {depth} blocks, attention calls "
          f"{dict(G.global_attention.launches)}, loss {loss:.4f}")
    check(launches == {"fwd": depth, "bwd": depth}
          and dict(G.global_attention.launches) == launches
          and math.isfinite(loss),
          f"[kernel_global_attn] ViT-L step: launches {launches} for "
          f"{depth} blocks, loss {loss}")
    return launches


def _zero_bn():
    """Sets the BatchNorm wrapper's counters to 0."""
    from fr_tpu_torch.ops.batch_norm import batch_norm
    batch_norm.launches = batch_norm.layout_copies = 0
    batch_norm.entry_launches.clear()


def _bn_launches(tag, calls, copies_per_step):
    """The BatchNorm kernels' launches since _zero_bn() by entry point,
    checked against the BatchNorm calls that ``calls`` counted: 2 forward
    and 2 backward a training call, 1 an eval call; and copies_per_step
    layout copies a training encoder call."""
    from fr_tpu_torch.ops.batch_norm import batch_norm as bn
    counts = calls.counts
    got = {k: bn.entry_launches[k]
           for k in ("bn_forward", "bn_backward", "bn_eval")}
    print(f"{tag} BatchNorm: {counts['bn_train']} training and "
          f"{counts['bn_eval']} eval calls in {counts['train']} training and "
          f"{counts['eval']} eval encoder calls; kernel launches {got}, "
          f"layout copies {bn.layout_copies}")
    check(got == {"bn_forward": 2 * counts["bn_train"],
                  "bn_backward": 2 * counts["bn_train"],
                  "bn_eval": counts["bn_eval"]}
          and bn.launches == sum(got.values()),
          f"{tag} BatchNorm launches {got} (all {bn.launches})")
    check(bn.layout_copies == copies_per_step * counts["train"],
          f"{tag} {bn.layout_copies} BatchNorm layout copies for "
          f"{counts['train']} training steps")
    return got


def phase_resnet100():
    """[resnet100] the serving CLI of webface42m at full width, the
    embedding golden in f32 and bf16, the embed throughput. Returns the
    serving CLI's BatchNorm kernel launches by entry point."""
    import numpy as np
    import torch
    from fr_tpu_torch.cli.main import main as cli_main
    from fr_tpu_torch.configs.base import Config
    from fr_tpu_torch.models.resnet import ResNet
    from fr_tpu_torch.train.step import make_embed_step
    from fr_tpu_torch.utils.golden import (golden_encoder, golden_images,
                                           seeded_state_dict)

    calls = _EncoderCalls(ResNet)
    captured = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            _zero_bn()
            msg = cli_main(WEBFACE_ARGS + ["--mode", "test", "--test_b", "64",
                                           "--save_root", tmp])
    finally:
        calls.close()
    check(calls.counts["eval"] >= 1, "[resnet100] no encoder call")
    bn = _bn_launches("[resnet100]", calls, 0)
    check('[Test with "synthetic"]' in captured.getvalue()
          and "- EER" in captured.getvalue(),
          "[resnet100] the ROC report was not printed")
    emb = np.concatenate(msg["synthetic"].embeddings)
    check(emb.shape == (512, 512) and bool(np.isfinite(emb).all()),
          f"[resnet100] embeddings {emb.shape} not finite")
    norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
    check(norm_err <= 1e-4, "[resnet100] embeddings are not unit-norm")
    print(f"[resnet100] serving: {calls.counts['eval']} encoder calls, "
          f"embeddings {emb.shape} finite, max | |e| - 1 | {norm_err:.2e}; "
          f"mean {msg['synthetic'].infer_time:.2f} ms per call of 128 "
          f"images, host to host")

    golden = np.load(R100_GOLDEN)
    seed, ref = int(golden["seed"]), golden["embeddings"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        model = golden_encoder("ResNet100", dtype)
        model.load_state_dict(seeded_state_dict(model, seed), strict=True)
        embed = make_embed_step(Config(img_size=112), model.cuda(), "cuda")
        out = embed(golden_images(seed, img_size=112)).cpu().numpy()
        if dtype == torch.float32:
            err = float(np.abs(out - ref).max())
            print(f"[resnet100] golden f32 (TF32 off) max_abs_err {err:.3e} "
                  f"(tol 1e-3)")
            check(err <= 1e-3, f"[resnet100] f32 golden error {err}")
        else:
            cos = np.sum(out * ref, axis=1) / (
                np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
            print(f"[resnet100] golden bf16 min per-row cosine "
                  f"{cos.min():.5f} (tol 0.99)")
            check(cos.min() >= 0.99, f"[resnet100] bf16 cosine {cos.min()}")
        del model, embed
    phase_throughput("ResNet100")
    return bn


def _webface_conf(sample_block=WEBFACE_BLOCK, optimizer=None):
    from fr_tpu_torch.cli.main import build_conf, parse_args

    extra = ["--optimizer", optimizer] if optimizer else []
    conf = build_conf(parse_args(WEBFACE_ARGS + [
        "--mode", "train", "--sample_block", str(sample_block)] + extra))
    check(conf.n_classes == 2059906 and conf.sample_rate == 0.1
          and conf.network == "ResNet100" and conf.b == 128,
          f"webface42m config: {conf.n_classes} classes at "
          f"{conf.sample_rate}")
    return conf


def _webface_batches(conf, n, seed=11):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randint(0, 256, (n, conf.b, conf.img_size, conf.img_size,
                                    3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    labels = torch.randint(0, conf.n_classes, (n, conf.b), device="cuda",
                           generator=gen)
    return images, labels


def phase_webface42m(steps: int = 3, timed: int = 8):
    """[webface42m] the training step at the full head. Returns the
    launches of (grouped_gather, grouped_update_sgd, grouped_update_adamw),
    of the margin-CE kernels by arm and body ("<arm> <body>", the two kernel
    arms' steps) and of the BatchNorm kernels by entry point over the
    phase."""
    import torch
    from fr_tpu_torch.heads.partial_fc import (sample_groups,
                                               shard_group_masks)
    from fr_tpu_torch.models.resnet import ResNet
    from fr_tpu_torch.ops import fused_pfc as F
    from fr_tpu_torch.ops import sparse_rows as R
    from fr_tpu_torch.train.task import FaceRecognitionTask

    rows = (R.grouped_gather, R.grouped_update_sgd, R.grouped_update_adamw)
    ce = (F.margin_ce_stats, F.margin_ce_grad_emb, F.margin_ce_grad_w)
    for k in rows + ce:
        k.launches = 0
    _zero_bn()
    calls = _EncoderCalls(ResNet)
    conf = _webface_conf()
    n = steps + timed
    images, labels = _webface_batches(conf, n)

    def run(conf, tag, n_steps, n_timed, expect):
        """n_steps checked steps, then n_timed on the host clock; expect:
        launches per step of the three grouped kernels. Returns (losses, ms
        per step)."""
        torch.cuda.reset_peak_memory_stats()
        before = [k.launches for k in rows]
        task = FaceRecognitionTask(conf, stage="train", device="cuda", seed=0)
        cfg = task.pfc_cfg
        if cfg.sample_block > 1 and expect[1]:
            # the groups step 1 will draw: the same masks and a copy of the
            # state's sampling generator
            gen = torch.Generator(device="cuda")
            gen.set_state(task.state.generators["sample"].get_state())
            lab = labels[0]
            gidx = sample_groups(cfg, gen, *shard_group_masks(
                cfg, 0, lab, (lab >= 0) & (lab < cfg.num_local)))
            check(gidx.shape == (cfg.num_sample_groups,)
                  and bool((gidx[1:] > gidx[:-1]).all()),
                  f"[webface42m] {tag}: the drawn groups are not sorted "
                  f"unique")
            check(bool(torch.isin(lab // cfg.sample_block, gidx).all()),
                  f"[webface42m] {tag}: a label's group was not drawn")
            w0 = task.state.pfc.weight.clone()
        losses = [task.training_step((images[0], labels[0]))["loss"].item()]
        if cfg.sample_block > 1 and expect[1]:
            # the momentum starts at zero, and g + wd·w leaves no drawn row
            # at zero (the warm-up's first lr is too small to move every
            # weight by an ulp, so the weight shows only what stayed)
            def groups(rows_changed):
                return rows_changed.reshape(-1, cfg.sample_block)

            moved = groups((task.state.pfc.slots["momentum"] != 0).any(dim=1))
            drawn = torch.zeros(moved.shape[0], dtype=torch.bool,
                                device="cuda")
            drawn[gidx] = True
            check(bool((moved.all(dim=1) == drawn).all())
                  and not bool(moved[~drawn].any()),
                  f"[webface42m] {tag}: the rows the update wrote are not "
                  f"the drawn groups' rows")
            stayed = groups((task.state.pfc.weight != w0).any(dim=1))
            check(not bool(stayed[~drawn].any()),
                  f"[webface42m] {tag}: a weight row outside the drawn "
                  f"groups changed")
            del w0, moved, stayed
        losses += [task.training_step((images[i], labels[i]))["loss"].item()
                   for i in range(1, n_steps)]
        counts = [k.launches - b for k, b in zip(rows, before)]
        check(counts == [e * n_steps for e in expect],
              f"[webface42m] {tag}: grouped-kernel launches {counts} over "
              f"{n_steps} steps")
        check(all(x == x and abs(x) != float("inf") for x in losses),
              f"[webface42m] {tag}: losses {losses}")
        ms = None
        if n_timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n_steps, n_steps + n_timed):
                out = task.training_step((images[i], labels[i]))
            out["loss"].item()
            ms = (time.perf_counter() - t0) * 1e3 / n_timed
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"[webface42m] {tag}: head {cfg.num_classes_padded:,} x "
              f"{cfg.embedding_size}, {cfg.num_sample:,} columns sampled "
              f"({cfg.num_sample_groups:,} groups of {cfg.sample_block}), "
              f"b={conf.b}: losses {[round(x, 4) for x in losses]}" + (
                  f"; {ms:.2f} ms per step, {conf.b * 1e3 / ms:.1f} imgs/s "
                  f"(host clock over {n_timed} steps)" if ms else "")
              + f"; peak memory {peak:.2f} GB; grouped launches {counts}")
        del task
        torch.cuda.empty_cache()
        return losses, ms

    results, routes = {}, {}
    for arm, fused in CE_ARMS:
        before = [k.launches for k in ce]
        conf.use_fused = fused
        with _ce_arm(arm):
            results[arm] = run(conf, f"SGD use_fused={fused}, the CE {arm}",
                               steps, timed, (1, 1, 0))
            routes[arm] = _ce_arm_launches()
        counts = [k.launches - b for k, b in zip(ce, before)]
        want = [0] * 3 if arm == "plain_torch" else [steps + timed] * 3
        check(counts == want, f"[webface42m] margin-CE launches {counts} "
              f"over {steps + timed} steps in the {arm} arm")
    _check_ce_arms("[webface42m]", {a: r[0] for a, r in results.items()},
                   routes, steps + timed)
    ce_launches = {f"{arm} {body}": c for arm in ("plain_kernels", "fused")
                   for body, c in routes[arm][0].items()}
    run(_webface_conf(optimizer="AdamW"), "AdamW use_fused=False", steps, 0,
        (1, 0, 1))
    _, ms_row = run(_webface_conf(sample_block=1), "SGD sample_block=1 "
                       "(per-row sampling)", steps, timed, (0, 0, 0))
    ms_block = results["plain_kernels"][1]
    print(f"[webface42m] sample_block {WEBFACE_BLOCK} against 1, use_fused "
          f"off: {ms_block:.2f} vs {ms_row:.2f} ms per step on the host "
          f"clock ({ms_row / ms_block:.2f}x); the plain CE in PyTorch "
          f"{results['plain_torch'][1]:.2f} ms, use_fused on "
          f"{results['fused'][1]:.2f} ms; the device's side of it is in "
          f"[profile]")
    calls.close()
    # the last BN2d's gradient reaches it NCHW from the flatten
    bn = _bn_launches("[webface42m]", calls, 1)
    return [k.launches for k in rows], ce_launches, bn


def phase_resnet100_train_golden():
    import numpy as np
    import torch
    from fr_tpu_torch.ops import sparse_rows as R
    from fr_tpu_torch.utils.golden import run_train_golden

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = np.load(R100_TRAIN_GOLDEN)
    before = (R.grouped_gather.launches, R.grouped_update_sgd.launches)
    ours = run_train_golden(int(golden["seed"]), "cuda", "ResNet100",
                            golden["gidx"])
    check((R.grouped_gather.launches - before[0],
           R.grouped_update_sgd.launches - before[1]) == (2, 2),
          "the ResNet100 golden run missed the grouped kernels")
    check(list(ours["update_names"]) == list(golden["update_names"]),
          "the golden's tensors differ from the model's")
    rel = {k: float(np.max(np.abs(ours[k] - golden[k]) / np.abs(golden[k])))
           for k in ("losses", "grad_norms", "update_norms")}
    print(f"[resnet100_train_golden] f32 (TF32 off), sample_block 4, the "
          f"golden's groups fed in: losses {ours['losses']} vs "
          f"{golden['losses']}; max rel: losses {rel['losses']:.2e}, grad "
          f"norms {rel['grad_norms']:.2e} (tol 1e-3), update norms "
          f"{rel['update_norms']:.2e} (tol 5e-2)")
    check(rel["losses"] <= 1e-3 and rel["grad_norms"] <= 1e-3,
          "ResNet100 training golden: loss or grad norm beyond 1e-3")
    check(rel["update_norms"] <= 5e-2, "ResNet100 training golden: update "
          "norms beyond 5e-2")


def phase_resume():
    """[resume] 7 epochs of the training CLI in one run, then the same
    command with --resume, which restores that run's epoch-5 save and runs
    epochs 6 and 7 again: the same encoder and head, bit for bit. cuDNN is
    held to its deterministic algorithms for both runs."""
    import torch
    from fr_tpu_torch.cli.main import main as cli_main
    from fr_tpu_torch.ops import sparse_rows as R

    args = ["--config", "webface42m", "--mode", "train", "--network",
            "ResNet100", "--synthetic", "--sample_rate", "0.5",
            "--sample_block", "4", "--num_epoch", str(RESUME_EPOCHS),
            "--device", "cuda"]
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    captured = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            t0 = time.perf_counter()
            before = R.grouped_update_sgd.launches
            whole = cli_main(args + ["--save_root", tmp])
            steps = R.grouped_update_sgd.launches - before
            states = sorted(p.name for p in Path(tmp).glob("*/state/*.pt"))
            size = sum(p.stat().st_size for p in Path(tmp).glob(
                "*/state/*.pt")) / 1e6
            again = cli_main(args + ["--save_root", tmp, "--resume"])
            runs = sorted(p.name for p in Path(tmp).iterdir())
            wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = saved
    out = captured.getvalue()
    check(states == ["5.pt"], f"[resume] saved states {states}")
    check(len(runs) == 1 and "--resume: reusing run dir" in out
          and "resumed at epoch 5" in out,
          "[resume] the second run did not resume in the first run's dir")
    check(steps == RESUME_EPOCHS * 8 and whole.pfc_cfg.sample_block == 4,
          f"[resume] {steps} grouped updates in {RESUME_EPOCHS} epochs")
    check(len(again.history) == RESUME_EPOCHS - 5
          and again.state.step == whole.state.step == RESUME_EPOCHS * 8,
          f"[resume] resumed epochs {len(again.history)}, step "
          f"{again.state.step}")
    a, b = again.encoder.state_dict(), whole.encoder.state_dict()
    differ = [k for k in b if not torch.equal(a[k], b[k])]
    head = torch.equal(again.state.pfc.weight, whole.state.pfc.weight) and \
        torch.equal(again.state.pfc.slots["momentum"],
                    whole.state.pfc.slots["momentum"])
    print(f"[resume] ResNet100 bf16 b=128, sample_block 4: {RESUME_EPOCHS} "
          f"epochs in one run against a --resume from its epoch-5 state "
          f"({size:.1f} MB): {len(b) - len(differ)}/{len(b)} encoder tensors "
          f"and the head {'are' if head else 'are NOT'} bitwise equal; "
          f"losses {[round(h['train_loss'], 4) for h in whole.history[5:]]} "
          f"vs {[round(h['train_loss'], 4) for h in again.history]}; "
          f"{wall:.1f} s")
    check(not differ and head, f"[resume] the resumed run differs: "
          f"{differ[:5]}")


# ---------------------------------------------------------------------------
# The data and evaluation layer. Every file is written here: an
# image folder, a packed corpus, a bcolz (or .npy) pair root, a csv cross
# set and a .pth snapshot; the config's dataset roots point at them through
# its DATA_DIR for each run.
# ---------------------------------------------------------------------------

DATA_CLASSES, DATA_PER_CLASS, DATA_PX = 128, 8, 192   # 1,024 images
VAL_PAIRS, VAL_PX = 256, 112         # the LFW layout: 112 px, NCHW, float
CROSS_CLASSES, CROSS_PER_CLASS = 256, 4                 # 1,024 JPEGs
DATA_NETWORK = "AlterNet50"
DATA_TRAIN_ARGS = ["--config", "ms1m_arcface_122", "--mode", "train",
                   "--network", DATA_NETWORK, "--num_epoch", "6",
                   "--device", "cuda"]
DATA_TEST_ARGS = ["--config", "ms1m_arcface_122", "--mode", "test",
                  "--network", DATA_NETWORK, "--test_b", "64",
                  "--device", "cuda"]
DATA_STEPS = 6 * (DATA_CLASSES * DATA_PER_CLASS // 128)


def _importable(name):
    import importlib
    try:
        importlib.import_module(name)
        return True
    except Exception:   # a module that is there but does not load is absent
        return False


def phase_host_libs():
    """[host_libs] which host libraries the data paths can use here;
    returns {name: present}."""
    import ctypes.util
    import shutil
    from fr_tpu_torch import native
    from fr_tpu_torch.data.bcolz_reader import blosc_available

    libs = {"cv2": _importable("cv2"), "pandas": _importable("pandas"),
            "tensorboard": _importable("torch.utils.tensorboard"),
            "libblosc": blosc_available(),
            "libjpeg": ctypes.util.find_library("jpeg") is not None,
            "g++": shutil.which("g++") is not None}
    built = native.available()
    how = ("with JPEG" if native.jpeg_available() else "without JPEG") \
        if built else ""
    print("[host_libs] " + ", ".join(
        f"{k} {'present' if v else 'absent'}" for k, v in libs.items())
        + f"; the native library {'built ' + how if built else 'did not build'}")
    return libs


@contextlib.contextmanager
def _data_dir(root):
    """The ms1m_arcface_122 config's dataset roots under ``root`` while the
    block runs."""
    from fr_tpu_torch.configs import ms1m_arcface_122 as cfg
    saved = cfg.DATA_DIR
    cfg.DATA_DIR = str(root)
    try:
        yield Path(root) / "validation"
    finally:
        cfg.DATA_DIR = saved


def _write_bcolz(root, arr, chunklen):
    """A bcolz 1.x rootdir (meta/sizes, meta/storage with the repr-quoted
    dtype, __attrs__, data/__<i>.blp blosc chunks) through the port's
    compress_chunk."""
    from fr_tpu_torch.data.bcolz_reader import compress_chunk
    (root / "meta").mkdir(parents=True)
    (root / "data").mkdir()
    (root / "meta" / "sizes").write_text(json.dumps(
        {"shape": list(arr.shape), "nbytes": int(arr.nbytes),
         "cbytes": 0}))
    (root / "meta" / "storage").write_text(json.dumps(
        {"dtype": repr(arr.dtype)[6:-1],
         "cparams": {"clevel": 5, "shuffle": 1, "cname": "lz4",
                     "quantize": 0},
         "chunklen": chunklen, "dflt": 0.0, "expectedlen": len(arr)}))
    (root / "__attrs__").write_text("{}")
    for i, s in enumerate(range(0, len(arr), chunklen)):
        (root / "data" / f"__{i}.blp").write_bytes(compress_chunk(
            arr[s:s + chunklen].tobytes(), arr.dtype.itemsize, cname="lz4"))


def _write_val_root(root, libs):
    """<root>/validation/lfw unless it is there: 256 synthetic pairs at 112
    px as (512, 3, 112, 112) float32, a bcolz rootdir where libblosc is
    present, else lfw.npy; lfw_list.npy beside it."""
    import numpy as np
    from fr_tpu_torch.data import synthetic_pairs

    val = Path(root) / "validation"
    if (val / "lfw_list.npy").exists():
        return
    val.mkdir(parents=True)
    pairs, same = synthetic_pairs(VAL_PAIRS, DATA_CLASSES, VAL_PX)
    arr = np.ascontiguousarray(np.transpose(pairs, (0, 1, 4, 2, 3)).reshape(
        2 * VAL_PAIRS, 3, VAL_PX, VAL_PX))
    if libs["libblosc"]:
        _write_bcolz(val / "lfw", arr, chunklen=32)
        layout = "bcolz rootdir (lz4, chunks of 32 images)"
    else:
        np.save(val / "lfw.npy", arr)
        layout = ".npy (libblosc absent)"
    np.save(val / "lfw_list.npy", same)
    print(f"[data] validation pair root: {VAL_PAIRS} pairs at {VAL_PX} px "
          f"as a {layout}")


class _StepWatch:
    """While open: where each training step's images came from (on the
    card, or not) and how many epochs went through the task's prefetch."""

    def __init__(self):
        from fr_tpu_torch.train.task import FaceRecognitionTask as T
        self.cls, self.on_card, self.prefetches = T, [], 0
        self.step, self.prefetch = T.training_step, T.prefetch_device_batches
        watch = self

        def training_step(task, batch):
            images = batch[0]
            watch.on_card.append(hasattr(images, "is_cuda")
                                 and images.is_cuda)
            return watch.step(task, batch)

        def prefetch(task, host_iter, depth=2):
            watch.prefetches += 1
            return watch.prefetch(task, host_iter, depth)

        T.training_step, T.prefetch_device_batches = training_step, prefetch

    def close(self):
        self.cls.training_step = self.step
        self.cls.prefetch_device_batches = self.prefetch


def _data_train(tag, root, extra, device_resident=False):
    """One training CLI run of AlterNet50 at full width from the files
    under ``root``: the steps, 12 + 12 tensor-core launches per step (12 per
    validation call), each step's images on the card, the prefetch taken
    (or skipped for a device-resident corpus), a finite loss whose last
    epoch is below the first, the ROC report at epoch 5 and the epoch-5
    snapshot. Returns (the snapshot, the epochs' imgs/s, seconds)."""
    import re
    import numpy as np
    from fr_tpu_torch.cli.main import main as cli_main
    from fr_tpu_torch.ops.fused_window_attn import (
        fused_window_attention_packed as fwd, window_attention_backward as bwd)

    save = Path(root) / f"save_{tag.strip('[]')}"
    calls, watch = _EncoderCalls(), _StepWatch()
    captured = io.StringIO()
    try:
        with _data_dir(root), \
                contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            t0 = time.perf_counter()
            fwd.launches = bwd.launches = 0
            _reset_routes()
            task = cli_main(DATA_TRAIN_ARGS + extra
                            + ["--save_root", str(save)])
            launches = fwd.launches, bwd.launches
            wall = time.perf_counter() - t0
    finally:
        calls.close()
        watch.close()
    steps, evals = calls.counts["train"], calls.counts["eval"]
    report = captured.getvalue()
    rates = [float(x) for x in re.findall(r"Throughput: ([\d.]+) imgs/sec",
                                          report)]
    losses = [h["train_loss"] for h in task.history]
    snapshots = sorted(p.name for p in save.glob("*/*.npz"))
    print(f"{tag} {steps} steps, {evals} validation encoder calls, "
          f"launches {launches[0]} forward, {launches[1]} backward; images "
          f"on the card in {sum(watch.on_card)}/{len(watch.on_card)} steps, "
          f"{watch.prefetches} epochs through the prefetch; losses "
          f"{[round(x, 4) for x in losses]}; imgs/s by epoch (host clock) "
          f"{rates}; {wall:.1f} s")
    check(steps == DATA_STEPS and task.conf.n_classes == DATA_CLASSES,
          f"{tag} {steps} steps over {task.conf.n_classes} classes")
    _check_routes(tag, *launches)
    check(launches[1] == 12 * steps and launches[0] == 12 * (steps + evals),
          f"{tag} launches {launches} for {steps} steps and {evals} "
          f"validation calls")
    check(all(watch.on_card) and len(watch.on_card) == steps,
          f"{tag} a step's images were not on the card")
    check(watch.prefetches == (0 if device_resident else 6),
          f"{tag} {watch.prefetches} epochs went through the prefetch")
    check(len(losses) == 6 and bool(np.isfinite(losses).all())
          and losses[-1] < losses[0], f"{tag} losses {losses}")
    check('[Validation with "lfw"]' in report and "- EER" in report
          and task.history[4]["val_acc"] is not None,
          f"{tag} the ROC report was not printed at epoch 5")
    check(snapshots == ["5_epoch_encoder.npz"], f"{tag} snapshots "
          f"{snapshots}")
    check(len(rates) == 6, f"{tag} {len(rates)} epoch throughputs")
    return next(save.glob("*/5_epoch_encoder.npz")), rates, wall


def phase_data_folder(root, libs):
    """[data_folder] write_synthetic_folder (128 classes x 8 JPEGs, 192
    px) and the validation pair root, then the training CLI with
    --data_dir. Needs cv2 to write the JPEGs."""
    if not libs["cv2"]:
        print("[data_folder] not run: cv2 absent")
        return None
    from fr_tpu_torch.data import write_synthetic_folder
    t0 = time.perf_counter()
    folder = Path(root) / "folder"
    write_synthetic_folder(str(folder), DATA_CLASSES, DATA_PER_CLASS,
                           DATA_PX)
    _write_val_root(root, libs)
    print(f"[data_folder] wrote {DATA_CLASSES * DATA_PER_CLASS} JPEGs and "
          f"the pair root in {time.perf_counter() - t0:.1f} s")
    out = _data_train("[data_folder]", root, ["--data_dir", str(folder)])
    print(f"[data_folder] {time.perf_counter() - t0:.1f} s in all")
    return out


def phase_data_packed(root, libs):
    """[data_packed] images.npy, labels.npy and classes.json straight from
    synthetic_corpus (numpy alone), then the training CLI with --packed_dir
    and with --packed_dir --device_corpus."""
    import numpy as np
    from fr_tpu_torch.data import synthetic_corpus
    t0 = time.perf_counter()
    packed = Path(root) / "packed"
    packed.mkdir()
    imgs, labels = synthetic_corpus(DATA_CLASSES, DATA_PER_CLASS, DATA_PX)
    np.save(packed / "images.npy", imgs)
    np.save(packed / "labels.npy", labels)
    (packed / "classes.json").write_text(json.dumps(
        [f"id_{i:05d}" for i in range(DATA_CLASSES)]))
    _write_val_root(root, libs)
    out = {"packed": _data_train("[data_packed]", root,
                                 ["--packed_dir", str(packed)])}
    out["device_corpus"] = _data_train(
        "[data_device_corpus]", root,
        ["--packed_dir", str(packed), "--device_corpus"],
        device_resident=True)
    print(f"[data_packed] {time.perf_counter() - t0:.1f} s in all")
    return out


def _data_test(tag, root, extra, per_call_images):
    """One test CLI run of AlterNet50 under ``root``; returns its report
    {name: Config} after checking 12 tensor-core forward launches per
    encoder call and finite embeddings."""
    import numpy as np
    from fr_tpu_torch.cli.main import main as cli_main
    from fr_tpu_torch.ops.fused_window_attn import \
        fused_window_attention_packed as fwd

    calls = _EncoderCalls()
    captured = io.StringIO()
    try:
        with _data_dir(root), \
                contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            fwd.launches = 0
            _reset_routes()
            msg = cli_main(DATA_TEST_ARGS + extra + [
                "--save_root", str(Path(root) / "save_test")])
            launches = fwd.launches
    finally:
        calls.close()
    n_calls = calls.counts["eval"]
    _check_routes(tag, launches, 0)
    check(n_calls >= 1 and launches == 12 * n_calls,
          f"{tag} {launches} launches for {n_calls} encoder calls")
    report = captured.getvalue()
    check(len(msg) == 1 and "- EER" in report,
          f"{tag} sets {list(msg)}, the ROC report printed: "
          f"{'- EER' in report}")
    (name, result), = msg.items()
    emb = result.embeddings
    emb = np.concatenate(emb) if isinstance(emb, tuple) else emb
    check(f'[Test with "{name}"]' in report and emb.shape[1] == 512
          and bool(np.isfinite(emb).all()), f"{tag} embeddings {emb.shape}")
    print(f"{tag} {name}: {n_calls} encoder calls of up to "
          f"{per_call_images} images, {launches} launches; accuracy "
          f"{result.acc:.2f}%, {result.infer_time:.2f} ms per call (host "
          f"to host)")
    return msg


def phase_eval_data(root, libs, snapshot):
    """[eval_data] the pair test over the validation root from the epoch-5
    snapshot, as .npz and as a .pth that export_encoder_pth wrote from the
    same weights (bit-equal embeddings, identical reports); the cross test
    over a csv set of 1,024 JPEGs (cv2 and pandas); the synthetic cross
    test; pair_score_device and cross_score_device against the host's f64
    scores on those embeddings."""
    import numpy as np
    from fr_tpu_torch.data import PairDataset
    from fr_tpu_torch.eval import verification as V
    from fr_tpu_torch.utils.jax_import import load_encoder_npz
    from fr_tpu_torch.utils.torch_export import export_encoder_pth

    t0 = time.perf_counter()
    pth = Path(root) / "5_epoch_encoder.pth"
    export_encoder_pth(str(pth), load_encoder_npz(str(snapshot),
                                                  DATA_NETWORK, DATA_PX),
                       DATA_NETWORK, epoch=5)
    runs = {}
    for kind, path in (("npz", snapshot), ("pth", pth)):
        runs[kind] = _data_test(f"[eval_data] pair {kind}", root,
                                ["--ckpt_path", str(path)], 128)["lfw"]
    (a1, a2), (b1, b2) = runs["npz"].embeddings, runs["pth"].embeddings
    same = np.array_equal(a1, b1) and np.array_equal(a2, b2)
    print(f"[eval_data] .npz and .pth: embeddings "
          f"{'bit-equal' if same else 'DIFFER'}, reports "
          f"{'identical' if runs['npz'].roc == runs['pth'].roc else 'DIFFER'}")
    check(same and runs["npz"].roc == runs["pth"].roc
          and runs["npz"].acc == runs["pth"].acc,
          "[eval_data] the .npz and .pth runs differ")

    # the test's pair order: PairDataset's seeded permutation
    labels = PairDataset(str(Path(root) / "validation" / "lfw"),
                         VAL_PX).labels
    cross_emb = None
    if libs["cv2"] and libs["pandas"]:
        croot = Path(root) / "cross"
        _write_cross_set(croot / "validation" / "lfw")
        msg = _data_test("[eval_data] cross csv", croot,
                         ["--test_type", "cross", "--ckpt_path",
                          str(snapshot)], 64)
        cross_emb = msg["lfw"].embeddings
        n = CROSS_CLASSES * CROSS_PER_CLASS
        check(f"- Total count = {n * (n - 1) // 2:,}" in msg["lfw"].roc,
              "[eval_data] the cross report's pair count")
        cross_labels = np.repeat(np.arange(CROSS_CLASSES), CROSS_PER_CLASS)
    else:
        print(f"[eval_data] cross csv not run: "
              f"{'cv2' if not libs['cv2'] else 'pandas'} absent")
    msg = _data_test("[eval_data] cross synthetic", root,
                     ["--test_type", "cross", "--synthetic"], 64)
    if cross_emb is None:
        cross_emb = msg["synthetic"].embeddings
        cross_labels = np.repeat(np.arange(128), 4)

    # device scoring on the card against the host's f64 scores
    t1 = time.perf_counter()
    hg, hi, scores = V.pair_score_device(a1, a2, labels)
    rhg, rhi, rscores = V.pair_score(a1, a2, labels)
    err = float(np.abs(scores - rscores).max())
    check(hg.sum() == rhg.sum() and hi.sum() == rhi.sum() and err <= 1e-5,
          f"[eval_data] pair_score_device: max |score - host| {err}")
    dev = V.cross_score_device(cross_emb, cross_labels)
    host = V.cross_score(cross_emb, cross_labels)
    worst, near = _check_cross_device(dev, host)
    print(f"[eval_data] on the card: pair_score_device max |score - host "
          f"f64| {err:.3e} (tol 1e-5), totals equal; cross_score_device "
          f"over {len(cross_emb)} embeddings: totals equal, largest "
          f"cumulative-histogram difference {worst} against {near[1e-5]} "
          f"host scores within 1e-5 of a bin edge and {near[1e-7]} within "
          f"1e-7 ({time.perf_counter() - t1:.1f} s)")
    print(f"[eval_data] {time.perf_counter() - t0:.1f} s in all")


def _write_cross_set(root):
    """<root>/imgs/<name>.csv of (file, label) rows and 1,024 JPEGs at 112
    px: 256 classes x 4, synthetic_corpus with seed 3."""
    import cv2
    from fr_tpu_torch.data import synthetic_corpus
    imgs, labels = synthetic_corpus(CROSS_CLASSES, CROSS_PER_CLASS, VAL_PX,
                                    seed=3)
    img_dir = Path(root) / "imgs"
    img_dir.mkdir(parents=True)
    rows = []
    for i, (img, lab) in enumerate(zip(imgs, labels)):
        cv2.imwrite(str(img_dir / f"{i:05d}.jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        rows.append(f"{i:05d}.jpg,{lab}\n")
    (img_dir / f"{Path(root).name}.csv").write_text("".join(rows))


def _check_cross_device(dev, host, margins=(1e-5, 1e-7)):
    """Equal genuine and imposter totals; the cumulative histograms differ
    nowhere by more than the number of host scores within each margin of a
    bin edge (a bin is 1.00001e-5 wide, so 1e-5 reaches every score; 1e-7
    is the f32 rounding of d² at unit norms). Returns the largest
    difference and {margin: that number}."""
    import numpy as np
    (hg, hi), (rhg, rhi, scores, _) = dev, host
    check(hg.sum() == rhg.sum() and hi.sum() == rhi.sum(),
          "[eval_data] cross_score_device totals differ from the host's")
    worst = max(int(np.abs(np.cumsum(a) - np.cumsum(b)).max())
                for a, b in ((hg, rhg), (hi, rhi)))
    x = (1e5 - 1.0) * scores
    off = np.abs(x - np.round(x))
    near = {m: int(np.sum(off <= m * (1e5 - 1.0))) for m in margins}
    check(all(worst <= n for n in near.values()),
          f"[eval_data] cross_score_device: cumulative difference {worst}, "
          f"host scores near an edge {near}")
    return worst, near


def phase_data(root):
    """The data phases in order; returns their seconds and the epochs'
    imgs/s by input path."""
    t = {}
    t0 = time.perf_counter()
    libs = phase_host_libs()
    folder = phase_data_folder(root, libs)
    t["data_folder"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    packed = phase_data_packed(root, libs)
    t["data_packed"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    snapshot = (folder or packed["packed"])[0]
    phase_eval_data(root, libs, snapshot)
    t["eval_data"] = time.perf_counter() - t2
    rates = {"packed": packed["packed"][1],
             "device_corpus": packed["device_corpus"][1]}
    if folder is not None:
        rates["folder"] = folder[1]
    print("[data] seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in t.items())
          + f"; {sum(t.values()):.1f} s together")
    return t, rates


# ---------------------------------------------------------------------------
# Slice 14: the user tools, the training CLI's --profile trace and
# TensorBoard scalars, and the port's bench.
# ---------------------------------------------------------------------------

TOOLS_CLASSES, TOOLS_PER_CLASS, TOOLS_PX = 8, 8, 250   # 64 JPEGs
TOOLS_BATCH = 24    # 3 encoder calls per embed run, the last one padded
PROFILE_CLI_STEPS = 2
BENCH_STEPS = 5
BENCH_TIMEOUT = 600
# the seven rows took 176.9 s on an NVIDIA H100 80GB HBM3 at 700 W, over
# the 150 s this phase may take: the four that cover the packed attention,
# the sparse-row kernels, the embedding step and the card-resident corpus
BENCH_SMOKE_ROWS = ("alternet50", "webface42m_head", "embed_r100",
                    "r100_realdata")
# the port's kernel launches per step of each bench row, by body
# (fr_tpu_torch/bench.py kernel_launches_per_step)
BENCH_LAUNCHES = {
    "alternet50": {"attention_fwd_tensor_cores": 12,
                   "attention_bwd_tensor_cores": 12},
    "webface42m_head": {"grouped_gather": 1, "grouped_update_sgd": 1},
}


def _tools_reference(conf, encoder, files):
    """make_embed_step over the tool's batches: the same decode, the same
    normalisation, the same zero padding of the tail."""
    import numpy as np
    from fr_tpu_torch.data.folder import _decode_resize
    from fr_tpu_torch.train.step import make_embed_step

    embed = make_embed_step(conf, encoder.to("cuda").eval(), "cuda")
    out = []
    for s in range(0, len(files), TOOLS_BATCH):
        imgs = np.zeros((TOOLS_BATCH, conf.img_size, conf.img_size, 3),
                        np.float32)
        for j, f in enumerate(files[s:s + TOOLS_BATCH]):
            imgs[j] = (_decode_resize(f, conf.img_size).astype(np.float32)
                       / 255.0 - 0.5) / 0.5
        out.append(embed(imgs).cpu().numpy()[:len(files[s:s + TOOLS_BATCH])])
    return np.concatenate(out)


def phase_tools(root):
    """[tools] the four user tools at full width: 64 JPEGs of 250 px
    (write_synthetic_folder), fd_processing (Haar where cv2 has objdetect
    and a cascade is found, else the centre crop; it says which),
    pack_dataset over the crops, tools/embed.py over the crops with
    AlterNet50 at 192 px in bf16 from an .npz and from a .pth of the same
    seeded weights (bit-equal, bit-equal to make_embed_step on the same
    batches, unit norm, 12 row-1 tensor-core launches per encoder call),
    and convert_bcolz where libblosc is present."""
    import numpy as np
    from fr_tpu_torch.configs import load_config
    from fr_tpu_torch.data.bcolz_reader import blosc_available
    from fr_tpu_torch.data.synthetic import write_synthetic_folder
    from fr_tpu_torch.models import build_encoder
    from fr_tpu_torch.models.common import init_weights
    from fr_tpu_torch.ops.fused_window_attn import \
        fused_window_attention_packed as kernel
    from fr_tpu_torch.tools import (convert_bcolz, embed, fd_processing,
                                    pack_dataset)
    from fr_tpu_torch.utils.jax_import import export_encoder_npz
    from fr_tpu_torch.utils.torch_export import export_encoder_pth

    t0 = time.perf_counter()
    check(_importable("cv2"), "[tools] cv2 is absent")
    import cv2
    root = Path(root) / "tools"
    write_synthetic_folder(str(root), TOOLS_CLASSES, TOOLS_PER_CLASS,
                           TOOLS_PX)
    haar = hasattr(cv2, "CascadeClassifier") and any(
        Path(p).exists() for p in fd_processing.HAAR_PATHS)
    stats = fd_processing.process_tree(str(root / "imgs"), out_size=112,
                                       detector="haar")
    n = TOOLS_CLASSES * TOOLS_PER_CLASS
    crops = sorted((root / "imgs_fd").rglob("*.jpg"))
    how = ("the Haar cascade" if haar else
           "the centre crop (no Haar cascade or no objdetect in this cv2)")
    print(f"[tools] fd_processing with {how}: {stats}; {len(crops)} crops")
    check(stats["total"] == n and stats["failed"] == 0 and len(crops) == n
          and stats["detected"] + stats["fallback"] == n
          and (haar or stats["fallback"] == n),
          f"[tools] fd_processing stats {stats}")
    check(cv2.imread(str(crops[0])).shape == (112, 112, 3),
          "[tools] the crops are not 112 px")
    pack_dataset.main(["--src", str(root / "imgs_fd"), "--dst",
                       str(root / "packed"), "--img_size", "112"])
    packed = np.load(root / "packed" / "images.npy", mmap_mode="r")
    check(packed.shape == (n, 112, 112, 3), f"[tools] packed {packed.shape}")

    conf = load_config("ms1m_arcface_122", network="AlterNet50")
    encoder = init_weights(build_encoder(conf), 0)
    export_encoder_npz(str(root / "enc.npz"), encoder, 1, "AlterNet50",
                       conf.img_size)
    export_encoder_pth(str(root / "enc.pth"), encoder, "AlterNet50", 1)
    embeddings, lists = [], []
    calls = _EncoderCalls()
    try:
        kernel.launches = 0
        _reset_routes()
        for ckpt in ("enc.npz", "enc.pth"):
            out = str(root / f"emb_{ckpt[4:]}")
            check(embed.main(["--ckpt", str(root / ckpt), "--network",
                              "AlterNet50", "--input_dir",
                              str(root / "imgs_fd"), "--out", out,
                              "--batch", str(TOOLS_BATCH), "--device",
                              "cuda"]) == 0, "[tools] embed failed")
            embeddings.append(np.load(out + ".npy"))
            lists.append(Path(out + ".files.txt").read_text().splitlines())
        launches = kernel.launches
    finally:
        calls.close()
    n_calls = calls.counts["eval"]
    _check_routes("[tools]", launches, 0)
    check(n_calls == 2 * -(-n // TOOLS_BATCH) and launches == 12 * n_calls,
          f"[tools] {launches} launches for {n_calls} encoder calls, "
          f"expected 12 per call")
    check(lists[0] == lists[1] and len(lists[0]) == n,
          "[tools] the file lists differ")
    npz, pth = embeddings
    check(npz.shape == (n, 512) and bool(np.isfinite(npz).all()),
          f"[tools] embeddings {npz.shape}")
    check(np.array_equal(npz, pth), "[tools] the .npz and .pth embeddings "
          "differ")
    ref = _tools_reference(conf, encoder, lists[0])
    check(np.array_equal(npz, ref), "[tools] embed differs from "
          f"make_embed_step by {float(np.abs(npz - ref).max()):.3e}")
    norm_err = float(np.abs(np.linalg.norm(npz, axis=1) - 1.0).max())
    check(norm_err <= 1e-4, f"[tools] max | |e| - 1 | {norm_err:.2e}")
    print(f"[tools] embed: {n} crops of AlterNet50 at 192 px in bf16 from "
          f".npz and .pth, bit-equal to each other and to make_embed_step; "
          f"{n_calls} encoder calls, {launches} row-1 tensor-core launches; "
          f"max | |e| - 1 | {norm_err:.2e}")
    if blosc_available():
        arr = np.random.default_rng(2).standard_normal(
            (16, 3, 112, 112)).astype(np.float32)
        _write_bcolz(root / "val" / "lfw", arr, chunklen=6)
        np.save(root / "val" / "lfw_list.npy", np.arange(8) % 2 == 0)
        convert_bcolz.main(["--src", str(root / "val" / "lfw"), "--dst",
                            str(root / "npy" / "lfw")])
        check(np.array_equal(np.load(root / "npy" / "lfw.npy"), arr)
              and (root / "npy" / "lfw_list.npy").exists(),
              "[tools] convert_bcolz")
        print("[tools] convert_bcolz: a 16-item rootdir read back equal")
    else:
        print("[tools] convert_bcolz not run: libblosc absent")
    print(f"[tools] {time.perf_counter() - t0:.1f} s")


def phase_profile_cli(root):
    """[profile_cli] the training CLI (AlterNet50, bf16, b=128, 6 epochs)
    with --profile 2: the trace holds two ProfilerStep ranges and the
    row-1 and row-2 tensor-core kernels' CUDA events of both steps (12 +
    12 a step); says whether TBLog/ was written; no module of JAX or
    TensorFlow is loaded after the run."""
    from fr_tpu_torch.cli.main import main as cli_main

    t0 = time.perf_counter()
    save = Path(root) / "profile_cli"
    _reset_routes()
    task = cli_main(TRAIN_ARGS + ["--profile", str(PROFILE_CLI_STEPS),
                                  "--save_root", str(save)])
    (run_dir,) = save.iterdir()
    trace = run_dir / "profile" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    # the host's step ranges (each shows on the device's timeline too, as
    # a gpu_user_annotation)
    steps = [e["name"] for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("ProfilerStep#")]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kernels)
             for k in ("window_attn_fwd_tc_kernel",
                       "window_attn_bwd_tc_kernel")}
    tb = sorted((run_dir / "TBLog").glob("events.out.tfevents.*"))
    # the CLI, TensorBoard's writer included, brings none of JAX into the
    # process (nor TensorFlow, which would bring Keras and its backends)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & {
        "jax", "jaxlib", "flax", "optax", "orbax", "tensorflow", "keras"})
    print(f"[profile_cli] modules of JAX or TensorFlow loaded: {loaded}")
    print(f"[profile_cli] {trace.relative_to(save)}: "
          f"{trace.stat().st_size / 2**20:.1f} MB, steps {steps}, "
          f"{len(kernels)} kernel events, of them {found}; TBLog "
          f"{'written' if tb else 'not written'}; losses "
          f"{[round(h['train_loss'], 4) for h in task.history]}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(len(steps) == PROFILE_CLI_STEPS, f"[profile_cli] steps {steps}")
    check(all(v == 12 * PROFILE_CLI_STEPS for v in found.values()),
          f"[profile_cli] tensor-core kernels in the trace {found}, "
          f"expected {12 * PROFILE_CLI_STEPS} each")
    check(len(task.history) == 6, "[profile_cli] the run did not finish")
    check(not loaded, f"[profile_cli] the CLI run loaded {loaded}")


def phase_bench():
    """[bench] python -m fr_tpu_torch.bench over BENCH_SMOKE_ROWS,
    BENCH_STEPS=5, one repeat: prints the JSON line; every row has a value
    > 0, a non-null mfu and this card's name, and the attention and
    sparse-row rows launched their kernels. Returns the JSON object."""
    import gc
    import os
    import signal
    import torch

    t0 = time.perf_counter()
    # the rows run in their own processes: free what this one has cached
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[bench] this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_STEPS=str(BENCH_STEPS), BENCH_REPEATS="1",
               BENCH_ROWS=",".join(BENCH_SMOKE_ROWS))
    # its own process group, so that a timeout ends the row's process too
    proc = subprocess.Popen([sys.executable, "-m", "fr_tpu_torch.bench"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        check(False, f"[bench] no result in {BENCH_TIMEOUT} s")
    lines = stdout.strip().splitlines()
    check(proc.returncode == 0 and lines, "[bench] exit "
          f"{proc.returncode}: {stderr[-3000:]}")
    agg = json.loads(lines[-1])
    print(f"[bench] {json.dumps(agg)}")
    rows = {r["row"]: r for r in agg["rows"]}
    name = torch.cuda.get_device_name(0)
    for row, r in rows.items():
        print(f"[bench] {row}: {r.get('value', 0):.1f} imgs/s, step "
              f"{r.get('step_ms', 0):.2f} ms, device busy "
              f"{r.get('device_busy_ms') or 0:.2f} ms, idle share "
              f"{r.get('idle_share') or 0:.3f}, "
              f"{r.get('launches_per_step') or 0:.0f} launches a step, mfu "
              f"{r.get('mfu') or 0:.4f}; {r.get('error', '')}")
    check(tuple(rows) == BENCH_SMOKE_ROWS, f"[bench] rows {list(rows)}")
    for row, r in rows.items():
        check(r.get("value", 0) > 0 and r.get("mfu") is not None
              and r.get("device_name") == name and r.get("idle_share")
              is not None, f"[bench] {row}: {r}")
        want = BENCH_LAUNCHES.get(row, {})
        got = r["kernel_launches_per_step"]
        check(all(got.get(k) == v for k, v in want.items()),
              f"[bench] {row}: launches per step {got}, expected {want}")
    print(f"[bench] {time.perf_counter() - t0:.1f} s")
    return agg


# ---------------------------------------------------------------------------
# Slice 6: the grouped (rows 15-16), spatial (row 17) and entry-fused (row
# 18) attention routes, AlterNetSep50, AlterNetV1_50, DepthwiseTaps.
# ---------------------------------------------------------------------------

def _bound(nbytes, flops, dt):
    """(ms, by): the larger of bytes over 3.35 TB/s and flops over the
    card's peak for the input type (989 TFLOP/s bf16, 67 TFLOP/s f32)."""
    import torch
    peak = 989e12 if dt == torch.bfloat16 else 67e12
    t_bytes, t_ops = nbytes / 3.35e12, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _variant_bound(kind, windows, n, c, heads, dt, n_mask):
    """The least time of one call of a row-17/18 kernel: each input read
    once, each output written once. spatial_fwd writes f32; qkv_fwd reads
    x, W (3C, C) f32 and b, and computes the projection (2·rows·C·3C) before
    the two attention products; qkv_bwd recomputes it and adds dx and dW
    (three projections in all) to the five products of the recompute
    backward, and writes dx, dW, db, dscale and dbias."""
    import torch
    es = 2 if dt == torch.bfloat16 else 4
    rows = windows * n
    params = heads * 4 + heads * n * n * 4 + n_mask * n * n * 4
    sums = heads * (n * n + 1) * 4
    proj = 3 * c * c * 4 + 3 * c * 4
    attn = 2 * windows * n * n * c        # one attention product, all heads
    nbytes, flops = {
        "spatial_fwd": (rows * 3 * c * es + params + rows * c * 4, 2 * attn),
        "spatial_bwd": (2 * rows * 3 * c * es + params + rows * c * es + sums,
                        5 * attn),
        "qkv_fwd": (2 * rows * c * es + proj + params,
                    2 * rows * c * 3 * c + 2 * attn),
        "qkv_bwd": (3 * rows * c * es + 2 * proj + params + sums,
                    3 * 2 * rows * c * 3 * c + 5 * attn),
        # row 18b by part: the recompute and attend kernel (x, g, W in;
        # round(dqkv) and the sums out), the dx product (round(dqkv) and
        # the bf16 W that the sums' part rounds, in; dx out) and the dW
        # product (round(dqkv), x in; dW f32 out)
        "qkv_bwd_attend": (2 * rows * c * es + proj + params
                           + rows * 3 * c * es + sums + 3 * c * 4,
                           2 * rows * c * 3 * c + 5 * attn),
        "qkv_bwd_dx": (rows * 3 * c * es + 3 * c * c * es + rows * c * es,
                       2 * rows * c * 3 * c),
        "qkv_bwd_dw": (rows * 3 * c * es + rows * c * es + 3 * c * c * 4,
                       2 * rows * c * 3 * c)}[kind]
    return _bound(nbytes, flops, dt)


# Swin50's N=49 sites on the grouped route (head_group 4): (name, B·nW,
# heads, windows per image, sites per Swin50 encoder call)
GROUPED_SHAPES = [("swin50_s3", 512, 8, 4, 4), ("swin50_s4", 128, 16, 1, 10)]
# the spatial shapes: AlterNet50's (res, window, heads, unmasked and
# masked sites per encoder call) and Swin50's window-7 ones (no sites there)
SPATIAL_SHAPES = [("stage2", 24, 6, 4, 1, 1), ("stage3", 12, 6, 8, 4, 4),
                  ("stage4", 6, 3, 16, 1, 1), ("swin50_s3", 14, 7, 8, 0, 0),
                  ("swin50_s4", 7, 7, 16, 0, 0)]
# the (window, dim) pairs of AlterNet50 that [alternet50_spatial] lists
ALTERNET50_SPATIAL = frozenset({(6, 128), (6, 256), (3, 512)})
VARIANT_GOLDENS = {n: ROOT / "tests" / "data" / f"{n.lower()}_golden.npz"
                   for n in ("AlterNetSep50", "AlterNetV1_50")}
VARIANT_EPOCHS = 6


def _grouped_cases():
    """Rows 15/16 on the card, bf16: the packed entry with head_group 4 at
    Swin50's shapes, with and without the shift mask (stage 3 only: stage
    4 is one window per image), under autograd with stored_stats=True.
    Returns (max errors {fwd, bwd}, bf16 times per shape, launches {fwd,
    bwd} of the driven calls)."""
    import torch
    from fr_tpu_torch.ops import fused_window_attn as F

    P = F.fused_window_attention_packed
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"fwd": 0.0, "bwd": 0.0}
    times, calls = {}, []
    for name, bw, heads, nw, _ in GROUPED_SHAPES:
        for masked in (False, True):
            if masked and nw == 1:
                continue
            shape = (name, bw, heads, 32, nw, masked)
            qkv, scale, bias16, g, mask, nw_ = _perhead_inputs(
                shape, torch.bfloat16, gen)
            calls.append((qkv, scale, bias16, g, mask, nw_, heads))
            tag = f"{name} {'masked' if masked else 'unmasked'}"
            q = qkv.detach().requires_grad_(True)
            stats_before = P.stats_launches
            out = P(q, scale, bias16, heads, nw_, mask,
                    out_dtype=torch.bfloat16, stored_stats=True,
                    head_group=4)
            out.backward(g)
            torch.cuda.synchronize()
            check(P.stats_launches == stats_before,
                  f"[kernel_variants] {tag}: the grouped route took the "
                  f"stats arm")
            ref = F.window_attention_reference(qkv, scale, bias16, heads,
                                               mask, torch.bfloat16)
            err = (out.float() - ref.float()).abs().max().item()
            check(err <= BF16_TOL, f"[kernel_variants] grouped {tag}: "
                  f"error {err}")
            worst["fwd"] = max(worst["fwd"], err)
            plain = F.window_attention_backward_reference(
                qkv, scale, bias16, g, heads, mask)
            d = ((q.grad.float() - plain[0].float()).norm()
                 / plain[0].float().norm()).item()
            check(d <= 1e-2, f"[kernel_variants] grouped {tag}: dqkv "
                  f"norm-wise {d}")
            worst["bwd"] = max(worst["bwd"], (q.grad.float()
                                              - plain[0].float()).abs()
                               .max().item())
            if masked:
                continue
            t = {"fwd": time_ms(lambda: P(qkv, scale, bias16, heads, nw_,
                                          mask, out_dtype=torch.bfloat16,
                                          head_group=4)),
                 "fwd_plain": time_ms(lambda: F.window_attention_reference(
                     qkv, scale, bias16, heads, mask, torch.bfloat16)),
                 "bwd": time_ms(lambda: F.window_attention_backward(
                     qkv, scale, bias16, g, heads, nw_, mask)),
                 "bwd_plain": time_ms(
                     lambda: F.window_attention_backward_reference(
                         qkv, scale, bias16, g, heads, mask)),
                 "fwd_lib": _library_fwd_ms(qkv, scale, bias16, mask, heads),
                 "bwd_lib": _library_bwd_ms(qkv, scale, bias16, mask, heads,
                                            g)}
            times[name] = t
            print(f"[kernel_variants] grouped {name} {tuple(qkv.shape)} "
                  f"h{heads} hg4: fwd {t['fwd']:.4f} (plain "
                  f"{t['fwd_plain']:.4f}, sdpa {t['fwd_lib']:.4f}), bwd "
                  f"{t['bwd']:.4f} (plain {t['bwd_plain']:.4f}, sdpa "
                  f"{t['bwd_lib']:.4f}) ms; err fwd {err:.2e}, dqkv "
                  f"norm-wise {d:.2e}")
    # the driven path of rows 15/16: every case once more, forward and
    # backward under autograd, with the counts set to 0 just before
    _reset([(P, "grouped_launches"), (P, "grouped_backward_launches")])
    _reset_routes()
    for qkv, scale, bias16, g, mask, nw_, heads in calls:
        q = qkv.detach().requires_grad_(True)
        P(q, scale, bias16, heads, nw_, mask, out_dtype=torch.bfloat16,
          head_group=4).backward(g)
    torch.cuda.synchronize()
    _check_routes("[kernel_variants] grouped route:", len(calls), len(calls))
    launches = {"fwd": P.grouped_launches, "bwd": P.grouped_backward_launches}
    check(launches == {"fwd": len(calls), "bwd": len(calls)},
          f"[kernel_variants] grouped launches {launches} for {len(calls)} "
          f"calls")
    return worst, times, launches


def _spatial_cases():
    """Row 17 against its plain versions at SPATIAL_SHAPES, masked and
    unmasked, bf16 and f32; times in bf16 with the chain it replaces
    (partition, the row-1 or row-2 kernel, reverse) and SDPA on the
    partitioned qkv (not the same function)."""
    import torch
    from fr_tpu_torch.models.swin_common import (shifted_window_mask,
                                                 window_partition,
                                                 window_reverse)
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.ops import fused_window_attn_variants as V

    gen = torch.Generator(device="cuda").manual_seed(12)
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for name, res, ws, heads, *_ in SPATIAL_SHAPES:
        c = heads * 32
        for masked in (False, True):
            if masked and res == ws:
                continue
            mask = (torch.from_numpy(shifted_window_mask(res, res, ws,
                                                         ws // 2)).cuda()
                    if masked else None)
            nw = (res // ws) ** 2
            for dt, tol in ((torch.bfloat16, BF16_TOL),
                            (torch.float32, F32_TOL)):
                qkv = torch.randn(128, res, res, 3 * c, device="cuda",
                                  generator=gen).to(dt)
                scale = torch.empty(heads, device="cuda").uniform_(
                    5.0, 20.0, generator=gen)
                bias16 = 16 * torch.sigmoid(torch.randn(
                    heads, ws * ws, ws * ws, device="cuda", generator=gen))
                g = torch.randn(128, res, res, c, device="cuda",
                                generator=gen)
                tag = (f"spatial {name} {'masked' if masked else 'unmasked'}"
                       f" {str(dt).split('.')[-1]}")
                out = V.fused_window_attention_spatial(qkv, scale, bias16,
                                                       heads, ws, mask)
                grads = V.spatial_attention_backward(qkv, scale, bias16, g,
                                                     heads, ws, mask)
                torch.cuda.synchronize()
                ref = V.window_attention_spatial_reference(
                    qkv, scale, bias16, heads, ws, mask)
                check(out.dtype == torch.float32
                      and bool(torch.isfinite(out).all()),
                      f"[kernel_variants] {tag}: output")
                err = (out - ref).abs().max().item()
                check(err <= tol, f"[kernel_variants] {tag}: error {err}")
                worst["fwd"] = max(worst["fwd"], err)
                worst["bwd"] = max(worst["bwd"], _check_grads(
                    f"[kernel_variants] {tag}", grads,
                    V.window_attention_spatial_backward_reference(
                        qkv, scale, bias16, g, heads, ws, mask), dt))
                if dt != torch.bfloat16:
                    continue

                def chain_fwd():
                    win = F.fused_window_attention_packed(
                        window_partition(qkv, ws), scale, bias16, heads,
                        nw if masked else 1, mask)
                    return window_reverse(win, ws, res, res)

                def chain_bwd():
                    d = F.window_attention_backward(
                        window_partition(qkv, ws), scale, bias16,
                        window_partition(g, ws), heads, nw if masked else 1,
                        mask)
                    return window_reverse(d[0], ws, res, res)

                wq = window_partition(qkv, ws)
                t = {"fwd": time_ms(lambda: V.fused_window_attention_spatial(
                         qkv, scale, bias16, heads, ws, mask)),
                     "fwd_plain": time_ms(
                         lambda: V.window_attention_spatial_reference(
                             qkv, scale, bias16, heads, ws, mask)),
                     "fwd_chain": time_ms(chain_fwd),
                     "fwd_lib": _library_fwd_ms(wq, scale, bias16, mask,
                                                heads),
                     "bwd": time_ms(lambda: V.spatial_attention_backward(
                         qkv, scale, bias16, g, heads, ws, mask)),
                     "bwd_plain": time_ms(
                         lambda: V.window_attention_spatial_backward_reference(
                             qkv, scale, bias16, g, heads, ws, mask)),
                     "bwd_chain": time_ms(chain_bwd),
                     "bwd_lib": _library_bwd_ms(
                         wq, scale, bias16, mask, heads,
                         window_partition(g, ws).to(dt))}
                times[(name, masked)] = t
                print(f"[kernel_variants] {tag:34s} {tuple(qkv.shape)} h"
                      f"{heads}: fwd {t['fwd']:.4f} (plain "
                      f"{t['fwd_plain']:.4f}, partition+row1+reverse "
                      f"{t['fwd_chain']:.4f}, sdpa {t['fwd_lib']:.4f}); bwd "
                      f"{t['bwd']:.4f} (plain {t['bwd_plain']:.4f}, "
                      f"partition+row2+reverse {t['bwd_chain']:.4f}, sdpa "
                      f"{t['bwd_lib']:.4f}) ms")
    return worst, times


def _qkv_check(tag, grads, ref, dt):
    """Row 18's backward against its plain version: f32 dx, dscale, dbias
    5e-5·max(|ref|, 1) element-wise, dW and db (sums over every token row,
    in another order) 1e-5 norm-wise; bf16 1e-2 norm-wise and dscale
    3e-2·max(|ref|, 1) (a bf16 rounding of the projection's qkv flips where
    the f32 sums differ in the last digit). Returns the max-abs error of
    each gradient, {name: error}."""
    import torch
    errs = {}
    for t_name, a, b in zip(("dx", "dw", "db", "dscale", "dbias"), grads,
                            ref):
        a, b = a.float(), b.float()
        check(bool(torch.isfinite(a).all()), f"{tag} {t_name} not finite")
        mx = (a - b).abs().max().item()
        if dt == torch.bfloat16 and t_name == "dscale":
            ok = mx <= 3e-2 * max(b.abs().max().item(), 1.0)
        elif dt == torch.bfloat16 or t_name in ("dw", "db"):
            rel = ((a - b).norm() / b.norm()).item()
            ok = rel <= (1e-2 if dt == torch.bfloat16 else 1e-5)
        else:
            ok = mx <= F32_TOL * max(b.abs().max().item(), 1.0)
        check(ok, f"{tag} {t_name}: max-abs {mx}")
        errs[t_name] = mx
    return errs


def _qkv_bwd_parts(call, reps: int = 10):
    """Device ms per call of the tensor-core all-in-kernel backward by part,
    from torch.profiler over ``reps`` calls after one: "attend" the
    recompute-and-attend kernel, "dx" and "dw" the two mma.sync products,
    "sums" the fixed-order sums and W's rounding, "other" the wrapper's
    PyTorch copies (g's rounding, the gradients' slices)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    parts = dict.fromkeys(("attend", "dx", "dw", "sums", "other"), 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n = e.name
        key = ("attend" if "window_attn_qkv_bwd_tc_kernel" in n else
               ("dw" if "true" in n or "(bool)1" in n else "dx")
               if "window_attn_qkv_grad_mma_kernel" in n else
               "sums" if ("window_sum_kernel" in n
                          or "window_attn_qkv_round_kernel" in n) else
               "other")
        parts[key] += (e.time_range.end - e.time_range.start) / 1e3 / reps
    check(all(parts[k] > 0 for k in ("attend", "dx", "dw", "sums")),
          f"[kernel_variants] the profile misses a part of row 18b: {parts}")
    return parts


def _qkv_cases():
    """Row 18 against its plain versions at the AlterNet50 shapes, masked
    and unmasked, bf16 and f32: the forward (bf16 on the tensor-core body,
    f32 on the CUDA-core one, each call's route checked) and the
    all-in-kernel backward (the same two bodies, each call's route
    checked), its sums repeated bit for bit; times in bf16 with F.linear +
    the row-1 kernel (the same function, unfused), the hybrid backward,
    SDPA (not the same function), and the tensor-core backward by part
    (_qkv_bwd_parts) beside the parts' plain versions and one PyTorch call
    each for dx (torch.matmul in bf16) and dW (torch.mm, bf16 in, f32 sums
    and out). Then bf16 beyond the tensor-core tile, C = 72: both on the
    CUDA-core body, checked against the plain version as the tensor-core
    one is."""
    import torch
    import torch.nn.functional as Fn
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.ops import fused_window_attn_variants as V

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {"fwd": 0.0, "bwd": 0.0, "bwd_attend": 0.0, "bwd_dx": 0.0,
             "bwd_dw": 0.0}
    times = {}
    for name, bw, n, heads, res, ws, *_ in SHAPES:
        c = heads * 32
        for masked in (False, True):
            for dt, tol in ((torch.bfloat16, BF16_TOL),
                            (torch.float32, F32_TOL)):
                qkv, scale, bias16, g, mask, nw = _attention_inputs(
                    bw, n, heads, res, ws, masked, dt, gen)
                x = torch.randn(bw, n, c, device="cuda", generator=gen).to(dt)
                # qkv ~ N(0, 1) as rows 1/2's inputs, so that |out| < 4,
                # where BF16_TOL is two bf16 ulps
                w = torch.randn(3 * c, c, device="cuda",
                                generator=gen) / c ** 0.5
                b = 0.1 * torch.randn(3 * c, device="cuda", generator=gen)
                tag = (f"[kernel_variants] qkv {name} "
                       f"{'masked' if masked else 'unmasked'} "
                       f"{str(dt).split('.')[-1]}")
                route, out = _route_of(
                    lambda: V.fused_window_attention_packed_qkv(
                        x, w, b, scale, bias16, heads, nw, mask,
                        out_dtype=dt))
                check(route == ("tensor_cores" if dt == torch.bfloat16
                                else "cuda_cores"),
                      f"{tag}: the forward took the {route} body")
                route, grads = _route_of(
                    lambda: V.qkv_attention_backward(
                        x, w, b, scale, bias16, g, heads, nw, mask))
                check(route == ("tensor_cores" if dt == torch.bfloat16
                                else "cuda_cores"),
                      f"{tag}: the backward took the {route} body")
                torch.cuda.synchronize()
                ref = V.window_attention_qkv_reference(
                    x, w, b, scale, bias16, heads, mask, dt)
                err = (out.float() - ref.float()).abs().max().item()
                check(bool(torch.isfinite(out.float()).all()) and err <= tol,
                      f"{tag}: error {err}")
                worst["fwd"] = max(worst["fwd"], err)
                errs = _qkv_check(
                    tag, grads, V.window_attention_qkv_backward_reference(
                        x, w, b, scale, bias16, g, heads, mask), dt)
                worst["bwd"] = max(worst["bwd"], *errs.values())
                again = V.qkv_attention_backward(x, w, b, scale, bias16, g,
                                                 heads, nw, mask)
                check(all(torch.equal(a, a2) for a, a2 in zip(grads, again)),
                      f"{tag}: the sums changed between two runs")
                if dt != torch.bfloat16:
                    continue
                # the parts' errors: the attend kernel makes db, dscale and
                # dbias, the products dx and dW
                for part, names in (("attend", ("db", "dscale", "dbias")),
                                    ("dx", ("dx",)), ("dw", ("dw",))):
                    worst[f"bwd_{part}"] = max(worst[f"bwd_{part}"], *(
                        errs[k] for k in names))
                bias = b.to(dt)

                def attend_plain():
                    qkv_r = V._project(x, w, b)
                    p, _ = F._softmax_probs(qkv_r, scale, bias16, heads, mask)
                    return F._grad_products(qkv_r, scale, p, g, heads)

                d16 = attend_plain()[0].to(dt).reshape(-1, 3 * c)
                w16 = w.to(dt)
                x2 = x.reshape(-1, c)

                def linear_row1():
                    q = Fn.linear(x, w.to(dt)) + bias
                    return F.fused_window_attention_packed(
                        q, scale, bias16, heads, nw, mask, out_dtype=dt)

                q0 = Fn.linear(x, w.to(dt)) + bias
                t = {"fwd": time_ms(
                         lambda: V.fused_window_attention_packed_qkv(
                             x, w, b, scale, bias16, heads, nw, mask,
                             out_dtype=dt)),
                     "fwd_plain": time_ms(
                         lambda: V.window_attention_qkv_reference(
                             x, w, b, scale, bias16, heads, mask, dt)),
                     "fwd_chain": time_ms(linear_row1),
                     "fwd_lib": _library_fwd_ms(q0, scale, bias16, mask,
                                                heads),
                     "bwd": time_ms(lambda: V.qkv_attention_backward(
                         x, w, b, scale, bias16, g, heads, nw, mask)),
                     "bwd_plain": time_ms(
                         lambda: V.window_attention_qkv_backward_reference(
                             x, w, b, scale, bias16, g, heads, mask)),
                     "bwd_hybrid": time_ms(lambda: V.hybrid_backward(
                         x, w, b, scale, bias16, g, heads, nw, mask)),
                     "bwd_lib": _library_bwd_ms(q0, scale, bias16, mask,
                                                heads, g),
                     "bwd_attend_plain": time_ms(attend_plain),
                     "bwd_dx_plain": time_ms(lambda: torch.matmul(
                         d16.float(), w16.float()).to(dt)),
                     "bwd_dx_lib": time_ms(lambda: torch.matmul(d16, w16)),
                     "bwd_dw_plain": time_ms(lambda: torch.matmul(
                         d16.float().t(), x2.float())),
                     "bwd_dw_lib": time_ms(lambda: torch.mm(
                         d16.t(), x2, out_dtype=torch.float32))}
                t.update({f"bwd_{k}": v for k, v in _qkv_bwd_parts(
                    lambda: V.qkv_attention_backward(
                        x, w, b, scale, bias16, g, heads, nw, mask)).items()})
                times[(name, masked)] = t
                print(f"[kernel_variants] qkv {name} "
                      f"{'masked' if masked else 'unmasked'} x "
                      f"{tuple(x.shape)} h{heads}: fwd {t['fwd']:.4f} (plain "
                      f"{t['fwd_plain']:.4f}, F.linear+row1 "
                      f"{t['fwd_chain']:.4f}, sdpa {t['fwd_lib']:.4f}); "
                      f"all-in-kernel bwd {t['bwd']:.4f} (plain "
                      f"{t['bwd_plain']:.4f}, hybrid {t['bwd_hybrid']:.4f}, "
                      f"sdpa {t['bwd_lib']:.4f}) ms; by part (profiler) "
                      f"attend "
                      f"{t['bwd_attend']:.4f}, dx {t['bwd_dx']:.4f}, dW "
                      f"{t['bwd_dw']:.4f}, sums {t['bwd_sums']:.4f}, other "
                      f"{t['bwd_other']:.4f} (plain attend "
                      f"{t['bwd_attend_plain']:.4f}, dx "
                      f"{t['bwd_dx_plain']:.4f}, dW {t['bwd_dw_plain']:.4f};"
                      f" torch.matmul bf16 dx {t['bwd_dx_lib']:.4f}, "
                      f"torch.mm bf16 → f32 dW {t['bwd_dw_lib']:.4f}) ms")
    # bf16 beyond the tile: C = 72 (N 36, 4 heads of 18) is not a multiple
    # of 16, so the CUDA-core bodies of the forward and the backward
    dt, heads, c = torch.bfloat16, 4, 72
    _, scale, bias16, _, mask, nw = _attention_inputs(
        64, 36, heads, 12, 6, True, dt, gen)
    x = torch.randn(64, 36, c, device="cuda", generator=gen).to(dt)
    w = torch.randn(3 * c, c, device="cuda", generator=gen) / c ** 0.5
    b = 0.1 * torch.randn(3 * c, device="cuda", generator=gen)
    g = torch.randn(64, 36, c, device="cuda", generator=gen).to(dt)
    tag = "[kernel_variants] qkv N36 C72 h4 masked bfloat16"
    route, out = _route_of(lambda: V.fused_window_attention_packed_qkv(
        x, w, b, scale, bias16, heads, nw, mask, out_dtype=dt))
    check(route == "cuda_cores", f"{tag}: the forward took the {route} body")
    route, grads = _route_of(lambda: V.qkv_attention_backward(
        x, w, b, scale, bias16, g, heads, nw, mask))
    check(route == "cuda_cores", f"{tag}: the backward took the {route} "
          f"body")
    torch.cuda.synchronize()
    err = (out.float() - V.window_attention_qkv_reference(
        x, w, b, scale, bias16, heads, mask, dt).float()).abs().max().item()
    check(bool(torch.isfinite(out.float()).all()) and err <= BF16_TOL,
          f"{tag}: error {err}")
    errs = _qkv_check(tag, grads, V.window_attention_qkv_backward_reference(
        x, w, b, scale, bias16, g, heads, mask), dt)
    print(f"{tag}: forward and backward on the CUDA cores, forward max-abs "
          f"{err:.2e}, backward max-abs " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items()))
    return worst, times


def phase_kernel_variants():
    """[kernel_variants]: rows 15-18 against their plain versions. Returns
    ({row: (max error fwd, max error bwd)}, {row: times}, the launches of
    the grouped route's driven calls)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    grouped_err, grouped_t, grouped_launches = _grouped_cases()
    spatial_err, spatial_t = _spatial_cases()
    qkv_err, qkv_t = _qkv_cases()
    return ({"grouped": grouped_err, "spatial": spatial_err,
             "qkv": qkv_err},
            {"grouped": grouped_t, "spatial": spatial_t, "qkv": qkv_t},
            grouped_launches)


class _Route:
    """Switches the AlterNet50 attention route for a ``with`` block and
    restores every switch after it: "windows" (the default), "spatial"
    (ALTERNET50_SPATIAL listed), "entry_fused" (WindowAttention.entry_fused,
    hybrid backward), "entry_fused_allkernel" (and _PKX_HYBRID_BWD
    False)."""

    def __init__(self, route):
        self.route = route

    def __enter__(self):
        from fr_tpu_torch.models import swin_common
        from fr_tpu_torch.ops import fused_window_attn_variants as V
        self.saved = (swin_common.SPATIAL_KERNEL_CONFIGS,
                      swin_common.WindowAttention.entry_fused,
                      V._PKX_HYBRID_BWD)
        if self.route == "spatial":
            swin_common.SPATIAL_KERNEL_CONFIGS = ALTERNET50_SPATIAL
        elif self.route.startswith("entry_fused"):
            swin_common.WindowAttention.entry_fused = True
            V._PKX_HYBRID_BWD = self.route == "entry_fused"
        return self

    def __exit__(self, *exc):
        from fr_tpu_torch.models import swin_common
        from fr_tpu_torch.ops import fused_window_attn_variants as V
        (swin_common.SPATIAL_KERNEL_CONFIGS,
         swin_common.WindowAttention.entry_fused,
         V._PKX_HYBRID_BWD) = self.saved
        return False


def _route_counters(route):
    """(forward, backward) counters of a route's kernels."""
    from fr_tpu_torch.ops import fused_window_attn as F
    from fr_tpu_torch.ops import fused_window_attn_variants as V
    return {"windows": ((F.fused_window_attention_packed, "launches"),
                        (F.window_attention_backward, "launches")),
            "spatial": ((V.fused_window_attention_spatial, "launches"),
                        (V.fused_window_attention_spatial,
                         "backward_launches")),
            "entry_fused": ((V.fused_window_attention_packed_qkv,
                             "launches"),
                            (F.window_attention_backward, "launches")),
            "entry_fused_allkernel": ((V.fused_window_attention_packed_qkv,
                                       "launches"),
                                      (V.fused_window_attention_packed_qkv,
                                       "backward_launches"))}[route]


def _route_golden(route, tag):
    """Full-width AlterNet50 through a route against fr_tpu's golden
    embeddings: f32 (TF32 off) max-abs ≤ 1e-3, bf16 per-row cosine ≥ 0.99,
    12 forward launches on the route's counter."""
    import numpy as np
    import torch
    from fr_tpu_torch.configs.base import Config
    from fr_tpu_torch.models.alternet import ALTERNET_PLANS, AlterNet
    from fr_tpu_torch.train.step import make_embed_step
    from fr_tpu_torch.utils.golden import golden_images, seeded_state_dict

    golden = np.load(GOLDEN)
    seed, ref = int(golden["seed"]), golden["embeddings"]
    fwd, _ = _route_counters(route)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        model = AlterNet(*ALTERNET_PLANS["AlterNet50"], img_size=192,
                         emd_size=512, compute_dtype=dtype)
        model.load_state_dict(seeded_state_dict(model, seed), strict=True)
        embed = make_embed_step(Config(img_size=192), model.cuda(), "cuda")
        before = getattr(*fwd)
        with _Route(route):
            out = embed(golden_images(seed)).cpu().numpy()
        check(getattr(*fwd) - before == 12, f"{tag} golden run: "
              f"{getattr(*fwd) - before} launches, expected 12")
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


def _route_grads(route, tag, n_img: int = 8):
    """One f32 encoder backward (TF32 off, train mode, the golden's seeded
    weights, one dropout seed, a fixed projection of the L2-normalised
    embeddings as the loss) through the route against the windows route:
    every parameter's gradient norm-wise within 1e-3 above a floor of 1e-5
    of the largest gradient norm, as [alternet50]'s stats switch holds it.
    Printed per attention group, over the tensors above the floor (v_bias
    and proj.bias get gradients of rounding noise, ~1e-9 of the largest:
    the next BatchNorm cancels them): qkv, q_bias, logit_scale, cpb_mlp,
    proj."""
    import numpy as np
    import torch
    from fr_tpu_torch.models.common import l2_normalize
    from fr_tpu_torch.utils.golden import (golden_encoder, golden_images,
                                           seeded_state_dict)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = golden_encoder("AlterNet50", train=True)
    model.load_state_dict(seeded_state_dict(model, 0), strict=True)
    model.cuda().train()
    x = torch.from_numpy(golden_images(0, n_img, 192)).cuda()
    r = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (n_img, 512)).astype(np.float32)).cuda()
    names, params = zip(*model.named_parameters())
    grads = {}
    for arm in ("windows", route):
        gen = torch.Generator(device="cuda").manual_seed(8)
        with _Route(arm):
            loss = (l2_normalize(model(x, gen).float()) * r).sum()
            grads[arm] = torch.autograd.grad(loss, params)
    norms = [float(g.norm()) for g in grads["windows"]]
    diffs = [float((a - b).norm()) for a, b in zip(grads[route],
                                                   grads["windows"])]
    floor = 1e-5 * max(norms)
    worst = max(max(d - floor, 0.0) / max(n0, 1e-30)
                for n0, d in zip(norms, diffs))
    groups = {}
    for name, n0, d in zip(names, norms, diffs):
        for group in ("qkv", "q_bias", "logit_scale", "cpb_mlp", "proj"):
            if f".attn.{group}" in name and n0 > floor:
                groups[group] = max(groups.get(group, 0.0), d / n0)
    print(f"{tag} f32 encoder gradients against the windows route ({n_img} "
          f"images): worst norm-wise difference beyond the floor "
          f"{worst:.2e} (tol 1e-3); per attention group above the floor: "
          + ", ".join(f"{k} {v:.1e}" for k, v in groups.items()))
    check(len(groups) == 5, f"{tag} attention groups above the floor: "
          f"{sorted(groups)}")
    check(worst <= 1e-3, f"{tag} gradients differ from the windows route's:"
          f" {worst:.2e}")
    del model


def phase_alternet50_routes(steps: int = 3, timed: int = 5):
    """[alternet50_spatial] and [alternet50_entry_fused]: full-width
    AlterNet50 through the spatial route and the entry-fused route (hybrid
    and all-in-kernel backward): the golden; three bf16 training steps
    (b=128, the CLI's synthetic head) from one seed against the windows
    route, losses within 1e-3 relative, 12 forward and 12 backward launches
    per step on the route's counters (set to 0 just before those steps);
    ms per step on the host clock over ``timed`` more steps; one f32 encoder
    backward against the windows route; a [profile] of each route's step
    (phase_profile). Returns {route: (forward launches, backward launches)}
    and {route: ms per step}."""
    import torch
    from fr_tpu_torch.cli.main import build_conf, parse_args
    from fr_tpu_torch.train.task import FaceRecognitionTask

    args = parse_args(TRAIN_ARGS)
    conf = build_conf(args)
    conf.n_classes = args.synthetic_classes
    gen = torch.Generator(device="cuda").manual_seed(14)
    images = torch.randint(0, 256, (steps + timed, conf.b, conf.img_size,
                                    conf.img_size, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    labels = torch.randint(0, conf.n_classes, (steps + timed, conf.b),
                           device="cuda", generator=gen)
    losses, launches, ms = {}, {}, {}
    for route in ("windows", "spatial", "entry_fused",
                  "entry_fused_allkernel"):
        tag = ("[alternet50_spatial]" if route == "spatial" else
               "[alternet50_entry_fused]" if route != "windows"
               else "[alternet50_windows]")
        counters = _route_counters(route)
        with _Route(route):
            task = FaceRecognitionTask(conf, stage="train", device="cuda",
                                       seed=0)
            _reset(counters)
            _reset_routes()
            losses[route] = [task.training_step((images[i], labels[i]))[
                "loss"].item() for i in range(steps)]
            launches[route] = tuple(getattr(f, a) for f, a in counters)
            # every route's forward and backward run on the tensor cores:
            # the all-in-kernel backward its own kernels, the others the
            # row-2 body
            _check_routes(f"{tag} {route}:", 12 * steps, 12 * steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps, steps + timed):
                out = task.training_step((images[i], labels[i]))
            out["loss"].item()
            ms[route] = (time.perf_counter() - t0) * 1e3 / timed
            del task
            # device busy, idle share and time by family of the route's step
            print(f"{tag} {route}: torch.profiler of the step at the full "
                  f"ms1m head")
            phase_profile("AlterNet50")
        print(f"{tag} {route}: losses {[round(x, 5) for x in losses[route]]}"
              f", launches forward/backward {launches[route]} over {steps} "
              f"steps; {ms[route]:.2f} ms per step (host clock, {timed} "
              f"steps, bf16 b={conf.b})")
        check(launches[route] == (12 * steps, 12 * steps),
              f"{tag} {route}: launches {launches[route]}, expected "
              f"{12 * steps} each")
        if route == "windows":
            continue
        for a, b in zip(losses["windows"], losses[route]):
            check(abs(a - b) <= 1e-3 * abs(a), f"{tag} {route} loss {b} vs "
                  f"the windows route's {a}: beyond 1e-3 relative")
        if route != "entry_fused_allkernel":
            _route_golden(route, tag)
        _route_grads(route, f"{tag} {route}")
    return launches, ms


def _retired_serving(network, tag, counters, per_call, extra=()):
    """The serving CLI on the golden's seeded weights (an fr_tpu-layout
    snapshot through --ckpt_path); ``counters`` must rise by ``per_call``
    each per encoder call. Returns the launches {counter: count}."""
    import numpy as np
    from fr_tpu_torch.cli.main import main as cli_main
    from fr_tpu_torch.models.alternet import AlterNetSep
    from fr_tpu_torch.models.alternet_v1 import AlterNetV1
    from fr_tpu_torch.utils.golden import golden_encoder, seeded_state_dict
    from fr_tpu_torch.utils.jax_import import export_encoder_npz

    cls = AlterNetV1 if "V1" in network else AlterNetSep
    seed = int(np.load(VARIANT_GOLDENS[network])["seed"])
    calls = _EncoderCalls(cls)
    captured = io.StringIO()
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(_Tee(sys.stdout, captured)):
            model = golden_encoder(network)
            model.load_state_dict(seeded_state_dict(model, seed), strict=True)
            ckpt = str(Path(tmp) / "seeded.npz")
            export_encoder_npz(ckpt, model, 0, network, 112)
            del model
            _reset(counters)
            msg = cli_main(_net_args(network, "test") + list(extra) + [
                "--save_root", tmp, "--ckpt_path", ckpt])
            counts = [getattr(f, a) for f, a in counters]
    finally:
        calls.close()
    n_calls = calls.counts["eval"]
    print(f"{tag} serving: {n_calls} encoder calls, launches {counts}")
    check(n_calls >= 1 and counts == [p * n_calls for p in per_call],
          f"{tag} launches {counts} for {n_calls} calls, expected "
          f"{per_call} per call")
    check('[Test with "synthetic"]' in captured.getvalue(),
          f"{tag} the ROC report was not printed")
    emb = np.concatenate(msg["synthetic"].embeddings)
    norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
    check(emb.shape == (512, 512) and bool(np.isfinite(emb).all())
          and norm_err <= 1e-4, f"{tag} embeddings {emb.shape}")
    print(f"{tag} embeddings {emb.shape} finite, max | |e| - 1 | "
          f"{norm_err:.2e}; mean {msg['synthetic'].infer_time:.2f} ms per "
          f"call of 128 images, host to host")
    return dict(zip((f"{f.__name__}.{a}" for f, a in counters), counts))


def _retired_golden(network, tag, bf16_cos=0.99):
    """The network's golden at 112 px: f32 (TF32 off) max-abs ≤ 1e-3, bf16
    per-row cosine ≥ bf16_cos."""
    import numpy as np
    import torch
    from fr_tpu_torch.configs.base import Config
    from fr_tpu_torch.train.step import make_embed_step
    from fr_tpu_torch.utils.golden import (golden_encoder, golden_images,
                                           seeded_state_dict)

    golden = np.load(VARIANT_GOLDENS[network])
    seed, ref = int(golden["seed"]), golden["embeddings"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16):
        model = golden_encoder(network, dtype)
        model.load_state_dict(seeded_state_dict(model, seed), strict=True)
        embed = make_embed_step(Config(img_size=112), model.cuda(), "cuda")
        out = embed(golden_images(seed, img_size=112)).cpu().numpy()
        if dtype == torch.float32:
            err = float(np.abs(out - ref).max())
            print(f"{tag} golden f32 (TF32 off) max_abs_err {err:.3e} "
                  f"(tol 1e-3)")
            check(err <= 1e-3, f"{tag} f32 golden error {err}")
        else:
            cos = np.sum(out * ref, axis=1) / (
                np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
            print(f"{tag} golden bf16 min per-row cosine {cos.min():.5f} "
                  f"(tol {bf16_cos})")
            check(cos.min() >= bf16_cos,
                  f"{tag} bf16 golden cosine {cos.min()}")
        del model, embed


def phase_alternet_sep50():
    """[alternet_sep50]: the serving CLI (1 packed-entry and 9 per-head
    forward launches per encoder call), the golden, and the training CLI
    (bf16, b=128, VARIANT_EPOCHS epochs: 1 + 9 forward launches per call,
    1 + 9 backward per step, the last epoch's loss below the first's).
    Returns the launches of both runs."""
    import numpy as np
    from fr_tpu_torch.cli.main import main as cli_main
    from fr_tpu_torch.models.alternet import AlterNetSep
    from fr_tpu_torch.ops import fused_window_attn as F

    tag = "[alternet_sep50]"
    fwd = [(F.fused_window_attention_packed, "launches"),
           (F.fused_window_attention, "launches")]
    bwd = [(F.window_attention_backward, "launches"),
           (F.fused_window_attention, "backward_launches")]
    serve = _retired_serving("AlterNetSep50", tag, fwd, [1, 9])
    _retired_golden("AlterNetSep50", tag)
    calls = _EncoderCalls(AlterNetSep)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            _reset(fwd + bwd)
            task = cli_main(_net_args("AlterNetSep50", "train")[:-1] + [
                str(VARIANT_EPOCHS), "--save_root", tmp])
            counts = [getattr(f, a) for f, a in fwd + bwd]
            wall = time.perf_counter() - t0
    finally:
        calls.close()
    steps, evals = calls.counts["train"], calls.counts["eval"]
    losses = [h["train_loss"] for h in task.history]
    print(f"{tag} training: {steps} steps, {evals} eval calls, launches "
          f"forward packed/per-head {counts[:2]}, backward {counts[2:]}; "
          f"epoch losses {[round(x, 4) for x in losses]}; {wall:.1f} s")
    check(steps == VARIANT_EPOCHS * 8, f"{tag} {steps} training steps")
    check(counts == [steps + evals, 9 * (steps + evals), steps, 9 * steps],
          f"{tag} training launches {counts}")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"{tag} training loss {losses}")
    del task
    return serve, counts


def phase_alternet_v1_50():
    """[alternet_v1_50]: the serving CLI at --img_size 112 (fr_tpu's
    default 192 does not build, ROADMAP §3; no attention kernel: its
    products are torch.matmul) and the golden. bf16 is held at cosine 0.97:
    fr_tpu's own bf16 embeddings of the golden's weights sit at 0.979-0.982
    of its f32 ones (on the CPU; the unnormalised q·k softmax of the local
    attention is sharp at these weights)."""
    tag = "[alternet_v1_50]"
    _retired_serving("AlterNetV1_50", tag, [], [],
                     extra=("--img_size", "112"))
    _retired_golden("AlterNetV1_50", tag, bf16_cos=0.97)


def phase_dw_taps():
    """[dw_taps]: EffiAlter_m at full width on the golden's seeded weights,
    f32 with TF32 off, eval mode: conf.dw_taps (DepthwiseTaps) against the
    depthwise conv, the same state dict; embeddings max-abs ≤ 1e-5."""
    import numpy as np
    import torch
    from fr_tpu_torch.configs.base import Config
    from fr_tpu_torch.models import build_encoder
    from fr_tpu_torch.models.effialternet import DepthwiseTaps
    from fr_tpu_torch.utils.golden import golden_images, seeded_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(np.load(ROOT / "tests" / "data" /
                       "effialter_m_golden.npz")["seed"])
    x = torch.from_numpy(golden_images(seed, img_size=112)).cuda()
    outs, sd = {}, None
    for taps in (False, True):
        model = build_encoder(Config(network="EffiAlter_m", img_size=112,
                                     emd_size=512, dw_taps=taps))
        sd = sd or seeded_state_dict(model, seed)
        model.load_state_dict(sd, strict=True)
        n_taps = sum(isinstance(m, DepthwiseTaps) for m in model.modules())
        check((n_taps > 0) == taps, f"[dw_taps] {n_taps} DepthwiseTaps with "
              f"dw_taps={taps}")
        with torch.no_grad():
            outs[taps] = model.cuda().eval()(x)
        del model
    err = (outs[True] - outs[False]).abs().max().item()
    print(f"[dw_taps] EffiAlter_m f32 (TF32 off), 4 images: DepthwiseTaps "
          f"against the depthwise conv, max-abs {err:.3e} (tol 1e-5)")
    check(bool(torch.isfinite(outs[True]).all()) and err <= 1e-5,
          f"[dw_taps] error {err}")


def _variant_entries(errs, times, launches):
    """The JSON entries of rows 15-18. Times: rows 15/16 one Swin50 encoder
    call's grouped sites (4 at s3, 10 at s4), rows 17/18 one AlterNet50
    encoder call or step (12 sites, 3-4 of them masked), bf16."""
    import torch
    var = "fused_window_attn_variants.py"
    bf = torch.bfloat16
    g = times["grouped"]
    out = []
    for kind, line, row in (("fwd", 462, 15), ("bwd", 500, 16)):
        mix = {k: sum(g[name][k] * sites
                      for name, *_, sites in GROUPED_SHAPES)
               for k in (kind, f"{kind}_plain", f"{kind}_lib")}
        bounds = [(_attn_bound_ms(bw, 49, heads * 32, heads, bf, kind, 0),
                   sites) for _, bw, heads, _, sites in GROUPED_SHAPES]
        bound = (sum(b[0] * sites for b, sites in bounds), bounds[-1][0][1])
        out.append(_entry(f"window_attn_{kind}_tc (grouped route, row "
                          f"{row})", "window_attn_tc.cuh", f"{var}:{line}",
                          launches["grouped"][kind], errs["grouped"][kind],
                          mix[kind], mix[f"{kind}_plain"], bound,
                          mix[f"{kind}_lib"]))
    for key, src, cases in (
            ("spatial", "window_attn_tc.cuh", ((247, "fwd"), (289, "bwd"))),
            ("qkv", "window_attn_qkv.cu", ((678, "fwd"), (754, "bwd")))):
        t = times[key]
        for line, kind in cases:
            mix = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
            by = "bytes"
            for name, bw, n, heads, res, ws, n_unmasked, n_masked in SHAPES:
                for masked, count in ((False, n_unmasked), (True, n_masked)):
                    tt = t[(name, masked)]
                    mix["ms"] += count * tt[kind]
                    mix["plain"] += count * tt[f"{kind}_plain"]
                    mix["lib"] += count * tt[f"{kind}_lib"]
                    b, by = _variant_bound(
                        f"{key}_{kind}", bw, n, heads * 32, heads, bf,
                        (res // ws) ** 2 if masked else 0)
                    mix["bound"] += count * b
            count = {("spatial", "fwd"): launches["spatial"][0],
                     ("spatial", "bwd"): launches["spatial"][1],
                     ("qkv", "fwd"): launches["entry_fused"][0],
                     ("qkv", "bwd"): launches["entry_fused_allkernel"][1]}[
                         (key, kind)]
            out.append(_entry(f"window_attn_{key}_{kind}_tc", src,
                              f"{var}:{line}", count, errs[key][kind],
                              mix["ms"], mix["plain"], (mix["bound"], by),
                              mix["lib"]))
    # row 18b's kernels by part, launched once each per backward call
    t = times["qkv"]
    for part, kernel in (("attend", "window_attn_qkv_bwd_tc_kernel"),
                         ("dx", "window_attn_qkv_grad_mma_kernel"),
                         ("dw", "window_attn_qkv_grad_mma_kernel")):
        mix = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
        by = "bytes"
        for name, bw, n, heads, res, ws, n_unmasked, n_masked in SHAPES:
            for masked, count in ((False, n_unmasked), (True, n_masked)):
                tt = t[(name, masked)]
                mix["ms"] += count * tt[f"bwd_{part}"]
                mix["plain"] += count * tt[f"bwd_{part}_plain"]
                mix["lib"] += count * tt.get(f"bwd_{part}_lib", 0.0)
                b, by = _variant_bound(
                    f"qkv_bwd_{part}", bw, n, heads * 32, heads, bf,
                    (res // ws) ** 2 if masked else 0)
                mix["bound"] += count * b
        out.append(_entry(f"{kernel} (row 18b: {part})", "window_attn_qkv.cu",
                          f"{var}:754", launches["entry_fused_allkernel"][1],
                          errs["qkv"][f"bwd_{part}"], mix["ms"],
                          mix["plain"], (mix["bound"], by),
                          mix["lib"] if part in ("dx", "dw") else None))
    return out


def _head_device_ms(events, kernels, steps):
    """{range: device ms per step} of the kernels that the profiled steps
    launched inside train/step.py's ``pfc_head:*`` ranges (rows, loss,
    backward, update). A kernel belongs to the range whose host interval
    holds its launch call (a CUDA API call, ``cu*``); kernel and
    launch call share a correlation id, which is the event's ``id``."""
    import bisect
    import torch
    from fr_tpu_torch.utils.profiling import HEAD_RANGE

    cpu = torch.autograd.DeviceType.CPU
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == cpu and e.name.startswith(HEAD_RANGE))
    check(len(spans) == 4 * steps, f"[profile] {len(spans)} {HEAD_RANGE}* "
          f"ranges over {steps} steps")
    starts = [a for a, _, _ in spans]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    found = sum(k.id in launched for k in kernels)
    check(found >= 0.99 * len(kernels), f"[profile] only {found} of "
          f"{len(kernels)} device events have their launch call in the "
          f"trace")
    out = {}
    for k in kernels:
        t = launched.get(k.id)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            name = spans[i][2][len(HEAD_RANGE):]
            out[name] = out.get(name, 0.0) + (
                k.time_range.end - k.time_range.start) / 1e3 / steps
    return out


def phase_profile(network, warmup: int = 3, steps: int = 5, conf=None):
    """torch.profiler over ``steps`` training steps after ``warmup`` (b=128,
    bf16, the full ms1m_arcface_122 head at sample_rate 0.3, use_fused
    off): wall per step (host clock, synchronised), device busy (the union
    of the kernels' intervals), idle share, kernel launches per step and
    device time by family, and the head's share: the device time of the
    kernels launched inside the step's ``pfc_head:*`` ranges. ``conf``
    replaces the network's ms1m configuration (the webface42m step).
    Returns the head's device ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fr_tpu_torch.cli.main import build_conf, parse_args
    from fr_tpu_torch.train.task import FaceRecognitionTask
    from fr_tpu_torch.utils.profiling import HEAD_RANGE, device_events
    from fr_tpu_torch.utils.profiling import busy_ms as union_ms

    if conf is None:
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
    events = prof.events()
    kernels = device_events(events)
    busy_ms = union_ms(kernels) / steps
    families, by_name = {}, {}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        fam = _family(e.name)
        families[fam] = families.get(fam, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    print(f"[profile] {network} bf16 b={conf.b}, {conf.n_classes:,} classes "
          f"at sample_rate {conf.sample_rate}, sample_block "
          f"{conf.sample_block}: wall {wall:.2f} ms per step "
          f"unprofiled ({conf.b * 1e3 / wall:.1f} imgs/s), device busy "
          f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall:.3f}, "
          f"{len(kernels) / steps:.0f} kernel launches per step")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {network}   {fam:28s} {ms:8.3f} ms/step "
              f"{100 * ms / max(busy_ms, 1e-9):5.1f}%")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile] {network}   top: {ms:8.3f} ms/step "
              f"[{_family(name)}] {name[:90]}")
    head = _head_device_ms(events, kernels, steps)
    head_ms = sum(head.values())
    print(f"[profile] {network}   the head inside the step (kernels launched "
          f"in the step's {HEAD_RANGE}* ranges): {head_ms:.3f} ms/step, "
          f"{100 * head_ms / max(busy_ms, 1e-9):.1f}% of device busy: "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(head.items())))
    del task
    torch.cuda.empty_cache()
    return head_ms


def phase_profile_fused_ce():
    """[profile] of the AlterNet50 step at the full ms1m_arcface_122 head
    (sample_rate 0.3) and of the webface42m step, use_fused on, all three
    margin-CE kernels on the tensor cores: the head's pfc_head:* device
    time. Returns {network: head ms per step}."""
    from fr_tpu_torch.cli.main import build_conf, parse_args
    heads = {}
    for network in ("AlterNet50", "ResNet100"):
        if network == "ResNet100":
            conf = _webface_conf()
        else:
            conf = build_conf(parse_args(_net_args(network, "train")))
            conf.sample_rate = FULL_HEAD_SAMPLE_RATE
        conf.use_fused = True
        print(f"[profile] {network}, use_fused on, the margin-CE kernels on "
              f"the tensor cores")
        heads[network] = phase_profile(network, conf=conf)
    return heads


def phase_stats_profile():
    """[profile] of the AlterNet50 and Swin50 training steps with
    FR_ATTN_STORED_STATS=1, the stats arm on its tensor-core body, beside
    the recompute arm's profiles of the same run ([alternet50_windows],
    phase_profile("Swin50")). The variable is restored."""
    import os
    t0 = time.perf_counter()
    saved = os.environ.get("FR_ATTN_STORED_STATS")
    os.environ["FR_ATTN_STORED_STATS"] = "1"
    try:
        for network in ("AlterNet50", "Swin50"):
            print(f"[profile] {network}: the stats arm "
                  f"(FR_ATTN_STORED_STATS=1)")
            phase_profile(network)
    finally:
        if saved is None:
            os.environ.pop("FR_ATTN_STORED_STATS", None)
        else:
            os.environ["FR_ATTN_STORED_STATS"] = saved
    print(f"[profile] the stats arm's two profiles: "
          f"{time.perf_counter() - t0:.1f} s")


def _family(name):
    n = name.lower()
    for fam, keys in (("port attention kernels", ("window_attn", "window_sum",
                                                  "proj_grad_gemm")),
                      ("port margin-CE kernels", ("margin_ce",)),
                      ("port sparse-row kernels", ("grouped_gather_kernel",
                                                   "grouped_sgd_kernel",
                                                   "grouped_adamw_kernel")),
                      ("port BatchNorm kernels", ("bn_stats_kernel",
                                                  "bn_apply_kernel",
                                                  "bn_bwd_reduce_kernel",
                                                  "bn_bwd_apply_kernel")),
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


def _ce_bound(kind, shape=CE_SHAPE, terms=1):
    """The margin-CE kernels at shape (N, D, K) in bf16: stats reads emb,
    W, labels (int64), col_valid and writes m, d, t; the two gradients also
    read m, d and g and write (N, D) or (K, D) f32. Products: the logits
    (2·N·K·D), and for a gradient also coeff·W or coeffᵀ·emb once per
    coefficient term."""
    n, d, k = shape
    inputs = n * d * 2 + k * d * 2 + n * 8 + k
    nbytes = {"margin_ce_stats": inputs + 3 * n * 4,
              "margin_ce_grad_emb": inputs + 3 * n * 4 + n * d * 4,
              "margin_ce_grad_w": inputs + 3 * n * 4 + k * d * 4}[kind]
    flops = (2 if kind == "margin_ce_stats" else 2 + 2 * terms) * n * k * d
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


# ---------------------------------------------------------------------------
# [multi_gpu]: the mesh path. (a) the CLI under torchrun at world size 1 over
# NCCL against the CLI without it; (b) two ranks of a (1, 2) mesh on this one
# card over gloo, each a FaceRecognitionTask of webface42m at full width,
# against a one-process step fed the union of their groups, and each rank's
# stripe of a card-resident corpus against fr_tpu's draw. The ranks are
# this script again, run with a private first argument (RECORDED_CLI,
# MESH_RANK); they load the kernels the parent built.
# ---------------------------------------------------------------------------

RECORDED_CLI, MESH_RANK = "--recorded-cli", "--mesh-rank"
MULTI_GPU_ARGS = ["--config", "webface42m", "--mode", "train", "--network",
                  "ResNet100", "--sample_rate", "0.1", "--sample_block",
                  str(WEBFACE_BLOCK), "--synthetic", "--num_epoch", "6",
                  "--device", "cuda"]
MESH_B, MESH_STEPS = 128, 3         # global batch, steps of each rank
MESH_CLASSES_LOCAL = 1030016        # 2,060,032 padded rows over 2 shards
# (b)'s striped corpus: 515 rows (two ranks leave one out) of 112 px, 19 MB
STRIPE_N, STRIPE_SEED, STRIPE_EPOCHS = 515, 21, 2


def _recorded_cli(argv):
    """(task, the groups each step drew, each step's loss) of the training
    CLI's main(argv), cuDNN held to its deterministic algorithms."""
    import torch
    import fr_tpu_torch.train.step as step_module
    from fr_tpu_torch.cli.main import main as cli_main
    from fr_tpu_torch.train.task import FaceRecognitionTask

    draws, losses = [], []
    sample_groups = step_module.sample_groups
    training_step = FaceRecognitionTask.training_step

    def drawing(*args, **kwargs):
        gidx = sample_groups(*args, **kwargs)
        draws.append(gidx.tolist())
        return gidx

    def stepping(self, batch):
        out = training_step(self, batch)
        losses.append(out["loss"].item())
        return out

    saved = torch.backends.cudnn.deterministic
    step_module.sample_groups = drawing
    FaceRecognitionTask.training_step = stepping
    torch.backends.cudnn.deterministic = True
    try:
        task = cli_main(argv)
    finally:
        step_module.sample_groups = sample_groups
        FaceRecognitionTask.training_step = training_step
        torch.backends.cudnn.deterministic = saved
    return task, draws, losses


def _recorded_cli_child(out, argv):
    """The torchrun child of [multi_gpu] (a): the recorded CLI, its record
    written to ``out`` as JSON."""
    _, draws, losses = _recorded_cli(argv)
    Path(out).write_text(json.dumps({"draws": draws, "losses": losses}))


def _multi_gpu_cli(root):
    """(a) the training CLI under torchrun, one process over NCCL at mesh
    (1, 1), against the same command without --distributed in this
    process: the same groups drawn at every step (--synthetic's 128
    classes are 2 groups of 64, 1 drawn, so this check is weak; the
    losses are the strong one), losses within 1e-5 relative, a finite
    loss and the snapshot in each."""
    t0 = time.perf_counter()
    _, draws, losses = _recorded_cli(MULTI_GPU_ARGS + [
        "--save_root", str(root / "one")])
    record = root / "torchrun.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", str(ROOT / "chip_smoke.py"),
           RECORDED_CLI, str(record), "--distributed", "--mesh_data", "1",
           "--mesh_model", "1"] + MULTI_GPU_ARGS + [
               "--save_root", str(root / "torchrun")]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"[multi_gpu] torchrun exited "
          f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    run = json.loads(record.read_text())
    steps = len(losses)
    check(steps == 6 * 8 and len(run["losses"]) == steps
          and all(x == x and abs(x) != float("inf")
                  for x in losses + run["losses"]),
          f"[multi_gpu] (a) losses: {steps} and {len(run['losses'])}")
    check(run["draws"] == draws and len(draws) == steps,
          "[multi_gpu] (a) the torchrun run drew other groups")
    rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], losses))
    check(rel <= 1e-5, f"[multi_gpu] (a) losses part by {rel:.2e}")
    for name in ("one", "torchrun"):
        check(len(list((root / name).glob("*/5_epoch_encoder.npz"))) == 1
              and len(list((root / name).glob("*/state/5.pt"))) == 1,
              f"[multi_gpu] (a) no epoch-5 snapshot in the {name} run")
    print(f"[multi_gpu] (a) the training CLI, webface42m ResNet100 bf16 "
          f"b=128 on 1,024 synthetic images ({steps} steps), under torchrun "
          f"over NCCL at mesh (1, 1) against no --distributed: the same "
          f"{len(draws[0])} group(s) of 2 drawn at all {steps} steps, losses "
          f"within {rel:.2e} relative (last {run['losses'][-1]:.4f}), both "
          f"snapshots written; {time.perf_counter() - t0:.1f} s")


def _mesh_batches(conf, seed=13):
    """Step 1: 64 float images and their labels (rank 0 takes them as
    they are, rank 1 in reverse order: see _mesh_rank_child); steps 2-3:
    128 uint8 images and labels, each rank its half."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    size = conf.img_size
    first = torch.randn((MESH_B // 2, size, size, 3), device="cuda",
                        generator=gen)
    labels = torch.randint(0, conf.n_classes, (MESH_B // 2,), device="cuda",
                           generator=gen)
    rest = [(torch.randint(0, 256, (MESH_B, size, size, 3), device="cuda",
                           dtype=torch.uint8, generator=gen),
             torch.randint(0, conf.n_classes, (MESH_B,), device="cuda",
                           generator=gen))
            for _ in range(MESH_STEPS - 1)]
    return first, labels, rest


def _mesh_conf():
    conf = _webface_conf()
    conf.use_fused = True
    return conf


def _encoder_digest(encoder):
    """sha256 of the encoder's parameters' and buffers' bytes."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in encoder.state_dict().values():
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def _stripe_corpus():
    """(images, labels) of (b)'s striped corpus, from a numpy seed."""
    import numpy as np
    rng = np.random.default_rng(STRIPE_SEED)
    return (rng.integers(0, 256, (STRIPE_N, 112, 112, 3), dtype=np.uint8),
            rng.integers(0, 1000, STRIPE_N).astype(np.int32))


def _sha(array) -> str:
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def _stripe_record(rank):
    """This rank's stripe of the corpus on cuda:0 at process_count 2: the
    resident rows' count and digest, and each step's image digest and
    labels, for STRIPE_EPOCHS epochs."""
    import torch
    from fr_tpu_torch.data import DeviceCorpusLoader
    t0 = time.perf_counter()
    images, labels = _stripe_corpus()
    loader = DeviceCorpusLoader(images, labels, MESH_B, seed=STRIPE_SEED,
                                device="cuda", process_index=rank,
                                process_count=2)
    rec = {"rows": loader.images.shape[0], "device": str(
        loader.images.device), "resident": _sha(loader.images.cpu().numpy()),
        "steps": [[(_sha(x.cpu().numpy()), y.tolist())
                   for x, y in loader.epoch(e)]
                  for e in range(STRIPE_EPOCHS)]}
    torch.cuda.synchronize()
    rec["s"] = time.perf_counter() - t0
    return rec


def _check_stripes(recs):
    """fr_tpu's draw (fr_tpu/data/device_corpus.py) recomputed with numpy
    against each rank's stripe record; returns the readings' text."""
    import numpy as np
    images, labels = _stripe_corpus()
    n_loc, b_loc = STRIPE_N // 2, MESH_B // 2
    steps = n_loc // b_loc
    for r, rec in enumerate(recs):
        block = slice(r * n_loc, (r + 1) * n_loc)
        check(rec["rows"] == n_loc and rec["resident"] == _sha(images[block])
              and rec["device"] == "cuda:0",
              f"[multi_gpu] (b) rank {r} holds {rec['rows']} rows on "
              f"{rec['device']}, not block {r}'s {n_loc} rows")
    for e in range(STRIPE_EPOCHS):
        perms = [np.random.default_rng((STRIPE_SEED, e, r)).permutation(
            n_loc) + r * n_loc for r in range(2)]
        for r, rec in enumerate(recs):
            check(len(rec["steps"][e]) == steps,
                  f"[multi_gpu] (b) rank {r} took {len(rec['steps'][e])} "
                  f"steps of epoch {e}, not {steps}")
        for s in range(steps):
            rows = [p[s * b_loc:(s + 1) * b_loc] for p in perms]
            want = np.concatenate([labels[x] for x in rows]).tolist()
            for r, rec in enumerate(recs):
                digest, got = rec["steps"][e][s]
                check(digest == _sha(images[rows[r]]),
                      f"[multi_gpu] (b) rank {r}'s images of epoch {e} "
                      f"step {s} are not fr_tpu's rows")
                check(got == want, f"[multi_gpu] (b) rank {r}'s labels of "
                      f"epoch {e} step {s} are not fr_tpu's")
    return (f"{STRIPE_N} images of 112 px over 2 ranks, {n_loc} rows "
            f"resident on each ({n_loc * 112 * 112 * 3 / 1e6:.1f} MB), "
            f"{b_loc} local images and {MESH_B} labels a step, "
            f"{STRIPE_EPOCHS} x {steps} steps; every batch bitwise fr_tpu's "
            f"rows, labels equal on both ranks and fr_tpu's; "
            f"{[round(rec['s'], 2) for rec in recs]} s by rank")


def _mesh_rank_child(rank, store, out):
    """(b) one rank of the (1, 2) mesh on cuda:0 over gloo; its record
    (its stripe of the corpus, losses, grad norms, encoder digests,
    launches, times, the step-1 drawn groups and their updated rows) saved
    to ``out``."""
    import torch
    import torch.distributed as dist
    import fr_tpu_torch.train.step as step_module
    from fr_tpu_torch.ops import fused_pfc as F
    from fr_tpu_torch.ops import sparse_rows as R
    from fr_tpu_torch.parallel.mesh import make_mesh
    from fr_tpu_torch.train.step import make_train_step
    from fr_tpu_torch.train.task import FaceRecognitionTask

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        # gloo takes CUDA tensors for the three calls the port makes
        x = torch.full((2, 3), float(rank + 1), device="cuda")
        gathered = torch.empty((4, 3), device="cuda")
        dist.all_gather_into_tensor(gathered, x)
        scattered = torch.empty((2, 3), device="cuda")
        dist.reduce_scatter_tensor(scattered, torch.arange(
            12., device="cuda").view(4, 3) * (rank + 1))
        total, top = x.clone(), x.clone()
        dist.all_reduce(total)
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        check(gathered[:, 0].tolist() == [1, 1, 2, 2]
              and scattered.view(-1).tolist() == [3 * (6 * rank + i)
                                                  for i in range(6)]
              and total.eq(3).all() and top.eq(2).all(),
              f"[multi_gpu] gloo on CUDA tensors: {gathered.tolist()}, "
              f"{scattered.tolist()}")
        stripe = _stripe_record(rank)
        mesh = make_mesh(1, 2)
        conf = _mesh_conf()
        t0 = time.perf_counter()
        task = FaceRecognitionTask(conf, stage="train", device="cuda",
                                   seed=0, mesh=mesh)
        cfg = task.pfc_cfg
        check((cfg.num_local, cfg.num_sample_groups, cfg.num_sample)
              == (MESH_CLASSES_LOCAL, 1609, 102976),
              f"[multi_gpu] shard {cfg.num_local} rows, "
              f"{cfg.num_sample_groups} groups")
        plain_step = make_train_step(conf, cfg, "cuda", None, mesh)
        first, labels, rest = _mesh_batches(conf)
        kernels = (F.margin_ce_stats, F.margin_ce_grad_emb,
                   F.margin_ce_grad_w, R.grouped_gather,
                   R.grouped_update_sgd)
        for k in kernels:
            k.launches = 0
        _reset_ce_routes()
        drawn = []
        sample_groups = step_module.sample_groups

        def drawing(*args, **kwargs):
            drawn.append(sample_groups(*args, **kwargs))
            return drawn[-1]

        step_module.sample_groups = drawing
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        built = time.perf_counter() - t0
        w0 = task.state.pfc.weight.clone()
        lr = task.schedule(0)
        rec = {"losses": [], "norms": [], "digests": [], "ms": []}

        def record(m, t):
            rec["losses"].append(m["loss"].item())
            if "grad_norm" in m:   # the step's own; the task's has none
                rec["norms"].append(float(m["grad_norm"]))
            rec["ms"].append((time.perf_counter() - t) * 1e3)
            rec["digests"].append(_encoder_digest(task.state.encoder))

        # step 1: rank 1 takes rank 0's images reversed, with the labels
        # reversed alike, so that a row order or label slice gone wrong
        # shows; _multi_gpu_mesh holds it against one process's steps on
        # each rank's images
        t = time.perf_counter()
        record(plain_step(task.state, first if rank == 0 else first.flip(0),
                          torch.cat([labels, labels.flip(0)]), lr), t)
        gidx = drawn[0]
        block = cfg.sample_block
        moved = (task.state.pfc.slots["momentum"] != 0).any(dim=1).view(
            -1, block)
        stayed = (task.state.pfc.weight != w0).any(dim=1).view(-1, block)
        picked = torch.zeros(moved.shape[0], dtype=torch.bool,
                             device="cuda")
        picked[gidx] = True
        check(bool((moved.all(dim=1) == picked).all())
              and not bool(moved[~picked].any())
              and not bool(stayed[~picked].any()),
              f"[multi_gpu] rank {rank}: rows outside the drawn groups "
              f"changed")
        torch.save({"gidx": gidx.cpu(), "grad": _group_grad(
            task.state, w0, gidx, conf.wd).cpu()}, f"{out}.grad")
        del w0, moved, stayed
        for images, labs in rest:
            t = time.perf_counter()
            local = images[rank * MESH_B // 2:(rank + 1) * MESH_B // 2]
            record(task.training_step((local, labs)), t)
        step_module.sample_groups = sample_groups
        rec.update(launches=[k.launches for k in kernels],
                   tensor_cores=_ce_launches(True),
                   cuda_cores=_ce_launches(False),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   built_s=built, rank=rank, stripe=stripe)
        Path(out).write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def _group_grad(state, w0, gidx, wd):
    """The step-1 SGD gradient of the head rows of groups ``gidx``: the
    momentum then holds g + wd·w0 on the drawn rows and 0 elsewhere."""
    groups = (-1, WEBFACE_BLOCK, w0.shape[1])
    mom = state.pfc.slots["momentum"].view(groups)[gidx]
    return mom - wd * w0.view(groups)[gidx]


def _mesh_reference(conf, images, labels, union):
    """(loss, the encoder's gradient as one f32 vector, the gradient of the
    union's groups' head rows) of the one-process step 1 on ``images`` and
    ``labels``, fed the groups ``union``, from the (1, 2) mesh's initial
    state: its head is the first num_classes_padded rows of the two shards'
    table."""
    import torch
    import fr_tpu_torch.train.step as step_module
    from fr_tpu_torch.train.task import FaceRecognitionTask, \
        pfc_config_from_conf

    task = FaceRecognitionTask(conf, stage="train", device="cuda", seed=0)
    cfg = task.pfc_cfg
    whole = pfc_config_from_conf(conf, 2).num_classes_padded
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = 0.01 * torch.randn((whole, cfg.embedding_size), generator=gen,
                               device="cuda")
    task.state.pfc.weight = table[:cfg.num_classes_padded].clone()
    w0 = task.state.pfc.weight.clone()
    del table
    grads = []
    clip = step_module.clip_by_global_norm

    def clipping(g, max_norm):  # the encoder's gradient before the clip
        grads.append(torch.cat([x.float().reshape(-1) for x in g]))
        return clip(g, max_norm)

    step_module.clip_by_global_norm = clipping
    try:
        m = step_module.make_train_step(conf, cfg, "cuda")(
            task.state, images, labels, task.schedule(0), sample_gidx=union)
    finally:
        step_module.clip_by_global_norm = clip
    return (m["loss"].item(), grads[0],
            _group_grad(task.state, w0, union, conf.wd))


def _multi_gpu_mesh(root):
    """(b) two ranks on this card: see _mesh_rank_child, then one process's
    steps on each rank's step-1 images fed the union of their groups."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    store = root / "store"
    outs = [root / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               MESH_RANK, str(r), str(store), str(outs[r])],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"[multi_gpu] rank {r} exited "
              f"{p.returncode}:\n{log[-4000:]}")
    recs = [json.loads(o.read_text()) for o in outs]
    ranks_s = time.perf_counter() - t0
    for r, rec in enumerate(recs):
        check(rec["launches"] == [MESH_STEPS] * 5
              and rec["tensor_cores"] == [MESH_STEPS] * 3
              and rec["cuda_cores"] == [0] * 3,
              f"[multi_gpu] rank {r} launches {rec['launches']}, on the "
              f"tensor cores {rec['tensor_cores']}, CUDA cores "
              f"{rec['cuda_cores']}")
        check(all(x == x and abs(x) != float("inf") for x in rec["losses"]),
              f"[multi_gpu] rank {r} losses {rec['losses']}")
    t_stripe = time.perf_counter()
    stripes = _check_stripes([rec["stripe"] for rec in recs])
    print(f"[multi_gpu] (b) the card-resident corpus striped: {stripes}; "
          f"checked in {time.perf_counter() - t_stripe:.2f} s")
    check(recs[0]["digests"] == recs[1]["digests"],
          "[multi_gpu] the ranks' encoders differ after a step")
    check(recs[0]["losses"] == recs[1]["losses"]
          and recs[0]["norms"] == recs[1]["norms"],
          "[multi_gpu] the ranks report different losses")
    conf = _mesh_conf()
    first, labels, _ = _mesh_batches(conf)
    shards = [torch.load(f"{o}.grad", weights_only=True) for o in outs]
    ng = MESH_CLASSES_LOCAL // WEBFACE_BLOCK
    union = torch.cat([shards[0]["gidx"], shards[1]["gidx"] + ng]).cuda()
    # the mesh's step-1 loss and gradients are the means of one process's
    # on each rank's 64 images (each rank's forward, bit for bit, and the
    # head columns of the union): the reference is their mean, and how far
    # the two halves part is the batch order's own effect in bf16
    (loss_a, enc_a, grad_a), (loss_b, enc_b, grad_b) = (
        _mesh_reference(conf, x, y, union)
        for x, y in ((first, labels), (first.flip(0), labels.flip(0))))
    loss, grad = (loss_a + loss_b) / 2, (grad_a + grad_b) / 2
    norm = float(torch.linalg.norm((enc_a + enc_b) / 2))
    order = {"loss": abs(loss_a - loss_b) / abs(loss_a),
             "grad_norm": float(torch.linalg.norm(enc_a - enc_b)
                                / torch.linalg.norm(enc_a)),
             "rows": float(torch.linalg.norm(grad_a - grad_b)
                           / torch.linalg.norm(grad_a))}
    del enc_a, enc_b, grad_a, grad_b
    errs = {"loss": abs(recs[0]["losses"][0] - loss) / abs(loss),
            "grad_norm": abs(recs[0]["norms"][0] - norm) / abs(norm)}
    start = 0
    for r, s in enumerate(shards):
        ref = grad[start:start + len(s["gidx"])]
        start += len(s["gidx"])
        errs[f"rows{r}"] = float(torch.linalg.norm(s["grad"].cuda() - ref)
                                 / torch.linalg.norm(ref))
    # rows 10 and 11 return their gradients in bf16, the operands' dtype:
    # the mesh rounds the sum of both halves once, the reference each half,
    # so the head rows part by bf16's own rounding (about 2e-3 norm-wise)
    check(errs["loss"] <= 1e-5 and errs["grad_norm"] <= 1e-3
          and errs["rows0"] <= 5e-3 and errs["rows1"] <= 5e-3,
          f"[multi_gpu] (b) step 1 against one process: {errs}; the two "
          f"one-process steps part by {order}")
    print(f"[multi_gpu] (b) webface42m ResNet100 bf16 use_fused, mesh "
          f"(1, 2) as two ranks on this card over gloo, global b={MESH_B} "
          f"(64 a rank), each rank {MESH_CLASSES_LOCAL:,} x 512 head rows "
          f"and {len(shards[0]['gidx']):,} groups drawn a step: rows 9-13 "
          f"launched once per step per rank (rows 9-11 on the tensor "
          f"cores), only drawn rows changed, encoders bitwise equal after "
          f"every step; step 1, rank 1 taking rank 0's images reversed, "
          f"against the mean of one process's steps on each rank's images "
          f"fed the union of the shards' groups: "
          f"loss {errs['loss']:.2e}, grad_norm {errs['grad_norm']:.2e}, "
          f"each shard's head-row gradient {errs['rows0']:.2e} and "
          f"{errs['rows1']:.2e} (norm-wise); the two one-process steps "
          f"part by {order['loss']:.2e} (loss), {order['grad_norm']:.2e} "
          f"(encoder gradient) and {order['rows']:.2e} (head rows), "
          f"the batch order's effect in bf16; losses {recs[0]['losses']}; "
          f"ms per step by rank (host clock, the gradients summed over the "
          f"host by gloo) {[[round(x, 1) for x in r['ms']] for r in recs]}; "
          f"peak memory by rank {[round(r['peak_gb'], 2) for r in recs]} "
          f"GB; ranks ready after {[round(r['built_s'], 1) for r in recs]} "
          f"s; {ranks_s:.1f} s for the ranks, "
          f"{time.perf_counter() - t0:.1f} s in all")


def phase_multi_gpu():
    """[multi_gpu] (a) and (b)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "cli").mkdir()
        _multi_gpu_cli(Path(tmp) / "cli")
        _multi_gpu_mesh(Path(tmp))
    print(f"[multi_gpu] {time.perf_counter() - t0:.1f} s")


def _entry(name, source, line, launches, err, ms, plain_ms, bound, lib):
    return {"name": name, "route": "cuda",
            "source": f"fr_tpu_torch/csrc/{source}",
            "replaces": f"fr_tpu/ops/{line}", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}


def main() -> None:
    import torch
    check(torch.cuda.is_available(), "torch finds no CUDA device")
    for path in (GOLDEN, TRAIN_GOLDEN, SWIN_TRAIN_GOLDEN, *NET_GOLDENS,
                 R100_GOLDEN, R100_TRAIN_GOLDEN, *VARIANT_GOLDENS.values()):
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
    worst_rows, times_rows, bounds_rows = phase_kernel_sparse_rows()
    times_bn = phase_kernel_batch_norm()
    times_ga, launches_ga = phase_kernel_global_attn()
    errs_v, times_v, launches_grouped = phase_kernel_variants()
    # each main path runs with its counts set to 0 just before it
    launches_fwd, _, bn_main = phase_main_path()
    phase_throughput()
    phase_golden()
    _, launches_bwd, _, bn_train = phase_train()
    launches_ce = phase_train_full_head()
    phase_train_golden()
    packed_stats = phase_stats_switch("AlterNet50")
    launches_routes, _ = phase_alternet50_routes()
    perhead = {"fwd": 0, "bwd": 0}
    perhead_stats = [0, 0]
    for network in ("Swin50", "EffiAlter_m"):
        counts, stats = phase_network(network)
        perhead["fwd"] += counts["serve"] + counts["train_fwd"]
        perhead["bwd"] += counts["train_bwd"]
        perhead_stats = [a + b for a, b in zip(perhead_stats, stats)]
    phase_swin50_train_golden()
    phase_alternet_sep50()
    phase_alternet_v1_50()
    phase_dw_taps()
    bn_resnet100 = phase_resnet100()
    launches_rows, launches_ce_webface, bn_webface = phase_webface42m()
    phase_resnet100_train_golden()
    phase_resume()
    phase_multi_gpu()
    with tempfile.TemporaryDirectory() as data_root:
        phase_data(data_root)
    with tempfile.TemporaryDirectory() as tools_root:
        phase_tools(tools_root)
        phase_profile_cli(tools_root)
    phase_bench()
    for network in ("Swin50", "EffiAlter_m"):
        phase_profile(network)
    phase_stats_profile()
    head_block = phase_profile("ResNet100", conf=_webface_conf())
    head_row = phase_profile("ResNet100", conf=_webface_conf(sample_block=1))
    print(f"[profile] ResNet100 webface42m, the head inside the step at "
          f"sample_block {WEBFACE_BLOCK} against 1: {head_block:.3f} vs "
          f"{head_row:.3f} ms of device time per step "
          f"({head_row / head_block:.2f}x)")
    head_fused = phase_profile_fused_ce()

    fwd = _mix(times_fwd, torch.bfloat16)
    bwd = _mix(times_bwd, torch.bfloat16)
    stats = {k: (sum(times_st[name][k] * (n_unmasked + n_masked)
                     for name, *_, n_unmasked, n_masked in SHAPES),
                 _perhead_mix(times_st, k))
             for k in ("fwd", "fwd_lib", "fwd_recompute", "bwd", "bwd_lib",
                       "bwd_recompute")}
    print("[summary] the stats pair, bf16, tensor cores against SDPA and "
          "the recompute kernel (rows 1/2, 5/6): "
          + "; ".join(f"row {row} {stats[kind][i]:.4f} vs sdpa "
                      f"{stats[kind + '_lib'][i]:.4f}, recompute "
                      f"{stats[kind + '_recompute'][i]:.4f} ms"
                      for row, kind, i in ((3, "fwd", 0), (4, "bwd", 0),
                                           (7, "fwd", 1), (8, "bwd", 1))))
    qkv = {k: sum(count * times_v["qkv"][(name, masked)][k]
                  for name, *_, n_unmasked, n_masked in SHAPES
                  for masked, count in ((False, n_unmasked),
                                        (True, n_masked)))
           for k in ("fwd", "fwd_chain")}
    print(f"[summary] row 18, bf16, the 12 AlterNet50 sites of one call: "
          f"tensor cores {qkv['fwd']:.4f} ms against F.linear + row 1 "
          f"{qkv['fwd_chain']:.4f}")
    qkv = {k: sum(count * times_v["qkv"][(name, masked)][k]
                  for name, *_, n_unmasked, n_masked in SHAPES
                  for masked, count in ((False, n_unmasked),
                                        (True, n_masked)))
           for k in ("bwd", "bwd_hybrid", "bwd_attend", "bwd_dx",
                     "bwd_dw", "bwd_sums", "bwd_other")}
    print(f"[summary] row 18b, bf16, the 12 AlterNet50 sites of one call: "
          f"tensor cores {qkv['bwd']:.4f} ms (by part: attend "
          f"{qkv['bwd_attend']:.4f}, dx {qkv['bwd_dx']:.4f}, dW "
          f"{qkv['bwd_dw']:.4f}, sums {qkv['bwd_sums']:.4f}, other "
          f"{qkv['bwd_other']:.4f}) against the hybrid backward "
          f"{qkv['bwd_hybrid']:.4f}")
    attn = "fused_window_attn.py"
    # rows 1, 2, 5, 6, 15-17b: the bf16 bodies on the tensor cores
    # (window_attn_tc.cuh; entries in window_attn_fwd.cu, _bwd.cu and
    # _spatial.cu); the main paths' launches all took them (_check_routes)
    kernels = [
        _entry("window_attn_fwd_tc (packed entry, row 1)",
               "window_attn_tc.cuh", f"{attn}:1572", launches_fwd,
               worst_fwd, fwd["ms"], fwd["plain_ms"], _packed_bound("fwd"),
               fwd["library_ms"]),
        _entry("window_attn_bwd_tc (packed entry, row 2)",
               "window_attn_tc.cuh", f"{attn}:1717", launches_bwd,
               worst_bwd, bwd["ms"], bwd["plain_ms"], _packed_bound("bwd"),
               bwd["library_ms"])]
    # rows 9-11 at the ms1m head on the tensor cores, launches from
    # [train_full_head]: the stats and the two-term pair from its
    # plain_kernels arm (the main path), the one-term pair from its fused
    # arm; the two-term pair replaces fr_tpu's plain CE and its autodiff
    for kernel, line, row, terms in (
            ("margin_ce_stats", "ops/fused_pfc.py:308", 9, 1),
            ("margin_ce_grad_emb", "ops/fused_pfc.py:406", 10, 1),
            ("margin_ce_grad_w", "ops/fused_pfc.py:425", 11, 1),
            ("margin_ce_grad_emb", "heads/partial_fc.py:211", 10, 2),
            ("margin_ce_grad_w", "heads/partial_fc.py:211", 11, 2)):
        name = kernel + ("_tc_2term" if terms == 2 else "_tc")
        t = times_ce[(kernel + ("_2term" if terms == 2 else ""),
                      CE_SHAPE[2])]
        entry = _entry(f"{name} (row {row}" + (
            ", two coefficient terms)" if terms == 2 else ")"),
            "margin_ce.cu", "", launches_ce[name], worst_ce[name], t["ms"],
            t["plain_ms"], _ce_bound(kernel, terms=terms), None)
        entry["replaces"] = f"fr_tpu/{line}"
        kernels.append(entry)
    for kind, line, count, err, row in (
            ("fwd", 1909, perhead["fwd"], worst_ph_f, 5),
            ("bwd", 2002, perhead["bwd"], worst_ph_b, 6)):
        kernels.append(_entry(
            f"window_attn_{kind}_tc (per-head entry, row {row})",
            "window_attn_tc.cuh", f"{attn}:{line}",
            count, err, _perhead_mix(times_ph, kind),
            _perhead_mix(times_ph, f"{kind}_plain"), _perhead_bound(kind),
            _perhead_mix(times_ph, f"{kind}_lib")))
    stats_mix = {k: _perhead_mix(times_st, k) for k in times_st[
        PERHEAD_SHAPES[0][0]]}
    packed_mix = {k: sum(times_st[name][k] * (n_unmasked + n_masked)
                         for name, *_, n_unmasked, n_masked in SHAPES)
                  for k in stats_mix}
    # rows 3-4, 7-8 on the tensor cores (the models' bf16 path under
    # FR_ATTN_STORED_STATS=1), launches from the stats switch's stats arm
    for kind, i, errs in (("fwd", 0, worst_st_f), ("bwd", 1, worst_st_b)):
        for entry, lines, counts, mix, bound, rows in (
                ("per-head", (731, 790), perhead_stats, stats_mix,
                 _perhead_bound(f"{kind}_stats"), (7, 8)),
                ("packed", (1298, 1367), packed_stats, packed_mix,
                 _packed_bound(f"{kind}_stats"), (3, 4))):
            kernels.append(_entry(
                f"window_attn_{kind}_stats_tc ({entry} entry, row "
                f"{rows[i]})", "window_attn_stats.cu", f"{attn}:{lines[i]}",
                counts[i], errs["tensor_cores"], mix[kind],
                mix[f"{kind}_plain"], bound, mix[f"{kind}_lib"]))
    for (name, line), count in zip(
            (("grouped_gather", 70), ("grouped_update_sgd", 99),
             ("grouped_update_adamw", 151)), launches_rows):
        ms, plain_ms, lib = times_rows[name]
        kernels.append(_entry(name, "sparse_rows.cu",
                              f"sparse_rows.py:{line}", count,
                              worst_rows[name], ms, plain_ms,
                              bounds_rows[name], lib))
    # the BatchNorm kernels replace no TPU kernel (flax's BatchNorm is XLA's
    # there); each shape's launches are those of its network's main paths:
    # IR-ResNet100's [resnet100] serving and [webface42m] training,
    # AlterNet50's [main] serving and [train] CLI
    bn_launches = {
        net: {k: sum(run[k] for run in runs) for k in runs[0]}
        for net, runs in (("IR-ResNet100", (bn_resnet100, bn_webface)),
                          ("AlterNet50", (bn_main, bn_train)))}
    for kind, label, entry in (
            ("fwd", "bn_stats + bn_apply", "bn_forward"),
            ("bwd", "bn_bwd_reduce + bn_bwd_apply", "bn_backward"),
            ("eval", "bn_eval", "bn_eval")):
        for tag in BN_SHAPES:
            ms, plain_ms, lib_ms, bound, err = times_bn[(tag, kind)]
            kernels.append({
                "name": f"{label} (BatchNorm, {tag})",
                "route": "cuda", "source": "fr_tpu_torch/csrc/batch_norm.cu",
                "replaces": None,
                "launches": bn_launches[tag.split()[0]][entry],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms})
    # the global-attention kernels replace no TPU kernel (fr_tpu has no
    # ViT); launches from [kernel_global_attn]'s ViT-L training step
    for kind in ("fwd", "bwd"):
        ms, plain_ms, lib_ms, bound, by, err = times_ga[kind]
        kernels.append({
            "name": f"global_attn_{kind} (ViT-L global attention, G1)",
            "route": "cuda", "source": "fr_tpu_torch/csrc/global_attn.cu",
            "replaces": None, "launches": launches_ga[kind],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
    kernels += _variant_entries(errs_v, times_v,
                                dict(launches_routes, grouped=launches_grouped))
    check(all(c > 0 for c in launches_ce_webface.values()),
          f"[webface42m] margin-CE launches {launches_ce_webface}")
    print("[summary] the head inside the step, use_fused on, the margin-CE "
          "kernels on the tensor cores (ms of device time per step): "
          + "; ".join(f"{net} {head_fused[net]:.3f}"
                      for net in ("AlterNet50", "ResNet100"))
          + f"; ResNet100 with use_fused off {head_block:.3f}")
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
    if sys.argv[1:2] == [RECORDED_CLI]:
        _recorded_cli_child(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == [MESH_RANK]:
        _mesh_rank_child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
