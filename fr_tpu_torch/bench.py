"""Benchmark of the port: the training and embedding throughput matrix of
fr_tpu's bench.py on one CUDA device.

    python -m fr_tpu_torch.bench                 # every row, on the card
    BENCH_ROWS=alternet50,embed_r100 BENCH_REPEATS=3 \
        python -m fr_tpu_torch.bench
    BENCH_MATRIX=0 BENCH_NETWORK=AlterNet50 BENCH_BATCH=128 BENCH_FUSED=1 \
        python -m fr_tpu_torch.bench     # one workload from the variables

The rows and the environment variables that define them are fr_tpu's
(bench.py:49-110), in the same order:

    r100_synthetic   ResNet100 b=256, 86,690 classes at sample_rate 0.3,
                     random float images on the device (the headline)
    alternet50       AlterNet50 b=128 at 192 px: the packed window attention
                     (rows 1/2 of the kernel table)
    swin50           Swin50 b=128: the per-head window attention (rows 5/6)
    effialter_m      EffiAlter_m b=128: the per-head window attention
    webface42m_head  ResNet100 b=256, 2,059,906 classes at sample_rate 0.1,
                     sample_block 64: the grouped sparse-row kernels (rows
                     12/13) on a 2,059,968 × 512 f32 head
    embed_r100       the embedding step (eval-mode ResNet100, L2-normalised)
                     at 256 images
    r100_realdata    r100_synthetic through a packed uint8 corpus of 4,096
                     images resident on the card and the on-device
                     augmentation

BENCH_FUSED=1 turns on the margin-CE kernels (rows 9-11) and
FR_ATTN_STORED_STATS=1 the stored-stats attention (rows 3/4, 7/8); neither
is a default. BENCH_FUSED is one of the workload variables that the matrix
pins for every row, as bench.py does, so its arm runs one workload at a
time (BENCH_MATRIX=0, or BENCH_ROW=<row>, with the row's variables;
``python -m fr_tpu_torch.tools.bench_arms`` runs the arms of a few rows in
turn). Each row runs in its own
subprocess, so the device's memory is
released between rows; BENCH_REPEATS=R walks the row list R times in turn,
and every row reports the median and the spread (max - min) of its repeats.
The aggregate JSON line is printed again after every row run, so a row that
hangs or fails costs that row only.

Each row reports:
- ``value``: images per second on the host clock over BENCH_STEPS steps
  after two warm-up steps, the span closed by a device synchronise;
- ``device_busy_ms``, ``idle_share``, ``launches_per_step``: from a separate
  torch.profiler window of PROFILE_STEPS steps after the timed span (the
  profiler's cost stays out of ``value``); busy is the union of the device
  events' intervals per step, idle the share of ``step_ms`` outside it;
- ``mfu``: 3 (training) or 1 (embedding) × the encoder's forward FLOPs per
  image × ``value`` ÷ the card's peak dense bf16 rate, from
  PEAK_BF16_TFLOPS by device name; a card not in the table gives null and
  the reason;
- ``kernel_launches_per_step``: the port's kernel wrappers' launches over
  the timed span, per step, by body;
- ``final_output``: the last element of the last timed step's output (the
  loss of a training row, an embedding element of the embedding row),
  checked to be finite.

``--device cpu`` (or BENCH_DEVICE=cpu) runs on the CPU, for the tests: no
device metric is measured there. Without it a machine with no CUDA device
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROWS = ("r100_synthetic", "alternet50", "swin50", "effialter_m",
        "webface42m_head", "embed_r100", "r100_realdata")

# Every environment variable that defines what a row measures; _row_env pins
# each of them for every row, so that a variable exported for one row does
# not leak into the others
WORKLOAD_VARS = {
    "BENCH_NETWORK": "ResNet100", "BENCH_BATCH": "256",
    "BENCH_CLASSES": "86690", "BENCH_SAMPLE_RATE": "0.3",
    "BENCH_SAMPLE_BLOCK": "1", "BENCH_PACKED": "", "BENCH_AUGMENT": "0",
    "BENCH_DEVICE_CORPUS": "0", "BENCH_FUSED": "0", "BENCH_MODE": "train",
}

# the synthetic corpus of r100_realdata when BENCH_PACKED names none
PACKED_DEFAULT = os.path.join(tempfile.gettempdir(),
                              "fr_tpu_torch_bench_packed")

# dense bf16 tensor-core peak by torch.cuda.get_device_name: the H100 SXM5
# from NVIDIA's H100 data sheet (at its 700 W limit)
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}

WARMUP_STEPS = 2
PROFILE_STEPS = 3
SUMMARISED = ("value", "step_ms", "device_busy_ms", "idle_share", "mfu")


def _row_env(row: str) -> dict:
    """The full workload pin of each row: WORKLOAD_VARS, overridden by what
    the row is."""
    env = dict(WORKLOAD_VARS)
    if row == "r100_synthetic":
        pass  # the WORKLOAD_VARS defaults are this row
    elif row == "r100_realdata":
        env.update({"BENCH_PACKED": os.environ.get(
                        "BENCH_PACKED", PACKED_DEFAULT),
                    "BENCH_DEVICE_CORPUS": "1"})
    elif row == "alternet50":
        env.update({"BENCH_NETWORK": "AlterNet50", "BENCH_BATCH": "128"})
    elif row == "swin50":
        env.update({"BENCH_NETWORK": "Swin50", "BENCH_BATCH": "128"})
    elif row == "effialter_m":
        env.update({"BENCH_NETWORK": "EffiAlter_m", "BENCH_BATCH": "128"})
    elif row == "embed_r100":
        env.update({"BENCH_MODE": "embed"})
    elif row == "webface42m_head":
        env.update({"BENCH_NETWORK": "ResNet100", "BENCH_BATCH": "256",
                    "BENCH_CLASSES": "2059906", "BENCH_SAMPLE_RATE": "0.1",
                    "BENCH_SAMPLE_BLOCK": os.environ.get(
                        "BENCH_SAMPLE_BLOCK", "64")})
    else:
        raise ValueError(row)
    return env


def ensure_packed_corpus(path: str, n: int = 4096, img_size: int = 112,
                         n_classes: int = 86690) -> str:
    """A synthetic packed corpus (data/packed.py layout) at ``path`` unless
    one is there. Returns "user" for a corpus that was there and that this
    function did not write (a marker file tags the ones it wrote), else
    "synthetic". The corpus is written in ``<path>.partial`` and renamed
    into place whole, so a run cut off while writing leaves no corpus at
    ``path``."""
    images_f = os.path.join(path, "images.npy")
    marker = "SYNTHETIC_BENCH_CORPUS"
    if os.path.exists(images_f):
        return "synthetic" if os.path.exists(os.path.join(path, marker)) \
            else "user"
    print(f"bench: no packed corpus at {path}: generating a synthetic "
          f"{n}-image one (the row is marked corpus=synthetic)",
          file=sys.stderr)
    part = path.rstrip(os.sep) + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    rng = np.random.default_rng(0)
    images = np.lib.format.open_memmap(
        os.path.join(part, "images.npy"), mode="w+", dtype=np.uint8,
        shape=(n, img_size, img_size, 3))
    images[:] = rng.integers(0, 256, images.shape, dtype=np.uint8)
    images.flush()
    del images
    np.save(os.path.join(part, "labels.npy"),
            rng.integers(0, n_classes, n).astype(np.int32))
    with open(os.path.join(part, "classes.json"), "w") as fh:
        json.dump([str(i) for i in range(n_classes)], fh)
    with open(os.path.join(part, marker), "w") as fh:
        fh.write("generated by fr_tpu_torch.bench ensure_packed_corpus\n")
    if os.path.isdir(path) and not os.listdir(path):
        os.rmdir(path)
    os.rename(part, path)
    return "synthetic"


def device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def card_line(device):
    """The card's name and power limit as nvidia-smi gives them; None off
    CUDA."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_counts() -> dict:
    """The port's kernel wrappers' launch counts, by body."""
    from fr_tpu_torch.ops import fused_pfc, fused_window_attn, sparse_rows
    counts = {f"attention_{k}": v
              for k, v in fused_window_attn.route_launches.items()}
    counts.update({f"margin_ce_{k}": v
                   for k, v in fused_pfc.route_launches.items()})
    for fn in (sparse_rows.grouped_gather, sparse_rows.grouped_update_sgd,
               sparse_rows.grouped_update_adamw):
        counts[fn.__name__] = fn.launches
    return counts


def _measure(run_step, steps: int, batch: int, device) -> dict:
    """Warm-up, the timed span (host clock, closed by a synchronise), then
    the profiled window on CUDA. ``run_step()`` runs one step and returns
    a tensor whose last value is checked to be finite."""
    import torch
    for _ in range(WARMUP_STEPS):
        out = run_step()
    _sync(device)
    before = _kernel_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = run_step()
    _sync(device)
    dt = time.perf_counter() - t0
    after = _kernel_counts()
    last = float(out.float().reshape(-1)[-1])
    if not np.isfinite(last):
        raise FloatingPointError(f"non-finite output {last}")
    step_ms = dt * 1e3 / steps
    res = {"value": batch * steps / dt, "unit": "imgs/s", "step_ms": step_ms,
           "steps": steps, "final_output": last,
           "kernel_launches_per_step": {
               k: (after[k] - before[k]) / steps for k in after
               if after[k] != before[k]},
           "device_busy_ms": None, "idle_share": None,
           "launches_per_step": None}
    if device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        from fr_tpu_torch.utils.profiling import busy_ms, device_events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_STEPS):
                run_step()
            torch.cuda.synchronize(device)
        kernels = device_events(prof.events())
        if not kernels:
            raise RuntimeError("the profiler recorded no device event")
        busy = busy_ms(kernels) / PROFILE_STEPS
        res.update(device_busy_ms=busy, idle_share=1.0 - busy / step_ms,
                   launches_per_step=len(kernels) / PROFILE_STEPS)
    return res


def _mfu(conf, value: float, multiplier: float, name: str) -> dict:
    """The whole step's share of the card's peak: the encoder's forward
    FLOPs (utils/flops.py, plain attention) × multiplier × images/s over
    the peak. A failed count or a card not in PEAK_BF16_TFLOPS gives null
    and the reason."""
    out = {"mfu": None, "mfu_note": None, "fwd_flops_per_img": None,
           "flops_multiplier": multiplier,
           "peak_tflops": PEAK_BF16_TFLOPS.get(name)}
    try:
        from fr_tpu_torch.utils.flops import encoder_forward_flops
        out["fwd_flops_per_img"] = encoder_forward_flops(conf, batch=1)
    except Exception:  # the row still reports its times
        out["mfu_note"] = ("FLOP count failed: "
                           + traceback.format_exc(limit=4)[-1500:])
        return out
    if out["peak_tflops"] is None:
        out["mfu_note"] = (f"no peak for device {name!r} in "
                           f"PEAK_BF16_TFLOPS")
        return out
    out["mfu"] = (multiplier * out["fwd_flops_per_img"] * value
                  / (out["peak_tflops"] * 1e12))
    return out


def _conf(network: str):
    from fr_tpu_torch.configs import load_config
    conf = load_config("ms1m_arcface_122", network=network)
    conf.mixed_precision = True
    return conf


def run_embed_workload(device) -> dict:
    """The embedding step of the validation path (eval-mode encoder,
    L2-normalised embeddings) on one batch resident on the device."""
    import torch
    from fr_tpu_torch.models import build_encoder
    from fr_tpu_torch.models.common import init_weights
    from fr_tpu_torch.train.step import make_embed_step

    batch = int(os.environ.get("BENCH_BATCH", "256"))
    network = os.environ.get("BENCH_NETWORK", "ResNet100")
    steps = int(os.environ.get("BENCH_STEPS", "40"))
    conf = _conf(network)
    encoder = init_weights(build_encoder(conf), 0).to(device).eval()
    embed = make_embed_step(conf, encoder, device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, conf.img_size, conf.img_size, 3)).astype(np.float32)
        ).to(device)
    row = {"metric": f"{network} eval embedding throughput (b={batch}, "
                     f"eval-mode BN, L2-normalised, bf16)"}
    row.update(_measure(lambda: embed(x), steps, batch, device))
    row.update(_mfu(conf, row["value"], 1.0, device_name(device)))
    return row


def run_workload(device) -> dict:
    """One row, configured by the environment, on ``device``."""
    from fr_tpu_torch.train.task import resolve_device
    device = resolve_device(device)
    common = {"device_name": device_name(device), "card": card_line(device),
              "use_fused": os.environ.get("BENCH_FUSED", "0") == "1",
              "attn_stored_stats": os.environ.get("FR_ATTN_STORED_STATS",
                                                  "")}
    if os.environ.get("BENCH_MODE", "train") == "embed":
        return {**common, **run_embed_workload(device)}

    import torch
    from fr_tpu_torch.data.augment import augment_cfg_from_conf
    from fr_tpu_torch.models import build_encoder
    from fr_tpu_torch.models.common import init_weights
    from fr_tpu_torch.train.state import init_train_state
    from fr_tpu_torch.train.step import make_train_step, prefetch_to_device
    from fr_tpu_torch.train.task import pfc_config_from_conf

    batch = int(os.environ.get("BENCH_BATCH", "256"))
    n_classes = int(os.environ.get("BENCH_CLASSES", "86690"))
    network = os.environ.get("BENCH_NETWORK", "ResNet100")
    steps = int(os.environ.get("BENCH_STEPS", "20"))
    sample_block = int(os.environ.get("BENCH_SAMPLE_BLOCK", "1"))

    conf = _conf(network)
    conf.n_classes = n_classes
    conf.b = batch
    conf.sample_rate = float(os.environ.get("BENCH_SAMPLE_RATE", "0.3"))
    conf.use_fused = common["use_fused"]
    conf.sample_block = sample_block
    pfc_cfg = pfc_config_from_conf(conf)
    encoder = init_weights(build_encoder(conf), 0)
    state = init_train_state(conf, encoder, pfc_cfg, device, 0)

    # BENCH_AUGMENT=1: uint8 inputs and the on-device augmentation;
    # BENCH_PACKED=<dir>: batches of a packed corpus, streamed through the
    # prefetch, or resident on the device with BENCH_DEVICE_CORPUS=1
    packed_dir = os.environ.get("BENCH_PACKED")
    augment = os.environ.get("BENCH_AUGMENT", "0") == "1" or bool(packed_dir)
    step = make_train_step(conf, pfc_cfg, device,
                           augment_cfg_from_conf(conf) if augment else None)
    resident = os.environ.get("BENCH_DEVICE_CORPUS", "0") == "1"
    rng = np.random.default_rng(0)
    corpus_kind = None
    if packed_dir:
        from fr_tpu_torch.data.device_corpus import DeviceCorpusLoader
        from fr_tpu_torch.data.packed import PackedTrainLoader
        corpus_kind = ensure_packed_corpus(packed_dir, img_size=conf.img_size,
                                           n_classes=n_classes)
        src = PackedTrainLoader(packed_dir, batch)
        loader = (DeviceCorpusLoader(src.images, src.labels % n_classes,
                                     batch, device=device)
                  if resident else src)

        def epochs():
            epoch = 0
            while True:
                for images, labels in loader.epoch(epoch):
                    yield images, labels % n_classes
                epoch += 1

        batches = (epochs() if resident
                   else prefetch_to_device(epochs(), device, 2))
        next_batch = batches.__next__
    else:
        batches = None
        if augment:
            x = rng.integers(0, 256, (batch, conf.img_size, conf.img_size, 3)
                             ).astype(np.uint8)
        else:
            x = rng.standard_normal(
                (batch, conf.img_size, conf.img_size, 3)).astype(np.float32)
        y = rng.integers(0, n_classes, batch).astype(np.int64)
        fixed = (torch.from_numpy(x).to(device),
                 torch.from_numpy(y).to(device))
        next_batch = lambda: fixed  # noqa: E731

    def run_step():
        images, labels = next_batch()
        return step(state, images, labels, 0.05)["loss"]

    tags = ", on-device augment" if augment else ""
    if packed_dir:
        tags += (", device-resident corpus" if resident
                 else ", packed corpus")
    if sample_block > 1:
        tags = f", sample_block={sample_block}" + tags
    row = {"metric": f"{network}+{conf.metric} train throughput (b={batch}, "
                     f"C={n_classes}, r={conf.sample_rate}{tags}, bf16)"}
    try:
        row.update(_measure(run_step, steps, batch, device))
    finally:
        getattr(batches, "close", lambda: None)()
    row.update(_mfu(conf, row["value"], 3.0, common["device_name"]))
    if corpus_kind is not None:
        row["corpus"] = corpus_kind
    return {**common, **row}


def summarise(name: str, runs: list) -> dict:
    """A row's entry: its last good run, with the median of each of
    SUMMARISED over the good runs and its spread (max - min)."""
    good = [r for r in runs if "value" in r]
    if not good:
        return {"row": name, **runs[-1]}
    out = {"row": name, **good[-1], "repeats": len(good)}
    for key in SUMMARISED:
        vals = [r[key] for r in good if r.get(key) is not None]
        out[key] = statistics.median(vals) if vals else None
        out[f"{key}_spread"] = max(vals) - min(vals) if vals else None
    if len(runs) > 1:
        out["runs"] = [{k: r.get(k) for k in ("value", "device_busy_ms",
                                              "idle_share", "mfu")}
                       if "value" in r else {"error": r.get("error")}
                       for r in runs]
    return out


def _aggregate(rows: list) -> dict:
    """The one JSON line over the rows run so far; the headline is
    r100_synthetic, else the first row with a value."""
    head = next((r for r in rows if r["row"] == "r100_synthetic"
                 and "value" in r), None) or \
        next((r for r in rows if "value" in r), None)
    if head is None:
        return {"metric": "bench failed", "value": 0, "unit": "imgs/s",
                "mfu": None, "rows": rows}
    return {"metric": head["metric"], "value": head["value"],
            "unit": head["unit"], "mfu": head["mfu"],
            "step_ms": head["step_ms"], "device_name": head["device_name"],
            "card": head["card"], "rows": rows}


def row_timeout() -> float:
    """Seconds one row's process may take (BENCH_ROW_TIMEOUT)."""
    return float(os.environ.get("BENCH_ROW_TIMEOUT", "900"))


def _run_row(name: str, device: str, timeout: float,
             overrides=None) -> dict:
    """One row in its own process, with the row's variables pinned, then
    ``overrides`` (an arm's variables) on top; returns its row dict."""
    env = dict(os.environ)
    env.update(_row_env(name))
    env.update(overrides or {})
    env.update(BENCH_ROW=name, BENCH_DEVICE=device)
    root = str(Path(__file__).resolve().parents[1])
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    try:
        proc = subprocess.run([sys.executable, "-m", "fr_tpu_torch.bench"],
                              env=env, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"error": f"row timed out after {timeout:.0f}s",
                "returncode": 124}
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        return {"error": (proc.stderr or proc.stdout)[-2000:],
                "returncode": proc.returncode}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the port's throughput matrix")
    p.add_argument("--device", choices=["cuda", "cpu"],
                   default=os.environ.get("BENCH_DEVICE", "cuda"),
                   help="cpu runs for the tests only; cuda raises when "
                        "absent")
    args = p.parse_args(argv)
    from fr_tpu_torch.train.task import resolve_device
    resolve_device(args.device)

    if os.environ.get("BENCH_ROW") or os.environ.get("BENCH_MATRIX",
                                                     "1") == "0":
        print(json.dumps(run_workload(args.device)), flush=True)
        return 0

    names = [r for r in os.environ.get("BENCH_ROWS", ",".join(ROWS)).split(",")
             if r]
    repeats = int(os.environ.get("BENCH_REPEATS", "1"))
    timeout = row_timeout()
    runs = {name: [] for name in names}
    for _ in range(repeats):
        for name in names:
            r = _run_row(name, args.device, timeout)
            runs[name].append(r)
            print(f"# {name}: {json.dumps(r)}", file=sys.stderr, flush=True)
            rows = [summarise(n, runs[n]) for n in names if runs[n]]
            print(json.dumps(_aggregate(rows)), flush=True)
    return 0 if any("value" in r for rs in runs.values() for r in rs) else 1


if __name__ == "__main__":
    sys.exit(main())
