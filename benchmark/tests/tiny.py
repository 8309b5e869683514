"""A copy of the benchmark with small cells added as files only: the way a
later change adds a configuration, a cell or a metric. The small cells
keep the real configurations' kinds and shapes of computation at sizes the
CPU runs in seconds; their limits are set from CPU readings of the program
(bf16) and of the float8 control at these sizes. ``tiny_r18_adamw`` is
``tiny_r18`` trained with AdamW at the learning rate and decay of
insightface's ViT-L recipe on WebFace42M (lr 0.001, weight decay 0.1)."""

from __future__ import annotations

import json
import shutil
import sys
import time
import types
from pathlib import Path
from typing import Optional

import torch

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]

TINY_TRAIN_LIMITS = {"grad1_median_gap": 0.1, "change3_median_gap": 0.15,
                     "head_grad1_diff": 0.12, "last_grad_median_gap": 0.1,
                     "last_head_grad_diff": 0.1}
TINY_EMBED_LIMITS = {"embed_gap": 0.03}
# from CPU readings over 13 seeds (program's largest; control's smallest;
# a step that leaves the state unchanged reads 1, half of the batch left
# out reads 1.5 to 1.8 on both head_grad1_diff and last_head_grad_diff):
# grad1_median_gap 0.0052 / 0.014, change3_median_gap 0.011 / 0.0081,
# head_grad1_diff 0.065 / 0.30, last_grad_median_gap 0.0041 / 0.0074,
# last_head_grad_diff 0.022 / 0.059
# tiny_r18_mesh: from CPU readings over 10 seeds (program's largest;
# control's smallest; each rank stepping on its own gradient's smallest,
# each shard scoring its own rows' smallest): grad1_leaf_diff 0.078 /
# 0.29 / 0.44 / 0.65, head_grad1_diff 0.093 / 0.32 / 0 / 1.02,
# last_head_grad_diff 0.064 / 0.067 / 0 / 0.58; over 12 seeds grad1_gap
# 0.133 / 0.130 / 0.140 / 0.320, and 0.266 with the sum left out for the
# last quarter of the encoder's parameters
TINY_MESH_LIMITS = {"grad1_median_gap": 0.1, "change3_median_gap": 0.15,
                    "grad1_gap": 0.2,
                    "grad1_leaf_diff": 0.15, "head_grad1_diff": 0.15,
                    "last_grad_median_gap": 0.1, "last_head_grad_diff": 0.1}
TINY_ADAMW_LIMITS = {"grad1_median_gap": 0.1, "change3_median_gap": 0.15,
                     "head_grad1_diff": 0.12, "last_grad_median_gap": 0.1,
                     "last_head_grad_diff": 0.1}


def _tiny_configs():
    r = json.loads((ROOT / "benchmark/configs/r100_wf42m.json").read_text())
    r["name"] = "tiny_r18"
    r["program"]["overrides"].update({
        "network": "ResNet18", "sample_rate": 0.25, "sample_block": 4,
        "b": 8, "img_size": 32, "emd_size": 64, "n_classes": 254})
    r["model"].update(network="ResNet18", blocks=[2, 2, 2, 2],
                      widths=[64, 128, 256, 64], emd_size=64, img_size=32,
                      pool=2)
    r["head"].update(num_classes=254, padded_classes=256, sample_block=4,
                     sampled_columns=64, emd_size=64)
    r["batch_size"] = 8
    a = json.loads((ROOT / "benchmark/configs/alternet50_ms1m.json")
                   .read_text())
    a["name"] = "tiny_alter"
    a["program"]["overrides"] = {
        "network": "AlterNet50", "sample_rate": 0.5, "b": 4,
        "img_size": 96, "emd_size": 64, "n_classes": 100,
        "use_fused": False}
    a["model"].update(emd_size=64, img_size=96, widths=[64, 128, 256, 64])
    a["head"].update(num_classes=100, padded_classes=100,
                     sampled_columns=50, emd_size=64)
    a["batch_size"] = 4
    w = json.loads(json.dumps(r))
    w["name"] = "tiny_r18_adamw"
    w["program"]["overrides"].update(optimizer="AdamW", lr=0.001, wd=0.1)
    w["optimizer"] = {"name": "AdamW", "lr": 0.001, "betas": [0.9, 0.999],
                      "eps": 1e-8, "weight_decay": 0.1, "max_grad_norm": 5.0}
    return {"tiny_r18": r, "tiny_alter": a, "tiny_r18_adamw": w}


def add_config(dst: Path, manifest: dict, cfg: dict) -> None:
    """``cfg`` as ``benchmark/configs/<name>.json`` and its entry."""
    path = f"benchmark/configs/{cfg['name']}.json"
    (dst / path).write_text(json.dumps(cfg))
    manifest["configs"].append({"name": cfg["name"], "source": "test",
                                "file": path, "reduced": [], "why": "small"})


def add_cell(dst: Path, manifest: dict, cell: str, config: str,
             traffic: str, own: dict) -> None:
    """A cell's entry, reporting the metrics of the real cell of its
    traffic, and ``benchmark/workloads/<cell>.json`` holding ``own``."""
    manifest["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "small"})
    like = {"train": "r100_wf42m.train", "embed": "r100_wf42m.embed"}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if like[traffic] in m.get("workloads", []):
            m["workloads"].append(cell)
    (dst / f"benchmark/workloads/{cell}.json").write_text(json.dumps(own))


def make_root(dst: Path, precision: str = "bfloat16") -> Path:
    """BENCHMARK.json and benchmark/ copied to ``dst``, with the small
    configurations, their cells (tiny_r18.train, tiny_alter.train,
    tiny_r18.embed, tiny_r18_adamw.train) and their limits added."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    manifest = json.loads((dst / "BENCHMARK.json").read_text())
    for cfg in _tiny_configs().values():
        cfg["precision"] = precision
        cfg["program"]["overrides"]["mixed_precision"] = \
            precision == "bfloat16"
        add_config(dst, manifest, cfg)
    train = {"steps_per_epoch": 4, "profiled_steps": 2}
    cells = (("tiny_r18.train", "tiny_r18", "train",
              {"limits": TINY_TRAIN_LIMITS, "traffic": train}),
             ("tiny_alter.train", "tiny_alter", "train",
              {"limits": TINY_TRAIN_LIMITS, "traffic": train}),
             ("tiny_r18.embed", "tiny_r18", "embed",
              {"limits": TINY_EMBED_LIMITS,
               "traffic": {"batch": 8, "buffers": 3, "profiled_steps": 2}}),
             ("tiny_r18_adamw.train", "tiny_r18_adamw", "train",
              {"limits": TINY_ADAMW_LIMITS, "traffic": train}))
    for cell in cells:
        add_cell(dst, manifest, *cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return dst


def make_mesh_root(dst: Path, precision: str = "bfloat16") -> Path:
    """``make_root``'s copy with ``tiny_r18_mesh``, tiny_r18 with its
    class table sharded over two ranks (mesh data 1, model 2; 4 images a
    rank), and its cell ``tiny_r18_mesh.train`` of 2 chips."""
    make_root(dst, precision)
    manifest = json.loads((dst / "BENCHMARK.json").read_text())
    cfg = json.loads((dst / "benchmark/configs/tiny_r18.json").read_text())
    cfg["name"] = "tiny_r18_mesh"
    cfg["deployment"] = {"chips": 2, "mesh": {"data": 1, "model": 2}}
    cfg["batch_size"] = 4
    cfg["head"]["sampled_columns"] = 32
    add_config(dst, manifest, cfg)
    add_cell(dst, manifest, "tiny_r18_mesh.train", "tiny_r18_mesh", "train",
             {"limits": TINY_MESH_LIMITS,
              "traffic": {"steps_per_epoch": 4, "profiled_steps": 2,
                          "warmup_steps": 3}})
    manifest["workloads"][-1]["chips"] = 2
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return dst


def rank_command(root: Path, cell: str, seed: int, seconds: float,
                 trace: bool, world: int, fail_rank: int = -1,
                 stall_rank: int = -1, sides: str = ""):
    """``command(rank)`` for ``ranks.launch``: a rank of a CPU run of a
    cell of ``world`` ranks over gloo (``python -m benchmark.tests.tiny``),
    the rank ``fail_rank`` raising once it has joined, the rank
    ``stall_rank`` sleeping there. With ``sides`` (comma-separated) rank 0
    prints the readings of those sides (``Loop.readings``) instead of the
    result line."""
    def command(rank):
        return [sys.executable, "-m", "benchmark.tests.tiny", str(root),
                cell, str(seed), repr(seconds), str(int(trace)), str(rank),
                str(world), str(fail_rank), str(stall_rank), sides]
    return command


def _readings(root: Path, cell: str, seed: int, seconds: float, rank: int,
              world: int, sides) -> Optional[dict]:
    """A rank of a CPU run of a mesh cell up to its readings of ``sides``,
    as ``calibrate.py`` takes them; rank 0 returns them."""
    import torch.distributed as dist
    from benchmark import ranks

    files = harness.cell_files(root, harness.load_manifest(root), cell)
    try:
        loop = ranks.mesh_loops(files, rank, world, "gloo")(seed)
        loop.setup()
        loop.window(seconds)
        loop.after_window()
        loop.release()
        return loop.readings(sides) if loop.lead else None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_main(argv) -> int:
    root, cell, seed, seconds, trace, rank, world, fail, stall, sides = argv
    rank, world = int(rank), int(world)
    # the ranks share the host's cores
    torch.set_num_threads(2)
    if rank in (int(fail), int(stall)):
        from benchmark import ranks
        ranks.join(rank, world, "gloo")
        print(f"rank {rank} joined", file=sys.stderr, flush=True)
        if rank == int(stall):
            time.sleep(3600)
        raise RuntimeError(f"rank {rank} fails on purpose")
    if sides:
        result = _readings(Path(root), cell, int(seed), float(seconds), rank,
                           world, tuple(sides.split(",")))
    else:
        result = harness.run_rank(Path(root), cell, int(seed),
                                  float(seconds), bool(int(trace)), rank,
                                  world, time.perf_counter(),
                                  backend="gloo")
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


def run_cpu(root: Path, cell: str, seed: int, seconds: float,
            trace: bool) -> dict:
    """A whole run of ``cell`` on the CPU, as ``harness.run_cell`` drives
    one on the card: set-up, the window, the traced steps with ``trace``,
    then what follows the window (``harness.conclude``)."""
    t_start = time.perf_counter()
    manifest = harness.load_manifest(root)
    files = harness.cell_files(root, manifest, cell)
    loop = harness.loop_for(files["traffic"])(files["config"],
                                              files["traffic"], seed, "cpu")
    loop.setup()
    run = types.SimpleNamespace(
        kind=loop.kind, cfg=files["config"], traffic=files["traffic"],
        window=None, peak=None, setup_s=time.perf_counter() - t_start,
        peak_bytes=0, trace=None)
    run.window = loop.window(seconds)
    if trace:
        run.trace = harness.profile(loop, files["traffic"]["profiled_steps"],
                                    False)
    return harness.conclude(root, manifest, cell, files, loop, run,
                            {"platform": "cpu", "kind": "cpu", "count": 1,
                             "memory_peak_bytes": 0})


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
