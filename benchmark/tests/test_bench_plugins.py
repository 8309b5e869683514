"""Encoder families and optimizers found by file: a family copied under a
new kind name runs with readings equal bit for bit to the original's, an
unknown kind or optimizer names the file that is missing, and the weights
and the reference's readings are those the benchmark drew before either
lookup existed."""

import hashlib
import json
import os
import re
import shutil
import struct
import subprocess
import sys

import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import train as ref
from benchmark.tests import tiny

# Runs cells of a benchmark root in the root's own copy of the package and
# prints, per cell, its readings and its forward FLOPs.
_RUN_CELLS = r"""
import json, sys
from pathlib import Path
import torch
torch.set_num_threads(2)
import benchmark
from benchmark import harness, yardstick
root = Path.cwd()
assert Path(benchmark.__file__).resolve().parent == root / "benchmark"
manifest = harness.load_manifest(root)
out = {}
for cell in sys.argv[1:]:
    files = harness.cell_files(root, manifest, cell)
    loop = harness.loop_for(files["traffic"])(
        files["config"], files["traffic"], 7, "cpu")
    loop.setup()
    loop.window(0)
    loop.after_window()
    loop.release()
    out[cell] = {"readings": loop.readings(("program", "control")),
                 "flops": yardstick.count_forward_flops(
                     files["config"]["model"])}
print(json.dumps(out))
"""


def test_a_family_is_found_by_its_file_alone(tmp_path):
    """families/ir_resnet.py copied as families/ir_resnet_copy.py, and
    tiny_r18 as a configuration of that kind, added as files only: its
    cell reads what tiny_r18.train reads at the same seed, bit for bit
    (one window step, so both record the same steps)."""
    root = tiny.make_root(tmp_path / "root")
    fam = root / "benchmark/reference/families"
    shutil.copy(fam / "ir_resnet.py", fam / "ir_resnet_copy.py")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/tiny_r18.json").read_text())
    cfg["name"] = "tiny_r18_copy"
    cfg["model"]["kind"] = "ir_resnet_copy"
    tiny.add_config(root, manifest, cfg)
    own = json.loads((root / "benchmark/workloads/tiny_r18.train.json")
                     .read_text())
    tiny.add_cell(root, manifest, "tiny_r18_copy.train", "tiny_r18_copy",
                  "train", own)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(root), str(tiny.ROOT)])}
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_CELLS, "tiny_r18.train",
         "tiny_r18_copy.train"], cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["tiny_r18_copy.train"] == got["tiny_r18.train"]
    assert got["tiny_r18.train"]["readings"]["program"]["loss1_gap"] > 0
    assert not (tiny.ROOT / "benchmark/reference/families"
                / "ir_resnet_copy.py").exists()


@pytest.mark.parametrize("section,key,name,missing", [
    ("model", "kind", "no_such_family", "families/no_such_family.py"),
    ("optimizer", "name", "Lion", "optimizers/lion.py")])
def test_an_unknown_family_or_optimizer_names_its_missing_file(
        tmp_path, section, key, name, missing):
    root = tiny.make_root(tmp_path)
    path = root / "benchmark/configs/tiny_r18.json"
    cfg = json.loads(path.read_text())
    cfg[section][key] = name
    path.write_text(json.dumps(cfg))
    with pytest.raises(harness.BenchError, match=re.escape(missing)):
        tiny.run_cpu(root, "tiny_r18.train", 3, 0.1, False)


def test_a_family_adds_parameter_kinds_by_its_init(monkeypatch):
    """A kind the family's INIT draws takes its share of the one draw in
    spec order; the other parameters keep theirs; a kind that neither
    inputs.py nor the family knows, or a known kind the family redraws, is
    refused."""
    from benchmark.reference.families import ir_resnet
    model = tiny._tiny_configs()["tiny_r18"]["model"]
    before = inputs.encoder_params(model, 1, "cpu")
    spec = ir_resnet.param_spec
    monkeypatch.setattr(ir_resnet, "param_spec", lambda m: spec(m) + [
        ("pos_embed", (1, 4, 2), "position")])
    monkeypatch.setattr(ir_resnet, "INIT", {
        "position": lambda z, shape: 0.02 * z}, raising=False)
    after = inputs.encoder_params(model, 1, "cpu")
    assert after["pos_embed"].shape == (1, 4, 2)
    assert list(after) == list(before)[:len(spec(model))] + [
        "pos_embed"] + list(before)[len(spec(model)):]
    for name in spec(model):
        assert torch.equal(after[name[0]], before[name[0]]), name
    monkeypatch.setattr(ir_resnet, "INIT", {}, raising=False)
    with pytest.raises(harness.BenchError, match="position"):
        inputs.encoder_params(model, 1, "cpu")
    monkeypatch.setattr(ir_resnet, "INIT", {"bias": lambda z, shape: z},
                        raising=False)
    with pytest.raises(harness.BenchError, match="bias"):
        inputs.encoder_params(model, 1, "cpu")


# sha256 of the weights of the real configurations at seed 1 and of the
# reference's readings of the small ones on inputs drawn from seed 5, as the
# benchmark computed them before families and optimizers were files (float32
# on an x86-64 CPU, two threads; another CPU's vector units may round
# differently)
DIGESTS = {
    "params.r100_wf42m":
        "ac27b7f28540be705399a3a07767ead8a0cb6a53aeeb6e5433c70e09a449c42a",
    "params.alternet50_ms1m":
        "07f368d15f66e41db08b8a397ceb0c24df49d97e795e9cc90f4729b68a78a0d1",
    "ref.tiny_r18.first":
        "e0a6027c6cfddead7c8ff8d83ba30fcb73ad2fefd9991069845477de633e38f6",
    "ref.tiny_r18.last":
        "f2351582f65c827f37a5c12ab0f41fb6e616de33fe7c529fed3e647d92743586",
    "ref.tiny_r18.embed":
        "691cf3fe8d4d2cad2eba7028f3522b372da0bf7c373482ad92b19205697116f4",
    "ref.tiny_alter.first":
        "cc699afc189051439e69b82bb7794a65a2da7f86f48a84a54537b6e5458dbc16",
    "ref.tiny_alter.last":
        "d0421f59f9525549c5e8d5fd14a00cb45cf4348b7468a615beef9478b90d4770",
    "ref.tiny_alter.embed":
        "dc53404096801307eec837a61ec31c674d57f2d4e343d12221cc2ec50cadb73e",
}


def _feed(h, x) -> None:
    if isinstance(x, dict):
        for k in sorted(x):
            h.update(k.encode())
            _feed(h, x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            _feed(h, v)
    elif isinstance(x, torch.Tensor):
        h.update(str(x.dtype).encode() + str(tuple(x.shape)).encode())
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    elif isinstance(x, str):
        h.update(x.encode())
    else:
        h.update(struct.pack("<d", float(x)))


def _digest(x) -> str:
    h = hashlib.sha256()
    _feed(h, x)
    return h.hexdigest()


@pytest.mark.parametrize("config", ["r100_wf42m", "alternet50_ms1m"])
def test_weights_are_drawn_as_before(config):
    cfg = json.loads((tiny.ROOT / f"benchmark/configs/{config}.json")
                     .read_text())
    p = inputs.encoder_params(cfg["model"], 1, "cpu")
    assert _digest([list(p), p]) == DIGESTS[f"params.{config}"]


@pytest.mark.parametrize("config", ["tiny_r18", "tiny_alter"])
def test_reference_reads_as_before(config):
    """Three steps from the seed's weights, one step from given slots and
    counts, and the embeddings, on inputs drawn from the seed: the
    reference alone, so that the program's own arithmetic does not enter."""
    cfg = tiny._tiny_configs()[config]
    seed, b, m = 5, cfg["batch_size"], cfg["model"]
    params0 = inputs.encoder_params(m, seed, "cpu")
    table0 = inputs.class_table(cfg["head"], seed, "cpu")
    images, labels = inputs.corpus(4 * b, m["img_size"],
                                   cfg["head"]["num_classes"], seed)
    steps = [{"images": torch.from_numpy(images[k * b:(k + 1) * b].copy()),
              "labels": torch.from_numpy(labels[k * b:(k + 1) * b].copy()),
              "states": {s: torch.Generator().manual_seed(
                  100 * k + i).get_state()
                  for i, s in enumerate(("augment", "sample", "dropout"))}}
             for k in range(4)]
    g = torch.Generator().manual_seed(9)
    names = [n for n in params0 if not n.endswith(("running_mean",
                                                   "running_var"))]
    start = {"slots": {"momentum": {
                 n: 0.01 * torch.randn(params0[n].shape, generator=g)
                 for n in names}},
             "head_slots": {"momentum": 0.01 * torch.randn(
                 table0.shape, generator=g)},
             "count": 7, "head_count": 7}
    got = {"first": ref.train_steps(cfg, params0, table0, steps[:3]),
           "last": ref.train_steps(cfg, params0, table0, steps[3:],
                                   start=start),
           "embed": ref.embed(cfg, params0, inputs.embed_images(
               1, 8, m["img_size"], seed, "cpu")[0])}
    for part, value in got.items():
        assert _digest(value) == DIGESTS[f"ref.{config}.{part}"], part
