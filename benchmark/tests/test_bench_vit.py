"""The ViT family of the benchmark (``reference/families/vit.py``, the
``vit_l_wf42m`` configuration and its three metrics), on the CPU.

A tiny configuration of the family, the program's ``ViT_T`` preset
(36 px, 16 tokens, 3 blocks of width 64, 4 heads, a quarter of the tokens
masked) trained with AdamW at the ViT-L recipe's lr and decay, is added to
a copy of the benchmark as files only, with its reference run in chunks of
4 of its 8 images: a whole run is correct on the unbroken program and not
correct with the step broken or with the float8 control in its place."""

import json
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, inputs
from benchmark import yardstick as ys
from benchmark.reference.encoders import bn_stat_names, identity
from benchmark.reference.families import vit as ref_vit
from benchmark.tests import tiny

CELL = "tiny_vit.train"
NEW = ("attention_ms_per_step", "attention_roofline",
       "rows_update_adamw_roofline")
# From CPU readings over six seeds (program's largest / float8 control's
# smallest): grad1_diff 0.066 / 0.30, head_grad1_diff 0.028 / 0.25,
# last_grad_median_gap 0.0041 / 0.010, last_head_grad_diff 0.024 / 0.12;
# a step that leaves the state unchanged reads 1 on each, and half of the
# batch left out reads 0.95 to 1.01 on both head numbers.
TINY_VIT_LIMITS = {"grad1_diff": 0.1, "head_grad1_diff": 0.1,
                   "last_grad_median_gap": 0.1, "last_head_grad_diff": 0.07}


def _vit_config() -> dict:
    cfg = json.loads((tiny.ROOT / "benchmark/configs/vit_l_wf42m.json")
                     .read_text())
    cfg["name"] = "tiny_vit"
    cfg["program"]["overrides"].update(
        network="ViT_T", sample_rate=0.25, sample_block=4, b=8,
        img_size=36, emd_size=32, n_classes=254)
    cfg["model"].update(network="ViT_T", img_size=36, depth=3, embed_dim=64,
                        heads=4, mask_ratio=0.25, emd_size=32,
                        reference_chunk=4)
    cfg["head"].update(num_classes=254, padded_classes=256,
                       sample_rate=0.25, sample_block=4, sampled_columns=64,
                       emd_size=32)
    cfg["batch_size"] = 8
    return cfg


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench_vit"))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    tiny.add_config(root, manifest, _vit_config())
    tiny.add_cell(root, manifest, CELL, "tiny_vit", "train",
                  {"limits": TINY_VIT_LIMITS,
                   "traffic": {"steps_per_epoch": 4, "profiled_steps": 2}})
    for m in manifest["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def test_unbroken_run_is_correct_and_the_new_readers_stay_silent(root):
    """A traced run on the CPU: correct, and the three new metrics, which
    read the card's device events, leave no number."""
    res = tiny.run_cpu(root, CELL, 2 ** 31 + 11, 0.3, True)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert not set(NEW) & set(res["metrics"])


def _no_update(*args, **kwargs):
    return None


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_broken_step_is_not_correct(root, monkeypatch, fault):
    from fr_tpu_torch.train import step as step_mod
    from fr_tpu_torch.train import task as task_mod
    if fault == "state_unchanged":
        monkeypatch.setattr(step_mod, "encoder_update", _no_update)
        monkeypatch.setattr(step_mod, "pfc_row_update", _no_update)
    else:
        real = task_mod.FaceRecognitionTask.training_step

        def half(self, batch):
            images, labels = batch
            n = images.shape[0] // 2
            return real(self, (images[:n], labels[:n]))
        monkeypatch.setattr(task_mod.FaceRecognitionTask, "training_step",
                            half)
    res = tiny.run_cpu(root, CELL, 2 ** 31 + 11, 0.3, False)
    assert not res["correct"], res["checks"]


def test_float8_control_fails_the_cells_limits(root):
    files = harness.cell_files(root, harness.load_manifest(root), CELL)
    loop = harness.loop_for(files["traffic"])(files["config"],
                                              files["traffic"], 21, "cpu")
    loop.setup()
    loop.window(0.2)
    loop.after_window()
    loop.release()
    got = loop.readings(("program", "control"))
    limits = files["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    assert any(got["control"][k] > v for k, v in limits.items()), got


def test_chunked_reference_is_one_pass():
    """The blocks in chunks under recomputation give the one pass's
    embeddings, and its gradients to float32 rounding: a weight's gradient
    sums over the images in another order (3e-7 of each leaf's norm seen,
    1e-5 allowed)."""
    model = _vit_config()["model"]
    params = inputs.encoder_params(model, 4, "cpu")
    x = torch.rand((8, 36, 36, 3),
                   generator=torch.Generator().manual_seed(1)) * 2 - 1
    w = torch.randn((8, 32), generator=torch.Generator().manual_seed(2))
    out = {}
    for chunk in (8, 3):
        leaves = {n: v.clone().requires_grad_(True) for n, v in
                  params.items() if not n.endswith(("running_mean",
                                                    "running_var"))}
        emb = ref_vit.forward({**model, "reference_chunk": chunk},
                              {**params, **leaves}, x, True,
                              torch.Generator().manual_seed(7), identity)
        out[chunk] = (emb.detach(), torch.autograd.grad(
            (emb * w).sum(), list(leaves.values())))
    assert torch.equal(out[8][0], out[3][0])
    for a, b in zip(out[8][1], out[3][1]):
        assert (a - b).norm() <= 1e-5 * b.norm()


def test_vit_l_sizes_and_stored_forward_flops():
    """The stored count is FlopCounterMode's over the reference's
    evaluation forward (here on the meta device: the count needs no
    values); 144 tokens, 136 kept, 255,684,352 parameters."""
    cfg = json.loads((tiny.ROOT / "benchmark/configs/vit_l_wf42m.json")
                     .read_text())
    model = cfg["model"]
    assert ref_vit.num_patches(model) == 144
    assert ref_vit.kept_tokens(model) == 136
    spec = ref_vit.param_spec(model)
    assert sum(torch.Size(s).numel() for _, s, _ in spec) == 255_684_352
    p = {n: torch.empty(s, device="meta") for n, s, _ in spec}
    for prefix, c in bn_stat_names(model):
        p[f"{prefix}.running_mean"] = torch.empty(c, device="meta")
        p[f"{prefix}.running_var"] = torch.empty(c, device="meta")
    x = torch.zeros((1, 112, 112, 3), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref_vit.forward(model, p, x, False, None, identity)
    assert counter.get_total_flops() == cfg["fwd_flops_per_img"]
    assert cfg["head"]["sampled_columns"] == 9656 * 64 == int(
        0.3 * cfg["head"]["padded_classes"]) // 64 * 64


def _event(name, start, end, device=torch.autograd.DeviceType.CPU, id=0):
    return types.SimpleNamespace(
        name=name, device_type=device, id=id, thread=1,
        time_range=types.SimpleNamespace(start=start, end=end))


def _window(spans):
    """One step: a kernel of 4 ms launched inside each named host span,
    and one launched outside every span."""
    host, kernels = [], []
    for i, name in enumerate(spans + ["outside"], start=1):
        t = 100 * i
        if name != "outside":
            host.append(_event(name, t, t + 50))
        host.append(_event("cudaLaunchKernel", t + 1, t + 2, id=i))
        kernels.append(_event(f"k{i}", 10_000 * i, 10_000 * i + 4_000,
                              torch.autograd.DeviceType.CUDA, i))
    events = host + kernels
    return types.SimpleNamespace(
        steps=1, events=events, kernels=kernels,
        head_ms=ys.head_ms(events, kernels, 1))


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_their_span_and_nothing_without_it(name):
    read = harness.metric_reader(tiny.ROOT, name)
    cfg = json.loads((tiny.ROOT / "benchmark/configs/vit_l_wf42m.json")
                     .read_text())
    peak = ys.PEAKS["NVIDIA H100 80GB HBM3"]
    run = types.SimpleNamespace(kind="train", cfg=cfg, peak=peak,
                                trace=None)
    assert read(run) is None
    run.trace = _window(["encoder:forward", "pfc_head:loss"])
    assert read(run) is None
    run.trace = _window(["encoder:attention", "pfc_head:update"])
    # the least times at the cell's sizes: the attention's bytes bind
    # (24·B·L·D at 3.35 TB/s, 24 layers), the update's 7·n·D·4 bytes
    attention_s = 24 * 24 * 384 * 136 * 768 / 3.35e12
    update_s = 7 * 617984 * 512 * 4 / 3.35e12
    want = {"attention_ms_per_step": 4.0,
            "attention_roofline": 100 * attention_s / 4e-3,
            "rows_update_adamw_roofline": 100 * update_s / 4e-3}[name]
    assert read(run) == pytest.approx(want)
    run.kind = "embed"
    assert read(run) is None


def test_the_adamw_roofline_reads_no_other_optimizer():
    read = harness.metric_reader(tiny.ROOT, "rows_update_adamw_roofline")
    cfg = json.loads((tiny.ROOT / "benchmark/configs/r100_wf42m.json")
                     .read_text())
    run = types.SimpleNamespace(
        kind="train", cfg=cfg, peak=ys.PEAKS["NVIDIA H100 80GB HBM3"],
        trace=_window(["pfc_head:update"]))
    assert read(run) is None
