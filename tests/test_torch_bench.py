"""The port's bench (fr_tpu_torch/bench.py) against fr_tpu's bench.py: the
same rows, workload variables and per-row environment; one tiny row of each
kind (training, embedding, the card-resident packed corpus) on the CPU
carries every field of the row schema, with mfu = multiplier · FLOPs ·
imgs/s / peak under a patched peak table and null with its reason for a
device the table lacks; the matrix's repeats give medians and spreads and
print the aggregate after every row run; the arms runner alternates its
arms' order by round and summarises each arm as the bench does; a corpus
write cut off part-way leaves no corpus; without a CUDA device and without
--device cpu the bench raises."""

import json
import runpy
import statistics
import tempfile
from pathlib import Path

import pytest

from fr_tpu_torch import bench
from fr_tpu_torch import configs
from fr_tpu_torch.tools import bench_arms
from test_torch_cpu_threads import one_torch_thread  # noqa: F401

ROOT_BENCH = Path(__file__).resolve().parent.parent / "bench.py"
ROW_FIELDS = ("metric", "value", "unit", "step_ms", "device_busy_ms",
              "idle_share", "launches_per_step", "mfu", "mfu_note",
              "fwd_flops_per_img", "flops_multiplier", "peak_tflops",
              "device_name", "card", "kernel_launches_per_step", "steps",
              "final_output", "use_fused", "attn_stored_stats")


@pytest.fixture(scope="module")
def fr_bench():
    """bench.py's namespace; its top level imports only the standard
    library and numpy, and main() runs under its __main__ check."""
    return runpy.run_path(str(ROOT_BENCH), run_name="fr_tpu_bench")


def test_rows_and_workload_vars_equal_bench_py(fr_bench):
    assert bench.ROWS == fr_bench["ROWS"]
    assert bench.WORKLOAD_VARS == fr_bench["WORKLOAD_VARS"]


@pytest.mark.parametrize("row", bench.ROWS)
def test_row_env_equals_bench_py(fr_bench, row, monkeypatch):
    """Equal for every row with BENCH_PACKED and BENCH_SAMPLE_BLOCK
    exported; without BENCH_PACKED, r100_realdata's default corpus is the
    port's own, under the temporary directory."""
    monkeypatch.setenv("BENCH_PACKED", "/data/packed")
    monkeypatch.setenv("BENCH_SAMPLE_BLOCK", "16")
    assert bench._row_env(row) == fr_bench["_row_env"](row)
    monkeypatch.delenv("BENCH_PACKED")
    monkeypatch.delenv("BENCH_SAMPLE_BLOCK")
    ours, ref = bench._row_env(row), fr_bench["_row_env"](row)
    if row == "r100_realdata":
        assert ours.pop("BENCH_PACKED") == bench.PACKED_DEFAULT == str(
            Path(tempfile.gettempdir()) / "fr_tpu_torch_bench_packed")
        assert ref.pop("BENCH_PACKED") == "/tmp/fr_bench_packed"
    assert ours == ref


def test_unknown_row_raises():
    with pytest.raises(ValueError):
        bench._row_env("r50")


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """ResNet18 at 32 px, b=8, 16 classes, 2 timed steps."""
    load = configs.load_config

    def small(*args, **kwargs):
        conf = load(*args, **kwargs)
        conf.img_size = 32
        return conf

    monkeypatch.setattr(configs, "load_config", small)
    for k, v in bench.WORKLOAD_VARS.items():
        monkeypatch.setenv(k, v)
    for k, v in {"BENCH_NETWORK": "ResNet18", "BENCH_BATCH": "8",
                 "BENCH_CLASSES": "16", "BENCH_SAMPLE_RATE": "1.0",
                 "BENCH_STEPS": "2"}.items():
        monkeypatch.setenv(k, v)
    return tmp_path


@pytest.mark.parametrize("kind", ["train", "embed", "realdata"])
def test_cpu_row_has_every_field_and_mfu(tiny, kind, monkeypatch):
    if kind == "embed":
        monkeypatch.setenv("BENCH_MODE", "embed")
    elif kind == "realdata":
        monkeypatch.setenv("BENCH_PACKED", str(tiny / "packed"))
        monkeypatch.setenv("BENCH_DEVICE_CORPUS", "1")
    monkeypatch.setitem(bench.PEAK_BF16_TFLOPS, "cpu", 0.5)
    row = bench.run_workload("cpu")
    assert set(ROW_FIELDS) <= set(row)
    assert row["device_name"] == "cpu" and row["card"] is None
    assert row["value"] > 0 and row["steps"] == 2
    assert row["step_ms"] == pytest.approx(8 * 1e3 / row["value"])
    # no device timeline on the CPU, and no kernel launched
    assert row["device_busy_ms"] is row["idle_share"] is None
    assert row["launches_per_step"] is None
    assert row["kernel_launches_per_step"] == {}
    mult = 1.0 if kind == "embed" else 3.0
    assert row["flops_multiplier"] == mult and row["peak_tflops"] == 0.5
    assert row["fwd_flops_per_img"] > 1e8
    assert row["mfu"] == pytest.approx(
        mult * row["fwd_flops_per_img"] * row["value"] / 0.5e12, rel=1e-12)
    assert row["mfu_note"] is None
    if kind == "realdata":
        assert row["corpus"] == "synthetic"
        assert "device-resident corpus" in row["metric"]


def test_a_device_not_in_the_table_gives_no_mfu(tiny):
    row = bench.run_workload("cpu")
    assert row["mfu"] is None and row["peak_tflops"] is None
    assert row["mfu_note"] == "no peak for device 'cpu' in PEAK_BF16_TFLOPS"
    assert row["fwd_flops_per_img"] > 1e8


def test_a_failed_flop_count_is_reported(tiny, monkeypatch):
    from fr_tpu_torch.utils import flops

    def broken(conf, batch=1):
        raise RuntimeError("no count")

    monkeypatch.setattr(flops, "encoder_forward_flops", broken)
    monkeypatch.setitem(bench.PEAK_BF16_TFLOPS, "cpu", 0.5)
    row = bench.run_workload("cpu")
    assert row["mfu"] is None and row["value"] > 0
    assert "FLOP count failed" in row["mfu_note"]
    assert "RuntimeError: no count" in row["mfu_note"]


def test_matrix_repeats_give_medians_and_spreads(monkeypatch, capsys):
    """Two rows, three repeats in turn; each run's result comes from a
    stand-in for the row's subprocess."""
    calls = []
    values = {"r100_synthetic": [100.0, 130.0, 110.0],
              "alternet50": [50.0, 40.0, 70.0]}

    def fake_row(name, device, timeout):
        i = sum(c == name for c in calls)
        calls.append(name)
        if name == "alternet50" and i == 1:
            return {"error": "boom", "returncode": 1}
        v = values[name][i]
        return {"metric": name, "value": v, "unit": "imgs/s",
                "step_ms": 1e3 / v, "device_busy_ms": v / 10,
                "idle_share": 0.5, "mfu": v / 1e3, "device_name": "cpu",
                "card": None}

    monkeypatch.setattr(bench, "_run_row", fake_row)
    monkeypatch.setenv("BENCH_ROWS", "r100_synthetic,alternet50")
    monkeypatch.setenv("BENCH_REPEATS", "3")
    monkeypatch.delenv("BENCH_ROW", raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    assert calls == ["r100_synthetic", "alternet50"] * 3
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 6  # the aggregate after every row run
    last = lines[-1]
    assert last["value"] == 110.0 and last["metric"] == "r100_synthetic"
    head, alt = last["rows"]
    assert head["repeats"] == 3 and head["value_spread"] == 30.0
    assert head["device_busy_ms"] == 11.0
    assert head["device_busy_ms_spread"] == pytest.approx(3.0)
    assert alt["repeats"] == 2
    assert alt["value"] == statistics.median([50.0, 70.0])
    assert alt["runs"][1] == {"error": "boom"}


def test_without_cuda_the_bench_raises(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("BENCH_ROW", "alternet50")
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main([])


def test_bench_arms_alternate_and_summarise(monkeypatch, capsys):
    """Two rounds over one row: the arms in order, then reversed; each
    arm's overrides and BENCH_ROW_TIMEOUT reach the row process; each arm's
    entry is the bench's own summary of its rounds."""
    calls = []

    def fake_row(name, device, timeout, overrides):
        calls.append((name, device, timeout, dict(overrides)))
        v = 100.0 + len(calls)
        return {"value": v, "device_busy_ms": v / 10, "idle_share": 0.5,
                "mfu": v / 1e3}

    monkeypatch.setattr(bench, "_run_row", fake_row)
    monkeypatch.setenv("BENCH_ROW_TIMEOUT", "123")
    assert bench_arms.main(["--rows", "alternet50", "--rounds", "2"]) == 0
    assert [c[3] for c in calls] == [
        {}, {"BENCH_FUSED": "1"}, {"FR_ATTN_STORED_STATS": "1"},
        {"FR_ATTN_STORED_STATS": "1"}, {"BENCH_FUSED": "1"}, {}]
    assert {c[:3] for c in calls} == {("alternet50", "cuda", 123.0)}
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    default = out["alternet50"]["default"]
    assert [r["value"] for r in default["runs"]] == [101.0, 106.0]
    assert default["value"] == 103.5 and default["value_spread"] == 5
    assert default["device_busy_ms"] == pytest.approx(10.35)
    assert default["repeats"] == 2
    stats = out["alternet50"]["stats"]
    assert [r["value"] for r in stats["runs"]] == [103.0, 104.0]


def test_a_cut_off_corpus_write_leaves_no_corpus(tmp_path, monkeypatch):
    """The synthetic corpus appears whole or not at all: a write that
    fails part-way leaves nothing at the path, and the next call writes
    it anew (over the partial directory) and then reuses it."""
    import numpy as np
    path = tmp_path / "corpus"
    save = np.save

    def full_disk(*args, **kwargs):
        raise OSError("No space left on device")

    monkeypatch.setattr(np, "save", full_disk)
    with pytest.raises(OSError, match="No space"):
        bench.ensure_packed_corpus(str(path), n=4, img_size=8, n_classes=3)
    assert not path.exists()
    assert (tmp_path / "corpus.partial" / "images.npy").exists()
    monkeypatch.setattr(np, "save", save)
    assert bench.ensure_packed_corpus(str(path), n=4, img_size=8,
                                      n_classes=3) == "synthetic"
    assert not (tmp_path / "corpus.partial").exists()
    assert sorted(p.name for p in path.iterdir()) == [
        "SYNTHETIC_BENCH_CORPUS", "classes.json", "images.npy", "labels.npy"]
    assert np.load(path / "images.npy").shape == (4, 8, 8, 3)
    assert bench.ensure_packed_corpus(str(path), n=4, img_size=8,
                                      n_classes=3) == "synthetic"
