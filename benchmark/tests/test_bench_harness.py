"""The benchmark's manifest and files, its name lookup, its import check and
its yardstick, on the CPU."""

import ast
import importlib
import json
import math

import pytest

from benchmark import harness
from benchmark import yardstick as ys
from benchmark.tests import tiny

ROOT = tiny.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_manifest_keys_names_and_units():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    names = []
    for section, keys in KEYS.items():
        for entry in MANIFEST[section]:
            assert set(entry) - {"workloads"} == keys, entry
            assert harness.NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert harness.UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]
    for section in KEYS:
        got = [e["name"] for e in MANIFEST[section]]
        assert len(got) == len(set(got)), section
    for e in MANIFEST["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_config_traffic_and_metric_has_its_file():
    for cell in MANIFEST["workloads"]:
        files = harness.cell_files(ROOT, MANIFEST, cell["name"])
        cfg = files["config"]
        assert cfg["name"] == cell["config"]
        loop = importlib.import_module(
            f"benchmark.loops.{files['traffic']['loop']}")
        assert files["limits"] and set(files["limits"]) <= set(
            loop.READINGS)
        e2e = {m["name"] for m in harness.cell_metrics(
            MANIFEST, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(MANIFEST, cell["name"], "per_layer")
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(harness.metric_reader(ROOT, m["name"]))
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == cfg["reduced"]
        assert c["file"].startswith("benchmark/")


def test_names_of_files_use_the_allowed_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or ".cache" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert all(ch.isascii() and (ch.isalnum() or ch in "_.-/")
                   for ch in rel), rel


def test_import_check_compares_whole_top_level_names():
    loaded = ["fr_tpu_torch", "fr_tpu_torch.train.step", "jaxtyping",
              "fr_tpu.x", "jax", "jaxlib.xla_client", "flax.linen",
              "optax", "orbax.checkpoint", "numpy"]
    assert harness.forbidden_modules(loaded) == [
        "flax.linen", "fr_tpu.x", "jax", "jaxlib.xla_client", "optax",
        "orbax.checkpoint"]
    assert harness.forbidden_modules(["fr_tpu_torch", "torch"]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_neither_jax_nor_either_package():
    files = list((ROOT / "benchmark" / "reference").rglob("*.py"))
    assert {"families", "optimizers"} <= {p.parent.name for p in files}
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "fr_tpu",
                               "fr_tpu_torch"), (path.name, name)


def test_harness_never_imports_jax_or_the_jax_package():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_stored_forward_flops_are_the_references(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert ys.count_forward_flops(cfg["model"]) == cfg["fwd_flops_per_img"]


def test_rooflines_at_the_webface42m_shapes():
    peak = ys.PEAKS["NVIDIA H100 80GB HBM3"]
    b, n, d = 256, 411968, 512
    ce = ys.margin_ce_least_s(b, n, d, peak)
    flops_s = 6.0 * b * n * d / 989.4e12
    bytes_s = 4.0 * (2 * n * d + 2 * b * d) / 3.35e12
    assert ce == bytes_s > flops_s
    assert math.isclose(ce * 1e3, 0.5040, abs_tol=5e-5)
    assert math.isclose(ys.rows_update_least_s(n, d, peak) * 1e3, 1.2593,
                        abs_tol=5e-5)
    cfg = json.loads((ROOT / "benchmark/configs/r100_wf42m.json").read_text())
    # a fifth of the 32,187 groups of 64 rows, as the program draws them
    assert cfg["head"]["sampled_columns"] == 6437 * 64 == n
    assert int(0.2 * cfg["head"]["padded_classes"]) // 64 == 6437
    assert ys.train_flops_per_img(cfg) == 3 * 22881861632 + 6 * d * n


def test_busy_time_is_the_union_of_intervals():
    class E:
        def __init__(self, a, b):
            self.time_range = type("T", (), {"start": a, "end": b})
    ev = [E(0, 10), E(5, 12), E(20, 25), E(24, 30), E(40, 41)]
    assert ys.busy_s(ev) == (12 + 10 + 1) / 1e6
    assert ys.busy_intervals(ev) == [[0, 12], [20, 30], [40, 41]]


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "benchmark/metrics/steps_in_window.train.py").write_text(
        "def read(run):\n"
        "    return float(run.window['steps']) if run.kind == 'train' "
        "else None\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({
        "name": "steps_in_window.train", "unit": "steps",
        "better": "higher", "source": "host_clock", "layer": "train step",
        "moves": "train_imgs_per_s", "workloads": ["tiny_r18.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    res = tiny.run_cpu(root, "tiny_r18.train", 5, 0.5, True)
    assert res["metrics"]["steps_in_window.train"]["value"] == \
        res["attempted"]
    assert list(res)[-1] == "checks"
