"""What decides ``correct``, on the CPU at small sizes: the plain reference
against the program computing in float32, where they agree to rounding;
and whole runs of the harness, its look for a card skipped, that come out
correct on the unbroken program and not correct with the timed path
broken underneath (a step that leaves the state unchanged, half of the
batch left out, an answer altered where it is produced) or with the
float8 control in the program's place. The training cells cover both
optimizers: SGD (tiny_r18, tiny_alter) and AdamW (tiny_r18_adamw)."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def root_f32(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench32"), "float32")


def _loop(root, cell, seed):
    manifest = harness.load_manifest(root)
    files = harness.cell_files(root, manifest, cell)
    d = harness.loop_for(files["traffic"])(files["config"],
                                             files["traffic"], seed, "cpu")
    d.setup()
    d.window(0.2)
    d.after_window()
    d.release()
    return d


@pytest.mark.parametrize("cell", ["tiny_r18.train", "tiny_alter.train",
                                  "tiny_r18_adamw.train"])
def test_reference_follows_the_float32_program(root_f32, cell):
    """In float32 the first step agrees to rounding: its loss, every leaf's
    first gradient and the class table's; the later steps drift apart only
    as far as a chaotic three-step trajectory does (AlterNet at four images
    a batch: under 1e-2). The step recorded after the window, followed
    from the copy of the program's state, agrees to rounding too."""
    got = _loop(root_f32, cell, 3).readings(("program",))["program"]
    assert got["grad1_gap"] < 1e-4 and got["loss1_gap"] < 1e-5
    assert got["grad1_diff"] < 1e-3 and got["head_grad1_diff"] < 1e-4
    assert got["loss_gap"] < 2e-3
    assert got["change3_gap"] < 2e-2
    assert got["last_loss_gap"] < 1e-5 and got["last_grad_gap"] < 1e-4
    assert got["last_head_grad_diff"] < 1e-4


def test_reference_embeds_as_the_float32_program(root_f32):
    got = _loop(root_f32, "tiny_r18.embed", 4).readings()["program"]
    assert got["embed_gap"] < 1e-4


@pytest.mark.parametrize("cell", ["tiny_r18.train", "tiny_r18.embed",
                                  "tiny_r18_adamw.train"])
def test_unbroken_runs_are_correct(root, cell):
    res = tiny.run_cpu(root, cell, 2 ** 31 + 11, 0.3, False)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


def _no_update(*args, **kwargs):
    return None


@pytest.mark.parametrize("cell,fault", [
    pytest.param("tiny_r18.train", "state_unchanged", id="state_unchanged"),
    pytest.param("tiny_r18.train", "half_batch", id="half_batch"),
    pytest.param("tiny_r18_adamw.train", "state_unchanged",
                 id="adamw-state_unchanged"),
    pytest.param("tiny_r18_adamw.train", "half_batch",
                 id="adamw-half_batch")])
def test_broken_training_step_is_not_correct(root, monkeypatch, cell,
                                             fault):
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
    res = tiny.run_cpu(root, cell, 2 ** 31 + 11, 0.3, False)
    assert not res["correct"], res["checks"]


def test_step_broken_after_the_warm_up_is_not_correct(root, monkeypatch):
    """A step that leaves the state unchanged only once set-up's steps are
    done, as a step captured or replayed after a warm-up might: the first
    steps read sound, and the step recorded after the window fails."""
    from fr_tpu_torch.train import step as step_mod
    from fr_tpu_torch.train import task as task_mod
    manifest = harness.load_manifest(root)
    traffic = harness.cell_files(root, manifest, "tiny_r18.train")["traffic"]
    sound = traffic["recorded_steps"] + traffic["warmup_steps"]
    calls = {"n": 0}
    real_step = task_mod.FaceRecognitionTask.training_step

    def counted(self, batch):
        calls["n"] += 1
        return real_step(self, batch)

    def after_set_up(real):
        def update(*args, **kwargs):
            return None if calls["n"] > sound else real(*args, **kwargs)
        return update
    monkeypatch.setattr(task_mod.FaceRecognitionTask, "training_step",
                        counted)
    for name in ("encoder_update", "pfc_row_update"):
        monkeypatch.setattr(step_mod, name,
                            after_set_up(getattr(step_mod, name)))
    res = tiny.run_cpu(root, "tiny_r18.train", 2 ** 31 + 11, 0.3, False)
    checks = res["checks"]
    assert not res["correct"], checks
    for k, c in checks.items():
        assert (c["value"] > c["limit"]) == k.startswith("last_"), checks


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_broken_embedding_step_is_not_correct(root, monkeypatch, fault):
    from fr_tpu_torch.train import step as step_mod
    real = step_mod.make_embed_step

    def broken(conf, encoder, device):
        embed = real(conf, encoder, device)

        def call(images):
            out = embed(images).clone()
            if fault == "answer_altered":
                out[0, 0] += 0.1
            else:
                out[out.shape[0] // 2:] = 0.0
            return out
        return call
    monkeypatch.setattr(step_mod, "make_embed_step", broken)
    res = tiny.run_cpu(root, "tiny_r18.embed", 2 ** 31 + 11, 0.3, False)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,number", [("tiny_r18.train",
                                          "head_grad1_diff"),
                                         ("tiny_r18.embed", "embed_gap"),
                                         ("tiny_r18_adamw.train",
                                          "head_grad1_diff")])
def test_float8_control_reads_above_the_program(root, cell, number):
    """At these sizes the control's reading is at least twice the
    program's, on each seed, and above the cell's limit."""
    limits = harness.cell_files(root, harness.load_manifest(root),
                                cell)["limits"]
    for seed in (21, 22):
        got = _loop(root, cell, seed).readings(("program", "control"))
        assert got["control"][number] > 2 * got["program"][number], got
        assert got["control"][number] > limits[number] or any(
            got["control"][k] > v for k, v in limits.items()), got


@pytest.mark.cuda
def test_control_fails_the_cells_limits_on_the_card():
    """The float8 control in the program's place fails one of each real
    cell's numbers at the cell's own size (the card's job)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    manifest = harness.load_manifest(tiny.ROOT)
    for cell in (w["name"] for w in manifest["workloads"]):
        files = harness.cell_files(tiny.ROOT, manifest, cell)
        d = harness.loop_for(files["traffic"])(
            files["config"], files["traffic"], 97, "cuda:0")
        d.setup()
        d.window(2.0)
        d.after_window()
        d.release()
        got = d.readings(("control",))["control"]
        assert any(got[k] > v for k, v in files["limits"].items()), got
        del d
        torch.cuda.empty_cache()
