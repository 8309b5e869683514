"""Checkpoints of a class-sharded head (fr_tpu_torch/ckpt/checkpoint.py on
a mesh): two gloo ranks of a (1, 2) mesh (tests/torch_multigpu_worker.py)
save their shards, and a one-process state restores that file; a
one-process save is restored by the two ranks. The file keeps the
one-device layout, so both ways are bitwise: the whole head and its slots
are the gathered shards, and each rank's restored shard is its slice of
the one-device table, padded (37 classes pad to 38 over two shards).

Then both files resume at meshes with two data rows, (2, 1) and (2, 2),
and take a sampled step: the data rows of one model shard must restore the
same sample stream (their head gradients are summed, so they must draw the
same columns), and after the step their head shards are bitwise equal."""

import numpy as np
import pytest
import torch

from fr_tpu_torch.ckpt import restore_train_state, save_train_state
from fr_tpu_torch.heads.partial_fc import PFCConfig, init_pfc_state
from fr_tpu_torch.models.common import init_weights
from fr_tpu_torch.parallel.mesh import Mesh
from fr_tpu_torch.train.state import (TrainState, init_encoder_slots,
                                      stream_generators)
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_multigpu_worker import (finish_job, run_job, seeded, small_resnet,
                                   start_job)

NET = {"layers": [1, 1, 1, 1], "emb": 16, "img": 32}
FIELDS = {"num_classes": 37, "embedding_size": 16}


def _one_device_state(encoder):
    cfg = PFCConfig(**FIELDS)
    return TrainState(step=0, encoder=encoder,
                      opt_slots=init_encoder_slots("SGD", encoder),
                      pfc=init_pfc_state(cfg, torch.Generator().manual_seed(
                          0), "cpu"),
                      generators=stream_generators(0, "cpu"))


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """A one-process save at step 3 (its sample stream advanced past the
    fresh one) and the (1, 2) ranks' save at step 1 (each rank's sample
    stream its own), with what the ranks saved and restored."""
    tmp_path = tmp_path_factory.mktemp("ckpt_mesh")
    encoder = init_weights(small_resnet(NET), 1)
    whole = seeded(1, 38, 16)            # the (1, 2) mesh's padded table
    momentum = seeded(2, 38, 16)
    # a one-process save of another table, for the ranks to restore
    one = _one_device_state(encoder)
    one.pfc.weight, one.pfc.slots = seeded(3, 37, 16), {
        "momentum": seeded(4, 37, 16)}
    one.step = one.pfc.count = 3
    one.generators["sample"].manual_seed(2000)
    save_train_state(tmp_path / "one", one, 3)

    ranks = run_job(tmp_path, "checkpoint", (1, 2), net=NET, pfc=FIELDS,
                    encoder=encoder.state_dict(), weight=whole,
                    momentum=momentum, save_dir=str(tmp_path / "mesh"),
                    restore_dir=str(tmp_path / "one"))
    return dict(tmp_path=tmp_path, encoder=encoder, whole=whole,
                momentum=momentum, one=one, ranks=ranks)


def test_sharded_save_and_restore_round_trip(saves):
    tmp_path, encoder, one, ranks = (saves[k] for k in (
        "tmp_path", "encoder", "one", "ranks"))
    whole, momentum = saves["whole"], saves["momentum"]

    # (1, 2) → (1, 1): the gathered shards, the padding row truncated
    shards = [r["saved"] for r in ranks]
    assert torch.equal(torch.cat([s["weight"] for s in shards]), whole)
    restored = restore_train_state(tmp_path / "mesh",
                                   _one_device_state(encoder))
    assert torch.equal(restored.pfc.weight, whole[:37])
    assert torch.equal(restored.pfc.slots["momentum"], momentum[:37])
    assert restored.step == restored.pfc.count == 1
    for name, gen in restored.generators.items():
        assert torch.equal(gen.get_state(), shards[0]["generators"][name])
    raw = torch.load(tmp_path / "mesh" / "state" / "1.pt", weights_only=True)
    assert raw["pfc"]["weight"].shape == (38, 16)
    assert raw["mesh"] == [1, 2]
    assert len(raw["rank_generators"]) == 1
    for name, state in raw["rank_generators"][0].items():
        assert torch.equal(state, shards[1]["generators"][name])

    # (1, 1) → (1, 2): each rank its slice of the padded one-device table
    padded = torch.cat([one.pfc.weight, torch.zeros(1, 16)])
    padded_m = torch.cat([one.pfc.slots["momentum"], torch.zeros(1, 16)])
    for r, out in enumerate(ranks):
        got = out["restored"]
        assert torch.equal(got["weight"], padded[r * 19:(r + 1) * 19])
        assert torch.equal(got["slots"]["momentum"],
                           padded_m[r * 19:(r + 1) * 19])
        assert got["step"] == got["count"] == 3
        # rank 0 takes the file's generators, rank 1 keeps its own
        fresh = stream_generators(0, "cpu", Mesh(1, 2, 0, r))
        for name, gen in one.generators.items():
            want = gen.get_state() if r == 0 else fresh[name].get_state()
            assert torch.equal(got["generators"][name], want)


def test_resume_with_data_rows_keeps_shards_equal(saves):
    """Saved at (1, 1) and at (1, 2), restored at (2, 1) and (2, 2), one
    step of a sampled head (sample_rate 0.5): shard m takes the file's
    shard m's sample stream where the file has that shard, else a fresh one
    that its data rows share; the shards of one model index stay bitwise
    equal across the data rows, and the encoders across every rank."""
    tmp_path = saves["tmp_path"]
    rng = np.random.default_rng(5)
    batch = (torch.from_numpy(rng.standard_normal(
        (8, 32, 32, 3)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 37, 8).astype(np.int32)))
    conf = dict(network="ResNet", emd_size=16, n_classes=37,
                metric="ArcFace", loss_s=30.0, loss_m=0.35,
                optimizer_name="SGD", optimizer="SGD", wd=5e-4, mom=0.9,
                mixed_precision=False, sample_rate=0.5, use_fused=False)
    dirs = {"one": str(tmp_path / "one"), "mesh": str(tmp_path / "mesh")}
    files = {name: torch.load(f"{d}/state/{step}.pt", weights_only=True)
             for (name, d), step in zip(dirs.items(), (3, 1))}
    jobs = {}
    for shape in ((2, 1), (2, 2)):
        job_dir = tmp_path / f"resume{shape[0]}x{shape[1]}"
        job_dir.mkdir()
        jobs[shape] = start_job(job_dir, "resume", shape, net=NET,
                                pfc=dict(FIELDS, sample_rate=0.5),
                                encoder=saves["encoder"].state_dict(),
                                conf=conf, lr=0.1, batch=batch,
                                restore_dirs=dirs)
    for (data, model), handle in jobs.items():
        ranks = finish_job(handle)
        for name, raw in files.items():
            saved_model = raw.get("mesh", [1, 1])[1]
            gens = [raw["generators"]] + raw.get("rank_generators", [])
            outs = [r[name] for r in ranks]
            for r, out in enumerate(outs):
                midx = r % model
                assert out["digest"] == outs[0]["digest"], (name, r)
                if midx < saved_model:
                    assert torch.equal(out["sample"],
                                       gens[midx]["sample"]), (name, r)
                row0 = outs[midx]        # data row 0 of the same shard
                assert torch.equal(out["sample"], row0["sample"])
                assert torch.equal(out["weight"], row0["weight"]), (name, r)
                assert torch.equal(out["slots"]["momentum"],
                                   row0["slots"]["momentum"]), (name, r)
                assert np.isfinite(out["loss"])
                assert out["loss"] == outs[0]["loss"]
