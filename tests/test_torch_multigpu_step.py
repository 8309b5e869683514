"""The port's training step on a ('data', 'model') mesh against fr_tpu's:
fr_tpu's make_train_step on meshes (1, 4), (2, 2) and (4, 1) of the
conftest's virtual CPU devices, and the port's on 4 gloo ranks of the same
shape (tests/torch_multigpu_worker.py, one spawn per mesh running every
case), from the same weights: the small IR-ResNet of
test_torch_train_step.py (one block per stage, 32 px, emd 64, 298 classes),
fr_tpu's flax init crossed with train_state_from_jax, each rank holding its
model shard of the head. Two steps of 16 images (4 a rank) of synthetic
identities made from a numpy seed, f32, lr 1e-3.

Cases: SGD and AdamW at sample_rate 1.0; block-sampled (sample_block 4,
sample_rate 0.5), each shard fed the groups fr_tpu's step draws for it (its
sample key folds the shard's index, fr_tpu/train/step.py:127), with the
plain CE and with use_fused (the kernels' plain versions under the
pmax/psum merge of ops/fused_pfc.py).

Tolerances are test_torch_train_step.py's, and why is said there: loss rtol
3e-5, grad_norm 1e-3, each tensor norm-wise rtol·‖ref‖ + 2e-6·√size with
parameters and the head 2e-4, BN running statistics 1e-3, the updates and
slots 3e-2 after step 1 and 1e-1 after step 2; AdamW's encoder as one
vector (parameters 1e-3), its step-2 loss 2e-4 and head 5e-3.

Every rank's encoder parameters and BN buffers are bitwise equal after each
step, and the shards of one model index are bitwise equal over the data
rows. Last, the port against itself: on batches that repeat one rank's 4
images on every rank (so that local BN sees the same statistics), its
M-way step drawing its own groups equals its one-device step fed the union
of every shard's groups, at the same tolerances.
"""

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
import numpy as np
import pytest
import torch

from fr_tpu.heads import partial_fc as jax_pfc
from fr_tpu.heads.partial_fc import init_pfc_state
from fr_tpu.models import resnet as jax_resnet
from fr_tpu.parallel import make_mesh as jax_make_mesh
from fr_tpu.train.optim import init_slots
from fr_tpu.train.state import TrainState as JaxTrainState
from fr_tpu.train.state import state_partition_specs
from fr_tpu.train.step import STREAM_SAMPLE, shard_batch, stream_key
from fr_tpu.train.step import make_train_step as jax_make_train_step
from fr_tpu_torch.configs.base import Config
from fr_tpu_torch.heads.partial_fc import PFCConfig
from fr_tpu_torch.models import resnet
from fr_tpu_torch.train.step import make_train_step
from fr_tpu_torch.utils.jax_import import (train_state_from_jax,
                                           train_state_to_jax_layout)
from test_torch_cpu_threads import one_torch_thread  # noqa: F401
from test_torch_train_step import _assert_close, _whole
from torch_multigpu_worker import finish_job, start_job

LAYERS, IMG, EMB, NCLS, BLOCK, LR = (1, 1, 1, 1), 32, 64, 298, 4, 1e-3
NET = {"layers": list(LAYERS), "emb": EMB, "img": IMG}
WORLD, B_LOC, STEPS = 4, 4, 2
MESHES = [(1, 4), (2, 2), (4, 1)]
# name: (optimizer, sample_rate, use_fused)
CASES = {"sgd": ("SGD", 1.0, False), "adamw": ("AdamW", 1.0, False),
         "block": ("SGD", 0.5, False), "fused": ("SGD", 0.5, True)}


def _conf(optimizer, sample_rate, use_fused):
    return Config(network="ResNet", emd_size=EMB, n_classes=NCLS,
                  metric="ArcFace", loss_s=30.0, loss_m=0.35,
                  optimizer_name=optimizer, optimizer=optimizer, wd=5e-4,
                  mom=0.9, eps=1e-8, betas=(0.9, 0.999),
                  mixed_precision=False, sample_rate=sample_rate,
                  use_fused=use_fused)


def _pfc_fields(optimizer, sample_rate, use_fused):
    """The port's PFCConfig fields but model_size."""
    return dict(num_classes=NCLS, embedding_size=EMB,
                sample_rate=sample_rate, margin="ArcFace", s=30.0, m=0.35,
                mixed_precision=False, optimizer=optimizer,
                use_fused=use_fused,
                sample_block=BLOCK if sample_rate < 1.0 else 1)


def _batches(seed, tiled=False):
    """STEPS global batches of WORLD·B_LOC images of 8 identities; tiled:
    one rank's 4 images repeated on every rank."""
    rng = np.random.default_rng(seed)
    templates = rng.standard_normal((8, IMG, IMG, 3))
    n = B_LOC if tiled else WORLD * B_LOC
    out = []
    for _ in range(STEPS):
        ident = rng.integers(0, 8, n)
        images = (templates[ident] + 0.3 * rng.standard_normal(
            (n, IMG, IMG, 3))).astype(np.float32)
        labels = (ident * 37 % NCLS).astype(np.int32)
        if tiled:
            images = np.tile(images, (WORLD, 1, 1, 1))
            labels = np.tile(labels, WORLD)
        out.append((images, labels))
    return out


@pytest.fixture(scope="module")
def flax_variables():
    enc = jax_resnet.ResNet(layers=LAYERS, emd_size=EMB)
    variables = jax.jit(lambda k: enc.init(
        k, jnp.zeros((1, IMG, IMG, 3), jnp.float32), train=True))(
        jax.random.key(0))
    return enc, variables


def _jax_start(variables, jcfg, optimizer):
    params = variables["params"]
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=variables["batch_stats"],
                         opt_slots=init_slots(optimizer, params),
                         pfc=init_pfc_state(jax.random.key(1), jcfg))


def _port_case(jstate, conf, fields, batches, gidx):
    """The worker's case: the port's state crossed from fr_tpu's (the
    whole head; each rank takes its shard) and the inputs."""
    model = resnet.ResNet(LAYERS, emd_size=EMB, img_size=IMG)
    state = train_state_from_jax(jstate, model, "ResNet", plan=LAYERS)
    return {"net": NET, "conf": dict(conf), "pfc": fields, "lr": LR,
            "encoder": state.encoder.state_dict(),
            "opt_slots": state.opt_slots, "weight": state.pfc.weight,
            "slots": state.pfc.slots, "count": state.pfc.count,
            "step": state.step,
            "batches": [(torch.from_numpy(x), torch.from_numpy(y))
                        for x, y in batches],
            "gidx": gidx}


def _drawn_groups(jcfg, key, step, labels, model):
    """The groups fr_tpu's step draws on each model shard
    (train/step.py:121-138, midx folded into the sample key)."""
    out = []
    lab = jnp.asarray(labels)
    for midx in range(model):
        loc = lab - midx * jcfg.num_local
        gpos, gvalid = jax_pfc.shard_group_masks(
            jcfg, midx, loc, (loc >= 0) & (loc < jcfg.num_local))
        out.append(torch.from_numpy(np.array(jax_pfc.sample_groups(
            jcfg, stream_key(key, STREAM_SAMPLE, step, midx), gpos,
            gvalid))))
    return out


def _host(jstate):
    return jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats,
        "opt_slots": jstate.opt_slots, "weight": jstate.pfc.weight,
        "slots": jstate.pfc.slots})


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def mesh_run(request, flax_variables, tmp_path_factory):
    """For one mesh: fr_tpu's states after each step of every case, and
    the port's ranks' results of the same cases plus the tiled one (the
    ranks run while fr_tpu's steps do)."""
    data, model = request.param
    enc, variables = flax_variables
    key = jax.random.key(3)
    starts, cases = {}, {}
    for name, (optimizer, rate, fused) in CASES.items():
        fields = _pfc_fields(optimizer, rate, fused)
        jcfg = jax_pfc.PFCConfig(**fields, model_size=model)
        starts[name] = _jax_start(variables, jcfg, optimizer)
        batches = _batches(0)
        # the groups fr_tpu's step i draws depend on the step count alone
        gidx = [_drawn_groups(jcfg, key, i, labels, model)
                for i, (_, labels) in enumerate(batches)]
        cases[name] = _port_case(starts[name],
                                 _conf(optimizer, rate, fused), fields,
                                 batches, gidx if jcfg.sampling else None)
    # the port against itself: tiled batches, its own draws
    fields = _pfc_fields("SGD", 0.5, False)
    jcfg = jax_pfc.PFCConfig(**fields, model_size=model)
    cases["tiled"] = _port_case(_jax_start(variables, jcfg, "SGD"),
                                _conf("SGD", 0.5, False), fields,
                                _batches(1, tiled=True), None)
    ranks = start_job(tmp_path_factory.mktemp(f"steps{data}x{model}"),
                      "steps", (data, model), cases=cases)

    jmesh = jax_make_mesh(data=data, model=model,
                          devices=jax.devices()[:WORLD])
    refs = {}
    for name, (optimizer, rate, fused) in CASES.items():
        jcfg = jax_pfc.PFCConfig(**_pfc_fields(optimizer, rate, fused),
                                 model_size=model)
        jstep = jax_make_train_step(_conf(optimizer, rate, fused), jmesh,
                                    enc, jcfg, donate=False)
        # on the shardings the step returns, so that step 2 compiles nothing
        jstate = jax.device_put(starts[name], jax.tree.map(
            lambda spec: NamedSharding(jmesh, spec),
            state_partition_specs(starts[name])))
        ref = []
        for images, labels in _batches(0):
            jstate, jm = jstep(jstate, *shard_batch(jmesh, images, labels),
                               LR, key)
            ref.append((float(jm["loss"]), float(jm["grad_norm"]),
                        _host(jstate)))
        refs[name] = (ref, _host(starts[name]))
    return (data, model), refs, cases, finish_job(ranks)


def _port_state(out, outs, step, model):
    """rank 0's encoder and slots after ``step`` and the whole head of data
    row 0, in fr_tpu's layout."""
    rec = out["steps"][step]
    enc = resnet.ResNet(LAYERS, emd_size=EMB, img_size=IMG)
    enc.load_state_dict(rec["encoder"], strict=True)

    class _S:  # what train_state_to_jax_layout reads
        pass

    s = _S()
    s.encoder, s.opt_slots, s.step = enc, rec["opt_slots"], rec["step"]
    s.pfc = _S()
    rows = [outs[m]["steps"][step] for m in range(model)]
    s.pfc.weight = torch.cat([r["weight"] for r in rows])
    s.pfc.slots = {k: torch.cat([r["slots"][k] for r in rows])
                   for k in rows[0]["slots"]}
    s.pfc.count = rec["count"]
    return train_state_to_jax_layout(s, "ResNet", plan=LAYERS)


def _check_ranks_agree(outs, name, model):
    """Every rank's encoder is bitwise rank 0's after each step; the shards
    of one model index are bitwise equal over the data rows; the losses and
    norms are the same everywhere."""
    for i in range(STEPS):
        recs = [o[name]["steps"][i] for o in outs]
        assert len({r["digest"] for r in recs}) == 1, (name, i)
        assert len({r["loss"] for r in recs}) == 1, (name, i)
        assert len({r["grad_norm"] for r in recs}) == 1, (name, i)
        for r, rec in enumerate(recs):
            twin = recs[r % model]
            assert torch.equal(rec["weight"], twin["weight"]), (name, i, r)
            for k in rec["slots"]:
                assert torch.equal(rec["slots"][k], twin["slots"][k])


def _compare(ours, ref, loss, jloss, norm, jnorm, i, adam, start_params):
    np.testing.assert_allclose(loss, jloss,
                               rtol=2e-4 if adam and i == 1 else 3e-5)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-3)
    rtol = (3e-2, 1e-1)[i]
    delta = lambda p: jax.tree.map(np.subtract, p, start_params)  # noqa
    view = _whole if adam else (lambda tree: tree)
    _assert_close(view(ours["params"]), view(ref["params"]),
                  1e-3 if adam else 2e-4, "params")
    _assert_close(ours["pfc"]["weight"], ref["weight"],
                  5e-3 if adam and i == 1 else 2e-4, "head")
    _assert_close(view(ours["batch_stats"]), view(ref["batch_stats"]), 1e-3,
                  "bn")
    _assert_close(view(delta(ours["params"])), view(delta(ref["params"])),
                  rtol, "update")
    _assert_close(view(ours["opt_slots"]), view(ref["opt_slots"]), rtol,
                  "slots")
    _assert_close(ours["pfc"]["slots"], ref["slots"], rtol, "head_slots")


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_fr_tpu(mesh_run, name):
    (data, model), refs, cases, outs = mesh_run
    ref, start = refs[name]
    _check_ranks_agree(outs, name, model)
    adam = CASES[name][0] == "AdamW"
    for i in range(STEPS):
        jloss, jnorm, jref = ref[i]
        rec = outs[0][name]["steps"][i]
        assert rec["step"] == rec["count"] == i + 1
        ours = _port_state(outs[0][name], [o[name] for o in outs], i, model)
        _compare(ours, jref, rec["loss"], jloss, rec["grad_norm"], jnorm, i,
                 adam, start["params"])
    if cases[name]["gidx"] is not None:
        # the padding rows (298 on) are masked and carry no gradient
        pad = ours["pfc"]["weight"][NCLS:] - start["weight"][NCLS:]
        assert np.abs(pad).max() <= 1e-6


def test_mesh_step_equals_one_device_step_on_the_union(mesh_run):
    """The tiled case: the M-way step's own draws, fed as one union to the
    one-device step on the same images, give the same step."""
    (data, model), _, cases, outs = mesh_run
    case = cases["tiled"]
    _check_ranks_agree(outs, "tiled", model)
    cfg = PFCConfig(**case["pfc"], model_size=model)
    ng = cfg.num_local // BLOCK
    drawn = [o["tiled"]["drawn"] for o in outs]
    for r in range(WORLD):   # one stream per model shard
        for a, b in zip(drawn[r], drawn[r % model]):
            assert torch.equal(a, b)
    one = PFCConfig(**case["pfc"])
    model_net = resnet.ResNet(LAYERS, emd_size=EMB, img_size=IMG)
    model_net.load_state_dict(case["encoder"], strict=True)
    from fr_tpu_torch.heads.partial_fc import PFCState
    from fr_tpu_torch.train.state import TrainState, stream_generators
    rows = one.num_classes_padded
    state = TrainState(
        step=0, encoder=model_net,
        opt_slots={k: {n: t.clone() for n, t in v.items()}
                   for k, v in case["opt_slots"].items()},
        pfc=PFCState(weight=case["weight"][:rows].clone(),
                     slots={k: v[:rows].clone()
                            for k, v in case["slots"].items()}),
        generators=stream_generators(0, "cpu"))
    step = make_train_step(Config(case["conf"]), one, "cpu")
    start = train_state_to_jax_layout(state, "ResNet", plan=LAYERS)
    for i, (images, labels) in enumerate(case["batches"]):
        union = torch.cat([drawn[m][i] + m * ng for m in range(model)])
        assert union.max() < rows // BLOCK
        m = step(state, images[:B_LOC], labels[:B_LOC], LR,
                 sample_gidx=union)
        rec = outs[0]["tiled"]["steps"][i]
        ours = _port_state(outs[0]["tiled"], [o["tiled"] for o in outs], i,
                           model)
        one_dev = train_state_to_jax_layout(state, "ResNet", plan=LAYERS)
        ref = {"params": one_dev["params"],
               "batch_stats": one_dev["batch_stats"],
               "opt_slots": one_dev["opt_slots"],
               "weight": one_dev["pfc"]["weight"],
               "slots": one_dev["pfc"]["slots"]}
        ours["pfc"]["weight"] = ours["pfc"]["weight"][:rows]
        ours["pfc"]["slots"] = {k: v[:rows]
                                for k, v in ours["pfc"]["slots"].items()}
        _compare(ours, ref, rec["loss"], m["loss"].item(), rec["grad_norm"],
                 m["grad_norm"].item(), i, False, start["params"])
