"""Worker of the port's multi-process CPU tests: one rank of a gloo process
group, run by tests/test_torch_mesh.py, test_torch_multigpu_step.py and
test_torch_checkpoint_mesh.py as

    python tests/torch_multigpu_worker.py <job file> <rank>

The job file (torch.save of plain tensors, numbers, strings, lists and
dicts, written by the test) names the job, the world size, the file:// store
and the output prefix; rank r writes its results to "<out>.<r>". The ranks
meet through a file store under the test's tmp_path, never a TCP port, so
several pytest workers can spawn at once. Each rank runs torch on one
thread. This module imports neither jax nor anything of fr_tpu: a spawned
rank is a process of the port alone.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from fr_tpu_torch.configs.base import Config  # noqa: E402
from fr_tpu_torch.heads.partial_fc import PFCConfig, PFCState  # noqa: E402
from fr_tpu_torch.models.resnet import ResNet  # noqa: E402
from fr_tpu_torch.parallel import collectives as C  # noqa: E402
from fr_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from fr_tpu_torch.train.state import TrainState  # noqa: E402
from fr_tpu_torch.train.state import stream_generators  # noqa: E402


def seeded(seed, *shape):
    """The same float32 tensor in every process (and in the test)."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def digest(module: torch.nn.Module) -> str:
    """sha256 of every parameter's and buffer's bytes, in state-dict
    order."""
    h = hashlib.sha256()
    for t in module.state_dict().values():
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def small_resnet(spec):
    return ResNet(tuple(spec["layers"]), emd_size=spec["emb"],
                  img_size=spec["img"])


def job_collectives(job, mesh):
    """all_gather over the model group and its backward, psum and its
    backward, pmax, pmean over the data group and the world, and
    embed_global_batch, on seeded inputs (the test computes each in one
    process)."""
    from fr_tpu_torch.train.step import embed_global_batch, make_embed_step

    n, d = job["rows"], job["dim"]
    r = mesh.rank
    x = seeded(100 + r, n, d).requires_grad_(True)
    g = seeded(200 + r, mesh.model * n, d)
    y = C.all_gather(x, mesh.model_group)
    (y * g).sum().backward()
    out = {"gathered": y.detach(), "gather_grad": x.grad.clone()}

    v = seeded(300 + r, n).requires_grad_(True)
    w = seeded(400 + mesh.data_idx, n)       # replicated over the row
    z = C.psum(v, mesh.model_group)
    (z * w).sum().backward()
    out.update(psum=z.detach(), psum_grad=v.grad.clone())
    mx = C.pmax(v, mesh.model_group)
    out.update(pmax=mx, pmax_requires_grad=mx.requires_grad)
    out.update(pmean_data=C.pmean(v, mesh.data_group),
               pmean_world=C.pmean(v, mesh.world_group))

    spec = job["net"]
    encoder = small_resnet(spec)
    encoder.load_state_dict(job["encoder"], strict=True)
    conf = Config(img_size=spec["img"])
    embed = make_embed_step(conf, encoder, "cpu")
    out["embeddings"] = torch.from_numpy(
        embed_global_batch(embed, job["images"].numpy(), mesh))
    return out


def _state(case, mesh, cfg):
    """The rank's state: the case's encoder and slots, its model shard of
    the case's whole head."""
    encoder = small_resnet(case["net"])
    encoder.load_state_dict(case["encoder"], strict=True)
    rows = slice(mesh.model_idx * cfg.num_local,
                 (mesh.model_idx + 1) * cfg.num_local)
    return TrainState(
        step=case["step"], encoder=encoder,
        opt_slots={k: {n: t.clone() for n, t in v.items()}
                   for k, v in case["opt_slots"].items()},
        pfc=PFCState(weight=case["weight"][rows].clone(),
                     slots={k: v[rows].clone()
                            for k, v in case["slots"].items()},
                     count=case["count"]),
        generators=stream_generators(0, "cpu", mesh))


def job_steps(job, mesh):
    """Each case: the training steps of its batches through make_train_step
    on this rank; per step the loss, grad_norm, the encoder's digest, the
    drawn groups, the shard's head and slots, and on rank 0 the encoder's
    state and slots."""
    from fr_tpu_torch.train.step import make_train_step, shard_batch

    results = {}
    for name, case in job["cases"].items():
        cfg = PFCConfig(**case["pfc"], model_size=mesh.model)
        state = _state(case, mesh, cfg)
        step = make_train_step(Config(case["conf"]), cfg, "cpu", mesh=mesh)
        drawn = []
        if case["gidx"] is None:
            # record the groups the step draws, from a copy of its stream
            import fr_tpu_torch.train.step as step_module
            original = step_module.sample_groups

            def recording(*args, **kwargs):
                out = original(*args, **kwargs)
                drawn.append(out.clone())
                return out

            step_module.sample_groups = recording
        per_step = []
        try:
            for i, (images, labels) in enumerate(case["batches"]):
                imgs, labs = shard_batch(mesh, images, labels)
                gidx = (None if case["gidx"] is None
                        else case["gidx"][i][mesh.model_idx])
                m = step(state, imgs, labs, case["lr"], sample_gidx=gidx)
                rec = {"loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "digest": digest(state.encoder),
                       "weight": state.pfc.weight.clone(),
                       "slots": {k: v.clone()
                                 for k, v in state.pfc.slots.items()},
                       "step": state.step, "count": state.pfc.count}
                if mesh.rank == 0:
                    rec["encoder"] = {k: v.clone() for k, v in
                                      state.encoder.state_dict().items()}
                    rec["opt_slots"] = {
                        k: {n: t.clone() for n, t in v.items()}
                        for k, v in state.opt_slots.items()}
                per_step.append(rec)
        finally:
            if case["gidx"] is None:
                step_module.sample_groups = original
        results[name] = {"steps": per_step, "drawn": drawn}
    return results


def job_checkpoint(job, mesh):
    """Save this rank's state (its head shard and slots set from the job's
    whole tables) at step 1, and restore the job's one-device save: the
    shards, the restored shards and the generators' states."""
    from fr_tpu_torch.ckpt import restore_train_state, save_train_state
    from fr_tpu_torch.heads.partial_fc import init_pfc_state
    from fr_tpu_torch.train.state import init_encoder_slots

    cfg = PFCConfig(**job["pfc"], model_size=mesh.model)
    encoder = small_resnet(job["net"])
    encoder.load_state_dict(job["encoder"], strict=True)

    def fresh():
        gen = torch.Generator().manual_seed(0)
        return TrainState(step=0, encoder=encoder,
                          opt_slots=init_encoder_slots("SGD", encoder),
                          pfc=init_pfc_state(cfg, gen, "cpu",
                                             mesh.model_idx),
                          generators=stream_generators(0, "cpu", mesh))

    state = fresh()
    rows = slice(mesh.model_idx * cfg.num_local,
                 (mesh.model_idx + 1) * cfg.num_local)
    state.pfc.weight = job["weight"][rows].clone()
    state.pfc.slots = {"momentum": job["momentum"][rows].clone()}
    state.pfc.count = state.step = 1
    state.generators["sample"].manual_seed(1000 + mesh.rank)
    saved = {"weight": state.pfc.weight.clone(),
             "slots": {k: v.clone() for k, v in state.pfc.slots.items()},
             "generators": {k: g.get_state()
                            for k, g in state.generators.items()}}
    save_train_state(job["save_dir"], state, 1, mesh)
    other = restore_train_state(job["restore_dir"], fresh(), mesh=mesh)
    return {"saved": saved, "restored": {
        "weight": other.pfc.weight, "slots": other.pfc.slots,
        "step": other.step, "count": other.pfc.count,
        "generators": {k: g.get_state()
                       for k, g in other.generators.items()}}}


def job_resume(job, mesh):
    """For each of the job's checkpoints: restore it into a fresh state of
    the sampled head (the file saved at another mesh shape), then take one
    training step of the job's batch; the sample stream's state after the
    restore, the shard's head and slots after the step and the encoder's
    digest."""
    from fr_tpu_torch.ckpt import restore_train_state
    from fr_tpu_torch.heads.partial_fc import init_pfc_state
    from fr_tpu_torch.train.state import init_encoder_slots
    from fr_tpu_torch.train.step import make_train_step, shard_batch

    cfg = PFCConfig(**job["pfc"], model_size=mesh.model)
    out = {}
    for name, save_dir in job["restore_dirs"].items():
        encoder = small_resnet(job["net"])
        encoder.load_state_dict(job["encoder"], strict=True)
        state = TrainState(step=0, encoder=encoder,
                           opt_slots=init_encoder_slots("SGD", encoder),
                           pfc=init_pfc_state(cfg, torch.Generator()
                                              .manual_seed(0), "cpu",
                                              mesh.model_idx),
                           generators=stream_generators(0, "cpu", mesh))
        restore_train_state(save_dir, state, mesh=mesh)
        sample = state.generators["sample"].get_state()
        step = make_train_step(Config(job["conf"]), cfg, "cpu", mesh=mesh)
        m = step(state, *shard_batch(mesh, *job["batch"]), job["lr"])
        out[name] = {"sample": sample, "loss": float(m["loss"]),
                     "weight": state.pfc.weight.clone(),
                     "slots": {k: v.clone()
                               for k, v in state.pfc.slots.items()},
                     "digest": digest(state.encoder)}
    return out


JOBS = {"collectives": job_collectives, "steps": job_steps,
        "checkpoint": job_checkpoint, "resume": job_resume}


def start_job(tmp_path, kind: str, mesh, **fields):
    """Spawn data·model ranks of this worker on ``kind`` with the job's
    ``fields``; ``finish_job`` collects them."""
    world = mesh[0] * mesh[1]
    tmp = Path(tmp_path)
    job = dict(fields, kind=kind, world=world, mesh=list(mesh),
               store=str(tmp / f"{kind}.store"), out=str(tmp / f"{kind}.out"))
    path = tmp / f"{kind}.job"
    torch.save(job, path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(path), str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    return kind, job["out"], procs


def finish_job(handle, timeout: float = 240) -> list:
    """Each rank's results, in rank order. Raises, with the ranks' output,
    if one fails."""
    kind, out, procs = handle
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise RuntimeError(f"rank {r} of {kind} exited {p.returncode}:"
                               f"\n{log[-4000:]}")
    return [torch.load(f"{out}.{r}", weights_only=True)
            for r in range(len(procs))]


def run_job(tmp_path, kind: str, mesh, **fields) -> list:
    """start_job, then finish_job."""
    return finish_job(start_job(tmp_path, kind, mesh, **fields))


def main(job_path: str, rank: int) -> None:
    job = torch.load(job_path, weights_only=True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{job['store']}",
                            rank=rank, world_size=job["world"])
    try:
        mesh = make_mesh(*job["mesh"])
        out = JOBS[job["kind"]](job, mesh)
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{job['out']}.{rank}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
