"""Closed-loop training traffic on a mesh of ranks, one process a card: the
train loop (``loops/train.py``) with the class table sharded over the
mesh's model axis, as the program's ``FaceRecognitionTask`` runs on this
rank of its ``Mesh``.

Every rank builds the task on its own card, loads the benchmark's weights
and its shard of the benchmark's class table, and feeds its stripe of the
corpus: ``DeviceCorpusLoader(process_index=rank, process_count=ranks)``
over ``steps_per_epoch`` global batches of ``batch_size`` images a rank,
every label of the global batch beside them. Set-up drives the recorded
and the warm-up steps as the one-card loop does; rank 0 times the second
half of the warm-up steps, and the window's count of steps is fixed from
that time, with a tenth to spare, before the window opens and broadcast
once, so that every rank runs exactly as many steps with no exchange in
them beyond the program's own. The window opens after a barrier and
closes after the last step, a synchronise and a barrier, on rank 0's
clock.

What the check needs crosses to rank 0 after the window: every rank's
recorded images and generators' states, the table's shards and their
slots in global row order, and the head's rows that each shard's steps
moved, with their global ids. The encoder and its slots are rank 0's, the
same on every rank. Rank 0 alone then runs the reference
(``reference/train_mesh.py``): the undistributed step over the global
batch, BatchNorm's statistics over each rank's images, each shard's draw
from its own generator's state. Only the mesh (data 1, model n) is run.
"""

from __future__ import annotations

import math
import time
from typing import List

import torch
import torch.distributed as dist

from benchmark import inputs
from benchmark.harness import BenchError
from benchmark.loops import train
from benchmark.loops.train import _feed, _norms, load_weights
from benchmark.reference import train_mesh as plain_mesh

# rows a chunk when a shard of the table crosses to rank 0
GATHER_ROWS = 1 << 16
# the window's count of steps is fixed from the warm-up's time a step with
# this much to spare, so that the window lasts at least ``seconds``
WINDOW_MARGIN = 1.1


class Loop(train.Loop):
    # rank 0 reads the sides of the one-card loop against the
    # undistributed reference, and three more planted faults: each rank
    # stepping on its own images' encoder gradient ("no_grad_sum"; rank
    # 0's is compared), the sum left out for the encoder's last leaves
    # that hold a quarter of its parameters ("part_grad_sum"), and each
    # shard's CE over its own rank's rows alone, no all-gather
    # ("local_head")
    reference = staticmethod(plain_mesh.train_steps)
    VARIANTS = {**train.Loop.VARIANTS,
                "no_grad_sum": {"no_grad_sum": True},
                "part_grad_sum": {"part_grad_sum": True},
                "local_head": {"local_head": True}}

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, mesh):
        super().__init__(cfg, traffic, seed, device)
        if mesh.data != 1:
            raise BenchError("the mesh loop runs the mesh (data 1, model n) "
                             f"only, not ({mesh.data}, {mesh.model})")
        self.mesh = mesh
        self.rank, self.ranks = mesh.rank, mesh.size
        self.lead = self.rank == 0

    # -- exchanges of the harness (never inside the window) ----------------
    def barrier(self) -> None:
        flag = torch.ones(1, device=self.device)
        dist.all_reduce(flag)
        self._sync()

    def total(self, x: float, op=dist.ReduceOp.SUM) -> float:
        t = torch.tensor([float(x)], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op)
        return float(t)

    def gather(self, x: torch.Tensor, host: bool = True):
        """Rank 0: every rank's ``x`` (equal shapes) concatenated in rank
        order along axis 0, on the host (or on rank 0's device), crossing
        ``GATHER_ROWS`` rows at a time; None on the other ranks."""
        rows = x.shape[0]
        keep = torch.device("cpu") if host else self.device
        out = (torch.empty((self.ranks * rows,) + tuple(x.shape[1:]),
                           dtype=x.dtype, device=keep)
               if self.lead else None)
        for a in range(0, rows, GATHER_ROWS):
            b = min(rows, a + GATHER_ROWS)
            part = x[a:b].contiguous()
            got = torch.empty((self.ranks * (b - a),) + tuple(part.shape[1:]),
                              dtype=part.dtype, device=part.device)
            dist.all_gather_into_tensor(got, part)
            if self.lead:
                got = got.to(keep).view((self.ranks,) + tuple(part.shape))
                for r in range(self.ranks):
                    out[r * rows + a:r * rows + b] = got[r]
        return out

    def gather_uneven(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Rank 0: each rank's ``x`` (its own number of rows), on the host;
        an empty list on the other ranks."""
        n = torch.tensor([x.shape[0]], dtype=torch.int64, device=self.device)
        counts = torch.empty(self.ranks, dtype=torch.int64,
                             device=self.device)
        dist.all_gather_into_tensor(counts, n)
        counts = counts.tolist()
        pad = torch.zeros((max(counts),) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        pad[:x.shape[0]] = x
        got = self.gather(pad)
        if not self.lead:
            return []
        m = max(counts)
        return [got[r * m:r * m + c] for r, c in enumerate(counts)]

    def objects(self, obj):
        """Rank 0: every rank's picklable ``obj`` in rank order."""
        out = [None] * self.ranks
        dist.all_gather_object(out, obj)
        return out if self.lead else None

    def _moved_rows(self, slot: torch.Tensor, rows: torch.Tensor,
                    values: torch.Tensor):
        """Rank 0: (sorted global row ids, values) of the rows that the
        shards report, every shard's in turn; None elsewhere."""
        start = self.mesh.model_idx * slot.shape[0]
        ids = self.gather_uneven(rows + start)
        vals = self.gather_uneven(values)
        if not self.lead:
            return None
        return torch.cat(ids), torch.cat(vals)

    def _step_record(self, batch) -> dict:
        """This rank's part of a step, gathered: rank 0 gets {"images":
        [each rank's uint8 images], "labels": the global labels, "states":
        [each rank's generators' states]}."""
        gens = self.task.state.generators
        mine = {"images": batch[0].detach().cpu().clone(),
                "states": {n: g.get_state() for n, g in gens.items()}}
        every = self.objects(mine)
        if not self.lead:
            return {}
        return {"images": [m["images"] for m in every],
                "labels": batch[1].detach().cpu().clone(),
                "states": [m["states"] for m in every]}

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from fr_tpu_torch.data.device_corpus import DeviceCorpusLoader
        from fr_tpu_torch.train.task import FaceRecognitionTask
        cfg, dev, seed, mesh = self.cfg, self.device, self.seed, self.mesh
        head = cfg["head"]
        b_global = cfg["batch_size"] * self.ranks
        conf = train.program_conf({**cfg, "batch_size": b_global})
        task = FaceRecognitionTask(conf, stage="train", device=dev, seed=seed,
                                   mesh=mesh)
        task.epoch = conf.warmup_steps
        if task.schedule(task.epoch) != cfg["optimizer"]["lr"]:
            raise ValueError("the schedule's lr at the end of warm-up is "
                             f"{task.schedule(task.epoch)}")
        pfc, pcfg = task.state.pfc, task.pfc_cfg
        n_local = head["padded_classes"] // mesh.model
        if (pcfg.num_classes_padded != head["padded_classes"]
                or pfc.weight.shape[0] != n_local
                or pcfg.num_sample != head["sampled_columns"]):
            raise ValueError(
                "the program's head is not the configuration's: "
                f"{pcfg.num_classes_padded} rows padded, "
                f"{pfc.weight.shape[0]} a shard, {pcfg.num_sample} drawn a "
                f"shard; stated {head['padded_classes']}, {n_local}, "
                f"{head['sampled_columns']}")
        params0 = inputs.encoder_params(cfg["model"], seed, dev)
        load_weights(task.encoder, params0)
        lo = mesh.model_idx * n_local
        table0 = inputs.class_table(head, seed, dev)[lo:lo + n_local].clone()
        with torch.no_grad():
            pfc.weight.copy_(table0)
        images, labels = inputs.corpus(
            self.traffic["steps_per_epoch"] * b_global,
            cfg["model"]["img_size"], head["num_classes"], seed)
        self.loader = DeviceCorpusLoader(
            images, labels, b_global, seed=seed, device=dev,
            process_index=self.rank, process_count=self.ranks)
        del images, labels
        self.task, self.feed = task, _feed(self.loader)
        self.batch = b_global

        self.names = names = [n for n, _ in task.encoder.named_parameters()]
        read = self.optim.READ
        self.recorded, losses = [], []
        for k in range(self.traffic["recorded_steps"]):
            batch = next(self.feed)
            self.recorded.append(self._step_record(batch))
            losses.append(task.training_step(batch)["loss"])
            if k == 0:
                slot = task.state.opt_slots[read]
                grad1 = _norms({n: slot[n] for n in names})
                head_slot = pfc.slots[read]
                grad1["head"] = math.sqrt(self.total(
                    float(torch.linalg.vector_norm(head_slot)) ** 2))
                mom1 = ({n: slot[n].detach().to("cpu", copy=True)
                         for n in names} if self.lead else None)
                rows = torch.nonzero(head_slot.abs().amax(dim=1) > 0)[:, 0]
                head1 = self._moved_rows(head_slot, rows,
                                         head_slot.index_select(0, rows))
        now = dict(task.encoder.named_parameters())
        change = _norms({n: now[n].detach() - params0[n] for n in names})
        change["head"] = math.sqrt(self.total(
            float(torch.linalg.vector_norm(pfc.weight - table0)) ** 2))
        self.program = {"loss": [float(x) for x in losses], "grad1": grad1,
                        "change3": change, "mom1": mom1, "head1": head1}
        del params0, table0, now
        warm = self.traffic["warmup_steps"]
        timed = max(1, warm // 2)
        for _ in range(warm - timed):
            task.training_step(next(self.feed))
        self._sync()
        t0 = time.perf_counter()
        for _ in range(timed):
            task.training_step(next(self.feed))
        self._sync()
        self.step_s = (time.perf_counter() - t0) / timed

    # -- the measured window ----------------------------------------------
    def window(self, seconds: float) -> dict:
        """Exactly the broadcast count of steps on every rank, between two
        barriers; the rate is the global batch's images over rank 0's
        clock."""
        count = torch.tensor(
            [max(1, math.ceil(WINDOW_MARGIN * seconds / self.step_s))
             if self.lead else 0], dtype=torch.int64, device=self.device)
        dist.broadcast(count, 0)
        count = int(count)
        waits, hosts, losses = [], [], []
        self.barrier()
        t0 = time.perf_counter()
        for _ in range(count):
            self._step(waits, hosts, losses)
        self.barrier()
        elapsed = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses)).tolist()
        return {"steps": count, "elapsed": elapsed,
                "rate": count * self.batch / elapsed,
                "waits": waits, "hosts": hosts,
                "failed": finite.count(False)}

    def traced(self, steps: int) -> dict:
        waits, hosts, losses = [], [], []
        self.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            self._step(waits, hosts, losses)
        self.barrier()
        return {"steps": steps, "elapsed": time.perf_counter() - t0}

    def after_window(self) -> None:
        """Records one more step of the window's call and feed, from a copy
        of the program's state before it: rank 0's encoder and slots, and
        every shard of the table and of its slots, on rank 0's card."""
        task, names, optim = self.task, self.names, self.optim
        pfc = task.state.pfc
        enc = dict(task.encoder.named_parameters())
        with torch.no_grad():
            snap = {
                "table": self.gather(pfc.weight.detach(), host=False),
                "head_slots": {s: self.gather(pfc.slots[s], host=False)
                               for s in optim.SLOTS},
                "count": task.state.step, "head_count": pfc.count}
            if self.lead:
                snap["params"] = {
                    n: v.detach().clone()
                    for n, v in task.encoder.named_buffers()
                    if n.endswith(("running_mean", "running_var"))}
                snap["params"].update({n: enc[n].detach().clone()
                                       for n in names})
                snap["slots"] = {s: {n: v.clone() for n, v in
                                     task.state.opt_slots[s].items()
                                     if n in enc} for s in optim.SLOTS}
            head_old = {s: pfc.slots[s].clone() for s in optim.SLOTS}
        batch = next(self.feed)
        step = self._step_record(batch)
        loss = task.training_step(batch)["loss"]
        read, decay = optim.READ, optim.decay(self.cfg["optimizer"])
        with torch.no_grad():
            delta = None
            if self.lead:
                slot, old = task.state.opt_slots[read], snap["slots"][read]
                delta = _norms({n: slot[n] - old[n] for n in names})
            head_slot, old = pfc.slots[read], head_old[read]
            moved = head_slot - old
            rows = torch.nonzero(moved.abs().amax(dim=1) > 0)[:, 0]
            moved_sq = self.total(float(torch.linalg.vector_norm(moved)) ** 2)
            del moved
            head = self._moved_rows(
                head_slot, rows, head_slot.index_select(0, rows)
                - decay * old.index_select(0, rows))
            if self.lead:
                delta["head"] = math.sqrt(moved_sq)
        del head_old
        loss = float(loss)
        self.last = {"step": step, "snap": snap if self.lead else None,
                     "program": {"loss": [loss], "grad1": delta,
                                 "head1": head}}
