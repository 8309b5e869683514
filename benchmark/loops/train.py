"""Closed-loop training traffic: one client drives the program's training
step as its ``Trainer`` does, batch after batch from the card-resident
corpus, with no synchronise between steps.

The program's entry is ``FaceRecognitionTask.training_step``, fed by
``DeviceCorpusLoader.epoch(e)``; the corpus holds ``steps_per_epoch`` ×
batch uint8 images of the seed and labels uniform over the classes, the
loader reshuffles it each epoch, and the on-device augmentation runs in
the step. The task's epoch is held at the end of the schedule's warm-up,
where its learning rate is the configuration's ``lr``.

Set-up builds the task, loads the benchmark's weights and class table into
it, and drives it through ``recorded_steps`` steps of the window's own
call and feed, keeping each batch, the generators' states before it and
the program's readings (losses, the first step's change of the
optimizer's read slot, the change of every leaf after the last recorded
step); ``warmup_steps`` more steps follow. Once the window (and any traced
steps) has closed, one more step of the same call and feed is recorded
from a copy of the program's state before it (encoder, the optimizer's
slots and step counts, class table and its slots), so that the path the
window timed, after its warm-up, is compared too. The reference then
follows the first steps from the seed's weights and the last step from
that copy (``reference/train.py``). The optimizer's module
(``reference/optimizers/<name>.py``) names the slots, the one read and
its decay, and the keys of the program's configuration it states.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import inputs
from benchmark.reference import train as plain
from benchmark.reference.train import optimizer

READINGS = ("loss_gap", "loss1_gap", "grad1_gap", "grad1_median_gap",
            "change3_gap", "change3_median_gap", "grad1_diff",
            "grad1_leaf_diff", "head_grad1_diff", "last_loss_gap",
            "last_grad_gap",
            "last_grad_median_gap", "last_head_grad_diff")


def program_conf(cfg: dict):
    """The program's configuration for cfg, refused where it departs from
    what the benchmark's configuration states."""
    from fr_tpu_torch.configs import load_config
    head, opt, model = cfg["head"], cfg["optimizer"], cfg["model"]
    optim = optimizer(opt)
    prog = cfg["program"]
    conf = load_config(prog["config"], **prog["overrides"])
    stated = {"n_classes": head["num_classes"], "emd_size": head["emd_size"],
              "loss_s": head["s"], "loss_m": head["m"],
              "metric": head["margin"], "optimizer_name": opt["name"],
              **optim.program_keys(opt), "img_size": model["img_size"],
              "mixed_precision": cfg["precision"] == "bfloat16",
              "b": cfg["batch_size"]}
    for key, want in stated.items():
        if conf.get(key) != want:
            raise ValueError(f"the program's {key} is {conf.get(key)!r}, "
                             f"the configuration states {want!r}")
    return conf


def load_weights(encoder: torch.nn.Module, values: Dict[str, torch.Tensor]
                 ) -> None:
    """Copies the benchmark's parameters and BN statistics into the
    program's encoder; its parameters must be exactly the configuration's."""
    params = dict(encoder.named_parameters())
    buffers = dict(encoder.named_buffers())
    want = {n for n in values if not n.endswith(("running_mean",
                                                 "running_var"))}
    if set(params) != want:
        raise ValueError(
            "the program's parameters are not the configuration's: "
            f"missing {sorted(want - set(params))[:5]}, "
            f"extra {sorted(set(params) - want)[:5]}")
    with torch.no_grad():
        for name, v in values.items():
            target = params.get(name)
            if target is None:
                target = buffers[name]
            if target.shape != v.shape:
                raise ValueError(f"{name}: {tuple(target.shape)} in the "
                                 f"program, {tuple(v.shape)} stated")
            target.copy_(v)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch._foreach_norm([tensors[n].float() for n in names])
    return dict(zip(names, torch.stack(vals).tolist()))


def _feed(loader):
    epoch = 0
    while True:
        yield from loader.epoch(epoch)
        epoch += 1


class Loop:
    kind = "train"
    # the reference's steps, and each side that stands in the program's
    # place by the keyword arguments it gives them (``readings``)
    reference = staticmethod(plain.train_steps)
    VARIANTS = {"reference": {}, "control": {"q": plain.fp8_rounding},
                "half_batch": {"half_batch": True},
                "bf16": {"q": plain.bf16_rounding},
                "bf16_attention": {"q": plain.bf16_attention}}

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.optim = optimizer(cfg["optimizer"])

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from fr_tpu_torch.data.device_corpus import DeviceCorpusLoader
        from fr_tpu_torch.train.task import FaceRecognitionTask
        cfg, dev, seed = self.cfg, self.device, self.seed
        conf = program_conf(cfg)
        task = FaceRecognitionTask(conf, stage="train", device=dev, seed=seed)
        task.epoch = conf.warmup_steps
        if task.schedule(task.epoch) != cfg["optimizer"]["lr"]:
            raise ValueError("the schedule's lr at the end of warm-up is "
                             f"{task.schedule(task.epoch)}")
        pfc = task.state.pfc
        if (pfc.weight.shape[0] != cfg["head"]["padded_classes"]
                or task.pfc_cfg.num_sample != cfg["head"]["sampled_columns"]):
            raise ValueError("the program's head is not the configuration's")
        params0 = inputs.encoder_params(cfg["model"], seed, dev)
        load_weights(task.encoder, params0)
        table0 = inputs.class_table(cfg["head"], seed, dev)
        with torch.no_grad():
            pfc.weight.copy_(table0)
        b = cfg["batch_size"]
        images, labels = inputs.corpus(self.traffic["steps_per_epoch"] * b,
                                       cfg["model"]["img_size"],
                                       cfg["head"]["num_classes"], seed)
        self.loader = DeviceCorpusLoader(images, labels, b, seed=seed,
                                         device=dev)
        del images, labels
        self.task, self.feed = task, _feed(self.loader)
        self.batch = b

        self.names = names = [n for n, _ in task.encoder.named_parameters()]
        read = self.optim.READ
        self.recorded, losses = [], []
        for k in range(self.traffic["recorded_steps"]):
            batch = next(self.feed)
            self.recorded.append({
                "images": batch[0].clone(), "labels": batch[1].clone(),
                "states": {n: g.get_state()
                           for n, g in task.state.generators.items()}})
            losses.append(task.training_step(batch)["loss"])
            if k == 0:
                # the read slot's change over a first step from zero
                slot = task.state.opt_slots[read]
                grad1 = _norms({n: slot[n] for n in names})
                grad1["head"] = float(torch.linalg.vector_norm(
                    pfc.slots[read]))
                # kept on the host, out of the window's memory
                mom1 = {n: slot[n].detach().to("cpu", copy=True)
                        for n in names}
                head_slot = pfc.slots[read]
                rows = torch.nonzero(head_slot.abs().amax(dim=1) > 0)[:, 0]
                head1 = (rows.cpu(), head_slot.index_select(0, rows).cpu())
        now = dict(task.encoder.named_parameters())
        change = _norms({n: now[n].detach() - params0[n] for n in names})
        change["head"] = float(torch.linalg.vector_norm(pfc.weight - table0))
        self.program = {"loss": [float(x) for x in losses], "grad1": grad1,
                        "change3": change, "mom1": mom1, "head1": head1}
        del params0, table0, now
        for _ in range(self.traffic["warmup_steps"]):
            task.training_step(next(self.feed))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- the measured window ----------------------------------------------
    def _step(self, waits, hosts, losses):
        a = time.perf_counter()
        batch = next(self.feed)
        b = time.perf_counter()
        losses.append(self.task.training_step(batch)["loss"])
        c = time.perf_counter()
        waits.append(b - a)
        hosts.append(c - b)
        return c

    def window(self, seconds: float) -> dict:
        waits, hosts, losses = [], [], []
        t0 = time.perf_counter()
        while self._step(waits, hosts, losses) - t0 < seconds:
            pass
        self._sync()
        elapsed = time.perf_counter() - t0
        finite = torch.isfinite(torch.stack(losses)).tolist()
        return {"steps": len(losses), "elapsed": elapsed,
                "rate": len(losses) * self.batch / elapsed,
                "waits": waits, "hosts": hosts,
                "failed": finite.count(False)}

    def traced(self, steps: int) -> dict:
        """Host seconds of ``steps`` steps under the profiler."""
        waits, hosts, losses = [], [], []
        self._sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            self._step(waits, hosts, losses)
        self._sync()
        return {"steps": steps, "elapsed": time.perf_counter() - t0}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def after_window(self) -> None:
        """Records one more step of the window's call and feed, from a copy
        on the card of the program's state before it."""
        task, names, optim = self.task, self.names, self.optim
        pfc = task.state.pfc
        enc = dict(task.encoder.named_parameters())
        with torch.no_grad():
            snap = {
                "params": {n: v.detach().clone()
                           for n, v in task.encoder.named_buffers()
                           if n.endswith(("running_mean", "running_var"))},
                "slots": {s: {n: v.clone() for n, v in
                              task.state.opt_slots[s].items() if n in enc}
                          for s in optim.SLOTS},
                "table": pfc.weight.detach().clone(),
                "head_slots": {s: pfc.slots[s].clone() for s in optim.SLOTS},
                "count": task.state.step, "head_count": pfc.count}
            snap["params"].update({n: enc[n].detach().clone()
                                   for n in names})
        batch = next(self.feed)
        step = {"images": batch[0].clone(), "labels": batch[1].clone(),
                "states": {n: g.get_state()
                           for n, g in task.state.generators.items()}}
        loss = task.training_step(batch)["loss"]
        read, decay = optim.READ, optim.decay(self.cfg["optimizer"])
        with torch.no_grad():
            slot, old = task.state.opt_slots[read], snap["slots"][read]
            delta = _norms({n: slot[n] - old[n] for n in names})
            head_slot, head_old = pfc.slots[read], snap["head_slots"][read]
            moved = head_slot - head_old
            rows = torch.nonzero(moved.abs().amax(dim=1) > 0)[:, 0]
            delta["head"] = float(torch.linalg.vector_norm(moved))
            del moved
            # what the step added to the decayed slot, s − decay·s₀, on
            # the rows it moved
            head = (rows, head_slot.index_select(0, rows)
                    - decay * head_old.index_select(0, rows))
        self.last = {"step": step, "snap": snap,
                     "program": {"loss": [float(loss)], "grad1": delta,
                                 "head1": head}}

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        del self.task, self.loader, self.feed

    # -- correctness --------------------------------------------------------
    def readings(self, sides=("program",)) -> Dict[str, Dict[str, float]]:
        """{side: its numbers compared} against the reference: the first
        steps from the seed, and the step recorded after the window from
        the copy of the program's state. The sides: "program" (the recorded
        readings), "control" (the reference with every product's operands
        rounded to float8 e4m3 in the program's place), "half_batch" (the
        reference with the loss taken over half of each batch, a planted
        fault), and two witnesses of the program's own precision, "bf16"
        (every product's operands and gradients rounded to bfloat16) and
        "bf16_attention" (the window attention's products alone); a mesh's
        loop adds its own (``VARIANTS``)."""
        others = ["reference"] + [s for s in sides if s != "program"]
        snap = self.last.pop("snap")
        last = {}
        with plain.no_tf32():
            for v in others:
                last[v] = self.reference(
                    self.cfg, snap["params"], snap["table"],
                    [self.last["step"]], start=snap, **self.VARIANTS[v])
        del snap
        dev = self.device
        params0 = inputs.encoder_params(self.cfg["model"], self.seed, dev)
        table0 = inputs.class_table(self.cfg["head"], self.seed, dev)
        first = {}
        with plain.no_tf32():
            for v in others:
                first[v] = self.reference(self.cfg, params0, table0,
                                          self.recorded, **self.VARIANTS[v])
        first["program"], last["program"] = self.program, \
            self.last["program"]
        self.raw = {"first": first, "last": last}
        return {side: {**compare(first[side], first["reference"]),
                       **compare_last(last[side], last["reference"])}
                for side in sides}


def _leaf_gaps(side: Dict[str, float], ref: Dict[str, float],
               leaves) -> list:
    """Per leaf, |side − ref| against the reference's norm of that leaf or
    of the median leaf, whichever is larger; largest first."""
    med = float(torch.tensor([ref[n] for n in leaves]).median())
    return sorted((abs(side[n] - ref[n]) / max(ref[n], med, 1e-30)
                   for n in leaves), reverse=True)


def _rows_diff(side, ref) -> float:
    """‖side − ref‖ / ‖ref‖ of two sets of table rows (sorted row ids,
    values); a row that only one side holds counts whole."""
    (rp, vp), (rr, vr) = side, ref
    dev = vr.device
    rp, vp = rp.to(dev), vp.to(dev)
    cp, cr = torch.isin(rp, rr), torch.isin(rr, rp)
    d2 = (torch.sum((vp[cp] - vr[cr]) ** 2) + torch.sum(vp[~cp] ** 2)
          + torch.sum(vr[~cr] ** 2))
    return float(torch.sqrt(d2 / torch.sum(vr * vr)))


def _moving(ref: dict) -> list:
    """The leaves whose first reference gradient is not nought to
    rounding: at least a thousandth of the median leaf's."""
    leaves = list(ref["grad1"])
    gmed = float(torch.tensor([ref["gnorm1"][n] for n in leaves]).median())
    return [n for n in leaves if ref["gnorm1"][n] >= 1e-3 * gmed]


def _slot_diffs(side: dict, ref: dict) -> Dict[str, tuple]:
    """{leaf: (‖m − m_ref‖², ‖m_ref‖²)} of the encoder's read slot after
    the first step."""
    out = {}
    for n, want in ref["mom1"].items():
        got = side["mom1"][n].to(want.device)
        out[n] = (float(torch.sum((got - want) ** 2)),
                  float(torch.sum(want * want)))
    return out


def compare(side: dict, ref: dict) -> Dict[str, float]:
    """The numbers a training cell may compare, each a gap against the
    reference (a cell's limits name those it compares):

    - ``loss_gap``: the largest relative gap of the recorded steps' losses;
      ``loss1_gap``: the first step's;
    - ``grad1_gap`` / ``grad1_median_gap``: the worst leaf's and the median
      leaf's gap of the first gradient's norms (the optimizer's read slot
      after one step from zero: the gradient as the optimizer takes it),
      the leaves being the encoder's parameters and the class table;
    - ``change3_gap`` / ``change3_median_gap``: the same of the norms of
      the change after the recorded steps, over the leaves whose reference
      gradient is not nought to rounding (at least a thousandth of the
      median leaf's);
    - ``grad1_diff``: ‖m − m_ref‖ / ‖m_ref‖ of the encoder's read slot
      after the first step, taken whole, element by element;
      ``grad1_leaf_diff``: leaf by leaf, ‖m − m_ref‖ over the norm of
      the reference's first gradient of that leaf, of the leaf where it
      is least, over the leaves whose reference gradient is not nought to
      rounding: the best-determined leaf's gradient, which a gradient of
      another batch turns even where the global clip gives its norms back
      (with SGD m − m_ref is g − g_ref, the weight decay's part being the
      same on both sides);
    - ``head_grad1_diff``: the same of the class table's read slot,
      over the rows either side moved. It is a function of the first
      step's embeddings and drawn rows, so it reads the forward's
      precision where the encoder's gradient, chaotic under any rounding
      (ReLU and max-pool choices flip), does not.

    A norm gap is taken against the reference's norm of that leaf or of
    the median leaf, whichever is larger."""
    losses = [abs(a - b) / abs(b) for a, b in zip(side["loss"], ref["loss"])]
    leaves, moving = list(ref["grad1"]), _moving(ref)
    g1 = _leaf_gaps(side["grad1"], ref["grad1"], leaves)
    c3 = _leaf_gaps(side["change3"], ref["change3"], moving)
    diff = num = 0.0
    leaf_diffs = []
    for n, (d2, w2) in _slot_diffs(side, ref).items():
        diff += d2
        num += w2
        if n in moving:
            leaf_diffs.append(d2 ** 0.5 / ref["gnorm1"][n])
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad1_gap": g1[0], "grad1_median_gap": g1[len(g1) // 2],
            "change3_gap": c3[0], "change3_median_gap": c3[len(c3) // 2],
            "grad1_diff": (diff / num) ** 0.5,
            "grad1_leaf_diff": min(leaf_diffs),
            "head_grad1_diff": _rows_diff(side["head1"], ref["head1"])}


def compare_last(side: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the step recorded after the window, each a gap
    against the reference's step from the same copy of the program's
    state: ``last_loss_gap``, the loss's relative gap;
    ``last_grad_gap`` / ``last_grad_median_gap``, the worst and the median
    leaf's gap of the norms of the read slot's change over the step (a
    step that leaves the state unchanged reads 1); ``last_head_grad_diff``,
    ‖G − G_ref‖ / ‖G_ref‖ of the class table's gradient as the optimizer
    took it, G = s − d·s₀ (s the read slot, d its decay), over the rows
    either side moved (a step that moves no row reads 1). The gradient,
    not the slot's change, since d·s₀ is common to both sides and would
    hide a change of precision."""
    leaves = list(ref["grad1"])
    g = _leaf_gaps(side["grad1"], ref["grad1"], leaves)
    return {"last_loss_gap": abs(side["loss"][0] - ref["loss"][0])
            / abs(ref["loss"][0]),
            "last_grad_gap": g[0], "last_grad_median_gap": g[len(g) // 2],
            "last_head_grad_diff": _rows_diff(side["head1"], ref["head1"])}


def explain(side: dict, ref: dict, top: int = 6) -> dict:
    """For a look at what drives the numbers: each step's loss gap, and
    per reading the leaves with the largest gaps (name, gap, side's norm,
    reference's norm, reference's first gradient) and the median leaf's
    gap."""
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                         zip(side["loss"], ref["loss"])]}
    for key in ("grad1", "change3"):
        if key not in side:
            continue
        leaves = list(ref[key])
        med = float(torch.tensor([ref[key][n] for n in leaves]).median())
        gaps = sorted(((abs(side[key][n] - ref[key][n])
                        / max(ref[key][n], med, 1e-30), n) for n in leaves),
                      reverse=True)
        out[key] = [[n, g, side[key][n], ref[key][n], ref["gnorm1"][n]]
                    for g, n in gaps[:top]]
        out[key + "_median_gap"] = gaps[len(gaps) // 2][0]
        if key == "grad1":
            # how far the read slot's change is a small difference of the
            # gradient and the decayed slot: ‖Δs‖ / ‖g‖ per leaf
            ratios = sorted(ref[key][n] / max(ref["gnorm1"][n], 1e-30)
                            for n in leaves)
            out["grad1_over_g_median"] = ratios[len(ratios) // 2]
    if "mom1" in side:
        # every moving leaf's ‖m − m_ref‖ / ‖g_ref‖ and its size, in the
        # order of the encoder's parameters
        diffs = _slot_diffs(side, ref)
        out["grad1_leaf_diffs"] = [
            [n, diffs[n][0] ** 0.5 / ref["gnorm1"][n],
             int(ref["mom1"][n].numel())] for n in _moving(ref)
            if n in diffs]
    return out
