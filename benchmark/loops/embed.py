"""Closed-loop embedding traffic: one client calls the program's embedding
step as ``tools/embed.py`` does, each call a batch of normalised float
images from a pinned host buffer of the seed, copied in, embedded, and its
embeddings copied back to the host before the next call.

The program's entry is the function ``train.step.make_embed_step`` returns,
on an encoder built by ``models.build_encoder``, loaded with the
benchmark's weights and BN statistics by ``load_state_dict(strict=True)``
and put in evaluation mode, as the tool does. The host buffer holds
``buffers`` batches, used in turn.

After the window a sample of the calls, drawn from the seed with the last
call always in it, is compared with the reference's embeddings of the
same images.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark import inputs
from benchmark.loops.train import program_conf

READINGS = ("embed_gap",)


class Loop:
    kind = "embed"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from fr_tpu_torch.models import build_encoder
        from fr_tpu_torch.train.step import make_embed_step
        cfg, dev = self.cfg, self.device
        conf = program_conf(cfg)
        encoder = build_encoder(conf)
        state = encoder.state_dict()
        values = inputs.encoder_params(cfg["model"], self.seed, dev)
        # strict: a name the program's encoder lacks is refused
        state.update({n: v.cpu() for n, v in values.items()})
        encoder.load_state_dict(state, strict=True)
        encoder.to(dev).eval()
        self.embed = make_embed_step(conf, encoder, dev)
        self.batch = self.traffic["batch"]
        self.host = inputs.embed_images(self.traffic["buffers"], self.batch,
                                        cfg["model"]["img_size"], self.seed,
                                        dev)
        self.calls = 0
        for _ in range(self.traffic["warmup_calls"]):
            self._call()

    def _call(self):
        j = self.calls % self.host.shape[0]
        t = time.perf_counter()
        out = self.embed(self.host[j]).cpu().numpy()
        self.calls += 1
        return j, out, time.perf_counter() - t

    def window(self, seconds: float) -> dict:
        self.outputs, lat = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            j, out, dt = self._call()
            self.outputs.append((j, out))
            lat.append(dt)
        elapsed = time.perf_counter() - t0
        failed = sum(not np.isfinite(o).all() for _, o in self.outputs)
        return {"steps": len(lat), "elapsed": elapsed,
                "rate": len(lat) * self.batch / elapsed, "latencies": lat,
                "failed": failed}

    def traced(self, steps: int) -> dict:
        t0 = time.perf_counter()
        for _ in range(steps):
            self._call()
        return {"steps": steps, "elapsed": time.perf_counter() - t0}

    def after_window(self) -> None:
        """Nothing to record: the window's own outputs are compared."""

    def release(self) -> None:
        del self.embed

    def _checked(self):
        n = len(self.outputs)
        rng = np.random.default_rng([int(self.seed), inputs.STREAMS["sample"]])
        k = min(self.traffic["checked_calls"], n)
        pick = set(rng.choice(n, size=k, replace=False).tolist()) | {n - 1}
        return [self.outputs[i] for i in sorted(pick)]

    def readings(self, sides=("program",)) -> Dict[str, Dict[str, float]]:
        """{side: {"embed_gap": the widest L2 distance, over the sampled
        calls' rows, between its unit embeddings and the reference's}}.
        The sides: "program" (the window's outputs) and "control" (the
        reference with every product's operands rounded to float8 e4m3 in
        the program's place)."""
        from benchmark.reference import train as ref
        dev = self.device
        params = inputs.encoder_params(self.cfg["model"], self.seed, dev)
        gap = {side: 0.0 for side in sides}
        with ref.no_tf32():
            for j, out in self._checked():
                x = self.host[j].to(dev)
                want = ref.embed(self.cfg, params, x).cpu().numpy()
                for side in sides:
                    got = (out if side == "program" else ref.embed(
                        self.cfg, params, x, q=ref.fp8_rounding).cpu().numpy())
                    gap[side] = max(gap[side], float(
                        np.linalg.norm(got - want, axis=1).max()))
        return {side: {"embed_gap": v} for side, v in gap.items()}
