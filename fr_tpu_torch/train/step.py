"""The training step and the embedding step (counterpart of
fr_tpu/train/step.py: ``_device_step`` :103-226 with one device, the
augmentation dispatch :253-272, and :452-475, :545-559), single device.

The training step, in fr_tpu's order:
  sample the head's columns (positives forced in) → each sample's target
  column → encoder in train mode (BN batch statistics, running statistics
  updated) → f32 L2-normalise → shard_softmax_ce, mean over the batch →
  backward → clip the encoder's gradients to global norm 5 → update the
  encoder, then the head's sampled rows.
Augmentation, when configured, runs as its own call before the step.

With block-aligned sampling (sample_block > 1) the head draws aligned groups
of rows: the masks stay at group granularity, the column mask is arithmetic
on the expanded index, and the rows move through the grouped kernels of
ops/sparse_rows.py (gather, then the in-place update). The gradient is taken
with respect to the gathered rows, so the gather carries no autograd.

The head's four parts of a step (drawing and gathering the rows, the loss,
its backward, the update) run inside ``record_function`` ranges named
``pfc_head:*``, so that a profile of the step can tell the head's device
time from the encoder's; outside a profile the ranges do nothing.

Batches reach the step from the host or already on the device:
``prefetch_to_device`` copies host batches a few steps ahead on a side CUDA
stream, and a tensor already on the step's device is taken as it is.

Random numbers come from explicit generators, one per fr_tpu RNG stream
(``stream_generators``), which live in the training state so that a
checkpoint carries them; JAX and torch streams differ, so a test feeds the
JAX side's sampled columns or groups in through ``sample_idx`` /
``sample_gidx``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from fr_tpu_torch.data.augment import augment
from fr_tpu_torch.heads.partial_fc import (PFCConfig, label_columns,
                                          sample_columns, sample_groups,
                                          shard_group_masks, shard_softmax_ce,
                                          shard_valid_mask)
from fr_tpu_torch.models.common import l2_normalize
from fr_tpu_torch.ops.sparse_rows import expand_group_index, grouped_gather
from fr_tpu_torch.train.optim import (clip_by_global_norm, encoder_update,
                                      pfc_row_update)
from fr_tpu_torch.train.state import TrainState

MAX_GRAD_NORM = 5.0


def make_train_step(conf, pfc_cfg: PFCConfig, device,
                    augment_cfg: Optional[tuple] = None) -> Callable:
    """step(state, images, labels, lr, sample_idx=None, sample_gidx=None)
    → metrics.

    images: (B, H, W, 3) float32, or uint8 when augment_cfg is given; labels
    (B,) int class ids; lr a float. Updates ``state`` in place and returns
    {"loss", "grad_norm"} as device scalars and "lr". ``sample_idx`` (test
    use) replaces the drawn sampled columns with a given sorted index
    vector, ``sample_gidx`` the drawn groups of block-aligned sampling with
    given sorted group ids. The encoder and the generators are the
    state's."""
    device = torch.device(device)
    optimizer = conf.optimizer_name
    cfg = pfc_cfg
    grouped = cfg.sampling and cfg.sample_block > 1
    # the grouped path keeps every mask at group granularity
    valid = None if grouped else shard_valid_mask(cfg, device)

    def head_rows(labels, pfc, gens, sample_idx, sample_gidx):
        """(idx, gidx, col_valid, w_rows): the active rows' ids (None for
        all), their group ids under block-aligned sampling (else None), the
        mask of the real columns among them and the rows themselves."""
        if grouped:
            if sample_gidx is None:
                owned = (labels >= 0) & (labels < cfg.num_local)
                gidx = sample_groups(cfg, gens["sample"],
                                     *shard_group_masks(cfg, labels, owned))
            else:
                gidx = torch.as_tensor(sample_gidx).to(device).long()
            idx = expand_group_index(gidx, cfg.sample_block)
            return (idx, gidx, idx < cfg.num_classes,
                    grouped_gather(pfc.weight, gidx, cfg.sample_block))
        if cfg.sampling:
            if sample_idx is None:
                owned = (labels >= 0) & (labels < cfg.num_local)
                pos = torch.zeros(cfg.num_local, dtype=torch.bool,
                                  device=device)
                pos[labels[owned]] = True
                idx = sample_columns(cfg, gens["sample"], pos, valid)
            else:
                idx = torch.as_tensor(sample_idx).to(device).long()
            return idx, None, valid[idx], pfc.weight.index_select(0, idx)
        return None, None, valid, pfc.weight

    def step(state: TrainState, images, labels, lr: float,
             sample_idx=None, sample_gidx=None) -> Dict:
        gens = state.generators
        # a synchronous copy for host arrays; .to returns a tensor that is
        # already on the device (a prefetched batch) as it is
        images = torch.as_tensor(images).to(device)
        labels = torch.as_tensor(labels).to(device).long()
        if augment_cfg is not None:
            images = augment(images, augment_cfg, gens["augment"])
        pfc = state.pfc
        with record_function("pfc_head:rows"):
            idx, gidx, col_valid, w_rows = head_rows(labels, pfc, gens,
                                                     sample_idx, sample_gidx)
            label_cols = label_columns(cfg, labels, idx)

        encoder = state.encoder
        encoder.train()
        names, params = zip(*encoder.named_parameters())
        w_act = w_rows.detach().requires_grad_(True)
        emb = l2_normalize(encoder(images, gens["dropout"]).float())
        with record_function("pfc_head:loss"):
            loss = shard_softmax_ce(cfg, emb, label_cols, w_act,
                                    col_valid).mean()
        # the head's backward, then the encoder's from the embeddings'
        # gradient: the same graph in two walks
        with record_function("pfc_head:backward"):
            g_emb, g_rows = torch.autograd.grad(loss, [emb, w_act])
        g_enc = torch.autograd.grad(emb, params, g_emb)

        g_enc, grad_norm = clip_by_global_norm(g_enc, MAX_GRAD_NORM)
        slots = {k: [v[n] for n in names] for k, v in state.opt_slots.items()}
        encoder_update(optimizer, conf, [p.data for p in params], g_enc,
                       slots, lr, state.step + 1)
        with record_function("pfc_head:update"):
            pfc_row_update(optimizer, conf, pfc.weight, pfc.slots, idx,
                           g_rows, lr, pfc.count + 1, gidx=gidx,
                           block=cfg.sample_block)
        state.step += 1
        pfc.count += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm, "lr": lr}

    return step


def prefetch_to_device(host_iter, device="cuda", depth: int = 2
                       ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(images, labels) host batches → (images, int32 labels) tensors on
    ``device``, converted ``depth`` batches ahead on a worker thread
    (fr_tpu/train/step.py:562-608), in order.

    On CUDA the worker pins each batch and copies it on a side stream with
    non_blocking copies, then records an event; the consumer's stream waits
    on that event before the batch is handed out, so a step never reads a
    torn batch, and each tensor is recorded on the consumer's stream, so
    the allocator cannot hand its memory back to the copy stream while a
    step still reads it. On the CPU the conversion is a plain
    ``torch.as_tensor``. A worker's exception is raised again at the
    consumer; closing the generator stops the worker, which then closes
    ``host_iter``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        copy_stream = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        # never block forever once the consumer has gone
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def convert(images, labels):
        host = (torch.as_tensor(np.asarray(images)),
                torch.as_tensor(np.asarray(labels, np.int32)))
        if not cuda:
            return host, None
        pinned = [t.pin_memory() for t in host]
        with torch.cuda.stream(copy_stream):
            batch = tuple(t.to(device, non_blocking=True) for t in pinned)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        # the pinned buffers ride along until the consumer has waited
        return batch, (ready, pinned)

    def worker():
        try:
            if cuda:
                torch.cuda.set_device(device)
            for images, labels in host_iter:
                if stop.is_set() or not put(convert(images, labels)):
                    return
            put(done)
        except BaseException as e:  # noqa: BLE001 — raised at the consumer
            put(e)
        finally:
            close = getattr(host_iter, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=worker, daemon=True,
                              name="prefetch_to_device")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, sync = item
            if sync is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(sync[0])
                for t in batch:
                    t.record_stream(stream)
            yield batch
    finally:
        stop.set()


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) weights of jax.image.resize's "bilinear" on one axis:
    half-pixel centres, a triangle kernel widened by in/out when
    downscaling (antialias), columns normalised to sum 1, samples outside
    the input zeroed — jax's compute_weight_mat in f32."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(images: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """NHWC f32 resize with the values of jax.image.resize(..., "bilinear")."""
    wh = torch.from_numpy(_resize_weights(images.shape[1], height)).to(
        images.device)
    ww = torch.from_numpy(_resize_weights(images.shape[2], width)).to(
        images.device)
    x = torch.einsum("bhwc,hH->bHwc", images, wh)
    return torch.einsum("bHwc,wW->bHWc", x, ww)


def make_embed_step(conf, encoder: torch.nn.Module, device) -> Callable:
    """images (NHWC float, numpy or tensor) → (B, emd) f32 L2-normalised
    embeddings on ``device``: resize to conf.img_size only when the size
    differs, encoder in eval mode (BN running statistics), no autograd."""
    img_size = conf.img_size
    device = torch.device(device)

    def embed(images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32).to(device)
        if x.shape[1] != img_size or x.shape[2] != img_size:
            x = resize_bilinear(x, img_size, img_size)
        encoder.eval()
        with torch.inference_mode():
            emb = encoder(x)
            return l2_normalize(emb.float())

    return embed


def embed_global_batch(embed_fn: Callable, flat) -> np.ndarray:
    """Embed a host batch (N, H, W, C) and fetch the (N, D) embeddings to
    host numpy; one device, so no padding or gathering."""
    return embed_fn(flat).cpu().numpy()
