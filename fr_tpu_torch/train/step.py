"""The training step and the embedding step (counterpart of
fr_tpu/train/step.py: ``_device_step`` :83-280, the augmentation dispatch
:253-272, ``shard_batch`` :478-509, the embed step :452-475 and
``embed_global_batch`` :545-559), on one device or one rank of a
('data', 'model') mesh (parallel/mesh.py).

The training step, in fr_tpu's order:
  sample the shard's head columns (positives forced in) → each sample's
  target column → encoder in train mode on the rank's images (local BN
  batch statistics, running statistics updated) → f32 L2-normalise →
  all-gather over the model group → shard_softmax_ce (pmax/psum over the
  model group), mean over the data row → backward → sum the gradients
  (the encoder's over the world, the head rows' over the data group) →
  clip the encoder's gradients to global norm 5 → average the BN running
  statistics over the world → update the encoder, then the shard's sampled
  rows.
Augmentation, when configured, runs as its own call before the step.

Gradients on a mesh. fr_tpu's loss is the pmean over 'data' of each row's
mean, and its vma-aware autodiff sums the cotangent of every replicated
input over the mesh axes it is replicated on (step.py:189-194). So each
rank backpropagates its row's loss divided by the data size through its
own images (the all-gather's backward sums the embeddings' cotangents over
the model group, parallel/collectives.py), and then the encoder's
gradients are summed over the world in one flat bucket and the head rows'
over the data group: fr_tpu's gradients exactly, not DDP's average. Every
rank then holds the same clipped gradient, so the ranks' encoders stay
equal bit for bit. BatchNorm uses each rank's own batch statistics, never
SyncBatchNorm (step.py:16-17). At mesh (1, 1) no collective runs and the
step is the one-device step.

With block-aligned sampling (sample_block > 1) the head draws aligned groups
of rows: the masks stay at group granularity, the column mask is arithmetic
on the expanded index, and the rows move through the grouped kernels of
ops/sparse_rows.py (gather, then the in-place update). The gradient is taken
with respect to the gathered rows, so the gather carries no autograd.

Each step runs inside spans (utils/profiling.py ``span``), one at every
layer boundary: the root ``train_step`` holds the augmentation, the head's
four parts (``pfc_head:rows``, ``:loss``, ``:backward``, ``:update``), the
encoder's forward and backward, the gradients' collectives and the
encoder's update, and the embedding step's root ``embed_step`` holds its
copy in and its encoder. A profile of a step places every kernel in the
span that launched it; outside a profile the spans do nothing.

Batches reach the step from the host or already on the device:
``prefetch_to_device`` copies host batches a few steps ahead on a side CUDA
stream, and a tensor already on the step's device is taken as it is. On a
mesh the images are the rank's rows of the global batch (``shard_batch``,
or a loader given ``process_index=rank``) and the labels the whole global
vector.

Random numbers come from explicit generators, one per fr_tpu RNG stream
(``stream_generators``), which live in the training state so that a
checkpoint carries them; JAX and torch streams differ, so a test feeds the
JAX side's sampled columns or groups in through ``sample_idx`` /
``sample_gidx`` (the shard's own, on a mesh).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from fr_tpu_torch.data.augment import augment
from fr_tpu_torch.heads.partial_fc import (PFCConfig, label_columns,
                                          sample_columns, sample_groups,
                                          shard_group_masks, shard_softmax_ce,
                                          shard_valid_mask)
from fr_tpu_torch.models.common import l2_normalize
from fr_tpu_torch.ops.sparse_rows import expand_group_index, grouped_gather
from fr_tpu_torch.parallel.collectives import (all_gather, pmean,
                                               pmean_flat_, psum_flat_)
from fr_tpu_torch.parallel.mesh import Mesh, local_class_slice
from fr_tpu_torch.train.optim import (clip_by_global_norm, encoder_update,
                                      pfc_row_update)
from fr_tpu_torch.train.state import TrainState
from fr_tpu_torch.utils import profiling as spans
from fr_tpu_torch.utils.profiling import span

MAX_GRAD_NORM = 5.0


def make_train_step(conf, pfc_cfg: PFCConfig, device,
                    augment_cfg: Optional[tuple] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """step(state, images, labels, lr, sample_idx=None, sample_gidx=None)
    → metrics.

    images: (b_loc, H, W, 3) float32, or uint8 when augment_cfg is given:
    the rank's rows of the global batch (all of it on one device); labels
    the global batch's (B,) int class ids; lr a float. Updates ``state`` in
    place and returns {"loss", "grad_norm"} as device scalars (the global
    batch's, the same on every rank) and "lr". ``sample_idx`` (test use)
    replaces the shard's drawn sampled columns with a given sorted index
    vector of shard-local ids, ``sample_gidx`` the drawn groups of
    block-aligned sampling with given sorted shard-local group ids. The
    encoder and the generators are the state's; ``mesh`` is this rank's
    place in the mesh (None: one device)."""
    device = torch.device(device)
    optimizer = conf.optimizer_name
    cfg = pfc_cfg
    mesh = mesh if mesh is not None else Mesh(1, 1)
    if cfg.model_size != mesh.model:
        raise ValueError(f"the head is split {cfg.model_size} ways, the "
                         f"mesh's model axis {mesh.model}")
    model_group = mesh.model_group
    class_start, num_local = local_class_slice(cfg.num_classes_padded,
                                               mesh.model, mesh.model_idx)
    grouped = cfg.sampling and cfg.sample_block > 1
    # the grouped path keeps every mask at group granularity
    valid = None if grouped else shard_valid_mask(cfg, mesh.model_idx,
                                                  device)

    def head_rows(labels, pfc, gens, sample_idx, sample_gidx):
        """(idx, gidx, col_valid, w_rows): the active rows' shard-local ids
        (None for all), their group ids under block-aligned sampling (else
        None), the mask of the real columns among them and the rows
        themselves. Positives are forced in from the global batch, so every
        data row of a shard draws the same columns."""
        loc = labels - class_start
        owned = (loc >= 0) & (loc < num_local)
        if grouped:
            if sample_gidx is None:
                gidx = sample_groups(cfg, gens["sample"], *shard_group_masks(
                    cfg, mesh.model_idx, loc, owned))
            else:
                gidx = torch.as_tensor(sample_gidx).to(device).long()
            idx = expand_group_index(gidx, cfg.sample_block)
            return (idx, gidx, idx + class_start < cfg.num_classes,
                    grouped_gather(pfc.weight, gidx, cfg.sample_block))
        if cfg.sampling:
            if sample_idx is None:
                pos = torch.zeros(num_local, dtype=torch.bool, device=device)
                pos[loc[owned]] = True
                idx = sample_columns(cfg, gens["sample"], pos, valid)
            else:
                idx = torch.as_tensor(sample_idx).to(device).long()
            return idx, None, valid[idx], pfc.weight.index_select(0, idx)
        return None, None, valid, pfc.weight

    def step(state: TrainState, images, labels, lr: float,
             sample_idx=None, sample_gidx=None) -> Dict:
        with span(spans.TRAIN_STEP):
            return _step(state, images, labels, lr, sample_idx, sample_gidx)

    def _step(state, images, labels, lr, sample_idx, sample_gidx):
        gens = state.generators
        # a synchronous copy for host arrays; .to returns a tensor that is
        # already on the device (a prefetched batch) as it is
        images = torch.as_tensor(images).to(device)
        labels = torch.as_tensor(labels).to(device).long()
        if augment_cfg is not None:
            with span(spans.AUGMENT):
                images = augment(images, augment_cfg, gens["augment"])
        pfc = state.pfc
        row_size = mesh.model * images.shape[0]
        with span(spans.HEAD_ROWS):
            idx, gidx, col_valid, w_rows = head_rows(labels, pfc, gens,
                                                     sample_idx, sample_gidx)
            # this data row's labels (fr_tpu/train/step.py:157-167)
            labels_row = labels if row_size == labels.shape[0] else \
                labels[mesh.data_idx * row_size:(mesh.data_idx + 1)
                       * row_size]
            label_cols = label_columns(cfg, labels_row - class_start, idx)

        encoder = state.encoder
        encoder.train()
        names, params = zip(*encoder.named_parameters())
        w_act = w_rows.detach().requires_grad_(True)
        with span(spans.ENCODER_FORWARD):
            emb = l2_normalize(encoder(images, gens["dropout"]).float())
        with span(spans.HEAD_LOSS):
            loss = shard_softmax_ce(cfg, all_gather(emb, model_group),
                                    label_cols, w_act, col_valid,
                                    model_group).mean()
        # the head's backward, then the encoder's from the embeddings'
        # gradient: the same graph in two walks
        with span(spans.HEAD_BACKWARD):
            g_emb, g_rows = torch.autograd.grad(
                loss / mesh.data if mesh.data > 1 else loss, [emb, w_act])
        with span(spans.ENCODER_BACKWARD):
            g_enc = list(torch.autograd.grad(emb, params, g_emb))
        with span(spans.COLLECTIVE_GRADS):
            psum_flat_(g_enc, mesh.world_group)
            psum_flat_([g_rows], mesh.data_group)
            pmean_flat_([b for b in encoder.buffers()
                         if b.is_floating_point()], mesh.world_group)

        with span(spans.OPTIM_ENCODER):
            g_enc, grad_norm = clip_by_global_norm(g_enc, MAX_GRAD_NORM)
            slots = {k: [v[n] for n in names]
                     for k, v in state.opt_slots.items()}
            encoder_update(optimizer, conf, [p.data for p in params], g_enc,
                           slots, lr, state.step + 1)
        with span(spans.HEAD_UPDATE):
            pfc_row_update(optimizer, conf, pfc.weight, pfc.slots, idx,
                           g_rows, lr, pfc.count + 1, gidx=gidx,
                           block=cfg.sample_block)
        state.step += 1
        pfc.count += 1
        return {"loss": pmean(loss.detach(), mesh.data_group),
                "grad_norm": grad_norm, "lr": lr}

    return step


def shard_batch(mesh: Optional[Mesh], images, labels):
    """(the rank's images, the global labels) of a global host batch: rows
    ``[rank·b_loc, (rank + 1)·b_loc)`` of the images, the batch split over
    both mesh axes in rank order (fr_tpu BATCH_SPEC, parallel/mesh.py:29),
    and every label."""
    if mesh is None or mesh.size == 1:
        return images, labels
    n = images.shape[0]
    if n % mesh.size:
        raise ValueError(f"global batch {n} does not split over "
                         f"{mesh.size} ranks")
    b_loc = n // mesh.size
    return images[mesh.rank * b_loc:(mesh.rank + 1) * b_loc], labels


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
        with span(spans.EMBED_STEP):
            with span(spans.EMBED_COPY_IN):
                x = torch.as_tensor(images, dtype=torch.float32).to(device)
                if x.shape[1] != img_size or x.shape[2] != img_size:
                    x = resize_bilinear(x, img_size, img_size)
            encoder.eval()
            with torch.inference_mode(), span(spans.EMBED_ENCODER):
                emb = encoder(x)
                return l2_normalize(emb.float())

    return embed


def embed_global_batch(embed_fn: Callable, flat,
                       mesh: Optional[Mesh] = None) -> np.ndarray:
    """Embed a host batch (N, H, W, C) that every rank holds and fetch the
    (N, D) embeddings to host numpy on every rank. On a mesh N is padded up
    to a multiple of the world, each rank embeds its slice, and the slices
    are all-gathered over the world and the pad stripped
    (fr_tpu/train/step.py:545-559)."""
    if mesh is None or mesh.size == 1:
        return embed_fn(flat).cpu().numpy()
    flat = np.asarray(flat)
    n = flat.shape[0]
    pad = (-n) % mesh.size
    if pad:
        flat = np.concatenate(
            [flat, np.zeros((pad,) + flat.shape[1:], flat.dtype)])
    per = flat.shape[0] // mesh.size
    emb = embed_fn(flat[mesh.rank * per:(mesh.rank + 1) * per])
    return all_gather(emb, mesh.world_group).cpu().numpy()[:n]
