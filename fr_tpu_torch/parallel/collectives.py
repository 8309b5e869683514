"""The collectives of fr_tpu's train step, on tensors, with the gradients
that fr_tpu's vma-aware autodiff gives them (counterpart of the
``lax.all_gather`` / ``psum`` / ``pmax`` / ``pmean`` calls of
fr_tpu/train/step.py and fr_tpu/heads/partial_fc.py).

Every function takes a process group of parallel/mesh.py, and is the
identity when it is None (a mesh axis of one rank).

- ``all_gather``: rank-ordered concatenation along axis 0 (fr_tpu's
  ``all_gather(tiled=True)``, step.py:176). Its backward is a reduce-scatter
  sum over the same group, the transpose autodiff derives (step.py:8): each
  rank gets the sum, over the group, of the cotangents of its own rows.
- ``psum``: the sum over the group of a value that every rank then holds
  replicated (partial_fc.py:257, :263). Its backward is the identity: each
  rank already holds the whole replicated cotangent, so an all-reduce would
  count the gradient once per rank. This holds where the value's consumers
  are themselves replicated, as in heads/partial_fc.py.
- ``pmax``: the maximum over the group; it carries no gradient
  (partial_fc.py:251-253).
- ``pmean``: the mean over the group of a value that carries no gradient:
  the reported loss over 'data' (step.py:183) and the BN running statistics
  over the world (step.py:198-200).
- ``psum_flat_``: the in-place sum over the group of a list of gradients,
  in one flat bucket per dtype.

Only ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_reduce`` are used, which exist in every torch the port runs on. Gloo
takes CUDA tensors for all three (it copies through the host itself), so
the two ranks that share one card in chip_smoke.py run over gloo with the
same calls as NCCL's ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    """A new tensor: x reduced over the group."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n·N, ...) from each rank's (N, ...), in rank order."""
    return x if group is None else _AllGather.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _PSum.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x.detach()
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x.detach()
    return _all_reduce(x, group, dist.ReduceOp.SUM) / group_size(group)


@torch.no_grad()
def psum_flat_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over the group in place, one all-reduce per dtype."""
    if group is None:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = _all_reduce(torch.cat([t.reshape(-1) for t in ts]), group,
                           dist.ReduceOp.SUM)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


@torch.no_grad()
def pmean_flat_(tensors: Sequence[torch.Tensor], group) -> None:
    """Average each tensor over the group in place (floating tensors; one
    all-reduce per dtype)."""
    if group is None:
        return
    psum_flat_(tensors, group)
    n = group_size(group)
    for t in tensors:
        t.div_(n)


def gather_rows_to_host(x: torch.Tensor, group, chunk_rows: int = 1 << 16,
                        keep: bool = True) -> Optional[torch.Tensor]:
    """The rank-ordered concatenation over the group of each rank's rows of
    ``x`` (N, ...), as one host tensor, gathered ``chunk_rows`` rows at a
    time, so that no device holds more than a chunk of the whole. Every
    rank of the group calls it; those with ``keep`` false get None."""
    if group is None:
        return x.detach().cpu() if keep else None
    n = dist.get_world_size(group)
    rows = x.shape[0]
    out = (torch.empty((n * rows,) + tuple(x.shape[1:]), dtype=x.dtype)
           if keep else None)
    for r0 in range(0, rows, chunk_rows):
        r1 = min(rows, r0 + chunk_rows)
        part = _all_gather(x[r0:r1], group)
        if keep:
            part = part.cpu().view((n, r1 - r0) + tuple(x.shape[1:]))
            for i in range(n):
                out[i * rows + r0:i * rows + r1] = part[i]
    return out
