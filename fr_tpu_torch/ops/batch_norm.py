"""BatchNorm with flax's semantics over an activation kept in its own dtype:
the Hopper kernels' wrappers and the plain PyTorch version.

fr_tpu's BatchNorm is flax's (fr_tpu/models/common.py:61-81): eps 1e-5,
running statistics updated as 0.9·R + 0.1·batch with the *biased* batch
variance, statistics and affine arithmetic in f32 whatever the input dtype,
the output rounded to the input's dtype. Under the mesh the statistics stay
local to each rank.

The plain version (``batch_norm_reference``) is that arithmetic through
PyTorch's f32 ``F.batch_norm`` on an f32 copy of x, cast back; the CPU takes
it. A CUDA tensor takes the kernels of csrc/batch_norm.cu, which read and
write x in its own dtype and keep the f32 arithmetic in registers, or
raises: two launches forward (statistics with the running update, then the
normalisation), two backward, one in eval mode. The training Function saves
x in its own dtype and the f32 mean and rstd, never an f32 copy of x. The
kernels replace no TPU kernel (flax's BatchNorm is XLA's there); the
source's header has their design.

The kernels take the activation as an (M, C) row-major matrix: a
channels_last 4-D tensor (M = N·H·W) or a contiguous 2-D one, as a view.
Any other layout, of x or of the incoming gradient, is made channels_last
once and counted on ``batch_norm.layout_copies``; ``batch_norm.launches``
counts the kernels' launches, and ``batch_norm.entry_launches`` the same
launches by entry point (``bn_forward``, ``bn_backward``, ``bn_eval``).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from fr_tpu_torch.ops._build import check_launch, load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def batch_norm_reference(x, running_mean, running_var, weight, bias,
                         num_batches_tracked, training: bool,
                         momentum: float, eps: float) -> torch.Tensor:
    """flax's BatchNorm through PyTorch's f32 batch norm. In training the
    running variance takes the *biased* batch variance, as flax does;
    torch's own BatchNorm takes the unbiased one, n/(n−1) larger (a third
    larger for BN1d over 4 samples). torch's update runs inside its fused
    BatchNorm, R₁ = (1−m)·R₀ + m·v·n/(n−1); the batch's share is then
    scaled back by (n−1)/n on the (C,) buffer, which needs no second pass
    over the activations."""
    xf = x.float()
    if not training:
        return F.batch_norm(xf, running_mean, running_var, weight, bias,
                            False, 0.0, eps).to(x.dtype)
    m = momentum
    n = xf.numel() // xf.shape[1]
    # torch updates a copy: autograd keeps the buffer it was given
    updated = running_var.clone()
    y = F.batch_norm(xf, running_mean, updated, weight, bias, True, m, eps)
    with torch.no_grad():
        kept = running_var * (1.0 - m)
        running_var.copy_(kept + (updated - kept) * ((n - 1) / n))
        num_batches_tracked.add_(1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
# A BatchNorm is launched ~200 times a training step, so the host path is
# kept short: the current stream is read as a raw handle, the entry points
# set and restore the device themselves, and the reductions' scratch is one
# buffer a stream.

def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels' (M, C) row-major matrix: itself when it is one
    already, else a channels_last (or contiguous 2-D) copy, counted."""
    if t.dim() == 4:
        if t.is_contiguous(memory_format=torch.channels_last):
            return t
        batch_norm.layout_copies += 1
        return t.contiguous(memory_format=torch.channels_last)
    if t.is_contiguous():
        return t
    batch_norm.layout_copies += 1
    return t.contiguous()


@functools.lru_cache(maxsize=None)
def _scratch_size(device: int, c: int) -> tuple[int, int]:
    """(floats of partials, ticket counters) a reduction over c channels
    takes on the device, as the kernels' source sizes them."""
    lib = load_library()
    floats, tickets = ctypes.c_longlong(), ctypes.c_int()
    check_launch(lib, lib.bn_scratch(device, c, ctypes.byref(floats),
                                     ctypes.byref(tickets)), "bn_scratch")
    return floats.value, tickets.value


_SCRATCH = {}


def _scratch(device: int, stream: int, c: int):
    """The stream's reduction scratch, grown to what C channels take, and
    its ticket counters, zeroed once: each reduction leaves them at zero.
    Launches on one stream run in order, so they share both."""
    need, n_tickets = _scratch_size(device, c)
    entry = _SCRATCH.get((device, stream))
    if entry is None or entry[0].numel() < need:
        tickets = (torch.zeros(n_tickets, dtype=torch.int32, device=device)
                   if entry is None else entry[1])
        entry = _SCRATCH[(device, stream)] = (
            torch.empty(need, dtype=torch.float32, device=device), tickets)
    return entry


def _launch(name: str, launches: int, *args) -> None:
    """Calls the entry point with args (pointers as ints, then the rest, in
    its order) and raises on a CUDA error; counts its launches."""
    lib = load_library()
    check_launch(lib, getattr(lib, name)(*args), name)
    batch_norm.launches += launches
    batch_norm.entry_launches[name] += launches


def _eval(x, weight, bias, running_mean, running_var, eps):
    c = x.shape[1]
    device = x.get_device()
    y = torch.empty_like(x)
    _launch("bn_eval", 1, x.data_ptr(), y.data_ptr(), _DTYPE_CODES[x.dtype],
            x.numel() // c, c, running_mean.data_ptr(),
            running_var.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps,
            device, torch._C._cuda_getCurrentRawStream(device))
    return y


def _backward(x, dy, mean, rstd, weight, frozen: int):
    """The backward pair: (dx, dγ, dβ). ``frozen``: eval mode, where mean
    and rstd are the running statistics and dx = γ·rstd·dy."""
    dy = _rows(dy)
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"the gradient is {dy.dtype} {tuple(dy.shape)}, "
                         f"the input {x.dtype} {tuple(x.shape)}")
    c = x.shape[1]
    device = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    part, tickets = _scratch(device, stream, c)
    dx = torch.empty_like(x)
    # dγ, dβ, then bn_bwd_apply's three coefficients
    grads = torch.empty(5 * c, dtype=torch.float32, device=x.device)
    ptr = grads.data_ptr()
    _launch("bn_backward", 2, x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            _DTYPE_CODES[x.dtype], x.numel() // c, c, mean.data_ptr(),
            rstd.data_ptr(), weight.data_ptr(), ptr, ptr + 4 * c,
            ptr + 8 * c, part.data_ptr(), part.numel(), tickets.data_ptr(),
            frozen, device, stream)
    return dx, grads[:c], grads[c:2 * c]


class _TrainBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                num_batches_tracked, momentum, eps):
        c = x.shape[1]
        device = x.get_device()
        stream = torch._C._cuda_getCurrentRawStream(device)
        part, tickets = _scratch(device, stream, c)
        y = torch.empty_like(x)
        # mean, rstd, scale γ·rstd
        stats = torch.empty(3 * c, dtype=torch.float32, device=x.device)
        _launch("bn_forward", 2, x.data_ptr(), y.data_ptr(),
                _DTYPE_CODES[x.dtype], x.numel() // c, c, weight.data_ptr(),
                bias.data_ptr(), running_mean.data_ptr(),
                running_var.data_ptr(), num_batches_tracked.data_ptr(),
                stats.data_ptr(), part.data_ptr(), part.numel(),
                tickets.data_ptr(), 1.0 - momentum, momentum, eps, device,
                stream)
        # written through their pointers: autograd learns of it here, so a
        # graph that saved them raises as after an in-place torch op
        torch.autograd.graph.increment_version(
            (running_mean, running_var, num_batches_tracked))
        ctx.save_for_backward(x, weight, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, stats = ctx.saved_tensors
        c = x.shape[1]
        dx, dweight, dbias = _backward(x, dy, stats[:c], stats[c:2 * c],
                                       weight, 0)
        return dx, dweight, dbias, None, None, None, None, None


class _EvalBatchNorm(torch.autograd.Function):
    """Eval mode where autograd needs the graph; without it the wrapper
    calls ``_eval`` alone."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps):
        ctx.save_for_backward(x, weight, running_mean, running_var)
        ctx.eps = eps
        return _eval(x, weight, bias, running_mean, running_var, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, running_mean, running_var = ctx.saved_tensors
        rstd = torch.rsqrt(running_var + ctx.eps)
        dx, dweight, dbias = _backward(x, dy, running_mean, rstd, weight, 1)
        return dx, dweight, dbias, None, None, None


_PARAMS = ("running_mean", "running_var", "weight", "bias")


def _check(x, params, num_batches_tracked) -> None:
    """What the kernels take: x bf16 or f32, (N, C) or (N, C, H, W); the
    (C,) f32 running statistics and parameters and the int64 step count,
    contiguous on x's device."""
    if x.dtype not in _DTYPE_CODES or x.dim() not in (2, 4):
        raise ValueError(f"the BatchNorm kernels take a bf16 or f32 (N, C) "
                         f"or (N, C, H, W) input, got {x.dtype} "
                         f"{tuple(x.shape)}")
    device, shape = x.get_device(), x.shape[1:2]
    for name, t, dtype, want in (
            *((n, p, torch.float32, shape) for n, p in zip(_PARAMS, params)),
            ("num_batches_tracked", num_batches_tracked, torch.int64, ())):
        if (t.dtype != dtype or t.shape != want or t.get_device() != device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(want)} "
                             f"{dtype} on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, num_batches_tracked: torch.Tensor,
               training: bool, momentum: float, eps: float) -> torch.Tensor:
    """flax's BatchNorm of x (N, C) or (N, C, H, W), in x's dtype. In
    training the batch statistics normalise x and update the running
    statistics and ``num_batches_tracked`` in place; in eval mode the
    running statistics normalise it. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernels or raises."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return batch_norm_reference(x, running_mean, running_var, weight,
                                        bias, num_batches_tracked, training,
                                        momentum, eps)
        raise ValueError(f"no BatchNorm kernel for device {x.device}")
    _check(x, (running_mean, running_var, weight, bias), num_batches_tracked)
    x = _rows(x)
    if training:
        if x.numel() // x.shape[1] < 2:
            raise ValueError(f"expected more than 1 value per channel when "
                             f"training, got input size {tuple(x.shape)}")
        return _TrainBatchNorm.apply(x, weight, bias, running_mean,
                                     running_var, num_batches_tracked,
                                     momentum, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _EvalBatchNorm.apply(x, weight, bias, running_mean,
                                    running_var, eps)
    return _eval(x, weight, bias, running_mean, running_var, eps)


batch_norm.launches = 0
batch_norm.entry_launches = collections.Counter()
batch_norm.layout_copies = 0
