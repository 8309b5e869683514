"""Fused margin-softmax cross-entropy for the PartialFC head: the Hopper
kernels' launch wrappers, their plain PyTorch versions and the autograd
Function that joins them.

Counterpart of fr_tpu/ops/fused_pfc.py::fused_margin_softmax_ce. The kernels
(csrc/margin_ce.cu) replace its three TPU kernels: the forward statistics
``_stats`` (online-softmax m, d, t over class tiles) and the two backward
kernels of ``_bwd_rule`` (grad_emb = coeff·W and grad_W = coeffᵀ·emb).
Their contract is fr_tpu's jnp twins ``_stats_jnp`` and ``_bwd_jnp``, of
which ``margin_ce_stats_reference`` and ``margin_ce_backward_reference`` are
line-for-line copies; ``margin_consts``, ``apply_margin_tile`` and
``margin_deriv_tile`` are shared by them and mirrored in the kernels.

Forward: loss = −log(clip(t/d, 1e-30)). Backward: the cotangent is zeroed
where t/d < 1e-30 (fr_tpu :374, matching autograd of the clip), then
coeff = g·s·margin′·clamp′·(p − onehot) drives both products. The operands
are cast to the compute dtype (bf16 under mixed precision, else f32) and
every product accumulates in f32; the gradients come back in the operands'
dtype, as fr_tpu's do.

A CPU tensor takes the plain versions; a CUDA tensor launches the kernels or
raises. Each wrapper counts its launches in ``.launches``. One shard only
(fr_tpu's model_axis=None); the class-sharded merge is ROADMAP §1,
multi-GPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

MASK = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MARGIN_CODE = {"ArcFace": 0, "CosFace": 1}
_TARGET_BLOCKS = 264   # two blocks per SM of an H100: the split heuristic
_STATS_ROWS, _EMB_ROWS, _CLASS_TILE = 32, 16, 64   # the kernels' tiles


def margin_consts(margin: str, m: float, easy_margin: bool = False) -> dict:
    """fr_tpu's ``_margin_consts``: easy_margin is the hard-margin formula
    with threshold 0 and fallback z itself."""
    if margin == "ArcFace":
        if easy_margin:
            return dict(cos_m=math.cos(m), sin_m=math.sin(m), theta=0.0,
                        sinmm=0.0)
        return dict(cos_m=math.cos(m), sin_m=math.sin(m),
                    theta=math.cos(math.pi - m),
                    sinmm=math.sin(math.pi - m) * m)
    if margin == "CosFace":
        return dict(m=m)
    raise ValueError(margin)


def apply_margin_tile(z, onehot, margin: str, s: float, mc: dict):
    """Margin on cosines z (already clamped) at the one-hot positions, ×s."""
    if margin == "ArcFace":
        sq = 1.0 - z * z
        sin_theta = torch.where(
            sq > 0, torch.sqrt(torch.where(sq > 0, sq, 1.0)), 0.0)
        margined = torch.where(z > mc["theta"],
                               z * mc["cos_m"] - sin_theta * mc["sin_m"],
                               z - mc["sinmm"])
    else:
        margined = z - mc["m"]
    return torch.where(onehot, margined, z) * s


def margin_deriv_tile(z, onehot, margin: str, s: float, mc: dict):
    """d(apply_margin_tile)/dz."""
    if margin == "ArcFace":
        sq = 1.0 - z * z
        safe = torch.where(sq > 0, sq, 1.0)
        dmarg = torch.where(sq > 0,
                            mc["cos_m"] + mc["sin_m"] * z * torch.rsqrt(safe),
                            mc["cos_m"])
        dmarg = torch.where(z > mc["theta"], dmarg, 1.0)
    else:
        dmarg = torch.ones_like(z)
    return torch.where(onehot, dmarg, 1.0) * s


def _consts(cfg) -> dict:
    return margin_consts(cfg.margin, cfg.m, getattr(cfg, "easy_margin", False))


def _raw_logits(emb, w, cfg):
    """f32 products of the compute-dtype operands."""
    compute = cfg.compute_dtype
    return torch.matmul(emb.to(compute).float(), w.to(compute).float().t())


def margin_ce_stats_reference(emb, w, label_cols, col_valid, cfg
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain twin of ``_stats_jnp``: per-row (m, d, t), f32."""
    mc = _consts(cfg)
    z = torch.clamp(_raw_logits(emb, w, cfg), -1.0, 1.0)
    onehot = (torch.arange(w.shape[0], device=w.device)[None, :]
              == label_cols[:, None])
    y = apply_margin_tile(z, onehot, cfg.margin, cfg.s, mc)
    y = torch.where(col_valid[None, :], y, MASK)
    m = torch.amax(y, dim=1)
    e = torch.exp(y - m[:, None])
    d = torch.sum(e, dim=1)
    t = torch.sum(torch.where(onehot, e, 0.0), dim=1)
    return m, d, t


def margin_ce_coeff_reference(emb, w, label_cols, col_valid, m_g, d_g, g,
                              cfg) -> torch.Tensor:
    """``_bwd_jnp``'s coeff (N, K) f32, before its cast to the compute
    dtype."""
    mc = _consts(cfg)
    raw = _raw_logits(emb, w, cfg)
    clamp_pass = (raw >= -1.0) & (raw <= 1.0)
    z = torch.clamp(raw, -1.0, 1.0)
    onehot = (torch.arange(w.shape[0], device=w.device)[None, :]
              == label_cols[:, None])
    valid = col_valid[None, :]
    y = apply_margin_tile(z, onehot, cfg.margin, cfg.s, mc)
    y = torch.where(valid, y, MASK)
    p = torch.exp(y - m_g[:, None]) / d_g[:, None]
    dy = p - torch.where(onehot, 1.0, 0.0)
    dmargin = margin_deriv_tile(z, onehot, cfg.margin, cfg.s, mc)
    coeff = g[:, None] * dy * dmargin
    return torch.where(clamp_pass & valid, coeff, 0.0)


def margin_ce_backward_reference(emb, w, label_cols, col_valid, m_g, d_g, g,
                                 cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``_bwd_jnp``: (grad_emb (N, D), grad_W (K, D)) f32."""
    compute = cfg.compute_dtype
    coeff = margin_ce_coeff_reference(emb, w, label_cols, col_valid, m_g,
                                      d_g, g, cfg).to(compute).float()
    ge = torch.matmul(coeff, w.to(compute).float())
    gw = torch.matmul(coeff.t(), emb.to(compute).float())
    return ge, gw


def _route(emb: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if emb.device.type == "cpu":
        return False
    if emb.device.type != "cuda":
        raise ValueError(f"no margin-CE kernel for device {emb.device}")
    return True


def margin_ce_stats(emb, w, label_cols, col_valid, cfg):
    """Per-row online-softmax statistics (m, d, t) of the margin logits."""
    if not _route(emb):
        return margin_ce_stats_reference(emb, w, label_cols, col_valid, cfg)
    out = _launch_stats(emb, w, label_cols, col_valid, cfg)
    margin_ce_stats.launches += 1
    return out


def margin_ce_grad_emb(emb, w, label_cols, col_valid, m_g, d_g, g, cfg):
    """grad_emb = coeff·W, (N, D) f32."""
    if not _route(emb):
        compute = cfg.compute_dtype
        coeff = margin_ce_coeff_reference(emb, w, label_cols, col_valid,
                                          m_g, d_g, g, cfg)
        return torch.matmul(coeff.to(compute).float(),
                            w.to(compute).float())
    out = _launch_grad(emb, w, label_cols, col_valid, m_g, d_g, g, cfg,
                       "margin_ce_grad_emb")
    margin_ce_grad_emb.launches += 1
    return out


def margin_ce_grad_w(emb, w, label_cols, col_valid, m_g, d_g, g, cfg):
    """grad_W = coeffᵀ·emb, (K, D) f32."""
    if not _route(emb):
        compute = cfg.compute_dtype
        coeff = margin_ce_coeff_reference(emb, w, label_cols, col_valid,
                                          m_g, d_g, g, cfg)
        return torch.matmul(coeff.to(compute).float().t(),
                            emb.to(compute).float())
    out = _launch_grad(emb, w, label_cols, col_valid, m_g, d_g, g, cfg,
                       "margin_ce_grad_w")
    margin_ce_grad_w.launches += 1
    return out


margin_ce_stats.launches = 0
margin_ce_grad_emb.launches = 0
margin_ce_grad_w.launches = 0


class _FusedMarginCE(torch.autograd.Function):
    """fr_tpu's custom_vjp: saves the operands and (m, d, p), recomputes the
    logits in the backward."""

    @staticmethod
    def forward(ctx, emb, w, label_cols, col_valid, cfg):
        m, d, t = margin_ce_stats(emb, w, label_cols, col_valid, cfg)
        p = t / d
        ctx.save_for_backward(emb, w, label_cols, col_valid, m, d, p)
        ctx.cfg = cfg
        return -torch.log(torch.clamp_min(p, 1e-30))

    @staticmethod
    def backward(ctx, g):
        emb, w, label_cols, col_valid, m, d, p = ctx.saved_tensors
        cfg = ctx.cfg
        # rows whose target probability fell under the clamp carry no
        # gradient, as autograd of the clip gives
        g = torch.where(p >= 1e-30, g, 0.0)
        ge = gw = None
        if ctx.needs_input_grad[0]:
            ge = margin_ce_grad_emb(emb, w, label_cols, col_valid, m, d, g,
                                    cfg).to(emb.dtype)
        if ctx.needs_input_grad[1]:
            gw = margin_ce_grad_w(emb, w, label_cols, col_valid, m, d, g,
                                  cfg).to(w.dtype)
        return ge, gw, None, None, None


def fused_margin_softmax_ce(emb: torch.Tensor, w: torch.Tensor,
                            label_cols: torch.Tensor,
                            col_valid: torch.Tensor, cfg) -> torch.Tensor:
    """Per-sample margin-softmax CE over the class columns of one shard.

    emb (N, D) and w (K, D): L2-normalised, in the compute dtype (fed that
    way by shard_softmax_ce); label_cols (N,) int, −1 for no target;
    col_valid (K,) bool; cfg a PFCConfig (margin, s, m, easy_margin,
    mixed_precision). Returns the per-sample loss (N,) f32."""
    return _FusedMarginCE.apply(emb, w, label_cols, col_valid, cfg)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _splits(row_tiles: int, class_tiles: int) -> int:
    """Class splits for the stats and grad_emb kernels: enough blocks for
    two per SM, no split without a class tile."""
    return max(1, min(class_tiles, -(-_TARGET_BLOCKS // row_tiles), 65535))


def _operands(emb, w, label_cols, col_valid, cfg):
    """Checked, contiguous kernel operands: emb and w in the compute dtype,
    int32 labels, uint8 column mask."""
    if emb.dim() != 2 or w.dim() != 2 or emb.shape[1] != w.shape[1]:
        raise ValueError(f"emb (N, D) and w (K, D) expected, got "
                         f"{tuple(emb.shape)} and {tuple(w.shape)}")
    N, D = emb.shape
    K = w.shape[0]
    if N == 0 or K == 0 or D == 0:
        raise ValueError(f"empty operands: N={N}, K={K}, D={D}")
    if cfg.margin not in _MARGIN_CODE:
        raise ValueError(f"no kernel for margin {cfg.margin!r}")
    dev = emb.device
    for name, t, shape in (("w", w, (K, D)), ("label_cols", label_cols, (N,)),
                           ("col_valid", col_valid, (K,))):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    compute = cfg.compute_dtype
    return (emb.to(compute).contiguous(), w.to(compute).contiguous(),
            label_cols.to(torch.int32).contiguous(),
            col_valid.to(torch.uint8).contiguous(), N, K, D,
            _DTYPE_CODE[compute])


def _margin_args(cfg):
    mc = _consts(cfg)
    return (_MARGIN_CODE[cfg.margin], float(cfg.s), mc.get("cos_m", 0.0),
            mc.get("sin_m", 0.0), mc.get("theta", 0.0), mc.get("sinmm", 0.0),
            mc.get("m", 0.0))


def _launch_stats(emb, w, label_cols, col_valid, cfg):
    from fr_tpu_torch.ops._build import check_launch, load_library

    emb, w, labels, cv, N, K, D, code = _operands(emb, w, label_cols,
                                                  col_valid, cfg)
    dev = emb.device
    splits = _splits(-(-N // _STATS_ROWS), -(-K // _CLASS_TILE))
    partial = torch.empty((3, splits, N), dtype=torch.float32, device=dev)
    m, d, t = torch.empty((3, N), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.margin_ce_stats(
            emb.data_ptr(), w.data_ptr(), labels.data_ptr(), cv.data_ptr(),
            N, K, D, code, *_margin_args(cfg), splits, partial.data_ptr(),
            m.data_ptr(), d.data_ptr(), t.data_ptr(), ctypes.c_void_p(stream))
    check_launch(lib, err, "margin_ce_stats")
    return m, d, t


def _launch_grad(emb, w, label_cols, col_valid, m_g, d_g, g, cfg, name):
    from fr_tpu_torch.ops._build import check_launch, load_library

    emb, w, labels, cv, N, K, D, code = _operands(emb, w, label_cols,
                                                  col_valid, cfg)
    dev = emb.device
    rows = [t.to(device=dev, dtype=torch.float32).contiguous()
            for t in (m_g, d_g, g)]
    if any(tuple(t.shape) != (N,) for t in rows):
        raise ValueError(f"m, d and g must be ({N},)")
    lib = load_library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        common = (emb.data_ptr(), w.data_ptr(), labels.data_ptr(),
                  cv.data_ptr(), *(t.data_ptr() for t in rows), N, K, D,
                  code, *_margin_args(cfg))
        if name == "margin_ce_grad_emb":
            splits = _splits(-(-N // _EMB_ROWS), -(-K // _CLASS_TILE))
            partial = torch.empty((splits, N, D), dtype=torch.float32,
                                  device=dev)
            out = torch.empty((N, D), dtype=torch.float32, device=dev)
            err = lib.margin_ce_grad_emb(*common, splits, partial.data_ptr(),
                                         out.data_ptr(), stream)
        else:
            out = torch.empty((K, D), dtype=torch.float32, device=dev)
            err = lib.margin_ce_grad_w(*common, out.data_ptr(), stream)
    check_launch(lib, err, name)
    return out
