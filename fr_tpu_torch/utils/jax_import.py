"""Carry fr_tpu's encoder weights and training state into the port, and the
port's back into fr_tpu's layout.

fr_tpu keeps flax parameter trees ({"Conv_0": {"Conv_0": {"kernel": ...}},
"BasicBlock_3": ...}) and BN statistics in a separate tree. The port's
modules use the reference state-dict naming that
fr_tpu/utils/torch_export.py writes, buffers included, so the result of
``encoder_state_dict_from_jax`` loads with ``load_state_dict(strict=True)``;
that strict load is the check that every name and shape lines up.

One table of entries (port key ↔ flax tree and path, and the layout change)
drives both directions: the import of weights, BN statistics and optimizer
slots (which have the parameters' tree), and the export of an encoder
snapshot in fr_tpu's ``.npz`` layout (fr_tpu/ckpt/checkpoint.py:145-152),
which ``load_encoder_npz`` and fr_tpu's own ``load_encoder`` both read.

Works on numpy arrays alone: no jax import, so it also runs on a machine
without jax.

Conventions: flax conv kernel (kh, kw, I, O) ↔ torch (O, I, kh, kw); flax
dense kernel (I, O) ↔ torch (O, I); flax BN scale/bias + mean/var ↔ torch
weight/bias/running_mean/running_var, num_batches_tracked 0 on import.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from fr_tpu_torch.models.alternet import (ALTERNET_PLANS, ALTERNET_SEP_PLANS,
                                          alt_sequence, alt_sequence_sep)
from fr_tpu_torch.models.alternet_v1 import ALTERNET_V1_PLANS
from fr_tpu_torch.models.effialternet import EFFIALTER_CFGS, stage_plan
from fr_tpu_torch.models.resnet import RESNET_LAYERS
from fr_tpu_torch.models.swinv2 import SWIN_PLANS
from fr_tpu_torch.models.swin_common import (relative_coords_table,
                                             relative_position_index,
                                             shifted_window_mask)

StateDict = Dict[str, torch.Tensor]
Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class _Entry:
    key: str                 # the port's state-dict key
    tree: str                # "params" or "batch_stats"
    path: Tuple[str, ...]    # flax path inside that tree
    kind: str                # "conv", "dense" or "vec"


_TO_TORCH = {"conv": (3, 2, 0, 1), "dense": (1, 0)}
_TO_FLAX = {"conv": (2, 3, 1, 0), "dense": (1, 0)}


class _Table:
    """The entries of one encoder, plus its architecture-fixed buffers."""

    def __init__(self):
        self.entries: List[_Entry] = []
        self.fixed: StateDict = {}

    def conv(self, name: str, path: Tuple[str, ...],
             bias: bool = False) -> None:
        self.entries.append(_Entry(f"{name}.weight", "params",
                                   path + ("Conv_0", "kernel"), "conv"))
        if bias:
            self.entries.append(_Entry(f"{name}.bias", "params",
                                       path + ("Conv_0", "bias"), "vec"))

    def linear(self, name: str, path: Tuple[str, ...], bias: bool) -> None:
        self.entries.append(_Entry(f"{name}.weight", "params",
                                   path + ("kernel",), "dense"))
        if bias:
            self.entries.append(_Entry(f"{name}.bias", "params",
                                       path + ("bias",), "vec"))

    def vec(self, key: str, path: Tuple[str, ...]) -> None:
        self.entries.append(_Entry(key, "params", path, "vec"))

    def bn(self, name: str, path: Tuple[str, ...]) -> None:
        p = path + ("BatchNorm_0",)
        for leaf, tree, flax_leaf in (("weight", "params", "scale"),
                                      ("bias", "params", "bias"),
                                      ("running_mean", "batch_stats", "mean"),
                                      ("running_var", "batch_stats", "var")):
            self.entries.append(_Entry(f"{name}.{leaf}", tree,
                                       p + (flax_leaf,), "vec"))
        self.fixed[f"{name}.num_batches_tracked"] = torch.tensor(
            0, dtype=torch.long)

    def basic_block(self, tb: str, path: Tuple[str, ...],
                    downsample: bool) -> None:
        self.conv(f"{tb}.conv1", path + ("Conv_0",))
        self.bn(f"{tb}.bn1", path + ("BatchNorm_0",))
        self.conv(f"{tb}.conv2", path + ("Conv_1",))
        self.bn(f"{tb}.bn2", path + ("BatchNorm_1",))
        if downsample:
            self.conv(f"{tb}.downsample.0", path + ("Conv_2",))
            self.bn(f"{tb}.downsample.1", path + ("BatchNorm_2",))

    def attention(self, tb: str, path: Tuple[str, ...], window: int,
                  res: int, shift: int) -> None:
        """A block's WindowAttention_0, its norm2 (BatchNorm_0) and, when
        shifted, its attn_mask."""
        a = path + ("WindowAttention_0",)
        pre = f"{tb}.attn"
        self.entries.append(_Entry(f"{pre}.qkv.weight", "params",
                                   a + ("qkv_kernel",), "dense"))
        for leaf in ("q_bias", "v_bias", "logit_scale"):
            self.vec(f"{pre}.{leaf}", a + (leaf,))
        self.linear(f"{pre}.cpb_mlp.0", a + ("cpb_fc1",), bias=True)
        self.linear(f"{pre}.cpb_mlp.2", a + ("cpb_fc2",), bias=False)
        self.fixed[f"{pre}.relative_coords_table"] = torch.from_numpy(
            relative_coords_table((window, window)))
        self.fixed[f"{pre}.relative_position_index"] = torch.from_numpy(
            relative_position_index((window, window)).astype(np.int64))
        self.linear(f"{pre}.proj", a + ("proj",), bias=True)
        self.bn(f"{tb}.norm2", path + ("BatchNorm_0",))
        if shift > 0:
            self.fixed[f"{tb}.attn_mask"] = torch.from_numpy(
                shifted_window_mask(res, res, window, shift))

    def swin_block(self, tb: str, path: Tuple[str, ...]) -> None:
        """Swin's block: attention, then the conv-MLP and norm3."""
        self.attention(tb, path, 7, 0, 0)
        self.conv(f"{tb}.mlp.fc1", path + ("Conv_0",), bias=True)
        self.conv(f"{tb}.mlp.fc2", path + ("Conv_1",), bias=True)
        self.bn(f"{tb}.norm3", path + ("BatchNorm_1",))

    def fan_block(self, tb: str, path: Tuple[str, ...], res: int,
                  shift: int) -> None:
        """EffiAlterNet's block: attention, then ChannelProcessing and
        norm3."""
        self.attention(tb, path, 7, res, shift)
        cp = path + ("ChannelProcessing_0",)
        self.linear(f"{tb}.chnnel_processing.qv", cp + ("Dense_0",),
                    bias=True)
        self.vec(f"{tb}.chnnel_processing.temperature", cp + ("temperature",))
        self.bn(f"{tb}.norm3", path + ("BatchNorm_1",))

    def mbconv(self, tb: str, path: Tuple[str, ...], use_se: bool) -> None:
        """EffiAlterNet's MBConv at the reference's conv.{i} indices."""
        self.conv(f"{tb}.conv.0", path + ("EConv_0",))
        self.bn(f"{tb}.conv.1", path + ("BatchNorm_0",))
        self.conv(f"{tb}.conv.3", path + ("EConv_1",))
        self.bn(f"{tb}.conv.4", path + ("BatchNorm_1",))
        if use_se:
            se = path + ("SELayer_0",)
            self.linear(f"{tb}.conv.6.fc.0", se + ("Dense_0",), bias=True)
            self.linear(f"{tb}.conv.6.fc.2", se + ("Dense_1",), bias=True)
            self.conv(f"{tb}.conv.7", path + ("EConv_2",))
            self.bn(f"{tb}.conv.8", path + ("BatchNorm_2",))

    def local_attention_block(self, tb: str, path: Tuple[str, ...]) -> None:
        """AlterNetV1's AttentionBasicBlockB (identity skip). flax numbers
        the Attention2d's convs in call order: its q Conv wrapper Conv_0,
        the bare nn.Conv of kv Conv_1 (the two share the class name), the
        output wrapper Conv_2."""
        self.bn(f"{tb}.norm1", path + ("BatchNorm_0",))
        self.conv(f"{tb}.conv", path + ("Conv_0",))
        self.bn(f"{tb}.norm2", path + ("BatchNorm_1",))
        la = path + ("LocalAttention_0",)
        self.vec(f"{tb}.attn.pos_embedding", la + ("pos_embedding",))
        a2 = la + ("Attention2d_0",)
        self.conv(f"{tb}.attn.attn.to_q", a2 + ("Conv_0",))
        self.entries.append(_Entry(f"{tb}.attn.attn.to_kv.weight", "params",
                                   a2 + ("Conv_1", "kernel"), "conv"))
        self.conv(f"{tb}.attn.attn.to_out.0", a2 + ("Conv_2",), bias=True)

    def head(self) -> None:
        self.bn("bn2", ("BatchNorm_1",))
        self.linear("fc", ("Dense_0", "Dense_0"), bias=True)
        self.bn("bn3", ("BatchNorm_2",))


def _resnet_table(layers: Sequence[int]) -> _Table:
    t = _Table()
    t.conv("conv1", ("Conv_0",))
    t.bn("bn1", ("BatchNorm_0",))
    i = 0
    for stage, blocks in enumerate(layers, start=1):
        for b in range(blocks):
            t.basic_block(f"layer{stage}.{b}", (f"BasicBlock_{i}",),
                          downsample=stage > 1 and b == 0)
            i += 1
    t.head()
    return t


def _alternet_table(num_blocks: Sequence[int], num_blocks2: Sequence[int],
                    img_size: int = 192, variant: str = "AlterNet") -> _Table:
    """Walks the stage plan in construction order: flax numbers modules per
    type (BasicBlock_i, AlterSwinBlock_j or AttentionBasicBlockB_j), the
    reference per stage (layer{s}.{k}). ``variant``: "AlterNet" (W-MSA /
    SW-MSA pairs, windows 6, 6, 6, 3), "Sep" (single unshifted window-7
    blocks) or "V1" (AttentionBasicBlockB)."""
    t = _Table()
    t.conv("conv1", ("Conv_0",))
    t.bn("bn1", ("BatchNorm_0",))
    basic_i = attn_i = 0
    res = img_size // 4
    placement = alt_sequence if variant == "AlterNet" else alt_sequence_sep
    for stage, (blocks, blocks2, win) in enumerate(
            zip(num_blocks, num_blocks2, (6, 6, 6, 3)), start=1):
        if stage > 1:
            res //= 2
        k = 0
        for slot, is_alt in enumerate([False]
                                      + list(placement(blocks, blocks2))):
            if not is_alt:
                t.basic_block(f"layer{stage}.{k}", (f"BasicBlock_{basic_i}",),
                              downsample=stage > 1 and slot == 0)
                basic_i += 1
                k += 1
                continue
            if variant == "V1":
                t.local_attention_block(
                    f"layer{stage}.{k}", (f"AttentionBasicBlockB_{attn_i}",))
                attn_i += 1
                k += 1
                continue
            shifts = (0,) if variant == "Sep" else (0, win // 2)
            for shift in shifts:
                t.attention(f"layer{stage}.{k}",
                            (f"AlterSwinBlock_{attn_i}",),
                            7 if variant == "Sep" else win, res, shift)
                attn_i += 1
                k += 1
    t.head()
    return t


def _swin_table(num_blocks: Sequence[int]) -> _Table:
    """flax numbers the stem conv Conv_0 and each stage's k2/s2 conv
    Conv_1.. (top level), blocks SwinBlock_i; the reference puts the
    downsampling conv at layer{s}.0."""
    t = _Table()
    t.conv("conv1", ("Conv_0",))
    t.bn("bn1", ("BatchNorm_0",))
    conv_i = 1
    block_i = 0
    for stage, (blocks, stride) in enumerate(zip(num_blocks, (1, 2, 2, 2)),
                                             start=1):
        k = 0
        if stride > 1:
            t.conv(f"layer{stage}.0", (f"Conv_{conv_i}",))
            conv_i += 1
            k = 1
        for _ in range(blocks):
            t.swin_block(f"layer{stage}.{k}", (f"SwinBlock_{block_i}",))
            block_i += 1
            k += 1
    t.head()
    return t


def _effialter_table(cfgs, img_size: int = 112) -> _Table:
    """features.0 is the stem (EConv_0, BatchNorm_0); then MBConv_i and
    FANSwinBlock_j in construction order, walked with fr_tpu's resolution
    bookkeeping; the head is Dense_0 (kernel and bias at the top) and
    BatchNorm_1."""
    t = _Table()
    t.conv("features.0.0", ("EConv_0",))
    t.bn("features.0.1", ("BatchNorm_0",))
    k = 1
    mb_i = fan_i = 0
    for cfg, res, seq in stage_plan(cfgs, img_size):
        use_se = bool(cfg[4])
        for is_alt in [False] + seq:
            if not is_alt:
                t.mbconv(f"features.{k}", (f"MBConv_{mb_i}",), use_se)
                mb_i += 1
                k += 1
                continue
            for shift in ((0, 3) if res > 7 else (0,)):
                t.fan_block(f"features.{k}", (f"FANSwinBlock_{fan_i}",),
                            res, shift)
                fan_i += 1
                k += 1
    t.linear("fc", ("Dense_0",), bias=True)
    t.bn("bn", ("BatchNorm_1",))
    return t


def _table(network: str, img_size: Optional[int] = None,
           plan: Optional[Tuple] = None) -> _Table:
    """``plan`` overrides the named network's stage plan: ResNet layers,
    AlterNet, AlterNetSep or AlterNetV1 (num_blocks, num_blocks2), Swin
    num_blocks or EffiAlterNet cfgs. Dispatch in fr_tpu's order."""
    if "EffiAlter" in network:
        return _effialter_table(plan or EFFIALTER_CFGS[network],
                                img_size or 112)
    if "AlterNetV1" in network:
        num_blocks, num_blocks2 = plan or ALTERNET_V1_PLANS[network]
        return _alternet_table(num_blocks, num_blocks2, img_size or 112,
                               "V1")
    if "AlterNetSep" in network:
        num_blocks, num_blocks2 = plan or ALTERNET_SEP_PLANS[network][:2]
        return _alternet_table(num_blocks, num_blocks2, img_size or 112,
                               "Sep")
    if "AlterNet" in network:
        num_blocks, num_blocks2 = plan or ALTERNET_PLANS[network][:2]
        return _alternet_table(num_blocks, num_blocks2, img_size or 192)
    if "Swin" in network:
        return _swin_table(plan or SWIN_PLANS[network][0])
    if "ResNet" in network:
        return _resnet_table(plan or RESNET_LAYERS[network])
    raise ValueError(f"Unknown network {network!r}")


def _get(tree: Mapping, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def _set(tree: Tree, path: Tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _to_torch(leaf, kind: str) -> torch.Tensor:
    x = np.array(leaf, dtype=np.float32)
    if kind in _TO_TORCH:
        x = np.ascontiguousarray(np.transpose(x, _TO_TORCH[kind]))
    return torch.from_numpy(x)


def _to_flax(t: torch.Tensor, kind: str) -> np.ndarray:
    x = t.detach().float().cpu().numpy()
    if kind in _TO_FLAX:
        x = np.ascontiguousarray(np.transpose(x, _TO_FLAX[kind]))
    return x


def encoder_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                                network: str, img_size: Optional[int] = None,
                                plan: Optional[Tuple] = None) -> StateDict:
    """fr_tpu (params, batch_stats) → the port's state_dict."""
    table = _table(network, img_size, plan)
    trees = {"params": params, "batch_stats": batch_stats}
    sd = {e.key: _to_torch(_get(trees[e.tree], e.path), e.kind)
          for e in table.entries}
    sd.update({k: v.clone() for k, v in table.fixed.items()})
    return sd


def encoder_trees_from_state_dict(state_dict: Mapping[str, torch.Tensor],
                                  network: str,
                                  img_size: Optional[int] = None,
                                  plan: Optional[Tuple] = None
                                  ) -> Tuple[Tree, Tree]:
    """The inverse: the port's state_dict → fr_tpu (params, batch_stats) as
    numpy trees."""
    trees: Dict[str, Tree] = {"params": {}, "batch_stats": {}}
    for e in _table(network, img_size, plan).entries:
        _set(trees[e.tree], e.path, _to_flax(state_dict[e.key], e.kind))
    return trees["params"], trees["batch_stats"]


def _unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        _set(tree, tuple(key.split(".")), v)
    return tree


def _flatten(tree: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def load_encoder_npz(path: str, network: str,
                     img_size: Optional[int] = None,
                     plan: Optional[Tuple] = None) -> StateDict:
    """Read an fr_tpu encoder snapshot (flattened ``params.*`` and
    ``batch_stats.*`` arrays) with numpy alone."""
    with np.load(path, allow_pickle=False) as data:
        params = {k[len("params."):]: data[k] for k in data.files
                  if k.startswith("params.")}
        stats = {k[len("batch_stats."):]: data[k] for k in data.files
                 if k.startswith("batch_stats.")}
    return encoder_state_dict_from_jax(_unflatten(params), _unflatten(stats),
                                       network, img_size, plan)


def export_encoder_npz(path: str, encoder: torch.nn.Module, epoch: int,
                       network: str, img_size: Optional[int] = None,
                       plan: Optional[Tuple] = None) -> None:
    """Write the ``{epoch}_epoch_encoder.npz`` snapshot in fr_tpu's layout
    (fr_tpu/ckpt/checkpoint.py export_encoder)."""
    params, stats = encoder_trees_from_state_dict(encoder.state_dict(),
                                                  network, img_size, plan)
    flat = _flatten(params, "params")
    flat.update(_flatten(stats, "batch_stats"))
    np.savez(path, __epoch__=epoch, __name__=network, **flat)


def train_state_from_jax(jax_state, encoder: torch.nn.Module, network: str,
                         img_size: Optional[int] = None,
                         plan: Optional[Tuple] = None, seed: int = 0):
    """fr_tpu's TrainState (arrays readable by np.asarray) → the port's
    TrainState around ``encoder``, on the encoder's device: weights and BN
    statistics, the encoder's optimizer slots through the same entries as
    the parameters (transposes included), the head weight, slots and count,
    and the step. fr_tpu's state holds no generator (its keys derive
    from the step); the port's three streams are seeded from ``seed``."""
    from fr_tpu_torch.heads.partial_fc import PFCState
    from fr_tpu_torch.train.state import TrainState, stream_generators

    def host(tree):
        if isinstance(tree, Mapping):
            return {k: host(v) for k, v in tree.items()}
        return np.asarray(tree)

    device = next(encoder.parameters()).device
    encoder.load_state_dict(encoder_state_dict_from_jax(
        host(jax_state.params), host(jax_state.batch_stats), network,
        img_size, plan), strict=True)
    entries = [e for e in _table(network, img_size, plan).entries
               if e.tree == "params"]
    names = [n for n, _ in encoder.named_parameters()]
    if sorted(names) != sorted(e.key for e in entries):
        raise ValueError("the encoder's parameters do not match fr_tpu's "
                         "parameter tree")
    opt_slots = {}
    for slot, tree in jax_state.opt_slots.items():
        tree = host(tree)
        opt_slots[slot] = {e.key: _to_torch(_get(tree, e.path), e.kind)
                           .to(device) for e in entries}
    pfc = PFCState(
        weight=torch.from_numpy(np.array(jax_state.pfc.weight, np.float32)
                                ).to(device),
        slots={k: torch.from_numpy(np.array(v, np.float32)).to(device)
               for k, v in jax_state.pfc.slots.items()},
        count=int(np.asarray(jax_state.pfc.count)))
    return TrainState(step=int(np.asarray(jax_state.step)), encoder=encoder,
                      opt_slots=opt_slots, pfc=pfc,
                      generators=stream_generators(seed, device))


def train_state_to_jax_layout(state, network: str,
                              img_size: Optional[int] = None,
                              plan: Optional[Tuple] = None) -> Dict[str, Any]:
    """The port's TrainState in fr_tpu's layout, as numpy: {"step",
    "params", "batch_stats", "opt_slots", "pfc": {"weight", "slots",
    "count"}}, for holding it against fr_tpu's state leaf by leaf."""
    params, stats = encoder_trees_from_state_dict(
        state.encoder.state_dict(), network, img_size, plan)
    opt_slots = {}
    for slot, tensors in state.opt_slots.items():
        tree: Tree = {}
        for e in _table(network, img_size, plan).entries:
            if e.tree == "params":
                _set(tree, e.path, _to_flax(tensors[e.key], e.kind))
        opt_slots[slot] = tree
    return {"step": state.step, "params": params, "batch_stats": stats,
            "opt_slots": opt_slots,
            "pfc": {"weight": state.pfc.weight.detach().cpu().numpy(),
                    "slots": {k: v.detach().cpu().numpy()
                              for k, v in state.pfc.slots.items()},
                    "count": state.pfc.count}}
