"""Read reference ``.pth`` encoder snapshots (counterpart of
fr_tpu/utils/torch_import.py:24 and :372-388).

The reference writes ``{model_state_dict, epoch, name}`` with
``torch.save`` (fr_tpu's ``export_encoder_pth`` writes the same schema). The
port's modules use that state-dict naming, buffers included, so the reader
is the state dict itself: ``model_state_dict`` where the file holds one, else
the whole dict, with DDP's ``module.`` prefix stripped, loaded strictly.
fr_tpu translates it into flax trees instead; the strict load is the
port's check that every name and shape lines up.

The file is read with ``weights_only=True``: the schema is tensors, an int
and a string, which torch's restricted unpickler takes. fr_tpu passes
``weights_only=False``; a file that needs it (arbitrary pickled objects) is
refused here rather than executed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove the DDP ``module.`` prefix (fr_tpu torch_import.py:24)."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_encoder_pth(path: str, network: str) -> Dict[str, torch.Tensor]:
    """The encoder state dict of a reference ``.pth``/``.pt`` snapshot, on
    the CPU. AlterNetV1 (fr_tpu raises for it, torch_import.py:387) and
    AlterNetSep (fr_tpu's export has no naming for it,
    torch_export.py:355) raise NotImplementedError."""
    if "AlterNet" in network and ("V1" in network or "Sep" in network):
        raise NotImplementedError(
            f"reference checkpoint import not implemented for {network}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(ckpt.get("model_state_dict", ckpt))
