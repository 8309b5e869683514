"""Write reference ``.pth`` encoder snapshots (counterpart of
fr_tpu/utils/torch_export.py:368-377).

The reference loads ``{model_state_dict, epoch, name}`` with
``load_state_dict(..., strict=True)`` (reference model/FR_PartialFC.py:76-90,
written by utils/trainer.py:107-115). The port's modules already use that
state-dict naming, buffers included, so the snapshot is the encoder's own
state dict, copied to the CPU; fr_tpu has to translate its flax trees
instead. ``utils/torch_import.load_encoder_pth`` reads the file back.
"""

from __future__ import annotations

from typing import Mapping, Union

import torch


def export_encoder_pth(path: str,
                       encoder: Union[torch.nn.Module,
                                      Mapping[str, torch.Tensor]],
                       network: str, epoch: int = 0) -> None:
    """Write the encoder (a module or its state dict) as a reference
    snapshot. AlterNetSep and AlterNetV1 raise NotImplementedError, as
    fr_tpu's export dispatch does (torch_export.py:347-365): the reference
    naming has no counterpart for them."""
    if "AlterNet" in network and ("V1" in network or "Sep" in network):
        raise NotImplementedError(
            f"reference checkpoint export not implemented for {network}")
    state = (encoder.state_dict() if isinstance(encoder, torch.nn.Module)
             else encoder)
    sd = {k: v.detach().cpu().clone() for k, v in state.items()}
    torch.save({"model_state_dict": sd, "epoch": epoch, "name": network},
               path)
