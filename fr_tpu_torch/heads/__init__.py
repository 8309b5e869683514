"""Margin-softmax heads (counterpart of fr_tpu/heads)."""
from fr_tpu_torch.heads.margins import arcface, cosface, combined_margin, get_margin_fn  # noqa: F401
