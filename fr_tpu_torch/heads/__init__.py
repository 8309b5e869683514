"""Margin-softmax heads (counterpart of fr_tpu/heads)."""
