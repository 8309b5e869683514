"""fr_tpu_torch — the PyTorch/CUDA port of fr_tpu for NVIDIA Hopper.

A second package beside ``fr_tpu`` (the JAX reference, which stays as it
is). Module names mirror ``fr_tpu``; public functions keep its layouts (NHWC
images, window-attention qkv as (B·nW, N, 3C)). Every Pallas kernel on a
ported path becomes a hand-written CUDA C++ kernel for sm_90a under
``csrc/``, built at first use by ``ops/_build.py``; beside each kernel sits
its plain PyTorch version, which CPU tensors take.

Ported so far, for every encoder of fr_tpu (IR-ResNet, AlterNet,
AlterNetSep, AlterNetV1, Swin, EffiAlterNet) at its reference widths, and
with every one of fr_tpu's eighteen TPU kernels, its opt-in attention
variants included: the serving path (``--mode test``: encoder in eval mode,
L2-normalised embeddings, pair scores and the 100001-bin ROC report) and
the one-GPU training path (``--mode train``: augmentation, the PartialFC
margin-softmax head with per-row or block-aligned negative sampling,
backward, clip, SGD/AdamW with sampled-row head updates, full-state
checkpoints with exact resume), and the data and evaluation layer (image
folder, packed and card-resident training corpora, bcolz pair roots and
csv cross sets, pair and cross scoring on the host through a native C++
library or on the card). This package imports torch and never jax, and
nothing of ``fr_tpu``.
"""

__version__ = "0.2.0"
