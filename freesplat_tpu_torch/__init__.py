"""FreeSplat in PyTorch for NVIDIA Hopper (H100).

A port of ``freesplat_tpu`` (the JAX/TPU package, which stays the numeric
reference).  The package mirrors the JAX layout (``geometry/``, ``ops/``,
``models/``, ``config/``, ``evaluation/``, ``training/``, ``utils/``) and
function names; public functions keep NHWC image layout.  It imports no
JAX and nothing of ``freesplat_tpu``.

Precision is set once, here: float32 matmuls and convolutions run in full
float32 (no TF32), because the port is held against float32 JAX and TF32
keeps only about three decimal digits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
