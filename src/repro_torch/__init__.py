"""PyTorch/CUDA port of the k-FED one-shot federated clustering system.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``kernels/``, ``core/``, ``fed/``, ``data/``, ``utils/``) so each
module's counterpart is found by path. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on a CUDA tensor every kernel
of the main path is a hand-written Hopper kernel (``kernels/csrc``), on a
CPU tensor its plain PyTorch version (``kernels/ref.py``).

Float32 matrix products must run in full IEEE float32 for parity with
the reference, so importing this package turns TF32 off for both
cuBLAS (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN
(``torch.backends.cudnn.allow_tf32``).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
