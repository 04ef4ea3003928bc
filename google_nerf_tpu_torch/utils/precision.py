"""Float32 scopes for cuDNN and cuBLAS.

On the card cuDNN runs float32 convolutions in TF32 unless told
otherwise, and JAX's float32 references do not.  `exact_f32` turns TF32
off for cuDNN and for cuBLAS products inside its scope and keeps cuDNN
on: `torch.backends.cudnn.flags(allow_tf32=False)` alone would also turn
cuDNN off, since its `enabled` defaults to False.  The flags are read
when each op runs, so a backward pass needs the scope around
`.backward()` as well as around the forward.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """cuDNN convolutions and cuBLAS products without TF32 in this scope
    (cuDNN stays on; its other settings are kept).  Every flag it sets is
    restored on leaving, also on an exception."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = was
