"""Bias-free ReLU MLPs (port of google_nerf_tpu/models/mlp.py)."""
from __future__ import annotations

from typing import Sequence

import torch


def init_mlp(generator: torch.Generator, dims: Sequence[int],
             device="cuda", dtype=torch.float32):
    """dims = [in, hidden..., out] -> list of (din, dout) weights,
    Kaiming-uniform fan-in init U[-sqrt(6/din), sqrt(6/din)]."""
    ws = []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = (6.0 / din) ** 0.5
        u = torch.rand((din, dout), generator=generator, dtype=dtype)
        ws.append(((2.0 * u - 1.0) * bound).to(device))
    return ws


def _dot(h, w, compute_dtype):
    """JAX's dot(h, w, preferred_element_type=f32) with both operands cast
    to compute_dtype: an f32-accumulated product of rounded operands whose
    output is NOT rounded back (a bf16 torch.matmul would round it)."""
    return h.to(compute_dtype).float() @ w.to(compute_dtype).float()


def mlp_apply(ws, x, *, compute_dtype=torch.float32):
    """ReLU MLP forward, no activation on the output layer; f32 output."""
    h = x
    for w in ws[:-1]:
        h = torch.relu(_dot(h, w, compute_dtype)).to(compute_dtype)
    return _dot(h, ws[-1], compute_dtype)
