"""The yardstick's arithmetic: the published peaks (peaks.json), the
bound of a piece of work (the larger of its bytes over the memory rate
and its operations over the compute rate, as the port's kernel table
computes it), the encoder's bytes and the MLPs' operations of a
configuration."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parents[1]
                    / "peaks.json").read_text())


def peak_flops(dtype: str, tf32: bool = False) -> float:
    """Compute peak of a configuration's compute dtype (TF32's when a
    float32 configuration lets matmuls use it)."""
    if dtype == "float32" and tf32:
        return PEAKS["flops_per_s"]["tf32"]
    return PEAKS["flops_per_s"][dtype]


def bound_s(nbytes: float, flops: float = 0.0, dtype: str = "float32"):
    """(seconds, "bytes" or "operations"): the least time the card
    could take, bytes read and written once at the HBM rate against the
    operations at the dtype's peak."""
    tb = nbytes / PEAKS["hbm_bytes_per_s"]
    to = flops / peak_flops(dtype)
    return (tb, "bytes") if tb >= to else (to, "operations")


DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def encoder_rows(spec, samples: int) -> int:
    """Table rows read for `samples` encoded points: one per level, and
    eight (one per cell corner) where a row holds a single vertex."""
    return samples * spec.n_levels * (1 if spec.encoder == "packed" else 8)


def encoder_forward_bytes(spec, samples: int, gather: str) -> int:
    """The rows gathered (in the gather dtype) and their int32 indices,
    read once; the float32 features written once."""
    rows = encoder_rows(spec, samples)
    row_bytes = spec.row_width * DTYPE_BYTES[gather]
    return rows * (row_bytes + 4) + samples * spec.enc_dim * 4


def encoder_backward_bytes(spec, samples: int) -> int:
    """The features' float32 gradient and the rows' int32 indices, read
    once; the float32 table gradient written once."""
    rows = encoder_rows(spec, samples)
    table = spec.n_levels * spec.table_rows * spec.row_width * 4
    return samples * spec.enc_dim * 4 + rows * 4 + table


def train_step_flops(spec, samples: int) -> float:
    """Both MLPs forward and backward (3 x 2 x MACs) per sample."""
    from portbench.reference.field import mlp_macs
    return 6.0 * mlp_macs(spec) * samples


def density_flops(spec, points: int) -> float:
    from portbench.reference.field import sigma_macs
    return 2.0 * sigma_macs(spec) * points


def view_flops(spec, samples: int) -> float:
    from portbench.reference.field import mlp_macs
    return 2.0 * mlp_macs(spec) * samples
