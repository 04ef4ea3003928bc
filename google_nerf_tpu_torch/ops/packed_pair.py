"""Paired-level packed hash encoding, two resolution levels a table row
(port of google_nerf_tpu/ops/packed_pair.py, the `packed2` encoder).

A row of pair p, keyed by its PARENT cell (resolution R), holds

    [ the parent cell's 8 corners x F  |  the child 3x3x3 vertex grid
      (resolution 2R) x F ]  = 35F floats,

so the child level is continuous inside a parent cell.  Keys, fracs and
corner weights are the packed encoder's (ops/packed_hash.py).

The forward is one row gather per (sample, pair): P2 (`gather_rows`,
ops/cuda/probe.py) on the table cast to the gather dtype.  P2 moves
16-byte words and a bf16 row of 35F = 70 values is 140 bytes, so the
gather reads a copy padded to the next 16 bytes (72 columns, 144 bytes)
and drops the pad.  The backward is JAX's custom VJP in f32: the table
gradient sums the payloads [w8 (x) g_parent | w27 (x) g_child] per
(pair, key) with P3 (`scatter_add_rows`); dx chains both levels' fracs
(d ff / d fp = 2).  CPU tensors take P2's and P3's plain versions.  The
gather and scatter are looked up on this module at call time, so a
caller can swap in the plain versions on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from google_nerf_tpu_torch.ops.cuda.probe import gather_rows, scatter_add_rows
from google_nerf_tpu_torch.ops.packed_hash import (_cell_keys, _consts,
                                                   _corner_weight_grads,
                                                   _corner_weights,
                                                   _rows_index)


@dataclasses.dataclass(frozen=True)
class PackedPairConfig:
    n_pairs: int = 4              # table count; effective levels = 2x
    n_features: int = 2           # features per level (out = 2*P*F)
    log2_table_size: int = 16     # parent cells per pair table
    base_resolution: int = 16     # coarsest PARENT resolution
    per_pair_scale: float = 3.17  # parent resolution ratio between pairs
    table_dtype: str = "bfloat16"  # gather dtype (params stay f32)

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def resolutions(self):
        """PARENT resolutions (P,): the row key lattice."""
        return tuple(
            int(np.floor(self.base_resolution * self.per_pair_scale ** p))
            for p in range(self.n_pairs))

    @property
    def child_resolutions(self):
        return tuple(2 * r for r in self.resolutions)

    @property
    def all_resolutions(self):
        """The 2P effective levels, resolution-ascending per pair."""
        out = []
        for r in self.resolutions:
            out += [r, 2 * r]
        return tuple(out)

    @property
    def row_width(self) -> int:
        return 35 * self.n_features          # 8 parent + 27 child

    @property
    def out_dim(self) -> int:
        return 2 * self.n_pairs * self.n_features


def packed_pair_config_for_scale(scale: float, n_pairs: int = 4,
                                 max_resolution: int = 0,
                                 **kw) -> PackedPairConfig:
    """The reference's N_min..N_max span (N_max = 2048*scale): the finest
    CHILD level lands at N_max, so parents span N_min .. N_max/2."""
    n_min = kw.pop("base_resolution", 16)
    n_max = max(max_resolution or 2048 * scale, 2 * n_min + 1)
    b = float(np.exp(np.log(n_max / 2.0 / n_min) / max(n_pairs - 1, 1)))
    return PackedPairConfig(n_pairs=n_pairs, base_resolution=n_min,
                            per_pair_scale=b, **kw)


def init_packed_pair(generator: torch.Generator, cfg: PackedPairConfig,
                     device="cuda") -> torch.Tensor:
    """(P, T, 35F) f32, U[-1e-4, 1e-4] (tcnn's init)."""
    u = torch.rand((cfg.n_pairs, cfg.table_size, cfg.row_width),
                   generator=generator, dtype=torch.float32)
    return ((2.0 * u - 1.0) * 1e-4).to(device)


def _child_axis_weights(ci, ff):
    """ci: (..., 3) in {0., 1.} (which 2x2x2 sub-cell), ff: (..., 3) frac
    inside it -> (..., 3 axes, 3 vertices): the linear weight of child
    vertex v in {0, 1, 2} along each axis."""
    u0 = (1.0 - ci) * (1.0 - ff)
    u1 = (1.0 - ci) * ff + ci * (1.0 - ff)
    u2 = ci * ff
    return torch.stack([u0, u1, u2], -1)


def _outer27(a, b, c):
    """(..., 3) x3 -> (..., 27), index (i*3 + j)*3 + k (x outermost)."""
    w = a[..., :, None, None] * b[..., None, :, None] * c[..., None, None, :]
    return w.reshape(w.shape[:-3] + (27,))


def _child_weights(ci, ff):
    """(..., 27) trilinear weights over the 3^3 child vertex grid."""
    u = _child_axis_weights(ci, ff)
    return _outer27(u[..., 0, :], u[..., 1, :], u[..., 2, :])


def _child_weight_grads(ci, ff):
    """d w27 / d ff_k: (..., 27, 3)."""
    u = _child_axis_weights(ci, ff)
    du = torch.stack([-(1.0 - ci), (1.0 - ci) - ci, ci], -1)  # (..., 3, 3)
    grads = []
    for k in range(3):
        fac = [u[..., j, :] for j in range(3)]
        fac[k] = du[..., k, :]
        grads.append(_outer27(*fac))
    return torch.stack(grads, -1)


def _pair_geometry(x, cfg: PackedPairConfig):
    """Parent keys (P, N), parent frac fp, child sub-cell ci and frac ff
    (P, N, 3), weights w8 (P, N, 8) and w27 (P, N, 27)."""
    keys, fp = _cell_keys(x, cfg)
    ci = torch.clamp_max(torch.floor(fp * 2.0), 1.0).detach()
    ff = fp * 2.0 - ci
    return keys, fp, ci, ff, _corner_weights(fp), _child_weights(ci, ff)


def _padded_rows(table, dtype):
    """table (P, T, W) -> (P*T, Wp) of dtype, Wp*size the next multiple
    of 16 bytes (P2's word): cast and padded in one pass into one
    buffer."""
    P, T, W = table.shape
    per_word = 16 // torch.tensor([], dtype=dtype).element_size()
    Wp = W + (-W % per_word)
    tab = torch.empty((P * T, Wp), dtype=dtype, device=table.device)
    tab[:, W:] = 0
    tab[:, :W].copy_(table.reshape(P * T, W))
    return tab


class _PackedPairEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, x, cfg):
        P, T, W = table.shape
        Fd = cfg.n_features
        n = x.shape[0]
        keys, fp, ci, ff, w8, w27 = _pair_geometry(x, cfg)
        idx = _rows_index(keys, T)
        tab = _padded_rows(table, getattr(torch, cfg.table_dtype))
        rows = gather_rows(tab, idx)[:, :W].reshape(P, n, W)
        rowsf = rows.float()
        rp = rowsf[..., :8 * Fd].reshape(P, n, 8, Fd)
        rc = rowsf[..., 8 * Fd:].reshape(P, n, 27, Fd)
        feat_p = (w8[..., None] * rp).sum(-2)                 # (P, N, F)
        feat_c = (w27[..., None] * rc).sum(-2)
        out = torch.stack([feat_p, feat_c], 2)                # (P, N, 2, F)
        ctx.cfg, ctx.shape = cfg, (P, T, W)
        ctx.save_for_backward(idx, fp, ci, ff, w8, w27, rows)
        return out.permute(1, 0, 2, 3).reshape(n, 2 * P * Fd)

    @staticmethod
    def backward(ctx, g):
        idx, fp, ci, ff, w8, w27, rows = ctx.saved_tensors
        cfg, (P, T, W) = ctx.cfg, ctx.shape
        Fd = cfg.n_features
        n = fp.shape[1]
        g = g.float().reshape(n, P, 2, Fd)
        gp = g[:, :, 0].permute(1, 0, 2)                      # (P, N, F)
        gc = g[:, :, 1].permute(1, 0, 2)
        dtable = dx = None
        if ctx.needs_input_grad[0]:
            payload = torch.cat([
                (w8[..., :, None] * gp[..., None, :]).reshape(P, n, 8 * Fd),
                (w27[..., :, None] * gc[..., None, :]).reshape(P, n,
                                                               27 * Fd)],
                -1).reshape(P * n, W)
            dtable = scatter_add_rows(idx, payload, P * T).view(P, T, W)
        if ctx.needs_input_grad[1]:
            rowsf = rows.float()
            rp = rowsf[..., :8 * Fd].reshape(P, n, 8, Fd)
            rc = rowsf[..., 8 * Fd:].reshape(P, n, 27, Fd)
            rg8 = (rp * gp[..., None, :]).sum(-1)             # (P, N, 8)
            dfp = (rg8[..., None] * _corner_weight_grads(fp)).sum(-2)
            rg27 = (rc * gc[..., None, :]).sum(-1)            # (P, N, 27)
            dff = (rg27[..., None] * _child_weight_grads(ci, ff)).sum(-2)
            res = _consts(cfg, str(fp.device))[1]
            dx = ((dfp + 2.0 * dff) * res[:, None, None]).sum(0)
        return dtable, dx, None


def packed_pair_encode(table, x, cfg: PackedPairConfig):
    """table: (P, T, 35F) f32; x: (N, 3) in [0, 1] -> (N, 2*P*F) f32,
    features [pair0 parent F, pair0 child F, pair1 parent F, ...], with
    the custom gradient described in the module notes."""
    return _PackedPairEncode.apply(table, x, cfg)


def packed_pair_encode_ref(table, x, cfg: PackedPairConfig):
    """Plain differentiable restatement (autograd, f32 rows, no dtype
    tricks), for tests."""
    P, T, W = table.shape
    Fd = cfg.n_features
    n = x.shape[0]
    keys, fp, ci, ff, w8, w27 = _pair_geometry(x, cfg)
    outs = []
    for p in range(P):
        rows = table[p][keys[p]]                              # (N, 35F)
        rp = rows[:, :8 * Fd].reshape(n, 8, Fd)
        rc = rows[:, 8 * Fd:].reshape(n, 27, Fd)
        outs.append((w8[p][..., None] * rp).sum(1))
        outs.append((w27[p][..., None] * rc).sum(1))
    return torch.stack(outs, 1).reshape(n, 2 * P * Fd)
