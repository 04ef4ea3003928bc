"""Plain reference of the Instant-NGP radiance field in PyTorch: the
multiresolution hash grid (Mueller et al. 2022, section 3) and its
packed-corner variant, spherical harmonics of degree 4 for the view
direction, the bias-free ReLU density and colour MLPs and the truncated
exponential density.

Precision is explicit: `Precision` names the dtype each matmul's
operands are rounded to (forward and backward), whether float32
matmuls may use TF32, and the dtype the table's rows are read in.  The
products are accumulated in float32.  The table gradient is float32:
rows are rounded to the gather dtype on the forward only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2}


@dataclasses.dataclass(frozen=True)
class Precision:
    compute: str = "float32"        # matmul operands, forward
    compute_grad: str = ""          # matmul cotangents ("" = compute)
    gather: str = "bfloat16"        # table rows as read
    tf32: bool = False

    @contextlib.contextmanager
    def matmul_mode(self):
        """TF32 on or off for the float32 matmuls inside the block."""
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old


def precision_of(block: Dict, control: bool = False) -> Precision:
    """A configuration's "precision" block; with control, its "control"
    entries (the next precision down) laid over it."""
    kw = dict(compute=block["compute"], gather=block["gather"],
              tf32=block["tf32"])
    if control:
        kw.update(block["control"])
    return Precision(**kw)


class _Round(torch.autograd.Function):
    """x rounded to `fwd` on the forward, its cotangent to `bwd`."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return x.to(fwd).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.bwd).float(), None, None


def round_to(x, prec: Precision):
    if prec.compute == "float32":
        return x
    return _Round.apply(x, DTYPES[prec.compute],
                        DTYPES[prec.compute_grad or prec.compute])


def round_values(x, dtype: str):
    """x rounded to dtype on the forward; the gradient passes unrounded."""
    if dtype == "float32":
        return x
    return x + (x.to(DTYPES[dtype]).float() - x).detach()


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def level_resolutions(n_levels: int, n_min: int, n_max: float) -> List[int]:
    """floor(N_min * b^l), b = exp(ln(N_max / N_min) / (L - 1))."""
    b = float(np.exp(np.log(n_max / n_min) / max(n_levels - 1, 1)))
    return [int(np.floor(n_min * b ** l)) for l in range(n_levels)]


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """The field's sizes, from a configuration file's "model" block."""
    encoder: str                    # "hash" | "packed"
    scale: float
    n_levels: int
    n_features: int
    log2_table: int
    resolutions: tuple
    sigma_width: int
    geo_feat_dim: int
    rgb_width: int
    rgb_layers: int

    @property
    def table_rows(self) -> int:
        return 1 << self.log2_table

    @property
    def row_width(self) -> int:
        """Table columns: F, or 8F for a packed row of 8 corners."""
        return self.n_features * (8 if self.encoder == "packed" else 1)

    @property
    def enc_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def sigma_dims(self):
        return [self.enc_dim, self.sigma_width, self.geo_feat_dim]

    @property
    def rgb_dims(self):
        return ([16 + self.geo_feat_dim] + [self.rgb_width] * self.rgb_layers
                + [3])


def field_spec(model: Dict) -> FieldSpec:
    """The spec of a configuration's "model" block (NGPConfig's keys)."""
    enc = model["encoder"]
    n_min = model.get("base_resolution", 16)
    if enc == "hash":
        L, F, log2 = (model["num_levels"], model["n_features"],
                      model["log2_hashmap_size"])
        n_max = 2048 * model["scale"]
    elif enc == "packed":
        L, F, log2 = (model["packed_levels"], model["packed_features"],
                      model["packed_log2_size"])
        n_max = max(model.get("packed_max_res", 0) or 2048 * model["scale"],
                    n_min + 1)
    else:
        raise ValueError(f"the reference has no encoder {enc!r}")
    return FieldSpec(enc, model["scale"], L, F, log2,
                     tuple(level_resolutions(L, n_min, n_max)),
                     model["sigma_width"], model["geo_feat_dim"],
                     model["rgb_width"], model["rgb_layers"])


def _hash(c, T: int):
    return (((c[..., 0] * PRIMES[0]) & U32) ^ ((c[..., 1] * PRIMES[1]) & U32)
            ^ ((c[..., 2] * PRIMES[2]) & U32)) & (T - 1)


_BITS = [[(c >> k) & 1 for k in range(3)] for c in range(8)]


def _corner_weights(frac):
    """frac (..., 3) -> (..., 8): corner c takes bit (c >> k) & 1 on k."""
    bits = torch.tensor(_BITS, device=frac.device) == 1
    f = frac[..., None, :]
    w = torch.where(bits, f, 1.0 - f)
    return w[..., 0] * w[..., 1] * w[..., 2]


def _cells(spec: FieldSpec, x01):
    """Lower cell corner (L, N, 3) int64, fraction (L, N, 3), res (L,)."""
    res_f = torch.tensor(spec.resolutions, dtype=torch.float32,
                         device=x01.device)[:, None, None]
    pos = x01[None] * res_f
    c0 = torch.minimum(torch.clamp_min(torch.floor(pos), 0.0), res_f - 1)
    return c0.to(torch.int64), pos - c0


def encode(spec: FieldSpec, table, x01, gather: str):
    """table (L, T, W) f32; x01 (N, 3) in [0, 1] -> (N, L*F) features."""
    L, T, F = spec.n_levels, spec.table_rows, spec.n_features
    N = x01.shape[0]
    c0, frac = _cells(spec, x01)
    res = torch.tensor(spec.resolutions, dtype=torch.int64,
                       device=x01.device)[:, None]
    lev = torch.arange(L, device=x01.device)[:, None] * T
    flat = table.reshape(L * T, -1)
    w = _corner_weights(frac)                                 # (L, N, 8)
    if spec.encoder == "packed":
        # one row per cell holds its 8 corners: dense levels index the
        # cell row-major, finer ones hash it
        dense = (res ** 3 <= T)
        key = torch.where(dense, (c0[..., 0] * res + c0[..., 1]) * res
                          + c0[..., 2], _hash(c0, T)).clamp(0, T - 1)
        rows = round_values(flat[(key + lev).reshape(-1)], gather)
        rows = rows.reshape(L, N, 8, F)
        feat = (w[..., None] * rows).sum(-2)                  # (L, N, F)
    else:
        # one row per vertex: dense levels index (r+1)^3 vertices
        # x-fastest, finer ones hash the vertex
        bits = torch.tensor(_BITS, dtype=torch.int64, device=x01.device)
        c = c0[:, None] + bits[None, :, None]                 # (L, 8, N, 3)
        r1 = (res + 1)[:, :, None]
        dense = ((res + 1) ** 3 <= T)[:, :, None]
        idx = torch.where(dense, c[..., 0] + c[..., 1] * r1
                          + c[..., 2] * r1 * r1, _hash(c, T)).clamp(0, T - 1)
        rows = round_values(flat[(idx + lev[:, :, None]).reshape(-1)],
                            gather).reshape(L, 8, N, F)
        feat = (w.permute(0, 2, 1)[..., None] * rows).sum(1)  # (L, N, F)
    return feat.permute(1, 0, 2).reshape(N, L * F)


def sh4(d):
    """Real spherical harmonics of degree 4 (16 values) of unit d."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x, 1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy)], -1)


def mlp(ws, x, prec: Precision):
    """ReLU MLP, no bias, no activation on the output layer."""
    h = x
    for i, w in enumerate(ws):
        h = round_to(h, prec) @ round_to(w, prec)
        if i < len(ws) - 1:
            h = torch.relu(h)
    return h


def norm3(v):
    p = v * v
    return torch.sqrt(p[..., 0] + p[..., 1] + p[..., 2])


class Field:
    """The field on given parameters {table, sigma_mlp, rgb_mlp}."""

    def __init__(self, spec: FieldSpec, params: Dict, prec: Precision):
        self.spec, self.p, self.prec = spec, params, prec

    def _x01(self, x):
        s = self.spec.scale
        return (x + s) / (2 * s)

    def density(self, x, with_feat: bool = False):
        enc = encode(self.spec, self.p["table"], self._x01(x),
                     self.prec.gather)
        with self.prec.matmul_mode():
            h = mlp(self.p["sigma_mlp"], enc, self.prec)
        sigma = _TruncExp.apply(h[:, 0])
        return (sigma, h) if with_feat else sigma

    def __call__(self, x, d):
        sigma, h = self.density(x, with_feat=True)
        du = d / norm3(d)[:, None]
        with self.prec.matmul_mode():
            logits = mlp(self.p["rgb_mlp"], torch.cat([sh4(du), h], -1),
                         self.prec)
        return sigma, torch.sigmoid(logits)


def mlp_macs(spec: FieldSpec) -> int:
    """Multiply-adds of both MLPs for one sample."""
    macs = 0
    for dims in (spec.sigma_dims, spec.rgb_dims):
        macs += sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return macs


def sigma_macs(spec: FieldSpec) -> int:
    d = spec.sigma_dims
    return sum(a * b for a, b in zip(d[:-1], d[1:]))


def chunked(fn, n: int, chunk: int, *args):
    """fn over row chunks of each arg, outputs concatenated."""
    outs = [fn(*(a[i:i + chunk] for a in args)) for i in range(0, n, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def make_params(spec: FieldSpec, seed: int, device) -> Dict:
    """Initial parameters from the seed, on the device in two calls: the
    table U[-1e-4, 1e-4] (tcnn's init), each MLP weight
    Kaiming-uniform U[-sqrt(6/din), sqrt(6/din)], all float32."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    table = (torch.rand((spec.n_levels, spec.table_rows, spec.row_width),
                        generator=g, device=device) * 2 - 1) \
        * 1e-4
    shapes = ([(a, b) for a, b in zip(spec.sigma_dims[:-1],
                                      spec.sigma_dims[1:])]
              + [(a, b) for a, b in zip(spec.rgb_dims[:-1], spec.rgb_dims[1:])])
    u = torch.rand((sum(a * b for a, b in shapes),), generator=g,
                   device=device)
    ws, off = [], 0
    for a, b in shapes:
        ws.append(((u[off:off + a * b] * 2 - 1)
                   * math.sqrt(6.0 / a)).reshape(a, b).contiguous())
        off += a * b
    n_sig = len(spec.sigma_dims) - 1
    return dict(table=table, sigma_mlp=ws[:n_sig], rgb_mlp=ws[n_sig:])


def leaves(params: Dict, table_key: Optional[str] = "table") -> Dict:
    """{name: tensor}: the table and each MLP layer as sigma_mlp.0 ..."""
    out = {table_key: params["table"]}
    for k in ("sigma_mlp", "rgb_mlp"):
        out.update({f"{k}.{i}": w for i, w in enumerate(params[k])})
    return out
