"""Plain reference of a served view of a bounded scene: every ray
marched once over the constant-step lattice from its box entry, the
field on the samples in occupied cells, front-to-back compositing that
stops including samples once the transmittance before them falls to
the threshold, then the white background under what is left."""
from __future__ import annotations

import torch

from portbench.reference.field import Field, norm3
from portbench.reference.train import SQRT3, aabb_hits, cell_of


@torch.no_grad()
def render_view(field: Field, occ, o, d, *, max_samples: int,
                T_threshold: float, group: int, ray_chunk: int = 1 << 15,
                eval_chunk: int = 1 << 20):
    """o, d (R, 3) -> dict rgb (R, 3), opacity, depth (R,) and the
    sample count the view needs (samples included in the composite)
    and rays whose transmittance reached the threshold."""
    spec = field.spec
    G = occ.shape[-1]
    R = o.shape[0]
    dev = o.device
    n = norm3(d)[:, None]
    du = d / torch.where(n > 0, n, 1.0)
    t1, t2 = aabb_hits(o, du, spec.scale)
    t2 = torch.where(t2 > 0, t2, 0.0)
    dt = SQRT3 / max_samples
    gs = group * 8
    s = torch.arange(max_samples // gs, dtype=torch.float32, device=dev)
    j = torch.arange(gs, dtype=torch.float32, device=dev)
    rgb = torch.zeros((R, 3), device=dev)
    opacity = torch.zeros((R,), device=dev)
    depth = torch.zeros((R,), device=dev)
    needed, ended = 0, 0
    for a in range(0, R, ray_chunk):
        b = min(R, a + ray_chunk)
        oc, dc = o[a:b], du[a:b]
        t0 = torch.clamp_min(t1[a:b], 0.0)
        ts = (t0[:, None, None] + s[None, :, None] * (gs * dt)
              + j * dt).reshape(b - a, max_samples)
        xyz = oc[:, None] + ts[..., None] * dc[:, None]
        c = cell_of(xyz, spec.scale, G)
        ok = (occ.reshape(G, G, G)[c[..., 0], c[..., 1], c[..., 2]]
              & (ts < t2[a:b, None]) & (t1[a:b, None] >= 0))
        if not bool(ok.any()):
            continue
        idx = ok.nonzero(as_tuple=True)
        px, dx = xyz[idx], dc[idx[0]]
        sig_parts, col_parts = [], []
        for k in range(0, px.shape[0], eval_chunk):
            sg, cl = field(px[k:k + eval_chunk], dx[k:k + eval_chunk])
            sig_parts.append(sg)
            col_parts.append(cl)
        sd = torch.zeros_like(ts)
        sd[idx] = torch.clamp_max(torch.cat(sig_parts) * dt, 80.0)
        col = torch.zeros(ts.shape + (3,), device=dev)
        col[idx] = torch.cat(col_parts)
        T = torch.exp(-(torch.cumsum(sd, -1) - sd))
        inc = ok & (T > T_threshold)
        w = torch.where(inc, T * (1.0 - torch.exp(-sd)), 0.0)
        opacity[a:b] = torch.clamp(w.sum(-1), 0.0, 1.0)
        rgb[a:b] = (w[..., None] * col).sum(1)
        depth[a:b] = (w * ts).sum(-1)
        needed += int(inc.sum())
        ended += int((ok & ~inc).any(-1).sum())
    rgb = rgb + (1.0 - opacity[:, None])
    return dict(rgb=rgb, opacity=opacity, depth=depth, needed=needed,
                ended=ended)
