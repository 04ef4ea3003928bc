"""Seeded inputs of the brick-field tile kernels K1-K5 at serving widths:
bricks along +z and tiles of rays marching through them (Bk=8 bf16
slabs, S=9 windows of the 256-sample lattice, 32-slot lists).

chip_smoke.py phase 2 holds the kernels against their plain versions and
the numpy goldens on these inputs; the tests take them at toy size.
"""
from __future__ import annotations

import torch

from google_nerf_tpu_torch.ops.cuda import brick_field as bf


def serving_width_inputs(n_tiles, seed, dev):
    """-> (args, rgba, nslots, Lp, keywords): args the positional tensors
    of K3 (pool_blk, meta, rays, sh, bf16 row pool, w1, w2, w3) on `dev`,
    rgba the matching (nb, 32, Bk^3) bf16 pre-shaded slabs of K5, nslots
    each tile's list length, Lp the list rows per tile, keywords S, dt,
    tau_max and Bk."""
    g = torch.Generator().manual_seed(seed)
    Bk, V, nb, Lp = 8, 256, 32, 32
    S = bf.window_span(256, Bk, V, 0.5)
    blk = torch.stack([torch.full((nb,), 15), torch.full((nb,), 15),
                       torch.arange(nb)], -1).float()
    lo = (blk * Bk / V * 2 - 1) * 0.5
    hi = ((blk + 1) * Bk / V * 2 - 1) * 0.5
    pool = torch.randn(nb, Bk ** 3, 128, generator=g) * 0.3
    pool[..., 0::16] = torch.randn(nb, Bk ** 3, 8, generator=g) + 2.0
    # each tile lists the column's bricks front to back; nslots cuts it
    order = torch.arange(nb).expand(n_tiles, Lp)
    meta = torch.cat([lo[order], hi[order], torch.zeros(n_tiles, Lp, 2)],
                     -1).reshape(-1, 8)
    o = torch.stack([torch.rand(n_tiles * 64, generator=g) * 0.06 - 0.03,
                     torch.rand(n_tiles * 64, generator=g) * 0.06 - 0.03,
                     torch.full((n_tiles * 64,), -1.0)], -1)
    d = torch.stack([torch.rand(n_tiles * 64, generator=g) * 0.02 - 0.01,
                     torch.rand(n_tiles * 64, generator=g) * 0.02 - 0.01,
                     torch.ones(n_tiles * 64)], -1)
    d = d / d.norm(dim=-1, keepdim=True)
    rays = torch.cat([o, d, torch.full((n_tiles * 64, 1), 0.5),
                      torch.full((n_tiles * 64, 1), 1.5)], -1)
    sh = torch.randn(n_tiles * 64, 16, generator=g) * 0.3
    ws = [(torch.rand(a, b, generator=g) * 2 - 1) * (6 / a) ** 0.5
          for a, b in ((32, 64), (64, 64), (64, 3))]
    nslots = torch.randint(1, Lp + 1, (n_tiles,), generator=g,
                           dtype=torch.int32)
    # pre-shaded slabs: the pool's sigma lanes and seeded rgb in [0, 1]
    rgb = torch.rand(nb, 8, 3, Bk ** 3, generator=g)
    rgba = torch.cat([pool[..., 0::16].transpose(1, 2)[:, :, None], rgb],
                     2).reshape(nb, 32, Bk ** 3)
    args = [order.reshape(-1).int(), meta, rays, sh,
            pool.to(torch.bfloat16)] + ws
    args = [a.to(dev).contiguous() for a in args]
    kw = dict(S=S, dt=3 ** 0.5 / 256, tau_max=float(-torch.log(
        torch.tensor(1e-2))), Bk=Bk)
    return args, rgba.to(dev, torch.bfloat16), nslots.to(dev), Lp, kw
