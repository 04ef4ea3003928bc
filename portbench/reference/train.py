"""Plain reference of the NGP training step on a constant-step,
single-cascade scene: the density grid (visibility, the warm-up update
over every cell and the sampled update after it), the march on the constant-step lattice, the
ray-major sample budget, the field, front-to-back compositing, the
random-background re-composite and backfill, the loss (masked RGB MSE
and opacity entropy) with its gradients by autograd, and Adam.

It follows the program's draws: the caller hands it a torch.Generator
in the state the program's generator had, and it draws the same
tensors in the same order (grid jitter on update steps, image and pixel
indices, backgrounds, march noise).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.field import Field, FieldSpec, Precision, chunked

SQRT3 = 3.0 ** 0.5
NEAR = 0.05


class Recipe:
    """The training recipe's numbers (a traffic file's "recipe" block)."""

    def __init__(self, r: Dict):
        self.batch = r["batch_size"]
        self.budget = r["samples_budget"]
        self.k = r["k_samples"]
        self.max_samples = r["max_samples"]
        self.group = r["march_group"]
        self.keep_groups = r["march_keep_groups"]
        self.T_threshold = r["T_threshold"]
        self.lambda_opacity = r["lambda_opacity"]
        self.lr = r["lr"]
        self.epochs = r["num_epochs"]
        self.steps_per_epoch = r["steps_per_epoch"]
        self.grid_interval = r["grid_update_interval"]
        self.warmup = r["warmup_steps"]
        self.sample_div = r["grid_sample_div"]
        self.random_bg = r["random_bg"]
        self.backfill = r["exclude_incomplete"] == "backfill"
        self.decay = 0.95

    @property
    def density_threshold(self):
        return 0.01 * self.max_samples / SQRT3

    def lr_at(self, step: int) -> float:
        eta_min = self.lr / 30
        epoch = min(step // self.steps_per_epoch, self.epochs)
        return eta_min + 0.5 * (self.lr - eta_min) * (
            1 + math.cos(math.pi * epoch / self.epochs))


def batch_rays(scene, img, pix):
    """World rays of (image, pixel) pairs: origins and directions."""
    c2w = scene["poses"][img]
    p = scene["directions"][pix][:, None, :] * c2w[:, :, :3]
    return c2w[:, :, 3], p[..., 0] + p[..., 1] + p[..., 2]


def aabb_hits(o, d, half: float):
    inv = 1.0 / torch.where(d.abs() > 1e-10, d,
                            torch.where(d >= 0, 1e-10, -1e-10))
    lo = (-half - o) * inv
    hi = (half - o) * inv
    t1 = torch.clamp_min(torch.minimum(lo, hi).amax(-1), 0.0)
    t2 = torch.maximum(lo, hi).amin(-1)
    hit = t2 > t1
    t1 = torch.where(hit, t1, -1.0)
    t2 = torch.where(hit, t2, -1.0)
    return torch.where((t1 >= 0) & (t1 < NEAR), NEAR, t1), t2


def cell_of(xyz, scale: float, G: int):
    """Integer cell coords (..., 3) of world points in one cascade."""
    b = min(0.5, scale)
    return (torch.clamp((0.5 / b) * xyz + 0.5, 0.0, 1.0 - 0.5 / G)
            * G).to(torch.int64)


def cell_centres(G: int, scale: float, device):
    """(G^3, 3) world centres of the raster cells, the grid's mapping."""
    g = torch.arange(G, dtype=torch.float32, device=device)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    c = torch.stack([x, y, z], -1).reshape(-1, 3)
    s = min(0.5, scale)
    return (c / torch.full((), G - 1.0, device=device) * 2 - 1) * (s - s / G)


@torch.no_grad()
def visible_cells(K, poses, w: int, h: int, G: int, scale: float, device):
    """(G^3,) float: 0 where some camera sees the cell centre in front
    of its near plane and none sees it nearer, else -1."""
    K = torch.as_tensor(K, dtype=torch.float32, device=device)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
    R = poses[:, :3, :3].transpose(1, 2)
    T = -(R * poses[:, None, :3, 3]).sum(-1)
    out = []
    for chunk in cell_centres(G, scale, device).reshape(32, -1, 3):
        xc = (R[:, None] * chunk[None, :, None, :]).sum(-1) + T[:, None, :]
        uvd = (K * xc[..., None, :]).sum(-1)
        z = uvd[..., 2]
        uv = uvd[..., :2] / torch.where(z.abs() > 1e-9, z, 1e-9)[..., None]
        inside = ((z >= 0) & (uv[..., 0] >= 0) & (uv[..., 0] < w)
                  & (uv[..., 1] >= 0) & (uv[..., 1] < h))
        cov = ((z >= NEAR) & inside).any(0)
        near = ((z < NEAR) & inside).any(0)
        out.append(torch.where(cov & ~near, 0.0, -1.0))
    return torch.cat(out)


@torch.no_grad()
def update_grid(grid, field: Field, r: Recipe, G: int, scale: float,
                warmup: bool, gen):
    """One grid update.  Warm-up: every cell, jittered in its cell.
    After it: G^3 / sample_div cells drawn uniformly, and as many drawn
    uniformly from the cells of positive density (the one where a draw
    rounds up to their count: the last cell), each jittered in its
    cell.  Then each cell's decayed value or its largest new density,
    whichever is larger (cells at -1 stay), and occupancy above
    min(mean of the positive cells, the density threshold).  The draws
    are taken from gen in the program's order.  Returns (grid, occ)."""
    dev = grid.device
    n = G ** 3
    if warmup:
        idx = torch.arange(n, device=dev)
        jitter = torch.rand((n, 3), generator=gen, device=dev)
    else:
        m = n // r.sample_div
        cu = torch.randint(0, G, (m, 3), dtype=torch.int32, generator=gen,
                           device=dev).long()
        u = torch.rand(m, generator=gen, device=dev)
        spare = torch.randint(0, n, (m,), dtype=torch.int32, generator=gen,
                              device=dev).long()
        jitter = torch.rand((2 * m, 3), generator=gen, device=dev)
        live = (grid > 0).nonzero()[:, 0]
        cnt = live.numel()
        if cnt:
            k = (u * float(cnt)).long()
            pos = torch.where(k < cnt, live[k.clamp_max(cnt - 1)], n - 1)
        else:
            pos = spare
        idx = torch.cat([(cu[:, 0] * G + cu[:, 1]) * G + cu[:, 2], pos])
    s = min(0.5, scale)
    pts = cell_centres(G, scale, dev)[idx] + (jitter * 2 - 1) * (s / G)
    sig = chunked(field.density, pts.shape[0], pts.shape[0] // 32, pts)
    best = torch.zeros(n, device=dev).scatter_reduce(
        0, idx, sig.float(), "amax")
    new = torch.where(grid < 0, grid, torch.maximum(grid * r.decay, best))
    pos = new > 0
    mean = torch.where(pos, new, 0.0).sum() / torch.clamp_min(pos.sum(), 1)
    return new, new > torch.clamp_max(mean, r.density_threshold)


@torch.no_grad()
def march(o, du, t1, t2, occ, noise, r: Recipe, scale: float, G: int):
    """Samples on the lattice t0 + i*dt, t0 = t1 + dt*noise: those in
    occupied cells before t2, in groups of r.group candidates; a ray
    keeps its first r.keep_groups groups that hold one, then its first
    r.k samples.  Returns ts (R, n) with valid (R, n) in ascending t and
    truncated (R,) (more live groups or samples than kept)."""
    R = o.shape[0]
    dev = o.device
    dt = SQRT3 / r.max_samples
    g = r.group
    gs = g * 8
    hit = t1 >= 0
    t0 = torch.clamp_min(t1, 0.0) + dt * noise
    s = torch.arange(r.max_samples // gs, dtype=torch.float32, device=dev)
    j = torch.arange(gs, dtype=torch.float32, device=dev)
    ts = (t0[:, None, None] + s[None, :, None] * (gs * dt)
          + j * dt).reshape(R, r.max_samples)
    c = cell_of(o[:, None] + ts[..., None] * du[:, None], scale, G)
    ok = occ[0][c[..., 0], c[..., 1], c[..., 2]] & (ts < t2[:, None]) \
        & hit[:, None]
    grp = ok.reshape(R, -1, g)
    live = grp.any(-1)
    rank = torch.cumsum(live.long(), -1) - 1
    keep_g = live & (rank < r.keep_groups)
    truncated = live.sum(-1) > r.keep_groups
    # the kept groups' candidates, first-live-group first
    order = torch.sort(torch.where(keep_g, rank, r.keep_groups), dim=-1,
                       stable=True).indices[:, :r.keep_groups]
    gvalid = torch.gather(keep_g, 1, order)
    sel = torch.gather(grp, 1, order[..., None].expand(-1, -1, g)) \
        & gvalid[..., None]
    ts_sel = torch.gather(ts.reshape(R, -1, g), 1,
                          order[..., None].expand(-1, -1, g))
    valid = sel.reshape(R, -1)
    tsv = ts_sel.reshape(R, -1)
    if r.k < valid.shape[1]:
        vr = torch.cumsum(valid.long(), -1) - 1
        truncated = truncated | (valid.sum(-1) > r.k)
        valid = valid & (vr < r.k)
    return torch.where(valid, tsv, 0.0), valid, truncated


def composite(sig, rgb, ts, keep, dt: float, T_threshold: float):
    """Front-to-back sums per ray over the kept samples of an (R, n)
    grid: opacity (clamped to [0, 1]), rgb, depth."""
    sd = torch.clamp_max(torch.where(keep, sig * dt, 0.0), 80.0)
    T = torch.exp(-(torch.cumsum(sd, -1) - sd))
    inc = keep & (T > T_threshold)
    w = torch.where(inc, T * (1.0 - torch.exp(-sd)), 0.0)
    return (torch.clamp(w.sum(-1), 0.0, 1.0), (w[..., None] * rgb).sum(1),
            (w * ts).sum(-1))


class TrainReference:
    """The reference's training state: parameters, Adam moments, the
    density grid and occupancy, the step count."""

    def __init__(self, spec: FieldSpec, recipe: Recipe, scene, params0,
                 prec: Precision, G: int):
        self.spec, self.r, self.scene, self.prec, self.G = (
            spec, recipe, scene, prec, G)
        dev = scene["images"].device
        self.params = dict(
            table=params0["table"].detach().clone().requires_grad_(True),
            sigma_mlp=[w.detach().clone().requires_grad_(True)
                       for w in params0["sigma_mlp"]],
            rgb_mlp=[w.detach().clone().requires_grad_(True)
                     for w in params0["rgb_mlp"]])
        self.m = {id(p): torch.zeros_like(p) for p in self.leaves()}
        self.v = {id(p): torch.zeros_like(p) for p in self.leaves()}
        w, h = scene["img_wh"]
        self.grid = visible_cells(scene["K"], scene["poses"], w, h, G,
                                  spec.scale, dev)
        self.occ = torch.zeros((1, G, G, G), dtype=torch.bool, device=dev)
        self.step = 0

    def leaves(self):
        return [self.params["table"], *self.params["sigma_mlp"],
                *self.params["rgb_mlp"]]

    def field(self):
        return Field(self.spec, self.params, self.prec)

    def loss(self, gen):
        """The step's loss from the next draws of gen; also returns
        (rays kept, samples kept)."""
        r, sc = self.r, self.scene
        if self.step % r.grid_interval == 0:
            grid, occ = update_grid(self.grid, self.field(), r, self.G,
                                    self.spec.scale,
                                    self.step < r.warmup, gen)
            self.grid, self.occ = grid, occ.reshape(1, *(self.G,) * 3)
        dev = sc["images"].device
        n_img, n_pix = sc["images"].shape[:2]
        img = torch.randint(0, n_img, (r.batch,), generator=gen, device=dev)
        pix = torch.randint(0, n_pix, (r.batch,), generator=gen, device=dev)
        gt, alpha = sc["images"][img, pix], sc["alphas"][img, pix]
        o, d = batch_rays(sc, img, pix)
        bg = (torch.rand((r.batch, 3), generator=gen, device=dev)
              if r.random_bg else torch.ones((r.batch, 3), device=dev))
        noise = torch.rand((r.batch,), generator=gen, device=dev)
        target = gt - (1.0 - alpha)[:, None] * (1.0 - bg)
        du = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        t1, t2 = aabb_hits(o, du, self.spec.scale)
        ts, valid, truncated = march(o, du, t1, t2, self.occ, noise, r,
                                     self.spec.scale, self.G)
        # the budget: the first samples in ray-major order; a ray that
        # lost one of its samples is left out of the loss
        rank = torch.cumsum(valid.reshape(-1).long(), 0).reshape(
            valid.shape) - 1
        keep = valid & (rank < r.budget)
        ray_mask = ~(valid & ~keep).any(-1)
        xyz = o[:, None] + ts[..., None] * du[:, None]
        sig_k, rgb_k = self.field()(xyz[keep], du[:, None].expand_as(xyz)[keep])
        R, n = valid.shape
        sig = torch.zeros((R, n), device=dev).masked_scatter(keep, sig_k)
        rgb = torch.zeros((R, n, 3), device=dev).masked_scatter(
            keep[..., None].expand(R, n, 3), rgb_k)
        dt = SQRT3 / r.max_samples
        opacity, rgb_ray, _ = composite(sig, rgb, ts, keep, dt,
                                        r.T_threshold)
        if r.backfill:
            fill = truncated & (opacity < 1.0 - r.T_threshold) \
                & (self.step >= r.warmup)
            bg = torch.where(fill[:, None], target, bg)
        out = rgb_ray + bg * (1.0 - opacity[:, None])
        den = torch.clamp_min(ray_mask.sum(), 1)
        l_rgb = torch.where(ray_mask[:, None], (out - target) ** 2,
                            0.0).sum() / (den * 3)
        op = torch.clamp(opacity, 0.0, 1.0) + 1e-10
        l_op = torch.where(ray_mask, r.lambda_opacity * (-op * torch.log(op)),
                           0.0).sum() / den
        return l_rgb + l_op, int(ray_mask.sum()), int(keep.sum())

    def train_step(self, gen):
        """One step: the loss, its gradients and Adam (betas 0.9, 0.999,
        eps 1e-15) at the cosine learning rate.  Returns (loss, grads
        {leaf name: tensor})."""
        loss, _, _ = self.loss(gen)
        leaves = self.leaves()
        grads = torch.autograd.grad(loss, leaves)
        lr = self.r.lr_at(self.step)
        t = self.step + 1
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                m, v = self.m[id(p)], self.v[id(p)]
                m.mul_(0.9).add_(g, alpha=0.1)
                v.mul_(0.999).addcmul_(g, g, value=0.001)
                mh = m / (1 - 0.9 ** t)
                vh = v / (1 - 0.999 ** t)
                p.sub_(lr * mh / (vh.sqrt() + 1e-15))
        self.step += 1
        names = leaf_names(self.spec)
        return loss.detach(), dict(zip(names, grads))


def leaf_names(spec: FieldSpec):
    return (["table"] + [f"sigma_mlp.{i}" for i in range(len(spec.sigma_dims)
                                                          - 1)]
            + [f"rgb_mlp.{i}" for i in range(len(spec.rgb_dims) - 1)])
