"""The LeReS loss zoo and its orchestrator (port of
google_nerf_tpu/depth/losses.py):

  * ILNR (`Train/lib/models/ILNR_loss.py:11-105`);
  * MSGIL (`Train/lib/models/MSGIL_loss.py:6-75`);
  * edge-guided ranking (`Train/lib/models/ranking_loss.py:17-214`);
  * PWN-edges normal regression (`Train/lib/models/PWN_edges.py:102-262`);
  * PWN-planes virtual-normal loss (`Train/lib/models/PWN_planes.py:6-261`);
  * the per-image scale/shift fit (`multi_depth_model_auxiv2.py:568-591`);
  * `depth_losses`, the ModelLoss orchestrator with the LOSS_MODE
    substring flags (`multi_depth_model_auxiv2.py:188-356`).

As in JAX, the reference's data-dependent gathers (nonzero, randperm,
masked_select) are fixed-count masked samples: a Gumbel top-k over the
mask, a uniform sample without replacement that repeats itself
cyclically when more are asked than the mask holds (ties, the masked-out
entries, in index order, as XLA's top_k orders them).  Also kept: the
fork's ILNR/MSGIL normalisation is the identity (`ILNR_loss.py:24-41`),
and MSGIL evaluates the same half-resolution scale `scales` times
(`MSGIL_loss.py:71-75`).

Draws.  Every random choice comes from `draws`, a dict of the random
numbers themselves, or, where `draws` lacks one, from `generator` (a
torch.Generator); so a test hands in JAX's.  Per loss (B images of N = H
x W pixels, n pairs):

  ranking:    edge_gumbel (B, N), edge_dist (B, 4, n) integers in
              [2, 30], rand_gumbel (B, 2, N);
  pwn_edges:  edge_gumbel (B, 2, N) (image edges, normal edges),
              edge_dist (B, 2, 4, n), rand_gumbel (B, 2, N);
  pwn_planes: gumbel (B, P, 3, N) for P plane ids, three groups each.

`depth_losses` takes them under "planes", "pwn_edges", "ranking" and
"ranking_auxi" (JAX's keys 0-3).

Layout: depth maps (pred, gt, disp, auxi, planes) are (B, H, W); rgb is
NCHW, (B, 3, H, W) (JAX's is NHWC); masks are bool (B, H, W).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.nn import functional as F

from google_nerf_tpu_torch.depth.normals import surface_normal_from_depth

_TINY = torch.finfo(torch.float32).tiny


# ---------------------------------------------------------------- helpers


def masked_mean(x, mask, dim=None, eps: float = 1e-8):
    m = mask.to(x.dtype)
    if dim is None:
        return (x * m).sum() / (m.sum() + eps)
    return (x * m).sum(dim) / (m.sum(dim) + eps)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) for u uniform in [tiny, 1), on
    the generator's device, then moved to `device`."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (-torch.log(-torch.log(u.clamp_min(_TINY)))).to(device)


def sample_masked_indices(mask: torch.Tensor, n: int, gumbel: torch.Tensor):
    """`n` indices drawn uniformly without replacement from the True
    entries of each row of `mask` (..., N), by the top n of `gumbel`
    (..., N) over the mask; past the mask's count the sample repeats
    cyclically.  Returns (idx (..., n) int64, ok (..., n) bool), ok
    marking draws that landed on the mask."""
    score = torch.where(mask, gumbel, torch.full_like(gumbel, -torch.inf))
    k = min(n, mask.shape[-1])
    idx = torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k]
    if k < n:
        idx = idx[..., torch.arange(n, device=idx.device) % k]
    return idx, torch.gather(mask, -1, idx)


def sobel_edges(gray: torch.Tensor):
    """(B, H, W) -> (edges, thetas), each (B, H, W): a VALID 3x3 Sobel,
    then a zero border (`getEdge`, `ranking_loss.py:125-141`)."""
    kx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=gray.dtype, device=gray.device)
    ky = torch.tensor([[1, 2, 1], [0, 0, 0], [-1, -2, -1]],
                      dtype=gray.dtype, device=gray.device)
    g = F.conv2d(gray[:, None], torch.stack([kx, ky])[:, None])
    gx, gy = g[:, 0], g[:, 1]
    edges = F.pad(torch.sqrt(gx * gx + gy * gy), (1, 1, 1, 1))
    thetas = F.pad(torch.atan2(gy, gx), (1, 1, 1, 1))
    return edges, thetas


def recover_scale_shift_depth(pred, gt, min_threshold: float = -1e-8,
                              max_threshold: float = 1e8):
    """The closed-form per-image 2x2 least-squares (scale, shift) taking
    pred to gt over gt's valid pixels
    (`multi_depth_model_auxiv2.py:568-591`).  pred, gt: (B, H, W)."""
    b = pred.shape[0]
    mask = ((gt > min_threshold) & (gt < max_threshold)).to(pred.dtype)
    m = mask.reshape(b, -1)
    p = pred.reshape(b, -1) * m
    g = gt.reshape(b, -1) * m
    a11 = (p * p).sum(-1)
    a12 = p.sum(-1)
    a22 = m.sum(-1)
    b1 = (p * g).sum(-1)
    b2 = g.sum(-1)
    eps = 1e-6
    det = (a11 + eps) * (a22 + eps) - a12 * a12
    scale = ((a22 + eps) * b1 - a12 * b2) / det
    shift = ((a11 + eps) * b2 - a12 * b1) / det
    return pred * scale[:, None, None] + shift[:, None, None]


# ------------------------------------------------------------------- ILNR


def ilnr_loss(pred, gt, valid_threshold: float = -1e-8,
              max_threshold: float = 1e8, return_per_pixel: bool = False):
    """MAE(gt - pred) + MAE(tanh(.01 gt) - tanh(.01 pred)): per-image
    masked means, averaged over the images with more than 100 valid
    pixels (0 when there is none)."""
    b = pred.shape[0]
    mask = (gt > valid_threshold) & (gt < max_threshold)
    mask_b = mask.reshape(b, -1)
    batch_ok = mask_b.sum(-1) > 100
    diff = (gt - pred).abs().reshape(b, -1)
    tanh_diff = (torch.tanh(0.01 * gt)
                 - torch.tanh(0.01 * pred)).abs().reshape(b, -1)
    per_img = (masked_mean(diff, mask_b, dim=-1)
               + masked_mean(tanh_diff, mask_b, dim=-1))
    per_img = torch.where(batch_ok, per_img, torch.zeros_like(per_img))
    loss = per_img.sum() / batch_ok.sum().clamp_min(1)
    loss = torch.where(batch_ok.any(), loss, torch.zeros_like(loss))
    if return_per_pixel:
        keep = mask & batch_ok[:, None, None]
        both = (diff + tanh_diff).reshape(pred.shape)
        return loss, torch.where(keep, both, torch.zeros_like(both))
    return loss


# ------------------------------------------------------------------ MSGIL


def _one_scale_gradient(pred, gt, mask):
    b = gt.shape[0]
    m = mask.to(pred.dtype)
    d = pred - gt
    mv = m[:, :-2, :] * m[:, 2:, :]
    mh = m[:, :, :-2] * m[:, :, 2:]
    vg = (d[:, :-2, :] - d[:, 2:, :]).abs() * mv
    hg = (d[:, :, :-2] - d[:, :, 2:]).abs() * mh
    valid = mh.reshape(b, -1).mean(-1) + mv.reshape(b, -1).mean(-1)
    grad = hg.reshape(b, -1).mean(-1) + vg.reshape(b, -1).mean(-1)
    return grad / (valid + 1e-8)


def msgil_loss(pred, gt, scales: int = 4, valid_threshold: float = -1e-8):
    """The per-image gradient-matching loss, (B,): `scales` times the
    half-resolution scale (`MSGIL_loss.py:71-75`)."""
    mask = gt > valid_threshold
    return scales * _one_scale_gradient(pred[:, ::2, ::2], gt[:, ::2, ::2],
                                        mask[:, ::2, ::2])


# ---------------------------------------------------------------- ranking


def _edge_guided_pairs(h: int, w: int, edges, thetas, n_pairs: int,
                       edge_gumbel, edge_dist):
    """Edge-anchored A/B pairs (`edgeGuidedSampling`,
    `ranking_loss.py:62-110`): anchors on the strong edges (at least a
    tenth of the image's largest), four points 2-30 px along the
    gradient's direction, chained a-b, b-c, c-d.  edges, thetas,
    edge_gumbel: (B, N); edge_dist: (B, 4, n_pairs).  Returns (A, B, ok),
    each (B, 3 n_pairs)."""
    edge_mask = edges >= edges.amax(-1, keepdim=True) * 0.1
    anchor, ok = sample_masked_indices(edge_mask, n_pairs, edge_gumbel)
    theta = torch.gather(thetas, -1, anchor)[:, None]
    row_a, col_a = (anchor // w)[:, None], (anchor % w)[:, None]
    sign = torch.tensor([-1.0, -1.0, 1.0, 1.0], device=edges.device)
    dist = edge_dist.to(torch.float32) * sign[:, None]
    col = col_a + torch.round(dist * torch.cos(theta).abs()).to(torch.int64)
    row = row_a + torch.round(dist * torch.sin(theta).abs()).to(torch.int64)
    pts = row.clamp(0, h - 1) * w + col.clamp(0, w - 1)   # (B, 4, n)
    a = torch.cat([pts[:, 0], pts[:, 1], pts[:, 2]], -1)
    b = torch.cat([pts[:, 1], pts[:, 2], pts[:, 3]], -1)
    return a, b, ok.repeat(1, 3)


def _random_pairs(mask_flat, n_pairs: int, rand_gumbel):
    """Two independent masked samples, (B, n_pairs) each; rand_gumbel
    (B, 2, N)."""
    a, ok_a = sample_masked_indices(mask_flat, n_pairs, rand_gumbel[:, 0])
    b, ok_b = sample_masked_indices(mask_flat, n_pairs, rand_gumbel[:, 1])
    return a, b, ok_a & ok_b


def _need(generator, what: str):
    if generator is None:
        raise ValueError(f"{what} samples at random: pass draws or a "
                         "torch.Generator")
    return generator


def ranking_draws(b: int, n: int, n_pairs: int,
                  generator: torch.Generator, device) -> Dict:
    g = _need(generator, "ranking_loss")
    return dict(edge_gumbel=gumbel((b, n), g, device),
                edge_dist=torch.randint(2, 31, (b, 4, n_pairs), generator=g,
                                        device=g.device).to(device),
                rand_gumbel=gumbel((b, 2, n), g, device))


def ranking_loss(pred, gt, rgb, mask_value: float = -1e-8,
                 sigma: float = 0.03, alpha: float = 1.0,
                 n_pairs: int = 2048, generator=None, draws=None):
    """The edge-guided and random ordinal ranking loss, (B,).  The red
    channel drives the edges (`getEdge` with c == 3,
    `ranking_loss.py:128-131`)."""
    b, h, w = pred.shape
    if draws is None:
        draws = ranking_draws(b, h * w, n_pairs, generator, pred.device)
    masks = (gt > mask_value).reshape(b, -1)
    edges, thetas = sobel_edges(rgb[:, 0])
    a1, b1, ok1 = _edge_guided_pairs(h, w, edges.reshape(b, -1),
                                     thetas.reshape(b, -1), n_pairs,
                                     draws["edge_gumbel"],
                                     draws["edge_dist"])
    a2, b2, ok2 = _random_pairs(masks, 3 * n_pairs, draws["rand_gumbel"])
    ia, ib = torch.cat([a1, a2], -1), torch.cat([b1, b2], -1)
    ok = torch.cat([ok1, ok2], -1)
    p, g = pred.reshape(b, -1), gt.reshape(b, -1)
    pa, pb = p.gather(1, ia), p.gather(1, ib)
    ga, gb = g.gather(1, ia), g.gather(1, ib)
    consistent = (masks.gather(1, ia) & masks.gather(1, ib)
                  & ok).to(pred.dtype)
    ratio = (ga + 1e-6) / (gb + 1e-6)
    hi, lo = 1.0 + sigma, 1.0 / (1.0 + sigma)
    mask_eq = (ratio < hi) & (ratio > lo)
    labels = torch.where(ratio >= hi, 1.0,
                         torch.where(ratio <= lo, -1.0, 0.0))
    equal = (pa - pb) ** 2 * mask_eq * consistent
    unequal = (torch.log1p(torch.exp(((pb - pa) * labels).clamp(-60.0,
                                                                 60.0)))
               * (~mask_eq) * consistent)
    return alpha * equal.mean(-1) + unequal.mean(-1)


# -------------------------------------------------------------- PWN-edges


def pwn_edges_draws(b: int, n: int, n_pairs: int,
                    generator: torch.Generator, device) -> Dict:
    g = _need(generator, "pwn_edges_loss")
    return dict(edge_gumbel=gumbel((b, 2, n), g, device),
                edge_dist=torch.randint(2, 31, (b, 2, 4, n_pairs),
                                        generator=g,
                                        device=g.device).to(device),
                rand_gumbel=gumbel((b, 2, n), g, device))


def _pair_cos(normals, ia, ib):
    """|cos| between the normals (B, 3, N) at index pairs (B, n)."""
    na = normals.gather(2, ia[:, None].expand(-1, 3, -1))
    nb = normals.gather(2, ib[:, None].expand(-1, 3, -1))
    return (na * nb).sum(1).abs()


def pwn_edges_loss(pred, gt, rgb, focal_length, mask_value: float = -1e-8,
                   cos_theta1: float = 0.3, cos_theta2: float = 0.95,
                   n_pairs: int = 2048, generator=None, draws=None):
    """Normal-consistency regression on edge-anchored and random point
    pairs, (B,).  focal_length: (B,)."""
    b, h, w = pred.shape
    if draws is None:
        draws = pwn_edges_draws(b, h * w, n_pairs, generator, pred.device)
    masks = gt > mask_value
    n_pred = surface_normal_from_depth(pred, focal_length, masks)
    n_gt = surface_normal_from_depth(gt, focal_length, masks)

    edges_img, thetas_img = sobel_edges(rgb[:, 0])
    # the gt normals' edges: the mean of the three channels' magnitudes
    edges_normal = sum(sobel_edges(n_gt[:, c])[0] for c in range(3)) / 3.0
    border = torch.ones((b, h, w), dtype=torch.bool, device=pred.device)
    border[:, 5:-5, 5:-5] = False
    edges_normal = torch.where(border, 0.0, edges_normal)
    # the dilated depth edges are left out (`PWN_edges.py:197-203`); the
    # threshold is a tenth of the batch's largest depth edge
    edges_depth = sobel_edges(gt)[0]
    edm = edges_depth >= edges_depth.max() * 0.1
    excl = F.max_pool2d(edm[:, None].to(pred.dtype), 3, 1, 1)[:, 0] > 0
    edges_normal = torch.where(excl, 0.0, edges_normal)
    edges_img = torch.where(excl, 0.0, edges_img)

    eg, ed = draws["edge_gumbel"], draws["edge_dist"]
    a1, b1, ok1 = _edge_guided_pairs(h, w, edges_img.reshape(b, -1),
                                     thetas_img.reshape(b, -1), n_pairs,
                                     eg[:, 0], ed[:, 0])
    a2, b2, ok2 = _edge_guided_pairs(h, w, edges_normal.reshape(b, -1),
                                     thetas_img.reshape(b, -1), n_pairs,
                                     eg[:, 1], ed[:, 1])
    ia, ib = torch.cat([a1, a2], -1), torch.cat([b1, b2], -1)
    ok = torch.cat([ok1, ok2], -1)
    m = masks.reshape(b, -1)
    consistent = m.gather(1, ia) & m.gather(1, ib) & ok
    nif, tif = n_pred.reshape(b, 3, -1), n_gt.reshape(b, 3, -1)
    t_cos, i_cos = _pair_cos(tif, ia, ib), _pair_cos(nif, ia, ib)
    m75 = (t_cos < cos_theta1) & consistent
    m10 = (t_cos > cos_theta2) & consistent
    l75 = ((t_cos - i_cos).abs() * m75).sum(-1) / (m75.sum(-1) + 1e-8)
    l10 = ((t_cos - i_cos).abs() * m10).sum(-1) / (m10.sum(-1) + 1e-8)
    # the random-pair regression term (`PWN_edges.py:246-252`)
    ra, rb, rok = _random_pairs(m, n_pairs, draws["rand_gumbel"])
    rt, ri = _pair_cos(tif, ra, rb), _pair_cos(nif, ra, rb)
    lr = ((rt - ri).abs() * rok).sum(-1) / (rok.sum(-1) + 1e-8)
    return l75 + l10 + lr


# ------------------------------------------------------------- PWN-planes


def pwn_planes_draws(b: int, n: int, max_planes: int,
                     generator: torch.Generator, device) -> Dict:
    return dict(gumbel=gumbel((b, max_planes, 3, n),
                              _need(generator, "pwn_planes_loss"), device))


def _norm(x, dim=-1, keepdim=False):
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)


def pwn_planes_loss(gt_depth, pred_depth_ss, planes, focal_length,
                    sample_groups: int = 512, max_planes: int = 8,
                    delta_cos: float = 0.867, delta_diff: float = 0.007,
                    xyz_mode: str = "xyz", generator=None, draws=None):
    """Points of one annotated plane should share a normal.  planes:
    (B, H, W) integer plane ids (0: none); focal_length (B,).  Returns a
    scalar: the batch's sum over the groups kept, over their count
    (`PWN_planes.py:233-259`)."""
    b, h, w = gt_depth.shape
    dt, dev = pred_depth_ss.dtype, pred_depth_ss.device
    if draws is None:
        draws = pwn_planes_draws(b, h * w, max_planes, generator, dev)
    u = torch.arange(w, dtype=dt, device=dev) - w // 2
    v = torch.arange(h, dtype=dt, device=dev) - h // 2
    if xyz_mode == "uvd":
        max_uv = u.max()
        x = (u[None, :] / max_uv).expand(b, h, w)
        y = (v[:, None] / max_uv).expand(b, h, w)
    else:
        f = focal_length.to(dt)[:, None, None]
        x = u[None, None, :] * pred_depth_ss.abs() / f
        y = v[None, :, None] * pred_depth_ss.abs() / f
    pwf = torch.stack([x, y, pred_depth_ss], -1).reshape(b, 1, h * w, 3)

    ids = torch.arange(1, max_planes + 1, device=dev)
    mask = planes.reshape(b, 1, -1) == ids[None, :, None]      # (B, P, N)
    n_valid = mask.sum(-1)
    idx = sample_masked_indices(mask[:, :, None].expand(-1, -1, 3, -1),
                                sample_groups, draws["gumbel"])[0]
    pts = pwf.expand(-1, max_planes, -1, -1)
    p1, p2, p3 = (pts.gather(2, idx[:, :, k, :, None].expand(-1, -1, -1, 3))
                  for k in range(3))                           # (B, P, G, 3)
    # drop near-degenerate groups (`filter_mask`, `PWN_planes.py:146-172`):
    # colinear in xy, or points too close
    d12, d13, d23 = (p2 - p1)[..., :2], (p3 - p1)[..., :2], (p3 - p2)[..., :2]
    dots = torch.stack([(a * c).sum(-1) / (_norm(a) * _norm(c) + 1e-8)
                        for a, c in ((d12, d13), (d12, d23), (d13, d23))],
                       -1)
    cos_bad = (dots.abs() > delta_cos).sum(-1) > 0
    near_x = torch.stack([d[..., 0].abs() < delta_diff
                          for d in (d12, d13, d23)], -1).any(-1)
    near_y = torch.stack([d[..., 1].abs() < delta_diff
                          for d in (d12, d13, d23)], -1).any(-1)
    ok = (~(cos_bad | (near_x & near_y))
          & (n_valid > 3 * sample_groups * 0.6 / 5)[..., None])
    vn = torch.linalg.cross(p2 - p1, p3 - p1, dim=-1)
    vn = vn / (_norm(vn, keepdim=True) + 1e-8)
    flip = (vn * p1).sum(-1) > 0
    vn = torch.where(flip[..., None], -vn, vn)
    okf = ok.to(dt)[..., None]
    aver = (vn * okf).sum(2, keepdim=True)                     # (B, P, 1, 3)
    aver = aver / (_norm(aver, keepdim=True) + 1e-5)
    cos_diff = (1.0 - (vn * aver).sum(-1)) * ok
    return cos_diff.sum() / (ok.sum() + 1e-8)


# ------------------------------------------------------------ orchestrator


def loss_draws(b: int, h: int, w: int, loss_mode: str,
               generator: torch.Generator, device, n_pairs: int = 2048,
               max_planes: int = 8) -> Dict:
    """The draws depth_losses takes in `loss_mode` (the sampled losses
    its flags turn on, auxi included), drawn from generator."""
    mode, n, out = loss_mode.lower(), h * w, {}
    if "_pairwise-normal-regress-plane_" in mode:
        out["planes"] = pwn_planes_draws(b, n, max_planes, generator,
                                         device)
    if "_pairwise-normal-regress-edge_" in mode:
        out["pwn_edges"] = pwn_edges_draws(b, n, n_pairs, generator, device)
    if "_ranking-edge_" in mode:
        out["ranking"] = ranking_draws(b, n, n_pairs, generator, device)
    if "_ranking-edge-auxi_" in mode:
        out["ranking_auxi"] = ranking_draws(b, n, n_pairs, generator,
                                            device)
    return out


@dataclasses.dataclass(frozen=True)
class LossConfig:
    loss_mode: str = "_ranking-edge_ilnr_msgil-normal_meanstd-tanh_"
    loss_auxi_weight: float = 0.5
    focal_x: float = 256.0
    focal_y: float = 256.0
    ilnr_min: float = -1e-8
    ilnr_max: float = 1e8
    pwn_max: float = 10.1


def depth_losses(pred, data, cfg: LossConfig, auxi=None,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The full criterion (`ModelLoss`).  pred: (B, H, W); data: depth
    (B, H, W), rgb (B, 3, H, W), optional planes (B, H, W) integers,
    focal_length (B,), quality_flg (B,), disp (B, H, W); auxi: the
    auxiliary disparity (B, H, W) or None.

    Modes, substrings of cfg.loss_mode: _pairwise-normal-regress-plane_,
    _pairwise-normal-regress-edge_ (quality 3 only), _meanstd-tanh_
    (ILNR on quality >= 2), _ranking-edge_, _msgil-normal_; with auxi and
    disp, _ranking-edge-auxi_, _msgil-normal-auxi_, _meanstd-tanh-auxi_.
    draws: per-loss draws (module docstring) under "planes",
    "pwn_edges", "ranking", "ranking_auxi"; a sampled loss missing from
    it draws from generator.

    Returns the named losses, 'ilnr_per_pixel' with the ILNR mode,
    'total_loss' (a scalar) and 'total_raw' ((B,): each image's raw
    total, what the cIMLE argmin-z picks by,
    `multi_depth_model_auxiv2.py:217-221`)."""
    draws = draws or {}
    mode = cfg.loss_mode.lower()
    gt = data["depth"]
    b = gt.shape[0]
    dev, dt = pred.device, pred.dtype
    q = data.get("quality_flg")
    if q is None:
        q = torch.full((b,), 3, dtype=torch.int32, device=dev)
    focal = data.get("focal_length")
    if focal is None:
        focal = torch.full((b,), cfg.focal_x, device=dev)

    loss: Dict[str, torch.Tensor] = {}
    total_raw = torch.zeros((b,), dtype=dt, device=dev)
    needs_ss = ("_pairwise-normal-regress-edge_" in mode
                or "_pairwise-normal-regress-plane_" in mode)
    pred_ss = (recover_scale_shift_depth(pred, gt, -1e-8, cfg.pwn_max)
               if needs_ss else None)

    if "_pairwise-normal-regress-plane_" in mode:
        planes = data.get("planes")
        if planes is None:
            planes = torch.zeros(gt.shape, dtype=torch.int32, device=dev)
        cur = pwn_planes_loss(gt, pred_ss, planes, focal,
                              generator=generator, draws=draws.get("planes"))
        loss["pairwise-normal-regress-plane_loss"] = cur
        total_raw = total_raw + cur

    if "_pairwise-normal-regress-edge_" in mode:
        hi = (q == 3).to(dt)
        cur = pwn_edges_loss(pred_ss, gt, data["rgb"], focal,
                             generator=generator,
                             draws=draws.get("pwn_edges")) * hi
        loss["pairwise-normal-regress-edge_loss"] = cur.sum()
        total_raw = total_raw + cur

    if "_meanstd-tanh_" in mode:
        gt_mid = torch.where((q >= 2)[:, None, None], gt, 0.0)
        cur, per_pixel = ilnr_loss(pred, gt_mid, cfg.ilnr_min, cfg.ilnr_max,
                                   return_per_pixel=True)
        loss["meanstd-tanh_loss"] = cur
        loss["ilnr_per_pixel"] = per_pixel
        total_raw = total_raw + cur

    if "_ranking-edge_" in mode:
        cur = ranking_loss(pred, gt, data["rgb"], generator=generator,
                           draws=draws.get("ranking"))
        loss["ranking-edge_loss"] = cur.sum()
        total_raw = total_raw + cur

    if "_msgil-normal_" in mode:
        cur = msgil_loss(pred, gt) * 0.1
        loss["msg_normal_loss"] = cur.sum()
        total_raw = total_raw + cur

    total = torch.zeros((), dtype=dt, device=dev)
    for k in sorted(loss):
        if k != "ilnr_per_pixel":
            total = total + loss[k].sum()

    # the auxi branch on disparity (`auxi_loss`,
    # multi_depth_model_auxiv2.py:240)
    if auxi is not None and "disp" in data:
        disp = data["disp"]
        auxi_total = torch.zeros((), dtype=dt, device=dev)
        if "_ranking-edge-auxi_" in mode:
            cur = ranking_loss(auxi, disp, data["rgb"], generator=generator,
                               draws=draws.get("ranking_auxi")).sum()
            loss["ranking-edge_auxiloss"] = cur
            auxi_total = auxi_total + cur
        if "_msgil-normal-auxi_" in mode:
            cur = msgil_loss(auxi, disp).sum() * 0.5
            loss["msg_normal_auxiloss"] = cur
            auxi_total = auxi_total + cur
        if "_meanstd-tanh-auxi_" in mode:
            cur = ilnr_loss(auxi, disp)
            loss["meanstd-tanh_auxiloss"] = cur
            auxi_total = auxi_total + cur
        total = total + auxi_total * cfg.loss_auxi_weight

    loss["total_loss"] = total
    loss["total_raw"] = total_raw
    return loss
