"""The batched schedule of the dense kernels K3 and K4
(csrc/brick_field_dense.cu), modelled in plain PyTorch and held bit for bit
against the slot-serial plain version `_tiles_plain`.

The kernels take a tile's list G slots at a time: each (ray, slot) pair's
window and its sum of sigma*dt first (from the trilerped features alone),
then the live gate tau < tau_max slot by slot in list order, and only then
the MLP, for the samples of live pairs only, composited per pair in window
order and added to the state in list order.  That is the same sums in the
same order as one slot at a time, because a brick's run, sum w*rgb and sum
w*t start from zero and meet the carried state only through the gate and
T_bef = exp(-tau).  The model below is test-only; the inputs are the
seeded serving-width bricks of tools/brick_inputs.py (chip_smoke.py phase
2's) at toy size, with denser sigma so the gate closes within the first
few slots.  The kernels take G = 8; the model is held at G 1, 3 and 8."""
import pytest
import torch

from google_nerf_tpu_torch.ops.cuda import brick_field as tbf
from test_torch_cuda import _dense_brick_inputs

TPX, FEAT = tbf.TPX, tbf.FEAT


def _trilerp(pool3, lanes, lerp):
    """The features of M samples, as the plain field computes them."""
    weights = tbf._lerp_w8 if lerp else tbf.trilerp_w8

    def h_of(blk, lid, frac):
        rows = pool3[blk, :, lid] if lanes else pool3[blk, lid]
        rows = tbf._bf(rows).reshape(-1, 8, FEAT)
        return tbf._bf(weights(frac)[..., None] * rows).sum(-2)
    return h_of


def _samples(r, m, n0, ok, S, dt_t, Bk):
    """(bi, ri, si) of the samples in `ok` (B, 64, S) and their voxel lid
    and in-voxel fractions, as _slot_step locates them."""
    o, du, t1 = r[..., 0:3], r[..., 3:6], r[..., 6]
    n_s = n0[..., None] + torch.arange(S, dtype=torch.float32)
    ts = t1[..., None] + (n_s + 0.5) * dt_t
    bi, ri, si = ok.nonzero(as_tuple=True)
    xyz = o[bi, ri] + ts[bi, ri, si][:, None] * du[bi, ri]
    lo_s, hi_s = m[bi, 0:3], m[bi, 3:6]
    u = (xyz - lo_s) * (torch.full_like(lo_s, float(Bk)) / (hi_s - lo_s))
    u = torch.clamp(u, 0.0, Bk - 1e-3)
    v0 = torch.floor(u)
    lid = ((v0[:, 0] * Bk + v0[:, 1]) * Bk + v0[:, 2]).long()
    return (bi, ri, si), lid, u - v0, ts


def _sd(h0, dt_t):
    return torch.clamp_max(torch.exp(torch.clamp_max(h0, 30.0)) * dt_t, 80.0)


def batched_model(args, nslots, *, S, dt, tau_max, Lcall, Bk, G, lanes):
    """K3 (lanes False) or K4 (lanes True, transposed pool) on every tile
    from zero, G list slots at a time.  Returns (out, mlp samples, pairs
    whose gate closed after the first slot of their batch)."""
    pool_blk, meta, rays, sh, pool3, w1, w2, w3 = args
    T = rays.shape[0] // TPX
    Lp = meta.shape[0] // T
    tid = torch.arange(T)
    r = rays.view(T, TPX, 8)
    st = torch.zeros(T, TPX, 8)
    dt_t = torch.tensor(dt, dtype=torch.float32)
    h_of = _trilerp(pool3, lanes, lanes)
    field = tbf._mlp_maker(sh, pool3, (w1, w2, w3), lanes=lanes,
                           lerp=lanes)(tid)
    n_mlp = closed_mid_batch = 0
    for base in range(0, Lcall, G):
        # 1. every pair's window and sum of sigma*dt, for rays alive at the
        #    batch start
        alive0 = st[..., 0] < tau_max
        slots = []
        for l in range(base, min(base + G, Lcall)):
            rows = tid * Lp + l
            m, pb = meta[rows], pool_blk[rows].long()
            n0, n1, hit = tbf.slab_window(r, m, dt)
            hit = hit & (l < nslots)[:, None]
            n_s = n0[..., None] + torch.arange(S, dtype=torch.float32)
            ok = (hit & alive0)[..., None] & (n_s <= n1[..., None])
            idx, lid, frac, ts = _samples(r, m, n0, ok, S, dt_t, Bk)
            sd_d = torch.zeros(ok.shape)
            sd_d[idx] = _sd(h_of(pb[idx[0]], lid, frac)[:, 0], dt_t)
            run = torch.zeros(hit.shape)
            for s in range(S):
                run = run + sd_d[..., s]
            slots.append(dict(m=m, pb=pb, n0=n0, n1=n1, hit=hit, run=run))
        # 2. the live gate, slot by slot in list order
        for k, sl in enumerate(slots):
            act = sl["hit"] & (st[..., 0] < tau_max)
            if k > 0:
                closed_mid_batch += int((sl["hit"] & alive0 & ~act).sum())
            sl["act"] = act
            sl["T_bef"] = torch.where(act, torch.exp(-st[..., 0]), 0.0)
            st[..., 0] += torch.where(act, sl["run"], 0.0)
            st[..., 5] += act.float()
        # 3. the field of live pairs' samples only, then each pair's
        #    composite in window order, added in list order
        for sl in slots:
            act = sl["act"]
            n_s = sl["n0"][..., None] + torch.arange(S, dtype=torch.float32)
            ok = act[..., None] & (n_s <= sl["n1"][..., None])
            idx, lid, frac, ts = _samples(r, sl["m"], sl["n0"], ok, S, dt_t,
                                          Bk)
            h0, rgb = field(idx[0], idx[1], sl["pb"][idx[0]], lid, frac)
            n_mlp += len(h0)
            sd_d = torch.zeros(ok.shape)
            rgb_d = torch.zeros(ok.shape + (3,))
            sd_d[idx] = _sd(h0, dt_t)
            rgb_d[idx] = rgb
            run = torch.zeros(act.shape)
            rgbw = torch.zeros(act.shape + (3,))
            depw = torch.zeros(act.shape)
            for s in range(S):
                w = torch.exp(-run) * (1.0 - torch.exp(-sd_d[..., s]))
                rgbw = rgbw + w[..., None] * rgb_d[..., s, :]
                depw = depw + w * ts[..., s]
                run = run + sd_d[..., s]
            st[..., 1:4] += sl["T_bef"][..., None] * rgbw
            st[..., 4] += sl["T_bef"] * depw
    return st.view(T * TPX, 8), n_mlp, closed_mid_batch


CASES = ([(layout, G, Lcall, None) for layout in ("n", "t")
          for G in (1, 3, 8) for Lcall in (5, 12)]
         + [("n", 3, 12, 65), ("t", 3, 12, 65)])


@pytest.mark.parametrize("layout,G,Lcall,S", CASES)
def test_batched_schedule_matches_plain_bitwise(layout, G, Lcall, S):
    """tau, rgb, depth and n_pairs bit for bit; some rays saturate and the
    gate closes inside a batch (G > 1).  S=65: windows longer than one
    field pass."""
    args, nslots, _, kw = _dense_brick_inputs(S)
    lanes = layout == "t"
    if lanes:
        args[4] = args[4].transpose(1, 2).contiguous()
    plain = (tbf.brick_field_tiles_t_plain if lanes
             else tbf.brick_field_tiles_plain)
    want = plain(*args, nslots=nslots, Lcall=Lcall, **kw)
    got, n_mlp, closed = batched_model(args, nslots, Lcall=Lcall, G=G,
                                       lanes=lanes, S=kw["S"], dt=kw["dt"],
                                       tau_max=kw["tau_max"], Bk=kw["Bk"])
    assert torch.equal(got, want)
    assert float(want[:, 5].sum()) > 0
    saturated = want[:, 0] >= kw["tau_max"]
    assert bool(saturated.any()) and not bool(saturated.all())
    if G > 1:
        assert closed > 0
    assert n_mlp > 0
