"""The batched schedule of the tile kernels K1-K5
(csrc/brick_field_dense.cu), modelled in plain PyTorch and held bit for bit
against the slot-serial plain versions `_tiles_plain` and `_wl_plain`.

The kernels take a tile's list G slots at a time: each (ray, slot) pair's
window and its sum of sigma*dt first (from the trilerped feature 0 alone),
then the live gate tau < tau_max slot by slot in list order, and only then
the field (K1-K4's MLP, K5's pre-shaded rgb), for the samples of live pairs
only, composited per pair in window order and added to the state in list
order.  That is the same sums in the same order as one slot at a time,
because a brick's run, sum w*rgb and sum w*t start from zero and meet the
carried state only through the gate and T_bef = exp(-tau).  K3/K4 start
each tile from zero, K1/K2/K5 from its init row (and skip a tile with no
slot or no live ray, which the gate leaves unchanged anyway); K2-K5 batch
a tile's list from lbase, K1 each worklist step's rows apart (a batch
never straddles two steps).  The model below is test-only; the inputs are
the seeded serving-width bricks of tools/brick_inputs.py (chip_smoke.py
phase 2's) at toy size, with denser sigma so the gate closes within the
first few slots.  The kernels take G = 8; the model is held at G 1, 3
and 8."""
import pytest
import torch

from google_nerf_tpu_torch.ops.cuda import brick_field as tbf
from test_torch_cuda import (_carry_inputs, _dense_brick_inputs,
                             _split_worklist)

TPX, FEAT = tbf.TPX, tbf.FEAT


def _trilerp(pool3, lanes, lerp, width=FEAT):
    """The features (width 4: K5's channels) of M samples, as the plain
    field computes them."""
    weights = tbf._lerp_w8 if lerp else tbf.trilerp_w8

    def h_of(blk, lid, frac):
        rows = pool3[blk, :, lid] if lanes else pool3[blk, lid]
        rows = tbf._bf(rows).reshape(-1, 8, width)
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


def tile_batches(tid, lbase, nslots, Lcall, G):
    """K2-K4's schedule: tile b takes rows lbase[b] + l, l < min(nslots[b],
    Lcall), G at a time -> (B, batches, G) list rows, -1 for none."""
    n = torch.clamp(nslots.long(), max=Lcall)
    l = torch.arange(-(-Lcall // G) * G)
    rows = torch.where(l[None] < n[:, None], lbase.long()[:, None] + l, -1)
    return rows.view(len(tid), -1, G)


def worklist_batches(wt, wl, wn, wf, P, G):
    """K1's schedule: each wf == 1 step starts a tile, whose run of steps
    (same wt, wf == 0) gives rows wl[j] + k, k < min(wn[j], P), each step
    in batches of G of its own -> (tiles, (B, batches, G) list rows)."""
    tiles, runs = [], []
    for j0 in range(len(wt)):
        if int(wf[j0]) != 1:
            continue
        j, run = j0, []
        while j < len(wt) and (j == j0 or (wt[j] == wt[j0] and wf[j] != 1)):
            rows = [int(wl[j]) + k for k in range(min(int(wn[j]), P))]
            run += [rows[i:i + G] + [-1] * (G - len(rows[i:i + G]))
                    for i in range(0, len(rows), G)]
            j += 1
        tiles.append(int(wt[j0]))
        runs.append(run)
    nb = max(len(r) for r in runs)
    return (torch.tensor(tiles),
            torch.tensor([r + [[-1] * G] * (nb - len(r)) for r in runs]))


def batched_model(args, tiles, batches, st, *, S, dt, tau_max, Bk, lanes,
                  lerp, rgba=False):
    """The batched body on `tiles` from the state st (B, 64, 8), updated
    in place, taking each tile's list rows batch by batch (batches (B,
    n, G), -1 for no row); rgba: K5's args and field.  Returns (shaded
    samples, pairs whose gate closed after the first slot of their
    batch)."""
    pool_blk, meta, rays = args[:3]
    T = rays.shape[0] // TPX
    r = rays.view(T, TPX, 8)[tiles]
    dt_t = torch.tensor(dt, dtype=torch.float32)
    if rgba:
        h_of = _trilerp(args[3], True, True, width=4)
        field = tbf._rgba_field(args[3])
    else:
        sh, pool3, w1, w2, w3 = args[3:]
        h_of = _trilerp(pool3, lanes, lerp)
        field = tbf._mlp_maker(sh, pool3, (w1, w2, w3), lanes=lanes,
                               lerp=lerp)(tiles)
    n_shaded = closed_mid_batch = 0
    for batch in batches.unbind(1):
        # 1. every pair's window and sum of sigma*dt, for rays alive at the
        #    batch start
        alive0 = st[..., 0] < tau_max
        slots = []
        for row in batch.unbind(1):
            rows = row.clamp(0, meta.shape[0] - 1)
            m, pb = meta[rows], pool_blk[rows].long()
            n0, n1, hit = tbf.slab_window(r, m, dt)
            hit = hit & (row >= 0)[:, None]
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
            n_shaded += len(h0)
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
    return n_shaded, closed_mid_batch


def _run_model(args, tiles, batches, out, kw, *, lanes, lerp, rgba=False):
    """The model on `tiles` from their rows of out (in place)."""
    st = out.view(-1, TPX, 8)[tiles].clone()
    counts = batched_model(args, tiles, batches, st, lanes=lanes, lerp=lerp,
                           rgba=rgba, **kw)
    out.view(-1, TPX, 8)[tiles] = st
    return counts


CASES = ([(layout, G, Lcall, None) for layout in ("n", "t")
          for G in (1, 3, 8) for Lcall in (5, 12)]
         + [("n", 3, 12, 65), ("t", 3, 12, 65)])


@pytest.mark.parametrize("layout,G,Lcall,S", CASES)
def test_batched_schedule_matches_plain_bitwise(layout, G, Lcall, S):
    """K3/K4 from zero: tau, rgb, depth and n_pairs bit for bit; some rays
    saturate and the gate closes inside a batch (G > 1).  S=65: windows
    longer than one field pass."""
    args, nslots, Lp, kw = _dense_brick_inputs(S)
    lanes = layout == "t"
    if lanes:
        args[4] = args[4].transpose(1, 2).contiguous()
    plain = (tbf.brick_field_tiles_t_plain if lanes
             else tbf.brick_field_tiles_plain)
    want = plain(*args, nslots=nslots, Lcall=Lcall, **kw)
    tid = torch.arange(len(nslots))
    got = torch.zeros_like(want)
    n_mlp, closed = _run_model(args, tid, tile_batches(
        tid, tid * Lp, nslots, Lcall, G), got, kw, lanes=lanes, lerp=lanes)
    assert torch.equal(got, want)
    assert float(want[:, 5].sum()) > 0
    saturated = want[:, 0] >= kw["tau_max"]
    assert bool(saturated.any()) and not bool(saturated.all())
    if G > 1:
        assert closed > 0
    assert n_mlp > 0


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("P,Lcall", [(8, 16), (16, 32), (4, 12)])
def test_batched_carry_matches_plain_bitwise(G, P, Lcall):
    """K2 from its init carry, bit for bit against its plain version:
    listed tiles 0, 1, 2, 4, 5 (tile 3 unlisted), tile 2 with no slot,
    tile 5 saturated on entry; K2's P and an Lcall that G need not
    divide.  Unlisted and skipped tiles keep init's rows, columns 6-7
    keep init's values everywhere."""
    args, nslots, Lp, kw, init = _carry_inputs()
    tid = torch.tensor([0, 1, 2, 4, 5])
    ns = nslots[tid].clone()
    ns[2] = 0
    call = dict(tid=tid, lbase=tid * Lp, nslots=ns, Lcall=Lcall, **kw)
    want = tbf.brick_field_tiles_tp_plain(*args, P=P, init=init, **call)
    got = init.clone()
    n_mlp, closed = _run_model(args, tid, tile_batches(
        tid, tid * Lp, ns, Lcall, G), got, kw, lanes=False, lerp=True)
    assert torch.equal(got, want)
    assert torch.equal(want[2 * TPX:4 * TPX], init[2 * TPX:4 * TPX])
    assert torch.equal(want[5 * TPX:], init[5 * TPX:])
    assert torch.equal(want[:, 6:8], init[:, 6:8])
    assert bool((want[:, 5] > init[:, 5]).any()) and n_mlp > 0
    if G > 1:
        assert closed > 0


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("P", [8, 16])
def test_batched_worklist_matches_plain_bitwise(G, P):
    """K1 from its init carry, bit for bit against its plain version, each
    step batched apart: a tile split over two steps with fewer than P rows
    on the first, a tile with no step, pad steps, a tile saturated on
    entry."""
    args, nslots, Lp, kw, init = _carry_inputs()
    wl_args = _split_worklist(nslots, Lp, P)
    want = tbf.brick_field_tiles_wl_plain(*args, *wl_args, P=P, init=init,
                                          **kw)
    got = init.clone()
    tiles, batches = worklist_batches(*wl_args, P, G)
    assert tiles.tolist() == [0, 1, 4, 5]
    n_mlp, closed = _run_model(args, tiles, batches, got, kw, lanes=False,
                               lerp=True)
    assert torch.equal(got, want)
    assert torch.equal(want[2 * TPX:4 * TPX], init[2 * TPX:4 * TPX])
    assert torch.equal(want[5 * TPX:], init[5 * TPX:])
    assert bool((want[TPX:2 * TPX, 5] > init[TPX:2 * TPX, 5]).any())
    assert n_mlp > 0
    if G > 1:
        assert closed > 0


@pytest.mark.parametrize("G,Lcall,S", [(G, Lcall, None) for G in (1, 3, 8)
                                       for Lcall in (5, 12, 16)]
                         + [(3, 12, 65), (8, 12, 65)])
def test_batched_rgba_carry_matches_plain_bitwise(G, Lcall, S):
    """K5 from its init carry on pre-shaded slabs, bit for bit against its
    plain version: listed tiles 0, 1, 2, 4, 5 (tile 3 unlisted), tile 2
    with no slot, tile 5 saturated on entry; Lcall below, above and a
    multiple of 8; S=65: windows longer than one field pass.  Some rays
    saturate inside the call and, for G > 1, the gate closes inside a
    batch.  Unlisted and skipped tiles keep init's rows, columns 6-7 keep
    init's values everywhere."""
    args, nslots, Lp, kw, init = _carry_inputs(rgba=True, S=S)
    tid = torch.tensor([0, 1, 2, 4, 5])
    ns = nslots[tid].clone()
    ns[2] = 0
    call = dict(tid=tid, lbase=tid * Lp, nslots=ns, Lcall=Lcall, **kw)
    want = tbf.brick_field_tiles_rgba_plain(*args, init=init, **call)
    got = init.clone()
    n_shaded, closed = _run_model(args, tid, tile_batches(
        tid, tid * Lp, ns, Lcall, G), got, kw, lanes=True, lerp=True,
        rgba=True)
    assert torch.equal(got, want)
    assert torch.equal(want[2 * TPX:4 * TPX], init[2 * TPX:4 * TPX])
    assert torch.equal(want[5 * TPX:], init[5 * TPX:])
    assert torch.equal(want[:, 6:8], init[:, 6:8])
    rendered = want[:, 5] > init[:, 5]
    saturated = rendered & (want[:, 0] >= kw["tau_max"])
    assert bool(saturated.any()) and not bool(saturated[rendered].all())
    assert n_shaded > 0
    if G > 1:
        assert closed > 0
