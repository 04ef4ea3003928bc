"""The training loop of the PyTorch port against JAX's, at a small size
(grid 32, 4 packed levels of 2^12 rows, 256 rays, max_samples 256, a
budget of 7 samples a ray as bench.py's), from one JAX train state
converted by train_state_from_jax and on the draws JAX makes from its
keys (system.py:348, :205-207, :232-235; rendering.py:65;
grid.py:179-199).

Tolerances: the loss rtol 1e-5; psnr, s_per_ray and mask_frac 1e-5.
Gradients, as the norm of the difference over the norm of JAX's: in
f32 compute 1e-4 for the rgb MLP and 1e-3 on the sigma path (the table
and sigma_mlp), in bf16 compute 2e-2 for all (JAX's own bf16 tolerance).
The sigma path's bound is JAX's error, not the port's: JAX's f32 stream
composite is further from the same step with the composite in float64
than the port is (asserted), and the port is held to that float64 step
at 1e-5.  JAX's jitted step moves further than these bounds from its
own op-by-op run on this fixture, so JAX is run op by op.  The Adam update from the
same gradients rtol 1e-4 at steps 1 and 10.  One grid update: the grid
rtol 1e-4, occ equal except at cells within 1e-5 relative of the
threshold, and the block2 words equal to JAX's packing of that occ."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from google_nerf_tpu.data.synthetic import SyntheticDataset as JDataset
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.train import system as jsys
from google_nerf_tpu_torch.convert import (train_state_from_jax,
                                           train_state_to_numpy)
from google_nerf_tpu_torch.data.synthetic import SyntheticDataset
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.train import system as tsys

MODEL = dict(scale=0.5, encoder="packed", grid_size=32, packed_levels=4,
             packed_log2_size=12)
TRAIN = dict(batch_size=256, k_samples=256, max_samples=256,
             samples_budget=7 * 256, grid_sample_div=16, random_bg=True,
             exclude_incomplete="backfill", march="block2")


def configs(dtype="bfloat16", **over):
    kw = dict(TRAIN, **over)
    jcfg = jsys.TrainConfig(model=JNGPConfig(
        compute_dtype=getattr(jnp, dtype), **MODEL), **kw)
    cfg = tsys.TrainConfig(model=NGPConfig(
        compute_dtype=getattr(torch, dtype), **MODEL), **kw)
    return jcfg, cfg


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's dataset and a JAX state after a warmup and a sampled grid
    update (table x1e3, as the JAX model tests' fixture), as numpy."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GNT_GT_CACHE", str(tmp_path_factory.mktemp("gt")))
    try:
        ds = JDataset(split="train", n_images=4, img_wh=(24, 24),
                      style="textured")
    finally:
        mp.undo()
    jcfg, _ = configs()
    state = jsys.init_train_state(jax.random.PRNGKey(0), jcfg, ds.K,
                                  ds.poses, ds.img_wh)
    state["params"]["packed_table"] = state["params"]["packed_table"] * 1e3
    state = jsys.grid_update_step(state, jax.random.PRNGKey(1), cfg=jcfg,
                                  warmup=True)
    state = jsys.grid_update_step(state, jax.random.PRNGKey(2), cfg=jcfg,
                                  warmup=False)
    tree = np_tree({k: state[k] for k in ("params", "density_grid", "occ",
                                          "occ_u8", "step")})
    scene = {k: np.array(v) for k, v in ds.scene().items()}
    return ds, tree, scene


def port_state(tree, cfg, step=None):
    st = train_state_from_jax(tree, cfg, device="cpu")
    if step is not None:
        st["step"] = step
    return st


def jax_state(tree, jcfg, step=None):
    st = jax.tree_util.tree_map(jnp.asarray, tree)
    st["opt_state"] = jsys.make_optimizer(jcfg).init(st["params"])
    st["step"] = jnp.asarray(tree["step"] if step is None else step,
                             jnp.int32)
    return st


def jax_step_draws(key, scene, B):
    """fused_train_step's draws from its key, as the port takes them."""
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    n_img, n_pix = scene["images"].shape[:2]
    _, kbg = jax.random.split(k2)
    draws = dict(img_idxs=jax.random.randint(ka, (B,), 0, n_img),
                 pix_idxs=jax.random.randint(kb, (B,), 0, n_pix),
                 bg=jax.random.uniform(kbg, (B, 3)),
                 noise=jax.random.uniform(jax.random.split(k2)[0], (B,)))
    return k2, {k: torch.as_tensor(np.array(v)) for k, v in draws.items()}


def jax_grid_draws(key, G, warmup, sample_div):
    kc = jax.random.fold_in(key, 0)
    d, n = {}, G ** 3
    if not warmup:
        m = G ** 3 // sample_div
        k1, k2, _ = jax.random.split(kc, 3)
        d["coords_u"] = jax.random.randint(k1, (m, 3), 0, G, dtype=jnp.int32)
        d["u"] = jax.random.uniform(k2, (m,))
        d["rand_idx"] = jax.random.randint(jax.random.fold_in(k2, 1), (m,),
                                           0, G ** 3)
        n = 2 * m
    d["jitter"] = jax.random.uniform(jax.random.fold_in(kc, 7), (n, 3))
    return [{k: torch.as_tensor(np.array(v)) for k, v in d.items()}]


def tscene(scene):
    return {k: torch.as_tensor(v) for k, v in scene.items()}


def _flat_grads(jgrads):
    out = {}
    for k in sorted(jgrads):
        v = jgrads[k]
        if isinstance(v, list):
            out.update({f"{k}.{i}": np.asarray(w) for i, w in enumerate(v)})
        else:
            out[k] = np.asarray(v)
    return out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grads_with_f64_composite(st, sc, tb, cfg, draws):
    """loss_and_grads with the stream composite evaluated in float64."""
    from google_nerf_tpu_torch.models import rendering
    orig = rendering.composite_stream_train

    def f64(plan, *args):
        out = orig(plan, *(a.double() for a in args[:4]), *args[4:])
        return {k: v.float() for k, v in out.items()}

    rendering.composite_stream_train = f64
    try:
        return tsys.loss_and_grads(st, sc, tb, cfg, draws=draws)
    finally:
        rendering.composite_stream_train = orig


@pytest.mark.parametrize("dtype,step", [("bfloat16", 300), ("float32", 0)])
def test_one_fused_train_step_matches_jax(world, dtype, step):
    """One step at the recipe (random bg, backfill on past warmup at step
    300, off at step 0): loss, metrics and every gradient."""
    ds, tree, scene = world
    jcfg, cfg = configs(dtype)
    key = jax.random.PRNGKey(7)
    k2, draws = jax_step_draws(key, scene, cfg.batch_size)
    jst = jax_state(tree, jcfg, step)
    batch = jsys.sample_batch(jax.random.split(key)[0], scene,
                              cfg.batch_size)

    def jloss(params):
        return jsys.loss_and_results(
            params, {"occ": jst["occ"], "occ_u8": jst["occ_u8"]}, scene,
            batch, k2, jcfg, step=jst["step"])

    # JAX evaluated op by op (its marcher stays jitted): jitted whole, XLA
    # reorders the stream's (B, 7) cumsum and its per-ray sums move by up
    # to ~3e-4 against its own eager run on these inputs
    (jl, jres), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jst["params"])
    _, jmetrics = jsys._train_step_impl(jst, scene, batch, k2, jcfg)

    st = port_state(tree, cfg, step)
    sc = tscene(scene)
    tb = tsys.sample_batch(sc, cfg.batch_size, img_idxs=draws["img_idxs"],
                           pix_idxs=draws["pix_idxs"])
    loss, res, grads = tsys.loss_and_grads(st, sc, tb, cfg, draws=draws)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_array_equal(res["valid"].numpy(),
                                  np.asarray(jres["valid"]))
    np.testing.assert_array_equal(res["ray_mask"].numpy(),
                                  np.asarray(jres["ray_mask"]))
    assert 0 < int(res["total_samples"]) and not bool(res["ray_mask"].all())
    for k, jg in _flat_grads(jgrads).items():
        tol = 2e-2 if dtype == "bfloat16" else (
            1e-3 if k.startswith(("packed_table", "sigma_mlp")) else 1e-4)
        assert _rel(grads[k], jg) <= tol, (k, _rel(grads[k], jg))
    if dtype == "float32":
        _, _, g64 = _grads_with_f64_composite(port_state(tree, cfg, step),
                                              sc, tb, cfg, draws)
        for k, g in grads.items():
            assert _rel(g, g64[k].numpy()) <= 1e-5, (k, _rel(g, g64[k]))
        jt = _flat_grads(jgrads)["packed_table"]
        assert _rel(jt, g64["packed_table"]) > _rel(grads["packed_table"],
                                                    g64["packed_table"])
    _, metrics = tsys.fused_train_step(port_state(tree, cfg, step), sc, cfg,
                                       draws=draws)
    for k in ("loss", "psnr", "s_per_ray", "mask_frac"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert metrics["lr"] == pytest.approx(float(jmetrics["lr"]), rel=1e-6)


@pytest.mark.parametrize("over", [{}, dict(weight_decay=1e-3),
                                  dict(optimize_ext=True)])
def test_adam_updates_match_optax(world, over):
    """From the same gradients, the port's optimizer and optax's agree
    after the first and the tenth update (Adam, AdamW with decay on the
    table, and the pose group at lr 1e-6): the summed update within rtol
    1e-4.  optax forms the bias corrections 1 - b^t in f32 (1 - 0.999 is
    1.3e-5 off at t = 1), torch in double, so updates differ by ~1e-5
    relative."""
    _, tree, _ = world
    jcfg, cfg = configs(**over)
    params = tree["params"]
    if cfg.optimize_ext:
        params = dict(params, dR=np.zeros((4, 3), np.float32),
                      dT=np.zeros((4, 3), np.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tx = jsys.make_optimizer(jcfg)
    jopt = tx.init(jp)
    st = port_state(dict(tree, params=params), cfg)
    leaves = tsys.param_leaves(st["params"])
    p0 = {k: v.detach().numpy().copy() for k, v in leaves.items()}
    rng = np.random.RandomState(0)
    for i in range(10):
        g = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32) * 1e-2, params)
        upd, jopt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jopt,
                              jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in _flat_grads(g).items():
            leaves[k].grad = torch.as_tensor(v)
        tsys.set_lr(st["opt"], cfg, i)
        st["opt"].step()
        if i in (0, 9):
            for k, v in _flat_grads(jp).items():
                upd = leaves[k].detach().numpy() - p0[k]
                want = v - p0[k]
                np.testing.assert_allclose(upd, want, rtol=1e-4,
                                           atol=1e-4 * np.abs(want).max(),
                                           err_msg=f"{k} after {i + 1}")


def test_grid_update_step_matches_jax(world):
    """One sampled grid update (block2 packing) on JAX's draws: the same
    occupancy and block2 words."""
    _, tree, _ = world
    jcfg, cfg = configs("float32")
    key = jax.random.PRNGKey(5)
    jst = jsys.grid_update_step(jax_state(tree, jcfg), key, cfg=jcfg,
                                warmup=False)
    st = tsys.grid_update_step(
        port_state(tree, cfg), cfg, warmup=False,
        draws=jax_grid_draws(key, 32, False, cfg.grid_sample_div))
    grid, jgrid_ = st["density_grid"].numpy(), np.asarray(jst["density_grid"])
    np.testing.assert_allclose(grid, jgrid_, rtol=1e-4)
    pos = jgrid_ > 0
    thr = min(jgrid_[pos].mean(), cfg.density_threshold)
    near = np.abs(jgrid_ - thr) <= 1e-5 * thr
    occ = st["occ"].numpy()
    np.testing.assert_array_equal(occ[~near], np.asarray(jst["occ"])[~near])
    assert near.mean() < 1e-3
    from google_nerf_tpu.ops.march_block import pack_occupancy_block2
    want = pack_occupancy_block2(occ, max_samples=cfg.max_samples,
                                 scale=cfg.model.scale)
    for k in ("blocks4", "super"):
        np.testing.assert_array_equal(st["occ_u8"][k].numpy(),
                                      np.asarray(want[k]))
    if not near.any():
        for k in ("blocks4", "super"):
            np.testing.assert_array_equal(st["occ_u8"][k].numpy(),
                                          np.asarray(jst["occ_u8"][k]))
    assert 0 < occ.mean() < 1


def test_train_state_round_trip(world):
    """A JAX state's numpy leaves through the port and back: params,
    grid, occ and the block2 words exact."""
    _, tree, _ = world
    _, cfg = configs()
    back = train_state_to_numpy(port_state(tree, cfg))
    flat = lambda t: jax.tree_util.tree_leaves(t)  # noqa: E731
    assert len(flat(back)) == len(flat(tree))
    for a, b in zip(flat(back), flat(tree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


def test_dataset_sample_and_scene_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("GNT_GT_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("GNT_TORCH_GT_CACHE", str(tmp_path / "torch"))
    kw = dict(split="train", n_images=3, img_wh=(12, 12), style="textured")
    want = JDataset(**kw)
    got = SyntheticDataset(device="cpu", **kw)
    b, jb = (d.sample(np.random.default_rng(3), 50) for d in (got, want))
    for k in ("img_idxs", "pix_idxs"):
        np.testing.assert_array_equal(b[k], jb[k])
    np.testing.assert_allclose(b["rgb"], jb["rgb"], atol=1e-5)
    for u8 in (False, True):
        s, js = got.scene(images_uint8=u8), want.scene(images_uint8=u8)
        assert sorted(s) == sorted(js)
        for k in s:
            assert tuple(s[k].shape) == tuple(js[k].shape), k
            assert s[k].device.type == "cpu"
            tol = 1 if s[k].dtype == torch.uint8 else 1e-5
            np.testing.assert_allclose(s[k].numpy().astype(np.float32),
                                       np.asarray(js[k], np.float32),
                                       atol=tol, err_msg=k)


def test_tiny_run_loss_falls_and_stays_finite():
    """40 steps from the port's own init on its own dataset (white
    background): every step's loss finite, and the loss of one fixed
    batch and set of draws at most half of what it was before."""
    ds = SyntheticDataset(split="train", n_images=6, img_wh=(24, 24),
                          device="cpu")
    _, cfg = configs("float32", random_bg=False)
    state = tsys.init_train_state(cfg, ds.K, ds.poses, ds.img_wh,
                                  generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    gen = torch.Generator().manual_seed(1)
    scene = ds.scene()
    fg = torch.Generator().manual_seed(5)
    fixed = dict(img_idxs=torch.randint(0, 6, (1024,), generator=fg),
                 pix_idxs=torch.randint(0, 24 * 24, (1024,), generator=fg),
                 noise=torch.rand(1024, generator=fg))
    big = tsys.TrainConfig(**dict(vars(cfg), batch_size=1024,
                                  samples_budget=7 * 1024))

    def fixed_loss():
        b = tsys.sample_batch(scene, 1024, img_idxs=fixed["img_idxs"],
                              pix_idxs=fixed["pix_idxs"])
        return float(tsys.loss_and_grads(state, scene, b, big,
                                         draws=fixed)[0])

    tsys.grid_update_step(state, cfg, warmup=True, generator=gen)
    before = fixed_loss()
    losses = []
    for _ in range(40):
        state, m = tsys.run_training(state, scene, cfg, steps=1,
                                     generator=gen)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert fixed_loss() < 0.5 * before
    assert state["step"] == 40 and state["occ"].any()


@pytest.mark.slow
def test_convergence_mirror_of_verify_recipe():
    """.claude/skills/verify/SKILL.md's CPU recipe (300 steps, batch 2048,
    k 32, max_samples 256, grid 32, log2 14, budget 16x rays, 50 solid
    64^2 images) on march="block2", the port's marcher, both trainers from
    JAX's initial state and on JAX's draws for every step and grid
    update: the mean train psnr of the last 10 steps within 1.5 dB of
    JAX's."""
    kw = dict(batch_size=2048, k_samples=32, max_samples=256,
              samples_budget=16 * 2048, num_epochs=1, steps_per_epoch=300,
              exclude_incomplete="backfill", march="block2")
    model = dict(scale=0.5, encoder="packed", grid_size=32,
                 packed_log2_size=14)
    jds = JDataset(split="train")
    jcfg = jsys.TrainConfig(model=JNGPConfig(**model), **kw)
    cfg = tsys.TrainConfig(model=NGPConfig(**model), **kw)
    jst = jsys.init_train_state(jax.random.PRNGKey(0), jcfg, jds.K,
                                jds.poses, jds.img_wh)
    st = port_state(np_tree({k: jst[k] for k in (
        "params", "density_grid", "occ", "occ_u8", "step")}), cfg)
    jscene = jds.scene()
    scene = {k: np.array(v) for k, v in jscene.items()}
    sc = tscene(scene)
    key = jax.random.PRNGKey(0)
    jpsnr, psnr = [], []
    for i in range(300):
        if i % 16 == 0:
            gk = jax.random.fold_in(key, 2 * i + 1)
            jst = jsys.grid_update_step(jst, gk, cfg=jcfg, warmup=i < 256)
            tsys.grid_update_step(st, cfg, warmup=i < 256,
                                  draws=jax_grid_draws(gk, 32, i < 256,
                                                       cfg.grid_sample_div))
        sk = jax.random.fold_in(key, 2 * i)
        _, draws = jax_step_draws(sk, scene, cfg.batch_size)
        jst, jm = jsys.fused_train_step(jst, jscene, sk, cfg=jcfg)
        st, m = tsys.fused_train_step(st, sc, cfg, draws=draws)
        jpsnr.append(float(jm["psnr"]))
        psnr.append(float(m["psnr"]))
    assert np.mean(jpsnr[-10:]) > 20.0
    assert abs(np.mean(psnr[-10:]) - np.mean(jpsnr[-10:])) < 1.5
