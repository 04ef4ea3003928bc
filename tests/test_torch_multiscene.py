"""Multi-scene training in the port (parallel/multiscene.py): one scene a
rank in a gloo world of two on the CPU, against lone runs of each scene
and against JAX's make_multiscene_train_step on a ('scene',) mesh of two
(mirrors tests/test_multiscene.py with S = 2: its model and scenes, 3
views at 16x16 from seeds 0 and 1), from JAX's stacked states carried
across by convert.multiscene_states_from_jax.

Each rank's scene after two multi-scene steps equals a lone run of
fused_train_step on the same draws, bit for bit (one thread on both
sides), and the per-scene metrics come out as (S,) tensors on every
rank.  Each scene's first loss lies within rtol 1e-5 of JAX's (JAX's
draws: scene s takes jax.random.split(key, S)[s]).  The converted
states equal JAX's unstack_states leaf by leaf."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from google_nerf_tpu.data.synthetic import SyntheticDataset
from google_nerf_tpu.models.ngp import NGPConfig as JNGPConfig
from google_nerf_tpu.parallel.multiscene import (make_multiscene_train_step,
                                                 stack_scenes, stack_states,
                                                 unstack_states)
from google_nerf_tpu.train import system as jsys
from google_nerf_tpu_torch.convert import (multiscene_states_from_jax,
                                           train_state_from_jax,
                                           train_state_to_numpy)
from google_nerf_tpu_torch.models.ngp import NGPConfig
from google_nerf_tpu_torch.parallel.launch import run_world
from google_nerf_tpu_torch.train import system as tsys
from test_torch_cli_parity import one_torch_thread  # noqa: F401
from test_torch_dp_ranks import multiscene_cases
from test_torch_train_step import jax_step_draws

S = 2
STEPS = 2
MODEL = dict(scale=0.5, encoder="packed", packed_levels=2,
             packed_log2_size=8, grid_size=16)
TRAIN = dict(batch_size=128, k_samples=8, max_samples=32, samples_budget=0)
KEY = jax.random.PRNGKey(7)
LEAVES = ("params", "density_grid", "occ", "occ_u8", "step")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def step_draws(key, scene, B):
    """fused_train_step's draws from its key without random backgrounds:
    render_train's noise takes the step's second key whole."""
    k2, d = jax_step_draws(key, scene, B)
    d.pop("bg")
    d["noise"] = torch.as_tensor(np.array(jax.random.uniform(k2, (B,))))
    return {k: v.numpy() for k, v in d.items()}


@pytest.fixture(scope="module")
def multi():
    jcfg = jsys.TrainConfig(model=JNGPConfig(**MODEL), **TRAIN)
    cfg = tsys.TrainConfig(model=NGPConfig(**MODEL), **TRAIN)
    states, scenes = [], []
    for s in range(S):
        ds = SyntheticDataset(split="train", n_images=3, img_wh=(16, 16),
                              seed=s)
        st = jsys.init_train_state(jax.random.PRNGKey(s), jcfg, ds.K,
                                   ds.poses, ds.img_wh)
        st = jsys.grid_update_step(st, jax.random.PRNGKey(100 + s),
                                   cfg=jcfg, warmup=True)
        states.append(st)
        scenes.append(ds.scene())
    stacked = stack_states(states)
    np_scenes = [np_tree(sc) for sc in scenes]
    draws = [[step_draws(k, np_scenes[s], cfg.batch_size)
              for s, k in enumerate(jax.random.split(
                  jax.random.fold_in(KEY, i), S))] for i in range(STEPS)]
    tree = np_tree({k: stacked[k] for k in LEAVES})
    trees = [train_state_to_numpy(st) for st in
             multiscene_states_from_jax(tree, S, cfg, "cpu")]
    ranks = run_world(multiscene_cases, S, (trees, np_scenes, cfg, draws),
                      timeout=120)
    mesh = Mesh(np.array(jax.devices()[:S]), ("scene",))
    jstep = make_multiscene_train_step(jcfg, mesh)
    _, jmetrics = jstep(stacked, stack_scenes(scenes),
                        jax.random.fold_in(KEY, 0))
    return dict(cfg=cfg, stacked=stacked, tree=tree, trees=trees,
                scenes=np_scenes, draws=draws, ranks=ranks,
                jmetrics=np_tree(jmetrics))


def test_multiscene_metrics_are_per_scene(multi):
    for out in multi["ranks"]:
        for m in out["metrics"]:
            assert sorted(m) == ["loss", "lr", "mask_frac", "psnr",
                                 "s_per_ray"]
            for v in m.values():
                assert v.shape == (S,)
            assert np.isfinite(m["loss"]).all()
    m0, m1 = (r["metrics"] for r in multi["ranks"])
    for a, b in zip(m0, m1):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_each_scene_equals_its_lone_run(multi, one_torch_thread):
    """Scene s of the world (gathered on every rank) against
    fused_train_step run alone on scene s with the same draws."""
    cfg = multi["cfg"]
    for s in range(S):
        st = train_state_from_jax(multi["trees"][s], cfg, "cpu")
        sc = {k: torch.as_tensor(v) for k, v in multi["scenes"][s].items()}
        for i in range(STEPS):
            st, m = tsys.fused_train_step(st, sc, cfg, draws={
                k: torch.as_tensor(v)
                for k, v in multi["draws"][i][s].items()})
            for k, v in m.items():
                assert multi["ranks"][0]["metrics"][i][k][s] == \
                    np.float32(float(v)), (s, i, k)
        want = train_state_to_numpy(st)
        for out in multi["ranks"]:
            got = out["states"][s]
            assert int(got["step"]) == STEPS
            flat = jax.tree_util.tree_leaves
            for a, b in zip(flat(got), flat(want)):
                np.testing.assert_array_equal(a, b)
    t0, t1 = (multi["ranks"][0]["states"][s]["params"]["packed_table"]
              for s in range(S))
    assert not np.allclose(t0, t1)


def test_first_loss_matches_jax_multiscene_step(multi):
    np.testing.assert_allclose(multi["ranks"][0]["metrics"][0]["loss"],
                               multi["jmetrics"]["loss"], rtol=1e-5)


def test_multiscene_states_from_jax_equal_unstack_states(multi):
    """convert.multiscene_states_from_jax: scene s's params, grid,
    occupancy, packed words and step equal JAX's unstack_states(s), leaf
    by leaf (the optax state is not carried); a tree without the scene
    axis is refused."""
    want = unstack_states(multi["stacked"], S)
    for s, got in enumerate(multi["trees"]):
        w = np_tree({k: want[s][k] for k in LEAVES})
        flat = jax.tree_util.tree_leaves
        assert len(flat(got)) == len(flat(w))
        for a, b in zip(flat(got), flat(w)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="scene axis"):
        multiscene_states_from_jax(multi["tree"], S + 1, multi["cfg"],
                                   "cpu")
