"""SyncBN in the port's depth network (DepthModelConfig.bn_axis_name: every
BatchNorm of the encoder and decoder reduces its train-mode statistics
over the process group) in a gloo world of two ranks on the CPU, against
the unsharded train-mode forward of the port and of JAX (mirrors
tests/test_depth_parallel.py: resnet18 at 32^2 from JAX's init, here a
global batch of 4, two images a rank; and its comm cases, which
test_torch_parallel.py and test_torch_dp_ranks.py hold).

Tolerances: the sharded float32 forward against the unsharded port
forward and JAX's unsharded forward at JAX's 2e-4 (rtol and atol: the
synced statistics are flax's E[x^2] - E[x]^2 from summed moments, the
unsharded port's torch's two-pass variance); the running statistics
after the forward within 1e-4 norm-relative per tensor against the
unsharded port's and JAX's, as the voxelnet's flax statistics are held
(PERF.md section 6): in float32 the two variance forms and the sums'
order move layer4's means 1.3e-5 apart (elementwise, a channel mean of
2.2e-4 lies 1.1e-5 relative from the unsharded port's), and float64
holds them to 1e-9; in float64 the forward, the
running statistics, and the gradients of sum(logit * w) with respect to
the images and every parameter (the parameter gradients summed over the
ranks) against the unsharded float64 step at 1e-9 norm-relative; the
biases of the convolutions that feed a BatchNorm, whose gradient is 0 up
to rounding, below 1e-9 on both sides instead (PERF.md section 6)."""
import jax
import numpy as np
import pytest
import torch

from google_nerf_tpu.depth.model import DepthModelConfig as JConfig
from google_nerf_tpu.depth.model import DepthNet as JNet
from google_nerf_tpu.depth.model import init_depth_model as jax_init
from google_nerf_tpu_torch.convert import depth_state_from_jax
from google_nerf_tpu_torch.depth.model import DepthModelConfig, DepthNet
from google_nerf_tpu_torch.parallel.launch import run_world
from test_torch_cli_parity import one_torch_thread  # noqa: F401
from test_torch_dp_ranks import syncbn_cases

N = 2
BATCH = 4
HW = (32, 32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def synced():
    jcfg = JConfig(backbone="resnet18")
    variables = jax_init(jax.random.PRNGKey(0), jcfg, HW)
    rgb = np.asarray(jax.random.uniform(jax.random.PRNGKey(1),
                                        (BATCH,) + HW + (3,)))
    ref, upd = JNet(jcfg).apply(variables, rgb, train=True,
                                mutable=["batch_stats"])
    state = {k: v.numpy() for k, v in
             depth_state_from_jax(_np(variables)).items()}
    jstats = depth_state_from_jax(_np(dict(variables, **upd)))
    x = np.ascontiguousarray(rgb.transpose(0, 3, 1, 2))
    w = np.random.default_rng(3).normal(size=(BATCH, 1) + HW)
    ranks = run_world(syncbn_cases, N, (state, DepthModelConfig(
        backbone="resnet18"), x, w), timeout=120)
    return dict(state=state, x=x, w=w, ref=np.asarray(ref).transpose(
        0, 3, 1, 2), jstats=jstats, ranks=ranks)


def unsharded(synced, dtype):
    model = DepthNet(DepthModelConfig(backbone="resnet18"))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           synced["state"].items()})
    model = model.to(dtype).train()
    x = torch.as_tensor(synced["x"]).to(dtype).requires_grad_(True)
    y = model(x)
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return model, x, y, stats


def test_syncbn_matches_global_batch_stats(synced, one_torch_thread):
    """float32: the ranks' logits together equal the unsharded port
    forward and JAX's (2e-4); the running statistics 1e-4
    norm-relative."""
    _, _, y, stats = unsharded(synced, torch.float32)
    got = np.concatenate([r["logit_float32"] for r in synced["ranks"]])
    np.testing.assert_allclose(got, y.detach().numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got, synced["ref"], rtol=2e-4, atol=2e-4)
    assert len(stats) == 2 * 28            # every BatchNorm synced
    for r in synced["ranks"]:
        for k, v in stats.items():
            assert _rel(r["stats_float32"][k], v.numpy()) <= 1e-4, k
            assert _rel(r["stats_float32"][k],
                        synced["jstats"][k].numpy()) <= 1e-4, k


def test_syncbn_step_matches_unsharded_in_float64(synced,
                                                  one_torch_thread):
    """float64: logits, running statistics, and the gradients with respect
    to the images and the params against the unsharded step, 1e-9
    norm-relative."""
    model, x, y, stats = unsharded(synced, torch.float64)
    (y * torch.as_tensor(synced["w"])).sum().backward()
    got = np.concatenate([r["logit_float64"] for r in synced["ranks"]])
    assert _rel(got, y.detach().numpy()) <= 1e-9
    for r in synced["ranks"]:
        for k, v in stats.items():
            assert _rel(r["stats_float64"][k], v.numpy()) <= 1e-9, k
    gx = np.concatenate([r["grad_x"] for r in synced["ranks"]])
    assert _rel(gx, x.grad.numpy()) <= 1e-9
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    for r in synced["ranks"]:
        assert sorted(r["grads"]) == sorted(grads)
        for k, g in grads.items():
            if np.abs(g).max() < 1e-9:          # a BatchNorm-fed bias
                assert np.abs(r["grads"][k]).max() < 1e-9, k
                continue
            assert _rel(r["grads"][k], g) <= 1e-9, (k, _rel(r["grads"][k], g))
