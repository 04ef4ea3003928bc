"""The port's LeReS depth network (google_nerf_tpu_torch/depth/) against
JAX's (google_nerf_tpu/depth/) on the CPU: every case of
tests/test_depth_model.py, run through both on the same seeded numpy
inputs and on JAX's parameters carried across by
convert.depth_state_from_jax, plus the modules those cases do not reach
(StyleMod, ATA, the config tree) and the port's own initialiser.

Tolerances: encoder features, logits, AdaIN activations, auxi outputs,
depth_inference: norm-relative 1e-5 (f32 convolutions summed in another
order; seen up to 1.4e-6 here); upsample_bilinear rtol and atol
1e-5, the bound JAX's own test holds it to against torch (JAX's
gather-and-lerp, its weights from linspace, against F.interpolate; seen
1.4e-6 on values of unit scale); StyleMod, ATA 1e-6 relative; the
config tree and lateral channels exactly.  JAX's inputs are NHWC, the port's NCHW."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.depth import adain as jadain
from google_nerf_tpu.depth import config as jconfig
from google_nerf_tpu.depth import decoder as jdecoder
from google_nerf_tpu.depth.backbones import LateralEncoder as JEncoder
from google_nerf_tpu.depth.backbones import \
    lateral_channels as jax_lateral_channels
from google_nerf_tpu.depth.model import DepthModelConfig as JConfig
from google_nerf_tpu.depth.model import DepthNet as JNet
from google_nerf_tpu.depth.model import depth_inference as jax_inference
from google_nerf_tpu.depth.model import get_adain_init_act as jax_acts
from google_nerf_tpu.depth.model import init_depth_model as jax_init
from google_nerf_tpu.depth.model import set_mean_var_shifts as jax_shifts
from google_nerf_tpu_torch.convert import depth_state_from_jax
from google_nerf_tpu_torch.depth import adain, config, decoder
from google_nerf_tpu_torch.depth.backbones import (_ARCHS, ENCODER_ALIASES,
                                                   LateralEncoder,
                                                   lateral_channels)
from google_nerf_tpu_torch.depth.model import (DepthModelConfig, DepthNet,
                                               depth_forward,
                                               depth_inference,
                                               get_adain_init_act,
                                               init_depth_model,
                                               normalize_rgb,
                                               set_mean_var_shifts)

REL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(
        0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carried(kw, hw=(32, 32), key=0):
    """JAX's init of a DepthModelConfig(**kw) and the port's DepthNet
    holding the same variables."""
    variables = jax_init(jax.random.PRNGKey(key), JConfig(**kw), hw)
    model = DepthNet(DepthModelConfig(**kw)).eval()
    model.load_state_dict(depth_state_from_jax(_np(variables)), strict=True)
    return variables, model


def _rgb(shape, seed=1):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _z(b, d, seed=2):
    return np.random.default_rng(seed).normal(size=(b, d)).astype(np.float32)


@pytest.mark.parametrize("arch", sorted(_ARCHS) + sorted(ENCODER_ALIASES))
def test_lateral_channels(arch):
    assert lateral_channels(arch) == jax_lateral_channels(arch)


def test_encoder_lateral_shapes():
    enc = JEncoder("resnet18")
    x = _rgb((1, 64, 64, 3))
    variables = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = enc.apply(variables, jnp.asarray(x))
    state = depth_state_from_jax({k: {"encoder": v}
                                  for k, v in _np(variables).items()})
    port = LateralEncoder("resnet18").eval()
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()},
                         strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    assert [tuple(f.shape) for f in got] == [
        (1, 64, 16, 16), (1, 128, 8, 8), (1, 256, 4, 4), (1, 512, 2, 2)]
    for g, w in zip(got, want):
        assert _rel(_nhwc(g), w) <= REL


@pytest.mark.parametrize("kw", [dict(backbone="resnet18"),
                                dict(backbone="resnet50")],
                         ids=["resnet18", "resnet50"])
def test_depthnet_full_resolution_output(kw):
    variables, model = carried(kw, (64, 64))
    x = _rgb((2, 64, 64, 3))
    want = JNet(JConfig(**kw)).apply(variables, jnp.asarray(x))
    got = depth_forward(model, _nchw(x))
    assert tuple(got.shape) == (2, 1, 64, 64)
    assert _rel(_nhwc(got), want) <= REL


def test_depth_inference_positive():
    """RelDepthModel.inference: depth - min + 0.01 over the batch, so one
    image of a batch of 2 has its minimum at 0.01 and the other at or
    above it (multi_depth_model_woauxi.py:16-21)."""
    kw = dict(backbone="resnet18")
    variables, model = carried(kw)
    x = _rgb((2, 32, 32, 3))
    want = np.asarray(jax_inference(variables, JConfig(**kw),
                                    jnp.asarray(x)))
    got = depth_inference(model, _nchw(x))
    assert _rel(_nhwc(got), want) <= REL
    mins = got.amin(dim=(1, 2, 3)).numpy()
    assert float(mins.min()) == pytest.approx(0.01, abs=1e-6)
    assert float(mins.max()) >= 0.01 and not np.allclose(mins[0], mins[1])
    np.testing.assert_allclose(mins, want.min(axis=(1, 2, 3)), atol=1e-5)


@pytest.mark.parametrize("site", ["encoder", "decoder"])
def test_cimle_z_changes_output(site):
    """Both AdaIN sites: the port's logit for two latents against JAX's,
    and the latent moves it."""
    kw = dict(backbone="resnet18", d_latent=8, cimle_site=site)
    variables, model = carried(kw)
    x = normalize_rgb(torch.from_numpy(_rgb((1, 3, 32, 32))))
    xj = jnp.asarray(_nhwc(x))
    outs = []
    for z in (np.zeros((1, 8), np.float32), np.full((1, 8), 2.0, np.float32),
              _z(1, 8)):
        want = JNet(JConfig(**kw)).apply(variables, xj, z=jnp.asarray(z))
        got = depth_forward(model, x, torch.from_numpy(z))
        assert _rel(_nhwc(got), want) <= REL
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1])
    assert "adain_stats" in variables
    style = [n for n, _ in model.named_parameters() if "style" in n]
    root = "encoder_modules" if site == "encoder" else "decoder_modules"
    assert style and all(n.startswith(root) for n in style)


def test_adain_mean_var_shifts_applied():
    kw = dict(backbone="resnet18", d_latent=8)
    variables, model = carried(kw)
    rgb = np.ones((1, 32, 32, 3), np.float32)
    z = np.zeros((1, 8), np.float32)
    base = depth_forward(model, _nchw(rgb), torch.from_numpy(z))
    flat = flax.traverse_util.flatten_dict(variables["adain_stats"])
    sites = sorted({k[:-1] for k in flat})
    rng = np.random.default_rng(3)
    means = [rng.normal(0, 0.5, flat[s + ("mean_shift",)].shape)
             for s in sites]
    vars_ = [rng.normal(0, 0.1, flat[s + ("var_shift",)].shape)
             for s in sites]
    shifted = jax_shifts(variables, means, vars_)
    want = JNet(JConfig(**kw)).apply(shifted, jnp.asarray(rgb),
                                     z=jnp.asarray(z))
    assert set_mean_var_shifts(model, means, vars_) is model
    got = depth_forward(model, _nchw(rgb), torch.from_numpy(z))
    assert _rel(_nhwc(got), want) <= REL
    assert not torch.allclose(base, got)
    with pytest.raises(ValueError):
        set_mean_var_shifts(model, means[:3], vars_[:3])


def test_get_adain_init_act():
    kw = dict(backbone="resnet18", d_latent=8)
    variables, model = carried(kw)
    x, z = _rgb((2, 32, 32, 3)), _z(2, 8)
    want = jax_acts(variables, JConfig(**kw), jnp.asarray(x), jnp.asarray(z))
    got = get_adain_init_act(model, _nchw(x), torch.from_numpy(z))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _rel(_nhwc(g), w) <= REL
    _, dmodel = carried(dict(kw, cimle_site="decoder"))
    assert get_adain_init_act(dmodel, _nchw(x), torch.from_numpy(z)) is None


def test_auxi_branch_shapes():
    kw = dict(backbone="resnet18", with_auxi=True)
    variables, model = carried(kw, (64, 64))
    x = _rgb((1, 64, 64, 3))
    want = JNet(JConfig(**kw)).apply(variables, jnp.asarray(x))
    got = depth_forward(model, _nchw(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (1, 1, 64, 64)
        assert _rel(_nhwc(g), w) <= REL
    # depth_inference takes the logit of (logit, auxi)
    d = depth_inference(model, _nchw(x))
    assert _rel(_nhwc(d), jax_inference(variables, JConfig(**kw),
                                        jnp.asarray(x))) <= REL


@pytest.mark.parametrize("hw,factor", [((5, 7), 2), ((3, 4), 4), ((1, 1), 2),
                                       ((2, 1), 2)])
def test_upsample_bilinear_matches_jax(hw, factor):
    x = np.random.default_rng(0).normal(size=(2,) + hw + (3,)).astype(
        np.float32)
    want = np.asarray(jdecoder.upsample_bilinear(jnp.asarray(x), factor))
    got = decoder.upsample_bilinear(_nchw(x), factor)
    assert tuple(got.shape) == (2, 3, hw[0] * factor, hw[1] * factor)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_style_mod_and_ata_match_jax():
    x = _rgb((2, 6, 5, 16))
    z = _z(2, 8)
    sm = jadain.StyleMod(16)
    v = sm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(z))
    port = adain.StyleMod(8, 16)
    k = np.asarray(v["params"]["lin"]["kernel"])
    port.lin.weight.data = torch.from_numpy(k.T.copy())
    port.lin.bias.data = torch.from_numpy(
        np.array(v["params"]["lin"]["bias"]))
    want = sm.apply(v, jnp.asarray(x), jnp.asarray(z))
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(z))
    assert _rel(_nhwc(got), want) <= 1e-6

    low, high = _rgb((2, 4, 4, 16), 5), _rgb((2, 4, 4, 16), 6)
    ata = jdecoder.ATA(16)
    v = ata.init(jax.random.PRNGKey(1), jnp.asarray(low), jnp.asarray(high))
    port = decoder.ATA(16)
    for i, name in ((0, "Dense_0"), (2, "Dense_1")):
        port.fc[i].weight.data = torch.from_numpy(
            np.asarray(v["params"][name]["kernel"]).T.copy())
        port.fc[i].bias.data = torch.from_numpy(
            np.array(v["params"][name]["bias"]))
    want = ata.apply(v, jnp.asarray(low), jnp.asarray(high))
    with torch.no_grad():
        got = port(_nchw(low), _nchw(high))
    assert _rel(_nhwc(got), want) <= 1e-6


def test_port_init_is_seeded_and_lecun_normal():
    """init_depth_model: one seed gives one model, kernels at flax's
    lecun-normal scale, zero biases, BatchNorm as flax starts it."""
    cfg = DepthModelConfig(backbone="resnet18", d_latent=8)
    a = init_depth_model(torch.Generator().manual_seed(5), cfg, "cpu")
    b = init_depth_model(torch.Generator().manual_seed(5), cfg, "cpu")
    c = init_depth_model(torch.Generator().manual_seed(6), cfg, "cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert not a.training and set(sa) == set(DepthNet(cfg).state_dict())
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder_modules.conv1.weight"],
                           sc["encoder_modules.conv1.weight"])
    w = sa["encoder_modules.layer2.0.conv1.weight"]       # fan_in 576
    assert float(w.std()) == pytest.approx(576 ** -0.5, rel=0.05)
    assert float(w.abs().max()) <= 2 * 576 ** -0.5 / .8796 + 1e-6
    assert float(sa["decoder_modules.conv1.bias"].abs().sum()) == 0
    assert torch.equal(sa["encoder_modules.bn1.running_var"], torch.ones(64))
    assert float(sa["encoder_modules.style_mod0.mean_shift"].abs().sum()) == 0
    out = depth_inference(a, torch.from_numpy(_rgb((1, 3, 32, 32))),
                          torch.from_numpy(_z(1, 8)))
    assert torch.isfinite(out).all()


def test_config_matches_jax(tmp_path, monkeypatch):
    """The config tree, merge_from_list and merge_from_file (PyYAML and
    the stdlib fallback) give JAX's values."""
    assert dataclasses.asdict(config.DepthCfg()) == dataclasses.asdict(
        jconfig.DepthCfg())
    opts = ["TRAIN.BASE_LR", "0.01", "MODEL.D_LATENT", "16",
            "DATASET.CROP_SIZE", "[384, 384]", "MODEL.FREEZE_BACKBONE",
            "true"]
    want = dataclasses.asdict(jconfig.merge_from_list(jconfig.DepthCfg(),
                                                      opts))
    assert dataclasses.asdict(config.merge_from_list(config.DepthCfg(),
                                                     opts)) == want
    path = tmp_path / "cfg.yaml"
    path.write_text("TRAIN:\n  BASE_LR: 0.01\n  LR_MILESTONES: [10, 20]\n"
                    "MODEL:\n  ENCODER: resnet50_stride32\n  D_LATENT: 16\n")
    want = dataclasses.asdict(jconfig.merge_from_file(jconfig.DepthCfg(),
                                                      str(path)))
    got = dataclasses.asdict(config.merge_from_file(config.DepthCfg(),
                                                    str(path)))
    assert got == want and got["model"]["d_latent"] == 16
    import builtins
    real_import = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("no PyYAML")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    assert dataclasses.asdict(config.merge_from_file(
        config.DepthCfg(), str(path))) == want
    with pytest.raises(KeyError):
        config.merge_from_list(config.DepthCfg(), ["TRAIN.NOPE", "1"])
