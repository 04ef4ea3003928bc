"""Depth checkpoints in the port against JAX's converter, on the CPU:

  * a reference torch checkpoint (.pth): a torch-named state dict built
    from JAX's resnet50 init tree by the inverse of JAX's naming (as
    tests/test_depth_model.py's conversion test builds one), with random
    values, plus keys JAX's converter skips (style-mod MLPs inside and
    outside the blocks, num_batches_tracked, the auxi branch, a key
    outside the model, a decoder field it does not map) and a `module.`
    prefix on some keys.  torch.save'd, then read by JAX's
    load_torch_checkpoint + convert_torch_state_dict + merge_converted
    and by the port's load_reference_checkpoint: the same skipped keys
    in the same order, the same tensors, equal forwards (norm-relative
    1e-5, seen ~1e-6);
  * JAX's save_pytree .npz (plain and cIMLE): read by
    convert.read_depth_npz into the port (forwards norm-relative 1e-5),
    and the port's save_depth_npz read back by JAX's load_pytree equal
    to the tree JAX wrote, leaf for leaf;
  * the port's depth CLIs' --load_ckpt on both file kinds."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from google_nerf_tpu.depth.model import DepthModelConfig as JConfig
from google_nerf_tpu.depth.model import DepthNet as JNet
from google_nerf_tpu.depth.model import init_depth_model as jax_init
from google_nerf_tpu.depth.weights import (convert_torch_state_dict,
                                           load_torch_checkpoint,
                                           merge_converted)
from google_nerf_tpu.utils.ckpt import load_pytree, save_pytree
from google_nerf_tpu_torch.convert import (depth_state_from_jax,
                                           depth_state_to_jax,
                                           read_depth_npz, save_depth_npz)
from google_nerf_tpu_torch.depth.model import (DepthModelConfig, DepthNet,
                                               depth_forward,
                                               init_depth_model)
from google_nerf_tpu_torch.depth.weights import (load_checkpoint,
                                                 load_reference_checkpoint)

_FTB_INV = {"conv1": "conv1", "branch_conv1": "conv_branch.1",
            "branch_bn": "conv_branch.2", "branch_conv2": "conv_branch.4"}
_AO_INV = {"conv1": "adapt_conv.0", "bn": "adapt_conv.1",
           "conv2": "adapt_conv.3"}


def _torch_name(path):
    """A flax module path of a Bottleneck DepthNet -> its reference torch
    name (the inverse of JAX's weights.py naming)."""
    root, rest = path[0], path[1:]
    if root == "encoder":
        if rest[0] in ("conv1", "bn1"):
            return f"encoder_modules.{rest[0]}"
        stage, blk = rest[0].replace("layer", "").split("_")
        n = int(rest[1].split("_")[1])
        conv = rest[2] == "Conv_0"
        mod = (("downsample.0" if conv else "downsample.1") if n == 3
               else (f"conv{n + 1}" if conv else f"bn{n + 1}"))
        return f"encoder_modules.layer{stage}.{blk}.{mod}"
    if rest[0] == "conv1":
        return "decoder_modules.conv1"
    if rest[0] == "conv":
        return f"decoder_modules.conv.{_FTB_INV[rest[1]]}"
    if rest[0] in ("ffm0", "ffm1", "ffm2"):
        return f"decoder_modules.{rest[0]}.{rest[1]}.{_FTB_INV[rest[2]]}"
    return f"decoder_modules.outconv.{_AO_INV[rest[1]]}"


def _reference_state(variables):
    rng = np.random.default_rng(0)
    state = {}
    flat = flax.traverse_util.flatten_dict(variables["params"])
    for path, v in flat.items():
        name = _torch_name(path[:-1])
        if path[-1] == "kernel":
            state[name + ".weight"] = (0.05 * rng.normal(size=(
                v.shape[3], v.shape[2], v.shape[0], v.shape[1])))
        elif path[-1] == "bias":
            state[name + ".bias"] = rng.normal(size=v.shape)
        else:
            state[name + ".weight"] = 0.1 * np.abs(
                rng.normal(size=v.shape)) + 0.5
    for path, v in flax.traverse_util.flatten_dict(
            variables["batch_stats"]).items():
        name = _torch_name(path[:-1])
        val = rng.normal(size=v.shape)
        if path[-1] == "var":
            val = np.abs(val) + 0.1
            state[name + ".num_batches_tracked"] = np.array(7)
        state[name + "." + {"mean": "running_mean",
                            "var": "running_var"}[path[-1]]] = val
    extra = {
        "encoder_modules.layer1.0.style_mod0.mlp.0.weight": (512, 8),
        "encoder_modules.style_mod1.mlp.6.bias": (512,),
        "decoder_modules.style_mod3.mlp.2.weight": (256, 512),
        "decoder_modules.conv.conv_branch.3.weight": (4,),
        "auxi_modules.ftb32.conv1.weight": (256, 512, 3, 3),
        "auxi_modules.out.adapt_conv.1.running_mean": (128,),
        "sample_count": (1,),
    }
    for k, shape in extra.items():
        state[k] = rng.normal(size=shape)
    out = {}
    for i, (k, v) in enumerate(state.items()):
        key = ("module." + k) if i % 5 == 0 else k
        out[key] = torch.as_tensor(np.asarray(v)).to(
            torch.long if k.endswith("num_batches_tracked") else torch.float32)
    return out


@pytest.fixture(scope="module")
def resnet50():
    kw = dict(backbone="resnet50")
    return kw, jax_init(jax.random.PRNGKey(0), JConfig(**kw), (32, 32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _forwards(kw, variables, model, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    z = (rng.normal(size=(1, kw["d_latent"])).astype(np.float32)
         if kw.get("d_latent") else None)
    want = JNet(JConfig(**kw)).apply(
        variables, jnp.asarray(x), z=None if z is None else jnp.asarray(z))
    got = depth_forward(model, torch.from_numpy(x.transpose(0, 3, 1, 2)),
                        None if z is None else torch.from_numpy(z))
    if kw.get("with_auxi"):
        return ([g.numpy().transpose(0, 2, 3, 1) for g in got],
                [np.asarray(w) for w in want])
    return got.numpy().transpose(0, 2, 3, 1), np.asarray(want)


def test_reference_pth_loads_as_jax_converts_it(resnet50, tmp_path):
    kw, variables = resnet50
    path = str(tmp_path / "res50.pth")
    torch.save({"depth_model": _reference_state(variables), "epoch": 3},
               path)

    converted, jax_skipped = convert_torch_state_dict(
        load_torch_checkpoint(path))
    merged = merge_converted(variables, converted)
    model = init_depth_model(torch.Generator().manual_seed(9),
                             DepthModelConfig(**kw), "cpu")
    skipped, unused = load_reference_checkpoint(model, path)
    assert skipped == jax_skipped and unused == []
    assert len(skipped) > 60 and all(
        "num_batches_tracked" in k or "style_mod" in k or "auxi" in k
        or k in ("sample_count", "decoder_modules.conv.conv_branch.3.weight")
        for k in skipped)

    want = depth_state_from_jax(jax.tree_util.tree_map(np.asarray, merged))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
    g, w = _forwards(kw, merged, model)
    assert _rel(g, w) <= 1e-5


def test_reference_shape_mismatch_raises(tmp_path):
    model = DepthNet(DepthModelConfig(backbone="resnet18"))
    path = str(tmp_path / "bad.pth")
    torch.save({"encoder_modules.conv1.weight": torch.zeros(64, 3, 3, 3),
                "encoder_modules.conv1.bias": torch.zeros(64)}, path)
    with pytest.raises(ValueError, match="shape"):
        load_reference_checkpoint(model, path)
    torch.save({"encoder_modules.conv1.bias": torch.zeros(64)}, path)
    # JAX takes an encoder conv's bias and its merge drops it: so does
    # the port, and says so
    assert load_reference_checkpoint(model, path) == (
        [], ["encoder_modules.conv1.bias"])


@pytest.mark.parametrize("kw", [dict(backbone="resnet50"),
                                dict(backbone="resnet18", d_latent=8),
                                dict(backbone="resnet18", d_latent=8,
                                     cimle_site="decoder", with_auxi=True)],
                         ids=["resnet50", "cimle", "decoder_auxi"])
def test_jax_npz_carries_across(kw, tmp_path):
    variables = jax_init(jax.random.PRNGKey(2), JConfig(**kw), (64, 64))
    tree = jax.tree_util.tree_map(np.asarray, variables)
    jpath = str(tmp_path / "jax.npz")
    save_pytree(jpath, tree)
    model = DepthNet(DepthModelConfig(**kw)).eval()
    model.load_state_dict(depth_state_from_jax(read_depth_npz(jpath)),
                          strict=True)
    out = _forwards(kw, variables, model)
    if kw.get("with_auxi"):
        for g, w in zip(*out):
            assert _rel(g, w) <= 1e-5
    else:
        assert _rel(*out) <= 1e-5

    tpath = str(tmp_path / "port.npz")
    save_depth_npz(tpath, model.state_dict())
    back = flax.traverse_util.flatten_dict(load_pytree(tpath))
    want = flax.traverse_util.flatten_dict(tree)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))
    again = depth_state_to_jax(model.state_dict())
    assert set(flax.traverse_util.flatten_dict(again)) == set(want)


def test_cli_load_checkpoint_takes_both_kinds(resnet50, tmp_path):
    kw, variables = resnet50
    cfg = DepthModelConfig(**kw)
    npz = str(tmp_path / "m.npz")
    save_pytree(npz, jax.tree_util.tree_map(np.asarray, variables))
    a = init_depth_model(torch.Generator().manual_seed(1), cfg, "cpu")
    assert "npz" in load_checkpoint(a, npz)
    pth = str(tmp_path / "m.pth")
    torch.save({"model_state_dict": {
        "module.encoder_modules." + k: v for k, v in
        a.encoder_modules.state_dict().items()}}, pth)
    b = init_depth_model(torch.Generator().manual_seed(2), cfg, "cpu")
    line = load_checkpoint(b, pth)
    assert "53 keys skipped" in line, line      # num_batches_tracked
    for k, v in a.encoder_modules.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(b.encoder_modules.state_dict()[k], v), k
