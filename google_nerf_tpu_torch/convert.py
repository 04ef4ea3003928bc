"""Carry NGP and depth-model weights from the JAX package into the port.

These functions take numpy data only, so nothing here imports JAX: a JAX
pytree is passed as nested dicts/lists of numpy arrays
(`jax.tree_util.tree_map(np.asarray, params)`), the bench state is the
npz file that bench.py writes, and a depth checkpoint is the npz that
JAX's save_pytree writes (read_depth_npz, depth_state_from_jax).
"""
from __future__ import annotations

import re

import numpy as np
import torch

from google_nerf_tpu_torch.models.ngp import NGPConfig


def _t(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def params_from_jax(tree, device="cuda"):
    """init_ngp / init_train_state params (numpy leaves) -> port params.

    Keys are kept: the encoder's table (hash_table (L, T, F),
    packed_table (L, T, 8F) or pair_table (P, T, 35F); none for the
    frequency encoder), sigma_mlp and rgb_mlp (lists of (din, dout)
    weights), and the optional pose refinement dR/dT."""
    known = {"hash_table", "packed_table", "pair_table", "sigma_mlp",
             "rgb_mlp", "dR", "dT"}
    if not {"sigma_mlp", "rgb_mlp"} <= set(tree) or set(tree) - known:
        raise ValueError(f"not an NGP params tree: keys {sorted(tree)}")
    return {k: ([_t(w, device) for w in v] if isinstance(v, (list, tuple))
                else _t(v, device)) for k, v in tree.items()}


def load_bench_state(path, cfg: NGPConfig = NGPConfig(encoder="packed"),
                     device="cuda"):
    """Read the bench.py state npz -> (params, occ).

    The file holds `occ` and the params' leaves `p0..pN` in
    jax.tree_util leaf order, i.e. dict keys sorted by name and list
    items in order:
        [dR, dT,]  packed_table,  rgb_mlp[0..rgb_layers],  sigma_mlp[0..1]
    (dR/dT exist only when the run refined poses): bench.py trains the
    packed encoder.  `cfg` gives the number of rgb layers."""
    with np.load(path) as z:
        n = len([k for k in z.files if k.startswith("p")
                 and k[1:].isdigit()])
        leaves = [z[f"p{i}"] for i in range(n)]
        occ = torch.as_tensor(z["occ"], device=device)
    n_rgb = cfg.rgb_layers + 1
    extra = n - (1 + n_rgb + 2)
    if extra not in (0, 2):
        raise ValueError(f"{path}: {n} param leaves do not fit the packed "
                         f"NGP layout with {n_rgb} rgb layers")
    tree = {}
    if extra:
        tree["dR"], tree["dT"] = leaves[0], leaves[1]
    rest = leaves[extra:]
    tree["packed_table"] = rest[0]
    tree["rgb_mlp"] = rest[1:1 + n_rgb]
    tree["sigma_mlp"] = rest[1 + n_rgb:]
    return params_from_jax(tree, device), occ


def train_state_from_jax(tree, cfg, device="cuda"):
    """A JAX train state's numpy leaves -> the port's train state.

    tree: dict with params (as params_from_jax takes them), density_grid,
    occ, occ_u8 and step; occ_u8 is block2's dict of blocks4 and super,
    the block marcher's rows (G^3, 16), or the int32 word grid (C, G, G,
    G) of the seg and dense layouts.
    The optax state is not carried: the port's optimizer starts with
    zero moments, as a fresh JAX state's does.  cfg: the port's
    TrainConfig."""
    from google_nerf_tpu_torch.train.system import (make_optimizer,
                                                    param_leaves)
    params = params_from_jax(tree["params"], device)
    for p in param_leaves(params).values():
        p.requires_grad_(True)
    state = dict(params=params, opt=make_optimizer(cfg, params))
    state["density_grid"] = _t(tree["density_grid"], device)
    state["occ"] = torch.as_tensor(np.asarray(tree["occ"], bool),
                                   device=device)
    state["occ_u8"] = _words(tree["occ_u8"], device)
    state["step"] = int(tree["step"])
    return state


def multiscene_states_from_jax(stacked, S: int, cfg, device="cuda"):
    """JAX's stack_states tree (numpy leaves with a leading scene axis of
    S: params, density_grid, occ, occ_u8, step) -> S port train states,
    scene s from row s of every leaf (unstack_states), each through
    train_state_from_jax (the optax state is not carried)."""
    def row(tree, s):
        if isinstance(tree, dict):
            return {k: row(v, s) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [row(v, s) for v in tree]
        a = np.asarray(tree)
        if a.shape[:1] != (S,):
            raise ValueError(f"a leaf of shape {a.shape} has no scene axis "
                             f"of {S}")
        return a[s]
    keys = ("params", "density_grid", "occ", "occ_u8", "step")
    return [train_state_from_jax({k: row(stacked[k], s) for k in keys}, cfg,
                                 device) for s in range(S)]


def _words(occ_u8, device):
    if isinstance(occ_u8, dict):
        return {k: _words(v, device) for k, v in occ_u8.items()}
    return torch.tensor(np.asarray(occ_u8, np.int32), device=device)


def train_state_to_numpy(state):
    """The port's train state -> numpy leaves in train_state_from_jax's
    layout (no optimizer state)."""
    def n(t):
        return t.detach().cpu().numpy()
    return dict(params={k: ([n(w) for w in v] if isinstance(v, list)
                            else n(v)) for k, v in state["params"].items()},
                density_grid=n(state["density_grid"]), occ=n(state["occ"]),
                occ_u8=({k: n(v) for k, v in state["occ_u8"].items()}
                        if isinstance(state["occ_u8"], dict)
                        else n(state["occ_u8"])),
                step=np.asarray(state["step"], np.int32))


# ------------------------------------------------------- the depth model

_DEPTH_ROOTS = {"encoder": "encoder_modules", "decoder": "decoder_modules",
                "auxi": "auxi_modules"}
_FTB_NAMES = {"conv1": "conv1", "branch_conv1": "conv_branch.1",
              "branch_bn": "conv_branch.2", "branch_conv2": "conv_branch.4"}
_AO_NAMES = {"conv1": "adapt_conv.0", "bn": "adapt_conv.1",
             "conv2": "adapt_conv.3"}
_DEPTH_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "mean": "running_mean", "var": "running_var",
                 "mean_shift": "mean_shift", "var_shift": "var_shift"}


def _depth_module(mods, n_convs):
    """A flax module path under encoder/decoder/auxi -> the port's module
    name (the reference's torch name)."""
    head, rest = mods[0], mods[1:]
    m = re.fullmatch(r"layer(\d)_(\d+)", head)
    if m:                                  # (ConvBN_n, Conv_0|BatchNorm_0)
        n, conv = int(rest[0].split("_")[1]), rest[1] == "Conv_0"
        sub = (f"downsample.{0 if conv else 1}" if n == n_convs
               else f"{'conv' if conv else 'bn'}{n + 1}")
        return f"layer{m.group(1)}.{m.group(2)}.{sub}"
    if head.startswith("style_mod"):
        return f"{head}.mlp.{2 * int(rest[0][3:])}" if rest else head
    if head.startswith("ffm"):
        return f"{head}.{rest[0]}.{_FTB_NAMES[rest[1]]}"
    if head in ("outconv", "out"):
        return f"{head}.{_AO_NAMES[rest[0]]}"
    if rest:                               # an FTB: conv, ftb32 ... ftb2
        return f"{head}.{_FTB_NAMES[rest[0]]}"
    return head                            # conv1, bn1


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _n_convs(params):
    """2 for a BasicBlock encoder (layer1_0's first conv is 3x3), 3 for a
    Bottleneck one (1x1)."""
    k = params["encoder"]["layer1_0"]["ConvBN_0"]["Conv_0"]["kernel"]
    return 3 if np.shape(k)[0] == 1 else 2


def depth_state_from_jax(variables, device="cpu"):
    """A flax DepthNet's variables ({params, batch_stats[, adain_stats]},
    numpy leaves) -> the port's DepthNet state dict.  Conv kernels go
    HWIO -> OIHW (a grouped conv's (kh, kw, in/g, out) -> (out, in/g, kh,
    kw)), dense kernels are transposed; BatchNorm's scale/bias and
    mean/var become weight/bias and running_mean/running_var.  Every
    BatchNorm also gets num_batches_tracked = 0, so the result loads
    with strict=True."""
    n_convs = _n_convs(variables["params"])
    state = {}
    for coll in ("params", "batch_stats", "adain_stats"):
        for path, v in _flat(variables.get(coll, {})).items():
            a = np.asarray(v, np.float32)
            if path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            name = (f"{_DEPTH_ROOTS[path[0]]}."
                    f"{_depth_module(path[1:-1], n_convs)}."
                    f"{_DEPTH_LEAVES[path[-1]]}")
            state[name] = torch.tensor(np.ascontiguousarray(a),
                                       device=device)
            if path[-1] == "var":
                state[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
                    torch.zeros((), dtype=torch.long, device=device)
    return state


def depth_n_convs(state) -> int:
    """2 for a BasicBlock encoder, 3 for a Bottleneck one, from a port
    DepthNet state dict (or its named parameters)."""
    return 3 if state["encoder_modules.layer1.0.conv1.weight"].shape[-1] \
        == 1 else 2


def depth_flax_path(key: str, ndim: int, n_convs: int):
    """A port DepthNet state_dict key (of a tensor with `ndim` axes) ->
    (collection, the flax path under it: the root module, the module
    path, the leaf), the inverse of depth_state_from_jax's names."""
    ftb = {v: k for k, v in _FTB_NAMES.items()}
    ao = {v: k for k, v in _AO_NAMES.items()}
    roots = {v: k for k, v in _DEPTH_ROOTS.items()}
    root, *mods, leaf = key.split(".")
    head, rest = mods[0], ".".join(mods[1:])
    if head.startswith("layer"):       # layerL.B.sub
        b, sub = mods[1], ".".join(mods[2:])
        if sub.startswith("downsample"):
            n, conv = n_convs, sub.endswith("0")
        else:
            n, conv = int(sub[-1]) - 1, sub.startswith("conv")
        path = (f"{head}_{b}", f"ConvBN_{n}",
                "Conv_0" if conv else "BatchNorm_0")
    elif head.startswith("style_mod"):
        path = (head,) + ((f"mlp{int(mods[2]) // 2}",) if rest else ())
    elif head.startswith("ffm"):
        path = (head, mods[1], ftb[".".join(mods[2:])])
    elif head in ("outconv", "out"):
        path = (head, ao[rest])
    elif rest:
        path = (head, ftb[rest])
    else:
        path = (head,)
    if leaf in ("running_mean", "running_var"):
        coll, fl = "batch_stats", leaf[len("running_"):]
    elif leaf in ("mean_shift", "var_shift"):
        coll, fl = "adain_stats", leaf
    elif leaf == "weight":
        coll, fl = "params", "scale" if ndim == 1 else "kernel"
    else:
        coll, fl = "params", leaf
    return coll, (roots[root],) + path + (fl,)


def depth_state_to_jax(state):
    """The inverse of depth_state_from_jax: a port DepthNet state dict ->
    flax variables as nested dicts of numpy arrays, copies of the tensors
    (num_batches_tracked dropped)."""
    n_convs = depth_n_convs(state)
    out = {}
    for key, t in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        a = t.detach().cpu().numpy().copy()
        coll, path = depth_flax_path(key, a.ndim, n_convs)
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 2:
            a = a.T
        node = out.setdefault(coll, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out


def read_depth_npz(path):
    """JAX's save_pytree .npz (keys '/'-joined flax paths, as
    google_nerf_tpu/utils/ckpt.py writes the depth CLIs' checkpoints) ->
    nested dicts of numpy arrays, read with numpy alone."""
    tree = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            node = tree
            *parts, leaf = key.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def save_depth_npz(path, state):
    """A port DepthNet state dict -> a .npz in JAX's save_pytree layout,
    which JAX's depth CLIs and read_depth_npz load."""
    flat = {"/".join(p): v
            for p, v in _flat(depth_state_to_jax(state)).items()}
    np.savez(path, **flat)


def _optax_traces(opt_state):
    """The momentum traces (merged over the parameter groups, nested
    dicts of numpy arrays) and the update count of a numpy copy of the
    optax state of JAX's make_depth_optimizer
    (jax.tree_util.tree_map(np.asarray, opt_state)), read by field name:
    TraceState.trace, ScaleByScheduleState.count."""
    traces, counts = {}, set()

    def merge(node, out):
        for k, v in node.items():
            if isinstance(v, dict):
                merge(v, out.setdefault(k, {}))
            elif isinstance(v, np.ndarray):      # not a MaskedNode
                out[k] = v

    def walk(x):
        if hasattr(x, "_fields"):                # a NamedTuple state
            for f in x._fields:
                v = getattr(x, f)
                if f == "trace":
                    merge(v, traces)
                elif f == "count":
                    counts.add(int(np.asarray(v)))
                else:
                    walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(opt_state)
    if not traces or len(counts) != 1:
        raise ValueError(f"not a depth optimizer state: traces "
                         f"{bool(traces)}, counts {sorted(counts)}")
    return traces, counts.pop()


def depth_train_state_from_jax(variables, opt_state, step, cfg,
                               device="cpu"):
    """A JAX depth trainer's state -> the port's DepthTrainState, so that
    a JAX run continues in the port.  variables: the flax DepthNet's
    {params, batch_stats[, adain_stats]}; opt_state: the optax state of
    JAX's make_depth_optimizer over those params; both as numpy trees
    (jax.tree_util.tree_map(np.asarray, ...)); step: JAX's
    DepthTrainState.step; cfg: the run's DepthCfg.  The model gets the
    variables, the optimizer each parameter's momentum trace and the
    update count."""
    from google_nerf_tpu_torch.depth.trainer import init_trainer
    state, _ = init_trainer(0, cfg, device)
    state.model.load_state_dict(depth_state_from_jax(variables, device))
    traces, count = _optax_traces(opt_state)
    by_name = depth_state_from_jax({"params": traces}, device)
    for name, p in state.model.named_parameters():
        state.optimizer.state[p]["trace"] = by_name[name]
    for group in state.optimizer.param_groups:
        group["count"] = count
    state.step = int(step)
    return state


def spvcnn_from_jax(tree, device="cpu"):
    """JAX's SPVCNN parameters (init_spvcnn or convert_spvcnn_state_dict;
    nested dicts and lists of numpy arrays) -> the port's, the same tree
    of float32 tensors (depth/spvcnn.py keeps JAX's layout: kernels (K,
    inc, outc), dense weights (out, in))."""
    if isinstance(tree, dict):
        return {k: spvcnn_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [spvcnn_from_jax(v, device) for v in tree]
    return _t(tree, device)


# flax module names of depth/voxelnet.py's VoxelNetRegressor -> the port's
_VOXEL_MODULES = {"VoxelConvBlock_0": "stem", "Dense_0": "fc1",
                  "Dense_1": "fc2"}
_VOXEL_BLOCK = {"VoxelConvBlock_0": "block", "Conv_0": "conv",
                "BatchNorm_0": "bn", "Conv_1": "down.0",
                "BatchNorm_1": "down.1"}
_VOXEL_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight",
                 "mean": "running_mean", "var": "running_var"}


def voxelnet_state_from_jax(variables, device="cpu"):
    """flax VoxelNetRegressor variables ({params, batch_stats}, numpy
    leaves) -> the port's VoxelNetRegressor state dict: Conv kernels
    (kd, kh, kw, in, out) -> (out, in, kd, kh, kw), Dense kernels
    transposed, BatchNorm scale/bias and mean/var -> weight/bias and
    running_mean/running_var, with num_batches_tracked = 0 so that the
    result loads with strict=True."""
    state = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flat(variables.get(coll, {})).items():
            a = np.asarray(v, np.float32)
            if path[-1] == "kernel":
                a = a.transpose(4, 3, 0, 1, 2) if a.ndim == 5 else a.T
            head, *mods = path[:-1]
            if head.startswith("VoxelResBlock_"):
                name = f"stages.{head.rsplit('_', 1)[1]}"
            else:
                name = _VOXEL_MODULES[head]
            key = ".".join([name] + [_VOXEL_BLOCK[m] for m in mods]
                           + [_VOXEL_LEAVES[path[-1]]])
            state[key] = torch.tensor(np.ascontiguousarray(a),
                                      device=device)
            if path[-1] == "var":
                state[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = \
                    torch.zeros((), dtype=torch.long, device=device)
    return state
