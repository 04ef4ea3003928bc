"""Checkpoints (port of google_nerf_tpu/utils/ckpt.py).

A checkpoint is a directory holding one `torch.save` file, state.pt: the
train state's tensors (params, density_grid, occ, occ_u8), its step and
the optimizer's state_dict() under "opt".  It is read back with
`weights_only=True`, so loading runs no pickled code.

  * full checkpoint: the whole train state, resume-capable;
  * slim checkpoint: params (without the pose refinement dR/dT unless
    save_poses), occ and step, the deployable artifact;
  * load_ckpt_filtered: a prefix-filtered partial load on the same
    '/'-joined, key-sorted leaf paths as JAX's.

The port cannot read JAX's orbax directories; a JAX checkpoint crosses
through convert.train_state_from_jax on the caller's side.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

_FILE = "state.pt"


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, torch.optim.Optimizer):
        return tree.state_dict()
    return tree


def save_ckpt(path: str, state: Dict[str, Any]):
    """Save a train state (or any nested dict of tensors, lists, numbers
    and an optimizer) to the directory `path`."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{_FILE}.tmp{os.getpid()}")
    torch.save(_detached(state), tmp)
    os.replace(tmp, os.path.join(path, _FILE))


def _read(path: str):
    return torch.load(os.path.join(os.path.abspath(path), _FILE),
                      map_location="cpu", weights_only=True)


def load_ckpt(path: str, target: Dict[str, Any] = None):
    """Load a checkpoint saved by save_ckpt.  Without target: the saved
    tree, on the CPU.  With target (a train state of the same layout):
    every leaf of the target is set from the checkpoint, tensors copied
    in place (so the target's optimizer keeps pointing at its params),
    and the target is returned."""
    tree = _read(path)
    if target is None:
        return tree
    return _restore(tree, target, lambda key: True, strict=True)


def slim_state(state: Dict[str, Any], save_poses: bool = False):
    """Params, occ and step: what rendering needs."""
    params = dict(state["params"])
    if not save_poses:
        params.pop("dR", None)
        params.pop("dT", None)
    return dict(params=params, occ=state["occ"], step=state["step"])


def save_slim_ckpt(path: str, state: Dict[str, Any],
                   save_poses: bool = False):
    save_ckpt(path, slim_state(state, save_poses))


def save_pytree(path: str, tree) -> None:
    """A nested dict of tensors or arrays -> one .npz whose keys are the
    '/'-joined paths."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (str(k),))
        else:
            flat["/".join(prefix)] = (node.detach().cpu().numpy()
                                      if isinstance(node, torch.Tensor)
                                      else np.asarray(node))

    walk(tree, ())
    np.savez(path, **flat)


def load_pytree(path: str):
    """Inverse of save_pytree: a nested dict of CPU tensors."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(data[key])
    return tree


def _flatten_paths(tree, prefix=()):
    """{'/'-joined path: leaf} with dict keys sorted (JAX's leaf order);
    an optimizer is one leaf."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_paths(tree[k], prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_paths(v, prefix + (str(i),)))
    else:
        out["/".join(prefix)] = tree
    return out


def _set_path(tree, key: str, value):
    *parents, last = key.split("/")
    node = tree
    for p in parents:
        node = node[int(p)] if isinstance(node, list) else node[p]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def _restore(tree, target, want, strict: bool):
    """Set target's wanted leaves from the saved tree, in place: a tensor
    of the same shape is copied into the target's tensor, any other leaf
    replaced; an optimizer loads the saved state_dict.  A shape mismatch
    keeps the target's value (strict: raises)."""
    opt_state = tree.pop("opt", None) if isinstance(tree, dict) else None
    src = _flatten_paths(tree)
    for key, tv in _flatten_paths(target).items():
        if not want(key):
            continue
        if isinstance(tv, torch.optim.Optimizer):
            if opt_state is not None:
                tv.load_state_dict(opt_state)
            elif strict:
                raise KeyError(f"checkpoint has no {key}")
            continue
        if key not in src:
            if strict:
                raise KeyError(f"checkpoint has no {key}")
            continue
        sv = src[key]
        if isinstance(tv, torch.Tensor):
            sv = torch.as_tensor(sv)
            if tuple(sv.shape) != tuple(tv.shape):
                if strict:
                    raise ValueError(f"{key}: checkpoint shape "
                                     f"{tuple(sv.shape)}, target "
                                     f"{tuple(tv.shape)}")
                continue                   # shape mismatch: keep target
            with torch.no_grad():
                tv.copy_(sv)
        else:
            _set_path(target, key, sv)
    return target


def load_ckpt_filtered(path: str, target: Dict[str, Any],
                       include_prefixes=("params",),
                       exclude_prefixes=()) -> Dict[str, Any]:
    """Prefix-filtered partial load: restore only the target's leaves
    whose '/'-joined path starts with one of include_prefixes (and none
    of exclude_prefixes); the others keep the target's values, as do
    leaves the checkpoint lacks or holds at another shape.  The target is
    updated in place and returned.

    Unlike JAX's, which returns the target untouched when it cannot read
    the checkpoint, this raises (a missing or unreadable file)."""
    def want(key: str) -> bool:
        return (any(key.startswith(p) for p in include_prefixes)
                and not any(key.startswith(p) for p in exclude_prefixes))

    return _restore(_read(path), target, want, strict=False)
