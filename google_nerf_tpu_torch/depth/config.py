"""Two-tier config system for the depth (LeReS) stack (port of
google_nerf_tpu/depth/config.py).

A typed config tree with the reference's DATASET / MODEL / TRAIN
sections and defaults (`Train/lib/configs/config.py:18-249`), plus
`merge_from_file` (yaml-style dict merge with type coercion; PyYAML when
it is installed, else a stdlib parser of the two-level
'SECTION:\\n  KEY: value' layout) and `merge_from_list` (KEY VALUE pair
overrides).  Pure Python: no torch.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DatasetCfg:
    # reference defaults: `config.py:28-58`
    crop_size: Tuple[int, int] = (448, 448)
    depth_min: float = 0.01
    depth_scale_factor: float = 10.0       # depth x10 normalisation
    focal_x: float = 256.0
    focal_y: float = 256.0
    rgb_pixel_means: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    rgb_pixel_vars: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    invalid_value: float = -1.0
    sky_value: float = 20.0


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    # `config.py:60-78`
    encoder: str = "resnext101_stride32x8d"
    init_type: str = "xavier"
    pretrained_weights: str = ""
    d_latent: int = 32
    cimle_version: str = "v2"
    freeze_backbone: bool = False


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    # `config.py:80-102`
    base_lr: float = 0.001
    scale_decoder_lr: float = 1.0
    mlp_lr: float = 0.001
    max_iter: int = 300000
    lr_milestones: Tuple[int, ...] = (120000, 200000)
    warmup_iters: int = 500
    batch_size: int = 4
    epochs: int = 50
    snapshot_iters: int = 6000
    val_step: int = 5000
    log_interval: int = 10
    loss_mode: str = "_ranking-edge_msgil-normal_meanstd-tanh_"
    loss_auxi_weight: float = 0.5
    # cIMLE (`Train/tools/train.py:139-251`)
    num_latent: int = 20                   # hypotheses per image at recache
    latent_minibatch: int = 5
    recache_epochs: int = 10               # re-select z every N epochs
    ckpt_epochs: int = 8


@dataclasses.dataclass(frozen=True)
class DepthCfg:
    dataset: DatasetCfg = DatasetCfg()
    model: ModelCfg = ModelCfg()
    train: TrainCfg = TrainCfg()


def _coerce(old: Any, new: Any) -> Any:
    """Type-coerced replacement (`config.py:158-249` semantics)."""
    if isinstance(old, tuple) and isinstance(new, (list, tuple)):
        return tuple(new)
    if isinstance(old, bool):
        if isinstance(new, str):
            return new.lower() in ("1", "true", "yes")
        return bool(new)
    if isinstance(old, (int, float)) and isinstance(new, str):
        return type(old)(ast.literal_eval(new))
    if old is not None and not isinstance(new, type(old)):
        try:
            return type(old)(new)
        except (TypeError, ValueError):
            pass
    return new


def merge_from_dict(cfg: DepthCfg, d: Dict[str, Any]) -> DepthCfg:
    """Merge a nested {section: {key: value}} dict; keys are
    case-insensitive (the reference cfg is upper-case)."""
    out = cfg
    for section, vals in d.items():
        s = section.lower()
        sub = getattr(out, s)
        updates = {}
        for k, v in vals.items():
            kk = k.lower()
            if not hasattr(sub, kk):
                raise KeyError(f"unknown config key {section}.{k}")
            updates[kk] = _coerce(getattr(sub, kk), v)
        out = dataclasses.replace(out, **{s: dataclasses.replace(
            sub, **updates)})
    return out


def merge_from_file(cfg: DepthCfg, path: str) -> DepthCfg:
    """yaml config merge (`merge_cfg_from_file`, `config.py:124-155`).
    Uses a minimal parser when PyYAML is absent."""
    try:
        import yaml
        with open(path) as f:
            d = yaml.safe_load(f)
    except ImportError:
        d = _parse_simple_yaml(path)
    return merge_from_dict(cfg, d or {})


def _parse_simple_yaml(path: str) -> Dict[str, Any]:
    """Two-level 'SECTION:\\n  KEY: value' parser (stdlib only)."""
    out: Dict[str, Any] = {}
    section: Optional[str] = None
    with open(path) as f:
        for line in f:
            if not line.strip() or line.strip().startswith("#"):
                continue
            if not line.startswith(" "):
                section = line.split(":")[0].strip()
                out[section] = {}
            else:
                k, v = line.strip().split(":", 1)
                v = v.strip()
                try:
                    v = ast.literal_eval(v)
                except (ValueError, SyntaxError):
                    pass
                out[section][k] = v
    return out


def merge_from_list(cfg: DepthCfg, opts: Sequence[str]) -> DepthCfg:
    """['TRAIN.BASE_LR', '0.01', ...] overrides
    (`merge_cfg_from_list`, `config.py` style)."""
    assert len(opts) % 2 == 0
    d: Dict[str, Dict[str, Any]] = {}
    for k, v in zip(opts[::2], opts[1::2]):
        section, key = k.split(".", 1)
        d.setdefault(section, {})[key] = v
    return merge_from_dict(cfg, d)
