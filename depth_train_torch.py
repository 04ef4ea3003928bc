"""cIMLE depth-model training CLI of the PyTorch port (the port's
depth_train.py; the reference's `AdelaiDepth/LeReS/Train/tools/train.py`
and its v2..v6 variants, picked by --cimle_version): annotation-JSON
datasets, the argmin-z recache every 10 epochs, SGD with the warmup
multistep schedule, a checkpoint every 8 epochs.

    python depth_train_torch.py --dataroot datasets --dataset_list demo \\
        --epoch 2 --batchsize 2

Writes <out_dir>/epoch{N}.npz and final.npz in JAX's save_pytree layout
(convert.save_depth_npz), which depth_test.py, depth_eval.py and the
port's depth CLIs load, and the resumable checkpoint
<out_dir>/resume_epoch{N} (model, optimizer, step, epoch) in the port's
own format (utils/ckpt.save_ckpt); --resume takes that directory (JAX's
orbax checkpoints do not load here).  Runs on the CUDA card unless given
--platform cpu.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from depth_test_torch import device_of
from google_nerf_tpu_torch.convert import save_depth_npz
from google_nerf_tpu_torch.depth.config import (DepthCfg, merge_from_file,
                                                merge_from_list)
from google_nerf_tpu_torch.depth.data import (DepthAnnotationDataset,
                                              MultiDatasetSampler)
from google_nerf_tpu_torch.depth.trainer import train_depth
from google_nerf_tpu_torch.utils.ckpt import load_ckpt, save_ckpt

BACKBONES = {"resnet50": "resnet50", "resnet18": "resnet18",
             "resnext101": "resnext101_32x8d"}


def get_args(argv=None):
    p = argparse.ArgumentParser(description="LeReS cIMLE training "
                                "(PyTorch port)")
    # mirrors Train/tools/parse_arg_base.py, as depth_train.py
    p.add_argument("--dataroot", default="datasets")
    p.add_argument("--dataset_list", nargs="+", required=True)
    p.add_argument("--batchsize", type=int, default=2)
    p.add_argument("--epoch", type=int, default=50)
    p.add_argument("--base_lr", type=float, default=0.001)
    p.add_argument("--mlp_lr", type=float, default=0.001)
    p.add_argument("--d_latent", type=int, default=32)
    p.add_argument("--cimle_version", default="v2",
                   help="v2=encoder AdaIN; v3..v6=decoder AdaIN")
    p.add_argument("--backbone", default="resnext101",
                   choices=list(BACKBONES))
    p.add_argument("--loss_mode",
                   default="_ranking-edge_msgil-normal_meanstd-tanh_")
    p.add_argument("--crop_size", type=int, default=448)
    p.add_argument("--out_dir", default="ckpts/depth")
    p.add_argument("--cfg_file", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default=None,
                   help="a resume_epoch{N} directory of a previous run "
                        "(restores the model, optimizer, step and epoch)")
    p.add_argument("--options", nargs="*", default=[],
                   help="KEY VALUE config overrides (TRAIN.BASE_LR 0.01)")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"])
    return p.parse_args(argv)


def build_cfg(args) -> DepthCfg:
    cfg = DepthCfg()
    cfg = dataclasses.replace(
        cfg,
        dataset=dataclasses.replace(cfg.dataset,
                                    crop_size=(args.crop_size,
                                               args.crop_size)),
        model=dataclasses.replace(cfg.model,
                                  encoder=BACKBONES[args.backbone],
                                  d_latent=args.d_latent,
                                  cimle_version=args.cimle_version),
        train=dataclasses.replace(cfg.train, base_lr=args.base_lr,
                                  mlp_lr=args.mlp_lr,
                                  batch_size=args.batchsize,
                                  epochs=args.epoch,
                                  loss_mode=args.loss_mode))
    if args.cfg_file:
        cfg = merge_from_file(cfg, args.cfg_file)
    if args.options:
        cfg = merge_from_list(cfg, args.options)
    return cfg


def main(argv=None):
    """Run the CLI; returns dict(state, history (train_depth's: a dict
    per recache and per step), seconds)."""
    args = get_args(argv)
    device = device_of(args.platform)
    cfg = build_cfg(args)
    datasets = [DepthAnnotationDataset(args.dataroot, name, cfg=cfg.dataset)
                for name in args.dataset_list]
    sampler = MultiDatasetSampler(datasets, seed=args.seed)
    print(f"{len(datasets)} datasets, {len(sampler)} samples/epoch")
    os.makedirs(args.out_dir, exist_ok=True)

    def ckpt_fn(state, epoch):
        path = os.path.join(args.out_dir, f"epoch{epoch + 1}.npz")
        save_depth_npz(path, state.model.state_dict())
        save_ckpt(os.path.join(args.out_dir, f"resume_epoch{epoch + 1}"),
                  dict(model=state.model.state_dict(), opt=state.optimizer,
                       step=state.step, epoch=epoch + 1))
        print(f"saved {path}")

    resume = None
    if args.resume:
        resume = load_ckpt(args.resume)
        print(f"resumed from {args.resume} (epoch {int(resume['epoch'])})")

    history = []
    t0 = time.time()
    state = train_depth(args.seed, cfg, sampler, ckpt_fn=ckpt_fn,
                        resume=resume, device=device, history=history)
    seconds = time.time() - t0
    final = os.path.join(args.out_dir, "final.npz")
    save_depth_npz(final, state.model.state_dict())
    print(f"saved {final}")
    return dict(state=state, history=history, seconds=seconds)


if __name__ == "__main__":
    main(sys.argv[1:])
