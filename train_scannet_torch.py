"""ScanNet training CLI of the PyTorch port (the port's
train_scannet.py): train_torch.py with --dataset_name scannet forced,
the ScanNet dataset's flags (--test_skip, --rot_transpose, --scale_flip,
--raw_scan_rootdir) and depth-prior supervision (--depth_dir with
--depth_loss_w > 0); the test video at 5 fps.

    python train_scannet_torch.py --root_dir scans_processed/scene0000_00 \\
        --raw_scan_rootdir scans --depth_dir priors/scene0000_00 \\
        --depth_loss_w 0.1 --exp_name scene0000_00

Results land under results/scannet/<exp_name>, checkpoints under
ckpts/scannet/<exp_name>.  Runs on the CUDA card unless given
--platform cpu.
"""
from __future__ import annotations

import os
import sys

from google_nerf_tpu_torch.opt import get_opts
from train_torch import main, save_videos


def run(argv=None):
    hparams = get_opts(argv)
    hparams.dataset_name = 'scannet'
    logs = main(hparams, video_fps=5)
    if not hparams.no_save_test and not hparams.val_only:
        val_dir = os.path.abspath(f'results/scannet/{hparams.exp_name}')
        save_videos(val_dir, fps=5)
    return logs


if __name__ == '__main__':
    run(sys.argv[1:])
