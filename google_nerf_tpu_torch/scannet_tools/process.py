"""ScanNet scene export and train/test split tools (port of
google_nerf_tpu/scannet_tools/process.py).

    python -m google_nerf_tpu_torch.scannet_tools.process scene \
        --filename scene0000_00.sens --output_path scans_processed/scene0000_00
    python -m google_nerf_tpu_torch.scannet_tools.process batch \
        --scans_root scans --output_root scans_processed
    python -m google_nerf_tpu_torch.scannet_tools.process split \
        --output_path scans_processed/scene0000_00 --test_step 8

The reference's `process_scannet/`:
  * process_scannet_single_scene.py:34-157 — decode a scene's .sens into
    rgb/ (jpg), depth/ (uint16 png), pose/ (txt), intrinsics txts at
    640x480 with a frame skip (default 10 single-scene, 20 batch)
  * prepare_scannet_data.py:34-156 — batch run over a scan directory
  * split_train_test.py:8-47 — every test_step-th frame is test; writes
    test_step_{N}/{train,test}.txt
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from google_nerf_tpu_torch.scannet_tools.sensor_data import SensorData


def process_scene(sens_path: str, output_path: str, *,
                  frame_skip: int = 10, image_size=(480, 640),
                  export_depth: bool = True):
    """Export one scene; image_size is (h, w) like the reference scripts."""
    os.makedirs(output_path, exist_ok=True)
    sd = SensorData(sens_path)
    try:
        if export_depth:
            sd.export_depth_images(os.path.join(output_path, "depth"),
                                   image_size, frame_skip)
        sd.export_color_images(os.path.join(output_path, "rgb"),
                               image_size, frame_skip)
        sd.export_poses(os.path.join(output_path, "pose"), frame_skip)
        sd.export_intrinsics(output_path)
    finally:
        sd.close()


def split_train_test(output_path: str, test_step: int = 8):
    """Every test_step-th exported frame becomes test."""
    all_ids = sorted(int(d[:-4])
                     for d in os.listdir(os.path.join(output_path, "rgb"))
                     if d.endswith(".jpg"))
    train_ids = [fid for i, fid in enumerate(all_ids) if i % test_step != 0]
    test_ids = [fid for i, fid in enumerate(all_ids) if i % test_step == 0]
    split_dir = os.path.join(output_path, f"test_step_{test_step}")
    os.makedirs(split_dir, exist_ok=True)
    for name, ids in (("train", train_ids), ("test", test_ids)):
        with open(os.path.join(split_dir, f"{name}.txt"), "w") as f:
            f.writelines(f"{i}\n" for i in ids)
    return train_ids, test_ids


def prepare_batch(scans_root: str, output_root: str, *, frame_skip: int = 20,
                  image_size=(480, 640), test_step: int = 8):
    """Batch run: export every scene under scans_root."""
    sens_files = sorted(glob.glob(
        os.path.join(scans_root, "*", "*.sens")))
    for sens in sens_files:
        scene = os.path.basename(os.path.dirname(sens))
        out = os.path.join(output_root, scene)
        print(f"processing {scene} ...")
        process_scene(sens, out, frame_skip=frame_skip,
                      image_size=image_size)
        split_train_test(out, test_step)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("scene", help="process one scene's .sens")
    ps.add_argument("--filename", required=True)
    ps.add_argument("--output_path", required=True)
    ps.add_argument("--frame_skip", type=int, default=10)
    ps.add_argument("--height", type=int, default=480)
    ps.add_argument("--width", type=int, default=640)
    ps.add_argument("--test_step", type=int, default=8)

    pb = sub.add_parser("batch", help="process all scenes under a root")
    pb.add_argument("--scans_root", required=True)
    pb.add_argument("--output_root", required=True)
    pb.add_argument("--frame_skip", type=int, default=20)
    pb.add_argument("--test_step", type=int, default=8)

    pt = sub.add_parser("split", help="(re)write the train/test split")
    pt.add_argument("--output_path", required=True)
    pt.add_argument("--test_step", type=int, default=8)

    args = p.parse_args(argv)
    if args.cmd == "scene":
        process_scene(args.filename, args.output_path,
                      frame_skip=args.frame_skip,
                      image_size=(args.height, args.width))
        split_train_test(args.output_path, args.test_step)
    elif args.cmd == "batch":
        prepare_batch(args.scans_root, args.output_root,
                      frame_skip=args.frame_skip, test_step=args.test_step)
    else:
        split_train_test(args.output_path, args.test_step)


if __name__ == "__main__":
    main()


# ---------------------------------------------------------------------------
# NYU40 label mapping (reference `process_scannet/util.py:34-45` +
# `map_label_image`, `prepare_scannet_data.py:59-70`) and the per-scene
# scale table (`process_scannet/scannet_scales.txt`).
# ---------------------------------------------------------------------------

SCANNET_SCENE_SCALES = {
    "scene0000_00": 4.6, "scene0000_01": 4.52, "scene0079_00": 6.31,
    "scene0134_00": 2.86, "scene0158_00": 2.61, "scene0316_00": 2.91,
    "scene0521_00": 2.76, "scene0553_00": 1.71, "scene0616_00": 2.97,
    "scene0653_00": 3.26,
}


def read_label_mapping(path: str, label_from: str = "raw_category",
                       label_to: str = "nyu40id"):
    """Parse the ScanNet `scannetv2-labels.combined.tsv` into a mapping.
    Integer-looking source labels are returned as ints."""
    import csv
    mapping = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    try:
        return {int(k): v for k, v in mapping.items()}
    except (ValueError, TypeError):
        return mapping


def map_label_image(image, mapping) -> "np.ndarray":
    """Vectorized label-id remap of a (H, W) int image (the reference loops
    over unique ids; here one lookup-table gather does all of them)."""
    image = np.asarray(image)
    max_id = max(int(image.max()), max(mapping, default=0))
    lut = np.zeros(max_id + 1, dtype=np.uint16)
    for k, v in mapping.items():
        if isinstance(k, int) and 0 <= k <= max_id:
            lut[k] = v
    return lut[image]


def scene_scale(scene_id: str, default: float = 1.0) -> float:
    """Per-scene normalisation scale (scannet_scales.txt)."""
    return SCANNET_SCENE_SCALES.get(scene_id, default)
