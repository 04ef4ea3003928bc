"""Dataset registry of the port (google_nerf_tpu/data/__init__.py's
names): the five on-disk formats and the procedural `synthetic` scene."""
from google_nerf_tpu_torch.data.base import BaseDataset
from google_nerf_tpu_torch.data.colmap import ColmapDataset
from google_nerf_tpu_torch.data.nerfpp import NeRFPPDataset
from google_nerf_tpu_torch.data.nsvf import NSVFDataset
from google_nerf_tpu_torch.data.rtmv import RTMVDataset
from google_nerf_tpu_torch.data.scannet import ScannetDataset
from google_nerf_tpu_torch.data.synthetic import SyntheticDataset

dataset_dict = {
    "nsvf": NSVFDataset,
    "colmap": ColmapDataset,
    "rtmv": RTMVDataset,
    "nerfpp": NeRFPPDataset,
    "scannet": ScannetDataset,
    "synthetic": SyntheticDataset,
}

__all__ = ["BaseDataset", "ColmapDataset", "NeRFPPDataset", "NSVFDataset",
           "RTMVDataset", "ScannetDataset", "SyntheticDataset",
           "dataset_dict"]
