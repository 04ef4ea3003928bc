"""LeReS / cIMLE monocular depth, the inference half (port of
google_nerf_tpu/depth/):

  config      two-tier DATASET/MODEL/TRAIN config with yaml merge
  adain       EqualizedDense, StyleMod, AdaInMod (calibration shifts as
              buffers)
  backbones   ResNet-18/34/50/101/152 and ResNeXt101-32x8d lateral
              encoders, encoder-site AdaIN
  decoder     FTB / ATA / FFM / AO decoder, decoder-site AdaIN, AuxiNetV2
  model       DepthNet, init_depth_model, depth_inference, AdaIN
              calibration helpers
  weights     reference torch checkpoints (res101.pth) loaded by name
  metrics     absRel/squaRel/rms/silog/log10/delta/WHDR battery (numpy)
  pointcloud  depth -> PLY

JAX's flax variables and .npz checkpoints carry across with
google_nerf_tpu_torch/convert.py (depth_state_from_jax).  CLIs:
depth_test_torch.py, depth_eval_scannet_torch.py (repo root).
"""
