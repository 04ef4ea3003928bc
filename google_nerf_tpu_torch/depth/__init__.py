"""LeReS / cIMLE monocular depth: the network and its cIMLE trainer (port
of google_nerf_tpu/depth/):

  config      two-tier DATASET/MODEL/TRAIN config with yaml merge
  adain       EqualizedDense, StyleMod, AdaInMod (calibration shifts as
              buffers)
  backbones   ResNet-18/34/50/101/152 and ResNeXt101-32x8d lateral
              encoders, encoder-site AdaIN, flax's train-mode BatchNorm
  decoder     FTB / ATA / FFM / AO decoder, decoder-site AdaIN, AuxiNetV2
  model       DepthNet, init_depth_model, depth_inference, AdaIN
              calibration helpers
  priors      frame_priors: a frame's hypotheses at the crop, one shift a
              minibatch, resized back (CUDA graphs of the forward on the
              card)
  weights     reference torch checkpoints (res101.pth) loaded by name
  metrics     absRel/squaRel/rms/silog/log10/delta/WHDR battery (numpy)
  pointcloud  depth -> PLY
  normals     surface normals from depth (the PWN losses')
  losses      ILNR, MSGIL, ranking, PWN edges and planes, depth_losses
  optim       warmup multistep schedule, DepthSGD (JAX's optax chain)
  data        annotation-JSON datasets and the interleaving sampler
  trainer     the argmin-z recache, the train step, train_depth,
              calibrate_adain
  spvcnn      the SPVCNN shape-refiner heads as a coordinate-list sparse
              executor, torchsparse state dicts, refine_shift/focal
  voxelnet    the dense 64^3 refiner (JAX's redesign)

JAX's flax variables, .npz checkpoints and trainer state carry across
with google_nerf_tpu_torch/convert.py (depth_state_from_jax,
depth_train_state_from_jax).  CLIs: depth_test_torch.py,
depth_eval_scannet_torch.py, depth_train_torch.py, depth_eval_torch.py
(repo root).
"""
