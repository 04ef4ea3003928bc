"""PyTorch/CUDA port of google_nerf_tpu.

Module paths and function names mirror the JAX package, so each
counterpart is easy to find (`google_nerf_tpu/models/baked.py` ->
`google_nerf_tpu_torch/models/baked.py`).  The port imports torch and
numpy only, never jax and nothing of the JAX package.  Its entry points
run on the CUDA device unless the caller passes `device="cpu"`.
"""
