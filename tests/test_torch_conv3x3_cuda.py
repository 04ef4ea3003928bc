"""Card-only tests of the depth decoder's 3x3 kernels (csrc/conv3x3.cu
through ops/cuda/conv3x3.py).  This file imports no JAX, so it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_conv3x3_cuda.py

Without a card every test here skips.  Shapes: every distinct 3x3 of
the decoder at a minibatch of 5 and a 448^2 crop (1/32 with the split
over K, 1/16 to 1/4, the AO head's two at 1/2 with Cout 1 on its own
kernel) and two odd sides.  Bounds, against the float64 convolution of
the same float32 inputs on the CPU, for K = 9 Cin:
  * each output within K 2^-24 of the sum of its terms' magnitudes
    (|x| * |w| + |bias|): the worst case of a K-term f32 sum, so a miss
    is a wrong term, not rounding;
  * norm-relative within 4 sqrt(K) 2^-24: a sum's rounding errors of
    either sign grow as sqrt(K) times a term's ulp, a result as
    sqrt(K) terms (~1e-6 at K = 2,304).
"""
import pytest
import torch
from torch.nn import functional as F

from google_nerf_tpu_torch.ops.cuda.conv3x3 import conv3x3
from google_nerf_tpu_torch.utils import logging
from google_nerf_tpu_torch.utils.precision import exact_f32

U = 2.0 ** -24
SHAPES = {                        # (Cin, Cout, side) at a minibatch of 5
    "14_2048_512": (2048, 512, 14), "14_512_512": (512, 512, 14),
    "14_512_256": (512, 256, 14), "28_1024_256": (1024, 256, 28),
    "28_256_256": (256, 256, 28), "56_512_256": (512, 256, 56),
    "56_256_256": (256, 256, 56), "112_256_256": (256, 256, 112),
    "224_256_128": (256, 128, 224), "224_128_1": (128, 1, 224),
    "13_520_200": (520, 200, 13), "57_36_130": (36, 130, 57),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run there only")
    return torch.device("cuda")


def _inputs(cin, cout, side, seed, batch=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, cin, side, side), generator=g)
    w = torch.randn((cout, cin, 3, 3), generator=g) / (3 * cin ** 0.5)
    b = torch.randn((cout,), generator=g)
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_conv3x3_matches_the_float64_convolution(shape):
    dev = _card()
    cin, cout, side = SHAPES[shape]
    x, w, b = _inputs(cin, cout, side, seed=len(shape) + cin)
    got = conv3x3(x.to(dev), w.to(dev), b.to(dev)).cpu().double()
    x64, w64, b64 = x.double(), w.double(), b.double()
    want = F.conv2d(x64, w64, b64, padding=1)
    mag = F.conv2d(x64.abs(), w64.abs(), b64.abs(), padding=1)
    K = 9 * cin
    err = (got - want).abs()
    assert bool((err <= K * U * mag).all()), float((err / mag).max())
    rel = float((got - want).norm() / want.norm())
    assert rel <= 4 * K ** 0.5 * U, rel


@pytest.mark.cuda
def test_conv3x3_is_deterministic_and_counts():
    """Two calls of a split shape (1/32) and of an unsplit one give the
    same bits; `launches` counts the pack, the GEMM and the split's
    sum; under a profiler depth_conv3_macs counts the multiply-adds."""
    dev = _card()
    for cin, cout, side in ((2048, 512, 14), (256, 256, 112)):
        x, w, b = (t.to(dev) for t in _inputs(cin, cout, side, seed=5))
        before = conv3x3.launches
        a = conv3x3(x, w, b)
        assert conv3x3.launches - before == (3 if side == 14 else 2)
        assert torch.equal(a, conv3x3(x, w, b))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        was = logging.counters().get("depth_conv3_macs", 0)
        conv3x3(x, w, b)
        moved = logging.counters()["depth_conv3_macs"] - was
    assert moved == 5 * 112 * 112 * 256 * 256 * 9


@pytest.mark.cuda
def test_conv3x3_refuses_what_it_has_no_instance_for():
    dev = _card()
    x = torch.randn((1, 8, 6, 6), device=dev)
    w = torch.randn((4, 8, 3, 3), device=dev)
    with pytest.raises(TypeError):
        conv3x3(x.half(), w.half())
    with pytest.raises(ValueError):
        conv3x3(x, torch.randn((4, 8, 1, 1), device=dev))
    with pytest.raises(ValueError):
        conv3x3(x, w, stride=2)
    with pytest.raises(ValueError):
        conv3x3(x, w, padding=0)
    with pytest.raises(TypeError):
        conv3x3(x.transpose(2, 3), w)


def _decoder_and_features(dev):
    from google_nerf_tpu_torch.depth.decoder import Decoder
    dec = Decoder((256, 512, 1024, 2048)).eval()
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for m in dec.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 1.5, generator=g)
    dec = dec.to(dev)
    feats = [torch.randn((5, c, s, s), generator=g).to(dev)
             for c, s in ((256, 112), (512, 56), (1024, 28), (2048, 14))]
    return dec, feats


@pytest.mark.cuda
def test_decoder_capture_replays_the_eager_kernels_bit_for_bit():
    """The decoder at a 448^2 crop's laterals (every shape above but the
    odd ones), eager through the kernels, then captured in a CUDA graph
    and replayed twice: the same bits; the grad-recording call takes
    nn.Conv2d (cuDNN in f32, TF32 off) and lands within 1e-4."""
    dev = _card()
    dec, feats = _decoder_and_features(dev)
    with torch.no_grad():
        before = conv3x3.launches
        want = dec(feats)
        assert conv3x3.launches > before
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dec(feats)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = dec(feats)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    before = conv3x3.launches
    with exact_f32():
        lib = dec(feats)
    assert lib.requires_grad and conv3x3.launches == before
    rel = float((lib.detach() - want).norm() / want.norm())
    assert rel <= 1e-4, rel


@pytest.mark.cuda
def test_frame_priors_on_the_kernels_match_the_cudnn_path(monkeypatch):
    """depth/priors.frame_priors at the benchmark's cell (ResNeXt101-32x8d,
    encoder-site cIMLE at d_latent 32, 448^2, 10 hypotheses of a 480x640
    frame) with the decoder's 3x3s on the kernels, against the same
    frame with them on nn.Conv2d (cuDNN, f32, TF32 off): each
    hypothesis within 1e-5 norm-relative (the benchmark's `prior_rel`
    limit is 1e-4); the replayed counter tallies count the kernels'
    multiply-adds of each frame under a profiler."""
    from google_nerf_tpu_torch.depth import decoder, priors
    from google_nerf_tpu_torch.depth.model import (DepthModelConfig,
                                                   init_depth_model)
    dev = _card()
    cfg = DepthModelConfig(backbone="resnext101_32x8d", d_latent=32)
    model = init_depth_model(torch.Generator().manual_seed(4), cfg, dev)
    g = torch.Generator().manual_seed(5)
    rgb = torch.rand((480, 640, 3), generator=g).to(dev)
    z = torch.randn((10, 32), generator=g).to(dev)
    got = priors.frame_priors(model, rgb, z, 448, (480, 640))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        was = logging.counters().get("depth_conv3_macs", 0)
        again = priors.frame_priors(model, rgb, z, 448, (480, 640))
        macs = logging.counters()["depth_conv3_macs"] - was
    assert torch.equal(again, got)
    assert macs == 2 * _decoder_macs(5)
    monkeypatch.setattr(decoder.Conv3x3, "forward", torch.nn.Conv2d.forward)
    priors._GRAPHS.pop(model, None)
    want = priors.frame_priors(model, rgb, z, 448, (480, 640))
    for k in range(10):
        rel = float((got[k] - want[k]).norm() / want[k].norm())
        assert rel <= 1e-5, (k, rel)


def _decoder_macs(batch):
    """The decoder's 3x3 multiply-adds at a 448^2 crop."""
    def conv(side, cin, cout):
        return batch * side * side * cout * cin * 9

    def ftb(side, cin, cout):
        return conv(side, cin, cout) + 2 * conv(side, cout, cout)
    macs = ftb(14, 2048, 512) + conv(14, 512, 256)
    for side, cin in ((28, 1024), (56, 512), (112, 256)):
        macs += ftb(side, cin, 256) + ftb(side, 256, 256)
    return macs + conv(224, 256, 128) + conv(224, 128, 1)
