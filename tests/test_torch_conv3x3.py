"""The depth decoder's 3x3 convolution on the CPU: the plain version
(ops/conv3x3.py) and the wrapper (ops/cuda/conv3x3.py), which runs it
for CPU tensors, against F.conv2d at every decoder shape with the sides
cut small (bit for bit: the plain version is that call); what both
refuse; the launch plan of the card's kernels; the decoder's routing
(a call that records a gradient takes nn.Conv2d, any other the
wrapper); and the counters of a captured forward: count() tallies into
the capture's open piece and depth/priors.replay counts each piece's
tally again under a profiler.  The kernels themselves run in
tests/test_torch_conv3x3_cuda.py on a card.
"""
import pytest
import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import ProfilerActivity, profile

from google_nerf_tpu_torch.depth import decoder, priors
from google_nerf_tpu_torch.ops.conv3x3 import conv3x3_plain
from google_nerf_tpu_torch.ops.cuda import conv3x3 as cv
from google_nerf_tpu_torch.utils import logging

# (Cin, Cout) of the decoder's 3x3s at 448^2 (1/32 to 1/2), sides cut
SHAPES = {"1_32_in": (2048, 512, 2), "1_32_mid": (512, 512, 2),
          "1_32_out": (512, 256, 3), "1_16_in": (1024, 256, 3),
          "1_16_mid": (256, 256, 4), "1_8_in": (512, 256, 5),
          "1_4_mid": (256, 256, 7), "ao_in": (256, 128, 8),
          "ao_out": (128, 1, 9), "odd": (5, 3, 1)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(cin, cout, side, seed=0, batch=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, cin, side, side), generator=g),
            torch.randn((cout, cin, 3, 3), generator=g),
            torch.randn((cout,), generator=g))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_version_is_the_padded_convolution(shape):
    cin, cout, side = SHAPES[shape]
    x, w, b = _inputs(cin, cout, side)
    want = F.conv2d(x, w, b, padding=1)
    assert torch.equal(conv3x3_plain(x, w, b), want)
    assert torch.equal(cv.conv3x3(x, w, b), want)
    assert torch.equal(cv.conv3x3(x, w), F.conv2d(x, w, padding=1))


def _refusals():
    x, w, b = _inputs(4, 3, 5)
    return {
        "float64": ((x.double(), w.double(), b.double()), {}, TypeError),
        "float16": ((x.half(), w.half(), b.half()), {}, TypeError),
        "bias float64": ((x, w, b.double()), {}, TypeError),
        "1x1": ((x, w[:, :, :1, :1].contiguous(), b), {}, ValueError),
        "5x5": ((x, torch.randn(3, 4, 5, 5), b), {}, ValueError),
        "cin": ((x, torch.randn(3, 5, 3, 3), b), {}, ValueError),
        "bias shape": ((x, w, b[:2]), {}, ValueError),
        "3d x": ((x[0], w, b), {}, ValueError),
        "stride 2": ((x, w, b), dict(stride=2), ValueError),
        "stride (1, 2)": ((x, w, b), dict(stride=(1, 2)), ValueError),
        "padding 0": ((x, w, b), dict(padding=0), ValueError),
        "padding 2": ((x, w, b), dict(padding=(2, 2)), ValueError),
        "x not contiguous": ((x.transpose(2, 3), w, b), {}, TypeError),
        "channels_last x": ((x.contiguous(memory_format=torch.channels_last),
                             w, b), {}, TypeError),
        "w not contiguous": ((x, w.transpose(2, 3), b), {}, TypeError),
    }


@pytest.mark.parametrize("case", list(_refusals()))
@pytest.mark.parametrize("fn", [conv3x3_plain, cv.conv3x3],
                         ids=["plain", "wrapper"])
def test_both_refuse_what_the_kernels_take_not(case, fn):
    args, kw, err = _refusals()[case]
    with pytest.raises(err):
        fn(*args, **kw)


def test_stride_and_padding_of_one_pass_as_ints_or_pairs():
    x, w, b = _inputs(4, 3, 5)
    want = F.conv2d(x, w, b, padding=1)
    assert torch.equal(cv.conv3x3(x, w, b, (1, 1), (1, 1)), want)
    assert torch.equal(cv.conv3x3(x, w, b, 1, 1), want)


def test_plan_fills_the_card_and_covers_k():
    """The split over K: the 1/32 and 1/16 maps of a minibatch of 5 split
    until about two blocks an SM, the larger ones not at all; the
    splits' K steps cover every step once; Cp and Np are the kernels'
    multiples."""
    sms = 132
    want = {(2048, 512, 14): 8, (512, 512, 14): 8, (512, 256, 14): 16,
            (1024, 256, 28): 4, (256, 256, 28): 4, (512, 256, 56): 1,
            (256, 256, 112): 1, (256, 128, 224): 1}
    for (cin, cout, side), splits in want.items():
        p = cv.plan(5, cin, side, side, cout, sms)
        steps = 9 * -(-cin // cv.BK)
        assert p["splits"] == splits, (cin, cout, side, p)
        assert (p["splits"] - 1) * p["per_split"] < steps \
            <= p["splits"] * p["per_split"]
        assert p["per_split"] >= min(steps, cv.MIN_STEPS)
        tiles = -(-5 * side * side // cv.BM) * -(-cout // cv.BN)
        assert tiles * p["splits"] <= 2 * sms or p["splits"] == 1
        assert p["Cp"] % 32 == 0 and p["Cp"] >= cin
        assert p["Np"] % cv.BN == 0 and p["Np"] >= cout
    p = cv.plan(1, 3, 1, 1, 2, sms)           # K of 9 steps: no split
    assert p["splits"] == 1 and p["per_split"] == 9


def _small_decoder():
    dec = decoder.Decoder((8, 12, 16, 20), midchannels=(8, 8, 8, 16))
    feats = [torch.randn((2, c, s, s), generator=torch.Generator()
                         .manual_seed(c)) for c, s in ((8, 16), (12, 8),
                                                       (16, 4), (20, 2))]
    return dec.eval(), feats


def test_decoder_routes_by_whether_a_gradient_is_recorded(monkeypatch):
    """Every 3x3 of the decoder is a Conv3x3 (an nn.Conv2d, same state
    dict); a no-grad CPU call runs the wrapper's plain version once a
    convolution, bit for bit nn.Conv2d's result; a grad-recording call
    runs none of it and gives a graph; grad mode on with nothing that
    requires a gradient takes the wrapper."""
    dec, feats = _small_decoder()
    convs = [m for m in dec.modules() if isinstance(m, decoder.Conv3x3)]
    assert len(convs) == 24 and all(isinstance(m, nn.Conv2d) for m in convs)
    calls = []

    def spy(*a, **k):
        calls.append(a[0].shape)
        return conv3x3_plain(*a, **k)
    monkeypatch.setattr(cv, "conv3x3_plain", spy)
    with torch.no_grad():
        got = dec(feats)
    assert len(calls) == 24
    monkeypatch.setattr(decoder.Conv3x3, "forward", nn.Conv2d.forward)
    with torch.no_grad():
        assert torch.equal(dec(feats), got)
    monkeypatch.undo()
    monkeypatch.setattr(cv, "conv3x3_plain", spy)
    calls.clear()
    out = dec(feats)                     # parameters require gradients
    assert calls == [] and out.requires_grad
    assert torch.equal(out.detach(), got)
    out.sum().backward()
    assert all(m.weight.grad is not None for m in convs)
    for p in dec.parameters():
        p.requires_grad_(False)
    assert not dec(feats).requires_grad and len(calls) == 24


def test_decoder_copies_a_channels_last_input_to_nchw():
    """Laterals in channels_last (NHWC data on the CPU) reach the wrapper
    as NCHW and give nn.Conv2d's result within float32 rounding."""
    dec, feats = _small_decoder()
    cl = [f.contiguous(memory_format=torch.channels_last) for f in feats]
    with torch.no_grad():
        got = dec(cl)
        want = dec(feats)
    assert got.is_contiguous()
    assert float((got - want).norm() / want.norm()) <= 1e-6


def test_decoder_state_dict_is_unchanged():
    """Conv3x3 keeps nn.Conv2d's parameters: the decoder's state dict
    has the keys and shapes of nn.Conv2d(cin, cout, 3, padding=1)."""
    m = decoder.Conv3x3(6, 4)
    ref = nn.Conv2d(6, 4, 3, padding=1)
    assert {k: v.shape for k, v in m.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    assert (m.stride, m.padding, m.dilation, m.groups) == \
        (ref.stride, ref.padding, ref.dilation, ref.groups)


class _Cut:
    """A stand-in for priors._Cut: the tally of the piece being captured."""

    def __init__(self):
        self.tally = {}

    def add(self, name, n):
        self.tally[name] = self.tally.get(name, 0) + n


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_count_tallies_into_the_capture_and_replay_counts_again(
        monkeypatch):
    cut = _Cut()
    monkeypatch.setattr(logging, "_cut", cut)
    before = logging.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        logging.count("depth_conv3_macs", 5)
        logging.count("depth_conv3_macs", 7)
        logging.count("other", 1)
    assert cut.tally == {"depth_conv3_macs": 12, "other": 1}
    assert logging.counters() == before       # nothing counted while captured
    monkeypatch.setattr(logging, "_cut", None)
    g0, g1 = _Graph(), _Graph()
    pieces = [((), g0, {}), (("depth.decoder",), g1, dict(cut.tally))]
    priors.replay(pieces)                     # no profiler: nothing counted
    assert logging.counters() == before
    with profile(activities=[ProfilerActivity.CPU]):
        priors.replay(pieces)
        priors.replay(pieces)
    after = logging.counters()
    assert after.get("depth_conv3_macs", 0) \
        - before.get("depth_conv3_macs", 0) == 24
    assert after.get("other", 0) - before.get("other", 0) == 2
    assert (g0.replays, g1.replays) == (3, 3)
