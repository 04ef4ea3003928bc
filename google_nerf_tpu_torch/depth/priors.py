"""Per-frame depth priors of the (cIMLE) LeReS model: what
depth_eval_scannet_torch.py runs for every frame of a scan (the
reference's `Train/tools/eval_scannet.py:335-467`).

`frame_priors` takes one frame on the device, resizes it to the crop
square (cv2's INTER_LINEAR sample positions), runs `depth_inference`
on each minibatch of latent hypotheses (ImageNet normalisation, the
float32 forward with TF32 off, one depth shift a minibatch) and
resizes every hypothesis back to the frame's size.  The priors stay on
the device.

On the card the network's forward runs as CUDA graphs, captured at the
first minibatch of each shape and replayed after: cuDNN's FFT-tiled
convolutions launch ~68,000 kernels a frame of 10 hypotheses at 448²,
which left the card waiting on the host for most of an eager frame
(815 ms eager against 311 ms replayed on an H100, the priors bit for
bit the same).  The capture is cut at each span inside the network
(utils/logging.span), so that a replay runs each piece inside the spans
its kernels belong to and a profiler still sees the layers.
"""
from __future__ import annotations

import contextlib
import itertools
import warnings
import weakref
from typing import Optional, Tuple

import torch

from google_nerf_tpu_torch.depth.model import (DepthNet, depth_forward,
                                               depth_inference)
from google_nerf_tpu_torch.utils import logging
from google_nerf_tpu_torch.utils.image import resize_linear
from google_nerf_tpu_torch.utils.logging import count, span

MINIBATCH = 5               # eval_scannet.py:374-380


class _Cut:
    """A capture cut at span boundaries: the graphs in order, each with
    the spans open while it was captured."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs, self.stack, self.graph = [], [], None

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool)

    def end(self):
        self.graph.capture_end()
        self.graphs.append((tuple(self.stack), self.graph))

    @contextlib.contextmanager
    def __call__(self, name):
        self.end()
        self.stack.append(name)
        self.begin()
        try:
            yield
        finally:
            self.end()
            self.stack.pop()
            self.begin()


class _Graphs:
    """depth_forward of one model as CUDA graphs, one set per input
    shape: the inputs are copied into the set's own, the output is the
    set's own and holds until the set's next call."""

    def __init__(self, model: DepthNet):
        self.weights = _weights_of(model)
        self.sets = {}

    def __call__(self, model, rgb, z):
        shape = (tuple(rgb.shape), None if z is None else tuple(z.shape))
        if shape not in self.sets:
            self.sets[shape] = _capture(model, rgb, z)
        x, zs, out, graphs = self.sets[shape]
        x.copy_(rgb)
        if z is not None:
            zs.copy_(z)
        replay(graphs)
        return out


def replay(graphs):
    """Replay [(spans, graph)] in order, each inside its spans: a span
    open across consecutive pieces stays one range."""
    names, opened = [], []
    try:
        for stack, graph in graphs:
            n = 0
            while n < min(len(names), len(stack)) and names[n] == stack[n]:
                n += 1
            while len(names) > n:           # the spans this piece is out of
                names.pop()
                opened.pop().__exit__(None, None, None)
            for name in stack[n:]:          # and those it is in
                names.append(name)
                opened.append(span(name))
                opened[-1].__enter__()
            graph.replay()
    finally:
        while opened:
            opened.pop().__exit__(None, None, None)


def _capture(model, rgb, z):
    """(input, latent and output buffers, the cut graphs) of one
    forward of this shape."""
    x = rgb.clone()
    zs = None if z is None else z.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # cuDNN picks its algorithms
        for _ in range(2):
            depth_forward(model, x, zs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    cut = _Cut()
    with torch.cuda.stream(side), warnings.catch_warnings():
        # the pieces before and after the network's spans are empty
        warnings.filterwarnings("ignore", "The CUDA Graph is empty")
        cut.begin()
        logging._cut = cut
        try:
            out = depth_forward(model, x, zs)
        finally:
            logging._cut = None
            cut.end()
    torch.cuda.current_stream().wait_stream(side)
    return x, zs, out, cut.graphs


def _weights_of(model):
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                        model.buffers()))


# each model's graphs, which go with the model
_GRAPHS = weakref.WeakKeyDictionary()


def _forward_of(model: DepthNet, rgb01: torch.Tensor):
    """The forward a frame's minibatches run: CUDA graphs of this model
    on the card in eval mode (captured anew when its weights move),
    depth_forward elsewhere."""
    if not rgb01.is_cuda or model.training:
        return depth_forward
    g = _GRAPHS.get(model)
    if g is None or g.weights != _weights_of(model):
        g = _GRAPHS[model] = _Graphs(model)
    return g


def frame_priors(model: DepthNet, rgb01: torch.Tensor,
                 latents: Optional[torch.Tensor], crop: int,
                 out_hw: Tuple[int, int],
                 n_z: Optional[int] = None) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] on the model's device -> (n_z, h, w)
    priors for out_hw = (h, w), on the device.

    latents: (n_z, d_latent), run MINIBATCH rows at a time, each
    minibatch shifted by its own minimum; None for a plain model, which
    then runs n_z (default 1) copies of the frame the same way."""
    if latents is not None:
        n_z = latents.shape[0]
    n_z = n_z or 1
    h, w = out_hw
    forward = _forward_of(model, rgb01)
    with span("depth.priors.frame"):
        count("depth_frames")
        with span("depth.resize"):
            inp = resize_linear(rgb01, (crop, crop)).permute(2, 0, 1)[None]
        preds = []
        for start in range(0, n_z, MINIBATCH):
            m = min(MINIBATCH, n_z - start)
            z = None if latents is None else latents[start:start + m]
            count("depth_hypotheses", m)
            preds.append(depth_inference(
                model, inp.expand(m, -1, -1, -1).contiguous(), z,
                forward)[:, 0])
        with span("depth.resize"):
            out = resize_linear(torch.cat(preds).permute(1, 2, 0), (w, h))
            return out.permute(2, 0, 1).contiguous()
