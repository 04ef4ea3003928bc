"""Host ranges the benchmark lays around the program's layers in a
traced run only: the encoder's forward ("portbench.encoder.forward"),
its backward from the gradient reaching its output to the table's
gradient leaving it ("portbench.encoder.backward"), and the density
grid's update ("portbench.grid_update").  The program's module
attributes are swapped for wrappers and restored afterwards."""
from __future__ import annotations

import contextlib

import torch
from torch.autograd.profiler import record_function

ENC_FWD = "portbench.encoder.forward"
ENC_BWD = "portbench.encoder.backward"
GRID = "portbench.grid_update"
WINDOW = "portbench.window"


class _Box:
    def __init__(self):
        self.rf = None

    def enter(self):
        self.rf = record_function(ENC_BWD)
        self.rf.__enter__()

    def exit(self):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class _Begin(torch.autograd.Function):
    """Identity on the encoder's output; its backward opens the range."""

    @staticmethod
    def forward(ctx, x, box):
        ctx.box = box
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.box.enter()
        return g, None


class _End(torch.autograd.Function):
    """Identity on the table; its backward closes the range."""

    @staticmethod
    def forward(ctx, x, box):
        ctx.box = box
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.box.exit()
        return g, None


@contextlib.contextmanager
def layer_ranges(table_key: str):
    from google_nerf_tpu_torch.models import ngp
    from google_nerf_tpu_torch.train import system
    enc0, grid0 = ngp._encode_xyz, system.grid_update_step

    def encode(params, cfg, x01):
        box = _Box()
        p = dict(params)
        p[table_key] = _End.apply(params[table_key], box)
        with record_function(ENC_FWD):
            out = enc0(p, cfg, x01)
        return _Begin.apply(out, box)

    def grid(*a, **k):
        with record_function(GRID):
            return grid0(*a, **k)

    ngp._encode_xyz, system.grid_update_step = encode, grid
    try:
        yield
    finally:
        ngp._encode_xyz, system.grid_update_step = enc0, grid0
