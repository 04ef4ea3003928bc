"""The construct ladder P5 of the PyTorch port (ops/cuda/ladder.py)
against the JAX tool tools/mosaic_bisect.py in interpret mode.

The tool is loaded by path and its module attribute `pl` replaced by a
shim that sets interpret=True on `pallas_call`, keeps `when`, and records
each rung's operands and output; then its own `main()` runs all 17 rungs.
Each port rung's plain version, on the port's copy of the tool's
operands (checked equal to the ones the tool passed), is held to the JAX
rung: exactly, or within rtol 1e-5 for k13, k15 and k16 (f32 sums in
another order, exp and sigmoid).  k12 reads its output before writing
it: JAX's buffer is undefined there and interpret mode returns NaN,
while the port defines k12 on a zeroed output (1.0 everywhere).  The
card-only kernel tests are in test_torch_cuda.py."""
import contextlib
import importlib.util
import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from google_nerf_tpu_torch.ops.cuda import ladder
from google_nerf_tpu_torch.tools import kernel_ladder

ROOT = Path(__file__).resolve().parents[1]


class _Interpret:
    """Stands in for the tool's `pl`: interpret-mode pallas_call that
    records (operands, output) of every call, and pl.when."""

    when = staticmethod(pl.when)

    def __init__(self):
        self.calls = []

    def pallas_call(self, kern, **kw):
        call = pl.pallas_call(kern, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            self.calls.append(([np.asarray(jnp.asarray(a).astype(jnp.float32)
                                           if a.dtype == jnp.bfloat16 else a)
                                for a in args], np.asarray(out)))
            return out
        return run


@pytest.fixture(scope="module")
def jax_ladder():
    """{k: (operands, output)} of the JAX tool's rungs, and its log."""
    spec = importlib.util.spec_from_file_location(
        "_mosaic_bisect_interpret", ROOT / "tools" / "mosaic_bisect.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    shim = _Interpret()
    tool.pl = shim
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tool.main()
    assert len(shim.calls) == len(ladder.RUNGS), log.getvalue()
    return dict(zip(ladder.RUNGS, shim.calls)), log.getvalue()


def test_jax_ladder_ran_every_rung(jax_ladder):
    _, log = jax_ladder
    for name, _ in ladder.RUNGS.values():
        assert f"{name}: OK" in log
    assert "BISECT DONE" in log


@pytest.mark.parametrize("k", [k for k in ladder.RUNGS if k != 12])
def test_plain_rung_matches_jax_rung(k, jax_ladder):
    jax_args, want = jax_ladder[0][k]
    args = ladder.rung_operands(k, ladder.operands("cpu"))
    assert len(args) == len(jax_args)
    for a, j in zip(args, jax_args):
        np.testing.assert_array_equal(a.float().numpy(), j.astype(np.float32))
    got = ladder.rung_plain(k, *args).numpy()
    assert got.shape == want.shape == (8, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=ladder.RTOL.get(k, 0.0),
                               atol=0)


def test_k12_is_defined_on_a_zeroed_output(jax_ladder):
    """The one rung met differently on purpose: JAX's k12 reads an
    undefined output (NaN in interpret mode); the port's starts from
    zeros, so every live lane adds 1."""
    _, want = jax_ladder[0][12]
    assert np.isnan(want).all()
    got = ladder.rung_plain(12, *ladder.rung_operands(
        12, ladder.operands("cpu")))
    np.testing.assert_array_equal(got.numpy(), np.ones((8, 64), np.float32))
    assert ladder.mismatch(12, torch.tensor(want), got) == \
        "output not finite"


def test_rung_wrapper_on_cpu_takes_the_plain_version():
    ops = ladder.operands("cpu")
    before = ladder.rung.launches
    for k in ladder.RUNGS:
        args = ladder.rung_operands(k, ops)
        got = ladder.rung(k, *args)
        assert ladder.mismatch(k, got, ladder.rung_plain(k, *args)) is None
    assert ladder.rung.launches == before


def test_mismatch_holds_each_rung_to_its_tolerance():
    want = torch.full((8, 64), 1000.0)
    assert ladder.mismatch(13, want * (1 + 5e-6), want) is None
    assert ladder.mismatch(13, want * (1 + 5e-5), want) is not None
    assert ladder.mismatch(8, want + 1.0 / 64, want) is not None
    assert ladder.mismatch(8, want[:4], want[:4]) is not None


def test_rungs_check_their_operands():
    ops = ladder.operands("cpu")
    with pytest.raises(ValueError, match="k18"):
        ladder.rung(18, ops["r8"])
    with pytest.raises(TypeError, match="operand"):
        ladder.rung(7, ops["r8"])
    with pytest.raises(TypeError, match="slabT"):
        ladder.rung(8, ops["slabT"].float())
    with pytest.raises(TypeError, match="r8"):
        ladder.rung_plain(1, ops["r8"][:4])


def test_kernel_ladder_runs_only_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    with pytest.raises(SystemExit, match="no CUDA device"):
        kernel_ladder.main([])
