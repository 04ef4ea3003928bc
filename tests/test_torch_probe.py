"""Tool probes P1-P4 of the PyTorch port (ops/cuda/probe.py) against the
JAX tool tools/pallas_probe.py: the port's plain versions on the same
numpy inputs as the tool's own references (`jnp.take(tab, idx, axis=0)`,
`jnp.zeros((T, F)).at[sidx].add(vals)`) and as interpret-mode copies of
its four Pallas kernels.  The tool itself cannot be imported: it runs
its 1M-row probes at import.  The copies keep its bodies and BlockSpecs
at small sizes (T=256, F=32, N=1024 in blocks of 256, NS=512, NC=128).

Tolerances: the gathers are exact; the scatter-add within atol 1e-5 (its
f32 sums may be taken in another order; ~2 rows land on each table row).
The card-only kernel tests are in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from google_nerf_tpu_torch.ops.cuda import probe
from google_nerf_tpu_torch.tools import kernel_probe

T, F, N, BLK, NS, NC = 256, 32, 1024, 256, 512, 128


def _inputs(seed=0, t=T, f=F, n=N, ns=NS):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, f).astype(np.float32),
            rng.randint(0, t, n).astype(np.int32),
            rng.randn(ns, f).astype(np.float32),
            rng.randint(0, t, ns).astype(np.int32))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _gather_interpret(tab, idx):
    """tools/pallas_probe.py:39-53 (`kern`, `call`; P1) and :74-88
    (`kernb`, `callb`; P2, the same body on a bf16 table) in interpret
    mode: the whole table as one VMEM block, idx in blocks of BLK."""
    def kern(tab_ref, idx_ref, out_ref):
        out_ref[:] = tab_ref[idx_ref[:], :]

    return pl.pallas_call(
        kern,
        grid=(N // BLK,),
        out_shape=jax.ShapeDtypeStruct((N, F), tab.dtype),
        in_specs=[pl.BlockSpec((T, F), lambda g: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((BLK,), lambda g: (g,),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((BLK, F), lambda g: (g, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(tab, idx)


def _scatter_interpret(sidx, vals):
    """tools/pallas_probe.py:113-130 (`skern`, `scall`; P3) in interpret
    mode: sidx in SMEM, one scalar loop adding in index order."""
    def skern(idx_ref, vals_ref, out_ref):
        out_ref[:] = jnp.zeros_like(out_ref)

        def body(i, _):
            j = idx_ref[i]
            out_ref[j, :] += vals_ref[i, :]
            return 0

        jax.lax.fori_loop(0, NS, body, 0)

    return pl.pallas_call(
        skern,
        out_shape=jax.ShapeDtypeStruct((T, F), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(sidx, vals)


def _row_dma_interpret(idx, tab):
    """tools/pallas_probe.py:155-172 (`grid_spec`, `ckern`, `ccall`; P4)
    in interpret mode: one (1, F) row block per grid step, addressed by
    the scalar-prefetched idx."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(NC,),
        in_specs=[pl.BlockSpec((1, F), lambda g, idx: (idx[g], 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, F), lambda g, idx: (g, 0),
                               memory_space=pltpu.VMEM),
    )

    def ckern(idx_ref, tab_ref, out_ref):
        out_ref[:] = tab_ref[:]

    return pl.pallas_call(
        ckern,
        out_shape=jax.ShapeDtypeStruct((NC, F), jnp.float32),
        grid_spec=grid_spec,
        interpret=True,
    )(idx, tab)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_matches_jax_reference_and_interpret_kernel(dtype):
    """P1 (f32) and P2 (bf16): the wrapper on CPU tensors, its plain
    version, jnp.take and the Pallas kernel agree exactly."""
    tab, idx, _, _ = _inputs()
    jtab = jnp.asarray(tab).astype(getattr(jnp, dtype))
    ttab = torch.as_tensor(tab).to(getattr(torch, dtype))
    tidx = torch.as_tensor(idx)
    before = dict(probe.gather_rows.launches)
    got = probe.gather_rows(ttab, tidx)
    assert got.dtype == ttab.dtype and tuple(got.shape) == (N, F)
    np.testing.assert_array_equal(got.float().numpy(),
                                  _np(jnp.take(jtab, idx, axis=0)))
    np.testing.assert_array_equal(got.float().numpy(),
                                  _np(_gather_interpret(jtab, idx)))
    assert torch.equal(probe.gather_rows_plain(ttab, tidx), got)
    assert probe.gather_rows.launches == before      # no kernel on the CPU


def test_scatter_add_matches_jax_reference_and_interpret_kernel():
    """P3 within atol 1e-5 of the tool's reference and of its scalar-loop
    kernel."""
    _, _, vals, sidx = _inputs()
    before = probe.scatter_add_rows.launches
    got = probe.scatter_add_rows(torch.as_tensor(sidx),
                                 torch.as_tensor(vals), T).numpy()
    assert got.shape == (T, F) and got.dtype == np.float32
    ref = _np(jnp.zeros((T, F)).at[sidx].add(vals))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got, _np(_scatter_interpret(jnp.asarray(sidx), jnp.asarray(vals))),
        rtol=0, atol=1e-5)
    assert np.abs(got).sum() > 0
    assert probe.scatter_add_rows.launches == before


def test_bulk_gather_matches_jax_reference_and_interpret_kernel():
    """P4 on the tool's idx[:NC]: exact against jnp.take and the row-DMA
    kernel."""
    tab, idx, _, _ = _inputs()
    idx = idx[:NC]
    before = probe.gather_rows_bulk.launches
    got = probe.gather_rows_bulk(torch.as_tensor(tab),
                                 torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, _np(jnp.take(tab, idx, axis=0)))
    np.testing.assert_array_equal(
        got, _np(_row_dma_interpret(jnp.asarray(idx), jnp.asarray(tab))))
    np.testing.assert_array_equal(
        probe.gather_rows_bulk_plain(torch.as_tensor(tab),
                                     torch.as_tensor(idx)).numpy(), got)
    assert probe.gather_rows_bulk.launches == before


@pytest.mark.parametrize("n,f,dtype", [(1000, 32, "float32"),
                                       (999, 16, "bfloat16"),
                                       (77, 3, "float32"),
                                       (0, 32, "float32"),
                                       (33, 1, "float32"),
                                       (129, 33, "float32"),
                                       (31, 4, "float32"),
                                       (65, 128, "float32"),
                                       (33, 256, "bfloat16")])
def test_ragged_gathers_and_scatter_match_jax(n, f, dtype):
    """Sizes no block or 32-row warp tile divides, narrow rows and an
    empty index; rows of 4, 12 and 132 bytes (F = 1, 3, 33: the scatter's
    cut-short words) scatter but no gather takes them; the bulk gather's
    smallest and largest rows, 16 and 512 bytes, in f32 and bf16."""
    tab, idx, vals, sidx = _inputs(seed=1, f=f, n=n, ns=n)
    jtab = jnp.asarray(tab).astype(getattr(jnp, dtype))
    ttab = torch.as_tensor(tab).to(getattr(torch, dtype))
    if (f * ttab.element_size()) % 16:     # both gathers move 16-byte words
        for fn in (probe.gather_rows, probe.gather_rows_bulk):
            with pytest.raises(ValueError, match="multiple of 16"):
                fn(ttab, torch.as_tensor(idx))
    else:
        got = probe.gather_rows(ttab, torch.as_tensor(idx))
        assert tuple(got.shape) == (n, f)
        np.testing.assert_array_equal(got.float().numpy(),
                                      _np(jnp.take(jtab, idx, axis=0)))
        np.testing.assert_array_equal(
            probe.gather_rows_bulk(ttab, torch.as_tensor(idx)).float()
            .numpy(), got.float().numpy())
    np.testing.assert_allclose(
        probe.scatter_add_rows(torch.as_tensor(sidx), torch.as_tensor(vals),
                               T).numpy(),
        _np(jnp.zeros((T, f)).at[sidx].add(vals)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("f,dtype", [(3, torch.float32), (4, torch.bfloat16),
                                     (256, torch.float32)])
def test_bulk_gather_refuses_rows_it_cannot_copy(f, dtype):
    """A bulk copy moves a multiple of 16 bytes, here at most 512 a row:
    12-, 8- and 1024-byte rows raise on every device, never falling back.
    The thread gather moves 16-byte words too: it refuses the 12- and
    8-byte rows alike and takes the 1024-byte ones."""
    tab = torch.zeros((8, f), dtype=dtype)
    idx = torch.zeros(4, dtype=torch.int32)
    for fn in (probe.gather_rows_bulk, probe.gather_rows_bulk_plain):
        with pytest.raises(ValueError, match="bulk copy"):
            fn(tab, idx)
    for fn in (probe.gather_rows, probe.gather_rows_plain):
        if (f * tab.element_size()) % 16:
            with pytest.raises(ValueError, match="the gather"):
                fn(tab, idx)
        else:
            assert torch.equal(fn(tab, idx), tab[idx])
    with pytest.raises(ValueError, match="aligned"):
        probe.gather_rows(torch.zeros(33)[1:].view(8, 4), idx)


def test_wrappers_check_their_arguments():
    tab = torch.zeros((8, 4))
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        probe.gather_rows(tab, idx.long())
    with pytest.raises(TypeError, match="2-D"):
        probe.gather_rows(tab[None], idx)
    with pytest.raises(TypeError, match="float32"):
        probe.gather_rows(tab.half(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        probe.gather_rows(tab.t(), idx)
    with pytest.raises(ValueError, match="entries"):
        probe.scatter_add_rows(idx, torch.zeros((4, 4)), 8)
    with pytest.raises(ValueError, match="T="):
        probe.scatter_add_rows(idx, torch.zeros((3, 4)), -1)
    with pytest.raises(TypeError, match="vals"):
        probe.scatter_add_rows(idx, torch.zeros((3, 4), dtype=torch.float64),
                               8)


def test_kernel_probe_cases_on_cpu():
    """The tool's probes at a small size on the CPU: each wrapper (here
    its plain version) works by the tool's own test, each of its library
    calls computes the same function, and its work counts the bytes its
    inputs and output must move."""
    cases = kernel_probe.probes("cpu", seed=0, t=T, n=N, ns=NS, nc=NC)
    assert [p.label for p in cases] == ["(a)", "(a2)", "(b)", "(c)"]
    assert [p.scatter for p in cases] == [False, False, True, False]
    for p in cases:
        got = p.fn(*p.args)
        assert p.agrees(got, p.plain(*p.args)) == (True, 0.0)
        for name, call in p.library_calls().items():
            assert p.agrees(call(), got)[0], (p.label, name)
    tab, idx = cases[0].args
    assert cases[0].work() == (4 * N + 4 * F * (N + len(set(idx.tolist()))),
                               0)
    scatter = cases[2]
    assert scatter.work() == (4 * (NS + NS * F + T * F), NS * F)
    off = scatter.fn(*scatter.args) + 1e-4
    assert not scatter.agrees(off, scatter.plain(*scatter.args))[0]


def test_kernel_probe_runs_only_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the refusal without one")
    with pytest.raises(SystemExit, match="no CUDA device"):
        kernel_probe.main([])
