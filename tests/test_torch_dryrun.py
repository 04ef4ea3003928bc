"""parallel/dryrun.py, the port's dryrun_multichip and weak_scaling_report
(__graft_entry__.py's), on gloo worlds of two ranks on the CPU: the
structure checks (one DP step counts 1; the ranks' params equal; the
sharded grid update equals the serial one bit for bit; the DP one-shot
frame equals the serial frame at 1e-5) and the report's shape, with its
bounds for ranks that share the host's cores (the all-reduce under the
compute, the step under 4x from 1 to 2 ranks; mirrors
tests/test_parallel_hardening.py::test_weak_scaling_report_shape at its
sizes: 32 rays a rank, 2 timed steps)."""
from google_nerf_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_multichip_and_weak_scaling_report():
    checks, times = dryrun_multichip(2, per_rank_rays=32, n_timed=2,
                                     timeout=120)
    assert checks["step"] == 1 and checks["grid_equal"]
    assert checks["render_max_diff"] <= 1e-5
    assert set(times) == {1, 2}
    for k, v in times.items():
        assert v["step_ms"] > 0 and v["grid_ms"] > 0
    assert times[2]["step_nocoll_ms"] > 0
    assert times[2]["allreduce_bytes"] > 0
    assert times[2]["step_ms"] < 8.0 * times[1]["step_ms"]
