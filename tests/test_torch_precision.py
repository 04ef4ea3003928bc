"""utils.precision.exact_f32, the float32 scope of the port's depth
network and of ssim/LPIPS (eval/metrics.py): inside it cuDNN stays on
with TF32 off for cuDNN and cuBLAS; on leaving, every flag it set is
back as it was, also when the body raises.  The checks read the flags
only, so they run on the CPU."""
import pytest
import torch

from google_nerf_tpu_torch.depth import model as depth_model
from google_nerf_tpu_torch.eval import metrics
from google_nerf_tpu_torch.utils.precision import exact_f32


def _flags():
    c = torch.backends.cudnn
    return dict(enabled=c.enabled, benchmark=c.benchmark,
                deterministic=c.deterministic, allow_tf32=c.allow_tf32,
                matmul_tf32=torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture(params=[(True, True), (False, False)],
                ids=["tf32_on", "all_off"])
def outside(request):
    """Flags set before the scope: TF32 on everywhere, or cuDNN off."""
    c = torch.backends.cudnn
    before = _flags()
    tf32, enabled = request.param
    torch.backends.cuda.matmul.allow_tf32 = tf32
    with c.flags(enabled=enabled, benchmark=True, deterministic=True,
                 allow_tf32=tf32):
        yield _flags()
    torch.backends.cuda.matmul.allow_tf32 = before["matmul_tf32"]
    assert _flags() == before


def test_scope_keeps_cudnn_on_without_tf32(outside):
    with exact_f32():
        inside = _flags()
    assert inside == dict(outside, enabled=True, allow_tf32=False,
                          matmul_tf32=False)
    assert _flags() == outside


def test_scope_restores_every_flag_on_an_exception(outside):
    with pytest.raises(KeyError):
        with exact_f32():
            assert torch.backends.cudnn.enabled
            raise KeyError("body failed")
    assert _flags() == outside


def test_depth_model_and_metrics_share_the_scope():
    assert depth_model.exact_f32 is exact_f32
    assert metrics.exact_f32 is exact_f32


@pytest.mark.parametrize("fn", ["ssim", "lpips"])
def test_metrics_run_inside_the_scope(fn, monkeypatch):
    """ssim's filter and LPIPS's VGG trunk see cuDNN on and TF32 off."""
    seen = []
    conv2d = metrics.F.conv2d

    def recording(*a, **kw):
        seen.append(_flags())
        return conv2d(*a, **kw)

    monkeypatch.setattr(metrics.F, "conv2d", recording)
    x = torch.rand(1, 3, 16, 16)
    if fn == "ssim":
        metrics.ssim(x, x.flip(-1))
    else:
        w = {}
        cin = 3
        li = 0
        for b, widths in enumerate(metrics._VGG_BLOCKS):
            for width in widths:
                w[f"conv{li}_w"] = torch.randn(width, cin, 3, 3) * 0.05
                w[f"conv{li}_b"] = torch.zeros(width)
                cin, li = width, li + 1
            w[f"lin{b}_w"] = torch.rand(1, cin, 1, 1)
        metrics._lpips_impl(w, x * 2 - 1, x.flip(-1) * 2 - 1)
    assert seen and all(f["enabled"] and not f["allow_tf32"]
                        and not f["matmul_tf32"] for f in seen)


def test_depth_step_precision_tool_on_the_cpu():
    """tools/depth_step_precision at resnet18, 64x64, on the CPU.  At a
    batch of 2: the float32 step's loss within 1e-6 of float64, its
    gradients and momentum traces within 2e-3.  At a batch of 1, where
    compared_keys leaves out the encoder's style_mod0 (its gradient is
    eps's alone): every other tensor's gradient and trace within 2e-4;
    the float32 losses on the float64 prediction within 1e-6 of its
    float64 gradient; the float32 backward pass fed that gradient nearer
    float64 with BatchNorm on its running statistics than on the batch.
    One intra-op thread: the test workers share the cores."""
    from google_nerf_tpu_torch.tools import depth_step_precision as dsp
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        two = dsp.compare(*dsp.inputs("resnet18", 64, 2, 8), "cpu")
        one = dsp.run("resnet18", 64, 1, 8, "cpu")
    finally:
        torch.set_num_threads(n)
    assert "card_f64" not in two
    assert two["cpu"]["loss"] <= 1e-6
    assert two["cpu"]["grads"] <= 2e-3 and two["cpu"]["traces"] <= 2e-3
    assert one["n_compared"] == two["n_compared"] - 8   # style_mod0.mlp
    assert one["cpu"]["grads_tensor_max"] <= 2e-4
    assert one["cpu"]["traces_tensor_max"] <= 2e-4
    parts = one["cpu_split"]
    assert parts["losses_alone"] <= 1e-6
    assert parts["backward_alone_bn_eval"] < parts["backward_alone"]
