"""S3D's float32 stem weight gradient of ``ops/stem_wgrad.py`` on the CPU:
its plain version against the JAX package's gradient of S3D's stem
convolution, the rule that routes ``Conv_1a.conv1`` to the kernel, the
autograd Function, and S3D's CPU forward and backward with and without
the route. The kernel itself runs only on the card: the ``gpu`` test
below and ``chip_smoke.py``'s ``stem_wgrad`` phase."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video_similarity_search_tpu_torch.models.layers import Conv3d
from video_similarity_search_tpu_torch.models.s3d import S3D
from video_similarity_search_tpu_torch.ops import stem_wgrad


def _operands(b, t, h, w, cout, seed=0):
    """(B, T, H, W, 3) clips, a (Cout, 3, 1, 7, 7) weight and the output
    gradient (B, Cout, T, ceil(H / 2), ceil(W / 2)), seeded."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, w, 3)).astype(np.float32)
    wt = (0.1 * rng.normal(size=(cout, 3, 1, 7, 7))).astype(np.float32)
    g = rng.normal(size=(b, cout, t, (h + 1) // 2, (w + 1) // 2)).astype(
        np.float32)
    return x, wt, g


@pytest.mark.parametrize("b,t,h,w,cout", [(2, 2, 17, 16, 64),
                                          (1, 3, 9, 11, 128)])
def test_plain_weight_gradient_equals_the_jax_stem_gradient(b, t, h, w,
                                                            cout):
    """The plain version against ``jax.grad`` of the JAX package's
    ``Conv3d`` as its S3D builds ``Conv_1a.conv1`` ((1, 7, 7), stride
    (1, 2, 2), padding (0, 3, 3)), on the same weights, clips and output
    gradient."""
    import jax
    import jax.numpy as jnp

    from video_similarity_search_tpu.models.layers import Conv3d as JConv3d

    x, wt, g = _operands(b, t, h, w, cout, seed=h + cout)
    got = stem_wgrad.weight_grad_plain(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(g),
        torch.from_numpy(wt))
    assert got.shape == (cout, 3, 1, 7, 7)
    conv = JConv3d(cout, (1, 7, 7), (1, 2, 2), padding=(0, 3, 3))
    g_cl = jnp.asarray(g.transpose(0, 2, 3, 4, 1))

    def inner(kernel):
        out = conv.apply({"params": {"Conv_0": {"kernel": kernel}}},
                         jnp.asarray(x))
        return (out * g_cl).sum()

    jax_grad = np.asarray(jax.grad(inner)(jnp.asarray(
        wt.transpose(2, 3, 4, 1, 0))))  # (kT, kH, kW, Cin, Cout)
    np.testing.assert_allclose(got.numpy(),
                               jax_grad.transpose(4, 3, 0, 1, 2),
                               rtol=1e-4, atol=1e-4)


_S3D_STEM = dict(in_channels=3, out_channels=64, kernel_size=(1, 7, 7),
                 stride=(1, 2, 2), padding=(0, 3, 3))
_CLIP = dict(device="cuda", dtype=torch.float32, requires_grad=False)


@pytest.mark.parametrize("case,conv_kw,clip_kw,compute_dtype,grad,engaged", [
    ("the MoCo query's float32 CUDA stem", {}, {}, None, True, True),
    ("Cout 128", dict(out_channels=128), {}, None, True, True),
    ("the CPU", {}, dict(device="cpu"), None, True, False),
    ("bf16 autocast", {}, {}, torch.bfloat16, True, False),
    ("2 channels (the flow stem)", dict(in_channels=2), {}, None, True,
     False),
    ("a weight that takes no gradient", dict(requires_grad=False), {}, None,
     True, False),
    ("a clip that requires a gradient", {}, dict(requires_grad=True), None,
     True, False),
    ("grad mode off (the key encoder's forward)", {}, {}, None, False,
     False),
    ("stride (1, 1, 1)", dict(stride=(1, 1, 1)), {}, None, True, False),
    ("Cout 48", dict(out_channels=48), {}, None, True, False),
    ("a (3, 7, 7) kernel", dict(kernel_size=(3, 7, 7), padding=(1, 3, 3)),
     {}, None, True, False),
    ("a bias", dict(bias=True), {}, None, True, False),
    ("float64", dict(dtype=torch.float64), dict(dtype=torch.float64), None,
     True, False),
])
def test_routing_rule(case, conv_kw, clip_kw, compute_dtype, grad, engaged):
    conv_kw = dict(conv_kw)
    requires_grad = conv_kw.pop("requires_grad", True)
    dtype = conv_kw.pop("dtype", torch.float32)
    conv = Conv3d(**{**_S3D_STEM, **conv_kw}).to(dtype).requires_grad_(
        requires_grad)
    clip = {**_CLIP, **clip_kw}
    x = types.SimpleNamespace(device=torch.device(clip["device"]),
                              dtype=clip["dtype"],
                              requires_grad=clip["requires_grad"])
    with torch.set_grad_enabled(grad):
        assert stem_wgrad.engages(conv, x, compute_dtype) is engaged, case


def test_routing_rule_takes_s3ds_rgb_stem_alone():
    x = types.SimpleNamespace(device=torch.device("cuda"),
                              dtype=torch.float32, requires_grad=False)
    rgb, flow = S3D(), S3D(input_channel=2)
    assert stem_wgrad.engages(rgb.Conv_1a.conv1, x, None)
    assert not stem_wgrad.engages(flow.Conv_1a.conv1, x, None)
    assert not any(stem_wgrad.engages(m, x, None) for name, m in
                   rgb.named_modules() if isinstance(m, torch.nn.Conv3d)
                   and name != "Conv_1a.conv1")


@pytest.mark.parametrize("b,t,h,w,cout", [(2, 3, 10, 12, 64),
                                          (1, 2, 9, 7, 128)])
def test_function_equals_conv3d_forward_and_weight_gradient(b, t, h, w,
                                                            cout):
    x, wt, g = _operands(b, t, h, w, cout, seed=w)
    xv = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    w1 = torch.from_numpy(wt).requires_grad_()
    out = stem_wgrad.StemWgradF32.apply(xv, w1)
    out.backward(torch.from_numpy(g))
    w2 = torch.from_numpy(wt).requires_grad_()
    ref = F.conv3d(xv, w2, stride=(1, 2, 2), padding=(0, 3, 3))
    ref.backward(torch.from_numpy(g))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-6, atol=1e-6)


def test_function_refuses_an_input_gradient():
    x, wt, _ = _operands(1, 2, 8, 8, 64)
    with pytest.raises(RuntimeError, match="no gradient for its input"):
        stem_wgrad.StemWgradF32.apply(
            torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_(),
            torch.from_numpy(wt))


def test_alignment_copy_only_off_16_bytes():
    """The wrapper copies an operand only where it starts off the 16
    bytes the kernel's copies need, and keeps its memory order."""
    a = torch.zeros(2, 3, 4, 8, 4)
    assert stem_wgrad._aligned(a) is a
    off = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)
    assert off.data_ptr() % 16 == 4
    v = off.permute(0, 4, 1, 2, 3)
    copied = stem_wgrad._aligned(v)
    assert copied.data_ptr() % 16 == 0 and copied.stride() == v.stride()
    assert torch.equal(copied, v)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, _, g = _operands(1, 2, 8, 8, 64)
    with pytest.raises(ValueError, match="one CUDA device"):
        stem_wgrad.weight_grad_cuda(torch.from_numpy(x), torch.from_numpy(g))


def _forward_backward(model, x):
    out = model(x)
    out.square().sum().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    return out.detach(), grads


def test_s3d_cpu_forward_and_backward_unchanged(monkeypatch):
    """On the CPU the stem calls ``conv1`` and never the Function; forced
    through the Function, the CPU model takes its plain weight gradient,
    with the same output and gradients."""
    torch.manual_seed(0)
    model = S3D()
    model.train()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 8, 32, 32, 3)).astype(np.float32))
    calls = []
    real = stem_wgrad.StemWgradF32.apply

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(stem_wgrad.StemWgradF32, "apply", counted)
    launches = stem_wgrad.LAUNCHES
    state = {k: v.clone() for k, v in model.state_dict().items()}
    out, grads = _forward_backward(model, x)
    assert not calls and stem_wgrad.LAUNCHES == launches
    model.load_state_dict(state)  # the BatchNorm statistics moved
    stem = model.Conv_1a.conv1
    monkeypatch.setattr(stem_wgrad, "engages", lambda conv, *a: conv is stem)
    routed, routed_grads = _forward_backward(model, x)
    assert len(calls) == 1 and stem_wgrad.LAUNCHES == launches
    torch.testing.assert_close(routed, out, rtol=0, atol=0)
    for k, g in grads.items():
        torch.testing.assert_close(routed_grads[k], g, rtol=1e-5,
                                   atol=1e-6, msg=k)


@pytest.mark.gpu
def test_stem_wgrad_kernel_on_the_card():
    """The kernel against a float64 weight gradient at ragged shapes (odd
    H and W, W not a multiple of 4, Cout 128; a clip and, apart, an output
    gradient that start 4 bytes into their storage, off the 16 bytes the
    kernel's copies need), two calls bitwise equal, and one launch a
    float32 MoCo step, none in the key encoder's forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train import (make_banks,
                                                         make_moco_train_step,
                                                         make_optimizer)
    from video_similarity_search_tpu_torch.utils.moco_precision import \
        moco_cfg

    gen = torch.Generator(device="cuda").manual_seed(0)
    def off_by_4_bytes(a):
        return torch.cat([a.new_zeros(1), a.flatten()])[1:].view(a.shape)

    # W 16 needs no padding, so the views reach the wrapper's alignment copy
    for b, t, h, w, cout, off in [(3, 5, 37, 45, 64, None),
                                  (2, 3, 17, 16, 128, "x"),
                                  (1, 4, 64, 64, 64, "grad")]:
        x = torch.randn(b, t, h, w, 3, device="cuda", generator=gen)
        g = torch.randn(b, t, (h + 1) // 2, (w + 1) // 2, cout, device="cuda",
                        generator=gen)
        if off == "x":
            x = off_by_4_bytes(x)
        if off == "grad":
            g = off_by_4_bytes(g)
        assert (x.data_ptr() % 16 != 0) == (off == "x")
        assert (g.data_ptr() % 16 != 0) == (off == "grad")
        g = g.permute(0, 4, 1, 2, 3)
        got = stem_wgrad.weight_grad_cuda(x, g)
        assert torch.equal(got, stem_wgrad.weight_grad_cuda(x, g))
        ref = stem_wgrad.weight_grad_plain(
            x.double().permute(0, 4, 1, 2, 3), g.double(),
            torch.empty(cout, 3, 1, 7, 7, dtype=torch.float64,
                        device="cuda"))
        err = float((got.double() - ref).abs().max() / ref.abs().max())
        assert err <= 1e-5, (b, t, h, w, cout, err)

    cfg = moco_cfg()
    torch.manual_seed(0)
    model = model_selector(cfg)
    bank = make_banks(cfg, 0, model)["moco"]
    step = make_moco_train_step(cfg, model,
                                *make_optimizer(cfg, model.parameters()),
                                bank, uber=True, device="cuda")
    batch = {k: torch.randn(4, 16, 64, 64, 3, device="cuda", generator=gen)
             for k in ("x1", "x2")}
    batch["label"] = torch.tensor([0, 1, 0, 2], device="cuda")
    before = stem_wgrad.LAUNCHES
    step(batch)
    torch.cuda.synchronize()
    assert stem_wgrad.LAUNCHES == before + 1
    bank.keys(batch["x2"])
    torch.cuda.synchronize()
    assert stem_wgrad.LAUNCHES == before + 1
