"""The 3-D ResNet stem convolution of ``ops/stem_conv.py`` on the CPU: its
plain version against ``F.conv3d`` and the JAX package's stem convolution,
the rule that routes R3D's ``conv1`` to the tensor-core kernel, the
autograd Function's weight gradient, and the CPU model's forward and
backward (the kernel itself runs only on the card:
``tests/test_torch_port_hygiene.py``, ``chip_smoke.py``'s stem phase)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from video_similarity_search_tpu.models.layers import Conv3d as JConv3d
from video_similarity_search_tpu_torch.models import generate_model
from video_similarity_search_tpu_torch.models.layers import Conv3d
from video_similarity_search_tpu_torch.ops import stem_conv


def _operands(b, t, h, w, kt, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, w, 3)).astype(np.float32)
    wt = (0.1 * rng.normal(size=(cout, 3, kt, 7, 7))).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("kt", [1, 3, 5, 7])
@pytest.mark.parametrize("cout", [64, 128])
@pytest.mark.parametrize("b", [1, 3])
def test_plain_version_equals_conv3d_and_the_jax_stem(kt, cout, b):
    x, wt = _operands(b, 5, 9, 11, kt, cout, seed=kt + cout + b)
    got = stem_conv.conv3d_plain(torch.from_numpy(x), torch.from_numpy(wt))
    assert got.shape == (b, cout, 5, 5, 6)
    ref = F.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(),
                   torch.from_numpy(wt), stride=(1, 2, 2),
                   padding=(kt // 2, 3, 3))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    jax_out = JConv3d(cout, (kt, 7, 7), (1, 2, 2)).apply(
        {"params": {"Conv_0": {"kernel": jnp.asarray(
            wt.transpose(2, 3, 4, 1, 0))}}}, jnp.asarray(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(jax_out), rtol=1e-5, atol=1e-5)


_R3D18_STEM = dict(in_channels=3, out_channels=64, kernel_size=(7, 7, 7),
                   stride=(1, 2, 2))


@pytest.mark.parametrize("case,kwargs,device,dtype,engaged", [
    ("R3D-18's bf16 CUDA stem", {}, "cuda", torch.bfloat16, True),
    ("kT 3, Cout 128", dict(out_channels=128, kernel_size=(3, 7, 7)),
     "cuda", torch.bfloat16, True),
    ("kT 1", dict(kernel_size=(1, 7, 7)), "cuda", torch.bfloat16, True),
    ("float32 compute (no autocast)", {}, "cuda", None, False),
    ("fp16 autocast", {}, "cuda", torch.float16, False),
    ("the CPU", {}, "cpu", torch.bfloat16, False),
    ("stem_s2d's 12 channels", dict(in_channels=12, kernel_size=(7, 4, 4),
                                    stride=(1, 1, 1), padding=(3, 2, 2)),
     "cuda", torch.bfloat16, False),
    ("temporal stride 2", dict(stride=(2, 2, 2)), "cuda", torch.bfloat16,
     False),
    ("Cout 32", dict(out_channels=32), "cuda", torch.bfloat16, False),
    ("even kT", dict(kernel_size=(4, 7, 7), padding=(2, 3, 3)), "cuda",
     torch.bfloat16, False),
])
def test_routing_rule(case, kwargs, device, dtype, engaged):
    conv = Conv3d(**{**_R3D18_STEM, **kwargs})
    assert stem_conv.engages(conv, device, dtype) is engaged, case


def test_routing_rule_takes_the_models_stems():
    r3d = generate_model(18, no_max_pool=True)
    assert stem_conv.engages(r3d.conv1, "cuda", torch.bfloat16)
    s2d = generate_model(18, no_max_pool=True, stem_s2d=True)
    assert not stem_conv.engages(s2d.conv1, "cuda", torch.bfloat16)
    assert stem_conv.autocast_dtype("cpu") is None
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert stem_conv.autocast_dtype("cpu") == torch.bfloat16


@pytest.mark.parametrize("kt", [3, 7])
def test_function_weight_gradient_equals_conv3d(kt):
    x, wt = _operands(2, 4, 10, 12, kt, 64, seed=kt)
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, 64, 4, 5, 6)).astype(np.float32))
    w1 = torch.from_numpy(wt).requires_grad_()
    out = stem_conv.StemConv3d.apply(torch.from_numpy(x), w1)
    out.backward(g)
    w2 = torch.from_numpy(wt).requires_grad_()
    ref = F.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), w2,
                   stride=(1, 2, 2), padding=(kt // 2, 3, 3))
    ref.backward(g)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-6, atol=1e-6)


def test_function_refuses_an_input_gradient():
    x, wt = _operands(1, 2, 8, 8, 3, 64)
    with pytest.raises(RuntimeError, match="no gradient for its input"):
        stem_conv.StemConv3d.apply(torch.from_numpy(x).requires_grad_(),
                                   torch.from_numpy(wt))


def _forward_backward(model, x):
    out = model(x)
    out.square().sum().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    return out.detach(), grads


@pytest.mark.parametrize("autocast", [False, True])
def test_resnet3d_cpu_forward_and_backward_unchanged(monkeypatch, autocast):
    """On the CPU (also under CPU autocast) the stem calls ``conv1`` and
    never the kernel's op; forced through the op, the CPU model takes the
    plain version and the Function's gradient, with the same result."""
    torch.manual_seed(0)
    model = generate_model(10, no_max_pool=True, hidden_layer=32,
                           out_dim=8, conv1_t_size=3)
    model.train()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 4, 20, 20, 3)).astype(np.float32))
    ctx = (torch.autocast("cpu", dtype=torch.bfloat16) if autocast
           else torch.autocast("cpu", enabled=False))
    calls = []
    real = stem_conv.stem_conv3d

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(stem_conv, "stem_conv3d", counted)
    launches = stem_conv.LAUNCHES
    state = {k: v.clone() for k, v in model.state_dict().items()}
    with ctx:
        out, grads = _forward_backward(model, x)
    assert not calls and stem_conv.LAUNCHES == launches
    if autocast:
        return
    model.load_state_dict(state)  # the BatchNorm statistics moved
    monkeypatch.setattr(stem_conv, "engages", lambda *a: True)
    routed, routed_grads = _forward_backward(model, x)
    assert calls and stem_conv.LAUNCHES == launches
    torch.testing.assert_close(routed, out, rtol=1e-5, atol=1e-5)
    for k, g in grads.items():
        torch.testing.assert_close(routed_grads[k], g, rtol=1e-4,
                                   atol=1e-5, msg=k)
