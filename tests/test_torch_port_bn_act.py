"""The 3-D ResNet's eval BatchNorm epilogue of ``ops/bn_act.py``: its plain
version against the modules' unfused eval composition, the rule that
routes a block's epilogue to the fused pass, the CPU model's eval forward
(the modules' own calls, bitwise as before), the routing of R3D-18's and
R3D-50's epilogues where the rule holds, and (``gpu``-marked, on the card)
the kernel against the plain version and its launches in a forward. The
file imports no JAX, so the card runs it:
``python -m pytest --noconftest -m gpu tests/test_torch_port_bn_act.py``."""

import contextlib
import types

import pytest
import torch
import torch.nn.functional as F

from video_similarity_search_tpu_torch.models import generate_model
from video_similarity_search_tpu_torch.models import resnet3d
from video_similarity_search_tpu_torch.models.layers import BatchNorm
from video_similarity_search_tpu_torch.models.resnet3d import (BasicBlock3d,
                                                               Bottleneck3d)
from video_similarity_search_tpu_torch.ops import bn_act

CL = torch.channels_last_3d
VARIANTS = ["none", "residual", "normalized residual"]


def _bn(c: int, seed: int, dtype=torch.float32) -> BatchNorm:
    """An eval-mode BatchNorm with seeded affine parameters and running
    statistics."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
        bn.bias.copy_(0.5 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.5 * torch.randn(c, generator=g))
        bn.running_var.copy_(0.2 + torch.rand(c, generator=g) * 2)
    return bn.to(dtype).eval()


def _operands(variant, shape, dtype, seed=0, device="cpu"):
    """x, residual, bn, residual_bn for a variant, in channels_last_3d."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = torch.randn(shape, generator=g).to(dtype).to(device,
                                                       memory_format=CL)
    r = (None if variant == "none" else
         torch.randn(shape, generator=g).to(dtype).to(device,
                                                      memory_format=CL))
    param_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    bn = _bn(c, seed + 1, param_dtype).to(device)
    rbn = (_bn(c, seed + 2, param_dtype).to(device)
           if variant == "normalized residual" else None)
    return x, r, bn, rbn


def _unfused(x, bn, r=None, rbn=None):
    y = bn(x)
    if r is not None:
        y = y + (rbn(r) if rbn is not None else r)
    return F.relu(y)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-6)])
def test_plain_version_equals_the_unfused_eval_composition(variant, dtype,
                                                           tol):
    x, r, bn, rbn = _operands(variant, (3, 16, 2, 5, 7), dtype, seed=3)
    with torch.no_grad():
        got = bn_act.bn_act_plain(x, bn, r, rbn)
        ref = _unfused(x, bn, r, rbn)
    assert got.dtype == dtype
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=tol, atol=tol * scale)
    assert bool((got >= 0).all())


def _rule_case(case):
    x, r, bn, rbn = _operands("normalized residual", (2, 16, 2, 3, 4),
                              torch.float32)
    if case == "train mode":
        bn.train()
    elif case == "the residual's BatchNorm in train mode":
        rbn.train()
    elif case == "contiguous (not channels_last_3d) x":
        x = x.contiguous()
    elif case == "contiguous residual":
        r = r.contiguous()
    elif case == "C 12, not a multiple of 8":
        x, r, bn, rbn = _operands("normalized residual", (2, 12, 2, 3, 4),
                                  torch.float32)
    elif case == "float64":
        x, r = x.double(), r.double()
    elif case == "float16":
        x, r = x.half(), r.half()
    elif case == "residual of another type":
        r = r.to(torch.bfloat16)
    elif case == "float64 BatchNorm":
        bn.double()
    elif case == "x off 16 bytes":
        x = torch.empty(x.numel() + 1)[1:].view(2, 2, 3, 4, 16).permute(
            0, 4, 1, 2, 3)
    return x, r, bn, rbn


@pytest.mark.parametrize("case,engaged", [
    ("eval, no graph, channels_last_3d float32, C 16", True),
    ("train mode", False),
    ("the residual's BatchNorm in train mode", False),
    ("autograd recording", False),
    ("contiguous (not channels_last_3d) x", False),
    ("contiguous residual", False),
    ("C 12, not a multiple of 8", False),
    ("float64", False),
    ("float16", False),
    ("residual of another type", False),
    ("float64 BatchNorm", False),
    ("x off 16 bytes", False),
])
def test_routing_rule(case, engaged):
    """The rule asked for CUDA, of CPU tensors: every other condition is
    then the one that decides."""
    x, r, bn, rbn = _rule_case(case)
    with torch.set_grad_enabled(case == "autograd recording"):
        assert bn_act.engages(bn, "cuda", x, r, rbn) is engaged, case
        if case.startswith("eval"):
            assert bn_act.engages(bn, "cuda", x.to(torch.bfloat16))
            assert bn_act.engages(bn, "cuda", x, r)


def test_routing_rule_on_the_cpu():
    x, r, bn, rbn = _operands("normalized residual", (2, 16, 2, 3, 4),
                              torch.float32)
    with torch.no_grad():
        assert not bn_act.engages(bn, x.device.type, x, r, rbn)
        assert not bn_act.engages(bn, x.device.type, x)
        assert not bn_act.may_engage(bn, x.device.type)


def _old_basic(self, x):
    r = x if self.downsample is None else self.downsample(x)
    h = F.relu(self.bn1(self.conv1(x)))
    h = self.bn2(self.conv2(h))
    return F.relu(h + r)


def _old_bottleneck(self, x):
    r = x if self.downsample is None else self.downsample(x)
    h = F.relu(self.bn1(self.conv1(x)))
    h = F.relu(self.bn2(self.conv2(h)))
    h = self.bn3(self.conv3(h))
    return F.relu(h + r)


@pytest.fixture
def as_before(monkeypatch):
    """-> a context that runs the 3-D ResNet's blocks and stem as their
    forwards read before the fused pass existed."""

    @contextlib.contextmanager
    def ctx():
        with monkeypatch.context() as m:
            m.setattr(BasicBlock3d, "forward", _old_basic)
            m.setattr(Bottleneck3d, "forward", _old_bottleneck)
            m.setattr(resnet3d, "bn_act", types.SimpleNamespace(
                bn_relu=lambda h, bn: F.relu(bn(h))))
            yield
    return ctx


def _seeded_eval(module, seed):
    torch.manual_seed(seed)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.2)
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 2.0)
    return module.eval()


@pytest.mark.parametrize("block,in_ch,planes,stride,shortcut,layout", [
    ("basic", 16, 16, 1, "B", "channels_last_3d"),
    ("basic", 16, 32, 2, "B", "channels_last_3d"),
    ("basic", 16, 32, 2, "A", "contiguous"),
    ("bottleneck", 16, 8, 1, "B", "channels_last_3d"),
    ("bottleneck", 32, 8, 2, "B", "contiguous"),
])
def test_block_eval_forward_on_the_cpu_is_bitwise_as_before(
        as_before, block, in_ch, planes, stride, shortcut, layout):
    cls = BasicBlock3d if block == "basic" else Bottleneck3d
    torch.manual_seed(0)
    module = _seeded_eval(cls(in_ch, planes, stride, shortcut), 1)
    fmt = CL if layout == "channels_last_3d" else torch.contiguous_format
    module.to(memory_format=fmt)
    x = torch.randn(2, in_ch, 4, 6, 6).to(memory_format=fmt)
    launches = bn_act.LAUNCHES
    with torch.no_grad():
        got = module(x)
        with as_before():
            ref = module(x)
    assert torch.equal(got, ref)
    assert bn_act.LAUNCHES == launches


@pytest.mark.parametrize("depth,kwargs", [
    (18, dict(no_max_pool=True)),
    (10, dict(shortcut_type="A")),
    (50, dict(widen_factor=0.25)),
    (18, dict(no_max_pool=True, stem_s2d=True)),
])
@pytest.mark.parametrize("grad", [False, True])
def test_resnet3d_eval_forward_on_the_cpu_is_bitwise_as_before(
        as_before, depth, kwargs, grad):
    torch.manual_seed(0)
    model = _seeded_eval(generate_model(depth, hidden_layer=32, out_dim=8,
                                        conv1_t_size=3, **kwargs), 2)
    model.to(memory_format=CL)
    x = torch.randn(2, 4, 16, 16, 3)
    launches = bn_act.LAUNCHES
    with torch.set_grad_enabled(grad):
        got = model(x)
        with as_before():
            ref = model(x)
    assert torch.equal(got, ref)
    assert bn_act.LAUNCHES == launches == 0


@pytest.mark.parametrize("depth,kwargs,sites", [
    (18, dict(no_max_pool=True), 17),  # the stem, 2 a block for 8 blocks
    (50, dict(widen_factor=0.25), 49),  # the stem, 3 a block for 16 blocks
    (10, dict(shortcut_type="A"), 9),
    (18, dict(no_max_pool=True, stem_s2d=True), 16),  # s2d: the blocks'
])
def test_routed_epilogues_where_the_rule_holds(monkeypatch, depth, kwargs,
                                               sites):
    """With the rule asked for CUDA of the CPU tensors, every BatchNorm
    epilogue of an eval forward goes to the fused pass (here its plain
    version in place of the kernel): one a stem (none for ``stem_s2d``'s),
    one for each BatchNorm but the downsample's, which rides with the
    block's last. The result matches the unfused forward; a train-mode
    forward routes none."""
    calls = []
    plain = bn_act.bn_act_plain
    rule, may = bn_act.engages, bn_act.may_engage

    def counted(x, bn, residual=None, residual_bn=None, out=None):
        calls.append(residual_bn is not None)
        return out.copy_(plain(x, bn, residual, residual_bn))

    monkeypatch.setattr(bn_act, "engages",
                        lambda bn, device_type, *a: rule(bn, "cuda", *a))
    monkeypatch.setattr(bn_act, "may_engage",
                        lambda module, device_type: may(module, "cuda"))
    monkeypatch.setattr(bn_act, "bn_act_cuda", counted)
    torch.manual_seed(0)
    model = _seeded_eval(generate_model(depth, hidden_layer=32, out_dim=8,
                                        conv1_t_size=3, **kwargs), 3)
    model.to(memory_format=CL)
    x = torch.randn(2, 4, 16, 16, 3)
    with torch.no_grad():
        got = model(x)
        assert len(calls) == sites
        downsamples = sum(isinstance(getattr(m, "downsample", None),
                                     torch.nn.Sequential)
                          for m in model.modules())
        assert sum(calls) == downsamples
        with monkeypatch.context() as m:
            m.setattr(bn_act, "engages", lambda *a: False)
            ref = model(x)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert bn_act.LAUNCHES == 0
    calls.clear()
    model.train()
    model(x).square().sum().backward()
    assert not calls


# --- on the card ------------------------------------------------------------


def _bf16_unit(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (8 significand bits)."""
    _, e = torch.frexp(v.abs())
    return torch.ldexp(torch.ones_like(v), e - 8)


def _tolerance(ref: torch.Tensor) -> torch.Tensor:
    """bf16: one bf16 unit of each output, and a floor of 2^-16 of the
    largest where a near-zero output is the difference of larger terms
    (their float32 sums' last bit, which the kernel's fmaf and the plain
    version's multiply and add may round apart, then decides); float32:
    1e-6 of the largest output."""
    f = ref.float()
    top = float(f.abs().max()) if f.numel() else 0.0
    if ref.dtype == torch.bfloat16:
        return _bf16_unit(f) + 2.0 ** -16 * top
    return torch.full_like(f, 1e-6 * top)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_version_on_the_card(dtype, c, variant,
                                                  inplace):
    """A ragged N x T x H x W (rows no multiple of a block's tile): within
    ``_tolerance`` of the plain version."""
    _needs_card()
    x, r, bn, rbn = _operands(variant, (5, c, 3, 7, 9), dtype, seed=c,
                              device="cuda")
    with torch.no_grad():
        ref = bn_act.bn_act_plain(x, bn, r, rbn)
        launches = bn_act.LAUNCHES
        got = bn_act.bn_act_cuda(x, bn, r, rbn, out=x if inplace else None)
    torch.cuda.synchronize()
    assert bn_act.LAUNCHES == launches + 1
    assert (got is x) == inplace
    assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
    err = (got.float() - ref.float()).abs()
    assert bool((err <= _tolerance(ref)).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((3, 24, 2, 5, 5), torch.bfloat16),      # 3 channel groups a row
    ((2, 2056, 1, 3, 3), torch.bfloat16),    # 257 groups: 2 spans
    ((2, 2048, 1, 3, 3), torch.float32),     # 512 groups: 2 spans
    ((9, 64, 16, 32, 32), torch.bfloat16),   # many grid-stride rounds
    ((0, 64, 2, 3, 3), torch.bfloat16),      # empty
])
def test_kernel_takes_other_widths_on_the_card(shape, dtype):
    _needs_card()
    x, r, bn, rbn = _operands("normalized residual", shape, dtype, seed=7,
                              device="cuda")
    with torch.no_grad():
        ref = bn_act.bn_act_plain(x, bn, r, rbn)
        got = bn_act.bn_act_cuda(x, bn, r, rbn)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    assert bool((err <= _tolerance(ref)).all())


@pytest.mark.gpu
def test_r3d18_eval_forward_launches_17_and_a_train_step_none():
    _needs_card()
    torch.manual_seed(0)
    model = _seeded_eval(generate_model(18, no_max_pool=True), 4).cuda().to(
        memory_format=CL)
    x = torch.randn(4, 16, 64, 64, 3, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        def compute():
            return (torch.autocast("cuda", dtype=dtype)
                    if dtype != torch.float32 else contextlib.nullcontext())

        before = bn_act.LAUNCHES
        with torch.inference_mode(), compute():
            got = model(x).float()
        assert bn_act.LAUNCHES == before + 17, dtype
        with torch.inference_mode(), compute(), \
                pytest.MonkeyPatch.context() as m:
            m.setattr(bn_act, "engages", lambda *a: False)
            ref = model(x).float()
        assert bn_act.LAUNCHES == before + 17
        cos = F.cosine_similarity(got, ref, dim=1)
        assert float(cos.min()) > 1 - (1e-3 if dtype == torch.bfloat16
                                       else 1e-6), dtype
    before = bn_act.LAUNCHES
    with torch.autocast("cuda", dtype=torch.bfloat16):
        model(x).float().square().sum()  # eval mode, autograd recording
    model.train()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        model(x).float().square().sum().backward()
    torch.cuda.synchronize()
    assert bn_act.LAUNCHES == before


@pytest.mark.gpu
def test_s2d_stem_keeps_its_own_calls_on_the_card():
    """``stem_s2d``'s stem output is a crop of its convolution's: its
    BatchNorm and ReLU stay the modules' calls, the blocks' 16 epilogues
    take the fused pass, and the forward matches the unfused one."""
    _needs_card()
    torch.manual_seed(0)
    model = _seeded_eval(generate_model(18, no_max_pool=True,
                                        stem_s2d=True), 5).cuda().to(
        memory_format=CL)
    x = torch.randn(4, 16, 64, 64, 3, device="cuda")
    before = bn_act.LAUNCHES
    with torch.inference_mode(), torch.autocast("cuda",
                                                dtype=torch.bfloat16):
        got = model(x).float()
        assert bn_act.LAUNCHES == before + 16
        with pytest.MonkeyPatch.context() as m:
            m.setattr(bn_act, "engages", lambda *a: False)
            ref = model(x).float()
    assert bn_act.LAUNCHES == before + 16
    cos = F.cosine_similarity(got, ref, dim=1)
    assert float(cos.min()) > 1 - 1e-3


@pytest.mark.gpu
def test_a_profile_links_the_kernel_to_its_op():
    """The launch is the op ``BnAct``, so per-op device times (the
    benchmark's span readers) count the kernel."""
    _needs_card()
    from torch.profiler import ProfilerActivity, profile
    x, r, bn, _ = _operands("residual", (2, 64, 2, 8, 8), torch.bfloat16,
                            device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            bn_act.bn_act_cuda(x, bn, r)
        torch.cuda.synchronize()
    linked = [k.name for e in prof.events() if e.name == "BnAct"
              for k in e.kernels]
    assert any("bn_act_kernel" in name for name in linked), linked
