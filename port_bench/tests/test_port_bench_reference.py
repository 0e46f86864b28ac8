"""The plain reference against the program at tiny sizes on the CPU: the
encoders' forward and gradient on the same weights, the augmentation and
the triplet loss on the same draws."""

import numpy as np
import pytest
import torch

from port_bench import common
from port_bench.reference import models
from port_bench.reference import triplet as ref


def _pair(arch):
    from video_similarity_search_tpu_torch.models.resnet3d import \
        generate_model
    from video_similarity_search_tpu_torch.models.slowfast import SlowFast

    prog = (generate_model(18, n_input_channels=3, shortcut_type="B",
                           conv1_t_size=7, conv1_t_stride=1,
                           no_max_pool=True) if arch == "r3d18"
            else SlowFast(depth=50))
    reference = models.build(arch)
    state = common.seeded_state(prog.state_dict(), 5, torch.device("cpu"))
    assert set(state) == set(reference.state_dict())
    prog.load_state_dict(state)
    reference.load_state_dict(state)
    return prog.double(), reference.double()


@pytest.mark.parametrize("arch", ["r3d18", "slowfast50"])
@pytest.mark.parametrize("train", [False, True])
def test_encoder_matches_the_program(arch, train):
    from video_similarity_search_tpu_torch.models.slowfast import \
        multipathway_input

    torch.set_num_threads(4)
    prog, reference = _pair(arch)
    prog.train(train)
    reference.train(train)
    shape = (4, 4, 16, 16, 3) if arch == "r3d18" else (4, 8, 32, 32, 3)
    clips = torch.randn(shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(1))
    if arch == "slowfast50":
        a = prog(multipathway_input(clips, 4))
        b = reference(models.slow_fast_input(clips, 4))
    else:
        a, b = prog(clips), reference(clips)
    torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    if train:
        w = torch.randn_like(a)
        (a * w).sum().backward()
        (b * w).sum().backward()
        gp = dict(prog.named_parameters())
        for k, p in reference.named_parameters():
            torch.testing.assert_close(gp[k].grad, p.grad, rtol=1e-7,
                                       atol=1e-9)


@pytest.mark.parametrize("pre_cropped", [True, False])
def test_augment_matches_the_program(pre_cropped):
    from video_similarity_search_tpu_torch.data.augment import train_augment

    hw = 16 if pre_cropped else 40
    x = torch.randint(0, 256, (6, 4, hw, hw, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(2))
    for seed in range(4):
        a = train_augment(x, torch.Generator().manual_seed(seed), 16,
                          pre_cropped=pre_cropped)
        g = torch.Generator().manual_seed(seed)
        b = ref.augment(x, ref.draw_params(
            g, 6, None if pre_cropped else (hw, hw)), 16, "ucf101")
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_triplet_loss_matches_the_program():
    from video_similarity_search_tpu_torch.losses import (llc_loss,
                                                          online_triplet_loss)

    g = torch.Generator().manual_seed(3)
    emb = torch.randn(24, 16, generator=g, dtype=torch.float64)
    labels = torch.randint(0, 4, (8,), generator=g)
    targets = torch.cat([labels, labels])
    a, _, picks = online_triplet_loss(
        emb[:16], targets, margin=0.2, dist_metric="cosine",
        sampling_strategy="random_semi_hard",
        generator=torch.Generator().manual_seed(9))
    b, own, gap = ref.triplet_loss(emb[:16].float(), targets, 0.2,
                                   torch.Generator().manual_seed(9))
    np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    assert torch.equal(own, picks) and float(gap) == 0.0
    # the program's picks judged: equal picks give no gap; a pick moved
    # to another candidate is judged by its distance to the boundary
    b2, _, gap = ref.triplet_loss(emb[:16].float(), targets, 0.2,
                                  torch.Generator().manual_seed(9),
                                  picks=picks)
    assert float(b2) == float(b) and float(gap) == 0.0
    moved = (picks + 1) % 16
    _, _, gap = ref.triplet_loss(emb[:16].float(), targets, 0.2,
                                 torch.Generator().manual_seed(9),
                                 picks=moved)
    assert float(gap) > 0.01
    c = llc_loss(emb[:8], emb[8:16], emb[16:], 0.04, "cosine")
    d = ref.local_local(emb[:8], emb[8:16], emb[16:], 0.04)
    np.testing.assert_allclose(float(c), float(d), rtol=1e-6)


def test_step_seed_is_the_programs():
    from video_similarity_search_tpu_torch.train.driver import step_seed

    for epoch, step in [(0, 0), (3, 7), (2 * (2 ** 31 + 5), 2)]:
        assert ref.step_seed(epoch, step) == step_seed(epoch, step)


def test_fp8_rounds_to_e4m3_under_a_scale():
    from port_bench.reference.precision import fp8

    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    y = fp8(x)
    assert abs(float(y.abs().max()) - 3.0) < 1e-6
    assert len(torch.unique(y)) < 256
    assert float((y - x).abs().max()) < 3.0 / 8
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
