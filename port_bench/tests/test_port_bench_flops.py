"""The frozen FLOP counts."""

import pytest

from port_bench import flops
from port_bench.tests._tiny import BENCH


def test_r3d18_forward_is_111_24_gflop():
    c = flops.resnet3d_flops_per_clip(depth=18, t=16, size=128)
    assert round(c["forward"] / 1e9, 2) == 111.24
    assert round(c["first"] / 1e9, 2) == 8.63


def test_hooks_over_the_reference_agree_with_the_formula():
    config = {"reference": "r3d18",
              "flops": {"count": "hooks", "frames": 16, "size": 128}}
    hooked = flops.clip_flops(config)
    formula = flops.clip_flops({"reference": "r3d18", "flops": {
        "count": "resnet3d", "depth": 18, "frames": 16, "size": 128}})
    assert hooked == formula


def test_slowfast50_counts():
    config = {"reference": "slowfast50",
              "flops": {"count": "hooks", "frames": 8, "size": 224,
                        "alpha": 4}}
    c = flops.clip_flops(config)
    assert 20e9 < c["forward"] < 60e9
    assert c["train"] == 3 * c["forward"] - c["first"]


def test_slowfast50_matches_the_published_count():
    """The paper gives SlowFast 8x8 R50 65.7 GFLOPs (multiply-adds) a view
    of 256x256; at 224x224 and two FLOPs a multiply-add that is 100.6."""
    config = {"reference": "slowfast50",
              "flops": {"count": "hooks", "frames": 32, "size": 224,
                        "alpha": 4}}
    want = 2 * 65.7e9 * (224 / 256) ** 2
    assert abs(flops.clip_flops(config)["forward"] / want - 1) < 0.01


def test_peak_table():
    assert flops.bf16_peak("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(ValueError):
        flops.bf16_peak("cpu")


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_each_configuration_counts(name):
    import json
    import os

    from port_bench import run

    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    with open(os.path.join(run.ROOT, conf["file"])) as f:
        c = flops.clip_flops(json.load(f))
    assert 0 < c["first"] < c["forward"] < c["train"]
