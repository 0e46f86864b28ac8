"""The port's config parser against the JAX package's (mirrors
tests/test_config.py): for every shipped YAML, with trailing opts and
explicit flags, both give the same merged config key for key."""

import glob
import os

import pytest

from video_similarity_search_tpu.config import arg_parser as j_parser
from video_similarity_search_tpu.config import load_config as j_load
from video_similarity_search_tpu_torch.config import arg_parser as t_parser
from video_similarity_search_tpu_torch.config import load_config as t_load

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
YAMLS = sorted(glob.glob(os.path.join(CONFIGS, "*.yaml")))

FLAGS = ["--batch_size", "8", "--epoch", "3", "--output", "/tmp/out",
         "--num_data_workers", "2", "--sample_size", "112",
         "--sampling_strategy", "fixed_semi_hard", "--val_metric",
         "local_batch", "--val_batch_size", "40", "--n_classes", "51"]
OPTS = ["TRAIN.EPOCHS", "5", "LOSS.DIST_METRIC", "euclidean",
        "ITERCLUSTER.ADAPTIVEP", "True", "TRAIN.BATCH_SIZE", "64",
        "DATA.SAMPLE_DURATION", "8"]


def _both(argv):
    return (j_load(j_parser().parse_args(argv)).to_dict(),
            t_load(t_parser().parse_args(argv)).to_dict())


def test_every_shipped_yaml_is_covered():
    assert len(YAMLS) == 5


@pytest.mark.parametrize("yaml_path", YAMLS, ids=os.path.basename)
@pytest.mark.parametrize("extra", [[], FLAGS, FLAGS + OPTS],
                         ids=["yaml", "flags", "flags+opts"])
def test_load_config_matches_jax(yaml_path, extra):
    j, t = _both(["--cfg", yaml_path] + extra)
    assert t == j


def test_precedence_defaults_yaml_opts_flags():
    path = os.path.join(CONFIGS, "resnet_hmdb.yaml")
    argv = ["--cfg", path, "--batch_size", "8", "TRAIN.EPOCHS", "5",
            "TRAIN.BATCH_SIZE", "64"]
    j, t = _both(argv)
    assert t == j
    assert t["TRAIN"]["DATASET"] == "hmdb51"   # YAML beats defaults
    assert t["TRAIN"]["EPOCHS"] == 5           # opts beat YAML
    assert t["TRAIN"]["BATCH_SIZE"] == 8       # a flag beats all


def test_device_flag_defaults_to_cuda_and_is_not_a_config_key():
    args = t_parser().parse_args([])
    assert args.device == "cuda"
    args = t_parser().parse_args(["--device", "cpu", "TRAIN.EPOCHS", "2"])
    assert args.device == "cpu" and args.opts == ["TRAIN.EPOCHS", "2"]
    assert "DEVICE" not in t_load(args)
    # every flag of the JAX parser parses the same in the port's
    j_flags = {a.dest for a in j_parser()._actions}
    t_flags = {a.dest for a in t_parser()._actions}
    assert t_flags == j_flags | {"device"}
