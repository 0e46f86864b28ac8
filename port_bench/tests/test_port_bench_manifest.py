"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found by its name."""

import json
import math
import os
import re

import pytest

from port_bench import run

ROOT = run.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expan|per_tok|width)", re.I)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["command"][0] == "python3"
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    n = 24  # the most cells a benchmark may grow to
    budget = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200
    assert budget <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)


def test_workloads_find_their_files():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        data = os.path.join(run.HERE, "workloads", w["name"] + ".json")
        with open(data) as f:
            spec = json.load(f)
        assert spec["config"] == w["config"]
        assert spec["traffic"] == w["traffic"]
        assert os.path.isfile(os.path.join(run.HERE, "traffic",
                                           w["traffic"] + ".py"))
        assert spec["limits"] and all(
            math.isfinite(v) for v in spec["limits"].values())


def test_metrics():
    e2e = BENCH["end_to_end"]
    layers = BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in e2e:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in e2e if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    reported = {c: {m["name"] for m in e2e if c in m.get("workloads", [c])}
                for c in cells}
    for c in cells:
        assert "setup_s" in reported[c] and len(reported[c]) >= 2
        assert run.cell_metrics(BENCH, c, "per_layer")
    layer_names = {}
    for m in layers:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        for c in m.get("workloads", cells):
            assert m["moves"] in reported[c], (m["name"], c)
        assert os.path.isfile(run.metric_file(m["name"]))
        assert callable(run.load_metric(m["name"]).read)
        layer_names.setdefault(m["layer"], m["layer"])


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_holds_the_configuration(name):
    """Each configuration file's overrides give the program's config the
    configuration states (the R3D-18 one equals the repo's UCF yaml)."""
    from port_bench import common
    from video_similarity_search_tpu_torch.config import (arg_parser,
                                                          load_config)

    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    cfg = common.port_cfg(common.Ctx(workload={}, config=config, seed=0,
                                     seconds=0, trace=False, device=None))
    if name == "r3d18_slic":
        yaml = os.path.join(ROOT, "configs",
                            "resnet_ucf_itercluster_flow.yaml")
        want = load_config(arg_parser().parse_args(["--cfg", yaml]))
        # the data paths are the fed cell's store's, set at run time
        want.OUTPUT_PATH = cfg.OUTPUT_PATH
        for key in ("VID_PATH", "ANNOTATION_PATH", "OPTICAL_U_PATH"):
            want.DATASET[key] = cfg.DATASET[key]
        assert cfg.to_dict() == want.to_dict()
    assert list(config["clip"][:1]) == [cfg.DATA.SAMPLE_DURATION]
    assert config["clip"][1] == cfg.DATA.SAMPLE_SIZE
    assert config["batch_anchors"] == cfg.TRAIN.BATCH_SIZE
    assert config["compute_dtype"] == cfg.TPU.COMPUTE_DTYPE


@pytest.mark.parametrize("name,stem", [
    ("device_idle_pct.embed", "device_idle_pct"),
    ("device_idle_pct.fed", "device_idle_pct"),
    ("augment_ms.slowfast", "augment_ms"),
    ("train_step_mfu", "train_step_mfu"),
    ("loader_wait_ms", "loader_wait_ms"),
])
def test_metric_reader_is_found_by_name_or_its_stem(name, stem):
    """A metric without a file of its own is read by that of its name
    less the last dotted part; a name with no reader at all is an error."""
    assert run.metric_file(name) == os.path.join(run.HERE, "layer_metrics",
                                                 stem + ".py")


def test_metric_without_a_reader_is_refused():
    with pytest.raises(FileNotFoundError):
        run.metric_file("no_such_metric.train")
