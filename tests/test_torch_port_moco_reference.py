"""The port's MoCo UberNCE step (``train/steps.py::make_moco_train_step``
over ``models/moco.py``) against the benchmark's plain reference
(``port_bench/reference/moco_s3d.py``), on the CPU from seeded random
weights and a seeded labelled queue: 4 pairs of 8x32x32 clips, K 16 (so
three steps fill the queue past its first row and the labels put
positives in it), Adam at lr 1e-3 with weight decay 1e-5, three steps.

Both run their networks in float64, as the repository's S3D parity tests
do (S3D's Mixed_5 BatchNorms amplify float32 summation order at small
sizes); the embeddings, logits, loss and queue are float32 on both sides,
as in the program. Checked: the first step's logits and every step's loss,
the first gradient (Adam's first moment over 1 - beta1), the query
parameters after the first two Adam updates, the key parameters after
the first two momentum updates, the enqueued keys, the pointer and the
labels.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import common  # noqa: E402
from port_bench.reference import moco_s3d as ref  # noqa: E402
from video_similarity_search_tpu_torch.config import get_cfg  # noqa: E402
from video_similarity_search_tpu_torch.models import \
    model_selector  # noqa: E402
from video_similarity_search_tpu_torch.train.state import \
    make_optimizer  # noqa: E402
from video_similarity_search_tpu_torch.train.steps import (  # noqa: E402
    make_banks, make_moco_train_step)

B, T, S, K, CLASSES, STEPS = 4, 8, 32, 16, 3, 3
SEED = 2 ** 31 + 15
# float64 networks: only the float32 logits, loss and queue round, alike
# on both sides; what is left is the order of float64 sums. S3D at random
# init amplifies it from step to step: the parameters are 1e-16 apart
# after the first update, 1e-10 after the second and up to 5e-7 after
# the third (Adam's rescaling of near-zero gradients), so the parameters
# are held after the first two updates, to a hundred-thousandth of an
# update of lr 1e-3, and the third step by its loss, keys and queue
TOL = 1e-6
UPDATE_TOL = 1e-8


@pytest.fixture(scope="module")
def runs():
    torch.manual_seed(0)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield _runs()
    finally:
        torch.set_num_threads(n)


def _cfg():
    cfg = get_cfg()
    cfg.merge_from_list([str(v) for v in [
        "MODEL.ARCH", "uber_nce", "LOSS.TYPE", "UberNCE", "LOSS.K", K,
        "LOSS.FEAT_DIM", 128, "OPTIM.OPTIMIZER", "adam", "OPTIM.LR", 0.001,
        "OPTIM.WD", 0.00001, "TRAIN.BATCH_SIZE", B,
        "DATA.SAMPLE_DURATION", T, "DATA.SAMPLE_SIZE", S,
        "TPU.COMPUTE_DTYPE", "float32"]])
    return cfg


def _runs():
    cpu = torch.device("cpu")
    cfg = _cfg()
    model = model_selector(cfg)
    state = common.seeded_state(model.state_dict(), SEED, cpu)
    model.load_state_dict(state)
    model.double()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    bank = make_banks(cfg, 0, model)["moco"]
    g = torch.Generator().manual_seed(SEED)
    queue = torch.randn(K, 128, generator=g)
    queue = queue / queue.norm(dim=1, keepdim=True)
    queue_labels = torch.randint(0, CLASSES, (K,), generator=g)
    bank.queue.copy_(queue)
    bank.queue_labels.copy_(queue_labels)
    batches = [{"x1": torch.rand(B, T, S, S, 3, generator=g,
                                 dtype=torch.float64),
                "x2": torch.rand(B, T, S, S, 3, generator=g,
                                 dtype=torch.float64),
                "labels": torch.randint(0, CLASSES, (B,), generator=g)}
               for _ in range(STEPS)]
    opt, sched = make_optimizer(cfg, model.parameters())
    step = make_moco_train_step(cfg, model, opt, sched, bank, uber=True,
                                device=cpu)
    names = dict(model.named_parameters())
    prog = {"loss": [], "query": [], "key": [], "queries": []}
    hook = model.register_forward_hook(
        lambda m, i, o: prog["queries"].append(o.detach().float()))
    for i, batch in enumerate(batches):
        m = step({"x1": batch["x1"], "x2": batch["x2"],
                  "label": batch["labels"]})
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            hook.remove()
            prog["grad1"] = {k: opt.state[p]["exp_avg"] / 0.1
                             for k, p in names.items()}
        prog["query"].append({k: p.detach().clone()
                              for k, p in names.items()})
        prog["key"].append({"encoder_q." + k: p.detach().clone()
                            for k, p in bank.encoder_k.named_parameters()})
    prog["queue"] = bank.queue.clone()
    prog["queue_labels"] = bank.queue_labels.clone()
    prog["queue_ptr"] = int(bank.queue_ptr)
    prog["queue0"] = queue
    spec = {"size": S, "dataset": "ucf101", "lr": 0.001, "wd": 0.00001,
            "dtype": torch.float64}
    refs = [ref.run_steps(state, queue, queue_labels, batches[:n],
                          [0] * n, spec, cpu) for n in range(1, STEPS + 1)]
    return prog, refs


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_first_logits_and_every_loss(runs):
    prog, refs = runs
    q = ref.l2norm(prog["queries"][0])
    logits = torch.cat([(q * prog["queue"][:B]).sum(1, keepdim=True),
                        q @ prog["queue0"].T], dim=1) / ref.T_MOCO
    assert _rel(logits, refs[0]["logits1"]) < TOL
    np.testing.assert_allclose(prog["loss"], refs[-1]["loss"], rtol=TOL)


def test_first_gradient(runs):
    prog, refs = runs
    for k, g in prog["grad1"].items():
        assert float(g.norm()) == pytest.approx(refs[0]["grad1"][k],
                                                rel=TOL, abs=1e-12), k


@pytest.mark.parametrize("n", [1, 2])
def test_adam_and_momentum_updates(runs, n):
    """The query parameters after the n-th Adam update and the key
    parameters after the n-th momentum update (from the updated query)."""
    prog, refs = runs
    for side in ("query", "key"):
        got, want = prog[side][n - 1], refs[n - 1][side]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=UPDATE_TOL,
                                       err_msg=f"{side} {k} step {n}")


def test_enqueued_keys_pointer_and_labels(runs):
    prog, refs = runs
    n = STEPS * B
    np.testing.assert_allclose(prog["queue"][:n].numpy(),
                               refs[-1]["keys"].numpy(), rtol=0, atol=TOL)
    np.testing.assert_array_equal(prog["queue"][n:].numpy(),
                                  prog["queue0"][n:].numpy())
    assert prog["queue_ptr"] == refs[-1]["queue_ptr"] == n % K
    assert torch.equal(prog["queue_labels"], refs[-1]["queue_labels"])
