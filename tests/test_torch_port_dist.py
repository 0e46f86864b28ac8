"""The port's data-parallel pretrain (``video_similarity_search_tpu_torch.
parallel``) on the CPU: ranks are processes started with
``torch.multiprocessing`` that meet over gloo on localhost, each joined
with its own time limit so a fault cannot hang the suite.

The invariant: W ranks, each fed its B / W rows, step as the 1-rank port
fed the assembled global batch of B (whose accumulation microbatch a is
every rank's microbatch a, in rank order), and after every step their
parameters, statistics and banks are bit-identical.

* (a) the flax-variant synced BatchNorm / BatchNorm1d at world 2 against
  ``layers.BatchNorm`` on the concatenated batch: output, running
  statistics, input and affine gradients; SubBatchNorm with a group that
  spans both ranks;
* (b) two triplet steps at world 2 (augmentation and mining drawn from
  the generator) against 1 rank: random_semi_hard, TRAIN.ACCUM_STEPS 2
  and LOSS.MEM_TRIPLET; and the world-2 step against the JAX step on a
  2-device mesh of the suite's virtual CPU devices, the Gumbel draws
  injected (hazard H2), at ``test_torch_port_train_step.py``'s
  tolerances;
* (c) the contrastive step (NCE banks with the intra-negative view, and
  MemoryMoCo) and the UberNCE step at world 2 against 1 rank: banks,
  queue, pointer and the key encoder's update;
* (d) a 2-epoch ``--iterative_cluster`` run of the training CLI at world
  2 (``--num_shards 2``): parameters bit-identical across ranks, the same
  NMI on both, the JAX CLI's files written once (by rank 0), and a resume
  launched as ``--gpu 0,1 --device cpu``;
* (e) the JAX package's multi-host ``targets`` layout: its per-host
  collate concatenated process by process, as ``shard_batch`` assembles
  a multi-host batch, puts labels beside the wrong embeddings (ROADMAP
  Queue 3); the port's gathered layout does not.

Tolerances, world 2 against 1 rank: the steps run their networks in
float64 (the losses and banks stay float32, as in both packages) and
agree within 1e-9 on parameters, statistics, banks and losses: only the
order of the sums differs. (In float32 the R3D stem's weight gradient,
which sums terms that mostly cancel, moves by up to ~1e-3 of an update
at ACCUM_STEPS 2, as two float32 summation orders do on one device.) The
second UberNCE step is held within 1e-6: S3D at random init amplifies
the first step's rounding ~1e3-fold. The BatchNorm layers run in float32
within 1e-5.
"""

import os
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from video_similarity_search_tpu_torch import parallel
from video_similarity_search_tpu_torch.config import get_cfg
from video_similarity_search_tpu_torch.models import layers, model_selector
from video_similarity_search_tpu_torch.train.driver import (_device_batch,
                                                            step_seed)
from video_similarity_search_tpu_torch.train.state import make_optimizer
from video_similarity_search_tpu_torch.train.steps import (
    make_banks, make_contrastive_train_step, make_moco_train_step,
    make_triplet_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
JOIN_S = 240  # each group of ranks, start to finish
RANK_TIMEOUT = timedelta(seconds=120)  # rendezvous and each collective
TOL = 1e-9  # the float64 steps
BN_TOL = 1e-5  # the float32 BatchNorm layers
UBERNCE_SECOND_STEP_TOL = 1e-6
STEP_DTYPE = torch.float64
T, S, IN = 4, 16, 20  # frames, crop, uint8 clip side before the crop
B = 4  # global anchors
TRIPLET = ["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 10,
           "RESNET.NO_MAX_POOl", True, "RESNET.HIDDEN_LAYER", 32,
           "RESNET.OUT_DIM", 8, "DATA.SAMPLE_DURATION", T,
           "DATA.SAMPLE_SIZE", S, "TPU.COMPUTE_DTYPE", "float32",
           "LOSS.LOCAL_LOCAL_CONTRAST", True,
           "DATASET.SAMPLING_STRATEGY", "random_semi_hard",
           "TRAIN.BATCH_SIZE", B, "OPTIM.LR", 0.1, "OPTIM.MOMENTUM", 0.5]
N_DATA = 12  # the NCE banks' rows


# -- running ranks ---------------------------------------------------------

def _rank_entry(rank, fn, world, port, out_dir, args, join_group):
    torch.set_num_threads(2)
    if join_group:
        parallel.initialize_distributed(f"tcp://127.0.0.1:{port}", world,
                                        rank, backend="gloo",
                                        timeout=RANK_TIMEOUT)
    try:
        out = fn(rank, world, port, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        parallel.destroy()


def _ranks(fn, out_dir, *args, world=WORLD, join_group=True):
    """Run ``fn(rank, world, port, *args)`` on ``world`` processes (in a
    gloo group when ``join_group``) -> their results in rank order. Every
    process is gone when this returns: a group that outlives JOIN_S is
    killed and the test fails."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(
        _rank_entry, args=(fn, world, parallel.free_port(), out_dir, args,
                           join_group),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"{fn.__name__}: ranks still running after "
                            f"{JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _cases_worker(rank, world, port, cases):
    """Several runs in one group: ``cases`` maps a name to (the name of a
    module-level ``run(*args, rank=, world=)``, args)."""
    return {name: globals()[fn](*args, rank=rank, world=world)
            for name, (fn, args) in cases.items()}


def _rank_rows(x, rank, world, accum=1, parts=1):
    """Rank's rows of a global leaf of ``parts`` x B rows, laid out as the
    loaders of W ranks feed it: global microbatch a is every rank's
    microbatch a in rank order, and ``targets`` (parts=2) is [anchor
    labels; positive labels] on every rank."""
    x = np.asarray(x)
    rest = x.shape[1:]
    return x.reshape((parts, accum, world, -1) + rest)[:, :, rank].reshape(
        (-1,) + rest)


def _local(batch, rank, world, accum=1):
    return {k: _rank_rows(v, rank, world, accum, 2 if k == "targets" else 1)
            for k, v in batch.items()}


def _cfg(opts):
    cfg = get_cfg()
    cfg.merge_from_list(list(opts))
    return cfg


def _model(cfg, init):
    model = model_selector(cfg)
    model.load_state_dict(init)
    return model.to(STEP_DTYPE)


def _device_views(batch, cfg, gen, accum=1):
    """The driver's device batch, its clips in the networks' dtype."""
    dev = _device_batch(batch, cfg, gen, train=True, device="cpu",
                        accum=accum)
    return {k: v.to(STEP_DTYPE) if v.is_floating_point() else v
            for k, v in dev.items()}


def _init(cfg):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return model_selector(cfg).state_dict()


def _assert_same(a, b, what):
    """Bit-identical state dicts (nested dicts of tensors)."""
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], dict):
            _assert_same(a[k], b[k], f"{what}.{k}")
        else:
            assert torch.equal(a[k], b[k]), f"{what}.{k}"


def _assert_close(got, want, what, tol=TOL):
    assert got.keys() == want.keys(), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_close(got[k], want[k], f"{what}.{k}", tol)
        else:
            np.testing.assert_allclose(
                got[k].double().numpy(), want[k].double().numpy(),
                rtol=0, atol=tol, err_msg=f"{what}.{k}")


def _uint8_batch(rng, views=("anchor", "positive", "extra"), clip=(T, IN)):
    t, side = clip
    out = {v: rng.integers(0, 256, (B, t, side, side, 3), np.uint8)
           for v in views}
    # both labels in each half, so each accumulation microbatch mines
    labels = np.array([0, 1, 1, 0])
    out["targets"] = np.concatenate([labels, labels]).astype(np.int64)
    out["index"] = rng.choice(N_DATA, B, replace=False).astype(np.int64)
    return out


# -- (a) synced BatchNorm ----------------------------------------------------

BN_CASES = {"bn3d": (6, (3, T, 5, 5)), "bn1d": (6, (16,)),
            "sub_bn": (6, (3, T, 5, 5))}  # 3 groups of 2: one spans ranks


def _bn_layer(kind, channels):
    if kind == "bn1d":
        return layers.BatchNorm1d(channels)
    if kind == "sub_bn":
        return layers.SubBatchNorm(channels, num_splits=3)
    return layers.BatchNorm(channels)


def _bn_run(kind, xs, dys, rank=0, world=1):
    """Two train-mode forwards and backwards of rank's rows; the affine
    gradients summed over ranks (``sum_gradients``)."""
    n, shape = BN_CASES[kind]
    bn = _bn_layer(kind, shape[0])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, shape[0]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, shape[0]))
    bn.train()
    out = []
    for x, dy in zip(xs, dys):
        x = torch.from_numpy(_rank_rows(x, rank, world)).requires_grad_()
        bn.zero_grad()
        y = bn(x)
        y.backward(torch.from_numpy(_rank_rows(dy, rank, world)))
        parallel.sum_gradients(bn.parameters())
        out.append({"y": y.detach(), "dx": x.grad,
                    "dweight": bn.weight.grad, "dbias": bn.bias.grad,
                    "running_mean": bn.running_mean.clone(),
                    "running_var": bn.running_var.clone()})
    return out


def _bn_inputs(kind):
    n, shape = BN_CASES[kind]
    rng = np.random.default_rng(0)
    xs = [rng.normal(0.3, 1.2, (n,) + shape).astype(np.float32)
          for _ in range(2)]
    dys = [rng.normal(size=(n,) + shape).astype(np.float32)
           for _ in range(2)]
    return xs, dys


def _collectives_run(rank=0, world=1):
    """The helpers at world 2, rank r holding rows [r, r + 1] of a 4-row
    global batch."""
    x = torch.tensor([[1.0 + 2 * rank], [2.0 + 2 * rank]],
                     requires_grad=True)
    g = parallel.gather_rows(x)
    (g * torch.arange(1.0, 5.0)[:, None]).sum().backward()
    # [anchor targets; positive targets] of each rank, gathered by part
    parts = parallel.gather_parts(torch.tensor([10 * rank, 10 * rank + 1,
                                                10 * rank + 2,
                                                10 * rank + 3]), 2)
    # all_reduce_sum's contract: each rank back-propagates its own share
    # (r + 1) total of the global loss sum_r (r + 1) total = 3 total
    y = torch.tensor([1.0 + rank], requires_grad=True)
    total = parallel.all_reduce_sum(y * y)
    ((rank + 1) * total).backward()
    # SubBatchNorm over 6 items, 3 a rank, in groups of 2: items 2 and 3
    # span the ranks
    sub = layers.SubBatchNorm(1, num_splits=3).train()
    sub(torch.arange(3.0).reshape(3, 1, 1, 1, 1) + 3 * rank)
    module = torch.nn.Linear(2, 2)
    with torch.no_grad():
        module.weight.fill_(rank)
    parallel.broadcast_module(module)
    return {"gathered": g.detach(), "x_grad": x.grad, "parts": parts,
            "y_grad": y.grad, "sub_mean": sub.running_mean.clone(),
            "agree_rank": parallel.agree(rank), "agree_one": parallel.agree(1),
            "weight": module.weight.detach().clone()}


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    """Every BatchNorm case and the collectives, in one world-2 group."""
    cases = {kind: ("_bn_run", (kind,) + _bn_inputs(kind))
             for kind in BN_CASES}
    cases["collectives"] = ("_collectives_run", ())
    return _ranks(_cases_worker, tmp_path_factory.mktemp("bn"), cases)


@pytest.mark.parametrize("kind", sorted(BN_CASES))
def test_synced_batchnorm_matches_the_global_batch(kind, bn_ranks):
    want = _bn_run(kind, *_bn_inputs(kind))
    got = [r[kind] for r in bn_ranks]
    for step in range(2):
        per_rank = [g[step] for g in got]
        for k in ("dweight", "dbias", "running_mean", "running_var"):
            assert torch.equal(per_rank[0][k], per_rank[1][k]), k
            np.testing.assert_allclose(per_rank[0][k].numpy(),
                                       want[step][k].numpy(), atol=BN_TOL,
                                       err_msg=f"step {step} {k}")
        for k in ("y", "dx"):
            joined = torch.cat([g[k] for g in per_rank])
            np.testing.assert_allclose(joined.numpy(), want[step][k].numpy(),
                                       atol=BN_TOL,
                                       err_msg=f"step {step} {k}")


def test_collectives_at_world_2(bn_ranks):
    for rank, r in enumerate(bn_ranks):
        g = r["collectives"]
        assert g["gathered"].flatten().tolist() == [1.0, 2.0, 3.0, 4.0]
        # the gathered rows' gradient, this rank's slice of it
        assert g["x_grad"].flatten().tolist() == [1.0 + 2 * rank,
                                                  2.0 + 2 * rank]
        assert g["parts"].tolist() == [0, 1, 10, 11, 2, 3, 12, 13]
        # d(3 sum_r y_r^2)/dy_r: the gradient of the global loss, of
        # which each rank passed back only its own share
        assert g["y_grad"].tolist() == [3 * 2 * (1.0 + rank)]
        # the group means 0.5, 2.5 and 4.5 average to 2.5: 0.1 of it
        assert abs(float(g["sub_mean"][0]) - 0.25) < 1e-7
        assert not g["agree_rank"] and g["agree_one"]
        assert (g["weight"] == 0).all()


# -- (b) triplet steps -------------------------------------------------------

TRIPLET_CASES = {"random_semi_hard": [],
                 "accum2": ["TRAIN.ACCUM_STEPS", 2],
                 "mem_triplet": ["LOSS.MEM_TRIPLET", True,
                                 "LOSS.MEM_TRIPLET_K", 16]}


def _triplet_run(opts, init, batches, rank=0, world=1):
    """Two triplet steps as the driver runs them: uint8 clips augmented on
    the device, the step's generator seeded alike on every rank."""
    cfg = _cfg(opts)
    accum = max(1, int(cfg.TRAIN.ACCUM_STEPS))
    model = _model(cfg, init)
    opt, sched = make_optimizer(cfg, model.parameters())
    banks = make_banks(cfg, 0)
    step = make_triplet_train_step(cfg, model, opt, sched, device="cpu",
                                   bank=banks.get("mem_triplet"))
    gen = torch.Generator()
    metrics = []
    for i, batch in enumerate(batches):
        gen.manual_seed(step_seed(0, i))
        m = step(_device_views(_local(batch, rank, world, accum), cfg, gen,
                               accum), gen)
        metrics.append({"loss": m["loss"], "n_triplets": m["n_triplets"],
                        "negatives": m["negatives"]})
    return {"state": model.state_dict(), "metrics": metrics,
            "banks": {k: v.state_dict() for k, v in banks.items()}}


def _triplet_inputs(case):
    opts = TRIPLET + TRIPLET_CASES[case]
    rng = np.random.default_rng(1)
    return opts, _init(_cfg(opts)), [_uint8_batch(rng) for _ in range(2)]


@pytest.fixture(scope="module")
def triplet_ranks(tmp_path_factory):
    cases = {case: ("_triplet_run", _triplet_inputs(case))
             for case in TRIPLET_CASES}
    return _ranks(_cases_worker, tmp_path_factory.mktemp("triplet"), cases)


@pytest.mark.parametrize("case", sorted(TRIPLET_CASES))
def test_triplet_steps_at_world_2_equal_one_rank(case, triplet_ranks):
    opts, init, batches = _triplet_inputs(case)
    want = _triplet_run(opts, init, batches)
    got = [r[case] for r in triplet_ranks]
    _assert_same(got[0]["state"], got[1]["state"], "rank 0 vs 1")
    _assert_same(got[0]["banks"], got[1]["banks"], "banks, rank 0 vs 1")
    _assert_close(got[0]["state"], want["state"], "state")
    _assert_close(got[0]["banks"], want["banks"], "banks")
    for g, w in zip(got[0]["metrics"], want["metrics"]):
        assert int(g["n_triplets"]) == int(w["n_triplets"]) > 0
        assert torch.equal(g["negatives"], w["negatives"])
        assert abs(float(g["loss"]) - float(w["loss"])) <= TOL
    assert init.keys() == want["state"].keys()
    assert any(not torch.equal(init[k], want["state"][k]) for k in init)


def _injected_worker(rank, world, port, opts, init, batches, noises):
    """Float clips and JAX's Gumbel draws, each rank fed its rows; the
    state after each step."""
    cfg = _cfg(opts)
    model = model_selector(cfg)
    model.load_state_dict(init)
    step = make_triplet_train_step(cfg, model,
                                   *make_optimizer(cfg, model.parameters()),
                                   device="cpu")
    out = []
    for batch, noise in zip(batches, noises):
        local = {k: torch.from_numpy(v) for k, v in
                 _local(batch, rank, world).items()}
        local["targets"] = local["targets"].long()
        m = step(local, noise=torch.from_numpy(noise))
        out.append({"metrics": {k: float(m[k]) for k in
                                ("loss", "triplet_loss", "aux_loss",
                                 "n_triplets")},
                    "state": {k: v.clone()
                              for k, v in model.state_dict().items()}})
    return out


def test_world_2_triplet_steps_match_jax_on_a_two_device_mesh(tmp_path):
    """Two steps of ``test_torch_port_train_step.py``'s cell, the JAX step
    jitted over a batch sharded on a 2-device mesh (its driver's
    ``shard_batch``); as there, the loss within 1e-5 and every parameter
    and statistic within 1e-4 after each step. The second JAX step starts
    from the port's weights and statistics: at init the stem's update
    sums terms that mostly cancel, and the two packages' float32 orders of
    summation (and the mesh's) would otherwise move the second loss by
    ~1e-5."""
    import jax
    import jax.numpy as jnp

    import test_torch_port_train_step as ts
    from video_similarity_search_tpu.parallel import (make_mesh, replicate,
                                                      shard_batch)
    from video_similarity_search_tpu.train import create_train_state

    jcfg, tcfg = ts._cfgs()
    jmodel, params, stats, tmodel = ts._models(jcfg, tcfg, seed=3)
    init = {k: v.clone() for k, v in tmodel.state_dict().items()}
    mesh = make_mesh(devices=jax.devices()[:WORLD])
    state = create_train_state(jax.random.key(0), jmodel, jcfg,
                               jnp.zeros((2, ts.T, ts.S, ts.S, 3)))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, stats))
    jstep = ts.j_make_step(jcfg)
    rng = np.random.default_rng(4)
    n = 2 * ts.B
    batches = [ts._batch(rng) for _ in range(2)]
    keys = [jax.random.key(10 + i) for i in range(2)]
    noises = [np.array(jax.random.gumbel(jax.random.split(k)[0], (n, n, n),
                                         dtype=jnp.float32)) for k in keys]
    got = _ranks(_injected_worker, tmp_path, list(ts.OPTS), init, batches,
                 noises)
    for i in range(2):
        _assert_same(got[0][i]["state"], got[1][i]["state"],
                     f"step {i}, rank 0 vs 1")
        with mesh:
            state, jm = jstep(replicate(mesh, state),
                              shard_batch(mesh, batches[i]), keys[i])
        tm = got[0][i]["metrics"]
        assert int(tm["n_triplets"]) == int(jm["n_triplets"]) > 0
        for k in ("loss", "triplet_loss", "aux_loss"):
            np.testing.assert_allclose(tm[k], float(jm[k]), atol=1e-5,
                                       err_msg=f"step {i} {k}")
        tmodel.load_state_dict(got[0][i]["state"])
        t_params, t_stats = ts._flax_trees(tmodel)
        ts._assert_trees_close(t_params, jax.device_get(state.params),
                               atol=1e-4)
        ts._assert_trees_close(t_stats, jax.device_get(state.batch_stats),
                               atol=1e-4)
        # the next step starts from the port's weights in both packages
        state = state.replace(params=jax.tree.map(jnp.asarray, t_params),
                              batch_stats=jax.tree.map(jnp.asarray, t_stats))


# -- (c) contrastive and UberNCE steps ---------------------------------------

CONTRASTIVE = TRIPLET[:14] + [
    "LOSS.TYPE", "contrastive", "DATASET.MODALITY", "rgb", "LOSS.K", 6,
    "LOSS.FEAT_DIM", 8, "LOSS.T", 0.5, "RESNET.WIDEN_FACTOR", 0.125,
    "TPU.COMPUTE_DTYPE", "float32", "TRAIN.BATCH_SIZE", B, "OPTIM.LR", 0.01]
CONTRASTIVE_CASES = {"nce_intra_negative": ["LOSS.INTRA_NEGATIVE", True],
                     "memory_moco": ["LOSS.MOCO", True]}
MOCO_CLIP = (8, 32)
UBERNCE = ["MODEL.ARCH", "uber_nce", "LOSS.TYPE", "UberNCE", "LOSS.K", 8,
           "DATA.SAMPLE_DURATION", MOCO_CLIP[0], "DATA.SAMPLE_SIZE",
           MOCO_CLIP[1], "TPU.COMPUTE_DTYPE", "float32", "TPU.HOST_RRC", True,
           "TRAIN.BATCH_SIZE", B, "OPTIM.LR", 0.01, "OPTIM.MOMENTUM", 0.5]


def _contrastive_run(opts, init, batches, rank=0, world=1):
    """Two contrastive (or, for LOSS.TYPE UberNCE, MoCo) steps as the
    driver runs them."""
    cfg = _cfg(opts)
    model = _model(cfg, init)
    opt, sched = make_optimizer(cfg, model.parameters())
    moco = cfg.LOSS.TYPE == "UberNCE"
    with torch.random.fork_rng(devices=[]):
        banks = make_banks(cfg, N_DATA, model)
    if moco:
        step = make_moco_train_step(cfg, model, opt, sched, banks["moco"],
                                    uber=True, device="cpu")
    else:
        use_moco = "memory_moco" in banks
        step = make_contrastive_train_step(
            cfg, model, opt, sched, banks["memory_moco" if use_moco
                                          else "nce"],
            modality="rgb", intra_neg=bool(cfg.LOSS.INTRA_NEGATIVE),
            use_moco=use_moco, device="cpu")
    gen = torch.Generator()
    losses, states = [], []
    for i, batch in enumerate(batches):
        gen.manual_seed(step_seed(0, i))
        dev = _device_views(_local(batch, rank, world), cfg, gen)
        b = dev["anchor"].shape[0]
        if moco:
            m = step({"x1": dev["anchor"], "x2": dev["positive"],
                      "label": dev["targets"][:b]}, gen)
        else:
            m = step({"view1": dev["anchor"], "view2": dev["positive"],
                      "index": dev["index"]}, gen)
        losses.append(float(m["loss"]))
        states.append({"model": {k: v.clone() for k, v in
                                 model.state_dict().items()},
                       "banks": {k: {n: t.clone() for n, t in
                                     v.state_dict().items()}
                                 for k, v in banks.items()}})
    return {"states": states, "losses": losses}


def _contrastive_inputs(case):
    if case == "ubernce":
        opts, clip = UBERNCE, MOCO_CLIP
    else:
        opts, clip = CONTRASTIVE + CONTRASTIVE_CASES[case], (T, IN)
    rng = np.random.default_rng(2)
    return (opts, _init(_cfg(opts)),
            [_uint8_batch(rng, ("anchor", "positive"), clip)
             for _ in range(2)])


CONTRASTIVE_ALL = sorted(CONTRASTIVE_CASES) + ["ubernce"]


@pytest.fixture(scope="module")
def contrastive_ranks(tmp_path_factory):
    cases = {case: ("_contrastive_run", _contrastive_inputs(case))
             for case in CONTRASTIVE_ALL}
    return _ranks(_cases_worker, tmp_path_factory.mktemp("contrastive"),
                  cases)


@pytest.mark.parametrize("case", CONTRASTIVE_ALL)
def test_contrastive_steps_at_world_2_equal_one_rank(case, contrastive_ranks):
    want = _contrastive_run(*_contrastive_inputs(case))
    got = [r[case] for r in contrastive_ranks]
    for i in range(2):
        _assert_same(got[0]["states"][i], got[1]["states"][i],
                     f"step {i}, rank 0 vs 1")
        # S3D at random init amplifies the first update's rounding (the
        # float32 queue and logits) ~1e3-fold in the second: 8e-11 after
        # one UberNCE step, 2e-7 after two
        tol = UBERNCE_SECOND_STEP_TOL if case == "ubernce" and i else TOL
        _assert_close(got[0]["states"][i], want["states"][i], f"step {i}",
                      tol)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=1e-6)
    if case == "ubernce":  # two steps of the global batch enqueued
        moco = got[0]["states"][1]["banks"]["moco"]
        assert int(moco["queue_ptr"]) == 0
        assert (moco["queue_labels"] >= 0).all()


# -- (d) the training CLI at world 2 -----------------------------------------

CLI_YAML = (f"MODEL:\n  ARCH: 3dresnet\nRESNET:\n  MODEL_DEPTH: 10\n"
            "  NO_MAX_POOl: true\n  HIDDEN_LAYER: 32\n  OUT_DIM: 8\n"
            f"DATA:\n  SAMPLE_SIZE: {S}\n  SAMPLE_DURATION: {T}\n"
            "TRAIN:\n  DATASET: ucf101\n  BATCH_SIZE: 8\n  EPOCHS: 2\n"
            "  NUM_DATA_WORKERS: 2\n  LOG_INTERVAL: 100\n"
            "  RETRIEVAL_INTERVAL: 1\n"
            "VAL:\n  BATCH_SIZE: 8\n"
            "DATASET:\n  SAMPLING_STRATEGY: random_semi_hard\n"
            "  POSITIVE_SAMPLING_P: 1.0\n"
            "LOSS:\n  LOCAL_LOCAL_CONTRAST: true\n"
            "OPTIM:\n  LR: 0.01\n"
            "ITERCLUSTER:\n  METHOD: finch\n  INTERVAL: 1\n"
            "  WARMUP_EPOCHS: 0\n  ADAPTIVEP: true\n"
            "TPU:\n  COMPUTE_DTYPE: float32\n")
LOGS = ("NMIs.txt", "AMIs.txt", "train_loss_and_acc.txt",
        "val_loss_and_acc.txt", "global_retrieval_acc.txt")


def _cli_worker(rank, world, port, argv):
    from video_similarity_search_tpu_torch.cli import online_train

    cfg, model, _ = online_train.main(
        ["--num_shards", str(world), "--shard_id", str(rank),
         "--ip_address_port", f"tcp://127.0.0.1:{port}"] + argv)
    return {"state": model.state_dict(),
            "p": cfg.DATASET.POSITIVE_SAMPLING_P,
            "target_type": cfg.DATASET.TARGET_TYPE_T}


def _written(out):
    found = set()
    for dirpath, _, names in os.walk(out):
        rel = os.path.relpath(dirpath, out)
        found |= {os.path.normpath(os.path.join(rel, n)) for n in names}
    return found


def _log(out, name):
    with open(os.path.join(out, "tnet_checkpoints", name)) as f:
        return f.read().splitlines()


def test_training_cli_at_world_2_and_its_resume(tmp_path):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from synthetic_data import make_synthetic_ucf

    vid, ann = make_synthetic_ucf(str(tmp_path / "data"))
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(CLI_YAML)
    out = str(tmp_path / "out")
    data = ["DATASET.VID_PATH", vid, "DATASET.ANNOTATION_PATH", ann]
    argv = ["--cfg", str(cfg_path), "--iterative_cluster", "--output", out,
            "--device", "cpu"]
    got = _ranks(_cli_worker, tmp_path / "ranks", argv + data,
                 join_group=False)
    _assert_same(got[0]["state"], got[1]["state"], "rank 0 vs 1")
    assert got[0]["target_type"] == got[1]["target_type"] == "cluster_label"
    nmi = float(_log(out, "NMIs.txt")[-1])
    assert got[0]["p"] == got[1]["p"] == pytest.approx(1.0 - nmi, abs=1e-6)
    for name in LOGS:  # one line an epoch: rank 1 wrote none
        assert len(_log(out, name)) == 2, name
    files = _written(out)
    assert {"vid_clusters.txt", "tnet_checkpoints/3dresnet/checkpoint.pth.tar",
            "tnet_checkpoints/NMIs.txt"} <= files
    with open(os.path.join(out, "vid_clusters.txt")) as f:
        assert len(f.read().split()) == 9  # one label a train video
    saved = torch.load(os.path.join(out, "tnet_checkpoints", "3dresnet",
                                    "checkpoint.pth.tar"), weights_only=False)
    assert saved["epoch"] == 2
    _assert_same({k: v for k, v in saved["state_dict"].items()},
                 got[0]["state"], "checkpoint vs rank 0")

    # resume for a third epoch, two CPU ranks started by the CLI itself
    cmd = [sys.executable, "-m",
           "video_similarity_search_tpu_torch.cli.online_train",
           "--cfg", str(cfg_path), "--iterative_cluster", "--output", out,
           "--checkpoint_path", out, "--device", "cpu", "--gpu", "0,1",
           "--ip_address_port", f"tcp://127.0.0.1:{parallel.free_port()}",
           "TRAIN.EPOCHS", "3"] + data
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=JOIN_S)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "resume: epoch 2" in run.stdout
    train_log = _log(out, "train_loss_and_acc.txt")
    assert len(train_log) == 3 and train_log[-1].startswith("epoch:2 ")
    assert len(_log(out, "NMIs.txt")) == 3
    assert files <= _written(out)


# -- (e) the JAX package's multi-host targets layout -------------------------

def test_jax_multihost_targets_disagree_with_the_embeddings():
    """Two hosts, two triplets each. The JAX multi-host ``shard_batch``
    builds each global leaf from the hosts' local leaves, host by host
    (``jax.make_array_from_process_local_data`` over a batch-sharded
    leaf), so anchor = [a0; a1] and positive = [p0; p1], and the step
    mines over emb2 = [a0; a1; p0; p1]; but each host's collate lays its
    targets out [anchor targets; positive targets], so the global targets
    come out [ta0; tp0; ta1; tp1]. With a different label on each host,
    half the rows of emb2 carry another row's label. The port's gathered
    layout, [ta0; ta1; tp0; tp1], matches emb2 row for row."""
    from video_similarity_search_tpu.data.pipeline import collate_triplets

    hosts = []
    for h in range(WORLD):
        items = [{"anchor": np.full((1,), 10 * h + i),
                  "positive": np.full((1,), 10 * h + i),
                  "index": 10 * h + i, "targets": (h, h)} for i in range(2)]
        hosts.append(collate_triplets(items))
    glob = {k: np.concatenate([hst[k] for hst in hosts]) for k in hosts[0]}
    emb2_items = np.concatenate([glob["anchor"], glob["positive"]])[:, 0]
    true = emb2_items // 10  # each item's host, which is its label
    assert not np.array_equal(glob["targets"], true)
    assert np.array_equal(glob["targets"], [0, 0, 0, 0, 1, 1, 1, 1])
    assert np.array_equal(true, [0, 0, 1, 1, 0, 0, 1, 1])
    # the port: each rank's [anchor targets; positive targets], gathered
    # part by part (parallel.gather_parts)
    local = np.stack([hst["targets"] for hst in hosts])  # (W, 2 b)
    port = local.reshape(WORLD, 2, -1).transpose(1, 0, 2).reshape(-1)
    assert np.array_equal(port, true)
