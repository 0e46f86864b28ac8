"""Weights carried across from the JAX package, and reference checkpoints.

``flax_resnet3d_to_torch``, ``flax_s3d_to_torch``, ``flax_r3d_to_torch``
and ``flax_linear_classifier_to_torch`` are the inverses of the JAX
package's ``torch_resnet3d_to_flax``, ``torch_s3d_to_flax``,
``torch_r3d_to_flax`` and ``torch_linear_classifier_to_flax``
(``train/checkpoint.py``): they take the flax ``params`` / ``batch_stats``
trees (as numpy arrays) and return a state_dict with the reference's torch
keys, which the port's modules load with ``load_state_dict``.

``load_torch_checkpoint`` reads a reference ``.pth.tar`` (the JAX
package's ``train/checkpoint.py:223-241``, S3D's block aliases mapped to
the direct names); ``load_encoder_state`` puts it into a port encoder,
whose parameters carry the same names, and ``merge_pretrained`` loads it
partially, as the JAX package's ``merge_pretrained`` does.

``save_checkpoint`` / ``restore_train_state`` / ``resolve_checkpoint`` are
the training run's own checkpoints (the JAX package's
``train/checkpoint.py:105-216`` and ``driver.py::_resolve_checkpoint``).
The port cannot write orbax, so it writes the reference's format, which
the JAX package's ``load_checkpoint`` reads too: ``{"epoch": epoch + 1,
"best_prec1", "state_dict"}`` with the reference key names, plus the
optimizer's and the learning-rate schedule's state.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.resnet3d import conv1_kernel_to_s2d

_BLOCK_RE = re.compile(r"^layer(\d)_(\d+)$")


def _conv(v) -> torch.Tensor:  # (kT, kH, kW, Cin, Cout) -> (Cout, Cin, kT, kH, kW)
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(v, np.float32), (4, 3, 0, 1, 2))))


def _dense(v) -> torch.Tensor:  # (in, out) -> (out, in)
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(v, np.float32).T))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def _conv1d(v) -> torch.Tensor:  # (k, Cin/groups, Cout) -> (Cout, Cin/groups, k)
    return torch.from_numpy(np.array(
        np.transpose(np.asarray(v, np.float32), (2, 1, 0))))


_ATTENTION_RE = re.compile(r"^(channel|spatio)_temporal_attention\d$")


def flax_resnet3d_to_torch(params: Mapping, batch_stats: Mapping,
                           use_dropout: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """flax ResNet3D trees -> torch state_dict (reference key names). The
    attention blocks keep their flax module names (``models/resnet3d.py``);
    the classifier is ``linear``, or ``linear.1`` behind a dropout
    (``use_dropout``), as the reference names it. An s2d stem's kernel
    carries over as it is."""
    sd: Dict[str, torch.Tensor] = {}

    def put_bn(prefix: str, p: Mapping, s: Mapping) -> None:
        p, s = p["BatchNorm_0"], s["BatchNorm_0"]
        sd[prefix + ".weight"] = _vec(p["scale"])
        sd[prefix + ".bias"] = _vec(p["bias"])
        sd[prefix + ".running_mean"] = _vec(s["mean"])
        sd[prefix + ".running_var"] = _vec(s["var"])
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    for name, p in params.items():
        s = batch_stats.get(name, {})
        m = _BLOCK_RE.match(name)
        if name == "conv1":
            sd["conv1.weight"] = _conv(p["Conv_0"]["kernel"])
        elif name == "bn1":
            put_bn("bn1", p, s)
        elif m:
            prefix = f"layer{m.group(1)}.{m.group(2)}"
            for sub, leaf in p.items():
                if sub.startswith("conv"):
                    sd[f"{prefix}.{sub}.weight"] = _conv(leaf["Conv_0"]["kernel"])
                elif sub.startswith("bn"):
                    put_bn(f"{prefix}.{sub}", leaf, s[sub])
                elif sub == "downsample_conv":
                    sd[f"{prefix}.downsample.0.weight"] = _conv(
                        leaf["Conv_0"]["kernel"])
                elif sub == "downsample_bn":
                    put_bn(f"{prefix}.downsample.1", leaf, s[sub])
                else:
                    raise KeyError(f"unmapped flax leaf {name}/{sub}")
        elif name == "projection":
            for fc in ("fc1", "fc2"):
                sd[f"{fc}.weight"] = _dense(p[fc]["kernel"])
                sd[f"{fc}.bias"] = _vec(p[fc]["bias"])
            put_bn("bn_proj", p["bn_proj"], s["bn_proj"])
        elif name in ("temporal_ds_linear", "linear"):
            prefix = "linear.1" if name == "linear" and use_dropout else name
            sd[f"{prefix}.weight"] = _dense(p["kernel"])
            sd[f"{prefix}.bias"] = _vec(p["bias"])
        elif _ATTENTION_RE.match(name):
            for sub, leaf in p.items():
                leaf = leaf.get("Conv_0", leaf)
                k = np.asarray(leaf["kernel"])
                sd[f"{name}.{sub}.weight"] = (
                    _conv(k) if k.ndim == 5 else _conv1d(k) if k.ndim == 3
                    else _dense(k))
                sd[f"{name}.{sub}.bias"] = _vec(leaf["bias"])
        else:
            raise KeyError(f"unmapped flax module {name!r} (not ported)")
    return sd


def _flat(tree: Mapping, path: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _flax_to_torch(params: Mapping, batch_stats: Mapping,
                   name: Callable[[List[str]], str]) -> Dict[str, torch.Tensor]:
    """Generic flax -> torch state_dict: ``name`` maps a leaf's module path
    (flax's ``Conv_0`` / ``BatchNorm_0`` wrappers dropped) to its torch
    module; ``kernel`` becomes ``weight`` (a 5-D one transposed as a
    convolution, a 2-D one as a linear), ``scale`` ``weight``, and the
    statistics ``running_mean`` / ``running_var`` beside a zero
    ``num_batches_tracked``."""
    sd: Dict[str, torch.Tensor] = {}
    fields = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}
    for tree in (params, batch_stats):
        for path, v in _flat(tree):
            mods = [p for p in path[:-1] if p not in ("Conv_0", "BatchNorm_0")]
            prefix, field = name(mods), path[-1]
            if field == "kernel":
                v = _conv(v) if np.ndim(v) == 5 else _dense(v)
            else:
                v = _vec(v)
            sd[f"{prefix}.{fields[field]}"] = v
            if field == "mean":
                sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd


_BRANCH_RE = re.compile(r"^branch(\d)_(\d)$")
_R3D_BLOCK_RE = re.compile(r"^conv(\d)_block(\d+)$")


def _s3d_name(mods: List[str]) -> str:
    """flax S3D path -> torch name: ``branch1_1`` is ``branch1.1``."""
    return ".".join(_BRANCH_RE.sub(r"branch\1.\2", m) for m in mods)


def _r3d_name(mods: List[str]) -> str:
    """flax R3DNet path -> torch name: ``conv{s}_block0`` is
    ``conv{s}.block1``, ``conv{s}_block{b}`` ``conv{s}.blocks.{b - 1}``, and
    a convolution sits in its ``SpatioTemporalConv`` wrapper."""
    out = []
    for m in mods:
        blk = _R3D_BLOCK_RE.match(m)
        if blk:
            b = int(blk.group(2))
            out.append(f"conv{blk.group(1)}." + (
                "block1" if b == 0 else f"blocks.{b - 1}"))
        else:
            out.append(m)
    if mods[-1] in ("conv1", "conv2", "downsampleconv"):
        out.append("temporal_spatial_conv")
    return ".".join(out)


def _embedder_name(backbone: Callable[[List[str]], str],
                   heads: Mapping[str, str]) -> Callable[[List[str]], str]:
    """The embedders' ``nn.Sequential`` names: the backbone at ``0.``, each
    projection at its index in ``heads``."""
    def name(mods: List[str]) -> str:
        if mods[0] == "backbone":
            return "0." + backbone(mods[1:])
        return heads[mods[0]]
    return name


def flax_s3d_to_torch(params: Mapping, batch_stats: Mapping
                      ) -> Dict[str, torch.Tensor]:
    """flax ``S3DEmbedder`` trees -> the port's ``S3DEmbedder`` state_dict
    (``0.*``, and the 1x1x1 projections ``2.*`` / ``4.*``); a bare ``S3D``
    tree (no ``backbone`` key) -> the port's ``S3D`` state_dict."""
    if "backbone" not in params:
        return _flax_to_torch(params, batch_stats, _s3d_name)
    sd = _flax_to_torch(params, batch_stats,
                        _embedder_name(_s3d_name, {"proj1": "2",
                                                   "proj2": "4"}))
    for idx in ("2", "4"):  # Dense (in, out) -> Conv3d (out, in, 1, 1, 1)
        sd[f"{idx}.weight"] = sd[f"{idx}.weight"][:, :, None, None, None]
    return sd


def flax_r3d_to_torch(params: Mapping, batch_stats: Mapping
                      ) -> Dict[str, torch.Tensor]:
    """flax ``R3DEmbedder`` trees -> the port's ``R3DEmbedder`` state_dict
    (``0.*``, the linears ``1.*`` / ``3.*``); a bare ``R3DNet`` tree -> the
    port's ``R3DNet`` state_dict."""
    if "backbone" not in params:
        return _flax_to_torch(params, batch_stats, _r3d_name)
    return _flax_to_torch(params, batch_stats,
                          _embedder_name(_r3d_name, {"proj1": "1",
                                                     "proj2": "3"}))


def flax_linear_classifier_to_torch(params: Mapping, batch_stats: Mapping,
                                    use_dropout: bool = True
                                    ) -> Dict[str, torch.Tensor]:
    """flax ``LinearClassifier`` trees -> the port's ``LinearClassifier``
    state_dict: ``backbone.*``, ``final_bn.*`` and ``final_fc.1.*`` behind
    a dropout (``final_fc.0.*`` without one)."""
    fc = "final_fc.1" if use_dropout else "final_fc.0"

    def name(mods: List[str]) -> str:
        if mods[0] == "backbone":
            return "backbone." + _s3d_name(mods[1:])
        return {"final_bn": "final_bn", "final_fc": fc}[mods[0]]
    return _flax_to_torch(params, batch_stats, name)


# S3D: the reference registers each block both directly (Conv_1a,
# Mixed_3b, ...) and through the block Sequentials (block1.0, block3.1,
# ...), so its state_dict holds both aliases of the same tensors
# (reference models/s3d/s3dg.py:143-197; the JAX package's
# checkpoint.py:366-372). The port keeps the direct names.
_S3D_BLOCK_ALIASES = {
    "block1.0": "Conv_1a", "block2.1": "Conv_2b", "block2.2": "Conv_2c",
    "block3.1": "Mixed_3b", "block3.2": "Mixed_3c",
    "block4.1": "Mixed_4b", "block4.2": "Mixed_4c", "block4.3": "Mixed_4d",
    "block4.4": "Mixed_4e", "block4.5": "Mixed_4f",
    "block5.1": "Mixed_5b", "block5.2": "Mixed_5c",
}
_ALIAS_RE = re.compile(r"(^|\.)(block\d\.\d)\.")


def _canonical_s3d_key(k: str) -> str:
    return _ALIAS_RE.sub(
        lambda m: m.group(1) + _S3D_BLOCK_ALIASES.get(m.group(2),
                                                      m.group(2)) + ".",
        k, count=1)


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Reference ``.pth.tar`` -> {"torch_state_dict", "epoch",
    "best_prec1"}, on the CPU. Strips the DDP ``module.`` prefix
    (reference model_utils.py:184), maps a MoCo query encoder's
    ``encoder_q.0.`` to ``backbone.`` (coclr_classify.py:244) and S3D's
    ``blockN.M`` aliases to the direct block names. A directory (an orbax
    checkpoint of the JAX package) raises: it cannot be read without JAX.
    The file is unpickled: load trusted checkpoints only."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package); the port reads torch .pth.tar checkpoints only")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("encoder_q.0."):
            k = "backbone." + k[len("encoder_q.0."):]
        sd[_canonical_s3d_key(k)] = v.detach().cpu() \
            if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return {
        "torch_state_dict": sd,
        "epoch": int(ckpt.get("epoch", 0)) if isinstance(ckpt, dict) else 0,
        "best_prec1": float(ckpt.get("best_prec1", 0.0))
        if isinstance(ckpt, dict) else 0.0,
    }


_HEAD_PREFIXES = ("fc1.", "bn_proj.", "fc2.")


def _is_s2d_for(own: torch.Tensor, v: torch.Tensor) -> bool:
    """A 7x7 stem weight offered to a space-to-depth stem (the JAX
    ``torch_resnet3d_to_flax(stem_s2d=True)`` transform)."""
    return (own.ndim == v.ndim == 5 and tuple(own.shape[-2:]) == (4, 4)
            and tuple(v.shape[-2:]) == (7, 7)
            and own.shape[1] == 4 * v.shape[1])


def load_encoder_state(model: torch.nn.Module,
                       state_dict: Mapping[str, torch.Tensor],
                       verbose: bool = True) -> Dict[str, list]:
    """Load every tensor of ``state_dict`` whose name (a leading
    ``backbone.`` dropped where ``model`` has no such name) and shape
    match a tensor of ``model``, as the JAX package's partial load does
    (``merge_pretrained``); a 7x7 ``conv1.weight`` offered to a
    space-to-depth stem is transformed to it (``conv1_kernel_to_s2d``). Prints what it skipped and what it kept at
    init; raises ``KeyError`` when a backbone weight or statistic (anything
    outside the projection head but the ``num_batches_tracked`` counters)
    gets no value. -> the names loaded, skipped and missing."""
    own = model.state_dict()
    loaded, skipped = {}, []
    for k, v in state_dict.items():
        name = k
        if k not in own and k.startswith("backbone."):
            name = k[len("backbone."):]
        if name == "conv1.weight" and name in own and _is_s2d_for(own[name], v):
            v = conv1_kernel_to_s2d(v)
        if name in own and tuple(own[name].shape) == tuple(v.shape):
            loaded[name] = v.to(own[name].dtype)
        else:
            skipped.append(k)
    missing = [k for k in own if k not in loaded]
    if verbose:
        print(f"checkpoint: loaded {len(loaded)} tensors, skipped "
              f"{len(skipped)} {skipped[:8]}, kept {len(missing)} at init "
              f"{missing[:8]}")
    backbone = [k for k in missing if not k.startswith(_HEAD_PREFIXES)
                and not k.endswith("num_batches_tracked")]
    if backbone:
        raise KeyError(f"checkpoint has no value for backbone tensors "
                       f"{backbone[:8]} ({len(backbone)} in all)")
    model.load_state_dict(loaded, strict=False)
    return {"loaded": sorted(loaded), "skipped": skipped, "missing": missing}


def merge_pretrained(model: torch.nn.Module,
                     state_dict: Mapping[str, torch.Tensor],
                     verbose: bool = True) -> Tuple[int, int]:
    """'neq' partial load (the JAX package's ``merge_pretrained``; reference
    coclr_utils/utils.py:93-118): every tensor of ``model`` whose name and
    shape match one of ``state_dict`` takes its value, the rest keep their
    init. Prints and returns (matched, kept at init)."""
    own = model.state_dict()
    take = {k: v.to(own[k].dtype) for k, v in state_dict.items()
            if k in own and tuple(own[k].shape) == tuple(v.shape)}
    model.load_state_dict(take, strict=False)
    matched, kept = len(take), len(own) - len(take)
    if verbose:
        print(f"partial load: matched {matched} tensors, kept {kept} at init")
    return matched, kept


# --------------------------------------------------------------------------
# the training run's checkpoints

CHECKPOINT = "checkpoint.pth.tar"


def checkpoint_dir(output_path: str, arch: str) -> str:
    return os.path.join(output_path, "tnet_checkpoints", arch)


def save_checkpoint(output_path: str, arch: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, schedule, epoch: int,
                    best_prec1: float, is_best: bool = False,
                    keep_every: int = 200,
                    banks: Optional[Mapping[str, torch.nn.Module]] = None
                    ) -> str:
    """Save under <out>/tnet_checkpoints/<arch>/ (reference
    model_utils.py:161-176, online_train.py:749-776): ``checkpoint.pth.tar``
    (overwritten), a ``model_best.pth.tar`` copy when ``is_best``, and
    ``checkpoint_<epoch + 1>.pth.tar`` every ``keep_every`` epochs. The
    loss-side ``banks`` (``mem_triplet``, ``nce``, ``memory_moco``: the JAX
    package's ``_BANK_FIELDS``) go under ``"banks"``, so a resumed run does
    not start them afresh. -> the checkpoint's path."""
    base = checkpoint_dir(output_path, arch)
    os.makedirs(base, exist_ok=True)
    payload = {
        "epoch": epoch + 1,  # the reference stores the epoch to resume at
        "best_prec1": float(best_prec1),
        "state_dict": {k: v.detach().cpu()
                       for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "lr_schedule": schedule.state_dict(),
    }
    if banks:
        payload["banks"] = {name: {k: v.detach().cpu() for k, v in
                                   bank.state_dict().items()}
                            for name, bank in banks.items()}
    path = os.path.join(base, CHECKPOINT)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a preempted save leaves the last one whole
    if is_best:
        shutil.copyfile(path, os.path.join(base, "model_best.pth.tar"))
    if keep_every and (epoch + 1) % keep_every == 0:
        shutil.copyfile(path, os.path.join(
            base, f"checkpoint_{epoch + 1}.pth.tar"))
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The raw payload of a ``.pth.tar`` on the CPU (unpickled: trusted
    files only)."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _restore_optimizer(optimizer: torch.optim.Optimizer, saved: Optional[dict],
                       verbose: bool = True) -> int:
    """Pour a saved ``optimizer.state_dict()`` into the live optimizer,
    parameter by parameter. A parameter whose saved state is missing or
    whose tensors do not match its shape keeps a fresh state, loudly (as
    the JAX package's ``_pour_flat``). The live hyperparameters (from the
    config) stay. -> the count of parameters kept fresh."""
    live = optimizer.state_dict()
    live_ids = [i for g in live["param_groups"] for i in g["params"]]
    params = [p for g in optimizer.param_groups for p in g["params"]]
    saved_state, saved_ids = {}, []
    if saved is not None:
        saved_state = saved.get("state", {})
        saved_ids = [i for g in saved["param_groups"] for i in g["params"]]
    state, fresh = {}, []
    for pos, (pid, p) in enumerate(zip(live_ids, params)):
        st = saved_state.get(saved_ids[pos]) if pos < len(saved_ids) else None
        ok = st is not None and all(
            not isinstance(v, torch.Tensor) or v.ndim == 0
            or tuple(v.shape) == tuple(p.shape) for v in st.values())
        if ok:
            state[pid] = st
        else:
            fresh.append(pos)
    optimizer.load_state_dict({"state": state,
                               "param_groups": live["param_groups"]})
    if fresh and verbose:
        print(f"WARNING: restore[optimizer]: {len(fresh)}/{len(params)} "
              "parameters had no matching saved state and start fresh "
              f"(first: parameter {fresh[0]}); their momentum is lost")
    return len(fresh)


def _restore_banks(banks: Mapping[str, torch.nn.Module], saved: Mapping,
                   verbose: bool = True) -> None:
    """Pour saved bank buffers into the live banks. A bank, or a buffer,
    that the checkpoint lacks or holds at another shape stays fresh,
    loudly (the JAX package's ``_pour_flat``)."""
    for name, bank in banks.items():
        own, got = bank.state_dict(), saved.get(name) or {}
        take = {k: v.to(own[k].dtype) for k, v in got.items()
                if k in own and tuple(v.shape) == tuple(own[k].shape)}
        bank.load_state_dict(take, strict=False)
        fresh = [k for k in own if k not in take]
        if fresh and verbose:
            print(f"WARNING: restore[{name}]: {len(fresh)}/{len(own)} "
                  "buffers had no matching saved value and stay freshly "
                  f"initialized (first: {fresh[0]})")
    for name in saved:
        if name not in banks and verbose:
            print(f"WARNING: restore[{name}]: checkpoint carries a {name} "
                  "bank but the run has none (LOSS.TYPE changed?); "
                  "discarding it")


def load_bank_state(bank: torch.nn.Module, fields: Mapping) -> None:
    """Carry a JAX bank (``MemTripletState``, ``NCEAverageState`` or
    ``MemoryMoCoState``, as a mapping of its fields to numpy arrays) into
    the port's bank, whose buffers bear the same names. Every buffer must
    get a value; a field that is None (no intra-negative bank) is
    skipped."""
    own = bank.state_dict()
    sd = {k: torch.from_numpy(np.array(v)).to(own[k].dtype)
          for k, v in fields.items() if v is not None}
    bank.load_state_dict(sd, strict=True)


def restore_train_state(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, schedule,
                        payload: Mapping, verbose: bool = True,
                        banks: Optional[Mapping[str, torch.nn.Module]] = None
                        ) -> Tuple[int, float]:
    """Apply a loaded payload: the weights and BatchNorm statistics (names
    and shapes as ``load_encoder_state`` matches them), the optimizer's
    state (``_restore_optimizer``), the schedule's count and the loss-side
    ``banks`` (``_restore_banks``). A reference checkpoint without an
    optimizer restores weights only, with a warning. -> (start epoch,
    best_prec1) (reference model_utils.py:180-211)."""
    sd = {}
    for k, v in payload.get("state_dict", payload).items():
        sd[k[len("module."):] if k.startswith("module.") else k] = v
    load_encoder_state(model, sd, verbose=verbose)
    n_params = sum(len(g["params"]) for g in optimizer.param_groups)
    fresh = n_params
    if "optimizer" in payload:
        fresh = _restore_optimizer(optimizer, payload["optimizer"], verbose)
    elif verbose:
        print("WARNING: restore[optimizer]: the checkpoint holds no "
              "optimizer state; momentum starts fresh")
    if "lr_schedule" in payload:
        schedule.load_state_dict(payload["lr_schedule"])
    if banks or payload.get("banks"):
        _restore_banks(banks or {}, payload.get("banks") or {}, verbose)
    epoch = int(payload.get("epoch", 0))
    best = float(payload.get("best_prec1", 0.0))
    if verbose:
        print(f"resume: epoch {epoch}, best_prec1 {best}, optimizer state "
              f"for {n_params - fresh}/{n_params} parameters, schedule "
              f"count {schedule.count}")
    return epoch, best


def resolve_checkpoint(path: Optional[str], arch: str,
                       allow_missing: bool = False) -> Optional[str]:
    """Map a --checkpoint_path argument to a loadable checkpoint file (the
    JAX ``driver._resolve_checkpoint``): a ``.pth.tar`` itself, or a run
    root holding ``tnet_checkpoints/<arch>/checkpoint.pth.tar``.
    ``allow_missing`` (--vector, where the path is the stable root that may
    not have been written yet) returns None for a missing target;
    otherwise a missing path raises instead of silently training from
    scratch. An orbax directory of the JAX package raises: it cannot be
    read without JAX."""
    if not path:
        return None
    nested = os.path.join(checkpoint_dir(path, arch), CHECKPOINT)
    if os.path.isdir(path):
        if os.path.exists(nested):
            return nested
        if os.path.exists(os.path.join(path, "_METADATA")):
            raise ValueError(
                f"{path} is an orbax checkpoint of the JAX package; the port "
                "reads torch .pth.tar checkpoints only")
        if allow_missing:
            return None
        raise FileNotFoundError(
            f"--checkpoint_path {path!r} contains no checkpoint (looked for "
            f"{nested})")
    if os.path.exists(path):
        return path
    if allow_missing:
        return None
    raise FileNotFoundError(
        f"--checkpoint_path {path!r} does not exist (a missing path is only "
        "tolerated under --vector, the preemptible-resume case)")
