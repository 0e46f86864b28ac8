"""Weights carried across from the JAX package, and reference checkpoints.

``flax_resnet3d_to_torch`` is the inverse of the JAX package's
``train/checkpoint.py::torch_resnet3d_to_flax``: it takes the flax
``params`` / ``batch_stats`` trees of a ``ResNet3D`` (as numpy arrays) and
returns a state_dict with the kenshohara reference keys that the port's
``ResNet3D`` loads with ``load_state_dict``.

``load_torch_checkpoint`` reads a reference ``.pth.tar`` (the JAX
package's ``train/checkpoint.py:223-241``) and ``load_encoder_state`` puts
it into the port's ``ResNet3D``, whose parameters carry the same names.

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
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_BLOCK_RE = re.compile(r"^layer(\d)_(\d+)$")


def _conv(v) -> torch.Tensor:  # (kT, kH, kW, Cin, Cout) -> (Cout, Cin, kT, kH, kW)
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(v, np.float32), (4, 3, 0, 1, 2))))


def _dense(v) -> torch.Tensor:  # (in, out) -> (out, in)
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(v, np.float32).T))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def flax_resnet3d_to_torch(params: Mapping, batch_stats: Mapping
                           ) -> Dict[str, torch.Tensor]:
    """flax ResNet3D trees -> torch state_dict (reference key names)."""
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
        else:
            raise KeyError(f"unmapped flax module {name!r} (not ported)")
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Reference ``.pth.tar`` -> {"torch_state_dict", "epoch",
    "best_prec1"}, on the CPU. Strips the DDP ``module.`` prefix
    (reference model_utils.py:184) and maps a MoCo query encoder's
    ``encoder_q.0.`` to ``backbone.`` (coclr_classify.py:244). The file is
    unpickled: load trusted checkpoints only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith("encoder_q.0."):
            k = "backbone." + k[len("encoder_q.0."):]
        sd[k] = v.detach().cpu() if isinstance(v, torch.Tensor) \
            else torch.as_tensor(v)
    return {
        "torch_state_dict": sd,
        "epoch": int(ckpt.get("epoch", 0)) if isinstance(ckpt, dict) else 0,
        "best_prec1": float(ckpt.get("best_prec1", 0.0))
        if isinstance(ckpt, dict) else 0.0,
    }


_HEAD_PREFIXES = ("fc1.", "bn_proj.", "fc2.")


def load_encoder_state(model: torch.nn.Module,
                       state_dict: Mapping[str, torch.Tensor],
                       verbose: bool = True) -> Dict[str, list]:
    """Load every tensor of ``state_dict`` whose name (a leading
    ``backbone.`` dropped) and shape match a tensor of ``model``, as the
    JAX package's partial load does (``merge_pretrained``). Prints what it
    skipped and what it kept at init; raises ``KeyError`` when a backbone
    weight or statistic (anything outside the projection head but the
    ``num_batches_tracked`` counters) gets no value. -> the names loaded,
    skipped and missing."""
    own = model.state_dict()
    loaded, skipped = {}, []
    for k, v in state_dict.items():
        name = k[len("backbone."):] if k.startswith("backbone.") else k
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


# --------------------------------------------------------------------------
# the training run's checkpoints

CHECKPOINT = "checkpoint.pth.tar"


def checkpoint_dir(output_path: str, arch: str) -> str:
    return os.path.join(output_path, "tnet_checkpoints", arch)


def save_checkpoint(output_path: str, arch: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, schedule, epoch: int,
                    best_prec1: float, is_best: bool = False,
                    keep_every: int = 200) -> str:
    """Save under <out>/tnet_checkpoints/<arch>/ (reference
    model_utils.py:161-176, online_train.py:749-776): ``checkpoint.pth.tar``
    (overwritten), a ``model_best.pth.tar`` copy when ``is_best``, and
    ``checkpoint_<epoch + 1>.pth.tar`` every ``keep_every`` epochs. ->
    the checkpoint's path."""
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


def restore_train_state(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, schedule,
                        payload: Mapping, verbose: bool = True
                        ) -> Tuple[int, float]:
    """Apply a loaded payload: the weights and BatchNorm statistics (names
    and shapes as ``load_encoder_state`` matches them), the optimizer's
    state (``_restore_optimizer``) and the schedule's count. A reference
    checkpoint without an optimizer restores weights only, with a warning.
    -> (start epoch, best_prec1) (reference model_utils.py:180-211)."""
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
