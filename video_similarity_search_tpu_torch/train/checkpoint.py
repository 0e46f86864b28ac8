"""Weights carried across from the JAX package, and reference checkpoints.

``flax_resnet3d_to_torch`` is the inverse of the JAX package's
``train/checkpoint.py::torch_resnet3d_to_flax``: it takes the flax
``params`` / ``batch_stats`` trees of a ``ResNet3D`` (as numpy arrays) and
returns a state_dict with the kenshohara reference keys that the port's
``ResNet3D`` loads with ``load_state_dict``.

``load_torch_checkpoint`` reads a reference ``.pth.tar`` (the JAX
package's ``train/checkpoint.py:223-241``) and ``load_encoder_state`` puts
it into the port's ``ResNet3D``, whose parameters carry the same names.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

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
