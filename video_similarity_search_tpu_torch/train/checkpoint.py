"""Weights carried across from the JAX package.

``flax_resnet3d_to_torch`` is the inverse of the JAX package's
``train/checkpoint.py::torch_resnet3d_to_flax``: it takes the flax
``params`` / ``batch_stats`` trees of a ``ResNet3D`` (as numpy arrays) and
returns a state_dict with the kenshohara reference keys that the port's
``ResNet3D`` loads with ``load_state_dict``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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
