"""Weights carried across from the JAX package, and reference checkpoints.

``flax_resnet3d_to_torch``, ``flax_s3d_to_torch``, ``flax_r3d_to_torch``,
``flax_linear_classifier_to_torch``, ``flax_slowfast_to_torch`` and
``flax_moco_encoder_to_torch`` are the inverses of the JAX package's
``torch_resnet3d_to_flax``, ``torch_s3d_to_flax``, ``torch_r3d_to_flax``,
``torch_linear_classifier_to_flax``, ``torch_slowfast_to_flax`` and
``torch_moco_encoder_to_flax`` (``train/checkpoint.py``): they take the
flax ``params`` / ``batch_stats`` trees (as numpy arrays) and return a
state_dict with the reference's torch keys, which the port's modules load
with ``load_state_dict``.

``load_torch_checkpoint`` reads a reference ``.pth.tar`` (the JAX
package's ``train/checkpoint.py:223-241``, S3D's block aliases mapped to
the direct names) and ``load_caffe2_checkpoint`` a pyslowfast Caffe2
``.pkl`` (its blob names mapped to pyslowfast's torch names);
``load_encoder_state`` puts either into a port encoder, whose parameters
carry the same names, and ``merge_pretrained`` loads it partially, as the
JAX package's ``merge_pretrained`` does. Both normalize a Sub-BN state
dict (``sub_to_normal_bn_sd``) and, with ``inflate_temporal``, inflate a
2-D kernel to the model's temporal size.

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
import pickle
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
                   heads: Mapping[str, str],
                   prefix: str = "") -> Callable[[List[str]], str]:
    """The embedders' ``nn.Sequential`` names: the backbone at ``0.``, each
    projection at its index in ``heads``, all behind ``prefix``."""
    def name(mods: List[str]) -> str:
        if mods[0] == "backbone":
            return prefix + "0." + backbone(mods[1:])
        return prefix + heads[mods[0]]
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


def flax_moco_encoder_to_torch(params: Mapping, batch_stats: Mapping,
                               prefix: str = "encoder_q"
                               ) -> Dict[str, torch.Tensor]:
    """flax ``MoCoEncoder`` trees -> the port's ``MoCoEncoder`` state_dict
    (``encoder_q.0.*`` S3D, the 1x1x1 projections ``encoder_q.2.*`` /
    ``encoder_q.4.*``); ``prefix="encoder_k"`` names them for the bank's
    key encoder."""
    sd = _flax_to_torch(params, batch_stats, _embedder_name(
        _s3d_name, {"proj_conv1": "2", "proj_conv2": "4"}, prefix + "."))
    for idx in ("2", "4"):  # Dense (in, out) -> Conv3d (out, in, 1, 1, 1)
        k = f"{prefix}.{idx}.weight"
        sd[k] = sd[k][:, :, None, None, None]
    return sd


_SF_STAGE_RE = re.compile(r"^s(\d)_pathway(\d)(_stem)?$")
_SF_NONLOCAL = {"theta": "conv_theta", "phi": "conv_phi", "g": "conv_g",
                "out_conv": "conv_out"}


def _slowfast_name(mods: List[str]) -> str:
    """flax SlowFast path -> pyslowfast's torch name: ``s2_pathway1`` /
    ``res0`` is ``s2.pathway1_res0``, ``s1_pathway0_stem`` is
    ``s1.pathway0_stem``, a Nonlocal block's ``theta`` ... ``out_conv``
    are ``conv_theta`` ... ``conv_out``, ``head_projection`` is
    ``head.projection``."""
    m = _SF_STAGE_RE.match(mods[0])
    if m is None:
        return {"head_projection": "head.projection"}.get(
            mods[0], ".".join(mods))
    head = f"s{m.group(1)}.pathway{m.group(2)}"
    if m.group(3):
        return ".".join([head + "_stem"] + mods[1:])
    rest = mods[2:]
    if mods[1].startswith("nonlocal"):
        rest = [_SF_NONLOCAL.get(r, r) for r in rest]
    return ".".join([f"{head}_{mods[1]}"] + rest)


def flax_slowfast_to_torch(params: Mapping, batch_stats: Mapping
                           ) -> Dict[str, torch.Tensor]:
    """flax ``SlowFast`` / ``SinglePathwayResNet`` trees -> the port's
    state_dict (pyslowfast's names, every BatchNorm statistic with it)."""
    return _flax_to_torch(params, batch_stats, _slowfast_name)


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
    ``blockN.M`` aliases to the direct block names. A ``.pkl`` is a Caffe2
    checkpoint (``load_caffe2_checkpoint``). A directory (an orbax
    checkpoint of the JAX package) raises: it cannot be read without JAX.
    The file is unpickled: load trusted checkpoints only."""
    if path.endswith(".pkl"):
        return load_caffe2_checkpoint(path)
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


# --------------------------------------------------------------------------
# Caffe2 / Sub-BN / 2-D inflation import (the JAX package's
# train/checkpoint.py:665-862; reference
# models/slowfast/slowfast/utils/checkpoint.py:107-389 and
# c2_model_loading.py)

# Caffe2 blob name -> pyslowfast torch name, applied in order (the JAX
# package's _C2_NAME_RULES, reference c2_model_loading.py:9-112).
_C2_NAME_RULES = [
    # nonlocal: 'nonlocal_conv3_1_theta_w' -> 's3.pathway0_nonlocal1.conv_theta.weight'
    (r"^nonlocal_conv([0-9]+)_([0-9]+)_(.*)", r"s\1.pathway0_nonlocal\2_\3"),
    (r"^(.*)_nonlocal([0-9]+)_(theta|g|phi|out)(.*)",
     r"\1_nonlocal\2.conv_\3\4"),
    (r"^(.*)_nonlocal([0-9]+)_(bn)_(.*)", r"\1_nonlocal\2.\3.\4"),
    # fast->slow fusion: 't_pool1_subsample*' / 't_resN_i_branch2c_bn_subsample*'
    (r"^t_pool1_subsample_bn_(.*)", r"s1_fuse.bn.\1"),
    (r"^t_pool1_subsample_(.*)", r"s1_fuse.conv_f2s.\1"),
    (r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_bn_(.*)",
     r"s\1_fuse.bn.\3"),
    (r"^t_res([0-9]+)_([0-9]+)_branch2c_bn_subsample_(.*)",
     r"s\1_fuse.conv_f2s.\3"),
    # slow pathway residual blocks + stem
    (r"^res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)",
     r"s\1.pathway0_res\2.branch\3.\4_\5"),
    (r"^res_conv1_bn_(.*)", r"s1.pathway0_stem.bn.\1"),
    (r"^conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
    (r"^res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)",
     r"s\1.pathway0_res\2.branch\3_\4"),
    (r"^res_conv1_(.*)", r"s1.pathway0_stem.conv.\1"),
    # fast pathway ('t_' prefix)
    (r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)([a-z])_(.*)",
     r"s\1.pathway1_res\2.branch\3.\4_\5"),
    (r"^t_res_conv1_bn_(.*)", r"s1.pathway1_stem.bn.\1"),
    (r"^t_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
    (r"^t_res([0-9]+)_([0-9]+)_branch([0-9]+)_(.*)",
     r"s\1.pathway1_res\2.branch\3_\4"),
    (r"^t_res_conv1_(.*)", r"s1.pathway1_stem.conv.\1"),
    # classifier head + parameter-suffix normalization
    (r"pred_(.*)", r"head.projection.\1"),
    (r"(.*)bn.b\Z", r"\1bn.bias"),
    (r"(.*)bn.s\Z", r"\1bn.weight"),
    (r"(.*)bn.rm\Z", r"\1bn.running_mean"),
    (r"(.*)bn.riv\Z", r"\1bn.running_var"),
    (r"(.*)[\._]b\Z", r"\1.bias"),
    (r"(.*)[\._]w\Z", r"\1.weight"),
]


def caffe2_name_to_torch(name: str) -> str:
    """Apply the Caffe2 -> pyslowfast naming rules in order (reference
    get_name_convert_func, c2_model_loading.py:9-112)."""
    for src, dst in _C2_NAME_RULES:
        name = re.sub(src, dst, name)
    return name


def _is_c2_solver_blob(key: str) -> bool:
    """Caffe2 solver / bookkeeping blobs, not model weights, matched as
    name segments (a weight blob whose name merely contains 'lr' is kept),
    as the JAX package matches them."""
    return (key == "lr" or key.endswith("_lr")
            or key == "momentum" or key.endswith("_momentum")
            or key == "model_iter" or key.endswith("_model_iter")
            or key.startswith("__"))


def caffe2_blobs_to_torch_sd(blobs: Mapping[str, Any],
                             verbose: bool = True) -> Dict[str, torch.Tensor]:
    """{Caffe2 blob name: array} -> a pyslowfast state_dict of CPU tensors
    (reference slowfast/utils/checkpoint.py:206-263). Caffe2 conv blobs
    share torch's (Cout, Cin, kT, kH, kW) layout, so they load as they
    are; solver blobs are skipped."""
    sd, skipped = {}, []
    for key, blob in blobs.items():
        if _is_c2_solver_blob(key):
            skipped.append(key)
            continue
        sd[caffe2_name_to_torch(key)] = torch.from_numpy(
            np.array(blob, copy=True))
    if skipped and verbose:
        print(f"caffe2 import: skipped {len(skipped)} solver/bookkeeping "
              f"blobs (first: {skipped[0]})")
    return sd


def load_caffe2_checkpoint(path: str) -> Dict[str, Any]:
    """A Caffe2 pickle ``{"blobs": {...}}`` (the public pretrained SlowFast
    distribution format) -> ``{"torch_state_dict", "epoch": 0,
    "best_prec1": 0.0}``, as ``load_torch_checkpoint`` returns. Read with
    ``encoding="latin1"`` (Python 2 pickles); unpickled: trusted files
    only."""
    with open(path, "rb") as f:
        ckpt = pickle.load(f, encoding="latin1")
    blobs = ckpt["blobs"] if isinstance(ckpt, dict) and "blobs" in ckpt \
        else ckpt
    return {"torch_state_dict": caffe2_blobs_to_torch_sd(blobs),
            "epoch": 0, "best_prec1": 0.0}


def sub_to_normal_bn_sd(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A Sub-BN state_dict with plain-BN keys (reference sub_to_normal_bn,
    slowfast/utils/checkpoint.py:290-329): ``bn.bn.*`` running statistics
    become ``bn.*``, ``bn.split_bn.*`` and the wrapper's duplicate affine
    go, (C,1,1,1) affines become (C,). Leaves a plain state_dict as it
    is; numpy arrays or tensors."""
    out = {}
    for key, v in sd.items():
        if ".split_bn." in key:
            continue
        if key.endswith(("bn.bn.running_mean", "bn.bn.running_var",
                         "bn.bn.num_batches_tracked")):
            key = key.replace("bn.bn.", "bn.")
        elif "bn.bn." in key:
            continue  # duplicate affine copy held by the wrapper
        if key.endswith(("bn.weight", "bn.bias")) and np.ndim(v) == 4:
            v = v[:, 0, 0, 0]
        out[key] = v
    return out


def inflate_kernel(own: torch.Tensor, v: torch.Tensor,
                   inflate_temporal: bool) -> torch.Tensor:
    """``v`` shaped for ``own``, a (Cout, Cin, kT, kH, kW) convolution
    kernel, where it can be: a 2-D (Cout, Cin, kH, kW) kernel is one of
    temporal size 1 (the JAX ``_conv_t``); with ``inflate_temporal`` a
    kernel of temporal size 1 is tiled kT times along dimension 2 and
    divided by kT (the JAX ``merge_pretrained(inflate_temporal=True)``;
    reference inflate_weight, slowfast/utils/checkpoint.py:139-175), so a
    temporally constant input gives the 2-D network's activations. Any
    other ``v`` comes back as it is."""
    if own.ndim != 5 or v.ndim not in (4, 5):
        return v
    if v.ndim == 4:
        v = v[:, :, None]
    kt = own.shape[2]
    if (inflate_temporal and v.shape[2] == 1 and kt > 1
            and v.shape[:2] == own.shape[:2]
            and v.shape[3:] == own.shape[3:]):
        v = v.repeat(1, 1, kt, 1, 1) / kt
    return v


_HEAD_PREFIXES = ("fc1.", "bn_proj.", "fc2.")


def _is_s2d_for(own: torch.Tensor, v: torch.Tensor) -> bool:
    """A 7x7 stem weight offered to a space-to-depth stem (the JAX
    ``torch_resnet3d_to_flax(stem_s2d=True)`` transform)."""
    return (own.ndim == v.ndim == 5 and tuple(own.shape[-2:]) == (4, 4)
            and tuple(v.shape[-2:]) == (7, 7)
            and own.shape[1] == 4 * v.shape[1])


def _own_name(k: str, own: Mapping[str, torch.Tensor]) -> str:
    """A checkpoint key's name in ``own``: a ``backbone.`` prefix (the
    remapped MoCo ``encoder_q.0.``) is dropped where ``own`` has no such
    name, or read as ``encoder_q.0.`` where ``own`` is a MoCo encoder."""
    if k in own or not k.startswith("backbone."):
        return k
    rest = k[len("backbone."):]
    return "encoder_q.0." + rest if "encoder_q.0." + rest in own else rest


def load_encoder_state(model: torch.nn.Module,
                       state_dict: Mapping[str, torch.Tensor],
                       verbose: bool = True,
                       inflate_temporal: bool = False) -> Dict[str, list]:
    """Load every tensor of ``state_dict`` whose name (``_own_name``) and
    shape match a tensor of ``model``, as the JAX package's partial load
    does (``merge_pretrained``): a Sub-BN state_dict is normalized first
    (``sub_to_normal_bn_sd``), a 7x7 ``conv1.weight`` offered to a
    space-to-depth stem is transformed to it (``conv1_kernel_to_s2d``), a
    2-D kernel is one of temporal size 1 and, with ``inflate_temporal``
    (``SLOWFAST.CHECKPOINT_INFLATE``), such a kernel is inflated to the
    model's (``inflate_kernel``). Prints what it skipped and what it kept
    at init; raises ``KeyError`` when a backbone weight or statistic
    (anything outside the projection head but the ``num_batches_tracked``
    counters) gets no value. -> the names loaded, skipped and missing."""
    own = model.state_dict()
    loaded, skipped = {}, []
    for k, v in sub_to_normal_bn_sd(state_dict).items():
        name = _own_name(k, own)
        if name == "conv1.weight" and name in own and _is_s2d_for(own[name], v):
            v = conv1_kernel_to_s2d(v)
        if name in own:
            v = inflate_kernel(own[name], v, inflate_temporal)
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
                     verbose: bool = True,
                     inflate_temporal: bool = False) -> Tuple[int, int]:
    """'neq' partial load (the JAX package's ``merge_pretrained``; reference
    coclr_utils/utils.py:93-118): every tensor of ``model`` whose name and
    shape match one of ``state_dict`` (a Sub-BN one normalized, a 2-D
    kernel read as one of temporal size 1) takes its value, the rest keep
    their init; ``inflate_temporal`` inflates a kernel of temporal size 1
    to the model's (``inflate_kernel``). Prints and returns (matched and
    inflated, kept at init)."""
    own = model.state_dict()
    take, inflated = {}, 0
    for k, v in sub_to_normal_bn_sd(state_dict).items():
        if k not in own:
            continue
        w = inflate_kernel(own[k], v, inflate_temporal)
        if tuple(own[k].shape) == tuple(w.shape):
            take[k] = w.to(own[k].dtype)
            inflated += int(w.numel() != v.numel())  # tiled kT times
    model.load_state_dict(take, strict=False)
    matched, kept = len(take), len(own) - len(take)
    if verbose:
        msg = f"partial load: matched {matched} tensors, kept {kept} at init"
        if inflate_temporal:
            msg += f", temporally inflated {inflated}"
        print(msg)
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
    """The raw payload of a ``.pth.tar`` on the CPU, or a Caffe2 ``.pkl``
    as ``load_caffe2_checkpoint`` reads it (the JAX ``load_checkpoint``
    dispatches on the extension too); unpickled: trusted files only."""
    if path.endswith(".pkl"):
        return load_caffe2_checkpoint(path)
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
    """Carry a JAX bank (``MemTripletState``, ``NCEAverageState``,
    ``MemoryMoCoState`` or ``MoCoState``, as a mapping of its fields to
    numpy arrays, ``key_params`` as its flax tree) into the port's bank,
    whose buffers bear the same names. Every buffer must get a value; a
    field that is None (no intra-negative bank, no UberNCE labels) is
    skipped. A ``MoCoState``'s ``key_params`` become the key encoder's
    parameters; its BatchNorm statistics, which the JAX state does not
    hold (the key forward never reads them), stay as they are."""
    own = bank.state_dict()
    sd = {}
    for k, v in fields.items():
        if v is None:
            continue
        if k == "key_params":
            sd.update(flax_moco_encoder_to_torch(v, {}, prefix="encoder_k"))
            sd.update({n: t for n, t in own.items()
                       if n.startswith("encoder_k.") and n not in sd})
        else:
            sd[k] = torch.from_numpy(np.array(v)).to(own[k].dtype)
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
