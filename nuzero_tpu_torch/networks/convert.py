"""Flax network variables -> the port's ``state_dict`` (NumPy only).

``RecurrentNet``:

The Flax names (``nuzero_tpu/networks/recurrent.py``) map one to one:

    params/Conv_0/HexConv_0/kernel                       -> stem.conv.weight
    params/Scan_RecurCell_0/Conv_0/HexConv_0/kernel      -> cell.recall.conv.weight
    params/Scan_RecurCell_0/BasicBlock_{b}/Conv_{j}/...  -> cell.blocks.{b}.conv{j+1}.conv.weight
    params/ReducePolicyHead_0/Conv_{i}/...               -> policy_head.convs.{i}.conv.weight
    params/<Kind>ValueHead_0/...                         -> value_head.... (``_head``)

``MLPNetwork``, ``ConvNet`` and ``ResNet``: see ``mlp_state_dict``,
``convnet_state_dict`` and ``resnet_state_dict``.

Hex kernels are ``[7, Cin, Cout]`` on both sides.  An ortho conv
(``Conv_{i}/Conv_0/kernel``, HWIO) becomes OIHW.  A Dense ``kernel``
``[in, out]`` becomes a ``weight`` ``[out, in]``, beside its ``bias``.  A
BatchNorm's ``scale`` and ``bias`` (``params``) and ``mean`` and ``var``
(``batch_stats``) become ``weight``, ``bias``, ``running_mean`` and
``running_var``.

A value head is mapped by its tree, not by the order of its layers
(``_head``).  Flax numbers a head's ``nn.Conv``s and its hex-or-ortho
``Conv`` selectors with one counter, as both classes are named ``Conv``
(``StrangeValueHead``: ``Conv_0`` a grouped 1x1 kernel, ``Conv_1`` a
``HexConv_0``, alternating), so a ``Conv_{i}`` that holds a ``kernel`` of
its own is a 1x1 ``nn.Conv`` (-> ``pointwise.{j}.weight``, the j-th such in
``i``'s order) and one that holds a ``HexConv_0`` or ``Conv_0`` a selector
(-> ``convs.{j}.conv.weight``).  ``DepthwiseConv_{i}`` holds a
``HexDepthwiseConv_0`` kernel [7, C] or an ortho grouped ``Conv_0`` kernel
[3, 3, 1, C] (-> ``depthwise.{i}.conv.weight``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _conv_weight(node: Dict[str, Any]) -> np.ndarray:
    if "HexConv_0" in node:
        return np.asarray(node["HexConv_0"]["kernel"], np.float32)
    return np.asarray(node["Conv_0"]["kernel"], np.float32).transpose(3, 2, 0, 1)


def _numbered(node: Dict[str, Any], prefix: str):
    keys = sorted(
        (k for k in node if k.startswith(prefix + "_")),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    return [node[k] for k in keys]


def recurrent_net_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Convert a Flax ``RecurrentNet``'s variables (nested dicts of arrays)."""
    params = variables["params"]
    out = {"stem.conv.weight": _conv_weight(params["Conv_0"])}
    cell = params["Scan_RecurCell_0"]
    if "Conv_0" in cell:
        out["cell.recall.conv.weight"] = _conv_weight(cell["Conv_0"])
    for b, block in enumerate(_numbered(cell, "BasicBlock")):
        for j, conv in enumerate(_numbered(block, "Conv")):
            out[f"cell.blocks.{b}.conv{j + 1}.conv.weight"] = _conv_weight(conv)
    stats = variables.get("batch_stats", {})
    _head(out, "policy_head", params["ReducePolicyHead_0"], {})
    value = _value_head_name(params)
    _head(out, "value_head", params[value], stats.get(value, {}))
    return out


def _value_head_name(params: Dict[str, Any]) -> str:
    """The Flax name of a net's value head: ``<Kind>ValueHead_0``."""
    (name,) = [k for k in params if k.endswith("ValueHead_0")]
    return name


def _dense(out: Dict[str, np.ndarray], prefix: str, node: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = np.asarray(node["kernel"], np.float32).T.copy()
    if "bias" in node:
        out[f"{prefix}.bias"] = np.asarray(node["bias"], np.float32)


def _batch_norm(out, prefix: str, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
    out[f"{prefix}.weight"] = np.asarray(params["scale"], np.float32)
    out[f"{prefix}.bias"] = np.asarray(params["bias"], np.float32)
    out[f"{prefix}.running_mean"] = np.asarray(stats["mean"], np.float32)
    out[f"{prefix}.running_var"] = np.asarray(stats["var"], np.float32)


def _head(out, prefix: str, params, stats) -> None:
    """A head's convs, 1x1 convs, depthwise convs and BatchNorms (Flax
    ``Conv_{i}``, ``DepthwiseConv_{i}``, ``BatchNorm_{i}``; see the module's
    docstring), or the dense value head."""
    if "Dense_0" in params:
        out[f"{prefix}.conv.conv.weight"] = _conv_weight(params["Conv_0"])
        if "BatchNorm_0" in params:
            _batch_norm(out, f"{prefix}.norm", params["BatchNorm_0"], stats["BatchNorm_0"])
        _dense(out, f"{prefix}.dense1", params["Dense_0"])
        _dense(out, f"{prefix}.dense2", params["Dense_1"])
        return
    convs = _numbered(params, "Conv")
    for i, conv in enumerate(c for c in convs if "kernel" not in c):
        out[f"{prefix}.convs.{i}.conv.weight"] = _conv_weight(conv)
    for i, conv in enumerate(c for c in convs if "kernel" in c):
        out[f"{prefix}.pointwise.{i}.weight"] = _conv_weight({"Conv_0": conv})
    for i, dw in enumerate(_numbered(params, "DepthwiseConv")):
        kernel = (np.asarray(dw["HexDepthwiseConv_0"]["kernel"], np.float32)
                  if "HexDepthwiseConv_0" in dw else _conv_weight(dw))
        out[f"{prefix}.depthwise.{i}.conv.weight"] = kernel
    for i, bn in enumerate(_numbered(params, "BatchNorm")):
        _batch_norm(out, f"{prefix}.norms.{i}", bn, stats[f"BatchNorm_{i}"])


def value_head_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Convert a lone Flax value head's variables (``make_value_head(...)``
    initialised on its own), keyed as the port's head's ``state_dict``."""
    out = {}
    _head(out, "head", variables["params"], variables.get("batch_stats", {}))
    return {k[len("head."):]: v for k, v in out.items()}


def mlp_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Convert a Flax ``MLPNetwork``'s variables: ``Dense_{i}`` in creation
    order are the trunk (``hidden_layers + 1``), then the 3 policy and the 3
    value layers."""
    dense = _numbered(variables["params"], "Dense")
    n_trunk = len(dense) - 6
    out = {}
    for i, node in enumerate(dense):
        if i < n_trunk:
            _dense(out, f"trunk.{i}", node)
        elif i < n_trunk + 3:
            _dense(out, f"policy.{i - n_trunk}", node)
        else:
            _dense(out, f"value.{i - n_trunk - 3}", node)
    return out


def convnet_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Convert a Flax ``ConvNet``'s variables: ``Conv_{i}`` -> ``convs.{i}``."""
    params = variables["params"]
    out = {f"convs.{i}.conv.weight": _conv_weight(conv)
           for i, conv in enumerate(_numbered(params, "Conv"))}
    _head(out, "policy_head", params["ReducePolicyHead_0"], {})
    _head(out, "value_head", params["ReduceValueHead_0"], {})
    return out


def resnet_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Convert a Flax ``ResNet``'s variables (``batch_stats`` where it has
    BatchNorm): ``Conv_0`` / ``BatchNorm_0`` -> ``stem`` / ``stem_norm``,
    ``BasicBlock_{b}`` -> ``blocks.{b}``, the heads by name."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = {"stem.conv.weight": _conv_weight(params["Conv_0"])}
    if "BatchNorm_0" in params:
        _batch_norm(out, "stem_norm", params["BatchNorm_0"], stats["BatchNorm_0"])
    for b, block in enumerate(_numbered(params, "BasicBlock")):
        for j, conv in enumerate(_numbered(block, "Conv")):
            out[f"blocks.{b}.conv{j + 1}.conv.weight"] = _conv_weight(conv)
        if "BatchNorm_0" in block:
            _batch_norm(out, f"blocks.{b}.norm", block["BatchNorm_0"],
                        stats[f"BasicBlock_{b}"]["BatchNorm_0"])
    _head(out, "policy_head", params["ReducePolicyHead_0"],
          stats.get("ReducePolicyHead_0", {}))
    value = _value_head_name(params)
    _head(out, "value_head", params[value], stats.get(value, {}))
    return out
