"""Flax ``RecurrentNet`` variables -> the port's ``state_dict`` (NumPy only).

The Flax names (``nuzero_tpu/networks/recurrent.py``) map one to one:

    params/Conv_0/HexConv_0/kernel                       -> stem.conv.weight
    params/Scan_RecurCell_0/Conv_0/HexConv_0/kernel      -> cell.recall.conv.weight
    params/Scan_RecurCell_0/BasicBlock_{b}/Conv_{j}/...  -> cell.blocks.{b}.conv{j+1}.conv.weight
    params/ReducePolicyHead_0/Conv_{i}/...               -> policy_head.convs.{i}.conv.weight
    params/ReduceValueHead_0/Conv_{i}/...                -> value_head.convs.{i}.conv.weight

Hex kernels are ``[7, Cin, Cout]`` on both sides.  An ortho conv
(``Conv_{i}/Conv_0/kernel``, HWIO) becomes OIHW.
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
    for head, name in (
        ("ReducePolicyHead_0", "policy_head"),
        ("ReduceValueHead_0", "value_head"),
    ):
        for i, conv in enumerate(_numbered(params[head], "Conv")):
            out[f"{name}.convs.{i}.conv.weight"] = _conv_weight(conv)
    return out
