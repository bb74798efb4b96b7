"""YAML config I/O (counterpart of ``nuzero_tpu/config/yaml_io.py``; ref
``Utils/Functions/yaml_utils.py``): ``load_yaml`` and ``save_yaml``, and the
bulk-migration helpers that add or remove a key across a whole config
directory (ref ``yaml_utils.py:24-75``).  PyYAML only: the JAX package's
comment-preserving ruamel round trip is not ported, so a migrated file
loses its comments."""

from __future__ import annotations

import os
from typing import Any, Sequence

import yaml


def load_yaml(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)


def save_yaml(data: Any, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)


def _walk_configs(directory: str):
    for root, _, files in os.walk(directory):
        for name in sorted(files):
            if name.endswith((".yaml", ".yml")):
                yield os.path.join(root, name)


def _section(data: Any, section_path: Sequence[str]):
    """The dict at ``section_path`` inside ``data``, or None."""
    node = data
    for part in section_path:
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node if isinstance(node, dict) else None


def insert_in_all_configs(directory: str, section_path: Sequence[str], key: str,
                          value: Any) -> int:
    """Add ``key: value`` under ``section_path`` in every YAML config under
    ``directory`` (ref ``yaml_utils.py:24-52``) -> the number of files
    written."""
    count = 0
    for path in _walk_configs(directory):
        data = load_yaml(path)
        node = _section(data, section_path)
        if node is not None:
            node[key] = value
            save_yaml(data, path)
            count += 1
    return count


def remove_from_all_configs(directory: str, section_path: Sequence[str], key: str) -> int:
    """Remove ``key`` under ``section_path`` in every YAML config under
    ``directory`` (ref ``yaml_utils.py:54-75``) -> the number of files
    written."""
    count = 0
    for path in _walk_configs(directory):
        data = load_yaml(path)
        node = _section(data, section_path)
        if node is not None and key in node:
            del node[key]
            save_yaml(data, path)
            count += 1
    return count
