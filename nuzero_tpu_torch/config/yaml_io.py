"""YAML config I/O (counterpart of ``nuzero_tpu/config/yaml_io.py``'s
``load_yaml`` and ``save_yaml``, PyYAML only; the reference's comment-
preserving round trip and bulk-migration helpers are not ported)."""

from __future__ import annotations

from typing import Any

import yaml


def load_yaml(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)


def save_yaml(data: Any, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)
