"""YAML config reading (counterpart of ``nuzero_tpu/config/yaml_io.py``'s
``load_yaml``; the port only reads configs)."""

from __future__ import annotations

from typing import Any

import yaml


def load_yaml(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f)
