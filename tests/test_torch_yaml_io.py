"""The port's bulk config-migration helpers (``nuzero_tpu_torch/config/yaml_io.py``;
ref ``Utils/Functions/yaml_utils.py:24-75``), mirroring
``tests/test_yaml_io.py`` and held against the JAX package's: the same
migration of the same directory leaves the same data and counts (exact)."""

import os
import shutil

import pytest

from nuzero_tpu.config import yaml_io as jax_yaml_io
from nuzero_tpu_torch.config.schemas import load_training_config
from nuzero_tpu_torch.config.yaml_io import (
    insert_in_all_configs, load_yaml, remove_from_all_configs, save_yaml,
)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "training")


def _write_two_configs(d):
    for name, steps in (("a.yaml", 10), ("b.yml", 20)):
        save_yaml({"Running": {"training_steps": steps}, "Learning": {}}, str(d / name))


def test_insert_in_all_configs(tmp_path):
    _write_two_configs(tmp_path)
    n = insert_in_all_configs(str(tmp_path), ["Running"], "num_actors", 64)
    assert n == 2
    for name in ("a.yaml", "b.yml"):
        assert load_yaml(str(tmp_path / name))["Running"]["num_actors"] == 64
    # The migrated configs still load through the port's parser.
    cfg = load_training_config(str(tmp_path / "a.yaml"))
    assert cfg.running.num_actors == 64
    assert cfg.running.training_steps == 10


def test_remove_from_all_configs(tmp_path):
    _write_two_configs(tmp_path)
    insert_in_all_configs(str(tmp_path), ["Running"], "stale_knob", 1)
    n = remove_from_all_configs(str(tmp_path), ["Running"], "stale_knob")
    assert n == 2
    for name in ("a.yaml", "b.yml"):
        assert "stale_knob" not in load_yaml(str(tmp_path / name))["Running"]


def test_missing_section_untouched(tmp_path):
    save_yaml({"Other": {}}, str(tmp_path / "c.yaml"))
    assert insert_in_all_configs(str(tmp_path), ["Running"], "x", 1) == 0
    assert remove_from_all_configs(str(tmp_path), ["Running"], "x") == 0


@pytest.mark.parametrize("section,key,value", [
    (["Running"], "num_actors", 64),
    (["Learning", "Samples"], "late_heavy", True),
    (["Nowhere"], "x", 1),
])
def test_migration_equals_jax(tmp_path, section, key, value):
    """The shipped training configs migrated by each package: the same
    files touched and the same data after an insert and after a remove."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(CONFIGS, port)
    shutil.copytree(CONFIGS, ref)
    assert insert_in_all_configs(str(port), section, key, value) == \
        jax_yaml_io.insert_in_all_configs(str(ref), section, key, value)
    for name in sorted(p.name for p in port.iterdir()):
        assert load_yaml(str(port / name)) == jax_yaml_io.load_yaml(str(ref / name)), name
    assert remove_from_all_configs(str(port), section, key) == \
        jax_yaml_io.remove_from_all_configs(str(ref), section, key)
    for name in sorted(p.name for p in port.iterdir()):
        assert load_yaml(str(port / name)) == jax_yaml_io.load_yaml(str(ref / name)), name
