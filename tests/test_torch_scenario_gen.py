"""The port's scenario generator and board-size overrides against the JAX
package's: the same config dicts and the same packed arrays, exactly (both
draw from NumPy's generators in the same order)."""

import math
import os

import numpy as np
import pytest

from nuzero_tpu.envs.scs import scenario_gen as jax_gen
from nuzero_tpu.envs.scs.scenario import load_scenario as jax_load_scenario
from nuzero_tpu_torch.envs.scs import scenario_gen
from nuzero_tpu_torch.envs.scs.scenario import load_scenario

SCENARIOS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "configs", "scenarios")
FIELDS = ("rows", "cols", "turns", "stacking_limit", "n_vp", "max_game_length", "name")
ARRAYS = ("terrain_attack", "terrain_defense", "terrain_cost", "vp", "reinf_stats",
          "reinf_turn", "reinf_arrival", "reinf_count")


def assert_same_scenario(got, want, msg=""):
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), f"{msg} {field}"
    for field in ARRAYS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, f"{msg} {field}"
        np.testing.assert_array_equal(a, b, f"{msg} {field}")


def test_families_match_jax():
    assert scenario_gen.FAMILIES == jax_gen.FAMILIES


@pytest.mark.parametrize("family", jax_gen.FAMILIES)
@pytest.mark.parametrize("size", [4, 5, 10, 15])
@pytest.mark.parametrize("seed", [3, 42])
def test_generated_scenario_matches_jax(family, size, seed):
    """``generate_scenario`` gives the same dict and ``make_scenario`` the
    same arrays as the JAX generator, for every family, size and seed."""
    assert scenario_gen.generate_scenario(family, size) == jax_gen.generate_scenario(family, size)
    assert scenario_gen.generate_scenario(family, size, turns=11) == jax_gen.generate_scenario(
        family, size, turns=11)
    assert_same_scenario(scenario_gen.make_scenario(family, size, seed=seed),
                         jax_gen.make_scenario(family, size, seed=seed), f"{family} {size}")


def test_generator_refuses_what_jax_refuses():
    for args in (("bogus", 5), ("solo_soldier", 2)):
        with pytest.raises(ValueError):
            jax_gen.generate_scenario(*args)
        with pytest.raises(ValueError):
            scenario_gen.generate_scenario(*args)


def test_written_suite_matches_jax(tmp_path):
    """``write_scenario_suite`` writes the same files, byte for byte."""
    kwargs = dict(families=("randomized", "mirrored_plus", "solo_soldier"), sizes=(4, 7),
                  solo_sizes=(5, 30))
    got = scenario_gen.write_scenario_suite(str(tmp_path / "port"), **kwargs)
    want = jax_gen.write_scenario_suite(str(tmp_path / "jax"), **kwargs)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read(), a


@pytest.mark.parametrize("size", [5, 7, 9, 11, 13, 15])
def test_board_size_override_matches_jax(size):
    """``load_scenario``'s ``board_size`` and ``turns`` overrides at the size
    sweep's sizes and turn rule, ``ceil(7 * size / 5)``: every array of the
    ``Scenario`` equal to the JAX loader's."""
    path = os.path.join(SCENARIOS, "solo_scout_5.yml")
    turns = math.ceil(7 * size / 5)
    got = load_scenario(path, seed=42, board_size=size, turns=turns)
    want = jax_load_scenario(path, seed=42, board_size=size, turns=turns)
    assert (got.rows, got.cols, got.turns) == (size, size, turns)
    assert_same_scenario(got, want, f"{size}x{size}")
