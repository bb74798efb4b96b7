"""The probe state sets and ``SCSGame.simple_state`` in the port, against
the JAX package on the CPU (``tests/test_state_sets.py``'s fixtures:
``open_field_5.yml`` and ``solo_scout_5.yml``, seed 3): every state field
and every observation exactly."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
from nuzero_tpu.evaluation import state_sets as jax_state_sets
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.evaluation import STATE_SET_BUILDERS
from nuzero_tpu_torch.evaluation.state_sets import (
    MIRRORED_SPECS, R_UNBALANCED_SPECS, SOLO_SPECS, UNBALANCED_SPECS, build_state_set,
    mirrored_state_set, r_unbalanced_state_set, solo_state_set, unbalanced_state_set,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _path(name):
    return os.path.join(REPO, "configs", "scenarios", name)


@pytest.fixture(scope="module")
def open_field():
    return SCSGame(load_scenario(_path("open_field_5.yml"), seed=3), device="cpu")


@pytest.fixture(scope="module")
def solo():
    return SCSGame(load_scenario(_path("solo_scout_5.yml"), seed=3), device="cpu")


@pytest.fixture(scope="module")
def jax_games():
    return {name: JaxSCSGame(jax_load_scenario(_path(name), seed=3))
            for name in ("open_field_5.yml", "solo_scout_5.yml")}


def test_simple_state_places_units(open_field):
    g = open_field
    st = g.simple_state(9, [(1, 0, 1), (1, 1, 1), (0, 0, 0)])
    assert int(st.alive.sum()) == 3
    assert int(st.turn) == 9
    assert not bool(st.terminal)
    alive = st.alive[0]
    assert alive[0] and alive[g.S] and alive[g.S + 1]
    board = st.board[0]
    assert board[0, 1, 0] == g.S and board[1, 1, 0] == g.S + 1
    assert board[0, 0, 0] == 0
    assert bool(g.legal_mask(st).any())


def test_simple_state_stacking(open_field):
    board = open_field.simple_state(9, [(1, 0, 1), (1, 0, 1)]).board[0]
    assert board[0, 1, 0] == open_field.S and board[0, 1, 1] == open_field.S + 1


@pytest.mark.parametrize("placements,match", [
    ([(1, 0, 0), (1, 1, 1)], "unit slots"),  # the solo scenario has 1 slot a player
    ([(2, 0, 0)], "player must be 0 or 1"),
])
def test_simple_state_errors(solo, jax_games, placements, match):
    """The port raises where the JAX engine raises, with its message."""
    with pytest.raises(ValueError, match=match):
        solo.simple_state(7, placements)
    with pytest.raises(ValueError, match=match):
        jax_games["solo_scout_5.yml"].simple_state(7, placements)


def test_simple_state_stacking_limit_raises(open_field, jax_games):
    over = [(1, 0, 1)] * (open_field.K + 1)
    with pytest.raises(ValueError, match="stacking limit"):
        open_field.simple_state(9, over)
    with pytest.raises(ValueError, match="stacking limit"):
        jax_games["open_field_5.yml"].simple_state(9, over)


def test_mirrored_and_unbalanced_sets_shapes(open_field):
    for builder in (mirrored_state_set, unbalanced_state_set, r_unbalanced_state_set):
        obs = builder(open_field)
        assert obs.shape == (6,) + open_field.observation_shape
        assert obs.dtype == torch.float32 and obs.device.type == "cpu"
        assert bool(torch.isfinite(obs).all())


def test_solo_set(solo):
    obs = solo_state_set(solo)
    assert obs.shape == (6,) + solo.observation_shape
    assert bool(torch.isfinite(obs).all())
    base = build_state_set(solo, SOLO_SPECS[:1])
    assert not torch.allclose(obs[0], obs[5])
    assert torch.equal(obs[0], base[0])


def test_probe_states_distinct(open_field):
    flat = build_state_set(open_field, MIRRORED_SPECS).reshape(len(MIRRORED_SPECS), -1)
    for i in range(len(flat)):
        for j in range(i + 1, len(flat)):
            assert not torch.allclose(flat[i], flat[j]), (i, j)


SCENARIO_OF = {"mirrored": "open_field_5.yml", "unbalanced": "open_field_5.yml",
               "r_unbalanced": "open_field_5.yml", "solo": "solo_scout_5.yml"}


@pytest.mark.parametrize("name", sorted(STATE_SET_BUILDERS))
def test_state_set_equals_jax(name, open_field, solo, jax_games):
    """Each set's observations equal the JAX package's bit for bit."""
    scenario = SCENARIO_OF[name]
    env = solo if scenario == "solo_scout_5.yml" else open_field
    got = STATE_SET_BUILDERS[name](env).numpy()
    want = np.asarray(jax_state_sets.STATE_SET_BUILDERS[name](jax_games[scenario]))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


CASES = [("open_field_5.yml", spec) for spec in (*MIRRORED_SPECS, *UNBALANCED_SPECS,
                                                  *R_UNBALANCED_SPECS)]
CASES += [("solo_scout_5.yml", spec) for spec in SOLO_SPECS]
CASES += [("open_field_5.yml", (0, [])), ("open_field_5.yml", (30, [(0, 2, 2), (1, 2, 3)]))]


@pytest.mark.parametrize("scenario,spec", CASES[::4] + CASES[-2:])
def test_simple_state_equals_jax_field_for_field(scenario, spec, open_field, solo, jax_games):
    """Every field of the probe state equals the JAX engine's, dtype too:
    the slot assignment, the cleared reinforcements and the stage the
    auto-advance leaves."""
    turn, placements = spec
    env = solo if scenario == "solo_scout_5.yml" else open_field
    got = env.simple_state(turn, placements)
    want = jax_games[scenario].simple_state(turn, placements)
    for f in dataclasses.fields(got):
        a = getattr(got, f.name)[0].numpy()
        b = np.asarray(getattr(want, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(env.observe(got)[0].numpy(),
                                  np.asarray(jax_games[scenario].observe(want)))
    assert bool(jnp.isfinite(jax_games[scenario].observe(want)).all())
