"""The port's batch-first SCS engine against the JAX engine as the oracle.

Lockstep random playouts of B games through both engines from the same
scenario; at every step legality, observations, player, terminal flags,
turn/stage and the packed state must agree exactly (both engines do the
same integer and small-dyadic float arithmetic)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
from nuzero_tpu.utils.packing import make_packer as jax_make_packer
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.utils.packing import make_packer

torch.set_num_threads(2)

SCENARIOS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "scenarios",
)
CASES = [
    ("open_field_5.yml", 42, 140),
    ("river_crossing_10.yml", 7, 70),
    ("solo_scout_5.yml", 3, 70),
]


@pytest.mark.parametrize("name,seed", [(n, s) for n, s, _ in CASES])
def test_scenario_arrays_match(name, seed):
    path = os.path.join(SCENARIOS, name)
    want = jax_load_scenario(path, seed=seed)
    got = load_scenario(path, seed=seed)
    for field in (
        "rows", "cols", "turns", "stacking_limit", "n_vp", "max_game_length",
    ):
        assert getattr(got, field) == getattr(want, field), field
    for field in (
        "terrain_attack", "terrain_defense", "terrain_cost", "vp",
        "reinf_stats", "reinf_turn", "reinf_arrival", "reinf_count",
    ):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("name,seed,steps", CASES)
def test_lockstep_playout_matches_jax(name, seed, steps):
    B = 8
    path = os.path.join(SCENARIOS, name)
    jenv = JaxSCSGame(jax_load_scenario(path, seed=seed))
    tenv = SCSGame(load_scenario(path, seed=seed))
    assert tenv.num_actions == jenv.num_actions
    assert tenv.observation_shape == jenv.observation_shape
    assert tenv.max_game_length == jenv.max_game_length

    jpack, _, jdim = jax_make_packer(jenv.init(jax.random.key(0)))
    tstate = tenv.init(B)
    tpack, tunpack, tdim = make_packer(tstate)
    assert tdim == jdim

    j_init = jax.jit(jax.vmap(jenv.init))
    j_step = jax.jit(jax.vmap(jenv.step))
    j_view = jax.jit(
        lambda s: (
            jax.vmap(jenv.legal_mask)(s),
            jax.vmap(jenv.observe)(s),
            jax.vmap(jenv.current_player)(s),
            jax.vmap(jenv.terminal)(s),
            jax.vmap(jenv.terminal_value)(s),
            jax.vmap(jpack)(s),
        )
    )
    jstate = j_init(jax.random.split(jax.random.key(seed), B))
    rng = np.random.default_rng(seed)
    for t in range(steps):
        legal, obs, player, term, tval, packed = map(np.asarray, j_view(jstate))
        msg = f"{name} step {t}"
        np.testing.assert_array_equal(tenv.legal_mask(tstate).numpy(), legal, msg)
        np.testing.assert_array_equal(tenv.observe(tstate).numpy(), obs, msg)
        np.testing.assert_array_equal(tenv.current_player(tstate).numpy(), player, msg)
        np.testing.assert_array_equal(tenv.terminal(tstate).numpy(), term, msg)
        np.testing.assert_array_equal(tenv.terminal_value(tstate).numpy(), tval, msg)
        np.testing.assert_array_equal(tstate.turn.numpy(), np.asarray(jstate.turn), msg)
        np.testing.assert_array_equal(tstate.stage.numpy(), np.asarray(jstate.stage), msg)
        np.testing.assert_array_equal(tpack(tstate).numpy(), packed, msg)
        # Unpacking is the inverse of packing.
        np.testing.assert_array_equal(tpack(tunpack(tpack(tstate))).numpy(), packed)
        # Random legal actions; terminal games (no legal action) take 0,
        # which both engines must accept as a total step.
        actions = np.zeros(B, np.int32)
        for b in range(B):
            ok = np.flatnonzero(legal[b])
            if ok.size:
                actions[b] = rng.choice(ok)
        jstate = j_step(jstate, jnp.asarray(actions))
        tstate = tenv.step(tstate, torch.from_numpy(actions))
    # The playout must have covered more than the placement phase.
    assert (np.asarray(jstate.turn) >= 1).any()
