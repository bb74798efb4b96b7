"""The port's batch-first SCS engine against the JAX engine as the oracle.

Lockstep random playouts of B games through both engines from the same
scenario; at every step legality, observations, player, terminal flags,
turn/stage and the packed state must agree exactly (both engines do the
same integer and small-dyadic float arithmetic).  The scenarios are the
committed YAML files and the scenario generator's families at two sizes;
with ``randomize_vp`` the JAX engine's drawn layouts are handed to the
port's ``init``."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
from nuzero_tpu.envs.scs import scenario_gen as jax_scenario_gen
from nuzero_tpu.utils.packing import make_packer as jax_make_packer
from nuzero_tpu_torch.envs.scs import scenario_gen
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import board_sides, load_scenario
from nuzero_tpu_torch.utils.packing import make_packer

torch.set_num_threads(2)

SCENARIOS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "scenarios",
)
# (scenario, seed, steps): a YAML file, or "<family>_<size>" of the
# scenario generator.
CASES = [
    ("open_field_5.yml", 42, 140),
    ("river_crossing_10.yml", 7, 70),
    ("solo_scout_5.yml", 3, 70),
    ("solo_soldier_10.yml", 5, 70),
] + [(f"{family}_{size}", 11, 60) for family in scenario_gen.FAMILIES for size in (4, 7)]


def _scenarios(name, seed):
    """(JAX Scenario, port Scenario) of a case."""
    if name.endswith(".yml"):
        path = os.path.join(SCENARIOS, name)
        return jax_load_scenario(path, seed=seed), load_scenario(path, seed=seed)
    family, size = name.rsplit("_", 1)
    return (jax_scenario_gen.make_scenario(family, int(size), seed=seed),
            scenario_gen.make_scenario(family, int(size), seed=seed))


@pytest.mark.parametrize("name,seed", [(n, s) for n, s, _ in CASES])
def test_scenario_arrays_match(name, seed):
    want, got = _scenarios(name, seed)
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
    jscenario, tscenario = _scenarios(name, seed)
    jenv = JaxSCSGame(jscenario)
    tenv = SCSGame(tscenario, device="cpu")
    jstate = jax.jit(jax.vmap(jenv.init))(jax.random.split(jax.random.key(seed), B))
    _lockstep(jenv, tenv, jstate, tenv.init(B), steps, seed, name)


def _lockstep(jenv, tenv, jstate, tstate, steps, seed, name):
    """Random legal actions through both engines; every view of the state
    equal at every step."""
    B = tstate.stage.shape[0]
    assert tenv.num_actions == jenv.num_actions
    assert tenv.observation_shape == jenv.observation_shape
    assert tenv.max_game_length == jenv.max_game_length

    jpack, _, jdim = jax_make_packer(jenv.init(jax.random.key(0)))
    tpack, tunpack, tdim = make_packer(tstate)
    assert tdim == jdim

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


# --------------------------------------------------------------------------- #
# randomize_vp: per-game victory points                                       #
# --------------------------------------------------------------------------- #


def _resized(size):
    """``solo_scout_5.yml`` at ``size`` x ``size``, turns ceil(7*size/5) (the
    size sweep's maps), in both packages."""
    path = os.path.join(SCENARIOS, "solo_scout_5.yml")
    turns = math.ceil(7 * size / 5)
    return (jax_load_scenario(path, seed=42, board_size=size, turns=turns),
            load_scenario(path, seed=42, board_size=size, turns=turns))


@pytest.mark.parametrize("name,cols", [("solo_scout_5.yml", 5), ("solo_soldier_10.yml", 10)])
def test_randomize_vp_draws_one_cell_in_each_owners_half(name, cols):
    """Over many draws: one cell per player and game, always in the owner's
    half (``board_sides``), every cell of each half drawn, and the layouts
    differ across games; the rest of the state is the static init's."""
    _, scenario = _scenarios(name, 1)
    env = SCSGame(scenario, randomize_vp=True, device="cpu")
    B = 4096
    state = env.init(B, generator=torch.Generator().manual_seed(0))
    vp = state.vp.numpy()
    assert vp.shape == (B, 2, env.R, env.C)
    assert (vp.sum((2, 3)) == 1).all()
    p0_last, p1_first = board_sides(cols)
    half = np.zeros((2, env.R, env.C), bool)
    half[0, :, : p0_last + 1] = True
    half[1, :, p1_first:] = True
    assert not (vp & ~half).any()
    # Uniform over each half: every cell within 5 standard deviations of
    # its expected count, and the two players' cells drawn independently
    # (every pair of cells occurs, where the pairs are few).
    cells = half.reshape(2, -1).sum(1)
    for p in (0, 1):
        counts = vp[:, p].sum(0)[half[p]]
        expect = B / cells[p]
        assert (np.abs(counts - expect) <= 5 * np.sqrt(expect)).all()
    layouts = len({vp[b].tobytes() for b in range(B)})
    assert layouts > 1
    if cells[0] * cells[1] <= B // 8:
        assert layouts == cells[0] * cells[1]
    static = env.init(B, vp=env.vp.expand(B, -1, -1, -1))
    for field in vars(state):
        if field != "vp":
            assert torch.equal(getattr(state, field), getattr(static, field)), field
    # The same generator state draws the same layouts.
    again = env.init(B, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.vp, state.vp)


def test_randomize_vp_refuses_and_warns_as_jax():
    """More than one victory point per player is refused by both engines;
    an init with neither a generator nor a layout warns and takes the
    static layout."""
    path = os.path.join(SCENARIOS, "river_crossing_10.yml")
    with pytest.raises(ValueError):
        JaxSCSGame(jax_load_scenario(path, seed=1), randomize_vp=True)
    with pytest.raises(ValueError):
        SCSGame(load_scenario(path, seed=1), randomize_vp=True, device="cpu")
    _, scenario = _resized(5)
    env = SCSGame(scenario, randomize_vp=True, device="cpu")
    with pytest.warns(UserWarning, match="static load-time VP layout"):
        state = env.init(3)
    assert torch.equal(state.vp, env.vp.expand(3, -1, -1, -1))
    with pytest.raises(ValueError):
        env.init(3, vp=np.zeros((2, 2, 5, 5), bool))


@pytest.mark.parametrize("size", [5, 11])
def test_handed_in_layouts_reproduce_jax_init(size):
    """``init(B, vp=...)`` with the JAX engine's drawn layouts gives JAX's
    ``init(key)`` states, field for field."""
    jscenario, tscenario = _resized(size)
    jenv = JaxSCSGame(jscenario, randomize_vp=True)
    tenv = SCSGame(tscenario, randomize_vp=True, device="cpu")
    B = 16
    jstate = jax.vmap(jenv.init)(jax.random.split(jax.random.key(size), B))
    tstate = tenv.init(B, vp=np.asarray(jstate.vp))
    assert len({np.asarray(jstate.vp)[b].tobytes() for b in range(B)}) > 1
    for field in vars(tstate):
        np.testing.assert_array_equal(getattr(tstate, field).numpy(),
                                      np.asarray(getattr(jstate, field)), field)


@pytest.mark.parametrize("size,steps", [(5, 70), (11, 90)])
def test_randomize_vp_lockstep_matches_jax(size, steps):
    """Lockstep playouts from the JAX engine's drawn layouts, handed in:
    equal to JAX step by step."""
    jscenario, tscenario = _resized(size)
    jenv = JaxSCSGame(jscenario, randomize_vp=True)
    tenv = SCSGame(tscenario, randomize_vp=True, device="cpu")
    B = 8
    jstate = jax.jit(jax.vmap(jenv.init))(jax.random.split(jax.random.key(size + 1), B))
    _lockstep(jenv, tenv, jstate, tenv.init(B, vp=np.asarray(jstate.vp)), steps, size,
              f"randomize_vp {size}x{size}")
