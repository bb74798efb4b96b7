"""The port's self-play move, end to end, against the JAX self-play step.

Both run ``init_selfplay`` then ``make_selfplay_step`` with subtree reuse
on the same scenario and on the same RecurrentNet weights (JAX init,
converted).  Positions, actions (through the packed game states), policy
rows, move counts and tree structure must agree exactly; values, which
come out of the two frameworks' convolutions, agree within 1e-5."""

import os

import jax
import numpy as np
import torch

from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame
from nuzero_tpu.envs.scs import load_scenario as jax_load_scenario
from nuzero_tpu.networks import NetworkManager as JaxManager
from nuzero_tpu.networks import RecurrentNet as JaxRecurrentNet
from nuzero_tpu.search.mcts import SearchParams as JaxSearchParams
from nuzero_tpu.training.selfplay import init_selfplay as jax_init_selfplay
from nuzero_tpu.training.selfplay import make_selfplay_step as jax_make_selfplay_step
from nuzero_tpu.utils.packing import make_packer as jax_make_packer
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.networks.convert import recurrent_net_state_dict
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.search.mcts import SearchParams
from nuzero_tpu_torch.training.selfplay import init_selfplay, make_selfplay_step
from nuzero_tpu_torch.utils.packing import make_packer

torch.set_num_threads(2)

PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "scenarios", "open_field_5.yml",
)


def _torch_net(env, filters=8):
    net = RecurrentNet(
        env.observation_shape[0], env.action_space_shape[0],
        num_filters=filters, num_blocks=2, recall=True, hex=True,
    )
    mgr = NetworkManager(net, env.observation_shape)

    def apply(variables, obs):
        p, v, _ = mgr.apply(variables, obs, iters_to_do=2)
        return p, v

    return mgr, apply


def test_selfplay_step_matches_jax():
    B, sims = 4, 8
    jenv = JaxSCSGame(jax_load_scenario(PATH, seed=42))
    tenv = SCSGame(load_scenario(PATH, seed=42))

    jmgr = JaxManager(
        JaxRecurrentNet(
            policy_channels=jenv.action_space_shape[0], num_filters=8,
            num_blocks=2, recall=True, hex=True,
        ),
        jenv.observation_shape,
    )
    jvars = jax.jit(jmgr.init)(jax.random.key(0))

    def jnet(v, obs):
        p, val, _ = jmgr.apply(v, obs, iters_to_do=2)
        return p, val

    tmgr, tnet = _torch_net(tenv)
    tvars = {
        k: torch.tensor(v)
        for k, v in recurrent_net_state_dict(jax.tree.map(np.asarray, jvars)).items()
    }

    jparams = JaxSearchParams(num_simulations=sims)
    tparams = SearchParams(num_simulations=sims)
    jstep = jax.jit(jax_make_selfplay_step(jenv, jnet, jparams, training=False))
    tstep = make_selfplay_step(tenv, tnet, tparams, training=False)
    jsp = jax_init_selfplay(jenv, B, jax.random.key(1), search_params=jparams)
    tsp = init_selfplay(tenv, B, torch.Generator().manual_seed(1), search_params=tparams)
    jpack, _, _ = jax_make_packer(jenv.init(jax.random.key(0)))
    tpack, _, _ = make_packer(tsp.games)

    for move in range(3):
        jsp, jfin, jstats = jstep(jvars, jsp)
        tsp, tfin, tstats = tstep(tvars, tsp)
        msg = f"move {move}"
        np.testing.assert_array_equal(
            tpack(tsp.games).numpy(), np.asarray(jax.vmap(jpack)(jsp.games)), msg
        )
        np.testing.assert_array_equal(tsp.policy_buf.numpy(), np.asarray(jsp.policy_buf), msg)
        np.testing.assert_array_equal(tsp.state_buf.numpy(), np.asarray(jsp.state_buf), msg)
        np.testing.assert_array_equal(tsp.move_count.numpy(), np.asarray(jsp.move_count), msg)
        assert int(tsp.total_moves) == int(jsp.total_moves) == B * (move + 1)
        np.testing.assert_array_equal(tsp.tree_valid.numpy(), np.asarray(jsp.tree_valid), msg)
        np.testing.assert_array_equal(tfin.mask.numpy(), np.asarray(jfin.mask), msg)
        for field in ("visit", "parent", "child", "root", "free"):
            np.testing.assert_array_equal(
                getattr(tsp.tree, field).numpy(), np.asarray(getattr(jsp.tree, field)),
                err_msg=f"{msg} tree.{field}",
            )
        np.testing.assert_allclose(
            tsp.tree.value_sum.numpy(), np.asarray(jsp.tree.value_sum),
            rtol=0, atol=1e-5 * sims,
        )
        for key, value in jstats.items():
            tol = 1e-5 if key in ("root_value_mean",) else 0
            np.testing.assert_allclose(
                float(tstats[key]), float(value), rtol=0, atol=tol, err_msg=key
            )
    assert tsp.tree_valid.any()


def test_selfplay_emits_valid_games():
    """Recorded policies are distributions over the played prefix and
    finished games carry values in {-1, 0, 1} (``tests/test_training.py``'s
    self-play check, on SCS cut to two turns so games end quickly)."""
    env = SCSGame(load_scenario(PATH, seed=42, turns=2))
    mgr, net = _torch_net(env)
    variables = mgr.init(torch.Generator().manual_seed(0))
    params = SearchParams(num_simulations=4)
    step = make_selfplay_step(env, net, params, training=True)
    B = 4
    sp = init_selfplay(env, B, torch.Generator().manual_seed(1), search_params=params)
    total_finished = 0
    for _ in range(40):
        sp, finished, _ = step(variables, sp)
        m = finished.mask.numpy()
        total_finished += int(m.sum())
        for bi in np.flatnonzero(m):
            ln = int(finished.length[bi])
            assert 1 <= ln <= env.max_game_length
            assert float(finished.final_value[bi]) in (-1.0, 0.0, 1.0)
            psum = finished.policy[bi, :ln].sum(-1).numpy()
            np.testing.assert_allclose(psum, 1.0, atol=1e-5)
        if total_finished >= B:
            break
    assert total_finished >= B
    assert int(sp.total_games) == total_finished


def test_trajectory_overflow_discards_and_resets():
    """A game that fills its trajectory rows without ending is dropped:
    its slot restarts from a fresh game, its tree is not carried, and it
    is not emitted as finished (the JAX step's overflow discard)."""
    env = SCSGame(load_scenario(PATH, seed=42))
    mgr, net = _torch_net(env)
    variables = mgr.init(torch.Generator().manual_seed(0))
    params = SearchParams(num_simulations=2)
    step = make_selfplay_step(env, net, params, training=False)
    B = 2
    sp = init_selfplay(
        env, B, torch.Generator().manual_seed(1), trajectory_capacity=2, search_params=params
    )
    assert sp.state_buf.shape[1] == 2
    pack, _, _ = make_packer(sp.games)
    fresh = pack(env.init(B))
    sp, finished, _ = step(variables, sp)
    assert sp.move_count.tolist() == [1, 1]
    sp, finished, _ = step(variables, sp)
    assert not bool(finished.mask.any())
    assert sp.move_count.tolist() == [0, 0]
    assert not bool(sp.tree_valid.any())
    assert int(sp.total_games) == 0 and int(sp.total_moves) == 2 * B
    torch.testing.assert_close(pack(sp.games), fresh, rtol=0, atol=0)
