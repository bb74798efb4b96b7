"""The port's pygame viewer (``nuzero_tpu_torch/utils/viewer.py``) and
``--analyse``, headless under the SDL dummy driver, mirroring
``tests/test_viewer.py`` and held against the JAX package: the frame of the
same position and a counter image equal JAX's pixel for pixel, and
``--analyse`` on the committed ``scs_solo_r3`` weights plays the same greedy
actions as ``run.py --analyse`` (all exact).  Skips where pygame is not
installed (the card machine has none)."""

import json
import os

import numpy as np
import pytest
import torch

pygame = pytest.importorskip("pygame", reason="the viewer needs pygame")

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

import run as jax_runner  # noqa: E402
from nuzero_tpu.envs.scs import SCSGame as JaxSCSGame  # noqa: E402
from nuzero_tpu.envs.scs import make_scenario  # noqa: E402
from nuzero_tpu.utils import viewer as jax_viewer  # noqa: E402
from nuzero_tpu_torch import run as runner  # noqa: E402
from nuzero_tpu_torch.envs.scs.game import SCSGame  # noqa: E402
from nuzero_tpu_torch.utils.render import legal_actions  # noqa: E402
from nuzero_tpu_torch.utils.viewer import SCSViewer, create_counter  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def games():
    """The same randomized 5x5 scenario in each package."""
    scenario = make_scenario("randomized", 5, seed=5)
    return JaxSCSGame(scenario), SCSGame(scenario, device="cpu")


def _play(game, n, seed=0):
    """The state after ``n`` random legal moves, and the actions."""
    rng = np.random.default_rng(seed)
    state, actions = game.init(1), []
    for _ in range(n):
        if bool(game.terminal(state)[0]):
            break
        a = int(rng.choice(legal_actions(game, state)))
        actions.append(a)
        state = game.step(state, torch.tensor([a], dtype=torch.int32))
    return state, actions


def test_frame_renders_board(games):
    viewer = SCSViewer(games[1])
    surf = viewer.frame(_play(games[1], 12)[0])
    assert surf.get_size() == viewer.size
    px = pygame.surfarray.array3d(surf)
    # Not a blank canvas: terrain, grid, and counters produce many colors.
    assert len(np.unique(px.reshape(-1, 3), axis=0)) > 10


def test_frame_equals_jax(games):
    """After the same actions, the frame's pixels equal the JAX viewer's."""
    jgame, game = games
    state, actions = _play(game, 12)
    jstate = jax_viewer.SCSViewer(jgame)._replay_states(actions)[-1]
    got = pygame.surfarray.array3d(SCSViewer(game).frame(state))
    want = pygame.surfarray.array3d(jax_viewer.SCSViewer(jgame).frame(jstate))
    np.testing.assert_array_equal(got, want)


def test_save_png(tmp_path, games):
    viewer = SCSViewer(games[1])
    p = viewer.save_png(games[1].init(1), str(tmp_path / "board.png"))
    assert os.path.getsize(p) > 1000


def test_create_counter(tmp_path):
    p = create_counter(str(tmp_path / "c.png"), 2, 2, 4, player=1)
    assert os.path.getsize(p) > 500
    want = jax_viewer.create_counter(str(tmp_path / "j.png"), 2, 2, 4, player=1)
    np.testing.assert_array_equal(pygame.surfarray.array3d(pygame.image.load(p)),
                                  pygame.surfarray.array3d(pygame.image.load(want)))


def test_replay_states_match_engine(games):
    game = games[1]
    state, actions = _play(game, 6, seed=1)
    states = SCSViewer(game)._replay_states(actions)
    assert len(states) == len(actions) + 1
    assert torch.equal(states[-1].board, state.board)


def test_analyse_run_cli_headless(tmp_path, monkeypatch):
    """``--analyse`` end to end under the dummy SDL driver on a port run:
    plays a game with the run's checkpoint, saves the history, replays it."""
    from nuzero_tpu_torch.config.run_meta import save_run_meta
    from nuzero_tpu_torch.utils.checkpoint import save_checkpoint

    monkeypatch.setattr(runner, "RUNS", str(tmp_path))
    run_dir = tmp_path / "scs_tiny"
    run_dir.mkdir()
    env = runner._scs_env("solo_scout_5.yml", device="cpu")
    manager = runner._managers(env, "recurrent", filters=8)
    params = manager.init(torch.Generator().manual_seed(0))
    save_checkpoint(str(run_dir / "checkpoints"), 1, {"params": params})
    save_run_meta(str(run_dir), "scs", "recurrent", scenario="solo_scout_5.yml", num_filters=8)
    actions = runner.analyse_run("scs_tiny", max_moves=10, auto=True, fps=1000, device="cpu")
    assert 1 <= len(actions) <= 10
    with open(run_dir / "analysis_actions.json") as f:
        assert json.load(f) == actions


def test_analyse_committed_run_equals_jax(tmp_path, monkeypatch):
    """``--analyse scs_solo_r3`` reads the run's export and plays the greedy
    PolicyAgent in both seats; JAX's PolicyAgent on the run's Orbax
    checkpoint, at every position of that game (JAX's engine replaying the
    actions), picks the same action (``run.py --analyse`` plays the same
    loop eagerly, ~1 min on the CPU)."""
    import jax
    import jax.numpy as jnp

    from nuzero_tpu.config.run_meta import build_from_meta as jax_build_from_meta
    from nuzero_tpu.config.run_meta import load_run_meta as jax_load_run_meta
    from nuzero_tpu.evaluation import PolicyAgent as JaxPolicyAgent
    from nuzero_tpu.utils.checkpoint import restore_checkpoint as jax_restore

    monkeypatch.setattr(runner, "RUNS", str(tmp_path))
    got = runner.analyse_run("scs_solo_r3", max_moves=24, auto=True, fps=1000, device="cpu")
    with open(tmp_path / "scs_solo_r3" / "analysis_actions.json") as f:
        assert json.load(f) == got

    run_dir = os.path.join(REPO, "runs", "scs_solo_r3")
    jenv, jmgr = jax_build_from_meta(jax_load_run_meta(run_dir), REPO)
    params = jax_restore(os.path.join(run_dir, "checkpoints"), "auto")[0]["params"]
    states = jax_viewer.SCSViewer(jenv)._replay_states(got)
    assert len(got) == 24 or bool(jenv.terminal(states[-1]))
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *states[:-1])
    choose = jax.jit(JaxPolicyAgent(jmgr, params).policy(jenv))
    want = np.asarray(choose(params, batch, jnp.arange(len(got), dtype=jnp.int32),
                             jax.random.key(0)))
    assert got == want.tolist()
