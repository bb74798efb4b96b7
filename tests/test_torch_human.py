"""Human-vs-agent terminal play and the ASCII render of the port
(``nuzero_tpu_torch/evaluation/human.py``, ``utils/render.py``), mirroring
``tests/test_human_play.py``, and held against the JAX package: the
transcript of a game against the same deterministic agent and
``render_scs_ascii`` after the same actions equal JAX's, string for string;
a cached agent decides as an uncached one (all exact)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import run as jax_runner
from nuzero_tpu.evaluation import PolicyAgent as JaxPolicyAgent
from nuzero_tpu.evaluation import play_vs_agent as jax_play_vs_agent
from nuzero_tpu.utils.render import render_scs_ascii as jax_render_scs_ascii
from nuzero_tpu_torch import run as runner
from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta
from nuzero_tpu_torch.envs.tictactoe import TicTacToe
from nuzero_tpu_torch.evaluation import PolicyAgent, RandomAgent, play_vs_agent
from nuzero_tpu_torch.utils.caches import DictCache
from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint
from nuzero_tpu_torch.utils.render import render_scs_ascii, replay_actions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TTT_ASSET = os.path.join(REPO, "nuzero_tpu_torch", "assets", "runs", "ttt_long_r3c")


class ScriptedInput:
    """Feeds canned answers; falls back to the first legal action parsed
    from the prompt once the script runs out."""

    def __init__(self, answers):
        self.answers = list(answers)
        self.prompts = []

    def __call__(self, prompt):
        self.prompts.append(prompt)
        if self.answers:
            return self.answers.pop(0)
        legal = prompt.split("legal: [")[1].split("]")[0].split(",")
        return legal[0].strip()


def test_game_runs_to_terminal_and_rejects_illegal():
    env = TicTacToe(device="cpu")
    lines = []
    inp = ScriptedInput(["banana", "99", "4"])  # two illegal, then center
    value = play_vs_agent(env, RandomAgent(), human_player=0, seed=3, input_fn=inp,
                          print_fn=lines.append)
    out = "\n".join(str(x) for x in lines)
    assert out.count("illegal move") >= 2
    assert "game over" in out
    assert value in (-1.0, 0.0, 1.0)


def test_coordinate_input_accepted():
    env = TicTacToe(device="cpu")
    lines = []
    # "1 1" = center via (row, col) coords -> plane 0 ravel
    inp = ScriptedInput(["1 1"])
    play_vs_agent(env, RandomAgent(), human_player=0, seed=5, input_fn=inp,
                  print_fn=lines.append)
    assert any("game over" in str(x) for x in lines)


def _ttt_agents():
    """The ttt_long_r3c net as a PolicyAgent in each package: JAX's restored
    from the run's Orbax checkpoint, the port's from its export."""
    from nuzero_tpu.config.run_meta import build_from_meta as jax_build_from_meta
    from nuzero_tpu.utils.checkpoint import restore_checkpoint as jax_restore

    meta = load_run_meta(TTT_ASSET)
    jenv, jmgr = jax_build_from_meta(meta, REPO)
    jparams = jax_restore(os.path.join(REPO, "runs", "ttt_long_r3c", "checkpoints"),
                          "auto")[0]["params"]
    env, mgr = build_from_meta(meta, REPO, device="cpu")
    params = restore_checkpoint(os.path.join(TTT_ASSET, "checkpoints"), device="cpu")[0]["params"]
    return jenv, JaxPolicyAgent(jmgr, jparams), env, PolicyAgent(mgr, params)


def test_transcript_equals_jax_against_the_same_agent():
    """The same human moves against the committed net's policy agent in each
    package: every printed line, boards and agent moves, equal."""
    jenv, jagent, env, agent = _ttt_agents()
    want, got = [], []
    jax_play_vs_agent(jenv, jagent, human_player=1, seed=0,
                      input_fn=ScriptedInput([]), print_fn=want.append)
    play_vs_agent(env, agent, human_player=1, seed=0, input_fn=ScriptedInput([]),
                  print_fn=got.append)
    assert len(got) > 6 and got == want


def test_cached_agent_decides_as_uncached():
    """With a cache, the second visit of each position is a hit and gives
    the action the agent chose the first time."""
    _, _, env, agent = _ttt_agents()
    plain = PolicyAgent(agent.manager, agent.variables)
    agent.set_cache(DictCache(64))
    rng = np.random.default_rng(0)
    state = env.init(1)
    for move in range(5):
        for _ in range(2):
            a = agent.choose_host(env, state, agent.variables, torch.Generator(), move)
            assert a == plain.choose_host(env, state, plain.variables, torch.Generator(), move)
        legal = np.flatnonzero(env.legal_mask(state)[0].numpy())
        state = env.step(state, torch.tensor([int(rng.choice(legal))], dtype=torch.int32))
    assert (agent.cache.hits, agent.cache.misses, agent.cache.length()) == (5, 5, 5)


def test_render_scs_ascii_equals_jax():
    """The same 30 random legal actions on ``open_field_5.yml`` in each
    engine: the ASCII board after every action equals JAX's."""
    jenv = jax_runner._scs_env("open_field_5.yml")
    env = runner._scs_env("open_field_5.yml", device="cpu")
    step, legal_mask = jax.jit(jenv.step), jax.jit(jenv.legal_mask)
    rng = np.random.default_rng(7)
    js, actions = jenv.init(None), []
    want = [jax_render_scs_ascii(jenv, js)]
    for _ in range(30):
        a = int(rng.choice(np.flatnonzero(np.asarray(legal_mask(js)))))
        js = step(js, jnp.int32(a))
        actions.append(a)
        want.append(jax_render_scs_ascii(jenv, js))
    got = [render_scs_ascii(env, s) for s in replay_actions(env, actions)]
    assert got == want
