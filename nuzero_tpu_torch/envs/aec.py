"""PettingZoo AEC adapter for the batch-first envs (counterpart of
``nuzero_tpu/envs/aec.py``).

The reference's SCS_Game is a ``pettingzoo.AECEnv`` subclass checked with
``pettingzoo.test.api_test`` (ref ``Games/SCS/SCS_Game.py:67``,
``Run.py:328-345``).  The port's engines step batches of tensors; this
host-side wrapper plays one game (a batch of one) behind the AEC interface,
a mutable cursor over the state, for interop: debugging, external
baselines and the environment-contract test.

pettingzoo and gymnasium are optional: without them the module imports
and ``AECAdapter`` raises ``ImportError`` when built.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nuzero_tpu_torch.utils.render import render_scs_ascii

try:
    from gymnasium import spaces
    from pettingzoo import AECEnv

    _HAVE_PZ = True
except ImportError:  # pragma: no cover - environment dependent
    AECEnv = object
    _HAVE_PZ = False


class AECAdapter(AECEnv):
    metadata = {"render_modes": ["ansi"], "name": "nuzero_tpu_torch_env"}

    def __init__(self, env, render_mode: Optional[str] = None):
        if not _HAVE_PZ:
            raise ImportError("pettingzoo/gymnasium not available")
        super().__init__()
        self.env = env
        self.render_mode = render_mode
        self.possible_agents = [0, 1]
        self._obs_space = spaces.Box(low=-1.0, high=np.inf,
                                     shape=tuple(env.observation_shape), dtype=np.float32)
        self._act_space = spaces.Discrete(env.num_actions)
        self._state = None

    # -- spaces -----------------------------------------------------------

    def observation_space(self, agent):
        return self._obs_space

    def action_space(self, agent):
        return self._act_space

    # -- core -------------------------------------------------------------

    def _mask(self) -> np.ndarray:
        return self.env.legal_mask(self._state)[0].cpu().numpy().astype(np.int8)

    def reset(self, seed=None, options=None):
        """A fresh game; an env whose games start at random (SCS with
        ``randomize_vp``) draws from a generator seeded with ``seed``."""
        gen = torch.Generator(device=self.env.device).manual_seed(seed if seed is not None else 0)
        self._state = self.env.init(1, generator=gen)
        self.agents = list(self.possible_agents)
        self.agent_selection = int(self.env.current_player(self._state)[0])
        self.rewards = {a: 0.0 for a in self.agents}
        self._cumulative_rewards = {a: 0.0 for a in self.agents}
        self.terminations = {a: False for a in self.agents}
        self.truncations = {a: False for a in self.agents}
        self.infos = {a: {"action_mask": self._mask()} for a in self.agents}

    def observe(self, agent):
        return self.env.observe(self._state)[0].cpu().numpy()

    def state(self):
        return self.env.observe(self._state)[0].cpu().numpy()

    def step(self, action):
        agent = self.agent_selection
        if self.terminations[agent] or self.truncations[agent]:
            # Dead-agent bookkeeping step (PettingZoo protocol).
            self._was_dead_step(action)
            return
        self._cumulative_rewards[agent] = 0.0
        self._state = self.env.step(
            self._state, torch.tensor([int(action)], dtype=torch.int32, device=self.env.device))

        if bool(self.env.terminal(self._state)[0]):
            value = float(self.env.terminal_value(self._state)[0])
            self.rewards = {0: value, 1: -value}
            self.terminations = {a: True for a in self.agents}
        else:
            self.rewards = {a: 0.0 for a in self.agents}
            self.agent_selection = int(self.env.current_player(self._state)[0])

        mask = self._mask()
        for a in self.agents:
            self.infos[a] = {"action_mask": mask}
        self._accumulate_rewards()

    def render(self):
        if hasattr(self.env, "render"):
            return self.env.render(self._state)
        return render_scs_ascii(self.env, self._state)

    def close(self):
        pass
