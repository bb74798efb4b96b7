"""Run metadata: rebuild (env, manager) for a saved run (counterpart of
``nuzero_tpu/config/run_meta.py``).

Checkpoints hold only tensors, so each run directory carries a small
``run_meta.yaml`` naming the game, scenario and architecture; the env and
the network are rebuilt from it and the parameters restored from the
checkpoint.  The file's schema is the JAX package's, so the committed runs'
``run_meta.yaml`` files load unchanged; a ResNet with BatchNorms adds
``batch_norm: true`` (a file without the key has none).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from nuzero_tpu_torch.config.yaml_io import load_yaml, save_yaml

META_FILE = "run_meta.yaml"


def save_run_meta(run_dir: str, game: str, arch: str, *, scenario: Optional[str] = None,
                  seed: int = 42, hex: Optional[bool] = None, num_filters: int = 64,
                  num_blocks: Optional[int] = None, randomize_vp: bool = False,
                  batch_norm: bool = False) -> str:
    """``game``: "ttt" | "scs".  ``scenario``: a scenario YAML file name under
    ``configs/scenarios`` (scs only).  ``arch``: mlp | conv | recurrent |
    resnet; ``num_blocks`` and ``batch_norm`` size a resnet's tower."""
    if hex is None:
        hex = game == "scs"
    if num_blocks is None:
        num_blocks = 4 if arch == "resnet" else 2
    meta = {
        "game": game,
        "scenario": scenario,
        "seed": seed,
        "arch": arch,
        "hex": bool(hex),
        "num_filters": num_filters,
        "num_blocks": num_blocks,
        "randomize_vp": bool(randomize_vp),
    }
    if batch_norm:  # written only where set, so other metas stay the JAX package's
        meta["batch_norm"] = True
    path = os.path.join(run_dir, META_FILE)
    save_yaml(meta, path)
    return path


def load_run_meta(run_dir: str) -> Optional[dict]:
    path = os.path.join(run_dir, META_FILE)
    if not os.path.exists(path):
        return None
    return load_yaml(path)


def build_from_meta(meta: dict, repo_root: str, device="cuda") -> Tuple[object, object]:
    """(env, NetworkManager) from a ``run_meta.yaml`` dict, on ``device``.
    The net's policy channels and observation shape come from the env."""
    from nuzero_tpu_torch.networks.convnet import ConvNet
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.mlp import MLPNetwork
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet
    from nuzero_tpu_torch.networks.resnet import ResNet

    game = meta["game"]
    if game == "ttt":
        from nuzero_tpu_torch.envs.tictactoe import TicTacToe

        env = TicTacToe(device=device)
    elif game == "scs":
        from nuzero_tpu_torch.envs.scs.game import SCSGame
        from nuzero_tpu_torch.envs.scs.scenario import load_scenario

        scenario = load_scenario(
            os.path.join(repo_root, "configs", "scenarios", meta["scenario"]),
            seed=int(meta.get("seed", 42)))
        env = SCSGame(scenario, randomize_vp=bool(meta.get("randomize_vp", False)),
                      device=device)
    else:
        raise ValueError(f"unknown game {game!r} in run_meta")

    arch = meta["arch"]
    hex = bool(meta.get("hex", game == "scs"))
    filters = int(meta.get("num_filters", 64))
    blocks = int(meta.get("num_blocks", 2))
    channels, policy_channels = env.observation_shape[0], env.action_space_shape[0]
    if arch == "mlp":
        net = MLPNetwork(env.observation_shape, env.num_actions)
    elif arch == "conv":
        net = ConvNet(channels, policy_channels, num_filters=filters, num_layers=blocks,
                      hex=hex)
    elif arch == "recurrent":
        net = RecurrentNet(channels, policy_channels, num_filters=filters, num_blocks=blocks,
                           hex=hex)
    elif arch == "resnet":
        net = ResNet(channels, policy_channels, num_filters=filters, num_blocks=blocks,
                     batch_norm=bool(meta.get("batch_norm", False)), hex=hex)
    else:
        raise ValueError(f"unknown arch {arch!r} in run_meta")
    return env, NetworkManager(net.to(env.device), env.observation_shape)
