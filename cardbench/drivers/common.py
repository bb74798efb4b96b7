"""What the drivers share: the port's objects built from a cell's files, the
outcome of a run, and the window's clock."""

from __future__ import annotations

import copy
import dataclasses
import gc
import time

import torch

from cardbench import harness


@dataclasses.dataclass
class Outcome:
    checks: list
    attempted: int
    failed: int
    end_to_end: dict
    memory_peak_bytes: int
    context: dict


def build_kernels(device) -> float:
    """The port's kernel libraries, built side by side where the checkout
    has none yet (``ops/cuda/build.py``, into the checkout) -> seconds."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        from nuzero_tpu_torch.ops.cuda.build import build_all

        build_all()
    return time.perf_counter() - t0


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_env(traffic: dict, device, board_size=None, turns=None):
    """The port's SCS env of the traffic's scenario (a JSON copy of the
    repository's YAML), its map drawn from ``scenario_seed``."""
    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.envs.scs.scenario import scenario_from_dict

    data = scenario_data(traffic, board_size, turns)
    return SCSGame(scenario_from_dict(data, seed=traffic["scenario_seed"]),
                   randomize_vp=traffic["randomize_vp"], device=device)


def scenario_data(traffic: dict, board_size=None, turns=None) -> dict:
    """The traffic's scenario mapping, resized as the port's
    ``load_scenario(board_size=, turns=)`` resizes it."""
    data = copy.deepcopy(harness.traffic_file("scenarios", traffic["scenario"] + ".json"))
    if board_size is not None:
        data["Board_dimensions"] = {"rows": int(board_size), "columns": int(board_size)}
    if turns is not None:
        data["Turns"] = int(turns)
        reinf = data.get("Reinforcements")
        if reinf and "schedule" in reinf:
            reinf["schedule"] = {p: (list(v) + [[]] * (turns + 1))[:turns + 1]
                                 for p, v in reinf["schedule"].items()}
    return data


def build_manager(config: dict, env):
    """The port's ``RecurrentNet`` of the configuration, on the env's device,
    behind a ``NetworkManager``."""
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet

    channels, planes = env.observation_shape[0], env.action_space_shape[0]
    net = RecurrentNet(channels, planes, num_filters=config["num_filters"],
                       num_blocks=config["num_blocks"], recall=config["recall"],
                       policy_head=config["policy_head"], value_head=config["value_head"],
                       value_activation=config["value_activation"], hex=config["hex"],
                       dtype=getattr(torch, config["compute_dtype"]))
    return NetworkManager(net.to(env.device), env.observation_shape)


def recipe(traffic: dict, config: dict):
    """(TrainingConfig, SearchParams) of the traffic's recipe, with the
    configuration's recurrent iterations and the traffic's overrides."""
    from nuzero_tpu_torch.config.schemas import (
        search_params_from_dict, training_config_from_dict,
    )

    train = copy.deepcopy(harness.traffic_file("recipes", traffic["training"] + ".json"))
    search = copy.deepcopy(harness.traffic_file("recipes", traffic["search"] + ".json"))
    rec = train.setdefault("Recurrent Options", {})
    rec["train_iterations"] = [config["train_iterations"]]
    rec["pred_iterations"] = [config["pred_iterations"]]
    for section, values in traffic.get("training_overrides", {}).items():
        train.setdefault(section, {}).update(values)
    for section, values in traffic.get("search_overrides", {}).items():
        search.setdefault(section, {}).update(values)
    return training_config_from_dict(train), search_params_from_dict(search)


def release(device) -> None:
    """Free what the program held before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


class Deadline:
    """The window's clock: ``open()`` at its start, ``over()`` once
    ``seconds`` have passed."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t0 = None

    def open(self) -> float:
        self.t0 = time.perf_counter()
        return self.t0

    def over(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds
