"""Interactive terminal wizard (counterpart of ``nuzero_tpu/interactive.py``;
ref ``Interactive.py``).

The reference ships a Q&A wizard that edits base YAML configs and launches
training / testing / counter creation (``Interactive.py:34-55``,
``new_training`` at ``:126``, ``testing_mode`` at ``:174``, model chooser at
``:521``); its README marks it "currently not working" (``README.md:96``).
This is a WORKING equivalent with the same flows:

- quick-start presets;
- a new-training flow that asks the key hyperparameters, writes a derived
  training/search YAML pair next to the run (so the run is reproducible and
  resumable, ref config backups ``AlphaZero.py:184-187``), and launches;
- a continue-training flow (resume from a run's checkpoints);
- a testing flow building agent matchups;
- SCS counter-image creation (ref ``CounterCreator``).

All prompts accept empty input for the shown default.  ``input_fn`` /
``print_fn`` are injectable for tests.  Everything the wizard launches
runs on ``device`` (the card by default) through the port's CLI module,
``nuzero_tpu_torch.run``; in a multi-process launch both training flows run
data-parallel over the processes, as the JAX wizard's run on a mesh of
every device (``parallel.mesh.default_mesh``).
"""

from __future__ import annotations

import os
from typing import Callable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Wizard:
    def __init__(
        self,
        input_fn: Callable[[str], str] = input,
        print_fn: Callable[[str], None] = print,
        device="cuda",
    ):
        self.input = input_fn
        self.print = print_fn
        self.device = device

    # -- prompt helpers ----------------------------------------------------

    def ask_choice(self, prompt: str, options):
        while True:
            self.print(prompt)
            for i, (label, _) in enumerate(options):
                self.print(f"  {i}) {label}")
            choice = self.input("> ").strip()
            if choice.isdigit() and 0 <= int(choice) < len(options):
                return options[int(choice)][1]
            self.print("invalid choice")

    def ask(self, prompt: str, default, cast=str):
        while True:
            raw = self.input(f"{prompt} [{default}]: ").strip()
            if not raw:
                return default
            try:
                if cast is bool:
                    return raw.lower() in ("1", "true", "yes", "y")
                return cast(raw)
            except ValueError:
                self.print(f"expected {cast.__name__}")

    # -- flows ---------------------------------------------------------------

    def start(self):
        mode = self.ask_choice(
            "What would you like to do?",
            [
                ("Quick-start a training preset", "preset"),
                ("Configure a new training run", "new_training"),
                ("Continue a training run from its checkpoints", "continue"),
                ("Test agents", "test"),
                ("Create SCS unit counter images", "counters"),
                ("Quit", "quit"),
            ],
        )
        if mode == "quit":
            return None
        if mode == "continue":  # keyword-safe method name
            return self.continue_()
        return getattr(self, mode)()

    def preset(self):
        from nuzero_tpu_torch import run as runner

        preset = self.ask_choice(
            "Pick a training preset:",
            [
                ("Tic-Tac-Toe + MLP", 0),
                ("Tic-Tac-Toe + RecurrentNet", 1),
                ("SCS 5x5 + hex RecurrentNet", 2),
                ("SCS solo-scout + hex RecurrentNet", 3),
            ],
        )
        name = self.input("Run name (empty = default): ").strip() or None
        runner.training_preset(preset, name, device=self.device)
        return ("preset", preset, name)

    def _build_configs(self, game: str):
        """Q&A over the key knobs; returns (training_dict, search_dict)
        mirroring the reference YAML layouts (so they round-trip through
        the normal loaders)."""
        steps = self.ask("Training steps", 300, int)
        actors = self.ask("Self-play batch size (num_actors)", 256, int)
        games_per_step = self.ask("Games per training step", 64, int)
        early_fill = self.ask("Early-fill games", 512, int)
        window = self.ask("Replay window (games)", 5000, int)
        batch = self.ask("Train batch size", 1024, int)
        num_samples = self.ask("Sample batches per step", 4, int)
        optimizer = self.ask_choice(
            "Optimizer:", [("SGD", "SGD"), ("Adam", "Adam")]
        )
        lr = self.ask(
            "Learning rate", 0.1 if optimizer == "SGD" else 5e-5, float
        )
        sims = self.ask("MCTS simulations per move", 100, int)
        train_iters = self.ask("Recurrent train iterations", 2, int)
        pred_iters = self.ask("Recurrent pred iterations", 2, int)
        alpha = self.ask("Progressive-loss alpha (0 = off)", 0.0, float)
        mode = self.ask_choice(
            "Running mode:",
            [("sequential", "sequential"), ("asynchronous", "asynchronous")],
        )
        training = {
            "Initialization": {"network_name": game, "load_checkpoint": False},
            "Running": {
                "running_mode": mode,
                "num_actors": actors,
                "early_fill_per_type": early_fill,
                "training_steps": steps,
                "Sequential": {"num_games_per_type_per_step": games_per_step},
                "Asynchronous": {"update_delay": 0.0},
            },
            "Testing": {
                "asynchronous_testing": True,
                "early_testing": True,
                "testing_actors": 128,
                "policy_test_frequency": max(steps // 10, 1),
                "mcts_test_frequency": max(steps // 5, 1),
                "num_policy_test_games": 256,
                "num_mcts_test_games": 128,
            },
            "Recurrent Options": {
                "train_iterations": [train_iters],
                "pred_iterations": [pred_iters],
                "test_iterations": pred_iters,
                "alpha": alpha,
            },
            "Learning": {
                "replay_window_size": window,
                "value_loss": "SE",
                "policy_loss": "CEL",
                "normalize_cel": True,
                "learning_method": "samples",
                "Samples": {
                    "batch_size": batch,
                    "num_samples": num_samples,
                    "with_replacement": True,
                    "late_heavy": False,
                },
            },
            "Saving": {"save_frequency": max(steps // 6, 1), "save_buffer": True},
            "Optimizer": {
                "optimizer_choice": optimizer,
                "SGD": {"weight_decay": 1e-7, "momentum": 0.9, "nesterov": True},
            },
            "Scheduler": {
                "starting_lr": lr,
                "scheduler_boundaries": [5000, 10000, 20000],
                "scheduler_gamma": 0.5,
            },
        }
        search = {
            "Simulation": {"mcts_simulations": sims, "keep_subtree": True},
            "UCT": {"pb_c_base": 10000, "pb_c_init": 1.15},
            "Exploration": {
                "number_of_softmax_moves": 2,
                "epsilon_softmax_exploration": 0.04,
                "epsilon_random_exploration": 0.001,
                "value_factor": 1,
                "root_exploration_fraction": 0.2,
                "root_dist_alpha": 0.15,
                "root_dist_beta": 1,
            },
        }
        return training, search

    def new_training(self, launch: bool = True):
        from nuzero_tpu_torch.config.yaml_io import save_yaml

        game = self.ask_choice(
            "Game:",
            [
                ("Tic-Tac-Toe", "ttt"),
                ("SCS open-field 5x5", "scs_open"),
                ("SCS solo-scout 5x5", "scs_solo"),
            ],
        )
        arch = self.ask_choice(
            "Architecture:",
            [
                ("MLP", "mlp"),
                ("DeepThinking RecurrentNet", "recurrent"),
                ("ResNet", "resnet"),
                ("ConvNet", "conv"),
            ],
        )
        name = self.ask("Run name", f"{game}_{arch}")
        training, search = self._build_configs(name)

        run_dir = os.path.join(REPO, "runs", name)
        os.makedirs(run_dir, exist_ok=True)
        train_path = os.path.join(run_dir, "train_config.yaml")
        search_path = os.path.join(run_dir, "search_config.yaml")
        save_yaml(training, train_path)
        save_yaml(search, search_path)
        from nuzero_tpu_torch.config.run_meta import save_run_meta

        save_run_meta(
            run_dir,
            "ttt" if game == "ttt" else "scs",
            arch,
            scenario=(
                None
                if game == "ttt"
                else "open_field_5.yml"
                if game == "scs_open"
                else "solo_scout_5.yml"
            ),
            hex=game != "ttt",
        )
        self.print(f"configs written to {run_dir}")
        if not launch:
            return (game, arch, name, train_path, search_path)

        from nuzero_tpu_torch import run as runner

        env = (
            runner._ttt_env(self.device)
            if game == "ttt"
            else runner._scs_env(
                "open_field_5.yml" if game == "scs_open" else "solo_scout_5.yml",
                device=self.device,
            )
        )
        manager = runner._managers(env, arch, hex=game != "ttt")
        self._launch(env, manager, train_path, search_path, run_dir)
        return (game, arch, name, train_path, search_path)

    def _launch(self, env, manager, train_path, search_path, run_dir):
        from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
        from nuzero_tpu_torch.parallel.mesh import default_mesh
        from nuzero_tpu_torch.training.pipeline import AlphaZero

        cfg = load_training_config(train_path)
        search = load_search_config(search_path)
        az = AlphaZero(env, manager, cfg, search, run_dir=run_dir,
                       mesh=default_mesh(env.device))
        if cfg.load_checkpoint:
            state, step = az.load(cfg.checkpoint.iteration_number)
            az.run(initial_state=state, starting_step=step)
        else:
            az.run()
        self.print(f"run complete; artifacts in {run_dir}")

    def continue_(self):
        """Pick a run, rebuild its env+network from ``run_meta.yaml``,
        restore the latest checkpoint and resume training (ref
        ``Interactive.py:126-173`` continue flows)."""
        runs_dir = os.path.join(REPO, "runs")
        runs = sorted(
            d
            for d in (os.listdir(runs_dir) if os.path.isdir(runs_dir) else [])
            if os.path.isdir(os.path.join(runs_dir, d, "checkpoints"))
        )
        if not runs:
            self.print("no resumable runs found under runs/")
            return None
        name = self.ask_choice("Resume which run?", [(r, r) for r in runs])
        run_dir = os.path.join(runs_dir, name)

        from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta

        meta = load_run_meta(run_dir)
        if meta is None:
            self.print(
                f"{name} has no run_meta.yaml (created before resume "
                "support); re-launch it via run.py once to write one"
            )
            return None
        train_path = search_path = None
        for cand in ("train_config_copy.yaml", "train_config.yaml"):
            if os.path.exists(os.path.join(run_dir, cand)):
                train_path = os.path.join(run_dir, cand)
                break
        for cand in ("search_config_copy.yaml", "search_config.yaml"):
            if os.path.exists(os.path.join(run_dir, cand)):
                search_path = os.path.join(run_dir, cand)
                break
        if train_path is None or search_path is None:
            self.print(f"{name} is missing its config copies; cannot resume")
            return None
        extra = self.ask(
            "Extra training steps beyond the config's training_steps "
            "(0 = just finish the configured run)",
            0,
            int,
        )

        import dataclasses

        from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
        from nuzero_tpu_torch.parallel.mesh import default_mesh
        from nuzero_tpu_torch.training.pipeline import AlphaZero

        env, manager = build_from_meta(meta, REPO, device=self.device)
        cfg = load_training_config(train_path)
        if extra:
            cfg = dataclasses.replace(
                cfg,
                running=dataclasses.replace(
                    cfg.running,
                    training_steps=cfg.running.training_steps + extra,
                ),
            )
        search = load_search_config(search_path)
        az = AlphaZero(env, manager, cfg, search, run_dir=run_dir,
                       mesh=default_mesh(env.device))
        state, step = az.load(cfg.checkpoint.iteration_number)
        self.print(f"resuming {name} from step {step}")
        az.run(initial_state=state, starting_step=step)
        self.print(f"resumed run complete; artifacts in {run_dir}")
        return name

    def test(self):
        from nuzero_tpu_torch import run as runner

        preset = self.ask_choice(
            "Pick a testing preset:",
            [
                ("TTT trained agents vs random", 0),
                ("SCS goal-rush baseline", 1),
                ("SCS iteration-extrapolation sweep", 2),
            ],
        )
        name = self.input("Run name to load (empty = default): ").strip() or None
        runner.testing_preset(preset, name, device=self.device)
        return ("test", preset, name)

    def counters(self):
        from nuzero_tpu_torch.utils.viewer import create_counter

        out_dir = self.ask(
            "Output directory", os.path.join(REPO, "runs", "counters")
        )
        os.makedirs(out_dir, exist_ok=True)
        n = self.ask("How many counters?", 1, int)
        paths = []
        for i in range(n):
            name = self.ask(f"Counter {i} name", f"unit_{i}")
            attack = self.ask("Attack", 2, int)
            defense = self.ask("Defense", 2, int)
            movement = self.ask("Movement", 2, int)
            player = self.ask("Player (0/1)", 0, int)
            path = os.path.join(out_dir, f"{name}.png")
            create_counter(path, attack, defense, movement, player)
            paths.append(path)
            self.print(f"wrote {path}")
        return paths


def start(input_fn: Callable[[str], str] = input,
          print_fn: Callable[[str], None] = print, device="cuda"):
    return Wizard(input_fn, print_fn, device).start()
