"""The port's interactive wizard (``nuzero_tpu_torch/interactive.py``),
mirroring ``tests/test_interactive.py``, and held against the JAX
package's wizard: the same answers write the same training, search and
run-meta YAML (exact), and the block progress bar prints JAX's lines
(exact).  Its launch path trains on the CPU here, one device, no mesh."""

import io
import os

from nuzero_tpu import interactive as jax_interactive
from nuzero_tpu.utils.printbar import PrintBar as JaxPrintBar
from nuzero_tpu_torch import interactive
from nuzero_tpu_torch.config.yaml_io import load_yaml
from nuzero_tpu_torch.interactive import Wizard


def _scripted(answers):
    it = iter(answers)

    def input_fn(prompt):
        return next(it)

    return input_fn


# game=ttt, arch=mlp, name, then all-default hyperparameters (empty string =
# accept default), optimizer=SGD, mode=sequential.
ANSWERS = ["0", "0", "wiz_test"] + [""] * 7 + ["0", ""] + [""] * 4 + ["0"]


def test_new_training_writes_loadable_configs(tmp_path, monkeypatch):
    monkeypatch.setattr(interactive, "REPO", str(tmp_path))
    out = io.StringIO()
    w = Wizard(_scripted(ANSWERS), out.write, device="cpu")
    game, arch, name, train_path, search_path = w.new_training(launch=False)
    assert (game, arch, name) == ("ttt", "mlp", "wiz_test")

    from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config

    cfg = load_training_config(train_path)
    assert cfg.network_name == "wiz_test"
    assert cfg.running.training_steps == 300
    assert cfg.optimizer.optimizer_choice == "SGD"
    assert cfg.optimizer.starting_lr == 0.1
    assert cfg.learning.normalize_cel is True
    search = load_search_config(search_path)
    assert search.num_simulations == 100
    assert search.keep_subtree is True


def test_new_training_yaml_equals_jax(tmp_path, monkeypatch):
    """The same answers (SCS solo scout, ResNet, Adam, asynchronous, every
    number given) in each wizard: the three files are equal as data."""
    answers = ["2", "2", "scs_wiz", "12", "32", "8", "16", "500", "64", "2", "1", "0.001",
               "30", "3", "5", "0.01", "1"]
    port, ref = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setattr(interactive, "REPO", str(port))
    monkeypatch.setattr(jax_interactive, "REPO", str(ref))
    got = Wizard(_scripted(answers), lambda s: None, device="cpu").new_training(launch=False)
    want = jax_interactive.Wizard(_scripted(answers), lambda s: None).new_training(launch=False)
    assert got[:3] == want[:3] == ("scs_solo", "resnet", "scs_wiz")
    for name in ("train_config.yaml", "search_config.yaml", "run_meta.yaml"):
        assert load_yaml(str(port / "runs" / "scs_wiz" / name)) == load_yaml(
            str(ref / "runs" / "scs_wiz" / name)), name


def test_printbar_output():
    from nuzero_tpu_torch.utils.printbar import PrintBar

    out = io.StringIO()
    bar = PrintBar("fill", total=4, width=4, stream=out)
    for _ in range(4):
        bar.next()
    lines = [line for line in out.getvalue().splitlines() if line]
    assert lines[0].startswith("fill |····|")
    assert lines[-1].endswith("100%")
    assert "████" in lines[-1]
    ref = io.StringIO()
    for stream, cls in ((out, None), (ref, JaxPrintBar)):
        stream.seek(0)
        stream.truncate()
        b = (cls or PrintBar)("early fill", total=37, width=10, stream=stream)
        for n in (1, 5, 2, 9, 30):
            b.next(n)
        b.finish()
    assert out.getvalue() == ref.getvalue()


def _tiny_run(run_dir):
    from nuzero_tpu_torch.config.run_meta import save_run_meta
    from nuzero_tpu_torch.config.yaml_io import save_yaml

    run_dir.mkdir(parents=True)
    save_yaml({
        "Initialization": {"network_name": "tiny"},
        "Running": {"num_actors": 8, "early_fill_per_type": 8, "training_steps": 2,
                    "Sequential": {"num_games_per_type_per_step": 2}},
        "Learning": {"replay_window_size": 64, "Samples": {"batch_size": 8, "num_samples": 1}},
        "Saving": {"save_frequency": 1},
        "Scheduler": {"starting_lr": 1e-3},
    }, str(run_dir / "train_config.yaml"))
    save_yaml({"Simulation": {"mcts_simulations": 4}}, str(run_dir / "search_config.yaml"))
    save_run_meta(str(run_dir), "ttt", "mlp", hex=False)


def test_continue_flow_resumes_end_to_end(tmp_path, monkeypatch):
    """The continue flow loads the checkpoint and resumes training (ref
    Interactive.py:126-173)."""
    import torch

    from nuzero_tpu_torch.config.schemas import load_training_config
    from nuzero_tpu_torch.envs.tictactoe import TicTacToe
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.mlp import MLPNetwork
    from nuzero_tpu_torch.search.mcts import SearchParams
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    monkeypatch.setattr(interactive, "REPO", str(tmp_path))
    run_dir = tmp_path / "runs" / "tiny"
    _tiny_run(run_dir)
    env = TicTacToe(device="cpu")
    mgr = NetworkManager(MLPNetwork(env.observation_shape, 9), env.observation_shape)
    cfg = load_training_config(str(run_dir / "train_config.yaml"))
    az = AlphaZero(env, mgr, cfg, SearchParams(num_simulations=4), run_dir=str(run_dir))
    torch.manual_seed(0)
    az.run(seed=0)
    assert max(r["step"] for r in az.journal.load() if "step" in r) == 2

    out = []
    # choice 0 = the only run; extra steps = 2.
    w = interactive.Wizard(_scripted(["0", "2"]), out.append, device="cpu")
    assert w.continue_() == "tiny"
    assert any("resuming tiny from step 2" in s for s in out)
    steps = [r["step"] for r in az.journal.load() if "step" in r]
    assert max(steps) == 4, "resume should have trained steps 3 and 4"


def test_new_training_launches_on_one_device(tmp_path, monkeypatch):
    """The new-training flow with launch: TTT + MLP cut to one step of 8
    actors and 4 simulations trains on the wizard's device and writes its
    checkpoint and journal."""
    monkeypatch.setattr(interactive, "REPO", str(tmp_path))
    answers = ["0", "0", "wiz_run", "1", "8", "2", "8", "64", "16", "1", "0", "", "4", "",
               "", "", "0"]
    out = []
    Wizard(_scripted(answers), out.append, device="cpu").new_training(launch=True)
    run_dir = tmp_path / "runs" / "wiz_run"
    assert any(f"run complete; artifacts in {run_dir}" in s for s in out)
    records = [r for r in load_journal(run_dir) if r.get("step") == 1]
    assert records and "loss/combined" in records[0]
    assert os.path.exists(run_dir / "checkpoints" / "step_00000001.pt")


def load_journal(run_dir):
    from nuzero_tpu_torch.utils.metrics import MetricsJournal

    return MetricsJournal(str(run_dir / "journal.jsonl")).load()


def test_counters_flow_equals_jax(tmp_path):
    """The counter-image flow (ref CounterCreator): the same answers write
    the same counter images as JAX's wizard, pixel for pixel (headless;
    skips without pygame)."""
    import pytest

    pygame = pytest.importorskip("pygame", reason="counter images need pygame")
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    answers = ["{out}", "2", "scout", "1", "1", "4", "1", "tank", "", "", "", "0"]
    paths = []
    for name, cls in (("port", Wizard), ("jax", jax_interactive.Wizard)):
        out = str(tmp_path / name)
        paths.append(cls(_scripted([a.format(out=out) for a in answers]),
                         lambda s: None).counters())
    assert [os.path.basename(p) for p in paths[0]] == ["scout.png", "tank.png"]
    for got, want in zip(*paths):
        assert (pygame.surfarray.array3d(pygame.image.load(got)) ==
                pygame.surfarray.array3d(pygame.image.load(want))).all()
