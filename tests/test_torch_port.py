"""Port hygiene: ``nuzero_tpu_torch`` imports without JAX (the CUDA wrappers
included, without nvcc), its entry points default to the card, and
``chip_smoke.py`` refuses to run without a CUDA card instead of falling
back to the CPU; its pure helpers (shapes, bounds, launch counts, the SASS
check, the library yardstick's layout) are checked here."""

import ast
import inspect
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

import torch

import chip_smoke
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.search.tree import init_tree
from nuzero_tpu_torch.training.learner import Learner, LearnerConfig
from nuzero_tpu_torch.training.replay import create_buffer
from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "nuzero_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "nuzero_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import torch
import nuzero_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nuzero_tpu_torch.__path__, "nuzero_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for module in ("ops.cuda.hexconv_kernel", "training.learner", "training.losses",
               "training.pipeline", "training.replay", "utils.checkpoint", "utils.metrics",
               "utils.profiling", "config.schemas", "run", "__main__", "interactive",
               "config.yaml_io", "search.tree", "utils.render", "utils.printbar", "native",
               "utils.caches", "evaluation.agents", "evaluation.manager", "evaluation.human",
               "utils.viewer", "envs.aec"):
    assert "nuzero_tpu_torch." + module in names, (module, names)
from nuzero_tpu_torch.ops import hexconv
from nuzero_tpu_torch.ops.cuda import hexconv_kernel
x = torch.randn(2, 5, 5, 4, requires_grad=True)
w = torch.randn(7, 4, 3, requires_grad=True)
hexconv.hex_conv(x, w).sum().backward()
assert x.grad is not None and w.grad is not None
assert sum(hexconv_kernel.launch_count.values()) == 0
# Importing builds nothing and loads no native library, and pygame stays
# unimported until a viewer is made.
from nuzero_tpu_torch import native
assert native._lib is None and not native._tried
assert "pygame" not in sys.modules
print("imported", len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")


def test_port_sources_never_name_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|nuzero_tpu)\b(?!_torch)", re.M)
    offenders = [
        str(p.relative_to(REPO))
        for p in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
        if pattern.search(p.read_text())
    ]
    assert offenders == []


# What each lower layer of the port may import from the port besides
# itself: a layer (every module under it) or one module.
LAYERS_BELOW = {
    "ops": set(),
    "native": set(),
    "parallel": set(),
    "utils": {"native", "ops"},
    "search": {"ops", "utils"},
    "networks": {"ops"},
    "envs": {"config.yaml_io", "ops", "utils"},
    "evaluation": {"config", "envs", "networks", "ops", "search", "utils"},
}


def _module_name(path):
    parts = list(path.relative_to(PORT).with_suffix("").parts)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _port_imports(path, modules):
    """The port's modules that ``path`` imports, at module level or inside
    a function, each as its dotted name under ``nuzero_tpu_torch``: the
    longest prefix of the imported name that is a module of the port.  The
    port imports itself by absolute names only: a relative import is
    yielded as such, and no layer allows it."""
    def resolve(name):
        while name not in modules:
            name = name.rpartition(".")[0]
        return name

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                top, _, rest = alias.name.partition(".")
                if top == "nuzero_tpu_torch":
                    yield resolve(rest)
        elif isinstance(node, ast.ImportFrom) and node.level:
            yield f"relative import {'.' * node.level}{node.module or ''}"
        elif isinstance(node, ast.ImportFrom):
            top, _, module = node.module.partition(".")
            if top == "nuzero_tpu_torch":
                for alias in node.names:
                    yield resolve(f"{module}.{alias.name}".strip("."))


@pytest.mark.parametrize("layer", sorted(LAYERS_BELOW))
def test_layers_import_only_below(layer):
    """Every module under a lower layer imports from the port only its own
    layer and the layers (or modules) below it that ``LAYERS_BELOW`` names,
    so the import graph points one way."""
    modules = {_module_name(p) for p in PORT.rglob("*.py")} | {""}
    allowed = LAYERS_BELOW[layer] | {layer}
    offenders = sorted(
        f"{p.relative_to(REPO)} imports {target or 'nuzero_tpu_torch'}"
        for p in (PORT / layer).rglob("*.py")
        for target in _port_imports(p, modules)
        if not any(target == a or target.startswith(a + ".") for a in allowed)
    )
    assert offenders == []


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=_env(),
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _cli_entry_points():
    from nuzero_tpu_torch import interactive, run

    return [run.training_preset, run.testing_preset, run.debug_preset, run.analyse_run,
            run.live_goalrush, run.play, interactive.Wizard.__init__, interactive.start]


@pytest.mark.parametrize("entry", [SCSGame.__init__, init_tree, create_buffer,
                                   restore_checkpoint, *_cli_entry_points()])
def test_entry_points_default_to_the_card(entry):
    """The port runs on the card unless the caller asks for the CPU: the
    library's entry points, the CLI's modes and the wizard's launch paths."""
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_training_entry_points_follow_their_inputs(tmp_path):
    """``Learner`` and ``AlphaZero`` take no device of their own: they run
    where the module and the env they are given lie (the card by default)."""
    from nuzero_tpu_torch.config.schemas import (
        PlottingConfig, TestingFrequencyConfig, TrainingConfig,
    )
    from nuzero_tpu_torch.search.mcts import SearchParams
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    for entry in (Learner.__init__, AlphaZero.__init__):
        assert "device" not in inspect.signature(entry).parameters
    env = SCSGame(load_scenario(str(REPO / "configs/scenarios/open_field_5.yml"), seed=42),
                  device="cpu")
    mgr = NetworkManager(RecurrentNet(86, 21, num_filters=8), env.observation_shape)
    state = Learner(mgr, LearnerConfig()).init_state(torch.Generator().manual_seed(0))
    assert {v.device.type for v in state.params.values()} == {"cpu"}
    cfg = TrainingConfig(testing=TestingFrequencyConfig(policy_test_frequency=0,
                                                        mcts_test_frequency=0),
                         plotting=PlottingConfig(plot_loss=False))
    az = AlphaZero(env, mgr, cfg, SearchParams(num_simulations=2), run_dir=str(tmp_path))
    assert az.device.type == "cpu" and az.buffer.states.device.type == "cpu"


def test_cli_defaults_to_the_card():
    """``python -m nuzero_tpu_torch`` takes run.py's arguments and
    ``--device``, default cuda."""
    from nuzero_tpu_torch import run

    args = run.build_parser().parse_args(["--debug", "0"])
    assert args.device == "cuda"
    for flags in (["--training-preset", "2", "--filters", "256", "--net-dtype", "bfloat16"],
                  ["--testing-preset", "1", "--view"], ["--play", "mcts", "--cache", "keyless"],
                  ["--analyse", "r"], ["--interactive"], ["--training-preset", "0", "--name",
                  "n", "--train-config", "t", "--search-config", "s"]):
        run.build_parser().parse_args(flags)


@pytest.mark.parametrize("dtype,batch,cin,cout,ms,by", [
    # 2*7*M*Cin*Cout / 989 TFLOP/s with M = 768*25
    ("bfloat16", 768, 256, 256, 2 * 7 * 19200 * 256 * 256 / 989e9, "operations"),
    # (M*Cin + 7*Cin*Cout + M*Cout) * 2 bytes / 3.35 TB/s
    ("bfloat16", 768, 138, 21, (19200 * 138 + 7 * 138 * 21 + 19200 * 21) * 2 / 3.35e9, "bytes"),
    # f32 on the CUDA cores: 67 TFLOP/s
    ("float32", 512, 64, 64, 2 * 7 * 12800 * 64 * 64 / 67e9, "operations"),
    # the value ramp's last f32 conv moves more bytes than it does FLOPs
    ("float32", 512, 16, 1, (12800 * 16 + 7 * 16 * 1 + 12800 * 1) * 4 / 3.35e9, "bytes"),
    # a training update's recall conv (M = 256*25): dW of 342->256, and its
    # dX, the forward kernel at 256->342, do the same operations
    ("bfloat16", 256, 342, 256, 2 * 7 * 6400 * 342 * 256 / 989e9, "operations"),
    ("bfloat16", 256, 256, 342, 2 * 7 * 6400 * 342 * 256 / 989e9, "operations"),
    # dW of the value ramp's last conv, x [M, 64] and dY [M, 1]
    ("float32", 256, 64, 1, (6400 * 64 + 7 * 64 * 1 + 6400 * 1) * 4 / 3.35e9, "bytes"),
])
def test_chip_smoke_bound(dtype, batch, cin, cout, ms, by):
    """The least time chip_smoke.py reports for a 5x5 hex conv, and for the
    dW and dX of one (inputs read once, the output written once): the
    larger of the operations and the bytes at the card's peaks, and which
    one."""
    got_ms, got_by = chip_smoke.bound(dtype, batch, 5, 5, cin, cout)
    assert got_by == by
    assert abs(got_ms - ms) <= 1e-9 * ms


def test_chip_smoke_conv_shapes():
    """The 17 convs of one 2-iteration evaluation at 256 filters, as the
    kernel table lists them."""
    assert chip_smoke.conv_shapes(256) == [
        (86, 256, 1), (342, 256, 2), (256, 256, 8), (256, 138, 1), (138, 21, 1),
        (256, 192, 1), (192, 128, 1), (128, 64, 1), (64, 1, 1),
    ]


# A cuobjdump -sass excerpt in its own layout: one f32 instantiation with
# FFMA and LDGSTS, one bf16 instantiation with HGMMA.
_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_13f3218hexconv_f32_kernelILi64EEEvNS0_6ParamsE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x00000a00ff017b82 */
                                                                                 /* 0x000fe40000000800 */
        /*0010*/              @!P0 LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR4][R4.64] ;  /* 0x0000000004037fae */
        /*0020*/                   FFMA R8, R12, R16, R8 ;                       /* 0x000000100c087223 */
        /*0030*/                   FFMA R9, R12, R17, R9 ;                       /* 0x000000110c097223 */
		Function : _ZN12_GLOBAL__N_13hop25hexconv_bf16_wgmma_kernelILi64EEEvNS0_6ParamsE
        /*0000*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;  /* 0x0000000418187df0 */
        /*0010*/                   FFMA R2, R3, R4, R2 ;                         /* 0x0000000403027223 */
"""


@pytest.mark.parametrize("kernel,must,must_not,error", [
    ("hexconv_f32_kernel", ("FFMA", "LDGSTS"), ("HMMA", "HGMMA"), None),
    ("hexconv_bf16_wgmma_kernel", ("HGMMA",), (), None),
    ("hexconv_f32_kernel", ("FFMA", "LDGSTS", "LDSM"), (), "lacks \\['LDSM'\\]"),
    ("hexconv_bf16_wgmma_kernel", ("HGMMA",), ("FFMA",), "holds \\['FFMA'\\]"),
    ("hexconv_f16_kernel", ("FFMA",), (), "not in the SASS"),
])
def test_chip_smoke_sass_check(kernel, must, must_not, error):
    """chip_smoke.py's SASS check on a canned excerpt: an opcode counts
    without its modifiers and predicate, HMMA is not HGMMA, and a missing
    or forbidden instruction raises."""
    if error is None:
        counts = chip_smoke.check_sass(_SASS, kernel, must, must_not)
        assert all(counts[op] > 0 for op in must)
        assert all(counts[op] == 0 for op in must_not)
    else:
        with pytest.raises(AssertionError, match=error):
            chip_smoke.check_sass(_SASS, kernel, must, must_not)


def test_chip_smoke_sass_counts():
    counts = chip_smoke.sass_opcodes(_SASS, "hexconv", ("FFMA", "LDGSTS", "HGMMA"))
    assert list(counts.values()) == [
        {"FFMA": 2, "LDGSTS": 1, "HGMMA": 0}, {"FFMA": 1, "LDGSTS": 0, "HGMMA": 1},
    ]


def test_chip_smoke_checks_every_kernel():
    """Phase 1 holds every kernel to a SASS rule (the f32 dW kernel: FFMA
    fed by cp.async, no tensor-core instruction; the bf16 dW kernel: HGMMA
    fed by ldmatrix),
    and phase 2's ragged f32 cases cover odd Cin,
    pixel counts off the block size, odd and even widths and Cout of 1 and
    42."""
    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import DW_KERNELS, KERNELS

    assert set(chip_smoke.SASS) == {*KERNELS.values(), *DW_KERNELS.values()}
    assert chip_smoke.SASS["hexconv_f32_kernel"] == (("FFMA", "LDGSTS"), ("HMMA", "HGMMA"))
    assert chip_smoke.SASS[DW_KERNELS[torch.float32]] == (("FFMA", "LDGSTS"), ("HMMA", "HGMMA"))
    assert chip_smoke.SASS[DW_KERNELS[torch.bfloat16]] == (("HGMMA", "LDSM"), ())
    ragged = chip_smoke.RAGGED
    assert any(cin % 2 for _, _, _, cin, _ in ragged)
    assert any((b * h * w) % 64 for b, h, w, _, _ in ragged)
    assert {w % 2 for _, _, w, _, _ in ragged} == {0, 1}
    assert {1, 42} <= {cout for *_, cout in ragged}


@pytest.mark.parametrize("intervals,ms", [
    ([], 0.0),
    ([(0, 10)], 0.01),
    ([(0, 10), (5, 20), (30, 40)], 0.03),  # overlapping kernels count once
    ([(30, 40), (0, 10), (2, 4)], 0.02),   # nested and out of order
])
def test_chip_smoke_union_ms(intervals, ms):
    """Device time of kernels that may overlap (the f32 dW's reduce kernel
    starts beside its main kernel): the union of their intervals, us -> ms."""
    assert chip_smoke.union_ms(intervals) == pytest.approx(ms)


def test_chip_smoke_idle_gaps():
    """Idle time between kernels, counted once where kernels overlap, and
    charged to the kernel before the gap."""
    kernels = [{"ts": 0, "dur": 10, "name": "a(int)"}, {"ts": 5, "dur": 20, "name": "b(x)"},
               {"ts": 1025, "dur": 5, "name": "a(int)"}, {"ts": 1033, "dur": 1, "name": "c"},
               {"ts": 3034, "dur": 1, "name": "d"}]
    assert chip_smoke.idle_gaps(kernels) == (
        "idle between kernels 3.0 ms over 4 gaps, 2 gaps over 10 us sum to 3.0 ms; most "
        "idle after: c 2.0 ms, b 1.0 ms, a 0.0 ms")


def test_chip_smoke_backward_ragged_shapes():
    """The backward's ragged cases: dW with Cin 1 and 21 and Cout 1 and 342;
    dX (Cin and Cout swapped) with Cin 1 and 21 and Cout 342, 150, 138 and
    86; odd widths; pixel counts off the dW kernel's 16-pixel chunk."""
    ragged = chip_smoke.BACKWARD_RAGGED
    cins, couts = {s[3] for s in ragged}, {s[4] for s in ragged}
    assert {1, 21} <= cins and {1, 342} <= couts
    assert {1, 21} <= couts and {342, 150, 138, 86} <= cins
    assert {w % 2 for _, _, w, _, _ in ragged} == {0, 1}
    assert any((b * h * w) % 16 for b, h, w, _, _ in ragged)


@pytest.mark.parametrize("filters,shapes", [
    (256, [(86, 256, 1), (342, 256, 4), (256, 256, 16), (256, 138, 1), (138, 21, 1),
           (256, 192, 1), (192, 128, 1), (128, 64, 1), (64, 1, 1)]),
    (64, [(86, 64, 1), (150, 64, 4), (64, 64, 16), (64, 42, 1), (42, 21, 1),
          (64, 48, 1), (48, 32, 1), (32, 16, 1), (16, 1, 1)]),
])
def test_chip_smoke_update_shapes_and_launches(filters, shapes):
    """One training update at 4 iterations runs 27 hex convs: 27 forward
    launches, 26 dX (all but the stem's) and 27 dW."""
    assert chip_smoke.conv_shapes(filters, iterations=chip_smoke.TRAIN_ITERS) == shapes
    assert chip_smoke.launches_per_update() == {"forward": 27, "dx": 26, "dw": 27}
    assert sum(n for *_, n in shapes) == 27


@pytest.mark.parametrize("n,k", [(n, k) for n in range(4) for k in range(1, 5 - n)])
def test_progressive_update_launches(n, k, monkeypatch):
    """The launches chip_smoke.py expects of one update with the progressive
    loss on (4 iterations, draws (n, k)), counted here as calls of the
    plain versions on the CPU, which stand where the card launches the
    forward (and dX) and the dW kernel."""
    from nuzero_tpu_torch.ops import hexconv

    counts = {"forward": 0, "dx": 0, "dw": 0}

    def counted(name, fn):
        def call(*args):
            counts[name] += 1
            return fn(*args)
        return call

    for name, attr in (("forward", "hex_conv_plain"), ("dx", "hex_conv_dx_plain"),
                       ("dw", "hex_conv_dw_plain")):
        monkeypatch.setattr(hexconv, attr, counted(name, getattr(hexconv, attr)))
    env = SCSGame(load_scenario(str(REPO / "configs/scenarios/open_field_5.yml"), seed=42),
                  device="cpu")
    mgr = NetworkManager(RecurrentNet(86, 21, num_filters=8), env.observation_shape)
    learner = Learner(mgr, LearnerConfig(train_iterations=4, prog_alpha=0.01),
                      draws=lambda rng, m: (n, k))
    state = learner.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    obs = env.observe(env.init(2))
    policy = torch.softmax(torch.randn(2, env.num_actions, generator=gen), -1)
    learner.train_step(state, (obs, policy, torch.zeros(2), torch.zeros(2, dtype=torch.int32)),
                       torch.Generator())
    # The plain dX is the plain forward on mirrored taps, as dX on the card
    # is the forward kernel: the forward count holds both.
    want = chip_smoke.launches_per_progressive_update(4, n, k)
    assert counts == {**want, "forward": want["forward"] + want["dx"]}


def test_library_backward_is_the_hex_backward():
    """The dX/dW yardstick (cuDNN's ``convolution_backward`` of the dual 3x3
    conv, here on the CPU) computes the hex conv's backward once mapped back
    to the hex layout (f32, 1e-5 of the largest value)."""
    from nuzero_tpu_torch.ops import hexconv

    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 5, 7, 6, generator=gen), torch.randn(7, 6, 3, generator=gen)
    dy = torch.randn(2, 5, 7, 3, generator=gen)
    dx_call, dw_call, to_hex = chip_smoke.library_backward(x, w, dy)
    dx, dw = to_hex(dx_call(), dw_call())
    for got, want in ((dx, hexconv.hex_conv_dx_plain(dy, w)),
                      (dw, hexconv.hex_conv_dw_plain(x, dy))):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# What an H100 holds at once of the f32 dW kernel's clusters of c = 1..8
# blocks at one block per SM: 132 SMs in GPCs of 16 and 18 (a cluster's
# blocks share a GPC).
_GPCS = (16, 16, 16, 16, 16, 16, 18, 18)
_CAPACITY = tuple(sum(n // c for n in _GPCS) for c in range(1, 9))


@pytest.mark.parametrize("m,tiles", [
    (6400, 3), (6400, 5), (6400, 2), (6400, 1),
    (6400, 16), (6400, 40), (6400, 32), (6400, 20), (6400, 15), (6400, 12), (6400, 4),
    (10, 1), (16, 1), (17, 6), (25, 1), (1800, 12), (12800, 2), (57600, 1), (6400, 132),
    (6400, 1024),
])
def test_dw_slices_cover_every_pixel(m, tiles):
    """The f32 dW kernel's grid for ``tiles`` blocks per slice (the 64f
    update's 3, 5, 2 and 1, the 256f update's 16, 40, 32, 20, 15, 12 and 4,
    then edges): slices of whole 16-pixel chunks that cover every pixel
    once, none empty, whose count the cluster size divides with clusters of
    at least 4 blocks (or one cluster of at most 8), all of the grid's
    clusters held by the card at once (``_CAPACITY``), and no shorter slice
    that keeps all of that."""
    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import dw_cluster, dw_slices

    slices, per = dw_slices(m, tiles, _CAPACITY)
    starts = range(0, slices * per, per)
    assert per % 16 == 0 and per > 0
    assert all(start < m for start in starts) and slices * per >= m  # none empty, all covered

    def fits(n):
        c = dw_cluster(n)
        return n == 1 or ((n <= 8 or c >= 4) and tiles * (n // c) <= _CAPACITY[c - 1])

    cluster = dw_cluster(slices)
    assert 1 <= cluster <= 8 and slices % cluster == 0
    assert fits(slices)
    chunks, per_chunks = -(-m // 16), per // 16
    if per_chunks > 1:
        shorter = -(-chunks // (per_chunks - 1))
        assert tiles * shorter > _CAPACITY[0] or not fits(shorter)
    if (m, tiles) == (6400, 2):
        assert (slices, per, cluster) == (50, 128, 5)  # 64->64: 2 x 10 clusters of 5 blocks


@pytest.mark.parametrize("m,tiles", [
    (6400, 8), (6400, 24), (6400, 16), (6400, 12), (6400, 3), (6400, 6), (6400, 2), (6400, 1),
    (10, 1), (16, 1), (17, 6), (1800, 12), (57600, 1), (6400, 132), (6400, 1024),
])
def test_dw_wgmma_slices_cover_every_pixel(m, tiles):
    """The bf16 dW kernel's grid for ``tiles`` blocks per slice (the 256f
    update's 8, 24, 16, 12, 3, 12, 6, 2 and 1, then edges): slices of whole
    16-pixel steps that cover every pixel once, none empty, and the
    shortest such slices that keep the blocks in one wave of 132 SMs."""
    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import dw_wgmma_slices

    slices, per = dw_wgmma_slices(m, tiles, 132)
    starts = range(0, slices * per, per)
    assert per % 16 == 0 and per > 0
    assert all(start < m for start in starts) and slices * per >= m  # none empty, all covered
    steps, per_steps = -(-m // 16), per // 16
    wave = max(132, tiles)
    assert tiles * slices <= wave
    shorter = -(-steps // (per_steps - 1)) if per_steps > 1 else None
    assert shorter is None or tiles * shorter > wave, "a shorter slice would still fit one wave"


def test_build_digest_follows_the_headers(tmp_path, monkeypatch):
    """A kernel library is keyed on its source and on every header under
    csrc/: editing either gives another file name, so no stale library is
    loaded; other files leave it alone."""
    from nuzero_tpu_torch.ops.cuda import build

    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("a\n")
    first = build.library_path("k", ("k.cu",))
    assert first == build.library_path("k", ("k.cu",))
    (tmp_path / "notes.txt").write_text("b\n")
    assert build.library_path("k", ("k.cu",)) == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = build.library_path("k", ("k.cu",))
    assert second != first
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert build.library_path("k", ("k.cu",)) not in (first, second)
    assert os.path.dirname(first) == build.BUILD_DIR
