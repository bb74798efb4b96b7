"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: print the card's name and power limit; build the kernel
   libraries from ``nuzero_tpu_torch/ops/cuda/csrc`` (one ``nvcc`` per
   source, side by side) and check each kernel's machine code with
   ``cuobjdump -sass`` (``SASS``): the bf16 forward kernel runs on Hopper's
   warpgroup tensor cores (``HGMMA``); the f32 forward kernel does FFMA on
   the CUDA cores, fed by ``cp.async`` (``LDGSTS``), and holds no
   tensor-core instruction (no ``HMMA``, no ``HGMMA``); the bf16 dW kernel
   runs on the warpgroup tensor cores with its A operand gathered by
   ``ldmatrix`` (``HGMMA``, ``LDSM``); the f32 dW kernel, like the f32
   forward, does FFMA fed by ``cp.async`` (``LDGSTS``) and holds no
   tensor-core instruction;
2. kernel check: the CUDA hex conv against its plain PyTorch version at
   every conv shape of the two self-play legs, plus 10x10 and 30x30
   boards in both dtypes, ragged f32 shapes (``RAGGED``: odd Cin, pixel
   counts off the block size, odd and even widths, Cout of 1 and 42), and
   the f32 shapes of the transfer sweeps (phase 13: B=64 on 5x5 to 15x15
   boards, Cin 67 and 131, Cout 38, 12 and 1), with their times summed
   per evaluation at 2, 6 and 24 iterations.
   Kernel, plain and library times are taken in
   turns with CUDA events; the library call is the JAX package's XLA path
   as one cuDNN ``conv2d`` (``hex_conv_dual3x3``; only the ``conv2d`` is
   timed), and each shape's bound is computed from its shape (``bound``);
3. network check: both legs' RecurrentNet on the card (kernel) against
   the same weights on the CPU (plain version) on a small batch;
4. self-play, 256 filters, bf16 compute, B=768, and
5. self-play, 64 filters, f32, B=512: ``init_selfplay`` then four eager
   moves of ``make_selfplay_step`` (SCS ``open_field_5.yml``, seed 42,
   ``RecurrentNet(policy_channels=21, num_blocks=2, recall=True,
   hex=True)``, 2 iterations, 30 simulations with carried trees,
   ``training=True``; random weights from a seed).  Each leg checks the
   move counter, the legality of every played action, that policy targets
   are distributions over the legal actions, and that the kernel ran
   17 times per network evaluation, and plays one more move under
   ``torch.profiler`` (device kernels, busy time, idle share, the hex
   conv's share).  Then the graphed move: from
   the same initial state and generator state, ``capture_selfplay_step``
   and four replays, each under sync debug mode "error" (no host sync
   inside a replay), each equal bit for bit to the eager move of the same
   index in every tensor the move writes and in the generator's state,
   with the recorded policy rows over the recorded positions' legal
   actions; then one replay under the profiler, which must count 17 x 31
   = 527 hex-conv launches (with where the card idles, ``idle_gaps``),
   and the capture time, seconds per replayed move, the host's time until
   ``replay()`` returns and env-steps/s beside the eager ones.

The training half:

6. backward kernel check: in both dtypes, at every hex-conv shape of one
   training update at B=256 (256f bf16, the flagship; 64f f32,
   ``scs_small.yaml``), the dW kernel against ``hex_conv_dw_plain`` and dX
   (the forward kernel on ``mirror_taps(W)``) against ``hex_conv_dx_plain``,
   plus the ragged shapes ``BACKWARD_RAGGED`` and, for the bf16 dW
   kernel, a 30x30 board (the f32 dW within 1e-5 of max|dW|, the bf16
   within 1e-2); each line prints kernel, plain and library ms
   (cuDNN's ``convolution_backward`` of the dual 3x3 conv,
   ``library_backward``) as loops of calls, the dW kernel's and the
   library's weight-grad also as replayed CUDA graphs (device time
   without the host's rate of calls), the bound and the launches per
   update;
7. gradient check: one learner update of each net on the card against the
   same update on the CPU from the same weights, then the launch counts of
   one update at B=256 with the progressive loss off (27 forward + 26 dX
   launches of the forward kernel, 27 of the dW kernel); then that 64f f32
   update (``scs_small.yaml``'s width) timed over 10 updates and profiled
   once (device busy time, idle share, hex-conv forward, dX and dW device
   time); and, run after the heavy phases (after 13), the repeat check
   (``repeat_check``): the card gradient test's f32 update (16f, 3
   iterations, B=8) ``REPEATS`` times on the same inputs and the f32 dW
   kernel alone ``REPEATS`` times at each of that net's shapes, every
   repeat bit-equal to the first (both kernels sum in a fixed order);
8. training run: ``AlphaZero(...).run()`` on the flagship configs
   (``scs_contested256.yaml``, ``scs_contested256_search.yaml``) loaded by
   the port's schemas at full network and learner width, cut as
   ``TRAIN_CUTS`` says, its self-play through the graphed move; it
   prints each step's self-play and train seconds and checks the update
   count, finite losses, changed parameters, a grown buffer and a
   checkpoint that restores equal through ``load``; then times 10 more
   learner updates on the filled buffer and profiles one (device busy
   time, idle share, hex-conv forward, dX and dW device time).

The non-recurrent networks, Tic-Tac-Toe and the evaluation layer:

9. zoo: ``ConvNet(num_layers=2)`` and ``ResNet(num_blocks=4)``, hex, at
   256f bf16 B=768 and 64f f32 B=512 on ``open_field_5.yml`` observations,
   and ``MLPNetwork`` (``run.py`` preset 0) on Tic-Tac-Toe at B=4096: each
   against the same weights on the CPU (plain path) on 8 positions, the
   hex-conv launches of one evaluation (9 and 15), ms per evaluation;
10. TTT self-play, ``MLPNetwork``, ``ttt_search.yaml`` (100 simulations,
   carried trees), B=1024 and B=4096 (``bench.py``'s TTT legs): four eager
   moves, then the captured move and four replays under sync debug mode
   "error", each equal bit for bit to the eager move, env-steps/s of both;
11. evaluation on SCS at full width (``solo_scout_5.yml``):
   ``TestManager.run_test_batch`` with ``PolicyAgent`` (RecurrentNet 256f
   bf16, 2 iterations) against ``GoalRushAgent``, 256 games from each seat,
   then ``MctsAgent`` (30 simulations) against ``GoalRushAgent`` cut as
   ``ARENA_CUTS`` says, and ``PolicyAgent`` on ``open_field_5.yml``, where
   both players own units, cut as ``ARENA_BOTH`` says; every played action
   legal, wins + losses + draws = games, network evaluations in every seat
   where the agent decides, 17 hex-conv launches per ``PolicyAgent``
   evaluation, seconds per arena move;
12. TTT training through ``AlphaZero.run()`` on ``ttt_default.yaml`` and
   ``ttt_search.yaml`` with the MLP, cut to ``TTT_STEPS`` steps, plots on,
   in-loop tests as configured (early, policy every 25, MCTS every 50,
   asynchronous): each step's self-play, train and eval seconds; every
   ``wr/*`` and ``nonloss/*`` key at steps 0, 25 and 50 under the async
   harvest's launch steps, finite losses, changed parameters, the
   captured self-play graph, and a checkpoint that restores equal.

The DeepThinking transfer path:

13. the three committed runs (``nuzero_tpu_torch/assets/runs``: the JAX
   package's Orbax checkpoints carried across) loaded through
   ``build_from_meta`` and ``TestManager.create_agent_from_config``; each
   net on the card (kernel) against the CPU (plain) on 8 reachable
   positions of every sweep size at 2, 6 and 24 iterations (within 1e-4
   of max|.|, legal argmax equal, 17/37/127 hex-conv launches per
   evaluation); ``run.py`` preset 2, the iteration sweep (64 games a point,
   2-20 iterations) of ``scs_solo_r3`` and ``scs_solo_prog_r3``, equal to
   the port's CPU curve and to the committed curve (except where the JAX
   package on the CPU does not reproduce the TPU-made curve,
   ``CPU_DIFFERS_FROM_COMMITTED``), with the smallest decision margin of
   each point's game; preset 3, the size sweep of ``scs_solo_rvp_r5`` (6
   sizes x 3 iteration counts x 64 games, layouts drawn per game), each
   point within 3 standard deviations of the two samples plus 1/64 of the
   committed rate and the mean within 3 standard errors; every arena action
   legal, the launches of every evaluation, the mean seconds per arena
   move of each sweep; then a ``randomize_vp`` self-play leg (64f f32, B=512,
   ``solo_scout_5.yml``): four eager moves after ``RVP_LEG``'s warm-up,
   then the captured move's four replays under sync debug mode "error",
   each equal bit for bit, recycled games on new layouts.

The rest of the training pipeline:

14. ``run.py`` training preset 3's recipe through ``AlphaZero.run()``:
   ``scs_small.yaml`` and ``scs_search.yaml`` loaded by the port's schemas,
   ``solo_scout_5.yml`` with per-game victory points, the solo state set,
   RecurrentNet 64f f32 (the committed ``scs_solo_rvp_r5``'s net), cut as
   ``PRESET3_CUTS`` says.  (a) ``value_probe/0..5`` at steps 2 and 4 only,
   in [-1, 1], the final probes on the card within 1e-5 of max|v| of the
   CPU's, 27 f32-kernel launches per probe evaluation; (b) ``weights/abs_*``
   ordered and equal to the CPU's within 1e-6 of ``abs_max``; (c) the plots,
   or the one warning that names the missing matplotlib; (d) finite
   losses, changed parameters, a checkpoint restored equal and
   ``load_buffer_at_step(2)`` at the journal's ``buffer_seq``; (e) the
   asynchronous mode (``PRESET3_ASYNC``): every step at least
   ``update_delay`` long with a move-batch, one capture per step function,
   no host sync inside a replay; (f) two game types (``PRESET3_TYPES``):
   per-type losses and games, a graph per type, both types in the buffer,
   27 and 37 launches per evaluation; (g) ``NUZERO_MFU`` and
   ``NUZERO_TRACE_DIR`` (``PRESET3_TRACE``): ``train_flops_per_s`` > 0 and a
   Chrome trace whose kernels include the f32 forward and dW kernels.

The command line:

15. the port's CLI on the card, each mode a subprocess that calls
   ``nuzero_tpu_torch.run.main`` with the mode's arguments, as ``python -m
   nuzero_tpu_torch.run`` does, must exit 0 and then writes its launches
   per kernel to a file (``CLI_DRIVER``): (a) ``--debug 0/1/2`` side by side (a board and the terminal
   value; the tree dump names the chosen action among the root's
   children); (b) ``--training-preset 2 --filters 256 --net-dtype
   bfloat16``, the flagship width, on copies of ``scs_small.yaml`` and
   ``scs_search.yaml`` cut in depth (``CLI_TRAIN_CUTS``) with an absolute
   ``--name`` in a temporary directory: the run directory's files, the
   journal's keys (``JOURNAL_KEYS``), and the bf16 forward and dW kernels'
   launches equal to what the moves and updates give
   (``expected_cli_launches``); (c) the same with ``load_checkpoint`` on,
   which must resume at the saved step for one more; (d) its last
   checkpoint through ``build_from_meta`` (f32) on the card and the CPU
   within 1e-4, and as the 256f bf16 net within 1e-2, on 8 positions; (e) side by side:
   testing preset 1, testing preset 2 on ``scs_solo_r3`` (from its export;
   its curve must equal phase 13's), ``--play mcts --cache keyless`` with
   moves 0-8 on stdin (a whole game, the hit ratio printed),
   ``--interactive`` with "5" (quit), and (f) the wizard's new-training
   flow, TTT + MLP cut to one step (``WIZARD_TRAIN``).  ``--analyse`` and
   ``--view`` open the pygame viewer, which the card machine lacks; they
   are held headless on a CPU host (``tests/test_torch_viewer.py``).

The last modules of the port:

16. the discontinued value heads (``depth``, ``combined``, ``separable``,
   ``reverse``, ``rawsep``, ``strange``): (a) their hex convs' shapes
   (256 -> 256, 256 -> 64, 64 -> 8, 8 -> 1, 256 -> 1, 64 -> 256, 64 -> 1)
   forward, dX and dW against the plain versions in both dtypes at B=64;
   (b) each head in ``RecurrentNet(num_filters=256, num_blocks=2, hex=True)``
   in bf16 and at 64f in f32, on weights drawn in the JAX package's Flax
   tree (``flax_variables``) and carried across by ``networks/convert.py``,
   one forward at B=64 on ``open_field_5.yml`` positions against the same
   weights on the CPU (f32 within 1e-4 of each output's largest entry;
   bf16 within 1e-2 of its largest or of 0.1, and in norm within twice
   bf16's own error) with its hex-conv launches exact (14 depth, 17 combined and strange, 13
   separable, reverse and rawsep); (c) one learner update of each, its
   launches exact; (e) the f32 depthwise convs with TF32 allowed, within
   1e-5 of float64;
17. data-parallel training on the one card, ranks as subprocesses over
   gloo (NCCL refuses two ranks on one device): (a) the CLI's
   ``--training-preset 2 --filters 256 --net-dtype bfloat16`` cut as phase
   15 cuts it, on 2 ranks of a torchrun-style launch (64 of the 128 actors
   each), then its one-step resume at 2 ranks; each rank reports through
   ``DP_DRIVER`` a SHA-256 of its params (equal across ranks), its
   launches (exact, ``expected_cli_launches``) and its ring's games; the
   journal holds each step once and each checkpoint is written once, with
   one ring file per rank; (b) the gradient of one global batch by 2 ranks
   (the learner's all-reduced gradient, which every rank applies) and by
   1, 64f f32 (within 1e-5 of each tensor's largest), 256f bf16 (within
   1e-2 of the gradient's largest, each tensor within twice bf16's own
   error, as phase 7 holds bf16);
   (c) a one-rank NCCL group's gradient bit-equal to the one without it.  NCCL
   across cards needs more than one card and is not run.

The SCS env's step kernel (``csrc/scs_step.cu``), run after phase 2:

18. at each shape the benchmark's cells step (``SCS_STEP_SHAPES``:
   ``solo_scout_5`` with victory points per game at B=128, ``open_field_5``
   at B=512 and 1,024, the transfer sweep's 15x15, 21-turn solo scout at
   B=64), random legal play on the card to every game's end and three steps
   more, ``SCSGame.step`` (the kernel) against its plain version, the eager
   body ``SCSGame._step``, on the same states: every field equal
   (``torch.equal``), one launch a step; then both timed as graphs of the
   first 32 steps (kernel, plain and bound in us a step).  Phases 4 and 5
   also count the kernel's launches: one per simulation and one for the
   move, in the eager moves and in the capture with its warm-up.

The last two lines are a JSON summary of the kernels (with each hex-conv
kernel's launches in phase 15, ``cli``, 16, ``heads``, and 17, rank 0's,
``data_parallel``; the SCS step kernel's launches in phases 4 and 5 and its
times in phase 18) and ``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SIMS = 30
MOVES = 4
KERNEL_SOURCE = "nuzero_tpu_torch/ops/cuda/csrc/hexconv.cu"
DW_SOURCE = "nuzero_tpu_torch/ops/cuda/csrc/hexconv_dw.cu"
REPLACES = "nuzero_tpu/ops/pallas/hexconv_kernel.py:91"
# The dW kernel replaces no Pallas kernel: the JAX backward is XLA's VJP.
DW_REPLACES = "nuzero_tpu/ops/hexconv.py:205"
# (filters, dtype name, batch) of the two self-play legs.
LEGS = ((256, "bfloat16", 768), (64, "float32", 512))
SCS_STEP_SOURCE = "nuzero_tpu_torch/ops/cuda/csrc/scs_step.cu"
# The kernel replaces no Pallas kernel: the JAX engine's step is plain JAX.
SCS_STEP_REPLACES = "nuzero_tpu/envs/scs/game.py:SCSGame.step"
# (scenario, per-game victory points, batch) of phase 18: the shapes the
# benchmark's cells step (solo64, contested256 and its B=1,024 variant, the
# arena's 15x15 sweep point, "sweep15").
SCS_STEP_SHAPES = (("solo_scout_5", True, 128), ("open_field_5", False, 512),
                   ("open_field_5", False, 1024), ("sweep15", True, 64))
SCS_STEP_TIMED = 32  # recorded steps a timed graph holds
SCS_STEP_REPLAYS = 20
# (filters, dtype name) of the two learner widths: the flagship and
# scs_small.yaml's (the training recipe's default width).
NETS = ((256, "bfloat16"), (64, "float32"))
# Instructions each kernel's SASS must hold, and must not hold.
SASS = {
    "hexconv_bf16_wgmma_kernel": (("HGMMA",), ()),
    "hexconv_f32_kernel": (("FFMA", "LDGSTS"), ("HMMA", "HGMMA")),
    "hexconv_dw_f32_kernel": (("FFMA", "LDGSTS"), ("HMMA", "HGMMA")),
    "hexconv_dw_bf16_wgmma_kernel": (("HGMMA", "LDSM"), ()),
}
TRAIN_CONFIG = "configs/training/scs_contested256.yaml"
SEARCH_CONFIG = "configs/search/scs_contested256_search.yaml"
# The training run's cuts of the flagship configs (the files say 300
# steps, a checkpoint every 50, in-loop tests on, 512 actors, an early fill
# of 128 games and 100 simulations).
TRAIN_CUTS = {"training_steps": 3, "save_frequency": 3, "num_actors": 128,
              "early_fill_per_type": 16, "num_simulations": 30,
              "in-loop tests": "off"}
GRAD_BATCH = 16
TIMED_UPDATES = 10
# Phase 9: the MLP's TTT batch (the hex zoo runs at the self-play legs'
# widths and batches, LEGS).
MLP_BATCH = 4096
# Phase 10: bench.py's TTT legs.
TTT_BATCHES = (1024, 4096)
TTT_SEARCH = "configs/search/ttt_search.yaml"
TTT_CONFIG = "configs/training/ttt_default.yaml"
# Phase 11: the arena legs on solo_scout_5.yml (the scenario's cap is 70
# moves); the MCTS leg is cut in games and moves.
ARENA_SCENARIO = "solo_scout_5.yml"
ARENA_GAMES = 256
ARENA_CUTS = {"games": 32, "max_moves": 24, "num_simulations": 30}
# A PolicyAgent leg where both players own units, so that both seats'
# agent paths run (open_field_5.yml caps a game at 622 moves).
ARENA_BOTH = {"scenario": "open_field_5.yml", "games": 256, "max_moves": 48}
# Phase 12: the training run's cut of ttt_default.yaml (600 steps).
TTT_STEPS = 50

# Shapes, peaks and bounds of the kernel checks, and the launches they expect.
CONVS_PER_EVAL = 17
# Recurrent iterations of the training recipe (train_iterations: [4]) and
# its batch: one update's hex convs see B=256 5x5 boards, M = 6400 pixels.
TRAIN_ITERS, TRAIN_BATCH = 4, 256
# Peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 on the tensor
# cores, f32 on the CUDA cores (the f32 kernel keeps f32 rounding, so TF32
# is not its roofline), and device memory.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# (B, H, W, Cin, Cout) of the f32 kernel's ragged cases: odd Cin, pixel
# counts off the block size, odd and even widths, Cout of 1 and 42.
RAGGED = ((3, 7, 7, 21, 16), (2, 6, 6, 42, 1), (5, 5, 8, 64, 42), (4, 5, 5, 86, 70),
          (1, 9, 9, 150, 96))
# (B, H, W, Cin, Cout) of forward convs whose backward is checked off the
# training path: dW with Cin 1 and 21 and Cout 1 and 342, dX (the forward
# kernel with Cin and Cout swapped) with Cin 1 and 21 and Cout 342, 150,
# 138 and 86; odd widths; pixel counts off the dW kernel's 16-pixel chunk.
BACKWARD_RAGGED = ((4, 5, 5, 64, 1), (3, 5, 5, 138, 21), (2, 5, 5, 342, 256),
                   (3, 7, 7, 150, 64), (5, 3, 9, 86, 21), (2, 6, 6, 21, 1),
                   (1, 5, 7, 1, 342), (3, 5, 5, 256, 86))
# The transfer sweeps (``evaluation/sweeps.py``: the committed 64-filter
# solo-scout nets, f32): B=64 games on boards of 5x5 to 15x15, 67
# observation channels and 12 policy planes, at 2, 6 and 24 iterations.
SWEEP_BATCH = 64
SWEEP_SIZES = (5, 7, 9, 11, 13, 15)
SWEEP_ITERS = (2, 6, 24)


def log(*args):
    print(*args, flush=True)


def conv_shapes(filters: int, obs_channels: int = 86, policy_channels: int = 21,
                iterations: int = 2):
    """(Cin, Cout, count) of the hex convs of one RecurrentNet evaluation
    at ``iterations`` iterations, 2 blocks, recall."""
    from nuzero_tpu_torch.networks.blocks import _ramp

    shapes = [(obs_channels, filters, 1), (filters + obs_channels, filters, iterations),
              (filters, filters, 4 * iterations)]
    for head in (_ramp(filters, policy_channels, 2), _ramp(filters, 1, 4)):
        ins = [filters] + list(head[:-1])
        shapes += [(i, o, 1) for i, o in zip(ins, head)]
    assert sum(n for _, _, n in shapes) == 7 + 5 * iterations
    return shapes


def value_head_conv_shapes(head: str, filters: int):
    """(Cin, Cout) of the hex convs of value head ``head`` on a hex trunk
    of ``filters`` channels, read off the head that ``make_value_head``
    builds, in the order it holds them, which is their call order.  The
    heads' 1x1, grouped and depthwise convs are no hex convs and launch no
    kernel."""
    from nuzero_tpu_torch.networks.blocks import HexConv, make_value_head

    module = make_value_head(head, filters, hex=True, board_shape=(5, 5))
    return [tuple(m.weight.shape[1:]) for m in module.modules() if isinstance(m, HexConv)]


def convs_per_evaluation(head: str = "reduce", iterations: int = 2) -> int:
    """Hex convs of one hex RecurrentNet evaluation (2 blocks, recall) with
    value head ``head``: the stem, 5 per iteration, the policy ramp's 2 and
    the head's."""
    return 3 + 5 * iterations + len(value_head_conv_shapes(head, 64))


def sweep_conv_shapes(iterations: int = 2):
    """(Cin, Cout, count) of one evaluation of the sweeps' nets."""
    return conv_shapes(64, obs_channels=67, policy_channels=12, iterations=iterations)


def launches_per_update(iterations: int = TRAIN_ITERS) -> dict:
    """Kernel launches of one learner update with the progressive loss off
    (one forward at ``iterations``): every hex conv launches the forward
    kernel once forward and the dW kernel once backward, and every conv but
    the stem (whose input is the observation) the forward kernel once more
    for dX."""
    convs = 7 + 5 * iterations
    return {"forward": convs, "dx": convs - 1, "dw": convs}


def launches_per_progressive_update(iterations: int, n: int, k: int) -> dict:
    """Kernel launches of one learner update with the progressive loss on
    and its draws ``(n, k)`` (``training/learner.py:progressive_draws``):
    ``launches_per_update`` for the full forward, plus a second forward of
    ``n + k`` iterations whose thought is detached at iteration ``n`` (none
    where n is 0).  Its backward reaches only the convs after the detach
    and the heads (6 convs), and no dX where a conv's input is detached
    (the first conv of iteration ``n``, the recall on the detached thought
    and the observation) or is the observation (the stem)."""
    base = launches_per_update(iterations)
    convs = 7 + 5 * (n + k)
    if n == 0:
        dw, dx = convs, convs - 1
    else:
        dw, dx = 5 * k + 6, 5 * k + 5
    return {"forward": base["forward"] + convs, "dx": base["dx"] + dx, "dw": base["dw"] + dw}


def bound(dtype_name, batch, rows, cols, cin, cout):
    """The least time (ms) the card could take for one hex conv, and what
    bounds it: 2*7*M*Cin*Cout operations at the dtype's peak, or x, W and y
    each moved once at the memory rate."""
    m = batch * rows * cols
    size = 2 if dtype_name == "bfloat16" else 4
    ops_ms = 2 * 7 * m * cin * cout / PEAK_FLOPS[dtype_name] * 1e3
    bytes_ms = (m * cin + 7 * cin * cout + m * cout) * size / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` over a loop of ``reps`` calls, by CUDA events:
    device time, or the host's rate of calls where that is slower."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` as ``reps`` calls captured in one CUDA graph and
    replayed: device time without the host's rate of calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dual3x3_weights(weights):
    """The 7 taps ``[7, Cin, Cout]`` embedded in an even-column and an
    odd-column 3x3 kernel, stacked on the output axis: ``[2*Cout, Cin, 3, 3]``
    (OIHW; even-column outputs first)."""
    from nuzero_tpu_torch.ops.hexconv import hex_neighbor_offsets

    _, cin, cout = weights.shape
    k = weights.new_zeros(2, 3, 3, cin, cout)
    for parity in (0, 1):
        offs = hex_neighbor_offsets(parity)
        k[parity, offs[:, 0] + 1, offs[:, 1] + 1] = weights
    return k.permute(0, 4, 3, 1, 2).reshape(2 * cout, cin, 3, 3)


def hex_conv_dual3x3(x, weights):
    """The JAX package's XLA path (``nuzero_tpu/ops/hexconv.py:hex_conv``)
    as one library call, the yardstick timed beside the kernel: a dense
    3x3 ``conv2d`` with both parity kernels on the output axis, then each
    output column taken from its parity's half.  It does 18 multiply-adds
    per pixel and channel pair where the hex conv needs 7."""
    import torch

    B, H, W, _ = x.shape
    cout = weights.shape[-1]
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), dual3x3_weights(weights), padding=1)
    y = y.permute(0, 2, 3, 1).reshape(B, H, W, 2, cout)
    odd = (torch.arange(W, device=x.device) % 2).bool().view(1, 1, W, 1)
    return torch.where(odd, y[..., 1, :], y[..., 0, :])


def dual3x3_weight_grad_to_taps(dk, cin: int, cout: int):
    """The hex weight gradient [7, Cin, Cout] from the gradient of the dual
    3x3 weights ``[2*Cout, Cin, 3, 3]`` (``dual3x3_weights``): each tap's
    weights sit in both parity kernels, so its gradient is the sum of the
    two."""
    from nuzero_tpu_torch.ops.hexconv import hex_neighbor_offsets

    dk = dk.reshape(2, cout, cin, 3, 3)
    total = 0
    for parity in (0, 1):
        offs = hex_neighbor_offsets(parity)
        total = total + dk[parity, :, :, offs[:, 0] + 1, offs[:, 1] + 1].permute(2, 1, 0)
    return total


def library_backward(x, weights, dy):
    """The JAX package's backward as cuDNN calls (the library yardstick of
    the dX and dW kernels): the VJP of the dual 3x3 conv, dY stacked as
    [dY on even columns, dY on odd columns] against ``dual3x3_weights``.
    Returns (dx_call, dw_call, to_hex): the two ``convolution_backward``
    calls, input-grad and weight-grad, on prepared NCHW views, and a map of
    their outputs to the hex layout [B, H, W, Cin] and [7, Cin, Cout]."""
    import torch

    cin, cout, W = x.shape[3], dy.shape[3], x.shape[2]
    odd = (torch.arange(W, device=x.device) % 2).to(dy.dtype).view(1, 1, W, 1)
    dy2 = torch.cat([dy * (1 - odd), dy * odd], dim=3).permute(0, 3, 1, 2)
    xn, k = x.permute(0, 3, 1, 2), dual3x3_weights(weights)
    back = torch.ops.aten.convolution_backward

    def call(mask):
        return back(dy2, xn, k, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)

    def to_hex(dx, dk):
        return dx.permute(0, 2, 3, 1), dual3x3_weight_grad_to_taps(dk, cin, cout)

    return (lambda: call([True, False, False])[0], lambda: call([False, True, False])[1],
            to_hex)


def sass_opcodes(sass: str, kernel: str, opcodes) -> dict:
    """{function: {opcode: count}} for every function in ``cuobjdump -sass``
    output whose name holds ``kernel``; an instruction counts under its
    opcode without modifiers (``HGMMA.64x64x16.F32.BF16`` is ``HGMMA``)."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if kernel in name:
                counts[name] = dict.fromkeys(opcodes, 0)
        elif name in counts and "*/" in line:
            words = line.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):
                words = words[1:]
            op = words[0].split(".")[0] if words else ""
            if op in counts[name]:
                counts[name][op] += 1
    return counts


def check_sass(sass: str, kernel: str, must, must_not=()) -> dict:
    """Raise unless every instantiation of ``kernel`` holds each opcode of
    ``must`` and none of ``must_not``; returns the counts summed over them."""
    counts = sass_opcodes(sass, kernel, (*must, *must_not))
    if not counts:
        raise AssertionError(f"{kernel}: not in the SASS")
    for name, ops in counts.items():
        missing = [op for op in must if not ops[op]]
        forbidden = [op for op in must_not if ops[op]]
        if missing or forbidden:
            raise AssertionError(f"{kernel} ({name}): lacks {missing}, holds {forbidden}")
    return {op: sum(ops[op] for ops in counts.values()) for op in (*must, *must_not)}


def dump_sass(library_path: str) -> str:
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", library_path], capture_output=True, text=True,
                          check=True).stdout


def kernel_check(dtype, batch, rows, cols, cin, cout, gen):
    """Kernel vs plain on one shape -> (err, max|y|, kernel ms, plain ms,
    library ms)."""
    import torch

    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import hex_conv_cuda
    from nuzero_tpu_torch.ops.hexconv import hex_conv_plain

    x = torch.randn(batch, rows, cols, cin, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(7, cin, cout, device="cuda", generator=gen) / (7 * cin) ** 0.5).to(dtype)
    y = hex_conv_cuda(x, w)
    ref = hex_conv_plain(x, w)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
    if not (y.shape == ref.shape and err <= tol):
        raise AssertionError(
            f"hex conv {dtype} B={batch} {rows}x{cols} {cin}->{cout}: "
            f"max abs err {err} > {tol}"
        )
    lib_err = (hex_conv_dual3x3(x, w).float() - ref.float()).abs().max().item()
    if lib_err > tol:
        raise AssertionError(f"dual 3x3 conv2d {dtype} {cin}->{cout}: err {lib_err} > {tol}")
    # The library call alone: one conv2d on the channels-last NCHW view.
    xn, k = x.permute(0, 3, 1, 2), dual3x3_weights(w)
    conv = torch.nn.functional.conv2d
    # Plain, kernel, library, library, kernel, plain.
    reps = 20
    p1 = time_ms(lambda: hex_conv_plain(x, w), reps)
    k1 = time_ms(lambda: hex_conv_cuda(x, w), reps)
    l1 = time_ms(lambda: conv(xn, k, padding=1), reps)
    l2 = time_ms(lambda: conv(xn, k, padding=1), reps)
    k2 = time_ms(lambda: hex_conv_cuda(x, w), reps)
    p2 = time_ms(lambda: hex_conv_plain(x, w), reps)
    return err, scale, (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2


def make_env(device, cls=None):
    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.envs.scs.scenario import load_scenario

    path = os.path.join(REPO, "configs", "scenarios", "open_field_5.yml")
    return (cls or SCSGame)(load_scenario(path, seed=42), device=device)


def make_net(env, filters, dtype):
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet

    net = RecurrentNet(
        env.observation_shape[0], env.action_space_shape[0], num_filters=filters,
        num_blocks=2, recall=True, hex=True, dtype=dtype,
    ).to(env.device)
    return NetworkManager(net, env.observation_shape)


def network_check(filters, dtype):
    """The net on the card (kernel) vs on the CPU (plain) on 8 positions."""
    import torch

    env = make_env("cuda")
    mgr = make_net(env, filters, dtype)
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))
    obs = env.observe(env.init(8))
    with torch.no_grad():
        p, v, _ = mgr.apply(variables, obs, iters_to_do=2)
        cpu_mgr = make_net(make_env("cpu"), filters, dtype)
        cpu_vars = {k: t.cpu() for k, t in variables.items()}
        p_ref, v_ref, _ = cpu_mgr.apply(cpu_vars, obs.cpu(), iters_to_do=2)
    torch.cuda.synchronize()
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want, name in ((p, p_ref, "logits"), (v, v_ref, "value")):
        got = got.cpu()
        if not (got.shape == want.shape and torch.isfinite(got).all()):
            raise AssertionError(f"{filters}f {name}: bad shape or non-finite values")
        err = (got - want).abs().max().item()
        scale = max(want.abs().max().item(), 0.1)
        log(f"network {filters}f {dtype}: {name} max abs err {err:.3e} (scale {scale:.3e})")
        if err > rel * scale:
            raise AssertionError(f"{filters}f {name}: card vs CPU err {err} > {rel * scale}")


def union_ms(intervals) -> float:
    """ms covered by the union of (start, stop) intervals in microseconds:
    device time of kernels that may overlap (the f32 dW's reduce kernel is
    a programmatic dependent launch, running beside the main kernel's
    end)."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def idle_gaps(kernels) -> str:
    """Where the card idles between the profiled kernels (trace events):
    the idle time between the first start and the last end, the gaps over
    10 us, and the three kernels with the most idle time after them."""
    import collections

    events = sorted(kernels, key=lambda e: e["ts"])
    after = collections.Counter()
    total = big = 0.0
    n_big, end = 0, events[0]["ts"] + events[0]["dur"]
    for prev, e in zip(events, events[1:]):
        gap = e["ts"] - end
        if gap > 0:
            total += gap
            after[prev["name"].split("(")[0][-60:]] += gap
            if gap > 10:
                big, n_big = big + gap, n_big + 1
        end = max(end, e["ts"] + e["dur"])
    top = ", ".join(f"{name} {us / 1e3:.1f} ms" for name, us in after.most_common(3))
    return (f"idle between kernels {total / 1e3:.1f} ms over {len(events) - 1} gaps, "
            f"{n_big} gaps over 10 us sum to {big / 1e3:.1f} ms; most idle after: {top}")


def profile_run(fn, gaps=False):
    """``fn()`` under torch.profiler -> (seconds, device kernels, device busy
    ms as the union of kernel intervals, hex-conv ms, hex-conv launches),
    and ``idle_gaps`` of the trace as a sixth item with ``gaps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    busy = union_ms((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    hexconv = [e["dur"] for e in kernels if "hexconv" in e["name"]]
    out = (seconds, len(kernels), busy, sum(hexconv) / 1e3, len(hexconv))
    return out + (idle_gaps(kernels),) if gaps else out


def check_policy(policy, legal):
    """Raise unless each row of ``policy`` is a distribution over ``legal``."""
    import torch

    on_legal = (policy * legal).sum(-1)
    if not (torch.allclose(on_legal, torch.ones_like(on_legal), atol=1e-5)
            and float((policy * ~legal).abs().sum()) == 0.0):
        raise AssertionError("policy targets are not distributions over legal actions")


def scs_step_env(scenario, randomize_vp):
    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.envs.scs.scenario import load_scenario
    from nuzero_tpu_torch.evaluation.sweeps import size_env

    if scenario == "sweep15":
        return size_env(15)
    path = os.path.join(REPO, "configs", "scenarios", scenario + ".yml")
    return SCSGame(load_scenario(path, seed=42), randomize_vp=randomize_vp, device="cuda")


def scs_step_graph(fn, pairs):
    """A graph (``graphs.capture``, with its overflow flag) that calls ``fn``
    on each (state, action) of ``pairs`` once, after one eager pass on a side
    stream; (graph, outputs, flag)."""
    import torch

    from nuzero_tpu_torch.utils import graphs

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), graphs.overflow_into(torch.zeros((), dtype=torch.bool,
                                                                   device="cuda")):
        for state, action in pairs:
            fn(state, action)
    torch.cuda.current_stream().wait_stream(side)
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    graph = torch.cuda.CUDAGraph()
    with graphs.capture(graph, overflow=flag):
        outs = [fn(state, action) for state, action in pairs]
    return graph, outs, flag


def scs_step_check(card):
    """Phase 18: the SCS env's step kernel against its plain version, the
    eager body ``SCSGame._step``, on the same card states at each shape of
    ``SCS_STEP_SHAPES``: random legal play from the opening until every game
    has finished and three steps more, every field of every step equal bit
    for bit (``torch.equal``), one launch a step.  Then the first
    ``SCS_STEP_TIMED`` steps as two graphs, one of ``SCSGame.step`` (a kernel
    node a step) and one of ``_step`` (its stage-machine loops as
    while-nodes, as the self-play move's graph held the step before the
    kernel), each output checked against the eager body again, each replayed
    ``SCS_STEP_REPLAYS`` times: ms a step from the median replay's CUDA
    events.  The bound is the bytes a step reads and writes (every field in
    and out, and the action) at the card's memory rate; the kernel is bound by
    latency instead (its source note).  Returns one dict a shape."""
    import torch

    from nuzero_tpu_torch.ops.cuda import scs_step_kernel

    def fields(state):
        return [getattr(state, f.name) for f in dataclasses.fields(state)]

    def replay_ms(graph):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ms = []
        for _ in range(SCS_STEP_REPLAYS):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return statistics.median(ms)

    lines = []
    for scenario, randomize_vp, batch in SCS_STEP_SHAPES:
        env = scs_step_env(scenario, randomize_vp)
        label = f"{scenario} B={batch}"
        gen = torch.Generator(device="cuda").manual_seed(2**31 + batch)
        state = env.init(batch, generator=gen)
        scs_step_kernel.reset_launch_count()
        pairs, steps, after = [], 0, 0
        while after < 3:
            legal = env.legal_mask(state)
            u = torch.rand(legal.shape, generator=gen, device="cuda")
            action = torch.where(legal, u, -1.0).argmax(-1).to(torch.int32)
            want = env._step(state, action)
            got = env.step(state, action)
            differ = [f.name for f, g, w in zip(dataclasses.fields(want), fields(got),
                                                  fields(want)) if not torch.equal(g, w)]
            if differ:
                raise AssertionError(f"scs_step {label} step {steps}: the kernel differs from "
                                     f"the eager body in {differ}")
            if len(pairs) < SCS_STEP_TIMED:
                pairs.append((state, action))
            state = want
            steps += 1
            after += bool(state.terminal.all())
            if steps > env.max_game_length + 3:
                raise AssertionError(f"scs_step {label}: a game outlasted the scenario's bound")
        env.terminal_value(state)  # raises if a step overflowed
        if scs_step_kernel.launch_count[scs_step_kernel.KERNEL] != steps:
            raise AssertionError(f"scs_step {label}: {scs_step_kernel.launch_count} launches "
                                 f"in {steps} steps")
        want = [fields(env._step(s, a)) for s, a in pairs]
        ms = {}
        for name, fn in (("kernel", env.step), ("plain", env._step)):
            graph, outs, flag = scs_step_graph(fn, pairs)
            graph.replay()
            torch.cuda.synchronize()
            if bool(flag):
                raise AssertionError(f"scs_step {label}: the {name} graph overflowed")
            for i, (out, w) in enumerate(zip(outs, want)):
                if not all(torch.equal(g, e) for g, e in zip(fields(out), w)):
                    raise AssertionError(f"scs_step {label}: the {name} graph's step {i} "
                                         f"differs from the eager body")
            ms[name] = replay_ms(graph) / len(pairs)
            del graph, outs
        nbytes = 2 * sum(t.numel() * t.element_size() for t in fields(pairs[0][0]))
        nbytes += pairs[0][1].numel() * pairs[0][1].element_size()
        line = {"scenario": scenario, "batch": batch, "steps_checked": steps,
                "ms": ms["kernel"], "plain_ms": ms["plain"],
                "bound_ms": nbytes / PEAK_BYTES * 1e3, "bytes": nbytes}
        lines.append(line)
        log(f"scs_step {label}: {steps} steps to every game's end and 3 more, every field "
            f"equal to the eager body; graph of {len(pairs)} steps: kernel "
            f"{1e3 * line['ms']:.2f} us a step, plain {1e3 * line['plain_ms']:.1f} us, bound "
            f"{1e3 * line['bound_ms']:.3f} us ({nbytes} bytes), "
            f"{100 * line['bound_ms'] / line['ms']:.1f}% of bound  [{card}]")
    return lines


def selfplay_leg(filters, dtype, batch, card):
    """The eager moves, then the same moves as replays of the captured
    move, from the same state and generator state; returns (launches of the
    eager moves, evals, eager seconds per move, replayed seconds per move,
    the SCS step kernel's launches in the eager moves)."""
    import torch

    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.ops.cuda import hexconv_kernel, scs_step_kernel
    from nuzero_tpu_torch.search.mcts import SearchParams
    from nuzero_tpu_torch.training.selfplay import (
        capture_selfplay_step, init_selfplay, make_selfplay_step, move_tensors, play_in_place,
    )
    from nuzero_tpu_torch.utils.packing import make_packer

    def snapshot(sp, finished, stats):
        return {k: v.clone() for k, v in move_tensors(sp, finished, stats).items()}

    class CheckedSCSGame(SCSGame):
        """Records the legal mask of each played position and checks the
        played action against it (eager moves only: it reads the host)."""

        watch = None
        played_legal = None

        def step(self, state, action):
            if state is self.watch:
                legal = self.legal_mask(state)
                bi = torch.arange(action.shape[0], device=action.device)
                if not bool(legal[bi, action.long()].all()):
                    raise AssertionError("self-play played an illegal action")
                self.played_legal = legal
            return super().step(state, action)

    env = make_env("cuda", CheckedSCSGame)
    mgr = make_net(env, filters, dtype)
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))
    evals = 0

    def apply(v, obs):
        nonlocal evals
        evals += 1
        p, val, _ = mgr.apply(v, obs, iters_to_do=2)
        return p, val

    params = SearchParams(num_simulations=SIMS)

    def fresh_state():
        return init_selfplay(env, batch, torch.Generator(device="cuda").manual_seed(1),
                             search_params=params)

    step = make_selfplay_step(env, apply, params, training=True)
    label = f"{filters}f {dtype} B={batch}"
    sp = fresh_state()
    torch.cuda.synchronize()

    # --- eager moves: legality, launches
    seconds, eager = [], []
    bi = torch.arange(batch, device="cuda")
    hexconv_kernel.reset_launch_count()
    scs_step_kernel.reset_launch_count()
    evals = 0
    for move in range(MOVES):
        before = int(sp.total_moves)
        row = sp.move_count.long()
        env.watch = sp.games
        t0 = time.perf_counter()
        finished, stats = play_in_place(step, variables, sp)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if int(sp.total_moves) != before + batch:
            raise AssertionError("total_moves did not grow by B")
        if env.played_legal is None:
            raise AssertionError("the played move was not observed")
        check_policy(sp.policy_buf[bi, row], env.played_legal)
        if not bool(torch.isfinite(finished.final_value).all()):
            raise AssertionError("non-finite final values")
        if not torch.isfinite(stats["root_value_mean"]):
            raise AssertionError("non-finite root values")
        env.watch = env.played_legal = None
        eager.append(snapshot(sp, finished, stats))
        log(f"leg {label} move {move}: {seconds[-1]:.4f} s, "
            f"root_value_mean {float(stats['root_value_mean']):+.4f}, "
            f"tree_nodes_mean {float(stats['tree_nodes_mean']):.2f}")
    counts = dict(hexconv_kernel.launch_count)
    steps = scs_step_kernel.launch_count[scs_step_kernel.KERNEL]
    if evals != (1 + SIMS) * MOVES:
        raise AssertionError(f"{evals} network evaluations, expected {(1 + SIMS) * MOVES}")
    if steps != (1 + SIMS) * MOVES:  # a step per simulation, and the move's own
        raise AssertionError(f"{steps} SCS step kernel launches, expected {(1 + SIMS) * MOVES}")
    expected = {name: 0 for name in counts}
    expected[hexconv_kernel.KERNELS[dtype]] = CONVS_PER_EVAL * evals
    if counts != expected:
        raise AssertionError(f"kernel launches {counts}, expected {expected}")
    steady = statistics.median(seconds[1:])
    secs, n, busy, hex_ms, hex_n = profile_run(lambda: play_in_place(step, variables, sp))
    log(f"profile {label}: one eager move {secs:.4f} s under the profiler, "
        f"{n} device kernels, busy {busy:.1f} ms (idle {100 * (1 - busy / 1e3 / steady):.1f}% "
        f"of a {steady:.4f} s steady move); hex conv {hex_ms:.1f} ms in {hex_n} launches "
        f"({100 * hex_ms / busy:.1f}% of busy)  [{card}]")
    launches = counts[hexconv_kernel.KERNELS[dtype]]
    del sp

    # --- the same moves as replays of the captured move
    gsp = fresh_state()
    _, unpack, dim = make_packer(env.init(1))
    hexconv_kernel.reset_launch_count()
    scs_step_kernel.reset_launch_count()
    evals = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = capture_selfplay_step(step, variables, gsp)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    captured = hexconv_kernel.launch_count[hexconv_kernel.KERNELS[dtype]]
    captured_steps = scs_step_kernel.launch_count[scs_step_kernel.KERNEL]
    if (evals != 2 * (1 + SIMS) or captured != CONVS_PER_EVAL * evals
            or captured_steps != evals):
        raise AssertionError(f"warm-up and capture made {evals} evaluations, {captured} "
                             f"hex-conv and {captured_steps} SCS step kernel launches")
    replayed, launched = [], []
    for move in range(MOVES):
        row = gsp.move_count.long()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            finished, stats = graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launched.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        replayed.append(time.perf_counter() - t0)
        got = snapshot(gsp, finished, stats)
        differ = [k for k in eager[move] if not torch.equal(got[k], eager[move][k])]
        if differ:
            raise AssertionError(f"replay {move} differs from eager move {move} in {differ}")
        recorded = unpack(gsp.state_buf[bi, row, :dim])
        check_policy(gsp.policy_buf[bi, row], env.legal_mask(recorded))
        log(f"graph {label} replay {move}: {replayed[-1]:.4f} s (replay() returned after "
            f"{launched[-1]:.4f} s), equal to eager move {move} "
            f"in all {len(got)} tensors, no host sync inside, policy over the recorded "
            f"position's legal actions")
    graph.check_overflow()
    secs, n, busy, hex_ms, hex_n, gaps = profile_run(graph.replay, gaps=True)
    graph.check_overflow()
    if hex_n != CONVS_PER_EVAL * (1 + SIMS):
        raise AssertionError(f"{hex_n} hex-conv launches in a replayed move, expected "
                             f"{CONVS_PER_EVAL * (1 + SIMS)}")
    steady_g = statistics.median(replayed[1:])
    log(f"graph {label}: capture {capture_s:.2f} s (warm-up move included); steady "
        f"{steady_g:.4f} s per replayed move (median of replays 2-{MOVES}), "
        f"{batch * SIMS / steady_g:.1f} env-steps/s, against {steady:.4f} s and "
        f"{batch * SIMS / steady:.1f} eager  [{card}]")
    log(f"profile {label}: one replayed move {secs:.4f} s under the profiler, {n} device "
        f"kernels, busy {busy:.1f} ms (idle {100 * (1 - busy / 1e3 / steady_g):.1f}% of a "
        f"{steady_g:.4f} s replayed move); hex conv {hex_ms:.1f} ms in {hex_n} launches "
        f"({100 * hex_ms / busy:.1f}% of busy); {gaps}  [{card}]")
    return launches, (1 + SIMS) * MOVES, seconds, replayed, steps


def backward_check(dtype, batch, rows, cols, cin, cout, gen):
    """The dW kernel and dX (the forward kernel on the mirrored taps) of one
    hex conv against their plain versions -> {"dw": (err, max|dW|, kernel ms,
    plain ms, library ms, kernel graph ms, library graph ms), "dx": (...)}:
    ms per call of a loop of calls, and per call of a replayed CUDA graph of
    the same calls."""
    import torch

    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import hex_conv_cuda, hex_conv_dw_cuda
    from nuzero_tpu_torch.ops.hexconv import hex_conv_dw_plain, hex_conv_dx_plain, mirror_taps

    x = torch.randn(batch, rows, cols, cin, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(7, cin, cout, device="cuda", generator=gen) / (7 * cin) ** 0.5).to(dtype)
    dy = torch.randn(batch, rows, cols, cout, device="cuda", generator=gen).to(dtype)
    w_mirror = mirror_taps(w)
    lib_dx, lib_dw, to_hex = library_backward(x, w, dy)
    runs = {
        "dw": (lambda: hex_conv_dw_cuda(x, dy), lambda: hex_conv_dw_plain(x, dy), lib_dw),
        "dx": (lambda: hex_conv_cuda(dy, w_mirror), lambda: hex_conv_dx_plain(dy, w), lib_dx),
    }
    lib_out = dict(zip(("dx", "dw"), to_hex(lib_dx(), lib_dw())))
    out = {}
    for name, (kernel, plain, library) in runs.items():
        # f32: dW within 1e-5 of max|dW| (fixed-order f32 sums), dX 1e-4.
        tol = (1e-2 if dtype != torch.float32 else 1e-5 if name == "dw" else 1e-4)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        label = f"{name} {dtype} B={batch} {rows}x{cols} {cin}->{cout}"
        if not (got.shape == ref.shape and err <= tol * scale):
            raise AssertionError(f"{label}: max abs err {err} > {tol * scale}")
        lib_err = (lib_out[name].float() - ref.float()).abs().max().item()
        if lib_err > 2 * tol * scale:
            raise AssertionError(f"{label}: library err {lib_err} > {2 * tol * scale}")
        reps = 10
        p1, k1, l1 = time_ms(plain, reps), time_ms(kernel, reps), time_ms(library, reps)
        l2, k2, p2 = time_ms(library, reps), time_ms(kernel, reps), time_ms(plain, reps)
        kg1, lg1 = graph_ms(kernel, reps), graph_ms(library, reps)
        lg2, kg2 = graph_ms(library, reps), graph_ms(kernel, reps)
        out[name] = (err, scale, (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2,
                     (kg1 + kg2) / 2, (lg1 + lg2) / 2)
    return out


def random_batch(env, batch, gen, device):
    """A learner batch from ``gen``: binary observation planes, policy
    targets that are distributions with zeros, values in {-1, 0, 1}."""
    import torch

    shape = (batch,) + tuple(env.observation_shape)
    obs = (torch.rand(shape, generator=gen) < 0.2).float()
    pol = torch.rand(batch, env.num_actions, generator=gen)
    pol = torch.where(torch.rand(pol.shape, generator=gen) < 0.9, 0.0, pol) + 1e-6
    pol = pol / pol.sum(-1, keepdim=True)
    val = torch.randint(-1, 2, (batch,), generator=gen).float()
    gt = torch.zeros(batch, dtype=torch.int32)
    return tuple(t.to(device) for t in (obs, pol, val, gt))


def learner_for(mgr, alpha, draws=None, mesh=None):
    from nuzero_tpu_torch.training.learner import Learner, LearnerConfig, progressive_draws

    cfg = LearnerConfig(optimizer="Adam", learning_rate=1e-3, train_iterations=TRAIN_ITERS,
                        prog_alpha=alpha)
    return Learner(mgr, cfg, draws=draws or progressive_draws, mesh=mesh)


def grad_check(filters, dtype):
    """One learner update (Adam, 4 iterations, alpha 0.01 with the
    progressive branch's draws fixed at n=1, k=2) on the card against the
    same update on the CPU from the same weights.

    f32: losses within 1e-5 relative, gradients within 1e-4 of each
    tensor's largest, updated parameters within 5e-2 of lr (Adam's step of
    a near-zero gradient is sensitive to its last digits).

    bf16: both sides round every conv's output and dX to bf16 at the same
    places, but their f32 sums in another order flip some of those
    roundings, and the flips add up along the backward (the stem's
    gradient, the deepest, differs by ~5% in norm).  So each side is
    measured against bf16's own error: the same update computed in f32 on
    the CPU.  A bf16 gradient on the card must lie within twice the CPU's
    bf16-vs-f32 difference of the CPU's bf16 gradient (relative norms per
    tensor), the loss within 2e-2, and the parameter steps' signs agree on
    >= 98% of the parameters."""
    import torch

    from nuzero_tpu_torch.training.learner import TrainState

    lr = 1e-3
    env = make_env("cuda")
    params = make_net(env, filters, dtype).init(torch.Generator(device="cuda").manual_seed(0))
    batch = random_batch(env, GRAD_BATCH, torch.Generator().manual_seed(0), "cpu")
    cpu_env = make_env("cpu")

    def update(mgr, dev):
        learner = learner_for(mgr, 0.01, draws=lambda rng, iters: (1, 2))
        p = {k: v.to(dev) for k, v in params.items()}
        state = TrainState(params=p, opt_state=learner.init_opt_state(p), step=0)
        c_l, _, grads = learner.value_and_grad(state.params, tuple(t.to(dev) for t in batch),
                                               None)
        new = learner.apply_gradients(state, grads)
        return (float(c_l.detach()), {k: g.float().cpu() for k, g in grads.items()},
                {k: (new.params[k] - p[k]).cpu() for k in p})

    loss, grads, steps = update(make_net(env, filters, dtype), "cuda")
    torch.cuda.synchronize()
    loss_ref, grads_ref, steps_ref = update(make_net(cpu_env, filters, dtype), "cpu")
    f32 = dtype == torch.float32
    if not f32:
        _, grads_f32, _ = update(make_net(cpu_env, filters, torch.float32), "cpu")

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

    if not abs(loss - loss_ref) <= (1e-5 if f32 else 2e-2) * abs(loss_ref):
        raise AssertionError(f"{filters}f loss on the card {loss} vs CPU {loss_ref}")
    worst_g = worst_ratio = worst_p = 0.0
    for k in grads:
        scale = grads_ref[k].abs().max().item()
        err = (grads[k] - grads_ref[k]).abs().max().item()
        worst_g = max(worst_g, err / max(scale, 1e-30))
        worst_p = max(worst_p, (steps[k] - steps_ref[k]).abs().max().item())
        if f32 and err > 1e-4 * scale:
            raise AssertionError(f"{filters}f grad {k}: max err {err} vs max {scale}")
        if not f32:
            card_err, bf16_err = rel(grads[k], grads_ref[k]), rel(grads_ref[k], grads_f32[k])
            worst_ratio = max(worst_ratio, card_err / max(bf16_err, 1e-30))
            if card_err > 2 * bf16_err:
                raise AssertionError(f"{filters}f grad {k}: card vs CPU {card_err:.3e} of its "
                                     f"norm, over twice bf16 vs f32 {bf16_err:.3e}")
    agree = (torch.cat([(steps[k].sign() == steps_ref[k].sign()).flatten() for k in steps])
             .float().mean().item())
    if (f32 and worst_p > 5e-2 * lr) or (not f32 and agree < 0.98):
        raise AssertionError(f"{filters}f parameter steps differ by {worst_p}, signs agree "
                             f"on {agree:.4f}")
    log(f"gradient check {filters}f {dtype} B={GRAD_BATCH}: loss {loss:.6f} vs CPU "
        f"{loss_ref:.6f}; worst gradient err {worst_g:.2e} of its tensor's max"
        + ("" if f32 else f", card-vs-CPU at most {worst_ratio:.2f}x the CPU's bf16-vs-f32")
        + f"; parameter steps within {worst_p:.2e} (lr {lr}), signs agree on {agree:.4f}")


def update_launch_check(filters, dtype):
    """One learner update at B=256 and 4 iterations with the progressive
    loss off: the forward kernel launches 27 + 26 times, the dW kernel 27
    times.  Returns the counts of this run."""
    import torch

    from nuzero_tpu_torch.ops.cuda import hexconv_kernel

    env = make_env("cuda")
    mgr = make_net(env, filters, dtype)
    learner = learner_for(mgr, 0.0)
    state = learner.init_state(torch.Generator(device="cuda").manual_seed(0))
    batch = random_batch(env, TRAIN_BATCH, torch.Generator().manual_seed(1), "cuda")
    torch.cuda.synchronize()
    hexconv_kernel.reset_launch_count()
    state, metrics = learner.train_step(state, batch)
    torch.cuda.synchronize()
    counts = dict(hexconv_kernel.launch_count)
    per = launches_per_update()
    expected = {name: 0 for name in counts}
    expected[hexconv_kernel.KERNELS[dtype]] = per["forward"] + per["dx"]
    expected[hexconv_kernel.DW_KERNELS[dtype]] = per["dw"]
    if counts != expected:
        raise AssertionError(f"{filters}f update launches {counts}, expected {expected}")
    if not torch.isfinite(metrics["loss/combined"]):
        raise AssertionError(f"{filters}f update: non-finite loss")
    log(f"launches of one {filters}f {dtype} update (B={TRAIN_BATCH}, {TRAIN_ITERS} "
        f"iterations, alpha 0): forward kernel {per['forward']} + {per['dx']} (dX), "
        f"dW kernel {per['dw']}")
    return counts


def update_profile(filters, dtype, card):
    """The learner update of ``update_launch_check`` (B=256, 4 iterations,
    alpha 0), timed over ``TIMED_UPDATES`` updates after one warm-up, then
    one more under torch.profiler: device busy time, idle share and the
    hex conv's forward, dX and dW device time."""
    import torch

    env = make_env("cuda")
    learner = learner_for(make_net(env, filters, dtype), 0.0)
    state = learner.init_state(torch.Generator(device="cuda").manual_seed(0))
    batch = random_batch(env, TRAIN_BATCH, torch.Generator().manual_seed(1), "cuda")
    times = []
    for _ in range(1 + TIMED_UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = learner.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[1:]
    secs, n_kernels, busy, ms = profile_update(learner, state, batch, None)
    med = statistics.median(times)
    log(f"learner update {filters}f {dtype} B={TRAIN_BATCH}: median {med:.2f} ms of "
        f"{TIMED_UPDATES} (min {min(times):.2f}, max {max(times):.2f})  [{card}]")
    log(f"profile of one {filters}f update: {secs * 1e3:.2f} ms under the profiler, {n_kernels} "
        f"device kernels, busy {busy:.2f} ms (idle {100 * (1 - busy / med):.1f}% of a {med:.2f} "
        f"ms update); hex conv forward {ms['forward']:.2f} ms, dX {ms['dx']:.2f} ms, dW "
        f"{ms['dw']:.2f} ms ({100 * sum(ms.values()) / busy:.1f}% of busy)  [{card}]")


def profile_update(learner, state, batch, rng):
    """One learner update under torch.profiler -> (seconds, device kernels,
    device busy ms, hex-conv forward, dX and dW device ms), each the union
    of its kernels' intervals.  dW runs before dX in the hex conv's
    backward, so forward-kernel launches after the first dW launch are
    dX."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.train_step(state, batch, rng)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
    dw_start = min((e["ts"] for e in kernels if "hexconv_dw" in e["name"]), default=float("inf"))
    parts = {"forward": [], "dx": [], "dw": []}
    for e, span in zip(kernels, spans):
        if "hexconv_dw" in e["name"]:
            parts["dw"].append(span)
        elif "hexconv" in e["name"]:
            parts["dx" if e["ts"] > dw_start else "forward"].append(span)
    return seconds, len(kernels), union_ms(spans), {k: union_ms(v) for k, v in parts.items()}


def training_run(card):
    """The flagship training recipe through ``AlphaZero.run()``, cut by
    ``TRAIN_CUTS``; returns the kernel launches of the run."""
    import torch

    from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
    from nuzero_tpu_torch.ops.cuda import hexconv_kernel
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    cuts = TRAIN_CUTS
    cfg = load_training_config(os.path.join(REPO, TRAIN_CONFIG))
    cfg = dataclasses.replace(
        cfg,
        running=dataclasses.replace(cfg.running, training_steps=cuts["training_steps"],
                                    num_actors=cuts["num_actors"],
                                    early_fill_per_type=cuts["early_fill_per_type"]),
        saving=dataclasses.replace(cfg.saving, save_frequency=cuts["save_frequency"]),
        testing=dataclasses.replace(cfg.testing, early_testing=False, policy_test_frequency=0,
                                    mcts_test_frequency=0, goal_rush_opponent=False),
    )
    search = dataclasses.replace(load_search_config(os.path.join(REPO, SEARCH_CONFIG)),
                                 num_simulations=cuts["num_simulations"])
    log(f"training run: {TRAIN_CONFIG} + {SEARCH_CONFIG}, cut to "
        + ", ".join(f"{k} {v}" for k, v in cuts.items()))
    env = make_env("cuda")
    mgr = make_net(env, 256, torch.bfloat16)
    with tempfile.TemporaryDirectory() as run_dir:
        az = AlphaZero(env, mgr, cfg, search, run_dir=run_dir)
        initial = az.learner.init_state(torch.Generator(device="cuda").manual_seed(0))
        before = {k: v.clone() for k, v in initial.params.items()}
        torch.cuda.synchronize()
        hexconv_kernel.reset_launch_count()
        t0 = time.perf_counter()
        state = az.run(seed=0, initial_state=initial)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(hexconv_kernel.launch_count)
        records = az.journal.load()
        updates = cfg.running.training_steps * cfg.learning.num_samples
        if state.step != updates or records[-1]["updates"] != updates:
            raise AssertionError(f"{state.step} updates applied, expected {updates}")
        if not all(torch.isfinite(torch.tensor(r["loss/combined"])) for r in records):
            raise AssertionError("non-finite training losses")
        if all(torch.equal(before[k], state.params[k]) for k in before):
            raise AssertionError("the parameters did not change")
        if not (az.buffer.games_added > 0 and int(az.buffer.num_positions) > 0):
            raise AssertionError("the replay buffer did not grow")
        for name in (hexconv_kernel.KERNELS[torch.bfloat16],
                     hexconv_kernel.DW_KERNELS[torch.bfloat16]):
            if not counts[name]:
                raise AssertionError(f"the training run never launched {name}")
        for r in records:
            log(f"training step {r['step']}: {r['games']} games, buffer {r['buffer_games']} "
                f"games / {r['buffer_positions']} positions, loss {r['loss/combined']:.4f} "
                f"(policy {r['loss/policy']:.4f}, value {r['loss/value']:.4f}); "
                f"self-play {r['time/selfplay']:.2f} s, train {r['time/train']:.3f} s  [{card}]")
        log(f"training run: {seconds:.1f} s for {cfg.running.training_steps} steps, "
            f"{state.step} updates, {az.buffer.games_added} games; kernel launches {counts}")

        # The checkpoint of the last step restores equal through load().
        resumed = AlphaZero(env, mgr, cfg, search, run_dir=run_dir)
        restored, step = resumed.load("auto")
        if step != cfg.running.training_steps or restored.step != state.step:
            raise AssertionError(f"restored step {step} / {restored.step}")
        for k in state.params:
            if not (torch.equal(restored.params[k], state.params[k])
                    and torch.equal(restored.opt_state["mu"][k], state.opt_state["mu"][k])):
                raise AssertionError(f"restored {k} differs")
        if not torch.equal(resumed.buffer.states, az.buffer.states):
            raise AssertionError("restored buffer differs")
        log(f"checkpoint of step {step} restored equal (params, Adam moments, buffer)")

        # More learner updates on the filled buffer, timed, then one profiled.
        lcfg = cfg.learning
        times = []
        for _ in range(TIMED_UPDATES):
            batch = az._sample_obs(az._rng, lcfg.batch_size, late_heavy=lcfg.late_heavy,
                                   with_replacement=lcfg.with_replacement)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = az.learner.train_step(state, batch, az._host_rng)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        batch = az._sample_obs(az._rng, lcfg.batch_size, late_heavy=lcfg.late_heavy,
                               with_replacement=lcfg.with_replacement)
        secs, n_kernels, busy, ms = profile_update(az.learner, state, batch, az._host_rng)
        med = statistics.median(times)
        log(f"learner update 256f bf16 B={lcfg.batch_size}: median {med:.2f} ms of "
            f"{TIMED_UPDATES} (min {min(times):.2f}, max {max(times):.2f})  [{card}]")
        log(f"profile of one update: {secs * 1e3:.2f} ms under the profiler, {n_kernels} "
            f"device kernels, busy "
            f"{busy:.2f} ms (idle {100 * (1 - busy / (med)):.1f}% of a {med:.2f} ms update); "
            f"hex conv forward {ms['forward']:.2f} ms, dX {ms['dx']:.2f} ms, dW {ms['dw']:.2f} ms "
            f"({100 * sum(ms.values()) / busy:.1f}% of busy)  [{card}]")
    return counts


def mlp_manager(env):
    """``run.py`` preset 0's network: ``MLPNetwork(out_features=9)``."""
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.mlp import MLPNetwork

    return NetworkManager(MLPNetwork(env.observation_shape, env.num_actions).to(env.device),
                          env.observation_shape)


def zoo_nets(env, filters, dtype):
    """(name, manager, hex convs per evaluation) of the hex zoo at a width."""
    from nuzero_tpu_torch.networks.convnet import ConvNet
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.resnet import ResNet

    c, a = env.observation_shape[0], env.action_space_shape[0]
    return [
        ("ConvNet(num_layers=2)", NetworkManager(
            ConvNet(c, a, num_filters=filters, num_layers=2, dtype=dtype).to(env.device),
            env.observation_shape), 1 + 2 + 2 + 4),
        ("ResNet(num_blocks=4)", NetworkManager(
            ResNet(c, a, num_filters=filters, num_blocks=4, dtype=dtype).to(env.device),
            env.observation_shape), 1 + 2 * 4 + 2 + 4),
    ]


def random_positions(env, batch, gen, moves=6):
    """``batch`` states after ``moves`` uniform legal moves each."""
    from nuzero_tpu_torch.evaluation.agents import uniform_legal

    states = env.init(batch)
    for _ in range(moves):
        states = env.step(states, uniform_legal(env.legal_mask(states), gen))
    return states


def compare_cpu(label, mgr, cpu_mgr, variables, obs, rel, floor=0.1, f32_mgr=None):
    """The net on the card against the same weights on the CPU (plain path),
    each output within ``rel`` of its largest entry on the CPU, or of
    ``floor`` where that is larger.  With ``f32_mgr``, the f32 twin of a
    bf16 net on the CPU, each output is also held as phase 7 holds bf16:
    its distance from the CPU's, in norm, within twice bf16's own (the
    CPU's bf16 output against the f32 one).  That check has no floor."""
    import torch

    cpu_variables = {k: t.cpu() for k, t in variables.items()}
    with torch.no_grad():
        p, v, _ = mgr.apply(variables, obs)
        p_ref, v_ref, _ = cpu_mgr.apply(cpu_variables, obs.cpu())
        refs32 = (f32_mgr.apply(cpu_variables, obs.cpu())[:2] if f32_mgr is not None
                  else (None, None))
    torch.cuda.synchronize()
    for got, want, want32, name in zip((p, v), (p_ref, v_ref), refs32, ("logits", "value")):
        got = got.cpu().float()
        want = want.float()
        if not (got.shape == want.shape and torch.isfinite(got).all()):
            raise AssertionError(f"{label} {name}: bad shape or non-finite values")
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        scale = max(top, floor)
        if err > rel * scale:
            raise AssertionError(f"{label} {name}: card vs CPU err {err} > {rel * scale}")
        own = ""
        if want32 is not None:
            dist = ((got - want).norm() / want.norm()).item()
            bf16 = ((want - want32.float()).norm() / want32.float().norm()).item()
            if dist > 2 * bf16:
                raise AssertionError(f"{label} {name}: card vs CPU {dist:.3e} of its norm, "
                                     f"over twice bf16's own {bf16:.3e}")
            own = f"; {dist:.3e} in norm, {dist / bf16:.2f}x bf16's own {bf16:.3e}"
        log(f"{label} {name}: card vs CPU max abs err {err:.3e} (max|{name}| {top:.3e}, "
            f"{err / scale:.3e} of scale {scale:.3e}{own})")


def zoo_check(card):
    """Phase 9; returns the hex-conv launches of the timed evaluations."""
    import torch

    from nuzero_tpu_torch.envs.tictactoe import TicTacToe
    from nuzero_tpu_torch.ops.cuda import hexconv_kernel

    gen = torch.Generator(device="cuda").manual_seed(3)
    launches = {}
    for filters, dtype_name, batch in LEGS:
        dtype = getattr(torch, dtype_name)
        env, cpu_env = make_env("cuda"), make_env("cpu")
        obs = env.observe(random_positions(env, batch, gen))
        for (name, mgr, convs), (_, cpu_mgr, _) in zip(zoo_nets(env, filters, dtype),
                                                      zoo_nets(cpu_env, filters, dtype)):
            label = f"{name} {filters}f {dtype_name}"
            variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))
            compare_cpu(label, mgr, cpu_mgr, variables, obs[:8],
                        1e-4 if dtype == torch.float32 else 2e-2)
            with torch.no_grad():
                torch.cuda.synchronize()
                hexconv_kernel.reset_launch_count()
                mgr.apply(variables, obs)
                torch.cuda.synchronize()
                counts = dict(hexconv_kernel.launch_count)
                want = {k: 0 for k in counts}
                want[hexconv_kernel.KERNELS[dtype]] = convs
                if counts != want:
                    raise AssertionError(f"{label}: launches {counts}, expected {want}")
                ms = time_ms(lambda: mgr.apply(variables, obs), 20)
            launches[label] = convs
            log(f"{label} B={batch}: {convs} hex-conv launches per evaluation, "
                f"{ms:.4f} ms per evaluation  [{card}]")
    env, cpu_env = TicTacToe("cuda"), TicTacToe("cpu")
    mgr, cpu_mgr = mlp_manager(env), mlp_manager(cpu_env)
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))
    obs = env.observe(random_positions(env, MLP_BATCH, gen, moves=4))
    compare_cpu("MLPNetwork TTT f32", mgr, cpu_mgr, variables, obs[:8], 1e-4)
    with torch.no_grad():
        ms = time_ms(lambda: mgr.apply(variables, obs), 20)
    log(f"MLPNetwork TTT f32 B={MLP_BATCH}: no hex conv, {ms:.4f} ms per evaluation  [{card}]")
    return launches


def ttt_selfplay_leg(batch, card):
    """Phase 10 at one batch: the eager moves, then the same moves as
    replays of the captured move from the same state and generator state."""
    import torch

    from nuzero_tpu_torch.config.schemas import load_search_config
    from nuzero_tpu_torch.envs.tictactoe import TicTacToe
    from nuzero_tpu_torch.training.selfplay import (
        capture_selfplay_step, init_selfplay, make_selfplay_step, move_tensors, play_in_place,
    )
    from nuzero_tpu_torch.utils.packing import make_packer

    env = TicTacToe("cuda")
    mgr = mlp_manager(env)
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))
    params = load_search_config(os.path.join(REPO, TTT_SEARCH))

    def apply(v, obs):
        p, val, _ = mgr.apply(v, obs)
        return p, val

    def fresh_state():
        return init_selfplay(env, batch, torch.Generator(device="cuda").manual_seed(1),
                             search_params=params)

    def snapshot(sp, finished, stats):
        return {k: v.clone() for k, v in move_tensors(sp, finished, stats).items()}

    step = make_selfplay_step(env, apply, params, training=True)
    _, unpack, dim = make_packer(env.init(1))
    bi = torch.arange(batch, device="cuda")
    label = f"TTT MLP B={batch} {params.num_simulations} sims"
    sp = fresh_state()
    eager, seconds = [], []
    for move in range(MOVES):
        row = sp.move_count.long()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finished, stats = play_in_place(step, variables, sp)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        recorded = unpack(sp.state_buf[bi, row, :dim])
        check_policy(sp.policy_buf[bi, row], env.legal_mask(recorded))
        eager.append(snapshot(sp, finished, stats))
        log(f"{label} eager move {move}: {seconds[-1]:.4f} s, "
            f"finished {int(stats['finished'])}")
    gsp = fresh_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = capture_selfplay_step(step, variables, gsp)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replayed = []
    for move in range(MOVES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            finished, stats = graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        replayed.append(time.perf_counter() - t0)
        got = snapshot(gsp, finished, stats)
        differ = [k for k in eager[move] if not torch.equal(got[k], eager[move][k])]
        if differ:
            raise AssertionError(f"{label}: replay {move} differs from eager move {move} "
                                 f"in {differ}")
        log(f"{label} replay {move}: {replayed[-1]:.4f} s, equal to eager move {move} in "
            f"all {len(got)} tensors, no host sync inside")
    graph.check_overflow()
    steady, steady_g = statistics.median(seconds[1:]), statistics.median(replayed[1:])
    sims = params.num_simulations
    log(f"{label}: capture {capture_s:.2f} s; replayed {steady_g:.4f} s/move, "
        f"{batch * sims / steady_g:.1f} env-steps/s, against eager {steady:.4f} s/move, "
        f"{batch * sims / steady:.1f} env-steps/s (medians of moves 2-{MOVES})  [{card}]")


class CheckedAgent:
    """An agent whose actions are checked against the legal mask in every
    live game where its seat is on move (the arena is eager, so reading the
    host here is allowed); counts what it checked."""

    def __init__(self, agent, seat):
        self.agent, self.seat = agent, seat
        self.name = agent.name
        self.variables = getattr(agent, "variables", None)
        self.checked = self.illegal = 0

    def policy(self, env):
        import torch

        inner = self.agent.policy(env)

        def choose(variables, states, lengths, rng):
            action = inner(variables, states, lengths, rng)
            legal = env.legal_mask(states)
            bi = torch.arange(action.shape[0], device=action.device)
            mine = (env.current_player(states) == self.seat) & ~env.terminal(states)
            self.checked += int(mine.sum())
            self.illegal += int((mine & ~legal[bi, action.long()]).sum())
            return action

        return choose


def arena_check(card):
    """Phase 11; returns the hex-conv launches of the PolicyAgent batches."""
    import torch

    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.envs.scs.scenario import load_scenario
    from nuzero_tpu_torch.evaluation.agents import GoalRushAgent, MctsAgent, PolicyAgent
    from nuzero_tpu_torch.evaluation.manager import TestManager
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet
    from nuzero_tpu_torch.ops.cuda import hexconv_kernel
    from nuzero_tpu_torch.search.mcts import SearchParams

    class CountingManager(NetworkManager):
        evaluations = 0

        def apply(self, *args, **kwargs):
            CountingManager.evaluations += 1
            return super().apply(*args, **kwargs)

    def setup(scenario):
        """(env, test manager, PolicyAgent, its weights) on ``scenario``."""
        path = os.path.join(REPO, "configs", "scenarios", scenario)
        env = SCSGame(load_scenario(path, seed=42), device="cuda")
        net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0],
                           num_filters=256, num_blocks=2, recall=True, hex=True,
                           dtype=torch.bfloat16).to("cuda")
        mgr = CountingManager(net, env.observation_shape)
        variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))
        return env, TestManager(env), PolicyAgent(mgr, variables, 2), (mgr, variables)

    rush = GoalRushAgent()
    env, tm, policy, (mgr, variables) = setup(ARENA_SCENARIO)
    mcts = MctsAgent(mgr, variables, SearchParams(num_simulations=ARENA_CUTS["num_simulations"]))
    both = setup(ARENA_BOTH["scenario"])
    kernel = hexconv_kernel.KERNELS[torch.bfloat16]
    launches = 0
    # (name, scenario, test manager, agent, games, max_moves, seats where the
    # agent must decide): on solo_scout_5 player 0 owns no unit, so only
    # seat 1's agent evaluates the network; on open_field_5 both seats do.
    legs = (("policy", ARENA_SCENARIO, tm, policy, ARENA_GAMES, None, (1,)),
            ("mcts", ARENA_SCENARIO, tm, mcts, ARENA_CUTS["games"], ARENA_CUTS["max_moves"],
             (1,)),
            ("policy", ARENA_BOTH["scenario"], both[1], both[2], ARENA_BOTH["games"],
             ARENA_BOTH["max_moves"], (0, 1)))
    for name, scenario, tm, agent, games, max_moves, deciding in legs:
        for seat in (0, 1):
            p0, p1 = CheckedAgent(agent if seat == 0 else rush, 0), CheckedAgent(
                rush if seat == 0 else agent, 1)
            CountingManager.evaluations = 0
            torch.cuda.synchronize()
            hexconv_kernel.reset_launch_count()
            t0 = time.perf_counter()
            stats = tm.run_test_batch(games, p0, p1, tm.generator(seat), show_results=False,
                                      max_moves=max_moves)
            seconds = time.perf_counter() - t0
            count = hexconv_kernel.launch_count[kernel]
            per_move = tm.last_arena.seconds_per_move
            if p0.illegal or p1.illegal:
                raise AssertionError(f"{name} seat {seat}: {p0.illegal + p1.illegal} illegal "
                                     f"actions played")
            if stats.p0_wins + stats.p1_wins + stats.draws != games:
                raise AssertionError(f"{name} seat {seat}: outcomes do not sum to {games}")
            evals = CountingManager.evaluations
            if seat in deciding and not evals:
                raise AssertionError(f"{name} seat {seat} on {scenario}: the agent never "
                                     f"evaluated the network")
            if name == "policy":
                if count != CONVS_PER_EVAL * evals:
                    raise AssertionError(f"{count} hex-conv launches for {evals} PolicyAgent "
                                         f"evaluations, expected {CONVS_PER_EVAL} each")
                launches += count
            log(f"arena {name} (seat {seat}) vs goal_rush on {scenario}, {games} games"
                + (f", max_moves {max_moves}" if max_moves else "")
                + f": P1 {stats.p0_wins} / P2 {stats.p1_wins} / draws {stats.draws} "
                f"(truncated {stats.truncated}), avg length {stats.avg_length:.1f}; "
                f"{len(per_move)} arena moves, {p0.checked + p1.checked} actions checked "
                f"legal; {evals} network evaluations, "
                f"{count} hex-conv launches; {seconds:.2f} s, "
                f"{statistics.median(per_move):.4f} s per arena move (median)  [{card}]")
    return launches


def ttt_training_run(card):
    """Phase 12: ``ttt_default.yaml`` through ``AlphaZero.run()``."""
    import torch

    from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config
    from nuzero_tpu_torch.envs.tictactoe import TicTacToe
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    cfg = load_training_config(os.path.join(REPO, TTT_CONFIG))
    cfg = dataclasses.replace(
        cfg, running=dataclasses.replace(cfg.running, training_steps=TTT_STEPS))
    search = load_search_config(os.path.join(REPO, TTT_SEARCH))
    t = cfg.testing
    log(f"TTT training run: {TTT_CONFIG} + {TTT_SEARCH}, MLP, cut to {TTT_STEPS} steps; "
        f"tests early {t.early_testing}, policy every "
        f"{t.policy_test_frequency}, MCTS every {t.mcts_test_frequency}, asynchronous "
        f"{t.asynchronous_testing}")
    env = TicTacToe("cuda")
    mgr = mlp_manager(env)
    with tempfile.TemporaryDirectory() as run_dir:
        az = AlphaZero(env, mgr, cfg, search, run_dir=run_dir)
        initial = az.learner.init_state(torch.Generator(device="cuda").manual_seed(0))
        before = {k: v.clone() for k, v in initial.params.items()}
        t0 = time.perf_counter()
        state = az.run(seed=0, initial_state=initial)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        records = az.journal.load()
        steps = [r for r in records if "games" in r]
        tests = {r["step"]: r for r in records if r.get("async_test")}
        if [r["step"] for r in steps] != list(range(1, TTT_STEPS + 1)):
            raise AssertionError("missing training steps in the journal")
        if not all(torch.isfinite(torch.tensor(r["loss/combined"])) for r in steps):
            raise AssertionError("non-finite training losses")
        if all(torch.equal(before[k], state.params[k]) for k in before):
            raise AssertionError("the parameters did not change")
        if len(az._graphs) != 2:
            raise AssertionError(f"{len(az._graphs)} self-play graphs captured, expected 2")
        want = {0: ("policy", "mcts"), 25: ("policy",), 50: ("policy", "mcts")}
        for step, tags in want.items():
            keys = {f"{m}/{tag}_as_p{s}" for tag in tags for m in ("wr", "nonloss")
                    for s in (0, 1)}
            if step not in tests or not keys <= set(tests[step]):
                raise AssertionError(f"in-loop test keys missing at step {step}")
            log(f"TTT in-loop tests at step {step} (async, harvested): " + ", ".join(
                f"{k} {tests[step][k]:.4f}" for k in sorted(keys)))
        if set(tests) != set(want):
            raise AssertionError(f"async test records at steps {sorted(tests)}")
        for r in steps:
            log(f"TTT step {r['step']}: {r['games']} games, loss {r['loss/combined']:.4f}; "
                f"self-play {r['time/selfplay']:.3f} s, train {r['time/train']:.3f} s, "
                f"eval {r['time/eval']:.3f} s  [{card}]")
        log(f"TTT training run: {seconds:.1f} s for {TTT_STEPS} steps, {state.step} updates, "
            f"{az.buffer.games_added} games  [{card}]")
        resumed = AlphaZero(env, mgr, cfg, search, run_dir=run_dir)
        restored, step = resumed.load("auto")
        if step != TTT_STEPS or restored.step != state.step:
            raise AssertionError(f"restored step {step} / {restored.step}")
        for k in state.params:
            if not (torch.equal(restored.params[k], state.params[k])
                    and torch.equal(restored.opt_state["trace"][k], state.opt_state["trace"][k])):
                raise AssertionError(f"restored {k} differs")
        log(f"TTT checkpoint of step {step} restored equal (params, SGD trace)")


TRANSFER_RUNS = ("scs_solo_r3", "scs_solo_prog_r3", "scs_solo_rvp_r5")
ITERATION_RUNS = ("scs_solo_r3", "scs_solo_prog_r3")
SIZE_RUN = "scs_solo_rvp_r5"
SWEEP_GAMES = 64
# Points of the committed iteration curves (made on a TPU) that the JAX
# package on the CPU does not reproduce in f32; the card is held to the
# port's CPU result there, which equals the JAX package's on the CPU
# (tests/test_torch_transfer.py).  At 10 iterations the scs_solo_r3 game
# turns on a placement whose top-2 logit margin is 1.37e-3.
CPU_DIFFERS_FROM_COMMITTED = {("scs_solo_r3", 10)}
# The randomize_vp self-play leg: 64f f32, B=512, 30 simulations on
# solo_scout_5.yml; WARMUP_MOVES eager moves first, so that games end and
# are recycled within the checked moves.
RVP_LEG = {"batch": 512, "warmup_moves": 10}


def committed_json(run, name):
    with open(os.path.join(REPO, "runs", run, "plots", name)) as f:
        return json.load(f)


def legal_argmax_margins(logits, legal):
    """(argmax over the legal actions, top-1 minus top-2 legal logit) per row."""
    import torch

    masked = torch.where(legal, logits, torch.full_like(logits, float("-inf")))
    top = masked.topk(2, dim=-1).values
    return masked.argmax(-1), top[:, 0] - top[:, 1]


def deciding_margin(env, agent, variables, iterations):
    """Replay one game of ``agent`` (seat 1) on ``env`` at ``iterations`` and
    return the smallest top-2 legal logit margin over its decisions, with
    the move where it fell (every game of the iteration sweep is this
    game: the policy is an argmax and seat 0 never moves)."""
    import torch

    agent.set_recurrent_iterations(iterations)
    choose = agent.policy(env)
    state = env.init(1)
    worst = (float("inf"), -1)
    for move in range(env.max_game_length):
        if bool(env.terminal(state)[0]):
            break
        action = torch.zeros(1, dtype=torch.int32, device=env.device)
        if int(env.current_player(state)[0]) == 1:
            with torch.no_grad():
                logits, _, _ = agent.manager.apply(variables, env.observe(state),
                                                   iters_to_do=iterations)
            _, margin = legal_argmax_margins(logits, env.legal_mask(state))
            worst = min(worst, (float(margin[0]), move))
            action = choose(variables, state, None, None)
        state = env.step(state, action)
    return worst


def transfer_positions(sizes, gen):
    """{size: (observations [8, C, size, size], legal masks)} of reachable
    states on the size sweep's maps (CPU): game b of 8, each on its own
    drawn layout, after 2*b uniform legal moves."""
    import torch

    from nuzero_tpu_torch.evaluation import sweeps
    from nuzero_tpu_torch.evaluation.agents import uniform_legal

    out = {}
    for size in sizes:
        env = sweeps.size_env(size, device="cpu")
        state = env.init(8, generator=gen)
        obs, legal = [], []
        for t in range(16):
            if t % 2 == 0:
                obs.append(env.observe(state)[t // 2])
                legal.append(env.legal_mask(state)[t // 2])
            state = env.step(state, uniform_legal(env.legal_mask(state), gen))
        out[size] = torch.stack(obs), torch.stack(legal)
    return out


class CountingApply:
    """Wraps ``NetworkManager.apply`` for the phase: records each call's
    iteration count (the hex-conv launches an evaluation must make)."""

    def __init__(self):
        from nuzero_tpu_torch.networks.manager import NetworkManager

        self.cls, self.inner, self.iters = NetworkManager, NetworkManager.apply, []

    def __enter__(self):
        inner, iters = self.inner, self.iters

        def apply(mgr, variables, obs, iters_to_do=2, interim_thought=None):
            iters.append(int(iters_to_do))
            return inner(mgr, variables, obs, iters_to_do, interim_thought)

        self.cls.apply = apply
        return self

    def __exit__(self, *exc):
        self.cls.apply = self.inner


class CheckedSteps:
    """Wraps ``SCSGame.step`` for the phase: every action of a live game must
    be legal (the arena is eager, so reading the host here is allowed)."""

    def __init__(self):
        from nuzero_tpu_torch.envs.scs.game import SCSGame

        self.cls, self.inner, self.checked = SCSGame, SCSGame.step, 0

    def __enter__(self):
        import torch

        inner = self.inner

        def step(env, state, action):
            live = ~env.terminal(state)
            legal = env.legal_mask(state)
            bi = torch.arange(action.shape[0], device=action.device)
            if bool((live & ~legal[bi, action.long()]).any()):
                raise AssertionError("an arena game played an illegal action")
            self.checked += int(live.sum())
            return inner(env, state, action)

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.inner


def transfer_check(card):
    """Phase 13: the committed runs on the card; returns the f32 forward
    kernel's launches over the phase's sweeps and each iteration sweep's
    record by run."""
    import torch

    from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta
    from nuzero_tpu_torch.evaluation import sweeps
    from nuzero_tpu_torch.evaluation.manager import TestManager
    from nuzero_tpu_torch.ops.cuda import hexconv_kernel
    from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint
    from nuzero_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    kernel = hexconv_kernel.KERNELS[torch.float32]

    # --- 13.1 Network Check 2 on the card: the kernel against the plain
    # version on the CPU, and the launches of each evaluation
    positions = transfer_positions(SWEEP_SIZES, torch.Generator().manual_seed(0))
    worst = {k: 0.0 for k in SWEEP_ITERS}
    agents = {}
    for run in TRANSFER_RUNS:
        meta = load_run_meta(os.path.join(sweeps.GAME_DIR, run))
        env, mgr = build_from_meta(meta, REPO, device="cuda")
        _, cpu_mgr = build_from_meta(meta, REPO, device="cpu")
        agent = TestManager(env).create_agent_from_config(
            sweeps.policy_test(run, "iterations", 2, 2, 1, 1)["Agents"]["p2_agent"], mgr,
            game_dir=sweeps.GAME_DIR)
        agents[run] = agent
        cpu_vars = restore_checkpoint(os.path.join(sweeps.GAME_DIR, run, "checkpoints"),
                                      device="cpu")[0]["params"]
        if sorted(agent.variables) != sorted(cpu_vars) or not all(
                t.is_cuda for t in agent.variables.values()):
            raise AssertionError(f"{run}: the agent's weights are not the run's on the card")
        for size, (obs, legal) in positions.items():
            for iters in SWEEP_ITERS:
                label = f"{run} {size}x{size} {iters} iterations"
                with torch.no_grad():
                    torch.cuda.synchronize()
                    hexconv_kernel.reset_launch_count()
                    p, v, _ = mgr.apply(agent.variables, obs.cuda(), iters_to_do=iters)
                    torch.cuda.synchronize()
                    launches = hexconv_kernel.launch_count[kernel]
                    p_ref, v_ref, _ = cpu_mgr.apply(cpu_vars, obs, iters_to_do=iters)
                if launches != 7 + 5 * iters:
                    raise AssertionError(f"{label}: {launches} hex-conv launches, expected "
                                         f"{7 + 5 * iters}")
                errs = []
                for got, want, name in ((p, p_ref, "logits"), (v, v_ref, "value")):
                    got = got.cpu()
                    if not (got.shape == want.shape and torch.isfinite(got).all()):
                        raise AssertionError(f"{label} {name}: bad shape or non-finite values")
                    err = (got - want).abs().max().item()
                    rel = err / max(want.abs().max().item(), 1e-30)
                    if rel > 1e-4:
                        raise AssertionError(f"{label} {name}: card vs CPU {rel:.3e} of "
                                             f"max|.| > 1e-4")
                    errs.append(err)
                    worst[iters] = max(worst[iters], rel)
                # The legal argmax agrees wherever the CPU's top-2 margin
                # exceeds twice the logits' error (a flip inside the stated
                # tolerance would be no fault; none has been seen).
                arg, _ = legal_argmax_margins(p.cpu(), legal)
                arg_ref, margin = legal_argmax_margins(p_ref, legal)
                flips = (arg != arg_ref) & (margin > 2 * errs[0])
                if bool(flips.any()):
                    raise AssertionError(f"{label}: legal argmax differs from the CPU's at "
                                         f"margins {margin[flips].tolist()}")
                if bool((arg != arg_ref).any()):
                    log(f"{label}: legal argmax differs from the CPU's at margins "
                        f"{margin[arg != arg_ref].tolist()}, inside twice the error")
        log(f"network check 2 {run}: the card (hexconv_f32_kernel) against the CPU (plain) "
            f"on 8 positions at {', '.join(f'{s}x{s}' for s in SWEEP_SIZES)} and "
            f"{SWEEP_ITERS} iterations: within 1e-4 of max|.|, legal argmax equal, hex-conv "
            f"launches per evaluation {'/'.join(str(7 + 5 * k) for k in SWEEP_ITERS)}")
    log("network check 2: worst card-vs-CPU error relative to max|.|, by iterations: "
        + ", ".join(f"{k}: {v:.3e}" for k, v in worst.items()))

    # --- 13.2 / 13.3 the sweeps, through the port's TestManager
    launches = 0

    def sweep(fn, run, label, **kwargs):
        nonlocal launches
        torch.cuda.synchronize()
        hexconv_kernel.reset_launch_count()
        t0 = time.perf_counter()
        moves = profiling.snapshot().get("nuzero.arena.move", {"calls": 0, "total_s": 0.0})
        with CountingApply() as calls, CheckedSteps() as steps, \
                tempfile.TemporaryDirectory() as out:
            record = fn(run, out_dir=out, games=SWEEP_GAMES, device="cuda", **kwargs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(os.path.join(out, os.listdir(out)[0])) as f:
                if json.load(f) != record:
                    raise AssertionError(f"{label} {run}: the written JSON is not the record")
        count = hexconv_kernel.launch_count[kernel]
        want = sum(7 + 5 * k for k in calls.iters)
        if count != want or not calls.iters:
            raise AssertionError(f"{label} {run}: {count} hex-conv launches for "
                                 f"{len(calls.iters)} evaluations, expected {want}")
        launches += count
        after = profiling.snapshot()["nuzero.arena.move"]
        moved, secs = after["calls"] - moves["calls"], after["total_s"] - moves["total_s"]
        log(f"{label} {run}: {len(calls.iters)} PolicyAgent evaluations, {count} "
            f"hex-conv launches, {steps.checked} actions checked legal, {moved} arena moves, "
            f"{secs / moved:.4f} s per arena move (mean), {wall:.2f} s  [{card}]")
        return record

    def outcomes(point):
        counts = [point[k] * SWEEP_GAMES for k in ("p0_wr", "p1_wr", "draw_rate")]
        if any(abs(c - round(c)) > 1e-9 for c in counts) or round(sum(counts)) != SWEEP_GAMES:
            raise AssertionError(f"wins + losses + draws != {SWEEP_GAMES} games: {point}")
        return [round(c) for c in counts]

    scenario = sweeps.load_scenario(sweeps.SCENARIO, seed=42)
    curves = {}
    for run in ITERATION_RUNS:
        record = sweep(sweeps.iteration_sweep, run, "iteration sweep")
        curves[run] = record
        # The port's plain path on the CPU, 2 games a point: every game of a
        # point is the same game (an argmax policy, seat 0 never moves).
        cpu = sweeps.iteration_sweep(run, games=2, device="cpu")
        committed = committed_json(run, "iteration_sweep.json")
        if record["checkpoint_step"] != committed["checkpoint_step"] or not (
                len(record["results"]) == len(cpu["results"]) == len(committed["results"])):
            raise AssertionError(f"{run}: checkpoint step or points differ from the committed")
        env = sweeps.SCSGame(scenario, device="cuda")
        flipped = []
        for point, on_cpu, want in zip(record["results"], cpu["results"],
                                       committed["results"]):
            outcomes(point)
            iters = point["iterations"]
            ref = on_cpu if (run, iters) in CPU_DIFFERS_FROM_COMMITTED else want
            margin, move = deciding_margin(env, agents[run], agents[run].variables, iters)
            log(f"iteration sweep {run} at {iters} iterations: P2 {point['p1_wr']:.4f} "
                f"(CPU {on_cpu['p1_wr']:.4f}, committed {want['p1_wr']:.4f}"
                + (", held to the CPU" if ref is on_cpu else "") + f"), draws "
                f"{point['draw_rate']:.4f}; smallest legal top-2 logit margin {margin:.4e} "
                f"(move {move})  [{card}]")
            if point["p1_wr"] != on_cpu["p1_wr"] or any(point[k] != ref[k] for k in ref):
                flipped.append(iters)
        if flipped:
            raise AssertionError(f"{run}: the iteration curve differs at {flipped} (see the "
                                 f"margins above)")

    record = sweep(sweeps.size_sweep, SIZE_RUN, "size sweep")
    committed = committed_json(SIZE_RUN, "size_sweep.json")
    for key in ("checkpoint_step", "train_size", "turn_rule"):
        if record[key] != committed[key]:
            raise AssertionError(f"size sweep: {key} {record[key]} != {committed[key]}")
    if record["curves"].keys() != committed["curves"].keys():
        raise AssertionError(f"size sweep curves {list(record['curves'])}")
    diffs, variances = [], []
    n = SWEEP_GAMES
    for label, points in record["curves"].items():
        for point, want in zip(points, committed["curves"][label]):
            outcomes(point)
            got, ref = point["p1_wr"], want["p1_wr"]
            pooled = (got + ref) / 2
            sd = math.sqrt(pooled * (1 - pooled) * (2 / n))
            bound = 3 * sd + 1 / n
            log(f"size sweep {SIZE_RUN} {label} at {point['board_size']}x{point['board_size']}:"
                f" P2 {got:.4f} (committed {ref:.4f}, |diff| {abs(got - ref):.4f} <= "
                f"{bound:.4f}?), draws {point['draw_rate']:.4f}  [{card}]")
            if point["board_size"] != want["board_size"] or abs(got - ref) > bound:
                raise AssertionError(f"size sweep {label} at {point['board_size']}: P2 {got} "
                                     f"against the committed {ref}, bound {bound:.4f}")
            diffs.append(got - ref)
            variances.append(pooled * (1 - pooled) * (2 / n))
    if len(diffs) != 18:
        raise AssertionError(f"size sweep: {len(diffs)} points, expected 18")
    mean = sum(diffs) / len(diffs)
    se = math.sqrt(sum(variances)) / len(diffs)
    log(f"size sweep {SIZE_RUN}: mean P2 rate over the 18 points "
        f"{sum(p['p1_wr'] for c in record['curves'].values() for p in c) / 18:.4f} against "
        f"the committed "
        f"{sum(p['p1_wr'] for c in committed['curves'].values() for p in c) / 18:.4f} "
        f"(mean diff {mean:+.4f}, 3 standard errors {3 * se:.4f})")
    if abs(mean) > 3 * se:
        raise AssertionError(f"size sweep: mean difference {mean:+.4f} beyond 3 SE {3 * se:.4f}")

    # --- 13.4 the randomize_vp self-play leg, eager then graphed
    rvp_selfplay_leg(card)
    log(f"phase 13: {launches} hexconv_f32_kernel launches over the sweeps, wall time "
        f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches, curves


def rvp_selfplay_leg(card):
    """Self-play with per-game victory points (64f f32, B=512, 30
    simulations, ``solo_scout_5.yml``): after the warm-up moves, four eager
    moves, then the captured move and four replays from the same state
    and generator state under sync debug mode "error", each equal bit for
    bit to the eager move; recycled games must restart on layouts other
    than the ones they had."""
    import torch

    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.envs.scs.scenario import load_scenario
    from nuzero_tpu_torch.search.mcts import SearchParams
    from nuzero_tpu_torch.training.selfplay import (
        capture_selfplay_step, copy_selfplay, init_selfplay, make_selfplay_step, move_tensors,
        play_in_place,
    )

    path = os.path.join(REPO, "configs", "scenarios", "solo_scout_5.yml")
    env = SCSGame(load_scenario(path, seed=42), randomize_vp=True, device="cuda")
    mgr = make_net(env, 64, torch.float32)
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))

    def apply(v, obs):
        p, val, _ = mgr.apply(v, obs, iters_to_do=2)
        return p, val

    params = SearchParams(num_simulations=SIMS)
    step = make_selfplay_step(env, apply, params, training=True)
    batch = RVP_LEG["batch"]
    sp = init_selfplay(env, batch, torch.Generator(device="cuda").manual_seed(1),
                       search_params=params)
    for _ in range(RVP_LEG["warmup_moves"]):
        play_in_place(step, variables, sp)
    gsp = copy_selfplay(sp)
    half = env.vp_half
    eager, recycled, changed, seconds = [], 0, 0, []
    for move in range(MOVES):
        before = sp.games.vp.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finished, stats = play_in_place(step, variables, sp)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        eager.append({k: v.clone() for k, v in move_tensors(sp, finished, stats).items()})
        vp = sp.games.vp
        if not bool(((vp.sum((2, 3)) == 1).all() & ~(vp & ~half).any())):
            raise AssertionError("a layout is not one cell per player in the owner's half")
        fresh = sp.move_count == 0
        recycled += int(fresh.sum())
        changed += int(((vp != before).flatten(1).any(1) & fresh).sum())
        if bool(((vp != before).flatten(1).any(1) & ~fresh).any()):
            raise AssertionError("a live game's layout changed")
    if not recycled or not changed:
        raise AssertionError(f"{recycled} games recycled, {changed} on another layout")
    t0 = time.perf_counter()
    graph = capture_selfplay_step(step, variables, gsp)
    capture_s = time.perf_counter() - t0
    replayed = []
    for move in range(MOVES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            finished, stats = graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        replayed.append(time.perf_counter() - t0)
        got = move_tensors(gsp, finished, stats)
        differ = [k for k in eager[move] if not torch.equal(got[k], eager[move][k])]
        if differ:
            raise AssertionError(f"randomize_vp replay {move} differs from eager move {move} "
                                 f"in {differ}")
    graph.check_overflow()
    log(f"randomize_vp self-play 64f float32 B={batch} on solo_scout_5.yml (after "
        f"{RVP_LEG['warmup_moves']} warm-up moves): {recycled} games recycled in {MOVES} eager "
        f"moves, {changed} of them on another layout; {MOVES} replays equal bit for bit, no "
        f"host sync inside; eager {statistics.median(seconds[1:]):.4f} s per move, replayed "
        f"{statistics.median(replayed[1:]):.4f} s, capture {capture_s:.2f} s  [{card}]")


# Phase 7's repeat check: the card gradient test's update
# (tests/test_torch_cuda.py::test_recurrent_net_grad_matches_cpu) and the f32
# dW kernel alone at each of that net's shapes, repeated on the same inputs.
REPEATS = 200
# Phase 14: run.py training preset 3's recipe (the recipe of the committed
# scs_solo_rvp_r5): scs_small.yaml and scs_search.yaml, solo_scout_5.yml with
# per-game victory points, the solo state set and RecurrentNet 64f f32
# (2 blocks, recall, hex).  The files say 500 steps, plots every 25 steps, a
# checkpoint every 50, no weight stats, 300 simulations, an early fill of 128
# games and 32 games a step; everything not cut here is as in the files.
PRESET3_TRAIN = "configs/training/scs_small.yaml"
PRESET3_SEARCH = "configs/search/scs_search.yaml"
PRESET3_CUTS = {"training_steps": 4, "plot_frequency": 2, "save_frequency": 2,
                "plot_weights": True, "num_simulations": 30, "early_fill_per_type": 16,
                "num_games_per_type_per_step": 32}
# (e) the asynchronous mode, (f) two game types, (g) NUZERO_MFU and
# NUZERO_TRACE_DIR, each on top of PRESET3_CUTS; (g) is cut further so that
# the trace of its step stays small.
PRESET3_ASYNC = {"running_mode": "asynchronous", "update_delay": 2.0, "training_steps": 3}
PRESET3_TYPES = {"train_iterations": (4, 6), "pred_iterations": (4, 6), "training_steps": 2}
PRESET3_TRACE = {"training_steps": 2, "num_actors": 16, "early_fill_per_type": 4,
                 "num_games_per_type_per_step": 4, "num_simulations": 4, "num_samples": 2}


def repeat_check(card):
    """The f32 update of the card gradient test (16f, 3 iterations, B=8 on
    5x5), ``REPEATS`` times on the same inputs, each gradient bit-equal to
    the first and every tensor within 1e-4 of its largest of the CPU's;
    then the f32 dW kernel alone ``REPEATS`` times at each hex-conv shape of
    that net, bit-equal to the first.  The f32 forward and dW kernels sum in
    a fixed order (``csrc/hexconv_dw.cu``), so any difference is a race."""
    import numpy as np
    import torch

    from nuzero_tpu_torch.networks.blocks import HexConv
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet
    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import hex_conv_dw_cuda

    rng = np.random.default_rng(19)
    obs = torch.from_numpy((rng.random((8, 86, 5, 5)) < 0.2).astype(np.float32))
    cpu = RecurrentNet(86, 21, num_filters=16, num_blocks=2)
    net = RecurrentNet(86, 21, num_filters=16, num_blocks=2).cuda()
    net.load_state_dict(cpu.state_dict())

    def grads(module, x):
        params = dict(module.named_parameters())
        loss = sum((o.float() ** 2).sum() for o in module(x, 3)[0])
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    want = grads(cpu, obs)
    x = obs.cuda()
    first = None
    t0 = time.perf_counter()
    for i in range(REPEATS):
        got = grads(net, x)
        if first is None:
            first = {k: g.clone() for k, g in got.items()}
            ratios = {k: (g.cpu() - want[k]).abs().max().item() / want[k].abs().max().item()
                      for k, g in got.items()}
            over = {k: r for k, r in ratios.items() if r > 1e-4}
            if over:
                raise AssertionError("card gradients over 1e-4 of their largest: " + ", ".join(
                    f"{k} {r:.2e}" for k, r in sorted(over.items(), key=lambda kv: -kv[1])))
            continue
        differ = [k for k in got if not torch.equal(got[k], first[k])]
        if differ:
            raise AssertionError(f"repeat {i} of the update differs from the first in {differ}")
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    shapes = sorted({tuple(m.weight.shape[1:]) for m in net.modules() if isinstance(m, HexConv)})
    gen = torch.Generator(device="cuda").manual_seed(7)
    for cin, cout in shapes:
        xs = torch.randn((8, 5, 5, cin), generator=gen, device="cuda")
        dy = torch.randn((8, 5, 5, cout), generator=gen, device="cuda")
        ref = hex_conv_dw_cuda(xs, dy).clone()
        for i in range(REPEATS - 1):
            if not torch.equal(hex_conv_dw_cuda(xs, dy), ref):
                raise AssertionError(f"f32 dW {cin}->{cout}: repeat {i + 1} differs from the "
                                     "first")
    log(f"repeat check (phase 7): the 16f f32 update (B=8, 3 iterations) {REPEATS} times in "
        f"{update_s:.2f} s, every gradient bit-equal to the first, worst "
        f"{max(ratios.values()):.2e} of its tensor's largest against the CPU; the f32 dW "
        f"kernel {REPEATS} times at each of {len(shapes)} shapes "
        f"({', '.join(f'{a}->{b}' for a, b in shapes)}), bit-equal  [{card}]")


def preset3_config(**cuts):
    """(TrainingConfig, SearchParams) of the recipe, cut by PRESET3_CUTS and
    then by ``cuts`` (names of RunningConfig, PlottingConfig, SavingConfig,
    LearningConfig and RecurrentOptions fields, and num_simulations)."""
    from nuzero_tpu_torch.config.schemas import load_search_config, load_training_config

    cuts = {**PRESET3_CUTS, **cuts}
    cfg = load_training_config(os.path.join(REPO, PRESET3_TRAIN))
    sections = {}
    for name in ("running", "plotting", "saving", "learning", "recurrent"):
        section = getattr(cfg, name)
        fields = {f.name for f in dataclasses.fields(section)}
        sections[name] = dataclasses.replace(
            section, **{k: v for k, v in cuts.items() if k in fields})
    search = dataclasses.replace(load_search_config(os.path.join(REPO, PRESET3_SEARCH)),
                                 num_simulations=cuts["num_simulations"])
    return dataclasses.replace(cfg, **sections), search


def preset3_coordinator(cfg, search, run_dir, device="cuda", randomize_vp=(True,)):
    """``AlphaZero`` on the recipe's env (one per entry of ``randomize_vp``),
    net and state set, on ``device``."""
    import torch

    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.envs.scs.scenario import load_scenario
    from nuzero_tpu_torch.evaluation import solo_state_set
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    path = os.path.join(REPO, "configs", "scenarios", ARENA_SCENARIO)
    envs = [SCSGame(load_scenario(path, seed=42), randomize_vp=r, device=device)
            for r in randomize_vp]
    env = envs[0]
    net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0], num_filters=64,
                       num_blocks=2, recall=True, hex=True, dtype=torch.float32).to(device)
    return AlphaZero(envs if len(envs) > 1 else env,
                     NetworkManager(net, env.observation_shape), cfg, search,
                     run_dir=run_dir, state_set=solo_state_set(env))


def preset3_run(card):
    """Phase 14: the recipe through ``AlphaZero.run()`` on the card; returns
    the kernel launches of its main run."""
    import warnings

    import torch

    from nuzero_tpu_torch.ops.cuda import hexconv_kernel
    from nuzero_tpu_torch.training import pipeline
    from nuzero_tpu_torch.utils import plots

    f32, dw = hexconv_kernel.KERNELS[torch.float32], hexconv_kernel.DW_KERNELS[torch.float32]
    t_phase = time.perf_counter()
    log(f"preset 3 recipe: {PRESET3_TRAIN} + {PRESET3_SEARCH}, {ARENA_SCENARIO} with per-game "
        f"victory points, the solo state set, RecurrentNet 64f f32 (2 blocks, recall, hex); "
        f"cut to " + ", ".join(f"{k} {v}" for k, v in PRESET3_CUTS.items()))
    cfg, search = preset3_config()
    steps = cfg.running.training_steps
    with tempfile.TemporaryDirectory() as run_dir:
        az = preset3_coordinator(cfg, search, run_dir)
        initial = az.learner.init_state(torch.Generator(device="cuda").manual_seed(0))
        before = {k: v.clone() for k, v in initial.params.items()}
        # (c): the plot module warns once per process where matplotlib is
        # absent; start this phase's run with a fresh check.
        plots._pyplot.cache_clear()
        torch.cuda.synchronize()
        hexconv_kernel.reset_launch_count()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            state = az.run(seed=0, initial_state=initial)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(hexconv_kernel.launch_count)
        records = az.journal.load()
        for w in caught:
            if w.category is not plots.MissingMatplotlibWarning:
                log(f"warning during the run: {w.category.__name__}: {w.message}")
        missing = [w for w in caught if w.category is plots.MissingMatplotlibWarning]
        if plots._pyplot() is None:
            if len(missing) != 1:
                raise AssertionError(f"{len(missing)} matplotlib warnings, expected one")
            log(f"(c) plots: {missing[0].message}")
        else:
            written = sorted(os.listdir(os.path.join(run_dir, "plots")))
            if not written:
                raise AssertionError("matplotlib is installed and no plot was written")
            log(f"(c) plots written: {', '.join(written)}")

        # (d) the run.
        if [r["step"] for r in records] != list(range(1, steps + 1)):
            raise AssertionError(f"journal steps {[r['step'] for r in records]}")
        if state.step != steps * cfg.learning.num_samples:
            raise AssertionError(f"{state.step} updates applied")
        if not all(math.isfinite(r["loss/combined"]) for r in records):
            raise AssertionError("non-finite training losses")
        if all(torch.equal(before[k], state.params[k]) for k in before):
            raise AssertionError("the parameters did not change")
        if not (counts[f32] and counts[dw]):
            raise AssertionError(f"the run never launched {f32} or {dw}: {counts}")
        for r in records:
            log(f"preset 3 step {r['step']}: {r['games']} games, buffer {r['buffer_games']} "
                f"games, loss {r['loss/combined']:.4f}; self-play {r['time/selfplay']:.2f} s, "
                f"train {r['time/train']:.3f} s, eval {r['time/eval']:.4f} s  [{card}]")
        log(f"preset 3 run: {seconds:.1f} s for {steps} steps, {state.step} updates, "
            f"{int(az.buffer.games_added)} games; kernel launches {counts}")

        # (a) value probes.
        probe_keys = [f"value_probe/{i}" for i in range(6)]
        probed = [r["step"] for r in records if any(k in r for k in probe_keys)]
        if probed != [2, 4]:
            raise AssertionError(f"value probes at steps {probed}, expected [2, 4]")
        for r in records:
            if r["step"] in probed:
                vals = [r[k] for k in probe_keys]
                if not all(math.isfinite(v) and -1.0 <= v <= 1.0 for v in vals):
                    raise AssertionError(f"probe values at step {r['step']}: {vals}")
        torch.cuda.synchronize()
        hexconv_kernel.reset_launch_count()
        t0 = time.perf_counter()
        got = az.probe_values(state.params)
        probe_ms = (time.perf_counter() - t0) * 1e3
        probe_counts = dict(hexconv_kernel.launch_count)
        if probe_counts != {**{k: 0 for k in probe_counts}, f32: 27}:
            raise AssertionError(f"one probe evaluation launched {probe_counts}, expected 27 "
                                 f"of {f32}")
        cpu_params = {k: v.cpu() for k, v in state.params.items()}
        cpu = preset3_coordinator(cfg, search, None, device="cpu")
        want = cpu.probe_values(cpu_params)
        err, scale = max(abs(a - b) for a, b in zip(got, want)), max(abs(v) for v in want)
        if err > 1e-5 * scale:
            raise AssertionError(f"probe values on the card {got} vs CPU {want}")
        if [records[-1][k] for k in probe_keys] != got:
            raise AssertionError("the last journaled probes are not the final params' probes")
        log(f"(a) value probes at steps {probed}: {', '.join(f'{v:+.6f}' for v in got)}; "
            f"card vs CPU (plain) max err {err:.2e} of max|v| {scale:.4f}; one probe "
            f"evaluation {probe_ms:.2f} ms (host clock, synchronized), 27 launches of {f32}  "
            f"[{card}]")

        # (b) weight stats.
        w_keys = ("weights/abs_max", "weights/abs_min", "weights/abs_mean")
        weighed = [r for r in records if w_keys[0] in r]
        if [r["step"] for r in weighed] != [2, 4]:
            raise AssertionError(f"weight stats at steps {[r['step'] for r in weighed]}")
        for r in weighed:
            w_max, w_min, w_mean = (r[k] for k in w_keys)
            if not (0 <= w_min <= w_mean <= w_max and w_max > 0):
                raise AssertionError(f"weight stats at step {r['step']}: {w_max, w_min, w_mean}")
        want_w = cpu.weight_stats(cpu_params)
        err_w = max(abs(records[-1][k] - v) for k, v in zip(w_keys, want_w))
        if err_w > 1e-6 * want_w[0]:
            raise AssertionError(f"weight stats {[records[-1][k] for k in w_keys]} vs CPU "
                                 f"{want_w}")
        log(f"(b) weight stats at step {steps}: max {want_w[0]:.6f}, min {want_w[1]:.3e}, "
            f"mean {want_w[2]:.6f}; card vs CPU max err {err_w:.2e}")

        # (d) the checkpoint restores equal; the partial buffer load.
        resumed = preset3_coordinator(cfg, search, run_dir)
        restored, step = resumed.load("auto")
        if step != steps or restored.step != state.step:
            raise AssertionError(f"restored step {step} / {restored.step}")
        for k in state.params:
            if not (torch.equal(restored.params[k], state.params[k])
                    and torch.equal(restored.opt_state["mu"][k], state.opt_state["mu"][k])):
                raise AssertionError(f"restored {k} differs")
        if not torch.equal(resumed.buffer.states, az.buffer.states):
            raise AssertionError("restored buffer differs")
        partial = preset3_coordinator(cfg, search, run_dir)
        seq_at_2 = next(r["buffer_seq"] for r in records if r["step"] == 2)
        if not partial.load_buffer_at_step(2):
            raise AssertionError("load_buffer_at_step(2) found no buffer")
        if (int(partial.buffer.games_added) != seq_at_2
                or int(partial.buffer.seq.max()) != seq_at_2 - 1):
            raise AssertionError(f"partial load: {int(partial.buffer.games_added)} games, "
                                 f"largest seq {int(partial.buffer.seq.max())}; journal "
                                 f"buffer_seq {seq_at_2}")
        log(f"(d) checkpoint of step {step} restored equal (params, Adam moments, buffer); "
            f"load_buffer_at_step(2): {seq_at_2} games, largest seq {seq_at_2 - 1}, as the "
            f"journal's buffer_seq")
        del az, resumed, partial, cpu

    # (e) the asynchronous mode: no host sync inside a replay, one capture
    # per step function, every step at least update_delay long with at least
    # one move-batch.
    from nuzero_tpu_torch.training import selfplay

    cfg, search = preset3_config(**PRESET3_ASYNC)
    replay, capture = selfplay.SelfplayGraph.replay, pipeline.capture_selfplay_step
    captures, replays = [], [0]

    def checked_replay(graph):
        replays[0] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return replay(graph)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def counted_capture(step_fn, *args, **kwargs):
        captures.append(step_fn)
        return capture(step_fn, *args, **kwargs)

    selfplay.SelfplayGraph.replay = checked_replay
    pipeline.capture_selfplay_step = counted_capture
    try:
        with tempfile.TemporaryDirectory() as run_dir:
            az = preset3_coordinator(cfg, search, run_dir)
            batches = []
            selfplay_for = az._selfplay_for

            def counted(*args):
                before_b = az._sp_batches
                out = selfplay_for(*args)
                batches.append(az._sp_batches - before_b)
                return out

            az._selfplay_for = counted
            az.run(seed=0)
            torch.cuda.synchronize()
            records = az.journal.load()
    finally:
        selfplay.SelfplayGraph.replay = replay
        pipeline.capture_selfplay_step = capture
    step_fns = {az.sp_steps[0], az.sp_steps_early[0]}
    if len(captures) != len(step_fns) or set(captures) != step_fns:
        raise AssertionError(f"{len(captures)} captures for {len(step_fns)} step functions")
    delay = cfg.running.update_delay
    if (len(batches) != cfg.running.training_steps or min(batches) < 1
            or min(r["step_time_s"] for r in records) < delay):
        raise AssertionError(f"asynchronous steps: move-batches {batches}, seconds "
                             f"{[r['step_time_s'] for r in records]}")
    for r, n in zip(records, batches):
        log(f"(e) asynchronous step {r['step']}: {n} move-batches, {r['games']} games, "
            f"{r['step_time_s']:.3f} s (self-play {r['time/selfplay']:.3f} s, train "
            f"{r['time/train']:.3f} s, eval {r['time/eval']:.4f} s)  [{card}]")
    log(f"(e) asynchronous mode, update_delay {delay} s: {len(captures)} captures for "
        f"{len(step_fns)} step functions, {replays[0]} replays, none with a host sync "
        f"(sync debug mode \"error\")")
    del az

    # (f) two game types: the solo map with fixed and with per-game victory
    # points, at 4 and 6 iterations.
    cfg, search = preset3_config(**PRESET3_TYPES)
    with tempfile.TemporaryDirectory() as run_dir:
        az = preset3_coordinator(cfg, search, run_dir, randomize_vp=(False, True))
        per_eval = {}
        apply = az.manager.apply

        def counted_apply(variables, obs, iters_to_do=2, interim_thought=None):
            start = hexconv_kernel.launch_count[f32]
            out = apply(variables, obs, iters_to_do, interim_thought)
            per_eval.setdefault(iters_to_do, set()).add(hexconv_kernel.launch_count[f32] - start)
            return out

        az.manager.apply = counted_apply
        az.run(seed=0)
        torch.cuda.synchronize()
        records = az.journal.load()
    if per_eval != {4: {27}, 6: {37}}:
        raise AssertionError(f"launches per evaluation by iteration count: {per_eval}")
    graphs = [az._graphs.get(step) for step in az.sp_steps]
    if None in graphs or graphs[0] is graphs[1] or len(az._graphs) != 4:
        raise AssertionError(f"{len(az._graphs)} graphs for two game types")
    types = set(az.buffer.game_type[az.buffer.length > 0].tolist())
    keys = ("loss/type0", "loss/type1", "selfplay/type0/games", "selfplay/type1/games")
    if types != {0, 1} or not all(k in r for r in records for k in keys):
        raise AssertionError(f"buffer types {types}, records {[sorted(r) for r in records]}")
    for r in records:
        log(f"(f) two types, step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.4f}" if isinstance(r[k], float) else f"{k} {r[k]}" for k in keys)
            + f"; self-play {r['time/selfplay']:.2f} s, train {r['time/train']:.3f} s  [{card}]")
    log("(f) two types: one graph per type and step function (4), the buffer holds both "
        "types, 27 and 37 launches of the f32 kernel per evaluation of each type")
    del az

    # (g) NUZERO_MFU and NUZERO_TRACE_DIR.
    cfg, search = preset3_config(**PRESET3_TRACE)
    with tempfile.TemporaryDirectory() as run_dir:
        trace_dir = os.path.join(run_dir, "trace")
        saved = {k: os.environ.get(k) for k in ("NUZERO_MFU", "NUZERO_TRACE_DIR")}
        os.environ.update(NUZERO_MFU="1", NUZERO_TRACE_DIR=trace_dir)
        try:
            az = preset3_coordinator(cfg, search, run_dir)
            state = az.run(seed=0)
            torch.cuda.synchronize()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        records = az.journal.load()
        flops = [r.get("train_flops_per_s", 0) for r in records]
        traces = os.listdir(trace_dir)
        if not (flops and min(flops) > 0) or len(traces) != 1:
            raise AssertionError(f"train_flops_per_s {flops}, trace files {traces}")
        path = os.path.join(trace_dir, traces[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = {e["name"] for e in events if e.get("cat") == "kernel"}
        size = os.path.getsize(path)
    for kernel in (f32, dw):
        if not any(kernel in n for n in names):
            raise AssertionError(f"the trace holds no {kernel} ({len(names)} kernel names)")
    log(f"(g) NUZERO_MFU: train_flops_per_s {flops} ({az.train_flops(state.params):.6g} "
        f"FLOPs per update, B={cfg.learning.batch_size}); "
        f"NUZERO_TRACE_DIR: {traces[0]}, {size / 1e6:.1f} MB, {len(events)} events, its "
        f"kernels include {f32} and {dw}  [{card}]")
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return counts


# Phase 15: the port's CLI (``python -m nuzero_tpu_torch.run``) as a user
# runs it, each mode a subprocess on the card.  The flagship training preset
# is cut in depth only: steps, the early fill, simulations and the
# checkpoint cadence.
CLI_TRAIN_CUTS = {"training_steps": 2, "early_fill_per_type": 16, "save_frequency": 1,
                  "num_simulations": 30}
CLI_FLAGSHIP = ["--training-preset", "2", "--filters", "256", "--net-dtype", "bfloat16"]
CLI_SWEEP_RUN = "scs_solo_r3"
# The wizard: 1 = new training, TTT, MLP, a run name (an absolute path), then
# 1 step, 64 actors, 8 games a step, early fill 8, window 256, batch 32,
# 1 sample, SGD, the default rate, 10 simulations, the defaults, sequential.
WIZARD_TRAIN = "1\n0\n0\n{name}\n1\n64\n8\n8\n256\n32\n1\n0\n\n10\n\n\n\n0\n"
# The keys of every journal record of a training step (phase 14's run).
JOURNAL_KEYS = ("step", "games", "buffer_games", "buffer_positions", "buffer_seq", "updates",
                "loss/combined", "loss/policy", "loss/value", "selfplay/root_value",
                "selfplay/tree_full_frac", "selfplay/children_per_node", "step_time_s",
                "time/selfplay", "time/train", "time/eval")
CLI_TIMEOUT = 600


# Runs one CLI invocation as ``python -m nuzero_tpu_torch.run ARGS`` does
# (``run.main(ARGS)``), then writes the process's hex-conv kernel launches
# to the file named first; the CLI itself prints no counts.
CLI_DRIVER = """import json, sys
from nuzero_tpu_torch import run
from nuzero_tpu_torch.ops.cuda import hexconv_kernel
run.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump(dict(hexconv_kernel.launch_count), f)
"""


def cli_start(args, stdin=None):
    """Start the port's CLI with ARGS on the card (the default device) from
    the repository's root, through CLI_DRIVER."""
    t0 = time.perf_counter()
    fd, counts = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    proc = subprocess.Popen([sys.executable, "-c", CLI_DRIVER, counts, *args], cwd=REPO,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, args, stdin, t0, counts


def cli_finish(started):
    """Wait for a started CLI process -> (stdout, launches per kernel, its
    seconds from start to exit); a non-zero exit, a time-out or no written
    launch counts fails."""
    proc, args, stdin, t0, path = started
    try:
        try:
            out, err = proc.communicate(stdin, timeout=CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"the CLI {' '.join(args)} ran past {CLI_TIMEOUT} s")
        if proc.returncode != 0:
            raise AssertionError(f"the CLI {' '.join(args)} exited {proc.returncode}:\n"
                                 f"{err[-4000:]}")
        with open(path) as f:
            text = f.read()
        if not text:
            raise AssertionError(f"the CLI {' '.join(args)} wrote no launch counts")
        return out, json.loads(text), time.perf_counter() - t0
    finally:
        os.remove(path)


def cli(args, stdin=None):
    return cli_finish(cli_start(args, stdin))


def cli_finish_all(started):
    """cli_finish for each started process in turn; where one fails, the
    others are killed before the failure goes on."""
    try:
        return [cli_finish(p) for p in started]
    except BaseException:
        for proc, *_, path in started:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
            if os.path.exists(path):
                os.remove(path)
        raise


def cli_configs(tmp, **cuts):
    """Copies of ``scs_small.yaml`` (cut by CLI_TRAIN_CUTS, then ``cuts``:
    RunningConfig, SavingConfig or Initialization keys) and ``scs_search.yaml``
    (CLI_TRAIN_CUTS' simulations) in ``tmp`` -> their absolute paths."""
    from nuzero_tpu_torch.config.yaml_io import load_yaml, save_yaml

    cuts = {**CLI_TRAIN_CUTS, **cuts}
    train = load_yaml(os.path.join(REPO, PRESET3_TRAIN))
    for key, value in cuts.items():
        for section in ("Running", "Saving", "Initialization"):
            if key in train[section]:
                train[section][key] = value
    search = load_yaml(os.path.join(REPO, PRESET3_SEARCH))
    search["Simulation"]["mcts_simulations"] = cuts["num_simulations"]
    paths = os.path.join(tmp, "train.yaml"), os.path.join(tmp, "search.yaml")
    save_yaml(train, paths[0])
    save_yaml(search, paths[1])
    return paths


def expected_cli_launches(cfg, sims, captures, updates):
    """The hex-conv kernel launches of a training invocation: per captured
    step function two eager moves (the capture's warm-up and the captured
    move; a replay launches through no wrapper) of ``sims + 1`` network
    evaluations at ``pred_iterations``, and per update the forward, dX and
    dW of ``launches_per_progressive_update`` at the draws the coordinator
    makes (``progressive_draws`` from a CPU generator seeded 0 at each
    ``run``) -> (forward kernel, dW kernel)."""
    import torch

    from nuzero_tpu_torch.training.learner import progressive_draws

    pred, m = cfg.recurrent.pred_iterations[0], cfg.recurrent.train_iterations[0]
    forward = captures * 2 * (sims + 1) * (7 + 5 * pred)
    dw = 0
    rng = torch.Generator().manual_seed(0)
    for _ in range(updates):
        per = (launches_per_progressive_update(m, *progressive_draws(rng, m))
               if cfg.recurrent.alpha else launches_per_update(m))
        forward += per["forward"] + per["dx"]
        dw += per["dw"]
    return forward, dw


def cli_phase(card, iteration_curve):
    """Phase 15: every mode of the port's CLI on the card, as subprocesses;
    returns the launches per kernel of each invocation."""
    import torch

    from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta
    from nuzero_tpu_torch.config.schemas import load_training_config
    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import DW_KERNELS, KERNELS
    from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint

    t_phase = time.perf_counter()
    bf16, dw16 = KERNELS[torch.bfloat16], DW_KERNELS[torch.bfloat16]
    launches = {}

    # (a) the debug presets, side by side.
    started = [cli_start(["--debug", str(i)]) for i in range(3)]
    outs = cli_finish_all(started)
    for i, (out, counts, secs) in enumerate(outs):
        launches[f"debug {i}"] = counts
        log(f"(a) --debug {i}: {secs:.1f} s, last lines: "
            + " | ".join(out.rstrip("\n").split("\n")[-2:]))
    if "---|---|---" not in outs[0][0] or "terminal value:" not in outs[0][0]:
        raise AssertionError("--debug 0 printed no board or terminal value")
    if "turn " not in outs[1][0] or "moves: " not in outs[1][0]:
        raise AssertionError("--debug 1 printed no board or terminal value")
    dump = outs[2][0]
    chosen = int(dump.split("chosen action: ")[1].split(",")[0])
    if not dump.startswith("tree: ") or f"\n  a={chosen} p=" not in dump:
        raise AssertionError(f"--debug 2's dump does not name the chosen action {chosen}")

    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "flagship")
        # (b) training preset 2 at the flagship width, cut in depth.
        train, search = cli_configs(tmp)
        log("(b) --training-preset 2 --filters 256 --net-dtype bfloat16 on copies of "
            f"{PRESET3_TRAIN} and {PRESET3_SEARCH} cut to "
            + ", ".join(f"{k} {v}" for k, v in CLI_TRAIN_CUTS.items())
            + f"; --name {run_dir}")
        cfg = load_training_config(train)
        out, counts, secs = cli([*CLI_FLAGSHIP, "--train-config", train,
                                 "--search-config", search, "--name", run_dir])
        launches["training preset 2"] = counts
        steps, per_step = cfg.running.training_steps, cfg.learning.num_samples
        want = expected_cli_launches(cfg, CLI_TRAIN_CUTS["num_simulations"], 2, steps * per_step)
        if (counts[bf16], counts[dw16]) != want or counts[KERNELS[torch.float32]]:
            raise AssertionError(f"training preset 2 launched {counts}, expected {want} of "
                                 f"{bf16} and {dw16}")
        names = sorted(os.listdir(run_dir))
        ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
        for name in ("train_config_copy.yaml", "search_config_copy.yaml", "run_meta.yaml",
                     "journal.jsonl", "checkpoints"):
            if name not in names:
                raise AssertionError(f"the run directory lacks {name}: {names}")
        if ckpts != ["FORMAT", "step_00000001.pt", "step_00000002.pt"]:
            raise AssertionError(f"checkpoints {ckpts}")
        with open(os.path.join(run_dir, "journal.jsonl")) as f:
            records = [json.loads(line) for line in f]
        missing = [k for r in records for k in JOURNAL_KEYS if k not in r]
        if [r["step"] for r in records] != [1, 2] or missing:
            raise AssertionError(f"journal steps {[r['step'] for r in records]}, "
                                 f"missing keys {missing}")
        for r in records:
            log(f"(b) step {r['step']}: {r['games']} games, loss {r['loss/combined']:.4f}, "
                f"self-play {r['time/selfplay']:.2f} s, train {r['time/train']:.3f} s  [{card}]")
        log(f"(b) training preset 2: {secs:.1f} s; launches {counts} = {want[0]} forward "
            f"(2 captures x 2 eager moves x 31 evaluations x 27 convs, then per update 27 + "
            f"26 dX and the progressive loss's second forward at its draws) and {want[1]} dW "
            f"over {steps * per_step} updates  [{card}]")

        # (c) the resume: one more step from the saved one.
        train, search = cli_configs(tmp, training_steps=steps + 1, load_checkpoint=True)
        out, counts, secs = cli([*CLI_FLAGSHIP, "--train-config", train,
                                 "--search-config", search, "--name", run_dir])
        launches["training preset 2, resumed"] = counts
        resumed = f"resuming from step {steps} ({steps * per_step} updates)"
        if resumed not in out:
            raise AssertionError(f"the resume did not start at step {steps}: {out[-2000:]}")
        want = expected_cli_launches(cfg, CLI_TRAIN_CUTS["num_simulations"], 1, per_step)
        if (counts[bf16], counts[dw16]) != want:
            raise AssertionError(f"the resume launched {counts}, expected {want}")
        with open(os.path.join(run_dir, "journal.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if [r["step"] for r in records] != [1, 2, 3] or records[-1]["updates"] != 3 * per_step:
            raise AssertionError(f"resumed journal {[(r['step'], r['updates']) for r in records]}")
        log(f"(c) the resume: {resumed}, one step to {3 * per_step} updates in {secs:.1f} s; "
            f"launches {counts} = {want} (one capture, no early fill)  [{card}]")

        # (d) the written checkpoint, card against CPU, 8 positions.
        meta = load_run_meta(run_dir)
        tree, step = restore_checkpoint(os.path.join(run_dir, "checkpoints"), "auto",
                                        device="cuda")
        if step != 3 or tree["step"] != 3 * per_step:
            raise AssertionError(f"the last checkpoint is step {step}, {tree['step']} updates")
        env, mgr = build_from_meta(meta, REPO, device="cuda")
        _, cpu_mgr = build_from_meta(meta, REPO, device="cpu")
        gen = torch.Generator(device="cuda").manual_seed(5)
        obs = env.observe(random_positions(env, 8, gen))
        # f32 at network_check's f32 tolerance; bf16 at the bf16 one of
        # tests/test_torch_networks.py.
        compare_cpu("(d) checkpoint step 3, build_from_meta (f32)", mgr, cpu_mgr,
                    tree["params"], obs, 1e-4)
        cpu_env = make_env("cpu")
        compare_cpu("(d) checkpoint step 3, 256f bf16 (the run's compute dtype)",
                    make_net(env, 256, torch.bfloat16), make_net(cpu_env, 256, torch.bfloat16),
                    tree["params"], obs, 1e-2)

    # (e) testing presets 1 and 2, the play mode, the wizard's quit and (f)
    # its new-training flow (TTT + MLP, one step), side by side.
    sweep_dir = os.path.join(REPO, "runs", CLI_SWEEP_RUN, "plots_torch")
    if os.path.exists(sweep_dir):
        raise AssertionError(f"{sweep_dir} exists before the sweep")
    with tempfile.TemporaryDirectory() as tmp:
        wizard_run = os.path.join(tmp, "wizard_run")
        started = [cli_start(["--testing-preset", "1"]),
                   cli_start(["--testing-preset", "2", "--name", CLI_SWEEP_RUN]),
                   cli_start(["--play", "mcts", "--cache", "keyless"],
                             "".join(f"{i}\n" for i in range(9))),
                   cli_start(["--interactive"], "5\n"),
                   cli_start(["--interactive"], WIZARD_TRAIN.format(name=wizard_run))]
        try:
            (t1, c1, s1), (t2, c2, s2), (tp, cp, sp), (ti, ci, si), (tw, cw, sw) = (
                cli_finish_all(started))
            with open(os.path.join(sweep_dir, "iteration_sweep.json")) as f:
                curve = json.load(f)
        finally:
            shutil.rmtree(sweep_dir, ignore_errors=True)
        launches.update({"testing preset 1": c1, "testing preset 2": c2, "play": cp,
                         "interactive quit": ci, "interactive new training": cw})
        if f"run complete; artifacts in {wizard_run}" not in tw or not os.path.exists(
                os.path.join(wizard_run, "checkpoints", "step_00000001.pt")):
            raise AssertionError(f"the wizard's run: {tw[-2000:]}")
        with open(os.path.join(wizard_run, "journal.jsonl")) as f:
            wizard_records = [json.loads(line) for line in f]
    if t1.count(" (P1) vs ") != 2:
        raise AssertionError(f"testing preset 1 printed {t1[-1000:]}")
    if curve != iteration_curve:
        raise AssertionError(f"testing preset 2's curve {curve} differs from phase 13's "
                             f"{iteration_curve}")
    if not c2[KERNELS[torch.float32]]:
        raise AssertionError("testing preset 2 never launched the f32 forward kernel")
    ratio = [line for line in tp.split("\n") if "keyless cache: hit ratio" in line]
    if "game over" not in tp or not ratio:
        raise AssertionError(f"--play printed {tp[-1500:]}")
    if "What would you like to do?" not in ti:
        raise AssertionError("--interactive printed no menu")
    trained = [r for r in wizard_records if "loss/combined" in r]
    if [r["step"] for r in trained] != [1]:
        raise AssertionError(f"the wizard's journal {wizard_records}")
    # Each time runs from the five processes' common start to the reading
    # of its result.
    log(f"(e) testing preset 1 within {s1:.1f} s: "
        + " | ".join(line for line in t1.split("\n") if " (P1) vs " in line))
    log(f"(e) testing preset 2 --name {CLI_SWEEP_RUN} within {s2:.1f} s: the iteration curve "
        f"equals phase 13's ({len(curve['results'])} points); launches {c2}  [{card}]")
    log(f"(e) --play mcts --cache keyless within {sp:.1f} s: "
        + tp.split("game over: ")[1].split("\n")[0] + f"; {ratio[0]}")
    log(f"(e) --interactive, quit, within {si:.1f} s")
    log(f"(f) --interactive new training (TTT, MLP, 1 step, 64 actors, 10 simulations) within "
        f"{sw:.1f} s: journal steps {[r['step'] for r in wizard_records]} (the in-loop tests' "
        f"records under their launch steps), loss {trained[0]['loss/combined']:.4f}; launches "
        f"{cw}  [{card}]")

    log("(g) --analyse and --view are not driven here: they open the pygame viewer, and the "
        "card machine has no pygame; tests/test_torch_viewer.py holds them headless on a CPU "
        "host")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches


# Phase 16: every discontinued value head in the hex RecurrentNet, on the
# card.  Their hex convs take shapes no other phase holds (Cin 8 -> Cout 1,
# 64 -> 8, 256 -> 64, the width-64 net's 64 -> 256, depth's 256 -> 1).
HEADS = ("depth", "combined", "separable", "reverse", "rawsep", "strange")
HEAD_BATCH = 64
HEAD_NODES = {"depth": "DepthValueHead_0", "combined": "CombinedValueHead_0",
              "separable": "SeparableValueHead_0", "reverse": "ReverseValueHead_0",
              "rawsep": "RawSeparableValueHead_0", "strange": "StrangeValueHead_0",
              "reduce": "ReduceValueHead_0"}


def flax_variables(net, head, seed):
    """Variables of ``net`` (a hex RecurrentNet with value head ``head``) in
    the JAX package's Flax tree (``nuzero_tpu/networks/recurrent.py``; the
    heads' names as Flax gives them, Strange's 1x1 and hex convs numbered by
    one counter), each kernel drawn from ``seed`` as Flax initializes it
    (uniform, variance 1/(3 fan_in)); ``networks/convert.py`` maps them
    back."""
    import re

    import numpy as np

    rng = np.random.default_rng(seed)
    node = HEAD_NODES[head]
    params = {}

    def put(path, shape, fan_in):
        bound = (1.0 / fan_in) ** 0.5
        tree = params
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = rng.uniform(-bound, bound, shape).astype(np.float32)

    for key, value in net.state_dict().items():
        shape = tuple(value.shape)
        hex_kernel = ("HexConv_0", "kernel")
        if key == "stem.conv.weight":
            put(("Conv_0",) + hex_kernel, shape, shape[0] * shape[1])
        elif key == "cell.recall.conv.weight":
            put(("Scan_RecurCell_0", "Conv_0") + hex_kernel, shape, shape[0] * shape[1])
        elif m := re.fullmatch(r"cell\.blocks\.(\d+)\.conv(\d)\.conv\.weight", key):
            put(("Scan_RecurCell_0", f"BasicBlock_{m[1]}", f"Conv_{int(m[2]) - 1}")
                + hex_kernel, shape, shape[0] * shape[1])
        elif m := re.fullmatch(r"policy_head\.convs\.(\d+)\.conv\.weight", key):
            put(("ReducePolicyHead_0", f"Conv_{m[1]}") + hex_kernel, shape, shape[0] * shape[1])
        elif m := re.fullmatch(r"value_head\.convs\.(\d+)\.conv\.weight", key):
            i = int(m[1]) * 2 + 1 if head == "strange" else int(m[1])
            put((node, f"Conv_{i}") + hex_kernel, shape, shape[0] * shape[1])
        elif m := re.fullmatch(r"value_head\.pointwise\.(\d+)\.weight", key):
            i = int(m[1]) * 2 if head == "strange" else int(m[1])
            put((node, f"Conv_{i}", "kernel"), shape[::-1], shape[1])  # OI11 -> 11IO
        elif m := re.fullmatch(r"value_head\.depthwise\.(\d+)\.conv\.weight", key):
            if len(shape) == 2:
                put((node, f"DepthwiseConv_{m[1]}", "HexDepthwiseConv_0", "kernel"), shape, 7)
            else:  # the ortho grouped 3x3, OIHW [C, 1, 3, 3] -> HWIO
                put((node, f"DepthwiseConv_{m[1]}", "Conv_0", "kernel"),
                    (3, 3, 1, shape[0]), 9)
        else:
            raise KeyError(f"no Flax name for {key}")
    return {"params": params}


def head_net(env, filters, dtype, head):
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet

    net = RecurrentNet(env.observation_shape[0], env.action_space_shape[0], num_filters=filters,
                       num_blocks=2, recall=True, hex=True, dtype=dtype,
                       value_head=head).to(env.device)
    return NetworkManager(net, env.observation_shape)


def tf32_check():
    """The f32 depthwise convs with every TF32 flag on: the hex depthwise
    conv (elementwise f32) and the grouped 3x3 (cuDNN, inside the port's
    TF32 guard) against float64 on the CPU, within 1e-5 of scale; a TF32
    product keeps ~3 digits (2^-11 relative)."""
    import torch

    from nuzero_tpu_torch.networks.blocks import OrthoConv
    from nuzero_tpu_torch.ops.hexconv import hex_conv_depthwise

    gen = torch.Generator().manual_seed(16)
    x = torch.randn(HEAD_BATCH, 5, 5, 256, generator=gen)
    w = torch.randn(7, 256, generator=gen)
    grouped = OrthoConv(256, 256, 3, groups=256)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            hex_y = hex_conv_depthwise(x.cuda(), w.cuda()).cpu()
            grouped_y = grouped.cuda()(x.cuda()).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    with torch.no_grad():
        hex_ref = hex_conv_depthwise(x.double(), w.double())
        grouped_ref = torch.nn.functional.conv2d(
            x.double().permute(0, 3, 1, 2), grouped.weight.double().cpu(), padding="same",
            groups=256).permute(0, 2, 3, 1)
    for name, got, ref in (("hex depthwise", hex_y, hex_ref),
                           ("grouped 3x3 depthwise", grouped_y, grouped_ref)):
        rel = ((got.double() - ref).abs().max() / ref.abs().max()).item()
        if rel > 1e-5:
            raise AssertionError(f"f32 {name} on the card: {rel:.3e} of scale off float64 with "
                                 "TF32 allowed (TF32 keeps ~5e-4)")
        log(f"(e) f32 {name} B={HEAD_BATCH} 5x5 C=256 with TF32 allowed: {rel:.3e} of scale "
            f"off float64 (full f32)")


def heads_phase(card):
    """Phase 16: the discontinued value heads on the card -> the hex-conv
    launches per kernel of the phase's forwards and updates."""
    import torch

    from nuzero_tpu_torch.networks.convert import recurrent_net_state_dict
    from nuzero_tpu_torch.ops.cuda import hexconv_kernel
    from nuzero_tpu_torch.training.learner import TrainState

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(16)
    # (a) the heads' hex-conv shapes: forward, dX and dW against the plain
    # versions, in both dtypes, at B=64 on 5x5 boards.
    shapes = sorted({shape for head in HEADS for filters in (256, 64)
                     for shape in value_head_conv_shapes(head, filters)})
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for cin, cout in shapes:
            err, scale, k_ms, p_ms, l_ms = kernel_check(dtype, HEAD_BATCH, 5, 5, cin, cout, gen)
            b_ms, b_by = bound(dtype_name, HEAD_BATCH, 5, 5, cin, cout)
            res = backward_check(dtype, HEAD_BATCH, 5, 5, cin, cout, gen)
            log(f"(a) head conv {dtype_name} B={HEAD_BATCH} 5x5 {cin}->{cout}: forward err "
                f"{err:.3e} (max|y| {scale:.3e}), kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"library {l_ms:.4f} ms; dX err {res['dx'][0]:.3e} (max {res['dx'][1]:.3e}), "
                f"kernel {res['dx'][2]:.4f} ms; dW err {res['dw'][0]:.3e} (max "
                f"{res['dw'][1]:.3e}), kernel {res['dw'][2]:.4f} ms, graph {res['dw'][5]:.4f} "
                f"ms, library {res['dw'][4]:.4f} ms; bound {b_ms:.4f} ms ({b_by})  [{card}]")

    launches = {name: 0 for name in hexconv_kernel.launch_count}
    env, cpu_env = make_env("cuda"), make_env("cpu")
    obs = env.observe(random_positions(env, HEAD_BATCH, gen))
    batch = random_batch(env, HEAD_BATCH, torch.Generator().manual_seed(16), "cuda")
    for filters, dtype in ((256, torch.bfloat16), (64, torch.float32)):
        kernel = hexconv_kernel.KERNELS[dtype]
        dw_kernel = hexconv_kernel.DW_KERNELS[dtype]
        for i, head in enumerate(HEADS):
            # (b) converted JAX-shaped weights, card against CPU.
            mgr = head_net(env, filters, dtype, head)
            flax = flax_variables(mgr.module, head, seed=100 + i)
            state_dict = recurrent_net_state_dict(flax)
            want = mgr.module.state_dict()
            if set(state_dict) != set(want) or any(
                    tuple(want[k].shape) != v.shape for k, v in state_dict.items()):
                raise AssertionError(f"{head}: the converted Flax tree does not fit the net")
            variables = {k: torch.from_numpy(v).cuda() for k, v in state_dict.items()}
            label = f"(b) {head} {filters}f {str(dtype)[6:]} B={HEAD_BATCH}"
            torch.cuda.synchronize()
            hexconv_kernel.reset_launch_count()
            cpu_mgr = head_net(cpu_env, filters, dtype, head)
            if dtype == torch.float32:
                compare_cpu(label, mgr, cpu_mgr, variables, obs, 1e-4, floor=1e-6)
            else:
                compare_cpu(label, mgr, cpu_mgr, variables, obs, 1e-2,
                            f32_mgr=head_net(cpu_env, filters, torch.float32, head))
            counts = dict(hexconv_kernel.launch_count)
            want_fwd = convs_per_evaluation(head, 2)
            if counts[kernel] != want_fwd or sum(counts.values()) != want_fwd:
                raise AssertionError(f"{label}: launches {counts}, expected {want_fwd} of "
                                     f"{kernel}")
            # (c) one learner update (4 iterations, the progressive loss off).
            learner = learner_for(mgr, 0.0)
            state = TrainState(params=variables, opt_state=learner.init_opt_state(variables),
                               step=0)
            hexconv_kernel.reset_launch_count()
            new, metrics = learner.train_step(state, batch)
            torch.cuda.synchronize()
            update = dict(hexconv_kernel.launch_count)
            convs = convs_per_evaluation(head, TRAIN_ITERS)
            if (update[kernel], update[dw_kernel]) != (2 * convs - 1, convs):
                raise AssertionError(f"{label} update: launches {update}, expected "
                                     f"{2 * convs - 1} forward + dX and {convs} dW")
            loss = float(metrics["loss/combined"])
            moved = max((new.params[k] - variables[k]).abs().max().item() for k in variables
                        if k.startswith("value_head."))
            if not (math.isfinite(loss) and moved > 0):
                raise AssertionError(f"{label} update: loss {loss}, value head moved {moved}")
            for name in launches:
                launches[name] += counts[name] + update[name]
            log(f"{label}: {want_fwd} hex-conv launches per evaluation; one update (B="
                f"{HEAD_BATCH}, {TRAIN_ITERS} iterations) loss {loss:.4f}, {update[kernel]} "
                f"forward + dX and {update[dw_kernel]} dW launches, the value head's largest "
                f"step {moved:.2e}  [{card}]")
    # (e) no TF32 in the f32 depthwise convs.
    tf32_check()
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s; launches {launches}  [{card}]")
    return launches


# Phase 17: data-parallel training on the one card, ranks as subprocesses
# over gloo (NCCL refuses two ranks on one device).  (a) is the CLI's
# flagship training preset cut as phase 15 cuts it, at 2 ranks.
DP_RANKS = 2
DP_TIMEOUT = 600
# Runs one CLI invocation as a rank of a torchrun launch does, then writes
# the process's hex-conv launches, and for each AlphaZero.run it made the
# SHA-256 of the returned params and the games in this rank's ring.
DP_DRIVER = """import hashlib, json, sys
from nuzero_tpu_torch import run
from nuzero_tpu_torch.ops.cuda import hexconv_kernel
from nuzero_tpu_torch.training import pipeline
runs = []
run_az = pipeline.AlphaZero.run

def counted(self, *args, **kwargs):
    state = run_az(self, *args, **kwargs)
    h = hashlib.sha256()
    for k in sorted(state.params):
        h.update(k.encode())
        h.update(state.params[k].detach().cpu().contiguous().numpy().tobytes())
    runs.append({"params": h.hexdigest(), "ring_games": self.buffer.num_games,
                 "ring_capacity": self.buffer.capacity, "updates": state.step})
    return state

pipeline.AlphaZero.run = counted
run.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump({"launches": dict(hexconv_kernel.launch_count), "runs": runs}, f)
"""
# The gradient of one global batch at ``filters`` and ``dtype`` by this
# rank of WORLD ranks over BACKEND; rank 0 saves it.
DP_UPDATE_DRIVER = """import sys, torch
import chip_smoke
from nuzero_tpu_torch.parallel import make_mesh
from nuzero_tpu_torch.parallel.distributed import initialize_distributed
rank, world, port, backend, filters, dtype, out = sys.argv[1:8]
initialize_distributed(f"127.0.0.1:{port}", int(world), int(rank), backend=backend)
mesh = make_mesh("cuda:0")
grads = chip_smoke.dp_grads(int(filters), getattr(torch, dtype), mesh)
if int(rank) == 0:
    torch.save({k: v.cpu() for k, v in grads.items()}, out)
torch.distributed.destroy_process_group()
"""


def dp_grads(filters, dtype, mesh=None):
    """The gradient DP_UPDATE_DRIVER takes, on the card: seeded weights, a
    seeded global batch of 256 (the recipe's), 4 iterations, the
    progressive loss off, by the ranks of ``mesh`` (the learner's
    all-reduced gradient, which every rank applies) or, without one, by
    this process alone -> the gradient."""
    import torch

    env = make_env("cuda")
    mgr = make_net(env, filters, dtype)
    params = mgr.init(torch.Generator(device="cuda").manual_seed(17))
    batch = random_batch(env, TRAIN_BATCH, torch.Generator().manual_seed(17), "cuda")
    learner = learner_for(mgr, 0.0, mesh=mesh)
    _, _, grads = learner.value_and_grad(params, batch, None)
    torch.cuda.synchronize()
    return grads


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_processes(command_for, world):
    """Start ``world`` ranks (``command_for(rank)`` -> (argv, env)) from the
    repository's root; wait for all -> their stdout.  A non-zero exit or a
    time-out fails, after every rank is stopped."""
    procs = []
    for rank in range(world):
        argv, env = command_for(rank)
        procs.append(subprocess.Popen(argv, cwd=REPO, env={**os.environ, **env},
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for rank, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=DP_TIMEOUT)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {rank} ran past {DP_TIMEOUT} s") from None
            if proc.returncode != 0:
                raise AssertionError(f"rank {rank} exited {proc.returncode}:\n{err[-4000:]}")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def dp_cli(args):
    """The CLI with ARGS on DP_RANKS ranks of a torchrun-style launch on the
    one card (gloo) -> each rank's (stdout, DP_DRIVER report), seconds."""
    t0 = time.perf_counter()
    port = free_port()
    paths = []
    for _ in range(DP_RANKS):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        paths.append(path)

    def command(rank):
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(DP_RANKS), "LOCAL_RANK": str(rank)}
        return ([sys.executable, "-c", DP_DRIVER, paths[rank], *args, "--dist-backend",
                 "gloo"], env)

    try:
        outs = rank_processes(command, DP_RANKS)
        reports = []
        for path in paths:
            with open(path) as f:
                reports.append(json.load(f))
    finally:
        for path in paths:
            os.remove(path)
    return list(zip(outs, reports)), time.perf_counter() - t0


def data_parallel_phase(card):
    """Phase 17: data-parallel training on the one card -> the hex-conv
    launches per kernel of rank 0's CLI runs."""
    import torch

    from nuzero_tpu_torch.config.schemas import load_training_config
    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import DW_KERNELS, KERNELS

    t_phase = time.perf_counter()
    bf16, dw16 = KERNELS[torch.bfloat16], DW_KERNELS[torch.bfloat16]
    launches = {name: 0 for name in (*KERNELS.values(), *DW_KERNELS.values())}
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "dp_flagship")
        train, search = cli_configs(tmp)
        cfg = load_training_config(train)
        steps, per_step = cfg.running.training_steps, cfg.learning.num_samples
        per_rank = cfg.running.num_actors // DP_RANKS
        log(f"(a) {DP_RANKS} ranks (gloo, one card): " + " ".join(CLI_FLAGSHIP) + " cut as "
            f"phase 15 cuts it, {cfg.running.num_actors} actors = {per_rank} per rank")
        for resume in (False, True):
            if resume:
                train, search = cli_configs(tmp, training_steps=steps + 1, load_checkpoint=True)
            ranks, secs = dp_cli([*CLI_FLAGSHIP, "--train-config", train, "--search-config",
                                  search, "--name", run_dir])
            captures, updates = (1, per_step) if resume else (2, steps * per_step)
            want = expected_cli_launches(cfg, CLI_TRAIN_CUTS["num_simulations"], captures,
                                         updates)
            digests = set()
            for rank, (out, report) in enumerate(ranks):
                counts, (run,) = report["launches"], report["runs"]
                if (counts[bf16], counts[dw16]) != want or counts[KERNELS[torch.float32]]:
                    raise AssertionError(f"rank {rank} launched {counts}, expected {want} of "
                                         f"{bf16} and {dw16}")
                if not (0 < run["ring_games"] <= run["ring_capacity"]
                        == cfg.learning.replay_window_size // DP_RANKS):
                    raise AssertionError(f"rank {rank}'s ring: {run}")
                if f"torch.distributed: rank {rank} of {DP_RANKS} (gloo) on cuda:0" not in out:
                    raise AssertionError(f"rank {rank} did not join the group: {out[-1000:]}")
                digests.add(run["params"])
                log(f"(a) {'resume, ' if resume else ''}rank {rank}: params sha256 "
                    f"{run['params'][:16]}, {run['updates']} updates, ring {run['ring_games']} "
                    f"of {run['ring_capacity']} games, launches {counts[bf16]} forward + dX, "
                    f"{counts[dw16]} dW (expected {want})  [{card}]")
            if len(digests) != 1:
                raise AssertionError(f"the ranks' params differ: {digests}")
            for name in launches:
                launches[name] += ranks[0][1]["launches"][name]
            with open(os.path.join(run_dir, "journal.jsonl")) as f:
                records = [json.loads(line) for line in f]
            want_steps = list(range(1, steps + 1 + resume))
            if [r["step"] for r in records] != want_steps:
                raise AssertionError(f"journal steps {[r['step'] for r in records]}")
            ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
            want_ckpts = ["FORMAT"] + [f"step_{s:08d}{suffix}" for s in want_steps
                                       for suffix in (".pt", ".ring0-of-2.pt", ".ring1-of-2.pt")]
            if ckpts != want_ckpts:
                raise AssertionError(f"checkpoints {ckpts}")
            for r in records[-1 if resume else 0:]:
                log(f"(a) step {r['step']}: {r['games']} games over both ranks, buffer "
                    f"{r['buffer_games']} games ({r['buffer_seq_per_rank']} per rank), loss "
                    f"{r['loss/combined']:.4f}, self-play {r['time/selfplay']:.2f} s, train "
                    f"{r['time/train']:.3f} s  [{card}]")
            log(f"(a) {'the resume at 2 ranks' if resume else 'the run'}: {secs:.1f} s, "
                f"params bit-equal across ranks, journal steps {want_steps} written once, "
                f"checkpoint files {len(ckpts) - 1}  [{card}]")

    dp_gradient_check(card)
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return launches


def dp_gradient_check(card):
    """Phase 17 (b) and (c): the data-parallel gradient against one process."""
    import torch

    # (b) the gradient of one global batch by 2 ranks and by 1.  f32: each
    # tensor within 1e-5 of its largest entry.  bf16 rounds each rank's dW
    # partial to bf16 before the ranks' sum (one rounding of the whole in
    # one process), and where the halves cancel, as in the deep stem, that
    # rounding is large beside the sum.  So bf16 is held as phase 7 holds
    # the card against the CPU: every tensor within twice bf16's own error
    # (the one-process bf16 gradient against the same one in f32, relative
    # norms), and the whole gradient within 1e-2 of its largest entry.
    for filters, dtype_name in ((64, "float32"), (256, "bfloat16")):
        dtype = getattr(torch, dtype_name)
        port = free_port()
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "params.pt")
            t0 = time.perf_counter()
            rank_processes(lambda rank: ([sys.executable, "-c", DP_UPDATE_DRIVER, str(rank),
                                          str(DP_RANKS), str(port), "gloo", str(filters),
                                          dtype_name, out], {}), DP_RANKS)
            secs = time.perf_counter() - t0
            two = {k: v.float() for k, v in torch.load(out).items()}
        one = {k: v.float().cpu() for k, v in dp_grads(filters, dtype).items()}
        f32 = None if dtype == torch.float32 else {
            k: v.cpu() for k, v in dp_grads(filters, torch.float32).items()}
        top = max(v.abs().max().item() for v in one.values())
        worst = worst_ratio = 0.0
        for k in one:
            err = (two[k] - one[k]).abs().max().item()
            scale = one[k].abs().max().item() if f32 is None else top
            worst = max(worst, err / max(scale, 1e-30))
            if f32 is not None:
                rel = ((two[k] - one[k]).norm() / one[k].norm().clamp(min=1e-30)).item()
                own = ((one[k] - f32[k]).norm() / f32[k].norm().clamp(min=1e-30)).item()
                worst_ratio = max(worst_ratio, rel / max(own, 1e-30))
                if rel > 2 * own:
                    raise AssertionError(f"(b) {filters}f {dtype_name} {k}: 2 ranks vs 1 "
                                         f"{rel:.3e} of its norm, over twice bf16's own "
                                         f"{own:.3e}")
            tol = 1e-5 if f32 is None else 1e-2
            if err > tol * scale:
                raise AssertionError(f"(b) {filters}f {dtype_name} {k}: 2 ranks vs 1 differ by "
                                     f"{err} > {tol} x {scale}")
        log(f"(b) the gradient of one global batch of {TRAIN_BATCH} at {filters}f {dtype_name} "
            f"({TRAIN_ITERS} iterations) by {DP_RANKS} ranks and by 1: worst {worst:.2e} of "
            + ("each tensor's largest entry (tolerance 1e-5)" if f32 is None else
               f"the gradient's largest entry (tolerance 1e-2), each tensor at most "
               f"{worst_ratio:.2f}x bf16's own error")
            + f"; the ranks' run {secs:.1f} s  [{card}]")

    # (c) a one-rank NCCL group: the gradient bit-equal to no group.
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "params.pt")
        port = free_port()
        rank_processes(lambda rank: ([sys.executable, "-c", DP_UPDATE_DRIVER, "0", "1",
                                      str(port), "nccl", "64", "float32", out], {}), 1)
        nccl = torch.load(out)
    one = {k: v.cpu() for k, v in dp_grads(64, torch.float32).items()}
    if any(not torch.equal(nccl[k], one[k]) for k in one):
        raise AssertionError("(c) the one-rank NCCL gradient differs from the one without it")
    log("(c) a one-rank NCCL group: the 64f f32 gradient bit-equal to the one without a "
        "group; NCCL across cards is not run here (one card)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from nuzero_tpu_torch.ops.cuda.build import build_all
    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import DW_KERNELS, KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. device
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libraries = build_all()
    log(f"built the kernel libraries {sorted(libraries)} in {time.perf_counter() - t0:.1f} s")
    sass = "".join(dump_sass(lib._name) for lib in libraries.values())
    for kernel, (must, must_not) in SASS.items():
        counts = check_sass(sass, kernel, must, must_not)
        log(f"{kernel} SASS: " + ", ".join(f"{op} {n}" for op, n in counts.items()))

    # --- 2. kernel check
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_dtype = {}

    def check(dtype_name, batch, rows, cin, cout, label, cols=None):
        cols = cols or rows
        err, scale, k_ms, p_ms, l_ms = kernel_check(
            getattr(torch, dtype_name), batch, rows, cols, cin, cout, gen)
        b_ms, b_by = bound(dtype_name, batch, rows, cols, cin, cout)
        log(f"kernel {dtype_name} B={batch} {rows}x{cols} {cin}->{cout}{label}: "
            f"max abs err {err:.3e} (max|y| {scale:.3e}); kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / k_ms:.1f}% of bound  [{card}]")
        return err, k_ms, p_ms, l_ms, b_ms, b_by

    for filters, dtype_name, batch in LEGS:
        sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        by = {"operations": 0.0, "bytes": 0.0}
        worst = 0.0
        for cin, cout, count in conv_shapes(filters):
            err, k_ms, p_ms, l_ms, b_ms, b_by = check(
                dtype_name, batch, 5, cin, cout, f" (x{count})")
            for key, ms in zip(sums, (k_ms, p_ms, l_ms, b_ms)):
                sums[key] += count * ms
            by[b_by] += count * b_ms
            worst = max(worst, err)
        sums["bound_by"] = max(by, key=by.get)
        per_dtype[dtype_name] = [worst, sums]
        log(f"kernel {dtype_name} per {filters}f network evaluation (17 convs): "
            f"kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, library "
            f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms  [{card}]")
    for dtype_name, batch, rows, cin, cout in (("float32", 256, 10, 64, 64),
                                               ("float32", 64, 30, 64, 64),
                                               ("bfloat16", 256, 10, 342, 256),
                                               ("bfloat16", 64, 30, 256, 138)):
        err = check(dtype_name, batch, rows, cin, cout, "")[0]
        per_dtype[dtype_name][0] = max(per_dtype[dtype_name][0], err)
    for batch, rows, cols, cin, cout in RAGGED:
        err = check("float32", batch, rows, cin, cout, " (ragged)", cols)[0]
        per_dtype["float32"][0] = max(per_dtype["float32"][0], err)
    # The transfer sweeps' shapes (phase 13): f32, B=64, every board size;
    # per evaluation at each iteration count from the per-shape times.
    transfer = {}
    for size in SWEEP_SIZES:
        per_shape = {}
        for cin, cout, _ in sweep_conv_shapes():
            err, *times = check("float32", SWEEP_BATCH, size, cin, cout, " (sweep)")
            per_dtype["float32"][0] = max(per_dtype["float32"][0], err)
            per_shape[cin, cout] = times
        for iters in SWEEP_ITERS:
            sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
            by = {"operations": 0.0, "bytes": 0.0}
            for cin, cout, count in sweep_conv_shapes(iters):
                *times, b_by = per_shape[cin, cout]
                for key, ms in zip(sums, times):
                    sums[key] += count * ms
                by[b_by] += count * times[3]
            sums["bound_by"] = max(by, key=by.get)
            transfer[f"{size}x{size}, {iters} iterations"] = sums
            log(f"kernel float32 per sweep evaluation B={SWEEP_BATCH} {size}x{size} at {iters} "
                f"iterations ({7 + 5 * iters} convs): kernel {sums['ms']:.4f} ms, plain "
                f"{sums['plain_ms']:.4f} ms, library {sums['library_ms']:.4f} ms, bound "
                f"{sums['bound_ms']:.4f} ms ({sums['bound_by']}), "
                f"{100 * sums['bound_ms'] / sums['ms']:.1f}% of bound  [{card}]")

    # --- 18. the SCS env's step kernel against its plain version
    scs_step_lines = scs_step_check(card)

    # --- 6. backward kernel check, at the shapes of one training update
    dw_sums = {}
    per = launches_per_update()

    def backward_line(name, dtype_name, label, res, b_ms, b_by):
        err, scale, k_ms, p_ms, l_ms, kg_ms, lg_ms = res
        log(f"{name} {dtype_name} {label}: max abs err {err:.3e} (max {scale:.3e}); kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library {l_ms:.4f} ms; graph: kernel "
            f"{kg_ms:.4f} ms, library {lg_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / kg_ms:.1f}% of bound  [{card}]")

    for filters, dtype_name in NETS:
        dtype = getattr(torch, dtype_name)
        sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        dx_sums = dict(sums)
        graph_sums = {"dw": [0.0, 0.0], "dx": [0.0, 0.0]}  # kernel, library
        by = {"operations": 0.0, "bytes": 0.0}
        worst = 0.0
        for i, (cin, cout, count) in enumerate(conv_shapes(filters, iterations=TRAIN_ITERS)):
            res = backward_check(dtype, TRAIN_BATCH, 5, 5, cin, cout, gen)
            b_ms, b_by = bound(dtype_name, TRAIN_BATCH, 5, 5, cin, cout)
            for name, n in (("dw", count), ("dx", 0 if i == 0 else count)):
                backward_line(name, dtype_name, f"B={TRAIN_BATCH} 5x5 {cin}->{cout} (x{n} per "
                              f"update)", res[name], b_ms, b_by)
                total = sums if name == "dw" else dx_sums
                for key, ms in zip(total, (*res[name][2:5], b_ms)):
                    total[key] += n * ms
                graph_sums[name][0] += n * res[name][5]
                graph_sums[name][1] += n * res[name][6]
            by[b_by] += count * b_ms
            worst = max(worst, res["dw"][0])
            per_dtype[dtype_name][0] = max(per_dtype[dtype_name][0], res["dx"][0])
        sums["bound_by"] = max(by, key=by.get)
        dw_sums[dtype_name] = [worst, sums]
        for name, total in (("dW", sums), ("dX", dx_sums)):
            kg_ms, lg_ms = graph_sums[name.lower()]
            log(f"{name} {dtype_name} per {filters}f update ({per['dw' if name == 'dW' else 'dx']}"
                f" launches): kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
                f"library {total['library_ms']:.4f} ms; graph: kernel {kg_ms:.4f} ms, library "
                f"{lg_ms:.4f} ms; bound {total['bound_ms']:.4f} ms, "
                f"{100 * total['bound_ms'] / kg_ms:.1f}% of bound  [{card}]")
    ragged = [(d, shape) for d in ("float32", "bfloat16") for shape in BACKWARD_RAGGED]
    ragged.append(("bfloat16", (64, 30, 30, 256, 138)))
    for dtype_name, (batch, rows, cols, cin, cout) in ragged:
        res = backward_check(getattr(torch, dtype_name), batch, rows, cols, cin, cout, gen)
        b_ms, b_by = bound(dtype_name, batch, rows, cols, cin, cout)
        for name in ("dw", "dx"):
            backward_line(name, dtype_name, f"B={batch} {rows}x{cols} {cin}->{cout}", res[name],
                          b_ms, b_by)
        dw_sums[dtype_name][0] = max(dw_sums[dtype_name][0], res["dw"][0])
        per_dtype[dtype_name][0] = max(per_dtype[dtype_name][0], res["dx"][0])

    # --- 3. network check
    for filters, dtype_name, _ in LEGS:
        network_check(filters, getattr(torch, dtype_name))

    # --- 7. gradient check and the launches of one update
    update_counts = {}
    for filters, dtype_name in NETS:
        grad_check(filters, getattr(torch, dtype_name))
        update_counts[dtype_name] = update_launch_check(filters, getattr(torch, dtype_name))
    update_profile(64, torch.float32, card)

    # --- 4./5. self-play legs
    kernels = []
    scs_step_launches = {}
    for filters, dtype_name, batch in LEGS:
        launches, evals, seconds, replayed, steps = selfplay_leg(
            filters, getattr(torch, dtype_name), batch, card)
        scs_step_launches[f"{filters}f {dtype_name} B={batch}"] = steps
        steady = statistics.median(seconds[1:])
        log(f"leg {filters}f {dtype_name} B={batch}: first move {seconds[0]:.4f} s, "
            f"steady {steady:.4f} s/move (median of moves 2-{MOVES}), "
            f"{batch * SIMS / steady:.1f} env-steps/s; {evals} network evaluations, "
            f"{launches} hex-conv and {steps} SCS step kernel launches; replayed "
            f"{statistics.median(replayed[1:]):.4f} "
            f"s/move  [{card}]")
        worst, sums = per_dtype[dtype_name]
        kernels.append({
            "name": KERNELS[getattr(torch, dtype_name)],
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": launches,
            "max_abs_err": worst,
            **sums,
        })

    # --- 8. training run
    train_counts = training_run(card)
    # The dW kernels' launches: the bf16 kernel's from the training run, the
    # f32 kernel's from the 64f learner update (the recipe's default width).
    dw_launches = {"bfloat16": train_counts[DW_KERNELS[torch.bfloat16]],
                   "float32": update_counts["float32"][DW_KERNELS[torch.float32]]}
    for dtype_name in ("bfloat16", "float32"):
        worst, sums = dw_sums[dtype_name]
        kernels.append({
            "name": DW_KERNELS[getattr(torch, dtype_name)],
            "route": "cuda",
            "source": DW_SOURCE,
            "replaces": DW_REPLACES,
            "launches": dw_launches[dtype_name],
            "max_abs_err": worst,
            **sums,
        })

    # --- 9.-12. the zoo, Tic-Tac-Toe, the evaluation layer
    zoo_check(card)
    for batch in TTT_BATCHES:
        ttt_selfplay_leg(batch, card)
    arena_check(card)
    ttt_training_run(card)

    # --- 13. the transfer path: the committed runs, the sweeps, randomize_vp
    transfer_launches, curves = transfer_check(card)
    names = [k["name"] for k in kernels]
    kernels[names.index(KERNELS[torch.float32])]["transfer"] = {
        "launches": transfer_launches,
        "per_evaluation": transfer[f"{SWEEP_SIZES[-1]}x{SWEEP_SIZES[-1]}, {SWEEP_ITERS[-1]} "
                                   f"iterations"],
        "at": f"B={SWEEP_BATCH} {SWEEP_SIZES[-1]}x{SWEEP_SIZES[-1]}, {SWEEP_ITERS[-1]} "
              f"iterations",
    }

    # --- 7. (continued) the repeat check, after the heavy phases
    repeat_check(card)

    # --- 14. run.py preset 3's recipe
    preset3_counts = preset3_run(card)
    for kernel in (KERNELS[torch.float32], DW_KERNELS[torch.float32]):
        kernels[names.index(kernel)]["preset3"] = {"launches": preset3_counts[kernel]}

    # --- 15. the CLI, every mode, as subprocesses
    cli_counts = cli_phase(card, curves[CLI_SWEEP_RUN])
    for entry in kernels:
        by_mode = {mode: c[entry["name"]] for mode, c in cli_counts.items() if c[entry["name"]]}
        entry["cli"] = {"launches": sum(by_mode.values()), "by_mode": by_mode}

    # --- 16. the discontinued value heads
    head_counts = heads_phase(card)
    # --- 17. data-parallel training on the one card
    dp_counts = data_parallel_phase(card)
    for entry in kernels:
        entry["heads"] = {"launches": head_counts[entry["name"]]}
        entry["data_parallel"] = {"launches_rank0": dp_counts[entry["name"]]}

    # The SCS step kernel: launches in the self-play legs' eager moves (phases
    # 4 and 5); times at contested256's shape, and at every shape of phase 18.
    at = next(line for line in scs_step_lines if line["scenario"] == "open_field_5")
    kernels.append({
        "name": "scs_step_kernel",
        "route": "cuda",
        "source": SCS_STEP_SOURCE,
        "replaces": SCS_STEP_REPLACES,
        "launches": sum(scs_step_launches.values()),
        "by_leg": scs_step_launches,
        "max_abs_err": 0.0,
        "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
        "bound_by": "bytes",
        "at": f"{at['scenario']} B={at['batch']}",
        "shapes": scs_step_lines,
    })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
