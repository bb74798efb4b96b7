"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips where there is no CUDA card, as on the CPU
test machines.  This file imports neither JAX nor the JAX package, so it
also runs on a card machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (
    BACKWARD_RAGGED, RAGGED, SWEEP_BATCH, SWEEP_SIZES, conv_shapes, sweep_conv_shapes,
)
from nuzero_tpu_torch.envs.scs.game import SCSGame
from nuzero_tpu_torch.envs.scs.scenario import load_scenario
from nuzero_tpu_torch.networks.blocks import HexConv, OrthoConv
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.ops import hexconv
from nuzero_tpu_torch.ops.cuda import hexconv_kernel
from nuzero_tpu_torch.search import mcts
from nuzero_tpu_torch.training.selfplay import (
    capture_selfplay_step, init_selfplay, make_selfplay_step, move_tensors, play_in_place,
)
from nuzero_tpu_torch.utils import graphs

# (Cin, Cout) of the 17 convs of one 256-filter RecurrentNet evaluation.
LEG_256F = [(86, 256), (342, 256), (256, 256), (256, 138), (138, 21),
            (256, 192), (192, 128), (128, 64), (64, 1)]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _inputs(b, h, w, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((7, cin, cout)) / np.sqrt(7 * cin)).astype(np.float32)
    return x, wt


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", LEG_256F)
def test_bf16_kernel_matches_plain_on_card(cuda_card, cin, cout):
    """The bf16 kernel against the plain version at the 256-filter leg's
    shapes, B=8 on 5x5 boards: within 1e-2 of max|y| (f32 sums in another
    order, one bf16 rounding of the output)."""
    x, wt = _inputs(8, 5, 5, cin, cout, seed=3)
    xb = torch.from_numpy(x).to("cuda", torch.bfloat16)
    wb = torch.from_numpy(wt).to("cuda", torch.bfloat16)
    hexconv_kernel.reset_launch_count()
    got = hexconv_kernel.hex_conv_cuda(xb, wb).float()
    want = hexconv.hex_conv_plain(xb, wb).float()
    assert hexconv_kernel.launch_count[hexconv_kernel.KERNELS[torch.bfloat16]] == 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


# (B, H, W, Cin, Cout) of the f32 kernel's cases: the 64-filter leg's
# shapes at B=8 on 5x5, the ragged cases, and 10x10 and 30x30 boards.
F32_CASES = ([(8, 5, 5, cin, cout) for cin, cout, _ in conv_shapes(64)]
             + list(RAGGED) + [(4, 10, 10, 64, 64), (2, 30, 30, 64, 48)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout", F32_CASES)
def test_f32_kernel_matches_plain_on_card(cuda_card, b, h, w, cin, cout):
    """The f32 kernel against the plain version within 1e-5 of max|y|: both
    sum f32 products in f32 (FFMA, no TF32), in another order."""
    x, wt = _inputs(b, h, w, cin, cout, seed=5)
    xc, wc = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
    hexconv_kernel.reset_launch_count()
    got = hexconv_kernel.hex_conv_cuda(xc, wc)
    want = hexconv.hex_conv_plain(xc, wc)
    assert hexconv_kernel.launch_count[hexconv_kernel.KERNELS[torch.float32]] == 1
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("size", SWEEP_SIZES)
def test_f32_kernel_at_the_sweep_shapes(cuda_card, size):
    """The f32 kernel against the plain version at every conv shape of the
    transfer sweeps on one board size (B=64, Cin 67 and 131, Cout 38, 12
    and 1, odd widths 5-15), within 1e-5 of max|y|, one launch each."""
    for cin, cout, _ in sweep_conv_shapes():
        x, wt = _inputs(SWEEP_BATCH, size, size, cin, cout, seed=size)
        xc, wc = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
        hexconv_kernel.reset_launch_count()
        got = hexconv_kernel.hex_conv_cuda(xc, wc)
        want = hexconv.hex_conv_plain(xc, wc)
        assert hexconv_kernel.launch_count[hexconv_kernel.KERNELS[torch.float32]] == 1
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), f"{size}x{size} {cin}->{cout}: {err}"


@pytest.mark.cuda
def test_f32_ortho_conv_is_full_f32_on_card(cuda_card):
    """An f32 OrthoConv on the card matches the same weights on the CPU
    within 1e-5 of scale under torch's default flags, which let cuDNN run
    f32 convolutions in TF32 (about three digits); the caller's flag is
    left as it was."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((16, 5, 5, 64)).astype(np.float32))
    conv = OrthoConv(64, 64)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default
    try:
        with torch.no_grad():
            want = conv(x)
            got = conv.cuda()(x.cuda()).cpu()
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_f32_kernel_at_the_widest_board_that_fits(cuda_card):
    """At 64->64 the f32 kernel's halo slab (BM + 2W + 2 rows of 64
    channels, two buffers) and its B ring fit the 227 KB of shared memory
    up to W = 126: the widest board runs and matches the plain version."""
    x, wt = _inputs(1, 2, 126, 64, 64, seed=9)
    xc, wc = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
    got = hexconv_kernel.hex_conv_cuda(xc, wc)
    want = hexconv.hex_conv_plain(xc, wc)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_f32_kernel_raises_past_the_shared_memory_cap(cuda_card):
    """Past W = 126 at 64->64 the slab does not fit: hexconv_forward returns
    an error, which the wrapper raises, and nothing is launched."""
    x, wt = _inputs(1, 2, 130, 64, 64, seed=9)
    hexconv_kernel.reset_launch_count()
    with pytest.raises(RuntimeError, match="launch failed"):
        hexconv_kernel.hex_conv_cuda(torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda())
    assert hexconv_kernel.launch_count[hexconv_kernel.KERNELS[torch.float32]] == 0


def _grad_inputs(b, h, w, cin, cout, dtype, seed):
    x, wt = _inputs(b, h, w, cin, cout, seed)
    dy = np.random.default_rng(seed + 1).standard_normal((b, h, w, cout)).astype(np.float32)
    return (torch.from_numpy(a).to("cuda", dtype) for a in (x, wt, dy))


# One bf16 rounding of the output (2^-8 of its value at most) on f32 sums
# taken in another order; f32 sums over up to thousands of pixels in
# another order.
_BACKWARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# (B, H, W, Cin, Cout) of dW cases beyond BACKWARD_RAGGED: every conv shape
# of one 256-filter update and of one 64-filter update (B=256 on 5x5; the
# f32 kernel's plan puts their slices in clusters of 5 and 8), then the
# kernels' edges: Cin and Cout off multiples of 8 and of 4 (2-, 4- and
# 8-byte copies, padded tiles), fewer pixels than one 16-pixel step (one
# cluster, dW written by the kernel), odd and even widths, a 30x30 board,
# Cin past two 64-channel blocks with a ragged last one.
DW_CASES = ([(256, 5, 5, cin, cout) for cin, cout, _ in conv_shapes(256, iterations=4)]
            + [(256, 5, 5, cin, cout) for cin, cout, _ in conv_shapes(64, iterations=4)]
            + [(1, 2, 5, 21, 13), (3, 7, 9, 37, 70), (2, 6, 8, 150, 138), (5, 4, 4, 8, 1),
               (2, 30, 30, 256, 138), (3, 9, 10, 342, 21), (2, 5, 6, 100, 250)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout", list(BACKWARD_RAGGED) + DW_CASES)
def test_dw_kernel_matches_plain_on_card(cuda_card, dtype, b, h, w, cin, cout):
    """The dW kernel against ``hex_conv_dw_plain`` within the dtype's
    tolerance of max|dW| (``_BACKWARD_TOL``), and the same bits on a second
    run (fixed-order sums, no atomics)."""
    x, _, dy = _grad_inputs(b, h, w, cin, cout, dtype, seed=11)
    hexconv_kernel.reset_launch_count()
    got = hexconv_kernel.hex_conv_dw_cuda(x, dy)
    again = hexconv_kernel.hex_conv_dw_cuda(x, dy)
    want = hexconv.hex_conv_dw_plain(x, dy)
    assert hexconv_kernel.launch_count[hexconv_kernel.DW_KERNELS[dtype]] == 2
    assert got.shape == want.shape == (7, cin, cout) and got.dtype == dtype
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _BACKWARD_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.cuda
def test_dw_bf16_kernel_at_the_widest_board_that_fits(cuda_card):
    """The bf16 dW kernel's three halo slabs (128 + 2W + 2 rows of 144 B)
    fit its shared memory beside the dY tiles and tap tables up to W = 134
    at Cout 64: the widest board runs and matches the plain version."""
    cap = hexconv_kernel.hexconv_dw_library().hexconv_dw_max_width(64, 1)
    assert cap == 134
    x, _, dy = _grad_inputs(1, 2, cap, 64, 64, torch.bfloat16, seed=29)
    got = hexconv_kernel.hex_conv_dw_cuda(x, dy)
    want = hexconv.hex_conv_dw_plain(x, dy)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _BACKWARD_TOL[torch.bfloat16] * want.float().abs().max().item()


@pytest.mark.cuda
def test_dw_bf16_kernel_raises_past_the_shared_memory_cap(cuda_card):
    """One column past the cap the bf16 dW kernel refuses the launch: the
    wrapper raises an error naming the cap, and nothing is counted."""
    x, _, dy = _grad_inputs(1, 2, 135, 64, 64, torch.bfloat16, seed=29)
    hexconv_kernel.reset_launch_count()
    with pytest.raises(RuntimeError, match="shared-memory cap .boards up to 134 wide"):
        hexconv_kernel.hex_conv_dw_cuda(x, dy)
    assert sum(hexconv_kernel.launch_count.values()) == 0


@pytest.mark.cuda
def test_dw_f32_kernel_at_the_widest_board_that_fits(cuda_card):
    """The f32 dW kernel's two halo slabs (16 + 2W + 2 rows of 64 channels)
    fit its shared memory beside the dY tiles and tap tables at least up to
    the bf16 kernel's W = 134 at Cout 64: the widest board it takes runs,
    matches the plain version and gives the same bits twice."""
    cap = hexconv_kernel.hexconv_dw_library().hexconv_dw_max_width(64, 0)
    assert cap >= 134
    x, _, dy = _grad_inputs(1, 2, cap, 64, 64, torch.float32, seed=31)
    got = hexconv_kernel.hex_conv_dw_cuda(x, dy)
    again = hexconv_kernel.hex_conv_dw_cuda(x, dy)
    want = hexconv.hex_conv_dw_plain(x, dy)
    assert torch.equal(got, again)
    err = (got - want).abs().max().item()
    assert err <= _BACKWARD_TOL[torch.float32] * want.abs().max().item()


@pytest.mark.cuda
def test_dw_f32_kernel_raises_past_the_shared_memory_cap(cuda_card):
    """One column past its cap the f32 dW kernel refuses the launch: the
    wrapper raises an error naming the cap, and nothing is counted."""
    cap = hexconv_kernel.hexconv_dw_library().hexconv_dw_max_width(64, 0)
    x, _, dy = _grad_inputs(1, 2, cap + 1, 64, 64, torch.float32, seed=31)
    hexconv_kernel.reset_launch_count()
    with pytest.raises(RuntimeError, match=f"shared-memory cap .boards up to {cap} wide"):
        hexconv_kernel.hex_conv_dw_cuda(x, dy)
    assert sum(hexconv_kernel.launch_count.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout", BACKWARD_RAGGED)
def test_dx_path_matches_plain_on_card(cuda_card, dtype, b, h, w, cin, cout):
    """dX as the forward kernel on the mirrored taps (Cin and Cout swapped)
    against ``hex_conv_dx_plain``, within the dtype's tolerance of max|dX|."""
    _, wt, dy = _grad_inputs(b, h, w, cin, cout, dtype, seed=13)
    got = hexconv_kernel.hex_conv_cuda(dy, hexconv.mirror_taps(wt))
    want = hexconv.hex_conv_dx_plain(dy, wt)
    assert got.shape == want.shape == (b, h, w, cin)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _BACKWARD_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.cuda
def test_dw_launch_failure_raises(cuda_card, monkeypatch):
    """A dW launch the C side refuses (here slices that do not cover the
    pixels) raises, and is not counted."""
    x, _, dy = _grad_inputs(2, 5, 5, 8, 8, torch.float32, seed=1)
    monkeypatch.setattr(hexconv_kernel, "dw_slices", lambda *args: (1, 16))
    hexconv_kernel.reset_launch_count()
    with pytest.raises(RuntimeError, match="launch failed"):
        hexconv_kernel.hex_conv_dw_cuda(x, dy)
    assert sum(hexconv_kernel.launch_count.values()) == 0


def _grads(module, outputs):
    sum((o.float() ** 2).sum() for o in outputs).backward()
    return {k: p.grad.detach().cpu() for k, p in module.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hexconv_layer_grad_matches_cpu(cuda_card, dtype):
    """A HexConv layer's weight and input gradients on the card (kernels)
    against the CPU (plain versions), under torch's default TF32 flags,
    within ``_BACKWARD_TOL`` of the largest gradient."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((16, 5, 5, 40)).astype(np.float32))
    cpu = HexConv(40, 24, dtype=dtype)
    card = HexConv(40, 24, dtype=dtype).cuda()
    card.load_state_dict(cpu.state_dict())
    xc, xg = x.clone().requires_grad_(True), x.cuda().requires_grad_(True)
    want, got = _grads(cpu, (cpu(xc),)), _grads(card, (card(xg),))
    want["x"], got["x"] = xc.grad, xg.grad.cpu()
    for k in want:
        assert (got[k] - want[k]).abs().max().item() <= (
            _BACKWARD_TOL[dtype] * want[k].abs().max().item()), k


@pytest.mark.cuda
def test_recurrent_net_grad_matches_cpu(cuda_card):
    """The parameter gradients of a small f32 hex RecurrentNet (16 filters,
    3 iterations) on the card against the CPU, under torch's default TF32
    flags: within 1e-4 of each tensor's largest gradient (f32 sums in
    another order through ~20 layers)."""
    rng = np.random.default_rng(19)
    obs = torch.from_numpy((rng.random((8, 86, 5, 5)) < 0.2).astype(np.float32))
    cpu = RecurrentNet(86, 21, num_filters=16, num_blocks=2)
    card = RecurrentNet(86, 21, num_filters=16, num_blocks=2).cuda()
    card.load_state_dict(cpu.state_dict())
    hexconv_kernel.reset_launch_count()
    want = _grads(cpu, cpu(obs, 3)[0])
    got = _grads(card, card(obs.cuda(), 3)[0])
    assert hexconv_kernel.launch_count[hexconv_kernel.DW_KERNELS[torch.float32]] == 1 + 3 * 5 + 6
    ratios = {k: (got[k] - want[k]).abs().max().item() / want[k].abs().max().item()
              for k in want}
    over = {k: r for k, r in ratios.items() if r > 1e-4}
    assert not over, "gradients over 1e-4 of their tensor's largest: " + ", ".join(
        f"{k} {r:.2e}" for k, r in sorted(over.items(), key=lambda kv: -kv[1]))


SCENARIO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "scenarios", "open_field_5.yml")


def _selfplay(dtype, seed=1, scenario=SCENARIO, turns=None, randomize_vp=False):
    """A small self-play setup on the card: SCS open_field_5, B=4, an
    8-filter net, 3 simulations with carried trees, training draws."""
    env = SCSGame(load_scenario(scenario, seed=42, turns=turns), randomize_vp=randomize_vp,
                  device="cuda")
    mgr = NetworkManager(RecurrentNet(env.observation_shape[0], env.action_space_shape[0],
                                      num_filters=8, num_blocks=2, recall=True, hex=True,
                                      dtype=dtype).cuda(), env.observation_shape)

    def apply(variables, obs):
        p, v, _ = mgr.apply(variables, obs, iters_to_do=2)
        return p, v

    params = mcts.SearchParams(num_simulations=3)
    step = make_selfplay_step(env, apply, params, training=True)
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))
    sp = init_selfplay(env, 4, torch.Generator(device="cuda").manual_seed(seed),
                       search_params=params)
    return step, variables, sp


def _snapshot(sp, finished, stats):
    return {k: v.clone() for k, v in move_tensors(sp, finished, stats).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replayed_moves_equal_eager_moves(cuda_card, dtype):
    """Three replays of the captured move equal three eager moves from the
    same state and generator state, bit for bit, with no host read inside
    a replay."""
    step, variables, eager_sp = _selfplay(dtype)
    _, _, graph_sp = _selfplay(dtype)
    want = [_snapshot(eager_sp, *play_in_place(step, variables, eager_sp)) for _ in range(3)]
    graph = capture_selfplay_step(step, variables, graph_sp)
    got = []
    for _ in range(3):
        torch.cuda.set_sync_debug_mode("error")
        try:
            finished, stats = graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got.append(_snapshot(graph_sp, finished, stats))
    graph.check_overflow()
    for move, (g, w) in enumerate(zip(got, want)):
        for name in w:
            assert torch.equal(g[name], w[name]), f"move {move}: {name}"


@pytest.mark.cuda
def test_randomize_vp_replays_equal_eager_moves(cuda_card):
    """With per-game victory points (``solo_scout_5.yml`` cut to two turns,
    so games end and are recycled): eight replays of the captured move
    equal eight eager moves bit for bit, the generator's state included, with no
    host read inside a replay, and recycled games restart on layouts drawn
    inside the move."""
    solo = os.path.join(os.path.dirname(SCENARIO), "solo_scout_5.yml")
    setup = dict(scenario=solo, turns=2, randomize_vp=True)
    step, variables, eager_sp = _selfplay(torch.float32, **setup)
    _, _, graph_sp = _selfplay(torch.float32, **setup)
    first = eager_sp.games.vp.clone()
    want = [_snapshot(eager_sp, *play_in_place(step, variables, eager_sp)) for _ in range(8)]
    graph = capture_selfplay_step(step, variables, graph_sp)
    for move in range(8):
        torch.cuda.set_sync_debug_mode("error")
        try:
            finished, stats = graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = _snapshot(graph_sp, finished, stats)
        for name in want[move]:
            assert torch.equal(got[name], want[move][name]), f"move {move}: {name}"
    graph.check_overflow()
    recycled = [(w["move_count"] == 0) for w in want]
    assert any(bool(r.any()) for r in recycled)
    assert any(bool((w["games.vp"][r] != first[r]).any()) for w, r in zip(want, recycled))


@pytest.mark.cuda
def test_run_while_runs_on_the_device_until_its_condition_or_bound(cuda_card):
    """One capture, replayed with the loop's limit 0, 5 and past the bound
    of 8 trips: the body is skipped, runs 5 times, stops at 8."""
    y = torch.zeros((), device="cuda")
    x = torch.zeros((), device="cuda")
    limit = torch.zeros((), device="cuda")
    graph = torch.cuda.CUDAGraph()
    with graphs.capture(graph):
        y.zero_()
        graphs.run_while(lambda: y < limit, lambda: y.add_(1), 8)
        x.copy_(y + 100)
    got = []
    for value in (0.0, 5.0, 100.0):
        limit.fill_(value)
        graph.replay()
        got.append((y.item(), x.item()))
    assert got == [(0.0, 100.0), (5.0, 105.0), (8.0, 108.0)]


@pytest.mark.cuda
def test_capture_raises_on_a_cpu_tensor(cuda_card):
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(ValueError, match="0-d bool CUDA tensor"):
        with graphs.capture(graph):
            graphs.run_while(lambda: torch.tensor(True), lambda: None, 1)
    step, variables, _ = _selfplay(torch.float32)
    env = SCSGame(load_scenario(SCENARIO, seed=42), device="cpu")
    sp = init_selfplay(env, 4, torch.Generator().manual_seed(1),
                       search_params=mcts.SearchParams(num_simulations=3))
    with pytest.raises(ValueError, match="CUDA device"):
        capture_selfplay_step(step, variables, sp)


@pytest.mark.cuda
def test_an_overflow_raises_after_the_replay(cuda_card, monkeypatch):
    """One gamma round cannot accept every root-noise entry: the eager
    move raises at once; the replay sets the flag on the device and
    ``check_overflow`` raises after it."""
    monkeypatch.setattr(mcts, "GAMMA_ROUNDS", 1)
    step, variables, sp = _selfplay(torch.float32)
    with pytest.raises(OverflowError, match="gamma"):
        step(variables, _selfplay(torch.float32)[2])
    graph = capture_selfplay_step(step, variables, sp)
    graph.check_overflow()  # not set before a replay
    graph.replay()
    with pytest.raises(OverflowError, match="self-play move"):
        graph.check_overflow()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("family", ["ConvNet", "ResNet"])
def test_zoo_kernel_path_matches_plain_on_card(cuda_card, family, dtype):
    """ConvNet(num_layers=2) and ResNet(num_blocks=4), hex, 16 filters: on
    the card (the hex-conv kernels, 9 and 15 launches) against the same
    weights on the CPU (the plain path), within 1e-4 (f32) or 2e-2 (bf16)
    of the output scale."""
    from nuzero_tpu_torch.networks.convnet import ConvNet
    from nuzero_tpu_torch.networks.resnet import ResNet

    def make(device):
        env = SCSGame(load_scenario(SCENARIO, seed=42), device=device)
        c, a = env.observation_shape[0], env.action_space_shape[0]
        net = (ConvNet(c, a, num_filters=16, num_layers=2, dtype=dtype) if family == "ConvNet"
               else ResNet(c, a, num_filters=16, num_blocks=4, dtype=dtype))
        return env, NetworkManager(net.to(device), env.observation_shape)

    env, mgr = make("cuda")
    _, cpu_mgr = make("cpu")
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))
    obs = env.observe(env.init(8))
    hexconv_kernel.reset_launch_count()
    with torch.no_grad():
        p, v, _ = mgr.apply(variables, obs)
        p_ref, v_ref, _ = cpu_mgr.apply({k: t.cpu() for k, t in variables.items()}, obs.cpu())
    assert hexconv_kernel.launch_count[hexconv_kernel.KERNELS[dtype]] == (
        9 if family == "ConvNet" else 15)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in ((p, p_ref), (v, v_ref)):
        scale = max(float(want.abs().max()), 0.1)
        assert float((got.cpu() - want).abs().max()) <= rel * scale


@pytest.mark.cuda
def test_ttt_replayed_moves_equal_eager_moves(cuda_card):
    """Tic-Tac-Toe with an MLP, B=8, 8 simulations, carried trees: three
    replays of the captured move equal three eager moves bit for bit."""
    from nuzero_tpu_torch.envs.tictactoe import TicTacToe
    from nuzero_tpu_torch.networks.mlp import MLPNetwork

    env = TicTacToe("cuda")
    mgr = NetworkManager(MLPNetwork(env.observation_shape, 9).cuda(), env.observation_shape)

    def apply(variables, obs):
        p, v, _ = mgr.apply(variables, obs)
        return p, v

    params = mcts.SearchParams(num_simulations=8)
    step = make_selfplay_step(env, apply, params, training=True)
    variables = mgr.init(torch.Generator(device="cuda").manual_seed(0))

    def fresh():
        return init_selfplay(env, 8, torch.Generator(device="cuda").manual_seed(1),
                             search_params=params)

    eager_sp, graph_sp = fresh(), fresh()
    want = [_snapshot(eager_sp, *play_in_place(step, variables, eager_sp)) for _ in range(3)]
    graph = capture_selfplay_step(step, variables, graph_sp)
    for move in range(3):
        torch.cuda.set_sync_debug_mode("error")
        try:
            finished, stats = graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = _snapshot(graph_sp, finished, stats)
        for name in want[move]:
            assert torch.equal(got[name], want[move][name]), f"move {move}: {name}"
    graph.check_overflow()


@pytest.mark.cuda
def test_async_eval_jobs_beside_captured_selfplay(cuda_card, tmp_path):
    """A TTT run with early, per-step policy and MCTS tests on the worker
    thread: the step-0 job is pending when step 1 captures the self-play
    graph, later jobs run beside its replays; every job is harvested under
    its launch step."""
    from nuzero_tpu_torch.config.schemas import (
        LearningConfig, PlottingConfig, RunningConfig, TestingFrequencyConfig, TrainingConfig,
    )
    from nuzero_tpu_torch.envs.tictactoe import TicTacToe
    from nuzero_tpu_torch.networks.mlp import MLPNetwork
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    env = TicTacToe("cuda")
    mgr = NetworkManager(MLPNetwork(env.observation_shape, 9).cuda(), env.observation_shape)
    cfg = TrainingConfig(
        running=RunningConfig(num_actors=16, early_fill_per_type=8, training_steps=3,
                              num_games_per_type_per_step=8),
        testing=TestingFrequencyConfig(asynchronous_testing=True, early_testing=True,
                                       policy_test_frequency=1, mcts_test_frequency=1,
                                       num_policy_test_games=32, num_mcts_test_games=8),
        plotting=PlottingConfig(plot_loss=False),
        learning=LearningConfig(replay_window_size=64, batch_size=32, num_samples=2),
    )
    az = AlphaZero(env, mgr, cfg, mcts.SearchParams(num_simulations=8), run_dir=str(tmp_path))
    az.run(seed=0)
    records = az.journal.load()
    tests = [r for r in records if r.get("async_test")]
    assert [r["step"] for r in tests] == [0, 1, 2, 3]
    for r in tests:
        assert {f"{m}/{t}_as_p{s}" for m in ("wr", "nonloss") for t in ("policy", "mcts")
                for s in (0, 1)} <= set(r)
    assert len(az._graphs) == 2 and not az._pending_tests
    assert [r["step"] for r in records if "games" in r] == [1, 2, 3]


def _solo_coordinator(device, cfg, filters=16, randomize_vp=(True,)):
    """A coordinator on ``solo_scout_5.yml`` (one env per entry of
    ``randomize_vp``) with the solo state set and an f32 hex RecurrentNet."""
    from nuzero_tpu_torch.evaluation import solo_state_set
    from nuzero_tpu_torch.training.pipeline import AlphaZero

    path = os.path.join(os.path.dirname(SCENARIO), "solo_scout_5.yml")
    envs = [SCSGame(load_scenario(path, seed=42), randomize_vp=r, device=device)
            for r in randomize_vp]
    net = RecurrentNet(envs[0].observation_shape[0], envs[0].action_space_shape[0],
                       num_filters=filters, num_blocks=2).to(device)
    return AlphaZero(envs if len(envs) > 1 else envs[0],
                     NetworkManager(net, envs[0].observation_shape), cfg,
                     mcts.SearchParams(num_simulations=2), state_set=solo_state_set(envs[0]))


@pytest.mark.cuda
def test_probe_values_and_weight_stats_match_cpu(cuda_card):
    """The value probes on the card (27 launches of the f32 kernel at 4
    prediction iterations) within 1e-5 of max|v| of the CPU's on the same
    parameters, and the weight stats within 1e-6 of ``abs_max``."""
    from nuzero_tpu_torch.config.schemas import RecurrentOptions, TrainingConfig

    cfg = TrainingConfig(recurrent=RecurrentOptions(train_iterations=(4,),
                                                    pred_iterations=(4,)))
    card, cpu = _solo_coordinator("cuda", cfg), _solo_coordinator("cpu", cfg)
    params = card.learner.init_state(torch.Generator(device="cuda").manual_seed(3)).params
    hexconv_kernel.reset_launch_count()
    got = card.probe_values(params)
    assert hexconv_kernel.launch_count == {**{k: 0 for k in hexconv_kernel.launch_count},
                                           "hexconv_f32_kernel": 27}
    want = cpu.probe_values({k: v.cpu() for k, v in params.items()})
    scale = max(abs(v) for v in want)
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-5 * scale
    got_w = card.weight_stats(params)
    want_w = cpu.weight_stats({k: v.cpu() for k, v in params.items()})
    assert max(abs(a - b) for a, b in zip(got_w, want_w)) <= 1e-6 * want_w[0]


@pytest.mark.cuda
def test_two_game_types_launch_their_own_iteration_counts(cuda_card):
    """Two solo types (fixed and per-game victory points) at 4 and 6
    prediction iterations: each type's graph is its own, every network
    evaluation of type 0 launches the f32 kernel 27 times and of type 1
    37 times, and the buffer holds both types."""
    from nuzero_tpu_torch.config.schemas import (
        LearningConfig, PlottingConfig, RecurrentOptions, RunningConfig, TrainingConfig,
    )

    cfg = TrainingConfig(
        running=RunningConfig(num_actors=16, early_fill_per_type=4, training_steps=1,
                              num_games_per_type_per_step=4),
        learning=LearningConfig(replay_window_size=64, batch_size=16, num_samples=1),
        recurrent=RecurrentOptions(train_iterations=(4, 6), pred_iterations=(4, 6)),
        plotting=PlottingConfig(plot_loss=False),
    )
    az = _solo_coordinator("cuda", cfg, randomize_vp=(False, True))
    per_eval = {}
    apply = az.manager.apply

    def counted(variables, obs, iters_to_do=2, interim_thought=None):
        before = hexconv_kernel.launch_count["hexconv_f32_kernel"]
        out = apply(variables, obs, iters_to_do, interim_thought)
        per_eval.setdefault(iters_to_do, set()).add(
            hexconv_kernel.launch_count["hexconv_f32_kernel"] - before)
        return out

    az.manager.apply = counted
    az.run(seed=0)
    assert per_eval == {4: {27}, 6: {37}}
    graphs = [az._graphs[step] for step in az.sp_steps]
    assert graphs[0] is not graphs[1] and graphs[0].sp is not graphs[1].sp
    assert len(az._graphs) == 4
    assert set(az.buffer.game_type[az.buffer.length > 0].tolist()) == {0, 1}


@pytest.mark.cuda
def test_ttt_milestone_policy_rate_on_card(cuda_card):
    """The committed ``ttt_long_r3c`` export's raw policy on the card against
    the random agent, 1,024 games a seat: no loss as P1 and a non-loss rate
    of at least 0.98 as P0, the JAX run's worst evaluation of its policy
    after step 75 (``tests/test_torch_transfer.py`` holds the same bars on
    the CPU; there the port loses ~0.5% as P0).  Its network is a
    ``RecurrentNet(hex=False)`` of square 3x3 convs, so no hex-conv kernel
    runs."""
    from nuzero_tpu_torch.config.run_meta import build_from_meta, load_run_meta
    from nuzero_tpu_torch.evaluation import PolicyAgent, RandomAgent, TestManager
    from nuzero_tpu_torch.utils.checkpoint import restore_checkpoint

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    asset = os.path.join(repo, "nuzero_tpu_torch", "assets", "runs", "ttt_long_r3c")
    env, mgr = build_from_meta(load_run_meta(asset), repo, device="cuda")
    params = restore_checkpoint(os.path.join(asset, "checkpoints"), device="cuda")[0]["params"]
    tm = TestManager(env)
    agent = PolicyAgent(mgr, params)
    hexconv_kernel.reset_launch_count()
    as_p0 = tm.run_test_batch(1024, agent, RandomAgent(), show_results=False)
    as_p1 = tm.run_test_batch(1024, RandomAgent(), agent, show_results=False)
    assert as_p1.p0_wins == 0, as_p1
    assert (as_p0.p0_wins + as_p0.draws) / 1024 >= 0.98, as_p0
    assert sum(hexconv_kernel.launch_count.values()) == 0
