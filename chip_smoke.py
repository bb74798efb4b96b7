"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: print the card's name and power limit; build the hex-conv
   kernel library from ``nuzero_tpu_torch/ops/cuda/csrc``;
2. kernel check: the CUDA hex conv against its plain PyTorch version at
   every conv shape of the two self-play legs, plus a 10x10 and a 30x30
   board, with kernel and plain times taken in turns with CUDA events;
3. network check: both legs' RecurrentNet on the card (kernel) against
   the same weights on the CPU (plain version) on a small batch;
4. self-play, 256 filters, bf16 compute, B=768, and
5. self-play, 64 filters, f32, B=512: ``init_selfplay`` then four moves
   of ``make_selfplay_step`` (SCS ``open_field_5.yml``, seed 42,
   ``RecurrentNet(policy_channels=21, num_blocks=2, recall=True,
   hex=True)``, 2 iterations, 30 simulations with carried trees,
   ``training=True``; random weights from a seed).  Each leg checks the
   move counter, the legality of every played action, that policy targets
   are distributions over the legal actions, and that the kernel ran
   17 times per network evaluation.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SIMS = 30
MOVES = 4
CONVS_PER_EVAL = 17
KERNEL_SOURCE = "nuzero_tpu_torch/ops/cuda/csrc/hexconv.cu"
REPLACES = "nuzero_tpu/ops/pallas/hexconv_kernel.py:91"
# (filters, dtype name, batch) of the two self-play legs.
LEGS = ((256, "bfloat16", 768), (64, "float32", 512))


def log(*args):
    print(*args, flush=True)


def conv_shapes(filters: int, obs_channels: int = 86, policy_channels: int = 21):
    """(Cin, Cout, count) of the hex convs of one RecurrentNet evaluation
    at 2 iterations, 2 blocks, recall."""
    from nuzero_tpu_torch.networks.blocks import _ramp

    shapes = [(obs_channels, filters, 1), (filters + obs_channels, filters, 2),
              (filters, filters, 8)]
    for head in (_ramp(filters, policy_channels, 2), _ramp(filters, 1, 4)):
        ins = [filters] + list(head[:-1])
        shapes += [(i, o, 1) for i, o in zip(ins, head)]
    assert sum(n for _, _, n in shapes) == CONVS_PER_EVAL
    return shapes


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_check(dtype, batch, rows, cols, cin, cout, gen):
    """Kernel vs plain on one shape -> (err, max|y|, kernel ms, plain ms)."""
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
    # Plain, kernel, kernel, plain.
    reps = 20
    p1 = time_ms(lambda: hex_conv_plain(x, w), reps)
    k1 = time_ms(lambda: hex_conv_cuda(x, w), reps)
    k2 = time_ms(lambda: hex_conv_cuda(x, w), reps)
    p2 = time_ms(lambda: hex_conv_plain(x, w), reps)
    return err, scale, (k1 + k2) / 2, (p1 + p2) / 2


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


def selfplay_leg(filters, dtype, batch):
    """Run the self-play moves; returns (launches, evals, seconds per move)."""
    import torch

    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.ops.cuda import hexconv_kernel
    from nuzero_tpu_torch.search.mcts import SearchParams
    from nuzero_tpu_torch.training.selfplay import init_selfplay, make_selfplay_step

    class CheckedSCSGame(SCSGame):
        """Records the legal mask of each played position and checks the
        played action against it."""

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
    sp = init_selfplay(env, batch, torch.Generator(device="cuda").manual_seed(1),
                       search_params=params)
    step = make_selfplay_step(env, apply, params, training=True)
    torch.cuda.synchronize()

    seconds = []
    bi = torch.arange(batch, device="cuda")
    hexconv_kernel.reset_launch_count()
    evals = 0
    for move in range(MOVES):
        before = int(sp.total_moves)
        row = sp.move_count.long()
        env.watch = sp.games
        t0 = time.perf_counter()
        sp, finished, stats = step(variables, sp)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if int(sp.total_moves) != before + batch:
            raise AssertionError("total_moves did not grow by B")
        if env.played_legal is None:
            raise AssertionError("the played move was not observed")
        policy = sp.policy_buf[bi, row]
        legal = env.played_legal
        on_legal = (policy * legal).sum(-1)
        if not (torch.allclose(on_legal, torch.ones_like(on_legal), atol=1e-5)
                and float((policy * ~legal).abs().sum()) == 0.0):
            raise AssertionError("policy targets are not distributions over legal actions")
        if not bool(torch.isfinite(finished.final_value).all()):
            raise AssertionError("non-finite final values")
        if not torch.isfinite(stats["root_value_mean"]):
            raise AssertionError("non-finite root values")
        env.watch = env.played_legal = None
        log(f"leg {filters}f {dtype} B={batch} move {move}: {seconds[-1]:.4f} s, "
            f"root_value_mean {float(stats['root_value_mean']):+.4f}, "
            f"tree_nodes_mean {float(stats['tree_nodes_mean']):.2f}")
    counts = dict(hexconv_kernel.launch_count)
    if evals != (1 + SIMS) * MOVES:
        raise AssertionError(f"{evals} network evaluations, expected {(1 + SIMS) * MOVES}")
    expected = {name: 0 for name in counts}
    expected[hexconv_kernel.KERNELS[dtype]] = CONVS_PER_EVAL * evals
    if counts != expected:
        raise AssertionError(f"kernel launches {counts}, expected {expected}")
    return counts[hexconv_kernel.KERNELS[dtype]], evals, seconds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from nuzero_tpu_torch.ops.cuda.build import hexconv_library
    from nuzero_tpu_torch.ops.cuda.hexconv_kernel import KERNELS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    hexconv_library()
    log(f"built hex-conv kernel library in {time.perf_counter() - t0:.1f} s")

    # --- 2. kernel check
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_dtype = {}
    for filters, dtype_name, batch in LEGS:
        dtype = getattr(torch, dtype_name)
        k_eval = p_eval = 0.0
        worst = 0.0
        for cin, cout, count in conv_shapes(filters):
            err, scale, k_ms, p_ms = kernel_check(dtype, batch, 5, 5, cin, cout, gen)
            log(f"kernel {dtype_name} B={batch} 5x5 {cin}->{cout} (x{count}): "
                f"max abs err {err:.3e} (max|y| {scale:.3e}); kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms  [{card}]")
            k_eval += count * k_ms
            p_eval += count * p_ms
            worst = max(worst, err)
        per_dtype[dtype_name] = (worst, k_eval, p_eval)
        log(f"kernel {dtype_name} per {filters}f network evaluation (17 convs): "
            f"kernel {k_eval:.4f} ms, plain {p_eval:.4f} ms  [{card}]")
    for dtype_name, batch, rows, cin, cout in (("float32", 256, 10, 64, 64),
                                               ("float32", 64, 30, 64, 64)):
        dtype = getattr(torch, dtype_name)
        err, scale, k_ms, p_ms = kernel_check(dtype, batch, rows, rows, cin, cout, gen)
        log(f"kernel {dtype_name} B={batch} {rows}x{rows} {cin}->{cout}: max abs err "
            f"{err:.3e} (max|y| {scale:.3e}); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms  [{card}]")
        per_dtype[dtype_name] = (max(per_dtype[dtype_name][0], err),) + per_dtype[dtype_name][1:]

    # --- 3. network check
    for filters, dtype_name, _ in LEGS:
        network_check(filters, getattr(torch, dtype_name))

    # --- 4./5. self-play legs
    kernels = []
    for filters, dtype_name, batch in LEGS:
        launches, evals, seconds = selfplay_leg(filters, getattr(torch, dtype_name), batch)
        steady = statistics.median(seconds[1:])
        log(f"leg {filters}f {dtype_name} B={batch}: first move {seconds[0]:.4f} s, "
            f"steady {steady:.4f} s/move (median of moves 2-{MOVES}), "
            f"{batch * SIMS / steady:.1f} env-steps/s; {evals} network evaluations, "
            f"{launches} kernel launches  [{card}]")
        worst, k_eval, p_eval = per_dtype[dtype_name]
        kernels.append({
            "name": KERNELS[getattr(torch, dtype_name)],
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": launches,
            "max_abs_err": worst,
            "ms": k_eval,
            "plain_ms": p_eval,
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
