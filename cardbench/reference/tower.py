"""Plain reference of AlphaZero's batch-norm residual tower (Silver et al.,
Nature 550:354, 2017, Methods; Science 362:1140, 2018) as NuZero runs it
(upstream ``Neural_Networks/Architectures/ResNet.py``), in f32: the
benchmark's frozen copy of ``tests/plain_az_tower.py``'s forward with the
running statistics, on a dict of parameters under the port's names.

Stem conv, batch norm, relu; ``num_blocks`` blocks of conv, batch norm,
relu, conv, skip, relu; the reduce policy head (2 convs, a batch norm and
relu between) and the reduce value head (4 convs, batch norm and tanh
between, tanh of the global mean).  Departures from the papers: hex 7-tap
convs on SCS boards, NuZero's block (one norm, after its first conv) and
reduce heads, no conv biases.  The hex conv and the ``quant`` controls are
``net.py``'s.

Also here: the tower's hex convs for the yardstick (``evaluation_convs``),
the seeded weights (``draw_params``) and the tree judge of the self-play
cells with the tower in the recurrent net's place (``judge_trees``, a copy
of ``selfplay.judge_trees``).  Nothing here imports the port.
"""

from __future__ import annotations

import torch

from cardbench.reference import measure
from cardbench.reference import net as ref_net
from cardbench.reference import selfplay as ref_selfplay
from cardbench.reference.scs.base import select_state

EPS = 1e-5
#: The scale of each head's last conv (of its initializer's bound).  At the
#: full bound the drawn tower prefers some action planes and values from seed
#: to seed (logits' spread ~0.37, values' ~0.1), its search and its games
#: take a course of their own, and a move's time differs by up to ~20% from
#: seed to seed.  At 1/32 its priors are near uniform and its values near
#: zero (~0.012 and ~0.003, as the recurrent configurations' draws give), as
#: a net's are at the start of training.
HEAD_SCALE = 1.0 / 32


def layout(in_channels: int, policy_channels: int, filters: int, blocks: int):
    """([(name, shape)] of the parameters, [(name, shape)] of the buffers)
    under the port's names."""
    params = [("stem.conv.weight", (7, in_channels, filters))]
    norms = [("stem_norm", filters)]
    for i in range(blocks):
        params += [(f"blocks.{i}.conv1.conv.weight", (7, filters, filters)),
                   (f"blocks.{i}.conv2.conv.weight", (7, filters, filters))]
        norms.append((f"blocks.{i}.norm", filters))
    for head, sizes in (("policy_head", measure.ramp(filters, policy_channels, 2)),
                        ("value_head", measure.ramp(filters, 1, 4))):
        for i, (cin, cout) in enumerate(zip([filters] + sizes[:-1], sizes)):
            params.append((f"{head}.convs.{i}.conv.weight", (7, cin, cout)))
            if i < len(sizes) - 1:
                norms.append((f"{head}.norms.{i}", cout))
    params += [(f"{n}.{p}", (w,)) for n, w in norms for p in ("weight", "bias")]
    buffers = [(f"{n}.{b}", (w,)) for n, w in norms for b in ("running_mean", "running_var")]
    return params, buffers


def evaluation_convs(filters: int, obs_channels: int, policy_channels: int, blocks: int):
    """[(Cin, Cout)] of every hex conv of one evaluation: 2 * blocks + 7."""
    params, _ = layout(obs_channels, policy_channels, filters, blocks)
    return [(shape[1], shape[2]) for _, shape in params if len(shape) == 3]


def forward(params, obs: torch.Tensor, quant=None, calibrate: bool = False):
    """(policy logits [B, A], value [B]) of observations ``obs`` [B, C, H, W]
    with the running statistics, f32.  ``calibrate`` first sets each norm's
    running mean and unbiased variance in ``params`` to those of its input
    over the batch, layer by layer."""
    def conv(name, x):
        return ref_net.hex_conv(x, params[name], quant)

    def bn(name, x):
        if calibrate:
            var, mean = torch.var_mean(x, dim=(0, 1, 2), unbiased=True)
            params[f"{name}.running_mean"], params[f"{name}.running_var"] = mean, var
        scale = torch.rsqrt(params[f"{name}.running_var"] + EPS) * params[f"{name}.weight"]
        return (x - params[f"{name}.running_mean"]) * scale + params[f"{name}.bias"]

    x = obs.permute(0, 2, 3, 1).float()
    x = torch.relu(bn("stem_norm", conv("stem.conv.weight", x)))
    blocks = sorted({int(k.split(".")[1]) for k in params if k.startswith("blocks.")})
    for i in blocks:
        h = torch.relu(bn(f"blocks.{i}.norm", conv(f"blocks.{i}.conv1.conv.weight", x)))
        x = torch.relu(conv(f"blocks.{i}.conv2.conv.weight", h) + x)
    heads = {}
    for head, act in (("policy_head", torch.relu), ("value_head", torch.tanh)):
        n = len([k for k in params if k.startswith(f"{head}.convs.")])
        y = x
        for i in range(n):
            y = conv(f"{head}.convs.{i}.conv.weight", y)
            if i != n - 1:
                y = act(bn(f"{head}.norms.{i}", y))
        heads[head] = y
    p = heads["policy_head"]
    return (p.permute(0, 3, 1, 2).reshape(p.shape[0], -1),
            torch.tanh(heads["value_head"].mean(dim=(1, 2, 3))))


def evaluate(params, obs, quant=None, block: int = 2048):
    """``forward`` in blocks of ``block`` rows, without autograd."""
    logits, values = [], []
    with torch.no_grad():
        for s in range(0, obs.shape[0], block):
            lg, v = forward(params, obs[s:s + block], quant)
            logits.append(lg)
            values.append(v)
    return torch.cat(logits), torch.cat(values)


def positions(ref, seed: int, n: int = 512, plies: int = 40) -> torch.Tensor:
    """Observations of ``n`` positions drawn from the seed among those that
    ``n`` games of random legal play reach in their first ``plies`` moves
    (finished games stay where they ended and are not drawn again).  The
    draws are ``torch.rand``'s, which repeat on the card (its
    ``torch.multinomial`` does not)."""
    env = ref.env
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state = env.init(n, generator=gen)
    pool = []
    for _ in range(plies):
        done = env.terminal(state)
        pool.append(env.observe(state)[~done])
        u = torch.rand((n, env.num_actions), generator=gen, device=env.device)
        action = torch.where(env.legal_mask(state), u, -1.0).argmax(-1).to(torch.int32)
        state = select_state(done, state, env.step(state, action))
    pool = torch.cat(pool)
    order = torch.rand(pool.shape[0], generator=gen, device=pool.device).argsort()
    return pool[order[:n]]


def draw_params(params_layout, seed: int, device, obs: torch.Tensor) -> dict:
    """Fresh f32 parameters of the tower, drawn on the device from ``seed``
    in one call, uniform u in (-1, 1): each hex-conv weight [7, Cin, Cout]
    at the port's initializer bound, u * sqrt(1 / (7 * Cin)), as
    ``harness.draw_params``, the heads' last at ``HEAD_SCALE`` of it; each
    norm's scale 1 + u / 2 and bias u / 4.
    The running statistics are the batch statistics of ``obs`` (``positions``)
    at each norm's input, layer by layer, so that the activations stay
    normalized through the depth as a trained net's are.  ``params_layout``
    is ``layout``'s first list."""
    heads = {}
    for name, shape in params_layout:
        if len(shape) == 3 and name.startswith(("policy_head.", "value_head.")):
            heads[name.split(".")[0]] = name
    total = sum(torch.Size(s).numel() for _, s in params_layout)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in params_layout:
        u = flat[at:at + torch.Size(shape).numel()].view(shape)
        at += u.numel()
        if len(shape) == 3:
            scale = HEAD_SCALE if name in heads.values() else 1.0
            out[name] = (u * (scale / (7 * shape[1]) ** 0.5)).clone()
        elif name.endswith(".weight"):
            out[name] = 1.0 + 0.5 * u
        else:
            out[name] = 0.25 * u
    with torch.no_grad():
        forward(out, obs, calibrate=True)
    return out


def judge_trees(tree: dict, ref, params, control=None) -> dict:
    """``selfplay.judge_trees`` with the tower evaluated on every live node
    (a copy; there the recurrent net is evaluated): the readings of the
    sampled trees, and under ``"control"`` the tower one precision lower."""
    free, root = tree["free"], tree["root"]
    G, N = free.shape
    dev = free.device
    visit = tree["visit"]
    idx = torch.arange(N, device=dev).expand(G, N)
    is_root = idx == root[:, None].long()
    alloc = ~free
    wrong = int((free & is_root).sum())
    blocks = ref_selfplay._blocks

    # -- Edges: every allocated node but the root is its parent's step. ----
    nodes = alloc & ~is_root
    g, c = nodes.nonzero(as_tuple=True)
    p = tree["parent"][g, c].long()
    wrong += int((p < 0).sum())
    ok = p >= 0
    g, c, p = g[ok], c[ok], p[ok]
    wrong += int(free[g, p].sum())
    hits = tree["child"][g, p] == c[:, None].to(tree["child"].dtype)
    wrong += int((hits.sum(-1) != 1).sum())
    one = hits.sum(-1) == 1
    g, c, p, a = g[one], c[one], p[one], hits[one].float().argmax(-1)
    nxt, term, tval = ref_selfplay._step_packed(ref, tree["states"][g, p], a)
    wrong += int((nxt != tree["states"][g, c, :ref.dim]).any(-1).sum())
    wrong += int(((tval != tree["terminal_value"][g, c]) & term).sum())

    # -- Every allocated node, roots too: legal mask and terminal flag. ----
    ga, ca = alloc.nonzero(as_tuple=True)
    states = tree["states"][ga, ca]
    legal = ref_selfplay._legal(ref, states)
    wrong += int((legal != tree["legal"][ga, ca]).any(-1).sum())
    term_a = torch.cat([ref.env.terminal(ref.unpack(states[sl, :ref.dim]))
                        for sl in blocks(states.shape[0])]) if states.shape[0] else (
        torch.zeros(0, dtype=torch.bool, device=dev))
    tval_a = torch.cat([ref.env.terminal_value(ref.unpack(states[sl, :ref.dim]))
                        for sl in blocks(states.shape[0])]) if states.shape[0] else (
        torch.zeros(0, device=dev))
    wrong += int((term_a != tree["is_terminal"][ga, ca]).sum())

    # -- Visits. ------------------------------------------------------------
    cv, cs, has_child = ref_selfplay._children(tree)
    v_a, cv_a = visit[ga, ca], cv[ga, ca]
    visits_wrong = int(((v_a < 1) | (~term_a & (v_a < 1 + cv_a))
                        | (term_a & has_child[ga, ca])).sum())

    # -- The tower on every live node, as the reference computes it. -------
    live = ~term_a & (legal == tree["legal"][ga, ca]).all(-1)
    values = torch.where(term_a, tval_a.double(), 0.0)
    low_values = values.clone()
    out = {"transitions_wrong": wrong, "visits_wrong": visits_wrong, "prior_gap": 0.0,
           "value_gap": 0.0, "backup_gap": 0.0, "nodes_compared": 0, "values_compared": 0,
           "backups_compared": 0}
    low = {"prior_gap": 0.0, "value_gap": 0.0, "backup_gap": 0.0}
    if live.any():
        obs = torch.cat([ref.env.observe(ref.unpack(states[live][sl, :ref.dim]))
                         for sl in blocks(int(live.sum()))])
        logits, v = evaluate(params, obs)
        values[live] = v.double()
        want = ref_net.masked_log_priors(logits, legal[live])
        pr = ~is_root[ga, ca][live]
        gl, cl = ga[live][pr], ca[live][pr]
        got = torch.log(tree["prior"][gl, cl].double().clamp(min=1e-300))
        out["prior_gap"] = float(torch.where(legal[live][pr], (got - want[pr]).abs(), 0.0)
                                 .max()) if pr.any() else 0.0
        out["nodes_compared"] = int(pr.sum())
        if control is not None:
            lg_low, v_low = evaluate(params, obs, control)
            low_values[live] = v_low.double()
            got_low = ref_net.masked_log_priors(lg_low, legal[live])
            low["prior_gap"] = float(torch.where(legal[live][pr], (got_low - want).abs()[pr],
                                                 0.0).max()) if pr.any() else 0.0
    single = live & (v_a == 1)
    few = (v_a >= 2) & (v_a <= ref_selfplay.BACKUP_VISITS) & (live | term_a)
    scale = float(values[live].pow(2).mean().sqrt().clamp(min=1e-30)) if live.any() else 1.0

    def rms(x):
        return float(x.pow(2).mean().sqrt()) / scale

    def widest(x):
        return float(x.abs().max()) / scale

    if single.any():
        err = tree["value_sum"][ga, ca][single].double() - values[single]
        low_err = low_values[single] - values[single]
        out.update(value_gap=rms(err), value_gap_max=widest(err))
        low.update(value_gap=rms(low_err), value_gap_max=widest(low_err))
    out["values_compared"] = int(single.sum())
    if few.any():
        credits = (v_a - cv_a).double()[few]
        own = tree["value_sum"][ga, ca].double() - cs[ga, ca] - (v_a - cv_a) * values
        err, low_err = own[few] / credits, (low_values - values)[few]
        out.update(backup_gap=rms(err), backup_gap_max=widest(err))
        low.update(backup_gap=rms(low_err), backup_gap_max=widest(low_err))
    out["backups_compared"] = int(few.sum())
    if control is not None:
        out["control"] = low
    return out
