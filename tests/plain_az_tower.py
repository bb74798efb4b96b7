"""Plain reference of AlphaZero's residual tower as NuZero runs it, in f32.

The network of Silver et al., "Mastering the game of Go without human
knowledge", Nature 550:354 (2017), Methods, "Neural network architecture",
which AlphaZero (Silver et al., Science 362:1140, 2018) reuses: a
convolutional stem with batch normalization and a rectifier, residual
blocks of 256 filters with batch normalization (19 in the paper's smaller
net), and a policy head and a value head.  Written out on a dict of
parameters under the port's names (``networks/resnet.py``), with plain
``torch`` operations and no module of the port or of the JAX package.

Departures from the paper, all NuZero's (upstream
``Neural_Networks/Architectures/ResNet.py``):

- hexagonal convolutions of 7 taps (HexagDLy's offset coordinates) on SCS
  boards, where the paper has 3x3 convolutions on a 19x19 board;
- NuZero's ``BasicBlock``: conv, batch norm, rectifier, conv, then the skip
  connection and a rectifier (no batch norm after the second conv);
- NuZero's reduce heads: the policy head ramps the filters down to the
  action planes in 2 convs with 1 batch norm and rectifier between; the
  value head ramps to 1 channel in 4 convs with 3 batch norms and tanh
  between, then tanh of the global mean (the paper has a 1x1 conv and
  fully connected layers);
- no convolution has a bias.

Batch normalization is ``torch.nn.functional.batch_norm`` with torch's
defaults (``nn.BatchNorm2d``: eps 1e-5, momentum 0.1): with the running
statistics, or with the batch's (the biased variance normalizes, the
running variance moves by the unbiased one).  One update (``update``) is
the port's losses written out (cross-entropy with label smoothing 0.02 and
squared error, their batch means summed), autograd's gradients of the
parameters, then the running statistics moved and an Adam step (b1 0.9,
b2 0.999, eps 1e-8, bias-corrected at count 1).  TF32 is off throughout.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

EPS, MOMENTUM = 1e-5, 0.1
LABEL_SMOOTHING = 0.02
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# tap -> (row_offset, col_offset) for even and odd columns, taps ordered
# [center, n, ne, se, s, sw, nw].
_OFFSETS = {
    0: ((0, 0), (-1, 0), (-1, 1), (0, 1), (1, 0), (0, -1), (-1, -1)),
    1: ((0, 0), (-1, 0), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1)),
}


@contextlib.contextmanager
def _full_f32():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def hex_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` [B, H, W, Cin] by hex weights ``w`` [7, Cin, Cout]: each
    output the sum over the 7 taps of the neighbour's input times the tap's
    weight, zero off the board."""
    B, H, W, _ = x.shape
    out = torch.zeros(B, H, W, w.shape[2], dtype=torch.float32, device=x.device)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    cols = torch.arange(W, device=x.device)
    for t in range(7):
        for parity in (0, 1):
            dr, dc = _OFFSETS[parity][t]
            c = cols[cols % 2 == parity]
            taps = xp[:, 1 + dr:1 + dr + H][:, :, c + 1 + dc]
            out[:, :, c] += taps @ w[t].float()
    return out


def layout(in_channels: int, policy_channels: int, num_filters: int, num_blocks: int):
    """[(name, shape)] of the tower's parameters and then its buffers, under
    the port's names."""
    def ramp(start, end, n):
        step, prev, sizes = (end - start) / n, float(start), []
        for _ in range(n):
            prev += step
            sizes.append(int(prev))
        return sizes

    f = num_filters
    params = [("stem.conv.weight", (7, in_channels, f))]
    norms = [("stem_norm", f)]
    for i in range(num_blocks):
        params += [(f"blocks.{i}.conv1.conv.weight", (7, f, f)),
                   (f"blocks.{i}.conv2.conv.weight", (7, f, f))]
        norms.append((f"blocks.{i}.norm", f))
    for head, sizes in (("policy_head", ramp(f, policy_channels, 2)),
                        ("value_head", ramp(f, 1, 4))):
        for i, (cin, cout) in enumerate(zip([f] + sizes[:-1], sizes)):
            params.append((f"{head}.convs.{i}.conv.weight", (7, cin, cout)))
            if i < len(sizes) - 1:
                norms.append((f"{head}.norms.{i}", cout))
    params += [(f"{n}.{p}", (w,)) for n, w in norms for p in ("weight", "bias")]
    buffers = [(f"{n}.{b}", (w,)) for n, w in norms for b in ("running_mean", "running_var")]
    return params, buffers


def _batch_norm(params, name, x, train, moved):
    """NHWC ``x`` through the batch norm ``name``; in training mode the
    moved running statistics go into ``moved``."""
    mean = params[f"{name}.running_mean"].detach().clone()
    var = params[f"{name}.running_var"].detach().clone()
    y = F.batch_norm(x.permute(0, 3, 1, 2), mean, var, params[f"{name}.weight"],
                     params[f"{name}.bias"], training=train, momentum=MOMENTUM, eps=EPS)
    if train:
        moved[f"{name}.running_mean"], moved[f"{name}.running_var"] = mean, var
    return y.permute(0, 2, 3, 1)


def forward(params, obs: torch.Tensor, train: bool = False, norms: bool = True):
    """(policy logits [B, A], value [B], moved running statistics) of
    observations ``obs`` [B, C, H, W].  ``train`` normalizes by the batch's
    statistics; ``norms=False`` leaves every batch norm out (a fault)."""
    moved = {}

    def conv(name, x):
        return hex_conv(x, params[name])

    def bn(name, x):
        return _batch_norm(params, name, x, train, moved) if norms else x

    with _full_f32():
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
        logits = p.permute(0, 3, 1, 2).reshape(p.shape[0], -1)
        value = torch.tanh(heads["value_head"].mean(dim=(1, 2, 3)))
    return logits, value, moved


def losses(logits, value, policy_target, value_target):
    """(value loss, policy loss, combined): batch means of the squared error
    and of the cross-entropy with label smoothing 0.02."""
    smoothed = policy_target * (1.0 - LABEL_SMOOTHING) + LABEL_SMOOTHING / logits.shape[-1]
    p = -(smoothed * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    v = ((value_target - value) ** 2).mean()
    return v, p, p + v


def update(params, obs, policy_target, value_target, lr: float):
    """One Adam update from a fresh optimizer state, the forward in training
    mode -> (combined loss, gradients, new parameters and buffers)."""
    trained = {k: v.detach().clone().requires_grad_(not k.endswith(("running_mean",
                                                                    "running_var")))
               for k, v in params.items()}
    logits, value, moved = forward(trained, obs, train=True)
    _, _, loss = losses(logits, value, policy_target, value_target)
    keys = [k for k, v in trained.items() if v.requires_grad]
    grads = dict(zip(keys, torch.autograd.grad(loss, [trained[k] for k in keys])))
    bc1 = float(np.float32(1) - np.float32(ADAM_B1))
    bc2 = float(np.float32(1) - np.float32(ADAM_B2))
    new = {}
    with torch.no_grad():
        for k, v in params.items():
            if k in grads:
                g = grads[k]
                mu, nu = (1 - ADAM_B1) * g, (1 - ADAM_B2) * g * g
                new[k] = v - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
            else:
                new[k] = moved[k]
    return loss.detach(), grads, new
