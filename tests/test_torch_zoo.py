"""The port's MLPNetwork, ConvNet and ResNet against the JAX nets on
converted weights.

Each JAX net is initialised from a key; where it has BatchNorm, its scale,
bias and running statistics are redrawn from a seeded numpy generator
(Flax starts them at 1, 0, 0 and 1, which would hide a misplaced term).
The Flax variables go through ``networks/convert.py`` and both nets see
the same observations (numpy, seeded).  f32 within 1e-5 absolute (the
convolutions and matmuls sum in another order; outputs are O(1)); bf16
within 1e-2 of the output scale, as in ``tests/test_torch_networks.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.networks import ConvNet as JaxConvNet
from nuzero_tpu.networks import MLPNetwork as JaxMLPNetwork
from nuzero_tpu.networks import NetworkManager as JaxManager
from nuzero_tpu.networks import ResNet as JaxResNet
from nuzero_tpu_torch.networks import convert
from nuzero_tpu_torch.networks.blocks import BatchNorm, make_value_head
from nuzero_tpu_torch.networks.convnet import ConvNet
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.mlp import MLPNetwork
from nuzero_tpu_torch.networks.resnet import ResNet
from nuzero_tpu_torch.training.learner import Learner, LearnerConfig, TrainState

torch.set_num_threads(2)

# Hex nets on an SCS-like 6-plane 5x5 board; ortho nets on TTT's 2x3x3.
HEX_OBS, ORTHO_OBS = (6, 5, 5), (2, 3, 3)
POLICY_CHANNELS = 3


def _redraw_batch_norm(variables, seed):
    """Every BatchNorm's scale, bias, mean and var from a numpy generator."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables.get("batch_stats", {}))

    def walk(p, s):
        for key, node in p.items():
            if key.startswith("BatchNorm_"):
                n = node["scale"].shape[0]
                node["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                node["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
                s[key]["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                s[key]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
            elif isinstance(node, dict) and key in s:
                walk(node, s[key])

    walk(params, stats)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def _torch_vars(module, state_dict):
    tvars = {k: torch.tensor(v) for k, v in state_dict.items()}
    want = {k: v for k, v in module.state_dict().items()}
    assert set(tvars) == set(want)
    for k, v in want.items():
        assert tuple(v.shape) == tuple(tvars[k].shape), k
    return tvars


@functools.lru_cache(maxsize=None)
def _pair(kind, dtype_name="float32", hex=True, batch_norm=False, value_head="reduce"):
    obs = HEX_OBS if hex else ORTHO_OBS
    jdtype, tdtype = jnp.dtype(dtype_name), getattr(torch, dtype_name)
    if kind == "mlp":
        jmod = JaxMLPNetwork(out_features=9, hidden_layers=2, neurons_per_layer=16,
                             dtype=jdtype)
        tmod = MLPNetwork(obs, 9, hidden_layers=2, neurons_per_layer=16, dtype=tdtype)
        to_sd = convert.mlp_state_dict
    elif kind == "convnet":
        jmod = JaxConvNet(policy_channels=POLICY_CHANNELS, num_filters=8, num_layers=2,
                          hex=hex, dtype=jdtype)
        tmod = ConvNet(obs[0], POLICY_CHANNELS, num_filters=8, num_layers=2, hex=hex,
                       dtype=tdtype)
        to_sd = convert.convnet_state_dict
    else:
        jmod = JaxResNet(policy_channels=POLICY_CHANNELS, num_filters=8, num_blocks=2,
                         batch_norm=batch_norm, value_head=value_head, hex=hex, dtype=jdtype)
        tmod = ResNet(obs[0], POLICY_CHANNELS, num_filters=8, num_blocks=2,
                      batch_norm=batch_norm, value_head=value_head, hex=hex, dtype=tdtype,
                      board_shape=obs[1:])
        to_sd = convert.resnet_state_dict
    jmgr = JaxManager(jmod, obs)
    jvars = _redraw_batch_norm(jax.jit(jmgr.init)(jax.random.key(3)), seed=4)
    tvars = _torch_vars(tmod, to_sd(jvars))
    return obs, jmgr, jvars, NetworkManager(tmod, obs), tvars


def _compare(case, batch=4, seed=0):
    obs_shape, jmgr, jvars, tmgr, tvars = _pair(*case)
    obs = np.random.default_rng(seed).standard_normal((batch,) + obs_shape).astype(np.float32)
    jp, jv, _ = jmgr.apply(jvars, jnp.asarray(obs))
    with torch.no_grad():
        tp, tv, interim = tmgr.apply(tvars, torch.from_numpy(obs))
    assert interim is None and tp.shape == jp.shape and tv.shape == jv.shape
    for got, want in ((tp, jp), (tv, jv)):
        want = np.asarray(want.astype(jnp.float32))
        if case[1] == "float32":
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-5)
        else:
            scale = max(float(np.abs(want).max()), 1e-3)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-2 * scale)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_mlp_matches_jax(dtype_name):
    _compare(("mlp", dtype_name, False))


@pytest.mark.parametrize("hex,dtype_name", [(True, "float32"), (False, "float32"),
                                            (True, "bfloat16")])
def test_convnet_matches_jax(hex, dtype_name):
    _compare(("convnet", dtype_name, hex))


@pytest.mark.parametrize("hex", [True, False], ids=["hex", "ortho"])
@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "bn"])
@pytest.mark.parametrize("value_head", ["reduce", "dense"])
def test_resnet_matches_jax(hex, batch_norm, value_head):
    _compare(("resnet", "float32", hex, batch_norm, value_head))


@pytest.mark.parametrize("value_head", ["reduce", "dense"])
def test_resnet_bf16_batch_norm_matches_jax(value_head):
    _compare(("resnet", "bfloat16", True, True, value_head))


def test_mlp_policy_keeps_final_relu():
    """The reference's ReLU after the last policy layer: no negative logits."""
    _, _, _, tmgr, tvars = _pair("mlp", "float32", False)
    obs = torch.randn((64,) + ORTHO_OBS, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        p, v, _ = tmgr.apply(tvars, obs)
    assert (p >= 0).all() and (p == 0).any() and (v.abs() <= 1).all()


def test_init_by_kind_and_buffers_in_variables():
    """Conv kernels uniform within sqrt(1/fan_in), Dense kernels truncated
    normal with variance 1/fan_in, biases zero, BatchNorm scale one and
    bias zero, running statistics carried as 0 and 1."""
    net = ResNet(2, 1, num_filters=16, num_blocks=1, batch_norm=True, hex=False,
                 value_head="dense", board_shape=(3, 3))
    mgr = NetworkManager(net, ORTHO_OBS)
    v = mgr.init(torch.Generator().manual_seed(0))
    assert list(v) == [k for k, _ in net.named_parameters()] + [k for k, _ in net.named_buffers()]
    w = v["stem.conv.weight"]
    assert float(w.abs().max()) <= (1 / (2 * 9)) ** 0.5 and float(w.std()) > 0
    d = v["value_head.dense1.weight"]  # [256, 288]
    std = (1 / 288) ** 0.5
    assert float(d.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(d.std()) / std - 1) < 0.05
    for name in ("stem_norm", "blocks.0.norm", "value_head.norm"):
        assert (v[f"{name}.weight"] == 1).all() and (v[f"{name}.bias"] == 0).all()
        assert (v[f"{name}.running_mean"] == 0).all() and (v[f"{name}.running_var"] == 1).all()
    mlp = MLPNetwork(ORTHO_OBS, 9, hidden_layers=1, neurons_per_layer=8)
    mv = NetworkManager(mlp, ORTHO_OBS).init(torch.Generator().manual_seed(0))
    assert all((mv[f"{k}.bias"] == 0).all() for k in ("trunk.0", "policy.2", "value.1"))
    again = NetworkManager(mlp, ORTHO_OBS).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(mv[k], again[k]) for k in mv)


def test_batch_norm_is_running_average_inference():
    """The port's BatchNorm is Flax's with use_running_average: the batch's
    own statistics play no part."""
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.5, -1.0, 0.0, 2.0]))
        bn.running_var.copy_(torch.tensor([4.0, 1.0, 0.25, 1.0]))
        bn.weight.copy_(torch.tensor([1.0, 2.0, 1.0, 1.0]))
        bn.bias.copy_(torch.tensor([0.0, 0.0, 1.0, 0.0]))
        x = torch.randn(3, 2, 2, 4)
        want = (x - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5) * bn.weight + bn.bias
        torch.testing.assert_close(bn(x), want)
        torch.testing.assert_close(bn(x[:1]), want[:1])


def test_learner_refuses_a_batch_norm_net():
    """JAX cannot train a BatchNorm net (its learner applies with
    train=True and batch_stats immutable, which Flax refuses); the port's
    Learner trains the same net on the same batch as torch's BatchNorm2d
    does (held to a plain reference in ``tests/test_torch_az_tower.py``):
    the running statistics move and come back in the new parameters."""
    from flax.errors import ModifyScopeVariableError

    from nuzero_tpu.training.learner import Learner as JaxLearner
    from nuzero_tpu.training.learner import LearnerConfig as JaxLearnerConfig

    _, jmgr, _, tmgr, tvars = _pair("resnet", "float32", False, True, "reduce")
    jlearner = JaxLearner(jmgr, JaxLearnerConfig())
    state = jlearner.init_state(jax.random.key(0))
    batch = (jnp.zeros((2,) + ORTHO_OBS), jnp.full((2, 9), 1 / 9), jnp.zeros(2),
             jnp.zeros(2, jnp.int32))
    with pytest.raises(ModifyScopeVariableError):
        jlearner.train_step(state, batch, jax.random.key(1))
    learner = Learner(tmgr, LearnerConfig())
    tstate = TrainState(params=tvars, opt_state=learner.init_opt_state(tvars), step=0)
    actions = POLICY_CHANNELS * ORTHO_OBS[1] * ORTHO_OBS[2]
    tbatch = (torch.zeros((2,) + ORTHO_OBS), torch.full((2, actions), 1 / actions),
              torch.zeros(2), torch.zeros(2, dtype=torch.int32))
    new, metrics = learner.train_step(tstate, tbatch)
    assert new.step == 1 and torch.isfinite(metrics["loss/combined"])
    stats = [k for k, _ in tmgr.module.named_buffers()]
    assert stats and all(not torch.equal(new.params[k], tvars[k]) for k in stats)
    _, _, _, plain_mgr, _ = _pair("resnet", "float32", False, False, "reduce")
    Learner(plain_mgr, LearnerConfig())


def test_value_heads_and_policy_heads():
    """``make_value_head`` builds "reduce" and "dense" (the dense one needs
    the board shape) and the discontinued heads (held against JAX in
    ``tests/test_torch_value_heads.py``), refuses an unknown head, and an
    unknown ResNet policy head raises as in JAX."""
    assert make_value_head("dense", 8, board_shape=(3, 3)).dense1.weight.shape == (256, 288)
    with pytest.raises(ValueError, match="board_shape"):
        make_value_head("dense", 8)
    assert make_value_head("depth", 8).depthwise[0].conv.weight.shape == (7, 8)
    with pytest.raises(ValueError, match="unknown value head 'nope'"):
        make_value_head("nope", 8)
    with pytest.raises(ValueError, match="unavailable"):
        ResNet(2, 1, num_filters=8, policy_head="dense")
