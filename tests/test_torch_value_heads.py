"""The discontinued value heads and the hex depthwise conv against the JAX
package.

Each head of ``VALUE_HEADS`` is initialised alone in Flax at 16 channels;
where it has BatchNorm, the scales, biases and running statistics are
redrawn from a seeded numpy generator (Flax starts them at 1, 0, 0 and 1,
which would hide a misplaced term).  The variables go through
``networks/convert.py`` and both heads see the same NHWC activations
(numpy, seeded, B=4 on 5x5).  f32 within 1e-5 absolute (sums in another
order; outputs are O(1)); bf16 within 1e-2 of the output scale, as in
``tests/test_torch_networks.py``.  The depthwise conv is held against
``hex_conv_depthwise`` in both of its layouts, and its NumPy oracle, on
boards of odd and even width; the heads inside ``RecurrentNet`` and
``ResNet`` against the JAX nets; and the hex-conv calls of one
``RecurrentNet`` evaluation per head, counted on the plain version here as
the card's wrapper counts its kernel launches."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import convs_per_evaluation, value_head_conv_shapes
from nuzero_tpu.networks import NetworkManager as JaxManager
from nuzero_tpu.networks import RecurrentNet as JaxRecurrentNet
from nuzero_tpu.networks import ResNet as JaxResNet
from nuzero_tpu.networks.blocks import VALUE_HEADS as JAX_VALUE_HEADS
from nuzero_tpu.networks.blocks import make_value_head as jax_make_value_head
from nuzero_tpu.ops.hexconv import hex_conv_depthwise as jax_depthwise
from nuzero_tpu.ops.hexconv import hex_conv_depthwise_reference
from nuzero_tpu_torch.networks import convert
from nuzero_tpu_torch.networks.blocks import VALUE_HEADS, make_value_head
from nuzero_tpu_torch.networks.manager import NetworkManager
from nuzero_tpu_torch.networks.recurrent import RecurrentNet
from nuzero_tpu_torch.networks.resnet import ResNet
from nuzero_tpu_torch.ops import hexconv

torch.set_num_threads(2)

WIDTH, BATCH, BOARD = 16, 4, (5, 5)
DISCONTINUED = ("depth", "combined", "separable", "reverse", "rawsep", "strange")
OBS, POLICY_CHANNELS = (6, 5, 5), 3


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
    """The converted tensors, keyed and shaped as the module's state_dict."""
    tvars = {k: torch.tensor(v) for k, v in state_dict.items()}
    want = module.state_dict()
    assert set(tvars) == set(want)
    for k, v in want.items():
        assert tuple(v.shape) == tuple(tvars[k].shape), k
    return tvars


def _check(got, want, dtype_name):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale)


@functools.lru_cache(maxsize=None)
def _jax_variables(name, batch_norm, hex):
    """A head's Flax variables (f32 parameters whatever the compute dtype)."""
    jhead = jax_make_value_head(name, WIDTH, batch_norm=batch_norm, hex=hex)
    x0 = jnp.zeros((1, *BOARD, WIDTH), jnp.float32)
    return _redraw_batch_norm(jhead.init(jax.random.key(7), x0, False), seed=8)


def _head_pair(name, dtype_name, batch_norm, hex):
    jdtype, tdtype = jnp.dtype(dtype_name), getattr(torch, dtype_name)
    jhead = jax_make_value_head(name, WIDTH, batch_norm=batch_norm, hex=hex, dtype=jdtype)
    jvars = _jax_variables(name, batch_norm, hex)
    thead = make_value_head(name, WIDTH, batch_norm=batch_norm, hex=hex, dtype=tdtype,
                            board_shape=BOARD)
    return jhead, jvars, thead, _torch_vars(thead, convert.value_head_state_dict(jvars))


def test_registry_has_every_jax_key():
    assert sorted(VALUE_HEADS) == sorted(JAX_VALUE_HEADS)
    with pytest.raises(ValueError, match="unknown value head 'nope'"):
        make_value_head("nope", WIDTH)


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DISCONTINUED)
def test_head_matches_jax(name, dtype_name, batch_norm):
    """A lone head on converted weights, hex, with and without BatchNorm;
    the heads' default activation through make_value_head is tanh in both."""
    jhead, jvars, thead, tvars = _head_pair(name, dtype_name, batch_norm, True)
    x = np.random.default_rng(1).standard_normal((BATCH, *BOARD, WIDTH)).astype(np.float32)
    if dtype_name == "bfloat16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    want = jhead.apply(jvars, jnp.asarray(x), False)
    with torch.no_grad():
        got = torch.func.functional_call(thead, tvars, (torch.tensor(x),))
    assert got.shape == (BATCH,)
    assert got.dtype == getattr(torch, dtype_name)
    _check(got, want, dtype_name)


@pytest.mark.parametrize("name", DISCONTINUED)
def test_ortho_head_matches_jax(name):
    """hex=False: the grouped 3x3 depthwise and the 3x3 convs; rawsep's
    depthwise is ortho in either mode, as in the reference."""
    jhead, jvars, thead, tvars = _head_pair(name, "float32", False, False)
    x = np.random.default_rng(2).standard_normal((BATCH, *BOARD, WIDTH)).astype(np.float32)
    want = jhead.apply(jvars, jnp.asarray(x), False)
    with torch.no_grad():
        got = torch.func.functional_call(thead, tvars, (torch.tensor(x),))
    _check(got, want, "float32")


def test_rawsep_ignores_hex():
    """RawSeparable's parameters are the same whatever ``hex`` says, in both
    packages: its depthwise is the grouped 3x3 ([C, 1, 3, 3])."""
    for hex in (True, False):
        _, jvars, thead, _ = _head_pair("rawsep", "float32", False, hex)
        assert tuple(thead.state_dict()["depthwise.0.conv.weight"].shape) == (WIDTH, 1, 3, 3)
        assert jvars["params"]["DepthwiseConv_0"]["Conv_0"]["kernel"].shape == (3, 3, 1, WIDTH)


def test_strange_conversion_follows_the_shared_counter():
    """Flax numbers Strange's grouped 1x1 ``nn.Conv``s and its hex
    ``Conv`` selectors with one counter: Conv_0 (1,1,1,16), Conv_1
    HexConv_0 (7,16,256), ... Conv_7.  The even ones become pointwise.{i},
    the odd ones convs.{i}."""
    _, jvars, _, tvars = _head_pair("strange", "float32", True, True)
    params = jvars["params"]
    assert sorted(params) == sorted([f"Conv_{i}" for i in range(8)]
                                    + [f"BatchNorm_{i}" for i in range(3)])
    widths = (WIDTH, 256, 64, 8)
    for i, (cin, cout) in enumerate(zip(widths, (256, 64, 8, 1))):
        scale = params[f"Conv_{2 * i}"]["kernel"]
        conv = params[f"Conv_{2 * i + 1}"]["HexConv_0"]["kernel"]
        assert scale.shape == (1, 1, 1, cin) and conv.shape == (7, cin, cout)
        np.testing.assert_array_equal(tvars[f"pointwise.{i}.weight"].numpy(),
                                      np.asarray(scale).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(tvars[f"convs.{i}.conv.weight"].numpy(), conv)
    for i, width in enumerate((256, 64, 8)):
        np.testing.assert_array_equal(tvars[f"norms.{i}.running_var"].numpy(),
                                      jvars["batch_stats"][f"BatchNorm_{i}"]["var"])
        assert tvars[f"norms.{i}.weight"].shape == (width,)


@pytest.mark.parametrize("name", ["separable", "reverse", "combined", "depth"])
def test_conversion_maps_depthwise_and_pointwise(name):
    """The hex depthwise kernels ``DepthwiseConv_i/HexDepthwiseConv_0``
    [7, C] and the 1x1 ``Conv_i`` kernels (1, 1, Cin, Cout) land where the
    port's head reads them; BatchNorm_i in call order."""
    _, jvars, _, tvars = _head_pair(name, "float32", True, True)
    params = jvars["params"]
    for i in range(4):
        np.testing.assert_array_equal(
            tvars[f"depthwise.{i}.conv.weight"].numpy(),
            params[f"DepthwiseConv_{i}"]["HexDepthwiseConv_0"]["kernel"])
    if name in ("separable", "reverse"):
        for i in range(4):
            np.testing.assert_array_equal(tvars[f"pointwise.{i}.weight"].numpy(),
                                          np.asarray(params[f"Conv_{i}"]["kernel"])
                                          .transpose(3, 2, 0, 1))
    n_norms = len([k for k in params if k.startswith("BatchNorm_")])
    assert n_norms == {"separable": 3, "reverse": 3, "combined": 7, "depth": 4}[name]
    for i in range(n_norms):
        np.testing.assert_array_equal(tvars[f"norms.{i}.bias"].numpy(),
                                      params[f"BatchNorm_{i}"]["bias"])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,cols", [(5, 5), (4, 6), (6, 7)])
def test_depthwise_conv_matches_jax_and_the_oracle(rows, cols, dtype_name):
    """Against ``hex_conv_depthwise`` in NHWC and in NCHW and its NumPy
    oracle, on odd and even widths (both column parities at both edges)."""
    rng = np.random.default_rng(rows * 10 + cols)
    x = rng.standard_normal((3, rows, cols, 5)).astype(np.float32)
    w = rng.standard_normal((7, 5)).astype(np.float32)
    jd = jnp.dtype(dtype_name)
    if dtype_name == "bfloat16":
        x = np.asarray(jnp.asarray(x).astype(jd).astype(jnp.float32))
        w = np.asarray(jnp.asarray(w).astype(jd).astype(jnp.float32))
    td = getattr(torch, dtype_name)
    got = hexconv.hex_conv_depthwise(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
    assert got.dtype == td and got.shape == x.shape
    nhwc = jax_depthwise(jnp.asarray(x, jd), jnp.asarray(w, jd), data_format="NHWC")
    nchw = jax_depthwise(jnp.asarray(x.transpose(0, 3, 1, 2), jd), jnp.asarray(w, jd),
                         data_format="NCHW")
    oracle = hex_conv_depthwise_reference(x.transpose(0, 3, 1, 2), w).transpose(0, 2, 3, 1)
    _check(got, nhwc, dtype_name)
    _check(got, jnp.transpose(nchw, (0, 2, 3, 1)), dtype_name)
    _check(got, oracle, dtype_name)


def test_depthwise_conv_gradient_matches_jax():
    """Autograd through the plain function against ``jax.vjp``."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    w = rng.standard_normal((7, 4)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_depthwise(a, b), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    dx, dw = torch.autograd.grad(hexconv.hex_conv_depthwise(tx, tw), (tx, tw),
                                 torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match=r"weights \(7, 3\) != \(7, 4\)"):
        hexconv.hex_conv_depthwise(tx, tw[:, :3])


def _net_pair(kind, head, dtype_name="float32"):
    jd, td = jnp.dtype(dtype_name), getattr(torch, dtype_name)
    if kind == "recurrent":
        jmod = JaxRecurrentNet(policy_channels=POLICY_CHANNELS, num_filters=8, num_blocks=1,
                               value_head=head, hex=True, dtype=jd)
        tmod = RecurrentNet(OBS[0], POLICY_CHANNELS, num_filters=8, num_blocks=1,
                            value_head=head, hex=True, dtype=td, board_shape=OBS[1:])
        to_sd = convert.recurrent_net_state_dict
    else:
        jmod = JaxResNet(policy_channels=POLICY_CHANNELS, num_filters=8, num_blocks=1,
                         batch_norm=True, value_head=head, hex=True, dtype=jd)
        tmod = ResNet(OBS[0], POLICY_CHANNELS, num_filters=8, num_blocks=1, batch_norm=True,
                      value_head=head, hex=True, dtype=td, board_shape=OBS[1:])
        to_sd = convert.resnet_state_dict
    jmgr = JaxManager(jmod, OBS)
    jvars = _redraw_batch_norm(jmgr.init(jax.random.key(5)), seed=6)
    return jmgr, jvars, NetworkManager(tmod, OBS), _torch_vars(tmod, to_sd(jvars))


@pytest.mark.parametrize("kind,head", [("recurrent", h) for h in DISCONTINUED + ("dense",)]
                         + [("resnet", h) for h in DISCONTINUED])
def test_nets_take_every_head(kind, head):
    """RecurrentNet (2 iterations) and ResNet (with BatchNorm) with each
    head against the JAX net on converted weights, f32 (the reduce head in
    both and ResNet's dense head are held in tests/test_torch_networks.py
    and tests/test_torch_zoo.py)."""
    jmgr, jvars, tmgr, tvars = _net_pair(kind, head)
    obs = np.random.default_rng(4).standard_normal((BATCH,) + OBS).astype(np.float32)
    jp, jv, _ = jmgr.apply(jvars, jnp.asarray(obs))
    with torch.no_grad():
        tp, tv, _ = tmgr.apply(tvars, torch.from_numpy(obs))
    _check(tp, jp, "float32")
    _check(tv, jv, "float32")


@pytest.mark.parametrize("head", sorted(JAX_VALUE_HEADS))
def test_hex_conv_calls_per_evaluation(head, monkeypatch):
    """The hex convs of one hex RecurrentNet evaluation at 2 iterations, by
    head: 17 with reduce, 14 depth, 17 combined and strange, 13 separable,
    reverse and rawsep, 14 dense; the heads' 1x1, grouped and depthwise
    convs call no hex conv.  Counted here on the plain version, which the
    card's wrapper replaces with one kernel launch."""
    calls = []
    plain = hexconv.hex_conv_plain
    monkeypatch.setattr(hexconv, "hex_conv_plain",
                        lambda x, w: calls.append((x.shape[-1], w.shape[-1])) or plain(x, w))
    want = {"reduce": 17, "depth": 14, "combined": 17, "strange": 17, "separable": 13,
            "reverse": 13, "rawsep": 13, "dense": 14}[head]
    assert convs_per_evaluation(head, 2) == want
    net = RecurrentNet(OBS[0], POLICY_CHANNELS, num_filters=64, num_blocks=2,
                       value_head=head, hex=True, board_shape=OBS[1:])
    with torch.no_grad():
        net(torch.zeros((1,) + OBS), 2)
    assert len(calls) == want
    assert calls[-len(value_head_conv_shapes(head, 64)) or len(calls):] == (
        value_head_conv_shapes(head, 64) or [])


@pytest.mark.parametrize("head", DISCONTINUED)
def test_every_head_initializes_and_trains(head):
    """``NetworkManager.init`` draws each head's kernels by Flax's rule
    (uniform, bound sqrt(1/fan_in): 7 for a hex depthwise kernel, 9 for a
    grouped 3x3, 1 for a grouped 1x1), and one learner update moves the
    head."""
    from nuzero_tpu_torch.training.learner import Learner, LearnerConfig

    mgr = NetworkManager(RecurrentNet(OBS[0], POLICY_CHANNELS, num_filters=8, num_blocks=1,
                                      value_head=head, hex=True), OBS)
    params = mgr.init(torch.Generator().manual_seed(0))
    for k, v in params.items():
        if "depthwise" in k or "pointwise" in k:
            fan_in = v.shape[0] if v.dim() == 2 else v[0].numel()
            assert 0 < v.abs().max() <= fan_in ** -0.5, k
    learner = Learner(mgr, LearnerConfig(train_iterations=2))
    rng = np.random.default_rng(9)
    pt = rng.random((BATCH, POLICY_CHANNELS * 25)).astype(np.float32)
    batch = (torch.from_numpy(rng.standard_normal((BATCH,) + OBS).astype(np.float32)),
             torch.from_numpy(pt / pt.sum(-1, keepdims=True)),
             torch.from_numpy(rng.choice([-1.0, 1.0], BATCH).astype(np.float32)),
             torch.zeros(BATCH, dtype=torch.int32))
    state, metrics = learner.train_step(learner.init_state(torch.Generator().manual_seed(0)),
                                        batch)
    assert math.isfinite(float(metrics["loss/combined"]))
    moved = [k for k in params if k.startswith("value_head.")
             and not torch.equal(state.params[k], params[k])]
    assert moved, "the update left the value head as it was"
