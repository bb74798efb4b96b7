"""The plain references against the port's plain path on the CPU, at tiny
sizes: the frozen SCS engine against the port's, the f32 net against the
port's RecurrentNet, and the controls' precisions off the f32 net."""

import json
import os

import pytest
import torch

from cardbench import harness
from cardbench.reference import net as ref_net
from cardbench.reference import selfplay as ref_selfplay


def _scenario(name):
    with open(os.path.join(harness.HERE, "traffic", "scenarios", name + ".json")) as f:
        return json.load(f)


def _port_env(name, randomize_vp):
    from nuzero_tpu_torch.envs.scs.game import SCSGame
    from nuzero_tpu_torch.envs.scs.scenario import scenario_from_dict

    return SCSGame(scenario_from_dict(_scenario(name), seed=42), randomize_vp=randomize_vp,
                   device="cpu")


@pytest.mark.parametrize("name,randomize_vp", [("open_field_5", False), ("solo_scout_5", True)])
def test_frozen_engine_follows_the_port(name, randomize_vp):
    from nuzero_tpu_torch.utils.packing import make_packer

    port = _port_env(name, randomize_vp)
    ref = ref_selfplay.make_env(_scenario(name), 42, randomize_vp, "cpu")
    pack, _, dim = make_packer(port.init(1, generator=torch.Generator()))
    assert dim == ref.dim
    gen = torch.Generator().manual_seed(7)
    state = port.init(16, generator=gen)
    rstate = ref.unpack(pack(state))
    for _ in range(40):
        legal = port.legal_mask(state)
        assert torch.equal(legal, ref.env.legal_mask(rstate))
        assert torch.equal(port.observe(state), ref.env.observe(rstate))
        assert torch.equal(port.terminal(state), ref.env.terminal(rstate))
        assert torch.equal(port.terminal_value(state), ref.env.terminal_value(rstate))
        u = torch.rand(legal.shape, generator=gen)
        action = torch.argmax(torch.where(legal, u, -1.0), dim=-1).to(torch.int32)
        state = port.step(state, action)
        rstate = ref.env.step(rstate, action)
        assert torch.equal(pack(state), ref.pack(rstate))


def _net(filters, dtype, obs_channels=86, planes=21):
    from nuzero_tpu_torch.networks.manager import NetworkManager
    from nuzero_tpu_torch.networks.recurrent import RecurrentNet

    net = RecurrentNet(obs_channels, planes, num_filters=filters, num_blocks=2, hex=True,
                       dtype=dtype)
    return NetworkManager(net, (obs_channels, 5, 5))


@pytest.mark.parametrize("iterations", [1, 4])
def test_reference_net_follows_the_port_in_f32(iterations):
    manager = _net(8, torch.float32)
    params = harness.draw_params(manager.module, 123, "cpu")
    obs = (torch.rand(6, 86, 5, 5, generator=torch.Generator().manual_seed(1)) < 0.3).float()
    p, v, _ = manager.apply(params, obs, iters_to_do=iterations)
    rp, rv = ref_net.recurrent_forward(params, obs, iterations)
    assert torch.allclose(p, rp, rtol=1e-5, atol=1e-6 * float(rp.abs().max()))
    assert torch.allclose(v, rv, rtol=1e-5, atol=1e-6 * float(rv.abs().max()))


def test_progressive_forward_follows_the_port():
    manager = _net(8, torch.float32)
    params = harness.draw_params(manager.module, 5, "cpu")
    obs = (torch.rand(4, 86, 5, 5, generator=torch.Generator().manual_seed(2)) < 0.3).float()
    from torch.func import functional_call

    (p, v), _ = functional_call(manager.module, params, (obs, 4, None, 1, 3))
    rp, rv = ref_net.recurrent_forward(params, obs, 4, detach_at=1, limit=3)
    assert torch.allclose(p, rp, rtol=1e-5, atol=1e-6 * float(rp.abs().max()))
    assert torch.allclose(v, rv, rtol=1e-5, atol=1e-6 * float(rv.abs().max()))


def test_draw_params_is_the_seeds():
    manager = _net(8, torch.float32)
    a = harness.draw_params(manager.module, 2**31 + 99, "cpu")
    b = harness.draw_params(manager.module, 2**31 + 99, "cpu")
    c = harness.draw_params(manager.module, 2**31 + 100, "cpu")
    assert list(a) == [k for k, _ in manager.module.named_parameters()]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem.conv.weight"], c["stem.conv.weight"])
    w = a["cell.blocks.0.conv1.conv.weight"]
    assert float(w.abs().max()) <= (1.0 / (7 * 8)) ** 0.5


def test_controls_round_as_their_precisions():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.14159265])
    t = ref_net.QUANT["tf32"](x)
    assert t[0] == 1.0 and t[1] == 1.0 and t[2] == 1.0 + 2.0 ** -9
    assert abs(float(t[3]) + 3.14159265) < 2.0 ** -9 * 4
    y = torch.linspace(-1, 1, 101)
    f8 = ref_net.QUANT["fp8"](y)
    err = (f8 - y).abs().max()
    assert 0 < err < 1.0 / 16
    manager = _net(8, torch.float32)
    params = harness.draw_params(manager.module, 3, "cpu")
    obs = (torch.rand(4, 86, 5, 5, generator=torch.Generator().manual_seed(3)) < 0.3).float()
    f32 = ref_net.recurrent_forward(params, obs, 4)[0]
    for quant in ("tf32", "fp8"):
        low = ref_net.recurrent_forward(params, obs, 4, quant)[0]
        assert 0 < float((low - f32).abs().max())
