"""The port's hex-conv backward against the JAX package's.

``hex_conv`` differentiates through ``HexConvFunction``, whose backward on
CPU tensors is ``hex_conv_dx_plain`` (the hex conv of dY with the mirrored
taps) and ``hex_conv_dw_plain`` (the gathered taps transposed times dY).
They are held against ``jax.vjp`` of the JAX package's XLA hex conv and
against its custom VJP rule ``_hex_conv_pallas_bwd``, on the same numpy
inputs.  Tolerances, of the reference's largest value: f32 1e-5 (the same
sums in another order); bf16 2e-2, one bf16 rounding of the gradient
(2^-8 relative) where the two frameworks round at different places.

The mirror identity and the gathered dW are also checked against torch's
own autograd through ``hex_conv_plain``: these are the plain versions that
the CUDA kernels are held to on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuzero_tpu.ops import hexconv as jax_hexconv
from nuzero_tpu_torch.ops import hexconv

torch.set_num_threads(2)

# (B, H, W, Cin, Cout): 5x5 and 10x10 boards, H != W, odd and even widths,
# odd Cin, Cout of 1 and 21, and a recall-like Cin = F + 86 at F = 8.
SHAPES = [(2, 5, 5, 3, 4), (2, 10, 10, 8, 5), (2, 4, 6, 5, 1), (3, 5, 7, 7, 21),
          (2, 6, 5, 21, 3), (2, 5, 5, 94, 8)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(b, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((7, cin, cout)) / np.sqrt(7 * cin)).astype(np.float32)
    dy = rng.standard_normal((b, h, w, cout)).astype(np.float32)
    return x, wt, dy


def _port_grads(x, wt, dy, dtype):
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    wtt = torch.from_numpy(wt).to(getattr(torch, dtype)).requires_grad_(True)
    y = hexconv.hex_conv(xt, wtt)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    assert xt.grad.dtype == wtt.grad.dtype == getattr(torch, dtype)
    return xt.grad.float().numpy(), wtt.grad.float().numpy()


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_hex_conv_grad_matches_jax_vjp(dtype, b, h, w, cin, cout):
    """dX and dW of the port's ``hex_conv`` (plain path) against
    ``jax.vjp(_hex_conv_xla_nhwc)`` in the operands' dtype."""
    x, wt, dy = _inputs(b, h, w, cin, cout)
    jd = jnp.dtype(dtype)
    _, vjp = jax.vjp(jax_hexconv._hex_conv_xla_nhwc,
                     jnp.asarray(x).astype(jd), jnp.asarray(wt).astype(jd))
    jdx, jdw = vjp(jnp.asarray(dy).astype(jd))
    gx, gw = _port_grads(x, wt, dy, dtype)
    _close(gx, jdx, TOL[dtype])
    _close(gw, jdw, TOL[dtype])


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 10, 10, 3, 4), (3, 5, 7, 7, 21)])
def test_hex_conv_grad_matches_jax_pallas_bwd(b, h, w, cin, cout):
    """The same gradients against the JAX package's custom VJP rule
    ``_hex_conv_pallas_bwd`` around the interpret-mode Pallas forward, as
    ``tests/test_hexconv_pallas.py`` drives it (f32)."""
    from nuzero_tpu.ops.pallas import hex_conv_pallas

    def fwd(x, w):
        return hex_conv_pallas(x, w, interpret=True)

    ad = jax.custom_vjp(fwd)
    ad.defvjp(lambda x, w: (fwd(x, w), (x, w)), jax_hexconv._hex_conv_pallas_bwd)
    x, wt, dy = _inputs(b, h, w, cin, cout, seed=1)
    y, vjp = jax.vjp(ad, jnp.asarray(x), jnp.asarray(wt))
    jdx, jdw = vjp(jnp.asarray(dy))
    _close(hexconv.hex_conv(torch.from_numpy(x), torch.from_numpy(wt)).numpy(), y, 1e-5)
    gx, gw = _port_grads(x, wt, dy, "float32")
    _close(gx, jdx, TOL["float32"])
    _close(gw, jdw, TOL["float32"])


@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_plain_backward_matches_torch_autograd(b, h, w, cin, cout):
    """``hex_conv_dx_plain`` (the mirror identity: the hex conv of dY with
    ``W'[s] = W[opp(s)]^T``) and ``hex_conv_dw_plain`` equal torch's
    autograd through ``hex_conv_plain`` (f32, 1e-5 of the largest value)."""
    x, wt, dy = _inputs(b, h, w, cin, cout, seed=2)
    xt = torch.from_numpy(x).requires_grad_(True)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    gx, gw = torch.autograd.grad(hexconv.hex_conv_plain(xt, wtt), (xt, wtt),
                                 torch.from_numpy(dy))
    dyt = torch.from_numpy(dy)
    _close(hexconv.hex_conv_dx_plain(dyt, torch.from_numpy(wt)).numpy(), gx.numpy(), 1e-5)
    _close(hexconv.hex_conv_dw_plain(torch.from_numpy(x), dyt).numpy(), gw.numpy(), 1e-5)


def test_mirror_taps_swaps_opposite_taps():
    """``W'[s] = W[opp(s)]^T`` with opp swapping n/s, ne/sw, se/nw."""
    wt = torch.arange(7 * 2 * 3, dtype=torch.float32).reshape(7, 2, 3)
    got = hexconv.mirror_taps(wt)
    assert got.shape == (7, 3, 2)
    for s, t in enumerate((0, 4, 5, 6, 1, 2, 3)):
        torch.testing.assert_close(got[s], wt[t].t(), rtol=0, atol=0)
    torch.testing.assert_close(hexconv.mirror_taps(got), wt, rtol=0, atol=0)


def test_backward_skips_dx_where_the_input_needs_none(monkeypatch):
    """A conv whose input needs no gradient (a network's stem, which reads
    the observation) computes dW only."""
    calls = []
    real = hexconv.hex_conv_dx_plain
    monkeypatch.setattr(hexconv, "hex_conv_dx_plain", lambda *a: calls.append(1) or real(*a))
    x, wt, _ = _inputs(2, 5, 5, 4, 3)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    hexconv.hex_conv(torch.from_numpy(x), wtt).sum().backward()
    assert calls == [] and wtt.grad is not None
    xt = torch.from_numpy(x).requires_grad_(True)
    hexconv.hex_conv(xt, wtt).sum().backward()
    assert calls == [1] and xt.grad is not None
