"""The port's plain hex conv against the JAX hex conv, its NumPy oracle and
the Pallas kernel (interpret mode, as ``tests/test_hexconv_pallas.py``
runs it on the CPU).

Weights are scaled by 1/sqrt(7*Cin) so outputs are O(1).  f32 tolerance:
1e-5 absolute (the same sums taken in another order).  bf16: 2 bf16 ulps
of the output scale (both sides compute in f32 and round once to bf16;
a sum that lands near a rounding boundary may round the other way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nuzero_tpu.ops.hexconv import hex_conv as jax_hex_conv
from nuzero_tpu.ops.hexconv import hex_conv_reference
from nuzero_tpu.ops.pallas import hex_conv_pallas
from nuzero_tpu_torch.ops import hexconv
from nuzero_tpu_torch.ops.cuda import hexconv_kernel

torch.set_num_threads(2)

# (batch, rows, cols, cin, cout): tests/test_hexconv_pallas.py's shapes,
# then the slice's odd widths on 5x5 and 10x10 boards.
SHAPES = [
    (4, 5, 5, 3, 4),
    (4, 8, 6, 2, 2),
    (2, 5, 5, 86, 8),
    (2, 5, 5, 342, 16),
    (2, 5, 5, 16, 21),
    (2, 5, 5, 16, 1),
    (2, 10, 10, 86, 8),
    (2, 10, 10, 342, 16),
    (2, 10, 10, 16, 21),
    (2, 10, 10, 16, 1),
]


def _inputs(b, h, w, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((7, cin, cout)) / np.sqrt(7 * cin)).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_plain_matches_jax_f32(b, h, w, cin, cout):
    x, wt = _inputs(b, h, w, cin, cout)
    got = hexconv.hex_conv_plain(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    assert got.shape == (b, h, w, cout) and got.dtype == np.float32
    xla = np.asarray(jax_hex_conv(jnp.asarray(x), jnp.asarray(wt), data_format="NHWC"))
    oracle = hex_conv_reference(x.transpose(0, 3, 1, 2), wt).transpose(0, 2, 3, 1)
    pallas = np.asarray(hex_conv_pallas(jnp.asarray(x), jnp.asarray(wt), interpret=True))
    for want in (xla, oracle, pallas):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES[2:])
def test_plain_matches_jax_bf16(b, h, w, cin, cout):
    x, wt = _inputs(b, h, w, cin, cout, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(wt).to(torch.bfloat16)
    got = hexconv.hex_conv_plain(xb, wb)
    assert got.dtype == torch.bfloat16
    want = jax_hex_conv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16), data_format="NHWC"
    )
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 * ulp)


# tests/test_hexconv.py's boards at 3->4 channels, then the recall conv's
# 342->256 on one 5x5 board, a 10x10 board and odd channel counts.
DUAL_SHAPES = [(2, r, c, 3, 4) for r, c in ((3, 3), (5, 5), (4, 7), (8, 6), (1, 1))] + [
    (1, 5, 5, 342, 256),
    (2, 10, 10, 86, 8),
    (2, 7, 9, 21, 1),
    (3, 5, 6, 5, 3),
]


@pytest.mark.parametrize("b,h,w,cin,cout", DUAL_SHAPES)
def test_dual3x3_matches_jax_f32(b, h, w, cin, cout):
    """The library yardstick computes the hex conv: against the JAX XLA
    path it ports and against the plain version, 1e-5 absolute (the same
    sums, in another order)."""
    x, wt = _inputs(b, h, w, cin, cout, seed=2)
    got = chip_smoke.hex_conv_dual3x3(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    assert got.shape == (b, h, w, cout) and got.dtype == np.float32
    xla = np.asarray(jax_hex_conv(jnp.asarray(x), jnp.asarray(wt), data_format="NHWC"))
    plain = hexconv.hex_conv_plain(torch.from_numpy(x), torch.from_numpy(wt)).numpy()
    for want in (xla, plain):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dispatch_routes_cpu_tensors_to_plain():
    x, wt = _inputs(2, 5, 5, 4, 3)
    hexconv_kernel.reset_launch_count()
    y = hexconv.hex_conv(torch.from_numpy(x), torch.from_numpy(wt))
    torch.testing.assert_close(
        y, hexconv.hex_conv_plain(torch.from_numpy(x), torch.from_numpy(wt)), rtol=0, atol=0
    )
    assert sum(hexconv_kernel.launch_count.values()) == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is an error,
    raised before any build or launch."""
    x, wt = _inputs(2, 5, 5, 4, 3)
    hexconv_kernel.reset_launch_count()
    with pytest.raises(ValueError, match="CUDA"):
        hexconv_kernel.hex_conv_cuda(torch.from_numpy(x), torch.from_numpy(wt))
    assert sum(hexconv_kernel.launch_count.values()) == 0


def test_offset_tables_match_jax():
    from nuzero_tpu.ops.hexconv import hex_neighbor_offsets as jax_offsets

    for parity in (0, 1):
        np.testing.assert_array_equal(
            hexconv.hex_neighbor_offsets(parity), jax_offsets(parity)
        )
