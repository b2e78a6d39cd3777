"""The port's batched NTT (kernel 3 and its plain version) against the JAX
package's host NTT, at the leaf's sizes and past the one-pass limit of 2^12
(the old one-block cap of 2^14 included). Bit-exact. The `gpu` cases hold
the kernel against its plain version on the card; they skip without one."""

import numpy as np
import pytest
import torch

from qp_zk_circuits_tpu.field import gf_np as JF
from qp_zk_circuits_tpu.poly import ntt as jntt
from qp_zk_circuits_tpu_torch.field import goldilocks as gl
from qp_zk_circuits_tpu_torch.poly import ntt as tntt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    return torch.device("cuda")


def _t(x, device="cpu"):
    return gl.from_u64(x, device)


@pytest.mark.parametrize("shape", [(8, 1 << 6), (135, 1 << 8)])
def test_ntt_and_intt_match_reference(shape):
    rng = np.random.default_rng(shape[0])
    vals = JF.rand_felts(shape, rng)
    assert np.array_equal(gl.to_u64(tntt.ntt(_t(vals))), jntt.ntt_np(vals))
    assert np.array_equal(gl.to_u64(tntt.intt(_t(vals))), jntt.intt_np(vals))


@pytest.mark.parametrize("shape, rate_bits", [((8, 1 << 6), 1), ((135, 1 << 8), 3)])
def test_coset_lde_matches_reference(shape, rate_bits):
    rng = np.random.default_rng(rate_bits)
    coeffs = JF.rand_felts(shape, rng)
    got = gl.to_u64(tntt.coset_lde(_t(coeffs), rate_bits))
    assert np.array_equal(got, jntt.coset_lde_np(coeffs, rate_bits))


def test_quotient_sized_intt_and_roundtrip():
    rng = np.random.default_rng(9)
    vals = JF.rand_felts(1 << 11, rng)
    coeffs = tntt.intt(_t(vals))
    assert np.array_equal(gl.to_u64(coeffs), jntt.intt_np(vals))
    assert np.array_equal(gl.to_u64(tntt.ntt(coeffs)), vals)


def test_host_tables_match_reference():
    assert np.array_equal(tntt.bit_reversal_perm(7), jntt.bit_reversal_perm(7))
    for mine, ref in zip(tntt.stage_twiddles(6, True), jntt.stage_twiddles(6, True)):
        assert np.array_equal(mine, ref)


@pytest.mark.parametrize("log_n, n_in", [(15, 1 << 15), (16, 1 << 16)])
def test_ntt_and_intt_above_one_pass_match_reference(log_n, n_in):
    """Sizes past the old one-block cap of 2^14 (two passes on the card)."""
    rng = np.random.default_rng(log_n)
    vals = JF.rand_felts((2, n_in), rng)
    assert np.array_equal(gl.to_u64(tntt.ntt(_t(vals))), jntt.ntt_np(vals))
    assert np.array_equal(gl.to_u64(tntt.intt(_t(vals))), jntt.intt_np(vals))


def test_coset_lde_above_one_pass_matches_reference():
    rng = np.random.default_rng(13)
    coeffs = JF.rand_felts((3, 1 << 13), rng)
    got = gl.to_u64(tntt.coset_lde(_t(coeffs), 3))
    assert np.array_equal(got, jntt.coset_lde_np(coeffs, 3))


def test_coset_intt_above_one_pass_matches_reference():
    """Evaluations over g H -> coefficients: the JAX package's intt_np, then
    the unshift by g^-j (as its quotient_run does after intt_j)."""
    rng = np.random.default_rng(15)
    vals = JF.rand_felts((2, 1 << 15), rng)
    unshift = JF.powers(JF.inv(JF.MULTIPLICATIVE_GROUP_GENERATOR), 1 << 15)
    want = JF.mul(jntt.intt_np(vals), unshift[None, :])
    assert np.array_equal(gl.to_u64(tntt.coset_intt(_t(vals))), want)


def test_sizes_beyond_one_block_are_refused():
    """Above the cap 2^MAX_LOG_N (two passes of at most 2^12 points; one
    block held 2^14 before), and more inputs than points, raise on every
    device."""
    for dev in ("cpu", "meta"):
        x = torch.zeros((1, 4), dtype=torch.int64, device=dev)
        with pytest.raises(ValueError, match="2\\^1..2\\^24"):
            tntt.batched_ntt(x, tntt.MAX_LOG_N + 1)
        with pytest.raises(ValueError):
            tntt.batched_ntt(torch.zeros((1, 8), dtype=torch.int64, device=dev), 2)
    assert tntt.MAX_LOG_N == 24 and tntt.pass_bits(tntt.MAX_LOG_N) == (12, 12)
    assert tntt.pass_bits(12) == (12, 0) and tntt.pass_bits(19) == (10, 9)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(10)
    coeffs = _t(JF.rand_felts((135, 256), rng), cuda)
    for args in ((11, False, 7), (8, True, None), (8, False, None), (14, False, 7)):
        assert torch.equal(tntt.batched_ntt(coeffs, *args), tntt.batched_ntt_plain(coeffs, *args))


@pytest.mark.gpu
@pytest.mark.parametrize("log_n", [11, 12, 13, 14, 19])
def test_kernel_matches_plain_across_the_pass_boundary(cuda, log_n):
    """One pass up to 2^12, two above: forward, inverse, LDE from 2^(log_n - 3)
    with the coset shift, and inverse with the unshift, on 3 columns."""
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    x = _t(JF.rand_felts((3, n), rng), cuda)
    unshift = int(JF.inv(JF.MULTIPLICATIVE_GROUP_GENERATOR))
    for inputs, kw in ((x, {}), (x, dict(inverse=True)), (x[:, : n >> 3], dict(shift=7)),
                       (x, dict(inverse=True, out_shift=unshift))):
        got = tntt.batched_ntt(inputs, log_n, **kw)
        assert torch.equal(got, tntt.batched_ntt_plain(inputs, log_n, **kw)), kw
