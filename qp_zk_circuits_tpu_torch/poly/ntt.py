"""Batched radix-2 NTT / iNTT / coset LDE over Goldilocks, on torch tensors.

Polynomials are processed as a batch (..., N) sharing one set of twiddles:
iterative Cooley-Tukey, decimation in time, natural order in and out with a
bit-reversed gather up front, evaluations f(w^i) at index i. The device work
is kernel 3 (csrc/ntt.cu) behind `batched_ntt`; CPU tensors take its plain
torch version. `ntt`, `intt` and `coset_lde` are the three modes of it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from ..field import gf_np as F
from ..field import goldilocks as gl

#: one block holds a column in shared memory: N * 8 bytes up to 128 KB
MAX_LOG_N = 14


# ---------------------------------------------------------------------------
# host tables


@functools.cache
def bit_reversal_perm(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@functools.cache
def stage_twiddles(log_n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Twiddles per stage s = 1..log_n: w_{2^s}^j for j < 2^(s-1)."""
    out = []
    for s in range(1, log_n + 1):
        w = F.primitive_root_of_unity(s)
        if inverse:
            w = F.inv(w)
        out.append(F.powers(w, 1 << (s - 1)))
    return tuple(out)


@functools.cache
def _device_twiddles(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """All stage twiddles concatenated: stage s at offset 2^(s-1) - 1."""
    return gl.from_u64(np.concatenate(stage_twiddles(log_n, inverse)), device)


@functools.cache
def _device_powers(base: int, n: int, device: torch.device) -> torch.Tensor:
    return gl.from_u64(F.powers(np.uint64(base), n), device)


# ---------------------------------------------------------------------------
# kernel 3


def batched_ntt_plain(
    x: torch.Tensor, log_n: int, inverse: bool = False, shift: int | None = None,
    out_shift: int | None = None,
) -> torch.Tensor:
    """Plain torch version of `batched_ntt` (same arguments)."""
    c, n_in = x.shape
    n = 1 << log_n
    if shift is not None:
        x = gl.mul_plain(x, _device_powers(shift, n_in, x.device))
    if n_in < n:
        x = torch.nn.functional.pad(x, (0, n - n_in))
    x = x[:, torch.as_tensor(bit_reversal_perm(log_n), device=x.device)]
    tws = stage_twiddles(log_n, inverse)
    for s in range(1, log_n + 1):
        m = 1 << (s - 1)
        xs = x.reshape(c, n >> s, 2, m)
        even = xs[:, :, 0, :]
        odd = gl.mul_plain(xs[:, :, 1, :], gl.from_u64(tws[s - 1], x.device))
        x = torch.stack([gl.add_plain(even, odd), gl.sub_plain(even, odd)], dim=2)
        x = x.reshape(c, n)
    if inverse:
        x = gl.mul_plain(x, gl.felt(int(F.inv(np.uint64(n))), x.device))
    if out_shift is not None:
        x = gl.mul_plain(x, _device_powers(out_shift, n, x.device))
    return x


def batched_ntt(
    x: torch.Tensor, log_n: int, inverse: bool = False, shift: int | None = None,
    out_shift: int | None = None,
) -> torch.Tensor:
    """Kernel-3 transform of every row of x (C, n_in), n_in <= 2^log_n, for
    1 <= log_n <= MAX_LOG_N on every device (the CPU path keeps the kernel's
    limits).

    Element j of each row is first scaled by shift^j (when `shift` is given)
    and the rows are zero-padded to 2^log_n; `inverse` selects inverse twiddles and the 1/N
    scale; output element j is multiplied by out_shift^j (when given). Returns
    (C, 2^log_n) in natural order."""
    if x.dim() != 2 or x.shape[1] > 1 << log_n:
        raise ValueError(f"batched_ntt takes (C, n <= 2^{log_n}), got {tuple(x.shape)}")
    if not 1 <= log_n <= MAX_LOG_N:
        raise ValueError(
            f"NTT size 2^{log_n} outside the one-block kernel's range 2^1..2^{MAX_LOG_N}"
        )
    if x.device.type == "cpu":
        return batched_ntt_plain(x, log_n, inverse, shift, out_shift)
    _cuda.require_cuda_int64(x)
    x = x.contiguous()
    c, n_in = x.shape
    out = torch.empty((c, 1 << log_n), dtype=torch.int64, device=x.device)
    tw = _device_twiddles(log_n, inverse, x.device)
    sp = _device_powers(shift, n_in, x.device) if shift is not None else None
    post = _device_powers(out_shift, 1 << log_n, x.device) if out_shift is not None else None
    scale = int(F.inv(np.uint64(1 << log_n))) if inverse else 1
    err = _cuda.lib().qzk_ntt(
        x.data_ptr(), out.data_ptr(), tw.data_ptr(),
        None if sp is None else sp.data_ptr(),
        None if post is None else post.data_ptr(),
        c, n_in, log_n, scale, int(inverse), _cuda.stream(),
    )
    _cuda.check(err, "qzk_ntt")
    batched_ntt.launches += 1
    return out


batched_ntt.launches = 0


# ---------------------------------------------------------------------------
# the three modes, on (..., N) batches


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"size {n} is not a power of two")
    return log_n


def ntt(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """In-order radix-2 NTT along the last axis of (..., N)."""
    n = values.shape[-1]
    out = batched_ntt(values.reshape(-1, n), _log2(n), inverse=inverse)
    return out.reshape(values.shape)


def intt(values: torch.Tensor) -> torch.Tensor:
    return ntt(values, inverse=True)


def coset_intt(values: torch.Tensor) -> torch.Tensor:
    """Evaluations (..., N) over g * H, g the multiplicative group generator,
    -> coefficients: an inverse NTT with the g^-j unshift folded into the same
    launch."""
    n = values.shape[-1]
    unshift = int(F.inv(F.MULTIPLICATIVE_GROUP_GENERATOR))
    out = batched_ntt(values.reshape(-1, n), _log2(n), inverse=True, out_shift=unshift)
    return out.reshape(values.shape)


def coset_lde(coeffs: torch.Tensor, rate_bits: int, shift: int | None = None) -> torch.Tensor:
    """coeffs (..., N) -> evaluations over shift * H', |H'| = N << rate_bits."""
    n = coeffs.shape[-1]
    if shift is None:
        shift = int(F.MULTIPLICATIVE_GROUP_GENERATOR)
    out = batched_ntt(coeffs.reshape(-1, n), _log2(n) + rate_bits, shift=shift)
    return out.reshape(coeffs.shape[:-1] + (n << rate_bits,))
