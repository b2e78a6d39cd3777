"""Batched NTT / iNTT / coset LDE over Goldilocks, on torch tensors.

Polynomials are processed as a batch (..., N) sharing one set of twiddles,
natural order in and out, evaluations f(w^i) at index i. The device work is
kernel 3 (csrc/ntt.cu) behind `batched_ntt`: one pass of register stages in
shared memory for N <= 2^12, two passes (the four-step split N = N1 N2
through a scratch buffer) above, up to 2^24; a one-pass coset LDE of
N >> r coefficients runs as 2^r transforms of that size. CPU tensors take its
plain torch version, the iterative radix-2 Cooley-Tukey of the JAX package
(a bit-reversed gather, then log N decimation-in-time stages). `ntt`,
`intt`, `coset_intt` and `coset_lde` are modes of it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from ..field import gf_np as F
from ..field import goldilocks as gl

#: two passes of at most 2^12 points each
MAX_LOG_N = 24
#: the points one pass transforms in one block
MAX_PASS_LOG_N = 12


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


def _root(log_n: int, inverse: bool) -> np.uint64:
    w = F.primitive_root_of_unity(log_n)
    return F.inv(w) if inverse else w


@functools.cache
def stage_twiddles(log_n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Twiddles per stage s = 1..log_n: w_{2^s}^j for j < 2^(s-1)."""
    return tuple(F.powers_table(_root(s, inverse), 1 << (s - 1)) for s in range(1, log_n + 1))


def pass_bits(log_n: int) -> tuple[int, int]:
    """(log N1, log N2) of kernel 3's passes: (log_n, 0) for one pass."""
    if log_n <= MAX_PASS_LOG_N:
        return log_n, 0
    return (log_n + 1) // 2, log_n // 2


@functools.cache
def _device_root_powers(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """w^e for e < 2^(log_n - 1), w the primitive 2^log_n-th root (inverse)."""
    return gl.from_u64(F.powers_table(_root(log_n, inverse), 1 << (log_n - 1)), device)


#: up to 2^20 points kernel 3's four-step twiddle is one table of N felts
FULL_TWIDDLE_LOG_N = 20


@functools.cache
def _device_four_step(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """The four-step twiddle w_N^e: for e < N up to 2^FULL_TWIDDLE_LOG_N
    points; above, two tables, w_N^e for e < 2^h, then w_N^(2^h e') for
    e' < 2^(log_n - h), h = (log_n + 1) // 2."""
    w = _root(log_n, inverse)
    if log_n <= FULL_TWIDDLE_LOG_N:
        return gl.from_u64(F.powers_table(w, 1 << log_n), device)
    h = (log_n + 1) // 2
    lo = F.powers_table(w, 1 << h)
    hi = F.powers_table(F.pow_scalar(w, 1 << h), 1 << (log_n - h))
    return gl.from_u64(np.concatenate([lo, hi]), device)


@functools.cache
def _device_coset_powers(shift: int, log_n: int, rate_bits: int, device: torch.device) -> torch.Tensor:
    """(2^rate_bits, 2^(log_n - rate_bits)): row r holds (shift w_N^r)^k,
    w_N the primitive 2^log_n-th root."""
    w = _root(log_n, False)
    bases = F.mul(np.uint64(shift), F.powers(w, 1 << rate_bits))
    n = 1 << (log_n - rate_bits)
    return gl.from_u64(np.stack([F.powers_table(b, n) for b in bases]), device)


@functools.cache
def _device_powers(base: int, n: int, device: torch.device, scale: int = 1) -> torch.Tensor:
    """scale * base^j for j < n."""
    pows = F.powers_table(np.uint64(base), n)
    if scale != 1:
        pows = F.mul(pows, np.uint64(scale))
    return gl.from_u64(pows, device)


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


def _out_groups(out: torch.Tensor | None, cols: int, n: int) -> tuple[int, int]:
    """(columns a group, values between groups) of an output buffer: a
    contiguous (cols, n) matrix (or (G, cols / G, n) stack) is one group
    (0, 0); a (G, cols / G, n) view with rows n apart is G groups of its
    stride(0) (a batch's LDEs, each followed by its salt rows)."""
    if out is None:
        return 0, 0
    if out.dtype != torch.int64 or out.device.type not in ("cpu", "cuda"):
        raise TypeError(f"NTT output {out.dtype} on {out.device}, expected int64")
    if out.numel() == cols * n and out.shape[-1] == n and out.is_contiguous():
        return 0, 0
    if (out.dim() == 3 and out.shape[0] * out.shape[1] == cols and out.shape[2] == n
            and out.stride()[1:] == (n, 1) and out.stride(0) >= out.shape[1] * n):
        return out.shape[1], out.stride(0)
    raise ValueError(f"NTT output {tuple(out.shape)} strides {out.stride()}: kernel 3 writes "
                     f"a contiguous ({cols}, {n}) matrix or (G, {cols} / G, {n}) rows n apart")


def batched_ntt(
    x: torch.Tensor, log_n: int, inverse: bool = False, shift: int | None = None,
    out_shift: int | None = None, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kernel-3 transform of every row of x (C, n_in), 1 <= n_in <= 2^log_n,
    for 1 <= log_n <= MAX_LOG_N on every device.

    Element j of each row is first scaled by shift^j (when `shift` is given)
    and the rows are zero-padded to 2^log_n; `inverse` selects inverse twiddles and the 1/N
    scale; output element j is multiplied by out_shift^j (when given). Returns
    (C, 2^log_n) in natural order, or writes it into `out` and returns `out`:
    a contiguous (C, 2^log_n) matrix, or a (G, C / G, 2^log_n) view whose
    groups lie stride(0) apart (the first rows of each proof's salted LDE
    buffer). One launch a pass (`pass_bits`)."""
    if x.dim() != 2 or not 1 <= x.shape[1] <= 1 << log_n:
        raise ValueError(f"batched_ntt takes (C, 1 <= n <= 2^{log_n}), got {tuple(x.shape)}")
    if not 1 <= log_n <= MAX_LOG_N:
        raise ValueError(f"NTT size 2^{log_n} outside kernel 3's range 2^1..2^{MAX_LOG_N}")
    groups = _out_groups(out, x.shape[0], 1 << log_n)
    if x.device.type == "cpu":
        res = batched_ntt_plain(x, log_n, inverse, shift, out_shift)
        return res if out is None else out.copy_(res.view(out.shape))
    _cuda.require_cuda_int64(x, *(() if out is None else (out,)))
    return _launch_ntt(x.contiguous(), log_n, inverse, shift, out_shift, out, groups)


def _launch_ntt(x, log_n, inverse, shift, out_shift, out=None, groups=(0, 0)):
    dev = x.device
    c, n_in = x.shape
    n = 1 << log_n
    l1, l2 = pass_bits(log_n)
    # a one-pass LDE of 2^(log_n - r) inputs runs as 2^r transforms of that size
    coset_bits = log_n - (n_in.bit_length() - 1) if (
        shift is not None and not l2 and not inverse and n_in & (n_in - 1) == 0 and 1 < n_in < n
    ) else 0
    if out is None:
        out = torch.empty((c, n), dtype=torch.int64, device=dev)
    scratch = torch.empty((c, n), dtype=torch.int64, device=dev) if l2 else None
    tw1 = _device_root_powers(l1 - coset_bits, inverse, dev)
    tw2 = _device_root_powers(l2, inverse, dev) if l2 else None
    twn = _device_four_step(log_n, inverse, dev) if l2 else None
    scale = int(F.inv(np.uint64(n))) if inverse else 1
    if coset_bits:
        pre = _device_coset_powers(shift, log_n, coset_bits, dev)
    else:
        pre = _device_powers(shift, n_in, dev) if shift is not None else None
    post = _device_powers(out_shift, n, dev, scale) if out_shift is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _cuda.lib().qzk_ntt(
        x.data_ptr(), out.data_ptr(), ptr(scratch), tw1.data_ptr(), ptr(tw2), ptr(twn),
        ptr(pre), ptr(post), c, n_in, log_n, l1, coset_bits, scale, int(inverse), *groups,
        _cuda.stream(),
    )
    _cuda.check(err, "qzk_ntt")
    batched_ntt.launches += 2 if l2 else 1
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


def coset_lde(coeffs: torch.Tensor, rate_bits: int, shift: int | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """coeffs (..., N) -> evaluations over shift * H', |H'| = N << rate_bits;
    with `out`, written there (`batched_ntt`'s output forms)."""
    n = coeffs.shape[-1]
    if shift is None:
        shift = int(F.MULTIPLICATIVE_GROUP_GENERATOR)
    res = batched_ntt(coeffs.reshape(-1, n), _log2(n) + rate_bits, shift=shift, out=out)
    return res if out is not None else res.reshape(coeffs.shape[:-1] + (n << rate_bits,))
