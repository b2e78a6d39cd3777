"""Batched NTT / iNTT / coset LDE over Goldilocks, on torch tensors.

Polynomials are processed as a batch (..., N) sharing one set of twiddles,
natural order in and out, evaluations f(w^i) at index i. The device work is
kernel 3 (csrc/ntt.cu) behind `batched_ntt`: one pass of register stages in
shared memory for N <= 2^12, two passes (the four-step split N = N1 N2
through a scratch buffer) above, up to 2^24; a one-pass coset LDE of
N >> r coefficients runs as 2^r transforms of that size. CPU tensors take its
plain torch version, the iterative radix-2 Cooley-Tukey of the JAX package
(a bit-reversed gather, then log N decimation-in-time stages). `ntt`,
`intt`, `coset_intt` and `coset_lde` are modes of it. `ntt_sharded`
transforms one polynomial whose coefficients are spread over a mesh's
shards, on kernel 3 and kernel H (csrc/shard.cu: `shard_deinterleave`,
`shard_cross_ntt`).
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

    with _cuda.on_device(dev):
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


# ---------------------------------------------------------------------------
# the coefficient-sharded NTT (kernel H and kernel 3 over a mesh axis)
#
# The JAX package's four-step decomposition N = D * L over D shards, the
# coefficients in contiguous blocks of L (poly/ntt.py:186-258 there):
#
#   X[L k1 + k2] = sum_{n1 < D} w_D^(n1 k1) w_N^(n1 k2)
#                    [sum_{n2 < L} w_L^(n2 k2) x[D n2 + n1]]
#
# Shard p: deinterleave its block (kernel H), exchange (block -> cyclic),
# a length-L kernel-3 NTT whose output multiplier w_N^p puts the shard's
# twiddle row w_N^(p k2) on output k2 (the inverse's 1/L folded in), exchange
# the k2 slabs, the length-D DFT across the received slab (kernel H, 1/D for
# the inverse), and a last exchange back to contiguous blocks.

#: kernel H's cross-shard DFT takes at most this many shards
MAX_SHARDS = 64


def _shard_bits(d: int) -> int:
    bits = d.bit_length() - 1
    if d < 1 or 1 << bits != d or d > MAX_SHARDS:
        raise ValueError(f"{d} shards: kernel H takes a power of two up to {MAX_SHARDS}")
    return bits


def shard_deinterleave_plain(x: torch.Tensor, d: int) -> torch.Tensor:
    """Plain torch version of `shard_deinterleave`."""
    _shard_bits(d)
    return x.reshape(-1, d).T.contiguous()


def shard_deinterleave(x: torch.Tensor, d: int) -> torch.Tensor:
    """Kernel H's first entry: a shard's block x (L,) read as (L/D, D) ->
    (D, L/D), row r the coefficients x[q D + r] (the slab for shard r).
    L / D must be a power of two. On a CUDA tensor: one launch; on a CPU
    tensor: the plain version."""
    bits = _shard_bits(d)
    rows = x.shape[-1] >> bits if x.dim() == 1 else 0
    if rows < 1 or rows << bits != x.shape[0] or rows & (rows - 1):
        raise ValueError(f"kernel H deinterleaves an (L,) block, L / {d} a power of two; "
                         f"got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return shard_deinterleave_plain(x, d)
    _cuda.require_cuda_int64(x)
    x = x.contiguous()
    out = torch.empty((d, rows), dtype=torch.int64, device=x.device)
    with _cuda.on_device(x.device):
        err = _cuda.lib().qzk_shard_deinterleave(x.data_ptr(), out.data_ptr(), rows, bits,
                                                 _cuda.stream())
    _cuda.check(err, "qzk_shard_deinterleave")
    shard_deinterleave.launches += 1
    return out


@functools.cache
def _cross_roots(d: int, inverse: bool) -> np.ndarray:
    """w_D^(+-j) for j < D, times 1/D for the inverse: kernel H's roots."""
    bits = d.bit_length() - 1
    roots = F.powers(_root(bits, inverse) if bits else np.uint64(1), d)
    return F.mul(roots, F.inv(np.uint64(d))) if inverse else roots


@functools.cache
def _cross_twiddles(d: int, inverse: bool) -> tuple[np.ndarray, int]:
    """Kernel H's radix-2 constants: w_D^(+-j) for j < D/2 (one, unused,
    for D = 1) and the scale of every output, 1/D for the inverse, else 1."""
    bits = d.bit_length() - 1
    roots = F.powers(_root(bits, inverse) if bits else np.uint64(1), max(d // 2, 1))
    scale = int(F.inv(np.uint64(d))) if inverse else 1
    return np.ascontiguousarray(roots, dtype=np.uint64), scale


def shard_cross_ntt_plain(z: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Plain torch version of `shard_cross_ntt`: the direct sum, one
    multiply-add of the (D, L/D) slab's row n1 a step."""
    d = z.shape[0]
    _shard_bits(d)
    roots = _cross_roots(d, inverse)
    k1 = np.arange(d)
    out = torch.zeros_like(z)
    for n1 in range(d):
        w = gl.from_u64(roots[(n1 * k1) % d], z.device).unsqueeze(1)  # (D, 1) over k1
        out = gl.add_plain(out, gl.mul_plain(z[n1].unsqueeze(0), w))
    return out


def shard_cross_ntt(z: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Kernel H's second entry: the length-D DFT across a received (D, L/D)
    slab, W[k1, t] = sum_n1 z[n1, t] w_D^(+-n1 k1), times 1/D for the
    inverse, written as (D, L/D) rows (row k1 the slab for shard k1). D a
    power of two up to MAX_SHARDS. On a CUDA tensor: one launch of the
    radix-2 kernel (`_cross_twiddles`); on a CPU tensor: the plain version,
    the direct sum."""
    if z.dim() != 2 or z.shape[1] < 1:
        raise ValueError(f"kernel H's DFT takes a (D, L/D) slab, got {tuple(z.shape)}")
    bits = _shard_bits(z.shape[0])
    if z.device.type == "cpu":
        return shard_cross_ntt_plain(z, inverse)
    _cuda.require_cuda_int64(z)
    z = z.contiguous()
    out = torch.empty_like(z)
    roots, scale = _cross_twiddles(z.shape[0], inverse)
    with _cuda.on_device(z.device):
        err = _cuda.lib().qzk_shard_cross_ntt(z.data_ptr(), out.data_ptr(), z.shape[1], bits,
                                              roots.ctypes.data, scale, _cuda.stream())
    _cuda.check(err, "qzk_shard_cross_ntt")
    shard_cross_ntt.launches += 1
    return out


shard_deinterleave.launches = 0
shard_cross_ntt.launches = 0


def ntt_sharded(values, mesh, inverse: bool = False) -> list[torch.Tensor]:
    """Radix-2 NTT of ONE polynomial sharded by coefficient over `mesh`'s
    `axis` (the JAX package's `ntt_sharded`).

    values: the (N,) coefficients, a tensor (cut into D contiguous blocks,
    block p copied to shard p) or the D blocks (L,) already on their
    shards. Returns the natural-order evaluations in the same block layout,
    block p on shard p; torch.cat of them equals `ntt(values, inverse)` bit
    for bit. Requires D | N/D."""
    from ..parallel import collectives as col

    devs = mesh.shards("cols")
    d = len(devs)
    n = sum(v.shape[-1] for v in values) if isinstance(values, (list, tuple)) else values.shape[-1]
    if (n // d) % d != 0:
        raise AssertionError("need D | N/D for the transpose algorithm")
    log_n = _log2(n)
    l = n // d
    blocks = list(values) if isinstance(values, (list, tuple)) else col.scatter(values, devs)
    if len(blocks) != d or any(b.shape != (l,) or b.device != dev for b, dev in zip(blocks, devs)):
        raise ValueError(f"ntt_sharded takes {d} blocks ({l},), block p on shard p")
    w = _root(log_n, inverse)
    # block -> cyclic: shard p then holds x[D n2 + p] over n2
    xc = col.all_to_all([shard_deinterleave(b, d) for b in blocks], 0, 0)
    # the local length-L NTT, output k2 times w_N^(p k2)
    ys = [batched_ntt(x.view(1, l), log_n - (d.bit_length() - 1), inverse,
                      out_shift=int(F.pow_scalar(w, p)) if p else None).view(d, l // d)
          for p, x in enumerate(xc)]
    # the k2 slabs out, the n1 rows in: shard p holds [n1, t] of k2 = p L/D + t
    zs = col.all_to_all(ys, 0, 0)
    # the length-D DFT over n1; row k1 goes to shard k1
    out = col.all_to_all([shard_cross_ntt(z, inverse) for z in zs], 0, 0)
    return [o.view(l) for o in out]
