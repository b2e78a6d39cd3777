"""Goldilocks field arithmetic on torch int64 tensors, p = 2^64 - 2^32 + 1.

A felt is one int64 tensor element holding the u64 bit pattern, canonical in
[0, p). (The JAX package carries (lo, hi) u32 pairs only because the TPU has
no 64-bit integer path.) At numpy boundaries values are numpy uint64, as in
the JAX package.

`add`, `sub` and `mul` are the wrappers of kernel 1 (csrc/field_kernels.cu):
on a CUDA tensor they launch it (or raise), on a CPU tensor they run the
plain versions below. Torch on the CPU has no uint64 add, sub, shift or
compare, so the plain versions emulate the unsigned compare by flipping the
sign bit and build the 128-bit product from 32-bit limbs, following
`gf_np.py` step for step. Everything else here (`neg`, `sqr`, `exp7`, `inv`,
`powers`, `sum_tree`, `prod_tree`) is composed from the three wrappers.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _cuda

P = 0xFFFFFFFF00000001
EPS = 0xFFFFFFFF  # 2^64 mod p
M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
P_I64 = P - (1 << 64)  # p's bit pattern as a signed int64
_P_FLIPPED = P ^ (1 << 63)  # p with the sign bit flipped, for unsigned compare


# ---------------------------------------------------------------------------
# conversions


def _signed(value: int) -> int:
    """A canonical felt as the signed int64 with the same bit pattern."""
    v = int(value) % P
    return v - (1 << 64) if v >= 1 << 63 else v


def from_u64(x, device) -> torch.Tensor:
    """numpy uint64 array (canonical) -> int64 tensor on `device`."""
    arr = np.array(x, dtype=np.uint64).view(np.int64)
    return torch.as_tensor(arr, device=device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array (a host copy)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint64).copy()


def felt(value: int, device) -> torch.Tensor:
    """A 0-d felt tensor."""
    return torch.tensor(_signed(value), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _ge_p(x: torch.Tensor) -> torch.Tensor:
    return (x ^ _SIGN) >= _P_FLIPPED


# A conditional correction is `torch.add(x, condition, alpha=k)`: x + k
# where the condition holds, in one op (wrapping, as int64 arithmetic does).


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    s = torch.add(s, ult(s, a), alpha=EPS)
    return torch.add(s, _ge_p(s), alpha=-P_I64)


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.add(a - b, ult(a, b), alpha=-EPS)


def _reduce128(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo + hi * 2^64) mod p, canonical (gf_np.reduce128)."""
    hi_hi = (hi >> 32) & M32
    hi_lo = hi & M32
    t0 = torch.add(lo - hi_hi, ult(lo, hi_hi), alpha=-EPS)
    t1 = (hi_lo << 32) - hi_lo  # hi_lo * EPS < 2^64
    t2 = t0 + t1
    t2 = torch.add(t2, ult(t2, t0), alpha=EPS)
    return torch.add(t2, _ge_p(t2), alpha=-P_I64)


def mul128_plain(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 128-bit product of two u64 bit patterns, (lo, hi), from 32-bit
    limbs."""
    a0, a1 = a & M32, (a >> 32) & M32
    b0, b1 = b & M32, (b >> 32) & M32
    lh = a0 * b1
    hl = a1 * b0
    # middle 32-bit column: < 3 * 2^32, no overflow
    t = (((a0 * b0) >> 32) & M32) + (lh & M32) + (hl & M32)
    hi = a1 * b1 + ((lh >> 32) & M32) + ((hl >> 32) & M32) + (t >> 32)
    return a * b, hi  # the low word: int64 products wrap


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce128(*mul128_plain(a, b))


# ---------------------------------------------------------------------------
# kernel 1 wrappers


_OP_ADD, _OP_SUB, _OP_MUL = 0, 1, 2


def _launch_binary(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _cuda.require_cuda_int64(a, b)
    a, b = (t.contiguous() for t in torch.broadcast_tensors(a, b))
    out = torch.empty(a.shape, dtype=torch.int64, device=a.device)
    with _cuda.on_device(a.device):
        err = _cuda.lib().qzk_field_binary(
            op, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), _cuda.stream()
        )
    _cuda.check(err, "qzk_field_binary")
    return out


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a + b mod p (broadcasting)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return add_plain(a, b)
    out = _launch_binary(_OP_ADD, a, b)
    add.launches += 1
    return out


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a - b mod p (broadcasting)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return sub_plain(a, b)
    out = _launch_binary(_OP_SUB, a, b)
    sub.launches += 1
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical a * b mod p (broadcasting)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_plain(a, b)
    out = _launch_binary(_OP_MUL, a, b)
    mul.launches += 1
    return out


add.launches = 0
sub.launches = 0
mul.launches = 0


# ---------------------------------------------------------------------------
# composed ops


def mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    return mul(a, felt(c, a.device))


def add_const(a: torch.Tensor, c: int) -> torch.Tensor:
    return add(a, felt(c, a.device))


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def exp7(a: torch.Tensor) -> torch.Tensor:
    """a^7, the Poseidon2 S-box: a2, a4, a6 = a4*a2, a7 = a6*a."""
    a2 = sqr(a)
    a4 = sqr(a2)
    return mul(mul(a4, a2), a)


def pow_const(a: torch.Tensor, exp: int) -> torch.Tensor:
    """a ** exp for a Python-int exponent (square and multiply)."""
    e = int(exp)
    result = torch.ones_like(a)
    acc = a
    while e > 0:
        if e & 1:
            result = mul(result, acc)
        e >>= 1
        if e:
            acc = sqr(acc)
    return result


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2), elementwise; inv(0) = 0."""
    return pow_const(a, P - 2)


def powers(base: torch.Tensor, n: int) -> torch.Tensor:
    """[1, b, b^2, ..., b^(n-1)] for a 0-d felt tensor `base`, by doubling."""
    out = torch.ones(1, dtype=torch.int64, device=base.device)
    step = base
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, step)])
        step = sqr(step)
    return out[:n]


def _tree(op, a: torch.Tensor, dim: int) -> torch.Tensor:
    """Reduce `dim` (length >= 1) with `op` by successive halving."""
    while a.shape[dim] > 1:
        n = a.shape[dim]
        half = n // 2
        r = op(a.narrow(dim, 0, half), a.narrow(dim, half, half))
        if n % 2:
            r = torch.cat([r, a.narrow(dim, 2 * half, 1)], dim=dim)
        a = r
    return a.squeeze(dim)


def sum_tree(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Field sum along `dim` (the dim is removed)."""
    return _tree(add, a, dim)


def prod_tree(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Field product along `dim` (the dim is removed)."""
    return _tree(mul, a, dim)
