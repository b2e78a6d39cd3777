"""Uniform canonical Goldilocks felts drawn on the device: kernel G.

The counterpart of the JAX package's `plonk/prover_fused.py::_rand_felts_j`,
which draws a device-rng ZK proof's blinding rows and oracle salts in the
graph. The port draws them with Philox4x64-10 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", 2011; the generator of numpy's
`np.random.Philox`): multipliers 0xD2E7470EE14C6C93 and 0xCA5A826395121157,
Weyl constants 0x9E3779B97F4A7C15 and 0xBB67AE8584CAA73B, ten rounds.

The mapping, for a proof key `key` (a u64), a stream number `stream` and
felt index i (row-major over the filled tensor's logical shape):

  * block b = i >> 1 is Philox4x64-10 with key (key, stream) and counter
    (b, 0, 0, 0): four u64 words w0, w1, w2, w3. It is numpy's
    `np.random.Philox(key=key + (stream << 64), counter=b - 1)
    .random_raw(4)`, since numpy advances the counter before it draws;
  * felt 2b is w0 if w0 < p, else w1 reduced by one conditional subtract
    of p; felt 2b + 1 is w2 if w2 < p, else w3 reduced alike. This is the
    JAX package's two-draws-and-select rule (prover_fused.py:398-403): the
    result is canonical, and uniform up to the 2^-64 chance that both
    words land in [p, 2^64).

A device-rng proof draws its key with `rng.integers(0, 2**63)` from the
proof's `np.random.default_rng(seed)` (prover_fused.py:1116) and uses
stream 0 for the blinding rows and streams 1-3 for the wires, zs_pp and
quotient salts, as the JAX package folds its key with 0 and 1 + i
(prover_fused.py:549, :561-563). The felts differ from the JAX package's
threefry bits, so such proofs are valid but not byte-equal to either
package's host-rng proofs.

`rand_felts` is the wrapper of kernel G (csrc/random.cu): on a CUDA tensor
it launches it (or raises), on a CPU tensor it runs `rand_felts_plain`,
which builds the 128-bit products from 32-bit limbs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _cuda
from . import goldilocks as gl

PHILOX_M = (0xD2E7470EE14C6C93, 0xCA5A826395121157)
PHILOX_W = (0x9E3779B97F4A7C15, 0xBB67AE8584CAA73B)
PHILOX_ROUNDS = 10
_U64 = (1 << 64) - 1


def _i64(v: int) -> int:
    """A u64 as the signed int64 with the same bit pattern."""
    v &= _U64
    return v - (1 << 64) if v >> 63 else v


def _check(key: int, stream: int, out: torch.Tensor) -> None:
    if not (0 <= key <= _U64 and 0 <= stream <= _U64):
        raise ValueError(f"Philox key ({key}, {stream}) outside u64")
    if out.dtype != torch.int64:
        raise TypeError(f"felt output dtype {out.dtype}, expected torch.int64")
    if out.dim() > 2:
        raise ValueError(f"kernel G fills a vector or a matrix, got {tuple(out.shape)}")


def philox_blocks_plain(key: int, stream: int, blocks: torch.Tensor) -> torch.Tensor:
    """Philox4x64-10 of counters (b, 0, 0, 0) for the int64 block indices
    `blocks` (B,) under key (key, stream): (B, 4) words as int64 bit
    patterns."""
    m0 = torch.tensor(_i64(PHILOX_M[0]), dtype=torch.int64, device=blocks.device)
    m1 = torch.tensor(_i64(PHILOX_M[1]), dtype=torch.int64, device=blocks.device)
    c0, c1 = blocks, torch.zeros_like(blocks)
    c2, c3 = torch.zeros_like(blocks), torch.zeros_like(blocks)
    k0, k1 = key, stream
    for r in range(PHILOX_ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _U64, (k1 + PHILOX_W[1]) & _U64
        lo0, hi0 = gl.mul128_plain(c0, m0)
        lo1, hi1 = gl.mul128_plain(c2, m1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ _i64(k0), lo1, hi0 ^ c3 ^ _i64(k1), lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _select(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """first if first < p, else second reduced by one subtract of p."""
    second = torch.where(gl._ge_p(second), second - gl.P_I64, second)
    return torch.where(gl._ge_p(first), second, first)


def rand_felts_plain(key: int, stream: int, out: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `rand_felts` (same arguments and result)."""
    _check(key, stream, out)
    count = out.numel()
    words = philox_blocks_plain(key, stream, torch.arange((count + 1) // 2, device=out.device))
    felts = torch.stack([_select(words[:, 0], words[:, 1]), _select(words[:, 2], words[:, 3])],
                        dim=-1).reshape(-1)[:count]
    out.copy_(felts.view(out.shape))
    return out


#: kernel G indexes felts in 32 bits: a draw holds fewer than 2^31
MAX_FELTS = (1 << 31) - 1


class RandPlan(NamedTuple):
    """Kernel G's launch arguments for one draw: the (rows, cols) view with
    its element strides, and whether a Philox block's two felts go out as
    one 16-byte store (`vec`)."""

    rows: int
    cols: int
    rs: int
    cs: int
    vec: bool


def rand_felts_plan(out: torch.Tensor) -> RandPlan:
    """Kernel G's plan for filling `out` (a vector or a matrix, any strides;
    nothing is launched). A vector is one row. `vec` holds when no block
    straddles a row and every block's pair is 16-byte aligned: unit column
    stride, an even row length, an even row stride (or one row) and a
    16-byte aligned start. Raises ValueError for a draw of 2^31 felts or
    more, which the kernel's 32-bit indices do not cover."""
    count = out.numel()
    if count > MAX_FELTS:
        raise ValueError(f"kernel G draws fewer than 2^31 felts a call (32-bit indices), "
                         f"got {count}")
    view = out.reshape(1, -1) if out.dim() < 2 else out
    rows, cols = view.shape
    rs, cs = view.stride()
    vec = (cs == 1 and cols % 2 == 0 and (rows == 1 or rs % 2 == 0)
           and view.data_ptr() % 16 == 0)
    return RandPlan(rows, cols, rs, cs, vec)


def rand_felts(key: int, stream: int, out: torch.Tensor) -> torch.Tensor:
    """Fill the int64 vector or matrix `out` (any strides: the trace's
    blinding columns `[:, rows_used:]` are filled in place) with the
    canonical felts of (key, stream), felt i at the i-th element in
    row-major order (the module docstring's mapping). Returns `out`.

    On a CUDA tensor: kernel G, one launch (`rand_felts_plan`; fewer than
    2^31 felts). On a CPU tensor: the plain version."""
    _check(key, stream, out)
    if out.device.type == "cpu":
        return rand_felts_plain(key, stream, out)
    _cuda.require_cuda_int64(out)
    if out.numel() == 0:
        return out
    plan = rand_felts_plan(out)
    with _cuda.on_device(out.device):
        err = _cuda.lib().qzk_rand_felts(out.data_ptr(), plan.rows, plan.cols, plan.rs, plan.cs,
                                         key, stream, int(plan.vec), _cuda.stream())
    _cuda.check(err, "qzk_rand_felts")
    rand_felts.launches += 1
    return out


rand_felts.launches = 0


class Draw(NamedTuple):
    """Felts drawn on the device: (key, stream) of `rand_felts`, for a
    commit's salt rows in device-rng mode."""

    key: int
    stream: int
