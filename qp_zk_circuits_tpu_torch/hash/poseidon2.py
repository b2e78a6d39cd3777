"""Poseidon2 over Goldilocks: width 12, rate 8, 4-felt digest, x^7 S-box.

The reference consumes Poseidon2 both natively (`Poseidon2Hash::hash_no_pad`,
reference `wormhole/circuit/src/nullifier.rs:119-120`) and in-circuit
(`hash_n_to_hash_no_pad_p2`, `zk_merkle_proof.rs:504`); the gate needs 135 wire
columns at constraint degree 7 (`common/src/circuit.rs:431-449`). Parameters:

  t = 12 lanes, R_F = 8 external rounds (4 + 4), R_P = 22 internal rounds,
  S-box x^7, digest = 4 felts, sponge rate 8 / capacity 4.

Constant tables are the published Poseidon2 Goldilocks t=12 instance
(HorizenLabs `poseidon2_instance_goldilocks.rs`, as used by the plonky2-class
forks): the external/internal round constants are generated by the Grain-LFSR
procedure of the Poseidon reference spec with (field=1, sbox=0, n=64, t=12,
R_F=8, R_P=22) — external 8x12 first, then the 22 internal singles — and the
internal-matrix diagonal is the published `MAT_DIAG12_M_1` vector
(`_MAT_DIAG12_M_1` below). The derivation is cross-pinned in
tests/test_poseidon2.py: the first drawn constant must equal the published
table head 0x13dcf33aba214f46, and the frozen KAT digests lock the whole
instance. The upstream `qp-poseidon-core` crate (the chain-side hasher,
reference Cargo pin 3.1.0) hard-codes its own unpublished tables that are not
recoverable from the reference repo (the crate is not vendored and the
pinned block-hash fixtures do not match any Grain parameterization we
searched — 112+ encoding/sponge/table variants); `_constants()` remains the
single swap point should those tables become available.

Two implementations, tested bit-identical:
  * host: the C library of native/ (transcript, witness generation, host
    hashing) behind `permute_np`, `hash_no_pad` and `two_to_one_np`; the
    pure-Python forms (`_permute_scalar_pure`, `_permute_np_pure`,
    `_hash_no_pad_pure`, `_two_to_one_pure`) are the tests' oracles;
  * device: kernel 2 (csrc/poseidon2.cu) behind `permute`, `hash_rows`,
    `two_to_one` and `merkle_levels` on int64 tensors, with plain torch
    versions for CPU tensors — the PoW grind, and a Merkle tree (leaf
    hashing and every level up to the cap) in one call.

Kernel 2 has two forms of the permutation (csrc/poseidon2.cu), one per
wrapper at every size: `permute` runs one thread a state (its caller, the
grind, launches 2^17 states, enough to fill the card); `merkle_levels`,
`hash_rows` and `two_to_one` run the lane-split form, four threads a state,
which gives a leaf commit's 2048 rows four times the warps. The prover
builds every tree through `merkle_levels`; `hash_rows` and `two_to_one` are
the same kernels' flat forms, with no caller in the prover.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from .. import native as nat
from ..field import gf_np as F
from ..field import goldilocks as gl

WIDTH = 12
RATE = 8
CAPACITY = 4
DIGEST_LEN = 4  # POSEIDON2_OUTPUT in the reference (common/src/serialization.rs:18)
ROUNDS_F = 8  # external (full) rounds, split 4 + 4
ROUNDS_P = 22  # internal (partial) rounds
SBOX_DEGREE = 7

_P_INT = 0xFFFFFFFF00000001


# ---------------------------------------------------------------------------
# Grain-LFSR parameter generation (Poseidon reference spec, § "Initialization")


def _grain_stream(n: int, t: int, r_f: int, r_p: int):
    """Yield self-filtered Grain LFSR bits for (prime field, x^alpha sbox)."""
    bits = []
    for value, width in ((1, 2), (0, 4), (n, 12), (t, 12), (r_f, 10), (r_p, 10)):
        bits.extend(int(b) for b in bin(value)[2:].zfill(width))
    bits.extend([1] * 30)
    assert len(bits) == 80
    state = bits[:]  # state[0] is the oldest bit

    def step():
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        step()
    while True:
        if step() == 1:
            yield step()
        else:
            step()


def _grain_felts(count: int, stream) -> list[int]:
    """Draw `count` field elements by 64-bit rejection sampling."""
    out = []
    while len(out) < count:
        v = 0
        for _ in range(64):
            v = (v << 1) | next(stream)
        if v < _P_INT:
            out.append(v)
    return out


# Published internal-matrix diagonal for the Goldilocks t=12 instance
# (HorizenLabs poseidon2_instance_goldilocks.rs, MAT_DIAG12_M_1):
# M_I(x)_i = mu_i * x_i + sum_j x_j.
_MAT_DIAG12_M_1 = (
    0xC3B6C08E23BA9300,
    0xD84B5DE94A324FB6,
    0x0D0C371C5B35B84F,
    0x7964F570E7188037,
    0x5DAF18BBD996604B,
    0x6743BC47B9595257,
    0x5528B9362C59BB70,
    0xAC45E25B7127B68B,
    0xA2077D7DFBB606B5,
    0xF3FAAC6FAEE378AE,
    0x0C6388B51545E883,
    0xD27DBB6944917B60,
)


@functools.cache
def _constants():
    stream = _grain_stream(64, WIDTH, ROUNDS_F, ROUNDS_P)
    ext_rcs = np.array(
        _grain_felts(ROUNDS_F * WIDTH, stream), dtype=np.uint64
    ).reshape(ROUNDS_F, WIDTH)
    int_rcs = np.array(_grain_felts(ROUNDS_P, stream), dtype=np.uint64)
    diag = np.array(_MAT_DIAG12_M_1, dtype=np.uint64)
    assert _internal_matrix_invertible(diag)
    return ext_rcs, int_rcs, diag


def _internal_matrix_invertible(diag: np.ndarray) -> bool:
    """Check det(diag(mu) + J) != 0 via exact integer Gaussian elimination mod p."""
    m = [[(int(diag[i]) + 1) % _P_INT if i == j else 1 for j in range(WIDTH)] for i in range(WIDTH)]
    det = 1
    for col in range(WIDTH):
        piv = next((r for r in range(col, WIDTH) if m[r][col] % _P_INT != 0), None)
        if piv is None:
            return False
        if piv != col:
            m[col], m[piv] = m[piv], m[col]
            det = -det
        det = det * m[col][col] % _P_INT
        inv = pow(m[col][col], _P_INT - 2, _P_INT)
        for r in range(col + 1, WIDTH):
            f = m[r][col] * inv % _P_INT
            if f:
                for c in range(col, WIDTH):
                    m[r][c] = (m[r][c] - f * m[col][c]) % _P_INT
    return det % _P_INT != 0


def external_round_constants() -> np.ndarray:
    return _constants()[0]


def internal_round_constants() -> np.ndarray:
    return _constants()[1]


def internal_diag() -> np.ndarray:
    return _constants()[2]


# M4 block of the external linear layer (Poseidon2 paper, eq. 3).
_M4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6))


# ---------------------------------------------------------------------------
# host permutation, state shape (..., 12): `permute_np` in the C library; the
# numpy and Python-int forms are the tests' oracles


def _sbox_np(x):
    x2 = F.mul(x, x)
    x4 = F.mul(x2, x2)
    return F.mul(F.mul(x4, x2), x)


def _external_linear_np(state):
    """M_E = circ(2*M4, M4, M4): per-group M4, then add the group-sum."""
    g = state.reshape(state.shape[:-1] + (3, 4))
    cols = [g[..., j] for j in range(4)]
    y = [None] * 4
    for i in range(4):
        acc = None
        for j in range(4):
            term = F.mul(np.uint64(_M4[i][j]), cols[j])
            acc = term if acc is None else F.add(acc, term)
        y[i] = acc
    y = np.stack(y, axis=-1)  # (..., 3, 4)
    s = y[..., 0, :]
    for k in range(1, 3):
        s = F.add(s, y[..., k, :])
    out = F.add(y, s[..., None, :])
    return out.reshape(state.shape)


def _internal_linear_np(state, diag):
    total = state[..., 0]
    for i in range(1, WIDTH):
        total = F.add(total, state[..., i])
    return F.add(F.mul(state, diag), total[..., None])


@functools.cache
def _int_constants():
    ext_rcs, int_rcs, diag = _constants()
    return (
        [[int(v) for v in row] for row in ext_rcs],
        [int(v) for v in int_rcs],
        [int(v) for v in diag],
    )


def _scalar_ext_linear(s):
    """External linear layer on a 12-list of Python ints (shared helper)."""
    m4 = _M4
    y = []
    for g in range(3):
        b = s[4 * g : 4 * g + 4]
        for i in range(4):
            r = m4[i]
            y.append(r[0] * b[0] + r[1] * b[1] + r[2] * b[2] + r[3] * b[3])
    t = (y[0] + y[4] + y[8], y[1] + y[5] + y[9], y[2] + y[6] + y[10], y[3] + y[7] + y[11])
    return [(y[i] + t[i & 3]) % _P_INT for i in range(12)]


def _permute_scalar_pure(state) -> list[int]:
    """Single-state permutation in pure Python ints (the tests' oracle)."""
    ext_rcs, int_rcs, diag = _int_constants()
    ext_linear = _scalar_ext_linear
    x = ext_linear([int(v) for v in state])
    for r in range(4):
        rc = ext_rcs[r]
        x = ext_linear([pow(x[i] + rc[i], 7, _P_INT) for i in range(12)])
    for k in range(ROUNDS_P):
        x0 = pow(x[0] + int_rcs[k], 7, _P_INT)
        x[0] = x0
        tot = sum(x)
        x = [(diag[i] * x[i] + tot) % _P_INT for i in range(12)]
    for r in range(4, 8):
        rc = ext_rcs[r]
        x = ext_linear([pow(x[i] + rc[i], 7, _P_INT) for i in range(12)])
    return x


def permute_np(state: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation on host; state (..., 12) uint64 canonical, in
    the C library."""
    return nat.permute_batch(state)


def _permute_np_pure(state: np.ndarray) -> np.ndarray:
    """Vectorised numpy permutation (the tests' oracle)."""
    ext_rcs, int_rcs, diag = _constants()
    x = _external_linear_np(np.asarray(state, dtype=np.uint64))
    for r in range(4):
        x = F.add(x, ext_rcs[r])
        x = _sbox_np(x)
        x = _external_linear_np(x)
    for r in range(ROUNDS_P):
        x0 = F.add(x[..., 0], int_rcs[r])
        x = np.concatenate([_sbox_np(x0)[..., None], x[..., 1:]], axis=-1)
        x = _internal_linear_np(x, diag)
    for r in range(4, 8):
        x = F.add(x, ext_rcs[r])
        x = _sbox_np(x)
        x = _external_linear_np(x)
    return x


# ---------------------------------------------------------------------------
# sponges (host). Mirrors plonky2's overwrite-mode duplex construction.


def hash_no_pad(inputs: np.ndarray) -> np.ndarray:
    """plonky2-style hash_n_to_hash_no_pad: absorb rate-8 chunks (overwrite),
    permute per chunk, squeeze 4. inputs: 1-D uint64 felts. In the C
    library."""
    return nat.hash_no_pad(inputs)


def _hash_no_pad_pure(inputs: np.ndarray) -> np.ndarray:
    """hash_no_pad in pure Python ints (the tests' oracle)."""
    state = [0] * WIDTH
    felts = [int(v) for v in np.asarray(inputs, dtype=np.uint64).ravel()]
    for start in range(0, len(felts), RATE):
        chunk = felts[start : start + RATE]
        state[: len(chunk)] = chunk
        state = _permute_scalar_pure(state)
    return np.array(state[:DIGEST_LEN], dtype=np.uint64)


def hash_padded(inputs: np.ndarray) -> np.ndarray:
    """Sponge with 10* padding of the FINAL PARTIAL block only: if the input
    already fills whole rate blocks, no padding is appended (so a 16-felt node
    preimage hashes identically to plain hash_no_pad — pinned by the
    reference's spec-differential `node_hash_matches_spec`, which equates the
    chain's compact node hash with `Poseidon2Hash::hash_no_pad` on 16 felts);
    otherwise append a 1-felt and zero-fill the block (binds the felt count
    within a block — reference `common/src/serialization.rs:187-218`)."""
    inputs = np.asarray(inputs, dtype=np.uint64)
    if len(inputs) > 0 and len(inputs) % RATE == 0:
        return hash_no_pad(inputs)
    padded_len = ((len(inputs) + 1 + RATE - 1) // RATE) * RATE
    padded = np.zeros(padded_len, dtype=np.uint64)
    padded[: len(inputs)] = inputs
    padded[len(inputs)] = 1
    return hash_no_pad(padded)


def two_to_one_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Merkle 2-to-1 compression: state = [left(4) | right(4) | 0^4], one
    permute, in the C library."""
    return nat.two_to_one_many(left, right)[0]


def _two_to_one_pure(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """two_to_one_np in pure Python ints (the tests' oracle)."""
    state = [int(v) for v in np.asarray(left, dtype=np.uint64).ravel()]
    state += [int(v) for v in np.asarray(right, dtype=np.uint64).ravel()] + [0] * CAPACITY
    return np.array(_permute_scalar_pure(state)[:DIGEST_LEN], dtype=np.uint64)


def hash_or_noop(inputs: np.ndarray) -> np.ndarray:
    """<=4 felts: zero-padded copy (no permutation); else hash_no_pad."""
    inputs = np.asarray(inputs, dtype=np.uint64)
    if len(inputs) <= DIGEST_LEN:
        out = np.zeros(DIGEST_LEN, dtype=np.uint64)
        out[: len(inputs)] = inputs
        return out
    return hash_no_pad(inputs)


# ---------------------------------------------------------------------------
# device (torch) permutation — int64 tensors with trailing axis 12


@functools.cache
def _const_tensors(device: torch.device):
    ext_rcs, int_rcs, diag = _constants()
    return (
        gl.from_u64(ext_rcs, device),
        gl.from_u64(int_rcs, device),
        gl.from_u64(diag, device),
    )


def _reduce_sums_plain(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(hi * 2^32 + lo) mod p, canonical, for sums of 32-bit limbs lo, hi <
    2^40: one reduction for a whole linear combination with small
    coefficients."""
    h = hi + (lo >> 32)
    a = ((h & gl.M32) << 32) | (lo & gl.M32)
    a = torch.add(a, gl._ge_p(a), alpha=-gl.P_I64)
    top = h >> 32  # top * 2^64 = top * (2^32 - 1) mod p, below p
    return gl.add_plain(a, (top << 32) - top)


def _limbs(x: torch.Tensor) -> torch.Tensor:
    """(2, ...) the low and high 32-bit limbs of u64 bit patterns."""
    return torch.stack([x & gl.M32, (x >> 32) & gl.M32])


def _ext_linear_plain(x: torch.Tensor) -> torch.Tensor:
    """The external layer: M4 on each group of 4, then each output plus the
    sum over the three groups of its position, i.e. M4 applied to x_g plus
    the groups' sum; on 32-bit limbs (a coefficient sum of 64, so below
    2^38) with one reduction at the end. M4 (`_M4`) by an addition chain:
    rows t3 + t5, t5, t2 + t4, t4."""
    lm = _limbs(x.reshape(x.shape[:-1] + (3, 4)))
    lm = lm + lm.sum(dim=-2, keepdim=True)
    x0, x1, x2, x3 = lm.unbind(-1)
    t0 = x0 + x1
    t1 = x2 + x3
    t2 = x1 + x1 + t1
    t3 = x3 + x3 + t0
    t4 = 4 * t1 + t3
    t5 = 4 * t0 + t2
    y = torch.stack([t3 + t5, t5, t2 + t4, t4], dim=-1)
    return _reduce_sums_plain(y[0], y[1]).reshape(x.shape)


def _sbox_plain(x: torch.Tensor) -> torch.Tensor:
    x2 = gl.mul_plain(x, x)
    x4 = gl.mul_plain(x2, x2)
    return gl.mul_plain(gl.mul_plain(x4, x2), x)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain torch Poseidon2 on (..., 12) int64 felts (`_permute_np_pure`)."""
    ext_rcs, int_rcs, diag = _const_tensors(state.device)
    x = _ext_linear_plain(state)
    for r in range(4):
        x = _ext_linear_plain(_sbox_plain(gl.add_plain(x, ext_rcs[r])))
    for r in range(ROUNDS_P):
        x0 = _sbox_plain(gl.add_plain(x[..., :1], int_rcs[r]))
        x = torch.cat([x0, x[..., 1:]], dim=-1)
        total = _reduce_sums_plain(*_limbs(x).sum(dim=-1, keepdim=True))
        x = gl.add_plain(gl.mul_plain(x, diag), total)
    for r in range(4, 8):
        x = _ext_linear_plain(_sbox_plain(gl.add_plain(x, ext_rcs[r])))
    return x


def hash_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain torch hash_or_noop of every row: (R, C) -> (R, 4)."""
    r, c = rows.shape
    if c <= DIGEST_LEN:
        return torch.nn.functional.pad(rows, (0, DIGEST_LEN - c))
    state = torch.zeros((r, WIDTH), dtype=torch.int64, device=rows.device)
    for start in range(0, c, RATE):
        chunk = rows[:, start : start + RATE]
        state = permute_plain(torch.cat([chunk, state[:, chunk.shape[1] :]], dim=1))
    return state[:, :DIGEST_LEN]


def two_to_one_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Plain torch 2-to-1 compression: (B, 4) x (B, 4) -> (B, 4)."""
    zeros = torch.zeros_like(left)
    return permute_plain(torch.cat([left, right, zeros], dim=-1))[:, :DIGEST_LEN]


def merkle_levels_plain(leaves: torch.Tensor, cap_height: int) -> list[torch.Tensor]:
    """Plain torch Merkle levels: the leaf digests (hash_or_noop of each row),
    then node i of level l + 1 = two_to_one(level_l[2i], level_l[2i + 1]),
    up to the cap of 2^cap_height digests; views of one buffer, as the
    kernel's."""
    _tree_height(leaves, cap_height)
    cur = hash_rows_plain(leaves)
    levels = [cur]
    while cur.shape[0] > 1 << cap_height:
        cur = two_to_one_plain(cur[0::2], cur[1::2])
        levels.append(cur)
    return list(torch.cat(levels).split([lvl.shape[0] for lvl in levels]))


def _tree_height(leaves: torch.Tensor, cap_height: int) -> int:
    """log2 of the leaf count; raises unless the tree is well formed."""
    if leaves.dim() != 2:
        raise ValueError(f"a Merkle tree takes an (L, K) matrix, got {tuple(leaves.shape)}")
    n = leaves.shape[0]
    log_n = n.bit_length() - 1
    if n == 0 or 1 << log_n != n:
        raise ValueError("leaf count must be a power of two")
    if not 0 <= cap_height <= log_n:
        raise ValueError(f"cap height {cap_height} outside the tree height {log_n}")
    return log_n


# ---------------------------------------------------------------------------
# kernel 2: launch plans and wrappers

#: rows a block of the tree's first launch takes: at most 64, halved (down
#: to 8, one warp) until the blocks cover every SM
TREE_RUN_MAX, TREE_RUN_MIN = 64, 8


def tree_plan(rows: int, cap_height: int, sms: int, trees: int = 1) -> tuple[int, int, int]:
    """(rows a block of the first launch, levels each of its blocks reduces,
    levels the second launch reduces; 0 means no second launch), for a
    forest of `trees` trees of `rows` rows. The tree is lane-split at every
    size (csrc/poseidon2.cu says why)."""
    levels = (rows.bit_length() - 1) - cap_height
    run = TREE_RUN_MAX
    while run > TREE_RUN_MIN and trees * rows // run < sms:
        run //= 2
    run = min(run, rows)
    in_block = min(run.bit_length() - 1, levels)
    return run, in_block, levels - in_block


@functools.cache
def _sm_count(index: int | None) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _kernel_lib(index: int | None):
    """The kernel library with the round constants in the __constant__ memory
    of CUDA device `index` (that memory is per device: one upload each)."""
    lib = _cuda.lib()
    ext_rcs, int_rcs, diag = (np.ascontiguousarray(a, dtype=np.uint64) for a in _constants())
    with _cuda.on_device(torch.device("cuda", index)):
        err = lib.qzk_poseidon2_set_constants(
            ext_rcs.ctypes.data, int_rcs.ctypes.data, diag.ctypes.data
        )
    _cuda.check(err, "qzk_poseidon2_set_constants")
    return lib


def _launch(entry: str, device: torch.device, *args) -> None:
    """Call kernel-2 entry `entry` on `device`, its current stream last: the
    launch and the constants it reads are that device's."""
    lib = _kernel_lib(device.index)
    with _cuda.on_device(device):
        _cuda.check(getattr(lib, entry)(*args, _cuda.stream()), entry)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Kernel-2 Poseidon2 permutation of (..., 12) int64 felts."""
    if state.shape[-1] != WIDTH:
        raise ValueError(f"state width {state.shape[-1]}, expected {WIDTH}")
    if state.device.type == "cpu":
        return permute_plain(state)
    _cuda.require_cuda_int64(state)
    state = state.contiguous()
    out = torch.empty_like(state)
    _launch("qzk_poseidon2_permute", state.device,
            state.data_ptr(), out.data_ptr(), state.numel() // WIDTH)
    permute.launches += 1
    return out


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Kernel-2 hash_or_noop of every row of an (R, C) int64 matrix -> (R, 4).

    Rows may be strided (a transposed column-major LDE is read in place)."""
    if rows.dim() != 2:
        raise ValueError(f"hash_rows takes an (R, C) matrix, got {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return hash_rows_plain(rows)
    _cuda.require_cuda_int64(rows)
    r, c = rows.shape
    out = torch.empty((r, DIGEST_LEN), dtype=torch.int64, device=rows.device)
    _launch("qzk_poseidon2_hash_rows", rows.device,
            rows.data_ptr(), out.data_ptr(), r, c, rows.stride(0), rows.stride(1))
    hash_rows.launches += 1
    return out


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Kernel-2 Merkle compression of (B, 4) digest pairs -> (B, 4).

    Rows may be strided (the even and odd rows of one Merkle level)."""
    if left.shape != right.shape or left.dim() != 2 or left.shape[1] != DIGEST_LEN:
        raise ValueError("two_to_one takes two (B, 4) digest matrices")
    if left.device.type == "cpu" and right.device.type == "cpu":
        return two_to_one_plain(left, right)
    _cuda.require_cuda_int64(left, right)
    if left.stride(1) != 1:
        left = left.contiguous()
    if right.stride(1) != 1:
        right = right.contiguous()
    b = left.shape[0]
    out = torch.empty((b, DIGEST_LEN), dtype=torch.int64, device=left.device)
    _launch("qzk_poseidon2_two_to_one", left.device,
            left.data_ptr(), left.stride(0), right.data_ptr(), right.stride(0), out.data_ptr(), b)
    two_to_one.launches += 1
    return out


def merkle_levels(leaves: torch.Tensor, cap_height: int) -> list[torch.Tensor]:
    """Kernel-2 Merkle tree over the rows of an (L, K) int64 matrix: the leaf
    digests and every level up to the cap of 2^cap_height, as (n_l, 4) views
    of one device buffer, in one or two launches (`tree_plan`).

    Rows may be strided (a transposed column-major LDE is read in place)."""
    _tree_height(leaves, cap_height)
    if leaves.device.type == "cpu":
        return merkle_levels_plain(leaves, cap_height)
    _cuda.require_cuda_int64(leaves)
    return _launch_tree(leaves, cap_height, tree_plan(
        leaves.shape[0], cap_height, _sm_count(leaves.device.index)))


#: at most this many trees in one forest call (the grid's second axis)
MAX_FOREST_TREES = 65535


def _forest_shape(leaves: torch.Tensor, cap_height: int) -> None:
    if leaves.dim() != 3 or not 1 <= leaves.shape[0] <= MAX_FOREST_TREES:
        raise ValueError(f"a forest takes a (T, L, K) stack of 1..{MAX_FOREST_TREES} trees' "
                         f"leaves, got {tuple(leaves.shape)}")
    _tree_height(leaves[0], cap_height)


def merkle_forest_plain(leaves: torch.Tensor, cap_height: int) -> list[list[torch.Tensor]]:
    """Plain torch version of `merkle_forest` (same arguments and layout):
    `merkle_levels_plain` over every tree at once, each level's pairs taken
    within each tree."""
    _forest_shape(leaves, cap_height)
    trees, rows, cols = leaves.shape
    cur = hash_rows_plain(leaves.reshape(trees * rows, cols)).reshape(trees, rows, DIGEST_LEN)
    levels = [cur]
    while cur.shape[1] > 1 << cap_height:
        pairs = cur.reshape(trees, -1, 2, DIGEST_LEN)
        cur = two_to_one_plain(pairs[:, :, 0].reshape(-1, DIGEST_LEN),
                               pairs[:, :, 1].reshape(-1, DIGEST_LEN)).reshape(trees, -1, DIGEST_LEN)
        levels.append(cur)
    sizes = [lvl.shape[1] for lvl in levels]
    return [list(b.split(sizes)) for b in torch.cat(levels, dim=1)]


def merkle_forest(leaves: torch.Tensor, cap_height: int) -> list[list[torch.Tensor]]:
    """Kernel-2 Merkle trees of one shape, in one call: leaves (T, L, K)
    holds tree t's (L, K) rows at leaves[t], any strides (the stacked LDEs
    of a batch of proofs, read in place). Returns each tree's levels as in
    `merkle_levels`, tree t's in its own part of one device buffer. One or
    two launches for all T trees (`tree_plan` with the forest's size)."""
    _forest_shape(leaves, cap_height)
    if leaves.device.type == "cpu":
        return merkle_forest_plain(leaves, cap_height)
    _cuda.require_cuda_int64(leaves)
    return _launch_forest(leaves, cap_height, tree_plan(
        leaves.shape[1], cap_height, _sm_count(leaves.device.index), leaves.shape[0]),
        merkle_forest)


def _launch_tree(leaves: torch.Tensor, cap_height: int, plan) -> list[torch.Tensor]:
    return _launch_forest(leaves.unsqueeze(0), cap_height, plan, merkle_levels)[0]


def _launch_forest(leaves: torch.Tensor, cap_height: int, plan, counter) -> list[list[torch.Tensor]]:
    """The forest entry over (T, L, K) leaves, its launches added to
    `counter`'s count (`merkle_levels`' for a single tree)."""
    trees, rows, cols = leaves.shape
    sizes = [rows >> lvl for lvl in range(rows.bit_length() - cap_height)]
    buf = torch.empty((trees, sum(sizes), DIGEST_LEN), dtype=torch.int64, device=leaves.device)
    ts, rs, cs = leaves.stride()
    _launch("qzk_poseidon2_merkle_forest", leaves.device, leaves.data_ptr(), buf.data_ptr(),
            trees, ts, rows, cols, rs, cs, *plan)
    counter.launches += 2 if plan[2] else 1
    return [list(b.split(sizes)) for b in buf]


permute.launches = 0
hash_rows.launches = 0
two_to_one.launches = 0
merkle_levels.launches = 0
merkle_forest.launches = 0


