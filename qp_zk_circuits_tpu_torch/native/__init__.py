"""The port's host runtime in C: Poseidon2, the transcript's absorb, the
witness tape, the constraint tape and the FRI query verifier.

`build()` compiles poseidon2.c, fri_verify.c and witness_tape.c with the
system C compiler into one shared library, `_build/libqzk_host_<cpu>_<hash>.so`.
The hash covers the sources, the compiler and its flags, so an edited source
is rebuilt and a built one is reused; `<cpu>` tags the host's CPU model,
because `-march=native` code must not be loaded on another CPU. A build goes
to a temp file and is published with `os.replace`, so several processes can
build at once. The flags are tried from the most to the least (the first
set the compiler takes wins; `flags()` returns it). If no set builds, or
the library does not load, `lib()` raises with the compiler's output: there
is no Python fallback. Nothing here runs at import time.

`lib()` loads the library at first use and injects the Poseidon2 constants
of hash/poseidon2.py (`_constants()`, `_M4`). `counts` records the calls
made through the wrappers below, by wrapper, and the permutations they ran
(`"permutations"`; a tape or a query verify counts one call). The
wrappers tally under a lock, so the counts stay right when threads call
into the library at once (ctypes releases the GIL for each call: a stream's
witness thread runs its tapes while the proving thread absorbs).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD = _HERE.parent / "_build"
SOURCES = (_HERE / "poseidon2.c", _HERE / "fri_verify.c", _HERE / "witness_tape.c")
# -Bsymbolic binds the library's calls between its own files to itself, so a
# library of the same symbols loaded earlier in the process is never called
BASE_FLAGS = ("-O3", "-funroll-loops", "-shared", "-fPIC", "-Wl,-Bsymbolic")
FLAG_LADDER = (("-march=native", "-fopenmp"), ("-fopenmp",), ())

ROUNDS_P = 22
counts: collections.Counter = collections.Counter()

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_SZ = ctypes.c_size_t
_U64 = ctypes.c_uint64
_I64 = ctypes.c_int64

# entry name -> (restype, argtypes)
_ENTRIES = {
    "qzk_host_flags": (ctypes.c_char_p, []),
    "p2_set_constants": (None, [_u64p, _u64p, ctypes.c_int, _u64p, _u64p]),
    "p2_permute_batch": (None, [_u64p, _SZ]),
    "p2_permute_trace_batch": (None, [_u64p, _SZ] + [_u64p] * 4),
    "p2_hash_no_pad": (None, [_u64p, _SZ, _u64p]),
    "p2_hash_no_pad_many": (None, [_u64p, _SZ, _SZ, _u64p]),
    "p2_two_to_one_many": (None, [_u64p, _u64p, _SZ, _u64p]),
    "p2_merkle_walk": (None, [_u64p, _U64, _u64p, _SZ, _u64p]),
    "p2_absorb_many": (_I64, [_u64p, _u64p, _I64, _u64p, _U64]),
    "fri_verify_queries": (_I64, [_U64] * 2                # lde_bits, n_rounds
                           + [_u64p, _U64, _U64]           # schedule, n_layers, n_oracles
                           + [_u64p, _u64p, _U64]          # widths, caps, cap_height
                           + [_U64] + [_u64p] * 7          # n_batches .. betas
                           + [_u64p, _U64, _u64p]          # final_poly, final_len, commit caps
                           + [_U64] * 2                    # g, w0
                           + [_u64p] * 5),                 # indices, rows, sibs, leaves, step sibs
    "eval_tape": (None, [_u8p, _u32p, _u32p, _U64, _u64p, _U64, _u64p]),
    "wt_run": (_I64, [_i32p, _I64, _u64p, _u64p, _u8p, _I64]),
    "wt_run_many": (None, [_i32p, _I64, _u64p, _u64p, _u8p, _I64, _I64, _I64,
                           ctypes.POINTER(ctypes.c_int64)]),
    "p2_absorb_batch": (_I64, [_u64p, _u64p, _I64, _u64p, _U64, _I64]),
    "p2_duplex_batch": (None, [_u64p, _u64p, _I64, _I64]),
}

_lock = threading.Lock()
_counts_lock = threading.Lock()
_lib = None


def _tally(name: str, permutations: int = 0) -> None:
    """One call of wrapper `name` and the permutations it ran, in `counts`."""
    with _counts_lock:
        counts[name] += 1
        counts["permutations"] += permutations


def _cpu_tag() -> str:
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return hashlib.sha256(f"{platform.machine()}|{model}".encode()).hexdigest()[:12]


def library_path(cc: str = "cc") -> Path:
    h = hashlib.sha256(repr((cc, BASE_FLAGS, FLAG_LADDER)).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libqzk_host_{_cpu_tag()}_{h.hexdigest()[:16]}.so"


def build(cc: str = "cc") -> Path:
    """Compile the host library with `cc` unless it is built; returns its
    path. Raises RuntimeError with the compiler's output if no flag set
    builds it."""
    so = library_path(cc)
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", prefix=".host_build_", dir=BUILD)
    os.close(fd)
    failures = []
    try:
        for extra in FLAG_LADDER:
            flags = (*BASE_FLAGS, *extra)
            cmd = [cc, *flags, f'-DQZK_HOST_FLAGS="{" ".join(flags)}"', "-o", tmp,
                   *map(str, SOURCES)]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except OSError as e:  # no such compiler: no flag set helps
                failures.append(f"{' '.join(cmd)}\n{e}")
                break
            if res.returncode == 0:
                os.replace(tmp, so)
                return so
            failures.append(f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    raise RuntimeError("the host library did not build:\n" + "\n".join(failures))


def lib() -> ctypes.CDLL:
    """The loaded host library (built on first use), constants injected."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            try:
                handle = ctypes.CDLL(str(so))
            except OSError as e:
                raise RuntimeError(f"the host library {so} did not load: {e}") from e
            for name, (restype, argtypes) in _ENTRIES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            set_constants(handle)
            _lib = handle
    return _lib


def set_constants(handle, ext_rcs=None, int_rcs=None, diag=None) -> None:
    """Inject the Poseidon2 tables into a loaded library: by default
    hash/poseidon2.py's, else the ones given (the tests swap them)."""
    from ..hash import poseidon2 as ps

    dflt = ps._constants()
    tables = [np.ascontiguousarray(t if t is not None else d, dtype=np.uint64)
              for t, d in zip((ext_rcs, int_rcs, diag), dflt)]
    if tables[0].size != 8 * 12 or tables[1].size != ROUNDS_P or tables[2].size != 12:
        raise ValueError("Poseidon2 tables of the wrong size")
    m4 = np.ascontiguousarray(ps._M4, dtype=np.uint64).ravel()
    handle.p2_set_constants(_ptr(tables[0]), _ptr(tables[1]), ROUNDS_P, _ptr(tables[2]),
                            _ptr(m4))


def flags() -> str:
    """The compiler flags that built the loaded library."""
    return lib().qzk_host_flags().decode()


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u64p)


def _u64(a, shape_tail=None) -> np.ndarray:
    out = np.ascontiguousarray(a, dtype=np.uint64)
    if shape_tail is not None and (out.ndim == 0 or out.shape[-1] != shape_tail):
        raise ValueError(f"expected a trailing axis of {shape_tail}, got shape {out.shape}")
    return out


def permute_batch(states: np.ndarray) -> np.ndarray:
    """states (..., 12) canonical uint64 -> permuted, same shape."""
    out = _u64(states, 12).copy()
    n = out.size // 12
    lib().p2_permute_batch(_ptr(out), n)
    _tally("permute_batch", n)
    return out


def permute_trace_batch(states: np.ndarray):
    """states (n, 12) -> (ext_a (n, 4, 12), internal (n, R_P), ext_b (n, 3, 12),
    out (n, 12)): the S-box outputs the Poseidon2 gate's wires carry."""
    arr = _u64(states, 12).reshape(-1, 12)
    n = arr.shape[0]
    ext_a = np.empty((n, 4, 12), dtype=np.uint64)
    inter = np.empty((n, ROUNDS_P), dtype=np.uint64)
    ext_b = np.empty((n, 3, 12), dtype=np.uint64)
    out = np.empty((n, 12), dtype=np.uint64)
    lib().p2_permute_trace_batch(_ptr(arr), n, _ptr(ext_a), _ptr(inter), _ptr(ext_b), _ptr(out))
    _tally("permute_trace_batch", n)
    return ext_a, inter, ext_b, out


def hash_no_pad(inputs: np.ndarray) -> np.ndarray:
    """One overwrite-mode sponge over a 1-D felt vector -> digest (4,)."""
    arr = _u64(inputs).ravel()
    digest = np.empty(4, dtype=np.uint64)
    lib().p2_hash_no_pad(_ptr(arr), arr.size, _ptr(digest))
    _tally("hash_no_pad", -(-arr.size // 8))
    return digest


def hash_no_pad_many(rows: np.ndarray) -> np.ndarray:
    """rows (n, len) -> digests (n, 4)."""
    arr = _u64(rows)
    if arr.ndim != 2:
        raise ValueError(f"expected (n, len) rows, got shape {arr.shape}")
    n, length = arr.shape
    digests = np.empty((n, 4), dtype=np.uint64)
    lib().p2_hash_no_pad_many(_ptr(arr), n, length, _ptr(digests))
    _tally("hash_no_pad_many", n * -(-length // 8))
    return digests


def two_to_one_many(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """left, right (n, 4) -> parent digests (n, 4)."""
    lt = _u64(left, 4).reshape(-1, 4)
    rt = _u64(right, 4).reshape(-1, 4)
    if lt.shape != rt.shape:
        raise ValueError(f"left {lt.shape} and right {rt.shape} differ")
    out = np.empty_like(lt)
    lib().p2_two_to_one_many(_ptr(lt), _ptr(rt), lt.shape[0], _ptr(out))
    _tally("two_to_one_many", lt.shape[0])
    return out


def merkle_walk(leaf_digest: np.ndarray, index: int, siblings: np.ndarray) -> np.ndarray:
    """A Merkle path folded in one call: leaf (4,), siblings (L, 4) -> the
    cap entry (4,) it reaches."""
    leaf = _u64(leaf_digest).ravel()
    if leaf.size != 4:
        raise ValueError(f"a digest has 4 felts, got {leaf.size}")
    sibs = _u64(siblings).reshape(-1, 4)
    if not 0 <= int(index) < 1 << 64:
        raise ValueError(f"leaf index {index} out of range")
    out = np.empty(4, dtype=np.uint64)
    lib().p2_merkle_walk(_ptr(leaf), int(index), _ptr(sibs), sibs.shape[0], _ptr(out))
    _tally("merkle_walk", sibs.shape[0])
    return out


def absorb_many(state: np.ndarray, buf: list, felts: np.ndarray) -> tuple[np.ndarray, list]:
    """Duplex-sponge absorption of a felt vector (overwrite mode) into a
    12-lane state and a partial input buffer: returns the new state and the
    leftover buffer."""
    st = _u64(state).ravel().copy()
    k = len(buf)
    if st.size != 12 or k >= 8:
        raise ValueError(f"a state of 12 lanes and a buffer under 8 felts, got {st.size}, {k}")
    b = np.zeros(8, dtype=np.uint64)
    b[:k] = buf
    arr = _u64(felts).ravel()
    k2 = int(lib().p2_absorb_many(_ptr(st), _ptr(b), k, _ptr(arr), arr.size))
    _tally("absorb_many", (k + arr.size) // 8)
    return st, [np.uint64(v) for v in b[:k2]]


def fri_verify_queries(
    lde_bits: int,
    schedule: np.ndarray,
    oracle_widths: np.ndarray,
    oracle_caps: np.ndarray,
    cap_height: int,
    batch_sizes: np.ndarray,
    batch_points: np.ndarray,
    poly_oi: np.ndarray,
    poly_pj: np.ndarray,
    openings: np.ndarray,
    alpha: np.ndarray,
    betas: np.ndarray,
    final_poly: np.ndarray,
    commit_caps: np.ndarray,
    g: int,
    w0: int,
    indices: np.ndarray,
    initial_rows: np.ndarray,
    initial_sibs: np.ndarray,
    step_leaves: np.ndarray,
    step_sibs: np.ndarray,
) -> int:
    """All FRI query rounds in one call. Returns 0 on success, else
    (code << 32) | (round << 16) | sub (fri_verify.c). The arrays are
    flattened by fri/verifier.py::_native_flatten; their sizes are checked
    here against the layout the C code reads."""
    a = {k: _u64(v).ravel() for k, v in dict(
        schedule=schedule, widths=oracle_widths, caps=oracle_caps, bsizes=batch_sizes,
        bpoints=batch_points, poly_oi=poly_oi, poly_pj=poly_pj, openings=openings,
        alpha=alpha, betas=betas, final=final_poly, ccaps=commit_caps, idx=indices,
        rows=initial_rows, isibs=initial_sibs, leaves=step_leaves, ssibs=step_sibs).items()}
    n_rounds, n_layers, n_oracles = a["idx"].size, a["schedule"].size, a["widths"].size
    terms = int(a["bsizes"].sum())
    leaf_len = sib_len = cap_len = 0
    log_m = int(lde_bits)
    for a_bits in a["schedule"].tolist():
        mp = log_m - a_bits
        cl = min(int(cap_height), mp)
        leaf_len += 2 << a_bits
        sib_len += 4 * (mp - cl)
        cap_len += 4 << cl
        log_m = mp
    want = dict(caps=n_oracles * (4 << int(cap_height)), bpoints=2 * a["bsizes"].size, poly_oi=terms,
                poly_pj=terms, openings=2 * terms, alpha=2, betas=2 * n_layers, ccaps=cap_len,
                rows=n_rounds * int(a["widths"].sum()),
                isibs=n_rounds * n_oracles * 4 * (int(lde_bits) - int(cap_height)),
                leaves=n_rounds * leaf_len, ssibs=n_rounds * sib_len)
    bad = {k: (a[k].size, v) for k, v in want.items() if a[k].size != v}
    if bad or a["final"].size % 2 or log_m < 0:
        raise ValueError(f"FRI query arrays of the wrong size (got, want): {bad}")
    if terms and int(max(a["poly_oi"].max(), 0)) >= n_oracles:
        raise ValueError("a composition term names an oracle out of range")
    if terms and np.any(a["poly_pj"] >= a["widths"][a["poly_oi"].astype(np.int64)]):
        raise ValueError("a composition term names a column out of its row")
    code = int(lib().fri_verify_queries(
        int(lde_bits), n_rounds, _ptr(a["schedule"]), n_layers, n_oracles, _ptr(a["widths"]),
        _ptr(a["caps"]), int(cap_height), a["bsizes"].size, _ptr(a["bsizes"]),
        _ptr(a["bpoints"]), _ptr(a["poly_oi"]), _ptr(a["poly_pj"]), _ptr(a["openings"]),
        _ptr(a["alpha"]), _ptr(a["betas"]), _ptr(a["final"]), a["final"].size // 2,
        _ptr(a["ccaps"]), int(g), int(w0), _ptr(a["idx"]), _ptr(a["rows"]), _ptr(a["isibs"]),
        _ptr(a["leaves"]), _ptr(a["ssibs"])))
    _tally("fri_verify_queries")
    return code


def eval_tape(tape, inputs: np.ndarray) -> np.ndarray:
    """Evaluate a ConstraintTape (plonk/constraint_tape.py) on its inputs
    (n_inputs, 2) -> the tape's output nodes (n_out, 2) uint64."""
    inputs = _u64(inputs).reshape(-1, 2)
    if inputs.shape[0] != tape.n_inputs:
        raise ValueError(f"the tape takes {tape.n_inputs} inputs, got {inputs.shape[0]}")
    n_ops = tape.ops.size
    values = np.empty((tape.n_inputs + n_ops, 2), dtype=np.uint64)
    values[: tape.n_inputs] = inputs
    lib().eval_tape(
        tape.ops.ctypes.data_as(_u8p), tape.ia.ctypes.data_as(_u32p),
        tape.ib.ctypes.data_as(_u32p), n_ops, _ptr(tape.pool), tape.n_inputs, _ptr(values))
    _tally("eval_tape")
    return values[tape.out_ids]


def witness_tape_run(code: np.ndarray, consts: np.ndarray, vals: np.ndarray,
                     written: np.ndarray, rounds_p: int) -> int:
    """Run a witness tape (plonk/witness_tape.py). `vals` and `written` are
    updated in place; returns 0, else (err << 32) | record."""
    for name, arr, dtype in (("code", code, np.int32), ("vals", vals, np.uint64),
                             ("written", written, np.uint8)):
        if arr.dtype != dtype or not arr.flags.c_contiguous:
            raise ValueError(f"{name} must be a contiguous {np.dtype(dtype).name} array")
    if written.size != vals.size:
        raise ValueError("vals and written differ in size")
    consts = _u64(consts)
    rc = int(lib().wt_run(code.ctypes.data_as(_i32p), code.size, _ptr(consts), _ptr(vals),
                          written.ctypes.data_as(_u8p), int(rounds_p)))
    _tally("wt_run")
    return rc


def absorb_batch(states: np.ndarray, bufs: np.ndarray, felts: np.ndarray) -> tuple:
    """K transcripts' absorbs of one step, in one call: states (K, 12),
    partial input buffers (K, fill) of one fill, felts (K, n). Returns the
    new states and buffers (K, fill'); bit-equal to K `absorb_many` calls."""
    st = _u64(states, 12).reshape(-1, 12).copy()
    k = st.shape[0]
    b_in = _u64(bufs).reshape(k, -1)
    fill = b_in.shape[1]
    arr = _u64(felts).reshape(k, -1)
    if fill >= 8:
        raise ValueError(f"a buffer under 8 felts, got {fill}")
    b = np.zeros((k, 8), dtype=np.uint64)
    b[:, :fill] = b_in
    n = arr.shape[1]
    fill2 = int(lib().p2_absorb_batch(_ptr(st), _ptr(b), fill, _ptr(arr), n, k))
    _tally("absorb_batch", k * ((fill + n) // 8))
    return st, b[:, :fill2].copy()


def duplex_batch(states: np.ndarray, bufs: np.ndarray) -> np.ndarray:
    """K transcripts' duplexes in one call: the first `fill` lanes of state
    k take buffer k (K, fill), then each state is permuted."""
    st = _u64(states, 12).reshape(-1, 12).copy()
    k = st.shape[0]
    b_in = _u64(bufs).reshape(k, -1)
    fill = b_in.shape[1]
    if fill > 8:
        raise ValueError(f"a buffer of at most 8 felts, got {fill}")
    b = np.zeros((k, 8), dtype=np.uint64)
    b[:, :fill] = b_in
    lib().p2_duplex_batch(_ptr(st), _ptr(b), fill, k)
    _tally("duplex_batch", k)
    return st


def witness_tape_run_many(code: np.ndarray, consts: np.ndarray, vals: np.ndarray,
                          written: np.ndarray, rounds_p: int) -> np.ndarray:
    """Run one witness tape over K value arrays (vals, written: (K, T)), in
    one call; each is updated in place. Returns the K results of `wt_run`."""
    for name, arr, dtype in (("code", code, np.int32), ("vals", vals, np.uint64),
                             ("written", written, np.uint8)):
        if arr.dtype != dtype or not arr.flags.c_contiguous:
            raise ValueError(f"{name} must be a contiguous {np.dtype(dtype).name} array")
    if vals.ndim != 2 or written.shape != vals.shape:
        raise ValueError("vals and written must be (K, T) arrays of one shape")
    consts = _u64(consts)
    rcs = np.zeros(vals.shape[0], dtype=np.int64)
    lib().wt_run_many(code.ctypes.data_as(_i32p), code.size, _ptr(consts), _ptr(vals),
                      written.ctypes.data_as(_u8p), vals.shape[1], vals.shape[0],
                      int(rounds_p), rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    _tally("wt_run_many")
    return rcs
