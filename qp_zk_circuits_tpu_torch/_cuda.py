"""Build and load the port's CUDA kernels (csrc/*.cu) as one plain-C library.

Each source is compiled by its own `nvcc` process for `sm_90a`, all started
together, then linked into `_build/libqzk_<hash>.so`, where the hash covers
the sources and flags, so an edited kernel is rebuilt and a built one is
reused. The library is loaded with ctypes: pointers and the stream pass as
`c_void_p`, and every entry returns a `cudaError_t` that `check` turns into
an exception. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong

# entry name -> argtypes (all return int, a cudaError_t)
_ENTRIES = {
    "qzk_field_binary": [_I, _P, _P, _P, _LL, _P],
    "qzk_poseidon2_set_constants": [_P, _P, _P],
    "qzk_poseidon2_permute": [_P, _P, _LL, _P],
    "qzk_poseidon2_hash_rows": [_P, _P, _LL, _I, _LL, _LL, _P],
    "qzk_poseidon2_two_to_one": [_P, _LL, _P, _LL, _P, _LL, _P],
    "qzk_poseidon2_merkle_forest": [_P, _P, _LL, _LL, _LL, _I, _LL, _LL, _I, _I, _I, _P],
    "qzk_ntt": [_P] * 8 + [_LL, _LL, _I, _I, _I, _ULL, _I, _LL, _LL, _P],
    "qzk_quotient_set_constants": [_P, _P, _P],
    "qzk_quotient": [_P, _LL, _P, _P, _LL] + [_P] * 8 + [_LL] + [_I] * 13 + [_P],
    "qzk_permutation": [_P, _LL, _P, _P, _P, _LL, _P, _P] + [_I] * 5 + [_P],
    "qzk_fri_composition": [_P, _I, _P, _P, _P, _P, _I, _P, _LL, _P, _LL, _I, _I, _P],
    "qzk_eval_openings": [_P, _I, _P, _LL, _P, _P, _I, _I, _P],
    "qzk_fri_fold": [_P, _P, _P, _LL, _I, _P, _LL, _I, _I, _I, _P],
    "qzk_query_gather": [_P, _P],
    "qzk_transcript_set_constants": [_P, _P, _P],
    "qzk_transcript_batch": [_P, _I, _P],
    "qzk_grind_batch": [_P, _LL, _I, _I, _P, _LL, _I, _LL, _P],
    "qzk_rand_felts": [_P, _LL, _LL, _LL, _LL, _ULL, _ULL, _I, _P],
    "qzk_shard_deinterleave": [_P, _P, _LL, _I, _P],
    "qzk_shard_cross_ntt": [_P, _P, _LL, _I, _P, _ULL, _P],
}

#: the kernels with a proof axis (A, B, C, D, E, F) take at most this many
#: proofs a launch: each proof's pointers travel by value in the launch's
#: parameters, its challenges in a record on the card (MAX_PROOFS of
#: csrc/quotient.cu, permutation.cu and fri.cu); a larger batch takes more
#: launches of the same kernel
PROOFS_PER_LAUNCH = 16

_lib = None


def proof_groups(k: int, per_launch: int = PROOFS_PER_LAUNCH) -> list[tuple[int, int]]:
    """The proof ranges of a batch's launches: at most `per_launch` each."""
    return [(g, min(g + per_launch, k)) for g in range(0, k, per_launch)]


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libqzk_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    shared library; returns its path. A no-op when it is already built."""
    so = library_path()
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs = []
        failures = []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\n{out}")
            objs.append(str(obj))
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp_so = Path(tmp) / so.name
        link = [nvcc, "-shared", "-o", str(tmp_so), *objs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _ENTRIES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {err}")


def stream() -> int:
    """The current device's current stream (see `on_device`)."""
    return torch.cuda.current_stream().cuda_stream


def on_device(device: torch.device):
    """The context every launch runs in: its operands' CUDA device current,
    so the runtime launches there and `stream()` is that device's current
    stream (on a mesh of several cards the current device is not the
    operands' by default). A CPU device leaves the current device as it is
    (a stand-in library fed CPU tensors)."""
    return torch.cuda.device(device.index if device.type == "cuda" else -1)


def require_cuda_int64(*tensors: torch.Tensor) -> None:
    """A kernel takes int64 tensors on one CUDA device; anything else raises."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel operand on {t.device}, expected one CUDA device")
        if t.dtype != torch.int64:
            raise TypeError(f"kernel operand dtype {t.dtype}, expected torch.int64")
