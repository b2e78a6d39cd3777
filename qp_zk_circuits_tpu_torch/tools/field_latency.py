"""Cycles of one dependent field multiply, add and shuffle on one CUDA card.

    python -m qp_zk_circuits_tpu_torch.tools.field_latency [--n 10000]

Builds `tools/field_latency.cu` (csrc/goldilocks.cuh's `mul` and `add`, the
ones every kernel inlines) with the kernel library's nvcc flags into a
temporary directory, runs one warp through a chain of n of each, and prints
the SM cycles a link, the card from nvidia-smi, and a JSON object last. A
kernel that runs a few warps an SM (the leaf's) waits on these latencies.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _cuda
from .timing import card


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=10000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("field_latency needs a CUDA card")
    src = Path(__file__).with_suffix(".cu")
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "field_latency.so"
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", f"-I{_cuda.CSRC}",
                        str(src), "-o", str(so)], check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        lib.qzk_field_latency.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        sink = torch.zeros(32, dtype=torch.int64, device="cuda")
        cycles = torch.zeros(3, dtype=torch.int64, device="cuda")
        for _ in range(2):  # the second run is timed warm
            _cuda.check(lib.qzk_field_latency(sink.data_ptr(), cycles.data_ptr(), args.n),
                        "qzk_field_latency")
    per = [c / args.n for c in cycles.cpu().tolist()]
    result = {"mul_cycles": per[0], "add_cycles": per[1], "shfl_add_cycles": per[2],
              "n": args.n, "card": card()}
    print(f"dependent mul {per[0]:.1f} cycles, add {per[1]:.1f}, shuffle + add {per[2]:.1f}")
    print(result["card"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
