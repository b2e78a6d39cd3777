"""Throughput of the integer instructions kernel G is made of, on one CUDA
card, in lanes an SM a clock.

    python -m qp_zk_circuits_tpu_torch.tools.int_rate [--n 4096]

Builds `tools/int_rate.cu` with the kernel library's nvcc flags into a
temporary directory, runs one block of 1024 threads an SM (8 interleaved
chains a thread) of each instruction: IMAD.WIDE.U32, IMAD, IMAD.HI.U32,
LOP3, and IMAD.WIDE with LOP3 in turn, and prints each loop's opcodes
(the instructions ptxas made of the PTX: `tools/sass_mix.py`), the median
over the SMs of the lanes an SM completes a clock (instructions x 1024 /
the block's clock64 span), the card from nvidia-smi, and a JSON object
last. Hopper's integer FMA and ALU pipes each take 16 lanes an SM
sub-partition a clock (64 an SM) for a full-rate instruction; a lower rate
means more issue slots an instruction.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import _cuda
from . import sass_mix
from .timing import card

OPS = ("IMAD.WIDE.U32", "IMAD", "IMAD.HI.U32", "LOP3", "IMAD.WIDE.U32 + LOP3")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int_rate needs a CUDA card")
    src = Path(__file__).with_suffix(".cu")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "int_rate.so"
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", str(src), "-o", str(so)],
                       check=True, capture_output=True, text=True)
        for name, insns in sass_mix.parse(sass_mix.disassemble(src)).items():
            for first, last in sass_mix.loops(insns):
                print(f"{name} loop: {sass_mix.mix(insns, first, last)[0]}")
        lib = ctypes.CDLL(str(so))
        lib.qzk_int_rate.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
        sink = torch.zeros(sms * 1024, dtype=torch.int64, device="cuda")
        cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
        for op, name in enumerate(OPS):
            for _ in range(2):  # the second run is timed warm
                _cuda.check(lib.qzk_int_rate(sink.data_ptr(), cycles.data_ptr(), op, sms,
                                             args.n), "qzk_int_rate")
            per_op = 2 if op == 4 else 1
            span = statistics.median(cycles.cpu().tolist())
            rates[name] = 1024 * 8 * per_op * args.n / span
    for name, r in rates.items():
        print(f"{name}: {r:.1f} lanes an SM a clock")
    result = {"lanes_per_sm_clock": rates, "n": args.n, "sms": sms, "card": card()}
    print(result["card"])
    print(json.dumps(result))


if __name__ == "__main__":
    main()
