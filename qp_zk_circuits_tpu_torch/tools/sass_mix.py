"""Count a kernel's SASS instructions by opcode and by the pipe that runs them.

    python -m qp_zk_circuits_tpu_torch.tools.sass_mix [--source random.cu] [--function rand_felts]

Compiles `csrc/<source>` with the kernel library's nvcc flags into a cubin
for sm_90a in a temporary directory, disassembles it with `cuobjdump -sass`
(a static tool: no card is needed), and for each function whose mangled
name contains `--function` prints the instructions of the whole function
and of its innermost loops (from a backward branch's target to the
branch) by opcode and by class:

  * `imad`: IMAD in all its forms (IMAD.WIDE.U32, IMAD.HI.U32, IMAD.X, ...),
    the 32-bit multiplies, which Hopper runs on its FMA pipe;
  * `alu`: the integer ALU pipe's LOP3, IADD3, ISETP, SEL, SHF, LEA, PLOP3,
    IABS, IMNMX, FLO, POPC, BREV, PRMT;
  * `mov`: MOV and its forms;
  * `mem`, `uniform` (U* instructions of the uniform datapath), `other`.

Each of the imad and alu pipes takes 16 lanes an SM sub-partition a clock
(64 an SM), and a sub-partition dispatches one warp instruction a clock (128
lanes an SM), so a block of work with I imad-class and A alu-class
instructions needs at least max(I, A, (I + A) / 2) / 64 SM-clocks a lane.
Prints one line a function and a loop, and a JSON object last.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from .. import _cuda

ALU = {"LOP3", "IADD3", "ISETP", "SEL", "SHF", "LEA", "PLOP3", "IABS", "IMNMX", "FLO", "POPC",
       "BREV", "PRMT", "IADD", "LOP", "SHL", "SHR", "ISCADD"}
MEM = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ATOM", "ATOMG", "RED", "LDGSTS"}

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function : (\S+)")


def opcode_class(op: str) -> str:
    base = op.split(".")[0]
    if base == "IMAD":
        return "imad"
    if base in ALU:
        return "alu"
    if base == "MOV":
        return "mov"
    if base in MEM:
        return "mem"
    if base.startswith("U"):
        return "uniform"
    return "other"


def parse(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """function -> [(address, opcode, operands)] from cuobjdump -sass."""
    funcs: dict[str, list[tuple[int, str, str]]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            text = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2).strip())
            op, _, rest = text.partition(" ")
            cur.append((int(m.group(1), 16), op, rest))
    return funcs


def loops(insns: list[tuple[int, str, str]]) -> list[tuple[int, int]]:
    """(first, last) addresses of the innermost loops: a BRA to an earlier
    address closes one; a loop that holds another's branch is not
    innermost."""
    found = []
    for addr, op, rest in insns:
        if op.split(".")[0] != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if m and int(m.group(1), 16) <= addr:
            found.append((int(m.group(1), 16), addr))
    return [(a, b) for a, b in found
            if not any((c, d) != (a, b) and a <= c and d <= b for c, d in found)]


def mix(insns, first: int, last: int) -> tuple[dict, dict]:
    ops = collections.Counter(op for addr, op, _ in insns if first <= addr <= last)
    classes = collections.Counter()
    for op, n in ops.items():
        classes[opcode_class(op)] += n
    return dict(sorted(ops.items())), dict(sorted(classes.items()))


def disassemble(source: Path) -> str:
    """`cuobjdump -sass` of the CUDA source compiled into a cubin with the
    kernel library's nvcc flags (a temporary directory; no card needed)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-cubin", str(source), "-o",
                        str(cubin)], check=True, capture_output=True, text=True)
        return subprocess.run([tool, "-sass", str(cubin)], check=True, capture_output=True,
                              text=True).stdout


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default="random.cu")
    ap.add_argument("--function", default="rand_felts")
    args = ap.parse_args()
    sass = disassemble(_cuda.CSRC / args.source)
    result = []
    for name, insns in parse(sass).items():
        if args.function not in name:
            continue
        spans = [("function", insns[0][0], insns[-1][0])] + [
            ("loop", first, last) for first, last in loops(insns)]
        for kind, first, last in spans:
            ops, classes = mix(insns, first, last)
            result.append({"function": name, kind: [first, last], "classes": classes,
                           "opcodes": ops})
            print(f"{name} {kind} 0x{first:x}-0x{last:x}: "
                  + ", ".join(f"{k} {v}" for k, v in classes.items()) + "; "
                  + ", ".join(f"{k} {v}" for k, v in ops.items()))
    print(json.dumps({"source": args.source, "loops": result}))


if __name__ == "__main__":
    main()
