#!/usr/bin/env python3
"""Instruction counts of the loops in gzp_tpu_torch's compiled kernels.

    python3 tools/sass_loops.py [--kernels suffix_merge ...] [--out chiprun_out/sass]

Builds the named kernel libraries (default: all) with ``nvcc`` for
``sm_90a``, disassembles each with ``cuobjdump -sass`` into
``<out>/<name>.sass``, and prints one JSON line per loop of each function:
a loop is the span from a backward branch's target to the branch. For each
it gives the SASS instructions in the body, and how many of them run on
the ALU pipe (integer and logic, fp32 compare and min/max), on the FMA
pipe (fp32 add, multiply and fused multiply-add, IMAD), are shared-memory
loads or other, which is what an operation bound of the kernel is counted
from. Needs the CUDA toolkit, not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

# opcodes that run on the ALU pipe (64 lanes per SM per clock on Hopper):
# integer and logic instructions, and fp32 compares, min/max and selects;
# IMAD and the fp32 additions and products run on the FMA pipe
ALU = {"IADD3", "IMNMX", "ISETP", "LOP3", "SEL", "SHF", "PRMT", "LEA", "IABS",
       "FLO", "POPC", "BREV", "PLOP3", "VIMNMX", "P2R", "R2P", "FMNMX", "FSETP", "FSEL"}
FMA = {"FADD", "FMUL", "FFMA", "IMAD"}
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")


def parse(sass: str) -> dict[str, list[tuple[int, str]]]:
    """{function: [(address, instruction text)]} from ``cuobjdump -sass``."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None and (m := LINE.search(line)):
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def opcode(text: str) -> str:
    """Base opcode of an instruction, without its predicate and modifiers."""
    words = text.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0]


def loops(instrs: list[tuple[int, str]]) -> list[dict]:
    out = []
    for i, (addr, text) in enumerate(instrs):
        if opcode(text) != "BRA" or not (m := re.search(r"0x([0-9a-f]+)", text)):
            continue
        target = int(m.group(1), 16)
        if target > addr:
            continue
        body = [opcode(t) for a, t in instrs if target <= a <= addr]
        kinds = Counter("alu" if op in ALU else "fma" if op in FMA
                        else "lds" if op == "LDS" else "other" for op in body)
        out.append({"start": hex(target), "end": hex(addr), "instructions": len(body),
                    **kinds, "opcodes": dict(Counter(body).most_common())})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", nargs="*", default=None)
    ap.add_argument("--out", default="chiprun_out/sass")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the repo root
    from gzp_tpu_torch.ops import lz_cuda, pack_cuda  # noqa: F401  (registers the kernels)
    from gzp_tpu_torch.runtime import cuda_lib

    kernels = [k for k in cuda_lib.registered()
               if args.kernels is None or k.name in args.kernels]
    if not kernels:
        print(f"sass_loops: no kernel named {args.kernels}", file=sys.stderr)
        return 1
    cuda_lib.build(kernels)
    cuobjdump = str(Path(cuda_lib.nvcc()).with_name("cuobjdump"))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for k in kernels:
        sass = subprocess.run([cuobjdump, "-sass", str(k.library)], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        (out / f"{k.name}.sass").write_text(sass)
        for func, instrs in parse(sass).items():
            print(json.dumps({"kernel": k.name, "function": func,
                              "instructions": len(instrs), "loops": loops(instrs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
