"""Instruction mix of the port's CUDA kernels, from the machine code nvcc
built: what a kernel executes per warp, by opcode and by integer pipe.

    python3 tools/sass_mix_cuda.py [--source FILE.cu] [kernel-name-part ...]

Builds csrc/ as the port does (vp8oclenc_tpu_torch/_build/), or with
`--source` one .cu file with the same nvcc flags (another tree's source, or
a variant of one), disassembles each library with `cuobjdump -sass` and
counts, for every kernel whose name holds one of the given parts (default:
all), its instructions by opcode.  The card has no hardware counters to
read here, so this stands in for a profiler's instruction statistics: a
kernel that is unrolled into straight-line code (the full-pel and
quarter-pel searches are, but for their early exits) executes per warp
what the listing holds; for a kernel with loops the listing is a static
count, and `loops` gives each backward branch's body as [instructions,
first address], from which a loop's executed count follows.  Opcodes are
grouped by the pipe that takes them on compute capability 9.0: "fma"
(IMAD*, IDP4A: the multiply-add pipe, which nvcc also feeds plain adds and
moves as IMAD.IADD / IMAD.MOV), "alu" (IADD3, LOP3, SHF, PRMT, LEA, ISETP,
SEL, VIMNMX, IABS, ...), "lsu" (shared and global memory), "other".  One
JSON line per kernel.  Needs nvcc and cuobjdump (the CUDA toolkit); no GPU
work is launched.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FMA = ("IMAD", "IDP4A", "IDP", "FFMA", "FMUL", "FADD")
LSU = ("LDS", "STS", "LDG", "STG", "LD", "ST", "LDL", "STL", "ATOM", "ATOMG",
       "RED", "LDC", "ULDC", "LDSM")
OTHER = ("BRA", "EXIT", "BAR", "WARPSYNC", "NOP", "BSSY", "BSYNC", "CALL",
         "RET", "S2R", "S2UR", "CS2R", "SHFL", "REDUX", "MEMBAR", "ERRBAR",
         "CCTL", "DEPBAR", "YIELD", "NANOSLEEP", "VOTE", "MATCH")


# "/*0040*/  @!P0 IMAD.MOV.U32 R1, RZ, RZ, R2 ;": address, opcode, operands
INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T\d]+\s+)?"
                         r"([A-Z][A-Z0-9_]*)[.\w]*\s*([^;]*);")


def pipe_of(op: str) -> str:
    if op in FMA:
        return "fma"
    if op in LSU:
        return "lsu"
    if op in OTHER:
        return "other"
    return "alu"


def libraries(source):
    """{name: path of a built library}: csrc/ as the port builds it, or the
    one file `source` built with the same flags into a temporary folder."""
    from vp8oclenc_tpu_torch.ops import cuda_build
    if source is None:
        cuda_build.build_all()
        return {n: cuda_build._so(n) for n in cuda_build.SOURCES}
    out = tempfile.mkdtemp()
    p = cuda_build._start(os.path.abspath(source), out)
    log, _ = p.communicate()
    if p.returncode != 0:
        raise RuntimeError(log)
    name = os.path.splitext(os.path.basename(source))[0]
    return {source: os.path.join(out, name + ".so")}


def main() -> int:
    sys.path.insert(0, ROOT)
    from vp8oclenc_tpu_torch.ops import cuda_build
    ap = argparse.ArgumentParser()
    ap.add_argument("--source")
    ap.add_argument("parts", nargs="*")
    args = ap.parse_args()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    for name, so in libraries(args.source).items():
        text = subprocess.run([tool, "-sass", so], check=True,
                              capture_output=True, text=True).stdout
        for chunk in text.split("Function : ")[1:]:
            fn = chunk.split("\n", 1)[0].strip()
            if args.parts and not any(w in fn for w in args.parts):
                continue
            ops = collections.Counter()
            loops = []
            for m in INSTRUCTION.finditer(chunk):
                at, op, rest = int(m.group(1), 16), m.group(2), m.group(3)
                ops[op] += 1
                if op == "BRA":
                    t = re.search(r"0x([0-9a-f]+)", rest)
                    if t and int(t.group(1), 16) <= at:
                        start = int(t.group(1), 16)
                        loops.append([(at - start) // 16 + 1, hex(start)])
            pipes = collections.Counter()
            for op, c in ops.items():
                pipes[pipe_of(op)] += c
            print(json.dumps({
                "library": name, "kernel": fn,
                "instructions": sum(ops.values()),
                "backward_branches": len(loops), "loops": loops,
                "pipes": dict(pipes),
                "opcodes": dict(ops.most_common(24))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
