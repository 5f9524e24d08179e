#!/usr/bin/env python3
"""Count the machine instructions a kernel executes per trip of its main loop.

    cuobjdump -sass mjpeg423_tpu_torch/_build/libmj423_cuda.so > lib.sass
    python3 -m mjpeg423_tpu_torch.tools.sass_count lib.sass [name-filter ...]
    python3 -m mjpeg423_tpu_torch.tools.sass_count --build   # dump it first

For every kernel in the listing (or those whose mangled name holds one of
the filters) the script finds the main loop: the backward branch with the
longest span.  A kernel without a loop is counted from its entry to its
last EXIT.  Inside that region it walks every acyclic path from the head
to the back edge (a conditional forward branch forks the path, inner loops
are walked once) and prints, for the shortest and the longest path, the
instructions by the unit that takes them:

  fma     IMAD in all its forms (multiply-add, .MOV, .SHL, .IADD, .WIDE,
          .HI): the FMA pipe
  alu     integer add, logic, shift, permute, min/max, select, compare,
          LEA, MOV: the ALU pipe
  shared  LDS, STS, LDSM, and LDGSTS (cp.async, which writes shared memory)
  global  LDG, STG, LDC
  other   barriers, branches, uniform-datapath and special instructions

The counts are static: one thread's instructions on that path.  Times 8
threads an image block they stand beside the least counts that
chip_smoke.py uses for its bounds (OPS_DECODE_BLOCK a block-frame,
OPS_FDCT_QUANT_PLANE a plane block).  Calls (CALL.*) are listed by name: a
division subroutine shows up there.
"""
from __future__ import annotations

import collections
import re
import subprocess
import sys

FMA = {"IMAD", "IDP", "IDP4A", "IDP2A", "FFMA", "FMUL", "FADD", "HFMA2"}
ALU = {
    "IADD3", "VIADD", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "PRMT",
    "VIMNMX", "VIMNMX3", "IMNMX", "SEL", "ISETP", "LEA", "MOV", "IABS", "SGXT", "PLOP3",
    "BMSK", "FLO", "POPC", "VABSDIFF", "VABSDIFF4", "VIADDMNMX", "FSEL",
    "FSETP", "I2F", "F2I", "MUFU", "I2FP", "F2FP", "CS2R",
}
SHARED = {"LDS", "STS", "LDSM", "LDGSTS", "STSM"}
GLOBAL = {"LDG", "STG", "LDC", "LD", "ST", "ATOMG", "RED"}
CLASSES = ("fma", "alu", "shared", "global", "other")

_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_TARGET = re.compile(r"\b(0x[0-9a-f]+)\s*$")


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base in FMA:
        return "fma"
    if base in ALU:
        return "alu"
    if base in SHARED:
        return "shared"
    if base in GLOBAL:
        return "global"
    return "other"


def parse(text: str) -> dict[str, list[tuple[int, str, str, str]]]:
    """name -> [(address, predicate or '', opcode, operands)]."""
    funcs: dict[str, list] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LINE.match(line)
        if not m or cur is None:
            continue
        words = m.group(2).split(None, 1)
        pred = ""
        if words[0].startswith("@"):
            pred = words[0]
            words = words[1].split(None, 1) if len(words) > 1 else [""]
        cur.append((int(m.group(1), 16), pred, words[0],
                    words[1] if len(words) > 1 else ""))
    return funcs


def branch_target(ops: str) -> int | None:
    m = _TARGET.search(ops.strip())
    return int(m.group(1), 16) if m else None


def main_loop(ins) -> tuple[int, int] | None:
    """(head index, back-edge index) of the longest backward branch."""
    index = {a: i for i, (a, *_rest) in enumerate(ins)}
    best = None
    for i, (addr, _p, op, ops) in enumerate(ins):
        if op.split(".")[0] != "BRA":
            continue
        t = branch_target(ops)
        if t is None or t >= addr or t not in index:
            continue
        if best is None or addr - t > ins[best[1]][0] - ins[best[0]][0]:
            best = (index[t], i)
    return best


def paths(ins, head: int, tail: int, limit: int = 4096):
    """Counters of every acyclic path from ins[head] to ins[tail]."""
    index = {a: i for i, (a, *_rest) in enumerate(ins)}
    out = []
    stack = [(head, collections.Counter())]
    while stack and len(out) < limit:
        i, c = stack.pop()
        while True:
            addr, pred, op, ops = ins[i]
            c[classify(op)] += 1
            c["total"] += 1
            base = op.split(".")[0]
            if i == tail or base == "EXIT" and not pred:
                out.append(c)
                break
            if base == "BRA":
                t = branch_target(ops)
                fwd = t is not None and t > addr and t in index \
                    and index[t] <= tail
                if fwd and pred:
                    stack.append((index[t], c.copy()))
                elif fwd:
                    i = index[t]
                    continue
            i += 1
            if i > tail:
                out.append(c)
                break
    return out


def report(name: str, ins) -> dict:
    loop = main_loop(ins)
    if loop is None:
        exits = [i for i, x in enumerate(ins) if x[2].split(".")[0] == "EXIT"]
        head, tail = 0, exits[-1] if exits else len(ins) - 1
        what = "no loop: entry to last EXIT"
    else:
        head, tail = loop
        what = f"loop {ins[head][0]:#06x}..{ins[tail][0]:#06x}"
    ps = paths(ins, head, tail)
    lo = min(ps, key=lambda c: c["total"])
    hi = max(ps, key=lambda c: c["total"])
    calls = sorted({ops for _a, _p, op, ops in ins[head:tail + 1]
                    if op.split(".")[0] in ("CALL", "CAL")})
    print(f"{name}\n  {what}, {tail - head + 1} instructions in the region, "
          f"{len(ps)} paths")
    for tag, c in (("shortest", lo), ("longest", hi)):
        parts = " ".join(f"{k}={c[k]}" for k in CLASSES)
        print(f"  {tag} path per thread: total={c['total']} {parts}; "
              f"x8 threads a block: total={8 * c['total']} "
              f"fma={8 * c['fma']} alu={8 * c['alu']} "
              f"shared={8 * c['shared']}")
    print(f"  calls in the region: {calls if calls else 'none'}")
    return {"name": name, "region": what, "shortest": dict(lo),
            "longest": dict(hi), "calls": calls}


def main(argv: list[str]) -> int:
    if argv and argv[0] == "--build":
        from mjpeg423_tpu_torch.ops import _build

        so = _build.build()
        nvcc = _build.nvcc_path()
        dump = nvcc[: -len("nvcc")] + "cuobjdump"
        text = subprocess.run([dump, "-sass", str(so)], check=True,
                              capture_output=True, text=True).stdout
        filters = argv[1:]
    elif argv:
        with open(argv[0]) as fh:
            text = fh.read()
        filters = argv[1:]
    else:
        print(__doc__, file=sys.stderr)
        return 2
    for name, ins in parse(text).items():
        if filters and not any(f in name for f in filters):
            continue
        if ins:
            report(name, ins)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
