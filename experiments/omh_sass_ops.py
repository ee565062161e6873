"""Counts the instructions csrc/omh.cu spends on one valid (position,
register) of its selection, from the kernel's SASS.

Compiles dashing2_tpu_torch/csrc/omh.cu to a cubin for sm_90a (nvcc, the
flags of native.nvcc_command), dumps its SASS with cuobjdump into
OUT/omh.sass, and reads `omh_select`. Each load of a staged keyed
word from shared memory (LDS.64, or LDS.128 for two) starts the work of
one position for the thread's register: the word xor the register's
salt, the u64 wanghash chain, and the u64 compare with the worst kept
key (`key > bk[ELL - 1]`, an ISETP pair whose high half ends in .EX).
The script takes, for each load, the instructions that both depend on
the load and feed that compare (a forward slice from the load cut by a
backward slice from the compare, in program order), so the loop's
counter and address arithmetic, the valid test, the branches and the
rarely taken rounding and insert are left out. It prints each slice and
its counts by pipe: IMAD* issue on the FMA pipe, every other counted
instruction on the integer ALU. chip_smoke.py charges those counts (ALU
at 64 lanes a clock per SM, IMADs at 64 on their own pipe, the two
together at the 128-lane issue limit; the largest of the three).

Run on a machine with the CUDA toolkit (nvcc, cuobjdump):

    python3 experiments/omh_sass_ops.py [--out chiprun_out/omh_sass]
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "dashing2_tpu_torch", "csrc", "omh.cu")
FUNCTION = "omh_select"               # in the selection kernel's mangled name

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_REG = re.compile(r"(?<![\w.])(U?R\d+|U?P\d)(?![\w])")


def _tool(name: str) -> str:
    for c in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", name), shutil.which(name) or ""):
        if c and os.path.exists(c):
            return c
    raise FileNotFoundError(f"{name} not found (set CUDA_HOME)")


def sass_of(source: str, out: str) -> str:
    """The SASS text of `source` compiled for sm_90a."""
    cubin = os.path.join(out, "omh.cubin")
    subprocess.run([_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-cubin", "-o", cubin, source],
                   check=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    with open(os.path.join(out, "omh.sass"), "w") as f:
        f.write(text)
    return text


def function_lines(text: str, name: str):
    """The lines of the first function whose mangled name holds `name`."""
    lines, keep = [], False
    for ln in text.splitlines():
        if "Function :" in ln:
            keep = name in ln
            continue
        if keep:
            lines.append(ln)
    if not lines:
        raise ValueError(f"no function {name} in the SASS")
    return lines


def parse(lines):
    """[(address, opcode, dests, sources, text)] in program order; a
    register pair or quad written or read by a 64- or 128-bit operation
    is named register by register."""
    out = []
    for ln in lines:
        m = _INSN.search(ln)
        if not m:
            continue
        addr, body = int(m.group(1), 16), m.group(2).strip()
        guard = []
        if body.startswith("@"):
            g, body = body.split(None, 1)
            guard = _REG.findall(g)
        parts = body.split(None, 1)
        op = parts[0]
        ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 \
            else []
        width = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) \
            else 1
        ndest = 0
        if ops and not ops[0].startswith("["):
            ndest = 2 if "SETP" in op else 1
            while ndest < len(ops) and re.fullmatch(r"U?P\d", ops[ndest]) \
                    and not op.startswith(("SEL", "FSEL")):
                ndest += 1
        if op.startswith(("ST", "BRA", "EXIT", "BAR", "BSSY", "BSYNC",
                          "WARPSYNC", "RET", "CALL", "NOP")):
            ndest = 0
        dests, srcs = [], list(guard)
        for i, o in enumerate(ops):
            regs = [r for r in _REG.findall(o) if r not in ("PT", "RZ")]
            if i < ndest:
                for r in regs:
                    dests += _span(r, width if i == 0 else 1)
            else:
                for r in regs:
                    # the addend of IMAD.WIDE is a pair; an address is not
                    pair = ".WIDE" in op and i == 3
                    srcs += _span(r, 2 if pair else 1)
        out.append((addr, op, dests, srcs, body))
    return out


def _span(reg: str, width: int):
    m = re.fullmatch(r"(U?R)(\d+)", reg)
    if not m or width == 1:
        return [reg]
    return [f"{m.group(1)}{int(m.group(2)) + k}" for k in range(width)]


def chain(insns, start: int):
    """(instructions of the slice, words loaded) for the load at index
    `start`: the instructions after it that depend on it and feed the
    first compare(s) it reaches, one 64-bit compare a word loaded."""
    words = 2 if ".128" in insns[start][1] else 1
    tainted = set(insns[start][2])
    forward, compares = set(), []
    for j in range(start + 1, len(insns)):
        _, op, dests, srcs, _ = insns[j]
        hit = any(s in tainted for s in srcs)
        for d in dests:
            (tainted.add if hit else tainted.discard)(d)
        if hit:
            forward.add(j)
            if op.startswith("ISETP") and ".EX" in op:
                compares.append(j)
                if len(compares) == words:
                    break
    if len(compares) < words:
        raise ValueError(f"the load at {insns[start][0]:#x} reaches "
                         f"{len(compares)} of {words} compares")
    keep, todo = set(compares), list(compares)
    while todo:
        j = todo.pop()
        for s in insns[j][3]:
            for i in range(j - 1, start, -1):
                if s in insns[i][2]:
                    if i in forward and i not in keep:
                        keep.add(i)
                        todo.append(i)
                    break
    return sorted(keep), words


def pipe(op: str) -> str:
    return "fma" if op.startswith("IMAD") else "alu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "omh_sass"))
    ap.add_argument("--sass", help="read this SASS dump instead of "
                    "compiling the source")
    a = ap.parse_args(argv)
    os.makedirs(a.out, exist_ok=True)
    if a.sass:
        with open(a.sass) as f:
            text = f.read()
    else:
        text = sass_of(SOURCE, a.out)
    insns = parse(function_lines(text, FUNCTION))
    loads = [i for i, (_, op, _, _, _) in enumerate(insns)
             if op.startswith("LDS") and (".64" in op or ".128" in op)]
    if not loads:
        raise ValueError("no 64- or 128-bit shared load in omh_select")
    per_word = collections.Counter()
    for i in loads:
        keep, words = chain(insns, i)
        n = collections.Counter(pipe(insns[j][1]) for j in keep)
        print(f"load {insns[i][0]:#06x} {insns[i][4]} ({words} word(s)): "
              f"{n['alu']} ALU, {n['fma']} IMAD")
        for j in keep:
            print(f"    {insns[j][0]:#06x}  {pipe(insns[j][1])}  "
                  f"{insns[j][4]}")
        if n["alu"] % words or n["fma"] % words:
            raise ValueError("a two-word load's slices differ")
        per_word[(n["alu"] // words, n["fma"] // words)] += words
    print(f"slices per word loaded (ALU, IMAD): count: {dict(per_word)}")
    (alu, fma), _ = per_word.most_common(1)[0]
    print(f"one valid (position, register): {alu} ALU + {fma} IMAD = "
          f"{alu + fma} instructions; in ALU-lane units the largest of "
          f"ALU {alu}, IMAD {fma}, issue (ALU + IMAD) / 2 = "
          f"{(alu + fma) / 2}: {max(alu, fma, (alu + fma) / 2)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
