"""Where the kernels' spills sit in their machine code: for each kernel
instance whose name holds every ``--match`` string (by default the
streamed fills' ``stream_ring_kernel`` instances at the main shapes), the
local-memory loads and stores (LDL / STL) of its SASS and the loops
(backward branches) around them:

    python -m sequencealigning_tpu_torch.csrc.sass_spills
        [--match S ...] [--dump DIR] [--out FILE]

run from the repository root on a machine with the CUDA toolkit
(``cuobjdump`` beside ``nvcc``); builds the kernels first if needed.  One
line an instance: its instructions, LDL / STL counts, and each innermost
loop of more than --hot instructions (the step loops: a spin wait is a
few instructions) with the spills inside it; then, for the spills outside
those loops, the size of the smallest loop around each, or "none" when no
loop holds it.  --dump DIR writes each instance's SASS to DIR.  The
default --match picks the instances at the main shapes: the global fast4
fill at 8 lanes a thread and the textbook full fills at 4 (compat and
wildcard off), int32 and int16 (``stream_ring16_kernel``).  Each step
loop also gets its count of DPX instructions and lane moves (VIADDMNMX,
VIMNMX, VIMNMX3 and PRMT, by opcode with their modifiers), which shows
what each s16x2 intrinsic lowered to.  --blocks N prints, for each
instance, its N basic blocks (straight-line runs between branches and
branch targets) of the most DPX instructions, with their opcodes: in the
streamed fills the largest is a step's run of cells with no lane at p, and
for the int16 instances its words are counted by their s16x2 adds to
INT16_MIN (a word's t0 and M, two a word), so the run's instructions a
word follow.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

# stream_ring_kernel<LPT, DIRS, MODE, COMPAT, WILDCARD> and its int16
# twin stream_ring16_kernel at the main shapes.
MAIN = tuple(f"{k}ILi{a}" for k in ("stream_ring_kernel",
                                    "stream_ring16_kernel")
             for a in ("8ELi1ELi0ELb1ELb0E", "4ELi2ELi1ELb0ELb0E",
                       "4ELi2ELi2ELb0ELb0E"))
_OPCODE = re.compile(r"^(?:@!?U?P\w+\s+)?((?:VIADDMNMX|VIMNMX3?|PRMT)"
                     r"(?:\.[A-Z0-9x]+)*)")

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def functions(sass: str) -> dict:
    """{name: [(address, instruction text)]} of a cuobjdump -sass listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INSN.search(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def analyse(insns, hot: int) -> dict:
    """Spills and loops of one function's instructions.  Code past the
    last EXIT is out of line (the divergent paths of warp shuffles, which
    branch back into the loops): its branches form no loop, and a spill
    there is reported as out of line."""
    index = {a: i for i, (a, _) in enumerate(insns)}
    tail = max((i for i, (_, t) in enumerate(insns)
                if re.search(r"\bEXIT\b", t)), default=len(insns) - 1)
    loops = []
    for i, (a, text) in enumerate(insns[:tail + 1]):
        targets = re.findall(r"0x([0-9a-f]+)", text)
        if re.search(r"\bBRA\b", text) and targets:
            target = int(targets[-1], 16)
            if target <= a and target in index:
                loops.append((index[target], i))
    spills = [i for i, (_, t) in enumerate(insns)
              if re.search(r"\b(LDL|STL)(\.[A-Z0-9.]+)?\b", t)]

    def inside(i, lp):
        return lp[0] <= i <= lp[1]

    innermost = [lp for lp in set(loops)
                 if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1]
                            for o in loops)]
    hot_loops = sorted(lp for lp in innermost if lp[1] - lp[0] + 1 > hot)
    def opcodes(lp):
        counts = {}
        for _, text in insns[lp[0]:lp[1] + 1]:
            m = _OPCODE.match(text)
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        return dict(sorted(counts.items()))

    rows = [dict(first=insns[lp[0]][0], last=insns[lp[1]][0],
                 instructions=lp[1] - lp[0] + 1,
                 spills=sum(inside(i, lp) for i in spills),
                 opcodes=opcodes(lp))
            for lp in hot_loops]
    outside = []
    for i in spills:
        if any(inside(i, lp) for lp in hot_loops):
            continue
        around = [lp[1] - lp[0] + 1 for lp in loops if inside(i, lp)]
        outside.append(dict(address=insns[i][0], insn=insns[i][1],
                            out_of_line=i > tail,
                            smallest_loop=min(around) if around else None))
    return dict(instructions=len(insns),
                ldl=sum("LDL" in insns[i][1] for i in spills),
                stl=sum("STL" in insns[i][1] for i in spills),
                hot_loops=rows, outside=outside)


_DPX = re.compile(r"^(?:@!?U?P\w+\s+)?(VIADDMNMX|VIMNMX3?)\b")
_BRANCH = re.compile(r"\b(BRA|BRX|JMP|JMX|EXIT|RET|CALL|BREAK|BSYNC|"
                     r"WARPSYNC)\b")


def dpx_blocks(insns, top: int) -> list:
    """The `top` basic blocks of the most DPX instructions: each a dict of
    its first address, instructions, DPX count, the int16 words it holds
    (s16x2 adds to INT16_MIN / 2) and its opcodes (base names)."""
    targets = set()
    for _, text in insns:
        if re.search(r"\bBRA\b", text):
            hit = re.findall(r"0x([0-9a-f]+)", text)
            if hit:
                targets.add(int(hit[-1], 16))
    blocks, cur = [], []
    for a, text in insns:
        if a in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append((a, text))
        if _BRANCH.search(text):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    rows = []
    for b in blocks:
        ops = {}
        for _, text in b:
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        rows.append(dict(
            first=b[0][0], instructions=len(b),
            dpx=sum(bool(_DPX.match(t)) for _, t in b),
            words=sum("S16x2" in t and "0x80008000" in t and
                      "VIADDMNMX" in t for _, t in b) / 2,
            opcodes=dict(sorted(ops.items(), key=lambda kv: -kv[1]))))
    return sorted(rows, key=lambda r: -r["dpx"])[:top]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", action="append", default=None,
                    help="a string the instance's name holds (repeatable; "
                         "default: the main shapes' instances, each)")
    ap.add_argument("--hot", type=int, default=64,
                    help="instructions above which an innermost loop counts "
                         "as a step loop")
    ap.add_argument("--dump", default=None, help="directory for the SASS")
    ap.add_argument("--out", default=None, help="JSON file for the rows")
    ap.add_argument("--blocks", type=int, default=0,
                    help="also report the N basic blocks of most DPX "
                         "instructions of each instance")
    args = ap.parse_args()
    from sequencealigning_tpu_torch import csrc

    csrc.kernels()
    lib = os.path.join(csrc.BUILD_DIR, "libsa_kernels.so")
    tool = os.path.join(os.path.dirname(csrc.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    picks = [[m] for m in MAIN] if args.match is None else [args.match]
    rows = []
    for name, insns in sorted(functions(sass).items()):
        if not any(all(m in name for m in p) for p in picks):
            continue
        r = dict(entry=name, **analyse(insns, args.hot))
        if args.blocks:
            r["blocks"] = dpx_blocks(insns, args.blocks)
        rows.append(r)
        hot = "; ".join(f"{h['instructions']} instructions at "
                        f"{h['first']:#x}-{h['last']:#x}, {h['spills']} "
                        f"spills ({h['opcodes']})"
                        for h in r["hot_loops"]) or "none"
        where = ", ".join(
            f"{o['insn'].split()[-3 if o['insn'].startswith('@') else 0]} "
            f"at {o['address']:#x} "
            + ("(out of line)" if o["out_of_line"] else
               f"(loop of {o['smallest_loop']})" if o["smallest_loop"]
               else "(no loop)") for o in r["outside"]) or "none"
        print(f"{name}: {r['instructions']} instructions, {r['ldl']} LDL, "
              f"{r['stl']} STL; innermost loops over {args.hot} "
              f"instructions: {hot}; spills outside them: {where}",
              flush=True)
        for b in r.get("blocks", []):
            per = (f", {b['instructions'] / b['words']:.1f} a word"
                   if b["words"] else "")
            print(f"  block at {b['first']:#x}: {b['instructions']} "
                  f"instructions, {b['dpx']} DPX, {b['words']:g} int16 "
                  f"words{per}; {b['opcodes']}", flush=True)
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            with open(os.path.join(args.dump, name[:120] + ".sass"),
                      "w") as f:
                f.write("\n".join(f"/*{a:04x}*/ {t}" for a, t in insns))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
