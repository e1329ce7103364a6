"""Count the Hopper instructions (SASS) of the kernels in a CUDA source.

    python3 tools/sass_count.py SOURCE.cu [--out DIR]

Compiles SOURCE with the port's nvcc flags (``ops/_build.NVCC_FLAGS``) and
``-Xptxas -v`` into a cubin, disassembles it with ``cuobjdump -sass`` and
prints, for every kernel: the registers and spills ptxas reports, its
instructions counted by opcode, and each loop's body (from a backward
branch's target up to the branch) counted by opcode. Opcodes are counted by
their first name (``FFMA.FTZ`` counts as FFMA, ``MUFU.RCP`` as MUFU).

With --out DIR it also writes ptxas.txt, the disassembly (sass.txt) and the
counts (counts.json) there. Needs the CUDA toolkit (``nvcc``,
``cuobjdump``); runs on a machine without a GPU too.
"""

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")
# the opcodes the undistortion's arithmetic is judged by, then the rest
FOCUS = ("FFMA", "FMUL", "FADD", "MUFU", "DFMA", "DMUL", "DADD", "BRA",
         "LDG", "STG")


def _tool(name):
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and Path(cand).exists():
            return cand
    raise SystemExit(f"sass_count: {name} not found (PATH, /usr/local/cuda/bin)")


def _opcode(text):
    """'@!P0 FFMA.FTZ R1, ...' -> 'FFMA'."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def parse(sass):
    """{kernel: [(address, opcode, text)]} and {kernel: {label: address}}."""
    funcs, labels = {}, {}
    name, pending = None, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name = m.group(1)
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            funcs[name].append((addr, _opcode(m.group(2)), m.group(2)))
    return funcs, labels


def _hist(instrs):
    return dict(collections.Counter(op for _, op, _ in instrs).most_common())


def count(instrs, labels):
    """Opcode counts of a kernel and of each loop body in it."""
    loops = []
    for addr, op, text in instrs:
        if op != "BRA":
            continue
        m = _TARGET.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is None or target >= addr:
            continue
        body = [i for i in instrs if target <= i[0] <= addr]
        loops.append({"from": hex(target), "to": hex(addr),
                      "instructions": len(body), "opcodes": _hist(body)})
    real = [i for i in instrs if i[1] != "NOP"]
    return {"instructions": len(real), "opcodes": _hist(real), "loops": loops}


def _line(hist):
    focus = [f"{op} {hist[op]}" for op in FOCUS if op in hist]
    rest = sum(n for op, n in hist.items() if op not in FOCUS)
    return ", ".join(focus + [f"other {rest}"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    from slam_tricks_tpu_torch.ops._build import NVCC_FLAGS

    nvcc, cuobjdump = _tool("nvcc"), _tool("cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        build = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o", str(cubin),
             str(args.source)], capture_output=True, text=True)
        if build.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{build.stdout}{build.stderr}")
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                              capture_output=True, text=True,
                              check=True).stdout
    ptxas = build.stdout + build.stderr
    funcs, labels = parse(sass)
    counts = {name: count(instrs, labels[name])
              for name, instrs in funcs.items()}
    print(f"{args.source} (nvcc {' '.join(NVCC_FLAGS)} -Xptxas -v)")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())
    for name, c in counts.items():
        print(f"{name}: {c['instructions']} instructions: "
              f"{_line(c['opcodes'])}")
        for loop in c["loops"]:
            print(f"  loop {loop['from']}..{loop['to']}: "
                  f"{loop['instructions']} instructions: "
                  f"{_line(loop['opcodes'])}")
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "ptxas.txt").write_text(ptxas)
        (args.out / "sass.txt").write_text(sass)
        (args.out / "counts.json").write_text(json.dumps(counts, indent=1))


if __name__ == "__main__":
    main()
