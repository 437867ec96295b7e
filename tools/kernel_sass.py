#!/usr/bin/env python3
"""The SASS of the port's kernels, side by side for several checkouts: one
source of each tree compiled for ``sm_90a`` with the build's flags, its
kernels disassembled, and per kernel the instruction count, the counts by
opcode, the constant-bank loads whose address takes a register (an indexed
read of the launch's parameters), the uniform-datapath instructions and the
local-memory accesses (spills).  Needs ``nvcc`` and ``cuobjdump`` (the CUDA
toolkit); no GPU.

    python3 tools/kernel_sass.py --tree parent=<dir> --tree change=. \\
        --source scl_decode --match 'narrow|ILb0ELb1ELb0ELb0E' [--out build/sass.json]

Each ``--tree name=dir`` is a checkout of the repo (``git archive`` of a
commit unpacked into a directory that ``.gitignore`` lists, or the working
tree).  The sources compile in parallel, one ``nvcc`` each.  ``--match`` is
a regular expression on the kernels' mangled or demangled names.  The JSON
file ``--out`` holds every kernel's counts; the SASS of each matched kernel
goes beside it, one file per tree and kernel.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

# the build's flags (ops/build.py NVCC_FLAGS) without those of a shared library
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false")
# an instruction line: its address, an optional predicate, the opcode, its
# modifiers and its operands
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-7T]\s+)?"
                    r"([A-Z][A-Z0-9_]*)(\.[^\s]*)?\s*(.*?);")


def _tool(name: str) -> str:
    for c in (Path("/usr/local/cuda/bin") / name, shutil.which(name)):
        if c and Path(c).exists():
            return str(c)
    raise SystemExit(f"{name} not found (the CUDA toolkit is needed)")


def _functions(sass: str) -> dict:
    """``{mangled name: [instruction lines]}`` of a ``cuobjdump -sass`` text."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and _INSTR.match(line):
            out[name].append(line.strip())
    return out


def _counts(lines: list) -> dict:
    ops = collections.Counter()
    indexed_ldc = uniform = local = 0
    for line in lines:
        m = _INSTR.match(line)
        op, operands = m.group(1), m.group(3)
        ops[op] += 1
        if op in ("LDC", "ULDC") and re.search(r"c\[0x[0-9a-f]+\]\[U?R\d+", operands):
            indexed_ldc += 1
        if op.startswith("U") or op == "ULDC":
            uniform += 1
        if op in ("LDL", "STL"):
            local += 1
    return {"instructions": len(lines), "indexed_constant_loads": indexed_ldc,
            "uniform_instructions": uniform, "local_accesses": local,
            "by_opcode": dict(ops.most_common())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True, help="name=dir")
    ap.add_argument("--source", default="scl_decode", help="csrc/<source>.cu")
    ap.add_argument("--match", default=".", help="regular expression on kernel names")
    ap.add_argument("--define", action="append", default=[], help="extra -D flags")
    ap.add_argument("--out", default="build/kernel_sass.json")
    args = ap.parse_args()
    nvcc, cuobjdump, filt = _tool("nvcc"), _tool("cuobjdump"), shutil.which("cu++filt") or \
        (str(Path("/usr/local/cuda/bin/cu++filt"))
         if Path("/usr/local/cuda/bin/cu++filt").exists() else None)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    trees = dict(t.split("=", 1) for t in args.tree)
    procs = {}
    for name, root in trees.items():
        src = Path(root) / "polarcode_and_ldpc_tpu_torch" / "ops" / "csrc" / f"{args.source}.cu"
        cubin = out.parent / f"{out.stem}_{name}.cubin"
        cmd = [nvcc, *FLAGS, *(f"-D{d}" for d in args.define), "-Xptxas", "-v", "-cubin",
               "-o", str(cubin), str(src)]
        procs[name] = (cubin, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    result = {}
    for name, (cubin, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the {name} tree:\n{log}")
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True,
                              text=True, check=True).stdout
        kernels = {}
        for mangled, lines in _functions(sass).items():
            pretty = subprocess.run([filt, mangled], capture_output=True, text=True
                                    ).stdout.strip() if filt else mangled
            if not (re.search(args.match, mangled) or re.search(args.match, pretty)):
                continue
            kernels[pretty] = {"mangled": mangled, **_counts(lines)}
            (out.parent / f"{out.stem}_{name}_{mangled[:80]}.sass").write_text(
                "\n".join(lines) + "\n")
        result[name] = {"kernels": kernels,
                        "ptxas": [x for x in log.splitlines() if re.search(args.match, x)
                                  or "registers" in x]}
        for pretty, k in kernels.items():
            print(json.dumps({"tree": name, "kernel": pretty[:120],
                              **{f: k[f] for f in ("instructions", "indexed_constant_loads",
                                                   "uniform_instructions", "local_accesses")}}))
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
