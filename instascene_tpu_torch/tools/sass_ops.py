"""Registers, shared memory and static SASS opcode counts of the CUDA
kernels of one source tree.

    python3 sass_ops.py --root <tree> [--match NAME ...]

--root names the directory that holds `instascene_tpu_torch/`. The tree's
csrc/ is built with its own cuda_build (nvcc -Xptxas=-v, on the machine
with the card and the CUDA toolkit); for each kernel instantiation ptxas
reports, one line: its registers, shared memory, stack and spills. Then
each library is disassembled with `cuobjdump -sass`, and for each
instantiation whose demangled name contains every --match string (default:
every one) the count of each opcode in its code, modifiers dropped (SHFL,
BAR, LDS, MUFU, ...): a static count, what the compiler made of a loop
body, not how often it ran. Prints one JSON line {"root": ..., "ptxas":
{kernel: {...}}, "sass": {kernel: {opcode: count}}}. Run on two trees to
see where a kernel moved.
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

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_FUNC = re.compile(r"^\s*Function : (\w+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_]*)")


def demangle(names):
    """Demangled names, by cu++filt or c++filt where the toolkit has one."""
    for tool in ("cu++filt", "c++filt"):
        path = shutil.which(tool) or (
            f"/usr/local/cuda/bin/{tool}"
            if os.path.exists(f"/usr/local/cuda/bin/{tool}") else None)
        if path:
            out = subprocess.run([path], input="\n".join(names),
                                 capture_output=True, text=True).stdout
            lines = out.splitlines()
            if len(lines) == len(names):
                return dict(zip(names, lines))
    return {n: n for n in names}


def ptxas_table(log):
    """{mangled kernel: registers, smem, stack, spill bytes} from nvcc's
    -Xptxas=-v output."""
    table, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1)
            table[cur] = {}
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            table[cur].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = _USED.search(line)
        if m:
            sm = _SMEM.search(line)
            table[cur].update(registers=int(m.group(1)),
                              smem=int(sm.group(1)) if sm else 0)
    return table


def sass_counts(lib):
    """{mangled kernel: Counter(opcode)} of one library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--match", nargs="*", default=[])
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from instascene_tpu_torch import cuda_build
    names = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    for name in names:      # rebuild, so that ptxas reports every kernel
        cuda_build._target(name).unlink(missing_ok=True)
    cuda_build.build_all(names)
    ptxas, sass = {}, {}
    for name in names:
        ptxas.update(ptxas_table(cuda_build.BUILD_LOG[name]))
        sass.update(sass_counts(cuda_build._target(name)))
    nice = demangle(sorted(set(ptxas) | set(sass)))
    keep = lambda k: all(m in nice[k] for m in args.match)
    print(json.dumps({
        "root": args.root,
        "ptxas": {nice[k]: v for k, v in sorted(ptxas.items()) if keep(k)},
        "sass": {nice[k]: dict(sorted(v.items())) for k, v in
                 sorted(sass.items()) if keep(k)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
