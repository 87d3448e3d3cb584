"""Whether the kernels of two builds of one CUDA source compile to the same
SASS, up to register names: for a change that adds instances (a new head
dim) and must leave the existing ones as they were. Needs ``cuobjdump``
(the CUDA toolkit), so it runs where the kernels build:

    python -m vipers_torch.tools.sass_compare OLD.so NEW.so [--names attention]

Each kernel of OLD.so is held against every kernel of NEW.so: its
instructions with registers, predicates, operand-reuse hints, addresses
and the kernel's own name masked. A kernel matches when some NEW kernel has the same sequence
("same"), or the same instructions in another order ("reordered": the
scheduler moved independent instructions). Prints one line a kernel and
exits 1 if any kernel of OLD.so has neither.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from typing import Dict, List

_MASKS = [
    (re.compile(r"/\*[0-9a-f]{4,}\*/"), ""),        # instruction addresses
    (re.compile(r"\bU?R\d+\b"), "R"),               # registers
    (re.compile(r"\.reuse\b"), ""),                 # operand-reuse hints (follow the order)
    (re.compile(r"\bU?P\d\b"), "P"),                # predicates
    (re.compile(r"\bB\d+\b"), "B"),                 # convergence barriers
    (re.compile(r"`\(\.L_x_\d+\)"), "`(L)"),        # branch targets
    (re.compile(r"0x[0-9a-f]+(?=\s*;)"), "0x"),     # branch offsets at the end
]


def _cuobjdump() -> str:
    for cand in ("/usr/local/cuda/bin/cuobjdump", shutil.which("cuobjdump") or ""):
        if cand:
            return cand
    raise RuntimeError("cuobjdump not found: run where the CUDA toolkit is")


def kernels(lib: str) -> Dict[str, List[str]]:
    """{mangled kernel name: its masked instructions} of a shared library."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    found: Dict[str, List[str]] = {}
    name = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            found[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?)\s*;?\s*(/\*.*\*/)?\s*$", line)
        if name and m and m.group(1):
            text = m.group(1)
            for pat, rep in _MASKS:
                text = pat.sub(rep, text)
            found[name].append(text.replace(name, "<self>"))
    return found


def compare(old: str, new: str, names: str = "") -> List[tuple]:
    """(old kernel, verdict, instructions) for each kernel of ``old`` whose
    name contains ``names``; verdict "same", "reordered" or "differs"."""
    a, b = kernels(old), kernels(new)
    seqs = {tuple(v) for v in b.values()}
    bags = [Counter(v) for v in b.values()]
    rows = []
    for k, v in sorted(a.items()):
        if names not in k:
            continue
        if tuple(v) in seqs:
            verdict = "same"
        elif Counter(v) in bags:
            verdict = "reordered"
        else:
            verdict = "differs"
        rows.append((k, verdict, len(v)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--names", default="", help="only kernels whose name contains this")
    args = ap.parse_args(argv)
    rows = compare(args.old, args.new, args.names)
    for k, verdict, n in rows:
        print(f"{verdict:9s} {n:6d} instructions  {k}")
    bad = [r for r in rows if r[1] == "differs"]
    print(f"{len(rows) - len(bad)} of {len(rows)} kernels of {args.old} have their SASS in "
          f"{args.new} (up to register names)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
