#!/usr/bin/env python3
"""
The machine code (SASS) of both attention kernels' instances in two
checkouts of this repository, compared kernel by kernel, on a machine with
the CUDA toolkit: each tree builds its libraries (ops/attention.py's
build(), one nvcc per part) into its own _build/ in a process of its own,
then `cuobjdump -sass` lists every __global__ function of every part, and
each function's SASS is compared between the trees.

A function is named by its mangled name with the anonymous namespace's
per-file hash taken out (it changes with the source's text, not with the
code). Prints the count of functions whose SASS is the same in both trees
and, by instance, head size, relative flag and KEYS, those whose text
differs only in its spacing ("spacing": the same instructions and
encodings; cuobjdump pads a library's text to its widest instruction, so
a kernel beside new, wider instructions reads wider), those that differ
and those found in one tree only (an instance whose template arguments
changed). Beside each function that differs it prints how many lines of
its text changed (a diff of the texts, spacing aside) and whether its
instructions are the same ones in another order (the instructions without
their addresses, encodings and operand reuse flags, as a multiset). Last a
JSON object of the counts and names. Exits non-zero if a function of an
instance not named by --changing differs or is found in one tree only.
--changing names an instance of both kernels (bf16) or of one kernel
(gathered_attention:bf16, rel_attention:bf16: the other kernel's instance
of that name must then keep its SASS).
With --opcodes, it also prints, for each function of the --changing
instances in this tree, how many of its instructions have each opcode
(an opcode matches the instructions whose own opcode starts with it, as
HMMA.1688 matches HMMA.1688.F32.TF32).

Usage: python3 scripts/sass_two_trees.py OTHER_TREE [--changing f64 gathered_attention:bf16 ...]
                                        [--opcodes HMMA.1688 ...]
"""
from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
LIST_PARTS = ("import sys; from foldingdiff_tpu_torch.ops import attention as a; a.build(); "
              "print('\\n'.join(str(l.library_path(p)) for l in a.LIBRARIES for p in range(len(l.parts))))")
FUNCTION = re.compile(r"^\s*Function : (\S+)\s*$")
ANONYMOUS = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
INSTANCE = re.compile(r"\d(((?:rel|gathered)_attention)(?:_([a-z0-9]+))?_kernel)ILi(\d+)E(?:Lb(\d)E)?(?:Li(\d+)E)?")


def cuobjdump() -> str:
    for c in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError("cuobjdump not found")


def functions(library: str) -> dict:
    """{normalised mangled name: its SASS text} of one shared library."""
    out = subprocess.run([cuobjdump(), "-sass", library], capture_output=True, text=True, check=True).stdout
    found, name, lines = {}, None, []
    for line in out.splitlines():
        m = FUNCTION.match(line)
        if m:
            if name:
                found[name] = "\n".join(lines)
            name, lines = ANONYMOUS.sub("_GLOBAL__N_", m.group(1)), []
        elif name:
            lines.append(line.strip())
    if name:
        found[name] = "\n".join(lines)
    return found


def tree_functions(tree: str) -> dict:
    """Builds the tree's libraries in a process run from it; {name: SASS} of all its parts."""
    out = subprocess.run([sys.executable, "-c", LIST_PARTS], cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"build in {tree} failed:\n{out.stdout[-5000:]}\n{out.stderr[-5000:]}")
    found = {}
    for library in out.stdout.split():
        found.update(functions(library))
    return found


def instructions(text: str) -> list:
    """The instructions of a function's SASS text in order, without their
    addresses, encodings and operand reuse flags."""
    found = []
    for line in text.splitlines():
        line = re.sub(r"/\*.*?\*/", "", line).replace(".reuse", "")
        if line.strip():
            found.append(" ".join(line.split()))
    return found


def changes(other: str, this: str) -> str:
    """How the SASS text of one function differs between the trees."""
    a, b = [" ".join(l.split()) for l in other.splitlines()], [" ".join(l.split()) for l in this.splitlines()]
    changed = sum(1 for l in difflib.unified_diff(a, b, lineterm="", n=0)
                  if l[:1] in "+-" and not l.startswith(("+++", "---")))
    reordered = sorted(instructions(other)) == sorted(instructions(this))
    return f"{changed} of {len(a)} and {len(b)} lines changed" + (
        "; the same instructions in another order" if reordered else "")


def describe(name: str) -> tuple[str, str]:
    """(kernel:instance, a readable tag) of a mangled kernel name."""
    m = INSTANCE.search(name)
    if not m:
        return "?", name
    function, kernel, instance, d, rel, keys = m.groups()
    return f"{kernel}:{instance or 'fma'}", f"{function} D={d}" + (f" rel={rel}" if rel else "") + (
        f" keys={keys}" if keys else "")


def named(instance: str, changing: list) -> bool:
    """Whether --changing names a kernel:instance, by itself or by its
    instance's name alone (every kernel's)."""
    return instance in changing or instance.split(":")[-1] in changing


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("other")
    parser.add_argument("--changing", nargs="*", default=[], help="instances whose SASS may differ")
    parser.add_argument("--opcodes", nargs="*", default=[], help="opcodes to count in the changing instances")
    args = parser.parse_args()
    other, this = tree_functions(str(Path(args.other).resolve())), tree_functions(str(REPO))
    result = {"same": [], "spacing": [], "differ": [], "only_other": [], "only_this": []}
    for name in sorted(set(other) | set(this)):
        if name in other and name in this:
            key = "same" if other[name] == this[name] else (
                "spacing" if other[name].split() == this[name].split() else "differ")
        else:
            key = "only_other" if name in other else "only_this"
        result[key].append(name)
    bad = []
    for key, names in result.items():
        print(f"{key}: {len(names)} functions", flush=True)
        for name in names:
            instance, tag = describe(name)
            if key == "differ":
                print(f"  {tag}: {changes(other[name], this[name])}", flush=True)
            elif key != "same":
                print(f"  {tag}", flush=True)
            if key in ("differ", "only_other", "only_this") and not named(instance, args.changing):
                bad.append(tag)
    by_instance = {}
    for name in result["same"]:
        instance = describe(name)[0].split(":")[-1]
        by_instance[instance] = by_instance.get(instance, 0) + 1
    print(f"same SASS by instance: {by_instance}")
    opcodes = {}
    for name in sorted(this):
        instance, tag = describe(name)
        if args.opcodes and named(instance, args.changing):
            ops = [i.split()[1] if i.startswith("@") else i.split()[0] for i in instructions(this[name])]
            opcodes[tag] = {op: sum(o.startswith(op) for o in ops) for op in args.opcodes}
            print(f"opcodes of {tag}: {opcodes[tag]}", flush=True)
    print(json.dumps({"counts": {k: len(v) for k, v in result.items()}, "same_by_instance": by_instance,
                      "not_same": {k: [describe(n)[1] for n in v] for k, v in result.items() if k != "same"},
                      "opcodes": opcodes}))
    if bad:
        raise SystemExit(f"SASS differs outside {args.changing}: {bad}")


if __name__ == "__main__":
    main()
