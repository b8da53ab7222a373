#!/usr/bin/env python3
"""
Wall time of building both attention kernel sources (csrc/rel_attention.cu
and csrc/gathered_attention.cu, every instance at every head size) in up
to four forms, one after another from nothing, each form's nvcc runs all
started together:

- "parts" (where the libraries are built in parts): each source in its
  CudaLibrary.parts (-DATTN_INSTANCES, -DATTN_HEAD_DIMS), one nvcc per part;
- "whole": one nvcc per source, nothing else;
- "split-compile": one nvcc per source with --split-compile=0 (nvcc runs
  its optimiser passes in as many threads as the host has);
- "split-compile-extended": the same with --split-compile-extended=0.

Each build writes into a fresh directory under --out and reports ptxas's
spills (a spill fails the port's build). Prints one line per form, and last
a JSON object of the times with the host's CPU count and nvcc's version.

Usage: python3 scripts/nvcc_build_forms.py [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from foldingdiff_tpu_torch.ops import attention  # noqa: E402

SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def commands(form: str, out: Path) -> list[list[str]]:
    nvcc = attention._nvcc()
    cmds = []
    for lib in attention.LIBRARIES:
        if form == "parts":
            for part in range(len(lib.parts)):
                cmds.append([nvcc, *attention.NVCC_FLAGS, *lib.defines(part), "-o",
                             str(out / f"{lib.name}_{part}.so"), str(lib.source)])
        else:
            split = [] if form == "whole" else [f"--{form}=0"]
            cmds.append([nvcc, *attention.NVCC_FLAGS, *split, "-o", str(out / f"{lib.name}.so"), str(lib.source)])
    return cmds


def build(form: str, out: Path) -> dict:
    out.mkdir(parents=True)
    start = time.perf_counter()
    procs = [(cmd, time.perf_counter(), subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                         text=True)) for cmd in commands(form, out)]
    each, spills, failed = [], 0, []
    for cmd, t0, proc in procs:
        output, _ = proc.communicate()
        each.append(round(time.perf_counter() - t0, 1))
        spills += sum(int(a) + int(b) for a, b in SPILL.findall(output))
        if proc.returncode:
            failed.append(output[-2000:])
    return {"form": form, "nvcc": len(procs), "wall_s": round(time.perf_counter() - start, 1), "each_s": each,
            "spill_bytes": spills, "failed": failed}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="directory for the builds (default: a temporary one)")
    args = parser.parse_args()
    root = Path(args.out or tempfile.mkdtemp(prefix="nvcc_build_forms_"))
    version = subprocess.run([attention._nvcc(), "--version"], capture_output=True, text=True).stdout.strip()
    results = []
    forms = ("whole", "split-compile", "split-compile-extended")
    forms = ("parts",) * hasattr(attention.CudaLibrary, "defines") + forms
    for form in forms:
        r = build(form, root / form)
        results.append(r)
        print(f"{form}: {r['nvcc']} nvcc, {r['wall_s']} s wall (each {r['each_s']}), spills {r['spill_bytes']} "
              f"bytes" + (f", FAILED:\n" + "\n".join(r["failed"]) if r["failed"] else ""), flush=True)
    print(json.dumps({"cpus": os.cpu_count(), "nvcc": version.splitlines()[-1], "builds": results}))


if __name__ == "__main__":
    main()
