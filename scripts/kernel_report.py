#!/usr/bin/env python3
"""What nvcc made of CUDA sources: per kernel, registers, stack frame and
spills (``-Xptxas -v``) and SASS instructions, tensor-core ``HGMMA``s
(wgmma) and ``HMMA``s (mma.sync) among them (``cuobjdump -sass``).

    python3 scripts/kernel_report.py [source.cu ...]

Builds each source (default: the port's ``csrc/conv2d.cu``) with the
flags ``repro_torch.kernels._build`` uses, into ``chiprun_out/
kernel_report/``, prints one line per kernel and writes
``chiprun_out/kernel_report.json``.  Needs the CUDA toolkit (nvcc,
cuobjdump), not a card: it compares a source with another tree's copy
of it, e.g. a ``git archive`` of the parent commit."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    sources = [Path(a).resolve() for a in argv] or [_build.CSRC / "conv2d.cu"]
    out_dir = ROOT / "chiprun_out" / "kernel_report"
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {}
    for i, src in enumerate(sources):
        lib = out_dir / f"lib{i}-{src.stem}.so"
        build = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-o", str(lib), str(src)],
            capture_output=True, text=True)
        if build.returncode:
            print(build.stdout[-4000:], build.stderr[-4000:])
            return 1
        ptxas = _build.ptxas_report(build.stdout + build.stderr)
        sass = _build.sass_report(lib)
        kernels = {k: dict(ptxas.get(k, {}), **sass.get(k, {}))
                   for k in sorted(set(ptxas) | set(sass))}
        report[str(src)] = kernels
        print(src)
        for name, r in kernels.items():
            print(f"  {name:36s} registers {r.get('registers', '?'):>4} "
                  f"stack {r.get('stack', '?'):>4} B  spills "
                  f"{r.get('spill_stores', '?')}/{r.get('spill_loads', '?')}"
                  f" B  SASS {r.get('instructions', '?'):>6}  HGMMA "
                  f"{r.get('hgmma', '?')}  HMMA {r.get('hmma', '?')}")
    with open(ROOT / "chiprun_out" / "kernel_report.json", "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main(sys.argv[1:]))
