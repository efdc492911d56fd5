#!/usr/bin/env python3
"""The ``ui`` shell's block times and the pipeline's ticks of two checkouts,
in turns on one card.

Run from the root of a checkout, with another checkout unpacked beside it
(e.g. ``git archive <commit> | tar -x -C build/parent_full``; ``build/`` is
copied to the card's machine):

    python3 tools/ui_ab.py build/parent_full .

Runs chip_smoke.py's phase 14 (the ``ui`` pipeline at 192 kS/s: mean and
worst 0.1 s block) and phase 17 (the pipeline's ms per tick at pp=3 and
pp=2) of each checkout in its own process, in the order parent, this,
this, parent, and prints one line a run. Host-clock numbers: compare them
only within one call. Imports no jax; needs a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time

ONE_RUN = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as C
from jsdr_tpu_torch.ops import _build
_build.build()
dev = torch.device("cuda")
ui = C.phase_ui(torch, np, dev, "[ab]")
ticks = C.phase_parallel(torch, np, dev, np.random.default_rng(0), "[ab]")
print("AB " + json.dumps({"ui_mean": ui[0], "ui_worst": ui[1],
                          "pp3": ticks[3], "pp2": ticks[2]}))
'''


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, this = sys.argv[1], sys.argv[2]
    failed = False
    for root in (parent, this, this, parent):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", ONE_RUN], cwd=root,
                             capture_output=True, text=True, timeout=600)
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        failed |= res.returncode != 0 or not line
        print(f"{root} rc={res.returncode} "
              f"{time.perf_counter() - t0:.0f} s "
              + (line[-1] if line else res.stdout[-2000:] + res.stderr[-3000:]),
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
