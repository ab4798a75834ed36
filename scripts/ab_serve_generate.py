"""Wall per decode step of two checkouts of the port, on one card.

    python3 scripts/ab_serve_generate.py BEFORE_DIR AFTER_DIR [--rounds 2]

Runs ``chip_smoke.py``'s ``serve-generate`` phase (h2o-danube-3-4b at
published widths, 2 layers, 8 requests of 64 prompt and 64 new tokens)
from each checkout in turn, one process a run, in the order before,
after, after, before (``--rounds`` such pairs of pairs), so drift of the
host is shared. Each checkout builds its own kernels into its own
``build/`` first. Prints each run's phase line, then one JSON line with
the wall per decode step (ms, the mean of the phase's two ``generate``
calls) of every run by checkout.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

RUN = ("import chip_smoke as c; c.fa.build_library(); "
       "cfg, p = c.serve_model(); c.serve_generate(cfg, p)")
STEP = re.compile(r"\[serve-generate [^\]]*\].*?([0-9.]+)ms per decode step")


def run(tree: Path) -> float:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                         capture_output=True, text=True, timeout=600)
    line = next((x for x in out.stdout.splitlines()
                 if x.startswith("[serve-generate")), None)
    if out.returncode != 0 or line is None:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"serve-generate failed in {tree}")
    print(f"{tree.name or tree.resolve().name}: {line[:400]}", flush=True)
    return float(STEP.match(line).group(1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    walls = {"before": [], "after": []}
    for _ in range(args.rounds):
        for key in ("before", "after", "after", "before"):
            walls[key].append(run(getattr(args, key)))
    print(json.dumps({"ms_per_decode_step": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
