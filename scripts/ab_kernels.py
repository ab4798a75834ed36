"""Hand kernels of two checkouts of the port, on one card.

    python3 scripts/ab_kernels.py BEFORE_DIR AFTER_DIR [--rounds 2]
        [--parts ssd,cells,contacts,merge,scaled]

With the ``ssd`` part, first holds BEFORE's ``ssd_scan`` to AFTER's
``chip_smoke.py`` check (``check_ssd_cases``: every case within
``SSD_TOL`` and ``SSD_REL``, the slow-decay cases included), so a stricter
check is shown to pass on the kernel it replaces. Then runs each checkout
in turn, one process a run, in the order before, after, after, before
(``--rounds`` such pairs of pairs), so drift of the card and host is
shared. Each run builds its checkout's kernels into its own ``build/`` and
measures, with its own ``chip_smoke.py``'s helpers, the parts asked for
(all five by default):

* ``ssd``: ``ssd_scan`` at mamba2-130m's prefill shape (B = 1, S = 8192,
  24 heads of 64, N = 128, G = 1, Q = 128, bf16), device ms in a CUDA
  graph, and the device µs of each CUDA kernel it launches
  (``torch.profiler``); the mamba2-130m prefill (all 24 layers, 8192
  tokens): wall ms;
* ``cells``: ``cell_close_words`` at the N = 12800 point (319 × 319 cells,
  cap 9) on the planes of the last of 64 slots of a run (seed 0), and on
  planes with most slots full (``chip_smoke.cell_case``, seed 3), device
  ms; and that point's wall and summed device µs a slot over 32 profiled
  slots;
* ``contacts``: ``pairwise_contacts`` on the main path's own inputs
  (``chip_smoke.main_path_inputs``: one rdm step from seed 0) at the
  paper point (N = 200), the dense N = 800 point, and 16 paper-point runs
  in one launch (B = 16, seeds 0-15), each held bit for bit to its plain
  version, device ms in a CUDA graph; the card's launch floor (a
  one-element ``fill_`` in the same harness); and the paper point's wall
  and summed device µs a slot over 32 profiled slots;
* ``merge``: ``gossip_merge_rows`` at R = 200, D = 34, about 60% of the
  rows selected, random w (``chip_smoke.merge_case``, seed 22), held bit
  for bit to its plain version, device ms;
* ``scaled``: ``gossip_merge_rows_scaled`` on the same inputs (scale 1 on
  about half the rows), each held bit for bit to its plain version, device
  ms, timed in the order without ``fold``, with, with, without (the first
  timing of a kernel on fresh tensors has read lower than the ones after
  it), then without on fresh inputs; and the launch floor.

Prints each run's numbers, then one JSON line with all of them by
checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHECK = """
import sys
sys.path.insert(0, {before!r} + "/src")
import repro_torch.kernels.ssd_scan as ks
if not hasattr(ks.ssd_scan, "forms"):
    ks.ssd_scan.forms = {{}}
sys.path.insert(0, {after!r})
import chip_smoke as c
assert c.ks is ks, "the check must run the kernel of " + {before!r}
c.ssd_forms = lambda what, want: None
ks.build_library()
c.check_ssd_cases()
"""

PRELUDE = """
import dataclasses
import json
import re
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as c

out = {}
"""

PARTS = {"ssd": """
c.ks.build_library()
gen = torch.Generator("cuda").manual_seed(21)
args = c.ssd_inputs(gen, 1, c.PREFILL_S, 24, 1, 128, 64, torch.bfloat16)
out["ssd_ms"] = c.device_ms(lambda: c.ks.ssd_scan(*args, chunk=128),
                            per_graph=10, replays=10)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(10):
        c.ks.ssd_scan(*args, chunk=128)
    torch.cuda.synchronize()


def kernel_name(key):
    m = re.search(r"::(\\w+)(?:<[^(]*>)?\\(", key)
    return m.group(1) if m else key


out["ssd_kernels_us"] = {kernel_name(e.key): e.device_time_total / e.count
                         for e in prof.key_averages()
                         if e.device_time_total > 0 and e.count == 10}
del args
cfg, params = c.mamba_model()
out["prefill_wall_ms"] = c.mamba_prefill(cfg, params)["wall_ms"]
del params
torch.cuda.empty_cache()
""", "cells": """
c.kc.build_cell_library()
p, scfg = c.scaled_point(12800, 64)
with c.Recorder("cell_close_words", keep=1, module=c.sim_cells) as rec:
    c.simulate(p, scfg, seed=0)
(run_args, run_kw), = rec.calls
short = dataclasses.replace(scfg, n_slots=32)
wall_us, dev = c.profiled(lambda: c.simulate(p, short))
out["cells_slot_wall_us"] = wall_us / 32
out["cells_slot_device_us"] = sum(e.self_device_time_total for e in dev) / 32
full = c.cell_case(np.random.default_rng(3), 1, 319, 9, 2)
for key, a, kw in (("cells_run_planes_ms", run_args, run_kw),
                   ("cells_full_planes_ms", full,
                    dict(ncx=319, ncy=319, r_tx2=25.0))):
    got = c.kc.cell_close_words(*a, **kw)
    if not torch.equal(got, c.kc.cell_close_words_ref(*a, **kw)):
        raise AssertionError(key + ": kernel != plain version")
    out[key] = c.device_ms(lambda: c.kc.cell_close_words(*a, **kw))
""", "contacts": """
c.kc.build_library()
one = torch.empty(1, device="cuda")
out["launch_floor_ms"] = c.device_ms(lambda: one.fill_(0.0))
for key, cfg, b in (("contacts_n200_ms", c.SimConfig(), 1),
                    ("contacts_n800_ms", c.scaled_point(800, 2000)[1], 1),
                    ("contacts_b16_n200_ms", c.SimConfig(), 16)):
    items = [c.main_path_inputs(cfg, k) for k in range(b)]
    r_tx2 = items[0][1]
    a = tuple(torch.cat([x[i] for x, _ in items]) for i in range(5))
    got = c.kc.pairwise_contacts(*a, r_tx2)
    want = c.kc.pairwise_contacts_ref(*a, r_tx2)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(key + ": kernel != plain version")
    out[key] = c.device_ms(lambda: c.kc.pairwise_contacts(*a, r_tx2))
p = c.paper_params(lam=0.05, M=1)
short = c.SimConfig(n_slots=32)
c.simulate(p, short)
wall_us, dev = c.profiled(lambda: c.simulate(p, short))
out["paper_slot_wall_us"] = wall_us / 32
out["paper_slot_device_us"] = sum(e.self_device_time_total for e in dev) / 32
""", "merge": """
c.gm.build_library()
gen = torch.Generator("cuda").manual_seed(22)
own, peer, w, scale, s = c.merge_case(gen, 200, 34, "mixed", "random")
got = c.gm.gossip_merge_rows(own, peer, w, s)
if not torch.equal(got.view(torch.int32),
                   c.gm.gossip_merge_rows_ref(own, peer, w, s)
                   .view(torch.int32)):
    raise AssertionError("gossip_merge_rows: kernel != plain version")
out["merge_rows_ms"] = c.device_ms(
    lambda: c.gm.gossip_merge_rows(own, peer, w, s))
""", "scaled": """
c.gm.build_library()
gen = torch.Generator("cuda").manual_seed(22)
args = c.merge_case(gen, 200, 34, "mixed", "random")
for key, fold in (("merge_rows_scaled_ms", False),
                  ("merge_rows_scaled_fold_ms", True),
                  ("merge_rows_scaled_fold_2_ms", True),
                  ("merge_rows_scaled_2_ms", False),
                  ("merge_rows_scaled_fresh_ms", False)):
    if key.endswith("fresh_ms"):
        args = c.merge_case(gen, 200, 34, "mixed", "random")
    got = c.gm.gossip_merge_rows_scaled(*args, fold=fold)
    want = c.gm.gossip_merge_rows_scaled_ref(*args, fold=fold)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(key + ": kernel != plain version")
    out[key] = c.device_ms(
        lambda: c.gm.gossip_merge_rows_scaled(*args, fold=fold))
one = torch.empty(1, device="cuda")
out["launch_floor_ms"] = c.device_ms(lambda: one.fill_(0.0))
"""}

FOOTER = """
print("AB " + json.dumps(out))
"""


def run(tree: Path, code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"run failed in {tree}")
    return out.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated, of " + ", ".join(PARTS))
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not parts or any(p not in PARTS for p in parts):
        ap.error(f"--parts: choose from {', '.join(PARTS)}")
    before, after = args.before.resolve(), args.after.resolve()
    if "ssd" in parts:
        line = next(x for x in run(after, CHECK.format(
            before=str(before), after=str(after))).splitlines()
            if x.startswith("[ssd-kernel"))
        print(f"{before.name} under {after.name}'s check: {line}", flush=True)
    code = PRELUDE + "".join(PARTS[p] for p in parts) + FOOTER
    runs = {"before": [], "after": []}
    for _ in range(args.rounds):
        for key in ("before", "after", "after", "before"):
            tree = before if key == "before" else after
            text = run(tree, code)
            got = json.loads(next(x for x in text.splitlines()
                                  if x.startswith("AB "))[3:])
            print(f"{key} ({tree.name}): {json.dumps(got)}", flush=True)
            runs[key].append(got)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
