"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. device — the card's name and power limit; it must be sm_90;
2. build — the CUDA kernels from ``src/repro_torch/csrc``, one nvcc per
   source, all started together;
3. kernel — first the card's launch floor (a one-element ``fill_`` timed
   as the kernels are, printed as ``launch_floor_us`` here and on the
   merge-kernel line); then ``pairwise_contacts`` vs its plain version on
   the card, bit for bit on every output, over N x prev-density cases,
   multi-bit zone words (and words over all 32 bits, bit 31 the int32
   sign bit, at N = 130, 200 and 1025 and B = 16), a dense node cluster,
   N = 1024, 1025 and 2048
   (lanes holding one word or two), B = 16, lattice positions (equal d²
   across lanes and words), ``prevw`` with every bit set but a few, and N =
   5000 and 16500 (5 and 17 segments of 1024 columns, each loading the
   next one's ``prevw`` words; two chunks of columns at 16500);
4. merge-kernel — ``gossip_merge_rows`` and ``gossip_merge_rows_scaled``
   (in both operand orders: ``fold`` off and on) vs their plain versions,
   bit for bit, over N x D, all/no/mixed rows
   selected, w in {0, 1, random}, scale 1 and below 1, NaN and inf in
   unselected peer rows;
5. replay — the port runs the paper geometry on the CPU (496 slots), then
   on the card replaying the same positions: every trace equal bit for bit,
   and one contact-kernel launch per slot;
6. learn-replay — the same with Gossip Learning at the learning point
   (Λ = 10, T_T = 5 s; logreg for 496 slots, the MLP for 320): every
   protocol trace equal bit for bit, CPU vs card and learning vs
   ``learn=None``; the learning traces within tolerance;
7. mf-check and free runs on the card — the paper's analytics (Lemma 1-3
   fixed point, Theorem-1 DDE, Lemma 4 stored information) solved on the
   card and held to the CPU's solution within the CPU tests' tolerances;
   then Fig. 1's grid (benchmarks/fig1_availability.py:30-42: (T_T, T_M)
   in {(5, 2.5), (0.5, 0.25)} x L in {10, 50, 100, 500} kb, λ = 0.05,
   M = 1) x seeds 0 and 1 as ONE sweep (``repro_torch.sim.sweep``, B =
   16, N = 200, 7992 slots sampled every 24): one contact-kernel launch
   a slot for all 16 rows, every row's a, busy and stored information
   printed beside the batched mean field, the paper point's seed-0 row
   held to tests/test_sim_vs_meanfield.py's five thresholds against the
   card's analytics, slots/s and run-slots/s (slots/s x B), the kernel
   held against its plain version bit for bit on the sweep's last B = 16
   inputs and timed beside its bound, a profile of the sweep; the batched
   fixed point and DDE over tests/test_meanfield.py's λ × M grid held row
   by row to the CPU's; kernel-sweeps times 16 paper-point runs in one
   launch; then the dense N = 800 point (496 slots) free, with wall
   time, slots/s, launches and sanity checks;
7a. the sweep phases, over λ in {0.02, 0.05, 0.2} x seeds 0 and 1 at the
   paper geometry: sweep-rows (304 slots: finite, each seed's population
   trace shared by its rows); sweep-replay (160 slots,
   each seed's positions replayed: the card's sweep equals the CPU's bit
   for bit); sweep-reduce (96 slots, chunks of 2 scenarios padded to 4:
   the mean, final, quantiles and o_tau sweeps against numpy's
   reductions of the trace sweep within ``REDUCE_TOL``, final samples
   and o_tau_den exact; a checkpointed sweep resumed after losing its
   second chunk file, bit for bit with the plain one); sweep-learn (a
   2 x 2 logreg learning sweep, 160 slots, and a 2 x 2 cells sweep at
   N = 1024, 160 slots: rows bit for bit with B = 1 card runs on the
   protocol traces, learning traces within ``LEARN_TOL``);
8. learn-run — the learning point at full width (N = 200, logreg; 1000
   slots) free on the card: accuracy must rise, holders must be no worse
   than the population; the merge kernel is held against its plain
   version on the run's own merge inputs and timed; then a defended run
   (norm clip) does the same for ``gossip_merge_rows_scaled``;
9. cell-kernel — ``cell_close_words`` (one block per strip of up to 32
   cells of a grid row) vs its plain version, bit for bit, over cap in
   {1, 4, 9, 32, 40} x ncx in {1, 3, 17, 319} x B in {1, 2} (strips of 32
   and, at cap 40, of 16; ragged last strips), empty and full cells,
   multi-bit zone words (three more cases with words over all 32 bits),
   pairs an ulp either side of r_tx; and
   ``neighbor_lists`` at B = 2 on the card equal to each item's CPU run;
10. cells-replay — N = 1024 at the paper's density on the cells backend
    (500 slots, of which whole samples of 16 run: 496): the CPU run, then
    the card replaying its positions, every trace and ``nbr_overflow``
    equal bit for bit, one cell-kernel launch per slot;
11. cells-vs-dense — the N = 800 point (256 slots) on the card with
    ``contact_backend="cells"`` and ``"dense"``: every trace bit for bit;
12. cells-run — the convergence figure's N = 12800 point (496 slots,
    ``auto`` = cells) free on the card: no overflow, population and
    availability sane, the kernel held against its plain version on the
    last slot's planes and timed beside its bound; then a 16-slot profile.

13. flat-merge-kernel — ``gossip_merge`` vs its plain version, bit for
    bit, in both operand orders, over float32 and bfloat16, lengths 1 to
    16385, an odd 3-D shape, a view at an odd element offset and the
    125.8 M-element embedding leaf, w in {0, 1/3, 0.5, 1, random}, success
    true and false (NaN and inf in the peer when false); a non-contiguous
    input must raise;
14. init-replay — the test-size h2o-danube-3-4b ``init_lm`` on the card
    equals the same call on the CPU, bit for bit, in float32 and bfloat16;
    round-replay — three rounds over that tree (float32 and bfloat16, with
    a one-element float32 leaf, segments 1 and 3) on the card equal the
    same rounds on the CPU, bit for bit, every merge on the card through
    the kernel (in both of its operand orders);
15. gossip-round — h2o-danube-3-4b at its published widths, 2 of its 24
    layers, R = 4 replicas: three rounds through the kernel and again
    through the plain merge on the card, every leaf bit for bit, count and
    age exact, the kernel's launches per round;
16. rounds-run — 16 rounds of that configuration, timed: wall per round,
    the kernel on the embedding leaf beside its bound, plain and library
    times, device time per round beside the round's bound, the device's
    busy share and peak memory; every leaf finite, the replicas' spread
    lower after every round with a merge of distinct replicas and no
    churn, and a churned replica equal to the default bit for bit.

17. attention-kernel — ``flash_attention`` vs its plain version in
    float32 and bfloat16 (tests/test_kernels.py's tolerances) over D in
    {64, 67, 100, 120, 128}, G in {1, 4, 8}, causal on/off, window in
    {None, 96, 4096}, Sq = Skv, Sq < Skv and Sq = 1 over Skv in {1, 5, 37,
    129, 300, 4096}, strided ring views and views one element off, S =
    5000 and the prefill shape, each case taking the form the shape and
    dtype give (``mma``: bf16 Sq > 1; ``simt``: float32 Sq > 1;
    ``decode``: Sq = 1) as ``flash_attention.forms`` records, each also
    within a relative L2 difference (``ATTN_REL``), q sharpened in the
    long-key cases; float16 and D = 129 must raise;
18. serve-replay — the reduced h2o-danube-3-4b (2 layers, float32 then
    bfloat16) on the card against the same calls on the CPU: ``lm_forward``
    logits within tolerance, ``generate`` tokens equal in float32 (also
    over a ring of 8 that wraps); in bfloat16 the CPU's sequence replayed
    through the card's decode, the same token wherever the choice is
    clear; the forms launched as the shapes say;
19. serve-prefill — h2o-danube-3-4b at its published widths (2 layers,
    bf16) prefilling 8192 tokens: wall, tokens/s, 2 launches of the mma
    form, layer 0's attention vs the plain version (``ATTN_TOL`` and
    ``ATTN_REL``), the kernel timed beside its bound, the plain version
    and SDPA;
20. serve-generate — the serving main path: 8 requests of 64 prompt and
    64 new tokens (``max_len`` 256): 2 launches a step, all of the decode
    form, tokens in the vocabulary and equal on a second call, decode
    logits vs the prefill's, wall per step, a profile of 8 steps, and the
    decode kernel at 128 and 4096 valid slots beside its bound and SDPA.

21. ssd-kernel — ``ssd_scan`` vs its plain version in float32 (the
    ``simt`` form) and bfloat16 (the ``mma`` form), each case asserting
    the form ``ssd_scan.forms`` recorded, y and the final state within
    tests/test_kernels.py's tolerances (``SSD_TOL``) and a relative L2
    limit (``SSD_REL``), over that file's cases, ragged S, S below the
    chunk, G = 2, strided and misaligned views of one xBC-like buffer,
    the full prefill shape, and slow-decay cases with D = 0 (the prefill
    shape and two ragged ones), where a wrong hand-off of the state
    between chunks shows; float16 and H % G != 0 must raise;
22. mamba-replay — the reduced mamba2-130m (2 layers, float32 then
    bfloat16): ``init_lm`` on the card equal to the CPU's bit for bit,
    ``lm_forward`` logits within tolerance (the ``simt`` form in float32,
    ``mma`` in bfloat16), ``generate`` tokens equal in float32, the CPU's
    sequence replayed through the card's decode in bfloat16, and in
    float32 the kernel prefill's final state vs the state after the same
    inputs through ``mamba_decode``;
23. mamba-prefill — mamba2-130m at its published widths, all 24 layers,
    bf16, prefilling 8192 tokens: wall, tokens/s, 24 launches of the
    ``mma`` form, layer 0's scan vs the plain version (``SSD_TOL`` and
    ``SSD_REL``), the kernel timed beside its bound, the plain version
    and the serial ``simt`` design on the same bf16 inputs;
24. mamba-generate — 8 requests of 64 prompt and 64 new tokens
    (``max_len`` 256) on that model: no kernel launch (decode is the
    recurrence), tokens in the vocabulary and equal on a second call,
    decode logits vs the prefill's, wall per step, a profile of 8 steps.

25. faults-kernel — ``pairwise_contacts`` and ``cell_close_words`` (the
    latter inside ``neighbor_lists``, whose lists equal the CPU's) on the
    main path's inputs with a random third of the nodes switched off
    (zone words zero, as the engine folds accessibility in), bit for bit
    with their plain versions at N = 200, N = 1024 and B = 16; no off
    node has a contact;
26. faults-replay — under ``harsh()`` (duty cycling, link failures,
    aborts, crashes): dense N = 200 and cells N = 1024 (304 slots each)
    on the card replaying the CPU's positions, every trace and
    fault field bit for bit, every fault kind seen, the path's kernel
    held to its plain version on the run's last inputs; then a B = 4
    ``harsh()`` sweep (200 slots) whose rows (0, 0) and (1, 1) equal B = 1
    card runs;
27. faults-check — the Zipf spot check (tests/test_sim_faults.py:379-399)
    on the card: the class fixed point and DDE solved on the card and
    held to the CPU's; ``zipf_mix(3)`` at the paper point as one B = 2
    sweep (seeds 0, 1), 4000 slots, ``reduce="mean"`` over the second
    half: each class's availability within 15% of the class solver and
    in its order, its on-fraction and ``fault_events`` printed, slots/s,
    the contact kernel held to its plain version on the sweep's last
    inputs and timed, and profiles of the faulted sweep and of the same
    sweep without faults (kernels and device time a slot).
28. attack-replay — the Byzantine path: ``harsh_adversarial()`` (sign
    flippers at 4x, metadata liars, crashes) with ``robust_defense()`` and
    ``logreg_task()`` at the learning point, dense N = 200, 304 slots, on
    the card replaying the CPU's positions: every protocol trace, fault
    field, ``poisoned_frac``, ``poisoned_frac_c`` and ``merge_stats`` bit
    for bit, the learning traces within ``LEARN_TOL``, one launch of
    ``gossip_merge_rows_scaled`` a slot (the norm clip on sign-flipped
    payloads), held to its plain version on the run's last merges; then an
    undefended B = 2 ``harsh_adversarial()`` sweep (160 slots) whose rows
    equal B = 1 card runs bit for bit on the same fields (one launch of
    ``gossip_merge_rows`` a slot, held to its plain version); it prints
    the scaled merge's launches on poisoned payloads, the norm clips and
    distance rejections, and the final ``poisoned_frac`` with and without
    the defense. After the second process has ended, profiles of the
    attack path and of the same path with every class honest (kernels and
    device time a slot).
29. contam-twin — the contamination twin against the attack figure's
    sweeps (benchmarks/fig_adversarial.py, uncut: 48 nodes in a 100 m
    square, RZ 50 m, 960 slots, logreg): ``signflip(0.1)`` undefended,
    with ``robust_defense()`` (clipped) and with ``trimmed_defense()``,
    each one B = 2 sweep (seeds 0, 1): the per-seed tail
    ``poisoned_frac``, the seeds that ignited, the measured ``eta_adv``,
    the twin's prediction (``solve_contamination_classes`` with the
    measured merge rate, then ``solve_contamination_transient`` over the
    tail window, holder-conditioned) on the card and on the CPU from the
    same telemetry (within ``TWIN_RTOL``), its error and slots/s; the
    undefended and trimmed rows must ignite and fall within 15%; the
    clipped row's error is printed beside the reference's own (its twin
    misses that arm). One ``gossip_merge_rows`` launch a slot in the
    undefended and trimmed arms, one ``gossip_merge_rows_scaled`` in the
    clipped one, each held to its plain version on the run's last merges.
    Then the solvers on the card against the CPU's (x within
    ``CONTAM_XTOL``, o within ``CONTAM_OTOL``): ``signflip(0.1)`` and
    ``harsh_adversarial()`` at the learning point, eta_adv 0.5 with the
    measured merge rate, and each case's transient, with wall times.
30. zones-replay — several Replication Zones on the card replaying the
    CPU's positions, every trace bit for bit, the per-zone ones included,
    and the path's kernel held to its plain version on the run's last
    inputs: (a) three zones (two overlapping, a small disjoint one
    drifting and reflected off the walls), dense N = 200, 304 slots; (b)
    that layout scaled to the area on the cells backend, N = 1024, 160
    slots; (c) 32 zones on a grid, dense, 160 slots, nodes in zone 31
    alone (zone word -2**31); (d) ``harsh()`` with logreg learning across
    two zones, 160 slots, every row merge held to its plain version; (e) a
    B = 4 three-zone sweep (160 slots) whose rows (0, 0) and (1, 1) equal
    B = 1 card runs. After the second process has ended, profiles of (a)
    and of the paper point (kernels and device time a slot).
31. zones-check — benchmarks/fig_multizone.py's Monte-Carlo check in its
    quick form, uncut: two overlapping zones of 60 m at the paper point,
    one B = 2 sweep (seeds 0, 1) of 4000 slots, ``reduce="mean"`` over
    the second half, each zone's availability within 15% of
    ``solve_fixed_point_multizone`` on the card and ``a_mf >= a_sim -
    0.05`` (tests/test_sim_zones.py:392-395), slots/s, the contact kernel
    held to its plain version on the sweep's last inputs; then the
    multizone fixed point and DDE on the card against the CPU's (within
    ``ZONE_RTOL`` and ``DDE_ATOL``), with wall times.
32. mobility-replay — the other mobility models on the card against the
    CPU, every trace bit for bit (rwp and manhattan call no
    transcendental, so free runs agree), each run's contact kernel held to
    its plain version on its last inputs: (a) rwp with a 60 s pause, dense
    N = 200, 304 slots; (b) manhattan, dense N = 200, 304 slots; (c)
    manhattan on the cell lists, N = 1024 at the paper density, 160 slots,
    ``nbr_overflow`` 0; (d) manhattan with ``harsh()`` and logreg learning,
    N = 200, 160 slots: protocol traces, fault fields and ``merge_stats``
    bit for bit, learning traces within ``LEARN_TOL``, every row merge held
    to its plain version; (f) rdm with ``speed_range`` (0.1, 1.9) replaying
    the CPU's positions (its init splits the key four ways), 304 slots;
    then (e) a B = 4 rwp sweep (160 slots) whose rows (0, 0) and (1, 1)
    equal B = 1 card runs. After the second process has ended, profiles of
    an rwp (60 s pause) and a manhattan slot beside the paper point's, and
    mobility-kernels: ``pairwise_contacts`` on those runs' last slot,
    ``cell_close_words`` on a manhattan N = 1024 run's last planes and
    ``gossip_merge_rows`` on (d)'s merges, each held to and timed beside
    its plain version and bound.
33. mobility-check — (a) tests/test_sim_mobility.py's five contact-rate
    probes (``measure_contact_rate``, N = 200: rdm, rwp, manhattan, rwp
    with a 60 s pause, rdm with ``speed_range``) on the card, one
    ``pairwise_contacts`` launch a slot, each within its tolerance of its
    twin built on the card, the paused rwp more than 0.2 from the no-pause
    twin, the ``speed_range`` rate nearer the corrected twin; rwp's and
    manhattan's rates equal the port's CPU runs bit for bit (a worker
    process of the third one); (b) examples/simulate_vs_meanfield.py
    --fast for rwp and manhattan (in this process, after 27's sweep), each
    one B = 2 sweep (seeds 0, 1) at the paper point, 2000 slots (cut from
    4000 for time) sampled every 16, second half: availability within 15%
    of the fixed point on the twin (on the card) and ``a_mf >= a_sim -
    0.02``; busy, nodes in the RZ and slots/s printed; the kernel held to
    its plain version on each sweep's last inputs.
34. dispatch-check — the sweep dispatch queue (``repro_torch.sim.
    dispatch``) on the card: first zone-root, ``zone_member`` on the
    card on ROADMAP queue 3's boundary input, equal to the CPU's, the
    boundary node outside; then Fig. 1's first 4 scenarios x seeds 0 and
    1 at the paper geometry, 240 slots, one scenario a chunk,
    ``reduce="mean"``: (a) in-process, (b) through ``sweep.run(workers=2,
    queue_dir=...)``, (c) through ``run_dispatched`` under a chaos
    schedule of a ``kill`` (chunk 0) and a ``corrupt`` result (chunk 1);
    (b) and (c) equal (a) bit for bit with full coverage, (b) without a
    requeue, (c) with an expired lease and a corrupt result seen; the
    run-slots/s of (a) and (b), one after the other in one process, the
    workers' start-up (each one's first claim, from the queue's lease
    records), (c)'s wall and the card's name and power limit printed. The
    workers are processes of their own, each with a CUDA context on the
    card.

Order: 1-4, 9, 13 and 25 (the kernel checks), the analytics of 7 and 27;
then three processes on the card at once, all bound by the host's launch
rate: this one runs the long sweeps of 7 (mf-check), 27 (faults-check)
and 33 (mobility-check's two), a second one (spawned, ``side_phases``)
the phases that only check (the sweep phases, 5, 10, 6, 26, 11, 28, 30,
32, 14's replays, 18 and 22), with every replay's CPU run queued at its
start in a worker process of its own (spawned, at most 4 threads), and a
third one (spawned, ``twin_phases``) 29, 31, 33's probes (their CPU
sides in a worker of its own, one thread) and 34 (its two dispatch
workers are processes of their own on the card). When the other two have
ended, on a quiet card, this one times: the kernels on 7's and 27's last
inputs and their profiles, then 8, 28's, 30's and 32's profiles, 12, 15,
16, 17, 19, 20, 21, 23 and 24.

The run lengths above are cut to keep the script near half its 1200 s
limit on a slow host (the simulator is bound by the host's launch rate):
the reference check's 12000 slots to 7992, where the stored information
is still within its threshold, and 33's example from 4000 slots to 2000
(PERF.md §7 lists every cut).

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import random as jr  # noqa: E402
from repro_torch.configs import get_arch_config  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.fg_paper import (AREA_SIDE,  # noqa: E402
                                          DENSITY, R_TX, SPEED_DEFAULT,
                                          paper_contact_model,
                                          paper_params)
from repro_torch.configs.fg_adversarial import (  # noqa: E402
    harsh_adversarial, robust_defense, signflip, trimmed_defense)
from repro_torch.configs.fg_faults import harsh, zipf_mix  # noqa: E402
from repro_torch.configs.fg_learn import logreg_task, mlp_task  # noqa: E402
from repro_torch.core import gossip  # noqa: E402
from repro_torch.core.capacity import node_stored_information  # noqa: E402
from repro_torch.core.dde import (  # noqa: E402
    solve_contamination_transient, solve_observation_availability,
    solve_observation_availability_batch,
    solve_observation_availability_classes,
    solve_observation_availability_multizone)
from repro_torch.core.meanfield import (  # noqa: E402
    solve_contamination_classes, solve_fixed_point, solve_fixed_point_batch,
    solve_fixed_point_classes, solve_fixed_point_multizone)
from repro_torch.core.merge import DefenseConfig  # noqa: E402
from repro_torch.kernels import contacts as kc  # noqa: E402
from repro_torch.kernels.build import BUILD_DIR  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gossip_merge as gm  # noqa: E402
from repro_torch.kernels import ssd_scan as ks  # noqa: E402
from repro_torch.models.attention import gqa_qkv  # noqa: E402
from repro_torch.numerics import fma32, sqrt32  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.models.mamba import (init_mamba_cache,  # noqa: E402
                                      mamba_decode, mamba_forward,
                                      mamba_scan_inputs)
from repro_torch.models.transformer import (  # noqa: E402
    init_cache, init_lm, lm_forward, params_from_numpy, params_to_numpy,
    stack_replicas)
from repro_torch.serve import (ServeEngine, make_decode_step,  # noqa: E402
                               make_prefill_step)
from repro_torch.sim import cells as sim_cells  # noqa: E402
from repro_torch.sim import contacts as sim_contacts  # noqa: E402
from repro_torch.sim import sweep  # noqa: E402
from repro_torch.sim import learn as learning  # noqa: E402
from repro_torch.sim.compute import pack_mask  # noqa: E402
from repro_torch.core.zones import ZoneSet  # noqa: E402
from repro_torch.sim.engine import (SimConfig, effective_zones,  # noqa: E402
                                    mobility_track, simulate, zone_member)
from repro_torch.core.mobility import contact_model_for  # noqa: E402
from repro_torch.sim import dispatch as sim_dispatch  # noqa: E402
from repro_torch.sim import mobility as sim_mobility  # noqa: E402
from repro_torch.sim.mobility import (get_mobility,  # noqa: E402
                                      measure_contact_rate)
from repro_torch.tree import tree_items, tree_map  # noqa: E402

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s,
#: float32 FLOP/s outside the tensor cores and dense bf16 FLOP/s.
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
BF16_FLOPS_S = 989e12
TRACES = ("availability", "busy_frac", "stored_info", "obs_birth",
          "obs_holders", "model_holders", "n_in_rz", "availability_z",
          "stored_info_z", "n_in_rz_z", "t")
#: The learning point: fig_learning.py's full-size point.
LEARN_PARAMS = dict(lam=0.05, Lam=10.0, M=1, T_T=5.0)
#: Card vs CPU tolerances of the learning traces (gradients and accuracy
#: logits sum in another order on the card; every draw is bit for bit).
LEARN_TOL = dict(test_acc=(0.0, 2e-3), test_acc_holders=(0.0, 2e-3),
                 learn_obs=(1e-5, 0.0), theta_var=(1e-3, 1e-7))
#: The free-run check (tests/test_sim_vs_meanfield.py:34-83): the paper
#: point sampled every 24, seed 0, the second half of the samples held to
#: the port's analytics; cut from the test's 12000 slots to 7992 (333
#: samples) for time: the stored information rises slowly (mf/sim 1.41 at
#: 8000 slots, 1.20 at 12000 on the CPU; the threshold is 2).
MF_POINT = dict(lam=0.05, M=1)
MF_CFG = SimConfig(n_slots=7992, sample_every=24)
#: ... run as one sweep over Fig. 1's grid (benchmarks/fig1_availability.py
#: :30-42: (T_T, T_M) variants x model sizes L, λ = 0.05, M = 1) and two
#: seeds: B = 16 rows, the paper point's seed 0 first.
FIG1_VARIANTS = ((5.0, 2.5), (0.5, 0.25))
FIG1_LS = (10e3, 50e3, 100e3, 500e3)
MF_SEEDS = (0, 1)
#: Card vs CPU analytics, the CPU tests' tolerances against ``repro``
#: (tests/test_torch_analytics.py): fixed-point fields rtol 1e-5, o(τ) atol
#: 1e-5, the integral and the stored information rtol 1e-4.
MF_RTOL, DDE_ATOL, INTEGRAL_RTOL = 1e-5, 1e-5, 1e-4
MF_FIELDS = ("a", "b", "S", "T_S", "r", "d_M", "d_I", "stability", "rho")
#: tests/test_meanfield.py:27-29's grid, for the batched solvers.
MF_GRID = [dict(lam=lam, M=M) for lam in (0.01, 0.05, 0.2) for M in (1, 4)]
KERNELS = (kc.pairwise_contacts, gm.gossip_merge_rows,
           gm.gossip_merge_rows_scaled, kc.cell_close_words, gm.gossip_merge,
           fa.flash_attention, ks.ssd_scan)
#: Kernel launch counts of a dense run without learning, per slot.
DENSE_ONLY = dict(pairwise_contacts=1, gossip_merge_rows=0,
                  gossip_merge_rows_scaled=0, cell_close_words=0,
                  gossip_merge=0, flash_attention=0, ssd_scan=0)
#: ... and of the serving path: flash_attention only.
NO_KERNEL = dict(DENSE_ONLY, pairwise_contacts=0)
#: ... and of a cells run without learning.
CELLS_ONLY = dict(DENSE_ONLY, pairwise_contacts=0, cell_close_words=1)
#: The gossip round's configuration: h2o-danube-3-4b at its published
#: widths (arXiv:2401.16818), cut to 2 of its 24 layers, R = 4 replicas,
#: each from its own key, and a fifth initialisation as the default.
GOSSIP_ARCH, GOSSIP_LAYERS, GOSSIP_R = "h2o-danube-3-4b", 2, 4
#: seed 1: under the default seed 0 no replica churns in the first 16
#: rounds (64 draws at 0.05), which would leave the churn path unexercised;
#: under seed 1 one replica churns in round 5 and two in round 11.
GOSSIP = gossip.GossipConfig(matching="random", success_prob=0.9,
                             busy_prob=0.05, churn_prob=0.05,
                             merge_policy="obs_count", seed=1)
#: count before round 0, so that the obs_count weights are not all 0.5.
GOSSIP_COUNTS = (1.0, 2.0, 3.0, 7.0)
#: gossip-round's rounds: three of seed 1's, with the churn of round 11.
CHECKED_ROUNDS = (10, 11, 12)
#: flash_attention vs its plain version: tests/test_kernels.py:12's
#: tolerances (rtol, atol): float32 sums in other orders; in bfloat16 the
#: output's rounding can then differ by an ulp (2^-8 relative).
ATTN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
#: ... and the output's relative L2 error, ||got - want|| / ||want||, at
#: most this. Over thousands of keys a flat softmax leaves outputs near
#: ATTN_TOL's atol, where a 64-key tile dropped or a window edge a tile off
#: passes it (about 4e-3 of abs change) but moves the relative error by
#: ~0.1. Float32: sums in other orders, ~1e-6; bfloat16: the output's
#: rounding and P in bf16, ~2e-3 (the mma form's arithmetic on the CPU).
ATTN_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: q's scale in the long-key cases (k and v: 0.5): scores of standard
#: deviation ~2, so the softmax is peaked and the outputs well above atol.
SHARP_Q = 4.0
#: Serving logits, one path against another (rtol, atol): float32 products
#: summed in other orders (cuBLAS, the CPU, the kernel); in bfloat16 the
#: two paths round the residual stream at other points (matrix products of
#: other shapes, the kernel against the chunked softmax), an ulp or two of
#: activations of order 1 (the CPU tests measured 0.05 against repro).
SERVE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 0.1)}
#: Serving at full width: the gossip configuration's tree (2 of 24 layers
#: of h2o-danube-3-4b, bf16, window 4096), one prefill of twice the window,
#: then 8 requests of 64 prompt and 64 new tokens.
PREFILL_S = 8192
GEN_B, GEN_PROMPT, GEN_NEW, GEN_MAX_LEN = 8, 64, 64, 256
#: The decode kernel is timed at this many valid cache slots, and at a
#: long cache (the window of h2o-danube-3-4b), where one block per (batch,
#: KV head) leaves half the card idle.
DECODE_VALID = 128
DECODE_LONG = 4096
#: Mamba-2 serving: mamba2-130m (arXiv:2405.21060) at its published widths
#: and all 24 layers, bf16, with the same two traffic shapes.
MAMBA_ARCH = "mamba2-130m"
#: ssd_scan vs its plain version: tests/test_kernels.py:64-66's tolerances
#: (rtol, atol): float32 sums in other orders, which the exp of the
#: cumulative sums amplifies; in bfloat16 y is rounded once more.
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 5e-2)}
#: ... and y's (and the final state's) relative L2 error, ||got - want|| /
#: ||want||, at most this. Over a chunk of 128 the fast decay of the other
#: cases (dt = softplus(0.5·randn), A in [0.5, 2]) leaves a state weight of
#: e^-47 or less, and D·x is most of y: a state handed to the next chunk a
#: chunk late, or decayed twice, changes y by nothing there. The slow-decay
#: cases (dt = softplus(0.5·randn - 5), D = 0) keep exp(-csum_Q) near
#: 0.2-0.65, where those faults move y by 0.17-0.67 of its norm. Float32:
#: sums in other orders; bfloat16: y's one rounding to bf16 (~2e-3).
SSD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: bfloat16 logits of a Mamba stack, one path against another (rtol,
#: atol): an ulp of difference at a layer's input comes out of the next
#: layer's chunked scan several ulps apart (tests/test_torch_mamba.py
#: measured 0.08-0.21 between the port and repro at 2 layers, where repro's
#: own bfloat16 logits lie up to 0.50 from its float32 ones).
MAMBA_DEEP_TOL = (2e-2, 0.5)
#: mamba2-130m's decode logits against its prefill's, on the bf16 tree
#: cast to float32 (rtol, atol): the recurrence against the chunked scan
#: (two algorithms) through 24 layers, measured 2.6e-4 at logits up to
#: 4.7 on an H100 (PERF.md §6, PR 19). In bf16 the two paths round at
#: other points (the decode's convolution runs in float32, the prefill's
#: in bf16) and 24 random layers amplify that: 2.0 at logits up to 4.8
#: and 0.625 argmax agreement there, so bf16 is reported, not held.
MAMBA_F32_TOL = (1e-3, 1e-3)


_START = time.perf_counter()


def phase(name: str, msg: str) -> None:
    print(f"[{name} +{time.perf_counter() - _START:.0f}s] {msg}", flush=True)


def roofline_ms(nbytes: float, flops: float,
                flops_s: float = F32_FLOPS_S) -> tuple[float, str]:
    """The least time of a call that moves ``nbytes`` and does ``flops``
    operations at ``flops_s`` (default: float32): the larger of the two at
    the card's peaks, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / flops_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_bound_ms(b: int, n: int) -> tuple[float, str]:
    """Least time for one sweep: every input read once (x, y, zone word,
    elig, prevw), every output written once (closew, best_j, has), and 5
    float32 operations per pair (2 subtractions, a multiply, an FMA)."""
    nw = (n + 31) // 32
    nbytes = b * n * (4 + 4 + 4 + 1) + 2 * b * n * nw * 4 + b * n * (4 + 1)
    flops = 5 * b * n * n
    return roofline_ms(nbytes, flops)


def _events_ms(run, count: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / count


def call_ms(fn, reps: int = 200, warm: int = 20) -> float:
    """Time per eager call, CUDA events around ``reps`` calls: what the
    simulator's loop pays, host-side launch overhead included."""
    for _ in range(warm):
        fn()

    def run():
        for _ in range(reps):
            fn()

    return _events_ms(run, reps)


def device_ms(fn, per_graph: int = 50, replays: int = 20) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph
    and replayed, so no host work sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()

    ms = _events_ms(run, replays * per_graph)
    del graph
    return ms


def launch_floor_ms() -> float:
    """The card's launch floor: device time per call of a one-element
    ``fill_`` in the same CUDA-graph harness as the kernels
    (:func:`device_ms`), the least any launch on this path can take."""
    one = torch.empty(1, device="cuda")
    return device_ms(lambda: one.fill_(0.0))


def zone_draw(rng, shape, zone_bits: int) -> torch.Tensor:
    """Int32 zone words with up to ``zone_bits`` bits. At 32 bits each word
    holds one or two of the top four zones (bits 28-31), so that the gate
    keeps few pairs and a quarter of the words or more set bit 31, the
    int32 sign bit (words drawn as int64, then cut to int32)."""
    if zone_bits < 32:
        return torch.tensor(rng.integers(0, 1 << zone_bits, shape),
                            dtype=torch.int32)
    one = np.left_shift(1, rng.integers(28, 32, shape))
    two = np.where(rng.random(shape) < 0.3,
                   np.left_shift(1, rng.integers(28, 32, shape)), 0)
    return torch.tensor(one | two, dtype=torch.int64).to(torch.int32)


def random_case(rng, b: int, n: int, density: float, side: float,
                zone_bits: int, lattice: bool = False,
                full_prev: bool = False, r_tx2: float = 25.0):
    """Kernel inputs on the card: positions in a ``side`` square, zone
    words with up to ``zone_bits`` bits, symmetric previous contacts.

    ``lattice``: positions on the integer lattice of the square, every node
    in zone 1, so that many pairs of a row share one d² (the argmin's tie
    rule across lanes and words). ``full_prev``: every bit of ``prevw`` set
    (pad bits too) except a tenth of the close pairs' bits."""
    if lattice:
        xy = rng.integers(0, int(side), (2, b, n)).astype(np.float32)
        x, y = (torch.tensor(v) for v in xy)
        zw = torch.ones((b, n), dtype=torch.int32)
    else:
        x = torch.tensor(rng.uniform(0, side, (b, n)), dtype=torch.float32)
        y = torch.tensor(rng.uniform(0, side, (b, n)), dtype=torch.float32)
        zw = zone_draw(rng, (b, n), zone_bits)
    elig = torch.tensor(rng.random((b, n)) < 0.7)
    args = [t.cuda() for t in (x, y, zw, elig)]
    gen = torch.Generator("cuda").manual_seed(n)
    if full_prev:
        closew = kc.pairwise_contacts_ref(
            *args, torch.zeros((b, n, (n + 31) // 32), dtype=torch.int32,
                               device="cuda"), r_tx2)[0]
        keep = pack_mask(torch.rand((b, n, n), device="cuda",
                                    generator=gen) < 0.1)
        return args + [~(closew & keep)]
    prev = torch.rand((b, n, n), device="cuda", generator=gen) < density
    return args + [pack_mask(prev & prev.transpose(1, 2))]


def max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def check_kernel_cases(floor_ms: float) -> int:
    """The kernel against its plain version, bit for bit, over N x prev
    density (B = 2), multi-bit zone words, a dense cluster, the N where
    lanes start to hold more than one word (1024, 1025, 2048), the sweeps'
    batch (B = 16), lattice positions full of equal d², ``prevw`` with
    every bit set but a few, and N = 5000 and 16500 (5 and 17 segments of
    1024 columns, and at 16500 two chunks)."""
    rng = np.random.default_rng(0)
    r_tx2 = 25.0
    worst = 0
    cases = [dict(n=n, density=d) for n in (20, 33, 65, 130, 200, 800, 3200)
             for d in (0.0, 0.3, 1.0)]
    cases += [dict(n=200, density=0.2, zone_bits=5),
              dict(n=130, side=4.0), dict(n=130, side=4.0, zone_bits=3)]
    # words over all 32 bits: bit 31 is the int32 sign bit
    cases += [dict(n=200, density=0.2, zone_bits=32),
              dict(n=130, side=4.0, zone_bits=32),
              dict(n=1025, density=0.1, side=40.0, zone_bits=32),
              dict(n=200, b=16, density=0.2, side=20.0, zone_bits=32)]
    cases += [dict(n=n, density=d) for n in (1024, 1025, 2048)
              for d in (0.0, 0.3)]
    cases += [dict(n=200, density=0.2, b=16), dict(n=200, b=16, lattice=True,
                                                     side=14.0)]
    cases += [dict(n=n, lattice=True, side=side)
              for n, side in ((200, 12.0), (1100, 40.0), (2048, 45.0))]
    cases += [dict(n=n, full_prev=True, side=side)
              for n, side in ((200, 30.0), (1025, 60.0))]
    # many segments a chunk; past 16384, two chunks
    cases += [dict(n=5000, side=400.0, density=0.001),
              dict(n=16500, b=1, side=600.0, density=0.0002)]
    for case in cases:
        kw = dict(b=2, density=0.0, side=60.0, zone_bits=1) | case
        args = random_case(rng, kw.pop("b"), kw.pop("n"), r_tx2=r_tx2, **kw)
        got = kc.pairwise_contacts(*args, r_tx2)
        want = kc.pairwise_contacts_ref(*args, r_tx2)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("closew", "best_j", "has")):
            if not torch.equal(g, w):
                raise AssertionError(f"kernel != plain on {name} at {case}")
        worst = max(worst, max_abs_err(got, want))
    phase("kernel", f"{len(cases)} cases bit for bit (N up to 16500 in two "
                    f"chunks, B=1, 2 and 16, multi-bit zone words and 4 cases"
                    f" of words with bit 31 set, clustered "
                    f"nodes, N=1024/1025/2048, lattice ties, full prevw); "
                    f"max_abs_err={worst} launch_floor_us={1e3 * floor_ms:.3f}")
    return worst


def main_path_inputs(cfg: SimConfig, seed: int):
    """The kernel's inputs as the main path gives them: positions after
    one rdm step at ``cfg``, the zone words, in-zone eligibility, and the
    previous slot's packed contacts."""
    model = get_mobility("rdm")
    key = jr.PRNGKey(seed, device="cuda")[None]
    mob, key = model.init(key, cfg)
    zs = effective_zones(cfg)
    r_tx2 = float(np.float32(cfg.r_tx ** 2))

    def sweep_args(pos):
        zw = pack_mask(zone_member(pos, zs))[..., 0]
        return (pos[..., 0].contiguous(), pos[..., 1].contiguous(), zw,
                zw != 0)

    x0, y0, zw0, el0 = sweep_args(mob.pos)
    n = cfg.n_nodes
    empty = torch.zeros((1, n, (n + 31) // 32), dtype=torch.int32,
                        device="cuda")
    prevw = kc.pairwise_contacts_ref(x0, y0, zw0, el0, empty, r_tx2)[0]
    k1, k2, _ = jr.split(key, 3).unbind(-2)
    mob = model.step(k1, k2, mob, cfg)
    return (*sweep_args(mob.pos), prevw), r_tx2


def time_kernel(cfg: SimConfig, seed: int, b: int = 1) -> dict:
    """Holds the kernel against its plain version, bit for bit, on the
    main path's own inputs at ``cfg`` (``b`` runs, seeds ``seed`` on,
    stacked on the batch axis), then times both."""
    items = [main_path_inputs(cfg, seed + k) for k in range(b)]
    args = tuple(torch.cat([a[i] for a, _ in items]) for i in range(5))
    return time_kernel_args(args, items[0][1], "the path's inputs")


def time_kernel_args(args, r_tx2: float, on: str) -> dict:
    """The kernel against its plain version, bit for bit, on the inputs
    ``(x, y, zw, elig, prevw)`` (``on`` says whose), then both timed."""
    args = tuple(args[:5])

    def kernel():
        return kc.pairwise_contacts(*args, r_tx2)

    def plain():
        return kc.pairwise_contacts_ref(*args, r_tx2)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("closew", "best_j", "has")):
        if not torch.equal(g, w):
            raise AssertionError(f"kernel != plain on {name} at {on}, "
                                 f"(B, N)={tuple(args[0].shape)}")
    bound_ms, bound_by = kernel_bound_ms(*args[0].shape)
    return dict(on=on, max_abs_err=max_abs_err(got, want),
                ms=device_ms(kernel), plain_ms=device_ms(plain),
                call_ms=call_ms(kernel), plain_call_ms=call_ms(plain),
                bound_ms=bound_ms, bound_by=bound_by)


def time_sweeps_shape(floor_ms: float, b: int = 16) -> None:
    """The contact kernel at the sweeps' shape: ``b`` paper-point runs
    (N = 200) in one launch, on their own inputs."""
    k = time_kernel(SimConfig(), 0, b)
    phase("kernel-sweeps", (
        f"B={b} N=200 (seeds 0-{b - 1}, one rdm step): kernel==plain "
        f"(max_abs_err={k['max_abs_err']}) kernel_us={1e3 * k['ms']:.3f} "
        f"bound_us={1e3 * k['bound_ms']:.5f} ({k['bound_by']}) "
        f"plain_us={1e3 * k['plain_ms']:.3f} "
        f"kernel_call_us={1e3 * k['call_ms']:.3f} "
        f"launch_floor_us={1e3 * floor_ms:.3f}"))


def same_traces(a, b, what: str = "replayed GPU run != CPU run",
                traces=TRACES) -> None:
    for f in traces:
        x, y = getattr(a, f), getattr(b, f)
        if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what} on {f}")


def check_replay(refs: dict, seed: int = 0) -> None:
    p, cfg, _ = replay_case("replay")
    n_slots = cfg.n_slots
    cpu, track, t_cpu = refs["replay"].result()
    reset_counts()
    t = time.perf_counter()
    gpu = simulate(p, dataclasses.replace(cfg, mobility="replay"), seed=seed,
                   device="cuda", positions=track)
    t_gpu = time.perf_counter() - t
    launches = kc.pairwise_contacts.launches
    same_traces(cpu, gpu)
    if counts() != per_run(DENSE_ONLY, n_slots):
        raise AssertionError(f"launches {counts()} for {n_slots} slots")
    phase("replay", f"N=200 {n_slots} slots: every trace bit for bit; "
                    f"launches={launches}; cpu {t_cpu:.1f}s, gpu {t_gpu:.1f}s")


def free_run(label: str, p, cfg: SimConfig, seed: int = 0,
             per_slot: dict = DENSE_ONLY, timed=None, tag: str = "run") -> dict:
    """A free run on the card: launches as ``per_slot`` says, finite traces
    of the expected shape, no neighbour-list overflow, population and
    availability sane. Then ``timed()`` holds the path's kernel against its
    plain version and times it (by default the contact kernel on the main
    path's own inputs), and a short profile follows."""
    reset_counts()
    t = time.perf_counter()
    out = simulate(p, cfg, seed=seed)                 # default device: cuda
    wall = time.perf_counter() - t
    launches = counts()
    if launches != per_run(per_slot, slots_run(cfg)):
        raise AssertionError(f"{label}: launches {launches}")
    s0 = int(len(out.t) * cfg.warmup_frac)
    n_rz = float(out.n_in_rz[s0:].mean())
    avail = float(out.availability[s0:].mean())
    for name in ("availability", "stored_info", "busy_frac"):
        if not np.all(np.isfinite(getattr(out, name))):
            raise AssertionError(f"{label}: non-finite {name}")
    if out.availability.shape != (cfg.n_slots // cfg.sample_every, p.M):
        raise AssertionError(f"{label}: availability {out.availability.shape}")
    if out.nbr_overflow is not None and int(out.nbr_overflow.max()) != 0:
        raise AssertionError(f"{label}: nbr_overflow {out.nbr_overflow.max()}")
    if abs(n_rz - p.N) / p.N >= 0.05:
        raise AssertionError(f"{label}: mean n_in_rz {n_rz} vs N {p.N}")
    if not 0.0 < avail <= 1.0:
        raise AssertionError(f"{label}: mean availability {avail}")
    k = timed() if timed else time_kernel(cfg, seed)
    plain_call = (f"plain_call_us={1e3 * k['plain_call_ms']:.3f} "
                  if "plain_call_ms" in k else "")
    phase(tag, (
        f"{label}: N={cfg.n_nodes} slots={cfg.n_slots} wall={wall:.3f}s "
        f"slots/s={cfg.n_slots / wall:.1f} launches={launches} "
        f"kernel==plain on {k['on']} (max_abs_err={k['max_abs_err']}) "
        f"kernel_us={1e3 * k['ms']:.3f} bound_us={1e3 * k['bound_ms']:.5f} "
        f"({k['bound_by']}) plain_us={1e3 * k['plain_ms']:.3f} "
        f"kernel_call_us={1e3 * k['call_ms']:.3f} {plain_call}"
        f"mean availability={avail:.6f} busy={float(out.busy_frac[s0:].mean()):.6f} "
        f"stored_info={float(out.stored_info[s0:].mean()):.6f} "
        f"n_in_rz={n_rz:.3f} (N={p.N:.3f})"))
    profile_slots(label, p, cfg)
    name, = (n for n, v in per_slot.items() if v)
    return dict(launches=launches[name], out=out, **k)


def profiled(run) -> tuple[float, list]:
    """The wall µs of ``run()`` under ``torch.profiler`` (device activity
    only), synchronised, and its CUDA events summed by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    return wall_us, [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_slots(label: str, p, cfg: SimConfig, n_slots: int = 16,
                  run=None) -> None:
    """Where a slot's time goes: ``torch.profiler`` (device activity only,
    a short run: its post-processing walks every event in Python) — the
    device's busy share of the wall time, CUDA kernels per slot, and the
    heaviest kernels. Reports "not measured" if the profiler sees no
    device time. The run steps whole samples only, so the counts are per
    slot it stepped.
    ``run(cfg)`` runs the short configuration (default: ``simulate`` of
    ``p``; a sweep profiles all its rows' slots together)."""
    short = dataclasses.replace(cfg, n_slots=n_slots,
                                sample_every=min(cfg.sample_every, n_slots))
    n_slots = slots_run(short)
    if run is None:
        def run(c):
            return simulate(p, c)
    run(short)
    t_all = time.perf_counter()
    wall_us, dev = profiled(lambda: run(short))
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        phase("profile", f"{label}: device time not measured")
        return
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    phase("profile", (
        f"{label}: {n_slots} slots in {time.perf_counter() - t_all:.1f}s "
        f"with the profiler, wall_per_slot_us={wall_us / n_slots:.1f} "
        f"device_busy_share={busy_us / wall_us:.4f} "
        f"device_us_per_slot={busy_us / n_slots:.1f} "
        f"kernels_per_slot={sum(e.count for e in dev) / n_slots:.1f} top: " +
        "; ".join(f"{e.key[:48]} {e.self_device_time_total / n_slots:.2f}us/slot "
                  f"x{e.count / n_slots:.1f}" for e in top)))


# ------------------------------------------------------ the free-run check

def analytics(p, device) -> tuple[dict, float]:
    """The paper point's Lemma 1-3 fixed point, Theorem-1 DDE and Lemma 4
    stored information on ``device`` (None: the default, cuda), strict;
    returns them and the wall seconds of each, synchronised."""
    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    cm, t_cm = timed(lambda: paper_contact_model(device=device))
    sol, t_fp = timed(lambda: solve_fixed_point(p, cm, strict=True))
    dde, t_dde = timed(lambda: solve_observation_availability(p, sol,
                                                              strict=True))
    stored = node_stored_information(p, sol, dde.integral(p.tau_l))
    return (dict(cm=cm, sol=sol, dde=dde, stored=float(stored)),
            dict(contact=t_cm, fixed_point=t_fp, dde=t_dde))


def held_to_cpu(card, cpu, what: str) -> float:
    """A mean-field solution (and its DDE) from the card against the CPU's,
    to the CPU tests' tolerances; returns the largest relative difference
    of the fixed point's fields."""
    worst = 0.0
    for f in MF_FIELDS:
        got, want = getattr(card["sol"], f).cpu(), getattr(cpu["sol"], f)
        finite = torch.isfinite(want)
        if not (torch.equal(torch.isfinite(got), finite)
                and torch.allclose(got[finite], want[finite], rtol=MF_RTOL,
                                   atol=1e-30)):
            raise AssertionError(f"{what}: {f} card {got} vs cpu {want}")
        rel = (got - want)[finite].abs() / want[finite].abs().clamp_min(1e-30)
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
    if not torch.equal(card["sol"].converged.cpu(), cpu["sol"].converged):
        raise AssertionError(f"{what}: converged differs")
    o_err = float((card["dde"].o.cpu() - cpu["dde"].o).abs().max())
    if o_err > DDE_ATOL:
        raise AssertionError(f"{what}: o(tau) differs by {o_err}")
    return worst


def fig1_grid() -> list:
    """benchmarks/fig1_availability.py:30-42's full grid: the two service
    time variants x four model sizes, λ = 0.05, M = 1; the first point is
    the paper point."""
    return [paper_params(**MF_POINT, T_T=t_t, T_M=t_m, L=size)
            for t_t, t_m in FIG1_VARIANTS for size in FIG1_LS]


def mf_analytics() -> dict:
    """The paper point's analytics on the card and on the CPU, the card's
    held to the CPU's (timed on a quiet card, before the side phases)."""
    p = paper_params(**MF_POINT)
    card, t_card = analytics(p, None)                # default device: cuda
    cpu, t_cpu = analytics(p, "cpu")
    if card["sol"].a.device.type != "cuda" or card["dde"].o.device.type != "cuda":
        raise AssertionError("mf-check: the analytics left the card")
    fp_rel = held_to_cpu(card, cpu, "mf-check analytics")
    if not math.isclose(card["stored"], cpu["stored"], rel_tol=INTEGRAL_RTOL):
        raise AssertionError(f"mf-check: stored information card "
                             f"{card['stored']} vs cpu {cpu['stored']}")
    return dict(card=card, cpu=cpu, t_card=t_card, t_cpu=t_cpu, fp_rel=fp_rel)


def mf_check(an: dict):
    """The main path's free-run check on the card, as one sweep: Fig. 1's
    grid x seeds (0, 1) (B = 16, 7992 slots each) in one slot loop, one
    contact-kernel launch a slot for all 16 rows; the paper point's seed-0
    row held to the reference test's five thresholds against the card's
    analytics ``an`` (:func:`mf_analytics`); every row's a, busy and
    stored information against Fig. 1's mean field. Returns ``finish()``,
    the part that times, for a quiet card: the contact kernel held against
    its plain version on the sweep's last B = 16 inputs and timed, a
    profile of the sweep, the batched solvers over tests/test_meanfield.py's
    grid held row by row to the CPU's."""
    ps = fig1_grid()
    p = paper_params(**MF_POINT)
    if ps[0] != p:
        raise AssertionError("mf-check: Fig. 1's first point is not the "
                             "paper point")
    card, cpu, t_card, t_cpu, fp_rel = (
        an[k] for k in ("card", "cpu", "t_card", "t_cpu", "fp_rel"))

    b = len(ps) * len(MF_SEEDS)
    with Recorder("pairwise_contacts", keep=1, module=sim_contacts) as rec:
        reset_counts()
        t = time.perf_counter()
        batch = sweep.run(ps, MF_CFG, MF_SEEDS)       # default device: cuda
        wall = time.perf_counter() - t
        launches = counts()
    if launches != per_run(DENSE_ONLY, slots_run(MF_CFG)):
        raise AssertionError(f"mf-check: launches {launches}, want one "
                             f"pairwise_contacts a slot for all {b} rows")
    (args, _), = rec.calls
    if args[0].shape != (b, MF_CFG.n_nodes):
        raise AssertionError(f"mf-check: the kernel ran at {args[0].shape}")
    s_count = MF_CFG.n_slots // MF_CFG.sample_every
    for name in ("availability", "stored_info", "busy_frac"):
        arr = getattr(batch, name)
        if arr.shape[:3] != (len(ps), len(MF_SEEDS), s_count) \
                or not np.all(np.isfinite(arr)):
            raise AssertionError(f"mf-check: {name} {arr.shape} not finite")
    half = s_count // 2
    n_rows = batch.n_in_rz[:, :, half:].mean(-1)
    if np.any(np.abs(n_rows - p.N) / p.N >= 0.05):
        raise AssertionError(f"mf-check: populations {n_rows}")

    out = batch.point(0, 0)
    sol = card["sol"]
    a_mf, b_mf = float(sol.a), float(sol.b)
    n_sim = float(out.n_in_rz[half:].mean())
    a_sim = float(out.availability[half:].mean())
    b_sim = float(out.busy_frac[half:].mean())
    st_sim, st_mf = float(out.stored_info[half:].mean()), card["stored"]
    checks = {
        "population within 5% of N": abs(n_sim - p.N) / p.N < 0.05,
        "availability within 15%": abs(a_mf - a_sim) / a_sim < 0.15,
        "a_mf >= a_sim - 0.02": a_mf >= a_sim - 0.02,
        "busy within 50%": abs(b_mf - b_sim) / max(b_sim, 1e-6) < 0.5,
        "stored: sim > 0": st_sim > 0,
        "stored: mf/sim < 2": st_mf / st_sim < 2.0,
        "stored: mf >= sim - 0.5": st_mf >= st_sim - 0.5,
        "stability < 0.5": float(sol.stability) < 0.5,
        "S > 0.95": float(sol.S) > 0.95,
    }
    failed = [k for k, ok in checks.items() if not ok]

    # Fig. 1's table: the batched fixed point, the batched DDE and the
    # capacity on the card, against each row's second half (seeds pooled)
    sols = solve_fixed_point_batch(ps, card["cm"], strict=True)
    dde = solve_observation_availability_batch(ps, sols, strict=True)
    rows = []
    for i, q in enumerate(ps):
        st = float(node_stored_information(
            q, sols.point(i), dde.point(i).integral(q.tau_l)))
        rows.append(
            f"T_T={q.T_T:g} T_M={q.T_M:g} L={q.L:g}: a mf={float(sols.a[i]):.6f} "
            f"sim={float(batch.availability[i, :, half:].mean()):.6f}, busy "
            f"mf={float(sols.b[i]):.6f} "
            f"sim={float(batch.busy_frac[i, :, half:].mean()):.6f}, stored "
            f"mf={st:.6f} sim={float(batch.stored_info[i, :, half:].mean()):.6f}")
    phase("mf-check", (
        f"Fig. 1 grid, {len(ps)} points x seeds {MF_SEEDS} (B={b}), "
        f"{MF_CFG.n_slots} slots, second half, mean field vs simulation: "
        + "; ".join(rows)))
    phase("mf-check", (
        f"sweep (beside the side phases): B={b} N={MF_CFG.n_nodes} "
        f"slots={MF_CFG.n_slots} wall={wall:.3f}s "
        f"slots/s={MF_CFG.n_slots / wall:.1f} "
        f"run-slots/s={b * MF_CFG.n_slots / wall:.1f} launches={launches}"))
    line = (f"paper point (row 0, seed 0), {MF_CFG.n_slots} slots, second "
            f"half: a mf={a_mf:.6f} sim={a_sim:.6f}; b mf={b_mf:.6f} "
            f"sim={b_sim:.6f}; S={float(sol.S):.6f} "
            f"stability={float(sol.stability):.6f}; stored_info "
            f"mf={st_mf:.6f} sim={st_sim:.6f}; n_in_rz={n_sim:.3f} "
            f"(N={p.N:.3f}); card vs cpu max_rel={fp_rel:.3e}; analytics "
            f"wall on the card: contact {t_card['contact']:.3f}s, fixed "
            f"point {t_card['fixed_point']:.3f}s, dde "
            f"{t_card['dde']:.3f}s ({card['dde'].o.numel()} samples); on "
            f"the cpu: fixed point {t_cpu['fixed_point']:.3f}s, dde "
            f"{t_cpu['dde']:.3f}s")
    if failed:
        raise AssertionError(f"mf-check: {failed} failed; {line}")
    phase("mf-check", f"all five thresholds hold; {line}")

    def finish() -> dict:
        k = time_kernel_args(args, args[5], f"the sweep's last inputs (B={b})")
        phase("mf-check", (
            f"kernel==plain on {k['on']} (max_abs_err={k['max_abs_err']}) "
            f"kernel_us={1e3 * k['ms']:.3f} bound_us={1e3 * k['bound_ms']:.5f} "
            f"({k['bound_by']}) plain_us={1e3 * k['plain_ms']:.3f} "
            f"kernel_call_us={1e3 * k['call_ms']:.3f} "
            f"plain_call_us={1e3 * k['plain_call_ms']:.3f}"))
        profile_slots(f"fig1 sweep B={b}", p, MF_CFG,
                      run=lambda c: sweep.run(ps, c, MF_SEEDS))
        mf_batch(card, cpu)
        return dict(launches=launches["pairwise_contacts"], **k)

    return finish


def mf_batch(card_point, cpu_point) -> None:
    """The batched fixed point and DDE on the card over the λ × M grid:
    each row held to the CPU's batch, and the paper point's row to the
    card's scalar solve bit for bit."""
    ps = [paper_params(**kw) for kw in MF_GRID]
    cm_card, cm_cpu = card_point["cm"], cpu_point["cm"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    sols = solve_fixed_point_batch(ps, cm_card, strict=True)
    torch.cuda.synchronize()
    t_fp = time.perf_counter() - t
    t = time.perf_counter()
    dde = solve_observation_availability_batch(ps, sols, strict=True)
    torch.cuda.synchronize()
    t_dde = time.perf_counter() - t
    cpu_sols = solve_fixed_point_batch(ps, cm_cpu, strict=True)
    cpu_dde = solve_observation_availability_batch(ps, cpu_sols, strict=True)
    worst = held_to_cpu(dict(sol=sols, dde=dde), dict(sol=cpu_sols,
                                                      dde=cpu_dde),
                        "mf-check batch")
    ints = dde.integral(torch.tensor([p.tau_l for p in ps], device="cuda"))
    cpu_ints = cpu_dde.integral(torch.tensor([p.tau_l for p in ps]))
    if not torch.allclose(ints.cpu(), cpu_ints, rtol=INTEGRAL_RTOL):
        raise AssertionError(f"mf-check batch: integrals {ints} vs {cpu_ints}")
    i = MF_GRID.index(MF_POINT)
    for f in MF_FIELDS:
        if not torch.equal(getattr(sols, f)[i], getattr(card_point["sol"], f)):
            raise AssertionError(f"mf-check batch: row {i} {f} != scalar")
    if not torch.equal(dde.o[i], card_point["dde"].o):
        raise AssertionError(f"mf-check batch: row {i} o(tau) != scalar")
    phase("mf-check", (
        f"batched over lam x M = {len(ps)} points: every row within the "
        f"CPU tests' tolerances of the CPU's batch (max_rel={worst:.3e}), "
        f"the paper point's row equal to the scalar solve bit for bit; "
        f"wall on the card: fixed point {t_fp:.3f}s, dde {t_dde:.3f}s "
        f"({dde.o.shape[1]} steps x {len(ps)} points); "
        f"a={[round(float(x), 6) for x in sols.a]}"))


# ------------------------------------------------------------------- sweeps

#: The sweep phases' grid: three observation rates at the paper geometry
#: (scenario axis) x seeds 0 and 1.
SWEEP_LAMS = (0.02, 0.05, 0.2)
SWEEP_SEEDS = (0, 1)
#: Reductions on the card vs numpy's of the trace (rtol, atol): float32
#: sums over the samples in another order (the card's reduction kernels
#: against numpy's pairwise sums); final samples and o_tau_den are exact.
REDUCE_TOL = (1e-5, 1e-6)
#: sweep rows' protocol traces, held bit for bit wherever rows are compared
SWEEP_TRACES = tuple(f for f in TRACES if f != "t")


def sweep_grid(**kw) -> list:
    return [paper_params(lam=lam, M=1, **kw) for lam in SWEEP_LAMS]


def same_rows(batch, i: int, j: int, one, what: str,
              traces=SWEEP_TRACES) -> None:
    """Row (i, j) of a sweep equal to a single run on every trace."""
    same_traces(batch.point(i, j), one, f"{what}: row ({i}, {j})", traces)


def sweep_rows(n_slots: int = 304) -> None:
    """A 3 x 2 sweep on the card (one contact launch a slot for its 6
    rows): finite traces, and the rows of one seed share its population
    trace bit for bit (mobility and zones run once a seed). Its two B = 1
    runs were cut to keep the script in its time: faults-replay and
    sweep-learn hold sweep rows to B = 1 card runs."""
    ps, cfg = sweep_grid(), SimConfig(n_slots=n_slots)
    reset_counts()
    t = time.perf_counter()
    batch = sweep.run(ps, cfg, SWEEP_SEEDS)           # default device: cuda
    wall = time.perf_counter() - t
    if counts() != per_run(DENSE_ONLY, slots_run(cfg)):
        raise AssertionError(f"sweep-rows launches {counts()}")
    for f in ("availability", "busy_frac", "stored_info"):
        if not np.all(np.isfinite(getattr(batch, f))):
            raise AssertionError(f"sweep-rows: {f} not finite")
    for i in range(1, len(ps)):
        if not np.array_equal(batch.n_in_rz[i], batch.n_in_rz[0]):
            raise AssertionError(f"sweep-rows: scenario {i}'s populations "
                                 f"differ from scenario 0's")
    b = len(ps) * len(SWEEP_SEEDS)
    phase("sweep-rows", (
        f"lam {SWEEP_LAMS} x seeds {SWEEP_SEEDS} (B={b}), N=200, "
        f"{slots_run(cfg)} slots: finite, each seed's population trace "
        f"shared by its rows; launches={counts()['pairwise_contacts']}; "
        f"sweep {wall:.1f}s ({slots_run(cfg) / wall:.1f} slots/s, "
        f"{b * slots_run(cfg) / wall:.1f} run-slots/s)"))


def sweep_replay(n_slots: int = 160) -> None:
    """The same grid with each seed's positions replayed: the card's sweep
    equals the CPU's bit for bit on every trace."""
    ps = sweep_grid()
    cfg = SimConfig(n_slots=n_slots, mobility="replay")
    tracks = np.stack([mobility_track(dataclasses.replace(cfg, mobility="rdm"),
                                      seed=s, device="cpu")
                       for s in SWEEP_SEEDS])
    t = time.perf_counter()
    cpu = sweep.run(ps, cfg, SWEEP_SEEDS, device="cpu", positions=tracks)
    t_cpu = time.perf_counter() - t
    reset_counts()
    t = time.perf_counter()
    gpu = sweep.run(ps, cfg, SWEEP_SEEDS, positions=tracks)
    t_gpu = time.perf_counter() - t
    if counts() != per_run(DENSE_ONLY, slots_run(cfg)):
        raise AssertionError(f"sweep-replay launches {counts()}")
    same_traces(cpu, gpu, "sweep on the card != on the CPU", SWEEP_TRACES)
    phase("sweep-replay", (
        f"lam {SWEEP_LAMS} x seeds {SWEEP_SEEDS}, N=200, {slots_run(cfg)} "
        f"slots, positions replayed: every trace bit for bit, card vs CPU; "
        f"launches={counts()['pairwise_contacts']}; cpu {t_cpu:.1f}s, gpu "
        f"{t_gpu:.1f}s"))


def reduced_like_numpy(trace, reduce: str, s0: int, qs) -> dict:
    """numpy's reduction of a trace sweep's light quantities."""
    light = dict(availability=trace.availability, busy_frac=trace.busy_frac,
                 stored=trace.stored_info, model_holders=trace.model_holders,
                 n_in_rz=trace.n_in_rz, availability_z=trace.availability_z,
                 stored_z=trace.stored_info_z, n_in_rz_z=trace.n_in_rz_z)
    out = {}
    for k, v in light.items():
        w = v[:, :, s0:].astype(np.float32)
        if reduce == "mean":
            out[k], out[k + "_std"] = w.mean(axis=2), w.std(axis=2)
        elif reduce == "final":
            out[k] = v[:, :, -1]
        else:
            out[k] = np.moveaxis(np.quantile(w, qs, axis=2), 0, -1)
    return out


def o_tau_like_numpy(trace, s0: int, tau) -> tuple:
    """``(num, den)`` of the o(τ) histograms of a trace sweep, in numpy."""
    # float32 ages and bins, as the card's reduction computes them
    age = (trace.t[s0:, None, None].astype(np.float32)
           - trace.obs_birth[:, :, s0:])
    frac = trace.obs_holders[:, :, s0:] / np.maximum(
        trace.model_holders[:, :, s0:], 1)[..., None]
    with np.errstate(invalid="ignore"):
        bins = np.floor(age / np.float32(tau[1] - tau[0]))
    ok = (np.isfinite(age) & (age >= 0)
          & (trace.model_holders[:, :, s0:] > 0)[..., None]
          & (bins >= 0) & (bins < len(tau)))
    num = np.zeros(trace.availability.shape[:2] + (len(tau),), np.float64)
    den = np.zeros_like(num)
    for t_i in range(len(tau)):
        sel = ok & (bins == t_i)
        num[..., t_i] = np.where(sel, frac, 0.0).sum(axis=(2, 3, 4))
        den[..., t_i] = sel.sum(axis=(2, 3, 4))
    return num, den


def sweep_reduce(n_slots: int = 96) -> None:
    """3 scenarios in chunks of 2 (padded to 4) x 2 seeds: the mean,
    final, quantiles and o_tau sweeps on the card held to numpy's
    reductions of the trace sweep (``REDUCE_TOL``; final samples and
    o_tau_den exact); then a checkpointed mean sweep, its second chunk
    file removed and resumed, bit for bit with the plain one."""
    ps, cfg = sweep_grid(), SimConfig(n_slots=n_slots)
    qs, tau = (0.1, 0.5, 0.9), np.arange(0.0, 60.0, 4.0)
    kw = dict(chunk_size=2)
    t = time.perf_counter()
    trace = sweep.run(ps, cfg, SWEEP_SEEDS, **kw)
    walls = {"trace": time.perf_counter() - t}
    if trace.plan.n_chunks != 2 or trace.plan.pad_scenarios != 4:
        raise AssertionError(f"sweep-reduce plan {trace.plan}")
    worst, runs = {}, {}
    for reduce in ("mean", "final", "quantiles", "o_tau"):
        t = time.perf_counter()
        got = runs[reduce] = sweep.run(
            ps, cfg, SWEEP_SEEDS, reduce=reduce, quantiles=qs,
            tau_grid=tau if reduce == "o_tau" else None, **kw)
        walls[reduce] = time.perf_counter() - t
        if reduce == "o_tau":
            num, den = o_tau_like_numpy(trace, got.warmup_samples, tau)
            if not np.array_equal(got.stats["o_tau_den"], den):
                raise AssertionError("sweep-reduce: o_tau_den differs")
            if den.sum() <= 0:
                raise AssertionError("sweep-reduce: no observation aged")
            want = {"o_tau_num": num}
        else:
            want = reduced_like_numpy(trace, reduce, got.warmup_samples, qs)
        for k, w in want.items():
            g = got.stats[k]
            if reduce == "final":
                if g.dtype != w.dtype or not np.array_equal(g, w):
                    raise AssertionError(f"sweep-reduce final {k} differs")
                continue
            worst[reduce] = max(worst.get(reduce, 0.0),
                                close(g, w, *REDUCE_TOL, f"{reduce} {k}"))
    plain = runs["mean"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as ck:
        full = sweep.run(ps, cfg, SWEEP_SEEDS, reduce="mean", **kw,
                         checkpoint_dir=ck)
        files = sorted(f for f in os.listdir(ck) if f.endswith(".npz"))
        if len(files) != 2:
            raise AssertionError(f"sweep-reduce: chunk files {files}")
        os.remove(os.path.join(ck, files[1]))
        t = time.perf_counter()
        resumed = sweep.run(ps, cfg, SWEEP_SEEDS, reduce="mean", **kw,
                            checkpoint_dir=ck, resume=True)
        walls["resume"] = time.perf_counter() - t
    for got in (full, resumed):
        if set(got.stats) != set(plain.stats) or not all(
                np.array_equal(got.stats[k], plain.stats[k])
                for k in plain.stats):
            raise AssertionError("sweep-reduce: checkpointed sweep differs")
    if resumed.telemetry["chunks"][0] != {"attempts": 0, "resumed": True}:
        raise AssertionError(f"sweep-reduce: {resumed.telemetry}")
    phase("sweep-reduce", (
        f"lam {SWEEP_LAMS} in chunks of 2 (padded to 4) x seeds "
        f"{SWEEP_SEEDS}, {slots_run(cfg)} slots: mean/std, quantiles "
        f"{qs} and o_tau_num vs numpy of the trace sweep max abs diff "
        f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } within "
        f"(rtol, atol) {REDUCE_TOL}; final and o_tau_den exact; "
        f"checkpointed mean sweep and its resume after losing chunk 1 bit "
        f"for bit with the plain one; host bytes trace {trace.host_bytes}, "
        f"mean {plain.host_bytes}; walls "
        f"{ {k: round(v, 1) for k, v in walls.items()} }s"))


def sweep_learn(n_slots: int = 160, cells_slots: int = 160) -> None:
    """A logreg learning sweep (2 x 2) and a cells sweep (N = 1024, 2 x 2)
    on the card: rows (0, 0) and (1, 1) equal B = 1 card runs, bit for bit
    on the protocol traces (and ``merge_stats``, ``nbr_overflow``), the
    learning traces within ``LEARN_TOL``."""
    base = paper_params(**LEARN_PARAMS)
    ps = [base, base.replace(lam=0.2)]
    cfg = SimConfig(n_slots=n_slots, learn=logreg_task())
    reset_counts()
    t = time.perf_counter()
    batch = sweep.run(ps, cfg, SWEEP_SEEDS)
    wall = time.perf_counter() - t
    if counts() != per_run(dict(DENSE_ONLY, gossip_merge_rows=1),
                           slots_run(cfg)):
        raise AssertionError(f"sweep-learn launches {counts()}")
    errs = {}
    for i, j in ((0, 0), (1, 1)):
        one = simulate(ps[i], cfg, seed=SWEEP_SEEDS[j])
        same_rows(batch, i, j, one, "sweep-learn",
                  SWEEP_TRACES + ("merge_stats",))
        for k in LEARN_TOL:
            errs[k] = max(errs.get(k, 0.0), close(
                getattr(batch.point(i, j), k), getattr(one, k),
                *LEARN_TOL[k], f"sweep-learn {k}"))
    p_c, cfg_c = scaled_point(1024, cells_slots)
    ps_c = [p_c, p_c.replace(lam=0.2)]
    reset_counts()
    t = time.perf_counter()
    cells_batch = sweep.run(ps_c, cfg_c, SWEEP_SEEDS)
    wall_c = time.perf_counter() - t
    if counts() != per_run(CELLS_ONLY, slots_run(cfg_c)):
        raise AssertionError(f"sweep-learn cells launches {counts()}")
    for i, j in ((0, 0), (1, 1)):
        one = simulate(ps_c[i], cfg_c, seed=SWEEP_SEEDS[j])
        same_rows(cells_batch, i, j, one, "sweep-learn cells",
                  SWEEP_TRACES + ("nbr_overflow",))
    phase("sweep-learn", (
        f"logreg, lam (0.05, 0.2) x seeds {SWEEP_SEEDS}, N=200, {n_slots} "
        f"slots: rows (0, 0) and (1, 1) vs B=1 card runs, protocol traces "
        f"and merge_stats bit for bit, learning traces max abs diff {errs} "
        f"within {LEARN_TOL}; wall {wall:.1f}s; cells N=1024, "
        f"{slots_run(cfg_c)} slots, 2 x 2: rows bit for bit with B=1 "
        f"(cell_close_words launches "
        f"{slots_run(cfg_c)}, one a slot over the 2 seeds' lists), "
        f"max nbr_overflow {int(cells_batch.nbr_overflow.max())}, wall "
        f"{wall_c:.1f}s"))


# ------------------------------------------------------------ merge kernels

def merge_bound_ms(n: int, d: int, k: int, scaled: bool) -> tuple[float, str]:
    """Least time for one merge of ``n`` rows of which ``k`` are selected:
    own read and out written on every row, s (1 byte) read on every row,
    peer, w (4 bytes) and, scaled, the scale (4) only on the selected rows;
    3 float32 operations per selected element (a multiply and an FMA), 4
    when scaled, and 1 - w once per selected row."""
    nbytes = 2 * n * d * 4 + k * d * 4 + n + k * (8 if scaled else 4)
    flops = (4 if scaled else 3) * k * d + k
    return roofline_ms(nbytes, flops)


def merge_case(gen, n: int, d: int, s_kind: str, w_kind: str):
    """Merge inputs on the card: ``own``, ``peer`` (NaN and inf in some
    unselected rows), ``w``, ``scale`` (1 on half the rows) and ``s``."""
    def rand(*shape):
        return torch.rand(shape, device="cuda", generator=gen)

    own = torch.randn((n, d), device="cuda", generator=gen)
    peer = 3 * torch.randn((n, d), device="cuda", generator=gen)
    s = {"all": torch.ones(n, dtype=torch.bool, device="cuda"),
         "none": torch.zeros(n, dtype=torch.bool, device="cuda"),
         "mixed": rand(n) < 0.6}[s_kind]
    w = {"zero": torch.zeros(n, device="cuda"),
         "one": torch.ones(n, device="cuda"), "random": rand(n)}[w_kind]
    scale = torch.where(rand(n) < 0.5, 1.0, 0.01 + 0.99 * rand(n))
    bad = ~s & (rand(n) < 0.5)
    peer[bad] = torch.where(rand(int(bad.sum()), 1) < 0.5, float("nan"),
                            float("inf")).expand(-1, d)
    return own, peer, w, scale, s


def merge_err(got, want) -> float:
    """Max abs difference of two merge outputs; raises unless they are
    equal bit for bit."""
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("kernel != plain")
    diff = torch.where(got == want, 0.0, (got - want).abs())
    return float(diff.max()) if got.numel() else 0.0


def check_merge_pair(args, label: str) -> float:
    """Both merge kernels (the scaled one in both orders) against their
    plain versions, bit for bit; returns the largest abs difference."""
    own, peer, w, scale, s = args
    worst = 0.0
    for name, kern, plain, kargs, kw in (
            ("gossip_merge_rows", gm.gossip_merge_rows,
             gm.gossip_merge_rows_ref, (own, peer, w, s), {}),
            ("gossip_merge_rows_scaled", gm.gossip_merge_rows_scaled,
             gm.gossip_merge_rows_scaled_ref, (own, peer, w, scale, s), {}),
            ("gossip_merge_rows_scaled fold", gm.gossip_merge_rows_scaled,
             gm.gossip_merge_rows_scaled_ref, (own, peer, w, scale, s),
             dict(fold=True))):
        got, want = kern(*kargs, **kw), plain(*kargs, **kw)
        torch.cuda.synchronize()
        try:
            worst = max(worst, merge_err(got, want))
        except AssertionError:
            raise AssertionError(f"{name} != plain at {label}") from None
        if not torch.equal(got[~s].view(torch.int32),
                           own[~s].view(torch.int32)):
            raise AssertionError(f"{name}: unselected rows changed at {label}")
    return worst


def check_merge_cases(floor_ms: float) -> float:
    gen = torch.Generator("cuda").manual_seed(13)
    count, worst = 0, 0.0
    for n in (1, 7, 200, 4097):
        for d in (1, 34, 306, 1000):
            for s_kind in ("all", "none", "mixed"):
                for w_kind in ("zero", "one", "random"):
                    args = merge_case(gen, n, d, s_kind, w_kind)
                    worst = max(worst, check_merge_pair(
                        args, f"N={n} D={d} s={s_kind} w={w_kind}"))
                    count += 1
    phase("merge-kernel", f"{count} cases x 2 kernels (the scaled one with "
                          f"and without fold) bit for bit (N up to 4097, D "
                          f"up to 1000, NaN/inf in unselected peer rows, "
                          f"scale 1 and < 1); max_abs_err={worst} "
                          f"launch_floor_us={1e3 * floor_ms:.3f}")
    return worst


class Recorder:
    """Wraps a kernel wrapper where ``module`` (a layer on the main path)
    calls it and keeps the inputs of its last ``keep`` calls (the run's own
    inputs); the wrapped kernel still launches and counts."""

    def __init__(self, name: str, keep: int = 64, module=learning):
        self.name, self.keep, self.calls = name, keep, []
        self.module = module
        self.fn = getattr(module, name)

    def __call__(self, *args, **kw):
        self.calls = (self.calls + [(args, kw)])[-self.keep:]
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def time_merge(kern, plain, library, args, kw) -> dict:
    """Device times (CUDA graph) of the kernel, its plain version and the
    nearest library composition on one set of merge inputs."""
    return dict(ms=device_ms(lambda: kern(*args, **kw)),
                plain_ms=device_ms(lambda: plain(*args, **kw)),
                library_ms=device_ms(lambda: library(*args)),
                call_ms=call_ms(lambda: kern(*args, **kw)))


def lerp_rows(own, peer, w, s):
    """The nearest PyTorch composition: ``where(s, lerp(peer, own, w), own)``
    (two calls; no one library call merges rows under a mask)."""
    return torch.where(s[:, None], torch.lerp(peer, own, w[:, None]), own)


def lerp_rows_scaled(own, peer, w, scale, s):
    return torch.where(s[:, None],
                       torch.lerp(scale[:, None] * peer, own, w[:, None]), own)


def held_to_plain(rec: Recorder, kern, plain) -> tuple[int, float]:
    """The kernel against its plain version on every recorded call, bit for
    bit: ``(selected rows, max abs difference)``. Checks only: the side
    process times nothing."""
    rows, worst = 0, 0.0
    for args, kw in rec.calls:
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        try:
            worst = max(worst, merge_err(got, want))
        except AssertionError:
            raise AssertionError(
                f"{rec.name} != plain on the run's inputs") from None
        rows += int(args[-1].sum())
    if rows == 0:
        raise AssertionError(f"{rec.name}: the recorded calls merged no row")
    return rows, worst


def held_on_run_inputs(rec: Recorder, kern, plain, library,
                       bound_fn) -> dict:
    """The kernel against its plain version on every recorded call of a
    run, bit for bit; then the kernel, its plain version and the library
    composition timed on the busiest call (B = 1 -> (N, ...)), beside the
    bound for that call's selected rows."""
    rows, worst = held_to_plain(rec, kern, plain)
    args, kw = max(rec.calls, key=lambda c: int(c[0][-1].sum()))
    flat = tuple(a[0].contiguous() for a in args)
    n, d = flat[0].shape
    k = int(flat[-1].sum())
    bound_ms, bound_by = bound_fn(n, d, k)
    return dict(calls=len(rec.calls), rows=rows, n=n, k=k, max_abs_err=worst,
                bound_ms=bound_ms, bound_by=bound_by,
                **time_merge(kern, plain, library, flat, kw))


def reset_counts() -> None:
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    fa.flash_attention.forms.clear()
    ks.ssd_scan.forms.clear()


def attention_forms(what: str, want: dict) -> None:
    """``flash_attention``'s launches by form since the last reset must be
    ``want``."""
    if fa.flash_attention.forms != want:
        raise AssertionError(f"{what}: flash_attention forms "
                             f"{fa.flash_attention.forms}, want {want}")


def ssd_forms(what: str, want: dict) -> None:
    """``ssd_scan``'s launches by form since the last reset must be
    ``want``."""
    if ks.ssd_scan.forms != want:
        raise AssertionError(f"{what}: ssd_scan forms {ks.ssd_scan.forms}, "
                             f"want {want}")


def ssd_form(dtype) -> str:
    """The form an ``ssd_scan`` call must take: ``mma`` in bfloat16,
    ``simt`` in float32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def per_run(per_slot: dict, n_slots: int) -> dict:
    return {k: v * n_slots for k, v in per_slot.items()}


def slots_run(cfg: SimConfig) -> int:
    """The slots a run steps: whole samples of ``cfg.sample_every``."""
    return cfg.n_slots // cfg.sample_every * cfg.sample_every


def close(a, b, rtol: float, atol: float, what: str = "") -> float:
    """Max abs difference; raises if ``a`` and ``b`` differ beyond
    ``atol + rtol * |b|`` or in shape. Tensors are compared on the host, in
    float32."""
    a, b = (x.float().cpu().numpy() if torch.is_tensor(x) else x
            for x in (a, b))
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        raise AssertionError(f"{what}: shape {a.shape} vs {b.shape} or "
                             f"non-finite")
    if not np.all(np.abs(a - b) <= atol + rtol * np.abs(b)):
        raise AssertionError(f"{what}: beyond rtol={rtol} atol={atol}")
    return float(np.abs(a.astype(np.float64) - b).max())


def learn_replay(refs: dict, kind: str, seed: int = 0) -> None:
    p, cfg, task = replay_case(kind)
    lc, n_slots = cfg.learn, cfg.n_slots
    cpu, track, t_cpu = refs[kind].result()
    replay = dataclasses.replace(cfg, mobility="replay")
    reset_counts()
    t = time.perf_counter()
    gpu = simulate(p, replay, seed=seed, device="cuda", positions=track,
                   task=task)
    t_gpu = time.perf_counter() - t
    launches = counts()
    if launches != per_run(dict(DENSE_ONLY, gossip_merge_rows=1), n_slots):
        raise AssertionError(f"learn-replay launches {launches}")
    off = simulate(p, dataclasses.replace(replay, learn=None), seed=seed,
                   device="cuda", positions=track)
    same_traces(cpu, gpu, "learning run on the card != on the CPU",
                TRACES + ("merge_stats",))
    same_traces(gpu, off, "learning run != learn=None run")
    errs = {k: close(getattr(gpu, k), getattr(cpu, k), *LEARN_TOL[k])
            for k in LEARN_TOL}
    phase("learn-replay", (
        f"{lc.model} D={lc.param_dim} N=200 {n_slots} slots: protocol traces and merge_stats bit for "
        f"bit (card vs CPU, learning vs learn=None); learning traces "
        f"max abs diff {errs} within (rtol, atol) {LEARN_TOL}; "
        f"launches={launches}; cpu {t_cpu:.1f}s, gpu {t_gpu:.1f}s"))


def learn_run(seed: int = 0, n_slots: int = 1000) -> dict:
    """The learning point at full width, free on the card: the merge
    kernel's main path. 1000 slots: the accuracy check holds on the CPU
    from 1000 slots on (scripts/learn_rise.py)."""
    p = paper_params(**LEARN_PARAMS)
    cfg = SimConfig(n_slots=n_slots, learn=logreg_task())
    with Recorder("gossip_merge_rows") as rec:
        reset_counts()
        t = time.perf_counter()
        out = simulate(p, cfg, seed=seed)             # default device: cuda
        wall = time.perf_counter() - t
        launches = counts()
    if launches != per_run(dict(DENSE_ONLY, gossip_merge_rows=1),
                           cfg.n_slots):
        raise AssertionError(f"learn-run launches {launches}")
    s = cfg.n_slots // cfg.sample_every
    for k in ("test_acc", "test_acc_holders", "learn_obs", "theta_var"):
        arr = getattr(out, k)
        if arr.shape != (s,) or not np.all(np.isfinite(arr)):
            raise AssertionError(f"learn-run: {k} {arr.shape} not finite")
    early, late = float(out.test_acc[:3].mean()), float(out.test_acc[-3:].mean())
    holders = float(out.test_acc_holders[-3:].mean())
    if not late > early + 0.05:
        raise AssertionError(f"learn-run: accuracy {early} -> {late}")
    if not holders >= late - 1e-6:
        raise AssertionError(f"learn-run: holders {holders} < {late}")
    merged = held_on_run_inputs(
        rec, gm.gossip_merge_rows, gm.gossip_merge_rows_ref, lerp_rows,
        lambda n, d, sel: merge_bound_ms(n, d, sel, scaled=False))
    d = cfg.learn.param_dim
    ms = out.merge_stats[-1]
    phase("learn-run", (
        f"N={cfg.n_nodes} D={d} slots={cfg.n_slots} wall={wall:.3f}s "
        f"slots/s={cfg.n_slots / wall:.1f} launches={launches} "
        f"test_acc {early:.6f} -> {late:.6f} holders {holders:.6f} "
        f"learn_obs={float(out.learn_obs[-1]):.3f} "
        f"theta_var={float(out.theta_var[-1]):.6g} merge_stats={ms.tolist()} "
        f"{merge_line(merged)}"))
    profile_slots("learn", p, cfg)
    return dict(launches=launches["gossip_merge_rows"], **merged)


def merge_line(k: dict) -> str:
    return (f"kernel==plain on the run's last {k['calls']} merges "
            f"({k['rows']} rows, max_abs_err={k['max_abs_err']}); timed on "
            f"the busiest ({k['k']} of {k['n']} rows selected): "
            f"kernel_us={1e3 * k['ms']:.3f} "
            f"bound_us={1e3 * k['bound_ms']:.5f} ({k['bound_by']}) "
            f"plain_us={1e3 * k['plain_ms']:.3f} "
            f"library_us={1e3 * k['library_ms']:.3f} "
            f"kernel_call_us={1e3 * k['call_ms']:.3f}")


def defended_run(seed: int = 0, n_slots: int = 496) -> dict:
    """A norm-clipped learning run on the card: the scaled merge's path."""
    p = paper_params(**LEARN_PARAMS)
    lc = dataclasses.replace(logreg_task(),
                             defense=DefenseConfig(norm_clip=0.5))
    cfg = SimConfig(n_slots=n_slots, learn=lc)
    with Recorder("gossip_merge_rows_scaled") as rec:
        reset_counts()
        t = time.perf_counter()
        out = simulate(p, cfg, seed=seed)
        wall = time.perf_counter() - t
        launches = counts()
    if launches != per_run(dict(DENSE_ONLY, gossip_merge_rows_scaled=1),
                           n_slots):
        raise AssertionError(f"defended run launches {launches}")
    ms = out.merge_stats[-1]
    if ms[learning.MS_NORMCLIP] <= 0 or not np.all(np.isfinite(out.test_acc)):
        raise AssertionError(f"defended run: merge_stats {ms.tolist()}")
    merged = held_on_run_inputs(
        rec, gm.gossip_merge_rows_scaled, gm.gossip_merge_rows_scaled_ref,
        lerp_rows_scaled,
        lambda n, d, sel: merge_bound_ms(n, d, sel, scaled=True))
    phase("defended-run", (
        f"norm_clip=0.5 N={cfg.n_nodes} slots={n_slots} wall={wall:.3f}s "
        f"slots/s={n_slots / wall:.1f} launches={launches} "
        f"merge_stats={ms.tolist()} test_acc {float(out.test_acc[0]):.6f} -> "
        f"{float(out.test_acc[-1]):.6f} {merge_line(merged)}"))
    return dict(launches=launches["gossip_merge_rows_scaled"], **merged)


# --------------------------------------------------------- cell-list kernel

def cell_bound_ms(b: int, n_pad: int, cap: int,
                  n_cells: int) -> tuple[float, str]:
    """Least time for one 3×3-cell pass: each of the four planes (x, y,
    zone word, id; 4 bytes a slot) read once, each word written once, and 5
    float32 operations per (row slot, candidate) pair (2 subtractions, a
    multiply, an FMA)."""
    nwords = (9 * cap + 31) // 32
    nbytes = 4 * 4 * b * n_pad * cap + 4 * b * n_cells * cap * nwords
    flops = 5 * b * n_cells * cap * 9 * cap
    return roofline_ms(nbytes, flops)


def cell_case(rng, b: int, ncx: int, cap: int, zone_bits: int,
              r_tx: float = 5.0):
    """Cell planes on the card, ``(B, (ncx + 2)², cap)``, border ring
    empty: each interior cell empty, full or part full; nodes uniform in
    their cell (side r_tx), zone words with up to ``zone_bits`` bits; in a
    fifth of the cells slot 1 sits at r_tx from slot 0 along x (one ulp
    inside, on it, or one ulp outside) and in another fifth at r_tx in a
    random direction."""
    s = ncx + 2
    n_pad = s * s
    kind = rng.integers(0, 3, (b, n_pad))
    occ = np.where(kind == 0, 0, np.where(kind == 1, cap,
                                          rng.integers(0, cap + 1, (b, n_pad))))
    px, py = np.arange(n_pad) // s, np.arange(n_pad) % s
    occ[:, (px == 0) | (px == s - 1) | (py == 0) | (py == s - 1)] = 0
    full = np.arange(cap) < occ[..., None]
    x = ((px - 1)[:, None] + rng.random((b, n_pad, cap))) * r_tx
    y = ((py - 1)[:, None] + rng.random((b, n_pad, cap))) * r_tx
    x, y = x.astype(np.float32), y.astype(np.float32)
    if cap >= 2:
        r = np.float32(r_tx)
        d = np.array([np.nextafter(r, np.float32(0)), r,
                      np.nextafter(r, np.float32(2 * r_tx))], np.float32)
        pick = rng.random((b, n_pad))
        axis = pick < 0.2
        x[..., 1] = np.where(axis, x[..., 0] + d[rng.integers(0, 3, (b, n_pad))],
                             x[..., 1])
        y[..., 1] = np.where(axis, y[..., 0], y[..., 1])
        ring = (pick >= 0.2) & (pick < 0.4)
        th = rng.uniform(0, 2 * np.pi, (b, n_pad))
        x[..., 1] = np.where(ring, x[..., 0] + (r * np.cos(th)).astype(np.float32),
                             x[..., 1])
        y[..., 1] = np.where(ring, y[..., 0] + (r * np.sin(th)).astype(np.float32),
                             y[..., 1])
    ids = np.cumsum(full.reshape(b, -1), axis=1).reshape(full.shape) - 1
    zone = zone_draw(rng, (b, n_pad, cap), zone_bits)
    planes = (np.where(full, x, np.float32(1e9)).astype(np.float32),
              np.where(full, y, np.float32(1e9)).astype(np.float32),
              np.where(full, ids, -1).astype(np.int32))
    xc, yc, idc = (torch.from_numpy(a).cuda() for a in planes)
    zc = torch.where(torch.from_numpy(full), zone, 0).cuda()
    return [xc, yc, zc, idc]


def check_cell_cases() -> int:
    """The cell kernel against its plain version, bit for bit, over cap x
    grid x batch (pairs up to 2·10⁸ per case)."""
    rng = np.random.default_rng(14)
    r_tx2 = 25.0
    worst, count = 0, 0
    # the last three: words over all 32 bits (bit 31 the int32 sign bit)
    grid = [(cap, ncx, b, 1 + i % 5) for i, (cap, ncx, b) in enumerate(
        (cap, ncx, b) for cap in (1, 4, 9, 32, 40) for ncx in (1, 3, 17, 319)
        for b in (1, 2) if b * ncx * ncx * 9 * cap * cap <= 2e8)]
    grid += [(4, 17, 2, 32), (9, 319, 1, 32), (32, 3, 2, 32)]
    for cap, ncx, b, bits in grid:
        args = cell_case(rng, b, ncx, cap, bits)
        got = kc.cell_close_words(*args, ncx, ncx, r_tx2)
        want = kc.cell_close_words_ref(*args, ncx, ncx, r_tx2)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"cell kernel != plain at cap={cap} "
                                 f"ncx={ncx} B={b} zone bits {bits}")
        worst = max(worst, max_abs_err([got], [want]))
        count += 1
        del got, want, args
    torch.cuda.empty_cache()
    lists = check_batched_lists()
    phase("cell-kernel", f"{count} cases bit for bit (cap 1-40, ncx 1-319, "
                         f"B 1-2, empty and full cells, multi-bit zone words "
                         f"and 3 cases of words with bit 31 set, "
                         f"pairs an ulp either side of r_tx); "
                         f"max_abs_err={worst}; {lists}")
    return worst


def check_batched_lists(seed: int = 14) -> str:
    """``neighbor_lists`` at B = 2 on the card (the stage's own planes
    through the kernel) against each item's CPU run, bit for bit."""
    _, cfg = scaled_point(1024, 16)
    grid = sim_cells.make_grid(cfg)
    r_tx2 = float(np.float32(cfg.r_tx ** 2))
    gen = torch.Generator().manual_seed(seed)
    pos = torch.rand((2, cfg.n_nodes, 2), generator=gen) * cfg.area_side
    zw = torch.randint(0, 4, (2, cfg.n_nodes), generator=gen,
                       dtype=torch.int32)
    nbr, ovf = sim_cells.neighbor_lists(pos.cuda(), zw.cuda(), grid, r_tx2)
    for b in range(2):
        want, wovf = sim_cells.neighbor_lists(pos[b:b + 1], zw[b:b + 1],
                                              grid, r_tx2)
        if not (torch.equal(nbr[b].cpu(), want[0])
                and int(ovf[b]) == int(wovf[0])):
            raise AssertionError(f"neighbor_lists at B = 2 != item {b} on "
                                 f"the CPU")
    return (f"neighbor_lists at N={cfg.n_nodes} B=2 on the card == each "
            f"item on the CPU ({int((nbr >= 0).sum())} list entries)")


def cells_replay(refs: dict, seed: int = 0) -> None:
    """N = 1024 at the paper's density, on the cells backend: the CPU run,
    then the card replaying its positions; every trace equal bit for bit."""
    p, cfg, _ = replay_case("cells-replay")
    if sim_cells.contact_backend(cfg) != "cells":
        raise AssertionError("N = 1024 at the paper density is not on cells")
    cpu, track, t_cpu = refs["cells-replay"].result()
    reset_counts()
    t = time.perf_counter()
    gpu = simulate(p, dataclasses.replace(cfg, mobility="replay"), seed=seed,
                   device="cuda", positions=track)
    t_gpu = time.perf_counter() - t
    if counts() != per_run(CELLS_ONLY, slots_run(cfg)):
        raise AssertionError(f"cells-replay launches {counts()}")
    same_traces(cpu, gpu, "replayed cells run on the card != on the CPU",
                TRACES + ("nbr_overflow",))
    phase("cells-replay", (
        f"N=1024 {slots_run(cfg)} slots: every trace and nbr_overflow bit for bit "
        f"(max nbr_overflow {int(gpu.nbr_overflow.max())}); launches="
        f"{counts()}; cpu {t_cpu:.1f}s, gpu {t_gpu:.1f}s"))


def cells_vs_dense(seed: int = 0, n_slots: int = 256) -> None:
    """The N = 800 point on the card on both backends: equal bit for bit."""
    p, cfg = scaled_point(800, n_slots)
    runs, walls = {}, {}
    for backend, per_slot in (("cells", CELLS_ONLY), ("dense", DENSE_ONLY)):
        reset_counts()
        t = time.perf_counter()
        runs[backend] = simulate(p, dataclasses.replace(
            cfg, contact_backend=backend), seed=seed)
        walls[backend] = time.perf_counter() - t
        if counts() != per_run(per_slot, slots_run(cfg)):
            raise AssertionError(f"cells-vs-dense {backend}: {counts()}")
    if int(runs["cells"].nbr_overflow.max()) != 0:
        raise AssertionError("cells-vs-dense: the cells run overflowed")
    same_traces(runs["cells"], runs["dense"], "cells run != dense run")
    phase("cells-vs-dense", (
        f"N=800 {slots_run(cfg)} slots on the card: every trace bit for bit; "
        f"cells {walls['cells']:.1f}s, dense {walls['dense']:.1f}s; "
        f"busy={float(runs['cells'].busy_frac.mean()):.6f}"))


def cells_run(seed: int = 0, n_slots: int = 496) -> dict:
    """The N = 12800 point of the convergence figure, free on the card on
    the cells backend (``auto``); the cell kernel is then held against its
    plain version on the run's last-slot planes and both are timed. 496
    slots (1000 until the mobility phases: cut for time)."""
    p, cfg = scaled_point(12800, n_slots)
    grid = sim_cells.make_grid(cfg)
    with Recorder("cell_close_words", keep=1, module=sim_cells) as rec:
        return free_run("cells-12800", p, cfg, seed, CELLS_ONLY,
                        lambda: time_cell_kernel(*rec.calls[-1], grid),
                        tag="cells-run")


def time_cell_kernel(args, kw, grid) -> dict:
    """The cell kernel against its plain version, bit for bit, on one
    recorded call, then timed: the kernel in a CUDA graph, the plain version
    eagerly (its ``torch.nonzero`` waits for the device, which a graph
    cannot capture)."""
    def kernel():
        return kc.cell_close_words(*args, **kw)

    def plain():
        return kc.cell_close_words_ref(*args, **kw)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("cell kernel != plain on the run's last planes")
    b, n_pad, cap = args[0].shape
    bound_ms, bound_by = cell_bound_ms(b, n_pad, cap, grid.n_cells)
    return dict(on=f"the last slot's planes (grid {grid.ncx}x{grid.ncy}, "
                   f"cap {cap}, nbr_cap {grid.nbr_cap})",
                max_abs_err=max_abs_err([got], [want]), ms=device_ms(kernel),
                plain_ms=call_ms(plain, reps=20), call_ms=call_ms(kernel),
                bound_ms=bound_ms, bound_by=bound_by)


# -------------------------------------------------------------- the faults

#: The fault telemetry, held bit for bit wherever runs are compared.
FAULT_FIELDS = ("availability_c", "on_frac_c", "n_in_rz_c", "fault_events")
#: The Zipf spot check (tests/test_sim_faults.py:379-399): zipf_mix(3) at
#: the paper point, 4000 slots sampled every 8, seeds 0 and 1 as one B = 2
#: sweep, reduce="mean" over the second half; each class within 15% of the
#: class solver and in its order.
ZIPF_CFG = SimConfig(n_slots=4000, sample_every=8, faults=zipf_mix(n_classes=3))
ZIPF_SEEDS = (0, 1)
ZIPF_TOL = 0.15
#: The harsh() sweep of faults-replay: two rates x seeds 0 and 1 (B = 4).
FAULT_SWEEP_LAMS = (0.05, 0.2)


def switched_off(gen, zw):
    """Zone words with a random third of the nodes off (their words zero,
    as the engine folds accessibility in) and the ``on`` mask."""
    on = torch.rand(zw.shape, device=zw.device, generator=gen) >= 1.0 / 3.0
    return kc.apply_access(zw, on), on


def faults_kernel() -> int:
    """``pairwise_contacts`` and ``cell_close_words`` on the main path's
    inputs with a random third of the nodes switched off, against their
    plain versions bit for bit, at N = 200, N = 1024 and B = 16 (16 seeds
    at N = 200); an off node has no contact. The cell kernel runs inside
    ``neighbor_lists`` (its own planes, recorded), whose lists on the card
    equal the CPU's."""
    gen = torch.Generator("cuda").manual_seed(25)
    shapes = ((SimConfig(), 1), (scaled_point(1024, 16)[1], 1),
              (SimConfig(), 16))
    worst, off_count = 0, 0
    for cfg, b in shapes:
        items = [main_path_inputs(cfg, s) for s in range(b)]
        x, y, zw, elig, prevw = (torch.cat([a[i] for a, _ in items])
                                 for i in range(5))
        r_tx2 = items[0][1]
        zw, on = switched_off(gen, zw)
        args = (x, y, zw, elig & on, prevw)
        got = kc.pairwise_contacts(*args, r_tx2)
        want = kc.pairwise_contacts_ref(*args, r_tx2)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("closew", "best_j", "has")):
            if not torch.equal(g, w):
                raise AssertionError(f"faults-kernel: pairwise_contacts != "
                                     f"plain on {name} at B={b} N={cfg.n_nodes}")
        if got[0][~on].any() or got[2][~on].any():
            raise AssertionError("faults-kernel: an off node has a contact")
        worst = max(worst, max_abs_err(got, want))
        off_count += int((~on).sum())

        grid = sim_cells.make_grid(dataclasses.replace(
            cfg, contact_backend="cells"))
        pos = torch.stack([x, y], -1)
        with Recorder("cell_close_words", keep=1, module=sim_cells) as rec:
            nbr, ovf = sim_cells.neighbor_lists(pos, zw, grid, r_tx2, on)
        (cargs, ckw), = rec.calls
        cgot = kc.cell_close_words(*cargs, **ckw)
        cwant = kc.cell_close_words_ref(*cargs, **ckw)
        torch.cuda.synchronize()
        if not torch.equal(cgot, cwant):
            raise AssertionError(f"faults-kernel: cell_close_words != plain "
                                 f"at B={b} N={cfg.n_nodes}")
        worst = max(worst, max_abs_err([cgot], [cwant]))
        cpu_nbr, cpu_ovf = sim_cells.neighbor_lists(
            pos.cpu(), zw.cpu(), grid, r_tx2, on.cpu())
        if not (torch.equal(nbr.cpu(), cpu_nbr) and torch.equal(ovf.cpu(),
                                                                cpu_ovf)):
            raise AssertionError(f"faults-kernel: neighbor_lists on the card "
                                 f"!= CPU at B={b} N={cfg.n_nodes}")
        if (nbr[~on] >= 0).any():
            raise AssertionError("faults-kernel: an off node has neighbours")
    phase("faults-kernel", (
        f"a third of the nodes off (zone words zero): pairwise_contacts and "
        f"cell_close_words (inside neighbor_lists, which equal the CPU's) "
        f"== plain bit for bit at N=200, N=1024 and B=16 x N=200 "
        f"({off_count} nodes off in all, none with a contact); "
        f"max_abs_err={worst}"))
    return worst


def kernel_on_last(rec, cells_path: bool, what: str) -> int:
    """The path's contact kernel against its plain version on the last
    recorded inputs, bit for bit; returns the max abs difference."""
    (args, kw), = rec.calls
    if cells_path:
        got, want = ([kc.cell_close_words(*args, **kw)],
                     [kc.cell_close_words_ref(*args, **kw)])
    else:
        got = kc.pairwise_contacts(*args, **kw)
        want = kc.pairwise_contacts_ref(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{what}: kernel != plain on the last inputs")
    return max_abs_err(got, want)


def faults_replay(refs: dict, sweep_slots: int = 200) -> dict:
    """Card runs replaying the CPU's positions under ``harsh()``, bit for
    bit on every trace and fault field: dense N = 200 (304 slots) and the
    cells backend at N = 1024 (304 slots; the cell kernel also held to its
    plain version on the run's last planes); then a B = 4 ``harsh()``
    sweep whose rows (0, 0) and (1, 1) equal B = 1 card runs."""
    out, lines = {}, []
    for kind, per_slot in (("faults-dense", DENSE_ONLY),
                           ("faults-cells", CELLS_ONLY)):
        p, cfg, _ = replay_case(kind)
        cpu, track, t_cpu = refs[kind].result()
        module = sim_cells if per_slot is CELLS_ONLY else sim_contacts
        name = "cell_close_words" if per_slot is CELLS_ONLY \
            else "pairwise_contacts"
        with Recorder(name, keep=1, module=module) as rec:
            reset_counts()
            t = time.perf_counter()
            gpu = simulate(p, dataclasses.replace(cfg, mobility="replay"),
                           seed=0, positions=track)
            t_gpu = time.perf_counter() - t
            launches = counts()
        if launches != per_run(per_slot, slots_run(cfg)):
            raise AssertionError(f"{kind} launches {launches}")
        extra = ("nbr_overflow",) if per_slot is CELLS_ONLY else ()
        same_traces(cpu, gpu, f"{kind}: card != CPU",
                    TRACES + FAULT_FIELDS + extra)
        if not np.all(gpu.fault_events[-1] > 0):
            raise AssertionError(f"{kind}: events {gpu.fault_events[-1]}")
        out[kind] = dict(launches=launches[name], max_abs_err=kernel_on_last(
            rec, per_slot is CELLS_ONLY, kind))
        lines.append(
            f"{kind} N={cfg.n_nodes} {slots_run(cfg)} slots: every trace and "
            f"fault field bit for bit, fault_events {gpu.fault_events[-1].tolist()}"
            f" (abort, link, crash), {name} launches {launches[name]} and "
            f"== plain on the last inputs; cpu {t_cpu:.1f}s (worker), gpu "
            f"{t_gpu:.1f}s")

    ps = [paper_params(lam=lam, M=1) for lam in FAULT_SWEEP_LAMS]
    cfg = SimConfig(n_slots=sweep_slots, faults=harsh())
    reset_counts()
    t = time.perf_counter()
    batch = sweep.run(ps, cfg, SWEEP_SEEDS)
    wall = time.perf_counter() - t
    if counts() != per_run(DENSE_ONLY, slots_run(cfg)):
        raise AssertionError(f"faults-replay sweep launches {counts()}")
    out["sweep"] = dict(launches=counts()["pairwise_contacts"])
    for i, j in ((0, 0), (1, 1)):
        one = simulate(ps[i], cfg, seed=SWEEP_SEEDS[j])
        same_rows(batch, i, j, one, "faults-replay sweep",
                  SWEEP_TRACES + FAULT_FIELDS)
    b = len(ps) * len(SWEEP_SEEDS)
    lines.append(
        f"harsh() sweep lam {FAULT_SWEEP_LAMS} x seeds {SWEEP_SEEDS} (B={b}),"
        f" {slots_run(cfg)} slots: rows (0, 0) and (1, 1) equal B=1 card "
        f"runs bit for bit on every trace and fault field; launches "
        f"{out['sweep']['launches']}; sweep {wall:.1f}s")
    phase("faults-replay", "; ".join(lines))
    return out


#: The Byzantine telemetry, held bit for bit wherever runs are compared.
ATTACK_FIELDS = ("poisoned_frac", "poisoned_frac_c", "merge_stats")


class PoisonedMerges:
    """Wraps ``learning.merge_deliveries`` while a run goes: for each call
    (one merge kernel launch), the poisoned payloads it received, kept on
    the device; read once after the run."""

    def __init__(self):
        self.fn, self.poisoned = learning.merge_deliveries, []

    def __call__(self, *args, merge_stats, **kw):
        out = self.fn(*args, merge_stats=merge_stats, **kw)
        k = learning.MS_ATTEMPT_POISON
        self.poisoned.append(out["merge_stats"][..., k] - merge_stats[..., k])
        return out

    def __enter__(self):
        learning.merge_deliveries = self
        return self

    def __exit__(self, *exc):
        learning.merge_deliveries = self.fn

    def launches(self) -> int:
        """Calls that merged at least one poisoned payload in some row."""
        return int((torch.stack(self.poisoned).sum(-1) > 0).sum())


def attack_replay(refs: dict, sweep_slots: int = 160) -> dict:
    """The Byzantine path on the card. ``harsh_adversarial()`` with
    ``robust_defense()`` replaying the CPU's positions (N = 200, 304 slots):
    every protocol trace, fault field and the Byzantine telemetry bit for
    bit, the learning traces within ``LEARN_TOL``, the scaled merge (the
    norm clip) held to its plain version on the run's last merges. Then the
    undefended attack as a B = 2 sweep (seeds 0 and 1) whose rows equal
    B = 1 card runs, the row merge held to its plain version."""
    p, cfg, task = replay_case("attack")
    cpu, track, t_cpu = refs["attack"].result()
    n_slots = slots_run(cfg)
    with Recorder("gossip_merge_rows_scaled") as rec_s, \
            PoisonedMerges() as pm:
        reset_counts()
        t = time.perf_counter()
        gpu = simulate(p, dataclasses.replace(cfg, mobility="replay"),
                       seed=0, positions=track, task=task)
        t_gpu = time.perf_counter() - t
        launches = counts()
    if launches != per_run(dict(DENSE_ONLY, gossip_merge_rows_scaled=1),
                           n_slots):
        raise AssertionError(f"attack-replay launches {launches}")
    same_traces(cpu, gpu, "attack-replay: card != CPU",
                TRACES + FAULT_FIELDS + ATTACK_FIELDS)
    errs = {k: close(getattr(gpu, k), getattr(cpu, k), *LEARN_TOL[k],
                     f"attack-replay {k}") for k in LEARN_TOL}
    ms = gpu.merge_stats[-1]
    if ms[learning.MS_ATTEMPT_POISON] <= 0 or ms[learning.MS_NORMCLIP] <= 0:
        raise AssertionError(f"attack-replay: merge_stats {ms.tolist()}")
    rows_s, worst_s = held_to_plain(rec_s, gm.gossip_merge_rows_scaled,
                                    gm.gossip_merge_rows_scaled_ref)

    ps = [paper_params(**LEARN_PARAMS)]
    scfg = SimConfig(n_slots=sweep_slots, faults=harsh_adversarial(),
                     learn=logreg_task())
    with Recorder("gossip_merge_rows") as rec_r:
        reset_counts()
        t = time.perf_counter()
        batch = sweep.run(ps, scfg, SWEEP_SEEDS)
        wall = time.perf_counter() - t
        swept = counts()
    if swept != per_run(dict(DENSE_ONLY, gossip_merge_rows=1),
                        slots_run(scfg)):
        raise AssertionError(f"attack-replay sweep launches {swept}")
    rows_r, worst_r = held_to_plain(rec_r, gm.gossip_merge_rows,
                                    gm.gossip_merge_rows_ref)
    for j, seed in enumerate(SWEEP_SEEDS):
        one = simulate(ps[0], scfg, seed=seed)
        same_rows(batch, 0, j, one, "attack-replay sweep",
                  SWEEP_TRACES + FAULT_FIELDS + ATTACK_FIELDS)
        for k in LEARN_TOL:
            errs[k] = max(errs[k], close(
                getattr(batch.point(0, j), k), getattr(one, k),
                *LEARN_TOL[k], f"attack-replay sweep {k}"))
    at = slots_run(scfg) // cfg.sample_every - 1
    phase("attack-replay", (
        f"harsh_adversarial() + robust_defense() N=200 {n_slots} slots: "
        f"every trace, fault field, poisoned_frac, poisoned_frac_c and "
        f"merge_stats bit for bit (card vs CPU), learning traces max abs "
        f"diff {errs} within {LEARN_TOL}; launches={launches}; cpu "
        f"{t_cpu:.1f}s (worker), gpu {t_gpu:.1f}s"))
    phase("attack-replay", (
        f"gossip_merge_rows_scaled launches {launches['gossip_merge_rows_scaled']}"
        f", {pm.launches()} of them on poisoned payloads "
        f"({int(ms[learning.MS_ATTEMPT_POISON])} poisoned of "
        f"{int(ms[learning.MS_ATTEMPT])} merge attempts), == plain on the "
        f"last {len(rec_s.calls)} merges ({rows_s} rows, max_abs_err="
        f"{worst_s})"))
    phase("attack-replay", (
        f"norm clips {int(ms[learning.MS_NORMCLIP])}, distance rejections "
        f"{int(ms[learning.MS_DISTREJ])} ({int(ms[learning.MS_DISTREJ_POISON])}"
        f" of poisoned payloads)"))
    phase("attack-replay", (
        f"poisoned_frac with the defense {float(gpu.poisoned_frac[-1]):.6f} "
        f"at slot {n_slots} ({float(gpu.poisoned_frac[at]):.6f} at slot "
        f"{slots_run(scfg)}); without it {float(batch.poisoned_frac[0, 0, -1]):.6f}"
        f" / {float(batch.poisoned_frac[0, 1, -1]):.6f} at slot "
        f"{slots_run(scfg)} (seeds {SWEEP_SEEDS})"))
    phase("attack-replay", (
        f"undefended harsh_adversarial() sweep seeds {SWEEP_SEEDS} (B=2), "
        f"{slots_run(scfg)} slots: rows equal B=1 card runs bit for bit on "
        f"every trace, fault field and the Byzantine telemetry; "
        f"gossip_merge_rows launches {swept['gossip_merge_rows']}, == plain "
        f"on the last {len(rec_r.calls)} merges ({rows_r} rows, max_abs_err="
        f"{worst_r}); sweep {wall:.1f}s"))
    return dict(scaled_launches=launches["gossip_merge_rows_scaled"],
                rows_launches=swept["gossip_merge_rows"],
                max_abs_err=max(worst_s, worst_r))


def attack_profiles() -> None:
    """What the attack costs a slot: attack-replay's configuration free on
    the card, profiled, and the same with every class honest (the same
    protocol: classes, crashes and the defense, no poisoning)."""
    p, cfg, _ = replay_case("attack")
    profile_slots("attack", p, cfg)
    honest = dataclasses.replace(cfg.faults, classes=tuple(
        dataclasses.replace(c, adv_mode="none") for c in cfg.faults.classes))
    profile_slots("attack off", p, dataclasses.replace(cfg, faults=honest))


def class_solution(p, fc, device) -> tuple:
    """The class fixed point and its DDE on ``device`` (None: cuda),
    strict, with the wall seconds of each."""
    cm = paper_contact_model(device=device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cs = solve_fixed_point_classes(p, cm, faults=fc, strict=True)
    torch.cuda.synchronize()
    t_fp = time.perf_counter() - t
    t = time.perf_counter()
    dd = solve_observation_availability_classes(p, cs, strict=True)
    torch.cuda.synchronize()
    return cs, dd, t_fp, time.perf_counter() - t


def zipf_solution() -> dict:
    """The class solver and its DDE for the Zipf spot check, solved on the
    card (timed on a quiet card, before the side phases) and held to the
    CPU's."""
    fc = ZIPF_CFG.faults
    p = paper_params(**MF_POINT)
    cs, dd, t_fp, t_dde = class_solution(p, fc, None)
    cpu_cs, cpu_dd, _, _ = class_solution(p, fc, "cpu")
    if cs.a.device.type != "cuda" or dd.o.device.type != "cuda":
        raise AssertionError("faults-check: the class solver left the card")
    worst = 0.0
    for f in ("a", "a_serve", "b", "S", "T_S", "r", "d_M", "d_I"):
        got, want = getattr(cs, f).cpu(), getattr(cpu_cs, f)
        if not torch.allclose(got, want, rtol=MF_RTOL, atol=1e-30):
            raise AssertionError(f"faults-check: {f} card {got} vs cpu {want}")
        worst = max(worst, float(((got - want).abs() / want.abs()).max()))
    o_err = float((dd.o.cpu() - cpu_dd.o).abs().max())
    w_err = float((dd.weighted().o.cpu() - cpu_dd.weighted().o).abs().max())
    if max(o_err, w_err) > DDE_ATOL:
        raise AssertionError(f"faults-check: o(tau) differs by {o_err}")
    return dict(cs=cs, dd=dd, t_fp=t_fp, t_dde=t_dde, worst=worst,
                o_err=o_err)


def faults_check(sol: dict):
    """The Zipf spot check on the card (tests/test_sim_faults.py:379-399):
    zipf_mix(3) at the paper point as one B = 2 sweep (seeds 0, 1), 4000
    slots, reduce="mean" over the second half: each class's availability
    within 15% of the class solver's (``sol``, :func:`zipf_solution`) and
    in its order. Returns ``finish()``, the part that times, for a quiet
    card: the contact kernel held to its plain version on the sweep's last
    inputs and timed, and profiles of the faulted sweep and of the same
    sweep without faults (kernels and device time a slot)."""
    fc = ZIPF_CFG.faults
    p = paper_params(**MF_POINT)
    cs, dd, t_fp, t_dde, worst, o_err = (
        sol[k] for k in ("cs", "dd", "t_fp", "t_dde", "worst", "o_err"))
    with Recorder("pairwise_contacts", keep=1, module=sim_contacts) as rec:
        reset_counts()
        t = time.perf_counter()
        summ = sweep.run([p], ZIPF_CFG, ZIPF_SEEDS, reduce="mean",
                         warmup_frac=0.5)
        wall = time.perf_counter() - t
        launches = counts()
    if launches != per_run(DENSE_ONLY, slots_run(ZIPF_CFG)):
        raise AssertionError(f"faults-check launches {launches}")
    a_model = cs.a[:, 0].cpu().numpy()
    a_sim = summ.stats["availability_c"][0, :, 0, :].mean(axis=0)
    on_frac = summ.stats["on_frac_c"][0].mean(axis=0)
    events = summ.stats["fault_events"][0]
    rel = np.abs(a_sim - a_model) / a_model
    duty = [c.duty for c in fc.classes]
    line = (f"zipf_mix(3) at the paper point, B={len(ZIPF_SEEDS)} "
            f"(seeds {ZIPF_SEEDS}), {ZIPF_CFG.n_slots} slots, second half: "
            + "; ".join(f"class {c} (duty {duty[c]:.4f}): a sim={a_sim[c]:.6f} "
                        f"mf={a_model[c]:.6f} (rel {rel[c]:.4f}), on-fraction "
                        f"{on_frac[c]:.6f}" for c in range(len(duty)))
            + f"; fault_events {events.tolist()}; beside the side phases: "
            f"wall={wall:.3f}s "
            f"slots/s={ZIPF_CFG.n_slots / wall:.1f} run-slots/s="
            f"{len(ZIPF_SEEDS) * ZIPF_CFG.n_slots / wall:.1f} launches="
            f"{launches['pairwise_contacts']}; class solver card vs cpu "
            f"max_rel={worst:.3e}, o(tau) max_abs={o_err:.3e}; wall on the "
            f"card: fixed point {t_fp:.3f}s, dde {t_dde:.3f}s "
            f"({dd.o.shape[0]} lanes x {dd.o.shape[-1]} steps)")
    if not (np.array_equal(np.argsort(a_model), np.argsort(a_sim))
            and float(rel.max()) < ZIPF_TOL):
        raise AssertionError(f"faults-check: classes off the solver; {line}")
    if events.any() or not np.all(np.isfinite(a_sim)):
        raise AssertionError(f"faults-check: {line}")
    phase("faults-check", f"each class within {ZIPF_TOL:.0%} of the class "
                          f"solver, in its order; {line}")
    (args, _), = rec.calls

    def finish() -> dict:
        k = time_kernel_args(args, args[5], f"the Zipf sweep's last inputs "
                                            f"(B={len(ZIPF_SEEDS)})")
        phase("faults-check", (
            f"kernel==plain on {k['on']} (max_abs_err={k['max_abs_err']}) "
            f"kernel_us={1e3 * k['ms']:.3f} bound_us={1e3 * k['bound_ms']:.5f} "
            f"({k['bound_by']}) plain_us={1e3 * k['plain_ms']:.3f} "
            f"kernel_call_us={1e3 * k['call_ms']:.3f}"))
        for label, c in (("zipf sweep B=2", ZIPF_CFG),
                         ("the same sweep without faults",
                          dataclasses.replace(ZIPF_CFG, faults=None))):
            profile_slots(label, p, c, n_slots=32,
                          run=lambda short: sweep.run([p], short, ZIPF_SEEDS))
        return dict(launches=launches["pairwise_contacts"], **k)

    return finish


# -------------------------------------------- the contamination twin

#: ``benchmarks/fig_adversarial.py``'s learning-smoke geometry (``CFG_KW``):
#: dense contacts in a small arena, where the epidemic needs its 240 s.
ADV_CFG_KW = dict(n_nodes=48, area_side=100.0, rz_radius=50.0, n_slots=960,
                  sample_every=8, k_obs=32)
ADV_LAM, ADV_LAM_OBS = 0.05, 10.0
ADV_TOL = 0.15       # twin vs measured poisoned fraction (``TOL``)
ADV_TAIL = 20        # the tail window, in samples (``TAIL``)
ADV_IGNITE = 0.1     # tail fraction above which a seed ignited (``IGNITE``)
ADV_SEEDS = (0, 1)
#: The figure's signflip(0.1) arms; the twin is gated on the undefended and
#: trimmed ones. On the clipped arm the reference's own twin misses
#: (ROADMAP, "Defects of the reference that the port copies").
ADV_ARMS = {"undefended": None, "clipped": robust_defense(),
            "trimmed": trimmed_defense()}
ADV_GATED = ("undefended", "trimmed")
#: The reference's clipped-arm error at seeds 0-1 (``python -m
#: benchmarks.fig_adversarial --quick`` on the CPU).
ADV_CLIPPED_REF = 0.458
#: The contamination solvers on the card against the CPU on one class
#: solution: rel on x, abs on the transient's o.
CONTAM_XTOL, CONTAM_OTOL = 1e-5, 1e-6
#: The twin's prediction on the card against the CPU's (rel).
TWIN_RTOL = 1e-5


def smoke_params():
    """The mean-field twin of the learning-smoke geometry: the paper scenario
    re-scaled to the 48-node arena at its own density (RZ = the inscribed
    disc of radius ``area/2``, speed 1)."""
    density = ADV_CFG_KW["n_nodes"] / ADV_CFG_KW["area_side"] ** 2
    r_rz = ADV_CFG_KW["rz_radius"]
    return paper_params(lam=ADV_LAM, Lam=ADV_LAM_OBS, M=1).replace(
        N=density * math.pi * r_rz**2, alpha=2.0 * density * 1.0 * r_rz)


def _measured_eta(ms: np.ndarray) -> float:
    """Acceptance probability of poisoned payloads from the cumulative
    merge-screen counters (a seed-summed (R, 6) slice)."""
    attempts = float(ms[:, learning.MS_ATTEMPT_POISON].sum())
    rejected = float(ms[:, learning.MS_DISTREJ_POISON].sum())
    if attempts <= 0.0:
        return 1.0
    return max(0.0, 1.0 - rejected / attempts)


def _twin_prediction(p, cm, fc, *, eta: float, t, attempts_cum,
                     n_nodes: int) -> float:
    """The contamination twin's prediction of the tail-window holder-masked
    poisoned fraction from measured delivery telemetry, solved on ``cm``'s
    device. ``attempts_cum`` is the seed-mean cumulative merge-attempt
    counter sampled at times ``t``: its first delivery starts the twin's
    clock, and the slope of its second half is the per-node delivery rate.
    The transient runs from a clean start and is averaged, holder-
    conditioned, over the tail window the simulator reports."""
    att = np.asarray(attempts_cum, float)
    t = np.asarray(t, float)
    onset_i = int(np.argmax(att > 0.0))
    t_onset = float(t[onset_i]) if att[-1] > 0.0 else 0.0
    half = len(t) // 2
    dt_meas = float(t[-1] - t[half])
    m_meas = float(att[-1] - att[half]) / max(n_nodes * dt_meas, 1e-9)

    contam = solve_contamination_classes(p, cm, fc, eta_adv=eta,
                                         merge_rate=m_meas)
    horizon = float(t[-1]) - t_onset
    tr = solve_contamination_transient(contam, dt=0.5, t_max=horizon)
    xh = contam.holder_fraction(tr.o).cpu().numpy()       # (C, K, nt)
    f = contam.fracs.cpu().numpy()
    xh_pop = np.einsum("c,ck...->k...", f, xh)[0]          # (nt,)
    w0 = float(t[-ADV_TAIL]) - t_onset
    sel = tr.tau.cpu().numpy() >= w0
    return float(xh_pop[sel].mean())


def attack_row(defense, device=None, seeds=ADV_SEEDS) -> dict:
    """One ``signflip(0.1)`` row of benchmarks/fig_adversarial.py: a B =
    len(seeds) sweep at ``ADV_CFG_KW`` under ``defense`` (None: undefended),
    with the per-seed tail ``poisoned_frac`` and, over the seeds that
    ignited, the measured fraction, ``eta_adv`` and the seed-mean
    cumulative merge attempts the twin reads."""
    p, fc = smoke_params(), signflip(frac=0.1)
    cfg = SimConfig(learn=dataclasses.replace(logreg_task(), defense=defense),
                    faults=fc, **ADV_CFG_KW)
    t = time.perf_counter()
    out = sweep.run([p], cfg, seeds, device=device)
    wall = time.perf_counter() - t
    pf_seed = np.asarray(out.poisoned_frac)[0, :, -ADV_TAIL:].mean(axis=1)
    ign = pf_seed > ADV_IGNITE
    ms = np.asarray(out.merge_stats)[0, :, -1]               # (R, 6)
    row = dict(p=p, fc=fc, cfg=cfg, t=np.asarray(out.t), pf_seed=pf_seed,
               ign=ign, wall=wall, poisoned=None, eta=None, attempts_cum=None)
    if ign.any():
        row.update(
            poisoned=float(pf_seed[ign].mean()),
            eta=_measured_eta(ms[ign]) if defense is not None else 1.0,
            attempts_cum=np.asarray(out.merge_stats)[0, ign, :, 0].mean(0))
    return row


def row_twin(row: dict, cm) -> float:
    """``_twin_prediction`` of an ignited ``attack_row`` on ``cm``."""
    return _twin_prediction(row["p"], cm, row["fc"], eta=row["eta"],
                            t=row["t"], attempts_cum=row["attempts_cum"],
                            n_nodes=ADV_CFG_KW["n_nodes"])


def contamination_case(p, fc, device, **kw) -> tuple:
    """``solve_contamination_classes`` and its transient (dt 0.5) on
    ``device`` (None: cuda), with the wall seconds of each. The balance
    must converge and the trace be finite (the class solver under it need
    not reach the balance's tol 1e-6: at the learning point it stops at
    2e-6)."""
    cm = paper_contact_model(device=device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cs = solve_contamination_classes(p, cm, fc, **kw)
    if not bool(cs.converged):
        raise AssertionError(f"contam-twin: residual {float(cs.residual)}")
    torch.cuda.synchronize()
    t_cs = time.perf_counter() - t
    t = time.perf_counter()
    tr = solve_contamination_transient(cs, dt=0.5, strict=True)
    torch.cuda.synchronize()
    return cs, tr, t_cs, time.perf_counter() - t


def on_card(sol):
    """A solution record with its tensors moved to the card."""
    return dataclasses.replace(sol, **{
        f.name: getattr(sol, f.name).cuda() for f in dataclasses.fields(sol)
        if torch.is_tensor(getattr(sol, f.name))})


def contam_diff(cs, tr, cpu_cs, cpu_tr, o_tol: float, what: str) -> tuple:
    """``(x rel, o abs)`` card vs CPU; raises beyond ``CONTAM_XTOL`` and
    ``o_tol``, or if a result left the card."""
    if {cs.x.device.type, tr.o.device.type, cs.x_holders.device.type} \
            != {"cuda"}:
        raise AssertionError(f"contam-twin: {what}: a solver left the card")
    x_err = float(((cs.x.cpu() - cpu_cs.x).abs() / cpu_cs.x.abs()).max())
    o_err = float((tr.o.cpu() - cpu_tr.o).abs().max())
    if x_err > CONTAM_XTOL or o_err > o_tol or tr.o.shape != cpu_tr.o.shape:
        raise AssertionError(
            f"contam-twin: {what} card vs cpu x rel {x_err}, o abs {o_err}, "
            f"shapes {tuple(tr.o.shape)} {tuple(cpu_tr.o.shape)}")
    return x_err, o_err


def contamination_solvers(m_meas: float) -> str:
    """The contamination solvers on the card against the CPU's. Cases:
    signflip(0.1) and harsh_adversarial() at the learning point, and
    signflip(0.1) at the smoke point with eta_adv 0.5 and the measured
    merge rate ``m_meas``; each with its transient. On the CPU's class
    solution, carried to the card: x within ``CONTAM_XTOL`` (rel), o within
    ``CONTAM_OTOL`` (abs). End to end, on the card's own class solution
    (which departs from the CPU's by float32 rounding, and the epidemic's
    rise amplifies that in o): x within ``CONTAM_XTOL``, o within
    ``DDE_ATOL``, as the class DDE is held in faults-check."""
    lines = []
    cm = paper_contact_model()
    for label, p, fc, kw in (
            ("signflip(0.1)", paper_params(**LEARN_PARAMS), signflip(frac=0.1),
             {}),
            ("harsh_adversarial()", paper_params(**LEARN_PARAMS),
             harsh_adversarial(), {}),
            (f"signflip(0.1) eta_adv 0.5 merge_rate {m_meas:.6g}",
             smoke_params(), signflip(frac=0.1),
             dict(eta_adv=0.5, merge_rate=m_meas))):
        cs, tr, t_cs, t_tr = contamination_case(p, fc, None, **kw)
        cpu_cs, cpu_tr, _, _ = contamination_case(p, fc, "cpu", **kw)
        whole = contam_diff(cs, tr, cpu_cs, cpu_tr, DDE_ATOL,
                            f"{label} end to end")
        torch.cuda.synchronize()
        t = time.perf_counter()
        cc = solve_contamination_classes(p, cm, fc, csol=on_card(cpu_cs.csol),
                                         **kw)
        torch.cuda.synchronize()
        t_cc = time.perf_counter() - t
        ctr = solve_contamination_transient(cc, dt=0.5, strict=True)
        same = contam_diff(cc, ctr, cpu_cs, cpu_tr, CONTAM_OTOL,
                           f"{label} on the CPU's class solution")
        lines.append(
            f"{label}: x={[round(float(v), 6) for v in cs.x[:, 0]]} "
            f"x_pop_holders={float(cs.x_pop_holders):.6f}, "
            f"{tr.o.shape[-1]} samples; card vs cpu on the cpu's class "
            f"solution x rel {same[0]:.3e}, o abs {same[1]:.3e}; end to end "
            f"x rel {whole[0]:.3e}, o abs {whole[1]:.3e}; wall on the card: "
            f"steady {t_cs:.3f}s with the class solver, {t_cc:.3f}s "
            f"without, transient {t_tr:.3f}s")
    return "; ".join(lines)


def contam_twin(start: float) -> dict:
    """The contamination twin on the card, in a process of its own
    (spawned beside ``side_phases``; it checks and times nothing else):
    benchmarks/fig_adversarial.py's signflip(0.1) rows uncut, each a B = 2
    sweep (seeds 0, 1) at ``ADV_CFG_KW``, the twin predicted on the card and
    on the CPU from the same telemetry, the undefended and trimmed rows
    gated at ``ADV_TOL``; the row merges held to their plain versions on
    each run's last merges; then the solvers on the card against the
    CPU's. Returns the merges' launches and differences for the kernel
    record."""
    global _START
    _START = start
    torch.set_num_threads(2)
    cm_gpu, cm_cpu = paper_contact_model(), paper_contact_model(device="cpu")
    launches = dict(gossip_merge_rows=0, gossip_merge_rows_scaled=0)
    worst, errs, m_meas = 0.0, {}, None
    for arm, defense in ADV_ARMS.items():
        name = "gossip_merge_rows" if arm != "clipped" else \
            "gossip_merge_rows_scaled"
        with Recorder(name) as rec:
            reset_counts()
            row = attack_row(defense)
            launched = counts()
        n_slots = slots_run(row["cfg"])
        if launched != per_run(dict(DENSE_ONLY, **{name: 1}), n_slots):
            raise AssertionError(f"contam-twin {arm} launches {launched}")
        launches[name] += launched[name]
        kern = getattr(gm, name)
        rows, err = held_to_plain(rec, kern, getattr(gm, name + "_ref"))
        worst = max(worst, err)
        line = (f"{arm}: signflip(0.1) N={ADV_CFG_KW['n_nodes']} B="
                f"{len(ADV_SEEDS)} {n_slots} slots, tail poisoned_frac per "
                f"seed {[round(float(v), 6) for v in row['pf_seed']]}, ignited "
                f"{int(row['ign'].sum())}/{len(ADV_SEEDS)}; slots/s="
                f"{n_slots / row['wall']:.1f}; {name} launches {launched[name]}"
                f", == plain on the last {len(rec.calls)} merges ({rows} rows,"
                f" max_abs_err={err})")
        if row["poisoned"] is None:
            if arm in ADV_GATED:
                raise AssertionError(f"contam-twin: no seed ignited; {line}")
            phase("contam-twin", line)
            continue
        t = time.perf_counter()
        x_gpu = row_twin(row, cm_gpu)
        torch.cuda.synchronize()
        t_twin = time.perf_counter() - t
        x_cpu = row_twin(row, cm_cpu)
        if abs(x_gpu - x_cpu) > TWIN_RTOL * abs(x_cpu):
            raise AssertionError(
                f"contam-twin: {arm} twin card {x_gpu} vs cpu {x_cpu}")
        errs[arm] = abs(x_gpu - row["poisoned"]) / max(abs(row["poisoned"]),
                                                       1e-12)
        line += (f"; measured {row['poisoned']:.6f}, eta_adv "
                 f"{row['eta']:.6f}; twin {x_gpu:.6f} (card, {t_twin:.3f}s) "
                 f"/ {x_cpu:.6f} (cpu); rel err {errs[arm]:.4f}")
        if arm in ADV_GATED:
            if errs[arm] > ADV_TOL:
                raise AssertionError(f"contam-twin: twin off; {line}")
            line += f" <= {ADV_TOL}"
        else:
            line += (f" (not gated: the reference's own twin misses this arm, "
                     f"{ADV_CLIPPED_REF} at seeds 0-1)")
        phase("contam-twin", line)
        if arm == "undefended":
            att, tt = row["attempts_cum"], row["t"]
            half = len(tt) // 2
            m_meas = float(att[-1] - att[half]) / (
                ADV_CFG_KW["n_nodes"] * float(tt[-1] - tt[half]))
    phase("contam-twin", contamination_solvers(m_meas))
    torch.cuda.synchronize()
    return dict(launches=launches, max_abs_err=worst, errs=errs)


# ----------------------------------------------------------------- zones

def three_zones(side: float = 200.0) -> ZoneSet:
    """Three Replication Zones scaled to the area ``side`` (200 m: the
    paper's): two static ones that overlap and a small one, disjoint from
    both at t = 0, drifting at (2.6, 1.8) m/s and reflected off the walls."""
    s = side / 200.0
    return ZoneSet(centers=((60.0 * s, 100.0 * s), (110.0 * s, 100.0 * s),
                            (150.0 * s, 165.0 * s)),
                   radii=(45.0 * s, 40.0 * s, 22.0 * s),
                   drift=((0.0, 0.0), (0.0, 0.0), (2.6, 1.8)))


def grid_zones() -> ZoneSet:
    """32 discs on an 8 x 4 grid over the paper's area, neighbours in a
    row overlapping: zone 31 (bit 31, the int32 sign bit) is the top right
    disc, and a node there alone has the word -2**31."""
    return ZoneSet(centers=tuple((12.5 + 25.0 * (z % 8), 25.0 + 50.0 * (z // 8))
                                 for z in range(32)), radii=(14.0,) * 32)


#: benchmarks/fig_multizone.py's check: two overlapping zones of 60 m.
TWO_ZONES = ZoneSet(centers=((75.0, 100.0), (125.0, 100.0)), radii=(60.0, 60.0))
#: ... its quick form, uncut: 4000 slots sampled every 32, seeds 0 and 1
#: as one B = 2 sweep, the second half's mean a zone
ZCHECK_CFG = SimConfig(n_slots=4000, sample_every=32, zones=TWO_ZONES)
ZCHECK_SEEDS = (0, 1)
#: tests/test_sim_zones.py:392-395: 15% relative, a_mf >= a_sim - 0.05
ZCHECK_TOL, ZCHECK_SLACK = 0.15, 0.05
#: The multizone fixed point, card vs CPU (relative)
ZONE_RTOL = 1e-6
#: The zones replays: kind -> the kernel counts of a slot
ZONE_REPLAYS = {"zones-dense": DENSE_ONLY, "zones-cells": CELLS_ONLY,
                "zones-32": DENSE_ONLY,
                "zones-learn": dict(DENSE_ONLY, gossip_merge_rows=1)}
SIGN_BIT = -2 ** 31


def zones_replay(refs: dict, sweep_slots: int = 160) -> dict:
    """Card runs replaying the CPU's positions with several Replication
    Zones, bit for bit on every trace, the per-zone ones included: (a)
    three zones, one drifting, dense N = 200, 304 slots; (b) the same
    layout scaled to the area on the cells backend, N = 1024, 160 slots;
    (c) 32 zones, nodes in zone 31 alone, 160 slots; (d) ``harsh()`` with
    logreg learning across two zones, 160 slots, every row merge held to
    its plain version; each run's contact kernel held to its plain version
    on the run's last inputs. Then (e) a B = 4 sweep over the three zones
    whose rows (0, 0) and (1, 1) equal B = 1 card runs."""
    out, lines = {}, []
    for kind, per_slot in ZONE_REPLAYS.items():
        p, cfg, task = replay_case(kind)
        cpu, track, t_cpu = refs[kind].result()
        cells_path = per_slot is CELLS_ONLY
        name = "cell_close_words" if cells_path else "pairwise_contacts"
        module = sim_cells if cells_path else sim_contacts
        with Recorder(name, keep=1, module=module) as rec, \
                Recorder("gossip_merge_rows") as rec_m:
            reset_counts()
            t = time.perf_counter()
            gpu = simulate(p, dataclasses.replace(cfg, mobility="replay"),
                           seed=0, positions=track, task=task)
            t_gpu = time.perf_counter() - t
            launches = counts()
        if launches != per_run(per_slot, slots_run(cfg)):
            raise AssertionError(f"{kind} launches {launches}")
        fields = TRACES + (("nbr_overflow",) if cells_path else ())
        if cfg.learn is not None:
            fields += FAULT_FIELDS + ("merge_stats",)
            for k in LEARN_TOL:
                close(getattr(gpu, k), getattr(cpu, k), *LEARN_TOL[k],
                      f"{kind} {k}")
        same_traces(cpu, gpu, f"{kind}: card != CPU", fields)
        k_zones = cfg.zones.k
        if gpu.n_in_rz_z.shape[-1] != k_zones or \
                not np.all(gpu.n_in_rz_z.max(axis=0) > 0):
            raise AssertionError(f"{kind}: zones {gpu.n_in_rz_z.max(axis=0)}")
        err = kernel_on_last(rec, cells_path, kind)
        line = (f"{kind} K={k_zones} N={cfg.n_nodes} {slots_run(cfg)} "
                f"slots: every trace bit for bit, final n_in_rz_z "
                f"{gpu.n_in_rz_z[-1].tolist()}, {name} launches "
                f"{launches[name]}, == plain on the last inputs")
        if kind == "zones-32":
            words = zone_words_of(track, cfg)
            alone = int((words == SIGN_BIT).sum())
            if alone == 0:
                raise AssertionError("zones-32: no node in zone 31 alone")
            line += (f", {alone} node-slots in zone 31 alone (word "
                     f"{SIGN_BIT}), max n_in_rz_z[31] "
                     f"{int(gpu.n_in_rz_z[:, 31].max())}")
        merged = 0
        if cfg.learn is not None:
            merged, m_err = held_to_plain(rec_m, gm.gossip_merge_rows,
                                          gm.gossip_merge_rows_ref)
            err = max(err, m_err)
            line += (f", gossip_merge_rows launches "
                     f"{launches['gossip_merge_rows']} == plain on the last "
                     f"{len(rec_m.calls)} merges ({merged} rows), "
                     f"fault_events {gpu.fault_events[-1].tolist()}")
        out[kind] = dict(launches=launches, max_abs_err=err)
        lines.append(line + f"; cpu {t_cpu:.1f}s (worker), gpu {t_gpu:.1f}s")

    ps = [paper_params(lam=lam, M=1) for lam in FAULT_SWEEP_LAMS]
    cfg = SimConfig(n_slots=sweep_slots, zones=three_zones())
    reset_counts()
    t = time.perf_counter()
    batch = sweep.run(ps, cfg, SWEEP_SEEDS)
    wall = time.perf_counter() - t
    if counts() != per_run(DENSE_ONLY, slots_run(cfg)):
        raise AssertionError(f"zones-replay sweep launches {counts()}")
    out["sweep"] = dict(launches=counts())
    for i, j in ((0, 0), (1, 1)):
        one = simulate(ps[i], cfg, seed=SWEEP_SEEDS[j])
        same_rows(batch, i, j, one, "zones-replay sweep", SWEEP_TRACES)
    lines.append(
        f"three-zone sweep lam {FAULT_SWEEP_LAMS} x seeds {SWEEP_SEEDS} "
        f"(B={len(ps) * len(SWEEP_SEEDS)}), {slots_run(cfg)} slots: rows "
        f"(0, 0) and (1, 1) equal B=1 card runs bit for bit on every trace; "
        f"launches {out['sweep']['launches']['pairwise_contacts']}; sweep "
        f"{wall:.1f}s")
    phase("zones-replay", "; ".join(lines))
    return out


def zone_words_of(track, cfg: SimConfig) -> torch.Tensor:
    """The zone words of every slot a run over static zones moved through
    (slots 1 on), as the engine computes them."""
    pos = torch.as_tensor(np.asarray(track[1:slots_run(cfg) + 1]),
                          dtype=torch.float32, device="cuda")
    return pack_mask(zone_member(pos, effective_zones(cfg)))[..., 0]


def multizone_pair(p, zs: ZoneSet) -> dict:
    """The multizone fixed point and its DDE on the card and on the CPU,
    with the card's wall times."""
    out = {}
    for dev in ("cuda", "cpu"):
        cm = paper_contact_model(device=dev)
        t = time.perf_counter()
        mz = solve_fixed_point_multizone(p, cm, zs, density=DENSITY,
                                         speed=SPEED_DEFAULT, strict=True)
        if dev == "cuda":
            torch.cuda.synchronize()
        t_fp = time.perf_counter() - t
        t = time.perf_counter()
        dde = solve_observation_availability_multizone(p, mz, strict=True)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = dict(mz=mz, dde=dde, t_fp=t_fp,
                        t_dde=time.perf_counter() - t)
    return out


def zones_check() -> dict:
    """benchmarks/fig_multizone.py's Monte-Carlo check (``_sim_check``,
    quick form, uncut) on the card: two overlapping zones at the paper
    point, one B = 2 sweep (seeds 0, 1) of 4000 slots, ``reduce="mean"``
    over the second half; each zone's seed-mean availability within 15% of
    ``solve_fixed_point_multizone`` on the card and ``a_mf >= a_sim -
    0.05``; the contact kernel held to its plain version on the sweep's
    last inputs. Then the multizone fixed point and DDE on the card
    against the CPU's."""
    p = paper_params(lam=0.05, M=1)
    both = multizone_pair(p, TWO_ZONES)
    card, cpu = both["cuda"], both["cpu"]
    a_mf = card["mz"].a.cpu().numpy()
    with Recorder("pairwise_contacts", keep=1, module=sim_contacts) as rec:
        reset_counts()
        t = time.perf_counter()
        summ = sweep.run([p], ZCHECK_CFG, ZCHECK_SEEDS, reduce="mean",
                         warmup_frac=0.5)
        wall = time.perf_counter() - t
        launches = counts()
    n_slots = slots_run(ZCHECK_CFG)
    if launches != per_run(DENSE_ONLY, n_slots):
        raise AssertionError(f"zones-check launches {launches}")
    err = kernel_on_last(rec, False, "zones-check")
    a_seed = np.asarray(summ.stats["availability_z"])[0]      # (R, M, K)
    a_sim = a_seed.mean(axis=(0, 1))
    errs = np.abs(a_mf - a_sim) / np.maximum(a_sim, 1e-9)
    b = len(ZCHECK_SEEDS)
    zones = "; ".join(
        f"zone {z}: sim {a_sim[z]:.6f} (seeds "
        f"{[round(float(v), 6) for v in a_seed[:, 0, z]]}) mf {a_mf[z]:.6f} "
        f"rel err {errs[z]:.4f}" for z in range(TWO_ZONES.k))
    line = (f"two zones of 60 m at (75, 100) and (125, 100), paper point, "
            f"B={b} N={ZCHECK_CFG.n_nodes} {n_slots} slots, second half: "
            f"{zones}; slots/s={n_slots / wall:.1f} run-slots/s="
            f"{b * n_slots / wall:.1f}; launches "
            f"{launches['pairwise_contacts']}, == plain on the last inputs")
    if np.any(errs >= ZCHECK_TOL) or np.any(a_mf < a_sim - ZCHECK_SLACK):
        raise AssertionError(f"zones-check: beyond {ZCHECK_TOL} or "
                             f"a_mf < a_sim - {ZCHECK_SLACK}; {line}")
    phase("zones-check", line + f" (within {ZCHECK_TOL}, a_mf >= a_sim - "
                                f"{ZCHECK_SLACK})")
    fields = ("a", "b", "S", "T_S", "r", "d_M", "d_I", "N_z", "alpha_z",
              "Lam_z", "R")
    a_rel = max(close(getattr(card["mz"], f), getattr(cpu["mz"], f),
                      ZONE_RTOL, 0.0, f"zones-check {f}") for f in fields)
    o_abs = close(card["dde"].o, cpu["dde"].o, 0.0, DDE_ATOL,
                  "zones-check o")
    phase("zones-check", (
        f"multizone solvers card vs cpu: fixed point max abs diff "
        f"{a_rel:.3e} (rtol {ZONE_RTOL}), o(tau) {tuple(card['dde'].o.shape)} "
        f"max abs diff {o_abs:.3e} (atol {DDE_ATOL}); wall on the card: "
        f"fixed point {card['t_fp']:.3f}s, dde {card['t_dde']:.3f}s; on the "
        f"cpu {cpu['t_fp']:.3f}s, {cpu['t_dde']:.3f}s"))
    return dict(launches=launches["pairwise_contacts"], max_abs_err=err)


def zone_profiles() -> None:
    """Kernels and device time a slot of zones-replay's three-zone run
    beside the paper point's (B = 1, 32 slots each)."""
    p = paper_params(lam=0.05, M=1)
    profile_slots("paper", p, SimConfig(n_slots=32), n_slots=32)
    profile_slots("zones-3", p, SimConfig(n_slots=32, zones=three_zones()),
                  n_slots=32)


def twin_phases(start: float) -> tuple:
    """The third process on the card: ``contam_twin``, ``zones_check``,
    then ``contact_rates`` (mobility-check's probes), whose CPU sides run
    meanwhile in a worker process of this one (spawned, one thread), then
    ``dispatch_check``, whose coordinator mostly waits on its two worker
    processes."""
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_rates = {label: pool.submit(probe_rate_cpu, label)
                     for label in MOB_EXACT}
        contam = contam_twin(start)
        zcheck = zones_check()
        rates = contact_rates(cpu_rates)
        return contam, zcheck, rates, dispatch_check()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


# ------------------------------------------------------------- mobility

#: tests/test_sim_mobility.py's contact-rate probes (N = 200): label ->
#: (model, SimConfig overrides, seed, slots, tolerance against the twin,
#: ``repro``'s rate on the CPU with JAX 0.9.0)
MOB_PROBES = {
    "rdm": ("rdm", {}, 0, 3000, 0.12, 0.061053),
    "rwp": ("rwp", {}, 0, 3000, 0.18, 0.082733),
    "manhattan": ("manhattan", {}, 0, 3000, 0.18, 0.089987),
    "rwp-pause60": ("rwp", dict(pause_s=60.0), 1, 4000, 0.2, 0.060900),
    "rdm-speed_range": ("rdm", dict(speed_range=(0.1, 1.9)), 0, 3000, 0.12,
                        0.071227),
}
#: The probes without a transcendental on their path: card == CPU exactly
MOB_EXACT = ("rwp", "manhattan", "rwp-pause60")
#: examples/simulate_vs_meanfield.py --fast at the paper point, one B = 2
#: sweep a model (seeds 0, 1), cut from 4000 slots to 2000 for time
#: (PERF.md §7), sampled every 16, second half; availability within 15%
#: of the fixed point on the twin and a_mf >= a_sim - 0.02
#: (tests/test_sim_vs_meanfield.py's availability thresholds)
MOB_CHECK_SLOTS = 2000
MOB_CHECK_SEEDS = (0, 1)
MOB_CHECK_TOL, MOB_CHECK_SLACK = 0.15, 0.02
#: ``repro``'s example at 4000 slots (CPU, JAX 0.9.0): a_sim, a_mf
MOB_CHECK_REF = {"rwp": (0.9515, 0.9640), "manhattan": (0.9286, 0.9637)}
#: The mobility replays: kind -> the kernel counts of a slot
MOB_REPLAYS = {"mob-rwp": DENSE_ONLY, "mob-manhattan": DENSE_ONLY,
               "mob-cells": CELLS_ONLY,
               "mob-learn": dict(DENSE_ONLY, gossip_merge_rows=1),
               "mob-speed_range": DENSE_ONLY}


def probe_config(label: str) -> tuple:
    """``(model, cfg, seed, slots)`` of a contact-rate probe."""
    name, kw, seed, slots, _, _ = MOB_PROBES[label]
    return name, SimConfig(n_nodes=200, **kw), seed, slots


def probe_twin(label: str, device=None):
    """The probe's analytic twin at the paper geometry (the reference test's
    ``GEOM``), with its pause or speed range."""
    name, kw, _, _, _, _ = MOB_PROBES[label]
    return contact_model_for(name, speed=SPEED_DEFAULT, r_tx=R_TX,
                             density=DENSITY, street_spacing=25.0,
                             area_side=AREA_SIDE, device=device, **kw)


def probe_rate_cpu(label: str) -> tuple:
    """A probe run by the port on the CPU, in a worker process: the rate
    and the wall seconds."""
    torch.set_num_threads(1)
    name, cfg, seed, slots = probe_config(label)
    t = time.perf_counter()
    rate = measure_contact_rate(seed, name=name, cfg=cfg, n_slots=slots,
                                device="cpu")
    return rate, time.perf_counter() - t


def mobility_replay(refs: dict, sweep_slots: int = 160) -> dict:
    """The other mobility models on the card against the CPU, bit for bit
    on every trace: (a) rwp with a 60 s pause, dense N = 200, 304 slots,
    free; (b) manhattan, dense N = 200, 304 slots, free; (c) manhattan on
    the cell lists, N = 1024 at the paper density, 160 slots, free,
    ``nbr_overflow`` 0; (d) manhattan with ``harsh()`` and logreg learning,
    N = 200, 160 slots, free: protocol traces, fault fields and
    ``merge_stats`` bit for bit, the learning traces within ``LEARN_TOL``,
    every row merge held to its plain version; (f) rdm with ``speed_range``
    (0.1, 1.9), replaying the CPU's positions (its init splits the key four
    ways), 304 slots. Each run's contact kernel held to its plain version
    on its last inputs. Then (e) a B = 4 rwp sweep whose rows (0, 0) and
    (1, 1) equal B = 1 card runs."""
    out, lines = {}, []
    for kind, per_slot in MOB_REPLAYS.items():
        p, cfg, task = replay_case(kind)
        cpu, track, t_cpu = refs[kind].result()
        cells_path = per_slot is CELLS_ONLY
        name = "cell_close_words" if cells_path else "pairwise_contacts"
        module = sim_cells if cells_path else sim_contacts
        replayed = kind == "mob-speed_range"
        with Recorder(name, keep=1, module=module) as rec, \
                Recorder("gossip_merge_rows") as rec_m:
            reset_counts()
            t = time.perf_counter()
            if replayed:
                gpu = simulate(p, dataclasses.replace(cfg, mobility="replay"),
                               seed=0, positions=track, task=task)
            else:
                gpu = simulate(p, cfg, seed=0, task=task)
            t_gpu = time.perf_counter() - t
            launches = counts()
        if launches != per_run(per_slot, slots_run(cfg)):
            raise AssertionError(f"{kind} launches {launches}")
        fields = TRACES + (("nbr_overflow",) if cells_path else ())
        if cfg.learn is not None:
            fields += FAULT_FIELDS + ("merge_stats",)
            for k in LEARN_TOL:
                close(getattr(gpu, k), getattr(cpu, k), *LEARN_TOL[k],
                      f"{kind} {k}")
        same_traces(cpu, gpu, f"{kind}: card != CPU", fields)
        if cells_path and int(gpu.nbr_overflow.max()) != 0:
            raise AssertionError(f"{kind}: nbr_overflow "
                                 f"{gpu.nbr_overflow.max()}")
        err = kernel_on_last(rec, cells_path, kind)
        line = (f"{kind} ({cfg.mobility if not replayed else 'rdm replayed'}"
                f") N={cfg.n_nodes} {slots_run(cfg)} slots "
                f"{'replayed' if replayed else 'free'}: every trace bit for "
                f"bit, mean n_in_rz {float(gpu.n_in_rz.mean()):.2f}, {name} "
                f"launches {launches[name]}, == plain on the last inputs")
        if cells_path:
            line += f", nbr_overflow {int(gpu.nbr_overflow.max())}"
        if cfg.learn is not None:
            merged, m_err = held_to_plain(rec_m, gm.gossip_merge_rows,
                                          gm.gossip_merge_rows_ref)
            err = max(err, m_err)
            line += (f", gossip_merge_rows launches "
                     f"{launches['gossip_merge_rows']} == plain on the last "
                     f"{len(rec_m.calls)} merges ({merged} rows), "
                     f"fault_events {gpu.fault_events[-1].tolist()}")
        out[kind] = dict(launches=launches, max_abs_err=err)
        lines.append(line + f"; cpu {t_cpu:.1f}s (worker), gpu {t_gpu:.1f}s")

    ps = [paper_params(lam=lam, M=1) for lam in FAULT_SWEEP_LAMS]
    cfg = SimConfig(n_slots=sweep_slots, mobility="rwp")
    with Recorder("pairwise_contacts", keep=1, module=sim_contacts) as rec:
        reset_counts()
        t = time.perf_counter()
        batch = sweep.run(ps, cfg, SWEEP_SEEDS)
        wall = time.perf_counter() - t
        launches = counts()
    if launches != per_run(DENSE_ONLY, slots_run(cfg)):
        raise AssertionError(f"mobility-replay sweep launches {launches}")
    err = kernel_on_last(rec, False, "mobility-replay sweep")
    out["sweep"] = dict(launches=launches, max_abs_err=err)
    for i, j in ((0, 0), (1, 1)):
        one = simulate(ps[i], cfg, seed=SWEEP_SEEDS[j])
        same_rows(batch, i, j, one, "mobility-replay sweep", SWEEP_TRACES)
    lines.append(
        f"rwp sweep lam {FAULT_SWEEP_LAMS} x seeds {SWEEP_SEEDS} "
        f"(B={len(ps) * len(SWEEP_SEEDS)}), {slots_run(cfg)} slots: rows "
        f"(0, 0) and (1, 1) equal B=1 card runs bit for bit on every trace; "
        f"launches {launches['pairwise_contacts']}, == plain on the last "
        f"inputs; sweep {wall:.1f}s")
    phase("mobility-replay", "; ".join(lines))
    return out


def contact_rates(cpu_rates: dict) -> dict:
    """The five probes on the card, through ``pairwise_contacts`` (one
    launch a slot and one for the initial words), each within its
    tolerance of its twin built on the card, the kernel held to its plain
    version on each probe's last inputs; the paused rwp more than 0.2
    from the no-pause twin, the ``speed_range`` rate nearer the corrected
    twin than the constant-speed one; rwp's and manhattan's rates equal
    the port's CPU runs bit for bit."""
    rates, launches, err, lines = {}, 0, 0, []
    for label, (_, _, _, _, tol, ref) in MOB_PROBES.items():
        name, cfg, seed, slots = probe_config(label)
        with Recorder("pairwise_contacts", keep=1, module=sim_mobility) as rec:
            reset_counts()
            t = time.perf_counter()
            rate = measure_contact_rate(seed, name=name, cfg=cfg,
                                        n_slots=slots)
            g_sim = float(rate)                       # synchronises
            wall = time.perf_counter() - t
            n = counts()["pairwise_contacts"]
        if n != slots + 1 or rate.device.type != "cuda":
            raise AssertionError(f"{label}: {n} launches for {slots} slots")
        err = max(err, kernel_on_last(rec, False, f"probe {label}"))
        launches += n
        g_twin = float(probe_twin(label, "cuda").g)
        rel = abs(g_sim - g_twin) / g_twin
        rates[label] = g_sim
        line = (f"{label}: g_sim {g_sim:.6f} (repro {ref:.6f}) twin "
                f"{g_twin:.6f} rel err {rel:.4f} (tol {tol}), {n} launches "
                f"for {slots} slots, {slots / wall:.0f} slots/s")
        if label in cpu_rates:
            cpu, t_cpu = cpu_rates[label].result()
            if not torch.equal(rate.cpu(), cpu):
                raise AssertionError(f"{label}: card {g_sim!r} != cpu "
                                     f"{float(cpu)!r}")
            line += f", == the CPU's bit for bit (cpu {t_cpu:.0f}s, worker)"
        if rel >= tol:
            raise AssertionError(f"mobility-check {line}")
        lines.append(line)
    g_nopause = float(probe_twin("rwp", "cuda").g)
    off = abs(rates["rwp-pause60"] - g_nopause) / g_nopause
    g_const = float(probe_twin("rdm", "cuda").g)
    g_corr = float(probe_twin("rdm-speed_range", "cuda").g)
    sr = rates["rdm-speed_range"]
    if off <= 0.2 or not abs(sr - g_corr) < abs(sr - g_const):
        raise AssertionError(f"mobility-check: paused rwp {off:.4f} from the "
                             f"no-pause twin; speed_range {sr} vs corrected "
                             f"{g_corr}, constant {g_const}")
    lines.append(f"paused rwp {off:.4f} from the no-pause twin (> 0.2); "
                 f"speed_range rate {abs(sr - g_corr):.6f} from the corrected "
                 f"twin, {abs(sr - g_const):.6f} from the constant-speed one")
    phase("mobility-check", "contact rates on the card: " + "; ".join(lines))
    return dict(launches=launches, max_abs_err=err)


def mobility_sweeps() -> dict:
    """examples/simulate_vs_meanfield.py --fast for rwp and manhattan: one
    B = 2 sweep a model (seeds 0, 1), the paper point, ``MOB_CHECK_SLOTS``
    slots sampled every 16, ``reduce="mean"`` over the second half,
    availability within 15% of ``solve_fixed_point`` on the model's twin
    (solved on the card) and ``a_mf >= a_sim - 0.02``; busy, nodes in the
    RZ and slots/s printed; the contact kernel held to its plain version on
    each sweep's last inputs. In the main process, after faults-check: it
    waits there for the other two processes anyway."""
    launches, err = 0, 0
    p = paper_params(lam=0.05, M=1)
    for mob in ("rwp", "manhattan"):
        cfg = SimConfig(n_slots=MOB_CHECK_SLOTS, sample_every=16,
                        mobility=mob)
        t = time.perf_counter()
        sol = solve_fixed_point(p, paper_contact_model(mobility=mob),
                                strict=True)
        a_mf, b_mf = float(sol.a), float(sol.b)
        t_fp = time.perf_counter() - t
        with Recorder("pairwise_contacts", keep=1,
                      module=sim_contacts) as rec:
            reset_counts()
            t = time.perf_counter()
            summ = sweep.run([p], cfg, MOB_CHECK_SEEDS, reduce="mean",
                             warmup_frac=0.5)
            wall = time.perf_counter() - t
            n = counts()
        n_slots = slots_run(cfg)
        if n != per_run(DENSE_ONLY, n_slots):
            raise AssertionError(f"mobility-check {mob} launches {n}")
        err = max(err, kernel_on_last(rec, False, f"mobility-check {mob}"))
        launches += n["pairwise_contacts"]
        st = {k: np.asarray(summ.stats[k])[0] for k in
              ("availability", "busy_frac", "n_in_rz")}
        a_seed = st["availability"][:, 0]
        a_sim = float(a_seed.mean())
        rel = abs(a_mf - a_sim) / a_sim
        b = len(MOB_CHECK_SEEDS)
        line = (f"{mob}, paper point, B={b} N={cfg.n_nodes} {n_slots} slots, "
                f"second half: a_sim {a_sim:.6f} (seeds "
                f"{[round(float(v), 6) for v in a_seed]}) a_mf {a_mf:.6f} "
                f"rel err {rel:.4f}; busy sim {float(st['busy_frac'].mean()):.6f}"
                f" mf {b_mf:.6f}; nodes in RZ "
                f"{float(st['n_in_rz'].mean()):.2f} (p.N {p.N:.2f}); repro at "
                f"4000 slots a_sim {MOB_CHECK_REF[mob][0]} a_mf "
                f"{MOB_CHECK_REF[mob][1]}; slots/s={n_slots / wall:.1f} "
                f"run-slots/s={b * n_slots / wall:.1f}; fixed point on the "
                f"card {t_fp:.3f}s; launches {n['pairwise_contacts']}, == "
                f"plain on the last inputs")
        if rel >= MOB_CHECK_TOL or a_mf < a_sim - MOB_CHECK_SLACK:
            raise AssertionError(f"mobility-check: beyond {MOB_CHECK_TOL} or "
                                 f"a_mf < a_sim - {MOB_CHECK_SLACK}; {line}")
        phase("mobility-check", line + f" (within {MOB_CHECK_TOL}, a_mf >= "
                                       f"a_sim - {MOB_CHECK_SLACK})")
    return dict(launches=launches, max_abs_err=err)


def mobility_profiles() -> None:
    """Kernels and device time a slot of an rwp and a manhattan run beside
    the paper point's (``zone_profiles``; B = 1, 32 slots each); then, on
    a quiet card, each kernel of the mobility paths timed on its new
    inputs beside its plain version and bound: ``pairwise_contacts`` on
    the profiled runs' last slot (paused nodes; nodes on street lines),
    ``cell_close_words`` on a manhattan run's last planes at N = 1024
    (32 slots) and ``gossip_merge_rows`` on the merges of replay (d)'s
    configuration (160 slots)."""
    p = paper_params(lam=0.05, M=1)
    lines = []
    for mob, kw in (("rwp", dict(pause_s=60.0)), ("manhattan", {})):
        cfg = SimConfig(n_slots=32, mobility=mob, **kw)
        label = mob + ("-pause60" if kw else "")
        with Recorder("pairwise_contacts", keep=1, module=sim_contacts) as rec:
            profile_slots(label, p, cfg, n_slots=32)
        (args, _), = rec.calls
        k = time_kernel_args(args, args[5], f"{label}'s last slot")
        lines.append(f"pairwise_contacts on {k['on']}: "
                     f"kernel_us={1e3 * k['ms']:.3f} "
                     f"bound_us={1e3 * k['bound_ms']:.5f} ({k['bound_by']}) "
                     f"plain_us={1e3 * k['plain_ms']:.3f}")
    p_cells, cfg = scaled_point(1024, 32)
    cfg = dataclasses.replace(cfg, mobility="manhattan",
                              contact_backend="cells")
    with Recorder("cell_close_words", keep=1, module=sim_cells) as rec:
        simulate(p_cells, cfg)
    k = time_cell_kernel(*rec.calls[-1], sim_cells.make_grid(cfg))
    lines.append(f"cell_close_words on manhattan's {k['on']}: "
                 f"kernel_us={1e3 * k['ms']:.3f} "
                 f"bound_us={1e3 * k['bound_ms']:.5f} ({k['bound_by']}) "
                 f"plain_us={1e3 * k['plain_ms']:.3f}")
    p_learn, cfg, task = replay_case("mob-learn")
    with Recorder("gossip_merge_rows") as rec:
        simulate(p_learn, cfg, task=task)
    merged = held_on_run_inputs(
        rec, gm.gossip_merge_rows, gm.gossip_merge_rows_ref, lerp_rows,
        lambda n, d, sel: merge_bound_ms(n, d, sel, scaled=False))
    lines.append(f"gossip_merge_rows under manhattan + harsh(): "
                 f"{merge_line(merged)}")
    phase("mobility-kernels", "; ".join(lines))


# ------------------------------------------------------------- dispatch

#: dispatch-check's sweep: 4 scenarios of Fig. 1's grid (the (5, 2.5) s
#: service times x the four model sizes) x 2 seeds at the paper geometry,
#: one scenario a chunk, ``reduce="mean"``.
DISPATCH_CFG = SimConfig(n_slots=240, sample_every=8)
DISPATCH_SEEDS = (0, 1)
DISPATCH_WORKERS = 2
#: The zone root's boundary input (ROADMAP queue 3): a centred zone of this
#: radius and a node at ZONE_ROOT_POINT, one ulp outside it.
ZONE_ROOT_RADIUS = 24.78697967529297
ZONE_ROOT_POINT = (124.78194, 100.5)


def zone_root() -> str:
    """``zone_member`` on the card on the zone root's boundary input (a
    (1, 200, 2) uniform track, numpy seed 0, node 7 on the point): the
    same decisions as on the CPU, node 7 outside; and torch's own float32
    root on the card against ``sqrt32`` on the node's d²."""
    pos = np.random.default_rng(0).uniform(0.0, 200.0, (1, 200, 2))
    pos = pos.astype(np.float32)
    pos[0, 7] = ZONE_ROOT_POINT
    zs = ZoneSet(centers=((100.0, 100.0),), radii=(ZONE_ROOT_RADIUS,))
    card = zone_member(torch.from_numpy(pos).cuda(), zs).cpu()
    cpu = zone_member(torch.from_numpy(pos), zs)
    if not torch.equal(card, cpu) or bool(card[0, 7, 0]):
        raise AssertionError("zone-root: the card's zone membership differs "
                             "from the CPU's, or node 7 is inside")
    d = torch.from_numpy(pos[0, 7]).cuda() - 100.0
    d2 = fma32(d[1], d[1], d[0] * d[0])
    raw = torch.sqrt(d2.expand(1024).contiguous())
    return (f"node 7 outside on both devices, {int(card.sum())} of 200 "
            f"inside, equal; torch's float32 root on the card "
            f"{'==' if bool((raw == sqrt32(d2)).all()) else '!='} sqrt32 "
            f"on its d^2")


def first_claims(lease_dir: str, until: threading.Event) -> dict:
    """Each worker's first claim time (``time.time()``, from its lease's
    owner record), read from ``lease_dir`` until ``until`` is set: a
    worker claims as soon as it has imported the port, made its CUDA
    context and rebuilt the sweep's setup."""
    seen: dict = {}
    while not until.wait(0.02):
        for name in os.listdir(lease_dir) if os.path.isdir(lease_dir) else ():
            if name.endswith(".owner.json"):
                with contextlib.suppress(OSError, ValueError):
                    with open(os.path.join(lease_dir, name)) as f:
                        owner = json.load(f)
                    seen.setdefault(owner["worker"], owner["claimed_at"])
    return seen


def dispatch_check() -> dict:
    """Phase 34: the sweep dispatch queue on the card. (a) the in-process
    ``sweep.run`` of ``DISPATCH_CFG``'s sweep; (b) the same sweep through
    ``sweep.run(workers=2, queue_dir=...)``; (c) again under a chaos
    schedule of one ``kill`` (chunk 0) and one ``corrupt`` (chunk 1): (b)
    and (c) equal (a) bit for bit on every statistic, coverage full, (b)
    without a requeue, (c) with an expired lease and a corrupt result seen.
    The workers run ``pairwise_contacts`` in their own processes; the
    kernel is held to its plain version by the phases of this script."""
    phase("zone-root", zone_root())
    ps = fig1_grid()[:4]
    n_slots = slots_run(DISPATCH_CFG)
    runs = len(ps) * len(DISPATCH_SEEDS)
    kw = dict(reduce="mean", chunk_size=1)
    reset_counts()
    t = time.perf_counter()
    inproc = sweep.run(ps, DISPATCH_CFG, DISPATCH_SEEDS, **kw)
    t_in = time.perf_counter() - t
    launches = counts()
    if launches != per_run(DENSE_ONLY, len(ps) * n_slots):
        raise AssertionError(f"dispatch-check launches {launches}")

    def same(out, what):
        for k, v in inproc.stats.items():
            if not np.array_equal(v, out.stats[k], equal_nan=True):
                raise AssertionError(f"dispatch-check: {what} differs from "
                                     f"the in-process sweep on {k}")
        if set(out.stats) != set(inproc.stats) or not out.coverage.all():
            raise AssertionError(f"dispatch-check: {what}'s keys or "
                                 f"coverage differ")

    with tempfile.TemporaryDirectory(prefix="dispatch-check-") as qd:
        until = threading.Event()
        with concurrent.futures.ThreadPoolExecutor(1) as watch:
            claims = watch.submit(first_claims,
                                  os.path.join(qd, "clean", "leases"), until)
            t0, t = time.time(), time.perf_counter()
            try:
                clean = sweep.run(ps, DISPATCH_CFG, DISPATCH_SEEDS, **kw,
                                  workers=DISPATCH_WORKERS,
                                  queue_dir=os.path.join(qd, "clean"))
            finally:
                t_clean = time.perf_counter() - t
                until.set()
        start_s = sorted(round(c - t0, 2) for c in claims.result().values())
        same(clean, "the dispatched sweep")
        tel = clean.telemetry
        if any(tc["requeues"] for tc in tel["chunks"].values()) or (
                tel["expired_leases"] or tel["corrupt_results"]):
            raise AssertionError(f"dispatch-check: requeues in a clean "
                                 f"dispatch: {tel}")
        chaos = [sim_dispatch.chaos_directive(0, 0, "kill"),
                 sim_dispatch.chaos_directive(1, 0, "corrupt")]
        t = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            hurt = sim_dispatch.run_dispatched(
                ps, DISPATCH_CFG, DISPATCH_SEEDS, **kw,
                workers=DISPATCH_WORKERS, chaos=chaos,
                queue_dir=os.path.join(qd, "chaos"))
        t_chaos = time.perf_counter() - t
        same(hurt, "the sweep under kill + corrupt")
        tel_c = hurt.telemetry
        if tel_c["expired_leases"] < 1 or tel_c["corrupt_results"] < 1:
            raise AssertionError(f"dispatch-check: chaos not seen: {tel_c}")
    phase("dispatch-check", (
        f"Fig. 1's first {len(ps)} scenarios x seeds {DISPATCH_SEEDS}, "
        f"N={DISPATCH_CFG.n_nodes}, {n_slots} slots, chunks of 1 scenario, "
        f"mean: (a) in-process {t_in:.2f}s, run-slots/s="
        f"{runs * n_slots / t_in:.1f}, launches "
        f"{launches['pairwise_contacts']}; (b) {DISPATCH_WORKERS} workers "
        f"{t_clean:.2f}s, run-slots/s={runs * n_slots / t_clean:.1f}, every "
        f"stat == (a), no requeue, chunk latencies "
        f"{[tc['latency_s'] for tc in tel['chunks'].values()]}s, the "
        f"workers' first claims (start: import, CUDA context, setup) at "
        f"{start_s}s, run-slots/s from the first claim "
        f"{runs * n_slots / (t_clean - start_s[0]):.1f}; (c) kill chunk 0 + "
        f"corrupt chunk 1: {t_chaos:.2f}s, every stat == (a), expired "
        f"leases {tel_c['expired_leases']}, corrupt results "
        f"{tel_c['corrupt_results']}, respawns {tel_c['respawns']}; on "
        f"{card_line()}"))
    return dict(launches=launches["pairwise_contacts"])


# ------------------------------------------------------- the gossip round

def leaf_bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 or bfloat16 tensor's raw bits, to compare bit for bit."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def flat_merge_bound_ms(n: int, itemsize: int) -> tuple[float, str]:
    """Least time for ``gossip_merge`` merging ``n`` elements: own and peer
    read and the output written once; 3 float32 operations an element (a
    multiply and an FMA) and ``1 - w`` once. (Unmerged, the kernel reads
    no peer: 2 accesses an element.)"""
    return roofline_ms(3 * n * itemsize, 3 * n + 1)


def placed(x: torch.Tensor, dtype, offset: int) -> torch.Tensor:
    """``x`` as ``dtype`` in a contiguous view that starts ``offset``
    elements into its buffer (an odd offset breaks 16-byte alignment)."""
    buf = torch.empty(x.numel() + offset, dtype=dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def check_flat_merge_cases() -> float:
    """``gossip_merge`` against its plain version on the card, bit for bit;
    returns the largest abs difference (0 when bit for bit)."""
    gen = torch.Generator("cuda").manual_seed(17)
    shapes = [((1,), 0), ((7,), 0), ((4095,), 0), ((16385,), 0),
              ((3, 257, 33), 0), ((4097,), 1), ((32768, 3840), 0)]
    count, worst = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, offset in shapes:
            own, peer = (placed(2 * torch.randn(shape, device="cuda",
                                                generator=gen), dtype, offset)
                         for _ in range(2))
            bad = peer.clone()
            bad.view(-1)[::3] = float("nan")
            bad.view(-1)[1::3] = float("inf")
            for w in (0.0, 1 / 3, 0.5, 1.0, "random"):
                wt = (torch.rand((), device="cuda", generator=gen)
                      if w == "random" else
                      torch.tensor(np.float32(w), device="cuda"))
                for success, own_first in itertools.product(
                        (True, False), (False, True)):
                    s = torch.tensor(success, device="cuda")
                    p = peer if success else bad
                    got = gm.gossip_merge(own, p, wt, s, own_first=own_first)
                    want = gm.gossip_merge_ref(own, p, wt, s, own_first)
                    torch.cuda.synchronize()
                    label = (f"{dtype} {shape} offset {offset} "
                             f"w={float(wt)} success={success} "
                             f"own_first={own_first}")
                    if not torch.equal(leaf_bits(got), leaf_bits(want)):
                        raise AssertionError(f"gossip_merge != plain: {label}")
                    if not (success or torch.equal(leaf_bits(got),
                                                   leaf_bits(own))):
                        raise AssertionError(
                            f"unselected leaf changed: {label}")
                    worst = max(worst, float((got.float() - want.float())
                                             .abs().max()))
                    count += 1
            del own, peer, bad
    x = torch.zeros((64, 32), device="cuda")
    try:
        gm.gossip_merge(x.t(), x.t(), torch.tensor(0.5, device="cuda"),
                        torch.tensor(True, device="cuda"))
    except ValueError:
        pass
    else:
        raise AssertionError("gossip_merge took a non-contiguous input")
    torch.cuda.empty_cache()
    phase("flat-merge-kernel", (
        f"{count} cases bit for bit (float32 and bfloat16; lengths 1 to "
        f"125829120, an odd 3-D shape, a view at an odd offset; w in "
        f"{{0, 1/3, 0.5, 1, random}}; success true/false, NaN/inf in the "
        f"unselected peer; both operand orders); a non-contiguous input "
        f"raised; "
        f"max_abs_err={worst}"))
    return worst


def check_init_replay(seed: int = 7) -> None:
    """The test-size config's ``init_lm`` on the card equals the same call
    on the CPU, bit for bit (``random.normal`` on the card included)."""
    leaves = 0
    for dtype in ("float32", "bfloat16"):
        cfg = reduced(get_arch_config(GOSSIP_ARCH), dtype=dtype)
        cpu = init_lm(cfg, jr.PRNGKey(seed), device="cpu")
        gpu = init_lm(cfg, jr.PRNGKey(seed))          # default device: cuda
        for (path, c), (_, g) in zip(tree_items(cpu), tree_items(gpu)):
            if g.device.type != "cuda" or not torch.equal(
                    leaf_bits(g.cpu()), leaf_bits(c)):
                raise AssertionError(f"init_lm on the card != CPU: {dtype} "
                                     f"{path}")
            leaves += 1
    phase("init-replay", f"reduced {GOSSIP_ARCH} (float32 and bfloat16): "
                         f"{leaves} leaves bit for bit, card vs CPU")


def check_round_replay(seed: int = 7) -> None:
    """Rounds over the test-size tree with a one-element float32 leaf
    added (its merge, and the segmented round's float32 merges, take the
    kernel's other operand order; the trees made once a dtype, stacked
    anew for each segmentation), on the card and on the CPU: every leaf
    bit for bit, count and age exact, one launch per replica and non-empty
    leaf segment."""
    notes, merged, trees = [], 0, {}
    for dtype, segments in itertools.product(("float32", "bfloat16"),
                                             (1, 3)):
        if dtype not in trees:
            arch = reduced(get_arch_config(GOSSIP_ARCH), dtype=dtype)
            trees = {dtype: [init_lm(arch, jr.PRNGKey(seed + k), device="cpu")
                             for k in range(GOSSIP_R + 1)]}
        reps, rng = trees[dtype], np.random.default_rng(seed)
        pc = dict(stack_replicas(reps[:GOSSIP_R]), scale=torch.from_numpy(
            rng.normal(size=(GOSSIP_R, 1)).astype(np.float32)))
        dc = dict(stack_replicas([reps[GOSSIP_R]] * GOSSIP_R),
                  scale=torch.zeros(GOSSIP_R, 1))
        pg, dg = (tree_map(lambda x: x.cuda(), t) for t in (pc, dc))
        sc = dict(count=torch.tensor(GOSSIP_COUNTS),
                  age=torch.zeros(GOSSIP_R))
        sg = {k: v.cuda() for k, v in sc.items()}
        fn, R = gossip.build_gossip_round(
            GOSSIP_R, dataclasses.replace(GOSSIP, segments=segments))
        for r in CHECKED_ROUNDS:
            segs = sum(R for _, x in tree_items(pc)
                       if (r % segments) * -(-x[0].numel() // segments)
                       < x[0].numel())
            success = fn.gates(sc, r).success
            merged += int(success.sum())
            reset_counts()
            pg, sg = fn(pg, sg, dg, r)
            torch.cuda.synchronize()
            if counts() != dict(DENSE_ONLY, pairwise_contacts=0,
                                gossip_merge=segs):
                raise AssertionError(f"round-replay launches {counts()}, "
                                     f"want {segs}")
            pc, sc = fn(pc, sc, dc, r)
            for (path, c), (_, g) in zip(tree_items(pc), tree_items(pg)):
                if not torch.equal(leaf_bits(g.cpu()), leaf_bits(c)):
                    raise AssertionError(f"round {r} on the card != CPU: "
                                         f"{dtype} segments={segments} "
                                         f"{path}")
            for k in ("count", "age"):
                if not torch.equal(sg[k].cpu(), sc[k]):
                    raise AssertionError(f"round {r}: {k} card != CPU")
            notes.append(f"{dtype}/seg{segments}/r{r}: {segs} launches")
    if not merged:
        raise AssertionError("round-replay merged no replica")
    phase("round-replay", (
        f"reduced {GOSSIP_ARCH} + a one-element float32 leaf, R={GOSSIP_R}, "
        f"rounds {CHECKED_ROUNDS}, float32 and bfloat16, segments 1 and 3: "
        f"card == CPU bit for bit on every leaf, count and age; {merged} "
        f"replica merges; " + ", ".join(notes)))


def gossip_replicas():
    """The gossip configuration's R replicas (keys 0..R-1), its default
    (key R, on every replica) and the start state, on the card."""
    cfg = get_arch_config(GOSSIP_ARCH, n_layers=GOSSIP_LAYERS)
    t = time.perf_counter()
    params = stack_replicas([init_lm(cfg, jr.PRNGKey(k))
                             for k in range(GOSSIP_R)])
    default = stack_replicas([init_lm(cfg, jr.PRNGKey(GOSSIP_R))] * GOSSIP_R)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    state = dict(count=torch.tensor(GOSSIP_COUNTS, device="cuda"),
                 age=torch.zeros(GOSSIP_R, device="cuda"))
    n = sum(v[0].numel() for _, v in tree_items(params))
    phase("gossip-init", (
        f"{GOSSIP_ARCH} at its published widths, n_layers={GOSSIP_LAYERS} "
        f"(of 24), R={GOSSIP_R}: {len(tree_items(params))} leaves, {n} "
        f"parameters a replica, bfloat16; init of {GOSSIP_R + 1} trees "
        f"{init_s:.1f}s"))
    return params, default, state


def plain_merge(own, peer, w_own, success, out=None, own_first=False):
    """The round's merge through the plain version, on the card."""
    return out.copy_(gm.gossip_merge_ref(own, peer, w_own, success,
                                         own_first))


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """``module.name`` is ``fn`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def check_gossip_round(params, default, state) -> dict:
    """Three rounds at full width through the kernel and through the plain
    merge on the card: every leaf bit for bit, count and age exact."""
    fn, R = gossip.build_gossip_round(GOSSIP_R, GOSSIP)
    n_leaves = len(tree_items(params))
    pk, sk, pp, sp = params, state, params, state
    launches, notes = [], []
    for r in CHECKED_ROUNDS:
        g = fn.gates(sk, r)
        reset_counts()
        pk, sk = fn(pk, sk, default, r)
        torch.cuda.synchronize()
        launches.append(gm.gossip_merge.launches)
        if counts() != dict(DENSE_ONLY, pairwise_contacts=0,
                            gossip_merge=R * n_leaves):
            raise AssertionError(f"gossip-round launches {counts()}")
        with swapped(gossip, "gossip_merge", plain_merge):
            pp, sp = fn(pp, sp, default, r)
        torch.cuda.synchronize()
        for (path, a), (_, b) in zip(tree_items(pk), tree_items(pp)):
            if not torch.equal(leaf_bits(a), leaf_bits(b)):
                raise AssertionError(f"round {r}: kernel != plain on {path}")
        for k in ("count", "age"):
            if not torch.equal(sk[k], sp[k]):
                raise AssertionError(f"round {r}: {k} {sk[k]} != {sp[k]}")
        notes.append(f"round {r}: success={g.success.int().tolist()} "
                     f"churn={g.reset.int().tolist()} "
                     f"count={sk['count'].tolist()}")
    phase("gossip-round", (
        f"{len(CHECKED_ROUNDS)} rounds at full width, kernel vs plain on "
        f"the card: {n_leaves} leaves x R={R} bit for bit, count and age "
        f"exact; gossip_merge launches per round {launches}; "
        + "; ".join(notes)))
    return dict(launches_per_round=launches[0])


def embed_spread(params) -> float:
    """Mean pairwise Euclidean distance between the replicas' embeddings."""
    e = params["embed"]
    d = [float((e[i].float() - e[j].float()).norm())
         for i in range(GOSSIP_R) for j in range(i + 1, GOSSIP_R)]
    return sum(d) / len(d)


def rounds_run(params, default, state, n_rounds: int = 16) -> dict:
    """The gossip round's main path: ``n_rounds`` rounds at full width on
    the card, timed and checked."""
    fn, R = gossip.build_gossip_round(GOSSIP_R, GOSSIP)
    tree_bytes = sum(v[0].numel() * v.element_size()
                     for _, v in tree_items(params))
    n_leaves = len(tree_items(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, bounds, lowered, skipped, churned = [], [], 0, [], 0
    p, st = params, state
    spread = embed_spread(p)
    spreads = [spread]
    reset_counts()
    for r in range(n_rounds):
        g = fn.gates(st, r)
        success, reset = g.success.tolist(), g.reset.tolist()
        partner = g.partner.tolist()
        distinct = any(success[i] and not torch.equal(
            p["embed"][i], p["embed"][partner[i]]) for i in range(R))
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, st = fn(p, st, default, r)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        bounds.append(sum(3 if s_ else 2 for s_ in success) * tree_bytes
                      / HBM_BYTES_S * 1e3)
        for i in range(R):
            if reset[i]:
                churned += 1
                if not all(torch.equal(leaf_bits(x[i]), leaf_bits(d[i]))
                           for (_, x), (_, d) in zip(tree_items(p),
                                                     tree_items(default))):
                    raise AssertionError(f"round {r}: churned replica {i} "
                                         f"!= default")
        new = embed_spread(p)
        if distinct and not any(reset):
            if not new < spread:
                raise AssertionError(f"round {r}: spread {spread} -> {new} "
                                     f"after a merge without churn")
            lowered += 1
        elif any(success) and not any(reset):
            skipped.append(r)
        spread = new
        spreads.append(new)
    launches = counts()
    if launches != dict(DENSE_ONLY, pairwise_contacts=0,
                        gossip_merge=n_rounds * R * n_leaves):
        raise AssertionError(f"rounds-run launches {launches}")
    peak = torch.cuda.max_memory_allocated()
    for path, leaf in tree_items(p):
        if not torch.isfinite(leaf).all():
            raise AssertionError(f"rounds-run: {path} not finite")
    prof = profile_round(fn, p, st, default, n_rounds)
    k = time_flat_merge(p, fn.gates(st, n_rounds))
    wall = sorted(walls)
    total = torch.cuda.get_device_properties(0).total_memory
    phase("rounds-run", (
        f"{n_rounds} rounds, R={R}, {GOSSIP}: wall per round first "
        f"{1e3 * walls[0]:.3f}ms, median {1e3 * wall[len(wall) // 2]:.3f}ms, "
        f"mean {1e3 * sum(walls) / len(walls):.3f}ms; launches={launches}; "
        f"churned replicas {churned} (each == default bit for bit); spread "
        f"lower on all {lowered} rounds that merged distinct replicas "
        f"without churn (rounds merging only equal replicas: {skipped}); "
        f"spread {', '.join(f'{v:.6g}' for v in spreads)}; every leaf "
        f"finite; peak memory {peak / 2**30:.2f} GiB = "
        f"{peak / total:.4f} of the card; round bound from this run's "
        f"merges {min(bounds):.4f}-{max(bounds):.4f}ms (all merged "
        f"{3 * R * tree_bytes / HBM_BYTES_S * 1e3:.4f}ms); {prof}; "
        f"gossip_merge on the embedding leaf (32768, 3840) bfloat16 merged: "
        f"kernel_us={1e3 * k['ms']:.3f} bound_us={1e3 * k['bound_ms']:.3f} "
        f"({k['bound_by']}) plain_us={1e3 * k['plain_ms']:.3f} "
        f"library_us={1e3 * k['library_ms']:.3f} "
        f"kernel_call_us={1e3 * k['call_ms']:.3f}; "
        f"max_abs_err={k['max_abs_err']}"))
    return dict(launches=launches["gossip_merge"], **k)


def profile_round(fn, p, st, default, r0: int, n: int = 2) -> str:
    """Device time and busy share of ``n`` rounds (``torch.profiler``, as
    ``profile_slots`` measures them), and the merge kernel's part."""
    def rounds():
        for r in range(r0, r0 + n):
            fn(p, st, default, r)

    wall_us, dev = profiled(rounds)
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        return "device time not measured"
    merge_us = sum(e.self_device_time_total for e in dev
                   if "merge_flat" in e.key)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:3]
    return (f"profiled {n} rounds: wall_per_round_ms={wall_us / n / 1e3:.3f} "
            f"device_ms_per_round={busy_us / n / 1e3:.4f} "
            f"merge_kernel_ms_per_round={merge_us / n / 1e3:.4f} "
            f"device_busy_share={busy_us / wall_us:.4f} "
            f"kernels_per_round={sum(e.count for e in dev) / n:.1f} top: "
            + "; ".join(f"{e.key[:40]} "
                        f"{e.self_device_time_total / n / 1e3:.3f}ms/round "
                        f"x{e.count / n:.1f}" for e in top))


def time_flat_merge(p, g) -> dict:
    """``gossip_merge`` on the run's own embedding leaf (replica 0 with its
    partner, merged at its weight): held against its plain version, then the
    kernel, the plain version and the nearest library composition timed."""
    own, peer = p["embed"][0], p["embed"][int(g.partner[0])]
    w, s = g.w_own[0], torch.tensor(True, device="cuda")
    out = torch.empty_like(own)
    got, want = gm.gossip_merge(own, peer, w, s), gm.gossip_merge_ref(
        own, peer, w, s)
    torch.cuda.synchronize()
    if not torch.equal(leaf_bits(got), leaf_bits(want)):
        raise AssertionError("gossip_merge != plain on the embedding leaf")
    err = float((got.float() - want.float()).abs().max())
    del got, want

    def library():
        return torch.where(s, torch.lerp(peer.float(), own.float(), w).to(
            own.dtype), own)

    bound_ms, bound_by = flat_merge_bound_ms(own.numel(), own.element_size())
    ms = device_ms(lambda: gm.gossip_merge(own, peer, w, s, out=out),
                   per_graph=20, replays=5)
    plain = device_ms(lambda: gm.gossip_merge_ref(own, peer, w, s),
                      per_graph=2, replays=3)
    lib = device_ms(library, per_graph=5, replays=3)
    call = call_ms(lambda: gm.gossip_merge(own, peer, w, s, out=out), reps=50)
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=lib, call_ms=call,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)


# ------------------------------------------------------------- serving

def attention_bound_ms(b: int, sq: int, skv: int, h: int, hkv: int, d: int,
                       dtype, causal: bool, window) -> tuple[float, str]:
    """Least time for one ``flash_attention`` call: q, k and v read once,
    the output written once; 4·D operations (the two products) for every
    unmasked (query, key) pair of every query head, at the card's peak for
    the inputs' type (bf16: the tensor cores; float32: the CUDA cores)."""
    q_pos = np.arange(sq) + (skv - sq)
    hi = np.minimum(q_pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window else np.zeros(sq)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * sq * h * d + 2 * b * skv * hkv * d) * item
    flops = 4 * d * pairs * b * h
    rate = BF16_FLOPS_S if dtype == torch.bfloat16 else F32_FLOPS_S
    return roofline_ms(nbytes, flops, rate)


@contextlib.contextmanager
def no_tf32():
    """Float32 products in full float32 (hopper guide §6), set explicitly."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def attention_inputs(gen, b, sq, skv, h, hkv, d, dtype, q_scale=0.5):
    return (q_scale * torch.randn((b, sq, h, d), device="cuda",
                                  generator=gen)).to(dtype), *(
        (0.5 * torch.randn((b, skv, hkv, d), device="cuda",
                           generator=gen)).to(dtype) for _ in range(2))


def attention_form(q) -> str:
    """The form a call must take: ``decode`` for one query position, else
    ``mma`` in bfloat16 and ``simt`` in float32."""
    if q.shape[1] == 1:
        return "decode"
    return "mma" if q.dtype == torch.bfloat16 else "simt"


def attention_close(got, want, what: str) -> tuple[float, float]:
    """``got`` against ``want`` elementwise within ``ATTN_TOL`` and as a
    whole within ``ATTN_REL``; returns the max abs and the relative L2
    difference."""
    err = close(got, want, *ATTN_TOL[want.dtype], what)
    g, w = got.double(), want.double()
    rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
    if not rel <= ATTN_REL[want.dtype]:
        raise AssertionError(f"{what}: relative L2 difference {rel} beyond "
                             f"{ATTN_REL[want.dtype]}")
    return err, rel


def attention_case(q, k, v, causal: bool, window,
                   what: str) -> tuple[float, float]:
    """One kernel call against the plain version on the same inputs, in
    the form the shape and dtype give; returns the max abs and relative L2
    differences."""
    fa.flash_attention.forms.clear()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    attention_forms(what, {attention_form(q): 1})
    want = fa.flash_attention_ref(q, k.contiguous(), v.contiguous(),
                                  causal=causal, window=window)
    torch.cuda.synchronize()
    return attention_close(got, want, what)


def check_attention_cases() -> float:
    """``flash_attention`` against its plain version on the card, float32
    and bfloat16, over D x G x masks x lengths (D = 67, and 100 in
    bfloat16, take the kernels' single-value loads, the others their
    16-byte loads), ring-cache views, views one element off, a window that
    prunes tiles, and the full-width prefill shape (the long-key cases with
    q at ``SHARP_Q``), each in the form its shape and dtype give, within
    ``ATTN_TOL`` and ``ATTN_REL``; inputs the kernel refuses must raise.
    Returns the largest abs difference."""
    gen = torch.Generator("cuda").manual_seed(18)
    masks = [(True, None), (False, None), (True, 96), (True, 4096),
             (False, 96)]
    # Sq > 1: Skv not a multiple of 64; at G = 1 the causal S = 200 block
    # has a tile wholly masked for its first warpgroup's rows, and window
    # 96 leaves the last rows' first visited tile wholly masked. Sq = 1:
    # Skv = 1 and 5 leave some of the 8 warps' key slices empty.
    lengths = [(2, 200, 200), (1, 37, 300), (3, 1, 1), (2, 1, 5),
               (2, 1, 37), (2, 1, 129), (2, 1, 300)]
    count, worst, worst_rel = 0, 0.0, 0.0
    with no_tf32():
        for dtype, d, g in itertools.product(
                (torch.float32, torch.bfloat16), (64, 67, 100, 120, 128),
                (1, 4, 8)):
            for (causal, window), (b, sq, skv) in itertools.product(
                    masks, lengths):
                q, k, v = attention_inputs(gen, b, sq, skv, 2 * g, 2, d,
                                           dtype)
                err, rel = attention_case(
                    q, k, v, causal, window,
                    f"{dtype} D={d} G={g} causal={causal} window={window} "
                    f"B={b} Sq={sq} Skv={skv}")
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                count += 1
        big = [(torch.bfloat16, (1, 37, 5000, 32, 8, 120), None),
               (torch.bfloat16, (1, 5000, 5000, 8, 2, 120), None),
               (torch.float32, (1, 5000, 5000, 8, 8, 64), None),
               (torch.bfloat16, (3, 1, 37, 32, 8, 120), "view"),
               (torch.float32, (3, 1, 37, 32, 8, 120), "view"),
               (torch.float32, (3, 1, 200, 8, 2, 128), "view"),
               (torch.bfloat16, (2, 1, 4096, 32, 8, 120), "view"),
               (torch.float32, (2, 1, 4096, 32, 8, 120), "view"),
               (torch.bfloat16, (2, 70, 70, 8, 2, 120), "offset"),
               (torch.float32, (2, 70, 70, 8, 2, 120), "offset"),
               (torch.bfloat16, (2, 1, 70, 8, 2, 120), "offset"),
               (torch.float32, (2, 1, 70, 8, 2, 120), "offset"),
               (torch.bfloat16, (1, PREFILL_S, PREFILL_S, 32, 8, 120), None)]
        for dtype, (b, sq, skv, h, hkv, d), how in big:
            q, k, v = attention_inputs(gen, b, sq, skv, h, hkv, d, dtype,
                                       q_scale=SHARP_Q)
            if how == "view":                 # a ring cache's valid slots
                ck, cv = (torch.zeros((b, 2 * skv + 64, hkv, d),
                                      dtype=dtype, device="cuda")
                          for _ in range(2))
                ck[:, :skv], cv[:, :skv] = k, v
                k, v = ck[:, :skv], cv[:, :skv]
                assert not k.is_contiguous()
            if how == "offset":               # not 16-byte aligned
                q, k, v = (placed(x, dtype, 1) for x in (q, k, v))
            causal = how != "view"
            window = 4096 if causal else None
            err, rel = attention_case(
                q, k, v, causal, window,
                f"{dtype} {(b, sq, skv, h, hkv, d)} {how or ''}")
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
            count += 1
            del q, k, v
    refused = 0
    for bad in ((torch.float16, 64), (torch.float32, 129)):
        x = torch.zeros((1, 4, 2, bad[1]), dtype=bad[0], device="cuda")
        try:
            fa.flash_attention(x, x, x)
        except ValueError:
            refused += 1
    if refused != 2:
        raise AssertionError("flash_attention took float16 or D > 128")
    torch.cuda.empty_cache()
    phase("attention-kernel", (
        f"{count} cases within tests/test_kernels.py's tolerances (float32 "
        f"2e-5, bfloat16 2e-2) and relative L2 {ATTN_REL[torch.float32]} / "
        f"{ATTN_REL[torch.bfloat16]}, each in its form (mma: bf16 Sq > 1; "
        f"simt: float32 Sq > 1; decode: Sq = 1): D in {{64, 67, 100, 120, "
        f"128}} (67, 100 in bf16 and views one element off take the single-value "
        f"loads), G in {{1, 4, 8}}, causal on/off, window in {{None, 96, "
        f"4096}}, Sq = Skv, Sq < Skv and Sq = 1 over Skv in {{1, 5, 37, "
        f"129, 300, 4096}}, ring-cache views in both dtypes, S = 5000 with "
        f"the window pruning tiles, the prefill shape (1, {PREFILL_S}, 32/8 "
        f"heads, 120), q at {SHARP_Q} x randn from S = 5000 on; float16 "
        f"and D = 129 raised; max_abs_err={worst} "
        f"max_rel_l2={worst_rel}"))
    return worst


def greedy_replay(cfg, gpu, cpu, prompts, n_new: int, max_len: int,
                  window_override, tol) -> str:
    """``ServeEngine.generate`` on the card and on the CPU. Float32: the
    tokens equal. bfloat16: the CPU's sequence replayed through the card's
    decode step by step, logits within ``tol`` and the same greedy token
    wherever the CPU's best logit leads the next by more than twice the
    tolerance (closer calls may flip on a bf16 rounding)."""
    kw = dict(max_len=max_len, window_override=window_override)
    reset_counts()
    got = ServeEngine(cfg, gpu, **kw).generate(prompts.cuda(), n_new)
    torch.cuda.synchronize()
    n_attn = cfg.repeats * sum(s.kind == "attn" for s in cfg.pattern)
    want_launches = dict(NO_KERNEL, flash_attention=(
        prompts.shape[1] + n_new) * n_attn)
    if counts() != want_launches:
        raise AssertionError(f"serve-replay launches {counts()}")
    n_decode = want_launches["flash_attention"]
    attention_forms("generate", {"decode": n_decode} if n_decode else {})
    want = ServeEngine(cfg, cpu, **kw).generate(prompts, n_new)
    if got.device.type != "cuda" or got.dtype != torch.int64:
        raise AssertionError(f"generate gave {got.dtype} on {got.device}")
    same = torch.equal(got.cpu(), want)
    if cfg.dtype == "float32":
        if not same:
            raise AssertionError(f"generate card != CPU: {got} vs {want}")
        return f"tokens equal ({tuple(got.shape)})"
    seq = torch.cat([prompts, want], dim=1)
    cg = init_cache(cfg, seq.shape[0], max_len,
                    window_override=window_override)
    cc = init_cache(cfg, seq.shape[0], max_len,
                    window_override=window_override, device="cpu")
    dec = make_decode_step(cfg, window_override=window_override)
    worst, decided = 0.0, 0
    for t in range(seq.shape[1] - 1):
        lg, cg = dec(gpu, cg, seq[:, t:t + 1].cuda(), t)
        lc, cc = dec(cpu, cc, seq[:, t:t + 1], t)
        g = lg[:, 0, :cfg.vocab_size].float().cpu()
        c = lc[:, 0, :cfg.vocab_size].float()
        worst = max(worst, close(g, c, *tol, f"bf16 decode step {t}"))
        if t >= prompts.shape[1] - 1:
            top2 = c.topk(2, dim=-1).values
            clear = top2[:, 0] - top2[:, 1] > 2 * tol[1]
            if not torch.equal(g.argmax(-1)[clear], seq[clear, t + 1]):
                raise AssertionError(f"bf16 step {t}: a clear greedy choice "
                                     f"differs")
            decided += int(clear.sum())
    return (f"tokens {'equal' if same else 'not all equal'}; replayed "
            f"decode logits max_abs_err={worst}, {decided} clear greedy "
            f"choices equal")


def serve_replay(seed: int = 3) -> None:
    """The reduced h2o-danube-3-4b (2 layers) on the card against the same
    calls on the CPU, float32 then bfloat16: ``lm_forward`` logits over 80
    tokens (past the reduced 64-token window) and ``generate``, once with
    a ring of 8 slots that wraps."""
    notes = []
    with no_tf32():
        for dtype in ("float32", "bfloat16"):
            cfg = reduced(get_arch_config(GOSSIP_ARCH), n_layers=2,
                          dtype=dtype)
            cpu = init_lm(cfg, jr.PRNGKey(seed), device="cpu")
            gpu = params_from_numpy(params_to_numpy(cpu))
            rng = np.random.default_rng(seed)
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 80)))
            reset_counts()
            lg = lm_forward(cfg, gpu, tok.cuda(), chunk=32)[0]
            torch.cuda.synchronize()
            if counts() != dict(NO_KERNEL, flash_attention=cfg.n_layers):
                raise AssertionError(f"lm_forward launches {counts()}")
            attention_forms(f"{dtype} lm_forward", {
                "mma" if dtype == "bfloat16" else "simt": cfg.n_layers})
            err = close(lg.cpu(), lm_forward(cfg, cpu, tok, chunk=32)[0],
                         *SERVE_TOL[dtype], f"{dtype} lm_forward")
            prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (3, 5)))
            plain = greedy_replay(cfg, gpu, cpu, prompts, 8, 32, None,
                                  SERVE_TOL[dtype])
            ring = greedy_replay(cfg, gpu, cpu, prompts, 20, 32, 8,
                                 SERVE_TOL[dtype])
            notes.append(f"{dtype}: lm_forward max_abs_err={err}; generate "
                         f"8: {plain}; ring of 8, 20 new: {ring}")
    phase("serve-replay", (
        f"reduced {GOSSIP_ARCH} (2 layers), card (kernel) vs CPU (plain "
        f"path), tolerances {SERVE_TOL}: " + "; ".join(notes)))


def serve_model():
    """The serving configuration's tree on the card: ``init_lm`` from key 0
    of the gossip configuration (2 of 24 layers at published widths)."""
    cfg = get_arch_config(GOSSIP_ARCH, n_layers=GOSSIP_LAYERS)
    params = init_lm(cfg, jr.PRNGKey(0))
    torch.cuda.synchronize()
    return cfg, params


def time_attention(q, k, v, causal: bool, window, per_graph: int,
                   replays: int, plain_reps: int) -> dict:
    """The kernel (CUDA graph), its plain version (eager) and SDPA with the
    same mask (``enable_gqa``; a CUDA graph), on the same inputs."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    bound_ms, bound_by = attention_bound_ms(b, sq, skv, h, hkv, d, q.dtype,
                                            causal, window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    q_pos = torch.arange(sq, device="cuda")[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device="cuda")[None, :]
    band = torch.ones((sq, skv), dtype=torch.bool, device="cuda")
    if causal:
        band &= q_pos >= k_pos
    if window is not None:
        band &= q_pos - k_pos < window

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float() - fa.flash_attention(
        q, k, v, causal=causal, window=window).float()).abs().max())
    ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=window),
                   per_graph=per_graph, replays=replays)
    plain = call_ms(lambda: fa.flash_attention_ref(q, k, v, causal=causal,
                                                   window=window),
                    reps=plain_reps, warm=1)
    lib = device_ms(library, per_graph=per_graph, replays=replays)
    call = call_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                              window=window),
                   reps=per_graph, warm=1)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, call_ms=call,
                bound_ms=bound_ms, bound_by=bound_by, library_err=lib_err)


def serve_prefill(cfg, params, seed: int = 19) -> dict:
    """``make_prefill_step`` over B = 1, S = 8192 tokens (twice the window,
    so the band is live): wall time, tokens/s, the kernel's launches, layer
    0's attention held against the plain version on its own q/k/v, and
    the kernel timed there beside its bound, the plain version and SDPA."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, PREFILL_S))).cuda()
    prefill = make_prefill_step(cfg)
    prefill(params, dict(tokens=tokens[:, :256]))         # warm-up
    reset_counts()
    t = time.perf_counter()
    logits = prefill(params, dict(tokens=tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = counts()
    if launches != dict(NO_KERNEL, flash_attention=cfg.n_layers):
        raise AssertionError(f"serve-prefill launches {launches}")
    attention_forms("serve-prefill", {"mma": cfg.n_layers})
    if tuple(logits.shape) != (1, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("serve-prefill logits not finite or misshapen")
    layer0 = tree_map(lambda a: a[0], params["blocks"][0])
    h = rmsnorm(params["embed"][tokens], layer0["norm_mix"], cfg.norm_eps)
    q, k, v = gqa_qkv(layer0["attn"], cfg, h)
    got = fa.flash_attention(q, k, v, causal=True, window=cfg.window)
    err, rel = attention_close(got, fa.flash_attention_ref(
        q, k, v, causal=True, window=cfg.window), "layer 0 prefill attention")
    del got, h
    timed = time_attention(q, k, v, True, cfg.window, per_graph=3,
                           replays=2, plain_reps=2)
    del q, k, v
    torch.cuda.empty_cache()
    phase("serve-prefill", (
        f"{GOSSIP_ARCH} at published widths, {cfg.n_layers} of 24 layers, "
        f"bf16, B=1 S={PREFILL_S} window {cfg.window}: wall "
        f"{1e3 * wall:.3f}ms, {PREFILL_S / wall:.1f} tokens/s; launches "
        f"{launches['flash_attention']}; logits finite; layer 0 attention vs "
        f"plain max_abs_err={err} rel_l2={rel}; kernel_ms={timed['ms']:.4f} "
        f"kernel_call_ms={timed['call_ms']:.4f} bound_ms="
        f"{timed['bound_ms']:.4f} ({timed['bound_by']}) plain_ms="
        f"{timed['plain_ms']:.4f} sdpa_ms={timed['library_ms']:.4f} "
        f"(sdpa vs kernel max abs {timed['library_err']})"))
    return dict(launches=launches["flash_attention"], max_abs_err=err,
                wall_ms=1e3 * wall, **timed)


def profile_decode(params, cfg, prompts, max_len: int, n: int = 8,
                   kernel: str = "flash_decode_kernel") -> str:
    """Device time, busy share and kernels per step over ``n`` decode
    steps at the end of a warm cache (``torch.profiler``); ``kernel``
    names the hand kernel whose time is summed."""
    cache = init_cache(cfg, prompts.shape[0], max_len)
    dec = make_decode_step(cfg)
    for t in range(prompts.shape[1]):
        _, cache = dec(params, cache, prompts[:, t:t + 1], t)

    def steps():
        tok = prompts[:, -1:]
        for i in range(n):
            lg, _ = dec(params, cache, tok, prompts.shape[1] + i)
            tok = lg[:, -1:, :cfg.vocab_size].argmax(dim=-1)

    wall_us, dev = profiled(steps)
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        return "device time not measured"
    attn_us = sum(e.self_device_time_total for e in dev
                  if kernel in e.key)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:4]
    return (f"profiled {n} steps at {prompts.shape[1]}+ cached tokens: "
            f"wall_per_step_ms={wall_us / n / 1e3:.4f} device_ms_per_step="
            f"{busy_us / n / 1e3:.4f} {kernel}_ms_per_step="
            f"{attn_us / n / 1e3:.4f} device_busy_share="
            f"{busy_us / wall_us:.4f} kernels_per_step="
            f"{sum(e.count for e in dev) / n:.1f} top: "
            + "; ".join(f"{e.key[:40]} {e.self_device_time_total / n:.1f}"
                        f"us/step x{e.count / n:.1f}" for e in top))


def serve_generate(cfg, params, seed: int = 20) -> dict:
    """``ServeEngine.generate`` at full width: 8 requests, 64-token prompts,
    64 new tokens, ``max_len`` 256 (128 decode steps). Tokens in the
    vocabulary, a second call equal, the decode logits at the last prompt
    position against ``make_prefill_step``'s; wall per step, the device's
    busy share, and the decode kernel at 128 and 4096 valid slots beside
    its bound and SDPA."""
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT))).cuda()
    engine = ServeEngine(cfg, params, max_len=GEN_MAX_LEN)
    steps = GEN_PROMPT + GEN_NEW
    reset_counts()
    t = time.perf_counter()
    first = engine.generate(prompts, GEN_NEW)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t
    launches = counts()
    if launches != dict(NO_KERNEL, flash_attention=steps * cfg.n_layers):
        raise AssertionError(f"serve-generate launches {launches}")
    attention_forms("serve-generate", {"decode": steps * cfg.n_layers})
    t = time.perf_counter()
    second = engine.generate(prompts, GEN_NEW)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t
    if tuple(first.shape) != (GEN_B, GEN_NEW) or not (
            0 <= int(first.min()) and int(first.max()) < cfg.vocab_size):
        raise AssertionError("serve-generate tokens out of the vocabulary")
    if not torch.equal(first, second):
        raise AssertionError("serve-generate: a second call differs")
    cache = init_cache(cfg, GEN_B, GEN_MAX_LEN)
    dec = make_decode_step(cfg)
    for i in range(GEN_PROMPT):
        lg, cache = dec(params, cache, prompts[:, i:i + 1], i)
    pre = make_prefill_step(cfg)(params, dict(tokens=prompts))
    err = close(lg[:, 0], pre, *SERVE_TOL["bfloat16"],
                 "decode vs prefill logits at the last prompt position")
    prof = profile_decode(params, cfg, prompts, GEN_MAX_LEN)
    del cache
    gen = torch.Generator("cuda").manual_seed(21)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (SHARP_Q * torch.randn((GEN_B, 1, h, d), device="cuda",
                               generator=gen)).to(torch.bfloat16)
    ck, cv = ((0.5 * torch.randn((GEN_B, GEN_MAX_LEN, hkv, d), device="cuda",
                                 generator=gen)).to(torch.bfloat16)
              for _ in range(2))
    k, v = ck[:, :DECODE_VALID], cv[:, :DECODE_VALID]
    kerr, krel = attention_close(fa.flash_attention(q, k, v, causal=False),
                                 fa.flash_attention_ref(q, k, v, causal=False),
                                 "decode-shape attention")
    timed = time_attention(q, k, v, False, None, per_graph=50, replays=20,
                           plain_reps=50)
    del ck, cv, k, v
    k, v = ((0.5 * torch.randn((GEN_B, DECODE_LONG, hkv, d), device="cuda",
                               generator=gen)).to(torch.bfloat16)
            for _ in range(2))
    long = time_attention(q, k, v, False, None, per_graph=20, replays=5,
                          plain_reps=2)
    del k, v
    per_step = (wall1 + wall2) / 2 / steps
    phase("serve-generate", (
        f"B={GEN_B}, prompt {GEN_PROMPT}, {GEN_NEW} new, max_len "
        f"{GEN_MAX_LEN}: wall {1e3 * wall1:.3f} / {1e3 * wall2:.3f}ms "
        f"(first / second call), {1e3 * per_step:.4f}ms per decode step, "
        f"{GEN_B * GEN_NEW / wall2:.1f} new tokens/s (second call); launches "
        f"{launches['flash_attention']} ({launches['flash_attention'] / steps:.0f}"
        f" a step); tokens in [0, {cfg.vocab_size}), second call equal; "
        f"decode vs prefill logits max_abs_err={err}; {prof}; decode kernel "
        f"at n_valid={DECODE_VALID}: kernel_us={1e3 * timed['ms']:.3f} "
        f"kernel_call_us={1e3 * timed['call_ms']:.3f} bound_us="
        f"{1e3 * timed['bound_ms']:.4f} ({timed['bound_by']}) plain_us="
        f"{1e3 * timed['plain_ms']:.3f} sdpa_us="
        f"{1e3 * timed['library_ms']:.3f}; max_abs_err={kerr} rel_l2="
        f"{krel}; at "
        f"n_valid={DECODE_LONG}: kernel_us={1e3 * long['ms']:.3f} bound_us="
        f"{1e3 * long['bound_ms']:.4f} ({long['bound_by']}) sdpa_us="
        f"{1e3 * long['library_ms']:.3f}"))
    return dict(launches=launches["flash_attention"], max_abs_err=kerr,
                decode=timed)


# ------------------------------------------------------------- Mamba-2

def ssd_bound_ms(b: int, s: int, h: int, g: int, n: int, p: int, q: int,
                 dtype) -> tuple[float, str]:
    """Least time for one ``ssd_scan`` call: x, B, C (in ``dtype``), dt,
    A and D read once, y written once; per head and chunk of q_c rows the
    TPU kernel's four products, 2·q_c²·N (C Bᵀ) + 2·q_c²·P + 2·2·q_c·N·P
    (C·state, the state update), at the card's peak for the inputs' type
    (bf16: the tensor cores; float32: the CUDA cores)."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * item + b * s * h * 4 \
        + 2 * h * 4
    rows = [min(q, s - c) for c in range(0, s, q)]
    flops = b * h * sum(2 * r * r * (n + p) + 4 * r * n * p for r in rows)
    rate = BF16_FLOPS_S if dtype == torch.bfloat16 else F32_FLOPS_S
    return roofline_ms(nbytes, flops, rate)


def ssd_inputs(gen, b, s, h, g, n, p, dtype, offset: int = 0,
               slow: bool = False):
    """x, dt, A, B, C, D on the card at tests/test_kernels.py's scales; x,
    B and C cut from one (b, s, offset + h·p + 2·g·n) buffer, as the model
    cuts them from xBC (``offset`` elements in: a misaligned view). With
    ``slow``, dt = softplus(0.5·randn - 5) (about 0.007) and D = 0, so that
    the state carried between chunks shows in y (see ``SSD_REL``)."""
    width = h * p + 2 * g * n
    buf = torch.empty((b, s, offset + width), dtype=dtype, device="cuda")
    buf[..., offset:offset + h * p] = 0.5 * torch.randn(
        (b, s, h * p), device="cuda", generator=gen)
    buf[..., offset + h * p:] = 0.3 * torch.randn(
        (b, s, 2 * g * n), device="cuda", generator=gen)
    xs, bs, cs = torch.split(buf[..., offset:], [h * p, g * n, g * n], -1)
    dt = torch.nn.functional.softplus(
        0.5 * torch.randn((b, s, h), device="cuda", generator=gen)
        - (5.0 if slow else 0.0))
    d = torch.linspace(0.1, 1.0, h, device="cuda")
    return (xs.reshape(b, s, h, p), dt,
            torch.linspace(0.5, 2.0, h, device="cuda"),
            bs.reshape(b, s, g, n), cs.reshape(b, s, g, n),
            torch.zeros_like(d) if slow else d)


def ssd_close(got, want, dtype, what: str) -> tuple[float, float]:
    """``got`` against ``want`` elementwise within ``SSD_TOL[dtype]`` and
    as a whole within ``SSD_REL[dtype]``; returns the max abs and the
    relative L2 difference."""
    err = close(got, want, *SSD_TOL[dtype], what)
    g, w = got.double(), want.double()
    rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
    if not rel <= SSD_REL[dtype]:
        raise AssertionError(f"{what}: relative L2 difference {rel} beyond "
                             f"{SSD_REL[dtype]}")
    return err, rel


def check_ssd_cases() -> float:
    """``ssd_scan`` against its plain version on the card, float32 and
    bfloat16, y and the final state, each within ``SSD_TOL`` and
    ``SSD_REL``, over tests/test_kernels.py's cases, ragged S, S below the
    chunk, G = 2, views at offsets 0 and 1 of one buffer, the full prefill
    shape, and slow-decay cases (``ssd_inputs``'s ``slow``) at the prefill
    shape and two ragged ones; inputs the kernel refuses must raise.
    Returns the largest abs difference of y."""
    gen = torch.Generator("cuda").manual_seed(21)
    cases = [(1, 64, 2, 1, 16, 16, 16, 0), (2, 96, 4, 2, 32, 32, 32, 0),
             (1, 128, 2, 1, 64, 64, 128, 0), (2, 100, 4, 1, 16, 24, 32, 1),
             (1, 20, 2, 1, 8, 8, 32, 0), (1, 48, 4, 2, 16, 16, 16, 1),
             (2, 300, 6, 2, 128, 64, 128, 1), (1, 1000, 3, 3, 40, 70, 128, 1),
             (1, PREFILL_S, 24, 1, 128, 64, 128, 0)]
    slow = cases[-3:]
    count, worst, st_worst = 0, 0.0, 0.0
    rels = {}
    for dtype in (torch.float32, torch.bfloat16):
        for decay, group in (("fast", cases), ("slow", slow)):
            for b, s, h, g, n, p, q, off in group:
                args = ssd_inputs(gen, b, s, h, g, n, p, dtype, off,
                                  slow=decay == "slow")
                assert off == 0 or args[0].data_ptr() % 16 != 0
                ks.ssd_scan.forms.clear()
                y, st = ks.ssd_scan(*args, chunk=q, return_state=True)
                torch.cuda.synchronize()
                want, want_st = ks.ssd_scan_ref(*args, chunk=q)
                what = (f"{dtype} {decay} {(b, s, h, g, n, p, q)} offset "
                        f"{off}")
                err, rel = ssd_close(y, want, dtype, what)
                st_err, st_rel = ssd_close(st, want_st, torch.float32,
                                           what + " state")
                worst, st_worst = max(worst, err), max(st_worst, st_err)
                key = (str(dtype).split(".")[-1], decay)
                was = rels.get(key, (0.0, 0.0))
                rels[key] = (max(was[0], rel), max(was[1], st_rel))
                if not torch.equal(ks.ssd_scan(*args, chunk=q), y):
                    raise AssertionError(f"{what}: y differs without the "
                                         f"state")
                ssd_forms(what, {ssd_form(dtype): 2})
                count += 1
                del args, y, st, want, want_st
    refused = 0
    for dtype, h, g in ((torch.float16, 4, 1), (torch.float32, 4, 3)):
        x = torch.zeros((1, 8, h, 8), dtype=dtype, device="cuda")
        bm = torch.zeros((1, 8, g, 8), dtype=dtype, device="cuda")
        v = torch.zeros((h,), device="cuda")
        try:
            ks.ssd_scan(x, torch.zeros((1, 8, h), device="cuda"), v, bm, bm,
                        v, chunk=4)
        except ValueError:
            refused += 1
    if refused != 2:
        raise AssertionError("ssd_scan took float16 or H % G != 0")
    torch.cuda.empty_cache()
    rel_note = ", ".join(f"{k[0]} {k[1]} {v[0]:.3g} (state {v[1]:.3g})"
                         for k, v in sorted(rels.items()))
    phase("ssd-kernel", (
        f"{count} cases within tests/test_kernels.py's tolerances (float32 "
        f"1e-4, bfloat16 5e-2) and relative L2 {SSD_REL[torch.float32]} / "
        f"{SSD_REL[torch.bfloat16]}: its three cases, ragged S (100, 300, "
        f"1000), S < Q, G = 2 and 3, N up to 128, P up to 70, views of one "
        f"xBC-like buffer at offsets 0 and 1 (misaligned), the prefill shape "
        f"(1, {PREFILL_S}, 24, 1, 128, 64, Q = 128), and slow decay with "
        f"D = 0 at S = 300, 1000 and {PREFILL_S}; float16 and H % G != 0 "
        f"raised; max_abs_err={worst}, final state max_abs_err={st_worst}; "
        f"largest relative L2 of y (and the state) by dtype and decay: "
        f"{rel_note}"))
    return worst


def mamba_replay(seed: int = 5) -> None:
    """The reduced mamba2-130m (2 layers) on the card against the same
    calls on the CPU, float32 then bfloat16: ``init_lm`` bit for bit,
    ``lm_forward`` logits over 80 tokens (5 chunks), ``generate``, and in
    float32 layer 0's kernel prefill state vs ``mamba_decode``'s."""
    notes = []
    with no_tf32():
        for dtype in ("float32", "bfloat16"):
            cfg = reduced(get_arch_config(MAMBA_ARCH), n_layers=2,
                          dtype=dtype)
            cpu = init_lm(cfg, jr.PRNGKey(seed), device="cpu")
            card = init_lm(cfg, jr.PRNGKey(seed))
            for (path, c), (_, g) in zip(tree_items(cpu), tree_items(card)):
                if not torch.equal(leaf_bits(c), leaf_bits(g.cpu())):
                    raise AssertionError(f"init_lm card != CPU at {path}")
            gpu = params_from_numpy(params_to_numpy(cpu))
            rng = np.random.default_rng(seed)
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 80)))
            reset_counts()
            lg = lm_forward(cfg, gpu, tok.cuda())[0]
            torch.cuda.synchronize()
            if counts() != dict(NO_KERNEL, ssd_scan=cfg.n_layers):
                raise AssertionError(f"lm_forward launches {counts()}")
            attention_forms(f"{dtype} mamba lm_forward", {})
            ssd_forms(f"{dtype} mamba lm_forward",
                      {ssd_form(getattr(torch, dtype)): cfg.n_layers})
            tol = SERVE_TOL[dtype] if dtype == "float32" else MAMBA_DEEP_TOL
            err = close(lg.cpu(), lm_forward(cfg, cpu, tok)[0], *tol,
                        f"{dtype} lm_forward")
            prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                    (3, 5)))
            gen = greedy_replay(cfg, gpu, cpu, prompts, 8, 32, None,
                                SERVE_TOL[dtype])
            note = (f"{dtype}: init_lm bit for bit; lm_forward "
                    f"max_abs_err={err}; generate 8: {gen}")
            if dtype == "float32":
                p0 = tree_map(lambda a: a[0], gpu["blocks"][0])["mamba"]
                u = torch.randn((2, 40, cfg.d_model), device="cuda",
                                generator=torch.Generator("cuda").manual_seed(
                                    seed))
                reset_counts()
                _, st = mamba_forward(p0, cfg, u, return_state=True)
                torch.cuda.synchronize()
                if counts() != dict(NO_KERNEL, ssd_scan=1):
                    raise AssertionError(f"mamba_forward launches {counts()}")
                ssd_forms("float32 mamba_forward", {"simt": 1})
                cache = init_mamba_cache(cfg, 2, torch.float32)
                for t in range(u.shape[1]):
                    mamba_decode(p0, cfg, u[:, t:t + 1], cache)
                serr = close(st, cache["state"], *SERVE_TOL["float32"],
                             "prefill state vs decode state")
                note += (f"; layer 0's kernel prefill state (40 tokens) vs "
                         f"40 decode steps max_abs_err={serr}")
            notes.append(note)
    phase("mamba-replay", (
        f"reduced {MAMBA_ARCH} (2 layers), card (kernel) vs CPU (plain "
        f"path), logits tolerance float32 {SERVE_TOL['float32']}, bfloat16 "
        f"forward {MAMBA_DEEP_TOL} and decode {SERVE_TOL['bfloat16']}: "
        + "; ".join(notes)))


def mamba_model():
    """mamba2-130m at its published widths, all 24 layers, bf16:
    ``init_lm`` from key 0 on the card."""
    cfg = get_arch_config(MAMBA_ARCH)
    t = time.perf_counter()
    params = init_lm(cfg, jr.PRNGKey(0))
    torch.cuda.synchronize()
    n = sum(v.numel() for _, v in tree_items(params))
    phase("mamba-init", (
        f"{MAMBA_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.ssm_heads} heads of {cfg.ssm_head_dim}, N {cfg.ssm_state}, "
        f"vocab {cfg.vocab_size} padded to {cfg.padded_vocab}, {cfg.dtype}: "
        f"{n} parameters in {time.perf_counter() - t:.2f}s"))
    return cfg, params


def mamba_prefill(cfg, params, seed: int = 22) -> dict:
    """``make_prefill_step`` over B = 1, S = 8192 tokens (64 chunks):
    wall, tokens/s, the kernel's launches (one a layer), layer 0's scan
    held against the plain version on its own inputs, and the kernel
    timed there (a CUDA graph) beside its bound and the plain version."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, PREFILL_S))).cuda()
    prefill = make_prefill_step(cfg)
    prefill(params, dict(tokens=tokens[:, :256]))         # warm-up
    reset_counts()
    t = time.perf_counter()
    logits = prefill(params, dict(tokens=tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = counts()
    if launches != dict(NO_KERNEL, ssd_scan=cfg.n_layers):
        raise AssertionError(f"mamba-prefill launches {launches}")
    attention_forms("mamba-prefill", {})
    ssd_forms("mamba-prefill", {"mma": cfg.n_layers})
    forms = dict(ks.ssd_scan.forms)
    if tuple(logits.shape) != (1, cfg.padded_vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("mamba-prefill logits not finite or misshapen")
    layer0 = tree_map(lambda a: a[0], params["blocks"][0])
    h = rmsnorm(params["embed"][tokens], layer0["norm_mix"], cfg.norm_eps)
    _, x, dt, a, bm, cm = mamba_scan_inputs(layer0["mamba"], cfg, h)
    args = (x, dt, a, bm, cm, layer0["mamba"]["D"])
    q = cfg.ssm_chunk
    got = ks.ssd_scan(*args, chunk=q)
    want, _ = ks.ssd_scan_ref(*args, chunk=q)
    err, rel = ssd_close(got, want, torch.bfloat16, "layer 0 prefill scan")
    del got, want, h
    bound_ms, bound_by = ssd_bound_ms(1, PREFILL_S, cfg.ssm_heads,
                                      cfg.ssm_groups, cfg.ssm_state,
                                      cfg.ssm_head_dim, q, x.dtype)
    ms = device_ms(lambda: ks.ssd_scan(*args, chunk=q), per_graph=5,
                   replays=4)
    serial = device_ms(lambda: ks._launch("simt", *args, q, False),
                       per_graph=5, replays=4)
    call = call_ms(lambda: ks.ssd_scan(*args, chunk=q), reps=10, warm=1)
    plain = call_ms(lambda: ks.ssd_scan_ref(*args, chunk=q), reps=3,
                    warm=1)
    del args, x, dt, bm, cm
    torch.cuda.empty_cache()
    phase("mamba-prefill", (
        f"{MAMBA_ARCH} at published widths, all {cfg.n_layers} layers, "
        f"bf16, B=1 S={PREFILL_S} ({PREFILL_S // q} chunks of {q}): wall "
        f"{1e3 * wall:.3f}ms, {PREFILL_S / wall:.1f} tokens/s; launches "
        f"{launches['ssd_scan']} {forms}; logits finite; layer 0 scan vs plain "
        f"max_abs_err={err} relative L2 {rel:.3g}; kernel_ms={ms:.4f} "
        f"kernel_call_ms={call:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"plain_ms={plain:.4f}; the serial simt design on the same bf16 "
        f"inputs serial_ms={serial:.4f}"))
    return dict(launches=launches["ssd_scan"], max_abs_err=err, ms=ms,
                call_ms=call, plain_ms=plain, bound_ms=bound_ms,
                bound_by=bound_by, wall_ms=1e3 * wall, serial_ms=serial)


def mamba_generate(cfg, params, seed: int = 23) -> dict:
    """``ServeEngine.generate`` at full width: 8 requests, 64-token
    prompts, 64 new tokens, ``max_len`` 256 (128 decode steps, no kernel:
    a Mamba decode step is the recurrence). Tokens in the vocabulary, a
    second call equal, the decode logits at the last prompt position
    against ``make_prefill_step``'s (which runs the kernel), held in
    float32 on the tree cast to float32 and reported in bf16; wall per
    step and a profile of 8 steps."""
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT))).cuda()
    engine = ServeEngine(cfg, params, max_len=GEN_MAX_LEN)
    steps = GEN_PROMPT + GEN_NEW
    reset_counts()
    t = time.perf_counter()
    first = engine.generate(prompts, GEN_NEW)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t
    launches = counts()
    if launches != NO_KERNEL:
        raise AssertionError(f"mamba-generate launches {launches}")
    attention_forms("mamba-generate", {})
    t = time.perf_counter()
    second = engine.generate(prompts, GEN_NEW)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t
    if tuple(first.shape) != (GEN_B, GEN_NEW) or not (
            0 <= int(first.min()) and int(first.max()) < cfg.vocab_size):
        raise AssertionError("mamba-generate tokens out of the vocabulary")
    if not torch.equal(first, second):
        raise AssertionError("mamba-generate: a second call differs")
    diffs = {}
    with no_tf32():
        for c, p in ((cfg, params), (cfg.replace(dtype="float32"),
                                     tree_map(lambda a: a.float(), params))):
            cache = init_cache(c, GEN_B, GEN_MAX_LEN)
            dec = make_decode_step(c)
            for i in range(GEN_PROMPT):
                lg, cache = dec(p, cache, prompts[:, i:i + 1], i)
            reset_counts()
            pre = make_prefill_step(c)(p, dict(tokens=prompts))
            torch.cuda.synchronize()
            if counts() != dict(NO_KERNEL, ssd_scan=c.n_layers):
                raise AssertionError(f"mamba-generate prefill launches "
                                     f"{counts()}")
            ssd_forms(f"mamba-generate {c.dtype} prefill",
                      {ssd_form(getattr(torch, c.dtype)): c.n_layers})
            a, b = lg[:, 0].float(), pre.float()
            diffs[c.dtype] = (
                float((a - b).abs().max()), float((a - b).norm() / b.norm()),
                float((a[:, :c.vocab_size].argmax(-1) == b[
                    :, :c.vocab_size].argmax(-1)).float().mean()))
            if c.dtype == "float32":
                err = close(a, b, *MAMBA_F32_TOL, "float32 decode vs "
                            "prefill logits at the last prompt position")
            del cache, p
    prof = profile_decode(params, cfg, prompts, GEN_MAX_LEN,
                          kernel="ssd_kernel")
    per_step = (wall1 + wall2) / 2 / steps
    phase("mamba-generate", (
        f"B={GEN_B}, prompt {GEN_PROMPT}, {GEN_NEW} new, max_len "
        f"{GEN_MAX_LEN}: wall {1e3 * wall1:.3f} / {1e3 * wall2:.3f}ms "
        f"(first / second call), {1e3 * per_step:.4f}ms per decode step, "
        f"{GEN_B * GEN_NEW / wall2:.1f} new tokens/s (second call); launches "
        f"{launches['ssd_scan']} (decode is the recurrence); tokens in [0, "
        f"{cfg.vocab_size}), second call equal; decode vs prefill logits at "
        f"the last prompt position (max abs, relative L2, argmax agreement): "
        f"float32 {diffs['float32']} within {MAMBA_F32_TOL}, bfloat16 "
        f"{diffs['bfloat16']} (reported); {prof}"))
    return dict(launches=launches["ssd_scan"], max_abs_err=err,
                wall_ms_per_step=1e3 * per_step)


# ------------------------------------------------- the replays' CPU side

def replay_case(kind: str) -> tuple:
    """``(p, cfg, task)`` of a replay phase's run: the CPU runs it free, the
    card replays the positions it moved through."""
    if kind == "replay":
        return paper_params(lam=0.05, M=1), SimConfig(n_slots=496), None
    if kind in ("logreg", "mlp"):
        lc = logreg_task() if kind == "logreg" else mlp_task()
        cfg = SimConfig(n_slots=496 if kind == "logreg" else 320, learn=lc)
        return (paper_params(**LEARN_PARAMS), cfg,
                learning.make_task(lc, "cpu"))
    if kind == "faults-dense":
        return (paper_params(lam=0.05, M=1),
                SimConfig(n_slots=304, faults=harsh()), None)
    if kind == "attack":
        lc = dataclasses.replace(logreg_task(), defense=robust_defense())
        return (paper_params(**LEARN_PARAMS),
                SimConfig(n_slots=304, faults=harsh_adversarial(), learn=lc),
                learning.make_task(lc, "cpu"))
    if kind == "zones-dense":
        return (paper_params(lam=0.05, M=1),
                SimConfig(n_slots=304, zones=three_zones()), None)
    if kind == "zones-32":
        return (paper_params(lam=0.05, M=1),
                SimConfig(n_slots=160, zones=grid_zones()), None)
    if kind in ("mob-rwp", "mob-manhattan", "mob-speed_range"):
        kw = {"mob-rwp": dict(mobility="rwp", pause_s=60.0),
              "mob-manhattan": dict(mobility="manhattan"),
              "mob-speed_range": dict(speed_range=(0.1, 1.9))}[kind]
        return paper_params(lam=0.05, M=1), SimConfig(n_slots=304, **kw), None
    if kind == "mob-learn":
        lc = logreg_task()
        return (paper_params(**LEARN_PARAMS),
                SimConfig(n_slots=160, mobility="manhattan", faults=harsh(),
                          learn=lc), learning.make_task(lc, "cpu"))
    if kind == "zones-learn":
        lc = logreg_task()
        return (paper_params(**LEARN_PARAMS),
                SimConfig(n_slots=160, faults=harsh(), learn=lc,
                          zones=TWO_ZONES), learning.make_task(lc, "cpu"))
    p, cfg = scaled_point(1024, {"cells-replay": 500, "faults-cells": 304,
                                 "zones-cells": 160, "mob-cells": 160}[kind])
    if kind == "mob-cells":
        cfg = dataclasses.replace(cfg, mobility="manhattan",
                                  contact_backend="cells")
    if kind == "faults-cells":
        cfg = dataclasses.replace(cfg, faults=harsh())
    if kind == "zones-cells":
        cfg = dataclasses.replace(cfg, zones=three_zones(cfg.area_side))
    return p, cfg, None


#: The replay phases, in the order the script reaches them.
REPLAYS = ("replay", "cells-replay", "logreg", "mlp", "faults-dense",
           "faults-cells", "attack") + tuple(ZONE_REPLAYS) + tuple(MOB_REPLAYS)


def side_phases(start: float) -> dict:
    """The phases that only check, never time: in a second process on the
    card (spawned), beside the main process's two long sweeps (mf-check's
    and faults-check's), which are bound by the host's launch rate, so two
    processes finish sooner than one. The replays' CPU runs go to a worker
    process of this one, queued at the start. ``start`` is the main
    process's clock origin (``time.perf_counter`` is one clock for all
    processes), so the phase lines' times agree. Returns faults-replay's
    and attack-replay's launches and differences, which enter the kernel
    record."""
    global _START
    _START = start
    torch.set_num_threads(2)
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        refs = {kind: pool.submit(cpu_reference, kind) for kind in REPLAYS}
        sweep_rows()
        sweep_reduce()
        check_replay(refs)
        cells_replay(refs)
        learn_replay(refs, "logreg")
        learn_replay(refs, "mlp")
        sweep_replay()
        faulted = faults_replay(refs)
        sweep_learn()
        cells_vs_dense()
        faulted["attack"] = attack_replay(refs)
        faulted["zones"] = zones_replay(refs)
        faulted["mobility"] = mobility_replay(refs)
        check_init_replay()
        check_round_replay()
        serve_replay()
        mamba_replay()
        torch.cuda.synchronize()
        return faulted
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def cpu_reference(kind: str, seed: int = 0) -> tuple:
    """A replay phase's CPU side, in a worker process: the free CPU run,
    the positions it moved through, and its wall seconds."""
    torch.set_num_threads(max(1, min(4, len(os.sched_getaffinity(0)) // 2)))
    p, cfg, task = replay_case(kind)
    t = time.perf_counter()
    out = simulate(p, cfg, seed=seed, device="cpu", task=task)
    track = mobility_track(cfg, seed=seed, device="cpu")
    return out, track, time.perf_counter() - t


def build_all() -> None:
    """One nvcc per kernel source, all started together."""
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(lambda build: build(),
                             (kc.build_library, gm.build_library,
                              kc.build_cell_library, fa.build_library,
                              ks.build_library)))
    phase("build", f"{', '.join(lib.name for lib in libs)} in "
                   f"{time.perf_counter() - t:.2f}s")


def scaled_point(n_total: int, n_slots: int):
    """The paper scenario at ``n_total`` nodes and fixed density (the
    dense points of the convergence figure)."""
    area = math.sqrt(n_total / DENSITY)
    r_rz = area / 2.0
    p = paper_params(lam=0.05, M=1).replace(
        N=DENSITY * math.pi * r_rz**2, alpha=2.0 * DENSITY * 1.0 * r_rz)
    cfg = SimConfig(n_nodes=n_total, area_side=area, rz_radius=r_rz,
                    n_slots=n_slots, sample_every=16)
    return p, cfg


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    cap = torch.cuda.get_device_capability(0)
    print(card_line(), flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]}, "
                    f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"need an sm_90 card, got sm_{cap[0]}{cap[1]}")

    build_all()
    floor_ms = launch_floor_ms()
    checks = dict(err=check_kernel_cases(floor_ms),
                  merge_worst=check_merge_cases(floor_ms),
                  flat_worst=check_flat_merge_cases(),
                  cell_worst=check_cell_cases(),
                  fault_worst=faults_kernel())
    an, sol = mf_analytics(), zipf_solution()
    # the checking phases go to a second process on the card (spawned: this
    # one holds a CUDA context) while this one runs the two long sweeps
    # and the contamination twin's sweeps to a third
    spawn = multiprocessing.get_context("spawn")
    side = concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn)
    twin = concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn)
    try:
        job = side.submit(side_phases, _START)
        twin_job = twin.submit(twin_phases, _START)
        finish_mf = mf_check(an)
        finish_zipf = faults_check(sol)
        sweeps = mobility_sweeps()
        faulted = job.result()
        (faulted["contam"], faulted["zones-check"],
         faulted["mobility-check"], faulted["dispatch"]) = twin_job.result()
        faulted["mobility-sweeps"] = sweeps
    finally:
        side.shutdown(wait=True, cancel_futures=True)
        twin.shutdown(wait=True, cancel_futures=True)
    # the other processes have ended: the card is quiet for what is timed
    return main_phases(floor_ms, checks, finish_mf, finish_zipf, faulted)


def main_phases(floor_ms: float, checks: dict, finish_mf, finish_zipf,
                faulted: dict) -> int:
    err, merge_worst, flat_worst, cell_worst, fault_worst = (
        checks[k] for k in ("err", "merge_worst", "flat_worst", "cell_worst",
                            "fault_worst"))
    main_run = finish_mf()
    zipf = finish_zipf()
    time_sweeps_shape(floor_ms)
    dense_run = free_run("dense-800", *scaled_point(800, 496))
    cell_run = cells_run()
    rows = learn_run()
    scaled = defended_run()
    attack_profiles()
    zone_profiles()
    mobility_profiles()
    params, default, state = gossip_replicas()
    check_gossip_round(params, default, state)
    flat = rounds_run(params, default, state)
    del params, default, state
    attn_worst = check_attention_cases()
    serve_cfg, serve_params = serve_model()
    pre = serve_prefill(serve_cfg, serve_params)
    gen = serve_generate(serve_cfg, serve_params)
    del serve_params
    ssd_worst = check_ssd_cases()
    mamba_cfg, mamba_params = mamba_model()
    mpre = mamba_prefill(mamba_cfg, mamba_params)
    mgen = mamba_generate(mamba_cfg, mamba_params)
    del mamba_params

    attack, contam = faulted["attack"], faulted["contam"]
    zones, zcheck = faulted["zones"], faulted["zones-check"]

    mob = faulted["mobility"]
    mcheck = [faulted["mobility-check"], faulted["mobility-sweeps"]]

    def zone_launches(name):
        return sum(run["launches"][name] for run in zones.values())

    def mob_launches(name):
        return sum(run["launches"][name] for run in mob.values())

    zone_err = max(run.get("max_abs_err", 0) for run in zones.values())
    mob_err = max(run["max_abs_err"] for run in mob.values())

    def merge_record(name, run, line, attack_launches):
        return dict(
            name=name, route="cuda", source="src/repro_torch/csrc/gossip_merge.cu",
            replaces=f"src/repro/kernels/gossip_merge.py:{line}",
            launches=(run["launches"] + attack_launches
                      + contam["launches"][name] + zone_launches(name)
                      + mob_launches(name)),
            max_abs_err=max(merge_worst, run["max_abs_err"],
                            attack["max_abs_err"], contam["max_abs_err"],
                            zone_err if name == "gossip_merge_rows" else 0,
                            mob_err if name == "gossip_merge_rows" else 0),
            ms=run["ms"], plain_ms=run["plain_ms"], bound_ms=run["bound_ms"],
            bound_by=run["bound_by"], library_ms=run["library_ms"])

    record = {"kernels": [dict(
        name="pairwise_contacts", route="cuda",
        source="src/repro_torch/csrc/contacts.cu",
        replaces="src/repro/kernels/contacts.py:299",
        launches=(main_run["launches"] + zipf["launches"]
                  + zone_launches("pairwise_contacts") + zcheck["launches"]
                  + mob_launches("pairwise_contacts")
                  + sum(run["launches"] for run in mcheck)
                  + faulted["dispatch"]["launches"]),
        max_abs_err=max(err, main_run["max_abs_err"],
                        dense_run["max_abs_err"], fault_worst,
                        zipf["max_abs_err"],
                        faulted["faults-dense"]["max_abs_err"], zone_err,
                        zcheck["max_abs_err"], mob_err,
                        *(run["max_abs_err"] for run in mcheck)),
        ms=main_run["ms"], plain_ms=main_run["plain_ms"],
        bound_ms=main_run["bound_ms"], bound_by=main_run["bound_by"],
        library_ms=None,
    ), merge_record("gossip_merge_rows", rows, 116, attack["rows_launches"]),
        merge_record("gossip_merge_rows_scaled", scaled, 173,
                     attack["scaled_launches"]), dict(
        name="cell_close_words", route="cuda",
        source="src/repro_torch/csrc/cells.cu",
        replaces="src/repro/kernels/contacts.py:473",
        launches=(cell_run["launches"] + faulted["faults-cells"]["launches"]
                  + zone_launches("cell_close_words")
                  + mob_launches("cell_close_words")),
        max_abs_err=max(cell_worst, cell_run["max_abs_err"], fault_worst,
                        faulted["faults-cells"]["max_abs_err"], zone_err,
                        mob_err),
        ms=cell_run["ms"], plain_ms=cell_run["plain_ms"],
        bound_ms=cell_run["bound_ms"], bound_by=cell_run["bound_by"],
        library_ms=None), dict(
        name="gossip_merge", route="cuda",
        source="src/repro_torch/csrc/gossip_merge.cu",
        replaces="src/repro/kernels/gossip_merge.py:96",
        launches=flat["launches"],
        max_abs_err=max(flat_worst, flat["max_abs_err"]), ms=flat["ms"],
        plain_ms=flat["plain_ms"], bound_ms=flat["bound_ms"],
        bound_by=flat["bound_by"], library_ms=flat["library_ms"]), dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:82",
        launches=pre["launches"] + gen["launches"],
        max_abs_err=max(attn_worst, pre["max_abs_err"], gen["max_abs_err"]),
        ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
        bound_by=pre["bound_by"], library_ms=pre["library_ms"]), dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:91",
        launches=mpre["launches"] + mgen["launches"],
        max_abs_err=max(ssd_worst, mpre["max_abs_err"]), ms=mpre["ms"],
        plain_ms=mpre["plain_ms"], bound_ms=mpre["bound_ms"],
        bound_by=mpre["bound_by"], library_ms=None)]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
