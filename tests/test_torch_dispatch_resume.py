"""The port's dispatched sweep beyond ``repro``'s chaos cases (on
``device="cpu"``; the shared fixtures are ``tests/test_torch_dispatch_
chaos.py``'s):

1. a dispatched ``mobility="replay"`` sweep: the positions travel in the
   spec as numpy, and the workers replay them bit for bit;
2. an in-process ``sweep.run(checkpoint_dir=, resume=True)`` finishing a
   dispatched study whose coordinator stopped after some chunks were
   published, and a dispatched ``resume=True`` finishing an in-process
   study: the chunk files are the same files;
3. a sweep dispatched for ``cuda`` on a host without one ends in
   ``DispatchError`` and publishes nothing (no fallback to the CPU).
"""

import glob
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro_torch.sim import SimConfig, dispatch, sweep
from repro_torch.sim.engine import mobility_track
from test_torch_dispatch_chaos import (CFG, KW, POLICY, PS,  # noqa: F401
                                       _assert_bitwise, _dispatch, one_thread,
                                       reference)


def test_dispatched_replay_sweep_bitwise(tmp_path):
    """``mobility="replay"``: the positions travel in the spec as numpy and
    each worker replays them on its own device."""
    free = SimConfig(n_nodes=40, n_slots=96, sample_every=8)
    cfg = SimConfig(n_nodes=40, n_slots=96, sample_every=8,
                    mobility="replay")
    seeds = (3, 4)
    track = np.stack([mobility_track(free, seed=s, device="cpu")
                      for s in seeds])
    # the replayed frames are not the free run's: the workers must use them
    track = np.mod(track + np.float32(37.0), np.float32(200.0))
    kw = dict(reduce="final", chunk_size=2, device="cpu", positions=track)
    want = sweep.run(PS, cfg, seeds, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = sweep.run(PS, cfg, seeds, workers=2, retry_policy=POLICY,
                        queue_dir=str(tmp_path / "q"), **kw)
    _assert_bitwise(want, got)
    assert got.coverage.all() and got.plan == want.plan
    free_run = sweep.run(PS, free, seeds, reduce="final", chunk_size=2,
                         device="cpu")
    assert not np.array_equal(free_run.stats["n_in_rz"],
                              got.stats["n_in_rz"])


def test_in_process_resume_finishes_a_stopped_dispatch(reference, tmp_path):
    """The coordinator stops (a stall, with chunk 2's worker hung) after
    chunks 0 and 1 were published; the in-process sweep resumes from those
    very files and computes only chunk 2."""
    ck = str(tmp_path / "ck")
    # the stall fires once chunks 0 and 1 are in and chunk 2's lease stays
    # fresh; 20 s covers the workers' start and a chunk on a loaded host
    stall = dispatch.RetryPolicy(max_attempts=3, lease_ttl_s=60.0,
                                 heartbeat_s=0.3, stall_timeout_s=20.0)
    with pytest.raises(dispatch.DispatchError, match="stalled"):
        _dispatch(tmp_path, chaos=[dispatch.chaos_directive(
            2, 0, "hang", seconds=60.0)], policy=stall, checkpoint_dir=ck)
    files = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(ck, "step_*.npz")))
    assert files == ["step_00000000.npz", "step_00000001.npz"]
    out = sweep.run(PS, CFG, **KW, checkpoint_dir=ck, resume=True)
    _assert_bitwise(reference, out)
    chunks = out.telemetry["chunks"]
    assert chunks[0].get("resumed") and chunks[1].get("resumed")
    assert not chunks[2].get("resumed")


def test_dispatch_resumes_an_in_process_study(reference, tmp_path):
    """The reverse: an in-process checkpointed sweep loses a chunk file; a
    dispatched ``resume=True`` reuses the others and publishes the missing
    one, the same arrays and content hashes as the in-process file."""
    ck = str(tmp_path / "ck")
    sweep.run(PS, CFG, **KW, checkpoint_dir=ck)
    lost = os.path.join(ck, "step_00000001")
    with np.load(lost + ".npz") as z:
        before = {k: z[k] for k in z.files}
    with open(lost + ".json") as f:
        manifest = json.load(f)
    for ext in (".npz", ".json"):
        os.remove(lost + ext)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = sweep.run(PS, CFG, **KW, checkpoint_dir=ck, resume=True,
                        workers=2, retry_policy=POLICY)
    _assert_bitwise(reference, out)
    chunks = out.telemetry["chunks"]
    assert chunks[0].get("resumed") and chunks[2].get("resumed")
    assert not chunks[1].get("resumed") and chunks[1]["attempts"] == 1
    with np.load(lost + ".npz") as z:
        after = {k: z[k] for k in z.files}
    assert set(after) == set(before)
    for k in before:
        assert np.array_equal(after[k], before[k]), k
    with open(lost + ".json") as f:
        remade = json.load(f)
    assert remade["leaves"] == manifest["leaves"]
    assert remade["meta"]["schema"] == manifest["meta"]["schema"]
    assert remade["meta"]["fingerprint"] == manifest["meta"]["fingerprint"]
    assert os.path.isdir(os.path.join(ck, ".queue", "todo"))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_cuda_dispatch_without_a_card_raises(tmp_path):
    """No fallback: workers asked for ``cuda`` where there is none raise
    before claiming, the pool spends its respawns, and the coordinator
    raises ``DispatchError``; nothing is computed or published."""
    policy = dispatch.RetryPolicy(max_attempts=3, lease_ttl_s=3.0,
                                  heartbeat_s=0.3, max_respawns=1,
                                  stall_timeout_s=60.0)
    qd = tmp_path / "q"
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with pytest.raises(dispatch.DispatchError, match="respawn budget"):
            sweep.run(PS[:1], CFG, (0,), reduce="mean", workers=1,
                      device="cuda", retry_policy=policy, queue_dir=str(qd))
    assert any("no CUDA device" in str(w.message) for w in seen)
    assert list((qd / "results").iterdir()) == []
    assert list((qd / "leases").iterdir()) == []
    # the task was never claimed
    assert [p.name for p in (qd / "todo").iterdir()] == [
        "chunk_00000.a0.task"]
