"""The port's dispatched sweep under chaos (mirrors
``tests/test_dispatch_chaos.py`` for ``repro_torch``, on ``device="cpu"``).

For any chaos schedule (worker kills, hangs, SIGSTOP freezes, slowdowns,
corrupt result writes, worker exceptions) the dispatcher returns either

* reductions **equal bit for bit** to the port's own in-process
  ``sweep.run`` (chunk programs are pure functions of (chunk, spec), so
  re-runs and duplicates reproduce exactly), or
* a **correctly masked subset**: the uncovered ``coverage`` rows are
  exactly the quarantined chunks' scenarios, every covered row equals the
  fault-free value bit for bit, and the quarantine record carries the
  worker's traceback.

``repro``'s own chaos tests cannot be the oracle on this JAX (its sweep
fails in ``shared_barrier``, and a patch in the test does not reach its
worker processes); the port's in-process sweep is.
``tests/test_torch_dispatch_resume.py`` holds the cases beyond
``repro``'s: replay, resume in either direction, and ``cuda`` without a
card.

Workers are real processes (``python -m repro_torch.sim.dispatch``);
torch is held to one thread in them (``OMP_NUM_THREADS``, inherited) and
here. Every dispatched run bounds itself: short lease TTLs and stall
timeouts, and hang, freeze and slow lengths that the coordinator's
shutdown kills.
"""

import glob
import json
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs.fg_paper import paper_params
from repro_torch.sim import SimConfig, dispatch, sweep

CFG = SimConfig(n_nodes=40, n_slots=160, sample_every=8)
PS = [paper_params(lam=lam, M=1) for lam in (0.1, 0.2, 0.3)]
KW = dict(seeds=(0, 1), reduce="mean", chunk_size=1, device="cpu")

# short but safe timings: heartbeats are threads, and expiry needs the
# coordinator to have *seen* the lease past the TTL, so a short TTL does
# not flap on a loaded host
POLICY = dispatch.RetryPolicy(max_attempts=3, lease_ttl_s=3.0,
                              heartbeat_s=0.3, stall_timeout_s=60.0)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return sweep.run(PS, CFG, **KW)
    finally:
        torch.set_num_threads(prev)


def _dispatch(tmp_path, chaos=None, policy=POLICY, **over):
    kw = dict(KW, **over)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return dispatch.run_dispatched(
            PS, CFG, kw.pop("seeds"), queue_dir=str(tmp_path / "q"),
            chaos=chaos, retry_policy=policy, workers=2, **kw)


def _assert_bitwise(ref, out, rows=slice(None)):
    assert set(ref.stats) == set(out.stats)
    for k in ref.stats:
        a, b = np.asarray(ref.stats[k]), np.asarray(out.stats[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert np.array_equal(a[rows], b[rows], equal_nan=True), k


def test_clean_dispatch_bitwise_with_full_coverage(reference, tmp_path):
    out = _dispatch(tmp_path)
    _assert_bitwise(reference, out)
    assert out.host_bytes == reference.host_bytes
    assert out.coverage.dtype == bool and out.coverage.all()
    assert out.quarantined == () and out.failed_chunks == ()
    tel = out.telemetry
    assert set(tel["chunks"]) == {0, 1, 2}
    for c, tc in tel["chunks"].items():
        assert tc["attempts"] == 1 and tc["requeues"] == 0, (c, tc)
        assert tc["latency_s"] > 0.0
    assert tel["expired_leases"] == 0 and tel["corrupt_results"] == 0
    # the queue's layout is repro's, xla_cache included (left empty)
    qd = tmp_path / "q"
    assert {p.name for p in qd.iterdir()} >= {
        "todo", "leases", "results", "failures", "quarantine", "spec.pkl",
        "DONE", "xla_cache"}
    assert not any((qd / "xla_cache").iterdir())
    assert len(glob.glob(str(qd / "results" / "step_*.npz"))) == 3


def test_killed_and_hung_workers_recover_bitwise(reference, tmp_path):
    """SIGKILL mid-task and a heartbeat-stopped hang both surface as
    expired leases; the chunks re-run and the study is exact."""
    chaos = [dispatch.chaos_directive(0, 0, "kill"),
             dispatch.chaos_directive(1, 0, "hang", seconds=60.0)]
    out = _dispatch(tmp_path, chaos=chaos)
    _assert_bitwise(reference, out)
    assert out.coverage.all() and out.quarantined == ()
    tel = out.telemetry
    assert tel["chunks"][0]["requeues"] >= 1
    assert tel["chunks"][1]["requeues"] >= 1
    assert tel["chunks"][2]["requeues"] == 0  # the untouched chunk
    assert tel["expired_leases"] >= 2
    assert tel["respawns"] >= 1


def test_frozen_worker_lease_expires_and_chunk_recovers(reference,
                                                        tmp_path):
    """SIGSTOP freezes the heartbeat thread with the process: the
    coordinator must expire the lease and re-dispatch."""
    chaos = [dispatch.chaos_directive(2, 0, "freeze", seconds=60.0)]
    out = _dispatch(tmp_path, chaos=chaos)
    _assert_bitwise(reference, out)
    assert out.coverage.all() and out.quarantined == ()
    assert out.telemetry["chunks"][2]["requeues"] >= 1
    assert out.telemetry["expired_leases"] >= 1


def test_corrupt_write_detected_and_slow_worker_duplicated(reference,
                                                           tmp_path):
    """A garbage result write must be hash-rejected and recomputed; a slow
    but heartbeating worker must get a straggler duplicate whose first
    completed result wins, bit for bit."""
    chaos = [dispatch.chaos_directive(1, 0, "corrupt"),
             dispatch.chaos_directive(0, 0, "slow", seconds=45.0)]
    policy = dispatch.RetryPolicy(
        max_attempts=3, lease_ttl_s=60.0, heartbeat_s=0.3,
        straggler_min_done=2, straggler_quantile=0.5, straggler_factor=1.5)
    out = _dispatch(tmp_path, chaos=chaos, policy=policy)
    _assert_bitwise(reference, out)
    assert out.coverage.all() and out.quarantined == ()
    tel = out.telemetry
    assert tel["corrupt_results"] >= 1
    assert tel["chunks"][1]["requeues"] >= 1
    # the slow chunk was never killed (its lease outlives the test), so
    # only a duplicate can have finished it
    assert tel["chunks"][0]["duplicates"] >= 1
    assert tel["expired_leases"] == 0


def test_poison_chunk_quarantined_with_masked_coverage(reference, tmp_path):
    """A chunk that fails on every attempt is quarantined (rows masked
    out of coverage, covered rows exact, the traceback recorded); it never
    sinks the sweep."""
    chaos = [dispatch.chaos_directive(2, a, "raise")
             for a in range(POLICY.max_attempts)]
    out = _dispatch(tmp_path, chaos=chaos)
    assert out.quarantined == (2,)
    assert out.failed_chunks == (2,)
    assert list(out.coverage) == [True, True, False]
    _assert_bitwise(reference, out, rows=slice(0, 2))
    # masked rows are fill, not stale data: NaN for float stats
    for k, v in out.stats.items():
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            assert np.isnan(v[2]).all(), k
    rec = out.telemetry["quarantine"][2]
    assert rec["attempts"] == POLICY.max_attempts
    assert "chaos: injected failure" in rec["last_failure"]["error"]
    assert "Traceback" in rec["last_failure"]["traceback"]
    with open(tmp_path / "q" / "quarantine" / "chunk_00002.json") as f:
        assert json.load(f)["attempts"] == POLICY.max_attempts


def test_chaos_directive_validation():
    with pytest.raises(ValueError):
        dispatch.chaos_directive(0, 0, "explode")
    with pytest.raises(ValueError, match="workers"):
        dispatch.run_dispatched(PS, CFG, (0,), workers=0, device="cpu")
