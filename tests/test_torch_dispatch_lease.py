"""Lease-queue primitives of ``repro_torch.sim.dispatch`` (mirrors
``tests/test_dispatch_lease.py`` for the port).

The claim protocol is one atomic ``os.rename``:

1. of any number of concurrent claimers of one task, exactly one wins;
2. a lease stops being renewed the moment its owner stops running: a
   SIGSTOPped worker freezes its heartbeat thread with it, the lease's age
   crosses ``lease_ttl_s``, and the coordinator-side release (remove and
   re-enqueue) makes the chunk claimable again.

Plus ``RetryPolicy``'s backoff (deterministic jitter, exponential growth,
a cap) and its validation, and the queue's files read the same in both
packages: a task enqueued by ``repro`` is claimed by the port with the
same ``{chunk, attempt, dup}`` and the reverse, and the backoff equals
``repro``'s for the same key and attempt.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from repro.sim import dispatch as rdispatch
from repro_torch.sim import dispatch
from repro_torch.sim.dispatch import RetryPolicy


def _mk_queue(tmp_path):
    qd = str(tmp_path / "queue")
    dispatch._init_queue(qd)
    return qd


# ------------------------------------------------------- claim atomicity

def test_concurrent_claimers_exactly_one_wins(tmp_path):
    qd = _mk_queue(tmp_path)
    dispatch.enqueue_task(qd, chunk=7, attempt=1)

    n = 16
    barrier = threading.Barrier(n)
    wins: list[dict] = []
    lock = threading.Lock()

    def claim(i):
        barrier.wait()  # the most rename contention
        got = dispatch.claim_task(qd, f"w{i}")
        if got is not None:
            with lock:
                wins.append(got)

    threads = [threading.Thread(target=claim, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    assert len(wins) == 1
    assert (wins[0]["chunk"], wins[0]["attempt"], wins[0]["dup"]) == (7, 1, 0)
    assert os.path.exists(wins[0]["lease"])
    assert os.listdir(os.path.join(qd, "todo")) == []


def test_claim_lowest_chunk_first_and_name_roundtrip(tmp_path):
    qd = _mk_queue(tmp_path)
    for c, a, d in [(3, 0, 0), (1, 2, 0), (2, 1, 3)]:
        dispatch.enqueue_task(qd, c, a, dup=d)
        name = dispatch._task_name(c, a, d) + ".task"
        assert dispatch._parse_task_name(name) == (c, a, d)
    # failure-record and sidecar names parse too
    assert dispatch._parse_task_name("chunk_00002.a1d3.json") == (2, 1, 3)
    assert dispatch._parse_task_name(
        "chunk_00001.a2.lease.owner.json") == (1, 2, 0)

    order = [dispatch.claim_task(qd, "w")["chunk"] for _ in range(3)]
    assert order == [1, 2, 3]
    assert dispatch.claim_task(qd, "w") is None


def test_fresh_claim_mtime_is_now_not_task_age(tmp_path):
    """A rename keeps the mtime, so the claim stamps the lease: a lease
    claimed long after its task was enqueued must not look expired."""
    qd = _mk_queue(tmp_path)
    task = dispatch.enqueue_task(qd, 0, 0)
    stale = time.time() - 3600.0
    os.utime(task, (stale, stale))
    got = dispatch.claim_task(qd, "w")
    assert time.time() - os.stat(got["lease"]).st_mtime < 5.0


# --------------------------------------------------- heartbeats and expiry

def test_heartbeat_renews_until_paused(tmp_path):
    lease = str(tmp_path / "chunk_00000.a0.lease")
    open(lease, "w").close()
    old = time.time() - 100.0
    os.utime(lease, (old, old))

    hb = dispatch._Heartbeat(lease, interval=0.05)
    try:
        time.sleep(0.3)
        assert time.time() - os.stat(lease).st_mtime < 1.0  # renewed
        hb.pause()
        time.sleep(0.1)  # let a beat in flight land
        frozen = os.stat(lease).st_mtime
        time.sleep(0.3)
        assert os.stat(lease).st_mtime == frozen  # no renewal while paused
    finally:
        hb.stop()


_STOPPED_WORKER = r"""
import sys, time
from repro_torch.sim import dispatch
qd = sys.argv[1]
task = dispatch.claim_task(qd, "stopme")
assert task is not None
hb = dispatch._Heartbeat(task["lease"], interval=0.05)
print("CLAIMED", flush=True)
time.sleep(600)
"""


@pytest.mark.skipif(not hasattr(signal, "SIGSTOP"), reason="needs SIGSTOP")
def test_sigstopped_worker_lease_expires_and_releases(tmp_path):
    """SIGSTOP freezes the whole process, heartbeat thread included, so the
    lease's mtime ages past the TTL, and the coordinator-side release
    (remove the lease, re-enqueue) makes the chunk claimable again."""
    qd = _mk_queue(tmp_path)
    dispatch.enqueue_task(qd, 0, 0)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in sys.path if p) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", _STOPPED_WORKER, qd],
        stdout=subprocess.PIPE, env=env, text=True)
    try:
        assert proc.stdout.readline().strip() == "CLAIMED"
        lease = os.path.join(qd, "leases", "chunk_00000.a0.lease")
        assert os.path.exists(lease)
        assert dispatch._lease_owner(lease)["pid"] == proc.pid

        os.kill(proc.pid, signal.SIGSTOP)
        ttl = 0.6
        time.sleep(3 * ttl)
        age = time.time() - os.stat(lease).st_mtime
        assert age > ttl, "frozen worker kept heartbeating?"

        # coordinator-side release: remove the expired lease, re-enqueue
        # the chunk at the next attempt, claimable by anyone again
        dispatch._remove_lease(lease)
        dispatch.enqueue_task(qd, 0, 1)
        got = dispatch.claim_task(qd, "w2")
        assert got is not None and (got["chunk"], got["attempt"]) == (0, 1)
    finally:
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=10)
        if proc.stdout is not None:
            proc.stdout.close()


# ------------------------------------------------------------ retry policy

def test_backoff_deterministic_monotone_capped():
    pol = RetryPolicy(max_attempts=8, backoff_base_s=0.25, backoff_mult=2.0,
                      backoff_max_s=2.0, jitter=0.5)
    delays = [pol.backoff(k, key="fp:3") for k in range(1, 9)]
    assert delays == [pol.backoff(k, key="fp:3") for k in range(1, 9)]
    bases = [min(0.25 * 2.0 ** (k - 1), 2.0) for k in range(1, 9)]
    for d, b in zip(delays, bases):
        assert b <= d < 1.5 * b  # jitter in [0, 0.5) of the base
    assert pol.backoff(1, key="a") != pol.backoff(1, key="b")
    nojit = RetryPolicy(jitter=0.0)
    assert nojit.backoff(3) == min(0.25 * 4.0, nojit.backoff_max_s)


def test_retry_policy_validation():
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(heartbeat_s=2.0, lease_ttl_s=1.0)


# ------------------------------------------------------- across packages

@pytest.mark.parametrize("writer", ["repro", "port"])
def test_queue_files_read_the_same_in_both_packages(tmp_path, writer):
    """A task one package enqueues, the other claims with the same
    ``{chunk, attempt, dup}``, lowest chunk first; both leave the same
    lease and owner files."""
    enq, claim = ((rdispatch, dispatch) if writer == "repro"
                  else (dispatch, rdispatch))
    qd = str(tmp_path / "queue")
    rdispatch._init_queue(qd)
    assert sorted(os.listdir(qd)) == sorted(dispatch._DIRS)
    tasks = [(4, 0, 0), (2, 1, 0), (9, 2, 1)]
    for c, a, d in tasks:
        enq.enqueue_task(qd, c, a, dup=d)
        assert enq._task_name(c, a, d) == claim._task_name(c, a, d)
    got = [claim.claim_task(qd, "x") for _ in tasks]
    assert [(g["chunk"], g["attempt"], g["dup"]) for g in got] == \
        sorted(tasks)
    for g in got:
        owner = enq._lease_owner(g["lease"])
        assert owner["worker"] == "x" and owner["pid"] == os.getpid()
        enq._remove_lease(g["lease"])
    assert claim.claim_task(qd, "x") is None
    assert os.listdir(os.path.join(qd, "leases")) == []


def test_backoff_and_chaos_equal_repro():
    kw = dict(max_attempts=8, backoff_base_s=0.3, backoff_mult=1.7,
              backoff_max_s=5.0, jitter=0.4)
    mine, theirs = RetryPolicy(**kw), rdispatch.RetryPolicy(**kw)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(RetryPolicy()) == \
        dataclasses.asdict(rdispatch.RetryPolicy())
    for key in ("", "fp:0", "ab12cd:7"):
        for attempt in range(0, 10):
            assert mine.backoff(attempt, key=key) == \
                theirs.backoff(attempt, key=key)
    for act in dispatch._CHAOS_ACTIONS:
        assert dispatch.chaos_directive(3, 1, act, 2.5) == \
            rdispatch.chaos_directive(3, 1, act, 2.5)
    assert dispatch._CHAOS_ACTIONS == rdispatch._CHAOS_ACTIONS
    assert set(rdispatch.__all__) <= set(dispatch.__all__)
