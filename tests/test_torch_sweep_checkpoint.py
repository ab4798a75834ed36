"""Preemption-safe port sweeps: ``sweep.run(checkpoint_dir=, resume=)``
(mirrors ``tests/test_sweep_checkpoint.py`` for ``repro_torch``).

Checkpointing changes no result: a checkpointed sweep equals the plain
sweep bit for bit, and a killed-and-resumed sweep reproduces the
uninterrupted one from the surviving chunk files. A chunk that raises is
retried under the ``RetryPolicy``; one that exhausts it is NaN/zero-filled
and listed in ``failed_chunks``. Files from another sweep, or damaged
ones, are warned about and recomputed. The chunk files are ``repro``'s
format: each package reads the other's.
"""

import glob
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as rckpt
from repro.sim.dispatch import RetryPolicy as RRetryPolicy
from repro_torch.checkpoint import ckpt
from repro_torch.configs.fg_paper import paper_params
from repro_torch.sim import SimConfig, sweep
from repro_torch.sim.dispatch import RetryPolicy

CFG = SimConfig(n_nodes=40, n_slots=160, sample_every=8)
PS = [paper_params(lam=lam, M=1) for lam in (0.1, 0.2, 0.3)]
SEEDS = (0, 1)
KW = dict(seeds=SEEDS, reduce="mean", chunk_size=1, device="cpu")


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stats_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def _chunk_files(d):
    return sorted(glob.glob(os.path.join(str(d), "step_*.npz")))


def _flaky(monkeypatch, fail):
    """Patch the chunk worker: ``fail(n)`` (n = the dispatch count, from
    1) returns an exception to raise, a value to return, or None to run."""
    orig = sweep._chunk_worker
    state = {"n": 0}

    def patched(*args, **kwargs):
        worker = orig(*args, **kwargs)

        def wrapper(keys, p_chunk):
            state["n"] += 1
            what = fail(state["n"])
            if isinstance(what, Exception):
                raise what
            if what is not None:
                return what
            return worker(keys, p_chunk)

        return wrapper

    monkeypatch.setattr(sweep, "_chunk_worker", patched)


def test_checkpointed_sweep_bitwise_equals_plain(tmp_path):
    plain = sweep.run(PS, CFG, **KW)
    ck = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    _stats_equal(plain.stats, ck.stats)
    assert ck.failed_chunks == ()
    assert len(_chunk_files(tmp_path)) == ck.plan.n_chunks == 3


def test_kill_and_resume_bitwise(tmp_path):
    full = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    files = _chunk_files(tmp_path)
    os.remove(files[-1])
    os.remove(files[-1].replace(".npz", ".json"))
    resumed = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path),
                        resume=True)
    _stats_equal(full.stats, resumed.stats)
    assert resumed.failed_chunks == ()
    assert resumed.telemetry["chunks"][0] == {"attempts": 0, "resumed": True}
    assert resumed.telemetry["chunks"][2]["attempts"] == 1


def test_resume_skips_completed_chunks(tmp_path, monkeypatch):
    full = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    n_files = len(glob.glob(os.path.join(str(tmp_path), "*")))

    def boom(*a, **k):
        def worker(keys, p_chunk):
            raise AssertionError("resume dispatched a completed chunk")
        return worker

    monkeypatch.setattr(sweep, "_chunk_worker", boom)
    again = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path),
                      resume=True)
    _stats_equal(full.stats, again.stats)
    assert again.devices_used == 0
    assert len(glob.glob(os.path.join(str(tmp_path), "*"))) == n_files


def test_retry_recovers_a_transient_failure(tmp_path, monkeypatch):
    plain = sweep.run(PS, CFG, **KW)
    _flaky(monkeypatch, lambda n: RuntimeError("transient") if n == 1
           else None)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    assert any("attempt 1/2" in str(w.message) for w in rec)
    assert out.failed_chunks == () and out.coverage.all()
    _stats_equal(plain.stats, out.stats)


def test_persistent_failure_is_filled_and_masked(tmp_path, monkeypatch):
    plain = sweep.run(PS, CFG, **KW)
    _flaky(monkeypatch, lambda n: RuntimeError("persistent") if n <= 2
           else None)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    assert out.failed_chunks == (0,)
    assert list(out.coverage) == [False, True, True]
    assert any("NaN/zero-filled" in str(w.message) for w in rec)
    a = out.stats["availability"]
    assert np.all(np.isnan(a[0]))
    assert np.array_equal(a[1:], plain.stats["availability"][1:])
    assert len(_chunk_files(tmp_path)) == 2         # nothing saved for 0


def test_fingerprint_mismatch_rejected(tmp_path):
    sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    kw = dict(KW, seeds=(0, 1, 2))
    fresh = sweep.run(PS, CFG, **kw)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        resumed = sweep.run(PS, CFG, **kw, checkpoint_dir=str(tmp_path),
                            resume=True)
    assert any("fingerprint" in str(w.message) for w in rec)
    _stats_equal(fresh.stats, resumed.stats)


def test_checkpoint_trace_mode(tmp_path):
    """The trace sweep (``BatchSimOutputs``) checkpoints and resumes too."""
    kw = dict(KW, reduce="trace")
    plain = sweep.run(PS, CFG, **kw)
    sweep.run(PS, CFG, **kw, checkpoint_dir=str(tmp_path))
    os.remove(_chunk_files(tmp_path)[1])
    ck = sweep.run(PS, CFG, **kw, checkpoint_dir=str(tmp_path), resume=True)
    for k in ("availability", "busy_frac", "obs_birth", "obs_holders",
              "n_in_rz", "model_holders"):
        assert np.array_equal(getattr(plain, k), getattr(ck, k)), k


def test_corrupt_chunk_files_warned_and_recomputed(tmp_path):
    """A truncated npz, garbage bytes and a shape-drifted array are each
    skipped with a warning naming the chunk, then recomputed."""
    full = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    files = _chunk_files(tmp_path)
    blob = open(files[0], "rb").read()
    with open(files[0], "wb") as f:
        f.write(blob[: len(blob) // 2])
    with open(files[1], "wb") as f:
        f.write(b"\xffnot-an-npz\x00" * 32)
    data = dict(np.load(files[2]))
    key = next(k for k in data if k != "fingerprint")
    data[key] = np.zeros((1, 1, 7), data[key].dtype)
    with open(files[2], "wb") as f:
        np.savez(f, **data)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        resumed = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path),
                            resume=True)
    msgs = [str(w.message) for w in rec]
    for c in range(3):
        assert any(f"chunk {c}" in m for m in msgs), (c, msgs)
    assert any("unreadable or corrupt" in m for m in msgs)
    _stats_equal(full.stats, resumed.stats)
    assert resumed.failed_chunks == () and resumed.coverage.all()


def test_bitflip_caught_by_content_hash(tmp_path):
    full = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    target = _chunk_files(tmp_path)[1]
    data = dict(np.load(target))
    key = next(k for k in data if k != "fingerprint")
    arr = data[key].copy()
    flat = arr.reshape(-1).view(np.uint8)
    flat[len(flat) // 2] ^= 0xFF
    data[key] = arr
    with open(target, "wb") as f:
        np.savez(f, **data)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        resumed = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path),
                            resume=True)
    assert any("chunk 1" in str(w.message) and "hash" in str(w.message)
               for w in rec)
    _stats_equal(full.stats, resumed.stats)


def test_manifest_records_attempt_and_schema(tmp_path, monkeypatch):
    _flaky(monkeypatch, lambda n: RuntimeError("transient") if n == 1
           else None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    assert out.failed_chunks == ()
    metas = [ckpt.load_manifest(p)["meta"] for p in _chunk_files(tmp_path)]
    assert [m["chunk"] for m in metas] == [0, 1, 2]
    assert all(m["schema"] == "sweep-chunk-v1" for m in metas)
    assert all(m["fingerprint"] == metas[0]["fingerprint"] for m in metas)
    assert [m["attempt"] for m in metas] == [1, 0, 0]
    assert out.telemetry["chunks"][0]["attempts"] == 2
    assert out.telemetry["chunks"][1]["attempts"] == 1


def test_retry_policy_governs_attempts(tmp_path, monkeypatch):
    plain = sweep.run(PS, CFG, **KW)
    _flaky(monkeypatch, lambda n: RuntimeError("transient") if n <= 2
           else None)
    pol = RetryPolicy(max_attempts=3, backoff_base_s=0.01)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path),
                        retry_policy=pol)
    assert any("attempt 2/3" in str(w.message) for w in rec)
    assert out.failed_chunks == ()
    _stats_equal(plain.stats, out.stats)
    assert out.telemetry["chunks"][0]["attempts"] == 3


def test_retry_output_shape_validated(tmp_path, monkeypatch):
    """A retry that returns another schema is a failed attempt, and
    nothing of it reaches the checkpoint directory."""
    _flaky(monkeypatch, lambda n: RuntimeError("transient") if n == 1
           else ({"availability": np.zeros((1, 1))} if n == 2 else None))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path))
    assert out.failed_chunks == (0,)
    assert list(out.coverage) == [False, True, True]
    msgs = " ".join(str(w.message) for w in rec)
    assert "missing" in msgs
    monkeypatch.undo()
    resumed = sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path),
                        resume=True)
    assert resumed.failed_chunks == ()
    _stats_equal(sweep.run(PS, CFG, **KW).stats, resumed.stats)


@pytest.mark.parametrize("kw", [{}, dict(jitter=0.0),
                                dict(backoff_base_s=0.1, backoff_mult=3.0,
                                     backoff_max_s=2.0, jitter=0.9)])
def test_retry_policy_backoff_equals_repro(kw):
    got, want = RetryPolicy(**kw), RRetryPolicy(**kw)
    for attempt in range(0, 9):
        for key in ("", "abc:0", "f" * 64 + ":3"):
            assert got.backoff(attempt, key) == want.backoff(attempt, key)
    for bad in (dict(max_attempts=0), dict(heartbeat_s=5.0)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)


def test_port_and_repro_read_each_others_files(tmp_path):
    """A port file restores in ``repro`` and a ``repro`` file in the port,
    with meta, content hashes and a bfloat16 leaf; so does a sweep chunk
    file."""
    rng = np.random.default_rng(0)
    tree = {"b": {"x": rng.normal(size=(3, 4)).astype(np.float32),
                  "n": np.arange(5, dtype=np.int32)},
            "a": torch.tensor([1.5, -2.25], dtype=torch.bfloat16),
            "fingerprint": np.arange(8, dtype=np.uint8)}
    like = {"a": 0, "b": {"n": 0, "x": 0}, "fingerprint": 0}
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 7, tree,
                                meta={"who": "port"}, integrity=True,
                                atomic=True)
    got, step = rckpt.restore_checkpoint(path, like, verify=True)
    assert step == 7 and rckpt.load_manifest(path)["meta"] == {"who": "port"}
    np.testing.assert_array_equal(got["b"]["x"], tree["b"]["x"])
    np.testing.assert_array_equal(got["b"]["n"], tree["b"]["n"])
    assert str(got["a"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(got["a"], np.float32),
                                  [1.5, -2.25])

    rtree = {"b": {"x": jnp.asarray(tree["b"]["x"]),
                   "n": jnp.asarray(tree["b"]["n"])},
             "a": jnp.asarray([1.5, -2.25], jnp.bfloat16),
             "fingerprint": jnp.asarray(tree["fingerprint"])}
    rpath = rckpt.save_checkpoint(str(tmp_path / "repro"), 3, rtree,
                                  meta={"who": "repro"}, integrity=True,
                                  atomic=True)
    back, step = ckpt.restore_checkpoint(rpath, like, verify=True)
    assert step == 3 and ckpt.load_manifest(rpath)["meta"]["who"] == "repro"
    np.testing.assert_array_equal(back["b"]["x"], tree["b"]["x"])
    assert back["b"]["n"].dtype == np.int32
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], tree["a"])
    as_tensor, _ = ckpt.restore_checkpoint(rpath, dict(like, b={
        "n": torch.zeros(1, dtype=torch.int32), "x": 0}), verify=True)
    assert torch.is_tensor(as_tensor["b"]["n"])

    # a port sweep chunk, restored by repro with its content hashes checked
    sweep.run(PS, CFG, **KW, checkpoint_dir=str(tmp_path / "sweep"))
    chunk = _chunk_files(tmp_path / "sweep")[0]
    names = np.load(chunk).files
    r_tree, r_step = rckpt.restore_checkpoint(chunk, {k: 0 for k in names},
                                              verify=True)
    t_tree, t_step = ckpt.restore_checkpoint(chunk, {k: 0 for k in names},
                                             verify=True)
    assert r_step == t_step == 0
    for k in names:
        np.testing.assert_array_equal(np.asarray(r_tree[k]), t_tree[k])

    with pytest.raises(NotImplementedError, match="mesh"):
        ckpt.save_checkpoint(str(tmp_path), 0, tree, specs={"a": None})
    with pytest.raises(NotImplementedError, match="mesh"):
        ckpt.restore_checkpoint(path, like, mesh=object())
