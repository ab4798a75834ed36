"""The contamination twin against the port's own attack sweeps (CPU).

``benchmarks/fig_adversarial.py``'s three ``signflip(0.1)`` rows at its
learning-smoke geometry (48 nodes in a 100 m square, 960 slots, seeds 0
and 1 as one B = 2 sweep), run by the port on the CPU through
``chip_smoke.attack_row``, the helpers ``chip_smoke.py``'s ``contam-twin``
phase runs on the card:

* ``chip_smoke``'s ``smoke_params``, ``_measured_eta`` and
  ``_twin_prediction`` equal the benchmark's on the same telemetry (rel
  1e-5; the twin solved by ``repro`` there and by the port here);
* the undefended and trimmed rows ignite on at least one seed and the twin
  predicts their tail ``poisoned_frac`` within the figure's ``TOL`` (15%);
* the clipped row's error is the one ``repro``'s twin makes on the same
  telemetry, and it is above ``TOL``: the reference's compartment model
  misses the norm-clipped arm (ROADMAP, "Defects of the reference that the
  port copies"). A fix of the model shows here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from benchmarks import fig_adversarial as fa
from repro.configs import fg_adversarial as rfa
from repro.configs.fg_paper import paper_contact_model as r_contact_model
from repro_torch.configs.fg_paper import paper_contact_model

RTOL = 1e-5


@pytest.fixture(scope="module")
def rows():
    """The three arms' B = 2 sweeps on the CPU (about 10 s each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {arm: cs.attack_row(d, device="cpu")
                for arm, d in cs.ADV_ARMS.items()}
    finally:
        torch.set_num_threads(threads)


def test_geometry_and_gates_are_the_figures():
    assert cs.ADV_CFG_KW == fa.CFG_KW
    assert (cs.ADV_TOL, cs.ADV_TAIL, cs.ADV_IGNITE) == (
        fa.TOL, fa.TAIL, fa.IGNITE)
    assert (cs.ADV_LAM, cs.ADV_LAM_OBS) == (fa.LAM, fa.LAM_OBS)
    assert list(cs.ADV_ARMS) == list(fa.ARMS)
    for arm, d in cs.ADV_ARMS.items():
        ref = fa.ARMS[arm]
        assert (d is None) == (ref is None)
        if d is not None:
            assert dataclasses.asdict(d) == dataclasses.asdict(ref)
    p, rp = cs.smoke_params(), fa.smoke_params()
    for f in dataclasses.fields(rp):
        if f.name not in ("zones", "faults"):
            assert getattr(p, f.name) == getattr(rp, f.name), f.name


def test_measured_eta_is_the_figures():
    rng = np.random.default_rng(28)
    for _ in range(20):
        ms = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
        assert cs._measured_eta(ms) == fa._measured_eta(ms)
    assert cs._measured_eta(np.zeros((2, 6), np.int32)) == 1.0


@pytest.mark.parametrize("arm", list(cs.ADV_ARMS))
def test_twin_on_the_ports_rows(rows, arm):
    row = rows[arm]
    assert row["pf_seed"].shape == (len(cs.ADV_SEEDS),)
    assert np.all((row["pf_seed"] >= 0.0) & (row["pf_seed"] <= 1.0))
    if arm in cs.ADV_GATED:
        assert row["ign"].any(), row["pf_seed"]
    if row["poisoned"] is None:
        return
    x = cs.row_twin(row, paper_contact_model(device="cpu"))
    x_ref = fa._twin_prediction(
        fa.smoke_params(), r_contact_model(), rfa.signflip(frac=0.1),
        eta=row["eta"], t=row["t"], attempts_cum=row["attempts_cum"],
        n_nodes=cs.ADV_CFG_KW["n_nodes"])
    np.testing.assert_allclose(x, x_ref, rtol=RTOL)
    err = abs(x - row["poisoned"]) / row["poisoned"]
    err_ref = abs(x_ref - row["poisoned"]) / row["poisoned"]
    np.testing.assert_allclose(err, err_ref, rtol=RTOL, atol=1e-7)
    if arm in cs.ADV_GATED:
        assert err <= cs.ADV_TOL, (arm, x, row["poisoned"])
    else:
        # the reference's defect, copied: its twin misses the clipped arm
        assert err > cs.ADV_TOL, (arm, x, row["poisoned"])
