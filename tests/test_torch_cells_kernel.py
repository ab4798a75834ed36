"""The plain version of the ``cell_close_words`` pass in
``repro_torch.kernels.contacts`` against ``repro``'s jitted oracle
``cell_close_words_ref`` and its Pallas kernel in interpret mode, bit for
bit, on the cases of ``tests/test_kernels.py`` plus ragged word counts,
dense cells and multi-bit zone words; threshold-placed pairs that only
``fma(dx, dx, dy*dy)`` rounds as the reference does; the padded-grid
layout helpers; a batch equal to its items; and the dispatch rule. The
CUDA kernel itself runs on the card only, where ``chip_smoke.py`` holds it
against this plain version."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import contacts as rk
from repro.sim.cells import CellGrid as RCellGrid
from repro.sim.cells import bin_nodes as r_bin_nodes
from repro_torch.kernels import contacts as tk

R_TX2 = 25.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count at these sizes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
_ref = jax.jit(rk.cell_close_words_ref, static_argnames=("ncx", "ncy"))


def _zone_words(member: np.ndarray) -> np.ndarray:
    return (member.astype(np.uint32)
            << np.arange(member.shape[1], dtype=np.uint32)).sum(
                -1, dtype=np.uint32)


def _planes(n, ncx, cap, *, k_zones=1, seed=0, area=200.0, spread=1.0):
    """Far-filled cell planes of ``n`` nodes binned by ``repro``: numpy
    ``(xc, yc, zc, idc)`` with ``zc`` uint32."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, area * spread, (n, 2))
    # every other node within 4 m of the one before it: close pairs exist
    pos[1::2] = np.clip(pos[0::2][:n // 2] + rng.uniform(-2.8, 2.8,
                                                         (n // 2, 2)),
                        0, area * spread)
    pos = pos.astype(np.float32)
    zw = _zone_words(rng.random((n, k_zones)) < 0.7)
    grid = RCellGrid(ncx=ncx, ncy=ncx, cell=area / ncx, cap_cell=cap,
                     nbr_cap=8)
    idc = np.array(r_bin_nodes(jnp.asarray(pos), grid)[0])
    safe, empty = np.clip(idc, 0, n - 1), idc < 0
    xc = np.where(empty, np.float32(1e9), pos[safe, 0]).astype(np.float32)
    yc = np.where(empty, np.float32(1e9), pos[safe, 1]).astype(np.float32)
    zc = np.where(empty, np.uint32(0), zw[safe]).astype(np.uint32)
    return xc, yc, zc, idc


def _torch_planes(*planes):
    xc, yc, zc, idc = planes
    return (torch.from_numpy(xc), torch.from_numpy(yc),
            torch.from_numpy(zc.view(np.int32)), torch.from_numpy(idc))


def _port(planes, ncx, ncy=None):
    words = tk.cell_close_words(*(t[None] for t in _torch_planes(*planes)),
                                ncx, ncy or ncx, R_TX2)
    return words[0].numpy().view(np.uint32)


CASES = [
    (30, 4, 4, 1, 200.0),     # tiny grid, most neighbourhoods on the border
    (120, 8, 8, 1, 200.0),    # cells larger than r_tx
    (120, 8, 8, 3, 200.0),    # multi-zone word gating
    (200, 39, 4, 1, 200.0),   # the paper geometry's grid (sparse cells)
    (64, 5, 2, 2, 200.0),     # tight cap (empty-slot handling)
    (40, 3, 1, 1, 9.0),       # cap 1: 9 candidates, one word
    (300, 3, 32, 5, 40.0),    # 288 candidates: full cells, nine words
    (400, 3, 40, 2, 40.0),    # 360 candidates: a ragged last word
]


@pytest.mark.parametrize("n,ncx,cap,k_zones,area", CASES)
def test_plain_matches_repro_oracle_and_pallas(n, ncx, cap, k_zones, area):
    planes = _planes(n, ncx, cap, k_zones=k_zones, seed=n + cap, area=area)
    got = _port(planes, ncx)
    want = np.asarray(_ref(*planes, ncx=ncx, ncy=ncx, r_tx2=R_TX2))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (ncx * ncx, cap, (9 * cap + 31) // 32)
    assert got.any()                         # some pairs are close
    if ncx <= 8:
        pallas = rk.cell_close_words(*planes, ncx, ncx, R_TX2,
                                     interpret=True)
        np.testing.assert_array_equal(got, np.asarray(pallas))


def test_ragged_word_pad_bits_are_zero():
    planes = _planes(400, 3, 40, seed=4, area=15.0)   # crowded cells
    got = _port(planes, 3)
    assert not np.any(got[..., -1] >> np.uint32((9 * 40) % 32))
    np.testing.assert_array_equal(
        got, np.asarray(_ref(*planes, ncx=3, ncy=3, r_tx2=R_TX2)))


def threshold_offsets(count: int, seed: int = 0) -> np.ndarray:
    """``(count, 2)`` float32 offsets whose close bit at r_tx = 5 differs
    between ``fma(dx, dx, dy*dy)`` and both the plain ``dx*dx + dy*dy``
    and the reversed ``fma(dy, dy, dx*dx)``."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, 200_000)
    dx = (5 * np.cos(th)).astype(np.float32)
    dy = (5 * np.sin(th)).astype(np.float32)
    fma = (dx.astype(np.float64) * dx + (dy * dy)).astype(np.float32)
    rev = (dy.astype(np.float64) * dy + (dx * dx)).astype(np.float32)
    inside = fma <= R_TX2
    pick = (inside != (dx * dx + dy * dy <= R_TX2)) & (inside != (rev <= R_TX2))
    return np.stack([dx, dy], -1)[pick][:count]


def _threshold_planes(cap: int = 96):
    """One interior cell: slot 0 at the origin, slots 1.. at threshold
    offsets from it (the border ring empty), so row 0's candidate ``s`` of
    the centre cell has ``dx, dy`` exactly the offset."""
    off = threshold_offsets(cap - 1)
    n_pad = 9
    xc = np.full((n_pad, cap), np.float32(1e9), np.float32)
    yc = xc.copy()
    zc = np.zeros((n_pad, cap), np.uint32)
    idc = np.full((n_pad, cap), -1, np.int32)
    xc[4, 0] = yc[4, 0] = 0.0
    xc[4, 1:], yc[4, 1:] = -off[:, 0], -off[:, 1]
    zc[4] = 1
    idc[4] = np.arange(cap)
    return (xc, yc, zc, idc), off


def test_threshold_pairs_round_as_one_fma():
    """Row 0's bits match the jitted reference (and the Pallas kernel) only
    with d² = fma(dx, dx, dy*dy): on these pairs the plain sum and the
    reversed FMA each flip every bit of the centre cell."""
    planes, off = _threshold_planes()
    cap = planes[0].shape[1]
    got = _port(planes, 1)
    np.testing.assert_array_equal(
        got, np.asarray(_ref(*planes, ncx=1, ncy=1, r_tx2=R_TX2)))
    np.testing.assert_array_equal(
        got, np.asarray(rk.cell_close_words(*planes, 1, 1, R_TX2,
                                            interpret=True)))
    bits = np.unpackbits(got[0, 0].view(np.uint8), bitorder="little")
    row0 = bits[4 * cap + 1:5 * cap].astype(bool)     # centre cell, slots 1..
    dx, dy = off[:, 0], off[:, 1]
    fma = (dx.astype(np.float64) * dx + dy * dy).astype(np.float32) <= R_TX2
    plain = dx * dx + dy * dy <= R_TX2
    rev = (dy.astype(np.float64) * dy + dx * dx).astype(np.float32) <= R_TX2
    np.testing.assert_array_equal(row0, fma)
    assert np.all(row0 != plain) and np.all(row0 != rev)
    assert 0 < row0.sum() < cap - 1                   # both sides of r_tx


def test_layout_helpers_equal_repro():
    for ncx, ncy in ((1, 1), (3, 5), (17, 17), (319, 319)):
        assert tuple(tk.cell_neighborhood_offsets(ncy).tolist()) == \
            rk.cell_neighborhood_offsets(ncy)
        np.testing.assert_array_equal(
            tk.interior_cell_ids(ncx, ncy).numpy(),
            np.asarray(rk.interior_cell_ids(ncx, ncy)))
        assert tk.padded_cell_id(ncx - 1, ncy - 1, ncy) == \
            int(rk.padded_cell_id(ncx - 1, ncy - 1, ncy))


def test_batch_equals_items():
    items = [_torch_planes(*_planes(120, 8, 8, k_zones=2, seed=s))
             for s in (1, 2)]
    stacked = tk.cell_close_words(
        *[torch.stack([it[i] for it in items]) for i in range(4)], 8, 8,
        R_TX2)
    for b, it in enumerate(items):
        single = tk.cell_close_words(*(t[None] for t in it), 8, 8, R_TX2)
        assert torch.equal(single[0], stacked[b])


def test_cpu_tensors_take_the_plain_version():
    before = tk.cell_close_words.launches
    _port(_planes(30, 4, 4), 4)
    assert tk.cell_close_words.launches == before


def test_other_devices_raise():
    planes = [t[None].to("meta") for t in _torch_planes(*_planes(30, 4, 4))]
    with pytest.raises(ValueError, match="unsupported device"):
        tk.cell_close_words(*planes, 4, 4, R_TX2)


def test_source_rounds_d2_as_one_fma():
    """The kernel computes the close bit as the plain version does."""
    src = tk.CELL_SOURCE.read_text()
    assert "__fmaf_rn(dx, dx, __fmul_rn(dy, dy))" in src
    assert "__fsub_rn(xi, sx[k])" in src and "__fsub_rn(yi, sy[k])" in src
    assert "__ballot_sync" in src
