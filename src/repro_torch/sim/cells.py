"""Cell-list (spatial-hash) contact detection (port of ``repro.sim.cells``).

The large-N alternative to the dense O(N²) sweep: the area is covered by a
uniform grid of square cells with side >= r_tx, so a close pair lies in the
same or an adjacent cell, and a node is compared only with the 3×3 cell
neighbourhood around it. Every function takes a leading batch axis ``B``.

1. :func:`bin_nodes` sorts nodes by cell (stably, so ids ascend within a
   cell) into a ``(B, n_pad_cells, cap_cell)`` buffer of node ids on a grid
   with an empty border ring.
2. :func:`neighbor_lists` builds the far-filled coordinate, zone and id
   planes of that buffer, runs the 3×3 close pass
   ``repro_torch.kernels.contacts.cell_close_words`` (the CUDA kernel on a
   CUDA tensor, its plain version on a CPU tensor), scatters the rows back
   to node order and compacts each row to an ascending, -1-padded list of
   ``nbr_cap`` neighbour ids. This is ``repro``'s kernel branch, on both
   devices; ``repro``'s node-centric gather branch gives the same bits.
3. :func:`candidate_best` picks each node's nearest *new* eligible
   neighbour (first minimum by id), the cells form of the dense argmin.

Both caps are static. A node past its cell's ``cap_cell`` sits out contact
detection for the slot, and a list past ``nbr_cap`` drops its highest ids;
both count into the per-slot overflow the engine carries as
``nbr_overflow`` (0 means detection was exact).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.contacts import (apply_access, cell_close_words,
                                          cell_neighborhood_offsets,
                                          interior_cell_ids, padded_cell_id)
from repro_torch.numerics import fma32
from repro_torch.sim.compute import unpack_mask
from repro_torch.sim.contacts import take_nodes

__all__ = [
    "CellGrid",
    "NeighborOverflowWarning",
    "contact_backend",
    "make_grid",
    "bin_nodes",
    "neighbor_lists",
    "candidate_best",
]


class NeighborOverflowWarning(UserWarning):
    """Cell-list contact detection dropped close pairs this run.

    A warning under ``SimConfig.overflow_mode="warn"`` (the default), a
    ``RuntimeError`` under ``"strict"``; the message carries the running
    per-slot max of dropped pairs."""


#: ``contact_backend="auto"`` switches to cells at this node count.
AUTO_CELLS_MIN_N = 1024

#: Fewest grid cells for which ``auto`` picks cells: below this the 3×3
#: neighbourhood covers most of the area.
_MIN_CELLS = 16

#: Coordinate of an empty slot in the cell planes: farther than r_tx from
#: every node.
_FAR = 1e9

#: The int32 "+inf" score of :func:`candidate_best`: above every
#: non-negative float32's bits.
_NO_SCORE = 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class CellGrid:
    """Static geometry of the uniform contact grid. ``cell >= r_tx``, and
    ``n_pad_cells = (ncx + 2) * (ncy + 2)`` counts the empty border ring."""

    ncx: int
    ncy: int
    cell: float
    cap_cell: int   # node-id slots per cell
    nbr_cap: int    # close-neighbour slots per node

    @property
    def n_cells(self) -> int:
        return self.ncx * self.ncy

    @property
    def n_pad_cells(self) -> int:
        return (self.ncx + 2) * (self.ncy + 2)

    def padded_cell_id(self, cx, cy):
        """Flattened padded-grid id of interior cell ``(cx, cy)``."""
        return padded_cell_id(cx, cy, self.ncy)


def _auto_caps(n_nodes: int, area_side: float, r_tx: float,
               cell: float) -> tuple[int, int]:
    """(cap_cell, nbr_cap) with a 6σ Poisson margin over the uniform
    density."""
    mu_cell = n_nodes * cell * cell / (area_side * area_side)
    cap_cell = max(4, math.ceil(mu_cell + 6.0 * math.sqrt(mu_cell) + 6.0))
    mu_nbr = n_nodes * math.pi * r_tx * r_tx / (area_side * area_side)
    nbr_cap = max(8, math.ceil(mu_nbr + 6.0 * math.sqrt(mu_nbr) + 8.0))
    return cap_cell, nbr_cap


def make_grid(cfg) -> CellGrid:
    """The :class:`CellGrid` of a ``SimConfig``: the most cells per axis
    with ``cell >= r_tx``, one fewer when the margin is under
    ``1e-4 * r_tx``; ``cfg.cell_cap`` / ``cfg.nbr_cap`` override the caps."""
    ncx = max(1, int(math.floor(cfg.area_side / cfg.r_tx)))
    if ncx > 1 and cfg.area_side / ncx - cfg.r_tx < 1e-4 * cfg.r_tx:
        ncx -= 1
    cell = cfg.area_side / ncx
    cap_cell, nbr_cap = _auto_caps(cfg.n_nodes, cfg.area_side, cfg.r_tx, cell)
    if getattr(cfg, "cell_cap", None) is not None:
        cap_cell = int(cfg.cell_cap)
    if getattr(cfg, "nbr_cap", None) is not None:
        nbr_cap = int(cfg.nbr_cap)
    return CellGrid(ncx=ncx, ncy=ncx, cell=cell, cap_cell=cap_cell,
                    nbr_cap=nbr_cap)


def contact_backend(cfg) -> str:
    """Resolve ``cfg.contact_backend`` to ``"dense"`` or ``"cells"``:
    ``"auto"`` picks cells from :data:`AUTO_CELLS_MIN_N` nodes up, when the
    grid :func:`make_grid` builds has at least ``_MIN_CELLS`` cells."""
    mode = getattr(cfg, "contact_backend", "auto")
    if mode in ("dense", "cells"):
        return mode
    if mode != "auto":
        raise ValueError(f"unknown contact_backend {mode!r}; known: 'dense', "
                         "'cells', 'auto'")
    if (cfg.n_nodes >= AUTO_CELLS_MIN_N
            and make_grid(cfg).n_cells >= _MIN_CELLS):
        return "cells"
    return "dense"


def bin_nodes(pos: torch.Tensor, grid: CellGrid):
    """Bin ``(B, N, 2)`` positions into the padded cell buffer:
    ``(cellbuf, pcid, binned, bin_overflow)``.

    * ``cellbuf`` ``(B, n_pad_cells, cap_cell)`` int32 node ids, -1 empty,
      ascending within a cell;
    * ``pcid`` ``(B, N)`` int64 padded-grid cell of each node;
    * ``binned`` ``(B, N)`` bool, the node made it into the buffer (a node
      that did not sits out contact detection this slot);
    * ``bin_overflow`` ``(B,)`` int32, the number of nodes left out.

    ``pos // cell`` is ``torch.floor_divide``, bit for bit ``repro``'s
    jitted ``//`` also on cell edges."""
    b, n, _ = pos.shape
    cap, n_slots = grid.cap_cell, grid.n_pad_cells * grid.cap_cell
    cell = torch.full((), grid.cell, dtype=torch.float32, device=pos.device)
    cx = torch.floor_divide(pos[..., 0], cell).to(torch.int32).clamp(
        0, grid.ncx - 1)
    cy = torch.floor_divide(pos[..., 1], cell).to(torch.int32).clamp(
        0, grid.ncy - 1)
    pcid = grid.padded_cell_id(cx.to(torch.int64), cy.to(torch.int64))

    order = torch.argsort(pcid, dim=-1, stable=True)   # ids ascend in-cell
    sorted_cid = torch.gather(pcid, 1, order)
    # rank within the cell: position minus the first index of the same id
    first = torch.searchsorted(sorted_cid, sorted_cid, side="left")
    rank = torch.arange(n, device=pos.device) - first
    kept = rank < cap
    # ranks past the cap go to one spare slot, sliced off after the scatter
    slot = torch.where(kept, sorted_cid * cap + rank, n_slots)
    flat = torch.full((b, n_slots + 1), -1, dtype=torch.int32,
                      device=pos.device)
    flat.scatter_(1, slot, order.to(torch.int32))
    cellbuf = flat[:, :n_slots].contiguous().reshape(b, grid.n_pad_cells, cap)
    binned = torch.zeros((b, n), dtype=torch.bool,
                         device=pos.device).scatter_(1, order, kept)
    bin_overflow = (n - binned.sum(-1)).to(torch.int32)
    return cellbuf, pcid, binned, bin_overflow


def _compact_sorted(cand: torch.Tensor, closebit: torch.Tensor,
                    nbr_cap: int):
    """The ``(B, N, nbr_cap)`` ascending, -1-padded neighbour lists of the
    candidate ids ``cand`` whose ``closebit`` is set, and the per-node
    count of entries cut by the cap."""
    n = cand.shape[-2]
    key = torch.where(closebit, cand.to(torch.int64), n)
    skey = torch.sort(key, dim=-1).values[..., :nbr_cap]
    nbr = torch.where(skey < n, skey, -1).to(torch.int32)
    dropped = (closebit.sum(-1) - nbr_cap).clamp(min=0)
    return nbr, dropped


def neighbor_lists(pos, zonew, grid: CellGrid, r_tx2, access=None):
    """Per-node close-neighbour lists via the cell grid: ``(nbr,
    overflow)``.

    ``nbr`` is ``(B, N, nbr_cap)`` int32: the ids of the nodes within r_tx
    that share a zone (``zonew`` the ``(B, N)`` int32 zone words),
    ascending, -1-padded. ``overflow`` ``(B,)`` int32 counts the nodes left
    out of the cell buffer plus the list entries cut by ``nbr_cap``.
    ``access`` (``(B, N)`` bool, or None) is folded into the zone word."""
    zonew = apply_access(zonew, access)
    b, n = zonew.shape
    cap = grid.cap_cell
    ncand = 9 * cap
    cellbuf, pcid, _, bin_overflow = bin_nodes(pos, grid)

    # cell-major planes; empty slots far away, in no zone
    empty = cellbuf < 0
    safe = cellbuf.clamp(0, n - 1).reshape(b, -1)
    xy = take_nodes(pos, safe).reshape(*cellbuf.shape, 2)
    xc = torch.where(empty, _FAR, xy[..., 0])
    yc = torch.where(empty, _FAR, xy[..., 1])
    zc = torch.where(empty, 0, take_nodes(zonew, safe).reshape(cellbuf.shape))
    words = cell_close_words(xc, yc, zc, cellbuf, grid.ncx, grid.ncy, r_tx2)

    # rows back to node order through a spare row (a node left out of the
    # buffer has no row: its close bits stay zero)
    nw = words.shape[-1]
    ids = cellbuf[:, interior_cell_ids(grid.ncx, grid.ncy, pos.device)]
    dest = torch.where(ids >= 0, ids, n).reshape(b, -1).to(torch.int64)
    rows = torch.zeros((b, n + 1, nw), dtype=torch.int32, device=pos.device)
    rows.scatter_(1, dest[..., None].expand(-1, -1, nw),
                  words.reshape(b, -1, nw))
    closebit = unpack_mask(rows[:, :n], ncand)

    # the kernel's candidate axis of a node: the 3×3 scan of its cell
    offs = cell_neighborhood_offsets(grid.ncy, pos.device)
    nbr_cells = (pcid[..., None] + offs).reshape(b, -1)          # (B, 9N)
    cand = torch.gather(cellbuf, 1, nbr_cells[..., None].expand(-1, -1, cap))
    cand = cand.reshape(b, n, ncand)

    nbr, dropped = _compact_sorted(cand, closebit, grid.nbr_cap)
    overflow = (bin_overflow + dropped.sum(-1)).to(torch.int32)
    return nbr, overflow


def candidate_best(pos, nbr, prev_nbr, elig):
    """Per-run stage: each node's best *new*-contact candidate, ``(best,
    has)``.

    Neighbour ``j`` of node ``i`` is a candidate iff it is not in ``i``'s
    previous list and both are eligible; the winner has the least d² (as
    int32 bits, ``fma(dx, dx, dy*dy)``), ties to the first slot, which is
    the lowest id. ``best`` is -1 where there is no candidate."""
    b, n, k = nbr.shape
    j = nbr.clamp(0, n - 1).reshape(b, -1)
    pj = take_nodes(pos, j).reshape(b, n, k, 2)
    dx = pos[..., 0, None] - pj[..., 0]
    dy = pos[..., 1, None] - pj[..., 1]
    d2 = fma32(dx, dx, dy * dy)
    was_close = (nbr[..., :, None] == prev_nbr[..., None, :]).any(-1)
    cand = ((nbr >= 0) & ~was_close & elig[..., None]
            & take_nodes(elig, j).reshape(b, n, k))

    score = torch.where(cand, d2.view(torch.int32), _NO_SCORE)
    best_score = score.min(-1).values
    has = best_score != _NO_SCORE
    lanes = torch.arange(k, dtype=torch.int64, device=nbr.device)
    slot = torch.where(score == best_score[..., None], lanes, k).min(-1).values
    best = torch.gather(nbr, -1, slot.clamp(max=k - 1)[..., None])[..., 0]
    return torch.where(has, best, -1), has

