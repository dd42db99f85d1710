"""Tile-graph communication plans: the structure-compiled halo exchange.

Port of ``repro.core.commplan`` (pure numpy; every field equal to the JAX
package's).  Azul's NoC traffic follows the sparsity structure: a PE pulls
only the x words its stored nonzeros reference.  Given the stacked ELL
tiles of a ``core.partition`` plan, this module compiles once, on the
host:

* which remote u-shards each tile references (owners of the columns its
  stored nonzeros touch; padding masked out);
* a static **pull schedule**: the union over tiles of the shard offsets
  ("deltas") along the gather axis -- every tile runs the same hops, one
  per delta, receiving shard ``(tile + delta) mod p``;
* **halo-remapped column ids**: each tile's ELL columns rewritten to index
  the compact buffer ``[own shard, pulled shards...]``;
* the **modeled NoC bytes per iteration** of both layouts and the
  ``use_halo`` decision (halo only where it moves strictly fewer
  shard-words than the dense all-gather);
* the **interior/frontier row split** for communication hiding: a row is
  interior when every stored nonzero references the tile's own shard.
  The overlapped matvec computes interior rows against ``[own, zeros]``
  and frontier rows against the full halo buffer and adds the two; the
  split also gives the modeled overlap efficiency.

The port's engine (``repro_torch.core.engine``) holds every tile on one
device, so a hop is an index gather over the tile axis
(``repro_torch.core.noc``); the schedule, the remap and the model are the
JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "CommPlan",
    "compile_comm_plan_1d",
    "compile_comm_plan_2d",
    "halo_remap_cols",
]


class CommPlan(NamedTuple):
    """A compiled pull schedule for one partition (see module docstring).

    ``deltas``      static shard offsets along the pull axis: hop ``m``
                    ppermutes shard ``(tile + deltas[m]) mod pull_axis_size``
                    onto every tile (empty = purely local gather).
    ``cols_halo``   (tiles, rows_p, w) int32 ELL columns remapped into the
                    halo buffer ``concat([own, pulled...])``; padding
                    entries (vals == 0) map to 0.
    ``pull_axis_size``  tiles along the gather axis (P for 1d, pr for 2d).
    ``u``           words per exchanged vector shard.
    ``fixed_words`` per-tile words/SpMV moved by the stages shared between
                    the two layouts (2d: mesh transpose + output scatter).
    ``use_halo``    True when the halo schedule moves strictly fewer
                    gather-stage words than the dense all-gather.
    ``interior_mask``  (tiles, rows_p) bool: True for rows whose stored
                    nonzeros all reference the tile's own shard (every
                    halo-remapped column id < u) -- computable before the
                    pulled shards land.
    """

    mode: str                     # "1d" | "2d"
    deltas: tuple                 # sorted hop offsets, each in [1, p-1]
    cols_halo: np.ndarray         # (tiles, rows_p, w) int32
    pull_axis_size: int
    u: int
    itemsize: int
    fixed_words: int
    use_halo: bool
    interior_mask: np.ndarray | None = None   # (tiles, rows_p) bool
    interior_nnz: int = 0         # stored nonzeros in interior rows
    total_nnz: int = 0            # stored nonzeros, all rows

    @property
    def halo_width(self) -> int:
        return len(self.deltas)

    @property
    def gather_words_halo(self) -> int:
        return self.halo_width * self.u

    @property
    def gather_words_dense(self) -> int:
        return (self.pull_axis_size - 1) * self.u

    def bytes_per_iter(self, layout: str) -> int:
        """Modeled per-tile NoC bytes one SpMV moves under ``layout``
        (per RHS; the O(1) psum'd scalars of the dots are excluded)."""
        gather = (self.gather_words_halo if layout == "halo"
                  else self.gather_words_dense)
        return (self.fixed_words + gather) * self.itemsize

    @property
    def interior_frac_nnz(self) -> float:
        """Fraction of stored nonzeros in interior rows (the compute
        stream available to hide the pull stage behind)."""
        if not self.total_nnz:
            return 1.0
        return round(self.interior_nnz / self.total_nnz, 4)

    @property
    def overlap_interior_words(self) -> int:
        """Per-tile interior MACs a tile streams while its pulls fly --
        the time budget (1 word/cycle NoC, 1 MAC/cycle PE, the paper's
        normalization) available for hiding the gather stage."""
        tiles = max(self.cols_halo.shape[0], 1)
        return int(self.interior_nnz // tiles)

    @property
    def overlap_hidden_words(self) -> int:
        """Gather words the interior stream covers: min(gather, interior
        work).  The transpose/scatter stages stay exposed (they bound the
        SpMV's output, not its input)."""
        return min(self.gather_words_halo, self.overlap_interior_words)

    @property
    def overlap_exposed_words(self) -> int:
        """Gather words left on the critical path after overlap."""
        return self.gather_words_halo - self.overlap_hidden_words

    @property
    def overlap_efficiency(self) -> float:
        """hidden / gather in [0, 1]; 1.0 when there is nothing to pull."""
        g = self.gather_words_halo
        return round(self.overlap_hidden_words / g, 4) if g else 1.0

    def model(self) -> dict:
        """The benchmark/regression-gate record: plan choice, halo width,
        and both layouts' modeled traffic (host-deterministic, so the CI
        gate compares it exactly)."""
        dense = self.bytes_per_iter("dense")
        halo = self.bytes_per_iter("halo")
        return {
            "mode": self.mode,
            "pull_axis_size": int(self.pull_axis_size),
            "u": int(self.u),
            "halo_width": int(self.halo_width),
            "plan": "halo" if self.use_halo else "dense",
            "gather_words_halo": int(self.gather_words_halo),
            "gather_words_dense": int(self.gather_words_dense),
            "bytes_per_iter_halo": int(halo),
            "bytes_per_iter_dense": int(dense),
            "reduction": round(dense / halo, 3) if halo else float(dense > 0),
            "interior_frac_nnz": float(self.interior_frac_nnz),
            "overlap_interior_words": int(self.overlap_interior_words),
            "overlap_hidden_words": int(self.overlap_hidden_words),
            "overlap_exposed_words": int(self.overlap_exposed_words),
            "overlap_efficiency": float(self.overlap_efficiency),
        }


def _needed_shards(cols: np.ndarray, vals: np.ndarray, u: int,
                   p: int) -> np.ndarray:
    """(tiles, p) bool: does tile t's stored structure reference shard k?

    Only *stored* nonzeros count (vals != 0 masks ELL padding): a padded
    slot's column id is an artifact, not traffic.
    """
    tiles = cols.shape[0]
    owner = np.clip(cols // max(u, 1), 0, p - 1)
    need = np.zeros((tiles, p), dtype=bool)
    live = vals != 0
    for t in range(tiles):
        need[t, np.unique(owner[t][live[t]])] = True
    return need


def halo_remap_cols(cols: np.ndarray, vals: np.ndarray, u: int, p: int,
                    deltas: tuple, tile_coord: np.ndarray) -> np.ndarray:
    """Rewrite per-tile ELL columns from block-local ids into halo-buffer
    ids.  ``tile_coord[t]`` is tile t's coordinate along the pull axis; its
    own shard sits at halo slot 0, the shard pulled with ``deltas[m]``
    (i.e. shard ``(coord + deltas[m]) mod p``) at slot ``m + 1``."""
    slot_of = np.zeros((len(tile_coord), p), np.int64)
    for t, i in enumerate(tile_coord):
        slot_of[t, i] = 0
        for m, d in enumerate(deltas):
            slot_of[t, (i + d) % p] = m + 1
    shard = np.clip(cols // max(u, 1), 0, p - 1)
    within = cols % max(u, 1)
    out = slot_of[np.arange(cols.shape[0])[:, None, None], shard] * u + within
    # padding entries carry no value; pin them to 0 so gathers stay in-bounds
    return np.where(vals != 0, out, 0).astype(np.int32)


def _deltas_from_need(need: np.ndarray, tile_coord: np.ndarray,
                      p: int) -> tuple:
    """Union pull schedule: offsets d such that SOME tile references the
    shard d hops up its pull axis.  SPMD programs are uniform across tiles,
    so the union is what every tile executes."""
    ds: set = set()
    for t, i in enumerate(tile_coord):
        for k in np.flatnonzero(need[t]):
            d = int((k - i) % p)
            if d:
                ds.add(d)
    return tuple(sorted(ds))


def _interior_split(cols_halo: np.ndarray, vals: np.ndarray, u: int):
    """(mask, interior_nnz, total_nnz): the interior/frontier row split.

    A row is interior iff every *stored* nonzero's halo-remapped column
    lands in slot 0 (``col < u``, the tile's own shard); padding entries
    are already pinned to column 0 by :func:`halo_remap_cols`, so they
    never mark a row remote.  Mode-independent: slot 0 means "own shard"
    under both the 1d and 2d remaps.
    """
    live = np.asarray(vals) != 0
    remote = (cols_halo >= u) & live
    mask = ~remote.any(axis=2)
    total = int(live.sum())
    interior = int((live & mask[:, :, None]).sum())
    return mask, interior, total


def _decide(deltas: tuple, p: int) -> bool:
    """Halo pays only when it moves strictly fewer shard-words than the
    dense all-gather; ties (and p == 1) keep the single fused collective."""
    return 0 < p - 1 and len(deltas) < p - 1


def compile_comm_plan_1d(cols_pad: np.ndarray, vals: np.ndarray, u: int,
                         parts: int, itemsize: int = 4) -> CommPlan:
    """Compile the pull schedule of a 1D row partition.

    ``cols_pad``: (parts, rows_p, w) column ids in the *padded tile layout*
    (tile t, local r) = t*u + r -- i.e. the engine's 1D device layout, so
    the shard owner of a column is simply ``col // u``.
    """
    cols_pad = np.asarray(cols_pad)
    vals = np.asarray(vals)
    coord = np.arange(parts)
    need = _needed_shards(cols_pad, vals, u, parts)
    deltas = _deltas_from_need(need, coord, parts)
    cols_halo = halo_remap_cols(cols_pad, vals, u, parts, deltas, coord)
    mask, interior, total = _interior_split(cols_halo, vals, u)
    return CommPlan("1d", deltas, cols_halo, parts, u, itemsize,
                    fixed_words=0, use_halo=_decide(deltas, parts),
                    interior_mask=mask, interior_nnz=interior,
                    total_nnz=total)


def compile_comm_plan_2d(cols: np.ndarray, vals: np.ndarray, pr: int,
                         pc: int, u: int, itemsize: int = 4) -> CommPlan:
    """Compile the pull schedule of a 2D block partition.

    ``cols``: (pr*pc, br, w) column ids *local to column block J* (the
    partition plan's layout).  The dense path mesh-transposes x into L_col
    and all-gathers block J's pr u-shards along the row axes; the halo
    schedule pulls only the sub-shards tile (i, j)'s nonzeros reference --
    sub-shard k of block J lives (post-transpose) on tile (k, j), so the
    pull axis is the mesh row axis and tile (i, j)'s coordinate is i.

    ``fixed_words`` carries the stages both layouts share: the u-shard
    mesh transpose in and the (pc-1)/pc-scaled psum_scatter of the br
    output partials.
    """
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    tiles = pr * pc
    coord = np.asarray([t // pc for t in range(tiles)])   # row index i
    need = _needed_shards(cols, vals, u, pr)
    deltas = _deltas_from_need(need, coord, pr)
    cols_halo = halo_remap_cols(cols, vals, u, pr, deltas, coord)
    # transpose: one u-shard hop -- but on degenerate grids (pr == 1 or
    # pc == 1) the L_row -> L_col permutation is the identity and
    # noc.mesh_transpose elides it, so it costs nothing on the NoC;
    # scatter: ring reduce-scatter of br partials receives (pc-1) u-words
    fixed = (u if (pr > 1 and pc > 1) else 0) + (pc - 1) * u
    mask, interior, total = _interior_split(cols_halo, vals, u)
    return CommPlan("2d", deltas, cols_halo, pr, u, itemsize,
                    fixed_words=fixed, use_halo=_decide(deltas, pr),
                    interior_mask=mask, interior_nnz=interior,
                    total_nnz=total)
