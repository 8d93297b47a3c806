"""Fused batched reservoir rollout: the generic banded kernel (B1).

T steps of paper Eq. 1 for a whole state batch:

    x(n) = (1 - leak) * x(n-1) + leak * f(u(n) @ W_in + x(n-1) @ W)
    y(n) = x(n) @ W_out                                       (optional, Eq. 2)

The recurrent reduction is driven by the plan's static per-band term lists
(:meth:`repro_torch.plan.ExecutionPlan.rollout_layout`): culled blocks —
and, in int8 mode, culled digit plane-blocks — never appear, the analogue
of the paper's synthesis-time adder culling.  Two modes share one kernel:

* ``fp32`` — dequantized tiles in IEEE fp32 FMAs; on the card each
  output's rows split over a thread block's warps and lanes into fixed
  partial sums, reduced in a fixed tree (an order set by the grid and the
  table, never by the batch), in the twin in ascending row order;
* ``int8`` — exact digit-plane arithmetic: the state batch is requantized
  every step and each term is a shifted int32 plane-tile product; on the
  card a table sparse enough (:func:`pack_blocks`' rule) instead folds
  every term of a column into one (row, weight) list, the same int32 sums.

This module holds what both rollout kernels share — the host tables, their
per-thread-block packing and grid choice, the launch of the persistent
kernel (all T steps in one cooperative launch, the readout fused) and the
plain PyTorch twin of one step — and the B1 entry point
:func:`reservoir_rollout` with its twin :func:`reservoir_rollout_plain`.
A CUDA tensor goes through the kernel (``csrc/rollout.cu``) or raises; a
CPU tensor takes the twin, the port's analogue of Pallas
``interpret=True``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.sparse import int_matmul_exact
from repro_torch.kernels._build import check
from repro_torch.kernels._launch import (MAX_SMEM, check_f32, require_cuda,
                                         same_device, stream, unit_stride)
from repro_torch.kernels.reservoir_rollout import _cuda
from repro_torch.plan.specialize import MM

__all__ = ["BlockShares", "RolloutGrid", "RolloutTables", "blocks_per_sm",
           "build_tables", "generic_schedules", "io_macs", "launch_counts",
           "pack_blocks", "plain_recurrent_product", "plan_grid",
           "readout_path", "reservoir_rollout", "reservoir_rollout_plain",
           "rollout_grid", "rollout_readout_plain", "smem_bytes"]

# The persistent kernel's geometry (csrc/rollout.cu).
_MMA_ROWS = 16                # batch rows per tile: the MMA's M
_MMA_COLS = 8                 # output columns per MMA: N
_MMA_DEPTH = 32               # rows per MMA: K
_BAR_BYTES = 16               # the mbarrier at the head of shared memory
_ALIGN = 16                   # bulk copies move multiples of 16 bytes
_MAX_DIGIT_COLS = 1 << 8      # a digit word's column field: bits 16-23
_MAX_READOUT_COLS = 32 * 32   # the shared readout: a warp's lanes, 32 each
_THREADS = 256                # threads per block
_WARPS = _THREADS // 32
_LIST_ROW_BITS = 16           # a list word: state row in bits 0-15, the
_LIST_WEIGHT_MAX = 1 << 15    # signed weight in bits 16-31
# The list form is taken when the longest column's entries per lane are at
# most this many times the dense form's MMA units per warp (at least one),
# both the largest over the grid's blocks.  From B2 alone on the card at
# 1-25 % nonzeros, dims 1,024 and 4,096, batches 1, 4 and 16 (the readings
# in tools/probe_rollout_forms.py): the lists were at least as fast at
# every batch at ratios 0.62, 1.0 (twice) and 2.12, and slower at batch 16
# at 2.0 (dim 1,024, 2 %) and above; between 1.0 and 2.0, so every table
# that takes the lists is at least as fast at every batch measured.
_LISTS_PER_MMA_UNIT = 1.5
_FORMS = {"fp32": 0, "mma": 1, "lists": 2}      # rollout_run's `form`


@dataclasses.dataclass(frozen=True)
class RolloutTables:
    """A rollout schedule lowered into tables for one device.

    ``terms_host`` rows are ``(0, tile, shift, row_block)`` for a tile
    product and ``(1, row_block, digit_lo, digit_hi)`` for a shift-add
    group whose ``(i, j, sign, w)`` digits sit in
    ``digits[digit_lo:digit_hi]``; ``col_ptr_host[ci]:col_ptr_host[ci + 1]``
    are output column block ``ci``'s terms, in schedule order.
    ``data_host`` flattens the banded data to ``(n_bands * max_terms,
    block, block)``; :func:`pack_blocks` cuts each thread block's share
    for the kernel from it.  ``tiles`` and ``digits`` are the same arrays
    on ``device``, made at first use: only the twin reads them.
    """

    mode: str
    block: int
    n_col_blocks: int
    device: torch.device
    data_host: np.ndarray
    digits_host: np.ndarray
    col_ptr_host: tuple
    terms_host: tuple
    n_matmul_terms: int
    n_digits: int
    # (device, n_blocks) -> (RolloutGrid, device operands); filled at launch
    grids: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)
    # "tiles" / "digits" on the device; filled when the twin first runs
    _twin_operands: dict = dataclasses.field(default_factory=dict,
                                             compare=False, repr=False)

    def _on_device(self, name: str, host: np.ndarray) -> torch.Tensor:
        if name not in self._twin_operands:
            self._twin_operands[name] = torch.as_tensor(host,
                                                        device=self.device)
        return self._twin_operands[name]

    @property
    def tiles(self) -> torch.Tensor:
        return self._on_device("tiles", self.data_host)

    @property
    def digits(self) -> torch.Tensor:
        return self._on_device("digits", self.digits_host)

    @property
    def int8(self) -> bool:
        return self.mode == "int8"

    @property
    def rows_pad(self) -> int:
        return self.n_col_blocks * self.block


def generic_schedules(band_plans: tuple) -> tuple:
    """B1's ``(slot, shift, row_block)`` band plans as MM-tagged terms."""
    return tuple(tuple((ci, tuple((MM, slot, shift, ri)
                                  for slot, shift, ri in terms))
                       for ci, terms in band)
                 for band in band_plans)


def build_tables(schedules: tuple, data: np.ndarray, *, mode: str,
                 n_col_blocks: int, device) -> RolloutTables:
    """Pack MM/SA-tagged band schedules + banded tile data for ``device``."""
    n_bands, max_terms, bk, _ = data.shape
    per_col: list[list[tuple]] = [[] for _ in range(n_col_blocks)]
    digits: list[tuple] = []
    for bi, band in enumerate(schedules):
        for ci, terms in band:
            for term in terms:
                if term[0] == MM:
                    _tag, slot, shift, ri = term
                    per_col[ci].append((0, bi * max_terms + slot, shift, ri))
                else:
                    _tag, ri, dgs = term
                    lo = len(digits)
                    digits.extend(dgs)
                    per_col[ci].append((1, ri, lo, len(digits)))
    col_ptr = np.cumsum([0] + [len(c) for c in per_col])
    rows = [t for col in per_col for t in col]
    digits_host = np.asarray(digits, np.int32).reshape(-1, 4)
    data_host = data.reshape(n_bands * max_terms, bk, bk)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return RolloutTables(
        mode=mode, block=bk, n_col_blocks=n_col_blocks, device=device,
        data_host=data_host, digits_host=digits_host,
        col_ptr_host=tuple(int(c) for c in col_ptr),
        terms_host=tuple(rows),
        n_matmul_terms=sum(1 for r in rows if r[0] == 0),
        n_digits=len(digits))


# -- per-block packing and the grid -------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockShares:
    """Every thread block's share of a table, for one grid size.

    Block ``k`` owns columns ``c0 .. c0 + cw`` of column block
    ``k // slices`` (``c0`` = that block's first column + ``(k % slices)
    * cw``).  Its share sits at byte ``meta[k, 0]`` of ``blob``, padded to
    16 bytes for the bulk copy, in one of two forms (``form``), the same
    for every block:

    * ``"mma"`` (fp32 tables always): the column block's MM terms as int32
      ``(row block, shift)`` pairs (padded to 16 bytes), then its ``cw``
      columns of every MM term's tile in that order — int8 tiles as
      m16n8k32 B fragments (``(term, 32-row chunk, 8-column group)`` x 256
      bytes, lane ``l``'s 8 bytes at ``8 l``), fp32 tiles as ``(term,
      8-column group, row, column)`` floats (a warp reads 4 rows of a
      group as 32 consecutive floats) — then its shift-add digits as one
      uint32 each (row of the state, column within the slice << 16, shift
      << 24, negative << 28).  ``meta`` rows are ``(offset, MM terms,
      digits, share bytes)``.
    * ``"lists"`` (int8): each of the ``cw`` columns as the nonzero
      entries of the column's folded weights over the state rows (its MM
      tiles' elements << their shift plus its digits' +-(1 << w), summed
      per row), ascending by row, one uint32 word each: the state row in
      bits 0-15, the signed 16-bit weight in bits 16-31.  A column's
      ``lanes`` = :func:`_list_lanes` threads share its list, lane ``l``
      taking entries ``l``, ``l + lanes``, ...; every column is padded
      with zero words (row 0, weight 0) to the block's ``per_lane x
      lanes`` and word ``(i, j, l)`` of entry ``i lanes + l`` of column
      ``j`` sits at ``(i cw + j) lanes + l``, so the block's threads read
      consecutive words.  ``meta`` rows are ``(offset, per_lane, 0, share
      bytes)``.

    ``entries`` counts the list form's nonzero entries (0 for ``"mma"``).
    """

    n_blocks: int
    slices: int
    cw: int
    blob: np.ndarray
    meta: np.ndarray
    form: str = "mma"
    entries: int = 0

    @property
    def share_bytes(self) -> int:
        """The largest share: what residency needs per block."""
        return int(self.meta[:, 3].max())


def _slice_options(block: int) -> list[int]:
    """Thread blocks per column block: the divisors of ``block // 8``, so
    a block owns whole 8-column MMA groups."""
    groups = block // _MMA_COLS
    return [s for s in range(1, groups + 1) if groups % s == 0]


def _pad16(a: np.ndarray) -> np.ndarray:
    return np.concatenate([a, np.zeros(-len(a) % _ALIGN, np.uint8)])


def _list_lanes(cw: int) -> int:
    """Threads that share one column's list in the list form
    (``list_lanes`` in ``csrc/rollout.cu``): the largest power of two
    ``L`` with ``L x cw`` at most the block's 256 threads (1 when ``cw``
    exceeds them: the columns then take several passes)."""
    return 1 << max(0, (_THREADS // cw).bit_length() - 1)


def _folded_entries(tables: RolloutTables):
    """Every nonzero folded weight of an int8 table, as ``(column, row,
    weight)`` int64 arrays sorted by column then row: the sum over a
    column block's MM terms of ``tile[row, col] << shift`` and over its
    digits of ``+-(1 << w)``.  None when a weight or a row index needs
    more than 16 bits (the list form cannot hold it)."""
    bk, cp, rows = tables.block, tables.col_ptr_host, tables.terms_host
    if tables.rows_pad > 1 << _LIST_ROW_BITS:
        return None
    per_ci = [(ci, t) for ci in range(tables.n_col_blocks)
              for t in rows[cp[ci]:cp[ci + 1]]]
    parts = []
    mm = [(ci, slot, shift, rb) for ci, (k, slot, shift, rb) in per_ci
          if k == 0]
    if mm:
        ci, slot, shift, rb = (np.asarray(v, np.int64) for v in zip(*mm))
        tiles = tables.data_host[slot]
        m, r, c = np.nonzero(tiles)
        parts.append((ci[m] * bk + c, rb[m] * bk + r,
                      tiles[m, r, c].astype(np.int64) << shift[m]))
    sa = [(ci, rb, lo, hi) for ci, (k, rb, lo, hi) in per_ci if k == 1]
    if sa:
        ci, rb, lo, hi = (np.asarray(v, np.int64) for v in zip(*sa))
        n = hi - lo
        g = np.repeat(np.arange(len(sa)), n)
        idx = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(n.sum())
        d = tables.digits_host[idx].astype(np.int64)
        parts.append((ci[g] * bk + d[:, 1], rb[g] * bk + d[:, 0],
                      d[:, 2] << d[:, 3]))
    if not parts or not sum(len(v) for _c, _r, v in parts):
        return (np.zeros(0, np.int64),) * 3
    col, row, val = (np.concatenate(a) for a in zip(*parts))
    key = col * tables.rows_pad + row
    order = np.argsort(key, kind="stable")
    key, val = key[order], val[order]
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    key, val = key[first], np.add.reduceat(val, first)
    keep = val != 0
    key, val = key[keep], val[keep]
    if len(val) and (val.min() < -_LIST_WEIGHT_MAX
                     or val.max() >= _LIST_WEIGHT_MAX):
        return None
    return key // tables.rows_pad, key % tables.rows_pad, val


def _pack_lists(tables: RolloutTables, n_blocks: int, cw: int, entries
                ) -> tuple[np.ndarray, np.ndarray]:
    """The list form's blob and meta of ``n_blocks`` blocks of ``cw``
    columns from :func:`_folded_entries`."""
    col, row, val = entries
    lanes = _list_lanes(cw)
    counts = np.bincount(col, minlength=n_blocks * cw)
    per_lane = -(-counts.reshape(n_blocks, cw).max(1) // lanes)
    words = per_lane * cw * lanes                 # a multiple of 8: 32 bytes
    start = np.cumsum(np.r_[0, words])
    blk, j = col // cw, col % cw
    rank = np.arange(len(col)) - np.cumsum(np.r_[0, counts])[col]
    at = start[blk] + (rank // lanes * cw + j) * lanes + rank % lanes
    blob = np.zeros(max(int(start[-1]), _ALIGN // 4), np.uint32)
    blob[at] = (row.astype(np.uint32)
                | (val.astype(np.int16).view(np.uint16).astype(np.uint32)
                   << _LIST_ROW_BITS))
    meta = np.column_stack([start[:-1] * 4, per_lane, np.zeros_like(words),
                            words * 4]).astype(np.int32)
    return blob.view(np.uint8), meta


def _mma_units(tables: RolloutTables, cw: int) -> int:
    """The dense form's (term, 8-column group) MMA units per warp of the
    busiest block."""
    cp, rows = tables.col_ptr_host, tables.terms_host
    n_mm = max(sum(1 for t in rows[cp[ci]:cp[ci + 1]] if t[0] == 0)
               for ci in range(tables.n_col_blocks))
    return -(-n_mm * (cw // _MMA_COLS) // _WARPS)


def _pack_tiles(tables: RolloutTables, slices: int, cw: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """The dense (``"mma"``) form's blob and meta."""
    bk, ncb = tables.block, tables.n_col_blocks
    if tables.n_digits and cw > _MAX_DIGIT_COLS:
        raise ValueError(
            f"{ncb * slices} thread blocks give slices of {cw} columns; a "
            f"shift-add digit word holds a column within its slice in 8 "
            f"bits, so slices of at most {_MAX_DIGIT_COLS} columns")
    groups, kch = cw // _MMA_COLS, bk // _MMA_DEPTH
    cp, rows = tables.col_ptr_host, tables.terms_host
    shares, meta = [], []
    offset = 0
    for ci in range(ncb):
        terms = rows[cp[ci]:cp[ci + 1]]
        mm = [t for t in terms if t[0] == 0]
        head = _pad16(np.asarray([(rb, shift) for _k, _t, shift, rb in mm],
                                 np.int32).view(np.uint8).reshape(-1))
        tiles = tables.data_host[[t[1] for t in mm]]        # (n_mm, bk, bk)
        dg = [np.column_stack([tables.digits_host[lo:hi, 0] + rb * bk,
                               tables.digits_host[lo:hi, 1:]])
              for _k, rb, lo, hi in terms if _k == 1]
        dg = np.concatenate(dg) if dg else np.zeros((0, 4), np.int64)
        for sl in range(slices):
            c0 = sl * cw
            part = tiles[:, :, c0:c0 + cw]
            if tables.int8:
                part = part.reshape(len(mm), kch, 2, 4, 4, groups, 8
                                    ).transpose(0, 1, 5, 6, 3, 2, 4)
            else:
                part = part.reshape(len(mm), bk, groups, 8
                                    ).transpose(0, 2, 1, 3)
            tile_bytes = np.ascontiguousarray(part).view(np.uint8).reshape(-1)
            mine = dg[(dg[:, 1] >= c0) & (dg[:, 1] < c0 + cw)]
            words = (mine[:, 0].astype(np.uint32)
                     | ((mine[:, 1] - c0).astype(np.uint32) << 16)
                     | (mine[:, 3].astype(np.uint32) << 24)
                     | ((mine[:, 2] < 0).astype(np.uint32) << 28))
            share = _pad16(np.concatenate([head, tile_bytes,
                                           words.view(np.uint8)]))
            meta.append((offset, len(mm), len(mine), len(share)))
            shares.append(share)
            offset += len(share)
    blob = np.concatenate(shares) if offset else np.zeros(_ALIGN, np.uint8)
    return blob, np.asarray(meta, np.int32).reshape(-1, 4)


def pack_blocks(tables: RolloutTables, n_blocks: int) -> BlockShares:
    """Cut ``tables`` into the shares of ``n_blocks`` thread blocks, in
    the form the table takes on that grid: int8 takes ``"lists"`` when
    every folded weight fits 16 bits and the longest column's entries
    per lane are at most ``_LISTS_PER_MMA_UNIT`` times the dense form's
    MMA units per warp; otherwise (and fp32 always) ``"mma"``."""
    bk, ncb = tables.block, tables.n_col_blocks
    slices = n_blocks // ncb
    if n_blocks % ncb or slices not in _slice_options(bk):
        raise ValueError(
            f"{n_blocks} thread blocks do not split {ncb} column blocks of "
            f"{bk} into 8-column groups; use {ncb} x one of "
            f"{_slice_options(bk)}")
    cw = bk // slices
    entries = _folded_entries(tables) if tables.int8 else None
    if entries is not None:
        blob, meta = _pack_lists(tables, n_blocks, cw, entries)
        if meta[:, 1].max() <= _LISTS_PER_MMA_UNIT * max(
                1, _mma_units(tables, cw)):
            return BlockShares(n_blocks=n_blocks, slices=slices, cw=cw,
                               blob=blob, meta=meta, form="lists",
                               entries=len(entries[0]))
    blob, meta = _pack_tiles(tables, slices, cw)
    return BlockShares(n_blocks=n_blocks, slices=slices, cw=cw, blob=blob,
                       meta=meta)


def stage_stride(tables: RolloutTables) -> int:
    """Bytes per batch row of the working state (int8 or fp32), padded
    by 16 so the MMA's A-fragment loads fall in 32 distinct banks."""
    return tables.rows_pad * (1 if tables.int8 else 4) + _ALIGN


def _f32_warps(cw: int) -> int:
    """Warps that split one 8-column group's rows in the fp32 product
    (``f32_warps`` in ``csrc/rollout.cu``): each output sums 4 x this many
    partials."""
    return max(1, 8 // (cw // _MMA_COLS))


def readout_path(cw: int) -> str:
    """How the kernel sums a block's partial readout over its ``cw``
    columns (``shuffle_readout`` in ``csrc/rollout.cu``): ``"shuffle"``,
    by shuffles within a row's lanes, when ``cw`` divides 32;
    ``"shared"`` otherwise: a thread per (output, 32-column chunk) reads
    the row from shared memory and its chunk's weights from coalesced
    rows of ``W_out``, sums the chunk in registers, and the chunks meet by
    shuffles.  Both run one pairwise tree over column index, so the sum
    order depends on ``cw`` alone, and both sum the last batch tile's rows
    in the step barrier's wait."""
    return "shuffle" if cw <= 32 and 32 % cw == 0 else "shared"


def smem_bytes(tables: RolloutTables, cw: int, share: int = 0) -> int:
    """Dynamic shared memory of one block: the mbarrier, one batch tile of
    the working state, the int32 accumulator (int8) or the warps' fp32
    partial sums (``_f32_warps(cw)`` per output), each output's u . W_in
    and x(n-1) (fp32) and, when resident, the block's share."""
    per_output = (3 if tables.int8 else 2 + _f32_warps(cw)) * 4
    return (_BAR_BYTES + _MMA_ROWS * stage_stride(tables)
            + _MMA_ROWS * cw * per_output + share)


@dataclasses.dataclass(frozen=True)
class RolloutGrid:
    """The launch geometry of one table on one device."""

    n_blocks: int
    slices: int
    cw: int
    share_bytes: int          # the largest block's share of the table
    resident: bool            # shares kept in shared memory for all T
    smem: int                 # dynamic shared memory per block
    shares: BlockShares

    @property
    def form(self) -> str:
        """The shares' form: ``"mma"`` (dense tiles) or ``"lists"``."""
        return self.shares.form


def plan_grid(tables: RolloutTables, capacity, n_blocks: int | None = None
              ) -> RolloutGrid:
    """Choose the grid and the residency of the shares.

    ``capacity(smem)`` is how many blocks of ``smem`` bytes the device
    holds at once (occupancy x SMs).  Without ``n_blocks`` the grid is the
    most blocks (the narrowest column slices) whose streaming footprint
    all fit at once; it depends on the table and the device only, never
    on the batch, so every call of a table reduces in the same order.
    The shares are resident when the block's footprint with its share
    still lets the whole grid be resident; otherwise every block reads its
    share from global memory each step.
    """
    ncb, bk = tables.n_col_blocks, tables.block
    if n_blocks is None:
        fits = [s for s in _slice_options(bk)
                if ncb * s <= capacity(smem_bytes(tables, bk // s))]
        if not fits:
            raise ValueError(
                f"a {tables.rows_pad}-row {tables.mode} state tile exceeds "
                "one thread block's shared memory")
        n_blocks = ncb * max(fits)
    shares = pack_blocks(tables, n_blocks)
    base = smem_bytes(tables, shares.cw)
    full = base + shares.share_bytes
    resident = full <= MAX_SMEM and capacity(full) >= n_blocks
    return RolloutGrid(n_blocks=n_blocks, slices=shares.slices,
                       cw=shares.cw, share_bytes=shares.share_bytes,
                       resident=resident, smem=full if resident else base,
                       shares=shares)


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def blocks_per_sm(capacity, smem: int, n_sms: int) -> int:
    """The occupancy a grid was planned at: blocks of ``smem`` bytes (the
    grid's launched footprint) that one of the device's ``n_sms`` SMs
    holds, by :func:`plan_grid`'s ``capacity``."""
    return capacity(smem) // n_sms


def _device_capacity(int8: bool, device: torch.device):
    """``capacity(smem)`` of :func:`plan_grid` for the rollout kernel on
    ``device``: the occupancy API's blocks per SM x the SM count, for int8
    the fewer of its two forms' instantiations (the form is chosen after
    the grid)."""
    lib = _cuda.LIBRARY.load()
    sms = _sm_count(device)
    forms = ("mma", "lists") if int8 else ("fp32",)

    def per_sm(form: str, smem: int) -> int:
        blocks = ctypes.c_int(0)
        check(lib.rollout_occupancy(_FORMS[form], smem, ctypes.byref(blocks)),
              "rollout_occupancy")
        return blocks.value

    def capacity(smem: int) -> int:
        if smem > MAX_SMEM:
            return 0
        return min(per_sm(form, smem) for form in forms) * sms

    return capacity


def rollout_grid(tables: RolloutTables, device: torch.device,
                 n_blocks: int | None = None):
    """The :class:`RolloutGrid` of ``tables`` on a CUDA ``device`` and its
    device operands (blob, meta), made once per grid."""
    key = (str(device), n_blocks)
    if key not in tables.grids:
        with torch.cuda.device(device):
            capacity = _device_capacity(tables.int8, device)
            grid = plan_grid(tables, capacity, n_blocks)
            per_sm = blocks_per_sm(capacity, grid.smem, _sm_count(device))
        ops = (torch.as_tensor(grid.shares.blob, device=device),
               torch.as_tensor(grid.shares.meta, device=device))
        tables.grids[key] = (grid, ops)
        obs.event("rollout_grid", mode=tables.mode, n_blocks=grid.n_blocks,
                  cw=grid.cw, resident=grid.resident,
                  share_bytes=grid.share_bytes, smem=grid.smem,
                  blob_bytes=int(grid.shares.blob.nbytes),
                  mm_terms=tables.n_matmul_terms, digits=tables.n_digits,
                  form=grid.form, list_entries=grid.shares.entries,
                  blocks_per_sm=per_sm)
    return tables.grids[key]


def launch_counts(grid: RolloutGrid, steps: int, batch: int, b_tile: int
                  ) -> tuple[int, int, int]:
    """What one launch on ``grid`` adds to the kernels layer's counters:
    ``(streamed share bytes, shift-add digits, product rows)``.  Streamed
    shares are read whole from global memory by every block once per
    batch tile per step (none beyond the one bulk copy when resident);
    each digit of the dense form is scattered once per batch row per step
    (the list form scatters none: its digits are folded into the
    weights); the recurrent product runs once per step per batch row."""
    meta = grid.shares.meta
    streamed = 0 if grid.resident else (int(meta[:, 3].sum()) * steps
                                         * -(-batch // b_tile))
    return streamed, int(meta[:, 2].sum()) * steps * batch, steps * batch


def io_macs(steps: int, batch: int, dim: int, in_dim: int, out_dim: int,
            readout_steps: int) -> tuple[int, int]:
    """The multiply-adds of one launch's dense input projection and
    readout: ``(steps x batch rows x dim x I, readout steps x batch rows x
    dim x O)``; the readout's is 0 in a launch without predictions
    (``readout_steps`` 0)."""
    return steps * batch * dim * in_dim, readout_steps * batch * dim * out_dim


# -- readout ------------------------------------------------------------------
def rollout_readout_plain(x: torch.Tensor,
                          w_out: torch.Tensor) -> torch.Tensor:
    """The twin's readout ``y = x @ w_out`` of a (B, dim) state (the
    kernel computes it inside the rollout launch)."""
    return x @ w_out


# -- shared checks ------------------------------------------------------------
def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _same_device_tables(dev, tables, *tensors):
    if tables.device != dev:
        raise ValueError(f"operands on different devices: {tables.device} "
                         f"vs {dev}")
    same_device(dev, *tensors)


def check_operands(u_seq, tables, w_in, x0, w_out, final_out, b_tile,
                   want_preds, readout_every):
    """Everything a launch needs of its operands but the device type:
    same device, dtypes, shapes, strides, a batch tile of at most one MMA
    tile and a state that one block can stage.  Raises ``ValueError`` /
    ``TypeError``."""
    dev = u_seq.device
    _same_device_tables(dev, tables, w_in, x0, w_out, final_out)
    check_f32(u_seq, w_in, x0, w_out, final_out)
    want = np.dtype(np.int8 if tables.int8 else np.float32)
    if tables.data_host.dtype != want:
        raise TypeError(f"{tables.mode} tiles must be {want}, "
                        f"got {tables.data_host.dtype}")
    if u_seq.dim() != 3 or not unit_stride(u_seq, 2):
        raise ValueError("u_seq must be (T, B, I) with unit stride over I")
    t, b, i = u_seq.shape
    if t < 1:
        raise ValueError("u_seq needs at least one step")
    dim = x0.shape[-1]
    bk = tables.block
    if x0.shape != (b, dim) or not x0.is_contiguous():
        raise ValueError(f"x0 must be a contiguous ({b}, dim) tensor, got "
                         f"{tuple(x0.shape)}")
    if not (tables.n_col_blocks - 1) * bk < dim <= tables.n_col_blocks * bk:
        raise ValueError(f"state dim {dim} does not match "
                         f"{tables.n_col_blocks} column blocks of {bk}")
    if w_in.shape != (i, dim) or not w_in.is_contiguous():
        raise ValueError(f"w_in must be a contiguous ({i}, {dim}) tensor")
    if want_preds:
        if w_out is None or w_out.shape[0] != dim or not w_out.is_contiguous():
            raise ValueError("want_preds needs a contiguous (dim, O) w_out")
        if t % readout_every:
            raise ValueError(f"readout_every={readout_every} must divide "
                             f"T={t}")
    if final_out is not None and (final_out.shape != (b, dim)
                                  or not final_out.is_contiguous()):
        raise ValueError("final_out must be a contiguous (B, dim) tensor")
    if not 1 <= b_tile <= _MMA_ROWS:
        raise ValueError(f"batch tile {b_tile} exceeds one thread block's "
                         f"{_MMA_ROWS}-row MMA tile; lower batch_tile_max")
    if bk % _MMA_DEPTH or tables.rows_pad >= 1 << 16:
        raise ValueError(f"the rollout kernel takes blocks of a multiple of "
                         f"{_MMA_DEPTH} rows and fewer than 65536 state "
                         f"rows, not {tables.n_col_blocks} x {bk}")
    if smem_bytes(tables, _MMA_COLS) > MAX_SMEM:
        raise ValueError(f"a {tables.rows_pad}-row {tables.mode} state tile "
                         "exceeds one thread block's shared memory")


def _launch_rollout(counted, u_seq, tables, w_in, x0, w_out=None, *,
                    leak=1.0, smax=127, recur_scale=1.0, b_tile=16,
                    readout_every=1, want_states=True, want_preds=False,
                    want_final=False, final_out=None, n_blocks=None):
    """One cooperative launch of the persistent kernel for all T steps
    (counted on ``counted.launches``; with ``want_preds`` the readout is
    computed inside it, counted on ``counted.fused_launches``;
    with metrics on, its :func:`launch_counts` too (product rows under the
    grid's form), and with predictions
    its readout steps x batch rows under the grid's :func:`readout_path`;
    the input projection's and the readout's multiply-adds by
    :func:`io_macs`).
    The last step writes straight into the final-state buffer — the
    caller's carry when it donates one.  ``n_blocks`` sets the grid
    (default: :func:`plan_grid`'s choice); the entry points leave it to
    the default, block-count sweeps and tests call this directly."""
    require_cuda(u_seq)
    check_operands(u_seq, tables, w_in, x0, w_out, final_out, b_tile,
                   want_preds, readout_every)
    dev = u_seq.device
    grid, (blob, meta) = rollout_grid(tables, dev, n_blocks)
    if want_preds and grid.cw > _MAX_READOUT_COLS:
        raise ValueError(f"the readout sums slices of at most "
                         f"{_MAX_READOUT_COLS} columns, not {grid.cw}; "
                         "use more thread blocks")
    t_steps, b, i = u_seq.shape
    dim = x0.shape[1]
    o = w_out.shape[1] if want_preds else 0
    n_out = t_steps // readout_every if want_preds else 0
    states = (torch.empty((t_steps, b, dim), device=dev)
              if want_states else None)
    preds = partial = None
    if want_preds:
        preds = torch.empty((n_out, b, o), device=dev)
        partial = torch.empty((n_out, grid.n_blocks, b, o), device=dev)
    final = None
    if want_final:
        final = (final_out if final_out is not None
                 else torch.empty((b, dim), device=dev))
    ldx = stage_stride(tables)
    # the working state's two halves, then the step barrier's 8-byte count
    xbuf = torch.empty(2 * b * ldx + _ALIGN, dtype=torch.uint8, device=dev)
    xkeep = torch.empty((b, tables.rows_pad), device=dev)
    name = counted.__name__
    rc = _cuda.LIBRARY.load().rollout_run(
        _FORMS[grid.form if tables.int8 else "fp32"], u_seq.data_ptr(),
        u_seq.stride(0), u_seq.stride(1),
        w_in.data_ptr(), _ptr(w_out if want_preds else None), x0.data_ptr(),
        _ptr(states), _ptr(preds), _ptr(final), xbuf.data_ptr(),
        xkeep.data_ptr(), _ptr(partial), blob.data_ptr(), meta.data_ptr(),
        t_steps, b, dim, i, o, tables.block, grid.cw, grid.slices, b_tile,
        readout_every, ldx, tables.rows_pad, int(grid.resident),
        grid.n_blocks, grid.smem, 1.0 - leak, leak, float(smax), recur_scale,
        stream(dev))
    check(rc, name)
    counted.launches += 1
    if want_preds:
        counted.fused_launches += 1
    obs.inc("kernel_launches_total", kernel=name)
    if obs.metrics() is not None:
        streamed, digits, rows = launch_counts(grid, t_steps, b, b_tile)
        obs.inc("rollout_streamed_bytes_total", streamed, kernel=name)
        obs.inc("rollout_shiftadd_digits_total", digits, kernel=name)
        obs.inc("rollout_product_rows_total", rows, kernel=name,
                form=grid.form)
        macs_in, macs_out = io_macs(t_steps, b, dim, i, o, n_out)
        obs.inc("rollout_io_macs_total", macs_in, kernel=name, part="input")
        if want_preds:
            obs.inc("rollout_readout_rows_total", n_out * b, kernel=name,
                    path=readout_path(grid.cw))
            obs.inc("rollout_io_macs_total", macs_out, kernel=name,
                    part="readout")
    return _pack(states, preds, final)


def _pack(states, preds, final):
    out = [o for o in (states, preds, final) if o is not None]
    return out[0] if len(out) == 1 else tuple(out)


# -- plain twin ---------------------------------------------------------------
def plain_recurrent_product(x: torch.Tensor,
                            tables: RolloutTables) -> torch.Tensor:
    """The twin's recurrent product ``x @ W`` over the term tables.

    int8: ``x`` is the (B, rows_pad) int32 quantized state and the result
    the exact int32 product (tile products in float64, exact for int8
    operands; shift-add digits scattered with ``index_add_``).  fp32: the
    (B, rows_pad) float state, each column's tile products summed in
    schedule order (culled columns are zero).
    """
    bk = tables.block
    b = x.shape[0]
    cp, rows = tables.col_ptr_host, tables.terms_host
    out = torch.zeros((b, tables.n_col_blocks * bk), dtype=x.dtype,
                      device=x.device)
    for ci in range(tables.n_col_blocks):
        acc = None
        for kind, a, c, d in rows[cp[ci]:cp[ci + 1]]:
            if kind == 0:
                xs = x[:, d * bk:(d + 1) * bk]
                if tables.int8:
                    contrib = int_matmul_exact(xs, tables.tiles[a]) << c
                else:
                    contrib = xs @ tables.tiles[a]
                acc = contrib if acc is None else acc + contrib
            else:
                if acc is None:
                    acc = torch.zeros((b, bk), dtype=x.dtype,
                                      device=x.device)
                dg = tables.digits[c:d].long()
                col = torch.bitwise_left_shift(x[:, a * bk + dg[:, 0]],
                                               dg[:, 3].int())
                acc.index_add_(1, dg[:, 1], col * dg[:, 2].int())
        if acc is not None:
            out[:, ci * bk:(ci + 1) * bk] = acc
    return out


def _plain_rollout(u_seq, tables, w_in, x0, w_out=None, *, leak=1.0,
                   smax=127, recur_scale=1.0, readout_every=1,
                   want_states=True, want_preds=False, want_final=False,
                   final_out=None):
    """The step loop of the CUDA kernel in PyTorch ops, on any device.

    Walks the same per-column term tables; the state is zero-padded to
    whole column blocks (pad columns stay zero through the recurrence).
    The input projection is summed in ascending input order and the
    epilogue uses separately rounded operations, as the kernel does, so
    every element goes through the kernel's rounding sequence.
    """
    _same_device_tables(u_seq.device, tables, w_in, x0, w_out, final_out)
    t_steps, b, i = u_seq.shape
    dim = x0.shape[-1]
    rpad = tables.n_col_blocks * tables.block
    x = x0.new_zeros((b, rpad))
    x[:, :dim] = x0
    win = w_in.new_zeros((i, rpad))
    win[:, :dim] = w_in
    has_terms = torch.tensor(
        [hi > lo for lo, hi in zip(tables.col_ptr_host,
                                   tables.col_ptr_host[1:])],
        device=x.device).repeat_interleave(tables.block)
    states, preds = [], []
    for t in range(t_steps):
        u = u_seq[t]
        up = u[:, 0:1] * win[0]
        for m in range(1, i):
            up = up + u[:, m:m + 1] * win[m]
        if tables.int8:
            xq = torch.clamp(torch.round(x * smax), -smax - 1,
                             smax).to(torch.int32)
            recur = plain_recurrent_product(xq, tables)
            pre = up + recur.to(torch.float32) * recur_scale
        else:
            pre = torch.where(has_terms,
                              up + plain_recurrent_product(x, tables), up)
        x = (1.0 - leak) * x + leak * torch.tanh(pre)
        if want_states:
            states.append(x[:, :dim])
        if want_preds and (t + 1) % readout_every == 0:
            preds.append(rollout_readout_plain(x[:, :dim], w_out))
    final = None
    if want_final:
        final = x[:, :dim].contiguous()
        if final_out is not None:
            final = final_out.copy_(final)
    return _pack(torch.stack(states) if want_states else None,
                 torch.stack(preds) if want_preds else None, final)


def _dispatch(counted, plain, u_seq, tables, w_in, x0, w_out=None, *,
              leak=1.0, smax=127, recur_scale=1.0, b_tile=16,
              readout_every=1, want_states=True, want_preds=False,
              want_final=False, final_out=None):
    """The kernels layer's entry for one rollout, timed as the
    ``rollout.launch`` span while tracing is on: on a card to the return
    of the launch call (checks, grid, allocations, the enqueue), on a
    CPU tensor the twin's whole call."""
    tracer = obs.tracer()
    t0 = 0.0 if tracer is None else time.perf_counter()
    if not (want_states or want_preds or want_final):
        raise ValueError("request at least one of states, preds, final")
    kw = dict(leak=leak, smax=smax, recur_scale=recur_scale,
              readout_every=readout_every, want_states=want_states,
              want_preds=want_preds, want_final=want_final,
              final_out=final_out)
    if u_seq.device.type == "cpu":
        out = plain(u_seq, tables, w_in, x0, w_out, **kw)
    else:
        out = _launch_rollout(counted, u_seq, tables, w_in, x0, w_out,
                              b_tile=b_tile, **kw)
    if tracer is not None:
        tracer.record("rollout.launch", t0, time.perf_counter(),
                      kernel=counted.__name__)
    return out


def reservoir_rollout_plain(u_seq, tables, w_in, x0, w_out=None, **kw):
    """Plain twin of :func:`reservoir_rollout` (MM terms only)."""
    if any(r[0] != 0 for r in tables.terms_host):
        raise ValueError("the generic rollout takes MM terms only")
    return _plain_rollout(u_seq, tables, w_in, x0, w_out, **kw)


def reservoir_rollout(u_seq: torch.Tensor, tables: RolloutTables,
                      w_in: torch.Tensor, x0: torch.Tensor,
                      w_out: torch.Tensor | None = None, **kw):
    """B1: T-step generic banded rollout of a state batch.

    Args:
        u_seq: (T, B, I) float32 inputs (unit stride over I).
        tables: :func:`build_tables` of :func:`generic_schedules` of the
            plan's ``rollout_layout`` band plans, on ``u_seq``'s device.
        w_in: (I, dim) input weights; x0: (B, dim) initial states.
        w_out: (dim, O) readout weights (required iff ``want_preds``).
        leak, smax, recur_scale: Eq. 1's leak; int8 state range and the
            ``scale / smax`` factor restoring float pre-activations.
        b_tile: batch rows per tile (at most 16, one MMA tile).
        readout_every: emit predictions every k steps (k must divide T).
        want_states / want_preds / want_final: which outputs to return.
        final_out: optional (B, dim) buffer that receives x(T) in place
            (the chunked scheduler's carried state).

    Returns states (T, B, dim), preds (T // k, B, O) and the final state
    (B, dim), in that order — bare when exactly one is requested.
    """
    return _dispatch(reservoir_rollout, reservoir_rollout_plain, u_seq, tables,
                     w_in, x0, w_out, **kw)


reservoir_rollout.launches = reservoir_rollout.fused_launches = 0
