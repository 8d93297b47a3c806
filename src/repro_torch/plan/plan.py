"""ExecutionPlan: compile a FixedMatrix once, execute it everywhere.

The paper's design flow takes the *content* of a fixed matrix and compiles
it to a physical design exactly once — constant propagation culls degenerate
adders, CSD minimizes the remaining logic — and the resulting circuit makes
zero per-step decisions.  This module is the software analogue of that
synthesis step: :class:`ExecutionPlan` lowers one compiled
:class:`repro_torch.core.sparse.FixedMatrix` into the static artefacts every
consumer needs, so no kernel wrapper re-derives them ad hoc:

* gathered fp32 nonzero tiles + per-column reduction terms (block culling),
* int8 digit-plane tiles + per-column ``(plane, tile, row_block)`` terms
  with plane-level culling on top of block-level culling,
* whole-plane keep masks and block-padded digit planes (bitplane gemv),
* the sorted, column-padded BCSR tile list (block-sparse matmul),
* banded rollout layouts: output column blocks partitioned into bands
  whose weight tiles fit a byte budget,
* the FPGA cost model evaluated on the exact decomposed structure
  (ones -> LUT/FF/Fmax/power, Eq. 5 latency).

Every artefact is a numpy array or a static tuple, built on the host; the
kernel wrappers move what they need to the device once.  The lowering is
identical to the JAX package's for every budget and crossover, so the two
packages' schedules compare with ``==``.

Plans are cached per FixedMatrix instance (``plan_for``): the matrix is
frozen, so the lowering is paid once per process, like place-and-route is
paid once per bitstream.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch import obs
from repro_torch.core import costmodel
from repro_torch.core.sparse import BlockSparse, FixedMatrix

__all__ = [
    "DEFAULT_VMEM_BUDGET",
    "BandedRollout",
    "BcsrLayout",
    "ExecutionPlan",
    "PlanStats",
    "RolloutBand",
    "plan_cache_stats",
    "plan_for",
]

# Default per-band byte budget for the rollout's weight tiles.  It is an
# argument of the lowering, kept at the JAX package's value (8 MiB, sized
# for a TPU core's VMEM) so that both packages lower a matrix into the same
# bands and schedules.  Changing it changes the program, not just its speed.
DEFAULT_VMEM_BUDGET = 8 * 2**20


def pad_axis(a: np.ndarray, axis: int, size: int) -> np.ndarray:
    """Zero-pad one axis up to ``size`` (shared by the kernel wrappers)."""
    pad = size - a.shape[axis]
    if pad == 0:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """What the compile step kept vs culled — the paper's Fig. 5-9 metrics."""

    block: int
    blocks_total: int
    blocks_nnz: int
    width: int                 # digit planes after PN/CSD decomposition
    fp32_terms_kept: int       # == blocks_nnz (one reduction term per tile)
    fp32_terms_culled: int     # zero blocks dropped at compile time
    int8_terms_kept: int       # (plane, block) pairs with any set digit
    int8_terms_culled: int     # vs the dense width x blocks_total structure
    planes_kept: int           # whole planes with any set digit
    planes_culled: int
    ones: int                  # set digit bits, the paper's cost driver

    @property
    def block_density(self) -> float:
        return self.blocks_nnz / max(self.blocks_total, 1)


@dataclasses.dataclass(frozen=True)
class BcsrLayout:
    """Sorted/padded tile list for the BCSR matmul kernel.

    Tiles are sorted by (col, row) so each output column block's tiles
    form one contiguous run (``col_ptr``), and every empty output column
    gets one zero tile so the whole output is written.
    """

    shape: tuple[int, int]
    block: int
    rows_pad: int
    cols_pad: int
    data: np.ndarray           # (n_tiles, block, block)
    cols: np.ndarray           # (n_tiles,) int32
    rows: np.ndarray           # (n_tiles,) int32
    n_tiles: int

    @classmethod
    def from_blocks(cls, bs: BlockSparse) -> "BcsrLayout":
        nbr, nbc = bs.mask.shape
        data = np.asarray(bs.data)
        cols = bs.block_cols.astype(np.int32)
        rows = bs.block_rows.astype(np.int32)
        missing = sorted(set(range(nbc)) - set(cols.tolist()))
        if missing:
            zero = np.zeros((len(missing), bs.block, bs.block), data.dtype)
            data = np.concatenate([data, zero], axis=0) if data.size else zero
            cols = np.concatenate([cols, np.asarray(missing, np.int32)])
            rows = np.concatenate([rows, np.zeros(len(missing), np.int32)])
        order = np.lexsort((rows, cols))
        return cls(shape=bs.shape, block=bs.block,
                   rows_pad=nbr * bs.block, cols_pad=nbc * bs.block,
                   data=np.ascontiguousarray(data[order]),
                   cols=cols[order], rows=rows[order],
                   n_tiles=int(data.shape[0]))

    @property
    def col_ptr(self) -> np.ndarray:
        """(n_col_blocks + 1,) int32: column block ``c``'s tiles are
        ``col_ptr[c]:col_ptr[c + 1]`` (never empty)."""
        nbc = self.cols_pad // self.block
        return np.searchsorted(self.cols, np.arange(nbc + 1)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class RolloutBand:
    """One budget-sized slice of the rollout reduction.

    ``col_terms`` lists, for each output column block this band owns, the
    static reduction terms ``(slot, shift, row_block)``: ``slot`` indexes
    this band's row of the banded data array, ``shift`` is the digit-plane
    shift (0 in fp32 mode), ``row_block`` selects the state slice.
    """

    index: int
    col_lo: int                # first output column block (inclusive)
    col_hi: int                # last output column block (exclusive)
    col_terms: tuple           # ((ci, ((slot, shift, row_block), ...)), ...)
    n_terms: int
    data_bytes: int            # this band's real tile payload


@dataclasses.dataclass(frozen=True)
class BandedRollout:
    """Rollout lowering: banded tile data + static per-band term plans."""

    mode: str                  # "fp32" | "int8"
    block: int
    data: np.ndarray           # (n_bands, max_terms, block, block)
    bands: tuple               # tuple[RolloutBand, ...]
    max_terms: int
    vmem_budget: int | None    # None: unbanded (single band)

    @property
    def n_bands(self) -> int:
        return len(self.bands)

    @property
    def n_terms(self) -> int:
        return sum(b.n_terms for b in self.bands)

    def band_plans(self) -> tuple:
        """Static nested tuple the kernels walk: one entry per band."""
        return tuple(b.col_terms for b in self.bands)


class ExecutionPlan:
    """All static artefacts of one compiled FixedMatrix, derived once.

    Heavyweight artefacts (digit planes, int8 tiles) are cached properties
    so an fp32-only consumer never pays for the integer lowering and vice
    versa.
    """

    def __init__(self, fm: FixedMatrix):
        self._fm = fm
        bs = fm.blocks
        self.shape = fm.shape
        self.block = bs.block
        self.nbr, self.nbc = bs.mask.shape
        self.rows_pad = self.nbr * self.block
        self.cols_pad = self.nbc * self.block
        self.mode = fm.mode
        self.weight_bits = fm.weight_bits
        self.scale = fm.scale
        self.element_sparsity = fm.element_sparsity
        self.block_rows = bs.block_rows
        self.block_cols = bs.block_cols
        self.blocks_total = bs.n_blocks_total
        self.blocks_nnz = bs.n_blocks_nnz
        self.block_density = bs.density
        self._layouts: dict = {}

    # -- float lowering -----------------------------------------------------
    @functools.cached_property
    def fp32_tiles(self) -> np.ndarray:
        """(n_nnz, block, block) float32 dequantized nonzero tiles."""
        return np.asarray(self._fm.blocks.data, np.float32)

    # -- integer lowering ---------------------------------------------------
    @functools.cached_property
    def digits(self) -> np.ndarray:
        """(width, rows, cols) int8 signed digits with V = sum 2^w d_w."""
        planes = self._fm.planes
        return planes.pos.astype(np.int8) - planes.neg.astype(np.int8)

    @property
    def width(self) -> int:
        return int(self.digits.shape[0])

    @functools.cached_property
    def plane_mask(self) -> tuple:
        """Whole-plane keep flags (CSD often leaves high planes empty)."""
        return tuple(bool(np.any(self.digits[w])) for w in range(self.width))

    @functools.cached_property
    def int8_tiles(self) -> np.ndarray:
        """(width, n_nnz, block, block) int8 digit tiles over the same
        nonzero-block list as ``fp32_tiles``."""
        bk = self.block
        dig = pad_axis(pad_axis(self.digits, 1, self.rows_pad),
                       2, self.cols_pad)
        tiles = dig.reshape(self.width, self.nbr, bk, self.nbc, bk
                            ).transpose(0, 1, 3, 2, 4)
        return tiles[:, self.block_rows, self.block_cols]

    @functools.cached_property
    def plane_block_mask(self) -> np.ndarray:
        """(width, n_nnz) bool: plane-level culling on top of block-level
        culling — a reduction term exists only where that plane of that
        block has any set digit."""
        return np.any(self.int8_tiles != 0, axis=(2, 3))

    def padded_digits(self, block_r: int = 128,
                      block_c: int = 128) -> np.ndarray:
        """Signed digits zero-padded to block multiples for bitplane_gemv
        (C-contiguous: one plane after another, rows of columns)."""
        dig = self.digits
        dig = pad_axis(dig, 1, -(-dig.shape[1] // block_r) * block_r)
        dig = pad_axis(dig, 2, -(-dig.shape[2] // block_c) * block_c)
        return np.ascontiguousarray(dig)

    # -- BCSR lowering ------------------------------------------------------
    @functools.cached_property
    def bcsr(self) -> BcsrLayout:
        return BcsrLayout.from_blocks(self._fm.blocks)

    # -- rollout lowering (banded) ------------------------------------------
    def _col_term_descriptors(self, mode: str) -> list:
        """Per output column block, the ordered reduction terms as
        ``(tile_idx, shift, row_block)`` — ascending row order (fp32) /
        (tile, plane) order (int8), matching the reference accumulation."""
        rows, cols = self.block_rows, self.block_cols
        out = []
        for ci in range(self.nbc):
            tiles = np.flatnonzero(cols == ci)
            if mode == "fp32":
                out.append([(int(di), 0, int(rows[di])) for di in tiles])
            else:
                keep = self.plane_block_mask
                out.append([(int(di), w, int(rows[di]))
                            for di in tiles for w in range(self.width)
                            if keep[w, di]])
        return out

    def col_terms(self, mode: str = "fp32") -> tuple:
        """Per output column block, the ordered reduction terms as
        ``(tile_idx, shift, row_block)`` tuples (shift is 0 in fp32 mode).
        Culled blocks — and, in int8 mode, culled plane-blocks — never
        appear."""
        return tuple(tuple(ts) for ts in self._col_term_descriptors(mode))

    def _tile_bytes(self, mode: str) -> int:
        itemsize = 4 if mode == "fp32" else 1
        return self.block * self.block * itemsize

    def _col_term_counts(self, mode: str) -> np.ndarray:
        """Reduction terms per output column block — enough to band without
        gathering any tile data (fp32 never touches the integer lowering)."""
        if mode == "fp32":
            return np.bincount(self.block_cols, minlength=self.nbc)
        counts = np.zeros(self.nbc, np.int64)
        np.add.at(counts, self.block_cols, self.plane_block_mask.sum(axis=0))
        return counts

    def band_partition(self, mode: str = "fp32",
                       vmem_budget: int | None = DEFAULT_VMEM_BUDGET,
                       ) -> tuple:
        """Greedy packing of output column blocks into budget-sized bands.

        Returns ``((col_lo, col_hi, n_terms), ...)`` — computed from
        per-column term *counts* only, so cost summaries never pay for the
        tile gather (``rollout_layout`` reuses the same partition to build
        the banded data).  ``vmem_budget=None`` yields one unbanded band.
        """
        if mode not in ("fp32", "int8"):
            raise ValueError(f"mode must be fp32 or int8, not {mode!r}")
        tile_bytes = self._tile_bytes(mode)
        counts = self._col_term_counts(mode)
        spans: list[list[int]] = [[0, 0, 0]]       # [col_lo, col_hi, n_terms]
        for ci in range(self.nbc):
            n = int(counts[ci])
            if vmem_budget is not None and n * tile_bytes > vmem_budget:
                raise ValueError(
                    f"column block {ci} alone needs {n * tile_bytes} B of "
                    f"tiles > vmem_budget={vmem_budget}; raise the budget "
                    f"or compile with a smaller block than {self.block}")
            last = spans[-1]
            if (vmem_budget is not None and last[1] > last[0]
                    and (last[2] + n) * tile_bytes > vmem_budget):
                spans.append([ci, ci, 0])
                last = spans[-1]
            last[1] = ci + 1
            last[2] += n
        return tuple((lo, hi, n) for lo, hi, n in spans)

    def band_summary(self, mode: str = "fp32",
                     vmem_budget: int | None = DEFAULT_VMEM_BUDGET,
                     ) -> tuple:
        """(n_bands, tile_bytes_per_band) — the reporting view of banding,
        no tile data gathered."""
        spans = self.band_partition(mode, vmem_budget)
        return (len(spans),
                max(n for _lo, _hi, n in spans) * self._tile_bytes(mode))

    def rollout_layout(self, mode: str = "fp32",
                       vmem_budget: int | None = DEFAULT_VMEM_BUDGET,
                       ) -> BandedRollout:
        """Lower the recurrent reduction into budget-sized bands.

        Output column blocks are packed per :meth:`band_partition`; each
        term's tile is gathered into the band's row of one padded
        ``(n_bands, max_terms, block, block)`` array.
        """
        if mode not in ("fp32", "int8"):
            raise ValueError(f"mode must be fp32 or int8, not {mode!r}")
        key = (mode, vmem_budget)
        if key in self._layouts:
            return self._layouts[key]
        bk = self.block
        col_terms = self._col_term_descriptors(mode)
        if mode == "fp32":
            source, dtype = self.fp32_tiles, np.float32
            tile_of = lambda di, w: source[di]                    # noqa: E731
        else:
            source, dtype = self.int8_tiles, np.int8
            tile_of = lambda di, w: source[w, di]                 # noqa: E731
        tile_bytes = self._tile_bytes(mode)

        bands: list[RolloutBand] = []
        band_data: list[np.ndarray] = []
        for bi, (lo, hi, _n) in enumerate(
                self.band_partition(mode, vmem_budget)):
            tiles, terms = [], []
            for ci in range(lo, hi):
                slots = []
                for di, w, ri in col_terms[ci]:
                    slots.append((len(tiles), w, ri))
                    tiles.append(tile_of(di, w))
                terms.append((ci, tuple(slots)))
            bands.append(RolloutBand(
                index=bi, col_lo=lo, col_hi=hi,
                col_terms=tuple(terms), n_terms=len(tiles),
                data_bytes=len(tiles) * tile_bytes))
            band_data.append(np.stack(tiles) if tiles
                             else np.zeros((0, bk, bk), dtype))
        max_terms = max(1, max(b.n_terms for b in bands))
        data = np.zeros((len(bands), max_terms, bk, bk), dtype)
        for bi, tiles in enumerate(band_data):
            data[bi, : tiles.shape[0]] = tiles
        layout = BandedRollout(mode=mode, block=bk, data=data,
                               bands=tuple(bands), max_terms=max_terms,
                               vmem_budget=vmem_budget)
        self._layouts[key] = layout
        return layout

    # -- cost reporting -----------------------------------------------------
    @functools.cached_property
    def stats(self) -> PlanStats:
        kept = int(self.plane_block_mask.sum())
        width = self.width
        return PlanStats(
            block=self.block,
            blocks_total=self.blocks_total,
            blocks_nnz=self.blocks_nnz,
            width=width,
            fp32_terms_kept=self.blocks_nnz,
            fp32_terms_culled=self.blocks_total - self.blocks_nnz,
            int8_terms_kept=kept,
            int8_terms_culled=width * self.blocks_total - kept,
            planes_kept=sum(self.plane_mask),
            planes_culled=width - sum(self.plane_mask),
            ones=self._fm.ones,
        )

    def specialize_summary_line(
            self, mode: str = "fp32",
            vmem_budget: int | None = DEFAULT_VMEM_BUDGET) -> str:
        """One-line regime report of the specialized rollout program: the
        chosen weight-residency regime, weight bytes, and how the terms
        split between folded-tile matmuls and shift-add reductions."""
        from repro_torch.plan.specialize import specialize_summary
        s = specialize_summary(self, mode, vmem_budget=vmem_budget)
        return (f"{s['mode']} {s['regime']} ({s['n_bands']} band(s), "
                f"{s['resident_bytes']} B weights), "
                f"{s['n_matmul_terms']} matmul terms + "
                f"{s['n_shiftadd_terms']} shift-add terms "
                f"({s['shiftadd_digits']} digit adds)")

    def fpga_cost(self, input_bits: int = 8) -> costmodel.FPGADesignPoint:
        """The paper's synthesis estimate for this exact structure."""
        return costmodel.design_point(
            rows=self.shape[0], cols=self.shape[1],
            element_sparsity=self.element_sparsity,
            weight_bits=self.weight_bits, input_bits=input_bits,
            mode=self.mode, ones=self._fm.ones)

    def describe(self, input_bits: int = 8,
                 vmem_budget: int | None = DEFAULT_VMEM_BUDGET) -> str:
        """Human-readable compile summary: structure kept/culled + FPGA
        cost + the specialized programs' regimes."""
        s = self.stats
        dp = self.fpga_cost(input_bits)
        n_bands, band_bytes = self.band_summary("fp32",
                                                vmem_budget=vmem_budget)
        lines = [
            f"ExecutionPlan {self.shape[0]}x{self.shape[1]} block={self.block} "
            f"mode={self.mode} weight_bits={self.weight_bits}",
            f"  blocks: {s.blocks_nnz}/{s.blocks_total} kept "
            f"({s.fp32_terms_culled} culled, density {s.block_density:.2f})",
            f"  int8 plane-terms: {s.int8_terms_kept} kept / "
            f"{s.int8_terms_culled} culled (planes {s.planes_kept}/{s.width})",
            f"  rollout bands (fp32, budget {vmem_budget} B): "
            f"{n_bands} x <= {band_bytes} B tiles",
            "  specialized: " + self.specialize_summary_line(
                "fp32", vmem_budget),
            "  specialized: " + self.specialize_summary_line(
                "int8", vmem_budget),
            f"  FPGA: ones={s.ones}  LUTs={dp.luts:.0f}  FFs={dp.ffs:.0f}  "
            f"Fmax={dp.fmax_hz / 1e6:.0f} MHz",
            f"  Eq.5 latency: {dp.cycles} cycles = {dp.latency_ns:.1f} ns  "
            f"power = {dp.power_w:.1f} W",
        ]
        return "\n".join(lines)


# plan_for cache telemetry.  The cache itself is the matrix instance (the
# plan rides on ``fm._execution_plan``), so its lifetime is exactly the
# matrix's; the counters let a long-lived server verify that property.
_PLAN_CACHE_STATS: dict = {"hits": 0, "misses": 0}


def plan_cache_stats(reset: bool = False) -> dict:
    """Cumulative plan_for hit/miss counters (``reset=True`` zeroes them)."""
    out = dict(_PLAN_CACHE_STATS)
    if reset:
        _PLAN_CACHE_STATS.update(hits=0, misses=0)
    return out


def plan_for(fm: FixedMatrix) -> ExecutionPlan:
    """The ExecutionPlan for a compiled matrix, cached per instance.

    FixedMatrix is frozen by construction, so the plan — like the paper's
    place-and-route result — is computed at most once per matrix, and it
    is released exactly when the matrix is: the cache slot lives on the
    instance, never in a process-global table.
    """
    plan = getattr(fm, "_execution_plan", None)
    hit = plan is not None and plan._fm is fm
    if not hit:
        with obs.timed_span("plan.lower"):
            plan = ExecutionPlan(fm)
        fm._execution_plan = plan
        obs.event("plan_lowering", shape=str(fm.shape))
    _PLAN_CACHE_STATS["hits" if hit else "misses"] += 1
    obs.inc("plan_cache_requests_total", outcome="hit" if hit else "miss")
    return plan
