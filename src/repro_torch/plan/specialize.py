"""Plan specialization: lower an ExecutionPlan into a rollout *program*.

The paper's design flow does not stop at knowing the matrix structure — it
compiles the structure *into the computation*: constant propagation deletes
work (zero digits cost nothing), CSD logic minimization strength-reduces
what remains, and the matrix stays spatially resident so it is never
re-fetched.  ``specialize_rollout`` turns one
:class:`~repro_torch.plan.plan.ExecutionPlan` into a :class:`RolloutProgram`:

* **regime selection** — when every kept weight tile fits the byte budget
  the program is ``resident`` (one band); otherwise it is ``pipelined``:
  output columns are packed into bands of at most half the budget.  The
  CUDA kernel repacks every band into per-thread-block shares either way
  (kept in shared memory when they fit), so the regime changes nothing it
  does: it decides only how columns group into bands, which only the
  plain twin and the JAX reference walk.
* **constant-propagated CSD folding** (int8 modes) — the per-plane
  ``2^w`` scales and digit signs are compile-time constants, so all planes
  of a block that stay on the matmul path fold into ONE int8 tile
  (``sum_w 2^w d_w`` — exactly the quantized block, by construction): one
  int32 tile product replaces ``width`` shifted plane products, with
  bit-identical results because int32 accumulation is exact.
* **shift-add strength reduction** — a digit plane of a block whose
  ``ones`` count falls below the crossover skips the matmul entirely: its
  few set digits are emitted as static shift-add terms
  (``acc[:, j] += ±(x[:, i] << w)``), the software mirror of the paper's
  synthesized adder trees.
* **batch tiling** — the batch axis splits into tiles of at most
  ``batch_tile_max`` rows; each CUDA thread block owns a column slice of
  one output column block and walks the batch tiles in turn.

Every schedule is arithmetic-order-safe: int8 terms accumulate in exact
int32 (any order gives the same bits) and fp32 terms keep the banded
kernel's ascending-row order — so the specialized program is bit-identical
to the generic banded kernel in every regime.  The lowering is the JAX
package's, unchanged, so the two packages' schedules and tiles are equal.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.sparse import int_matmul_exact
from repro_torch.plan.plan import DEFAULT_VMEM_BUDGET, ExecutionPlan

__all__ = [
    "MM",
    "SA",
    "DEFAULT_BATCH_TILE",
    "RolloutProgram",
    "specialize_rollout",
    "specialize_summary",
    "int8_recur_reference",
]

# Term tags in a band schedule (static tuples):
#   (MM, slot, shift, row_block)          one tile matmul, then << shift
#   (SA, row_block, ((i, j, sign, w)...)) unrolled shift-add digits
MM = 0
SA = 1

# Default cap on batch-tile rows (the serve pool of 16 slots is one tile).
DEFAULT_BATCH_TILE = 16


def default_crossover(block: int) -> int:
    """Set-digit count below which shift-adds replace a folded tile matmul.

    A folded (block x block) int8 tile costs one full tile product
    regardless of content; a shift-add plane costs ``ones`` adds.  Kept at
    the JAX package's value until the autotuner measures an H100 one.
    """
    return max(8, block // 2)


@dataclasses.dataclass(frozen=True)
class RolloutProgram:
    """A matrix-specialized rollout: banded folded tiles + static schedule.

    ``schedules`` is the nested static tuple — one entry per band, each
    listing ``(ci, terms)`` per output column block with :data:`MM`/:data:`SA`
    tagged terms.  ``data`` holds the folded weight tiles the MM terms
    index.
    """

    mode: str                  # "fp32" | "int8"
    block: int
    regime: str                # "resident" | "pipelined"
    data: np.ndarray           # (n_bands, max_terms, block, block)
    schedules: tuple
    max_terms: int
    vmem_budget: int | None
    crossover: int
    batch_tile_max: int
    n_matmul_terms: int        # folded-tile matmul terms kept
    n_shiftadd_terms: int      # (block, plane-group) shift-add terms
    shiftadd_digits: int       # unrolled digit adds across all SA terms
    resident_bytes: int        # weight bytes of one band (x2 if pipelined)

    @property
    def n_bands(self) -> int:
        return len(self.schedules)

    def batch_tiling(self, batch: int) -> tuple[int, int, int]:
        """(b_tile, n_tiles, b_padded) for a batch of ``batch`` rows.

        Tiles are balanced (``ceil(B / n_tiles)`` rows each) so padding
        never exceeds ``n_tiles - 1`` rows.
        """
        n_tiles = max(1, -(-batch // self.batch_tile_max))
        b_tile = -(-batch // n_tiles)
        return b_tile, n_tiles, b_tile * n_tiles

    def describe(self) -> str:
        dbl = " x2 (double-buffered)" if self.regime == "pipelined" else ""
        return (f"{self.mode} {self.regime}: {self.n_bands} band(s), "
                f"{self.resident_bytes} B weights{dbl}, "
                f"{self.n_matmul_terms} matmul terms + "
                f"{self.n_shiftadd_terms} shift-add terms "
                f"({self.shiftadd_digits} digit adds, "
                f"crossover {self.crossover})")


def _int8_block_lowering(plan: ExecutionPlan, di: int, crossover: int):
    """Constant-propagate one block's digit planes.

    Returns ``(mm_tiles, sa_digits)``: ``mm_tiles`` is a list of
    ``(tile_int8, shift)`` — one folded tile (shift 0) when the partial
    fold stays in int8 range, else the unfolded per-plane tiles — and
    ``sa_digits`` the strength-reduced ``(i, j, sign, w)`` terms of the
    planes below the crossover.
    """
    tiles = plan.int8_tiles                      # (width, n_nnz, bk, bk)
    keep = plan.plane_block_mask
    sa_digits: list[tuple] = []
    mm_planes: list[int] = []
    for w in range(plan.width):
        if not keep[w, di]:
            continue                              # culled at compile time
        plane = tiles[w, di]
        ones = int(np.count_nonzero(plane))
        if ones < crossover:
            ii, jj = np.nonzero(plane)
            sa_digits.extend(
                (int(i), int(j), int(plane[i, j]), w)
                for i, j in zip(ii, jj))
        else:
            mm_planes.append(w)
    if not mm_planes:
        return [], tuple(sa_digits)
    folded = sum(tiles[w, di].astype(np.int64) << w for w in mm_planes)
    if np.abs(folded).max() <= 127:
        # the full fold is always the quantized block (|q| <= 127); only a
        # *partial* fold — CSD's 2^width carry digit staying behind — can
        # overflow int8, in which case the planes stay separate.
        return [(folded.astype(np.int8), 0)], tuple(sa_digits)
    return ([(tiles[w, di], w) for w in mm_planes], tuple(sa_digits))


def _column_lowerings(plan: ExecutionPlan, mode: str, crossover: int):
    """Per output column block: ``[(ri, mm_tiles, sa_digits), ...]`` in the
    banded kernel's ascending-tile order."""
    rows, cols = plan.block_rows, plan.block_cols
    out: list[list] = []
    for ci in range(plan.nbc):
        entries = []
        for di in np.flatnonzero(cols == ci):
            ri = int(rows[di])
            if mode == "fp32":
                entries.append((ri, [(plan.fp32_tiles[int(di)], 0)], ()))
            else:
                mm, sa = _int8_block_lowering(plan, int(di), crossover)
                entries.append((ri, mm, sa))
        out.append(entries)
    return out


def _partition(plan: ExecutionPlan, col_mm_counts: np.ndarray,
               tile_bytes: int, vmem_budget: int | None):
    """Regime selection + greedy band packing over folded-term counts.

    Resident when every kept tile fits the budget at once; otherwise bands
    are capped at *half* the budget so two bands fit in flight.
    """
    total = int(col_mm_counts.sum()) * tile_bytes
    if vmem_budget is None or total <= vmem_budget:
        return "resident", ((0, plan.nbc),)
    cap = vmem_budget // 2
    spans: list[list[int]] = [[0, 0, 0]]          # [lo, hi, n_terms]
    for ci in range(plan.nbc):
        n = int(col_mm_counts[ci])
        if n * tile_bytes > cap:
            raise ValueError(
                f"column block {ci} alone needs {n * tile_bytes} B of folded "
                f"tiles > half the vmem_budget ({cap} B needed for double "
                f"buffering); raise the budget or compile with a smaller "
                f"block than {plan.block}")
        last = spans[-1]
        if last[1] > last[0] and (last[2] + n) * tile_bytes > cap:
            spans.append([ci, ci, 0])
            last = spans[-1]
        last[1] = ci + 1
        last[2] += n
    return "pipelined", tuple((lo, hi) for lo, hi, _n in spans)


def _lowerings(plan: ExecutionPlan, mode: str, crossover: int):
    """Column lowerings cached per ``(mode, crossover)`` on the plan — the
    expensive half of the analysis (digit-plane folding) is independent of
    the band budget and batch tile."""
    cache = getattr(plan, "_lowerings", None)
    if cache is None:
        cache = plan._lowerings = {}
    key = (mode, crossover)
    if key not in cache:
        cache[key] = _column_lowerings(plan, mode, crossover)
    return cache[key]


def _analyze(plan: ExecutionPlan, mode: str, crossover: int,
             vmem_budget: int | None) -> dict:
    """The shared schedule analysis both the summary and the full program
    build from: column lowerings, band partition, regime, and every
    derived count — ONE set of formulas.  Materializes no tile data."""
    cols = _lowerings(plan, mode, crossover)
    itemsize = 4 if mode == "fp32" else 1
    tile_bytes = plan.block * plan.block * itemsize
    counts = np.array([sum(len(mm) for _ri, mm, _sa in entries)
                       for entries in cols])
    regime, spans = _partition(plan, counts, tile_bytes, vmem_budget)
    max_terms = max(1, max(int(counts[lo:hi].sum()) for lo, hi in spans))
    return {
        "cols": cols,
        "spans": spans,
        "tile_bytes": tile_bytes,
        "max_terms": max_terms,
        "mode": mode,
        "regime": regime,
        "n_bands": len(spans),
        "n_matmul_terms": int(counts.sum()),
        "n_shiftadd_terms": sum(1 for entries in cols
                                for _ri, _mm, sa in entries if sa),
        "shiftadd_digits": sum(len(sa) for entries in cols
                               for _ri, _mm, sa in entries),
        "resident_bytes": max_terms * tile_bytes * (
            1 if regime == "resident" else 2),
        "crossover": crossover,
        "vmem_budget": vmem_budget,
    }


_SUMMARY_KEYS = ("mode", "regime", "n_bands", "n_matmul_terms",
                 "n_shiftadd_terms", "shiftadd_digits", "resident_bytes",
                 "crossover", "vmem_budget", "batch_tile_max")


def _summary_dict(src) -> dict:
    """Public summary fields from an analysis dict or RolloutProgram."""
    get = src.get if isinstance(src, dict) else lambda k: getattr(src, k)
    return {k: get(k) for k in _SUMMARY_KEYS}


def _check_mode(mode: str) -> None:
    if mode not in ("fp32", "int8"):
        raise ValueError(f"mode must be fp32 or int8, not {mode!r}")


def specialize_summary(plan: ExecutionPlan, mode: str = "fp32",
                       vmem_budget: int | None = DEFAULT_VMEM_BUDGET,
                       crossover: int | None = None,
                       batch_tile_max: int = DEFAULT_BATCH_TILE) -> dict:
    """Counts-level view of the specialization — what ``describe`` reports.

    Keyed on the full schedule tuple ``(mode, vmem_budget, crossover,
    batch_tile_max)``, the same key :func:`specialize_rollout` caches
    programs under.  Reads the fields off an already-cached
    :class:`RolloutProgram` when one exists; otherwise runs the shared
    analysis once (never materializing the banded data) and caches it on
    the plan.  Always returns a fresh dict.
    """
    _check_mode(mode)
    crossover = default_crossover(plan.block) if crossover is None else crossover
    key = (mode, vmem_budget, crossover, batch_tile_max)
    prog = getattr(plan, "_programs", {}).get(key)
    if prog is not None:
        return _summary_dict(prog)
    cache = getattr(plan, "_summaries", None)
    if cache is None:
        cache = plan._summaries = {}
    if key not in cache:
        cache[key] = _summary_dict(dict(
            _analyze(plan, mode, crossover, vmem_budget),
            batch_tile_max=batch_tile_max))
    return dict(cache[key])


def specialize_rollout(plan: ExecutionPlan, mode: str = "fp32",
                       vmem_budget: int | None = DEFAULT_VMEM_BUDGET,
                       crossover: int | None = None,
                       batch_tile_max: int = DEFAULT_BATCH_TILE,
                       ) -> RolloutProgram:
    """Lower one plan into a matrix-specialized :class:`RolloutProgram`.

    Cached per ``(mode, vmem_budget, crossover, batch_tile_max)`` on the
    plan — like the plan itself, the specialization is paid once per
    frozen matrix.
    """
    _check_mode(mode)
    crossover = default_crossover(plan.block) if crossover is None else crossover
    key = (mode, vmem_budget, crossover, batch_tile_max)
    cache = getattr(plan, "_programs", None)
    if cache is None:
        cache = plan._programs = {}
    if key in cache:
        return cache[key]

    t_spec = time.perf_counter()
    bk = plan.block
    dtype = np.float32 if mode == "fp32" else np.int8
    a = _analyze(plan, mode, crossover, vmem_budget)

    schedules: list[tuple] = []
    band_data: list[list[np.ndarray]] = []
    for lo, hi in a["spans"]:
        tiles: list[np.ndarray] = []
        band_cols = []
        for ci in range(lo, hi):
            terms: list[tuple] = []
            for ri, mm, sa in a["cols"][ci]:
                for tile, shift in mm:
                    terms.append((MM, len(tiles), shift, ri))
                    tiles.append(np.asarray(tile, dtype))
                if sa:
                    terms.append((SA, ri, sa))
            band_cols.append((ci, tuple(terms)))
        schedules.append(tuple(band_cols))
        band_data.append(tiles)

    data = np.zeros((a["n_bands"], a["max_terms"], bk, bk), dtype)
    for bi, tiles in enumerate(band_data):
        if tiles:
            data[bi, : len(tiles)] = np.stack(tiles)
    program = RolloutProgram(
        mode=mode, block=bk, regime=a["regime"], data=data,
        schedules=tuple(schedules), max_terms=a["max_terms"],
        vmem_budget=vmem_budget, crossover=crossover,
        batch_tile_max=batch_tile_max,
        n_matmul_terms=a["n_matmul_terms"],
        n_shiftadd_terms=a["n_shiftadd_terms"],
        shiftadd_digits=a["shiftadd_digits"],
        resident_bytes=a["resident_bytes"])
    cache[key] = program
    obs.span("plan.specialize", t_spec, time.perf_counter(), clock="wall",
             mode=mode, regime=a["regime"], n_bands=a["n_bands"])
    obs.event("specialize", mode=mode, regime=a["regime"])
    return program


def int8_recur_reference(program: RolloutProgram, xq: torch.Tensor,
                         rows_pad: int, out_cols: int) -> torch.Tensor:
    """Schedule-driven exact integer recurrent product.

    ``xq``: (..., rows) int32 quantized states -> (..., out_cols) int32 —
    bit-identical to ``FixedMatrix.matvec_int_exact`` because every term
    accumulates in exact int32.  The same schedule the CUDA kernel walks,
    in plain PyTorch (for parity tests).
    """
    if program.mode != "int8":
        raise ValueError("int8_recur_reference needs an int8 program")
    bk = program.block
    xp = xq.new_zeros(xq.shape[:-1] + (rows_pad,), dtype=torch.int32)
    xp[..., : xq.shape[-1]] = xq.to(torch.int32)
    data = torch.as_tensor(program.data, device=xq.device)
    pieces = []
    for bi, band in enumerate(program.schedules):
        for _ci, terms in band:
            acc = xq.new_zeros(xq.shape[:-1] + (bk,), dtype=torch.int32)
            for term in terms:
                if term[0] == MM:
                    _tag, slot, shift, ri = term
                    xs = xp[..., ri * bk:(ri + 1) * bk]
                    acc = acc + (int_matmul_exact(xs, data[bi, slot]) << shift)
                else:
                    _tag, ri, digits = term
                    for i, j, s, w in digits:
                        col = xp[..., ri * bk + i] << w
                        acc[..., j] += col if s > 0 else -col
            pieces.append(acc)
    return torch.cat(pieces, dim=-1)[..., :out_cols]
