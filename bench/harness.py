"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that names, its traffic
mix in ``bench/traffic/<mix>.json`` and each of its metrics in
``bench/metrics/<metric>.py`` (a module with ``read(run) -> float | None``;
``None`` leaves the metric out of the line).  Adding a cell, a mix or a
metric adds files and entries and edits none.

The program under test is the PyTorch port, ``repro_torch``: the
benchmark builds its weights from the seed (``bench/weights.py``), hands
them to the port's public constructors, drives the port's engine
(``bench/drive.py``) and judges what they answered against the
plain reference (``bench/check.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import time

import numpy as np
import torch

from bench import arith, check, drive, readers
from bench.devtrace import (DeviceTrace, attribute_gaps, busy_ns, clip,
                            idle_gaps, op_totals)
from bench.gen import Traffic
from bench.reference.esn import quantize
from bench.weights import make_weights

__all__ = ["BENCH_DIR", "ROOT", "Cell", "RunView", "load_cell",
           "metric_reader", "run_cell"]

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
WARM_REQUESTS = 4            # set-up requests of the engine path


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict                # the configuration file's contents
    mix: dict                # the traffic file's contents
    metrics: list            # BENCHMARK.json metric entries for this cell
    per_layer: list
    root: pathlib.Path = ROOT  # where BENCHMARK.json and the files are


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration
    and traffic mix."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config, traffic = cells[name]["config"], cells[name]["traffic"]
    confs = {c["name"]: c["file"] for c in bench["configs"]}
    cfg = json.loads((root / confs[config]).read_text())
    mix = json.loads((root / bench["paths"][0] / "traffic"
                      / f"{traffic}.json").read_text())
    return Cell(name=name, cfg=cfg, mix=mix,
                metrics=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)], root=root)


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    path = root / bench["paths"][0] / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class RunView:
    """What a metric reader reads: the cell, the window, the device trace
    (``None`` in an untraced run) and counts of the seed's matrix."""

    cell: Cell
    window: drive.Window
    trace: DeviceTrace | None
    setup_s: float
    nnz: int                 # nonzeros of the seed's matrix
    kept_blocks: int         # blocks of the quantized matrix with any
    arith: str               # "int8" or "fp32"

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    def device_ops(self) -> list:
        """The trace's device operations inside the window."""
        w = self.window
        return clip(self.trace.ops, w.t_open, w.t_last)

    def step_ops(self) -> int:
        c = self.cfg
        return arith.step_ops(self.nnz, c["reservoir_dim"], c["input_dim"],
                              c["output_dim"])


def build_program(cfg: dict, weights, seed: int, device):
    """The port's engine over the seed's weights, through its public
    constructors."""
    from repro_torch.core.esn import ESNConfig, ESNParams
    from repro_torch.core.sparse import FixedMatrix
    from repro_torch.serve import ReservoirEngine
    keys = ("reservoir_dim", "input_dim", "output_dim", "element_sparsity",
            "spectral_radius", "input_scale", "leak", "weight_bits",
            "state_bits", "mode", "block")
    ecfg = ESNConfig(**{k: cfg[k] for k in keys}, seed=int(seed) % (1 << 32))
    fm = FixedMatrix.compile(weights.dense, weight_bits=cfg["weight_bits"],
                             mode=ecfg.digit_mode, block=cfg["block"],
                             rng=np.random.default_rng(int(seed) % (1 << 63)))
    params = ESNParams(
        w=fm, w_in=torch.as_tensor(weights.w_in, device=device),
        w_out=torch.as_tensor(weights.w_out, device=device), config=ecfg)
    return ReservoirEngine(params, backend="auto", device=device)


def warm_up(engine, traffic) -> None:
    """Run every shape the window will use once: the shortest and the
    longest requests among a few of the mix's."""
    from repro_torch.serve import SubmitSpec
    for u in traffic.warm_requests(WARM_REQUESTS):
        engine.submit(SubmitSpec(u)).preds.cpu()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _kept_blocks(cfg: dict, dense: np.ndarray) -> int:
    q, _ = quantize(dense, cfg["weight_bits"])
    bk, r = cfg["block"], dense.shape[0]
    nb = -(-r // bk)
    pad = np.zeros((nb * bk, nb * bk), bool)
    pad[:r, :r] = q != 0
    return int(pad.reshape(nb, bk, nb, bk).any(axis=(1, 3)).sum())


def _device_info(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def _top(d: dict, n: int = 10) -> list:
    return [[name[:160], ns / 1e9] for name, ns in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             control: bool = False) -> dict:
    """One run: returns the result line's fields (``checks`` last), plus
    ``"_stderr"`` lines and, with ``control``, the control's ``pred_err``
    under ``"_control"``."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg = cell.cfg
    traced = bool(trace)
    marks = [("start", time.perf_counter())]
    weights = make_weights(cfg, seed, device)
    marks.append(("weights", time.perf_counter()))
    engine = build_program(cfg, weights, seed, device)
    marks.append(("program", time.perf_counter()))
    traffic = Traffic(cell.mix, seed, cfg["input_dim"])
    warm_up(engine, traffic)
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    tracer = DeviceTrace(device) if traced else None
    spans = [] if traced else None
    # the collector leaves set-up's objects (torch's modules, the port's
    # tables) alone during the window, as a serving process would after
    # start-up: a full collection over them is a pause of ~0.1 s
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    if tracer is not None:
        tracer.start()
    window = drive.drive_engine(engine, traffic, seconds, spans=spans)
    if tracer is not None:
        tracer.stop()
    else:
        _sync(device)
    gc.unfreeze()
    dev_info = _device_info(device)
    # the program's state goes before the reference runs on the device
    del engine
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    judged = check.check_window(cfg, weights, traffic, window, seed, device)
    view = RunView(cell=cell, window=window, trace=tracer, setup_s=setup_s,
                   nnz=weights.nnz, kept_blocks=_kept_blocks(cfg, weights.dense),
                   arith=arith.arith(cfg["mode"]))
    metrics = {}
    for m in (cell.per_layer if traced else cell.metrics):
        value = metric_reader(m["name"], cell.root)(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    numbers = judged["numbers"]
    correct = (judged["failed"] == 0
               and all(v["value"] <= v["limit"] for v in numbers.values()))
    out = {"correct": bool(correct), "attempted": len(window.due),
           "failed": int(judged["failed"]), "metrics": metrics,
           "device": dev_info}
    err = [f"cell {cell.name} seed {seed}: {len(window.due)} requests due, "
           f"{len(window.done)} answered, window {window.seconds:.6f} s, "
           f"set-up {setup_s:.6f} s, sample {len(judged['keys'])}",
           "set-up s: " + ", ".join(
               f"{n} {t - marks[i][1]:.6f}" for i, (n, t) in
               enumerate(marks[1:])) + f" (imports before: "
           f"{marks[0][1] - t_start:.6f})"]
    if tracer is not None:
        ops = view.device_ops()
        out["device"]["busy_s"] = busy_ns(ops) / 1e9
        out["device"]["window_s"] = window.seconds
        gaps = idle_gaps(tracer.ops, window.t_open, window.t_last)
        out["breakdown"] = {
            "device_ops": _top(op_totals(ops)),
            "idle_gaps": _top(attribute_gaps(gaps, window.spans))}
        least, bound = readers.rollout_least_s(view)
        first = next((o for o in tracer.ops if any(
            k in o[0] for k in readers.ROLLOUT_KERNELS)), None)
        lead = (first[1] - window.spans[0][1]) / 1e3 if first else None
        err.append(f"trace: {len(tracer.ops)} device operations, "
                   f"{len(window.spans)} host spans, rollout bound "
                   f"{bound} ({least:.9f} s), first rollout kernel "
                   f"{lead} us after the first host span, clock offsets "
                   f"differ by {tracer.offset_check_us} us")
    if control:
        out["_control"] = check.control_numbers(
            cfg, weights, traffic, judged["keys"], judged["refs"], device)
    err += [f"check {k}: {v['value']!r} limit {v['limit']!r}"
            for k, v in numbers.items()]
    out["checks"] = numbers
    out["_stderr"] = err
    return out
