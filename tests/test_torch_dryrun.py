"""The dry run (``lower_cell``, ``run_cell_inline``, ``dryrun.main``) and
its reports against the JAX package's, on the CPU.

Cells of reduced configs on small meshes (2 x 2, and 2 x 2 x 2), one per
block family and shape kind: MHA train (on the 2 x 2 and the 2 x 2 x 2),
MoE decode and prefill on the 2 x 2 x 2 (whose 'pod' and 'data' are one
DTensor mesh dim, ``sharding.mesh_dims``), MoE train with ZeRO
gradient shardings (``expert_fsdp=False``), int8 prefill
(``frozen_sparse_serving``, with both packages' ``MIN_QUANT_SIZE`` lowered
to 256 so the reduced leaves quantize), MLA decode, xLSTM decode, RG-LRU +
local attention prefill, the enc-dec prefill and the vision train step;
and a cell the config does not support (``long_500k`` on a full-attention
arch, through both packages' ``run_cell_inline``).  The reference lowers
each on 8 host devices in one subprocess (``_dryrun_reference.py``, once
per test run for all xdist workers); the port runs each on rank 0 of a
fake world of the mesh's size, within ``CELL_TIMEOUT`` seconds.  Held per
cell:

  * ``param_count``, ``status`` (and the skip reason) and the step's
    ``meta`` equal;
  * the argument bytes of parameters and optimizer state equal: each
    side's ``argument_bytes`` less the local bytes of its batch, caches
    and token (the port's token ids are int64, the reference's int32);
  * dot FLOPs per device within ``FLOP_RTOL`` (10 %) of the walker's,
    ``FLOP_RTOL_CASE`` where a cell needs more.  The tally counts the
    products eager PyTorch runs (``mm`` / ``bmm`` at their local shapes),
    the walker the dots XLA kept after its optimizations and partitioning:
    the MoE, MLA, RG-LRU, int8 and vision cells differ by 1.4-9.6 % (XLA
    folds or partitions some products differently), the enc-dec prefill
    and the MHA train steps agree exactly, and the xLSTM decode step
    carries 31 % more in the port (its sLSTM region's gate products).

The reports: ``cell_report`` / ``to_markdown`` / ``dryrun_table`` of the
same records equal the reference's bit for bit, with the reference's
``PEAK_FLOPS`` / ``HBM_BW`` / ``LINK_BW`` set to the port's H100 figures
(``monkeypatch``; the reference file is not edited) and the "peak fits"
threshold read as 80 GB where the reference writes 16 (records below 16
GB or above 80 GB, so both thresholds agree).
"""

import contextlib
import copy
import fcntl
import json
import math
import os
import pathlib
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro_torch.configs as tcfg

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT = 600.0
# one port cell in this process: a cell that stalls (as the 3-D train and
# prefill steps once did in DTensor's redistribute planner, ROADMAP
# C-port-7) fails here instead of holding the suite
CELL_TIMEOUT = 300
FLOP_RTOL = 0.10
# the xLSTM decode step: the port's sLSTM region projects the gates of the
# whole (local) batch on weights gathered whole, where XLA partitions part
# of that product over 'model' (31 % more per device in this cell)
FLOP_RTOL_CASE = {"xlstm_decode": 0.35}
M22 = ((2, 2), ("data", "model"))
M222 = ((2, 2, 2), ("pod", "data", "model"))
TRAIN, PREFILL, DECODE = (16, 8, "train"), (32, 4, "prefill"), \
    (32, 4, "decode")
CASES = {
    "stablelm_train_22": dict(arch="stablelm-1.6b", shape=TRAIN, mesh=M22),
    "stablelm_train_222": dict(arch="stablelm-1.6b", shape=TRAIN,
                               mesh=M222),
    "olmoe_decode_222": dict(arch="olmoe-1b-7b", shape=DECODE, mesh=M222),
    "olmoe_prefill_222": dict(arch="olmoe-1b-7b", shape=PREFILL,
                              mesh=M222),
    "olmoe_train_zero": dict(arch="olmoe-1b-7b", shape=TRAIN, mesh=M22,
                             overrides={"expert_fsdp": False}),
    "mistral_prefill_int8": dict(
        arch="mistral-nemo-12b", shape=PREFILL, mesh=M22,
        overrides={"frozen_sparse_serving": True}, min_quant=256),
    "deepseek_decode": dict(arch="deepseek-v2-236b", shape=DECODE,
                            mesh=M22),
    "xlstm_decode": dict(arch="xlstm-350m", shape=DECODE, mesh=M22),
    "rgemma_prefill": dict(arch="recurrentgemma-2b", shape=PREFILL,
                           mesh=M22),
    "whisper_prefill": dict(arch="whisper-base", shape=PREFILL, mesh=M22),
    "internvl_train": dict(arch="internvl2-76b", shape=TRAIN, mesh=M22,
                           overrides={"microbatches": 2}),
    "gemma_skip": dict(arch="gemma-2b", skip=True, shape_name="long_500k"),
}
# cells whose products are the same operations in both packages
EXACT = ("stablelm_train_22", "stablelm_train_222")


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free the XLA executables this module compiled (ROADMAP C-port-5)."""
    yield
    jax.clear_caches()


def _run_reference(workdir: pathlib.Path) -> None:
    cases = workdir / "cases.json"
    cases.write_text(json.dumps(CASES))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    with open(workdir / "reference.log", "w") as log:
        proc = subprocess.run(
            [sys.executable, str(HERE / "_dryrun_reference.py"), str(cases),
             str(workdir / "reference.json")], stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=str(workdir),
            timeout=TIMEOUT, preexec_fn=lambda: os.nice(10))
    if proc.returncode != 0:
        raise RuntimeError((workdir / "reference.log").read_text()[-4000:])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's records, made once per test run (a file lock
    shares them between xdist workers)."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        root = tmp_path_factory.mktemp("dryrun_ref")
        _run_reference(root)
    else:
        root = tmp_path_factory.getbasetemp().parent / f"dryrun_ref-{uid}"
        with open(f"{root}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not (root / "done").exists():
                root.mkdir(exist_ok=True)
                _run_reference(root)
                (root / "done").touch()
    return json.loads((root / "reference.json").read_text())


def _local_bytes(tree) -> int:
    from repro_torch.models.common import tree_leaves
    from repro_torch.parallel.sharding import mesh_dim_sizes
    total = 0
    for sds in tree_leaves(tree):
        shape = list(sds.shape)
        if sds.sharding is not None:
            sizes = mesh_dim_sizes(sds.sharding.mesh)
            for i, p in enumerate(sds.sharding.placements):
                if hasattr(p, "dim"):
                    shape[p.dim] //= sizes[i]
        total += math.prod(shape) * sds.dtype.itemsize
    return total


@contextlib.contextmanager
def _time_limit(seconds: int):
    def stop(*_):
        raise TimeoutError(f"the cell ran over {seconds} s")

    old = signal.signal(signal.SIGALRM, stop)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def port_record(case) -> dict:
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import run_cell_inline
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models.transformer import LM

    cfg = tcfg.reduced(tcfg.get_config(case["arch"]))
    if case.get("overrides"):
        cfg = cfg.replace(**case["overrides"])
    if case.get("skip"):
        rec = run_cell_inline(case["arch"], case["shape_name"], False,
                              save_hlo=False)
        return {"status": rec["status"], "reason": rec.get("reason")}
    seq, batch, kind = case["shape"]
    shape = ShapeSpec("cell", seq, batch, kind)
    sizes, names = case["mesh"]
    with fake_world(math.prod(sizes)):
        mesh = make_mesh(sizes, names)
        lowered, meta = lower_cell(cfg, shape, mesh)
        compiled = lowered.compile()
        lm = LM(cfg, device="meta")
        if kind == "decode":
            extra = (specs.cache_specs(lm, shape, mesh),
                     specs.token_spec(shape, mesh))
        else:
            extra = specs.batch_specs(cfg, shape, mesh)
        extra = {str(i): t for i, t in enumerate(extra)} \
            if isinstance(extra, tuple) else extra
        return {"status": "ok", **meta,
                "argument_bytes": compiled.memory_analysis()[
                    "argument_bytes"],
                "memory": compiled.memory_analysis(),
                "input_bytes": _local_bytes(extra),
                "hlo_walk": compiled.walk(),
                "op_table": compiled.op_table(),
                "param_count": lm.param_count()}


_RECORDS = {}


def record_of(name) -> dict:
    """``port_record`` of ``CASES[name]``, lowered once per process within
    ``CELL_TIMEOUT`` seconds (the op-table test reads the cell the parity
    test lowers)."""
    if name not in _RECORDS:
        with _time_limit(CELL_TIMEOUT):
            _RECORDS[name] = port_record(CASES[name])
    return _RECORDS[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_cell_matches_reference(name, reference, monkeypatch):
    from repro_torch.models import quantize as tquant
    case = CASES[name]
    if case.get("min_quant"):
        monkeypatch.setattr(tquant, "MIN_QUANT_SIZE", case["min_quant"])
    got = record_of(name)
    want = reference[name]
    assert got["status"] == want["status"]
    if case.get("skip"):
        assert got["reason"] == want["reason"] and got["reason"]
        return
    assert got["param_count"] == want["param_count"]
    assert {k: got[k] for k in ("step", "donated") if k in got} == \
        {k: want[k] for k in ("step", "donated") if k in want}
    # parameters and optimizer state: the same bytes on rank 0
    assert (got["argument_bytes"] - got["input_bytes"]
            == want["argument_bytes"] - want["input_bytes"])
    mem = got["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    if case["shape"][2] == "train":
        # the state is written in place: every parameter and moment
        assert mem["alias_bytes"] >= (got["argument_bytes"]
                                      - got["input_bytes"]) - 64
    g, w = got["hlo_walk"]["dot_flops"], want["hlo_walk"]["dot_flops"]
    if name in EXACT:
        assert g == w
    assert abs(g - w) <= FLOP_RTOL_CASE.get(name, FLOP_RTOL) * w, (g, w)
    assert set(got["hlo_walk"]) == set(want["hlo_walk"])


def test_op_table_lines_add_up_to_the_totals():
    """The op table's per-operation lines sum to the per-device dot FLOPs
    and collective bytes it heads with, and on the 2 x 2 x 2 a collective
    over the data axes runs over one group of pod x data = 4 ranks."""
    rec = record_of("stablelm_train_222")
    walk = rec["hlo_walk"]
    lines = rec["op_table"].splitlines()
    ops = [ln.split() for ln in lines if ln.startswith("op ")]
    total = {}
    for op in ops:
        total[op[1]] = total.get(op[1], 0.0) + float(op[-1][len("total="):])
    assert total["dot"] == walk["dot_flops"] > 0
    for kind, b in walk["collective_bytes"].items():
        assert total[kind] == b
    groups = {op[op.index("group") + 1] for op in ops if "group" in op}
    assert "4" in groups and groups <= {"2", "4", "8"}


def test_int8_cell_has_int8_arguments(monkeypatch):
    """``frozen_sparse_serving`` makes the prefill's parameters int8: its
    argument bytes fall below the bf16 cell's."""
    from repro_torch.models import quantize as tquant
    monkeypatch.setattr(tquant, "MIN_QUANT_SIZE", 256)
    case = dict(CASES["mistral_prefill_int8"])
    q = port_record(case)
    case["overrides"] = {}
    b = port_record(case)
    assert q["argument_bytes"] < b["argument_bytes"]


# -- the CLI and its records ---------------------------------------------------
def test_main_writes_a_record_with_the_reference_keys(tmp_path, monkeypatch,
                                                      capsys):
    from repro_torch.launch import dryrun, report, roofline
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    monkeypatch.setattr(roofline, "RESULTS", tmp_path)
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--cell", "stablelm-1.6b", "decode_32k",
        "--override", "n_layers=2", "--override", "d_model=256",
        "--override", "d_ff=512", "--override", "vocab_size=4096"])
    dryrun.main()
    p = dryrun.cell_path("stablelm-1.6b", "decode_32k", False)
    rec = json.loads(p.read_text())
    assert rec["status"] == "ok", rec
    assert set(rec) >= {"arch", "shape", "mesh", "n_devices", "variant",
                        "overrides", "t_lower_s", "t_compile_s", "step",
                        "donated", "memory_per_device", "cost_analysis_raw",
                        "hlo_walk", "t_walk_s", "param_count", "status"}
    assert rec["mesh"] == "16x16" and rec["n_devices"] == 256
    assert rec["overrides"] == {"n_layers": 2, "d_model": 256, "d_ff": 512,
                                "vocab_size": 4096}
    assert set(rec["memory_per_device"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_bytes"}
    assert p.with_suffix(".ops.txt.gz").exists()
    # cached unless --force
    dryrun.main()
    assert "cached:" in capsys.readouterr().out
    assert roofline.cell_report(rec)["dominant"] in ("compute", "memory",
                                                     "collective")
    assert "stablelm-1.6b | decode_32k | 16x16 | ok" in report.dryrun_table()


def test_cell_paths_and_overrides_equal_reference():
    from repro.launch import dryrun as jd
    from repro_torch.launch import dryrun as td
    for args in (("a", "train_4k", False, ""), ("b", "decode_32k", True,
                                                "v1")):
        assert td.cell_path(*args).relative_to(td.RESULTS) == \
            jd.cell_path(*args).relative_to(jd.RESULTS)
    assert td.RESULTS.name == "dryrun_torch" != jd.RESULTS.name
    pairs = ["a=1", "b=true", "c=False", "d=0.5", "e=x"]
    assert td.parse_overrides(pairs) == jd.parse_overrides(pairs)
    assert list(td.all_cells()) == list(jd.all_cells())


# -- the reports ---------------------------------------------------------------
def _records() -> list:
    """Synthetic records of every arch and shape (walker numbers and peaks
    drawn from a seeded generator; peaks below 16 GB or above 80 GB), a
    skipped one and an error."""
    rng = np.random.default_rng(3)
    out = []
    for arch in jcfg.list_archs():
        for shape in jcfg.SHAPES:
            peak = float(rng.choice([rng.uniform(1, 15), rng.uniform(81, 200)
                                     ])) * 2 ** 30
            out.append({
                "arch": arch, "shape": shape, "mesh": "16x16",
                "n_devices": 256, "variant": "", "status": "ok",
                "step": "train_step", "t_compile_s": 1.5,
                "param_count": int(rng.integers(1e8, 1e11)),
                "hlo_walk": {
                    "dot_flops": float(10 ** rng.uniform(8, 16)),
                    "conv_flops": float(rng.choice([0.0, 1e9])),
                    "total_collective_bytes": float(10 ** rng.uniform(
                        5, 12))},
                "memory_per_device": {
                    "argument_bytes": int(peak * 0.3),
                    "temp_bytes": int(peak * 0.7), "peak_bytes": int(peak)},
            })
    out.append({"arch": "gemma-2b", "shape": "long_500k", "mesh": "16x16",
                "status": "skipped", "variant": ""})
    out.append({"arch": "qwen3-32b", "shape": "train_4k", "mesh": "16x16",
                "status": "error", "variant": ""})
    return out


def _h100(monkeypatch):
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline as troof
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroof, name, getattr(troof, name))
    return jroof, troof


def test_cell_report_and_markdown_equal_reference(monkeypatch):
    jroof, troof = _h100(monkeypatch)
    recs = _records()
    got = [troof.cell_report(copy.deepcopy(r)) for r in recs]
    want = [jroof.cell_report(copy.deepcopy(r)) for r in recs]
    assert got == want
    assert sum(r is None for r in got) == 2
    rows = [r for r in got if r]
    assert troof.to_markdown(rows) == jroof.to_markdown(rows)
    assert {r["dominant"] for r in rows} == {"compute", "memory",
                                             "collective"}


def test_dryrun_table_equals_reference(tmp_path, monkeypatch):
    from repro.launch import report as jrep
    from repro_torch.launch import report as trep
    jroof, troof = _h100(monkeypatch)
    for mesh_dir in ("pod16x16", "pod2x16x16"):
        d = tmp_path / mesh_dir
        d.mkdir()
        for i, rec in enumerate(_records()):
            (d / f"{i:03d}.json").write_text(json.dumps(rec))
        (d / "variant.json").write_text(json.dumps(
            {**_records()[0], "variant": "v"}))
    monkeypatch.setattr(jroof, "RESULTS", tmp_path)
    monkeypatch.setattr(troof, "RESULTS", tmp_path)
    want = jrep.dryrun_table().replace("16GB", "80GB")
    assert trep.dryrun_table() == want
    assert trep.roofline_table() == jrep.roofline_table()
    assert "| NO |" in want and "| yes |" in want
    assert trep.HBM_GB == 80
    assert len(troof.load_all("pod16x16")) == len(_records())
    assert len(troof.load_all("pod16x16", variants=True)) == 1
