"""The yardstick: generators, arithmetic, trace reductions, discovery by
name and the names in ``BENCHMARK.json``."""

import json
import re
import shutil

import numpy as np
import pytest

from bench import arith, devtrace, gen
from bench.conftest import ROOT, SEED

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MIXES = sorted(p.stem for p in (ROOT / "bench" / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_repeats_per_seed(mix):
    m = _mix(mix)
    a, b = gen.Traffic(m, SEED, 1), gen.Traffic(m, SEED, 1)
    for k in (0, 1, 63, 700, 5000):
        assert a.length(k) == b.length(k)
        np.testing.assert_array_equal(a.inputs(k), b.inputs(k))
    c = gen.Traffic(m, SEED + 1, 1)
    assert [a.length(k) for k in range(64)] != [c.length(k) for k in range(64)]


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_gets_the_same_work(mix):
    """Whole blocks hold the same lengths whatever the seed."""
    m = _mix(mix)
    want = sorted(gen.block_lengths(m["lengths"]))
    block = len(want)
    for seed in (0, 7, SEED, -5, 2 ** 70 + 3):
        t = gen.Traffic(m, seed, 1)
        for blk in (0, 3):
            got = sorted(t.length(k) for k in range(blk * block,
                                                     (blk + 1) * block))
            assert got == want


def test_block_lengths_hand_worked():
    q = gen.block_lengths({"dist": "values", "values": [6000, 120, 2999]})
    assert q.tolist() == [120, 2999, 6000]
    with pytest.raises(ValueError):
        gen.block_lengths({"dist": "loguniform", "min": 1, "max": 16})


def test_percentile_hand_worked():
    assert arith.percentile([4, 1, 3, 2], 50) == 2.5
    assert arith.percentile([10.0], 95) == 10.0
    xs = list(range(1, 101))
    assert arith.percentile(xs, 95) == pytest.approx(95.05)
    rng = np.random.default_rng(1)
    v = rng.exponential(size=997)
    assert arith.percentile(v, 95) == pytest.approx(np.percentile(v, 95))


def test_roofline_and_mfu_hand_worked():
    # 2 steps x 3 rows x (2*10 + 2*4*1 + 2*4*1) operations
    assert arith.launch_ops(10, 4, 1, 1, 2, 3) == 216
    # one 2x2 int8 block, W_in + W_out (32), u and x0 (4*(6+12)),
    # y and x(T) (4*(6+12))
    assert arith.launch_bytes(1, 2, 1, 4, 1, 1, 2, 3) == 4 + 32 + 72 + 72
    s, bound = arith.least_seconds(1979e12, 1.0, "int8")
    assert (s, bound) == (1.0, "compute")
    s, bound = arith.least_seconds(1.0, 3.35e12 * 2, "fp32")
    assert (s, bound) == (pytest.approx(2.0), "memory")
    assert arith.roofline_pct(1.0, 4.0) == 25.0
    assert arith.mfu_pct(67e12, 2.0, "fp32") == pytest.approx(50.0)
    with pytest.raises(ValueError):
        arith.roofline_pct(1.0, 0.0)


def test_trace_reductions_hand_worked():
    ops = [("a", 0, 10), ("b", 5, 15), ("a", 20, 30), ("c", 40, 45)]
    assert devtrace.busy_ns(ops) == 15 + 10 + 5
    assert devtrace.idle_gaps(ops, 0, 50) == [(15, 20), (30, 40), (45, 50)]
    assert devtrace.idle_gaps(ops, 12, 42) == [(15, 20), (30, 40)]
    assert devtrace.op_totals(ops) == {"a": 20, "b": 10, "c": 5}
    assert devtrace.clip(ops, 8, 22) == [("a", 8, 10), ("b", 8, 15),
                                         ("a", 20, 22)]
    spans = [("submit", 14, 18), ("copy", 18, 19), ("step", 32, 44)]
    got = devtrace.attribute_gaps([(15, 20), (30, 40), (45, 50)], spans)
    assert got == {"submit": 3, "copy": 1, "harness": 1 + 2 + 5, "step": 8}


def test_new_files_are_found_by_name(tmp_path, tiny):
    """A configuration, a traffic mix and a metric added as files (and
    entries in BENCHMARK.json) run with no other file edited."""
    from bench.harness import load_cell, metric_reader, run_cell
    from bench.conftest import shrink
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/esn1024-csd95.json").read_text())
    cfg.update(name="esn256-csd90", reservoir_dim=256, element_sparsity=0.9)
    (tmp_path / "bench/configs/esn256-csd90.json").write_text(json.dumps(cfg))
    mix = _mix("stream")
    mix["lengths"] = {"dist": "values", "values": [24]}
    (tmp_path / "bench/traffic/fixed24.json").write_text(json.dumps(mix))
    (tmp_path / "bench/metrics/answered_requests.py").write_text(
        "def read(run):\n    return len(run.window.done)\n")
    bench["configs"].append({"name": "esn256-csd90", "source": "x",
                             "file": "bench/configs/esn256-csd90.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "esn256-csd90.fixed24",
                               "config": "esn256-csd90",
                               "traffic": "fixed24", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "answered_requests", "unit": "1",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["esn256-csd90.fixed24"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("esn256-csd90.fixed24", tmp_path)
    assert cell.cfg["reservoir_dim"] == 256 and cell.root == tmp_path
    assert [m["name"] for m in cell.metrics][-1] == "answered_requests"
    assert metric_reader("answered_requests", tmp_path)
    out = run_cell(shrink(cell), SEED, 0.3, False, device="cpu")
    assert out["correct"]
    assert out["metrics"]["answered_requests"]["value"] == out["attempted"]


def test_benchmark_json_follows_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "bench/run.py"]
    assert b["paths"] == ["bench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert (ROOT / "bench/traffic" / f"{w['traffic']}.json").is_file()
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"steps_per_s", "latency_p95_ms", "setup_s"}
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", [])) <= set(cells)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:     # every cell reports a per-layer metric
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024
