"""The span reductions of ``bench/spans.py``, worked by hand:
``python -m pytest bench/test_bench_spans.py``."""

import pytest

from bench import devtrace, spans

US = 1000                     # the spans and operations are in ns

# two requests of the one-shot path: (name, start, end, trace_id, parent)
RS = "request.serve"
PROGRAM = [
    ("engine.prepare", 13 * US, 20 * US, "t-1", RS),
    ("rollout.launch", 22 * US, 40 * US, "t-1", RS),
    ("engine.sync", 45 * US, 95 * US, "t-1", RS),
    (RS, 12 * US, 98 * US, "t-1", None),
    ("engine.prepare", 201 * US, 205 * US, "t-2", RS),
    ("rollout.launch", 210 * US, 230 * US, "t-2", RS),
    ("engine.sync", 231 * US, 395 * US, "t-2", RS),
    (RS, 200 * US, 400 * US, "t-2", None),
]
OPS = [
    ("Memcpy HtoD (Pageable -> Device)", 15 * US, 17 * US),
    ("void rollout_kernel<true>(Params)", 50 * US, 90 * US),
    ("Memcpy DtoH (Device -> Pageable)", 103 * US, 105 * US),
    ("void rollout_kernel<true>(Params)", 260 * US, 380 * US),
]


def test_lead_tail_and_enqueue_hand_worked():
    # request 1: kernel 50-90 in a root 12-98, launch 22-40;
    # request 2: kernel 260-380 in a root 200-400, launch 210-230
    assert spans.submit_lead_us(PROGRAM, OPS) == pytest.approx(
        (38 + 60) / 2)
    assert spans.submit_tail_us(PROGRAM, OPS) == pytest.approx(
        (8 + 20) / 2)
    assert spans.launch_enqueue_us(PROGRAM, OPS) == pytest.approx(
        (18 + 20) / 2)
    # a launch with no request (run_segment's, the scheduler's) is no
    # request's, and the copies are no rollout kernel
    extra = PROGRAM + [("rollout.launch", 500 * US, 510 * US, None, None)]
    assert spans.launch_enqueue_us(extra, OPS) == pytest.approx(19)
    (r, la, k), _ = spans.requests(PROGRAM, OPS)
    assert (r[3], la[0], k[1]) == ("t-1", "rollout.launch", 50 * US)


@pytest.mark.parametrize("case", [
    "no spans", "no kernel", "two kernels", "no launch", "two launches",
    "untraced"])
def test_readers_refuse_an_unpaired_request(case):
    prog, ops = list(PROGRAM), list(OPS)
    if case == "no spans":
        prog = []
    elif case == "no kernel":
        ops = ops[:3]
    elif case == "two kernels":
        ops.append(("void rollout_kernel<true>(Params)", 385 * US,
                    390 * US))
    elif case == "no launch":
        prog.pop(5)
    elif case == "two launches":
        prog.append(("rollout.launch", 240 * US, 250 * US, "t-2", RS))
    else:
        prog = None
    for read in (spans.submit_lead_us, spans.submit_tail_us,
                 spans.launch_enqueue_us):
        assert read(prog, ops) is None


def test_program_spans_refuse_a_dropped_span():
    from repro_torch.obs import Tracer
    tr = Tracer(capacity=4)
    tr.record("a", 1.0, 1.5, trace_id="t-1")
    tr.record("b", 2.0, 2.25)
    tr.record("queued", 2.0, 3.0, clock="server")
    tr.record("late", 9.0, 9.5)
    got = spans.program_spans(tr, 0, 5 * 10 ** 9)
    assert got == [("a", 10 ** 9, 1_500_000_000, "t-1", None),
                   ("b", 2 * 10 ** 9, 2_250_000_000, None, None)]
    tr.record("e", 3.0)
    assert tr.dropped == 1
    assert spans.program_spans(tr, 0, 5 * 10 ** 9) is None
    assert spans.program_spans(None, 0, 1) is None


def test_innermost_attribution_hand_worked():
    bench = [("generator", 0, 10 * US), ("submit", 10 * US, 100 * US),
             ("copy", 100 * US, 110 * US)]
    gaps = devtrace.idle_gaps(OPS, 0, 120 * US)
    assert gaps == [(0, 15 * US), (17 * US, 50 * US), (90 * US, 103 * US),
                    (105 * US, 120 * US)]
    got = spans.attribute_innermost(gaps, bench + PROGRAM[:4])
    assert got == {k: v * US for k, v in {
        "generator": 10, "submit": 2 + 2, RS: 1 + 2 + 5 + 3,
        "engine.prepare": 2 + 3, "rollout.launch": 18,
        "engine.sync": 5 + 5, "copy": 3 + 5, "harness": 10}.items()}
    # the same gaps in all: the program's spans only split them finer
    assert sum(got.values()) == sum(g1 - g0 for g0, g1 in gaps)
    assert devtrace.attribute_gaps(gaps, bench) == {
        "generator": 10 * US, "submit": 48 * US, "copy": 8 * US,
        "harness": 10 * US}


@pytest.mark.parametrize("bench,gaps", [
    ([("submit", 14, 18), ("copy", 18, 19), ("step", 32, 44)],
     [(15, 20), (30, 40), (45, 50)]),
    ([("generator", 0, 10 * US), ("submit", 10 * US, 100 * US),
      ("copy", 100 * US, 110 * US)],
     devtrace.idle_gaps(OPS, 0, 120 * US))])
def test_innermost_equals_the_benchmark_attribution_without_the_program(
        bench, gaps):
    assert (spans.attribute_innermost(gaps, bench)
            == devtrace.attribute_gaps(gaps, bench))
    assert spans.attribute_innermost(gaps, []) == {
        "harness": sum(g1 - g0 for g0, g1 in gaps)}


def test_reanchor_hand_worked():
    # latencies 20, 20, 20, 120, 220: the device clock runs late from the
    # fourth launch on; rolling medians over 1 launch each side, 20, 20,
    # 20, 120, 170, hold 20 longest: the error reads 0, 0, 0, 100, 150
    launches = [(100, 80), (300, 280), (500, 480), (720, 600), (920, 700)]
    ops = [("Memcpy HtoD", 50, 60), ("rollout_kernel<true>", 100, 290),
           ("rollout_kernel<true>", 300, 350), ("Memcpy DtoH", 360, 370),
           ("rollout_kernel<true>", 500, 690), ("rollout_kernel<true>",
                                                 720, 900),
           ("Memcpy DtoH", 905, 910), ("rollout_kernel<true>", 920, 990)]
    got, err = spans.reanchor(ops, launches, half=1, bin_ns=50)
    assert got == ops[:5] + [("rollout_kernel<true>", 620, 800),
                             ("Memcpy DtoH", 805, 810),
                             ("rollout_kernel<true>", 770, 840)]
    assert err["latency_us"] == pytest.approx(0.02)
    assert err["error_us"][0] == 0 and err["error_us"][-1] == pytest.approx(
        0.15)
    # one slow launch among steady ones is latency, not clock error
    steady = [(100 * i + 20, 100 * i) for i in range(9)]
    steady[4] = (460, 400)
    moved, _ = spans.reanchor(ops, steady, half=2, bin_ns=50)
    assert moved == ops
    assert spans.reanchor(ops, []) == (ops, {})
    # a clock late from the first launch on: the level held longest wins
    late = [(100 * i + (420 if i < 3 else 20), 100 * i) for i in range(8)]
    _, err = spans.reanchor(ops, late, half=1, bin_ns=50)
    assert err["latency_us"] == pytest.approx(0.02)
    assert err["error_us"][-1] == pytest.approx(0.4)
