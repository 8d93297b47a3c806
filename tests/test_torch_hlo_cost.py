"""``launch/hlo_cost.py``: the copied HLO walker and the port's own tally.

The walker is the JAX package's, copied: on the reference's own HLO texts
(``tests/test_parallel.py``'s two) and on HLO text the reference compiles
here it returns the reference's dict exactly.

The port's ``StepTally`` is held to the reference's ground truth
(``tests/test_parallel.py``'s walker test: a 4 x 4 mesh, 7 iterations of
``relu(c @ w1) @ w2`` with x over 'data', w1's columns and w2's rows over
'model'): per-device dot FLOPs within 1 % of 7 * 2 * (2 * 64 * 512 * 1024)
/ 16 (here exact), and all-reduce bytes > 0 (the Partial product summed
over 'model').  The step runs on rank 0 of a fake world of 16 ranks on
meta tensors.  On a mesh of one its dot FLOPs equal
``torch.utils.flop_counter.FlopCounterMode``'s count of the same step with
``mesh=None`` (exactly: the same operations at the same shapes), which
is what ``chip_smoke.py``'s ``dryrun`` phase holds against a real step on
the card.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import hlo_cost as jhlo
from repro_torch.launch import hlo_cost as thlo


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free the XLA executables this module compiled (ROADMAP C-port-5)."""
    yield
    jax.clear_caches()


INDEX_COMMENTS = """ENTRY %main.1 (p0: f32[4,4], /*index=1*/p1: f32[4,4]) -> f32[4,4] {
  %p0 = f32[4,4]{1,0} parameter(0)
  %p1 = f32[4,4]{1,0} parameter(1)
  ROOT %dot.1 = f32[4,4]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}"""

TRIP_COUNT = """%body.1 (p: (s32[], f32[2,2])) -> (s32[], f32[2,2]) {
  %p = (s32[], f32[2,2]{1,0}) parameter(0)
  %a = f32[2,2]{1,0} get-tuple-element(%p), index=1
  %d = f32[2,2]{1,0} dot(%a, %a), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%cond.1 (p: (s32[], f32[2,2])) -> pred[] {
  %p = (s32[], f32[2,2]{1,0}) parameter(0)
  %c = s32[] constant(99)
}

ENTRY %main.2 (p0: (s32[], f32[2,2])) -> (s32[], f32[2,2]) {
  %p0 = (s32[], f32[2,2]{1,0}) parameter(0)
  ROOT %w = (s32[], f32[2,2]{1,0}) while(%p0), condition=%cond.1, body=%body.1, backend_config={"known_trip_count":{"n":"5"}}
}"""

COLLECTIVES = """ENTRY %main.3 (p0: f32[8,16]) -> f32[8,16] {
  %p0 = f32[8,16]{1,0} parameter(0)
  %ar = f32[8,16]{1,0} all-reduce(%p0), replica_groups={{0,1}}, to_apply=%add
  %ag = f32[16,16]{1,0} all-gather(%ar), dimensions={0}
  %rs = bf16[4,16]{1,0} reduce-scatter(%ag), dimensions={0}
  %a2a = f32[8,16]{1,0} all-to-all(%p0), dimensions={0}
  ROOT %cp = f32[8,16]{1,0} collective-permute(%a2a), source_target_pairs={{0,1}}
}"""


@pytest.mark.parametrize("text", [INDEX_COMMENTS, TRIP_COUNT, COLLECTIVES],
                         ids=["index_comments", "trip_count", "collectives"])
def test_walker_equals_reference_on_hlo_text(text):
    got, want = thlo.analyze_hlo(text), jhlo.analyze_hlo(text)
    assert got == want
    assert thlo.HloModule(text).analyze() == jhlo.HloModule(text).analyze()


def test_walker_equals_reference_on_compiled_hlo():
    """HLO the reference compiles here (a scan of dots, a convolution):
    the two walkers' dicts are equal and count the scan's trips."""
    w1 = jnp.ones((32, 64), jnp.float32)
    w2 = jnp.ones((64, 32), jnp.float32)

    def f(x, k):
        def body(c, _):
            return jnp.maximum(c @ w1, 0) @ w2, ()
        out, _ = jax.lax.scan(body, x, None, length=5)
        y = jax.lax.conv_general_dilated(out[None, None], k, (1, 1), "SAME")
        return out, y

    text = jax.jit(f).lower(jnp.ones((8, 32)), jnp.ones((1, 1, 3, 3))
                            ).compile().as_text()
    got, want = thlo.analyze_hlo(text), jhlo.analyze_hlo(text)
    assert got == want
    assert got["dot_flops"] == 5 * 2 * (2 * 8 * 32 * 64)
    assert got["conv_flops"] > 0


def test_walker_constants_are_the_references():
    assert thlo.COLLECTIVES == jhlo.COLLECTIVES
    assert thlo._DTYPE_BYTES == jhlo._DTYPE_BYTES


def _meta(dm, shape, placements):
    """A DTensor holding rank 0's shard of ``shape`` on the meta device."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for i, p in enumerate(placements):
        if hasattr(p, "dim"):
            local[p.dim] //= dm.size(i)
    return DTensor.from_local(torch.empty(local, dtype=torch.bfloat16,
                                          device="meta"),
                              dm, placements, run_check=False)


def test_tally_meets_the_ground_truth():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import fake_world, make_mesh

    with fake_world(16):
        dm = make_mesh((4, 4), ("data", "model")).device_mesh
        with thlo.StepTally() as tally:
            x = _meta(dm, (64, 512), [Shard(0), Replicate()])
            w1 = _meta(dm, (512, 1024), [Replicate(), Shard(1)])
            w2 = _meta(dm, (1024, 512), [Replicate(), Shard(0)])
            tally.mark_arguments((x, w1, w2))
            c = x
            for _ in range(7):
                c = torch.relu(c @ w1) @ w2
                c = c.redistribute(dm, [Shard(0), Replicate()])
            tally.mark_outputs(c)
            assert isinstance(c, DTensor)
    res = tally.walk()
    expect = 7 * 2 * (2 * 64 * 512 * 1024) / 16
    assert abs(res["dot_flops"] - expect) / expect < 0.01, res
    assert res["collective_bytes"].get("all-reduce", 0) > 0
    # each iteration all-reduces rank 0's (16, 512) bf16 partial sum over
    # 'model', counted twice as the walker counts an all-reduce
    assert res["collective_bytes"] == {"all-reduce": 7 * 2 * 16 * 512 * 2}
    # the global (DTensor-level) count is every rank's work
    assert tally.global_flops == 7 * 2 * (2 * 64 * 512 * 1024)
    mem = tally.memory()
    assert mem["argument_bytes"] == (16 * 512 + 512 * 256 + 256 * 512) * 2
    assert mem["output_bytes"] == 16 * 512 * 2
    assert mem["alias_bytes"] == 0
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"]


def test_tally_counts_live_bytes_and_frees():
    """Peak = the most bytes live at once: inputs, then two temporaries
    of which one is freed before the next is made."""
    with thlo.StepTally() as tally:
        a = torch.empty(1024, dtype=torch.float32, device="meta")
        tally.mark_arguments(a)
        b = a * 2                      # 4 KiB live beside a
        del b
        c = torch.empty(2048, dtype=torch.float32, device="meta") + 1
        out = a.add_(1)                # in place: aliases the input
        tally.mark_outputs((out, c))
        del c
    mem = tally.memory()
    assert mem["argument_bytes"] == 4096
    assert mem["alias_bytes"] == 4096
    assert mem["output_bytes"] == 4096 + 8192
    assert mem["peak_bytes"] == 4096 + 8192 + 8192
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                 + mem["temp_bytes"] - mem["alias_bytes"])


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "olmoe-1b-7b"])
def test_one_rank_dot_flops_equal_flop_counter(arch):
    """``lower_cell`` on a fake mesh of one rank against
    ``FlopCounterMode`` around the same train step with ``mesh=None`` on
    meta tensors: the same products at the same shapes."""
    import repro_torch.configs as tcfg
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.steps import lower_cell, make_train_step
    from repro_torch.models.transformer import LM
    from repro_torch.optim import adamw

    cfg = tcfg.reduced(tcfg.get_config(arch)).replace(microbatches=2)
    shape = tcfg.ShapeSpec("train", 16, 4, "train")
    with fake_world(1):
        lowered, meta = lower_cell(cfg, shape, make_mesh((1, 1), (
            "data", "model")))
        walk = lowered.compile().walk()
    assert meta == {"step": "train_step", "donated": "state"}
    lm = LM(cfg, device="meta")
    params = lm._init(torch.Generator(), torch.device("meta")).params
    state = {"params": params, "opt": adamw.init_state(params)}
    batch = {"tokens": torch.zeros((4, 17), dtype=torch.long,
                                   device="meta")}
    with FlopCounterMode(display=False) as fc:
        make_train_step(lm, None)(state, batch)
    assert walk["dot_flops"] == fc.get_total_flops() > 0
    assert walk["total_collective_bytes"] == 0.0
