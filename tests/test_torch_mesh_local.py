"""The LM on a mesh of one rank, in process (gloo, a file store).

A ``(1, 1)`` mesh places everything ``Replicate``, so DTensor runs the
same local kernels as ``mesh=None``: losses and gradients must be equal
bit for bit (what ``chip_smoke.py``'s ``mesh`` phase holds on the card).
The cases here cover what a spawned world does not: a checkpointed
function recomputed in the backward pass on another thread (on a card the
autograd engine runs the backward on its own thread, where the caller's
context variables are not set); ``_grad_elsewhere`` takes the gradients on
a new thread to do the same on the CPU.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as tcfg
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_ctx
from repro_torch.models import common as tcommon
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.transformer import LM, lm_param_shardings
from repro_torch.parallel.act import activation_mesh
from repro_torch.parallel.sharding import NamedSharding, distribute_tree


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _grad_elsewhere(loss, inputs):
    """``torch.autograd.grad`` on a new thread, which starts with no
    context variables set, as the autograd engine's thread on a card (the
    engine carries PyTorch's thread-local state there, DTensor's implicit
    replication included, so the new thread copies that flag)."""
    from torch.distributed.tensor import DTensor

    out = {}
    flag = DTensor._op_dispatcher._allow_implicit_replication

    def run():
        DTensor._op_dispatcher._allow_implicit_replication = flag
        try:
            out["grads"] = torch.autograd.grad(loss, inputs)
        except Exception as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["grads"]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recompute_outside_the_context_equals_no_mesh(tmp_path, remat):
    """The loss under ``activation_mesh``, its gradients taken on another
    thread: every group's recompute runs under the context it was built
    in (``keep_context``), bit for bit ``mesh=None``'s."""
    cfg = tcfg.reduced(tcfg.get_config("stablelm-1.6b")).replace(
        dtype="float32", remat=remat)
    lm = LM(cfg, device="cpu")
    params = lm.init(torch.Generator().manual_seed(0)).params
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 17)))

    def grads(p, ctx):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        it = iter(leaves)
        req = tree_map(lambda _: next(it), p)
        if ctx.mesh is None:
            loss = lm.loss(req, {"tokens": toks}, ctx)
            return loss, torch.autograd.grad(loss, leaves)
        with activation_mesh(ctx.mesh, ctx.data_axes, ctx.model_axis):
            loss = lm.loss(req, {"tokens": toks}, ctx)
            return loss, _grad_elsewhere(loss, leaves)

    want_loss, want = grads(params, make_ctx(None))
    with one_rank_mesh(tmp_path) as mesh:
        placed = distribute_tree(tree_map(torch.clone, params),
                                 lm_param_shardings(cfg, mesh))
        loss, got = grads(placed, make_ctx(mesh, cfg))
        assert torch.equal(_whole(loss), want_loss)
        for g, w in zip(got, want):
            assert torch.equal(_whole(g), w)


def test_streamed_cross_entropy_recomputes_under_the_context(tmp_path):
    """``cross_entropy_streamed``'s checkpointed chunks on DTensors, the
    backward on another thread: equal to the plain run."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((2, 12, 8), dtype=np.float32))
    table = torch.as_tensor(rng.standard_normal((16, 8), dtype=np.float32))
    labels = torch.as_tensor(rng.integers(0, 16, (2, 12)))

    def run(x, table, mesh=None):
        x, table = (t.detach().requires_grad_() for t in (x, table))
        if mesh is None:
            loss = tcommon.cross_entropy_streamed(x, table, labels, chunk=4)
            return loss, torch.autograd.grad(loss, (x, table))
        with activation_mesh(mesh, ("data",)):
            loss = tcommon.cross_entropy_streamed(x, table, labels, chunk=4)
            return loss, _grad_elsewhere(loss, (x, table))

    want_loss, want = run(x, table)
    with one_rank_mesh(tmp_path) as mesh:
        rep = distribute_tree({"x": x, "t": table}, {
            "x": NamedSharding(mesh, ("data", None, None)),
            "t": NamedSharding(mesh, (None, None))})
        loss, got = run(rep["x"], rep["t"], mesh)
        assert torch.equal(_whole(loss), want_loss)
        for g, w in zip(got, want):
            assert torch.equal(_whole(g), w)
