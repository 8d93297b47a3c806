"""The port's side of the mesh parity tests: a gloo world of spawned ranks.

    python tests/_mesh_world.py INPUTS.npz OUT.npz PARTS

Spawns CPU ranks (one intra-op thread each) that meet through a
``FileStore`` in the working directory (no network, no fixed port): 8
where a part has a case on the 2x2x2 mesh (its first four ranks also
form the 2x2 and 4x1 meshes the other cases need, as sub-meshes), else 4
(``_mesh_cases.PART_WORLD``).
Each rank writes what it owns; rank 0 merges the files into OUT.npz.
"""

import os
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _mesh_cases as mc  # noqa: E402



def t(a, dtype=None):
    import torch
    return torch.tensor(np.asarray(a), dtype=dtype)


def tree_of(flat, dtype=None):
    return mc.unflatten({k: t(v, dtype) for k, v in flat.items()})


def full(x):
    from torch.distributed.tensor import DTensor
    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.detach().numpy()


def store(out, prefix, tree):
    for k, v in mc.flatten(tree).items():
        out[f"{prefix}|{k}"] = full(v)


def placements(ctx, inp, out):
    import repro_torch.configs as tcfg
    from repro_torch.models.transformer import lm_params_from_numpy

    for arch in mc.PLACE_ARCHS:
        cfg = mc.cfg_of(tcfg, arch)
        tree = mc.unflatten(mc.sub(inp, f"place|{arch}"))
        for key in ("22", "222"):
            mesh = ctx["meshes"].get(key)
            if mesh is None:
                continue
            params = lm_params_from_numpy(tree, cfg, device="cpu",
                                          mesh=mesh)
            c = mc.coord_key(mesh.coordinate().values())
            for name, leaf in mc.flatten(params).items():
                out[f"shard|{arch}|{key}|{name}|{c}"] = (
                    leaf.to_local().numpy())


def moe(ctx, inp, out):
    import torch
    import repro_torch.configs as tcfg
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import split_tree
    from repro_torch.parallel.act import activation_mesh
    from repro_torch.parallel.sharding import (distribute_tree,
                                               param_shardings)

    mesh = ctx["meshes"]["22"]
    cfg = mc.cfg_of(tcfg, mc.MOE_ARCH, moe_cf=True)
    axes = split_tree(tmoe.init_moe(torch.Generator(), cfg,
                                    device="meta")).axes
    p = tree_of(mc.sub(inp, "moe|p"))
    p = distribute_tree(p, param_shardings(axes, p, mesh))
    x = distribute_tensor(t(inp["moe|x"]), mesh.device_mesh,
                          (Shard(0), Replicate()), src_data_rank=None)
    x.requires_grad_()
    leaves = list(mc.flatten(p).values())
    for leaf in leaves:
        leaf.requires_grad_()
    with activation_mesh(mesh, ("data",)):
        y, aux = tmoe.moe_forward(x, p, cfg, mesh, ("data",), "model",
                                  fsdp_gather=True)
        loss = (y * t(inp["moe|cy"])).sum() + 3.0 * aux
        grads = torch.autograd.grad(loss, [x] + leaves)
    out["moe|y"], out["moe|aux"] = full(y), full(aux)
    out["moe|gx"] = full(grads[0])
    for name, g in zip(mc.flatten(p), grads[1:]):
        out[f"moe|gp|{name}"] = full(g)


def slstm(ctx, inp, out):
    import torch
    import repro_torch.configs as tcfg
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import xlstm as txlstm
    from repro_torch.models.common import split_tree
    from repro_torch.models.transformer import ParallelCtx, _slstm_sharded
    from repro_torch.parallel.act import activation_mesh
    from repro_torch.parallel.sharding import (distribute_tree,
                                               param_shardings)

    mesh = ctx["meshes"]["22"]
    cfg = mc.cfg_of(tcfg, mc.SLSTM_ARCH)
    axes = split_tree(txlstm.init_slstm(torch.Generator(), cfg,
                                        device="meta")).axes
    p = tree_of(mc.sub(inp, "slstm|p"))
    p = distribute_tree(p, param_shardings(axes, p, mesh))
    leaves = list(mc.flatten(p).values())
    for leaf in leaves:
        leaf.requires_grad_()
    h = distribute_tensor(t(inp["slstm|h"]), mesh.device_mesh,
                          (Replicate(), Replicate()), src_data_rank=None)
    h.requires_grad_()
    pctx = ParallelCtx(mesh=mesh, data_axes=("data",))
    with activation_mesh(mesh, ("data",)):
        y, cache = _slstm_sharded(h, p, cfg, pctx)
        loss = ((y * t(inp["slstm|co"])).sum()
                + (cache["c"] * t(inp["slstm|cc"])).sum())
        grads = torch.autograd.grad(loss, [h] + leaves)
    out["slstm|y"], out["slstm|gh"] = full(y), full(grads[0])
    store(out, "slstm|cache", cache)
    for name, g in zip(mc.flatten(p), grads[1:]):
        out[f"slstm|gp|{name}"] = full(g)


def embed(ctx, inp, out):
    """``embed_lookup`` on a DTensor table (the local region: each rank's
    vocab slice, rows summed over 'model') and its table gradient, on
    the 2x2 and the 2x2x2."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.common import embed_lookup
    from repro_torch.parallel.act import activation_mesh
    from repro_torch.parallel.sharding import (batch_sharding,
                                               data_axis_names, placements,
                                               resolve_axes)

    cy = t(inp["emb|cy"])
    for key in ("22", "222"):
        mesh = ctx["meshes"].get(key)
        if mesh is None:
            continue
        table = distribute_tensor(
            t(inp["emb|table"]), mesh.device_mesh,
            placements(resolve_axes(("vocab", "embed"), mc.EMB_TABLE, mesh),
                       mesh), src_data_rank=None)
        table.requires_grad_()
        toks = distribute_tensor(t(inp["emb|tokens"], torch.int64),
                                 mesh.device_mesh,
                                 batch_sharding(mesh, 2).placements,
                                 src_data_rank=None)
        with activation_mesh(mesh, data_axis_names(mesh)):
            x = embed_lookup(toks, table)
            (g,) = torch.autograd.grad((x * cy).sum(), [table])
        out[f"emb|{key}|x"], out[f"emb|{key}|g"] = full(x), full(g)


def psum(ctx, inp, out):
    from repro_torch.optim.compression import compressed_psum

    mesh = ctx["meshes"]["22"]
    d, m = mesh.device_mesh.get_coordinate()
    x = t(inp["psum|x"])[d:d + 1, m:m + 1]
    total, err = compressed_psum(x, "model", mesh=mesh)
    out[f"psum|total|{d}-{m}"] = total.numpy()
    out[f"psum|err|{d}-{m}"] = err.numpy()


def ckpt(ctx, inp, out):
    """A train state written under the 2x2, restored under the 4x1: each
    rank's shards against the stored arrays cut at its coordinate."""
    import torch.distributed as dist
    import repro_torch.configs as tcfg
    from repro_torch.checkpoint import store as tstore
    from repro_torch.models.transformer import (lm_param_shardings,
                                                lm_params_from_numpy)
    from repro_torch.optim import adamw

    arch = mc.PLACE_ARCHS[0]
    cfg = mc.cfg_of(tcfg, arch)
    tree = mc.unflatten(mc.sub(inp, f"place|{arch}"))
    m22, m41 = ctx["meshes"]["22"], ctx["meshes"]["41"]
    params = lm_params_from_numpy(tree, cfg, device="cpu", mesh=m22)
    state = {"params": params, "opt": adamw.init_state(params)}
    d = pathlib.Path("ckpt")
    tstore.save(state, d, 3)
    sh = lm_param_shardings(cfg, m41)
    like = {"params": params, "opt": state["opt"]}
    shardings = {"params": sh, "opt": {"m": sh, "v": sh, "step": None}}
    back = tstore.restore(like, d, 3, shardings=shardings)
    c = mc.coord_key(m41.device_mesh.get_coordinate())
    for name, leaf in mc.flatten(back["params"]).items():
        out[f"ckpt|{name}|{c}"] = leaf.to_local().numpy()
        out[f"ckpt|placements|{name}|{c}"] = np.array(
            str(tuple(leaf.placements)))
    dist.barrier(group=ctx["group4"])


def serve(ctx, inp, out, key="22"):
    import repro_torch.configs as tcfg
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import (LM, lm_param_shardings,
                                                lm_params_from_numpy)

    mesh = ctx["meshes"][key]
    archs = mc.SERVE_ARCHS if key == "22" else mc.SERVE_222_ARCHS
    tag = "serve" if key == "22" else f"serve{key}"
    for arch in archs:
        cfg = mc.cfg_of(tcfg, arch)
        lm = LM(cfg, device="cpu")
        params = lm_params_from_numpy(
            mc.unflatten(mc.sub(inp, f"serve|{arch}|p")), cfg,
            device="cpu", mesh=mesh,
            shardings=lm_param_shardings(
                cfg, mesh, fsdp=cfg.fsdp and cfg.serving_fsdp))
        toks = inp[f"serve|{arch}|tokens"].astype(np.int64)
        s = mc.SERVE_SHAPE[1]
        batch = {"tokens": t(toks[:, :s])}
        for extra in ("patches", "frames"):
            if f"serve|{arch}|{extra}" in inp.files:
                batch[extra] = t(inp[f"serve|{arch}|{extra}"])
        prefill = make_prefill_step(lm, mesh, mc.CACHE_LEN)
        decode = make_decode_step(lm, mesh)
        logits, caches = prefill(params, batch)
        out[f"{tag}|{arch}|prefill"] = full(logits)
        for i in range(mc.DECODE_STEPS):
            logits, caches = decode(params, caches,
                                    t(toks[:, s + i:s + i + 1]))
            out[f"{tag}|{arch}|decode{i}"] = full(logits)


def int8(ctx, inp, out):
    import repro_torch.configs as tcfg
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import quantize as tquant
    from repro_torch.models.transformer import LM, lm_param_shardings
    from repro_torch.parallel.sharding import distribute_tree

    tquant.MIN_QUANT_SIZE = mc.INT8_MIN_QUANT
    mesh = ctx["meshes"]["22"]
    for arch in mc.INT8_ARCHS:
        cfg = mc.cfg_of(tcfg, arch)
        lm = LM(cfg, device="cpu")
        q = tquant.quantize_tree(tree_of(mc.sub(inp, f"serve|{arch}|p")))
        params = distribute_tree(q, lm_param_shardings(
            cfg, mesh, fsdp=cfg.fsdp and cfg.serving_fsdp))
        toks = inp[f"serve|{arch}|tokens"].astype(np.int64)
        s = mc.SERVE_SHAPE[1]
        logits, caches = make_prefill_step(lm, mesh, mc.CACHE_LEN)(
            params, {"tokens": t(toks[:, :s])})
        out[f"int8|{arch}|prefill"] = full(logits)
        decode = make_decode_step(lm, mesh)
        for i in range(mc.DECODE_STEPS):
            logits, caches = decode(params, caches,
                                    t(toks[:, s + i:s + i + 1]))
            out[f"int8|{arch}|decode{i}"] = full(logits)


def train(ctx, inp, out, key="22"):
    import repro_torch.configs as tcfg
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import (LM, lm_param_shardings,
                                                train_state_from_numpy)
    from repro_torch.optim import adamw

    mesh = ctx["meshes"][key]
    tag = "train" if key == "22" else f"train{key}"
    for arch, (over, zero) in mc.TRAIN_CASES.items():
        if key != "22" and arch not in mc.TRAIN_222_ARCHS:
            continue
        cfg = mc.cfg_of(tcfg, arch, **over)
        lm = LM(cfg, device="cpu")
        params = mc.unflatten(mc.sub(inp, f"train|{arch}|p"))
        zeros = mc.unflatten({k: np.zeros_like(v) for k, v in
                              mc.flatten(params).items()})
        state = train_state_from_numpy(
            {"params": params, "opt": {"m": zeros, "v": zeros, "step": 0}},
            cfg, device="cpu", mesh=mesh)
        grad_sh = (lm_param_shardings(cfg, mesh, fsdp=True,
                                      expert_fsdp=True) if zero else None)
        step = make_train_step(lm, mesh, adamw.AdamWConfig(**mc.STEP_CFG),
                               grad_shardings=grad_sh)
        for i in range(2):
            batch = {"tokens": t(inp[f"train|{arch}|tokens{i}"]
                                 .astype(np.int64))}
            state, metrics = step(state, batch)
            out[f"{tag}|{arch}|loss{i}"] = full(metrics["loss"])
            out[f"{tag}|{arch}|grad_norm{i}"] = full(metrics["grad_norm"])
        store(out, f"{tag}|{arch}|params", state["params"])


def on_222(fn):
    def run(ctx, inp, out):
        return fn(ctx, inp, out, key="222")
    return run


# (part, case, the world it runs in: 8 ranks or the first 4)
PARTS = {"blocks": ((placements, 8), (moe, 4), (slstm, 4), (embed, 8),
                    (psum, 4), (ckpt, 4)),
         "serve": ((serve, 4), (on_222(serve), 8)), "int8": ((int8, 4),),
         "train": ((train, 4), (on_222(train), 8))}


def rank_main(rank, world, inputs, parts, workdir):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import _lm_mesh

    torch.set_num_threads(1)
    store = dist.FileStore(str(workdir / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    inp = np.load(inputs)
    group4 = dist.new_group(list(range(4)))
    meshes = {}
    if world == 8:
        meshes["222"] = _lm_mesh("cpu", (2, 2, 2),
                                 ("pod", "data", "model"),
                                 np.arange(8).reshape(2, 2, 2))
    for key in ("22", "41"):
        shape, names = mc.MESHES[key]
        mesh = _lm_mesh("cpu", shape, names,
                        np.arange(4).reshape(shape))
        if rank < 4:
            meshes[key] = mesh
    ctx = {"meshes": meshes, "group4": group4}
    out = {}
    for part in parts:
        for fn, n in PARTS[part]:
            if rank < n:
                os.chdir(workdir)
                fn(ctx, inp, out)
    np.savez(workdir / f"rank{rank}.npz", **out)
    dist.barrier()
    if rank == 0:
        merged = {}
        for r in range(world):
            with np.load(workdir / f"rank{r}.npz") as f:
                merged.update({k: f[k] for k in f.files})
        np.savez(workdir / "merged.npz", **merged)
    dist.destroy_process_group()


def main():
    import torch.multiprocessing as mp

    inputs, out = pathlib.Path(sys.argv[1]).resolve(), pathlib.Path(
        sys.argv[2]).resolve()
    workdir = out.parent / "world"
    workdir.mkdir(exist_ok=True)
    (workdir / "store").unlink(missing_ok=True)    # a fresh rendezvous
    parts = sys.argv[3].split(",")
    world = max(mc.PART_WORLD[p] for p in parts)
    mp.spawn(rank_main, args=(world, inputs, parts, workdir), nprocs=world)
    (workdir / "merged.npz").rename(out)


if __name__ == "__main__":
    main()
