"""The JAX package's side of the mesh parity tests (a subprocess).

    python tests/_mesh_reference.py INPUTS.npz OUT.npz PARTS

Runs on host devices (``XLA_FLAGS=--xla_force_host_platform_device_count
=N``, set by the caller: 8 where a part has a 2x2x2 case, else 4)
with meshes built as
``Mesh(np.array(devices).reshape(shape), names)``: jax 0.9's
``jax.make_mesh`` makes ``Explicit`` axes, on which the reference's train
step fails (ROADMAP C-ref-8, recorded here under ``cref8``).
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _mesh_cases as mc  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa

import repro.configs as jcfg  # noqa: E402
from repro.launch.steps import (make_decode_step, make_prefill_step,  # noqa
                                make_train_step)
from repro.models import moe as jmoe  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.common import split_tree  # noqa: E402
from repro.models.transformer import LM, ParallelCtx, _slstm_sharded  # noqa
from repro.optim import adamw  # noqa: E402
from repro.optim.compression import compressed_psum  # noqa: E402
from repro.parallel.sharding import param_shardings  # noqa: E402

DEVS = np.array(jax.devices())


def mesh_of(key):
    shape, names = mc.MESHES[key]
    n = int(np.prod(shape))
    return Mesh(DEVS[:n].reshape(shape), names)


def coords(mesh) -> dict:
    return {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}


def np_tree(flat: dict):
    return jax.tree.map(jnp.asarray, mc.unflatten(flat))


def axes_of(cfg):
    return jax.eval_shape(LM(cfg).init, jax.random.PRNGKey(0))


def shardings(cfg, mesh, **kw):
    pa = axes_of(cfg)
    kw = {"fsdp": cfg.fsdp, "expert_fsdp": cfg.expert_fsdp, **kw}
    return param_shardings(pa.axes, pa.params, mesh, use_tp=cfg.use_tp,
                           **kw)


def store(out, prefix, tree):
    for k, v in mc.flatten(tree).items():
        out[f"{prefix}|{k}"] = np.asarray(v)


def placements(inp, out):
    for arch in mc.PLACE_ARCHS:
        cfg = mc.cfg_of(jcfg, arch)
        params = np_tree(mc.sub(inp, f"place|{arch}"))
        for key in ("22", "222"):
            mesh = mesh_of(key)
            placed = jax.device_put(params, shardings(cfg, mesh))
            where = coords(mesh)
            for name, leaf in mc.flatten(placed).items():
                for shard in leaf.addressable_shards:
                    c = mc.coord_key(where[shard.device.id])
                    out[f"shard|{arch}|{key}|{name}|{c}"] = np.asarray(
                        shard.data)


def moe(inp, out):
    cfg = mc.cfg_of(jcfg, mc.MOE_ARCH, moe_cf=True)
    mesh = mesh_of("22")
    p = np_tree(mc.sub(inp, "moe|p"))
    axes = split_tree(jmoe.init_moe(jax.random.PRNGKey(0), cfg)).axes
    p = jax.device_put(p, param_shardings(axes, p, mesh))
    x = jax.device_put(jnp.asarray(inp["moe|x"]),
                       NamedSharding(mesh, P("data")))
    cy = jnp.asarray(inp["moe|cy"])

    def f(x, p):
        y, aux = jmoe.moe_forward(x, p, cfg, mesh, ("data",), "model",
                                  fsdp_gather=True)
        return jnp.sum(y * cy) + 3.0 * aux, (y, aux)

    (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(x, p)
    out["moe|y"], out["moe|aux"] = np.asarray(y), np.asarray(aux)
    out["moe|gx"] = np.asarray(gx)
    store(out, "moe|gp", gp)
    y0, _ = jax.jit(lambda x, p: jmoe.moe_forward(x, p, cfg))(x, p)
    out["moe|y_nomesh"] = np.asarray(y0)


def slstm(inp, out):
    cfg = mc.cfg_of(jcfg, mc.SLSTM_ARCH)
    mesh = mesh_of("22")
    p = np_tree(mc.sub(inp, "slstm|p"))
    axes = split_tree(jxlstm.init_slstm(jax.random.PRNGKey(0), cfg)).axes
    p = jax.device_put(p, param_shardings(axes, p, mesh))
    h = jnp.asarray(inp["slstm|h"])
    co, cc = jnp.asarray(inp["slstm|co"]), jnp.asarray(inp["slstm|cc"])
    ctx = ParallelCtx(mesh=mesh, data_axes=("data",))

    def f(h, p):
        y, cache = _slstm_sharded(h, p, cfg, ctx)
        return jnp.sum(y * co) + jnp.sum(cache["c"] * cc), (y, cache)

    (_, (y, cache)), (gh, gp) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(h, p)
    out["slstm|y"], out["slstm|gh"] = np.asarray(y), np.asarray(gh)
    store(out, "slstm|cache", cache)
    store(out, "slstm|gp", gp)


def embed(inp, out):
    """``embed_lookup`` (``jnp.take``) and its table gradient under
    ``jax.jit`` on the 2x2 and the 2x2x2, the table placed by the rules
    (vocab over 'model', d_model over the data axes), the tokens' batch
    over the data axes."""
    from repro.models.common import embed_lookup
    from repro.parallel.sharding import batch_sharding, resolve_axes

    cy = jnp.asarray(inp["emb|cy"])
    for key in ("22", "222"):
        mesh = mesh_of(key)
        table = jax.device_put(jnp.asarray(inp["emb|table"]), NamedSharding(
            mesh, resolve_axes(("vocab", "embed"), mc.EMB_TABLE, mesh)))
        toks = jax.device_put(jnp.asarray(inp["emb|tokens"]),
                              batch_sharding(mesh, 2))

        def f(table):
            x = embed_lookup(toks, table)
            return jnp.sum(x * cy), x

        (_, x), g = jax.jit(jax.value_and_grad(f, has_aux=True))(table)
        out[f"emb|{key}|x"], out[f"emb|{key}|g"] = np.asarray(x), \
            np.asarray(g)


def psum(inp, out):
    mesh = mesh_of("22")
    f = jax.shard_map(lambda x: compressed_psum(x, "model"), mesh=mesh,
                      in_specs=P("data", "model", None),
                      out_specs=(P("data", None, None),
                                 P("data", "model", None)),
                      check_vma=False)
    x = jnp.asarray(inp["psum|x"])
    # op by op (shard_map's own execution) and jitted: XLA's fusion of the
    # jitted quantization rounds the error differently
    total, err = f(x)
    out["psum|total"], out["psum|err"] = np.asarray(total), np.asarray(err)
    total, err = jax.jit(f)(x)
    out["psum|total_jit"] = np.asarray(total)
    out["psum|err_jit"] = np.asarray(err)


def serve(inp, out, key="22"):
    mesh = mesh_of(key)
    archs = mc.SERVE_ARCHS if key == "22" else mc.SERVE_222_ARCHS
    tag = "serve" if key == "22" else f"serve{key}"
    for arch in archs:
        cfg = mc.cfg_of(jcfg, arch)
        lm = LM(cfg)
        params = jax.device_put(
            np_tree(mc.sub(inp, f"serve|{arch}|p")),
            shardings(cfg, mesh, fsdp=cfg.fsdp and cfg.serving_fsdp))
        toks = inp[f"serve|{arch}|tokens"]
        s = mc.SERVE_SHAPE[1]
        batch = {"tokens": jnp.asarray(toks[:, :s])}
        for extra in ("patches", "frames"):
            if f"serve|{arch}|{extra}" in inp.files:
                batch[extra] = jnp.asarray(inp[f"serve|{arch}|{extra}"])
        prefill = jax.jit(make_prefill_step(lm, mesh, mc.CACHE_LEN))
        decode = jax.jit(make_decode_step(lm, mesh))
        logits, caches = prefill(params, batch)
        out[f"{tag}|{arch}|prefill"] = np.asarray(logits)
        for i in range(mc.DECODE_STEPS):
            tok = jnp.asarray(toks[:, s + i:s + i + 1])
            logits, caches = decode(params, caches, tok)
            out[f"{tag}|{arch}|decode{i}"] = np.asarray(logits)


def int8(inp, out):
    """int8 frozen-weight serving on the 2x2, the leaves placed as
    ``lower_cell`` places them (``quant_struct_like`` of the parameter
    specs)."""
    from repro.launch import specs
    from repro.models import quantize as jquant

    jquant.MIN_QUANT_SIZE = mc.INT8_MIN_QUANT
    mesh = mesh_of("22")
    for arch in mc.INT8_ARCHS:
        cfg = mc.cfg_of(jcfg, arch)
        lm = LM(cfg)
        q = jquant.quantize_tree(np_tree(mc.sub(inp, f"serve|{arch}|p")))
        structs, _ = specs.params_specs(lm, mesh,
                                        fsdp=cfg.fsdp and cfg.serving_fsdp)
        sh = jax.tree.map(lambda sds: sds.sharding,
                          jquant.quant_struct_like(structs))
        params = jax.device_put(q, sh)
        toks = inp[f"serve|{arch}|tokens"]
        s = mc.SERVE_SHAPE[1]
        prefill = jax.jit(make_prefill_step(lm, mesh, mc.CACHE_LEN))
        decode = jax.jit(make_decode_step(lm, mesh))
        logits, caches = prefill(params, {"tokens": jnp.asarray(
            toks[:, :s])})
        out[f"int8|{arch}|prefill"] = np.asarray(logits)
        for i in range(mc.DECODE_STEPS):
            tok = jnp.asarray(toks[:, s + i:s + i + 1])
            logits, caches = decode(params, caches, tok)
            out[f"int8|{arch}|decode{i}"] = np.asarray(logits)


def train(inp, out, key="22"):
    mesh = mesh_of(key)
    tag = "train" if key == "22" else f"train{key}"
    for arch, (over, zero) in mc.TRAIN_CASES.items():
        if key != "22" and arch not in mc.TRAIN_222_ARCHS:
            continue
        cfg = mc.cfg_of(jcfg, arch, **over)
        lm = LM(cfg)
        params = jax.device_put(np_tree(mc.sub(inp, f"train|{arch}|p")),
                                shardings(cfg, mesh))
        grad_sh = (shardings(cfg, mesh, fsdp=True, expert_fsdp=True)
                   if zero else None)
        state = {"params": params, "opt": adamw.init_state(params)}
        step = jax.jit(make_train_step(
            lm, mesh, adamw.AdamWConfig(**mc.STEP_CFG),
            grad_shardings=grad_sh))
        for i in range(2):
            batch = {"tokens": jnp.asarray(inp[f"train|{arch}|tokens{i}"])}
            state, metrics = step(state, batch)
            out[f"{tag}|{arch}|loss{i}"] = np.asarray(metrics["loss"])
            out[f"{tag}|{arch}|grad_norm{i}"] = np.asarray(
                metrics["grad_norm"])
        store(out, f"{tag}|{arch}|params", state["params"])


def on_222(fn):
    def run(inp, out):
        return fn(inp, out, key="222")
    return run


def cref8(inp, out):
    """C-ref-8: the reference's train step on ``make_host_mesh()`` (jax
    0.9's ``jax.make_mesh``, Explicit axes) fails; recorded, not raised."""
    from repro.launch.mesh import make_host_mesh

    arch = "stablelm-1.6b"
    cfg = mc.cfg_of(jcfg, arch)
    lm = LM(cfg)
    params = lm.init(jax.random.PRNGKey(0)).params
    state = {"params": params, "opt": adamw.init_state(params)}
    mesh = make_host_mesh()
    batch = {"tokens": jax.device_put(
        jnp.zeros((8, mc.TRAIN_SHAPE[1] + 1), jnp.int32),
        NamedSharding(mesh, P("data")))}
    try:
        jax.jit(make_train_step(lm, mesh))(state, batch)
        msg = "ran"
    except Exception as e:  # noqa: BLE001 - the failure is the record
        msg = f"{type(e).__name__}: {e}"
    out["cref8|error"] = np.array(msg[:400])


PARTS = {"blocks": (placements, moe, slstm, embed, psum),
         "serve": (serve, on_222(serve), cref8), "int8": (int8,),
         "train": (train, on_222(train))}


def main():
    inp = np.load(sys.argv[1])
    out = {}
    for part in sys.argv[3].split(","):
        for fn in PARTS[part]:
            fn(inp, out)
    np.savez(sys.argv[2], **out)


if __name__ == "__main__":
    main()
