"""The JAX package's side of the dry-run parity tests (a subprocess).

    python tests/_dryrun_reference.py CASES.json OUT.json

Runs on 8 host devices (``XLA_FLAGS=--xla_force_host_platform_device_count
=8``, set by the caller) with meshes built as
``Mesh(np.array(devices).reshape(shape), names)`` (``Auto`` axes; jax
0.9's ``jax.make_mesh`` makes ``Explicit`` ones, ROADMAP C-ref-8).  For
each case it builds the record ``run_cell_inline`` builds (the reference
lowers only on its production mesh) through ``lower_cell``,
``.compile()``, ``memory_analysis()`` and the HLO walker, plus the local
bytes of the step's inputs that are not parameters or optimizer state
(batch, caches, token), from its own ``launch/specs.py``.  A case whose
shape the config does not support goes through ``run_cell_inline``
itself (it returns before making a mesh).
"""

import json
import sys

import numpy as np

import jax
from jax.sharding import Mesh

import repro.configs as jcfg
from repro.configs.base import ShapeSpec
from repro.launch import hlo_cost, specs
from repro.launch.dryrun import run_cell_inline
from repro.launch.steps import lower_cell
from repro.models import quantize
from repro.models.transformer import LM


def local_bytes(tree) -> int:
    total = 0
    for sds in jax.tree.leaves(tree):
        shape = (sds.sharding.shard_shape(sds.shape)
                 if sds.sharding is not None else sds.shape)
        total += int(np.prod(shape)) * np.dtype(sds.dtype).itemsize
    return total


def one(case) -> dict:
    if case.get("min_quant"):
        quantize.MIN_QUANT_SIZE = case["min_quant"]
    cfg = jcfg.reduced(jcfg.get_config(case["arch"]))
    if case.get("overrides"):
        cfg = cfg.replace(**case["overrides"])
    if case.get("skip"):
        rec = run_cell_inline(case["arch"], case["shape_name"], False,
                              save_hlo=False)
        return {"status": rec["status"], "reason": rec.get("reason")}
    seq, batch, kind = case["shape"]
    shape = ShapeSpec("cell", seq, batch, kind)
    sizes, names = case["mesh"]
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(sizes))]).reshape(sizes),
                tuple(names))
    lowered, meta = lower_cell(cfg, shape, mesh)
    compiled = lowered.compile()
    ma = compiled.memory_analysis()
    lm = LM(cfg)
    if kind == "decode":
        extra = (specs.cache_specs(lm, shape, mesh),
                 specs.token_spec(shape, mesh))
    else:
        extra = specs.batch_specs(cfg, shape, mesh)
    return {"status": "ok", **meta,
            "argument_bytes": int(ma.argument_size_in_bytes),
            "input_bytes": local_bytes(extra),
            "hlo_walk": hlo_cost.analyze_hlo(compiled.as_text()),
            "param_count": lm.param_count()}


def main():
    cases = json.loads(open(sys.argv[1]).read())
    out = {name: one(case) for name, case in cases.items()}
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
