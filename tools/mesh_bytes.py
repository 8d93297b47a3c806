#!/usr/bin/env python3
"""Bytes the LM substrate's explicit redistributes move on the production
mesh, computed from shapes and the port's own placement rules.

    python3 tools/mesh_bytes.py [--mesh 16x16 | 2x16x16]

Each row is one point where the port redistributes explicitly instead of
leaving it to DTensor's sharding propagation (``CHANGES.md`` and
``PERF.md`` name them): the config and shape cell it is reckoned for, the
collective, and the bytes that enter it on each rank per step (the local
payload; a ring all-reduce moves about twice that per rank, an
all-gather of a payload P over n ranks receives (n - 1) P).  Nothing is
measured: no process group of 256 ranks exists here, and the rules run
on an ``AbstractMesh``.  Prints a table and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models.attention import _kv_slice  # noqa: E402
from repro_torch.models.common import tree_leaves_with_path  # noqa: E402
from repro_torch.models.transformer import (LM,  # noqa: E402
                                            lm_param_shardings)
from repro_torch.parallel.sharding import (cache_sharding,  # noqa: E402
                                           data_axis_size)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BYTES = {"bfloat16": 2, "float32": 4}


def _local_fraction(spec, mesh) -> float:
    """The share of a leaf one rank holds under ``spec``."""
    n = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            n *= mesh.shape[a]
    return 1.0 / n


def _params(cfg):
    return LM(cfg, device="meta")._init(torch.Generator(),
                                        torch.device("meta")).params


def _count(pattern, cfg, kind) -> int:
    return sum(k == kind for k in pattern) * cfg.n_groups + sum(
        k == kind for k in (cfg.tail_pattern or ()))


def rows(mesh) -> list:
    out = []
    shapes = tcfg.SHAPES
    n_data = data_axis_size(mesh)
    n_model = mesh.shape["model"]

    # the label's logit in the cross entropy: Partial over 'model' -> an
    # all-reduce of one float32 per token of the rank's batch rows
    cfg = tcfg.get_config("stablelm-1.6b")
    sh = shapes["train_4k"]
    out.append(dict(
        point="models/common._nll_on_mesh: the label's logit",
        cell=f"{cfg.name} {sh.name}", collective="all-reduce over model",
        bytes=sh.global_batch // n_data * sh.seq_len * 4))

    # sLSTM: the mixer gathered whole per block call (and its gradient
    # reduce-scattered back), per microbatch
    cfg = tcfg.get_config("xlstm-350m")
    sh = shapes["train_4k"]
    sh_tree = lm_param_shardings(cfg, mesh)
    p = _params(cfg)
    mixer = 0.0
    for i, kind in enumerate(cfg.block_pattern):
        if kind != "slstm":
            continue
        leaves = tree_leaves_with_path(p["groups"][f"b{i}"]["mixer"])
        specs = dict(tree_leaves_with_path(
            sh_tree["groups"][f"b{i}"]["mixer"]))
        for path, leaf in leaves:
            per_layer = leaf.numel() // leaf.shape[0]
            frac = _local_fraction(specs[path].spec, mesh)
            mixer += per_layer * leaf.element_size() * (1 - frac)
    calls = _count(cfg.block_pattern, cfg, "slstm") // max(
        sum(k == "slstm" for k in cfg.block_pattern), 1)
    out.append(dict(
        point="models/transformer._slstm_sharded: the mixer gathered",
        cell=f"{cfg.name} {sh.name}",
        collective="all-gather (forward), reduce-scatter (backward)",
        bytes=int(mixer * calls * max(cfg.microbatches, 1))))

    # MoE expert parallelism: the experts' d_model gathered over the data
    # axes, y summed over 'model' (per MoE layer and microbatch)
    cfg = tcfg.get_config("olmoe-1b-7b")
    sh = shapes["train_4k"]
    m = cfg.moe
    k = max(cfg.microbatches, 1)
    w = BYTES[cfg.dtype]
    n_layers = _count(cfg.block_pattern, cfg, "attn")
    expert_w = 3 * (m.n_experts // n_model) * cfg.d_model * m.d_expert * w
    gather = expert_w * (1 - 1 / n_data) if cfg.expert_fsdp else 0
    tokens = sh.global_batch * sh.seq_len // n_data // k
    out.append(dict(
        point="models/moe._ep_forward: experts gathered over the data axes",
        cell=f"{cfg.name} {sh.name}", collective="all-gather over data",
        bytes=int(gather * n_layers * k)))
    out.append(dict(
        point="models/moe._ep_forward: y summed over model",
        cell=f"{cfg.name} {sh.name}", collective="all-reduce over model",
        bytes=tokens * cfg.d_model * w * n_layers * k))

    # attention: the region keeps the projections' placements (heads over
    # 'model' where they divide; query heads alone with each rank's kv
    # slice); only query heads that divide while their groups straddle
    # ranks make it gather q over 'model'
    sh = shapes["prefill_32k"]
    moved = {}
    for arch in tcfg.list_archs():
        c = tcfg.get_config(arch)
        hq, hkv = c.n_heads, c.n_kv_heads
        if hq % n_model or not hkv or hkv % n_model == 0:
            continue
        if _kv_slice(hq, hkv, n_model, 0) is None:
            moved[arch] = (sh.global_batch // n_data * sh.seq_len * hq
                           * c.head_dim * BYTES[c.dtype] * c.n_layers)
    out.append(dict(
        point="models/attention._attention_on_mesh: q gathered over model",
        cell=f"every registered config, {sh.name}",
        collective="all-gather over model",
        bytes=max(moved.values(), default=0), configs=sorted(moved)))

    cfg = tcfg.get_config("mistral-nemo-12b")
    # decode over a cache whose sequence is split over 'model': max, sum
    # and P.V all-reduced over 'model' per layer and step
    sh = shapes["decode_32k"]
    spec = cache_sharding(mesh, (sh.global_batch, sh.seq_len,
                                 cfg.n_kv_heads, cfg.head_dim),
                          n_kv=cfg.n_kv_heads, kv_dim=2, seq_dim=1).spec
    b = sh.global_batch // (n_data if spec[0] else 1)
    split = spec[1] == "model"
    per_layer = b * cfg.n_heads * (2 + cfg.head_dim) * 4
    out.append(dict(
        point="models/attention._decode_attention_local: split sequence",
        cell=f"{cfg.name} {sh.name}", collective="all-reduce over model",
        bytes=per_layer * cfg.n_layers if split else 0))

    # the checkpoint: every leaf gathered whole (rank 0 writes)
    cfg = tcfg.get_config("stablelm-1.6b")
    p = _params(cfg)
    state = sum(x.numel() * (x.element_size() + 8)
                for _, x in tree_leaves_with_path(p))
    out.append(dict(
        point="checkpoint/store.save: the state gathered whole",
        cell=f"{cfg.name} (params + float32 m, v)",
        collective="all-gather over the mesh (once per save)",
        bytes=state))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16", choices=sorted(MESHES))
    args = ap.parse_args()
    sizes, names = MESHES[args.mesh]
    mesh = AbstractMesh(sizes, names)
    table = rows(mesh)
    print(f"explicit redistributes on the {args.mesh} production mesh "
          f"({math.prod(sizes)} ranks), bytes entering the collective on "
          f"each rank per step (computed, not measured)")
    for r in table:
        print(f"  {r['point']}: {r['cell']}, {r['collective']}: "
              f"{r['bytes']:,} B")
    print(json.dumps({"mesh": args.mesh, "rows": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
