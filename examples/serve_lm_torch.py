"""Batched LM serving demo on the PyTorch/CUDA port's serve layer.

The twin of ``examples/serve_lm.py`` on ``repro_torch``.  Loads a small LM
(random weights — the point is the serving machinery), takes a set of
*variable-length* prompts, groups them through the serve layer's
:class:`PaddingBucketer` (one prefill/decode pair per bucket shape
instead of one per request shape), decodes tokens, and reports
throughput + padding efficiency via :class:`ServeStats`.

With ``--frozen-sparse`` the final-projection matrix additionally goes
through the paper's FixedMatrix pipeline (int8 + CSD digit planes) and
reports the cost-model numbers — the LM-serving face of the paper's
fixed-matrix specialization.

Departures from the reference script: ``--device`` (default ``cuda``;
``--device cpu`` runs on the CPU); weights from a seeded
``torch.Generator`` where the reference takes ``PRNGKey(0)``; the mesh of
``make_host_mesh()`` (``(1, 1)`` with one visible card) runs over a
process group, so the script opens one of one rank (NCCL on the card,
gloo on the CPU, over a file store in a temporary directory) when none
is open, and closes it before it returns; the parameters are placed on
that mesh; the step functions are called directly (there is no ``jit``),
and timed calls end in a device synchronisation where the reference
blocks on its result.

Run:  python examples/serve_lm_torch.py --tokens 16
      python examples/serve_lm_torch.py --tokens 16 --frozen-sparse
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent
                       / "src"))

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, one_rank_group
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import LM, lm_param_shardings
from repro_torch.parallel.sharding import distribute_tree
from repro_torch.serve import PaddingBucketer, RolloutRequest, ServeStats

CFG = ModelConfig(
    name="serve-demo", family="dense", n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=2048,
    tie_embeddings=True, remat="none")


def _local(x):
    """A step's output as a plain tensor (on a mesh of one rank a DTensor's
    shard is the whole tensor)."""
    return x.to_local() if hasattr(x, "to_local") else x


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(lm, mesh, params, reqs, tokens, stats):
    """The bucketed prefill + greedy decode loop: {uid: (tokens,) int}, and
    the number of bucket shapes."""
    dev = lm.device
    bucketer = PaddingBucketer(len_buckets=(32, 64, 128, 256),
                               batch_buckets=(1, 2, 4, 8, 16))
    decoded = {}
    step_cache = {}  # bucket_len -> prefill/decode pair

    for mb in bucketer.group(reqs):
        bpad, tpad, _ = mb.inputs.shape
        cache_len = tpad + tokens
        if tpad not in step_cache:
            step_cache[tpad] = (make_prefill_step(lm, mesh, cache_len),
                                make_decode_step(lm, mesh))
        prefill, decode = step_cache[tpad]
        prompts = torch.as_tensor(mb.inputs[:, :, 0], dtype=torch.long,
                                  device=dev)      # (bpad, tpad) tokens

        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompts})
        logits = _local(logits)
        _sync(dev)
        stats.record_call(batch=bpad, steps=tpad,
                          seconds=time.perf_counter() - t0,
                          real_steps=mb.real_steps)

        # The reference seeds decode from row j's logits at lens[j] - 1,
        # but its prefill returns the last position's logits only
        # (B, 1, V), and JAX clamps the out-of-range index to that one
        # position: every row seeds from the last (padded) position, as
        # here.  (Right-padding leaves pad tokens in the KV cache —
        # acceptable for this random-weights demo; production serving
        # would mask them in attention.)
        lens = np.asarray(mb.lengths + [tpad] * (bpad - len(mb.requests)))
        pos = torch.as_tensor(np.minimum(lens - 1, logits.shape[1] - 1),
                              device=dev)
        tok = logits[torch.arange(bpad, device=dev), pos].argmax(
            -1)[:, None]
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(tokens - 1):
            logits, caches = decode(params, caches, tok)
            tok = _local(logits).argmax(-1)
            out.append(tok)
        _sync(dev)
        stats.record_call(batch=bpad, steps=tokens - 1,
                          seconds=time.perf_counter() - t0,
                          real_steps=(tokens - 1) * len(mb.requests))
        seq = torch.cat(out, dim=1).cpu().numpy()
        for j, req in enumerate(mb.requests):
            decoded[req.uid] = seq[j]
    return decoded, len(step_cache)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--min-prompt", type=int, default=24)
    ap.add_argument("--max-prompt", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--frozen-sparse", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    with one_rank_group(dev):
        lm = LM(CFG, device=dev)
        mesh = make_host_mesh(dev)
        params = lm.init(torch.Generator(device=dev).manual_seed(0)).params
        params = distribute_tree(params, lm_param_shardings(CFG, mesh))
        rng = np.random.default_rng(0)

        # Ragged prompts -> padded microbatches via the serve layer's
        # bucketer.
        reqs = [RolloutRequest(
                    uid=i,
                    inputs=rng.integers(
                        0, CFG.vocab_size,
                        (int(rng.integers(args.min_prompt,
                                          args.max_prompt + 1)),
                         1)).astype(np.int32))
                for i in range(args.requests)]
        stats = ServeStats()
        decoded, n_shapes = serve(lm, mesh, params, reqs, args.tokens, stats)
        table = _local(params["embed"]).float().cpu().numpy()  # (V, d) tied

    assert len(decoded) == args.requests
    for uid, seq in decoded.items():
        assert seq.shape == (args.tokens,)
        assert (seq >= 0).all() and (seq < CFG.vocab_size).all()
    print(f"served {args.requests} ragged prompts "
          f"({args.min_prompt}-{args.max_prompt} tokens) through "
          f"{n_shapes} bucket shapes")
    print("serve stats:", stats.render())

    if args.frozen_sparse:
        from repro_torch.core.sparse import FixedMatrix
        t0 = time.perf_counter()
        fm = FixedMatrix.compile(table.T, weight_bits=8, mode="csd")
        t_compile = time.perf_counter() - t0
        cost = fm.fpga_cost()
        dense_bytes = table.size * 2
        plane_bytes = fm.ones / 8 + fm.plan().stats.blocks_nnz * 16
        print(f"\nfrozen-sparse head: compiled in {t_compile:.1f}s — "
              f"{fm.ones} ones, element sparsity {fm.element_sparsity:.2f}")
        print(f"  spatial-model latency {cost.latency_ns:.0f} ns/token; "
              f"bf16 stream {dense_bytes / 1e6:.1f} MB vs digit-plane "
              f"{plane_bytes / 1e6:.1f} MB per read")
    print("OK")
    return {"decoded": decoded, "stats": stats}


if __name__ == "__main__":
    main()
