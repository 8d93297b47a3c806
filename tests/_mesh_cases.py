"""The cases the mesh parity tests run on both packages, and their files.

A test module writes the inputs once (``write_inputs``: seeded NumPy, the
parameters drawn by the port's initializer), then runs two subprocesses
side by side: ``_mesh_reference.py`` (the JAX package on host devices,
``--xla_force_host_platform_device_count``) and ``_mesh_world.py`` (the
port in a gloo world of spawned ranks, one per device of the same mesh).
Each writes its results as one ``.npz``; the tests compare them.  This
module imports neither framework at import time, so both scripts share it.

Keys are ``|``-joined; a tree leaf's name joins its dict keys with ``.``.
Meshes are built the same way on both sides: ranks (devices) in row-major
order over ``(data, model)`` or ``(pod, data, model)``, so rank ``r`` of
the world sits at the mesh coordinate of device ``r`` of the reference.
"""

from __future__ import annotations

import dataclasses
import fcntl
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"

MESHES = {"22": ((2, 2), ("data", "model")),
          "222": ((2, 2, 2), ("pod", "data", "model")),
          "41": ((4, 1), ("data", "model"))}

# placements: parameters of these reduced configs on the 2x2 and 2x2x2
PLACE_ARCHS = ("olmoe-1b-7b", "mistral-nemo-12b", "xlstm-350m")
# the MoE block with a capacity that drops assignments
MOE_ARCH = "olmoe-1b-7b"
MOE_CF = 1.0
MOE_SHAPE = (4, 16)
SLSTM_ARCH = "xlstm-350m"
SLSTM_SHAPE = (4, 8)
PSUM_SHAPE = (2, 2, 5000)
# prefill (B, S) + DECODE_STEPS teacher-forced decode steps on the 2x2:
# MHA, GQA with a sequence-split cache, MoE, the recurrent blocks and MLA's
# latent cache (the other registered archs share these code paths; the
# CPU time of the two processes is what the tier-1 run pays)
SERVE_ARCHS = ("stablelm-1.6b", "mistral-nemo-12b", "olmoe-1b-7b",
               "xlstm-350m", "deepseek-v2-236b")
SERVE_SHAPE = (4, 16)
CACHE_LEN = 24
DECODE_STEPS = 4
N_PATCHES = 4
# two train steps on the 2x2: (arch, config overrides, ZeRO accumulators)
TRAIN_CASES = {"stablelm-1.6b": ({"microbatches": 1}, False),
               "xlstm-350m": ({"microbatches": 1}, False),
               "olmoe-1b-7b": ({"microbatches": 2, "expert_fsdp": False},
                               True)}
TRAIN_SHAPE = (8, 16)
# eps 1e-3 keeps each AdamW update near-linear in its gradient: at the
# default 1e-8 a first step is lr * sign(g), so a gradient within float32
# noise of 0 may move its weight by up to 2 lr in either package
STEP_CFG = dict(lr=1e-2, eps=1e-3, warmup_steps=0, total_steps=10)


def cfg_of(pkg_configs, arch: str, **over):
    """The reduced float32 config of ``arch`` from either package's
    ``configs`` module."""
    cfg = pkg_configs.reduced(pkg_configs.get_config(arch))
    kw = dict(dtype="float32")
    if over.pop("moe_cf", False):
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=MOE_CF)
    return cfg.replace(**kw, **over)


def flatten(tree, prefix="") -> dict:
    """Nested dicts -> {dotted name: leaf} (``None`` subtrees dropped)."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}."))
        return out
    out[prefix[:-1]] = tree
    return out


def unflatten(flat: dict) -> dict:
    """{dotted name: leaf} -> nested dicts."""
    out: dict = {}
    for name, leaf in flat.items():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def sub(npz, prefix: str) -> dict:
    """The entries of ``npz`` under ``prefix|`` as {rest: array}."""
    p = prefix + "|"
    return {k[len(p):]: npz[k] for k in npz.files if k.startswith(p)}


def coord_key(coord) -> str:
    return "-".join(str(int(c)) for c in coord)


def write_inputs(path: pathlib.Path, parts: tuple) -> None:
    """Every input of ``parts`` ("blocks", "serve", "train") into
    ``path`` (.npz):
    parameters drawn by the port's initializer (float32), data from
    seeded NumPy."""
    import torch

    sys.path.insert(0, str(SRC))
    import repro_torch.configs as tcfg
    from repro_torch.models import moe as tmoe
    from repro_torch.models import xlstm as txlstm
    from repro_torch.models.common import split_tree
    from repro_torch.models.transformer import LM

    def params(cfg, seed):
        lm = LM(cfg, device="cpu")
        tree = lm.init(torch.Generator().manual_seed(seed)).params
        return {k: v.numpy() for k, v in flatten(tree).items()}

    out = {}
    rng = np.random.default_rng(0)
    if "blocks" in parts:
        for arch in PLACE_ARCHS:
            for k, v in params(cfg_of(tcfg, arch), 3).items():
                out[f"place|{arch}|{k}"] = v
        cfg = cfg_of(tcfg, MOE_ARCH, moe_cf=True)
        g = torch.Generator().manual_seed(5)
        p = split_tree(tmoe.init_moe(g, cfg, device="cpu")).params
        for k, v in flatten(p).items():
            out[f"moe|p|{k}"] = v.numpy()
        b, s = MOE_SHAPE
        out["moe|x"] = rng.standard_normal((b, s, cfg.d_model),
                                           dtype=np.float32)
        out["moe|cy"] = rng.standard_normal((b, s, cfg.d_model),
                                            dtype=np.float32)
        cfg = cfg_of(tcfg, SLSTM_ARCH)
        g = torch.Generator().manual_seed(6)
        p = split_tree(txlstm.init_slstm(g, cfg, device="cpu")).params
        for k, v in flatten(p).items():
            out[f"slstm|p|{k}"] = v.numpy()
        b, s = SLSTM_SHAPE
        out["slstm|h"] = rng.standard_normal((b, s, cfg.d_model),
                                             dtype=np.float32)
        out["slstm|co"] = rng.standard_normal((b, s, cfg.d_model),
                                              dtype=np.float32)
        out["slstm|cc"] = rng.standard_normal(
            (b, cfg.n_heads, cfg.head_dim), dtype=np.float32)
        out["psum|x"] = (3 * rng.standard_normal(PSUM_SHAPE)).astype(
            np.float32)
    if "serve" in parts:
        for arch in SERVE_ARCHS:
            cfg = cfg_of(tcfg, arch)
            for k, v in params(cfg, 7).items():
                out[f"serve|{arch}|p|{k}"] = v
            b, s = SERVE_SHAPE
            out[f"serve|{arch}|tokens"] = rng.integers(
                0, cfg.vocab_size, (b, s + DECODE_STEPS)).astype(np.int32)
            if cfg.frontend == "vision":
                out[f"serve|{arch}|patches"] = rng.standard_normal(
                    (b, N_PATCHES, cfg.d_model), dtype=np.float32)
            if cfg.encoder is not None:
                out[f"serve|{arch}|frames"] = rng.standard_normal(
                    (b, cfg.encoder.seq_len, cfg.d_model), dtype=np.float32)
    if "train" in parts:
        for arch, (over, _) in TRAIN_CASES.items():
            cfg = cfg_of(tcfg, arch, **over)
            for k, v in params(cfg, 9).items():
                out[f"train|{arch}|p|{k}"] = v
            b, s = TRAIN_SHAPE
            for step in range(2):
                out[f"train|{arch}|tokens{step}"] = rng.integers(
                    0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    np.savez(path, **out)


def run_both(workdir: pathlib.Path, parts: tuple, timeout: float):
    """Write the inputs, run the reference and the port's world side by
    side, and return (inputs, reference, port) as loaded ``.npz``."""
    inputs = workdir / "inputs.npz"
    write_inputs(inputs, parts)
    n = 8 if "blocks" in parts else 4
    # one thread per process: the two run beside the suite's other workers
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n} "
               "--xla_cpu_multi_thread_eigen=false",
               OMP_NUM_THREADS="1")
    procs = {}
    for name, script in (("reference", "_mesh_reference.py"),
                         ("port", "_mesh_world.py")):
        log = open(workdir / f"{name}.log", "w")
        # at a lower priority: the suite's workers come first, these take
        # the cores they leave idle (the world's ranks inherit it)
        procs[name] = (subprocess.Popen(
            [sys.executable, str(HERE / script), str(inputs),
             str(workdir / f"{name}.npz"), ",".join(parts)],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            cwd=str(workdir), preexec_fn=lambda: os.nice(10)), log)
    deadline = time.monotonic() + timeout
    failed = []
    for name, (proc, log) in procs.items():
        try:
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append(f"{name}: {rc}\n"
                          + (workdir / f"{name}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("\n".join(failed))
    return tuple(np.load(workdir / f"{n}.npz")
                 for n in ("inputs", "reference", "port"))


def shared_run(tmp_path_factory, name: str, parts: tuple, timeout: float):
    """``run_both`` once per test run, shared by the xdist workers: the
    first worker that asks runs it under a file lock, the others wait and
    read its files."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return run_both(tmp_path_factory.mktemp(name), parts, timeout)
    root = tmp_path_factory.getbasetemp().parent / f"{name}-{uid}"
    with open(f"{root}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (root / "done").exists():
            root.mkdir(exist_ok=True)
            run_both(root, parts, timeout)
            (root / "done").touch()
    return tuple(np.load(root / f"{n}.npz")
                 for n in ("inputs", "reference", "port"))
