"""The port's example scripts (``examples/*_torch.py``) against the JAX
package's (``examples/*.py``), on the CPU.

(a) The scripts as users run them: each reservoir script and its twin in
    a subprocess of its own (the twin with ``--device cpu``, from another
    working directory, without ``PYTHONPATH``), both at the same small
    arguments.  Both exit 0 and print ``OK``; one parser reads both
    outputs, and every number that does not come from a clock must be
    equal: the ExecutionPlan report and plan table, ones, FPGA ns and W,
    request and step counts, and every line of the two virtual-clock
    scripts (``serve_sharded``, ``serve_resilient``).
(b) Arrays in process, on the same inputs: the twins' ``main`` returns
    what it computed, held against the reference's calls.
(c) The LM twins' loops with the reference's weights (``float32``, carried
    by ``lm_params_from_numpy``) on a ``(1, 1)`` gloo mesh, against the
    reference's steps on a ``(1, 1)`` mesh of ``Auto`` axes (its own
    ``make_host_mesh()`` fails under jax 0.9, ROADMAP C-ref-8).
(d) A resumed ``train_lm_torch`` run equals an uninterrupted one.

Tolerances:

- ``INT8_STATE_TOL`` = 0.05: an int8 reservoir requantizes its state every
  step, so a one-ulp difference of an input projection or ``tanh`` (XLA's
  and PyTorch's differ) moves a state across a rounding boundary of its
  int8 code and the trajectories part by a few codes' worth; the
  contracting reservoir keeps the gap bounded (quickstart: 0.030 over
  2,999 steps at batch 1; timeseries: 0.007 at batch 180).  The first step,
  before any requantization, is held to ``FP32_STATE_TOL``.
- ``FP32_STATE_TOL`` = 1e-6: float32 trajectories (1.0e-7 measured).
- Predictions served with one ``W_out``: per step within
  ``|x_port - x_ref| @ |W_out|`` (the states' gap through the readout)
  plus ``READOUT_TOL`` = 1e-4 relative for the readout's own sum order.
- ``SER_TOL`` = 0.05 and ``ACC_TOL`` = 2/60: the readouts are ridge fits
  whose float32 Gram sums run in another order in each package; at the
  scripts' ridges (1e-5, 1e-3) that order moves ``W_out`` by more than
  its largest entry (C-ref-6), so each package's SER or accuracy is its
  own (SER gap 0.025 measured, accuracy gap 1/60).
- ``LOSS_TOL`` = 1e-4: the LM losses of the first train steps.
"""

import dataclasses
import importlib.util
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.core.esn import ESNConfig as JESNConfig
from repro.core.esn import init_esn as j_init_esn
from repro.core.esn import run_readout as j_run_readout
from repro.core.esn import run_reservoir as j_run_reservoir
from repro.core.ridge import ridge_fit as j_ridge_fit
from repro.data import pipeline as jpipe
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models.transformer import LM as JLM
from repro.optim import adamw as jadamw
from repro.serve import RolloutRequest as JRolloutRequest

from repro_torch.core.ridge import ridge_fit
from repro_torch.launch.mesh import make_host_mesh, one_rank_group
from repro_torch.models.transformer import LM, lm_params_from_numpy
from repro_torch.serve import RolloutRequest, ServeStats

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CPU = torch.device("cpu")

INT8_STATE_TOL = 0.05
FP32_STATE_TOL = 1e-6
READOUT_TOL = 1e-4
SER_TOL = 0.05
ACC_TOL = 2 / 60
LOSS_TOL = 1e-4
SCRIPT_TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def _release_xla_executables():
    """Free this module's XLA executables once its tests in this worker
    are done (ROADMAP C-port-5)."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(stem: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"_example_{stem}", EXAMPLES / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin(name: str) -> types.ModuleType:
    """``examples/<name>_torch.py`` as a module (its ``main(argv)`` returns
    what it computed)."""
    return _load(f"{name}_torch")


# ---------------------------------------------------------------------------
# (d) resume: first, the file's longest test
# ---------------------------------------------------------------------------
def test_train_lm_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """30 steps with a checkpoint every 10, then a run to 40 resumes from
    step 20: its losses equal steps 21-39 of one 40-step run bit for bit,
    and the 40-step run passes the script's own loss check (8 x 16 tokens
    a step: the loss falls ~0.39 against the check's 0.3)."""
    mod = twin("train_lm")
    small = ["--batch", "8", "--seq", "16", "--ckpt-every", "10",
             "--device", "cpu"]
    torch.set_num_threads(2)
    first = mod.main(["--steps", "30", "--ckpt-dir", str(tmp_path / "a")]
                     + small)
    resumed = mod.main(["--steps", "40", "--ckpt-dir", str(tmp_path / "a")]
                       + small)
    whole = mod.main(["--steps", "40", "--ckpt-dir", str(tmp_path / "b")]
                     + small)
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 20" in out
    assert out.count("OK: loss decreased") == 1     # the 40-step run
    assert first["start"] == 0 and whole["start"] == 0
    assert resumed["start"] == 21
    assert first["losses"] == whole["losses"][:30]
    assert resumed["losses"] == whole["losses"][21:]
    assert np.isfinite(whole["losses"]).all()
    assert len(whole["step_s"]) == 40 and len(resumed["step_s"]) == 19


# ---------------------------------------------------------------------------
# (a) the scripts as users run them
# ---------------------------------------------------------------------------
# the small arguments both packages take (none for the three paper tasks)
ARGS = {
    "quickstart": [],
    "channel_equalization": [],
    "timeseries_classification": [],
    "serve_reservoir": ["--dim", "128", "--requests", "8"],
    "serve_async": ["--dim", "128", "--requests", "12"],
    "serve_observed": ["--dim", "128", "--requests", "12"],
    "serve_sharded": ["--dim", "128", "--requests", "24"],
    "serve_resilient": ["--dim", "128", "--requests", "24"],
}

# per script, the patterns whose matches must be equal in both outputs
# (the reference's backend names read as the port's: xla -> torch)
_PLAN = [r"(?ms)^ExecutionPlan .*?^  Eq\.5 latency: .*?$"]
FACTS = {
    "quickstart": _PLAN + [r"vs modeled V100 cuSPARSE gemv: .*"],
    "channel_equalization": [
        r"(\S+)\s+SER=[\d.]+\s+\| deployed matrix: (\d+) ones, (\d+) "
        r"ns/symbol, ([\d.]+) W"],
    "timeseries_classification": [r"reservoir: .* ns/step on XCVU13P"],
    "serve_reservoir": _PLAN + [
        r"(?m)^\|.*\|$",
        r"served \d+ rollout requests -> predictions \(.*\)",
        r"serve stats: (\d+) calls, (\d+) seqs, (\d+) steps \((\d+)%"],
    "serve_async": [
        r"(\d+) requests, (\d+) steps total",
        r"both paths served (\d+) requests with matching predictions "
        r"\(backend=(\w+)\)",
        r"queue: (\d+)/(\d+) done",
        r"(\d+) timed out, (\d+) rejected, (\d+) shed, (\d+) quota held"],
    "serve_observed": [
        r"warmup done: (\d+) rollout variants \w+",
        r"\(backend=(\w+)\)",
        r"served (\d+) requests, (\d+) steps",
        r"(?m)^  (queue_wait_seconds|request_latency_seconds|ttfp_seconds)"
        r"\s+n=(\d+)",
        r"(?m)^  (requests_\w+_total)\s+(\S+)$",
        r"events: (\d+) [\w -]+ at warmup, (\d+) [\w -]+ under traffic"],
    # every number of these two runs is on the virtual clock
    "serve_sharded": [r"(?m)^.*$"],
    "serve_resilient": [r"(?m)^.*$"],
}


def facts(name: str, text: str) -> list:
    text = text.replace("backend=xla", "backend=torch")
    return [re.findall(p, text) for p in FACTS[name]]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    return {**env, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", **extra}


@pytest.mark.parametrize("name", sorted(ARGS))
def test_script_prints_what_the_reference_prints(name, tmp_path):
    args = list(ARGS[name])
    outs = {side: [] for side in ("ref", "port")}
    if name == "serve_observed":
        outs = {side: ["--trace-out", str(tmp_path / f"{side}.jsonl"),
                       "--metrics-out", str(tmp_path / f"{side}.prom")]
                for side in outs}
    ref = subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}.py")] + args + outs["ref"],
        cwd=ROOT, env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # the twin finds its own package, whatever the working directory
    port = subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}_torch.py")] + args
        + outs["port"] + ["--device", "cpu"],
        cwd=tmp_path, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    (r_out, r_err), (p_out, p_err) = (
        ref.communicate(timeout=SCRIPT_TIMEOUT),
        port.communicate(timeout=SCRIPT_TIMEOUT))
    assert ref.returncode == 0, r_err[-3000:]
    assert port.returncode == 0, p_err[-3000:]
    assert p_out.rstrip().splitlines()[-1] == "OK", p_out[-2000:]
    if name not in ("quickstart", "channel_equalization"):
        assert r_out.rstrip().splitlines()[-1] == "OK"   # the others don't
    want, got = facts(name, r_out), facts(name, p_out)
    assert all(want), f"the parser read nothing of {name}: {want}"
    assert got == want
    if name == "serve_observed":
        assert (tmp_path / "port.jsonl").stat().st_size > 0
        assert "repro_requests_completed_total" in (
            tmp_path / "port.prom").read_text()


# ---------------------------------------------------------------------------
# (b) arrays in process, on the same inputs
# ---------------------------------------------------------------------------
def _close_through_readout(got, want, gap, w_out):
    """Predictions of one readout from two trajectories: per step within
    the states' gap through ``|W_out|`` plus the readout's own rounding."""
    bound = np.abs(gap) @ np.abs(w_out) + READOUT_TOL * (1 + np.abs(want))
    assert (np.abs(got - want) <= bound).all()


def test_quickstart_states_and_served_predictions():
    """Batch 1, int8-CSD at dim 800 over 2,999 steps: the states within
    INT8_STATE_TOL (the first step within FP32_STATE_TOL), and the fused
    readout's predictions beside the reference's ``run_readout`` with the
    same ``W_out``.  The NRMSE is left out: at ridge 1e-6 rounding decides
    it (C-ref-6)."""
    out = twin("quickstart").main(["--device", "cpu"])
    jp = j_init_esn(JESNConfig(reservoir_dim=800, element_sparsity=0.75,
                               mode="int8-csd", seed=0))
    sig = jpipe.mackey_glass(3000, seed=0)
    u = jnp.asarray(sig[:-1, None])
    want = np.asarray(j_run_reservoir(jp, u))
    got = out["states"].numpy()
    assert got.shape == want.shape == (2999, 800)
    assert np.abs(got[0] - want[0]).max() <= FP32_STATE_TOL
    assert np.abs(got - want).max() <= INT8_STATE_TOL
    w_out = out["params"].w_out.numpy()
    jp = dataclasses.replace(jp, w_out=jnp.asarray(w_out))
    _close_through_readout(out["preds"].numpy(),
                           np.asarray(j_run_readout(jp, u)), got - want,
                           w_out)


def test_channel_equalization_states_and_ser():
    """Per mode: the states (fp32 within FP32_STATE_TOL, int8 within
    INT8_STATE_TOL) and the SER within SER_TOL of the reference's; in
    fp32, where the states agree, the port's readout scores the same SER
    on the reference's states as on its own (the gap is the fit's)."""
    out = twin("channel_equalization").main(["--device", "cpu"])
    u, d = jpipe.channel_equalization(6000, seed=0, snr_db=28.0)
    u = (u / np.abs(u).max()).astype(np.float32)
    hp = {"fp32": dict(input_scale=0.3, leak=0.3, spectral_radius=0.8),
          "int8-csd": dict(input_scale=1.0, leak=0.6, spectral_radius=0.85)}
    ser = twin("channel_equalization").ser
    for mode, tol in (("fp32", FP32_STATE_TOL), ("int8-csd", INT8_STATE_TOL)):
        jp = j_init_esn(JESNConfig(reservoir_dim=600, element_sparsity=0.85,
                                   mode=mode, seed=3, **hp[mode]))
        want = np.asarray(j_run_reservoir(jp, jnp.asarray(u[:, None])))
        got = out[mode]["states"].numpy()
        assert np.abs(got - want).max() <= tol, mode
        w = j_ridge_fit(jnp.asarray(want[200:4000]),
                        jnp.asarray(d[200:4000, None]), lam=1e-5)
        want_ser = ser(want[4000:] @ np.asarray(w), d[4000:])
        assert abs(out[mode]["ser"] - want_ser) <= SER_TOL, mode
        assert out[mode]["ser"] < 0.2 and want_ser < 0.2
        if mode == "fp32":
            w_port = out[mode]["params"].w_out.numpy()
            assert ser(want[4000:] @ w_port, d[4000:]) == out[mode]["ser"]


def test_timeseries_features_and_accuracy():
    """Batch 180 (int8-CSD, dim 400): states within INT8_STATE_TOL and the
    mean/std features within it; the port's ``ridge_fit`` on the
    reference's features labels all but ACC_TOL of the test samples as the
    reference's does (120 rows of 800 features: the Gram has rank <= 120,
    so the float32 sum order moves near-tied samples); the twin's
    accuracy within ACC_TOL of the reference's."""
    mod = twin("timeseries_classification")
    out = mod.main(["--device", "cpu"])
    x, y = mod.make_dataset()
    jp = j_init_esn(JESNConfig(reservoir_dim=400, input_dim=4,
                               element_sparsity=0.8, spectral_radius=0.9,
                               leak=0.5, mode="int8-csd", seed=1))
    states = np.asarray(j_run_reservoir(jp, jnp.asarray(x)))
    got = out["states"].numpy()
    assert got.shape == states.shape == (180, 120, 400)
    assert np.abs(got - states).max() <= INT8_STATE_TOL
    settled = states[:, 60:, :]
    feats = np.concatenate([settled.mean(axis=1), settled.std(axis=1)],
                           axis=1)
    assert np.abs(out["feats"] - feats).max() <= INT8_STATE_TOL
    onehot = np.eye(3, dtype=np.float32)[y]
    w = j_ridge_fit(jnp.asarray(feats[:120]), jnp.asarray(onehot[:120]),
                    lam=1e-3)
    want = np.asarray(jnp.asarray(feats[120:]) @ w).argmax(1)
    w_port = ridge_fit(torch.as_tensor(feats[:120]),
                       torch.as_tensor(onehot[:120]), lam=1e-3)
    got_pred = (torch.as_tensor(feats[120:]) @ w_port).argmax(1).numpy()
    assert np.mean(got_pred != want) <= ACC_TOL
    assert abs(out["acc"] - float((want == y[120:]).mean())) <= ACC_TOL
    assert out["acc"] > 0.8


# ---------------------------------------------------------------------------
# (c) the LM twins' loops against the reference's steps
# ---------------------------------------------------------------------------
def _auto_mesh():
    """The reference's ``(1, 1)`` host mesh with ``Auto`` axes."""
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if jnp.issubdtype(a.dtype, jnp.floating)
                        else np.asarray(a), tree)


def _lm_pair(name, pick):
    """(port cfg, reference LM, reference float32 params) of the config
    ``pick`` takes from a script's module: the twin's equals the
    reference's field for field."""
    cfg, jcfg = pick(twin(name)), pick(_load(name))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg = cfg.replace(dtype="float32")
    jlm = JLM(dataclasses.replace(jcfg, dtype="float32"))
    return cfg, jlm, jlm.init(jax.random.PRNGKey(0)).params


def _reference_serve(jlm, mesh, params, reqs, tokens):
    """``examples/serve_lm.py``'s loop, on ``mesh``."""
    from repro.serve import PaddingBucketer as JPaddingBucketer
    bucketer = JPaddingBucketer(len_buckets=(32, 64, 128, 256),
                                batch_buckets=(1, 2, 4, 8, 16))
    decoded, step_cache = {}, {}
    for mb in bucketer.group(reqs):
        bpad, tpad, _ = mb.inputs.shape
        if tpad not in step_cache:
            step_cache[tpad] = (
                jax.jit(j_make_prefill_step(jlm, mesh, tpad + tokens)),
                jax.jit(j_make_decode_step(jlm, mesh), donate_argnums=1))
        prefill, decode = step_cache[tpad]
        logits, caches = prefill(params, {"tokens": jnp.asarray(
            mb.inputs[:, :, 0])})
        lens = np.asarray(mb.lengths + [tpad] * (bpad - len(mb.requests)))
        tok = jnp.argmax(logits[jnp.arange(bpad), lens - 1],
                         axis=-1).astype(jnp.int32)[:, None]
        out = [tok]
        for _ in range(tokens - 1):
            logits, caches = decode(params, caches, tok)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            out.append(tok)
        seq = np.concatenate([np.asarray(t) for t in out], axis=1)
        for j, req in enumerate(mb.requests):
            decoded[req.uid] = seq[j]
    return decoded


def test_serve_lm_loop_equals_the_reference_steps():
    """Two bucket shapes (prompts 24-40 tokens), 6 greedy tokens: every
    request's tokens equal the reference's prefill/decode on its mesh."""
    mod = twin("serve_lm")
    cfg, jlm, jparams = _lm_pair("serve_lm", lambda m: m.CFG)
    rng = np.random.default_rng(0)
    lengths = [int(rng.integers(24, 41)) for _ in range(5)]
    prompts = [rng.integers(0, cfg.vocab_size, (t, 1)).astype(np.int32)
               for t in lengths]
    want = _reference_serve(
        jlm, _auto_mesh(), jparams,
        [JRolloutRequest(uid=i, inputs=p) for i, p in enumerate(prompts)], 6)
    with one_rank_group(CPU):
        mesh = make_host_mesh(CPU)
        lm = LM(cfg, device=CPU)
        params = lm_params_from_numpy(_to_np(jparams), cfg, device=CPU,
                                      mesh=mesh)
        stats = ServeStats()
        got, n_shapes = mod.serve(
            lm, mesh, params,
            [RolloutRequest(uid=i, inputs=p) for i, p in enumerate(prompts)],
            6, stats)
    assert n_shapes == 2 and stats.calls == 4
    assert sorted(got) == sorted(want) == list(range(5))
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


def test_train_lm_loop_equals_the_reference_steps(tmp_path):
    """The tiny preset in float32, 3 steps at 2 x 16 tokens from the
    reference's initial weights: each loss within LOSS_TOL of the
    reference's jitted step on its mesh."""
    mod = twin("train_lm")
    cfg, jlm, jparams = _lm_pair("train_lm", lambda m: m.PRESETS["tiny"])
    steps = 3
    stream = jpipe.LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2, seed=0)
    opt_cfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=100)
    mesh = _auto_mesh()
    step_fn = jax.jit(j_make_train_step(jlm, mesh, opt_cfg),
                      donate_argnums=0)
    state = {"params": jparams, "opt": jadamw.init_state(jparams)}
    start = _to_np(jparams)
    want = []
    for step in range(steps):
        batch = {k: jnp.asarray(v)
                 for k, v in jpipe.lm_batch(stream, step).items()}
        state, metrics = step_fn(state, batch)
        want.append(float(metrics["loss"]))
    args = types.SimpleNamespace(steps=steps, batch=2, seq=16,
                                 ckpt_dir=str(tmp_path), ckpt_every=25,
                                 simulate_failure=False)
    with one_rank_group(CPU):
        lm = LM(cfg, device=CPU)
        got, first, _ = mod.train(lm, make_host_mesh(CPU), args,
                                  params=lm_params_from_numpy(
                                      start, cfg, device=CPU))
    assert first == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
