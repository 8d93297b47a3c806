"""The one serve request/response contract.

Every caller builds a :class:`SubmitSpec` and every path answers with a
:class:`RolloutResult`: :class:`~repro_torch.serve.engine.ReservoirEngine`
and :class:`~repro_torch.serve.scheduler.AsyncReservoirServer` accept the
spec identically.  The module is dependency-free on purpose (no engine
imports) so every serve module can import it without cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Any


class _Unset:
    """Sentinel distinguishing "kwarg not passed" from an explicit value
    (``None`` is a legal ``vmem_budget``: forced resident)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "<unset>"

    def __bool__(self) -> bool:
        return False


_UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class SubmitSpec:
    """One serving request, identical across every entry point.

    ``inputs`` is the (T, input_dim) step sequence (engines also accept a
    pre-batched (B, T, input_dim) array on the one-shot path).  Everything
    else is keyword-only:

    * ``model``        — registry model name to route to (multi-tenant
      servers resolve it through their :class:`ModelRegistry`; the bare
      single-model engine rejects it).
    * ``x0``           — optional (reservoir_dim,) initial state.
    * ``deadline``     — absolute time on the server's clock; a spec still
      queued past it is dropped (``timed_out``).  ``None`` falls back to
      the model's registry deadline policy, if any.
    * ``want_states``  — ``True``: answer with the (T, R) state
      trajectory; ``False``: answer with (T, O) predictions; ``None``
      (default): predictions when the serving engine has a trained
      readout, states otherwise.
    * ``uid``          — result key; servers assign ``req<N>`` when None.
    * ``trace_id``     — observability correlation id threaded through
      every span this request touches and echoed in
      ``RolloutResult.timings``; when ``None`` and tracing is enabled
      (``repro_torch.obs.configure()``), servers assign one at submit.
    """

    inputs: Any
    _: dataclasses.KW_ONLY
    model: str | None = None
    x0: Any | None = None
    deadline: float | None = None
    want_states: bool | None = None
    uid: Any | None = None
    trace_id: str | None = None

    @property
    def length(self) -> int:
        return int(self.inputs.shape[0])


@dataclasses.dataclass(frozen=True)
class RolloutResult:
    """What every serve path answers with.

    Exactly one of ``preds``/``states`` is set (by ``want_states``);
    ``output`` is the one that is.  ``final_state`` is x(T) on the
    one-shot engine paths (the carry a chunked caller resumes from
    bit-identically); scheduler paths answer ``None`` — a pooled chunk
    rolls past a retiring sequence's real length, so the pool row is not
    x(T).

    ``timings`` is a plain mutable dict following ONE schema on every
    path (one-shot engine calls and queued scheduler serving alike —
    built by :func:`lifecycle_timings`).  All times are seconds on the
    path's serving clock: ``time.perf_counter`` for direct engine calls,
    the server's virtual clock for scheduled requests.

    Always present:

    * ``arrival_time``      — when the request entered the system (a
      direct engine call "arrives" when it is made);
    * ``admit_time``        — when work started (equals ``arrival_time``
      on direct calls: there is no queue to wait in);
    * ``finish_time``       — when the result was complete;
    * ``first_output_time`` — when the first chunk of output was ready
      (equals ``finish_time`` on one-shot calls);
    * ``queue_wait_s``      — ``admit_time - arrival_time``;
    * ``ttfp_s``            — ``first_output_time - arrival_time``
      (time to first prediction);
    * ``latency_s``         — ``finish_time - arrival_time``;
    * ``seconds``           — time spent actually serving: the fused
      rollout wall time on engine paths, ``finish_time - admit_time``
      (slot residency) on scheduler paths.

    Present when applicable:

    * ``model`` / ``version`` — the registry tenant and pinned version a
      routed request was served by;
    * ``trace_id``           — the observability correlation id (set
      when ``repro_torch.obs`` tracing is enabled or the spec carried one).

    ``status`` is ``"ok"`` on every served result.  A server whose
    admission policy refuses a submission answers immediately with
    ``status="rejected"`` — no payload, and ``timings`` carrying
    ``reason`` (``"queue_full"`` / ``"deadline_unmeetable"`` /
    ``"tenant_over_share"``) plus ``retry_after_s``, the policy's
    estimate of when resubmitting could succeed.
    """

    preds: Any | None = None
    states: Any | None = None
    final_state: Any | None = None
    timings: dict = dataclasses.field(default_factory=dict)
    status: str = "ok"

    @property
    def rejected(self) -> bool:
        """True when admission control refused this submission."""
        return self.status == "rejected"

    @property
    def output(self) -> Any:
        """The requested payload: predictions, or states under
        ``want_states=True``."""
        return self.states if self.preds is None else self.preds


def lifecycle_timings(*, arrival_time: float, admit_time: float,
                      finish_time: float,
                      first_output_time: float | None = None,
                      seconds: float | None = None,
                      model: str | None = None,
                      version: int | None = None,
                      trace_id: str | None = None) -> dict:
    """Build the one documented ``RolloutResult.timings`` schema.

    Every serve path calls this so the key set can never drift between
    the one-shot engine paths and the scheduler paths (see
    :class:`RolloutResult` for the key meanings).  ``first_output_time``
    defaults to ``finish_time`` (one-shot: the whole output lands at
    once); ``seconds`` defaults to ``finish_time - admit_time``.
    """
    if first_output_time is None:
        first_output_time = finish_time
    t = {
        "arrival_time": arrival_time,
        "admit_time": admit_time,
        "first_output_time": first_output_time,
        "finish_time": finish_time,
        "queue_wait_s": admit_time - arrival_time,
        "ttfp_s": first_output_time - arrival_time,
        "latency_s": finish_time - arrival_time,
        "seconds": (finish_time - admit_time if seconds is None
                    else seconds),
    }
    if model is not None:
        t["model"] = model
        t["version"] = version
    if trace_id is not None:
        t["trace_id"] = trace_id
    return t


__all__ = ["SubmitSpec", "RolloutResult", "lifecycle_timings"]
