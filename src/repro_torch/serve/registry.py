"""Multi-tenant model registry with bit-exact live swap.

A :class:`ModelRegistry` owns named, versioned models: each
:class:`ModelVersion` wraps trained :class:`~repro_torch.core.esn.ESNParams`
plus the engine configuration (backend / specialization kwargs / device)
it should serve under.  Engines are built lazily through the bounded
``engine_for`` LRU, keyed on the registry's ``(name, version)`` identity —
so re-registering bit-identical weights under a new version is a distinct
cache entry, and retraining in place never serves a stale engine.

``publish(name, ...)`` is the live-swap path.  The new version's engine is
planned, specialized and built *before* cutover — including a prewarm of
the chunk call against every attached
:class:`~repro_torch.serve.scheduler.AsyncReservoirServer`'s pool shape
(kernel builds, table uploads) — then the active-version pointer flips
atomically.  In-flight slots keep the
engine version pinned at their admission and run to completion; only new
admissions see the new version.  The retired version is demoted to the
eviction front of the engine LRU so it falls out once traffic stops
pinning it.  The whole procedure is the serving analogue of the elastic
shrink: :func:`~repro_torch.runtime.elastic.swap_serve_plan` records the
action contract, ``publish`` executes it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch import obs
from repro_torch.runtime import faults
from repro_torch.runtime.elastic import swap_serve_plan
from repro_torch.serve.api import SubmitSpec
from repro_torch.serve.engine import engine_cache_demote, engine_for

__all__ = ["ModelRegistry", "ModelVersion", "TenantPolicy"]


@dataclasses.dataclass
class TenantPolicy:
    """Per-tenant serving policy.

    ``quota`` caps the tenant's concurrently-seated slots per pool (None =
    unbounded); ``deadline_s`` is a relative queue deadline applied to
    specs that don't carry their own (None = no deadline).
    """

    quota: int | None = None
    deadline_s: float | None = None


@dataclasses.dataclass(frozen=True)
class ModelVersion:
    """One immutable registered (name, version) -> params binding."""

    name: str
    version: int
    params: Any
    # sorted (key, value) tuple so the record stays hashable/frozen
    engine_kwargs: tuple = ()

    @property
    def key(self) -> tuple[str, int]:
        """The ``engine_for``/``plan_for`` tenant identity."""
        return (self.name, self.version)


class ModelRegistry:
    """Named, versioned models behind one serve surface.

    ``backend``/``engine_kwargs`` set registry-wide engine defaults;
    per-model kwargs at ``register``/``publish`` override them (``device=``
    among them).  ``build`` (signature ``build(params, backend=, device=,
    **kwargs) -> engine``) replaces engine construction wholesale.
    """

    def __init__(self, backend: str = "auto",
                 build: Callable | None = None, **engine_kwargs):
        self.backend = backend
        self._build = build
        self._engine_kwargs = dict(engine_kwargs)
        self._versions: dict[str, dict[int, ModelVersion]] = {}
        self._active: dict[str, int] = {}
        self._policies: dict[str, TenantPolicy] = {}
        self._servers: list = []

    # -- bookkeeping ---------------------------------------------------------
    def attach(self, server) -> None:
        """Wire a server to this registry: its submits route model specs
        here and its pool gets prewarmed on every publish."""
        if server not in self._servers:
            self._servers.append(server)
        server.registry = self

    def detach(self, server) -> None:
        if server in self._servers:
            self._servers.remove(server)
        if getattr(server, "registry", None) is self:
            server.registry = None

    @property
    def models(self) -> list[str]:
        return sorted(self._versions)

    def versions(self, name: str) -> list[int]:
        return sorted(self._versions[name])

    def active_version(self, name: str) -> int:
        if name not in self._active:
            raise KeyError(f"no model named {name!r} registered")
        return self._active[name]

    def get(self, name: str, version: int | None = None) -> ModelVersion:
        v = self.active_version(name) if version is None else version
        try:
            return self._versions[name][v]
        except KeyError:
            raise KeyError(f"model {name!r} has no version {v}") from None

    def quota(self, name: str) -> int | None:
        pol = self._policies.get(name)
        return None if pol is None else pol.quota

    def deadline_s(self, name: str) -> float | None:
        pol = self._policies.get(name)
        return None if pol is None else pol.deadline_s

    def set_policy(self, name: str, *, quota: int | None = None,
                   deadline_s: float | None = None) -> TenantPolicy:
        pol = TenantPolicy(quota=quota, deadline_s=deadline_s)
        self._policies[name] = pol
        return pol

    # -- registration --------------------------------------------------------
    def register(self, name: str, params, *, version: int | None = None,
                 quota: int | None = None, deadline_s: float | None = None,
                 activate: bool = True, **engine_kwargs) -> ModelVersion:
        """Record ``params`` as a version of ``name``.

        ``version`` defaults to (highest registered) + 1, starting at 1.
        ``activate=True`` makes it the version new admissions route to —
        without the prewarm-before-cutover dance of ``publish`` (use
        ``publish`` for models already taking traffic).
        """
        vs = self._versions.setdefault(name, {})
        if version is None:
            version = max(vs, default=0) + 1
        if version in vs:
            raise ValueError(
                f"model {name!r} already has a version {version} — "
                "versions are immutable; publish a new one")
        kw = {**self._engine_kwargs, **engine_kwargs}
        mv = ModelVersion(name=name, version=version, params=params,
                          engine_kwargs=tuple(sorted(kw.items())))
        vs[version] = mv
        if quota is not None or deadline_s is not None:
            self.set_policy(name, quota=quota, deadline_s=deadline_s)
        if activate or name not in self._active:
            self._active[name] = version
        return mv

    # -- engines -------------------------------------------------------------
    def engine(self, name: str, version: int | None = None):
        """The (lazily built, LRU-cached) engine serving
        ``(name, version)``; default the active version."""
        mv = self.get(name, version)
        return engine_for(mv.params, self.backend, tenant=mv.key,
                          build=self._build, **dict(mv.engine_kwargs))

    # -- live swap -----------------------------------------------------------
    def publish(self, name: str, params=None, *, version: int | None = None,
                prewarm: bool = True, **engine_kwargs) -> dict:
        """Swap ``name`` to a new version with zero downtime.

        With ``params``, registers them as a fresh version first; with
        ``version`` alone, re-activates an already-registered one
        (rollback).  Either way the target engine is fully built —
        plan -> specialize -> kernel tables, plus a chunk-call prewarm on
        every attached server — *before* the atomic active-version flip,
        so no request ever waits on a swap build.  In-flight slots
        finish on their admission-pinned engine; the retired version is
        demoted in the engine LRU.  Returns the executed
        :func:`~repro_torch.runtime.elastic.swap_serve_plan` with timing
        attached.
        """
        old = self._active.get(name)
        if params is not None:
            mv = self.register(name, params, version=version,
                               activate=False, **engine_kwargs)
        elif version is not None:
            mv = self.get(name, version)
        else:
            raise ValueError("publish() needs params (new version) or "
                             "version= (rollback)")
        t0 = time.perf_counter()
        if prewarm:
            if self._servers:
                for srv in self._servers:
                    srv.prewarm_model(name, mv.version)
            else:
                self.engine(name, mv.version)
        prewarm_s = time.perf_counter() - t0
        # fault-injection seam: an installed FaultPlan may abort the swap
        # at the worst moment — after the prewarm spend, before the
        # cutover.  The active version is untouched (the one dict write
        # below never happened) and the prewarmed version stays
        # registered inactive, so a retry publishes it without
        # rebuilding.  In-flight and future traffic keep serving the old
        # version with zero drops.
        fault_plan = faults.active()
        if fault_plan is not None and fault_plan.take_publish_abort():
            obs.event("publish_abort", model=name, old_version=old,
                      staged_version=mv.version, prewarm_s=prewarm_s)
            obs.inc("publish_aborts_total", model=name)
            raise faults.PublishAborted(
                f"injected abort publishing {name!r} v{mv.version}: "
                f"active version stays {old!r}")
        # atomic cutover: one dict write — admissions resolve the active
        # version at a single point (_resolve_engine), so a request sees
        # wholly-old or wholly-new, never a mix
        self._active[name] = mv.version
        if old is not None and old != mv.version:
            engine_cache_demote((name, old))
        obs.event("publish", model=name, old_version=old,
                  new_version=mv.version, prewarm_s=prewarm_s)
        obs.inc("publishes_total", model=name)
        obs.span("registry.publish", t0, t0 + prewarm_s, clock="wall",
                 model=name, version=mv.version)
        plan = swap_serve_plan(name, old, mv.version)
        plan["prewarm_s"] = prewarm_s
        return plan

    # -- convenience ---------------------------------------------------------
    def submit(self, spec: SubmitSpec):
        """One-shot synchronous rollout of ``spec`` on its model's active
        engine (no pool, no queue) — handy for smoke tests."""
        if spec.model is None:
            raise ValueError("registry.submit() needs spec.model")
        eng = self.engine(spec.model)
        return eng.submit(dataclasses.replace(spec, model=None))
