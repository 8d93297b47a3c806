"""Serving-side re-planning: the live-swap action contract.

The JAX package's ``runtime/elastic.py`` also holds mesh re-planning after
host failures, elastic shrink/grow of a sharded serving pool, autoscaling,
heartbeats and a straggler watchdog.  Those arrive with the multi-device
slice; what single-device serving needs is :func:`swap_serve_plan`, the
contract :meth:`~repro_torch.serve.registry.ModelRegistry.publish`
executes.  Framework-free.
"""

from __future__ import annotations

__all__ = ["swap_serve_plan"]


def swap_serve_plan(name: str, old_version: int | None,
                    new_version: int) -> dict:
    """Live-swap response for a multi-tenant serving pool.

    Publishing a new version of a served model changes nothing about the
    devices, but the engine behind a tenant's admissions does, and the
    state that must survive is the in-flight work.  The action list is the
    contract ``ModelRegistry.publish`` executes — build *before* cutover,
    pin in-flight slots to the engine they started on, and make the
    cutover a single atomic active-version write so no request ever
    observes a half-swapped model.
    """
    return {
        "model": name,
        "previous_version": old_version,
        "version": new_version,
        "actions": [
            "build the new version's engine off-path (plan -> specialize "
            "-> kernel tables; ExecutionPlan cached per registry identity)",
            "prewarm it against every attached server's pool shapes "
            "(chunk launch run before any request routes to it)",
            "atomic cutover: flip the registry's active version — new "
            "admissions pin the new engine",
            "in-flight slots keep their admission-pinned engine and run "
            "to completion (zero drops, bit-exact both sides)",
            "demote the retired version in the engine LRU so it is first "
            "out once its last pinned slot retires",
        ],
    }
