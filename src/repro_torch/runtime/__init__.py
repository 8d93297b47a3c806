"""Runtime support: deterministic fault injection (``faults``) and elastic
re-planning, autoscaling and the live-swap contract (``elastic``)."""
