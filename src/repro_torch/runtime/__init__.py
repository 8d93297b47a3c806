"""Runtime support: deterministic fault injection (``faults``) and the
live-swap contract (``elastic``)."""
