"""Runtime support: deterministic fault injection (``faults``)."""
