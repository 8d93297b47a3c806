"""Launch layer: the rollout roofline (the LM half comes with its configs)."""
