"""Launch layer: the data mesh of sharded serving and the rollout roofline
(the LM half comes with its configs)."""
