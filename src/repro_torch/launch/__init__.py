"""Launch layer: the data mesh of sharded serving, the LM prefill/decode
step builders, and the roofline (the LM analytic model and the rollout)."""
