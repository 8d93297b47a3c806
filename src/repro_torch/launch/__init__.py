"""Launch layer: meshes, the step builders, the dry run (specs, a step's
per-device tally, the per-cell driver) and its reports, and the roofline
(the LM analytic model and the rollout)."""
