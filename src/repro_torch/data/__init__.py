"""Data pipelines: the synthetic LM stream and the reservoir tasks."""
