"""Optimizer substrate."""
