"""Standalone fleet components (the metrics component)."""
