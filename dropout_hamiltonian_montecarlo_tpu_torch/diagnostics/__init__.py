"""Convergence diagnostics."""
