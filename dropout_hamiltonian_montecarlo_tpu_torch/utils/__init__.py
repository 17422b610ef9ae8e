"""Profiling and conversion helpers."""
