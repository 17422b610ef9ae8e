"""Samplers and warmup."""
