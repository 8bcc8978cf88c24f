"""Shared utilities (logging, metrics, prefetch, the loss check)."""
