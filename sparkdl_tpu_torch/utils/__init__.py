"""Shared utilities (logging, metrics, prefetch)."""
