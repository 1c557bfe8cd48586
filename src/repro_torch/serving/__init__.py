"""Serving from a training checkpoint: parameter restore, prefill, decode."""
