"""Batched early-exit evaluators."""
