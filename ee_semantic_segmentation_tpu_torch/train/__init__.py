"""Checkpoint save/load (eval side)."""
