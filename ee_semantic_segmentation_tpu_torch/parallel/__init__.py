"""The train step (one device; multi-GPU is a ROADMAP.md item)."""
