"""Data parallelism (``mesh.py``: one process per GPU, explicit collectives)
and the train step."""
