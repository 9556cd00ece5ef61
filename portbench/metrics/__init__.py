"""Per-layer metric readers (`<metric>.py`, each a `read(ctx)`; their
arithmetic is `portbench/readers.py`) and the frozen cost model."""
