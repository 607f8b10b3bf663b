"""The harness of the port's benchmark (``qpbench/run.py``)."""
