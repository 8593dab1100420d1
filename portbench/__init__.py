"""The benchmark of the PyTorch and CUDA port (``portbench/run.py``)."""
