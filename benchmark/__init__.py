"""The benchmark of the PyTorch/CUDA port (README.md; one run: run.py)."""
