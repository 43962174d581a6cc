"""Tensor ops and the hand-written Hopper kernels (see ``_cuda.py``)."""
