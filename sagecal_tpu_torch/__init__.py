"""sagecal-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``sagecal_tpu`` (the JAX reference). Module
names and layout follow the JAX package so every port module has an
obvious counterpart; inside, the code is plain PyTorch. The two Pallas
kernels on the full-batch calibration path are hand-written CUDA C++ for
``sm_90a`` (``csrc/``), built at first use and loaded with ``ctypes``.

This package imports ``torch`` and ``numpy`` only: never ``jax`` and
never ``sagecal_tpu``.
"""
