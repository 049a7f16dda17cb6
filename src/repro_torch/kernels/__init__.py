"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel has: ``csrc/<file>.cu`` (the CUDA C++ source, built by
``_cuda`` with ``nvcc`` on first use), ``<file>.py`` (its wrapper: checks,
allocation, launch, launch count), an entry in ``ops`` (CPU tensor ->
``ref``, CUDA tensor -> kernel) and a plain PyTorch version in ``ref``.
"""
