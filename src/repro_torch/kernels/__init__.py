"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel has: ``csrc/<file>.cu`` (the CUDA C++ source, built by
``_cuda`` with ``nvcc`` on first use), ``<file>.py`` (its wrapper: checks,
allocation, launch, launch count), an entry in ``ops`` (CPU tensor ->
``ref``, CUDA tensor -> kernel) and a plain PyTorch version in ``ref``.
Every kernel module is imported here, so attribute access never depends
on what was imported before.
"""
from . import (
    collective_quant, decode_attention, dequant_reduce, fedavg_reduce, flash_attention, ops,
    quantize, ref, scatter_reduce, selective_scan,
)
