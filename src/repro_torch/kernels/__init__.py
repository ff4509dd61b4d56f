"""Hand-written CUDA kernels for Hopper (sm_90a), one package each.

Each package holds ``csrc/<name>.cu``, its launcher ``kernel.py``, the
plain PyTorch version ``ref.py`` / ``ops.py`` and the dispatcher
``ops.<name>`` that sends a CUDA tensor to the kernel and a CPU tensor to
the plain version.  ``_build`` compiles the sources with nvcc at first use.
"""
