"""PyTorch and CUDA port of the ``repro`` package, for one NVIDIA H100.

It mirrors ``src/repro`` module by module, imports nothing of JAX or of
``repro``, and runs on ``cuda`` unless a caller asks for the CPU.  Its
attention kernels are hand-written CUDA (``repro_torch.kernels``).
"""
