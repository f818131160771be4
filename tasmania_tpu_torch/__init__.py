"""tasmania_tpu_torch: the moist isentropic model of ``tasmania_tpu`` in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper GPUs.

The module paths mirror the JAX package's; ``interop`` moves states between
numpy and the port.  Importing the package builds nothing: the kernels are
compiled at first use on a CUDA device (``ops/_lib.py``).
"""
