"""tasmania_tpu_torch: the moist isentropic model of ``tasmania_tpu`` in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper GPUs.

The module paths mirror the JAX package's; ``interop`` moves states between
numpy and the port.  Importing the package builds nothing: the kernels are
compiled at first use on a CUDA device (``ops/_lib.py``).
"""

import importlib

__version__ = "0.1.0"

#: the subpackages the JAX package imports at the top, loaded here on first use
SUBPACKAGES = ("burgers", "domain", "dwarfs", "framework", "isentropic", "parallel", "physics")


def __getattr__(name):
    # lazy: importing the package builds nothing and imports no subpackage
    if name in SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    if name == "FieldArray":
        from tasmania_tpu_torch.framework.field import FieldArray

        return FieldArray
    raise AttributeError(name)
