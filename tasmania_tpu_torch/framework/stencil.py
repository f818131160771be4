"""Stencil registration and dispatch (counterpart of
``tasmania_tpu/framework/stencil.py``).

A stencil definition is an array function: arrays positionally, keyword-only
compile-time constants (externals).  Definitions are registered by name and
backend; ``compile_stencil`` resolves one and binds the externals of a
``BackendOptions``.  The port's backends are:

* ``"torch"``: tensors on any device;
* ``"numpy"``: host arrays, the oracle.

The JAX package's backend names ``"jax"``, ``"pallas"`` and
``"pallas:interpret"`` are accepted, so that user code ports unchanged, and
map to ``"torch"`` (``BACKEND_ALIASES``), at registration and at lookup.  No
backend name chooses between a kernel and its plain version: a kernel
wrapper launches its kernel on a CUDA tensor and runs the plain version on a
CPU one, whatever the backend.  ``BackendOptions.jit`` is accepted and wraps
nothing.
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Mapping, Optional

from tasmania_tpu_torch.framework import allocators
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.registry import Registry, make_decorator_registrar

#: the backend of a component that names none
DEFAULT_BACKEND = "torch"
#: the JAX package's backend names and the port's backend each runs as
BACKEND_ALIASES = {"jax": "torch", "pallas": "torch", "pallas:interpret": "torch"}


def resolve_backend(backend: Optional[str]) -> str:
    """The port's name of ``backend`` (``None`` is the default)."""
    backend = backend or DEFAULT_BACKEND
    return BACKEND_ALIASES.get(backend, backend)


#: global registries: stencil definitions and reusable subroutines
STENCIL_REGISTRY = Registry()
SUBROUTINE_REGISTRY = Registry()

#: decorator: @stencil_definition("diffusion", backend=("torch", "numpy"))
stencil_definition = make_decorator_registrar(STENCIL_REGISTRY, resolve_backend)
#: decorator: @subroutine_definition("laplacian", backend="torch")
subroutine_definition = make_decorator_registrar(SUBROUTINE_REGISTRY, resolve_backend)


def _bind_externals(fn: Callable, externals: Mapping[str, Any]) -> Callable:
    """``fn`` with the externals it declares as keywords bound."""
    if not externals:
        return fn
    sig = inspect.signature(fn)
    accepted = {
        k: v
        for k, v in externals.items()
        if k in sig.parameters
        and sig.parameters[k].kind
        in (inspect.Parameter.KEYWORD_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    }
    return functools.partial(fn, **accepted) if accepted else fn


def compile_stencil(
    name: str,
    backend: str = DEFAULT_BACKEND,
    backend_options: Optional[BackendOptions] = None,
) -> Callable:
    """The stencil ``name`` of ``backend`` with the externals of
    ``backend_options`` bound."""
    bo = backend_options or BackendOptions()
    return _bind_externals(STENCIL_REGISTRY.query(name, resolve_backend(backend)), bo.externals)


def compile_subroutine(
    name: str,
    backend: str = DEFAULT_BACKEND,
    backend_options: Optional[BackendOptions] = None,
) -> Callable:
    bo = backend_options or BackendOptions()
    return _bind_externals(SUBROUTINE_REGISTRY.query(name, resolve_backend(backend)), bo.externals)


class StencilFactory:
    """Mixin giving a component its backend, backend options and storage
    options, with compile and allocate methods that follow them."""

    def __init__(
        self,
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        self._backend = backend or DEFAULT_BACKEND
        self._backend_options = backend_options or BackendOptions()
        self._storage_options = storage_options or StorageOptions()

    @property
    def backend(self) -> str:
        return self._backend

    @property
    def backend_options(self) -> BackendOptions:
        return self._backend_options

    @property
    def storage_options(self) -> StorageOptions:
        return self._storage_options

    @storage_options.setter
    def storage_options(self, value: StorageOptions) -> None:
        self._storage_options = value

    def compile_stencil(self, name: str, backend: Optional[str] = None) -> Callable:
        return compile_stencil(name, backend or self._backend, self._backend_options)

    def compile_subroutine(self, name: str, backend: Optional[str] = None) -> Callable:
        return compile_subroutine(name, backend or self._backend, self._backend_options)

    def _options(self, dtype) -> StorageOptions:
        so = self._storage_options
        return so if dtype is None else StorageOptions(dtype=dtype, device=so.device)

    def zeros(self, shape, backend: Optional[str] = None, dtype=None):
        return allocators.zeros(backend or self._backend, shape, storage_options=self._options(dtype))

    def ones(self, shape, backend: Optional[str] = None, dtype=None):
        return allocators.ones(backend or self._backend, shape, storage_options=self._options(dtype))

    def empty(self, shape, backend: Optional[str] = None, dtype=None):
        return allocators.empty(backend or self._backend, shape, storage_options=self._options(dtype))

    def as_storage(self, data, backend: Optional[str] = None, dtype=None):
        return allocators.as_storage(backend or self._backend, data, storage_options=self._options(dtype))


# the generic definitions register themselves on import; a compile_stencil
# call finds them whichever module imported this one first
from tasmania_tpu_torch.framework import stencil_definitions  # noqa: E402,F401
