"""Hierarchical registries (counterpart of ``tasmania_tpu/framework/registry.py``).

Two registries live here:

* ``Registry``: a two-level mapping ``name -> backend -> payload`` with a
  wildcard (``"all"``) and glob-style backend patterns (``"torch*"``), which
  holds the stencil definitions (``framework/stencil.py``);
* ``factor_register`` and ``factorize``: string-keyed subclass factories,
  through which the framework builds its boundaries, topographies, steppers,
  flux schemes, prognostic schemes and dwarfs.  A subclass registered by a
  user is built by its name as the built-in ones are.
"""

from __future__ import annotations

import fnmatch
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

from tasmania_tpu_torch.utils.exceptions import FactoryRegistryError

WILDCARD = "all"


class Registry:
    """``name -> backend -> payload`` with wildcard and glob backend patterns."""

    def __init__(self) -> None:
        self._store: Dict[str, Dict[str, Any]] = {}

    def register(self, payload: Any, name: str, backend: str = WILDCARD) -> None:
        self._store.setdefault(name, {})[backend] = payload

    def query(self, name: str, backend: str) -> Any:
        """The payload of (name, backend): the exact backend, else the
        longest glob pattern that matches it (``"torch:cuda*"`` before
        ``"torch*"``), else the wildcard.  An unknown name falls back to the
        entry registered under the wildcard name, if any."""
        entry = self._store.get(name)
        if entry is None:
            entry = self._store.get(WILDCARD)
        if entry is None:
            raise FactoryRegistryError(f"no registration for {name!r}")
        if backend in entry:
            return entry[backend]
        candidates = [pat for pat in entry if pat != WILDCARD and fnmatch.fnmatchcase(backend, pat)]
        if candidates:
            return entry[max(candidates, key=len)]
        if WILDCARD in entry:
            return entry[WILDCARD]
        raise FactoryRegistryError(
            f"no registration for {name!r} under backend {backend!r}; available: {sorted(entry)}"
        )

    def names(self) -> Sequence[str]:
        return tuple(self._store)

    def backends(self, name: str) -> Sequence[str]:
        return tuple(self._store.get(name, ()))

    def __contains__(self, name: str) -> bool:
        return name in self._store


def make_decorator_registrar(registry: Registry, normalize: Callable[[str], str] = str) -> Callable:
    """A decorator ``@reg(name, backend=...)`` filling ``registry``; each
    backend name goes through ``normalize`` first."""

    def registrar(name: str, backend="torch"):
        backends = (backend,) if isinstance(backend, str) else tuple(backend)

        def wrap(fn):
            for b in backends:
                registry.register(fn, name, normalize(b))
            return fn

        return wrap

    return registrar


def factor_register(name: str) -> Callable[[type], type]:
    """Class decorator registering a subclass under ``name`` on the nearest
    base whose class body defines a ``registry`` dict."""

    def wrap(cls: type) -> type:
        for base in cls.__mro__[1:]:
            reg = base.__dict__.get("registry")
            if isinstance(reg, dict):
                reg[name] = cls
                cls.registry_name = name
                return cls
        raise FactoryRegistryError(f"{cls.__name__} has no factory base with a 'registry' dict")

    return wrap


def factorize(
    name: str,
    base: type,
    args: Sequence[Any] = (),
    kwargs: Optional[Mapping[str, Any]] = None,
) -> Any:
    """An instance of the subclass registered under ``name`` on ``base``."""
    reg = base.__dict__.get("registry")
    if not isinstance(reg, dict):
        raise FactoryRegistryError(f"{base.__name__} defines no registry")
    if name not in reg:
        raise FactoryRegistryError(f"unknown {base.__name__} flavour {name!r}; registered: {sorted(reg)}")
    return reg[name](*args, **(dict(kwargs) if kwargs else {}))


def registered_names(base: type) -> Sequence[str]:
    """The names registered on ``base``, in the order of registration."""
    reg = base.__dict__.get("registry")
    return tuple(reg) if isinstance(reg, dict) else ()
