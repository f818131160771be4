"""The framework's exceptions (counterpart of
``tasmania_tpu/utils/exceptions.py``)."""


class FactoryRegistryError(Exception):
    """Raised on unknown registry keys or malformed factory registration."""


class IncompatibleUnitsError(Exception):
    """Raised when two unit strings cannot be converted into one another."""


class IncompatibleDimensionsError(Exception):
    """Raised when declared field dimensions disagree between components."""


class PropertyError(Exception):
    """Raised when component property dictionaries are inconsistent."""


class TimeError(Exception):
    """Raised on malformed model time/timestep handling."""
