"""Custom exceptions. Counterpart of ``nessai_tpu/utils/errors.py``."""


class RNGError(RuntimeError):
    """Base class for RNG-related errors."""


class RNGNotSetError(RNGError):
    """Raised when a component requires an RNG that has not been set."""

    def __init__(self, msg: str = "rng not set") -> None:
        super().__init__(msg)


class RNGSetError(RNGError):
    """Raised when attempting to overwrite an already-set RNG."""

    def __init__(self, msg: str = "rng already set") -> None:
        super().__init__(msg)


class SamplingError(RuntimeError):
    """Raised when sampling fails irrecoverably."""
