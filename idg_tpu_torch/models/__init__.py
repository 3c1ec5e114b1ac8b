"""The f64 NumPy golden oracle."""

from .reference import degridder_reference, gridder_reference

__all__ = ["degridder_reference", "gridder_reference"]
