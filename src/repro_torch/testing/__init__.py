"""Hermetic test doubles shared by tests, benchmarks, and the quickstart."""

from .chaos import ChaosController, Fault, chaos
from .objstore import FakeObjectStore

__all__ = ["ChaosController", "FakeObjectStore", "Fault", "chaos"]
