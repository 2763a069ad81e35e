from .lm import ServeEngine

__all__ = ["ServeEngine"]
