from .sharding import Dist, make_dist, make_rules

__all__ = ["Dist", "make_dist", "make_rules"]
