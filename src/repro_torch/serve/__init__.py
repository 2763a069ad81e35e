"""The port's serving: the multi-tenant dataset service
(``DatasetServer``/``ServeClient``, ported from ``repro.serve``), which fronts
Bullion datasets for feature-serving workloads with its range filter and
dequantize on the server's device, and the LM serving engine
(``ServeEngine``, ``serve.lm``)."""

from .client import ClientResult, ServeClient, ServeError
from .lm import ServeEngine
from .server import DatasetServer, PlanCache, QueryResult, TenantBudget

__all__ = [
    "DatasetServer", "PlanCache", "QueryResult", "TenantBudget",
    "ServeClient", "ClientResult", "ServeError", "ServeEngine",
]
