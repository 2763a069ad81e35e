"""Training-data reads: the ``BullionLoader`` and synthetic Bullion tables
(``write_lm_corpus``, ``write_ads_table``, ``write_quant_table``)."""

from .loader import BullionLoader, LoaderState
from .synthetic import write_ads_table, write_lm_corpus, write_quant_table

__all__ = ["BullionLoader", "LoaderState", "write_ads_table",
           "write_lm_corpus", "write_quant_table"]
