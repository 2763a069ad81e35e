"""Synthetic Bullion tables (``write_lm_corpus``, ``write_ads_table``,
``write_quant_table``).

The training loader (``data/loader.py`` in the JAX package) is not ported
yet (ROADMAP.md §1, the next read slice)."""

from .synthetic import write_ads_table, write_lm_corpus, write_quant_table

__all__ = ["write_ads_table", "write_lm_corpus", "write_quant_table"]
