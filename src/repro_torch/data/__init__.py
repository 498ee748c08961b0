"""Synthetic LM data, numpy only: the reference's ``repro.data``."""
from .pipeline import PrefetchIterator, SyntheticLM, make_data_iterator
