"""Data pipeline (the port of ``repro.data``)."""

from .pipeline import DataConfig, SyntheticLMDataset, make_dataset

__all__ = ["DataConfig", "SyntheticLMDataset", "make_dataset"]
