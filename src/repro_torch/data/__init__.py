"""The synthetic, resumable LM data pipeline (the port of ``repro.data``)."""
from .pipeline import DataConfig, SyntheticLMData, tsp_batch_stream

__all__ = ["DataConfig", "SyntheticLMData", "tsp_batch_stream"]
