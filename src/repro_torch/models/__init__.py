"""The LM substrate's dense decoders, the PyTorch port of ``repro.models``
(config, layers, model; MoE, SSM and sharding come in later slices)."""
from .config import LayerSpec, ModelConfig
from . import layers, model

__all__ = ["LayerSpec", "ModelConfig", "layers", "model"]
