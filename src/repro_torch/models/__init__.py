"""The LM substrate's decoders, the PyTorch port of ``repro.models``
(config, layers with GQA and MLA attention, moe, model; SSM and sharding
come in later slices)."""
from .config import LayerSpec, ModelConfig
from . import layers, model, moe

__all__ = ["LayerSpec", "ModelConfig", "layers", "model", "moe"]
