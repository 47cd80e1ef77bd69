"""The LM substrate's models, the PyTorch port of ``repro.models``
(config, layers with GQA, MLA and cross-attention, moe, ssm, model;
sharding comes in a later slice)."""
from .config import LayerSpec, ModelConfig
from . import layers, model, moe, ssm

__all__ = ["LayerSpec", "ModelConfig", "layers", "model", "moe", "ssm"]
