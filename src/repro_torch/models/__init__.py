"""The LM substrate's models, the PyTorch port of ``repro.models``
(config, layers with GQA, MLA and cross-attention, moe, ssm, model with
the training loss, and sharding's partition rules; placing shards over
more than one mesh position is ROADMAP item 18.6)."""
from .config import LayerSpec, ModelConfig
from . import layers, model, moe, sharding, ssm

__all__ = ["LayerSpec", "ModelConfig", "layers", "model", "moe", "sharding",
           "ssm"]
