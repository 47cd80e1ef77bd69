"""The LM substrate's models, the PyTorch port of ``repro.models``
(config, layers with GQA, MLA and cross-attention, moe, ssm, model with
the training loss, sharding's partition rules, shards and activation
constraints), and ``sharded``: a model's parameters held in shards over a
mesh."""
from .config import LayerSpec, ModelConfig
from . import layers, model, moe, sharded, sharding, ssm

__all__ = ["LayerSpec", "ModelConfig", "layers", "model", "moe", "sharded",
           "sharding", "ssm"]
