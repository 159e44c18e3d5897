"""The port's models."""
from .convert import gluon_params_from_numpy, params_from_jax, params_to_jax
from .transformer import TransformerLM, TransformerLMConfig

__all__ = ["TransformerLM", "TransformerLMConfig", "params_from_jax",
           "params_to_jax", "gluon_params_from_numpy"]
