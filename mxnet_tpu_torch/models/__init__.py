"""The port's models."""
from .convert import params_from_jax, params_to_jax
from .transformer import TransformerLM, TransformerLMConfig

__all__ = ["TransformerLM", "TransformerLMConfig", "params_from_jax",
           "params_to_jax"]
