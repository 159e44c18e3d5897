"""The port's models."""
from .convert import (gluon_params_from_numpy, params_from_jax,
                      params_to_jax, rnn_arrays_to_flat, rnn_flat_to_arrays)
from .transformer import TransformerLM, TransformerLMConfig

__all__ = ["TransformerLM", "TransformerLMConfig", "params_from_jax",
           "params_to_jax", "gluon_params_from_numpy", "rnn_flat_to_arrays",
           "rnn_arrays_to_flat"]
