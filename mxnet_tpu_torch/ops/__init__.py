"""The port's operators: each hand-written CUDA kernel beside its plain
PyTorch version (see `flash_attention`)."""
