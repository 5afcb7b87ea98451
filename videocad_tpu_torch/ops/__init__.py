"""Tensor ops of the port: preprocessing and the hand-written kernels'
wrappers (each with its plain PyTorch version beside it), dropout and its
random bits, and the losses."""
