"""PyTorch / CUDA port of videocad_tpu for one NVIDIA H100.

The JAX package ``videocad_tpu`` beside this one is the reference: the
port reads the same ``model_configs/*.json``, its parameter names follow
the JAX parameter tree (``decoder.layers_3.cross_attn.key.weight``), and
its tests hold each module against the JAX module on the same inputs.

This package imports ``torch`` and never ``jax`` or ``videocad_tpu``: the
machine with the card has neither. Framework-free code it needs (the
action vocabulary, the HTTP serving protocol, the metric accumulation, the
synthetic batch feed) is carried as its own copy, and the tests hold the
copies equal to the originals.

Hand-written kernels live in ``csrc/`` and are built at first use by
``kernels/build.py``; each wrapper runs its plain PyTorch version on a CPU
tensor and launches the kernel (or raises) on a CUDA tensor.
"""
