"""The benchmark's plain reference of VideoCADFormer: float32 PyTorch,
written from the published description. It imports nothing of the
program (``videocad_tpu_torch``) and nothing of JAX."""
