"""Build and loading of the port's hand-written kernels (``csrc/``)."""
