"""Inference: the KV-cached rollout, the lane-multiplexed serving step and
the HTTP server. Import the submodules directly."""
