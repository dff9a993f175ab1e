"""Kernels of the port: hand-written CUDA (``csrc/``), their wrappers, the
plain PyTorch versions (:mod:`.ref`) and the schedule-resolving ops."""
