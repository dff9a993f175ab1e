"""PyTorch + CUDA port of the transfer-tuning serving stack, for NVIDIA Hopper.

``repro_torch`` sits beside the JAX package ``repro`` and keeps its module
names, so the counterpart of ``repro.X.Y`` is ``repro_torch.X.Y``.  It imports
torch, numpy and the standard library only: what it needs from ``repro``
(workloads, the schedule IR, the architecture configs) lives here as its own
copy, and the tests hold the two packages against each other.

Every Pallas kernel on the ported path has a hand-written CUDA C++ kernel for
``sm_90a`` under ``kernels/csrc/``, built with ``nvcc`` at first use and bound
with ``ctypes`` (:mod:`repro_torch.kernels._build`).  Each kernel wrapper
keeps its plain PyTorch version beside it (:mod:`repro_torch.kernels.ref`):
a tensor on the CPU takes the plain version, a tensor on the card launches
the kernel or raises.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, and raise when no GPU is present and the CPU was not asked for.
"""
