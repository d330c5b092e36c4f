"""PyTorch / CUDA port of snvc_tpu for NVIDIA Hopper (H100).

The JAX package ``snvc_tpu`` is the reference; this package mirrors its
module layout so each module's counterpart is found under the same path.
It imports torch, numpy and the standard library only.  The TPU Pallas
kernels on the two serving paths (Vernier refinement and global stereo
detection) are hand-written CUDA kernels here (``csrc/``), built by
``_build.py`` with nvcc at first use.

Entry points default to ``device="cuda"`` and raise when no GPU is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
