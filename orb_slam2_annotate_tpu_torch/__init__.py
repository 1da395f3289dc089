"""orb_slam2_annotate_tpu_torch — the PyTorch / CUDA port of orb_slam2_annotate_tpu.

The JAX package beside this one is the reference; every module here has a
counterpart of the same name there.  This package imports ``torch`` and
never ``jax``.  Hot operations that the JAX package left to XLA fusion are
hand-written CUDA kernels for Hopper (``csrc/``), each with a plain PyTorch
twin in its wrapper module (``kernels/``): CPU tensors take the twin, CUDA
tensors launch the kernel or raise.

Subpackages: geometry, ops, solvers, worldmap, pipeline, io, kernels.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and normal-equation math must be true float32, as the reference
# forces jax_default_matmul_precision="highest": TF32 keeps ~3 decimal
# digits, which breaks Lie-group orthonormality and LM convergence.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
