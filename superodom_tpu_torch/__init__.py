"""superodom_tpu_torch — the LiDAR-inertial odometry pipeline in PyTorch.

The package mirrors ``superodom_tpu`` module by module (same function and
NamedTuple field names) so every piece can be held against its JAX
counterpart.  The hot ops of scan-to-map registration run as hand-written
CUDA kernels (``csrc/``, bound in :mod:`superodom_tpu_torch.kernels`); every
kernel has a plain PyTorch version beside it that CPU tensors take.

This package imports torch and numpy only — never jax, never superodom_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# Estimator math is small dense contractions (3x3 PCA scatter, 6x6 normal
# equations): reduced-precision accumulation costs pose accuracy, so f32
# products stay full f32 everywhere (mirrors jax_default_matmul_precision
# "highest" in the JAX package).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
