"""bpt_tpu_torch: the bidirectional path tracer on PyTorch and CUDA.

A port of `bpt_tpu` (the JAX package, which stays the reference) to
PyTorch on an NVIDIA Hopper GPU.  The layout mirrors `bpt_tpu` module for
module; plain tensor code is eager PyTorch, and the seven trace kernels
(closest hit and any hit: K1 and K2 on tables of at most 2,048 treelets,
the main path's; K3 and K4 on tables of any size; K5-K7, the
counterparts of the reference's other kernels) are hand-written CUDA C++
under `csrc/`, built with nvcc at first use (`ops/_build.py`).

Every wrapper around a kernel runs its plain PyTorch version for tensors
on the CPU and launches the kernel for CUDA tensors; there is no other
route.  Randomness is counter-based threefry2x32 keyed by lane identity,
bit-exact with `jax.random` (`core/rng.py`).
"""
import torch

# No matrix product in the port may run in TF32: the tracer and the MIS
# weights are compared with the f32 reference at a few ulp.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
