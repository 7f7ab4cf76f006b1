"""The benchmark's plain reference: a frozen copy of the plain PyTorch
code of bpt_tpu_torch (the port), renamed, with every trace through the
plain walks (accel/api.py), the BVH built in numpy (accel/build.py) and
no kernel, compaction or native code.  It imports nothing of the port;
later changes to the port do not reach it.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
