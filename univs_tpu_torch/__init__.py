"""univs_tpu_torch — the PyTorch/CUDA port of ``univs_tpu``.

Same models, same inference laws, same outputs as the JAX package, in
PyTorch, with every Pallas kernel of the ported path replaced by a
CUDA C++ kernel written for Hopper (``sm_90a``) under ``csrc/``.

Layout mirrors ``univs_tpu`` (``ops/``, ``models/``, ``prompts/``,
``losses/``, ``inference/``, ``utils/``) so each module's counterpart
is easy to find.  Public module boundaries keep the JAX package's
layouts (NHWC feature maps, ``[N, Lq, M*D]`` MSDA output, the memory
pool's field shapes).

Numerics: the port states both TF32 switches and turns them off — a
float32 reference must not silently run its convolutions in TF32
(cuDNN's default).  On the card the compute dtype is bf16, on the CPU
float32, as ``compute_dtype_of`` says.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
