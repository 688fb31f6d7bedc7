"""tensornetworksfork_tpu_torch — the PyTorch + CUDA port of tensornetworksfork_tpu.

The same tensor-network sweep trainer (DMRG-style Gauss-Newton node updates
over a static topology) written for one NVIDIA H100: plain tensor work is
PyTorch, and every Pallas kernel of the JAX package's Gram path is a CUDA C++
kernel written by hand for sm_90a (`csrc/gram.cu`, bound in `ops/cuda`).

The JAX package `tensornetworksfork_tpu` stays beside this one as the
reference; the module layout and names follow it so each counterpart can be
found. This package never imports JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# Mirrors tensornetworksfork_tpu/__init__.py, which sets
# jax_default_matmul_precision="highest" for the whole package: every f32
# matmul and convolution runs in full f32, never TF32 — the Gauss-Newton
# systems are resolved to f32 accuracy.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .core.topology import Topology, TopologyBuilder, NodeSpec, PARAM, INPUT, CONST  # noqa: E402
from .core.engine import Network  # noqa: E402
from .core.sweep import SweepConfig, Sweeper, Member, accumulating_sweep  # noqa: E402
from .core import solve  # noqa: E402
from .ops import bregman  # noqa: E402
