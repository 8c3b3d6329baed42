"""isaacgym_tpu_torch: the PyTorch/CUDA port of ``isaacgym_tpu``.

The flagship env step (``make("HumanoidPingpongTiltNoEarlyStopG1")``) runs
on an NVIDIA H100 through a hand-written CUDA kernel for the fused physics
substep (``csrc/fused_substep.cu``). Layers, bottom-up:
  csrc/    the CUDA kernel and its host loop
  ops/     the kernel's wrapper, plain version, constant pack and build
  models/  URDF parsing, the kinematic-tree compiler, batched FK
  sim/     scene compilation and the batched simulator
  env/     the vectorized env step with branch-free auto-reset
  tasks/   the flagship pingpong task
Imports torch and numpy only: no JAX, no YAML, nothing of ``isaacgym_tpu``.
"""

__version__ = "0.1.0"

from isaacgym_tpu_torch.make import make  # noqa: F401
