"""isaacgym_tpu_torch: the PyTorch/CUDA port of ``isaacgym_tpu``.

The pingpong tasks' env steps (``make("HumanoidPingpongTiltNoEarlyStopG1")``
and the others of ``tasks/``) run on an NVIDIA H100 through hand-written
CUDA kernels for the fused physics substep: ``csrc/fused_substep.cu`` (one
fixed-base humanoid), ``csrc/fused_substep_multi.cu`` (several) and
``csrc/fused_substep_floating.cu`` (a floating base). Layers, bottom-up:
  csrc/    the CUDA kernels and their host loop
  ops/     the kernels' wrappers, plain versions, constant packs and build
  models/  URDF parsing, the kinematic-tree compiler, batched FK
  sim/     scene compilation, the batched simulator, the tensor and asset API
  env/     the vectorized env step with branch-free auto-reset, DR
  tasks/   the pingpong tasks
  rl/      PPO, checkpoints, play
Imports torch and numpy only: no JAX, no YAML, nothing of ``isaacgym_tpu``.
"""

__version__ = "0.1.0"

from isaacgym_tpu_torch.make import make  # noqa: F401
