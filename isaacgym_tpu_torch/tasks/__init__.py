"""Task registry of the port (``isaacgym_tpu/tasks/__init__.py``): every
single-humanoid task (C5, C6, C9, the flagship and its
``HumanoidPingpongTiltGaussFTG1`` alias, which the JAX package maps to the
flagship's class with its own config), C8, C10 and C11: the whole registry
of the JAX package."""

from __future__ import annotations

from typing import Dict


def task_registry() -> Dict[str, type]:
    from isaacgym_tpu_torch.tasks.humanoid_pingpong import HumanoidPingpong
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_27dof import (
        HumanoidPingpongTiltNESSparse27DOF,
    )
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_4actor_tilt import Humanoid12PingpongTilt
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_alignment import HumanoidPingpongAlignment
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_draft_5actor import HumanoidPingpong5Actor
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_tilt import HumanoidPingpongTilt
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_tilt_no_earlystop import (
        HumanoidPingpongTiltNoEarlyStop,
    )
    return {"HumanoidPingpongG1": HumanoidPingpong,
            "HumanoidPingpongTiltG1": HumanoidPingpongTilt,
            "HumanoidPingpongTiltNoEarlyStopG1": HumanoidPingpongTiltNoEarlyStop,
            "HumanoidPingpongTiltGaussFTG1": HumanoidPingpongTiltNoEarlyStop,
            "Humanoid12PingpongTiltG1": Humanoid12PingpongTilt,
            "HumanoidPingpongAlignmentG1": HumanoidPingpongAlignment,
            "HumanoidPingpongTiltNESSparse27DOFG1": HumanoidPingpongTiltNESSparse27DOF,
            "HumanoidPingpong5ActorG1": HumanoidPingpong5Actor}
