"""Task registry of the port: the flagship, C6 and C8 so far (ROADMAP,
module 1 queues the other single-humanoid tasks)."""

from __future__ import annotations

from typing import Dict


def task_registry() -> Dict[str, type]:
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_4actor_tilt import Humanoid12PingpongTilt
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_tilt import HumanoidPingpongTilt
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_tilt_no_earlystop import (
        HumanoidPingpongTiltNoEarlyStop,
    )
    return {"HumanoidPingpongTiltG1": HumanoidPingpongTilt,
            "HumanoidPingpongTiltNoEarlyStopG1": HumanoidPingpongTiltNoEarlyStop,
            "Humanoid12PingpongTiltG1": Humanoid12PingpongTilt}
