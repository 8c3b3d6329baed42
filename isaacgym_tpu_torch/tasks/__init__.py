"""Task registry of the port: the flagship only, so far (ROADMAP, module 5
queues the other single-humanoid tasks)."""

from __future__ import annotations

from typing import Dict


def task_registry() -> Dict[str, type]:
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_tilt_no_earlystop import (
        HumanoidPingpongTiltNoEarlyStop,
    )
    return {"HumanoidPingpongTiltNoEarlyStopG1": HumanoidPingpongTiltNoEarlyStop}
