from isaacgym_tpu_torch.sensors.camera import Camera  # noqa: F401
