"""The port held to the JAX package on the JAX package's own outputs,
carried across as numpy files: the env step at the parity gates' widths
(:mod:`.env_step`) and the paired KL run from the JAX launcher's draws
(:mod:`.kl_pair`). ``data/`` holds a small committed fixture per task."""


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them ("" where
    it cannot be run)."""
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
