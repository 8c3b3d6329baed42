"""The port's env step against the JAX package's, from the same states.

States come from a JAX rollout under uniform actions (numpy-seeded); each is
carried into the port with ``interop``, and both packages step once with the
same actions. Envs that reset in that step get the JAX side's launch
velocity injected into the port, because the two RNG streams differ. On the
CPU the JAX side runs its XLA path, the port its plain fused substep (the
Pallas formulation), so the gates are the flagship's Pallas-vs-XLA gates of
``tools/parity_tpu.py:57-59``, flip-aware in the same way: envs whose done
flag differs, or whose root differs by more than 0.1 (a contact that
activated on one side only), are flips and are excluded from the max
deviations; the flip rate is gated.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu_torch.interop import env_state_from_numpy, to_numpy

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
B = 64
GATE = dict(max_dof_pos=0.01, max_dof_vel=1.5, max_root=0.2, max_ncf=10.0,
            max_obs=0.2, max_reward=40.0, max_flip_rate=0.002)
SAMPLE_STEPS = (5, 15, 25, 35, 45, 55, 65, 75)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_env_state_numpy(s):
    return dict(sim=dict(s.sim._asdict()), progress=s.progress, flags=dict(s.flags),
                pre_ball_root=s.pre_ball_root, ep_return=s.ep_return)


@pytest.fixture(scope="module")
def pair():
    je = isaacgym_tpu.make(seed=0, task=TASK, num_envs=B)
    pe = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu")
    step = jax.jit(je.step_fn)
    rng = np.random.RandomState(7)
    state, _ = je.reset()
    samples = []
    for t in range(max(SAMPLE_STEPS) + 1):
        a = rng.uniform(-1, 1, (B, 7)).astype(np.float32)
        if t in SAMPLE_STEPS:
            s_np = _np(state)
            if t == SAMPLE_STEPS[-1]:
                # half the envs at the episode boundary: the step resets them
                s_np = s_np._replace(progress=np.where(
                    np.arange(B) % 2 == 0, je.max_episode_length - 2,
                    s_np.progress).astype(np.int32))
            out = _np(step(jax.tree.map(jnp.asarray, s_np), jnp.asarray(a)))
            samples.append((s_np, a, out))
        state, *_ = step(state, jnp.asarray(a))
    return je, pe, samples


def test_env_step_matches_within_the_flagship_gates(pair, monkeypatch):
    je, pe, samples = pair
    dev = {k: 0.0 for k in ("dof_pos", "dof_vel", "root", "ncf", "obs", "reward")}
    flips = compared = resets = 0
    for s_np, a, (sj, oj, rj, dj, ij) in samples:
        sp = env_state_from_numpy(_jax_env_state_numpy(s_np))
        launch = torch.tensor(np.asarray(sj.sim.root[:, 2, 7:10]))
        monkeypatch.setattr(pe, "sample_ball_velocity", lambda n: launch[:n].clone())
        sp2, op, rp, dp, ip = pe.step(sp, torch.as_tensor(a))
        keep = dp.numpy().astype(bool) == np.asarray(dj).astype(bool)
        resets += int(np.asarray(dj).sum())
        root_d = np.abs(sp2.sim.root.numpy() - sj.sim.root).reshape(B, -1).max(1)
        clean = keep & (root_d <= 0.1)
        flips += int((~clean).sum())
        compared += B
        pairs = dict(dof_pos=(sp2.sim.dof_pos, sj.sim.dof_pos),
                     dof_vel=(sp2.sim.dof_vel, sj.sim.dof_vel),
                     root=(sp2.sim.root, sj.sim.root),
                     ncf=(sp2.sim.net_contact_force, sj.sim.net_contact_force),
                     obs=(op, oj), reward=(rp, rj))
        for k, (x, y) in pairs.items():
            d = np.abs(x.numpy() - np.asarray(y)).reshape(B, -1).max(1)
            dev[k] = max(dev[k], float(d[clean].max()))
        for k in sj.flags:
            np.testing.assert_array_equal(sp2.flags[k].numpy()[clean],
                                          np.asarray(sj.flags[k])[clean])
        np.testing.assert_array_equal(sp2.progress.numpy()[clean],
                                      np.asarray(sj.progress)[clean])
        for k in ("episode_done", "time_outs", "episode_length"):
            np.testing.assert_array_equal(ip[k].numpy()[clean], np.asarray(ij[k])[clean])
    assert resets >= B // 2 - 1
    for k, v in dev.items():
        assert v <= GATE[f"max_{k}"], f"{k}: {v:.3e} > {GATE[f'max_{k}']}"
    assert flips / compared <= GATE["max_flip_rate"], (flips, compared)


def test_reset_ball_velocity_follows_the_config_ranges():
    pe = isaacgym_tpu_torch.make(seed=1, task=TASK, num_envs=4096, device="cpu")
    state, obs = pe.reset()
    v = state.sim.root[:, 2, 7:10].numpy().astype(np.float64)
    ball = pe.cfg["env"]["ball"]
    speed = np.linalg.norm(v, axis=1)
    tilt = np.degrees(np.arctan2(v[:, 1], -v[:, 0]))
    tilt_z = np.degrees(np.arcsin(v[:, 2] / speed))
    for x, (lo, hi) in ((speed, ball["initialSpeedRange"]), (tilt, ball["tiltAngleRange"]),
                        (tilt_z, ball["tiltZAngleRange"])):
        width = hi - lo
        assert lo - 1e-4 <= x.min() and x.max() <= hi + 1e-4
        # uniform: mean at the centre, sd width/sqrt(12) (4096 draws: 5 sigma)
        assert abs(x.mean() - 0.5 * (lo + hi)) < 5 * width / np.sqrt(12 * 4096)
        assert abs(x.std() - width / np.sqrt(12)) < 0.05 * width
    np.testing.assert_array_equal(state.sim.root[:, :2].numpy(),
                                  np.broadcast_to(pe.scene.initial_root[:2], (4096, 2, 13)))
    assert obs.shape == (4096, 80) and torch.isfinite(obs).all()


def test_interop_round_trip(pair):
    _, _, samples = pair
    s_np = samples[0][0]
    d = _jax_env_state_numpy(s_np)
    back = to_numpy(env_state_from_numpy(d))
    for k, v in d["sim"].items():
        np.testing.assert_array_equal(back["sim"][k], v)
    for k in ("progress", "pre_ball_root", "ep_return"):
        np.testing.assert_array_equal(back[k], d[k])
    for k, v in d["flags"].items():
        np.testing.assert_array_equal(back["flags"][k], v)
