"""Heightfield terrain in the port (``models/terrain.py``, the terrain ground
of the contact phase, the heightmap observation block) against the JAX
package's, on the CPU.

* ``Heightfield.sample`` and ``normal`` on the same seeded field, at random
  points, at cell corners and past the field's edges (where both clamp to
  the last cell), and the trimesh conversion: the same float32 formulas,
  measured equal to 6e-8 m and 1.2e-7; gate 1e-6.
* The heightmap block (225 points) from the same body states: measured
  1.2e-7 m; gate 1e-6.
* The flagship on the seeded rough field with the heightmap block (obs 305,
  act 7), 16 envs: states from a JAX rollout under uniform actions
  (numpy-seeded) at 8 steps, the ball bouncing on the terrain floor behind
  the humanoid in the later ones (steps 145-160), the last with half the
  envs at the episode boundary; both packages step each once with the same
  actions, the JAX side's launch velocity injected where an env resets. The
  JAX side runs its XLA path, the port K1's plain version and its torch
  contact phase. Measured over the 128 env-steps: dof_pos 2.4e-7, dof_vel
  2.7e-5, root 3.0e-5, contact force 3.6e-6 N, obs 1.1e-5, reward 2.9e-6,
  no flip, 2 floor contacts. Gates 1e-5, 1e-3, 1e-3, 1e-4 N, 5e-4, 1e-4
  (28-45 times the readings), at most one flip (done differing, or a root
  more than 0.1 apart). The terrain contact over the whole field and past
  its edges is held at 64 envs in ``tests/test_torch_nonkernel.py``.
* The heightmap's flat-world branch (no terrain): the block is the height
  offset minus the root height, as the JAX package's; the flagship with it
  still takes K2.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu.models import terrain as JT
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
from isaacgym_tpu_torch.interop import env_state_from_numpy, heightfield_from_jax
from isaacgym_tpu_torch.models import terrain as PT
from isaacgym_tpu_torch.tasks.pingpong_common import rough_terrain_cfg
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_torch_c8 import _jax_env_state_numpy, _np

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
B = 16
SAMPLE_STEPS = (30, 60, 100, 145, 149, 152, 155, 160)
GATE = dict(dof_pos=1e-5, dof_vel=1e-3, root=1e-3, ncf=1e-4, obs=5e-4, reward=1e-4)
MAX_FLIPS = 1
FIELD_TOL = 1e-6


def _jax_field(raw, cfg_plane):
    return JT.Heightfield.from_raw(raw.T, horizontal_scale=cfg_plane["horizontal_scale"],
                                   vertical_scale=0.75, transform_x=cfg_plane["transform_x"],
                                   transform_y=cfg_plane["transform_y"])


@pytest.fixture(scope="module")
def field():
    cfg = rough_terrain_cfg(load_task_config(TASK), seed=5, size_m=(3.0, 2.0))
    plane = cfg["env"]["plane"]
    jf = _jax_field(plane["terrain"], plane)
    return jf, heightfield_from_jax(jf)


def _points(jf, n, rng):
    R, C = jf.heights.shape
    lo, hi = jf.origin, jf.origin + np.asarray([R - 1, C - 1]) * jf.scale
    pts = rng.uniform(lo - 0.3, hi + 0.3, (n, 2))
    corners = jf.origin + rng.randint(0, [R, C], (n // 4, 2)) * jf.scale   # grid nodes
    return np.concatenate([pts, corners]).astype(np.float32)


def test_heightfield_sample_and_normal_match_the_jax_package(field):
    jf, pf = field
    xy = _points(jf, 4000, np.random.RandomState(0))
    np.testing.assert_allclose(pf.sample(torch.as_tensor(xy)).numpy(),
                               np.asarray(jf.sample(jnp.asarray(xy))), rtol=0, atol=FIELD_TOL)
    np.testing.assert_allclose(pf.normal(torch.as_tensor(xy)).numpy(),
                               np.asarray(jf.normal(jnp.asarray(xy))), rtol=0, atol=FIELD_TOL)
    raw = np.random.RandomState(1).randint(-20, 20, (9, 7)).astype(np.float32)
    for slope in (None, 0.5):
        for a, b in zip(PT.convert_heightfield_to_trimesh(raw, 0.1, 0.005, slope),
                        JT.convert_heightfield_to_trimesh(raw, 0.1, 0.005, slope)):
            np.testing.assert_array_equal(a, b)


def test_heightmap_block_matches_the_jax_package(field):
    jf, pf = field
    rng = np.random.RandomState(2)
    n = 64
    bs = np.zeros((n, 3, 13), np.float32)
    bs[:, 0, 0:2] = _points(jf, n, rng)[:n]
    bs[:, 0, 2] = rng.uniform(0.5, 1.2, n)
    q = rng.normal(size=(n, 4))
    bs[:, 0, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    grid = JT.make_meshgrid()
    want = np.asarray(jax.vmap(lambda s: JT.compute_heightmap_observations(
        s, None, grid, jf, height_offset=0.9))(jnp.asarray(bs)))
    got = PT.compute_heightmap_observations(torch.as_tensor(bs), PT.make_meshgrid(), pf, 0.9)
    assert got.shape == (n, 225)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FIELD_TOL)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = rough_terrain_cfg(load_task_config(TASK), seed=0)
    npy = tmp_path_factory.mktemp("terrain") / "height_map.npy"
    np.save(npy, cfg["env"]["plane"]["terrain"])
    cfg["env"]["plane"]["terrain"] = str(npy)       # both packages load the same file
    jcfg = jax_load_task_config(TASK)
    jcfg["env"]["plane"] = dict(cfg["env"]["plane"])
    jcfg["env"]["heightmap"] = {"enabled": True}
    je = isaacgym_tpu.make(seed=0, task=TASK, num_envs=B, cfg=jcfg)
    pe = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu", cfg=cfg)
    assert je.num_obs == pe.num_obs == 305 and pe.sim.route == "k1"
    step = jax.jit(je.step_fn)
    rng = np.random.RandomState(11)
    state, _ = je.reset()
    samples = []
    for t in range(max(SAMPLE_STEPS) + 1):
        a = rng.uniform(-1, 1, (B, 7)).astype(np.float32)
        if t in SAMPLE_STEPS:
            s_np = _np(state)
            if t == SAMPLE_STEPS[-1]:
                s_np = s_np._replace(progress=np.where(
                    np.arange(B) % 2 == 0, je.max_episode_length - 2,
                    s_np.progress).astype(np.int32))
            out = _np(step(jax.tree.map(jnp.asarray, s_np), jnp.asarray(a)))
            samples.append((s_np, a, out))
        state, *_ = step(state, jnp.asarray(a))
    return je, pe, samples


def test_terrain_env_step_matches_the_jax_env_step(pair, monkeypatch):
    je, pe, samples = pair
    dev = {k: 0.0 for k in GATE}
    flips = floor_contacts = resets = 0
    for s_np, a, (sj, oj, rj, dj, ij) in samples:
        sp = env_state_from_numpy(_jax_env_state_numpy(s_np))
        launch = torch.tensor(np.asarray(sj.sim.root[:, 2, 7:10]))
        monkeypatch.setattr(pe, "sample_ball_velocity", lambda n: launch[:n].clone())
        sp2, op, rp, dp, ip = pe.step(sp, torch.as_tensor(a))
        resets += int(np.asarray(dj).sum())
        keep = dp.numpy().astype(bool) == np.asarray(dj).astype(bool)
        clean = keep & (np.abs(sp2.sim.root.numpy() - sj.sim.root).reshape(B, -1).max(1) <= 0.1)
        flips += int((~clean).sum())
        # the ball touching the terrain floor (below the table, its contact force set)
        z = np.asarray(s_np.sim.root[:, 2, 2])
        floor_contacts += int(((z < 0.3) & (np.abs(np.asarray(sj.sim.net_contact_force[:, 41]))
                                            .sum(1) > 0)).sum())
        pairs = dict(dof_pos=(sp2.sim.dof_pos, sj.sim.dof_pos),
                     dof_vel=(sp2.sim.dof_vel, sj.sim.dof_vel),
                     root=(sp2.sim.root, sj.sim.root),
                     ncf=(sp2.sim.net_contact_force, sj.sim.net_contact_force),
                     obs=(op, oj), reward=(rp, rj))
        for k, (x, y) in pairs.items():
            d = np.abs(x.numpy() - np.asarray(y)).reshape(B, -1).max(1)
            if clean.any():
                dev[k] = max(dev[k], float(d[clean].max()))
        for k in sj.flags:
            np.testing.assert_array_equal(sp2.flags[k].numpy()[clean],
                                          np.asarray(sj.flags[k])[clean])
    assert floor_contacts > 0 and resets >= B // 2 - 1
    assert flips <= MAX_FLIPS, flips
    for k, v in dev.items():
        assert v <= GATE[k], f"{k}: {v:.3e} > {GATE[k]}"


def test_flat_world_heightmap_branch_matches_the_jax_package():
    jcfg = jax_load_task_config(TASK)
    jcfg["env"]["heightmap"] = {"enabled": True}
    pcfg = load_task_config(TASK)
    pcfg["env"]["heightmap"] = {"enabled": True}
    je = isaacgym_tpu.make(seed=0, task=TASK, num_envs=4, cfg=jcfg)
    pe = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=4, device="cpu", cfg=pcfg)
    assert pe.num_obs == je.num_obs == 305 and pe.sim.route == "k2"
    _, oj = je.reset()
    _, op = pe.reset()
    np.testing.assert_allclose(op[:, 80:].numpy(), np.asarray(oj)[:, 80:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(op[:, 80:].numpy(), 0.9 - pe.scene.initial_root[0, 2],
                               rtol=0, atol=1e-6)


def test_a_missing_terrain_file_raises(tmp_path):
    cfg = load_task_config(TASK)
    cfg["env"]["plane"]["terrain"] = str(tmp_path / "absent.npy")
    with pytest.raises(FileNotFoundError):
        isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=2, device="cpu", cfg=cfg)
