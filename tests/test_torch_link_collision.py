"""The port's link-vs-link narrowphase (``link_collision``) against the JAX
package's (``isaacgym_tpu/sim/simulator.py:1342-1527``).

- The four checks of ``tests/test_link_collision.py`` on the port: two
  pendulums' tips collide (momentum passes across articulations, equal and
  opposite tip forces), without the flag they pass through, two sibling arms
  of one articulation block each other (the shared factor), and C8's
  cross-humanoid pairs are pruned at build time.
- Each pair list equals the JAX ``Simulator._art_art_pairs`` on the same
  scene: the pendulums, the sibling arms, C8 and the flagship, each with
  ``linkCollision`` on.
- The pendulum strike: every step of a 30-step JAX rollout (B = 4, per-env
  launch velocities) taken once by the port from the JAX state: dof_vel
  within 1e-5 rad/s and the tips' net contact force within 1e-3 N (the
  strike peaks at about 370 N; 7e-7 and 6e-5 measured), on every step, so
  the strike step too.
- A link scene routes to the non-kernel step on both devices, and
  ``step_dr`` with an identity channel equals ``step`` on it.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.sim.simulator import SimState as JSimState
from isaacgym_tpu.sim.simulator import Simulator as JSimulator
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_build_scene
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
from tests import test_link_collision as JT
from isaacgym_tpu_torch.env.randomize import identity_params
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim.scene import compile_scene
from isaacgym_tpu_torch.sim.simulator import Simulator, route_for
from isaacgym_tpu_torch.tasks.pingpong_common import build_pingpong_scene
from isaacgym_tpu_torch.utils.config import load_task_config

C8 = "Humanoid12PingpongTiltG1"
FLAGSHIP = "HumanoidPingpongTiltNoEarlyStopG1"
TIP_A, TIP_B = 2, 5   # the pendulums' tip bodies (env-level rows)
STRIKE_TOL = dict(dof_vel=1e-5, ncf=1e-3)


def _jax_sibling_arms(link_collision=True):
    from isaacgym_tpu.models import kinematics as JK
    from isaacgym_tpu.models import urdf as JU
    from isaacgym_tpu.sim.scene import DRIVE_POS, ActorSpec, PlaneParams, SceneSpec
    robot = JK.compile_tree(JU.parse_urdf(JT.TWO_ARMS, from_string=True))
    return JSimulator(jax_compile_scene(SceneSpec(
        actors=[ActorSpec("bot", robot, pos=(0.0, 0.0, 1.5), fixed_base=True, restitution=0.2,
                          friction=0.3, drive_mode=DRIVE_POS, stiffness=np.zeros(2),
                          damping=np.zeros(2))],
        plane=PlaneParams(), dt=1 / 120, substeps=2, link_collision=link_collision)))


def _task_scenes(task, humanoids):
    """(port scene, JAX scene) of a task's config with ``linkCollision`` on."""
    cfg, jcfg = load_task_config(task), jax_load_task_config(task)
    for c in (cfg, jcfg):
        c["env"]["scene"]["linkCollision"] = True
    return (compile_scene(build_pingpong_scene(cfg["env"], cfg["sim"], humanoids=humanoids)),
            jax_compile_scene(jax_build_scene(jcfg["env"], jcfg["sim"], humanoids=humanoids)))


def _run(sim, state, tgt, steps):
    ncf = []
    for _ in range(steps):
        state = sim.step(state, tgt, torch.zeros_like(tgt))
        ncf.append(state.net_contact_force[0].clone())
    return state, torch.stack(ncf).numpy()


def _swing(link_collision):
    sim = Simulator(scripted.pendulum_scene(link_collision), device="cpu")
    state = sim.initial_state(1)
    state = state._replace(dof_vel=torch.tensor([[-4.0, 0.0]]))
    out, ncf = _run(sim, state, torch.zeros((1, 2)), 30)
    return sim, ncf, out


def test_the_scenes_are_the_jax_tests():
    assert scripted.PENDULUM_URDF == JT.PENDULUM
    assert scripted.TWO_ARMS_URDF == JT.TWO_ARMS


def test_cross_articulation_tips_collide():
    sim, ncf, out = _swing(True)
    assert len(sim._art_art_pairs) == 1
    assert float(out.dof_vel[0, 1].abs()) > 0.5
    assert float(out.dof_pos[0, 1].abs()) > 0.1
    mags = np.linalg.norm(ncf[:, TIP_A], axis=-1)
    hit = int(np.argmax(mags))
    assert mags[hit] > 10.0
    np.testing.assert_allclose(ncf[hit, TIP_A], -ncf[hit, TIP_B], rtol=1e-5)


def test_without_flag_tips_pass_through():
    sim, ncf, out = _swing(False)
    assert sim._art_art_pairs == []
    assert float(out.dof_vel[0, 1].abs()) < 1e-5
    assert float(np.abs(ncf[:, [TIP_A, TIP_B]]).max()) == 0.0


def test_sibling_arms_same_articulation_collide():
    sim = Simulator(scripted.sibling_arms_scene(), device="cpu")
    assert len(sim._art_art_pairs) >= 1
    state = sim.initial_state(1)
    state = state._replace(dof_vel=torch.tensor([[-3.0, 3.0]]))
    out, _ = _run(sim, state, torch.zeros((1, 2)), 60)
    q = out.dof_pos[0].numpy()
    xL, xR = -0.4 - np.sin(q[0]), 0.4 - np.sin(q[1])
    assert xL <= xR + 0.13, f"tips interpenetrated: xL={xL:.3f} xR={xR:.3f}"


def test_c8_cross_pairs_pruned_out_of_reach():
    scene, _ = _task_scenes(C8, 2)
    sim = Simulator(scene, device="cpu")
    assert scene.spec.link_collision
    assert [(a, b) for a, b in sim._art_art_pairs if a["art"] != b["art"]] == []


def _pair_key(pairs):
    keys = ("art", "link", "kind", "body", "e", "mu", "radius_bound")
    arrays = ("off_pos", "off_quat", "size", "body_off")
    out = []
    for a, b in pairs:
        for g in (a, b):
            out.append(tuple(g[k] for k in keys) + tuple(
                tuple(np.asarray(g[k], np.float32).tolist()) for k in arrays))
    return out


@pytest.mark.parametrize("scene", ["pendulums", "sibling_arms", "c8", "flagship"])
def test_pair_lists_equal_the_jax_package(scene):
    if scene == "pendulums":
        port, jax_sim = scripted.pendulum_scene(), JT._two_pendulums(True)
    elif scene == "sibling_arms":
        port, jax_sim = scripted.sibling_arms_scene(), _jax_sibling_arms()
    else:
        port, jscene = _task_scenes(C8 if scene == "c8" else FLAGSHIP, 2 if scene == "c8" else 1)
        jax_sim = JSimulator(jscene)
    ours = Simulator(port, device="cpu")._art_art_pairs
    assert len(ours) == len(jax_sim._art_art_pairs) > 0
    assert _pair_key(ours) == _pair_key(jax_sim._art_art_pairs)


def test_pendulum_strike_matches_the_jax_step():
    """Each step of a JAX rollout of the strike, taken once by the port from
    the JAX state (single-step parity): dof_vel and the tips' contact
    forces within ``STRIKE_TOL``; the strike is in the rollout."""
    B, steps = 4, 30
    jsim = JT._two_pendulums(True)
    sim = Simulator(scripted.pendulum_scene(), device="cpu")
    state, tgt = scripted.link_strike_state(sim, B, np.random.RandomState(3))
    js = JSimState(**{f: jnp.asarray(getattr(state, f).numpy()) for f in JSimState._fields})
    jt = jnp.asarray(tgt.numpy())
    peak, worst = 0.0, dict(dof_vel=0.0, ncf=0.0)
    jstep = jax.jit(jsim.step)
    for _ in range(steps):
        js2 = jstep(js, jt, jnp.zeros_like(jt))
        got = sim.step(type(state)(*[torch.as_tensor(np.array(getattr(js, f)))
                                     for f in JSimState._fields]), tgt, torch.zeros_like(tgt))
        want_v = np.asarray(js2.dof_vel)
        want_f = np.asarray(js2.net_contact_force)[:, [TIP_A, TIP_B]]
        worst["dof_vel"] = max(worst["dof_vel"], float(np.abs(got.dof_vel.numpy() - want_v).max()))
        worst["ncf"] = max(worst["ncf"], float(np.abs(
            got.net_contact_force[:, [TIP_A, TIP_B]].numpy() - want_f).max()))
        peak = max(peak, float(np.abs(want_f).max()))
        js = js2
    assert peak > 10.0, "no strike in the rollout"
    for f, tol in STRIKE_TOL.items():
        assert worst[f] <= tol, f"{f} deviates {worst[f]:.3e} > {tol}"


@pytest.mark.parametrize("make_scene", [scripted.pendulum_scene, scripted.sibling_arms_scene])
def test_link_scene_routes_nonkernel_and_dr_identity_equals_step(make_scene):
    scene = make_scene()
    assert route_for(scene, "cpu") == route_for(scene, "cuda") == "nonkernel"
    sim = Simulator(scene, device="cpu")
    state, tgt = scripted.link_strike_state(sim, 8, np.random.RandomState(5))
    for _ in range(40):   # up to the first step with a contact
        want = sim.step(state, tgt, torch.zeros_like(tgt))
        if float(want.net_contact_force.abs().max()) > 0.0:
            break
        state = want
    got = sim.step_dr(state, tgt, torch.zeros_like(tgt), identity_params(scene.num_dofs, 8))
    assert float(want.net_contact_force.abs().max()) > 0.0
    for f in want._fields:
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=1e-6)
