"""The routing repair: ``route_for(scene, device_type)`` sends a scene whose
route's kernel cannot take it to the non-kernel step, so the port steps
every scene that the JAX package steps.

The JAX package's kernels take any DOF count, and its K3 articulations of
unequal DOF counts (``isaacgym_tpu/ops/pallas_dynamics.py:58-69``,
``:1515-1519``). The port's CUDA libraries are built for a few shapes (K1
and K2 at 7 DOFs, K3 at ``KERNEL_SHAPES``, K4 at 27), and its packs have
maxima, so on CUDA the JAX tests' 4-DOF floating biped and a 3-DOF
single-ball arm take the non-kernel step (decided here with "cuda" and no
card), while the flagship, C8 and C10 keep K2, K3 and K4. On every device a
fixed-base pair of unequal DOF counts takes it: the flagship's 7-DOF
humanoid beside a 3-DOF arm steps on the CPU and matches the JAX package's
``_step_vmapped`` at ``tests/test_torch_nonkernel.py``'s gates (the port
raised there before). The wrappers keep their own shape checks.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

from isaacgym_tpu.models import kinematics as JK
from isaacgym_tpu.models import urdf as JU
from isaacgym_tpu.sim.scene import ActorSpec as JActorSpec
from isaacgym_tpu.sim.scene import compile_scene as jax_compile_scene
from isaacgym_tpu.sim.simulator import SimState as JSimState
from isaacgym_tpu.sim.simulator import Simulator as JSimulator
from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene as jax_build_scene
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
from isaacgym_tpu_torch.models import kinematics as K
from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.ops import fused_substep_floating as FF
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim.scene import (DRIVE_POS, ActorSpec, PlaneParams, SceneSpec,
                                          compile_scene)
from isaacgym_tpu_torch.sim.simulator import Simulator, kernel_refusal, route_for
from isaacgym_tpu_torch.tasks.pingpong_common import build_pingpong_scene, rough_terrain_cfg
from isaacgym_tpu_torch.utils.config import load_task_config
from tests.test_torch_fused_substep_floating import _toy_spec
from tests.test_torch_nonkernel import GATE, _compare

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
C8 = "Humanoid12PingpongTiltG1"
C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
B = 32


def _scene(task, **kw):
    cfg = load_task_config(task)
    return compile_scene(build_pingpong_scene(cfg["env"], cfg["sim"], **kw))


def test_routes_by_device():
    """The same scene, on the CPU (every plain version takes any shape) and
    on CUDA (the libraries' shapes)."""
    biped = compile_scene(_toy_spec(U, K, ActorSpec, PlaneParams, SceneSpec, "toy", DRIVE_POS))
    arm = scripted.toy_arm_scene()
    cfg = rough_terrain_cfg(load_task_config(TASK), seed=0, size_m=(1.0, 1.0))
    terrain = compile_scene(build_pingpong_scene(cfg["env"], cfg["sim"]))
    routes = lambda scene: (route_for(scene, "cpu"), route_for(scene, "cuda"))
    assert routes(biped) == ("k4", "nonkernel")
    assert routes(arm) == ("k2", "nonkernel")
    assert routes(_scene(TASK)) == ("k2", "k2")
    assert routes(_scene(C8, humanoids=2)) == ("k3", "k3")
    assert routes(_scene(C10, floating_base=True)) == ("k4", "k4")
    assert routes(terrain) == ("k1", "k1")
    assert "not built for" in kernel_refusal(biped, "k4", "cuda")
    assert kernel_refusal(biped, "k4", "cpu") is None
    assert Simulator(biped, device="cpu").route == "k4"


def test_the_wrappers_keep_their_shape_checks():
    """A direct launch of K4 on the biped's pack still raises."""
    sim = Simulator(compile_scene(_toy_spec(U, K, ActorSpec, PlaneParams, SceneSpec, "toy",
                                            DRIVE_POS)), device="cpu")
    k = sim.fused_substep_floating
    with pytest.raises(NotImplementedError, match="built for 27 DOFs, scene has 4"):
        k.launch(torch.zeros(FF.n_in(4), 8))


def _unequal(pkg):
    """The flagship scene with a 3-DOF arm added after the humanoid: two
    fixed-base articulations of 7 and 3 DOFs and one ball, in the JAX
    package's classes (``pkg`` "jax") or the port's."""
    if pkg == "jax":
        cfg = jax_load_task_config(TASK)
        spec = jax_build_scene(cfg["env"], cfg["sim"])
        u, k, actor = JU, JK, JActorSpec
    else:
        cfg = load_task_config(TASK)
        spec = build_pingpong_scene(cfg["env"], cfg["sim"])
        u, k, actor = U, K, ActorSpec
    arm = k.compile_tree(u.parse_urdf(scripted.TOY_ARM_URDF, from_string=True))
    kp = np.full(3, 25.0, np.float32)
    spec.actors.insert(1, actor("arm", arm, pos=(0.6, -0.6, 1.0), fixed_base=True,
                                restitution=0.6, friction=0.5, stiffness=kp, damping=kp / 20))
    return (jax_compile_scene if pkg == "jax" else compile_scene)(spec)


def test_arms_of_unequal_dof_counts_step_and_match_the_jax_step():
    scene = _unequal("torch")
    assert [sl.model.tree.n_dof for sl in scene.articulations] == [7, 3]
    assert route_for(scene, "cpu") == route_for(scene, "cuda") == "nonkernel"
    assert "unequal DOF counts" in kernel_refusal(scene, "k3", "cpu")
    sim = Simulator(scene, device="cpu")
    js = JSimulator(_unequal("jax"))
    rng = np.random.RandomState(3)
    lo = np.concatenate([sl.model.tree.lower for sl in scene.articulations])
    hi = np.concatenate([sl.model.tree.upper for sl in scene.articulations])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    # the humanoid's paddle in front of an incoming ball, the arm anywhere
    env = type("E", (), {"scene": scene, "cfg": None})
    q7, qd7, tgt7, _, bp, bv, bw = scripted.k2_inputs(env, "paddle_ball", B, rng)
    state = sim.initial_state(B)
    root = state.root.clone()
    ba = scene.free_bodies[0].actor_index
    root[:, ba, 0:3], root[:, ba, 7:10], root[:, ba, 10:13] = f(bp), f(bv), f(bw)
    q = f(np.concatenate([q7, rng.uniform(lo[7:], hi[7:], (B, 3))], 1))
    qd = f(np.concatenate([qd7, rng.uniform(-3.0, 3.0, (B, 3))], 1))
    tgt = f(np.concatenate([tgt7, rng.uniform(lo[7:], hi[7:], (B, 3))], 1))
    eff = torch.zeros_like(tgt)
    state = state._replace(root=root, dof_pos=q, dof_vel=qd)
    got = sim.step(state, tgt, eff)
    jstate = JSimState(**{f_: jnp.asarray(getattr(state, f_).numpy())
                          for f_ in JSimState._fields})
    want = jax.jit(js._step_vmapped)(jstate, jnp.asarray(tgt.numpy()), jnp.asarray(eff.numpy()))
    _compare(got, want, GATE)
    assert float((got.net_contact_force.abs().sum((1, 2)) > 0).float().mean()) > 0.5
