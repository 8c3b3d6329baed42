"""The port's scene constants against the JAX package's: resolved config,
compiled asset trees, the compiled scene, the kernel's geom lists and
constant pack, rotations and batched body-state FK.

The constants are the same numbers computed by copies of the same numpy
code, so the bar is array equality, or 1e-7 where float32 rounding of a
repeated computation may differ in the last place.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu.ops import pallas_dynamics as PDK
from isaacgym_tpu.tasks.pingpong_common import load_tree as jax_load_tree
from isaacgym_tpu.utils import rotations as jrot
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
from isaacgym_tpu_torch.ops import fused_substep as F
from isaacgym_tpu_torch.tasks.pingpong_common import load_tree
from isaacgym_tpu_torch.utils import rotations as trot
from isaacgym_tpu_torch.utils.config import load_task_config

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
URDFS = ("g1_29dof_rev_1_0_pingpong_fixed_except_right_arm.urdf",
         "pingpong_table.urdf", "small_ball.urdf")


@pytest.fixture(scope="module")
def envs():
    """(JAX env, port env, the arguments JAX's simulator passes to
    ``build_fused_substep``)."""
    je = isaacgym_tpu.make(seed=0, task=TASK, num_envs=16)
    captured = {}
    real = PDK.build_fused_substep

    def capture(*args, **kwargs):
        if not kwargs.get("with_dr"):
            captured["args"], captured["kwargs"] = args, kwargs
        return real(*args, **kwargs)

    PDK.build_fused_substep = capture
    try:
        je.sim._maybe_build_pallas(force=True)
    finally:
        PDK.build_fused_substep = real
    pe = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=16, device="cpu")
    return je, pe, captured


def test_resolved_config_equals_the_yaml_loader():
    assert load_task_config(TASK) == jax_load_task_config(TASK)


@pytest.mark.parametrize("urdf", URDFS)
def test_compiled_tree_equals(urdf):
    a, b = jax_load_tree(urdf), load_tree(urdf)
    assert a.body_names == b.body_names and a.dof_names == b.dof_names
    for field in a.__dataclass_fields__:
        va, vb = getattr(a, field), getattr(b, field)
        if isinstance(va, np.ndarray):
            np.testing.assert_allclose(vb, va, rtol=0, atol=1e-7, err_msg=field)
        else:
            assert va == vb, field


def test_compiled_scene_equals(envs):
    je, pe, _ = envs
    a, b = je.scene, pe.scene
    np.testing.assert_array_equal(b.initial_root, a.initial_root)
    assert (a.num_actors, a.num_dofs, a.num_bodies) == (b.num_actors, b.num_dofs, b.num_bodies)
    assert a.body_names == b.body_names and a.dof_names == b.dof_names
    assert len(a.static_geoms) == len(b.static_geoms)
    assert len(a.art_geoms) == len(b.art_geoms)
    for ga, gb in zip(a.static_geoms + a.art_geoms, b.static_geoms + b.art_geoms):
        for f in ga.__dataclass_fields__:
            np.testing.assert_array_equal(np.asarray(getattr(gb, f)),
                                          np.asarray(getattr(ga, f)), err_msg=f)
    import dataclasses
    assert [dataclasses.asdict(x) for x in a.free_bodies] == \
        [dataclasses.asdict(x) for x in b.free_bodies]
    ma, mb = a.articulations[0].model, b.articulations[0].model
    for f in ("ancestor_mask", "link_mass", "link_com", "link_inertia_com", "armature",
              "is_revolute"):
        np.testing.assert_array_equal(getattr(mb, f), getattr(ma, f), err_msg=f)
    sa, sb = a.articulations[0], b.articulations[0]
    np.testing.assert_array_equal(sb.stiffness, sa.stiffness)
    np.testing.assert_array_equal(sb.damping, sa.damping)


def test_fused_geom_lists_equal_the_pallas_build_arguments(envs):
    je, pe, cap = envs
    args, kw = cap["args"], cap["kwargs"]
    from isaacgym_tpu_torch.sim.simulator import fused_ball_cfg, fused_geom_lists
    static, n_true, art, art_bodies = fused_geom_lists(pe.scene)
    j_static, j_art = args[8], args[9]
    assert n_true == kw["n_true_static"]
    assert len(static) == len(j_static) and len(art) == len(j_art)
    # the JAX package drops each art geom's ``art`` index before its
    # single-humanoid build (simulator.py:495-497); here it is kept, and is 0
    assert all(g["art"] == 0 for g in art)
    for mine, theirs in zip(static + [{k: v for k, v in g.items() if k != "art"} for g in art],
                            j_static + j_art):
        assert set(mine) == set(theirs)
        for k in mine:
            np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(theirs[k]), err_msg=k)
    np.testing.assert_array_equal(art_bodies, je.sim._fused_art_bodies)
    assert fused_ball_cfg(pe.scene) == args[7]


def test_constant_pack_equals_one_built_from_the_jax_arguments(envs):
    _, pe, cap = envs
    args, kw = cap["args"], cap["kwargs"]
    assert kw["exact_support"] is True and kw["with_torque"] is False
    j_art = args[9]   # with each geom's body origin, which the pack carries
    pack = F.build_constants(
        args[0], args[1], args[2], args[3], args[4], args[5], args[6], args[7],
        args[8], j_art, bounce_threshold=kw["bounce_threshold"],
        n_true_static=kw["n_true_static"], max_depenetration=kw["max_depenetration"],
        exact_support=kw["exact_support"])
    np.testing.assert_array_equal(pe.sim.constants, pack)
    # the Pallas kernel's own reach pruning keeps the same pairs
    lay = F.layout(7)
    pairs = [(int(pe.sim.constants[lay["pair"] + 8 * i]),
              int(pe.sim.constants[lay["pair"] + 8 * i + 1]))
             for i in range(int(pe.sim.constants[F.C_NPAIR]))]
    want = [(gi, si) for gi, g in enumerate(args[9])
            for si, sg in enumerate(args[8][:kw["n_true_static"]])
            if not PDK._static_pair_unreachable(args[0], args[1], g, sg)]
    assert pairs == want and len(pairs) == 2


ROT_FNS = ("quat_mul", "quat_rotate", "quat_rotate_inverse", "quat_conjugate",
           "calc_heading_quat_inv", "get_euler_xyz", "quat_from_angle_axis")


@pytest.mark.parametrize("name", ROT_FNS)
def test_rotations_match(name):
    rng = np.random.RandomState(3)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.normal(size=(64, 4)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, 64).astype(np.float32)
    argsets = {"quat_mul": (q, q2), "quat_rotate": (q, v), "quat_rotate_inverse": (q, v),
               "quat_conjugate": (q,), "calc_heading_quat_inv": (q,),
               "get_euler_xyz": (q,), "quat_from_angle_axis": (ang, v)}
    a = getattr(jrot, name)(*[jnp.asarray(x) for x in argsets[name]])
    b = getattr(trot, name)(*[torch.as_tensor(x) for x in argsets[name]])
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        # float32 transcendentals differ in the last places between XLA and torch
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0, atol=2e-6)


def test_body_states_match(envs):
    je, pe, _ = envs
    rng = np.random.RandomState(5)
    tree = pe.scene.articulations[0].model.tree
    B = 16
    sj = je.sim.initial_state(B)
    q = rng.uniform(tree.lower, tree.upper, (B, 7)).astype(np.float32)
    qd = rng.uniform(-3, 3, (B, 7)).astype(np.float32)
    sj = sj._replace(dof_pos=jnp.asarray(q), dof_vel=jnp.asarray(qd))
    from isaacgym_tpu_torch.interop import sim_state_from_numpy, to_numpy
    sp = sim_state_from_numpy({f: np.asarray(getattr(sj, f)) for f in sj._fields})
    ids = pe.body_states_id
    a = np.asarray(je.sim.make_body_state_fn(ids)(sj))
    b = pe.sim.make_body_state_fn(ids)(sp).numpy()
    # float32 FK through 7 joints: sin/cos and accumulation-order rounding
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-5)
    assert to_numpy(sp)["dof_pos"].tolist() == q.tolist()
