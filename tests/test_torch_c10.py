"""C10 (HumanoidPingpongTiltNESSparse27DOFG1: the whole-body 27-DOF G1 on a
floating base, K4): the port's env step against the JAX package's, its
scene constants, the standing humanoid, the scripted table reward, a JAX
policy carried across, the launcher on the CPU and the refusals.

Env step: states come from a JAX rollout under uniform actions
(numpy-seeded) at 16 envs, 8 states each, the last with half the envs at
the episode boundary; the port steps each once with the same actions and,
for envs that reset, the JAX side's launch velocity and ball start y, z.
On the CPU the JAX side runs its XLA path and the port its plain K4; the
two differ only in float32 summation order. Measured over the 128
env-steps: dof_pos 1.3e-6, dof_vel 7.6e-4, root 4.2e-4, ncf 0.030 N, obs
5.0e-4, reward 2.1e-4, no flip. The gates sit 13-80 times above those
readings, far inside the C10 row of ``tools/parity_tpu.py:79-81`` (which
is set for TPU against CPU). An env whose done flag differs or whose root
moves more than 0.1 apart (a contact that acts on one side only) is a
flip: it is counted, at most one of the 128, and its fields are left out.
The obs lane of the predicted y-intercept (lane 120), the reference's
unclamped ``y + vy / (-vx + 1e-6) x``, amplifies last-place velocity noise
without bound near vx ~ 0, so it alone is left out of the obs comparison
(ROADMAP §3).

Scene constants are copies of the same numpy code, so the bar is array
equality, or 1e-7 (tree) and 2e-5 (float32 FK through 27 joints) where
float32 rounding of a repeated computation may differ in the last place.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu.ops import dynamics as JD
from isaacgym_tpu.ops import pallas_dynamics as PDK
from isaacgym_tpu.rl.networks import ActorCritic as JActorCritic
from isaacgym_tpu.tasks.pingpong_common import load_tree as jax_load_tree
from isaacgym_tpu.utils.config import compose as jax_compose
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
from isaacgym_tpu_torch.interop import (actor_critic_from_jax, env_state_from_numpy,
                                        sim_state_from_numpy)
from isaacgym_tpu_torch.ops import dynamics as D
from isaacgym_tpu_torch.ops import fused_substep_floating as FF
from isaacgym_tpu_torch.rl.networks import ActorCritic
from isaacgym_tpu_torch.sim.simulator import floating_geom_lists, fused_ball_cfg
from isaacgym_tpu_torch.tasks.pingpong_common import load_tree
from isaacgym_tpu_torch.utils.config import load_task_config, load_train_config
from tests.test_torch_c8 import _jax_env_state_numpy, _np

C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
URDF = "g1_27dof_pingpong.urdf"
B = 16
SAMPLE_STEPS = (5, 15, 25, 35, 45, 55, 65, 75)
GATE = dict(max_dof_pos=1e-4, max_dof_vel=1e-2, max_root=1e-2, max_ncf=1.0,
            max_obs=1e-2, max_reward=1e-2, max_flips=1)
Y_INTERCEPT_LANE = 114 + 6


@pytest.fixture(scope="module")
def pair():
    """(JAX env, port env on the CPU, [(state, actions, JAX step output)]
    at the sample steps), all numpy."""
    je = isaacgym_tpu.make(seed=0, task=C10, num_envs=B)
    pe = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=B, device="cpu")
    step = jax.jit(je.step_fn)
    rng = np.random.RandomState(11)
    state, _ = je.reset()
    samples = []
    for t in range(max(SAMPLE_STEPS) + 1):
        a = rng.uniform(-1, 1, (B, 27)).astype(np.float32)
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


def test_env_step_matches_within_the_c10_parity_gates(pair, monkeypatch):
    je, pe, samples = pair
    ba = pe.ball_actor
    assert ba == je.ball_actor == 2 and pe.num_obs == je.num_obs == 313
    lanes = np.arange(313) != Y_INTERCEPT_LANE
    dev = {k: 0.0 for k in ("dof_pos", "dof_vel", "root", "ncf", "obs", "reward")}
    flips = compared = resets = 0
    for s_np, a, (sj, oj, rj, dj, ij) in samples:
        sp = env_state_from_numpy(_jax_env_state_numpy(s_np))
        launch = torch.tensor(np.asarray(sj.sim.root[:, ba, 7:10]))
        start = torch.tensor(np.asarray(sj.sim.root[:, ba, 1:3]))
        monkeypatch.setattr(pe, "sample_ball_velocity", lambda n: launch[:n].clone())
        monkeypatch.setattr(pe, "sample_ball_start", lambda n: start[:n].clone())
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
                     obs=(op[:, lanes], np.asarray(oj)[:, lanes]), reward=(rp, rj))
        for k, (x, y) in pairs.items():
            d = np.abs(x.numpy() - np.asarray(y)).reshape(B, -1).max(1)
            if clean.any():
                dev[k] = max(dev[k], float(d[clean].max()))
        assert set(sp2.flags) == set(sj.flags)
        for k in sj.flags:
            np.testing.assert_array_equal(sp2.flags[k].numpy()[clean],
                                          np.asarray(sj.flags[k])[clean], err_msg=k)
        np.testing.assert_array_equal(sp2.progress.numpy()[clean],
                                      np.asarray(sj.progress)[clean])
        for k in ("episode_done", "time_outs", "episode_length"):
            np.testing.assert_array_equal(ip[k].numpy()[clean], np.asarray(ij[k])[clean])
        assert set(ip["episode_events"]) == set(ij["episode_events"])
    assert resets >= B // 2 - 1
    for k, v in dev.items():
        assert v <= GATE[f"max_{k}"], f"C10: {k}: {v:.3e} > {GATE[f'max_{k}']}"
    assert flips <= GATE["max_flips"], (flips, compared)


@pytest.mark.slow
def test_random_action_ragdolls_are_the_jax_packages():
    """Random actions topple C10's humanoids and Baumgarte contacts throw the
    ragdolls: both packages at 16 envs, from reset, with the same uniform
    actions (numpy-seeded) for 306 steps, the second episode from step 160.
    At the last step at least 90 % of the humanoids have latched the fall on
    each side, and on each side some pelvis was thrown above 2 m (standing it
    sits at 0.82 m). Prints the fallen share and mean pelvis height at the
    last step and the highest pelvis of the run, per package. Slow: about 8
    minutes on the CPU, most of it the plain K4."""
    n, steps = 16, 306
    je = isaacgym_tpu.make(seed=0, task=C10, num_envs=n)
    pe = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=n, device="cpu")
    step = jax.jit(je.step_fn)
    acts = np.random.RandomState(0).uniform(-1, 1, (steps, n, 27)).astype(np.float32)
    sj, _ = je.reset()
    sp, _ = pe.reset()
    top = {"jax": 0.0, "port": 0.0}
    for a in acts:
        sj, *_ = step(sj, jnp.asarray(a))
        sp, *_ = pe.step(sp, torch.as_tensor(a))
        top["jax"] = max(top["jax"], float(np.asarray(sj.sim.root[:, 0, 2]).max()))
        top["port"] = max(top["port"], float(sp.sim.root[:, 0, 2].max()))
    last = {"jax": (np.asarray(sj.flags["humanoid_die_calculated"]).mean(),
                    float(np.asarray(sj.sim.root[:, 0, 2]).mean())),
            "port": (sp.flags["humanoid_die_calculated"].float().mean().item(),
                     float(sp.sim.root[:, 0, 2].mean()))}
    for k in ("jax", "port"):
        print(f"C10 ragdolls, {k}: step {steps - 1}: fallen share {last[k][0]}, "
              f"mean pelvis z {last[k][1]} m; highest pelvis z {top[k]} m")
        assert last[k][0] >= 0.9 and top[k] > 2.0, (k, last[k], top[k])


def test_neutral_pose_keeps_the_humanoid_standing():
    """``tests/test_task_family.py:102-129``: neutral-pose actions keep the
    pelvis in (0.7, 1.0) m over 20 steps, no fall is latched, the ``*_count``
    flags surface as episode events, and the ball starts within C10's y, z
    ranges."""
    env = isaacgym_tpu_torch.make(seed=6, task=C10, num_envs=2, device="cpu",
                                  episodeLength=24)
    assert env.num_obs == 313 and env.num_actions == 27
    assert env.scene.num_dofs == 27 and env.scene.articulations[0].model.floating
    state, obs = env.reset()
    assert obs.shape == (2, 313)
    a0 = (-env._pd_action_offset / env._pd_action_scale).expand(2, -1)
    for _ in range(20):
        state, obs, rew, done, info = env.step(state, a0)
    pelvis_z = float(state.sim.root[0, 0, 2])
    assert 0.7 < pelvis_z < 1.0, pelvis_z
    assert bool(torch.isfinite(obs).all()) and not bool(state.flags["fall_down_count"].any())
    assert set(info["episode_events"]) == {"hit_paddle", "closer_to_paddle", "hit_table",
                                           "fall_down", "cross_net"}
    assert all(v.shape == (2,) for v in info["episode_events"].values())
    ball0 = env.reset()[0].sim.root[:, 2].numpy()
    assert np.all(ball0[:, 1] > -0.55) and np.all(ball0[:, 1] < 0.15)
    assert np.all(ball0[:, 2] > 0.95) and np.all(ball0[:, 2] < 1.06)


def test_gradient_table_reward_scripted():
    """``tests/test_task_family.py:132-160``: the ball crossing z in
    [0.82, 0.83] with vx > 0 inside x in [1.9, 3.1], |y| < 0.6 earns
    +hitTableReward once; outside the square a distance-proportional
    penalty."""
    env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=2, device="cpu",
                                  episodeLength=50)
    state, _ = env.reset()

    def rewards_at(ball_pos, ball_vel, flags):
        root = state.sim.root.clone()
        root[:, 2, 0:3] = torch.tensor(ball_pos)
        root[:, 2, 7:10] = torch.tensor(ball_vel)
        sim1 = state.sim._replace(root=root)
        return env.reward(root[:, 2], sim1, env._rb_fn(sim1), flags, state.progress + 1)

    r_in, _, f_in = rewards_at([2.5, 0.0, 0.825], [2.0, 0.0, -1.0], state.flags)
    r_out, _, _ = rewards_at([2.5, 1.5, 0.825], [2.0, 0.0, -1.0], state.flags)
    assert float(r_in[0]) - float(r_out[0]) > 2000.0
    assert bool(f_in["hit_table_calculated"][0])
    r_again, _, _ = rewards_at([2.5, 0.0, 0.825], [2.0, 0.0, -1.0], f_in)
    assert float(r_in[0]) - float(r_again[0]) > 2000.0


def test_jax_c10_policy_carried_across_gives_the_same_mu():
    obs_dim, act_dim, units = 313, 27, (64, 32)
    jnet = JActorCritic(num_actions=act_dim, units=units, compute_dtype=jnp.float32)
    params = jnet.init(jax.random.PRNGKey(4), jnp.zeros((1, obs_dim)))
    obs = np.random.RandomState(6).standard_normal((32, obs_dim)).astype(np.float32)
    mu_j, ls_j, v_j = jnet.apply(params, jnp.asarray(obs))
    net = ActorCritic(obs_dim, act_dim, units=units, compute_dtype=torch.float32)
    net.load_state_dict(actor_critic_from_jax(_np(params)))
    with torch.no_grad():
        mu, ls, v = net(torch.as_tensor(obs))
    assert mu.shape == (32, act_dim)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ls.detach().numpy(), np.asarray(ls_j))


def test_resolved_configs_equal_the_yaml_loader():
    assert load_task_config(C10) == jax_load_task_config(C10)
    train = load_train_config(C10)
    assert train == jax_compose(C10)["train"]
    cfg = train["params"]["config"]
    assert load_task_config(C10)["env"]["numEnvs"] == 2048
    assert (cfg["horizon_length"], cfg["minibatch_size"], cfg["mini_epochs"],
            float(cfg["learning_rate"])) == (32, 4096, 5, 2e-5)
    assert train["params"]["network"]["mlp"]["units"] == [2048, 1536, 1024, 1024, 512, 512]


def test_floating_tree_equals():
    a, b = jax_load_tree(URDF, floating_base=True), load_tree(URDF, floating_base=True)
    assert b.floating_base and b.n_dof == 27
    assert a.body_names == b.body_names and a.dof_names == b.dof_names
    for field in a.__dataclass_fields__:
        va, vb = getattr(a, field), getattr(b, field)
        if isinstance(va, np.ndarray):
            np.testing.assert_allclose(vb, va, rtol=0, atol=1e-7, err_msg=field)
        else:
            assert va == vb, field


def test_floating_articulation_model_equals():
    """nv = nd + 6, the base's six armature lanes zero, the base composite
    at link nd, the (nl, nd) ancestor mask."""
    a = JD.build_articulation(jax_load_tree(URDF, floating_base=True))
    b = D.build_articulation(load_tree(URDF, floating_base=True))
    assert (b.floating, b.nv, b.nl) == (True, 33, 28) == (a.floating, a.nv, a.nl)
    assert b.ancestor_mask.shape == (28, 27) and not b.ancestor_mask[27].any()
    assert not b.armature[:6].any()
    for f in ("ancestor_mask", "link_mass", "link_com", "link_inertia_com", "armature",
              "is_revolute"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)


@pytest.fixture(scope="module")
def built():
    """(JAX env, port env, the arguments JAX's simulator passes to
    ``build_fused_substep_floating``)."""
    je = isaacgym_tpu.make(seed=0, task=C10, num_envs=8)
    captured = {}
    real = PDK.build_fused_substep_floating

    def capture(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return real(*args, **kwargs)

    PDK.build_fused_substep_floating = capture
    try:
        je.sim._maybe_build_pallas(force=True)
    finally:
        PDK.build_fused_substep_floating = real
    pe = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=8, device="cpu")
    return je, pe, captured


def test_floating_humanoid_compiles_to_an_articulation_slot(built):
    je, pe, _ = built
    a, b = je.scene, pe.scene
    assert len(b.articulations) == 1 and len(b.free_bodies) == 1
    assert b.articulations[0].actor_index == 0 and b.free_bodies[0].actor_index == 2
    np.testing.assert_array_equal(b.initial_root, a.initial_root)
    assert (a.num_dofs, a.num_bodies) == (b.num_dofs, b.num_bodies) == (27, 42)
    assert len(b.static_geoms) == len(a.static_geoms) == 2
    assert len(b.art_geoms) == len(a.art_geoms) == 9
    for ga, gb in zip(a.static_geoms + a.art_geoms, b.static_geoms + b.art_geoms):
        for f in ga.__dataclass_fields__:
            np.testing.assert_array_equal(np.asarray(getattr(gb, f)),
                                          np.asarray(getattr(ga, f)), err_msg=f)
    assert [dataclasses.asdict(x) for x in a.free_bodies] == \
        [dataclasses.asdict(x) for x in b.free_bodies]
    assert pe.sim.fused_substep_floating is not None
    assert pe.sim.fused_substep is None and pe.sim.fused_substep_multi is None


def test_geom_lists_and_pack_equal_the_pallas_build_arguments(built):
    je, pe, cap = built
    args, kw = cap["args"], dict(cap["kwargs"])
    assert kw.pop("with_torque") is False and kw["exact_support"] is True
    static, art, bodies = floating_geom_lists(pe.scene)
    for mine, theirs in zip(static + art, args[6] + args[7]):
        assert set(mine) == set(theirs)
        for k in mine:
            np.testing.assert_array_equal(np.asarray(mine[k]), np.asarray(theirs[k]), err_msg=k)
    assert [g["link"] for g in art].count(-1) == 2   # the base-welded geoms move too
    np.testing.assert_array_equal(bodies, je.sim._ffl_art_bodies)
    assert fused_ball_cfg(pe.scene) == args[5]
    np.testing.assert_array_equal(pe.sim.constants, FF.build_floating_constants(*args, **kw))


def test_body_states_carry_the_base_velocity(built):
    je, pe, _ = built
    rng = np.random.RandomState(5)
    n = 8
    sj = je.sim.initial_state(n)
    root = np.array(sj.root)
    root[:, 0, 3:7] = np.asarray([0.1, -0.05, 0.2, 0.97]) / np.linalg.norm([0.1, -0.05, 0.2, 0.97])
    root[:, 0, 7:13] = rng.uniform(-1.0, 1.0, (n, 6))
    sj = sj._replace(root=jnp.asarray(root),
                     dof_pos=jnp.asarray(rng.uniform(-0.3, 0.3, (n, 27)).astype(np.float32)),
                     dof_vel=jnp.asarray(rng.uniform(-3, 3, (n, 27)).astype(np.float32)))
    sp = sim_state_from_numpy({f: np.asarray(getattr(sj, f)) for f in sj._fields})
    ids = pe.rb_body_ids()
    a = np.asarray(je.sim.make_body_state_fn(ids)(sj))
    b = pe.sim.make_body_state_fn(ids)(sp).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-5)
    assert np.abs(b[:, 0, 7:13] - root[:, 0, 7:13]).max() < 1e-6   # the pelvis is the base


def test_c10_launcher_trains_on_the_cpu(tmp_path):
    from isaacgym_tpu_torch.train import main
    ts = main([f"task={C10}", "num_envs=4", "max_iterations=1", "device=cpu",
               "experiment=c10", "train.params.network.mlp.units=[32,32]",
               "train.params.config.horizon_length=4",
               "train.params.config.minibatch_size=16"], run_root=str(tmp_path))
    assert ts.epoch == 1
    assert (tmp_path / "c10" / "ckpt_final.pt").exists()
    assert ts.params.mu.out_features == 27 and ts.params.actor_mlp.layers[0].in_features == 313
