"""C11 (HumanoidPingpong5ActorG1: two fixed-base 26-DOF humanoids under
effort drive, a table and two balls, K3 at <26, 2, 2>) against the JAX
package's task of the same name.

- ``make`` on the CPU: obs 24, act 52, 5 actors, route k3, and k3 on the
  card too (``KERNEL_SHAPES`` holds <26, 2, 2>); the resolved configs equal
  the JAX loader's.
- ``action_to_drive`` equals the JAX task's at powerScale 1 and 0.5.
- The reward's symmetry across the robots (``tests/test_task_family.py:268``).
- The env step: states of a JAX rollout at 8 envs under numpy-seeded uniform
  actions (steps 5, 15, 25 and 35, the last with half the envs at the
  episode boundary), each stepped once by both packages with the same
  actions and, for the envs that reset, the JAX step's own launches of both
  balls (``sample_ball_velocities``). The JAX side runs its XLA path; the
  port its K3 route (the plain K3) and its non-kernel route. Held per field
  to ``STEP_TOL`` (far inside the C11 row of ``tools/parity_tpu.py:82-84``)
  over the envs that are not flips: none on the non-kernel route, at most
  one of the 32 on the K3 route (a paddle strike where the JAX kernel, which
  K3 follows, parts from the XLA step).
- The plain K3 against the port's non-kernel step on C11 (reset, both
  paddle strikes and ball rest, random efforts) within
  ``tests/test_torch_nonkernel.py``'s ``GATE``, flip-aware.
- JAX-initialised actor-critic parameters at C11's widths (obs 24, act 52,
  the train config's units), carried by ``interop.actor_critic_from_jax``,
  give the JAX action means.
- The launcher trains C11 on the CPU.

The JAX env step at 8 envs costs about 30 s of XLA compile on the CPU, once
for the module.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

import isaacgym_tpu
import isaacgym_tpu_torch
from isaacgym_tpu.rl.networks import ActorCritic as JActorCritic
from isaacgym_tpu.utils.config import compose as jax_compose
from isaacgym_tpu.utils.config import load_task_config as jax_load_task_config
from isaacgym_tpu_torch.interop import actor_critic_from_jax, env_state_from_numpy
from isaacgym_tpu_torch.rl.networks import ActorCritic
from isaacgym_tpu_torch.sim import scripted
from isaacgym_tpu_torch.sim.simulator import route_for
from isaacgym_tpu_torch.utils.config import load_task_config, load_train_config
from tests.test_torch_nonkernel import GATE

C11 = "HumanoidPingpong5ActorG1"
B = 8
SAMPLE_STEPS = (5, 15, 25, 35)
#: per field, the most the port's step may deviate from the JAX XLA step on
#: an env that is not a flip (float32 rounding of two implementations of one
#: step; on the non-kernel route 1e-6 m, 7e-5 rad/s, 1e-3 N measured)
STEP_TOL = dict(dof_pos=1e-5, dof_vel=1e-3, dof_force=1e-4, root=1e-4, ncf=1e-2, obs=1e-3,
                reward=1e-4)
MAX_FLIPS = dict(k3=1, nonkernel=0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX env, port env on the CPU, [(state, actions, JAX step output)])."""
    je = isaacgym_tpu.make(seed=0, task=C11, num_envs=B)
    pe = isaacgym_tpu_torch.make(seed=0, task=C11, num_envs=B, device="cpu")
    step = jax.jit(je.step_fn)
    rng = np.random.RandomState(11)
    state, _ = je.reset()
    samples = []
    for t in range(max(SAMPLE_STEPS) + 1):
        a = rng.uniform(-1, 1, (B, 52)).astype(np.float32)
        if t in SAMPLE_STEPS:
            s_np = _np(state)
            if t == SAMPLE_STEPS[-1]:
                s_np = s_np._replace(progress=np.where(
                    np.arange(B) % 2 == 0, je.max_episode_length - 2,
                    s_np.progress).astype(np.int32))
            samples.append((s_np, a, _np(step(jax.tree.map(jnp.asarray, s_np),
                                              jnp.asarray(a)))))
        state, *_ = step(state, jnp.asarray(a))
    return je, pe, samples


def test_make_routes_and_sizes(pair):
    je, pe, _ = pair
    assert (pe.num_obs, pe.num_actions) == (je.num_obs, je.num_actions) == (24, 52)
    assert len(pe.scene_spec.actors) == 5 and pe.ball_actor == je.ball_actor == 4
    assert [sl.model.tree.n_dof for sl in pe.scene.articulations] == [26, 26]
    assert pe.sim.route == "k3" and route_for(pe.scene, "cuda") == "k3"
    assert pe.sim.fused_substep_multi.ng == 10


def test_resolved_configs_equal_the_yaml_loader():
    assert load_task_config(C11) == jax_load_task_config(C11)
    assert load_train_config(C11) == jax_compose(C11)["train"]


@pytest.mark.parametrize("power_scale", [1.0, 0.5])
def test_action_to_drive_equals_the_jax_task(pair, power_scale):
    je, pe, _ = pair
    a = np.random.RandomState(2).uniform(-1, 1, (B, 52)).astype(np.float32)
    old = (je.power_scale, pe.power_scale)
    je.power_scale = pe.power_scale = power_scale
    try:
        tj, ej = je.action_to_drive(jnp.asarray(a))
        tp, ep = pe.action_to_drive(torch.as_tensor(a))
    finally:
        je.power_scale, pe.power_scale = old
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    np.testing.assert_allclose(ep.numpy(), np.asarray(ej), rtol=1e-6, atol=0)


def test_reward_symmetric_across_robots(pair):
    _, pe, _ = pair
    state, _ = pe.reset()
    rb = pe._rb_fn(state.sim)[:1]
    sim1 = type(state.sim)(*[t[:1] for t in state.sim])
    p1, p2 = rb[0, 0, 0:3], rb[0, 1, 0:3]
    offs = torch.tensor([0.3, 0.1, 0.2])
    far = (p1 + p2) / 2 + torch.tensor([0.0, 0.0, 50.0])

    def rew(b1, b2):
        root = sim1.root.clone()
        root[0, pe.BALL1, 0:3] = b1
        root[0, pe.BALL2, 0:3] = b2
        s = sim1._replace(root=root)
        r, _, _ = pe.reward(s.root[:, pe.ball_actor], s, rb, {}, torch.zeros(1))
        return float(r[0])

    r_a, r_b = rew(far, p1 + offs), rew(p2 + offs, far)
    np.testing.assert_allclose(r_a, r_b, rtol=1e-5)
    assert rew(far, p1 + 0.5 * offs) > r_a
    assert rew(p2 + 0.5 * offs, far) > r_b


@pytest.mark.parametrize("route", ["k3", "nonkernel"])
def test_env_step_matches_the_jax_step(pair, monkeypatch, route):
    """The port's env step on its K3 route (the plain K3 on the CPU) and on
    its non-kernel route against the JAX XLA step. The non-kernel step
    computes what the XLA step computes: no flip. K3 follows the JAX
    package's kernel, which parts from the XLA step on some paddle strikes
    at C11's 8.3 ms substep, as on C5's (ROADMAP section 3): an env whose
    root lands more than 0.1 apart is such a flip, at most ``MAX_FLIPS[route]``
    of the 32 env steps, and left out."""
    je, pe, samples = pair
    monkeypatch.setattr(pe.sim, "route", route)
    dev = {k: 0.0 for k in STEP_TOL}
    resets = flips = 0
    for s_np, a, (sj, oj, rj, dj, ij) in samples:
        sp = env_state_from_numpy(dict(sim=dict(s_np.sim._asdict()), progress=s_np.progress,
                                       flags=dict(s_np.flags), pre_ball_root=s_np.pre_ball_root,
                                       ep_return=s_np.ep_return))
        v1 = torch.tensor(np.asarray(sj.sim.root[:, pe.BALL1, 7:10]))
        v2 = torch.tensor(np.asarray(sj.sim.root[:, pe.BALL2, 7:10]))
        monkeypatch.setattr(pe, "sample_ball_velocities",
                            lambda n: (v1[:n].clone(), v2[:n].clone()))
        sp2, op, rp, dp, ip = pe.step(sp, torch.as_tensor(a))
        np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
        resets += int(np.asarray(dj).sum())
        clean = np.abs(sp2.sim.root.numpy() - sj.sim.root).reshape(B, -1).max(1) <= 0.1
        flips += int((~clean).sum())
        pairs = dict(dof_pos=(sp2.sim.dof_pos, sj.sim.dof_pos),
                     dof_vel=(sp2.sim.dof_vel, sj.sim.dof_vel),
                     dof_force=(sp2.sim.dof_force, sj.sim.dof_force),
                     root=(sp2.sim.root, sj.sim.root),
                     ncf=(sp2.sim.net_contact_force, sj.sim.net_contact_force),
                     obs=(op, oj), reward=(rp, rj))
        for k, (x, y) in pairs.items():
            d = np.abs(x.numpy() - np.asarray(y)).reshape(B, -1).max(1)
            dev[k] = max(dev[k], float(d[clean].max()))
        np.testing.assert_array_equal(sp2.progress.numpy(), np.asarray(sj.progress))
        for k in ("episode_done", "time_outs", "episode_length"):
            np.testing.assert_array_equal(ip[k].numpy(), np.asarray(ij[k]))
        np.testing.assert_array_equal(sp2.pre_ball_root.numpy(), np.asarray(sj.pre_ball_root))
    assert resets >= B // 2
    assert flips <= MAX_FLIPS[route], f"{route}: {flips} flips"
    for k, tol in STEP_TOL.items():
        assert dev[k] <= tol, f"{route}: {k}: {dev[k]:.3e} > {tol}"


@pytest.mark.parametrize("kind", scripted.C8_KINDS)
def test_plain_k3_matches_the_nonkernel_step(pair, kind):
    """One step of the K3 route (the plain K3) and of the non-kernel step
    from C11's scripted sets (every env's balls at a paddle on the strike
    sets), random efforts. Over the envs that are not flips (root within
    0.1; at most one a set, a strike where the JAX kernel's sweep and the
    XLA step's part): every field within ``GATE``, the contact forces on the
    rows K3 reports (the articulated geoms' bodies and the balls: a ball's
    contact with a base-welded geom is a static's in the kernel, as in the
    JAX package's), not the contact moments (the sensor-less kernel route
    leaves them at zero)."""
    _, pe, _ = pair
    sim = pe.sim
    rng = np.random.RandomState(21)
    state, _ = scripted.strike_state(sim, kind, B, rng, cfg=pe.cfg)
    eff = torch.as_tensor(rng.uniform(-20.0, 20.0, (B, 52)).astype(np.float32))
    tgt = torch.zeros_like(eff)
    got = sim.step_kernel(state, tgt, eff)
    want = sim.step_nonkernel(state, tgt, eff)
    clean = (got.root - want.root).abs().reshape(B, -1).max(1).values <= 0.1
    assert int((~clean).sum()) <= 1, kind
    rows = torch.as_tensor(np.concatenate([sim.art_bodies,
                                           [b.body_start for b in pe.scene.free_bodies]]))
    for f, tol in GATE.items():
        if f == "net_contact_torque":
            continue
        d = (getattr(got, f) - getattr(want, f))[clean]
        if f == "net_contact_force":
            d = d[:, rows]
        assert float(d.abs().max()) <= tol, f"{kind}: {f} {float(d.abs().max()):.3e} > {tol}"
    if kind != "reset":
        assert float(got.net_contact_force[clean][:, rows].abs().max()) > 0.0


def test_jax_c11_policy_carried_across_gives_the_same_mu():
    units = tuple(load_train_config(C11)["params"]["network"]["mlp"]["units"])
    jnet = JActorCritic(num_actions=52, units=units, compute_dtype=jnp.float32)
    params = jnet.init(jax.random.PRNGKey(6), jnp.zeros((1, 24)))
    obs = np.random.RandomState(5).standard_normal((16, 24)).astype(np.float32)
    mu_j, ls_j, v_j = jnet.apply(params, jnp.asarray(obs))
    net = ActorCritic(24, 52, units=units, compute_dtype=torch.float32)
    net.load_state_dict(actor_critic_from_jax(_np(params)))
    with torch.no_grad():
        mu, ls, v = net(torch.as_tensor(obs))
    assert mu.shape == (16, 52)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ls.detach().numpy(), np.asarray(ls_j))


def test_c11_launcher_trains_on_the_cpu(tmp_path):
    from isaacgym_tpu_torch.train import main
    ts = main([f"task={C11}", "num_envs=8", "max_iterations=1", "device=cpu",
               "experiment=c11", "train.params.network.mlp.units=[32,32]",
               "train.params.config.horizon_length=4",
               "train.params.config.minibatch_size=16"], run_root=str(tmp_path))
    assert ts.epoch == 1
    assert (tmp_path / "c11" / "ckpt_final.pt").exists()
    assert ts.params.mu.out_features == 52 and ts.params.actor_mlp.layers[0].in_features == 24
