"""C8 (Humanoid12PingpongTiltG1, two humanoids, K3) and C6
(HumanoidPingpongTiltG1, K2): the port's env step against the JAX package's,
from the same states, as ``tests/test_torch_env.py`` does for the flagship;
their resolved configs, the C8 launcher on the CPU, the refusal of DR on C8,
and a JAX C8 policy carried across.

States come from a JAX rollout under uniform actions (numpy-seeded) at
64 envs, 8 states each, the last with half the envs at the episode
boundary; the port steps each once with the same actions and the JAX side's
launch velocity for envs that reset. On the CPU the JAX side runs its XLA
path and the port its plain K2 or K3, so the gates are the C6 and C8 rows of
``tools/parity_tpu.py:60-65`` (flip rate at most 0.5 %), flip-aware as in
``tests/test_torch_env.py``. C8 runs with ``twoPlayer`` off (obs 94) here and on
(obs 188, both humanoids' rewards and flags) in
``tests/test_torch_c8_two_player.py``; C6 in ``tests/test_torch_c6.py``.
Each file traces one XLA env step (about a minute on the CPU), so the three
run side by side under ``--dist loadfile``.
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
from isaacgym_tpu_torch.utils.config import load_task_config, load_train_config

C6, C8 = "HumanoidPingpongTiltG1", "Humanoid12PingpongTiltG1"
C5, C9 = "HumanoidPingpongG1", "HumanoidPingpongAlignmentG1"
B = 64
SAMPLE_STEPS = (5, 15, 25, 35, 45, 55, 65, 75)
GATES = {
    C6: dict(max_dof_pos=0.01, max_dof_vel=1.5, max_root=0.25, max_ncf=20.0,
             max_obs=0.25, max_reward=10.0, max_flip_rate=0.005),
    C8: dict(max_dof_pos=0.01, max_dof_vel=1.5, max_root=0.2, max_ncf=20.0,
             max_obs=0.2, max_reward=10.0, max_flip_rate=0.005),
}
# C5 and C9 have no row of their own: C6's, the same scene at another dt or
# restitution (tests/test_torch_c5_c9.py)
GATES[C5] = GATES[C9] = GATES[C6]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_env_state_numpy(s):
    return dict(sim=dict(s.sim._asdict()), progress=s.progress, flags=dict(s.flags),
                pre_ball_root=s.pre_ball_root, ep_return=s.ep_return)


def make_pair(task, **overrides):
    """(task, JAX env, port env on the CPU, [(state, actions, JAX step
    output)] at the sample steps), all numpy."""
    je = isaacgym_tpu.make(seed=0, task=task, num_envs=B, **overrides)
    pe = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=B, device="cpu", **overrides)
    step = jax.jit(je.step_fn)
    rng = np.random.RandomState(11)
    state, _ = je.reset()
    samples = []
    for t in range(max(SAMPLE_STEPS) + 1):
        a = rng.uniform(-1, 1, (B, pe.num_actions)).astype(np.float32)
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
    return task, je, pe, samples


def check_step_parity(pair, monkeypatch, num_obs):
    """The port's step against the JAX package's on every sample, within
    the task's gates, flip-aware."""
    task, je, pe, samples = pair
    name = f"{task} obs {num_obs}"
    gate = GATES[task]
    ba = pe.ball_actor
    assert ba == je.ball_actor == (3 if task == C8 else 2)
    assert pe.num_obs == je.num_obs == num_obs
    dev = {k: 0.0 for k in ("dof_pos", "dof_vel", "root", "ncf", "obs", "reward")}
    flips = compared = resets = 0
    for s_np, a, (sj, oj, rj, dj, ij) in samples:
        sp = env_state_from_numpy(_jax_env_state_numpy(s_np))
        launch = torch.tensor(np.asarray(sj.sim.root[:, ba, 7:10]))
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
        assert set(sp2.flags) == set(sj.flags)
        for k in sj.flags:
            np.testing.assert_array_equal(sp2.flags[k].numpy()[clean],
                                          np.asarray(sj.flags[k])[clean], err_msg=k)
        np.testing.assert_array_equal(sp2.progress.numpy()[clean],
                                      np.asarray(sj.progress)[clean])
        for k in ("episode_done", "time_outs", "episode_length"):
            np.testing.assert_array_equal(ip[k].numpy()[clean], np.asarray(ij[k])[clean])
    assert resets >= B // 2 - 1
    for k, v in dev.items():
        assert v <= gate[f"max_{k}"], f"{name}: {k}: {v:.3e} > {gate[f'max_{k}']}"
    assert flips / compared <= gate["max_flip_rate"], (name, flips, compared)


@pytest.fixture(scope="module")
def pair():
    return make_pair(C8)


def test_env_step_matches_within_the_parity_gates(pair, monkeypatch):
    check_step_parity(pair, monkeypatch, 94)


@pytest.mark.parametrize("task", (C6, C8))
def test_resolved_configs_equal_the_yaml_loader(task):
    assert load_task_config(task) == jax_load_task_config(task)
    assert load_train_config(task) == jax_compose(task)["train"]


def test_jax_c8_policy_carried_across_gives_the_same_mu():
    obs_dim, act_dim, units = 94, 14, (64, 32)
    jnet = JActorCritic(num_actions=act_dim, units=units, compute_dtype=jnp.float32)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, obs_dim)))
    obs = np.random.RandomState(5).standard_normal((32, obs_dim)).astype(np.float32)
    mu_j, ls_j, v_j = jnet.apply(params, jnp.asarray(obs))
    net = ActorCritic(obs_dim, act_dim, units=units, compute_dtype=torch.float32)
    net.load_state_dict(actor_critic_from_jax(_np(params)))
    with torch.no_grad():
        mu, ls, v = net(torch.as_tensor(obs))
    assert mu.shape == (32, act_dim)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ls.detach().numpy(), np.asarray(ls_j))


def test_c8_launcher_trains_on_the_cpu(tmp_path):
    from isaacgym_tpu_torch.train import main
    ts = main([f"task={C8}", "num_envs=8", "max_iterations=1", "device=cpu",
               "experiment=c8", "train.params.network.mlp.units=[32,32]",
               "train.params.config.horizon_length=4",
               "train.params.config.minibatch_size=16"], run_root=str(tmp_path))
    assert ts.epoch == 1
    assert (tmp_path / "c8" / "ckpt_final.pt").exists()
    assert ts.params.mu.out_features == 14 and ts.params.actor_mlp.layers[0].in_features == 94
