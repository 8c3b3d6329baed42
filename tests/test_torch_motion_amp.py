"""The port's motion library and AMP (``isaacgym_tpu_torch/rl/motion_lib.py``,
``rl/amp.py``) against the JAX package's (``isaacgym_tpu/rl/motion_lib.py``,
``rl/amp.py``).

Clips written by either package's ``save_motion_clip`` load in the other,
and ``get_motion_state`` agrees within 1e-6 on the same queries. With the
flax discriminator's weights carried across
(``interop.amp_discriminator_from_jax``), ``disc_loss`` (total, both logits,
the gradient penalty) and ``style_reward`` agree within 1e-5 relative, and
one discriminator Adam step equals optax's. An ``AMPTrainer`` epoch runs on
the port alone at 8 envs (no JAX AMP epoch is compiled), and the
discriminator learns to tell two clouds apart as in
``tests/test_motion_amp.py``.
"""

import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp
import optax

import isaacgym_tpu_torch
from isaacgym_tpu.rl import amp as JA
from isaacgym_tpu.rl import motion_lib as JM
from isaacgym_tpu_torch.interop import amp_discriminator_from_jax
from isaacgym_tpu_torch.models.assets import ASSET_DIR
from isaacgym_tpu_torch.rl import amp as A
from isaacgym_tpu_torch.rl import motion_lib as M
from isaacgym_tpu_torch.rl.ppo import PPOConfig

D, J = 7, 5
UNITS = (64, 32)


def _clip_arrays(T, freq, bodies):
    t = np.linspace(0, 2 * np.pi, T)
    rng = np.random.RandomState(int(freq * 10))
    q = rng.standard_normal((T, 4))
    arrays = dict(
        root_pos=np.stack([t, 0.1 * t, np.sin(t)], -1),
        root_rot=q / np.linalg.norm(q, axis=-1, keepdims=True),
        dof_pos=0.3 * np.sin(freq * t)[:, None] * np.linspace(0.5, 1.5, D)[None],
        dof_vel=0.3 * freq * np.cos(freq * t)[:, None] * np.ones((1, D)))
    if bodies:
        qb = rng.standard_normal((T, J, 4))
        arrays.update(body_pos=rng.standard_normal((T, J, 3)).astype(np.float32),
                      body_rot=(qb / np.linalg.norm(qb, axis=-1, keepdims=True)).astype(
                          np.float32))
    return arrays


@pytest.fixture(scope="module", params=("jax_writes", "port_writes"))
def clips(request, tmp_path_factory):
    """Two clips of unequal length, one with body states, written by one
    package's ``save_motion_clip``."""
    d = tmp_path_factory.mktemp(request.param)
    save = JM.save_motion_clip if request.param == "jax_writes" else M.save_motion_clip
    for i, (T, freq) in enumerate(((60, 1.0), (45, 2.0))):
        a = _clip_arrays(T, freq, bodies=True)
        if request.param == "port_writes":
            a = {k: torch.as_tensor(v) for k, v in a.items()}
        save(os.path.join(d, f"clip{i}.npz"), fps=30.0, **a)
    return str(d)


def test_clips_load_in_both_and_states_match(clips):
    lib = M.MotionLib(clips, num_dofs=D, key_body_ids=[1, 3], device="cpu")
    jlib = JM.MotionLib(clips, num_dofs=D, key_body_ids=[1, 3])
    assert lib.num_motions == jlib.num_motions == 2 and lib.num_bodies == J
    np.testing.assert_array_equal(lib.motion_lengths.numpy(), np.asarray(jlib.motion_lengths))
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 2, 256)
    times = rng.uniform(-0.2, 2.2, 256).astype(np.float32)   # past both ends too
    got = lib.get_motion_state(torch.as_tensor(ids), torch.as_tensor(times))
    want = jlib.get_motion_state(jnp.asarray(ids), jnp.asarray(times))
    assert set(got) == set(want) == {"root_pos", "root_rot", "dof_pos", "dof_vel", "body_pos",
                                     "body_rot", "key_body_pos"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    gen = torch.Generator().manual_seed(0)
    s_ids = lib.sample_motions(gen, 64)
    s_t = lib.sample_time(gen, s_ids)
    assert set(s_ids.tolist()) <= {0, 1} and float(s_t.min()) >= 0
    assert bool((s_t <= lib.motion_lengths[s_ids]).all())


def test_skeleton_tree_matches():
    path = os.path.join(ASSET_DIR, "g1_29dof_rev_1_0_pingpong_fixed_except_right_arm.urdf")
    sk, jsk = M.SkeletonTree.from_mjcf(path), JM.SkeletonTree.from_mjcf(path)
    assert sk.num_nodes == jsk.num_nodes == 40 and sk.node_names == jsk.node_names
    assert sk.node_names[0] == "pelvis" and sk.parent_indices[0] == -1
    np.testing.assert_array_equal(sk.parent_indices, jsk.parent_indices)
    np.testing.assert_array_equal(sk.local_translation, jsk.local_translation)


def _disc_pair(dim=28, seed=0):
    jdisc = JA.AMPDiscriminator(units=UNITS)
    params = jdisc.init(jax.random.PRNGKey(seed), jnp.zeros((1, dim)))
    disc = A.AMPDiscriminator(dim, UNITS)
    disc.load_state_dict(amp_discriminator_from_jax(jax.tree.map(np.asarray, params)))
    return jdisc, params, disc


def _obs(seed, n=96, dim=28, shift=0.0):
    return (np.random.RandomState(seed).standard_normal((n, dim)) + shift).astype(np.float32)


def test_disc_loss_and_style_reward_match():
    jdisc, params, disc = _disc_pair()
    agent, demo = _obs(1, shift=-0.5), _obs(2, shift=0.5)
    apply_fn = lambda p, x: jdisc.apply(p, x)
    jtotal, jaux = JA.disc_loss(apply_fn, params, jnp.asarray(agent), jnp.asarray(demo))
    total, aux = A.disc_loss(disc, torch.as_tensor(agent), torch.as_tensor(demo))
    close = lambda a, b: np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=0)
    close(total, jtotal)
    for k in ("disc_agent_logit", "disc_demo_logit", "disc_grad_penalty"):
        close(aux[k], jaux[k])
    assert float(aux["disc_grad_penalty"]) > 0
    np.testing.assert_allclose(A.style_reward(disc, torch.as_tensor(agent)).numpy(),
                               np.asarray(JA.style_reward(apply_fn, params, jnp.asarray(agent))),
                               rtol=1e-5, atol=1e-7)


class _StubEnv:
    num_envs, num_obs, num_actions = 4, 14, 7
    device = torch.device("cpu")


def test_one_disc_adam_step_matches_optax():
    """``AMPTrainer.disc_update`` (Adam at 1e-4 on ``disc_loss``, its
    gradient through the penalty's double backward) against optax.adam on
    ``jax.value_and_grad`` of the JAX loss, from the same weights."""
    jdisc, params, _ = _disc_pair(seed=3)
    trainer = A.AMPTrainer(_StubEnv(), PPOConfig(units=(16,)), amp_obs_dim=28,
                           demo_sampler=None, disc_units=UNITS)
    _, amp_state = trainer.init_state()
    amp_state.disc.load_state_dict(amp_discriminator_from_jax(jax.tree.map(np.asarray, params)))
    agent, demo = _obs(4, shift=-1.0), _obs(5, shift=1.0)
    apply_fn = lambda p, x: jdisc.apply(p, x)
    (jloss, _), grads = jax.value_and_grad(
        lambda p: JA.disc_loss(apply_fn, p, jnp.asarray(agent), jnp.asarray(demo)),
        has_aux=True)(params)
    opt = optax.adam(1e-4)
    updates, _ = opt.update(grads, opt.init(params))
    want = amp_discriminator_from_jax(jax.tree.map(np.asarray,
                                                   optax.apply_updates(params, updates)))
    amp_state, metrics = trainer.disc_update(amp_state, torch.as_tensor(agent),
                                             torch.as_tensor(demo))
    assert amp_state.disc_opt.count == 1
    np.testing.assert_allclose(float(metrics["disc_loss"]), float(jloss), rtol=1e-5)
    for n, p in amp_state.disc.named_parameters():
        # a first Adam step is lr * sign(g) up to eps: a 1e-4 move, held to 1e-7
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=0, atol=1e-7,
                                   err_msg=n)


def test_amp_trainer_epoch_on_the_flagship(tmp_path):
    """Record a rollout as a clip with the demo's tools, then one AMP epoch
    of a fresh policy at 8 envs: finite metrics, the style reward flowing."""
    from isaacgym_tpu_torch.amp_demo import amp_features, dof_obs_offset, record_clip
    env = isaacgym_tpu_torch.make(seed=0, task="HumanoidPingpongTiltNoEarlyStopG1",
                                  num_envs=8, device="cpu", episodeLength=30)
    clip = str(tmp_path / "clip.npz")
    fps = record_clip(env, lambda o: torch.full((8, 7), 0.25), 20, clip)
    lib = M.MotionLib(clip, num_dofs=7, device="cpu")
    amp_obs_fn, demo_sampler = amp_features(lib, dof_obs_offset(env), 7, fps)
    cfg = PPOConfig(units=(32, 32), horizon_length=4, minibatch_size=8, mini_epochs=1)
    trainer = A.AMPTrainer(env, cfg, amp_obs_dim=28, demo_sampler=demo_sampler,
                           amp_obs_fn=amp_obs_fn, seed=0, disc_units=UNITS)
    ppo_state, amp_state = trainer.init_state()
    env_state, obs = trainer.reset(amp_state)
    ppo_state, amp_state, env_state, obs, metrics = trainer.train_epoch(
        ppo_state, amp_state, env_state, obs)
    assert ppo_state.epoch == 1 and amp_state.disc_opt.count == 1
    for name in ("reward_mean", "a_loss", "disc_loss", "disc_demo_logit", "disc_agent_logit"):
        assert np.isfinite(float(metrics[name])), name
    demo = demo_sampler(torch.Generator().manual_seed(5), 16)
    assert demo.shape == (16, 28)
    assert float(trainer.blended_reward(amp_state, torch.zeros(16), demo).abs().max()) > 0


def test_discriminator_learns_to_separate():
    dim = 14
    rng = np.random.RandomState(0)
    demo = torch.as_tensor(rng.randn(256, dim).astype(np.float32) + 2.0)
    agent = torch.as_tensor(rng.randn(256, dim).astype(np.float32) - 2.0)
    disc = A.AMPDiscriminator(dim, units=(32, 32))
    disc.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(disc.parameters(), lr=1e-3, eps=1e-8)
    for _ in range(200):
        loss, aux = A.disc_loss(disc, agent, demo)
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert float(aux["disc_demo_logit"]) > 0.5
    assert float(aux["disc_agent_logit"]) < -0.5
    assert float(A.style_reward(disc, demo).mean()) > float(A.style_reward(disc, agent).mean())
