"""Domain randomization in the port against the JAX package's.

The sampler: the two RNG streams differ, so the port's ``DomainRandomizer``
is held against the JAX package's by distribution (4096 envs each): the
identity at step 0 (every flagship term is on a 3000-step linear schedule),
the ranges, means and spreads at full and half strength. Means are gated at
5 standard errors of the difference of two sample means, spreads at 5 %.

The env step: states come from a JAX rollout with DR on (numpy-seeded
actions). Before each compared step the same full-strength ``DRParams``
(JAX-sampled at step 3000) is injected into both packages through
``interop``, and the port's action and observation noise are replaced by
the JAX package's own draws for that step, so the step differs only in its
physics (XLA path on the JAX side, the plain K2-dr on the port's) and in the
launch of resetting balls, which is injected as in ``test_torch_env.py``.
The gates are the flagship gates of ``tests/test_torch_env.py``
(``tools/parity_tpu.py:57-59``), flip-aware in the same way.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

import isaacgym_tpu
from isaacgym_tpu.env.randomize import DomainRandomizer as JDomainRandomizer

import isaacgym_tpu_torch
from isaacgym_tpu_torch.env.randomize import DomainRandomizer, DRParams
from isaacgym_tpu_torch.interop import env_state_from_numpy, to_numpy
from isaacgym_tpu_torch.utils.config import load_task_config

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
B = 64
N_DRAW = 4096
GATE = dict(max_dof_pos=0.01, max_dof_vel=1.5, max_root=0.2, max_ncf=10.0,
            max_obs=0.2, max_reward=40.0, max_flip_rate=0.002)
SAMPLE_STEPS = (10, 30, 50, 70)


def _dr_cfg():
    cfg = load_task_config(TASK)
    cfg["task"]["randomize"] = True
    return cfg


def _spec():
    return load_task_config(TASK)["task"]["randomization_params"]


def _jax_draws(step):
    rz = JDomainRandomizer(_spec(), 7)
    keys = jax.random.split(jax.random.PRNGKey(0), N_DRAW)
    p = jax.vmap(lambda k: rz.sample(k, jnp.asarray(step, jnp.int32)))(keys)
    return {f: np.asarray(v, np.float64) for f, v in p._asdict().items()}


def _port_draws(step):
    rz = DomainRandomizer(_spec(), 7)
    p = rz.sample(torch.Generator().manual_seed(0), step, N_DRAW)
    return {f: v.numpy().astype(np.float64) for f, v in p._asdict().items()}


def test_sampler_is_the_identity_at_step_0():
    for draws in (_port_draws(0), _jax_draws(0)):
        for f, v in draws.items():
            want = 1.0 if f.endswith("scale") else 0.0
            np.testing.assert_array_equal(v, want, err_msg=f)


@pytest.mark.parametrize("step", [1500, 3000, 6000])
def test_sampler_matches_the_jax_distribution(step):
    got, want = _port_draws(step), _jax_draws(step)
    for f in DRParams._fields:
        a, b = got[f], want[f]
        assert a.shape == b.shape, f
        if f == "gravity_offset":           # noise on z only
            assert not a[:, :2].any()
            a, b = a[:, 2], b[:, 2]
        se = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= 5 * se + 1e-12, f
        assert abs(a.std() - b.std()) <= 0.05 * b.std(), f
        if f.endswith("scale"):             # uniform: same support
            assert b.min() - 0.01 <= a.min() and a.max() <= b.max() + 0.01, f
    s = min(step / 3000.0, 1.0)
    m = got["mass_scale"]
    assert m.min() >= 1 + (0.5 - 1) * s - 1e-6 and m.max() <= 1 + (1.5 - 1) * s + 1e-6
    assert abs(got["gravity_offset"][:, 2].std() - 0.4 * s) < 0.05 * 0.4 * s


def test_noise_spreads():
    rz = DomainRandomizer(_spec(), 7)
    g = torch.Generator().manual_seed(1)
    zeros = torch.zeros(N_DRAW, 80)
    assert abs(rz.observation_noise(g, zeros).std().item() - 0.002) < 1e-4
    assert abs(rz.action_noise(g, zeros[:, :7]).std().item() - 0.02) < 1e-3
    assert rz.frequency == 600


def _jax_state_numpy(s):
    return dict(sim=dict(s.sim._asdict()), progress=s.progress, flags=dict(s.flags),
                pre_ball_root=s.pre_ball_root, ep_return=s.ep_return,
                dr=dict(s.dr._asdict()), randomize_buf=s.randomize_buf,
                global_step=s.global_step)


@pytest.fixture(scope="module")
def pair():
    je = isaacgym_tpu.make(seed=0, task=TASK, num_envs=B, cfg=_dr_cfg())
    pe = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, device="cpu", cfg=_dr_cfg())
    assert je.randomize and pe.randomize
    rz = je.randomizer
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    full = jax.vmap(lambda k: rz.sample(k, jnp.asarray(3000, jnp.int32)))(keys)
    step = jax.jit(je.step_fn)
    rng = np.random.RandomState(7)
    state, _ = je.reset()
    samples = []
    for t in range(max(SAMPLE_STEPS) + 1):
        a = rng.uniform(-1, 1, (B, 7)).astype(np.float32)
        if t in SAMPLE_STEPS:
            s = jax.tree.map(np.asarray, state._replace(dr=full))
            if t == SAMPLE_STEPS[-1]:
                # a third of the envs at the episode boundary: the step resets them
                s = s._replace(progress=np.where(np.arange(B) % 3 == 0,
                                                 je.max_episode_length - 2,
                                                 s.progress).astype(np.int32))
            out = jax.tree.map(np.asarray, step(jax.tree.map(jnp.asarray, s), jnp.asarray(a)))
            gs = int(s.global_step)
            noise_a = np.asarray(jax.random.normal(jax.random.fold_in(
                jax.random.PRNGKey(101), gs), (B, 7))) * rz.act_noise
            noise_o = np.asarray(jax.random.normal(jax.random.fold_in(
                jax.random.PRNGKey(202), gs + 1), (B, 80))) * rz.obs_noise
            samples.append((s, a, out, noise_a, noise_o))
        state, *_ = step(state, jnp.asarray(a))
    return je, pe, samples


def test_dr_env_step_matches_within_the_flagship_gates(pair, monkeypatch):
    je, pe, samples = pair
    dev = {k: 0.0 for k in ("dof_pos", "dof_vel", "root", "ncf", "obs", "reward")}
    flips = compared = resets = 0
    for s_np, a, (sj, oj, rj, dj, ij), noise_a, noise_o in samples:
        sp = env_state_from_numpy(_jax_state_numpy(s_np))
        launch = torch.tensor(np.asarray(sj.sim.root[:, 2, 7:10]))
        monkeypatch.setattr(pe, "sample_ball_velocity", lambda n: launch[:n].clone())
        monkeypatch.setattr(pe.randomizer, "action_noise",
                            lambda g, x: x + torch.as_tensor(noise_a, dtype=torch.float32))
        monkeypatch.setattr(pe.randomizer, "observation_noise",
                            lambda g, x: x + torch.as_tensor(noise_o, dtype=torch.float32))
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
        # no env passed ``frequency``: the DR params ride on unchanged
        got_dr = to_numpy(sp2.dr)
        for f, v in sj.dr._asdict().items():
            np.testing.assert_array_equal(got_dr[f], v, err_msg=f)
        np.testing.assert_array_equal(sp2.randomize_buf.numpy(), sj.randomize_buf)
        assert int(sp2.global_step) == int(sj.global_step) == int(s_np.global_step) + 1
        np.testing.assert_array_equal(sp2.progress.numpy()[clean], sj.progress[clean])
    assert resets >= B // 3 - 1
    for k, v in dev.items():
        assert v <= GATE[f"max_{k}"], f"{k}: {v:.3e} > {GATE[f'max_{k}']}"
    assert flips / compared <= GATE["max_flip_rate"], (flips, compared)


def test_full_strength_dr_moves_the_step(pair):
    """The injected parameters act on the port's step: it differs from the
    same step with identity parameters."""
    _, pe, samples = pair
    s_np, a = samples[1][:2]
    d = _jax_state_numpy(s_np)
    full = env_state_from_numpy(d)
    ident = full._replace(dr=DRParams(*[torch.ones_like(v) if f.endswith("scale")
                                        else torch.zeros_like(v)
                                        for f, v in full.dr._asdict().items()]))
    g = torch.Generator().manual_seed(0)
    pe.generator.set_state(g.get_state())
    s_full = pe.step(full, torch.as_tensor(a))[0]
    pe.generator.set_state(g.get_state())
    s_id = pe.step(ident, torch.as_tensor(a))[0]
    assert (s_full.sim.dof_force - s_id.sim.dof_force).abs().max() > 1.0


def test_resample_at_the_boundary_after_frequency():
    """Resetting envs whose counter reached ``frequency`` draw new params at
    the current global step and restart their counter; the others keep
    theirs and count on."""
    pe = isaacgym_tpu_torch.make(seed=3, task=TASK, num_envs=16, device="cpu", cfg=_dr_cfg())
    state, _ = pe.reset()
    assert int(state.global_step) == 0
    assert bool((state.dr.mass_scale == 1.0).all())          # identity at step 0
    half = torch.arange(16) % 2 == 0
    state = state._replace(
        progress=torch.full((16,), pe.max_episode_length - 2, dtype=torch.int32),
        randomize_buf=torch.where(half, 599, 3).to(torch.int32),
        global_step=torch.tensor(2999, dtype=torch.int32))
    s2, *_ , done, _ = pe.step(state, torch.zeros(16, 7))
    assert bool(done.all())
    assert int(s2.global_step) == 3000
    np.testing.assert_array_equal(s2.randomize_buf.numpy(), np.where(half, 0, 4))
    changed = (s2.dr.mass_scale != 1.0) & (s2.dr.kp_scale != 1.0).all(1)
    np.testing.assert_array_equal(changed.numpy(), half.numpy())
    assert float(s2.dr.restitution_scale[half].max()) <= 0.7
