"""``tools/torch_ckpt_from_orbax.py``: a JAX train state saved with orbax,
converted, restores into the port as the same policy and the same next update.

The JAX state (``tests/test_torch_ppo.py``'s net, obs 80, act 7, units
(64, 32)) first takes one clipped Adam step on a fixed batch, so its Adam
moments and count are not the initial ones; its normalizers are drawn from
a seed, its epoch and lr set. After ``isaacgym_tpu.rl.checkpoint.save`` and
the conversion, the port's ``checkpoint.restore`` gives a state whose
means, log-sigmas and values on 64 observations equal the JAX policy's
(1e-5), whose Adam count, moments, normalizers, epoch and lr are the JAX
ones, and whose next update (the second Adam step) moves the parameters as
the JAX update does, within ``tests/test_torch_ppo.py``'s tolerance for
updates after the first step (5e-3 lr where the gradient is large).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import jax
import jax.numpy as jnp

from isaacgym_tpu.rl import checkpoint as jckpt
from isaacgym_tpu.rl import normalizer as JN
from tests.test_torch_ppo import (B, H, LR, OBS, _assert_steps_match, _fixed_batch, _flat,
                                  _jax_update, _np_tree, _stats, _trainers)
from tools.torch_ckpt_from_orbax import convert

from isaacgym_tpu_torch.interop import actor_critic_from_jax
from isaacgym_tpu_torch.rl import checkpoint as ckpt


def test_converted_checkpoint_restores_the_jax_policy_and_update(tmp_path, monkeypatch):
    T = B * H
    jt, jts, pt, pts = _trainers(grad_norm=0.5, learning_rate=LR)
    template = jts
    rng = np.random.RandomState(12)
    jstats = JN.RunningStats(**{k: jnp.asarray(v) for k, v in _stats(rng, (OBS,)).items()})
    vstats = JN.RunningStats(**{k: jnp.asarray(v) for k, v in _stats(rng, ()).items()})
    batch = _fixed_batch(jt, jts.params, jstats, T)
    jparams, jopt, jlr, _ = jt._update(jts, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jstats, jax.random.PRNGKey(3))
    jts = jts._replace(params=jparams, opt_state=jopt, obs_stats=jstats, value_stats=vstats,
                       epoch=jnp.asarray(7, jnp.int32), last_lr=jlr)
    jckpt.save(str(tmp_path / "orbax"), jts)
    d = convert(str(tmp_path / "orbax"), str(tmp_path / "ckpt.pt"), template)
    assert d["opt_state"]["count"] == 1 and d["epoch"] == 7

    back = ckpt.restore(str(tmp_path / "ckpt.pt"), pt.init_state())
    assert back.epoch == 7 and back.opt_state.count == 1
    np.testing.assert_allclose(float(back.last_lr), float(jlr), rtol=0)
    for got, want in ((back.obs_stats, jstats), (back.value_stats, vstats)):
        for f in got._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    adam = jopt.inner_state[1][0]
    names = [n for n, _ in back.params.named_parameters()]
    for mine, theirs in zip((back.opt_state.mu, back.opt_state.nu), (adam.mu, adam.nu)):
        want = actor_critic_from_jax(_np_tree(theirs))
        for n, t in zip(names, mine):
            np.testing.assert_array_equal(t.numpy(), want[n].numpy(), err_msg=n)

    obs = np.random.RandomState(13).standard_normal((64, OBS)).astype(np.float32)
    jmu, jls, jv = (np.asarray(x) for x in jt._policy(jts.params, jstats, jnp.asarray(obs)))
    with torch.no_grad():
        pmu, pls, pv = (x.numpy() for x in pt._policy(back.params, back.obs_stats,
                                                        torch.as_tensor(obs)))
    for got, want in ((pmu, jmu), (pls, jls), (pv, jv)):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)

    batch2 = _fixed_batch(jt, jts.params, jstats, T)
    jparams2, jlr2, _, _, _, jgrads = _jax_update(jt, jts, batch2, jstats, monkeypatch)
    before = actor_critic_from_jax(_np_tree(jts.params))
    p_net, opt_state, lr, _ = pt._update(back, {k: torch.as_tensor(v) for k, v in batch2.items()},
                                         back.obs_stats)
    assert opt_state.count == 2
    got = {n: p.detach().numpy() for n, p in p_net.named_parameters()}
    want = actor_critic_from_jax(_np_tree(jparams2))
    gj = _flat(actor_critic_from_jax(_np_tree(jgrads)))
    assert _assert_steps_match(got, want, before, gj, LR, 5e-3, "next update") <= 4.0
    np.testing.assert_allclose(float(lr), float(jlr2), rtol=1e-6)
