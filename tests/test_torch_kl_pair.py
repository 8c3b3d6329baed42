"""The paired KL run's harness at a small size: the JAX half
(``tools/torch_kl_pair_export.py``) and the port's half
(``isaacgym_tpu_torch.parity.kl_pair``).

The flagship at 8 envs, horizon 8, minibatch 16, 5 mini-epochs, units
(64, 32) in float32, lr 1e-3 (the sizes and tolerances of
``tests/test_torch_ppo_epoch.py::test_two_train_epochs_match``), with an
episode length of 6 so that every env resets at steps 5, 10 and 15 of the
two epochs. The export runs the JAX launcher's computation unpatched; this
test wraps ``jax.random.normal`` and ``jax.random.permutation`` only to
record what they return.

* The export's action noise and permutations are what the JAX trainer drew
  in its two epochs, bit for bit, and its launches are what the JAX env
  draws at each reset (launch 0 the initial state's).
* The port, built by ``kl_pair`` from the export and fed its draws, gives
  each epoch's batch, metrics, normalizers and parameters within
  ``test_two_train_epochs_match``'s tolerances, through the resets, and
  resets every env 3 times.
* ``kl_pair``'s command line writes both runs' per-epoch records.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

from isaacgym_tpu_torch.interop import actor_critic_from_jax
from isaacgym_tpu_torch.parity import kl_pair

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools import torch_kl_pair_export as X  # noqa: E402

NE, H, MB, EPOCHS, LR = 8, 8, 16, 2, 1e-3
OVERRIDES = ["task.env.episodeLength=6", f"train.params.config.horizon_length={H}",
             f"train.params.config.minibatch_size={MB}", "train.params.config.mini_epochs=5",
             f"train.params.config.learning_rate={LR}",
             "train.params.network.mlp.units=[64,32]"]


def _np(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def paired(tmp_path_factory):
    """(export dir, recorded JAX draws, the JAX run's per-epoch records)."""
    out = str(tmp_path_factory.mktemp("kl_pair"))
    rec = {"normal": [], "permutation": []}
    real = {n: getattr(jax.random, n) for n in rec}

    def recorder(name):
        def draw(key, *args, **kw):
            x = real[name](key, *args, **kw)
            jax.debug.callback(lambda v: rec[name].append(np.asarray(v)), x, ordered=True)
            return x
        return draw

    epochs = []

    def on_epoch(it, metrics, batch, ts):
        epochs.append(dict(metrics=metrics, batch=_np(batch), obs_stats=_np(ts.obs_stats),
                           value_stats=_np(ts.value_stats), params=_np(ts.params)))

    mp = pytest.MonkeyPatch()
    for n in rec:
        mp.setattr(jax.random, n, recorder(n))
    try:
        X.export(out, epochs=EPOCHS, num_envs=NE, overrides=OVERRIDES, launcher_check=False,
                 log=lambda *a, **k: None, compute_dtype=jnp.float32, on_epoch=on_epoch)
        jax.effects_barrier()
    finally:
        mp.undo()
    return out, rec, epochs


def test_export_draws_are_the_jax_trainers(paired):
    out, rec, _ = paired
    noise, perms = np.load(os.path.join(out, "noise.npy")), np.load(os.path.join(out, "perms.npy"))
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert noise.shape == (EPOCHS * H, NE, 7) and perms.shape == (EPOCHS * 5, NE * H)
    # the export's own replay draws first, then the training run's draws
    assert len(rec["normal"]) == 2 * len(noise) and len(rec["permutation"]) == 2 * len(perms)
    np.testing.assert_array_equal(np.stack(rec["normal"][len(noise):]), noise)
    np.testing.assert_array_equal(np.stack(rec["permutation"][len(perms):]), perms)
    assert meta["launch0_vs_state_max_abs"] == 0.0
    assert meta["action_vs_noise_max_abs"] < 1e-6


def test_export_launches_are_the_jax_envs(paired):
    out = paired[0]
    launches = np.load(os.path.join(out, "launches.npy"))
    cfg, env, _, _, state, _ = X.build(NE, 42, OVERRIDES)
    ba = env.ball_actor
    np.testing.assert_array_equal(np.asarray(state.sim.root[:, ba, 7:10]), launches[:, 0])
    step = jax.jit(env.step_fn)
    count = np.zeros(NE, np.int64)
    for _ in range(EPOCHS * H):
        state, _, _, done, _ = step(state, jnp.zeros((NE, 7)))
        done = np.asarray(done).astype(bool)
        count += done
        for i in np.nonzero(done)[0]:
            np.testing.assert_array_equal(np.asarray(state.sim.root[i, ba, 7:10]),
                                          launches[i, count[i]])
    assert (count == 3).all() and launches.shape[1] > 3


def test_port_fed_the_export_matches_the_jax_epochs(paired):
    out, _, jax_epochs = paired
    meta, env, trainer, ts, state, obs, draws = kl_pair.build(out, "cpu", dtype=torch.float32)
    batches = []
    real = trainer._update
    trainer._update = lambda ts_, b, s: (batches.append(b), real(ts_, b, s))[1]
    for it, rec, ts, state, obs in kl_pair.epochs_run(trainer, ts, state, obs, draws, EPOCHS):
        j, pb = jax_epochs[it], batches[-1]
        for k, tol in (("obs", 1e-3), ("action", 5e-4), ("logp", 5e-4), ("mu", 5e-4),
                       ("sigma", 5e-4), ("value_n", 5e-4), ("returns_n", 5e-4),
                       ("adv", 5e-4)):
            np.testing.assert_allclose(pb[k].numpy(), j["batch"][k], rtol=0, atol=tol,
                                       err_msg=f"epoch {it} {k}")
        assert set(rec) == set(j["metrics"])
        for k in rec:
            np.testing.assert_allclose(rec[k], j["metrics"][k], rtol=1e-3, atol=1e-4,
                                       err_msg=f"epoch {it} {k}")
        for got, want in ((ts.obs_stats, j["obs_stats"]), (ts.value_stats, j["value_stats"])):
            for f in got._fields:
                np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                           rtol=1e-4, atol=1e-5, err_msg=f"epoch {it} {f}")
        got = {n: q.detach().numpy() for n, q in ts.params.named_parameters()}
        want = actor_critic_from_jax(j["params"])
        for n in got:
            d = np.abs(got[n].astype(np.float64) - np.asarray(want[n], np.float64)) / LR
            assert d.max() <= 2.0 * 5 * (NE * H // MB), f"epoch {it} {n}: {d.max():.2e} lr"
            assert np.median(d) <= 2e-2, f"epoch {it} {n}: median {np.median(d):.2e} lr"
    assert draws.resets.tolist() == [3] * NE
    assert draws.n_noise == EPOCHS * H and draws.n_perm == EPOCHS * 5


def test_kl_pair_command_writes_both_runs(paired, tmp_path):
    out = paired[0]
    path = str(tmp_path / "kl.json")
    assert kl_pair.main([out, "--device", "cpu", "--epochs", "1", "--out", path]) == 0
    with open(path) as f:
        doc = json.load(f)
    assert doc["config"]["num_envs"] == NE
    assert len(doc["runs"]["jax_cpu"]["records"]) == EPOCHS
    (rec,) = doc["runs"]["port_cpu"]["records"]
    assert rec["epoch"] == 0 and np.isfinite(rec["kl"]) and np.isfinite(rec["kl_first_minibatch"])
    assert rec["resets_per_env"] == 1
