"""The port's tensor-parallel trunks (``parallel/mesh.py`` ``device_mesh``,
``shard_params_tp`` on DTensor's ``parallelize_module``;
``parallel/tensor_parallel.py``) on the CPU over gloo.

The JAX package's ``tests/test_distributed.py:43-63`` runs a PPO epoch with
the trunks sharded over ``mdl`` and checks it is finite and the kernels stay
sharded. Here the sharded epoch is held to the one-process epoch of the
port, whose unsharded epoch is itself held to the JAX package's epoch
(``tests/test_torch_ppo_epoch.py``):

* placements on a ``(1, 2)`` mesh: even trunk layers cut along the torch
  weight's dim 0, odd ones along dim 1, heads and ``log_sigma`` whole; with
  ``mdl == 1`` every parameter replicated and nothing cut;
* two processes, ``dp 1 x mdl 2``, units (64, 64), 8 envs, horizon 4,
  minibatch 16, two mini-epochs, float32 trunks: the first minibatch's
  reduced gradients within 1e-5 of the one-process epoch's, relative to the
  gradient's largest entry (a tensor of small sums such as ``log_sigma``'s,
  ~1e-9, is held to the same absolute bound), the epoch's metrics within 1e-4 relative (1e-6
  absolute), the gathered parameters after the update within the
  data-parallel test's tolerance (``atol=2e-5, rtol=2e-4``), the clip's
  global norm of the first minibatch within 1e-5 of the whole gradient's
  (not one rank's shards), and the layers still cut after the update;
* four processes, ``dp 2 x mdl 2`` at units (32, 32, 32), a trunk that
  ends on a column-parallel layer and gathers its output: the ranks of one
  ``dp`` index draw alike (bit-equal metrics and parameters), and the run
  equals the one-process epoch on the 8 envs within the same tolerances.

Float32 trunks, here and in the card's ``tp/flagship`` (``chip_smoke.py``):
in bfloat16 each rank's partial product is rounded before the sum over
``mdl``. The bfloat16 sharded epoch, the dtype the flagship trains in, is
held to no one-process epoch yet (ROADMAP §3).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "HumanoidPingpongTiltNoEarlyStopG1"
BASE = [f"task={TASK}", "num_envs=8", "task.env.episodeLength=8", "seed=5", "device=cpu",
        "train.params.config.horizon_length=4", "train.params.config.minibatch_size=16",
        "train.params.config.mini_epochs=2"]
GRAD_RTOL, METRIC_RTOL, METRIC_ATOL = 1e-5, 1e-4, 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(out, world, args, module="isaacgym_tpu_torch.parallel.tensor_parallel"):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen([sys.executable, "-m", module, *args, f"out={out}"],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-4000:]
    return [json.load(open(os.path.join(out, f"result_rank{r}.json"))) for r in range(world)]


def _one_process(units):
    """The one-process epoch: its metrics, first reduced gradients and
    parameters after the update, by name."""
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose, preprocess_train_config
    cfg = compose(TASK, BASE[1:] + [f"train.params.network.mlp.units={units}"])
    preprocess_train_config(cfg)
    env = isaacgym_tpu_torch.make(seed=5, task=TASK, device="cpu", cfg=cfg["task"])
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=5,
                         compute_dtype=torch.float32)
    ts = trainer.init_state()
    names = [n for n, _ in ts.params.named_parameters()]
    first = {}

    def record(grads, aux):
        if not first:
            first.update({n: g.detach().clone() for n, g in zip(names, grads)})
        return grads, aux
    trainer._reduce_grads = record
    state, obs = env.reset()
    ts, state, obs, metrics = trainer.train_epoch(ts, state, obs)
    params = {n: p.detach().clone() for n, p in ts.params.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, first, params


def _assert_matches_one_process(out, results, one):
    metrics, first, params = one
    got = np.load(os.path.join(out, "params_rank0.npz"))
    from isaacgym_tpu_torch.rl.ppo import global_norm
    scale = max(float(g.abs().max()) for g in first.values())
    norm = float(global_norm(list(first.values())))
    for r in results:
        assert abs(r["first_grad_norm"] - norm) <= GRAD_RTOL * norm, (r["first_grad_norm"], norm)
    for n, g in first.items():
        np.testing.assert_allclose(got[f"grad0.{n}"], g.numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=n)
    for n, p in params.items():
        np.testing.assert_allclose(got[f"param.{n}"], p.numpy(), atol=2e-5, rtol=2e-4,
                                   err_msg=n)
    for r in results:
        for k, v in metrics.items():
            assert abs(r["metrics"][k] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v), (k, r["rank"])


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    args = BASE + ["train.params.network.mlp.units=[64,64]", "model_parallel=2", "epochs=1",
                   "backend=gloo", "compute_dtype=float32"]
    return out, _spawn(out, 2, args)


def test_placements_on_a_1x2_mesh_survive_the_update(tp_run):
    _, results = tp_run
    for r in results:
        assert (r["dp"], r["mdl"], r["mdl_index"]) == (1, 2, r["rank"])
        place, shapes = r["placements"], r["local_shapes"]
        for trunk in ("actor_mlp", "critic_mlp"):
            assert place[f"{trunk}.layers.0.weight"] == ["shard", 0]
            assert place[f"{trunk}.layers.0.bias"] == ["shard", 0]
            assert place[f"{trunk}.layers.1.weight"] == ["shard", 1]
            assert place[f"{trunk}.layers.1.bias"] == ["replicate"]
            assert shapes[f"{trunk}.layers.0.weight"] == [32, 80]
            assert shapes[f"{trunk}.layers.1.weight"] == [64, 32]
        for head in ("mu.weight", "mu.bias", "value.weight", "value.bias", "log_sigma"):
            assert place[head] == ["replicate"]
        assert shapes["mu.weight"] == [7, 64]


def test_sharded_epoch_equals_one_process(tp_run):
    out, results = tp_run
    _assert_matches_one_process(out, results, _one_process("[64,64]"))


def test_ranks_gather_equal_logical_params(tp_run):
    out, _ = tp_run
    a, b = (np.load(os.path.join(out, f"params_rank{r}.npz")) for r in range(2))
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mdl_one_replicates():
    """``shard_params_tp`` on a ``(1, 1)`` mesh in one gloo process: nothing
    cut, every parameter kept."""
    import torch.distributed as dist
    from isaacgym_tpu_torch.parallel import mesh as M
    from isaacgym_tpu_torch.parallel.tensor_parallel import placements
    from isaacgym_tpu_torch.rl.networks import ActorCritic
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        dm = M.device_mesh(1, device_type="cpu")
        assert dm.mesh_dim_names == ("dp", "mdl") and tuple(dm.shape) == (1, 1)
        net = ActorCritic(80, 7, units=(16, 16))
        before = {n: p.detach().clone() for n, p in net.named_parameters()}
        assert M.shard_params_tp(net, dm) is net
        assert set(v[0] for v in placements(net).values()) == {"replicate"}
        for n, p in net.named_parameters():
            assert torch.equal(p, before[n])
    finally:
        dist.destroy_process_group()


def test_dp2_x_mdl2_keys_draws_by_dp_index(tmp_path):
    out = str(tmp_path)
    args = BASE + ["train.params.network.mlp.units=[32,32,32]", "model_parallel=2",
                   "epochs=1", "backend=gloo", "compute_dtype=float32"]
    results = _spawn(out, 4, args)
    assert results[0]["placements"]["actor_mlp.layers.2.weight"] == ["shard", 0]
    assert [(r["dp_index"], r["mdl_index"]) for r in results] == [(0, 0), (0, 1), (1, 0),
                                                                  (1, 1)]
    for d in range(2):
        a, b = results[2 * d], results[2 * d + 1]
        assert a["metrics"] == b["metrics"] and a["envs_per_rank"] == 4
    p = [np.load(os.path.join(out, f"params_rank{r}.npz")) for r in range(4)]
    for k in p[0].files:
        for r in range(1, 4):
            np.testing.assert_array_equal(p[0][k], p[r][k], err_msg=k)
    _assert_matches_one_process(out, results, _one_process("[32,32,32]"))
