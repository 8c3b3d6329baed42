"""The port's data-parallel PPO epoch (``parallel/``) on the CPU.

Two processes joined over gloo (``python -m isaacgym_tpu_torch.parallel.
data_parallel``, started as ``torchrun`` starts its ranks), each with 4 of
8 envs of the flagship, train two epochs (units (64, 64), horizon 4,
minibatch 16, two mini-epochs, episodes of 8 steps, so the envs reset
inside the run): the setting ``tests/test_multiprocess.py`` pins for the
JAX package. Both ranks end with bit-equal parameters, equal to one process
on the 8 envs within the JAX test's tolerance (``atol=2e-5, rtol=2e-4``),
and only rank 0 writes the metrics, the config and the checkpoint. The
launcher as two ranks trains a replica on each, rank 0 alone writing. A
rank's env draws its rows of the global draws (the flagship with DR, C11,
C10). Also
``make_mesh``'s shape arithmetic and the env-batch placement by rank.
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

from isaacgym_tpu_torch.parallel import mesh
from isaacgym_tpu_torch.parallel.data_parallel import flat_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "HumanoidPingpongTiltNoEarlyStopG1"
ARGS = [f"task={TASK}", "num_envs=8", "task.env.episodeLength=8", "seed=5", "device=cpu",
        "train.params.network.mlp.units=[64,64]", "train.params.config.horizon_length=4",
        "train.params.config.minibatch_size=16", "train.params.config.mini_epochs=2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ddp"))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "isaacgym_tpu_torch.parallel.data_parallel", *ARGS,
             "epochs=2", "backend=gloo", f"out={out}"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-4000:]
    return out


def test_ranks_end_bit_equal(two_process_run):
    p0 = np.load(os.path.join(two_process_run, "params_rank0.npy"))
    p1 = np.load(os.path.join(two_process_run, "params_rank1.npy"))
    np.testing.assert_array_equal(p0, p1)
    for rank in range(2):
        r = json.load(open(os.path.join(two_process_run, f"result_rank{rank}.json")))
        assert (r["world_size"], r["envs_per_rank"]) == (2, 4) and np.isfinite(r["a_loss"])


def test_two_processes_equal_one_process(two_process_run):
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose, preprocess_train_config
    cfg = compose(TASK, ARGS[1:])
    preprocess_train_config(cfg)
    env = isaacgym_tpu_torch.make(seed=5, task=TASK, device="cpu", cfg=cfg["task"])
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=5)
    ts = trainer.init_state()
    state, obs = env.reset()
    for _ in range(2):
        ts, state, obs, metrics = trainer.train_epoch(ts, state, obs)
    assert float(metrics["episode_count"]) > 0   # the envs reset inside the run
    dist = np.load(os.path.join(two_process_run, "params_rank0.npy"))
    np.testing.assert_allclose(dist, flat_params(ts), atol=2e-5, rtol=2e-4)


def test_only_rank_zero_writes(two_process_run):
    files = sorted(os.listdir(two_process_run))
    assert files == ["ckpt_final.pt", "config.json", "metrics.jsonl", "params_rank0.npy",
                     "params_rank1.npy", "result_rank0.json", "result_rank1.json"]
    rows = [json.loads(x) for x in open(os.path.join(two_process_run, "metrics.jsonl"))]
    assert [r["epoch"] for r in rows] == [0, 1]


def test_launcher_ranks_train_replicas_and_rank_zero_writes(tmp_path):
    """``python -m isaacgym_tpu_torch.train`` as two ranks (the environment
    ``torchrun`` sets, gloo): each trains its own replica, rank 0 alone
    writes the run directory and the console log."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "isaacgym_tpu_torch.train", *ARGS, "max_iterations=2",
             "experiment=ranks", "log_every=1"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-4000:]
    run = tmp_path / "runs" / "ranks"
    assert sorted(os.listdir(run)) == ["ckpt_final.pt", "config.json", "metrics.jsonl"]
    assert [json.loads(x)["epoch"] for x in open(run / "metrics.jsonl")] == [0, 1]
    assert "seed 5" in outs[0] and "epoch      1" in outs[0]
    assert "training" not in outs[1] and "epoch " not in outs[1]


@pytest.mark.parametrize("task,dr", [(TASK, True), ("HumanoidPingpong5ActorG1", False),
                                     ("HumanoidPingpongTiltNESSparse27DOFG1", False)])
def test_sharded_draws_are_the_global_draws_rows(task, dr):
    """Each rank's env (4 of 8 envs) resets and steps as its rows of the
    one-process env: ball launches (C11's two balls), C10's ball starts,
    the DR parameters and their action and observation noise."""
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.parallel.data_parallel import shard_draws
    from isaacgym_tpu_torch.utils.config import compose
    ov = ["device=cpu"] + (["task.randomize=true"] if dr else [])
    full = isaacgym_tpu_torch.make(seed=3, task=task, device="cpu",
                                   cfg=compose(task, ["num_envs=8"] + ov)["task"])
    state, obs = full.reset()
    act = torch.zeros((8, full.num_actions))
    state, obs, *_ = full.step(state, act)
    for rank in range(2):
        part = shard_draws(isaacgym_tpu_torch.make(
            seed=3, task=task, device="cpu", cfg=compose(task, ["num_envs=4"] + ov)["task"]),
            rank, 2)
        s, o = part.reset()
        s, o, *_ = part.step(s, act[:4])
        rows = slice(4 * rank, 4 * rank + 4)
        for a, b in zip(s.sim, state.sim):
            torch.testing.assert_close(a, b[rows], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(o, obs[rows], rtol=1e-6, atol=1e-6)
        if dr:
            assert all(torch.equal(a, b[rows]) for a, b in zip(s.dr, state.dr))


def test_mesh_shape_and_placement():
    assert mesh.make_mesh(8) == {"dp": 8, "mdl": 1}
    assert mesh.make_mesh(8, model_parallel=2) == {"dp": 4, "mdl": 2}
    with pytest.raises(ValueError):
        mesh.make_mesh(6, model_parallel=4)
    tree = {"x": torch.arange(8.0).reshape(4, 2), "step": torch.tensor(3),
            "nested": (torch.arange(4), None)}
    part = mesh.shard_env_tree(tree, rank=1, world_size=2)
    assert part["x"].tolist() == [[4.0, 5.0], [6.0, 7.0]]
    assert part["step"].item() == 3 and part["nested"][0].tolist() == [2, 3]
    assert part["nested"][1] is None
    assert mesh.replicate_tree(tree) is tree or mesh.replicate_tree(tree)["x"].equal(tree["x"])
    assert mesh.world() == (0, 1, 0)
    assert mesh.init_distributed("gloo") == (0, 1, 0)   # one process joins nothing
