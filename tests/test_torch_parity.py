"""The port's parity tool (``isaacgym_tpu_torch.parity.env_step``) and its
committed fixture (``isaacgym_tpu_torch/parity/data/``, written by
``tools/torch_parity_export.py``: 64 envs x 4 states of each task, the last
with half the envs at the episode boundary).

* The port's ``GATES`` is ``tools/parity_tpu.py``'s, and each file takes the
  row its docstring names.
* The flagship fixture's outputs are the JAX env step's on its inputs: the
  JAX package steps them again here, outside flips to 1e-5.
* The port on the CPU passes the fixture for the flagship and C5 (its plain
  K2) and C11 (its plain K3, both balls' launches injected); the card runs
  every task's fixture in ``chip_smoke.py``.
* Wrong forms fail the tool: the port's dof velocities negated, or one
  env's done flag flipped with nothing else changed; and the command exits
  non-zero on a file whose rewards were moved.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each
import jax
import jax.numpy as jnp

import isaacgym_tpu
from isaacgym_tpu_torch.parity import env_step as E
from tools.parity_tpu import GATES as JAX_GATES

DATA = os.path.join(os.path.dirname(E.__file__), "data")
NAMES = ("flagship", "c5", "c6", "c8", "c9", "c10", "terrain", "c11")
C6, C10, FLAGSHIP = ("HumanoidPingpongTiltG1", "HumanoidPingpongTiltNESSparse27DOFG1",
                     "HumanoidPingpongTiltNoEarlyStopG1")


def _path(name):
    return os.path.join(DATA, f"{name}.npz")


def test_gates_are_the_jax_tools():
    assert E.GATES == JAX_GATES


@pytest.mark.parametrize("name", NAMES)
def test_fixture_file_and_its_gate_row(name):
    meta, arrays = E.load(_path(name))
    assert meta["name"] == name and meta["num_envs"] == 64 and meta["states"] == 4
    assert os.path.getsize(_path(name)) < 600_000
    S, B = 4, 64
    assert arrays["action"].shape == (S, B, meta["num_actions"])
    assert arrays["out.obs"].shape == (S, B, meta["num_obs"])
    assert arrays["out.done"][-1].sum() >= B // 2     # the boundary state resets
    row = E.gate_for(name, meta["task"])
    want = {"c5": C6, "c9": C6, "terrain": FLAGSHIP}.get(name, meta["task"])
    expect = dict(JAX_GATES[want], **({"max_obs": 150.0} if want == C10 else {}))
    assert row == expect


def test_flagship_fixture_is_the_jax_env_step():
    meta, a = E.load(_path("flagship"))
    env = isaacgym_tpu.make(seed=0, task=meta["task"], num_envs=meta["num_envs"])
    step = jax.jit(env.step_fn)
    state, _ = env.reset()
    ba = env.ball_actor
    for i in range(meta["states"]):
        pick = lambda p: {k[len(p):]: jnp.asarray(v[i]) for k, v in a.items() if k.startswith(p)}
        s = state._replace(sim=state.sim._replace(**pick("in.sim.")), flags=pick("in.flags."),
                           progress=jnp.asarray(a["in.progress"][i]),
                           pre_ball_root=jnp.asarray(a["in.pre_ball_root"][i]),
                           ep_return=jnp.asarray(a["in.ep_return"][i]),
                           rng=jnp.asarray(a["in.rng"][i]))
        s2, obs, rew, done, _ = step(s, jnp.asarray(a["action"][i]))
        keep = np.asarray(done) == a["out.done"][i]
        root = np.asarray(s2.sim.root)
        keep &= np.abs(root - a["out.sim.root"][i]).reshape(len(keep), -1).max(1) <= 0.1
        assert keep.mean() > 0.95
        for got, want in ((root, a["out.sim.root"][i]), (s2.sim.dof_pos, a["out.sim.dof_pos"][i]),
                          (s2.sim.dof_vel, a["out.sim.dof_vel"][i]), (obs, a["out.obs"][i]),
                          (rew, a["out.reward"][i])):
            np.testing.assert_allclose(np.asarray(got)[keep], want[keep], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(root[:, ba][np.asarray(done)],
                                      a["out.sim.root"][i][:, ba][np.asarray(done)])


@pytest.mark.parametrize("name,route", [("flagship", "k2"), ("c5", "k2"), ("c11", "k3")])
def test_port_passes_the_fixture_on_the_cpu(name, route):
    res = E.check(_path(name), "cpu")
    assert res["gate"] == "PASS", res["gate_failures"]
    assert res["env_steps_compared"] == 256 and res["resets"] >= 32 and res["route"] == route
    assert res["unmoved_resets"] == 0


@pytest.mark.parametrize("form", sorted(E.WRONG_FORMS))
def test_wrong_forms_fail_the_tool(form):
    res = E.check(_path("flagship"), "cpu", mutate=E.WRONG_FORMS[form])
    assert res["gate"] == "FAIL", res


def test_command_exits_non_zero_on_a_failing_file(tmp_path):
    shutil.copy(_path("flagship"), tmp_path / "flagship.npz")
    assert E.main([str(tmp_path), "--device", "cpu"]) == 0
    meta, arrays = E.load(_path("flagship"))
    arrays["out.reward"] = arrays["out.reward"] + 100.0
    np.savez_compressed(tmp_path / "flagship.npz", meta_json=np.asarray(json.dumps(meta)),
                        **arrays)
    assert E.main([str(tmp_path), "--device", "cpu"]) == 1
