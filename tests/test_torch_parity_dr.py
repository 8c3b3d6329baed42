"""The parity tool's DR rows (``parity/env_step.py`` on
``tools/torch_parity_export.py --dr`` files): the port's env step under
domain randomization against the JAX package's, with every JAX draw
replayed (each env's ``DRParams``, the action and observation noise, the
fresh parameters drawn for every env), and the port's new ``DRParams`` held
bit for bit to the JAX step's on every env whose done flag agrees.

* The committed fixture (``parity/data/<task>_dr.npz``: the first 64 envs of
  states 3, 7, 11 and 15 of the gates'-width exports, the last with half the
  envs resetting and every env's ``randomize_buf`` at ``frequency - 1``, so
  those envs draw new parameters) of the flagship (K2-dr), C8 and C10 (the
  non-kernel step under DR) passes its task's gate row on the CPU, with no
  flip, no DR mismatch and no kernel launch counted (the CPU runs the plain
  versions).
* The exporter on the CPU: the JAX flagship under DR at 16 envs, 20 steps
  kept every 10th, each kept state stepped once; the port passes the file.
* The gates bite: the same fixture with the DR parameters at the identity,
  with the noise dropped, or with the fresh draw equal to the old
  parameters (the redraw dropped), fails on each task.
* The port's randomizer under the replay hands out the JAX draws and
  nothing else.
"""

import json
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

from isaacgym_tpu_torch.parity import env_step as E
from tools import torch_parity_export as X

DATA = os.path.join(os.path.dirname(E.__file__), "data")
NAMES = ("flagship_dr", "c8_dr", "c10_dr")


def _path(name):
    return os.path.join(DATA, f"{name}.npz")


@pytest.mark.parametrize("name", NAMES)
def test_fixture_holds_the_draws_at_full_strength(name):
    meta, a = E.load(_path(name))
    assert meta["dr"] and meta["name"] == name and meta["num_envs"] == 64
    assert meta["dr_global_step"] == X.DR_GLOBAL_STEP
    assert (a["in.global_step"] >= X.DR_GLOBAL_STEP).all()
    assert (a["in.randomize_buf"][-1] == 599).all() and a["out.done"][-1].sum() >= 32
    assert np.abs(a["draw.action_noise"]).max() > 0 and np.abs(a["draw.obs_noise"]).max() > 0
    assert np.abs(a["in.dr.kp_scale"] - 1).max() > 0.3     # full strength, not the identity
    redrawn = a["out.done"][-1].astype(bool)
    assert np.abs(a["out.dr.kp_scale"][-1][redrawn] - a["in.dr.kp_scale"][-1][redrawn]).min() > 0
    assert (a["out.dr.kp_scale"][-1][~redrawn] == a["in.dr.kp_scale"][-1][~redrawn]).all()
    # the fresh draw covers every env; the redrawn envs kept it
    for f in ("gravity_offset", "mass_scale", "kp_scale", "upper_shift"):
        fresh, new, old = a[f"draw.dr.{f}"][-1], a[f"out.dr.{f}"][-1], a[f"in.dr.{f}"][-1]
        assert fresh.shape == old.shape
        assert (fresh != old).reshape(len(old), -1).any(axis=1).all()
        assert (new[redrawn] == fresh[redrawn]).all()


@pytest.mark.parametrize("name,route", [("flagship_dr", "k2"), ("c8_dr", "k3"),
                                        ("c10_dr", "k4")])
def test_port_passes_the_dr_fixture_on_the_cpu(name, route):
    res = E.check(_path(name), "cpu")
    assert res["gate"] == "PASS", res["gate_failures"]
    assert res["dr"] and res["route"] == route and res["env_steps_compared"] == 256
    assert res["contact_flips"] == res["event_flips"] == res["reset_flips"] == 0
    assert res["dr_mismatches"] == 0
    assert res["resets"] >= 32 and res["kernel_launches"] == 0


@pytest.mark.parametrize("form", sorted(E.DR_WRONG_INPUTS))
@pytest.mark.parametrize("name", NAMES)
def test_wrong_dr_inputs_fail_the_gates(name, form):
    res = E.check(_path(name), "cpu", mutate_inputs=E.DR_WRONG_INPUTS[form])
    assert res["gate"] == "FAIL", res


def test_exporter_on_the_cpu_and_the_port_on_its_file(tmp_path, monkeypatch):
    monkeypatch.setattr(X, "STEPS", 20)
    monkeypatch.setattr(X, "FIXTURE_STATES", (0, 1))
    meta = X.export_task("flagship", str(tmp_path), fixture_dir=str(tmp_path / "fx"), dr=True,
                         width=16, log=lambda *a, **k: None)
    assert meta["dr"] and meta["states"] == 2 and meta["num_envs"] == 16
    res = E.check(str(tmp_path / "flagship_dr.npz"), "cpu")
    assert res["gate"] == "PASS" and res["resets"] == 8, res
    fx = json.loads(str(np.load(tmp_path / "fx" / "flagship_dr.npz")["meta_json"]))
    assert fx["fixture_of_states"] == [0, 1]


def test_replay_randomizer_hands_out_the_given_draws():
    from isaacgym_tpu_torch.env.randomize import DomainRandomizer, identity_params
    replay = E.ReplayRandomizer(DomainRandomizer({"frequency": 600}, 7))
    dr = identity_params(7, 4)
    an, on = torch.randn(4, 7), torch.randn(4, 80)
    replay.draws = dict(dr=dr, action_noise=an, obs_noise=on)
    assert replay.sample(None, 3000, 4) is dr and replay.frequency == 600
    x = torch.randn(4, 7)
    assert torch.equal(replay.action_noise(None, x), x + an)
    assert torch.equal(replay.observation_noise(None, torch.zeros(4, 80)), on)
