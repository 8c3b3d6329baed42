"""The port's viewer (``isaacgym_tpu_torch/viewer/``) against the JAX
package's (``isaacgym_tpu/viewer/``).

For the same body states (a port rollout of the flagship at 4 envs), the
port's trajectory npz has the JAX recorder's keys, shapes, dtypes and
values, and the port's ``render_frames`` draws the JAX one's frames bit for
bit from the same npz. ``joint_monkey`` is deterministic on the port's FK,
the live viewer answers its endpoints from a file and from a live port env,
and the mp4 and gif writers work as ``tests/test_render.py`` checks them.
No JAX env step is compiled: the JAX recorder is fed the port's states.
"""

import os
import threading
import urllib.request

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs in several workers: one intra-op thread each

import isaacgym_tpu_torch
from isaacgym_tpu.viewer import render as JR
from isaacgym_tpu.viewer.trajectory import TrajectoryRecorder as JRecorder
from isaacgym_tpu_torch.viewer import joint_monkey, render as R
from isaacgym_tpu_torch.viewer.trajectory import TrajectoryRecorder, record_env_rollout

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
STEPS = 12


@pytest.fixture(scope="module")
def npzs(tmp_path_factory):
    """(port npz, JAX npz, env): both recorders fed the port's rollout, with
    markers, lines (ragged, then cleared) and an extra stream."""
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=4, device="cpu",
                                  episodeLength=40)
    d = tmp_path_factory.mktemp("traj")
    from isaacgym_tpu.sim.scene import compile_scene
    from isaacgym_tpu.tasks.pingpong_common import build_pingpong_scene
    from isaacgym_tpu_torch.utils.config import load_task_config
    cfg = load_task_config(TASK)
    jscene = compile_scene(build_pingpong_scene(cfg["env"], cfg["sim"]))
    rec = TrajectoryRecorder(env.scene.body_names, max_envs=2, scene=env.scene)
    jrec = JRecorder(jscene.body_names, max_envs=2, scene=jscene)
    gen = torch.Generator().manual_seed(1)
    state, obs = env.reset()
    for t in range(STEPS):
        rb = env.sim.rigid_body_states(state.sim)
        ball = state.sim.root[:, env.ball_actor, :]
        if t == 3:
            for r in (rec, jrec):
                r.add_lines(np.float32([[[0, 0, 1], [1, 0, 1]], [[1, 1, 1], [2, 0, 1]]]))
        if t == 6:
            for r in (rec, jrec):
                r.add_lines(np.float32([0, 0, 0, 0, 0, 2]), colors=np.float32([0, 1, 0]))
        if t == 9:
            for r in (rec, jrec):
                r.clear_lines()
        rec.record(rb, markers=ball[:, None, :3], ball=ball)
        jrec.record(rb.numpy(), markers=ball[:, None, :3].numpy(), ball=ball.numpy())
        state, obs, *_ = env.step(state, torch.rand((4, 7), generator=gen) * 2 - 1)
    return rec.save(str(d / "port.npz")), jrec.save(str(d / "jax.npz")), env


def test_trajectory_npz_equals_the_jax_recorder_s(npzs):
    p, jp, env = npzs
    got, want = dict(np.load(p)), dict(np.load(jp))
    assert set(got) == set(want) == {"body_states", "body_names", "geoms", "markers", "lines",
                                     "line_colors", "extra_ball"}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["body_states"].shape == (STEPS, 2, env.scene.num_bodies, 13)
    assert np.isfinite(got["body_states"]).all()
    np.testing.assert_array_equal(R.scene_geom_table(env.scene), got["geoms"])


def test_render_frames_equal_the_jax_renderer_bit_for_bit(npzs):
    p, _, _ = npzs
    data = dict(np.load(p))
    kw = dict(size=(160, 90), lines=data["lines"], line_colors=data["line_colors"])
    bs, mk = data["body_states"][:, 0], data["markers"][:, 0]
    frames = list(R.render_frames(bs, data["geoms"], mk, **kw))
    want = list(JR.render_frames(bs, data["geoms"], mk, **kw))
    assert len(frames) == STEPS
    for f, w in zip(frames, want):
        np.testing.assert_array_equal(f, w)
    assert frames[0].std() > 5.0


@pytest.mark.parametrize("ext,size,min_bytes", ((".mp4", (320, 180), 2000),
                                                (".gif", (160, 90), 1000)))
def test_video_writers(npzs, tmp_path, ext, size, min_bytes):
    p, _, _ = npzs
    out = str(tmp_path / f"c7{ext}")
    R.render_trajectory(p, out, fps=30, size=size, env=1)
    assert os.path.getsize(out) > min_bytes
    if ext == ".mp4":
        import cv2
        cap = cv2.VideoCapture(out)
        ok, frame = cap.read()
        cap.release()
        assert ok and frame.std() > 5.0
        cli = str(tmp_path / "cli.mp4")
        R.main([p, cli, "--fps", "30", "--width", "256", "--height", "144"])
        assert os.path.exists(cli)


def test_record_env_rollout(tmp_path):
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=2, device="cpu",
                                  episodeLength=16)
    record_env_rollout(env, steps=5, out_path=str(tmp_path / "traj.npz"))
    data = np.load(tmp_path / "traj.npz")
    assert data["body_states"].shape == (5, 1, 42, 13)
    assert data["extra_ball"].shape == (5, 1, 13) and len(data["body_names"]) == 42


def test_joint_monkey_runs_animates_and_is_deterministic():
    a = joint_monkey.run(steps=25, seed=3, device="cpu").stacked()
    assert a.shape == (25, 1, 83, 13) and np.isfinite(a).all()
    assert np.abs(a[-1, 0, :40, 0:3] - a[0, 0, :40, 0:3]).max() > 1e-3
    np.testing.assert_array_equal(a, joint_monkey.run(steps=25, seed=3, device="cpu").stacked())


def _get(port, path):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60).read()


@pytest.mark.parametrize("source", ("npz", "live"))
def test_live_viewer_endpoints(npzs, source):
    from isaacgym_tpu_torch.viewer.live import serve, serve_live
    httpd = (serve(npzs[0], port=0) if source == "npz"
             else serve_live(TASK, device="cpu", port=0))
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        assert b"<img" in _get(port, "/")
        assert b'"T"' in _get(port, "/meta")
        jpg1 = _get(port, "/frame?t=1&az=-60&el=30&dist=3.5")
        jpg2 = _get(port, "/frame?t=2&az=20&el=10&dist=5.0")
        assert jpg1[:2] == jpg2[:2] == b"\xff\xd8" and jpg1 != jpg2
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/nope")
    finally:
        httpd.shutdown()
        httpd.server_close()
