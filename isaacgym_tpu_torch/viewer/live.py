"""Interactive viewer, the interactive half of the viewer capability
(``isaacgym_tpu/viewer/live.py``; the reference's ``create_viewer``,
``draw_viewer``, ``viewer_camera_look_at`` and ``sync_frame_time``).

Without a display server "interactive" means a local HTTP viewer: the
offline renderer's software rasterizer (``viewer.render``, on the host),
with an orbit camera (mouse drag), zoom (wheel), frame scrubbing and
playback. Two sources:

  # a recorded trajectory
  python -m isaacgym_tpu_torch.viewer.live traj.npz [--port 8008] [--env 0]

  # a live sim: the port's env steps as the playhead advances; an optional
  # policy checkpoint of the port's launcher, else zero actions
  python -m isaacgym_tpu_torch.viewer.live --task HumanoidPingpongTiltNoEarlyStopG1 \
      [--checkpoint runs/exp/ckpt_final.pt] [--device cpu] [--port 8008]

The live sim steps on the card unless ``--device cpu``. Frames are rendered
on demand (one JPEG per request, through ``cv2``); in live mode stepping
happens lazily as the playhead advances, and frames already simulated stay
scrubbable from a buffer.
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from isaacgym_tpu_torch.models import urdf as U
from isaacgym_tpu_torch.viewer.render import render_frames

_PAGE = """<!doctype html>
<html><head><title>isaacgym_tpu_torch viewer</title><style>
 body { margin:0; background:#1b1d23; color:#d7dae0; font:13px sans-serif;
        display:flex; flex-direction:column; align-items:center; }
 #frame { margin-top:10px; border:1px solid #333; cursor:grab; }
 #bar { width:960px; display:flex; gap:10px; align-items:center; padding:8px 0; }
 #t { flex:1; }
 button { background:#2a2d36; color:#d7dae0; border:1px solid #444;
          padding:4px 12px; cursor:pointer; }
</style></head><body>
<img id="frame" width="960" height="540" draggable="false"/>
<div id="bar">
  <button id="play">&#9654;</button>
  <input type="range" id="t" min="0" max="0" value="0"/>
  <span id="label"></span>
</div>
<div>drag: orbit &nbsp; wheel: zoom &nbsp; space: play/pause &nbsp;
     arrows: step</div>
<script>
let T=1, t=0, az=-47, el=26, dist=4.2, playing=false, dragging=false,
    lx=0, ly=0, inflight=false, dirty=true;
const img=document.getElementById('frame'), slider=document.getElementById('t'),
      label=document.getElementById('label'), playBtn=document.getElementById('play');
function meta(){fetch('/meta').then(r=>r.json()).then(m=>{
  if(m.T!==T){T=m.T; slider.max=T-1; dirty=true;}});}
meta(); setInterval(meta, 2000);  // live-sim sources grow T as they step
function url(){return `/frame?t=${t}&az=${az.toFixed(1)}&el=${el.toFixed(1)}&dist=${dist.toFixed(2)}`;}
function tick(){
  if((dirty||playing) && !inflight){
    if(playing){ t=(t+1)%T; slider.value=t; }
    dirty=false; inflight=true;
    const u=url();
    const pre=new Image();
    pre.onload=()=>{ img.src=pre.src; inflight=false;
                     label.textContent=`${t}/${T-1}`; };
    pre.onerror=()=>{ inflight=false; };
    pre.src=u;
  }
  requestAnimationFrame(tick);
}
tick();
img.addEventListener('mousedown',e=>{dragging=true;lx=e.clientX;ly=e.clientY;});
window.addEventListener('mouseup',()=>dragging=false);
window.addEventListener('mousemove',e=>{
  if(!dragging) return;
  az-=(e.clientX-lx)*0.4; el=Math.max(-85,Math.min(85,el+(e.clientY-ly)*0.3));
  lx=e.clientX; ly=e.clientY; dirty=true;});
img.addEventListener('wheel',e=>{e.preventDefault();
  dist=Math.max(0.5,Math.min(20,dist*(e.deltaY>0?1.1:0.9))); dirty=true;});
slider.addEventListener('input',()=>{t=+slider.value; dirty=true;});
playBtn.addEventListener('click',()=>{playing=!playing;
  playBtn.innerHTML=playing?'&#10074;&#10074;':'&#9654;';});
window.addEventListener('keydown',e=>{
  if(e.code==='Space'){playBtn.click(); e.preventDefault();}
  if(e.code==='ArrowRight'){t=Math.min(T-1,t+1); slider.value=t; dirty=true;}
  if(e.code==='ArrowLeft'){t=Math.max(0,t-1); slider.value=t; dirty=true;}});
</script></body></html>"""


class _Viewer:
    def __init__(self, npz_path: str, env: int = 0,
                 target=(1.2, 0.0, 0.8), size=(960, 540)):
        data = dict(np.load(npz_path, allow_pickle=False))
        bs = data["body_states"]
        if bs.ndim == 4:
            bs = bs[:, env]
        self.body_states = bs
        geoms = data.get("geoms")
        if geoms is None:
            nb = bs.shape[1]
            geoms = np.asarray([[b, U.GEOM_SPHERE, 0.03, 0.03, 0.03,
                                 0, 0, 0, 0, 0, 0, 1.0] for b in range(nb)],
                               np.float32)
        self.geoms = geoms
        markers = data.get("markers")
        if markers is not None and markers.ndim == 4:
            markers = markers[:, env]
        self.markers = markers
        self.target = np.asarray(target, np.float64)
        self.size = size
        self._lock = threading.Lock()  # cv2 rasterize is cheap but not reentrant

    @property
    def T(self) -> int:
        return int(self.body_states.shape[0])

    def frame_jpeg(self, t: int, az_deg: float, el_deg: float,
                   dist: float) -> bytes:
        import cv2
        t = int(np.clip(t, 0, self.T - 1))
        az, el = np.radians(az_deg), np.radians(el_deg)
        eye = self.target + dist * np.asarray([
            np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
        eye[2] = max(eye[2], 0.05)
        mk = self.markers[t:t + 1] if self.markers is not None else None
        with self._lock:
            frame = next(render_frames(self.body_states[t:t + 1], self.geoms,
                                       mk, size=self.size, eye=eye,
                                       target=self.target))
        ok, buf = cv2.imencode(".jpg", frame,
                               [int(cv2.IMWRITE_JPEG_QUALITY), 85])
        if not ok:
            raise RuntimeError("jpeg encode failed")
        return bytes(buf)


class _LiveSim:
    """Frame source that steps a live port env as the playhead advances.

    Drop-in for :class:`_Viewer`: ``T`` grows as frames are simulated (the
    page polls ``/meta``); asking for frame ``t`` steps the sim up to ``t``
    and every simulated frame stays scrubbable from the buffer.
    """

    def __init__(self, task: str, checkpoint: str = "", device: str = "cuda",
                 env_index: int = 0, seed: int = 17,
                 target=(1.2, 0.0, 0.8), size=(960, 540),
                 max_frames: int = 5000):
        import torch
        import isaacgym_tpu_torch
        from isaacgym_tpu_torch.utils.config import compose
        from isaacgym_tpu_torch.viewer.render import scene_geom_table

        self._torch = torch
        cfg = compose(task, ["num_envs=1", f"device={device}"])
        self.env = isaacgym_tpu_torch.make(seed=seed, task=task, device=device,
                                           cfg=cfg["task"])
        self.geoms = scene_geom_table(self.env.scene)
        self.markers = None
        self.target = np.asarray(target, np.float64)
        self.size = size
        self.max_frames = max_frames
        self._lock = threading.Lock()

        self._policy = None
        if checkpoint:
            from isaacgym_tpu_torch.rl import checkpoint as ckpt
            from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
            trainer = PPOTrainer(self.env, PPOConfig.from_train_cfg(cfg.get("train", {})),
                                 seed=seed)
            ts = ckpt.restore(checkpoint, trainer.init_state())

            @torch.no_grad()
            def policy(obs):
                return trainer._policy(ts.params, ts.obs_stats, obs)[0]
            self._policy = policy

        self._state, self._obs = self.env.reset()
        self._frames = [self._bodies()]

    def _bodies(self) -> np.ndarray:
        return self.env.sim.rigid_body_states(self._state.sim)[0].cpu().numpy()

    @property
    def T(self) -> int:
        # one beyond the buffer so the playhead can keep advancing
        return min(len(self._frames) + 1, self.max_frames)

    def _step(self) -> None:
        actions = (self._policy(self._obs) if self._policy is not None
                   else self._torch.zeros((1, self.env.num_actions), device=self.env.device))
        self._state, self._obs, rew, done, info = self.env.step(self._state, actions)
        self._frames.append(self._bodies())

    def frame_jpeg(self, t: int, az_deg: float, el_deg: float,
                   dist: float) -> bytes:
        import cv2
        with self._lock:
            t = int(np.clip(t, 0, self.max_frames - 1))
            while len(self._frames) <= t:
                self._step()
            az, el = np.radians(az_deg), np.radians(el_deg)
            eye = self.target + dist * np.asarray([
                np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
            eye[2] = max(eye[2], 0.05)
            frame = next(render_frames(self._frames[t][None], self.geoms,
                                       None, size=self.size, eye=eye,
                                       target=self.target))
        ok, buf = cv2.imencode(".jpg", frame,
                               [int(cv2.IMWRITE_JPEG_QUALITY), 85])
        if not ok:
            raise RuntimeError("jpeg encode failed")
        return bytes(buf)


def make_handler(viewer: _Viewer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            try:
                if u.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif u.path == "/meta":
                    self._send(200, "application/json",
                               json.dumps({"T": viewer.T}).encode())
                elif u.path == "/frame":
                    q = parse_qs(u.query)
                    jpg = viewer.frame_jpeg(
                        t=int(float(q.get("t", ["0"])[0])),
                        az_deg=float(q.get("az", ["-47"])[0]),
                        el_deg=float(q.get("el", ["26"])[0]),
                        dist=float(q.get("dist", ["4.2"])[0]))
                    self._send(200, "image/jpeg", jpg)
                else:
                    self._send(404, "text/plain", b"not found")
            except (BrokenPipeError, ConnectionResetError):
                pass
    return Handler


def serve(npz_path: str, port: int = 8008, env: int = 0) -> ThreadingHTTPServer:
    viewer = _Viewer(npz_path, env=env)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(viewer))
    print(f"viewing {npz_path} ({viewer.T} frames) at http://localhost:{port}/",
          flush=True)
    return httpd


def serve_live(task: str, checkpoint: str = "", device: str = "cuda",
               port: int = 8008, seed: int = 17) -> ThreadingHTTPServer:
    viewer = _LiveSim(task, checkpoint=checkpoint, device=device, seed=seed)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(viewer))
    src = f"policy {checkpoint}" if checkpoint else "zero actions"
    print(f"LIVE sim {task} ({src}) at http://localhost:{port}/", flush=True)
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("npz", nargs="?", default=None,
                    help="recorded trajectory (omit with --task for live sim)")
    ap.add_argument("--task", default=None,
                    help="step a LIVE sim of this registered task instead")
    ap.add_argument("--checkpoint", default="",
                    help="policy checkpoint for the live sim (default: zeros)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--env", type=int, default=0)
    args = ap.parse_args(argv)
    if args.task:
        httpd = serve_live(args.task, checkpoint=args.checkpoint,
                           device=args.device, port=args.port, seed=args.seed)
    elif args.npz:
        httpd = serve(args.npz, port=args.port, env=args.env)
    else:
        ap.error("provide a trajectory npz or --task for a live sim")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
