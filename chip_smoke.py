#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it, phase by phase.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds:
  device  the card's name, and its name and power limit from nvidia-smi;
  build   one nvcc per csrc/*.cu, started together, into build/kernels/
          (and g++ the host loop that counts the kernels' operations), wall
          seconds, and ptxas's registers, stack and spills of K1, K2,
          K2-dr, K2-tau, K2-dr-tau, K3, K3-tau, K4 and K4-tau;
  k2/*    the fused-substep kernel against its plain PyTorch version on the
          card, B = 4096, one substep from each state set (reset, rollout
          after 60 steps, paddle_ball, paddle_table, ball_rest), the plain
          version run in float32 and in float64: per output over envs whose
          contact pattern agrees, the deviation from each, gated at the CPU
          tests' tolerances beyond the float32 plain run's own rounding (see
          compare), and the flip rate;
  k2_gates  K2's output with each warp's two env columns swapped (envs 2i
          and 2i + 1), and K2 on a copy of the pack whose articulated geoms
          sit 100 m from their links (their reactions dropped, their rows
          kept), must each fail the gates on some set;
  k2/odd  K2 at 4095 envs (the last warp's second env idle) on the rollout
          states, under the same comparison; k2dr/odd, k2tau/odd,
          k2drtau/odd and k1/odd the same for the other builds and K1;
  timing  K2 per launch (CUDA events, median of 15 repeats of 20 launches,
          through its launcher into an output allocated once; the
          wrapper's call beside it) beside the plain version and the bound
          (bytes over 3.35 TB/s vs counted FP32 operations over 67 TFLOP/s,
          the larger), ptxas's registers, stack, spills and shared memory
          of the entry that ran, and its launch geometry;
  k2dr/*  K2-dr, the domain-randomized build, against its plain version on
          the same five sets with a channel drawn by DomainRandomizer.sample
          at global step 3000 (every scheduled term at full strength), under
          the same comparison and gates; and K2-dr with an identity channel
          against K2 (within 1e-6 of each output's scale);
  k2dr_timing  K2-dr per launch, its plain version, its bound, ptxas usage
          and geometry, as timing;
  k3/*    K3, the multi-articulation kernel, against its plain version under
          the same comparison and gates, B = 4096: on C8 (reset, rollout
          after 60 steps, paddle_ball1, paddle_ball2 -- the humanoid yawed
          180 deg -- and ball_rest) and on the two-arm, two-ball check scene
          (ball_ball: the balls about to collide; effort: effort drive);
  k3_gates  K3's output with arm 1's qd_new negated, and K3 on a copy of the
          scene's pack whose articulations list no geoms for the balls (the
          ball-vs-art reactions dropped, everything else the same), must
          each fail the gates on some set;
  k3_timing  K3 per launch on the C8 rollout states (sim/scripted
          k3_random_inputs; its library entry into an output allocated once,
          the wrapper's time beside it), its plain version, its bound, ptxas's
          registers, stack, spills and shared memory of the entry that ran,
          and its launch geometry (as k4_timing; k3tau_timing too);
  k2tau/*  K2-tau, the torque-lane build of K2 for scenes with a force
          sensor, on the flagship scene with a paddle sensor (raised table
          for paddle_table), on K2's five sets under the same comparison and
          gates, the moment rows compared on their own (geom moments to
          1e-5, the ball's to 1e-7: TOL); k2drtau/* K2-dr-tau (DR and torque
          lanes) on two of them; k2tau_timing and k2drtau_timing their
          times, bounds, ptxas usage and geometry;
  k3tau/*  K3-tau on C8 with a sensor on each paddle (C8's five sets) and on
          the two-arm, two-ball scene with paddle sensors (ball_ball, whose
          ball-pair moments the JAX package's tests never reach, and
          effort); k3tau_timing its time, bound, ptxas usage and geometry;
  k4tau/*  K4-tau, the torque-lane build of K4, on C10 with a paddle sensor
          (raised table for table) at 2048 envs, on K4's five sets (below)
          under k4/*'s comparison, the moment rows compared on their own at
          TOL; strike and table must reach non-zero geom moments (the ball's
          reactions, art-vs-static); k4tau_timing its time, plain version,
          bound and ptxas usage;
  tau_gates  each tau kernel's (K2-tau, K2-dr-tau, K3-tau, K4-tau) output
          with its geom or its ball moment rows zeroed, or negated, must
          fail the moment gates on some set;
  k4/*    K4, the floating-base kernel, against its plain version on C10
          at its 2048 envs under the same comparison, the base's pose and
          velocities gated as q and qd are, flip rate at most 0.2 % as K2's:
          stand (the neutral pose, the feet's resting contacts), random (60
          env steps under random actions), strike (a paddle-ball strike),
          fall (a falling humanoid hitting the ground), table (standing on
          the raised table, art-vs-static);
  k4_gates  K4's output with the base's linear velocity negated, and K4
          run on the scene lifted 2 m above its ground (the ground contacts
          dropped, everything else the same), must each fail the gates on
          some set;
  k4_timing  K4 per launch on the random-action states, its plain version,
          its bound, ptxas's registers, stack, spills and shared memory, and
          its launch geometry (envs per block, blocks, the blocks an SM
          holds by the CUDA runtime's occupancy calculator, waves, warps per
          busy SM; k4tau_timing too);
  k1/*    K1, the arm step, against its plain version on the flagship arm at
          4096 envs under the same comparison (its frames and factor gated
          as q is; a flip is an env whose set of clamped joints differs):
          random (joints, velocities and targets within the limits),
          limits (every joint at or just past a limit, moving outward),
          terrain (60 steps of the terrain flagship under random actions);
  k1_gates  K1's output with qd_new negated must fail the gates on some set;
  k1_timing  K1 per launch (its launcher, as timing), its plain version,
          its bound (counted ops), ptxas's registers, stack, spills and
          shared memory, and its launch geometry;
  k2/c5_*, k2/c9_*  K2 on C5's scene (its 0.0083 s substep) and C9's (table
          and ball restitution 1.5) under the same comparison: random-action
          states and paddle strikes, and on C9 table bounces (balls falling
          at 2-4 m/s from within a substep's travel of the table);
  parity/<scene>  the parity tool (isaacgym_tpu_torch.parity.env_step) on its
          committed fixture (64 envs x 4 states of the JAX package's env
          step, isaacgym_tpu_torch/parity/data/) for the flagship, C5, C6,
          C8, C9, C10, the terrain flagship and C11: the port's step on the card
          within each scene's parity gates, its kernel launched twice a
          step; parity_gates  the port's dof velocities negated, and one
          env's done flag flipped alone, must each fail the gates;
  main    make(seed=0, flagship, 4096 envs), reset, 5 warm-up steps, then
          3 windows of 100 steps under uniform actions in [-1, 1] from a
          seeded generator: launches must be exactly 2 per step, every
          state finite, and some ball must bounce (z below 0.85, then up);
          env-steps/s and ms per step per window;
  profile torch.profiler over 10 more steps: device busy share, device
          kernels per step, K2's share, the top kernels by device time;
  guard_cost  the baked-root guard's cost on the main cell: windows of 100
          steps through the guarded Simulator.step and through step_kernel,
          in turns guarded, unguarded, unguarded, guarded, and the compare
          with its sync alone per call;
  c8_main make(seed=0, C8, 4096 envs), 3 windows of 100 steps as main: K3
          exactly 2 launches per step and K2 none, every state finite, a
          ball bounces; then 10 steps with twoPlayer on, obs 188 finite;
  c8_profile  torch.profiler over 10 C8 steps: device kernels per step and
          K3's share;
  c6_main 100 steps of C6 (HumanoidPingpongTiltG1) at 4096 envs: K2
          exactly 2 per step, every state finite;
  c5_main, c9_main  100 steps each of C5 (HumanoidPingpongG1) and C9
          (HumanoidPingpongAlignmentG1) at 4096 envs: route k2, K2 exactly
          2 per step, every state finite;
  sensors/flagship, sensors/c8, sensors/c10  the force-sensor path at
          4096 envs (C10 at 2048): the scene with a sensor on each paddle
          (create_asset_force_sensor), 100 Simulator.step calls from scripted
          off-centre strikes re-launched every 10 steps, each read with
          acquire_force_sensor_tensor: K2-tau (K3-tau on C8, K4-tau on C10)
          exactly 2 launches per step, every strike (force above 0.1 N)
          reads a non-zero moment; env-steps/s and microseconds per
          acquire_force_sensor_tensor; then the first strike step's sensor
          force and moment lanes against the same step through the plain
          version in float32 and float64 (SENSOR_TOL beyond the float32
          run's rounding);
  c10_main  make(seed=0, C10, 2048 envs), 3 windows of 50 steps under
          random actions: K4 exactly 2 launches per step, every state
          finite; env-steps/s and ms per step;
  c10_profile  torch.profiler over 10 C10 steps: device kernels per step,
          K4's share and the device busy share;
  terrain_main  the flagship on the seeded 8 m x 6 m rough heightfield with
          the heightmap block (obs 305) at 4096 envs, 3 windows of 50 steps
          under random actions: K1 exactly 2 launches per step and K2 none,
          every state finite, a ball bounces; env-steps/s; terrain_profile
          torch.profiler over 10 steps (device kernels per step, busy
          share, K1's share);
  baked_guard/flagship, baked_guard/c10  the table root written in every env
          (flagship at 4096 envs with the ball resting on the table; C10 at
          2048 standing on the raised table): the guarded step equals the
          non-kernel step exactly and differs from the unguarded kernel step
          (the guard dropped is rejected); untouched, it equals the kernel
          step exactly;
  train   PPOTrainer at the flagship's full width (4096 envs, horizon 32,
          minibatch 4096 x 5 mini-epochs, separate [2048,1536,1024,1024,512,512]
          bf16 trunks) with task.randomize=true, global step 3000 and
          full-strength DR params after reset, 7 epochs: seconds per epoch
          split into rollout and update, rollout env-steps/s, K2-dr launched
          exactly 2 x 32 per epoch and K2 never, every metric finite,
          episode_length_mean 169 once episodes finish, and a lower total
          loss on the first 4096 rows of each epoch's batch after the update
          than before it; then torch.profiler over one more epoch (device
          busy share) and the update's bf16 matrix-work floor;
  train_nodr  2 epochs with randomize false: the launcher's default route,
          K2 exactly 2 x 32 per epoch and K2-dr never;
  ckpt    save under a temporary directory, restore into a fresh trainer,
          the same mu on the same observations bit for bit, then play one
          episode of 4096 envs;
  c8_train  2 epochs on C8's own train config at 4096 envs: K3 exactly
          2 x 32 launches per epoch, every metric finite, a lower loss on
          the first 4096 rows after the update than before it;
  c10_train  the same for C10 on its own train config at 2048 envs, K4
          exactly 2 x 32 launches per epoch;
  c5_train, c9_train  one full-width PPO epoch each on its own train
          config at 4096 envs: K2 exactly 2 x 32 launches, seconds split
          into rollout and update, every metric finite, the first
          minibatch's loss falls;
  terrain_train  2 epochs of the terrain flagship without DR at 4096 envs,
          every env 29 steps from its episode's end: K1 exactly 2 x 32
          launches per epoch, episodes of 169, every metric finite, the loss
          on the first minibatch falls;
  dr/c8, dr/c10  make(..., task.randomize=true) at 4096 and 2048 envs, DR
          at full strength (global step 3000), 10 env steps under random
          actions: the non-kernel step, K3 and K4 launched 0 times, every
          state finite, env-steps/s; then from the last state one
          Simulator.step with an identity DR channel against the kernel
          route's step (within NONKERNEL_GATE, flip-aware; not the contact
          moments, which the sensor-less kernel route leaves at zero) and
          one with the full-strength channel, which must fail that gate;
  dr_train/c8, dr_train/c10  one PPO epoch each (horizon 16) on its train config with
          task.randomize=true: every metric finite, K3 and K4 launched 0
          times, seconds per epoch;
  routes/biped, routes/arm3  the JAX tests' 4-DOF floating biped and a
          3-DOF single-ball arm, shapes no kernel library is built for:
          Simulator on the card takes "nonkernel" and holds no kernel, and
          one step from a seeded random state equals the CPU's non-kernel
          step within NONKERNEL_GATE, flip-aware;
  k3/c11_*, k3tau/c11_*  K3 and K3-tau at <26, 2, 2> (C11: two 26-DOF
          humanoids under effort drive, two balls; K3-tau with a sensor on
          each paddle) against their plain versions under the same
          comparison at 4096 envs: reset (both balls' launches), rollout (60
          env steps under random actions), paddle_ball1, paddle_ball2 (both
          balls at the paddles) and ball_rest, efforts uniform in
          +-C11_EFFORT; k3_gates/c11  K3's two wrong forms (as k3_gates)
          must each fail the gates on some C11 set, and K3-tau's zeroed or
          negated moment rows too; k3c11_timing, k3tauc11_timing  their
          time per launch on the rollout states (the tree-blocked body),
          plain version, bound (the body's counted ops), ptxas usage
          (registers, stack, spills, shared bytes) and launch geometry
          (envs a block, blocks per SM asked and fitting, waves);
  c11_main  make(seed=0, C11, 4096 envs), 50 steps under random actions:
          route k3, K3 exactly 2 launches per step, every state finite,
          env-steps/s; torch.profiler over 10 more steps (device busy
          share, device kernels per step, K3's share);
  c11_train  one PPO epoch of C11's train config at 4096 envs: K3 exactly
          2 x 32 launches, seconds split into rollout and update, every
          metric finite, the first minibatch's loss falls;
  sensors/c11  the sensor path (above) on C11 with a sensor on each paddle:
          K3-tau at <26, 2, 2>;
  link/pendulums, link/sibling_arms, link/flagship  the link-vs-link
          narrowphase (link_collision) through the non-kernel step: the JAX
          tests' two pendulums and sibling arms at 4096 envs with per-env
          swing velocities (30 steps), and the flagship with linkCollision
          on at 4096 envs (10 steps): route nonkernel and no kernel held,
          the pair count, ms per step, and one step against the CPU's
          non-kernel step within NONKERNEL_GATE, flip-aware;
  flatten_train  three flagship epochs at 4096 envs with
          flatten_optimizer: true on the launcher's config otherwise (the
          flag selects the per-tensor step, which the CPU tests hold to
          optax.flatten), through train_epochs (K2 2 x 32 launches an
          epoch, finite metrics, the first minibatch's loss falls);
          flatten_train/update  the first update under torch.profiler
          (device kernels per minibatch);
  camera/closed_form  a 0.02 m ball 0.25 m before the camera on the card
          (65 x 65, about 80 pixels on the ball): every pixel on the ball
          within 1e-4 m of the ray-sphere closed form (float64), the centre
          at 0.23 m, seg 0 on it, sky -1 and ground -2;
  camera/flagship  the flagship with enableCameraSensors at 4096 envs and
          96 x 72, rendered after 8 K2 steps: 16 envs against the CPU render
          of the same body states (CAMERA_* gates, camera_compare),
          planted shading faults (planted_faults) that the gates must
          reject, ms per render (CUDA
          events, median of 7), device kernels and busy ms per render
          (torch.profiler), peak memory of a render;
  tensor_api/camera  acquire_camera_image_tensor for depth, color and
          segmentation: each equal to the render, on the card;
  amp_train  a fresh policy's 240-step flagship rollout at 4096 envs saved
          with save_motion_clip and loaded by MotionLib on the card, then 3
          AMPTrainer epochs at 4096 envs (amp_demo's config): K2 exactly
          2 x (4 + 32) launches an epoch, finite discriminator metrics, the
          demos' mean logit above the agents' on fresh batches after the
          last update (a smoke check); seconds per
          epoch split into the discriminator (its rollout and update) and
          the PPO epoch;
  viewer  record_env_rollout for 60 steps at 4096 envs (4 recorded): the
          npz's keys, shapes and dtypes are the JAX recorder's, its body
          states finite (drawing frames needs cv2: a host step, checked on
          the CPU);
  assets/native  (after build) the g++ build of the native asset parsers,
          and every URDF of models/assets and the MJCF arm fixture parsed
          natively equal, field for field, to the Python parsers' models;
          every scene of the run compiles from the native parse;
  pbt/flagship  python -m isaacgym_tpu_torch.pbt's population of 2, two
          rounds of two epochs at 4096 envs with the launcher's nets: K2
          2 x 32 launches an epoch a member, one member exploited a round,
          a clone keeping its bits while its donor trains on, ckpt_best.pt
          restoring the best member;
  ddp/flagship  the data-parallel epoch (parallel/data_parallel.py) in two
          processes on the one card over gloo, 2 x 2048 envs, one epoch
          with DR: K2-dr 2 x 32 launches an epoch on each rank, bit-equal
          parameters on both ranks, only rank 0's files; each rank's seconds
          an epoch beside the one-process 4096-env epoch of train;
  profile_ppo/flagship, probe_ball/flagship  each tool at 4096 envs, its
          JSON line (the epoch's halves, FLOPs and MFU; the ball's arrival
          statistics over 170 zero-action steps), K2's launches counted;
  parity_dr/<scene> or parity_dr_fixture/<scene> (flagship, c8, c10)
          the parity tool's DR rows (the env step under domain randomization
          with every JAX draw replayed, the new DR parameters bit for bit):
          parity_dr/ at the gates' widths from build/parity/<scene>_dr.npz
          where tools/torch_parity_export.py --dr wrote them (they are not
          committed: 40 MB), else parity_dr_fixture/ on the committed 64-env
          fixture; within the gates, K2-dr twice a step on the flagship, no
          launch on C8 and C10 (the non-kernel step); parity_dr_gates  each
          fixture with identity DR parameters and with the redraw dropped,
          and the flagship's with its noise dropped, must fail;
  switches/<scene>_<switch>  each physics switch (sim/switches.py) on the
          flagship (K2), C8 (K3) and C10 (K4) where it reaches them, 1024
          envs (C10 512) of contact states: one step on the card against
          the CPU's under the same switch, the route's kernel twice (its
          -tau build under torque; switches/flagship_torque_dr K2-dr-tau
          under DR), no kernel under pallas off, the default's bits under
          ccd and native off;
  tp/flagship  the PPO epoch with the trunks sharded over mdl
          (parallel/tensor_parallel.py), two processes on the one card over
          gloo, dp 1 x mdl 2, 4096 envs, the full trunk in float32
          (DTensor's parallelize_module): the first minibatch's gradients,
          the clip norm and the rollout's metrics against one process's
          epoch; the update's metrics and the parameters after it within 4x
          their spread against a second one-process epoch with float64
          trunks; the trunks still cut after the update; seconds per epoch
          beside the one process's.
Then the kernels line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; with
no CUDA device, or run outside the repository, it exits non-zero at once.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

TASK = "HumanoidPingpongTiltNoEarlyStopG1"
C6 = "HumanoidPingpongTiltG1"
C8 = "Humanoid12PingpongTiltG1"
C10 = "HumanoidPingpongTiltNESSparse27DOFG1"
C5 = "HumanoidPingpongG1"
C9 = "HumanoidPingpongAlignmentG1"
C11 = "HumanoidPingpong5ActorG1"
C11_EFFORT = 20.0   # N m: C11's scripted sets' efforts are uniform in +-20 (effort drive)
# the parity tool's committed fixture, one file per scene
PARITY_FILES = ("flagship", "c5", "c6", "c8", "c9", "c10", "terrain", "c11")
B = 4096
B10 = 2048                     # C10's numEnvs (its config, and the reference's)
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12    # H100 SXM FP32, non-tensor
PEAK_BF16_OPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
# impulses: the force rows; a torque build's moment rows are gated on their
# own, by their size (tests/test_torch_force_torque.py's header): a ball's
# moment about its centre is 0.02 m times a friction impulse (up to ~1e-4),
# a geom body's up to ~6e-3 in a strike and ~0.4 at the raised table
# K4's base pose and velocities are gated as q and qd are (the CPU tests'
# tolerances, tests/test_torch_fused_substep_floating.py)
# K1's post-step frames and packed Cholesky factor are gated as q is
TOL = dict(q_new=1e-4, ball_pos=1e-4, ball_vel=1e-4, qd_new=1e-3, tau=1e-3,
           impulses=1e-3, ball_omega=1e-3, geom_moments=1e-5, ball_moments=1e-7,
           base_pos=1e-4, base_quat=1e-4, base_linvel=1e-3, base_angvel=1e-3,
           frame_pos=1e-4, frame_quat=1e-4, chol=1e-4)
# the sensor path's step against the same step through the plain version:
# force lanes in N, moment lanes in N m (the CPU test's port step against the
# JAX package's step holds them so)
SENSOR_TOL = dict(force=1e-2, moment=1e-3)
MAX_FLIP_RATE = 0.002
# the non-kernel step against another route's step or another device's,
# per SimState field (tests/test_torch_nonkernel.py's GATE and GATE_C10,
# which hold it to the JAX package's XLA step); an env whose root lands more
# than 0.1 apart is a flip
NONKERNEL_GATE = dict(root=1e-2, dof_pos=1e-5, dof_vel=2e-3, dof_force=1e-3,
                      net_contact_force=0.05, net_contact_torque=2e-3)
NONKERNEL_GATE_C10 = dict(root=5e-3, dof_pos=1e-5, dof_vel=3e-3, dof_force=5e-3,
                          net_contact_force=0.1, net_contact_torque=5e-3)
C_F32 = 1.0                    # see compare
# a kernel's numbers per built shape in the kernels line (K3, K3-tau)
# tp/flagship: the sharded float32 epoch against the one-process epoch (the
# first minibatch's gradients relative to their largest entry; the metrics
# and the clip norm relative to their own size, the metrics with an absolute
# floor for the near-zero bounds loss): 4096 envs x 32 steps may part at a
# paddle strike where the two trunks' float32 sums differ in the last place,
# so the gates sit above the CPU tests' 1e-5 and 1e-4
TP_GRAD_TOL, TP_METRIC_RTOL, TP_METRIC_ATOL = 1e-3, 1e-3, 1e-6
# the update's metrics (the last mini-epoch's means) and the parameters after
# it come after 160 Adam steps, which grow last-place differences. Their
# gate is measured in the same run: a second one-process epoch with its
# trunks computed in float64 gives the spread that the float32 trunks'
# rounding alone makes, and the sharded epoch (whose trunks only sum in
# another order) may part from the float32 one-process epoch by at most
# TP_SPREAD_FACTOR times that spread, metric by metric (plus the rollout's
# TP_METRIC_RTOL; TP_PARAM_ATOL for the parameters). A reordered float32 twin (the loss means summed in reverse
# row order) is no witness: the means' gradients do not depend on the order,
# and on the H100 it gave the same parameters bit for bit
TP_UPDATE_METRICS = ("a_loss", "c_loss", "entropy", "b_loss", "kl")
TP_SPREAD_FACTOR, TP_PARAM_ATOL = 4.0, 1e-6
SHAPE_FIELDS = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "registers",
                "stack_bytes", "spill_bytes", "smem_bytes")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def split_rows(out, moments=None):
    """name -> tensor of each compared output. A torque build's impulses
    (``moments`` = (ng, nb): ng geom moment rows, then nb ball moment rows,
    after the force rows) split into ``impulses`` (the force rows),
    ``geom_moments`` and ``ball_moments``."""
    v = {f: getattr(out, f) for f in out._fields}
    if moments:
        ng, nb = moments
        imp = out.impulses
        v.update(impulses=imp[:, :-(ng + nb)], geom_moments=imp[:, -(ng + nb):-nb],
                 ball_moments=imp[:, -nb:])
    return v


def compare(got, want32, want64, moments=None, pattern=None):
    """A kernel against its plain version, run in float32 and in float64 on
    the same inputs (a torque build's moment rows as their own outputs, see
    split_rows). Flips (envs whose contact pattern, the force rows, differs
    from the float32 plain run's) are counted and left out. The gate holds
    each element of each output to exact arithmetic, as far as float32 allows:

        |kernel - plain64| <= TOL + C_F32 |plain32 - plain64|

    C_F32 = 1 is the least value at which the float32 plain version itself,
    put in the kernel's place, passes whatever the gate: it credits the
    kernel with the float32 rounding that the plain version shows on that
    element, and no more. Every result within TOL of the float32 plain run
    passes (triangle inequality); so does one nearer to exact arithmetic
    than the float32 plain run where that run's own rounding exceeds TOL (at
    paddle contacts the contact normal is a short ball-to-paddle vector
    normalised). Reports, per output over the kept envs, the gated excess
    ``|kernel - plain64| - C_F32 |plain32 - plain64|``, the deviation from
    each plain run and the float32-to-float64 gap."""
    import torch
    g_, w32_, w64_ = (split_rows(o, moments) for o in (got, want32, want64))
    if pattern is None:   # the contact pattern: which impulse rows are active
        pattern = lambda o: o["impulses"].abs().sum(-1) > 0
    fa, fb = pattern(g_), pattern(w32_)
    keep = ~(fa != fb).any(dim=1)
    flat = lambda t: t.reshape(keep.shape[0], -1)[keep]
    kept_max = lambda d: float(flat(d).max()) if bool(keep.any()) else 0.0
    res = {k_: {} for k_ in ("excess", "max_err_vs_f32_plain", "max_err_vs_f64_plain",
                             "f32_plain_vs_f64_plain")}
    for f in g_:
        g, w32, w64 = g_[f].double(), w32_[f].double(), w64_[f]
        d64, gap = (g - w64).abs(), (w32 - w64).abs()
        res["excess"][f] = kept_max(d64 - C_F32 * gap)
        res["max_err_vs_f32_plain"][f] = kept_max((g - w32).abs())
        res["max_err_vs_f64_plain"][f] = kept_max(d64)
        res["f32_plain_vs_f64_plain"][f] = kept_max(gap)
    res["flip_rate"] = float((~keep).float().mean())
    res["finite"] = all(bool(torch.isfinite(getattr(got, f)).all()) for f in got._fields)
    return res


def gate(phase, res, extra_ok=True, extra=""):
    """Raise unless ``compare``'s result is within TOL, the flip rate and
    finite."""
    bad = [f for f, e in res["excess"].items() if not e <= TOL[f]]
    if bad or res["flip_rate"] > MAX_FLIP_RATE or not res["finite"] or not extra_ok:
        raise SystemExit(f"{phase}: kernel disagrees with its plain version: {bad} "
                         f"flip {res['flip_rate']} finite {res['finite']} {extra}")


def check_kernel(phase, kernel, plain, ins, extra=(), fields=None, ok=True, why="",
                 keep_outputs=False):
    """One state set: the kernel against its plain version run in float32 and
    in float64 on the same inputs (``extra``: more inputs, the DR channel),
    emitted and gated (``compare``, ``gate``; ``ok`` and ``why`` a further
    check of the caller's). A torque-lane build also reports its largest geom
    and ball moment, and which of its moment rows, zeroed or negated in the
    kernel's output, the gates reject (``wrong_moments_rejected``). Returns
    ``compare``'s result; with ``keep_outputs`` also the kernel's and the
    two plain runs' outputs, under ``outputs``."""
    import torch
    t0 = time.perf_counter()
    got = kernel(*ins, *extra)
    want = plain(*ins, *extra)
    want64 = plain(*[t.double() for t in ins], *[t.double() for t in extra])
    torch.cuda.synchronize()
    moments = (kernel.ng, getattr(kernel, "nb", 1)) if kernel.with_torque else None
    res = compare(got, want, want64, moments)
    out = {"phase": phase, **res, **(fields or {}),
           "contact_rows_active": (got.impulses.abs().sum(-1) > 0).float().mean(0).tolist()}
    if moments:
        ng, nb = moments
        rows = {"geom_moments": slice(-(ng + nb), -nb), "ball_moments": slice(-nb, None)}
        out["max_moment"] = res["max_moment"] = {f: float(got.impulses[:, r].abs().max())
                                                 for f, r in rows.items()}
        res["wrong_moments_rejected"] = []
        for how, scale in (("zeroed", 0.0), ("negated", -1.0)):
            for f, r in rows.items():
                imp = got.impulses.clone()
                imp[:, r] *= scale
                if not compare(got._replace(impulses=imp), want, want64,
                               moments)["excess"][f] <= TOL[f]:
                    res["wrong_moments_rejected"].append(f"{f} {how}")
    emit({**out, "seconds": time.perf_counter() - t0})
    gate(phase, res, ok, why)
    if keep_outputs:
        res["outputs"] = (got, want, want64)
    return res


def fold(acc, res):
    """Keep in ``acc`` the largest deviation, excess and flip rate over sets,
    and which wrong moment rows some set's gates rejected."""
    if "wrong_moments_rejected" in res:
        acc["wrong_moments_rejected"] = sorted(set(acc.get("wrong_moments_rejected", ()))
                                               | set(res["wrong_moments_rejected"]))
    for f in res["excess"]:
        acc["max_err"][f] = max(acc["max_err"].get(f, 0.0), res["max_err_vs_f32_plain"][f])
        acc["excess"][f] = max(acc["excess"].get(f, -math.inf), res["excess"][f])
    acc["flip_rate"] = max(acc.get("flip_rate", 0.0), res["flip_rate"])
    acc["max_abs_err"] = max(acc["max_err"].values())


def device_kernels(prof):
    """name -> (launches, device microseconds) of the CUDA kernels a
    torch.profiler run recorded (device events only, not the CPU ops). Reads
    the raw kineto events: building the profiler's FunctionEvent tree for an
    epoch's ~10^5 events takes minutes."""
    from torch.autograd import DeviceType
    per_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, t = per_name.get(e.name(), (0, 0.0))
            per_name[e.name()] = (n + 1, t + e.duration_ns() / 1e3)
    return per_name


def cuda_ms(fn, inner, repeats):
    """Median over ``repeats`` of the CUDA-event time of ``inner`` calls."""
    import torch
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_kernel(phase, launch, wrapped, plain, ops, n_bytes, plain_repeats=10, b=B,
                fields=None):
    """A kernel's time per launch on a packed buffer and through its wrapper,
    its plain version's time and the bound: the larger of the bytes over the
    memory rate and the counted FP32 operations over the FP32 peak, at ``b``
    envs."""
    t0 = time.perf_counter()
    k_ms = cuda_ms(launch, 20, 15)
    wrap_ms = cuda_ms(wrapped, 20, 15)
    plain_ms = cuda_ms(plain, 1, plain_repeats)
    if ops <= 0:
        raise SystemExit(f"{phase}: operation count failed")
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    out = {"kernel_ms": k_ms, "wrapper_ms": wrap_ms, "plain_ms": plain_ms, "bytes": n_bytes,
           "fp32_ops": ops, "ops_per_env": ops / b, "bytes_bound_ms": bytes_ms,
           "ops_bound_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", **(fields or {})}
    emit({"phase": phase, **out, "seconds": time.perf_counter() - t0})
    return out


def lift_art_geoms(consts, far=100.0):
    """A copy of K2 pack ``consts`` with each articulated geom moved ``far``
    m from its link (its offset's z): the geoms keep their impulse rows, but
    no ball and no static reaches them."""
    from isaacgym_tpu_torch.ops import fused_substep as F
    c = consts.copy()
    art = F.layout(int(c[F.C_ND]))["art"]
    for gi in range(int(c[F.C_NART])):
        c[art + gi * F.ART_STRIDE + F.A_OFF_POS + 2] += far
    return c


def bounced_envs(zs, dev):
    """Envs whose ball went below z = 0.85 and then up again, from a list of
    per-step (B,) heights."""
    import torch
    z = torch.stack(zs)                          # (steps, B)
    zmin, tmin = z.min(dim=0)
    later = torch.where(torch.arange(len(zs), device=dev)[:, None] > tmin[None], z,
                        torch.full_like(z, -1e9)).max(dim=0).values
    return int(((zmin < 0.85) & (later > zmin + 0.01)).sum())


def k3_without_ball_art(k):
    """A copy of K3 wrapper ``k``'s pack whose articulations list no geoms
    for the balls (each C_GEOM_HI set to its C_GEOM_LO): the pairs and the
    impulse rows keep the geoms."""
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    consts = k.consts.copy()
    lay = M.multi_layout(k.nd, k.K)
    for a in range(k.K):
        blk = lay["art0"] + a * lay["art_stride"]
        consts[blk + M.C_GEOM_HI] = consts[blk + M.C_GEOM_LO]
    return consts


def k3_checks(dev, host, cases, seed, tag="", tau=None, plain_repeats=5):
    """K3 against its plain version (float32 and float64) on each of
    ``cases``, (name, env, kind, effort scale): ``scripted.k3_inputs`` of
    that kind on that env drawn from RandomState(``seed`` + the case's
    index), or for kind None a random-action rollout of the env; with
    ``tau``, the same scene's K3-tau wrapper (a sensor on each paddle) on
    the same sets, its moment gates rejecting each wrong moment form on some
    set. Then that the gates reject two wrong K3 outputs on some set
    (``k3_gates``): arm 1's qd_new negated, and K3 on a copy of the scene's
    pack whose articulations list no geoms for the balls (the ball-vs-art
    reactions dropped, everything else the same). Then K3's (and K3-tau's)
    timing on the first case's rollout set, bound, ptxas usage and launch
    geometry (``k3_timing``). ``tag`` names a second shape's phases
    (``k3/{tag}_{name}``, ``k3_gates/{tag}``, ``k3{tag}_timing``,
    ``k3tau{tag}_timing``). Returns the kernels-line numbers of K3, and of
    K3-tau with ``tau``; raises on any failed gate."""
    import numpy as np
    import torch
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    from isaacgym_tpu_torch.sim import scripted

    pre = f"{tag}_" if tag else ""
    acc, acc_tau = {"max_err": {}, "excess": {}}, {"max_err": {}, "excess": {}}
    wrong = {"arm 1's qd_new negated": [], "ball-vs-art reactions dropped": []}
    sets, no_art = {}, {}
    for i, (name, e, kind, scale) in enumerate(cases):
        if kind is None:
            ins = scripted.k3_random_inputs(e, B)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in scripted.k3_inputs(
                e, kind, B, np.random.RandomState(seed + i), scale))
        k = e.sim.fused_substep_multi
        shape = {"shape": [k.nd, k.K, k.nb]}
        plain = lambda *a, k=k: M.fused_substep_multi_reference(k.device_consts(dev), *a)
        res = check_kernel(f"k3/{pre}{name}", k, plain, ins, fields=shape, keep_outputs=True)
        got, want, want64 = res.pop("outputs")
        fold(acc, res)
        sets[name] = (e, ins)
        if k not in no_art:
            no_art[k] = M.FusedSubstepMulti(k3_without_ball_art(k))
        nd = k.nd
        arm1 = torch.cat([got.qd_new[:, :nd], -got.qd_new[:, nd:2 * nd]], 1)
        for form, out in (("arm 1's qd_new negated", got._replace(qd_new=arm1)),
                          ("ball-vs-art reactions dropped", no_art[k](*ins))):
            r = compare(out, want, want64)
            if (any(not v <= TOL[f] for f, v in r["excess"].items())
                    or r["flip_rate"] > MAX_FLIP_RATE):
                wrong[form].append(name)
        if tau is not None:
            plain_t = lambda *a: M.fused_substep_multi_reference(tau.device_consts(dev), *a,
                                                                 with_torque=True)
            fold(acc_tau, check_kernel(f"k3tau/{pre}{name}", tau, plain_t, ins, fields=shape))
    gates = "k3_gates" + (f"/{tag}" if tag else "")
    emit({"phase": gates, "rejected_on_sets": wrong,
          **({"tau_wrong_moments_rejected": acc_tau.get("wrong_moments_rejected")}
             if tau is not None else {})})
    if not all(wrong.values()):
        raise SystemExit(f"{gates}: the gates let a wrong K3 output pass on every set: {wrong}")
    if tau is not None and len(acc_tau.pop("wrong_moments_rejected", ())) != 4:
        raise SystemExit(f"{gates}: a wrong K3-tau moment form passed on every set")

    # timing at the main path's shape, on the first case's rollout states
    e, ins = sets[next(n for n, _, kind, _ in cases if kind is None)]
    x = M.pack_inputs(*ins)
    xc = x.cpu()
    out = {}
    timed = [("k3", e.sim.fused_substep_multi, acc)] + (
        [("k3tau", tau, acc_tau)] if tau is not None else [])
    for label, kk, a in timed:
        cc = torch.as_tensor(kk.consts)
        yc = torch.empty((M.n_out(kk.nd_tot, kk.nb, kk.ng, kk.with_torque), B))
        count = (host.igt_fused_substep_multi_tau_count_ops if kk.with_torque
                 else host.igt_fused_substep_multi_count_ops)
        usage = ptxas_usage("libigt_fused_substep_multi.so", k3_entry(kk))
        geo = k3_geometry(kk, B)
        t = time_kernel(
            f"{label}{tag}_timing", fixed_launch(kk, x, yc.shape[0]), lambda kk=kk: kk(*ins),
            lambda kk=kk: M.fused_substep_multi_reference(kk.device_consts(dev), *ins,
                                                          with_torque=kk.with_torque),
            count(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B, kk.nd, kk.K, kk.nb),
            4 * B * (M.n_in(kk.nd_tot, kk.nb) + yc.shape[0]) + 4 * kk.consts.size,
            plain_repeats=plain_repeats,
            fields={"shape": [kk.nd, kk.K, kk.nb], **usage, **geo})
        out[label] = dict(a, ms=t["kernel_ms"], wrapper_ms=t["wrapper_ms"],
                          plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                          bound_by=t["bound_by"], **usage, geometry=geo)
    return out


def k2_checks(dev, host):
    """K2 against its plain version (float32 and float64) on the flagship's
    five state sets (paddle_table on the raised-table scene); that the gates
    reject two wrong K2 outputs (k2_gates): each warp's two env columns
    swapped, and K2 on a pack whose articulated geoms no ball or static
    reaches (their reactions dropped); K2 at an odd B (k2/odd); its timing,
    bound, ptxas usage and launch geometry; then K2-dr the same way with a
    full-strength DR channel (and an identity channel against K2). Returns
    the sets, the randomizer and the kernels-line numbers of K2 and K2-dr;
    raises on any failed gate."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.env.randomize import DomainRandomizer
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.utils.config import load_task_config

    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B)
    env_raised = isaacgym_tpu_torch.make(
        seed=0, task=TASK, num_envs=B, cfg=scripted.raised_table_cfg(load_task_config(TASK)))
    sets, k2acc, k2_wrong = {}, {"max_err": {}, "excess": {}}, {}
    lifted = F.FusedSubstep(lift_art_geoms(env.sim.fused_substep.consts))
    lifted_raised = F.FusedSubstep(lift_art_geoms(env_raised.sim.fused_substep.consts))
    for i, name in enumerate(("reset", "rollout", "paddle_ball", "paddle_table", "ball_rest")):
        e = env_raised if name == "paddle_table" else env
        if name == "rollout":
            ins = scripted.k2_random_inputs(env, B)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in
                        scripted.k2_inputs(e, name, B, np.random.RandomState(100 + i)))
        k = e.sim.fused_substep
        plain = lambda *a, k=k: F.fused_substep_reference(k.device_consts(dev), *a)
        res = check_kernel(f"k2/{name}", k, plain, ins, keep_outputs=True)
        got, want, want64 = res.pop("outputs")
        fold(k2acc, res)
        sets[name] = (e, ins)
        # the gates reject K2's wrong forms: the two halves of each warp
        # writing each other's env columns, and the articulated geoms'
        # contacts dropped (K2 on a copy of the pack with those geoms 100 m
        # from their links: their rows stay, their reactions are gone)
        pairs = lambda t: t.reshape(B // 2, 2, *t.shape[1:]).flip(1).reshape(t.shape)
        forms = {"env columns swapped in pairs": type(got)(*[pairs(t) for t in got]),
                 "articulated geoms' contacts dropped":
                     (lifted_raised if name == "paddle_table" else lifted)(*ins)}
        for form, out in forms.items():
            r = compare(out, want, want64)
            if (any(not v <= TOL[f] for f, v in r["excess"].items())
                    or r["flip_rate"] > MAX_FLIP_RATE):
                k2_wrong.setdefault(form, []).append(name)
    k2_scene_checks(dev, k2acc)
    emit({"phase": "k2_gates", "rejected_on_sets": k2_wrong})
    if set(k2_wrong) != set(forms):
        raise SystemExit(f"k2_gates: the gates let a wrong K2 output pass on every set: "
                         f"{k2_wrong}")
    # an odd B: the last warp's second env idle
    e, ins = sets["rollout"]
    k = e.sim.fused_substep
    odd = tuple(t[:B - 1].contiguous() for t in ins)
    fold(k2acc, check_kernel("k2/odd", k, lambda *a: F.fused_substep_reference(
        k.device_consts(dev), *a), odd, fields={"num_envs": B - 1}))

    # timing at the main path's shape, on the rollout states
    x = F.pack_inputs(*ins)
    consts = k.device_consts(dev)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((F.n_out(k.nd, k.ng), B))
    k2usage = ptxas_usage("libigt_fused_substep.so", k2_entry(k))
    k2geo = k2_geometry(k, B)
    k2t = time_kernel(
        "timing", fixed_launch(k, x, yc.shape[0]), lambda: k(*ins),
        lambda: F.fused_substep_reference(consts, *ins),
        host.igt_fused_substep_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B, k.nd),
        4 * B * (F.n_in(k.nd) + F.n_out(k.nd, k.ng)) + 4 * k.consts.size,
        fields={**k2usage, **k2geo})

    # K2-dr against its plain version, DR at full strength
    rz = DomainRandomizer(load_task_config(TASK)["task"]["randomization_params"], 7)
    dr_gen = torch.Generator(device=dev)
    dr_gen.manual_seed(3)
    ident = None
    k2dracc, dr_chans = {"max_err": {}, "excess": {}}, {}
    for name, (e, ins) in sets.items():
        chan = e.sim.dr_channel(rz.sample(dr_gen, 3000, B))
        if ident is None:
            ident = e.sim.dr_channel(rz.sample(dr_gen, 0, B))   # step 0: the identity
        k = e.sim.fused_substep_dr
        k2_out, id_out = e.sim.fused_substep(*ins), k(*ins, ident)
        id_dev = max(float(((getattr(id_out, f) - getattr(k2_out, f)).abs()
                            / getattr(k2_out, f).abs().clamp(min=1.0)).max())
                     for f in k2_out._fields)
        plain = lambda *a, k=k: F.fused_substep_reference(k.device_consts(dev), *a[:7],
                                                          dr_chan=a[7])
        fold(k2dracc, check_kernel(
            f"k2dr/{name}", k, plain, ins, (chan,), ok=id_dev <= 1e-6,
            why=f"identity vs K2 {id_dev}",
            fields={"identity_vs_k2": id_dev,
                    "mass_scale_range": [float(chan[:, 4 * k.nd].min()),
                                         float(chan[:, 4 * k.nd].max())]}))
        dr_chans[name] = chan

    e, ins = sets["rollout"]
    chan = dr_chans["rollout"]
    k = e.sim.fused_substep_dr
    fold(k2dracc, check_kernel("k2dr/odd", k, lambda *a: F.fused_substep_reference(
        k.device_consts(dev), *a[:7], dr_chan=a[7]), odd, (chan[:B - 1].contiguous(),),
        fields={"num_envs": B - 1}))
    x = F.pack_inputs(*ins, chan)
    xc = x.cpu()
    k2drusage = ptxas_usage("libigt_fused_substep.so", k2_entry(k))
    k2drgeo = k2_geometry(k, B)
    k2drt = time_kernel(
        "k2dr_timing", fixed_launch(k, x, yc.shape[0]), lambda: k(*ins, chan),
        lambda: F.fused_substep_reference(consts, *ins, dr_chan=chan),
        host.igt_fused_substep_dr_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B,
                                            k.nd),
        4 * B * (k.n_in() + F.n_out(k.nd, k.ng)) + 4 * k.consts.size,
        fields={**k2drusage, **k2drgeo})
    line = lambda acc, t, usage, geo: dict(
        acc, ms=t["kernel_ms"], wrapper_ms=t["wrapper_ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], **usage, geometry=geo)
    return sets, rz, line(k2acc, k2t, k2usage, k2geo), line(k2dracc, k2drt, k2drusage, k2drgeo)


def k2_scene_checks(dev, acc):
    """K2 on C5's and C9's scenes against its plain version (their own
    constant packs: C5's substep of 0.0083 s, C9's table and ball
    restitution of 1.5): C5's random-action states and paddle strikes, C9's
    random-action states, paddle strikes and table bounces (balls falling
    onto the table at 2-4 m/s from within a substep's travel, so that the
    gated restitution acts); folded into ``acc``."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.simulator import fused_geom_lists
    for label, task in (("c5", C5), ("c9", C9)):
        env = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=B)
        k = env.sim.fused_substep
        plain = lambda *a, k=k: F.fused_substep_reference(k.device_consts(dev), *a)
        kinds = ("rollout", "paddle_ball") + (("table_bounce",) if label == "c9" else ())
        for i, kind in enumerate(kinds):
            rng = np.random.RandomState(200 + i)
            if kind == "rollout":
                ins = scripted.k2_random_inputs(env, B)
            elif kind == "paddle_ball":
                ins = tuple(torch.as_tensor(a, device=dev)
                            for a in scripted.k2_inputs(env, kind, B, rng))
            else:
                ins = [torch.as_tensor(a, device=dev)
                       for a in scripted.k2_inputs(env, "ball_rest", B, rng)]
                table = fused_geom_lists(env.scene)[0][0]
                top = float(table["pos"][2] + table["size"][2])
                rb = env.scene.free_bodies[0].radius
                ins[4][:, 2] = torch.as_tensor(top + rb + rng.uniform(0.0, 0.01, B),
                                               dtype=torch.float32, device=dev)
                ins[5][:, 2] = torch.as_tensor(-rng.uniform(2.0, 4.0, B),
                                               dtype=torch.float32, device=dev)
                ins = tuple(ins)
            fold(acc, check_kernel(f"k2/{label}_{kind}", k, plain, ins, fields={
                "task": task, "substep_dt": float(k.consts[F.C_DT]),
                "table_restitution": env.cfg["env"]["scene"]["tableRestitution"]}))


def parity_checks(dev):
    """The parity tool (``isaacgym_tpu_torch.parity.env_step``) on the card
    on its committed fixture, every scene: the port's env step against the
    JAX package's outputs within the parity gates; then the wrong forms on
    the flagship's file, each of which the gates must reject
    (``parity_gates``). Returns the kernel launches of each scene's check."""
    from isaacgym_tpu_torch.parity import env_step as E
    data = os.path.join(os.path.dirname(E.__file__), "data")
    launches = {}
    for name in PARITY_FILES:
        res = E.check(os.path.join(data, f"{name}.npz"), "cuda")
        emit({"phase": f"parity/{name}", **res})
        want = 2 * res["samples"]
        if res["gate"] != "PASS" or res["kernel_launches"] != want:
            raise SystemExit(f"parity/{name}: {res['gate_failures']}, "
                             f"{res['kernel_launches']} launches for {want}")
        launches[name] = res["kernel_launches"]
    t0 = time.perf_counter()
    rejected = {form: E.check(os.path.join(data, "flagship.npz"), "cuda",
                              mutate=f)["gate_failures"] for form, f in E.WRONG_FORMS.items()}
    emit({"phase": "parity_gates", "rejected": rejected, "seconds": time.perf_counter() - t0})
    if not all(rejected.values()):
        raise SystemExit(f"parity_gates: a wrong form passed the gates: {rejected}")
    return launches


ROUTE_KERNELS = {"k2": "fused_substep", "k3": "fused_substep_multi",
                 "k4": "fused_substep_floating"}


def task_main(dev, task, label, route, steps=100, profile=False):
    """One task's env step at 4096 envs through its route's kernel (K2, or
    K3 for C11): ``steps`` steps under uniform random actions, the route as
    asked, its kernel exactly 2 launches per step, every state finite; with
    ``profile`` 5 warm-up steps first and torch.profiler over 10 more steps
    after (device busy share, device kernels per step, the kernel's share).
    Returns the kernel's launches in the ``steps`` steps."""
    import torch
    import isaacgym_tpu_torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    t0 = time.perf_counter()
    env = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=B)
    name = ROUTE_KERNELS[route]
    k = getattr(env.sim, name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    act = lambda: torch.rand((B, env.num_actions), generator=gen, device=dev) * 2 - 1
    state, obs = env.reset()
    for _ in range(5 if profile else 0):
        state, *_ = env.step(state, act())
    torch.cuda.synchronize()
    k.launches = 0
    resets = 0
    tw = time.perf_counter()
    for _ in range(steps):
        state, obs, rew, done, info = env.step(state, act())
        resets += done.sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    launches = k.launches
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    out = {"phase": f"{label}_main", "task": task, "num_envs": B, "steps": steps,
           "route": env.sim.route, f"{route}_launches": launches,
           "env_steps_per_s": B * steps / wall, "ms_per_step": wall * 1e3 / steps,
           "resets": int(resets), "finite": finite}
    if profile:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tp = time.perf_counter()
            for _ in range(10):
                state, *_ = env.step(state, act())
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - tp) * 1e6
        kernels = [(n, c, t) for n, (c, t) in device_kernels(prof).items()]
        busy_us = sum(t for _, _, t in kernels)
        k_us = sum(t for n, _, t in kernels if f"{name}_kernel" in n)
        top = sorted(kernels, key=lambda r: -r[2])[:6]
        out.update(profile_wall_ms_per_step=wall_us / 1e4,
                   device_busy_ms_per_step=busy_us / 1e4, device_busy_share=busy_us / wall_us,
                   device_kernels_per_step=sum(c for _, c, _ in kernels) / 10,
                   **{f"{route}_ms_per_step": k_us / 1e4,
                      f"{route}_share_of_busy": k_us / busy_us},
                   top_kernels=[{"name": n[:70], "launches": c, "ms": t / 1e3}
                                for n, c, t in top])
    emit({**out, "seconds": time.perf_counter() - t0})
    if env.sim.route != route or launches != 2 * steps or not finite:
        raise SystemExit(f"{label}_main: route {env.sim.route}, {route} launched {launches} "
                         f"times in {steps} steps, finite={finite}")
    return launches


def trainer_for(overrides=(), task=TASK, b=B):
    """A task's env at ``b`` envs and a PPO trainer on its own train config,
    with launcher-style ``overrides``."""
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.utils.config import compose
    cfg = compose(task, [f"num_envs={b}", *overrides])
    env = isaacgym_tpu_torch.make(seed=0, task=task, cfg=cfg["task"])
    return env, PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=0)


def train_epochs(label, env, trainer, kernels, want, epochs, ts=None, state=None, obs=None,
                 episode_length=None, extra=None):
    """``epochs`` PPO epochs of ``trainer`` on ``env``, from ``ts``, ``state``
    and ``obs`` (a fresh start where not given); one call per trainer, as it
    wraps the trainer's rollout and update. Each epoch is emitted as
    ``{label}/epoch``: its seconds split into rollout and update, and the
    launches of each of ``kernels`` (name -> wrapper); then ``{label}``, the
    totals, with medians over the epochs after the first where there are
    more than one, and ``extra``. Checks each epoch: every kernel launched
    ``want[name]`` times, every metric finite, a lower total loss on the
    epoch's first minibatch rows after the update than before it, and with
    ``episode_length`` every finished episode that long. Returns (ts, state,
    obs, rows); raises on a failed check."""
    import torch
    t0 = time.perf_counter()
    b, horizon = env.num_envs, trainer.cfg.horizon_length
    rec = {"rollout_s": [], "update_s": [], "loss": []}
    real_rollout, real_update = trainer._rollout_and_gae, trainer._update

    def rollout(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_rollout(*a)
        torch.cuda.synchronize()
        rec["rollout_s"].append(time.perf_counter() - t)
        return out

    def update(ts_, batch, obs_stats):
        mb0 = {k_: v[:trainer.cfg.minibatch_size] for k_, v in batch.items()}
        with torch.no_grad():
            before = float(trainer.loss(ts_.params, obs_stats, mb0)[0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_update(ts_, batch, obs_stats)
        torch.cuda.synchronize()
        rec["update_s"].append(time.perf_counter() - t)
        with torch.no_grad():
            after = float(trainer.loss(out[0], obs_stats, mb0)[0])
        rec["loss"].append((before, after))
        return out

    trainer._rollout_and_gae, trainer._update = rollout, update
    if ts is None:
        ts = trainer.init_state()
    if state is None:
        state, obs = env.reset()
    rows = []
    for it in range(epochs):
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        te = time.perf_counter()
        ts, state, obs, metrics = trainer.train_epoch(ts, state, obs)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - te
        m = {k_: float(v) for k_, v in metrics.items()}
        n_ep = m["episode_count"]
        row = {"epoch": it, "epoch_s": epoch_s, "rollout_s": rec["rollout_s"][-1],
               "update_s": rec["update_s"][-1],
               "rollout_env_steps_per_s": b * horizon / rec["rollout_s"][-1],
               "env_steps_per_s": b * horizon / epoch_s,
               "loss_first_mb_before_after": rec["loss"][-1],
               **{f"{n}_launches": k.launches for n, k in kernels.items()},
               "episode_count": n_ep,
               "episode_length_mean": m["episode_length_sum"] / n_ep if n_ep else None,
               "episode_return_mean": m["episode_return_sum"] / n_ep if n_ep else None,
               **{k_: m[k_] for k_ in ("reward_mean", "a_loss", "c_loss", "kl", "last_lr")}}
        emit({"phase": f"{label}/epoch", **row})
        if ({n: k.launches for n, k in kernels.items()} != want
                or not all(math.isfinite(v) for v in m.values())
                or not rec["loss"][-1][1] < rec["loss"][-1][0]
                or (episode_length and n_ep
                    and m["episode_length_sum"] / n_ep != episode_length)):
            raise SystemExit(f"{label}: epoch {it}: {row}, want launches {want}, {m}")
        rows.append(row)
    steady = rows[1:]
    med = {f"{f}_median": statistics.median(r[f] for r in steady)
           for f in ("epoch_s", "rollout_s", "update_s", "rollout_env_steps_per_s",
                     "env_steps_per_s")} if steady else {}
    emit({"phase": label, "epochs": epochs, "num_envs": b,
          "launches": {n: sum(r[f"{n}_launches"] for r in rows) for n in kernels},
          **{f: [r[f] for r in rows] for f in ("epoch_s", "rollout_s", "update_s",
                                              "env_steps_per_s")},
          **med, **(extra or {}), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    return ts, state, obs, rows


def task_train(dev, task, label, route, epochs=1, b=B):
    """``epochs`` PPO epochs of a task on its own train config at ``b`` envs
    (``train_epochs``) through its route's kernel (K2, K3 or K4): exactly
    2 x horizon launches an epoch. Returns the launches."""
    env, trainer = trainer_for(task=task, b=b)
    route_k = getattr(env.sim, ROUTE_KERNELS[route])
    rows = train_epochs(f"{label}_train", env, trainer, {route: route_k},
                        {route: 2 * trainer.cfg.horizon_length}, epochs)[3]
    return sum(r[f"{route}_launches"] for r in rows)


def tau_checks(dev, host, k2_sets, rz, k4_sets):
    """K2-tau (the torque lanes of K2, for scenes with a force sensor) against
    its plain version in float32 and float64 on K2's five state sets, on the
    flagship scene with a paddle sensor (raised-table scene for
    paddle_table); K2-dr-tau on two of them; then K3-tau on C8 with a sensor
    on each paddle (C8's five sets) and on the two-arm, two-ball scene with
    paddle sensors (ball_ball, effort); then K4-tau on C10 with a paddle
    sensor on K4's five sets (``k4_sets``; raised-table scene for table).
    Then each kernel's timing and bound, and a check that the moment gates
    reject each kernel's output with its geom or its ball moment rows zeroed
    or negated. Returns the kernels-line numbers of K2-tau, K2-dr-tau, K3-tau
    and K4-tau; raises on any failed gate."""
    import numpy as np
    import torch
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_floating as FF
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.scene import DRIVE_EFFORT, DRIVE_POS
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.utils.config import load_task_config

    sims = {raised: Simulator(scripted.paddle_sensor_scene(
        scripted.raised_table_cfg(load_task_config(TASK)) if raised else load_task_config(TASK)),
        device=dev) for raised in (False, True)}
    k2 = {"max_err": {}, "excess": {}}
    k2dr = {"max_err": {}, "excess": {}}
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for name, (e, ins) in k2_sets.items():
        sim = sims[name == "paddle_table"]
        k = sim.fused_substep
        if not k.with_torque or not np.array_equal(k.consts, e.sim.fused_substep.consts):
            raise SystemExit("k2tau: the sensor scene's pack differs from the flagship's")
        plain = lambda *a, k=k: F.fused_substep_reference(k.device_consts(dev), *a,
                                                          with_torque=True)
        fold(k2, check_kernel(f"k2tau/{name}", k, plain, ins))
        if name in ("rollout", "paddle_ball"):
            kd = sim.fused_substep_dr
            chan = sim.dr_channel(rz.sample(gen, 3000, B))
            plain_dr = lambda *a, k=kd: F.fused_substep_reference(
                k.device_consts(dev), *a[:7], dr_chan=a[7], with_torque=True)
            fold(k2dr, check_kernel(f"k2drtau/{name}", kd, plain_dr, ins, (chan,)))

    # K2-tau and K2-dr-tau at an odd B: the last warp's second env idle
    _, ins = k2_sets["rollout"]
    odd = tuple(t[:B - 1].contiguous() for t in ins)
    k, kd = sims[False].fused_substep, sims[False].fused_substep_dr
    fold(k2, check_kernel("k2tau/odd", k, lambda *a: F.fused_substep_reference(
        k.device_consts(dev), *a, with_torque=True), odd, fields={"num_envs": B - 1}))
    chan = sims[False].dr_channel(rz.sample(gen, 3000, B))[:B - 1].contiguous()
    fold(k2dr, check_kernel("k2drtau/odd", kd, lambda *a: F.fused_substep_reference(
        kd.device_consts(dev), *a[:7], dr_chan=a[7], with_torque=True), odd, (chan,),
        fields={"num_envs": B - 1}))

    # K2-tau timing on the rollout states, the bound from the host body's count
    k = sims[False].fused_substep
    x = F.pack_inputs(*ins)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((F.n_out(k.nd, k.ng, True), B))
    consts = k.device_consts(dev)
    usage = ptxas_usage("libigt_fused_substep.so", k2_entry(k))
    t = time_kernel(
        "k2tau_timing", fixed_launch(k, x, yc.shape[0]), lambda: k(*ins),
        lambda: F.fused_substep_reference(consts, *ins, with_torque=True),
        host.igt_fused_substep_tau_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B,
                                             k.nd, 0),
        4 * B * (F.n_in(k.nd) + F.n_out(k.nd, k.ng, True)) + 4 * k.consts.size,
        fields={**usage, **k2_geometry(k, B)})
    k2.update(ms=t["kernel_ms"], wrapper_ms=t["wrapper_ms"], plain_ms=t["plain_ms"],
              bound_ms=t["bound_ms"], bound_by=t["bound_by"], **usage,
              geometry=k2_geometry(k, B))
    # K2-dr-tau on the same states with a full-strength DR channel
    kd = sims[False].fused_substep_dr
    chan = sims[False].dr_channel(rz.sample(gen, 3000, B))
    xd = F.pack_inputs(*ins, chan)
    xdc = xd.cpu()
    usage = ptxas_usage("libigt_fused_substep.so", k2_entry(kd))
    t = time_kernel(
        "k2drtau_timing", fixed_launch(kd, xd, yc.shape[0]), lambda: kd(*ins, chan),
        lambda: F.fused_substep_reference(consts, *ins, dr_chan=chan, with_torque=True),
        host.igt_fused_substep_tau_count_ops(cc.data_ptr(), xdc.data_ptr(), yc.data_ptr(), B,
                                             kd.nd, 1),
        4 * B * (kd.n_in() + F.n_out(kd.nd, kd.ng, True)) + 4 * kd.consts.size,
        fields={**usage, **k2_geometry(kd, B)})
    k2dr.update(ms=t["kernel_ms"], wrapper_ms=t["wrapper_ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], **usage,
                geometry=k2_geometry(kd, B))

    # K3-tau
    c8cfg = load_task_config(C8)
    c8 = types.SimpleNamespace(cfg=c8cfg, sim=Simulator(scripted.paddle_sensor_scene(c8cfg, 2),
                                                        device=dev))
    c8.scene = c8.sim.scene
    toys = {d: scripted.ToyEnv(d, device=dev, paddle_sensor=True)
            for d in (DRIVE_POS, DRIVE_EFFORT)}
    k3 = {"max_err": {}, "excess": {}}
    rollout = None
    cases = (("reset", c8, "reset", 0.0), ("rollout", c8, None, 0.0),
             ("paddle_ball1", c8, "paddle_ball1", 0.0), ("paddle_ball2", c8, "paddle_ball2", 0.0),
             ("ball_rest", c8, "ball_rest", 0.0), ("ball_ball", toys[DRIVE_POS], "ball_ball", 0.0),
             ("effort", toys[DRIVE_EFFORT], "paddle_ball1", 15.0))
    for i, (name, e, kind, scale) in enumerate(cases):
        if kind is None:   # 60 steps of the sensor scene from reset launches
            state, _ = scripted.strike_state(e.sim, "reset", B, np.random.RandomState(299),
                                             c8cfg)
            for _ in range(60):
                tgt = torch.rand((B, 14), generator=gen, device=dev) * 2 - 1
                state = e.sim.step(state, tgt, torch.zeros_like(tgt))
            ba = [b.actor_index for b in e.scene.free_bodies]
            ins = (state.dof_pos, state.dof_vel, tgt, torch.zeros_like(tgt),
                   state.root[:, ba, 0:3], state.root[:, ba, 7:10], state.root[:, ba, 10:13])
            ins = rollout = tuple(a.contiguous() for a in ins)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in scripted.k3_inputs(
                e, kind, B, np.random.RandomState(300 + i), scale))
        k = e.sim.fused_substep_multi
        if not k.with_torque:
            raise SystemExit("k3tau: the sensor scene was built without the torque lanes")
        plain = lambda *a, k=k: M.fused_substep_multi_reference(k.device_consts(dev), *a,
                                                                with_torque=True)
        fold(k3, check_kernel(f"k3tau/{name}", k, plain, ins))

    # K4-tau on C10 with a paddle sensor, on K4's sets (the same packs)
    c10sims = {raised: Simulator(scripted.paddle_sensor_scene(
        scripted.raised_table_cfg(load_task_config(C10)) if raised else load_task_config(C10),
        floating_base=True), device=dev) for raised in (False, True)}
    k4 = {"max_err": {}, "excess": {}}
    for name, (e, ins) in k4_sets.items():
        k = c10sims[name == "table"].fused_substep_floating
        if not k.with_torque or not np.array_equal(k.consts, e.sim.fused_substep_floating.consts):
            raise SystemExit("k4tau: the sensor scene's pack differs from C10's")
        plain = lambda *a, k=k: FF.floating_substep_plain(k.device_consts(dev), *a,
                                                          with_torque=True)
        res = check_kernel(f"k4tau/{name}", k, plain, ins, fields={"num_envs": B10})
        if name in ("strike", "table") and not res["max_moment"]["geom_moments"] > 0:
            raise SystemExit(f"k4tau/{name}: no geom moment reached: {res['max_moment']}")
        fold(k4, res)
    # the moment gates bite: each kernel's output with its geom or its ball
    # moment rows zeroed, or negated, fails them on some set
    rejected = {n: acc.pop("wrong_moments_rejected")
                for n, acc in (("k2tau", k2), ("k2drtau", k2dr), ("k3tau", k3), ("k4tau", k4))}
    emit({"phase": "tau_gates", "wrong_moments_rejected": rejected})
    wrong = {f"{f} {how}" for how in ("zeroed", "negated")
             for f in ("geom_moments", "ball_moments")}
    if any(wrong - set(r) for r in rejected.values()):
        raise SystemExit(f"tau_gates: the moment gates let wrong moments pass: {rejected}")
    k = c8.sim.fused_substep_multi
    x = M.pack_inputs(*rollout)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((M.n_out(k.nd_tot, k.nb, k.ng, True), B))
    consts = k.device_consts(dev)
    usage = ptxas_usage("libigt_fused_substep_multi.so", k3_entry(k))
    t = time_kernel(
        "k3tau_timing", fixed_launch(k, x, yc.shape[0]), lambda: k(*rollout),
        lambda: M.fused_substep_multi_reference(consts, *rollout, with_torque=True),
        host.igt_fused_substep_multi_tau_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(),
                                                   B, k.nd, k.K, k.nb),
        4 * B * (M.n_in(k.nd_tot, k.nb) + M.n_out(k.nd_tot, k.nb, k.ng, True))
        + 4 * k.consts.size, plain_repeats=5,
        fields={"shape": [k.nd, k.K, k.nb], **usage, **k3_geometry(k, B)})
    k3.update(ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
              bound_by=t["bound_by"], **usage)

    # K4-tau timing on K4's random-action states
    _, ins = k4_sets["random"]
    k = c10sims[False].fused_substep_floating
    x = FF.pack_inputs(*ins)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((FF.n_out(k.nd, k.ng, True), B10))
    consts = k.device_consts(dev)
    usage = ptxas_usage("libigt_fused_substep_floating.so", "Lb1E")
    geometry = k4_geometry(True, B10)
    t = time_kernel(
        "k4tau_timing", lambda: k.launch(x), lambda: k(*ins),
        lambda: FF.floating_substep_plain(consts, *ins, with_torque=True),
        host.igt_fused_substep_floating_tau_count_ops(cc.data_ptr(), xc.data_ptr(),
                                                      yc.data_ptr(), B10, k.nd),
        4 * B10 * (FF.n_in(k.nd) + FF.n_out(k.nd, k.ng, True)) + 4 * k.consts.size,
        plain_repeats=3, b=B10, fields={"num_envs": B10, **usage, **geometry})
    k4.update(ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
              bound_by=t["bound_by"], **usage)
    return k2, k2dr, k3, k4


def sensor_vs_plain(sim, state, tgt, eff):
    """One ``Simulator.step`` from ``state`` through the scene's kernel, and
    the same step with the kernel's plain version put in its place, run in
    float32 and in float64: the sensor tensor's force and moment lanes of
    the kernel's step against the plain steps', over envs whose sensors read
    a force in both the kernel's and the float32 plain step or in neither,
    held as ``compare`` holds a kernel, ``|kernel - plain64| <= SENSOR_TOL +
    |plain32 - plain64|``. Raises if they disagree."""
    import copy
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_floating as FF
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    from isaacgym_tpu_torch.sim import tensor_api as T
    name, ref = next((n, r) for n, r in (
        ("fused_substep_floating", FF.floating_substep_plain),
        ("fused_substep_multi", M.fused_substep_multi_reference),
        ("fused_substep", F.fused_substep_reference)) if getattr(sim, n) is not None)
    consts = getattr(sim, name).device_consts(state.root.device)
    plain = copy.copy(sim)
    setattr(plain, name, lambda *a: ref(consts, *a, with_torque=True))
    w = T.acquire_force_sensor_tensor(sim, sim.step(state, tgt, eff))
    w32 = T.acquire_force_sensor_tensor(plain, plain.step(state, tgt, eff))
    w64 = T.acquire_force_sensor_tensor(plain, plain.step(
        state._replace(**{f: getattr(state, f).double() for f in state._fields}),
        tgt.double(), eff.double()))
    keep = ((w[..., :3].norm(dim=-1) > 0) == (w32[..., :3].norm(dim=-1) > 0)).all(dim=1)
    res = {"flip_rate": float((~keep).float().mean()), "strikes": int(
        (w[keep][..., :3].norm(dim=-1) > 0.1).sum())}
    for lane, sl in (("force", slice(0, 3)), ("moment", slice(3, 6))):
        g, a, b = w[keep][..., sl].double(), w32[keep][..., sl].double(), w64[keep][..., sl]
        res[lane] = {"excess": float(((g - b).abs() - (a - b).abs()).max()),
                     "max_err_vs_f64_plain": float((g - b).abs().max()),
                     "f32_plain_vs_f64_plain": float((a - b).abs().max()),
                     "largest": float(b.abs().max())}
    if (res["flip_rate"] > MAX_FLIP_RATE or res["strikes"] == 0
            or any(not res[n]["excess"] <= tol for n, tol in SENSOR_TOL.items())):
        raise SystemExit(f"sensor lanes disagree with the plain version's step: {res}")
    return res


def sensor_path(dev, steps=100, relaunch_every=10):
    """The force-sensor path at full width: the flagship scene, then C8 (4096
    envs), then C10 (2048), then C11 (4096: K3-tau at <26, 2, 2>), each with
    a sensor on every paddle
    (``create_asset_force_sensor``), ``steps`` calls of ``Simulator.step``
    from scripted off-centre strikes (re-launched every ``relaunch_every``
    steps), each read through ``acquire_force_sensor_tensor``. Checks that every strike (a sensor
    force above 0.1 N) reads a non-zero moment, and after the run the first
    strike step's sensor lanes against the same step through the plain
    version (``sensor_vs_plain``). Returns the kernels' launch counts of
    this run (``flagship_dr``: K2-dr-tau's, the DR build of the flagship
    sensor scene, which this path, with DR off, leaves at 0) and the
    phase's numbers."""
    import numpy as np
    import torch
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim import tensor_api as T
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.utils.config import load_task_config

    out, launches = {}, {}
    for label, task, humanoids, kinds, b in (
            ("flagship", TASK, 1, ("paddle_ball",), B),
            ("c8", C8, 2, ("paddle_ball1", "paddle_ball2"), B),
            ("c10", C10, 1, ("strike",), B10),
            ("c11", C11, 2, ("paddle_ball1", "paddle_ball2"), B)):
        t0 = time.perf_counter()
        cfg = load_task_config(task)
        floating = label == "c10"
        sim = Simulator(c11_sensor_scene() if label == "c11" else
                        scripted.paddle_sensor_scene(cfg, humanoids, floating_base=floating),
                        device=dev)
        k = (sim.fused_substep_floating if floating else
             sim.fused_substep if humanoids == 1 else sim.fused_substep_multi)
        rng = np.random.RandomState(7)

        def strike(kind):
            """A strike state, its targets and efforts."""
            if floating:
                env = types.SimpleNamespace(scene=sim.scene, cfg=cfg)
                return scripted.k4_state(sim, scripted.k4_inputs(env, kind, b, rng))
            state, tgt = scripted.strike_state(sim, kind, b, rng)
            return state, tgt, torch.zeros_like(tgt)

        state, tgt, eff = strike(kinds[0])
        sim.step(state, tgt, eff)   # warm-up
        torch.cuda.synchronize()
        wrappers = (sim.fused_substep, sim.fused_substep_dr, sim.fused_substep_multi,
                    sim.fused_substep_floating)
        for kk in wrappers:
            if kk is not None:
                kk.launches = 0
        step_s, read_s, strikes, moments = 0.0, 0.0, 0, 0
        rows = torch.as_tensor(sim.scene.force_sensor_bodies, device=dev)
        for i in range(steps):
            if i % relaunch_every == 0:
                state, tgt, eff = strike(kinds[(i // relaunch_every) % len(kinds)])
                if i == 0:
                    first = (state, tgt, eff)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            state = sim.step(state, tgt, eff)
            torch.cuda.synchronize()
            tr = time.perf_counter()
            w = T.acquire_force_sensor_tensor(sim, state)
            torch.cuda.synchronize()
            read_s += time.perf_counter() - tr
            step_s += tr - ts
            hit = w[..., :3].norm(dim=-1) > 0.1
            strikes += int(hit.sum())
            moments += int((hit & (w[..., 3:].norm(dim=-1) > 0)).sum())
        finite = all(bool(torch.isfinite(t).all()) for t in state)
        launches[label] = k.launches
        if sim.fused_substep_dr is not None:   # K2-dr-tau: DR is off on this path
            launches[f"{label}_dr"] = sim.fused_substep_dr.launches
        # every kernel of the scene is the torque build: no sensor-less one ran
        sensorless = sum(kk.launches for kk in wrappers
                         if kk is not None and not kk.with_torque)
        out[label] = {"num_envs": b, "steps": steps, "sensors": int(rows.numel()),
                      "launches": k.launches, "sensorless_launches": sensorless,
                      "env_steps_per_s": b * steps / step_s,
                      "us_per_acquire_force_sensor_tensor": read_s / steps * 1e6,
                      "strikes": strikes, "strikes_with_moment": moments, "finite": finite}
        if (k.launches != 2 * steps or sensorless or not finite or strikes == 0
                or moments != strikes):
            raise SystemExit(f"sensors/{label}: {out[label]}")
        out[label]["vs_plain_step"] = sensor_vs_plain(sim, *first)
        out[label]["seconds"] = time.perf_counter() - t0
        emit({"phase": f"sensors/{label}", **out[label]})
    return launches, out


def ptxas_usage(lib_name, entry=""):
    """Registers, stack frame, spill bytes and static shared memory per block
    of a library's kernels whose mangled name holds ``entry`` (all by
    default), from its ``ptxas -v`` output (the build of this run)."""
    import re
    from isaacgym_tpu_torch.ops import _build
    blocks = _build.build_logs.get(lib_name, "").split("Compiling entry function")[1:]
    log = "".join(b for b in blocks if entry in b.splitlines()[0])
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    stack = [int(m) for m in re.findall(r"(\d+) bytes stack frame", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)]
    return {"registers": max(regs, default=None), "stack_bytes": max(stack, default=None),
            "spill_bytes": max(spills, default=None), "smem_bytes": max(smem, default=0)}


def launch_geometry(occupancy, b, what):
    """A warp kernel's launch at ``b`` envs. ``occupancy(out)`` is the
    library's occupancy entry (``igt_floating_occupancy``,
    ``igt_multi_occupancy``: a warp per env; ``igt_fused_occupancy``,
    ``igt_arm_occupancy``: two envs to a warp) filling ``out`` with the envs
    of a block and the blocks per SM that its ``__launch_bounds__`` asks for,
    from the library, the blocks an SM holds, from the CUDA runtime's
    occupancy calculator on the built kernel (computed, not a reading of the
    run), and (the two-env entries) the warps of a block. Returns those and
    how the blocks land on the card's SMs."""
    import ctypes
    import torch
    out = (ctypes.c_int * 4)()
    err = occupancy(ctypes.addressof(out))
    if err != 0:
        raise SystemExit(f"{what} geometry: the occupancy calculator returned {err}")
    envs, asked, fit, warps = out
    warps = warps or envs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = (b + envs - 1) // envs
    busy = min(blocks, sms)
    return {"envs_per_block": envs, "warps_per_block": warps, "threads_per_block": 32 * warps,
            "blocks": blocks, "sms": sms, "blocks_per_sm_asked": asked,
            "blocks_per_sm_fit": fit, "waves": -(-blocks // (sms * fit)), "sms_busy": busy,
            "warps_per_busy_sm": blocks * warps / busy}


def k2_geometry(k, b):
    """The launch of K2 wrapper ``k``'s build (K2, K2-dr, K2-tau, K2-dr-tau)
    at ``b`` envs (launch_geometry)."""
    from isaacgym_tpu_torch.ops import _build
    lib = _build.cuda_library("fused_substep")
    return launch_geometry(lambda out: lib.igt_fused_occupancy(
        int(k.with_dr), int(k.with_torque), out, 4), b, "k2")


def k2_entry(k):
    """The mangled-name fragment of K2 wrapper ``k``'s kernel in ptxas's log:
    its template arguments <ND, WITH_DR, WITH_TORQUE>."""
    return f"ILi{k.nd}ELb{int(k.with_dr)}ELb{int(k.with_torque)}E"


def k1_geometry(b):
    """K1's launch at ``b`` envs (launch_geometry)."""
    from isaacgym_tpu_torch.ops import _build
    lib = _build.cuda_library("arm_step")
    return launch_geometry(lambda out: lib.igt_arm_occupancy(out, 4), b, "k1")


def k4_geometry(with_torque, b):
    """K4's (K4-tau's) launch at ``b`` envs (launch_geometry)."""
    from isaacgym_tpu_torch.ops import _build
    lib = _build.cuda_library("fused_substep_floating")
    return launch_geometry(lambda out: lib.igt_floating_occupancy(int(with_torque), out, 3), b,
                           "k4")


def k3_geometry(k, b):
    """The launch of K3 (K3-tau) wrapper ``k``'s build at ``b`` envs
    (launch_geometry)."""
    from isaacgym_tpu_torch.ops import _build
    lib = _build.cuda_library("fused_substep_multi")
    return launch_geometry(lambda out: lib.igt_multi_occupancy(
        k.nd, k.K, k.nb, int(k.with_torque), out, 3), b, "k3")


def fixed_launch(k, x, rows):
    """One launch of wrapper ``k`` (K1, K2's builds, K3, K3-tau) on the
    packed buffer ``x`` into a (rows, B) output allocated once (its
    ``launcher``): the kernel's time alone. The wrapper's call packs its
    inputs and allocates and unpacks its output every time, which at these
    kernels' tens of microseconds a launch sets the pace from the host
    (wrapper_ms)."""
    import torch
    return k.launcher(x, torch.empty((rows, x.shape[1]), device=x.device))


def k3_entry(k):
    """The mangled-name fragment of K3 (K3-tau) wrapper ``k``'s kernel in
    ptxas's log: its template arguments <ND, K, NB, WITH_TORQUE>."""
    return f"ILi{k.nd}ELi{k.K}ELi{k.nb}ELb{int(k.with_torque)}E"


def k4_checks(dev, host):
    """K4 against its plain version (float32 and float64) on C10 at 2048 envs,
    five sets: stand (the neutral pose, resting foot contacts), random (60
    env steps under random actions), strike (a paddle-ball strike), fall (a
    falling humanoid hitting the ground) and table (standing on the raised
    table, art-vs-static); then that the gates reject K4's output with the
    base's linear velocity negated, and K4's output on the scene lifted above
    its ground (k4_gates); then its timing, bound and ptxas usage (k4_timing). Returns
    the kernels-line numbers; raises on any failed gate."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.ops import fused_substep_floating as FF
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.utils.config import load_task_config

    env = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=B10)
    env_raised = isaacgym_tpu_torch.make(
        seed=0, task=C10, num_envs=B10, cfg=scripted.raised_table_cfg(load_task_config(C10)))

    lift = 2.0

    def lifted(k):
        """K4 on a copy of the scene's pack whose statics stand ``lift`` m
        higher (its own wrapper and count)."""
        consts = k.consts.copy()
        lay = FF.layout(k.nd)
        for si in range(int(consts[FF.C_NSTATIC])):
            consts[lay["static"] + si * FF.STATIC_STRIDE + FF.G_POS + 2] += lift
        return FF.FusedSubstepFloating(consts)

    def no_ground(k_lifted, ins):
        """The wrong form the gates must reject: K4 with its ground contacts
        dropped. The scene, humanoid and ball included, is run ``lift`` m
        above its ground and brought back down; gravity is uniform, so only
        the ground contacts (feet and ball) differ from the real step."""
        ins = list(ins)
        for i in (4, 8):   # base pos, ball pos
            ins[i] = ins[i] + torch.tensor([0.0, 0.0, lift], device=dev)
        out = k_lifted(*ins)
        down = torch.tensor([0.0, 0.0, lift], device=dev)
        return out._replace(base_pos=out.base_pos - down, ball_pos=out.ball_pos - down)

    acc, sets = {"max_err": {}, "excess": {}}, {}
    wrong = {"base_linvel negated": [], "ground contacts dropped": []}
    bad_forms = {}
    for i, name in enumerate(("stand", "random", "strike", "fall", "table")):
        t0 = time.perf_counter()
        e = env_raised if name == "table" else env
        if name == "random":
            ins = scripted.k4_random_inputs(env, B10)
        else:
            ins = tuple(torch.as_tensor(a, device=dev) for a in
                        scripted.k4_inputs(e, name, B10, np.random.RandomState(400 + i)))
        k = e.sim.fused_substep_floating
        consts = k.device_consts(dev)
        got = k(*ins)
        want = FF.floating_substep_plain(consts, *ins)
        want64 = FF.floating_substep_plain(consts, *[t.double() for t in ins])
        torch.cuda.synchronize()
        res = compare(got, want, want64)
        emit({"phase": f"k4/{name}", **res,
              "contact_rows_active": (got.impulses.abs().sum(-1) > 0).float().mean(0).tolist(),
              "seconds": time.perf_counter() - t0})
        gate(f"k4/{name}", res)
        fold(acc, res)
        sets[name] = (e, ins)
        if e not in bad_forms:
            bad_forms[e] = lifted(k)
        for form, out in (("base_linvel negated", got._replace(base_linvel=-got.base_linvel)),
                          ("ground contacts dropped", no_ground(bad_forms[e], ins))):
            r = compare(out, want, want64)
            if (any(not v <= TOL[f] for f, v in r["excess"].items())
                    or r["flip_rate"] > MAX_FLIP_RATE):
                wrong[form].append(name)
    emit({"phase": "k4_gates", "rejected_on_sets": wrong})
    if not all(wrong.values()):
        raise SystemExit(f"k4_gates: the gates let a wrong K4 output pass on every set: {wrong}")

    # timing at the main path's shape, on the random-action states
    e, ins = sets["random"]
    k = e.sim.fused_substep_floating
    x = FF.pack_inputs(*ins)
    consts = k.device_consts(dev)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((FF.n_out(k.nd, k.ng), B10))
    usage = ptxas_usage("libigt_fused_substep_floating.so", "Lb0E")
    geometry = k4_geometry(False, B10)
    t = time_kernel(
        "k4_timing", lambda: k.launch(x), lambda: k(*ins),
        lambda: FF.floating_substep_plain(consts, *ins),
        host.igt_fused_substep_floating_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(),
                                                  B10, k.nd),
        4 * B10 * (FF.n_in(k.nd) + FF.n_out(k.nd, k.ng)) + 4 * k.consts.size,
        plain_repeats=3, b=B10, fields={"num_envs": B10, **usage, **geometry})
    return dict(acc, ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], **usage), sets


def nonkernel_compare(got, want, gate):
    """Two ``SimState``s, the non-kernel step's and another route's or
    device's, per field over the envs that are not flips (root more than 0.1
    apart): the largest deviation, whether every field is within ``gate``,
    and the flip rate (``tests/test_torch_nonkernel.py``'s ``_compare``)."""
    import torch
    n = got.root.shape[0]
    d_root = (got.root - want.root.to(got.root.device)).abs().reshape(n, -1).max(dim=1).values
    clean = d_root <= 0.1
    dev = {}
    for f in got._fields:
        d = (getattr(got, f) - getattr(want, f).to(got.root.device)).abs()[clean]
        dev[f] = float(d.max()) if d.numel() else 0.0
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    flip_rate = float((~clean).float().mean())
    within = (all(dev[f] <= gate[f] for f in gate) and flip_rate <= MAX_FLIP_RATE
              and finite)
    return {"max_dev": dev, "flip_rate": flip_rate, "finite": finite, "within_gate": within}


def dr_checks(dev, steps=10):
    """Domain randomization on C8 (4096 envs) and C10 (2048): ``make`` with
    ``task.randomize=true``, every DR term at full strength (global step
    3000), ``steps`` env steps under random actions through the non-kernel
    step (K3 and K4 launched 0 times), every state finite; then from the
    last state one ``Simulator.step`` with an identity channel against the
    kernel route's step (within the non-kernel gate) and one with the
    full-strength channel, which must differ beyond it. Returns the phases'
    numbers; raises on any failed check."""
    import copy
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.env.randomize import identity_params
    from isaacgym_tpu_torch.utils.config import load_task_config

    out = {}
    for label, task, b, act, gate in (("c8", C8, B, 14, NONKERNEL_GATE),
                                      ("c10", C10, B10, 27, NONKERNEL_GATE_C10)):
        t0 = time.perf_counter()
        cfg = copy.deepcopy(load_task_config(task))
        cfg["task"]["randomize"] = True
        env = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=b, cfg=cfg)
        sim = env.sim
        k = sim.fused_substep_multi if label == "c8" else sim.fused_substep_floating
        gen = torch.Generator(device=dev)
        gen.manual_seed(9)
        act_fn = lambda: torch.rand((b, act), generator=gen, device=dev) * 2 - 1
        state, obs = env.reset()
        state = state._replace(global_step=torch.full_like(state.global_step, 3000),
                               dr=env.randomizer.sample(env.generator, 3000, b))
        state, *_ = env.step(state, act_fn())   # warm-up
        torch.cuda.synchronize()
        k.launches = 0
        tw = time.perf_counter()
        for _ in range(steps):
            state, obs, rew, done, info = env.step(state, act_fn())
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        launches = k.launches
        finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
            torch.isfinite(obs).all() and torch.isfinite(rew).all())
        tgt, eff = env.action_to_drive(act_fn())
        kernel_step = sim.step(state.sim, tgt, eff)
        # the sensor-less kernel route leaves net_contact_torque at zero and
        # the non-kernel step fills it: every other field is compared
        gate = {f: v for f, v in gate.items() if f != "net_contact_torque"}
        ident = nonkernel_compare(sim.step(state.sim, tgt, eff,
                                           identity_params(env.scene.num_dofs, b, dev)),
                                  kernel_step, gate)
        full = nonkernel_compare(sim.step(state.sim, tgt, eff, state.dr), kernel_step, gate)
        out[label] = {"num_envs": b, "steps": steps, "route": sim.route,
                      "kernel_launches": launches, "finite": finite,
                      "env_steps_per_s": b * steps / wall, "ms_per_step": wall / steps * 1e3,
                      "identity_vs_kernel_step": ident, "full_strength_vs_kernel_step": full,
                      "seconds": time.perf_counter() - t0}
        emit({"phase": f"dr/{label}", **out[label]})
        if launches or not finite or not ident["within_gate"] or full["within_gate"]:
            raise SystemExit(f"dr/{label}: {out[label]}")
    return out


def route_checks(dev, b=1024):
    """Scenes at shapes no kernel library is built for, the JAX tests' 4-DOF
    floating biped and a 3-DOF single-ball arm: on the card the simulator
    takes the non-kernel route and holds no kernel, and one step from a
    seeded random state equals the CPU's non-kernel step from the same
    state within the non-kernel gate. Raises on any failed check."""
    import numpy as np
    import torch
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.simulator import Simulator

    for label, scene_fn, gate in (("biped", scripted.toy_biped_scene, NONKERNEL_GATE_C10),
                                  ("arm3", scripted.toy_arm_scene, NONKERNEL_GATE)):
        t0 = time.perf_counter()
        scene = scene_fn()
        sim, cpu = Simulator(scene, device=dev), Simulator(scene, device="cpu")
        kernels = [n for n in ("arm_steps", "fused_substep", "fused_substep_dr",
                               "fused_substep_multi", "fused_substep_floating")
                   if getattr(sim, n) is not None]
        state, tgt, eff = scripted.random_state(cpu, b, np.random.RandomState(11))
        want = cpu.step_nonkernel(state, tgt, eff)
        got = sim.step(type(state)(*[t.to(dev) for t in state]), tgt.to(dev), eff.to(dev))
        res = nonkernel_compare(got, want, gate)
        emit({"phase": f"routes/{label}", "num_envs": b, "route": sim.route,
              "route_on_cpu": cpu.route, "kernels_held": kernels,
              "dofs": [sl.model.tree.n_dof for sl in scene.articulations],
              "contact_envs": int((got.net_contact_force.abs().sum((1, 2)) > 0).sum()),
              **res, "seconds": time.perf_counter() - t0})
        if sim.route != "nonkernel" or kernels or not res["within_gate"]:
            raise SystemExit(f"routes/{label}: route {sim.route}, kernels {kernels}, {res}")


def terrain_env(b, seed=0):
    """The flagship on the seeded rough heightfield with the heightmap block
    (``rough_terrain_cfg``): K1 and the non-kernel contact phase."""
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.tasks.pingpong_common import rough_terrain_cfg
    from isaacgym_tpu_torch.utils.config import load_task_config
    return isaacgym_tpu_torch.make(seed=seed, task=TASK, num_envs=b,
                                   cfg=rough_terrain_cfg(load_task_config(TASK), seed=seed))


def k1_checks(dev, host, env_t):
    """K1 against its plain version (float32 and float64) on the flagship arm
    at 4096 envs, three sets: random (joints, velocities and PD targets
    uniform within the limits and +-3 rad/s), limits (every joint at or
    just past a limit, moving outward, so the clamp acts), terrain (60 env
    steps of the terrain flagship ``env_t`` under random actions). Flips
    are envs whose set of clamped joints differs from the float32 plain
    run's. Then that the gates reject K1's output with qd_new negated
    (k1_gates), and its timing, bound and ptxas usage (k1_timing). Returns
    the kernels-line numbers; raises on any failed gate."""
    import numpy as np
    import torch
    from isaacgym_tpu_torch.ops import arm_step as A
    sim = env_t.sim
    k = sim.arm_steps[0]
    slot = sim.scene.articulations[0]
    tree = slot.model.tree
    lo_np, hi_np = tree.lower.astype(np.float64), tree.upper.astype(np.float64)
    lo, hi = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (lo_np, hi_np))
    init = torch.as_tensor(sim.scene.initial_root[slot.actor_index], device=dev)
    base = (init[0:3].expand(B, 3).contiguous(), init[3:7].expand(B, 4).contiguous())
    limit_pattern = lambda o: (o["q_new"] <= lo) | (o["q_new"] >= hi)
    plain = lambda *a: A.arm_step_plain(k.device_consts(dev), *a)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    rng = np.random.RandomState(11)
    sets = {}
    sets["random"] = (t(rng.uniform(lo_np, hi_np, (B, 7))), t(rng.uniform(-3, 3, (B, 7))),
                      t(rng.uniform(lo_np, hi_np, (B, 7))), t(np.zeros((B, 7))))
    side = rng.uniform(size=(B, 7)) < 0.5
    q = np.where(side, lo_np, hi_np) + np.where(side, -1, 1) * rng.uniform(-0.01, 0.02, (B, 7))
    sets["limits"] = (t(q), t(np.where(side, -1, 1) * rng.uniform(0.0, 4.0, (B, 7))),
                      t(np.where(side, lo_np, hi_np) + np.where(side, -0.5, 0.5)),
                      t(np.zeros((B, 7))))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    state, _ = env_t.reset()
    for _ in range(60):
        state, *_ = env_t.step(state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
    tgt, eff = env_t.action_to_drive(torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
    sets["terrain"] = (state.sim.dof_pos.contiguous(), state.sim.dof_vel.contiguous(),
                       tgt.contiguous(), eff.contiguous())
    acc, rejected = {"max_err": {}, "excess": {}}, []
    for name, ins in sets.items():
        t0 = time.perf_counter()
        ins = ins + base
        got = k(*ins)
        want, want64 = plain(*ins), plain(*[x.double() for x in ins])
        torch.cuda.synchronize()
        res = compare(got, want, want64, pattern=limit_pattern)
        emit({"phase": f"k1/{name}", **res,
              "clamped_share": float(limit_pattern({"q_new": got.q_new}).float().mean()),
              "seconds": time.perf_counter() - t0})
        gate(f"k1/{name}", res)
        fold(acc, res)
        bad = compare(got._replace(qd_new=-got.qd_new), want, want64, pattern=limit_pattern)
        if not bad["excess"]["qd_new"] <= TOL["qd_new"]:
            rejected.append(name)
        if name == "random":
            timing_ins = ins
    # an odd B: the last warp's second env idle
    t0 = time.perf_counter()
    ins = tuple(t[:B - 1].contiguous() for t in timing_ins)
    got = k(*ins)
    res = compare(got, plain(*ins), plain(*[x.double() for x in ins]), pattern=limit_pattern)
    emit({"phase": "k1/odd", "num_envs": B - 1, **res, "seconds": time.perf_counter() - t0})
    gate("k1/odd", res)
    fold(acc, res)
    emit({"phase": "k1_gates", "negated_qd_new_rejected_on": rejected})
    if not rejected:
        raise SystemExit("k1_gates: the gates let K1 with a negated qd_new pass")
    x = A.pack_inputs(*timing_ins)
    xc, cc = x.cpu(), torch.as_tensor(k.consts)
    yc = torch.empty((A.n_out(7), B))
    usage = ptxas_usage("libigt_arm_step.so")
    tk = time_kernel(
        "k1_timing", fixed_launch(k, x, A.n_out(7)), lambda: k(*timing_ins),
        lambda: A.arm_step_plain(k.device_consts(dev), *timing_ins),
        host.igt_arm_step_count_ops(cc.data_ptr(), xc.data_ptr(), yc.data_ptr(), B, 7),
        4 * B * (A.n_in(7) + A.n_out(7)) + 4 * k.consts.size,
        fields={**usage, **k1_geometry(B)})
    return {**acc, "ms": tk["kernel_ms"], "wrapper_ms": tk["wrapper_ms"],
            "plain_ms": tk["plain_ms"], "bound_ms": tk["bound_ms"], "bound_by": tk["bound_by"],
            **usage, "geometry": k1_geometry(B)}


def terrain_main(dev, env_t, window=50):
    """The terrain flagship at 4096 envs through K1: 3 windows of ``window``
    steps (formerly 100) under uniform random actions, K1 exactly 2 launches per step and K2
    none, every state finite, some ball bounces; then torch.profiler over
    10 steps. Returns K1's launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    sim = env_t.sim
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    act = lambda: torch.rand((B, 7), generator=gen, device=dev) * 2 - 1
    k1 = sim.arm_steps[0]
    state, obs = env_t.reset()
    for _ in range(5):
        state, obs, rew, done, info = env_t.step(state, act())
    torch.cuda.synchronize()
    k1.launches = 0
    windows, zs, steps = [], [], 0
    for _ in range(3):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for _ in range(window):
            state, obs, rew, done, info = env_t.step(state, act())
            zs.append(state.sim.root[:, 2, 2].clone())
            steps += 1
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - tw)
    launches = k1.launches
    k2 = 0 if sim.fused_substep is None else sim.fused_substep.launches
    finite = all(bool(torch.isfinite(t_).all()) for t_ in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    bounced = bounced_envs(zs, dev)
    rates = [B * window / w for w in windows]
    emit({"phase": "terrain_main", "num_envs": B, "steps": steps, "k1_launches": launches,
          "k2_launches": k2, "route": sim.route, "obs_shape": list(obs.shape),
          "env_steps_per_s": rates, "env_steps_per_s_median": statistics.median(rates),
          "ms_per_step": [w * 1e3 / window for w in windows], "bounced_envs": bounced,
          "ball_z_min": float(torch.stack(zs).min()),
          "seconds": time.perf_counter() - t0})
    if (launches != 2 * steps or k2 != 0 or not finite or bounced == 0
            or tuple(obs.shape) != (B, 305)):
        raise SystemExit(f"terrain_main: K1 {launches} and K2 {k2} launches in {steps} steps, "
                         f"finite={finite} bounced={bounced} obs {tuple(obs.shape)}")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        for _ in range(10):
            state, *_ = env_t.step(state, act())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tw) * 1e6
    kernels = [(n, c, t_) for n, (c, t_) in device_kernels(prof).items()]
    busy_us = sum(t_ for _, _, t_ in kernels)
    k1_us = sum(t_ for n, _, t_ in kernels if "arm_step" in n)
    top = sorted(kernels, key=lambda r: -r[2])[:6]
    emit({"phase": "terrain_profile", "steps": 10, "wall_ms_per_step": wall_us / 1e4,
          "device_busy_ms_per_step": busy_us / 1e4, "device_busy_share": busy_us / wall_us,
          "device_kernels_per_step": sum(c for _, c, _ in kernels) / 10,
          "k1_ms_per_step": k1_us / 1e4, "k1_share_of_busy": k1_us / busy_us,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t_ / 1e3} for n, c, t_ in top],
          "seconds": time.perf_counter() - t0})
    return launches


def guard_cost(dev, env):
    """The baked-root guard's cost on the flagship's main cell: windows of
    100 env steps through the guarded ``Simulator.step`` and through
    ``step_kernel`` (no compare, no sync), in turns guarded, unguarded,
    unguarded, guarded, and the compare alone per call."""
    import torch
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    act = lambda: torch.rand((B, 7), generator=gen, device=dev) * 2 - 1
    sim = env.sim
    guarded = sim.step   # the class's method, bound
    rates = {"guarded": [], "unguarded": []}
    state, _ = env.reset()
    for mode in ("guarded", "unguarded", "unguarded", "guarded"):
        sim.step = guarded if mode == "guarded" else sim.step_kernel
        for _ in range(3):
            state, *_ = env.step(state, act())
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for _ in range(100):
            state, *_ = env.step(state, act())
        torch.cuda.synchronize()
        rates[mode].append(B * 100 / (time.perf_counter() - tw))
    del sim.step   # back to the class's method
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(200):
        sim.baked_roots_moved(state.sim)
    compare_us = (time.perf_counter() - tw) / 200 * 1e6
    med = {k_: statistics.median(v) for k_, v in rates.items()}
    emit({"phase": "guard_cost", "env_steps_per_s": rates,
          "ms_per_step_guarded": B / med["guarded"] * 1e3,
          "ms_per_step_unguarded": B / med["unguarded"] * 1e3,
          "guard_ms_per_step": B / med["guarded"] * 1e3 - B / med["unguarded"] * 1e3,
          "compare_and_sync_us_per_call": compare_us,
          "seconds": time.perf_counter() - t0})


def baked_guard(dev):
    """The baked-root guard on the card: on the flagship (K2, 4096 envs, the
    ball resting on the table) and on C10 (K4, 2048 envs, standing on the
    raised table) the table root written in every env (raised 4 cm, or
    lowered 4 cm under C10's feet). The guarded ``Simulator.step`` must
    equal ``step_nonkernel`` and differ from the unguarded ``step_kernel``
    (the guard dropped, which the check must reject); with the roots
    untouched it must equal ``step_kernel`` exactly."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim import tensor_api as T
    from isaacgym_tpu_torch.utils.config import load_task_config
    out = {}
    for name, task, b, cfg_fn, inputs, to_state, delta in (
            ("flagship", TASK, B, lambda c: c, scripted.k2_inputs, scripted.k2_state, 0.04),
            ("c10", C10, B10, scripted.raised_table_cfg, scripted.k4_inputs, scripted.k4_state,
             -0.04)):
        t0 = time.perf_counter()
        env = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=b,
                                      cfg=cfg_fn(load_task_config(task)))
        sim = env.sim
        kind = "ball_rest" if name == "flagship" else "table"
        state, tgt, eff = to_state(sim, inputs(env, kind, b, np.random.RandomState(9)))
        same = lambda a, c: all(torch.equal(getattr(a, f), getattr(c, f)) for f in a._fields)
        untouched_ok = same(sim.step(state, tgt, eff), sim.step_kernel(state, tgt, eff))
        table = state.root[:, [1]].clone()
        table[:, 0, 2] += delta
        moved = T.set_actor_root_state_tensor_indexed(state, table, torch.arange(b, device=dev),
                                                      actor_ids=[1])
        guarded = sim.step(moved, tgt, eff)
        nonkernel = sim.step_nonkernel(moved, tgt, eff)
        unguarded = sim.step_kernel(moved, tgt, eff)
        guarded_ok = same(guarded, nonkernel)
        dropped_rejected = not same(unguarded, nonkernel)
        diff = {f: float((getattr(unguarded, f) - getattr(nonkernel, f)).abs().max())
                for f in ("root", "dof_vel", "net_contact_force")}
        finite = all(bool(torch.isfinite(t_).all()) for t_ in guarded)
        emit({"phase": f"baked_guard/{name}", "route": sim.route, "num_envs": b,
              "untouched_equals_kernel_step": untouched_ok,
              "moved_equals_nonkernel_step": guarded_ok,
              "guard_dropped_rejected": dropped_rejected,
              "kernel_vs_nonkernel_on_moved": diff, "finite": finite,
              "seconds": time.perf_counter() - t0})
        if not (untouched_ok and guarded_ok and dropped_rejected and finite):
            raise SystemExit(f"baked_guard/{name}: untouched {untouched_ok} moved {guarded_ok} "
                             f"dropped rejected {dropped_rejected} finite {finite}")
        out[name] = diff
        del env, sim
    return out


def terrain_train(dev):
    """2 PPO epochs of the terrain flagship at 4096 envs on its train config,
    without DR, every env 29 steps from its episode's end at the start (so
    episodes finish in the first epoch), through ``train_epochs``: K1
    exactly 2 x 32 launches per epoch and episodes of 169 steps. Returns
    K1's launches."""
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from isaacgym_tpu_torch.tasks.pingpong_common import rough_terrain_cfg
    from isaacgym_tpu_torch.utils.config import compose
    cfg = compose(TASK, [f"num_envs={B}"])
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, cfg=rough_terrain_cfg(cfg["task"], seed=0))
    trainer = PPOTrainer(env, PPOConfig.from_train_cfg(cfg["train"]), seed=0)
    state, obs = env.reset()
    state = state._replace(progress=torch.full_like(state.progress,
                                                    env.max_episode_length - 30))
    rows = train_epochs("terrain_train", env, trainer, {"k1": env.sim.arm_steps[0]},
                        {"k1": 2 * trainer.cfg.horizon_length}, 2, state=state, obs=obs,
                        episode_length=169.0)[3]
    if not rows[0]["episode_count"]:
        raise SystemExit("terrain_train: no episode finished in the first epoch")
    return sum(r["k1_launches"] for r in rows)


def c11_sensor_scene():
    """C11's scene with a force sensor on each humanoid's paddle (K3-tau at
    <26, 2, 2>)."""
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.tasks.humanoid_pingpong_draft_5actor import build_5actor_scene
    from isaacgym_tpu_torch.utils.config import load_task_config
    return scripted.with_paddle_sensor(build_5actor_scene(load_task_config(C11)["sim"]))


def link_checks(dev, b=B, steps=30, flagship_steps=20):
    """The link-vs-link narrowphase (``link_collision``) on the card, through
    the non-kernel step: the JAX tests' two pendulums and sibling arms
    (``scripted.pendulum_scene``, ``sibling_arms_scene``) batched to ``b``
    envs with per-env swing velocities, ``steps`` steps each; the flagship
    with ``linkCollision`` on at ``b`` envs, ``flagship_steps`` steps under
    random actions. Each: route nonkernel and no kernel held (0 launches),
    its pair count, ms per step, and one step, from the state of the run's
    busiest link-contact step (the scenes) or its last state (the flagship),
    against the CPU's non-kernel step from the same state within
    NONKERNEL_GATE, flip-aware. Raises on any failed check."""
    import copy
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.utils.config import load_task_config

    held = lambda sim: [n for n in ("arm_steps", "fused_substep", "fused_substep_dr",
                                    "fused_substep_multi", "fused_substep_floating")
                        if getattr(sim, n) is not None]
    to = lambda s, d: type(s)(*[t.to(d) for t in s])
    for label, scene_fn in (("pendulums", scripted.pendulum_scene),
                            ("sibling_arms", scripted.sibling_arms_scene)):
        t0 = time.perf_counter()
        scene = scene_fn()
        sim, cpu = Simulator(scene, device=dev), Simulator(scene, device="cpu")
        state, tgt = scripted.link_strike_state(sim, b, np.random.RandomState(13))
        zero = torch.zeros_like(tgt)
        sim.step(state, tgt, zero)   # warm-up
        torch.cuda.synchronize()
        states, contacts = [state], []
        tw = time.perf_counter()
        for _ in range(steps):
            state = sim.step(state, tgt, zero)
            states.append(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tw
        for s in states[1:]:
            contacts.append(int((s.net_contact_force.abs().sum((1, 2)) > 0).sum()))
        i = int(np.argmax(contacts))
        want = cpu.step_nonkernel(to(states[i], "cpu"), tgt.cpu(), zero.cpu())
        res = nonkernel_compare(states[i + 1], want, NONKERNEL_GATE)
        row = {"num_envs": b, "steps": steps, "route": sim.route, "kernels_held": held(sim),
               "link_pairs": len(sim._art_art_pairs), "ms_per_step": wall * 1e3 / steps,
               "contact_envs_per_step": contacts, "compared_step": i, **res,
               "seconds": time.perf_counter() - t0}
        if label == "pendulums":   # the struck pendulum swings afterwards
            row["struck_envs_swinging"] = int((states[-1].dof_vel[:, 1].abs() > 0.5).sum())
        emit({"phase": f"link/{label}", **row})
        if (sim.route != "nonkernel" or row["kernels_held"] or not row["link_pairs"]
                or not res["within_gate"] or contacts[i] == 0
                or row.get("struck_envs_swinging", 1) == 0):
            raise SystemExit(f"link/{label}: {row}")

    t0 = time.perf_counter()
    cfg = copy.deepcopy(load_task_config(TASK))
    cfg["env"]["scene"]["linkCollision"] = True
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=b, cfg=cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    act = lambda: torch.rand((b, 7), generator=gen, device=dev) * 2 - 1
    state, obs = env.reset()
    state, *_ = env.step(state, act())   # warm-up
    torch.cuda.synchronize()
    tw = time.perf_counter()
    for _ in range(flagship_steps):
        state, obs, rew, done, info = env.step(state, act())
    torch.cuda.synchronize()
    wall = time.perf_counter() - tw
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    tgt, eff = env.action_to_drive(act())
    got = env.sim.step(state.sim, tgt, eff)
    cpu = Simulator(env.scene, device="cpu")
    want = cpu.step_nonkernel(to(state.sim, "cpu"), tgt.cpu(), eff.cpu())
    res = nonkernel_compare(got, want, NONKERNEL_GATE)
    row = {"num_envs": b, "steps": flagship_steps, "route": env.sim.route,
           "kernels_held": held(env.sim), "link_pairs": len(env.sim._art_art_pairs),
           "ms_per_step": wall * 1e3 / flagship_steps,
           "env_steps_per_s": b * flagship_steps / wall, "finite": finite, **res,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "link/flagship", **row})
    if (env.sim.route != "nonkernel" or row["kernels_held"] or row["link_pairs"] != 14
            or not finite or not res["within_gate"]):
        raise SystemExit(f"link/flagship: {row}")


# the camera on the card against its CPU render of the same states: depth
# within 1e-4 m (plus two float32 ulps of the depth: ground hits near the
# horizon lie kilometres off) where both hit, seg equal on at least 99.9 % of
# pixels and unequal only where the two nearest hits lie within 1e-4 m
# (tests/test_torch_camera.py's gates against the JAX camera); rgb within
# CAMERA_RGB_TOL where seg agrees, plus, on a body (not the ground, whose
# normal is exact), what the two renders' own depth difference there allows:
# the shading is the colour (at most 1) times 0.35 + 0.65 n.l, and a hit
# moved by dt along the ray turns a sphere's or a cylinder's normal by at
# most dt / r, so 0.65 |dt| / r with r the scene's smallest curved radius
# (the 2 cm ball). The card's fused multiply-adds move the ball's grazing
# hits by up to 6.7e-5 m, and their rgb by 4.7e-4, which that term covers;
# on every other pixel the card equals the CPU render to 6e-8 (PERF.md
# §6). CAMERA_RGB_TOL lies between that and the smallest of the planted
# shading faults that camera/flagship renders and must see rejected: the
# light turned by CAMERA_FAULT_RAD about x, y or z (the smallest, about z,
# read 5.9e-5), a palette colour scaled by 1 + CAMERA_FAULT_REL.
CAMERA_DEPTH_TOL, CAMERA_SEG_AGREE, CAMERA_RGB_TOL = 1e-4, 0.999, 1e-5
CAMERA_FAULT_RAD, CAMERA_FAULT_REL = 3e-4, 1e-3


def profiled_first_update(trainer, rec):
    """Wrap ``trainer._update`` so that its first call runs under
    torch.profiler (device activity only): ``rec`` gets the update's device
    kernels, the minibatches it ran and its wall seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    real = trainer._update

    def update(ts, batch, obs_stats):
        if rec:
            return real(ts, batch, obs_stats)
        cfg = trainer.cfg
        n_mb = cfg.mini_epochs * (batch["logp"].shape[0] // min(cfg.minibatch_size,
                                                                 batch["logp"].shape[0]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = real(ts, batch, obs_stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        kernels = sum(c for c, _ in device_kernels(prof).values())
        rec.update(minibatches=n_mb, device_kernels=kernels,
                   kernels_per_minibatch=kernels / n_mb, profiled_update_s=wall)
        return out

    trainer._update = update


def flatten_train(dev):
    """``flatten_optimizer: true`` at the flagship's full width, on the
    launcher's config otherwise: three epochs through ``train_epochs`` (K2
    2 x 32 an epoch, finite metrics, the loss falls), the first update under
    torch.profiler (device kernels per minibatch). The flag selects the
    per-tensor step, which tests/test_torch_flatten.py holds to
    ``optax.flatten``. Returns K2's launches in the three epochs."""
    t0 = time.perf_counter()
    env, trainer = trainer_for(["train.params.config.flatten_optimizer=true"])
    if not trainer.cfg.flatten_optimizer:
        raise SystemExit("flatten_train: the launcher's flag did not reach the trainer")
    rec = {}
    profiled_first_update(trainer, rec)
    k2 = env.sim.fused_substep
    _, _, _, rows = train_epochs("flatten_train", env, trainer, {"k2": k2},
                                 {"k2": 2 * trainer.cfg.horizon_length}, 3)
    emit({"phase": "flatten_train/update", "update": rec,
          "seconds": time.perf_counter() - t0})
    return sum(r["k2_launches"] for r in rows)


def camera_compare(got, want, r_min):
    """The card's images against the CPU's render of the same states
    (CAMERA_*'s gates; ``r_min`` the smallest curved geom's radius).
    Returns the deviations and ``ok``."""
    import torch
    d, wd = got["depth"].double(), want["depth"].double()
    hit, whit = torch.isfinite(d), torch.isfinite(wd)
    same = got["seg"] == want["seg"]
    both = hit & whit
    spacing = torch.abs(torch.nextafter(want["depth"], torch.tensor(torch.inf)) - want["depth"])
    excess = ((d - wd).abs() - CAMERA_DEPTH_TOL - 2 * spacing.double())[both]
    body = same & (want["seg"] >= 0)
    turn = torch.where(body, 0.65 * (d - wd).abs() / r_min, torch.zeros_like(d))
    rgb_err = (got["rgb"].double() - want["rgb"].double()).abs().amax(-1)
    res = {"hit_share": float(hit.float().mean()),
           "misses_agree": bool(torch.equal(hit, whit)),
           "sky_is_seg_minus_1": bool(torch.equal(got["seg"] == -1, ~hit)),
           "depth_max_abs_err": float((d - wd).abs()[both].max()),
           "depth_excess": float(excess.max()),
           "seg_agree": float(same.float().mean()),
           "seg_unequal_depth_max": float((d - wd).abs()[~same].max()) if bool((~same).any())
           else 0.0,
           "rgb_max_abs_err": float(rgb_err[same].max()),
           "rgb_normal_turn_max": float(turn.max()),
           "rgb_excess": float((rgb_err - turn)[same].max())}
    res["ok"] = (res["misses_agree"] and res["sky_is_seg_minus_1"] and res["depth_excess"] <= 0
                 and res["seg_agree"] >= CAMERA_SEG_AGREE
                 and res["seg_unequal_depth_max"] <= CAMERA_DEPTH_TOL
                 and res["rgb_excess"] <= CAMERA_RGB_TOL)
    return res


def planted_faults(cam, rad, rel):
    """Copies of ``cam`` with small shading faults planted: the light turned
    by ``rad`` about x, y and z; the first actor's colour and the ground's
    scaled by 1 + ``rel``."""
    import copy
    import math
    import torch
    faults = {}
    c, s = math.cos(rad), math.sin(rad)
    for axis in range(3):
        rot = torch.eye(3, dtype=torch.float64)
        i, j = [k for k in range(3) if k != axis]
        rot[i, i], rot[i, j], rot[j, i], rot[j, j] = c, -s, s, c
        bad = copy.copy(cam)
        bad._light = (rot.to(cam._light.device) @ cam._light.double()).float()
        faults[f"light_turned_{'xyz'[axis]}"] = bad
    for name, rows in (("actor0_colour", cam._seg_ids == 0), ("ground_colour", cam._seg_ids == -2)):
        bad = copy.copy(cam)
        bad._colors = cam._colors.clone()
        bad._colors[rows] *= 1 + rel
        faults[name] = bad
    return faults


def camera_checks(dev):
    """The ray-cast camera on the card: a ball at a known distance against
    the closed form; the flagship with enableCameraSensors at 4096 envs and
    96 x 72 after 8 K2 steps (16 envs against the CPU render of the same
    states; ms, device kernels and peak memory per render); the tensor API's
    image types. Returns K2's launches in the 8 steps."""
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from torch.profiler import ProfilerActivity, profile
    from isaacgym_tpu_torch.models.assets import ASSET_DIR
    from isaacgym_tpu_torch.models import urdf as U
    from isaacgym_tpu_torch.models.kinematics import load_asset
    from isaacgym_tpu_torch.sensors import Camera
    from isaacgym_tpu_torch.sim import scene as S
    from isaacgym_tpu_torch.sim import tensor_api
    from isaacgym_tpu_torch.sim.simulator import Simulator

    # closed form: a 0.02 m ball 0.25 m in front of the camera
    t0 = time.perf_counter()
    ball = load_asset(os.path.join(ASSET_DIR, "small_ball.urdf"))
    scene = S.compile_scene(S.SceneSpec(
        actors=[S.ActorSpec("ball", ball, pos=(0.0, 0.0, 1.0), fixed_base=False)],
        plane=S.PlaneParams(), dt=1 / 120, substeps=2))
    sim = Simulator(scene, device=dev)
    cam = Camera(scene, pos=(0.25, 0.0, 1.0), target=(0.0, 0.0, 1.0), width=65, height=65,
                 fov_deg=60, device=dev)
    out = cam.render(sim, sim.initial_state(4))
    rays = cam.rays.double().cpu().numpy()
    oc = np.array([0.25, 0.0, 0.0])                    # origin minus the ball's centre
    b = rays @ oc
    disc = b * b - (oc @ oc - 0.02 ** 2)
    t_ball = np.where(disc >= 0, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf).reshape(65, 65)
    d = out["depth"].cpu().double().numpy()
    seg = out["seg"].cpu().numpy()
    on_ball = np.isfinite(t_ball)
    res = {"center_depth": float(d[0, 32, 32]), "closed_form": 0.25 - 0.02,
           "ball_pixels": int(on_ball.sum()),
           "ball_depth_max_abs_err": float(np.abs(d[:, on_ball] - t_ball[on_ball]).max()),
           "ball_seg_ok": bool((seg[:, on_ball] == 0).all()),
           "sky_ok": bool(seg[0, 0, 0] == -1 and not np.isfinite(d[0, 0, 0])),
           "ground_ok": bool(seg[0, -1, 32] == -2 and d[0, -1, 32] > 1.0),
           "envs_equal": bool((out["depth"] == out["depth"][:1]).all())}
    res["ok"] = (res["ball_depth_max_abs_err"] <= 1e-4 and res["ball_seg_ok"] and res["sky_ok"]
                 and res["ground_ok"] and res["envs_equal"] and res["ball_pixels"] >= 50
                 and abs(res["center_depth"] - res["closed_form"]) <= 1e-4)
    emit({"phase": "camera/closed_form", **res, "seconds": time.perf_counter() - t0})
    if not res["ok"]:
        raise SystemExit(f"camera/closed_form: {res}")

    # the flagship with its camera at 4096 envs
    t0 = time.perf_counter()
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B, enableCameraSensors=True)
    cam = env.cameras[0]
    k2 = env.sim.fused_substep
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state, obs = env.reset()
    torch.cuda.synchronize()
    k2.launches = 0
    for _ in range(8):
        state, obs, *_ = env.step(state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
    torch.cuda.synchronize()
    launches = k2.launches
    rb = env.sim.rigid_body_states(state.sim)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    out = env.render_camera(state)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    ms = cuda_ms(lambda: env.render_camera(state), 1, 7)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        env.render_camera(state)
        torch.cuda.synchronize()
    per_name = device_kernels(prof)
    n_kernels = sum(c for c, _ in per_name.values())
    busy_ms = sum(t for _, t in per_name.values()) / 1e3
    envs = torch.linspace(0, B - 1, 16).long()
    rb16 = rb[envs]
    want = Camera(env.scene, device="cpu").render_bodies(rb16.cpu())
    curved = cam.table.kind != U.GEOM_BOX
    r_min = float(cam.table.size[curved, 0].min())
    res = camera_compare({k: v[envs].cpu() for k, v in out.items()}, want, r_min)
    faults = {name: camera_compare({k: v.cpu() for k, v in bad.render_bodies(rb16).items()},
                                   want, r_min)
              for name, bad in planted_faults(cam, CAMERA_FAULT_RAD, CAMERA_FAULT_REL).items()}
    res["planted_faults"] = {"light_turned_rad": CAMERA_FAULT_RAD,
                             "colour_scaled_by": 1 + CAMERA_FAULT_REL,
                             **{n: {"rgb_excess": f["rgb_excess"], "rejected": not f["ok"]}
                                for n, f in faults.items()}}
    seen = sorted(set(out["seg"][envs].unique().tolist()))
    shapes = {k: list(v.shape) for k, v in out.items()}
    ok = (res["ok"] and not any(f["ok"] for f in faults.values()) and launches == 16
          and shapes == {
        "depth": [B, 72, 96], "rgb": [B, 72, 96, 3], "seg": [B, 72, 96]}
        and out["seg"].dtype == torch.int32 and {-2, 0, 1} <= set(seen))
    emit({"phase": "camera/flagship", "num_envs": B, "width": cam.width, "height": cam.height,
          "geoms": len(cam.table.kind), "k2_launches": launches, "ms_per_render": ms,
          "device_kernels_per_render": n_kernels, "device_busy_ms_per_render": busy_ms,
          "peak_mem_gb_per_render": peak_gb, "rays_per_s": B * cam.width * cam.height / ms * 1e3,
          "vs_cpu_16_envs": res, "seg_ids_seen": seen, "shapes": shapes, "ok": ok,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise SystemExit(f"camera/flagship: {res} launches {launches} shapes {shapes}")

    t0 = time.perf_counter()
    res = {}
    for kind, key in (("depth", "depth"), ("color", "rgb"), ("segmentation", "seg")):
        img = tensor_api.acquire_camera_image_tensor(cam, env.sim, state.sim, kind)
        res[kind] = {"shape": list(img.shape), "dtype": str(img.dtype),
                     "device": img.device.type, "equal_render": bool(torch.equal(img, out[key]))}
    ok = all(r["equal_render"] and r["device"] == dev.type for r in res.values())
    emit({"phase": "tensor_api/camera", **res, "ok": ok, "seconds": time.perf_counter() - t0})
    if not ok:
        raise SystemExit(f"tensor_api/camera: {res}")
    return launches


def amp_train(dev, epochs=3, clip_steps=240):
    """AMP on the flagship at 4096 envs: a fresh policy's 240-step rollout
    saved with save_motion_clip and loaded by MotionLib on the card, then
    three AMPTrainer epochs (amp_demo's config): K2 launches per epoch (the
    discriminator's 4-step rollout and the PPO epoch's 32, 2 a step), finite
    discriminator metrics, the demos' mean logit above the agents' on fresh
    batches after the last update (a smoke check: the CPU tests hold the
    update to optax's); seconds per epoch split into the discriminator and
    PPO.
    Returns K2's launches in the epochs."""
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.amp_demo import amp_features, dof_obs_offset, record_clip
    from isaacgym_tpu_torch.rl import amp as A
    from isaacgym_tpu_torch.rl.motion_lib import MotionLib
    from isaacgym_tpu_torch.rl.ppo import PPOConfig
    t0 = time.perf_counter()
    env, expert = trainer_for()
    ets = expert.init_state()
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.npz")
        fps = record_clip(env, lambda o: expert._policy(ets.params, ets.obs_stats, o)[0],
                          clip_steps, clip)
        lib = MotionLib(clip, num_dofs=env.num_actions, device=dev)
    del expert, ets
    nd = env.num_actions
    amp_obs_fn, demo_sampler = amp_features(lib, dof_obs_offset(env), nd, fps)
    cfg = PPOConfig(units=(512, 256), horizon_length=32, minibatch_size=4096, mini_epochs=5,
                    learning_rate=1e-4)
    trainer = A.AMPTrainer(env, cfg, amp_obs_dim=4 * nd, demo_sampler=demo_sampler,
                           amp_obs_fn=amp_obs_fn, seed=1)
    ppo_state, amp_state = trainer.init_state()
    env_state, obs = trainer.reset(amp_state)
    k2 = env.sim.fused_substep
    ppo_s = []
    real_ppo = trainer.ppo.train_epoch

    def timed_ppo(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_ppo(*a)
        torch.cuda.synchronize()
        ppo_s.append(time.perf_counter() - t)
        return out

    trainer.ppo.train_epoch = timed_ppo
    rows = []
    want = 2 * (trainer.disc_rollout_steps + cfg.horizon_length)
    for it in range(epochs):
        torch.cuda.synchronize()
        k2.launches = 0
        te = time.perf_counter()
        ppo_state, amp_state, env_state, obs, metrics = trainer.train_epoch(
            ppo_state, amp_state, env_state, obs)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - te
        m = {k_: float(v) for k_, v in metrics.items()}
        row = {"epoch": it, "epoch_s": epoch_s, "disc_s": epoch_s - ppo_s[-1],
               "ppo_s": ppo_s[-1], "k2_launches": k2.launches,
               **{k_: m[k_] for k_ in ("disc_loss", "disc_agent_logit", "disc_demo_logit",
                                       "disc_grad_penalty", "reward_mean", "a_loss", "kl")}}
        emit({"phase": "amp_train/epoch", **row})
        if k2.launches != want or not all(math.isfinite(v) for v in m.values()):
            raise SystemExit(f"amp_train: epoch {it}: {row}, want {want} K2 launches")
        rows.append(row)
    # the discriminator after its last update, on a fresh agent batch (the
    # policy's next disc_rollout_steps) and a fresh demo batch
    _, _, agent_obs = trainer._collect_amp_obs(ppo_state, env_state[0], obs)
    demo_obs = demo_sampler(torch.Generator(device=dev).manual_seed(7), agent_obs.shape[0])
    with torch.no_grad():
        agent_logit = float(amp_state.disc(agent_obs).mean())
        demo_logit = float(amp_state.disc(demo_obs).mean())
    ok = demo_logit > agent_logit
    emit({"phase": "amp_train", "num_envs": B, "epochs": epochs, "clip_frames": clip_steps,
          "clip_fps": fps, "amp_obs_dim": 4 * nd,
          "launches": {"k2": sum(r["k2_launches"] for r in rows)},
          "k2_launches_per_epoch": want,
          **{f: [r[f] for r in rows] for f in ("epoch_s", "disc_s", "ppo_s")},
          "fresh_batch": {"rows": agent_obs.shape[0], "disc_agent_logit": agent_logit,
                          "disc_demo_logit": demo_logit},
          "demo_above_agent": ok, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise SystemExit(f"amp_train: on fresh batches the demo logit {demo_logit} is not "
                         f"above the agents' {agent_logit}")
    return sum(r["k2_launches"] for r in rows)


def viewer_check(dev, steps=60, envs=4):
    """record_env_rollout on the card (4096 envs, the first ``envs``
    recorded): the npz's keys, shapes and dtypes are the JAX recorder's
    format, its body states finite. Rendering frames is a host step (cv2),
    checked on the CPU."""
    import numpy as np
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.viewer.trajectory import record_env_rollout
    t0 = time.perf_counter()
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B)
    nb, ng = env.scene.num_bodies, (len(env.scene.static_geoms) + len(env.scene.art_geoms)
                                     + len(env.scene.free_bodies))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traj.npz")
        tw = time.perf_counter()
        record_env_rollout(env, steps=steps, envs=envs, out_path=path)
        record_s = time.perf_counter() - tw
        data = dict(np.load(path))
    fmt = {k: (list(v.shape), v.dtype.kind + str(v.dtype.itemsize)) for k, v in data.items()}
    want = {"body_states": ([steps, envs, nb, 13], "f4"), "body_names": ([nb], None),
            "geoms": ([ng, 12], "f4"), "extra_ball": ([steps, envs, 13], "f4")}
    ok = (set(fmt) == set(want) and data["body_names"].dtype.kind == "U"
          and all(fmt[k][0] == s and (d is None or fmt[k][1] == d) for k, (s, d) in want.items())
          and bool(np.isfinite(data["body_states"]).all())
          and list(data["body_names"]) == list(env.scene.body_names))
    emit({"phase": "viewer", "num_envs": B, "steps": steps, "recorded_envs": envs,
          "format": fmt, "record_s": record_s, "ok": ok, "seconds": time.perf_counter() - t0})
    if not ok:
        raise SystemExit(f"viewer: {fmt}")


def model_differences(a, b, atol=1e-12):
    """The fields where two ``UrdfModel``s differ (names exactly, numbers to
    ``atol``): empty when equal."""
    import numpy as np
    bad = []
    if (a.name, a.root, a.link_names) != (b.name, b.root, b.link_names):
        bad.append("names")
    if [j.name for j in a.joints] != [j.name for j in b.joints]:
        return bad + ["joints"]
    for ja, jb in zip(a.joints, b.joints):
        if (ja.kind, ja.parent, ja.child) != (jb.kind, jb.parent, jb.child):
            bad.append(f"joint {ja.name}")
        for f in ("xyz", "rpy", "axis", "lower", "upper", "effort", "velocity", "damping",
                  "friction", "armature"):
            if not np.allclose(getattr(ja, f), getattr(jb, f), rtol=0, atol=atol):
                bad.append(f"joint {ja.name}.{f}")
    for name in a.link_names:
        la, lb = a.links[name], b.links[name]
        for f in ("mass", "com", "inertia"):
            if not np.allclose(getattr(la, f), getattr(lb, f), rtol=0, atol=atol):
                bad.append(f"link {name}.{f}")
        if len(la.geoms) != len(lb.geoms):
            bad.append(f"link {name}.geoms")
            continue
        for ga, gb in zip(la.geoms, lb.geoms):
            if ga.kind != gb.kind or not all(
                    np.allclose(getattr(ga, f), getattr(gb, f), rtol=0, atol=atol)
                    for f in ("size", "xyz", "rpy")):
                bad.append(f"link {name}.geom")
    return bad


def native_assets():
    """assets/native: build the native parsers (g++), then parse every URDF
    of ``models/assets`` and the MJCF arm fixture natively and with the
    Python parsers; the two models must be equal field for field (1e-12).
    Every scene after this phase compiles from the native parse."""
    from isaacgym_tpu_torch import native
    from isaacgym_tpu_torch.models import mjcf, urdf as U
    from isaacgym_tpu_torch.models.assets import ASSET_DIR
    from isaacgym_tpu_torch.ops import _build
    from isaacgym_tpu_torch.sim import scripted
    t0 = time.perf_counter()
    native.library_path()
    build_s = time.perf_counter() - t0
    rows = {}
    for f in sorted(os.listdir(ASSET_DIR)):
        if f.endswith(".urdf"):
            path = os.path.join(ASSET_DIR, f)
            rows[f] = model_differences(native.parse_urdf_native(path), U.parse_urdf(path))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "arm.xml")
        with open(path, "w") as fh:
            fh.write(scripted.ARM_MJCF)
        rows["arm.xml"] = model_differences(native.parse_mjcf_native(path),
                                            mjcf.parse_mjcf(path))
    emit({"phase": "assets/native", "build_s": build_s,
          "compile_seconds": _build.build_seconds.get("libig_assets.so"),
          "files": sorted(rows), "differences": {k: v for k, v in rows.items() if v},
          "seconds": time.perf_counter() - t0})
    if len(rows) < 7 or any(rows.values()):
        raise SystemExit(f"assets/native: {rows}")


def _state_tensors(ts):
    return ([p.detach() for p in ts.params.parameters()] + list(ts.opt_state.mu)
            + list(ts.opt_state.nu) + list(ts.obs_stats) + list(ts.value_stats))


def pbt_flagship(dev, root):
    """pbt/flagship: population 2, two rounds of two epochs at B envs with
    the launcher's nets, through K2 (2 x 32 launches an epoch a member).
    Checks: one member exploited each round; a clone of the best member
    keeps its bits while the donor trains another epoch; ``ckpt_best.pt``
    restores the best member's parameters. Returns K2's launches."""
    import torch
    from isaacgym_tpu_torch import pbt
    from isaacgym_tpu_torch.rl import checkpoint
    t0 = time.perf_counter()
    members, history, trainer = pbt.main(
        [f"task={TASK}", "population=2", "rounds=2", "epochs_per_round=2", f"num_envs={B}",
         "experiment=pbt_flagship", "seed=0"], run_root=root)
    torch.cuda.synchronize()
    pbt_s = time.perf_counter() - t0
    env = trainer.env
    launches = env.sim.kernel_launches()
    want = {"fused_substep": 2 * 2 * 2 * 2 * trainer.cfg.horizon_length, "fused_substep_dr": 0}
    best = max(members, key=lambda m: m["objective"])
    back = checkpoint.restore(os.path.join(root, "pbt_flagship", "ckpt_best.pt"),
                              trainer.init_state())
    restored = all(torch.equal(a, b) for a, b in zip(back.params.parameters(),
                                                      best["ts"].params.parameters()))
    clone = pbt.clone_train_state(best["ts"], torch.Generator(device=dev), best["lr"])
    shared = ({t.data_ptr() for t in _state_tensors(clone)}
              & {t.data_ptr() for t in _state_tensors(best["ts"])})
    kept = [t.clone() for t in _state_tensors(clone)]
    donor, *_ = trainer.train_epoch(best["ts"], best["env_state"], best["obs"])
    torch.cuda.synchronize()
    clone_kept = all(torch.equal(a, b) for a, b in zip(_state_tensors(clone), kept))
    donor_moved = not all(torch.equal(a, b) for a, b in zip(_state_tensors(donor), kept))
    row = {"population": 2, "rounds": 2, "epochs_per_round": 2, "num_envs": B,
           "history": history, "k2_launches": launches["fused_substep"],
           "k2dr_launches": launches["fused_substep_dr"], "want": want,
           "s_per_member_epoch": pbt_s / 8, "best_restored": restored,
           "clone_shares_tensors": len(shared), "clone_kept_bits": clone_kept,
           "donor_moved": donor_moved}
    emit({"phase": "pbt/flagship", **row, "seconds": time.perf_counter() - t0})
    if (launches != want or [len(r["exploited"]) for r in history] != [1, 1] or not restored
            or shared or not clone_kept or not donor_moved):
        raise SystemExit(f"pbt/flagship: {row}")
    return launches["fused_substep"]


def ddp_flagship(repo, root, one_process_epoch_s, extra=()):
    """ddp/flagship: the data-parallel epoch in two processes on the one
    card over gloo, 2 x B/2 envs, one epoch with DR through K2-dr (formerly
    two). Checks:
    both ranks end with bit-equal parameters; only rank 0 writes the
    metrics, config and checkpoint; each rank launches K2-dr 2 x 32 times
    an epoch and K2 none. Prints each rank's seconds per epoch beside the
    one-process B-env epoch with DR (``train``). Returns both ranks' K2-dr
    launches."""
    import socket
    import numpy as np
    t0 = time.perf_counter()
    out = os.path.join(root, "ddp")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=repo)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "isaacgym_tpu_torch.parallel.data_parallel", f"task={TASK}",
             f"num_envs={B}", "task.randomize=true", "epochs=1", "backend=gloo",
             "seed=0", f"out={out}", *extra], cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise SystemExit("ddp/flagship: a rank failed:\n" + "\n".join(l[-3000:] for l in logs))
    results = [json.load(open(os.path.join(out, f"result_rank{r}.json"))) for r in range(2)]
    p0, p1 = (np.load(os.path.join(out, f"params_rank{r}.npy")) for r in range(2))
    files = sorted(os.listdir(out))
    want_files = ["ckpt_final.pt", "config.json", "metrics.jsonl", "params_rank0.npy",
                  "params_rank1.npy", "result_rank0.json", "result_rank1.json"]
    per_epoch = [r["kernel_launches_per_epoch"] for r in results]
    want = {"fused_substep": 0, "fused_substep_dr": 64}
    row = {"ranks": 2, "envs_per_rank": B // 2, "backend": "gloo",
           "params_bit_equal": bool(np.array_equal(p0, p1)), "files": files,
           "launches_per_epoch": per_epoch,
           "rank_s_per_epoch": [r["seconds_per_epoch"] for r in results],
           "one_process_s_per_epoch": one_process_epoch_s,
           "finite": all(math.isfinite(r["a_loss"]) for r in results)}
    emit({"phase": "ddp/flagship", **row, "seconds": time.perf_counter() - t0})
    if (not row["params_bit_equal"] or files != want_files or not row["finite"]
            or any(e != want for r in per_epoch for e in r)):
        raise SystemExit(f"ddp/flagship: {row}")
    return sum(e["fused_substep_dr"] for r in per_epoch for e in r)


def tool_checks():
    """profile_ppo/flagship and probe_ball/flagship: each tool at B envs,
    its JSON line printed under the phase, with K2's launches counted by
    the tool's own env. Returns K2's launches of each."""
    from isaacgym_tpu_torch import probe_ball, profile_ppo
    import isaacgym_tpu_torch
    t0 = time.perf_counter()
    rep = profile_ppo.profile(TASK, B, device="cuda", repeats=2)
    emit({"phase": "profile_ppo/flagship", **rep, "seconds": time.perf_counter() - t0})
    # warm-up and two each of rollouts, updates and epochs: 5 rollouts of 32 steps
    if (rep["kernel_launches"]["fused_substep"] != 5 * 2 * rep["horizon"]
            or not rep["mfu_update_analytic"] > 0
            or rep["flops_counter_fwd_per_sample"] != rep["net_fwd_flops_per_sample"]):
        raise SystemExit(f"profile_ppo/flagship: {rep}")
    t0 = time.perf_counter()
    env = isaacgym_tpu_torch.make(seed=1, task=TASK, num_envs=B)
    state, _ = env.reset()
    out = probe_ball.probe(env, state, 170, TASK)
    emit({"phase": "probe_ball/flagship", **out, "seconds": time.perf_counter() - t0})
    if out["kernel_launches"]["fused_substep"] != 2 * 170 or not out["cross_rate"] > 0.5:
        raise SystemExit(f"probe_ball/flagship: {out}")
    return rep["kernel_launches"]["fused_substep"], out["kernel_launches"]["fused_substep"]


def parity_dr_checks(dev, repo):
    """The parity tool's DR rows (the env step under domain randomization,
    every JAX draw replayed) for the flagship (K2-dr, 2 launches a step), C8
    and C10 (the non-kernel step, no launch): ``parity_dr/<scene>`` at the
    gates' widths from ``build/parity/<scene>_dr.npz`` where
    ``tools/torch_parity_export.py --dr`` wrote them (on a machine with JAX),
    else ``parity_dr_fixture/<scene>`` on the committed 64-env fixture
    (``parity/data/``, cut from those files). Then parity_dr_gates: each
    scene's fixture with the DR parameters at the identity and with the
    redraw dropped, and the flagship's with the noise dropped, must fail
    (the CPU tests run every scene with all three). Returns K2-dr's
    launches."""
    from isaacgym_tpu_torch.parity import env_step as E
    data = os.path.join(os.path.dirname(E.__file__), "data")
    full = os.path.join(repo, "build", "parity")
    k2dr = 0
    for name, per_step in (("flagship", {"fused_substep": 0, "fused_substep_dr": 2}),
                           ("c8", {"fused_substep_multi": 0}),
                           ("c10", {"fused_substep_floating": 0})):
        fname = f"{name}_dr.npz"
        at_width = os.path.exists(os.path.join(full, fname))
        path = os.path.join(full if at_width else data, fname)
        phase = f"parity_dr/{name}" if at_width else f"parity_dr_fixture/{name}"
        res = E.check(path, "cuda")
        res["file"] = os.path.relpath(path, repo)
        emit({"phase": phase, **res})
        want = {k: n * res["samples"] for k, n in per_step.items()}
        if res["gate"] != "PASS" or res["launches_by_kernel"] != want:
            raise SystemExit(f"{phase}: {res['gate_failures']}, "
                             f"{res['launches_by_kernel']} launches for {want}")
        k2dr += res["launches_by_kernel"].get("fused_substep_dr", 0)
    t0 = time.perf_counter()
    forms = [("flagship", "identity_dr"), ("flagship", "no_noise"), ("flagship", "no_redraw"),
             ("c8", "identity_dr"), ("c8", "no_redraw"), ("c10", "identity_dr"),
             ("c10", "no_redraw")]
    rejected = {f"{name}/{form}": E.check(os.path.join(data, f"{name}_dr.npz"), "cuda",
                                          mutate_inputs=E.DR_WRONG_INPUTS[form])["gate_failures"]
                for name, form in forms}
    emit({"phase": "parity_dr_gates", "rejected": rejected,
          "seconds": time.perf_counter() - t0})
    if not all(rejected.values()):
        raise SystemExit(f"parity_dr_gates: a wrong input passed the gates: {rejected}")
    return k2dr


# each switch of sim/switches.py on the scenes whose kernel it reaches
SWITCH_SCENES = {"flagship": ("kappa", "art_static", "ccd", "pallas", "torque", "reach_prune",
                              "native"),
                 "c8": ("kappa", "art_static", "pallas", "torque", "reach_prune"),
                 "c10": ("kappa", "art_static", "pallas", "torque")}


def switch_states(label, env, b):
    """A scene's contact states for the switch checks: the flagship (raised
    table) half paddle strikes, half the paddle in the table; C8 paddle
    strikes of humanoid 1; C10 (raised table) half strikes, half standing on
    the table. Returns ``(state, targets, efforts)`` on the env's device."""
    import numpy as np
    import torch
    from isaacgym_tpu_torch.sim import scripted
    rng = np.random.RandomState(23)
    if label == "c8":
        state, tgt = scripted.strike_state(env.sim, "paddle_ball1", b, rng, env.cfg)
        return state, tgt, torch.zeros_like(tgt)
    inputs = scripted.k2_inputs if label == "flagship" else scripted.k4_inputs
    kinds = ("paddle_ball", "paddle_table") if label == "flagship" else ("strike", "table")
    halves = [inputs(env, kind, b // 2, rng) for kind in kinds]
    ins = [np.concatenate(x) for x in zip(*halves)]
    return (scripted.k2_state if label == "flagship" else scripted.k4_state)(env.sim, ins)


def switch_checks(dev, b=1024):
    """switches/<scene>_<switch>: each physics switch (``PhysicsSwitches``)
    on the flagship (K2), C8 (K3) and C10 (K4, 512 envs) where it reaches
    them: ``make(..., switches=)`` on the card, one ``Simulator.step`` from
    the scene's contact states (``switch_states``) against the CPU's step of
    the same scene under the same switch (the plain versions or the
    non-kernel step) within the non-kernel gate, flip-aware. Launches: the
    route's kernel twice (its ``-tau`` build under ``torque``), none and no
    kernel held under ``pallas=False``. ``ccd=False`` and ``native=False``
    step the default's bits on the kernel route (the kernels sweep whatever
    the CCD switch says, as the JAX kernels do); ``kappa=0`` moves the balls'
    spin, ``art_static=False`` the paddle in the table (C10: the body on it),
    ``torque=True`` writes non-zero moments. Returns each scene's launches of
    each kernel, summed over its switches."""
    import copy
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_floating as FL
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.sim.simulator import Simulator
    from isaacgym_tpu_torch.sim.switches import PhysicsSwitches as PS
    from isaacgym_tpu_torch.utils.config import load_task_config

    switch_of = {"kappa": PS(kappa=0.0), "art_static": PS(art_static=False),
                 "ccd": PS(ccd=False), "pallas": PS(pallas=False), "torque": PS(torque=True),
                 "reach_prune": PS(reach_prune=False), "native": PS(native=False)}
    tasks = {"flagship": (TASK, b, NONKERNEL_GATE), "c8": (C8, b, NONKERNEL_GATE),
             "c10": (C10, b // 2, NONKERNEL_GATE_C10)}
    totals = {}
    for label, switches in SWITCH_SCENES.items():
        task, n, gate = tasks[label]
        cfg = copy.deepcopy(load_task_config(task))
        if label != "c8":
            cfg = scripted.raised_table_cfg(cfg)
        base = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=n, cfg=cfg,
                                       switches=PS())
        state, tgt, eff = switch_states(label, base, n)
        route_k = ROUTE_KERNELS[base.sim.route]
        default_step = base.sim.step(state, tgt, eff)
        for name in switches:
            t0 = time.perf_counter()
            sw = switch_of[name]
            env = isaacgym_tpu_torch.make(seed=0, task=task, num_envs=n,
                                          cfg=copy.deepcopy(cfg), switches=sw)
            sim = env.sim
            for k in filter(None, [getattr(sim, a) for a in ROUTE_KERNELS.values()]):
                k.launches = 0
            got = sim.step(state, tgt, eff)
            torch.cuda.synchronize()
            launches = sim.kernel_launches()
            cpu = Simulator(env.scene, device="cpu", switches=sw)
            want = cpu.step(type(state)(*[t.cpu() for t in state]), tgt.cpu(), eff.cpu())
            res = nonkernel_compare(got, want, gate)
            moved = {f: float((getattr(got, f) - getattr(default_step, f)).abs().max())
                     for f in ("root", "dof_vel", "net_contact_torque")}
            spin = float((got.root[:, env.ball_actor, 10:13]
                          - default_step.root[:, env.ball_actor, 10:13]).abs().max())
            expect = ({} if name == "pallas" else
                      {k: 2 if k == route_k else 0 for k in {route_k, *launches}})
            kernel = getattr(sim, route_k)
            pairs = None if kernel is None else int(sim.constants[
                FL.C_ART_STATIC if route_k == "fused_substep_floating" else F.C_NPAIR])
            ok = res["within_gate"] and launches == expect and (
                (name != "pallas" or (sim.route == "nonkernel" and kernel is None))
                and (name != "torque" or (kernel.with_torque
                                          and moved["net_contact_torque"] > 1e-3))
                and (name not in ("ccd", "native")
                     or all(torch.equal(getattr(got, f), getattr(default_step, f))
                            for f in got._fields))
                and (name != "kappa" or spin > 1.0)
                and (name != "art_static" or (pairs == 0 and (
                    label == "c8" or moved["dof_vel"] > 0.5 or moved["root"] > 0.05))))
            row = {"num_envs": n, "switches": sw.report(), "route": sim.route,
                   "route_on_cpu": cpu.route, "launches": launches, "want_launches": expect,
                   "with_torque": None if kernel is None else kernel.with_torque,
                   "art_static_pairs_or_flag": pairs, "vs_cpu": res,
                   "vs_default_step": moved, "ball_spin_moved": spin,
                   "seconds": time.perf_counter() - t0}
            emit({"phase": f"switches/{label}_{name}", **row})
            if not ok:
                raise SystemExit(f"switches/{label}_{name}: {row}")
            for k, v in launches.items():
                key = f"{k}_tau" if name == "torque" else k
                totals[(label, key)] = totals.get((label, key), 0) + v
            if label == "flagship" and name == "torque":
                totals[(label, "fused_substep_dr_tau")] = torque_dr_step(
                    env, cpu, state, tgt, eff, gate)
    return totals


def torque_dr_step(env, cpu, state, tgt, eff, gate):
    """switches/flagship_torque_dr: under ``torque=True`` the DR step of the
    flagship runs K2-dr-tau (twice a step; 0 on the main path, which has no
    sensor), against the CPU's step with the same full-strength draw.
    Returns its launches."""
    import torch
    from isaacgym_tpu_torch.env.randomize import DomainRandomizer
    t0 = time.perf_counter()
    sim, n = env.sim, state.root.shape[0]
    gen = torch.Generator(device=sim.device)
    gen.manual_seed(5)
    dr = DomainRandomizer(env.cfg["task"]["randomization_params"],
                          env.scene.num_dofs).sample(gen, 3000, n)
    sim.fused_substep.launches = sim.fused_substep_dr.launches = 0
    got = sim.step(state, tgt, eff, dr)
    torch.cuda.synchronize()
    launches = sim.kernel_launches()
    want = cpu.step(type(state)(*[t.cpu() for t in state]), tgt.cpu(), eff.cpu(),
                    type(dr)(*[t.cpu() for t in dr]))
    res = nonkernel_compare(got, want, gate)
    row = {"num_envs": n, "launches": launches, "with_torque": sim.fused_substep_dr.with_torque,
           "vs_cpu": res, "moments": float(got.net_contact_torque.abs().max()),
           "seconds": time.perf_counter() - t0}
    emit({"phase": "switches/flagship_torque_dr", **row})
    if (not res["within_gate"] or launches != {"fused_substep": 0, "fused_substep_dr": 2}
            or not sim.fused_substep_dr.with_torque or not row["moments"] > 1e-3):
        raise SystemExit(f"switches/flagship_torque_dr: {row}")
    return launches["fused_substep_dr"]


def tp_flagship(repo, root, b=B, extra=()):
    """tp/flagship: the PPO epoch with the trunks sharded over ``mdl``
    (``parallel/tensor_parallel.py``) in two processes on the one card over
    gloo, dp 1 x mdl 2, at the flagship's full width and full trunk
    ([2048, 1536, 1024, 1024, 512, 512]) in float32 (bfloat16 would round
    each rank's partial product before the sum), one epoch without DR.
    Against a one-process epoch of the same config and seed: the first
    minibatch's reduced gradients within TP_GRAD_TOL of the largest entry,
    the clip's global norm and the rollout's metrics within TP_METRIC_RTOL;
    the update's metrics and the gathered parameters after it within
    TP_SPREAD_FACTOR times their spread between that epoch and a second
    one-process epoch with float64 trunks; the
    trunk layers still cut after the update, both ranks' gathered parameters
    equal. Each rank's seconds per epoch beside the one process's. Returns
    both ranks' K2 launches."""
    import socket
    import numpy as np
    import torch
    import isaacgym_tpu_torch
    from isaacgym_tpu_torch.rl.ppo import PPOConfig, PPOTrainer, global_norm
    from isaacgym_tpu_torch.utils.config import compose, preprocess_train_config
    t0 = time.perf_counter()
    out = os.path.join(root, "tp")
    args = [f"task={TASK}", f"num_envs={b}", "seed=0", "epochs=1", "model_parallel=2",
            "backend=gloo", "compute_dtype=float32", *extra]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=repo)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "isaacgym_tpu_torch.parallel.tensor_parallel", *args,
             f"out={out}"], cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise SystemExit("tp/flagship: a rank failed:\n" + "\n".join(l[-3000:] for l in logs))
    results = [json.load(open(os.path.join(out, f"result_rank{r}.json"))) for r in range(2)]
    got = [np.load(os.path.join(out, f"params_rank{r}.npz")) for r in range(2)]
    # the one-process epoch of the same config, and its float64-trunk twin
    cfg = compose(TASK, [a for a in args if a.split("=")[0] in ("num_envs", "seed", "device")])
    preprocess_train_config(cfg)

    def one_process(dtype=torch.float32):
        env1 = isaacgym_tpu_torch.make(seed=0, task=TASK, cfg=cfg["task"])
        trainer = PPOTrainer(env1, PPOConfig.from_train_cfg(cfg["train"]), seed=0,
                             compute_dtype=dtype)
        ts = trainer.init_state()
        names = [n for n, _ in ts.params.named_parameters()]
        first = {}

        def record(grads, aux):
            if not first:
                first.update({n: g.detach().float().cpu().numpy()
                              for n, g in zip(names, grads)})
            return grads, aux
        trainer._reduce_grads = record
        state, obs = env1.reset()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ts, state, obs, m = trainer.train_epoch(ts, state, obs)
        one = {k: float(v) for k, v in m.items()}
        seconds = time.perf_counter() - t1
        params = {n: p.detach().float().cpu().numpy() for n, p in ts.params.named_parameters()}
        del env1, ts, state, obs
        torch.cuda.empty_cache()
        return trainer, first, one, params, seconds
    trainer, first, one, params1, one_s = one_process()
    _, _, twin, params2, _ = one_process(torch.float64)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-6)
    spread = {k: rel(twin[k], one[k]) for k in TP_UPDATE_METRICS}
    param_spread = max(float(np.abs(params2[n] - p).max()) for n, p in params1.items())
    param_err = max(max(float(np.abs(g[f"param.{n}"] - p).max()) for n, p in params1.items())
                    for g in got)
    scale = max(float(np.abs(g).max()) for g in first.values())
    grad_err = max(float(np.abs(got[0][f"grad0.{n}"] - g).max()) for n, g in first.items()) / scale
    norm1 = float(global_norm([torch.as_tensor(g) for g in first.values()]))
    metric_errs = {k: max(abs(r["metrics"][k] - v) / max(abs(v), 1e-6) for r in results)
                   for k, v in one.items()}
    update_rtol = {k: TP_SPREAD_FACTOR * v + TP_METRIC_RTOL for k, v in spread.items()}
    param_atol = TP_SPREAD_FACTOR * param_spread + TP_PARAM_ATOL
    rtol = lambda k: update_rtol.get(k, TP_METRIC_RTOL)
    metrics_ok = all(abs(r["metrics"][k] - v) <= rtol(k) * abs(v) + TP_METRIC_ATOL
                     for r in results for k, v in one.items())
    place = results[0]["placements"]
    cut = all(place[f"{t}.layers.{i}.weight"] == ["shard", i % 2]
              for t in ("actor_mlp", "critic_mlp") for i in range(6))
    shapes = results[0]["local_shapes"]
    equal = all(np.array_equal(got[0][k], got[1][k]) for k in got[0].files)
    row = {"ranks": 2, "dp": 1, "mdl": 2, "num_envs": b, "backend": "gloo",
           "trunk": list(trainer.cfg.units), "compute_dtype": "float32",
           "rank_s_per_epoch": [r["seconds_per_epoch"] for r in results],
           "one_process_s_per_epoch": one_s, "launches_per_epoch":
               [r["kernel_launches_per_epoch"] for r in results],
           "first_grad_max_rel_err": grad_err, "grad_tol": TP_GRAD_TOL,
           "first_grad_norm": [r["first_grad_norm"] for r in results],
           "first_grad_norm_one_process": norm1, "metric_rtol": TP_METRIC_RTOL,
           "metric_atol": TP_METRIC_ATOL, "metric_rel_errs": metric_errs,
           "one_process_metrics": one, "float64_trunk_metrics": twin,
           "float64_trunk_update_spread": spread, "spread_factor": TP_SPREAD_FACTOR,
           "update_metric_rtol": update_rtol, "param_max_abs_err": param_err,
           "float64_trunk_param_spread": param_spread, "param_atol": param_atol,
           "trunk_cut_after_update": cut,
           "rank0_local_shapes": {k: shapes[k] for k in ("actor_mlp.layers.0.weight",
                                                           "actor_mlp.layers.1.weight",
                                                           "mu.weight")},
           "ranks_gather_equal": equal, "card": nvidia_smi(),
           "seconds": time.perf_counter() - t0}
    emit({"phase": "tp/flagship", **row})
    want = {"fused_substep": 2 * trainer.cfg.horizon_length, "fused_substep_dr": 0}
    if (grad_err > TP_GRAD_TOL or not metrics_ok or not cut or not equal
            or not param_err <= param_atol
            or any(abs(n - norm1) > TP_METRIC_RTOL * norm1 for n in row["first_grad_norm"])
            or any(e != want for r in row["launches_per_epoch"] for e in r)):
        raise SystemExit(f"tp/flagship: {row}")
    return sum(e["fused_substep"] for r in row["launches_per_epoch"] for e in r)


def main():
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "isaacgym_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    import numpy as np
    import isaacgym_tpu_torch
    from concurrent.futures import ThreadPoolExecutor
    from isaacgym_tpu_torch.env.randomize import DomainRandomizer
    from isaacgym_tpu_torch.ops import _build
    from isaacgym_tpu_torch.ops import arm_step as A
    from isaacgym_tpu_torch.ops import fused_substep as F
    from isaacgym_tpu_torch.ops import fused_substep_floating as FL
    from isaacgym_tpu_torch.ops import fused_substep_multi as M
    from isaacgym_tpu_torch.sim import scripted
    from isaacgym_tpu_torch.utils.config import load_task_config

    # ---- 0: device
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "name": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    # ---- 1: build (one nvcc per source and g++, all started together)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        f_cuda = pool.submit(_build.build_cuda_libraries)
        f_host = pool.submit(_build.build_host_library)
        libs, host = f_cuda.result(), f_host.result()
    for lib in (libs["fused_substep"], host):
        F.check_library_layout(lib, 7)
    for lib in (libs["fused_substep_multi"], host):
        for nd in (7, 3, 26):
            M.check_library_layout(lib, nd, 2)
    for lib in (libs["fused_substep_floating"], host):
        FL.check_library_layout(lib, 27)
    A.check_library_layout(libs["arm_step"], 7)
    ptxas = [ln.strip() for log in _build.build_logs.values() for ln in log.splitlines()
             if "registers" in ln or "bytes stack frame" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compile_seconds": _build.build_seconds, "ptxas": ptxas})

    # ---- 1b: the native asset parsers (every scene below compiles from them)
    native_assets()

    # ---- 2: K2 and K2-dr against their plain versions, the gates' bite, timings
    sets, rz, k2_line, k2dr_line = k2_checks(dev, host)
    gen = torch.Generator(device=dev)

    # ---- 2c: K3 against its plain version, and its timing; K3 and K3-tau at
    # <26, 2, 2> on C11's sets
    from isaacgym_tpu_torch.sim.scene import DRIVE_EFFORT, DRIVE_POS
    from isaacgym_tpu_torch.sim.simulator import Simulator
    env8 = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=B)
    toy_pd, toy_effort = (scripted.ToyEnv(d, device=dev) for d in (DRIVE_POS, DRIVE_EFFORT))
    k3 = k3_checks(dev, host, [
        ("reset", env8, "reset", 0.0), ("rollout", env8, None, 0.0),
        ("paddle_ball1", env8, "paddle_ball1", 0.0), ("paddle_ball2", env8, "paddle_ball2", 0.0),
        ("ball_rest", env8, "ball_rest", 0.0), ("ball_ball", toy_pd, "ball_ball", 0.0),
        ("effort", toy_effort, "paddle_ball1", 15.0)], seed=200)["k3"]
    # C11's sets under random efforts of up to C11_EFFORT; K3-tau on C11's
    # scene with a sensor on each paddle
    env11 = isaacgym_tpu_torch.make(seed=0, task=C11, num_envs=B)
    k11 = env11.sim.fused_substep_multi
    tau11 = Simulator(c11_sensor_scene(), device=dev).fused_substep_multi
    if (k11.nd, k11.K, k11.nb) != (26, 2, 2) or not tau11.with_torque or tau11.nd != 26:
        raise SystemExit(f"k3/c11: shapes {(k11.nd, k11.K, k11.nb)}, K3-tau {tau11.with_torque}")
    lines = k3_checks(dev, host, [(n, env11, None if n == "rollout" else n, C11_EFFORT) for n in (
        "reset", "rollout", "paddle_ball1", "paddle_ball2", "ball_rest")], seed=400, tag="c11",
        tau=tau11, plain_repeats=3)
    k3c11, k3tauc11 = lines["k3"], lines["k3tau"]
    del env8, toy_pd, toy_effort, env11, k11, tau11, lines

    # ---- 2d: K4 against its plain version on C10, the gates' bite, its timing
    k4, k4_sets = k4_checks(dev, host)

    # ---- 2e: K2-tau, K2-dr-tau, K3-tau and K4-tau against their plain
    # versions, the moment gates' bite, timings
    k2tau, k2drtau, k3tau, k4tau = tau_checks(dev, host, sets, rz, k4_sets)
    del k4_sets

    # ---- 2f: K1 against its plain version on the flagship arm, its timing
    env_t = terrain_env(B)
    k1 = k1_checks(dev, host, env_t)

    # ---- 2g: the parity tool on its committed fixture, every scene, and the
    # gates' bite
    parity_launches = parity_checks(dev)

    # ---- 3: the main path
    t0 = time.perf_counter()
    env = isaacgym_tpu_torch.make(seed=0, task=TASK, num_envs=B)
    k = env.sim.fused_substep
    gen.manual_seed(0)
    state, obs = env.reset()
    for _ in range(5):
        state, obs, rew, done, info = env.step(
            state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
    torch.cuda.synchronize()
    k.launches = 0
    windows, zs = [], []
    steps = 0
    for _ in range(3):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for _ in range(100):
            state, obs, rew, done, info = env.step(
                state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
            zs.append(state.sim.root[:, 2, 2].clone())
            steps += 1
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - tw)
    launches = k.launches
    if launches != 2 * steps:
        raise SystemExit(f"main path: K2 launched {launches} times in {steps} steps")
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    bounced = bounced_envs(zs, dev)
    if not finite or bounced == 0:
        raise SystemExit(f"main path: finite={finite} bounced_envs={bounced}")
    rates = [B * 100 / w for w in windows]
    emit({"phase": "main", "num_envs": B, "steps": steps, "k2_launches": launches,
          "env_steps_per_s": rates, "env_steps_per_s_median": statistics.median(rates),
          "ms_per_step": [w * 10 for w in windows], "bounced_envs": bounced,
          "hit_paddle_flags": int(state.flags["paddle_condition_calculated"].sum()),
          "seconds": time.perf_counter() - t0})

    # ---- where a step's time goes: torch.profiler over 10 more steps
    t0 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        for _ in range(10):
            state, *_ = env.step(state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tw) * 1e6
    kernels = [(name, n, t) for name, (n, t) in device_kernels(prof).items()]
    busy_us = sum(t for _, _, t in kernels)
    top = sorted(kernels, key=lambda r: -r[2])[:6]
    emit({"phase": "profile", "steps": 10, "wall_ms_per_step": wall_us / 1e4,
          "device_busy_ms_per_step": busy_us / 1e4,
          "device_busy_share": busy_us / wall_us,
          "device_kernels_per_step": sum(c for _, c, _ in kernels) / 10,
          "k2_ms_per_step": sum(t for n, _, t in kernels if "fused_substep" in n) / 1e4,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t / 1e3} for n, c, t in top],
          "seconds": time.perf_counter() - t0})

    # ---- 4a: the baked-root guard's cost on the main cell
    guard_cost(dev, env)

    # ---- 4b: the C8 env step through K3
    t0 = time.perf_counter()
    env8 = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=B)
    k3k = env8.sim.fused_substep_multi
    gen.manual_seed(0)
    act8 = lambda: torch.rand((B, 14), generator=gen, device=dev) * 2 - 1
    state, obs = env8.reset()
    for _ in range(5):
        state, obs, rew, done, info = env8.step(state, act8())
    torch.cuda.synchronize()
    k3k.launches = 0
    windows, zs, steps = [], [], 0
    for _ in range(3):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for _ in range(100):
            state, obs, rew, done, info = env8.step(state, act8())
            zs.append(state.sim.root[:, 3, 2].clone())
            steps += 1
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - tw)
    c8_launches = k3k.launches
    c8_k2 = 0 if env8.sim.fused_substep is None else env8.sim.fused_substep.launches
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    bounced = bounced_envs(zs, dev)
    rates = [B * 100 / w for w in windows]
    env2p = isaacgym_tpu_torch.make(seed=0, task=C8, num_envs=B, twoPlayer=True)
    s2, o2 = env2p.reset()
    for _ in range(10):
        s2, o2, r2, d2, _ = env2p.step(s2, act8())
    two_player_ok = (tuple(o2.shape) == (B, 188) and bool(torch.isfinite(o2).all())
                     and bool(torch.isfinite(r2).all()))
    emit({"phase": "c8_main", "num_envs": B, "steps": steps, "k3_launches": c8_launches,
          "k2_launches": c8_k2, "env_steps_per_s": rates,
          "env_steps_per_s_median": statistics.median(rates),
          "ms_per_step": [w * 10 for w in windows], "bounced_envs": bounced,
          "hit_paddle_flags": int(state.flags["condition_calculated"].sum()),
          "two_player_obs": list(o2.shape), "two_player_finite": two_player_ok,
          "seconds": time.perf_counter() - t0})
    if c8_launches != 2 * steps or c8_k2 != 0 or not finite or bounced == 0 or not two_player_ok:
        raise SystemExit(f"c8_main: K3 {c8_launches} and K2 {c8_k2} launches in {steps} steps, "
                         f"finite={finite} bounced_envs={bounced} two_player={two_player_ok}")
    del env2p, s2, o2

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        for _ in range(10):
            state, *_ = env8.step(state, act8())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tw) * 1e6
    kernels = [(name, n, t) for name, (n, t) in device_kernels(prof).items()]
    busy_us = sum(t for _, _, t in kernels)
    k3_us = sum(t for n, _, t in kernels if "fused_substep_multi" in n)
    top = sorted(kernels, key=lambda r: -r[2])[:6]
    emit({"phase": "c8_profile", "steps": 10, "wall_ms_per_step": wall_us / 1e4,
          "device_busy_ms_per_step": busy_us / 1e4, "device_busy_share": busy_us / wall_us,
          "device_kernels_per_step": sum(c for _, c, _ in kernels) / 10,
          "k3_ms_per_step": k3_us / 1e4, "k3_share_of_busy": k3_us / busy_us,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t / 1e3} for n, c, t in top],
          "seconds": time.perf_counter() - t0})
    del env8, state, obs

    # ---- 4b2: the C11 env step through K3 at <26, 2, 2>
    c11_launches = task_main(dev, C11, "c11", "k3", steps=50, profile=True)

    # ---- 4c: the C6 env step through K2
    t0 = time.perf_counter()
    env6 = isaacgym_tpu_torch.make(seed=0, task=C6, num_envs=B)
    state, obs = env6.reset()
    torch.cuda.synchronize()
    env6.sim.fused_substep.launches = 0
    tw = time.perf_counter()
    for _ in range(100):
        state, obs, rew, done, info = env6.step(
            state, torch.rand((B, 7), generator=gen, device=dev) * 2 - 1)
    torch.cuda.synchronize()
    c6_s = time.perf_counter() - tw
    c6_launches = env6.sim.fused_substep.launches
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    emit({"phase": "c6_main", "num_envs": B, "steps": 100, "k2_launches": c6_launches,
          "env_steps_per_s": B * 100 / c6_s, "finite": finite,
          "seconds": time.perf_counter() - t0})
    if c6_launches != 200 or not finite:
        raise SystemExit(f"c6_main: K2 launched {c6_launches} times in 100 steps, "
                         f"finite={finite}")
    del env6, state, obs

    # ---- 4c2: C5 and C9 through K2
    c5_launches = task_main(dev, C5, "c5", "k2")
    c9_launches = task_main(dev, C9, "c9", "k2")

    # ---- 4d: the force-sensor path through K2-tau, K3-tau and K4-tau
    tau_launches, _ = sensor_path(dev)

    # ---- 4e: the C10 env step through K4, at its 2048 envs
    t0 = time.perf_counter()
    env10 = isaacgym_tpu_torch.make(seed=0, task=C10, num_envs=B10)
    k4k = env10.sim.fused_substep_floating
    gen.manual_seed(0)
    act10 = lambda: torch.rand((B10, 27), generator=gen, device=dev) * 2 - 1
    state, obs = env10.reset()
    for _ in range(5):
        state, obs, rew, done, info = env10.step(state, act10())
    torch.cuda.synchronize()
    k4k.launches = 0
    windows, steps, c10_window = [], 0, 50   # formerly 100
    for _ in range(3):
        torch.cuda.synchronize()
        tw = time.perf_counter()
        for _ in range(c10_window):
            state, obs, rew, done, info = env10.step(state, act10())
            steps += 1
        torch.cuda.synchronize()
        windows.append(time.perf_counter() - tw)
    c10_launches = k4k.launches
    finite = all(bool(torch.isfinite(t).all()) for t in state.sim) and bool(
        torch.isfinite(obs).all() and torch.isfinite(rew).all())
    rates = [B10 * c10_window / w for w in windows]
    emit({"phase": "c10_main", "num_envs": B10, "steps": steps, "k4_launches": c10_launches,
          "env_steps_per_s": rates, "env_steps_per_s_median": statistics.median(rates),
          "ms_per_step": [w * 1e3 / c10_window for w in windows], "finite": finite,
          "obs_shape": list(obs.shape),
          "fallen_share": float(state.flags["humanoid_die_calculated"].float().mean()),
          "pelvis_z_mean": float(state.sim.root[:, 0, 2].mean()),
          "seconds": time.perf_counter() - t0})
    if c10_launches != 2 * steps or not finite or tuple(obs.shape) != (B10, 313):
        raise SystemExit(f"c10_main: K4 launched {c10_launches} times in {steps} steps, "
                         f"finite={finite}")

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        for _ in range(10):
            state, *_ = env10.step(state, act10())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tw) * 1e6
    kernels = [(name, n, t) for name, (n, t) in device_kernels(prof).items()]
    busy_us = sum(t for _, _, t in kernels)
    k4_us = sum(t for n, _, t in kernels if "fused_substep_floating" in n)
    top = sorted(kernels, key=lambda r: -r[2])[:6]
    emit({"phase": "c10_profile", "steps": 10, "wall_ms_per_step": wall_us / 1e4,
          "device_busy_ms_per_step": busy_us / 1e4, "device_busy_share": busy_us / wall_us,
          "device_kernels_per_step": sum(c for _, c, _ in kernels) / 10,
          "k4_ms_per_step": k4_us / 1e4, "k4_share_of_busy": k4_us / busy_us,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t / 1e3} for n, c, t in top],
          "seconds": time.perf_counter() - t0})
    del env10, state, obs

    # ---- 4f: the terrain flagship through K1 and the torch contact phase
    k1_launches = terrain_main(dev, env_t)
    del env_t

    # ---- 4g: the baked-root guard on the flagship (K2) and C10 (K4)
    baked_guard(dev)

    # ---- 5: training at full width with DR, through K2-dr
    from isaacgym_tpu_torch.rl import checkpoint
    from isaacgym_tpu_torch.rl.player import play
    from isaacgym_tpu_torch.rl.ppo import PPOTrainer

    env, trainer = trainer_for(["task.randomize=true"])
    pcfg = trainer.cfg
    ts = trainer.init_state()
    state, obs = env.reset()
    # past the 3000-step ramp: every scheduled DR term at full strength
    state = state._replace(global_step=torch.full_like(state.global_step, 3000),
                           dr=env.randomizer.sample(env.generator, 3000, B))
    n_weights = sum(mod.weight.numel() for mod in ts.params.modules()
                    if isinstance(mod, torch.nn.Linear))
    upd_flop = 3 * 2 * n_weights * B * pcfg.horizon_length * pcfg.mini_epochs
    ts, state, obs, epochs = train_epochs(
        "train", env, trainer, {"k2": env.sim.fused_substep, "k2dr": env.sim.fused_substep_dr},
        {"k2": 0, "k2dr": 2 * pcfg.horizon_length}, 7, ts, state, obs, episode_length=169.0,
        extra={"net_weights": n_weights, "update_flop": upd_flop,
               "update_bf16_floor_ms": upd_flop / PEAK_BF16_OPS_PER_S * 1e3})
    train_launches = {n: sum(r[f"{n}_launches"] for r in epochs) for n in ("k2", "k2dr")}
    if not any(r["episode_count"] for r in epochs):
        raise SystemExit("train: no episode finished in 7 epochs")

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tw = time.perf_counter()
        ts, state, obs, metrics = trainer.train_epoch(ts, state, obs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tw) * 1e6
    per_name = device_kernels(prof)
    busy_us = sum(t for _, t in per_name.values())
    top = sorted(per_name.items(), key=lambda r: -r[1][1])[:8]
    emit({"phase": "train_profile", "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / wall_us,
          "device_kernels": sum(c for c, _ in per_name.values()),
          "k2dr_ms": sum(t for n, (_, t) in per_name.items() if "fused_substep" in n) / 1e3,
          "top_kernels": [{"name": n[:70], "launches": c, "ms": t / 1e3}
                          for n, (c, t) in top],
          "seconds": time.perf_counter() - t0})

    # ---- 6: the launcher's default route (randomize false) through K2
    env_n, trainer_n = trainer_for()
    rows = train_epochs("train_nodr", env_n, trainer_n,
                        {"k2": env_n.sim.fused_substep, "k2dr": env_n.sim.fused_substep_dr},
                        {"k2": 2 * pcfg.horizon_length, "k2dr": 0}, 2)[3]
    nodr_launches = {n: sum(r[f"{n}_launches"] for r in rows) for n in ("k2", "k2dr")}
    del env_n, trainer_n

    # ---- 7: checkpoint round trip, then play one episode
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.pt")
        checkpoint.save(path, ts)
        fresh = PPOTrainer(env, pcfg, seed=123)
        back = checkpoint.restore(path, fresh.init_state())
    with torch.no_grad():
        mu_a = trainer._policy(ts.params, ts.obs_stats, obs)[0]
        mu_b = fresh._policy(back.params, back.obs_stats, obs)[0]
    same = bool(torch.equal(mu_a, mu_b)) and back.epoch == ts.epoch
    stats = play(env, fresh, back, episodes=1)
    emit({"phase": "ckpt", "mu_identical": same, "play": stats,
          "seconds": time.perf_counter() - t0})
    if not same or stats["episodes"] != B or not math.isfinite(stats["return_mean"]):
        raise SystemExit(f"ckpt: mu identical {same}, play {stats}")

    # ---- 7b: C8 training through K3
    c8_train_launches = task_train(dev, C8, "c8", "k3", epochs=2)

    # ---- 7b2: one C11 epoch through K3 at <26, 2, 2>
    c11_train_launches = task_train(dev, C11, "c11", "k3")

    # ---- 7c: C10 training through K4, at its 2048 envs
    c10_train_launches = task_train(dev, C10, "c10", "k4", epochs=2, b=B10)

    # ---- 7c2: one full-width epoch each of C5 and C9 through K2
    c5_train_launches = task_train(dev, C5, "c5", "k2")
    c9_train_launches = task_train(dev, C9, "c9", "k2")

    # ---- 7d: terrain training through K1, without DR
    k1_train_launches = terrain_train(dev)

    # ---- 7e: DR on C8 and C10 through the non-kernel step: env steps, then
    # one PPO epoch each
    dr_checks(dev)
    for label, task, b in (("c8", C8, B), ("c10", C10, B10)):
        t0 = time.perf_counter()
        # horizon 16 (formerly 32): the non-kernel DR step is the
        # script's slowest path
        env_d, trainer_d = trainer_for(["task.randomize=true",
                                        "train.params.config.horizon_length=16"],
                                       task=task, b=b)
        ts_d = trainer_d.init_state()
        state_d, obs_d = env_d.reset()
        k_d = env_d.sim.fused_substep_multi if label == "c8" else env_d.sim.fused_substep_floating
        torch.cuda.synchronize()
        k_d.launches = 0
        te = time.perf_counter()
        ts_d, state_d, obs_d, metrics_d = trainer_d.train_epoch(ts_d, state_d, obs_d)
        torch.cuda.synchronize()
        m = {k_: float(v) for k_, v in metrics_d.items()}
        row = {"num_envs": b, "route": env_d.sim.route, "kernel_launches": k_d.launches,
               "epoch_s": time.perf_counter() - te,
               "finite": all(math.isfinite(v) for v in m.values()),
               **{k_: m[k_] for k_ in ("reward_mean", "a_loss", "c_loss", "kl")}}
        emit({"phase": f"dr_train/{label}", **row, "seconds": time.perf_counter() - t0})
        if k_d.launches or not row["finite"]:
            raise SystemExit(f"dr_train/{label}: {row}")
        del env_d, trainer_d, ts_d, state_d, obs_d

    # ---- 7f: shapes no kernel library is built for take the non-kernel step
    route_checks(dev)

    # ---- 7g: link-vs-link contacts on the non-kernel step
    link_checks(dev, flagship_steps=10)

    # ---- 7h: flatten_optimizer, the camera, AMP with the motion library, the
    # trajectory recorder
    flat_launches = flatten_train(dev)
    camera_launches = camera_checks(dev)
    amp_launches = amp_train(dev)
    viewer_check(dev)

    # ---- 7i: PBT, the data-parallel epoch in two processes, profile_ppo and
    # probe_ball, at full width through K2 and K2-dr
    with tempfile.TemporaryDirectory() as tmp:
        pbt_launches = pbt_flagship(dev, tmp)
        torch.cuda.empty_cache()
        ddp_launches = ddp_flagship(repo, tmp, statistics.median(r["epoch_s"]
                                                                 for r in epochs[1:]))
    profile_launches, probe_launches = tool_checks()

    # ---- 7j: the DR env step against the JAX step_dr, the physics switches,
    # the tensor-parallel trunks in two processes
    parity_dr_launches = parity_dr_checks(dev, repo)
    sw = switch_checks(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tp_launches = tp_flagship(repo, tmp)
    sw_paths = lambda key: {f"switches/{label}": v for (label, k), v in sw.items() if k == key}

    # ---- 8: the kernels line, the card, the verdict
    emit({"kernels": [{
        "name": "arm_step", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/arm_step.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:447",
        "launches": k1_launches, "launches_by_path": {
            "terrain_main": k1_launches, "terrain_train": k1_train_launches,
            "parity/terrain": parity_launches["terrain"]},
        **k1, "library_ms": None,
        "us": k1["ms"] * 1e3, "plain_us": k1["plain_ms"] * 1e3,
        "bound_us": k1["bound_ms"] * 1e3}, {
        "name": "fused_substep", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754",
        "launches": launches, "launches_by_path": {
            "main": launches, "train": train_launches["k2"], "train_nodr": nodr_launches["k2"],
            "c5_main": c5_launches, "c9_main": c9_launches, "c5_train": c5_train_launches,
            "c9_train": c9_train_launches, "flatten_train": flat_launches,
            "camera/flagship": camera_launches, "amp_train": amp_launches,
            "pbt/flagship": pbt_launches, "profile_ppo/flagship": profile_launches,
            "probe_ball/flagship": probe_launches, "tp/flagship": tp_launches,
            **sw_paths("fused_substep"),
            **{f"parity/{n}": parity_launches[n] for n in ("flagship", "c5", "c6", "c9")}},
        **k2_line, "library_ms": None, "us": k2_line["ms"] * 1e3,
        "plain_us": k2_line["plain_ms"] * 1e3, "bound_us": k2_line["bound_ms"] * 1e3}, {
        "name": "fused_substep_dr", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754 (with_dr=True, "
                    "isaacgym_tpu/sim/simulator.py:521)",
        "launches": train_launches["k2dr"], "launches_by_path": {
            "main": 0, "train": train_launches["k2dr"], "train_nodr": nodr_launches["k2dr"],
            "ddp/flagship": ddp_launches, "parity_dr/flagship": parity_dr_launches},
        **k2dr_line, "library_ms": None, "us": k2dr_line["ms"] * 1e3,
        "plain_us": k2dr_line["plain_ms"] * 1e3, "bound_us": k2dr_line["bound_ms"] * 1e3}, {
        "name": "fused_substep_multi", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep_multi.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:1477",
        "launches": c8_launches, "launches_by_path": {
            "c8_main": c8_launches, "c8_train": c8_train_launches,
            "parity/c8": parity_launches["c8"], "c11_main": c11_launches,
            "c11_train": c11_train_launches, "parity/c11": parity_launches["c11"],
            **sw_paths("fused_substep_multi")},
        **k3, "library_ms": None, "us": k3["ms"] * 1e3, "plain_us": k3["plain_ms"] * 1e3,
        "bound_us": k3["bound_ms"] * 1e3,
        "by_shape": {"7,2,1": {f: k3[f] for f in SHAPE_FIELDS},
                     "26,2,2": {f: k3c11[f] for f in SHAPE_FIELDS}}}, {
        "name": "fused_substep_tau", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754 (with_torque=True)",
        "launches": tau_launches["flagship"],
        "launches_by_path": {"sensors": tau_launches["flagship"],
                             **sw_paths("fused_substep_tau")},
        **k2tau, "library_ms": None, "us": k2tau["ms"] * 1e3,
        "plain_us": k2tau["plain_ms"] * 1e3, "bound_us": k2tau["bound_ms"] * 1e3}, {
        "name": "fused_substep_dr_tau", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:754 (with_dr=True, with_torque=True)",
        "launches": tau_launches["flagship_dr"],
        "launches_by_path": {"sensors": tau_launches["flagship_dr"],
                             **sw_paths("fused_substep_dr_tau")},
        **k2drtau, "library_ms": None, "us": k2drtau["ms"] * 1e3,
        "plain_us": k2drtau["plain_ms"] * 1e3, "bound_us": k2drtau["bound_ms"] * 1e3}, {
        "name": "fused_substep_multi_tau", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep_multi.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:1477 (with_torque=True)",
        "launches": tau_launches["c8"], "launches_by_path": {
            "sensors": tau_launches["c8"], "sensors/c11": tau_launches["c11"],
            **sw_paths("fused_substep_multi_tau")},
        **k3tau, "library_ms": None, "us": k3tau["ms"] * 1e3,
        "plain_us": k3tau["plain_ms"] * 1e3, "bound_us": k3tau["bound_ms"] * 1e3,
        "by_shape": {"7,2,1": {f: k3tau[f] for f in SHAPE_FIELDS},
                     "26,2,2": {f: k3tauc11[f] for f in SHAPE_FIELDS}}}, {
        "name": "fused_substep_floating", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep_floating.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:2225",
        "launches": c10_launches, "launches_by_path": {
            "c10_main": c10_launches, "c10_train": c10_train_launches,
            "parity/c10": parity_launches["c10"], **sw_paths("fused_substep_floating")},
        **k4, "library_ms": None, "us": k4["ms"] * 1e3, "plain_us": k4["plain_ms"] * 1e3,
        "bound_us": k4["bound_ms"] * 1e3}, {
        "name": "fused_substep_floating_tau", "route": "cuda",
        "source": "isaacgym_tpu_torch/csrc/fused_substep_floating.cu",
        "replaces": "isaacgym_tpu/ops/pallas_dynamics.py:2225 (with_torque=True)",
        "launches": tau_launches["c10"], "launches_by_path": {
            "sensors": tau_launches["c10"], **sw_paths("fused_substep_floating_tau")},
        **k4tau, "library_ms": None, "us": k4tau["ms"] * 1e3,
        "plain_us": k4tau["plain_ms"] * 1e3, "bound_us": k4tau["bound_ms"] * 1e3}]})
    print(f"total seconds {time.perf_counter() - t_all:.1f}", file=sys.stderr)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
