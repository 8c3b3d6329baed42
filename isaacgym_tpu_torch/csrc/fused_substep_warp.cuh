// K2, the fused physics substep of the flagship scene (one fixed-base arm,
// one ball), and its builds K2-dr (WITH_DR), K2-tau (WITH_TORQUE) and
// K2-dr-tau: the per-env body, two envs to a warp.
//
// Replaces isaacgym_tpu/ops/pallas_dynamics.py:754 (build_fused_substep,
// with_dr and with_torque False or True), in its order: the arm's dynamics
// (PD drive, FK, mass matrix, RNEA bias, Cholesky, integration with limits,
// FK at the new q); then the ball's free flight, the ground plane, every
// static geom (table, net, the base-welded humanoid geoms), every
// articulated geom with the joint-space reaction through the factor, the
// art-vs-static pairs, and the ball's caps and integration. The pack is
// fused_substep.cuh's; ND, WITH_DR and WITH_TORQUE are compile-time.
//
// Env b0 + a runs on half-warp a (lanes 16 a .. 16 a + 15; art_warp.cuh's
// EnvCols): both envs go through the same phases, each on its own column of
// x and y and its own part of the warp's shared block (K2Shared), so a phase
// on one lane per env issues once for both. The dynamics are art_warp.cuh's
// arms_dynamics with the arms as envs and the factor on one lane per env
// (SERIAL_FACTOR). The contacts take the form fused_substep_multi.cuh gives
// K3 at one ball:
//   - each env's flight and plane on a lane of its own, in the phase that
//     also runs each of its art-vs-static pairs' narrowphase (a lane each)
//     and clears its impulse rows;
//   - the statics: each env's statics tested on a lane each against its
//     ball's current state, then its lane 0 walks them in order to the first
//     that acts, which changes the state; the rest are tested again
//     (k2_statics_walk);
//   - the articulated geoms the same way, K2_CHUNK at a time per env, the
//     test split over the env's lanes (k2_art_tests), the first that acts
//     taking its reaction (k2_art_take: art_warp.cuh's cooperative solves,
//     the sums on one lane);
//   - the pairs in rounds, round p each env's pair p (k2_pair_round);
//   - the outputs, one lane per channel; the ball's caps on its own lane.
// Each reaction's whole arithmetic on one lane instead (one phase for the
// tests, one for the reactions and pairs) was within 2 % of this on the
// card and took 30 more registers (PERF.md). Whether a contact acts is decided per env, so the halves can need
// different phases: a phase runs whenever either env needs it (the loop
// conditions read both envs' state, the same on every lane), and an env with
// nothing to do in it idles under its own flag. Every each() is reached by
// all 32 lanes: no phase is called inside one env's branch.
//
// A test that does not act changes nothing but the sums a walk adds, so
// taking the tests ahead of the walk gives the one-thread results; the tests
// that cannot act are skipped (art_warp.cuh's ``apart``: a static, a geom or
// a pair whose hull clears the other's by a margin; K2-tau still forms a far
// static's moment term from its first sphere test). Every value is formed by
// the operations of the one-thread-per-env body this design replaced, in
// the same order, so the outputs are the same bits. The host's counting
// build runs this same body and takes back out the tests that a state change
// throws away (an acting static's, which ball_static repeats, and every test
// after the first that acts): its count is the work the data needs, the
// bound's.
//
// K2-dr reads its env's randomization rows (fused_substep.cuh) where the
// one-thread body did: the dynamics' in arms_dynamics, the gravity offset in
// the ball's flight, the friction and restitution scales on the articulated
// geoms and the base-welded statics (not the table, the net or the plane).
// K2-tau writes the moment rows after the impulse rows: each articulated
// geom body's contact moment about its frame origin, then the ball's about
// its centre.
#pragma once

#include <type_traits>

#include "art_warp.cuh"
#include "fused_substep.cuh"
#include "warp.cuh"

namespace igt {

constexpr int K2_ENVS = 2;               // envs per warp, one on each half
constexpr int K2_HW = WARP / K2_ENVS;    // an env's lanes
constexpr int K2_CHUNK = 2;              // an env's articulated geoms tested together
static_assert(K2_CHUNK * SWEEP_ART <= K2_HW, "a lane for each sweep sample of a chunk");

// The contacts' scratch of the warp's two envs.
template <class T, int ND, bool WITH_TORQUE>
struct K2Contact {
  ArmContact<T, ND> arm[K2_ENVS];
  BallState<T> ball[K2_ENVS];   // s_imp: the ball's impulse row (plane, statics, geoms)
  V3<T> geom_imp[K2_ENVS][MAX_ART], geom_tq[K2_ENVS][WITH_TORQUE ? MAX_ART : 1];
  // the ball-vs-art contact that acts: its depth and normal before the sweep
  V3<T> n_now[K2_ENVS];
  T d_now[K2_ENVS];
  // each pair's narrowphase: contact point, normal, depth, whether it
  // penetrates
  V3<T> pr_pt[K2_ENVS][MAX_PAIRS], pr_n[K2_ENVS][MAX_PAIRS];
  T pr_dist[K2_ENVS][MAX_PAIRS];
  unsigned char pr_hit[K2_ENVS][MAX_PAIRS];
  // the tests taken ahead: whether each static acts on the ball in its
  // current state, and the static's moment term; whether each articulated
  // geom of a chunk acts, and its test's terms
  unsigned char st_act[K2_ENVS][MAX_STATIC], ga_act[K2_ENVS][K2_CHUNK];
  int st_next[K2_ENVS];   // each env's next static to take
  V3<T> st_m[WITH_TORQUE ? K2_ENVS : 1][WITH_TORQUE ? MAX_STATIC : 1];
  ArtTest<T, ND> at[K2_ENVS][K2_CHUNK];
  // the counting build: each static test's operations (its cull's, the
  // rest's) and each articulated geom test's, for ops_drop
  long long st_ops[COUNTS<T> ? K2_ENVS : 1][COUNTS<T> ? MAX_STATIC : 1][2];
  long long ga_ops[COUNTS<T> ? K2_ENVS : 1][COUNTS<T> ? K2_CHUNK : 1];
};

// A warp's block: each env's arm state, and the scratch (the dynamics' and
// the contacts' in one storage where T allows it, warp.cuh).
template <class T, int ND, bool WITH_TORQUE>
struct K2Shared {
  ArmState<T, ND> arm[K2_ENVS];
  Overlay<ArmsDyn<T, ND, K2_ENVS>, K2Contact<T, ND, WITH_TORQUE>,
          std::is_trivially_default_constructible<T>::value> s;
};

IGT_HD const float* k2_static(const float* c, int nd, int si) {
  return c + static_off(nd) + si * STATIC_STRIDE;
}
IGT_HD const float* k2_geom(const float* c, int nd, int gi) {
  return c + art_off(nd) + gi * ART_STRIDE;
}
IGT_HD const float* k2_pair(const float* c, int nd, int pi) {
  return c + pair_off(nd) + pi * PAIR_STRIDE;
}

// Env a's ball: its flight (under g and, with WITH_DR, its env's gravity
// offset) and the plane, from the inputs: its state, plane impulse and moment
// before the statics.
template <class T, int ND, bool WITH_DR, bool WITH_TORQUE, class Io>
IGT_HD void k2_flight_plane(const float* c, const Io& io, int a, BallState<T>& bs) {
  const int ib = 4 * ND;
  V3<T> pos = v3<T>(T(io.get(ib, a)), T(io.get(ib + 1, a)), T(io.get(ib + 2, a)));
  V3<T> vel = v3<T>(T(io.get(ib + 3, a)), T(io.get(ib + 4, a)), T(io.get(ib + 5, a)));
  V3<T> omg = v3<T>(T(io.get(ib + 6, a)), T(io.get(ib + 7, a)), T(io.get(ib + 8, a)));
  const T gx = T(ldc(c + C_GX)), gy = T(ldc(c + C_GY)), gz = T(ldc(c + C_GZ));
  if constexpr (WITH_DR)   // DR rows 4 ND + 1 .. 3: the gravity offset
    ball_flight(c, gx + T(io.dr(a, 4 * ND + 1)), gy + T(io.dr(a, 4 * ND + 2)),
                gz + T(io.dr(a, 4 * ND + 3)), vel, omg);
  else
    ball_flight(c, gx, gy, gz, vel, omg);
  const V3<T> dv0 = ball_plane(c, pos, vel, omg);
  bs.s_imp = scale(dv0, T(ldc(c + C_MB)));
  bs.tq = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  if constexpr (WITH_TORQUE) bs.tq = static_moment(c, v3<T>(T(0.0f), T(0.0f), T(1.0f)), dv0);
  bs.pos = pos;
  bs.vel = vel;
  bs.omg = omg;
}

// Static si's materials against env a's ball: the pack's combined ones, or
// with WITH_DR for a base-welded humanoid geom (past the true statics) its
// own scaled by the env's DR rows 4 ND + 5 (restitution) and 4 ND + 4
// (friction), combined with the ball's.
template <class T, int ND, bool WITH_DR, class Io>
IGT_HD void k2_static_material(const float* c, const Io& io, int a, int si, T& e, T& mu) {
  const float* g = k2_static(c, ND, si);
  e = T(ldc(g + G_E));
  mu = T(ldc(g + G_MU));
  if constexpr (WITH_DR) {
    if (si >= (int)ldc(c + C_NTRUE_STATIC)) {
      e = T(0.5f) * (T(ldc(c + C_E_BALL)) + T(ldc(g + G_E_RAW)) * T(io.dr(a, 4 * ND + 5)));
      mu = T(0.5f) * (T(ldc(c + C_MU_BALL)) + T(ldc(g + G_MU_RAW)) * T(io.dr(a, 4 * ND + 4)));
    }
  }
}

// Static si against the ball in the state ``bs`` (ball_static's arithmetic up
// to its test): whether it acts and, with WITH_TORQUE, the moment term
// ball_static adds when it does not (a zero velocity change). ``far``: no
// sweep sample can penetrate, so the first sphere test gives the normal and
// the sweep is skipped.
template <class T, int ND, bool WITH_TORQUE>
IGT_HD bool k2_static_test(const float* c, int si, const BallState<T>& bs, bool far, V3<T>& m) {
  const float* g = k2_static(c, ND, si);
  const int kind = (int)ldc(g + G_KIND);
  const float* R = g + G_ROT;
  const T rb = T(ldc(c + C_RB)), z = T(0.0f);
  const V3<T> c0 = mat_t(R, sub(bs.pos, cv3<T>(g + G_POS)));
  T dist;
  V3<T> n_l;
  sphere_geom(kind, g + G_SIZE, c0, rb, dist, n_l);
  bool act = false;
  if (!far) {
    const V3<T> dv_l = mat_t(R, scale(bs.vel, T(ldc(c + C_DT_HALF))));
    sweep(kind, g + G_SIZE, rb, c0, dv_l, 2, dist, n_l);
    act = (dist < z) && (dot(bs.vel, mat(R, n_l)) < z);   // resolve_static's test
  }
  if constexpr (WITH_TORQUE) m = static_moment(c, mat(R, n_l), v3<T>(z, z, z));
  return act;
}

// Env a's ball against the statics in order, from static ``next``. Each
// static's test on the ball's current state is known (k2_static_test, a lane
// each): a static that does not act changes nothing but the impulse and
// moment sums, so the walk adds its terms (its zero velocity change over
// inv_m, its moment) and goes on; the first static that acts takes
// ball_static, which changes the state, and the walk stops there (``next``
// after it) for the later statics to be tested again. The counting build
// drops the work thrown away (``ops``: each test's cull and the rest): the
// acting static's test but its cull, and the later statics' tests.
template <class T, int ND, bool WITH_DR, bool WITH_TORQUE, class Io>
IGT_HD void k2_statics_walk(const float* c, const Io& io, int a, BallState<T>& bs,
                            const unsigned char* st_act, const V3<T>* st_m,
                            const long long (*ops)[2], int& next) {
  const T inv_mb = T(ldc(c + C_INV_MB));
  const T z = T(0.0f) / inv_mb;   // dv / inv_m of a static that does not act
  const int n_static = (int)ldc(c + C_NSTATIC);
  int si = next;
  for (; si < n_static; ++si) {
    if (!st_act[si]) {
      bs.s_imp = v3<T>(bs.s_imp.x + z, bs.s_imp.y + z, bs.s_imp.z + z);
      if constexpr (WITH_TORQUE) bs.tq = add(bs.tq, st_m[si]);
      continue;
    }
    T e, mu;
    k2_static_material<T, ND, WITH_DR>(c, io, a, si, e, mu);
    const V3<T> dv = ball_static(c, k2_static(c, ND, si), e, mu, bs.pos, bs.vel, bs.omg,
                                 WITH_TORQUE ? &bs.tq : nullptr);
    bs.s_imp = v3<T>(bs.s_imp.x + dv.x / inv_mb, bs.s_imp.y + dv.y / inv_mb,
                     bs.s_imp.z + dv.z / inv_mb);
    if constexpr (COUNTS<T>) {
      long long thrown = ops[si][1];
      for (int sj = si + 1; sj < n_static; ++sj) thrown += ops[sj][0] + ops[sj][1];
      ops_drop(T(), thrown);
    }
    ++si;
    break;
  }
  next = si;
}

// Whether each env's ball acts on its articulated geoms g0[a] .. g0[a] +
// n[a] - 1 (n[a] <= K2_CHUNK; 0: the env has none left) in the ball's and
// the arm's current state: the ball-vs-art contact's arithmetic up to its
// test, split over the env's lanes (each geom's cull and geometry, one
// Jacobian column per lane, each geom's point velocity and sweep samples, one
// sample's sphere test per lane, each geom's first penetrating sample and the
// test) -> ct.ga_act; the counting build also gathers each test's operations
// in ct.ga_ops.
template <class T, int ND, class Sh>
IGT_HD void k2_art_tests(const float* c, const int* g0_, const int* n_, Sh& sh, const Lanes& w) {
  constexpr int G = K2_ENVS, HW = K2_HW;
  auto& ct = sh.s.ct;
  int g0[G], n[G];
  for (int a = 0; a < G; ++a) {
    g0[a] = g0_[a];
    n[a] = n_[a];
  }
  const T rb = T(ldc(c + C_RB));
  // the cull: the contact point's speed is at most sum |u_i| (|pos - fp_i| +
  // r) over the DOFs, so the sweep reaches at most (|vel| + that) dt
  each_arm<G>(w, [=, &sh, &ct](int a, int k) {
    if (k >= n[a]) return;
    const long long o = ops_now(T());
    const float* g = k2_geom(c, ND, g0[a] + k);
    const auto& ar = sh.arm[a];
    const V3<T> pos = ct.ball[a].pos, vel = ct.ball[a].vel;
    T vb = T(0.0f);
    for (int i = 0; i < ND; ++i) {
      const V3<T> d = sub(pos, ar.fp[i]);
      vb = vb + abs_(ar.u[i]) * (dof_rev(c, i) ? sqrt_(dot(d, d)) + rb : T(1.0f));
    }
    V3<T> lp;
    Q4<T> lq;
    link_frame<T, ND>(c, ar, (int)ldc(g + A_LINK), lp, lq);
    const V3<T> d = sub(pos, add(lp, qrot(lq, cv3<T>(g + A_OFF_POS))));
    ct.at[a][k].near = !apart(sqrt_(dot(d, d)), hull_radius<T>((int)ldc(g + A_KIND), g + A_SIZE),
                              rb, (sqrt_(dot(vel, vel)) + vb) * T(4.0f) * T(ldc(c + C_DT_QUARTER)));
    ct.ga_act[a][k] = 0;
    if constexpr (COUNTS<T>) ct.ga_ops[a][k] = ops_now(T()) - o;
  });
  bool any = false;
  for (int a = 0; a < G; ++a)
    for (int k = 0; k < n[a]; ++k) any = any || ct.at[a][k].near;
  if (!any) return;
  each_arm<G>(w, [=, &sh, &ct](int a, int k) {
    if (k >= n[a] || !ct.at[a][k].near) return;
    const long long o = ops_now(T());
    const float* g = k2_geom(c, ND, g0[a] + k);
    auto& at = ct.at[a][k];
    const V3<T> pos = ct.ball[a].pos;
    V3<T> lp;
    Q4<T> lq;
    link_frame<T, ND>(c, sh.arm[a], (int)ldc(g + A_LINK), lp, lq);
    const V3<T> gp = add(lp, qrot(lq, cv3<T>(g + A_OFF_POS)));
    const Q4<T> gq = qmul(lq, cq4<T>(g + A_OFF_QUAT));
    const V3<T> c0 = qrot(conj(gq), sub(pos, gp));
    T d_now;
    V3<T> n_now_l;
    sphere_geom((int)ldc(g + A_KIND), g + A_SIZE, c0, rb, d_now, n_now_l);
    const V3<T> n_now = qrot(gq, n_now_l);
    at.c0 = c0;
    at.gq = gq;
    at.d_now = d_now;
    at.n_now_l = n_now_l;
    at.n_now = n_now;
    at.cp = sub(pos, scale(n_now, rb));
    if constexpr (COUNTS<T>) ct.ga_ops[a][k] += ops_now(T()) - o;
  });
  each_arm<G>(w, [=, &sh, &ct](int a, int s) {
    for (int t = s; t < n[a] * ND; t += HW) {
      const int k = t / ND, i = t % ND;
      auto& at = ct.at[a][k];
      if (!at.near) continue;
      const long long o = ops_now(T());
      bool on;
      const V3<T> col = jac_col<T, ND>(c, c + mask_off(ND), (int)ldc(k2_geom(c, ND, g0[a] + k) + A_LINK),
                                       i, at.cp, sh.arm[a].fp, sh.arm[a].axw, on);
      at.Jc[i] = col;
      at.on[i] = on;
      if (on) at.cu[i] = scale(col, sh.arm[a].u[i]);
      if constexpr (COUNTS<T>) ct.ga_ops[a][k] += ops_now(T()) - o;
    }
  });
  each_arm<G>(w, [=, &ct](int a, int k) {
    if (k >= n[a] || !ct.at[a][k].near) return;
    const long long o = ops_now(T());
    auto& at = ct.at[a][k];
    V3<T> v_point = v3<T>(T(0.0f), T(0.0f), T(0.0f));
    for (int i = 0; i < ND; ++i)
      if (at.on[i]) v_point = add(v_point, at.cu[i]);
    at.v_rel = sub(ct.ball[a].vel, v_point);
    const V3<T> dv_l = qrot(conj(at.gq), scale(at.v_rel, T(ldc(c + C_DT_QUARTER))));
    V3<T> ck = at.c0;
    for (int m = 0; m < SWEEP_ART; ++m) {
      ck = add(ck, dv_l);
      at.ck[m] = ck;
    }
    if constexpr (COUNTS<T>) ct.ga_ops[a][k] += ops_now(T()) - o;
  });
  each_arm<G>(w, [=, &ct](int a, int s) {
    const int k = s / SWEEP_ART, m = s % SWEEP_ART;
    if (k >= n[a] || !ct.at[a][k].near) return;
    const long long o = ops_now(T());
    auto& at = ct.at[a][k];
    const float* g = k2_geom(c, ND, g0[a] + k);
    sphere_geom((int)ldc(g + A_KIND), g + A_SIZE, at.ck[m], rb, at.dk[m], at.nk[m]);
    if constexpr (COUNTS<T>) ct.ga_ops[a][k] += ops_now(T()) - o;
  });
  each_arm<G>(w, [=, &ct](int a, int k) {
    if (k >= n[a] || !ct.at[a][k].near) return;
    const long long o = ops_now(T());
    auto& at = ct.at[a][k];
    T dist = at.d_now;   // sweep: the first penetrating sample wins
    V3<T> n_l = at.n_now_l;
    bool found = dist < T(0.0f);
    for (int m = 0; m < SWEEP_ART; ++m) {
      if (!found && at.dk[m] < T(0.0f)) {
        dist = at.dk[m];
        n_l = at.nk[m];
      }
      found = found || at.dk[m] < T(0.0f);
    }
    at.n = qrot(at.gq, n_l);
    at.vn = dot(at.v_rel, at.n);
    ct.ga_act[a][k] = (dist < T(0.0f)) && (at.vn < T(0.0f));
    if constexpr (COUNTS<T>) ct.ga_ops[a][k] += ops_now(T()) - o;
  });
}

// The reaction of each env's acting ball-vs-art contact, test k[a] of its
// chunk from geom g0[a] (k[a] == n[a]: none): the test's columns, swept
// normal and normal velocity become the env's contact; then the solves, the
// impulse (materials from the pack, or with WITH_DR the geom's own scaled by
// the env's DR rows and combined with the ball's), the ball's change, the
// rows, the joint-space reaction. The impulse joins the ball's row, its
// negation is the geom's row; with WITH_TORQUE the moments join the ball's
// and the geom body's.
template <class T, int ND, bool WITH_DR, bool WITH_TORQUE, class Io, class Sh>
IGT_HD void k2_art_take(const float* c, const Io& io, const int* g0_, const int* k_,
                        const int* n_, Sh& sh, const Lanes& w) {
  constexpr int G = K2_ENVS, HW = K2_HW;
  auto& ct = sh.s.ct;
  int gi[G], k[G];
  bool acts[G];
  for (int a = 0; a < G; ++a) {
    k[a] = k_[a];
    gi[a] = g0_[a] + k[a];
    acts[a] = k[a] < n_[a];
  }
  const T rb = T(ldc(c + C_RB));
  each_arm<G>(w, [=, &ct](int a, int s) {
    auto& ac = ct.arm[a];
    if (s == 0) ac.act = acts[a];
    if (!acts[a]) return;
    const auto& at = ct.at[a][k[a]];
    for (int i = s; i < ND; i += HW) {
      ac.Jc[i] = at.Jc[i];
      ac.on[i] = at.on[i];
    }
    if (s != 0) return;
    ct.d_now[a] = at.d_now;
    ct.n_now[a] = at.n_now;
    ac.pt = at.cp;
    const float* g = k2_geom(c, ND, gi[a]);
    T e_art;
    if constexpr (WITH_DR)   // restitution scale: DR row 4 ND + 5
      e_art = T(0.5f) * (T(ldc(c + C_E_BALL)) + T(ldc(g + A_E_RAW)) * T(io.dr(a, 4 * ND + 5)));
    else
      e_art = T(ldc(g + A_E));
    const V3<T> v_rel = at.v_rel, n = at.n;
    ac.e_eff = sel(abs_(at.vn) > T(ldc(c + C_BOUNCE)), e_art, T(0.0f));
    const V3<T> slip = ldc(c + C_KAPPA) > 0.0f ? sub(v_rel, scale(cross(ct.ball[a].omg, n), rb))
                                                : v_rel;
    const V3<T> vt = sub(slip, scale(n, dot(slip, n)));
    ac.vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
    ac.t_hat = scale(vt, T(1.0f) / ac.vt_n);
    ac.n = n;
    ac.vn = at.vn;
  });
  contact_solve<T, ND, G>(sh, w);
  each_arm<G>(w, [=, &sh, &ct](int a, int s) {
    auto& ac = ct.arm[a];
    if (!ac.act || s != 0) return;
    auto& bs = ct.ball[a];
    const float* g = k2_geom(c, ND, gi[a]);
    const T inv_mb = T(ldc(c + C_INV_MB));
    const T Pn = -(T(1.0f) + ac.e_eff) * ac.vn / (inv_mb + sum_sq<T, ND>(ac.sqn));
    const T w_t = T(ldc(c + C_WT0)) + sum_sq<T, ND>(ac.sqt);
    T mu_art;
    if constexpr (WITH_DR)   // friction scale: DR row 4 ND + 4
      mu_art = T(0.5f) * (T(ldc(c + C_MU_BALL)) + T(ldc(g + A_MU_RAW)) * T(io.dr(a, 4 * ND + 4)));
    else
      mu_art = T(ldc(g + A_MU));
    const T Pt = min_(mu_art * Pn, ac.vt_n / w_t);
    const V3<T> n = ac.n, t_hat = ac.t_hat;
    const V3<T> P = sub(scale(n, Pn), scale(t_hat, Pt));
    bs.vel = add(bs.vel, scale(P, inv_mb));
    bs.omg = add(bs.omg, scale(cross(n, t_hat), T(ldc(c + C_KAPPA_INVMB_OVER_RB)) * Pt));
    ac.an = -Pn;
    ac.at = Pt;
    ac.minus = 0;
    bs.pos = add(bs.pos, scale(n, max_(-ct.d_now[a], T(0.0f))));
    if constexpr (WITH_TORQUE) {
      bs.tq = add(bs.tq, scale(cross(ct.n_now[a], P), -rb));
      V3<T> lp;
      Q4<T> lq;
      link_frame<T, ND>(c, sh.arm[a], (int)ldc(g + A_LINK), lp, lq);
      const V3<T> borg = add(lp, qrot(lq, cv3<T>(g + A_BODY_OFF)));
      ct.geom_tq[a][gi[a]] = add(ct.geom_tq[a][gi[a]], cross(sub(ac.pt, borg), scale(P, T(-1.0f))));
    }
    ct.geom_imp[a][gi[a]] = v3<T>(-P.x, -P.y, -P.z);
    bs.s_imp = add(bs.s_imp, P);
  });
  contact_back<T, ND, G>(sh, w);
}

// Round p of the art-vs-static pairs: pair p of each env whose narrowphase
// penetrates (``hit[a]``), on the env's lanes, both envs at once: the
// Baumgarte impulse on the arm's velocities, the 2 mm resting band. The
// impulse joins the geom's row; with WITH_TORQUE its moment about the geom
// body's frame origin joins the geom's moment row.
template <class T, int ND, bool WITH_TORQUE, class Sh>
IGT_HD void k2_pair_round(const float* c, const bool* hit, int p, Sh& sh, const Lanes& w) {
  constexpr int G = K2_ENVS, HW = K2_HW;
  auto& ct = sh.s.ct;
  bool h[G];
  for (int a = 0; a < G; ++a) h[a] = hit[a];
  const float* pr = k2_pair(c, ND, p);
  const int gi = (int)ldc(pr + P_ART);
  const float* g = k2_geom(c, ND, gi);
  each_arm<G>(w, [=, &sh, &ct](int a, int s) {
    if (h[a]) contact_cols<T, ND, HW>(c, sh.arm[a], ct.arm[a], ct.pr_pt[a][p], (int)ldc(g + A_LINK), s);
  });
  each_arm<G>(w, [=, &ct](int a, int s) {
    if (s != 0) return;
    auto& ac = ct.arm[a];
    ac.act = 0;
    if (!h[a]) return;
    const V3<T> n = ct.pr_n[a][p];
    const V3<T> v_point = point_velocity<T, ND>(ac);
    const T vn = dot(v_point, n);
    if (!(vn < T(0.1f))) return;   // separating: no impulse
    ac.act = 1;
    const T bounce = T(ldc(c + C_BOUNCE));
    ac.bias = min_(T(ldc(c + C_BIAS_K)) * max_(-ct.pr_dist[a][p] - T(0.005f), T(0.0f)),
                   T(ldc(c + C_MAX_DEPEN)));
    ac.e_eff = sel(abs_(vn) > bounce, T(ldc(pr + P_E)), T(0.0f));
    const V3<T> vt = sub(v_point, scale(n, vn));
    ac.vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
    ac.t_hat = scale(vt, T(1.0f) / ac.vt_n);
    ac.n = n;
    ac.vn = vn;
  });
  bool acts = false;
  for (int a = 0; a < G; ++a) acts = acts || ct.arm[a].act;
  if (!acts) return;
  contact_solve<T, ND, G>(sh, w);
  each_arm<G>(w, [=, &sh, &ct](int a, int s) {
    auto& ac = ct.arm[a];
    if (!ac.act || s != 0) return;
    const T bounce = T(ldc(c + C_BOUNCE)), dist = ct.pr_dist[a][p];
    T Pn = (-(T(1.0f) + ac.e_eff) * min_(ac.vn, T(0.0f)) + ac.bias)
        / max_(sum_sq<T, ND>(ac.sqn), T(1e-9f));
    T Pt = min_(T(ldc(pr + P_MU)) * Pn, ac.vt_n / max_(sum_sq<T, ND>(ac.sqt), T(1e-9f)));
    // resting-contact band: ramp the impulse over the first 2 mm
    const T s_r = sel(abs_(ac.vn) > bounce, T(1.0f), clip_(-dist / T(0.002f), T(0.0f), T(1.0f)));
    Pn = Pn * s_r;
    Pt = Pt * s_r;
    ac.an = Pn;
    ac.at = Pt;
    ac.minus = 1;
    const V3<T> P = sub(scale(ac.n, Pn), scale(ac.t_hat, Pt));
    ct.geom_imp[a][gi] = add(ct.geom_imp[a][gi], P);
    if constexpr (WITH_TORQUE) {
      V3<T> lp;
      Q4<T> lq;
      link_frame<T, ND>(c, sh.arm[a], (int)ldc(g + A_LINK), lp, lq);
      ct.geom_tq[a][gi] = add(ct.geom_tq[a][gi],
                              cross(sub(ct.pr_pt[a][p], add(lp, qrot(lq, cv3<T>(g + A_BODY_OFF)))), P));
    }
  });
  contact_back<T, ND, G>(sh, w);
}

// ------------------------------------------------------------- the body --
// Envs b0 and b0 + 1 of K2's substep, run by the warp ``w`` with the warp's
// block ``sh`` (b0 + 1 == B: env b0 alone, EnvCols). x: (n_in(ND) [+
// n_dr(ND) with WITH_DR], B) inputs, y: (n_out(ND, ng, WITH_TORQUE), B)
// outputs, both channel-major; env b reads and writes column b.
template <class T, int ND, bool WITH_DR = false, bool WITH_TORQUE = false>
IGT_HD void fused_substep_warp(const float* __restrict__ c, const float* __restrict__ x,
                               float* __restrict__ y, int b0, int B,
                               K2Shared<T, ND, WITH_TORQUE>& sh, const Lanes& w) {
  constexpr int G = K2_ENVS, HW = K2_HW;
  const EnvCols<ND, G> io{x, y, b0, B, (size_t)B, n_in(ND)};
  arms_dynamics<T, ND, G, WITH_DR, true>([c](int) { return c; }, io, sh, w);

  auto& ct = sh.s.ct;
  const int ng = (int)ldc(c + C_NART), n_pair = (int)ldc(c + C_NPAIR);
  const int n_static = (int)ldc(c + C_NSTATIC);

  // each env's flight and plane (its lane 0); its impulse rows cleared; each
  // of its pairs' narrowphase (a lane each)
  each_arm<G>(w, [=, &sh, &ct](int a, int s) {
    if (s == 0) {
      k2_flight_plane<T, ND, WITH_DR, WITH_TORQUE>(c, io, a, ct.ball[a]);
      ct.st_next[a] = 0;
    }
    for (int gi = s; gi < ng; gi += HW) {
      ct.geom_imp[a][gi] = v3<T>(T(0.0f), T(0.0f), T(0.0f));
      if constexpr (WITH_TORQUE) ct.geom_tq[a][gi] = ct.geom_imp[a][gi];
    }
    for (int p = s; p < n_pair; p += HW) {
      const float* pr = k2_pair(c, ND, p);
      const float* g = k2_geom(c, ND, (int)ldc(pr + P_ART));
      const float* sg = k2_static(c, ND, (int)ldc(pr + P_STATIC));
      V3<T> lp;   // a geom whose hull clears the static's cannot act
      Q4<T> lq;
      link_frame<T, ND>(c, sh.arm[a], (int)ldc(g + A_LINK), lp, lq);
      const V3<T> d = sub(add(lp, qrot(lq, cv3<T>(g + A_OFF_POS))), cv3<T>(sg + G_POS));
      if (apart(sqrt_(dot(d, d)), hull_radius<T>((int)ldc(sg + G_KIND), sg + G_SIZE),
                hull_radius<T>((int)ldc(g + A_KIND), g + A_SIZE), T(0.0f))) {
        ct.pr_hit[a][p] = 0;
        continue;
      }
      pair_narrowphase<T, ND>(c, sh.arm[a], pr, g, sg, ct.pr_pt[a][p], ct.pr_n[a][p],
                              ct.pr_dist[a][p]);
      ct.pr_hit[a][p] = ct.pr_dist[a][p] < T(0.0f);
    }
  });

  // the statics in order: each env's statics from its next one on tested on a
  // lane each against its ball's current state, then its lane 0 walks them up
  // to the first that acts (k2_statics_walk), until both envs have taken
  // every static
  for (;;) {
    bool more = false;
    for (int a = 0; a < G; ++a) more = more || ct.st_next[a] < n_static;
    if (!more) break;
    each_arm<G>(w, [=, &ct](int a, int s) {
      for (int si = s; si < n_static; si += HW) {
        if (si < ct.st_next[a]) continue;
        const long long o = ops_now(T());
        const float* g = k2_static(c, ND, si);
        const auto& bs = ct.ball[a];
        const V3<T> d = sub(bs.pos, cv3<T>(g + G_POS));
        const bool far = apart(sqrt_(dot(d, d)), hull_radius<T>((int)ldc(g + G_KIND), g + G_SIZE),
                               T(ldc(c + C_RB)), sqrt_(dot(bs.vel, bs.vel)) * T(ldc(c + C_DT)));
        const long long o_cull = ops_now(T());
        ct.st_act[a][si] = 0;
        if (WITH_TORQUE || !far) {   // K2-tau still needs a far static's moment term
          V3<T> m;
          ct.st_act[a][si] = k2_static_test<T, ND, WITH_TORQUE>(c, si, bs, far, m);
          if constexpr (WITH_TORQUE) ct.st_m[a][si] = m;
        }
        if constexpr (COUNTS<T>) {
          ct.st_ops[a][si][0] = o_cull - o;
          ct.st_ops[a][si][1] = ops_now(T()) - o_cull;
        }
      }
    });
    each_arm<G>(w, [=, &ct](int a, int s) {
      if (s == 0 && ct.st_next[a] < n_static)
        k2_statics_walk<T, ND, WITH_DR, WITH_TORQUE>(c, io, a, ct.ball[a], ct.st_act[a],
                                                      ct.st_m[WITH_TORQUE ? a : 0],
                                                      ct.st_ops[COUNTS<T> ? a : 0], ct.st_next[a]);
    });
  }

  // each env's ball against its articulated geoms in order: the geoms from
  // its next one on are tested K2_CHUNK at a time (k2_art_tests) against the
  // current state. A geom that does not act changes nothing; the first that
  // acts takes its reaction (k2_art_take), which changes the state, and the
  // geoms after it are tested again (the counting build drops their first
  // tests).
  int next[G];
  for (int a = 0; a < G; ++a) next[a] = 0;
  for (;;) {
    int n[G], k[G];
    bool more = false;
    for (int a = 0; a < G; ++a) {
      n[a] = ng - next[a] < K2_CHUNK ? ng - next[a] : K2_CHUNK;
      more = more || n[a] > 0;
    }
    if (!more) break;
    sync(w);   // every lane has read the last tests
    k2_art_tests<T, ND>(c, next, n, sh, w);
    bool any = false;
    for (int a = 0; a < G; ++a) {
      k[a] = 0;
      while (k[a] < n[a] && !ct.ga_act[a][k[a]]) ++k[a];
      if constexpr (COUNTS<T>)
        for (int j = k[a] + 1; j < n[a]; ++j) ops_drop(T(), ct.ga_ops[a][j]);
      any = any || k[a] < n[a];
    }
    if (any) k2_art_take<T, ND, WITH_DR, WITH_TORQUE>(c, io, next, k, n, sh, w);
    for (int a = 0; a < G; ++a) next[a] += k[a] < n[a] ? k[a] + 1 : n[a];
  }

  // articulated geoms vs the true statics: pairs pruned at pack time
  for (int p = 0; p < n_pair; ++p) {
    bool hit[G], any = false;
    for (int a = 0; a < G; ++a) {
      hit[a] = ct.pr_hit[a][p];
      any = any || hit[a];
    }
    if (any) k2_pair_round<T, ND, WITH_TORQUE>(c, hit, p, sh, w);
  }

  // outputs: qd, the impulse rows (then the moment rows); the ball capped
  // and integrated on the env's last lane
  each_arm<G>(w, [=, &sh, &ct](int a, int s) {
    const int io0 = 3 * ND + 9, it = io0 + 3 * (ng + 1);
    for (int d = s; d < ND; d += HW) io.put(ND + d, a, sh.arm[a].u[d]);
    for (int gi = s; gi < ng; gi += HW) {
      const V3<T> p = ct.geom_imp[a][gi];
      io.put(io0 + 3 * gi, a, p.x); io.put(io0 + 3 * gi + 1, a, p.y); io.put(io0 + 3 * gi + 2, a, p.z);
      if constexpr (WITH_TORQUE) {
        const V3<T> tq = ct.geom_tq[a][gi];
        io.put(it + 3 * gi, a, tq.x); io.put(it + 3 * gi + 1, a, tq.y); io.put(it + 3 * gi + 2, a, tq.z);
      }
    }
    if (s != HW - 1) return;
    const BallState<T>& bs = ct.ball[a];
    const int ib = io0 + 3 * ng;
    io.put(ib, a, bs.s_imp.x); io.put(ib + 1, a, bs.s_imp.y); io.put(ib + 2, a, bs.s_imp.z);
    if constexpr (WITH_TORQUE) {
      io.put(it + 3 * ng, a, bs.tq.x); io.put(it + 3 * ng + 1, a, bs.tq.y);
      io.put(it + 3 * ng + 2, a, bs.tq.z);
    }
    V3<T> pos = bs.pos, vel = bs.vel, omg = bs.omg;
    ball_finish(c, pos, vel, omg);
    const int o = 3 * ND;
    io.put(o, a, pos.x); io.put(o + 1, a, pos.y); io.put(o + 2, a, pos.z);
    io.put(o + 3, a, vel.x); io.put(o + 4, a, vel.y); io.put(o + 5, a, vel.z);
    io.put(o + 6, a, omg.x); io.put(o + 7, a, omg.y); io.put(o + 8, a, omg.z);
  });
}

}  // namespace igt
