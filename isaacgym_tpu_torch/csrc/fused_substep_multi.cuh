// K3, the fused physics substep of K fixed-base articulations and NB balls
// (the two-humanoid C8 scene), and its torque-lane build K3-tau: the per-env
// body, run by one warp.
//
// Replaces isaacgym_tpu/ops/pallas_dynamics.py:1477 (build_fused_substep_multi;
// K3 with with_torque=False, K3-tau with with_torque=True, the compile-time
// WITH_TORQUE), in its order: each articulation's dynamics (PD or
// effort drive, FK, mass matrix, RNEA bias, Cholesky, integration, FK at the
// new q); then per ball its free flight, the plane, every static geom and
// every articulated geom of every articulation, each reaction going into
// that articulation's DOF block through its own factor; the ball pair; the
// balls' caps and integration; then every articulated geom against the true
// statics. Each step is K2's arithmetic (fused_substep.cuh) applied to the
// articulation's or the ball's own block of the constant pack.
//
// Pack layout (mirrored by isaacgym_tpu_torch/ops/fused_substep_multi.py,
// which checks it against igt_multi_layout): a HEAD-slot header (K2's scene
// slots plus H_*), K articulation blocks each laid out as K2's pack up to its
// static list (header with base pose, drive mode and its geoms' and pairs'
// ranges, DOF table, mask), MAX_BALLS ball blocks each a K2 header with that
// ball's slots, then the static geoms, the articulated geoms (grouped by
// articulation) and the art-vs-static pairs. Static and articulated entries
// carry the material combined with each ball; articulated entries keep K2's
// slots, the body origin (A_BODY_OFF) included.
//
// K3-tau writes, after K3's impulse rows, each articulated geom body's
// contact moment about its frame origin and each ball's about its centre:
// (B, 2 ng + 3 NB, 3) impulse rows in all. A ball-pair contact gives each
// ball -r_i (n x P), as the JAX package's ball-pair block takes it.
//
// One warp per env (warp.cuh), the articulations side by side: articulation
// a runs on lanes a 32/K .. (a + 1) 32/K - 1, all of them through the same
// phases of art_warp.cuh (the dynamics; a contact's columns and solves), or
// at the shapes TREE_CAP names (<26, 2, 2>) of tree_warp.cuh, which runs
// each articulation as the subtrees of its base, block by block. The
// env's state lives in its block of shared memory (MultiShared: each
// articulation's factor, u and frames; the dynamics' scratch and the
// contacts' overlaid). The contacts, in the one-thread order:
//   - each ball's flight and plane on a lane of its own, in the phase that
//     also runs every art-vs-static pair's narrowphase (one lane each: it
//     reads only the post-step frames) and clears the impulse rows;
//   - the statics: every (ball, static) tested on a lane of its own against
//     the ball's current state, then each ball's lane walks them in order to
//     the first that acts, which changes the state; the rest are tested
//     again (statics_walk);
//   - each ball against each articulated geom in order, the same way: the
//     geoms from the next one on tested a chunk at a time, split over lanes
//     (ball_art_tests), the first that acts taking its reaction with the
//     solves cooperative and the sums on one lane (ball_art_take);
//   - the ball pair on one lane;
//   - the art-vs-static pairs in rounds: round p takes each articulation's
//     p-th pair, the articulations' at once on their own lanes (they touch
//     different u, factors and geom rows);
//   - the outputs, one lane per channel; the balls' caps and integration on
//     their own lanes.
// A test that does not act changes nothing but the sums a walk adds (a
// static's zero velocity change over inv_m, its moment term), so taking the
// tests ahead of the walk gives the one-thread results. The tests that cannot
// act are skipped: a static, a geom or a pair whose hull clears the ball's
// swept sphere (or the static's hull) by a margin (``apart``; K3-tau still
// forms a far static's moment term, from its first sphere test). Whether a
// contact acts is decided per env, so every lane takes the same branch
// between phases. Every value is formed by the same operations in the same
// order as in the one-thread-per-env body this design replaced, so the
// outputs are the same bits. The host's counting build runs this same body
// and takes back out the tests that a state change throws away (an acting
// static's test, which ball_static repeats, and every test after the first
// that acts): its count is the work the data needs, the bound's. ND, K and
// NB are template parameters.
//
// What bounds it on an H100: see fused_substep_multi.cu.
#pragma once

#include <type_traits>

#include "art_warp.cuh"
#include "fused_substep.cuh"
#include "tree_warp.cuh"
#include "warp.cuh"

namespace igt {

constexpr int MULTI_HEAD = 64;
constexpr int MAX_BALLS = 2;
constexpr int MULTI_MAX_STATIC = 24;
constexpr int MULTI_MAX_ART = 16;
constexpr int MULTI_MAX_PAIRS = 32;
// scene-wide header slots past K2's
enum : int { H_K = 40, H_NB = 41, H_BB_E = 42, H_BB_MU = 43, H_BB_WN = 44, H_BB_WT = 45,
             H_BB_T = 46 };
// articulation block slots past K2's
enum : int { C_GEOM_LO = 40, C_GEOM_HI = 41, C_PAIR_LO = 42, C_PAIR_HI = 43 };
constexpr int BALL_STRIDE = 48;
constexpr int MULTI_STATIC_STRIDE = 24;
constexpr int MULTI_ART_STRIDE = 28;
// per-ball materials (+ 2 bi) past K2's entry slots; the entry's articulation
enum : int { G_EB = 20, G_MUB = 21, A_EB = 20, A_MUB = 21, A_ART = 24 };

IGT_HD constexpr int multi_art_stride(int nd) { return static_off(nd); }
IGT_HD constexpr int multi_ball_off(int nd, int k) { return MULTI_HEAD + k * multi_art_stride(nd); }
IGT_HD constexpr int multi_static_off(int nd, int k) { return multi_ball_off(nd, k) + MAX_BALLS * BALL_STRIDE; }
IGT_HD constexpr int multi_art_off(int nd, int k) {
  return multi_static_off(nd, k) + MULTI_MAX_STATIC * MULTI_STATIC_STRIDE;
}
IGT_HD constexpr int multi_pair_off(int nd, int k) {
  return multi_art_off(nd, k) + MULTI_MAX_ART * MULTI_ART_STRIDE;
}
IGT_HD constexpr int multi_total(int nd, int k) { return multi_pair_off(nd, k) + MULTI_MAX_PAIRS * PAIR_STRIDE; }
IGT_HD constexpr int multi_n_in(int nd_tot, int nb) { return 4 * nd_tot + 9 * nb; }

// Fills ``out`` with the layout, in the order of fused_substep_multi.py's
// _LAYOUT_KEYS, so the Python side can check it.
inline int fill_multi_layout(int nd, int k, int* out, int n) {
  if (n < 21 || nd < 1 || k < 1) return 1;
  const int v[21] = {MULTI_HEAD, multi_art_stride(nd), multi_ball_off(nd, k), BALL_STRIDE,
                     multi_static_off(nd, k), MULTI_STATIC_STRIDE, multi_art_off(nd, k),
                     MULTI_ART_STRIDE, multi_pair_off(nd, k), multi_total(nd, k), MAX_BALLS,
                     MULTI_MAX_STATIC, MULTI_MAX_ART, MULTI_MAX_PAIRS, H_K, H_BB_T, C_DRIVE,
                     C_GEOM_LO, G_EB, A_ART, A_EB};
  for (int i = 0; i < 21; ++i) out[i] = v[i];
  return 0;
}

// The two balls' swept sphere-sphere impulse with spin; s_imp gathers it
// into each ball's static row, and with ``tqa`` each ball's moment -r (n x P)
// is added to tqa and tqb.
template <class T>
IGT_HD void ball_pair(const float* c, const float* ca, const float* cb, V3<T>& pa, V3<T>& va,
                      V3<T>& wa, V3<T>& sa, V3<T>& pb, V3<T>& vb, V3<T>& wb, V3<T>& sb,
                      V3<T>* tqa = nullptr, V3<T>* tqb = nullptr) {
  V3<T> d = sub(pa, pb);
  T dn = sqrt_floor(dot(d, d), 1e-18f);
  V3<T> n = scale(d, T(1.0f) / dn);
  V3<T> v_rel = sub(va, vb);
  T dist = dn;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    V3<T> dk = add(d, scale(v_rel, T(ldc(c + H_BB_T + kk))));
    dist = min_(dist, sqrt_floor(dot(dk, dk), 1e-18f));
  }
  const T ra = T(ldc(ca + C_RB)), rb = T(ldc(cb + C_RB));
  T dist_now = dn - ra - rb;
  dist = dist - ra - rb;
  T vn = dot(v_rel, n);
  if (!((dist < T(0.0f)) && (vn < T(0.0f)))) return;   // inactive: no impulse
  T e_eff = sel(abs_(vn) > T(ldc(c + C_BOUNCE)), T(ldc(c + H_BB_E)), T(0.0f));
  T Pn = -(T(1.0f) + e_eff) * vn / T(ldc(c + H_BB_WN));
  V3<T> slip = v_rel;
  if (ldc(ca + C_KAPPA) > 0.0f || ldc(cb + C_KAPPA) > 0.0f) {
    const V3<T> zero3 = v3<T>(T(0.0f), T(0.0f), T(0.0f));
    V3<T> spa = ldc(ca + C_KAPPA) > 0.0f ? scale(cross(wa, n), ra) : zero3;
    V3<T> spb = ldc(cb + C_KAPPA) > 0.0f ? scale(cross(wb, n), rb) : zero3;
    slip = sub(v_rel, add(spa, spb));
  }
  V3<T> vt = sub(slip, scale(n, dot(slip, n)));
  T vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
  V3<T> t_hat = scale(vt, T(1.0f) / vt_n);
  T Pt = min_(T(ldc(c + H_BB_MU)) * Pn, vt_n / T(ldc(c + H_BB_WT)));
  V3<T> P = sub(scale(n, Pn), scale(t_hat, Pt));
  V3<T> dwdir = cross(n, t_hat);
  va = add(va, scale(P, T(ldc(ca + C_INV_MB))));
  vb = sub(vb, scale(P, T(ldc(cb + C_INV_MB))));
  wa = add(wa, scale(dwdir, T(ldc(ca + C_KAPPA_INVMB_OVER_RB)) * Pt));
  wb = add(wb, scale(dwdir, T(ldc(cb + C_KAPPA_INVMB_OVER_RB)) * Pt));
  T push = max_(-dist_now, T(0.0f));
  pa = add(pa, scale(n, T(0.5f) * push));
  pb = sub(pb, scale(n, T(0.5f) * push));
  sa = add(sa, P);
  sb = sub(sb, P);
  if (tqa) {
    V3<T> nxP = cross(n, P);
    *tqa = sub(*tqa, scale(nxP, ra));
    *tqb = sub(*tqb, scale(nxP, rb));
  }
}

// ---------------------------------------------------------- shared block --
constexpr int ART_CHUNK = 4;   // articulated geoms tested together

// The contacts' scratch.
template <class T, int ND, int K, int NB, bool WITH_TORQUE>
struct MultiContact {
  ArmContact<T, ND> arm[K];
  BallState<T> ball[NB];
  V3<T> geom_imp[MULTI_MAX_ART], geom_tq[WITH_TORQUE ? MULTI_MAX_ART : 1];
  // the ball-vs-art contact that acts: its depth and normal before the sweep
  V3<T> n_now;
  T d_now;
  // each art-vs-static pair's narrowphase: contact point, normal, depth and
  // whether it penetrates
  V3<T> pr_pt[MULTI_MAX_PAIRS], pr_n[MULTI_MAX_PAIRS];
  T pr_dist[MULTI_MAX_PAIRS];
  int pr_hit[MULTI_MAX_PAIRS];
  // the tests taken ahead: whether each static acts on each
  // ball in its current state and the static's moment term; whether each
  // articulated geom of a chunk acts, and its test's terms
  unsigned char st_act[NB][MULTI_MAX_STATIC], ga_act[ART_CHUNK];
  int st_next[NB];   // each ball's next static to take
  V3<T> st_m[WITH_TORQUE ? NB : 1][WITH_TORQUE ? MULTI_MAX_STATIC : 1];
  ArtTest<T, ND> at[ART_CHUNK];
  // the counting build: each static test's operations (its cull's, the
  // rest's) and each articulated geom test's, for ops_drop
  long long st_ops[COUNTS<T> ? NB : 1][COUNTS<T> ? MULTI_MAX_STATIC : 1][2];
  long long ga_ops[COUNTS<T> ? ART_CHUNK : 1];
};

// The shapes whose articulations run in tree_warp.cuh's blocked form, and
// its tables' capacity, factor entries an articulation (sum over its blocks
// of tri(DOFs)): <26, 2, 2>, C11's two 26-DOF G1s, 98 of them each. Every
// other shape keeps art_warp.cuh's dense form (0).
template <int ND, int K, int NB>
constexpr int TREE_CAP = 0;
template <>
constexpr int TREE_CAP<26, 2, 2> = 128;

// One env's block: each articulation's state, and the scratch (the
// dynamics' and the contacts' in one storage where T allows it, warp.cuh);
// with CAP (TREE_CAP) the tree-blocked forms of the state and the dynamics'
// scratch.
template <class T, int ND, int K, int NB, bool WITH_TORQUE>
struct MultiShared {
  static constexpr int CAP = TREE_CAP<ND, K, NB>;
  std::conditional_t<CAP == 0, ArmState<T, ND>, TreeState<T, ND, CAP>> arm[K];
  Overlay<std::conditional_t<CAP == 0, ArmsDyn<T, ND, K>, TreesDyn<T, ND, K, CAP>>,
          MultiContact<T, ND, K, NB, WITH_TORQUE>,
          std::is_trivially_default_constructible<T>::value> s;
};

// A contact's forward solves, its sum of squares and its back solve on
// articulation a (art_warp.cuh's, or tree_warp.cuh's on the contact's block).
template <class T, int ND, int K, class Sh>
IGT_HD void arm_solve(Sh& sh, const Lanes& w) {
  if constexpr (Sh::CAP > 0) tree_contact_solve<T, ND, K>(sh, w);
  else contact_solve<T, ND, K>(sh, w);
}
template <class T, int ND, class Sh>
IGT_HD T arm_sum_sq(const Sh& sh, int a, const T* sq) {
  if constexpr (Sh::CAP > 0) return tree_sum_sq<T, ND>(sh.arm[a], sq);
  else return sum_sq<T, ND>(sq);
}
template <class T, int ND, int K, class Sh>
IGT_HD void arm_back(Sh& sh, const Lanes& w) {
  if constexpr (Sh::CAP > 0) tree_contact_back<T, ND, K>(sh, w);
  else contact_back<T, ND, K>(sh, w);
}

// ---------------------------------------------------------------- contacts --
// Ball bi's flight and plane, from the inputs (K2's phase functions): its
// state, plane impulse and moment before the statics.
template <class T, int ND, int K, int NB, bool WITH_TORQUE>
IGT_HD void ball_flight_plane(const float* c, const float* x, int b, size_t sB, int bi,
                              BallState<T>& bs) {
#define IGT_IN(ch) T(x[(size_t)(ch) * sB + b])
  const float* cb = c + multi_ball_off(ND, K) + bi * BALL_STRIDE;
  const int ib = 4 * K * ND;
  V3<T> pos = v3<T>(IGT_IN(ib + 3 * bi), IGT_IN(ib + 3 * bi + 1), IGT_IN(ib + 3 * bi + 2));
  V3<T> vel = v3<T>(IGT_IN(ib + 3 * NB + 3 * bi), IGT_IN(ib + 3 * NB + 3 * bi + 1),
                    IGT_IN(ib + 3 * NB + 3 * bi + 2));
  V3<T> omg = v3<T>(IGT_IN(ib + 6 * NB + 3 * bi), IGT_IN(ib + 6 * NB + 3 * bi + 1),
                    IGT_IN(ib + 6 * NB + 3 * bi + 2));
  ball_flight(cb, T(ldc(cb + C_GX)), T(ldc(cb + C_GY)), T(ldc(cb + C_GZ)), vel, omg);
  const V3<T> dv0 = ball_plane(cb, pos, vel, omg);
  bs.s_imp = scale(dv0, T(ldc(cb + C_MB)));
  bs.tq = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  if constexpr (WITH_TORQUE) bs.tq = static_moment(cb, v3<T>(T(0.0f), T(0.0f), T(1.0f)), dv0);
  bs.pos = pos;
  bs.vel = vel;
  bs.omg = omg;
  bs.b_art = v3<T>(T(0.0f), T(0.0f), T(0.0f));
#undef IGT_IN
}

// Static si against ball bi in the state ``bs`` (ball_static's arithmetic
// on a copy): whether it acts and, with WITH_TORQUE, the moment term
// ball_static adds. ``far``: the static cannot act (no sweep sample
// penetrates), so the first sphere test gives the normal and the velocity
// change is zero: the sweep and the impulse are skipped.
template <class T, int ND, int K, bool WITH_TORQUE>
IGT_HD bool static_test(const float* c, int bi, int si, const BallState<T>& bs, bool far,
                        V3<T>& m) {
  const float* cb = c + multi_ball_off(ND, K) + bi * BALL_STRIDE;
  const float* g = c + multi_static_off(ND, K) + si * MULTI_STATIC_STRIDE;
  const int kind = (int)ldc(g + G_KIND);
  const float* R = g + G_ROT;
  const T rb = T(ldc(cb + C_RB)), z = T(0.0f);
  V3<T> pos = bs.pos, vel = bs.vel, omg = bs.omg;
  const V3<T> c0 = mat_t(R, sub(pos, cv3<T>(g + G_POS)));
  T dist;
  V3<T> n_l;
  sphere_geom(kind, g + G_SIZE, c0, rb, dist, n_l);
  bool act = false;
  V3<T> dv = v3<T>(z, z, z);
  if (!far) {
    const T d0 = dist;
    const V3<T> dv_l = mat_t(R, scale(vel, T(ldc(cb + C_DT_HALF))));
    sweep(kind, g + G_SIZE, rb, c0, dv_l, 2, dist, n_l);
    const V3<T> n = mat(R, n_l);
    act = (dist < z) && (dot(vel, n) < z);   // resolve_static's test
    dv = resolve_static(cb, vel, omg, pos, dist, n, T(ldc(g + G_EB + 2 * bi)),
                        T(ldc(g + G_MUB + 2 * bi)), d0);
    if constexpr (WITH_TORQUE) m = static_moment(cb, n, dv);
  } else if constexpr (WITH_TORQUE) {
    m = static_moment(cb, mat(R, n_l), dv);
  }
  return act;
}

// Ball bi against the statics in order, from static ``next``. Each static's
// test on the ball's current state is known (static_test, on a lane of its
// own): a static that does not act changes nothing but the impulse and
// moment sums, so the walk adds its terms (its zero velocity change over
// inv_m, its moment) and goes on; the first static that acts takes
// ball_static, which changes the state, and the walk stops there (``next``
// after it) for the later statics to be tested again. The counting build
// drops the work thrown away (``ops``: each test's cull and the rest): the
// acting static's test but its cull, and the later statics' tests.
template <class T, int ND, int K, int NB, bool WITH_TORQUE>
IGT_HD void statics_walk(const float* c, int bi, BallState<T>& bs, const unsigned char* st_act,
                         const V3<T>* st_m, const long long (*ops)[2], int& next) {
  const float* cb = c + multi_ball_off(ND, K) + bi * BALL_STRIDE;
  const T inv_mb = T(ldc(cb + C_INV_MB));
  const T z = T(0.0f) / inv_mb;   // dv / inv_m of a static that does not act
  const int n_static = (int)ldc(c + C_NSTATIC);
  int si = next;
  for (; si < n_static; ++si) {
    if (!st_act[si]) {
      bs.s_imp = v3<T>(bs.s_imp.x + z, bs.s_imp.y + z, bs.s_imp.z + z);
      if constexpr (WITH_TORQUE) bs.tq = add(bs.tq, st_m[si]);
      continue;
    }
    const float* g = c + multi_static_off(ND, K) + si * MULTI_STATIC_STRIDE;
    const V3<T> dv = ball_static(cb, g, T(ldc(g + G_EB + 2 * bi)), T(ldc(g + G_MUB + 2 * bi)),
                                 bs.pos, bs.vel, bs.omg, WITH_TORQUE ? &bs.tq : nullptr);
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

// Whether ball bi acts on each of the articulated geoms g0 .. g0 + ng - 1
// (ng <= ART_CHUNK) in the ball's and the articulations' current state: the
// arithmetic of the ball-vs-art contact up to its test, split over lanes (each geom's
// geometry, then one Jacobian column per lane, then each geom's point
// velocity and sweep samples, then one sample's sphere test per lane, then
// each geom's first penetrating sample and the test) -> ct.ga_act; the
// counting build also gathers each geom's operations in ct.ga_ops.
template <class T, int ND, int K, class Sh>
IGT_HD void ball_art_tests(const float* c, int bi, int g0, int ng, Sh& sh, const Lanes& w) {
  auto& ct = sh.s.ct;
  const float* cb = c + multi_ball_off(ND, K) + bi * BALL_STRIDE;
  const auto arm_of = [c](int gi) {
    int a = 0;
    while (a < K - 1 && gi >= (int)ldc(c + MULTI_HEAD + a * multi_art_stride(ND) + C_GEOM_HI)) ++a;
    return a;
  };
  const auto geom = [c, g0](int k) { return c + multi_art_off(ND, K) + (g0 + k) * MULTI_ART_STRIDE; };
  const auto art = [c](int a) { return c + MULTI_HEAD + a * multi_art_stride(ND); };
  // the cull: the contact point's speed is at most sum |u_i| (|pos - fp_i| +
  // r) over the DOFs, so the sweep reaches at most (|vel| + that) dt
  each(w, [=, &sh, &ct](int lane) {
    if (lane >= ng) return;
    const long long o = ops_now(T());
    const int a = arm_of(g0 + lane);
    const float* g = geom(lane);
    const auto& ar = sh.arm[a];
    const V3<T> pos = ct.ball[bi].pos, vel = ct.ball[bi].vel;
    const T rb = T(ldc(cb + C_RB));
    T vb = T(0.0f);
    const auto reach = [&](int i, bool rev) {
      const V3<T> d = sub(pos, ar.fp[i]);
      vb = vb + abs_(ar.u[i]) * (rev ? sqrt_(dot(d, d)) + rb : T(1.0f));
    };
    if constexpr (Sh::CAP > 0) {   // the DOFs that move the geom's link
      for (unsigned anc = tree_anc(ar.tr, (int)ldc(g + A_LINK)); anc; anc &= anc - 1u)
        reach(low_bit(anc), ar.tr.rev >> low_bit(anc) & 1u);
    } else {
      for (int i = 0; i < ND; ++i) reach(i, dof_rev(art(a), i));
    }
    V3<T> lp;
    Q4<T> lq;
    link_frame<T, ND>(art(a), ar, (int)ldc(g + A_LINK), lp, lq);
    const V3<T> d = sub(pos, add(lp, qrot(lq, cv3<T>(g + A_OFF_POS))));
    ct.at[lane].near = !apart(sqrt_(dot(d, d)), hull_radius<T>((int)ldc(g + A_KIND), g + A_SIZE),
                              rb, (sqrt_(dot(vel, vel)) + vb) * T(4.0f) * T(ldc(cb + C_DT_QUARTER)));
    ct.ga_act[lane] = 0;
    if constexpr (COUNTS<T>) ct.ga_ops[lane] = ops_now(T()) - o;
  });
  bool any = false;
  for (int k = 0; k < ng; ++k) any = any || ct.at[k].near;
  if (!any) return;
  each(w, [=, &sh, &ct](int lane) {
    if (lane >= ng || !ct.at[lane].near) return;
    const long long o = ops_now(T());
    const int a = arm_of(g0 + lane);
    const float* g = geom(lane);
    auto& at = ct.at[lane];
    const V3<T> pos = ct.ball[bi].pos;
    const T rb = T(ldc(cb + C_RB));
    V3<T> lp;
    Q4<T> lq;
    link_frame<T, ND>(art(a), sh.arm[a], (int)ldc(g + A_LINK), lp, lq);
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
    if constexpr (COUNTS<T>) ct.ga_ops[lane] += ops_now(T()) - o;
  });
  each(w, [=, &sh, &ct](int lane) {
    if constexpr (Sh::CAP > 0) {
      // the tree form: the chunk's (geom, ancestor of its link) pairs, a lane
      // each; a column off the ancestors is zero and never read
      for (int t = lane;; t += WARP) {
        int k = 0, m = t;
        unsigned anc = 0u;
        for (; k < ng; ++k) {
          anc = tree_anc(sh.arm[arm_of(g0 + k)].tr, (int)ldc(geom(k) + A_LINK));
          if (m < pop_count(anc)) break;
          m -= pop_count(anc);
        }
        if (k == ng) break;
        auto& at = ct.at[k];
        if (!at.near) continue;
        const long long o = ops_now(T());
        for (; m > 0; --m) anc &= anc - 1u;
        const int i = low_bit(anc), a = arm_of(g0 + k);
        const auto& ar = sh.arm[a];
        const V3<T> col = ar.tr.rev >> i & 1u ? cross(ar.axw[i], sub(at.cp, ar.fp[i])) : ar.axw[i];
        at.Jc[i] = col;
        at.on[i] = 1;
        at.cu[i] = scale(col, ar.u[i]);
        if constexpr (COUNTS<T>) ct.ga_ops[k] += ops_now(T()) - o;
      }
    } else {
      for (int t = lane; t < ng * ND; t += WARP) {
        const int k = t / ND, i = t % ND, a = arm_of(g0 + k);
        const float* ca = art(a);
        auto& at = ct.at[k];
        if (!at.near) continue;
        const long long o = ops_now(T());
        bool on;
        const V3<T> col = jac_col<T, ND>(ca, ca + mask_off(ND), (int)ldc(geom(k) + A_LINK), i,
                                         at.cp, sh.arm[a].fp, sh.arm[a].axw, on);
        at.Jc[i] = col;
        at.on[i] = on;
        if (on) at.cu[i] = scale(col, sh.arm[a].u[i]);
        if constexpr (COUNTS<T>) ct.ga_ops[k] += ops_now(T()) - o;
      }
    }
  });
  each(w, [=, &sh, &ct](int lane) {
    if (lane >= ng || !ct.at[lane].near) return;
    const long long o = ops_now(T());
    auto& at = ct.at[lane];
    V3<T> v_point = v3<T>(T(0.0f), T(0.0f), T(0.0f));
    if constexpr (Sh::CAP > 0) {
      for (unsigned anc = tree_anc(sh.arm[arm_of(g0 + lane)].tr, (int)ldc(geom(lane) + A_LINK));
           anc; anc &= anc - 1u)
        v_point = add(v_point, at.cu[low_bit(anc)]);
    } else {
      for (int i = 0; i < ND; ++i)
        if (at.on[i]) v_point = add(v_point, at.cu[i]);
    }
    at.v_rel = sub(ct.ball[bi].vel, v_point);
    const V3<T> dv_l = qrot(conj(at.gq), scale(at.v_rel, T(ldc(cb + C_DT_QUARTER))));
    V3<T> ck = at.c0;
    for (int m = 0; m < SWEEP_ART; ++m) {
      ck = add(ck, dv_l);
      at.ck[m] = ck;
    }
    if constexpr (COUNTS<T>) ct.ga_ops[lane] += ops_now(T()) - o;
  });
  each(w, [=, &ct](int lane) {
    if (lane >= ng * SWEEP_ART || !ct.at[lane / SWEEP_ART].near) return;
    const long long o = ops_now(T());
    auto& at = ct.at[lane / SWEEP_ART];
    const int m = lane % SWEEP_ART;
    const float* g = geom(lane / SWEEP_ART);
    sphere_geom((int)ldc(g + A_KIND), g + A_SIZE, at.ck[m], T(ldc(cb + C_RB)), at.dk[m], at.nk[m]);
    if constexpr (COUNTS<T>) ct.ga_ops[lane / SWEEP_ART] += ops_now(T()) - o;
  });
  each(w, [=, &ct](int lane) {
    if (lane >= ng || !ct.at[lane].near) return;
    const long long o = ops_now(T());
    auto& at = ct.at[lane];
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
    ct.ga_act[lane] = (dist < T(0.0f)) && (at.vn < T(0.0f));
    if constexpr (COUNTS<T>) ct.ga_ops[lane] += ops_now(T()) - o;
  });
}

// An acting ball-vs-art contact's restitution, tangent and slip speed, from
// the relative velocity v_rel, the swept normal n and vn = v_rel . n
// (the ball-vs-art contact after its test), into the articulation's contact
// ``ac``.
template <class T, int ND>
IGT_HD void ball_art_dirs(const float* cb, const float* g, int bi, const BallState<T>& bs,
                          V3<T> v_rel, V3<T> n, T vn, ArmContact<T, ND>& ac) {
  const T rb = T(ldc(cb + C_RB));
  ac.e_eff = sel(abs_(vn) > T(ldc(cb + C_BOUNCE)), T(ldc(g + A_EB + 2 * bi)), T(0.0f));
  const V3<T> slip = ldc(cb + C_KAPPA) > 0.0f ? sub(v_rel, scale(cross(bs.omg, n), rb)) : v_rel;
  const V3<T> vt = sub(slip, scale(n, dot(slip, n)));
  ac.vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
  ac.t_hat = scale(vt, T(1.0f) / ac.vt_n);
  ac.n = n;
  ac.vn = vn;
}

// The reaction of an acting contact of ball bi with articulated geom gi of
// articulation a (the ball-vs-art contact after its test; ct.d_now, ct.n_now and the
// articulation's contact set): the solves, the impulse, the ball's change,
// the rows, the joint-space reaction. The impulse joins the ball's b_art
// row, its reaction the geom's row; with WITH_TORQUE its moments join the
// ball's and the geom body's.
template <class T, int ND, int K, bool WITH_TORQUE, class Sh>
IGT_HD void ball_art_react(const float* c, int a, int gi, int bi, Sh& sh, const Lanes& w) {
  auto& ct = sh.s.ct;
  const float* ca = c + MULTI_HEAD + a * multi_art_stride(ND);
  const float* cb = c + multi_ball_off(ND, K) + bi * BALL_STRIDE;
  const float* g = c + multi_art_off(ND, K) + gi * MULTI_ART_STRIDE;
  arm_solve<T, ND, K>(sh, w);
  each(w, [=, &sh, &ct](int lane) {
    if (lane != a * (WARP / K)) return;
    auto& ac = ct.arm[a];
    auto& bs = ct.ball[bi];
    const T rb = T(ldc(cb + C_RB)), inv_mb = T(ldc(cb + C_INV_MB));
    const T Pn = -(T(1.0f) + ac.e_eff) * ac.vn / (inv_mb + arm_sum_sq<T, ND>(sh, a, ac.sqn));
    const T w_t = T(ldc(cb + C_WT0)) + arm_sum_sq<T, ND>(sh, a, ac.sqt);
    const T Pt = min_(T(ldc(g + A_MUB + 2 * bi)) * Pn, ac.vt_n / w_t);
    const V3<T> n = ac.n, t_hat = ac.t_hat;
    const V3<T> P = sub(scale(n, Pn), scale(t_hat, Pt));
    bs.vel = add(bs.vel, scale(P, inv_mb));
    bs.omg = add(bs.omg, scale(cross(n, t_hat), T(ldc(cb + C_KAPPA_INVMB_OVER_RB)) * Pt));
    ac.an = -Pn;
    ac.at = Pt;
    ac.minus = 0;
    bs.pos = add(bs.pos, scale(n, max_(-ct.d_now, T(0.0f))));
    if constexpr (WITH_TORQUE) {
      bs.tq = add(bs.tq, scale(cross(ct.n_now, P), -rb));
      V3<T> lp;
      Q4<T> lq;
      link_frame<T, ND>(ca, sh.arm[a], (int)ldc(g + A_LINK), lp, lq);
      const V3<T> borg = add(lp, qrot(lq, cv3<T>(g + A_BODY_OFF)));
      ct.geom_tq[gi] = add(ct.geom_tq[gi], cross(sub(ac.pt, borg), scale(P, T(-1.0f))));
    }
    ct.geom_imp[gi] = sub(ct.geom_imp[gi], P);
    bs.b_art = add(bs.b_art, P);
  });
  arm_back<T, ND, K>(sh, w);
}

// Ball bi against articulated geom gi = g0 + k of articulation a, which
// ball_art_tests found acting (test k of its chunk): the test's geometry,
// columns, swept normal and normal velocity become the contact's, then
// ball_art_react.
template <class T, int ND, int K, bool WITH_TORQUE, class Sh>
IGT_HD void ball_art_take(const float* c, int a, int gi, int bi, int k, Sh& sh, const Lanes& w) {
  constexpr int HW = WARP / K;
  auto& ct = sh.s.ct;
  const float* cb = c + multi_ball_off(ND, K) + bi * BALL_STRIDE;
  const float* g = c + multi_art_off(ND, K) + gi * MULTI_ART_STRIDE;
  each_arm<K>(w, [=, &sh, &ct](int a2, int s) {
    const auto& at = ct.at[k];
    auto& ac = ct.arm[a2];
    if (s == 0) ac.act = a2 == a;
    if (a2 != a) return;
    if constexpr (Sh::CAP > 0) {   // the columns of the link's block
      auto& ar = sh.arm[a];
      const int link = (int)ldc(g + A_LINK), bk = tree_blk(ar.tr, link);
      const unsigned anc = tree_anc(ar.tr, link);
      if (s == 0) ar.cb = bk;
      for (int m = bk < 0 ? 0 : ar.tr.bs[bk] + s; bk >= 0 && m < ar.tr.bs[bk + 1]; m += HW) {
        const int i = ar.tr.bm[m];
        ac.on[i] = anc >> i & 1u;
        if (ac.on[i]) ac.Jc[i] = at.Jc[i];
      }
    } else {
      for (int i = s; i < ND; i += HW) {
        ac.Jc[i] = at.Jc[i];
        ac.on[i] = at.on[i];
      }
    }
    if (s != 0) return;
    ct.d_now = at.d_now;
    ct.n_now = at.n_now;
    ac.pt = at.cp;
    ball_art_dirs<T, ND>(cb, g, bi, ct.ball[bi], at.v_rel, at.n, at.vn, ac);
  });
  ball_art_react<T, ND, K, WITH_TORQUE>(c, a, gi, bi, sh, w);
}

// Round p of the art-vs-static pairs: articulation a's p-th
// pair, where its narrowphase penetrates (``hit[a]``), on a's lanes, all
// articulations at once. The impulse joins the geom's row; with WITH_TORQUE
// its moment about the geom body's frame origin joins the geom's moment row.
template <class T, int ND, int K, bool WITH_TORQUE, class Sh>
IGT_HD void pair_round(const float* c, const int* plo, const bool* hit, int p, Sh& sh,
                       const Lanes& w) {
  constexpr int HW = WARP / K;
  auto& ct = sh.s.ct;
  bool h[K];
  int lo[K];
  for (int a = 0; a < K; ++a) {
    h[a] = hit[a];
    lo[a] = plo[a];
  }
  const auto pair = [=](int a) { return c + multi_pair_off(ND, K) + (lo[a] + p) * PAIR_STRIDE; };
  const auto geom = [=](int a) {
    return c + multi_art_off(ND, K) + (int)ldc(pair(a) + P_ART) * MULTI_ART_STRIDE;
  };
  const auto art = [c](int a) { return c + MULTI_HEAD + a * multi_art_stride(ND); };
  each_arm<K>(w, [=, &sh, &ct](int a, int s) {
    if (!h[a]) return;
    if constexpr (Sh::CAP > 0)
      tree_contact_cols<T, ND, HW>(sh.arm[a], ct.arm[a], ct.pr_pt[lo[a] + p],
                                   (int)ldc(geom(a) + A_LINK), s);
    else
      contact_cols<T, ND, HW>(art(a), sh.arm[a], ct.arm[a], ct.pr_pt[lo[a] + p],
                              (int)ldc(geom(a) + A_LINK), s);
  });
  each_arm<K>(w, [=, &sh, &ct](int a, int s) {
    if (s != 0) return;
    auto& ac = ct.arm[a];
    ac.act = 0;
    if (!h[a]) return;
    const float* ca = art(a);
    const int pi = lo[a] + p;
    const V3<T> n = ct.pr_n[pi];
    V3<T> v_point;
    if constexpr (Sh::CAP > 0) v_point = tree_point_velocity<T, ND>(sh.arm[a], ac);
    else v_point = point_velocity<T, ND>(ac);
    const T vn = dot(v_point, n);
    if (!(vn < T(0.1f))) return;   // separating: no impulse
    ac.act = 1;
    const T bounce = T(ldc(ca + C_BOUNCE));
    ac.bias = min_(T(ldc(ca + C_BIAS_K)) * max_(-ct.pr_dist[pi] - T(0.005f), T(0.0f)),
                   T(ldc(ca + C_MAX_DEPEN)));
    ac.e_eff = sel(abs_(vn) > bounce, T(ldc(pair(a) + P_E)), T(0.0f));
    const V3<T> vt = sub(v_point, scale(n, vn));
    ac.vt_n = sqrt_floor(dot(vt, vt), 1e-18f);
    ac.t_hat = scale(vt, T(1.0f) / ac.vt_n);
    ac.n = n;
    ac.vn = vn;
  });
  bool acts = false;
  for (int a = 0; a < K; ++a) acts = acts || ct.arm[a].act;
  if (!acts) return;
  arm_solve<T, ND, K>(sh, w);
  each_arm<K>(w, [=, &sh, &ct](int a, int s) {
    auto& ac = ct.arm[a];
    if (!ac.act || s != 0) return;
    const float* ca = art(a);
    const float* pr = pair(a);
    const int pi = lo[a] + p, gi = (int)ldc(pr + P_ART);
    const T bounce = T(ldc(ca + C_BOUNCE)), dist = ct.pr_dist[pi];
    T Pn = (-(T(1.0f) + ac.e_eff) * min_(ac.vn, T(0.0f)) + ac.bias)
        / max_(arm_sum_sq<T, ND>(sh, a, ac.sqn), T(1e-9f));
    T Pt = min_(T(ldc(pr + P_MU)) * Pn,
                ac.vt_n / max_(arm_sum_sq<T, ND>(sh, a, ac.sqt), T(1e-9f)));
    // resting-contact band: ramp the impulse over the first 2 mm
    const T s_r = sel(abs_(ac.vn) > bounce, T(1.0f), clip_(-dist / T(0.002f), T(0.0f), T(1.0f)));
    Pn = Pn * s_r;
    Pt = Pt * s_r;
    ac.an = Pn;
    ac.at = Pt;
    ac.minus = 1;
    const V3<T> P = sub(scale(ac.n, Pn), scale(ac.t_hat, Pt));
    ct.geom_imp[gi] = add(ct.geom_imp[gi], P);
    if constexpr (WITH_TORQUE) {
      V3<T> lp;
      Q4<T> lq;
      link_frame<T, ND>(ca, sh.arm[a], (int)ldc(geom(a) + A_LINK), lp, lq);
      ct.geom_tq[gi] = add(ct.geom_tq[gi],
                           cross(sub(ct.pr_pt[pi], add(lp, qrot(lq, cv3<T>(geom(a) + A_BODY_OFF)))), P));
    }
  });
  arm_back<T, ND, K>(sh, w);
}

// ------------------------------------------------------------- the body --
// One env's K3 substep, run by the warp ``w`` with the env's block ``sh``.
// x: (multi_n_in(K ND, NB), B) inputs, y: (3 K ND + 9 NB + 3 (ng + 2 NB)
// [+ 3 (ng + NB) with WITH_TORQUE], B) outputs, both channel-major; env b
// reads and writes column b.
template <class T, int ND, int K, int NB, bool WITH_TORQUE = false>
IGT_HD void fused_substep_multi_env(const float* __restrict__ c, const float* __restrict__ x,
                                    float* __restrict__ y, int b, int B,
                                    MultiShared<T, ND, K, NB, WITH_TORQUE>& sh, const Lanes& w) {
  static_assert(NB >= 1 && NB <= MAX_BALLS, "1 or 2 balls");
  static_assert(MULTI_MAX_PAIRS <= WARP && NB < WARP, "a lane for each pair and each ball");
  constexpr int NDT = K * ND;
  const size_t sB = (size_t)B;
#define IGT_OUT(ch, v) (y[(size_t)(ch) * sB + b] = to_f(v))
  const auto art = [c](int a) { return c + MULTI_HEAD + a * multi_art_stride(ND); };
  const ArmRows<ND> rows{x, y, b, sB, NDT};
  if constexpr (MultiShared<T, ND, K, NB, WITH_TORQUE>::CAP > 0) {
    constexpr int CAP = MultiShared<T, ND, K, NB, WITH_TORQUE>::CAP;
    if (!tree_dynamics<T, ND, K, CAP>(art, rows, sh, w)) {
      // a tree whose blocks need more than CAP factor entries: NaN out
      const int n_out = 3 * NDT + 9 * NB + 3 * ((int)ldc(c + C_NART) + 2 * NB)
                        + (WITH_TORQUE ? 3 * ((int)ldc(c + C_NART) + NB) : 0);
      each(w, [=](int lane) {
        for (int ch = lane; ch < n_out; ch += WARP) IGT_OUT(ch, T(NAN));
      });
      return;
    }
  } else {
    arms_dynamics<T, ND, K>(art, rows, sh, w);
  }

  auto& ct = sh.s.ct;
  const int ng = (int)ldc(c + C_NART);
  int plo[K], rounds = 0;
  for (int a = 0; a < K; ++a) {
    plo[a] = (int)ldc(art(a) + C_PAIR_LO);
    const int n = (int)ldc(art(a) + C_PAIR_HI) - plo[a];
    rounds = n > rounds ? n : rounds;
  }

  // each ball's flight and plane (lanes 31, 30); the impulse rows cleared;
  // every pair's narrowphase (lane pi)
  each(w, [=, &sh, &ct](int lane) {
    for (int bi = 0; bi < NB; ++bi) {
      if (lane != WARP - 1 - bi) continue;
      ball_flight_plane<T, ND, K, NB, WITH_TORQUE>(c, x, b, sB, bi, ct.ball[bi]);
      ct.st_next[bi] = 0;
    }
    for (int gi = lane; gi < ng; gi += WARP) {
      ct.geom_imp[gi] = v3<T>(T(0.0f), T(0.0f), T(0.0f));
      if constexpr (WITH_TORQUE) ct.geom_tq[gi] = ct.geom_imp[gi];
    }
    for (int a = 0; a < K; ++a) {
      const int pi = lane;
      if (pi < (int)ldc(art(a) + C_PAIR_LO) || pi >= (int)ldc(art(a) + C_PAIR_HI)) continue;
      const float* pr = c + multi_pair_off(ND, K) + pi * PAIR_STRIDE;
      const float* g = c + multi_art_off(ND, K) + (int)ldc(pr + P_ART) * MULTI_ART_STRIDE;
      const float* sg = c + multi_static_off(ND, K) + (int)ldc(pr + P_STATIC) * MULTI_STATIC_STRIDE;
      V3<T> lp;   // a geom whose hull clears the static's cannot act
      Q4<T> lq;
      link_frame<T, ND>(art(a), sh.arm[a], (int)ldc(g + A_LINK), lp, lq);
      const V3<T> d = sub(add(lp, qrot(lq, cv3<T>(g + A_OFF_POS))), cv3<T>(sg + G_POS));
      if (apart(sqrt_(dot(d, d)), hull_radius<T>((int)ldc(sg + G_KIND), sg + G_SIZE),
                hull_radius<T>((int)ldc(g + A_KIND), g + A_SIZE), T(0.0f))) {
        ct.pr_hit[pi] = 0;
        continue;
      }
      pair_narrowphase<T, ND>(art(a), sh.arm[a], pr, g, sg, ct.pr_pt[pi], ct.pr_n[pi],
                              ct.pr_dist[pi]);
      ct.pr_hit[pi] = ct.pr_dist[pi] < T(0.0f);
    }
  });
  // the statics in order: each (ball, static) from each ball's next static
  // on is tested on a lane of its own against the ball's current state, then
  // each ball's lane walks them up to the first that acts (statics_walk),
  // until every ball has taken every static
  const int n_static = (int)ldc(c + C_NSTATIC);
  for (;;) {
    bool more = false;
    for (int bi = 0; bi < NB; ++bi) more = more || ct.st_next[bi] < n_static;
    if (!more) break;
    each(w, [=, &ct](int lane) {
      for (int t = lane; t < NB * n_static; t += WARP) {
        const int bi = t / n_static, si = t % n_static;
        if (si < ct.st_next[bi]) continue;
        const long long o = ops_now(T());
        const float* cb = c + multi_ball_off(ND, K) + bi * BALL_STRIDE;
        const float* g = c + multi_static_off(ND, K) + si * MULTI_STATIC_STRIDE;
        const auto& bs = ct.ball[bi];
        const V3<T> d = sub(bs.pos, cv3<T>(g + G_POS));
        const bool far = apart(sqrt_(dot(d, d)), hull_radius<T>((int)ldc(g + G_KIND), g + G_SIZE),
                               T(ldc(cb + C_RB)), sqrt_(dot(bs.vel, bs.vel)) * T(ldc(cb + C_DT)));
        const long long o_cull = ops_now(T());
        ct.st_act[bi][si] = 0;
        if (WITH_TORQUE || !far) {   // K3-tau still needs a far static's moment term
          V3<T> m;
          ct.st_act[bi][si] = static_test<T, ND, K, WITH_TORQUE>(c, bi, si, bs, far, m);
          if constexpr (WITH_TORQUE) ct.st_m[bi][si] = m;
        }
        if constexpr (COUNTS<T>) {
          ct.st_ops[bi][si][0] = o_cull - o;
          ct.st_ops[bi][si][1] = ops_now(T()) - o_cull;
        }
      }
    });
    each(w, [=, &ct](int lane) {
      for (int bi = 0; bi < NB; ++bi)
        if (lane == WARP - 1 - bi && ct.st_next[bi] < n_static)
          statics_walk<T, ND, K, NB, WITH_TORQUE>(c, bi, ct.ball[bi], ct.st_act[bi],
                                                   ct.st_m[WITH_TORQUE ? bi : 0],
                                                   ct.st_ops[COUNTS<T> ? bi : 0], ct.st_next[bi]);
    });
  }

  // each ball against every articulated geom of every articulation, in
  // order: the geoms from the next one on are tested a chunk at a time
  // (ball_art_tests) against the current state. A geom that does not act
  // changes nothing; the first that acts takes its reaction (ball_art_take),
  // which changes the state, and the geoms after it are tested again (the
  // counting build drops their first tests).
  const auto arm_of = [=](int gi) {
    int a = 0;
    while (a < K - 1 && gi >= (int)ldc(art(a) + C_GEOM_HI)) ++a;
    return a;
  };
  for (int bi = 0; bi < NB; ++bi) {
    for (int next = 0; next < ng;) {
      const int n = ng - next < ART_CHUNK ? ng - next : ART_CHUNK;
      sync(w);   // every lane has read the last tests
      ball_art_tests<T, ND, K>(c, bi, next, n, sh, w);
      int k = 0;
      while (k < n && !ct.ga_act[k]) ++k;
      if constexpr (COUNTS<T>)
        for (int j = k + 1; j < n; ++j) ops_drop(T(), ct.ga_ops[j]);
      if (k < n) ball_art_take<T, ND, K, WITH_TORQUE>(c, arm_of(next + k), next + k, bi, k, sh, w);
      next += k < n ? k + 1 : n;
    }
  }

  if constexpr (NB == 2) {
    one(w, [=, &ct]() {
      const float* c0 = c + multi_ball_off(ND, K);
      auto &b0 = ct.ball[0], &b1 = ct.ball[1];
      ball_pair(c, c0, c0 + BALL_STRIDE, b0.pos, b0.vel, b0.omg, b0.s_imp, b1.pos, b1.vel,
                b1.omg, b1.s_imp, WITH_TORQUE ? &b0.tq : nullptr, WITH_TORQUE ? &b1.tq : nullptr);
    });
  }

  // articulated geoms vs the true statics: pairs pruned at pack time
  for (int p = 0; p < rounds; ++p) {
    bool hit[K], any = false;
    for (int a = 0; a < K; ++a) {
      hit[a] = p < (int)ldc(art(a) + C_PAIR_HI) - plo[a] && ct.pr_hit[plo[a] + p];
      any = any || hit[a];
    }
    if (any) pair_round<T, ND, K, WITH_TORQUE>(c, plo, hit, p, sh, w);
  }

  // outputs: qd, the impulse rows (and moment rows); each ball capped and
  // integrated on its own lane
  each(w, [=, &sh, &ct](int lane) {
    const int io = 3 * NDT + 9 * NB;
    for (int ch = lane; ch < NDT; ch += WARP) IGT_OUT(NDT + ch, sh.arm[ch / ND].u[ch % ND]);
    for (int gi = lane; gi < ng; gi += WARP) {
      const V3<T> p = ct.geom_imp[gi];
      IGT_OUT(io + 3 * gi, p.x); IGT_OUT(io + 3 * gi + 1, p.y); IGT_OUT(io + 3 * gi + 2, p.z);
      if constexpr (WITH_TORQUE) {
        const int rt = io + 3 * (ng + 2 * NB + gi);
        const V3<T> tq = ct.geom_tq[gi];
        IGT_OUT(rt, tq.x); IGT_OUT(rt + 1, tq.y); IGT_OUT(rt + 2, tq.z);
      }
    }
    for (int bi = 0; bi < NB; ++bi) {
      if (lane != WARP - 1 - bi) continue;
      const BallState<T>& bs = ct.ball[bi];
      V3<T> pos = bs.pos, vel = bs.vel, omg = bs.omg;
      ball_finish(c + multi_ball_off(ND, K) + bi * BALL_STRIDE, pos, vel, omg);
      const int o = 3 * NDT + 3 * bi;
      IGT_OUT(o, pos.x); IGT_OUT(o + 1, pos.y); IGT_OUT(o + 2, pos.z);
      IGT_OUT(o + 3 * NB, vel.x); IGT_OUT(o + 3 * NB + 1, vel.y); IGT_OUT(o + 3 * NB + 2, vel.z);
      IGT_OUT(o + 6 * NB, omg.x); IGT_OUT(o + 6 * NB + 1, omg.y); IGT_OUT(o + 6 * NB + 2, omg.z);
      const int rs = io + 3 * (ng + bi), ra = io + 3 * (ng + NB + bi);
      IGT_OUT(rs, bs.s_imp.x); IGT_OUT(rs + 1, bs.s_imp.y); IGT_OUT(rs + 2, bs.s_imp.z);
      IGT_OUT(ra, bs.b_art.x); IGT_OUT(ra + 1, bs.b_art.y); IGT_OUT(ra + 2, bs.b_art.z);
      if constexpr (WITH_TORQUE) {   // ball moment rows after the geom moment rows
        const int rt = io + 3 * (2 * ng + 2 * NB + bi);
        IGT_OUT(rt, bs.tq.x); IGT_OUT(rt + 1, bs.tq.y); IGT_OUT(rt + 2, bs.tq.z);
      }
    }
  });
#undef IGT_OUT
}

}  // namespace igt
