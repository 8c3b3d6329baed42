// The tree-blocked form of art_warp.cuh's fixed-base dynamics and of a
// contact's joint-space solves, for K articulations side by side in one warp.
// K3 and K3-tau take it at <26, 2, 2> (C11's two 26-DOF G1s), where
// fused_substep_multi.cuh's TREE_CAP selects it; every other build keeps the
// dense form.
//
// A fixed base's tree splits into the subtrees that hang from the base: the
// G1's 26 DOFs into two legs of 6 and two arms of 7, C8's 7-DOF arm into one.
// No link lies below two of them, so no entry of M between two of them has a
// link to sum over, and neither has the factor: each subtree is a block of M
// that factors and solves on its own. The blocks are derived at each launch
// from the ancestor mask (tree_link, tree_blocks), not fixed per model. Then:
//   - the FK walks run a lane per block, a chain's parent frame in registers;
//   - each link's active columns (its ancestors) J_li and I_l axw_i are kept
//     for those columns only, link l's at joff[l], its ancestor i at
//     joff[l] + na[i] - 1 (i's own ancestors are the ones before it);
//   - M and its factor are kept block by block, block b's packed lower
//     triangle at lbase[b] (entry (i, j) at lbase + tri(pos i) + pos j): 98
//     entries for the G1 where the dense form holds 351, and the J and I axw
//     tables 98 columns where it holds 676;
//   - each entry of a block's M sums its links on a lane of its own;
//   - the blocks factor side by side, a phase per column of the largest
//     block (6 for the G1, not 25), and back-solve on a lane each;
//   - a contact's columns, solves and sums run on its link's block alone.
// What the dense form computes beyond this is M and factor entries that are
// exactly +0 and their products: x - 0 y is x (it turns a -0 into +0 only),
// so every value is the dense form's, with every kept sum in its order: the
// outputs are the same bits unless a sum passes through -0.
#pragma once

#include "art_warp.cuh"
#include "warp.cuh"

namespace igt {

// ------------------------------------------------------------- the blocks --
// An articulation's tree: per link its ancestors (itself included), and the
// blocks, each a subtree of the base, with its DOFs in ascending order.
template <int ND>
struct Tree {
  static_assert(ND <= 32, "a link's ancestors are the bits of one word");
  unsigned cbits[ND];                   // per link: its ancestors, a bit each
  unsigned char na[ND];                 // and how many
  unsigned char blk[ND], pos[ND];       // per DOF: its block, its place there
  unsigned char bm[ND], bs[ND + 1];     // block b's DOFs: bm[bs[b]] .. bm[bs[b + 1] - 1]
  unsigned short lbase[ND], joff[ND];   // block b's factor at L[lbase[b]]; link l's columns
  unsigned rev;                         // the revolute DOFs, a bit each
  int nblk, nent, ncol, wide;           // blocks, factor entries, active columns, largest block
};

// Link l's ancestors from the mask of the articulation's block c.
template <int ND>
IGT_HD void tree_link(const float* c, Tree<ND>& tr, int l) {
  const float* mask = c + mask_off(ND);
  unsigned bits = 0;
  for (int i = 0; i < ND; ++i)
    if (ldc(mask + l * ND + i) != 0.0f) bits |= 1u << i;
  tr.cbits[l] = bits;
  tr.na[l] = (unsigned char)pop_count(bits);
}

// The blocks, from every link's ancestors (tree_link): a DOF with no
// ancestor but itself starts a block, any other joins the block of its
// lowest ancestor, the subtree's root. Then the blocks' offsets, each
// link's columns', the counts and (from the block c) the revolute DOFs.
template <int ND>
IGT_HD void tree_blocks(const float* c, Tree<ND>& tr) {
  int nblk = 0;
  tr.rev = 0u;
  for (int d = 0; d < ND; ++d) tr.rev |= (unsigned)dof_rev(c, d) << d;
  for (int b = 0; b <= ND; ++b) tr.bs[b] = 0;
  for (int d = 0; d < ND; ++d) {
    const unsigned c = tr.cbits[d] & ((1u << d) - 1u);   // its proper ancestors
    const int b = c == 0u ? nblk++ : tr.blk[low_bit(c)];
    tr.blk[d] = (unsigned char)b;
    tr.pos[d] = tr.bs[b + 1]++;
  }
  int ent = 0, wide = 0, col = 0;
  for (int b = 0; b < nblk; ++b) {
    const int n = tr.bs[b + 1];
    tr.lbase[b] = (unsigned short)ent;
    ent += tri(n);
    wide = n > wide ? n : wide;
    tr.bs[b + 1] = (unsigned char)(tr.bs[b] + n);
  }
  for (int d = 0; d < ND; ++d) {
    tr.bm[tr.bs[tr.blk[d]] + tr.pos[d]] = (unsigned char)d;
    tr.joff[d] = (unsigned short)col;
    col += tr.na[d];
  }
  tr.nblk = nblk;
  tr.nent = ent;
  tr.ncol = col;
  tr.wide = wide;
}

// The DOFs a contact on ``link`` moves (its ancestors), and the block they lie
// in: none for a link off the articulation (link_frame's base).
template <int ND>
IGT_HD unsigned tree_anc(const Tree<ND>& tr, int link) {
  return link >= 0 && link < ND ? tr.cbits[link] : 0u;
}
template <int ND>
IGT_HD int tree_blk(const Tree<ND>& tr, int link) {
  return link >= 0 && link < ND ? (int)tr.blk[link] : -1;
}

// ------------------------------------------------------------ shared state --
// One articulation's state through the substep (ArmState's, with the factor
// block by block, CAP entries at most), its tree, and the block of the
// contact being solved (-1: none).
template <class T, int ND, int CAP>
struct TreeState {
  T L[CAP];
  T u[ND], q[ND], tau[ND], sn[ND], cs[ND];
  V3<T> fp[ND], axw[ND];
  Q4<T> fq[ND];
  Tree<ND> tr;
  int cb;
};

// Its dynamics' scratch (ArmDyn's, with the active columns only, and each
// factor entry's row and column).
template <class T, int ND, int CAP>
struct TreeDyn {
  T rhs[ND], y[ND], qdd[ND], dinv[ND];
  V3<T> w[ND], wd[ND], ao[ND];
  V3<T> com[ND], f[ND], nn[ND];
  T Iw[ND][6];
  T mass[ND];
  V3<T> J[CAP], Ia[CAP];             // link l's active column i: J_li, I_l axw_i
  unsigned char ei[CAP], ej[CAP];    // factor entry t: M_ij
};

template <class T, int ND, int K, int CAP>
struct TreesDyn {
  TreeDyn<T, ND, CAP> arm[K];
};

// ---------------------------------------------------------------- dynamics --
// Block b's DOFs from (bp, bq) in ascending order on one lane (fk_dof).
template <class T, int ND, class Ar, class Dy>
IGT_HD void fk_block(const float* c, V3<T> bp, Q4<T> bq, Ar& ar, Dy& dy, int b, bool vel) {
  FkCarry<T> k = fk_start(bp, bq);
  int last = -1;
  for (int m = ar.tr.bs[b]; m < ar.tr.bs[b + 1]; ++m) {
    const int d = ar.tr.bm[m];
    fk_dof<T>(c, d, last, bp, bq, ar, dy, vel, k);
    last = d;
  }
}

// x = L^-T y on block b of the articulation's factor, back_sub's order.
template <class T, int ND, class Ar>
IGT_HD void tree_back(const Ar& ar, int b, const T* y, T* x) {
  const auto& tr = ar.tr;
  const int o = tr.bs[b], n = tr.bs[b + 1] - o;
  const T* L = ar.L + tr.lbase[b];
  for (int r = n - 1; r >= 0; --r) {
    const int i = tr.bm[o + r];
    T s = y[i];
    for (int q = r + 1; q < n; ++q) s = s - L[tri(q) + r] * x[tr.bm[o + q]];
    x[i] = s / L[tri(r) + r];
  }
}

// The K articulations' dynamics (arms_dynamics' steps and outputs, no DR),
// block by block. Returns false, having computed nothing past the blocks,
// when an articulation's factor needs more than CAP entries.
template <class T, int ND, int K, int CAP, class Art, class Io, class Sh>
IGT_HD bool tree_dynamics(Art art, const Io& io, Sh& sh, const Lanes& w) {
  constexpr int HW = WARP / K;

  // drive; u before the step; each link's ancestors
  each_arm<K>(w, [=, &sh](int a, int s) {
    auto& ar = sh.arm[a];
    const bool effort_drive = ldc(art(a) + C_DRIVE) != 0.0f;
    for (int d = s; d < ND; d += HW) {
      dof_drive<T, ND, false>(art(a), io, a, ar, d, effort_drive);
      tree_link<ND>(art(a), ar.tr, d);
    }
  });
  // the blocks, one lane per articulation
  each_arm<K>(w, [=, &sh](int a, int s) {
    if (s == 0) tree_blocks<ND>(art(a), sh.arm[a].tr);
  });
  int wide = 0;
  for (int a = 0; a < K; ++a) {
    if (sh.arm[a].tr.nent > CAP) return false;
    wide = sh.arm[a].tr.wide > wide ? sh.arm[a].tr.wide : wide;
  }

  // FK with the velocity and bias propagation, one lane per block
  each_arm<K>(w, [=, &sh](int a, int s) {
    if (s >= sh.arm[a].tr.nblk) return;
    V3<T> bp;
    Q4<T> bq;
    io.base(a, art(a), bp, bq);
    for (int b = s; b < sh.arm[a].tr.nblk; b += HW)
      fk_block<T, ND>(art(a), bp, bq, sh.arm[a], sh.s.dyn.arm[a], b, true);
  });

  // per link: world COM, inertia, force and moment; per DOF i: its row's
  // entries of its block's factor
  each_arm<K>(w, [=, &sh](int a, int s) {
    const auto& tr = sh.arm[a].tr;
    auto& dy = sh.s.dyn.arm[a];
    for (int l = s; l < ND; l += HW) {
      link_terms_fixed<T, ND, false>(art(a), sh.arm[a], dy, l, io, a);
      dy.mass[l] = T(ldc(art(a) + DOF_OFF + l * DOF_STRIDE + D_MASS));
      const int b = tr.blk[l], p = tr.pos[l];
      for (int q = 0; q <= p; ++q) {
        const int t = tr.lbase[b] + tri(p) + q;
        dy.ei[t] = (unsigned char)l;
        dy.ej[t] = tr.bm[tr.bs[b] + q];
      }
    }
  });

  // every link's active columns, a lane per link
  each_arm<K>(w, [=, &sh](int a, int s) {
    const auto& ar = sh.arm[a];
    auto& dy = sh.s.dyn.arm[a];
    for (int l = s; l < ND; l += HW) {
      int t = ar.tr.joff[l];
      for (unsigned bits = ar.tr.cbits[l]; bits; bits &= bits - 1u, ++t) {
        const int i = low_bit(bits);
        const bool rev = ar.tr.rev >> i & 1u;
        dy.J[t] = rev ? cross(ar.axw[i], sub(dy.com[l], ar.fp[i])) : ar.axw[i];
        if (rev) dy.Ia[t] = inertia_times<T>(dy, l, ar.axw[i]);
      }
    }
  });

  // each entry of a block's M sums over its links in ascending l (i's
  // descendants), a lane each; a diagonal entry's lane also sums the bias of
  // its DOF over the same links, then adds the armature
  each_arm<K>(w, [=, &sh](int a, int s) {
    const float* c = art(a);
    auto& ar = sh.arm[a];
    const auto& tr = ar.tr;
    auto& dy = sh.s.dyn.arm[a];
    for (int t = s; t < tr.nent; t += HW) {
      const int i = dy.ei[t], j = dy.ej[t], b = tr.blk[i];
      const bool rev_i = tr.rev >> i & 1u, revs = rev_i && (tr.rev >> j & 1u), diag = i == j;
      const V3<T> axi = ar.axw[i];
      T Mij = T(0.0f), acc = T(0.0f);
      for (int m = tr.bs[b] + tr.pos[i]; m < tr.bs[b + 1]; ++m) {
        const int l = tr.bm[m];
        const unsigned cb = tr.cbits[l];
        if (!((cb >> i & 1u) && (cb >> j & 1u))) continue;
        const V3<T> Jli = dy.J[tr.joff[l] + tr.na[i] - 1];
        const int lj = tr.joff[l] + tr.na[j] - 1;
        if (diag) {
          if (rev_i) acc = acc + dot(axi, dy.nn[l]);
          acc = acc + dot(Jli, dy.f[l]);
        }
        if (revs) Mij = Mij + dot(axi, dy.Ia[lj]);
        Mij = Mij + dy.mass[l] * dot(Jli, dy.J[lj]);
      }
      if (diag) {
        Mij = Mij + T(ldc(c + DOF_OFF + i * DOF_STRIDE + D_ARMATURE));
        dy.rhs[i] = ar.tau[i] - acc;
      }
      ar.L[t] = Mij;
    }
  });

  // each block's first pivot and its y
  each_arm<K>(w, [=, &sh](int a, int s) {
    auto& ar = sh.arm[a];
    auto& dy = sh.s.dyn.arm[a];
    for (int b = s; b < ar.tr.nblk; b += HW) {
      const int i = ar.tr.bm[ar.tr.bs[b]];
      T& Lii = ar.L[ar.tr.lbase[b]];
      Lii = sqrt_floor(Lii, 1e-12f);
      dy.dinv[i] = T(1.0f) / Lii;
      dy.y[i] = dy.rhs[i] / Lii;
    }
  });
  // Cholesky in place (left-looking) with the forward solve, the blocks side
  // by side: phase p forms column p of every block below its diagonal, each
  // row also subtracting L_ij^2 from its diagonal and L_ij y_j from its rhs;
  // the owner of a block's row p + 1 then forms that pivot and its y
  for (int p = 0; p < wide - 1; ++p) {
    each_arm<K>(w, [=, &sh](int a, int s) {
      auto& ar = sh.arm[a];
      const auto& tr = ar.tr;
      auto& dy = sh.s.dyn.arm[a];
      for (int i = s; i < ND; i += HW) {
        const int r = tr.pos[i], b = tr.blk[i];
        if (r <= p) continue;
        const int j = tr.bm[tr.bs[b] + p];
        T* Li = ar.L + tr.lbase[b] + tri(r);
        const T* Lj = ar.L + tr.lbase[b] + tri(p);
        T s2 = Li[p];
        for (int k = 0; k < p; ++k) s2 = s2 - Li[k] * Lj[k];
        const T lij = s2 * dy.dinv[j];
        Li[p] = lij;
        Li[r] = Li[r] - lij * lij;
        dy.rhs[i] = dy.rhs[i] - lij * dy.y[j];
        if (r != p + 1) continue;
        Li[r] = sqrt_floor(Li[r], 1e-12f);
        dy.dinv[i] = T(1.0f) / Li[r];
        dy.y[i] = dy.rhs[i] / Li[r];
      }
    });
  }
  // qdd = L^-T y, one lane per block
  each_arm<K>(w, [=, &sh](int a, int s) {
    const auto& ar = sh.arm[a];
    auto& dy = sh.s.dyn.arm[a];
    for (int b = s; b < ar.tr.nblk; b += HW)
      tree_back<T, ND>(ar, b, dy.y, dy.qdd);
  });

  // semi-implicit Euler, velocity clamp, joint limits
  each_arm<K>(w, [=, &sh](int a, int s) {
    const T dt = T(ldc(art(a) + C_DT));
    for (int d = s; d < ND; d += HW)
      dof_euler<T, ND, false>(art(a), io, a, sh.arm[a], d, dt, sh.s.dyn.arm[a].qdd[d]);
  });
  // FK at the new q, one lane per block
  each_arm<K>(w, [=, &sh](int a, int s) {
    if (s >= sh.arm[a].tr.nblk) return;
    V3<T> bp;
    Q4<T> bq;
    io.base(a, art(a), bp, bq);
    for (int b = s; b < sh.arm[a].tr.nblk; b += HW)
      fk_block<T, ND>(art(a), bp, bq, sh.arm[a], sh.s.dyn.arm[a], b, false);
  });
  return true;
}

// --------------------------------------------------------------- contacts --
// The contact's columns of world point ``pt`` on ``link`` (those of its
// block; a column off its ancestors is zero, ``on`` false) and each active
// one times u_i: the block's m-th DOF on lane s = m of the articulation's HW.
// Lane 0 records the block.
template <class T, int ND, int HW, class Ar>
IGT_HD void tree_contact_cols(Ar& ar, ArmContact<T, ND>& ct, V3<T> pt, int link, int s) {
  const unsigned anc = tree_anc(ar.tr, link);
  const int b = tree_blk(ar.tr, link);
  if (s == 0) ar.cb = b;
  if (b < 0) return;
  for (int m = ar.tr.bs[b] + s; m < ar.tr.bs[b + 1]; m += HW) {
    const int i = ar.tr.bm[m];
    ct.on[i] = anc >> i & 1u;
    if (!ct.on[i]) continue;
    ct.Jc[i] = ar.tr.rev >> i & 1u ? cross(ar.axw[i], sub(pt, ar.fp[i])) : ar.axw[i];
    ct.cu[i] = scale(ct.Jc[i], ar.u[i]);
  }
}

// sum_k sq[k] over the contact's block, ascending k (+0 without one).
template <class T, int ND, class Ar>
IGT_HD T tree_sum_sq(const Ar& ar, const T* sq) {
  T s = T(0.0f);
  if (ar.cb < 0) return s;
  for (int m = ar.tr.bs[ar.cb]; m < ar.tr.bs[ar.cb + 1]; ++m) s = s + sq[ar.tr.bm[m]];
  return s;
}

// The point's velocity, sum of the active columns times u_i in ascending i.
template <class T, int ND, class Ar>
IGT_HD V3<T> tree_point_velocity(const Ar& ar, const ArmContact<T, ND>& ct) {
  V3<T> v = v3<T>(T(0.0f), T(0.0f), T(0.0f));
  if (ar.cb < 0) return v;
  for (int m = ar.tr.bs[ar.cb]; m < ar.tr.bs[ar.cb + 1]; ++m)
    if (ct.on[ar.tr.bm[m]]) v = add(v, ct.cu[ar.tr.bm[m]]);
  return v;
}

// contact_solve on each acting contact's block: yn = L^-1 J^T n and yt =
// L^-1 J^T t_hat with their squares, column by column, the block's row m on
// lane m of the articulation's lanes.
template <class T, int ND, int K, class Sh>
IGT_HD void tree_contact_solve(Sh& sh, const Lanes& w) {
  constexpr int HW = WARP / K;
  int wide = 0;
  for (int a = 0; a < K; ++a) {
    const auto& ar = sh.arm[a];
    if (!sh.s.ct.arm[a].act || ar.cb < 0) continue;
    const int n = ar.tr.bs[ar.cb + 1] - ar.tr.bs[ar.cb];
    wide = n > wide ? n : wide;
  }
  each_arm<K>(w, [=, &sh](int a, int s) {
    const auto& ar = sh.arm[a];
    auto& ct = sh.s.ct.arm[a];
    if (!ct.act || ar.cb < 0) return;
    const int o = ar.tr.bs[ar.cb];
    for (int m = o + s; m < ar.tr.bs[ar.cb + 1]; m += HW) {
      const int i = ar.tr.bm[m];
      ct.bn[i] = ct.on[i] ? dot(ct.Jc[i], ct.n) : T(0.0f);
      ct.bt[i] = ct.on[i] ? dot(ct.Jc[i], ct.t_hat) : T(0.0f);
    }
    if (s == 0) {
      const int i = ar.tr.bm[o];
      const T l00 = ar.L[ar.tr.lbase[ar.cb]];
      ct.yn[i] = ct.bn[i] / l00;
      ct.sqn[i] = ct.yn[i] * ct.yn[i];
      ct.yt[i] = ct.bt[i] / l00;
      ct.sqt[i] = ct.yt[i] * ct.yt[i];
    }
  });
  for (int p = 0; p < wide - 1; ++p) {
    each_arm<K>(w, [=, &sh](int a, int s) {
      const auto& ar = sh.arm[a];
      auto& ct = sh.s.ct.arm[a];
      if (!ct.act || ar.cb < 0) return;
      const int o = ar.tr.bs[ar.cb], n = ar.tr.bs[ar.cb + 1] - o;
      const T* L = ar.L + ar.tr.lbase[ar.cb];
      const int j = ar.tr.bm[o + (p < n ? p : 0)];
      for (int r = s; r < n; r += HW) {
        if (r <= p) continue;
        const int i = ar.tr.bm[o + r];
        const T lij = L[tri(r) + p];
        ct.bn[i] = ct.bn[i] - lij * ct.yn[j];
        ct.bt[i] = ct.bt[i] - lij * ct.yt[j];
        if (r != p + 1) continue;
        const T lii = L[tri(r) + r];
        ct.yn[i] = ct.bn[i] / lii;
        ct.sqn[i] = ct.yn[i] * ct.yn[i];
        ct.yt[i] = ct.bt[i] / lii;
        ct.sqt[i] = ct.yt[i] * ct.yt[i];
      }
    });
  }
}

// contact_back on each acting contact's block: u += L^-T (yn an + yt at), or
// L^-T (yn an - yt at) with ``minus``, one lane per articulation.
template <class T, int ND, int K, class Sh>
IGT_HD void tree_contact_back(Sh& sh, const Lanes& w) {
  each_arm<K>(w, [=, &sh](int a, int s) {
    auto& ar = sh.arm[a];
    auto& ct = sh.s.ct.arm[a];
    if (!ct.act || s != 0 || ar.cb < 0) return;
    const T an = ct.an, at = ct.at;
    const int o = ar.tr.bs[ar.cb], e = ar.tr.bs[ar.cb + 1];
    for (int m = o; m < e; ++m) {
      const int i = ar.tr.bm[m];
      ct.jv[i] = ct.minus ? ct.yn[i] * an - ct.yt[i] * at : ct.yn[i] * an + ct.yt[i] * at;
    }
    tree_back<T, ND>(ar, ar.cb, ct.jv, ct.du);
    for (int m = o; m < e; ++m) ar.u[ar.tr.bm[m]] = ar.u[ar.tr.bm[m]] + ct.du[ar.tr.bm[m]];
  });
}

}  // namespace igt
