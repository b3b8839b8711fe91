// The whole Jacobi-preconditioned BiCGStab solve as one persistent
// cooperative kernel, templated on the stencil operator.  Shared by K1
// (bicgstab.cu, a 5-point Stencil5 system), K5 (bicgstab3.cu, a 7-point
// Stencil7 system) and K4 (triple_solve.cu, three Stencil5 solves in one
// launch); the operator supplies size() and apply_of(u, k), the stencil at
// flat index k of the values a callable u gives, with zero inflow.  The solve
// itself is the __device__ function solve() of a cooperative grid;
// bicgstab_kernel wraps one call of it, on one system or on a batch of
// systems (K1 and K5), and K4 calls it three times, on one system or on a
// batch (solve_batched).
//
// It computes exactly _bicgstab_inline of na_dd_tpu/ops/pallas_kernels.py
// (:83) with x0 = 0: the masked-early-exit update of bicgstab_unrolled,
// iters_used counting only the iterations taken while not done,
// done = s_conv | breakdown | (r.r <= tol_sq), safe_div guarded by
// |den| > 1e-300 cast to the dtype (0 in float32, so the float guard is
// |den| > 0), and the output x * mask.
//
// Design.  The TPU kernels kept every iterate in one core's VMEM; here one
// plane or volume alone exceeds an SM's 227 KB of shared memory, so the
// solve is spread over the whole card: one cooperative launch, grid-stride
// loops (each thread always owns the same points), and a grid-wide barrier
// wherever a value is needed at a point another block owns, or a dot product
// over the whole grid.  Those barriers and the passes over the arrays are
// the cost (a main-path solve takes 1-3 iterations), so an iteration has
// three passes and three barriers, with beta, omega, alpha from the barrier
// before:
//   A  p' = r + beta (p - omega v) at the own point, stored in the other p
//      buffer; v' = A (D^-1 p'), where D^-1 p' at each neighbour is
//      recomputed there from r, p, v and inv_diag; v' into the other v
//      buffer; r^.v' partial.                        barrier -> alpha
//   B  s = r - alpha v' at the own point and the neighbours (never stored);
//      t = A (D^-1 s) stored; s.s, t.s, t.t partials.  barrier -> s_conv, omega
//   C  s again at the own point; x += alpha D^-1 p' (+ omega D^-1 s),
//      r = s (- omega t); r.r, r^.r partials.         barrier -> done
// Own-point and neighbour values go through the same __forceinline__
// functions (next_p, next_s), so they are the same floating-point
// operations: iterates and partials are bit for bit those of the same
// schedule with p^ = D^-1 p' and s^ = D^-1 s stored.
// Iteration 0 is specialised: with x0 = 0, p' = b + 0 exactly, so p, v, x
// are not read and the b.b partial rides on pass A's barrier (no set-up
// pass).  The rhs comes as an object (ArrayRhs for K1 and K5): K4 forms its
// T rhs in that pass, at the own point and at the neighbours, and stores it
// there for the later passes (triple_solve.cu).  Pass C writes x * mask into
// the output every iteration, and the unmasked x into a work array only when
// another iteration may follow, so there is no separate mask pass.
//
// Every dot product is deterministic: each block writes one partial per
// slot; after the barrier warp 0 of every block sums all partials of the
// barrier's slots in one loop, lane l adding blocks l, l + 32, ... in turn,
// so all blocks hold bit-identical scalars and take the same `done` branch,
// which makes a real `break` equal to the masked fixed budget.
//
// Loads.  No pass reads an array that the same pass writes at another point:
// a value crosses between blocks only over a grid barrier, whose fence orders
// the writes before every later read.  So the work arrays, and the rhs b
// (which K4 writes in the launch), are read with plain loads that L1 may
// serve, neighbours' values included; never through the read-only path,
// which is not coherent within a launch.  On the H100 this form was the
// fastest at every main-path shape (257^2, 1025^2, 65^3, 129^3) against the
// same loads through L2 only (__ldcg) and against p^ stored with a fourth
// barrier, through L2 or L1, all four bit for bit equal (PERF.md, Findings).
// The partials are still read through L2.
// Scratch (seven working arrays and the partials) is allocated by the
// caller.
//
// Batch (the leading dimension that jax.vmap of the TPU kernel gives): one
// cooperative launch solves nsys systems of equal size, each on its own
// contiguous share of the blocks (Share), grid-stride over its own points,
// so each block still writes one partial a slot.  After each barrier warp 0
// of every block sums the partials grouped by system (system_totals: the
// same loads as one system's), so every block holds every system's scalars
// and `done`; a done system's blocks skip their passes and meet every
// barrier, and the loop ends when the last system is done or the budget is
// spent.  Each system's arithmetic is that of the solve of one system on
// its share of the grid.  A batch of one launches the solve of one system
// itself (bicgstab_kernel).  The batch is bounded by kMaxBatch (the shared
// totals) and by the co-resident blocks, at least one a system.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace bicgstab {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWorkArrays = 7;
constexpr int kMaxSlotsPerBarrier = 3;
constexpr int kBatchSlotsPerBarrier = 4;  // solve_batched's pass C
constexpr int kMaxBatch = 32;  // systems in one launch of bicgstab_kernel

// Dot-product slots in the partials array (slot * gridDim.x + block); the
// slots one barrier sums are adjacent.  kLast and kTolSq are the batched
// solve's per-system flags (see solve_batched).
enum Slot {
  kRhatV = 0, kBB, kSS, kTS, kTT, kRR, kRhatR, kLast, kTolSq, kNumSlots
};

// The blocks of a batched launch: system `sys` of the `nsys` owns the `per`
// consecutive blocks from sys * per (gridDim.x = nsys * per).
struct Share {
  int nsys;
  int sys;
  int per;

  __device__ static Share of(int nsys) {
    const int per = static_cast<int>(gridDim.x) / nsys;
    return Share{nsys, static_cast<int>(blockIdx.x) / per, per};
  }
};

// The seven working arrays of a solve and the dot-product partials.
template <typename T>
struct Work {
  T* r;
  T* p[2];  // p of the last iteration and p' of this one, in turns
  T* v[2];  // likewise v and v'
  T* t;
  T* x;  // the unmasked iterate, kept while another iteration may follow
  T* partials;  // kNumSlots * gridDim.x

  // The same arrays from point `off` on (one system of a batch).
  __device__ Work offset(size_t off) const {
    return Work{r + off, {p[0] + off, p[1] + off}, {v[0] + off, v[1] + off},
                t + off, x + off, partials};
  }
};

// `work` holds the seven working arrays of n points each.
template <typename T>
Work<T> make_work(T* work, size_t n, T* partials) {
  return Work<T>{work,
                 {work + n, work + 2 * n},
                 {work + 3 * n, work + 4 * n},
                 work + 5 * n,
                 work + 6 * n,
                 partials};
}

// What a solve leaves behind: iterations taken while not done, the
// recurrence residual r.r at exit and tol_sq = tol^2 (b.b), the same in
// every thread of the system's blocks; and whether the grid took an
// iteration (in a batch, whether any system did), the same in every thread
// of the grid.
template <typename T>
struct Result {
  int used;
  T rr;
  T tol_sq;
  bool looped;
};

template <typename T, class Op>
struct Params {
  Op A;        // the stencil operator (its coefficient arrays and shape)
  const T* b;  // rhs; also r^ (the shadow residual, r0 = b with x0 = 0)
  const T* inv_diag;
  const T* mask;
  T* x;
  int* iters_out;  // one a system
  Work<T> W;
  int nsys;  // systems, one after another in every array
  int iters;
  double tol_sq_coef;  // tol * tol, cast to T in the kernel
};

template <typename T>
__device__ __forceinline__ T eps_div();
template <>
__device__ __forceinline__ double eps_div<double>() {
  return 1e-300;
}
template <>
__device__ __forceinline__ float eps_div<float>() {
  return 0.0f;  // float(1e-300) underflows to 0, as jnp.asarray(1e-300, f32)
}

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den, bool* ok) {
  *ok = fabs(den) > eps_div<T>();
  return *ok ? num / den : T(0);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block sums of the kS values v[s], written into the block's slots
// first .. first + kS - 1 of `partials`.  `red` holds kS * kWarps values; it
// is free again once the grid barrier that follows has passed.
template <int kS, typename T>
__device__ __forceinline__ void store_partials(T (&v)[kS], T* partials,
                                               int first, T* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const T w = warp_sum(v[s]);
    if (lane == 0) red[s * kWarps + warp] = w;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      T w = lane < kWarps ? red[s * kWarps + lane] : T(0);
      w = warp_sum(w);
      if (lane == 0) partials[(first + s) * gridDim.x + blockIdx.x] = w;
    }
  }
}

// Totals over all blocks of slots first .. first + kS - 1, each in one fixed
// order, so every block gets bit-identical values.  One loop serves all kS
// slots, so their loads are in flight together.  `bcast` holds kS values.
template <int kS, typename T>
__device__ __forceinline__ void grid_totals(const T* partials, int first,
                                            T (&out)[kS], T* bcast) {
  if (threadIdx.x < 32) {
    const int g = gridDim.x;
    T acc[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) acc[s] = T(0);
#pragma unroll 4
    for (int k = threadIdx.x; k < g; k += 32) {
#pragma unroll
      for (int s = 0; s < kS; ++s)
        acc[s] += __ldcg(partials + (first + s) * g + k);
    }
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      acc[s] = warp_sum(acc[s]);
      if (threadIdx.x == 0) bcast[s] = acc[s];
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kS; ++s) out[s] = bcast[s];
}

// Totals of slots first .. first + kS - 1 over each system's blocks
// (Share), into bcast[q * kS + s] for system q; each in one fixed order, so
// every block gets bit-identical values.  One loop serves all kS slots, so
// their loads are in flight together.  `bcast` holds sh.nsys * kS values.
template <int kS, typename T>
__device__ __forceinline__ void system_totals(const T* partials, int first,
                                              const Share& sh, T* bcast) {
  if (threadIdx.x < 32) {
    const int g = gridDim.x;
    for (int q = 0; q < sh.nsys; ++q) {
      T acc[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) acc[s] = T(0);
      const int end = (q + 1) * sh.per;
#pragma unroll 4
      for (int k = q * sh.per + threadIdx.x; k < end; k += 32) {
#pragma unroll
        for (int s = 0; s < kS; ++s)
          acc[s] += __ldcg(partials + (first + s) * g + k);
      }
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        acc[s] = warp_sum(acc[s]);
        if (threadIdx.x == 0) bcast[q * kS + s] = acc[s];
      }
    }
  }
  __syncthreads();
}

// A value of an array that this launch writes, or may write (see above): a
// plain load, which L1 may serve.
template <typename T>
__device__ __forceinline__ T ld(const T* a, int k) {
  return a[k];
}

// p' = r + beta (p - omega v) at one point, own or neighbour.
template <typename T>
__device__ __forceinline__ T next_p(T r, T p, T v, T beta, T omega) {
  return r + beta * (p - omega * v);
}

// s = r - alpha v' at one point, own or neighbour.
template <typename T>
__device__ __forceinline__ T next_s(T r, T v, T alpha) {
  return r - alpha * v;
}

// The rhs b of a solve as the solve reads it: first(j) at any point in
// iteration 0's pass A, own(k) at the thread's own point there, and the
// array stored() from that pass's barrier on.  Here an array that is there
// when the solve starts; K4 passes one that it forms in that pass.
template <typename T>
struct ArrayRhs {
  const T* b;
  __device__ __forceinline__ T first(int j) const { return ld(b, j); }
  __device__ __forceinline__ T own(int k) const { return ld(b, k); }
  __device__ __forceinline__ const T* stored() const { return b; }
};

// One whole solve A x = b from x0 = 0 by every thread of the cooperative
// grid; x comes out multiplied by mask.  An array rhs is read at
// neighbours' points, so a caller that writes it in the launch syncs the
// grid before the call.  `red` (kMaxSlotsPerBarrier * kWarps values) and
// `bcast` (kMaxSlotsPerBarrier) are the block's shared scratch.  Ends
// without a grid sync, on pass C's barrier when it took an iteration (x, r
// and the partials written before it are visible after it), or with the x
// it writes after its only barrier when it took none: a caller that reads x
// at a neighbour's point after that, or starts another solve on the same
// work arrays, syncs first.
template <typename T, class Op, class Rhs>
__device__ __forceinline__ Result<T> solve(cg::grid_group& grid, const Op& A,
                                           const Rhs& B, const T* inv_diag_in,
                                           const T* mask_in, T* x,
                                           const Work<T>& W, int iters,
                                           double tol_sq_coef, T* red,
                                           T* bcast) {
  const int n = A.size();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const T* __restrict__ inv_diag = inv_diag_in;
  const T* __restrict__ mask = mask_in;

  // Iteration 0, pass A: x0 = 0 gives r = r^ = b, p = v = 0, and
  // p' = b + beta (0 - 1 * 0) = b + 0 bit for bit.  Its barrier also brings
  // b.b, hence tol_sq and `done` at the start.
  {
    T* Pn = W.p[1];
    T* Vn = W.v[1];
    T acc[2] = {T(0), T(0)};  // r^.v', b.b
    const auto phat = [&](int j) {
      return (B.first(j) + T(0)) * __ldg(inv_diag + j);
    };
    for (int k = first; k < n; k += stride) {
      const T bk = B.own(k);
      Pn[k] = bk + T(0);
      const T vk = A.apply_of(phat, k);
      Vn[k] = vk;
      acc[0] += bk * vk;
      acc[1] += bk * bk;
    }
    store_partials(acc, W.partials, kRhatV, red);
  }
  grid.sync();
  T first_totals[2];
  grid_totals(W.partials, kRhatV, first_totals, bcast);
  const T* b = B.stored();
  T rv = first_totals[0];
  const T bb = first_totals[1];
  const T tol_sq = static_cast<T>(tol_sq_coef) * bb;
  T rr = bb;      // r.r
  T rhat_r = bb;  // r^.r
  if (rr <= tol_sq || iters <= 0) {
    for (int k = first; k < n; k += stride) x[k] = T(0) * __ldg(mask + k);
    return Result<T>{0, rr, tol_sq, false};
  }
  T rho = T(1), alpha = T(1), omega = T(1);
  int used = 0;

  for (int it = 0;; ++it) {
    const T* r = it == 0 ? b : W.r;  // r of the last iteration
    const T* Pc = W.p[it & 1];
    const T* Vc = W.v[it & 1];
    T* Pn = W.p[(it + 1) & 1];
    T* Vn = W.v[(it + 1) & 1];
    const T rho1 = rhat_r;
    bool ok1 = true, ok2 = true, ok3, ok4;  // iteration 0: rho = omega = 1

    if (it > 0) {
      // pass A: p' stored; v' = A D^-1 p' with p' recomputed at neighbours
      const T ratio = safe_div(rho1, rho, &ok1);
      const T aw = safe_div(alpha, omega, &ok2);
      const T beta = ratio * aw;
      const auto phat = [&](int j) {
        return next_p(ld(r, j), ld(Pc, j), ld(Vc, j), beta, omega) *
               __ldg(inv_diag + j);
      };
      T acc[1] = {T(0)};  // r^.v'
      for (int k = first; k < n; k += stride) {
        Pn[k] = next_p(ld(r, k), ld(Pc, k), ld(Vc, k), beta, omega);
        const T vk = A.apply_of(phat, k);
        Vn[k] = vk;
        acc[0] += ld(b, k) * vk;
      }
      store_partials(acc, W.partials, kRhatV, red);
      grid.sync();
      T rhat_v[1];
      grid_totals(W.partials, kRhatV, rhat_v, bcast);
      rv = rhat_v[0];
    }
    const T alpha_new = safe_div(rho1, rv, &ok3);

    // pass B: t = A D^-1 s, with s recomputed at every point it is read
    {
      const auto shat = [&](int j) {
        return next_s(ld(r, j), ld(Vn, j), alpha_new) * __ldg(inv_diag + j);
      };
      T acc[3] = {T(0), T(0), T(0)};  // s.s, t.s, t.t
      for (int k = first; k < n; k += stride) {
        const T tk = A.apply_of(shat, k);
        W.t[k] = tk;
        const T sk = next_s(ld(r, k), ld(Vn, k), alpha_new);
        acc[0] += sk * sk;
        acc[1] += tk * sk;
        acc[2] += tk * tk;
      }
      store_partials(acc, W.partials, kSS, red);
    }
    grid.sync();
    T sts[3];  // s.s, t.s, t.t
    grid_totals(W.partials, kSS, sts, bcast);
    const bool s_conv = sts[0] <= tol_sq;
    const T omega_new = safe_div(sts[1], sts[2], &ok4);
    const bool breakdown = !(ok1 && ok2 && ok3 && ok4);
    const bool last = s_conv || breakdown || it + 1 >= iters;

    // pass C: x and r at the own point; x * mask into the output
    {
      T acc[2] = {T(0), T(0)};  // r.r, r^.r
      for (int k = first; k < n; k += stride) {
        const T sk = next_s(ld(r, k), ld(Vn, k), alpha_new);
        const T ik = __ldg(inv_diag + k);
        const T x_old = it == 0 ? T(0) : ld(W.x, k);
        const T x_half = x_old + alpha_new * (ld(Pn, k) * ik);
        T xk, rk;
        if (s_conv) {
          xk = x_half;
          rk = sk;
        } else {
          xk = x_half + omega_new * (sk * ik);
          rk = sk - omega_new * ld(W.t, k);
        }
        x[k] = xk * __ldg(mask + k);
        if (!last) W.x[k] = xk;
        W.r[k] = rk;
        acc[0] += rk * rk;
        acc[1] += ld(b, k) * rk;
      }
      store_partials(acc, W.partials, kRR, red);
    }
    grid.sync();
    T rrs[2];  // r.r, r^.r
    grid_totals(W.partials, kRR, rrs, bcast);
    rr = rrs[0];
    rhat_r = rrs[1];
    rho = rho1;
    alpha = alpha_new;
    omega = omega_new;
    ++used;
    if (last || rr <= tol_sq) break;
  }
  return Result<T>{used, rr, tol_sq, true};
}

// The solve of `solve` on a batch: the grid solves sh.nsys systems at once,
// each on the sh.per blocks that Share gives it, and A, B, inv_diag, mask, x
// and W are the calling block's own system's.  Every block sums the partials
// of every system (system_totals), and pass C also reports, per system,
// whether this iteration was its last (slot kLast) and its tol_sq (slot
// kTolSq), so every block sees every system's `done` and all leave the loop
// together, when the last system is done.  A done system's blocks skip their
// passes but meet every barrier; its x, iteration count and r.r stay as they
// were.  Each system's arithmetic is that of `solve` on its share of the
// grid (the same passes, written out again so that the single-system solve
// keeps its own registers: see bicgstab_kernel).  `red` holds
// kBatchSlotsPerBarrier * kWarps values, `bcast` kMaxBatch *
// kBatchSlotsPerBarrier.
template <typename T, class Op, class Rhs>
__device__ __forceinline__ Result<T> solve_batched(
    cg::grid_group& grid, const Op& A, const Rhs& B, const T* inv_diag_in,
    const T* mask_in, T* x, const Work<T>& W, int iters, double tol_sq_coef,
    T* red, T* bcast, const Share& sh) {
  const int n = A.size();
  const int stride = sh.per * kThreads;
  const int first =
      (static_cast<int>(blockIdx.x) - sh.sys * sh.per) * kThreads + threadIdx.x;
  const T* __restrict__ inv_diag = inv_diag_in;
  const T* __restrict__ mask = mask_in;

  // Iteration 0, pass A: x0 = 0 gives r = r^ = b, p = v = 0, and
  // p' = b + beta (0 - 1 * 0) = b + 0 bit for bit.  Its barrier also brings
  // b.b, hence tol_sq and `done` at the start.
  {
    T* Pn = W.p[1];
    T* Vn = W.v[1];
    T acc[2] = {T(0), T(0)};  // r^.v', b.b
    const auto phat = [&](int j) {
      return (B.first(j) + T(0)) * __ldg(inv_diag + j);
    };
    for (int k = first; k < n; k += stride) {
      const T bk = B.own(k);
      Pn[k] = bk + T(0);
      const T vk = A.apply_of(phat, k);
      Vn[k] = vk;
      acc[0] += bk * vk;
      acc[1] += bk * bk;
    }
    store_partials(acc, W.partials, kRhatV, red);
  }
  grid.sync();
  system_totals<2>(W.partials, kRhatV, sh, bcast);
  const T* b = B.stored();
  T rv = bcast[2 * sh.sys];
  const T bb = bcast[2 * sh.sys + 1];
  const T tol_sq = static_cast<T>(tol_sq_coef) * bb;
  T rr = bb;      // r.r
  T rhat_r = bb;  // r^.r
  bool active = !(rr <= tol_sq || iters <= 0);
  if (!active) {
    for (int k = first; k < n; k += stride) x[k] = T(0) * __ldg(mask + k);
  }
  bool any = false;
  for (int q = 0; q < sh.nsys; ++q) {
    const T bq = bcast[2 * q + 1];
    any |= !(bq <= static_cast<T>(tol_sq_coef) * bq || iters <= 0);
  }
  if (!any) return Result<T>{0, rr, tol_sq, false};
  T rho = T(1), alpha = T(1), omega = T(1);
  int used = 0;

  for (int it = 0;; ++it) {
    const int end = active ? n : 0;  // a done system runs no pass
    const T* r = it == 0 ? b : W.r;  // r of the last iteration
    const T* Pc = W.p[it & 1];
    const T* Vc = W.v[it & 1];
    T* Pn = W.p[(it + 1) & 1];
    T* Vn = W.v[(it + 1) & 1];
    const T rho1 = rhat_r;
    bool ok1 = true, ok2 = true, ok3, ok4;  // iteration 0: rho = omega = 1

    if (it > 0) {
      // pass A: p' stored; v' = A D^-1 p' with p' recomputed at neighbours
      const T ratio = safe_div(rho1, rho, &ok1);
      const T aw = safe_div(alpha, omega, &ok2);
      const T beta = ratio * aw;
      const auto phat = [&](int j) {
        return next_p(ld(r, j), ld(Pc, j), ld(Vc, j), beta, omega) *
               __ldg(inv_diag + j);
      };
      T acc[1] = {T(0)};  // r^.v'
      for (int k = first; k < end; k += stride) {
        Pn[k] = next_p(ld(r, k), ld(Pc, k), ld(Vc, k), beta, omega);
        const T vk = A.apply_of(phat, k);
        Vn[k] = vk;
        acc[0] += ld(b, k) * vk;
      }
      store_partials(acc, W.partials, kRhatV, red);
      grid.sync();
      system_totals<1>(W.partials, kRhatV, sh, bcast);
      rv = bcast[sh.sys];
    }
    const T alpha_new = safe_div(rho1, rv, &ok3);

    // pass B: t = A D^-1 s, with s recomputed at every point it is read
    {
      const auto shat = [&](int j) {
        return next_s(ld(r, j), ld(Vn, j), alpha_new) * __ldg(inv_diag + j);
      };
      T acc[3] = {T(0), T(0), T(0)};  // s.s, t.s, t.t
      for (int k = first; k < end; k += stride) {
        const T tk = A.apply_of(shat, k);
        W.t[k] = tk;
        const T sk = next_s(ld(r, k), ld(Vn, k), alpha_new);
        acc[0] += sk * sk;
        acc[1] += tk * sk;
        acc[2] += tk * tk;
      }
      store_partials(acc, W.partials, kSS, red);
    }
    grid.sync();
    system_totals<3>(W.partials, kSS, sh, bcast);
    const T* sts = bcast + 3 * sh.sys;  // s.s, t.s, t.t
    const bool s_conv = sts[0] <= tol_sq;
    const T omega_new = safe_div(sts[1], sts[2], &ok4);
    const bool breakdown = !(ok1 && ok2 && ok3 && ok4);
    const bool last = s_conv || breakdown || it + 1 >= iters;

    // pass C: x and r at the own point; x * mask into the output
    constexpr int kC = kBatchSlotsPerBarrier;
    {
      T acc[kC] = {T(0), T(0), T(0), T(0)};  // r.r, r^.r, last, tol_sq
      for (int k = first; k < end; k += stride) {
        const T sk = next_s(ld(r, k), ld(Vn, k), alpha_new);
        const T ik = __ldg(inv_diag + k);
        const T x_old = it == 0 ? T(0) : ld(W.x, k);
        const T x_half = x_old + alpha_new * (ld(Pn, k) * ik);
        T xk, rk;
        if (s_conv) {
          xk = x_half;
          rk = sk;
        } else {
          xk = x_half + omega_new * (sk * ik);
          rk = sk - omega_new * ld(W.t, k);
        }
        x[k] = xk * __ldg(mask + k);
        if (!last) W.x[k] = xk;
        W.r[k] = rk;
        acc[0] += rk * rk;
        acc[1] += ld(b, k) * rk;
      }
      // one thread a block reports its system's flag, the system's first
      // block its tol_sq: the block sums carry them exactly
      if (threadIdx.x == 0) {
        acc[2] = (last || !active) ? T(1) : T(0);
        acc[3] = first == 0 ? tol_sq : T(0);
      }
      store_partials(acc, W.partials, kRR, red);
    }
    grid.sync();
    system_totals<kC>(W.partials, kRR, sh, bcast);
    if (active) {
      rr = bcast[kC * sh.sys];
      rhat_r = bcast[kC * sh.sys + 1];
      rho = rho1;
      alpha = alpha_new;
      omega = omega_new;
      ++used;
      active = !(last || rr <= tol_sq);
    }
    any = false;
    for (int q = 0; q < sh.nsys; ++q) {
      const T* c = bcast + kC * q;  // r.r, r^.r, last, tol_sq
      any |= !(c[2] > T(0) || c[0] <= c[3]);
    }
    if (!any) break;
  }
  return Result<T>{used, rr, tol_sq, true};
}

// kBatched: one system of a batch per share of the grid (Share), the arrays
// holding the nsys systems one after another, n points each (solve_batched).
// Otherwise the one system on the whole grid (solve): a batch of one
// launches that instantiation (launch), since the batched one spends
// registers on the batch's bookkeeping (PERF.md, Findings: one system
// through it was 29 % slower in K1 at 257^2 and took a smaller grid in K5).
template <typename T, class Op, bool kBatched>
__global__ void __launch_bounds__(kThreads) bicgstab_kernel(Params<T, Op> P) {
  cg::grid_group grid = cg::this_grid();
  constexpr int kSlots = kBatched ? kBatchSlotsPerBarrier : kMaxSlotsPerBarrier;
  __shared__ T red[kSlots * kWarps];
  __shared__ T bcast[(kBatched ? kMaxBatch : 1) * kSlots];
  if constexpr (kBatched) {
    const Share sh = Share::of(P.nsys);
    const size_t off = static_cast<size_t>(sh.sys) * P.A.size();
    const Result<T> res = solve_batched<T, Op, ArrayRhs<T>>(
        grid, P.A.offset(off), ArrayRhs<T>{P.b + off}, P.inv_diag + off,
        P.mask + off, P.x + off, P.W.offset(off), P.iters, P.tol_sq_coef, red,
        bcast, sh);
    if (blockIdx.x == sh.sys * sh.per && threadIdx.x == 0)
      P.iters_out[sh.sys] = res.used;
  } else {
    const Result<T> res =
        solve<T, Op>(grid, P.A, ArrayRhs<T>{P.b}, P.inv_diag, P.mask, P.x,
                     P.W, P.iters, P.tol_sq_coef, red, bcast);
    if (blockIdx.x == 0 && threadIdx.x == 0) *P.iters_out = res.used;
  }
}

// Cooperative grid size of `kernel` for nsys systems of n points each: for
// each system the blocks that can be co-resident divided among the systems,
// capped by the blocks n needs at `points` a thread (so with nsys = 1 the
// co-resident blocks capped by n's).  On the
// H100, at one point a thread, this rule was within 5 % of the best of 1
// block a SM, 2 a SM and itself at every main-path shape of K1 and K5, in
// f64 and f32, and up to 1.9x faster than 1 a SM where the points fill the
// card (PERF.md, Findings).
template <class Kernel>
int grid_blocks_of(Kernel kernel, int n, int* blocks, int points = 1,
                   int nsys = 1) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nsys < 1 || nsys > kMaxBatch)
    return static_cast<int>(cudaErrorInvalidValue);
  const int need = (n + kThreads * points - 1) / (kThreads * points);
  const int cap = per_sm * sms / nsys;
  if (cap < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks = (need < cap ? need : cap) * nsys;
  return static_cast<int>(cudaSuccess);
}

template <typename T, class Op>
int grid_blocks(int n, int nsys, int* blocks) {
  if (nsys == 1) return grid_blocks_of(bicgstab_kernel<T, Op, false>, n, blocks);
  return grid_blocks_of(bicgstab_kernel<T, Op, true>, n, blocks, 1, nsys);
}

// One cooperative launch of `kernel` on its one argument `params`.
template <class Kernel, class P>
int launch_cooperative(Kernel kernel, P& params, int blocks, void* stream) {
  void* args[] = {&params};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// nsys systems of A.size() points each, one after another in b, inv_diag,
// mask, x and A's coefficient arrays; `work` holds the seven working arrays
// of nsys * A.size() points each, `iters_out` nsys counts.  `blocks` is a
// multiple of nsys (grid_blocks).
template <typename T, class Op>
int launch(const Op& A, const T* b, const T* inv_diag, const T* mask, T* x,
           int* iters_out, T* work, T* partials, int nsys, int iters,
           double tol_sq_coef, int blocks, void* stream) {
  if (nsys < 1 || nsys > kMaxBatch || blocks % nsys != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T, Op> P{
      A,
      b,
      inv_diag,
      mask,
      x,
      iters_out,
      make_work(work, static_cast<size_t>(nsys) * A.size(), partials),
      nsys,
      iters,
      tol_sq_coef};
  if (nsys == 1)
    return launch_cooperative(bicgstab_kernel<T, Op, false>, P, blocks, stream);
  return launch_cooperative(bicgstab_kernel<T, Op, true>, P, blocks, stream);
}

}  // namespace bicgstab
