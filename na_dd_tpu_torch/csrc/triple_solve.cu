// K4: the whole triangular Newton sweep's linear algebra — the T, cl and cd
// Jacobi-BiCGStab solves and the cross-coupling right-hand sides between
// them — in one persistent cooperative kernel, for Hopper (sm_90a).
//
// Replaces: triple_solve_pallas, na_dd_tpu/ops/pallas_kernels.py:263 (body
// _make_triple_solve_kernel :182, solves _bicgstab_inline :83).  It computes
//
//   J_T  dT  = rhs_T m
//   J_cl dcl = (base_cl + dt C_clT (dT m)) m
//   J_cd dcd = (base_cd + dt (C_cdT (dT m) + d_cdcl (dcl m))) m
//
// each the masked-early-exit solve of bicgstab.cuh from x0 = 0, and writes
// dT m, dcl m, dcd m, the three iteration counts, the three recurrence
// residuals r.r at exit and the three tol_sq = tol^2 (b.b) of the masked,
// coupled right-hand sides.  `converged = res <= tol_sq` is formed by the
// caller, as the TPU wrapper forms it.
//
// Bound on the card: bytes and latency.  33 input planes and 3 output planes
// must cross device memory once (19.0 MB in f64 at 257 x 257, 5.7 us at
// 3.35 TB/s); each iteration of each solve makes the 32 plane passes and
// three grid barriers of K1 (bicgstab.cu).  At 257 x 257 the working set
// sits in L2 and the barriers cost about as much as the passes.
//
// Design: the TPU kernel kept all 40 planes in one core's VMEM; here a plane
// (528 KB in f64 at N=256) exceeds an SM's shared memory, so what carries
// over is the single launch: one cooperative grid runs the three solves back
// to back with the working set (36 planes + 8 of scratch, 23.2 MB in f64 at
// N=256) resident in the 50 MB L2, and nothing returns to the host or waits
// for a launch between the solves.  The solve is bicgstab::solve, the same
// device function K1 wraps, called three times on the same seven working
// arrays.  Grid syncs of K4's own, beyond the solves' three an iteration:
//  - none before the T solve: its rhs rhs_T m is formed in the solve's
//    first pass, where it is read (at the own point, stored for the later
//    passes, and at the neighbours);
//  - none between two solves: a solve that took an iteration ends on its
//    pass C barrier, after which its x is visible everywhere and pass A's
//    partial slots are free.  A T solve that took none wrote dT after its
//    only barrier, so one sync follows it then (every block alike);
//  - one after each coupled rhs, formed by a grid-stride pass into the
//    scratch plane, since its solve reads it at neighbours' points from its
//    first pass on.  Forming it in that pass instead, recomputed at the
//    neighbours as the T rhs is, was slower at 257 x 257 on the H100: a
//    second coupling stencil at each neighbour and more registers cost more
//    than the sync (PERF.md, Findings).
// Five syncs of its own become two.  Every form of the sums and the grid was
// measured against each other on the H100 (PERF.md, Findings): a barrier of
// K4's own on an arrival counter, and one reduced over thread block clusters
// through distributed shared memory (clusters of 2, 4 and 8), were each
// slower than the cooperative grid's sync; fewer blocks make each barrier
// cheaper where the solve sits in L2, so the grid gives each thread at
// least two points (130 blocks at 257 x 257, the co-resident limit at
// 1025 x 1025), and at most 128 registers keep two blocks a SM.
// The scratch plane and dT, dcl are read with plain loads, never through
// the read-only path, because this launch wrote them; dcl only at the
// thread's own point, which this thread wrote.
//
// Batch (the leading dimension that jax.vmap of the TPU kernel gives, as the
// batched ladder and the eta sweep run it): nsys systems of equal shape, one
// after another in every array, in one cooperative launch.  Each system owns
// its share of the blocks (bicgstab::Share) and runs the same sequence on
// it: the three solves are bicgstab::solve_batched (per-system scalars,
// `done` and iteration counts, zero inflow at each system's own edges), and
// the coupling passes stride over the system's own points, each after a
// grid barrier.  dt is per system, read from a device array of nsys float64
// values (the ladder's levels each have their own), so the wrapper never
// waits on the host.  The T solve is followed by a sync only when no system
// took an iteration (Result::looped), the batched form of the single
// system's rule.  A batch of one launches the single-system instantiation,
// which spends no registers on the batch's bookkeeping (kBatched).
#include <cuda_runtime.h>

#include "bicgstab.cuh"
#include "stencil5.cuh"

namespace {

namespace cg = cooperative_groups;
using bicgstab::kThreads;
using bicgstab::kWarps;

constexpr int kInputPlanes = 33;
constexpr int kScratchPlanes = bicgstab::kWorkArrays + 1;  // + the rhs plane
constexpr int kPointsPerThread = 2;  // at least, in the grid rule
constexpr int kMinBlocksPerSM = 2;   // the register cap: 128 a thread

template <typename T>
struct TripleParams {
  Stencil5Op<T> J_T, J_cl, J_cd;  // Newton operators
  Stencil5Op<T> C_clT, C_cdT;     // coupling operators dFcl/dT, dFcd/dT
  const T* d_cdcl;                // diagonal coupling dFcd/dcl
  const T* rhs_T;
  const T* base_cl;
  const T* base_cd;
  const T* invd_T;
  const T* invd_cl;
  const T* invd_cd;
  const T* mask;
  T* dT;
  T* dcl;
  T* dcd;
  int* iters_out;  // [3]
  T* res_out;      // [3] recurrence r.r at exit
  T* tolsq_out;    // [3]
  T* rhs;          // scratch: the masked (coupled) rhs of the running solve
  bicgstab::Work<T> W;
  int iters;
  double tol_sq_coef;  // tol * tol, cast to T in the kernel
  double dt;           // cast to T in the kernel, where dt_sys is null
  const double* dt_sys;  // or one dt a system, on the device
  int nsys;              // systems, one after another in every array
};

// The dt of system `sys`, cast to T.
template <typename T>
__device__ __forceinline__ T dt_of(const TripleParams<T>& P, int sys) {
  return static_cast<T>(P.dt_sys != nullptr ? P.dt_sys[sys] : P.dt);
}

// Solve k's results of system `sys`, written by the system's first thread
// (`lead`); the outputs hold three entries a system.
template <typename T>
__device__ __forceinline__ void write_result(const TripleParams<T>& P, int sys,
                                             int k, bool lead,
                                             const bicgstab::Result<T>& res) {
  if (lead) {
    P.iters_out[3 * sys + k] = res.used;
    P.res_out[3 * sys + k] = res.rr;
    P.tolsq_out[3 * sys + k] = res.tol_sq;
  }
}

// x * m rounded on its own, never contracted into a following add, so a
// value formed here equals the product the plain version forms.
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// The T solve's rhs, formed in the solve's first pass (bicgstab::ArrayRhs
// has the contract): rhs_T m at every point that pass reads, stored into
// `plane` at the own point for the later passes.  Own-point and neighbour
// values are the same product, bit for bit.
template <typename T>
struct MaskedRhs {
  const T* rhs;
  const T* mask;
  T* plane;
  __device__ __forceinline__ T first(int j) const {
    return mul_rn(__ldg(rhs + j), __ldg(mask + j));
  }
  __device__ __forceinline__ T own(int k) const {
    const T v = first(k);
    plane[k] = v;
    return v;
  }
  __device__ __forceinline__ const T* stored() const { return plane; }
};

// One system on the whole grid.
template <typename T>
__device__ __forceinline__ void triple_one(cg::grid_group& grid,
                                           const TripleParams<T>& P, T* red,
                                           T* bcast) {
  const int n = P.J_T.size();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const T* __restrict__ mask = P.mask;
  const T* dT = P.dT;
  const auto dT_at = [dT](int m) { return bicgstab::ld(dT, m); };

  // --- T solve, its rhs formed in its first pass ---
  bicgstab::Result<T> res = bicgstab::solve<T>(
      grid, P.J_T, MaskedRhs<T>{P.rhs_T, mask, P.rhs}, P.invd_T, mask, P.dT,
      P.W, P.iters, P.tol_sq_coef, red, bcast);
  write_result(P, 0, 0, lead, res);
  if (res.used == 0) grid.sync();  // dT came after the solve's only barrier

  // --- cl rhs coupling + solve ---
  // dt is read where a coupling pass uses it: held over a solve, it would
  // take a register there
  T dt = dt_of(P, 0);
  for (int k = first; k < n; k += stride) {
    const T coup = P.C_clT.apply_of(dT_at, k);
    P.rhs[k] = (__ldg(P.base_cl + k) + dt * coup) * __ldg(mask + k);
  }
  grid.sync();
  res = bicgstab::solve<T>(grid, P.J_cl, bicgstab::ArrayRhs<T>{P.rhs},
                           P.invd_cl, mask, P.dcl, P.W, P.iters,
                           P.tol_sq_coef, red, bcast);
  write_result(P, 0, 1, lead, res);

  // --- cd rhs coupling + solve ---
  dt = dt_of(P, 0);
  for (int k = first; k < n; k += stride) {
    const T coup = P.C_cdT.apply_of(dT_at, k) +
                   __ldg(P.d_cdcl + k) * bicgstab::ld(P.dcl, k);
    P.rhs[k] = (__ldg(P.base_cd + k) + dt * coup) * __ldg(mask + k);
  }
  grid.sync();
  res = bicgstab::solve<T>(grid, P.J_cd, bicgstab::ArrayRhs<T>{P.rhs},
                           P.invd_cd, mask, P.dcd, P.W, P.iters,
                           P.tol_sq_coef, red, bcast);
  write_result(P, 0, 2, lead, res);
}

// A batch: the same sequence, each system on its share of the grid with its
// own arrays, dt and scalars (solve_batched); every block meets every
// barrier, so a condition for a grid sync must be the same in all of them.
template <typename T>
__device__ __forceinline__ void triple_batched(cg::grid_group& grid,
                                               const TripleParams<T>& P,
                                               T* red, T* bcast) {
  const bicgstab::Share sh = bicgstab::Share::of(P.nsys);
  const int n = P.J_T.size();
  const size_t off = static_cast<size_t>(sh.sys) * n;
  const int stride = sh.per * kThreads;
  const int first =
      (static_cast<int>(blockIdx.x) - sh.sys * sh.per) * kThreads + threadIdx.x;
  const bool lead = first == 0;
  const T* __restrict__ mask = P.mask + off;
  const bicgstab::Work<T> W = P.W.offset(off);
  T* rhs = P.rhs + off;
  const T* dT = P.dT + off;
  const T* dcl = P.dcl + off;
  const auto dT_at = [dT](int m) { return bicgstab::ld(dT, m); };
  const Stencil5Op<T> C_clT = P.C_clT.offset(off);
  const Stencil5Op<T> C_cdT = P.C_cdT.offset(off);

  // --- T solve, its rhs formed in its first pass ---
  bicgstab::Result<T> res = bicgstab::solve_batched<T>(
      grid, P.J_T.offset(off), MaskedRhs<T>{P.rhs_T + off, mask, rhs},
      P.invd_T + off, mask, P.dT + off, W, P.iters, P.tol_sq_coef, red, bcast,
      sh);
  write_result(P, sh.sys, 0, lead, res);
  if (!res.looped) grid.sync();  // every dT came after the only barrier

  // --- cl rhs coupling + solve ---
  T dt = dt_of(P, sh.sys);
  for (int k = first; k < n; k += stride) {
    const T coup = C_clT.apply_of(dT_at, k);
    rhs[k] = (__ldg(P.base_cl + off + k) + dt * coup) * __ldg(mask + k);
  }
  grid.sync();
  res = bicgstab::solve_batched<T>(grid, P.J_cl.offset(off),
                                   bicgstab::ArrayRhs<T>{rhs}, P.invd_cl + off,
                                   mask, P.dcl + off, W, P.iters,
                                   P.tol_sq_coef, red, bcast, sh);
  write_result(P, sh.sys, 1, lead, res);

  // --- cd rhs coupling + solve ---
  dt = dt_of(P, sh.sys);
  for (int k = first; k < n; k += stride) {
    const T coup = C_cdT.apply_of(dT_at, k) +
                   __ldg(P.d_cdcl + off + k) * bicgstab::ld(dcl, k);
    rhs[k] = (__ldg(P.base_cd + off + k) + dt * coup) * __ldg(mask + k);
  }
  grid.sync();
  res = bicgstab::solve_batched<T>(grid, P.J_cd.offset(off),
                                   bicgstab::ArrayRhs<T>{rhs}, P.invd_cd + off,
                                   mask, P.dcd + off, W, P.iters,
                                   P.tol_sq_coef, red, bcast, sh);
  write_result(P, sh.sys, 2, lead, res);
}

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    triple_solve_kernel(TripleParams<T> P) {
  cg::grid_group grid = cg::this_grid();
  constexpr int kSlots = kBatched ? bicgstab::kBatchSlotsPerBarrier
                                  : bicgstab::kMaxSlotsPerBarrier;
  __shared__ T red[kSlots * kWarps];
  __shared__ T bcast[(kBatched ? bicgstab::kMaxBatch : 1) * kSlots];
  if constexpr (kBatched) {
    triple_batched(grid, P, red, bcast);
  } else {
    triple_one(grid, P, red, bcast);
  }
}

template <typename T>
Stencil5Op<T> op_at(const void* const* planes, int first, int n0, int n1) {
  const T* const* p = reinterpret_cast<const T* const*>(planes) + first;
  return Stencil5Op<T>{p[0], p[1], p[2], p[3], p[4], n0, n1};
}

// `in` holds the 33 input planes in the TPU kernel's order: J_T, J_cl, J_cd,
// C_clT, C_cdT (c0, cxm, cxp, cym, cyp each), d_cdcl, rhs_T, base_cl,
// base_cd, invd_T, invd_cl, invd_cd, mask, each holding nsys systems of
// n0 x n1 points one after another.  `out` holds dT, dcl, dcd (likewise);
// `iters_out` three counts a system; `scalars` res[nsys][3] then
// tol_sq[nsys][3]; `work` the eight scratch stacks.  dt_sys, when not null,
// holds one dt a system on the device, in place of dt.  `blocks` is a
// multiple of nsys (triple_solve_blocks_*).
template <typename T>
int launch(const void* const* in, void* const* out, int* iters_out,
           void* scalars, void* work, void* partials, int nsys, int n0,
           int n1, int iters, double tol_sq_coef, double dt,
           const double* dt_sys, int blocks, void* stream) {
  if (nsys < 1 || nsys > bicgstab::kMaxBatch || blocks % nsys != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* const* p = reinterpret_cast<const T* const*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
  const size_t n = static_cast<size_t>(nsys) * n0 * n1;
  T* w = static_cast<T*>(work);
  T* s = static_cast<T*>(scalars);
  TripleParams<T> P{op_at<T>(in, 0, n0, n1),
                    op_at<T>(in, 5, n0, n1),
                    op_at<T>(in, 10, n0, n1),
                    op_at<T>(in, 15, n0, n1),
                    op_at<T>(in, 20, n0, n1),
                    p[25],
                    p[26],
                    p[27],
                    p[28],
                    p[29],
                    p[30],
                    p[31],
                    p[32],
                    o[0],
                    o[1],
                    o[2],
                    iters_out,
                    s,
                    s + 3 * nsys,
                    w + bicgstab::kWorkArrays * n,
                    bicgstab::make_work(w, n, static_cast<T*>(partials)),
                    iters,
                    tol_sq_coef,
                    dt,
                    dt_sys,
                    nsys};
  if (nsys == 1)
    return bicgstab::launch_cooperative(triple_solve_kernel<T, false>, P,
                                        blocks, stream);
  return bicgstab::launch_cooperative(triple_solve_kernel<T, true>, P, blocks,
                                      stream);
}

// The cooperative grid for nsys systems of n points: the triple kernel
// holds more pointers and registers than K1, so its grid comes from its own
// occupancy, at two points a thread, divided among the systems.
template <typename T>
int grid_blocks(int n, int nsys, int* blocks) {
  if (nsys == 1)
    return bicgstab::grid_blocks_of(triple_solve_kernel<T, false>, n, blocks,
                                    kPointsPerThread);
  return bicgstab::grid_blocks_of(triple_solve_kernel<T, true>, n, blocks,
                                  kPointsPerThread, nsys);
}

}  // namespace

extern "C" {

int triple_solve_input_planes() { return kInputPlanes; }

int triple_solve_num_slots() { return bicgstab::kNumSlots; }

int triple_solve_work_planes() { return kScratchPlanes; }

int triple_solve_blocks_f64(int n, int nsys, int* blocks) {
  return grid_blocks<double>(n, nsys, blocks);
}

int triple_solve_blocks_f32(int n, int nsys, int* blocks) {
  return grid_blocks<float>(n, nsys, blocks);
}

int triple_solve_f64(const void* const* in, void* const* out, int* iters_out,
                     void* scalars, void* work, void* partials, int nsys,
                     int n0, int n1, int iters, double tol_sq_coef, double dt,
                     const double* dt_sys, int blocks, void* stream) {
  return launch<double>(in, out, iters_out, scalars, work, partials, nsys, n0,
                        n1, iters, tol_sq_coef, dt, dt_sys, blocks, stream);
}

int triple_solve_f32(const void* const* in, void* const* out, int* iters_out,
                     void* scalars, void* work, void* partials, int nsys,
                     int n0, int n1, int iters, double tol_sq_coef, double dt,
                     const double* dt_sys, int blocks, void* stream) {
  return launch<float>(in, out, iters_out, scalars, work, partials, nsys, n0,
                       n1, iters, tol_sq_coef, dt, dt_sys, blocks, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
