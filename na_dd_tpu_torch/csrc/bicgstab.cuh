// The whole Jacobi-preconditioned BiCGStab solve as one persistent
// cooperative kernel, templated on the stencil operator.  Shared by K1
// (bicgstab.cu, a 5-point Stencil5 system), K5 (bicgstab3.cu, a 7-point
// Stencil7 system) and K4 (triple_solve.cu, three Stencil5 solves in one
// launch); the operator supplies size() and apply(u, k), the stencil at flat
// index k with zero inflow.  The solve itself is the __device__ function
// solve() of a cooperative grid; bicgstab_kernel wraps one call of it.
//
// It computes exactly _bicgstab_inline of na_dd_tpu/ops/pallas_kernels.py
// (:83) with x0 = 0: the masked-early-exit update of bicgstab_unrolled,
// iters_used counting only the iterations taken while not done,
// done = s_conv | breakdown | (r.r <= tol_sq), safe_div guarded by
// |den| > 1e-300 cast to the dtype (0 in float32, so the float guard is
// |den| > 0), and the output x * mask.
//
// Design: the TPU kernels kept every iterate in one core's VMEM; here one
// plane or volume alone exceeds an SM's 227 KB of shared memory, so the
// solve is spread over the whole card instead.  One cooperative launch, grid
// sized to the blocks that can be co-resident; grid-stride loops over the
// points (each thread always owns the same points, so r, p, v, x, t need no
// cross-block visibility); cooperative_groups grid syncs between the phases
// that need a neighbour's value or a global dot.  Every dot product is
// deterministic: each block writes one partial sum, and after the sync every
// block sums all partials in the same fixed order, so all blocks hold
// bit-identical scalars and take the same `done` branch — which makes a real
// `break` on done safe and equal to the masked fixed budget.  Neighbour reads
// of p^ and s^ and the partials go through __ldcg (L2) because other blocks
// wrote them in this launch.  The rhs b (also the shadow residual r^) is only
// ever read at a thread's own points: through the read-only path when it is
// an input of the launch, with plain loads when the same thread wrote it
// earlier in the launch (K4's coupled right-hand sides).  Scratch (six
// working arrays and the partials) is allocated by the caller.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace bicgstab {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWorkArrays = 6;

// dot-product slots in the partials array (slot * gridDim.x + block)
enum Slot { kBB = 0, kRR, kRhatR, kRhatV, kSS, kTS, kTT, kNumSlots };

// The six working arrays of a solve and the dot-product partials.
template <typename T>
struct Work {
  T* r;  // holds s within an iteration
  T* p;
  T* v;
  T* phat;
  T* shat;
  T* t;
  T* partials;  // kNumSlots * gridDim.x
};

// `work` holds the six working arrays of n points each.
template <typename T>
Work<T> make_work(T* work, size_t n, T* partials) {
  return Work<T>{work,         work + n,     work + 2 * n, work + 3 * n,
                 work + 4 * n, work + 5 * n, partials};
}

// What a solve leaves behind, the same in every thread of the grid:
// iterations taken while not done, the recurrence residual r.r at exit and
// tol_sq = tol^2 (b.b).
template <typename T>
struct Result {
  int used;
  T rr;
  T tol_sq;
};

template <typename T, class Op>
struct Params {
  Op A;        // the stencil operator (its coefficient arrays and shape)
  const T* b;  // rhs; also r^ (the shadow residual, r0 = b with x0 = 0)
  const T* inv_diag;
  const T* mask;
  T* x;
  int* iters_out;
  Work<T> W;
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

// Block sum of v, written by thread 0 into the block's slot of `partials`.
template <typename T>
__device__ void store_partial(T v, T* partials, int slot, T* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? red[lane] : T(0);
    w = warp_sum(w);
    if (lane == 0) partials[slot * gridDim.x + blockIdx.x] = w;
  }
  __syncthreads();
}

// Sum of all blocks' partials of `slot`, in one fixed order: every block gets
// the bit-identical value.
template <typename T>
__device__ T grid_total(const T* partials, int slot, T* bcast) {
  if (threadIdx.x < 32) {
    T v = T(0);
    for (int k = threadIdx.x; k < static_cast<int>(gridDim.x); k += 32)
      v += __ldcg(partials + slot * gridDim.x + k);
    v = warp_sum(v);
    if (threadIdx.x == 0) *bcast = v;
  }
  __syncthreads();
  const T out = *bcast;
  __syncthreads();
  return out;
}

// The rhs at a thread's own point k: the read-only path for an input of the
// launch, a plain load for a value this thread wrote earlier in the launch.
template <typename T, bool kRhsIsInput>
__device__ __forceinline__ T load_rhs(const T* b, int k) {
  if (kRhsIsInput) return __ldg(b + k);
  return b[k];
}

// One whole solve A x = b from x0 = 0 by every thread of the cooperative
// grid; x comes out multiplied by mask.  `red` (kWarps values) and `bcast`
// are the block's shared scratch.  Ends without a grid sync: a caller that
// reads x at a neighbour's point, or starts another solve on the same
// partials, syncs first.
template <typename T, class Op, bool kRhsIsInput>
__device__ __forceinline__ Result<T> solve(cg::grid_group& grid, const Op& A,
                                           const T* b, const T* inv_diag_in,
                                           const T* mask, T* x,
                                           const Work<T>& W, int iters,
                                           double tol_sq_coef, T* red,
                                           T* bcast) {
  const int n = A.size();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const T* __restrict__ inv_diag = inv_diag_in;

  // x0 = 0  =>  r0 = b = r^, p = v = 0
  T acc = T(0);
  for (int k = first; k < n; k += stride) {
    const T bk = load_rhs<T, kRhsIsInput>(b, k);
    x[k] = T(0);
    W.r[k] = bk;
    W.p[k] = T(0);
    W.v[k] = T(0);
    acc += bk * bk;
  }
  store_partial(acc, W.partials, kBB, red);
  grid.sync();
  const T bb = grid_total(W.partials, kBB, bcast);
  const T tol_sq = static_cast<T>(tol_sq_coef) * bb;
  T rr = bb;     // r.r
  T rhat_r = bb; // r^.r
  T rho = T(1), alpha = T(1), omega = T(1);
  bool done = rr <= tol_sq;
  int used = 0;

  for (int it = 0; it < iters && !done; ++it) {
    bool ok1, ok2, ok3, ok4;
    const T rho1 = rhat_r;
    const T ratio = safe_div(rho1, rho, &ok1);
    const T aw = safe_div(alpha, omega, &ok2);
    const T beta = ratio * aw;

    // p = r + beta (p - omega v);  p^ = p * inv_diag
    for (int k = first; k < n; k += stride) {
      const T pk = W.r[k] + beta * (W.p[k] - omega * W.v[k]);
      W.p[k] = pk;
      W.phat[k] = pk * __ldg(inv_diag + k);
    }
    grid.sync();

    // v = A p^;  r^.v
    acc = T(0);
    for (int k = first; k < n; k += stride) {
      const T vk = A.apply(W.phat, k);
      W.v[k] = vk;
      acc += load_rhs<T, kRhsIsInput>(b, k) * vk;
    }
    store_partial(acc, W.partials, kRhatV, red);
    grid.sync();
    const T alpha_new =
        safe_div(rho1, grid_total(W.partials, kRhatV, bcast), &ok3);

    // s = r - alpha v (kept in r);  s^ = s * inv_diag;  s.s
    acc = T(0);
    for (int k = first; k < n; k += stride) {
      const T sk = W.r[k] - alpha_new * W.v[k];
      W.r[k] = sk;
      W.shat[k] = sk * __ldg(inv_diag + k);
      acc += sk * sk;
    }
    store_partial(acc, W.partials, kSS, red);
    grid.sync();
    const bool s_conv = grid_total(W.partials, kSS, bcast) <= tol_sq;

    // t = A s^;  t.s and t.t
    acc = T(0);
    T acc2 = T(0);
    for (int k = first; k < n; k += stride) {
      const T tk = A.apply(W.shat, k);
      W.t[k] = tk;
      acc += tk * W.r[k];
      acc2 += tk * tk;
    }
    store_partial(acc, W.partials, kTS, red);
    store_partial(acc2, W.partials, kTT, red);
    grid.sync();
    const T ts = grid_total(W.partials, kTS, bcast);
    const T tt = grid_total(W.partials, kTT, bcast);
    const T omega_new = safe_div(ts, tt, &ok4);

    // x = x + alpha p^ (+ omega s^);  r = s (- omega t);  r.r and r^.r
    acc = T(0);
    acc2 = T(0);
    for (int k = first; k < n; k += stride) {
      const T sk = W.r[k];
      const T x_half = x[k] + alpha_new * W.phat[k];
      T xk, rk;
      if (s_conv) {
        xk = x_half;
        rk = sk;
      } else {
        xk = x_half + omega_new * W.shat[k];
        rk = sk - omega_new * W.t[k];
      }
      x[k] = xk;
      W.r[k] = rk;
      acc += rk * rk;
      acc2 += load_rhs<T, kRhsIsInput>(b, k) * rk;
    }
    store_partial(acc, W.partials, kRR, red);
    store_partial(acc2, W.partials, kRhatR, red);
    grid.sync();
    rr = grid_total(W.partials, kRR, bcast);
    rhat_r = grid_total(W.partials, kRhatR, bcast);

    const bool breakdown = !(ok1 && ok2 && ok3 && ok4);
    rho = rho1;
    alpha = alpha_new;
    omega = omega_new;
    ++used;
    done = s_conv || breakdown || rr <= tol_sq;
  }

  for (int k = first; k < n; k += stride) x[k] *= __ldg(mask + k);
  return Result<T>{used, rr, tol_sq};
}

template <typename T, class Op>
__global__ void __launch_bounds__(kThreads) bicgstab_kernel(Params<T, Op> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T red[kWarps];
  __shared__ T bcast;
  const Result<T> res =
      solve<T, Op, true>(grid, P.A, P.b, P.inv_diag, P.mask, P.x, P.W, P.iters,
                         P.tol_sq_coef, red, &bcast);
  if (blockIdx.x == 0 && threadIdx.x == 0) *P.iters_out = res.used;
}

// Cooperative grid size of `kernel` for n points: the blocks that can be
// co-resident, capped by the blocks n needs.
template <class Kernel>
int grid_blocks_of(Kernel kernel, int n, int* blocks) {
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
  const int need = (n + kThreads - 1) / kThreads;
  const int cap = per_sm * sms;
  *blocks = need < cap ? need : cap;
  return static_cast<int>(cudaSuccess);
}

template <typename T, class Op>
int grid_blocks(int n, int* blocks) {
  return grid_blocks_of(bicgstab_kernel<T, Op>, n, blocks);
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

// `work` holds the six working arrays of A.size() points each.
template <typename T, class Op>
int launch(const Op& A, const T* b, const T* inv_diag, const T* mask, T* x,
           int* iters_out, T* work, T* partials, int iters,
           double tol_sq_coef, int blocks, void* stream) {
  Params<T, Op> P{A,
                  b,
                  inv_diag,
                  mask,
                  x,
                  iters_out,
                  make_work(work, static_cast<size_t>(A.size()), partials),
                  iters,
                  tol_sq_coef};
  return launch_cooperative(bicgstab_kernel<T, Op>, P, blocks, stream);
}

}  // namespace bicgstab
