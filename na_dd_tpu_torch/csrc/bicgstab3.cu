// K5: a whole Jacobi-preconditioned BiCGStab solve of a Stencil7 system in
// one persistent cooperative kernel, for Hopper (sm_90a).
//
// Replaces: bicgstab_solve3_pallas, na_dd_tpu/ops/pallas_kernels.py:702
// (body _make_bicgstab3_kernel :661, an in-kernel fori_loop over
// _bicgstab_inline :83).  The solve body, its contract and its design are in
// bicgstab.cuh, shared with K1; this file gives it the 7-point operator.  The
// TPU kernel's single-VMEM-block limit (fused_solve3_fits :688, N <= 31) is a
// Mosaic budget: this kernel solves at every N.
//
// Bound on the card: bytes, and at small N latency.  An iteration makes
// three passes (bicgstab.cuh) that touch 36 volume-sized arrays (14, 11 and
// 11: the seven coefficient volumes twice, r, p, v, inv_diag and the
// neighbours' values from L1/L2) at roughly one operation per byte, and
// three grid-wide barriers; iteration 0 touches 31 (p, v and x are zero).
// Two regimes:
//   N=64 (65^3, 2.2 MB a volume in f64): the 18 working volumes (~40 MB)
//     fit the 50 MB L2, so an iteration is served mostly from L2 and the
//     barriers weigh about a fifth of it (30 us an iteration on the H100,
//     ~2.2 us a barrier; PERF.md);
//   N=128 (129^3, 17.2 MB a volume): they do not (~310 MB), so each
//     iteration streams its volumes from HBM (~620 MB, ~185 us at
//     3.35 TB/s; 235 us measured); the +-x neighbours, 133 KB apart, come
//     from L2, since the grid sweeps a few x-planes at a time.
// Each input must come from device memory once per solve: 11 volumes (b,
// seven coefficients, inv_diag, mask, and x written), 24.2 MB at N=64 and
// 188.9 MB at N=128.
//
// A batch of nsys volumes of one shape, one after another in every array (the
// leading dimension of the wrapper's operands), is solved in the same launch
// (bicgstab.cuh, Batch); iters_out holds one count a system.
#include <cuda_runtime.h>

#include "bicgstab.cuh"
#include "stencil7.cuh"

namespace {

// The 7-point operator on an (n0, n1, n2) volume, flat index
// k = (i * n1 + j) * n2 + l.
template <typename T>
struct Stencil7Op {
  const T* c0;
  const T* cxm;
  const T* cxp;
  const T* cym;
  const T* cyp;
  const T* czm;
  const T* czp;
  int n0;
  int n1;
  int n2;

  __host__ __device__ int size() const { return n0 * n1 * n2; }

  // The operator of the volume `off` points further on (a batch's next
  // system).
  __device__ Stencil7Op offset(size_t off) const {
    return Stencil7Op{c0 + off,  cxm + off, cxp + off, cym + off,
                      cyp + off, czm + off, czp + off, n0,
                      n1,        n2};
  }

  template <class U>
  __device__ __forceinline__ T apply_of(U u, int k) const {
    return stencil7_of<T>(u, c0, cxm, cxp, cym, cyp, czm, czp, k, n0, n1, n2);
  }
};

template <typename T>
int solve(const T* b, const T* c0, const T* cxm, const T* cxp, const T* cym,
          const T* cyp, const T* czm, const T* czp, const T* inv_diag,
          const T* mask, T* x, int* iters_out, T* work, T* partials, int nsys,
          int n0, int n1, int n2, int iters, double tol_sq_coef, int blocks,
          void* stream) {
  const Stencil7Op<T> A{c0, cxm, cxp, cym, cyp, czm, czp, n0, n1, n2};
  return bicgstab::launch<T>(A, b, inv_diag, mask, x, iters_out, work,
                             partials, nsys, iters, tol_sq_coef, blocks,
                             stream);
}

}  // namespace

extern "C" {

int bicgstab3_num_slots() { return bicgstab::kNumSlots; }

int bicgstab3_work_volumes() { return bicgstab::kWorkArrays; }

int bicgstab3_max_batch() { return bicgstab::kMaxBatch; }

int bicgstab3_blocks_f64(int n, int nsys, int* blocks) {
  return bicgstab::grid_blocks<double, Stencil7Op<double>>(n, nsys, blocks);
}

int bicgstab3_blocks_f32(int n, int nsys, int* blocks) {
  return bicgstab::grid_blocks<float, Stencil7Op<float>>(n, nsys, blocks);
}

int bicgstab3_solve_f64(const double* b, const double* c0, const double* cxm,
                        const double* cxp, const double* cym,
                        const double* cyp, const double* czm,
                        const double* czp, const double* inv_diag,
                        const double* mask, double* x, int* iters_out,
                        double* work, double* partials, int nsys, int n0,
                        int n1, int n2, int iters, double tol_sq_coef,
                        int blocks, void* stream) {
  return solve<double>(b, c0, cxm, cxp, cym, cyp, czm, czp, inv_diag, mask, x,
                       iters_out, work, partials, nsys, n0, n1, n2, iters,
                       tol_sq_coef, blocks, stream);
}

int bicgstab3_solve_f32(const float* b, const float* c0, const float* cxm,
                        const float* cxp, const float* cym, const float* cyp,
                        const float* czm, const float* czp,
                        const float* inv_diag, const float* mask, float* x,
                        int* iters_out, float* work, float* partials, int nsys,
                        int n0, int n1, int n2, int iters, double tol_sq_coef,
                        int blocks, void* stream) {
  return solve<float>(b, c0, cxm, cxp, cym, cyp, czm, czp, inv_diag, mask, x,
                      iters_out, work, partials, nsys, n0, n1, n2, iters,
                      tol_sq_coef, blocks, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
