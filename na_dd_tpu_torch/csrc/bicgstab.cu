// K1: a whole Jacobi-preconditioned BiCGStab solve of a Stencil5 system in
// one persistent cooperative kernel, for Hopper (sm_90a).
//
// Replaces: bicgstab_solve_pallas, na_dd_tpu/ops/pallas_kernels.py:342
// (body _make_bicgstab_kernel :61 and _bicgstab_inline :83).  The solve
// body, its contract and its design are in bicgstab.cuh, shared with K5;
// this file gives it the 5-point operator (Stencil5Op, stencil5.cuh).
//
// Bound on the card: bytes and latency, not operations.  An iteration makes
// three passes (bicgstab.cuh) that touch 32 plane-sized arrays (12, 9 and
// 11: the five coefficient planes twice, r, p, v, inv_diag and the
// neighbours' values from L1/L2) at roughly one operation per byte, and
// three grid-wide barriers; iteration 0 touches 27 (p, v and x are zero).  At
// N=256 a plane is 528 KB in f64: an iteration streams ~16.9 MB, 5.0 us at
// the HBM rate, while the ~8.5 MB working set stays in the 50 MB L2; each
// input must come from device memory once per solve (4.76 MB, 1.4 us).
// Measured on the H100 (PERF.md): 12.5 us an iteration, of which ~2.5 us is
// each barrier, and almost no fixed cost; at the one to three iterations a
// main-path solve takes, the barriers cost about as much as the streaming.
//
// A batch of nsys planes of one shape, one after another in every array (the
// leading dimension of the wrapper's operands), is solved in the same launch
// (bicgstab.cuh, Batch); iters_out holds one count a system.
#include <cuda_runtime.h>

#include "bicgstab.cuh"
#include "stencil5.cuh"

namespace {

template <typename T>
int solve(const T* b, const T* c0, const T* cxm, const T* cxp, const T* cym,
          const T* cyp, const T* inv_diag, const T* mask, T* x, int* iters_out,
          T* work, T* partials, int nsys, int n0, int n1, int iters,
          double tol_sq_coef, int blocks, void* stream) {
  const Stencil5Op<T> A{c0, cxm, cxp, cym, cyp, n0, n1};
  return bicgstab::launch<T>(A, b, inv_diag, mask, x, iters_out, work,
                             partials, nsys, iters, tol_sq_coef, blocks,
                             stream);
}

}  // namespace

extern "C" {

int bicgstab_num_slots() { return bicgstab::kNumSlots; }

int bicgstab_work_planes() { return bicgstab::kWorkArrays; }

int bicgstab_max_batch() { return bicgstab::kMaxBatch; }

int bicgstab_blocks_f64(int n, int nsys, int* blocks) {
  return bicgstab::grid_blocks<double, Stencil5Op<double>>(n, nsys, blocks);
}

int bicgstab_blocks_f32(int n, int nsys, int* blocks) {
  return bicgstab::grid_blocks<float, Stencil5Op<float>>(n, nsys, blocks);
}

int bicgstab_solve_f64(const double* b, const double* c0, const double* cxm,
                       const double* cxp, const double* cym, const double* cyp,
                       const double* inv_diag, const double* mask, double* x,
                       int* iters_out, double* work, double* partials,
                       int nsys, int n0, int n1, int iters, double tol_sq_coef,
                       int blocks, void* stream) {
  return solve<double>(b, c0, cxm, cxp, cym, cyp, inv_diag, mask, x, iters_out,
                       work, partials, nsys, n0, n1, iters, tol_sq_coef,
                       blocks, stream);
}

int bicgstab_solve_f32(const float* b, const float* c0, const float* cxm,
                       const float* cxp, const float* cym, const float* cyp,
                       const float* inv_diag, const float* mask, float* x,
                       int* iters_out, float* work, float* partials, int nsys,
                       int n0, int n1, int iters, double tol_sq_coef,
                       int blocks, void* stream) {
  return solve<float>(b, c0, cxm, cxp, cym, cyp, inv_diag, mask, x, iters_out,
                      work, partials, nsys, n0, n1, iters, tol_sq_coef, blocks,
                      stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
