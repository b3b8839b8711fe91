// K6/K7: the 7-point stencil apply for Hopper (sm_90a).
//
// Replaces both 7-point apply kernels of na_dd_tpu/ops/pallas_kernels.py:
//   stencil7_apply_pallas :615 (body _stencil7_kernel :577, shifts
//     _shifted3 :559), a single-block kernel that holds u and the seven
//     coefficient volumes in VMEM (about N <= 55);
//   stencil7_apply_tiled :834 (body _make_stencil7_tiled_kernel :790), the
//     same apply over x-slabs with one-slab halos for the larger cubes.
// The single-block/tiled split and the slab sizing (_pick_slab_tile3 :764,
// apply3_fits :609, apply3_tiled_fits :784) are VMEM budgets; on the card
// one kernel serves every size.
//
// Bound on the card: bytes.  Each output point reads 8 values (u and seven
// coefficients) and writes one, 13 operations for 72 bytes in f64 — far
// below the H100's ratio of peak f64 rate to memory rate.  At N=64 (65^3)
// that is 9 x 65^3 x 8 B = 19.8 MB, 5.9 us at 3.35 TB/s; at N=128 (129^3)
// 154.6 MB, 46.1 us.
//
// Design: one thread per output point over the flat index, so z (the
// contiguous axis) is fastest across threads and every warp's loads of u and
// of the coefficients coalesce with no idle lanes on the ragged 65- or
// 129-wide rows; the neighbour reads at j +- 1 and i +- 1 hit L1/L2 lines
// that neighbouring warps and blocks load.  The faces read zero inflow by
// index.  Nothing is staged in shared memory: the reuse of u is 7x, which
// the caches capture, and the coefficients are read once.
//
// Batch: a stack of nb volumes (the leading dimension jax.vmap gives) in one
// launch, blockIdx.y the volume; each volume is offset on its own and has
// its own zero inflow, so no face of one volume reads the next.
#include <cuda_runtime.h>

#include "stencil7.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) stencil7_apply_kernel(
    const T* __restrict__ u, const T* __restrict__ c0,
    const T* __restrict__ cxm, const T* __restrict__ cxp,
    const T* __restrict__ cym, const T* __restrict__ cyp,
    const T* __restrict__ czm, const T* __restrict__ czp, T* __restrict__ out,
    int n0, int n1, int n2) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n0 * n1 * n2) return;
  const size_t off = static_cast<size_t>(blockIdx.y) * n0 * n1 * n2;
  out[off + k] = stencil7_at<T, false>(u + off, c0 + off, cxm + off, cxp + off,
                                       cym + off, cyp + off, czm + off,
                                       czp + off, k, n0, n1, n2);
}

template <typename T>
int launch(const T* u, const T* c0, const T* cxm, const T* cxp, const T* cym,
           const T* cyp, const T* czm, const T* czp, T* out, int nb, int n0,
           int n1, int n2, void* stream) {
  const int n = n0 * n1 * n2;
  const dim3 blocks((n + kThreads - 1) / kThreads, nb);
  stencil7_apply_kernel<T>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          u, c0, cxm, cxp, cym, cyp, czm, czp, out, n0, n1, n2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stencil7_apply_f64(const double* u, const double* c0, const double* cxm,
                       const double* cxp, const double* cym, const double* cyp,
                       const double* czm, const double* czp, double* out,
                       int nb, int n0, int n1, int n2, void* stream) {
  return launch<double>(u, c0, cxm, cxp, cym, cyp, czm, czp, out, nb, n0, n1,
                        n2, stream);
}

int stencil7_apply_f32(const float* u, const float* c0, const float* cxm,
                       const float* cxp, const float* cym, const float* cyp,
                       const float* czm, const float* czp, float* out, int nb,
                       int n0, int n1, int n2, void* stream) {
  return launch<float>(u, c0, cxm, cxp, cym, cyp, czm, czp, out, nb, n0, n1,
                       n2, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
