// Fused affine-coupling transform for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nessai_tpu/ops/coupling_pallas.py
// (affine_coupling_transform, pallas_call at line 56). Per row i of
// [n, d] float32 inputs x, raw_s, t:
//   s_ij  = clamp * tanh(raw_s_ij / clamp)
//   y_ij  = x_ij * exp(s_ij) + t_ij          (forward)
//   y_ij  = (x_ij - t_ij) * exp(-s_ij)        (inverse)
//   ld_i  = +/- sum_j s_ij
//
// Bound on the card: bytes. The function reads 3*n*d and writes n*d + n
// floats, 4*n*(4*d + 1) bytes, a few dozen operations per element, so it
// is far below the operations-per-byte line. At the flagship's shapes
// (d = 1, n ~ 1e3..3e4) the byte bound is nanoseconds and the launch
// latency sets the time. Design: a grid-stride loop with one thread per
// row and a sequential loop over the d columns, so the row sum needs no
// cross-thread reduction and consecutive threads read consecutive rows
// (coalesced for d = 1, the flagship's width). The kernel allocates
// nothing and does not synchronise; tanhf/expf are the accurate
// functions (no fast-math), which the tolerances against the plain
// PyTorch version rely on.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void affine_coupling_kernel(const float* __restrict__ x,
                                       const float* __restrict__ raw_s,
                                       const float* __restrict__ t,
                                       float* __restrict__ y,
                                       float* __restrict__ ld,
                                       int64_t n, int d, float clamp,
                                       int inverse) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const int64_t base = row * d;
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float s = clamp * tanhf(raw_s[base + j] / clamp);
      const float xv = x[base + j];
      const float tv = t[base + j];
      y[base + j] = inverse ? (xv - tv) * expf(-s) : xv * expf(s) + tv;
      acc += s;
    }
    ld[row] = inverse ? -acc : acc;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer). Returns the
// cudaError_t of the launch; 0 means success. n = 0 launches nothing.
extern "C" int affine_coupling_launch(const void* x, const void* raw_s,
                                      const void* t, void* y, void* ld,
                                      int64_t n, int d, float clamp,
                                      int inverse, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // enough blocks to fill 132 SMs several times over; the grid-stride
  // loop covers the rest
  const int64_t max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  affine_coupling_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(raw_s),
      static_cast<const float*>(t), static_cast<float*>(y),
      static_cast<float*>(ld), n, d, clamp, inverse);
  return static_cast<int>(cudaGetLastError());
}
