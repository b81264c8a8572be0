// Affine-coupling layer for Hopper (sm_90a): the forward/inverse kernel
// and its backward kernel.
//
// Replaces the Pallas TPU kernel nessai_tpu/ops/coupling_pallas.py
// (affine_coupling_transform, pallas_call at line 56) together with the
// column gather and scatter around it in nessai_tpu/flows/bijectors.py
// (AffineCoupling._pallas_transform and _scatter, lines 207-218), and the
// backward of its training wrapper (_ac_bwd, line 112: jax.vjp of the jnp
// reference). For x [n, D], the conditioner output out = [raw_s | t]
// [n, 2 n_tr] and the transformed columns c_j = transform_idx[j]
// (increasing), row by row:
//   s_j   = clamp * tanh(raw_s_j / clamp)
//   y_c   = x_c                              (identity column c)
//   y_c_j = x_c_j * exp(s_j) + t_j           (forward)
//   y_c_j = (x_c_j - t_j) * exp(-s_j)        (inverse)
//   ld    = +/- sum_j s_j
// The bare transform (x, raw_s, t) [n, d] -> (y, ld) is the case with
// every column transformed (transform_idx null, c_j = j).
//
// What bounds it on the card: bytes, 4 n (2 D + 2 n_tr + 1) forward, at
// a few dozen operations per transformed element. At the flagship's
// shape (n = 900, D = 2) that is 0.01 us, and a launch costs about 1.4 us:
// there the time goes to launches. Done with library ops around a bare
// transform, the layer takes seven launches forward (gathers of x, copies
// of the strided halves of out, a concatenation and a scatter) and some
// forty backward. The design therefore does the layer in one launch each
// way:
// - one group of G lanes per row (G a power of two, at most 32), lane q
//   on VEC consecutive columns (VEC = 4, with 16-byte loads and stores,
//   where D % 4 == 0 and the rows are aligned), so neighbouring lanes read
//   neighbouring addresses; identity columns are copied, transformed ones
//   mapped; raw_s and t are read through out's row stride (no copy);
// - each block builds the column map (column -> j, or -1) from
//   transform_idx in shared memory;
// - ld: every lane takes each column's tanh by __shfl_sync in column
//   order and adds clamp * tanh into a float sum from +0 without FMA, the
//   rounding of a sequential loop over the row; no atomics, so a launch
//   gives the same bits every time. The row loop is per warp, so every
//   lane of a warp runs every shuffle; lanes past n compute on stand-ins
//   and store nothing;
// - blocks of 128 threads (n = 900 spreads over 15 SMs), at most 16 a
//   SM (the SM count from cudaDeviceGetAttribute), a grid-stride loop
//   beyond.
// The backward is the same mapping without a reduction. It recomputes s
// (and, for the inverse, y) instead of saving y, and writes g_x [n, D]
// (identity columns pass g_y through) and g_out = [g_raw | g_t]. Its
// arithmetic is spelt with __fmul_rn/__fadd_rn so nvcc contracts nothing
// into FMA, and it divides by clamp as PyTorch divides a CUDA tensor by a
// Python scalar (a product with the float reciprocal): it rounds as the
// op sequence it replaces (affine_coupling_backward_plain in
// ops/coupling.py) does on the card. tanhf/expf are the accurate
// functions (no fast-math).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <int VEC>
__device__ __forceinline__ void load(float (&v)[VEC], const float* p) {
  if (VEC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = p[k];
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&v)[VEC]) {
  if (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

// column[c] = j for c = transform_idx[j], -1 for an identity column (an
// index outside [0, D) is dropped rather than written out of bounds)
__device__ __forceinline__ void build_column_map(int* column,
                                                 const int* transform_idx,
                                                 int D, int n_tr) {
  for (int c = threadIdx.x; c < D; c += blockDim.x) column[c] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < n_tr; j += blockDim.x) {
    const int c = transform_idx[j];
    if (c >= 0 && c < D) column[c] = j;
  }
  __syncthreads();
}

// ALL: every column transformed with j = c (the bare transform), no map,
// and raw_s and t read VEC at a time as x is.
template <int VEC, bool ALL>
__global__ void __launch_bounds__(kThreads)
affine_coupling_kernel(const float* __restrict__ x, int64_t sx,
                       const float* __restrict__ raw, int64_t sr,
                       const float* __restrict__ t, int64_t st,
                       float* __restrict__ y, float* __restrict__ ld,
                       const int* __restrict__ transform_idx, int64_t n,
                       int D, int n_tr, int G, float clamp, int inverse) {
  extern __shared__ int column[];
  if (!ALL) build_column_map(column, transform_idx, D, n_tr);
  const int lane = threadIdx.x & 31;
  const int q = lane & (G - 1);
  const int rows_per_warp = 32 / G;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t first = warp * rows_per_warp; first < n; first += warps * rows_per_warp) {
    const int64_t row = first + lane / G;
    const bool live = row < n;
    float acc = 0.0f;
    for (int c0 = 0; c0 < D; c0 += G * VEC) {
      const int c = c0 + q * VEC;
      // D % VEC == 0, so c < D holds the lane's VEC columns
      const bool here = live && c < D;
      float xv[VEC], rv[VEC], tv[VEC], th[VEC];
      int j[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        xv[k] = rv[k] = tv[k] = th[k] = 0.0f;
        j[k] = -1;
      }
      if (here) {
        load<VEC>(xv, x + row * sx + c);
        if (ALL) {
          load<VEC>(rv, raw + row * sr + c);
          load<VEC>(tv, t + row * st + c);
#pragma unroll
          for (int k = 0; k < VEC; ++k) j[k] = c + k;
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            j[k] = column[c + k];
            if (j[k] >= 0) {
              rv[k] = raw[row * sr + j[k]];
              tv[k] = t[row * st + j[k]];
            }
          }
        }
        float yv[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          yv[k] = xv[k];
          if (j[k] >= 0) {
            th[k] = tanhf(rv[k] / clamp);
            const float s = __fmul_rn(clamp, th[k]);
            yv[k] = inverse ? __fmul_rn(__fsub_rn(xv[k], tv[k]), expf(-s))
                            : __fmaf_rn(xv[k], expf(s), tv[k]);
          }
        }
        store<VEC>(y + row * D + c, yv);
      }
      // the row sum in column order, every lane in every shuffle. An
      // identity column or one past D adds clamp * 0 = +0, which leaves
      // the sum as it is: it starts at +0 and so is never -0
      for (int p = 0; p < G; ++p) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float th_p = __shfl_sync(kFull, th[k], p, G);
          acc = __fadd_rn(acc, __fmul_rn(clamp, th_p));
        }
      }
    }
    if (live && q == 0) ld[row] = inverse ? -acc : acc;
  }
}

// Gradients of the layer for the cotangents g_y (null: none) and g_ld
// (null: none); g_x may be null (x needs no gradient).
template <int VEC, bool ALL>
__global__ void __launch_bounds__(kThreads)
affine_coupling_backward_kernel(
    const float* __restrict__ x, int64_t sx, const float* __restrict__ raw,
    int64_t sr, const float* __restrict__ t, int64_t st,
    const float* __restrict__ gy, int64_t sgy, const float* __restrict__ gld,
    int64_t sgld, float* __restrict__ gx, float* __restrict__ graw, int64_t sgr,
    float* __restrict__ gt, int64_t sgt, const int* __restrict__ transform_idx,
    int64_t n, int D, int n_tr, int G, float clamp, float inv_clamp,
    int inverse) {
  extern __shared__ int column[];
  if (!ALL) build_column_map(column, transform_idx, D, n_tr);
  const int q = threadIdx.x & (G - 1);
  const int64_t rows = (static_cast<int64_t>(gridDim.x) * blockDim.x) / G;
  for (int64_t row = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
       row < n; row += rows) {
    const float gl = gld ? gld[row * sgld] : 0.0f;
    for (int c = q * VEC; c < D; c += G * VEC) {
      float xv[VEC], rv[VEC], tv[VEC], gv[VEC], gxv[VEC], grv[VEC], gtv[VEC];
      int j[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        xv[k] = rv[k] = tv[k] = gv[k] = 0.0f;
        j[k] = ALL ? c + k : column[c + k];
      }
      if (gy) load<VEC>(gv, gy + row * sgy + c);
      load<VEC>(xv, x + row * sx + c);
      if (ALL) {
        load<VEC>(rv, raw + row * sr + c);
        if (inverse) load<VEC>(tv, t + row * st + c);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (j[k] >= 0) {
            rv[k] = raw[row * sr + j[k]];
            if (inverse) tv[k] = t[row * st + j[k]];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        gxv[k] = gv[k];
        if (j[k] < 0) continue;
        const float g = gv[k];
        const float th = tanhf(__fmul_rn(rv[k], inv_clamp));
        const float s = __fmul_rn(clamp, th);
        const float dtanh = __fsub_rn(1.0f, __fmul_rn(th, th));
        if (inverse) {
          // y as the forward kernel computed it
          const float sf = __fmul_rn(clamp, tanhf(rv[k] / clamp));
          const float yv = __fmul_rn(__fsub_rn(xv[k], tv[k]), expf(-sf));
          gxv[k] = __fmul_rn(g, expf(-s));
          gtv[k] = -gxv[k];
          grv[k] = __fmul_rn(__fsub_rn(__fmul_rn(-g, yv), gl), dtanh);
        } else {
          const float e = expf(s);
          gxv[k] = __fmul_rn(g, e);
          gtv[k] = g;
          grv[k] = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(g, xv[k]), e), gl), dtanh);
        }
      }
      if (gx) store<VEC>(gx + row * D + c, gxv);
      if (ALL) {
        store<VEC>(graw + row * sgr + c, grv);
        store<VEC>(gt + row * sgt + c, gtv);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (j[k] >= 0) {
            graw[row * sgr + j[k]] = grv[k];
            gt[row * sgt + j[k]] = gtv[k];
          }
        }
      }
    }
  }
}

bool aligned(const void* p, int64_t stride) {
  return p == nullptr || ((reinterpret_cast<uintptr_t>(p) & 15) == 0 && stride % 4 == 0);
}

// The launch of a call: VEC columns a lane, G lanes a row, the grid and
// the shared memory of the column map.
struct Shape {
  int vec, G;
  unsigned int blocks;
  size_t smem;
};

cudaError_t shape_for(int64_t n, int D, bool all, bool vec4, Shape* shape) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  shape->vec = vec4 && D % 4 == 0 ? 4 : 1;
  const int lanes = (D + shape->vec - 1) / shape->vec;
  int G = 1;
  while (G < lanes && G < 32) G *= 2;
  shape->G = G;
  const int64_t rows_per_block = kThreads / G;
  const int64_t want = (n + rows_per_block - 1) / rows_per_block;
  const int64_t most = static_cast<int64_t>(sms) * (2048 / kThreads);
  shape->blocks = static_cast<unsigned int>(want < most ? want : most);
  shape->smem = all ? 0 : static_cast<size_t>(D) * sizeof(int);
  return cudaSuccess;
}

typedef void (*ForwardKernel)(const float*, int64_t, const float*, int64_t,
                              const float*, int64_t, float*, float*,
                              const int*, int64_t, int, int, int, float, int);
typedef void (*BackwardKernel)(const float*, int64_t, const float*, int64_t,
                               const float*, int64_t, const float*, int64_t,
                               const float*, int64_t, float*, float*, int64_t,
                               float*, int64_t, const int*, int64_t, int, int,
                               int, float, float, int);

// indexed [VEC == 4][ALL]
const ForwardKernel kForward[2][2] = {
    {affine_coupling_kernel<1, false>, affine_coupling_kernel<1, true>},
    {affine_coupling_kernel<4, false>, affine_coupling_kernel<4, true>}};
const BackwardKernel kBackward[2][2] = {
    {affine_coupling_backward_kernel<1, false>, affine_coupling_backward_kernel<1, true>},
    {affine_coupling_backward_kernel<4, false>, affine_coupling_backward_kernel<4, true>}};

// the most columns the column map may take in shared memory (48 KB)
constexpr int kMaxColumns = 12288;

}  // namespace

// Forward (inverse = 0) or inverse (inverse = 1) coupling of n rows on
// `stream` (a cudaStream_t passed as a pointer). Row i of x starts at
// x + i * sx, of raw_s at raw + i * sr, of t at t + i * st (unit column
// stride each); y is contiguous [n, D] and ld [n]. transform_idx is a
// device array of n_tr increasing column indices, or null for every
// column (n_tr = D). Returns the cudaError_t of the launch; 0 means
// success. n = 0 launches nothing.
extern "C" int affine_coupling_launch(const void* x, int64_t sx, const void* raw,
                                      int64_t sr, const void* t, int64_t st,
                                      void* y, void* ld, const void* transform_idx,
                                      int64_t n, int D, int n_tr, float clamp,
                                      int inverse, void* stream) {
  if (D < 1 || D > kMaxColumns || n_tr < 0 || n_tr > D)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const bool all = transform_idx == nullptr;
  const bool vec4 = aligned(x, sx) && aligned(y, D) &&
                    (!all || (aligned(raw, sr) && aligned(t, st)));
  Shape shape;
  const cudaError_t err = shape_for(n, D, all, vec4, &shape);
  if (err != cudaSuccess) return static_cast<int>(err);
  kForward[shape.vec == 4][all]<<<shape.blocks, kThreads, shape.smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), sx, static_cast<const float*>(raw), sr,
      static_cast<const float*>(t), st, static_cast<float*>(y),
      static_cast<float*>(ld), static_cast<const int*>(transform_idx), n, D,
      n_tr, shape.G, clamp, inverse);
  return static_cast<int>(cudaGetLastError());
}

// Backward of the coupling: from x, raw_s, t (as for the forward) and the
// cotangents gy (row stride sgy; null for none) and gld ([n], stride
// sgld; null for none) to gx (contiguous [n, D]; null to skip), graw and gt (row strides
// sgr, sgt; unit column stride).
extern "C" int affine_coupling_backward_launch(
    const void* x, int64_t sx, const void* raw, int64_t sr, const void* t,
    int64_t st, const void* gy, int64_t sgy, const void* gld, int64_t sgld,
    void* gx, void* graw, int64_t sgr, void* gt, int64_t sgt, const void* transform_idx,
    int64_t n, int D, int n_tr, float clamp, int inverse, void* stream) {
  if (D < 1 || D > kMaxColumns || n_tr < 0 || n_tr > D)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const bool all = transform_idx == nullptr;
  const bool vec4 = aligned(x, sx) && aligned(gy, sgy) && aligned(gx, D) &&
                    (!all || (aligned(raw, sr) && aligned(t, st) &&
                              aligned(graw, sgr) && aligned(gt, sgt)));
  Shape shape;
  const cudaError_t err = shape_for(n, D, all, vec4, &shape);
  if (err != cudaSuccess) return static_cast<int>(err);
  // PyTorch divides by a Python scalar as a product with its reciprocal
  const float inv_clamp = 1.0f / clamp;
  kBackward[shape.vec == 4][all]<<<shape.blocks, kThreads, shape.smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), sx, static_cast<const float*>(raw), sr,
      static_cast<const float*>(t), st, static_cast<const float*>(gy), sgy,
      static_cast<const float*>(gld), sgld, static_cast<float*>(gx),
      static_cast<float*>(graw), sgr, static_cast<float*>(gt), sgt,
      static_cast<const int*>(transform_idx), n, D, n_tr, shape.G, clamp,
      inv_clamp, inverse);
  return static_cast<int>(cudaGetLastError());
}
