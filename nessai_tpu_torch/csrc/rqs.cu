// Rational-quadratic spline (linear tails) for Hopper (sm_90a): the
// forward or inverse transform, and the backward of the forward.
//
// Replaces the Pallas TPU kernel nessai_tpu/ops/rqs_pallas.py (rqs_pallas,
// pallas_call at line 180; the math is _spline_math_kt, lines 32-121).
// The JAX package has no backward kernel: its rqs_pallas_vjp (lines
// 207-244) differentiates the jnp reference. rqs_backward_launch below is
// that gradient written out by hand.
//
// Per element i, with raw widths u[K], raw heights v[K] and raw interior
// derivatives r[K-1] on rows of their own (row strides given):
//   W_k = (min_w + (1 - min_w K) softmax(u)_k) * 2B, the same for heights
//   knots C_0 = -B, C_k = -B + sum_{j<k} W_j, C_K = B (pinned)
//   derivatives 1, min_d + softplus(r_k + shift), 1
//   bin k = number of interior knots C_1..C_{K-1} at or below x
//   forward: y = rational quadratic of theta = (x - C_k) / w_k
//   inverse: theta = the stable root of the quadratic, y = C_k + theta w_k
//   log-derivative per element; x outside [-B, B] passes through (ld 0).
//
// Bound on the card: bytes. A forward call reads 4*m*3K bytes (x and the
// 3K-1 parameters) and writes 8*m; the backward reads 4*m*(3K+2) and
// writes 4*m*3K. At some 20K + 60 operations per element (K exps per
// softmax, the knot scan, the spline) it stays below the
// operations-per-byte line of the card in float32. At the flagship's
// shapes (m ~ 1e3) the byte bound is tens of nanoseconds; what sets the
// time there is each thread's dependent chain of double-precision
// exponentials and logarithms (about 9 us forward and 16 us backward a
// call on an H100 SXM at 700 W, against 1.4 us for the affine-coupling
// kernel at the same m).
//
// Design (right first, not fast): one thread per element in a
// grid-stride loop. K is a runtime argument up to kMaxBins; the loops over
// bins are unrolled to kMaxBins with a guard, so the exponentials of the
// softmax stay in registers. Inputs and outputs are float32; the math in
// between is double. In float32 the knots round to ~5e-7 (an ulp of B),
// and a narrow, strongly curved bin turns that into errors of 1e-3 in the
// log-derivative over 10^6 elements (the plain version in float32 shows
// the same against float64). In double each output is the float32
// rounding of the exact function of its float32 inputs, so the kernel is
// held tightly against the plain version run in float64. The TPU
// kernel's [K, m] transpose (bins on sublanes, batch on lanes) and its
// one-hot select are not carried over:
// the parameters are read in their own row-major layout (the conditioner's
// [n, n_tr, 3K-1] output, through its strides), the knots are built by a
// running scan that keeps the bin it finds, and the two derivatives of
// that bin are read directly by index. Nothing is allocated here and
// nothing synchronises; exp/log/log1p are the accurate functions (no
// fast-math).

#include <cstdint>
#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RQS_DEVICE __device__ __forceinline__
#else
#define RQS_DEVICE inline
#endif

constexpr int kMaxBins = 16;

// the type of the math between the float32 loads and stores
typedef double real;

// ---- per-element math ----------------------------------------------------

struct SplineParams {
  real B;       // tail bound: the spline lives on [-B, B]
  real min_w;   // smallest bin width, as a share of 2B
  real min_h;   // smallest bin height, as a share of 2B
  real min_d;   // smallest derivative
  real shift;   // log(expm1(1 - min_d)): raw 0 gives derivative 1
  int K;         // bins, 1 <= K <= kMaxBins
};

// The bin that holds the element, with the softmax terms the backward
// needs.
struct Bin {
  int k;        // bin index
  real cw, w;  // left width knot and bin width
  real ch, h;  // left height knot and bin height
  real dk, dk1;  // derivatives at the bin's two knots
  real sum_w, sum_h;  // softmax denominators
};

RQS_DEVICE real softplus(real v) {
  return fmax(v, 0.0) + log1p(exp(-fabs(v)));
}

RQS_DEVICE real sigmoid(real v) {
  if (v >= 0.0) return 1.0 / (1.0 + exp(-v));
  const real e = exp(v);
  return e / (1.0 + e);
}

// exp(u_k - max u) for k < K (0 beyond); returns their sum.
RQS_DEVICE real softmax_terms(const float* u, int K, real (&e)[kMaxBins]) {
  real mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxBins; ++k)
    if (k < K) mx = fmax(mx, static_cast<real>(u[k]));
  real sum = 0.0;
#pragma unroll
  for (int k = 0; k < kMaxBins; ++k) {
    e[k] = k < K ? exp(u[k] - mx) : 0.0;
    sum += e[k];
  }
  return sum;
}

// Build the width and height knots by a running scan and keep the bin
// whose left knot (width knots forward, height knots inverse) is the
// last one at or below xv. The knots strictly increase (every bin is at
// least 2B * min_w wide), so this is the reference's count of interior
// knots at or below xv.
RQS_DEVICE Bin find_bin(real xv, const float* u, const float* v,
                        const float* r, const SplineParams& p, bool inverse,
                        real (&ew)[kMaxBins], real (&eh)[kMaxBins]) {
  Bin b;
  b.sum_w = softmax_terms(u, p.K, ew);
  b.sum_h = softmax_terms(v, p.K, eh);
  const real total = 2.0 * p.B;
  const real scale_w = 1.0 - p.min_w * p.K;
  const real scale_h = 1.0 - p.min_h * p.K;
  real acc_w = 0.0, acc_h = 0.0;
  real cw = -p.B, ch = -p.B;  // left knots of bin k
  b.k = 0;
  b.cw = cw;
  b.ch = ch;
  b.w = b.h = 0.0;
#pragma unroll
  for (int k = 0; k < kMaxBins; ++k) {
    if (k < p.K) {
      acc_w += (p.min_w + scale_w * (ew[k] / b.sum_w)) * total;
      acc_h += (p.min_h + scale_h * (eh[k] / b.sum_h)) * total;
      const bool last = k == p.K - 1;
      const real cw1 = last ? p.B : -p.B + acc_w;
      const real ch1 = last ? p.B : -p.B + acc_h;
      if (k == 0 || xv >= (inverse ? ch : cw)) {
        b.k = k;
        b.cw = cw;
        b.ch = ch;
        b.w = cw1 - cw;
        b.h = ch1 - ch;
      }
      cw = cw1;
      ch = ch1;
    }
  }
  b.dk = b.k == 0 ? 1.0 : p.min_d + softplus(r[b.k - 1] + p.shift);
  b.dk1 = b.k == p.K - 1 ? 1.0 : p.min_d + softplus(r[b.k] + p.shift);
  return b;
}

// The transform of one element: *y and *ld.
RQS_DEVICE void spline_element(real xv, const float* u, const float* v,
                               const float* r, const SplineParams& p,
                               bool inverse, float* y, float* ld) {
  if (!(xv >= -p.B && xv <= p.B)) {  // linear tails (and NaN) pass through
    *y = xv;
    *ld = 0.0;
    return;
  }
  real ew[kMaxBins], eh[kMaxBins];
  const Bin b = find_bin(xv, u, v, r, p, inverse, ew, eh);
  const real s = b.h / b.w;
  const real delta = b.dk + b.dk1 - 2.0 * s;
  real theta;
  if (inverse) {
    const real y_rel = xv - b.ch;
    const real a = b.h * (s - b.dk) + y_rel * delta;
    const real bq = b.h * b.dk - y_rel * delta;
    const real c = -s * y_rel;
    const real disc = fmax(bq * bq - 4.0 * a * c, 0.0);
    theta = (2.0 * c) / (-bq - sqrt(disc));
    theta = fmin(fmax(theta, 0.0), 1.0);
    *y = theta * b.w + b.cw;
  } else {
    theta = fmin(fmax((xv - b.cw) / b.w, 0.0), 1.0);
  }
  const real omt = 1.0 - theta;
  const real denom = s + delta * theta * omt;
  const real num = (s * s) * (b.dk1 * (theta * theta) + 2.0 * s * theta * omt +
                               b.dk * (omt * omt));
  const real log_d = log(num) - 2.0 * log(denom);
  if (inverse) {
    *ld = -log_d;
  } else {
    *y = b.ch + b.h * (s * (theta * theta) + b.dk * theta * omt) / denom;
    *ld = log_d;
  }
}

// Gradient of one element of the forward transform, given the cotangents
// gy of y and gl of the log-derivative: writes *gx and the K, K and K-1
// parameter gradients (every entry). The last knot is pinned to B, so it
// passes no gradient back (the knot sum is 2B whatever the widths).
RQS_DEVICE void spline_element_backward(real xv, const float* u,
                                        const float* v, const float* r,
                                        const SplineParams& p, real gy,
                                        real gl, float* gx, float* gu,
                                        float* gv, float* gr) {
  const int K = p.K;
  if (!(xv >= -p.B && xv <= p.B)) {
    *gx = gy;
    for (int k = 0; k < K; ++k) gu[k] = gv[k] = 0.0;
    for (int k = 0; k < K - 1; ++k) gr[k] = 0.0;
    return;
  }
  real ew[kMaxBins], eh[kMaxBins];
  const Bin b = find_bin(xv, u, v, r, p, false, ew, eh);
  const real s = b.h / b.w;
  const real delta = b.dk + b.dk1 - 2.0 * s;
  const real raw_theta = (xv - b.cw) / b.w;
  const bool in_range = raw_theta >= 0.0 && raw_theta <= 1.0;
  const real t = fmin(fmax(raw_theta, 0.0), 1.0);
  const real omt = 1.0 - t;
  const real t1 = t * omt;
  const real denom = s + delta * t1;
  const real nu = s * (t * t) + b.dk * t1;  // y = ch + h * nu / denom
  const real q = b.dk1 * (t * t) + 2.0 * s * t1 + b.dk * (omt * omt);
  const real inv_den = 1.0 / denom;
  const real ratio = nu * inv_den;
  // coefficients of d(nu), d(denom) and d(q) in the cotangent-weighted
  // sum  gy * y + gl * (2 log s + log q - 2 log denom)
  const real c_nu = gy * b.h * inv_den;
  const real c_den = -gy * b.h * ratio * inv_den - 2.0 * gl * inv_den;
  const real c_q = gl / q;
  const real one_m_2t = 1.0 - 2.0 * t;
  const real g_t = c_nu * (2.0 * s * t + b.dk * one_m_2t) +
                    c_den * delta * one_m_2t +
                    c_q * (2.0 * b.dk1 * t + 2.0 * s * one_m_2t - 2.0 * b.dk * omt);
  const real g_s = c_nu * (t * t) + c_den * (1.0 - 2.0 * t1) +
                    c_q * 2.0 * t1 + 2.0 * gl / s;
  const real g_dk = (c_nu + c_den) * t1 + c_q * (omt * omt);
  const real g_dk1 = c_den * t1 + c_q * (t * t);
  // theta = (x - cw) / w (unless clamped), s = h / w
  real g_x = 0.0, g_cw = 0.0, g_w = -g_s * s / b.w;
  if (in_range) {
    g_x = g_t / b.w;
    g_cw = -g_t / b.w;
    g_w -= g_t * raw_theta / b.w;
  }
  const real g_h = gy * ratio + g_s / b.w;
  const real g_ch = gy;
  *gx = g_x;
  // knot gradients: w = C_{k+1} - C_k, h = D_{k+1} - D_k; C_0 and C_K are
  // constants
  const int k = b.k;
  const real a_w = k >= 1 ? g_cw - g_w : 0.0;   // dC_k
  const real b_w = k + 1 <= K - 1 ? g_w : 0.0;  // dC_{k+1}
  const real a_h = k >= 1 ? g_ch - g_h : 0.0;
  const real b_h = k + 1 <= K - 1 ? g_h : 0.0;
  // C_j = -B + sum_{i<j} W_i, W_i = (min + scale p_i) * 2B, p = softmax(u):
  // dW_i = a [i < k] + b [i <= k];  du_i = c p_i (dW_i - sum_j p_j dW_j)
  real pw_lt = 0.0, pw_le = 0.0, ph_lt = 0.0, ph_le = 0.0;
#pragma unroll
  for (int i = 0; i < kMaxBins; ++i) {
    if (i < K) {
      const real pw = ew[i] / b.sum_w, ph = eh[i] / b.sum_h;
      if (i < k) {
        pw_lt += pw;
        ph_lt += ph;
      }
      if (i <= k) {
        pw_le += pw;
        ph_le += ph;
      }
    }
  }
  const real c_w = (1.0 - p.min_w * K) * 2.0 * p.B;
  const real c_h = (1.0 - p.min_h * K) * 2.0 * p.B;
  const real dot_w = a_w * pw_lt + b_w * pw_le;
  const real dot_h = a_h * ph_lt + b_h * ph_le;
#pragma unroll
  for (int i = 0; i < kMaxBins; ++i) {
    if (i < K) {
      const real dw = (i < k ? a_w : 0.0) + (i <= k ? b_w : 0.0);
      const real dh = (i < k ? a_h : 0.0) + (i <= k ? b_h : 0.0);
      gu[i] = c_w * (ew[i] / b.sum_w) * (dw - dot_w);
      gv[i] = c_h * (eh[i] / b.sum_h) * (dh - dot_h);
    }
  }
  for (int j = 0; j < K - 1; ++j) gr[j] = 0.0;
  if (k >= 1) gr[k - 1] = g_dk * sigmoid(r[k - 1] + p.shift);
  if (k + 1 <= K - 1) gr[k] = g_dk1 * sigmoid(r[k] + p.shift);
}

// ---- kernels -------------------------------------------------------------

#ifdef __CUDACC__
namespace {

__global__ void rqs_forward_kernel(const float* __restrict__ x,
                                   const float* __restrict__ u, int64_t su,
                                   const float* __restrict__ v, int64_t sv,
                                   const float* __restrict__ r, int64_t sr,
                                   float* __restrict__ y,
                                   float* __restrict__ ld, int64_t m,
                                   SplineParams p, int inverse) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    spline_element(x[i], u + i * su, v + i * sv, r + i * sr, p, inverse != 0,
                   y + i, ld + i);
  }
}

__global__ void rqs_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ u, int64_t su,
    const float* __restrict__ v, int64_t sv, const float* __restrict__ r,
    int64_t sr, const float* __restrict__ gy, const float* __restrict__ gl,
    float* __restrict__ gx, float* __restrict__ gu, float* __restrict__ gv,
    float* __restrict__ gr, int64_t m, SplineParams p) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int K = p.K;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    spline_element_backward(x[i], u + i * su, v + i * sv, r + i * sr, p,
                            gy[i], gl[i], gx + i, gu + i * K, gv + i * K,
                            gr + i * (K - 1));
  }
}

unsigned int grid_for(int64_t m, int threads) {
  int64_t blocks = (m + threads - 1) / threads;
  // enough blocks to fill 132 SMs several times over; the grid-stride
  // loop covers the rest
  const int64_t max_blocks = 132 * 16;
  return static_cast<unsigned int>(blocks < max_blocks ? blocks : max_blocks);
}

SplineParams make_params(int K, double B, double min_w, double min_h,
                         double min_d, double shift) {
  SplineParams p;
  p.B = B;
  p.min_w = min_w;
  p.min_h = min_h;
  p.min_d = min_d;
  p.shift = shift;
  p.K = K;
  return p;
}

constexpr int kThreads = 256;

}  // namespace

// Forward (inverse = 0) or inverse (inverse = 1) transform of m elements
// on `stream` (a cudaStream_t passed as a pointer). x, y and ld are
// contiguous [m]; row i of the widths starts at u + i * su (the K entries
// of a row contiguous), and so on. Returns the cudaError_t of the launch;
// 0 means success. m = 0 launches nothing; K outside [1, kMaxBins] gives
// cudaErrorInvalidValue.
extern "C" int rqs_forward_launch(const void* x, const void* u, int64_t su,
                                  const void* v, int64_t sv, const void* r,
                                  int64_t sr, void* y, void* ld, int64_t m,
                                  int K, double B, double min_w,
                                  double min_h, double min_d, double shift,
                                  int inverse,
                                  void* stream) {
  if (K < 1 || K > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  rqs_forward_kernel<<<grid_for(m, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), su,
      static_cast<const float*>(v), sv, static_cast<const float*>(r), sr,
      static_cast<float*>(y), static_cast<float*>(ld), m,
      make_params(K, B, min_w, min_h, min_d, shift), inverse);
  return static_cast<int>(cudaGetLastError());
}

// Backward of the forward transform: from x, the parameters and the
// cotangents gy, gl (contiguous [m]) to gx [m] and the contiguous
// gradients gu [m, K], gv [m, K], gr [m, K-1].
extern "C" int rqs_backward_launch(const void* x, const void* u, int64_t su,
                                   const void* v, int64_t sv, const void* r,
                                   int64_t sr, const void* gy, const void* gl,
                                   void* gx, void* gu, void* gv, void* gr,
                                   int64_t m, int K, double B, double min_w,
                                   double min_h, double min_d, double shift,
                                   void* stream) {
  if (K < 1 || K > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  rqs_backward_kernel<<<grid_for(m, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), su,
      static_cast<const float*>(v), sv, static_cast<const float*>(r), sr,
      static_cast<const float*>(gy), static_cast<const float*>(gl),
      static_cast<float*>(gx), static_cast<float*>(gu),
      static_cast<float*>(gv), static_cast<float*>(gr), m,
      make_params(K, B, min_w, min_h, min_d, shift));
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__
