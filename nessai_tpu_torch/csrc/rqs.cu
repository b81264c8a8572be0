// Rational-quadratic spline for Hopper (sm_90a): the forward or inverse
// transform, and the backward of either direction, with linear tails on
// [-B, B] or on the unit box [0, 1] (tails=None), for any number of bins.
//
// Replaces the Pallas TPU kernel nessai_tpu/ops/rqs_pallas.py (rqs_pallas,
// pallas_call at line 180; the math is _spline_math_kt, lines 32-121).
// The JAX package has no backward kernel: its rqs_pallas_vjp (lines
// 207-244) differentiates the jnp reference, in either direction
// (_rqs_bwd, line 228). rqs_backward_launch below is that gradient of the
// forward written out by hand, rqs_inverse_backward_launch that of the
// inverse. The unit box is the jnp spline of
// nessai_tpu/flows/rqs.py:28-158 with tails=None, which the JAX package
// runs outside Pallas (flows/bijectors.py:318 takes Pallas for linear
// tails only).
//
// Per element i, with raw widths u[K], raw heights v[K] and raw
// derivatives r on rows of their own (row strides given), on the box
// [lo, hi] of width S (lo = -B, S = 2B for linear tails; lo = 0, S = 1
// for tails=None):
//   W_k = (min_w + (1 - min_w K) softmax(u)_k) * S, the same for heights
//   knots C_0 = lo, C_k = lo + sum_{j<k} W_j, C_K = hi (pinned)
//   derivatives: linear tails 1, min_d + softplus(r_k + shift) for the
//     K - 1 interior knots, 1; tails=None min_d + softplus(r_k + shift)
//     at all K + 1 knots
//   bin k = number of interior knots C_1..C_{K-1} at or below x
//   forward: y = rational quadratic of theta = (x - C_k) / w_k
//   inverse: theta = the stable root of the quadratic, y = C_k + theta w_k
//   log-derivative per element; x outside [lo, hi] passes through (ld 0);
//   with tails=None y is clamped to the box after the spline, in double.
//
// What bounds it on this card. Bytes: a forward call reads 4*m*3K bytes
// (x and the 3K +- 1 parameters) and writes 8*m; the backward reads
// 4*m*(3K+2) and writes 4*m*3K, tens of nanoseconds at the flagship's
// shapes (m ~ 1e3). The math is double (below), which the H100 runs at
// half its float32 rate. At the flagship's shapes neither limit is near:
// the time is the launch plus the latency of one element's dependent
// chain (the loads, two softmaxes, the knot scan, the bin search, the
// spline and its two logarithms). At m ~ 1e6 the time is far above both
// bounds too, and what sets it is the instructions each element costs.
//
// Design: one lane group per element. An element has `items` lane items:
// its K bins for linear tails, lane k holding the derivative at knot
// k + 1; its K bins and one more for tails=None, lane k holding the
// derivative at knot k (so K + 1 items). G lanes, G the next power of
// two at or above `items` (2 <= G <= 32), work on one element; a warp
// holds 32 / G elements and walks them in a grid-stride loop. Lane k of
// a group
//   - reads u[k], v[k] and r[k] of its element's row, so one load of a
//     warp covers 32 / G rows of G contiguous floats, and the loads do
//     not wait for x;
//   - takes one exp for each softmax, after a max over the group in
//     float32 (log2 G steps of __shfl_xor_sync);
//   - gets the sum of the exps up to bin k from an inclusive scan over
//     the group (log2 G steps of __shfl_up_sync), the softmax's sum from
//     the scan's last lane, so its right knot is one division away; its
//     left knot comes from lane k - 1, and the last knot is pinned;
//   - takes the softplus of r[k].
// The bin is a ballot of "x >= left knot" over lanes 1..K-1 counted with
// __popc: the reference's count of interior knots at or below x (the
// knots strictly increase: every bin is at least S min_w wide). The
// bin's knots and derivatives come from their lanes by __shfl_sync. In
// the forward the bin then goes to one lane of the warp, which evaluates
// the rational quadratic and stores y and the log-derivative. Where the
// input would not fit on the card at G lanes an element, a warp finds the
// bins of 32 elements in G rounds, and each lane then takes the two
// softplus of its element's bin and evaluates its spline: repeated in
// the G lanes of a group, those made the forward at m ~ 1e6 slower than
// one thread per element. The backward recomputes the bin, back-
// propagates through the rational quadratic in every lane of the group,
// takes the sums of the softmax shares below and up to the bin from the
// same scan, and lane k writes the gradients of its own u[k], v[k] and
// r[k]: coalesced rows instead of one thread writing 3K floats. So the
// dependent chain of an element is one exp per softmax, one division,
// 2 log2 G steps of shuffles and the spline.
//
// More items than a warp has lanes (K > 32 with linear tails, K >= 32
// with tails=None): one element a warp, lane l holding bins l, 32 + l,
// ... in chunks of 32. The softmaxes' max and sum take one pass over the
// chunks each; a third pass computes the knots chunk by chunk (the scan
// carries the sum of the chunks before it), counts the interior right
// knots at or below x with a ballot a chunk, and takes the bin's values
// from the chunk that holds it: the count after chunk c is below
// 32 (c + 1) exactly when the bin lies in chunk c. The backward adds a
// fourth pass that writes every lane's gradients. Below that size the
// grid-stride loop is as before; the chunked path is compiled into the
// 32-lane instances only.
//
// Every lane of a warp runs every shuffle and ballot with the full mask:
// an element outside the box (or NaN) or past the end of the input is
// computed on stand-in parameters and selected away, never returned from
// early; lanes k >= K give -inf to the max, 0 to the scans and false to
// the ballot. No atomics and a fixed shuffle order, so a run is
// bit-identical to itself.
//
// Precision: float32 loads and stores and the softmax's max (exact: it
// is one of the float32 inputs); double in between: the softmax exps,
// the shares, the knot scans, the differences x - C_k and C_{k+1} - C_k,
// the softplus and sigmoid, the spline and its logarithms, and the clamp
// to the unit box. In float32 the knots round to ~5e-7 (an ulp of B),
// and a narrow, strongly curved bin turns that into errors of 1e-3 in
// the log-derivative over 10^6 elements; in double each output is the
// float32 rounding of the exact function of its float32 inputs. exp, log
// and log1p are the accurate functions (no fast-math).

#include <cstdint>
#include <math.h>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
// threads a block: at the flagship's m ~ 1e3 and G = 8, tens of blocks,
// so the elements spread over tens of SMs
constexpr int kThreads = 128;
// the forward asks for 4 blocks an SM (up to 128 registers a thread):
// with the thread count alone ptxas held the 32-lane and the spread
// tails=None instances to 56-80 registers and spilled
constexpr int kForwardBlocksPerSM = 4;

struct SplineParams {
  double lo;     // the box's low end: -B (linear tails) or 0 (tails=None)
  double span;   // the box's width: 2B or 1
  double hi;     // lo + span
  double min_w;  // smallest bin width, as a share of the span
  double min_h;  // smallest bin height, as a share of the span
  double min_d;  // smallest derivative
  double shift;  // log(expm1(1 - min_d)): raw 0 gives derivative 1
  int K;         // bins, K >= 1
};

// Lane items of an element: K bins, and for tails=None one more lane for
// the derivative at the last knot.
template <bool kUnit>
__device__ __forceinline__ int lane_items(int K) {
  return kUnit ? K + 1 : K;
}

// Raw derivatives in a row: K - 1 interior ones, or all K + 1.
template <bool kUnit>
__device__ __forceinline__ int raw_derivatives(int K) {
  return kUnit ? K + 1 : K - 1;
}

// ---- reductions within a group of G lanes (aligned, G a power of two) ----

template <int G>
__device__ __forceinline__ float group_max(float a) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(kFullWarp, a, off, G));
  return a;
}

// Inclusive prefix sum over the group: lane k gets a_0 + ... + a_k.
template <int G>
__device__ __forceinline__ double group_scan(double a, int k) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const double t = __shfl_up_sync(kFullWarp, a, off, G);
    if (k >= off) a += t;
  }
  return a;
}

template <int G>
__device__ __forceinline__ double from_lane(double a, int src) {
  return __shfl_sync(kFullWarp, a, src, G);
}

// The group's lanes of a warp-wide ballot.
template <int G>
__device__ __forceinline__ unsigned group_votes(unsigned votes, int lane) {
  if (G == 32) return votes;
  return (votes >> (lane & ~(G - 1))) & ((1u << (G & 31)) - 1u);
}

// The softmax of the group's K raw values (lanes k >= K hold none): lane
// k's share p_k in *share and the return value p_0 + ... + p_k. The max
// is taken in float32, where it is exact (one of the raw values); the
// sum is the scan's last lane, so one scan gives both.
template <int G>
__device__ __forceinline__ double group_softmax_upto(float raw, bool bin,
                                                     int k, double* share) {
  const float mx = group_max<G>(bin ? raw : -INFINITY);
  const double e =
      bin ? exp(static_cast<double>(raw) - static_cast<double>(mx)) : 0.0;
  const double upto = group_scan<G>(e, k);
  const double sum = from_lane<G>(upto, G - 1);
  *share = e / sum;
  return upto / sum;
}

// min_d + softplus(v) for v = r + shift, from e = exp(-|v|).
__device__ __forceinline__ double derivative(double v, double e,
                                             const SplineParams& p) {
  return p.min_d + (fmax(v, 0.0) + log1p(e));
}

// min_d + softplus(raw + shift).
__device__ __forceinline__ double derivative_of(float raw,
                                                const SplineParams& p) {
  const double v = static_cast<double>(raw) + p.shift;
  return derivative(v, exp(-fabs(v)), p);
}

// The right knot of bin k, lo + sum_{j<=k} (min + scale p_j) S, from the
// sum of the shares up to k; the last knot is pinned to hi.
__device__ __forceinline__ double right_knot(int k, double upto, double min,
                                             const SplineParams& p) {
  return k == p.K - 1 ? p.hi
                      : p.lo + ((k + 1) * min + (1.0 - min * p.K) * upto) * p.span;
}

// ---- one element, in every lane of its group ------------------------------

// The bin that holds the element, known to every lane of the group.
struct Bin {
  int k;          // bin index
  double cw, w;   // left width knot and bin width
  double ch, h;   // left height knot and bin height
  double dk, dk1; // derivatives at the bin's two knots
};

// What lane k keeps of its own bin for the backward (up to 32 items).
struct LaneShares {
  double p_w, p_h;        // softmax shares of bin k (0 for k >= K)
  double upto_w, upto_h;  // their sums over bins 0..k
  double e_r;             // exp(-|r_k + shift|), for the softplus's gradient
  double r;               // r_k + shift
};

// What the chunked path keeps for the backward, the same in every lane.
struct WarpShares {
  float mu, mv;            // the softmaxes' maxima
  double sum_w, sum_h;     // and their sums of exps
  double le_w, le_h;       // shares summed over bins 0..bin
  double lt_w, lt_h;       // shares summed over bins 0..bin-1
};

// Knots from the group scan and the bin by a ballot (width knots forward,
// height knots inverse), for elements with at most G lane items. u, v
// and r are the element's rows; they are read wherever the element
// exists (`valid`), so the loads need not wait for x, and raw 0 stands
// in past the end of the input. With kDerivatives lane k also takes the
// softplus of r[k] and the group gathers the bin's two derivatives;
// without, b.dk and b.dk1 are left for the caller.
template <int G, bool kUnit, bool kDerivatives>
__device__ __forceinline__ Bin group_bin(double xv, bool valid,
                                         const float* u, const float* v,
                                         const float* r, int k, int lane,
                                         const SplineParams& p, bool inverse,
                                         LaneShares* own) {
  const int K = p.K;
  const bool bin = k < K;
  const float uk = valid && bin ? u[k] : 0.0f;
  const float vk = valid && bin ? v[k] : 0.0f;
  // lane k's derivative: at knot k + 1 for linear tails (1 at the last
  // knot), at knot k for tails=None
  double d_lane = 1.0;
  if (kDerivatives) {
    const int n_r = raw_derivatives<kUnit>(K);
    own->r = static_cast<double>(valid && k < n_r ? r[k] : 0.0f) + p.shift;
    own->e_r = exp(-fabs(own->r));
    if (k < n_r) d_lane = derivative(own->r, own->e_r, p);
  }
  own->upto_w = group_softmax_upto<G>(uk, bin, k, &own->p_w);
  own->upto_h = group_softmax_upto<G>(vk, bin, k, &own->p_h);
  const double right_w = right_knot(k, own->upto_w, p.min_w, p);
  const double right_h = right_knot(k, own->upto_h, p.min_h, p);
  const double below_w = __shfl_up_sync(kFullWarp, right_w, 1, G);
  const double below_h = __shfl_up_sync(kFullWarp, right_h, 1, G);
  const double left_w = k == 0 ? p.lo : below_w;
  const double left_h = k == 0 ? p.lo : below_h;
  // interior knots C_1..C_{K-1} (the left knots of lanes 1..K-1) at or
  // below x; NaN votes no
  const double edge = inverse ? left_h : left_w;
  const unsigned votes = __ballot_sync(kFullWarp, k >= 1 && bin && xv >= edge);
  Bin b;
  b.k = __popc(group_votes<G>(votes, lane));
  b.cw = from_lane<G>(left_w, b.k);
  b.w = from_lane<G>(right_w, b.k) - b.cw;
  b.ch = from_lane<G>(left_h, b.k);
  b.h = from_lane<G>(right_h, b.k) - b.ch;
  if (kDerivatives) {
    if (kUnit) {
      b.dk = from_lane<G>(d_lane, b.k);
      b.dk1 = from_lane<G>(d_lane, b.k + 1);
    } else {
      const double d_left = from_lane<G>(d_lane, b.k > 0 ? b.k - 1 : 0);
      b.dk = b.k == 0 ? 1.0 : d_left;
      b.dk1 = from_lane<G>(d_lane, b.k);
    }
  }
  return b;
}

// The bin of an element with more lane items than a warp has lanes: one
// element a warp, lane l holding items l, 32 + l, ... (see the head of
// the file). Every value it returns is the same in every lane.
template <bool kUnit, bool kDerivatives>
__device__ __forceinline__ Bin warp_bin_chunked(double xv, bool valid,
                                             const float* u, const float* v,
                                             const float* r, int lane,
                                             const SplineParams& p, bool inverse,
                                             WarpShares* own) {
  const int K = p.K;
  const int n_r = raw_derivatives<kUnit>(K);
  const int chunks = (K + 31) >> 5;
  // pass 1: the softmaxes' maxima (float32, exact)
  float mu = -INFINITY, mv = -INFINITY;
  for (int c = 0; c < chunks; ++c) {
    const int j = (c << 5) + lane;
    if (j < K) {
      mu = fmaxf(mu, valid ? u[j] : 0.0f);
      mv = fmaxf(mv, valid ? v[j] : 0.0f);
    }
  }
  mu = group_max<32>(mu);
  mv = group_max<32>(mv);
  // pass 2: their sums, chunk by chunk as pass 3 adds them up
  double sum_w = 0.0, sum_h = 0.0;
  for (int c = 0; c < chunks; ++c) {
    const int j = (c << 5) + lane;
    const bool bin = j < K;
    const double ew = bin ? exp(static_cast<double>(valid ? u[j] : 0.0f) - static_cast<double>(mu)) : 0.0;
    const double eh = bin ? exp(static_cast<double>(valid ? v[j] : 0.0f) - static_cast<double>(mv)) : 0.0;
    sum_w += from_lane<32>(group_scan<32>(ew, lane), 31);
    sum_h += from_lane<32>(group_scan<32>(eh, lane), 31);
  }
  // pass 3: the knots, the count of interior knots at or below x, and the
  // bin's values from the chunk that holds it
  double carry_w = 0.0, carry_h = 0.0;    // exps of the chunks before
  double last_w = p.lo, last_h = p.lo;    // the knot before the chunk
  double last_d = 1.0;                    // its derivative (linear tails)
  int count = 0;
  Bin b = {};
  for (int c = 0; c < chunks; ++c) {
    const int j = (c << 5) + lane;
    const bool bin = j < K;
    const double ew = bin ? exp(static_cast<double>(valid ? u[j] : 0.0f) - static_cast<double>(mu)) : 0.0;
    const double eh = bin ? exp(static_cast<double>(valid ? v[j] : 0.0f) - static_cast<double>(mv)) : 0.0;
    const double acc_w = carry_w + group_scan<32>(ew, lane);
    const double acc_h = carry_h + group_scan<32>(eh, lane);
    double prev_w = __shfl_up_sync(kFullWarp, acc_w, 1);
    double prev_h = __shfl_up_sync(kFullWarp, acc_h, 1);
    if (lane == 0) {
      prev_w = carry_w;
      prev_h = carry_h;
    }
    carry_w = from_lane<32>(acc_w, 31);
    carry_h = from_lane<32>(acc_h, 31);
    const double right_w = right_knot(j, acc_w / sum_w, p.min_w, p);
    const double right_h = right_knot(j, acc_h / sum_h, p.min_h, p);
    double left_w = __shfl_up_sync(kFullWarp, right_w, 1);
    double left_h = __shfl_up_sync(kFullWarp, right_h, 1);
    if (lane == 0) {
      left_w = last_w;
      left_h = last_h;
    }
    last_w = from_lane<32>(right_w, 31);
    last_h = from_lane<32>(right_h, 31);
    // interior right knots C_{j+1} (j + 1 <= K - 1) at or below x
    const double edge = inverse ? right_h : right_w;
    count += __popc(__ballot_sync(kFullWarp, j + 1 <= K - 1 && xv >= edge));
    double dl = 1.0, dr = 1.0;  // the derivatives at item j's two knots
    if (kDerivatives) {
      const double d = j < n_r ? derivative_of(valid ? r[j] : 0.0f, p) : 1.0;
      if (kUnit) {
        // lane j holds knot j; knot j + 1 is the next lane's, or for the
        // last lane the next chunk's first
        dl = d;
        dr = __shfl_down_sync(kFullWarp, d, 1);
        if (lane == 31) dr = j + 1 < n_r ? derivative_of(valid ? r[j + 1] : 0.0f, p) : 1.0;
      } else {
        // lane j holds knot j + 1; knot j is the lane before's
        dr = d;
        dl = __shfl_up_sync(kFullWarp, d, 1);
        if (lane == 0) dl = last_d;
        last_d = from_lane<32>(d, 31);
      }
    }
    if ((count >> 5) == c) {  // the same in every lane of the warp
      const int src = count & 31;
      b.k = count;
      b.cw = from_lane<32>(left_w, src);
      b.w = from_lane<32>(right_w, src) - b.cw;
      b.ch = from_lane<32>(left_h, src);
      b.h = from_lane<32>(right_h, src) - b.ch;
      if (kDerivatives) {
        b.dk = from_lane<32>(dl, src);
        b.dk1 = from_lane<32>(dr, src);
      }
      if (own != nullptr) {
        own->le_w = from_lane<32>(acc_w, src) / sum_w;
        own->le_h = from_lane<32>(acc_h, src) / sum_h;
        own->lt_w = from_lane<32>(prev_w, src) / sum_w;
        own->lt_h = from_lane<32>(prev_h, src) / sum_h;
      }
    }
  }
  if (own != nullptr) {
    own->mu = mu;
    own->mv = mv;
    own->sum_w = sum_w;
    own->sum_h = sum_h;
  }
  return b;
}

// The transform of an element inside the box: *y and *ld.
__device__ __forceinline__ void spline_value(double xv, const Bin& b,
                                             bool inverse, double* y,
                                             double* ld) {
  const double s = b.h / b.w;
  const double delta = b.dk + b.dk1 - 2.0 * s;
  double theta;
  if (inverse) {
    const double y_rel = xv - b.ch;
    const double a = b.h * (s - b.dk) + y_rel * delta;
    const double bq = b.h * b.dk - y_rel * delta;
    const double c = -s * y_rel;
    const double disc = fmax(bq * bq - 4.0 * a * c, 0.0);
    theta = (2.0 * c) / (-bq - sqrt(disc));
    theta = fmin(fmax(theta, 0.0), 1.0);
    *y = theta * b.w + b.cw;
  } else {
    theta = fmin(fmax((xv - b.cw) / b.w, 0.0), 1.0);
  }
  const double omt = 1.0 - theta;
  const double denom = s + delta * theta * omt;
  const double num = (s * s) * (b.dk1 * (theta * theta) + 2.0 * s * theta * omt +
                                b.dk * (omt * omt));
  const double log_d = log(num) - 2.0 * log(denom);
  if (inverse) {
    *ld = -log_d;
  } else {
    *y = b.ch + b.h * (s * (theta * theta) + b.dk * theta * omt) / denom;
    *ld = log_d;
  }
}

// Gradient of an element's forward transform with respect to x and to its
// bin's quantities, given the cotangents gy of y and gl of the
// log-derivative.
struct BinGrad {
  double x;         // dx
  double a_w, b_w;  // width knots C_k and C_{k+1}
  double a_h, b_h;  // height knots
  double dk, dk1;   // the bin's two derivatives
};

__device__ __forceinline__ BinGrad bin_backward(double xv, const Bin& b,
                                                double gy, double gl, int K) {
  const double s = b.h / b.w;
  const double delta = b.dk + b.dk1 - 2.0 * s;
  const double raw_theta = (xv - b.cw) / b.w;
  const bool in_range = raw_theta >= 0.0 && raw_theta <= 1.0;
  const double t = fmin(fmax(raw_theta, 0.0), 1.0);
  const double omt = 1.0 - t;
  const double t1 = t * omt;
  const double denom = s + delta * t1;
  const double nu = s * (t * t) + b.dk * t1;  // y = ch + h * nu / denom
  const double q = b.dk1 * (t * t) + 2.0 * s * t1 + b.dk * (omt * omt);
  const double inv_den = 1.0 / denom;
  const double ratio = nu * inv_den;
  // coefficients of d(nu), d(denom) and d(q) in the cotangent-weighted
  // sum  gy * y + gl * (2 log s + log q - 2 log denom)
  const double c_nu = gy * b.h * inv_den;
  const double c_den = -gy * b.h * ratio * inv_den - 2.0 * gl * inv_den;
  const double c_q = gl / q;
  const double one_m_2t = 1.0 - 2.0 * t;
  const double g_t = c_nu * (2.0 * s * t + b.dk * one_m_2t) +
                     c_den * delta * one_m_2t +
                     c_q * (2.0 * b.dk1 * t + 2.0 * s * one_m_2t - 2.0 * b.dk * omt);
  const double g_s = c_nu * (t * t) + c_den * (1.0 - 2.0 * t1) +
                     c_q * 2.0 * t1 + 2.0 * gl / s;
  BinGrad g;
  g.dk = (c_nu + c_den) * t1 + c_q * (omt * omt);
  g.dk1 = c_den * t1 + c_q * (t * t);
  // theta = (x - cw) / w (unless clamped), s = h / w
  double g_cw = 0.0, g_w = -g_s * s / b.w;
  g.x = 0.0;
  if (in_range) {
    g.x = g_t / b.w;
    g_cw = -g_t / b.w;
    g_w -= g_t * raw_theta / b.w;
  }
  const double g_h = gy * ratio + g_s / b.w;
  const double g_ch = gy;
  // knot gradients: w = C_{k+1} - C_k, h = D_{k+1} - D_k; C_0 and C_K are
  // constants (the last knot is pinned, so it passes no gradient back)
  g.a_w = b.k >= 1 ? g_cw - g_w : 0.0;      // dC_k
  g.b_w = b.k + 1 <= K - 1 ? g_w : 0.0;     // dC_{k+1}
  g.a_h = b.k >= 1 ? g_ch - g_h : 0.0;
  g.b_h = b.k + 1 <= K - 1 ? g_h : 0.0;
  return g;
}

// Gradient of an element's inverse transform, x = C_k + w theta with
// theta the root of y = D_k + h nu(theta) / denom(theta) and the
// log-derivative -(2 log s + log q(theta) - 2 log denom(theta)), given the
// cotangents gx of x and gl of the log-derivative. theta is taken as the
// forward's inverse computes it; its gradient is the implicit one, which
// equals that of the quadratic's root wherever the root is simple, as it
// is in a monotone bin (dy/dtheta = h s q / denom^2 > 0):
//   lambda = (gx w - gl dlogd/dtheta) / (dy/dtheta)
// is the gradient in y, and the parameters see -lambda as a cotangent of
// the forward's y (through theta) beside the direct terms of x and of
// the log-derivative at fixed theta: so bin_backward's coefficients with
// gy -> -lambda and gl -> -gl, and x's own gx on C_k and gx theta on w.
// Where the root was clamped to [0, 1] theta is a constant, as the clamp
// makes it in the plain version: lambda = 0.
__device__ __forceinline__ BinGrad bin_backward_inverse(double yv, const Bin& b,
                                                        double gx, double gl, int K) {
  const double s = b.h / b.w;
  const double delta = b.dk + b.dk1 - 2.0 * s;
  const double y_rel = yv - b.ch;
  const double a = b.h * (s - b.dk) + y_rel * delta;
  const double bq = b.h * b.dk - y_rel * delta;
  const double c = -s * y_rel;
  const double disc = fmax(bq * bq - 4.0 * a * c, 0.0);
  const double raw_theta = (2.0 * c) / (-bq - sqrt(disc));
  const bool in_range = raw_theta >= 0.0 && raw_theta <= 1.0;
  const double t = fmin(fmax(raw_theta, 0.0), 1.0);
  const double omt = 1.0 - t;
  const double t1 = t * omt;
  const double denom = s + delta * t1;
  const double nu = s * (t * t) + b.dk * t1;
  const double q = b.dk1 * (t * t) + 2.0 * s * t1 + b.dk * (omt * omt);
  const double inv_den = 1.0 / denom;
  const double ratio = nu * inv_den;
  const double one_m_2t = 1.0 - 2.0 * t;
  const double dlogd_dt = (2.0 * b.dk1 * t + 2.0 * s * one_m_2t - 2.0 * b.dk * omt) / q -
                          2.0 * delta * one_m_2t * inv_den;
  const double dy_dt = b.h * s * q * inv_den * inv_den;
  const double lambda = in_range ? (gx * b.w - gl * dlogd_dt) / dy_dt : 0.0;
  // the forward's coefficients for the cotangents (-lambda, -gl)
  const double gyf = -lambda;
  const double glf = -gl;
  const double c_nu = gyf * b.h * inv_den;
  const double c_den = -gyf * b.h * ratio * inv_den - 2.0 * glf * inv_den;
  const double c_q = glf / q;
  const double g_s = c_nu * (t * t) + c_den * (1.0 - 2.0 * t1) + c_q * 2.0 * t1 + 2.0 * glf / s;
  BinGrad g;
  g.dk = (c_nu + c_den) * t1 + c_q * (omt * omt);
  g.dk1 = c_den * t1 + c_q * (t * t);
  g.x = lambda;
  // x = C_k + w theta, s = h / w
  const double g_cw = gx;
  const double g_w = -g_s * s / b.w + gx * t;
  const double g_h = gyf * ratio + g_s / b.w;
  const double g_ch = gyf;
  g.a_w = b.k >= 1 ? g_cw - g_w : 0.0;
  g.b_w = b.k + 1 <= K - 1 ? g_w : 0.0;
  g.a_h = b.k >= 1 ? g_ch - g_h : 0.0;
  g.b_h = b.k + 1 <= K - 1 ? g_h : 0.0;
  return g;
}

// A raw width's (or raw height's) gradient for bin k with share p_k.
// C_j = lo + sum_{i<j} W_i, W_i = (min + scale p_i) * S, p = softmax(u):
// dW_i = a [i < bin] + b [i <= bin] and du_k = c p_k (dW_k - sum_i p_i
// dW_i), the sum from the shares summed below the bin (lt) and up to it
// (le).
__device__ __forceinline__ double share_gradient(double p_k, double lt,
                                                 double le, double a, double b,
                                                 int bin, int k, double c) {
  const double dot = a * lt + b * le;
  const double dw = (k < bin ? a : 0.0) + (k <= bin ? b : 0.0);
  return c * p_k * (dw - dot);
}

// The gradient of raw derivative j: r_j is knot j + 1's derivative for
// linear tails, knot j's for tails=None.
template <bool kUnit>
__device__ __forceinline__ double raw_derivative_gradient(int j, int bin,
                                                          const BinGrad& g,
                                                          double sig) {
  const int at_k = kUnit ? bin : bin - 1;  // the raw index of knot bin
  return j == at_k ? g.dk * sig : (j == at_k + 1 ? g.dk1 * sig : 0.0);
}

// d softplus(r) / dr = sigmoid(r), from e = exp(-|r|).
__device__ __forceinline__ double softplus_gradient(double r, double e) {
  return r >= 0.0 ? 1.0 / (1.0 + e) : e / (1.0 + e);
}

// ---- kernels -------------------------------------------------------------

// The bin of lane `src`'s element, to every lane (its derivatives only
// where they were gathered).
template <bool kDerivatives>
__device__ __forceinline__ Bin bin_from_lane(const Bin& b, int src) {
  Bin out;
  out.k = __shfl_sync(kFullWarp, b.k, src);
  out.cw = __shfl_sync(kFullWarp, b.cw, src);
  out.w = __shfl_sync(kFullWarp, b.w, src);
  out.ch = __shfl_sync(kFullWarp, b.ch, src);
  out.h = __shfl_sync(kFullWarp, b.h, src);
  if (kDerivatives) {
    out.dk = __shfl_sync(kFullWarp, b.dk, src);
    out.dk1 = __shfl_sync(kFullWarp, b.dk1, src);
  }
  return out;
}

// An element's bin, through the group or, for more items than a warp
// has lanes, the chunked path (32-lane instances only).
template <int G, bool kUnit, bool kDerivatives>
__device__ __forceinline__ Bin element_bin(double xv, bool valid, const float* u,
                                           const float* v, const float* r, int k,
                                           int lane, const SplineParams& p,
                                           bool inverse, LaneShares* own,
                                           WarpShares* warp) {
  if constexpr (G == 32) {
    if (lane_items<kUnit>(p.K) > 32)
      return warp_bin_chunked<kUnit, kDerivatives>(xv, valid, u, v, r, lane, p, inverse, warp);
  }
  return group_bin<G, kUnit, kDerivatives>(xv, valid, u, v, r, k, lane, p, inverse, own);
}

// A warp takes `rounds` x 32 / G elements a pass: in each round its
// groups find the bins of 32 / G elements, and lane t keeps the bin of
// element t of the pass; then each lane evaluates the spline of its own
// element and stores it. kSpread (rounds = G, where the input fills the
// card): every lane evaluates one element, and takes only the two
// softplus its bin needs, so neither is repeated in the G lanes of a
// group. Otherwise (rounds = 1, the shortest chain) every lane of a group
// takes the softplus of its own r[k] while the softmaxes run.
template <int G, bool kUnit, bool kSpread>
__global__ void __launch_bounds__(kThreads, kForwardBlocksPerSM)
    rqs_forward_kernel(const float* __restrict__ x, const float* __restrict__ u,
                       int64_t su, const float* __restrict__ v, int64_t sv,
                       const float* __restrict__ r, int64_t sr,
                       float* __restrict__ y, float* __restrict__ ld,
                       int64_t m, SplineParams p, int inverse) {
  constexpr int kPerRound = 32 / G;  // elements a warp holds at once
  constexpr int kRounds = kSpread ? G : 1;
  constexpr int kSpan = kPerRound * kRounds;
  const int lane = threadIdx.x & 31;
  const int k = lane & (G - 1);
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  // `first` and `round` are the same in every lane of the warp, so all
  // lanes run every iteration and every shuffle in it
  for (int64_t first = warp * kSpan; first < m; first += warps * kSpan) {
    Bin mine = {};
#pragma unroll 1
    for (int round = 0; round < kRounds; ++round) {
      const int64_t i = first + round * kPerRound + lane / G;
      const bool valid = i < m;
      const double xv = valid ? x[i] : 0.0f;
      const int64_t row = valid ? i : 0;
      LaneShares own;
      const Bin b = element_bin<G, kUnit, !kSpread>(xv, valid, u + row * su, v + row * sv,
                                                    r + row * sr, k, lane, p, inverse != 0,
                                                    &own, nullptr);
      // lane t's element is that of group t % kPerRound in round t / kPerRound
      const Bin moved = bin_from_lane<!kSpread>(b, (lane % kPerRound) * G);
      if (lane / kPerRound == round) mine = moved;
    }
    const int64_t i = first + lane;
    if (lane < kSpan && i < m) {
      const float xf = x[i];
      const double xv = xf;
      if (xv >= p.lo && xv <= p.hi) {
        if (kSpread) {
          const float* ri = r + i * sr;
          const int n_r = raw_derivatives<kUnit>(p.K);
          if (kUnit) {
            mine.dk = derivative_of(ri[mine.k], p);
            mine.dk1 = mine.k + 1 < n_r ? derivative_of(ri[mine.k + 1], p) : 1.0;
          } else {
            const double v0 = static_cast<double>(mine.k > 0 ? ri[mine.k - 1] : 0.0f) + p.shift;
            const double v1 = static_cast<double>(mine.k < p.K - 1 ? ri[mine.k] : 0.0f) + p.shift;
            mine.dk = mine.k == 0 ? 1.0 : derivative(v0, exp(-fabs(v0)), p);
            mine.dk1 = mine.k == p.K - 1 ? 1.0 : derivative(v1, exp(-fabs(v1)), p);
          }
        }
        double yv, ldv;
        spline_value(xv, mine, inverse != 0, &yv, &ldv);
        // rounding can put y a few ulp outside the unit box
        if (kUnit) yv = fmin(fmax(yv, p.lo), p.hi);
        y[i] = static_cast<float>(yv);
        ld[i] = static_cast<float>(ldv);
      } else {  // outside the box (and NaN): passed through
        y[i] = xf;
        ld[i] = 0.0f;
      }
    }
  }
}

// The backward of the forward (kInverse false) or of the inverse (true):
// the inverse finds the bin by the height knots and takes
// bin_backward_inverse; the rest is shared.
template <int G, bool kUnit, bool kInverse>
__global__ void __launch_bounds__(kThreads) rqs_backward_kernel(
    const float* __restrict__ x, const float* __restrict__ u, int64_t su,
    const float* __restrict__ v, int64_t sv, const float* __restrict__ r,
    int64_t sr, const float* __restrict__ gy, const float* __restrict__ gl,
    float* __restrict__ gx, float* __restrict__ gu, float* __restrict__ gv,
    float* __restrict__ gr, int64_t m, SplineParams p) {
  constexpr int kPerWarp = 32 / G;
  const int K = p.K;
  const int n_r = raw_derivatives<kUnit>(K);
  const int lane = threadIdx.x & 31;
  const int k = lane & (G - 1);
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const double c_w = (1.0 - p.min_w * K) * p.span;
  const double c_h = (1.0 - p.min_h * K) * p.span;
  bool chunked = false;
  if constexpr (G == 32) chunked = lane_items<kUnit>(K) > 32;
  for (int64_t first = warp * kPerWarp; first < m; first += warps * kPerWarp) {
    const int64_t i = first + lane / G;
    const bool valid = i < m;
    const double xv = valid ? x[i] : 0.0f;
    const double gyv = valid ? gy[i] : 0.0f;
    const double glv = valid ? gl[i] : 0.0f;
    const bool inside = valid && xv >= p.lo && xv <= p.hi;  // NaN is outside
    const int64_t row = valid ? i : 0;
    const float* ui = u + row * su;
    const float* vi = v + row * sv;
    const float* ri = r + row * sr;
    LaneShares own;
    WarpShares shares;
    const Bin b = element_bin<G, kUnit, true>(xv, valid, ui, vi, ri, k, lane, p, kInverse,
                                              &own, &shares);
    const BinGrad g = kInverse ? bin_backward_inverse(xv, b, gyv, glv, K)
                               : bin_backward(xv, b, gyv, glv, K);
    if (valid && k == 0)
      // outside the box: dx = gy, no parameter gradient
      gx[i] = inside ? static_cast<float>(g.x) : static_cast<float>(gyv);
    if (!chunked) {
      // every lane shuffles (b.k differs between the groups of a warp)
      const double below_w = from_lane<G>(own.upto_w, b.k > 0 ? b.k - 1 : 0);
      const double below_h = from_lane<G>(own.upto_h, b.k > 0 ? b.k - 1 : 0);
      const double le_w = from_lane<G>(own.upto_w, b.k);
      const double le_h = from_lane<G>(own.upto_h, b.k);
      const double lt_w = b.k == 0 ? 0.0 : below_w;
      const double lt_h = b.k == 0 ? 0.0 : below_h;
      const double g_u = share_gradient(own.p_w, lt_w, le_w, g.a_w, g.b_w, b.k, k, c_w);
      const double g_v = share_gradient(own.p_h, lt_h, le_h, g.a_h, g.b_h, b.k, k, c_h);
      const double g_r = raw_derivative_gradient<kUnit>(k, b.k, g, softplus_gradient(own.r, own.e_r));
      if (valid) {
        if (k < K) {
          gu[i * K + k] = inside ? static_cast<float>(g_u) : 0.0f;
          gv[i * K + k] = inside ? static_cast<float>(g_v) : 0.0f;
        }
        if (k < n_r) gr[i * n_r + k] = inside ? static_cast<float>(g_r) : 0.0f;
      }
    } else if (valid) {
      // pass 4 of the chunked path: every lane's items, chunk by chunk
      // (the element is the warp's, so `valid` is the same in every lane)
      const int items = K > n_r ? K : n_r;
      for (int j = lane; j < items; j += 32) {
        if (j < K) {
          const double p_w = exp(static_cast<double>(ui[j]) - static_cast<double>(shares.mu)) / shares.sum_w;
          const double p_h = exp(static_cast<double>(vi[j]) - static_cast<double>(shares.mv)) / shares.sum_h;
          const double g_u = share_gradient(p_w, shares.lt_w, shares.le_w, g.a_w, g.b_w, b.k, j, c_w);
          const double g_v = share_gradient(p_h, shares.lt_h, shares.le_h, g.a_h, g.b_h, b.k, j, c_h);
          gu[i * K + j] = inside ? static_cast<float>(g_u) : 0.0f;
          gv[i * K + j] = inside ? static_cast<float>(g_v) : 0.0f;
        }
        if (j < n_r) {
          const double rv = static_cast<double>(ri[j]) + p.shift;
          const double g_r = raw_derivative_gradient<kUnit>(j, b.k, g, softplus_gradient(rv, exp(-fabs(rv))));
          gr[i * n_r + j] = inside ? static_cast<float>(g_r) : 0.0f;
        }
      }
    }
  }
}

// log2 of the lanes an element takes: the next power of two at or above
// its lane items, at least 2 (a one-lane group is the two-lane one with a
// lane idle; ptxas spilled its own instance) and at most 32 (the chunked
// path above that).
int lane_shift(int items) {
  int s = 1;
  while ((1 << s) < items && s < 5) ++s;
  return s;
}

// The threads the card holds at once: 2048 on each SM.
cudaError_t resident_threads(int64_t* threads) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *threads = static_cast<int64_t>(sms) * 2048;
  return err;
}

// Blocks for `lanes` threads, at most as many as the card holds at once;
// the grid-stride loop covers the rest.
unsigned int grid_for(int64_t lanes, int64_t resident) {
  const int64_t want = (lanes + kThreads - 1) / kThreads;
  const int64_t most = resident / kThreads;
  return static_cast<unsigned int>(want < most ? want : most);
}

// The spline's constants; tails = 0 is linear tails on [-B, B], tails = 1
// the unit box [0, 1] (B unused).
SplineParams make_params(int K, double B, double min_w, double min_h,
                         double min_d, double shift, int tails) {
  SplineParams p;
  p.lo = tails ? 0.0 : -B;
  p.span = tails ? 1.0 : 2.0 * B;
  p.hi = p.lo + p.span;
  p.min_w = min_w;
  p.min_h = min_h;
  p.min_d = min_d;
  p.shift = shift;
  p.K = K;
  return p;
}

typedef void (*ForwardKernel)(const float*, const float*, int64_t,
                              const float*, int64_t, const float*, int64_t,
                              float*, float*, int64_t, SplineParams, int);
typedef void (*BackwardKernel)(const float*, const float*, int64_t,
                               const float*, int64_t, const float*, int64_t,
                               const float*, const float*, float*, float*,
                               float*, float*, int64_t, SplineParams);

// indexed by [tails][spread][lane_shift - 1]: G = 2, 4, 8, 16, 32
const ForwardKernel kForward[2][2][5] = {
    {{rqs_forward_kernel<2, false, false>, rqs_forward_kernel<4, false, false>,
      rqs_forward_kernel<8, false, false>, rqs_forward_kernel<16, false, false>,
      rqs_forward_kernel<32, false, false>},
     {rqs_forward_kernel<2, false, true>, rqs_forward_kernel<4, false, true>,
      rqs_forward_kernel<8, false, true>, rqs_forward_kernel<16, false, true>,
      rqs_forward_kernel<32, false, true>}},
    {{rqs_forward_kernel<2, true, false>, rqs_forward_kernel<4, true, false>,
      rqs_forward_kernel<8, true, false>, rqs_forward_kernel<16, true, false>,
      rqs_forward_kernel<32, true, false>},
     {rqs_forward_kernel<2, true, true>, rqs_forward_kernel<4, true, true>,
      rqs_forward_kernel<8, true, true>, rqs_forward_kernel<16, true, true>,
      rqs_forward_kernel<32, true, true>}}};
// indexed by [inverse][tails][lane_shift - 1]
const BackwardKernel kBackward[2][2][5] = {
    {{rqs_backward_kernel<2, false, false>, rqs_backward_kernel<4, false, false>,
      rqs_backward_kernel<8, false, false>, rqs_backward_kernel<16, false, false>,
      rqs_backward_kernel<32, false, false>},
     {rqs_backward_kernel<2, true, false>, rqs_backward_kernel<4, true, false>,
      rqs_backward_kernel<8, true, false>, rqs_backward_kernel<16, true, false>,
      rqs_backward_kernel<32, true, false>}},
    {{rqs_backward_kernel<2, false, true>, rqs_backward_kernel<4, false, true>,
      rqs_backward_kernel<8, false, true>, rqs_backward_kernel<16, false, true>,
      rqs_backward_kernel<32, false, true>},
     {rqs_backward_kernel<2, true, true>, rqs_backward_kernel<4, true, true>,
      rqs_backward_kernel<8, true, true>, rqs_backward_kernel<16, true, true>,
      rqs_backward_kernel<32, true, true>}}};

// The lane shift of K bins with these tails.
int shift_for(int K, int tails) { return lane_shift(tails ? K + 1 : K); }

}  // namespace

// Forward (inverse = 0) or inverse (inverse = 1) transform of m elements
// on `stream` (a cudaStream_t passed as a pointer). x, y and ld are
// contiguous [m]; row i of the widths starts at u + i * su (the K entries
// of a row contiguous), and so on; the derivatives' rows hold K - 1
// entries for linear tails (tails = 0, on [-B, B]) and K + 1 for
// tails=None (tails = 1, on [0, 1]). Returns the cudaError_t of the
// launch; 0 means success. m = 0 launches nothing; K < 1 or tails
// outside {0, 1} gives cudaErrorInvalidValue.
extern "C" int rqs_forward_launch(const void* x, const void* u, int64_t su,
                                  const void* v, int64_t sv, const void* r,
                                  int64_t sr, void* y, void* ld, int64_t m,
                                  int K, double B, double min_w,
                                  double min_h, double min_d, double shift,
                                  int inverse, int tails,
                                  void* stream) {
  if (K < 1 || (tails != 0 && tails != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  const int shift_g = shift_for(K, tails);
  int64_t resident = 0;
  const cudaError_t err = resident_threads(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  // G rounds a pass (one spline a lane) where G lanes an element would
  // not fit on the card at once, else one round
  const int64_t lanes = m << shift_g;
  const bool spread = lanes > resident;
  kForward[tails][spread][shift_g - 1]<<<grid_for(spread ? m : lanes, resident), kThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), su,
      static_cast<const float*>(v), sv, static_cast<const float*>(r), sr,
      static_cast<float*>(y), static_cast<float*>(ld), m,
      make_params(K, B, min_w, min_h, min_d, shift, tails), inverse);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Either backward of m elements (see the launches below).
int launch_backward(int inverse, const void* x, const void* u, int64_t su,
                    const void* v, int64_t sv, const void* r, int64_t sr,
                    const void* gy, const void* gl, void* gx, void* gu, void* gv,
                    void* gr, int64_t m, int K, double B, double min_w,
                    double min_h, double min_d, double shift, int tails,
                    void* stream) {
  if (K < 1 || (tails != 0 && tails != 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  const int shift_g = shift_for(K, tails);
  int64_t resident = 0;
  const cudaError_t err = resident_threads(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  kBackward[inverse][tails][shift_g - 1]<<<grid_for(m << shift_g, resident), kThreads, 0,
                                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u), su,
      static_cast<const float*>(v), sv, static_cast<const float*>(r), sr,
      static_cast<const float*>(gy), static_cast<const float*>(gl),
      static_cast<float*>(gx), static_cast<float*>(gu),
      static_cast<float*>(gv), static_cast<float*>(gr), m,
      make_params(K, B, min_w, min_h, min_d, shift, tails));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Backward of the forward transform: from x, the parameters and the
// cotangents gy, gl (contiguous [m]) to gx [m] and the contiguous
// gradients gu [m, K], gv [m, K], gr [m, K - 1] (tails = 0) or
// [m, K + 1] (tails = 1).
extern "C" int rqs_backward_launch(const void* x, const void* u, int64_t su,
                                   const void* v, int64_t sv, const void* r,
                                   int64_t sr, const void* gy, const void* gl,
                                   void* gx, void* gu, void* gv, void* gr,
                                   int64_t m, int K, double B, double min_w,
                                   double min_h, double min_d, double shift,
                                   int tails, void* stream) {
  return launch_backward(0, x, u, su, v, sv, r, sr, gy, gl, gx, gu, gv, gr, m, K, B,
                         min_w, min_h, min_d, shift, tails, stream);
}

// Backward of the inverse transform, with the arguments of
// rqs_backward_launch: x is the inverse's input (a y of the forward), gy
// and gl the cotangents of its output and of its log-derivative.
extern "C" int rqs_inverse_backward_launch(const void* x, const void* u, int64_t su,
                                           const void* v, int64_t sv, const void* r,
                                           int64_t sr, const void* gy, const void* gl,
                                           void* gx, void* gu, void* gv, void* gr,
                                           int64_t m, int K, double B, double min_w,
                                           double min_h, double min_d, double shift,
                                           int tails, void* stream) {
  return launch_backward(1, x, u, su, v, sv, r, sr, gy, gl, gx, gu, gv, gr, m, K, B,
                         min_w, min_h, min_d, shift, tails, stream);
}
