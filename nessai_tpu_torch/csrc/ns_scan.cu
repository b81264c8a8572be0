// Nested-sampling consume/insert scan for Hopper (sm_90a).
//
// Replaces the lax.scan of nessai_tpu/samplers/ns_device.py (scan_consume,
// line 42), which the JAX package chains onto its device-resident pool.
// For the sorted live logL (float32 [n], ascending) and a pool of
// candidates in pop order (float32 [K]), step j of K:
//   ok        = pool[j] > live[0]  and  n_acc < max_accepts
//   idx       = #{i : live[i] < pool[j]}       (searchsorted, side left)
//   consumed  = ok ? ids[0] : -1
//   ins       = idx - 1                         (recorded on every step)
//   on ok:  live[0 .. idx-2] = live[1 .. idx-1], live[idx-1] = pool[j],
//           the same for ids with the candidate's id n + j; n_acc += 1
// and at the end final_ids = ids and n_acc. Ids index
// concat(live, pool in pop order).
//
// What bounds it on the card: neither bytes nor operations but the
// dependence of each accepted step on the one before. The design keeps
// that chain short and takes everything else off it. One launch of one
// block; thread t owns the R consecutive positions t R .. t R + R - 1.
// - Rejections in bulk. While the cap is not reached, a candidate with
//   p <= live[0] (a tie, NaN or -inf too) is rejected with idx 0, since
//   live is sorted: mask 0, consumed -1, ins -1. The pool is staged in
//   shared memory a tile at a time; a warp holds 32 candidates, one a
//   lane, and __ballot_sync(p > live[0]) finds the next one that is
//   accepted. Every candidate before it costs nothing more; live[0]
//   changes only at an accept.
// - An accepted step is a count and a shift. Where the live set spans
//   several warps, their counts meet in shared memory behind one
//   __syncthreads, in two copies by the parity of the accept count so
//   that no step overwrites one still being read, and a warp's upper
//   neighbour leaves its first entry there the same way.
//   * Register path (n <= 4096): the entries sit in registers, R a
//     template parameter: one warp with 8, 16 or 32 a lane up to 1024
//     live points (no barrier at all; the block's other warps only stage
//     the pool and search the capped tail), then up to 8 warps of 16. The
//     count is R comparisons and __reduce_add_sync, the plain version's
//     own sum(live < p), so ties and NaN count as there; the shift is a
//     select a register, the entry from the upper neighbour by
//     __shfl_down_sync. On an H100 one warp of 32 a lane was faster than
//     four warps of 8 at nlive 1000, and four of 16 faster than one of 64
//     at 2000.
//   * Ring paths (n > 4096): 32 W threads, W = ceil(n / 1024) warps (at
//     most 32), R = ceil(n / (32 W)); thread t's positions are a ring of
//     R slots that starts at slot h (a register), slot s at address
//     s * 32 W + t (no bank conflicts, coalesced), in shared memory
//     (the logL and ids, 8 bytes an entry, up to 28,672 entries), the ids
//     in global scratch up to 57,344 entries, the logL too above. The
//     count is two votes: over the first entries of a warp's lanes, which
//     finds the last lane whose first entry is below p (every lane before
//     it lies wholly below p on sorted data, every lane after it wholly
//     at or above), then over that lane's ring, 32 slots a vote. The
//     shift: a thread whose every position lies below idx - 1 turns its
//     ring (the slot of its first entry takes its upper neighbour's first
//     entry and h moves on one); the warp of the ring holding idx - 1
//     moves that ring's entries below it down one, a slot a lane, and
//     writes p there. No thread reads another warp's rings during the
//     steps, so global scratch costs no more barriers than shared memory.
// - The capped tail in parallel. Once n_acc == max_accepts the live set
//   is frozen (the registers go to shared memory, the rings turn back to
//   slot 0) and every later step is an independent lower bound with
//   mask 0 and consumed -1, a candidate a thread.
// - Every thread takes the same branch at every barrier (the decisions
//   come from the same data), so no barrier sits in divergent code.
// Only float32 comparisons and integer moves, no atomics: the outputs are
// bit for bit those of the plain version (ns_scan_plain in ops/ns_scan.py)
// wherever live is sorted. Accepts are on strict p > live[0] only, and an
// accepted candidate goes in at the lower bound, before entries equal to
// it.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the register path: one warp of 8 to 32 entries a thread in a block of
// 256, or up to 8 warps of 16
constexpr int kRegisterMaxThreads = 256;
constexpr int kRegisterMaxLive = 4096;
constexpr int kRegisterTile = 2048;
// the ring paths: up to 32 warps; pool candidates staged in shared memory
// at a time; dynamic shared memory for the rings, 224 KB beside the
// static buffers
constexpr int kRingMaxThreads = 1024;
constexpr int kRingTile = 512;
constexpr int kRingBytes = 229376;

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fffffff); }

// bits 0 .. lead of a warp mask
__device__ __forceinline__ unsigned through(int lead) { return kFull >> (31 - lead); }

// slot of a ring's logical entry kk (0 <= kk < R) when it starts at slot h
__device__ __forceinline__ int ring_slot(int h, int kk, int R) {
  const int s = h + kk;
  return s >= R ? s - R : s;
}

// The register path (see the top of the file).
template <int R>
__global__ void __launch_bounds__(kRegisterMaxThreads, 1)
    ns_scan_register_kernel(const float* __restrict__ live_in, const float* __restrict__ pool, int n, int k,
                            int W, int max_accepts, unsigned char* __restrict__ mask, int* __restrict__ consumed,
                            int* __restrict__ ins, int* __restrict__ final_ids, int* __restrict__ n_acc_out) {
  __shared__ float tile[kRegisterTile];
  __shared__ float frozen[kRegisterMaxLive];
  __shared__ int counts[2][32];
  __shared__ float edge_v[2][32];
  __shared__ int edge_id[2][32];
  __shared__ float second_v[2];
  // W warps step; with one, the block's other warps only stage the pool
  // and search the capped tail
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  float v[R];
  int id[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = t * R + r;
    // NaN above n is never below p
    v[r] = g < n ? live_in[g] : quiet_nan();
    id[r] = g;
  }
  if (lane == 0) {
    edge_v[0][w] = v[0];
    edge_id[0][w] = id[0];
  }
  if (t == 0) second_v[0] = v[1];
  __syncthreads();
  float live0 = edge_v[0][0];
  int n_acc = 0;
  // every thread computes the same tail, the stepping warps in the loop
  // and the others from s_tail
  __shared__ int s_tail;
  int tail = max_accepts > 0 ? k : 0;
  for (int base = 0; base < tail; base += kRegisterTile) {
    const int len = min(kRegisterTile, k - base);
    for (int i = t; i < len; i += T) tile[i] = pool[base + i];
    __syncthreads();
    for (int c = 0; c < len && w < W; c += 32) {
      const int j0 = base + c;
      const bool valid = c + lane < len;
      const float pv = valid ? tile[c + lane] : quiet_nan();
      unsigned pending = __ballot_sync(kFull, valid);
      bool out_mask = false;
      int out_cons = -1, out_ins = -1;
      while (true) {
        const unsigned acc = __ballot_sync(kFull, pv > live0) & pending;
        if (acc == 0u) break;
        const int lead = __ffs(acc) - 1;
        const float p = __shfl_sync(kFull, pv, lead);
        const int j = j0 + lead;
        const int par = n_acc & 1;
        int below = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) below += v[r] < p ? 1 : 0;
        int idx = __reduce_add_sync(kFull, below);
        float second;
        if (W > 1) {
          if (lane == 0) counts[par][w] = idx;
          __syncthreads();
          idx = __reduce_add_sync(kFull, lane < W ? counts[par][lane] : 0);
          second = second_v[par];
        } else {
          second = __shfl_sync(kFull, v[1], 0);
        }
        const int cons = __shfl_sync(kFull, id[0], 0);
        float up_v = __shfl_down_sync(kFull, v[0], 1);
        int up_id = __shfl_down_sync(kFull, id[0], 1);
        if (lane == 31 && w + 1 < W) {
          up_v = edge_v[par][w + 1];
          up_id = edge_id[par][w + 1];
        }
        // this thread's offset of the insertion position idx - 1
        const int d = idx - 1 - t * R;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float src_v = r + 1 < R ? v[r + 1] : up_v;
          const int src_id = r + 1 < R ? id[r + 1] : up_id;
          v[r] = r < d ? src_v : (r == d ? p : v[r]);
          id[r] = r < d ? src_id : (r == d ? n + j : id[r]);
        }
        if (W > 1) {
          if (lane == 0) {
            edge_v[par ^ 1][w] = v[0];
            edge_id[par ^ 1][w] = id[0];
          }
          if (t == 0) second_v[par ^ 1] = v[1];
        }
        live0 = idx >= 2 ? second : p;
        if (lane == lead) {
          out_mask = true;
          out_cons = cons;
          out_ins = idx - 1;
        }
        pending &= ~through(lead);
        if (++n_acc >= max_accepts) {
          tail = j + 1;
          break;
        }
      }
      if (w == 0 && valid && j0 + lane < tail) {
        mask[j0 + lane] = out_mask ? 1 : 0;
        consumed[j0 + lane] = out_cons;
        ins[j0 + lane] = out_ins;
      }
      if (tail < k) break;
    }
    if (t == 0) s_tail = tail;
    // the stepping warps are past the tile, and the tail is known
    __syncthreads();
    tail = s_tail;
  }
  if (tail < k) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int g = t * R + r;
      if (g < n) frozen[g] = v[r];
    }
    __syncthreads();
    for (int j = tail + t; j < k; j += T) {
      const float p = pool[j];
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (frozen[mid] < p) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      mask[j] = 0;
      consumed[j] = -1;
      ins[j] = lo - 1;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = t * R + r;
    if (g < n) final_ids[g] = id[r];
  }
  if (t == 0) *n_acc_out = n_acc;
}

// The ring paths (see the top of the file).
template <bool kValsShared, bool kIdsShared>
__global__ void __launch_bounds__(kRingMaxThreads, 1)
    ns_scan_kernel(const float* __restrict__ live_in, const float* __restrict__ pool, int n, int k, int R,
                   int max_accepts, unsigned char* __restrict__ mask, int* __restrict__ consumed,
                   int* __restrict__ ins, int* __restrict__ final_ids, int* __restrict__ n_acc_out,
                   float* work_live, int* work_ids) {
  extern __shared__ float4 dynamic_smem[];
  __shared__ float tile[kRingTile];
  __shared__ int counts[2][32];
  // each warp's first entry, for the warp below it; live position 1
  __shared__ float edge_v[2][32];
  __shared__ int edge_id[2][32];
  __shared__ float second_v[2];
  const int T = blockDim.x;
  const int W = T >> 5;
  float* vals = kValsShared ? reinterpret_cast<float*>(dynamic_smem) : work_live;
  int* ids = kIdsShared ? reinterpret_cast<int*>(reinterpret_cast<float*>(dynamic_smem) + R * T) : work_ids;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int w = t >> 5;
  for (int r = 0; r < R; ++r) {
    const int g = t * R + r;
    // NaN above n is never below p
    vals[r * T + t] = g < n ? live_in[g] : quiet_nan();
    ids[r * T + t] = g;
  }
  int h = 0;
  float first_v = vals[t];
  int first_id = ids[t];
  // the owner of position 1 (thread 0 unless R = 1)
  const bool owns_second = R >= 2 ? t == 0 : t == 1;
  if (lane == 0) {
    edge_v[0][w] = first_v;
    edge_id[0][w] = first_id;
  }
  if (owns_second) second_v[0] = R >= 2 ? vals[T] : first_v;
  __syncthreads();
  float live0 = edge_v[0][0];
  int n_acc = 0;
  // the first step of the capped tail, k while the cap is not reached;
  // every thread computes the same value
  int tail = max_accepts > 0 ? k : 0;
  for (int base = 0; base < tail; base += kRingTile) {
    const int len = min(kRingTile, k - base);
    for (int i = t; i < len; i += T) tile[i] = pool[base + i];
    __syncthreads();
    for (int c = 0; c < len; c += 32) {
      const int j0 = base + c;
      const bool valid = c + lane < len;
      const float pv = valid ? tile[c + lane] : quiet_nan();
      unsigned pending = __ballot_sync(kFull, valid);
      bool out_mask = false;
      int out_cons = -1, out_ins = -1;
      while (true) {
        const unsigned acc = __ballot_sync(kFull, pv > live0) & pending;
        if (acc == 0u) break;
        const int lead = __ffs(acc) - 1;
        const float p = __shfl_sync(kFull, pv, lead);
        const int j = j0 + lead;
        const int par = n_acc & 1;
        // count: whole lanes by their first entries, then the last such
        // lane's ring
        const unsigned lanes_below = __ballot_sync(kFull, first_v < p);
        int below = 0;
        if (lanes_below != 0u) {
          const int last = __popc(lanes_below) - 1;
          const int h_last = __shfl_sync(kFull, h, last);
          const int owner = (w << 5) + last;
          int in_ring = 0;
          for (int kk0 = 0; kk0 < R; kk0 += 32) {
            const int kk = kk0 + lane;
            const bool lt = kk < R && vals[ring_slot(h_last, kk, R) * T + owner] < p;
            const unsigned votes = __ballot_sync(kFull, lt);
            in_ring += __popc(votes);
            if (votes != kFull) break;
          }
          below = last * R + in_ring;
        }
        int idx = below;
        if (W > 1) {
          if (lane == 0) counts[par][w] = below;
          __syncthreads();
          idx = __reduce_add_sync(kFull, lane < W ? counts[par][lane] : 0);
        }
        const int m = idx - 1;
        const int cons = __shfl_sync(kFull, first_id, 0);
        float up_v = __shfl_down_sync(kFull, first_v, 1);
        int up_id = __shfl_down_sync(kFull, first_id, 1);
        if (lane == 31 && w + 1 < W) {
          up_v = edge_v[par][w + 1];
          up_id = edge_id[par][w + 1];
        }
        const float second = second_v[par];
        // shift: the rings wholly below position m turn, and the warp of
        // the ring holding m moves that ring's entries below m
        const int t_m = m / R;
        if (t < t_m) {
          vals[h * T + t] = up_v;
          ids[h * T + t] = up_id;
          h = h + 1 == R ? 0 : h + 1;
        }
        if ((t_m >> 5) == w) {
          const int d = m - t_m * R;
          const int h_m = __shfl_sync(kFull, h, t_m & 31);
          for (int kk0 = 0; kk0 <= d; kk0 += 32) {
            const int kk = kk0 + lane;
            float v = p;
            int id = n + j;
            if (kk < d) {
              v = vals[ring_slot(h_m, kk + 1, R) * T + t_m];
              id = ids[ring_slot(h_m, kk + 1, R) * T + t_m];
            }
            __syncwarp();
            if (kk <= d) {
              vals[ring_slot(h_m, kk, R) * T + t_m] = v;
              ids[ring_slot(h_m, kk, R) * T + t_m] = id;
            }
          }
          __syncwarp();
        }
        if (t <= t_m) {
          first_v = vals[h * T + t];
          first_id = ids[h * T + t];
        }
        if (lane == 0) {
          edge_v[par ^ 1][w] = first_v;
          edge_id[par ^ 1][w] = first_id;
        }
        if (owns_second) second_v[par ^ 1] = R >= 2 ? vals[ring_slot(h, 1, R) * T + t] : first_v;
        live0 = idx >= 2 ? second : p;
        // the warp's next count reads the rings its lanes just wrote
        __syncwarp();
        if (lane == lead) {
          out_mask = true;
          out_cons = cons;
          out_ins = m;
        }
        pending &= ~through(lead);
        if (++n_acc >= max_accepts) {
          tail = j + 1;
          break;
        }
      }
      if (w == 0 && valid && j0 + lane < tail) {
        mask[j0 + lane] = out_mask ? 1 : 0;
        consumed[j0 + lane] = out_cons;
        ins[j0 + lane] = out_ins;
      }
      if (tail < k) break;
    }
    // the tile is read and, after the last, every step's writes are seen
    __syncthreads();
  }
  if (tail < k) {
    // turn every ring back to slot 0 (a rotation by h, one cycle of the
    // permutation at a time)
    if (h != 0) {
      int cycles = R, b = h;
      while (b != 0) {
        const int rem = cycles % b;
        cycles = b;
        b = rem;
      }
      for (int c0 = 0; c0 < cycles; ++c0) {
        const float keep_v = vals[c0 * T + t];
        const int keep_id = ids[c0 * T + t];
        int at = c0;
        while (true) {
          int next = at + h;
          if (next >= R) next -= R;
          if (next == c0) break;
          vals[at * T + t] = vals[next * T + t];
          ids[at * T + t] = ids[next * T + t];
          at = next;
        }
        vals[at * T + t] = keep_v;
        ids[at * T + t] = keep_id;
      }
      h = 0;
    }
    __syncthreads();
    for (int j = tail + t; j < k; j += T) {
      const float p = pool[j];
      // the threads whose first entry is below p, then that many whole
      // rings and the last one's entries below p
      int lo = 0, hi = T;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (vals[mid] < p) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      int idx = 0;
      if (lo > 0) {
        const int owner = lo - 1;
        int a = 0, b = R;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (vals[mid * T + owner] < p) {
            a = mid + 1;
          } else {
            b = mid;
          }
        }
        idx = owner * R + a;
      }
      mask[j] = 0;
      consumed[j] = -1;
      ins[j] = idx - 1;
    }
  }
  for (int r = 0; r < R; ++r) {
    const int g = t * R + r;
    if (g < n) final_ids[g] = ids[ring_slot(h, r, R) * T + t];
  }
  if (t == 0) *n_acc_out = n_acc;
}

template <bool kValsShared, bool kIdsShared>
cudaError_t launch(int threads, size_t smem, cudaStream_t stream, const float* live, const float* pool, int n,
                   int k, int R, int max_accepts, unsigned char* mask, int* consumed, int* ins, int* final_ids,
                   int* n_acc, float* work_live, int* work_ids) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(reinterpret_cast<const void*>(&ns_scan_kernel<kValsShared, kIdsShared>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ns_scan_kernel<kValsShared, kIdsShared><<<1, threads, smem, stream>>>(
      live, pool, n, k, R, max_accepts, mask, consumed, ins, final_ids, n_acc, work_live, work_ids);
  return cudaGetLastError();
}

}  // namespace

// The scan of k pool candidates against n sorted live logL on `stream`
// (a cudaStream_t passed as a pointer), in one launch of one block: the
// register path for n <= 4096, else 32 * min(32, ceil(n / 1024)) threads
// with R = ceil(n / threads) entries each. Outputs: mask [k] (0/1 bytes),
// consumed [k], ins [k], final_ids [n], n_acc [1] (int32). work_ids and
// work_live are global scratch of threads * R entries each: work_ids is
// read where the rings take more than 224 KB of shared memory at 8 bytes
// an entry, work_live where they do at 4 (there they must not be null).
// Returns the cudaError_t of the launch; 0 means success. k = 0 copies
// the ids.
extern "C" int ns_scan_launch(const void* live, const void* pool, int n, int k, int max_accepts,
                              void* mask, void* consumed, void* ins, void* final_ids, void* n_acc,
                              void* work_live, void* work_ids, void* stream) {
  if (n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= kRegisterMaxLive) {
    // one warp with 8, 16 or 32 entries a lane to 1024 live points; above,
    // 16 entries a thread in as few warps as hold them
    const int R = n <= 256 ? 8 : n <= 512 ? 16 : n <= 1024 ? 32 : 16;
    const int warps = (n + 32 * R - 1) / (32 * R);
    const int threads = warps == 1 ? kRegisterMaxThreads : 32 * warps;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(live);
    const float* q = static_cast<const float*>(pool);
    unsigned char* mk = static_cast<unsigned char*>(mask);
    int* cs = static_cast<int*>(consumed);
    int* in = static_cast<int*>(ins);
    int* fi = static_cast<int*>(final_ids);
    int* na = static_cast<int*>(n_acc);
    if (R == 8) {
      ns_scan_register_kernel<8><<<1, threads, 0, s>>>(l, q, n, k, warps, max_accepts, mk, cs, in, fi, na);
    } else if (R == 16) {
      ns_scan_register_kernel<16><<<1, threads, 0, s>>>(l, q, n, k, warps, max_accepts, mk, cs, in, fi, na);
    } else {
      ns_scan_register_kernel<32><<<1, threads, 0, s>>>(l, q, n, k, warps, max_accepts, mk, cs, in, fi, na);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int threads = 32 * min(32, (n + 1023) / 1024);
  const int R = (n + threads - 1) / threads;
  const size_t entries = static_cast<size_t>(R) * threads;
  const bool ids_shared = 8 * entries <= kRingBytes;
  const bool vals_shared = 4 * entries <= kRingBytes;
  if ((!ids_shared && work_ids == nullptr) || (!vals_shared && work_live == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (ids_shared ? 8 : vals_shared ? 4 : 0) * entries;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(live);
  const float* q = static_cast<const float*>(pool);
  unsigned char* mk = static_cast<unsigned char*>(mask);
  int* cs = static_cast<int*>(consumed);
  int* in = static_cast<int*>(ins);
  int* fi = static_cast<int*>(final_ids);
  int* na = static_cast<int*>(n_acc);
  float* wl = static_cast<float*>(work_live);
  int* wi = static_cast<int*>(work_ids);
  cudaError_t err;
  if (ids_shared) {
    err = launch<true, true>(threads, smem, s, l, q, n, k, R, max_accepts, mk, cs, in, fi, na, wl, wi);
  } else if (vals_shared) {
    err = launch<true, false>(threads, smem, s, l, q, n, k, R, max_accepts, mk, cs, in, fi, na, wl, wi);
  } else {
    err = launch<false, false>(threads, smem, s, l, q, n, k, R, max_accepts, mk, cs, in, fi, na, wl, wi);
  }
  return static_cast<int>(err);
}
