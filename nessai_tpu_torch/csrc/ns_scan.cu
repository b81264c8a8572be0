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
// dependence of each step on the one before: K steps in order, each a
// binary search and, on accept, a shift of up to n entries. The work
// per step is a few hundred bytes moved within the SM, so a step costs
// its barriers (1 + ceil((idx - 1) / 1024) + 1 on accept, one on a skip)
// and the search's dependent shared-memory reads. The design is the
// simple one, one block for the whole scan:
// - live and ids sit in shared memory (8 bytes an entry: n up to 29,056
//   in the 227 KB a block may take, set with cudaFuncSetAttribute);
//   above that they sit in global scratch that the wrapper allocates
//   (kept in L2, 50 MB), through the same generic pointers;
// - every thread computes ok and idx itself from the same data (the
//   binary search reads one address at a time, a broadcast), so the
//   branch on ok is the same in every thread and the barriers inside it
//   are met by the whole block;
// - the shift goes in chunks of the block's width: each thread reads its
//   entry into a register, __syncthreads, writes it one place down;
//   thread 0 then writes the candidate and the step's three outputs.
// Only float32 comparisons and integer moves, no atomics: the outputs
// are bit for bit those of the plain version (ns_scan_plain in
// ops/ns_scan.py) wherever live is sorted. NaN and -inf candidates (the
// -inf padding of a bucketed pool) are never accepted and give idx 0,
// as there.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
// the dynamic shared memory one block may take on an H100
constexpr int kMaxSharedBytes = 232448;

__global__ void __launch_bounds__(kThreads, 1)
    ns_scan_kernel(const float* __restrict__ live_in, const float* __restrict__ pool,
                   int n, int k, int max_accepts, unsigned char* __restrict__ mask,
                   int* __restrict__ consumed, int* __restrict__ ins,
                   int* __restrict__ final_ids, int* __restrict__ n_acc_out,
                   float* work_live, int* work_ids, int use_shared) {
  extern __shared__ unsigned char smem[];
  float* live = use_shared ? reinterpret_cast<float*>(smem) : work_live;
  int* ids = use_shared ? reinterpret_cast<int*>(smem + sizeof(float) * static_cast<size_t>(n))
                        : work_ids;
  const int t = threadIdx.x;
  for (int i = t; i < n; i += kThreads) {
    live[i] = live_in[i];
    ids[i] = i;
  }
  __syncthreads();
  int n_acc = 0;
  for (int j = 0; j < k; ++j) {
    const float p = pool[j];
    const bool ok = (p > live[0]) && (n_acc < max_accepts);
    // lower bound: the count of entries below p in the sorted array
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (live[mid] < p) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int m = lo - 1;
    if (t == 0) {
      mask[j] = ok ? 1 : 0;
      consumed[j] = ok ? ids[0] : -1;
      ins[j] = m;
    }
    if (ok) {
      // live[0 .. m-1] = live[1 .. m], a chunk of the block's width at a
      // time: every read of a chunk lands before any of its writes, and a
      // chunk writes below everything the next one reads
      for (int base = 0; base < m; base += kThreads) {
        const int i = base + t;
        float v = 0.0f;
        int id = 0;
        if (i < m) {
          v = live[i + 1];
          id = ids[i + 1];
        }
        __syncthreads();
        if (i < m) {
          live[i] = v;
          ids[i] = id;
        }
      }
      // every thread is past its search and the shift is written
      __syncthreads();
      if (t == 0) {
        live[m] = p;
        ids[m] = n + j;
      }
      ++n_acc;
    }
    __syncthreads();
  }
  for (int i = t; i < n; i += kThreads) final_ids[i] = ids[i];
  if (t == 0) *n_acc_out = n_acc;
}

}  // namespace

// The scan of k pool candidates against n sorted live logL on `stream`
// (a cudaStream_t passed as a pointer), in one launch of one block.
// Outputs: mask [k] (0/1 bytes), consumed [k], ins [k], final_ids [n],
// n_acc [1] (int32). work_live [n] and work_ids [n] are global scratch,
// read only where 8 n bytes exceed the block's shared memory (then they
// must not be null). Returns the cudaError_t of the launch; 0 means
// success. k = 0 copies the ids.
extern "C" int ns_scan_launch(const void* live, const void* pool, int n, int k,
                              int max_accepts, void* mask, void* consumed, void* ins,
                              void* final_ids, void* n_acc, void* work_live,
                              void* work_ids, void* stream) {
  if (n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared_bytes = (sizeof(float) + sizeof(int)) * static_cast<size_t>(n);
  const int use_shared = shared_bytes <= static_cast<size_t>(kMaxSharedBytes);
  if (!use_shared && (work_live == nullptr || work_ids == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = use_shared ? shared_bytes : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ns_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ns_scan_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(live), static_cast<const float*>(pool), n, k, max_accepts,
      static_cast<unsigned char*>(mask), static_cast<int*>(consumed), static_cast<int*>(ins),
      static_cast<int*>(final_ids), static_cast<int*>(n_acc), static_cast<float*>(work_live),
      static_cast<int*>(work_ids), use_shared);
  return static_cast<int>(cudaGetLastError());
}
