// Bitonic sort network of (uint32 key, int32 lane) pairs for Hopper (sm_90a).
//
// Replaces pbrt_tpu/ops/sortnet.py::_local_kernel (K5), the Pallas kernel
// that runs the stages of a bitonic co-sort whose exchange distance j is
// below one 2048-lane block with the block resident in VMEM, and the XLA
// butterfly passes of sortnet.py::_global_pass between them:
//   bitonic_local_kernel  one CTA of 1024 threads per 2048-lane block holds
//       the block's keys and lanes in shared memory (16 KB) and runs the
//       stages of merge sizes k = k_lo .. k_hi, j = min(k, 2048)/2 .. 1,
//       one compare-exchange pair per thread per stage;
//   bitonic_merge_kernel  one pass at distance j >= 2048 for merge size k,
//       one pair per thread, in device memory.
//
// The network is the reference's: partner i ^ j, ascending where bit k of
// the global index is clear, and the exact take rule of sortnet.py:88
// (a pair swaps only when the keys are strictly out of order, so equal
// keys never move and the permutation is deterministic).  What differs is
// what rides the network: the reference moved every payload column
// through every stage; here only the lane index does, and the caller
// gathers each payload column once by the resulting permutation, which
// gives bit-identical columns.  Keys arrive as int64 holding uint32
// values (the port's key type) and are compared as uint32.
//
// Bound on this card: the local kernel reads and writes each key and lane
// once (12 bytes in, 12 out per lane) and does 66 compare-exchange stages
// in shared memory with a barrier between stages; each merge pass moves
// the same 24 bytes per lane through device memory.  Nothing is tuned
// yet (one pair per thread, bank conflicts at small j, 1024-thread CTAs).

#include <cuda_runtime.h>
#include <stdint.h>

#define BLK 2048
#define HALF (BLK / 2)

namespace {

__device__ __forceinline__ unsigned pair_lo(unsigned t, unsigned j) {
  // the t-th index whose bit j is clear
  return ((t & ~(j - 1u)) << 1) | (t & (j - 1u));
}

__global__ void __launch_bounds__(HALF)
bitonic_local_kernel(int64_t* __restrict__ key, int* __restrict__ lane,
                     unsigned long long k_lo, unsigned long long k_hi) {
  __shared__ uint32_t sk[BLK];
  __shared__ int sl[BLK];
  const unsigned t = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * BLK;
  sk[t] = (uint32_t)key[base + t];
  sk[t + HALF] = (uint32_t)key[base + t + HALF];
  sl[t] = lane[base + t];
  sl[t + HALF] = lane[base + t + HALF];
  __syncthreads();
  for (unsigned long long k = k_lo; k <= k_hi; k <<= 1) {
    for (unsigned j = (unsigned)(k < BLK ? k : BLK) >> 1; j >= 1; j >>= 1) {
      const unsigned lo = pair_lo(t, j);
      const unsigned hi = lo + j;
      const bool asc = ((base + lo) & k) == 0;
      const uint32_t a = sk[lo], b = sk[hi];
      if (asc ? b < a : b > a) {
        sk[lo] = b;
        sk[hi] = a;
        const int la = sl[lo];
        sl[lo] = sl[hi];
        sl[hi] = la;
      }
      __syncthreads();
    }
  }
  key[base + t] = (int64_t)sk[t];
  key[base + t + HALF] = (int64_t)sk[t + HALF];
  lane[base + t] = sl[t];
  lane[base + t + HALF] = sl[t + HALF];
}

__global__ void __launch_bounds__(256)
bitonic_merge_kernel(int64_t* __restrict__ key, int* __restrict__ lane, size_t n_pairs,
                     unsigned long long k, unsigned j) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_pairs) return;
  const size_t lo = ((t & ~(size_t)(j - 1u)) << 1) | (t & (size_t)(j - 1u));
  const size_t hi = lo + j;
  const bool asc = (lo & k) == 0;
  const uint32_t a = (uint32_t)key[lo], b = (uint32_t)key[hi];
  if (asc ? b < a : b > a) {
    key[lo] = (int64_t)b;
    key[hi] = (int64_t)a;
    const int la = lane[lo];
    lane[lo] = lane[hi];
    lane[hi] = la;
  }
}

}  // namespace

extern "C" int launch_bitonic_local(int64_t* key, int* lane, long long n,
                                    long long k_lo, long long k_hi, void* stream) {
  bitonic_local_kernel<<<(unsigned)(n / BLK), HALF, 0, (cudaStream_t)stream>>>(
      key, lane, (unsigned long long)k_lo, (unsigned long long)k_hi);
  return (int)cudaGetLastError();
}

extern "C" int launch_bitonic_merge(int64_t* key, int* lane, long long n, long long k,
                                    long long j, void* stream) {
  const size_t pairs = (size_t)n / 2;
  bitonic_merge_kernel<<<(unsigned)((pairs + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      key, lane, pairs, (unsigned long long)k, (unsigned)j);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
