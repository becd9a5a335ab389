// Bitonic co-sort of (uint32 key, int32 lane) pairs for Hopper (sm_90a).
//
// Replaces pbrt_tpu/ops/sortnet.py::_local_kernel (K5), the Pallas kernel
// that runs the stages of a bitonic co-sort whose exchange distance j is
// below one 2048-lane block with the block resident in VMEM, the XLA
// butterfly passes of sortnet.py::_global_pass between its calls, and the
// payload columns the reference moves through every stage.
//
// The network is the reference's: for k = 2 .. N and j = k/2 .. 1, lane i
// meets lane i ^ j, ascending where bit k of the global index is clear,
// and a pair swaps only when its keys are strictly out of order
// (sortnet.py:88), so equal keys never move.  The permutation depends only
// on that sequence of stages, not on how the stages are grouped into
// launches, so the grouping below gives the reference's permutation bit
// for bit.  Only the lane index rides the network, packed with its key
// into one 8-byte word (key in the high half, compared alone); one gather
// kernel then writes every payload column by the permutation.
//
// Three kernels, one host call (launch_co_sort) for a whole co_sort:
//   bitonic_tile_kernel   one CTA of 512 threads per 8192-lane tile (64 KB
//       of shared memory), 16 lanes per thread.  In layout A a thread holds
//       lanes warp * 512 + r * 32 + lane_id (r = 0..15): stages with j < 32
//       are warp shuffles, 32 <= j < 512 run in registers, and the stages
//       with j >= 512 of one merge size go through shared memory once
//       (layout B: r * 512 + warp * 32 + lane_id, those stages again in
//       registers), two barriers per merge size.  It runs k = 2 .. 8192 on
//       the first launch (reading the int64 keys and padding with
//       0xFFFFFFFF) and the j < 8192 tail of each k > 8192 (the last one
//       writes the sorted int64 keys and the int64 permutation);
//   bitonic_merge_kernel  for one k > 8192, the stages j = k/2 .. 8192 (at
//       most five per launch): the lanes that meet in them share their
//       index mod 8192 inside one k-block, so one thread loads such a
//       group of up to 32 lanes, runs the stages in registers and writes
//       it back once;
//   gather_rows_kernel    one thread per output row writes the row of
//       every payload operand (a by-value table of src, dst, row bytes).
// The launch list (kernels/bitonic.py::schedule) comes from the host as
// a step table.  A 262,144-lane sort is 1 tile launch, 5 x (merge + tile)
// and 1 gather: 12 launches where the first port made 36 and the
// reference 36 passes.
//
// Bound on this card: each network launch reads and writes 8 bytes per
// lane (the first reads the 8-byte key, the last writes 16 bytes), and
// the gather reads and writes each payload row once, so the sort is
// bound by device-memory bytes; with 32 tiles at 2^18 lanes the tile
// launches use 32 of the 132 SMs, which 8192-lane tiles trade for 11
// network launches instead of 15 with 2048-lane ones.

#include <cuda_runtime.h>
#include <stdint.h>

// TILE_LOG2 (8192-lane tiles), MERGE_MAX_LOG2 (stages per merge launch),
// MAX_GATHER (payload operands per gather) and KEY_PAD come from
// kernels/bitonic.py (NVCC_DEFINES) as -D values.
#if !defined(TILE_LOG2) || !defined(MERGE_MAX_LOG2) || !defined(MAX_GATHER) || !defined(KEY_PAD)
#error "compile with the -D values of kernels/bitonic.py::NVCC_DEFINES (kernels/build.py)"
#endif
#define TILE (1 << TILE_LOG2)
#define LANES 16                    // lanes per thread in the tile kernel
#define TILE_THREADS (TILE / LANES)  // 512
#define SPAN (32 * LANES)           // lanes per warp in layout A (512)
#define MERGE_THREADS 64
#define GATHER_THREADS 256

typedef unsigned long long u64;

namespace {

__device__ __forceinline__ uint32_t key_of(u64 v) { return (uint32_t)(v >> 32); }

// Ascending (or descending) compare-exchange of a pair held by one thread.
__device__ __forceinline__ void cmpx(u64& lo, u64& hi, bool asc) {
  const uint32_t a = key_of(lo), b = key_of(hi);
  if (asc ? b < a : b > a) {
    const u64 t = lo;
    lo = hi;
    hi = t;
  }
}

// The stage j = S * stride on registers v[r] that sit S * stride lanes
// apart; idx(r) is the global index of register r.  S is a compile-time
// constant so that every register index is one.
template <int S, int NR, class Idx>
__device__ __forceinline__ void reg_stage(u64 (&v)[NR], unsigned k, Idx idx) {
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (!(r & S)) cmpx(v[r], v[r + S], (idx(r) & k) == 0);
  }
}

// Stage j = s * stride for a run-time s in {1, 2, 4, 8} (<= NR / 2).
template <int NR, class Idx>
__device__ __forceinline__ void reg_stage_s(u64 (&v)[NR], unsigned s, unsigned k, Idx idx) {
  switch (s) {
    case 1: reg_stage<1>(v, k, idx); break;
    case 2: reg_stage<2>(v, k, idx); break;
    case 4: reg_stage<4>(v, k, idx); break;
    default: reg_stage<8>(v, k, idx); break;
  }
}

__global__ void __launch_bounds__(TILE_THREADS, 1)
bitonic_tile_kernel(const int64_t* __restrict__ keys_in, unsigned n, u64* __restrict__ packed,
                    int64_t* __restrict__ keys_out, int64_t* __restrict__ perm_out,
                    unsigned long long k_lo, unsigned long long k_hi) {
  extern __shared__ u64 sm[];
  const unsigned lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned base = blockIdx.x * TILE;
  const auto idx_a = [&](int r) { return base + warp * SPAN + r * 32 + lane_id; };
  const auto idx_b = [&](int r) { return base + r * SPAN + warp * 32 + lane_id; };
  u64 v[LANES];
#pragma unroll
  for (int r = 0; r < LANES; ++r) {
    const unsigned g = idx_a(r);
    if (keys_in != nullptr) {
      const uint32_t key = g < n ? (uint32_t)keys_in[g] : KEY_PAD;
      v[r] = ((u64)key << 32) | g;
    } else {
      v[r] = packed[g];
    }
  }
  for (unsigned long long kk = k_lo; kk <= k_hi; kk <<= 1) {
    const unsigned k = (unsigned)kk;
    unsigned j = (k < TILE ? k : TILE) >> 1;
    if (j >= SPAN) {  // the stages j >= 512 in layout B
#pragma unroll
      for (int r = 0; r < LANES; ++r) sm[idx_a(r) - base] = v[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < LANES; ++r) v[r] = sm[idx_b(r) - base];
      for (; j >= SPAN; j >>= 1) reg_stage_s(v, j / SPAN, k, idx_b);
#pragma unroll
      for (int r = 0; r < LANES; ++r) sm[idx_b(r) - base] = v[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < LANES; ++r) v[r] = sm[idx_a(r) - base];
      __syncthreads();  // the next merge size overwrites sm
    }
    for (; j >= 32; j >>= 1) reg_stage_s(v, j / 32, k, idx_a);
    for (; j >= 1; j >>= 1) {
      const bool lower = (lane_id & j) == 0;
#pragma unroll
      for (int r = 0; r < LANES; ++r) {
        const u64 p = __shfl_xor_sync(0xffffffffu, v[r], j);
        // keep the min where the pair ascends and this lane is the lower
        const bool want_min = ((idx_a(r) & k) == 0) == lower;
        const uint32_t a = key_of(v[r]), b = key_of(p);
        if (want_min ? b < a : b > a) v[r] = p;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < LANES; ++r) {
    const unsigned g = idx_a(r);
    if (keys_out != nullptr) {
      if (g < n) {
        keys_out[g] = (int64_t)key_of(v[r]);
        perm_out[g] = (int64_t)(uint32_t)v[r];
      }
    } else {
      packed[g] = v[r];
    }
  }
}

// The stages j = 2^(b+G_LOG2-1) .. 2^b of merge size k: one thread per
// group of 2^G_LOG2 lanes that differ only in index bits b .. b+G_LOG2-1.
template <int G_LOG2>
__global__ void __launch_bounds__(MERGE_THREADS)
bitonic_merge_kernel(u64* __restrict__ packed, unsigned n_groups, unsigned k, unsigned b) {
  constexpr int G = 1 << G_LOG2;
  const unsigned q = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (q >= n_groups) return;
  const unsigned low = (1u << b) - 1u;
  const unsigned g0 = ((q & ~low) << G_LOG2) | (q & low);
  const bool asc = (g0 & k) == 0;  // bit k lies above the group's bits
  u64 v[G];
#pragma unroll
  for (int r = 0; r < G; ++r) v[r] = packed[g0 + ((unsigned)r << b)];
#pragma unroll
  for (int s = G / 2; s >= 1; s >>= 1) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (!(r & s)) cmpx(v[r], v[r + s], asc);
    }
  }
#pragma unroll
  for (int r = 0; r < G; ++r) packed[g0 + ((unsigned)r << b)] = v[r];
}

struct GatherOp {
  const char* src;
  char* dst;
  unsigned long long row_bytes;  // a multiple of 4
};

struct GatherTable {
  GatherOp op[MAX_GATHER];
  int count;
};

// dst[i] = src[perm[i]] for every operand; a pad lane (perm >= n, only
// where a real key equals the pad key 0xFFFFFFFF) gives a zero row, as the
// reference's zero-padded columns do.
__global__ void __launch_bounds__(GATHER_THREADS)
gather_rows_kernel(const int64_t* __restrict__ perm, unsigned n, GatherTable table) {
  const unsigned i = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (i >= n) return;
  const long long p = perm[i];
  const bool pad = p >= (long long)n;
  // unrolled, so that every table entry is read at a constant offset
#pragma unroll
  for (int c = 0; c < MAX_GATHER; ++c) {
    if (c < table.count) {
      const GatherOp& op = table.op[c];
      const unsigned words = (unsigned)(op.row_bytes / 4);
      const uint32_t* s = reinterpret_cast<const uint32_t*>(op.src + (pad ? 0 : p) * op.row_bytes);
      uint32_t* d = reinterpret_cast<uint32_t*>(op.dst + (size_t)i * op.row_bytes);
      for (unsigned w = 0; w < words; ++w) d[w] = pad ? 0u : __ldg(s + w);
    }
  }
}

int tile(const int64_t* keys_in, unsigned n, u64* packed, int64_t* keys_out,
         int64_t* perm_out, unsigned n_pad, unsigned long long k_lo,
         unsigned long long k_hi, cudaStream_t stream) {
  const int smem = TILE * (int)sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(bitonic_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bitonic_tile_kernel<<<n_pad / TILE, TILE_THREADS, smem, stream>>>(
      keys_in, n, packed, keys_out, perm_out, k_lo, k_hi);
  return (int)cudaGetLastError();
}

int merge(u64* packed, unsigned n_pad, unsigned k, unsigned b, unsigned g, cudaStream_t stream) {
  const unsigned groups = n_pad >> g;
  const unsigned grid = (groups + MERGE_THREADS - 1) / MERGE_THREADS;
  switch (g) {
    case 1: bitonic_merge_kernel<1><<<grid, MERGE_THREADS, 0, stream>>>(packed, groups, k, b); break;
    case 2: bitonic_merge_kernel<2><<<grid, MERGE_THREADS, 0, stream>>>(packed, groups, k, b); break;
    case 3: bitonic_merge_kernel<3><<<grid, MERGE_THREADS, 0, stream>>>(packed, groups, k, b); break;
    case 4: bitonic_merge_kernel<4><<<grid, MERGE_THREADS, 0, stream>>>(packed, groups, k, b); break;
    case 5: bitonic_merge_kernel<5><<<grid, MERGE_THREADS, 0, stream>>>(packed, groups, k, b); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int gather(const int64_t* perm, unsigned n, const void* const* srcs, void* const* dsts,
           const long long* row_bytes, int n_ops, cudaStream_t stream) {
  if (n_ops < 0 || n_ops > MAX_GATHER) return (int)cudaErrorInvalidValue;
  GatherTable table = {};
  for (int c = 0; c < n_ops; ++c) {
    if (row_bytes[c] <= 0 || row_bytes[c] % 4) return (int)cudaErrorInvalidValue;
    table.op[c] = {static_cast<const char*>(srcs[c]), static_cast<char*>(dsts[c]),
                   (unsigned long long)row_bytes[c]};
  }
  table.count = n_ops;
  if (n == 0 || n_ops == 0) return 0;
  gather_rows_kernel<<<(n + GATHER_THREADS - 1) / GATHER_THREADS, GATHER_THREADS, 0, stream>>>(
      perm, n, table);
  return (int)cudaGetLastError();
}

bool valid_size(long long n, long long n_pad) {
  return n_pad >= TILE && n_pad <= (1LL << 31) && !(n_pad & (n_pad - 1)) && n >= 0 &&
         n <= n_pad;
}

bool valid_tile(long long n, long long n_pad, long long k_lo, long long k_hi) {
  return valid_size(n, n_pad) && k_lo >= 2 && k_hi <= n_pad && k_lo <= k_hi;
}

bool valid_merge(long long n_pad, long long k, long long b, long long g) {
  return valid_size(n_pad, n_pad) && b >= TILE_LOG2 && g >= 1 && g <= MERGE_MAX_LOG2 &&
         (1LL << (b + g)) <= k && k <= n_pad;
}

}  // namespace

// One tile launch: k = k_lo .. k_hi (powers of two), j = min(k, 8192)/2 .. 1.
// Reads keys_in [n] (pad lanes 0xFFFFFFFF) when given, else packed; writes
// keys_out / perm_out [n] when given, else packed [n_pad].
extern "C" int launch_bitonic_tile(const int64_t* keys_in, long long n, u64* packed,
                                   int64_t* keys_out, int64_t* perm_out, long long n_pad,
                                   long long k_lo, long long k_hi, void* stream) {
  if (!valid_tile(n, n_pad, k_lo, k_hi)) return (int)cudaErrorInvalidValue;
  return tile(keys_in, (unsigned)n, packed, keys_out, perm_out, (unsigned)n_pad,
              (unsigned long long)k_lo, (unsigned long long)k_hi, (cudaStream_t)stream);
}

// One merge launch: the stages j = 2^(b+g-1) .. 2^b of merge size k.
extern "C" int launch_bitonic_merge(u64* packed, long long n_pad, long long k, long long b,
                                    long long g, void* stream) {
  if (!valid_merge(n_pad, k, b, g)) return (int)cudaErrorInvalidValue;
  return merge(packed, (unsigned)n_pad, (unsigned)k, (unsigned)b, (unsigned)g,
               (cudaStream_t)stream);
}

extern "C" int launch_gather_rows(const int64_t* perm, long long n, const void* const* srcs,
                                  void* const* dsts, const long long* row_bytes, int n_ops,
                                  void* stream) {
  if (n < 0 || n > (1LL << 31)) return (int)cudaErrorInvalidValue;
  return gather(perm, (unsigned)n, srcs, dsts, row_bytes, n_ops, (cudaStream_t)stream);
}

// A whole co_sort in one call: the network over keys_in [n] padded to
// n_pad lanes (scratch: n_pad packed words) as the n_steps rows of steps,
// (0, k_lo, k_hi, 0) for a tile launch and (1, k, b, g) for a merge
// launch; the first row, a tile, reads keys_in, the last, a tile, writes
// the sorted keys and the permutation into keys_out / perm_out [n]; then
// every payload operand is gathered.  launches[0..2] receive the tile,
// merge and gather launches.
extern "C" int launch_co_sort(const int64_t* keys_in, long long n, long long n_pad,
                              const long long* steps, int n_steps, int64_t* keys_out,
                              int64_t* perm_out, u64* scratch, const void* const* srcs,
                              void* const* dsts, const long long* row_bytes, int n_ops,
                              int* launches, void* stream) {
  launches[0] = launches[1] = launches[2] = 0;
  if (!valid_size(n, n_pad) || n < 1 || n_steps < 1 || steps[0] != 0 ||
      steps[4 * (n_steps - 1)] != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  for (int s = 0; s < n_steps; ++s) {
    const long long* row = steps + 4 * s;
    const bool first = s == 0, last = s == n_steps - 1;
    int err;
    if (row[0] == 0 && valid_tile(n, n_pad, row[1], row[2])) {
      err = tile(first ? keys_in : nullptr, (unsigned)n, scratch, last ? keys_out : nullptr,
                 last ? perm_out : nullptr, (unsigned)n_pad, (unsigned long long)row[1],
                 (unsigned long long)row[2], st);
      launches[0] += !err;
    } else if (row[0] == 1 && valid_merge(n_pad, row[1], row[2], row[3])) {
      err = merge(scratch, (unsigned)n_pad, (unsigned)row[1], (unsigned)row[2],
                  (unsigned)row[3], st);
      launches[1] += !err;
    } else {
      err = (int)cudaErrorInvalidValue;
    }
    if (err) return err;
  }
  const int err = gather(perm_out, (unsigned)n, srcs, dsts, row_bytes, n_ops, st);
  if (err) return err;
  launches[2] += n_ops > 0;
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
