// Ordered 8-wide BVH walk for Hopper (sm_90a): one thread walks one ray
// through one tree.
//
// Replaces two Pallas TPU kernels that share one walk
// (pbrt_tpu/ops/bvh8.py::_walk8):
//   stream_walk8_kernel  <- pbrt_tpu/ops/stream_bvh.py::_stream_kernel
//       two-level traversal: each 1024-ray block carries a list of
//       candidate clusters (phase A, plain PyTorch), walked in order with
//       (t, slot) carried across them.  The TPU's sequential grid axis k
//       becomes a loop over k here, cut into segments (below).
//   wide_walk8_kernel    <- pbrt_tpu/ops/bvh8.py::_wide_kernel
//       the same walk over one whole tree.
//
// What the kernels compute is the reference's walk; how is rethought for
// the GPU.  The TPU walked 1024-ray packets with one scalar cursor and
// pushed children in the order of one representative lane's direction
// signs; here every thread keeps its own stack and orders pushes by its
// own ray's signs along the node's sort axis.  Results may differ from
// the reference only on exact t ties (the visiting order differs); they
// are bit-equal to the plain PyTorch version in kernels/bvh8_walk.py,
// which visits in the same per-ray order.  Built with -fmad=false so that
// every float operation rounds as PyTorch's does.
//
// Bound on this card: each step is a dependent 256-byte node fetch (or a
// 64-byte triangle fetch per slot) through the read-only cache, so the
// walk is latency-bound on those fetches, and it loses throughput to
// divergence between the 32 rays of a warp (rays arrive direction-sorted
// from the integrator, which keeps warps coherent).  What the design does
// about it:
// - the stack lives in shared memory, CAP entries per thread laid out
//   entry-major (entry e of thread t at e * THREADS + t, so the 32 lanes
//   of a warp always fall in distinct banks).  An 8-wide walk pops one
//   entry and pushes at most 8 per step, so a tree of `depth` interior
//   levels needs at most 7 depth + 1 entries; the host picks the smallest
//   template of 8, 16, 32, 64 or 96 entries that holds that
//   (kernels/bvh8_walk.py::stack_capacity), and 96 keeps the reference's
//   clamped writes for deeper trees;
// - node rows are read as 16-byte loads (three per pair of child boxes,
//   two for the refs, only when a box was hit), triangles as three;
// - on a sparse sweep (bounce and shadow rays: the integrator's sort puts
//   dead lanes last, so few warps have work) each live ray's candidate
//   list is cut into S segments, and each (32-ray group, segment) task is
//   one warp's work.  A persistent grid (the SM count times the CTAs that
//   fit on one) takes the tasks from a global counter; S = 4 x resident
//   warps / live groups, clamped to [1, candidate columns], is worked out
//   on the device from the groups that hold a live ray (t_max > RAY_EPS
//   and a candidate), so a dense sweep such as the camera sweep keeps S = 1
//   and exactly the sequential work, and a sparse one gets enough tasks
//   that the longest no longer sets the sweep's time.  Nothing in the walk
//   waits on another thread: no CTA barrier.
//
// Segments and the sequential result.  A task walks its candidates in
// order from the ray's t_max, carrying t within the segment; the tasks of
// a ray merge with one 64-bit atomicMin on the key (t bits << 32) | (k *
// slots + slot), k the candidate's position in the list and slot the hit
// within its tree (the host checks that k * slots fits 31 bits).  t >
// RAY_EPS > 0, so its float bits order as unsigned integers.  The key's
// minimum is the sequential walk's result: the sequential walk returns the
// least t; on a tie between candidates the earlier k, because a later hit
// must beat best_t strictly; within one tree, the first-visited triangle
// at that tree's least t, and the visiting order depends on the ray's
// signs, not on the starting t.  (A starting t can change which boxes are
// entered only through t_near < best_t; a box whose rounded t_near lies
// above the rounded t of a hit inside it could swap two hits whose t
// agree to an ulp: a tie, as bvh8_walk.walk_disagreement counts ties.)
// The warp that finishes a group's last task writes the group's results.
// Any hit: a task stops at its next candidate once another task of its ray
// has found a hit, so the slot returned may be another hit than the
// sequential walk's first; callers use only the any-hit mask (and t, which
// is -1e30 on every hit), which is what walk_disagreement compares.
//
// Table layout (pbrt_tpu/ops/bvh8.py docstring): node rows of 64 f32 --
// child c box in cols 6c..6c+5, child refs in cols 48..55 as exact f32
// integers, sort axis in col 56; leaf rows of 128 f32 = 8 triangle slots
// x 16 cols (p0 p1 p2 in cols 0..8).  A ref >= 0 is a node row; a ref
// < 0 is a leaf: -((first/8)*64 + count + 1).  Empty children have +inf
// boxes and never pass the slab test.

#include <cuda_runtime.h>
#include <stdint.h>

#define STACK_DEPTH 96
#define LEAF_COUNT_BITS 6
#define NODE_COLS 64
#define ROW_COLS 128
#define STREAM_BLOCK 1024
#define RAY_EPS 1e-4f
#define INERT_T (-1e30f)
#define THREADS 128
#define WARPS (THREADS / 32)
#define SEG_PER_WARP 4  // tasks per resident warp on a sparse sweep
#define NO_HIT 0xffffffffffffffffull

namespace {

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int sx, sy, sz;
};

__device__ __forceinline__ float safe_inv(float v) {
  const float sign = v < 0.0f ? -1.0f : 1.0f;
  const float r = sign / fmaxf(fabsf(v), 1e-20f);
  return fminf(fmaxf(r, -1e30f), 1e30f);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.ix = safe_inv(dx); r.iy = safe_inv(dy); r.iz = safe_inv(dz);
  r.sx = dx < 0.0f; r.sy = dy < 0.0f; r.sz = dz < 0.0f;
  return r;
}

// Slab test of the box (min xyz, max xyz) against (RAY_EPS, best_t).
__device__ __forceinline__ bool slab(float x0, float y0, float z0, float x1, float y1,
                                     float z1, const Ray& r, float best_t) {
  const float tlx = (x0 - r.ox) * r.ix;
  const float thx = (x1 - r.ox) * r.ix;
  const float tly = (y0 - r.oy) * r.iy;
  const float thy = (y1 - r.oy) * r.iy;
  const float tlz = (z0 - r.oz) * r.iz;
  const float thz = (z1 - r.oz) * r.iz;
  const float t_near = fmaxf(fmaxf(fminf(tlx, thx), fminf(tly, thy)), fminf(tlz, thz));
  const float t_far = fminf(fminf(fmaxf(tlx, thx), fmaxf(tly, thy)), fmaxf(tlz, thz));
  return t_near <= t_far && t_far > RAY_EPS && t_near < best_t;
}

// Walk one packed tree from `root`, folding hits into (best_t, best_prim);
// recorded ids are prim_base + packed slot.  `stack` is this thread's
// entry 0 in shared memory (entry e at stack[e * THREADS]); writes clamp
// to entry CAP - 1, which a stack of at least 7 depth + 1 entries never
// reaches.  Returns true when an any-hit walk found a hit (best_t is then
// inert and the thread is done with this ray).
template <int CAP>
__device__ __forceinline__ bool walk8(const float* __restrict__ nodes,
                                      const float* __restrict__ tris, int root,
                                      const Ray& r, float& best_t, int& best_prim,
                                      int prim_base, bool any_hit, int* stack) {
  int ref = root;
  int sp = 0;
  while (true) {
    if (ref < 0) {
      const int code = -ref - 1;
      const int first = (code >> LEAF_COUNT_BITS) << 3;
      const int count = code & ((1 << LEAF_COUNT_BITS) - 1);
      const float* leaf = tris + (size_t)(first >> 3) * ROW_COLS;
      for (int k = 0; k < count; ++k) {
        // a slot is 16 floats, 64-byte aligned: p0 p1 p2 in three float4s
        const float4* t4 =
            reinterpret_cast<const float4*>(leaf + (k >> 3) * ROW_COLS + 16 * (k & 7));
        const float4 a = __ldg(t4), b = __ldg(t4 + 1), c = __ldg(t4 + 2);
        const float p0x = a.x, p0y = a.y, p0z = a.z;
        const float e1x = a.w - p0x, e1y = b.x - p0y, e1z = b.y - p0z;
        const float e2x = b.z - p0x, e2y = b.w - p0y, e2z = c.x - p0z;
        const float pvx = r.dy * e2z - r.dz * e2y;
        const float pvy = r.dz * e2x - r.dx * e2z;
        const float pvz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const bool det_ok = fabsf(det) > 1e-12f;
        const float inv_det = det_ok ? 1.0f / det : 0.0f;
        const float tvx = r.ox - p0x, tvy = r.oy - p0y, tvz = r.oz - p0z;
        const float b0 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float b1 = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
        const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        if (det_ok && b0 >= 0.0f && b1 >= 0.0f && b0 + b1 <= 1.0f &&
            tt > RAY_EPS && tt < best_t) {
          best_prim = prim_base + first + k;
          best_t = tt;
        }
      }
      if (any_hit && best_prim >= 0) {
        best_t = INERT_T;
        return true;
      }
    } else {
      // a 256-byte row: child boxes 2q and 2q + 1 in float4s 3q..3q+2,
      // refs in float4s 12..13, the sort axis at col 56
      const float4* nf = reinterpret_cast<const float4*>(nodes + (size_t)ref * NODE_COLS);
      unsigned bits = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 u = __ldg(nf + 3 * q), v = __ldg(nf + 3 * q + 1),
                     w = __ldg(nf + 3 * q + 2);
        if (slab(u.x, u.y, u.z, u.w, v.x, v.y, r, best_t)) bits |= 1u << (2 * q);
        if (slab(v.z, v.w, w.x, w.y, w.z, w.w, r, best_t)) bits |= 2u << (2 * q);
      }
      if (bits) {
        const float4 ra = __ldg(nf + 12), rb = __ldg(nf + 13);
        const float refs[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
        const int h = __popc(bits);
        const int ax = (int)__ldg(reinterpret_cast<const float*>(nf) + 56);
        const int rev = ax == 0 ? r.sx : (ax == 1 ? r.sy : r.sz);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (bits & (1u << c)) {
            // rank = hit children strictly nearer along the sort axis, so
            // the nearest child lands on top of the stack
            const int rank = rev == 0 ? __popc(bits & ((1u << c) - 1u))
                                      : __popc(bits >> (c + 1));
            stack[min(sp + h - 1 - rank, CAP - 1) * THREADS] = (int)refs[c];
          }
        }
        sp += h;
      }
    }
    if (sp <= 0) return false;
    ref = stack[min(sp - 1, CAP - 1) * THREADS];
    sp -= 1;
  }
}

// Phase 1 of a streaming sweep, one thread per lane: every merge key to
// NO_HIT; each 32-lane group with a live ray (t_max > RAY_EPS and a
// candidate in its block) is listed for the walk (its finished-task count
// zeroed), its live rays counted; every lane of a group with none gets its
// result now (t_max, -1), as the sequential walk leaves it.
// header: [0] live rays, [1] listed groups, [2] next task, [3] S.
__global__ void __launch_bounds__(THREADS)
stream_prep8_kernel(const int* __restrict__ cnt, const float* __restrict__ tmax,
                    float* __restrict__ t_out, int* __restrict__ prim_out,
                    unsigned long long* __restrict__ keys, int* __restrict__ groups,
                    int* __restrict__ done, int* __restrict__ header) {
  const int i = blockIdx.x * THREADS + threadIdx.x;  // the launch covers n exactly
  const float t0 = tmax[i];
  const bool live = t0 > RAY_EPS && cnt[i / STREAM_BLOCK] > 0;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  keys[i] = NO_HIT;
  if (mask == 0) {
    t_out[i] = t0;
    prim_out[i] = -1;
  } else if ((threadIdx.x & 31) == 0) {
    const int pos = atomicAdd(header + 1, 1);
    groups[pos] = i >> 5;
    done[pos] = 0;
    atomicAdd(header, __popc(mask));
  }
}

// Phase 2: the persistent walk.  Each warp takes (group, segment) tasks
// from header[2] until none is left; see the note at the top.
// At most 80 registers, so that 6 CTAs of 128 threads fit on an SM.
template <int CAP>
__global__ void __launch_bounds__(THREADS, 6)
stream_walk8_kernel(const float* __restrict__ nodes, const float* __restrict__ tris,
                    const int* __restrict__ roots, const int* __restrict__ clist,
                    const int* __restrict__ cnt, const float* __restrict__ ox,
                    const float* __restrict__ oy, const float* __restrict__ oz,
                    const float* __restrict__ dx, const float* __restrict__ dy,
                    const float* __restrict__ dz, const float* __restrict__ tmax,
                    float* __restrict__ t_out, int* __restrict__ prim_out,
                    unsigned long long* keys, const int* __restrict__ groups,
                    int* __restrict__ done, int* __restrict__ header, int n_cand,
                    int nodes_pad, int leaves_pad, int any_hit) {
  extern __shared__ int stacks[];
  int* const stack = stacks + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int n_groups = header[1];
  // segments per group: four tasks per resident warp (the task queue then
  // evens out tasks of unequal length), at most one per candidate column,
  // and 1 (the sequential walk) on a dense sweep, such as config 3's
  // camera sweep (8192 groups against 4 x 3168 resident warps on an H100)
  const int seg_n =
      max(1, min(n_cand, SEG_PER_WARP * (int)gridDim.x * WARPS / max(n_groups, 1)));
  if (blockIdx.x == 0 && threadIdx.x == 0) header[3] = seg_n;
  const int n_tasks = n_groups * seg_n;
  const int slots = leaves_pad * 8;
  while (true) {
    int task = 0;
    if (lane == 0) task = atomicAdd(header + 2, 1);
    task = __shfl_sync(0xffffffffu, task, 0);
    if (task >= n_tasks) return;
    const int pos = task / seg_n;
    const int seg = task - pos * seg_n;
    const int i = groups[pos] * 32 + lane;
    const int b = i / STREAM_BLOCK;
    const int* cl = clist + (size_t)b * n_cand;
    const float t0 = tmax[i];
    float best_t = t0;
    int best = -1;  // k * slots + slot of the best hit
    if (t0 > RAY_EPS) {
      const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
      const int nc = cnt[b];
      const int k1 = (seg + 1) * nc / seg_n;
      for (int k = seg * nc / seg_n; k < k1; ++k) {
        // another task of this ray found a hit (a volatile read: keys change
        // under the walk)
        if (any_hit && seg_n > 1 && *(volatile unsigned long long*)(keys + i) != NO_HIT)
          break;
        const int cid = cl[k];
        if (walk8<CAP>(nodes + (size_t)cid * nodes_pad * NODE_COLS,
                       tris + (size_t)cid * leaves_pad * ROW_COLS, roots[cid], r, best_t,
                       best, k * slots, any_hit != 0, stack))
          break;
      }
    }
    if (seg_n == 1) {
      t_out[i] = best_t;
      prim_out[i] = best < 0 ? -1 : cl[best / slots] * slots + best % slots;
      continue;
    }
    if (best >= 0) {
      const unsigned long long key =
          any_hit ? (unsigned long long)best
                  : ((unsigned long long)__float_as_uint(best_t) << 32) | (unsigned)best;
      atomicMin(keys + i, key);
    }
    __threadfence();
    __syncwarp();
    int finished = 0;
    if (lane == 0) finished = atomicAdd(done + pos, 1);
    finished = __shfl_sync(0xffffffffu, finished, 0);
    if (finished == seg_n - 1) {  // this group's last task: write its results
      __threadfence();
      const unsigned long long key = atomicAdd(keys + i, 0ull);
      if (key == NO_HIT) {
        t_out[i] = t0;
        prim_out[i] = -1;
      } else {
        const int low = (int)(unsigned)key;
        t_out[i] = any_hit ? INERT_T : __uint_as_float((unsigned)(key >> 32));
        prim_out[i] = cl[low / slots] * slots + low % slots;
      }
    }
  }
}

template <int CAP>
__global__ void __launch_bounds__(THREADS, 4)
wide_walk8_kernel(const float* __restrict__ nodes, const float* __restrict__ tris,
                  const int* __restrict__ root, const float* __restrict__ ox,
                  const float* __restrict__ oy, const float* __restrict__ oz,
                  const float* __restrict__ dx, const float* __restrict__ dy,
                  const float* __restrict__ dz, const float* __restrict__ tmax,
                  float* __restrict__ t_out, int* __restrict__ prim_out, int n,
                  int any_hit) {
  extern __shared__ int stacks[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // whole-tree convention: spent lanes go inert at -1e30
  const float t0 = tmax[i];
  float best_t = t0 <= RAY_EPS ? INERT_T : t0;
  int best_prim = -1;
  if (t0 > RAY_EPS) {
    const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
    walk8<CAP>(nodes, tris, root[0], r, best_t, best_prim, 0, any_hit != 0,
               stacks + threadIdx.x);
  }
  t_out[i] = best_t;
  prim_out[i] = best_prim;
}

template <int CAP>
int stream_walk8(const float* nodes, const float* tris, const int* roots, const int* clist,
                 const int* cnt, const float* ox, const float* oy, const float* oz,
                 const float* dx, const float* dy, const float* dz, const float* tmax,
                 float* t_out, int* prim_out, long long* scratch, int n, int n_cand,
                 int nodes_pad, int leaves_pad, int any_hit, cudaStream_t stream) {
  // scratch: n merge keys, then n / 32 group ids, n / 32 finished-task
  // counts and the 4-int header
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(scratch);
  int* groups = reinterpret_cast<int*>(scratch + n);
  int* done = groups + n / 32;
  int* header = done + n / 32;
  const int smem = CAP * THREADS * 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_walk8_kernel<CAP>,
                                                        THREADS, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(header, 0, 4 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  stream_prep8_kernel<<<n / THREADS, THREADS, 0, stream>>>(cnt, tmax, t_out, prim_out, keys,
                                                          groups, done, header);
  stream_walk8_kernel<CAP><<<sms * per_sm, THREADS, smem, stream>>>(
      nodes, tris, roots, clist, cnt, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, keys,
      groups, done, header, n_cand, nodes_pad, leaves_pad, any_hit);
  return (int)cudaGetLastError();
}

template <int CAP>
int wide_walk8(const float* nodes, const float* tris, const int* root, const float* ox,
               const float* oy, const float* oz, const float* dx, const float* dy,
               const float* dz, const float* tmax, float* t_out, int* prim_out, int n,
               int any_hit, cudaStream_t stream) {
  wide_walk8_kernel<CAP><<<(n + THREADS - 1) / THREADS, THREADS, CAP * THREADS * 4, stream>>>(
      nodes, tris, root, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, n, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace

// the template of `cap` stack entries, F(CAP) a launch
#define WITH_CAP(cap, F)                        \
  switch (cap) {                                \
    case 8: return F(8);                        \
    case 16: return F(16);                      \
    case 32: return F(32);                      \
    case 64: return F(64);                      \
    case STACK_DEPTH: return F(STACK_DEPTH);    \
    default: return (int)cudaErrorInvalidValue; \
  }

// stack_cap: 8, 16, 32, 64 or 96 entries per thread (the smallest of at
// least 7 depth + 1 for the deepest tree; 96 clamps as the reference
// does); n a multiple of STREAM_BLOCK; n_cand * leaves_pad * 8 < 2^31;
// scratch: n + n / 32 + 2 int64 words.
extern "C" int launch_stream_walk8(const float* nodes, const float* tris,
                                   const int* roots, const int* clist, const int* cnt,
                                   const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz,
                                   const float* tmax, float* t_out, int* prim_out,
                                   long long* scratch, int n, int n_cand, int nodes_pad,
                                   int leaves_pad, int any_hit, int stack_cap,
                                   void* stream) {
  if (n % STREAM_BLOCK || n_cand < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
#define STREAM_WALK8(C)                                                                  \
  stream_walk8<C>(nodes, tris, roots, clist, cnt, ox, oy, oz, dx, dy, dz, tmax, t_out,  \
                  prim_out, scratch, n, n_cand, nodes_pad, leaves_pad, any_hit,         \
                  (cudaStream_t)stream)
  WITH_CAP(stack_cap, STREAM_WALK8)
#undef STREAM_WALK8
}

extern "C" int launch_wide_walk8(const float* nodes, const float* tris,
                                 const int* root, const float* ox, const float* oy,
                                 const float* oz, const float* dx, const float* dy,
                                 const float* dz, const float* tmax, float* t_out,
                                 int* prim_out, int n, int any_hit, int stack_cap,
                                 void* stream) {
  if (n == 0) return 0;
#define WIDE_WALK8(C) \
  wide_walk8<C>(nodes, tris, root, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, n, any_hit, \
                (cudaStream_t)stream)
  WITH_CAP(stack_cap, WIDE_WALK8)
#undef WIDE_WALK8
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
