// The keyframed skip-link walk for Hopper (sm_90a): a prepass lists the
// live rays, then a persistent grid walks them, a warp per task of R rays.
//
// K7, anim_prep_kernel + anim_walk_kernel <- pbrt_tpu/ops/animated_intersect.py:176
// _bvh_walk, a jax.lax.while_loop (no Pallas kernel): motion blur's walk over
// the skip-link BVH of shutter-union boxes (each triangle's box is the union
// of its boxes at every keyframe, so any time-t position stays inside),
// whose leaves test up to 4 triangles blended per lane from their keyframe
// rows with the lane's hat weights w_k(t) = max(0, 1 - |t (K - 1) - k|).
//
// What it computes is the reference's walk, per ray: at an interior node
// whose box is hit (t_near <= t_far, t_far > RAY_EPS, t_near < best_t)
// descend to node + 1, else jump to the skip link; at a leaf whose box is
// hit, blend and test each triangle (ids clamped to T - 1) with
// Moller-Trumbore (|det| > 1e-12, a hit must beat best_t strictly), then
// go on at the skip link.  A lane whose t_max <= RAY_EPS cannot hit
// anything (a hit needs RAY_EPS < t < t_max); the prepass answers it with
// (t_max, -1, 0, 0), which is what the reference's walk returns for it.
// In any-hit mode a ray stops after the leaf that found a hit.
//
// Rounding.  The reference's compiled CPU code fuses a product that feeds a
// sum into one fused multiply-add; so do the kernel and its plain version
// (kernels/anim_walk.py, in float64: core/geometry.fma).  Of the K hat
// weights at most two are non-zero, those of the keys floor(x) and
// floor(x) + 1 either side of the lane's x = t (K - 1), and only their
// rows are read: each blended value is w_a * c_a, then fmaf(w_b, c_b, .)
// where the second key counts, as the plain version's fused sum over
// every key gives it (a zero weight adds an exact zero).  Moller-Trumbore
// fuses a*b - c*d as fmaf(a, b, -(c*d)) and x . y as fmaf(x2, y2, fmaf(x0,
// y0, x1*y1)); every other operation rounds on its own (-fmad=false).
// Kernel and plain version then differ only where float64's double
// rounding of a fused result differs from fmaf's single rounding.
//
// Two instances of one template on the scalar type T of the keyframe rows,
// the rays, the shutter times and the results: float (the default policy),
// and double (the double policy, where the reference blends the keyframe
// rows in float64, pbrt_tpu/ops/animated_intersect.py:57-58, casts the
// times to the rays' float and takes the hat weights there, :90-93, and
// tests the triangles in float64).  Both read the same float32 node boxes,
// as the reference's float32 BVH build gives them.  The double instance
// fuses with fma() where the float one fuses with fmaf(); its plain version
// has no wider type to fuse in (core/geometry.fma), so the two differ in
// the last bits of a double there.
//
// Bound on this card.  A walk is latency-bound: every step waits on a
// fetch (a node, then a triangle's keyframe rows), and a warp is as slow
// as its slowest ray.  The shutter-union boxes of a turning mesh overlap
// widely, so most of the work is triangle tests (8.8x the triangle tests
// of K6 on the static torus), and in a one-step-a-loop walk ("if-if") a
// warp runs a leaf's tests whenever any one of its rays stands on a leaf,
// the others idle.  What the design does about it:
// - a prepass (anim_prep_kernel) answers the dead lanes, lists the live
//   ones and counts them on the device; a persistent grid (the SM count
//   times the CTAs of this instance that fit on one, by the occupancy API:
//   the double instance takes more registers) takes tasks of R listed rays
//   from a global counter, one warp each.  R comes from the live count on
//   the device (task_shape): TASKS_PER_WARP tasks per resident warp, up to
//   32 rays a task, so a dense sweep fills whole warps and a sparse one
//   spreads its rays over more warps.  No node-range segments: a sweep of
//   the motion frame has more live rays than resident warps, and a 64-bit
//   merge key could not hold a double t.  The header says what the launch
//   found (live rays, resident warps, R, lanes per ray);
// - a sweep of at most GROUP_RAYS_PER_LANE live rays per resident lane
//   gives each ray a group of LEAF_TRIS lanes (R <= 32 / LEAF_TRIS): they
//   walk the ray's nodes in lockstep (one fetch, broadcast), and in a leaf
//   phase each tests one of the leaf's triangles and the group keeps the
//   least (t, k), which is what the sequential leaf loop keeps (the least
//   t, the first at equal t).  A leaf then costs one triangle fetch's
//   latency, not LEAF_TRIS: a sparse sweep's time is its longest ray's
//   chain of fetches.  Measured on the motion frame's sweeps
//   (scripts/k7_variants.py), groups win wherever a ray a lane leaves
//   too few warps to hide the fetches, and lose on the double instance's
//   dense sweeps;
// - the walk is a "while-while" loop with speculative traversal (Aila and
//   Laine, HPG 2009): each ray walks nodes until it holds a leaf whose box
//   it hits; a ray that holds one walks on while others of its warp still
//   search, and stops at the next such leaf without taking it; when every
//   ray of the warp holds a leaf or has finished, they test their leaves
//   together.  Then a warp runs as many leaf phases as its ray with the
//   most leaves, not one per step where any ray stands on a leaf.  Walking
//   on with a held, untested leaf tests interior boxes against a larger
//   best_t than the sequential walk has there, which only descends more:
//   a leaf is tested only after its own box passed against the current
//   best_t (a stopped ray tests its node again), a child's rounded slab
//   interval lies inside its parent's (the rounded operations are
//   monotone), and leaves are tested in DFS order; so the triangles tested
//   and their order, and the result, are the sequential walk's;
// - each triangle's K keyframe rows are packed once per intersector
//   (kernels/anim_walk.pack_keys), key-major and padded to whole 16-byte
//   vectors (12 floats: three float4; 10 doubles: five double2), so that
//   the two adjacent keys of a lane are one aligned run of 96 or 160
//   bytes, read as 6 or 10 vector loads issued together (before: 9 or 18
//   dependent scalar loads of unaligned 36- or 72-byte rows); nodes are
//   two 16-byte loads of the box row and one of (skip, first, count).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define WARPS (THREADS / 32)
#define PREP_THREADS 256
#define TASKS_PER_WARP 2  // tasks per resident warp on a sparse sweep
// a sweep of at most this many live rays per resident lane gives each ray
// a group of LEAF_TRIS lanes
#define GROUP_RAYS_PER_LANE 2
#define LEAF_TRIS 4       // the shutter-union BVH is built with leaf_size=4
#define MAX_DEVICES 64    // per-device launch caches
#define FULL 0xffffffffu

namespace {

__device__ __forceinline__ float fused(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fused(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__device__ __forceinline__ T safe_inv(T v) {
  const T sign = v < T(0) ? T(-1) : T(1);
  const T r = sign / fmax(fabs(v), T(1e-20));
  return fmin(fmax(r, T(-1e30)), T(1e30));
}

// One key's row of a packed table: 9 values in whole 16-byte vectors.
template <typename T>
struct Row;

template <>
struct Row<float> {
  static constexpr int PAD = 12;  // three float4
  float4 v[3];
  __device__ __forceinline__ void load(const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int j = 0; j < 3; ++j) v[j] = __ldg(q + j);
  }
  __device__ __forceinline__ float operator[](int j) const {
    const float4& a = v[j >> 2];
    switch (j & 3) {
      case 0: return a.x;
      case 1: return a.y;
      case 2: return a.z;
      default: return a.w;
    }
  }
};

template <>
struct Row<double> {
  static constexpr int PAD = 10;  // five double2
  double2 v[5];
  __device__ __forceinline__ void load(const double* p) {
    const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
    for (int j = 0; j < 5; ++j) v[j] = __ldg(q + j);
  }
  __device__ __forceinline__ double operator[](int j) const {
    return (j & 1) ? v[j >> 1].y : v[j >> 1].x;
  }
};

template <typename T>
struct Lane {  // one ray: its columns, reciprocals, keys and weights
  T ox, oy, oz, dx, dy, dz, ix, iy, iz;
  T wa, wb;  // the hat weights of keys ka and ka + 1 (wb = 0: one key)
  int ka;
};

// Blend triangle pid at the lane's keys and test it (the sequential
// walk's leaf step for one triangle); true with (tt, b0, b1) on a hit
// that beats best_t.
template <typename T>
__device__ __forceinline__ bool blend_test(const T* __restrict__ rows, int pid, int n_keys,
                                           const Lane<T>& r, T best_t, T ray_eps, T& tt,
                                           T& b0, T& b1) {
  constexpr int PAD = Row<T>::PAD;
  const T* base = rows + ((size_t)pid * n_keys + r.ka) * PAD;
  Row<T> ca, cb;
  ca.load(base);
  cb.load(base + (r.wb != T(0) ? PAD : 0));  // both keys' loads in flight at once
  T p[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) p[j] = r.wa * ca[j];
  if (r.wb != T(0)) {
#pragma unroll
    for (int j = 0; j < 9; ++j) p[j] = fused(r.wb, cb[j], p[j]);
  }
  const T e1x = p[3] - p[0], e1y = p[4] - p[1], e1z = p[5] - p[2];
  const T e2x = p[6] - p[0], e2y = p[7] - p[1], e2z = p[8] - p[2];
  const T pvx = fused(r.dy, e2z, -(r.dz * e2y));
  const T pvy = fused(r.dz, e2x, -(r.dx * e2z));
  const T pvz = fused(r.dx, e2y, -(r.dy * e2x));
  const T det = fused(e1z, pvz, fused(e1x, pvx, e1y * pvy));
  const bool det_ok = fabs(det) > T(1e-12);
  const T inv_det = det_ok ? T(1) / det : T(0);
  const T tvx = r.ox - p[0], tvy = r.oy - p[1], tvz = r.oz - p[2];
  b0 = fused(tvz, pvz, fused(tvx, pvx, tvy * pvy)) * inv_det;
  const T qvx = fused(tvy, e1z, -(tvz * e1y));
  const T qvy = fused(tvz, e1x, -(tvx * e1z));
  const T qvz = fused(tvx, e1y, -(tvy * e1x));
  b1 = fused(r.dz, qvz, fused(r.dx, qvx, r.dy * qvy)) * inv_det;
  tt = fused(e2z, qvz, fused(e2x, qvx, e2y * qvy)) * inv_det;
  return det_ok && b0 >= T(0) && b1 >= T(0) && b0 + b1 <= T(1) && tt > ray_eps && tt < best_t;
}

// The prepass, one thread per lane: a dead lane (t_max <= RAY_EPS) gets
// its result now, (t_max, -1, 0, 0); a live lane is listed and counted.
// The list keeps lane order within each PREP_THREADS-lane block; the
// blocks follow in the order their atomics land.  header: [0] live rays,
// [1] next task, [2] resident warps, [3] rays per task, [4] lanes per ray
// (zeroed before).
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
anim_prep_kernel(const T* __restrict__ tmax, T* __restrict__ t_out, int* __restrict__ prim_out,
                 T* __restrict__ b0_out, T* __restrict__ b1_out, int* __restrict__ list,
                 int* __restrict__ header, int n) {
  __shared__ int base[PREP_THREADS / 32 + 1];
  const int i = blockIdx.x * PREP_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T t0 = i < n ? tmax[i] : T(0);
  const bool live = i < n && t0 > T(1e-4);
  const unsigned mask = __ballot_sync(FULL, live);
  if (i < n && !live) {
    t_out[i] = t0;
    prim_out[i] = -1;
    b0_out[i] = T(0);
    b1_out[i] = T(0);
  }
  if (lane == 0) base[warp] = __popc(mask);
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < PREP_THREADS / 32; ++w) {
      const int c = base[w];
      base[w] = sum;
      sum += c;
    }
    base[PREP_THREADS / 32] = sum ? atomicAdd(header, sum) : 0;
  }
  __syncthreads();
  if (live) list[base[PREP_THREADS / 32] + base[warp] + __popc(mask & ((1u << lane) - 1u))] = i;
}

// Rays per task for `live` rays on `warps` resident warps: up to 32, fewer
// on a sparse sweep, so that there are TASKS_PER_WARP tasks per warp.
__device__ __forceinline__ int task_shape(int live, int warps) {
  return min(32, max(1, live / max(TASKS_PER_WARP * warps, 1)));
}

// The group of `lane` (G lanes a ray) takes the hit of the least (t, k) of
// its lanes' triangles k (the sequential leaf loop's: the least t, the
// first at equal t), every lane of the group ending with it.
template <typename T, int G>
__device__ __forceinline__ void group_min(bool& hit, T& tt, T& b0, T& b1, int& k) {
#pragma unroll
  for (int s = 1; s < G; s <<= 1) {
    const bool o_hit = __shfl_xor_sync(FULL, (int)hit, s);
    const T o_tt = __shfl_xor_sync(FULL, tt, s);
    const T o_b0 = __shfl_xor_sync(FULL, b0, s);
    const T o_b1 = __shfl_xor_sync(FULL, b1, s);
    const int o_k = __shfl_xor_sync(FULL, k, s);
    if (o_hit && (!hit || o_tt < tt || (o_tt == tt && o_k < k))) {
      hit = true;
      tt = o_tt;
      b0 = o_b0;
      b1 = o_b1;
      k = o_k;
    }
  }
}

// The tasks of one sweep: a warp takes `rays` listed rays a task (at most
// 32 / G), each walked by G lanes, by the while-while loop of the note
// above.  The G lanes of a ray walk in lockstep (the same loads, the same
// decisions); in a leaf phase they share the leaf's triangles.
template <typename T, int G>
__device__ __forceinline__ void walk_tasks(
    const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
    const T* __restrict__ rows, const T* __restrict__ ox, const T* __restrict__ oy,
    const T* __restrict__ oz, const T* __restrict__ dx, const T* __restrict__ dy,
    const T* __restrict__ dz, const T* __restrict__ tmax, const T* __restrict__ time,
    T* __restrict__ t_out, int* __restrict__ prim_out, T* __restrict__ b0_out,
    T* __restrict__ b1_out, const int* __restrict__ list, int* __restrict__ header, int live,
    int rays, int n_nodes, int n_tris, int n_keys, bool any_hit) {
  const T ray_eps = T(1e-4);  // RAY_EPS, rounded to T as the reference's compares it
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;  // this lane's place in its ray's group
  const int n_tasks = (live + rays - 1) / rays;
  while (true) {
    int task = 0;
    if (lane == 0) task = atomicAdd(header + 1, 1);
    task = __shfl_sync(FULL, task, 0);
    if (task >= n_tasks) return;
    const int p = task * rays + lane / G;
    const int i = lane / G < rays && p < live ? list[p] : -1;
    Lane<T> r;
    T best_t = T(0), best_b0 = T(0), best_b1 = T(0);
    int best_prim = -1;
    if (i >= 0) {
      r.ox = ox[i], r.oy = oy[i], r.oz = oz[i];
      r.dx = dx[i], r.dy = dy[i], r.dz = dz[i];
      r.ix = safe_inv(r.dx), r.iy = safe_inv(r.dy), r.iz = safe_inv(r.dz);
      best_t = tmax[i];
      // the hat weights (ops/animated_intersect.time_weights) of the two
      // keys either side of x, the only ones that can be non-zero
      const T x = fmin(fmax(time[i], T(0)), T(1)) * T(n_keys - 1);
      r.ka = min((int)floor(x), n_keys - 1);
      r.wa = fmax(T(0), T(1) - fabs(x - T(r.ka)));
      r.wb = r.ka + 1 < n_keys ? fmax(T(0), T(1) - fabs(x - T(r.ka + 1))) : T(0);
    }
    int node = 0;
    bool walking = i >= 0;  // nodes left to visit
    int held_first = 0, held_count = 0;  // the leaf this ray holds, untested
    bool stopped = false;  // at a leaf it may not take while it holds one
    while (__any_sync(FULL, walking || held_count > 0)) {
      // walk until every ray of the warp holds a leaf or has finished
      while (__any_sync(FULL, walking && held_count == 0)) {
        if (!walking || stopped) continue;
        const float4* f = reinterpret_cast<const float4*>(nodes_f + 8 * (size_t)node);
        const float4 a = __ldg(f), b = __ldg(f + 1);
        const int4 c = __ldg(reinterpret_cast<const int4*>(nodes_i + 4 * (size_t)node));
        const T tlx = (T(a.x) - r.ox) * r.ix, thx = (T(a.w) - r.ox) * r.ix;
        const T tly = (T(a.y) - r.oy) * r.iy, thy = (T(b.x) - r.oy) * r.iy;
        const T tlz = (T(a.z) - r.oz) * r.iz, thz = (T(b.y) - r.oz) * r.iz;
        const T t_near = fmax(fmax(fmin(tlx, thx), fmin(tly, thy)), fmin(tlz, thz));
        const T t_far = fmin(fmin(fmax(tlx, thx), fmax(tly, thy)), fmax(tlz, thz));
        const bool box_hit = t_near <= t_far && t_far > ray_eps && t_near < best_t;
        if (box_hit && c.z > 0) {
          if (held_count > 0) {  // speculating: keep this leaf for the next round
            stopped = true;
            continue;
          }
          held_first = c.y;
          held_count = c.z;
        }
        node = box_hit && c.z == 0 ? node + 1 : c.x;
        walking = node < n_nodes;
      }
      // the leaf phase: every ray that holds a leaf tests it, lane `sub` of
      // its group the triangles sub, sub + G, ... in order, each against the
      // least t so far (a hit must beat it strictly: the first of equal t
      // stays), then the group keeps the least (t, k)
      T tt = T(0), b0 = T(0), b1 = T(0);
      bool hit = false;
      int k_hit = 0;
#pragma unroll 1
      for (int k = sub; k < held_count && k < LEAF_TRIS; k += G) {
        T t1, c0, c1;
        if (blend_test(rows, min(held_first + k, n_tris - 1), n_keys, r, hit ? tt : best_t,
                       ray_eps, t1, c0, c1)) {
          hit = true;
          tt = t1;
          b0 = c0;
          b1 = c1;
          k_hit = k;
        }
      }
      group_min<T, G>(hit, tt, b0, b1, k_hit);
      if (hit) {
        best_prim = min(held_first + k_hit, n_tris - 1);
        best_b0 = b0;
        best_b1 = b1;
        best_t = tt;
      }
      if (held_count > 0) {
        held_count = 0;
        stopped = false;
        if (any_hit && best_prim >= 0) walking = false;
      }
    }
    if (i >= 0 && sub == 0) {
      t_out[i] = best_t;
      prim_out[i] = best_prim;
      b0_out[i] = best_b0;
      b1_out[i] = best_b1;
    }
  }
}

// The walk: persistent warps over the list.  A sweep of at most
// GROUP_RAYS_PER_LANE live rays per resident lane gives each ray
// LEAF_TRIS lanes, at most 32 / LEAF_TRIS rays a task, so that a leaf's
// triangles are tested at once (one fetch's latency a leaf, not
// LEAF_TRIS); a denser one walks a ray a lane.
template <typename T>
__global__ void __launch_bounds__(THREADS)
anim_walk_kernel(const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
                 const T* __restrict__ rows, const T* __restrict__ ox,
                 const T* __restrict__ oy, const T* __restrict__ oz,
                 const T* __restrict__ dx, const T* __restrict__ dy,
                 const T* __restrict__ dz, const T* __restrict__ tmax,
                 const T* __restrict__ time, T* __restrict__ t_out,
                 int* __restrict__ prim_out, T* __restrict__ b0_out,
                 T* __restrict__ b1_out, const int* __restrict__ list,
                 int* __restrict__ header, int n_nodes, int n_tris, int n_keys,
                 int any_hit) {
  const int live = header[0];
  const int warps = gridDim.x * WARPS;
  const int group = live <= GROUP_RAYS_PER_LANE * 32 * warps ? LEAF_TRIS : 1;
  const int rays = min(task_shape(live, warps), 32 / group);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    header[2] = warps;
    header[3] = rays;
    header[4] = group;
  }
  if (group == 1)
    walk_tasks<T, 1>(nodes_f, nodes_i, rows, ox, oy, oz, dx, dy, dz, tmax, time, t_out,
                     prim_out, b0_out, b1_out, list, header, live, rays, n_nodes, n_tris,
                     n_keys, any_hit != 0);
  else
    walk_tasks<T, LEAF_TRIS>(nodes_f, nodes_i, rows, ox, oy, oz, dx, dy, dz, tmax, time,
                             t_out, prim_out, b0_out, b1_out, list, header, live, rays,
                             n_nodes, n_tris, n_keys, any_hit != 0);
}

// The persistent grid of `kernel` on the current device: the SM count
// times the CTAs of THREADS threads that fit on one.  `cache` (one entry
// per device, 0 = not yet known) spares the queries on later launches.
template <class K>
cudaError_t persistent_grid(K kernel, int (&cache)[MAX_DEVICES], int& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[dev] > 0) {
    grid = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) cache[dev] = grid = sms * per_sm;
  return err;
}

template <typename T>
int launch(const float* nodes_f, const int* nodes_i, const T* rows, const T* ox, const T* oy,
           const T* oz, const T* dx, const T* dy, const T* dz, const T* tmax,
           const T* time, T* t_out, int* prim_out, T* b0_out, T* b1_out, int* scratch, int n,
           int n_nodes, int n_tris, int n_keys, int any_hit, void* stream_) {
  if (n_keys < 1 || n_tris < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t stream = (cudaStream_t)stream_;
  static int cache[MAX_DEVICES];
  int grid = 0;
  int* list = scratch;
  int* header = scratch + n;
  cudaError_t err = persistent_grid(anim_walk_kernel<T>, cache, grid);
  if (err == cudaSuccess) err = cudaMemsetAsync(header, 0, 5 * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  anim_prep_kernel<T><<<(n + PREP_THREADS - 1) / PREP_THREADS, PREP_THREADS, 0, stream>>>(
      tmax, t_out, prim_out, b0_out, b1_out, list, header, n);
  anim_walk_kernel<T><<<grid, THREADS, 0, stream>>>(
      nodes_f, nodes_i, rows, ox, oy, oz, dx, dy, dz, tmax, time, t_out, prim_out, b0_out,
      b1_out, list, header, n_nodes, n_tris, n_keys, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace

// nodes_f [n_nodes, 8] and nodes_i [n_nodes, 4] 16-byte aligned; rows the
// packed keyframe table [n_tris, n_keys, 12] (kernels/anim_walk.pack_keys),
// 16-byte aligned; n_keys >= 1; scratch n + 5 ints (the list, then the
// header).  The float instance:
extern "C" int launch_anim_walk(const float* nodes_f, const int* nodes_i, const float* rows,
                                const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* tmax, const float* time, float* t_out,
                                int* prim_out, float* b0_out, float* b1_out, int* scratch,
                                int n, int n_nodes, int n_tris, int n_keys, int any_hit,
                                void* stream) {
  return launch<float>(nodes_f, nodes_i, rows, ox, oy, oz, dx, dy, dz, tmax, time, t_out,
                       prim_out, b0_out, b1_out, scratch, n, n_nodes, n_tris, n_keys, any_hit,
                       stream);
}

// The double instance: rows [n_tris, n_keys, 10], rays, times and results
// in double; nodes float, as above.
extern "C" int launch_anim_walk_f64(const float* nodes_f, const int* nodes_i,
                                    const double* rows, const double* ox, const double* oy,
                                    const double* oz, const double* dx, const double* dy,
                                    const double* dz, const double* tmax, const double* time,
                                    double* t_out, int* prim_out, double* b0_out,
                                    double* b1_out, int* scratch, int n, int n_nodes,
                                    int n_tris, int n_keys, int any_hit, void* stream) {
  return launch<double>(nodes_f, nodes_i, rows, ox, oy, oz, dx, dy, dz, tmax, time, t_out,
                        prim_out, b0_out, b1_out, scratch, n, n_nodes, n_tris, n_keys, any_hit,
                        stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
