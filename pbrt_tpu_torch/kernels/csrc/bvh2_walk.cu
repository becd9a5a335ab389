// Binary BVH walks for Hopper (sm_90a): one thread walks one ray.
//
// Replaces three Pallas TPU kernels (pbrt_tpu/ops/):
//   whole_prep_kernel + ordered_walk2_kernel<CAP>
//       <- pallas_bvh.py::_ordered_kernel (K4): the ordered near-first
//       stack walk over one whole binary tree.
//   stream_walk2_kernel<false, CAP> <- stream_bvh.py::_stream_kernel with
//       _walk_tree (K4): the same walk over each candidate cluster of the
//       ray's 1024-ray block, carrying (t, slot) across clusters.
//   stream_walk2_kernel<true, CAP>  <- the same with _walk_tree_fused
//       (K4b): leaf children are tested at their parent, left first.
//   whole_prep_kernel + skip_walk_kernel <- pallas_bvh.py::_traverse_kernel
//       (K6): the skip-link walk over 4-triangle leaves that also returns
//       the barycentrics of the hit.
//
// What each kernel computes is its reference's walk; how is rethought for
// the GPU.  The TPU walked 1024-ray packets with one scalar cursor (the
// skip walk descended where ANY lane hit the box; the ordered walks
// picked the near child by one representative lane's direction octant).
// Here every thread walks its own ray: its own stack (writes clamped to
// the last entry as in pallas_bvh.py), its own octant for the near-first
// bit in node column 14, its own box tests.  Results may then differ from
// the reference only on exact t ties; they are bit-equal to the plain
// PyTorch versions in kernels/bvh2_walk.py, which visit in the same
// per-ray order.  Built with -fmad=false so that every float operation
// rounds as PyTorch's does.
//
// Bound on this card: every step is a dependent fetch (a 64-byte node row,
// a 64-byte triangle slot, or a 32+16-byte skip node), so the walks are
// latency-bound on those fetches and lose throughput to divergence
// between the rays of a warp.  What the designs do about it:
// - the stack walks keep a stack of CAP = 16, 32, 64 or 96 entries per
//   thread in shared memory, entry-major (entry e of thread t at
//   e * THREADS + t), CAP picked by the host from the deepest tree
//   (kernels/bvh2_walk.py::stack_capacity; a binary walk holds at most one
//   entry per level, and 96 keeps the reference's clamped writes); node
//   rows are scalar loads (16-byte loads of them made K4 1.5x slower on an
//   H100: scripts/walk_variants.py), triangles three 16-byte loads;
// - the skip walk reads a node as two 16-byte loads of its box row and
//   one of its (skip, first, count) row, and triangles as three (16-byte
//   node loads measured faster than scalar ones; fetching both possible
//   successors' rows during a step bought nothing and took 80 registers
//   instead of 64: scripts/walk_variants.py);
// - the whole-tree walks (K6 and whole-tree K4) fill the card whatever
//   their number of live rays.  A prepass (whole_prep_kernel) answers the
//   dead lanes, lists the live ones and counts them on the device; a
//   persistent grid (the SM count times the CTAs that fit on one) then
//   takes tasks of (R listed rays, segment) from a global counter, one
//   warp each.  R and the segments per ray S are worked out on the device
//   from the live count (task_shape): SEG_PER_WARP tasks per resident warp
//   (4224 warps on an H100: 8 CTAs of 4 warps on each of 132 SMs), so a
//   dense sweep of 262,144 live rays takes R = 31 and S = 1, the
//   sequential walk written straight out, and a sparse one fewer rays per
//   task, down to one; only with fewer live rays than resident warps is
//   S > 1.  A sweep of S = 1 takes a loop of its own, without the merge.
//   Nothing inside a walk waits on another thread: no CTA barrier.  The
//   streaming walks take no segments and no prepass (their rays arrive
//   sorted, dead lanes last).
//
// Segments and the sequential result.  The tasks of a ray merge with one
// 64-bit atomicMin on a key whose high word is the hit's t bits (t >
// RAY_EPS > 0 orders as unsigned integers) and whose low word says which
// hit the sequential walk would have kept on a tie; the warp that finishes
// a group's last task writes its results.
// - K6: task s walks the DFS node range [s M / S, (s + 1) M / S): it
//   starts at node s M / S with t = t_max and stops at the first node past
//   its range.  It skips only the box tests of ancestors outside its
//   range, which can only prune, so it tests every triangle of its range
//   that the sequential walk tests (ties aside: a box whose rounded t_near
//   lies above the rounded t of a hit inside it, as walk_disagreement
//   counts ties).  Low word: the triangle id.  The sequential walk keeps
//   the first-visited triangle at the least t (its test is strict), and
//   that is the least id, because leaf `first` grows in DFS order
//   (SkipLinkBVH checks it).  The finishing task recomputes the winner's
//   (b0, b1) with the same operations, so the bits are the sequential's.
// - K4 whole tree: task j < S = 2^L walks the j-th depth-L subtree in the
//   ray's own near-first order: from the root it takes the near child for
//   a 0 bit of j and the far child for a 1 bit, most significant first,
//   each child's box tested at t_max, then walks the subtree it reached.
//   A leaf above level L belongs to the task whose remaining bits are all
//   0.  A lower j is visited earlier by the sequential walk, so the low
//   word (j << (32 - SPLIT_LOG2_MAX)) | slot keeps its tie winner (the
//   host checks that slots fit the field).  A tree deeper than its stack
//   (96 entries, clamped writes) is walked unsplit: the clamp would drop
//   other entries in a task than in the sequential walk.
// Any hit: a task stops at its next node once its ray's key shows another
// task's hit, so the hit returned may be another than the sequential
// walk's first; callers read only the mask (accel/bvh.py::occluded), and
// walk_disagreement compares only masks for any hit.
//
// Layouts (pbrt_tpu/ops/pallas_bvh.py): ordered node rows of 16 f32 --
// left box in cols 0..5, right box in 6..11 (min xyz, max xyz), child
// refs in 12..13 as exact f32 integers, the per-octant near-first mask in
// 14; leaf rows of 128 f32 = 8 triangle slots x 16 cols.  A ref >= 0 is a
// node row, a ref < 0 a leaf -((first/8)*64 + count + 1).  Skip-link
// tables: nodes_f [M,8] (box), nodes_i [M,4] (skip, first, count), tris
// [T,16] (p0 p1 p2).

#include <cuda_runtime.h>
#include <stdint.h>

// SPLIT_LOG2_MAX (the most subtree levels a whole-tree K4 ray is split
// into) comes from kernels/bvh2_walk.py (NVCC_DEFINES) as a -D value.
#ifndef SPLIT_LOG2_MAX
#error "compile with the -D values of kernels/bvh2_walk.py::NVCC_DEFINES (kernels/build.py)"
#endif
#define STACK_DEPTH 96
#define LEAF_COUNT_BITS 6
#define NODE2_COLS 16
#define ROW_COLS 128
#define STREAM_BLOCK 1024
#define RAY_EPS 1e-4f
#define INERT_T (-1e30f)
#define THREADS 128
#define WARPS (THREADS / 32)
#define PREP_THREADS 256
#define SEG_PER_WARP 2     // tasks per resident warp on a sparse sweep
#define SKIP_MIN_RANGE 64  // nodes per K6 range at least
#define NO_HIT 0xffffffffffffffffull
#define SLOT_BITS (32 - SPLIT_LOG2_MAX)
#define MAX_DEVICES 64  // per-device launch caches

namespace {

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int octant;
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
  r.octant = (dx < 0.0f) * 4 + (dy < 0.0f) * 2 + (dz < 0.0f);
  return r;
}

// Slab test of the box (min xyz, max xyz) at b against (0, best_t).
__device__ __forceinline__ bool slab_v(const float* b, const Ray& r, float best_t) {
  const float tlx = (b[0] - r.ox) * r.ix;
  const float thx = (b[3] - r.ox) * r.ix;
  const float tly = (b[1] - r.oy) * r.iy;
  const float thy = (b[4] - r.oy) * r.iy;
  const float tlz = (b[2] - r.oz) * r.iz;
  const float thz = (b[5] - r.oz) * r.iz;
  const float t_near = fmaxf(fmaxf(fminf(tlx, thx), fminf(tly, thy)), fminf(tlz, thz));
  const float t_far = fminf(fminf(fmaxf(tlx, thx), fmaxf(tly, thy)), fmaxf(tlz, thz));
  return t_near <= t_far && t_far > RAY_EPS && t_near < best_t;
}

// Moller-Trumbore on the triangle p = (p0 p1 p2); true on a hit nearer
// than best_t, with (tt, b0, b1) set.
__device__ __forceinline__ bool tri_test_v(const float (&p)[9], const Ray& r, float best_t,
                                           float& tt, float& b0, float& b1) {
  const float p0x = p[0], p0y = p[1], p0z = p[2];
  const float e1x = p[3] - p0x, e1y = p[4] - p0y, e1z = p[5] - p0z;
  const float e2x = p[6] - p0x, e2y = p[7] - p0y, e2z = p[8] - p0z;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = fabsf(det) > 1e-12f;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - p0x, tvy = r.oy - p0y, tvz = r.oz - p0z;
  b0 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  b1 = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return det_ok && b0 >= 0.0f && b1 >= 0.0f && b0 + b1 <= 1.0f && tt > RAY_EPS &&
         tt < best_t;
}

// The 16-float triangle slot at t (64-byte aligned): p0 p1 p2 in three
// 16-byte loads through the read-only cache.
__device__ __forceinline__ void tri16(const float* __restrict__ t, float (&p)[9]) {
  const float4* t4 = reinterpret_cast<const float4*>(t);
  const float4 a = __ldg(t4), b = __ldg(t4 + 1), c = __ldg(t4 + 2);
  p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
  p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
  p[8] = c.x;
}

// One ordered node row: both children's boxes, their refs, the mask.
struct NodeRow {
  float box[12];
  int left, right, mask;
};

// Where a stack walk finds its rows and keeps its stack: node rows as
// scalar loads through the read-only cache, triangles as three 16-byte
// loads, a CAP-entry stack per thread in shared memory (entry e of this
// thread at stack[e * THREADS]).  stop(): another task of the ray found a
// hit (SplitTables only).
template <int CAP_>
struct Tables {
  static constexpr int CAP = CAP_;
  const float* nodes;
  const float* tris;
  int* stack;
  __device__ __forceinline__ void node(int ref, NodeRow& n) const {
    const float* nf = nodes + (size_t)ref * NODE2_COLS;
#pragma unroll
    for (int c = 0; c < 12; ++c) n.box[c] = __ldg(nf + c);
    n.left = (int)__ldg(nf + 12);
    n.right = (int)__ldg(nf + 13);
    n.mask = (int)__ldg(nf + 14);
  }
  __device__ __forceinline__ void tri(const float* t, float (&p)[9]) const { tri16(t, p); }
  __device__ __forceinline__ int& slot(int i) const { return stack[i * THREADS]; }
  __device__ __forceinline__ bool stop() const { return false; }
};

// The whole-tree K4 task's tables: `flag` is its ray's merge key when the
// ray is split and the walk is any-hit, else null.
template <int CAP_>
struct SplitTables : Tables<CAP_> {
  const unsigned long long* flag;
  __device__ __forceinline__ bool stop() const {
    return flag != nullptr && *(volatile const unsigned long long*)flag != NO_HIT;
  }
};

// All triangles of the leaf `ref`, in slot order; ids prim_base + slot.
template <class Tab>
__device__ __forceinline__ void leaf_test(const Tab& tab, int ref, const Ray& r,
                                          float& best_t, int& best_prim, int prim_base) {
  const int code = -ref - 1;
  const int first = (code >> LEAF_COUNT_BITS) << 3;
  const int count = code & ((1 << LEAF_COUNT_BITS) - 1);
  const float* leaf = tab.tris + (size_t)(first >> 3) * ROW_COLS;
  for (int k = 0; k < count; ++k) {
    float p[9], tt, b0, b1;
    tab.tri(leaf + (k >> 3) * ROW_COLS + 16 * (k & 7), p);
    if (tri_test_v(p, r, best_t, tt, b0, b1)) {
      best_prim = prim_base + first + k;
      best_t = tt;
    }
  }
}

// Ordered near-first walk of one packed binary tree from `root`
// (stream_bvh.py::_walk_tree).  Stack writes clamp to entry CAP - 1, as
// in pallas_bvh.py; a stack of at least the tree's depth never clamps (a
// binary walk holds at most one entry per level above the current node).
// Returns true when an any-hit walk found a hit (best_t is then inert and
// the thread is done) or was told to stop.
template <class Tab>
__device__ __forceinline__ bool walk2(const Tab& tab, int root, const Ray& r, float& best_t,
                                      int& best_prim, int prim_base, bool any_hit) {
  int ref = root;
  int sp = 0;
  while (true) {
    if (any_hit && tab.stop()) return true;
    bool pop = true;
    if (ref < 0) {
      leaf_test(tab, ref, r, best_t, best_prim, prim_base);
      if (any_hit && best_prim >= 0) {
        best_t = INERT_T;
        return true;
      }
    } else {
      NodeRow nd;
      tab.node(ref, nd);
      const bool hl = slab_v(nd.box, r, best_t);
      const bool hr = slab_v(nd.box + 6, r, best_t);
      const bool left_first = ((nd.mask >> r.octant) & 1) == 1;
      if (hl && hr) {
        tab.slot(min(sp, Tab::CAP - 1)) = left_first ? nd.right : nd.left;
        sp += 1;
        ref = left_first ? nd.left : nd.right;
        pop = false;
      } else if (hl || hr) {
        ref = hl ? nd.left : nd.right;
        pop = false;
      }
    }
    if (pop) {
      if (sp <= 0) return false;
      ref = tab.slot(min(sp - 1, Tab::CAP - 1));
      sp -= 1;
    }
  }
}

// Fused-leaf walk (stream_bvh.py::_walk_tree_fused): both children are
// box-tested first, then leaf children are tested at the parent, left
// before right; only interior children are descended.  An any-hit walk
// stops after the step that found a hit (t keeps the hit's value).
template <class Tab>
__device__ __forceinline__ bool walk2_fused(const Tab& tab, int root, const Ray& r,
                                            float& best_t, int& best_prim, int prim_base,
                                            bool any_hit) {
  if (root < 0) {
    leaf_test(tab, root, r, best_t, best_prim, prim_base);
    return any_hit && best_prim >= 0;
  }
  int node = root;
  int sp = 0;
  while (true) {
    NodeRow nd;
    tab.node(node, nd);
    const bool hl = slab_v(nd.box, r, best_t);
    const bool hr = slab_v(nd.box + 6, r, best_t);
    const int l = nd.left;
    const int rr = nd.right;
    if (hl && l < 0) leaf_test(tab, l, r, best_t, best_prim, prim_base);
    if (hr && rr < 0) leaf_test(tab, rr, r, best_t, best_prim, prim_base);
    const bool go_l = hl && l >= 0;
    const bool go_r = hr && rr >= 0;
    const bool left_first = ((nd.mask >> r.octant) & 1) == 1;
    const bool near_go = left_first ? go_l : go_r;
    const bool far_go = left_first ? go_r : go_l;
    const int near = left_first ? l : rr;
    const int far = left_first ? rr : l;
    if (near_go && far_go) {
      tab.slot(min(sp, Tab::CAP - 1)) = far;
      sp += 1;
    }
    if (near_go) {
      node = near;
    } else if (far_go) {
      node = far;
    } else {
      if (sp <= 0) return any_hit && best_prim >= 0;
      node = tab.slot(min(sp - 1, Tab::CAP - 1));
      sp -= 1;
    }
    if (any_hit && best_prim >= 0) return true;
  }
}

// Where task j of 2^lg starts (see the note at the top): from the root,
// lg steps down in the ray's near-first order, to the near child on a 0
// bit of j and the far child on a 1 bit, most significant first, each
// child's box tested at t_max.  Sets ref to the subtree's root; false when
// the task has nothing to walk (a box on the way missed, or a leaf above
// level lg that belongs to another task).
template <class Tab>
__device__ __forceinline__ bool subtree_root(const Tab& tab, int& ref, const Ray& r,
                                             float t_max, int j, int lg) {
  for (int lvl = 0; lvl < lg; ++lvl) {
    if (ref < 0) return (j & ((1 << (lg - lvl)) - 1)) == 0;
    NodeRow nd;
    tab.node(ref, nd);
    const bool left_first = ((nd.mask >> r.octant) & 1) == 1;
    const bool take_left = left_first == (((j >> (lg - 1 - lvl)) & 1) == 0);
    float box[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) box[c] = take_left ? nd.box[c] : nd.box[c + 6];
    if (!slab_v(box, r, t_max)) return false;
    ref = take_left ? nd.left : nd.right;
  }
  return true;
}

// One skip-link node: its box row as two 16-byte loads, its (skip, first,
// count) row as one.
struct SkipNode {
  float box[6];
  int skip, first, count;
};

__device__ __forceinline__ void skip_node(const float* __restrict__ nodes_f,
                                          const int* __restrict__ nodes_i, int v,
                                          SkipNode& s) {
  const float4* f = reinterpret_cast<const float4*>(nodes_f + 8 * (size_t)v);
  const float4 a = __ldg(f), b = __ldg(f + 1);
  const int4 c = __ldg(reinterpret_cast<const int4*>(nodes_i + 4 * (size_t)v));
  s.box[0] = a.x; s.box[1] = a.y; s.box[2] = a.z; s.box[3] = a.w;
  s.box[4] = b.x; s.box[5] = b.y;
  s.skip = c.x;
  s.first = c.y;
  s.count = c.z;
}

// The skip-link walk (pallas_bvh.py::_traverse_kernel, per ray) of the
// DFS node range [a, b) from best_t: at an interior node whose box is hit
// descend to node + 1, else jump to the skip link; at a leaf whose box is
// hit test its triangles (ids clamped to T - 1, pallas_bvh.py:114).  It
// stops at the first node >= b, after the step that found an any-hit
// hit, or once `flag` (when not null) shows another task's hit.
__device__ __forceinline__ void skip_range(const float* __restrict__ nodes_f,
                                           const int* __restrict__ nodes_i,
                                           const float* __restrict__ tris, int a, int b,
                                           int n_tris, const Ray& r, float& best_t,
                                           int& best_prim, float& best_b0, float& best_b1,
                                           bool any_hit, const unsigned long long* flag) {
  int node = a;
  while (node < b) {
    SkipNode cur;
    skip_node(nodes_f, nodes_i, node, cur);
    const bool box_hit = slab_v(cur.box, r, best_t);
    if (box_hit && cur.count > 0) {
      for (int k = 0; k < cur.count; ++k) {
        const int pid = min(cur.first + k, n_tris - 1);
        float p[9], tt, b0, b1;
        tri16(tris + 16 * (size_t)pid, p);
        if (tri_test_v(p, r, best_t, tt, b0, b1)) {
          best_prim = pid;
          best_b0 = b0;
          best_b1 = b1;
          best_t = tt;
        }
      }
    }
    node = box_hit && cur.count == 0 ? node + 1 : cur.skip;
    if (any_hit && best_prim >= 0) return;
    if (flag != nullptr && *(volatile const unsigned long long*)flag != NO_HIT) return;
  }
}

// Phase 1 of a whole-tree sweep, one thread per lane: every lane's merge
// key to NO_HIT and every group's finished-task count to 0; a dead
// lane (t_max <= RAY_EPS) gets its result now (t = -1e30, -1, and b0 = b1
// = 0 where asked); a live lane is listed and counted.  The list keeps
// lane order within each PREP_THREADS-lane block; the blocks follow in the
// order their atomics land.  header: [0] live rays, [1] next task, [2] S,
// [3] rays per task.
__global__ void __launch_bounds__(PREP_THREADS)
whole_prep_kernel(const float* __restrict__ tmax, float* __restrict__ t_out,
                  int* __restrict__ prim_out, float* __restrict__ b0_out,
                  float* __restrict__ b1_out, unsigned long long* __restrict__ keys,
                  int* __restrict__ list, int* __restrict__ done, int* __restrict__ header,
                  int n) {
  __shared__ int base[PREP_THREADS / 32 + 1];
  const int i = blockIdx.x * PREP_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool live = i < n && tmax[i] > RAY_EPS;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (i < n) {
    keys[i] = NO_HIT;
    done[i] = 0;
    if (!live) {
      t_out[i] = INERT_T;
      prim_out[i] = -1;
      if (b0_out != nullptr) {
        b0_out[i] = 0.0f;
        b1_out[i] = 0.0f;
      }
    }
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

// The shape of a whole-tree sweep's tasks for `live` rays on `warps`
// resident warps: (rays per task, segments per ray).  A task takes up to
// 32 rays, fewer on a sparse sweep, so that there are SEG_PER_WARP tasks
// per warp (lanes of a warp then idle: a walk is latency-bound, and a warp
// is as slow as its slowest ray); only when there are fewer live rays than
// resident warps is a ray's walk cut into segments, about one task per
// warp, since segments cost work of their own (K6: the skip hops across
// each range; K4: the descent to each subtree and the pruning lost).
__device__ __forceinline__ int2 task_shape(int live, int warps) {
  const int rays = min(32, max(1, live / max(SEG_PER_WARP * warps, 1)));
  return make_int2(rays, live >= warps ? 1 : warps / max(live, 1));
}

// A task of the persistent grid for this warp: (position of its group of
// rays in the list, segment), or false when none is left.
__device__ __forceinline__ bool next_task(int* header, int seg_n, int n_tasks, int& pos,
                                          int& seg) {
  int task = 0;
  if ((threadIdx.x & 31) == 0) task = atomicAdd(header + 1, 1);
  task = __shfl_sync(0xffffffffu, task, 0);
  if (task >= n_tasks) return false;
  pos = task / seg_n;
  seg = task - pos * seg_n;
  return true;
}

// After a split task: fold its hit into the ray's key and count the task
// done; true (for the whole warp) when it finished the group's last task,
// whose lanes then read their rays' keys and write the results.
__device__ __forceinline__ bool last_task(unsigned long long* keys, int* done, int pos, int p,
                                          bool hit, unsigned long long key, int seg_n) {
  if (hit) atomicMin(keys + p, key);
  __threadfence();
  __syncwarp();
  int finished = 0;
  if ((threadIdx.x & 31) == 0) finished = atomicAdd(done + pos, 1);
  finished = __shfl_sync(0xffffffffu, finished, 0);
  if (finished != seg_n - 1) return false;
  __threadfence();
  return true;
}

// Phase 2 of K6: the persistent walk over listed rays in tasks of
// task_shape's rays and S node ranges per ray (S at most M /
// SKIP_MIN_RANGE).  At most 64 registers, so that 8 CTAs fit on an SM.
__global__ void __launch_bounds__(THREADS, 8)
skip_walk_kernel(const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
                 const float* __restrict__ tris, const float* __restrict__ ox,
                 const float* __restrict__ oy, const float* __restrict__ oz,
                 const float* __restrict__ dx, const float* __restrict__ dy,
                 const float* __restrict__ dz, const float* __restrict__ tmax,
                 float* __restrict__ t_out, int* __restrict__ prim_out,
                 float* __restrict__ b0_out, float* __restrict__ b1_out,
                 unsigned long long* keys, const int* __restrict__ list,
                 int* __restrict__ done, int* __restrict__ header, int n_nodes, int n_tris,
                 int any_hit) {
  const int lane = threadIdx.x & 31;
  const int live = header[0];
  const int2 shape = task_shape(live, gridDim.x * WARPS);
  const int rays = shape.x;
  const int seg_n = max(1, min(n_nodes / SKIP_MIN_RANGE, shape.y));
  const int n_groups = (live + rays - 1) / rays;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    header[2] = seg_n;
    header[3] = rays;
  }
  int pos, seg;
  if (seg_n == 1) {  // the sequential walk of each ray, written straight out
    while (next_task(header, 1, n_groups, pos, seg)) {
      const int p = pos * rays + lane;
      if (lane >= rays || p >= live) continue;
      const int i = list[p];
      float best_t = tmax[i], best_b0 = 0.0f, best_b1 = 0.0f;
      int best_prim = -1;
      const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
      skip_range(nodes_f, nodes_i, tris, 0, n_nodes, n_tris, r, best_t, best_prim, best_b0,
                 best_b1, any_hit != 0, nullptr);
      t_out[i] = best_t;
      prim_out[i] = best_prim;
      b0_out[i] = best_b0;
      b1_out[i] = best_b1;
    }
    return;
  }
  // one ray per task (rays == 1), its ranges merged by key
  while (next_task(header, seg_n, n_groups * seg_n, pos, seg)) {
    const int p = pos * rays + lane;
    const int i = lane < rays && p < live ? list[p] : -1;
    float t0 = 0.0f, best_t = 0.0f, best_b0 = 0.0f, best_b1 = 0.0f;
    int best_prim = -1;
    if (i >= 0) {
      t0 = tmax[i];
      best_t = t0;
      const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
      skip_range(nodes_f, nodes_i, tris, (int)((long long)seg * n_nodes / seg_n),
                 (int)((long long)(seg + 1) * n_nodes / seg_n), n_tris, r, best_t, best_prim,
                 best_b0, best_b1, any_hit != 0, any_hit ? keys + p : nullptr);
    }
    const unsigned long long mine =
        ((unsigned long long)__float_as_uint(best_t) << 32) | (unsigned)best_prim;
    if (last_task(keys, done, pos, p, best_prim >= 0, mine, seg_n) && i >= 0) {
      const unsigned long long key = atomicAdd(keys + p, 0ull);
      if (key == NO_HIT) {
        t_out[i] = t0;
        prim_out[i] = -1;
        b0_out[i] = 0.0f;
        b1_out[i] = 0.0f;
      } else {
        // the winner's barycentrics, by the operations that found it
        const int pid = (int)(unsigned)key;
        const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
        float q[9], tt, b0, b1;
        tri16(tris + 16 * (size_t)pid, q);
        tri_test_v(q, r, t0, tt, b0, b1);
        t_out[i] = __uint_as_float((unsigned)(key >> 32));
        prim_out[i] = pid;
        b0_out[i] = b0;
        b1_out[i] = b1;
      }
    }
  }
}

// Phase 2 of the whole-tree K4: the persistent walk over listed rays in
// tasks of task_shape's rays and S = 2^L subtrees per ray (2^L the largest
// power of two not above task_shape's S, L at most SPLIT_LOG2_MAX and the
// tree's depth; L = 0 for a tree deeper than CAP, whose stack clamps).  At
// most 64 registers, 8 CTAs per SM.
template <int CAP>
__global__ void __launch_bounds__(THREADS, 8)
ordered_walk2_kernel(const float* __restrict__ nodes, const float* __restrict__ tris,
                     const int* __restrict__ root, const float* __restrict__ ox,
                     const float* __restrict__ oy, const float* __restrict__ oz,
                     const float* __restrict__ dx, const float* __restrict__ dy,
                     const float* __restrict__ dz, const float* __restrict__ tmax,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     unsigned long long* keys, const int* __restrict__ list,
                     int* __restrict__ done, int* __restrict__ header, int depth, int any_hit) {
  extern __shared__ int stacks[];
  const int lane = threadIdx.x & 31;
  const int live = header[0];
  const int2 shape = task_shape(live, gridDim.x * WARPS);
  const int rays = shape.x;
  const int lg =
      depth > CAP ? 0 : min(31 - __clz(shape.y), min(SPLIT_LOG2_MAX, depth));
  const int seg_n = 1 << lg;
  const int n_groups = (live + rays - 1) / rays;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    header[2] = seg_n;
    header[3] = rays;
  }
  int pos, j;
  if (seg_n == 1) {  // the sequential walk of each ray, written straight out
    const Tables<CAP> tab{nodes, tris, stacks + threadIdx.x};
    while (next_task(header, 1, n_groups, pos, j)) {
      const int p = pos * rays + lane;
      if (lane >= rays || p >= live) continue;
      const int i = list[p];
      float best_t = tmax[i];
      int best = -1;
      const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
      walk2(tab, root[0], r, best_t, best, 0, any_hit != 0);
      t_out[i] = best_t;
      prim_out[i] = best;
    }
    return;
  }
  // one ray per task (rays == 1), its subtrees merged by key
  while (next_task(header, seg_n, n_groups * seg_n, pos, j)) {
    const int p = pos * rays + lane;
    const int i = lane < rays && p < live ? list[p] : -1;
    float t0 = 0.0f, best_t = 0.0f;
    int best = -1;
    if (i >= 0) {
      t0 = tmax[i];
      best_t = t0;
      const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
      const SplitTables<CAP> tab{{nodes, tris, stacks + threadIdx.x},
                                 any_hit ? keys + p : nullptr};
      int start = root[0];
      if (subtree_root(tab, start, r, t0, j, lg))
        walk2(tab, start, r, best_t, best, 0, any_hit != 0);
    }
    const unsigned low = ((unsigned)j << SLOT_BITS) | (unsigned)best;
    const unsigned long long mine =
        any_hit ? low : ((unsigned long long)__float_as_uint(best_t) << 32) | low;
    if (last_task(keys, done, pos, p, best >= 0, mine, seg_n) && i >= 0) {
      const unsigned long long key = atomicAdd(keys + p, 0ull);
      const bool hit = key != NO_HIT;
      t_out[i] = !hit ? t0 : (any_hit ? INERT_T : __uint_as_float((unsigned)(key >> 32)));
      prim_out[i] = hit ? (int)((unsigned)key & ((1u << SLOT_BITS) - 1u)) : -1;
    }
  }
}

// One thread per ray; the CTA's THREADS rays lie in one 1024-ray stream
// block and walk its candidate list, each on its own, carrying (t, slot)
// from cluster to cluster.  No thread waits for another.  At most 8 CTAs
// of 128 threads per SM: 64 registers, and no spills there.
template <bool FUSED, int CAP>
__global__ void __launch_bounds__(THREADS, 8)
stream_walk2_kernel(const float* __restrict__ nodes, const float* __restrict__ tris,
                    const int* __restrict__ roots, const int* __restrict__ clist,
                    const int* __restrict__ cnt, const float* __restrict__ ox,
                    const float* __restrict__ oy, const float* __restrict__ oz,
                    const float* __restrict__ dx, const float* __restrict__ dy,
                    const float* __restrict__ dz, const float* __restrict__ tmax,
                    float* __restrict__ t_out, int* __restrict__ prim_out, int n_cand,
                    int nodes_pad, int leaves_pad, int any_hit) {
  extern __shared__ int stacks[];
  const int i = blockIdx.x * THREADS + threadIdx.x;  // the launch covers n exactly
  // t starts at the ray's own t_max; dead lanes keep it and skip the walk
  // (no triangle satisfies RAY_EPS < t < t_max <= RAY_EPS)
  float best_t = tmax[i];
  int best_prim = -1;
  if (best_t > RAY_EPS) {
    const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
    const int b = i / STREAM_BLOCK;
    const int nc = cnt[b];
    const int* cl = clist + (size_t)b * n_cand;
    const int slots = leaves_pad * 8;
    for (int k = 0; k < nc; ++k) {
      const int cid = cl[k];
      const Tables<CAP> tab{nodes + (size_t)cid * nodes_pad * NODE2_COLS,
                            tris + (size_t)cid * leaves_pad * ROW_COLS, stacks + threadIdx.x};
      const bool found =
          FUSED ? walk2_fused(tab, roots[cid], r, best_t, best_prim, cid * slots, any_hit != 0)
                : walk2(tab, roots[cid], r, best_t, best_prim, cid * slots, any_hit != 0);
      if (found) break;
    }
  }
  t_out[i] = best_t;
  prim_out[i] = best_prim;
}

// The persistent grid of `kernel` on the current device: the SM count
// times the CTAs of THREADS threads and `smem` bytes that fit on one.
// `cache` (one entry per device, 0 = not yet known) spares the queries on
// later launches.
template <class K>
cudaError_t persistent_grid(K kernel, int smem, int (&cache)[MAX_DEVICES], int& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[dev] > 0) {
    grid = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  if (smem > 0)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) cache[dev] = grid = sms * per_sm;
  return err;
}

// The scratch of a whole-tree sweep of n rays: n merge keys, then the
// list of n lanes, n finished-task counts (one per group of rays; a group
// may hold one ray) and the 4-int header.
struct Scratch {
  unsigned long long* keys;
  int *list, *done, *header;
  Scratch(long long* s, int n)
      : keys(reinterpret_cast<unsigned long long*>(s)),
        list(reinterpret_cast<int*>(s + n)),
        done(list + n),
        header(done + n) {}
};

cudaError_t whole_prep(const float* tmax, float* t_out, int* prim_out, float* b0_out,
                       float* b1_out, const Scratch& s, int n, cudaStream_t stream) {
  const cudaError_t err = cudaMemsetAsync(s.header, 0, 4 * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  whole_prep_kernel<<<(n + PREP_THREADS - 1) / PREP_THREADS, PREP_THREADS, 0, stream>>>(
      tmax, t_out, prim_out, b0_out, b1_out, s.keys, s.list, s.done, s.header, n);
  return cudaGetLastError();
}

template <int CAP>
int ordered_walk2(const float* nodes, const float* tris, const int* root, const float* ox,
                  const float* oy, const float* oz, const float* dx, const float* dy,
                  const float* dz, const float* tmax, float* t_out, int* prim_out,
                  long long* scratch, int n, int depth, int any_hit, cudaStream_t stream) {
  const int smem = CAP * THREADS * 4;  // the i32 stacks
  const Scratch s(scratch, n);
  static int cache[MAX_DEVICES];
  int grid = 0;
  cudaError_t err = persistent_grid(ordered_walk2_kernel<CAP>, smem, cache, grid);
  if (err == cudaSuccess) err = whole_prep(tmax, t_out, prim_out, nullptr, nullptr, s, n, stream);
  if (err != cudaSuccess) return (int)err;
  ordered_walk2_kernel<CAP><<<grid, THREADS, smem, stream>>>(
      nodes, tris, root, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, s.keys, s.list, s.done,
      s.header, depth, any_hit);
  return (int)cudaGetLastError();
}

template <bool FUSED, int CAP>
int stream_walk2(const float* nodes, const float* tris, const int* roots, const int* clist,
                 const int* cnt, const float* ox, const float* oy, const float* oz,
                 const float* dx, const float* dy, const float* dz, const float* tmax,
                 float* t_out, int* prim_out, int n, int n_cand, int nodes_pad,
                 int leaves_pad, int any_hit, cudaStream_t stream) {
  const int smem = CAP * THREADS * 4;  // the i32 stacks
  const cudaError_t err = cudaFuncSetAttribute(
      stream_walk2_kernel<FUSED, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  stream_walk2_kernel<FUSED, CAP><<<n / THREADS, THREADS, smem, stream>>>(
      nodes, tris, roots, clist, cnt, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, n_cand,
      nodes_pad, leaves_pad, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace

// the template of `cap` stack entries, F(CAP) a launch
#define WITH_CAP(cap, F)                        \
  switch (cap) {                                \
    case 16: return F(16);                      \
    case 32: return F(32);                      \
    case 64: return F(64);                      \
    case STACK_DEPTH: return F(STACK_DEPTH);    \
    default: return (int)cudaErrorInvalidValue; \
  }

// stack_cap: 16, 32, 64 or 96 entries per thread (the smallest of at
// least the tree's depth; 96 clamps as the reference does); depth the
// tree's; slots of the tree < 2^SLOT_BITS; scratch: n + n + 2 int64
// words.
extern "C" int launch_ordered_walk2(const float* nodes, const float* tris,
                                    const int* root, const float* ox, const float* oy,
                                    const float* oz, const float* dx, const float* dy,
                                    const float* dz, const float* tmax, float* t_out,
                                    int* prim_out, long long* scratch, int n, int depth,
                                    int any_hit, int stack_cap, void* stream) {
  if (n == 0) return 0;
#define ORDERED_WALK2(C)                                                                      \
  ordered_walk2<C>(nodes, tris, root, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, scratch, \
                   n, depth, any_hit, (cudaStream_t)stream)
  WITH_CAP(stack_cap, ORDERED_WALK2)
#undef ORDERED_WALK2
}

// stack_cap as launch_ordered_walk2's, for the deepest cluster tree; n a
// multiple of STREAM_BLOCK.
extern "C" int launch_stream_walk2(const float* nodes, const float* tris,
                                   const int* roots, const int* clist, const int* cnt,
                                   const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz,
                                   const float* tmax, float* t_out, int* prim_out,
                                   int n, int n_cand, int nodes_pad, int leaves_pad,
                                   int any_hit, int fused, int stack_cap, void* stream) {
  if (n % STREAM_BLOCK || nodes_pad < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
#define STREAM_WALK2(C)                                                                      \
  (fused ? stream_walk2<true, C>(nodes, tris, roots, clist, cnt, ox, oy, oz, dx, dy, dz,     \
                                 tmax, t_out, prim_out, n, n_cand, nodes_pad, leaves_pad,    \
                                 any_hit, (cudaStream_t)stream)                              \
         : stream_walk2<false, C>(nodes, tris, roots, clist, cnt, ox, oy, oz, dx, dy, dz,    \
                                  tmax, t_out, prim_out, n, n_cand, nodes_pad, leaves_pad,   \
                                  any_hit, (cudaStream_t)stream))
  WITH_CAP(stack_cap, STREAM_WALK2)
#undef STREAM_WALK2
}

// scratch as launch_ordered_walk2's.
extern "C" int launch_skip_walk(const float* nodes_f, const int* nodes_i,
                                const float* tris, const float* ox, const float* oy,
                                const float* oz, const float* dx, const float* dy,
                                const float* dz, const float* tmax, float* t_out,
                                int* prim_out, float* b0_out, float* b1_out,
                                long long* scratch, int n, int n_nodes, int n_tris,
                                int any_hit, void* stream) {
  if (n == 0) return 0;
  const Scratch s(scratch, n);
  static int cache[MAX_DEVICES];
  int grid = 0;
  cudaError_t err = persistent_grid(skip_walk_kernel, 0, cache, grid);
  if (err == cudaSuccess)
    err = whole_prep(tmax, t_out, prim_out, b0_out, b1_out, s, n, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  skip_walk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      nodes_f, nodes_i, tris, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, b0_out, b1_out,
      s.keys, s.list, s.done, s.header, n_nodes, n_tris, any_hit);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
