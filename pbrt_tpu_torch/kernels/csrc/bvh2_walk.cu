// Binary BVH walks for Hopper (sm_90a): one thread per ray.
//
// Replaces three Pallas TPU kernels (pbrt_tpu/ops/):
//   ordered_walk2_kernel       <- pallas_bvh.py::_ordered_kernel (K4)
//       ordered near-first stack walk over one whole binary tree.
//   stream_walk2_kernel<false> <- stream_bvh.py::_stream_kernel with
//       _walk_tree (K4): the same walk over each candidate cluster of the
//       ray's 1024-ray block, carrying (t, slot) across clusters.
//   stream_walk2_kernel<true>  <- the same with _walk_tree_fused (K4b):
//       leaf children are tested at their parent, left first.
//   skip_walk_kernel           <- pallas_bvh.py::_traverse_kernel (K6)
//       the skip-link walk over 4-triangle leaves that also returns the
//       barycentrics of the hit.
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
// a 512-byte leaf row, or a 32+16-byte skip node), so the walks are
// latency-bound on those fetches and lose throughput to divergence
// between the rays of a warp; the integrator hands them direction-sorted
// rays, which keeps warps coherent.  The streaming walk reads its
// triangles as three 16-byte loads through the read-only cache, and keeps
// its stack (16, 32, 64 or 96 entries, a template picked from the deepest
// cluster tree the host packed) in shared memory, not local memory; its
// threads never wait for each other inside the candidate loop, so a
// cluster tree of any size is walked.  (No CTA barrier in that loop:
// one per cluster, to stage the cluster's rows in shared memory, cost
// ~30% on the H100, since it makes the CTA's warps walk each cluster in
// lockstep.)  The whole-tree walk reads scalars and keeps its 96-entry
// stack in local memory.
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

#define STACK_DEPTH 96
#define LEAF_COUNT_BITS 6
#define NODE2_COLS 16
#define ROW_COLS 128
#define STREAM_BLOCK 1024
#define RAY_EPS 1e-4f
#define INERT_T (-1e30f)
#define THREADS 128

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

// The same on a box in global memory, read through the read-only cache.
__device__ __forceinline__ bool slab(const float* __restrict__ b, const Ray& r,
                                     float best_t) {
  float v[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) v[c] = __ldg(b + c);
  return slab_v(v, r, best_t);
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

// The same on the triangle at t in global memory, read as 9 scalars.
__device__ __forceinline__ bool tri_test(const float* __restrict__ t, const Ray& r,
                                         float best_t, float& tt, float& b0, float& b1) {
  float p[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) p[c] = __ldg(t + c);
  return tri_test_v(p, r, best_t, tt, b0, b1);
}

// One ordered node row: both children's boxes, their refs, the mask.
struct NodeRow {
  float box[12];
  int left, right, mask;
};

// Where a walk finds its rows and keeps its stack.  GlobalTables: node and
// leaf rows through the read-only cache as scalar loads, the stack in
// local memory (the whole-tree walk).  StreamTables<CAP>: the same node
// rows as scalar loads (16-byte loads of them made K4 1.5x slower on an
// H100: scripts/walk_variants.py), triangles as three 16-byte loads
// (slots are 64-byte aligned), and a CAP-entry stack per thread in
// shared memory.
struct GlobalTables {
  static constexpr int CAP = STACK_DEPTH;
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
  __device__ __forceinline__ void tri(const float* t, float (&p)[9]) const {
#pragma unroll
    for (int c = 0; c < 9; ++c) p[c] = __ldg(t + c);
  }
  __device__ __forceinline__ int& slot(int i) const { return stack[i]; }
};

template <int CAP_>
struct StreamTables : GlobalTables {
  static constexpr int CAP = CAP_;
  __device__ __forceinline__ void tri(const float* t, float (&p)[9]) const {
    const float4* t4 = reinterpret_cast<const float4*>(t);
    const float4 a = __ldg(t4), b = __ldg(t4 + 1), c = __ldg(t4 + 2);
    p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
    p[4] = b.x; p[5] = b.y; p[6] = b.z; p[7] = b.w;
    p[8] = c.x;
  }
  // entry e of this thread at stack[e * THREADS]
  __device__ __forceinline__ int& slot(int i) const { return stack[i * THREADS]; }
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
// the thread is done).
template <class Tab>
__device__ __forceinline__ bool walk2(const Tab& tab, int root, const Ray& r, float& best_t,
                                      int& best_prim, int prim_base, bool any_hit) {
  int ref = root;
  int sp = 0;
  while (true) {
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

__global__ void __launch_bounds__(THREADS)
ordered_walk2_kernel(const float* __restrict__ nodes, const float* __restrict__ tris,
                     const int* __restrict__ root, const float* __restrict__ ox,
                     const float* __restrict__ oy, const float* __restrict__ oz,
                     const float* __restrict__ dx, const float* __restrict__ dy,
                     const float* __restrict__ dz, const float* __restrict__ tmax,
                     float* __restrict__ t_out, int* __restrict__ prim_out, int n,
                     int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // whole-tree convention: spent lanes go inert at -1e30
  const float t0 = tmax[i];
  float best_t = t0 <= RAY_EPS ? INERT_T : t0;
  int best_prim = -1;
  if (t0 > RAY_EPS) {
    int stack[STACK_DEPTH];
    const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
    const GlobalTables tab{nodes, tris, stack};
    walk2(tab, root[0], r, best_t, best_prim, 0, any_hit != 0);
  }
  t_out[i] = best_t;
  prim_out[i] = best_prim;
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
      const StreamTables<CAP> tab{{nodes + (size_t)cid * nodes_pad * NODE2_COLS,
                                   tris + (size_t)cid * leaves_pad * ROW_COLS,
                                   stacks + threadIdx.x}};
      const bool found =
          FUSED ? walk2_fused(tab, roots[cid], r, best_t, best_prim, cid * slots, any_hit != 0)
                : walk2(tab, roots[cid], r, best_t, best_prim, cid * slots, any_hit != 0);
      if (found) break;
    }
  }
  t_out[i] = best_t;
  prim_out[i] = best_prim;
}

__global__ void __launch_bounds__(THREADS)
skip_walk_kernel(const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
                 const float* __restrict__ tris, const float* __restrict__ ox,
                 const float* __restrict__ oy, const float* __restrict__ oz,
                 const float* __restrict__ dx, const float* __restrict__ dy,
                 const float* __restrict__ dz, const float* __restrict__ tmax,
                 float* __restrict__ t_out, int* __restrict__ prim_out,
                 float* __restrict__ b0_out, float* __restrict__ b1_out, int n,
                 int n_nodes, int n_tris, int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float t0 = tmax[i];
  float best_t = t0 <= RAY_EPS ? INERT_T : t0;
  int best_prim = -1;
  float best_b0 = 0.0f, best_b1 = 0.0f;
  if (t0 > RAY_EPS) {
    const Ray r = make_ray(ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
    int node = 0;
    while (node < n_nodes) {
      const int skip = __ldg(nodes_i + 4 * node + 0);
      const int first = __ldg(nodes_i + 4 * node + 1);
      const int count = __ldg(nodes_i + 4 * node + 2);
      const bool box_hit = slab(nodes_f + 8 * (size_t)node, r, best_t);
      if (box_hit && count > 0) {
        for (int k = 0; k < count; ++k) {
          const int pid = min(first + k, n_tris - 1);
          float tt, b0, b1;
          if (tri_test(tris + 16 * (size_t)pid, r, best_t, tt, b0, b1)) {
            best_prim = pid;
            best_b0 = b0;
            best_b1 = b1;
            best_t = tt;
          }
        }
      }
      node = box_hit && count == 0 ? node + 1 : skip;
      if (any_hit && best_prim >= 0) break;
    }
  }
  t_out[i] = best_t;
  prim_out[i] = best_prim;
  b0_out[i] = best_b0;
  b1_out[i] = best_b1;
}

int grid_for(int n) { return (n + THREADS - 1) / THREADS; }

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

template <bool FUSED>
int stream_walk2_cap(int cap, const float* nodes, const float* tris, const int* roots,
                     const int* clist, const int* cnt, const float* ox, const float* oy,
                     const float* oz, const float* dx, const float* dy, const float* dz,
                     const float* tmax, float* t_out, int* prim_out, int n, int n_cand,
                     int nodes_pad, int leaves_pad, int any_hit, cudaStream_t stream) {
#define STREAM_WALK2_ARGS                                                                  \
  nodes, tris, roots, clist, cnt, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, n, n_cand, \
      nodes_pad, leaves_pad, any_hit, stream
  switch (cap) {
    case 16: return stream_walk2<FUSED, 16>(STREAM_WALK2_ARGS);
    case 32: return stream_walk2<FUSED, 32>(STREAM_WALK2_ARGS);
    case 64: return stream_walk2<FUSED, 64>(STREAM_WALK2_ARGS);
    case STACK_DEPTH: return stream_walk2<FUSED, STACK_DEPTH>(STREAM_WALK2_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef STREAM_WALK2_ARGS
}

}  // namespace

extern "C" int launch_ordered_walk2(const float* nodes, const float* tris,
                                    const int* root, const float* ox, const float* oy,
                                    const float* oz, const float* dx, const float* dy,
                                    const float* dz, const float* tmax, float* t_out,
                                    int* prim_out, int n, int any_hit, void* stream) {
  ordered_walk2_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      nodes, tris, root, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, n, any_hit);
  return (int)cudaGetLastError();
}

// stack_cap: 16, 32, 64 or 96 entries per thread (the smallest at least
// the deepest cluster tree; 96 clamps as the reference does); n a
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
  return fused ? stream_walk2_cap<true>(stack_cap, nodes, tris, roots, clist, cnt, ox, oy, oz,
                                        dx, dy, dz, tmax, t_out, prim_out, n, n_cand,
                                        nodes_pad, leaves_pad, any_hit, (cudaStream_t)stream)
               : stream_walk2_cap<false>(stack_cap, nodes, tris, roots, clist, cnt, ox, oy,
                                         oz, dx, dy, dz, tmax, t_out, prim_out, n, n_cand,
                                         nodes_pad, leaves_pad, any_hit, (cudaStream_t)stream);
}

extern "C" int launch_skip_walk(const float* nodes_f, const int* nodes_i,
                                const float* tris, const float* ox, const float* oy,
                                const float* oz, const float* dx, const float* dy,
                                const float* dz, const float* tmax, float* t_out,
                                int* prim_out, float* b0_out, float* b1_out, int n,
                                int n_nodes, int n_tris, int any_hit, void* stream) {
  skip_walk_kernel<<<grid_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      nodes_f, nodes_i, tris, ox, oy, oz, dx, dy, dz, tmax, t_out, prim_out, b0_out,
      b1_out, n, n_nodes, n_tris, any_hit);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
