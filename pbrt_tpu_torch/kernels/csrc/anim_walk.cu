// The keyframed skip-link walk for Hopper (sm_90a): one thread walks one ray.
//
// K7, anim_walk_kernel <- pbrt_tpu/ops/animated_intersect.py:176 _bvh_walk,
// a jax.lax.while_loop (no Pallas kernel): motion blur's walk over the
// skip-link BVH of shutter-union boxes (each triangle's box is the union of
// its boxes at every keyframe, so any time-t position stays inside), whose
// leaves test up to 4 triangles blended per lane from their [K, 9] keyframe
// rows with the lane's hat weights w_k(t) = max(0, 1 - |t (K - 1) - k|).
//
// What it computes is the reference's walk, per ray: at an interior node
// whose box is hit (t_near <= t_far, t_far > RAY_EPS, t_near < best_t)
// descend to node + 1, else jump to the skip link; at a leaf whose box is
// hit, blend and test each triangle (ids clamped to T - 1) with
// Moller-Trumbore (|det| > 1e-12, a hit must beat best_t strictly).  A lane
// whose t_max <= RAY_EPS cannot hit anything (a hit needs RAY_EPS < t <
// t_max); it is answered at once with (t_max, -1, 0, 0), which is what the
// reference's walk returns for it.  In any-hit mode a ray stops after the
// step that found a hit.
//
// Rounding.  The reference's compiled CPU code fuses a product that feeds a
// sum into one fused multiply-add; so do the kernel and its plain version
// (kernels/anim_walk.py, in float64: core/geometry.fma).  Of the K hat
// weights at most two are non-zero (the keys either side of the lane's
// time) and only their rows are read: each blended value is w_a * c_a,
// then fmaf(w_b, c_b, .) where a second key counts, as the plain
// version's fused sum over every key gives it (a zero weight adds an
// exact zero).  Moller-Trumbore fuses a*b - c*d as fmaf(a, b, -(c*d)) and
// x . y as fmaf(x2, y2, fmaf(x0, y0, x1*y1)); every other operation
// rounds on its own (-fmad=false).  Kernel and plain version then differ
// only where float64's double rounding of a fused result differs from
// fmaf's single rounding.
//
// Two instances of one template on the scalar type T of the keyframe rows,
// the rays, the shutter times and the results: float (the default policy),
// and double (the double policy, where the reference blends the keyframe
// rows in float64, pbrt_tpu/ops/animated_intersect.py:57-58, casts the
// times to the rays' float and takes the hat weights there, :90-93, and
// tests the triangles in float64).  Both read the same float32 node boxes,
// as the reference's float32 BVH build gives them.  The double instance fuses with fma()
// where the float one fuses with fmaf(); its plain version has no wider
// type to fuse in (core/geometry.fma), so the two differ in the last bits
// of a double there.  The float instance is the one of before, bit for bit.
//
// Bound on this card: like K6, every step is a dependent fetch (a 32 + 16
// byte node, then per triangle two keyframe rows of 9 T), so the walk is
// latency-bound on those fetches; this first version keeps K6's 16-byte
// node loads and nothing else of its machinery (no prepass, no segments).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define LEAF_TRIS 4  // the shutter-union BVH is built with leaf_size=4

namespace {

__device__ __forceinline__ float fused(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fused(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__device__ __forceinline__ T safe_inv(T v) {
  const T sign = v < T(0) ? T(-1) : T(1);
  const T r = sign / fmax(fabs(v), T(1e-20));
  return fmin(fmax(r, T(-1e30)), T(1e30));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
anim_walk_kernel(const float* __restrict__ nodes_f, const int* __restrict__ nodes_i,
                 const T* __restrict__ keys, const T* __restrict__ ox,
                 const T* __restrict__ oy, const T* __restrict__ oz,
                 const T* __restrict__ dx, const T* __restrict__ dy,
                 const T* __restrict__ dz, const T* __restrict__ tmax,
                 const T* __restrict__ time, T* __restrict__ t_out,
                 int* __restrict__ prim_out, T* __restrict__ b0_out,
                 T* __restrict__ b1_out, int n, int n_nodes, int n_tris, int n_keys,
                 int any_hit) {
  const T ray_eps = T(1e-4);  // RAY_EPS, rounded to T as the reference's compares it
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T best_t = tmax[i];
  int best_prim = -1;
  T best_b0 = T(0), best_b1 = T(0);
  if (best_t > ray_eps) {
    const T rox = ox[i], roy = oy[i], roz = oz[i];
    const T rdx = dx[i], rdy = dy[i], rdz = dz[i];
    const T ix = safe_inv(rdx), iy = safe_inv(rdy), iz = safe_inv(rdz);
    // the hat weights (ops/animated_intersect.time_weights) and the keys
    // whose weight is non-zero, in key order
    const T x = fmin(fmax(time[i], T(0)), T(1)) * T(n_keys - 1);
    int kk[2] = {0, 0};
    T ww[2] = {T(0), T(0)};
    int nk = 0;
    for (int k = 0; k < n_keys && nk < 2; ++k) {
      const T w = fmax(T(0), T(1) - fabs(x - T(k)));
      if (w != T(0)) {
        kk[nk] = k;
        ww[nk] = w;
        ++nk;
      }
    }
    const int row = 9 * n_keys;
    int node = 0;
    while (node < n_nodes) {
      const float4* f = reinterpret_cast<const float4*>(nodes_f + 8 * (size_t)node);
      const float4 a = __ldg(f), b = __ldg(f + 1);
      const int4 c = __ldg(reinterpret_cast<const int4*>(nodes_i + 4 * (size_t)node));
      const T tlx = (T(a.x) - rox) * ix, thx = (T(a.w) - rox) * ix;
      const T tly = (T(a.y) - roy) * iy, thy = (T(b.x) - roy) * iy;
      const T tlz = (T(a.z) - roz) * iz, thz = (T(b.y) - roz) * iz;
      const T t_near = fmax(fmax(fmin(tlx, thx), fmin(tly, thy)), fmin(tlz, thz));
      const T t_far = fmin(fmin(fmax(tlx, thx), fmax(tly, thy)), fmax(tlz, thz));
      const bool box_hit = t_near <= t_far && t_far > ray_eps && t_near < best_t;
      const int count = c.z;
      if (box_hit && count > 0) {
        for (int k = 0; k < LEAF_TRIS && k < count; ++k) {
          const int pid = min(c.y + k, n_tris - 1);
          const T* kp = keys + (size_t)pid * row;
          T p[9];
          for (int j = 0; j < 9; ++j) p[j] = ww[0] * __ldg(kp + 9 * kk[0] + j);
          if (nk == 2)
            for (int j = 0; j < 9; ++j) p[j] = fused(ww[1], __ldg(kp + 9 * kk[1] + j), p[j]);
          const T e1x = p[3] - p[0], e1y = p[4] - p[1], e1z = p[5] - p[2];
          const T e2x = p[6] - p[0], e2y = p[7] - p[1], e2z = p[8] - p[2];
          const T pvx = fused(rdy, e2z, -(rdz * e2y));
          const T pvy = fused(rdz, e2x, -(rdx * e2z));
          const T pvz = fused(rdx, e2y, -(rdy * e2x));
          const T det = fused(e1z, pvz, fused(e1x, pvx, e1y * pvy));
          const bool det_ok = fabs(det) > T(1e-12);
          const T inv_det = det_ok ? T(1) / det : T(0);
          const T tvx = rox - p[0], tvy = roy - p[1], tvz = roz - p[2];
          const T b0 = fused(tvz, pvz, fused(tvx, pvx, tvy * pvy)) * inv_det;
          const T qvx = fused(tvy, e1z, -(tvz * e1y));
          const T qvy = fused(tvz, e1x, -(tvx * e1z));
          const T qvz = fused(tvx, e1y, -(tvy * e1x));
          const T b1 = fused(rdz, qvz, fused(rdx, qvx, rdy * qvy)) * inv_det;
          const T tt = fused(e2z, qvz, fused(e2x, qvx, e2y * qvy)) * inv_det;
          if (det_ok && b0 >= T(0) && b1 >= T(0) && b0 + b1 <= T(1) && tt > ray_eps &&
              tt < best_t) {
            best_prim = pid;
            best_b0 = b0;
            best_b1 = b1;
            best_t = tt;
          }
        }
      }
      node = box_hit && count == 0 ? node + 1 : c.x;
      if (any_hit && best_prim >= 0) break;
    }
  }
  t_out[i] = best_t;
  prim_out[i] = best_prim;
  b0_out[i] = best_b0;
  b1_out[i] = best_b1;
}

template <typename T>
int launch(const float* nodes_f, const int* nodes_i, const T* keys, const T* ox, const T* oy,
           const T* oz, const T* dx, const T* dy, const T* dz, const T* tmax,
           const T* time, T* t_out, int* prim_out, T* b0_out, T* b1_out, int n,
           int n_nodes, int n_tris, int n_keys, int any_hit, void* stream) {
  if (n_keys < 1 || n_tris < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  anim_walk_kernel<T><<<(n + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      nodes_f, nodes_i, keys, ox, oy, oz, dx, dy, dz, tmax, time, t_out, prim_out, b0_out,
      b1_out, n, n_nodes, n_tris, n_keys, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace

// nodes_f [n_nodes, 8] and nodes_i [n_nodes, 4] 16-byte aligned; keys
// [n_tris, n_keys, 9]; n_keys >= 1.  The float instance:
extern "C" int launch_anim_walk(const float* nodes_f, const int* nodes_i, const float* keys,
                                const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* tmax, const float* time, float* t_out,
                                int* prim_out, float* b0_out, float* b1_out, int n,
                                int n_nodes, int n_tris, int n_keys, int any_hit,
                                void* stream) {
  return launch<float>(nodes_f, nodes_i, keys, ox, oy, oz, dx, dy, dz, tmax, time, t_out,
                       prim_out, b0_out, b1_out, n, n_nodes, n_tris, n_keys, any_hit, stream);
}

// The double instance: keys, rays, times and results in double; nodes
// float, as above.
extern "C" int launch_anim_walk_f64(const float* nodes_f, const int* nodes_i,
                                    const double* keys, const double* ox, const double* oy,
                                    const double* oz, const double* dx, const double* dy,
                                    const double* dz, const double* tmax, const double* time,
                                    double* t_out, int* prim_out, double* b0_out,
                                    double* b1_out, int n, int n_nodes, int n_tris, int n_keys,
                                    int any_hit, void* stream) {
  return launch<double>(nodes_f, nodes_i, keys, ox, oy, oz, dx, dy, dz, tmax, time, t_out,
                        prim_out, b0_out, b1_out, n, n_nodes, n_tris, n_keys, any_hit, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
