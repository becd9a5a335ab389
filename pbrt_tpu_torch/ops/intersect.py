"""Hit-record constants shared by the intersectors (from
``pbrt_tpu/ops/intersect.py``).

Hit record (SoA dict of [N] tensors): t, hit (bool), kind, prim, and
b0/b1 (None when the walk returns only (t, prim):
``compute_interaction`` re-derives barycentrics).  The intersectors are
``accel/bvh.py::BVHIntersector`` and ``ops/intersect_soa.py``'s
brute-force sweep.
"""

KIND_NONE = -1
KIND_TRI = 0
KIND_SPHERE = 1

RAY_EPS = 1e-4
