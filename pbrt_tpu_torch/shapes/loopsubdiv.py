"""Loop subdivision surfaces (pbrt-v3 §3.8.2), host-side refinement (copy
of ``pbrt_tpu/shapes/loopsubdiv.py``).

Subdivides ``nlevels`` times with the Loop masks (valence-dependent beta for
even vertices, 3/8-3/8-1/8-1/8 for odd), then emits triangles with limit
normals approximated by the subdivided mesh's vertex normals.
"""

from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from pbrt_tpu_torch.core.paramset import ParamSet

log = logging.getLogger("pbrt_tpu_torch")


def _subdivide_once(verts: np.ndarray, faces: np.ndarray):
    nv = len(verts)
    edge_map = {}
    edges_of_vertex = defaultdict(set)
    faces_of_edge = defaultdict(list)
    for fi, (a, b, c) in enumerate(faces):
        for u, v in ((a, b), (b, c), (c, a)):
            e = (min(u, v), max(u, v))
            faces_of_edge[e].append(fi)
            edges_of_vertex[u].add(e)
            edges_of_vertex[v].add(e)

    # odd (edge) vertices
    new_verts = []
    for e, fs in faces_of_edge.items():
        u, v = e
        if len(fs) == 2:
            # opposite vertices
            opp = []
            for fi in fs:
                tri = faces[fi]
                opp.extend([int(x) for x in tri if x not in e])
            p = 0.375 * (verts[u] + verts[v]) + 0.125 * (verts[opp[0]] + verts[opp[1]])
        else:
            p = 0.5 * (verts[u] + verts[v])
        edge_map[e] = nv + len(new_verts)
        new_verts.append(p)

    # even (original) vertices
    even = np.empty_like(verts)
    for vi in range(nv):
        neighbors = set()
        boundary_edges = []
        for e in edges_of_vertex[vi]:
            other = e[0] if e[1] == vi else e[1]
            neighbors.add(other)
            if len(faces_of_edge[e]) == 1:
                boundary_edges.append(other)
        k = len(neighbors)
        if boundary_edges:
            if len(boundary_edges) == 2:
                even[vi] = 0.75 * verts[vi] + 0.125 * (
                    verts[boundary_edges[0]] + verts[boundary_edges[1]]
                )
            else:
                even[vi] = verts[vi]
        elif k > 0:
            if k == 3:
                beta = 3.0 / 16.0
            else:
                beta = 3.0 / (8.0 * k)
            even[vi] = (1 - k * beta) * verts[vi] + beta * sum(
                verts[n] for n in neighbors
            )
        else:
            even[vi] = verts[vi]

    all_verts = np.concatenate([even, np.asarray(new_verts)], axis=0)
    new_faces = []
    for a, b, c in faces:
        ab = edge_map[(min(a, b), max(a, b))]
        bc = edge_map[(min(b, c), max(b, c))]
        ca = edge_map[(min(c, a), max(c, a))]
        new_faces.extend([(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)])
    return all_verts, np.asarray(new_faces, dtype=np.int64)


def loop_subdivide(params: ParamSet, o2w, reverse):
    from pbrt_tpu_torch.shapes import _mesh_from_params

    nlevels = params.find_one_int("nlevels", 3)
    indices = params.find_int("indices")
    pts = params.find_point3f("P")
    if indices is None or pts is None:
        log.error("loopsubdiv missing 'indices' or 'P'")
        return None
    verts = np.asarray(pts, dtype=np.float64)
    faces = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    for _ in range(max(0, min(nlevels, 6))):
        verts, faces = _subdivide_once(verts, faces)

    # vertex normals by area-weighted face normals
    n = np.zeros_like(verts)
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]], verts[faces[:, 2]] - verts[faces[:, 0]]
    )
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(norm == 0, 1.0, norm)

    ps = ParamSet(params.float_t)
    ps.add_int("indices", faces.reshape(-1).tolist())
    ps.add_point3f("P", verts.astype(params.float_t))
    ps.add_normal3f("N", n.astype(params.float_t))
    return _mesh_from_params(ps, o2w, reverse)
