"""PLY mesh reader for ``Shape "plymesh"`` (copy of
``pbrt_tpu/shapes/plyread.py``): ASCII and binary PLY in both byte
orders, polygons fanned to triangles (v0, vk, vk+1)."""

from __future__ import annotations

import logging

import numpy as np

from pbrt_tpu_torch.core.paramset import ParamSet

log = logging.getLogger("pbrt_tpu_torch")

_PLY_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


def read_ply(path: str, float_t=np.float32):
    """Returns (vertices [V,3], normals [V,3] | None, uv [V,2] | None,
    indices [F,3]), the vertex data in the policy's float ``float_t``."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end:]
    body = body[body.find(b"\n") + 1 :]

    fmt = None
    elements = []  # (name, count, [(prop_name, type, is_list, count_type)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append((parts[4], parts[3], True, parts[2]))
            else:
                elements[-1][2].append((parts[2], parts[1], False, None))

    verts = norms = uvs = None
    faces = []
    if fmt == "ascii":
        toks = body.split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                rows = []
                for _ in range(count):
                    row = {}
                    for pname, ptype, is_list, _ in props:
                        row[pname] = float(toks[pos]); pos += 1
                    rows.append(row)
                verts, norms, uvs = _vertex_arrays(rows, float_t)
            elif name == "face":
                for _ in range(count):
                    n = int(toks[pos]); pos += 1
                    idx = [int(toks[pos + i]) for i in range(n)]
                    pos += n
                    for k in range(1, n - 1):
                        faces.append((idx[0], idx[k], idx[k + 1]))
            else:
                for _ in range(count):
                    for pname, ptype, is_list, _ in props:
                        if is_list:
                            n = int(toks[pos]); pos += 1 + n
                        else:
                            pos += 1
    else:
        endian = "<" if "little" in fmt else ">"
        pos = 0
        for name, count, props in elements:
            if name == "vertex" and all(not p[2] for p in props):
                dt = np.dtype([(p[0], endian + _PLY_TYPES[p[1]][0]) for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=pos)
                pos += dt.itemsize * count
                rows = arr
                verts, norms, uvs = _vertex_arrays_np(arr, float_t)
            elif name == "face" and (fast := _uniform_faces(body, pos, count, props, endian)):
                fan, pos = fast
                faces.extend(fan)
            elif name == "face":
                for _ in range(count):
                    cname, ptype, is_list, ctype = props[0]
                    ct, csz = _PLY_TYPES[ctype]
                    it, isz = _PLY_TYPES[ptype]
                    n = int(np.frombuffer(body, dtype=endian + ct, count=1, offset=pos)[0])
                    pos += csz
                    idx = np.frombuffer(body, dtype=endian + it, count=n, offset=pos)
                    pos += isz * n
                    for k in range(1, n - 1):
                        faces.append((int(idx[0]), int(idx[k]), int(idx[k + 1])))
            else:
                for _ in range(count):
                    for pname, ptype, is_list, ctype in props:
                        if is_list:
                            ct, csz = _PLY_TYPES[ctype]
                            it, isz = _PLY_TYPES[ptype]
                            n = int(np.frombuffer(body, dtype=endian + ct, count=1, offset=pos)[0])
                            pos += csz + isz * n
                        else:
                            pos += _PLY_TYPES[ptype][1]
    return verts, norms, uvs, np.asarray(faces, dtype=np.int64)


def _uniform_faces(body, pos, count, props, endian):
    """Binary faces read at once where the face element is one list and
    every face has the first face's vertex count: (the fanned triangles,
    the offset after the element), else None."""
    if count == 0 or len(props) != 1 or not props[0][2]:
        return None
    _, ptype, _, ctype = props[0]
    ct, it = endian + _PLY_TYPES[ctype][0], endian + _PLY_TYPES[ptype][0]
    n = int(np.frombuffer(body, dtype=ct, count=1, offset=pos)[0])
    rec = np.dtype([("n", ct), ("idx", it, (n,))])
    if n < 3 or pos + rec.itemsize * count > len(body):
        return None
    arr = np.frombuffer(body, dtype=rec, count=count, offset=pos)
    if not (arr["n"] == n).all():
        return None
    idx = arr["idx"].astype(np.int64)
    fan = np.stack([np.stack([idx[:, 0], idx[:, k], idx[:, k + 1]], axis=-1)
                    for k in range(1, n - 1)], axis=1).reshape(-1, 3)
    return [tuple(f) for f in fan.tolist()], pos + rec.itemsize * count


def _vertex_arrays(rows, float_t):
    verts = np.array([[r["x"], r["y"], r["z"]] for r in rows], dtype=float_t)
    norms = uvs = None
    if rows and "nx" in rows[0]:
        norms = np.array([[r["nx"], r["ny"], r["nz"]] for r in rows], dtype=float_t)
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if rows and ukey in rows[0]:
            uvs = np.array([[r[ukey], r[vkey]] for r in rows], dtype=float_t)
            break
    return verts, norms, uvs


def _vertex_arrays_np(arr, float_t):
    names = arr.dtype.names
    verts = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(float_t)
    norms = uvs = None
    if "nx" in names:
        norms = np.stack([arr["nx"], arr["ny"], arr["nz"]], axis=-1).astype(float_t)
    for ukey, vkey in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if ukey in names:
            uvs = np.stack([arr[ukey], arr[vkey]], axis=-1).astype(float_t)
            break
    return verts, norms, uvs


def mesh_from_ply(params: ParamSet, o2w, reverse):
    from pbrt_tpu_torch.shapes import _mesh_from_params

    filename = params.find_one_filename("filename", "")
    if not filename:
        log.error("plymesh missing 'filename'")
        return None
    try:
        verts, norms, uvs, faces = read_ply(filename, params.float_t)
    except (OSError, ValueError) as e:
        log.error("Unable to read PLY '%s': %s", filename, e)
        return None
    ps = ParamSet(params.float_t)
    ps.add_int("indices", faces.reshape(-1).tolist())
    ps.add_point3f("P", verts)
    if norms is not None:
        ps.add_normal3f("N", norms)
    if uvs is not None:
        ps.add_point2f("uv", uvs)
    return _mesh_from_params(ps, o2w, reverse)
