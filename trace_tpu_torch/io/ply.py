"""Minimal PLY mesh loader, ascii and binary little/big endian (port of
trace_tpu/io/ply.py; numpy only).

Covers the vertex x/y/z[/nx/ny/nz][/u/v or s/t] layouts and the count +
index face lists of PBRT-style assets (the reference's caustic-glass
mesh); polygons are fan-triangulated.
"""
from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str):
    """Parse a PLY file -> dict with 'vertices' [V,3] f32, optional
    'normals' [V,3] f32, optional 'uv' [V,2] f32, 'indices' [F,3] int32
    (polygons are fan-triangulated)."""
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.index(b"end_header")
    header_end = data.index(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", "replace")
    body = data[header_end:]

    fmt = None
    elements = []  # list of (name, count, [(prop_name, dtype, is_list, count_dtype)])
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], _PLY_TYPES[parts[3]], True, _PLY_TYPES[parts[2]])
                )
            else:
                elements[-1][2].append((parts[2], _PLY_TYPES[parts[1]], False, None))

    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    out = {}

    if fmt == "ascii":
        tokens = body.decode("ascii").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = {p[0]: [] for p in props}
                for _ in range(count):
                    for pname, _, is_list, _ in props:
                        assert not is_list
                        cols[pname].append(float(tokens[pos])); pos += 1
                out["vertex"] = {k: np.asarray(v, np.float32) for k, v in cols.items()}
            elif name == "face":
                faces = []
                for _ in range(count):
                    k = int(tokens[pos]); pos += 1
                    faces.append([int(tokens[pos + i]) for i in range(k)])
                    pos += k
                out["faces"] = faces
            else:
                for _ in range(count):
                    for pname, _, is_list, _ in props:
                        if is_list:
                            k = int(tokens[pos]); pos += 1 + k
                        else:
                            pos += 1
    else:
        assert endian, f"unknown ply format {fmt}"
        offset = 0
        for name, count, props in elements:
            if all(not p[2] for p in props):
                dt = np.dtype([(p[0], endian + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count=count, offset=offset)
                offset += dt.itemsize * count
                if name == "vertex":
                    out["vertex"] = {p[0]: arr[p[0]].astype(np.float32) for p in props}
            else:
                # Fixed-arity fast path: probe the first face's count.
                pname, idx_t, _, cnt_t = props[0]
                assert len(props) == 1 and name == "face"
                cnt_dt = np.dtype(endian + cnt_t)
                idx_dt = np.dtype(endian + idx_t)
                k0 = int(np.frombuffer(body, cnt_dt, count=1, offset=offset)[0])
                rec = np.dtype([("n", endian + cnt_t), ("v", endian + idx_t, (k0,))])
                try:
                    arr = np.frombuffer(body, rec, count=count, offset=offset)
                except ValueError:  # ragged with shrinking tail: short buffer
                    arr = None
                if arr is not None and np.all(arr["n"] == k0):
                    out["faces"] = arr["v"].astype(np.int64)
                    offset += rec.itemsize * count
                else:  # ragged: slow path
                    faces = []
                    pos = offset
                    for _ in range(count):
                        k = int(np.frombuffer(body, cnt_dt, count=1, offset=pos)[0])
                        pos += cnt_dt.itemsize
                        faces.append(
                            np.frombuffer(body, idx_dt, count=k, offset=pos).astype(np.int64)
                        )
                        pos += idx_dt.itemsize * k
                    out["faces"] = faces
                    offset = pos

    v = out["vertex"]
    vertices = np.stack([v["x"], v["y"], v["z"]], axis=-1)
    normals = None
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=-1)
    uv = None
    for ukey, vkey in (("u", "v"), ("s", "t")):
        if ukey in v and vkey in v:
            uv = np.stack([v[ukey], v[vkey]], axis=-1)
            break

    faces = out.get("faces", [])
    if isinstance(faces, np.ndarray) and faces.ndim == 2 and faces.shape[1] == 3:
        indices = faces.astype(np.int64)
    else:
        tris = []
        for face in faces:
            for i in range(1, len(face) - 1):  # fan triangulation
                tris.append([face[0], face[i], face[i + 1]])
        indices = np.asarray(tris, np.int64)

    return dict(vertices=vertices, normals=normals, uv=uv, indices=indices)


def load_triangle_mesh(path: str, object_to_world, material_id: int = 0):
    """Load a PLY straight into a packed Triangles SoA
    (model_loader.jl:1-11 equivalent)."""
    from ..shapes.triangle import pack_triangle_mesh

    mesh = load_ply(path)
    return pack_triangle_mesh(
        object_to_world, mesh["indices"], mesh["vertices"],
        normals=mesh["normals"], uv=mesh["uv"], material_id=material_id,
    )
