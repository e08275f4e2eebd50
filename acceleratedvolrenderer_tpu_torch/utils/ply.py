"""PLY mesh I/O (port of acceleratedvolrenderer_tpu/utils/ply.py, numpy only).

Reads ascii and binary_little_endian PLY into (vertices, faces[, normals,
uvs]); writes binary PLY.  Faces with more than 3 vertices are
fan-triangulated.  Used by Shape "plymesh" in the scene parser and by
`pbrt --toply`.
"""
from __future__ import annotations

import struct

import numpy as np

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def read_ply(path: str):
    """Returns dict with 'vertices' (V,3) f32, 'faces' (F,3) i32, and
    optionally 'normals' (V,3), 'uvs' (V,2)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, type, list_types|None)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append((tok[4], tok[3], tok[2]))
                else:
                    elements[-1][2].append((tok[2], tok[1], None))
            elif tok[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise NotImplementedError(f"{path}: format {fmt}")

        data = {}
        for name, count, props in elements:
            rows = []
            if fmt == "ascii":
                for _ in range(count):
                    vals = f.readline().split()
                    pos = 0
                    row = {}
                    for pname, ptype, ltype in props:
                        if ltype is None:
                            row[pname] = float(vals[pos]); pos += 1
                        else:
                            n = int(vals[pos]); pos += 1
                            row[pname] = [float(v) for v in vals[pos:pos + n]]
                            pos += n
                    rows.append(row)
            else:
                for _ in range(count):
                    row = {}
                    for pname, ptype, ltype in props:
                        if ltype is None:
                            c, sz = _TYPES[ptype]
                            row[pname] = struct.unpack(
                                "<" + c, f.read(sz))[0]
                        else:
                            cc, cs = _TYPES[ltype]
                            n = struct.unpack("<" + cc, f.read(cs))[0]
                            c, sz = _TYPES[ptype]
                            row[pname] = list(struct.unpack(
                                "<" + c * n, f.read(sz * n)))
                    rows.append(row)
            data[name] = rows

    out = {}
    if "vertex" in data:
        vs = data["vertex"]
        out["vertices"] = np.array(
            [[r["x"], r["y"], r["z"]] for r in vs], np.float32)
        if vs and "nx" in vs[0]:
            out["normals"] = np.array(
                [[r["nx"], r["ny"], r["nz"]] for r in vs], np.float32)
        ukeys = ("u", "s", "texture_u")
        vkeys = ("v", "t", "texture_v")
        for uk, vk in zip(ukeys, vkeys):
            if vs and uk in vs[0]:
                out["uvs"] = np.array(
                    [[r[uk], r[vk]] for r in vs], np.float32)
                break
    faces = []
    for fname in ("face", "tristrips"):
        if fname not in data:
            continue
        for r in data[fname]:
            idx = [int(i) for i in
                   r.get("vertex_indices", r.get("vertex_index", []))]
            if fname == "tristrips":
                for i in range(len(idx) - 2):
                    a, b, c = idx[i], idx[i + 1], idx[i + 2]
                    if a < 0 or b < 0 or c < 0:
                        continue
                    faces.append([a, c, b] if i % 2 else [a, b, c])
            else:
                for i in range(1, len(idx) - 1):   # fan triangulation
                    faces.append([idx[0], idx[i], idx[i + 1]])
    out["faces"] = np.asarray(faces, np.int32).reshape(-1, 3)
    return out


def write_ply(path: str, vertices, faces, normals=None, uvs=None):
    """Binary little-endian PLY writer."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {len(vertices)}",
               "property float x", "property float y", "property float z"]
        if normals is not None:
            hdr += ["property float nx", "property float ny",
                    "property float nz"]
        if uvs is not None:
            hdr += ["property float u", "property float v"]
        hdr += [f"element face {len(faces)}",
                "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        cols = [vertices]
        if normals is not None:
            cols.append(np.asarray(normals, np.float32))
        if uvs is not None:
            cols.append(np.asarray(uvs, np.float32))
        f.write(np.concatenate(cols, axis=1).astype("<f4").tobytes())
        for face in faces:
            f.write(struct.pack("<B3i", 3, *[int(i) for i in face]))
