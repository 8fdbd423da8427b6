"""Triangle-mesh data and host-side loaders.

Replaces the reference's loadserialized.cpp (Mitsuba .serialized format,
zlib-inflated) and parseobj.cpp (Wavefront OBJ) with numpy implementations,
including the Nelson-Max angle-weighted vertex-normal computation
(reference src/loadserialized.cpp:114-151, src/parseobj.cpp:57-92).
"""

import dataclasses
import struct
import zlib

import numpy as np

MTS_V3 = 0x0003
MTS_V4 = 0x0004

HAS_NORMALS = 0x0001
HAS_TEXCOORDS = 0x0002
HAS_COLORS = 0x0008
FACE_NORMALS = 0x0010
SINGLE_PRECISION = 0x1000
DOUBLE_PRECISION = 0x2000


@dataclasses.dataclass
class TriMeshData:
    """SoA host mesh. position/normal carry both keyframes [2, V, 3]."""
    position: np.ndarray     # [2, V, 3] float32
    normal: np.ndarray       # [2, V, 3] float32
    st: np.ndarray           # [V, 2] float32 (zeros if absent)
    indices: np.ndarray      # [T, 3] int32
    is_moving: bool = False


def _xform_points(m, p):
    ph = np.concatenate([p, np.ones_like(p[:, :1])], 1)
    out = ph @ np.asarray(m, np.float64).T
    return (out[:, :3] / out[:, 3:4])


def _xform_normals(m_inv, n):
    # n' = (M^-1)^T n
    return n @ np.asarray(m_inv, np.float64)[:3, :3]


def compute_vertex_normals(vertices, indices, flip=False):
    """Angle-weighted vertex normals (Nelson Max 1999), vectorized numpy port
    of reference src/loadserialized.cpp:114-151."""
    v = np.asarray(vertices, np.float64)
    idx = np.asarray(indices, np.int64)
    normals = np.zeros_like(v)

    p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    fl = np.linalg.norm(fn, axis=1)
    good = fl > 0
    fn_unit = np.where(good[:, None], fn / np.maximum(fl, 1e-30)[:, None], 0.0)

    def unit_angle(u, vv):
        d = np.sum(u * vv, 1)
        neg = d < 0
        a_neg = (np.pi - 2.0) * np.arcsin(
            np.clip(0.5 * np.linalg.norm(vv + u, axis=1), -1, 1))
        a_pos = 2.0 * np.arcsin(np.clip(0.5 * np.linalg.norm(vv - u, axis=1), -1, 1))
        return np.where(neg, a_neg, a_pos)

    def normed(x):
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)

    corners = [(p0, p1, p2), (p1, p2, p0), (p2, p0, p1)]
    for i, (a, b, c) in enumerate(corners):
        ang = unit_angle(normed(b - a), normed(c - a))
        contrib = fn_unit * (ang * good)[:, None]
        if flip:
            contrib = -contrib
        np.add.at(normals, idx[:, i], contrib)

    ln = np.linalg.norm(normals, axis=1, keepdims=True)
    return np.where(ln > 0, normals / np.maximum(ln, 1e-30), 0.0)


def load_serialized(filename, shape_index, to_world0=None, to_world1=None,
                    is_moving=False, flip_normals=False, face_normals=False):
    """Load one mesh from a Mitsuba .serialized file
    (format per reference src/loadserialized.cpp:239-325)."""
    if to_world0 is None:
        to_world0 = np.eye(4)
    if to_world1 is None:
        to_world1 = to_world0
    inv0 = np.linalg.inv(to_world0)
    inv1 = np.linalg.inv(to_world1)

    with open(filename, 'rb') as f:
        raw = f.read()
    version, = struct.unpack('<H', raw[2:4])
    offset = 4
    if shape_index > 0:
        count, = struct.unpack('<I', raw[-4:])
        if version == MTS_V4:
            table = raw[-(8 * count + 4):-4]
            offset = struct.unpack('<Q', table[8 * shape_index: 8 * shape_index + 8])[0]
        else:
            table = raw[-(4 * (count + 1)):-4]
            offset = struct.unpack('<I', table[4 * shape_index: 4 * shape_index + 4])[0]
        offset += 4  # skip the per-shape short magic+version header

    blob = zlib.decompress(raw[offset:])
    pos = 0
    flags, = struct.unpack('<I', blob[pos:pos + 4]); pos += 4
    if version == MTS_V4:
        end = blob.index(b'\x00', pos)
        pos = end + 1
    vcount, = struct.unpack('<Q', blob[pos:pos + 8]); pos += 8
    tcount, = struct.unpack('<Q', blob[pos:pos + 8]); pos += 8

    dt = np.float64 if (flags & DOUBLE_PRECISION) else np.float32
    isize = np.dtype(dt).itemsize

    p = np.frombuffer(blob, dt, vcount * 3, pos).reshape(vcount, 3).astype(np.float64)
    pos += vcount * 3 * isize

    n_raw = None
    if flags & HAS_NORMALS:
        n_raw = np.frombuffer(blob, dt, vcount * 3, pos).reshape(vcount, 3).astype(np.float64)
        pos += vcount * 3 * isize
    st = np.zeros((vcount, 2), np.float32)
    if flags & HAS_TEXCOORDS:
        st = np.frombuffer(blob, dt, vcount * 2, pos).reshape(vcount, 2).astype(np.float32)
        pos += vcount * 2 * isize
    if flags & HAS_COLORS:
        pos += vcount * 3 * 8  # colors are stored double (loadserialized.cpp:228-237)
    indices = np.frombuffer(blob, np.uint32, tcount * 3, pos).reshape(tcount, 3)
    indices = indices.astype(np.int32)

    p0 = _xform_points(to_world0, p)
    p1 = _xform_points(to_world1, p) if is_moving else p0

    use_face_normals = bool(flags & FACE_NORMALS) or face_normals
    if n_raw is None or use_face_normals:
        n0 = compute_vertex_normals(p0, indices, flip_normals)
        n1 = compute_vertex_normals(p1, indices, flip_normals) if is_moving else n0
    else:
        n0 = _xform_normals(inv0, n_raw)
        n1 = _xform_normals(inv1, n_raw) if is_moving else n0
        if flip_normals:
            n0, n1 = -n0, -n1

    return TriMeshData(
        position=np.stack([p0, p1]).astype(np.float32),
        normal=np.stack([n0, n1]).astype(np.float32),
        st=st,
        indices=indices,
        is_moving=is_moving,
    )


def load_obj(filename, to_world0=None, to_world1=None, is_moving=False,
             flip_normals=False, face_normals=False):
    """Wavefront OBJ loader (reference src/parseobj.cpp), with per-(v,vt,vn)
    vertex dedup and fan triangulation of polygons."""
    if to_world0 is None:
        to_world0 = np.eye(4)
    if to_world1 is None:
        to_world1 = to_world0
    inv0 = np.linalg.inv(to_world0)
    inv1 = np.linalg.inv(to_world1)

    pos_pool, st_pool, nor_pool = [], [], []
    vert_map = {}
    out_v, out_st, out_n = [], [], []
    tris = []

    def vertex_id(tok):
        if tok in vert_map:
            return vert_map[tok]
        parts = (tok.split('/') + ['', ''])[:3]
        vi = int(parts[0]) - 1 if parts[0] else -1
        ti = int(parts[1]) - 1 if parts[1] else -1
        ni = int(parts[2]) - 1 if parts[2] else -1
        out_v.append(pos_pool[vi])
        out_st.append(st_pool[ti] if ti >= 0 else (0.0, 0.0))
        out_n.append(nor_pool[ni] if ni >= 0 else None)
        vid = len(out_v) - 1
        vert_map[tok] = vid
        return vid

    with open(filename) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == 'v':
                pos_pool.append((float(t[1]), float(t[2]), float(t[3])))
            elif t[0] == 'vt':
                st_pool.append((float(t[1]), float(t[2])))
            elif t[0] == 'vn':
                nor_pool.append((float(t[1]), float(t[2]), float(t[3])))
            elif t[0] == 'f':
                ids = [vertex_id(tok) for tok in t[1:]]
                for k in range(2, len(ids)):
                    tris.append((ids[0], ids[k - 1], ids[k]))

    p = np.asarray(out_v, np.float64).reshape(-1, 3)
    st = np.asarray(out_st, np.float32).reshape(-1, 2)
    indices = np.asarray(tris, np.int32).reshape(-1, 3)

    p0 = _xform_points(to_world0, p)
    p1 = _xform_points(to_world1, p) if is_moving else p0

    has_all_normals = all(n is not None for n in out_n) and len(out_n) > 0
    if has_all_normals and not face_normals:
        n_raw = np.asarray(out_n, np.float64)
        n0 = _xform_normals(inv0, n_raw)
        n1 = _xform_normals(inv1, n_raw) if is_moving else n0
        ln = np.linalg.norm(n0, axis=1, keepdims=True)
        n0 = np.where(ln > 0, n0 / np.maximum(ln, 1e-30), 0.0)
        if is_moving:
            ln1 = np.linalg.norm(n1, axis=1, keepdims=True)
            n1 = np.where(ln1 > 0, n1 / np.maximum(ln1, 1e-30), 0.0)
        else:
            n1 = n0
        if flip_normals:
            n0, n1 = -n0, -n1
    else:
        n0 = compute_vertex_normals(p0, indices, flip_normals)
        n1 = compute_vertex_normals(p1, indices, flip_normals) if is_moving else n0

    return TriMeshData(
        position=np.stack([p0, p1]).astype(np.float32),
        normal=np.stack([n0, n1]).astype(np.float32),
        st=st,
        indices=indices,
        is_moving=is_moving,
    )
