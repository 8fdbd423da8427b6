"""Native host components: the binned-SAH BVH build, angle-weighted
vertex normals and the matmul sweep's Woop tables (copies of the JAX
package's native/ sources, the same entry points), built with g++ at
first use into ``_build/`` (git-ignored, keyed by a hash of the sources,
the flags, the compiler's version and the machine) and bound with
ctypes. A failed build raises.

No render path of either package reaches them: attach_bvh builds with
ops/bvh.build_bvh, whose nodes this builder does not reproduce bit for
bit, mesh normals come from scene/mesh.py and the Woop tables from
ops/intersect.build_matmul_tables (numpy, float64)."""

import ctypes
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), '_build')
# the JAX package's native/Makefile flags (its CXXFLAGS and LDFLAGS), so
# that the two libraries round alike (-march=native lets g++ fuse products
# into sums)
_FLAGS = ['-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall', '-shared']

_lib = None


def load_library():
    """Build native/*.cpp (once per hash of the sources, the flags, the
    compiler's version and the machine) and bind the entry points."""
    global _lib
    if _lib is not None:
        return _lib
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found: the native BVH build needs a '
                           'C++ compiler')
    version = subprocess.run([cxx, '--version'], capture_output=True,
                             text=True, check=True).stdout
    sources = sorted(glob.glob(os.path.join(_HERE, '*.cpp')))
    digest = hashlib.sha256('\n'.join(
        [' '.join(_FLAGS), version, platform.machine(),
         platform.node()]).encode())
    for src in sources:
        with open(src, 'rb') as f:
            digest.update(os.path.basename(src).encode() + f.read())
    out = os.path.join(_BUILD, f'libnative_{digest.hexdigest()[:16]}.so')
    if not os.path.exists(out):
        os.makedirs(_BUILD, exist_ok=True)
        work = tempfile.mkdtemp(dir=_BUILD)
        try:
            tmp = os.path.join(work, 'lib.so')
            proc = subprocess.run([cxx, *_FLAGS, '-o', tmp, *sources],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'native build failed:\n{proc.stderr}')
            os.replace(tmp, out)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(out)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.lmcmc_build_bvh.restype = ctypes.c_int
    lib.lmcmc_build_bvh.argtypes = [fp, fp, ctypes.c_int, fp, ctypes.c_int,
                                    ip]
    lib.lmcmc_vertex_normals.restype = None
    lib.lmcmc_vertex_normals.argtypes = [fp, ctypes.c_int, ip, ctypes.c_int,
                                         ctypes.c_int, fp]
    lib.lmcmc_woop_tables.restype = None
    lib.lmcmc_woop_tables.argtypes = [fp, ctypes.c_int, fp, fp,
                                      ctypes.POINTER(ctypes.c_uint8)]
    _lib = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_bvh_native(tri_lo, tri_hi):
    """Binned-SAH build over per-triangle bounds tri_lo / tri_hi [T, 3];
    returns (nodes [N, 8] f32, prim_ids [T] i32) in ops/bvh.py's layout."""
    lo = np.ascontiguousarray(tri_lo, np.float32)
    hi = np.ascontiguousarray(tri_hi, np.float32)
    T = lo.shape[0]
    if lo.shape != (T, 3) or hi.shape != (T, 3) or T == 0:
        raise ValueError(f'bounds of shapes {lo.shape} and {hi.shape}, '
                         f'expected [T, 3] each with T > 0')
    lib = load_library()
    cap = max(4 * T, 64)
    nodes = np.empty((cap, 8), np.float32)
    prims = np.empty(T, np.int32)
    n = lib.lmcmc_build_bvh(_fptr(lo), _fptr(hi), T, _fptr(nodes), cap,
                            _iptr(prims))
    if n < 0:
        raise RuntimeError(f'native BVH build: more than {cap} nodes')
    return nodes[:n].copy(), prims


def vertex_normals_native(verts, indices, flip=False):
    """Angle-weighted vertex normals of verts [V, 3] over triangles
    indices [T, 3]; returns [V, 3] f32."""
    v = np.ascontiguousarray(verts, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or idx.ndim != 2 or idx.shape[1] != 3:
        raise ValueError(f'vertices {v.shape}, indices {idx.shape}: expected '
                         f'[V, 3] and [T, 3]')
    if idx.size and (idx.min() < 0 or idx.max() >= v.shape[0]):
        raise ValueError(f'indices outside [0, {v.shape[0]})')
    lib = load_library()
    out = np.empty_like(v)
    lib.lmcmc_vertex_normals(_fptr(v), v.shape[0], _iptr(idx), idx.shape[0],
                             1 if flip else 0, _fptr(out))
    return out


def woop_tables_native(tri):
    """The Woop inverse frames of triangles tri [T, 3, 3] (keyframe 0):
    (B [3, 3T] f32, C [3T] f32, ok [T] bool), as
    ops/intersect.build_matmul_tables computes them (in float64, to
    within f32 rounding)."""
    t = np.ascontiguousarray(tri, np.float32)
    if t.ndim != 3 or t.shape[1:] != (3, 3):
        raise ValueError(f'triangles {t.shape}: expected [T, 3, 3]')
    lib = load_library()
    T = t.shape[0]
    B = np.empty((3, 3 * T), np.float32)
    C = np.empty(3 * T, np.float32)
    ok = np.empty(T, np.uint8)
    lib.lmcmc_woop_tables(_fptr(t), T, _fptr(B), _fptr(C),
                          ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return B, C, ok.astype(bool)
