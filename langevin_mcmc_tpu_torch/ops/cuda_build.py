"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process, all started
together, into objects that are linked into one shared library under
``_build/`` (git-ignored), keyed by a hash of every source, every header
(``csrc/*.cuh``) and the flags.
The library is built at first use on a machine with the CUDA toolkit and
bound with ctypes; each C entry point returns ``cudaGetLastError()`` of its
launch, which the wrappers turn into an exception.
"""

import ctypes
import glob
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(__file__))
_CSRC = os.path.join(_PKG, 'csrc')
_BUILD = os.path.join(_PKG, '_build')
# --fmad=false: every product and sum rounds on its own, in the order of
# the plain torch versions, so kernel and plain version agree bit for bit
_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '--fmad=false', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points, one per form of the walk kernel (csrc/walk.cuh
# launch_walk): tables and rays, (blocks, chunks, splits, any_hit), the
# closest hit's partials and outputs, occluded, chunk_mask, the stream
_WALK = [_P] * 7 + [_I] * 4 + [_P] * 10 + [_P]
# the BVH traversal (csrc/bvh.cu): the packed records and the root's
# reference, the leaf-ordered triangles and their count, the rays, (rays,
# motion, any_hit), the closest hit's outputs, occluded, the stream
_BVH = [_P, _I, _P, _I] + [_P] * 5 + [_I] * 3 + [_P] * 5 + [_P]
# the brute force (csrc/brute.cu): its tables (tris, screen, tiles, bands)
# and the scene's triangles, (triangles, tiles, bins), kappa and mu, the
# rays, (rays, splits, motion, any_hit), the ranges' partials, the closest
# hit's outputs, the any hit's flags, the stream
_F = ctypes.c_float
_BRUTE = [_P] * 5 + [_I] * 3 + [_F] * 2 + [_P] * 5 + [_I] * 4 + [_P] * 9 \
    + [_P]
# the trace registry's stamp (csrc/stamp.cu): the slots, the stage, the
# stream
_STAMP = [_P, _I, _P]
# the kNN moments (csrc/knn.cu): the cache's pss, v1, v2 and count, (rows,
# entries, coordinates), the lanes' dims, pss and order, (lanes, k), the
# squared query distance, found, v1, v2, the stream
_KNN = [_P] * 4 + [_I] * 3 + [_P] * 3 + [_I] * 2 + [_F] + [_P] * 3 + [_P]
SIGNATURES = {'chunkwalk_staged': _WALK, 'chunkwalk_resident': _WALK,
              'sweep_walk': _WALK, 'bvh_traverse': _BVH,
              'brute_force': _BRUTE, 'stamp': _STAMP, 'knn_query': _KNN}

# set by the first build in this process: seconds, cached, library path,
# and ptxas's report (-Xptxas -v) per source, kept beside the library
build_info = {}
_lib = None


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    return cand if os.path.exists(cand) else shutil.which('nvcc')


def _compile(nvcc, sources, out):
    """One nvcc per source, all at once, then one link into `out`.
    Returns ptxas's report of each source (its name -> text)."""
    work = tempfile.mkdtemp(dir=_BUILD)
    try:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(work, os.path.basename(src) + '.o')
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, '-c', '-o', obj, src],
                stderr=subprocess.PIPE, text=True)))
        reports, failed = {}, []
        for src, p in procs:
            reports[os.path.basename(src)] = p.communicate()[1]
            if p.returncode != 0:
                failed.append(src)
                print(reports[os.path.basename(src)], flush=True)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}')
        tmp = os.path.join(work, 'lib.so')
        subprocess.run([nvcc, *_NVCC_FLAGS[:2], '-shared', '-o', tmp,
                        *objs], check=True)
        os.replace(tmp, out)
        return reports
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _bind(path):
    """The library at path with every entry point of SIGNATURES it has
    bound."""
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def build_copy(out_dir, patches=(), sources=None, csrc=_CSRC):
    """A design variant of the library: csrc (default this package's)
    copied to out_dir/csrc, each patch (file, old, new) applied (old must
    occur exactly once), and the named sources (default every .cu) built
    with the library's flags into out_dir/lib.so. Returns the library,
    its entry points bound as load_library binds them, and ptxas's report
    of each source."""
    src_dir = os.path.join(out_dir, 'csrc')
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(csrc, src_dir)
    for name, old, new in patches:
        path = os.path.join(src_dir, name)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f'{out_dir}: {name} holds {text.count(old)} '
                               f'copies of the patch target {old!r}')
        with open(path, 'w') as f:
            f.write(text.replace(old, new))
    if sources is None:
        sources = sorted(os.path.basename(p)
                         for p in glob.glob(os.path.join(src_dir, '*.cu')))
    nvcc = _nvcc()
    if nvcc is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit')
    os.makedirs(_BUILD, exist_ok=True)
    out = os.path.join(out_dir, 'lib.so')
    reports = _compile(nvcc, [os.path.join(src_dir, s) for s in sources],
                       out)
    return _bind(out), reports


def _read_json(path):
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_library():
    """Build csrc/*.cu (once per hash of the sources and headers) and bind
    the entry points."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(_CSRC, '*.cu')))
    headers = sorted(glob.glob(os.path.join(_CSRC, '*.cuh')))
    digest = hashlib.sha256(' '.join(_NVCC_FLAGS).encode())
    for src in sources + headers:
        with open(src, 'rb') as f:
            digest.update(os.path.basename(src).encode() + f.read())
    out = os.path.join(_BUILD, f'liblmcmc_{digest.hexdigest()[:16]}.so')
    t0 = time.time()
    cached = os.path.exists(out)
    if not cached:
        nvcc = _nvcc()
        if nvcc is None:
            raise RuntimeError('nvcc not found: the CUDA kernels need the '
                               'CUDA toolkit')
        os.makedirs(_BUILD, exist_ok=True)
        with open(out + '.ptxas.json', 'w') as f:
            json.dump(_compile(nvcc, sources, out), f)
    lib = _bind(out)
    build_info.update(seconds=time.time() - t0, cached=cached, path=out,
                      sources=[os.path.basename(s) for s in sources],
                      ptxas=_read_json(out + '.ptxas.json'))
    _lib = lib
    return lib


def check(x, name, dtype, shape, device):
    """Raise ValueError unless x is a contiguous tensor of this dtype and
    shape on device."""
    if x.device != device:
        raise ValueError(f'{name} on {x.device}, expected {device}')
    if x.dtype != dtype:
        raise ValueError(f'{name} has dtype {x.dtype}, expected {dtype}')
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(x.shape)}, expected '
                         f'{tuple(shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{name} is not contiguous')


def stream_of(device):
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(err, what):
    if err != 0:
        raise RuntimeError(f'{what} launch failed: CUDA error {err}')
