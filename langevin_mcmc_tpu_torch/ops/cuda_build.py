"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` process, all started
together, into objects that are linked into one shared library under
``_build/`` (git-ignored), keyed by a hash of every source and the flags.
The library is built at first use on a machine with the CUDA toolkit and
bound with ctypes; each C entry point returns ``cudaGetLastError()`` of its
launch, which the wrappers turn into an exception.
"""

import ctypes
import glob
import hashlib
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
               '-O3', '--fmad=false', '-Xcompiler', '-fPIC']

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: argument types (pointers, then int sizes, then outputs,
# then the stream)
SIGNATURES = {
    'chunkwalk_closest': [_P] * 7 + [_I] * 3 + [_P] * 4 + [_P],
    'chunkwalk_any': [_P] * 7 + [_I] * 3 + [_P] + [_P],
    'sweep_closest': [_P] * 6 + [_I] * 2 + [_P] * 4 + [_P],
    'sweep_any': [_P] * 6 + [_I] * 2 + [_P] + [_P],
}

# set by the first build in this process: seconds, cached, library path
build_info = {}
_lib = None


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(cuda_home, 'bin', 'nvcc')
    return cand if os.path.exists(cand) else shutil.which('nvcc')


def _compile(nvcc, sources, out):
    """One nvcc per source, all at once, then one link into `out`."""
    work = tempfile.mkdtemp(dir=_BUILD)
    try:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(work, os.path.basename(src) + '.o')
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, '-c', '-o', obj, src])))
        failed = [src for src, p in procs if p.wait() != 0]
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}')
        tmp = os.path.join(work, 'lib.so')
        subprocess.run([nvcc, *_NVCC_FLAGS[:2], '-shared', '-o', tmp,
                        *objs], check=True)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load_library():
    """Build csrc/*.cu (once per source hash) and bind the entry points."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(_CSRC, '*.cu')))
    digest = hashlib.sha256(' '.join(_NVCC_FLAGS).encode())
    for src in sources:
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
        _compile(nvcc, sources, out)
    lib = ctypes.CDLL(out)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=time.time() - t0, cached=cached, path=out,
                      sources=[os.path.basename(s) for s in sources])
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
