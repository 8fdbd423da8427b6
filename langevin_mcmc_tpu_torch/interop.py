"""Carry scene data and path/chain state between the JAX package and the
port as dicts of numpy arrays (numpy and torch only; no JAX import).

The dicts are keyed by the field names the two packages share, so a test
can take a scene parsed by the JAX package, carry it across, and feed both
packages the same scene and the same inputs. These converters are for the
tests, which run on the CPU: that is why their device defaults to 'cpu',
unlike the port's entry points.
"""

import dataclasses

import numpy as np
import torch

from .scene.scenedata import HOST_FIELDS, build_scene
from .scene.textures import _flatten_neigh
from .path.records import PathRecord, Contribs
from .mcmc.chain import ChainState
from .mcmc.gaussian import Gaussian

CAMERA_FIELDS = ('sample_to_cam', 'cam_to_sample', 'c2w_trans', 'c2w_quat',
                 'w2c_trans', 'w2c_quat', 'near_clip', 'far_clip', 'dist',
                 'width', 'height')


TEXTURE_FIELDS = ('neigh', 'size', 'gamma', 'uvscale', 'offset')


def textures_from_numpy(d):
    """The port's texture host arrays from the JAX TexturePack fields
    (TEXTURE_FIELDS; offset None means the JAX padded layout
    [N, Hmax, Wmax, 12], which is flattened here)."""
    size = np.asarray(d['size'], np.int32)
    if d['offset'] is None:
        neigh, offset = _flatten_neigh(np.asarray(d['neigh']), size)
    else:
        neigh = np.asarray(d['neigh'])
        offset = np.asarray(d['offset'], np.int32)
    return dict(neigh=neigh, offset=offset, size=size,
                gamma=np.asarray(d['gamma']), uvscale=np.asarray(d['uvscale']))


def scene_from_numpy(d, device='cpu'):
    """SceneData from a dict of numpy arrays holding the JAX SceneData
    fields (HOST_FIELDS, both keyframes of tri_p and tri_n among them,
    num_lights, env_light_id, has_motion, 'camera': a dict of
    CAMERA_FIELDS, 'textures': a dict of TEXTURE_FIELDS and, where given,
    the BVH's 'bvh_nodes', 'bvh_prim_ids' and 'use_bvh')."""
    host = {k: np.asarray(d[k]) for k in HOST_FIELDS}
    for k in ('bvh_nodes', 'bvh_prim_ids', 'use_bvh'):
        if k in d:
            host[k] = d[k]
    host['num_lights'] = int(d['num_lights'])
    host['env_light_id'] = int(d['env_light_id'])
    host['has_motion'] = bool(d['has_motion'])
    host['camera'] = {k: np.asarray(d['camera'][k]) for k in CAMERA_FIELDS}
    host['textures'] = textures_from_numpy(d['textures'])
    return build_scene(host, device)


def _from_numpy(cls, d, device):
    kw = {}
    for f in dataclasses.fields(cls):
        # an optional field (default None) may be absent or None
        v = d.get(f.name) if f.default is None else d[f.name]
        if v is None:
            kw[f.name] = None
        elif f.name in ('rec', 'cached_rec'):
            kw[f.name] = record_from_numpy(v, device)
        elif f.name == 'gaussian':
            kw[f.name] = _from_numpy(Gaussian, v, device)
        else:
            a = np.array(v)
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            kw[f.name] = torch.as_tensor(a, device=device)
    return cls(**kw)


def _to_numpy(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out[f.name] = _to_numpy(v)
        else:
            out[f.name] = v.detach().cpu().numpy()
    return out


def record_from_numpy(d, device='cpu'):
    """PathRecord from a dict of numpy arrays (PathRecord field names)."""
    return _from_numpy(PathRecord, d, device)


def contribs_from_numpy(d, device='cpu'):
    return _from_numpy(Contribs, d, device)


def chain_state_from_numpy(d, device='cpu'):
    """ChainState from numpy arrays; 'rec' and 'gaussian' are nested dicts
    (the Gaussian's mean, cov_l_d, inv_cov_d, log_det and its dense
    cov_l, inv_cov, is_diagonal: [C, Dm, Dm] for H2MC, [C, 1, 1]
    placeholders for MALA)."""
    return _from_numpy(ChainState, d, device)


def record_to_numpy(obj):
    """PathRecord, Contribs or ChainState -> (nested) dict of numpy
    arrays; an optional field that is None (a ChainState's cached_rec
    without cache sampling) is left out."""
    return _to_numpy(obj)
