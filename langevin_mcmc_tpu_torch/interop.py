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
from .path.records import PathRecord, Contribs
from .mcmc.chain import ChainState
from .mcmc.gaussian import Gaussian

CAMERA_FIELDS = ('sample_to_cam', 'cam_to_sample', 'c2w_trans', 'c2w_quat',
                 'w2c_trans', 'w2c_quat', 'near_clip', 'far_clip', 'dist',
                 'width', 'height')


def scene_from_numpy(d, device='cpu'):
    """SceneData from a dict of numpy arrays holding the JAX SceneData
    fields (HOST_FIELDS, num_lights, and 'camera': a dict of
    CAMERA_FIELDS)."""
    host = {k: np.asarray(d[k]) for k in HOST_FIELDS}
    host['num_lights'] = int(d['num_lights'])
    host['camera'] = {k: np.asarray(d['camera'][k]) for k in CAMERA_FIELDS}
    return build_scene(host, device)


def _from_numpy(cls, d, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.name == 'rec':
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
        out[f.name] = _to_numpy(v) if dataclasses.is_dataclass(v) \
            else v.detach().cpu().numpy()
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
    arrays."""
    return _to_numpy(obj)
