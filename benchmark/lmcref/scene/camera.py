"""Perspective camera (port of scene/camera.py): host-built sampleToCam /
camToSample matrices, batched differentiable ray generation and point
projection."""

import dataclasses

import numpy as np
import torch

from . import transforms as T
from ..utils import vecmath as vm


@dataclasses.dataclass
class Camera:
    sample_to_cam: torch.Tensor    # [4,4]
    cam_to_sample: torch.Tensor    # [4,4]
    c2w_trans: torch.Tensor        # [2,3]
    c2w_quat: torch.Tensor         # [2,4]
    w2c_trans: torch.Tensor        # [2,3]
    w2c_quat: torch.Tensor         # [2,4]
    near_clip: float
    far_clip: float
    dist: float                    # W / (2 tan(fov/2))
    width: int
    height: int


def camera_from_arrays(a, device, dtype=torch.float32):
    """Camera from a dict of host arrays (keys as the Camera fields)."""
    t = lambda k: torch.as_tensor(np.array(a[k], np.float32),
                                  device=device).to(dtype)
    return Camera(
        sample_to_cam=t('sample_to_cam'), cam_to_sample=t('cam_to_sample'),
        c2w_trans=t('c2w_trans'), c2w_quat=t('c2w_quat'),
        w2c_trans=t('w2c_trans'), w2c_quat=t('w2c_quat'),
        near_clip=float(a['near_clip']), far_clip=float(a['far_clip']),
        dist=float(a['dist']), width=int(a['width']),
        height=int(a['height']))


def camera_arrays(to_world, fov, width, height, near_clip=1e-2,
                  far_clip=1000.0):
    """Host-side camera tables (the numpy half of the JAX make_camera)."""
    aspect = width / height
    cam_to_sample = (T.scale([-0.5, -0.5 * aspect, 1.0])
                     @ T.translate([-1.0, -1.0 / aspect, 0.0])
                     @ T.perspective(fov, near_clip, far_clip))
    sample_to_cam = np.linalg.inv(cam_to_sample)
    dist = width / (2.0 * np.tan((fov / 2.0) * np.pi / 180.0))
    w2c = to_world.inverse()
    ct, cq = to_world.as_arrays()
    wt, wq = w2c.as_arrays()
    return dict(sample_to_cam=sample_to_cam.astype(np.float32),
                cam_to_sample=cam_to_sample.astype(np.float32),
                c2w_trans=ct, c2w_quat=cq, w2c_trans=wt, w2c_quat=wq,
                near_clip=float(near_clip), far_clip=float(far_clip),
                dist=float(dist), width=int(width), height=int(height))


def sample_primary(cam: Camera, screen_pos, time):
    """Primary ray for screen position in [0,1)^2 at shutter `time`.
    Returns (org, dir, min_t, max_t)."""
    zeros = torch.zeros_like(screen_pos[..., :1])
    p_cam = vm.xform_point(cam.sample_to_cam, torch.cat([screen_pos, zeros], -1))
    d_cam = vm.normalize(p_cam)
    inv_z = 1.0 / d_cam[..., 2]
    rot, tr = T.interpolate_rigid(cam.c2w_trans, cam.c2w_quat, time)
    org = torch.broadcast_to(tr, d_cam.shape)
    d = T.rigid_xform_vector(rot, d_cam)
    return org, d, cam.near_clip * inv_z, cam.far_clip * inv_z


def camera_center_dir(cam: Camera, time):
    """Origin and viewing direction of the central ray (screenPos=(.5,.5))."""
    sp = torch.stack([time * 0 + 0.5, time * 0 + 0.5], -1)
    org, d, _, _ = sample_primary(cam, sp, time)
    return org, d


def project_point(cam: Camera, p, time):
    """World point -> screen [0,1)^2. Returns (screen_pos, valid)."""
    rot, tr = T.interpolate_rigid(cam.w2c_trans, cam.w2c_quat, time)
    cam_p = T.rigid_xform_point(rot, tr, p)
    valid = (cam_p[..., 2] >= cam.near_clip) & (cam_p[..., 2] <= cam.far_clip)
    raster = vm.xform_point(cam.cam_to_sample, cam_p)
    valid &= ((raster[..., 0] >= 0.0) & (raster[..., 0] <= 1.0)
              & (raster[..., 1] >= 0.0) & (raster[..., 1] <= 1.0))
    return raster[..., :2], valid
