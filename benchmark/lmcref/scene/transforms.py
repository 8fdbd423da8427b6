"""Affine transforms, quaternions and two-keyframe animated transforms
(port of scene/transforms.py).

Host-side construction is the JAX package's numpy code unchanged; the
shutter-time interpolation is torch.
"""

import numpy as np
import torch


def scale(v):
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def translate(v):
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = v
    return m


def rotate(angle_deg, axis):
    """Rotation matrix matching reference src/transform.cpp:10-40."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.radians(angle_deg))
    c = np.cos(np.radians(angle_deg))
    x, y, z = a
    m = np.eye(4, dtype=np.float64)
    m[0] = [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0]
    m[1] = [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s, 0]
    m[2] = [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c, 0]
    return m


def look_at(pos, target, up):
    """Camera-to-world matrix matching reference src/transform.cpp:42-77
    (left-handed: x=left, y=newUp, z=view dir)."""
    pos = np.asarray(pos, np.float64)
    d = np.asarray(target, np.float64) - pos
    d /= np.linalg.norm(d)
    up = np.asarray(up, np.float64)
    up /= np.linalg.norm(up)
    left = np.cross(up, d)
    left /= np.linalg.norm(left)
    new_up = np.cross(d, left)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = pos
    return m


def perspective(fov_deg, near, far):
    """Projection matching reference src/transform.cpp:79-90."""
    recip = 1.0 / (far - near)
    cot = 1.0 / np.tan(np.radians(fov_deg / 2.0))
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = cot
    m[1, 1] = cot
    m[2, 2] = far * recip
    m[2, 3] = -near * far * recip
    m[3, 2] = 1.0
    return m


def quaternion_from_matrix(m):
    """Rotation matrix -> quaternion (x,y,z,w), reference src/quaternion.cpp:4-36."""
    trace = m[0, 0] + m[1, 1] + m[2, 2]
    q = np.zeros(4, np.float64)
    if trace > 1e-7:
        s = np.sqrt(trace + 1.0)
        q[3] = s / 2.0
        s = 0.5 / s
        q[0] = (m[2, 1] - m[1, 2]) * s
        q[1] = (m[0, 2] - m[2, 0]) * s
        q[2] = (m[1, 0] - m[0, 1]) * s
    else:
        nxt = [1, 2, 0]
        i = 0
        if m[1, 1] > m[0, 0]:
            i = 1
        if m[2, 2] > m[i, i]:
            i = 2
        j, k = nxt[i], nxt[nxt[i]]
        s = np.sqrt((m[i, i] - (m[j, j] + m[k, k])) + 1.0)
        _q = np.zeros(3, np.float64)
        _q[i] = s * 0.5
        if s != 0.0:
            s = 0.5 / s
        q[3] = (m[k, j] - m[j, k]) * s
        _q[j] = (m[j, i] + m[i, j]) * s
        _q[k] = (m[k, i] + m[i, k]) * s
        q[:3] = _q
    return q


def quaternion_to_matrix_np(q):
    x, y, z, w = q
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = 1 - 2 * (y * y + z * z)
    m[0, 1] = 2 * (x * y - z * w)
    m[0, 2] = 2 * (x * z + y * w)
    m[1, 0] = 2 * (x * y + z * w)
    m[1, 1] = 1 - 2 * (x * x + z * z)
    m[1, 2] = 2 * (y * z - x * w)
    m[2, 0] = 2 * (x * z - y * w)
    m[2, 1] = 2 * (y * z + x * w)
    m[2, 2] = 1 - 2 * (x * x + y * y)
    return m


class AnimatedTransform:
    """Two-keyframe rigid transform, decomposed as translate + quaternion
    (reference src/animatedtransform.h:11-64). Assumes rigid input (camera
    and envmap transforms are)."""

    def __init__(self, m0, m1=None):
        m0 = np.asarray(m0, np.float64)
        m1 = m0 if m1 is None else np.asarray(m1, np.float64)
        self.is_moving = not np.array_equal(m0, m1)
        self.t = np.stack([m0[:3, 3], m1[:3, 3]])
        self.q = np.stack([quaternion_from_matrix(m0), quaternion_from_matrix(m1)])

    def inverse(self):
        inv = AnimatedTransform.__new__(AnimatedTransform)
        inv.is_moving = self.is_moving
        inv.q = self.q * np.array([-1.0, -1.0, -1.0, 1.0])
        inv.t = np.stack([
            -quaternion_to_matrix_np(inv.q[0])[:3, :3] @ self.t[0],
            -quaternion_to_matrix_np(inv.q[1])[:3, :3] @ self.t[1],
        ])
        return inv

    def matrix(self, time=0.0):
        """Host-side interpolation to a 4x4 numpy matrix."""
        q = slerp_np(time, self.q[0], self.q[1])
        m = quaternion_to_matrix_np(q)
        m[:3, 3] = (1 - time) * self.t[0] + time * self.t[1]
        return m

    def as_arrays(self, dtype=np.float32):
        """(translate[2,3], quat[2,4]) host arrays."""
        return self.t.astype(dtype), self.q.astype(dtype)


def slerp_np(t, q1, q2):
    cos_theta = np.dot(q1, q2)
    if cos_theta < 0:
        q2, cos_theta = -q2, -cos_theta
    if cos_theta > 0.9995:
        q = (1 - t) * q1 + t * q2
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(cos_theta, -1, 1))
    qperp = q2 - q1 * cos_theta
    qperp /= np.linalg.norm(qperp)
    return q1 * np.cos(theta * t) + qperp * np.sin(theta * t)


# ---- shutter-time interpolation (torch) ------------------------------------

def slerp(t, q1, q2):
    """Quaternion slerp, batched over t."""
    cos_theta = torch.sum(q1 * q2, -1)
    q2 = torch.where(cos_theta[..., None] < 0, -q2, q2)
    cos_theta = torch.abs(cos_theta)
    lin = (1.0 - t)[..., None] * q1 + t[..., None] * q2
    lin = lin / torch.linalg.norm(lin, dim=-1, keepdim=True)
    theta = torch.acos(torch.clamp(cos_theta, -1.0, 1.0))
    thetap = theta * t
    qperp = q2 - q1 * cos_theta[..., None]
    qperp = qperp / torch.clamp(torch.linalg.norm(qperp, dim=-1, keepdim=True),
                                min=1e-20)
    gen = (q1 * torch.cos(thetap)[..., None]
           + qperp * torch.sin(thetap)[..., None])
    return torch.where(cos_theta[..., None] > 0.9995, lin, gen)


def quaternion_to_matrix(q):
    """Quaternion [...,4] -> rotation matrix [...,3,3]."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                      2 * (x * z + y * w)], -1)
    r1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                      2 * (y * z - x * w)], -1)
    r2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                      1 - 2 * (x * x + y * y)], -1)
    return torch.stack([r0, r1, r2], -2)


def interpolate_rigid(trans, quat, time):
    """Two-keyframe (translate[2,3], quat[2,4]) transform at time [...];
    returns rot [...,3,3] and trans [...,3]. Differentiable."""
    q = slerp(time, quat[0], quat[1])
    rot = quaternion_to_matrix(q)
    tr = (1.0 - time)[..., None] * trans[0] + time[..., None] * trans[1]
    return rot, tr


def rigid_xform_point(rot, tr, p):
    return torch.einsum('...ij,...j->...i', rot, p) + tr


def rigid_xform_vector(rot, v):
    return torch.einsum('...ij,...j->...i', rot, v)
