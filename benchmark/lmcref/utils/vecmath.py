"""Vector math on trailing-axis-3 tensors (port of utils/vecmath.py).

Every guard against an infinite derivative in an untaken branch is kept as
the JAX code has it: ``torch.where`` leaks NaN gradients from the branch it
does not take exactly as ``jnp.where`` does.
"""

import torch

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI
INV_TWO_PI = 1.0 / TWO_PI
FOUR_PI = 4.0 * PI
INV_FOUR_PI = 1.0 / FOUR_PI
PI_OVER_TWO = 0.5 * PI
PI_OVER_FOUR = 0.25 * PI

ISECT_EPS = 5e-4
SHADOW_EPS = 5e-4
COS_EPS = 1e-4
AD_EPS = 1e-6


def dot(a, b):
    return torch.sum(a * b, -1)


def length_squared(v):
    return torch.sum(v * v, -1)


def normalize(v):
    # rsqrt(max(.)) keeps gradients finite at v == 0
    ls = length_squared(v)
    return v * torch.rsqrt(torch.clamp(ls, min=1e-18))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def distance_squared(a, b):
    return length_squared(a - b)


def luminance(rgb):
    return (0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1]
            + 0.072169 * rgb[..., 2])


def modulo(a, b):
    """Floor modulo into [0, b) (jnp.mod semantics, never torch.fmod)."""
    r = torch.remainder(a, b)
    return torch.where(r < 0, r + b, r)


def tent(u):
    """Tent deformation of a uniform in [0,1) to [-1, 1]; sqrt clamped away
    from 0 for the gradient."""
    lo = 1.0 - torch.sqrt(torch.clamp(2.0 * u, min=1e-12))
    hi = torch.sqrt(torch.clamp(2.0 * (u - 0.5), min=1e-12)) - 1.0
    return torch.where(u < 0.5, lo, hi)


def coordinate_system(n):
    """Orthonormal (b0, b1) around unit normal n (Duff et al. frame with
    the n.z == -1 guard)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    degenerate = z < (-1.0 + 1e-6)
    a = 1.0 / torch.where(degenerate, torch.ones_like(z), 1.0 + z)
    b = -x * y * a
    # the degenerate frame is ((0, -1, 0), (-1, 0, 0)), selected per
    # component (no constant tensor copied from the host)
    d = lambda v, c: torch.where(degenerate, v, c)
    b0 = torch.stack([d(0.0, 1.0 - x * x * a), d(-1.0, b), d(0.0, -x)], -1)
    b1 = torch.stack([d(-1.0, b), d(0.0, 1.0 - y * y * a), d(0.0, -y)], -1)
    return b0, b1


def reflect(wi, n):
    return 2.0 * dot(wi, n)[..., None] * n - wi


def refract(wi, n, cos_theta_t, eta, inv_eta):
    """n * (dot(wi, n) * eta_ + cosThetaT) - wi * eta_ with
    eta_ = invEta where cosThetaT < 0, else eta."""
    scale = torch.where(cos_theta_t < 0.0, inv_eta, eta)
    return (n * (dot(wi, n) * scale + cos_theta_t)[..., None]
            - wi * scale[..., None])


def sample_sphere(coord):
    """Spherical parameterization; returns (dir, jacobian)."""
    scaled_theta = TWO_PI * coord[..., 0]
    scaled_phi = PI * coord[..., 1]
    sin_phi = torch.sin(scaled_phi)
    cos_phi = torch.cos(scaled_phi)
    d = torch.stack([sin_phi * torch.cos(scaled_theta),
                     sin_phi * torch.sin(scaled_theta), cos_phi], -1)
    jacobian = torch.abs(sin_phi) * TWO_PI * PI
    return d, jacobian


def patan2(y, x):
    """atan2 wrapped to [0, 2pi) with atan2(0,0) = 0 and a finite gradient
    at the origin."""
    origin = (y == 0.0) & (x == 0.0)
    x = torch.where(origin, torch.ones_like(x), x)
    r = torch.atan2(y, x)
    r = torch.where(r < 0.0, r + TWO_PI, r)
    return torch.where(origin, torch.zeros_like(r), r)


def to_spherical_coord(d):
    theta = patan2(d[..., 1], d[..., 0]) * INV_TWO_PI
    phi = torch.acos(torch.clamp(d[..., 2], -1.0 + 1e-7, 1.0 - 1e-7))
    jacobian = torch.abs(torch.sin(phi)) * TWO_PI * PI
    return torch.stack([theta, phi * INV_PI], -1), jacobian


def sample_cos_hemisphere(u):
    phi = TWO_PI * u[..., 0]
    tmp = torch.sqrt(torch.clamp(1.0 - u[..., 1], min=AD_EPS))
    z = torch.sqrt(torch.clamp(u[..., 1], min=AD_EPS))
    return torch.stack([torch.cos(phi) * tmp, torch.sin(phi) * tmp, z], -1)


def sample_concentric_disc(u):
    """Concentric square-to-disc mapping."""
    r1 = 2.0 * u[..., 0] - 1.0
    r2 = 2.0 * u[..., 1] - 1.0
    r1_sq_gt = torch.square(r1) > torch.square(r2)
    r = torch.where(r1_sq_gt, r1, r2)
    one = torch.ones_like(r1)
    safe_r1 = torch.where(r1 == 0.0, one, r1)
    safe_r2 = torch.where(r2 == 0.0, one, r2)
    phi = torch.where(r1_sq_gt, PI_OVER_FOUR * (r2 / safe_r1),
                      PI_OVER_TWO - (r1 / safe_r2) * PI_OVER_FOUR)
    zero = (r1 == 0.0) | (r2 == 0.0)
    r = torch.where(zero, torch.zeros_like(r), r)
    phi = torch.where(zero, torch.zeros_like(phi), phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def local_to_world(local_dir, n):
    b0, b1 = coordinate_system(n)
    return (local_dir[..., 0:1] * b0 + local_dir[..., 1:2] * b1
            + local_dir[..., 2:3] * n)


def xform_point(m, p):
    """4x4 homogeneous transform of points [..., 3]."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], -1)
    out = torch.einsum('ij,...j->...i', m, ph)
    return out[..., :3] / out[..., 3:4]


def xform_vector(m, v):
    """The 3x3 part of a 4x4 transform applied to vectors [..., 3]."""
    return torch.einsum('ij,...j->...i', m[:3, :3], v)


def mis_weight_power2(pdf_a, pdf_b):
    ratio_sq = torch.square(pdf_b / pdf_a)
    return 1.0 / (1.0 + ratio_sq)


def mis(pdf):
    """MIS(p) = p^2 with |p| capped at 1e18 so the square and its partial
    stay finite in f32."""
    return torch.square(torch.clamp(pdf, -1e18, 1e18))


def clamp_abs(x, eps=1e-12):
    """Clamp |x| >= eps preserving sign; keeps 1/x and its derivative
    finite in f32."""
    return torch.where(torch.abs(x) < eps,
                       torch.where(x < 0, torch.full_like(x, -eps),
                                   torch.full_like(x, eps)), x)


def safe_div(a, b, eps=0.0):
    """a / b with b == 0 mapped to eps (keeps masked lanes finite)."""
    q = a / torch.where(b == 0.0, torch.ones_like(b), b)
    return torch.where(b == 0.0, torch.full_like(q, eps), q)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b
