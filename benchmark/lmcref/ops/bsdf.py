"""BSDFs: Lambertian, Phong and rough dielectric (Beckmann microfacet)
(port of ops/bsdf.py).

Dispatch keeps the JAX package's evaluate-all-and-select structure: every
material type the scene has is evaluated on every lane and the lane's type
selects (a type no material has is skipped: eager torch pays for each
operation it launches). Every
function takes a per-lane ``MatParams`` with textures already resolved, so
the same code serves wavefront tracing and the frozen differentiable
replay. The grazing cut-offs and the clamps that keep untaken branches'
derivatives finite are kept as the JAX code has them: ``torch.where``
leaks NaN gradients from the branch it does not take as ``jnp.where``
does.
"""

import dataclasses

import torch

from ..utils import vecmath as vm
from ..utils.tree import select_by_type
from ..scene.scenedata import (BSDF_LAMBERTIAN, BSDF_PHONG,
                               BSDF_ROUGH_DIELECTRIC)
from ..scene.textures import eval_texture


@dataclasses.dataclass
class MatParams:
    """Per-lane material parameters with textures resolved."""
    mat_type: torch.Tensor   # [...] int32
    twosided: torch.Tensor   # [...] bool
    kd: torch.Tensor         # [...,3] diffuse / transmittance (Kt)
    ks: torch.Tensor         # [...,3] specular
    exponent: torch.Tensor   # [...]
    ks_weight: torch.Tensor  # [...]
    eta: torch.Tensor        # [...]
    inv_eta: torch.Tensor    # [...]
    alpha: torch.Tensor      # [...]
    # the BSDF types any lane may have (known on the host): evaluate and
    # sample compute only these branches
    types: tuple = (BSDF_LAMBERTIAN, BSDF_PHONG, BSDF_ROUGH_DIELECTRIC)


def gather_mat_params(scene, mat_id, st):
    """Per-lane material parameters, each bound texture evaluated at st.
    A texture slot is evaluated only when some material of the scene binds
    it (scene.tex_slots, known on the host)."""
    m = mat_id.long()
    tex = scene.mat_tex[m]
    kd_on, ks_on, expo_on, alpha_on = scene.tex_slots
    kd = scene.mat_kd[m]
    if kd_on:
        kd = kd * eval_texture(scene.textures, tex[..., 0], st)
    ks = scene.mat_ks[m]
    if ks_on:
        ks = ks * eval_texture(scene.textures, tex[..., 1], st)
    expo = scene.mat_exponent[m]
    if expo_on:
        expo = torch.where(tex[..., 2] >= 0,
                           eval_texture(scene.textures, tex[..., 2],
                                        st)[..., 0], expo)
    alpha = scene.mat_alpha[m]
    if alpha_on:
        alpha = torch.where(tex[..., 3] >= 0,
                            eval_texture(scene.textures, tex[..., 3],
                                         st)[..., 0], alpha)
    return MatParams(mat_type=scene.mat_type[m],
                     twosided=scene.mat_twosided[m], kd=kd, ks=ks,
                     exponent=expo,
                     ks_weight=scene.mat_ks_weight[m], eta=scene.mat_eta[m],
                     inv_eta=scene.mat_inv_eta[m], alpha=alpha,
                     types=scene.mat_types)


def roughness(mp: MatParams):
    """Lambertian and Phong report roughness 1, the rough dielectric its
    alpha."""
    return torch.where(mp.mat_type == BSDF_ROUGH_DIELECTRIC, mp.alpha,
                       torch.ones_like(mp.alpha))


def _flip_normal(mp, wi, normal):
    cos_wi = vm.dot(wi, normal)
    flip = mp.twosided & (cos_wi < 0.0)
    normal_ = torch.where(flip[..., None], -normal, normal)
    cos_wi = torch.where(flip, -cos_wi, cos_wi)
    return normal_, cos_wi


def _zero(x):
    return torch.zeros_like(x)


def beckmann_d(local_h, alpha):
    """Beckmann normal distribution."""
    cos2 = torch.square(local_h[..., 2])
    safe_cos2 = torch.clamp(cos2, min=1e-12)
    expo = (torch.square(local_h[..., 0]) + torch.square(local_h[..., 1])) \
        / torch.clamp(torch.square(alpha), min=1e-12) / safe_cos2
    return torch.exp(-expo) / (vm.PI * torch.square(alpha)
                               * torch.square(safe_cos2))


def beckmann_g1(alpha, cos_theta):
    """Beckmann shadowing-masking, rational fit. The +1e-6 inside the sqrt
    keeps the gradient finite at cos == 1."""
    safe_cos = vm.clamp_abs(cos_theta)
    tan_theta = torch.sqrt(torch.abs(1.0 + 1e-6 - torch.square(cos_theta))) \
        / safe_cos
    a = 1.0 / torch.clamp(alpha * tan_theta, min=1e-12)
    a_sqr = torch.square(a)
    g = (3.535 * a + 2.181 * a_sqr) / (1.0 + 2.276 * a + 2.577 * a_sqr)
    one = torch.ones_like(g)
    g = torch.where(a >= 1.6, one, g)
    return torch.where(tan_theta <= 0.0, one, g)


def beckmann_g(alpha, cos_wi, cos_wo):
    return beckmann_g1(alpha, cos_wi) * beckmann_g1(alpha, cos_wo)


def fresnel_dielectric_ext(cos_i, eta, inv_eta):
    """Dielectric Fresnel; returns (F, cos_theta_t), cos_theta_t negative
    when entering (cos_i > 0) and 0 under total internal reflection."""
    scale = torch.where(cos_i > 0.0, inv_eta, eta)
    cos_t_sqr = 1.0 - (1.0 - torch.square(cos_i)) * torch.square(scale)
    tir = cos_t_sqr <= 0.0
    cos_ia = torch.abs(cos_i)
    cos_t = torch.sqrt(torch.clamp(cos_t_sqr, min=1e-12))
    rs = (cos_ia - eta * cos_t) / (cos_ia + eta * cos_t)
    rp = (eta * cos_ia - cos_t) / (eta * cos_ia + cos_t)
    f = 0.5 * (torch.square(rs) + torch.square(rp))
    f = torch.where(tir, torch.ones_like(f), f)
    cos_theta_t = torch.where(tir, torch.zeros_like(cos_t),
                              torch.where(cos_i > 0.0, -cos_t, cos_t))
    return f, cos_theta_t


def sample_micronormal(u, alpha):
    """Beckmann half-vector sampling. Returns (local_h, pdf_w)."""
    phi_m = vm.TWO_PI * u[..., 1]
    alpha_sqr = torch.square(alpha)
    tan2 = alpha_sqr * (-torch.log(torch.clamp(1.0 - u[..., 0], min=1e-6)))
    cos_m = 1.0 / torch.sqrt(1.0 + tan2)
    cos2_m = torch.square(cos_m)
    pdf = (1.0 - u[..., 0]) / torch.clamp(vm.PI * alpha_sqr * cos_m * cos2_m,
                                          min=1e-12)
    sin_m = torch.sqrt(torch.clamp(1.0 - cos2_m, min=vm.AD_EPS))
    local_h = torch.stack([sin_m * torch.cos(phi_m), sin_m * torch.sin(phi_m),
                           cos_m], -1)
    return local_h, pdf


def _scaled_alpha(alpha, cos):
    """The sampling roughness alpha * (1.2 - 0.2 sqrt|cos|); the sqrt's
    argument is clamped so masked grazing lanes keep a finite slope."""
    return alpha * (1.2 - 0.2 * torch.sqrt(torch.clamp(torch.abs(cos),
                                                       min=1e-6)))


def _sq_or_one(x):
    """x^2, or 1 where x == 0 (a refraction denominator's safe square)."""
    return torch.where(x == 0.0, torch.ones_like(x), torch.square(x))


def _eval_lambertian(mp, wi, normal, wo):
    normal_, cos_wi = _flip_normal(mp, wi, normal)
    cos_wo = vm.dot(normal_, wo)
    ok = (cos_wi >= vm.COS_EPS) & (cos_wo >= vm.COS_EPS)
    fwd = cos_wo * vm.INV_PI
    rev = cos_wi * vm.INV_PI
    contrib = fwd[..., None] * mp.kd
    return (torch.where(ok[..., None], contrib, _zero(contrib)), cos_wo,
            torch.where(ok, fwd, _zero(fwd)), torch.where(ok, rev, _zero(rev)))


def _phong_lobes(mp, cos_wi, cos_wo, alpha):
    """Specular + diffuse Phong value (times cos_wo), pdf and reverse pdf."""
    expo = mp.exponent
    weight = torch.pow(alpha, expo) * vm.INV_TWO_PI
    spec_ok = (mp.ks_weight > 0.0) & (weight > 1e-10)
    spec = mp.ks * ((expo + 2.0) * weight)[..., None]
    contrib = torch.where(spec_ok[..., None], spec, _zero(spec))
    pdf_s = mp.ks_weight * (expo + 1.0) * weight
    pdf = torch.where(spec_ok, pdf_s, _zero(pdf_s))
    rev_pdf = pdf
    diff = mp.ks_weight < 1.0
    pd = (1.0 - mp.ks_weight) * cos_wo * vm.INV_PI
    pdf = pdf + torch.where(diff, pd, _zero(pd))
    rd = (1.0 - mp.ks_weight) * cos_wi * vm.INV_PI
    rev_pdf = rev_pdf + torch.where(diff, rd, _zero(rd))
    cd = mp.kd * vm.INV_PI
    contrib = contrib + torch.where(diff[..., None], cd, _zero(cd))
    contrib = contrib * cos_wo[..., None]
    return contrib, pdf, rev_pdf


def _eval_phong(mp, wi, normal, wo):
    normal_, cos_wi = _flip_normal(mp, wi, normal)
    cos_wo = vm.dot(normal_, wo)
    ok = (cos_wi > vm.COS_EPS) & (cos_wo > vm.COS_EPS)
    alpha = torch.clamp(vm.dot(vm.reflect(wi, normal_), wo), min=1e-12)
    contrib, pdf, rev_pdf = _phong_lobes(mp, cos_wi, cos_wo, alpha)
    small = torch.amax(contrib, -1) < 1e-10
    contrib = torch.where((ok & ~small)[..., None], contrib, _zero(contrib))
    return (contrib, cos_wo, torch.where(ok, pdf, _zero(pdf)),
            torch.where(ok, rev_pdf, _zero(rev_pdf)))


def _eval_rough_dielectric(mp, wi, normal, wo, adjoint):
    cos_wi = vm.dot(wi, normal)
    cos_wo = vm.dot(wo, normal)
    ok = (torch.abs(cos_wi) >= vm.COS_EPS) & (torch.abs(cos_wo) >= vm.COS_EPS)
    reflect = cos_wi * cos_wo > 0.0
    eta_ = torch.where(cos_wi > 0.0, mp.eta, mp.inv_eta)
    rev_eta = torch.where(cos_wo > 0.0, mp.eta, mp.inv_eta)
    h = torch.where(reflect[..., None], wi + wo, wi + wo * eta_[..., None])
    h = vm.normalize(h)
    h = torch.where(vm.dot(h, normal)[..., None] < 0.0, -h, h)

    cos_h_wi = vm.dot(wi, h)
    cos_h_wo = vm.dot(wo, h)
    ok = ok & (torch.abs(cos_h_wi) >= vm.COS_EPS) \
        & (torch.abs(cos_h_wo) >= vm.COS_EPS)
    ok = ok & (cos_h_wi * cos_wi > 0.0) & (cos_h_wo * cos_wo > 0.0)

    b0, b1 = vm.coordinate_system(normal)
    local_h = torch.stack([vm.dot(b0, h), vm.dot(b1, h), vm.dot(normal, h)],
                          -1)
    alp = mp.alpha
    d = beckmann_d(local_h, alp)
    ok = ok & (d > 0.0)

    rev_cos_h_wi = cos_h_wo
    rev_cos_h_wo = cos_h_wi
    f, _ = fresnel_dielectric_ext(cos_h_wi, mp.eta, mp.inv_eta)
    a_cos_wi = torch.abs(cos_wi)
    a_cos_wo = torch.abs(cos_wo)
    g = beckmann_g(alp, a_cos_wi, a_cos_wo)
    prob = local_h[..., 2] * beckmann_d(local_h, _scaled_alpha(alp, a_cos_wi))
    ok = ok & (prob >= 1e-12)
    rev_prob = local_h[..., 2] * beckmann_d(local_h,
                                            _scaled_alpha(alp, a_cos_wo))

    safe_cos_wi = vm.clamp_abs(cos_wi)
    # reflection
    scalar_r = torch.abs(f * d * g / (4.0 * safe_cos_wi))
    contrib_r = mp.ks * scalar_r[..., None]
    pdf_r = torch.abs(prob * f / (4.0 * vm.clamp_abs(cos_h_wo)))
    rev_pdf_r = torch.abs(rev_prob * f / (4.0 * vm.clamp_abs(rev_cos_h_wo)))
    # refraction
    sqrt_denom = cos_h_wi + eta_ * cos_h_wo
    rev_sqrt_denom = rev_cos_h_wi + rev_eta * rev_cos_h_wo
    factor = torch.ones_like(eta_) if adjoint else torch.square(1.0 / eta_)
    safe_sq = _sq_or_one(sqrt_denom)
    scalar_t = torch.abs(factor * ((1.0 - f) * d * g * torch.square(eta_)
                                   * cos_h_wi * cos_h_wo)
                         / (safe_cos_wi * safe_sq))
    contrib_t = mp.kd * scalar_t[..., None]
    pdf_t = torch.abs(prob * (1.0 - f) * (torch.square(eta_) * cos_h_wo)
                      / safe_sq)
    rev_pdf_t = torch.abs(rev_prob * (1.0 - f)
                          * (torch.square(rev_eta) * rev_cos_h_wo)
                          / _sq_or_one(rev_sqrt_denom))

    contrib = torch.where(reflect[..., None], contrib_r, contrib_t)
    pdf = torch.where(reflect, pdf_r, pdf_t)
    rev_pdf = torch.where(reflect, rev_pdf_r, rev_pdf_t)
    return (torch.where(ok[..., None], contrib, _zero(contrib)), cos_wo,
            torch.where(ok, pdf, _zero(pdf)),
            torch.where(ok, rev_pdf, _zero(rev_pdf)))


def evaluate(mp: MatParams, wi, normal, wo, adjoint=False):
    """Returns (contrib incl. |cos wo|, cos_wo, pdf, rev_pdf)."""
    fns = {BSDF_LAMBERTIAN: lambda: _eval_lambertian(mp, wi, normal, wo),
           BSDF_PHONG: lambda: _eval_phong(mp, wi, normal, wo),
           BSDF_ROUGH_DIELECTRIC: lambda: _eval_rough_dielectric(
               mp, wi, normal, wo, adjoint)}
    return select_by_type(mp.mat_type, [(t, fns[t]()) for t in mp.types])


def _sample_lambertian(mp, wi, normal, u):
    cos_wi_raw = vm.dot(wi, normal)
    valid = torch.abs(cos_wi_raw) >= vm.COS_EPS
    neg = cos_wi_raw < 0.0
    valid &= (~neg) | mp.twosided
    normal_ = torch.where((mp.twosided & neg)[..., None], -normal, normal)
    cos_wi = torch.abs(cos_wi_raw)
    local = vm.sample_cos_hemisphere(u)
    wo = vm.local_to_world(local, normal_)
    cos_wo = local[..., 2]
    pdf = cos_wo * vm.INV_PI
    valid &= cos_wo >= vm.COS_EPS
    rev_pdf = cos_wi * vm.INV_PI
    return wo, mp.kd, cos_wo, pdf, rev_pdf, valid


def _sample_phong(mp, wi, normal, u):
    """rndParam[0] doubles as the lobe selector and (rescaled) phi."""
    cos_wi_raw = vm.dot(wi, normal)
    valid = torch.abs(cos_wi_raw) >= vm.COS_EPS
    neg = cos_wi_raw < 0.0
    valid &= (~neg) | mp.twosided
    normal_ = torch.where((mp.twosided & neg)[..., None], -normal, normal)
    cos_wi = torch.abs(cos_wi_raw)

    expo = mp.exponent
    r = vm.reflect(wi, normal_)
    u0 = u[..., 0]
    spec = u0 <= mp.ks_weight
    g = torch.where(spec, expo, torch.ones_like(expo))
    n_axis = torch.where(spec[..., None], r, normal_)
    rnd0 = torch.where(spec, u0 / (mp.ks_weight + 1e-10),
                       (u0 - mp.ks_weight) / (1.0 - mp.ks_weight + 1e-10))
    power = 1.0 / (g + 1.0)
    cos_alpha = torch.pow(torch.clamp(u[..., 1], min=1e-10), power)
    sin_alpha = torch.sqrt(torch.clamp(1.0 - torch.square(cos_alpha), min=0.0))
    phi = vm.TWO_PI * rnd0
    local_dir = torch.stack([sin_alpha * torch.cos(phi),
                             sin_alpha * torch.sin(phi), cos_alpha], -1)
    wo = vm.local_to_world(local_dir, n_axis)
    cos_wo = vm.dot(normal_, wo)
    valid &= cos_wo >= vm.COS_EPS

    alpha_spec = torch.clamp(vm.dot(r, wo), min=1e-12)
    contrib, pdf, rev_pdf = _phong_lobes(mp, cos_wi, cos_wo, alpha_spec)
    valid &= pdf >= 1e-10
    contrib = contrib / torch.clamp(pdf, min=1e-10)[..., None]
    return wo, contrib, cos_wo, pdf, rev_pdf, valid


def _sample_rough_dielectric(mp, wi, normal, u, u_disc, adjoint):
    cos_wi = vm.dot(wi, normal)
    valid = torch.abs(cos_wi) >= vm.COS_EPS
    alp = mp.alpha
    local_h, m_pdf = sample_micronormal(u, _scaled_alpha(alp, cos_wi))
    h = vm.local_to_world(local_h, normal)
    cos_h_wi = vm.dot(wi, h)
    valid = valid & (torch.abs(cos_h_wi) >= vm.COS_EPS)
    f, cos_theta_t = fresnel_dielectric_ext(cos_h_wi, mp.eta, mp.inv_eta)
    do_reflect = u_disc <= f

    # reflection
    wo_r = vm.reflect(wi, h)
    ok_r = (f > 0.0) & (vm.dot(normal, wo_r) * vm.dot(normal, wi) > 0.0)
    cos_h_wo_r = vm.dot(wo_r, h)
    pdf_r = torch.abs(m_pdf * f / (4.0 * vm.clamp_abs(cos_h_wo_r)))
    cos_wo_r = vm.dot(wo_r, normal)
    ok_r = ok_r & (torch.abs(cos_wo_r) >= vm.COS_EPS)
    rev_d_r = beckmann_d(local_h, _scaled_alpha(alp, cos_wo_r))
    rev_pdf_r = torch.abs(f * rev_d_r * local_h[..., 2]
                          / (4.0 * vm.clamp_abs(cos_h_wi)))
    refl_r = mp.ks

    # refraction
    wo_t = vm.refract(wi, h, cos_theta_t, mp.eta, mp.inv_eta)
    ok_t = (f < 1.0) & (cos_theta_t != 0.0) \
        & (vm.dot(normal, wo_t) * vm.dot(normal, wi) < 0.0)
    eta_ = torch.where(cos_wi > 0.0, mp.eta, mp.inv_eta)
    factor = torch.ones_like(eta_) if adjoint else torch.square(1.0 / eta_)
    refl_t = mp.kd * factor[..., None]
    cos_h_wo_t = vm.dot(wo_t, h)
    sqrt_denom = cos_h_wi + eta_ * cos_h_wo_t
    dwh_dwo = (torch.square(eta_) * cos_h_wo_t) / _sq_or_one(sqrt_denom)
    pdf_t = torch.abs(m_pdf * (1.0 - f) * torch.abs(dwh_dwo))
    cos_wo_t = vm.dot(wo_t, normal)
    ok_t = ok_t & (torch.abs(cos_wo_t) >= vm.COS_EPS)
    rev_eta = torch.where(cos_wo_t > 0.0, mp.eta, mp.inv_eta)
    rev_sqrt_denom = cos_h_wo_t + rev_eta * cos_h_wi
    rev_dwh_dwo = (torch.square(rev_eta) * cos_h_wi) \
        / _sq_or_one(rev_sqrt_denom)
    rev_d_t = beckmann_d(local_h, _scaled_alpha(alp, cos_wo_t))
    rev_pdf_t = torch.abs((1.0 - f) * rev_d_t * local_h[..., 2] * rev_dwh_dwo)

    dr = do_reflect[..., None]
    wo = torch.where(dr, wo_r, wo_t)
    refl = torch.where(dr, refl_r, refl_t)
    pdf = torch.where(do_reflect, pdf_r, pdf_t)
    rev_pdf = torch.where(do_reflect, rev_pdf_r, rev_pdf_t)
    cos_wo = torch.where(do_reflect, cos_wo_r, cos_wo_t)
    cos_h_wo = torch.where(do_reflect, cos_h_wo_r, cos_h_wo_t)
    valid = valid & torch.where(do_reflect, ok_r, ok_t)
    valid = valid & (torch.abs(cos_h_wo) >= vm.COS_EPS)
    valid = valid & (pdf >= 1e-12)
    valid = valid & (cos_h_wi * cos_wi > 0.0) & (cos_h_wo * cos_wo > 0.0)

    d = beckmann_d(local_h, alp)
    g = beckmann_g(alp, torch.abs(cos_wi), torch.abs(cos_wo))
    numerator = d * g * cos_h_wi
    denominator = m_pdf * torch.abs(cos_wi)
    contrib = refl * torch.abs(numerator
                               / vm.clamp_abs(denominator))[..., None]
    return wo, contrib, cos_wo, pdf, rev_pdf, valid


def sample(mp: MatParams, wi, normal, u, u_disc, adjoint=False):
    """Returns (wo, contrib = f/pdf incl. cos, cos_wo, pdf, rev_pdf, valid)."""
    fns = {BSDF_LAMBERTIAN: lambda: _sample_lambertian(mp, wi, normal, u),
           BSDF_PHONG: lambda: _sample_phong(mp, wi, normal, u),
           BSDF_ROUGH_DIELECTRIC: lambda: _sample_rough_dielectric(
               mp, wi, normal, u, u_disc, adjoint)}
    return select_by_type(mp.mat_type, [(t, fns[t]()) for t in mp.types])
