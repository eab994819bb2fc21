"""Microfacet distributions + glossy material assemblies.

Functional port-free re-design of the reference microfacet layer
(/root/reference/core/MicroFacet.{h,cpp}): Trowbridge-Reitz (GGX) and
Beckmann D / Smith Lambda / G, visible-normal sampling (the reference
defaults sampleVisibleArea=true), RoughnessToAlpha remap
(MicroFacet.h:97-103), and the glossy material assemblies Metal / Plastic /
rough Glass (materials/{MetalMaterial,PlasticMaterial,GlassMaterial}.cpp)
as batched masked dispatch.  All parameters differentiable; directions
sampled detached.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import PI
from ..scene.scene import MAT_DISNEY, MAT_GLASS, MAT_METAL, MAT_PLASTIC
from ..utils.math import (
    abs_cos_theta, cos2_phi, cos_phi, cos_theta, normalize, reflect, refract,
    same_hemisphere, sin2_phi, sin_phi, tan2_theta, tan_theta,
)
from . import bxdf
from .materials import _g

TROWBRIDGE = 0
BECKMANN = 1


def roughness_to_alpha(roughness):
    """MicroFacet.h:97-103 log-poly remap."""
    r = jnp.maximum(roughness, 1e-3)
    x = jnp.log(r)
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3 + 0.000640711 * x ** 4


# ---------------------------------------------------------------------------
# Trowbridge-Reitz (GGX)
# ---------------------------------------------------------------------------

# NOTE on the double-where pattern below: a degenerate lane (grazing wh,
# zero wi, below-horizon wo) must not merely mask its *value* to 0 — if the
# unselected branch's primal is inf/NaN, the VJP of jnp.where propagates
# NaN into parameter gradients (0 * inf).  So the degenerate operand is
# sanitized BEFORE the arithmetic, and the result masked after.

def tr_d(wh, ax, ay):
    """GGX anisotropic D (MicroFacet.cpp TrowbridgeReitzDistribution::D)."""
    t2 = tan2_theta(wh)
    c2 = cos_theta(wh) ** 2
    c4 = c2 * c2
    ok = jnp.isfinite(t2) & (c4 > 1e-16)
    t2s = jnp.where(ok, t2, 0.0)
    c4s = jnp.where(ok, c4, 1.0)
    e = (cos2_phi(wh) / (ax * ax) + sin2_phi(wh) / (ay * ay)) * t2s
    d = 1.0 / (PI * ax * ay * c4s * (1.0 + e) ** 2)
    return jnp.where(ok, d, 0.0)


def tr_lambda(w, ax, ay):
    abs_tan = jnp.abs(tan_theta(w))
    ok = jnp.isfinite(abs_tan)
    at = jnp.where(ok, abs_tan, 0.0)
    # clamp: a zero-vector lane has cos2_phi == sin2_phi == 0 and sqrt(0)
    # has an infinite derivative w.r.t. ax/ay
    alpha = jnp.sqrt(jnp.maximum(
        cos2_phi(w) * ax * ax + sin2_phi(w) * ay * ay, 1e-12))
    a2t2 = (alpha * at) ** 2
    lam = (-1.0 + jnp.sqrt(1.0 + a2t2)) / 2.0
    return jnp.where(ok, lam, 0.0)


def beckmann_d(wh, ax, ay):
    t2 = tan2_theta(wh)
    c2 = cos_theta(wh) ** 2
    c4 = c2 * c2
    ok = jnp.isfinite(t2) & (c4 > 1e-16)
    t2s = jnp.where(ok, t2, 0.0)
    c4s = jnp.where(ok, c4, 1.0)
    d = jnp.exp(-t2s * (cos2_phi(wh) / (ax * ax) + sin2_phi(wh) / (ay * ay))) / (
        PI * ax * ay * c4s
    )
    return jnp.where(ok, d, 0.0)


def beckmann_lambda(w, ax, ay):
    abs_tan = jnp.abs(tan_theta(w))
    ok = jnp.isfinite(abs_tan)
    at = jnp.where(ok, abs_tan, 1.0)
    alpha = jnp.sqrt(jnp.maximum(
        cos2_phi(w) * ax * ax + sin2_phi(w) * ay * ay, 1e-12))
    a = 1.0 / jnp.maximum(alpha * at, 1e-8)
    a_s = jnp.minimum(a, 1.6)  # branch-sanitized: >=1.6 lanes return 0
    lam = jnp.where(
        a >= 1.6, 0.0,
        (1.0 - 1.259 * a_s + 0.396 * a_s * a_s)
        / (3.535 * a_s + 2.181 * a_s * a_s),
    )
    return jnp.where(ok, lam, 0.0)


def mf_g1(lam):
    return 1.0 / (1.0 + lam)


def mf_g(lam_o, lam_i):
    return 1.0 / (1.0 + lam_o + lam_i)


def mf_pdf_visible(w, wh, d_val, lam_w):
    """pdf for visible-normal sampling: D * G1(w) * |w.wh| / |cos w|."""
    g1 = mf_g1(lam_w)
    cos_w = abs_cos_theta(w)
    return d_val * g1 * jnp.abs(jnp.sum(w * wh, -1)) / jnp.maximum(cos_w, 1e-8)


def tr_sample_wh(wo, u, ax, ay):
    """GGX visible-normal sampling (Heitz 2018 ellipsoid method — same
    distribution the reference samples via TrowbridgeReitzSample)."""
    flip = wo[..., 2] < 0
    w = jnp.where(flip[..., None], -wo, wo)
    # stretch
    vh = normalize(jnp.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    # orthonormal basis around vh
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = jnp.where(
        (lensq > 1e-12)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(lensq)], -1)
        / jnp.sqrt(jnp.maximum(lensq, 1e-12))[..., None],
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), vh.shape),
    )
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(u[..., 0])
    phi = 2.0 * PI * u[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    # unstretch
    wh = normalize(
        jnp.stack([ax * nh[..., 0], ay * nh[..., 1], jnp.maximum(1e-6, nh[..., 2])], -1)
    )
    return jnp.where(flip[..., None], -wh, wh)


def beckmann_sample_wh(wo, u, ax, ay):
    """Beckmann visible-normal sampling (MicroFacet.cpp:92-113
    BeckmannSample: stretch -> sample P22 slopes -> rotate -> unstretch).

    The slope CDF inversion (BeckmannSample11, MicroFacet.cpp:11-90) is a
    10-step Newton/bisection hybrid in the erf domain; here all lanes run
    the fixed 10 iterations with where-masked interval updates — same
    math, lockstep across the wavefront.
    """
    from jax.scipy.special import erf, erfinv

    flip = wo[..., 2] < 0
    w = jnp.where(flip[..., None], -wo, wo)
    # 1. stretch
    ws = normalize(jnp.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    ci = jnp.clip(ws[..., 2], -1.0, 1.0)
    u1 = jnp.maximum(u[..., 0], 1e-6)
    u2 = u[..., 1]

    # normal-incidence special case (cosTheta > .9999)
    r_ni = jnp.sqrt(-jnp.log(jnp.maximum(1.0 - u1, 1e-12)))
    sx_ni = r_ni * jnp.cos(2.0 * PI * u2)
    sy_ni = r_ni * jnp.sin(2.0 * PI * u2)

    # general case: numerical inversion in the erf domain
    ci_safe = jnp.maximum(jnp.abs(ci), 1e-4)
    si = jnp.sqrt(jnp.maximum(0.0, 1.0 - ci_safe * ci_safe))
    tan_ti = si / ci_safe
    cot_ti = 1.0 / jnp.maximum(tan_ti, 1e-12)
    sqrt_pi_inv = 1.0 / jnp.sqrt(PI)
    a = jnp.full_like(u1, -1.0)
    c = erf(cot_ti)
    theta_i = jnp.arccos(jnp.clip(ci_safe, -1.0, 1.0))
    fit = 1.0 + theta_i * (-0.876 + theta_i * (0.4265 - 0.0594 * theta_i))
    b = c - (1.0 + c) * jnp.power(jnp.maximum(1.0 - u1, 1e-12), fit)
    norm = 1.0 / (1.0 + c + sqrt_pi_inv * tan_ti * jnp.exp(-cot_ti * cot_ti))

    def newton(_, carry):
        a, b, c = carry
        b = jnp.where((b >= a) & (b <= c), b, 0.5 * (a + c))
        inv_erf = erfinv(jnp.clip(b, -1.0 + 1e-6, 1.0 - 1e-6))
        value = norm * (
            1.0 + b + sqrt_pi_inv * tan_ti * jnp.exp(-inv_erf * inv_erf)
        ) - u1
        deriv = norm * (1.0 - inv_erf * tan_ti)
        c = jnp.where(value > 0, b, c)
        a = jnp.where(value > 0, a, b)
        b = b - value / jnp.where(jnp.abs(deriv) < 1e-12,
                                  jnp.where(deriv < 0, -1e-12, 1e-12), deriv)
        return a, b, c

    _, b, _ = jax.lax.fori_loop(0, 10, newton, (a, b, c))
    sx_g = erfinv(jnp.clip(b, -1.0 + 1e-6, 1.0 - 1e-6))
    sy_g = erfinv(jnp.clip(2.0 * jnp.maximum(u2, 1e-6) - 1.0,
                           -1.0 + 1e-6, 1.0 - 1e-6))

    ni = ci > 0.9999
    slope_x = jnp.where(ni, sx_ni, sx_g)
    slope_y = jnp.where(ni, sy_ni, sy_g)

    # 3. rotate by phi of the stretched direction
    cphi = cos_phi(ws)
    sphi = sin_phi(ws)
    tmp = cphi * slope_x - sphi * slope_y
    slope_y = sphi * slope_x + cphi * slope_y
    slope_x = tmp
    # 4. unstretch; 5. normal
    wh = normalize(
        jnp.stack([-ax * slope_x, -ay * slope_y, jnp.ones_like(slope_x)], -1)
    )
    return jnp.where(flip[..., None], -wh, wh)


# ---------------------------------------------------------------------------
# FresnelBlend (Ashikhmin-Shirley, Reflection.h:446, Reflection.cpp:291-344)
# ---------------------------------------------------------------------------

def fresnel_blend_f(wo, wi, rd, rs, ax, ay):
    """FresnelBlend::f: coupled diffuse + Schlick-Fresnel microfacet gloss."""
    def pow5(v):
        return (v * v) * (v * v) * v

    aci = abs_cos_theta(wi)
    aco = abs_cos_theta(wo)
    diffuse = (
        (28.0 / (23.0 * PI)) * rd * (1.0 - rs)
        * (1.0 - pow5(1.0 - 0.5 * aci))[..., None]
        * (1.0 - pow5(1.0 - 0.5 * aco))[..., None]
    )
    wh = wi + wo
    degenerate = jnp.sum(wh * wh, -1) < 1e-16
    wh_n = normalize(wh, eps=1e-20)
    d = tr_d(wh_n, ax, ay)
    dot_ih = jnp.sum(wi * wh_n, -1)
    schlick = rs + pow5(1.0 - jnp.clip(dot_ih, 0.0, 1.0))[..., None] * (1.0 - rs)
    denom = 4.0 * jnp.abs(dot_ih) * jnp.maximum(aci, aco)
    specular = (d / jnp.maximum(denom, 1e-8))[..., None] * schlick
    out = diffuse + jnp.where(degenerate[..., None], 0.0, specular)
    same = same_hemisphere(wo, wi)
    return jnp.where(same[..., None], out, 0.0)


def fresnel_blend_pdf(wo, wi, ax, ay):
    """FresnelBlend::Pdf (Reflection.cpp:338): average of cosine and wh pdfs."""
    wh = normalize(wo + wi, eps=1e-20)
    d = tr_d(wh, ax, ay)
    pdf_wh = mf_pdf_visible(wo, wh, d, tr_lambda(wo, ax, ay))
    pdf = 0.5 * (
        abs_cos_theta(wi) / PI
        + pdf_wh / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * wh, -1)), 1e-8)
    )
    return jnp.where(same_hemisphere(wo, wi), pdf, 0.0)


def fresnel_blend_sample(wo, u2, uc, rd, rs, ax, ay):
    """FresnelBlend::Sample_f (Reflection.cpp:316): uc<.5 cosine-samples the
    hemisphere, else samples wh and reflects; pdf/f from the full mixture.
    Returns (wi, f, pdf, valid)."""
    pick_diffuse = uc < 0.5
    wi_d = bxdf.diffuse_sample_wi(wo, u2)
    wh = tr_sample_wh(wo, u2, ax, ay)
    wi_s = reflect(wo, wh)
    wi = jax.lax.stop_gradient(jnp.where(pick_diffuse[..., None], wi_d, wi_s))
    same = same_hemisphere(wo, wi)
    f = fresnel_blend_f(wo, wi, rd, rs, ax, ay)
    pdf = fresnel_blend_pdf(wo, wi, ax, ay)
    valid = same & (pdf > 0)
    return wi, f, pdf, valid


# ---------------------------------------------------------------------------
# Lobe assemblies
# ---------------------------------------------------------------------------

def _alphas(mats, mid):
    ru = _g(mats.rough_u, mid)
    rv = _g(mats.rough_v, mid)
    remap = _g(mats.remap_rough, mid) > 0.5
    ax = jnp.where(remap, roughness_to_alpha(ru), jnp.maximum(ru, 1e-3))
    ay = jnp.where(remap, roughness_to_alpha(rv), jnp.maximum(rv, 1e-3))
    return ax, ay


def microfacet_reflection_f(wo, wi, ax, ay, fresnel_fn, scale):
    """MicrofacetReflection::f (Reflection.cpp:227): D G F / (4 cos cos)."""
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh = wo + wi
    degenerate = (co < 1e-8) | (ci < 1e-8) | (jnp.sum(wh * wh, -1) < 1e-16)
    wh_n = normalize(wh, eps=1e-20)
    d = tr_d(wh_n, ax, ay)
    g = mf_g(tr_lambda(wo, ax, ay), tr_lambda(wi, ax, ay))
    # Fresnel at wh.wi with wh in the upper hemisphere (faceforward)
    wh_f = jnp.where((wh_n[..., 2] < 0)[..., None], -wh_n, wh_n)
    fr = fresnel_fn(jnp.sum(wi * wh_f, -1))
    f = scale * fr * (d * g / jnp.maximum(4.0 * co * ci, 1e-8))[..., None]
    same = same_hemisphere(wo, wi)
    return jnp.where((degenerate | ~same)[..., None], 0.0, f)


def microfacet_reflection_pdf(wo, wi, ax, ay):
    wh = normalize(wo + wi, eps=1e-20)
    d = tr_d(wh, ax, ay)
    pdf_wh = mf_pdf_visible(wo, wh, d, tr_lambda(wo, ax, ay))
    pdf = pdf_wh / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * wh, -1)), 1e-8)
    return jnp.where(same_hemisphere(wo, wi), pdf, 0.0)


def microfacet_transmission_f(wo, wi, ax, ay, eta_a, eta_b, kt):
    """MicrofacetTransmission::f (Reflection.cpp): GGX refraction lobe."""
    same = same_hemisphere(wo, wi)
    co = cos_theta(wo)
    ci = cos_theta(wi)
    eta = jnp.where(co > 0, eta_b / eta_a, eta_a / eta_b)
    wh = normalize(wo + wi * eta[..., None], eps=1e-20)
    wh = jnp.where((wh[..., 2] < 0)[..., None], -wh, wh)
    wo_dot = jnp.sum(wo * wh, -1)
    wi_dot = jnp.sum(wi * wh, -1)
    same_side = wo_dot * wi_dot > 0  # reject same-side (reference check)
    fr = bxdf.fr_dielectric(wo_dot, eta_a, eta_b)
    d = tr_d(wh, ax, ay)
    g = mf_g(tr_lambda(wo, ax, ay), tr_lambda(wi, ax, ay))
    denom = (wo_dot + eta * wi_dot) ** 2
    factor = 1.0 / eta  # radiance transport
    val = (
        (1.0 - fr)
        * jnp.abs(
            d * g * eta * eta * jnp.abs(wi_dot) * jnp.abs(wo_dot) * factor * factor
            / jnp.maximum(ci * co * denom, 1e-10)
        )
    )
    bad = same | (co == 0) | (ci == 0) | same_side
    return jnp.where(bad[..., None], 0.0, kt * val[..., None])


def microfacet_transmission_pdf(wo, wi, ax, ay, eta_a, eta_b):
    same = same_hemisphere(wo, wi)
    eta = jnp.where(cos_theta(wo) > 0, eta_b / eta_a, eta_a / eta_b)
    wh = normalize(wo + wi * eta[..., None], eps=1e-20)
    wo_dot = jnp.sum(wo * wh, -1)
    wi_dot = jnp.sum(wi * wh, -1)
    same_side = wo_dot * wi_dot > 0
    sqrt_denom = wo_dot + eta * wi_dot
    dwh_dwi = jnp.abs(eta * eta * wi_dot) / jnp.maximum(sqrt_denom * sqrt_denom, 1e-10)
    d = tr_d(jnp.where((wh[..., 2] < 0)[..., None], -wh, wh), ax, ay)
    pdf_wh = mf_pdf_visible(wo, wh, d, tr_lambda(wo, ax, ay))
    return jnp.where(same | same_side, 0.0, pdf_wh * dwh_dwi)


# ---------------------------------------------------------------------------
# Dispatch: evaluate / sample over glossy material kinds
# ---------------------------------------------------------------------------

def evaluate_glossy(mats, mid, cfg, wo, wi, kd_override=None):
    """(f, pdf, handled_mask) for METAL / PLASTIC / rough GLASS / DISNEY."""
    kind = _g(mats.kind, mid)
    n = kind.shape[0]
    f = jnp.zeros((n, 3), jnp.float32)
    pdf = jnp.zeros((n,), jnp.float32)
    handled = jnp.zeros((n,), bool)
    ax, ay = _alphas(mats, mid)

    if MAT_METAL in cfg.mat_kinds:
        m = kind == MAT_METAL
        eta3 = _g(mats.eta3, mid)
        k3 = _g(mats.k3, mid)
        fres = lambda c: bxdf.fr_conductor(c, jnp.ones_like(eta3), eta3, k3)
        f_m = microfacet_reflection_f(wo, wi, ax, ay, fres, jnp.ones((n, 3)))
        p_m = microfacet_reflection_pdf(wo, wi, ax, ay)
        f = jnp.where(m[..., None], f_m, f)
        pdf = jnp.where(m, p_m, pdf)
        handled = handled | m

    if MAT_PLASTIC in cfg.mat_kinds:
        # PlasticMaterial (PlasticMaterial.cpp:15): Lambertian kd + GGX ks
        # with dielectric Fresnel 1.5; BSDF::f sums lobes, pdf averages.
        m = kind == MAT_PLASTIC
        kd = kd_override if kd_override is not None else _g(mats.kd, mid)
        ks = _g(mats.ks, mid)
        fres = lambda c: bxdf.fr_dielectric(c, 1.5, 1.0)[..., None]
        f_spec = microfacet_reflection_f(wo, wi, ax, ay, fres, ks)
        f_diff = bxdf.lambert_f(wo, wi, kd)
        p_spec = microfacet_reflection_pdf(wo, wi, ax, ay)
        p_diff = bxdf.lambert_pdf(wo, wi)
        f = jnp.where(m[..., None], f_spec + f_diff, f)
        pdf = jnp.where(m, 0.5 * (p_spec + p_diff), pdf)
        handled = handled | m

    if MAT_GLASS in cfg.mat_kinds:
        # rough glass only (smooth handled as specular in materials.py)
        rough = (_g(mats.rough_u, mid) > 0) | (
            _g(mats.rough_v, mid) > 0
        )
        m = (kind == MAT_GLASS) & rough
        kr = _g(mats.kr, mid)
        kt = _g(mats.kt, mid)
        eta_b = _g(mats.eta, mid)
        fres = lambda c: bxdf.fr_dielectric(c, 1.0, eta_b)[..., None]
        f_r = microfacet_reflection_f(wo, wi, ax, ay, fres, kr)
        f_t = microfacet_transmission_f(wo, wi, ax, ay, jnp.ones_like(eta_b), eta_b, kt)
        p_r = microfacet_reflection_pdf(wo, wi, ax, ay)
        p_t = microfacet_transmission_pdf(wo, wi, ax, ay, jnp.ones_like(eta_b), eta_b)
        same = same_hemisphere(wo, wi)
        f_m = jnp.where(same[..., None], f_r, f_t)
        p_m = 0.5 * (p_r + p_t)
        f = jnp.where(m[..., None], f_m, f)
        pdf = jnp.where(m, p_m, pdf)
        handled = handled | m

    if MAT_DISNEY in cfg.mat_kinds:
        from . import disney

        f_d, p_d, m = disney.evaluate(mats, mid, cfg, wo, wi, kd_override)
        f = jnp.where(m[..., None], f_d, f)
        pdf = jnp.where(m, p_d, pdf)
        handled = handled | m

    return f, pdf, handled


def sample_glossy(mats, mid, cfg, wo, u2, uc, kd_override=None):
    """BsdfSample for glossy kinds; returns (sample, handled_mask)."""
    from .materials import BsdfSample

    kind = _g(mats.kind, mid)
    n = kind.shape[0]
    ax, ay = _alphas(mats, mid)
    wi = jnp.zeros((n, 3), jnp.float32)
    weight = jnp.zeros((n, 3), jnp.float32)
    pdf = jnp.zeros((n,), jnp.float32)
    f_out = jnp.zeros((n, 3), jnp.float32)
    spec = jnp.zeros((n,), bool)
    trans = jnp.zeros((n,), bool)
    eta_out = jnp.ones((n,), jnp.float32)
    valid = jnp.zeros((n,), bool)
    handled = jnp.zeros((n,), bool)

    def finish(m, wi_m, f_m, p_m, is_trans=None):
        nonlocal wi, weight, pdf, f_out, valid, handled, trans
        ok = (p_m > 0) & (abs_cos_theta(wi_m) > 1e-8)
        w_m = f_m * (
            abs_cos_theta(wi_m) / jnp.maximum(jax.lax.stop_gradient(p_m), 1e-12)
        )[..., None]
        wi = jnp.where(m[..., None], wi_m, wi)
        weight = jnp.where(m[..., None], w_m, weight)
        pdf = jnp.where(m, p_m, pdf)
        f_out = jnp.where(m[..., None], f_m, f_out)
        valid = valid | (m & ok)
        handled = handled | m
        if is_trans is not None:
            trans = trans | (m & is_trans)

    if MAT_METAL in cfg.mat_kinds:
        m = kind == MAT_METAL
        wh = tr_sample_wh(wo, u2, ax, ay)
        wi_m = jax.lax.stop_gradient(reflect(wo, wh))
        eta3 = _g(mats.eta3, mid)
        k3 = _g(mats.k3, mid)
        fres = lambda c: bxdf.fr_conductor(c, jnp.ones_like(eta3), eta3, k3)
        f_m = microfacet_reflection_f(wo, wi_m, ax, ay, fres, jnp.ones((n, 3)))
        p_m = microfacet_reflection_pdf(wo, wi_m, ax, ay)
        finish(m, wi_m, f_m, p_m)

    if MAT_PLASTIC in cfg.mat_kinds:
        m = kind == MAT_PLASTIC
        kd = kd_override if kd_override is not None else _g(mats.kd, mid)
        ks = _g(mats.ks, mid)
        pick_spec = uc < 0.5
        # remap uc-half to full for wh sample (lobe select remap,
        # Reflection.cpp:482-490)
        wh = tr_sample_wh(wo, u2, ax, ay)
        wi_spec = reflect(wo, wh)
        wi_diff = bxdf.diffuse_sample_wi(wo, u2)
        wi_m = jax.lax.stop_gradient(jnp.where(pick_spec[..., None], wi_spec, wi_diff))
        fres = lambda c: bxdf.fr_dielectric(c, 1.5, 1.0)[..., None]
        f_m = microfacet_reflection_f(wo, wi_m, ax, ay, fres, ks) + bxdf.lambert_f(
            wo, wi_m, kd
        )
        p_m = 0.5 * (
            microfacet_reflection_pdf(wo, wi_m, ax, ay) + bxdf.lambert_pdf(wo, wi_m)
        )
        finish(m, wi_m, f_m, p_m)

    if MAT_GLASS in cfg.mat_kinds:
        rough = (_g(mats.rough_u, mid) > 0) | (
            _g(mats.rough_v, mid) > 0
        )
        m = (kind == MAT_GLASS) & rough
        kr = _g(mats.kr, mid)
        kt = _g(mats.kt, mid)
        eta_b = _g(mats.eta, mid)
        wh = tr_sample_wh(wo, u2, ax, ay)
        wi_r = reflect(wo, wh)
        eta_ratio = jnp.where(cos_theta(wo) > 0, 1.0 / eta_b, eta_b)
        refr_ok, wi_t = refract(
            wo, jnp.where((jnp.sum(wo * wh, -1) < 0)[..., None], -wh, wh), eta_ratio
        )
        pick_r = uc < 0.5
        wi_m = jax.lax.stop_gradient(jnp.where(pick_r[..., None], wi_r, wi_t))
        fres = lambda c: bxdf.fr_dielectric(c, 1.0, eta_b)[..., None]
        same = same_hemisphere(wo, wi_m)
        f_m = jnp.where(
            same[..., None],
            microfacet_reflection_f(wo, wi_m, ax, ay, fres, kr),
            microfacet_transmission_f(wo, wi_m, ax, ay, jnp.ones_like(eta_b), eta_b, kt),
        )
        p_m = 0.5 * (
            microfacet_reflection_pdf(wo, wi_m, ax, ay)
            + microfacet_transmission_pdf(wo, wi_m, ax, ay, jnp.ones_like(eta_b), eta_b)
        )
        ok_branch = pick_r | refr_ok
        finish(m & ok_branch, wi_m, f_m, p_m, is_trans=~same)
        eta_out = jnp.where(m, eta_b, eta_out)

    if MAT_DISNEY in cfg.mat_kinds:
        from . import disney

        smp_d, m = disney.sample(mats, mid, cfg, wo, u2, uc, kd_override)
        wi = jnp.where(m[..., None], smp_d.wi, wi)
        weight = jnp.where(m[..., None], smp_d.weight, weight)
        pdf = jnp.where(m, smp_d.pdf, pdf)
        f_out = jnp.where(m[..., None], smp_d.f, f_out)
        spec = jnp.where(m, smp_d.specular, spec)
        trans = jnp.where(m, smp_d.transmission, trans)
        eta_out = jnp.where(m, smp_d.eta, eta_out)
        valid = jnp.where(m, smp_d.valid, valid)
        handled = handled | m

    return BsdfSample(wi, weight, pdf, f_out, spec, trans, eta_out, valid), handled
