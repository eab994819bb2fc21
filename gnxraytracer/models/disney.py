"""Disney BSDF (2015) as a batched lobe mixture.

Re-implementation of the reference's DisneyMaterial
(/root/reference/materials/DisneyMaterial.cpp): DisneyDiffuse (:50),
DisneyFakeSS Hanrahan-Krueger (:88), DisneyRetro (:134), DisneySheen
(:175), DisneyClearcoat GTR1 (:207), DisneyFresnel metallic/dielectric
lerp (:308), Disney-tweaked GGX (:332), assembly with thin-surface mode
and spectral transmission (:467-583).  BSSRDF omitted (disabled in the
reference integrator, PathIntegrator.cpp:165-192 `#if 0`).

Lobe presence is parameter-dependent per material row; presence masks are
floats in {0,1} so lobe selection and pdf averaging stay branchless and
differentiable in every continuous parameter.
"""

import jax
import jax.numpy as jnp

from ..constants import INV_PI, PI
from ..utils.math import (
    HIGHEST, abs_cos_theta, cos_theta, normalize, reflect, refract,
    same_hemisphere, tan2_theta,
)
from . import bxdf
from .materials import _g
from .microfacet import (
    mf_g, mf_g1, mf_pdf_visible, microfacet_transmission_f,
    microfacet_transmission_pdf, tr_d, tr_lambda, tr_sample_wh,
)


def _schlick_weight(c):
    m = jnp.clip(1.0 - c, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _lum(c):
    return jnp.matmul(c, jnp.asarray([0.212671, 0.715160, 0.072169],
                                     jnp.float32), precision=HIGHEST)


def _params(mats, mid):
    g = lambda col: _g(col, mid)
    return dict(
        c=g(mats.kd), metallic=g(mats.metallic), eta=g(mats.eta),
        strans=g(mats.spec_trans), rough=g(mats.rough_u),
        spec_tint=g(mats.specular_tint), aniso=g(mats.anisotropic),
        sheen=g(mats.sheen), sheen_tint=g(mats.sheen_tint),
        cc=g(mats.clearcoat), cc_gloss=g(mats.clearcoat_gloss),
        flat=g(mats.flatness), dt=g(mats.diff_trans), thin=g(mats.thin) > 0.5,
    )


def _derived(p):
    c = p["c"]
    lum = _lum(c)
    ctint = jnp.where((lum > 0)[..., None], c / jnp.maximum(lum, 1e-8)[..., None], 1.0)
    dw = (1.0 - p["metallic"]) * (1.0 - p["strans"])
    aspect = jnp.sqrt(1.0 - p["aniso"] * 0.9)
    r2 = p["rough"] * p["rough"]
    ax = jnp.maximum(1e-3, r2 / aspect)
    ay = jnp.maximum(1e-3, r2 * aspect)
    r0 = _schlick_r0(p["eta"])[..., None]
    cspec0 = _lerp3(p["metallic"],
                    r0 * _lerp3(p["spec_tint"], jnp.ones_like(c), ctint), c)
    csheen = _lerp3(p["sheen_tint"], jnp.ones_like(c), ctint)
    gloss = _lerp(p["cc_gloss"], 0.1, 0.001)
    return dict(ctint=ctint, dw=dw, ax=ax, ay=ay, cspec0=cspec0,
                csheen=csheen, gloss=gloss)


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


def _lerp3(t, a, b):
    return (1.0 - t)[..., None] * a + t[..., None] * b


def _schlick_r0(eta):
    return ((eta - 1.0) / (eta + 1.0)) ** 2


# ---------------------------------------------------------------------------
# Lobe evaluations (DisneyMaterial.cpp:50-306)
# ---------------------------------------------------------------------------

def disney_diffuse_f(wo, wi, scale_c):
    fo = _schlick_weight(abs_cos_theta(wo))
    fi = _schlick_weight(abs_cos_theta(wi))
    val = INV_PI * (1.0 - fo / 2.0) * (1.0 - fi / 2.0)
    return scale_c * val[..., None]


def disney_fake_ss_f(wo, wi, scale_c, rough):
    wh = wo + wi
    ok = jnp.sum(wh * wh, -1) > 1e-16
    wh = normalize(wh, eps=1e-20)
    cos_d = jnp.sum(wi * wh, -1)
    fss90 = cos_d * cos_d * rough
    fo = _schlick_weight(abs_cos_theta(wo))
    fi = _schlick_weight(abs_cos_theta(wi))
    fss = _lerp(fo, 1.0, fss90) * _lerp(fi, 1.0, fss90)
    ss = 1.25 * (fss * (1.0 / (abs_cos_theta(wo) + abs_cos_theta(wi) + 1e-8) - 0.5) + 0.5)
    return jnp.where(ok[..., None], scale_c * (INV_PI * ss)[..., None], 0.0)


def disney_retro_f(wo, wi, scale_c, rough):
    wh = wo + wi
    ok = jnp.sum(wh * wh, -1) > 1e-16
    wh = normalize(wh, eps=1e-20)
    cos_d = jnp.sum(wi * wh, -1)
    fo = _schlick_weight(abs_cos_theta(wo))
    fi = _schlick_weight(abs_cos_theta(wi))
    rr = 2.0 * rough * cos_d * cos_d
    val = INV_PI * rr * (fo + fi + fo * fi * (rr - 1.0))
    return jnp.where(ok[..., None], scale_c * val[..., None], 0.0)


def disney_sheen_f(wo, wi, scale_c):
    wh = wo + wi
    ok = jnp.sum(wh * wh, -1) > 1e-16
    wh = normalize(wh, eps=1e-20)
    cos_d = jnp.sum(wi * wh, -1)
    return jnp.where(ok[..., None], scale_c * _schlick_weight(cos_d)[..., None], 0.0)


def _gtr1(cos_th, alpha):
    a2 = alpha * alpha
    return (a2 - 1.0) / (PI * jnp.log(a2) * (1.0 + (a2 - 1.0) * cos_th * cos_th))


def _smith_g_ggx(cos_th, alpha):
    a2 = alpha * alpha
    c2 = cos_th * cos_th
    return 1.0 / (cos_th + jnp.sqrt(a2 + c2 - a2 * c2))


def disney_clearcoat_f(wo, wi, weight, gloss):
    wh = wo + wi
    ok = jnp.sum(wh * wh, -1) > 1e-16
    wh = normalize(wh, eps=1e-20)
    d = _gtr1(abs_cos_theta(wh), gloss)
    f = bxdf.schlick_fresnel(jnp.abs(jnp.sum(wo * wh, -1)), 0.04)
    g = _smith_g_ggx(abs_cos_theta(wo), 0.25) * _smith_g_ggx(abs_cos_theta(wi), 0.25)
    return jnp.where(ok, weight * d * f * g / 4.0, 0.0)


def disney_clearcoat_pdf(wo, wi, gloss):
    wh = wo + wi
    ok = (jnp.sum(wh * wh, -1) > 1e-16) & same_hemisphere(wo, wi)
    wh = normalize(wh, eps=1e-20)
    d = _gtr1(abs_cos_theta(wh), gloss)
    pdf = d * abs_cos_theta(wh) / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * wh, -1)), 1e-8)
    return jnp.where(ok, pdf, 0.0)


def _disney_fresnel(p, drv, cos_i):
    """DisneyFresnel (:308): lerp(metallic, dielectric Fresnel,
    Schlick with Cspec0)."""
    fd = bxdf.fr_dielectric(cos_i, 1.0, p["eta"])[..., None] * jnp.ones_like(drv["cspec0"])
    fs = drv["cspec0"] + (1.0 - drv["cspec0"]) * _schlick_weight(cos_i)[..., None]
    return _lerp3(p["metallic"], fd, fs)


# ---------------------------------------------------------------------------
# Assembly: f / pdf / sample
# ---------------------------------------------------------------------------

def _lobe_presence(p):
    """Presence (0/1 floats) of [diffuse-ish, microfacet refl, clearcoat,
    microfacet trans, lambert-trans(thin)] matching the allocation logic in
    ComputeScatteringFunctions (:467-583)."""
    dw = (1.0 - p["metallic"]) * (1.0 - p["strans"])
    pres_diff = (dw > 0).astype(jnp.float32)
    pres_spec = jnp.ones_like(dw)  # microfacet reflection always added
    pres_cc = (p["cc"] > 0).astype(jnp.float32)
    pres_trans = (p["strans"] > 0).astype(jnp.float32)
    pres_ltrans = ((p["dt"] > 0) & p["thin"]).astype(jnp.float32)
    return pres_diff, pres_spec, pres_cc, pres_trans, pres_ltrans


def _f_impl(p, drv, wo, wi):
    same = same_hemisphere(wo, wi)
    dw = drv["dw"]
    c = p["c"]
    f = jnp.zeros_like(c)

    # diffuse group (reflection hemisphere)
    flat = jnp.where(p["thin"], p["flat"], 0.0)
    diff_scale = (dw * (1.0 - flat))[..., None] * c
    ss_scale = (dw * flat)[..., None] * c
    f_diff = disney_diffuse_f(wo, wi, diff_scale)
    f_ss = disney_fake_ss_f(wo, wi, ss_scale, p["rough"])
    f_retro = disney_retro_f(wo, wi, dw[..., None] * c, p["rough"])
    f_sheen = disney_sheen_f(wo, wi, (dw * p["sheen"])[..., None] * drv["csheen"])
    pres_diff, pres_spec, pres_cc, pres_trans, pres_ltrans = _lobe_presence(p)
    f = f + jnp.where(same[..., None],
                      pres_diff[..., None] * (f_diff + f_ss + f_retro + f_sheen), 0.0)

    # microfacet reflection with DisneyFresnel and Disney G
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh = wo + wi
    ok = (co > 1e-8) & (ci > 1e-8) & (jnp.sum(wh * wh, -1) > 1e-16)
    whn = normalize(wh, eps=1e-20)
    whf = jnp.where((whn[..., 2] < 0)[..., None], -whn, whn)
    d_val = tr_d(whn, drv["ax"], drv["ay"])
    # Disney G: separable smith with remapped roughness (DisneyMicrofacet :332)
    g_val = mf_g1(tr_lambda(wo, drv["ax"], drv["ay"])) * mf_g1(tr_lambda(wi, drv["ax"], drv["ay"]))
    fr = _disney_fresnel(p, drv, jnp.sum(wi * whf, -1))
    f_spec = fr * (d_val * g_val / jnp.maximum(4.0 * co * ci, 1e-8))[..., None]
    f = f + jnp.where((same & ok)[..., None], f_spec, 0.0)

    # clearcoat
    f_cc = disney_clearcoat_f(wo, wi, p["cc"], drv["gloss"])
    f = f + jnp.where(same[..., None], (pres_cc * f_cc)[..., None], 0.0)

    # microfacet transmission (strans)
    # sqrt'(0) is infinite: black base-color texels would leak NaN into
    # texture-texel gradients through the 0-cotangent product — sanitize
    # the operand and mask the value (identical primal)
    c_pos = c > 0
    t_col = p["strans"][..., None] * jnp.where(
        c_pos, jnp.sqrt(jnp.where(c_pos, c, 1.0)), 0.0)
    rscaled = (0.65 * p["eta"] - 0.35) * p["rough"]  # thin remap (:540)
    ax_t = jnp.where(p["thin"], jnp.maximum(1e-3, rscaled * rscaled / jnp.sqrt(1.0 - p["aniso"] * 0.9)), drv["ax"])
    ay_t = jnp.where(p["thin"], jnp.maximum(1e-3, rscaled * rscaled * jnp.sqrt(1.0 - p["aniso"] * 0.9)), drv["ay"])
    f_trans = microfacet_transmission_f(wo, wi, ax_t, ay_t,
                                        jnp.ones_like(p["eta"]), p["eta"], t_col)
    f = f + pres_trans[..., None] * f_trans

    # thin lambertian transmission
    f_lt = (p["dt"] / 2.0)[..., None] * c * INV_PI
    f = f + jnp.where(same[..., None], 0.0, pres_ltrans[..., None] * f_lt)

    return f


def _pdf_impl(p, drv, wo, wi):
    pres = _lobe_presence(p)
    n_lobes = sum(pres)
    same = same_hemisphere(wo, wi)
    pdf = jnp.zeros(wo.shape[0], jnp.float32)
    # diffuse cosine pdf (+ thin lambert-trans handled on other side)
    pdf = pdf + pres[0] * jnp.where(same, abs_cos_theta(wi) * INV_PI, 0.0)
    # microfacet reflection
    wh = normalize(wo + wi, eps=1e-20)
    d_val = tr_d(wh, drv["ax"], drv["ay"])
    p_spec = mf_pdf_visible(wo, wh, d_val, tr_lambda(wo, drv["ax"], drv["ay"]))
    p_spec = p_spec / jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * wh, -1)), 1e-8)
    pdf = pdf + pres[1] * jnp.where(same, p_spec, 0.0)
    # clearcoat
    pdf = pdf + pres[2] * disney_clearcoat_pdf(wo, wi, drv["gloss"])
    # transmission
    p_tr = microfacet_transmission_pdf(wo, wi, drv["ax"], drv["ay"],
                                       jnp.ones_like(p["eta"]), p["eta"])
    pdf = pdf + pres[3] * p_tr
    # thin lambert transmission
    pdf = pdf + pres[4] * jnp.where(same, 0.0, abs_cos_theta(wi) * INV_PI)
    return pdf / jnp.maximum(n_lobes, 1.0)


def evaluate(mats, mid, cfg, wo, wi, kd_override=None):
    kind = _g(mats.kind, mid)
    from ..scene.scene import MAT_DISNEY

    m = kind == MAT_DISNEY
    p = _params(mats, mid)
    if kd_override is not None:
        p['c'] = kd_override
    drv = _derived(p)
    f = _f_impl(p, drv, wo, wi)
    pdf = _pdf_impl(p, drv, wo, wi)
    return f, pdf, m


def sample(mats, mid, cfg, wo, u2, uc, kd_override=None):
    from ..scene.scene import MAT_DISNEY
    from .materials import BsdfSample

    kind = _g(mats.kind, mid)
    m = kind == MAT_DISNEY
    p = _params(mats, mid)
    if kd_override is not None:
        p['c'] = kd_override
    drv = _derived(p)
    pres = _lobe_presence(p)
    n_lobes = sum(pres)

    # pick a lobe index in [0, n_lobes) among present lobes
    pick = jnp.floor(uc * n_lobes)
    cum0 = pres[0]
    cum1 = cum0 + pres[1]
    cum2 = cum1 + pres[2]
    cum3 = cum2 + pres[3]
    choose_diff = pick < cum0
    choose_spec = (~choose_diff) & (pick < cum1)
    choose_cc = (~choose_diff) & (~choose_spec) & (pick < cum2)
    choose_trans = (~choose_diff) & (~choose_spec) & (~choose_cc) & (pick < cum3)
    choose_lt = (~choose_diff) & (~choose_spec) & (~choose_cc) & (~choose_trans)

    # candidate directions
    wi_diff = bxdf.diffuse_sample_wi(wo, u2)
    wh = tr_sample_wh(wo, u2, drv["ax"], drv["ay"])
    wi_spec = reflect(wo, wh)
    # clearcoat GTR1 sample
    a2 = drv["gloss"] * drv["gloss"]
    ct2 = (1.0 - jnp.power(a2, 1.0 - u2[..., 0])) / (1.0 - a2 + 1e-12)
    cth = jnp.sqrt(jnp.clip(ct2, 0.0, 1.0))
    sth = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct2))
    phi = 2 * PI * u2[..., 1]
    wh_cc = jnp.stack([sth * jnp.cos(phi), sth * jnp.sin(phi), cth], -1)
    wh_cc = jnp.where((wo[..., 2] < 0)[..., None], -wh_cc, wh_cc)
    wi_cc = reflect(wo, wh_cc)
    # transmission through sampled wh
    eta_ratio = jnp.where(cos_theta(wo) > 0, 1.0 / p["eta"], p["eta"])
    _ok_t, wi_tr = refract(
        wo, jnp.where((jnp.sum(wo * wh, -1) < 0)[..., None], -wh, wh), eta_ratio
    )
    # thin lambert transmission: cosine sample flipped to other side
    wi_lt = bxdf.diffuse_sample_wi(-wo, u2)

    wi = jnp.where(choose_diff[..., None], wi_diff,
         jnp.where(choose_spec[..., None], wi_spec,
         jnp.where(choose_cc[..., None], wi_cc,
         jnp.where(choose_trans[..., None], wi_tr, wi_lt))))
    wi = jax.lax.stop_gradient(wi)

    f = _f_impl(p, drv, wo, wi)
    pdf = _pdf_impl(p, drv, wo, wi)
    ok = pdf > 1e-10
    weight = f * (abs_cos_theta(wi) / jnp.maximum(jax.lax.stop_gradient(pdf), 1e-10))[..., None]
    weight = jnp.where(ok[..., None], weight, 0.0)
    trans = choose_trans | choose_lt

    return BsdfSample(
        wi=wi, weight=weight, pdf=pdf, f=f,
        specular=jnp.zeros_like(m),
        transmission=trans,
        eta=p["eta"],
        valid=ok,
    ), m
