"""Material assemblies: per-hit lobe mixtures dispatched by material kind.

Replaces the reference's Material::ComputeScatteringFunctions +
per-pixel-arena BSDF allocation (/root/reference/core/Material.h:21,
materials/*.cpp) with branchless table dispatch: each hit gathers its
material row, every material *kind present in the scene* is evaluated for
all lanes, and results combine with where-masks.  The set of present kinds
is static (render config), so absent kinds compile away entirely.

Interface (local shading frame, z = ns):
  evaluate(mats, mid, cfg, wo, wi)  -> (f, pdf)   over non-specular lobes
  sample(mats, mid, cfg, wo, u2, uc) -> BsdfSample (detached wi, attached weight)
  has_nonspecular(mats, mid, cfg)   -> bool mask
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.scene import (
    MAT_DISNEY, MAT_GLASS, MAT_MATTE, MAT_METAL, MAT_MIRROR, MAT_PLASTIC,
    MaterialTable,
)
from ..utils.math import HIGHEST, abs_cos_theta, same_hemisphere
from . import bxdf


class BsdfSample(NamedTuple):
    wi: jnp.ndarray        # (N,3) local, detached
    weight: jnp.ndarray    # (N,3) f * |cos| / pdf (attached params)
    pdf: jnp.ndarray       # (N,) sampling pdf (detached value ok)
    f: jnp.ndarray         # (N,3) raw f (0 for specular lanes)
    specular: jnp.ndarray  # (N,) bool — sampled a delta lobe
    transmission: jnp.ndarray  # (N,) bool — sampled a transmissive lobe
    eta: jnp.ndarray       # (N,) material eta (for etaScale tracking)
    valid: jnp.ndarray     # (N,) bool — black f / zero pdf -> terminate


def _g(col, mid):
    """Gather a material column per lane. mid=None means the table was
    pre-gathered to per-lane rows by gather_material_table."""
    if mid is None:
        return col
    return jnp.take(col, mid, axis=0)


# material tables are tiny (<= a few dozen rows); fetch ALL columns with one
# one-hot matmul instead of ~10 per-lane gathers (ROADMAP A4 times it)
_F3_COLS = ("kd", "kr", "kt", "ks", "eta3", "k3")
_F1_COLS = ("sigma", "eta", "rough_u", "rough_v", "remap_rough", "bump_scale",
            "metallic", "spec_trans", "specular_tint", "anisotropic", "sheen",
            "sheen_tint", "clearcoat", "clearcoat_gloss", "flatness",
            "diff_trans", "thin")
_I1_COLS = ("kind", "kd_tex", "bump_tex")


def gather_material_table(mats: MaterialTable, mid) -> MaterialTable:
    """Per-lane material rows via a single (N, M) one-hot x (M, K) matmul.

    Returns a MaterialTable whose columns are (N,)/(N,3) — downstream code
    then indexes with mid=None. Falls back to plain takes for big tables.
    """
    m_rows = mats.kind.shape[0]
    if m_rows > 128:
        return MaterialTable(*(jnp.take(c, mid, axis=0) for c in mats))
    packed = jnp.concatenate(
        [getattr(mats, c).astype(jnp.float32) for c in _F3_COLS]
        + [getattr(mats, c).astype(jnp.float32)[:, None] for c in _F1_COLS]
        + [getattr(mats, c).astype(jnp.float32)[:, None] for c in _I1_COLS],
        axis=1,
    )
    oh = (mid[:, None] == jnp.arange(m_rows)[None, :]).astype(jnp.float32)
    rows = jnp.dot(oh, packed, precision=HIGHEST,
                   preferred_element_type=jnp.float32)
    out = {}
    off = 0
    for c in _F3_COLS:
        out[c] = rows[:, off:off + 3]
        off += 3
    for c in _F1_COLS:
        out[c] = rows[:, off]
        off += 1
    for c in _I1_COLS:
        out[c] = jnp.round(rows[:, off]).astype(jnp.int32)
        off += 1
    return MaterialTable(**out)


def has_nonspecular(mats: MaterialTable, mid, cfg):
    """NumComponents(~SPECULAR) > 0 per kind (PathIntegrator.cpp:138)."""
    kind = _g(mats.kind, mid)
    ns = jnp.ones(kind.shape, bool)
    if 1 in cfg.mat_kinds:  # mirror: specular only
        ns = ns & (kind != MAT_MIRROR)
    if 2 in cfg.mat_kinds:  # smooth glass: specular only (rough later)
        rough = (_g(mats.rough_u, mid) > 0) | (_g(mats.rough_v, mid) > 0)
        ns = ns & ((kind != MAT_GLASS) | rough)
    return ns


def resolve_kd(scene, cfg, mid, uv, mats=None, duv=None):
    """Per-hit diffuse/base color: texture lookup where kd_tex >= 0
    (Texture<T>::Evaluate, core/Texture.h:105-112), else the table color.

    mats: optionally a pre-gathered per-lane table (then mid=None).
    duv: optional (duvdx, duvdy) texture-space footprint from
    ComputeDifferentials (core/Interaction.cpp:65) — selects the filtered
    MIPMap lookup per cfg.texture_filter (MIPMap::Lookup, core/MIPMap.h:226
    trilinear / :259 EWA) instead of level-0 bilinear."""
    if mats is None:
        mats = scene.materials
    kd = _g(mats.kd, mid)
    if not getattr(cfg, "has_textures", False) or scene.textures is None:
        return kd
    from ..ops.texture import bilinear_lookup, ewa_lookup, trilinear_lookup

    atlas, offs, sizes = scene.textures
    tex_id = _g(mats.kd_tex, mid)
    tid = jnp.maximum(tex_id, 0)
    filt = getattr(cfg, "texture_filter", "bilinear")
    if duv is not None and filt == "ewa":
        val = ewa_lookup(atlas, offs, sizes, tid, uv, duv[0], duv[1])
    elif duv is not None and filt == "trilinear":
        # isotropic width = max footprint extent (MIPMap.h:226 call shape)
        width = jnp.maximum(
            jnp.max(jnp.abs(duv[0]), axis=-1), jnp.max(jnp.abs(duv[1]), axis=-1))
        val = trilinear_lookup(atlas, offs, sizes, tid, uv, width)
    else:
        val = bilinear_lookup(atlas, offs, sizes, tid, uv)
    return jnp.where((tex_id >= 0)[..., None], val, kd)


def evaluate(mats: MaterialTable, mid, cfg, wo, wi, kd_override=None):
    """f and pdf over non-specular lobes (BSDF::f / BSDF::Pdf,
    Reflection.cpp:440,548)."""
    kind = _g(mats.kind, mid)
    n = kind.shape[0]
    f = jnp.zeros((n, 3), jnp.float32)
    pdf = jnp.zeros((n,), jnp.float32)

    if MAT_MATTE in cfg.mat_kinds:
        m = kind == MAT_MATTE
        kd = kd_override if kd_override is not None else _g(mats.kd, mid)
        sigma = _g(mats.sigma, mid)
        f_on = bxdf.oren_nayar_f(wo, wi, kd, sigma)
        f_lam = bxdf.lambert_f(wo, wi, kd)
        f_m = jnp.where((sigma > 0)[..., None], f_on, f_lam)
        p_m = bxdf.lambert_pdf(wo, wi)
        f = jnp.where(m[..., None], f_m, f)
        pdf = jnp.where(m, p_m, pdf)

    if MAT_METAL in cfg.mat_kinds or MAT_PLASTIC in cfg.mat_kinds or MAT_GLASS in cfg.mat_kinds or MAT_DISNEY in cfg.mat_kinds:
        from . import microfacet as mf

        f2, p2, mask2 = mf.evaluate_glossy(mats, mid, cfg, wo, wi, kd_override)
        f = jnp.where(mask2[..., None], f2, f)
        pdf = jnp.where(mask2, p2, pdf)

    return f, pdf


def sample(mats: MaterialTable, mid, cfg, wo, u2, uc, kd_override=None):
    """BSDF::Sample_f dispatch (Reflection.cpp:474-546).

    u2: (N,2) direction sample; uc: (N,) lobe-choice sample.
    """
    kind = _g(mats.kind, mid)
    n = kind.shape[0]
    wi = jnp.zeros((n, 3), jnp.float32)
    weight = jnp.zeros((n, 3), jnp.float32)
    pdf = jnp.zeros((n,), jnp.float32)
    f = jnp.zeros((n, 3), jnp.float32)
    spec = jnp.zeros((n,), bool)
    trans = jnp.zeros((n,), bool)
    eta = jnp.ones((n,), jnp.float32)
    valid = jnp.zeros((n,), bool)

    if MAT_MATTE in cfg.mat_kinds:
        m = kind == MAT_MATTE
        kd = kd_override if kd_override is not None else _g(mats.kd, mid)
        sigma = _g(mats.sigma, mid)
        wi_m = bxdf.diffuse_sample_wi(wo, u2)
        f_on = bxdf.oren_nayar_f(wo, wi_m, kd, sigma)
        f_lam = bxdf.lambert_f(wo, wi_m, kd)
        f_m = jnp.where((sigma > 0)[..., None], f_on, f_lam)
        p_m = bxdf.lambert_pdf(wo, wi_m)
        ok = p_m > 0
        w_m = f_m * (abs_cos_theta(wi_m) / jnp.maximum(jax.lax.stop_gradient(p_m), 1e-12))[..., None]
        wi = jnp.where(m[..., None], wi_m, wi)
        weight = jnp.where(m[..., None], w_m, weight)
        pdf = jnp.where(m, p_m, pdf)
        f = jnp.where(m[..., None], f_m, f)
        valid = valid | (m & ok)

    if MAT_MIRROR in cfg.mat_kinds:
        m = kind == MAT_MIRROR
        kr = _g(mats.kr, mid)
        wi_m, w_m = bxdf.specular_mirror_sample(wo, kr)
        wi = jnp.where(m[..., None], wi_m, wi)
        weight = jnp.where(m[..., None], w_m, weight)
        pdf = jnp.where(m, 1.0, pdf)
        spec = spec | m
        valid = valid | m

    if MAT_GLASS in cfg.mat_kinds:
        # Smooth glass -> FresnelSpecular (GlassMaterial.cpp:14 with
        # allowMultipleLobes); rough glass handled in microfacet module.
        m = kind == MAT_GLASS
        kr = _g(mats.kr, mid)
        kt = _g(mats.kt, mid)
        eta_b = _g(mats.eta, mid)
        wi_m, w_r, w_t, choose_r, p_m, refr_ok = bxdf.fresnel_specular_sample(
            wo, uc, jnp.ones_like(eta_b), eta_b
        )
        w_m = jnp.where(
            choose_r[..., None], kr * (w_r / jnp.maximum(p_m, 1e-12))[..., None],
            kt * (w_t / jnp.maximum(p_m, 1e-12))[..., None],
        )
        ok = choose_r | refr_ok
        wi = jnp.where(m[..., None], wi_m, wi)
        weight = jnp.where(m[..., None], w_m, weight)
        pdf = jnp.where(m, p_m, pdf)
        spec = spec | m
        trans = trans | (m & ~choose_r)
        eta = jnp.where(m, eta_b, eta)
        valid = valid | (m & ok)

    if MAT_METAL in cfg.mat_kinds or MAT_PLASTIC in cfg.mat_kinds or MAT_DISNEY in cfg.mat_kinds:
        from . import microfacet as mf

        smp2, mask2 = mf.sample_glossy(mats, mid, cfg, wo, u2, uc, kd_override)
        wi = jnp.where(mask2[..., None], smp2.wi, wi)
        weight = jnp.where(mask2[..., None], smp2.weight, weight)
        pdf = jnp.where(mask2, smp2.pdf, pdf)
        f = jnp.where(mask2[..., None], smp2.f, f)
        spec = jnp.where(mask2, smp2.specular, spec)
        trans = jnp.where(mask2, smp2.transmission, trans)
        eta = jnp.where(mask2, smp2.eta, eta)
        valid = jnp.where(mask2, smp2.valid, valid)

    return BsdfSample(wi, weight, pdf, f, spec, trans, eta, valid)
