"""Light sampling as masked table dispatch over the LightTable.

Functional equivalent of the reference Light hierarchy
(/root/reference/core/Light.h, lights/*.cpp): per-lane light index gathers
a row of the table; every light *kind* present in the scene is evaluated
branchlessly and combined with where-masks (kinds present are static per
scene, so absent kinds compile away).

Parity note: the reference DiffuseAreaLight::L has a bool-conversion bug
(lights/DiffuseAreaLight.h:22-27: `bool dotNW = Dot(n, w); ...` so emission
occurs whenever the dot is nonzero, i.e. effectively two-sided).  We
replicate it when cfg.reference_area_bug is on (default), since the default
scenes depend on it for the visible light patch.
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..constants import INV_2PI, INV_PI, PI
from ..ops.sampling import sample_continuous_2d, uniform_sample_triangle
from ..scene.scene import (
    LIGHT_AREA, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_POINT, LIGHT_SKYBOX,
    LIGHT_SPOT, Scene,
)
from ..utils.math import (HIGHEST, dot, length, normalize, spherical_phi,
                          spherical_theta)


class LightSample(NamedTuple):
    wi: jnp.ndarray        # (N,3) world, unit
    pdf: jnp.ndarray       # (N,) solid-angle pdf (1 for delta lights)
    li: jnp.ndarray        # (N,3) incident radiance (pre-visibility)
    target: jnp.ndarray    # (N,3) point the shadow ray shoots to
    is_delta: jnp.ndarray  # (N,) bool
    is_infinite: jnp.ndarray  # (N,) bool (shadow ray is unbounded)


def _gather(table, idx):
    return jnp.take(table, idx, axis=0)


class LightRow(NamedTuple):
    """All per-light attributes for each lane, fetched with ONE one-hot
    matmul over the (tiny) light table instead of per-column gathers."""
    kind: jnp.ndarray
    pos: jnp.ndarray
    emit: jnp.ndarray
    axis: jnp.ndarray
    two_sided: jnp.ndarray
    cos_falloff: jnp.ndarray
    cos_total: jnp.ndarray
    p0: jnp.ndarray  # area-light triangle vertices (zeros for non-area)
    p1: jnp.ndarray
    p2: jnp.ndarray


def light_rows(scene: Scene, light_idx) -> LightRow:
    L = scene.lights
    nl = L.kind.shape[0]
    g = scene.geom
    tri_safe = jnp.maximum(L.tri, 0)
    has_tri = (L.tri >= 0)[:, None].astype(jnp.float32)
    if g.triangles.shape[0] > 0:
        tv = g.triangles[tri_safe]
        p0 = g.vertices[tv[:, 0]] * has_tri
        p1 = g.vertices[tv[:, 1]] * has_tri
        p2 = g.vertices[tv[:, 2]] * has_tri
    else:
        p0 = p1 = p2 = jnp.zeros((nl, 3))
    if nl > 128:
        gi = lambda c: jnp.take(c, light_idx, axis=0)
        return LightRow(gi(L.kind), gi(L.pos), gi(L.emit), gi(L.axis),
                        gi(L.two_sided), gi(L.cos_falloff), gi(L.cos_total),
                        gi(p0), gi(p1), gi(p2))
    packed = jnp.concatenate(
        [L.kind.astype(jnp.float32)[:, None], L.pos, L.emit, L.axis,
         L.two_sided[:, None], L.cos_falloff[:, None], L.cos_total[:, None],
         p0, p1, p2], axis=1,
    )
    oh = (light_idx[:, None] == jnp.arange(nl)[None, :]).astype(jnp.float32)
    r = jnp.dot(oh, packed, precision=HIGHEST,
                preferred_element_type=jnp.float32)
    return LightRow(
        kind=jnp.round(r[:, 0]).astype(jnp.int32),
        pos=r[:, 1:4], emit=r[:, 4:7], axis=r[:, 7:10],
        two_sided=r[:, 10], cos_falloff=r[:, 11], cos_total=r[:, 12],
        p0=r[:, 13:16], p1=r[:, 16:19], p2=r[:, 19:22],
    )


def area_light_emitted(scene: Scene, light_idx, n_light, w,
                       reference_bug=True, row: LightRow = None):
    """DiffuseAreaLight::L — radiance leaving the light surface toward w.

    light_idx: (N,) int32 (valid rows); n_light: (N,3) light-surface normal.
    """
    if row is not None:
        lemit = row.emit
        two_sided = row.two_sided > 0.5
    else:
        lemit = _gather(scene.lights.emit, light_idx)
        two_sided = _gather(scene.lights.two_sided, light_idx) > 0.5
    d = dot(n_light, w)
    if reference_bug:
        emits = two_sided | (d != 0.0)
    else:
        emits = two_sided | (d > 0.0)
    return jnp.where(emits[..., None], lemit, 0.0)


def _area_tri(scene: Scene, light_idx):
    tri_id = _gather(scene.lights.tri, light_idx)
    tri = scene.geom.triangles[tri_id]
    p0 = scene.geom.vertices[tri[..., 0]]
    p1 = scene.geom.vertices[tri[..., 1]]
    p2 = scene.geom.vertices[tri[..., 2]]
    return p0, p1, p2


def _tri_normal_area(p0, p1, p2):
    c = jnp.cross(p1 - p0, p2 - p0)
    area = 0.5 * length(c)
    n = normalize(c)
    return n, area


def skybox_le(scene: Scene, o, d):
    """SkyBoxLight::Le fallback (no image data): position gradient on the
    world sphere (lights/SkyBoxLight.cpp:55-87)."""
    wc = scene.world_center
    wr = scene.world_radius
    oc = o - wc
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - wr * wr
    disc = b * b - 4 * a * c
    hit = disc >= 0.0
    t = (-b + jnp.sqrt(jnp.maximum(disc, 0.0))) / (2.0 * a)
    hp = oc + t[..., None] * d  # relative to center
    col = (hp + wr) / (2.0 * wr)
    return jnp.where(hit[..., None], col, 0.0)


def envmap_le(scene: Scene, d):
    """InfiniteAreaLight::Le equirect lookup (InfiniteAreaLight.cpp:91-96)."""
    env = scene.env
    w = normalize(jnp.matmul(d, env.world_to_light[:3, :3].T,
                             precision=HIGHEST))
    u = spherical_phi(w) * INV_2PI
    v = spherical_theta(w) * INV_PI
    h, wd = env.image.shape[:2]
    iu = jnp.clip((u * wd).astype(jnp.int32), 0, wd - 1)
    iv = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return env.image[iv, iu]


def envmap_le_pdf(scene: Scene, d):
    """Fused InfiniteAreaLight::Le + Pdf_Li for one direction
    (InfiniteAreaLight.cpp:91-96 + 123-136): ONE (N, 4) gather from the
    packed [rgb, func/marg_int] table and one spherical-trig pass serve
    both, where the escaped-ray MIS path would otherwise pay two separate
    texel gathers plus a duplicated world->light transform per lane per
    bounce."""
    env = scene.env
    w = normalize(jnp.matmul(d, env.world_to_light[:3, :3].T,
                             precision=HIGHEST))
    theta = spherical_theta(w)
    u = spherical_phi(w) * INV_2PI
    v = theta * INV_PI
    h, wd = env.image.shape[:2]
    iu = jnp.clip((u * wd).astype(jnp.int32), 0, wd - 1)
    iv = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    row = env.le_func[iv, iu]
    st = jnp.sin(theta)
    pdf = jnp.where(st > 0, row[..., 3]
                    / (2.0 * PI * PI * jnp.maximum(st, 1e-8)), 0.0)
    return row[..., 0:3], pdf


def escaped_radiance(scene: Scene, cfg, o, d):
    """Sum of infinite-light Le for escaped rays (PathIntegrator.cpp:107-110)."""
    le = jnp.zeros_like(d)
    if cfg.has_skybox:
        le = le + skybox_le(scene, o, d)
    if cfg.has_env:
        le = le + envmap_le(scene, d)
    return le


def sample_li(scene: Scene, cfg, light_idx, p, u2):
    """Dispatch Light::Sample_Li over the table for each lane.

    light_idx: (N,) int32; p: (N,3) shading point; u2: (N,2).
    """
    L = scene.lights
    row = light_rows(scene, light_idx)
    kind = row.kind
    pos = row.pos
    emit = row.emit
    axis = row.axis

    n = p.shape[0]
    wi = jnp.zeros_like(p)
    pdf = jnp.zeros((n,), jnp.float32)
    li = jnp.zeros_like(p)
    target = jnp.zeros_like(p)
    is_delta = jnp.zeros((n,), bool)
    is_inf = jnp.zeros((n,), bool)

    if cfg.has_point_like:
        # PointLight (lights/PointLight.cpp:11-47): I / r^2
        to_l = pos - p
        d2 = jnp.maximum(dot(to_l, to_l), 1e-12)
        w = to_l / jnp.sqrt(d2)[..., None]
        li_pt = emit / d2[..., None]
        m = kind == LIGHT_POINT
        wi = jnp.where(m[..., None], w, wi)
        pdf = jnp.where(m, 1.0, pdf)
        li = jnp.where(m[..., None], li_pt, li)
        target = jnp.where(m[..., None], pos, target)
        is_delta = is_delta | m

        # SpotLight (lights/SpotLight.cpp:20-44): cone falloff on I/r^2
        m = kind == LIGHT_SPOT
        if cfg.has_spot:
            cos_f = row.cos_falloff
            cos_t = row.cos_total
            ct = dot(axis, -w)
            delta = jnp.clip((ct - cos_t) / jnp.maximum(cos_f - cos_t, 1e-8), 0.0, 1.0)
            # smoothstep^2 * ^2 = delta^2 * delta^2 per reference Falloff
            falloff = jnp.where(ct < cos_t, 0.0, jnp.where(ct > cos_f, 1.0, (delta * delta) * (delta * delta)))
            wi = jnp.where(m[..., None], w, wi)
            pdf = jnp.where(m, 1.0, pdf)
            li = jnp.where(m[..., None], li_pt * falloff[..., None], li)
            target = jnp.where(m[..., None], pos, target)
            is_delta = is_delta | m

    if cfg.has_distant:
        # DistantLight (lights/DistantLight.cpp:16-30): w = -wLight dir,
        # target outside world bounds
        m = kind == LIGHT_DISTANT
        w = normalize(-axis)
        tgt = p + w * (2.0 * scene.world_radius)
        wi = jnp.where(m[..., None], w, wi)
        pdf = jnp.where(m, 1.0, pdf)
        li = jnp.where(m[..., None], emit, li)
        target = jnp.where(m[..., None], tgt, target)
        is_delta = is_delta | m

    if cfg.has_area:
        # DiffuseAreaLight via uniform triangle sampling; area pdf ->
        # solid-angle pdf (core/Shape.cpp:21-36)
        m = kind == LIGHT_AREA
        p0, p1, p2 = row.p0, row.p1, row.p2
        b = uniform_sample_triangle(u2)
        ps = b[..., 0:1] * p0 + b[..., 1:2] * p1 + (1.0 - b[..., 0:1] - b[..., 1:2]) * p2
        nl, area = _tri_normal_area(p0, p1, p2)
        to_l = ps - p
        d2 = dot(to_l, to_l)
        dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
        w = to_l / dist[..., None]
        cos_l = jnp.abs(dot(nl, -w))
        pdf_sa = jnp.where(
            (cos_l > 1e-8) & (d2 > 0), d2 / jnp.maximum(cos_l * area, 1e-12), 0.0
        )
        l_val = area_light_emitted(scene, light_idx, nl, -w,
                                   cfg.reference_area_bug, row)
        wi = jnp.where(m[..., None], w, wi)
        pdf = jnp.where(m, pdf_sa, pdf)
        li = jnp.where(m[..., None], l_val, li)
        target = jnp.where(m[..., None], ps, target)

    if cfg.has_skybox:
        # SkyBoxLight::Sample_Li (SkyBoxLight.cpp:42-53): uniform direction,
        # pdf 1/4pi, radiance 16*image (no data -> black)
        m = kind == LIGHT_SKYBOX
        theta = u2[..., 1] * PI
        phi = u2[..., 0] * 2.0 * PI
        st, ct = jnp.sin(theta), jnp.cos(theta)
        w = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
        wi = jnp.where(m[..., None], w, wi)
        pdf = jnp.where(m, 1.0 / (4.0 * PI), pdf)
        li = jnp.where(m[..., None], 0.0, li)  # loadImage("1") fails -> black
        target = jnp.where(m[..., None], p + w * (2.0 * scene.world_radius), target)
        is_inf = is_inf | m

    if cfg.has_env:
        # InfiniteAreaLight::Sample_Li (InfiniteAreaLight.cpp:98-121):
        # 2D CDF importance sample -> (theta, phi), pdf / (2 pi^2 sin)
        m = kind == LIGHT_INFINITE
        env = scene.env
        from ..ops.sampling import Distribution2D, sample_continuous_2d_idx

        dist2 = Distribution2D(env.cond_func, env.cond_cdf, env.cond_int,
                               env.marg_cdf, env.marg_int,
                               getattr(env, "cond_inv", None))
        # the sampled integer texel serves radiance AND the map pdf from
        # ONE packed-row gather (le_func[..., 3] == func/marg_int ==
        # exactly sample_continuous_2d's pdf0*pdf1; round 5)
        uv, iv, iu = sample_continuous_2d_idx(dist2, u2)
        row = env.le_func[iv, iu]
        map_pdf = row[..., 3]
        li_env = row[..., 0:3]
        theta = uv[..., 1] * PI
        phi = uv[..., 0] * 2.0 * PI
        st, ct = jnp.sin(theta), jnp.cos(theta)
        w_light = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
        w = jnp.matmul(w_light, env.light_to_world[:3, :3].T,
                       precision=HIGHEST)
        pdf_env = jnp.where(st > 0, map_pdf / (2.0 * PI * PI * jnp.maximum(st, 1e-8)), 0.0)
        wi = jnp.where(m[..., None], w, wi)
        pdf = jnp.where(m, pdf_env, pdf)
        li = jnp.where(m[..., None], li_env, li)
        target = jnp.where(m[..., None], p + w * (2.0 * scene.world_radius), target)
        is_inf = is_inf | m

    return LightSample(wi, pdf, li, target, is_delta, is_inf)


def pdf_li(scene: Scene, cfg, light_idx, p, wi):
    """Light::Pdf_Li for the chosen light (MIS BSDF-side weight,
    core/Integrator.cpp:186-189).  Delta lights return 0."""
    L = scene.lights
    row = light_rows(scene, light_idx)
    kind = row.kind
    pdf = jnp.zeros(p.shape[0], jnp.float32)

    if cfg.has_area:
        # re-intersect the specific light triangle (core/Shape.cpp:38-54)
        m = kind == LIGHT_AREA
        p0, p1, p2 = row.p0, row.p1, row.p2
        valid, t = _single_tri_hit(p, wi, p0, p1, p2)
        nl, area = _tri_normal_area(p0, p1, p2)
        dist2 = t * t  # wi unit
        cos_l = jnp.abs(dot(nl, -wi))
        pdf_sa = jnp.where(
            valid & (cos_l > 1e-8), dist2 / jnp.maximum(cos_l * area, 1e-12), 0.0
        )
        pdf = jnp.where(m, pdf_sa, pdf)

    # SkyBoxLight::Pdf_Li returns 0 (lights/SkyBoxLight.h:37), which makes
    # EstimateDirect's BSDF side skip it entirely for non-specular lobes
    # (core/Integrator.cpp:186-188 "if (lightPdf == 0) return Ld").  So the
    # skybox kind deliberately leaves pdf at 0 here.

    if cfg.has_env:
        m = kind == LIGHT_INFINITE
        env = scene.env
        w_l = normalize(jnp.matmul(wi, env.world_to_light[:3, :3].T,
                                   precision=HIGHEST))
        theta = spherical_theta(w_l)
        phi = spherical_phi(w_l)
        st = jnp.sin(theta)
        from ..ops.sampling import Distribution2D, pdf_2d

        dist2 = Distribution2D(env.cond_func, env.cond_cdf, env.cond_int,
                               env.marg_cdf, env.marg_int)
        uv = jnp.stack([phi * INV_2PI, theta * INV_PI], axis=-1)
        p2 = pdf_2d(dist2, uv)
        pdf_env = jnp.where(st > 0, p2 / (2.0 * PI * PI * jnp.maximum(st, 1e-8)), 0.0)
        pdf = jnp.where(m, pdf_env, pdf)

    return pdf


def _single_tri_hit(o, d, p0, p1, p2):
    """Per-lane Moller-Trumbore against one triangle each (for Pdf_Li
    re-intersection; watertightness not needed for a pdf estimate)."""
    e1 = p1 - p0
    e2 = p2 - p0
    pv = jnp.cross(d, e2)
    det = dot(e1, pv)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tv = o - p0
    u = dot(tv, pv) * inv_det
    qv = jnp.cross(tv, e1)
    v = dot(d, qv) * inv_det
    t = dot(e2, qv) * inv_det
    valid = (jnp.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
    return valid, t
