"""Participating media: phase functions, transmittance, distance sampling.

Functional equivalents of the reference media layer:
  * Henyey-Greenstein p / Sample_p (core/Medium.cpp:164-196)
  * HomogeneousMedium: analytic Tr = exp(-sigma_t t) and spectral-MIS
    distance sampling (media/HomogeneousMedium.cpp:11-43)
  * GridDensityMedium: trilinear density (media/GridDensityMedium.cpp:14-29),
    delta tracking for Sample (:31-55), ratio tracking for Tr (:57-87) —
    the unbounded rejection loops become bounded lax.while_loops
    (MAX_TRACKING_STEPS) per SURVEY.md §7 "hard parts".

Randomness inside tracking loops is counter-based (ops/rng.py) keyed on
(lane, bounce, step) — sampler-dimension parity with the reference is
impractical here (SURVEY.md §7) and the hash stream is unbiased.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import INV_4PI, PI
from ..ops import rng
from ..utils.math import HIGHEST, coordinate_system, dot, normalize

MAX_TRACKING_STEPS = 256
MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1


# ---------------------------------------------------------------------------
# Henyey-Greenstein phase function
# ---------------------------------------------------------------------------

def hg_p(cos_theta, g):
    """PhaseHG (core/Medium.h:34)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / (denom * jnp.sqrt(jnp.maximum(denom, 1e-8)))


def hg_sample(wo, u, g):
    """HenyeyGreenstein::Sample_p (core/Medium.cpp:164): returns (wi, p)."""
    safe_g = jnp.where(jnp.abs(g) < 1e-3, 1e-3, g)
    sqr = (1.0 - safe_g * safe_g) / (1.0 + safe_g - 2.0 * safe_g * u[..., 0])
    cos_theta = jnp.where(
        jnp.abs(g) < 1e-3,
        1.0 - 2.0 * u[..., 0],
        -(1.0 + safe_g * safe_g - sqr * sqr) / (2.0 * safe_g),
    )
    cos_theta = jnp.clip(cos_theta, -1.0, 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = 2.0 * PI * u[..., 1]
    # build frame around wo (the reference builds around wo and negates per
    # its convention; HG is symmetric in phi)
    v1, v2 = coordinate_system(wo)
    wi = (
        sin_theta[..., None] * jnp.cos(phi)[..., None] * v1
        + sin_theta[..., None] * jnp.sin(phi)[..., None] * v2
        + cos_theta[..., None] * wo
    )
    return jax.lax.stop_gradient(normalize(wi)), hg_p(cos_theta, g)


# ---------------------------------------------------------------------------
# Grid density lookup
# ---------------------------------------------------------------------------

def grid_density(density, p_medium):
    """Trilinear density at medium-space points in [0,1]^3
    (GridDensityMedium::Density, media/GridDensityMedium.cpp:14-29)."""
    nz, ny, nx = density.shape
    res = jnp.asarray([nx, ny, nz], jnp.float32)
    ps = p_medium * res - 0.5
    pi = jnp.floor(ps)
    d = ps - pi
    pi = pi.astype(jnp.int32)

    def at(ix, iy, iz):
        inb = (
            (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) & (iz < nz)
        )
        v = density[jnp.clip(iz, 0, nz - 1), jnp.clip(iy, 0, ny - 1),
                    jnp.clip(ix, 0, nx - 1)]
        return jnp.where(inb, v, 0.0)

    x, y, z = pi[..., 0], pi[..., 1], pi[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    d00 = at(x, y, z) * (1 - dx) + at(x + 1, y, z) * dx
    d10 = at(x, y + 1, z) * (1 - dx) + at(x + 1, y + 1, z) * dx
    d01 = at(x, y, z + 1) * (1 - dx) + at(x + 1, y, z + 1) * dx
    d11 = at(x, y + 1, z + 1) * (1 - dx) + at(x + 1, y + 1, z + 1) * dx
    d0 = d00 * (1 - dy) + d10 * dy
    d1 = d01 * (1 - dy) + d11 * dy
    return d0 * (1 - dz) + d1 * dz


def _xform_pt(m, p):
    """Apply (N,4,4) or (4,4) to (N,3)."""
    if m.ndim == 3:
        return jnp.einsum("nij,nj->ni", m[:, :3, :3], p,
                          precision=HIGHEST) + m[:, :3, 3]
    return jnp.matmul(p, m[:3, :3].T, precision=HIGHEST) + m[:3, 3]


# ---------------------------------------------------------------------------
# Medium interaction sampling (per-lane, masked)
# ---------------------------------------------------------------------------

class MediumSample(NamedTuple):
    sampled_medium: jnp.ndarray  # (N,) bool: scattering event before surface
    t: jnp.ndarray               # (N,) event distance (valid if sampled)
    weight: jnp.ndarray          # (N,3) beta multiplier (Tr/pdf terms)


def sample_medium(media, medium_id, o, d, t_surf, lane_key, bounce, seed):
    """Dispatch Medium::Sample over lanes with medium_id >= 0.

    o, d: ray (d unit); t_surf: distance to next surface (INF if none).
    lane_key: (N,) int32 unique per lane for the hash RNG.
    """
    n = o.shape[0]
    active = medium_id >= 0
    mid = jnp.maximum(medium_id, 0)
    kind = media.kind[mid]
    sigma_a = media.sigma_a[mid]
    sigma_s = media.sigma_s[mid]
    sigma_t = sigma_a + sigma_s

    sampled = jnp.zeros((n,), bool)
    t_event = jnp.zeros((n,), jnp.float32)
    weight = jnp.ones((n, 3), jnp.float32)

    # --- homogeneous (HomogeneousMedium::Sample, :17-43) ------------------
    hom = active & (kind == MEDIUM_HOMOGENEOUS)
    u_ch = rng.uniform_float(lane_key, bounce, 9001, seed)
    u_t = rng.uniform_float(lane_key, bounce, 9002, seed)
    channel = jnp.minimum((u_ch * 3).astype(jnp.int32), 2)
    sig_c = jnp.take_along_axis(sigma_t, channel[:, None], axis=-1)[:, 0]
    # DETACHED sampling decision (the estimator's core rule, SURVEY §7):
    # the sampled distance is a function of sigma, and radiance is
    # discontinuous in t (occlusion boundaries), so an attached t makes
    # the pathwise d/d(sigma) biased — measured 23% low vs the oracle's
    # FD on the volpath scene.  Detach t; Tr and the spectral-MIS pdf
    # below stay attached at the FIXED t (their ratio carries the exact
    # score-free gradient).
    dist = jax.lax.stop_gradient(
        -jnp.log(jnp.maximum(1.0 - u_t, 1e-10)) / jnp.maximum(sig_c, 1e-10))
    t_h = jnp.minimum(dist, t_surf)
    sampled_h = dist < t_surf
    tr_h = jnp.exp(-sigma_t * jnp.minimum(t_h, 1e7)[:, None])
    # spectral MIS pdf: average over channels
    density_h = jnp.where(sampled_h[:, None], sigma_t * tr_h, tr_h)
    pdf_h = jnp.mean(density_h, axis=-1)
    pdf_h = jnp.where(pdf_h == 0, 1.0, pdf_h)
    w_h = jnp.where(
        sampled_h[:, None], tr_h * sigma_s / pdf_h[:, None], tr_h / pdf_h[:, None]
    )
    sampled = jnp.where(hom, sampled_h, sampled)
    t_event = jnp.where(hom, t_h, t_event)
    weight = jnp.where(hom[:, None], w_h, weight)

    # --- grid: delta tracking (GridDensityMedium::Sample, :31-55) ---------
    if media.density is not None:
        grd = active & (kind == MEDIUM_GRID)
        w2m = media.world_to_medium[mid]
        o_m = _xform_pt(w2m, o)
        d_m = jnp.einsum("nij,nj->ni", w2m[:, :3, :3], d,
                         precision=HIGHEST)
        # sigma_t for tracking: channel 0 (reference uses sigma_t[0] and
        # requires spectrally uniform sigma_t, GridDensityMedium.h:38-41)
        sig0 = sigma_t[:, 0]
        inv_max_d = media.inv_max_density[mid]
        # medium-space [0,1]^3 box clip
        t0, t1 = _box_clip(o_m, d_m, t_surf)
        inside = grd & (t0 < t1)

        def body(carry):
            step, t, done, hit_t = carry
            u1 = rng.uniform_float(lane_key, bounce * 1000 + step, 9101, seed)
            u2 = rng.uniform_float(lane_key, bounce * 1000 + step, 9102, seed)
            t_new = t - jnp.log(jnp.maximum(1.0 - u1, 1e-10)) * inv_max_d / jnp.maximum(sig0, 1e-10)
            escaped = t_new >= t1
            p_m = o_m + t_new[:, None] * d_m
            dens = grid_density(media.density, p_m)
            real = u2 < dens * inv_max_d
            newly_hit = ~done & inside & ~escaped & real
            hit_t = jnp.where(newly_hit, t_new, hit_t)
            done = done | escaped | newly_hit | ~inside
            return step + 1, t_new, done, hit_t

        def cond(carry):
            step, _, done, _ = carry
            return (step < MAX_TRACKING_STEPS) & ~jnp.all(done)

        init_done = ~inside
        _, _, done, hit_t = jax.lax.while_loop(
            cond, body, (0, t0, init_done, jnp.zeros((n,), jnp.float32))
        )
        sampled_g = inside & (hit_t > 0)
        w_g = jnp.where(sampled_g[:, None], sigma_s / jnp.maximum(sigma_t, 1e-10), 1.0)
        sampled = jnp.where(grd, sampled_g, sampled)
        t_event = jnp.where(grd, hit_t, t_event)
        weight = jnp.where(grd[:, None], w_g, weight)

    return MediumSample(sampled & active, t_event, jnp.where(active[:, None], weight, 1.0))


def medium_tr(media, medium_id, o, d, t_max, lane_key, salt, seed):
    """Medium::Tr dispatch: transmittance along a segment.

    Homogeneous: analytic exp (media/HomogeneousMedium.cpp:11-15).
    Grid: ratio tracking with RR (media/GridDensityMedium.cpp:57-87).
    """
    n = o.shape[0]
    active = medium_id >= 0
    mid = jnp.maximum(medium_id, 0)
    kind = media.kind[mid]
    sigma_t = media.sigma_a[mid] + media.sigma_s[mid]
    tr = jnp.ones((n, 3), jnp.float32)

    hom = active & (kind == MEDIUM_HOMOGENEOUS)
    tr_h = jnp.exp(-sigma_t * jnp.minimum(t_max, 1e7)[:, None])
    tr = jnp.where(hom[:, None], tr_h, tr)

    if media.density is not None:
        grd = active & (kind == MEDIUM_GRID)
        w2m = media.world_to_medium[mid]
        o_m = _xform_pt(w2m, o)
        d_m = jnp.einsum("nij,nj->ni", w2m[:, :3, :3], d,
                         precision=HIGHEST)
        sig0 = sigma_t[:, 0]
        inv_max_d = media.inv_max_density[mid]
        t0, t1 = _box_clip(o_m, d_m, t_max)
        inside = grd & (t0 < t1)

        def body(carry):
            step, t, tr_g, done = carry
            u1 = rng.uniform_float(lane_key, salt * 1000 + step, 9201, seed)
            u2 = rng.uniform_float(lane_key, salt * 1000 + step, 9202, seed)
            t_new = t - jnp.log(jnp.maximum(1.0 - u1, 1e-10)) * inv_max_d / jnp.maximum(sig0, 1e-10)
            escaped = t_new >= t1
            p_m = o_m + t_new[:, None] * d_m
            dens = grid_density(media.density, p_m)
            factor = 1.0 - jnp.maximum(0.0, dens * inv_max_d)
            tr_new = jnp.where((~done & ~escaped)[:, None] & inside[:, None],
                               tr_g * factor[:, None], tr_g)
            # Russian roulette on low Tr (reference rrThreshold .1)
            rr = (tr_new[:, 0] < 0.1) & ~done & ~escaped
            kill = rr & (u2 >= jnp.maximum(tr_new[:, 0], 0.0))
            tr_new = jnp.where(
                (rr & ~kill)[:, None], tr_new / jnp.maximum(tr_new[:, 0:1], 1e-8),
                tr_new,
            )
            tr_new = jnp.where(kill[:, None], 0.0, tr_new)
            done = done | escaped | kill
            return step + 1, t_new, tr_new, done

        def cond(carry):
            step, _, _, done = carry
            return (step < MAX_TRACKING_STEPS) & ~jnp.all(done)

        _, _, tr_g, _ = jax.lax.while_loop(
            cond, body, (0, t0, jnp.ones((n, 3), jnp.float32), ~inside)
        )
        tr = jnp.where(grd[:, None], tr_g, tr)

    return jnp.where(active[:, None], tr, 1.0)


def _box_clip(o_m, d_m, t_max):
    """Clip ray to the [0,1]^3 medium box; returns (t0, t1)."""
    inv = 1.0 / jnp.where(jnp.abs(d_m) < 1e-12,
                          jnp.where(d_m < 0, -1e-12, 1e-12), d_m)
    ta = (0.0 - o_m) * inv
    tb = (1.0 - o_m) * inv
    t0 = jnp.max(jnp.minimum(ta, tb), axis=-1)
    t1 = jnp.min(jnp.maximum(ta, tb), axis=-1)
    t0 = jnp.maximum(t0, 0.0)
    t1 = jnp.minimum(t1, t_max)
    return t0, t1


def transmittance_walk(scene, cfg, o, d, t_max, medium0, lane_key, salt,
                       seed):
    """VisibilityTester::Tr / Scene::IntersectTr as a bounded boundary walk
    (/root/reference/core/Light.cpp:33-53, core/Scene.cpp:26-40): re-cast
    from each null-material boundary hit, multiply the current medium's
    per-segment Tr, switch the current medium at each MediumInterface
    crossing, and return 0 on any real-material blocker.  The reference's
    unbounded while loop becomes a static unroll of cfg.tr_walk_segments
    scene casts (nesting depth, not path length — 4 covers shell-in-shell).

    Returns (tr (N,3), blocked (N,) bool).  Lanes still walking after the
    last segment keep their accumulated Tr (conservative, tiny bias only
    for deeper nesting than the unroll).
    """
    from ..ops import trace as trace_mod

    n = o.shape[0]
    tr = jnp.ones((n, 3), jnp.float32)
    cur_o = o
    cur_med = medium0
    t_rem = jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32)
    done = jnp.zeros((n,), bool)
    blocked = jnp.zeros((n,), bool)
    for k in range(max(cfg.tr_walk_segments, 1)):
        hit = trace_mod.scene_intersect(scene, cfg, cur_o, d, t_rem)
        seg_t = jnp.where(hit.hit, hit.t, t_rem)
        seg_tr = medium_tr(scene.media, cur_med, cur_o, d, seg_t, lane_key,
                           salt * 13 + k, seed)
        tr = jnp.where(done[:, None], tr, tr * seg_tr)
        # a hit on a real-material primitive is an opaque blocker -> Tr = 0
        is_tri = hit.kind == trace_mod.PRIM_TRI
        prim = jnp.where(is_tri, hit.prim, 0)
        mat = jnp.where(is_tri, scene.geom.tri_mat[prim], 0)
        if cfg.n_sphs > 0:
            is_sph = hit.kind == trace_mod.PRIM_SPH
            sp = jnp.where(is_sph, hit.prim, 0)
            mat = jnp.where(is_sph, scene.geom.sph_mat[sp], mat)
        blk = hit.hit & (mat >= 0) & ~done
        blocked = blocked | blk
        tr = jnp.where(blk[:, None], 0.0, tr)
        now_done = done | blk | ~hit.hit
        # cross the null boundary: MediumInterface transition by side
        # (GeometricPrimitive::Intersect medium resolution,
        # core/Primitive.cpp:40-46 semantics via the tri_medium table)
        tmed = scene.geom.tri_medium[prim]
        tv = scene.geom.triangles[prim]
        p0 = scene.geom.vertices[tv[:, 0]]
        p1 = scene.geom.vertices[tv[:, 1]]
        p2 = scene.geom.vertices[tv[:, 2]]
        ngb = jnp.cross(p1 - p0, p2 - p0)
        entering = jnp.sum(d * ngb, axis=-1) < 0
        new_med = jnp.where(entering, tmed[:, 0], tmed[:, 1])
        cur_med = jnp.where(now_done, cur_med, new_med)
        adv = seg_t + 1e-4 * jnp.maximum(1.0, jnp.abs(seg_t))
        cur_o = jnp.where(now_done[:, None], cur_o, cur_o + adv[:, None] * d)
        t_rem = jnp.where(now_done, t_rem, jnp.maximum(t_rem - adv, 0.0))
        done = now_done
    return tr, blocked
