"""Light-selection distributions: uniform / power / spatial.

Functional equivalent of the reference LightDistribution
(/root/reference/core/LightDistribution.{h,cpp}):

  * "uniform" — 1/nLights (CreateLightSampleDistribution fallback,
    LightDistribution.cpp:15-33);
  * "power"   — proportional to Light::Power().y() (the reference's
    PowerLightDistribution; SkyBox reports Power()=0 and is excluded,
    lights/SkyBoxLight.h);
  * "spatial" — a voxel grid of per-region distributions estimated by
    Monte Carlo.  The reference fills voxels lazily in a lock-free hash
    (LightDistribution.h:72-98); here we precompute ALL voxels densely
    in one vectorized pass (SURVEY.md §2.4) — no atomics, no hash.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..constants import PI
from ..scene.scene import (
    LIGHT_AREA, LIGHT_DISTANT, LIGHT_INFINITE, LIGHT_POINT, LIGHT_SKYBOX,
    LIGHT_SPOT, Scene,
)
from ..utils.math import HIGHEST, length


def light_powers(scene: Scene):
    """Per-light Power().y() luminance (reference Power() methods)."""
    L = scene.lights
    kind = L.kind
    lum = jnp.matmul(L.emit, jnp.asarray([0.212671, 0.715160, 0.072169]),
                     precision=HIGHEST)
    wr = scene.world_radius

    power = jnp.zeros_like(lum)
    # PointLight: 4 pi I (PointLight.cpp)
    power = jnp.where(kind == LIGHT_POINT, 4.0 * PI * lum, power)
    # SpotLight: I * 2 pi (1 - .5(cosFalloff + cosTotal))
    spot = lum * 2.0 * PI * (1.0 - 0.5 * (L.cos_falloff + L.cos_total))
    power = jnp.where(kind == LIGHT_SPOT, spot, power)
    # DistantLight: pi r^2 L
    power = jnp.where(kind == LIGHT_DISTANT, PI * wr * wr * lum, power)
    # DiffuseAreaLight: (two_sided ? 2 : 1) * L * area * pi
    tri = scene.geom.triangles[jnp.maximum(L.tri, 0)]
    p0 = scene.geom.vertices[tri[:, 0]]
    p1 = scene.geom.vertices[tri[:, 1]]
    p2 = scene.geom.vertices[tri[:, 2]]
    area = 0.5 * length(jnp.cross(p1 - p0, p2 - p0))
    area_pow = jnp.where(L.two_sided > 0.5, 2.0, 1.0) * lum * area * PI
    power = jnp.where(kind == LIGHT_AREA, area_pow, power)
    # InfiniteAreaLight: pi r^2 * mean radiance luminance
    if scene.env is not None:
        env_lum = jnp.mean(
            jnp.matmul(scene.env.image,
                       jnp.asarray([0.212671, 0.715160, 0.072169]),
                       precision=HIGHEST)
        )
        power = jnp.where(kind == LIGHT_INFINITE, PI * wr * wr * env_lum, power)
    # SkyBoxLight: Power() = 0 (excluded from power heuristics)
    power = jnp.where(kind == LIGHT_SKYBOX, 0.0, power)
    return power


class SpatialLightDist(NamedTuple):
    """Dense voxel grid of per-cell light CDFs."""
    cdf: jnp.ndarray      # (V, L+1) per-voxel CDF
    pmf: jnp.ndarray      # (V, L)
    res: tuple            # static (nx, ny, nz)
    lo: jnp.ndarray       # (3,) world bounds
    inv_extent: jnp.ndarray  # (3,)


def build_spatial_distribution(scene: Scene, cfg, res=16, n_samples=64, seed=7):
    """Precompute all voxels of the spatial light distribution.

    For each voxel, estimate each light's unoccluded contribution at
    n_samples jittered points (the reference's estimation strategy,
    LightDistribution.cpp:70-97, minus visibility) and normalize into a
    CDF with the same minimum-weight clamping idea.
    """
    from . import lights as lights_mod
    from ..ops import rng

    nl = cfg.n_lights
    # world bounds
    lo = scene.world_center - scene.world_radius
    hi = scene.world_center + scene.world_radius
    extent = hi - lo
    nv = res ** 3
    # voxel sample points
    ii = jnp.arange(nv, dtype=jnp.int32)
    iz = ii // (res * res)
    iy = (ii // res) % res
    ix = ii % res
    cell = jnp.stack([ix, iy, iz], -1).astype(jnp.float32)
    key = jnp.arange(nv * n_samples, dtype=jnp.int32)
    u3 = jnp.stack([
        rng.uniform_float(key, 0, 11, seed),
        rng.uniform_float(key, 0, 12, seed),
        rng.uniform_float(key, 0, 13, seed),
    ], -1).reshape(nv, n_samples, 3)
    pts = (cell[:, None] + u3) / res * extent + lo  # (V, S, 3)
    pts_flat = pts.reshape(-1, 3)

    contrib = np.zeros((nv, nl), np.float32)
    for li in range(nl):
        lidx = jnp.full((pts_flat.shape[0],), li, jnp.int32)
        u2 = jnp.stack([
            rng.uniform_float(key.repeat(1), 1, 21, seed),
            rng.uniform_float(key.repeat(1), 1, 22, seed),
        ], -1).reshape(nv * n_samples, 2)
        ls = lights_mod.sample_li(scene, cfg, lidx, pts_flat, u2)
        lum = jnp.matmul(ls.li, jnp.asarray([0.212671, 0.715160, 0.072169]),
                         precision=HIGHEST)
        est = jnp.where(ls.pdf > 0, lum / jnp.maximum(ls.pdf, 1e-12), 0.0)
        contrib[:, li] = np.asarray(est.reshape(nv, n_samples).mean(axis=1))

    # clamp tiny weights to 1% of the max (reference keeps all lights
    # selectable to stay unbiased)
    sums = contrib.sum(axis=1, keepdims=True)
    uniform = np.full_like(contrib, 1.0 / nl)
    w = np.where(sums > 0, contrib, uniform)
    w = np.maximum(w, 0.01 * w.max(axis=1, keepdims=True))
    pmf = w / w.sum(axis=1, keepdims=True)
    cdf = np.concatenate([np.zeros((nv, 1), np.float32),
                          np.cumsum(pmf, axis=1)], axis=1).astype(np.float32)
    return SpatialLightDist(
        cdf=jnp.asarray(cdf), pmf=jnp.asarray(pmf), res=(res, res, res),
        lo=lo, inv_extent=1.0 / extent,
    )


def spatial_choose_light(dist: SpatialLightDist, p, u):
    """Sample a light index from the voxel containing p."""
    res = dist.res[0]
    q = jnp.clip((p - dist.lo) * dist.inv_extent * res, 0, res - 1e-3)
    qi = q.astype(jnp.int32)
    vox = (qi[:, 2] * res + qi[:, 1]) * res + qi[:, 0]
    cdf = dist.cdf[vox]  # (N, L+1)
    idx = jnp.clip(
        jnp.sum((cdf <= u[:, None]).astype(jnp.int32), axis=1) - 1,
        0, dist.pmf.shape[1] - 1,
    )
    pdf = dist.pmf[vox, idx]
    return idx.astype(jnp.int32), pdf
