"""Sampling warps, MIS heuristics, and CDF distributions as array ops.

Functional equivalents of /root/reference/core/Sampling.{h,cpp}:
  * warps (ConcentricSampleDisk, CosineSampleHemisphere, UniformSample*)
    become pure jnp reparameterizations — these are the differentiable
    mappings from uniform randoms to directions/points;
  * Distribution1D/2D (CDF build + SampleContinuous/SampleDiscrete,
    core/Sampling.h:19-126) become prefix-sum arrays + vectorized
    searchsorted, which maps to sorted-scan primitives XLA tiles well.

All functions broadcast over leading batch dims.
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..constants import INV_2PI, INV_4PI, INV_PI, ONE_MINUS_EPSILON, PI, PI_OVER_2, PI_OVER_4


# ---------------------------------------------------------------------------
# Warps
# ---------------------------------------------------------------------------

def uniform_sample_hemisphere(u):
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_hemisphere_pdf():
    return INV_2PI


def uniform_sample_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sphere_pdf():
    return INV_4PI


def concentric_sample_disk(u):
    """Shirley-Chiu concentric disk warp (core/Sampling.cpp semantics)."""
    u_offset = 2.0 * u - 1.0
    ux, uy = u_offset[..., 0], u_offset[..., 1]
    zero = (ux == 0.0) & (uy == 0.0)
    use_x = jnp.abs(ux) > jnp.abs(uy)
    r = jnp.where(use_x, ux, uy)
    # guard divisions for the degenerate origin lane
    safe_ux = jnp.where(ux == 0.0, 1.0, ux)
    safe_uy = jnp.where(uy == 0.0, 1.0, uy)
    theta = jnp.where(
        use_x,
        PI_OVER_4 * (uy / safe_ux),
        PI_OVER_2 - PI_OVER_4 * (ux / safe_uy),
    )
    p = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
    return jnp.where(zero[..., None], 0.0, p)


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return jnp.concatenate([d, z[..., None]], axis=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_sample_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = u[..., 1] * 2.0 * PI
    return jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta], axis=-1
    )


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def uniform_sample_triangle(u):
    """Barycentric warp (core/Sampling.cpp UniformSampleTriangle)."""
    su0 = jnp.sqrt(u[..., 0])
    return jnp.stack([1.0 - su0, u[..., 1] * su0], axis=-1)


# ---------------------------------------------------------------------------
# MIS heuristics (core/Sampling.h:151-161)
# ---------------------------------------------------------------------------

def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / (nf * f_pdf + ng * g_pdf)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return jnp.where(denom > 0.0, f * f / jnp.where(denom > 0.0, denom, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Distribution1D / Distribution2D as CDF arrays
# ---------------------------------------------------------------------------

class Distribution1D(NamedTuple):
    """Piecewise-constant 1D distribution (core/Sampling.h:19-81).

    func:     (..., N)   unnormalized function values
    cdf:      (..., N+1) normalized CDF, cdf[..., 0]=0, cdf[..., -1]=1
    func_int: (...)      integral of func over [0,1]
    """

    func: jnp.ndarray
    cdf: jnp.ndarray
    func_int: jnp.ndarray

    @property
    def count(self):
        return self.func.shape[-1]


def make_distribution1d(func):
    func = jnp.asarray(func, jnp.float32)
    n = func.shape[-1]
    cdf = jnp.cumsum(func, axis=-1) / n
    func_int = cdf[..., -1]
    zero = func_int == 0.0
    # Degenerate all-zero function -> uniform CDF, as the reference does.
    uniform = (jnp.arange(1, n + 1, dtype=jnp.float32)) / n
    norm = jnp.where(
        zero[..., None], uniform, cdf / jnp.where(zero[..., None], 1.0, func_int[..., None])
    )
    cdf_full = jnp.concatenate([jnp.zeros_like(norm[..., :1]), norm], axis=-1)
    return Distribution1D(func, cdf_full, func_int)


def _find_interval(cdf, u):
    """Index i with cdf[i] <= u < cdf[i+1]; vectorized FindInterval."""
    if cdf.ndim == 1 and cdf.shape[-1] <= 2048:
        # compare-count: one fused (N, W+1) compare+reduce instead of the
        # while-loop XLA lowers searchsorted to; bit-identical semantics
        # (side='right' insertion point == count of entries <= u)
        idx = jnp.sum((cdf <= u[..., None]).astype(jnp.int32), axis=-1) - 1
    else:
        idx = jnp.searchsorted(cdf, u, side="right") - 1
    return jnp.clip(idx, 0, cdf.shape[-1] - 2)


def sample_continuous_1d(dist: Distribution1D, u):
    """Returns (x in [0,1), pdf, offset). Batched over u's leading dims."""
    offset = _find_interval(dist.cdf, u)
    c_lo = dist.cdf[offset]
    c_hi = dist.cdf[offset + 1]
    du = u - c_lo
    width = c_hi - c_lo
    du = jnp.where(width > 0.0, du / jnp.where(width > 0.0, width, 1.0), du)
    f = dist.func[offset]
    pdf = jnp.where(dist.func_int > 0.0, f / dist.func_int, 0.0)
    x = (offset.astype(jnp.float32) + du) / dist.count
    return x, pdf, offset


def sample_discrete_1d(dist: Distribution1D, u):
    """Returns (index, pmf, remapped u)."""
    offset = _find_interval(dist.cdf, u)
    f = dist.func[offset]
    pmf = jnp.where(dist.func_int > 0.0, f / (dist.func_int * dist.count), 0.0)
    c_lo = dist.cdf[offset]
    c_hi = dist.cdf[offset + 1]
    width = c_hi - c_lo
    u_remapped = jnp.where(width > 0.0, (u - c_lo) / jnp.where(width > 0.0, width, 1.0), u)
    u_remapped = jnp.minimum(u_remapped, ONE_MINUS_EPSILON)
    return offset, pmf, u_remapped


def discrete_pdf_1d(dist: Distribution1D, index):
    return dist.func[index] / (dist.func_int * dist.count)


class Distribution2D(NamedTuple):
    """2D marginal/conditional distribution (core/Sampling.h:97-126).

    cond_func: (H, W)    conditional p(u|v) rows
    cond_cdf:  (H, W+1)
    cond_int:  (H,)      per-row integrals
    marg_cdf:  (H+1,)
    marg_int:  ()        total integral
    """

    cond_func: jnp.ndarray
    cond_cdf: jnp.ndarray
    cond_int: jnp.ndarray
    marg_cdf: jnp.ndarray
    marg_int: jnp.ndarray
    # Optional (H, M+2) int32 inverse-CDF jump table for the conditional
    # rows: entry [r, j] = FindInterval(cond_cdf[r], just_below(j/M)).
    # Present only when built from concrete arrays AND every two-bucket
    # span covers <= _INV_MAX_GAP CDF intervals, so a fixed
    # _INV_BISECT_ITERS-step bisection is guaranteed exact (round 4: cuts
    # the per-lane env-CDF bisection from ~10 flat gathers to 4).
    cond_inv: jnp.ndarray = None

    @property
    def shape(self):
        return self.cond_func.shape


_INV_BISECT_ITERS = 4
_INV_MAX_GAP = 1 << _INV_BISECT_ITERS


def _build_row_inverse(cdf_rows):
    """Host-side inverse-CDF jump table over concrete (H, W+1) CDF rows.

    Returns (inv (H, M+2) int32, ok); inv[r, j] is the interval index at a
    tick just BELOW j/M (ticks j = 0..M+1, so bucket j's answer lies in
    [inv[r, j-1], inv[r, j+2]] — the bucket of slack on each side absorbs
    float32 rounding of u*M at runtime).  M starts at W and doubles (up to
    32x) until every three-bucket span covers <= _INV_MAX_GAP CDF
    intervals; ok is False when even the finest table fails (CDFs with
    long flat runs — e.g. hundreds of zero-mass texels at one u), in which
    case callers skip the table."""
    import numpy as np

    cdf_rows = np.asarray(cdf_rows)
    h, w1 = cdf_rows.shape
    w = w1 - 1
    for mult in (1, 2, 4, 8, 16, 32):
        m = w * mult
        ticks = np.nextafter((np.arange(m + 2) / m).astype(np.float32),
                             np.float32(-np.inf))
        inv = np.empty((h, m + 2), np.int64)
        for r in range(h):
            inv[r] = np.searchsorted(cdf_rows[r], ticks, side="right") - 1
        np.clip(inv, 0, w1 - 2, out=inv)
        gap = int((inv[:, 3:] + 1 - inv[:, :-3]).max()) if m >= 2 else 0
        if gap <= _INV_MAX_GAP:
            return inv.astype(np.int32), True
    return inv.astype(np.int32), False


def make_distribution2d(func, inverse_table=True):
    func = jnp.asarray(func, jnp.float32)
    cond = make_distribution1d(func)  # batched over rows
    marg = make_distribution1d(cond.func_int)
    cond_inv = None
    if inverse_table:
        import jax

        if not isinstance(cond.cdf, jax.core.Tracer):
            inv, ok = _build_row_inverse(cond.cdf)
            if ok:
                cond_inv = jnp.asarray(inv)
    return Distribution2D(cond.func, cond.cdf, cond.func_int, marg.cdf,
                          marg.func_int, cond_inv)


def _row_searchsorted(cdf2d, rows, u, inv=None):
    """Per-lane searchsorted(cdf2d[rows[i]], u[i], side='right') - 1 without
    materializing per-lane CDF rows.  The obvious `cdf2d[rows]` gather is
    (N, W+1) — at a 1M-lane wavefront against a 1000-column environment
    CDF that is ~4 GB of gather traffic PER CALL.  A bisection over the flat
    table is ceil(log2(W+1)) scalar gathers per lane instead; with an
    inverse jump table (`inv`, see _build_row_inverse) the bisection
    starts from a <= _INV_MAX_GAP-wide bracket and needs only
    _INV_BISECT_ITERS gathers."""
    import numpy as np

    w1 = cdf2d.shape[-1]
    flat = cdf2d.reshape(-1)
    base = rows.astype(jnp.int32) * w1
    if inv is not None:
        m = inv.shape[-1] - 2
        j = jnp.clip((u * m).astype(jnp.int32), 0, m - 1)
        ibase = rows.astype(jnp.int32) * (m + 2)
        inv_flat = inv.reshape(-1)
        # one bucket of slack on EACH side: float32 rounding of u*m can put
        # j one off in either direction; the build-time gap bound covers
        # the whole 3-bucket bracket
        lo = inv_flat[ibase + jnp.maximum(j - 1, 0)]
        hi = inv_flat[ibase + j + 2] + 1
        n_iter = _INV_BISECT_ITERS
    else:
        lo = jnp.zeros(rows.shape, jnp.int32)
        hi = jnp.full(rows.shape, w1, jnp.int32)
        n_iter = int(np.ceil(np.log2(max(w1, 2))))
    # invariant: cdf[lo] <= u (cdf[0] == 0 <= u) and (hi == w1 or cdf[hi] > u)
    for _ in range(n_iter):
        done = (hi - lo) <= 1
        mid = (lo + hi) >> 1
        v = flat[base + jnp.clip(mid, 0, w1 - 1)]
        go_right = (v <= u) & ~done
        lo = jnp.where(go_right, mid, lo)
        hi = jnp.where(~go_right & ~done, mid, hi)
    return lo


def sample_continuous_2d_idx(dist: Distribution2D, u):
    """u: (..., 2) -> ((..., 2) point in [0,1)^2, iv, iu) WITHOUT the pdf
    func gather: the sampled integer texel (iv, iu) lets callers holding
    a packed [payload, func/marg_int] table serve the pdf AND their
    payload (e.g. env radiance) from ONE per-lane row gather
    (models/lights.sample_li round 5)."""
    h, w = dist.shape
    marg = Distribution1D(dist.cond_int, dist.marg_cdf, dist.marg_int)
    d1, pdf1, v_idx = sample_continuous_1d(marg, u[..., 1])
    # Row-dependent conditional: flat-gather bisection (see _row_searchsorted)
    u0 = u[..., 0]
    idx = jnp.clip(_row_searchsorted(dist.cond_cdf, v_idx, u0,
                                     inv=dist.cond_inv), 0, w - 1)
    w1 = dist.cond_cdf.shape[-1]
    cdf_flat = dist.cond_cdf.reshape(-1)
    base = v_idx.astype(jnp.int32) * w1
    c_lo = cdf_flat[base + idx]
    c_hi = cdf_flat[base + idx + 1]
    width = c_hi - c_lo
    du = jnp.where(width > 0.0, (u0 - c_lo) / jnp.where(width > 0.0, width, 1.0), u0 - c_lo)
    d0 = (idx.astype(jnp.float32) + du) / w
    return jnp.stack([d0, d1], axis=-1), v_idx.astype(jnp.int32), idx


def sample_continuous_2d(dist: Distribution2D, u):
    """u: (..., 2) -> ((..., 2) point in [0,1)^2, pdf)."""
    h, w = dist.shape
    p, v_idx, idx = sample_continuous_2d_idx(dist, u)
    cond_int = dist.cond_int[v_idx]
    f = dist.cond_func.reshape(-1)[v_idx * w + idx]
    pdf0 = jnp.where(cond_int > 0.0, f / jnp.where(cond_int > 0.0, cond_int, 1.0), 0.0)
    # pdf1 = cond_int / marg_int (sample_continuous_1d's marginal pdf)
    pdf1 = jnp.where(dist.marg_int > 0.0, cond_int / dist.marg_int, 0.0)
    return p, pdf0 * pdf1


def pdf_2d(dist: Distribution2D, p):
    """PDF of a point p in [0,1)^2 w.r.t. the 2D distribution."""
    h, w = dist.shape
    iu = jnp.clip((p[..., 0] * w).astype(jnp.int32), 0, w - 1)
    iv = jnp.clip((p[..., 1] * h).astype(jnp.int32), 0, h - 1)
    return dist.cond_func[iv, iu] / dist.marg_int
