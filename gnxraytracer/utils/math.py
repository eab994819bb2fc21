"""Vector math over SoA (..., 3) float32 arrays.

The reference implements a templated AoS vector library
(/root/reference/core/Geometry.h:128-830).  Here everything is batched:
a "Vector3f" is the last axis of an (..., 3) jnp array, so every helper
here broadcasts over arbitrary leading batch dimensions and is trivially
differentiable and vmappable.
"""

import jax.numpy as jnp
from jax import lax

from ..constants import PI

# Precision of every f32 matrix product on the device path.  With none set,
# an f32 dot on a GPU may run in TF32 (~10 mantissa bits), which would
# round vertex positions fetched by one-hot products and move hit points.
HIGHEST = lax.Precision.HIGHEST


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def absdot(a, b):
    return jnp.abs(dot(a, b))


def cross(a, b):
    return jnp.cross(a, b)


def length_squared(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_squared(v))


def normalize(v, eps=0.0):
    """Normalize along the last axis. eps guards 0-vectors for AD safety."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.maximum(n2, eps if eps else 1e-30)), 0.0)


def face_forward(n, v):
    """Flip n so it lies in the hemisphere of v (Geometry.h Faceforward)."""
    s = jnp.where(dot(n, v) < 0.0, -1.0, 1.0)
    return n * s[..., None]


def coordinate_system(v1):
    """Build an orthonormal basis around unit v1.

    Same branch structure as the reference CoordinateSystem
    (/root/reference/core/Geometry.h): pick the larger of |x|,|y| to avoid
    degeneracy, expressed branchlessly with where masks.
    """
    cond = (jnp.abs(v1[..., 0]) > jnp.abs(v1[..., 1]))[..., None]
    inv_a = 1.0 / jnp.sqrt(
        jnp.where(
            cond[..., 0],
            v1[..., 0] * v1[..., 0] + v1[..., 2] * v1[..., 2],
            v1[..., 1] * v1[..., 1] + v1[..., 2] * v1[..., 2],
        )
    )[..., None]
    v2a = jnp.stack([-v1[..., 2], jnp.zeros_like(v1[..., 0]), v1[..., 0]], axis=-1)
    v2b = jnp.stack([jnp.zeros_like(v1[..., 0]), v1[..., 2], -v1[..., 1]], axis=-1)
    v2 = jnp.where(cond, v2a, v2b) * inv_a
    v3 = cross(v1, v2)
    return v2, v3


def spherical_direction(sin_theta, cos_theta, phi):
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )


def spherical_direction_basis(sin_theta, cos_theta, phi, x, y, z):
    return (
        (sin_theta * jnp.cos(phi))[..., None] * x
        + (sin_theta * jnp.sin(phi))[..., None] * y
        + cos_theta[..., None] * z
    )


def spherical_theta(v):
    return jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + 2.0 * PI, p)


def reflect(wo, n):
    """Mirror wo about n (both pointing away from surface)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Refract wi about n with relative IOR eta (incident/transmitted).

    Returns (ok, wt): ok is False on total internal reflection.
    Follows Refract() in the reference Geometry.h.
    """
    cos_theta_i = dot(n, wi)
    sin2_theta_i = jnp.maximum(0.0, 1.0 - cos_theta_i * cos_theta_i)
    sin2_theta_t = eta * eta * sin2_theta_i
    ok = sin2_theta_t < 1.0
    # sanitize before the sqrt: past TIR 1-sin2 <= 0 and sqrt's derivative
    # w.r.t. eta is infinite (NaN-leak through downstream wheres)
    s2s = jnp.where(ok, sin2_theta_t, 0.0)
    cos_theta_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - s2s))
    wt = eta[..., None] * -wi + (eta * cos_theta_i - cos_theta_t)[..., None] * n
    return ok, wt


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def distance(a, b):
    return length(a - b)


# ---- local shading-frame helpers (BSDF space: z = normal) -------------------
# Mirror the inline trig helpers of /root/reference/core/Reflection.h:24-80.

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def sin2_theta(w):
    return jnp.maximum(0.0, 1.0 - cos2_theta(w))


def sin_theta(w):
    return jnp.sqrt(sin2_theta(w))


def tan_theta(w):
    return sin_theta(w) / w[..., 2]


def tan2_theta(w):
    return sin2_theta(w) / cos2_theta(w)


def cos_phi(w):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 1.0, jnp.clip(w[..., 0] / jnp.where(s == 0.0, 1.0, s), -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    return jnp.where(s == 0.0, 0.0, jnp.clip(w[..., 1] / jnp.where(s == 0.0, 1.0, s), -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0
