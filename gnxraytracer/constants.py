"""Global numeric constants for the ray tracer.

Semantics follow the reference's global header (/root/reference/core/GNXRayTracer.h:113-206):
Float = float32, the same Pi family, ShadowEpsilon, MachineEpsilon and the
gamma(n) conservative floating-point error bound used by watertight
intersection.  Everything here is a plain Python float / jnp scalar so it can
be folded into jitted code as a compile-time constant.
"""

import numpy as np

Float = np.float32

# /root/reference/core/GNXRayTracer.h: MachineEpsilon = epsilon * 0.5
MACHINE_EPSILON = float(np.finfo(np.float32).eps) * 0.5

SHADOW_EPSILON = 0.0001
PI = 3.14159265358979323846
INV_PI = 0.31830988618379067154
INV_2PI = 0.15915494309189533577
INV_4PI = 0.07957747154594766788
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961
SQRT_2 = 1.41421356237309504880

# Largest float32 strictly less than 1 (pbrt's OneMinusEpsilon).
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))

INFINITY = float(np.finfo(np.float32).max)


def gamma(n):
    """Conservative rounding-error bound (n * eps/2) / (1 - n * eps/2).

    Mirrors gamma(n) in the reference global header; used by the watertight
    triangle test's conservative t bound.
    """
    return (n * MACHINE_EPSILON) / (1.0 - n * MACHINE_EPSILON)
