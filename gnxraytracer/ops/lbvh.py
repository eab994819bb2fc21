"""On-device LBVH build: Morton codes + sort + binary-radix linking.

Device-side equivalent of the reference's HLBVH build path
(/root/reference/accelerator/BVHAccel.cpp:369-524: EncodeMorton3 via
LeftShift3 :68-100, radix sort :102-144, emitLBVH treelets) re-designed
for XLA: the 6-bit-pass radix sort becomes one jnp.sort over 30-bit keys,
and the treelet emission becomes the Karras 2012 binary-radix tree, whose
per-node range search is a data-independent bounded loop — everything
jit-compiles and runs on device, enabling per-frame rebuilds for dynamic
scenes (the reference rebuilds on the host every scene edit).

Output: the same SoA arrays ops/bvh.py traverses, with leaf_size=1
(internal nodes = T-1, leaves = T, flattened depth-first is NOT required —
the traversal uses explicit child indices here via a second layout pass).

Layout note: the lockstep traversal (ops/bvh.py) expects the flattened
depth-first layout (second child offset).  We convert the Karras topology
to that layout host-side-free with an on-device iterative scheme is
complex; instead `build_lbvh` returns (parent/child arrays) and
`lbvh_to_linear` runs a tiny host pass (O(T)) to flatten — still far
faster than a host SAH build, and the Morton/sort/link heavy lifting
stays on device.
"""

import jax
import jax.numpy as jnp
import numpy as np


def _expand_bits(v):
    """LeftShift3 (BVHAccel.cpp:68-86): spread 10 bits to every 3rd bit."""
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3(p01):
    """30-bit Morton codes for points normalized to [0,1)^3."""
    q = jnp.clip(p01 * 1024.0, 0.0, 1023.0).astype(jnp.uint32)
    return (
        (_expand_bits(q[..., 2]) << jnp.uint32(2))
        | (_expand_bits(q[..., 1]) << jnp.uint32(1))
        | _expand_bits(q[..., 0])
    )


@jax.jit
def build_lbvh_device(vertices, triangles):
    """Device part: centroids -> morton -> sort -> Karras radix tree.

    Returns dict of arrays:
      order (T,)           triangle ids sorted by morton
      left/right (T-1,)    child indices: < T-1 internal, >= T-1 -> leaf (i - (T-1))
      bounds_lo/hi (2T-1,3)  fitted bottom-up (internal first, then leaves)
    """
    t = triangles.shape[0]
    p0 = vertices[triangles[:, 0]]
    p1 = vertices[triangles[:, 1]]
    p2 = vertices[triangles[:, 2]]
    lo = jnp.minimum(jnp.minimum(p0, p1), p2)
    hi = jnp.maximum(jnp.maximum(p0, p1), p2)
    c = 0.5 * (lo + hi)
    w_lo = jnp.min(c, axis=0)
    w_hi = jnp.max(c, axis=0)
    norm = (c - w_lo) / jnp.maximum(w_hi - w_lo, 1e-12)
    codes = morton3(norm)
    # tie-break equal codes by index (augment to 62 bits in int64-free way:
    # sort on (code, idx) via stable argsort of code)
    order = jnp.argsort(codes, stable=True).astype(jnp.int32)
    sc = codes[order]

    n_int = t - 1

    def _clz32(x):
        """Exact count-leading-zeros via bit smear + SWAR popcount
        (float log2 loses exactness above 2^24)."""
        x = x | (x >> jnp.uint32(1))
        x = x | (x >> jnp.uint32(2))
        x = x | (x >> jnp.uint32(4))
        x = x | (x >> jnp.uint32(8))
        x = x | (x >> jnp.uint32(16))
        # popcount of the smeared mask
        x = x - ((x >> jnp.uint32(1)) & jnp.uint32(0x55555555))
        x = (x & jnp.uint32(0x33333333)) + ((x >> jnp.uint32(2)) & jnp.uint32(0x33333333))
        x = (x + (x >> jnp.uint32(4))) & jnp.uint32(0x0F0F0F0F)
        pop = (x * jnp.uint32(0x01010101)) >> jnp.uint32(24)
        return (jnp.uint32(32) - pop).astype(jnp.int32)

    def delta(i, j):
        """Length of common prefix of sorted codes i and j; -1 out of range."""
        valid = (j >= 0) & (j < t)
        cj = sc[jnp.clip(j, 0, t - 1)]
        ci = sc[jnp.clip(i, 0, t - 1)]
        x = ci ^ cj
        # equal codes: augment with index bits (Karras trick) so the tree
        # stays a strict hierarchy; offset keeps these prefixes longer
        same = x == 0
        xi = jnp.asarray(i).astype(jnp.uint32) ^ jnp.asarray(j).astype(jnp.uint32)
        pre = jnp.where(same, _clz32(xi) + 32, _clz32(x))
        return jnp.where(valid, pre, -1)

    i = jnp.arange(n_int, dtype=jnp.int32)
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # find range end: exponential search then binary (bounded 30 steps)
    # bounded exponential search (T < 2^24 triangles)
    MAX_LOG = 24
    lmax = jnp.full((n_int,), 2, jnp.int32)
    for _ in range(MAX_LOG):
        bigger = delta(i, i + lmax * d) > delta_min
        lmax = jnp.where(bigger & (lmax < (1 << MAX_LOG)), lmax * 2, lmax)

    l = jnp.zeros((n_int,), jnp.int32)
    step = lmax // 2
    for _ in range(MAX_LOG + 1):
        cond = delta(i, i + (l + step) * d) > delta_min
        l = jnp.where((step > 0) & cond, l + step, l)
        step = step // 2
    j = i + l * d

    # split search
    delta_node = delta(i, j)
    s = jnp.zeros((n_int,), jnp.int32)
    div = jnp.full((n_int,), 2, jnp.int32)
    for _ in range(MAX_LOG + 1):
        tt = (l + div - 1) // div
        cond = delta(i, i + (s + tt) * d) > delta_node
        s = jnp.where((tt > 0) & cond, s + tt, s)
        div = div * 2
    gamma = i + s * d + jnp.minimum(d, 0)

    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)
    left = jnp.where(first == gamma, gamma + n_int, gamma)          # leaf if single
    right = jnp.where(last == gamma + 1, gamma + 1 + n_int, gamma + 1)

    # bottom-up bounds fit: iterate log2(T) times propagating child bounds
    leaf_lo = lo[order]
    leaf_hi = hi[order]
    node_lo = jnp.zeros((n_int, 3), jnp.float32) + jnp.inf
    node_hi = jnp.zeros((n_int, 3), jnp.float32) - jnp.inf

    def get_bounds(idx, nl, nh):
        is_leaf = idx >= n_int
        li = jnp.clip(idx - n_int, 0, t - 1)
        ii = jnp.clip(idx, 0, n_int - 1)
        blo = jnp.where(is_leaf[:, None], leaf_lo[li], nl[ii])
        bhi = jnp.where(is_leaf[:, None], leaf_hi[li], nh[ii])
        return blo, bhi

    def fit(_, carry):
        nl, nh = carry
        llo, lhi = get_bounds(left, nl, nh)
        rlo, rhi = get_bounds(right, nl, nh)
        return jnp.minimum(llo, rlo), jnp.maximum(lhi, rhi)

    n_iter = int(np.ceil(np.log2(max(t, 2)))) + 2
    node_lo, node_hi = jax.lax.fori_loop(0, n_iter, fit, (node_lo, node_hi))

    return dict(order=order, left=left, right=right,
                node_lo=node_lo, node_hi=node_hi,
                leaf_lo=leaf_lo, leaf_hi=leaf_hi)


def lbvh_to_linear(built, leaf_size=1, vertices=None, triangles=None):
    """Host O(T) pass: Karras topology -> the flattened depth-first SoA
    layout ops/bvh.py traverses (offset = second child / first prim).
    vertices/triangles are needed to pack the leaf triangle SoA + miss
    links for the threaded traversal; pass them through from build_lbvh."""
    from .bvh import _finish_build

    order = np.asarray(built["order"])
    left = np.asarray(built["left"])
    right = np.asarray(built["right"])
    node_lo = np.asarray(built["node_lo"])
    node_hi = np.asarray(built["node_hi"])
    leaf_lo = np.asarray(built["leaf_lo"])
    leaf_hi = np.asarray(built["leaf_hi"])
    t = len(order)
    n_int = t - 1

    lo_out, hi_out, off_out, npr_out, ax_out = [], [], [], [], []
    prim_order = []

    def emit(node):
        me = len(off_out)
        if node >= n_int:  # leaf
            li = node - n_int
            lo_out.append(leaf_lo[li])
            hi_out.append(leaf_hi[li])
            off_out.append(len(prim_order))
            npr_out.append(1)
            ax_out.append(0)
            prim_order.append(int(order[li]))
            return me
        lo_out.append(node_lo[node])
        hi_out.append(node_hi[node])
        off_out.append(0)
        npr_out.append(0)
        ext = node_hi[node] - node_lo[node]
        ax_out.append(int(np.argmax(ext)))
        emit(int(left[node]))
        second = emit(int(right[node]))
        off_out[me] = second
        return me

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 2 * t + 100))
    try:
        if t == 1:
            emit(n_int)  # single leaf
        else:
            emit(0)
    finally:
        sys.setrecursionlimit(old)

    pad = (-len(prim_order)) % leaf_size
    prim_order += [-1] * pad
    arrs = (
        np.asarray(lo_out, np.float32),
        np.asarray(hi_out, np.float32),
        np.asarray(off_out, np.int32),
        np.asarray(npr_out, np.int32),
        np.asarray(ax_out, np.int32),
        np.asarray(prim_order, np.int32),
    )
    if vertices is None:
        vertices = np.zeros((1, 3), np.float32)
        triangles = np.zeros((1, 3), np.int32)
    return _finish_build(arrs, np.asarray(vertices), np.asarray(triangles))


def build_lbvh(vertices, triangles, leaf_size=1):
    """Full LBVH: device morton/sort/link/fit + host flatten."""
    built = build_lbvh_device(jnp.asarray(vertices), jnp.asarray(triangles))
    return lbvh_to_linear(built, leaf_size=leaf_size,
                          vertices=vertices, triangles=triangles)
