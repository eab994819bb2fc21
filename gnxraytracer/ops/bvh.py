"""BVH: host-side SAH build -> SoA arrays; lockstep stack traversal on device.

Design per SURVEY.md §7 item 4: the reference's pointer-based build +
recursive flatten (/root/reference/accelerator/BVHAccel.cpp:147-646) becomes

  * a host-side numpy SAH builder (12-bucket surface-area heuristic, same
    cost model as BVHAccel.cpp:270-357) emitting the flattened depth-first
    layout as separate arrays (SoA mirror of the 32-byte LinearBVHNode,
    BVHAccel.cpp:54-65): bounds_lo/hi, offset (leaf: first prim; interior:
    second child), n_prims, axis, plus the reordered primitive index list;

  * device-side traversals: the GPU kernel (ops/bvh_kernel.py, one ray
    per lane walking the threaded tree), and XLA walks where all rays step
    in lockstep inside one lax.while_loop (per-lane cursor, per-lane
    stack, or one shared cursor per ray packet) — the references the
    kernel is checked against and the CPU path of the tests.

Leaves hold up to LEAF_SIZE prims so leaf processing is a fixed-size masked
intersection (no per-lane variable loops).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import INFINITY
from .intersect import TriHit, _permute_shear, _watertight_one

# Leaf width of every fixed-size leaf intersector (the GPU kernel and the
# XLA walks): every leaf occupies exactly LEAF_SIZE rows of leaf_soa.
LEAF_SIZE = 4
MAX_STACK = 64  # matches the reference's 64-deep stack (BVHAccel.cpp:661)
MAX_TRAV_STEPS = 4096  # termination guarantee for the lockstep walk


class BVH(NamedTuple):
    bounds_lo: jnp.ndarray  # (NN,3)
    bounds_hi: jnp.ndarray  # (NN,3)
    offset: jnp.ndarray     # (NN,) int32 leaf->prim start | interior->2nd child
    n_prims: jnp.ndarray    # (NN,) int32 (0 = interior)
    axis: jnp.ndarray       # (NN,) int32 split axis
    prim_idx: jnp.ndarray   # (T_padded,) int32 reordered triangle ids (-1 pad)
    miss: jnp.ndarray       # (NN,) int32 threaded skip link (-1 = done)
    leaf_soa: jnp.ndarray   # (T_padded, 9) packed p0|p1|p2 in leaf order
    # Per-octant front-to-back threading (the stackless replacement for
    # the reference's dirIsNeg near-child-first stack order,
    # accelerator/BVHAccel.cpp:663-700): for direction octant o, a walk that
    # enters inner node n continues at first8[o,n] (the child nearer along
    # the ray) and a miss/finished node jumps to miss8[o,n].  Early t_best
    # tightening is what prunes far subtrees — the whole point of ordered
    # traversal.  Optional (None on hand-built trees): the walks fall back
    # to the single fixed order.
    first8: jnp.ndarray = None  # (8, NN) int32
    miss8: jnp.ndarray = None   # (8, NN) int32


# ---------------------------------------------------------------------------
# Host build (numpy)
# ---------------------------------------------------------------------------

def _compute_miss_links(offset, n_prims):
    """Threaded-BVH miss links for the depth-first layout: where traversal
    jumps after a box miss / finished leaf.  For interior node i (children
    i+1 and offset[i]): miss[i+1] = offset[i]; miss[offset[i]] = miss[i].
    Root's miss is -1 (terminate).  Turns the reference's 64-deep stack walk
    (BVHAccel.cpp:653-729) into a cursor-only automaton: per-lane state is
    one int32 instead of a 64-word stack."""
    nn = len(offset)
    miss = np.full(nn, -1, np.int32)
    stack = [(0, -1)]
    while stack:
        node, m = stack.pop()
        miss[node] = m
        if n_prims[node] == 0:  # interior
            right = offset[node]
            stack.append((node + 1, right))  # left child -> sibling
            stack.append((right, m))         # right child -> my miss
    return miss


def _compute_octant_links(offset, n_prims, axis):
    """Eight threaded orderings of the same tree, one per ray-direction
    octant, each visiting the NEAR child first (the split-axis sign test the
    reference does per stack push, BVHAccel.cpp:678-690): octant bit a set
    means the direction is negative along axis a, so the right (upper)
    child is nearer and is visited first.

    Vectorized per BFS level (parents strictly precede children in the
    depth-first layout, and a child's miss depends only on its parent's
    already-final miss), so the build is O(levels) numpy scatters instead
    of 8 Python DFS walks.  Returns (first8, miss8), both (8, NN) int32."""
    nn = len(offset)
    is_inner = n_prims == 0
    inner = np.nonzero(is_inner)[0]
    left = (inner + 1).astype(np.int32)
    right = offset[inner].astype(np.int32)
    # (8, NI): near child per octant for every inner node
    neg = ((np.arange(8, dtype=np.int32)[:, None] >> axis[inner][None, :]) & 1)
    near = np.where(neg == 1, right[None, :], left[None, :])
    far = np.where(neg == 1, left[None, :], right[None, :])

    first8 = np.full((8, nn), -1, np.int32)
    first8[:, inner] = near

    pos = np.full(nn, -1, np.int64)
    pos[inner] = np.arange(len(inner))
    miss8 = np.full((8, nn), -1, np.int32)
    frontier = np.array([0], dtype=np.int64)
    while len(frontier):
        fi = frontier[is_inner[frontier]]
        if len(fi) == 0:
            break
        p = pos[fi]
        for o in range(8):  # near targets are unique (one parent per child)
            miss8[o, near[o, p]] = far[o, p]
            miss8[o, far[o, p]] = miss8[o, fi]
        frontier = np.concatenate([fi + 1, offset[fi]])
    return first8, miss8


def _pack_leaf_soa(vertices, triangles, order):
    """(T_padded, 9) p0|p1|p2 rows in leaf order: one contiguous row fetch
    per leaf prim instead of an index-chase (tris gather + 3 vertex
    gathers)."""
    v = np.asarray(vertices, np.float32)
    t = np.asarray(triangles, np.int64)
    safe = np.maximum(order.astype(np.int64), 0)
    tri = t[safe]
    soa = np.concatenate([v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]], axis=1)
    soa[order < 0] = 0.0
    return soa.astype(np.float32)


def _align_leaves(off, npr, order, leaf_size=LEAF_SIZE):
    """Normalize the leaf rows so every leaf occupies EXACTLY leaf_size
    rows (short leaves padded with -1).  Keeps all traversals' fixed-size
    leaf window valid with zero per-leaf length bookkeeping.  Vectorized
    (no per-leaf Python loop).  Returns (new_off, new_order)."""
    off = np.asarray(off, np.int64)
    npr = np.asarray(npr, np.int64)
    order = np.asarray(order, np.int64)
    leaves = np.nonzero(npr > 0)[0]
    if len(leaves) == 0:
        # leafless (empty-mesh) tree: zero leaf rows, offsets untouched —
        # both return values agree there is nothing to intersect
        return off.astype(np.int32), np.zeros((0,), np.int32)
    leaves = leaves[np.argsort(off[leaves], kind="stable")]
    cnt = npr[leaves]
    nl = len(leaves)
    new_order = np.full(nl * leaf_size, -1, np.int64)
    tot = int(cnt.sum())
    leaf_of = np.repeat(np.arange(nl), cnt)
    within = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    src = np.repeat(off[leaves], cnt) + within
    new_order[leaf_of * leaf_size + within] = order[src]
    new_off = off.copy()
    new_off[leaves] = np.arange(nl) * leaf_size
    return new_off.astype(np.int32), new_order.astype(np.int32)


def _finish_build(arrs, vertices, triangles, orig_ids=None):
    lo, hi, off, npr, ax, order = (np.asarray(a) for a in arrs)
    off, order = _align_leaves(off, npr, order)
    if orig_ids is not None:
        # subset build (big-prim separation): remap prim ids to GLOBAL
        # triangle ids before any table packs them
        orig_ids = np.asarray(orig_ids, np.int64)
        order = np.where(order >= 0, orig_ids[np.maximum(order, 0)],
                         -1).astype(np.int32)
    miss = _compute_miss_links(off, npr)
    soa = _pack_leaf_soa(vertices, triangles, order)
    first8, miss8 = _compute_octant_links(off, npr, ax)
    return BVH(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(off),
               jnp.asarray(npr), jnp.asarray(ax), jnp.asarray(order),
               jnp.asarray(miss), jnp.asarray(soa),
               jnp.asarray(first8), jnp.asarray(miss8))


def build_bvh(vertices, triangles, leaf_size=LEAF_SIZE, subset=None):
    """SAH BVH over triangles; returns BVH arrays (device).

    subset: optional index array — build the tree over triangles[subset]
    only, with prim ids remapped back to GLOBAL triangle ids (big-prim
    separation: a few huge triangles, e.g. a ground plane, inflate every
    packet block's node-set union; the caller brute-forces them instead
    and their hit t tightens the walk's t_max)."""
    triangles = np.asarray(triangles, np.int32)
    orig_ids = None
    if subset is not None:
        orig_ids = np.asarray(subset, np.int64)
        triangles = triangles[orig_ids]
    from ..native import bvh_native

    built = bvh_native.build(np.asarray(vertices, np.float32),
                             np.asarray(triangles, np.int32), leaf_size)
    if built is not None:
        return _finish_build(built, vertices, triangles, orig_ids)
    return _finish_build(build_bvh_numpy(vertices, triangles, leaf_size),
                         vertices, triangles, orig_ids)


def build_bvh_numpy(vertices, triangles, leaf_size=LEAF_SIZE):
    v = np.asarray(vertices, np.float64)
    t = np.asarray(triangles, np.int64)
    p0, p1, p2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    centroid = 0.5 * (lo + hi)
    n = len(t)

    # growable node arrays
    nodes_lo, nodes_hi, nodes_off, nodes_np, nodes_ax = [], [], [], [], []
    order = []

    def new_node():
        nodes_lo.append(np.zeros(3))
        nodes_hi.append(np.zeros(3))
        nodes_off.append(0)
        nodes_np.append(0)
        nodes_ax.append(0)
        return len(nodes_lo) - 1

    def build(idx):
        """idx: array of triangle indices for this subtree. Returns node id.
        Iterative would be faster; recursion depth ~ log2(T) w/ SAH splits,
        but degenerate cases can go deep -> guard with median fallback."""
        me = new_node()
        b_lo = lo[idx].min(0)
        b_hi = hi[idx].max(0)
        nodes_lo[me] = b_lo
        nodes_hi[me] = b_hi
        if len(idx) <= leaf_size:
            nodes_off[me] = len(order)
            nodes_np[me] = len(idx)
            order.extend(idx.tolist())
            return me
        c = centroid[idx]
        c_lo, c_hi = c.min(0), c.max(0)
        dim = int(np.argmax(c_hi - c_lo))
        if c_hi[dim] - c_lo[dim] < 1e-12:
            # degenerate: all centroids identical.  The reference makes one
            # big leaf here (BVHAccel.cpp:231-246) because its leaf loop is
            # variable-length; OUR leaf intersectors test a fixed LEAF_SIZE
            # window, so an oversized leaf would silently drop prims —
            # split arbitrarily in half until leaves fit.
            half = len(idx) // 2
            nodes_ax[me] = dim
            build(idx[:half])
            second = build(idx[half:])
            nodes_off[me] = second
            nodes_np[me] = 0
            return me
        # 12-bucket SAH (BVHAccel.cpp:270-357 cost model)
        nb = 12
        which = np.minimum(
            (nb * (c[:, dim] - c_lo[dim]) / (c_hi[dim] - c_lo[dim])).astype(int),
            nb - 1,
        )
        counts = np.bincount(which, minlength=nb)
        blo = np.full((nb, 3), np.inf)
        bhi = np.full((nb, 3), -np.inf)
        for bkt in range(nb):
            m = which == bkt
            if m.any():
                blo[bkt] = lo[idx][m].min(0)
                bhi[bkt] = hi[idx][m].max(0)

        def area(l, h):
            d = np.maximum(h - l, 0)
            return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])

        cost = np.empty(nb - 1)
        for i in range(nb - 1):
            l_lo = blo[: i + 1][counts[: i + 1] > 0]
            l_hi = bhi[: i + 1][counts[: i + 1] > 0]
            r_lo = blo[i + 1:][counts[i + 1:] > 0]
            r_hi = bhi[i + 1:][counts[i + 1:] > 0]
            c0 = counts[: i + 1].sum()
            c1 = counts[i + 1:].sum()
            a0 = area(l_lo.min(0), l_hi.max(0)) if c0 else 0.0
            a1 = area(r_lo.min(0), r_hi.max(0)) if c1 else 0.0
            cost[i] = 1 + (c0 * a0 + c1 * a1) / max(area(b_lo, b_hi), 1e-12)
        # (no "cost >= leaf_cost -> big leaf" branch: len(idx) > leaf_size
        # here, and oversized leaves overflow the fixed LEAF_SIZE
        # intersector window — always split instead)
        split = int(np.argmin(cost))
        left_mask = which <= split
        if not left_mask.any() or left_mask.all():
            half = len(idx) // 2
            srt = idx[np.argsort(c[:, dim])]
            li, ri = srt[:half], srt[half:]
        else:
            li, ri = idx[left_mask], idx[~left_mask]
        nodes_ax[me] = dim
        build(li)
        second = build(ri)
        nodes_off[me] = second
        nodes_np[me] = 0
        return me

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        build(np.arange(n))
    finally:
        sys.setrecursionlimit(old)

    # pad prim order to multiple of leaf_size with -1
    pad = (-len(order)) % leaf_size
    order_arr = np.asarray(order + [-1] * pad, np.int32)
    return (
        np.asarray(nodes_lo, np.float32),
        np.asarray(nodes_hi, np.float32),
        np.asarray(nodes_off, np.int32),
        np.asarray(nodes_np, np.int32),
        np.asarray(nodes_ax, np.int32),
        order_arr,
    )


# ---------------------------------------------------------------------------
# Device traversal
# ---------------------------------------------------------------------------

def _slab_test(lo, hi, o, inv_d, t_max):
    """Bounds3::IntersectP slab test (core/Geometry.h:1356) batched."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    t_near = jnp.max(tn, axis=-1)
    t_far = jnp.min(tf, axis=-1) * (1.0 + 2.0 * 7.2e-7)  # gamma(3) slop
    return (t_near <= t_far) & (t_far > 0) & (t_near < t_max)


def _leaf_intersect(verts, tris, prim_idx, leaf_off, o, d, t_best):
    """Intersect LEAF_SIZE prims per lane (masked), Moller-Trumbore.

    Returns (t (N,K), valid (N,K), ids (N,K), bary (N,K,2)).
    """
    k = LEAF_SIZE
    ids = prim_idx[leaf_off[:, None] + jnp.arange(k)[None, :]]  # (N,K)
    ok = ids >= 0
    safe = jnp.maximum(ids, 0)
    tri = tris[safe]  # (N,K,3)
    p0 = verts[tri[..., 0]]
    p1 = verts[tri[..., 1]]
    p2 = verts[tri[..., 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    dv = d[:, None]
    pv = jnp.cross(dv, e2)
    det = jnp.sum(e1 * pv, -1)
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tv = o[:, None] - p0
    u = jnp.sum(tv * pv, -1) * inv
    qv = jnp.cross(tv, e1)
    v = jnp.sum(dv * qv, -1) * inv
    t = jnp.sum(e2 * qv, -1) * inv
    valid = ok & (jnp.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
    valid &= (t > 1e-5) & (t < t_best[:, None])
    return t, valid, safe, jnp.stack([u, v], -1)


def _leaf_intersect_soa(bvh: BVH, leaf_off, o, d, t_best):
    """Leaf intersection from the packed (T_padded, 9) leaf SoA: one
    contiguous row fetch per prim instead of the tris->vertices index
    chase.  Watertight test (intersect._watertight_one), the same as brute
    force, the packet walk and the GPU kernel, so every walk has the same
    hit set.  Returns (t, valid, ids, uv) each (N, K) / (N, K, 2)."""
    k = LEAF_SIZE
    rows = leaf_off[:, None] + jnp.arange(k)[None, :]       # (N,K)
    ids = bvh.prim_idx[rows]
    soa = bvh.leaf_soa[rows]                                 # (N,K,9)
    (m0, m1), shear = _permute_shear(o, d)
    col = lambda x: x[:, None]
    valid, t, _b0, b1, b2 = _watertight_one(
        col(o[:, 0]), col(o[:, 1]), col(o[:, 2]), col(m0), col(m1),
        col(shear[:, 0]), col(shear[:, 1]), col(shear[:, 2]),
        col(t_best),
        (soa[..., 0], soa[..., 1], soa[..., 2]),
        (soa[..., 3], soa[..., 4], soa[..., 5]),
        (soa[..., 6], soa[..., 7], soa[..., 8]))
    valid &= (ids >= 0) & (t < t_best[:, None])
    return t, valid, jnp.maximum(ids, 0), jnp.stack([b1, b2], -1)


def bvh_closest_hit_stackless(bvh: BVH, o, d, t_max):
    """Threaded (stackless) traversal, closest hit.

    Cursor-only automaton over the miss-linked DFS layout: per step each
    lane advances cursor -> cursor+1 on an interior box hit, or to
    miss[cursor] otherwise; leaves run a fixed-size masked intersection.
    Per-lane loop state is 1 int32 + the running best hit — no (N, 64)
    stack array rewritten in device memory every step like the stack
    walk.  Trade-off vs. the reference's near-child-first order
    (BVHAccel.cpp:672-681): child order is fixed (left first), so early-t
    pruning relies on the slab test's `t_near < t_best` alone."""
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                            jnp.where(d < 0, -1e-20, 1e-20), d)

    class St(NamedTuple):
        cursor: jnp.ndarray
        t_best: jnp.ndarray
        best_tri: jnp.ndarray
        best_uv: jnp.ndarray
        found: jnp.ndarray
        step: jnp.ndarray

    st = St(
        cursor=jnp.zeros((n,), jnp.int32),
        t_best=jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32),
        best_tri=jnp.zeros((n,), jnp.int32),
        best_uv=jnp.zeros((n, 2), jnp.float32),
        found=jnp.zeros((n,), bool),
        step=jnp.zeros((), jnp.int32),
    )

    def cond(st):
        return jnp.any(st.cursor >= 0) & (st.step < MAX_TRAV_STEPS)

    def body(st):
        active = st.cursor >= 0
        node = jnp.maximum(st.cursor, 0)
        lo = bvh.bounds_lo[node]
        hi = bvh.bounds_hi[node]
        np_ = bvh.n_prims[node]
        off = bvh.offset[node]
        miss = bvh.miss[node]

        box_hit = _slab_test(lo, hi, o, inv_d, st.t_best) & active
        is_leaf = (np_ > 0) & box_hit
        is_inner = (np_ == 0) & box_hit

        t, valid, ids, uv = _leaf_intersect_soa(bvh, off, o, d, st.t_best)
        t_m = jnp.where(valid & is_leaf[:, None], t, INFINITY)
        kbest = jnp.argmin(t_m, axis=-1)
        rows = jnp.arange(n)
        t_new = t_m[rows, kbest]
        better = t_new < st.t_best
        t_best = jnp.where(better, t_new, st.t_best)
        best_tri = jnp.where(better, ids[rows, kbest], st.best_tri)
        best_uv = jnp.where(better[:, None], uv[rows, kbest], st.best_uv)

        cursor = jnp.where(is_inner, node + 1, miss)
        cursor = jnp.where(active, cursor, st.cursor)
        return St(cursor, t_best, best_tri, best_uv, st.found | better,
                  st.step + 1)

    st = jax.lax.while_loop(cond, body, st)
    b = jnp.stack(
        [1.0 - st.best_uv[:, 0] - st.best_uv[:, 1], st.best_uv[:, 0],
         st.best_uv[:, 1]], axis=-1,
    )
    return TriHit(hit=st.found, t=jnp.where(st.found, st.t_best, INFINITY),
                  tri=st.best_tri, b=b)


def bvh_any_hit_stackless(bvh: BVH, o, d, t_max):
    """Threaded traversal, early-out occlusion (IntersectP semantics)."""
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                            jnp.where(d < 0, -1e-20, 1e-20), d)
    t_max = jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32)

    class St(NamedTuple):
        cursor: jnp.ndarray
        occluded: jnp.ndarray
        step: jnp.ndarray

    st = St(cursor=jnp.zeros((n,), jnp.int32),
            occluded=jnp.zeros((n,), bool),
            step=jnp.zeros((), jnp.int32))

    def cond(st):
        return jnp.any(st.cursor >= 0) & (st.step < MAX_TRAV_STEPS)

    def body(st):
        active = st.cursor >= 0
        node = jnp.maximum(st.cursor, 0)
        lo = bvh.bounds_lo[node]
        hi = bvh.bounds_hi[node]
        np_ = bvh.n_prims[node]
        off = bvh.offset[node]
        miss = bvh.miss[node]
        box_hit = _slab_test(lo, hi, o, inv_d, t_max) & active
        is_leaf = (np_ > 0) & box_hit
        is_inner = (np_ == 0) & box_hit
        _, valid, _, _ = _leaf_intersect_soa(bvh, off, o, d, t_max)
        occluded = st.occluded | jnp.any(valid & is_leaf[:, None], axis=-1)
        cursor = jnp.where(is_inner, node + 1, miss)
        cursor = jnp.where(active & ~occluded, cursor, jnp.where(active, -1, st.cursor))
        return St(cursor, occluded, st.step + 1)

    st = jax.lax.while_loop(cond, body, st)
    return st.occluded


PACKET = 512  # rays per shared-cursor packet


def _spread3(x):
    """Interleave 10 bits with 2-bit gaps (30-bit 3D morton support)."""
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def ray_sort_perm(o, d, lo, hi, t_max=None, key_mode="oct_morton"):
    """Coherence permutation for packet traversal — the knob that turns a
    block's union-of-node-sets back toward per-ray-optimal visits.

    key_mode:
      "oct_morton"    — (direction octant major, 5-bit origin morton):
                        right for primary/shadow wavefronts where many
                        origins share a direction cone.
      "morton_oct"    — (8-bit origin morton major, octant minor): right
                        for BOUNCE wavefronts — origins cluster on the
                        surface the previous cast hit (the hit-cluster
                        key), directions are
                        cosine-spread so origin locality dominates.
      "morton6d"      — interleaved position(6b)+direction(4b) morton.

    When t_max is given, lanes with t_max <= 0 (dead wavefront lanes —
    integrators mask them this way) sort to the END: their blocks become
    all-dead, request no nodes, and terminate at the root in one step, so
    a wavefront that is 20% alive costs ~20% of a full cast instead of
    100%.  Returns (perm, inv_perm)."""
    ext = jnp.maximum(hi - lo, 1e-6)
    octant = ((d[:, 0] < 0).astype(jnp.uint32)
              | ((d[:, 1] < 0).astype(jnp.uint32) << 1)
              | ((d[:, 2] < 0).astype(jnp.uint32) << 2))
    if key_mode == "oct_morton":
        q = jnp.clip(((o - lo) / ext * 31.0), 0, 31).astype(jnp.uint32)
        morton = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
                  | (_spread3(q[:, 2]) << 2))
        key = (octant << jnp.uint32(15)) | morton
    elif key_mode == "oct_morton8":
        # octant major + fine 8-bit/axis origin morton: bounce wavefronts
        # from a dense mesh need origin cells far smaller than the scene
        # bound's 1/32 to keep a block's union of subtree paths tight
        q = jnp.clip(((o - lo) / ext * 255.0), 0, 255).astype(jnp.uint32)
        morton = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
                  | (_spread3(q[:, 2]) << 2))
        key = (octant << jnp.uint32(24)) | morton
    elif key_mode == "morton_oct":
        q = jnp.clip(((o - lo) / ext * 255.0), 0, 255).astype(jnp.uint32)
        morton = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
                  | (_spread3(q[:, 2]) << 2))  # 24 bits
        key = (morton << jnp.uint32(3)) | octant
    elif key_mode == "morton6d":
        q = jnp.clip(((o - lo) / ext * 63.0), 0, 63).astype(jnp.uint32)
        qd = jnp.clip((d * 0.5 + 0.5) * 15.0, 0, 15).astype(jnp.uint32)
        pm = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
              | (_spread3(q[:, 2]) << 2))  # 18 bits
        dm = (_spread3(qd[:, 0]) | (_spread3(qd[:, 1]) << 1)
              | (_spread3(qd[:, 2]) << 2))  # 12 bits
        key = (pm << jnp.uint32(12)) | dm
    else:
        raise ValueError(key_mode)
    if t_max is not None:
        key = jnp.where(t_max <= 0, jnp.uint32(0x7FFFFFFF), key)
    perm = jnp.argsort(key)
    # inverse by scatter (one pass) instead of a second 1M-element argsort
    n = perm.shape[0]
    inv = jnp.zeros((n,), perm.dtype).at[perm].set(
        jnp.arange(n, dtype=perm.dtype), unique_indices=True)
    return perm, inv


def packet_closest_hit_xla(bvh: BVH, o, d, t_max, packet=PACKET, sort=True,
                           sort_key="oct_morton"):
    """Packet traversal at the XLA level: rays grouped into `packet`-wide
    blocks; each block walks the threaded BVH behind ONE shared cursor,
    visiting a node when any of its rays wants it.

    Per step the memory access is an (N/packet,)-sized gather (2048 rows,
    not 1M) and all ray math is dense vector work, unlike the per-lane
    lockstep walks, whose every step gathers N node and leaf rows.  Each
    node is entered at most once, so the walk terminates in <= NN steps
    by construction.  Coherence (the `sort` flag) bounds how close a
    block's union-of-nodes is to each ray's own node set."""
    n = o.shape[0]
    t_max = jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32)
    if sort:
        perm, inv = ray_sort_perm(o, d, bvh.bounds_lo[0], bvh.bounds_hi[0],
                                  t_max=t_max, key_mode=sort_key)
        o, d, t_max = o[perm], d[perm], t_max[perm]

    b = packet
    n_pad = ((n + b - 1) // b) * b
    nb = n_pad // b

    def pad(x, fill):
        return jnp.concatenate(
            [x, jnp.full((n_pad - n,) + x.shape[1:], fill, x.dtype)])

    op = pad(o, 0.0).reshape(nb, b, 3)
    dp = pad(d, 1.0).reshape(nb, b, 3)
    tm = pad(t_max, -1.0).reshape(nb, b)
    inv_d = 1.0 / jnp.where(jnp.abs(dp) < 1e-20,
                            jnp.where(dp < 0, -1e-20, 1e-20), dp)
    # Watertight leaf frame (shape/Triangle.cpp:71-300 semantics, shared
    # with brute force and the GPU kernel so no two modes disagree at
    # shared mesh edges).  Permute/shear per ray, computed once per cast.
    (wm0, wm1), wshear = _permute_shear(op.reshape(-1, 3), dp.reshape(-1, 3))
    wm0 = wm0.reshape(nb, b)
    wm1 = wm1.reshape(nb, b)
    wsx = wshear[:, 0].reshape(nb, b)
    wsy = wshear[:, 1].reshape(nb, b)
    wsz = wshear[:, 2].reshape(nb, b)
    ox_, oy_, oz_ = op[..., 0], op[..., 1], op[..., 2]

    # Ordered (front-to-back) traversal: each block walks the threading for
    # its majority direction octant (after the sort, blocks are octant-pure
    # except at boundaries — a mixed block just gets a suboptimal but still
    # correct DFS order).  Near-child-first tightens t_best early, which is
    # what makes `tn < t_best` prune far subtrees on incoherent bounces.
    ordered = sort and bvh.first8 is not None
    if ordered:
        nn_nodes = bvh.first8.shape[1]
        d0 = dp[:, 0, :]  # block-representative ray
        oct_b = ((d0[:, 0] < 0).astype(jnp.int32)
                 | ((d0[:, 1] < 0).astype(jnp.int32) << 1)
                 | ((d0[:, 2] < 0).astype(jnp.int32) << 2))
        link_base = oct_b * nn_nodes
        first_flat = bvh.first8.reshape(-1)
        miss_flat = bvh.miss8.reshape(-1)

    class St(NamedTuple):
        cursor: jnp.ndarray   # (NB,)
        t_best: jnp.ndarray   # (NB,B)
        tri: jnp.ndarray      # (NB,B)
        uv: jnp.ndarray       # (NB,B,2)

    st = St(cursor=jnp.zeros((nb,), jnp.int32),
            t_best=tm,
            tri=jnp.full((nb, b), -1, jnp.int32),
            uv=jnp.zeros((nb, b, 2), jnp.float32))

    def cond(st):
        return jnp.any(st.cursor >= 0)

    def body(st):
        active = st.cursor >= 0
        node = jnp.maximum(st.cursor, 0)
        lo = bvh.bounds_lo[node][:, None, :]   # (NB,1,3)
        hi = bvh.bounds_hi[node][:, None, :]
        np_ = bvh.n_prims[node]
        off = bvh.offset[node]
        if ordered:
            nxt = first_flat[link_base + node]
            miss = miss_flat[link_base + node]
        else:
            nxt = node + 1
            miss = bvh.miss[node]

        t0 = (lo - op) * inv_d
        t1 = (hi - op) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1) * (1.0 + 2.0 * 7.2e-7)
        want = (tn <= tf) & (tf > 0) & (tn < st.t_best) & active[:, None]
        any_want = jnp.any(want, axis=-1)

        is_leaf = (np_ > 0) & any_want
        is_inner = (np_ == 0) & any_want

        t_best, tri_b, uv_b = st.t_best, st.tri, st.uv
        for k in range(LEAF_SIZE):
            ids = bvh.prim_idx[off + k]          # (NB,)
            row = bvh.leaf_soa[off + k]          # (NB,9)
            valid, t, _b0, b1, b2 = _watertight_one(
                ox_, oy_, oz_, wm0, wm1, wsx, wsy, wsz, t_best,
                (row[:, 0:1], row[:, 1:2], row[:, 2:3]),
                (row[:, 3:4], row[:, 4:5], row[:, 5:6]),
                (row[:, 6:7], row[:, 7:8], row[:, 8:9]))
            valid = valid & (t < t_best) & (is_leaf & (ids >= 0))[:, None]
            t_best = jnp.where(valid, t, t_best)
            tri_b = jnp.where(valid, ids[:, None], tri_b)
            uv_b = jnp.where(valid[..., None], jnp.stack([b1, b2], -1), uv_b)

        cursor = jnp.where(is_inner, nxt, miss)
        cursor = jnp.where(active, cursor, st.cursor)
        return St(cursor, t_best, tri_b, uv_b)

    st = jax.lax.while_loop(cond, body, st)

    t = st.t_best.reshape(-1)[:n]
    tri = st.tri.reshape(-1)[:n]
    uv = st.uv.reshape(-1, 2)[:n]
    if sort:
        t, tri, uv = t[inv], tri[inv], uv[inv]
    hit = tri >= 0
    bary = jnp.stack([1.0 - uv[:, 0] - uv[:, 1], uv[:, 0], uv[:, 1]], -1)
    return TriHit(hit=hit, t=jnp.where(hit, t, INFINITY),
                  tri=jnp.maximum(tri, 0), b=bary)


def packet_any_hit_xla(bvh: BVH, o, d, t_max, packet=PACKET, sort=True,
                       sort_key="oct_morton"):
    """Packet occlusion query: early-out per block once every ray in the
    block is occluded or t-limited."""
    n = o.shape[0]
    t_max = jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32)
    if sort:
        perm, inv = ray_sort_perm(o, d, bvh.bounds_lo[0], bvh.bounds_hi[0],
                                  t_max=t_max, key_mode=sort_key)
        o, d, t_max = o[perm], d[perm], t_max[perm]
    b = packet
    n_pad = ((n + b - 1) // b) * b
    nb = n_pad // b

    def pad(x, fill):
        return jnp.concatenate(
            [x, jnp.full((n_pad - n,) + x.shape[1:], fill, x.dtype)])

    op = pad(o, 0.0).reshape(nb, b, 3)
    dp = pad(d, 1.0).reshape(nb, b, 3)
    tm = pad(t_max, -1.0).reshape(nb, b)
    inv_d = 1.0 / jnp.where(jnp.abs(dp) < 1e-20,
                            jnp.where(dp < 0, -1e-20, 1e-20), dp)
    # watertight leaf frame (see packet_closest_hit_xla)
    (wm0, wm1), wshear = _permute_shear(op.reshape(-1, 3), dp.reshape(-1, 3))
    wm0 = wm0.reshape(nb, b)
    wm1 = wm1.reshape(nb, b)
    wsx = wshear[:, 0].reshape(nb, b)
    wsy = wshear[:, 1].reshape(nb, b)
    wsz = wshear[:, 2].reshape(nb, b)
    ox_, oy_, oz_ = op[..., 0], op[..., 1], op[..., 2]

    def cond(c):
        cursor, occ = c
        return jnp.any(cursor >= 0)

    def body(c):
        cursor, occ = c
        active = cursor >= 0
        node = jnp.maximum(cursor, 0)
        lo = bvh.bounds_lo[node][:, None, :]
        hi = bvh.bounds_hi[node][:, None, :]
        np_ = bvh.n_prims[node]
        off = bvh.offset[node]
        miss = bvh.miss[node]
        t0 = (lo - op) * inv_d
        t1 = (hi - op) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1) * (1.0 + 2.0 * 7.2e-7)
        want = (tn <= tf) & (tf > 0) & (tn < tm) & ~occ & active[:, None]
        any_want = jnp.any(want, axis=-1)
        is_leaf = (np_ > 0) & any_want
        is_inner = (np_ == 0) & any_want
        for k in range(LEAF_SIZE):
            ids = bvh.prim_idx[off + k]
            row = bvh.leaf_soa[off + k]
            valid, t, _b0, _b1, _b2 = _watertight_one(
                ox_, oy_, oz_, wm0, wm1, wsx, wsy, wsz, tm,
                (row[:, 0:1], row[:, 1:2], row[:, 2:3]),
                (row[:, 3:4], row[:, 4:5], row[:, 5:6]),
                (row[:, 6:7], row[:, 7:8], row[:, 8:9]))
            occ = occ | (valid & (t < tm)
                         & (is_leaf & (ids >= 0))[:, None])
        all_done = jnp.all(occ | (tm <= 0), axis=-1)
        cursor = jnp.where(is_inner & ~all_done, node + 1, miss)
        cursor = jnp.where(active, jnp.where(all_done, -1, cursor), cursor)
        return cursor, occ

    cursor0 = jnp.zeros((nb,), jnp.int32)
    occ0 = jnp.zeros((nb, b), bool)
    _, occ = jax.lax.while_loop(cond, body, (cursor0, occ0))
    occ = occ.reshape(-1)[:n]
    if sort:
        occ = occ[inv]
    return occ


def bvh_closest_hit(bvh: BVH, verts, tris, o, d, t_max):
    """Lockstep stack traversal, closest hit.  Returns TriHit with pbrt
    barycentric convention b = (1-u-v, u, v)."""
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    dir_neg = (inv_d < 0)  # (N,3)

    class St(NamedTuple):
        cursor: jnp.ndarray
        sp: jnp.ndarray
        stack: jnp.ndarray
        t_best: jnp.ndarray
        best_tri: jnp.ndarray
        best_uv: jnp.ndarray
        found: jnp.ndarray
        active: jnp.ndarray
        step: jnp.ndarray

    st = St(
        cursor=jnp.zeros((n,), jnp.int32),
        sp=jnp.zeros((n,), jnp.int32),
        stack=jnp.zeros((n, MAX_STACK), jnp.int32),
        t_best=jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32),
        best_tri=jnp.zeros((n,), jnp.int32),
        best_uv=jnp.zeros((n, 2), jnp.float32),
        found=jnp.zeros((n,), bool),
        active=jnp.ones((n,), bool),
        step=jnp.zeros((), jnp.int32),
    )

    def cond(st):
        # hard step bound: guarantees termination of the lockstep walk
        # whatever the tree
        return jnp.any(st.active) & (st.step < MAX_TRAV_STEPS)

    def body(st):
        node = st.cursor
        lo = bvh.bounds_lo[node]
        hi = bvh.bounds_hi[node]
        np_ = bvh.n_prims[node]
        off = bvh.offset[node]
        ax = bvh.axis[node]

        box_hit = _slab_test(lo, hi, o, inv_d, st.t_best) & st.active
        is_leaf = (np_ > 0) & box_hit
        is_inner = (np_ == 0) & box_hit

        # leaf: fixed-size masked intersection
        t, valid, ids, uv = _leaf_intersect(verts, tris, bvh.prim_idx, off, o, d,
                                            st.t_best)
        t_m = jnp.where(valid & is_leaf[:, None], t, INFINITY)
        kbest = jnp.argmin(t_m, axis=-1)
        rows = jnp.arange(n)
        t_new = t_m[rows, kbest]
        better = t_new < st.t_best
        t_best = jnp.where(better, t_new, st.t_best)
        best_tri = jnp.where(better, ids[rows, kbest], st.best_tri)
        best_uv = jnp.where(better[:, None], uv[rows, kbest], st.best_uv)
        found = st.found | better

        # inner: near child first by split-axis direction sign
        # (BVHAccel.cpp:672-681): near = node+1, far = offset when dir
        # positive along axis; swapped otherwise.
        take_ax = jnp.take_along_axis(dir_neg, ax[:, None], axis=-1)[:, 0]
        near = jnp.where(take_ax, off, node + 1)
        far = jnp.where(take_ax, node + 1, off)

        # push far where inner, set cursor=near; else pop
        sp = st.sp
        stack = st.stack
        can_push = is_inner & (sp < MAX_STACK)
        stack = jnp.where(
            can_push[:, None] & (jnp.arange(MAX_STACK)[None] == sp[:, None]),
            far[:, None], stack,
        )
        sp = jnp.where(can_push, sp + 1, sp)

        need_pop = st.active & ~is_inner
        empty = sp == 0
        # pop: cursor = stack[sp-1]
        pop_idx = jnp.maximum(sp - 1, 0)
        popped = stack[rows, pop_idx]
        cursor = jnp.where(is_inner, near, jnp.where(need_pop & ~empty, popped, node))
        sp = jnp.where(need_pop & ~empty, sp - 1, sp)
        active = st.active & ~(need_pop & empty)

        return St(cursor, sp, stack, t_best, best_tri, best_uv, found,
                  active, st.step + 1)

    st = jax.lax.while_loop(cond, body, st)
    b = jnp.stack(
        [1.0 - st.best_uv[:, 0] - st.best_uv[:, 1], st.best_uv[:, 0], st.best_uv[:, 1]],
        axis=-1,
    )
    return TriHit(hit=st.found, t=jnp.where(st.found, st.t_best, INFINITY),
                  tri=st.best_tri, b=b)


def bvh_any_hit(bvh: BVH, verts, tris, o, d, t_max):
    """Early-out occlusion query (IntersectP, BVHAccel.cpp:693-729)."""
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    dir_neg = inv_d < 0
    t_max = jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32)

    class St(NamedTuple):
        cursor: jnp.ndarray
        sp: jnp.ndarray
        stack: jnp.ndarray
        occluded: jnp.ndarray
        active: jnp.ndarray
        step: jnp.ndarray

    st = St(
        cursor=jnp.zeros((n,), jnp.int32),
        sp=jnp.zeros((n,), jnp.int32),
        stack=jnp.zeros((n, MAX_STACK), jnp.int32),
        occluded=jnp.zeros((n,), bool),
        active=jnp.ones((n,), bool),
        step=jnp.zeros((), jnp.int32),
    )

    def cond(st):
        return jnp.any(st.active) & (st.step < MAX_TRAV_STEPS)

    def body(st):
        node = st.cursor
        lo = bvh.bounds_lo[node]
        hi = bvh.bounds_hi[node]
        np_ = bvh.n_prims[node]
        off = bvh.offset[node]
        ax = bvh.axis[node]
        box_hit = _slab_test(lo, hi, o, inv_d, t_max) & st.active
        is_leaf = (np_ > 0) & box_hit
        is_inner = (np_ == 0) & box_hit

        t, valid, _, _ = _leaf_intersect(verts, tris, bvh.prim_idx, off, o, d, t_max)
        hit_any = jnp.any(valid & is_leaf[:, None], axis=-1)
        occluded = st.occluded | hit_any

        rows = jnp.arange(n)
        take_ax = jnp.take_along_axis(dir_neg, ax[:, None], axis=-1)[:, 0]
        near = jnp.where(take_ax, off, node + 1)
        far = jnp.where(take_ax, node + 1, off)
        sp = st.sp
        stack = st.stack
        can_push = is_inner & (sp < MAX_STACK)
        stack = jnp.where(
            can_push[:, None] & (jnp.arange(MAX_STACK)[None] == sp[:, None]),
            far[:, None], stack,
        )
        sp = jnp.where(can_push, sp + 1, sp)
        need_pop = st.active & ~is_inner
        empty = sp == 0
        pop_idx = jnp.maximum(sp - 1, 0)
        popped = stack[rows, pop_idx]
        cursor = jnp.where(is_inner, near, jnp.where(need_pop & ~empty, popped, node))
        sp = jnp.where(need_pop & ~empty, sp - 1, sp)
        # lanes stop when stack empties or they're already occluded
        active = st.active & ~occluded & ~(need_pop & empty)
        return St(cursor, sp, stack, occluded, active, st.step + 1)

    st = jax.lax.while_loop(cond, body, st)
    return st.occluded
