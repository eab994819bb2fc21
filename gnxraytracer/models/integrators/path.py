"""Wavefront path integrator.

Accelerator re-design of the reference PathIntegrator
(/root/reference/integrators/PathIntegrator.cpp:62-208): the recursive
per-pixel Li() becomes a bounce loop over a dense SoA ray wavefront —
every lane is one (pixel, sample) path; dead lanes are masked rather than
compacted (compaction via sort comes later as a perf feature).  Estimator
structure matches the reference exactly:

  * emission added at bounce 0 or after a specular bounce
  * NEE via UniformSampleOneLight + EstimateDirect with both MIS strategies
    (light sample + BSDF sample with an extra ray, core/Integrator.cpp:93-210)
  * power-heuristic MIS weights (core/Sampling.h:157)
  * beta *= f |cos| / pdf extension step, etaScale tracking
  * Russian roulette: q = max(.05, 1 - maxComp(beta*etaScale)) when
    maxComp < rrThreshold and bounces > 3 (PathIntegrator.cpp:198-204)

Sample-dimension layout per lane (stateless sampler, ops/samplers.py):
dims 0-4 camera; per bounce b, base = 5 + 8b:
  +0 light select, +1..2 uLight, +3..4 uScattering (NEE BSDF-MIS),
  +5..6 BSDF extension sample, +7 RR.
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ...constants import INFINITY
from ...ops import samplers, trace
from ...ops.sampling import power_heuristic
from ...scene import camera as cam_mod
from ...utils.math import absdot, dot, normalize
from .. import lights as lights_mod
from .. import materials as mat_mod

DIMS_PER_BOUNCE = 8
CAMERA_DIMS = 5


class RenderCfg(NamedTuple):
    """Static (hashable) render configuration — the typed replacement for
    the reference's hardcoded constants (SURVEY.md §5 config audit)."""
    width: int
    height: int
    spp: int
    max_depth: int = 5
    rr_threshold: float = 1.0
    mat_kinds: tuple = ()
    light_kinds: tuple = ()
    # per-light kind sequence (index -> kind), static; lets integrators
    # statically skip zero-contribution lights (e.g. whitted's all-lights
    # loop over a pdf-0 skybox).  Empty when unknown (hand-built configs).
    light_kind_seq: tuple = ()
    n_tris: int = 0
    n_sphs: int = 0
    # big-prim separation (scene.big_tri_idx): count of huge triangles
    # brute-forced outside the BVH; their hit t caps the packet walk
    n_big: int = 0
    n_lights: int = 0
    use_bvh: bool = False
    bvh_stackless: bool = True  # threaded miss-link walk (cursor-only state)
    # "kernel" (GPU traversal kernel, ops/bvh_kernel.py: one ray per lane),
    # "packet" (XLA: shared cursor per 512-ray block + coherence sort),
    # "stackless" (XLA: per-lane cursor), "stack" (XLA: per-lane 64-deep
    # stack).  make_config picks by platform (default_bvh_mode).
    bvh_mode: str = "packet"
    # Coherence-sort key for the packet walks (ops/bvh.ray_sort_perm):
    # "oct_morton" (direction-major) or "morton_oct" (origin-major — the
    # hit-cluster key, for bounce-heavy mesh workloads)
    sort_key: str = "oct_morton"
    reference_area_bug: bool = True
    spp_chunk: int = 4
    light_strategy: str = "uniform"  # uniform | power
    has_media: bool = False
    has_textures: bool = False
    fast_mis: bool = False    # single-extension-ray MIS (2 casts/bounce vs 3)
    # Tail compaction (fast_mis path): after bounce `compact_from`, survivors
    # are compacted into a buffer n//compact_frac wide and the remaining
    # bounces run at that width.  Unbiased: an extra Russian-roulette pass
    # with survival p = min(1, 0.75*M/alive) guarantees (Chernoff) the fixed
    # buffer cannot overflow; when alive <= 0.75*M (the common case) p == 1
    # and the result is bit-identical to the uncompacted loop.
    compact_tail: bool = False
    compact_from: int = 5     # first compacted bounce (> 4 so RR has run)
    compact_frac: int = 8     # tail buffer width = n // compact_frac
    # multi-stage compaction: ((bounce, frac), ...) — re-compact as the
    # wavefront keeps dying (without it the mesh chunk runs bounces 4-8 at
    # a width whose lanes are ~95% dead).  Overrides
    # compact_from/compact_frac when non-empty; each stage is the same
    # unbiased pre-thinning RR.
    compact_stages: tuple = ()
    # Software-pipelined fast-MIS loop (round 4): the extension cast moves
    # to the END of each bounce body, so a compact_stages entry compacts
    # the wavefront BETWEEN a bounce's cast and its shading work — a stage
    # at bounce 0 then runs ALL shading (NEE, texture filtering, material
    # sampling) only on lanes whose camera ray actually hit (49% on the
    # envmesh bench).  Identical estimator; fast_mis only.
    pipeline_casts: bool = False
    has_bump: bool = False    # any material carries a bump texture
    pixel_filter: str = "box"  # box | gaussian (filter importance sampling)
    filter_radius: float = 2.0
    filter_alpha: float = 2.0
    # Count useful scene casts (lanes actually tracing, not dispatch width):
    # trace_paths* then return (L, n_rays) and render_chunk (img, n_rays).
    # Replaces the reference's absent ray accounting and bench.py's old
    # estimate; one scalar reduce per cast per bounce.
    count_rays: bool = False
    # instancing (scene.instanced, ops/instancing.py): instance count and
    # base-mesh triangle count; hit.prim encodes inst * n_inst_tris + tri
    n_inst: int = 0
    n_inst_tris: int = 0
    # Nested-shell shadow transmittance (VisibilityTester::Tr boundary walk,
    # core/Light.cpp:33-53): number of null-boundary segments the volpath
    # shadow rays walk (0 = single-medium fast path).  Each segment costs a
    # scene cast; 4 covers shell-in-shell nesting.
    tr_walk_segments: int = 0
    # VolPath: extra bounce-loop iterations so null-boundary medium
    # transitions do NOT consume path depth — the reference re-loops with
    # bounces-- at null-BSDF vertices (PathIntegrator.cpp:121-126); lanes
    # carry a logical depth counter and the loop runs
    # max_depth+1+vol_null_extra iterations to bound crossings.
    vol_null_extra: int = 3
    # Whitted dual specular recursion (WhittedIntegrator.cpp:56-62): fork
    # into BOTH reflect and transmit branches per depth instead of the
    # stochastic single-branch wavefront (per-sample deterministic — what
    # config-1/2 per-sample parity runs need; cost 2^depth)
    whitted_faithful: bool = False
    # MIPMap filtering for camera-ray texture lookups (bounce 0, where the
    # reference's RayDifferential footprint is valid — spawned rays have
    # hasDifferentials=false and fall back to point samples, exactly as the
    # reference does): "bilinear" | "trilinear" | "ewa"
    # (MIPMap::Lookup, core/MIPMap.h:226,259)
    texture_filter: str = "ewa"

    # -- derived static predicates (python-level, trace-time) -------------
    @property
    def has_point_like(self):
        return 0 in self.light_kinds or 1 in self.light_kinds

    @property
    def has_spot(self):
        return 1 in self.light_kinds

    @property
    def has_distant(self):
        return 2 in self.light_kinds

    @property
    def has_area(self):
        return 3 in self.light_kinds

    @property
    def has_env(self):
        return 4 in self.light_kinds

    @property
    def has_skybox(self):
        return 5 in self.light_kinds


# BVH walk per platform: the traversal kernel on the GPU; the XLA packet
# walk on the CPU, which runs only tests.
_BVH_MODE = {"gpu": "kernel", "cpu": "packet"}


def default_bvh_mode(platform):
    """The BVH walk make_config picks on `platform`; any platform without
    a measured choice is an error, not a silent fallback."""
    if platform not in _BVH_MODE:
        raise ValueError(f"no BVH walk chosen for platform {platform!r} "
                         f"(known: {sorted(_BVH_MODE)})")
    return _BVH_MODE[platform]


def make_config(scene, width, height, spp, **kw):
    """Derive the static kind sets from a built scene (host-side)."""
    import numpy as np

    # mat_kinds from materials actually REFERENCED by geometry, not every
    # table row: the reference app registers a Mirror material the default
    # scene never assigns (ui/RenderThread.cpp:78-103), and dispatching on
    # table kinds made whitted treat the all-matte Cornell as specular
    # (5 full depths instead of 1) and compiled dead lobes everywhere.
    kinds_tab = np.asarray(scene.materials.kind)
    used = np.concatenate([np.asarray(scene.geom.tri_mat),
                           np.asarray(scene.geom.sph_mat)])
    if scene.instanced is not None:
        used = np.concatenate([used, np.asarray(scene.instanced.tri_mat)])
    used = used[used >= 0]
    if used.size:
        mat_kinds = tuple(sorted(set(kinds_tab[used].tolist())))
    else:
        mat_kinds = tuple(sorted(set(kinds_tab.tolist())))
    light_kinds = tuple(sorted(set(np.asarray(scene.lights.kind).tolist())))
    # Brute force below 32,768 triangles, the BVH above: the threshold
    # dates from the lockstep XLA walks, whose every step gathers node
    # rows for all lanes; it is not re-measured against the GPU kernel
    # yet (ROADMAP A6).  Override with use_bvh in kw.
    kw.setdefault("use_bvh", scene.bvh is not None
                  and int(scene.geom.triangles.shape[0]) > 32768)
    if scene.media is not None:
        # scenes with participating media need the full VisibilityTester::Tr
        # boundary walk (core/Light.cpp:33-53): without it, shadow rays
        # treat null-material medium shells as opaque occluders (measured
        # -6% systematic bias on the volpath parity scene, PARITY.md r3)
        kw.setdefault("tr_walk_segments", 4)
    if kw.get("use_bvh") and "bvh_mode" not in kw:
        kw["bvh_mode"] = default_bvh_mode(jax.default_backend())
    return RenderCfg(
        width=width, height=height, spp=spp,
        mat_kinds=mat_kinds, light_kinds=light_kinds,
        light_kind_seq=tuple(np.asarray(scene.lights.kind).tolist()),
        n_tris=int(scene.geom.triangles.shape[0]),
        n_sphs=int(scene.geom.sph_center.shape[0]),
        n_big=(0 if scene.big_tri_idx is None
               else int(scene.big_tri_idx.shape[0])),
        n_lights=int(scene.lights.kind.shape[0]),
        has_media=scene.media is not None,
        has_textures=scene.textures is not None,
        has_bump=bool(scene.textures is not None
                      and (np.asarray(scene.materials.bump_tex) >= 0).any()),
        n_inst=(0 if scene.instanced is None
                else int(scene.instanced.obj_to_world.shape[0])),
        n_inst_tris=(0 if scene.instanced is None
                     else int(scene.instanced.tris.shape[0])),
        **kw,
    )


# ---------------------------------------------------------------------------
# Direct lighting (UniformSampleOneLight + EstimateDirect)
# ---------------------------------------------------------------------------

def _choose_light(scene, cfg, u, p=None):
    """Light selection by the configured strategy (the reference's
    LightDistribution, core/LightDistribution.cpp):
      uniform — 1/nLights (core/Integrator.cpp:66-70)
      power   — proportional to Light::Power().y()
      spatial — per-voxel precomputed CDF (needs scene.light_dist; falls
                back to power when absent or p not given)
    """
    nl = cfg.n_lights
    if cfg.light_strategy == "spatial" and scene.light_dist is not None and p is not None:
        from ..light_dist import spatial_choose_light

        return spatial_choose_light(scene.light_dist, p, u)
    if cfg.light_strategy in ("power", "spatial"):
        pmf = _power_pmf(scene, nl)
        cdf = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(pmf)])
        idx = jnp.clip(
            jnp.sum((cdf <= u[:, None]).astype(jnp.int32), axis=1) - 1, 0, nl - 1
        )
        return idx.astype(jnp.int32), pmf[idx]
    idx = jnp.minimum((u * nl).astype(jnp.int32), nl - 1)
    pdf = jnp.full(u.shape, 1.0 / nl, jnp.float32)
    return idx, pdf


def _power_pmf(scene, nl):
    """Power-strategy pmf: precomputed at scene build (scene.light_pmf,
    mirroring the reference's one-time Preprocess LightDistribution build);
    falls back to recomputing for hand-constructed Scene values."""
    if scene.light_pmf is not None:
        return scene.light_pmf
    from ..light_dist import light_powers

    pw = light_powers(scene)
    total = jnp.sum(pw)
    return jnp.where(total > 0, pw / jnp.maximum(total, 1e-12),
                     jnp.full((nl,), 1.0 / nl))


def estimate_direct(scene, cfg, it, wo_local, u_light, u_scatter, light_idx,
                    kd_override=None, mats_row=None, vis_fn=None, mask=None):
    """EstimateDirect (core/Integrator.cpp:93-210) for all lanes at once.

    mats_row: optional pre-gathered per-lane MaterialTable (one one-hot
    matmul per bounce instead of per-column gathers).
    vis_fn: optional (o, d, t_max) -> (occluded (N,), tr (N,3)) replacing
    the binary shadow query — VolPath's handleMedia=true
    VisibilityTester::Tr path (core/Integrator.cpp:148-155).
    mask: optional (N,) bool — lanes whose NEE result will actually be
    used; the two scene casts get t_max = 0 outside it, so the packet
    walks skip those lanes entirely (the caller's downstream where-mask
    makes the values themselves irrelevant).
    Returns (N,3) direct radiance (before division by light-select pdf).
    """
    n = it.p.shape[0]
    if mats_row is None:
        mats_row = scene.materials
        mat_idx = it.mat
    else:
        mat_idx = None
    ld = jnp.zeros((n, 3), jnp.float32)

    # ---- strategy 1: sample the light ------------------------------------
    ls = lights_mod.sample_li(scene, cfg, light_idx, it.p, u_light)
    wi_local = trace.to_local(it, ls.wi)
    f_light, scat_pdf = mat_mod.evaluate(mats_row, mat_idx, cfg, wo_local,
                                         wi_local, kd_override)
    f_light = f_light * absdot(ls.wi, it.ns)[..., None]
    contrib_possible = (ls.pdf > 0) & jnp.any(ls.li > 0, axis=-1) & jnp.any(f_light > 0, axis=-1)
    if mask is not None:
        contrib_possible = contrib_possible & mask
    # visibility (shadow ray) only where it can matter
    so, sd, st = trace.shadow_ray(it, ls.target, ls.is_infinite)
    st = jnp.where(contrib_possible, st, 0.0)
    if vis_fn is not None:
        occluded, tr_vis = vis_fn(so, sd, st)
    else:
        occluded = trace.scene_occluded(scene, cfg, so, sd, st)
        tr_vis = None
    vis = contrib_possible & ~occluded
    w_l = jnp.where(
        ls.is_delta, 1.0, power_heuristic(1.0, ls.pdf, 1.0, scat_pdf)
    )
    ld_light = f_light * ls.li * (w_l / jnp.maximum(ls.pdf, 1e-12))[..., None]
    if tr_vis is not None:
        ld_light = ld_light * tr_vis
    ld = ld + jnp.where(vis[..., None], ld_light, 0.0)

    # ---- strategy 2: sample the BSDF (non-delta lights only) --------------
    smp = mat_mod.sample(mats_row, mat_idx, cfg, wo_local, u_scatter,
                         u_scatter[..., 0], kd_override)
    wi_world = trace.to_world(it, smp.wi)
    f_b = smp.f * absdot(wi_world, it.ns)[..., None]
    do_bsdf = (~ls.is_delta) & smp.valid & (smp.pdf > 0) & (
        jnp.any(f_b > 0, axis=-1) | smp.specular
    )
    l_pdf = lights_mod.pdf_li(scene, cfg, light_idx, it.p, wi_world)
    w_b = jnp.where(smp.specular, 1.0, power_heuristic(1.0, smp.pdf, 1.0, l_pdf))
    # specular lanes: EstimateDirect uses f from Sample_f directly; our
    # specular weight already folds pdf, so reconstruct f*cos/pdf:
    contrib_scale = jnp.where(
        smp.specular[..., None], smp.weight, f_b / jnp.maximum(smp.pdf, 1e-12)[..., None]
    )
    w_b = jnp.where(do_bsdf & ((l_pdf > 0) | smp.specular), w_b, 0.0)
    # trace the BSDF-sampled ray; add only if it hits *this* light (or the
    # light is infinite and the ray escapes)
    bo, bd = trace.spawn_ray(it, wi_world)
    bhit_relevant = do_bsdf if mask is None else (do_bsdf & mask)
    bhit = trace.scene_intersect(scene, cfg, bo, bd,
                                 jnp.where(bhit_relevant, INFINITY, 0.0))
    li_b = jnp.zeros((n, 3), jnp.float32)
    if cfg.has_area:
        hit_it_light = bhit.hit & (bhit.kind == trace.PRIM_TRI)
        p0, p1, p2, tri_light = trace.tri_emission_attrs(
            scene, cfg, jnp.where(hit_it_light, bhit.prim, 0))
        tri_light = jnp.where(hit_it_light, tri_light, -1)
        same_light = hit_it_light & (tri_light == light_idx)
        # emitted radiance toward -wi
        nl = normalize(jnp.cross(p1 - p0, p2 - p0))
        le = lights_mod.area_light_emitted(scene, light_idx, nl, -bd,
                                           cfg.reference_area_bug)
        li_b = jnp.where(same_light[..., None], le, li_b)
    if cfg.has_skybox or cfg.has_env:
        escaped = ~bhit.hit
        lkind = scene.lights.kind[light_idx]
        if cfg.has_skybox:
            # reference: Li = light.Le(ray) — the gradient fallback — even
            # though the skybox's Sample_Li side is black
            m = escaped & (lkind == 5)
            li_b = jnp.where(m[..., None],
                             lights_mod.skybox_le(scene, bo, bd), li_b)
        if cfg.has_env:
            m = escaped & (lkind == 4)
            li_b = jnp.where(m[..., None], lights_mod.envmap_le(scene, bd), li_b)
    ld = ld + contrib_scale * li_b * w_b[..., None]
    return ld


# ---------------------------------------------------------------------------
# The bounce loop
# ---------------------------------------------------------------------------

def _resolve_kd_hit(scene, cfg, hit, it, rd, mats_row=None):
    """Per-hit base color; with camera differentials (rd, bounce 0 only)
    the uv footprint feeds the filtered MIPMap lookup — the wiring of
    ComputeDifferentials (core/Interaction.cpp:65) into
    ImageTexture::Evaluate that the reference does per camera ray."""
    if not cfg.has_textures:
        return None
    mid = None if mats_row is not None else it.mat
    if rd is None or cfg.texture_filter == "bilinear":
        return mat_mod.resolve_kd(scene, cfg, mid, it.uv, mats=mats_row)
    dpdu, dpdv = trace.triangle_dpduv(scene, hit)
    duvdx, duvdy = trace.compute_differentials(it.p, it.ns, dpdu, dpdv, rd)
    return mat_mod.resolve_kd(scene, cfg, mid, it.uv, mats=mats_row,
                              duv=(duvdx, duvdy))


def _make_faithful_bounce(scene, cfg: RenderCfg, get_ub, n, rd=None):
    """Per-bounce body of the reference-faithful estimator (3 scene casts
    per bounce: closest hit + NEE shadow + NEE BSDF-side re-intersection,
    exactly EstimateDirect's structure, core/Integrator.cpp:93-210).
    Same dict-state layout as _make_fast_bounce so the compaction runner
    is shared; prev_pdf/prev_p are carried but unused here."""

    def bounce(b, state):
        ub = get_ub(b)
        # dead lanes cast with t_max = 0: the packet walks sort them to the
        # end and their blocks terminate at the root in one step, so a cast
        # costs ~(alive fraction) of full width
        hit = trace.scene_intersect(scene, cfg, state["o"], state["d"],
                                    jnp.where(state["alive"], INFINITY, 0.0))
        it = trace.make_interaction(scene, cfg, state["o"], state["d"], hit)

        L = state["L"]
        # emission at path vertex (bounce 0 or after specular)
        emit_ok = state["alive"] & ((b == 0) | state["specular"])
        if cfg.has_area:
            is_emitter = hit.hit & (hit.kind == trace.PRIM_TRI) & (it.light >= 0)
            le = lights_mod.area_light_emitted(
                scene, jnp.maximum(it.light, 0), it.ng, -state["d"],
                cfg.reference_area_bug,
            )
            add = emit_ok & is_emitter
            L = L + jnp.where(add[..., None], state["beta"] * le, 0.0)
        if cfg.has_skybox or cfg.has_env:
            esc = emit_ok & ~hit.hit
            le_inf = lights_mod.escaped_radiance(scene, cfg, state["o"], state["d"])
            L = L + jnp.where(esc[..., None], state["beta"] * le_inf, 0.0)

        alive = state["alive"] & hit.hit & (b < cfg.max_depth)

        # NEE (skip for perfectly specular BSDFs, PathIntegrator.cpp:138)
        wo_local = trace.to_local(it, it.wo)
        # one one-hot matmul fetches every material column for the bounce
        # (instead of ~10 per-lane gathers; ROADMAP A4 times it)
        mats_row = mat_mod.gather_material_table(scene.materials,
                                                 jnp.maximum(it.mat, 0))
        has_ns = mat_mod.has_nonspecular(mats_row, None, cfg)
        u_sel = ub[:, 0]
        u_light = ub[:, 1:3]
        u_scat = ub[:, 3:5]
        light_idx, light_pdf = _choose_light(scene, cfg, u_sel, it.p)
        kd_ov = _resolve_kd_hit(scene, cfg, hit, it, rd, mats_row)
        nee_ok = alive & has_ns
        ld = estimate_direct(scene, cfg, it, wo_local, u_light, u_scat, light_idx,
                             kd_ov, mats_row=mats_row, mask=nee_ok)
        L = L + jnp.where(
            nee_ok[..., None],
            state["beta"] * ld / jnp.maximum(light_pdf, 1e-12)[..., None],
            0.0,
        )

        # extension: sample the BSDF
        u_bsdf = ub[:, 5:7]
        smp = mat_mod.sample(mats_row, None, cfg, wo_local, u_bsdf,
                             u_bsdf[..., 0], kd_ov)
        beta = state["beta"] * smp.weight
        alive = alive & smp.valid & jnp.any(beta > 0, axis=-1)
        # etaScale update for specular transmission (PathIntegrator.cpp:161)
        entering = dot(it.wo, it.ng) > 0
        es_update = jnp.where(entering, smp.eta * smp.eta,
                              1.0 / jnp.maximum(smp.eta * smp.eta, 1e-12))
        eta_scale = jnp.where(
            smp.specular & smp.transmission, state["eta_scale"] * es_update,
            state["eta_scale"],
        )

        wi_world = trace.to_world(it, smp.wi)
        no, nd = trace.spawn_ray(it, wi_world)

        # Russian roulette (PathIntegrator.cpp:198-204).  q MUST be
        # detached: it is a function of the attached beta, and AD cannot
        # see the survival indicator's matching boundary term, so an
        # attached 1/(1-q) reweight biases d(image)/d(params) (measured
        # -12% on d/d(kd) vs the reference's FD at depth 8; exact match
        # with RR off or q detached — PARITY.md r3).
        rr_beta_max = jax.lax.stop_gradient(
            jnp.max(beta * eta_scale[..., None], axis=-1))
        do_rr = (rr_beta_max < cfg.rr_threshold) & (b > 3)
        q = jnp.maximum(0.05, 1.0 - rr_beta_max)
        u_rr = ub[:, 7]
        killed = do_rr & (u_rr < q)
        beta = jnp.where(
            (do_rr & ~killed)[..., None],
            beta / jnp.maximum(1.0 - q, 1e-6)[..., None], beta,
        )
        alive = alive & ~killed

        out = dict(
            o=jnp.where(alive[..., None], no, state["o"]),
            d=jnp.where(alive[..., None], nd, state["d"]),
            beta=jnp.where(alive[..., None], beta, state["beta"]),
            L=L,
            alive=alive,
            specular=jnp.where(alive, smp.specular, state["specular"]),
            eta_scale=jnp.where(alive, eta_scale, state["eta_scale"]),
            prev_pdf=state["prev_pdf"],
            prev_p=state["prev_p"],
        )
        if cfg.count_rays:
            # 1 closest-hit cast per alive-at-entry lane; EstimateDirect's
            # shadow ray + BSDF-side re-intersection for NEE candidates
            out["nrays"] = (state["nrays"]
                            + jnp.sum(state["alive"].astype(jnp.float32))
                            + 2.0 * jnp.sum(nee_ok.astype(jnp.float32)))
        return out

    return bounce


def trace_paths(scene, cfg: RenderCfg, sampler, pixel, sample, o, d, rd=None):
    """Reference-faithful wavefront path tracing (3 casts/bounce).
    Returns (N,3) radiance, or ((N,3), n_rays) when cfg.count_rays."""
    return _trace_loop(scene, cfg, sampler, pixel, sample, o, d,
                       _make_faithful_bounce, rd=rd)


# ---------------------------------------------------------------------------
# Fast-MIS variant: one extension + one shadow cast per bounce
# ---------------------------------------------------------------------------

def _hit_light_select_pdf(scene, cfg, light_idx):
    """P(select light_idx) under the configured strategy."""
    nl = cfg.n_lights
    if cfg.light_strategy in ("power", "spatial"):
        return _power_pmf(scene, nl)[light_idx]
    return jnp.full(light_idx.shape, 1.0 / nl, jnp.float32)


def _fast_parts(scene, cfg: RenderCfg, get_ub, n, rd=None):
    """The fast-MIS bounce body split into its three phases so the
    pipelined runner (_trace_loop_pipelined) can compact the wavefront
    BETWEEN the cast and the shading work:

      cast(state)          -> Hit          (packet walk; alive-width cost)
      emit(b, state, hit)  -> (N,3) L add  (emission/escape with MIS — must
                                            run at FULL width: escaped
                                            lanes die right after)
      work(b, state, hit)  -> state'       (interaction + NEE + extension
                                            sample + RR — survivors only)

    _make_fast_bounce composes them into the classic monolithic body; the
    math is identical either way."""

    def cast(state):
        # dead lanes cast with t_max = 0: the packet walks sort them to the
        # end and their blocks terminate at the root in one step, so a cast
        # costs ~(alive fraction) of full width
        return trace.scene_intersect(scene, cfg, state["o"], state["d"],
                                     jnp.where(state["alive"], INFINITY, 0.0))

    def emit(b, state, hit, it=None):
        """Emission/escape contribution of the vertex `hit` (MIS-weighted
        against the previous bounce's BSDF pdf).  `it` is passed by the
        classic body (which has it anyway); the pipelined runner passes
        None and the area block gathers the two fields it needs."""
        m = hit.t.shape[0]
        L = jnp.zeros((m, 3), jnp.float32)

        if cfg.has_area:
            if it is not None:
                light_id, ng = it.light, it.ng
            else:
                light_id, ng = trace.tri_light_and_ng(scene, cfg, hit)
            is_emitter = hit.hit & (hit.kind == trace.PRIM_TRI) & (light_id >= 0)
            lidx = jnp.maximum(light_id, 0)
            le = lights_mod.area_light_emitted(scene, lidx, ng, -state["d"],
                                               cfg.reference_area_bug)
            # pdf of having sampled this emission point via NEE from prev_p
            lrow = lights_mod.light_rows(scene, lidx)
            p0v, p1v, p2v = lrow.p0, lrow.p1, lrow.p2
            cr = jnp.cross(p1v - p0v, p2v - p0v)
            area = 0.5 * jnp.sqrt(jnp.maximum(jnp.sum(cr * cr, -1), 1e-20))
            nl_ = cr / jnp.maximum(2.0 * area, 1e-12)[..., None]
            dist2 = jnp.maximum(hit.t * hit.t, 1e-12)
            cos_l = jnp.abs(dot(nl_, -state["d"]))
            pdf_area = dist2 / jnp.maximum(cos_l * area, 1e-12)
            # NOTE: no light-select pmf here — pbrt's per-light MIS family
            # (selection is unbiased by the NEE /selectPdf division)
            w = jnp.where(
                state["specular"], 1.0,
                power_heuristic(1.0, state["prev_pdf"], 1.0, pdf_area),
            )
            L = L + jnp.where((state["alive"] & is_emitter)[..., None],
                              state["beta"] * le * w[..., None], 0.0)
        if cfg.has_skybox or cfg.has_env:
            esc = state["alive"] & ~hit.hit
            if cfg.has_env and not cfg.has_skybox:
                # fused Le + Pdf_Li: one packed gather + one trig pass
                # (round 5; see lights.envmap_le_pdf)
                le_inf, env_pdf = lights_mod.envmap_le_pdf(scene,
                                                           state["d"])
                w = jnp.where(
                    state["specular"], 1.0,
                    power_heuristic(1.0, state["prev_pdf"], 1.0, env_pdf),
                )
            elif cfg.has_env:
                le_inf = lights_mod.escaped_radiance(scene, cfg,
                                                     state["o"], state["d"])
                # MIS against env importance sampling
                env_rows = scene.lights.kind == 4
                env_idx = jnp.argmax(env_rows).astype(jnp.int32)
                lidx = jnp.full((m,), env_idx, jnp.int32)
                env_pdf = lights_mod.pdf_li(scene, cfg, lidx, state["o"], state["d"])
                w = jnp.where(
                    state["specular"], 1.0,
                    power_heuristic(1.0, state["prev_pdf"], 1.0, env_pdf),
                )
            else:
                # skybox: SkyBoxLight::Pdf_Li == 0 (SkyBoxLight.h:37) makes
                # the reference's EstimateDirect DROP the BSDF-side sample
                # ("if (lightPdf == 0) return Ld", core/Integrator.cpp:186).
                # The skybox therefore only ever reaches the image through
                # the bounce-0/specular escape path — weight 0 on
                # non-specular escapes, exactly like the reference.
                le_inf = lights_mod.escaped_radiance(scene, cfg,
                                                     state["o"], state["d"])
                w = jnp.where(state["specular"], 1.0, 0.0)
            L = L + jnp.where(esc[..., None],
                              state["beta"] * le_inf * w[..., None], 0.0)
        return L

    def work(b, state, hit, it=None, count_cast=True):
        if it is None:
            it = trace.make_interaction(scene, cfg, state["o"], state["d"],
                                        hit)
        ub = get_ub(b)
        L = state["L"]
        alive = state["alive"] & hit.hit & (b < cfg.max_depth)

        # ---- NEE: light-sample strategy only -------------------------------
        wo_local = trace.to_local(it, it.wo)
        mats_row = mat_mod.gather_material_table(scene.materials,
                                                 jnp.maximum(it.mat, 0))
        has_ns = mat_mod.has_nonspecular(mats_row, None, cfg)
        u_sel = ub[:, 0]
        u_light = ub[:, 1:3]
        light_idx, light_pdf_sel = _choose_light(scene, cfg, u_sel, it.p)
        kd_ov = _resolve_kd_hit(scene, cfg, hit, it, rd, mats_row)
        ls = lights_mod.sample_li(scene, cfg, light_idx, it.p, u_light)
        wi_local = trace.to_local(it, ls.wi)
        f_l, scat_pdf = mat_mod.evaluate(mats_row, None, cfg, wo_local,
                                         wi_local, kd_ov)
        f_l = f_l * absdot(ls.wi, it.ns)[..., None]
        can = (ls.pdf > 0) & jnp.any(ls.li > 0, -1) & jnp.any(f_l > 0, -1)
        so, sd, st = trace.shadow_ray(it, ls.target, ls.is_infinite)
        # shadow cast only where the NEE sample can contribute (dead/zero
        # lanes get t_max = 0 and cost nothing in the packet walks)
        occ = trace.scene_occluded(scene, cfg, so, sd,
                                   jnp.where(alive & has_ns & can, st, 0.0))
        w_l = jnp.where(ls.is_delta, 1.0,
                        power_heuristic(1.0, ls.pdf, 1.0, scat_pdf))
        ld = f_l * ls.li * (w_l / jnp.maximum(ls.pdf, 1e-12))[..., None]
        nee_ok = alive & has_ns & can & ~occ
        L = L + jnp.where(
            nee_ok[..., None],
            state["beta"] * ld / jnp.maximum(light_pdf_sel, 1e-12)[..., None],
            0.0,
        )

        # ---- extension ------------------------------------------------------
        u_bsdf = ub[:, 5:7]
        smp = mat_mod.sample(mats_row, None, cfg, wo_local, u_bsdf,
                             u_bsdf[..., 0], kd_ov)
        beta = state["beta"] * smp.weight
        alive = alive & smp.valid & jnp.any(beta > 0, axis=-1)
        entering = dot(it.wo, it.ng) > 0
        es_up = jnp.where(entering, smp.eta * smp.eta,
                          1.0 / jnp.maximum(smp.eta * smp.eta, 1e-12))
        eta_scale = jnp.where(smp.specular & smp.transmission,
                              state["eta_scale"] * es_up, state["eta_scale"])
        wi_world = trace.to_world(it, smp.wi)
        no, nd = trace.spawn_ray(it, wi_world)

        # ---- RR (q detached — see the faithful estimator's RR comment) ------
        rr_max = jax.lax.stop_gradient(
            jnp.max(beta * eta_scale[..., None], axis=-1))
        do_rr = (rr_max < cfg.rr_threshold) & (b > 3)
        q = jnp.maximum(0.05, 1.0 - rr_max)
        u_rr = ub[:, 7]
        killed = do_rr & (u_rr < q)
        beta = jnp.where((do_rr & ~killed)[..., None],
                         beta / jnp.maximum(1.0 - q, 1e-6)[..., None], beta)
        alive = alive & ~killed

        out = dict(
            o=jnp.where(alive[..., None], no, state["o"]),
            d=jnp.where(alive[..., None], nd, state["d"]),
            beta=jnp.where(alive[..., None], beta, state["beta"]),
            L=L,
            alive=alive,
            specular=jnp.where(alive, smp.specular, state["specular"]),
            eta_scale=jnp.where(alive, eta_scale, state["eta_scale"]),
            prev_pdf=jnp.where(alive, jnp.maximum(smp.pdf, 1e-12), state["prev_pdf"]),
            prev_p=jnp.where(alive[..., None], it.p, state["prev_p"]),
        )
        if cfg.count_rays:
            # 1 closest-hit cast per alive-at-entry lane (counted here in
            # the classic body; the pipelined runner counts casts at its
            # own cast sites) + 1 shadow cast per NEE candidate
            # (folded-MIS: the extension ray IS the BSDF-side MIS sample,
            # so no third cast)
            out["nrays"] = (state["nrays"]
                            + (jnp.sum(state["alive"].astype(jnp.float32))
                               if count_cast else 0.0)
                            + jnp.sum((alive & has_ns & can).astype(jnp.float32)))
        return out

    return cast, emit, work


def _make_fast_bounce(scene, cfg: RenderCfg, get_ub, n, rd=None):
    """Build the classic monolithic per-bounce body of the fast-MIS loop
    from the split phases.  get_ub(b) returns the (n, DIMS_PER_BOUNCE)
    sample dims for bounce b — either a slice of a precomputed matrix
    (halton) or computed in-loop (sobol/random)."""
    cast, emit, work = _fast_parts(scene, cfg, get_ub, n, rd=rd)

    def bounce(b, state):
        hit = cast(state)
        it = trace.make_interaction(scene, cfg, state["o"], state["d"], hit)
        state = dict(state, L=state["L"] + emit(b, state, hit, it=it))
        return work(b, state, hit, it=it)

    return bounce


def trace_paths_fast(scene, cfg: RenderCfg, sampler, pixel, sample, o, d,
                     rd=None):
    """Path tracing with the folded-MIS estimator: the extension ray doubles
    as the NEE BSDF-side MIS sample — emission found by the extension ray is
    weighted by PowerHeuristic(bsdf_pdf, light_pdf) instead of spawning the
    reference's third per-bounce ray (core/Integrator.cpp:159-207).  Same
    expectation, ~1/3 fewer scene casts and one fewer BSDF sample/bounce."""
    if getattr(cfg, "pipeline_casts", False):
        return _trace_loop_pipelined(scene, cfg, sampler, pixel, sample,
                                     o, d, rd=rd)
    return _trace_loop(scene, cfg, sampler, pixel, sample, o, d,
                       _make_fast_bounce, rd=rd)


def _prethin_p(alive, m):
    """Pre-thinning RR survival probability for a compaction into an
    m-slot buffer: p = min(1, (m - 4*sqrt(m)) / alive).  Unbiased (beta/p);
    E[kept] <= m - 4*sqrt(m) puts overflow tens of sigmas out (kept is
    Binomial, std <= sqrt(m)/2), and p == 1 — a bit-identical no-op — in
    the common case where the survivors already fit with that margin.
    (Round 4: the old 0.75*m target thinned 23% of lanes when compacting
    right after the camera cast at 49% occupancy into a half-width
    buffer.)"""
    alive_count = jnp.sum(alive.astype(jnp.float32))
    margin = m - 4.0 * float(m) ** 0.5
    return jnp.minimum(1.0, margin / jnp.maximum(alive_count, 1.0))


def _trace_loop(scene, cfg: RenderCfg, sampler, pixel, sample, o, d,
                make_bounce, rd=None):
    """Shared bounce-loop runner for both estimators.

    With cfg.compact_tail: Russian roulette (PathIntegrator.cpp:198-204)
    leaves only a few percent of lanes alive past bounce 4 (measured 2.1%
    on the Cornell bench), so the full-width loop wastes ~45% of its work
    on dead lanes.  Survivors are compacted into an n//compact_frac buffer
    after bounce `compact_from` and the tail bounces run at that width;
    radiance is scattered back at the end.

    Returns (N,3) radiance, or ((N,3), n_rays) when cfg.count_rays (n_rays
    = useful scene casts: lanes actually tracing, not dispatch width)."""
    n = o.shape[0]
    n_dims = CAMERA_DIMS + DIMS_PER_BOUNCE * (cfg.max_depth + 1)
    stages = (tuple(cfg.compact_stages) if cfg.compact_stages
              else ((cfg.compact_from, cfg.compact_frac),))
    stages = tuple((b, f) for b, f in stages
                   if b <= cfg.max_depth and n % f == 0 and n // f >= 256)
    # widths must strictly shrink stage to stage
    widths, last = [], n
    keep = []
    for b, f in stages:
        m = n // f
        if m < last:
            keep.append((b, f))
            last = m
    stages = tuple(keep)
    do_compact = cfg.compact_tail and bool(stages)
    n_dims_tot = n_dims + (len(stages) if do_compact else 0)
    inloop = samplers.supports_inloop_dims(sampler)
    if inloop:
        # dims computed inside the bounce loop: no (N, D) sample matrix in
        # device memory (at 1M lanes that matrix is ~300 MB of traffic)
        U = None

        def make_get_ub(pix, smp):
            def get_ub(b):
                base = CAMERA_DIMS + b * DIMS_PER_BOUNCE
                return samplers.sample_bounce_dims(
                    sampler, pix, smp, base, DIMS_PER_BOUNCE, n_dims_tot)
            return get_ub

        get_ub = make_get_ub(pixel, sample)
    else:
        U = samplers.sample_all_dims(sampler, pixel, sample, n_dims_tot)

        def get_ub(b):
            return jax.lax.dynamic_slice(
                U, (jnp.int32(0), CAMERA_DIMS + b * DIMS_PER_BOUNCE),
                (n, DIMS_PER_BOUNCE))

    state = dict(
        o=o, d=d,
        beta=jnp.ones((n, 3), jnp.float32),
        L=jnp.zeros((n, 3), jnp.float32),
        alive=jnp.ones((n,), bool),
        specular=jnp.ones((n,), bool),  # bounce 0 counts as specular
        eta_scale=jnp.ones((n,), jnp.float32),
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_p=o,
    )
    if cfg.count_rays:
        state["nrays"] = jnp.zeros((), jnp.float32)
    bounce = make_bounce(scene, cfg, get_ub, n)
    # bounce 0 peeled out when camera differentials drive a filtered texture
    # lookup (only camera rays carry a valid footprint — spawned rays have
    # hasDifferentials=false in the reference and fall back to bilinear)
    peel0 = (rd is not None and cfg.has_textures
             and cfg.texture_filter != "bilinear")
    if peel0:
        bounce0 = make_bounce(scene, cfg, get_ub, n, rd=rd)
        state = bounce0(jnp.int32(0), state)
    b_start = 1 if peel0 else 0
    if not do_compact:
        state = jax.lax.fori_loop(b_start, cfg.max_depth + 1, bounce, state)
        if cfg.count_rays:
            return state["L"], state["nrays"]
        return state["L"]

    # --- multi-stage compaction: run to each stage bounce, pre-thin (RR,
    # unbiased) survivors into an n//frac buffer, continue; scatter the
    # partial radiances back through the composed source maps at the end.
    cur_pixel, cur_sample, cur_U = pixel, sample, U
    b_prev = b_start
    outer = []  # (L_at_this_width, src, valid) per stage
    for si, (cb, frac) in enumerate(stages):
        state = jax.lax.fori_loop(b_prev, cb, bounce, state)
        b_prev = cb
        n_cur = state["o"].shape[0]
        m = n // frac
        alive = state["alive"]
        p_keep = _prethin_p(alive, m)
        if inloop:
            u_thin = samplers.sample_bounce_dims(
                sampler, cur_pixel, cur_sample, jnp.int32(n_dims + si), 1,
                n_dims_tot)[:, 0]
        else:
            u_thin = cur_U[:, n_dims + si]
        kept = alive & (u_thin < p_keep)
        beta = state["beta"] / p_keep
        slots = jnp.cumsum(kept.astype(jnp.int32)) - 1
        lane_id = jnp.arange(n_cur, dtype=jnp.int32)
        src = jnp.zeros((m,), jnp.int32).at[
            jnp.where(kept, slots, m)].set(lane_id, mode="drop")
        kept_count = jnp.sum(kept.astype(jnp.int32))
        valid = jnp.arange(m, dtype=jnp.int32) < kept_count
        outer.append((state["L"], src, valid))
        nrays_carry = state.get("nrays")
        state = dict(
            o=state["o"][src], d=state["d"][src],
            beta=beta[src],
            L=jnp.zeros((m, 3), jnp.float32),
            alive=valid,
            specular=state["specular"][src],
            eta_scale=state["eta_scale"][src],
            prev_pdf=state["prev_pdf"][src],
            prev_p=state["prev_p"][src],
        )
        if cfg.count_rays:
            state["nrays"] = nrays_carry  # scalar: carries across widths
        cur_pixel, cur_sample = cur_pixel[src], cur_sample[src]
        if inloop:
            get_ub = make_get_ub(cur_pixel, cur_sample)
        else:
            cur_U = cur_U[src]

            def get_ub(b, _U=cur_U, _m=m):
                return jax.lax.dynamic_slice(
                    _U, (jnp.int32(0), CAMERA_DIMS + b * DIMS_PER_BOUNCE),
                    (_m, DIMS_PER_BOUNCE))

        bounce = make_bounce(scene, cfg, get_ub, m)
    state = jax.lax.fori_loop(b_prev, cfg.max_depth + 1, bounce, state)
    L = state["L"]
    for L_outer, src, valid in reversed(outer):
        L = L_outer.at[src].add(jnp.where(valid[..., None], L, 0.0))
    if cfg.count_rays:
        return L, state["nrays"]
    return L


def _trace_loop_pipelined(scene, cfg: RenderCfg, sampler, pixel, sample,
                          o, d, rd=None):
    """Software-pipelined fast-MIS runner (cfg.pipeline_casts).

    Each iteration runs emit(b) -> work(b) -> cast(b+1), so a
    compact_stages entry (b, frac) compacts the wavefront AFTER bounce b's
    cast + emission but BEFORE its shading work: a stage at bounce 0 runs
    all NEE/texture/material shading only on camera rays that actually hit
    (49% of the envmesh bench), and later stages shrink each bounce's
    shading width the moment its cast resolves instead of one bounce
    later.  Identical estimator math to _trace_loop: the same sample dims
    feed the same computations, only dispatch widths differ (and the
    pre-thin p hits 1 on every bench stage, making results bit-identical).
    """
    n = o.shape[0]
    n_dims = CAMERA_DIMS + DIMS_PER_BOUNCE * (cfg.max_depth + 1)
    stages = (tuple(cfg.compact_stages) if cfg.compact_stages
              else ((cfg.compact_from, cfg.compact_frac),))
    stages = tuple((b, f) for b, f in stages
                   if b <= cfg.max_depth and n % f == 0 and n // f >= 256)
    widths, last, last_b, keep = [], n, -1, []
    for b, f in stages:
        m = n // f
        if m < last and b > last_b:
            keep.append((b, f))
            last, last_b = m, b
    stages = tuple(keep)
    do_compact = cfg.compact_tail and bool(stages)
    if not do_compact:
        return _trace_loop(scene, cfg, sampler, pixel, sample, o, d,
                           _make_fast_bounce, rd=rd)
    n_dims_tot = n_dims + len(stages)
    inloop = samplers.supports_inloop_dims(sampler)

    def make_get_ub(pix, smp, u_mat, m):
        if inloop:
            def get_ub(b):
                base = CAMERA_DIMS + b * DIMS_PER_BOUNCE
                return samplers.sample_bounce_dims(
                    sampler, pix, smp, base, DIMS_PER_BOUNCE, n_dims_tot)
        else:
            def get_ub(b):
                return jax.lax.dynamic_slice(
                    u_mat, (jnp.int32(0), CAMERA_DIMS + b * DIMS_PER_BOUNCE),
                    (m, DIMS_PER_BOUNCE))
        return get_ub

    cur_U = (None if inloop
             else samplers.sample_all_dims(sampler, pixel, sample, n_dims_tot))
    cur_pixel, cur_sample = pixel, sample
    cur_rd = rd
    peel0 = (rd is not None and cfg.has_textures
             and cfg.texture_filter != "bilinear")

    state = dict(
        o=o, d=d,
        beta=jnp.ones((n, 3), jnp.float32),
        L=jnp.zeros((n, 3), jnp.float32),
        alive=jnp.ones((n,), bool),
        specular=jnp.ones((n,), bool),  # bounce 0 counts as specular
        eta_scale=jnp.ones((n,), jnp.float32),
        prev_pdf=jnp.ones((n,), jnp.float32),
        prev_p=o,
    )
    if cfg.count_rays:
        state["nrays"] = jnp.zeros((), jnp.float32)

    def make_parts(m, with_rd):
        get_ub = make_get_ub(cur_pixel, cur_sample, cur_U, m)
        return _fast_parts(scene, cfg, get_ub, m,
                           rd=cur_rd if with_rd else None)

    def counted_cast(cast, state):
        if cfg.count_rays:
            state = dict(state, nrays=state["nrays"] + jnp.sum(
                state["alive"].astype(jnp.float32)))
        return state, cast(state)

    def run_span(b0, b1, state, hit, m):
        """Full emit->work->cast iterations for bounces [b0, b1)."""
        if b1 <= b0:
            return state, hit
        cast, emit, work = make_parts(m, with_rd=False)

        def body(bb, c):
            st, h = c
            st = dict(st, L=st["L"] + emit(bb, st, h))
            st = work(bb, st, h, count_cast=False)
            st, h = counted_cast(cast, st)
            return st, h

        if peel0 and b0 == 0:
            # bounce 0 peeled out: camera differentials drive the filtered
            # texture lookup only there (spawned rays have
            # hasDifferentials=false in the reference)
            cast0, emit0, work0 = make_parts(m, with_rd=True)
            state = dict(state, L=state["L"] + emit0(jnp.int32(0), state, hit))
            state = work0(jnp.int32(0), state, hit, count_cast=False)
            state, hit = counted_cast(cast0, state)
            b0 = 1
        if b1 > b0:
            state, hit = jax.lax.fori_loop(b0, b1, body, (state, hit))
        return state, hit

    # camera cast (bounce 0) at full width
    cast, emit, work = make_parts(n, with_rd=peel0)
    state, hit = counted_cast(cast, state)

    outer = []  # (L_at_this_width, src, valid) per stage
    b = 0
    m_cur = n
    for si, (cb, frac) in enumerate(stages):
        state, hit = run_span(b, cb, state, hit, m_cur)
        # emission of bounce cb at the pre-compaction width (escaped lanes
        # contribute here and are then dropped)
        _c, emit, _w = make_parts(m_cur, with_rd=False)
        state = dict(state, L=state["L"] + emit(cb, state, hit))
        # ---- compact survivors (lanes that hit AND pass pre-thin RR) ----
        m = n // frac
        survivors = state["alive"] & hit.hit
        p_keep = _prethin_p(survivors, m)
        if inloop:
            u_thin = samplers.sample_bounce_dims(
                sampler, cur_pixel, cur_sample, jnp.int32(n_dims + si), 1,
                n_dims_tot)[:, 0]
        else:
            u_thin = cur_U[:, n_dims + si]
        kept = survivors & (u_thin < p_keep)
        beta = state["beta"] / p_keep
        n_cur = state["o"].shape[0]
        slots = jnp.cumsum(kept.astype(jnp.int32)) - 1
        lane_id = jnp.arange(n_cur, dtype=jnp.int32)
        src = jnp.zeros((m,), jnp.int32).at[
            jnp.where(kept, slots, m)].set(lane_id, mode="drop")
        kept_count = jnp.sum(kept.astype(jnp.int32))
        valid = jnp.arange(m, dtype=jnp.int32) < kept_count
        outer.append((state["L"], src, valid))
        nrays_carry = state.get("nrays")
        hit = trace.Hit(hit=hit.hit[src] & valid, t=hit.t[src],
                        kind=hit.kind[src], prim=hit.prim[src],
                        b=hit.b[src])
        state = dict(
            o=state["o"][src], d=state["d"][src],
            beta=beta[src],
            L=jnp.zeros((m, 3), jnp.float32),
            alive=valid,
            specular=state["specular"][src],
            eta_scale=state["eta_scale"][src],
            prev_pdf=state["prev_pdf"][src],
            prev_p=state["prev_p"][src],
        )
        if cfg.count_rays:
            state["nrays"] = nrays_carry  # scalar: carries across widths
        cur_pixel, cur_sample = cur_pixel[src], cur_sample[src]
        if not inloop:
            cur_U = cur_U[src]
        if cur_rd is not None:
            cur_rd = jax.tree_util.tree_map(lambda x: x[src], cur_rd)
        m_cur = m
        # work + next cast for bounce cb at the compacted width
        with_rd = peel0 and cb == 0
        castc, _e, workc = make_parts(m, with_rd=with_rd)
        state = workc(jnp.int32(cb), state, hit, count_cast=False)
        state, hit = counted_cast(castc, state)
        b = cb + 1
    state, hit = run_span(b, cfg.max_depth, state, hit, m_cur)
    _c, emit, _w = make_parts(m_cur, with_rd=False)
    state = dict(state, L=state["L"] + emit(jnp.int32(cfg.max_depth), state,
                                            hit))
    L = state["L"]
    for L_outer, src, valid in reversed(outer):
        L = L_outer.at[src].add(jnp.where(valid[..., None], L, 0.0))
    if cfg.count_rays:
        return L, state["nrays"]
    return L


# ---------------------------------------------------------------------------
# Render driver
# ---------------------------------------------------------------------------

def render_chunk(scene, camera, sampler, cfg: RenderCfg, sample_start, n_samples):
    """Render n_samples spp for every pixel; returns (H*W, 3) radiance sum."""
    hw = cfg.width * cfg.height
    pixel = jnp.tile(jnp.arange(hw, dtype=jnp.int32), (n_samples,))
    sample = jnp.repeat(
        sample_start + jnp.arange(n_samples, dtype=jnp.int32), hw
    )
    p_film, time_u, p_lens = samplers.camera_sample(
        sampler, pixel, sample, cfg.width, cfg.pixel_filter,
        cfg.filter_radius, cfg.filter_alpha)
    rd = None
    if cfg.has_textures and cfg.texture_filter != "bilinear":
        o, d, _t, rd = cam_mod.generate_ray_differentials(
            camera, p_film, time_u, p_lens)
        # ScaleDifferentials(1/sqrt(spp)) (core/Integrator.cpp render loop)
        rd = cam_mod.scale_differentials(o, d, rd, 1.0 / (cfg.spp ** 0.5))
    else:
        o, d, _t = cam_mod.generate_rays(camera, p_film, time_u, p_lens)
    tracer = trace_paths_fast if cfg.fast_mis else trace_paths
    out = tracer(scene, cfg, sampler, pixel, sample, o, d, rd=rd)
    L, nrays = out if cfg.count_rays else (out, None)
    # box filter: each sample belongs to its own pixel -> segment sum by
    # reshape (samples are pixel-major tiles)
    img = jnp.sum(L.reshape(n_samples, hw, 3), axis=0)
    if cfg.count_rays:
        return img, nrays
    return img


_render_chunk_jit = jax.jit(
    render_chunk, static_argnames=("cfg", "n_samples"),
)


def render_fused(scene, camera, sampler, cfg: RenderCfg, n_chunks=None):
    """Whole-frame render in ONE device dispatch: lax.fori_loop over spp
    chunks on-device instead of a host dispatch per chunk.  Removes the
    per-chunk host round trip and lets XLA overlap chunk epilogues.  cfg.spp must be a
    multiple of cfg.spp_chunk (render() handles ragged spp)."""
    if n_chunks is None:
        assert cfg.spp % cfg.spp_chunk == 0, "spp % spp_chunk != 0"
        n_chunks = cfg.spp // cfg.spp_chunk
    hw = cfg.width * cfg.height

    def body(ci, acc):
        return acc + render_chunk(scene, camera, sampler, cfg,
                                  ci * cfg.spp_chunk, cfg.spp_chunk)

    acc = jax.lax.fori_loop(
        0, n_chunks, body, jnp.zeros((hw, 3), jnp.float32))
    img = acc / (n_chunks * cfg.spp_chunk)
    return img.reshape(cfg.height, cfg.width, 3)


_render_fused_jit = jax.jit(render_fused, static_argnames=("cfg", "n_chunks"))


def render(scene, camera, sampler, cfg: RenderCfg):
    """Full render: loops spp chunks on the host, accumulating on device.
    Returns (H, W, 3) linear HDR radiance (mean over spp)."""
    hw = cfg.width * cfg.height
    acc = jnp.zeros((hw, 3), jnp.float32)
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        acc = acc + _render_chunk_jit(scene, camera, sampler, cfg, s, ns)
        s += ns
    img = acc / cfg.spp
    return img.reshape(cfg.height, cfg.width, 3)
