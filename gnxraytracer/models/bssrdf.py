"""Subsurface scattering: separable BSSRDFs (tabulated beam-diffusion and
the Disney/Burley two-exponential profile).

Wavefront re-design of the reference BSSRDF layer
(/root/reference/core/SubReflection.{h,cpp} and the DisneyBSSRDF at
materials/DisneyMaterial.cpp:346-460):

  * the class hierarchy (BSSRDF -> SeparableBSSRDF -> Tabulated/Disney)
    becomes a parameter pytree + pure batched functions: `sw` (directional
    term), `sr_*` (radial profile), `sample_sr_*` / `pdf_sr_*`, and the
    axis/channel machinery of `Sample_Sp` / `Pdf_Sp` expressed over (N,)
    lanes;
  * the beam-diffusion table precompute (ComputeBeamDiffusionBSSRDF,
    SubReflection.cpp:117-151) runs host-side in vectorized numpy once per
    medium (100 rho x 64 radius grid, 100-point quadratures fully
    broadcast instead of the reference's triple loop);
  * the probe-ray intersection chain of Sample_Sp
    (SubReflection.cpp:222-305) is provided as `sample_sp_probe`, a
    bounded-iteration chain walk over the wavefront using the scene
    intersector.

The reference's integrator hook is compiled out (`#if 0`,
integrators/PathIntegrator.cpp:165-192), so these components are library
parity + building blocks for a subsurface-enabled integrator; gradients
flow through all profile parameters (R, d, sigma_a/s).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import PI
from ..ops.interpolation import (
    catmull_rom_weights, invert_catmull_rom, sample_catmull_rom_2d,
)
from ..utils.math import abs_cos_theta, cos_theta, normalize
from . import bxdf


# ---------------------------------------------------------------------------
# Fresnel moments (SubReflection.cpp:10-35), branchless over eta</>1
# ---------------------------------------------------------------------------

def fresnel_moment1(eta):
    eta = jnp.asarray(eta, jnp.float32)
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return jnp.where(eta < 1.0, lo, hi)


def fresnel_moment2(eta):
    eta = jnp.asarray(eta, jnp.float32)
    e2 = eta * eta
    e3 = e2 * eta
    e4 = e3 * eta
    e5 = e4 * eta
    lo = (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
          + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / jnp.maximum(eta, 1e-6)
    r2 = r * r
    r3 = r2 * r
    hi = (-547.033 + 45.3087 * r3 - 218.725 * r2 + 458.843 * r
          + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
          + 0.63942 * e5)
    return jnp.where(eta < 1.0, lo, hi)


# ---------------------------------------------------------------------------
# Separable directional term (SubReflection.h Sw / SeparableBSSRDFAdapter)
# ---------------------------------------------------------------------------

def sw(w, eta):
    """Sw(w) = (1 - Fr(cos w)) / (c pi), c = 1 - 2 FresnelMoment1(1/eta)."""
    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    return (1.0 - bxdf.fr_dielectric(cos_theta(w), 1.0, eta)) / (c * PI)


def adapter_f(wo, wi, eta):
    """SeparableBSSRDFAdapter::f (SubReflection.h:120-135): Sw(wi) with the
    radiance-mode eta^2 non-symmetry factor; cosine-hemisphere sampled like
    any diffuse lobe."""
    del wo
    return (sw(wi, eta) * eta * eta)[..., None]


# ---------------------------------------------------------------------------
# Disney/Burley two-exponential profile
# (materials/DisneyMaterial.cpp:352-460)
# ---------------------------------------------------------------------------

def disney_sr(r, big_r, d):
    """Sr(r) = R (e^{-r/d} + e^{-r/3d}) / (8 pi d r), d pre-scaled by the
    0.2 Burley factor by the caller (DisneyMaterial.cpp:360).

    r: (...,); big_r, d: (..., 3). Returns (..., 3).
    """
    r = jnp.maximum(r, 1e-6)[..., None]
    return big_r * (jnp.exp(-r / d) + jnp.exp(-r / (3.0 * d))) / (8.0 * PI * d * r)


def disney_sample_sr(u, d_ch):
    """Sample_Sr (DisneyMaterial.cpp:409-450): 1:3 MIS mix of the two
    exponentials, each invertible in closed form."""
    first = u < 0.25
    u1 = jnp.minimum(u * 4.0, 1.0 - 1e-7)
    u2 = jnp.minimum((u - 0.25) / 0.75, 1.0 - 1e-7)
    r1 = d_ch * jnp.log(1.0 / (1.0 - u1))
    r2 = 3.0 * d_ch * jnp.log(1.0 / (1.0 - u2))
    return jnp.where(first, r1, r2)


def disney_pdf_sr(r, d_ch):
    """Pdf_Sr (DisneyMaterial.cpp:453-460)."""
    r = jnp.maximum(r, 1e-6)
    return (0.25 * jnp.exp(-r / d_ch) / (2.0 * PI * d_ch * r)
            + 0.75 * jnp.exp(-r / (3.0 * d_ch)) / (6.0 * PI * d_ch * r))


def disney_s(po_p, po_ns, po_wo_local_z, pi_p, pi_ns, wi_local_z, r_prof, sp):
    """DisneyBSSRDF::S (DisneyMaterial.cpp:374-398): cavity fade x Schlick
    retro-weights x Sp / pi.  Takes precomputed |cos| terms in local frames
    and the Sp profile value."""
    a = normalize(pi_p - po_p, eps=1e-20)
    ct = jnp.sum(a * po_ns, -1)
    st = jnp.sqrt(jnp.maximum(0.0, 1.0 - ct * ct))
    a2 = po_ns * st[..., None] - (a - po_ns * ct[..., None]) * (
        ct / jnp.maximum(st, 1e-6)
    )[..., None]
    fade = jnp.where(ct > 0, jnp.maximum(0.0, jnp.sum(pi_ns * a2, -1)), 1.0)

    def schlick_weight(c):
        m = jnp.clip(1.0 - c, 0.0, 1.0)
        return (m * m) * (m * m) * m

    fo = schlick_weight(jnp.abs(po_wo_local_z))
    fi = schlick_weight(jnp.abs(wi_local_z))
    return (fade * (1.0 - 0.5 * fo) * (1.0 - 0.5 * fi))[..., None] * sp / PI


# ---------------------------------------------------------------------------
# Beam-diffusion table (ComputeBeamDiffusionBSSRDF, SubReflection.cpp:117)
# ---------------------------------------------------------------------------

class BSSRDFTable(NamedTuple):
    rho_samples: jnp.ndarray     # (R,)
    radius_samples: jnp.ndarray  # (M,)
    profile: jnp.ndarray         # (R, M)
    rho_eff: jnp.ndarray         # (R,)
    profile_cdf: jnp.ndarray     # (R, M)


def _beam_diffusion_ms(sigma_s, sigma_a, g, eta, r, n=100):
    """BeamDiffusionMS (SubReflection.cpp:37-92), numpy-vectorized over the
    depth quadrature and broadcast over (sigma, r) grids."""
    sigma_s, sigma_a, r = np.broadcast_arrays(
        np.asarray(sigma_s, np.float64), np.asarray(sigma_a, np.float64),
        np.asarray(r, np.float64),
    )
    sigmap_s = sigma_s * (1.0 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / np.maximum(sigmap_t, 1e-12)
    d_g = (2.0 * sigma_a + sigmap_s) / (3.0 * sigmap_t * sigmap_t)
    sigma_tr = np.sqrt(sigma_a / np.maximum(d_g, 1e-12))
    fm1 = float(fresnel_moment1(eta))
    fm2 = float(fresnel_moment2(eta))
    ze = -2.0 * d_g * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)
    i = (np.arange(n) + 0.5) / n  # (n,)
    i_col = np.log(1.0 - i).reshape((n,) + (1,) * sigmap_t.ndim)
    zr = -i_col / sigmap_t[None]  # (n, ...)
    zv = -zr + 2.0 * ze[None]
    rr = r[None]
    dr = np.sqrt(rr * rr + zr * zr)
    dv = np.sqrt(rr * rr + zv * zv)
    inv4pi = 1.0 / (4.0 * np.pi)
    phi_d = inv4pi / d_g[None] * (
        np.exp(-sigma_tr[None] * dr) / dr - np.exp(-sigma_tr[None] * dv) / dv
    )
    edn = inv4pi * (
        zr * (1.0 + sigma_tr[None] * dr) * np.exp(-sigma_tr[None] * dr) / dr ** 3
        - zv * (1.0 + sigma_tr[None] * dv) * np.exp(-sigma_tr[None] * dv) / dv ** 3
    )
    e = phi_d * c_phi + edn * c_e
    kappa = 1.0 - np.exp(-2.0 * sigmap_t[None] * (dr + zr))
    return (kappa * (rhop * rhop)[None] * e).mean(0)


def _beam_diffusion_ss(sigma_s, sigma_a, g, eta, r, n=100):
    """BeamDiffusionSS (SubReflection.cpp:94-115), numpy-vectorized."""
    sigma_s, sigma_a, r = np.broadcast_arrays(
        np.asarray(sigma_s, np.float64), np.asarray(sigma_a, np.float64),
        np.asarray(r, np.float64),
    )
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / np.maximum(sigma_t, 1e-12)
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = (np.arange(n) + 0.5) / n
    i_col = np.log(1.0 - i).reshape((n,) + (1,) * sigma_t.ndim)
    ti = t_crit[None] - i_col / sigma_t[None]
    d = np.sqrt(r[None] ** 2 + ti * ti)
    cos_o = ti / d

    def phase_hg(c, g):
        denom = 1.0 + g * g + 2.0 * g * c
        return (1.0 / (4.0 * np.pi)) * (1.0 - g * g) / (denom * np.sqrt(np.maximum(denom, 1e-12)))

    # FrDielectric(-cosThetaO, 1, eta) on the host
    def fr_diel(ci, eta_i, eta_t):
        ci = np.clip(ci, -1.0, 1.0)
        entering = ci > 0
        ei = np.where(entering, eta_i, eta_t)
        et = np.where(entering, eta_t, eta_i)
        ci = np.abs(ci)
        si = np.sqrt(np.maximum(0.0, 1.0 - ci * ci))
        st = ei / et * si
        ct = np.sqrt(np.maximum(0.0, 1.0 - st * st))
        rp = (et * ci - ei * ct) / np.maximum(et * ci + ei * ct, 1e-12)
        rs = (ei * ci - et * ct) / np.maximum(ei * ci + et * ct, 1e-12)
        return np.where(st >= 1.0, 1.0, 0.5 * (rp * rp + rs * rs))

    ess = (
        rho[None] * np.exp(-sigma_t[None] * (d + t_crit[None])) / (d * d)
        * phase_hg(cos_o, g)
        * (1.0 - fr_diel(-cos_o, 1.0, eta))
        * np.abs(cos_o)
    )
    return ess.mean(0)


def compute_beam_diffusion_table(g, eta, n_rho=100, n_radius=64):
    """ComputeBeamDiffusionBSSRDF (SubReflection.cpp:117-151): profile
    table over (rho, r_optical) with rho_eff + per-row CDF."""
    radius = np.zeros(n_radius)
    radius[1] = 2.5e-3
    for i in range(2, n_radius):
        radius[i] = radius[i - 1] * 1.2
    rho = (1.0 - np.exp(-8.0 * np.arange(n_rho) / (n_rho - 1))) / (
        1.0 - np.exp(-8.0)
    )
    rho_g, r_g = np.meshgrid(rho, radius, indexing="ij")  # (R, M)
    profile = 2.0 * np.pi * r_g * (
        _beam_diffusion_ss(rho_g, 1.0 - rho_g, g, eta, r_g)
        + _beam_diffusion_ms(rho_g, 1.0 - rho_g, g, eta, r_g)
    )
    # rho_eff + CDF per row, via the spline integral
    from ..ops.interpolation import integrate_catmull_rom

    radius_j = jnp.asarray(radius, jnp.float32)
    cdfs = []
    effs = []
    for i in range(n_rho):
        cdf, total = integrate_catmull_rom(radius_j,
                                           jnp.asarray(profile[i], jnp.float32))
        cdfs.append(np.asarray(cdf))
        effs.append(float(total))
    return BSSRDFTable(
        rho_samples=jnp.asarray(rho, jnp.float32),
        radius_samples=radius_j,
        profile=jnp.asarray(profile, jnp.float32),
        rho_eff=jnp.asarray(effs, jnp.float32),
        profile_cdf=jnp.asarray(np.stack(cdfs), jnp.float32),
    )


def subsurface_from_diffuse(table: BSSRDFTable, rho_eff, mfp):
    """SubsurfaceFromDiffuse (SubReflection.cpp:153-163): invert rho_eff
    back to single-scattering albedo, convert mean free path to sigmas."""
    rho = invert_catmull_rom(table.rho_samples, table.rho_eff, rho_eff)
    sigma_s = rho / mfp
    sigma_a = (1.0 - rho) / mfp
    return sigma_a, sigma_s


# ---------------------------------------------------------------------------
# TabulatedBSSRDF (SubReflection.h:83, .cpp:174-205,327-368)
# ---------------------------------------------------------------------------

def _tensor_spline(table: BSSRDFTable, rho, r_optical):
    """4x4 tensor Catmull-Rom interpolation of the profile, plus the
    interpolated rho_eff (TabulatedBSSRDF::Sr / Pdf_Sr inner loop)."""
    r_rows = table.rho_samples.shape[0]
    m_cols = table.radius_samples.shape[0]
    ro_off, *ro_w, ro_ok = catmull_rom_weights(table.rho_samples, rho)
    ra_off, *ra_w, ra_ok = catmull_rom_weights(table.radius_samples, r_optical)
    sr = 0.0
    rho_eff = 0.0
    for i in range(4):
        row = jnp.clip(ro_off + i, 0, r_rows - 1)
        rho_eff = rho_eff + ro_w[i] * table.rho_eff[row]
        for j in range(4):
            col = jnp.clip(ra_off + j, 0, m_cols - 1)
            sr = sr + ro_w[i] * ra_w[j] * table.profile[row, col]
    ok = ro_ok & ra_ok
    return jnp.where(ok, sr, 0.0), jnp.where(ok, rho_eff, 1.0), ok


def tabulated_sr(table: BSSRDFTable, sigma_t, rho, r):
    """TabulatedBSSRDF::Sr (SubReflection.cpp:174-205).

    sigma_t, rho: (..., C) per-channel; r: (...,). Returns (..., C).
    """
    r_optical = r[..., None] * sigma_t
    sr, _, _ = _tensor_spline(table, rho, r_optical)
    sr = jnp.where(r_optical != 0, sr / (2.0 * PI * jnp.maximum(r_optical, 1e-20)), sr)
    return jnp.maximum(sr * sigma_t * sigma_t, 0.0)


def tabulated_sample_sr(table: BSSRDFTable, sigma_t_ch, rho_ch, u):
    """TabulatedBSSRDF::Sample_Sr (SubReflection.cpp:327-334): returns
    r < 0 convention replaced by (r, valid)."""
    r_opt, _, _ = sample_catmull_rom_2d(
        table.rho_samples, table.radius_samples, table.profile,
        table.profile_cdf, rho_ch, u,
    )
    valid = sigma_t_ch > 0
    return jnp.where(valid, r_opt / jnp.maximum(sigma_t_ch, 1e-20), 0.0), valid


def tabulated_pdf_sr(table: BSSRDFTable, sigma_t_ch, rho_ch, r):
    """TabulatedBSSRDF::Pdf_Sr (SubReflection.cpp:336-368)."""
    r_optical = r * sigma_t_ch
    sr, rho_eff, ok = _tensor_spline(table, rho_ch, r_optical)
    sr = jnp.where(r_optical != 0, sr / (2.0 * PI * jnp.maximum(r_optical, 1e-20)), sr)
    pdf = sr * sigma_t_ch * sigma_t_ch / jnp.maximum(rho_eff, 1e-20)
    return jnp.where(ok, jnp.maximum(pdf, 0.0), 0.0)


# ---------------------------------------------------------------------------
# Sample_Sp axis/channel machinery (SubReflection.cpp:222-305)
# ---------------------------------------------------------------------------

def choose_projection_axis(u1, ss, ts, ns):
    """The 1/2:1/4:1/4 axis pick of Sample_Sp; returns (vx, vy, vz,
    remapped u1)."""
    first = u1 < 0.5
    second = (u1 >= 0.5) & (u1 < 0.75)
    u1r = jnp.where(first, u1 * 2.0,
                    jnp.where(second, (u1 - 0.5) * 4.0, (u1 - 0.75) * 4.0))
    fsel = first[..., None]
    ssel = second[..., None]
    vx = jnp.where(fsel, ss, jnp.where(ssel, ts, ns))
    vy = jnp.where(fsel, ts, jnp.where(ssel, ns, ss))
    vz = jnp.where(fsel, ns, jnp.where(ssel, ss, ts))
    return vx, vy, vz, u1r


def sample_sp_probe(scene, cfg, po_p, po_perr, po_ng, vx, vy, vz, r, phi,
                    r_max, mat_id, u_select, max_chain=4):
    """The probe-ray intersection chain of Sample_Sp
    (SubReflection.cpp:258-300), wavefront style.

    Casts the probe segment of length l = 2 sqrt(rMax^2 - r^2) through the
    sampled offset point, walking up to `max_chain` surface crossings and
    recording those whose material id matches the subsurface material; one
    admissible hit is then chosen with probability 1/nFound (u_select).

    Returns (hit_found (N,), pi Interaction for the chosen hit, n_found (N,)).
    The reference's unbounded linked-list walk becomes a fixed unrolled
    chain (diffusion radii are small; >4 same-material crossings along a
    2*rMax chord are geometrically rare).
    """
    from ..ops import trace

    n = po_p.shape[0]
    bad = r >= r_max
    l_len = 2.0 * jnp.sqrt(jnp.maximum(r_max * r_max - r * r, 0.0))
    base = (
        po_p
        + r[..., None] * (vx * jnp.cos(phi)[..., None] + vy * jnp.sin(phi)[..., None])
        - 0.5 * l_len[..., None] * vz
    )
    target = base + l_len[..., None] * vz

    # accumulate up to max_chain admissible hits
    hits_t = []
    hits_valid = []
    hit_records = []
    o = base
    d = normalize(target - base, eps=1e-20)
    remaining = l_len
    alive = ~bad & (l_len > 1e-7)
    for _ in range(max_chain):
        h = trace.scene_intersect(scene, cfg, o, d, jnp.maximum(remaining, 0.0))
        it = trace.make_interaction(scene, cfg, o, d, h)
        ok = h.hit & alive
        match = ok & (it.mat == mat_id)
        hits_valid.append(match)
        hit_records.append(it)
        hits_t.append(h.t)
        # continue the walk from the hit point
        o_next = trace.offset_ray_origin(it.p, it.p_err, it.ng, d)
        remaining = remaining - h.t
        alive = ok & (remaining > 1e-6)
        o = jnp.where(ok[..., None], o_next, o)

    n_found = jnp.sum(jnp.stack(hits_valid, -1).astype(jnp.int32), -1)
    found = n_found > 0
    # select hit index floor(u * nFound) among admissible ones
    sel = jnp.clip((u_select * n_found.astype(jnp.float32)).astype(jnp.int32),
                   0, jnp.maximum(n_found - 1, 0))
    # running index of admissible hits
    chosen = jnp.zeros((n,), jnp.int32)
    running = jnp.zeros((n,), jnp.int32)
    for k in range(max_chain):
        is_sel = hits_valid[k] & (running == sel)
        chosen = jnp.where(is_sel, k, chosen)
        running = running + hits_valid[k].astype(jnp.int32)

    def gather_field(field_idx):
        out = getattr(hit_records[0], field_idx)
        for k in range(1, max_chain):
            pick = chosen == k
            fk = getattr(hit_records[k], field_idx)
            out = jnp.where(
                pick[..., None] if fk.ndim > 1 else pick, fk, out
            )
        return out

    pi = trace.Interaction(
        p=gather_field("p"), p_err=gather_field("p_err"),
        ng=gather_field("ng"), ns=gather_field("ns"),
        ss=gather_field("ss"), ts=gather_field("ts"),
        uv=gather_field("uv"), wo=gather_field("wo"),
        mat=gather_field("mat"), light=gather_field("light"),
    )
    return found, pi, n_found


def pdf_sp(pdf_sr_fn, po_p, pi_p, pi_ng, ss, ts, ns, n_channels=3):
    """SeparableBSSRDF::Pdf_Sp (SubReflection.cpp:307-325): combine the 3
    axis projections x C channel strategies.

    pdf_sr_fn(ch, r) -> (...,) per-channel radial pdf.
    """
    d = po_p - pi_p
    d_local = jnp.stack(
        [jnp.sum(ss * d, -1), jnp.sum(ts * d, -1), jnp.sum(ns * d, -1)], -1
    )
    n_local = jnp.stack(
        [jnp.sum(ss * pi_ng, -1), jnp.sum(ts * pi_ng, -1), jnp.sum(ns * pi_ng, -1)],
        -1,
    )
    r_proj = jnp.stack(
        [
            jnp.sqrt(d_local[..., 1] ** 2 + d_local[..., 2] ** 2),
            jnp.sqrt(d_local[..., 2] ** 2 + d_local[..., 0] ** 2),
            jnp.sqrt(d_local[..., 0] ** 2 + d_local[..., 1] ** 2),
        ],
        -1,
    )
    axis_prob = jnp.asarray([0.25, 0.25, 0.5])
    ch_prob = 1.0 / n_channels
    pdf = 0.0
    for axis in range(3):
        for ch in range(n_channels):
            pdf = pdf + (
                pdf_sr_fn(ch, r_proj[..., axis])
                * jnp.abs(n_local[..., axis]) * ch_prob * axis_prob[axis]
            )
    return pdf
