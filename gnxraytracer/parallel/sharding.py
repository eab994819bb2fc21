"""Multi-card scaling: pixel data parallelism over a device mesh.

The reference's only parallelism is an OpenMP parallel-for over image
columns (/root/reference/core/Integrator.cpp:256).  Here (SURVEY.md §2.11)
the ray wavefront's *pixel axis* is sharded over a flat ("data",) mesh of
cards; the scene pytree (geometry, BVH, tables, env map) is replicated in
every card's memory; XLA's SPMD partitioner runs each card on its own
pixel block and inserts the all-reduce of parameter gradients in the
inverse-rendering training step, which XLA hands to NCCL (over NVLink
between the cards of one host).  The mesh is flat because every card
reaches every other at the same rate.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.integrators import path as path_mod
from ..ops import samplers as samplers_mod
from ..scene import camera as cam_mod


def make_mesh(n_devices=None, axis="data"):
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            # loud, not silent: a shorter mesh silently changes the
            # experiment (an "8-device" run quietly becomes 1-device —
            # exactly how r3's sharding-bench probes fooled us)
            raise ValueError(
                f"make_mesh({n_devices}) but only {len(devs)} devices "
                f"visible on platform {devs[0].platform!r}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _replicated(mesh):
    return NamedSharding(mesh, P())


def _sharded(mesh, axis="data"):
    return NamedSharding(mesh, P(axis))


def render_chunk_sharded(scene, camera, sampler, cfg, mesh, sample_start, n_samples):
    """One spp chunk with pixels sharded across the mesh.

    Each card renders its own pixel block with the single-device program
    (shard_map): lanes are laid out sample-major (n_samples, pixels), the
    samples of a pixel stay on its card, so the forward pass needs no
    collective.  Returns the (H*W, 3) radiance sum, sharded by pixel.
    """
    hw = cfg.width * cfg.height
    pixel = jnp.arange(hw, dtype=jnp.int32)
    pixel = jax.device_put(pixel, _sharded(mesh))
    scene = jax.device_put(scene, _replicated(mesh))
    camera = jax.device_put(camera, _replicated(mesh))
    sampler = jax.device_put(sampler, _replicated(mesh))
    return _run_sharded(scene, camera, sampler, pixel, cfg, mesh,
                        sample_start, n_samples)


def _local_radiance(scene, camera, sampler, pixel, cfg, sample_start,
                    n_samples, tracer):
    """(n_samples, len(pixel), 3) radiance of this card's pixels."""
    n_pix = pixel.shape[0]
    pix = jnp.tile(pixel, (n_samples,))
    smp = jnp.repeat(sample_start + jnp.arange(n_samples, dtype=jnp.int32),
                     n_pix)
    p_film, t_u, l_u = samplers_mod.camera_sample(sampler, pix, smp, cfg.width)
    o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, l_u)
    out = tracer(scene, cfg, sampler, pix, smp, o, d)
    L = out[0] if cfg.count_rays else out
    return L.reshape(n_samples, n_pix, 3)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "n_samples"))
def _run_sharded(scene, camera, sampler, pixel, cfg, mesh, sample_start,
                 n_samples):
    # module-level jit: repeat calls reuse the compiled executable (a
    # closure-local jit would recompile on every render_chunk_sharded call)
    tracer = (path_mod.trace_paths_fast if cfg.fast_mis
              else path_mod.trace_paths)

    def local(scene, camera, sampler, pixel, sample_start):
        return jnp.sum(_local_radiance(scene, camera, sampler, pixel, cfg,
                                       sample_start, n_samples, tracer),
                       axis=0)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P(), P("data"), P()),
        out_specs=P("data"), check_vma=False,
    )(scene, camera, sampler, pixel, sample_start)


def render_sharded(scene, camera, sampler, cfg, mesh):
    """Full sharded render; returns (H, W, 3) linear HDR on host."""
    hw = cfg.width * cfg.height
    acc = jnp.zeros((hw, 3), jnp.float32)
    s = 0
    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        acc = acc + render_chunk_sharded(scene, camera, sampler, cfg, mesh, s, ns)
        s += ns
    return np.asarray(acc).reshape(cfg.height, cfg.width, 3) / cfg.spp


# ---------------------------------------------------------------------------
# Inverse-rendering training step (the "training" workload of this
# framework: gradients of image loss w.r.t. scene parameters)
# ---------------------------------------------------------------------------

# Every MaterialTable column SURVEY.md §7 / BASELINE names as a gradient
# target: diffuse/specular scales, roughness, IOR, the ten Disney params
# (materials/DisneyMaterial.h:17).
_MAT_PARAM_COLS = (
    "kd", "sigma", "kr", "kt", "ks", "eta", "rough_u", "rough_v",
    "metallic", "spec_trans", "specular_tint", "anisotropic", "sheen",
    "sheen_tint", "clearcoat", "clearcoat_gloss", "flatness", "diff_trans",
)


def extract_params(scene):
    """The differentiable parameter pytree (SURVEY.md §7): all material
    columns, light radiance, env texels, medium scattering parameters
    (media/HomogeneousMedium.cpp:17-43), and image-texture texels (their
    gradient is the scatter-add transpose of the lookup gathers)."""
    p = {c: getattr(scene.materials, c) for c in _MAT_PARAM_COLS}
    p["light_emit"] = scene.lights.emit
    if scene.env is not None:
        p["env_image"] = scene.env.image
    if scene.media is not None:
        p["med_sigma_a"] = scene.media.sigma_a
        p["med_sigma_s"] = scene.media.sigma_s
        p["med_g"] = scene.media.g
    if scene.textures is not None:
        p["tex_atlas"] = scene.textures[0]
    return p


def insert_params(scene, p):
    mats = scene.materials._replace(
        **{c: p[c] for c in _MAT_PARAM_COLS if c in p})
    lights = scene.lights._replace(emit=p["light_emit"])
    env = scene.env
    if env is not None and "env_image" in p:
        env = env._replace(image=p["env_image"])
        if env.le_func is not None:
            # the packed [rgb, func/marg_int] table (round 5) must track
            # the injected texels so env-radiance reads stay attached to
            # the param; channel 3 (the sampling pdf) is a build-time
            # constant by design — the CDFs it must match are fixed
            env = env._replace(le_func=jnp.concatenate(
                [p["env_image"], env.le_func[..., 3:]], axis=-1))
    media = scene.media
    if media is not None and "med_sigma_a" in p:
        media = media._replace(sigma_a=p["med_sigma_a"],
                               sigma_s=p["med_sigma_s"], g=p["med_g"])
    textures = scene.textures
    if textures is not None and "tex_atlas" in p:
        textures = (p["tex_atlas"],) + tuple(textures[1:])
    return scene._replace(materials=mats, lights=lights, env=env,
                          media=media, textures=textures)


def make_train_step(cfg, mesh):
    """Jitted data-parallel training step: each card renders its pixel
    block and differentiates its share of the loss (shard_map); the loss
    and the gradient pytree are then summed over the mesh (psum, which
    XLA hands to NCCL) — the only cross-card traffic of the step."""
    hw = cfg.width * cfg.height

    def local_loss(params, scene, camera, sampler, pixel, target,
                   sample_start):
        img = jnp.mean(_local_radiance(
            insert_params(scene, params), camera, sampler, pixel, cfg,
            sample_start, cfg.spp_chunk, path_mod.trace_paths), axis=0)
        # this card's share of the image-wide mean squared error
        return jnp.sum((img - target) ** 2) / (hw * 3)

    def local_step(params, scene, camera, sampler, pixel, target,
                   sample_start, lr):
        loss, g = jax.value_and_grad(local_loss)(
            params, scene, camera, sampler, pixel, target, sample_start)
        loss, g = jax.lax.psum((loss, g), "data")
        return loss, jax.tree.map(lambda p, gi: p - lr * gi, params, g)

    @jax.jit
    def step(params, scene, camera, sampler, pixel, target, sample_start, lr):
        return jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P("data"), P("data"), P(), P()),
            out_specs=(P(), P()), check_vma=False,
        )(params, scene, camera, sampler, pixel, target, sample_start, lr)

    def run(params, scene, camera, sampler, target, sample_start=0, lr=1e-2):
        pixel = jax.device_put(jnp.arange(hw, dtype=jnp.int32), _sharded(mesh))
        target = jax.device_put(target.reshape(hw, 3), _sharded(mesh))
        params = jax.device_put(params, _replicated(mesh))
        scene = jax.device_put(scene, _replicated(mesh))
        camera = jax.device_put(camera, _replicated(mesh))
        sampler = jax.device_put(sampler, _replicated(mesh))
        return step(params, scene, camera, sampler, pixel, target,
                    jnp.int32(sample_start), jnp.float32(lr))

    return run
