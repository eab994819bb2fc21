"""Multi-host rendering: jax.distributed + per-host tile split.

The reference is strictly single-process (SURVEY.md §2.11).  This module
is the multi-host story of the renderer:

  * `init()` wraps jax.distributed.initialize (idempotent) — one process
    per host, devices global after init;
  * rendering work is split by *sample ranges* per host (each host renders
    the full film at spp/n_hosts, which keeps every collective inside the
    host's chips and needs a single cross-host image reduction at the end),
    or by *row ranges* (each host renders a film slab, no cross-host
    reduction at all);
  * the final combine is an all-gather over processes (NCCL within a
    host's cards, the network between hosts) or a host-side gather for
    slab mode.

Tested logic-wise with the virtual-device mesh (tests use
xla_force_host_platform_device_count) and a real two-process run on the
CPU (tests/test_multihost.py); real multi-host runs pass the coordinator
address, process count and process id to init().
"""

import jax
import jax.numpy as jnp
import numpy as np


def init(coordinator=None, num_processes=None, process_id=None):
    """Idempotent jax.distributed.initialize wrapper.

    Only initializes when a coordinator is known (argument or the standard
    env vars) — calling jax.distributed.initialize with no coordinator
    BLOCKS waiting for the coordination service, so single-host runs must
    skip it entirely.
    """
    import os

    if jax.process_count() > 1:
        return  # already initialized
    has_env = any(os.environ.get(k) for k in
                  ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"))
    if coordinator is None and not has_env:
        return  # single-host
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        pass  # already initialized


def sample_range_for_host(spp, process_id=None, process_count=None):
    """Contiguous spp slice owned by this host (sample-split mode)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if process_count is None else process_count
    per = (spp + n - 1) // n
    start = pid * per
    return start, min(per, spp - start)


def row_range_for_host(height, process_id=None, process_count=None):
    """Contiguous film-row slab owned by this host (slab-split mode)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if process_count is None else process_count
    per = (height + n - 1) // n
    start = pid * per
    return start, min(per, height - start)


def render_multihost(scene, camera, sampler, cfg, mode="samples"):
    """Render this host's share; returns (partial_image, weight).

    Combine across hosts with `combine_partials` (sample mode) or
    concatenate slabs (row mode).  Within the host, pixels are sharded
    over the local chips exactly as parallel/sharding.py does.
    """
    from . import sharding
    from ..models.integrators import path as path_mod

    mesh = sharding.make_mesh()
    if mode == "samples":
        start, count = sample_range_for_host(cfg.spp)
        hw = cfg.width * cfg.height
        acc = jnp.zeros((hw, 3), jnp.float32)
        s = start
        while s < start + count:
            ns = min(cfg.spp_chunk, start + count - s)
            acc = acc + sharding.render_chunk_sharded(
                scene, camera, sampler, cfg, mesh, s, ns)
            s += ns
        # mean over this host's samples: combine_partials re-weights by
        # `weight` so hosts with ragged sample counts combine correctly
        return (np.asarray(acc).reshape(cfg.height, cfg.width, 3) / count,
                count)
    # row-slab mode: render only this host's rows by shifting pixel ids
    start, rows = row_range_for_host(cfg.height)
    sub_cfg = cfg._replace(height=rows)
    # pixel ids offset so sampler/pixel identity matches the full film
    img = np.zeros((rows, cfg.width, 3), np.float32)
    hw = cfg.width * rows
    row_offset = start * cfg.width
    acc = jnp.zeros((hw, 3), jnp.float32)
    s = 0
    from ..ops import samplers as samplers_mod
    from ..scene import camera as cam_mod

    while s < cfg.spp:
        ns = min(cfg.spp_chunk, cfg.spp - s)
        pixel = jnp.tile(row_offset + jnp.arange(hw, dtype=jnp.int32), (ns,))
        sample = jnp.repeat(s + jnp.arange(ns, dtype=jnp.int32), hw)
        p_film, t_u, l_u = samplers_mod.camera_sample(
            sampler, pixel, sample, cfg.width, cfg.pixel_filter,
            cfg.filter_radius, cfg.filter_alpha)
        o, d, _ = cam_mod.generate_rays(camera, p_film, t_u, l_u)
        tracer = path_mod.trace_paths_fast if cfg.fast_mis else path_mod.trace_paths
        L = tracer(scene, cfg, sampler, pixel, sample, o, d)
        acc = acc + jnp.sum(L.reshape(ns, hw, 3), axis=0)
        s += ns
    return np.asarray(acc).reshape(rows, cfg.width, 3) / cfg.spp, rows


def combine_partials(partial, weight, total_weight):
    """Weighted combine for sample-split mode across hosts: every
    process's weighted partial image through process_allgather.  A failed
    gather raises; returning this process's partial image instead would
    pass a fraction of the samples off as the whole render."""
    from jax.experimental import multihost_utils

    stacked = multihost_utils.process_allgather(jnp.asarray(partial * weight))
    return np.asarray(jnp.sum(stacked, axis=0)) / total_weight
