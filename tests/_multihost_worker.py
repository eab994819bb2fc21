"""Worker for the real two-process multi-host test (test_multihost.py).

Each process: jax.distributed.initialize against a local coordinator,
render its sample range of the Cornell box, combine across processes with
process_allgather, write the combined image to disk.  Run as:

    python -m tests._multihost_worker <pid> <nprocs> <port> <outdir>
"""

import os
import sys


def main():
    pid, nprocs, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    os.environ["JAX_PLATFORMS"] = "cpu"
    # 2 virtual chips per "host" so the in-host mesh path is exercised too
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    import jax

    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nprocs, process_id=pid)
    assert jax.process_count() == nprocs

    import numpy as np

    from gnxraytracer.models.integrators import path
    from gnxraytracer.ops import samplers
    from gnxraytracer.parallel import multihost
    from gnxraytracer.scene import presets

    w = h = 8
    spp = 4
    scene, cam = presets.cornell_box(width=w, height=h)
    cfg = path.make_config(scene, w, h, spp=spp, max_depth=2, spp_chunk=2)
    sampler = samplers.make_sobol_sampler(spp)

    partial, weight = multihost.render_multihost(scene, cam, sampler, cfg,
                                                 mode="samples")
    combined = multihost.combine_partials(partial, weight, cfg.spp)
    np.save(os.path.join(outdir, f"img_{pid}.npy"), combined)
    print(f"process {pid}/{nprocs} ok", flush=True)


if __name__ == "__main__":
    main()
