"""BASELINE config-5 demonstration: kf-block sharded global BA on a LONG
concatenated trajectory, on the virtual 8-device mesh, vs the
single-device chunked GBA.

Reports error-to-truth agreement (the sharded solve is exact) and the
per-device chunk counts — the scaling story is chunks-per-device: the
single chip sweeps every chunk sequentially, the mesh spreads them, so
device wall scales with ceil(chunks / n_devices).  (CPU-mesh wall times
say nothing about an accelerator; agreement and work division do.)

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python scripts/bench_dist_gba.py [N_KF]
"""

import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

import __graft_entry__ as G
from plslam_tpu.parallel import dist_gba
from plslam_tpu.parallel.mesh import make_mesh

N_KF = int(sys.argv[1]) if len(sys.argv) > 1 else 128
ONLY = sys.argv[2] if len(sys.argv) > 2 else None  # single|mesh8
N_PTS = N_KF * 128
N_LS = N_KF * 8


def _peak_rss_gb():
    import resource

    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2)


def build():
    return G._build_ring_map(rng_seed=7, n_kf=N_KF, n_pts=N_PTS,
                             n_ls=N_LS, pose_noise=0.01, lm_noise=0.03)


def pt_err(mapper, pt_true):
    mp = mapper.map
    el = np.where(mp.pt_valid & (mp.pt_nobs >= 2))[0]
    return float(np.median(np.linalg.norm(mp.pt_w[el] - pt_true[el],
                                          axis=1)))


def main():
    results = {}
    want = lambda k: ONLY is None or ONLY == k
    pre = None
    if want("single"):
        # single-chip chunked GBA
        mapper, (T_true, pt_true) = build()
        pre = pt_err(mapper, pt_true)
        t0 = time.time()
        mapper.global_bundle_adjustment()
        results["single"] = {"wall_s": round(time.time() - t0, 1),
                             "pt_err": round(pt_err(mapper, pt_true), 5),
                             "peak_rss_gb": _peak_rss_gb()}

    if want("mesh8"):
        # 8-device kf-block mesh
        mapper, (T_true, pt_true) = build()
        if pre is None:
            pre = pt_err(mapper, pt_true)
        mesh = make_mesh(8, dist_gba.AXIS)
        t0 = time.time()
        blk = dist_gba.distributed_global_bundle_adjustment(mapper, mesh)
        results["mesh8"] = {
            "wall_s": round(time.time() - t0, 1),
            "pt_err": round(pt_err(mapper, pt_true), 5),
            "chunks": len(blk.metas),
            "chunks_per_device": -(-len(blk.metas) // 8),
            "peak_rss_gb": _peak_rss_gb()}

    print(json.dumps({"n_kf": N_KF, "n_pts": N_PTS, "n_ls": N_LS,
                      "pre_err": round(pre, 5), **results}))


if __name__ == "__main__":
    main()
