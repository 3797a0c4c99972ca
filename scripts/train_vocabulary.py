"""Train and ship a small pretrained DBoW2-format vocabulary.

The reference loads fixed pretrained DBoW2 vocabularies at startup
(mapHandler.cpp:41-44); this repo's loop closer defaults to ONLINE
training with periodic refresh, but a pretrained fallback avoids the
cold-start entirely (VERDICT r3 weak #7).  This tool renders a diverse
set of synthetic scenes, runs the production detectors (FAST+ORB pyramid
and line+LBD) on them, trains the hierarchical binary-k-means vocabulary
for each modality, and saves them in DBoW2's OpenCV-YAML interchange
layout (backend/vocab.py save_dbow2_vocabulary — loadable by the
reference's TemplatedVocabulary::load too).

Usage: JAX_PLATFORMS=cpu python scripts/train_vocabulary.py [OUT_DIR]
Writes <OUT_DIR>/vocab_orb_k10L3.yml.gz and vocab_lbd_k10L3.yml.gz
(default OUT_DIR: configs/).
"""

import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from plslam_tpu.backend import vocab as V
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend.frame import FrontendConfig
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.vo import VisualOdometry

N_SCENES = 6
N_FRAMES = 8
K, DEPTH = 10, 3


def collect_descriptors():
    pdesc, ldesc = [], []
    for seed in range(N_SCENES):
        scene = SyntheticScene(n_points=400, n_lines=48, seed=seed,
                               width=376, height=240,
                               fx=217.6, fy=217.6, cx=183.7, cy=126.1)
        cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy,
                                  scene.b, width=scene.width,
                                  height=scene.height)
        vo = VisualOdometry(cam, FrontendConfig(n_points=600, n_lines=96))
        for i, T in enumerate(circular_trajectory(N_FRAMES, step_t=0.12)):
            il, ir = scene.render_stereo(T, noise=1.5)
            feats = vo._extract(jnp.asarray(il), jnp.asarray(ir))
            p, l = jax.device_get((feats.points, feats.lines))
            pdesc.append(np.asarray(p.desc)[np.asarray(p.valid)])
            ldesc.append(np.asarray(l.desc)[np.asarray(l.valid)])
        print(f"scene {seed}: {sum(len(d) for d in pdesc)} point / "
              f"{sum(len(d) for d in ldesc)} line descriptors so far",
              flush=True)
    return np.concatenate(pdesc), np.concatenate(ldesc)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(__file__.rsplit("/", 2)[0], "configs")
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    pdesc, ldesc = collect_descriptors()
    print(f"collected {len(pdesc)} ORB + {len(ldesc)} LBD descriptors "
          f"({time.time() - t0:.0f}s)")
    for name, desc in (("vocab_orb_k10L3.yml.gz", pdesc),
                       ("vocab_lbd_k10L3.yml.gz", ldesc)):
        voc = V.train_vocabulary(desc, k=K, depth=DEPTH)
        path = os.path.join(out, name)
        V.save_dbow2_vocabulary(path, voc)
        # round-trip sanity
        back = V.load_dbow2_vocabulary(path)
        assert back.num_words == voc.num_words
        print(f"{path}: {voc.num_words} words, "
              f"{os.path.getsize(path) / 1024:.0f} KiB")


if __name__ == "__main__":
    main()
