"""A/B of the describe-stage patch reads and of the full-f32 matmul scope,
inside the jitted point+line detect program at EuRoC shape (a 752x480
stereo pair, 1200 ORB slots, 256 line slots).

Variants, all in one process on one device, timed in turns:
  gather        the kept form: patch slices + in-patch gathers, under
                the full-f32 matmul scope (what VisualOdometry runs);
  onehot        the one-hot-matmul reference forms (HIGHEST) in their
                place, under the same scope;
  gather-tf32   the kept form without the scope: the matmuls that state
                no precision run at the default (TF32 on the GPU).

Each round times N back-to-back calls of one variant ending in
block_until_ready; rounds run in the order A B C C B A, repeated.  Prints
the card's name and power limit, one line per variant (median and spread
of the per-call times), and writes the same as JSON under chiprun_out/.

Run: python scripts/ab_patch_forms.py [--rounds 3] [--calls 20]
     (--rehearse: 376x240 on the CPU, to check the script itself)
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import numpy as np  # noqa: E402

from plslam_tpu.core.numerics import full_f32_matmuls  # noqa: E402
from plslam_tpu.frontend import frame  # noqa: E402
from plslam_tpu.io.synthetic import SyntheticScene  # noqa: E402
from plslam_tpu.ops import lbd, orb, patches  # noqa: E402


def build(cfg, shape, form: str, scoped: bool):
    """AOT-compile the detect program with the given patch form."""
    def det(imgs, th):
        return (frame._detect_describe_points_batch(imgs, cfg, th),
                frame._detect_describe_lines_batch(imgs, cfg))

    fn = full_f32_matmuls(det) if scoped else det
    swap = {"extract_patches": patches.extract_patches_onehot,
            "sample_in_patches": patches.sample_in_patches_onehot}
    saved = [(m, k, getattr(m, k)) for m in (orb, lbd) for k in swap]
    try:
        if form == "onehot":
            for m, k, _ in saved:
                setattr(m, k, swap[k])
        imgs = jax.ShapeDtypeStruct((2,) + shape, np.float32)
        th = jax.ShapeDtypeStruct((), np.float32)
        t0 = time.time()
        exe = jax.jit(fn).lower(imgs, th).compile()
        return exe, time.time() - t0
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()
    dev = jax.devices()[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if dev.platform == "gpu" \
        else "no GPU"
    print(f"# {smi}; jax {jax.__version__}; {dev.device_kind}", flush=True)

    s = 2 if args.rehearse else 1
    cfg = frame.FrontendConfig(n_points=1200 // s, n_lines=256 // s)
    shape = (480 // s, 752 // s)
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0,
                           width=shape[1], height=shape[0], fx=435.2 / s,
                           fy=435.2 / s, cx=367.4 / s, cy=252.2 / s)
    imgs = jax.device_put(np.stack(scene.render_stereo(np.eye(4))), dev)
    th = jax.device_put(np.float32(20.0), dev)
    variants = {"gather": ("gather", True), "onehot": ("onehot", True),
                "gather-tf32": ("gather", False)}
    exes, compile_s = {}, {}
    for name, (form, scoped) in variants.items():
        exes[name], compile_s[name] = build(cfg, shape, form, scoped)
        jax.block_until_ready(exes[name](imgs, th))
        print(f"# compiled {name} in {compile_s[name]:.1f} s", flush=True)

    # the forms must agree before their times mean anything
    ref = jax.device_get(exes["gather"](imgs, th))
    alt = jax.device_get(exes["onehot"](imgs, th))
    same = all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(ref), jax.tree.leaves(alt)))
    print(f"# gather and onehot outputs identical: {same}", flush=True)

    names = list(variants)
    order = (names + names[::-1]) * args.rounds
    times = {n: [] for n in names}
    for name in order:
        exe = exes[name]
        t0 = time.perf_counter()
        for _ in range(args.calls):
            out = exe(imgs, th)
        jax.block_until_ready(out)
        times[name].append((time.perf_counter() - t0) / args.calls * 1e3)
    result = {"device": smi, "device_kind": dev.device_kind,
              "platform": dev.platform, "jax": jax.__version__,
              "outputs_identical": bool(same), "variants": {}}
    for n in names:
        t = np.asarray(times[n])
        result["variants"][n] = {
            "median_ms": float(np.median(t)), "min_ms": float(t.min()),
            "max_ms": float(t.max()), "rounds_ms": t.tolist(),
            "compile_s": compile_s[n]}
        print(f"{n:12s} median {np.median(t):.4f} ms/stereo pair "
              f"(min {t.min():.4f}, max {t.max():.4f}; "
              f"{len(t)} rounds x {args.calls} calls)", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ab_patch_forms.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
