"""Render the at-spec reference films with the BVH oracle on the card
(twin of tools/make_reference_films.py).

The committed ground truths (assets/reference/) are 256x144 only, while
BASELINE.md's RMSE gate is defined at the configurations' resolutions
(512^2 for configs 2-3, 1024^2 for config 4, 1920x1080 for config 5).
This renders those films through the "bvh" engine (kernel K20,
ops/bvh_traverse.py) under the torch integrator
(ops/trace.py `accumulate_samples`), not through the scan kernels of the
production pipeline, and saves them as
`<scene>_<W>x<H>_<spp>spp_bvh_torch.npy`: names that say the engine and
the package, so the JAX gate never reads them as its own films.

Methodology, the JAX tool's: the sampler is a pure function of (pixel,
sample) with hash offsets (`pixel_offsets(..., use_blue_noise=False)`,
RenderSettings' default), so a same-spp re-render by the production
engine integrates the identical sample set and the RMSE between the two
measures engine divergence, not Monte-Carlo noise
(rustic_tpu_torch/quality_gate.py reads these films). The frame is
rendered in pixel chunks and sample chunks, each folded into the chunk's
film on the card.

Four f32 films come to ~44 MB, so they are written to build/reference/
(ignored by git) by default; each film's mean, the sha256 of its bytes
and K20's launch counts (`bvh_traverse.LAUNCHES`) are printed, so that a
later run can show it reproduced them.

Usage (from the root of a checkout, on a machine with the card):
  python -m rustic_tpu_torch.make_reference_films [--cases darkcornell,...]
      [--size 256x144] [--out-dir build/reference] [--profile]
`--size` renders the cases at another size (to time them); the name
then says that size. `--profile` also prints, for each case, K20's share
of the device time of its first render_pixels call (`k20_share`).
`k20_operands` gives the rays K20 takes in the oracle's first call, in
pixel order, to the kernel probes (probe_kernel_builds `bvh`,
chip_smoke.py's phase 31).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "assets", "scenes")
OUT_DIR = os.path.join(REPO, "build", "reference")

GLASS_CAM = dict(cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0))
VEACH_CAM = dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))
BREAK_CAM = dict(cam_position=(0.0, 1.8, -3.2), has_skybox=True)

# (scene, skybox, size, spp, camera): tools/make_reference_films.py CASES,
# the BASELINE configuration resolutions, NEE+MIS
CASES = [
    ("DarkCornell.glb", None, (512, 512), 256, {}),
    ("GlassTest.glb", None, (512, 512), 256, GLASS_CAM),
    ("VeachMIS.glb", None, (1024, 1024), 128, VEACH_CAM),
    ("BreakTime.glb", "BreakTimeSky.npy", (1920, 1080), 64, BREAK_CAM),
]

SPP_CHUNK = 8  # samples a render_pixels call
PX_CHUNK = 1 << 20  # pixels a render_pixels call


def film_name(scene: str, w: int, h: int, spp: int) -> str:
    return f"{scene.split('.')[0].lower()}_{w}x{h}_{spp}spp_bvh_torch.npy"


def film_digest(film: np.ndarray) -> str:
    """sha256 of the film's f32 bytes."""
    return hashlib.sha256(np.ascontiguousarray(film, np.float32).tobytes()).hexdigest()


def render_oracle_chunked(scene, config, spp):
    """The mean film [H, W, 3] of `config` through the "bvh" engine,
    PX_CHUNK pixels and SPP_CHUNK samples a call, with hash offsets."""
    from rustic_tpu_torch.runtime.render import pixel_offsets, render_pixels

    w, h = config.width, config.height
    y, x = np.mgrid[0:h, 0:w]
    px = x.reshape(-1).astype(np.int32)
    py = y.reshape(-1).astype(np.int32)
    offsets = pixel_offsets(w, h, use_blue_noise=False)
    out = np.empty((w * h, 3), np.float32)
    for lo in range(0, w * h, PX_CHUNK):
        hi = min(lo + PX_CHUNK, w * h)
        film = torch.zeros((hi - lo, 3), dtype=torch.float32, device=scene.device)
        for s0 in range(0, spp, SPP_CHUNK):
            film = render_pixels(scene, config, px[lo:hi], py[lo:hi], min(SPP_CHUNK, spp - s0),
                                 offsets=offsets[lo:hi], sample_start=s0, engine="bvh",
                                 film_in=film)
        out[lo:hi] = film.cpu().numpy()
    return (out / max(spp, 1)).reshape(h, w, 3)


def k20_operands(scene, config, n_px):
    """K20's operands in the oracle's first `trace_paths` call (sample 0
    of the frame's first n_px pixels, render_oracle_chunked's first chunk)
    -> [(label, (ro, rd) or (ro, rd, max_t))] in launch order: "K20n bounce
    b" for the nearest-hit rays of bounce b, "K20a bounce b" for its shadow
    rays (a bounce without NEE launches no K20a). The rays are in pixel
    order, as the oracle traces them."""
    from rustic_tpu_torch.ops import bvh_traverse as BV
    from rustic_tpu_torch.runtime.render import pixel_offsets, render_pixels

    w, h = config.width, config.height
    y, x = np.mgrid[0:h, 0:w]
    px = x.reshape(-1)[:n_px].astype(np.int32)
    py = y.reshape(-1)[:n_px].astype(np.int32)
    offsets = pixel_offsets(w, h, use_blue_noise=False)[:n_px]
    calls, real = [], (BV.bvh_nearest, BV.bvh_occluded)

    def nearest(sc, ro, rd):
        calls.append((f"K20n bounce {sum(k.startswith('K20n') for k, _ in calls)}",
                      (ro.clone(), rd.clone())))
        return real[0](sc, ro, rd)

    def occluded(sc, ro, rd, max_t):
        calls.append((f"K20a bounce {sum(k.startswith('K20n') for k, _ in calls) - 1}",
                      (ro.clone(), rd.clone(), max_t.clone())))
        return real[1](sc, ro, rd, max_t)

    BV.bvh_nearest, BV.bvh_occluded = nearest, occluded
    try:
        render_pixels(scene, config, px, py, 1, offsets=offsets, sample_start=0, engine="bvh")
    finally:
        BV.bvh_nearest, BV.bvh_occluded = real
    return calls


def k20_share(scene, config):
    """K20's share of the device time of the oracle's first render_pixels
    call (SPP_CHUNK samples of the frame's first PX_CHUNK pixels) under
    torch.profiler -> {"device_ms", "k20_ms", "k20_share", "wall_ms",
    "k20_launches"}: the device time of every kernel and copy, K20's of
    the kernels named bvh_kernel; "wall_ms" is the same call's host time
    without the profiler, so "device_ms" over "wall_ms" is the busy
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rustic_tpu_torch.runtime.render import pixel_offsets, render_pixels

    w, h = config.width, config.height
    n = min(PX_CHUNK, w * h)
    y, x = np.mgrid[0:h, 0:w]
    px, py = x.reshape(-1)[:n].astype(np.int32), y.reshape(-1)[:n].astype(np.int32)
    offsets = pixel_offsets(w, h, use_blue_noise=False)[:n]

    def run():
        return render_pixels(scene, config, px, py, SPP_CHUNK, offsets=offsets, sample_start=0,
                             engine="bvh")

    run()  # warm: the kernels built and loaded
    torch.cuda.synchronize()
    t0 = time.time()  # the wall time without the profiler, which slows the host
    run()
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_us = k20_us = 0.0
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # host events; their kernels are listed apart
            continue
        us = ev.self_device_time_total
        device_us += us
        if "bvh_kernel" in ev.key:
            k20_us += us
            launches += ev.count
    return {"device_ms": device_us / 1e3, "k20_ms": k20_us / 1e3,
            "k20_share": k20_us / device_us if device_us else None, "wall_ms": wall,
            "k20_launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="all", help="comma-separated scene names, or all")
    ap.add_argument("--size", default=None, help="WxH to render instead of each case's size")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--profile", action="store_true",
                    help="also print K20's share of the device time of each case's first "
                         "render_pixels call (torch.profiler)")
    args = ap.parse_args(argv)

    from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
    from rustic_tpu_torch.ops import bvh_traverse as BV
    from rustic_tpu_torch.runtime.render import resolve_device
    from rustic_tpu_torch.scene.world import World, load_skybox_image

    device = resolve_device("cuda")
    cases = CASES
    if args.cases != "all":
        keep = set(args.cases.lower().split(","))
        cases = [c for c in cases if c[0].lower().split(".")[0] in keep]
    os.makedirs(args.out_dir, exist_ok=True)
    for name, sky, size, spp, cam in cases:
        w, h = (int(v) for v in args.size.split("x")) if args.size else size
        out = os.path.join(args.out_dir, film_name(name, w, h, spp))
        if os.path.exists(out):
            print(json.dumps({"film": os.path.basename(out), "skipped": "exists"}), flush=True)
            continue
        t0 = time.time()
        skybox = load_skybox_image(os.path.join(SCENES, sky)) if sky else None
        scene = World.from_path(os.path.join(SCENES, name)).to_torch(device, skybox)
        load = time.time() - t0
        config = TracingConfig(width=w, height=h, nee=NextEventEstimation.MIS, **cam)
        BV.reset_launch_counts()
        t0 = time.time()
        film = render_oracle_chunked(scene, config, spp)
        wall = time.time() - t0
        launches = dict(BV.LAUNCHES)
        if not np.isfinite(film).all():
            raise RuntimeError(f"{out}: non-finite radiance")
        np.save(out, film)
        print(json.dumps({
            "film": os.path.basename(out), "engine": "bvh", "device": str(device),
            "load_s": round(load, 2), "wall_s": round(wall, 2), "mean": float(film.mean()),
            "mpaths_per_s": w * h * spp / wall / 1e6, "sha256": film_digest(film),
            "launches": launches,
        }), flush=True)
        if args.profile:
            print(json.dumps({"film": os.path.basename(out), "profile": k20_share(scene, config)}),
                  flush=True)
        del scene
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
