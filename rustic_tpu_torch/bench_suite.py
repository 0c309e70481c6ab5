"""The BASELINE config suite (twin of tools/bench_suite.py): the five
configurations of BASELINE.md, each rendered once after a warm-up.

Per config: the scene build's seconds (startup_s, the sky included), the
warm-up's (one sample fold), and the timed render's wall seconds,
camera-path throughput (Mpaths/s) and spp/s, at the config's resolution
with its spp divided by `--scale` (resolution is kept, so every kernel
runs at the config's shapes); the film mean; each kernel's launches in
the timed render, and the scene's triangle tiles, alias entries and
whether it has lights, which decide those launches.

  python -m rustic_tpu_torch.bench_suite [--scale 16] [--configs 1,2,3]
      [--out build/bench_suite.json]

Prints one JSON object per config and a summary line; `--out` rewrites a
JSON artifact after every config, with what `bench.host_info` reports. A
config that fails is printed with its error and the run goes on, but the
exit code is then 1. The suite runs on the card: without one it fails.
`run_config(..., device="cpu")` renders on the host for Python callers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

from rustic_tpu_torch import bench
from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.runtime.pipeline import pick_sample_fold
from rustic_tpu_torch.runtime.render import render_image, resolve_device
from rustic_tpu_torch.scene.world import World, load_skybox_image

CONFIGS = {
    1: dict(scene="FurnaceTest.glb", size=(256, 256), spp=64, nee="off",
            skybox=None),
    2: dict(scene="DarkCornell.glb", size=(512, 512), spp=256, nee="mis",
            skybox=None),
    3: dict(scene="GlassTest.glb", size=(512, 512), spp=512, nee="mis",
            skybox=None),
    4: dict(scene="VeachMIS.glb", size=(1024, 1024), spp=1024, nee="mis",
            skybox=None),
    5: dict(scene="BreakTime.glb", size=(1920, 1080), spp=2048, nee="mis",
            skybox="BreakTimeSky.npy"),
}

_NEE = {
    "off": NextEventEstimation.NONE,
    "mis": NextEventEstimation.MIS,
    "direct": NextEventEstimation.DIRECT,
}


def run_config(idx: int, spec: dict, scale: int, device="cuda") -> dict:
    """Config `idx` (a CONFIGS entry, or any spec of that form) on
    `device` with its spp divided by `scale`."""
    device = resolve_device(device)
    w, h = spec["size"]
    spp = max(1, spec["spp"] // max(scale, 1))

    t0 = time.time()
    world = World.from_path(bench.scene_path(spec["scene"]))
    skybox = load_skybox_image(bench.scene_path(spec["skybox"])) if spec["skybox"] else None
    scene = world.to_torch(device, skybox)
    startup_s = time.time() - t0

    kwargs = dict(width=w, height=h, nee=_NEE[spec["nee"]])
    if spec["skybox"]:
        kwargs["has_skybox"] = True
    if spec["scene"] == "BreakTime.glb":
        kwargs["cam_position"] = (0.0, 1.8, -3.2)
    config = TracingConfig(**kwargs)

    # warm with one fold group: the fold sets every launch's lane count,
    # so it builds and loads every kernel the timed render launches
    settings = RenderSettings(samples=spp)
    batch = min(int(settings.batch_pixels), w * h)
    t0 = time.time()
    render_image(scene, config, RenderSettings(samples=pick_sample_fold(batch, spp)), device)
    warm_s = time.time() - t0

    (wall,), film, launches = bench.timed_renders(scene, config, settings, device, reps=1)
    paths = w * h * spp
    return dict(
        config=idx,
        scene=spec["scene"],
        size=f"{w}x{h}",
        spp=spp,
        backend=device.type,
        startup_s=startup_s,
        warmup_s=warm_s,
        wall_s=wall,
        mpaths_per_s=paths / wall / 1e6,
        spp_per_s=spp / wall,
        film_mean=float(film.mean()),
        launches=launches,
        tiles=int(scene.tile_aabbs.shape[0]),
        alias_entries=int(scene.n_alias_entries),
        has_lights=bool(scene.has_lights),
    )


def _write_out(path, results, scale):
    with open(path, "w") as f:
        json.dump({"scale": scale, **bench.host_info(), "configs": results}, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rustic_tpu_torch.bench_suite",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=16, help="divide each config's spp by this")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--out", default=None,
                    help="write the results as a JSON artifact (rewritten after every config)")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    results = []
    for idx in (int(v) for v in args.configs.split(",")):
        try:
            r = run_config(idx, CONFIGS[idx], args.scale, device)
        except Exception as e:  # report it and go on; the exit code says it failed
            traceback.print_exc()
            r = dict(config=idx, scene=CONFIGS[idx]["scene"], error=f"{type(e).__name__}: {e}")
        print(json.dumps(r), flush=True)
        results.append(r)
        if args.out:
            _write_out(args.out, results, args.scale)
    print(json.dumps({
        "summary": {r["scene"]: r["mpaths_per_s"] for r in results if "error" not in r},
        "scale": args.scale,
    }))
    return 1 if any("error" in r for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
