"""Where the time of a render goes on one CUDA device.

    python -m rustic_tpu_torch.profile_render
        [--scene darkcornell|veachmis|glasstest|breaktime]
        [--driver kernel-shade|ray-sorted|unsorted|fused|state-sorted|auto]
        [--scan lists|grid|resident]
        [--single-loop kernel-shade|torch-shade|fused] [--table PATH]

`darkcornell` (the default, the headline render): DarkCornell 1280x720
NEE+MIS, 4 bounces, profiled at 32 spp, then timed at 160 spp.
`veachmis` (the multi-tile render, BASELINE.md config 4 with the spp
cut): VeachMIS 1024x1024 NEE+MIS with the camera of
tools/quality_gate.py, profiled at 16 spp, then timed at 64 spp.
`glasstest` (long glass chains, BASELINE.md config 3 with the spp cut):
GlassTest 512x512 NEE+MIS with the camera of tools/quality_gate.py,
profiled at 16 spp, then timed at 64 spp.
`breaktime` (the full-pipeline render, BASELINE.md config 5 with the spp
cut): BreakTime 1920x1080 NEE+MIS with its HDR sky and textures (4096^2
atlas), profiled at 8 spp, then timed at 32 spp.
`--driver` names the multi-tile loop (RenderSettings.multitile_loop):
`kernel-shade` (the default), the reference loops `ray-sorted` and
`unsorted`, `fused` (K17: one launch a bounce), `state-sorted` (the whole
state re-sorted and compacted after each bounce) or `auto`; `--scan` the
form of its scans (RenderSettings.multitile_scan): `lists`, `grid` or
`resident` (the default is RenderSettings's). Neither changes the single-tile path, whose loop
`--single-loop` names (RenderSettings.single_tile_loop): `kernel-shade`
(the default), `torch-shade` or `fused`.

Renders the scene once as a warm-up, then once under torch.profiler, and
prints: the wall time of the profiled render, the device time summed over
its kernels and copies, the device's idle share (1 - device time / wall
time, one stream so nothing overlaps), and the device time per kernel
(K1-K17), per copy and for the torch glue (on the multi-tile path the glue
is the tile lists, the sort and unsort gathers, and the shading stages or
the row resolve), with the glue's twelve largest kernels and the peak
device memory. `--table` writes the profiler's full table to a file.
Then it times two renders at the timed spp without the profiler.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.runtime.pipeline import (
    MULTITILE_LOOPS,
    MULTITILE_SCANS,
    SINGLE_TILE_LOOPS,
)
from rustic_tpu_torch.runtime.render import render_image
from rustic_tpu_torch.scene.world import World, load_skybox_image

# scene -> (path, sky image or None, config, profiled spp, timed spp)
CONFIGS = {
    "darkcornell": (
        "assets/scenes/DarkCornell.glb", None,
        TracingConfig(width=1280, height=720, nee=NextEventEstimation.MIS),
        32, 160,
    ),
    "veachmis": (
        "assets/scenes/VeachMIS.glb", None,
        TracingConfig(width=1024, height=1024, nee=NextEventEstimation.MIS,
                      cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05)),
        16, 64,
    ),
    "glasstest": (
        "assets/scenes/GlassTest.glb", None,
        TracingConfig(width=512, height=512, nee=NextEventEstimation.MIS,
                      cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0)),
        16, 64,
    ),
    "breaktime": (
        "assets/scenes/BreakTime.glb", "assets/scenes/BreakTimeSky.npy",
        TracingConfig(width=1920, height=1080, nee=NextEventEstimation.MIS,
                      cam_position=(0.0, 1.8, -3.2), has_skybox=True),
        8, 32,
    ),
}

# demangled kernel names -> the port's kernel ids
_KERNELS = {
    "fused_tile_kernel<": "K17 fused_bounce",
    "fused_grid_kernel<": "K17 fused_bounce",  # matched before the grid_kernel< keys
    "scan_kernel<true,false,true>": "K1 nearest_attrs",
    "scan_kernel<true,true,true>": "K2 nearest_shadow_attrs",
    "scan_kernel<false,true,false>": "K3 occlude",
    "scan_kernel<true,false,false>": "K12 nearest",
    "scan_kernel<true,true,false>": "K13 nearest_shadow",
    "shade_kernel<false>": "K4 shade_bounce",
    "shade_kernel<true>": "K8 shade_bounce_wide",
    "grid_kernel<true,false,true>": "K5 nearest_multi",
    "grid_kernel<true,true,true>": "K6 nearest_shadow_multi",
    "grid_kernel<false,true,true>": "K7 occlude_multi",
    "grid_kernel<true,false,false>": "K9 nearest_grid",
    "grid_kernel<true,true,false>": "K10 nearest_shadow_grid",
    "grid_kernel<false,true,false>": "K11 occlude_grid",
    "resident_kernel<true,false>": "K14 nearest_resident",
    "resident_kernel<true,true>": "K15 nearest_shadow_resident",
    "resident_kernel<false,true>": "K16 occlude_resident",
}


def _category(name: str) -> str:
    flat = name.replace(" ", "")
    for key, label in _KERNELS.items():
        if key in flat:
            return label
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    return "torch glue"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=sorted(CONFIGS), default="darkcornell")
    ap.add_argument("--driver", choices=MULTITILE_LOOPS, default=MULTITILE_LOOPS[0])
    ap.add_argument("--scan", choices=MULTITILE_SCANS, default=RenderSettings.multitile_scan)
    ap.add_argument("--single-loop", choices=SINGLE_TILE_LOOPS, default=SINGLE_TILE_LOOPS[0])
    ap.add_argument("--table", help="write the profiler's key_averages table here")
    args = ap.parse_args(argv)
    path, sky, config, profile_spp, spp = CONFIGS[args.scene]
    size = f"{config.width}x{config.height}"
    one_tile = args.scene == "darkcornell"
    loop = (f"{args.single_loop} loop" if one_tile
            else f"{args.driver} loop, {args.scan} scans")

    def settings(samples):
        return RenderSettings(samples=samples, multitile_loop=args.driver,
                              multitile_scan=args.scan, single_tile_loop=args.single_loop)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    scene = World.from_path(path).to_torch(dev, load_skybox_image(sky) if sky else None)
    render_image(scene, config, settings(4), device=dev)  # builds and warms

    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        render_image(scene, config, settings(profile_spp), device=dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_cat: dict[str, list] = {}
    glue = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            cat = _category(evt.key)
            c = by_cat.setdefault(cat, [0.0, 0])
            c[0] += us
            c[1] += evt.count
            if cat == "torch glue":
                glue.append((us, evt.count, evt.key))
    busy_us = sum(v[0] for v in by_cat.values())
    if busy_us == 0:
        raise RuntimeError("the profiler recorded no device time; time with CUDA events")
    print(f"profiled render {args.scene} {size}x{profile_spp} spp, {loop}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: "
          f"wall {wall_us / 1e3:.3f} ms, "
          f"device {busy_us / 1e3:.3f} ms, busy {busy_us / wall_us:.4f}, "
          f"idle {1 - busy_us / wall_us:.4f}")
    for cat, (us, n) in sorted(by_cat.items(), key=lambda kv: -kv[1][0]):
        print(f"  {cat}: {us / 1e3:.3f} ms in {n} launches, "
              f"{us / busy_us:.4f} of device time")
    for us, n, key in sorted(glue, reverse=True)[:12]:
        print(f"    glue {us / 1e3:.3f} ms in {n}: {key[:110]}")
    if args.table:
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(row_limit=200))

    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_image(scene, config, settings(spp), device=dev)
        s = time.perf_counter() - t0
        print(f"render {args.scene} {size}x{spp} spp, {loop}: {s:.4f} s, "
              f"{config.width * config.height * spp / s / 1e6:.2f} Mpaths/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
