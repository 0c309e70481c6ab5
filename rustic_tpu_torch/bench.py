"""Headline benchmark (twin of bench.py): DarkCornell 1280x720 at 160 spp,
the upstream reference's own performance case (its author's GPU renders it
in 2.408 s: 61.2 M camera paths a second, benches/benchmark.rs:17).

  python -m rustic_tpu_torch.cli bench [--spp 160]
  python -m rustic_tpu_torch.bench [--spp 160]

Prints one JSON line with bench.py's keys: "value" is the camera-path
throughput (Mpaths/s) of the median of three timed `render_image` calls,
each after a device sync and ending in the film's copy to the host, made
after a warm-up render of one sample fold; "vs_baseline" divides it by
61.2. "compile_s" is the warm-up's seconds, "startup_s" the scene build's
and the warm-up's, "total_s" the whole run's. "cache_entries_added" counts
the kernel libraries (build/lib*.so) that nvcc built during the scene
build and the warm-up: "compile_regime" is "cold" when it built any, else
"warm" (every kernel loaded as built). "furnace_ok": pixel (65, 75) of
FurnaceTest at 128x128, 32 spp, is 0.8 +- 0.02 after gamma 1/2.2 (the
value is "furnace_value"). "pbr_multitile_mpaths": PBRTest (24,002
triangles in 47 tiles) at 256x144x8, the median of three renders after one
warm-up render; null with "pbr_skipped" naming the file when the scene is
missing. "launches": each kernel's launches in the last timed render.

The run is on the card: without one `main` fails. It writes the result to
build/bench_torch_last.json (full-spec runs) and appends it to
build/bench_torch_history.jsonl, each with the git head, the card's name
and power limit, the torch and CUDA versions and the host's CPU. The
functions take a `device` for Python callers (the tests pass "cpu", which
runs the kernels' plain versions); only CUDA results are recorded.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.runtime.pipeline import pick_sample_fold
from rustic_tpu_torch.runtime.render import render_image, render_pixels, resolve_device
from rustic_tpu_torch.scene.world import World

WIDTH, HEIGHT, SPP = 1280, 720, 160
BASELINE_MPATHS = 61.2  # 1280*720*160 / 2.408 s (benches/benchmark.rs:17)
PBR = (256, 144, 8)  # PBRTest's width, height and spp
REPS = 3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "assets", "scenes")
LAST_PATH = os.path.join(_build.BUILD_DIR, "bench_torch_last.json")
HISTORY_PATH = os.path.join(_build.BUILD_DIR, "bench_torch_history.jsonl")


def scene_path(name: str) -> str:
    """`name` in the repository's assets/scenes; FileNotFoundError naming
    the path when it is not there."""
    path = os.path.join(SCENES, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"scene file not found: {path}")
    return path


def _counted_modules():
    from rustic_tpu_torch.ops import bvh_traverse, flash_intersect, fused_bounce, probe_dot
    from rustic_tpu_torch.ops import shade_kernel

    return (flash_intersect, shade_kernel, fused_bounce, probe_dot, bvh_traverse)


def reset_launch_counts() -> None:
    for module in _counted_modules():
        module.reset_launch_counts()


def launch_counts() -> dict:
    """{kernel wrapper: launches since the last reset}, the launched ones."""
    out = {}
    for module in _counted_modules():
        out |= {k: n for k, n in module.LAUNCHES.items() if n}
    return out


def kernel_cache_entries() -> int:
    """The kernel libraries built so far (build/lib*.so)."""
    try:
        names = os.listdir(_build.BUILD_DIR)
    except FileNotFoundError:
        return 0
    return sum(n.startswith("lib") and n.endswith(".so") for n in names)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_renders(scene, config, settings, device, reps=REPS):
    """`reps` renders of `settings`, each from a synced device -> (seconds
    of each, the last film, the last render's launch counts)."""
    times = []
    for _ in range(reps):
        _sync(device)
        reset_launch_counts()
        t0 = time.time()
        film = render_image(scene, config, settings, device)  # ends in the copy to the host
        times.append(time.time() - t0)
    return times, film, launch_counts()


def run_headline(width=WIDTH, height=HEIGHT, spp=SPP, device="cuda", reps=REPS) -> dict:
    """DarkCornell NEE+MIS at width x height x spp: the scene build, a
    warm-up of one sample fold, then `reps` timed renders."""
    device = resolve_device(device)
    cache_before = kernel_cache_entries()
    t0 = time.time()
    scene = World.from_path(scene_path("DarkCornell.glb")).to_torch(device)
    scene_build_s = time.time() - t0

    config = TracingConfig(width=width, height=height, nee=NextEventEstimation.MIS)
    settings = RenderSettings(samples=spp)
    # warm with the fold the timed renders use, so every kernel they
    # launch is built and loaded
    batch = min(int(settings.batch_pixels), width * height)
    warm = RenderSettings(samples=pick_sample_fold(batch, spp), batch_pixels=settings.batch_pixels)
    t0 = time.time()
    render_image(scene, config, warm, device)
    warmup_s = time.time() - t0
    cache_added = kernel_cache_entries() - cache_before

    times, film, launches = timed_renders(scene, config, settings, device, reps)
    return dict(scene_build_s=scene_build_s, warmup_s=warmup_s, cache_added=cache_added,
                render_s_all=times, render_s=statistics.median(times), film=film,
                launches=launches)


def furnace_probe(device="cuda", spp=32):
    """Pixel (65, 75) of FurnaceTest at 128x128 (NEE off) through
    `render_pixels` -> (gamma-decoded value, within 0.02 of 0.8)."""
    device = resolve_device(device)
    scene = World.from_path(scene_path("FurnaceTest.glb")).to_torch(device)
    config = TracingConfig(width=128, height=128)
    film = render_pixels(scene, config, np.array([65], np.int32), np.array([75], np.int32), spp)
    value = float((film[0, 0].item() / spp) ** (1 / 2.2))
    return value, abs(value - 0.8) < 0.02


def run_pbr(width=PBR[0], height=PBR[1], spp=PBR[2], device="cuda", reps=REPS):
    """PBRTest NEE+MIS at width x height x spp: one warm-up render, then
    the median of `reps` -> Mpaths/s, or None when the scene file is
    missing."""
    device = resolve_device(device)
    path = os.path.join(SCENES, "PBRTest.glb")
    if not os.path.exists(path):
        return None
    scene = World.from_path(path).to_torch(device)
    config = TracingConfig(width=width, height=height, nee=NextEventEstimation.MIS)
    settings = RenderSettings(samples=spp)
    render_image(scene, config, settings, device)
    times, _, _ = timed_renders(scene, config, settings, device, reps)
    return width * height * spp / statistics.median(times) / 1e6


def bench(width=WIDTH, height=HEIGHT, spp=SPP, device="cuda", pbr=PBR) -> dict:
    """The headline render, the furnace probe and PBRTest's rate on
    `device` -> the result (bench.py's keys, and the port's
    furnace_value, launches and pbr_skipped)."""
    t_start = time.time()
    device = resolve_device(device)
    head = run_headline(width, height, spp, device)
    mpaths = width * height * spp / head["render_s"] / 1e6
    furnace_value, furnace_ok = furnace_probe(device)
    pbr_mpaths = run_pbr(*pbr, device=device)
    added = head["cache_added"]
    return {
        "metric": f"DarkCornell {width}x{height}x{spp}spp camera-path throughput",
        "value": mpaths,
        "unit": "Mpaths/s",
        "vs_baseline": mpaths / BASELINE_MPATHS,
        "render_s": head["render_s"],
        "render_s_all": head["render_s_all"],
        "compile_s": head["warmup_s"],
        "cache_entries_added": added,
        "compile_regime": "cold" if added > 0 else "warm",
        "compile_was_cold": added > 0,
        "scene_build_s": head["scene_build_s"],
        "startup_s": head["scene_build_s"] + head["warmup_s"],
        "total_s": time.time() - t_start,
        "backend": device.type,
        "spp_per_s": spp / head["render_s"],
        "furnace_ok": furnace_ok,
        "furnace_value": furnace_value,
        "film_mean": float(head["film"].mean()),
        "pbr_multitile_mpaths": pbr_mpaths,
        "pbr_skipped": None if pbr_mpaths is not None
        else f"{os.path.join(SCENES, 'PBRTest.glb')} not found",
        "launches": head["launches"],
    }


def _run(cmd) -> str | None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60, cwd=REPO)
    except (OSError, subprocess.SubprocessError):
        return None
    if proc.returncode != 0:
        return None
    return proc.stdout.strip() or None


def _cpu_model() -> str:
    """The host CPU's model name (/proc/cpuinfo, where the host states it)
    and its count of logical CPUs."""
    import platform

    model = platform.processor() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} CPUs"


def host_info() -> dict:
    """What a measurement was taken on: the git head, the card's name and
    power limit (nvidia-smi), the torch and CUDA versions, the host CPU."""
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return {
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git": _run(["git", "rev-parse", "--short", "HEAD"]),
        "card": smi.splitlines()[0] if smi else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cpu": _cpu_model(),
    }


def record(result: dict, spp: int) -> None:
    """Append a card's result to the history, and at the full spec also
    make it the last reading; a host result is not recorded."""
    if result["backend"] != "cuda":
        return
    rec = result | host_info()
    os.makedirs(os.path.dirname(HISTORY_PATH), exist_ok=True)
    with open(HISTORY_PATH, "a") as f:
        f.write(json.dumps(rec) + "\n")
    if spp == SPP:
        with open(LAST_PATH, "w") as f:
            json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rustic_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--spp", type=int, default=SPP)
    args = ap.parse_args(argv)
    result = bench(spp=args.spp)
    print(json.dumps(result), flush=True)
    record(result, args.spp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
