"""Headless CLI (twin of rustic_tpu/cli.py): the reference's GUI settings
as flags.

  python -m rustic_tpu_torch.cli render assets/scenes/DarkCornell.glb \\
      --out cornell.png --spp 256 --size 1280x720 --nee mis \\
      --tonemap aces_narkowicz

Subcommands: `render` (one-shot; `--progressive` republishes the frame
every sync-rate samples; `--checkpoint` saves the film and resumes from
it when the file exists; `--interactive` opens the viewer; `--sharded`
splits the frame over the ranks torchrun starts, one card a rank, and
is a world of one without torchrun), `info`, `compare` and `bench` (the
headline benchmark, rustic_tpu_torch/bench.py, on the card only).
Renders run on the card. `main(argv, device=...)` takes another render
device from a Python caller; the command line has no such flag.

  torchrun --nproc-per-node 8 -m rustic_tpu_torch.cli render \
      assets/scenes/DarkCornell.glb --sharded --spp 160 --nee mis
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import sys
import time

import numpy as np

from rustic_tpu_torch.config import (
    NextEventEstimation,
    RenderSettings,
    Tonemapping,
    TracingConfig,
)

_NEE = {
    "off": NextEventEstimation.NONE,
    "none": NextEventEstimation.NONE,
    "mis": NextEventEstimation.MIS,
    "direct": NextEventEstimation.DIRECT,
}
_TONEMAP = {t.name.lower(): t for t in Tonemapping}


def _parse_vec(text: str, n: int):
    parts = [float(p) for p in text.split(",")]
    if len(parts) != n:
        raise SystemExit(f"expected {n} comma-separated floats, got {text!r}")
    return tuple(parts)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rustic_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("render", help="render a scene to an image")
    r.add_argument("scene", help="path to a .glb/.gltf/.obj/.fbx/.stl/.ply scene")
    r.add_argument("--out", default="render.png", help="output PNG path")
    r.add_argument("--save-hdr", default=None, help="also write linear film (.npy/.hdr)")
    r.add_argument("--spp", type=int, default=32)
    r.add_argument("--size", default="1280x720", help="WxH")
    r.add_argument("--nee", choices=sorted(_NEE), default="off")
    r.add_argument("--bounces", type=int, default=4, help="max bounces")
    r.add_argument("--min-bounces", type=int, default=3)
    r.add_argument("--skybox", default=None, help="equirect HDR/LDR image path")
    r.add_argument("--tonemap", choices=sorted(_TONEMAP), default="none")
    r.add_argument("--denoise", action="store_true")
    r.add_argument(
        "--blue-noise",
        action="store_true",
        help="blue-noise pixel seeding for nicer low-spp previews (default: hash)",
    )
    r.add_argument("--camera-pos", default="0,1,-5")
    r.add_argument("--camera-rot", default="0,0", help="pitch,yaw (radians)")
    r.add_argument("--sun", default=None, help="sun direction x,y,z")
    r.add_argument("--sun-intensity", type=float, default=15.0)
    r.add_argument("--specular-clamp", default="0.1,0.9", help="specular weight clamp lo,hi")
    r.add_argument("--engine", choices=["auto", "brute", "bvh", "flash"], default="auto")
    r.add_argument("--sync-rate", type=int, default=32)
    r.add_argument(
        "--stats-json",
        default="-",
        help="write a structured per-render stats JSON line (throughput, "
        "wall splits) to this path; '-' = stderr (default), '' = off",
    )
    r.add_argument("--progressive", action="store_true")
    r.add_argument(
        "--interactive",
        action="store_true",
        help="open the progressive viewer (requires a display)",
    )
    r.add_argument("--sharded", action="store_true", help="use all devices (torch.distributed)")
    r.add_argument("--checkpoint", default=None, help="save/resume .npz checkpoint")

    c = sub.add_parser("compare", help="RMSE between intersection engines / vs a reference film")
    c.add_argument("scene")
    c.add_argument("--spp", type=int, default=16)
    c.add_argument("--size", default="128x128")
    c.add_argument("--nee", choices=sorted(_NEE), default="mis")
    c.add_argument("--reference", default=None, help=".npy reference film (created if missing)")
    c.add_argument("--reference-spp", type=int, default=None)

    i = sub.add_parser("info", help="print scene statistics")
    i.add_argument("scene")

    b = sub.add_parser("bench", help="run the headline benchmark (rustic_tpu_torch/bench.py)")
    b.add_argument("--spp", type=int, default=160)
    return p


def _make_config(args) -> TracingConfig:
    w, h = (int(v) for v in args.size.split("x"))
    sun = _parse_vec(args.sun, 3) if args.sun else (0.5, 1.3, 1.0)
    norm = float(np.linalg.norm(sun))
    if norm < 1e-9:
        raise SystemExit("--sun must be a non-zero direction vector")
    return TracingConfig(
        width=w,
        height=h,
        min_bounces=args.min_bounces,
        max_bounces=args.bounces,
        nee=_NEE[args.nee],
        has_skybox=args.skybox is not None,
        cam_position=_parse_vec(args.camera_pos, 3),
        cam_rotation=_parse_vec(args.camera_rot, 2),
        sun_direction=(*(c / norm for c in sun), args.sun_intensity),
        specular_weight_clamp=_parse_vec(args.specular_clamp, 2),
    )


# how long a rank waits for the others at a collective
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


@contextlib.contextmanager
def _launched_group(device):
    """The process group of a `render --sharded` that torchrun started
    (WORLD_SIZE in the environment), initialized from the environment:
    NCCL on the card, each rank on cuda:LOCAL_RANK, gloo on the CPU.
    Yields (the rank's device, its rank); without torchrun a world of one,
    (device, 0). The group is destroyed on the way out."""
    if "WORLD_SIZE" not in os.environ:
        yield device, 0
        return
    import torch
    import torch.distributed as dist

    if device.type == "cuda":
        local_rank = int(os.environ["LOCAL_RANK"])
        n_cards = torch.cuda.device_count()
        if local_rank >= n_cards:
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} has no card of its own: this host has {n_cards}, and "
                "ranks do not share one (start at most that many processes a node)"
            )
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            timeout=GROUP_TIMEOUT)
    try:
        yield device, dist.get_rank()
    finally:
        dist.destroy_process_group()


def cmd_render(args, device) -> int:
    from rustic_tpu_torch.runtime.render import resolve_device

    device = resolve_device(device)
    if not args.sharded:
        return _render(args, device, rank=0)
    with _launched_group(device) as (device, rank):
        return _render(args, device, rank)


def _render(args, device, rank: int) -> int:
    """The render command on `device`; only rank 0 writes files and the
    stats line."""
    from rustic_tpu_torch.scene.world import World, load_skybox_image
    from rustic_tpu_torch.utils.image_io import save_hdr, save_png

    t0 = time.time()
    world = World.from_path(args.scene)
    sky = load_skybox_image(args.skybox) if args.skybox else None
    scene = world.to_torch(device, sky)
    config = _make_config(args)
    settings = RenderSettings(
        samples=args.spp,
        sync_rate=args.sync_rate,
        denoise=args.denoise,
        use_blue_noise=args.blue_noise,
        tonemap=_TONEMAP[args.tonemap],
        engine=args.engine,
    )
    scene_build_s = time.time() - t0
    print(f"[rustic_tpu_torch] scene ready in {scene_build_s:.2f}s", file=sys.stderr)

    t0 = time.time()
    if args.interactive:
        from rustic_tpu_torch.runtime.viewer import Viewer

        # the host-side World + skybox let the viewer switch scenes and
        # skyboxes at runtime
        Viewer(scene, config, settings, world=world, skybox=sky).run()
        return 0
    resumed = 0
    if args.progressive or args.checkpoint:
        from rustic_tpu_torch.runtime.state import Checkpoint, TracingState

        state = TracingState(config.width, config.height, config, settings)
        if args.checkpoint and os.path.exists(args.checkpoint):
            state = Checkpoint.load(args.checkpoint).into_state(settings)
            resumed = int(state.samples)
            print(f"[rustic_tpu_torch] resumed at {state.samples} spp", file=sys.stderr)

        def on_frame(frame, samples):
            print(
                f"[rustic_tpu_torch] {samples}/{args.spp} spp "
                f"({samples / max(time.time() - t0, 1e-9):.1f} spp/s)",
                file=sys.stderr,
            )

        film = state.run(scene, target_samples=args.spp, on_frame=on_frame)
        if args.checkpoint and rank == 0:
            Checkpoint.from_state(state).save(args.checkpoint)
    elif args.sharded:
        from rustic_tpu_torch.parallel.shard import render_sharded

        film = render_sharded(scene, config, settings, engine=args.engine)
    else:
        from rustic_tpu_torch.runtime.render import render_image

        film = render_image(scene, config, settings, device, engine=args.engine)
        if settings.denoise:
            from rustic_tpu_torch.runtime.denoise import denoise

            film = denoise(film, device=device)
    dt = time.time() - t0
    # throughput counts only the samples rendered by this run: a checkpoint
    # resume would otherwise count samples it never traced
    rendered = max(args.spp - resumed, 0)
    paths = config.width * config.height * rendered
    print(
        f"[rustic_tpu_torch] rendered {rendered} spp in {dt:.2f}s "
        f"({paths / dt / 1e6:.1f} Mpaths/s)",
        file=sys.stderr,
    )

    if rank != 0:
        return 0

    # one JSON line per render with the throughput counters
    if args.stats_json:
        from rustic_tpu_torch.ops.intersect import _pick_engine
        from rustic_tpu_torch.utils.profiling import RenderStats

        stats = RenderStats(
            width=config.width,
            height=config.height,
            samples=rendered,
            max_bounces=config.max_bounces,
            nee=config.nee != NextEventEstimation.NONE,
            wall_s=dt,
        )
        line = json.dumps(
            {
                "scene": os.path.basename(args.scene),
                "backend": scene.device.type,
                "engine": _pick_engine(scene, args.engine),
                "samples_resumed": resumed,
                "mpaths_per_s": round(stats.mpaths_per_s, 6),
                "est_mrays_per_s": round(stats.est_mrays_per_s, 1),
                "spp_per_s": round(stats.spp_per_s, 2),
                "render_s": round(dt, 3),
                "scene_build_s": round(scene_build_s, 3),
                "film_mean": round(float(np.asarray(film).mean()), 6),
            }
        )
        if args.stats_json == "-":
            print(line, file=sys.stderr)
        else:
            with open(args.stats_json, "a") as fh:
                fh.write(line + "\n")

    save_png(args.out, film, settings.tonemap)
    print(f"[rustic_tpu_torch] wrote {args.out}", file=sys.stderr)
    if args.save_hdr:
        save_hdr(args.save_hdr, film)
    return 0


def cmd_info(args) -> int:
    from rustic_tpu_torch.scene.world import World

    world = World.from_path(args.scene)
    lt = world.light_table
    print(f"triangles:  {len(world.triangles)}")
    print(f"vertices:   {len(world.positions)}")
    print(f"materials:  {len(world.mat_albedo)}")
    print(f"bvh nodes:  {world.bvh.n_nodes}")
    print(f"lights:     {0 if lt.is_sentinel else len(lt)}")
    print(f"textured:   {int(world.mat_has_tex.any())}")
    return 0


def cmd_compare(args, device) -> int:
    from rustic_tpu_torch.scene.world import load_scene
    from rustic_tpu_torch.utils.compare import compare_engines, reference_compare

    scene = load_scene(args.scene, device=device)
    w, h = (int(v) for v in args.size.split("x"))
    config = TracingConfig(width=w, height=h, nee=_NEE[args.nee])
    result = {"engines": compare_engines(scene, config, args.spp, device=scene.device)}
    if args.reference:
        result["reference"] = reference_compare(
            scene, config, args.spp, args.reference,
            reference_samples=args.reference_spp, device=scene.device,
        )
    print(json.dumps(result, indent=2))
    return 0


def main(argv=None, device="cuda") -> int:
    """Run one subcommand. `device` is the render device (a keyword for
    Python callers, not a command-line flag)."""
    args = build_parser().parse_args(argv)
    if args.command == "render":
        return cmd_render(args, device)
    if args.command == "info":
        return cmd_info(args)
    if args.command == "bench":
        from rustic_tpu_torch import bench

        return bench.main(["--spp", str(args.spp)])
    return cmd_compare(args, device)


if __name__ == "__main__":
    sys.exit(main())
