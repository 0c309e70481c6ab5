"""The BASELINE quality gate on the card (twin of tools/quality_gate.py).

Two parts, one JSON line per case:

1. The furnace matrix: pixel (65, 75) of FurnaceTest at 128^2, NEE off
   and MIS, at high spp (512 by default) through `render_pixels` with its
   defaults (on the card: the staged pipeline), must equal the 0.8
   albedo within +-0.02 after gamma decode (reference:
   tests/correctness_tests.rs:14-33).

2. RMSE against the reference films: the five committed 256x144 films
   (assets/reference/, rendered by the JAX package on a TPU) and the
   four at-spec films of rustic_tpu_torch/make_reference_films.py (the
   port's BVH oracle, read from --ref-dir). Each case re-renders at the
   film's size and spp through the port's default loop and scan on the
   card (`render_image`, RenderSettings' defaults: hash offsets), so both
   renders integrate the same sample set and the RMSE measures engine
   divergence, not Monte-Carlo noise. Target RMSE < 1e-3, with the
   relative energy and the largest pixel difference beside it. A case
   whose film is absent is reported and skipped.

The results go to standard output and, with --out, to a JSON artifact
rewritten after every case, so a partial run stays on the record.

Usage (from the root of a checkout, on a machine with the card):
  python -m rustic_tpu_torch.quality_gate [--furnace-spp 512] [--cases all]
      [--skip-furnace] [--ref-dir build/reference] [--out gate.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

from rustic_tpu_torch.make_reference_films import (BREAK_CAM, CASES, GLASS_CAM, OUT_DIR,
                                                   VEACH_CAM, film_name)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "assets", "scenes")
REF = os.path.join(REPO, "assets", "reference")

# (scene, skybox, film, spp, camera and NEE): tools/quality_gate.py
# FILM_CASES. The film is a committed film's path, or for the at-spec
# films of make_reference_films.CASES a (W, H) size, whose film is looked
# up by the port's name in --ref-dir. The render's size is the film's own.
FILM_CASES = [
    ("DarkCornell.glb", None, os.path.join(REF, "darkcornell_256x144_2048spp.npy"), 2048, {}),
    ("FurnaceTest.glb", None, os.path.join(REF, "furnacetest_256x144_1024spp.npy"), 1024,
     dict(nee="none")),
    ("VeachMIS.glb", None, os.path.join(REF, "veachmis_256x144_1024spp.npy"), 1024, VEACH_CAM),
    ("GlassTest.glb", None, os.path.join(REF, "glasstest_256x144_1024spp.npy"), 1024, GLASS_CAM),
    ("BreakTime.glb", "BreakTimeSky.npy", os.path.join(REF, "breaktime_256x144_1024spp.npy"),
     1024, BREAK_CAM),
] + CASES


class Gate:
    """The emitted results, and the artifact they are written to."""

    def __init__(self, out_path):
        self.out_path = out_path
        self.results = []

    def emit(self, **kw):
        print(json.dumps(kw), flush=True)
        self.results.append(kw)
        if self.out_path:
            self._write()

    def _write(self):
        try:
            git = subprocess.run(["git", "rev-parse", "--short", "HEAD"], capture_output=True,
                                 text=True, timeout=10, cwd=REPO).stdout.strip() or None
        except (OSError, subprocess.SubprocessError):
            git = None
        with open(self.out_path, "w") as f:
            json.dump({"measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                       "git": git, "results": self.results}, f, indent=1)


def furnace_matrix(gate, spp, device):
    from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
    from rustic_tpu_torch.runtime.render import render_pixels
    from rustic_tpu_torch.scene.world import World

    scene = World.from_path(os.path.join(SCENES, "FurnaceTest.glb")).to_torch(device)
    for nee, label in ((NextEventEstimation.NONE, "off"), (NextEventEstimation.MIS, "mis")):
        config = TracingConfig(width=128, height=128, nee=nee)
        t0 = time.time()
        film = render_pixels(scene, config, np.array([65], np.int32), np.array([75], np.int32),
                             spp)
        probe = float((film.cpu().numpy()[0, 0] / spp) ** (1 / 2.2))
        gate.emit(gate="furnace", nee=label, spp=spp, probe=probe, wall_s=time.time() - t0,
                  ok=bool(abs(probe - 0.8) < 0.02))


def film_rmse(gate, cases, ref_dir, device):
    from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
    from rustic_tpu_torch.runtime.render import render_image
    from rustic_tpu_torch.scene.world import World, load_skybox_image

    scenes = {}
    for name, sky, film, spp, cfg_kw in cases:
        path = film if isinstance(film, str) else os.path.join(
            ref_dir, film_name(name, *film, spp))
        if not os.path.exists(path):
            gate.emit(gate="rmse", scene=name, film=os.path.basename(path),
                      error="reference film missing")
            continue
        ref = np.load(path)
        kw = dict(cfg_kw)
        nee = NextEventEstimation.NONE if kw.pop("nee", None) == "none" else NextEventEstimation.MIS
        if name not in scenes:
            scenes.clear()  # one scene on the card at a time
            skybox = load_skybox_image(os.path.join(SCENES, sky)) if sky else None
            scenes[name] = World.from_path(os.path.join(SCENES, name)).to_torch(device, skybox)
        config = TracingConfig(width=ref.shape[1], height=ref.shape[0], nee=nee, **kw)
        t0 = time.time()
        got = render_image(scenes[name], config, RenderSettings(samples=spp), device)
        wall = time.time() - t0
        d = got.astype(np.float64) - ref
        rmse = float(np.sqrt((d * d).mean()))
        gate.emit(gate="rmse", scene=name, film=os.path.basename(path),
                  size=f"{ref.shape[1]}x{ref.shape[0]}", spp=spp, wall_s=wall, rmse=rmse,
                  target="<1e-3", ok=bool(rmse < 1e-3),
                  rel_energy=float(abs(got.mean() - ref.mean()) / max(float(ref.mean()), 1e-9)),
                  max_abs_d=float(np.abs(d).max()), mean=float(got.mean()),
                  ref_mean=float(ref.mean()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--furnace-spp", type=int, default=512)
    ap.add_argument("--cases", default="all", help="comma-separated scene names, or all")
    ap.add_argument("--skip-furnace", action="store_true")
    ap.add_argument("--ref-dir", default=OUT_DIR, help="where the at-spec films are")
    ap.add_argument("--out", default=None, help="write every result to this JSON file")
    args = ap.parse_args(argv)

    import torch

    from rustic_tpu_torch.runtime.render import resolve_device

    device = resolve_device("cuda")
    gate = Gate(args.out)
    gate.emit(device=str(device), kind=torch.cuda.get_device_name(device))
    if not args.skip_furnace:
        furnace_matrix(gate, args.furnace_spp, device)
    cases = FILM_CASES
    if args.cases != "all":
        keep = set(args.cases.lower().split(","))
        cases = [c for c in cases if c[0].lower().split(".")[0] in keep]
    film_rmse(gate, cases, args.ref_dir, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
