"""What spreading the table over a cluster costs the resident scans.

    python -m rustic_tpu_torch.probe_resident

VeachMIS cut to two triangle tiles (1,024 triangles: the plates and the
backdrop whole, the emissive spheres nearest the camera) fits the shared
memory of one block, so the resident scans (K14-K16) can run on it with
a cluster of 1, where one block holds the whole table, and with its
table spread over clusters of 2, 4 and 8. Each rank of a cluster tests a
ray block against its own chunks only (csrc/flash_resident.cu), so no
read of the table leaves its SM at any cluster size: what the cluster
adds is a rank's looser running limits (its own winners only), the
ranks' uneven shares of a ray block's work, one cluster barrier a ray
block and c - 1 reads of other ranks' shared memory a ray at the merge.
One group of 1024x1024x4 lanes is traced through the kernel-shade loop;
K14 runs on its camera rays, K15 on the sorted bounce-1 rays with the
bounce-0 shadow rays, K16 on the sorted bounce-3 shadow rays, each
beside its grid-form twin (K9-K11) and held equal to it.

Prints the card's name and power limit, then per scan the grid form's
time and, per cluster size, the resident form's time (the median of 5
CUDA-event timings), the clusters the card seats at once and the SMs
they cover.
"""

from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch

from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets
from rustic_tpu_torch.scene import cuts
from rustic_tpu_torch.scene.gltf import load_glb
from rustic_tpu_torch.scene.world import World

SIZE, FOLD, TRIANGLES = 1024, 4, 1024
CAMERA = dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))
SCANS = {
    "K14": ("nearest_resident", "K9", FI.nearest_resident, FI.nearest_grid),
    "K15": ("nearest_shadow_resident", "K10", FI.nearest_shadow_resident, FI.nearest_shadow_grid),
    "K16": ("occlude_resident", "K11", FI.occlude_resident, FI.occlude_grid),
}


def two_tile_scene(device):
    gltf = load_glb("assets/scenes/VeachMIS.glb")
    cut = cuts.VEACH_ONE_TILE
    tri = gltf.triangles
    keep = np.isin(tri[:, 3], cut.whole)
    centroids = gltf.positions[tri[:, :3]].astype(np.float64).mean(axis=1)
    dist = np.linalg.norm(centroids - np.asarray(cut.toward, np.float64), axis=1)
    (material,) = cut.partial
    ids = np.flatnonzero(tri[:, 3] == material)
    keep[ids[np.argsort(dist[ids], kind="stable")[: TRIANGLES - int(keep.sum())]]] = True
    return World(cuts.keep_triangles(gltf, np.flatnonzero(keep))).to_torch(device)


def traced_operands(scene, device):
    """One group through the kernel-shade loop (grid scans) -> the ray
    rows each scan gets: {scan: (nearest rows, shadow rows)}."""
    config = TracingConfig(width=SIZE, height=SIZE, nee=NextEventEstimation.MIS, **CAMERA)
    cfg, cam = config.static_part(), config.dynamic_part(device)
    y, x = np.mgrid[0:SIZE, 0:SIZE]
    px = torch.from_numpy(x.reshape(-1).astype(np.int32)).to(device).repeat(FOLD)
    py = torch.from_numpy(y.reshape(-1).astype(np.int32)).to(device).repeat(FOLD)
    off = pixel_offsets(SIZE, SIZE, use_blue_noise=False).view(np.int32)
    off = torch.from_numpy(off.copy()).to(device).repeat(FOLD)
    st, feats_t, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
    pending = inv = feats_in = None
    bounces = []
    for b in range(cfg.max_bounces):
        rays = feats_t if feats_in is None else feats_in
        t, i, occ = P._scan(rays, pending, scene, "grid")
        t, i, occ, attrs_t = P.ks_resolve(scene, feats_t, t, i, occ, inv)
        st, nf, sf = SK.shade_bounce_wide(
            cfg, b, params, scene.entry_rows, st, feats_t, t, i, attrs_t, occ, sidx, off,
            has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
        bounces.append((rays, pending))
        feats_in, pending, inv = P.ks_sort(scene, st, nf, sf)
        if nf is not None:
            feats_t = nf
    return {"K14": (bounces[0][0], None), "K15": bounces[1], "K16": (None, pending)}


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> int:
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a"
    print(card)
    scene = two_tile_scene(device)
    g16, aabbs = scene.tri_feats16, scene.tile_aabbs
    t_pad, tt, nt = FI.geometry(g16)
    n_chunks = t_pad // FI.CHUNK
    print(f"{scene.n_tris} triangles in {nt} tiles of {tt}, {n_chunks} chunks of {FI.CHUNK}; "
          f"device budget {FI.resident_budget(device)}, plan {FI.use_resident(g16)}")
    cases = traced_operands(scene, device)
    planned = FI.use_resident
    for key, (name, grid_key, resident, grid) in SCANS.items():
        rows = [x for x in cases[key] if x is not None]
        lanes = rows[0].shape[1]
        want = grid(*rows, g16, aabbs, n_live=scene.n_tris)
        print(f"{grid_key} (grid form) at {lanes} lanes: "
              f"{time_ms(lambda: grid(*rows, g16, aabbs, n_live=scene.n_tris)):.3f} ms ({card})")
        for c in (1, 2, 4, 8):
            plan = FI.ResidentPlan(c, -(-n_chunks // c))
            FI.use_resident = lambda table, plan=plan: plan
            try:
                got = resident(*rows, g16, aabbs, scene.n_tris)
                ms = time_ms(lambda: resident(*rows, g16, aabbs, scene.n_tris))
            finally:
                FI.use_resident = planned
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            if not all(torch.equal(a, b) for a, b in pairs):
                raise SystemExit(f"{key} in a cluster of {c} differs from {grid_key}")
            active = FI.resident_active_clusters(name, plan, device)
            print(f"{key} cluster of {c} ({active} clusters = {active * c} SMs): {ms:.3f} ms, "
                  f"equal to {grid_key} ({card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
