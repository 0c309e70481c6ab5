#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: the headline render
(DarkCornell, one triangle tile, kernels K1-K4), the multi-tile renders
(VeachMIS, six tiles): the kernel-shade loop, the default (kernels K5-K7
and K8), and the reference loops, unsorted and ray-sorted (K5-K7 and the
torch shading stages), and the full-pipeline render (BreakTime, 21 tiles,
textures, normal maps, HDR sky) through the kernel-shade loop with each
scan form: tile lists and K5-K7, or the grid form K9-K11; then the
one-tile scenes the kernel-shade loop does not take (one-tile cuts of
BreakTime and VeachMIS) and DarkCornell through the torch-shade loop
(K12, K13, K3), held to the brute-force integrator, and VeachMIS through
the kernel-shade loop with the resident scans (K14-K16, the triangle
table in a thread-block cluster's shared memory); then the fused loop
(K17: one launch a bounce, scan and shading in one kernel) on DarkCornell
and VeachMIS; then FurnaceTest, GlassTest and PBRTest timed in each scan
form (the grid form, K9-K11, is the default), the state-sorted driver
(path compaction; the scans on whole-state-sorted rays, torch shading)
and "auto" against the kernel-shade loop, and the DarkCornell, GlassTest
and FurnaceTest reference films; and the dot-rate probes (K18, K19)
through their program, rustic_tpu_torch/probe_dot_floor.py.

Run from the root of a checkout:  python3 chip_smoke.py
(`--only PHASE[,PHASE...]` runs the device phase and the named ones.)

Phases, each of which must pass (the first that fails ends the run):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; the kernel sources of rustic_tpu_torch/csrc built by nvcc,
     one process per source, all started together.
  2. check: each kernel against its plain PyTorch version on the card, on
     real DarkCornell lanes of the main path, at the main path's shape
     (3,686,400 lanes) and on its first 65,536 lanes (K1-K3 also at
     65,536 + 77): winner index and occlusion equal on >= 99.99% of rays,
     t within rtol 1e-5 and the attr row exact where the index agrees;
     K4's outputs within rtol 1e-4, atol 1e-5. The kernels line reports
     the largest error at the main path's shape.
  3. time: each kernel and its plain version at the main path's shape
     (1280x720 pixels x 4 folded samples = 3,686,400 lanes), the median
     of 10 CUDA-event timings, taken in turns; the share of K1-K3's pairs
     and warp iterations that the skip test sends to the exact epilogue
     (its torch twin, FI.skip_scan, on the first 65,536 lanes).
  4. render: DarkCornell 1280x720, NEE+MIS, 4 bounces, 160 spp (the
     headline render of bench.py) through render_image on the card, after
     a warm-up of one sample fold; Mpaths/s; the kernel launch counts of that render,
     which must match its fold and bounce structure; the film mean, which
     must be finite and within 2% of 0.03945.
  5. cross-device: a 64x64x4 film rendered on the card (kernels) and on the
     host CPU (plain versions) must agree within rtol 1e-4, atol 1e-5.
  6. multi-check: one VeachMIS fold group (1024x1024 x 4 = 4,194,304
     lanes, NEE+MIS, the camera of tools/quality_gate.py) traced through
     K5/K6 and the stage functions; K5 on bounce-0 rays, K6 on bounce-1
     rays plus the bounce-0 shadow rays, K7 on the bounce-3 shadow rays,
     each against its plain version on the same admitted-tile lists at
     65,536, 65,613 and 4,194,304 lanes: K5 and K6, which also run each
     ray's own slab test inside the listed tiles for the nearest set,
     equal to their plain versions (the lists alone) bit for bit (NaN
     equal to NaN); K7 index and occlusion equal on >= 99.99% of rays.
  7. multi-time: K5-K7 and their plain versions at 4,194,304 lanes, in
     turns, as phase 3 but medians of 3 (the lists are built before the
     timed launches);
     each bound over the pairs its loop needs on this data (the nearest
     set: the listed tiles that each ray's slab test admits at its running
     best t; the any-hit set: the listed tiles a ray reaches before it is
     occluded), and beside it the bound over every pair the lists admit.
  8. multi-render: VeachMIS 1024x1024, NEE+MIS, 4 bounces, 16 spp through
     the unsorted loop after a one-group warm-up;
     Mpaths/s; launch counts K5 1, K6 15, K7 1 and none of K1-K4, K8; a
     finite film.
  9. sort-check: one VeachMIS fold group traced through the ray-sorted
     loop: admitted tiles per 256-ray block of the sorted bounce-1 rays
     with the bounce-0 shadow rays (K6's lists) and of the sorted bounce-3
     shadow rays (K7's), and the blocks that are all sentinel; K5 (on the
     sorted bounce-1 rays), K6 and K7 against their plain versions on these
     operands as phase 6 checks them, at 4,194,304 lanes and on the last
     65,613 (where the sentinel blocks, which admit no tile, lie). K5 on
     sorted rays is off every path (each loop runs K5 once a render, on
     the unsorted bounce-0 camera rays of phases 6-7), a check only.
 10. shade-check: the same group traced through the kernel-shade loop
     (the main path); K8 against its plain version on all 4,194,304 lanes
     of every bounce, bit for bit (NaN equal to NaN), and K8 and its plain
     version timed on bounce 1 as phase 3; the admitted tiles of its
     sorted operands, and K6 and K7 on them checked as phase 6 and timed
     as phase 7; K6 equal to K10 bit for bit on its operands.
 11. sorted-renders: VeachMIS 1024x1024, NEE+MIS, 64 spp through the
     kernel-shade loop (the default) and the ray-sorted loop, each after
     a one-group warm-up; Mpaths/s; launch counts K5 1, K6 63, K7 1 and,
     for the kernel-shade loop, K8 64; none of K1-K4 (nor K8 on the
     ray-sorted loop).
 12. multi-film: VeachMIS 256x144 x 1024 spp through the kernel-shade and
     the ray-sorted loop with tile lists and the state-sorted driver in
     the default scan form against the committed reference film
     (assets/reference/veachmis_256x144_1024spp.npy): relative energy
     within 1%, RMSE under the bound of tests/test_reference_films.py;
     each render's launch counts (the state-sorted driver: its pilot,
     then per group the nearest scan once, the merged scan once a later
     bounce and the any-hit scan once).
 13. multi-cross-device: VeachMIS 64x64x4 through the kernel-shade and
     the ray-sorted loop and the state-sorted driver (the unsorted loop's
     film is held to the JAX film by the CPU tests), and
     FurnaceTest 64x64x4 (5,120 alias entries) through the kernel-shade
     loop, card against host CPU, rtol 1e-4, atol 1e-5; launch counts
     as phase 12.
 14. breaktime-check: BreakTime (BASELINE.md config 5: 1920x1080, NEE+MIS,
     4 bounces, HDR sky, the camera of tools/quality_gate.py) loaded once
     (PNG decode, the 4096^2 atlas and the upload timed); one fold group
     of its first pixel chunk (1,048,576 pixels x 4 = 4,194,304 lanes)
     traced through the kernel-shade loop in the grid form. K9 on the
     bounce-0 camera rays, K10 on the sorted bounce-1 rays with the
     bounce-0 shadow rays, K11 on the sorted bounce-3 shadow rays, each
     against its plain version (index and occlusion equal on >= 99.99% of
     rays, t within rtol 1e-5, the tiles each block visits equal) at
     65,536, 65,613 and 4,194,304 lanes, and against K5-K7 on the same
     operands with their tile lists, as closely; K5 and K6 on these
     operands equal to their plain versions (the lists alone) bit for bit;
     the tiles each block visits (grid) and admits (lists). The shade kernel of the path (K4:
     BreakTime has 2 alias entries) and K8, both in HDR mode, bit-equal to
     their plain version on every bounce.
 15. breaktime-time: K9-K11 and their plain versions in turns as phase 7
     (2 turns: a plain version takes 3-6 s); the lane utilisation a loop of one thread a ray would
     have (admitted lanes over 32 x the warp-tiles with one), and the
     exact-epilogue shares of the skip test as phase 3; each form's whole
     scan, block_tile_lists plus K5-K7 against K9-K11 alone, and the list
     pre-pass alone.
 16. breaktime-renders: BreakTime 1920x1080 x 32 spp (BASELINE's 2048 cut
     for card time; the rate is per path) through the kernel-shade loop,
     with "lists" and with "grid", each after a one-group warm-up;
     Mpaths/s; launch counts per the 2 pixel chunks x 8 groups x 4
     bounces (K9 2, K10 62, K11 2, K4 64 on the grid render, none of
     K5-K7 and no block_tile_lists call there); a finite film.
 17. breaktime-film: BreakTime 256x144 x 1024 spp with each scan form,
     and through the state-sorted driver (default form), against
     assets/reference/breaktime_256x144_1024spp.npy: relative energy
     within 1%, RMSE under the bound of tests/test_reference_films.py;
     launch counts as phase 12.
 18. breaktime-cross-device: BreakTime 64x64x4 with each scan form, card
     against host CPU (the resident form against the grid form's host
     film: on the host both run one plain version): entries outside rtol 1e-4 / atol 1e-5 no more than
     the card's own film moves under a one-ulp camera shift (an ulp of a
     direction changes a path under the HDR sun; the card's sin, cos,
     atan2 and asin are not the host's to the ulp), at most 1%, and film
     means within 1e-4 relative.
 19. single-check: one DarkCornell group traced again; K12 and K13 against
     their plain versions as phase 2 checks K1 and K2, and equal to K1's
     and K2's (t, idx, occ) bit for bit, at 65,536, 65,613 and 3,686,400
     lanes; K12, K13 and their plain versions timed in turns as phase 3.
 20. single-renders: DarkCornell 1280x720 x 16 spp through the
     torch-shade loop (RenderSettings.single_tile_loop), and the one-tile
     cut of BreakTime (rustic_tpu_torch/scene/cuts.py: 512 triangles,
     textured, 4096^2 atlas, HDR sky) 1280x720 x 16 spp, which takes that
     loop by itself; Mpaths/s; launch counts K12 1, K13 15, K3 1 and no
     other kernel; finite films that are not black; DarkCornell's 64x64x4
     film equal to the kernel-shade loop's within rtol 1e-4, atol 1e-5.
 21. single-films: the one-tile cuts of BreakTime and VeachMIS (460 alias
     entries), 64x64x4: the staged film against the brute-force
     integrator (render_image(..., engine="brute")) on the card, and card
     against host CPU; each gated as phase 18 gates BreakTime (the brute
     engine perturbs t at every bounce: twice the shift's entries, 2%).
 22. resident-check: K14-K16 against their plain versions and against
     K9-K11 (index and occlusion equal on >= 99.99% of rays, t within rtol
     1e-5) at 65,536, 65,613 and 4,194,304 lanes on the kernel-shade
     loop's VeachMIS operands (cluster of 3) and BreakTime operands
     (cluster of 8); on VeachMIS also equal to K9-K11 bit for bit; cluster
     size, bytes per rank and active clusters; K14-K16, K9-K11 and
     (VeachMIS) the plain versions timed in turns; K15 on VeachMIS timed
     at every cluster size from 3 to 8.
 23. resident-render: VeachMIS 1024x1024 x 64 spp through the kernel-shade
     loop with multitile_scan="resident": launch counts K14 1, K15 63,
     K16 1, K8 64, none of K5-K7 and K9-K11, no block_tile_lists call; its
     64x64x4 film equal to the grid form's; its 256x144 x 1024 spp film
     against the reference film as phase 12.
 24. fused-check: one DarkCornell group traced again; on every bounce, at
     65,613 and 3,686,400 lanes, K17 against its plain version (scan
     winner, hit and occlusion equal on >= 99.99% of lanes; there the
     outputs within rtol 1e-4, atol 1e-5, as K4's), and against K1/K2 then
     K4 on the card bit for bit (NaN equal to NaN) on the state, the next
     rays and the shadow rays; its held-occlusion mode equal to K2's occ
     (where a shadow ray is pending) and to K4 without a fold. One VeachMIS group (6 tiles, 2,880 alias
     entries: the WIDE flag) traced through K17 itself; on every bounce
     65,536 of its lanes (rows 480-543 of the frame's first sample)
     against the plain version as above and against K10's winner, a row
     gather and K8, bit for bit on every lane (the held occ where a shadow
     ray is pending).
 25. fused-time: K17 and its plain version, then K17 against K2 then K4,
     in turns at 3,686,400 lanes (bounce 1), medians of 10 CUDA-event
     timings; K17's bound. K17 on the VeachMIS group's bounce-1 operands
     (4,194,304 lanes) beside its plain version (median of 3), then against
     K10, the row gather and K8 in turns; its bound over the pairs each
     ray's slab test admits (logged; the kernels line keeps the one-tile
     row).
 26. fused-render: DarkCornell 1280x720 x 160 spp through
     single_tile_loop="fused" and through the kernel-shade loop, in turns
     (two each) after a warm-up; launch counts K17 160, K3 1 and no other
     kernel; the film mean within 2% of 0.03945; its 64x64x4 film equal to
     the kernel-shade loop's bit for bit and to the host CPU's within rtol
     1e-4, atol 1e-5. VeachMIS 1024x1024 x 16 spp through
     multitile_loop="fused" (K10's scan inside K17), launch counts
     K17 16, K7 1; its 64x64x4 film against the kernel-shade loop's,
     rtol 1e-4, atol 1e-5.
 27. scenes-renders: FurnaceTest 256x256 x 64 spp (BASELINE.md config 1),
     GlassTest 512x512 x 64 spp (config 3, 512 spp cut) and PBRTest
     1280x720 x 16 spp, NEE+MIS, 4 bounces, through the kernel-shade loop
     with each scan form the scene admits (PBRTest's table does not fit a
     cluster: the resident form must raise ValueError): a one-group
     warm-up each, then 3 renders of each form in turns; Mpaths/s (median
     and spread) and each render's launch counts, checked.
 28. sorted-modes: one VeachMIS 1024x1024 group traced through the
     state-sorted driver with its pilot's schedule (compacted: the
     bounce-3 operands are a quarter of the lanes); each form's three
     scans on its bounce-1 and bounce-3 operands against their plain
     versions, at 65,613 lanes and at full length: K5/K6 bit for bit, the
     others as phases 14 and 22. Then the state-sorted driver, "auto" and
     the kernel-shade loop (default scan form) in turns on VeachMIS 64 spp
     and the scenes of phase 27, a one-group warm-up each and 3 renders:
     Mpaths/s, launch counts, each scene's pilot schedule, its work
     fraction W and whether auto's pick (state-sorted where W <= 0.7) was
     the faster driver; on VeachMIS the state-sorted driver also in the
     other scan forms (launch counts).
 29. films: DarkCornell (2048 spp), GlassTest and FurnaceTest (NEE off,
     1024 spp) 256x144 against assets/reference as phase 12, through the
     default loop and (the multi-tile two) the state-sorted driver.
 30. probe-check: K18 (FP32 FMAs; TF32, BF16 and int8 tensor cores through
     mma.sync; BF16 through wgmma) and K19 (the six-term split dot at K =
     96, F pre-split or split in the kernel, and the three-term dot at K =
     48, through mma.sync and through wgmma) against their plain
     versions at B = 1,048,576 and 65,613 rays, N = 1024, reps = 8: int8
     equal; the others within rtol 1e-5, atol 1e-5 on the same operands (TF32 and
     BF16 operands rounded to the type beforehand; the plain versions
     multiply in full f32, allow_tf32 off); K19 also within 1e-5 x
     sum_k |F_k| max_n |G_kn| of the float64 dot. Each timed beside its
     plain version and a torch.matmul + amin of the operand type, and
     bound by its unit's peak. Then the probes' program
     (probe_dot_floor.main: the case sweep and the accuracy table), with
     the launch counts read after it.

Each multi-tile loop is named by RenderSettings.multitile_loop, its scan
form by RenderSettings.multitile_scan, a one-tile scene's loop by
RenderSettings.single_tile_loop.

The last two lines of standard output are a JSON object describing each
kernel (its time, plain version's time, launches on its main path's
render, largest error against its plain version, all on the main path's
operands, and the least time the card could take for the same work:
bytes over 3.35 TB/s or operations over the peak of the unit they run on,
67 TFLOP/s FP32 outside the tensor cores, whichever is larger) and then
{"ok": true, "device": {...}}; neither is printed when a phase fails or
no CUDA device exists, and the exit code is then 1.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time
import traceback

WIDTH, HEIGHT = 1280, 720
SPP = 160
FOLD = 4
MAIN_LANES = WIDTH * HEIGHT * FOLD  # 3,686,400
CHECK_LANES = 65536
RAGGED = 77
FILM_MEAN_REF = 0.03945  # DarkCornell 1280x720x160spp NEE+MIS (bench_history.jsonl)

# the multi-tile configuration (BASELINE.md config 4, spp cut to 64)
VEACH = "assets/scenes/VeachMIS.glb"
VEACH_CAM = dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))
MT_SIZE = 1024
MT_SPP = 64
MT_UNSORTED_SPP = 16  # the unsorted loop's render, cut to keep the run short
MT_LANES = MT_SIZE * MT_SIZE * FOLD  # 4,194,304
MT_REF = "assets/reference/veachmis_256x144_1024spp.npy"
MT_REF_SPP = 1024
MT_REF_RMSE_TPU = 1.55e-4  # QUALITY_r5.json, the TPU build at 256x144x1024 spp
FURNACE = "assets/scenes/FurnaceTest.glb"
GLASS_CAM = dict(cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0))

# the other multi-tile scenes, NEE+MIS, 4 bounces, default cameras where
# tools/quality_gate.py names none: FurnaceTest (BASELINE.md config 1),
# GlassTest (config 3, 512 spp cut to 64 for card time) and PBRTest at the
# size of the JAX package's sort-mode crossover (rustic_tpu/runtime/pipeline.py:1714-1721)
OTHER_SCENES = {
    "FurnaceTest": dict(path=FURNACE, size=(256, 256), spp=64, cam={}),
    "GlassTest": dict(path="assets/scenes/GlassTest.glb", size=(512, 512), spp=64, cam=GLASS_CAM),
    "PBRTest": dict(path="assets/scenes/PBRTest.glb", size=(1280, 720), spp=16, cam={}),
}
# each scan form's (nearest, merged, any-hit) wrappers, by their launch-count names
SCAN_KERNELS = {
    "lists": ("nearest_multi", "nearest_shadow_multi", "occlude_multi"),
    "grid": ("nearest_grid", "nearest_shadow_grid", "occlude_grid"),
    "resident": ("nearest_resident", "nearest_shadow_resident", "occlude_resident"),
}
# the reference films phase 29 holds (tests/test_reference_films.py CASES):
# (name, scene, film, spp, NEE+MIS, camera); FurnaceTest's is NEE off
FILM_CASES = [
    ("DarkCornell", "assets/scenes/DarkCornell.glb",
     "assets/reference/darkcornell_256x144_2048spp.npy", 2048, True, {}),
    ("GlassTest", "assets/scenes/GlassTest.glb", "assets/reference/glasstest_256x144_1024spp.npy",
     1024, True, GLASS_CAM),
    ("FurnaceTest", FURNACE, "assets/reference/furnacetest_256x144_1024spp.npy", 1024, False, {}),
]

# the full-pipeline configuration (BASELINE.md config 5, spp cut to 32)
BT = "assets/scenes/BreakTime.glb"
BT_SKY = "assets/scenes/BreakTimeSky.npy"
BT_CAM = dict(cam_position=(0.0, 1.8, -3.2), has_skybox=True)
BT_W, BT_H = 1920, 1080
BT_SPP = 32
BT_CHUNK = 1 << 20  # RenderSettings.batch_pixels: 2 chunks of the frame
BT_LANES = BT_CHUNK * FOLD  # 4,194,304
BT_REF = "assets/reference/breaktime_256x144_1024spp.npy"

# the one-tile renders (the torch-shade loop)
ONE_TILE_SPP = 16

# published peaks of one H100 SXM (NVIDIA H100 datasheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TENSOR_OP_PER_S = {"tf32": 495e12, "bf16": 989e12, "int8": 1979e12, "bf16w": 989e12}
# FP32 operations of one (ray, triangle) pair test (csrc/flash_common.cuh
# pair_accumulate, pair_epilogue): 4 multiplies and 36 FMAs (2 each) for
# the four numerators, one division, three multiplies and the u + v add
FLOPS_PER_PAIR = 4 + 36 * 2 + 1 + 3 + 1
# the used rows of a [16, B] ray table: rd, ro x rd, ro, 1 (+ max_t)
RAY_ROWS, SHADOW_ROWS = 10, 11

KERNELS = {
    "K1": dict(
        name="nearest_attrs", source="rustic_tpu_torch/csrc/flash_intersect.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:776",
    ),
    "K2": dict(
        name="nearest_shadow_attrs", source="rustic_tpu_torch/csrc/flash_intersect.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:795",
    ),
    "K3": dict(
        name="occlude", source="rustic_tpu_torch/csrc/flash_intersect.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:1004",
    ),
    "K4": dict(
        name="shade_bounce", source="rustic_tpu_torch/csrc/shade.cu",
        replaces="rustic_tpu/ops/shade_kernel.py:523",
    ),
    "K5": dict(
        name="nearest_multi", source="rustic_tpu_torch/csrc/flash_multi.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:1242",
    ),
    "K6": dict(
        name="nearest_shadow_multi", source="rustic_tpu_torch/csrc/flash_multi.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:1271",
    ),
    "K7": dict(
        name="occlude_multi", source="rustic_tpu_torch/csrc/flash_multi.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:1313",
    ),
    "K8": dict(
        name="shade_bounce_wide", source="rustic_tpu_torch/csrc/shade.cu",
        replaces="rustic_tpu/ops/shade_kernel.py:683",
    ),
    "K9": dict(
        name="nearest_grid", source="rustic_tpu_torch/csrc/flash_multi.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:830",
    ),
    "K10": dict(
        name="nearest_shadow_grid", source="rustic_tpu_torch/csrc/flash_multi.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:967",
    ),
    "K11": dict(
        name="occlude_grid", source="rustic_tpu_torch/csrc/flash_multi.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:1018",
    ),
    "K12": dict(
        name="nearest", source="rustic_tpu_torch/csrc/flash_intersect.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:817",
    ),
    "K13": dict(
        name="nearest_shadow", source="rustic_tpu_torch/csrc/flash_intersect.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:950",
    ),
    "K14": dict(
        name="nearest_resident", source="rustic_tpu_torch/csrc/flash_resident.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:864",
    ),
    "K15": dict(
        name="nearest_shadow_resident", source="rustic_tpu_torch/csrc/flash_resident.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:893",
    ),
    "K16": dict(
        name="occlude_resident", source="rustic_tpu_torch/csrc/flash_resident.cu",
        replaces="rustic_tpu/ops/flash_intersect.py:926",
    ),
    "K17": dict(
        name="fused_bounce", source="rustic_tpu_torch/csrc/fused_bounce.cu",
        replaces="archive/fused_bounce/fused_bounce.py:376",
    ),
    # K18 by the unit its dot runs on ("bf16w": BF16 through wgmma)
    **{f"K18 {v}": dict(
        name=f"dot_min_{v}", source="rustic_tpu_torch/csrc/probe_dot.cu",
        replaces="tools/mxu_floor.py:38",
    ) for v in ("fp32", "tf32", "bf16", "int8", "bf16w")},
    "K19": dict(
        name="dot_min_split", source="rustic_tpu_torch/csrc/probe_dot.cu",
        replaces="tools/probe_k96.py:79",
    ),
    "K19 bf16w": dict(
        name="dot_min_split_bf16w", source="rustic_tpu_torch/csrc/probe_dot.cu",
        replaces="tools/probe_k96.py:79",
    ),
}
SINGLE_TILE = ("K1", "K2", "K3", "K4")
MULTI_TILE = ("K5", "K6", "K7")
GRID = ("K9", "K10", "K11")
RESIDENT = ("K14", "K15", "K16")


def bound(n_bytes, flops, peak=FP32_FLOP_PER_S):
    """(least ms the card could take, what bounds it); `peak`: the
    operations per second of the unit the work runs on."""
    ms_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    ms_ops = flops / peak * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops, "operations")


def scan_bound(lanes_by_set, pairs, n_out_bytes, table_bytes):
    """Bound of a scan: each ray set's used rows read once, the triangle
    table read once, its outputs written once; FLOPS_PER_PAIR per pair
    the ray sets need (for the multi-tile scans, the pairs of the tiles
    their culls admit on this data: `list_form_pairs`, or each ray's slab
    test in the grid and resident forms)."""
    n_bytes = sum(lanes * rows * 4 for lanes, rows in lanes_by_set) + table_bytes + n_out_bytes
    return bound(n_bytes, pairs * FLOPS_PER_PAIR)


def list_form_pairs(f, s, scene, lists):
    """The (ray, triangle) pairs the list form's loop (K5-K7) needs on this
    data, tiles in ascending order: for the nearest set `f`, each listed
    tile that the ray's own slab test admits at its running best t; for the
    any-hit set `s`, each listed tile the ray reaches before it is
    occluded; times the tile's real triangles -> (nearest pairs, any-hit
    pairs). On the plain versions' pieces, chunk by chunk."""
    import torch

    from rustic_tpu_torch.ops import flash_intersect as FI

    g16, aabbs = scene.tri_feats16, scene.tile_aabbs
    _, tt, nt = FI.geometry(g16)
    tris = [min(max(scene.n_tris - j * tt, 0), tt) for j in range(nt)]
    rays = f if f is not None else s
    block = torch.arange(rays.shape[1], device=rays.device) // FI.BT_MULTI
    near_admit = FI._admit_table(*lists, nt, 0) if f is not None else None
    any_admit = FI._admit_table(*lists, nt, 0 if f is None else 1) if s is not None else None
    near = anyhit = 0
    for lo, hi in FI._chunks(rays.shape[1], tt):
        blk = block[lo:hi]
        if f is not None:
            fc = f[:, lo:hi]
            n_min, n_max = FI._slab_spans(fc, aabbs)
            best = torch.full((hi - lo,), FI.BIG, dtype=torch.float32, device=rays.device)
        if s is not None:
            sc = s[:, lo:hi]
            occ = torch.zeros(hi - lo, dtype=torch.bool, device=rays.device)
        for j, gj in FI._tiles(g16, tt, nt):
            if f is not None:
                ok = near_admit[blk, j] & FI._slab_ok(n_min[:, j], n_max[:, j], best)
                near += int(ok.sum()) * tris[j]
                t_j = FI._nearest_chunk(fc, gj, tt)[0]
                best = torch.where(ok & (t_j < best), t_j, best)
            if s is not None:
                ok = any_admit[blk, j] & ~occ
                anyhit += int(ok.sum()) * tris[j]
                occ |= ok & (FI._anyhit_chunk(sc, gj, tt) != 0)
    return float(near), float(anyhit)


def shade_bound(cfg, st, nf_out, sf_out, occ, has_glass, n_alias):
    """Bound of K4/K8: each row the kernel reads, read once
    (shade_kernel.rows_moved), the alias entries it may pick, and each
    output row written once; the few hundred flops a lane are far under
    the byte time."""
    from rustic_tpu_torch.config import NextEventEstimation
    from rustic_tpu_torch.ops import shade_kernel as SK

    rows = SK.rows_moved(
        occ is not None, cfg.nee == NextEventEstimation.MIS, has_glass,
        0 if nf_out is None else nf_out.shape[0], 0 if sf_out is None else sf_out.shape[0],
    )
    return bound(rows * 4 * st.shape[1] + n_alias * 48 * 4, 0)


def log(*a):
    print(*a, flush=True)


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda", 0)
        # no single PyTorch call computes any of these kernels' functions
        self.results = {
            k: dict(route="cuda", **v, library_ms=None) for k, v in KERNELS.items()
        }

    # ---- helpers ---------------------------------------------------------------

    def phase(self, name, fn):
        """Run one phase; a failure ends the run (run() returns 1)."""
        log(f"== {name}")
        t0 = time.time()
        try:
            fn()
        except Exception:
            traceback.print_exc(file=sys.stdout)
            log(f"== {name}: FAILED after {time.time() - t0:.1f} s")
            return False
        log(f"== {name}: {time.time() - t0:.1f} s")
        return True

    def fail(self, msg):
        raise AssertionError(msg)

    def set_bound(self, key, b, report=True):
        if report:
            self.results[key]["bound_ms"], self.results[key]["bound_by"] = b
        log(f"{key} bound: {b[0]:.4f} ms ({b[1]})")

    def time_pair(self, key, kern, plain, lanes, reps=10, report=True):
        """Median CUDA-event times of `kern` and `plain`, taken in turns,
        into the kernels line if `report`."""
        import statistics

        kern(), plain()  # warm
        self.torch.cuda.synchronize()
        tk, tp = [], []
        for _ in range(reps):  # in turns: kernel, plain
            tk += self.time_ms(kern, reps=1)
            tp += self.time_ms(plain, reps=1)
        if report:
            self.results[key]["ms"] = statistics.median(tk)
            self.results[key]["plain_ms"] = statistics.median(tp)
        log(f"{key} at {lanes} lanes: kernel {statistics.median(tk):.3f} ms "
            f"(min {min(tk):.3f}), plain {statistics.median(tp):.3f} ms (min {min(tp):.3f})")

    def time_turns(self, what, label_a, fn_a, label_b, fn_b, reps=5):
        """Median CUDA-event times of two kernels, taken in turns."""
        import statistics

        fn_a(), fn_b()  # warm
        self.torch.cuda.synchronize()
        ta, tb = [], []
        for _ in range(reps):
            ta += self.time_ms(fn_a, reps=1)
            tb += self.time_ms(fn_b, reps=1)
        log(f"{what}: {label_a} {statistics.median(ta):.3f} ms, {label_b} "
            f"{statistics.median(tb):.3f} ms ({self.card})")

    def _counted(self):
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import fused_bounce as FB
        from rustic_tpu_torch.ops import probe_dot as PD
        from rustic_tpu_torch.ops import shade_kernel as SK

        return (FI, SK, FB, PD)

    def reset_counts(self):
        for module in self._counted():
            module.reset_launch_counts()

    def counts(self):
        """The launch counts of every kernel's wrapper."""
        out = {}
        for module in self._counted():
            out |= module.LAUNCHES
        return out

    def time_ms(self, fn, reps=10):
        """Per-launch times (ms) of `fn` by CUDA events."""
        torch = self.torch
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return out

    # ---- phase 1 ------------------------------------------------------------------

    def device(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        self.card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
        log(self.card)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from rustic_tpu_torch.ops import _build

        from concurrent.futures import ThreadPoolExecutor

        t0 = time.time()
        names = sorted({k["source"].rsplit("/", 1)[1][: -len(".cu")] for k in KERNELS.values()})
        with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
            paths = dict(zip(names, pool.map(_build.build, names)))
        for name, path in paths.items():
            with open(path[: -len(".so")] + ".log") as f:
                for line in f:
                    if "registers" in line or "spill" in line or "error" in line:
                        log(f"  ptxas[{name}]: {line.strip()}")
        log(f"kernel build: {time.time() - t0:.1f} s")

    # ---- main-path inputs ----------------------------------------------------------

    def main_path_inputs(self):
        """One real fold group of the headline render, traced through all
        four bounces by the kernels: the inputs each launch sees."""
        import numpy as np
        import torch

        from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import shade_kernel as SK
        from rustic_tpu_torch.runtime.pipeline import initk
        from rustic_tpu_torch.runtime.render import pixel_offsets
        from rustic_tpu_torch.scene.world import World

        self.scene = World.from_path("assets/scenes/DarkCornell.glb").to_torch(self.dev)
        self.config = TracingConfig(width=WIDTH, height=HEIGHT, nee=NextEventEstimation.MIS)
        cfg = self.config.static_part()
        y, x = np.mgrid[0:HEIGHT, 0:WIDTH]
        px = torch.from_numpy(x.reshape(-1).astype(np.int32)).to(self.dev).repeat(FOLD)
        py = torch.from_numpy(y.reshape(-1).astype(np.int32)).to(self.dev).repeat(FOLD)
        off = pixel_offsets(WIDTH, HEIGHT, use_blue_noise=False).view(np.int32)
        off = torch.from_numpy(off.copy()).to(self.dev).repeat(FOLD)
        st, feats, sidx, params = initk(cfg, self.config.dynamic_part(self.dev), px, py, 0, off, FOLD)
        n_alias = self.scene.n_alias_entries
        g16, attrs, live = self.scene.tri_feats16, self.scene.tri_attrs, self.scene.n_tris
        self.bounces = []
        pending = None
        for b in range(cfg.max_bounces):
            if pending is None:
                t, i, a = FI.nearest_attrs(feats, g16, attrs, live)
                occ = None
            else:
                t, i, occ, a = FI.nearest_shadow_attrs(feats, pending, g16, attrs, live)
            rec = dict(st=st, feats=feats, pending=pending, t=t, idx=i, attrs=a, occ=occ)
            st, nf, pending = SK.shade_bounce(
                cfg, b, params, self.scene.entry_rows, st, feats, t, i, a, occ, sidx, off,
                has_glass=self.scene.has_glass, n_alias=n_alias,
            )
            rec["shadow_out"] = pending
            self.bounces.append(rec)
            if nf is not None:
                feats = nf
        self.params, self.sidx, self.off, self.n_alias = params, sidx, off, n_alias
        torch.cuda.synchronize()
        hit = float((self.bounces[0]["t"] < FI.BIG).float().mean())
        log(f"main-path group traced: {MAIN_LANES} lanes, bounce-0 hit rate {hit:.4f}")

    # ---- phase 2 ------------------------------------------------------------------------

    def check(self):
        self.main_path_inputs()
        self.check_scans()
        self.check_shade()

    def _cmp_winner(self, key, t_k, i_k, t_p, i_p):
        """Index agreement >= 99.99%, t within rtol 1e-5 where it agrees
        -> (agreeing share, max |dt|, agree mask)."""
        agree = i_k == i_p
        frac = float(agree.float().mean())
        if frac < 0.9999:
            self.fail(f"{key}: winner index agrees on {frac:.6f} of rays (< 0.9999)")
        dt = (t_k - t_p).abs()[agree]
        tol = 1e-5 * t_p.abs()[agree]
        if bool((dt > tol).any()):
            self.fail(f"{key}: t differs beyond rtol 1e-5 (max |dt| {float(dt.max()):.3g})")
        return frac, float(dt.max()) if dt.numel() else 0.0, agree

    def _cmp_nearest(self, key, t_k, i_k, a_k, t_p, i_p, a_p):
        frac, e, agree = self._cmp_winner(key, t_k, i_k, t_p, i_p)
        if not self.torch.equal(a_k[:, agree], a_p[:, agree]):
            self.fail(f"{key}: attr rows differ where the index agrees")
        return frac, e

    def _cmp_occ(self, key, o_k, o_p):
        agree = float((o_k == o_p).float().mean())
        if agree < 0.9999:
            self.fail(f"{key}: occlusion agrees on {agree:.6f} of rays (< 0.9999)")
        return agree, float((o_k - o_p).abs().max())

    def _bit_equal(self, what, outs_a, outs_b):
        """Fail unless two scans' (t, idx, occ) are equal bit for bit on
        every lane (NaN equal to NaN)."""
        torch = self.torch
        names = {1: ("occ",), 2: ("t", "idx"), 3: ("t", "idx", "occ")}[len(outs_a)]
        for name, a, b in zip(names, outs_a, outs_b):
            same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
            if not bool(same.all()):
                self.fail(f"{what}: {name} differs on {int((~same).sum())} of {a.numel()} lanes")
        log(f"{what}: equal bit for bit on all {outs_a[0].numel()} lanes")

    def check_scans(self):
        from rustic_tpu_torch.ops import flash_intersect as FI

        g16, attrs, live = self.scene.tri_feats16, self.scene.tri_attrs, self.scene.n_tris
        b0, b1 = self.bounces[0], self.bounces[1]
        for n in (CHECK_LANES, CHECK_LANES + RAGGED, MAIN_LANES):
            errs = {}
            f0 = b0["feats"][:, :n].contiguous()
            f1 = b1["feats"][:, :n].contiguous()
            s1 = b1["pending"][:, :n].contiguous()
            s3 = self.bounces[-1]["shadow_out"][:, :n].contiguous()

            frac, e = self._cmp_nearest(
                "K1", *FI.nearest_attrs(f0, g16, attrs, live), *FI.nearest_attrs_plain(f0, g16, attrs)
            )
            errs["K1"] = e
            log(f"K1 n={n}: idx agree {frac:.6f}, max |dt| {e:.3g}")

            t_k, i_k, o_k, a_k = FI.nearest_shadow_attrs(f1, s1, g16, attrs, live)
            t_p, i_p, o_p, a_p = FI.nearest_shadow_attrs_plain(f1, s1, g16, attrs)
            frac, e = self._cmp_nearest("K2", t_k, i_k, a_k, t_p, i_p, a_p)
            occ_agree, _ = self._cmp_occ("K2", o_k, o_p)
            errs["K2"] = e
            log(f"K2 n={n}: idx agree {frac:.6f}, occ agree {occ_agree:.6f}, "
                f"occluded {float(o_k.float().mean()):.4f}, max |dt| {e:.3g}")
            del t_k, i_k, o_k, a_k, t_p, i_p, o_p, a_p

            occ_agree, e = self._cmp_occ("K3", FI.occlude(s3, g16, live), FI.occlude_plain(s3, g16))
            errs["K3"] = e
            log(f"K3 n={n}: occ agree {occ_agree:.6f}")
        # the kernels line reports the comparison at the main path's shape
        for k, e in errs.items():
            self.results[k]["max_abs_err"] = e

    def check_shade(self):
        import torch

        from rustic_tpu_torch.ops import shade_kernel as SK

        cfg = self.config.static_part()
        for n, b in itertools.product((CHECK_LANES, MAIN_LANES), (0, 1, cfg.max_bounces - 1)):
            rec = self.bounces[b]
            worst = 0.0

            def cut(x):
                return None if x is None else x[..., :n].contiguous()

            args = (
                cfg, b, self.params, self.scene.entry_rows, cut(rec["st"]), cut(rec["feats"]),
                cut(rec["t"]), cut(rec["idx"]), cut(rec["attrs"]), cut(rec["occ"]),
                cut(self.sidx), cut(self.off),
            )
            kw = dict(has_glass=self.scene.has_glass, n_alias=self.n_alias)
            outs_k = SK.shade_bounce(*args, **kw)
            outs_p = SK.shade_bounce_plain(*args, **kw)
            # shadow rows count where the NEE candidate is eligible, the
            # only lanes that read them (elsewhere the origin may be a miss
            # point ~1e6 away)
            elig = outs_p[0][SK.SK_PEND_ELIG] > 0.5
            if not torch.equal(elig, outs_k[0][SK.SK_PEND_ELIG] > 0.5):
                self.fail(f"K4 bounce {b}: NEE eligibility differs")
            for name, k_, p_, sel in zip(("state", "next rays", "shadow rays"), outs_k, outs_p,
                                         (slice(None), slice(None), elig)):
                if (k_ is None) != (p_ is None):
                    self.fail(f"K4 bounce {b}: {name} present on one side only")
                if k_ is None:
                    continue
                k_, p_ = k_[:, sel], p_[:, sel]
                err = (k_ - p_).abs()
                bad = ~torch.isclose(k_, p_, rtol=1e-4, atol=1e-5, equal_nan=True)
                worst = max(worst, float(torch.nan_to_num(err, nan=0.0).max()))
                if bool(bad.any()):
                    lanes = bad.any(dim=0).nonzero()[:5, 0].tolist()
                    self.fail(f"K4 bounce {b}: {name} differs at {int(bad.sum())} entries "
                              f"(lanes {lanes}), max |d| {float(err.max()):.3g}")
            log(f"K4 bounce {b} n={n}: allclose, max |d| {worst:.3g}")
            if n == MAIN_LANES:  # the kernels line reports the main path's shape
                self.results["K4"]["max_abs_err"] = max(
                    self.results["K4"].get("max_abs_err", 0.0), worst)

    # ---- phase 3 -------------------------------------------------------------------------

    def timing(self):
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import shade_kernel as SK

        g16, attrs, live = self.scene.tri_feats16, self.scene.tri_attrs, self.scene.n_tris
        b0, b1 = self.bounces[0], self.bounces[1]
        sh = self.bounces[-1]["shadow_out"]
        cfg = self.config.static_part()
        shade_args = (cfg, 1, self.params, self.scene.entry_rows, b1["st"], b1["feats"], b1["t"],
                      b1["idx"], b1["attrs"], b1["occ"], self.sidx, self.off)
        kw = dict(has_glass=self.scene.has_glass, n_alias=self.n_alias)
        cases = {
            "K1": (lambda: FI.nearest_attrs(b0["feats"], g16, attrs, live),
                   lambda: FI.nearest_attrs_plain(b0["feats"], g16, attrs)),
            "K2": (lambda: FI.nearest_shadow_attrs(b1["feats"], b1["pending"], g16, attrs, live),
                   lambda: FI.nearest_shadow_attrs_plain(b1["feats"], b1["pending"], g16, attrs)),
            "K3": (lambda: FI.occlude(sh, g16, live), lambda: FI.occlude_plain(sh, g16)),
            "K4": (lambda: SK.shade_bounce(*shade_args, **kw),
                   lambda: SK.shade_bounce_plain(*shade_args, **kw)),
        }
        for key, (kern, plain) in cases.items():
            self.time_pair(key, kern, plain, MAIN_LANES)
        # bounds at the timed shapes: one tile of n_tris real triangles
        n, n_tris = MAIN_LANES, self.scene.n_tris
        table = g16.shape[1] * RAY_ROWS * 4 + attrs.numel() * 4
        self.set_bound("K1", scan_bound([(n, RAY_ROWS)], n * n_tris, n * (8 + 32 * 4), table))
        self.set_bound("K2", scan_bound([(n, RAY_ROWS), (n, SHADOW_ROWS)], 2 * n * n_tris,
                                        n * (12 + 32 * 4), table))
        self.set_bound("K3", scan_bound([(n, SHADOW_ROWS)], n * n_tris, n * 4, table))
        self.log_exact_share("K1", b0["feats"], None, g16, None, live)
        self.log_exact_share("K2", b1["feats"], b1["pending"], g16, None, live)
        self.log_exact_share("K3", None, sh, g16, None, live)
        st_out, nf, sf = SK.shade_bounce(*shade_args, **kw)
        self.set_bound("K4", shade_bound(cfg, b1["st"], nf, sf, b1["occ"],
                                         self.scene.has_glass, self.n_alias))
        self.bounces = None  # free the traced group
        self.torch.cuda.empty_cache()

    def log_exact_share(self, key, f, s, g16, aabbs, live):
        """The share of pairs and of warp iterations that the skip test
        (`FI.skip_scan`, the kernels' `pair_skip` in torch) sends to the
        exact epilogue, on the first CHECK_LANES lanes of the operands."""
        from rustic_tpu_torch.ops import flash_intersect as FI

        def cut(x):
            return None if x is None else x[:, :CHECK_LANES].contiguous()

        stats = FI.skip_scan(cut(f), cut(s), g16, aabbs, live)[3].tolist()
        for (pairs, exact, warps, warps_exact), name in zip(stats, ("nearest", "any-hit")):
            if pairs:
                log(f"{key} {name} set on {CHECK_LANES} lanes: {exact / pairs:.4%} of {pairs} "
                    f"pairs and {warps_exact / warps:.4%} of {warps} warp iterations take the "
                    f"exact epilogue")

    # ---- phase 4 -------------------------------------------------------------------------

    def render(self):
        import numpy as np
        import torch

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import shade_kernel as SK
        from rustic_tpu_torch.runtime.render import render_image

        spp = SPP
        t0 = time.time()
        render_image(self.scene, self.config, RenderSettings(samples=FOLD), device=self.dev)
        log(f"warm-up render ({FOLD} spp): {time.time() - t0:.2f} s")

        FI.reset_launch_counts()
        SK.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        film = render_image(self.scene, self.config, RenderSettings(samples=spp), device=self.dev)
        render_s = time.time() - t0
        counts = {**FI.LAUNCHES, **SK.LAUNCHES}
        mpaths = WIDTH * HEIGHT * spp / render_s / 1e6
        log(f"render {WIDTH}x{HEIGHT}x{spp} spp NEE+MIS: {render_s:.3f} s, {mpaths:.2f} Mpaths/s "
            f"({self.card}); reference GPU yardstick 61.2 Mpaths/s")
        log(f"launch counts: {counts}")

        groups = -(-spp // FOLD)
        nb = self.config.max_bounces
        expect = {
            "nearest_attrs": 1 if spp % FOLD == 0 or groups == 1 else 2,
            "nearest_shadow_attrs": nb * groups - (1 if spp % FOLD == 0 or groups == 1 else 2),
            "occlude": 1 if spp % FOLD == 0 or groups == 1 else 2,
            "shade_bounce": nb * groups,
        }
        for key in SINGLE_TILE:
            self.results[key]["launches"] = counts[KERNELS[key]["name"]]
        expect = dict.fromkeys(counts, 0) | expect
        if counts != expect:
            self.fail(f"launch counts {counts} != expected {expect}")
        mean = float(film.mean())
        log(f"film mean {mean:.6f} (reference {FILM_MEAN_REF}, "
            f"{(mean / FILM_MEAN_REF - 1) * 100:+.3f}%)")
        if not np.isfinite(film).all() or film.shape != (HEIGHT, WIDTH, 3):
            self.fail("film is not finite or has the wrong shape")
        if abs(mean / FILM_MEAN_REF - 1.0) > 0.02:
            self.fail(f"film mean {mean} is not within 2% of {FILM_MEAN_REF}")

    # ---- phase 5 -------------------------------------------------------------------------

    def cross_device(self):
        import numpy as np

        from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
        from rustic_tpu_torch.runtime.render import render_image

        config = TracingConfig(width=64, height=64, nee=NextEventEstimation.MIS)
        settings = RenderSettings(samples=4)
        gpu = render_image(self.scene, config, settings, device=self.dev)
        cpu = render_image(self.scene.to("cpu"), config, settings, device="cpu")
        bad = ~np.isclose(gpu, cpu, rtol=1e-4, atol=1e-5)
        log(f"64x64x4 film, card vs host CPU: max |d| {np.abs(gpu - cpu).max():.3g}, "
            f"{int(bad.sum())} entries outside rtol 1e-4 / atol 1e-5, mean {gpu.mean():.6f}")
        if bad.any():
            px = np.argwhere(bad.any(axis=-1))[:5].tolist()
            self.fail(f"card and host films differ at pixels {px}")

    # ---- phase 6: the multi-tile path --------------------------------------------------

    def _mt_setup(self):
        """VeachMIS on the card and its 1024x1024 configuration."""
        from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
        from rustic_tpu_torch.scene.world import World

        if getattr(self, "mt_scene", None) is None:
            self.mt_scene = World.from_path(VEACH).to_torch(self.dev)
            self.mt_config = TracingConfig(
                width=MT_SIZE, height=MT_SIZE, nee=NextEventEstimation.MIS, **VEACH_CAM
            )

    def mt_inputs(self):
        """One real fold group of the VeachMIS render traced through all
        four bounces by the kernels and the stage functions: the ray rows
        each scan sees."""
        import numpy as np
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.runtime import pipeline as P
        from rustic_tpu_torch.runtime.render import pixel_offsets

        self._mt_setup()
        cfg = self.mt_config.static_part()
        cam = self.mt_config.dynamic_part(self.dev)
        y, x = np.mgrid[0:MT_SIZE, 0:MT_SIZE]
        px = torch.from_numpy(x.reshape(-1).astype(np.int32)).to(self.dev).repeat(FOLD)
        py = torch.from_numpy(y.reshape(-1).astype(np.int32)).to(self.dev).repeat(FOLD)
        off = pixel_offsets(MT_SIZE, MT_SIZE, use_blue_noise=False).view(np.int32)
        off = torch.from_numpy(off.copy()).to(self.dev).repeat(FOLD)
        st, feats, sidx = P.stage_init(cfg, cam, px, py, 0, off, FOLD)
        self.mt_bounces = []
        pending = prev_nee = None
        for b in range(cfg.max_bounces):
            t, idx, occ = P._scan(feats, pending, self.mt_scene)
            rec = dict(feats=feats, pending=pending, t=t)
            st, nf, nee = P.stage_pre(
                self.mt_scene, cfg, cam, b, st, feats, prev_nee, occ, t, idx, sidx, off
            )
            prev_nee, pending = nee if nee is not None else (None, None)
            rec["shadow_out"] = pending
            self.mt_bounces.append(rec)
            if nf is not None:
                feats = nf
        torch.cuda.synchronize()
        hit = float((self.mt_bounces[0]["t"] < FI.BIG).float().mean())
        log(f"VeachMIS group traced: {MT_LANES} lanes, bounce-0 hit rate {hit:.4f}")

    def _mt_cases(self, bounces, lanes: slice, k5_bounce: int = 0):
        """(tile lists, ray rows, kernel call, plain call) of K5-K7 on
        `lanes` of a traced group: K5 on the rays of `k5_bounce`, K6 on
        bounce-1 rays with the bounce-0 shadow rays, K7 on the bounce-3
        shadow rays; each with its admitted-tile lists, built once for
        both calls."""
        from rustic_tpu_torch.ops import flash_intersect as FI

        g16, aabbs, live = self.mt_scene.tri_feats16, self.mt_scene.tile_aabbs, self.mt_scene.n_tris

        def cut(x):
            return x[:, lanes].contiguous()

        f5 = cut(bounces[k5_bounce]["feats"])
        f1, s1 = cut(bounces[1]["feats"]), cut(bounces[1]["pending"])
        s3 = cut(bounces[-1]["shadow_out"])
        l5 = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False,), f5)
        l1 = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False, True), f1, s1)
        l3 = FI.block_tile_lists(aabbs, FI.BT_MULTI, (True,), s3)
        return {
            "K5": (l5, (f5,), lambda: FI.nearest_multi(f5, g16, *l5, aabbs, live),
                   lambda: FI.nearest_multi_plain(f5, g16, *l5)),
            "K6": (l1, (f1, s1), lambda: FI.nearest_shadow_multi(f1, s1, g16, *l1, aabbs, live),
                   lambda: FI.nearest_shadow_multi_plain(f1, s1, g16, *l1)),
            "K7": (l3, (s3,), lambda: FI.occlude_multi(s3, g16, *l3, live),
                   lambda: FI.occlude_multi_plain(s3, g16, *l3)),
        }

    def _mt_compare(self, cases, n):
        """K5 and K6 against their plain versions (the lists alone) bit
        for bit: their per-ray slab test inside the listed tiles must not
        change a lane; K7 as phase 6 -> {key: max |dt| or 0}."""
        admitted = {k: float(c[0][1].float().mean()) for k, c in cases.items()}
        out_k, out_p = (f() for f in cases["K5"][2:])
        self._bit_equal(f"K5 n={n} against its plain version", out_k, out_p)
        log(f"K5 n={n}: admitted tiles per block {admitted['K5']:.3f} of 6")
        out_k, out_p = (f() for f in cases["K6"][2:])
        self._bit_equal(f"K6 n={n} against its plain version", out_k, out_p)
        log(f"K6 n={n}: occluded {float(out_k[2].float().mean()):.4f}, "
            f"admitted tiles per block {admitted['K6']:.3f}")
        e5 = e6 = 0.0  # bit for bit
        del out_k, out_p
        o_k, o_p = (f() for f in cases["K7"][2:])
        occ_agree, e7 = self._cmp_occ("K7", o_k, o_p)
        log(f"K7 n={n}: occ agree {occ_agree:.6f}, occluded {float(o_k.float().mean()):.4f}, "
            f"admitted tiles per block {admitted['K7']:.3f}")
        return {"K5": e5, "K6": e6, "K7": e7}

    def _mt_time(self, cases, lanes, report):
        """Time the kernels of `cases` and their plain versions and bound
        each by the pairs its loop needs on this data (`list_form_pairs`);
        beside it, the bound over every pair the lists admit (each block's
        rays x the real triangles of each admitted tile). The kernels line
        takes the numbers of the keys in `report`."""
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI

        scene = self.mt_scene
        g16 = scene.tri_feats16
        _, tt, nt = FI.geometry(g16)
        tile_tris = torch.clamp(
            scene.n_tris - torch.arange(nt, device=self.dev) * tt, 0, tt).float()
        table = g16.shape[1] * RAY_ROWS * 4
        for key, (lists, rays, kern, plain) in cases.items():
            # 3 turns: the plain versions take ~1-2 s a call at these lanes
            self.time_pair(key, kern, plain, lanes, reps=3, report=key in report)
            b = rays[0].shape[1]
            nb = lists[0].shape[0]
            per_block = torch.full((nb,), float(FI.BT_MULTI), device=self.dev)
            per_block[-1] = b - FI.BT_MULTI * (nb - 1)
            listed = 0.0
            for ray_set in range(len(rays)):
                admit = FI._admit_table(*lists, nt, ray_set).float()
                listed += float(per_block @ (admit @ tile_tris))
            f, s = (rays[0], None) if key == "K5" else (None, rays[0]) if key == "K7" else rays
            near, anyhit = list_form_pairs(f, s, scene, lists)
            rows = [(b, r) for r in
                    {"K5": [RAY_ROWS], "K6": [RAY_ROWS, SHADOW_ROWS], "K7": [SHADOW_ROWS]}[key]]
            out = {"K5": 8, "K6": 12, "K7": 4}[key] * b
            inputs = (table + lists[0].numel() * 4 + lists[1].numel() * 4
                      + (scene.tile_aabbs.numel() * 4 if f is not None else 0))
            self.set_bound(key, scan_bound(rows, near + anyhit, out, inputs), report=key in report)
            parts = ([f"nearest set, listed tiles its slab test admits: {near:.4g}"] * (f is not None)
                     + [f"any-hit set, listed tiles before its occlusion: {anyhit:.4g}"]
                     * (s is not None))
            log(f"{key} bound counts {near + anyhit:.4g} pairs ({'; '.join(parts)}), "
                f"{(near + anyhit) / max(listed, 1.0):.4f} of the {listed:.4g} its lists admit; "
                f"over those: {scan_bound(rows, listed, out, inputs)[0]:.4f} ms")

    def mt_check(self):
        self.mt_inputs()
        for n in (CHECK_LANES, CHECK_LANES + RAGGED, MT_LANES):
            errs = self._mt_compare(self._mt_cases(self.mt_bounces, slice(0, n)), n)
        # K5's operands are the unsorted camera rays on every loop; K6 and
        # K7 are reported on the main path's sorted operands (shade-check)
        self.results["K5"]["max_abs_err"] = errs["K5"]

    def mt_timing(self):
        import statistics

        from rustic_tpu_torch.ops import flash_intersect as FI

        aabbs = self.mt_scene.tile_aabbs
        b0 = self.mt_bounces[0]
        lists_ms = self.time_ms(
            lambda: FI.block_tile_lists(aabbs, FI.BT_MULTI, (False,), b0["feats"]), reps=5
        )
        log(f"block_tile_lists at {MT_LANES} lanes (one ray set): "
            f"{statistics.median(lists_ms):.3f} ms")
        self._mt_time(self._mt_cases(self.mt_bounces, slice(None)), MT_LANES, ("K5",))
        self.mt_bounces = None  # free the traced group
        self.torch.cuda.empty_cache()

    def _render_mt(self, loop, spp, expect, scan="lists"):
        """Render VeachMIS MT_SIZE^2 x spp through the multi-tile `loop`
        with the scan form `scan` after a one-group warm-up; check the
        launch counts against `expect` (the others 0) -> the counts."""
        import numpy as np
        import torch

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.runtime.render import render_image

        t0 = time.time()
        render_image(self.mt_scene, self.mt_config,
                     RenderSettings(samples=FOLD, multitile_loop=loop, multitile_scan=scan),
                     device=self.dev)
        log(f"{loop} warm-up render ({FOLD} spp): {time.time() - t0:.2f} s")
        self.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        film = render_image(self.mt_scene, self.mt_config,
                            RenderSettings(samples=spp, multitile_loop=loop, multitile_scan=scan),
                            device=self.dev)
        render_s = time.time() - t0
        counts = self.counts()
        mpaths = MT_SIZE * MT_SIZE * spp / render_s / 1e6
        log(f"render VeachMIS {MT_SIZE}x{MT_SIZE}x{spp} spp NEE+MIS, {loop} loop, {scan} scans: "
            f"{render_s:.3f} s, {mpaths:.2f} Mpaths/s ({self.card})")
        log(f"launch counts: {counts}")
        expect = dict.fromkeys(counts, 0) | expect
        if counts != expect:
            self.fail(f"launch counts {counts} != expected {expect}")
        log(f"film mean {float(film.mean()):.6f}")
        if not np.isfinite(film).all() or film.shape != (MT_SIZE, MT_SIZE, 3):
            self.fail("film is not finite or has the wrong shape")
        return counts

    def mt_render(self):
        groups = MT_UNSORTED_SPP // FOLD
        self._render_mt("unsorted", MT_UNSORTED_SPP, {
            "nearest_multi": 1,
            "nearest_shadow_multi": self.mt_config.max_bounces * groups - 1,
            "occlude_multi": 1,
        })

    # ---- phases 9-11: the sorted loops -----------------------------------------------

    def _mt_group(self):
        """One VeachMIS fold group's pixels, offsets and settings."""
        import numpy as np
        import torch

        from rustic_tpu_torch.runtime.render import pixel_offsets

        y, x = np.mgrid[0:MT_SIZE, 0:MT_SIZE]
        px = torch.from_numpy(x.reshape(-1).astype(np.int32)).to(self.dev).repeat(FOLD)
        py = torch.from_numpy(y.reshape(-1).astype(np.int32)).to(self.dev).repeat(FOLD)
        off = pixel_offsets(MT_SIZE, MT_SIZE, use_blue_noise=False).view(np.int32)
        off = torch.from_numpy(off.copy()).to(self.dev).repeat(FOLD)
        return (self.mt_config.static_part(), self.mt_config.dynamic_part(self.dev),
                px, py, off)

    def _sorted_tiles(self, loop, bounces):
        """Print the admitted tiles per block and the all-sentinel blocks
        of a sorted group's K6 operands (bounce-1 rays with the bounce-0
        shadow rays) and K7 operands (bounce-3 shadow rays)."""
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.runtime import pipeline as P

        def sentinel_blocks(*rows):
            dead = torch.stack([r[6] == P.SENTINEL_RO for r in rows]).all(dim=0)
            nb = -(-dead.shape[0] // FI.BT_MULTI)
            dead = torch.nn.functional.pad(dead, (0, nb * FI.BT_MULTI - dead.shape[0]),
                                           value=True)
            return int(dead.reshape(nb, FI.BT_MULTI).all(dim=1).sum()), nb

        for what, rows in (("bounce-1 rays with bounce-0 shadow rays",
                            (bounces[1]["feats"], bounces[1]["pending"])),
                           ("bounce-3 shadow rays", (bounces[-1]["shadow_out"],))):
            flags = (False, True) if len(rows) == 2 else (True,)
            lists = FI.block_tile_lists(self.mt_scene.tile_aabbs, FI.BT_MULTI, flags, *rows)
            dead, nb = sentinel_blocks(*rows)
            log(f"{loop} loop, sorted {what}: admitted tiles per 256-ray block "
                f"{float(lists[1].float().mean()):.3f} of 6 (unsorted: 6.000), "
                f"{dead} of {nb} blocks all sentinel, "
                f"{int((lists[1] == 0).sum())} blocks admit no tile")

    def _sorted_compare(self, bounces):
        """K5 (on the sorted bounce-1 rays), K6 and K7 against their plain
        versions on a sorted group's last 65,613 lanes, where the sentinel
        blocks lie, and on all of them -> the errors at all lanes."""
        tail = slice(MT_LANES - CHECK_LANES - RAGGED, MT_LANES)
        for lanes, n in ((tail, CHECK_LANES + RAGGED), (slice(None), MT_LANES)):
            errs = self._mt_compare(self._mt_cases(bounces, lanes, k5_bounce=1), n)
        return errs

    def sort_check(self):
        """Trace one group through the ray-sorted loop; hold K5-K7 to
        their plain versions on its sorted operands."""
        import torch

        from rustic_tpu_torch.runtime import pipeline as P

        cfg, cam, px, py, off = self._mt_group()
        scene = self.mt_scene
        st, feats, sidx = P.rs_init(cfg, cam, px, py, 0, off, FOLD)
        bounces = []
        pending = prev_nee = inv = None
        for b in range(cfg.max_bounces):
            t, idx, occ = P._scan(feats, pending, scene)
            rec = dict(feats=feats, pending=pending)
            st, feats, nee, inv = P.rs_pre(
                scene, cfg, cam, b, st, prev_nee, occ, t, idx, inv, sidx, off
            )
            prev_nee, pending = nee if nee is not None else (None, None)
            rec["shadow_out"] = pending
            bounces.append(rec)
        torch.cuda.synchronize()
        self._sorted_tiles("ray-sorted", bounces)
        self._sorted_compare(bounces)
        del bounces
        torch.cuda.empty_cache()

    def shade_check(self):
        """Trace one group through the kernel-shade loop, the main path;
        hold K8 to its plain version bit for bit on every bounce and time
        it; check and time K6 and K7 on the group's sorted operands, and K6
        against K10 bit for bit."""
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import shade_kernel as SK
        from rustic_tpu_torch.runtime import pipeline as P

        cfg, cam, px, py, off = self._mt_group()
        scene = self.mt_scene
        n_alias = scene.n_alias_entries
        st, feats_t, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
        pending = inv = feats_in = None
        worst = 0.0
        timed = None
        bounces = []
        for b in range(cfg.max_bounces):
            rays = feats_t if feats_in is None else feats_in
            rec = dict(feats=rays, pending=pending)
            t, i, occ = P._scan(rays, pending, scene)
            t, i, occ, attrs_t = P.ks_resolve(scene, feats_t, t, i, occ, inv)
            args = (cfg, b, params, scene.entry_rows, st, feats_t, t, i, attrs_t, occ, sidx, off)
            kw = dict(has_glass=scene.has_glass, n_alias=n_alias)
            outs_k = SK.shade_bounce_wide(*args, **kw)
            outs_p = SK.shade_bounce_plain(*args, **kw)
            for name, k_, p_ in zip(("state", "next rays", "shadow rays"), outs_k, outs_p):
                if (k_ is None) != (p_ is None):
                    self.fail(f"K8 bounce {b}: {name} present on one side only")
                if k_ is None:
                    continue
                same = (k_ == p_) | (torch.isnan(k_) & torch.isnan(p_))
                err = float(torch.nan_to_num((k_ - p_).abs(), nan=0.0).max())
                worst = max(worst, err)
                if not bool(same.all()):
                    lanes = (~same).any(dim=0).nonzero()[:5, 0].tolist()
                    self.fail(f"K8 bounce {b}: {name} differs at {int((~same).sum())} entries "
                              f"(lanes {lanes}), max |d| {err:.3g}")
            log(f"K8 bounce {b} n={MT_LANES}: bit-equal to its plain version")
            if b == 1:
                timed = (args, kw)
            st, nf, sf = outs_k
            del outs_p
            feats_in, pending, inv = P.ks_sort(scene, st, nf, sf)
            rec["shadow_out"] = pending
            bounces.append(rec)
            if nf is not None:
                feats_t = nf
        self.results["K8"]["max_abs_err"] = worst
        args, kw = timed
        self.time_pair("K8", lambda: SK.shade_bounce_wide(*args, **kw),
                       lambda: SK.shade_bounce_plain(*args, **kw), MT_LANES)
        _, nf, sf = SK.shade_bounce_wide(*args, **kw)
        self.set_bound("K8", shade_bound(cfg, args[4], nf, sf, args[9], scene.has_glass, n_alias))
        del timed, args, nf, sf

        self._sorted_tiles("kernel-shade", bounces)
        errs = self._sorted_compare(bounces)
        for k in ("K6", "K7"):  # the main path's operands
            self.results[k]["max_abs_err"] = errs[k]
        cases = self._mt_cases(bounces, slice(None), k5_bounce=1)
        self._mt_time({k: cases[k] for k in ("K6", "K7")}, MT_LANES, ("K6", "K7"))
        # the list form and the grid form compute the same winner and occlusion on these
        # sorted operands (a dead lane is a sentinel here, which no slab test admits)
        self._bit_equal(
            "K6 against K10 on the sorted bounce-1 rays with the bounce-0 shadow rays",
            cases["K6"][2](), FI.nearest_shadow_grid(bounces[1]["feats"], bounces[1]["pending"],
                                                    scene.tri_feats16, scene.tile_aabbs,
                                                    n_live=scene.n_tris))
        self.ks_bounces = bounces  # the resident scans are checked on these operands
        del cases
        torch.cuda.empty_cache()

    def sorted_renders(self):
        groups = MT_SPP // FOLD
        scans = {
            "nearest_multi": 1,
            "nearest_shadow_multi": self.mt_config.max_bounces * groups - 1,
            "occlude_multi": 1,
        }
        counts = self._render_mt("kernel-shade", MT_SPP, scans | {
            "shade_bounce_wide": self.mt_config.max_bounces * groups,
        })
        for key in MULTI_TILE + ("K8",):  # the main path's render
            self.results[key]["launches"] = counts[KERNELS[key]["name"]]
        self._render_mt("ray-sorted", MT_SPP, scans)

    def mt_film(self, scans=None):
        """VeachMIS 256x144x1024 spp against the reference film, through
        each (loop, scan form) pair of `scans`: by default the kernel-shade
        and ray-sorted loops with tile lists and the state-sorted driver
        with the default form."""
        import numpy as np

        from rustic_tpu_torch.config import RenderSettings

        self._mt_setup()
        ref = np.load(MT_REF)
        config = dataclasses.replace(self.mt_config, width=ref.shape[1], height=ref.shape[0])
        if scans is None:  # the unsorted loop's film is held to these by the CPU tests
            scans = [("kernel-shade", "lists"), ("ray-sorted", "lists"),
                     ("state-sorted", RenderSettings.multitile_scan)]
        for loop, scan in scans:
            self._film_gate(f"VeachMIS, {loop} loop, {scan} scans,", self.mt_scene, config, ref,
                            RenderSettings(samples=MT_REF_SPP, multitile_loop=loop,
                                           multitile_scan=scan),
                            note=f"; TPU build {MT_REF_RMSE_TPU:g}, QUALITY_r5.json")

    def _cross(self, what, scene, config, loop):
        import numpy as np

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.runtime.render import render_image

        settings = RenderSettings(samples=4, multitile_loop=loop)
        gpu, _, counts, pilots, _ = self._render_counted(scene, config, settings)
        self._check_counts(what, counts, self._loop_counts(
            loop, settings.multitile_scan, scene, config, settings.samples, pilots))
        cpu = render_image(scene.to("cpu"), config, settings, device="cpu")
        bad = ~np.isclose(gpu, cpu, rtol=1e-4, atol=1e-5)
        log(f"{what} 64x64x4 film, card vs host CPU: max |d| {np.abs(gpu - cpu).max():.3g}, "
            f"{int(bad.sum())} entries outside rtol 1e-4 / atol 1e-5, mean {gpu.mean():.6f}")
        if bad.any():
            px = np.argwhere(bad.any(axis=-1))[:5].tolist()
            self.fail(f"{what}: card and host films differ at pixels {px}")

    def mt_cross_device(self):
        from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
        from rustic_tpu_torch.scene.world import World

        self._mt_setup()
        config = dataclasses.replace(self.mt_config, width=64, height=64)
        for loop in ("kernel-shade", "ray-sorted", "state-sorted"):
            self._cross(f"VeachMIS, {loop} loop,", self.mt_scene, config, loop)
        furnace = World.from_path(FURNACE).to_torch(self.dev)
        config = TracingConfig(width=64, height=64, nee=NextEventEstimation.MIS)
        self._cross("FurnaceTest (5,120 alias entries), kernel-shade loop,", furnace, config,
                    "kernel-shade")

    # ---- phases 14-18: BreakTime, the grid form -----------------------------------

    def bt_load(self):
        """Load BreakTime with its 4096^2 atlas and HDR sky, timing the
        PNG decode (the glTF load), the atlas, the rest of the scene build
        and the upload."""
        import torch

        from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
        from rustic_tpu_torch.scene import atlas as atlas_mod
        from rustic_tpu_torch.scene import world as world_mod
        from rustic_tpu_torch.scene.gltf import load_glb

        t0 = time.time()
        gltf = load_glb(BT)
        t_load = time.time() - t0
        pack = atlas_mod.pack_material_textures
        t_atlas = []

        def timed_pack(*a, **k):
            t1 = time.time()
            out = pack(*a, **k)
            t_atlas.append(time.time() - t1)
            return out

        atlas_mod.pack_material_textures = timed_pack
        try:
            t0 = time.time()
            world = world_mod.World(gltf)
            t_world = time.time() - t0
        finally:
            atlas_mod.pack_material_textures = pack
        t0 = time.time()
        sky = world_mod.load_skybox_image(BT_SKY)
        self.bt_scene = world.to_torch(self.dev, sky)
        torch.cuda.synchronize()
        t_up = time.time() - t0
        log(f"BreakTime load: glTF + 6 PNG decodes {t_load:.2f} s, World build {t_world:.2f} s "
            f"(of which the {world.atlas.shape[0]}^2 x 9 atlas {t_atlas[0]:.2f} s), sky + upload "
            f"{t_up:.2f} s; {self.bt_scene.n_tris} triangles in "
            f"{self.bt_scene.tile_aabbs.shape[0]} tiles, {self.bt_scene.n_alias_entries} alias "
            f"entries, atlas {self.bt_scene.atlas.numel() * 4 / 1e6:.0f} MB on the card")
        self.bt_config = TracingConfig(width=BT_W, height=BT_H, nee=NextEventEstimation.MIS,
                                       **BT_CAM)

    def _bt_group(self):
        """The first pixel chunk of the BreakTime frame, folded 4 times."""
        import numpy as np
        import torch

        from rustic_tpu_torch.runtime.render import pixel_offsets

        y, x = np.mgrid[0:BT_H, 0:BT_W]
        px = torch.from_numpy(x.reshape(-1)[:BT_CHUNK].astype(np.int32)).to(self.dev).repeat(FOLD)
        py = torch.from_numpy(y.reshape(-1)[:BT_CHUNK].astype(np.int32)).to(self.dev).repeat(FOLD)
        off = pixel_offsets(BT_W, BT_H, use_blue_noise=False)[:BT_CHUNK].view(np.int32)
        off = torch.from_numpy(off.copy()).to(self.dev).repeat(FOLD)
        return (self.bt_config.static_part(), self.bt_config.dynamic_part(self.dev), px, py, off)

    def bt_trace(self):
        """One BreakTime group through the kernel-shade loop in the grid
        form; K4 (the path's shade kernel) and K8 in HDR mode held bit for
        bit to their plain version on every bounce -> the scans' operands."""
        import torch

        from rustic_tpu_torch.ops import shade_kernel as SK
        from rustic_tpu_torch.runtime import pipeline as P

        cfg, cam, px, py, off = self._bt_group()
        scene = self.bt_scene
        n_alias = scene.n_alias_entries
        if n_alias > SK.MAX_ALIAS:
            self.fail(f"BreakTime has {n_alias} alias entries: its path would run K8, not K4")
        st, feats_t, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
        pending = inv = feats_in = None
        bounces = []
        kw = dict(has_glass=scene.has_glass, n_alias=n_alias)
        for b in range(cfg.max_bounces):
            rays = feats_t if feats_in is None else feats_in
            rec = dict(feats=rays, pending=pending)
            t, i, occ = P._scan(rays, pending, scene, "grid")
            t, i, occ, attrs_t = P.ks_resolve(scene, feats_t, t, i, occ, inv)
            args = (cfg, b, params, scene.entry_rows, st, feats_t, t, i, attrs_t, occ, sidx, off)
            outs_p = SK.shade_bounce_plain(*args, **kw)
            for key, fn in (("K4", SK.shade_bounce), ("K8", SK.shade_bounce_wide)):
                outs_k = fn(*args, **kw)
                for name, k_, p_ in zip(("state", "next rays", "shadow rays"), outs_k, outs_p):
                    if (k_ is None) != (p_ is None):
                        self.fail(f"{key} HDR bounce {b}: {name} present on one side only")
                    if k_ is None:
                        continue
                    same = (k_ == p_) | (torch.isnan(k_) & torch.isnan(p_))
                    if not bool(same.all()):
                        lanes = (~same).any(dim=0).nonzero()[:5, 0].tolist()
                        self.fail(f"{key} HDR bounce {b}: {name} differs at "
                                  f"{int((~same).sum())} entries (lanes {lanes})")
                if key == "K4":
                    st, nf, sf = outs_k
                del outs_k
            log(f"BreakTime bounce {b}: K4 and K8 in HDR mode bit-equal to their plain "
                f"version on {BT_LANES} lanes")
            del outs_p
            feats_in, pending, inv = P.ks_sort(scene, st, nf, sf)
            rec["shadow_out"] = pending
            bounces.append(rec)
            if nf is not None:
                feats_t = nf
        missed = float((st[SK.SK_MISSED] > 0.5).float().mean())
        log(f"BreakTime group traced: {BT_LANES} lanes, {missed:.4f} of them escaped to the sky")
        return bounces

    def _bt_cases(self, bounces, lanes: slice):
        """Operands of K9-K11 on `lanes` of the traced group: K9 on the
        bounce-0 camera rays, K10 on bounce-1 rays with the bounce-0 shadow
        rays, K11 on the bounce-3 shadow rays -> {key: rays (nearest set,
        any-hit set)}."""
        def cut(x):
            return x[:, lanes].contiguous()

        return {
            "K9": (cut(bounces[0]["feats"]), None),
            "K10": (cut(bounces[1]["feats"]), cut(bounces[1]["pending"])),
            "K11": (None, cut(bounces[-1]["shadow_out"])),
        }

    def _grid_call(self, key, f, s, visits=None):
        from rustic_tpu_torch.ops import flash_intersect as FI

        g16, aabbs, live = self.bt_scene.tri_feats16, self.bt_scene.tile_aabbs, self.bt_scene.n_tris
        if key == "K9":
            return FI.nearest_grid(f, g16, aabbs, visits=visits, n_live=live)
        if key == "K10":
            return FI.nearest_shadow_grid(f, s, g16, aabbs, visits=visits, n_live=live)
        return (FI.occlude_grid(s, g16, aabbs, visits=visits, n_live=live),)

    def _list_call(self, key, f, s):
        from rustic_tpu_torch.ops import flash_intersect as FI

        g16, aabbs, live = self.bt_scene.tri_feats16, self.bt_scene.tile_aabbs, self.bt_scene.n_tris
        if key == "K9":
            return FI.nearest_multi(
                f, g16, *FI.block_tile_lists(aabbs, FI.BT_MULTI, (False,), f), aabbs, live)
        if key == "K10":
            return FI.nearest_shadow_multi(
                f, s, g16, *FI.block_tile_lists(aabbs, FI.BT_MULTI, (False, True), f, s), aabbs,
                live)
        return (FI.occlude_multi(
            s, g16, *FI.block_tile_lists(aabbs, FI.BT_MULTI, (True,), s), live),)

    def _bt_compare(self, cases, n):
        """K9-K11 against their plain versions and against K5-K7 with lists
        on the same operands -> {key: max |dt| or 0 against the plain version}."""
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI

        errs = {}
        for key, (f, s) in cases.items():
            rays = f if f is not None else s
            nb = -(-rays.shape[1] // FI.BT_MULTI)
            visits = torch.zeros(nb, dtype=torch.int32, device=self.dev)
            out_k = self._grid_call(key, f, s, visits)
            t_p, i_p, o_p, vis_p = FI._grid_scan(f, s, self.bt_scene.tri_feats16,
                                                  self.bt_scene.tile_aabbs)[:4]
            out_p = {"K9": (t_p, i_p), "K10": (t_p, i_p, o_p), "K11": (o_p,)}[key]
            out_l = self._list_call(key, f, s)
            flags = {"K9": (False,), "K10": (False, True), "K11": (True,)}[key]
            lists = FI.block_tile_lists(self.bt_scene.tile_aabbs, FI.BT_MULTI, flags,
                                        *[r for r in (f, s) if r is not None])
            admitted = lists[1]
            if key != "K11":  # K5 and K6 run each ray's slab test inside the listed tiles
                g16 = self.bt_scene.tri_feats16
                plain_l = (FI.nearest_multi_plain(f, g16, *lists) if key == "K9"
                           else FI.nearest_shadow_multi_plain(f, s, g16, *lists))
                self._bit_equal(f"{'K5' if key == 'K9' else 'K6'} n={n} on these operands "
                                f"against its plain version", out_l, plain_l)
                del plain_l
            msg = []
            for against, out in (("plain", out_p), ("lists", out_l)):
                label = f"{key} vs {against}"
                if key != "K11":
                    frac, e, _ = self._cmp_winner(label, out_k[0], out_k[1], out[0], out[1])
                    msg.append(f"{against}: idx agree {frac:.6f}, max |dt| {e:.3g}")
                    if against == "plain":
                        errs[key] = e
                if key != "K9":
                    agree, _ = self._cmp_occ(label, out_k[-1], out[-1])
                    msg.append(f"{against}: occ agree {agree:.6f}")
                    if key == "K11" and against == "plain":
                        errs[key] = float((out_k[-1] - out[-1]).abs().max())
            if not torch.equal(visits, vis_p):
                self.fail(f"{key}: the tiles its blocks visit differ from its plain version's")
            log(f"{key} n={n}: " + "; ".join(msg) + f"; tiles per 256-ray block: grid visits "
                f"{float(visits.float().mean()):.3f}, lists admit "
                f"{float(admitted.float().mean()):.3f} of {self.bt_scene.tile_aabbs.shape[0]}")
        return errs

    def bt_check(self):
        self.bt_load()
        self.bt_bounces = self.bt_trace()
        for n in (CHECK_LANES, CHECK_LANES + RAGGED, BT_LANES):
            errs = self._bt_compare(self._bt_cases(self.bt_bounces, slice(0, n)), n)
        for k, e in errs.items():
            self.results[k]["max_abs_err"] = e

    def bt_timing(self):
        """K9-K11 and their plain versions timed in turns; bound by the
        pairs the grid form tests (each ray x the real triangles of each
        tile its own slab test admits); the whole scan of each form."""
        import statistics

        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI

        scene = self.bt_scene
        g16, aabbs = scene.tri_feats16, scene.tile_aabbs
        _, tt, nt = FI.geometry(g16)
        tile_tris = torch.clamp(
            scene.n_tris - torch.arange(nt, device=self.dev) * tt, 0, tt).double()
        table = g16.shape[1] * RAY_ROWS * 4 + aabbs.numel() * 4
        cases = self._bt_cases(self.bt_bounces, slice(None))
        for key, (f, s) in cases.items():
            plain = {"K9": lambda f=f: FI.nearest_grid_plain(f, g16, aabbs),
                     "K10": lambda f=f, s=s: FI.nearest_shadow_grid_plain(f, s, g16, aabbs),
                     "K11": lambda s=s: FI.occlude_grid_plain(s, g16, aabbs)}[key]
            self.time_pair(key, lambda key=key, f=f, s=s: self._grid_call(key, f, s), plain,
                           BT_LANES, reps=2)  # the plain versions take 3-6 s a call
            per_set, warp_tiles = (x.double() for x in FI._grid_scan(f, s, g16, aabbs)[4:6])
            pairs = float((per_set @ tile_tris).sum())
            for k, name in enumerate(("nearest", "any-hit")):
                if warp_tiles[k].sum() > 0:  # a loop of one thread a ray
                    log(f"{key} {name} set, one thread a ray: {float(per_set[k].sum()):.0f} "
                        f"admitted (ray, tile) lanes over 32 x {float(warp_tiles[k].sum()):.0f} "
                        f"warp-tiles with one: lane utilisation "
                        f"{float(per_set[k].sum() / (32 * warp_tiles[k].sum())):.4f}")
            self.log_exact_share(key, f, s, g16, aabbs, scene.n_tris)
            rows = [(BT_LANES, r) for r, x in ((RAY_ROWS, f), (SHADOW_ROWS, s)) if x is not None]
            out = {"K9": 8, "K10": 12, "K11": 4}[key] * BT_LANES
            self.set_bound(key, scan_bound(rows, pairs, out, table))
            log(f"{key}: {pairs:.4g} (ray, triangle) pairs tested "
                f"({pairs / (BT_LANES * len(rows) * scene.n_tris):.4f} of all)")
        # each form's whole scan: the list pre-pass plus K5-K7, or K9-K11
        for key, (f, s) in cases.items():
            lk = {"K9": "K5", "K10": "K6", "K11": "K7"}[key]
            flags = {"K9": (False,), "K10": (False, True), "K11": (True,)}[key]
            sets = [r for r in (f, s) if r is not None]

            def lists(flags=flags, sets=sets):
                return FI.block_tile_lists(aabbs, FI.BT_MULTI, flags, *sets)

            self._list_call(key, f, s), self._grid_call(key, f, s), lists()  # warm
            tl, tg, tp = [], [], []
            for _ in range(5):  # in turns
                tl += self.time_ms(lambda key=key, f=f, s=s: self._list_call(key, f, s), reps=1)
                tg += self.time_ms(lambda key=key, f=f, s=s: self._grid_call(key, f, s), reps=1)
                tp += self.time_ms(lists, reps=1)
            log(f"whole scan at {BT_LANES} lanes: lists form (block_tile_lists + {lk}) "
                f"{statistics.median(tl):.3f} ms, grid form ({key}) {statistics.median(tg):.3f} ms; "
                f"the list pre-pass alone {statistics.median(tp):.3f} ms ({self.card})")
        torch.cuda.empty_cache()  # bt_bounces stay for the resident scans' check

    def bt_renders(self):
        import numpy as np
        import torch

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import shade_kernel as SK
        from rustic_tpu_torch.runtime import pipeline as P
        from rustic_tpu_torch.runtime.render import render_image

        chunk = min(RenderSettings().batch_pixels, BT_W * BT_H)
        chunks = -(-BT_W * BT_H // chunk)
        groups = chunks * -(-BT_SPP // P.pick_sample_fold(chunk, BT_SPP))
        nb = self.bt_config.max_bounces
        names = {"lists": ("nearest_multi", "nearest_shadow_multi", "occlude_multi"),
                 "grid": ("nearest_grid", "nearest_shadow_grid", "occlude_grid")}
        for scan in ("lists", "grid"):
            settings = RenderSettings(samples=BT_SPP, multitile_scan=scan)
            t0 = time.time()
            render_image(self.bt_scene, self.bt_config,
                         RenderSettings(samples=FOLD, multitile_scan=scan), device=self.dev)
            log(f"{scan} warm-up render ({FOLD} spp): {time.time() - t0:.2f} s")
            list_calls = []
            real_lists = FI.block_tile_lists

            def counted_lists(*a, **k):
                list_calls.append(1)
                return real_lists(*a, **k)

            FI.block_tile_lists = counted_lists
            try:
                FI.reset_launch_counts()
                SK.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                film = render_image(self.bt_scene, self.bt_config, settings, device=self.dev)
                render_s = time.time() - t0
                counts = {**FI.LAUNCHES, **SK.LAUNCHES}
            finally:
                FI.block_tile_lists = real_lists
            mpaths = BT_W * BT_H * BT_SPP / render_s / 1e6
            log(f"render BreakTime {BT_W}x{BT_H}x{BT_SPP} spp NEE+MIS, HDR sky, kernel-shade "
                f"loop, {scan} scans: {render_s:.3f} s, {mpaths:.2f} Mpaths/s ({self.card}); "
                f"block_tile_lists calls {len(list_calls)}")
            log(f"launch counts: {counts}")
            near, merged, occl = names[scan]
            expect = dict.fromkeys(counts, 0) | {
                near: chunks, merged: nb * groups - chunks, occl: chunks,
                "shade_bounce": nb * groups,
            }
            if counts != expect:
                self.fail(f"launch counts {counts} != expected {expect}")
            if scan == "grid":
                if list_calls:
                    self.fail(f"the grid render built tile lists {len(list_calls)} times")
                for key in GRID:  # the main path's render of K9-K11
                    self.results[key]["launches"] = counts[KERNELS[key]["name"]]
            elif len(list_calls) != nb * groups + chunks:  # one list pre-pass per scan
                self.fail(f"the lists render built {len(list_calls)} tile lists")
            log(f"film mean {float(film.mean()):.6f}")
            if not np.isfinite(film).all() or film.shape != (BT_H, BT_W, 3):
                self.fail("film is not finite or has the wrong shape")

    def bt_film(self):
        """BreakTime 256x144x1024 spp against the reference film through the
        kernel-shade loop with each scan form, and the state-sorted driver
        with the default form."""
        import numpy as np

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.runtime.pipeline import MULTITILE_SCANS

        ref = np.load(BT_REF)
        config = dataclasses.replace(self.bt_config, width=ref.shape[1], height=ref.shape[0])
        runs = [("kernel-shade", scan) for scan in MULTITILE_SCANS]
        for loop, scan in runs + [("state-sorted", RenderSettings.multitile_scan)]:
            self._film_gate(f"BreakTime, {loop} loop, {scan} scans,", self.bt_scene, config, ref,
                            RenderSettings(samples=MT_REF_SPP, multitile_loop=loop,
                                           multitile_scan=scan))

    def bt_cross_device(self):
        """BreakTime 64x64x4, card against host CPU. Its normal-mapped
        glossy surfaces under the HDR sun turn an ulp of a direction into a
        visible change of a path, and the card's transcendental functions
        are not the host's to the ulp, so the gate is calibrated in the run:
        the card's film under a one-ulp camera shift (y of the position)
        differs from its own film in some entries beyond rtol 1e-4 / atol
        1e-5; card and host may differ in at most as many, at most 1% of
        the entries, with film means within 1e-4 relative."""
        import numpy as np

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.runtime.pipeline import MULTITILE_SCANS
        from rustic_tpu_torch.runtime.render import render_image

        config = dataclasses.replace(self.bt_config, width=64, height=64)
        x, y, z = config.cam_position
        shifted = dataclasses.replace(
            config, cam_position=(x, float(np.nextafter(np.float32(y), np.float32(2 * y))), z))
        host = self.bt_scene.to("cpu")

        def outside(a, b):
            return int((~np.isclose(a, b, rtol=1e-4, atol=1e-5)).sum())

        host_films = {}
        for scan in MULTITILE_SCANS:
            settings = RenderSettings(samples=4, multitile_scan=scan)
            gpu = render_image(self.bt_scene, config, settings, device=self.dev)
            # on the host the resident scans are the grid form's plain versions
            plain = "grid" if scan == "resident" else scan
            if plain not in host_films:
                host_films[plain] = render_image(
                    host, config, RenderSettings(samples=4, multitile_scan=plain), device="cpu")
            cpu = host_films[plain]
            ulp = outside(gpu, render_image(self.bt_scene, shifted, settings, device=self.dev))
            bad = outside(gpu, cpu)
            energy = abs(float(gpu.mean()) / float(cpu.mean()) - 1.0)
            log(f"BreakTime, {scan} scans, 64x64x4 film, card vs host CPU: max |d| "
                f"{np.abs(gpu - cpu).max():.3g}, {bad} of {gpu.size} entries outside rtol 1e-4 / "
                f"atol 1e-5 (a one-ulp camera shift on the card: {ulp}), relative energy "
                f"{energy:.3g}, mean {gpu.mean():.6f}")
            if bad > ulp or bad > 0.01 * gpu.size or energy > 1e-4:
                self.fail(f"BreakTime {scan}: card and host films differ beyond the one-ulp "
                          f"shift ({bad} entries against {ulp}, relative energy {energy:.3g})")

    # ---- phases 19-21: one tile, the torch-shade loop (K12, K13, K3) ------------------

    def single_check(self):
        """K12/K13 on DarkCornell lanes: against their plain versions, bit
        for bit against K1/K2, then timed with their plain versions."""
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI

        self.main_path_inputs()
        g16, attrs, live = self.scene.tri_feats16, self.scene.tri_attrs, self.scene.n_tris
        b0, b1 = self.bounces[0], self.bounces[1]
        for n in (CHECK_LANES, CHECK_LANES + RAGGED, MAIN_LANES):
            f0 = b0["feats"][:, :n].contiguous()
            f1 = b1["feats"][:, :n].contiguous()
            s1 = b1["pending"][:, :n].contiguous()
            t_k, i_k = FI.nearest(f0, g16, live)
            frac, e12, _ = self._cmp_winner("K12", t_k, i_k, *FI.nearest_plain(f0, g16))
            t_1, i_1, _ = FI.nearest_attrs(f0, g16, attrs, live)
            if not (torch.equal(t_k, t_1) and torch.equal(i_k, i_1)):
                self.fail(f"K12 n={n}: (t, idx) differ from K1's")
            log(f"K12 n={n}: idx agree {frac:.6f}, max |dt| {e12:.3g}; bit-equal to K1")
            t_k, i_k, o_k = FI.nearest_shadow(f1, s1, g16, live)
            t_p, i_p, o_p = FI.nearest_shadow_plain(f1, s1, g16)
            frac, e13, _ = self._cmp_winner("K13", t_k, i_k, t_p, i_p)
            occ_agree, _ = self._cmp_occ("K13", o_k, o_p)
            t_2, i_2, o_2, _ = FI.nearest_shadow_attrs(f1, s1, g16, attrs, live)
            if not (torch.equal(t_k, t_2) and torch.equal(i_k, i_2) and torch.equal(o_k, o_2)):
                self.fail(f"K13 n={n}: (t, idx, occ) differ from K2's")
            log(f"K13 n={n}: idx agree {frac:.6f}, occ agree {occ_agree:.6f}, occluded "
                f"{float(o_k.float().mean()):.4f}, max |dt| {e13:.3g}; bit-equal to K2")
            del t_k, i_k, o_k, t_p, i_p, o_p, t_1, i_1, t_2, i_2, o_2
        self.results["K12"]["max_abs_err"] = e12  # at the main path's shape
        self.results["K13"]["max_abs_err"] = e13
        f0, f1, s1 = b0["feats"], b1["feats"], b1["pending"]
        self.time_pair("K12", lambda: FI.nearest(f0, g16, live), lambda: FI.nearest_plain(f0, g16),
                       MAIN_LANES)
        self.time_pair("K13", lambda: FI.nearest_shadow(f1, s1, g16, live),
                       lambda: FI.nearest_shadow_plain(f1, s1, g16), MAIN_LANES)
        self.time_turns(f"at {MAIN_LANES} lanes", "K12", lambda: FI.nearest(f0, g16, live),
                        "K1", lambda: FI.nearest_attrs(f0, g16, attrs, live))
        self.time_turns(f"at {MAIN_LANES} lanes", "K13", lambda: FI.nearest_shadow(f1, s1, g16, live),
                        "K2", lambda: FI.nearest_shadow_attrs(f1, s1, g16, attrs, live))
        n, n_tris = MAIN_LANES, self.scene.n_tris
        table = g16.shape[1] * RAY_ROWS * 4
        self.set_bound("K12", scan_bound([(n, RAY_ROWS)], n * n_tris, n * 8, table))
        self.set_bound("K13", scan_bound([(n, RAY_ROWS), (n, SHADOW_ROWS)], 2 * n * n_tris,
                                         n * 12, table))
        self.bounces = None
        torch.cuda.empty_cache()

    def _one_tile_scenes(self):
        """The one-tile cuts of BreakTime (4096^2 atlas, HDR sky) and
        VeachMIS on the card, with their configurations at WIDTH x HEIGHT."""
        from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import shade_kernel as SK
        from rustic_tpu_torch.scene import cuts
        from rustic_tpu_torch.scene.gltf import load_glb
        from rustic_tpu_torch.scene.world import World, load_skybox_image

        t0 = time.time()
        self.one_tile = {}
        for name, path, cut, cam, sky in (
            ("BreakTime-1tile", BT, cuts.BREAKTIME_ONE_TILE, BT_CAM, BT_SKY),
            ("VeachMIS-1tile", VEACH, cuts.VEACH_ONE_TILE, VEACH_CAM, None),
        ):
            world = World(cuts.one_tile(load_glb(path), cut))
            scene = world.to_torch(self.dev, None if sky is None else load_skybox_image(sky))
            if FI.geometry(scene.tri_feats16)[2] != 1 or SK.supported(scene):
                self.fail(f"{name} is not a one-tile scene the kernel-shade loop refuses")
            config = TracingConfig(width=WIDTH, height=HEIGHT, nee=NextEventEstimation.MIS, **cam)
            self.one_tile[name] = (scene, config)
            log(f"{name}: {scene.n_tris} triangles, {scene.n_alias_entries} alias entries, "
                f"textured {scene.has_textures}, rows {scene.tri_attrs.shape[1]} wide")
        log(f"one-tile scenes built: {time.time() - t0:.1f} s")

    def _render_one_tile(self, what, scene, config, settings):
        """A timed render after a one-group warm-up; launch counts K12 1,
        K13 4 x groups - 1, K3 1, every other kernel 0 -> (counts, film)."""
        import numpy as np
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import shade_kernel as SK
        from rustic_tpu_torch.runtime.render import render_image

        t0 = time.time()
        render_image(scene, config, dataclasses.replace(settings, samples=FOLD), device=self.dev)
        log(f"{what} warm-up render ({FOLD} spp): {time.time() - t0:.2f} s")
        FI.reset_launch_counts()
        SK.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        film = render_image(scene, config, settings, device=self.dev)
        render_s = time.time() - t0
        counts = {**FI.LAUNCHES, **SK.LAUNCHES}
        spp = settings.samples
        mpaths = config.width * config.height * spp / render_s / 1e6
        log(f"render {what} {config.width}x{config.height}x{spp} spp NEE+MIS, torch-shade loop: "
            f"{render_s:.3f} s, {mpaths:.2f} Mpaths/s ({self.card})")
        log(f"launch counts: {counts}")
        groups = -(-spp // FOLD)
        expect = dict.fromkeys(counts, 0) | {
            "nearest": 1, "nearest_shadow": config.max_bounces * groups - 1, "occlude": 1}
        if counts != expect:
            self.fail(f"launch counts {counts} != expected {expect}")
        if not np.isfinite(film).all() or film.shape != (config.height, config.width, 3):
            self.fail(f"{what}: film is not finite or has the wrong shape")
        return counts, film

    def single_renders(self):
        import numpy as np

        from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
        from rustic_tpu_torch.runtime.render import render_image
        from rustic_tpu_torch.scene.world import World

        self.scene = World.from_path("assets/scenes/DarkCornell.glb").to_torch(self.dev)
        torch_shade = RenderSettings(samples=ONE_TILE_SPP, single_tile_loop="torch-shade")
        _, film = self._render_one_tile("DarkCornell", self.scene, self.config, torch_shade)
        mean = float(film.mean())
        log(f"film mean {mean:.6f} (reference {FILM_MEAN_REF} at {SPP} spp, "
            f"{(mean / FILM_MEAN_REF - 1) * 100:+.3f}%)")
        if abs(mean / FILM_MEAN_REF - 1.0) > 0.02:
            self.fail(f"film mean {mean} is not within 2% of {FILM_MEAN_REF}")
        small = TracingConfig(width=64, height=64, nee=NextEventEstimation.MIS)
        a = render_image(self.scene, small, RenderSettings(samples=4, single_tile_loop="torch-shade"),
                         device=self.dev)
        b = render_image(self.scene, small, RenderSettings(samples=4), device=self.dev)
        bad = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
        log(f"DarkCornell 64x64x4 film, torch-shade loop vs kernel-shade loop: max |d| "
            f"{np.abs(a - b).max():.3g}, {int(bad.sum())} entries outside rtol 1e-4 / atol 1e-5")
        if bad.any():
            self.fail("the torch-shade and the kernel-shade films of DarkCornell differ")
        self.scene = None

        self._one_tile_scenes()
        scene, config = self.one_tile["BreakTime-1tile"]
        counts, film = self._render_one_tile("BreakTime-1tile", scene, config,
                                             RenderSettings(samples=ONE_TILE_SPP))
        for key in ("K12", "K13"):  # the main path's render of K12, K13
            self.results[key]["launches"] = counts[KERNELS[key]["name"]]
        log(f"film mean {float(film.mean()):.6f}")
        if not film.mean() > 0.05:
            self.fail(f"BreakTime-1tile: the film is black (mean {film.mean()})")

    def _ulp_gated(self, what, a, b, ulp, slack=1):
        """Films `a` and `b` may differ beyond rtol 1e-4 / atol 1e-5 in at
        most `slack` x `ulp` entries (`ulp`: what a one-ulp camera shift
        moves) and `slack`% of them, with means within 1e-4 relative."""
        import numpy as np

        bad = int((~np.isclose(a, b, rtol=1e-4, atol=1e-5)).sum())
        energy = abs(float(a.mean()) / float(b.mean()) - 1.0)
        log(f"{what}: max |d| {np.abs(a - b).max():.3g}, {bad} of {a.size} entries outside "
            f"rtol 1e-4 / atol 1e-5 (a one-ulp camera shift on the card: {ulp}, allowed "
            f"{slack} x), relative energy {energy:.3g}, mean {a.mean():.6f}")
        if bad > slack * ulp or bad > 0.01 * slack * a.size or energy > 1e-4:
            self.fail(f"{what}: the films differ beyond {slack} x the one-ulp shift ({bad} "
                      f"entries against {ulp}, relative energy {energy:.3g})")

    def single_films(self):
        """The one-tile cuts at 64x64x4: staged (K12, K13, K3) against the
        brute-force integrator on the card, and card against host; gated
        by the card's own film under a one-ulp camera shift. The brute
        engine's t differs from the flash engine's exact re-test by ulps at
        every bounce, where the camera shift perturbs a path once, so that
        comparison is allowed twice the shift's entries."""
        import numpy as np

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.runtime.render import render_image

        settings = RenderSettings(samples=4)
        for name, (scene, config) in self.one_tile.items():
            config = dataclasses.replace(config, width=64, height=64)
            x, y, z = config.cam_position
            shifted = dataclasses.replace(
                config, cam_position=(x, float(np.nextafter(np.float32(y), np.float32(2 * y))), z))
            FI.reset_launch_counts()
            staged = render_image(scene, config, settings, device=self.dev)
            if FI.LAUNCHES["nearest"] != 1 or FI.LAUNCHES["nearest_shadow"] != 3:
                self.fail(f"{name}: the staged film did not run K12/K13: {FI.LAUNCHES}")
            if not np.isfinite(staged).all() or not staged.mean() > 0.05:
                self.fail(f"{name}: the staged film is not finite or is black")
            moved = render_image(scene, shifted, settings, device=self.dev)
            ulp = int((~np.isclose(staged, moved, rtol=1e-4, atol=1e-5)).sum())
            brute = render_image(scene, config, settings, device=self.dev, engine="brute")
            self._ulp_gated(f"{name} 64x64x4, staged vs the brute-force integrator on the card",
                            staged, brute, ulp, slack=2)
            host = render_image(scene.to("cpu"), config, settings, device="cpu")
            self._ulp_gated(f"{name} 64x64x4, card vs host CPU", staged, host, ulp)
        self.one_tile = None
        self.torch.cuda.empty_cache()

    # ---- phases 22-23: the resident scans (K14-K16) -----------------------------------

    def _resident_call(self, key, scene, f, s):
        from rustic_tpu_torch.ops import flash_intersect as FI

        g16, aabbs, live = scene.tri_feats16, scene.tile_aabbs, scene.n_tris
        if key == "K14":
            return FI.nearest_resident(f, g16, aabbs, live)
        if key == "K15":
            return FI.nearest_shadow_resident(f, s, g16, aabbs, live)
        return (FI.occlude_resident(s, g16, aabbs, live),)

    def _grid_on(self, key, scene, f, s):
        from rustic_tpu_torch.ops import flash_intersect as FI

        g16, aabbs, live = scene.tri_feats16, scene.tile_aabbs, scene.n_tris
        if key == "K14":
            return FI.nearest_grid(f, g16, aabbs, n_live=live)
        if key == "K15":
            return FI.nearest_shadow_grid(f, s, g16, aabbs, n_live=live)
        return (FI.occlude_grid(s, g16, aabbs, n_live=live),)

    def _resident_cases(self, bounces, lanes: slice):
        """Operands of K14-K16 on `lanes` of a group traced through the
        kernel-shade loop: K14 on the bounce-0 camera rays, K15 on the
        sorted bounce-1 rays with the bounce-0 shadow rays, K16 on the
        sorted bounce-3 shadow rays."""
        def cut(x):
            return x[:, lanes].contiguous()

        return {
            "K14": (cut(bounces[0]["feats"]), None),
            "K15": (cut(bounces[1]["feats"]), cut(bounces[1]["pending"])),
            "K16": (None, cut(bounces[-1]["shadow_out"])),
        }

    def _resident_compare(self, what, scene, cases, n):
        """K14-K16 against their plain versions and against K9-K11 ->
        ({key: max |dt| or 0 against plain}, {key: tested rays per tile})."""
        from rustic_tpu_torch.ops import flash_intersect as FI

        errs, per_set = {}, {}
        for key, (f, s) in cases.items():
            out_k = self._resident_call(key, scene, f, s)
            t_p, i_p, o_p, _, per_set[key] = FI._grid_scan(f, s, scene.tri_feats16,
                                                           scene.tile_aabbs)[:5]
            out_p = {"K14": (t_p, i_p), "K15": (t_p, i_p, o_p), "K16": (o_p,)}[key]
            out_g = self._grid_on(key, scene, f, s)
            msg = []
            for against, out in (("plain", out_p), ("grid", out_g)):
                label = f"{key} vs {against}"
                if key != "K16":
                    frac, e, _ = self._cmp_winner(label, out_k[0], out_k[1], out[0], out[1])
                    msg.append(f"{against}: idx agree {frac:.6f}, max |dt| {e:.3g}")
                    if against == "plain":
                        errs[key] = e
                if key != "K14":
                    agree, _ = self._cmp_occ(label, out_k[-1], out[-1])
                    msg.append(f"{against}: occ agree {agree:.6f}")
                    if key == "K16" and against == "plain":
                        errs[key] = float((out_k[-1] - out[-1]).abs().max())
            log(f"{what} {key} n={n}: " + "; ".join(msg))
        return errs, per_set

    def resident_check(self):
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI

        names = {k: KERNELS[k]["name"] for k in RESIDENT}
        grid_of = {"K14": "K9", "K15": "K10", "K16": "K11"}
        log(f"device budget: {FI.resident_budget(self.dev)} (shared-memory bytes a block, "
            f"blocks a portable cluster)")
        for what, scene, bounces in (("VeachMIS", self.mt_scene, self.ks_bounces),
                                     ("BreakTime", self.bt_scene, self.bt_bounces)):
            g16, aabbs = scene.tri_feats16, scene.tile_aabbs
            _, tt, nt = FI.geometry(g16)
            plan = FI.use_resident(g16)
            if plan is None:
                self.fail(f"{what}: the triangle table does not fit a cluster")
            active = {k: FI.resident_active_clusters(names[k], plan, self.dev) for k in RESIDENT}
            log(f"{what}: {nt} tiles, {nt * tt} padded triangles in a cluster of {plan.cluster}, "
                f"{plan.chunks_per_rank} chunks = {plan.bytes_per_rank} bytes a rank; active "
                f"clusters {active} ({plan.cluster * max(active.values())} of "
                f"{torch.cuda.get_device_properties(self.dev).multi_processor_count} SMs)")
            lanes = bounces[0]["feats"].shape[1]
            for n in (CHECK_LANES, CHECK_LANES + RAGGED, lanes):
                errs, per_set = self._resident_compare(
                    what, scene, self._resident_cases(bounces, slice(0, n)), n)
            cases = self._resident_cases(bounces, slice(None))
            tile_tris = torch.clamp(
                scene.n_tris - torch.arange(nt, device=self.dev) * tt, 0, tt).double()
            table = g16.shape[1] * RAY_ROWS * 4 + aabbs.numel() * 4
            main = what == "VeachMIS"  # the resident render's scene: the kernels line
            for key, (f, s) in cases.items():
                def kern(key=key, f=f, s=s):
                    return self._resident_call(key, scene, f, s)

                def grid(key=key, f=f, s=s):
                    return self._grid_on(key, scene, f, s)

                if main:
                    self._bit_equal(f"{what} {key} against {grid_of[key]}", kern(), grid())
                    self.results[key]["max_abs_err"] = errs[key]
                    plain = {"K14": lambda f=f: FI.nearest_resident_plain(f, g16, aabbs),
                             "K15": lambda f=f, s=s: FI.nearest_shadow_resident_plain(
                                 f, s, g16, aabbs),
                             "K16": lambda s=s: FI.occlude_resident_plain(s, g16, aabbs)}[key]
                    self.time_pair(key, kern, plain, lanes, reps=3)
                    pairs = float((per_set[key].double() @ tile_tris).sum())
                    rows = [(lanes, r) for r, x in ((RAY_ROWS, f), (SHADOW_ROWS, s))
                            if x is not None]
                    out = {"K14": 8, "K15": 12, "K16": 4}[key] * lanes
                    self.set_bound(key, scan_bound(rows, pairs, out, table))
                self.time_turns(f"{what} at {lanes} lanes", f"resident {key}", kern,
                                f"grid {grid_of[key]}", grid)
            if main:
                self._cluster_sweep(what, scene, cases["K15"], plan, lanes)

    def _cluster_sweep(self, what, scene, case, plan, lanes):
        """K15 with the table spread over each cluster size from the plan's
        up to the device's largest: each rank tests a ray block against
        fewer chunks, the ranks' running limits loosen, and a ray's merge
        reads c - 1 other ranks' keys."""
        import statistics

        from rustic_tpu_torch.ops import flash_intersect as FI

        f, s = case
        n_chunks = scene.tri_feats16.shape[1] // 4 // FI.CHUNK
        name = KERNELS["K15"]["name"]
        real = FI.use_resident
        for c in range(plan.cluster, FI.resident_budget(self.dev)[1] + 1):
            forced = FI.ResidentPlan(c, -(-n_chunks // c))
            FI.use_resident = lambda g16, forced=forced: forced
            try:
                self._resident_call("K15", scene, f, s)  # warm
                ms = statistics.median(self.time_ms(
                    lambda: self._resident_call("K15", scene, f, s), reps=3))
            finally:
                FI.use_resident = real
            active = FI.resident_active_clusters(name, forced, self.dev)
            log(f"{what} K15 at {lanes} lanes, cluster of {c} ({forced.chunks_per_rank} chunks a "
                f"rank, {active} active clusters = {active * c} SMs, {c - 1} remote keys a ray "
                f"at the merge): {ms:.3f} ms ({self.card})")

    def resident_render(self):
        import numpy as np

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.runtime.render import render_image

        groups = MT_SPP // FOLD
        nb = self.mt_config.max_bounces
        list_calls = []
        real_lists = FI.block_tile_lists

        def counted_lists(*a, **k):
            list_calls.append(1)
            return real_lists(*a, **k)

        FI.block_tile_lists = counted_lists
        try:
            counts = self._render_mt("kernel-shade", MT_SPP, {
                "nearest_resident": 1, "nearest_shadow_resident": nb * groups - 1,
                "occlude_resident": 1, "shade_bounce_wide": nb * groups,
            }, scan="resident")
        finally:
            FI.block_tile_lists = real_lists
        if list_calls:
            self.fail(f"the resident render built tile lists {len(list_calls)} times")
        for key in RESIDENT:  # the main path's render of K14-K16
            self.results[key]["launches"] = counts[KERNELS[key]["name"]]
        config = dataclasses.replace(self.mt_config, width=64, height=64)
        films = {scan: render_image(self.mt_scene, config,
                                    RenderSettings(samples=4, multitile_scan=scan),
                                    device=self.dev) for scan in ("grid", "resident")}
        same = np.array_equal(films["grid"], films["resident"])
        log(f"VeachMIS 64x64x4 film, resident scans vs grid scans: equal {same}, mean "
            f"{films['resident'].mean():.6f}")
        if not same:
            self.fail("the resident and the grid films differ")
        self.mt_film(scans=[("kernel-shade", "resident")])

    # ---- phases 24-26: the fused loop (K17) -------------------------------------------

    def _differing_lanes(self, what, outs_a, outs_b):
        """[B] bool: the lanes on which the (state, next rays, shadow
        rays) of `outs_a` and `outs_b` differ in any bit (NaN equal to NaN)."""
        torch = self.torch
        diff = None
        for name, a, b in zip(("state", "next rays", "shadow rays"), outs_a, outs_b):
            if (a is None) != (b is None):
                self.fail(f"{what}: {name} present on one side only")
            if a is None:
                continue
            d = ~((a == b) | (torch.isnan(a) & torch.isnan(b))).all(dim=0)
            diff = d if diff is None else diff | d
        return diff

    def _fused_case(self, what, scene, cfg, b, params, st, feats, pending, sidx, off,
                    ref_scan, ref_shade, strict):
        """K17 on one bounce's operands: bit for bit against the two-launch
        composition on the card (`ref_scan` -> (t, idx, occ i32 or None,
        rows), then `ref_shade`), folded and held; then against its plain
        version. `strict`: no lane may differ from the composition (else
        at most 0.01% of them) -> the largest |d| against the plain version."""
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import fused_bounce as FB
        from rustic_tpu_torch.ops import shade_kernel as SK

        kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
        fkw = dict(kw, n_live=scene.n_tris, tile_aabbs=scene.tile_aabbs)
        g16, attrs = scene.tri_feats16, scene.tri_attrs
        n = st.shape[1]
        allowed = 0 if strict else int(1e-4 * n)
        args = (cfg, b, params, scene.entry_rows, st, feats, pending, g16, attrs, sidx, off)
        outs_k = FB.fused_bounce(*args, **fkw)
        if outs_k[3] is not None:
            self.fail(f"{what}: an occlusion row came back without hold_occ")
        t, i, occ, rows = ref_scan(feats, pending)
        shade_args = (cfg, b, params, scene.entry_rows, st, feats, t, i, rows)
        outs_c = ref_shade(*shade_args, occ, sidx, off, **kw)
        n_diff = int(self._differing_lanes(what, outs_k[:3], outs_c).sum())
        if n_diff > allowed:
            self.fail(f"{what}: K17 differs from the two launches on {n_diff} lanes")
        msg = f"{n_diff} lanes differ from scan then shade"
        if pending is not None:  # the held mode: occ handed back, nothing folded
            outs_h = FB.fused_bounce(*args, **fkw, hold_occ=True)
            # where a shadow ray is pending: elsewhere its rows are not a
            # ray, no consumer reads its occ, and a scan that culls may skip it
            n_occ = int(((outs_h[3] != occ) & (st[SK.SK_PEND_ELIG] > 0.5)).sum())
            n_held = int(self._differing_lanes(
                what, outs_h[:3], ref_shade(*shade_args, None, sidx, off, **kw)).sum())
            if n_occ > allowed or n_held > allowed:
                self.fail(f"{what}: held mode differs on {n_occ} occ entries, {n_held} lanes")
            msg += f"; held: {n_occ} occ entries, {n_held} lanes differ"
            del outs_h
        del outs_c

        # the plain version, where its scan picks what the kernel's picks
        t_p, i_p, o_p = FB.scan_plain(feats, pending, g16)
        agree = (i_p == i) & ((t_p < FI.BIG) == (t < FI.BIG))
        if o_p is not None:  # occ counts where a shadow ray is pending, as above
            agree &= (o_p == occ) | ~(st[SK.SK_PEND_ELIG] > 0.5)
        frac = float(agree.float().mean())
        if frac < 0.9999:
            self.fail(f"{what}: the plain scan agrees on {frac:.6f} of lanes (< 0.9999)")
        outs_p = FB.fused_bounce_plain(*args, **kw)
        elig = outs_p[0][SK.SK_PEND_ELIG] > 0.5
        if not torch.equal(elig[agree], (outs_k[0][SK.SK_PEND_ELIG] > 0.5)[agree]):
            self.fail(f"{what}: NEE eligibility differs from the plain version")
        worst = 0.0
        for name, k_, p_, sel in zip(("state", "next rays", "shadow rays"), outs_k, outs_p,
                                     (agree, agree, agree & elig)):
            if (k_ is None) != (p_ is None):
                self.fail(f"{what}: {name} present on one side only")
            if k_ is None:
                continue
            k_, p_ = k_[:, sel], p_[:, sel]
            err = torch.nan_to_num((k_ - p_).abs(), nan=0.0)
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
            bad = ~torch.isclose(k_, p_, rtol=1e-4, atol=1e-5, equal_nan=True)
            if bool(bad.any()):
                self.fail(f"{what}: {name} differs from the plain version at "
                          f"{int(bad.sum())} entries, max |d| {float(err.max()):.3g}")
        log(f"{what} n={n}: {msg}; plain scan agrees on {frac:.6f}, outputs allclose, "
            f"max |d| {worst:.3g}")
        return worst

    def _scan_tiles(self, scene):
        """The scan half of K17's many-tile composition: K9 or K10 in the
        grid form, then the row gather -> (t, idx, occ i32 or None, rows)."""
        import torch

        from rustic_tpu_torch.runtime import pipeline as P

        def scan_tiles(feats, pending):
            t, i, occ = P._scan(feats, pending, scene, "grid")
            return (t, i, None if occ is None else occ.to(torch.int32),
                    scene.tri_attrs[i.long()].T.contiguous())

        return scan_tiles

    def fused_check(self):
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import fused_bounce as FB
        from rustic_tpu_torch.ops import shade_kernel as SK
        from rustic_tpu_torch.runtime import pipeline as P

        self.main_path_inputs()
        scene, cfg = self.scene, self.config.static_part()
        g16, attrs, live = scene.tri_feats16, scene.tri_attrs, scene.n_tris

        def scan_1tile(feats, pending):
            if pending is None:
                t, i, rows = FI.nearest_attrs(feats, g16, attrs, live)
                return t, i, None, rows
            return FI.nearest_shadow_attrs(feats, pending, g16, attrs, live)

        worst = 0.0
        for n in (CHECK_LANES + RAGGED, MAIN_LANES):
            for b, rec in enumerate(self.bounces):
                def cut(x):
                    return None if x is None else x[..., :n].contiguous()

                e = self._fused_case(
                    f"K17 DarkCornell bounce {b}", scene, cfg, b, self.params, cut(rec["st"]),
                    cut(rec["feats"]), cut(rec["pending"]), cut(self.sidx), cut(self.off),
                    scan_1tile, SK.shade_bounce, strict=True)
                if n == MAIN_LANES:
                    worst = max(worst, e)
        self.results["K17"]["max_abs_err"] = worst
        torch.cuda.empty_cache()

        # VeachMIS: six tiles, a wide alias table; the group traced by K17
        self._mt_setup()
        cfg, cam, px, py, off = self._mt_group()
        scene = self.mt_scene
        if scene.n_alias_entries <= SK.MAX_ALIAS:
            self.fail("VeachMIS would not run K17's wide alias mode")
        mg16, mattrs = scene.tri_feats16, scene.tri_attrs
        scan_tiles = self._scan_tiles(scene)
        st, feats, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
        lanes = slice(480 * MT_SIZE, 480 * MT_SIZE + CHECK_LANES)  # rows 480-543 of sample 0
        pending = None
        kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries,
                  n_live=scene.n_tris, tile_aabbs=scene.tile_aabbs)
        for b in range(cfg.max_bounces):
            def cut(x):
                return None if x is None else x[..., lanes].contiguous()

            self._fused_case(
                f"K17 VeachMIS bounce {b}", scene, cfg, b, params, cut(st), cut(feats),
                cut(pending), cut(sidx), cut(off), scan_tiles, SK.shade_bounce_wide, strict=True)
            if b == 1:  # phase 25 times K17 on these operands
                self.mt_fused_b1 = (cfg, params, st, feats, pending, sidx, off)
            st, nf, pending, _ = FB.fused_bounce(
                cfg, b, params, scene.entry_rows, st, feats, pending, mg16, mattrs, sidx, off, **kw)
            if nf is not None:
                feats = nf
        torch.cuda.empty_cache()

    def fused_time(self):
        from rustic_tpu_torch.config import NextEventEstimation
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import fused_bounce as FB
        from rustic_tpu_torch.ops import shade_kernel as SK

        scene, cfg = self.scene, self.config.static_part()
        g16, attrs, live = scene.tri_feats16, scene.tri_attrs, scene.n_tris
        b1 = self.bounces[1]
        kw = dict(has_glass=scene.has_glass, n_alias=self.n_alias)
        args = (cfg, 1, self.params, scene.entry_rows, b1["st"], b1["feats"], b1["pending"], g16,
                attrs, self.sidx, self.off)

        def fused():
            return FB.fused_bounce(*args, **kw, n_live=live, tile_aabbs=scene.tile_aabbs)

        def two_launches():
            t, i, occ, rows = FI.nearest_shadow_attrs(b1["feats"], b1["pending"], g16, attrs, live)
            return SK.shade_bounce(cfg, 1, self.params, scene.entry_rows, b1["st"], b1["feats"],
                                   t, i, rows, occ, self.sidx, self.off, **kw)

        self.time_pair("K17", fused, lambda: FB.fused_bounce_plain(*args, **kw), MAIN_LANES)
        self.time_turns(f"at {MAIN_LANES} lanes", "K17", fused, "K2 then K4", two_launches, reps=10)
        n = MAIN_LANES
        _, nf, sf, _ = fused()
        rows = FB.rows_moved(True, False, nf.shape[0], sf.shape[0])
        table = g16.shape[1] * RAY_ROWS * 4 + attrs.numel() * 4 + self.n_alias * 48 * 4
        mis = cfg.nee == NextEventEstimation.MIS
        k4_rows = SK.rows_moved(True, mis, scene.has_glass, nf.shape[0], sf.shape[0])
        k2_rows = RAY_ROWS + SHADOW_ROWS + 3 + 32
        log(f"rows a lane: K17 {rows}, K2 {k2_rows} + K4 {k4_rows} "
            f"({(k2_rows + k4_rows - rows) * 4} B a lane less)")
        self.set_bound("K17", bound(rows * 4 * n + table, 2 * n * scene.n_tris * FLOPS_PER_PAIR))
        self.bounces = None
        self.torch.cuda.empty_cache()
        self._fused_time_many()

    def _fused_time_many(self):
        """K17 on many tiles: VeachMIS bounce-1 operands (phase 24's trace,
        4,194,304 lanes) held bit for bit to K10 -> gather -> K8 (no lane may
        differ), folded and held, and to its plain version; then timed beside
        its plain version, and against K10, the row gather and K8 in turns;
        its bound over the pairs each ray's slab test admits, as K10's bound
        counts them (logged: the kernels line keeps K17's one-tile row)."""
        import torch

        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import fused_bounce as FB
        from rustic_tpu_torch.ops import shade_kernel as SK

        scene = self.mt_scene
        cfg, params, st, feats, pending, sidx, off = self.mt_fused_b1
        g16, attrs, aabbs, live = scene.tri_feats16, scene.tri_attrs, scene.tile_aabbs, scene.n_tris
        kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
        args = (cfg, 1, params, scene.entry_rows, st, feats, pending, g16, attrs, sidx, off)
        n = st.shape[1]

        self._fused_case("K17 VeachMIS bounce 1", scene, cfg, 1, params, st, feats, pending,
                         sidx, off, self._scan_tiles(scene), SK.shade_bounce_wide, strict=True)

        def fused():
            return FB.fused_bounce(*args, **kw, n_live=live, tile_aabbs=aabbs)

        def three_launches():
            t, i, occ = FI.nearest_shadow_grid(feats, pending, g16, aabbs, n_live=live)
            rows = attrs[i.long()].T.contiguous()
            return SK.shade_bounce_wide(cfg, 1, params, scene.entry_rows, st, feats, t, i, rows,
                                        occ, sidx, off, **kw)

        self.time_pair("K17 VeachMIS bounce 1", fused, lambda: FB.fused_bounce_plain(*args, **kw),
                       n, reps=3, report=False)
        self.time_turns(f"VeachMIS at {n} lanes", "K17", fused, "K10 then gather then K8",
                        three_launches, reps=10)
        _, nf, sf, _ = fused()
        per_set = FI._grid_scan(feats, pending, g16, aabbs)[4].double()
        _, tt, nt = FI.geometry(g16)
        tile_tris = torch.clamp(live - torch.arange(nt, device=self.dev) * tt, 0, tt).double()
        pairs = float((per_set @ tile_tris).sum())
        rows = FB.rows_moved(True, False, nf.shape[0], sf.shape[0])
        table = (g16.shape[1] * RAY_ROWS * 4 + aabbs.numel() * 4 + attrs.numel() * 4
                 + scene.n_alias_entries * 48 * 4)
        b = bound(rows * 4 * n + table, pairs * FLOPS_PER_PAIR)
        log(f"K17 VeachMIS bound: {b[0]:.4f} ms ({b[1]}; {pairs:.4g} slab-admitted pairs, "
            f"{pairs / (2 * n * live):.4f} of all)")
        self.mt_fused_b1 = None
        torch.cuda.empty_cache()

    def fused_render(self):
        import numpy as np
        import torch

        from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
        from rustic_tpu_torch.runtime.render import render_image

        if getattr(self, "scene", None) is None:
            from rustic_tpu_torch.scene.world import World

            self.scene = World.from_path("assets/scenes/DarkCornell.glb").to_torch(self.dev)
            self.config = TracingConfig(width=WIDTH, height=HEIGHT, nee=NextEventEstimation.MIS)
        fused = RenderSettings(samples=SPP, single_tile_loop="fused")
        t0 = time.time()
        render_image(self.scene, self.config, dataclasses.replace(fused, samples=FOLD),
                     device=self.dev)
        log(f"fused warm-up render ({FOLD} spp): {time.time() - t0:.2f} s")
        groups, nb = SPP // FOLD, self.config.max_bounces
        for turn in range(2):  # in turns: fused, kernel-shade
            for what, settings in (("fused", fused), ("kernel-shade", RenderSettings(samples=SPP))):
                self.reset_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                film = render_image(self.scene, self.config, settings, device=self.dev)
                render_s = time.time() - t0
                counts = self.counts()
                log(f"render DarkCornell {WIDTH}x{HEIGHT}x{SPP} spp NEE+MIS, {what} loop: "
                    f"{render_s:.3f} s, {WIDTH * HEIGHT * SPP / render_s / 1e6:.2f} Mpaths/s "
                    f"({self.card})")
                if what != "fused":
                    continue
                log(f"launch counts: {counts}")
                expect = dict.fromkeys(counts, 0) | {"fused_bounce": nb * groups, "occlude": 1}
                if counts != expect:
                    self.fail(f"launch counts {counts} != expected {expect}")
                self.results["K17"]["launches"] = counts["fused_bounce"]
                mean = float(film.mean())
                log(f"film mean {mean:.6f} (reference {FILM_MEAN_REF}, "
                    f"{(mean / FILM_MEAN_REF - 1) * 100:+.3f}%)")
                if not np.isfinite(film).all() or film.shape != (HEIGHT, WIDTH, 3):
                    self.fail("film is not finite or has the wrong shape")
                if abs(mean / FILM_MEAN_REF - 1.0) > 0.02:
                    self.fail(f"film mean {mean} is not within 2% of {FILM_MEAN_REF}")

        small = TracingConfig(width=64, height=64, nee=NextEventEstimation.MIS)
        four = RenderSettings(samples=4, single_tile_loop="fused")
        a = render_image(self.scene, small, four, device=self.dev)
        b = render_image(self.scene, small, RenderSettings(samples=4), device=self.dev)
        cpu = render_image(self.scene.to("cpu"), small, four, device="cpu")
        bad = ~np.isclose(a, cpu, rtol=1e-4, atol=1e-5)
        log(f"DarkCornell 64x64x4 film, fused loop: equal to the kernel-shade loop's "
            f"{np.array_equal(a, b)}; card vs host CPU max |d| {np.abs(a - cpu).max():.3g}, "
            f"{int(bad.sum())} entries outside rtol 1e-4 / atol 1e-5, mean {a.mean():.6f}")
        if not np.array_equal(a, b):
            self.fail("the fused and the kernel-shade films of DarkCornell differ")
        if bad.any():
            self.fail("the fused loop's card and host films differ")
        self.scene = None

        self._mt_setup()
        groups = MT_UNSORTED_SPP // FOLD
        self._render_mt("fused", MT_UNSORTED_SPP, {
            "fused_bounce": self.mt_config.max_bounces * groups, "occlude_multi": 1})
        config = dataclasses.replace(self.mt_config, width=64, height=64)
        a, b = (render_image(self.mt_scene, config, RenderSettings(samples=4, multitile_loop=loop),
                             device=self.dev) for loop in ("fused", "kernel-shade"))
        bad = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
        log(f"VeachMIS 64x64x4 film, fused loop vs kernel-shade loop: equal "
            f"{np.array_equal(a, b)}, max |d| {np.abs(a - b).max():.3g}, {int(bad.sum())} "
            f"entries outside rtol 1e-4 / atol 1e-5, mean {a.mean():.6f}")
        if bad.any():
            self.fail("the fused and the kernel-shade films of VeachMIS differ")

    # ---- phase 27: the dot-rate probes (K18, K19) -------------------------------------

    # ---- launch counts of a render ---------------------------------------------------------

    def _loop_counts(self, loop, scan, scene, config, spp, pilots=0):
        """The launches a render of `config`'s frame (one pixel chunk) x spp
        through `loop` makes: the multi-tile loops' scans in the form `scan`
        (the one-tile kernel-shade loop's K1-K3), the shade kernel of the
        kernel-shade loops, and `pilots` runs of the state-sorted pilot
        (bounces 0 .. max_bounces - 2 of one sample)."""
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops.nee import ENTRY_SELECT_MAX
        from rustic_tpu_torch.runtime import pipeline as P

        n_px, nb = config.width * config.height, config.max_bounces
        nee = config.nee.uses_nee and scene.has_lights
        if FI.geometry(scene.tri_feats16)[2] == 1:
            near, both, occl = "nearest_attrs", "nearest_shadow_attrs", "occlude"
        else:
            near, both, occl = SCAN_KERNELS[scan]
        if loop == "state-sorted":  # no shadow rays held across groups
            groups = -(-spp // P.pick_sample_fold(n_px, spp, sorted_path=True))
            if not nee:
                return {near: groups * nb + pilots * (nb - 1)}
            return {near: groups + pilots, both: groups * (nb - 1) + pilots * (nb - 2),
                    occl: groups}
        groups = -(-spp // P.pick_sample_fold(n_px, spp))
        out = {near: nb * groups} if not nee else {near: 1, both: nb * groups - 1, occl: 1}
        if loop != "ray-sorted":
            n_alias = scene.n_alias_entries if nee else 0
            out["shade_bounce_wide" if n_alias > ENTRY_SELECT_MAX else "shade_bounce"] = nb * groups
        return out

    def _render_counted(self, scene, config, settings):
        """render_image on the card -> (film, seconds, launch counts, state-sorted
        pilots run, state-sorted groups finished). The pilots are counted
        at `_quantize_schedule`, which each pilot calls once (the pilot
        cache is keyed on `_pilot_schedule` itself, so that stays as it is)."""
        from rustic_tpu_torch.runtime import pipeline as P
        from rustic_tpu_torch.runtime.render import render_image

        seen = {"_quantize_schedule": 0, "ss_finish": 0}
        real = {name: getattr(P, name) for name in seen}

        def counted(name):
            def wrapper(*a, **k):
                seen[name] += 1
                return real[name](*a, **k)
            return wrapper

        for name in seen:
            setattr(P, name, counted(name))
        try:
            self.torch.cuda.synchronize()
            self.reset_counts()
            t0 = time.time()
            film = render_image(scene, config, settings, device=self.dev)
            seconds = time.time() - t0
            counts = self.counts()
        finally:
            for name, fn in real.items():
                setattr(P, name, fn)
        return film, seconds, counts, seen["_quantize_schedule"], seen["ss_finish"]

    def _check_counts(self, what, counts, expect):
        expect = dict.fromkeys(counts, 0) | expect
        if counts != expect:
            self.fail(f"{what}: launch counts {counts} != expected {expect}")

    def _film_gate(self, what, scene, config, ref, settings, note=""):
        """Render `config`'s frame at the reference's size and hold it to
        the reference film: relative energy within 1%, RMSE under the bound
        of tests/test_reference_films.py:84; the launch counts checked."""
        import numpy as np

        bound = 0.35 * max(float(ref.mean()), 0.05) + 0.05  # tests/test_reference_films.py:84
        film, wall, counts, pilots, _ = self._render_counted(scene, config, settings)
        loop = settings.multitile_loop
        self._check_counts(what, counts, self._loop_counts(
            loop, settings.multitile_scan, scene, config, settings.samples, pilots))
        rel_energy = abs(float(film.mean()) - float(ref.mean())) / max(float(ref.mean()), 1e-9)
        rmse = float(np.sqrt(np.mean((film - ref) ** 2)))
        log(f"{what} {config.width}x{config.height}x{settings.samples} spp: {wall:.2f} s, film "
            f"mean {film.mean():.6f} vs reference {ref.mean():.6f} (relative energy "
            f"{rel_energy:.6f}), RMSE {rmse:.6g} (bound {bound:.4g}{note})")
        if not np.isfinite(film).all():
            self.fail(f"{what}: film is not finite")
        if rel_energy > 0.01:
            self.fail(f"{what}: relative energy {rel_energy} is not within 1%")
        if rmse >= bound:
            self.fail(f"{what}: RMSE {rmse} is not under {bound}")

    # ---- phases 27-29: the other scenes, the sort modes, the reference films --------

    def _load(self, spec):
        from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
        from rustic_tpu_torch.scene.world import World

        t0 = time.time()
        scene = World.from_path(spec["path"]).to_torch(self.dev)
        w, h = spec["size"]
        config = TracingConfig(width=w, height=h, nee=NextEventEstimation.MIS, **spec["cam"])
        log(f"{spec['path']}: {scene.n_tris} triangles in "
            f"{scene.tile_aabbs.shape[0]} tiles, {scene.n_alias_entries} alias entries, "
            f"loaded in {time.time() - t0:.2f} s")
        return scene, config

    def _in_turns(self, what, scene, config, spp, variants, reps=3):
        """Each of `variants` ({label: RenderSettings at spp}) rendered once
        at one group's samples, then `reps` times in turns; each render's
        launch counts checked -> {label: [Mpaths/s, ...]}."""
        import numpy as np

        from rustic_tpu_torch.runtime import pipeline as P
        from rustic_tpu_torch.runtime.render import render_image

        n_px = config.width * config.height
        for label, settings in variants.items():
            sorted_path = settings.multitile_loop == "state-sorted"
            warm = P.pick_sample_fold(n_px, spp, sorted_path=sorted_path)
            render_image(scene, config, dataclasses.replace(settings, samples=warm),
                         device=self.dev)
        rates = {label: [] for label in variants}
        for _ in range(reps):
            for label, settings in variants.items():
                film, s, counts, pilots, groups = self._render_counted(scene, config, settings)
                loop = settings.multitile_loop
                if loop == "auto":
                    loop = "state-sorted" if groups else "kernel-shade"
                self._check_counts(f"{what}, {label}", counts, self._loop_counts(
                    loop, settings.multitile_scan, scene, config, spp, pilots))
                if not np.isfinite(film).all() or not film.mean() > 0.0:
                    self.fail(f"{what}, {label}: the film is not finite or is black")
                rates[label].append(n_px * spp / s / 1e6)
                used = {k: v for k, v in counts.items() if v}
                log(f"render {what} {config.width}x{config.height}x{spp} spp, {label}: {s:.3f} s, "
                    f"{rates[label][-1]:.2f} Mpaths/s, pilots {pilots}, launches {used}")
        for label, r in rates.items():
            log(f"{what}, {label}: median {statistics.median(r):.2f} Mpaths/s "
                f"({min(r):.2f}-{max(r):.2f}, {len(r)} renders; {self.card})")
        return rates

    def scenes_renders(self):
        """FurnaceTest, GlassTest and PBRTest through the kernel-shade loop
        with each scan form the scene admits, in turns."""
        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.runtime.pipeline import MULTITILE_SCANS
        from rustic_tpu_torch.runtime.render import render_image

        self.scan_rates = {}
        for name, spec in OTHER_SCENES.items():
            scene, config = self._load(spec)
            forms = list(MULTITILE_SCANS)
            if FI.use_resident(scene.tri_feats16) is None:
                forms.remove("resident")
                try:
                    render_image(scene, config, RenderSettings(samples=1, multitile_scan="resident"),
                                 device=self.dev)
                except ValueError as e:
                    log(f"{name}: the resident form is refused ({e})")
                else:
                    self.fail(f"{name}: the resident form took a table it does not fit")
            rates = self._in_turns(name, scene, config, spec["spp"], {
                scan: RenderSettings(samples=spec["spp"], multitile_loop="kernel-shade",
                                     multitile_scan=scan) for scan in forms})
            self.scan_rates[name] = rates
            best = max(rates, key=lambda k: statistics.median(rates[k]))
            log(f"{name}: fastest scan form {best}")
            del scene
            self.torch.cuda.empty_cache()

    def _ss_trace(self, scan):
        """One VeachMIS group (1,048,576 lanes: fold 1) traced through the
        state-sorted driver's stages with the pilot's schedule (compacted)
        -> per bounce the scan's operands; the last also its shadow rays."""
        import numpy as np
        import torch

        from rustic_tpu_torch.runtime import pipeline as P
        from rustic_tpu_torch.runtime.render import pixel_offsets

        scene = self.mt_scene
        cfg, cam = self.mt_config.static_part(), self.mt_config.dynamic_part(self.dev)
        y, x = np.mgrid[0:MT_SIZE, 0:MT_SIZE]
        px = torch.from_numpy(x.reshape(-1).astype(np.int32)).to(self.dev)
        py = torch.from_numpy(y.reshape(-1).astype(np.int32)).to(self.dev)
        off = pixel_offsets(MT_SIZE, MT_SIZE, use_blue_noise=False).view(np.int32)
        off = torch.from_numpy(off.copy()).to(self.dev)
        lanes, schedule = P.sort_mode_pilot(scene, cfg, cam, px, py, off, 0, MT_SPP, scan)
        if schedule is None:
            self.fail("VeachMIS: the pilot gave no compaction schedule")
        fold = lanes // px.shape[0]
        film = torch.zeros((px.shape[0], 3), dtype=torch.float32, device=self.dev)
        oflow = torch.zeros((), dtype=torch.bool, device=self.dev)
        px, py, off = (a.repeat(fold) for a in (px, py, off))
        st, feats, sidx, lane2px = P.ss_init(cfg, cam, px, py, 0, off, fold)
        recs, pending, prev_nee = [], None, None
        for b in range(cfg.max_bounces):
            t, idx, occ = P._scan(feats, pending, scene, scan)
            recs.append(dict(feats=feats, pending=pending))
            window = (schedule[b], film, oflow) if b < cfg.max_bounces - 1 else None
            st, feats, nee, sidx, off, lane2px, n = P.ss_pre(
                scene, cfg, cam, b, st, prev_nee, occ, t, idx, sidx, off, lane2px, window)
            if window is not None:
                oflow = n
            prev_nee, pending = nee if nee is not None else (None, None)
        recs[-1]["shadow_out"] = pending
        log(f"VeachMIS state-sorted group: {lanes} lanes, schedule {schedule}, scan lengths "
            f"{[r['feats'].shape[1] for r in recs]}, overflow {bool(oflow)}")
        if bool(oflow):
            self.fail("VeachMIS: the traced group overflowed its schedule")
        return recs

    def _ss_compare(self, recs, n):
        """Each form's three scans on the state-sorted operands (their first
        n lanes) against their plain versions: the nearest scan on the
        bounce-1 rays, the merged scan on bounce 1 (with the bounce-0
        shadow rays) and on bounce 3, the any-hit scan on the bounce-3
        shadow rays. K5/K6 bit for bit against the lists alone, as phase 6;
        the grid and resident forms as phases 14 and 22."""
        from rustic_tpu_torch.ops import flash_intersect as FI

        scene = self.mt_scene
        g16, aabbs, live = scene.tri_feats16, scene.tile_aabbs, scene.n_tris

        def cut(x):
            return None if x is None else x[:, :n].contiguous()

        cases = {
            "bounce-1 rays": (cut(recs[1]["feats"]), None),
            "bounce-1 rays + bounce-0 shadow rays": (cut(recs[1]["feats"]), cut(recs[1]["pending"])),
            "bounce-3 rays + bounce-2 shadow rays": (cut(recs[3]["feats"]), cut(recs[3]["pending"])),
            "bounce-3 shadow rays": (None, cut(recs[3]["shadow_out"])),
        }
        for (what, (f, s)), keys in zip(cases.items(), (("K5", "K9", "K14"), ("K6", "K10", "K15"),
                                                        ("K6", "K10", "K15"), ("K7", "K11", "K16"))):
            m = (f if f is not None else s).shape[1]
            sets = [r for r in (f, s) if r is not None]
            flags = (False,) if s is None else (True,) if f is None else (False, True)
            lists = FI.block_tile_lists(aabbs, FI.BT_MULTI, flags, *sets)
            if f is None:
                out_l = (FI.occlude_multi(s, g16, *lists, live),)
                plain_l = (FI.occlude_multi_plain(s, g16, *lists),)
                agree, _ = self._cmp_occ(f"{keys[0]} on {what}", out_l[0], plain_l[0])
                log(f"{keys[0]} n={m} on the state-sorted {what}: occ agree {agree:.6f}")
            else:
                if s is None:
                    out_l = FI.nearest_multi(f, g16, *lists, aabbs, live)
                    plain_l = FI.nearest_multi_plain(f, g16, *lists)
                else:
                    out_l = FI.nearest_shadow_multi(f, s, g16, *lists, aabbs, live)
                    plain_l = FI.nearest_shadow_multi_plain(f, s, g16, *lists)
                self._bit_equal(f"{keys[0]} n={m} on the state-sorted {what} against its plain "
                                f"version", out_l, plain_l)
            del out_l, plain_l
            t_p, i_p, o_p = FI._grid_scan(f, s, g16, aabbs)[:3]
            for key, call in zip(keys[1:], (self._grid_on, self._resident_call)):
                out = call(keys[2], scene, f, s)  # both take the resident keys
                msg = []
                if f is not None:
                    frac, e, _ = self._cmp_winner(f"{key} on {what}", out[0], out[1], t_p, i_p)
                    msg.append(f"idx agree {frac:.6f}, max |dt| {e:.3g}")
                if s is not None:
                    agree, _ = self._cmp_occ(f"{key} on {what}", out[-1], o_p)
                    msg.append(f"occ agree {agree:.6f}")
                log(f"{key} n={m} on the state-sorted {what} against its plain version: "
                    + "; ".join(msg))

    def sorted_modes(self):
        """The scans on the state-sorted driver's operands, then the
        state-sorted driver (compacted), "auto" and the kernel-shade loop
        in turns on VeachMIS and the scenes of phase 27, each scene's
        pilot schedule and work fraction W, and whether auto's pick
        (state-sorted where W <= 0.7) was the faster driver here; on
        VeachMIS also the state-sorted driver in the other scan forms."""
        import numpy as np
        import torch

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.runtime import pipeline as P
        from rustic_tpu_torch.runtime.pipeline import MULTITILE_SCANS
        from rustic_tpu_torch.runtime.render import pixel_offsets

        self._mt_setup()
        scan = RenderSettings.multitile_scan
        recs = self._ss_trace(scan)
        for n in (CHECK_LANES + RAGGED, None):
            self._ss_compare(recs, n if n is not None else recs[1]["feats"].shape[1])
        del recs
        torch.cuda.empty_cache()
        scenes = [("VeachMIS", lambda: (self.mt_scene, self.mt_config), MT_SPP)] + [
            (name, lambda spec=spec: self._load(spec), spec["spp"])
            for name, spec in OTHER_SCENES.items()]
        for name, load, spp in scenes:
            scene, config = load()
            rates = self._in_turns(name, scene, config, spp, {
                loop: RenderSettings(samples=spp, multitile_loop=loop, multitile_scan=scan)
                for loop in ("state-sorted", "auto", "kernel-shade")})
            cfg, cam = config.static_part(), config.dynamic_part(self.dev)
            n_px = config.width * config.height
            y, x = np.mgrid[0:config.height, 0:config.width]
            px = torch.from_numpy(x.reshape(-1).astype(np.int32)).to(self.dev)
            py = torch.from_numpy(y.reshape(-1).astype(np.int32)).to(self.dev)
            off = torch.from_numpy(pixel_offsets(config.width, config.height, False).view(np.int32))
            lanes, schedule = P.sort_mode_pilot(scene, cfg, cam, px, py, off.to(self.dev), 0, spp,
                                                scan)
            w = P.work_fraction(cfg, lanes, schedule)
            pick = P._pick_sort_mode(scene, cfg, cam, px, py, off.to(self.dev), 0, spp, scan)
            med = {k: statistics.median(v) for k, v in rates.items()}
            faster = "state" if med["state-sorted"] > med["kernel-shade"] else "rays"
            log(f"{name} {config.width}x{config.height}x{spp} spp, {scan} scans: pilot schedule "
                f"{schedule} of {lanes} lanes ({n_px} pixels), W {w}, auto picks {pick!r}; "
                f"state-sorted {med['state-sorted']:.2f}, auto {med['auto']:.2f}, kernel-shade "
                f"{med['kernel-shade']:.2f} Mpaths/s: the pick was "
                f"{'the faster' if pick == faster else 'the slower'} driver ({self.card})")
            if name != "VeachMIS":
                del scene
                torch.cuda.empty_cache()
                continue
            for other in MULTITILE_SCANS:  # the state-sorted driver's launches in each form
                if other == scan:
                    continue
                settings = RenderSettings(samples=spp, multitile_loop="state-sorted",
                                          multitile_scan=other)
                film, s, counts, pilots, _ = self._render_counted(scene, config, settings)
                self._check_counts(f"{name}, state-sorted, {other} scans", counts, self._loop_counts(
                    "state-sorted", other, scene, config, spp, pilots))
                if not np.isfinite(film).all():
                    self.fail(f"{name}, state-sorted, {other} scans: the film is not finite")
                log(f"render {name} {config.width}x{config.height}x{spp} spp, state-sorted, {other} "
                    f"scans: {s:.3f} s, {n_px * spp / s / 1e6:.2f} Mpaths/s, launches "
                    f"{ {k: v for k, v in counts.items() if v} } ({self.card})")

    def films(self):
        """DarkCornell, GlassTest and FurnaceTest 256x144 against their
        reference films through the default loop, and the multi-tile two
        through the state-sorted driver."""
        import numpy as np

        from rustic_tpu_torch.config import NextEventEstimation, RenderSettings, TracingConfig
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.scene.world import World

        for name, path, ref_file, spp, mis, cam in FILM_CASES:
            ref = np.load(ref_file)
            scene = World.from_path(path).to_torch(self.dev)
            nee = NextEventEstimation.MIS if mis else NextEventEstimation.NONE
            config = TracingConfig(width=ref.shape[1], height=ref.shape[0], nee=nee, **cam)
            loops = ["kernel-shade"]
            if FI.geometry(scene.tri_feats16)[2] > 1:
                loops.append("state-sorted")
            for loop in loops:
                self._film_gate(f"{name}, {loop} loop,", scene, config, ref,
                                RenderSettings(samples=spp, multitile_loop=loop))

    def probe_check(self):
        import torch

        from rustic_tpu_torch import probe_dot_floor as PF
        from rustic_tpu_torch.ops import probe_dot as PD

        n, reps, k = 1024, 8, PD.SPLIT_K
        if torch.backends.cuda.matmul.allow_tf32:
            self.fail("the plain versions need full-f32 products (allow_tf32 off)")

        def close(key, got, want, what):
            if got.dtype == torch.int32:
                if not torch.equal(got, want):
                    self.fail(f"{key} {what}: int32 results differ")
                return 0.0
            err = float((got - want).abs().max())
            # atol: a min near zero (terms of magnitude 1, summed in another order)
            if not bool(torch.isclose(got, want, rtol=1e-5, atol=1e-5).all()):
                self.fail(f"{key} {what}: differs from its plain version beyond rtol 1e-5, "
                          f"atol 1e-5 (max |d| {err:.3g})")
            return err

        def library(f, g):
            """One matmul and one amin in the operands' type, a chunk of rays at a time."""
            for lo in range(0, f.shape[1], 1 << 15):
                (f[:, lo : lo + (1 << 15)].T @ g).amin(dim=1)

        for b in (CHECK_LANES + RAGGED, PF.RAYS):
            f32, g32 = PF.operands("fp32", k, b, n * reps, self.dev)
            f8, g8 = PF.operands("int8", k, b, n * reps, self.dev)
            operands = {
                "fp32": (f32, g32),
                "tf32": (PD.round_tf32(f32), PD.round_tf32(g32)),
                "bf16": (f32.to(torch.bfloat16), g32.to(torch.bfloat16)),
                "int8": (f8, g8),
            }
            operands["bf16w"] = operands["bf16"]
            for v, (f, g) in operands.items():
                key = f"K18 {v}"
                for acc_min in (True, False) if v != "bf16w" else (True,):
                    e = close(key, PD.dot_min(f, g, n, reps, v, acc_min=acc_min),
                              PD.dot_min_plain(f, g, n, reps, v, acc_min=acc_min),
                              f"B={b} acc_min={acc_min}")
                    if acc_min:
                        err = e
                log(f"{key} B={b}: within rtol 1e-5 of its plain version (equal for int8), "
                    f"max |d| {err:.3g}")
                if b != PF.RAYS:
                    continue
                self.results[key]["max_abs_err"] = err
                self.time_pair(key, lambda: PD.dot_min(f, g, n, reps, v),
                               lambda: PD.dot_min_plain(f, g, n, reps, v), b, reps=5)
                if v != "int8":  # torch has no public int8 product on the card
                    torch.backends.cuda.matmul.allow_tf32 = v == "tf32"
                    try:
                        lib = self.time_ms(lambda: library(f, g), reps=5)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
                    self.results[key]["library_ms"] = sorted(lib)[len(lib) // 2]
                    log(f"{key}: torch.matmul + amin in {f.dtype}"
                        f"{' with allow_tf32' if v == 'tf32' else ''} "
                        f"{self.results[key]['library_ms']:.3f} ms")
                n_bytes = f.numel() * f.element_size() + g.numel() * g.element_size() + 4 * b
                peak = FP32_FLOP_PER_S if v == "fp32" else TENSOR_OP_PER_S[v]
                self.set_bound(key, bound(n_bytes, 2 * b * n * reps * k, peak))

            # K19: the split dots against their plain versions and float64
            g96, f96 = PD.cat6_g(g32), PD.cat6_f(f32)
            scale = f32.double().abs().T @ g32.double().abs().amax(dim=1)
            ref = torch.empty(b, dtype=torch.float64, device=self.dev)
            ha = f96[:k].double()  # the three-term dot is exact in G: ha . (hb + mb + lb)
            ref48 = torch.empty_like(ref)
            for lo in range(0, b, 1 << 14):
                ref[lo : lo + (1 << 14)] = (f32[:, lo : lo + (1 << 14)].double().T
                                            @ g32.double()).amin(dim=1)
                ref48[lo : lo + (1 << 14)] = (ha[:, lo : lo + (1 << 14)].T
                                              @ g32.double()).amin(dim=1)
            cases = {
                "pre-split K=96": (f96, g96, ref),
                "in-kernel split K=96": (f32, g96, ref),
                "pre-split K=48": (f96[:48].contiguous(), g96[:48].contiguous(), ref48),
            }
            for (what, (f, g, r64)), (key, v) in itertools.product(
                    cases.items(), (("K19", "bf16"), ("K19 bf16w", "bf16w"))):
                got = PD.dot_min_split(f, g, n, reps, variant=v)
                plain = PD.dot_min_split_plain(f, g, n, reps)
                e = close(key, got, plain, f"{what} B={b}")
                rel = float(((got.double() - r64).abs() / scale).max())
                log(f"{key} {what} B={b}: within rtol 1e-5 of its plain version (max |d| {e:.3g}); "
                    f"|d| against float64 at most {rel:.3g} x sum_k |F_k| max_n |G_kn|")
                if rel > 1e-5:
                    self.fail(f"{key} {what}: {rel:.3g} x the term scale from the float64 dot")
                if b == PF.RAYS and what == "in-kernel split K=96":
                    self.results[key]["max_abs_err"] = e
                    self.time_pair(key, lambda: PD.dot_min_split(f, g, n, reps, variant=v),
                                   lambda: PD.dot_min_split_plain(f, g, n, reps), b, reps=5)
                    n_bytes = f.numel() * 4 + g.numel() * 2 + 4 * b
                    self.set_bound(key, bound(n_bytes, 2 * b * n * reps * 6 * k,
                                              TENSOR_OP_PER_S["bf16"]))
            del operands, cases, f32, g32, f8, g8, g96, f96, ref, ref48, ha, scale
            torch.cuda.empty_cache()

        # the probes' path: their program, with the counts read after it
        self.reset_counts()
        if PF.main([]) != 0:
            self.fail("probe_dot_floor failed")
        counts = self.counts()
        log(f"launch counts of probe_dot_floor: "
            f"{ {k_: v_ for k_, v_ in counts.items() if v_} }")
        for key in self.results:
            if key.startswith(("K18", "K19")):
                self.results[key]["launches"] = counts[KERNELS[key]["name"]]
                if not counts[KERNELS[key]["name"]]:
                    self.fail(f"{key} was not launched by probe_dot_floor")

    # ---- phases ----------------------------------------------------------------------------

    def run(self, only=()) -> int:
        phases = [
            ("device", self.device),
            ("check", self.check),
            ("time", self.timing),
            ("render", self.render),
            ("cross-device", self.cross_device),
            ("multi-check", self.mt_check),
            ("multi-time", self.mt_timing),
            ("multi-render", self.mt_render),
            ("sort-check", self.sort_check),
            ("shade-check", self.shade_check),
            ("sorted-renders", self.sorted_renders),
            ("multi-film", self.mt_film),
            ("multi-cross-device", self.mt_cross_device),
            ("breaktime-check", self.bt_check),
            ("breaktime-time", self.bt_timing),
            ("breaktime-renders", self.bt_renders),
            ("breaktime-film", self.bt_film),
            ("breaktime-cross-device", self.bt_cross_device),
            ("single-check", self.single_check),
            ("single-renders", self.single_renders),
            ("single-films", self.single_films),
            ("resident-check", self.resident_check),
            ("resident-render", self.resident_render),
            ("fused-check", self.fused_check),
            ("fused-time", self.fused_time),
            ("fused-render", self.fused_render),
            ("scenes-renders", self.scenes_renders),
            ("sorted-modes", self.sorted_modes),
            ("films", self.films),
            ("probe-check", self.probe_check),
        ]
        if only:
            unknown = set(only) - {name for name, _ in phases}
            if unknown:
                log(f"unknown phases: {sorted(unknown)}")
                return 2
            phases = [(name, fn) for name, fn in phases if name == "device" or name in only]
        for name, fn in phases:
            if not self.phase(name, fn):
                log(f"FAILED phase: {name}")
                return 1
            if name == "cross-device":
                self.scene = None
            if name == "resident-check":
                self.ks_bounces = self.bt_bounces = None
                self.torch.cuda.empty_cache()
        torch = self.torch
        if only:  # a partial run proves nothing about the whole: no result lines
            log(f"ran only {sorted(only)}")
            return 0
        keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms"}
        for key, row in self.results.items():
            if set(row) != keys or not row["launches"]:
                log(f"FAILED: {key} lacks {sorted(keys - set(row))} or was never launched: {row}")
                return 1
        log(self.card)
        log(json.dumps({"kernels": list(self.results.values())}))
        log(json.dumps({
            "ok": True,
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                       "count": torch.cuda.device_count()},
        }))
        return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        traceback.print_exc()
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        import rustic_tpu_torch  # noqa: F401  (absent outside a checkout)
    except ImportError:
        traceback.print_exc()
        return 1
    only = ()
    if sys.argv[1:2] == ["--only"] and len(sys.argv) == 3:
        only = tuple(sys.argv[2].split(","))
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--only PHASE[,PHASE...]]", file=sys.stderr)
        return 2
    return Smoke().run(only)


if __name__ == "__main__":
    sys.exit(main())
