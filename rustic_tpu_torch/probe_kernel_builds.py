"""Six questions about how the kernels are built, asked on one CUDA device.

    python -m rustic_tpu_torch.probe_kernel_builds contraction [DIR ...]
    python -m rustic_tpu_torch.probe_kernel_builds shade LABEL=SOURCE.cu [LABEL=SOURCE.cu ...]
    python -m rustic_tpu_torch.probe_kernel_builds scans LABEL=DIR [LABEL=DIR ...]
    python -m rustic_tpu_torch.probe_kernel_builds fused LABEL=DIR [LABEL=DIR ...]
    python -m rustic_tpu_torch.probe_kernel_builds dots LABEL=DIR [LABEL=DIR ...]
    python -m rustic_tpu_torch.probe_kernel_builds bvh LABEL=DIR [LABEL=DIR ...]

`contraction`: do the scans round the same with and without nvcc's FMA
contraction? K17 (csrc/fused_bounce.cu) runs the scans' pair test in a
translation unit built with -fmad=false, as the shading needs, while the
scans themselves are built with contraction on; they give the same bits
only if no product of csrc/flash_common.cuh can be fused into an add.
Builds flash_intersect.cu, flash_multi.cu and flash_resident.cu of csrc/
(and those of them found in every DIR given: copies beside a variant of
the header) both ways, prints per kernel a digest of its SASS instruction
stream and its FADD / FMUL / FFMA counts, says where the two builds
differ (exit code 1 if those of csrc/ do), and runs K2
(`rt_nearest_shadow_attrs`) of every build on one traced DarkCornell
group of 1280x720x4 lanes, comparing (t, idx, occ, rows) with the first
build's bit for bit.

`shade`: the shade kernels K4 and K8 built from several versions of
shade.cu (each with -fmad=false, its includes found beside it, then in
csrc/), timed in turns on the main paths' operands: K4 on bounce 1 of a
DarkCornell group (3,686,400 lanes), K8 on bounce 1 of a VeachMIS group
traced through the kernel-shade loop (4,194,304 lanes); the median of 10
CUDA-event timings each, and whether the outputs equal the first
version's bit for bit.

`scans`: the one-tile scans K1-K3 (flash_intersect.cu), the list-form
and grid-form scans K5-K7 and K9-K11 (flash_multi.cu) and the resident
scans K14-K16 (flash_resident.cu) built from several versions of the
sources, each DIR holding its flash_intersect.cu, flash_multi.cu,
flash_resident.cu and flash_common.cuh, or some of the three sources (an
older version: `git show <commit>:rustic_tpu_torch/csrc/<file>` into a
directory under build/; the first DIR holds all three). K1
on the bounce-0 rays, K2 on bounces 1-3 and K3 on the last shadow rays of
one traced DarkCornell group (1280x720x4 = 3,686,400 lanes); K5 and K14 on
the camera rays, K6 and K15 on the sorted bounce-1 rays with the bounce-0
shadow rays, K7 and K16 on the sorted bounce-3 shadow rays of one
VeachMIS group (1024x1024x4 = 4,194,304 lanes) traced through the
kernel-shade loop, and K6 and K7 also on the same bounces of a group
traced through the unsorted loop; K9 on the bounce-0 rays, K10 on the
sorted bounce-1 rays with the bounce-0 shadow rays and K11 on the sorted
bounce-3 shadow rays of one BreakTime group (the first 1920x1080 pixel
chunk x 4 = 4,194,304 lanes, grid form, HDR sky, 4096^2 atlas). (t, idx,
occ, attr rows, tiles visited per block) against the first version's bit
for bit on every lane (NaN equal to NaN), and each kernel's versions
timed in turns on every case (median of 10 CUDA-event timings). Each
version's ABI is read from its `rt_scan_abi` (none: 1): from 2 the grid
form, from 3 the list form and the resident form read the packed table
or take the live triangle count, and K5 and K6 take the tiles' AABBs
for each ray's slab test of the nearest set inside the listed tiles.

`fused`: K17 (fused_bounce.cu, built with -fmad=false from each DIR, its
includes found beside it, then in csrc/) on every bounce of one traced
DarkCornell group (1280x720x4 = 3,686,400 lanes, through K1/K2 and K4)
and of one traced VeachMIS group (1024x1024x4 = 4,194,304 lanes, unsorted,
through K9/K10, a row gather and K8): folded and, where shadow rays are
pending, held; on DarkCornell with the alias entries in shared memory
(narrow) and read from the global table (wide), on VeachMIS wide. The
state, the next rays and the shadow rays against the first version's bit
for bit on every lane (NaN equal to NaN), and the held occlusion on
every lane on one tile, on many tiles on every lane whose NEE term is
eligible (the count of the others that differ printed); each case timed
in turns (median of 10 CUDA-event timings). Each version's ABI is read
from its `rt_fused_abi` (none: 1, the JAX table layout and every pair;
2: the packed table, the tiles' AABBs and the live count); from 2 the
blocks an SM holds in each mode (`rt_fused_blocks_per_sm`; both alias
modes, also the one the scene does not run). Registers and spills of
every template from the build logs.

`dots`: the dot-rate probes K18 (`rt_dot_min`) and K19
(`rt_dot_min_split`) built from several versions of probe_dot.cu (one in
each DIR; an older one: `git show <commit>:rustic_tpu_torch/csrc/probe_dot.cu`
into a directory under build/), each run on every case of
probe_dot_floor's sweep (CASES) and of its split sweep (the six-term split
dot at K = 96, F pre-split or split in the kernel, and the three-term dot
at K = 48, through mma.sync and through wgmma), at B = 2^20 rays on
`probe_dot_floor.operands`: the outputs against the first version's bit
for bit, and the versions timed in turns (median of 10 CUDA-event
timings). A case a version is not built for (a variant it lacks) is
skipped for it. The int8 `wgmma` cases ("int8w") are also held to the
first version's int8 `mma.sync` case of the same K, bit for bit.
Registers, spills and the compiler's wgmma notes of every build from its
log, each under its kernel's name, and the min instructions (FMNMX,
IMNMX, the DPX min of three) in the SASS of each build's int8 `wgmma`
kernels and of its rate kernels (`rt_min_rate`).

`bvh`: the BVH traversal K20n (`rt_bvh_nearest`) and K20a
(`rt_bvh_occluded`) built from several versions of bvh_traverse.cu (one
in each DIR, with -fmad=false; an older one: `git show
<commit>:rustic_tpu_torch/csrc/bvh_traverse.cu` into a directory under
build/, or an edited copy there), each run on two operand sets: phase 31's
of chip_smoke.py (the sorted bounce-1 rays and the bounce-0 shadow rays
of one fold group of VeachMIS 1024^2, BreakTime's first pixel chunk and
PBRTest 1024^2, 4,194,304 lanes each), and the oracle's
(make_reference_films `k20_operands`: the rays of bounces 0-3 of its
first trace_paths call on VeachMIS 1024^2 and on BreakTime's first pixel
chunk, 1,048,576 lanes a launch, in pixel order). Every output against
the first version's bit for bit, and the versions timed in turns (median
of 10 CUDA-event timings; a packed build's launch includes the zeroing
of its ray counter, as its wrapper's does). Each version's ABI is read
from its `rt_bvh_abi` (none: 1, the struct of arrays and the shading
rows; 2: the packed records and a ray counter), so each takes its own
layout of the same scene. Registers and spills of every build from its
log, and from ABI 2 the blocks an SM holds.

All print the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.ops import flash_intersect as FI
from rustic_tpu_torch.ops import shade_kernel as SK
from rustic_tpu_torch.runtime import pipeline as P
from rustic_tpu_torch.runtime.render import pixel_offsets
from rustic_tpu_torch.scene import world as W
from rustic_tpu_torch.scene.world import World

FOLD = 4
SCAN_SOURCES = ("flash_intersect", "flash_multi", "flash_resident")
VEACH_CAM = dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a"


def group(path, config, device):
    """(scene, cfg, cam, px, py, offsets) of one fold group of the frame."""
    scene = World.from_path(path).to_torch(device)
    h, w = config.height, config.width
    y, x = np.mgrid[0:h, 0:w]
    px = torch.from_numpy(x.reshape(-1).astype(np.int32)).to(device).repeat(FOLD)
    py = torch.from_numpy(y.reshape(-1).astype(np.int32)).to(device).repeat(FOLD)
    off = pixel_offsets(w, h, use_blue_noise=False).view(np.int32)
    off = torch.from_numpy(off.copy()).to(device).repeat(FOLD)
    return scene, config.static_part(), config.dynamic_part(device), px, py, off


def darkcornell_bounce1(device):
    """Bounce 1 of a DarkCornell 1280x720x4 group through K1/K2 and K4 ->
    (scene, the operands of K2, the arguments of K4)."""
    config = TracingConfig(width=1280, height=720, nee=NextEventEstimation.MIS)
    scene, cfg, cam, px, py, off = group("assets/scenes/DarkCornell.glb", config, device)
    g16, attrs = scene.tri_feats16, scene.tri_attrs
    kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
    st, feats, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
    t, i, a = FI.nearest_attrs(feats, g16, attrs, scene.n_tris)
    st, feats, pending = SK.shade_bounce(cfg, 0, params, scene.entry_rows, st, feats, t, i, a,
                                         None, sidx, off, **kw)
    t, i, occ, a = FI.nearest_shadow_attrs(feats, pending, g16, attrs, scene.n_tris)
    shade_args = (cfg, 1, params, scene.entry_rows, st, feats, t, i, a, occ, sidx, off)
    return scene, (feats, pending), (shade_args, kw)


def veachmis_bounce1(device):
    """Bounce 1 of a VeachMIS 1024x1024x4 group through the kernel-shade
    loop -> the arguments of K8."""
    config = TracingConfig(width=1024, height=1024, nee=NextEventEstimation.MIS, **VEACH_CAM)
    scene, cfg, cam, px, py, off = group("assets/scenes/VeachMIS.glb", config, device)
    kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
    st, feats_t, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
    t, i, occ = P._scan(feats_t, None, scene)
    t, i, occ, attrs_t = P.ks_resolve(scene, feats_t, t, i, occ, None)
    st, nf, sf = SK.shade_bounce_wide(cfg, 0, params, scene.entry_rows, st, feats_t, t, i,
                                      attrs_t, occ, sidx, off, **kw)
    feats_in, pending, inv = P.ks_sort(scene, st, nf, sf)
    t, i, occ = P._scan(feats_in, pending, scene)
    t, i, occ, attrs_t = P.ks_resolve(scene, nf, t, i, occ, inv)
    return (cfg, 1, params, scene.entry_rows, st, nf, t, i, attrs_t, occ, sidx, off), kw


def time_ms(fn) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


# ---- one scan from a given build ------------------------------------------------

# key -> (source, entry point, ray sets (nearest, any-hit), outputs)
SCANS = {
    "K1": ("flash_intersect", "rt_nearest_attrs", (True, False), ("t", "idx", "rows")),
    "K2": ("flash_intersect", "rt_nearest_shadow_attrs", (True, True), ("t", "idx", "occ", "rows")),
    "K3": ("flash_intersect", "rt_occlude", (False, True), ("occ",)),
    "K9": ("flash_multi", "rt_nearest_grid", (True, False), ("t", "idx", "visits")),
    "K10": ("flash_multi", "rt_nearest_shadow_grid", (True, True), ("t", "idx", "occ", "visits")),
    "K11": ("flash_multi", "rt_occlude_grid", (False, True), ("occ", "visits")),
    "K5": ("flash_multi", "rt_nearest_multi", (True, False), ("t", "idx")),
    "K6": ("flash_multi", "rt_nearest_shadow_multi", (True, True), ("t", "idx", "occ")),
    "K7": ("flash_multi", "rt_occlude_multi", (False, True), ("occ",)),
    "K14": ("flash_resident", "rt_nearest_resident", (True, False), ("t", "idx")),
    "K15": ("flash_resident", "rt_nearest_shadow_resident", (True, True), ("t", "idx", "occ")),
    "K16": ("flash_resident", "rt_occlude_resident", (False, True), ("occ",)),
}
LIST_FORM = ("K5", "K6", "K7")
RESIDENT = ("K14", "K15", "K16")


def scan_abi(lib: str) -> int:
    """The build's `rt_scan_abi`: 3 where the list form reads the packed
    table (flash_multi.cu) or the resident form takes the live count
    (flash_resident.cu), 2 where only the grid form and the one-tile scans
    read the packed table and take the live count, 1 for a build without
    it (the JAX layout, no live count)."""
    try:
        fn = ctypes.CDLL(lib).rt_scan_abi
    except AttributeError:
        return 1
    fn.restype = ctypes.c_int
    return fn()


def scan_outputs(key, scene, b):
    """Fresh outputs of scan `key` for `b` rays, in its entry point's order."""
    dev = scene.tri_feats16.device
    alloc = {
        "t": lambda: torch.empty(b, dtype=torch.float32, device=dev),
        "idx": lambda: torch.empty(b, dtype=torch.int32, device=dev),
        "occ": lambda: torch.empty(b, dtype=torch.int32, device=dev),
        "rows": lambda: torch.empty((scene.tri_attrs.shape[1], b), dtype=torch.float32, device=dev),
        "visits": lambda: torch.empty(-(-b // FI.BT_MULTI), dtype=torch.int32, device=dev),
    }
    return tuple(alloc[name]() for name in SCANS[key][3])


def run_scan(lib, key, scene, f, s, outs=None, lists=None):
    """Launch scan `key` of build `lib` on rays `f` (nearest set) and `s`
    (any-hit set) -> its outputs, in SCANS order. A list-form scan takes
    its `lists` (lists, counts) and, from ABI 3 (K5, K6), the tiles'
    AABBs."""
    _, fn, (near, anyhit), names = SCANS[key]
    b = (f if f is not None else s).shape[1]
    outs = scan_outputs(key, scene, b) if outs is None else outs
    g16, aabbs, live = scene.tri_feats16, scene.tile_aabbs, scene.n_tris
    t_pad, tt, nt = FI.geometry(g16)
    abi = scan_abi(lib)
    rays = [x for x, on in ((f, near), (s, anyhit)) if on]
    if key in LIST_FORM:
        new = abi >= 3
        table = ((FI.packed_table(g16),) + ((aabbs,) if key != "K7" else ())
                 if new else (g16,))
        ptrs = (*rays, *table, *lists, *outs)
        ints = (b, nt, tt) + ((live,) if new else ())
    elif key in RESIDENT:
        plan = FI.use_resident(g16)
        ptrs = (*rays, g16, aabbs, *outs)
        ints = (b, nt, tt) + ((live,) if abi >= 3 else ()) + (plan.cluster, plan.chunks_per_rank)
    else:
        table = FI.packed_table(g16) if abi >= 2 else g16
        grid = "visits" in names
        ptrs = (*rays, table, *((aabbs,) if grid else
                                (scene.tri_attrs,) if "rows" in names else ()), *outs)
        ints = ((b, nt, tt) if grid else (b, tt, scene.tri_attrs.shape[1]) if "rows" in names
                else (b, tt))
        ints += (live,) if abi >= 2 else ()
    entry = _build.load_entry(lib, fn, len(ptrs), len(ints))
    _build.launch(entry, key, g16.device, ptrs, ints)
    return outs


# ---- contraction ---------------------------------------------------------------


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")


def sass_by_kernel(lib: str) -> dict:
    """{kernel: its SASS instructions, addresses and encodings stripped}."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True, text=True, check=True)
    kernels, name = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and name is not None:
            kernels[name].append(m.group(1).strip())
    return kernels


def min_opcodes(body) -> dict:
    """{opcode: count} of the min and max instructions (FMNMX, VIMNMX,
    VIMNMX3, ...) in one kernel's SASS (`sass_by_kernel`)."""
    return dict(Counter(next(w for w in ins.split() if not w.startswith("@"))  # after a predicate
                        for ins in body if "MNMX" in ins))


def contraction(dirs) -> int:
    device = torch.device("cuda", 0)
    scene, (feats, pending), _ = darkcornell_bounce1(device)
    first = None
    failed = False
    flags = ((), ("-fmad=false",))
    jobs = [(os.path.join(d, f"{name}.cu"), flag) for d in dirs for name in SCAN_SOURCES
            for flag in flags if os.path.exists(os.path.join(d, f"{name}.cu"))]
    with ThreadPoolExecutor(8) as pool:  # one nvcc per source and flag
        libs = dict(zip(jobs, pool.map(lambda job: _build.compile_source(*job), jobs)))
    for d in dirs:
        for name in SCAN_SOURCES:
            if (os.path.join(d, f"{name}.cu"), ()) not in libs:
                continue  # a variant directory may hold some of the scans only
            sass = {}
            for flag in flags:
                lib = libs[os.path.join(d, f"{name}.cu"), flag]
                sass[flag] = sass_by_kernel(lib)
                if name != "flash_intersect":
                    continue
                got = run_scan(lib, "K2", scene, feats, pending)
                torch.cuda.synchronize()
                t, idx, occ, rows = got
                if first is None:
                    first = got
                same = all(torch.equal(x, y) for x, y in zip(got, first))
                print(f"{d} {name} {' '.join(flag) or '(contraction on)'}: K2 on {feats.shape[1]} lanes "
                      f"{'equals' if same else 'DIFFERS from'} the first build's "
                      f"({int((t != first[0]).sum())} t, {int((idx != first[1]).sum())} idx, "
                      f"{int((occ != first[2]).sum())} occ differ)")
            on, off = sass[()], sass[("-fmad=false",)]
            for kernel in on:
                ops = on[kernel]
                digest = hashlib.sha1("\n".join(ops).encode()).hexdigest()[:10]
                count = {op: sum(1 for x in ops if re.search(rf"\b{op}\b", x))
                         for op in ("FADD", "FMUL", "FFMA")}
                same = ops == off.get(kernel)
                failed |= not same and d == dirs[0]  # csrc/ decides the verdict
                print(f"{d} {name} {kernel[:60]}: sass {digest} {count}, "
                      f"{'the same' if same else 'NOT the same'} with -fmad=false")
    print("the scans are independent of FMA contraction" if not failed else
          "FMA contraction changes a scan: write the rounding out in flash_common.cuh")
    return int(failed)


# ---- shade ----------------------------------------------------------------------


def shade(sources) -> int:
    device = torch.device("cuda", 0)
    card = card_line()
    _, _, (k4_args, k4_kw) = darkcornell_bounce1(device)
    k8_args, k8_kw = veachmis_bounce1(device)
    cases = {"K4": ("rt_shade_bounce", k4_args, k4_kw), "K8": ("rt_shade_bounce_wide", k8_args, k8_kw)}
    libs = {}
    for spec in sources:
        label, _, path = spec.partition("=")
        libs[label] = _build.compile_source(path, _build.EXTRA_FLAGS["shade"])
        with open(libs[label][: -len(".so")] + ".log") as f:
            for line in f:
                if "registers" in line:
                    print(f"{label}: {line.strip()}")
    for key, (fn, args, kw) in cases.items():
        cfg, bounce, params, entry_rows, st, feats_t, t, idx, attrs_t, occ, sidx, offsets = args
        b = st.shape[1]
        outs = {label: (torch.empty((SK.NST, b), dtype=torch.float32, device=device),
                        torch.empty((16, b), dtype=torch.float32, device=device),
                        torch.empty((16, b), dtype=torch.float32, device=device)) for label in libs}

        def launch(label):
            _build.launch(
                _build.load_entry(libs[label], fn, 14, 10), key, device,
                (params, entry_rows, st, feats_t, t, idx, attrs_t, occ, sidx, offsets,
                 SK._lds_primes(device), *outs[label]),
                (b, bounce, cfg.min_bounces, cfg.max_bounces, int(cfg.nee), 1,
                 int(kw["has_glass"]), kw["n_alias"], entry_rows.shape[0], int(cfg.has_skybox)))

        times = {label: [] for label in libs}
        for label in libs:  # warm
            launch(label)
        torch.cuda.synchronize()
        for _ in range(10):  # in turns
            for label in libs:
                times[label].append(time_ms(lambda label=label: launch(label)))
        base = next(iter(libs))
        for label in libs:
            same = all(bool(((x == y) | (x.isnan() & y.isnan())).all())
                       for x, y in zip(outs[label], outs[base]))
            print(f"{key} at {b} lanes, {label}: {statistics.median(times[label]):.3f} ms "
                  f"(min {min(times[label]):.3f}); outputs "
                  f"{'equal' if same else 'DIFFER from'} {base}'s ({card})")
    return 0


# ---- fused ----------------------------------------------------------------------


def fused_abi(lib: str) -> int:
    """The build's `rt_fused_abi`: 2 where K17 reads the packed table and
    takes the tiles' AABBs and the live count, 1 for a build without it."""
    try:
        fn = ctypes.CDLL(lib).rt_fused_abi
    except AttributeError:
        return 1
    fn.restype = ctypes.c_int
    return fn()


def fused_trace(name, device):
    """One group of `name` traced through the kernel-shade composition of
    K17 (one tile: K1/K2 and K4; many: K9/K10 in the grid form, a row
    gather and K8, unsorted) -> (scene, cfg, params, sidx, offsets,
    [(st, feats, pending shadow rows)] a bounce)."""
    from rustic_tpu_torch.ops import fused_bounce as FB

    if name == "DarkCornell":
        config = TracingConfig(width=1280, height=720, nee=NextEventEstimation.MIS)
    else:
        config = TracingConfig(width=1024, height=1024, nee=NextEventEstimation.MIS, **VEACH_CAM)
    scene, cfg, cam, px, py, off = group(f"assets/scenes/{name}.glb", config, device)
    if not FB.supported(scene, cfg):
        raise ValueError(f"{name} is outside K17's envelope")
    kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
    many = FI.geometry(scene.tri_feats16)[2] > 1
    shade = SK.shade_bounce_wide if scene.n_alias_entries > SK.MAX_ALIAS else SK.shade_bounce
    st, feats, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
    pending, bounces = None, []
    for b in range(cfg.max_bounces):
        bounces.append((st, feats, pending))
        if many:
            t, i, occ = P._scan(feats, pending, scene, "grid")
            occ = None if occ is None else occ.to(torch.int32)
            rows = scene.tri_attrs[i.long()].T.contiguous()
        elif pending is None:
            (t, i, rows), occ = FI.nearest_attrs(feats, scene.tri_feats16, scene.tri_attrs,
                                                 scene.n_tris), None
        else:
            t, i, occ, rows = FI.nearest_shadow_attrs(feats, pending, scene.tri_feats16,
                                                      scene.tri_attrs, scene.n_tris)
        st, nf, pending = shade(cfg, b, params, scene.entry_rows, st, feats, t, i, rows, occ,
                                sidx, off, **kw)
        feats = nf if nf is not None else feats
    return scene, cfg, params, sidx, off, bounces


def run_fused(lib, scene, cfg, bounce, params, st, feats, pending, sidx, off, outs, wide):
    """Launch K17 of build `lib` into `outs` (state, next rays or None,
    shadow rays, occ or None: held when given)."""
    g16, dev = scene.tri_feats16, st.device
    _, tt, nt = FI.geometry(g16)
    n_alias = scene.n_alias_entries
    primes = SK._lds_primes(dev)
    ints = (cfg.min_bounces, cfg.max_bounces, int(cfg.nee), int(n_alias > 0),
            int(scene.has_glass), n_alias, scene.entry_rows.shape[0], int(wide))
    head = (params, scene.entry_rows, st, feats, pending)
    if fused_abi(lib) >= 2:
        ptrs = (*head, FI.packed_table(g16), scene.tile_aabbs if nt > 1 else None,
                scene.tri_attrs, sidx, off, primes, *outs)
        ints = (st.shape[1], nt, tt, scene.tri_attrs.shape[1], scene.n_tris, bounce) + ints
    else:
        ptrs = (*head, g16, scene.tri_attrs, sidx, off, primes, *outs)
        ints = (st.shape[1], nt, tt, scene.tri_attrs.shape[1], bounce) + ints
    entry = _build.load_entry(lib, "rt_fused_bounce", len(ptrs), len(ints))
    _build.launch(entry, "K17", dev, ptrs, ints)


def fused(specs) -> int:
    device = torch.device("cuda", 0)
    card = card_line()
    dirs = dict(spec.split("=", 1) for spec in specs)
    with ThreadPoolExecutor(len(dirs)) as pool:  # one nvcc per source
        libs = dict(zip(dirs, pool.map(lambda label: _build.compile_source(
            os.path.join(dirs[label], "fused_bounce.cu"), _build.EXTRA_FLAGS["fused_bounce"]),
            dirs)))
    for label, lib in libs.items():
        with open(lib[: -len(".so")] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"{label}: {line.strip()}")
    failed = False
    for name in ("DarkCornell", "VeachMIS"):
        scene, cfg, params, sidx, off, bounces = fused_trace(name, device)
        torch.cuda.synchronize()
        many = FI.geometry(scene.tri_feats16)[2] > 1
        wides = (True,) if scene.n_alias_entries > SK.MAX_ALIAS else (False, True)
        for label, lib in libs.items():
            if fused_abi(lib) < 2:
                continue
            fn = getattr(ctypes.CDLL(lib), "rt_fused_blocks_per_sm")
            fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
            print(f"{label} {name}: blocks an SM holds (any-hit set, alias mode): " + ", ".join(
                f"{'shadow' if any_ else 'none'} {'wide' if w else 'narrow'} "
                f"{fn(int(many), int(any_), int(w), scene.n_tris)}"
                for any_ in (False, True) for w in (False, True)))
        for bounce, (st, feats, pending) in enumerate(bounces):
            b = st.shape[1]
            last = bounce == cfg.max_bounces - 1
            eligible = st[SK.SK_PEND_ELIG] > 0.5
            for hold in (False,) if pending is None else (False, True):
                for wide in wides:
                    what = (f"{name} bounce {bounce} {'held' if hold else 'folded'} "
                            f"{'wide' if wide else 'narrow'}")

                    def alloc():
                        return (torch.empty((SK.NST, b), dtype=torch.float32, device=device),
                                None if last else torch.empty((16, b), dtype=torch.float32,
                                                              device=device),
                                torch.empty((16, b), dtype=torch.float32, device=device),
                                torch.empty(b, dtype=torch.int32, device=device) if hold else None)

                    outs = {label: alloc() for label in libs}

                    def run(label, bounce=bounce, st=st, feats=feats, pending=pending,
                            wide=wide, outs=outs):
                        run_fused(libs[label], scene, cfg, bounce, params, st, feats, pending,
                                  sidx, off, outs[label], wide)

                    for label in libs:
                        run(label)
                    torch.cuda.synchronize()
                    base = next(iter(libs))
                    for label in libs:
                        diff = [int((~((x == y) | (x.isnan() & y.isnan()))).any(dim=0).sum())
                                if x is not None else 0
                                for x, y in zip(outs[label][:3], outs[base][:3])]
                        msg = f"(state, next rays, shadow rays) lanes differing {diff}"
                        bad = any(diff)
                        if hold:
                            occ_diff = outs[label][3] != outs[base][3]
                            n_elig = int((occ_diff & eligible).sum())
                            n_other = int((occ_diff & ~eligible).sum())
                            bad |= n_elig > 0 or (not many and n_other > 0)
                            msg += f"; held occ differing: {n_elig} eligible, {n_other} not"
                        failed |= bad
                        print(f"K17 {what} at {b} lanes, {label}: "
                              f"{'DIFFERS from' if bad else 'equals'} {base}'s: {msg}")
                    times = {label: [] for label in libs}
                    for label in libs:  # warm
                        run(label)
                    torch.cuda.synchronize()
                    for _ in range(10):  # in turns
                        for label in libs:
                            times[label].append(time_ms(lambda label=label: run(label)))
                    print(f"K17 {what}: " + ", ".join(
                        f"{label} {statistics.median(ts):.3f} ms (min {min(ts):.3f})"
                        for label, ts in times.items()) + f" ({card})")
                    del outs
        del scene, bounces
        torch.cuda.empty_cache()
    print("every version equals the first bit for bit (held occ: on every lane of one tile, "
          "on the eligible lanes of many)" if not failed else "a version DIFFERS from the first")
    return int(failed)


# ---- scans ----------------------------------------------------------------------


def darkcornell_cases(device):
    """{key: [(what, f, s)]}: K1-K3's operands on one DarkCornell group
    traced through the kernel-shade loop -> (scene, cases)."""
    config = TracingConfig(width=1280, height=720, nee=NextEventEstimation.MIS)
    scene, cfg, cam, px, py, off = group("assets/scenes/DarkCornell.glb", config, device)
    g16, attrs, live = scene.tri_feats16, scene.tri_attrs, scene.n_tris
    kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
    st, feats, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
    cases, pending = {"K1": [], "K2": [], "K3": []}, None
    for bounce in range(cfg.max_bounces):
        if pending is None:
            cases["K1"].append((f"bounce {bounce}", feats, None))
            t, i, a = FI.nearest_attrs(feats, g16, attrs, live)
            occ = None
        else:
            cases["K2"].append((f"bounce {bounce}", feats, pending))
            t, i, occ, a = FI.nearest_shadow_attrs(feats, pending, g16, attrs, live)
        st, nf, pending = SK.shade_bounce(cfg, bounce, params, scene.entry_rows, st, feats, t, i,
                                          a, occ, sidx, off, **kw)
        feats = nf if nf is not None else feats
    cases["K3"].append(("the last shadow rays", None, pending))
    return scene, cases


def veachmis_cases(device):
    """K5-K7's and K14-K16's operands on one VeachMIS group traced through
    the kernel-shade loop and, K6's and K7's on unsorted rays, through the
    unsorted loop (both with the grid-form scans) -> (scene, cases)."""
    config = TracingConfig(width=1024, height=1024, nee=NextEventEstimation.MIS, **VEACH_CAM)
    scene, cfg, cam, px, py, off = group("assets/scenes/VeachMIS.glb", config, device)
    kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
    st, feats_t, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
    cases = {key: [] for key in LIST_FORM + RESIDENT}
    for key in ("K5", "K14"):
        cases[key].append(("camera rays", feats_t, None))
    pending = inv = rays = None
    for bounce in range(cfg.max_bounces):
        rays = feats_t if rays is None else rays
        if bounce == 1:
            for key in ("K6", "K15"):
                cases[key].append(("sorted bounce 1", rays, pending))
        t, i, occ = P._scan(rays, pending, scene, "grid")
        t, i, occ, attrs_t = P.ks_resolve(scene, feats_t, t, i, occ, inv)
        st, nf, sf = SK.shade_bounce_wide(cfg, bounce, params, scene.entry_rows, st, feats_t, t,
                                          i, attrs_t, occ, sidx, off, **kw)
        rays, pending, inv = P.ks_sort(scene, st, nf, sf)
        feats_t = nf if nf is not None else feats_t
    for key in ("K7", "K16"):
        cases[key].append(("sorted bounce-3 shadow rays", None, pending))
    st, feats, sidx = P.stage_init(cfg, cam, px, py, 0, off, FOLD)
    pending = prev_nee = None
    for bounce in range(cfg.max_bounces):
        if bounce == 1:
            cases["K6"].append(("unsorted bounce 1", feats, pending))
        t, i, occ = P._scan(feats, pending, scene, "grid")
        st, nf, nee = P.stage_pre(scene, cfg, cam, bounce, st, feats, prev_nee, occ, t, i, sidx,
                                  off)
        prev_nee, pending = nee if nee is not None else (None, None)
        feats = nf if nf is not None else feats
    cases["K7"].append(("unsorted bounce-3 shadow rays", None, pending))
    return scene, cases


def breaktime_cases(device):
    """K9-K11's operands on the first pixel chunk of BreakTime (folded 4
    times) traced through the kernel-shade loop in the grid form ->
    (scene, cases)."""
    config = TracingConfig(width=1920, height=1080, nee=NextEventEstimation.MIS,
                           cam_position=(0.0, 1.8, -3.2), has_skybox=True)
    sky = W.load_skybox_image("assets/scenes/BreakTimeSky.npy")
    scene = World.from_path("assets/scenes/BreakTime.glb").to_torch(device, sky)
    n = 1 << 20
    y, x = np.mgrid[0 : config.height, 0 : config.width]
    px = torch.from_numpy(x.reshape(-1)[:n].astype(np.int32)).to(device).repeat(FOLD)
    py = torch.from_numpy(y.reshape(-1)[:n].astype(np.int32)).to(device).repeat(FOLD)
    off = pixel_offsets(config.width, config.height, use_blue_noise=False)[:n].view(np.int32)
    off = torch.from_numpy(off.copy()).to(device).repeat(FOLD)
    cfg = config.static_part()
    kw = dict(has_glass=scene.has_glass, n_alias=scene.n_alias_entries)
    st, feats_t, sidx, params = P.initk(cfg, config.dynamic_part(device), px, py, 0, off, FOLD)
    pending = inv = rays = None
    cases = {"K9": [], "K10": [], "K11": []}
    for bounce in range(cfg.max_bounces):
        rays = feats_t if rays is None else rays
        if bounce == 0:
            cases["K9"].append(("bounce 0", rays, None))
        elif bounce == 1:
            cases["K10"].append(("bounce 1", rays, pending))
        t, i, occ = P._scan(rays, pending, scene, "grid")
        t, i, occ, attrs_t = P.ks_resolve(scene, feats_t, t, i, occ, inv)
        st, nf, sf = SK.shade_bounce(cfg, bounce, params, scene.entry_rows, st, feats_t, t, i,
                                     attrs_t, occ, sidx, off, **kw)
        rays, pending, inv = P.ks_sort(scene, st, nf, sf)
        feats_t = nf if nf is not None else feats_t
    cases["K11"].append(("the last shadow rays", None, pending))
    return scene, cases


# the ray sets that a list-form scan's lists are built for (maxt flags)
LIST_FLAGS = {"K5": (False,), "K6": (False, True), "K7": (True,)}


def scans(specs) -> int:
    device = torch.device("cuda", 0)
    card = card_line()
    dirs = dict(spec.split("=", 1) for spec in specs)
    # a variant directory may hold some of the scans only
    jobs = [(label, name) for label in dirs for name in SCAN_SOURCES
            if os.path.exists(os.path.join(dirs[label], f"{name}.cu"))]
    with ThreadPoolExecutor(12) as pool:  # one nvcc per source
        built = pool.map(lambda job: _build.compile_source(
            os.path.join(dirs[job[0]], f"{job[1]}.cu")), jobs)
        libs = dict(zip(jobs, built))
    for (label, name), lib in libs.items():
        with open(lib[: -len(".so")] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"{label} {name}: {line.strip()}")
    failed = False
    for trace in (darkcornell_cases, veachmis_cases, breaktime_cases):
        scene, cases = trace(device)
        torch.cuda.synchronize()
        for key, ops in cases.items():
            source = SCANS[key][0]
            versions = [(label, libs[(label, source)]) for label in dirs
                        if (label, source) in libs]  # (name, build)
            for what, f, s in ops:
                lists = None
                if key in LIST_FORM:
                    lists = FI.block_tile_lists(scene.tile_aabbs, FI.BT_MULTI, LIST_FLAGS[key],
                                                *[x for x in (f, s) if x is not None])

                def run(version, outs=None, f=f, s=s, lists=lists):
                    return run_scan(version[1], key, scene, f, s, outs, lists)

                outs = {v[0]: run(v) for v in versions}
                torch.cuda.synchronize()
                base = versions[0][0]
                b = (f if f is not None else s).shape[1]
                for name, *_ in versions:
                    diff = [int((~((x == y) | (x.isnan() & y.isnan()))).sum())
                            for x, y in zip(outs[name], outs[base])]
                    failed |= any(diff)
                    print(f"{key} {what} at {b} lanes, {name}: ({', '.join(SCANS[key][3])}) "
                          f"{'equal' if not any(diff) else 'DIFFER from'} {base}'s on every "
                          f"lane" + (f" (lanes differing: {diff})" if any(diff) else ""))
                times = {v[0]: [] for v in versions}
                for v in versions:  # warm
                    run(v, outs[v[0]])
                torch.cuda.synchronize()
                for _ in range(10):  # in turns
                    for v in versions:
                        times[v[0]].append(time_ms(lambda v=v: run(v, outs[v[0]])))
                print(f"{key} {what}: " + ", ".join(
                    f"{name} {statistics.median(ts):.3f} ms (min {min(ts):.3f})"
                    for name, ts in times.items()) + f" ({card})")
                del outs, lists
        del scene, cases
        torch.cuda.empty_cache()
    print("every version equals the first bit for bit" if not failed else
          "a version DIFFERS from the first")
    return int(failed)


# ---- dots ------------------------------------------------------------------------


def dot_cases(device):
    """[(name, entry point, (F, G), ints after the pointers)] of every K18
    and K19 case the probes time, at B = 2^20 rays."""
    from rustic_tpu_torch import probe_dot_floor as PF
    from rustic_tpu_torch.ops import probe_dot as PD

    b = PF.RAYS
    cases, ops = [], {}
    for name, variant, k, n, reps, m, acc_min in PF.CASES:
        key = (PD._OPERAND[variant], k, n * reps)  # the same draws for each operand type
        if key not in ops:
            ops[key] = PF.operands(variant, k, b, n * reps, device)
        cases.append((name, "rt_dot_min", ops[key],
                      (b, k, n, reps, m, int(acc_min), PD.VARIANTS.index(variant))))
    n, reps = 1024, 8
    f32, g32 = PF.operands("fp32", PD.SPLIT_K, b, n * reps, device)
    f96, g96 = PD.cat6_f(f32), PD.cat6_g(g32)
    f48, g48 = f96[:48].contiguous(), g96[:48].contiguous()
    for variant in ("bf16", "bf16w"):  # the wrappers' default blocks
        code, m = PD.VARIANTS.index(variant), 512
        cases += [
            (f"K19 {variant} k96 presplit", "rt_dot_min", (f96, g96),
             (b, 96, n, reps, min(m, PD.max_block_rays(variant, 96)), 1, code)),
            (f"K19 {variant} k96 in-kernel F split", "rt_dot_min_split", (f32, g96),
             (b, n, reps, m, int(variant == "bf16w"))),
            (f"K19 {variant} k48 (x3)", "rt_dot_min", (f48, g48),
             (b, 48, n, reps, min(m, PD.max_block_rays(variant, 48)), 1, code)),
        ]
    return cases


def dots(specs) -> int:
    from rustic_tpu_torch.ops import probe_dot as PD

    int8, int8w = PD.VARIANTS.index("int8"), PD.VARIANTS.index("int8w")
    device = torch.device("cuda", 0)
    card = card_line()
    dirs = dict(spec.split("=", 1) for spec in specs)
    with ThreadPoolExecutor(len(dirs)) as pool:  # one nvcc per version
        libs = dict(zip(dirs, pool.map(lambda label: _build.compile_source(
            os.path.join(dirs[label], "probe_dot.cu"), _build.EXTRA_FLAGS["probe_dot"]), dirs)))
    for label, lib in libs.items():
        kernel = None
        with open(lib[: -len(".so")] + ".log") as f:
            for line in f:
                m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", line)
                if m:
                    kernel = m.group(1)
                elif re.search(r"\(C75\d\d\)", line):  # the compiler's wgmma notes name their kernel
                    print(f"{label}: {line.strip()}")
                elif "Used" in line and "registers" in line or "spill" in line:
                    print(f"{label}: {kernel}: {line.strip()}")
        for name, body in sass_by_kernel(lib).items():
            if "min_rate" in name or ("wgmma_dot_min" in name and "Int8" in name):
                print(f"{label}: {name}: min instructions in its SASS {min_opcodes(body)}")
    entries = {(label, fn): _build.load_entry(lib, fn, 4, n_ints)
               for label, lib in libs.items()
               for fn, n_ints in (("rt_dot_min", 7), ("rt_dot_min_split", 5))}
    scratch = torch.empty(8 << 20, dtype=torch.uint8, device=device)  # wgmma's G, K <= 128
    stream = torch.cuda.current_stream(device).cuda_stream
    failed = False
    int8_outs = {}  # (K, N, reps) -> the first version's int8 mma.sync output
    for name, fn, (f, g), ints in dot_cases(device):
        out_dtype = torch.int32 if f.dtype == torch.int8 else torch.float32
        outs = {}
        for label in dirs:
            out = torch.empty(f.shape[1], dtype=out_dtype, device=device)
            rc = entries[label, fn](f.data_ptr(), g.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr(), *ints, stream)
            if rc == 0:
                outs[label] = out
            else:
                print(f"{name}: {label} refuses it (cudaError {rc}): skipped")
        torch.cuda.synchronize()
        if not outs:
            continue
        base = next(iter(outs))
        for label, out in outs.items():
            same = out.view(torch.int32) == outs[base].view(torch.int32)
            diff = int((~same).sum())
            failed |= diff > 0
            print(f"{name}, {label}: {'equal to' if not diff else 'DIFFERS from'} {base}'s on "
                  f"every ray" + (f" ({diff} rays differ, max |d| "
                                  f"{float((out.double() - outs[base].double()).abs().max()):.3g})"
                                  if diff else ""))
        runs = {label: (label, ints) for label in outs}  # what is timed: (version, ints)
        shape = ints[1:4]  # K, N, reps of an rt_dot_min case
        if fn == "rt_dot_min" and ints[6] == int8:
            int8_outs[shape] = outs[base]
        elif fn == "rt_dot_min" and ints[6] == int8w and shape in int8_outs:
            for label, out in outs.items():
                diff = int((out != int8_outs[shape]).sum())
                failed |= diff > 0
                print(f"{name}, {label}: {'equal to' if not diff else 'DIFFERS from'} the int8 "
                      f"mma.sync case's output" + (f" ({diff} rays differ)" if diff else ""))
            # and timed in turns with every version's int8 mma.sync kernel at its widest block
            m8 = PD.max_block_rays("int8", shape[0])
            for label in dirs:
                runs[f"{label} int8 mma.sync m{m8}"] = (label, ints[:4] + (m8, 1, int8))
                outs[f"{label} int8 mma.sync m{m8}"] = torch.empty_like(outs[base])

        def run(key, fn=fn, f=f, g=g):
            label, args = runs[key]
            entries[label, fn](f.data_ptr(), g.data_ptr(), outs[key].data_ptr(),
                               scratch.data_ptr(), *args, stream)

        times = {key: [] for key in runs}
        for _ in range(10):  # in turns
            for key in runs:
                times[key].append(time_ms(lambda key=key: run(key)))
        print(f"{name}: " + ", ".join(
            f"{label} {statistics.median(ts):.3f} ms (min {min(ts):.3f})"
            for label, ts in times.items()) + f" ({card})")
        del outs
    print("every version equals the first bit for bit" if not failed else
          "a version DIFFERS from the first")
    return int(failed)


# ---- bvh -------------------------------------------------------------------------


def bvh_abi(lib: str) -> int:
    """The build's `rt_bvh_abi`: 2 where K20 reads the packed node and
    triangle records and a ray counter, 1 for a build without it (the
    struct of arrays and the shading rows, one thread a ray)."""
    try:
        fn = ctypes.CDLL(lib).rt_bvh_abi
    except AttributeError:
        return 1
    fn.restype = ctypes.c_int
    return fn()


def run_bvh(lib, scene, ops, outs=None):
    """Launch K20n (ops = (ro, rd)) or K20a (ops = (ro, rd, max_t)) of
    build `lib` -> its outputs: (t, idx, hit, backface, u, v) or (hit,).
    ABI 2 zeroes its ray counter in the launch, as the wrapper does."""
    nearest = len(ops) == 2
    b, dev = ops[0].shape[0], ops[0].device
    if outs is None:
        outs = ((torch.empty(b, dtype=torch.float32, device=dev),
                 torch.empty(b, dtype=torch.int32, device=dev),
                 torch.empty(b, dtype=torch.bool, device=dev),
                 torch.empty(b, dtype=torch.bool, device=dev),
                 torch.empty(b, dtype=torch.float32, device=dev),
                 torch.empty(b, dtype=torch.float32, device=dev)) if nearest
                else (torch.empty(b, dtype=torch.bool, device=dev),))
    if bvh_abi(lib) >= 2:
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        tables = (scene.bvh_nodes, scene.bvh_tris, counter)
        ints = (b, scene.bvh_node_base, scene.bvh_count_bits, scene.n_tris)
    else:
        tables = (scene.bvh_min, scene.bvh_max, scene.bvh_left_first, scene.bvh_count,
                  scene.tri_attrs)
        ints = (b, scene.tri_attrs.shape[1], scene.n_tris)
    ptrs = (*ops, *tables, *outs)
    fn = "rt_bvh_nearest" if nearest else "rt_bvh_occluded"
    _build.launch(_build.load_entry(lib, fn, len(ptrs), len(ints)), fn, dev, ptrs, ints)
    return outs


def ks_bounce1_rows(scene, config, n_px, device):
    """The sorted bounce-1 ray rows [16, B] and the bounce-0 shadow rows or
    None of one fold group of the frame's first n_px pixels traced through
    bounce 0 of the kernel-shade loop in the grid form (the operands of
    chip_smoke.py's phase 31)."""
    h, w = config.height, config.width
    y, x = np.mgrid[0:h, 0:w]
    px = torch.from_numpy(x.reshape(-1)[:n_px].astype(np.int32)).to(device).repeat(FOLD)
    py = torch.from_numpy(y.reshape(-1)[:n_px].astype(np.int32)).to(device).repeat(FOLD)
    off = pixel_offsets(w, h, use_blue_noise=False)[:n_px].view(np.int32)
    off = torch.from_numpy(off.copy()).to(device).repeat(FOLD)
    cfg, cam = config.static_part(), config.dynamic_part(device)
    n_alias = scene.n_alias_entries if cfg.nee.uses_nee and scene.has_lights else 0
    shade = SK.shade_bounce_wide if n_alias > P.ENTRY_SELECT_MAX else SK.shade_bounce
    st, feats_t, sidx, params = P.initk(cfg, cam, px, py, 0, off, FOLD)
    t, i, occ = P._scan(feats_t, None, scene, "grid")
    t, i, occ, attrs_t = P.ks_resolve(scene, feats_t, t, i, occ, None)
    st, nf, sf = shade(cfg, 0, params, scene.entry_rows, st, feats_t, t, i, attrs_t, occ, sidx,
                       off, has_glass=scene.has_glass, n_alias=n_alias)
    f1, s1, _ = P.ks_sort(scene, st, nf, sf)
    return f1, s1


def bvh_cases(device):
    """[(scene name, scene, [(what, operands)])]: phase 31's sorted
    operands (4,194,304 lanes) of VeachMIS, BreakTime and PBRTest, then the
    oracle's: the rays of bounces 0-3 of its first trace_paths call on
    VeachMIS at 1024^2 and on BreakTime's first pixel chunk (1,048,576
    lanes a launch, pixel order)."""
    from rustic_tpu_torch import make_reference_films as MR

    sky = W.load_skybox_image("assets/scenes/BreakTimeSky.npy")
    scenes = {
        "VeachMIS": (World.from_path("assets/scenes/VeachMIS.glb").to_torch(device),
                     TracingConfig(width=1024, height=1024, nee=NextEventEstimation.MIS,
                                   **VEACH_CAM)),
        "BreakTime": (World.from_path("assets/scenes/BreakTime.glb").to_torch(device, sky),
                      TracingConfig(width=1920, height=1080, nee=NextEventEstimation.MIS,
                                    **MR.BREAK_CAM)),
        "PBRTest": (World.from_path("assets/scenes/PBRTest.glb").to_torch(device),
                    TracingConfig(width=1024, height=1024, nee=NextEventEstimation.MIS)),
    }
    out = []
    for name, (scene, config) in scenes.items():
        f1, s1 = ks_bounce1_rows(scene, config, 1 << 20, device)
        ops = [("K20n sorted bounce-1 rays", (f1[6:9].T.contiguous(), f1[0:3].T.contiguous()))]
        if s1 is not None:
            ops.append(("K20a bounce-0 shadow rays", (
                s1[6:9].T.contiguous(), s1[0:3].T.contiguous(), s1[FI.SH_MAXT_COL].contiguous())))
        out.append((name, scene, ops))
    for name in ("VeachMIS", "BreakTime"):
        scene, config = scenes[name]
        ops = [(f"oracle {what}", rays) for what, rays in MR.k20_operands(
            scene, config, MR.PX_CHUNK)]
        out.append((name, scene, ops))
    torch.cuda.synchronize()
    return out


def bvh(specs) -> int:
    device = torch.device("cuda", 0)
    card = card_line()
    dirs = dict(spec.split("=", 1) for spec in specs)
    with ThreadPoolExecutor(len(dirs)) as pool:  # one nvcc per version
        libs = dict(zip(dirs, pool.map(lambda label: _build.compile_source(
            os.path.join(dirs[label], "bvh_traverse.cu"), _build.EXTRA_FLAGS["bvh_traverse"]),
            dirs)))
    for label, lib in libs.items():
        with open(lib[: -len(".so")] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"{label}: {line.strip()}")
        if bvh_abi(lib) >= 2:
            fn = ctypes.CDLL(lib).rt_bvh_blocks_per_sm
            fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
            print(f"{label}: blocks of 128 threads an SM holds: K20n {fn(1)}, K20a {fn(0)}")
    failed = False
    for name, scene, ops in bvh_cases(device):
        for what, rays in ops:
            outs = {label: run_bvh(lib, scene, rays) for label, lib in libs.items()}
            torch.cuda.synchronize()
            base = next(iter(outs))
            b = rays[0].shape[0]
            for label, got in outs.items():
                diff = [int((x.view(torch.int32) != y.view(torch.int32)).sum())
                        if x.is_floating_point() else int((x != y).sum())
                        for x, y in zip(got, outs[base])]
                failed |= any(diff)
                print(f"{name} {what} at {b} lanes, {label}: "
                      f"{'equal to' if not any(diff) else 'DIFFERS from'} {base}'s on every lane"
                      + (f" (lanes differing, by output: {diff})" if any(diff) else ""))
            times = {label: [] for label in libs}
            for _ in range(10):  # in turns
                for label, lib in libs.items():
                    times[label].append(time_ms(
                        lambda lib=lib, label=label: run_bvh(lib, scene, rays, outs[label])))
            print(f"{name} {what}: " + ", ".join(
                f"{label} {statistics.median(ts):.3f} ms (min {min(ts):.3f})"
                for label, ts in times.items()) + f" ({card})")
            del outs
    print("every version equals the first bit for bit" if not failed else
          "a version DIFFERS from the first")
    return int(failed)


def main(argv) -> int:
    if not argv or argv[0] not in ("contraction", "shade", "scans", "fused", "dots", "bvh"):
        print(__doc__)
        return 2
    print(card_line())
    if argv[0] == "contraction":
        return contraction([_build.CSRC] + argv[1:])
    if argv[0] == "scans":
        return scans(argv[1:])
    if argv[0] == "fused":
        return fused(argv[1:])
    if argv[0] == "dots":
        return dots(argv[1:])
    if argv[0] == "bvh":
        return bvh(argv[1:])
    return shade(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
