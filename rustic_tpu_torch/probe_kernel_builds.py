"""Two questions about how the kernels are built, asked on one CUDA device.

    python -m rustic_tpu_torch.probe_kernel_builds contraction [DIR ...]
    python -m rustic_tpu_torch.probe_kernel_builds shade LABEL=SOURCE.cu [LABEL=SOURCE.cu ...]

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

Both print the card's name and power limit first.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import statistics
import subprocess
import sys
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
    t, i, a = FI.nearest_attrs(feats, g16, attrs)
    st, feats, pending = SK.shade_bounce(cfg, 0, params, scene.entry_rows, st, feats, t, i, a,
                                         None, sidx, off, **kw)
    t, i, occ, a = FI.nearest_shadow_attrs(feats, pending, g16, attrs)
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


def contraction(dirs) -> int:
    device = torch.device("cuda", 0)
    scene, (feats, pending), _ = darkcornell_bounce1(device)
    g16, attrs = scene.tri_feats16, scene.tri_attrs
    b, tt = feats.shape[1], FI.geometry(g16)[1]
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
                t = torch.empty(b, dtype=torch.float32, device=device)
                idx = torch.empty(b, dtype=torch.int32, device=device)
                occ = torch.empty(b, dtype=torch.int32, device=device)
                rows = torch.empty((W.SLIM_WIDTH, b), dtype=torch.float32, device=device)
                _build.launch(_build.load_entry(lib, "rt_nearest_shadow_attrs", 8, 3), "K2", device,
                              (feats, pending, g16, attrs, t, idx, occ, rows),
                              (b, tt, W.SLIM_WIDTH))
                torch.cuda.synchronize()
                got = (t, idx, occ, rows)
                if first is None:
                    first = got
                same = all(torch.equal(x, y) for x, y in zip(got, first))
                print(f"{d} {name} {' '.join(flag) or '(contraction on)'}: K2 on {b} lanes "
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


def main(argv) -> int:
    if not argv or argv[0] not in ("contraction", "shade"):
        print(__doc__)
        return 2
    print(card_line())
    if argv[0] == "contraction":
        return contraction([_build.CSRC] + argv[1:])
    return shade(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
