#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: the headline render
(DarkCornell, one triangle tile, kernels K1-K4) and the multi-tile render
(VeachMIS, six tiles, kernels K5-K7 and the torch shading stages).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which must pass:
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
     of 10 CUDA-event timings, taken in turns.
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
     65,536, 65,613 and 4,194,304 lanes: index and occlusion equal on
     >= 99.99% of rays, t within rtol 1e-5.
  7. multi-time: K5-K7 and their plain versions at 4,194,304 lanes, in
     turns, as phase 3 (the lists are built before the timed launches).
  8. multi-render: VeachMIS 1024x1024, NEE+MIS, 4 bounces, 64 spp through
     render_image after a one-group warm-up; Mpaths/s; launch counts K5 1,
     K6 63, K7 1 and none of K1-K4; a finite film.
  9. multi-film: VeachMIS 256x144 x 1024 spp against the committed
     reference film (assets/reference/veachmis_256x144_1024spp.npy):
     relative energy within 1%, RMSE under the bound of
     tests/test_reference_films.py.
 10. multi-cross-device: VeachMIS 64x64x4, card against host CPU, rtol 1e-4,
     atol 1e-5.

The last two lines of standard output are a JSON object describing each
kernel and then {"ok": true, "device": {...}}; neither is printed when a
phase fails or no CUDA device exists, and the exit code is then 1.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
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
MT_LANES = MT_SIZE * MT_SIZE * FOLD  # 4,194,304
MT_REF = "assets/reference/veachmis_256x144_1024spp.npy"
MT_REF_SPP = 1024
MT_REF_RMSE_TPU = 1.55e-4  # QUALITY_r5.json, the TPU build at 256x144x1024 spp

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
}
SINGLE_TILE = ("K1", "K2", "K3", "K4")
MULTI_TILE = ("K5", "K6", "K7")


def log(*a):
    print(*a, flush=True)


class Smoke:
    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda", 0)
        self.failures = []
        self.results = {k: dict(route="cuda", **v) for k, v in KERNELS.items()}

    # ---- helpers ---------------------------------------------------------------

    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.time()
        try:
            fn()
        except Exception:  # a failed phase is recorded; later phases still run
            traceback.print_exc(file=sys.stdout)
            self.failures.append(name)
            log(f"== {name}: FAILED")
        log(f"== {name}: {time.time() - t0:.1f} s")

    def fail(self, msg):
        raise AssertionError(msg)

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
        g16, attrs = self.scene.tri_feats16, self.scene.tri_attrs
        self.bounces = []
        pending = None
        for b in range(cfg.max_bounces):
            if pending is None:
                t, i, a = FI.nearest_attrs(feats, g16, attrs)
                occ = None
            else:
                t, i, occ, a = FI.nearest_shadow_attrs(feats, pending, g16, attrs)
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

    def check_scans(self):
        from rustic_tpu_torch.ops import flash_intersect as FI

        g16, attrs = self.scene.tri_feats16, self.scene.tri_attrs
        b0, b1 = self.bounces[0], self.bounces[1]
        for n in (CHECK_LANES, CHECK_LANES + RAGGED, MAIN_LANES):
            errs = {}
            f0 = b0["feats"][:, :n].contiguous()
            f1 = b1["feats"][:, :n].contiguous()
            s1 = b1["pending"][:, :n].contiguous()
            s3 = self.bounces[-1]["shadow_out"][:, :n].contiguous()

            frac, e = self._cmp_nearest(
                "K1", *FI.nearest_attrs(f0, g16, attrs), *FI.nearest_attrs_plain(f0, g16, attrs)
            )
            errs["K1"] = e
            log(f"K1 n={n}: idx agree {frac:.6f}, max |dt| {e:.3g}")

            t_k, i_k, o_k, a_k = FI.nearest_shadow_attrs(f1, s1, g16, attrs)
            t_p, i_p, o_p, a_p = FI.nearest_shadow_attrs_plain(f1, s1, g16, attrs)
            frac, e = self._cmp_nearest("K2", t_k, i_k, a_k, t_p, i_p, a_p)
            occ_agree, _ = self._cmp_occ("K2", o_k, o_p)
            errs["K2"] = e
            log(f"K2 n={n}: idx agree {frac:.6f}, occ agree {occ_agree:.6f}, "
                f"occluded {float(o_k.float().mean()):.4f}, max |dt| {e:.3g}")
            del t_k, i_k, o_k, a_k, t_p, i_p, o_p, a_p

            occ_agree, e = self._cmp_occ("K3", FI.occlude(s3, g16), FI.occlude_plain(s3, g16))
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

        g16, attrs = self.scene.tri_feats16, self.scene.tri_attrs
        b0, b1 = self.bounces[0], self.bounces[1]
        sh = self.bounces[-1]["shadow_out"]
        cfg = self.config.static_part()
        shade_args = (cfg, 1, self.params, self.scene.entry_rows, b1["st"], b1["feats"], b1["t"],
                      b1["idx"], b1["attrs"], b1["occ"], self.sidx, self.off)
        kw = dict(has_glass=self.scene.has_glass, n_alias=self.n_alias)
        cases = {
            "K1": (lambda: FI.nearest_attrs(b0["feats"], g16, attrs),
                   lambda: FI.nearest_attrs_plain(b0["feats"], g16, attrs)),
            "K2": (lambda: FI.nearest_shadow_attrs(b1["feats"], b1["pending"], g16, attrs),
                   lambda: FI.nearest_shadow_attrs_plain(b1["feats"], b1["pending"], g16, attrs)),
            "K3": (lambda: FI.occlude(sh, g16), lambda: FI.occlude_plain(sh, g16)),
            "K4": (lambda: SK.shade_bounce(*shade_args, **kw),
                   lambda: SK.shade_bounce_plain(*shade_args, **kw)),
        }
        import statistics

        for key, (kern, plain) in cases.items():
            kern(), plain()  # warm
            self.torch.cuda.synchronize()
            tk, tp = [], []
            for _ in range(10):  # in turns: kernel, plain
                tk += self.time_ms(kern, reps=1)
                tp += self.time_ms(plain, reps=1)
            self.results[key]["ms"] = statistics.median(tk)
            self.results[key]["plain_ms"] = statistics.median(tp)
            log(f"{key} at {MAIN_LANES} lanes: kernel {statistics.median(tk):.3f} ms "
                f"(min {min(tk):.3f}), plain {statistics.median(tp):.3f} ms (min {min(tp):.3f})")
        self.bounces = None  # free the traced group
        self.torch.cuda.empty_cache()

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
        expect |= {KERNELS[k]["name"]: 0 for k in MULTI_TILE}
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

    def mt_inputs(self):
        """One real fold group of the VeachMIS render traced through all
        four bounces by the kernels and the stage functions: the ray rows
        each scan sees."""
        import numpy as np
        import torch

        from rustic_tpu_torch.config import NextEventEstimation, TracingConfig
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.runtime import pipeline as P
        from rustic_tpu_torch.runtime.render import pixel_offsets
        from rustic_tpu_torch.scene.world import World

        self.mt_scene = World.from_path(VEACH).to_torch(self.dev)
        self.mt_config = TracingConfig(
            width=MT_SIZE, height=MT_SIZE, nee=NextEventEstimation.MIS, **VEACH_CAM
        )
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

    def _mt_cases(self, n):
        """(key, kernel call, plain call) of K5-K7 on the first n lanes,
        with their admitted-tile lists built once for both."""
        from rustic_tpu_torch.ops import flash_intersect as FI

        scene = self.mt_scene
        g16, aabbs = scene.tri_feats16, scene.tile_aabbs
        b0, b1, b3 = self.mt_bounces[0], self.mt_bounces[1], self.mt_bounces[-1]
        f0 = b0["feats"][:, :n].contiguous()
        f1 = b1["feats"][:, :n].contiguous()
        s1 = b1["pending"][:, :n].contiguous()
        s3 = b3["shadow_out"][:, :n].contiguous()
        l0 = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False,), f0)
        l1 = FI.block_tile_lists(aabbs, FI.BT_MULTI, (False, True), f1, s1)
        l3 = FI.block_tile_lists(aabbs, FI.BT_MULTI, (True,), s3)
        admitted = {k: float(l[1].float().mean()) for k, l in (("K5", l0), ("K6", l1), ("K7", l3))}
        return admitted, {
            "K5": (lambda: FI.nearest_multi(f0, g16, *l0),
                   lambda: FI.nearest_multi_plain(f0, g16, *l0)),
            "K6": (lambda: FI.nearest_shadow_multi(f1, s1, g16, *l1),
                   lambda: FI.nearest_shadow_multi_plain(f1, s1, g16, *l1)),
            "K7": (lambda: FI.occlude_multi(s3, g16, *l3),
                   lambda: FI.occlude_multi_plain(s3, g16, *l3)),
        }

    def mt_check(self):
        self.mt_inputs()
        for n in (CHECK_LANES, CHECK_LANES + RAGGED, MT_LANES):
            admitted, cases = self._mt_cases(n)
            (t_k, i_k), (t_p, i_p) = (f() for f in cases["K5"])
            frac, e5, _ = self._cmp_winner("K5", t_k, i_k, t_p, i_p)
            log(f"K5 n={n}: idx agree {frac:.6f}, max |dt| {e5:.3g}, "
                f"admitted tiles per block {admitted['K5']:.3f} of 6")
            (t_k, i_k, o_k), (t_p, i_p, o_p) = (f() for f in cases["K6"])
            frac, e6, _ = self._cmp_winner("K6", t_k, i_k, t_p, i_p)
            occ_agree, _ = self._cmp_occ("K6", o_k, o_p)
            log(f"K6 n={n}: idx agree {frac:.6f}, occ agree {occ_agree:.6f}, "
                f"occluded {float(o_k.float().mean()):.4f}, max |dt| {e6:.3g}, "
                f"admitted tiles per block {admitted['K6']:.3f}")
            del t_k, i_k, o_k, t_p, i_p, o_p
            o_k, o_p = (f() for f in cases["K7"])
            occ_agree, e7 = self._cmp_occ("K7", o_k, o_p)
            log(f"K7 n={n}: occ agree {occ_agree:.6f}, occluded {float(o_k.float().mean()):.4f}, "
                f"admitted tiles per block {admitted['K7']:.3f}")
        # the kernels line reports the comparison at the main path's shape
        for k, e in (("K5", e5), ("K6", e6), ("K7", e7)):
            self.results[k]["max_abs_err"] = e

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
        _, cases = self._mt_cases(MT_LANES)
        for key, (kern, plain) in cases.items():
            kern(), plain()  # warm
            self.torch.cuda.synchronize()
            tk, tp = [], []
            for _ in range(10):  # in turns: kernel, plain
                tk += self.time_ms(kern, reps=1)
                tp += self.time_ms(plain, reps=1)
            self.results[key]["ms"] = statistics.median(tk)
            self.results[key]["plain_ms"] = statistics.median(tp)
            log(f"{key} at {MT_LANES} lanes: kernel {statistics.median(tk):.3f} ms "
                f"(min {min(tk):.3f}), plain {statistics.median(tp):.3f} ms (min {min(tp):.3f})")
        self.mt_bounces = None  # free the traced group
        self.torch.cuda.empty_cache()

    def mt_render(self):
        import numpy as np
        import torch

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.ops import flash_intersect as FI
        from rustic_tpu_torch.ops import shade_kernel as SK
        from rustic_tpu_torch.runtime.render import render_image

        t0 = time.time()
        render_image(self.mt_scene, self.mt_config, RenderSettings(samples=FOLD), device=self.dev)
        log(f"warm-up render ({FOLD} spp): {time.time() - t0:.2f} s")

        FI.reset_launch_counts()
        SK.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        film = render_image(
            self.mt_scene, self.mt_config, RenderSettings(samples=MT_SPP), device=self.dev
        )
        render_s = time.time() - t0
        counts = {**FI.LAUNCHES, **SK.LAUNCHES}
        mpaths = MT_SIZE * MT_SIZE * MT_SPP / render_s / 1e6
        log(f"render VeachMIS {MT_SIZE}x{MT_SIZE}x{MT_SPP} spp NEE+MIS: {render_s:.3f} s, "
            f"{mpaths:.2f} Mpaths/s ({self.card})")
        log(f"launch counts: {counts}")
        groups = MT_SPP // FOLD
        expect = dict.fromkeys(counts, 0) | {
            "nearest_multi": 1,
            "nearest_shadow_multi": self.mt_config.max_bounces * groups - 1,
            "occlude_multi": 1,
        }
        for key in MULTI_TILE:
            self.results[key]["launches"] = counts[KERNELS[key]["name"]]
        if counts != expect:
            self.fail(f"launch counts {counts} != expected {expect}")
        log(f"film mean {float(film.mean()):.6f}")
        if not np.isfinite(film).all() or film.shape != (MT_SIZE, MT_SIZE, 3):
            self.fail("film is not finite or has the wrong shape")

    def mt_film(self):
        import numpy as np

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.runtime.render import render_image

        ref = np.load(MT_REF)
        h, w = ref.shape[:2]
        config = dataclasses.replace(self.mt_config, width=w, height=h)
        t0 = time.time()
        film = render_image(self.mt_scene, config, RenderSettings(samples=MT_REF_SPP),
                            device=self.dev)
        wall = time.time() - t0
        rel_energy = abs(float(film.mean()) - float(ref.mean())) / max(float(ref.mean()), 1e-9)
        rmse = float(np.sqrt(np.mean((film - ref) ** 2)))
        bound = 0.35 * max(float(ref.mean()), 0.05) + 0.05  # tests/test_reference_films.py:84
        log(f"VeachMIS {w}x{h}x{MT_REF_SPP} spp: {wall:.2f} s, film mean {film.mean():.6f} "
            f"vs reference {ref.mean():.6f} (relative energy {rel_energy:.6f}), "
            f"RMSE {rmse:.6g} (bound {bound:.4g}; TPU build {MT_REF_RMSE_TPU:g}, QUALITY_r5.json)")
        if not np.isfinite(film).all():
            self.fail("film is not finite")
        if rel_energy > 0.01:
            self.fail(f"relative energy {rel_energy} is not within 1%")
        if rmse >= bound:
            self.fail(f"RMSE {rmse} is not under {bound}")

    def mt_cross_device(self):
        import numpy as np

        from rustic_tpu_torch.config import RenderSettings
        from rustic_tpu_torch.runtime.render import render_image

        config = dataclasses.replace(self.mt_config, width=64, height=64)
        settings = RenderSettings(samples=4)
        gpu = render_image(self.mt_scene, config, settings, device=self.dev)
        cpu = render_image(self.mt_scene.to("cpu"), config, settings, device="cpu")
        bad = ~np.isclose(gpu, cpu, rtol=1e-4, atol=1e-5)
        log(f"VeachMIS 64x64x4 film, card vs host CPU: max |d| {np.abs(gpu - cpu).max():.3g}, "
            f"{int(bad.sum())} entries outside rtol 1e-4 / atol 1e-5, mean {gpu.mean():.6f}")
        if bad.any():
            px = np.argwhere(bad.any(axis=-1))[:5].tolist()
            self.fail(f"card and host films differ at pixels {px}")

    # ---- phases ----------------------------------------------------------------------------

    def run(self) -> int:
        self.phase("device", self.device)
        if self.failures:
            return 1
        self.phase("check", self.check)
        if "check" not in self.failures:
            self.phase("time", self.timing)
            self.phase("render", self.render)
            self.phase("cross-device", self.cross_device)
        self.scene = None
        self.phase("multi-check", self.mt_check)
        if "multi-check" not in self.failures:
            self.phase("multi-time", self.mt_timing)
            self.phase("multi-render", self.mt_render)
            self.phase("multi-film", self.mt_film)
            self.phase("multi-cross-device", self.mt_cross_device)
        if self.failures:
            log(f"FAILED phases: {self.failures}")
            return 1
        torch = self.torch
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
    return Smoke().run()


if __name__ == "__main__":
    sys.exit(main())
