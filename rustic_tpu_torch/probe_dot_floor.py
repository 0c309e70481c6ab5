"""How fast the flash scans' dot shape can go on each arithmetic unit of
one CUDA device, and whether a low-precision pass can carry an f32 dot.

    python -m rustic_tpu_torch.probe_dot_floor [--quick] [--accuracy-only]

The counterpart of tools/mxu_floor.py and tools/probe_k96.py. The scans
(K1-K17) test a ray against a triangle with four 10-term dots on FP32
FMAs. `dot_min` (K18) and `dot_min_split` (K19, ops/probe_dot.py) do the
same shape of work, rays [K, B] against columns [K, N*reps] reduced by a
min per ray, on FP32 FMAs and on the tensor cores (`mma.sync`: TF32
m16n8k8, BF16 m16n8k16, int8 m16n8k32; `wgmma.mma_async`: BF16
m64n128k16, TF32 m64n128k8 and int8 m64n128k32, the cases named "bf16w",
"tf32w" and "int8w"), so their rates say what a pair test on each unit
could reach and what depth K costs there.

First `min_rates`: the card's rate of the fold's instructions (FMNMX,
IMNMX and the DPX min of three, `rt_min_rate` of csrc/probe_dot.cu), in G
results/s and per clock per SM at the SM clock the run read, beside the
64 a clock an SM that the fold's bound counts (`FOLD_PER_S`).

Cases, at B = 2^20 rays (the sweep of mxu_floor.main): K from 8 to 128 at
N = 1024; N from 128 to 2048; 256, 512 and 1024 rays a block (the TPU
kernels' blocks of 2048 and 4096 rays have no counterpart: a block holds
at most 1024 rays, 512 at K > 48); the min left out (`nored`); int8. The
f32 operand cases are "fp32" (FP32 FMAs: full precision, the TPU's
HIGHEST) and "tf32" (one tensor-core pass on f32 operands: the TPU's
lower precisions). An `mma` accumulates in f32 (or f16), so the TPU
probe's two bf16-output cases have no counterpart. Then probe_k96's
cases: the six-term split dot at K = 96, F pre-split or split in the
kernel, and the three-term dot at K = 48, beside one BF16 pass at K = 16.

Prints the card's name and power limit, then per case the time (the
median of 5 CUDA-event timings), outputs/s, TMAC/s over the case's own K
(zero padding to the instruction's depth is not counted) and the share
of the unit's published peak (67 TFLOP/s FP32, 495 TF32, 989 BF16, 1,979
TOP/s int8). Then `accuracy`: each unit's dot against float64 on
DarkCornell's triangle table and 4,096 rays from
`np.random.default_rng(0)`, the error scaled by |F|^T |G| (the summed
term magnitudes: Moller-Trumbore features cancel about tenfold). The
`wgmma` kernels take 128 columns at a time and are not in that table;
their split dot equals the `mma.sync` one bit for bit (chip_smoke.py).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import numpy as np
import torch

from rustic_tpu_torch.ops import _build
from rustic_tpu_torch.ops import probe_dot as PD
from rustic_tpu_torch.ops.intersect import _ray_features16
from rustic_tpu_torch.scene.world import World

RAYS = 1 << 20
# operations per second of each unit (NVIDIA H100 SXM datasheet, dense)
PEAK = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12, "bf16w": 989e12,
        "tf32w": 495e12, "int8w": 1979e12}

# name, variant, K, N, reps, rays a block, acc_min
CASES = [
    ("bf16 k16 n1024 m1024", "bf16", 16, 1024, 8, 1024, True),
    ("bf16 k32 n1024 m1024", "bf16", 32, 1024, 8, 1024, True),
    ("bf16 k64 n1024 m512", "bf16", 64, 1024, 8, 512, True),
    ("bf16 k128 n1024 m512", "bf16", 128, 1024, 8, 512, True),
    ("bf16 k8 n1024 m1024", "bf16", 8, 1024, 8, 1024, True),
    ("fp32 k16 n1024 m1024", "fp32", 16, 1024, 8, 1024, True),
    ("tf32 k16 n1024 m1024", "tf32", 16, 1024, 8, 1024, True),
    ("fp32 k8 n1024 m1024", "fp32", 8, 1024, 8, 1024, True),
    ("fp32 k32 n1024 m1024", "fp32", 32, 1024, 8, 1024, True),
    ("tf32 k8 n1024 m1024", "tf32", 8, 1024, 8, 1024, True),
    ("tf32 k32 n1024 m512", "tf32", 32, 1024, 8, 512, True),
    ("bf16 k16 n128 m1024", "bf16", 16, 128, 8, 1024, True),
    ("bf16 k16 n256 m1024", "bf16", 16, 256, 8, 1024, True),
    ("bf16 k16 n512 m1024", "bf16", 16, 512, 8, 1024, True),
    ("bf16 k16 n2048 m1024", "bf16", 16, 2048, 4, 1024, True),
    ("bf16 k16 n1024 m256", "bf16", 16, 1024, 8, 256, True),
    ("bf16 k16 n1024 m512", "bf16", 16, 1024, 8, 512, True),
    ("bf16 k128 n1024 m256", "bf16", 128, 1024, 8, 256, True),
    ("fp32 k16 n1024 m256", "fp32", 16, 1024, 8, 256, True),
    ("bf16 k16 n1024 nored", "bf16", 16, 1024, 8, 1024, False),
    ("fp32 k16 n1024 nored", "fp32", 16, 1024, 8, 1024, False),
    ("int8 k16 n1024 m1024", "int8", 16, 1024, 8, 1024, True),
    ("int8 k32 n1024 m1024", "int8", 32, 1024, 8, 1024, True),
    ("bf16w k16 n1024 m512", "bf16w", 16, 1024, 8, 512, True),
    ("bf16w k32 n1024 m512", "bf16w", 32, 1024, 8, 512, True),
    ("bf16w k64 n1024 m256", "bf16w", 64, 1024, 8, 256, True),
    ("bf16w k128 n1024 m256", "bf16w", 128, 1024, 8, 256, True),
    ("bf16w k16 n128 m512", "bf16w", 16, 128, 8, 512, True),
    ("bf16w k16 n1024 m256", "bf16w", 16, 1024, 8, 256, True),
    ("tf32w k16 n1024 m512", "tf32w", 16, 1024, 8, 512, True),
    ("tf32w k8 n1024 m512", "tf32w", 8, 1024, 8, 512, True),
    ("tf32w k32 n1024 m256", "tf32w", 32, 1024, 8, 256, True),
    ("int8w k16 n1024 m512", "int8w", 16, 1024, 8, 512, True),
    ("int8w k32 n1024 m512", "int8w", 32, 1024, 8, 512, True),
]
QUICK = 7  # --quick: the K sweep in BF16 and the two f32 operand cases


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a"


def operands(variant: str, k: int, b: int, cols: int, device, seed: int = 0):
    """F [k, b] and G [k, cols] in the operand type of `variant`: standard
    normal values (int8: uniform over the type), from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if variant in PD.INT8:
        def draw(n):
            return torch.randint(-128, 128, (k, n), generator=gen, device=device).to(torch.int8)
    else:
        def draw(n):
            x = torch.randn((k, n), generator=gen, device=device, dtype=torch.float32)
            return x.to(torch.bfloat16) if variant in ("bf16", "bf16w") else x
    return draw(b), draw(cols)


# the rate kernels of csrc/probe_dot.cu rt_min_rate: op -> (what, minima a result)
MIN_OPS = {0: ("fminf (FMNMX)", 1), 1: ("int min (IMNMX)", 1), 2: ("__vimin3_s32", 2)}
MR_THREADS, MR_STEP = 1024, 16 * 4  # threads a block; mins a thread per iteration
# The fold's peak, one min an output: FMNMX and IMNMX issue 64 a clock an SM
# on the ALU pipe (cc 9.0), here at the clock PEAK["fp32"] counts (128 FFMA
# lanes a clock an SM, two operations each); on int32 the DPX min of three
# (one VIMNMX3) folds two minima a result at that rate. Minima a second by
# accumulator type.
MIN_PER_CLK_SM = 64
FOLD_PER_S = {"float": PEAK["fp32"] / 256 * MIN_PER_CLK_SM,
              "int": PEAK["fp32"] / 256 * MIN_PER_CLK_SM * MIN_OPS[2][1]}


def min_rates(device, iters: int = 8192, blocks_per_sm: int = 2) -> dict:
    """The card's rate of each min of MIN_OPS: {op: dict(what, ms, g_per_s
    (results a second / 1e9), per_clk_sm, mhz)}; the median of 5 CUDA-event
    timings of `blocks_per_sm` x SMs blocks of MR_THREADS threads, `iters` x
    MR_STEP mins a thread; the SM clock from block 0's clock64 and
    %globaltimer over its loop. Prints one line a min."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = blocks_per_sm * sms
    fn = _build.entry_point("probe_dot", "rt_min_rate", 2, 3)
    out = torch.empty(blocks * MR_THREADS, dtype=torch.int32, device=device)
    clk = torch.zeros(2, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rates = {}
    for op, (what, folds) in MIN_OPS.items():
        def run(op=op):
            rc = fn(out.data_ptr(), clk.data_ptr(), op, iters, blocks, stream)
            if rc != 0:
                raise RuntimeError(f"rt_min_rate op {op} failed to launch: cudaError {rc}")
        ms = time_ms(run)
        cycles, ns = clk.tolist()
        mhz = cycles / ns * 1e3
        results = blocks * MR_THREADS * iters * MR_STEP / (ms * 1e-3)
        rates[op] = dict(what=what, ms=ms, g_per_s=results / 1e9, mhz=mhz,
                         per_clk_sm=results / (mhz * 1e6 * sms))
        print(f"min rate {what:16s} {ms:8.3f} ms  {results / 1e9:9.1f} G results/s  "
              f"{rates[op]['per_clk_sm']:6.2f} a clock an SM (the bound counts "
              f"{MIN_PER_CLK_SM}) at {mhz:.0f} MHz  ({folds} minima a result)")
    return rates


def time_ms(fn, iters: int = 5) -> float:
    """Median time (ms) of `fn` over `iters` timings after a warm-up: CUDA
    events on a CUDA device."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def report(name: str, unit: str, ms: float, b: int, k: int, n: int, reps: int) -> dict:
    outputs = b * n * reps
    macs = outputs * k
    row = {
        "name": name, "ms": ms, "out_per_s": outputs / (ms * 1e-3),
        "tmacs": macs / (ms * 1e-3) / 1e12, "peak_share": 2 * macs / (ms * 1e-3) / PEAK[unit],
    }
    print(f"{name:30s} {ms:9.3f} ms  {row['out_per_s']:.3e} outputs/s  {row['tmacs']:7.2f} TMAC/s  "
          f"{row['peak_share']:7.2%} of the {unit} peak")
    return row


def sweep(device, b: int = RAYS, quick: bool = False) -> list:
    """Time every case of CASES (the first QUICK with `quick`)."""
    rows = []
    for name, variant, k, n, reps, m, acc_min in CASES[:QUICK] if quick else CASES:
        f, g = operands(variant, k, b, n * reps, device)
        ms = time_ms(lambda: PD.dot_min(f, g, n, reps, variant, m=m, acc_min=acc_min))
        rows.append(report(name, variant, ms, b, k, n, reps))
    return rows


def split_sweep(device, b: int = RAYS, n: int = 1024, reps: int = 8) -> list:
    """probe_k96's cases: one BF16 pass at K = 16, the FP32 FMA dot, and
    the split dots at K = 96 (F pre-split, F split in the kernel) and 48."""
    f32, g32 = operands("fp32", PD.SPLIT_K, b, n * reps, device)
    f96, g96 = PD.cat6_f(f32), PD.cat6_g(g32)
    fbf, gbf = f32.to(torch.bfloat16), g32.to(torch.bfloat16)
    f48, g48 = f96[:48].contiguous(), g96[:48].contiguous()
    cases = [
        ("bf16 k16", "bf16", 16, lambda: PD.dot_min(fbf, gbf, n, reps, "bf16")),
        ("fp32 k16", "fp32", 16, lambda: PD.dot_min(f32, g32, n, reps, "fp32")),
        ("bf16 k96 presplit", "bf16", 96, lambda: PD.dot_min_split(f96, g96, n, reps)),
        ("bf16 k96 in-kernel F split", "bf16", 96, lambda: PD.dot_min_split(f32, g96, n, reps)),
        ("bf16 k48 (x3: ha.hb+ha.mb+ha.lb)", "bf16", 48, lambda: PD.dot_min_split(f48, g48, n, reps)),
        ("bf16w k96 presplit", "bf16w", 96,
         lambda: PD.dot_min_split(f96, g96, n, reps, variant="bf16w")),
        ("bf16w k96 in-kernel F split", "bf16w", 96,
         lambda: PD.dot_min_split(f32, g96, n, reps, variant="bf16w")),
        ("bf16w k48 (x3)", "bf16w", 48, lambda: PD.dot_min_split(f48, g48, n, reps, variant="bf16w")),
    ]
    return [report(name, unit, time_ms(fn), b, k, n, reps) for name, unit, k, fn in cases]


def mt_features(device, n_rays: int = 4096, scene_path: str = "assets/scenes/DarkCornell.glb"):
    """Real Moller-Trumbore operands: F [16, n_rays] of random rays
    (`np.random.default_rng(0)`) and the scene's triangle table G [16, 4*T]."""
    g = torch.from_numpy(np.asarray(World.from_path(scene_path).tri_feats16, np.float32))
    rng = np.random.default_rng(0)
    ro = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    f = _ray_features16(torch.from_numpy(ro), torch.from_numpy(rd))
    return f.contiguous().to(device), g.contiguous().to(device)


def _dots(fn, f, g) -> torch.Tensor:
    """Every dot F[:, b] . G[:, n] through a min-reducing `fn(f, cols)`,
    a column at a time (the column repeated to the kernels' width of 8, so
    the min returns it) -> [B, N] float64."""
    out = torch.empty((f.shape[1], g.shape[1]), dtype=torch.float64, device=f.device)
    for n in range(g.shape[1]):
        out[:, n] = fn(f, g[:, n : n + 1].expand(-1, 8).contiguous()).double()
    return out


def accuracy(device, n_rays: int = 4096, columns: int | None = None) -> dict:
    """Each unit's dot against float64 on `mt_features` (the first
    `columns` of G; all by default) -> {unit: (max, 99.9th percentile,
    mean) of |dot - f64| / (|F|^T |G|)}."""
    f, g = mt_features(device, n_rays)
    g = g[:, :columns].contiguous()
    ref = f.double().T @ g.double()
    scale = (f.double().abs().T @ g.double().abs()).clamp_min(1e-30)
    g96, f96 = PD.cat6_g(g), PD.cat6_f(f)
    fbf, gbf = f.to(torch.bfloat16), g.to(torch.bfloat16)
    units = {
        "fp32 FMA": lambda: _dots(lambda a, c: PD.dot_min(a, c, 8, 1, "fp32"), f, g),
        "tf32": lambda: _dots(lambda a, c: PD.dot_min(a, c, 8, 1, "tf32"), f, g),
        "bf16": lambda: _dots(lambda a, c: PD.dot_min(a, c, 8, 1, "bf16"), fbf, gbf),
        "bf16 K=48 x3": lambda: _dots(lambda a, c: PD.dot_min_split(a, c, 8, 1),
                                      f96[:48].contiguous(), g96[:48]),
        "bf16 K=96 x6": lambda: _dots(lambda a, c: PD.dot_min_split(a, c, 8, 1), f, g96),
    }
    stats = {}
    for name, run in units.items():
        rel = ((run() - ref).abs() / scale).flatten()
        p999 = float(torch.quantile(rel[:: max(1, rel.numel() // (1 << 22))], 0.999))
        stats[name] = (float(rel.max()), p999, float(rel.mean()))
        print(f"{name:14s} max_rel_vs_terms={stats[name][0]:.3e}  p999={p999:.3e}  "
              f"mean={stats[name][2]:.3e}")
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help=f"the first {QUICK} cases of the sweep")
    ap.add_argument("--accuracy-only", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    # the plain versions the wrappers are checked against multiply in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card)
    if not args.accuracy_only:
        min_rates(device)
        sweep(device, quick=args.quick)
        split_sweep(device)
        print()
    accuracy(device)
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
