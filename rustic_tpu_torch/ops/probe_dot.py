"""The dot-rate probes: kernels K18 and K19 and their plain twins.

Counterparts of the Pallas kernels of tools/mxu_floor.py (`_case_kernel`
and the int8 kernel of its `main`) and tools/probe_k96.py (`_kernel`).
Both compute, for F [K, B] and G [K, N*reps],

    out[b] = min over r < reps, n < N of  F[:, b] . G[:, r*N + n]

(with `acc_min` off, over column r*N of each slice alone): the shape of
the flash scans' pair test, rays against triangle columns reduced per
ray, without its epilogue. What differs is the unit the dot runs on:

- `dot_min` (K18), by `variant`: "fp32", FP32 FMAs with a few rays a
  thread, what the scans do; "tf32", "bf16" and "int8", tensor cores
  (`mma.sync`, FP32 or int32 accumulate); "bf16w", "tf32w" and "int8w",
  the BF16, TF32 and int8 tensor cores through the warpgroup instruction
  `wgmma.mma_async`. "tf32" and "tf32w" take float32 operands and round
  them to TF32 (`round_tf32`); "bf16" and "bf16w" take bfloat16, "int8"
  and "int8w" int8 operands and return int32.
- `dot_min_split` (K19): an f32 dot of depth 16 as one BF16 pass of depth
  96. Each f32 value a is split into three bfloat16 parts (`split3`: hi =
  bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid)); G arrives as the
  six blocks [hb mb lb hb mb hb] (`cat6_g`), F as [ha ha ha ma ma la]
  (`cat6_f`) or as [16, B] float32, which the kernel splits. The six kept
  cross terms are exact in the FP32 accumulator; the three dropped ones
  are below 2^-24 of the terms. The first 48 rows of both are the
  three-term dot ha.(hb + mb + lb).

Each wrapper runs its plain PyTorch version for CPU tensors and its CUDA
kernel (csrc/probe_dot.cu) for CUDA tensors, and counts its launches in
LAUNCHES. The plain versions are one float32 matrix product per chunk of
rays and a min; the renderer calls none of this, `probe_dot_floor` does.
"""

from __future__ import annotations

import torch

from rustic_tpu_torch.ops import _build

VARIANTS = ("fp32", "tf32", "bf16", "int8", "bf16w", "tf32w", "int8w")  # the kernel's numbers
WGMMA = ("bf16w", "tf32w", "int8w")  # through wgmma: whole 128-column tiles, acc_min only
INT8 = ("int8", "int8w")  # int8 operands, int32 sums
_OPERAND = {"fp32": torch.float32, "tf32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8, "bf16w": torch.bfloat16, "tf32w": torch.float32,
            "int8w": torch.int8}
_K_STEP = {"tf32": 8, "bf16": 16, "int8": 32, "bf16w": 16, "tf32w": 8,
           "int8w": 32}  # an instruction's depth
SPLIT_K = 16  # depth of the f32 dot K19 emulates
# f32 elements of one [chunk, N*reps] product of the plain versions (1 GiB)
_PLAIN_CHUNK = 1 << 28

LAUNCHES = {f"dot_min_{v}": 0 for v in VARIANTS} | {"dot_min_split": 0, "dot_min_split_bf16w": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- operand helpers ---------------------------------------------------------


def split3(a: torch.Tensor):
    """float32 -> (hi, mid, lo) bfloat16 with hi + mid + lo == a exactly
    for normal values (tools/probe_k96.py `split3_np`)."""
    a = a.to(torch.float32)
    hi = a.to(torch.bfloat16)
    r1 = a - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def cat6_g(g: torch.Tensor) -> torch.Tensor:
    """[16, N] float32 -> [96, N] bfloat16, the G-side blocks [hb mb lb hb mb hb]."""
    hb, mb, lb = split3(g)
    return torch.cat([hb, mb, lb, hb, mb, hb], dim=0)


def cat6_f(f: torch.Tensor) -> torch.Tensor:
    """[16, B] float32 -> [96, B] bfloat16, the F-side blocks [ha ha ha ma ma
    la]: with `cat6_g` the cross terms ha.hb ha.mb ha.lb ma.hb ma.mb la.hb."""
    ha, ma, la = split3(f)
    return torch.cat([ha, ha, ha, ma, ma, la], dim=0)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero, as `cvt.rna.tf32.f32` rounds (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# ---- plain versions ----------------------------------------------------------


def _check_shapes(f, g, n: int, reps: int):
    if f.ndim != 2 or g.ndim != 2 or f.shape[0] != g.shape[0]:
        raise ValueError(f"F {tuple(f.shape)} and G {tuple(g.shape)} must share their depth K")
    if g.shape[1] != n * reps:
        raise ValueError(f"G has {g.shape[1]} columns, expected N * reps = {n * reps}")


def _min_of_dots(f32, g32, n: int, acc_min: bool) -> torch.Tensor:
    """min over the columns of f32^T @ g32 (float32 tensors), a chunk of
    rays at a time."""
    if not acc_min:
        g32 = g32[:, ::n]  # column r*N of each slice
    b = f32.shape[1]
    out = torch.empty(b, dtype=torch.float32, device=f32.device)
    step = max(1, _PLAIN_CHUNK // g32.shape[1])
    for lo in range(0, b, step):
        out[lo : lo + step] = (f32[:, lo : lo + step].T @ g32).amin(dim=1)
    return out


def dot_min_plain(f, g, n: int, reps: int, variant: str = "fp32", acc_min: bool = True):
    """`dot_min` in plain PyTorch: the operands upcast to float32 ("tf32",
    "tf32w": rounded to TF32 first), one float32 product, the min. int8 sums of at
    most 32 products stay below 2^24, so float32 holds them exactly; the
    result of "int8" and "int8w" is returned as int32."""
    _check_shapes(f, g, n, reps)
    f32, g32 = f.float(), g.float()
    if variant in ("tf32", "tf32w"):
        f32, g32 = round_tf32(f32), round_tf32(g32)
    out = _min_of_dots(f32, g32, n, acc_min)
    return out.to(torch.int32) if variant in INT8 else out


def dot_min_split_plain(f, g, n: int, reps: int):
    """`dot_min_split` in plain PyTorch: F split here if it arrives as
    [16, B] float32 (`cat6_f`), then the float32 product of the upcast
    blocks and the min."""
    if f.dtype == torch.float32:
        f = cat6_f(f)
    _check_shapes(f, g, n, reps)
    return _min_of_dots(f.float(), g.float(), n, True)


# ---- CUDA wrappers -----------------------------------------------------------


def max_block_rays(variant: str, k: int) -> int:
    """The most rays a block of `dot_min` takes: a warp of the `mma.sync`
    variants holds its rays' fragments in registers, 64 rays up to three K
    steps (of 8 TF32, 16 BF16 or 32 int8 values) and 32 rays beyond, in
    blocks of at most 16 warps; the FP32 variant takes 1024 rays; a
    `wgmma` block is at most two warpgroups of 256 rays up to three K
    steps, of 128 beyond."""
    if variant == "fp32":
        return 1024
    steps = -(-k // _K_STEP[variant])
    if variant in WGMMA:
        return 512 if steps <= 3 else 256
    return 1024 if steps <= 3 else 512


# the depths K each unit's kernel is built for (csrc/probe_dot.cu rt_dot_min)
_DEPTHS = {"fp32": (8, 16, 32), "tf32": (8, 16, 32), "bf16": (8, 16, 32, 48, 64, 96, 128),
           "int8": (16, 32), "bf16w": (16, 32, 48, 64, 96, 128), "tf32w": (8, 16, 32),
           "int8w": (16, 32)}


def _check_operands(f, g, n, reps, dtype_f, dtype_g, variant, m):
    """Raise unless the kernel of `variant` takes these operands, `n`
    columns a slice and `m` rays a block."""
    _check_shapes(f, g, n, reps)
    dev = f.device
    _build.check(f, "F", dtype_f, f.shape, dev)
    _build.check(g, "G", dtype_g, g.shape, dev)
    k = g.shape[0]
    if k not in _DEPTHS[variant]:
        raise ValueError(f"K = {k}: the {variant} kernel is built for K in {_DEPTHS[variant]}")
    width = 128 if variant in WGMMA else 8  # columns of one tensor-core instruction
    if f.shape[1] < 1 or n < 1 or n % width or reps < 1:
        raise ValueError(
            f"B = {f.shape[1]}, N = {n}, reps = {reps}: N must be a multiple of {width}")
    most = max_block_rays(variant, k)
    # rays a warp (through wgmma a warpgroup) holds
    step = most // 2 if variant in WGMMA else 32 if variant == "fp32" or most < 1024 else 64
    if m < step or m % step or m > most:
        raise ValueError(f"{m} rays a block: expected a multiple of {step} up to {most}")


def _wgmma_scratch(variant: str, k: int, cols: int, device):
    """Room for G in the order `wgmma` reads it ("bf16w", "tf32w",
    "int8w": the kernel packs it there before its main launch, 32 bytes a
    column and K step), else None."""
    if variant not in WGMMA:
        return None
    step = _K_STEP[variant]
    return torch.empty(cols * step * -(-k // step), dtype=_OPERAND[variant], device=device)


def dot_min(f, g, n: int, reps: int, variant: str = "fp32", m: int | None = None,
            acc_min: bool = True):
    """K18 (replaces tools/mxu_floor.py `_case_kernel` and its int8
    kernel `k8`): F [K, B], G [K, n*reps] in the operand type of `variant`
    -> out [B] float32 (int32 for "int8" and "int8w"); `m` rays a block, a
    multiple of 64 (of 32 for "fp32" and where a block holds 512, of a
    warpgroup's rays for the `wgmma` variants) up to `max_block_rays`, the
    default. K: 8, 16 or 32 ("fp32", "tf32", "tf32w"); 8, 16, 32, 48, 64, 96
    or 128 ("bf16"; "bf16w" from 16); 16 or 32 ("int8", "int8w"). n: a
    multiple of 8 (of 128 for "bf16w", "tf32w" and "int8w", which have no
    `acc_min` off)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: expected one of {VARIANTS}")
    if variant in WGMMA and not acc_min:
        raise ValueError(f'the "{variant}" kernel reduces over every column (acc_min)')
    if _build.uses_plain(f):
        return dot_min_plain(f, g, n, reps, variant, acc_min)
    dtype = _OPERAND[variant]
    k, b = f.shape
    m = max_block_rays(variant, k) if m is None else m
    _check_operands(f, g, n, reps, dtype, dtype, variant, m)
    out = torch.empty(b, dtype=torch.int32 if variant in INT8 else torch.float32,
                      device=f.device)
    name = f"dot_min_{variant}"
    _build.launch(
        _build.entry_point("probe_dot", "rt_dot_min", 4, 7), name, f.device,
        (f, g, out, _wgmma_scratch(variant, k, n * reps, f.device)),
        (b, k, n, reps, m, int(acc_min), VARIANTS.index(variant)),
    )
    LAUNCHES[name] += 1
    return out


def dot_min_split(f, g, n: int, reps: int, m: int | None = None, variant: str = "bf16"):
    """K19 (replaces tools/probe_k96.py `_kernel`): G [96, n*reps] bfloat16
    from `cat6_g`; F [16, B] float32, split in the kernel, or the blocks of
    `cat6_f`, [96, B] bfloat16 (the first 48 rows of both: the three-term
    dot) -> out [B] float32. `variant`: "bf16" (`mma.sync`) or "bf16w"
    (`wgmma`); `m` rays a block (`max_block_rays`; the default: 512, and
    for "bf16w" the most a block takes)."""
    if variant not in ("bf16", "bf16w"):
        raise ValueError(f"variant {variant!r}: the split dot runs as \"bf16\" or \"bf16w\"")
    if _build.uses_plain(f):
        return dot_min_split_plain(f, g, n, reps)
    if m is None:
        k_a = SPLIT_K if f.dtype == torch.float32 else f.shape[0]  # depth of the A fragments
        m = 512 if variant == "bf16" else max_block_rays(variant, k_a)
    b = f.shape[1]
    out = torch.empty(b, dtype=torch.float32, device=f.device)
    name = "dot_min_split" if variant == "bf16" else "dot_min_split_bf16w"
    if f.dtype == torch.float32:
        if f.shape[0] != SPLIT_K or g.shape[0] != 6 * SPLIT_K:
            raise ValueError(f"the kernel splits F [16, B] against G [96, N]; got "
                             f"{tuple(f.shape)} and {tuple(g.shape)}")
        _check_operands(f, g[:SPLIT_K], n, reps, torch.float32, torch.bfloat16, variant, m)
        _build.check(g, "G", torch.bfloat16, (6 * SPLIT_K, n * reps), f.device)
        _build.launch(
            _build.entry_point("probe_dot", "rt_dot_min_split", 4, 5), name, f.device, (f, g, out, _wgmma_scratch(variant, 6 * SPLIT_K, n * reps, f.device)),
            (b, n, reps, m, int(variant == "bf16w")),
        )
    else:
        if f.shape[0] not in (3 * SPLIT_K, 6 * SPLIT_K):
            raise ValueError(f"pre-split F has depth {f.shape[0]}, expected 48 or 96")
        _check_operands(f, g, n, reps, torch.bfloat16, torch.bfloat16, variant, m)
        _build.launch(
            _build.entry_point("probe_dot", "rt_dot_min", 4, 7), name, f.device,
            (f, g, out, _wgmma_scratch(variant, f.shape[0], n * reps, f.device)),
            (b, f.shape[0], n, reps, m, 1, VARIANTS.index(variant)),
        )
    LAUNCHES[name] += 1
    return out
