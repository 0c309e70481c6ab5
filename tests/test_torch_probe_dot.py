"""The dot-rate probes (K18, K19: their plain versions) against the
Pallas kernel bodies of tools/mxu_floor.py and tools/probe_k96.py.

The same numpy-seeded operands go through the TPU probes' kernel bodies,
run here in Pallas interpret mode under a `pallas_call` with plain
BlockSpecs (the tools' own calls pin TPU memory spaces), and through the
port's plain versions: int8 equal; f32 within rtol 1e-5, atol 1e-5 (the
sum of 16 products is taken in another order); the split dots within
2e-5 of the float64 dot at these shapes (terms of magnitude 1). The
split helpers match the tools' numpy ones bit for bit."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rustic_tpu_torch import probe_dot_floor as PF
from rustic_tpu_torch.ops import probe_dot as PD
from tools.mxu_floor import _case_kernel
from tools.probe_k96 import _kernel as _k96_kernel
from tools.probe_k96 import cat6_f_np, cat6_g, split3_np

torch.set_num_threads(2)

B, M, N, REPS = 512, 128, 128, 2
HIGHEST = jax.lax.Precision.HIGHEST
DEFAULT = jax.lax.Precision.DEFAULT


def interpret(kernel, f, g, m=M):
    """`kernel` over ray blocks of `m`, as the tools' pallas_call grids it."""
    k_f, b = f.shape
    out = pl.pallas_call(
        kernel,
        grid=(b // m,),
        in_specs=[pl.BlockSpec((k_f, m), lambda i: (0, i)),
                  pl.BlockSpec(g.shape, lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, m), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((1, b), jnp.float32),
        interpret=True,
    )(jnp.asarray(f), jnp.asarray(g))
    return np.asarray(out)[0]


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    f = rng.normal(size=(16, B)).astype(np.float32)
    g = rng.normal(size=(16, N * REPS)).astype(np.float32)
    return f, g


def f64_min(f, g, acc_min=True):
    d = np.asarray(f, np.float64).T @ np.asarray(g, np.float64)
    d = d.reshape(d.shape[0], REPS, N)
    return (d.min(axis=2) if acc_min else d[:, :, 0]).min(axis=1)


def bf16_tensor(a) -> torch.Tensor:
    """A numpy bfloat16 array as a torch tensor, by its bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("acc_min", [True, False])
def test_fp32_dot_min_matches_the_tpu_kernel(operands, acc_min):
    f, g = operands
    want = interpret(_case_kernel(16, N, REPS, HIGHEST, acc_min), f, g)
    got = PD.dot_min(torch.from_numpy(f), torch.from_numpy(g), N, REPS, "fp32",
                     acc_min=acc_min).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, f64_min(f, g, acc_min), rtol=1e-5, atol=1e-5)


def test_bf16_dot_min_matches_the_tpu_kernel(operands):
    """One BF16 pass: every product is exact in f32, so only the order of
    the sum separates the two."""
    f, g = (a.astype(ml_dtypes.bfloat16) for a in operands)
    want = interpret(_case_kernel(16, N, REPS, DEFAULT, True), f, g)
    got = PD.dot_min(bf16_tensor(f), bf16_tensor(g), N, REPS, "bf16").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["int8", "int8w"])
@pytest.mark.parametrize("k", [16, 32])
def test_int8_dot_min_equals_the_tpu_kernel(k, variant):
    """Integer sums: "int8" (mma.sync) and "int8w" (wgmma) equal to the TPU
    kernel body and to the int64 product's min."""
    rng = np.random.default_rng(1)
    f = rng.integers(-128, 128, (k, B)).astype(np.int8)
    g = rng.integers(-128, 128, (k, N * REPS)).astype(np.int8)
    want = interpret(_case_kernel(k, N, REPS, None, True, out_dtype=jnp.int32), f, g)
    got = PD.dot_min(torch.from_numpy(f), torch.from_numpy(g), N, REPS, variant)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    exact = (f.astype(np.int64).T @ g.astype(np.int64)).min(axis=1)
    assert np.array_equal(got.numpy(), exact)


@pytest.mark.parametrize("case", ["k96-presplit", "k96-in-kernel-split", "k48"])
def test_split_dot_matches_the_tpu_kernel(operands, case):
    f, g = operands
    f96, g96 = cat6_f_np(f), cat6_g(g)
    if case == "k96-in-kernel-split":
        want = interpret(_k96_kernel(N, REPS, DEFAULT, 16, True), f, g96)
        got = PD.dot_min_split(torch.from_numpy(f), bf16_tensor(g96), N, REPS)
    else:
        k = 96 if case == "k96-presplit" else 48
        want = interpret(_k96_kernel(N, REPS, DEFAULT, k, False), f96[:k], g96[:k])
        got = PD.dot_min_split(bf16_tensor(f96[:k]), bf16_tensor(g96[:k]), N, REPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the three-term dot drops F's mid and lo parts: it is the dot of bf16(F)
    ha = split3_np(f)[0].astype(np.float32)
    ref = f64_min(ha if case == "k48" else f, g)
    assert np.abs(got.numpy() - ref).max() < 2e-5
    assert np.abs(want - ref).max() < 2e-5
    if case == "k48":  # and that is far from the f32 dot
        assert np.abs(got.numpy() - f64_min(f, g)).max() > 1e-3


def test_split_helpers_equal_the_numpy_ones(operands):
    f, g = operands
    f = np.concatenate([f, f * np.float32(1e-3), f * np.float32(3e4)], axis=1)

    def bits(a):
        return a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) else a.view(np.int16)

    for got, want in zip(PD.split3(torch.from_numpy(f)), split3_np(f)):
        assert got.dtype == torch.bfloat16 and np.array_equal(bits(got), bits(want))
    assert np.array_equal(bits(PD.cat6_f(torch.from_numpy(f))), bits(cat6_f_np(f)))
    assert np.array_equal(bits(PD.cat6_g(torch.from_numpy(g))), bits(cat6_g(g)))
    hi, mid, lo = PD.split3(torch.from_numpy(f))
    assert torch.equal(hi.double() + mid.double() + lo.double(), torch.from_numpy(f).double())


def test_round_tf32_keeps_ten_mantissa_bits(operands):
    x = torch.from_numpy(operands[0])
    r = PD.round_tf32(x)
    assert torch.equal(PD.round_tf32(r), r)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0**-11
    assert torch.equal(PD.round_tf32(torch.tensor([1.0 + 2.0**-11])), torch.tensor([1.0 + 2.0**-10]))
    got = PD.dot_min(x, torch.from_numpy(operands[1]), N, REPS, "tf32")
    want = PD.dot_min(r, PD.round_tf32(torch.from_numpy(operands[1])), N, REPS, "fp32")
    assert torch.equal(got, want)


def test_wrappers_check_their_operands(operands):
    f, g = (torch.from_numpy(a) for a in operands)
    with pytest.raises(ValueError, match="variant"):
        PD.dot_min(f, g, N, REPS, "fp16")
    with pytest.raises(ValueError, match="N \\* reps"):
        PD.dot_min(f, g, N, REPS + 1)
    with pytest.raises(ValueError, match="share their depth"):
        PD.dot_min(f[:8], g, N, REPS)
    with pytest.raises(ValueError, match="no kernel for device"):
        PD.dot_min(f.to("meta"), g.to("meta"), N, REPS)
    assert PD.max_block_rays("fp32", 16) == 1024
    assert [PD.max_block_rays("bf16", k) for k in (8, 16, 48, 64, 96, 128)] == [1024] * 3 + [512] * 3
    assert [PD.max_block_rays("tf32", k) for k in (8, 16, 32)] == [1024, 1024, 512]
    assert PD.max_block_rays("int8", 32) == 1024


def test_kernel_operands_are_checked_before_a_launch(operands):
    """What the CUDA wrappers refuse before they launch: a depth no kernel
    is built for, a column count off the mma's width, rays a block that do
    not fill whole warps or exceed what a block holds."""
    f, g = (torch.from_numpy(a) for a in operands)
    f32 = torch.float32
    PD._check_operands(f, g, N, REPS, f32, f32, "fp32", 1024)
    PD._check_operands(f, g, N, REPS, f32, f32, "tf32", 64)
    for bad, match in (
        (dict(variant="fp32", m=1000), "rays a block"),
        (dict(variant="fp32", m=2048), "rays a block"),
        (dict(variant="tf32", m=96), "multiple of 64"),
        (dict(variant="int8", m=1024), "dtype"),
    ):
        with pytest.raises(ValueError, match=match):
            PD._check_operands(f, g, N, REPS, f32 if bad["variant"] != "int8" else torch.int8,
                               f32, bad["variant"], bad["m"])
    with pytest.raises(ValueError, match="built for K"):
        PD._check_operands(f[:12], g[:12], N, REPS, f32, f32, "fp32", 1024)
    with pytest.raises(ValueError, match="multiple of 8"):
        PD._check_operands(f, g[:, : 2 * 100].contiguous(), 100, 2, f32, f32, "fp32", 1024)
    wide = torch.zeros((64, B), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 512"):
        PD._check_operands(wide, torch.zeros((64, N), dtype=torch.bfloat16), N, 1,
                           torch.bfloat16, torch.bfloat16, "bf16", 1024)
    with pytest.raises(ValueError, match="contiguous"):
        PD._check_operands(f.T.contiguous().T, g, N, REPS, f32, f32, "fp32", 1024)


def test_wgmma_variant_shares_the_bf16_plain_version(operands):
    """ "bf16w" (BF16 through wgmma) computes what "bf16" computes; its
    kernel takes 128 columns an instruction, whole warpgroups of 256 rays
    (128 beyond K = 48), and has no form without the min."""
    f, g = (bf16_tensor(a.astype(ml_dtypes.bfloat16)) for a in operands)
    assert torch.equal(PD.dot_min(f, g, N, REPS, "bf16w"), PD.dot_min(f, g, N, REPS, "bf16"))
    with pytest.raises(ValueError, match="acc_min"):
        PD.dot_min(f, g, N, REPS, "bf16w", acc_min=False)
    with pytest.raises(ValueError, match="split dot runs as"):
        PD.dot_min_split(f, g, N, REPS, variant="tf32")
    bf = torch.bfloat16
    assert [PD.max_block_rays("bf16w", k) for k in (16, 48, 64, 96, 128)] == [512, 512, 256, 256, 256]
    PD._check_operands(f, g, N, REPS, bf, bf, "bf16w", 512)
    PD._check_operands(f, g, N, REPS, bf, bf, "bf16w", 256)
    with pytest.raises(ValueError, match="multiple of 256"):
        PD._check_operands(f, g, N, REPS, bf, bf, "bf16w", 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        PD._check_operands(f, g[:, :128].contiguous(), 64, 2, bf, bf, "bf16w", 512)
    with pytest.raises(ValueError, match="built for K"):
        PD._check_operands(f[:8], g[:8], N, REPS, bf, bf, "bf16w", 512)
    assert PD._wgmma_scratch("bf16", 16, 256, "cpu") is None
    assert PD._wgmma_scratch("bf16w", 48, 256, "cpu").numel() == 256 * 48
    assert PD._wgmma_scratch("bf16w", 8 + 16, 256, "cpu").numel() == 256 * 32


def test_accuracy_ranks_the_units():
    """On real Moller-Trumbore features (DarkCornell, the probe's rays) the
    six-term split dot is as close to float64 as the FP32 FMA dot; one
    reduced-precision pass is orders of magnitude off."""
    stats = PF.accuracy("cpu", n_rays=64, columns=48)
    worst = {name: s[0] for name, s in stats.items()}
    assert set(worst) == {"fp32 FMA", "tf32", "bf16", "bf16 K=48 x3", "bf16 K=96 x6"}
    assert worst["fp32 FMA"] < 5e-7 and worst["bf16 K=96 x6"] < 5e-7
    assert worst["bf16 K=48 x3"] > 1e-4 and worst["bf16"] > 1e-4
    assert 1e-5 < worst["tf32"] < worst["bf16"]


def test_probe_operands_are_seeded():
    f, g = PF.operands("bf16", 16, 64, 32, "cpu")
    f2, g2 = PF.operands("bf16", 16, 64, 32, "cpu")
    assert f.dtype == g.dtype == torch.bfloat16 and f.shape == (16, 64) and g.shape == (16, 32)
    assert torch.equal(f, f2) and torch.equal(g, g2)
    fi, _ = PF.operands("int8", 32, 64, 32, "cpu")
    assert fi.dtype == torch.int8 and int(fi.min()) < -100 and int(fi.max()) > 100
    names = [c[0] for c in PF.CASES]
    assert len(set(names)) == len(names)
    for _, variant, k, n, reps, m, _ in PF.CASES:
        assert m <= PD.max_block_rays(variant, k) and n % 8 == 0 and PF.RAYS % m == 0
        f, g = PF.operands(variant, k, m, n * reps, "cpu")
        PD._check_operands(f, g, n, reps, f.dtype, g.dtype, variant, m)  # what the kernels take


def test_tf32_wgmma_variant_shares_the_tf32_plain_version(operands):
    """ "tf32w" (TF32 through wgmma) computes what "tf32" computes: both
    operands rounded to TF32, then the float32 dot. Held to the TPU case
    at its lower precision: within the TF32 rounding of both operands,
    2^-10 of the summed term magnitudes of the worst column."""
    f, g = operands
    tf, tg = torch.from_numpy(f), torch.from_numpy(g)
    got = PD.dot_min(tf, tg, N, REPS, "tf32w")
    assert torch.equal(got, PD.dot_min(tf, tg, N, REPS, "tf32"))
    assert torch.equal(got, PD.dot_min_plain(tf, tg, N, REPS, "tf32w"))
    want = interpret(_case_kernel(16, N, REPS, DEFAULT, True), f, g)
    terms = (np.abs(f).astype(np.float64).T @ np.abs(g).astype(np.float64)).max(axis=1)
    assert np.all(np.abs(got.numpy() - want) <= 2.0**-10 * 1.01 * terms + 1e-5)
    assert np.abs(got.numpy() - want).max() > 1e-5  # and TF32 is seen
    with pytest.raises(ValueError, match="acc_min"):
        PD.dot_min(tf, tg, N, REPS, "tf32w", acc_min=False)
    assert [PD.max_block_rays("tf32w", k) for k in (8, 16, 32)] == [512, 512, 256]
    PD._check_operands(tf, tg, N, REPS, torch.float32, torch.float32, "tf32w", 256)
    with pytest.raises(ValueError, match="multiple of 256"):
        PD._check_operands(tf, tg, N, REPS, torch.float32, torch.float32, "tf32w", 128)
    with pytest.raises(ValueError, match="built for K"):
        PD._check_operands(tf[:12], tg[:12], N, REPS, torch.float32, torch.float32, "tf32w", 512)
    scratch = PD._wgmma_scratch("tf32w", 16, 256, "cpu")
    assert scratch.dtype == torch.float32 and scratch.numel() * 4 == 256 * 32 * 2  # 2 K steps


def test_tf32_wgmma_launch_is_counted(operands, monkeypatch):
    """The wrapper's path to the card, with the launch itself replaced:
    the operands checked, the variant's number and block passed, the
    scratch for G's ring order allocated, and one launch counted."""
    tf, tg = (torch.from_numpy(a) for a in operands)
    calls = []
    monkeypatch.setattr(PD._build, "uses_plain", lambda x: False)
    monkeypatch.setattr(PD._build, "entry_point", lambda *a: a)
    monkeypatch.setattr(PD._build, "launch", lambda fn, label, dev, tensors, ints:
                        calls.append((fn, label, tensors, ints)))
    PD.reset_launch_counts()
    PD.dot_min(tf, tg, N, REPS, "tf32w")
    assert PD.LAUNCHES["dot_min_tf32w"] == 1
    assert sum(PD.LAUNCHES.values()) == 1
    (fn, label, tensors, ints), = calls
    assert fn == ("probe_dot", "rt_dot_min", 4, 7) and label == "dot_min_tf32w"
    assert ints == (B, 16, N, REPS, 512, 1, PD.VARIANTS.index("tf32w")) == (B, 16, N, REPS, 512, 1, 5)
    assert tensors[3].dtype == torch.float32 and tensors[3].numel() == N * REPS * 16
    with pytest.raises(ValueError, match="rays a block"):
        PD.dot_min(tf, tg, N, REPS, "tf32w", m=384)
    assert PD.LAUNCHES["dot_min_tf32w"] == 1
    PD.reset_launch_counts()


@pytest.mark.parametrize("k", [16, 32])
def test_int8_wgmma_variant_shares_the_int8_plain_version(k):
    """ "int8w" (int8 through wgmma, K = 16 padded to its K step of 32 as
    "int8" pads it) has "int8"'s plain version (its results:
    test_int8_dot_min_equals_the_tpu_kernel). Its kernel takes 128 columns
    an instruction, whole warpgroups of 256 rays (one K step: 512 a block),
    one K step of 32 bytes a column of G's scratch, and has no form
    without the min."""
    rng = np.random.default_rng(2)
    tf = torch.from_numpy(rng.integers(-128, 128, (k, B)).astype(np.int8))
    tg = torch.from_numpy(rng.integers(-128, 128, (k, N * REPS)).astype(np.int8))
    assert torch.equal(PD.dot_min_plain(tf, tg, N, REPS, "int8w"),
                       PD.dot_min_plain(tf, tg, N, REPS, "int8"))
    i8 = torch.int8
    with pytest.raises(ValueError, match="acc_min"):
        PD.dot_min(tf, tg, N, REPS, "int8w", acc_min=False)
    assert PD.max_block_rays("int8w", k) == 512
    PD._check_operands(tf, tg, N, REPS, i8, i8, "int8w", 512)
    PD._check_operands(tf, tg, N, REPS, i8, i8, "int8w", 256)
    with pytest.raises(ValueError, match="multiple of 256"):
        PD._check_operands(tf, tg, N, REPS, i8, i8, "int8w", 128)
    with pytest.raises(ValueError, match="up to 512"):
        PD._check_operands(tf, tg, N, REPS, i8, i8, "int8w", 768)
    with pytest.raises(ValueError, match="multiple of 128"):
        PD._check_operands(tf, tg[:, :128].contiguous(), 64, 2, i8, i8, "int8w", 512)
    with pytest.raises(ValueError, match="built for K"):
        PD._check_operands(tf[:8], tg[:8], N, REPS, i8, i8, "int8w", 512)
    with pytest.raises(ValueError, match="built for K"):
        wide = torch.zeros((48, B), dtype=i8)
        PD._check_operands(wide, torch.zeros((48, N), dtype=i8), N, 1, i8, i8, "int8w", 512)
    with pytest.raises(ValueError, match="dtype"):
        PD._check_operands(tf.float(), tg, N, REPS, i8, i8, "int8w", 512)
    scratch = PD._wgmma_scratch("int8w", k, N * REPS, "cpu")
    assert scratch.dtype == i8 and scratch.numel() == N * REPS * 32  # one K step of 32 bytes


def test_int8_wgmma_launch_is_counted(monkeypatch):
    """The wrapper's path to the card for "int8w", with the launch itself
    replaced: variant number 6, an int32 output, the scratch for G's ring
    order, one launch counted under its own label."""
    rng = np.random.default_rng(3)
    tf = torch.from_numpy(rng.integers(-128, 128, (16, B)).astype(np.int8))
    tg = torch.from_numpy(rng.integers(-128, 128, (16, N * REPS)).astype(np.int8))
    calls = []
    monkeypatch.setattr(PD._build, "uses_plain", lambda x: False)
    monkeypatch.setattr(PD._build, "entry_point", lambda *a: a)
    monkeypatch.setattr(PD._build, "launch", lambda fn, label, dev, tensors, ints:
                        calls.append((fn, label, tensors, ints)))
    PD.reset_launch_counts()
    out = PD.dot_min(tf, tg, N, REPS, "int8w")
    assert out.dtype == torch.int32 and out.shape == (B,)
    assert PD.LAUNCHES["dot_min_int8w"] == 1
    assert sum(PD.LAUNCHES.values()) == 1
    (fn, label, tensors, ints), = calls
    assert fn == ("probe_dot", "rt_dot_min", 4, 7) and label == "dot_min_int8w"
    assert ints == (B, 16, N, REPS, 512, 1, PD.VARIANTS.index("int8w")) == (B, 16, N, REPS, 512, 1, 6)
    assert tensors[2] is out
    assert tensors[3].dtype == torch.int8 and tensors[3].numel() == N * REPS * 32
    with pytest.raises(ValueError, match="rays a block"):
        PD.dot_min(tf, tg, N, REPS, "int8w", m=384)
    assert PD.LAUNCHES["dot_min_int8w"] == 1
    PD.reset_launch_counts()


def test_fold_peak_and_min_opcodes():
    """The fold's peak: 64 mins a clock an SM at the clock of the FP32 peak
    (132 SMs x 128 FFMA lanes x 2 operations), the min of three folding
    two minima a result on int32; 2^33 minima then take about 0.513 ms on
    FP32 and 0.256 on int32 accumulators. And the min opcodes of a
    kernel's SASS, predicates skipped."""
    from rustic_tpu_torch.probe_kernel_builds import min_opcodes

    clock = PF.PEAK["fp32"] / (132 * 128 * 2)
    assert PF.FOLD_PER_S["float"] == pytest.approx(PF.MIN_PER_CLK_SM * 132 * clock)
    assert PF.FOLD_PER_S["int"] == PF.MIN_OPS[2][1] * PF.FOLD_PER_S["float"]
    assert (1 << 33) / PF.FOLD_PER_S["float"] * 1e3 == pytest.approx(0.5128, abs=1e-4)
    assert (1 << 33) / PF.FOLD_PER_S["int"] * 1e3 == pytest.approx(0.2564, abs=1e-4)
    body = ["@P0 VIMNMX3 R1, R2, R3, R4", "FMNMX R0, R1, R2, PT", "IADD3 R1, R2, R3, RZ",
            "VIMNMX3 R5, R6, R7, R8", "VIMNMX R0, R1, R2, PT"]
    assert min_opcodes(body) == {"VIMNMX3": 2, "FMNMX": 1, "VIMNMX": 1}
