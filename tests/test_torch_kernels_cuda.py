"""The port's CUDA kernels against their plain versions, on the card.

Each test needs a CUDA card (the kernels have no CPU form) and skips
without one. This file imports no jax, so it also runs where only torch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Inputs are numpy-seeded, in bf16; shapes are small but keep the main path's
head dim (128), a ragged sequence tail and 512/256 sparse blocks. Tolerance:
bf16 atol 2e-2 plus rtol 2^-8 (one bf16 step of outputs up to ~8, where the
kernel and the plain version round an fp32 intermediate differently); int8
outputs within 1 LSB (an fp32 value on a rounding boundary); fp32 sums rtol
1e-4 (another summation order, CUDA's expf).
"""

import copy

import numpy as np
import pytest
import torch

from turbodiffusion_tpu_torch.models.rope import rope_freqs_3d
from turbodiffusion_tpu_torch.ops import flash_attention as fa
from turbodiffusion_tpu_torch.ops import fused_norm as fn
from turbodiffusion_tpu_torch.ops import linear_attention as la
from turbodiffusion_tpu_torch.ops import quant as qt
from turbodiffusion_tpu_torch.ops import sla_fused as sf
from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8
from turbodiffusion_tpu_torch.ops.attention import get_block_map

ATOL, RTOL = 2e-2, 2.0 ** -8
SEQ, DIM, HEADS, DH = 528, 256, 2, 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _randn(dev, *shape, seed=0, std=1.0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * std
    return torch.from_numpy(a).to(dev)


def _close(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mod", "affine", "plain"])
def test_k1_matches_plain(dev, mode):
    x = _randn(dev, 1, SEQ, DIM).bfloat16()
    ms = _randn(dev, 1, DIM, seed=1, std=0.5) if mode == "mod" else None
    mb = _randn(dev, 1, DIM, seed=2, std=0.5) if mode == "mod" else None
    w = (1 + _randn(dev, DIM, seed=3, std=0.1)).bfloat16() if mode == "affine" else None
    b = _randn(dev, DIM, seed=4, std=0.1).bfloat16() if mode == "affine" else None
    before = fn._mln_cuda.launches
    got = fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6)
    assert fn._mln_cuda.launches == before + 1
    _close(got, fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [True, False])
def test_k2_matches_plain(dev, rope):
    x = _randn(dev, 1, SEQ, DIM).bfloat16()
    w = (1 + _randn(dev, DIM, seed=3, std=0.1)).bfloat16()
    cos = sin = None
    if rope:
        cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 4, 66, DH, device=dev))
    before = fn._rmsrope_cuda.launches
    got = fn.rmsnorm_rope(x, w, cos, sin, num_heads=HEADS, eps=1e-5)
    assert fn._rmsrope_cuda.launches == before + 1
    want = (fn.rmsnorm_rope_ref(x, w, cos, sin, 1e-5) if rope else
            fn.rms_norm(x, w, 1e-5).reshape(got.shape))
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [40, 48])
@pytest.mark.parametrize("rope", [True, False])
def test_k2_wide_matches_plain(dev, heads, rope):
    """K2 above H*Dh 4096: the 14B's 40 x 128 and 48 x 128 (wider than any
    model of the repo), every channel checked."""
    D = heads * DH
    x = _randn(dev, 1, 300, D).bfloat16()
    w = (1 + _randn(dev, D, seed=3, std=0.1)).bfloat16()
    cos = sin = None
    if rope:
        cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 6, 25, DH, device=dev))
    before = fn._rmsrope_cuda.launches
    got = fn.rmsnorm_rope(x, w, cos, sin, num_heads=heads, eps=1e-5)
    assert fn._rmsrope_cuda.launches == before + 1
    want = (fn.rmsnorm_rope_ref(x, w, cos, sin, 1e-5) if rope else
            fn.rms_norm(x, w, 1e-5).reshape(got.shape))
    _close(got, want)


@pytest.mark.cuda
def test_k2_entry_refuses_what_it_cannot_compute(dev):
    """tdx_rmsnorm_rope returns cudaErrorInvalidValue (1) for an odd head
    dim or a row stride shorter than the row, and launches nothing."""
    from turbodiffusion_tpu_torch.ops import _build
    x = torch.zeros(4, 5120, dtype=torch.bfloat16, device=dev)
    out = torch.full_like(x, float("nan"))
    w = torch.ones(5120, dtype=torch.bfloat16, device=dev)
    lib = _build.load()
    for ld, H, Dh in ((5120, 40, 127), (4096, 40, 128)):
        rc = lib.tdx_rmsnorm_rope(x.data_ptr(), out.data_ptr(), w.data_ptr(),
                                  None, None, ld, 4, 4, H, Dh, 1e-5,
                                  _build.stream_ptr(x))
        assert rc == 1
    torch.cuda.synchronize()
    assert bool(out.isnan().all())


# ---------------------------------------------------------------------------
# K1 and K2's forms: the warp-per-row kernels at the path widths (row counts
# that are not a multiple of a block's rows, batch 2, the fused QKV column
# group), each written into an output poisoned with NaN so that a row or
# vector left unwritten fails; and the shapes that take the loop form. The
# 32,760-row inputs are drawn on the card (torch.Generator, seeded), the
# rest numpy-seeded as above.
# ---------------------------------------------------------------------------

def _card_randn(dev, *shape, seed=0, std=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev) * std


def _k1_operands(dev, D, mode, B=1, seed=0):
    """(mod_scale, mod_shift, weight, bias) of a K1 form: "mod" (norm1 /
    norm2), "affine" (norm3) or "bare"; the modulation (B, D) fp32."""
    mod, aff = mode == "mod", mode == "affine"
    return (_randn(dev, B, D, seed=seed + 1, std=0.5) if mod else None,
            _randn(dev, B, D, seed=seed + 2, std=0.5) if mod else None,
            (1 + _randn(dev, D, seed=seed + 3, std=0.1)).bfloat16() if aff else None,
            _randn(dev, D, seed=seed + 4, std=0.1).bfloat16() if aff else None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _k1_into_nan(x, ms, mb, w, b, form):
    """K1 through its C entry into an output prefilled with NaN, after
    checking which form the entry and `fn.mln_form` give the launch."""
    from turbodiffusion_tpu_torch.ops import _build
    lib = _build.load()
    B, L, D = x.shape
    out = torch.full_like(x, float("nan"))
    ptrs = [_ptr(t) for t in (x, out, ms, mb, w, b)]
    assert fn.mln_form(D, *ptrs) == form
    assert lib.tdx_modulated_layer_norm_form(*ptrs, D) == (form == "vector")
    assert lib.tdx_modulated_layer_norm(*ptrs, B * L, L, D, 1e-6,
                                        _build.stream_ptr(x)) == 0
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32760, 1000])
@pytest.mark.parametrize("D", [1536, 5120])
@pytest.mark.parametrize("mode", ["mod", "affine", "bare"])
def test_k1_vector_form_writes_every_row(dev, mode, D, rows):
    """K1's warp-per-row kernel at the 1.3B and 14B widths in its three
    forms, on 32,760 and 1,000 rows, against its plain version; through the
    wrapper too (one launch)."""
    x = (2 * _card_randn(dev, 1, rows, D, seed=60)).bfloat16()
    ms, mb, w, b = _k1_operands(dev, D, mode)
    want = fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6)
    _close(_k1_into_nan(x, ms, mb, w, b, "vector"), want)
    before = fn._mln_cuda.launches
    _close(fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6), want)
    assert fn._mln_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1536, 5120])
def test_k1_vector_form_at_batch_2_takes_each_batchs_modulation(dev, D):
    """Batch 2 with two different modulations: each batch's rows take its
    own (a block stages one batch's); batch 1's applied to batch 0 fails."""
    L = 1000
    x = (2 * _randn(dev, 2, L, D, seed=61)).bfloat16()
    ms, mb, _, _ = _k1_operands(dev, D, "mod", B=2, seed=62)
    want = fn.modulated_layer_norm_ref(x, ms, mb, eps=1e-6)
    got = _k1_into_nan(x, ms, mb, None, None, "vector")
    _close(got, want)
    wrong = fn.modulated_layer_norm_ref(x, ms[[1, 1]], mb[[1, 1]], eps=1e-6)
    with pytest.raises(AssertionError):
        _close(wrong, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mod", "affine"])
@pytest.mark.parametrize("case", ["width 1540", "unaligned view"])
def test_k1_loop_form_takes_what_the_vector_form_cannot(dev, case, mode):
    """Shapes that take K1's block-per-row kernel: a width that is not a
    multiple of 8, a view 4 bytes off 16-byte alignment; each matches the
    plain version, every row written."""
    L, D = 300, 1540 if case == "width 1540" else 1536
    if case == "width 1540":
        x = (2 * _randn(dev, 1, L, D, seed=68)).bfloat16()
    else:
        x = (2 * _randn(dev, L * D + 2, seed=68)).bfloat16()[2:].view(1, L, D)
    ms, mb, w, b = _k1_operands(dev, D, mode)
    _close(_k1_into_nan(x, ms, mb, w, b, "loop"),
           fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6))


@pytest.mark.cuda
def test_k1_k12_entries_refuse_a_view_their_loop_cannot_read(dev):
    """A view 2 bytes off alignment: the block-per-row kernel reads bf16
    pairs, so tdx_modulated_layer_norm(_quant) return cudaErrorInvalidValue
    (1), launch nothing, and the wrapper raises."""
    from turbodiffusion_tpu_torch.ops import _build
    L, D = 64, 1536
    x = _randn(dev, L * D + 1, seed=69).bfloat16()[1:].view(1, L, D)
    out = torch.full((1, L, D), float("nan"), dtype=torch.bfloat16, device=dev)
    s = torch.full((1, L, 1), float("nan"), device=dev)
    lib, st = _build.load(), _build.stream_ptr(x)
    assert lib.tdx_modulated_layer_norm(x.data_ptr(), out.data_ptr(), None, None, None,
                                        None, L, L, D, 1e-6, st) == 1
    assert lib.tdx_modulated_layer_norm_quant(x.data_ptr(), out.data_ptr(), s.data_ptr(),
                                              None, None, None, None, L, L, D, 1e-6,
                                              st) == 1
    with pytest.raises(RuntimeError, match="tdx_modulated_layer_norm"):
        fn.modulated_layer_norm(x)
    torch.cuda.synchronize()
    assert bool(out.isnan().all()) and bool(s.isnan().all())


def _k2_into_nan(x, w, cos, sin, H, form):
    """K2 through its C entry into an output prefilled with NaN, after
    checking which form the entry and `fn.rmsrope_form` give the launch."""
    from turbodiffusion_tpu_torch.ops import _build
    lib = _build.load()
    B, L, HD = x.shape
    ld = x.stride(1)
    out = torch.full((B, L, H, HD // H), float("nan"), dtype=x.dtype, device=x.device)
    ptrs = [_ptr(t) for t in (x, out, w, cos, sin)]
    assert fn.rmsrope_form(H, HD // H, ld, *ptrs) == form
    assert lib.tdx_rmsnorm_rope_form(*ptrs, ld, H, HD // H) == (form == "vector")
    assert lib.tdx_rmsnorm_rope(*ptrs, ld, B * L, L, H, HD // H, 1e-5,
                                _build.stream_ptr(x)) == 0
    torch.cuda.synchronize()
    return out


def _k2_want(x, w, cos, sin, H):
    if cos is not None:
        return fn.rmsnorm_rope_ref(x, w, cos, sin, 1e-5)
    B, L, HD = x.shape
    return fn.rms_norm(x, w, 1e-5).reshape(B, L, H, HD // H)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "qkv group"])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("H,Dh", [(12, 128), (40, 128), (48, 128), (24, 64)])
def test_k2_vector_form_matches_plain(dev, H, Dh, rope, layout):
    """K2's warp-per-row kernel at 12, 40 and 48 heads of 128 and 24 of 64,
    RoPE and norm only, on 1,000 rows, contiguous and as the K column group
    of a fused (1, L, 3 x H*Dh) QKV buffer (rows 3 H*Dh apart)."""
    L, HD = 1000, H * Dh
    if layout == "qkv group":
        x = _randn(dev, 1, L, 3 * HD, seed=63).bfloat16()[..., HD:2 * HD]
        assert x.stride(1) == 3 * HD
    else:
        x = _randn(dev, 1, L, HD, seed=63).bfloat16()
    w = (1 + _randn(dev, HD, seed=64, std=0.1)).bfloat16()
    cos = sin = None
    if rope:
        cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 20, 25, Dh, device=dev))
    _close(_k2_into_nan(x, w, cos, sin, H, "vector"), _k2_want(x, w, cos, sin, H))
    before = fn._rmsrope_cuda.launches
    _close(fn.rmsnorm_rope(x, w, cos, sin, num_heads=H, eps=1e-5),
           _k2_want(x, w, cos, sin, H))
    assert fn._rmsrope_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("case", ["head dim 6", "row stride 1540", "unaligned view"])
def test_k2_loop_form_takes_what_the_vector_form_cannot(dev, case, rope):
    """Shapes that take the block-per-row loop: a head dim of 6, a row
    stride that is not a multiple of 8, a view 2 bytes off 16-byte
    alignment; each matches the plain version, every element written."""
    L = 300
    if case == "head dim 6":
        H, Dh = 4, 6
        x = _randn(dev, 1, L, H * Dh, seed=65).bfloat16()
    elif case == "row stride 1540":
        H, Dh = 12, 128
        x = _randn(dev, 1, L, 1540, seed=65).bfloat16()[..., :H * Dh]
    else:
        H, Dh = 12, 128
        flat = _randn(dev, L * H * Dh + 1, seed=65).bfloat16()
        x = flat[1:].view(1, L, H * Dh)
    w = (1 + _randn(dev, H * Dh, seed=66, std=0.1)).bfloat16()
    cos = sin = None
    if rope:
        cos, sin = fn.rope_cos_sin_full(_randn(dev, L, Dh // 2, seed=67, std=3.0))
    _close(_k2_into_nan(x, w, cos, sin, H, "loop"), _k2_want(x, w, cos, sin, H))


@pytest.mark.cuda
def test_form_functions_agree_with_the_c_entries(dev):
    """`fn.mln_form` / `fn.rmsrope_form` give the form the C entries take,
    over widths, head dims, row strides and pointer offsets (the queries
    read pointers as numbers only); `fa.sparse_flash_form`,
    `fa.sparse_flash_i8qk_form`, `si8.sparse_i8_planes_form` and
    `si8.sparse_i8_planes_bs_form`, `fj.jvp_form` and `sb.bwd_form` the
    form (or the refusal) of K3's, K20's, K19's, K28's, K25 / K26's and
    K23 / K24's C queries, over blocks, lengths and strides; `la.linear_form`
    K21's, over lengths, strides and pointer offsets."""
    from turbodiffusion_tpu_torch.ops import _build
    lib = _build.load()
    base = 1 << 20
    for D in (8, 256, 1536, 1540, 2056, 5120, 8192, 8200):
        for off in (0, 2, 8, 16):
            for opt in (None, base + 4096):
                ptrs = [base + off, base, opt, opt, base + 64, None]
                assert (fn.mln_form(D, *ptrs) == "vector") == bool(
                    lib.tdx_modulated_layer_norm_form(*ptrs, D)), (D, off, opt)
    for H, Dh in ((12, 128), (40, 128), (48, 128), (24, 64), (4, 6), (3, 48), (65, 128),
                  (1, 16), (2, 256), (8, 8), (2, 512)):
        for ld in (H * Dh, 3 * H * Dh, H * Dh + 4):
            for off in (0, 2, 3072):
                for tables in ((None, None), (base, base + 8192)):
                    ptrs = [base + off, base, base + 64, *tables]
                    assert (fn.rmsrope_form(H, Dh, ld, *ptrs) == "vector") == bool(
                        lib.tdx_rmsnorm_rope_form(*ptrs, ld, H, Dh)), (H, Dh, ld, off)
    # K3, K20, K19 and K28: 1 the wgmma kernel, 0 the mma.sync loop, -1
    # refused
    code = {"wgmma": 1, "mma": 0}

    def py_form(form_fn, *args):
        try:
            return code[form_fn(*args)]
        except ValueError:
            return -1

    import ctypes
    L = 32760
    for bq, bk in ((512, 256), (512, 128), (128, 128), (512, 64), (128, 64), (64, 64),
                   (256, 384), (192, 256), (96, 64), (512, 32), (0, 256)):
        for kv_len in (L, 1000, 1, 0):
            for st in ([L * 12 * 128, 12 * 128, 128] * 4,
                       [3 * L * 1536, 3 * 1536, 128] * 3 + [L * 1536, 1536, 128],
                       [L * 12 * 132, 12 * 132, 132] + [L * 1536, 1536, 128] * 3):
                arr = (ctypes.c_int64 * 12)(*st)
                assert py_form(fa.sparse_flash_form, bq, bk, kv_len, *st) == \
                    lib.tdx_sparse_flash_attention_form(bq, bk, kv_len, arr), (bq, bk, kv_len, st)
                for Lk in (L, 1000):
                    assert py_form(fa.sparse_flash_i8qk_form, bq, bk, kv_len, Lk, *st) == \
                        lib.tdx_sparse_flash_attention_i8qk_form(bq, bk, kv_len, Lk, arr), \
                        (bq, bk, kv_len, Lk, st)
    # K25 / K26: blocks 0 / 0 are the dense launch
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    contig, fused = [L * 1536, 1536, 128], [3 * L * 1536, 3 * 1536, 128]
    for bq, bk in ((0, 0), (512, 256), (512, 64), (128, 64), (256, 192), (64, 64),
                   (192, 256), (320, 64), (96, 64), (512, 100), (0, 256), (512, 0)):
        for kv_len in (L, 900, 77, 1, 0):
            for st in (contig * 8, fused * 3 + contig * 5,
                       [L * 12 * 132, 12 * 132, 132] + contig * 7,
                       contig * 7 + [L * 1540, 1540, 128]):
                arr = (ctypes.c_int64 * 24)(*st)
                assert py_form(fj.jvp_form, bq, bk, kv_len, *st) == \
                    lib.tdx_flash_attention_jvp_form(bq, bk, kv_len, arr), (bq, bk, kv_len, st)
    # K23 / K24: the tile rows of each pass (128, 64) or -1 refused
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    do_t = [12 * L * 128, 128, L * 128]
    for bq, bk in ((512, 256), (512, 64), (128, 128), (64, 64), (192, 128), (256, 320),
                   (96, 64), (512, 32), (0, 256)):
        for kv_len in (L, 900, 1, 0):
            for st in (contig * 4, fused * 3 + do_t, [L * 12 * 132, 12 * 132, 132] + contig * 3,
                       contig * 3 + [L * 1540, 1540, 128]):
                arr = (ctypes.c_int64 * 12)(*st)
                try:
                    want = sb.bwd_form(bq, bk, kv_len, *st)
                except ValueError:
                    want = (-1, -1)
                assert want == tuple(lib.tdx_sparse_attention_bwd_form(pas, bq, bk, kv_len, arr)
                                     for pas in (0, 1)), (bq, bk, kv_len, st)
    LP = 32768
    for bq, bk in ((512, 256), (512, 128), (128, 128), (512, 64), (128, 64), (64, 64),
                   (192, 256), (96, 64), (512, 100)):
        for Lp, Lkp in ((LP, LP), (1536, 1536), (9728, 9472), (LP, 32760)):
            for kv_len in (Lkp, Lkp - 8, 1, 0, Lkp + 1):
                assert py_form(si8.sparse_i8_planes_bs_form, Lp, Lkp, kv_len, bq, bk) == \
                    lib.tdx_sparse_attention_i8_planes_bs_form(Lp, Lkp, kv_len, bq, bk), \
                    (Lp, Lkp, kv_len, bq, bk)
                assert py_form(si8.sparse_i8_planes_form, Lp, Lkp, kv_len, bq, bk) == \
                    lib.tdx_sparse_attention_i8_planes_form(Lp, Lkp, kv_len, bq, bk), \
                    (Lp, Lkp, kv_len, bq, bk)
    # K21: 1 its wgmma passes, -1 refused
    bhld, planes = [L * 1536, 128, 1536], [12 * LP * 128, LP * 128, 128]
    for B, H, Lq, kv_len in ((1, 12, LP, L), (2, 40, L, L), (1, 12, 40, 40), (1, 1, 1, 1),
                             (1, 12, 0, L), (1, 12, L, 0), (0, 12, L, L)):
        for st in (bhld * 4, planes * 4, [3 * L * 1536, 128, 3 * 1536] * 3 + bhld,
                   planes * 3 + [L * 1540, 128, 1540], bhld * 3 + [0, 128, 1536],
                   [L * 1532, 128, 1532] + bhld * 3):
            for off in (0, 2, 16):
                ptrs = [base, base + off, base + 4096, base + 8192]
                arr = (ctypes.c_int64 * 12)(*st)
                assert py_form(la.linear_form, B, H, Lq, kv_len, ptrs, st) == \
                    lib.tdx_linear_form(*ptrs, B, H, Lq, kv_len, arr), (B, H, Lq, kv_len, st, off)


@pytest.mark.cuda
@pytest.mark.parametrize("L,bq,bk", [(1100, 512, 256), (300, 128, 64)])
def test_k3_matches_plain(dev, L, bq, bk):
    q, k, v = (_randn(dev, 1, L, HEADS, DH, seed=s).bfloat16() for s in (5, 6, 7))
    _, lut, _ = get_block_map(q, k, 0.5, bq, bk)
    before = fa._sparse_flash_cuda.launches
    got = fa.sparse_flash_attention(q, k, v, lut, bq, bk)
    assert fa._sparse_flash_cuda.launches == before + 1
    _close(got, fa.sparse_flash_attention_plain(q, k, v, lut, bq, bk))


K3_CASES = ["ragged kv_len", "LUT ids out of range, a row with no live chunk",
            "batch 2", "qkv view", "40 heads", "NaN tail"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_CASES)
@pytest.mark.parametrize("bq,bk", [(512, 256), (128, 128)])
def test_k3_wgmma_form_matches_plain(dev, bq, bk, case):
    """K3's wgmma form (K4's kernel walking the LUT) against its plain
    version, Lq 1,100 (a ragged last tile): kv_len 900 of 1,100 keys (the
    LUT's last block wholly past it); LUT entries -1 and nK + 3 in every row
    and a row whose only live id names a block past kv_len (zero rows); batch
    2; q, k, v column groups of a fused QKV buffer; 40 heads (Lq 600); NaN in
    k and v past kv_len (held against the plain version on the live keys)."""
    B = 2 if case == "batch 2" else 1
    H = 40 if case == "40 heads" else HEADS
    L = 600 if case == "40 heads" else 1100
    kv_len = L if case in ("batch 2", "qkv view", "40 heads") else 900
    if case == "qkv view":
        qkv = _randn(dev, 1, L, 3 * H * DH, seed=81).bfloat16()
        q, k, v = (qkv[..., i * H * DH:(i + 1) * H * DH].unflatten(-1, (H, DH))
                   for i in range(3))
    else:
        q, k, v = (_randn(dev, B, L, H, DH, seed=s).bfloat16() for s in (82, 83, 84))
    nQ, nK = -(-L // bq), -(-L // bk)
    sel = nK // 2 + 2
    r = np.random.RandomState(85)
    a = np.stack([r.permutation(nK)[:sel] for _ in range(B * H * nQ)]).reshape(
        B, H, nQ, sel).astype(np.int32)
    if case.startswith("LUT"):
        a[..., 0], a[..., 1] = -1, nK + 3
        a[0, 0, 0] = -1
        a[0, 0, 0, 0] = nK - 1             # starts at or past kv_len: no live chunk
        assert (nK - 1) * bk >= kv_len
    lut = torch.from_numpy(a).to(dev)
    assert fa.sparse_flash_form(bq, bk, kv_len, *fa._strides(q, k, v)) == "wgmma"
    want_k, want_v = k, v
    if case == "NaN tail":
        want_k, want_v = k[:, :kv_len], v[:, :kv_len]
        k, v = k.clone(), v.clone()
        k[:, kv_len:], v[:, kv_len:] = float("nan"), float("nan")
    before = fa._sparse_flash_cuda.launches
    got = fa.sparse_flash_attention(q, k, v, lut, bq, bk, kv_len=kv_len)
    assert fa._sparse_flash_cuda.launches == before + 1
    want = fa.sparse_flash_attention_plain(q, want_k, want_v, lut, bq, bk, kv_len=kv_len)
    _close(got, want)
    if case.startswith("LUT"):
        assert torch.equal(got[0, :bq, 0], torch.zeros_like(got[0, :bq, 0]))


@pytest.mark.cuda
@pytest.mark.parametrize("Lk,form", [(77, "plain"), (512, "plain"), (1100, "plain"),
                                     (512, "batch 2"), (1100, "ragged kv_len"),
                                     (300, "qkv view"), (300, "40 heads")])
def test_k4_matches_plain(dev, Lk, form):
    """K4 against its plain version: Lq 1,100 over Lk keys; at batch 2; Lq
    1,000 over kv_len 900 of 1,100 keys; q, k, v read in place as the column
    groups of a fused (1, L, 3 x 256) QKV buffer; 40 heads."""
    B = 2 if form == "batch 2" else 1
    H = 40 if form == "40 heads" else HEADS
    Lq = 1000 if form == "ragged kv_len" else 1100
    kv_len = 900 if form == "ragged kv_len" else Lk
    if form == "qkv view":
        qkv = _randn(dev, 1, Lk, 3 * H * DH, seed=8).bfloat16()
        q, k, v = (qkv[..., i * H * DH:(i + 1) * H * DH].unflatten(-1, (H, DH))
                   for i in range(3))
    else:
        q = _randn(dev, B, Lq, H, DH, seed=8).bfloat16()
        k, v = (_randn(dev, B, Lk, H, DH, seed=s).bfloat16() for s in (9, 10))
    before = fa._flash_cuda.launches
    got = fa.flash_attention(q, k, v, kv_len=kv_len)
    assert fa._flash_cuda.launches == before + 1
    _close(got, fa.flash_attention_plain(q, k, v, kv_len=kv_len))


@pytest.mark.cuda
def test_garbage_tail_cannot_change_the_kernel_output(dev):
    """K/V rows at or past kv_len never reach the softmax in K3 or K4."""
    kv_len, Lp, bq, bk = 1000, 1024, 512, 256
    q, k, v = (_randn(dev, 1, Lp, HEADS, DH, seed=s).bfloat16() for s in (11, 12, 13))
    _, lut, _ = get_block_map(q, k[:, :kv_len], 0.5, bq, bk)
    pk, pv = k.clone(), v.clone()
    pk[:, kv_len:], pv[:, kv_len:] = 1e4, -1e4
    torch.testing.assert_close(
        fa.sparse_flash_attention(q, pk, pv, lut, bq, bk, kv_len=kv_len),
        fa.sparse_flash_attention(q, k[:, :kv_len], v[:, :kv_len], lut, bq, bk))
    torch.testing.assert_close(
        fa.flash_attention(q, pk, pv, kv_len=kv_len),
        fa.flash_attention(q, k[:, :kv_len], v[:, :kv_len]))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """No silent fallback: an fp32 or head-dim-64 CUDA tensor raises."""
    q = _randn(dev, 1, 64, HEADS, DH)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)                      # fp32
    q64 = _randn(dev, 1, 64, HEADS, 64).bfloat16()
    with pytest.raises(ValueError):
        fa.flash_attention(q64, q64, q64)                # head dim 64
    with pytest.raises(ValueError):
        fn.modulated_layer_norm(_randn(dev, 1, 8, DIM))  # fp32
    qs = torch.zeros(1, 64, HEADS, DH + 4, dtype=torch.bfloat16, device=dev)[..., :DH]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(qs, qs, qs)                   # heads 132 channels apart
    xq = torch.zeros(8, 128, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="int8"):
        qt.int8_block_matmul(xq.bfloat16(), torch.ones(1, 1, device=dev), xq,
                             torch.ones(1, 1, device=dev))


@pytest.mark.cuda
def test_k4_k22_entries_refuse_what_they_cannot_compute(dev):
    """tdx_flash_attention returns cudaErrorInvalidValue (1) for a stride
    off 16 bytes (a TMA map cannot hold it) and tdx_int8_gemm_block for K or
    N off 128 (a K tile is one quant block), and neither launches."""
    from turbodiffusion_tpu_torch.ops import _build
    lib = _build.load()
    q = torch.zeros(1, 64, HEADS, DH, dtype=torch.bfloat16, device=dev)
    o = torch.full_like(q, float("nan"))
    st = [q.stride(0), q.stride(1), q.stride(2)]
    bad = [q.stride(0), q.stride(1), q.stride(2) + 4]
    rc = lib.tdx_flash_attention(q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(),
                                 1, HEADS, 64, 64, *bad, *st, *st, *st, 0.1,
                                 _build.stream_ptr(q))
    assert rc == 1
    a = torch.zeros(8, 192, dtype=torch.int8, device=dev)
    out = torch.full((8, 256), float("nan"), device=dev)
    s = torch.ones(2, 2, device=dev)
    for K, N in ((192, 256), (128, 192)):
        rc = lib.tdx_int8_gemm_block(a.data_ptr(), a.data_ptr(), s.data_ptr(), s.data_ptr(),
                                     None, out.data_ptr(), 1, 8, N, K, _build.stream_ptr(a))
        assert rc == 1
    torch.cuda.synchronize()
    assert bool(o.isnan().all()) and bool(out.isnan().all())


def _int8_close(got, want):
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    assert int((got.int() - want.int()).abs().max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["q", "k", "v"])
def test_k5_matches_plain(dev, form):
    """K5's three call forms of the fused path, L = 1000 padded to 1024."""
    L, Lp = 1000, 1024
    x = _randn(dev, 1, L, DIM, seed=20).bfloat16()
    w = (1 + _randn(dev, DIM, seed=21, std=0.1)).bfloat16()
    cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 20, 26, DH, device=dev))
    kw = {"q": dict(weight=w, cos_full=cos, sin_full=sin, pool=512,
                    quant=True, bf16_out=False),
          "k": dict(weight=w, cos_full=cos, sin_full=sin, pool=256),
          "v": dict()}[form]
    before = sf._head_planes_cuda.launches
    got = sf.head_planes(x, num_heads=HEADS, eps=1e-6, pad_to=Lp, **kw)
    assert sf._head_planes_cuda.launches == before + 1
    want = sf.head_planes_plain(x, num_heads=HEADS, eps=1e-6, pad_to=Lp, **kw)
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "i8":
            _int8_close(got[key], want[key])
        elif key == "bf16":
            _close(got[key], want[key])
        else:
            torch.testing.assert_close(got[key], want[key], atol=1e-5, rtol=2e-2)


def _k5_close(got, want):
    """K5's outputs: int8 within 1 LSB, bf16 planes one bf16 step, scales
    and pooled means atol 1e-5 + rtol 2e-2 (a one-ulp RMS can move a bf16
    step of the normed row, and so a head's absmax)."""
    got = {k: t for k, t in got.items() if k != "rms_inv"}
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "i8":
            _int8_close(got[key], want[key])
        elif key == "bf16":
            _close(got[key], want[key])
        else:
            torch.testing.assert_close(got[key], want[key], atol=1e-5, rtol=2e-2)


def _k5_want(x, got, H, Lp, **kw):
    """K5's plain version for `got`, a launch with the row's own RMS: the
    statistic the kernel took (`rms_inv`, with a norm) against the plain
    one at rtol 1e-5, and the transform's plain version fed it. The plain
    version's RMS sums in another order, and one ulp of it can move a bf16
    step of the normed row, which RoPE's cancellation turns into two int8
    steps of an output (seen once in 167M values at the 14B's Q)."""
    ri = got.get("rms_inv")
    if ri is not None:
        torch.testing.assert_close(ri, sf.row_rms_inv_plain(x, 1e-6), rtol=1e-5, atol=0)
    return sf.head_planes_plain(x, num_heads=H, eps=1e-6, pad_to=Lp, rms_inv=ri, **kw)


def _k5_into_poison(x, H, Lp, w=None, cos=None, sin=None, pool=0, quant=False,
                    bf16_out=True):
    """K5 through its C entry into outputs prefilled with NaN (int8 with
    -128, which the kernel never writes), after checking that the entry and
    `sf.head_planes_form` give the launch the warp-per-row form; with a norm
    weight the output holds the rows' statistic too ("rms_inv")."""
    from turbodiffusion_tpu_torch.ops import _build
    lib = _build.load()
    B, L, HD = x.shape
    ld, dev, nan = x.stride(1), x.device, float("nan")
    out, partial, counters, nP = {}, None, None, 0
    if bf16_out:
        out["bf16"] = torch.full((B, H, Lp, DH), nan, dtype=torch.bfloat16, device=dev)
    if quant:
        out["i8"] = torch.full((B, H, Lp, DH), -128, dtype=torch.int8, device=dev)
        out["scale"] = torch.full((B, H, Lp), nan, device=dev)
    if pool:
        nP = -(-L // pool)
        out["pooled"] = torch.full((B, H, nP, DH), nan, device=dev)
        partial = torch.full((B, Lp // 64, HD), nan, device=dev)
        counters = torch.zeros((B, Lp // pool), dtype=torch.int32, device=dev)
    ptrs = [_ptr(t) for t in (x, w, cos, sin, out.get("bf16"), out.get("i8"), partial)]
    assert sf.head_planes_form(H, ld, *ptrs) == "vector"
    assert lib.tdx_head_planes_form(*ptrs, ld, H) == 1
    if w is not None:
        out["rms_inv"] = torch.full((B, L, 1), nan, device=dev)
    assert lib.tdx_head_planes(
        x.data_ptr(), _ptr(w), None, _ptr(cos), _ptr(sin), _ptr(out.get("bf16")),
        _ptr(out.get("i8")), _ptr(out.get("scale")), _ptr(partial),
        _ptr(out.get("pooled")), _ptr(counters), _ptr(out.get("rms_inv")), ld, B, L,
        Lp, H, pool, nP, 1e-6, _build.stream_ptr(x)) == 0
    torch.cuda.synchronize()
    if quant:
        assert bool((out["i8"] != -128).all())
    return out


# K5's call forms: the fused path's Q (int8, pooled at block_q) and K (bf16,
# pooled at block_k) passes, every output at pool 128, V bf16 (v_quant
# "channel") and V int8 with per-row scales (v_quant "row")
K5_CASES = {"q": dict(pool=512, quant=True, bf16_out=False, norm=True),
            "k": dict(pool=256, quant=False, bf16_out=True, norm=True),
            "all, pool 128": dict(pool=128, quant=True, bf16_out=True, norm=True),
            "v": dict(pool=0, quant=False, bf16_out=True, norm=False),
            "v row": dict(pool=0, quant=True, bf16_out=True, norm=False)}


def _k5_case(dev, heads, case, B=1, seed=120):
    """(x, kwargs of head_planes) of a K5 case, L = 1000: x contiguous at
    batch B, or the K column group of a fused (B, L, 3 H 128) QKV output."""
    L, HD = 1000, heads * DH
    x = _randn(dev, B, L, HD, seed=seed).bfloat16()
    c = K5_CASES[case]
    kw = dict(pool=c["pool"], quant=c["quant"], bf16_out=c["bf16_out"])
    if c["norm"]:
        cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 20, 26, DH, device=dev))
        kw.update(weight=(1 + _randn(dev, HD, seed=seed + 1, std=0.1)).bfloat16(),
                  cos_full=cos, sin_full=sin)
    return x, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K5_CASES))
@pytest.mark.parametrize("heads", [12, 40])
def test_k5_vector_form_matches_plain(dev, heads, case):
    """K5's warp-per-row kernel at the 1.3B's 12 and the 14B's 40 heads (one
    warp a row, four), the row's RMS its own, in each call form, L = 1,000
    padded to 1,024 (rows past L: a zero row's planes), into poisoned
    outputs; through the wrapper too (one launch)."""
    x, kw = _k5_case(dev, heads, case)
    Lp = 1024
    got = _k5_into_poison(x, heads, Lp, kw.get("weight"), kw.get("cos_full"),
                          kw.get("sin_full"), kw["pool"], kw["quant"], kw["bf16_out"])
    want = _k5_want(x, got, heads, Lp, **kw)
    _k5_close(got, want)
    before = sf._head_planes_cuda.launches
    again = sf.head_planes(x, num_heads=heads, eps=1e-6, pad_to=Lp, **kw)
    assert sf._head_planes_cuda.launches == before + 1
    for key in want:
        assert torch.equal(again[key], got[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["q", "k", "v row"])
@pytest.mark.parametrize("heads", [12, 40])
def test_k5_vector_form_on_a_qkv_group_at_batch_2(dev, heads, case):
    """Batch 2, x the K column group of a fused (2, L, 3 H 128) QKV output
    (rows 3 H 128 apart, batches L rows apart): each batch's planes and
    pooled means against the plain version, and two runs bit-equal (the
    pooled means are summed in a fixed order)."""
    L, Lp, HD = 1000, 1024, heads * DH
    qkv, kw = _k5_case(dev, 3 * heads, case, B=2, seed=130)
    x = qkv[..., HD:2 * HD]
    if "weight" in kw:
        kw["weight"] = kw["weight"][:HD]
    assert not x.is_contiguous() and x.stride(0) == L * x.stride(1)
    got = sf._head_planes_cuda(x, kw.get("weight"), kw.get("cos_full"), kw.get("sin_full"),
                               heads, 1e-6, kw["pool"], kw["quant"], kw["bf16_out"], Lp,
                               rms_out="weight" in kw)
    _k5_close(got, _k5_want(x, got, heads, Lp, **kw))
    twice = sf.head_planes(x, num_heads=heads, eps=1e-6, pad_to=Lp, **kw)
    for key in twice:
        assert torch.equal(got[key], twice[key]), key


@pytest.mark.cuda
def test_k5_k12_form_functions_agree_with_the_c_entries(dev):
    """`sf.head_planes_form` and `fn.mln_quant_form` give the form the C
    queries name (K5: 1 the warp-per-row kernel, 0 refused; K12: 1 the
    warp-per-row kernel, 0 the block-per-row one), over heads, row strides
    and pointer offsets (the queries read pointers as numbers only)."""
    from turbodiffusion_tpu_torch.ops import _build
    lib = _build.load()
    base = 1 << 20
    for H in (1, 12, 40, 64, 65):
        for ld in (H * DH, 3 * H * DH, H * DH + 4, H * DH - 8):
            for off in (0, 2, 16, 3072):
                for other in (None, base, base + 4):
                    ptrs = [base + off, other, other, other, base, None, base]
                    assert (sf.head_planes_form(H, ld, *ptrs) == "vector") == bool(
                        lib.tdx_head_planes_form(*ptrs, ld, H)), (H, ld, off, other)
    for D in (8, 1536, 1540, 5120, 8192, 8200):
        for off in (0, 2, 8, 16):
            for opt in (None, base + 4096):
                ptrs = [base + off, base, opt, opt, base + 64, None]
                assert (fn.mln_quant_form(D, *ptrs) == "vector") == bool(
                    lib.tdx_modulated_layer_norm_quant_form(*ptrs, D)), (D, off, opt)


def _kv_sums_exact(k, vi, L):
    """K6's kv and ksum over the rows < L, summed in float64: the exact
    sums, which no fp32 order of summation favours."""
    valid = (torch.arange(k.shape[2], device=k.device) < L)[:, None]
    pk = torch.where(valid, sf._softmax_d(k.double()), 0.0)
    return torch.matmul(pk.transpose(-1, -2), vi.double()), pk.sum(2, keepdim=True)


def _assert_kv_sums(got, plain, exact):
    """kv and ksum finite, at rtol 1e-4 / atol 1e-4 of the float64 sums, and
    at rtol 1e-4 of the fp32 plain version with atol 1e-4 plus the plain
    version's own largest distance from the float64 sums (its fp32 sums
    run in another order than the kernel's)."""
    for g_, p_, e_ in zip(got, plain, exact):
        assert bool(torch.isfinite(g_).all())
        torch.testing.assert_close(g_.double(), e_, rtol=1e-4, atol=1e-4)
        own = float((p_.double() - e_).abs().max())
        torch.testing.assert_close(g_, p_, rtol=1e-4, atol=1e-4 + own)


@pytest.mark.cuda
@pytest.mark.parametrize("linear_kv", [False, True])
def test_k6_matches_plain(dev, linear_kv):
    """Two linear-kv partial chunks (L = 3000) and a poisoned K tail that must
    stay out of the last block's statistic; kv and ksum as
    `_assert_kv_sums` holds them."""
    L, Lp, bk = 3000, 3072, 256
    k = _randn(dev, 1, HEADS, Lp, DH, seed=22).bfloat16()
    k[:, :, L:] = 1e4
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi = torch.from_numpy(np.random.RandomState(23).randint(
        -127, 128, (1, HEADS, Lp, DH)).astype(np.int8)).to(dev)
    before = sf._subquant_pack_kvt_cuda.launches
    got = sf.subquant_pack_kvt(k, mu, vi, bk, kv_len=L, linear_kv=linear_kv)
    assert sf._subquant_pack_kvt_cuda.launches == before + 1
    want = sf.subquant_pack_kvt_plain(k, mu, vi, bk, L, linear_kv)
    _int8_close(got[0], want[0])
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    if linear_kv:
        _assert_kv_sums(got[3:], want[3:], _kv_sums_exact(k, vi, L))


def _k6_operands(dev, B, heads, L, Lp, seed, tail):
    """K planes with a non-zero mean, per-channel int8 V and mu over the live
    rows; rows past L hold `tail` (K5 leaves zeros there; a poison must stay
    out of the statistic and the linear sums)."""
    k = (_randn(dev, B, heads, Lp, DH, seed=seed)
         + _randn(dev, B, heads, 1, DH, seed=seed + 1)).bfloat16()
    k[:, :, L:] = tail
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi = torch.from_numpy(np.random.RandomState(seed + 2).randint(
        -127, 128, (B, heads, Lp, DH)).astype(np.int8)).to(dev)
    return k, mu, vi


K6_CASES = {"L 1000 of 1024": (1, 1000, 1024, 0.0), "L 3000, runs": (1, 3000, 3072, 0.0),
            "NaN past kv_len": (1, 3000, 3072, float("nan")),
            "batch 2": (2, 1000, 1024, 1e4)}


@pytest.mark.cuda
@pytest.mark.parametrize("linear_kv", [False, True])
@pytest.mark.parametrize("bk", [64, 128, 256])
@pytest.mark.parametrize("case", list(K6_CASES))
@pytest.mark.parametrize("heads", [12, 40])
def test_k6_one_pass_matches_plain(dev, heads, case, bk, linear_kv):
    """K6's one walk over K and V (`k6::pack_kvt_kernel`, the reduce of its
    runs' partials with linear_kv) at the path's head counts: int8 K within
    1 LSB on the live rows (every row where the tail is finite), the V panel
    and the block scales exact, kv and ksum as `_assert_kv_sums` holds them
    and bit-equal over two runs; a NaN tail leaves ks, kv and ksum finite."""
    B, L, Lp, tail = K6_CASES[case]
    k, mu, vi = _k6_operands(dev, B, heads, L, Lp, 130 + heads + bk, tail)
    before = sf._subquant_pack_kvt_cuda.launches
    got = sf.subquant_pack_kvt(k, mu, vi, bk, kv_len=L, linear_kv=linear_kv)
    assert sf._subquant_pack_kvt_cuda.launches == before + 1
    want = sf.subquant_pack_kvt_plain(k, mu, vi, bk, L, linear_kv)
    rows = slice(None) if tail == tail else slice(0, L)   # NaN rows: garbage
    _int8_close(got[0][:, :, rows], want[0][:, :, rows])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    if linear_kv:
        _assert_kv_sums(got[3:], want[3:], _kv_sums_exact(k, vi, L))
        again = sf.subquant_pack_kvt(k, mu, vi, bk, kv_len=L, linear_kv=True)
        assert torch.equal(again[3], got[3]) and torch.equal(again[4], got[4])


@pytest.mark.cuda
def test_k6_grid_matches_the_c_query(dev):
    """`sf.kvt_grid` gives the blocks the C query launches with the linear
    branch (one block an SM: `__launch_bounds__(512, 1)` and ~217 KB of
    shared memory at block_k 256; as many waves as keep the runs to
    `_KVT_MAX_RUN` K blocks), and 0 for a shape the entry refuses."""
    from turbodiffusion_tpu_torch.ops import _build
    lib = _build.load()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, H, Lp, bk in [(1, 12, 32768, 256), (1, 40, 32768, 256), (1, 40, 75776, 256),
                         (2, 40, 32768, 256), (1, 2, 1024, 256), (1, 12, 3072, 64),
                         (4, 40, 1024, 128), (1, 12, 32768, 128)]:
        assert lib.tdx_subquant_pack_kvt_grid(B, H, Lp, bk, 1) == sf.kvt_grid(
            B, H, Lp, bk, n_sm), (B, H, Lp, bk)
    for B, H, Lp, bk in [(1, 12, 1024, 320), (1, 12, 1000, 256), (1, 12, 1024, 96),
                         (0, 12, 1024, 256)]:
        assert lib.tdx_subquant_pack_kvt_grid(B, H, Lp, bk, 1) == 0


def _k7_operands(dev, L, Lp, bq, bk, seed):
    r = np.random.RandomState(seed)
    qi, qs = sf._quant_rows(_randn(dev, 1, HEADS, Lp, DH, seed=seed))
    k = _randn(dev, 1, HEADS, Lp, DH, seed=seed + 1).bfloat16()
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi, vcs = si8.quantize_v_per_channel(
        _randn(dev, 1, HEADS, Lp, DH, seed=seed + 2).bfloat16(), L)
    kp, vtp, ks, kv, ksum = sf.subquant_pack_kvt_plain(k, mu, vi, bk, L, True)
    nQ, nK = -(-L // bq), -(-L // bk)
    sel = max(1, nK // 2)
    lut = torch.from_numpy(np.stack([r.permutation(nK)[:sel]
                                     for _ in range(HEADS * nQ)])
                           .reshape(1, HEADS, nQ, sel).astype(np.int32)).to(dev)
    lin = dict(lin_kvw=torch.matmul(kv * vcs, _randn(dev, DH, DH, seed=seed + 3,
                                                      std=0.03)),
               lin_ks_bias=torch.cat([ksum, _randn(dev, 1, HEADS, 1, DH,
                                                   seed=seed + 4, std=0.1)], 2))
    return (qi, qs, kp, vtp, ks, vcs, lut), lin


@pytest.mark.cuda
@pytest.mark.parametrize("lin", [False, True])
@pytest.mark.parametrize("L,Lp,bq,bk", [(1000, 1024, 512, 256),
                                        (520, 1024, 128, 128),
                                        (3000, 3072, 256, 128),
                                        (16200, 16384, 512, 256)])
def test_k7_matches_plain(dev, L, Lp, bq, bk, lin):
    """Blocks 512/256 and 128/128 (one 128-key chunk a block), Q blocks of
    two 128-row blocks at 128-key K blocks, and 32 of 64 K blocks of 256
    (sel x block_k = 8,192 keys a row, 64 chunks through the 3-stage
    ring)."""
    args, lin_kw = _k7_operands(dev, L, Lp, bq, bk, seed=30)
    kw = dict(block_q=bq, block_k=bk, kv_len=L, **(lin_kw if lin else {}))
    before = si8._sparse_i8_vt_cuda.launches
    got = si8.sparse_attention_i8_vt(*args, **kw)
    assert si8._sparse_i8_vt_cuda.launches == before + 1
    _close(got, si8.sparse_attention_i8_vt_plain(*args, **kw))


@pytest.mark.cuda
def test_k7_poisoned_tail_cannot_change_live_rows(dev):
    """int8 K / V rows past kv_len set to +127 change no row before kv_len."""
    L, Lp, bq, bk = 1000, 1024, 128, 128
    (qi, qs, kp, vtp, ks, vcs, lut), _ = _k7_operands(dev, L, Lp, bq, bk, 40)
    lut = torch.arange(Lp // bk, dtype=torch.int32, device=dev).expand(
        1, HEADS, Lp // bq, Lp // bk).contiguous()
    kw = dict(block_q=bq, block_k=bk, kv_len=L)
    clean = si8.sparse_attention_i8_vt(qi, qs, kp, vtp, ks, vcs, lut, **kw)
    pk, pv = kp.clone(), vtp.clone()
    pk[:, :, L:] = 127
    pv[:, :, -1, :, L % bk:] = 127
    poisoned = si8.sparse_attention_i8_vt(qi, qs, pk, pv, ks, vcs, lut, **kw)
    assert torch.equal(clean[:, :, :L], poisoned[:, :, :L])


@pytest.mark.cuda
def test_fused_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """No silent fallback: an fp32 or head-dim-64 CUDA tensor raises; K7
    refuses blocks of 64 rows (its tiles are 128 rows and 128 keys) without
    a launch, and its C entry refuses them too (a CUDA error, nothing
    runs)."""
    from turbodiffusion_tpu_torch.ops import _build
    with pytest.raises(ValueError):
        sf.head_planes(_randn(dev, 1, 64, DIM), num_heads=HEADS)   # fp32
    with pytest.raises(ValueError):
        sf.head_planes(_randn(dev, 1, 64, 128).bfloat16(), num_heads=2)
    (qi, qs, kp, vtp, ks, vcs, lut), _ = _k7_operands(dev, 250, 256, 64, 128, 31)
    before = si8._sparse_i8_vt_cuda.launches
    with pytest.raises(ValueError, match="multiple of 128"):
        si8.sparse_attention_i8_vt(qi, qs, kp, vtp, ks, vcs, lut, block_q=64,
                                   block_k=128, kv_len=250)
    assert si8._sparse_i8_vt_cuda.launches == before
    out = torch.empty(1, HEADS, 256, DH, dtype=torch.bfloat16, device=dev)
    assert _build.load().tdx_sparse_attention_i8_vt(
        qi.data_ptr(), qs.data_ptr(), kp.data_ptr(), vtp.data_ptr(), ks.data_ptr(),
        vcs.data_ptr(), lut.data_ptr(), None, None, out.data_ptr(), 1, HEADS, 256,
        256, 250, 4, lut.shape[-1], 64, 128, 1.0, _build.stream_ptr(qi)) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 2])
def test_k2_k5_read_a_fused_qkv_column_group_in_place(dev, group):
    """K2 and K5 read Q, K or V as a column group of one (B, L, 3*D) GEMM
    output (rows 3*D apart): the same output as from a contiguous copy."""
    L, Lp = 1000, 1024
    qkv = _randn(dev, 1, L, 3 * DIM, seed=50).bfloat16()
    x = qkv.split(DIM, -1)[group]
    assert not x.is_contiguous()
    w = (1 + _randn(dev, DIM, seed=51, std=0.1)).bfloat16()
    cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 20, 25, DH, device=dev))
    assert torch.equal(fn.rmsnorm_rope(x, w, cos, sin, num_heads=HEADS),
                       fn.rmsnorm_rope(x.contiguous(), w, cos, sin,
                                       num_heads=HEADS))
    kw = dict(weight=w, cos_full=cos, sin_full=sin, pool=256, num_heads=HEADS,
              eps=1e-6, pad_to=Lp)
    got = sf.head_planes(x, **kw)
    want = sf.head_planes(x.contiguous(), **kw)
    for key in want:
        assert torch.equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# K8-K11: the W8A8 linears (tolerances: int8 within 1 LSB, fp32 scales rtol
# 1e-5 for tanhf / torch.tanh ulps before an amax, bf16 outputs as above)
# ---------------------------------------------------------------------------

def _i8(dev, *shape, seed):
    a = np.random.RandomState(seed).randint(-127, 128, shape).astype(np.int8)
    return torch.from_numpy(a).to(dev)


def _scales(dev, n, seed):
    return _randn(dev, n, seed=seed, std=0.01).abs() + 1e-3


def _scales_close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,stride", [(200, 256, 256), (512, 1536, 1536),
                                        (300, 256, 768)])
def test_k8_matches_plain(dev, M, K, stride):
    """Rows of a contiguous activation and of a column group (stride 768)."""
    x = (3 * _randn(dev, M, stride, seed=60)).bfloat16()[:, :K]
    before = qt._quantize_rows_cuda.launches
    q, s = qt.quantize_rows_int8(x)
    assert qt._quantize_rows_cuda.launches == before + 1
    want_q, want_s = qt.quantize_rows_int8_plain(x)
    _int8_close(q, want_q)
    _scales_close(s, want_s)


# K9's shapes beside the first four cases' M = 200, K = 512, N = 384 (N / 128
# odd: one block a cluster): a ragged M with K = 192 (a half-zero last K
# tile) and pairs of blocks sharing the activation tile, M = 1, K = 64 (one
# K tile, half zeros), and M = 4000 x N 4608 (576 tile pairs, more than the
# card holds at once: each block walks several tiles, both consumers and the
# ring turning across tiles)
_K9_SHAPES = {"ragged_k192": (1000, 192, 1536), "one_row_k64": (1, 64, 256),
              "persistent": (4000, 1536, 4608)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tail", "bias", "gelu", "gate_residual",
                                  "ragged_k192", "one_row_k64", "persistent"])
def test_k9_matches_plain(dev, case):
    """M = 200 (a tail of 72 rows past the last full 128-row tile), then
    the shapes of _K9_SHAPES with bias, gate and residual."""
    M, K, N = _K9_SHAPES.get(case, (200, 512, 384))
    xq, wq = _i8(dev, M, K, seed=61), _i8(dev, N, K, seed=62)
    rs, cs = _scales(dev, M, 63)[:, None], _scales(dev, N, 64)
    bias = _randn(dev, N, seed=65).bfloat16() if case != "tail" else None
    act = "gelu_tanh" if case == "gelu" else None
    gr = case not in ("tail", "bias", "gelu")
    gate = _randn(dev, N, seed=66) if gr else None
    res = _randn(dev, M, N, seed=67).bfloat16() if gr else None
    before = qt._int8_gemm_postscale_cuda.launches
    got = qt.int8_gemm_postscale(xq, rs, wq, cs, bias, act, gate, res)
    assert qt._int8_gemm_postscale_cuda.launches == before + 1
    _close(got, qt.int8_gemm_postscale_plain(xq, rs, wq, cs, bias, act, gate, res))


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(200, 768, 512), (200, 1536, 512),
                                   (1000, 1152, 256), (1000, 4096, 384),
                                   (1000, 1792, 1536)])
def test_k10_matches_plain(dev, M, N, K):
    """BN = 768 (a cluster of 6 blocks): one scale column, then two; a
    ragged M (1000 = 3 x 256 + 232 rows) at BN 384 (clusters of 3), 1024
    (clusters of 8) and 896 (7, the 1.3B's) with 12 K tiles, three turns
    of the 4-stage ring."""
    xq, wq = _i8(dev, M, K, seed=70), _i8(dev, N, K, seed=71)
    rs, cs = _scales(dev, M, 72)[:, None], _scales(dev, N, 73)
    bias = _randn(dev, N, seed=74).bfloat16()
    before = qt._int8_gemm_qout_cuda.launches
    q, s = qt.int8_gemm_postscale_qout(xq, rs, wq, cs, bias, act="gelu_tanh")
    assert qt._int8_gemm_qout_cuda.launches == before + 1
    want_q, want_s = qt.int8_gemm_postscale_qout_plain(xq, rs, wq, cs, bias,
                                                       act="gelu_tanh")
    assert s.shape == (M, N // qt.pick_bn_div(N))
    _int8_close(q, want_q)
    _scales_close(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,bk,gate_residual", [
    (200, 384, 1536, 768, False), (200, 384, 1536, 768, True),
    (1000, 384, 768, 384, True), (1000, 512, 2048, 1024, True),
    (1000, 1536, 1792, 896, True)])
def test_k11_matches_plain(dev, M, N, K, bk, gate_residual):
    """bk = 768 over K = 1536: two slabs rescaled in order; M = 1000 (a
    40-row last tile) with slabs of 384, 1024 and 896 K; N / 128 odd (one
    block a cluster) and even (pairs sharing the activation tile)."""
    xq, wq = _i8(dev, M, K, seed=80), _i8(dev, N, K, seed=81)
    xs = _randn(dev, M, K // bk, seed=82, std=0.01).abs() + 1e-3
    cs, bias = _scales(dev, N, 83), _randn(dev, N, seed=84).bfloat16()
    gate = _randn(dev, N, seed=85) if gate_residual else None
    res = _randn(dev, M, N, seed=86).bfloat16() if gate_residual else None
    before = qt._int8_gemm_blockact_cuda.launches
    got = qt.int8_gemm_blockact(xq, xs, wq, cs, bias, bk=bk, gate=gate,
                                residual=res)
    assert qt._int8_gemm_blockact_cuda.launches == before + 1
    _close(got, qt.int8_gemm_blockact_plain(xq, xs, wq, cs, bias, bk=bk,
                                            gate=gate, residual=res))


@pytest.mark.cuda
def test_w8a8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """No silent fallback: N not a multiple of 128, K not of 64 (K10 / K11:
    of 128, and K11's slab), an fp32 activation, an N without a scale block
    or a K9 operand off 16-byte alignment raises without a launch; the K9,
    K10 and K11 C entries refuse the same shapes and K10 an N not a multiple
    of the scale block (a CUDA error, nothing runs)."""
    from turbodiffusion_tpu_torch.ops import _build
    xq = _i8(dev, 64, 256, seed=90)
    s = _scales(dev, 64, 91)[:, None]
    with pytest.raises(ValueError):
        qt.int8_gemm_postscale(xq, s, _i8(dev, 100, 256, seed=92),
                               _scales(dev, 100, 93))
    with pytest.raises(ValueError):
        qt.int8_gemm_postscale(xq[:, :200].contiguous(), s,
                               _i8(dev, 128, 200, seed=94), _scales(dev, 128, 95))
    with pytest.raises(ValueError):
        qt.quantize_rows_int8(_randn(dev, 64, 256))
    with pytest.raises(ValueError):
        qt.int8_gemm_postscale_qout(xq, s, _i8(dev, 256, 256, seed=96),
                                    _scales(dev, 256, 97))
    x192, w192 = _i8(dev, 64, 192, seed=98), _i8(dev, 768, 192, seed=99)
    x384, w384 = _i8(dev, 64, 384, seed=100), _i8(dev, 768, 384, seed=101)
    cs = _scales(dev, 768, 102)
    counts = (qt._int8_gemm_qout_cuda.launches, qt._int8_gemm_blockact_cuda.launches)
    for call in (lambda: qt.int8_gemm_postscale_qout(x192, s, w192, cs),
                 lambda: qt.int8_gemm_blockact(x192, s, w192, cs, bk=192),
                 lambda: qt.int8_gemm_blockact(x384, torch.ones(64, 2, device=dev),
                                               w384, cs, bk=192)):
        with pytest.raises(ValueError):
            call()
    assert (qt._int8_gemm_qout_cuda.launches,
            qt._int8_gemm_blockact_cuda.launches) == counts
    # K9: operands off the 16 bytes TMA reads from (a view one byte in)
    buf = _i8(dev, 64 * 256 + 16, seed=105)
    x_off = buf[1:1 + 64 * 256].view(64, 256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        qt.int8_gemm_postscale(x_off, s, _i8(dev, 128, 256, seed=106),
                               _scales(dev, 128, 107))
    lib, st = _build.load(), _build.stream_ptr(xq)
    # K9's C entry: N not a multiple of 128, K not of 64
    out9 = torch.empty(64, 256, dtype=torch.bfloat16, device=dev)
    w9 = _i8(dev, 256, 256, seed=108)
    for N, K in ((200, 256), (256, 96)):
        assert lib.tdx_int8_gemm_postscale(xq.data_ptr(), w9.data_ptr(), s.data_ptr(),
                                           cs.data_ptr(), None, None, None,
                                           out9.data_ptr(), 64, N, K, 0, st) != 0
    q = torch.empty(64, 1152, dtype=torch.int8, device=dev)
    sq = torch.empty(64, 2, device=dev)
    w1152, cs1152 = _i8(dev, 1152, 384, seed=103), _scales(dev, 1152, 104)
    out = torch.empty(64, 768, dtype=torch.bfloat16, device=dev)
    # N = 1152 with a 768 scale block; K = 192 (K10 and K11); a 192 slab
    assert lib.tdx_int8_gemm_qout(x384.data_ptr(), w1152.data_ptr(), s.data_ptr(),
                                  cs1152.data_ptr(), None, q.data_ptr(), sq.data_ptr(),
                                  64, 1152, 384, 768, 0, st) != 0
    assert lib.tdx_int8_gemm_qout(x192.data_ptr(), w192.data_ptr(), s.data_ptr(),
                                  cs.data_ptr(), None, q.data_ptr(), sq.data_ptr(),
                                  64, 768, 192, 768, 0, st) != 0
    for K, bk, a, w in ((192, 192, x192, w192), (384, 192, x384, w384)):
        assert lib.tdx_int8_gemm_blockact(a.data_ptr(), w.data_ptr(), s.data_ptr(),
                                          cs.data_ptr(), None, None, None,
                                          out.data_ptr(), 64, 768, K, bk, 0, st) != 0
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K12-K14: the int8 feeds of the W8A8 path (tolerances: int8 within 1 LSB;
# fp32 scales rtol 1e-5, K14's 5e-3 for fp32 sums in another order that move
# the bf16 rounding of a normed q or a P element)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mod", "affine"])
def test_k12_matches_plain(dev, mode):
    """norm1 / norm2 (modulated, int8 from fp32) and norm3 (affine)."""
    x = (2 * _randn(dev, 1, SEQ, DIM)).bfloat16()
    ms = _randn(dev, 1, DIM, seed=1, std=0.5) if mode == "mod" else None
    mb = _randn(dev, 1, DIM, seed=2, std=0.5) if mode == "mod" else None
    w = (1 + _randn(dev, DIM, seed=3, std=0.1)).bfloat16() if mode == "affine" else None
    b = _randn(dev, DIM, seed=4, std=0.1).bfloat16() if mode == "affine" else None
    before = fn._mln_quant_cuda.launches
    q, s = fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6, quant_out=True)
    assert fn._mln_quant_cuda.launches == before + 1
    want_q, want_s = fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6, quant_out=True)
    _int8_close(q, want_q)
    _scales_close(s, want_s)


def _k12_into_poison(x, ms, mb, w, b, form):
    """K12 through its C entry into an int8 output prefilled with -128 (which
    the kernel never writes) and NaN scales, after checking which form the
    entry and `fn.mln_quant_form` give the launch."""
    from turbodiffusion_tpu_torch.ops import _build
    lib = _build.load()
    B, L, D = x.shape
    q = torch.full((B, L, D), -128, dtype=torch.int8, device=x.device)
    s = torch.full((B, L, 1), float("nan"), device=x.device)
    ptrs = [_ptr(t) for t in (x, q, ms, mb, w, b)]
    assert fn.mln_quant_form(D, *ptrs) == form
    assert lib.tdx_modulated_layer_norm_quant_form(*ptrs, D) == (form == "vector")
    assert lib.tdx_modulated_layer_norm_quant(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                              *ptrs[2:], B * L, L, D, 1e-6,
                                              _build.stream_ptr(x)) == 0
    torch.cuda.synchronize()
    assert bool((q != -128).all()) and bool(s.isfinite().all())
    return q, s


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [32760, 1000])
@pytest.mark.parametrize("D", [1536, 5120])
@pytest.mark.parametrize("mode", ["mod", "affine"])
def test_k12_vector_form_writes_every_row(dev, mode, D, rows):
    """K12's warp-per-row kernel (int8 epilogue) at the 1.3B and 14B widths,
    modulated (norm1 / norm2) and affine (norm3), on 32,760 and 1,000 rows,
    into poisoned outputs, against its plain version; through the wrapper
    too (one launch, the same bits)."""
    x = (2 * _card_randn(dev, 1, rows, D, seed=70)).bfloat16()
    ms, mb, w, b = _k1_operands(dev, D, mode)
    want_q, want_s = fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6, quant_out=True)
    q, s = _k12_into_poison(x, ms, mb, w, b, "vector")
    _int8_close(q, want_q)
    _scales_close(s, want_s)
    before = fn._mln_quant_cuda.launches
    q2, s2 = fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6, quant_out=True)
    assert fn._mln_quant_cuda.launches == before + 1
    assert torch.equal(q2, q) and torch.equal(s2, s)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1536, 5120])
def test_k12_vector_form_at_batch_2_takes_each_batchs_modulation(dev, D):
    """Batch 2 with two different modulations: each batch's rows take its
    own (a block stages one batch's); batch 1's applied to batch 0 fails."""
    L = 1000
    x = (2 * _randn(dev, 2, L, D, seed=71)).bfloat16()
    ms, mb, _, _ = _k1_operands(dev, D, "mod", B=2, seed=72)
    want_q, want_s = fn.modulated_layer_norm_ref(x, ms, mb, eps=1e-6, quant_out=True)
    q, s = _k12_into_poison(x, ms, mb, None, None, "vector")
    _int8_close(q, want_q)
    _scales_close(s, want_s)
    wrong_q, wrong_s = fn.modulated_layer_norm_ref(x, ms[[1, 1]], mb[[1, 1]], eps=1e-6,
                                                   quant_out=True)
    with pytest.raises(AssertionError):
        _int8_close(wrong_q, want_q)
        _scales_close(wrong_s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width 1540", "unaligned view"])
def test_k12_loop_form_takes_what_the_vector_form_cannot(dev, case):
    """Shapes that take K12's block-per-row kernel: a width that is not a
    multiple of 8, a view 4 bytes off 16-byte alignment."""
    L, D = 300, 1540 if case == "width 1540" else 1536
    if case == "width 1540":
        x = (2 * _randn(dev, 1, L, D, seed=73)).bfloat16()
    else:
        x = (2 * _randn(dev, L * D + 2, seed=73)).bfloat16()[2:].view(1, L, D)
    ms, mb, _, _ = _k1_operands(dev, D, "mod")
    want_q, want_s = fn.modulated_layer_norm_ref(x, ms, mb, eps=1e-6, quant_out=True)
    q, s = _k12_into_poison(x, ms, mb, None, None, "loop")
    _int8_close(q, want_q)
    _scales_close(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("quant_out", [False, True])
def test_k1_k12_at_batch_2_with_the_blocks_modulation(dev, quant_out):
    """Batch 2 with the modulation as WanAttentionBlock passes it: column
    views of one (B, 6, D) tensor, which the wrapper copies to (B, D). With
    L = D, K12's scale output is the size of that copy, so it would take the
    copy's memory if the wrapper freed the copy before the launch; three
    launches in a row must each agree with the plain version."""
    x = (2 * _randn(dev, 2, DIM, DIM)).bfloat16()
    e = _randn(dev, 2, 6, DIM, seed=1, std=0.5)
    ms, mb = e[:, 1:2], e[:, 0:1]
    want = fn.modulated_layer_norm_ref(x, ms, mb, eps=1e-6, quant_out=quant_out)
    for _ in range(3):
        got = fn.modulated_layer_norm(x, ms, mb, eps=1e-6, quant_out=quant_out)
        if quant_out:
            _int8_close(got[0], want[0])
            _scales_close(got[1], want[1])
        else:
            _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [2, 12])
def test_k13_matches_plain_bitwise(dev, heads):
    """L = 1000 live rows of 1024-row planes: K8's rule on the unfolded
    rows, bit for bit."""
    planes = (2 * _randn(dev, 1, heads, 1024, DH, seed=100)).bfloat16()
    before = sf._unfold_quant_cuda.launches
    q, s = sf.unfold_quant(planes, 1000)
    assert sf._unfold_quant_cuda.launches == before + 1
    want_q, want_s = sf.unfold_quant_plain(planes, 1000)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,Lk", [(2, 77), (3, 512), (12, 512), (24, 77),
                                      (40, 512)])
def test_k14_matches_plain(dev, heads, Lk):
    """One block of 2 or 3 heads a 64-row tile, clusters of 3, 6 and 8
    blocks (12 heads as 3 of 4, 24 as 6 of 4, 40 as 8 of 5); 77 keys mask
    most of the second 64-key chunk. Above 16 heads `cross_attention_qout`
    takes K17, so K14 is launched directly there."""
    HD = heads * DH
    q = _randn(dev, 1, 1100, HD, seed=101).bfloat16()
    k, v = (_randn(dev, 1, Lk, heads, DH, seed=s).bfloat16() for s in (102, 103))
    w = (1 + _randn(dev, HD, seed=104, std=0.2)).bfloat16()
    before = fa._cross_qout_cuda.launches
    got_q, got_s = (fa.cross_attention_qout(q, k, v, w) if heads <= 16 else
                    fa._cross_qout_cuda(q, k, v, w, DH ** -0.5, 1e-6))
    assert fa._cross_qout_cuda.launches == before + 1
    want_q, want_s = fa.cross_attention_qout_plain(q, k, v, w)
    _int8_close(got_q, want_q)
    torch.testing.assert_close(got_s, want_s, rtol=5e-3, atol=0)


def _qout_case(dev, heads, lq, seed, B=1, kv_len=512, ld=0, sharp=False):
    """(q, k, v, w) for K14 / K17: q (B, lq, heads x 128), a column slice
    of rows `ld` wide when ld > 0; sharp: each row one of 8 directions plus
    noise, and 8 keys spread over [0, kv_len) 12 x those directions normed,
    so one key dominates each row by ~136 in the logits."""
    HD = heads * DH
    w = (1 + _randn(dev, HD, seed=seed, std=0.1)).bfloat16()
    if sharp:
        d = _randn(dev, B, 8, HD, seed=seed + 1).bfloat16()
        x = (d[:, torch.arange(lq, device=dev) % 8]
             + _randn(dev, B, lq, HD, seed=seed + 2, std=0.05)).bfloat16()
    else:
        x = _randn(dev, B, lq, ld or HD, seed=seed + 1).bfloat16()
    k = _randn(dev, B, kv_len, heads, DH, seed=seed + 3).bfloat16()
    v = _randn(dev, B, kv_len, heads, DH, seed=seed + 4).bfloat16()
    if sharp:
        keys = torch.linspace(0, kv_len - 1, 8, device=dev).long()
        k[:, keys] = (12 * fn.rms_norm(d, w, 1e-6).float()).bfloat16().view(B, 8, heads, DH)
    return x[..., :HD], k, v, w


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [False, True], ids=["k14", "k17"])
@pytest.mark.parametrize("case", ["sharp", "ragged_kv300", "batch2_slice", "kv1100",
                                  "kv50"])
def test_k14_k17_edge_cases_match_plain(dev, ext, case):
    """K14 (12 heads) and K17 (40 heads, K15's RMS given) off the path's
    call: a sharp q (one key dominates each row, in either key half), a
    ragged Lq with kv_len 300 (not a multiple of the 64-key chunk), batch 2
    with q a column slice, kv_len 1100 (past the one-pass 512 keys: two
    passes) and kv_len 50 (one chunk: consumer 1 holds no key)."""
    heads = 40 if ext else 12
    kw = {"sharp": dict(lq=700, sharp=True), "ragged_kv300": dict(lq=333, kv_len=300),
          "batch2_slice": dict(lq=200, B=2, ld=3 * heads * DH),
          "kv1100": dict(lq=150, kv_len=1100), "kv50": dict(lq=100, kv_len=50)}[case]
    q, k, v, w = _qout_case(dev, heads, seed=150, **kw)
    if ext:
        ri = sf.row_rms_inv_plain(q, 1e-6)
        got = fa._cross_qout_wide_cuda(q, ri, k, v, w, DH ** -0.5)
        want = fa.cross_attention_qout_wide_plain(q, ri, k, v, w)
    else:
        got = fa._cross_qout_cuda(q, k, v, w, DH ** -0.5, 1e-6)
        want = fa.cross_attention_qout_plain(q, k, v, w)
    _int8_close(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=5e-3, atol=0)


@pytest.mark.cuda
def test_qout_shape_matches_the_kernels_launch(dev):
    """`qout_shape` (Python) and `tdx_cross_attention_qout_shape` (the
    launcher's own computation) agree for every head count of the paths and
    a long kv_len."""
    import ctypes
    from turbodiffusion_tpu_torch.ops import _build
    lib = _build.load()
    for heads in (1, 2, 5, 12, 16, 24, 40):
        for kv_len in (50, 300, 512, 1100):
            want = fa.qout_shape(heads, kv_len)
            out = (ctypes.c_int * 6)()
            assert lib.tdx_cross_attention_qout_shape(
                heads, want["heads_per_block"], kv_len, ctypes.addressof(out)) == 0
            assert list(out) == [want["cluster"], want["stages"], want["chunks"],
                                 want["consumer0_chunks"], want["smem"], want["q_buffers"]]


@pytest.mark.cuda
def test_int8_feed_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """No silent fallback: fp32 inputs, or 13 heads (no cluster of <= 8
    blocks with <= 5 heads each), raise."""
    with pytest.raises(ValueError):
        fn.modulated_layer_norm(_randn(dev, 1, 8, DIM), quant_out=True)
    with pytest.raises(ValueError):
        sf.unfold_quant(_randn(dev, 1, 2, 64, DH), 8)
    q13 = _randn(dev, 1, 64, 13 * DH).bfloat16()
    k13 = _randn(dev, 1, 77, 13, DH).bfloat16()
    with pytest.raises(ValueError):
        fa.cross_attention_qout(q13, k13, k13, torch.ones(13 * DH, device=dev))


# ---------------------------------------------------------------------------
# K15-K17 and the wide forms of K1, K5 and K12: the 14B's 5120-wide rows and
# 40 heads (tolerances as above; K15's fp32 sum of squares rtol 1e-5, another
# order; K16 bit for bit, the same fp32 division)
# ---------------------------------------------------------------------------

WIDE_HEADS = 40
WIDE = WIDE_HEADS * DH                            # 5120


@pytest.mark.cuda
@pytest.mark.parametrize("width,col_block", [(None, 0), (WIDE, 1)])
def test_k15_matches_plain(dev, width, col_block):
    """A 5120-wide row, and the second 5120-column block of a 15360-wide
    row read through `width` / `col_block`."""
    cols = WIDE if width is None else 3 * WIDE
    x = (2 * _randn(dev, 1, 300, cols, seed=110)).bfloat16()
    before = sf._row_rms_inv_cuda.launches
    got = sf.row_rms_inv(x, 1e-6, width=width, col_block=col_block)
    assert sf._row_rms_inv_cuda.launches == before + 1
    want = sf.row_rms_inv_plain(x, 1e-6, width=width, col_block=col_block)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["q", "k", "v"])
def test_k5_external_rms_at_40_heads_matches_plain(dev, form):
    """K5 at 40 heads, L = 1000 padded to 1024: Q and K with the row's RMS
    inverse from K15 (the external-RMS mode) and with the row's own, V
    without a norm."""
    L, Lp = 1000, 1024
    x = _randn(dev, 1, L, WIDE, seed=111).bfloat16()
    w = (1 + _randn(dev, WIDE, seed=112, std=0.1)).bfloat16()
    cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(2, 20, 26, DH, device=dev))
    ri = sf.row_rms_inv(x, 1e-6) if form != "v" else None
    kw = {"q": dict(weight=w, cos_full=cos, sin_full=sin, pool=512,
                    quant=True, bf16_out=False),
          "k": dict(weight=w, cos_full=cos, sin_full=sin, pool=256),
          "v": dict()}[form]
    before = sf._head_planes_cuda.launches
    got = sf.head_planes(x, num_heads=WIDE_HEADS, eps=1e-6, pad_to=Lp,
                         rms_inv=ri, **kw)
    assert sf._head_planes_cuda.launches == before + 1
    want = sf.head_planes_plain(x, num_heads=WIDE_HEADS, eps=1e-6, pad_to=Lp,
                                rms_inv=ri, **kw)
    assert sorted(got) == sorted(want)
    for key in got:
        if key == "i8":
            _int8_close(got[key], want[key])
        elif key == "bf16":
            _close(got[key], want[key])
        else:
            torch.testing.assert_close(got[key], want[key], atol=1e-5, rtol=2e-2)
    if form != "v":
        # without K15's statistic the kernel takes the row's own (four warps
        # a 5120-wide row)
        own = sf._head_planes_cuda(x, w, cos, sin, WIDE_HEADS, 1e-6, kw["pool"],
                                   kw.get("quant", False), kw.get("bf16_out", True), Lp,
                                   rms_out=True)
        _k5_close(own, _k5_want(x, own, WIDE_HEADS, Lp, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [33, WIDE_HEADS])
def test_k16_matches_plain_bitwise(dev, heads):
    """L = 1000 live rows of 1024-row planes at 4224 and 5120 wide: the wide
    rule y / scale, bit for bit."""
    planes = (2 * _randn(dev, 1, heads, 1024, DH, seed=113)).bfloat16()
    before = sf._unfold_quant_wide_cuda.launches
    q, s = sf.unfold_quant(planes, 1000)
    assert sf._unfold_quant_wide_cuda.launches == before + 1
    want_q, want_s = sf.unfold_quant_wide_plain(planes, 1000)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


def _near_half_pairs(n_amax=128):
    """(amax, [y, ...]) bf16 pairs whose fp32 quotient y / scale lies on a
    half-integer or within 2 ulps of one (scale = amax * (1/127) in fp32):
    where y * (1/scale) can round the other way."""
    u = np.arange(0x3F80, 0x4300, dtype=np.uint32)           # bf16 in [1, 128)
    vals = (u << 16).view(np.float32)
    c = np.float32(1) / np.float32(127)
    out = []
    # amax = 127 * 2^-e: scale = 2^-e exactly, so (k + 1/2) 2^-e are ties
    for a in np.concatenate([vals[::max(1, len(vals) // n_amax)],
                             np.float32(127) / np.float32([1, 2, 4, 8])]):
        s = np.float32(a * c)
        ys = vals[(vals <= a) & (vals >= a / 128)]
        q = (ys / s).astype(np.float32)
        d = np.abs(q - np.floor(q) - np.float32(0.5))
        hit = ys[d <= 2 * np.spacing(q)]
        if len(hit):
            out.append((float(a), [float(y) for y in hit]))
    return out


@pytest.mark.cuda
def test_k16_rounds_half_integers_as_the_division(dev):
    """K16 at 40 heads on rows built so that y / scale lands on and within
    two ulps of half-integers (each row's amax a bf16 value, its other
    values the bf16 y with such a quotient, both signs), a row whose amax is
    0, and random rows: int8 bit for bit and scales exact against the plain
    version's fp32 division."""
    L, Lp = 1000, 1024
    planes = (2 * _randn(dev, 1, WIDE_HEADS, Lp, DH, seed=117)).bfloat16()
    rows = planes.transpose(1, 2).reshape(1, Lp, WIDE)        # a view of copies
    pairs = _near_half_pairs()
    assert len(pairs) > 8
    built = torch.zeros(len(pairs) + 1, WIDE)
    for i, (a, ys) in enumerate(pairs):
        vals = torch.tensor(ys * (WIDE // len(ys) + 1))[:WIDE - 1]
        sign = torch.from_numpy(np.random.RandomState(i).randint(0, 2, WIDE - 1) * 2 - 1)
        built[i, 0] = a
        built[i, 1:] = vals * sign
    rows = rows.clone()
    rows[0, :len(pairs) + 1] = built.bfloat16().to(dev)       # the last: all zero
    planes = rows.reshape(1, Lp, WIDE_HEADS, DH).transpose(1, 2).contiguous()
    before = sf._unfold_quant_wide_cuda.launches
    q, s = sf.unfold_quant(planes, L)
    assert sf._unfold_quant_wide_cuda.launches == before + 1
    want_q, want_s = sf.unfold_quant_wide_plain(planes, L)
    assert torch.equal(s, want_s)
    assert torch.equal(q, want_q), int((q.int() - want_q.int()).abs().max())
    assert float(s[0, len(pairs), 0]) == float(np.float32(1e-8) * np.float32(1 / 127))


@pytest.mark.cuda
@pytest.mark.parametrize("heads,Lk", [(24, 77), (WIDE_HEADS, 512)])
def test_k17_matches_plain(dev, heads, Lk):
    """`cross_attention_qout` above 2048 wide: K15 then K17 (clusters of 6
    blocks of 4 heads and of 8 of 5)."""
    HD = heads * DH
    q = _randn(dev, 1, 1100, HD, seed=114).bfloat16()
    k, v = (_randn(dev, 1, Lk, heads, DH, seed=s).bfloat16() for s in (115, 116))
    w = (1 + _randn(dev, HD, seed=117, std=0.2)).bfloat16()
    before = (fa._cross_qout_wide_cuda.launches, sf._row_rms_inv_cuda.launches)
    got_q, got_s = fa.cross_attention_qout(q, k, v, w)
    assert (fa._cross_qout_wide_cuda.launches,
            sf._row_rms_inv_cuda.launches) == (before[0] + 1, before[1] + 1)
    want_q, want_s = fa.cross_attention_qout_wide_plain(
        q, sf.row_rms_inv_plain(q, 1e-6), k, v, w)
    _int8_close(got_q, want_q)
    torch.testing.assert_close(got_s, want_s, rtol=5e-3, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mod", "affine"])
def test_k1_k12_at_the_14b_width_match_plain(dev, mode):
    """K1 (bf16) and K12 (int8) on 5120-wide rows, ten pairs a thread."""
    x = (2 * _randn(dev, 1, SEQ, WIDE, seed=118)).bfloat16()
    ms = _randn(dev, 1, WIDE, seed=1, std=0.5) if mode == "mod" else None
    mb = _randn(dev, 1, WIDE, seed=2, std=0.5) if mode == "mod" else None
    w = (1 + _randn(dev, WIDE, seed=3, std=0.1)).bfloat16() if mode == "affine" else None
    b = _randn(dev, WIDE, seed=4, std=0.1).bfloat16() if mode == "affine" else None
    _close(fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6),
           fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6))
    before = fn._mln_quant_cuda.launches
    q, s = fn.modulated_layer_norm(x, ms, mb, w, b, eps=1e-6, quant_out=True)
    assert fn._mln_quant_cuda.launches == before + 1
    want_q, want_s = fn.modulated_layer_norm_ref(x, ms, mb, w, b, 1e-6, quant_out=True)
    _int8_close(q, want_q)
    _scales_close(s, want_s)


# ---------------------------------------------------------------------------
# K18-K21: v_quant="row", --sla_block 64, the linear branch
# ---------------------------------------------------------------------------

def _row_operands(dev, L, Lp, seed):
    """K planes (non-zero mean, zero past L) and per-row int8 V."""
    k = _randn(dev, 1, HEADS, Lp, DH, seed=seed, std=2.0)
    k[:, :, L:] = 0
    k = (k + 0.5).bfloat16()
    vi, vs = sf._quant_rows(_randn(dev, 1, HEADS, Lp, DH, seed=seed + 1))
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    return k, mu, vi, vs


@pytest.mark.cuda
def test_k18_matches_plain(dev):
    L, Lp = 1000, 1024
    k, mu, vi, _ = _row_operands(dev, L, Lp, 30)
    before = sf._subquant_pack_kv_cuda.launches
    kvi, ks = sf.subquant_pack_kv(k, mu, vi)
    assert sf._subquant_pack_kv_cuda.launches == before + 1
    kvi_p, ks_p = sf.subquant_pack_kv_plain(k, mu, vi)
    _int8_close(kvi, kvi_p)
    assert torch.equal(kvi[..., DH:], vi)
    torch.testing.assert_close(ks, ks_p, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("L,bq,bk", [(1000, 512, 256), (300, 128, 64)])
def test_k19_matches_plain_and_ignores_a_poisoned_tail(dev, L, bq, bk):
    Lp = -(-L // 512) * 512
    k, mu, vi, vs = _row_operands(dev, L, Lp, 31)
    qi, qs = sf._quant_rows(_randn(dev, 1, HEADS, Lp, DH, seed=33))
    kvi, ks = sf.subquant_pack_kv_plain(k, mu, vi)
    nQ, nK = Lp // bq, -(-L // bk)
    r = np.random.RandomState(34)
    lut = torch.from_numpy(np.stack([r.permutation(nK)[:max(1, nK // 2)]
                                     for _ in range(HEADS * nQ)])
                           .reshape(1, HEADS, nQ, -1).astype(np.int32)).to(dev)
    kw = dict(block_q=bq, block_k=bk, kv_len=L)
    before = si8._sparse_i8_planes_cuda.launches
    got = si8.sparse_attention_i8_planes(qi, qs, kvi, ks, vs, lut, **kw)
    assert si8._sparse_i8_planes_cuda.launches == before + 1
    _close(got[:, :, :L], si8.sparse_attention_i8_planes_plain(
        qi, qs, kvi, ks, vs, lut, **kw)[:, :, :L])
    pk, pks, pvs = kvi.clone(), ks.clone(), vs.clone()
    pk[:, :, L:], pks[:, :, L:], pvs[:, :, L:] = 127, float("nan"), float("nan")
    poisoned = si8.sparse_attention_i8_planes(qi, qs, pk, pks, pvs, lut, **kw)
    assert torch.equal(poisoned[:, :, :L], got[:, :, :L])


@pytest.mark.cuda
def test_k27_matches_plain_and_ignores_nan_rows(dev):
    """Block-scale pack: K rows past kv_len NaN (they stay out of the block
    statistic); live rows within 1 LSB, scales bit-equal, V copied."""
    L, Lp, bk = 1000, 1024, 256
    k, mu, vi, _ = _row_operands(dev, L, Lp, 46)
    k[:, :, L:] = float("nan")
    before = sf._subquant_pack_kv_blocks_cuda.launches
    kvi, ks = sf.subquant_pack_kv(k, mu, vi, block_k=bk, kv_len=L)
    assert sf._subquant_pack_kv_blocks_cuda.launches == before + 1
    kvi_p, ks_p = sf.subquant_pack_kv_plain(k, mu, vi, bk, L)
    assert ks.shape == (1, HEADS, Lp // bk) and torch.equal(ks, ks_p)
    _int8_close(kvi[:, :, :L], kvi_p[:, :, :L])
    assert torch.equal(kvi[..., DH:], vi)


@pytest.mark.cuda
@pytest.mark.parametrize("L,bq,bk", [(1000, 512, 256), (300, 128, 64)])
def test_k28_matches_plain_and_ignores_a_poisoned_tail(dev, L, bq, bk):
    Lp = -(-L // 512) * 512
    k, mu, _, _ = _row_operands(dev, L, Lp, 47)
    v = _randn(dev, 1, HEADS, Lp, DH, seed=48).bfloat16()
    vi, vcs = si8.quantize_v_per_channel(v, L)
    qi, qs = sf._quant_rows(_randn(dev, 1, HEADS, Lp, DH, seed=49, std=3.0))
    kvi, ksb = sf.subquant_pack_kv_plain(k, mu, vi, bk, L)
    nQ, nK = Lp // bq, -(-L // bk)
    r = np.random.RandomState(50)
    lut = torch.from_numpy(np.stack([r.permutation(nK)[:max(1, nK // 2)]
                                     for _ in range(HEADS * nQ)])
                           .reshape(1, HEADS, nQ, -1).astype(np.int32)).to(dev)
    kw = dict(block_q=bq, block_k=bk, kv_len=L, k_block_scale=ksb,
              v_channel_scale=vcs)
    before = si8._sparse_i8_planes_bs_cuda.launches
    got = si8.sparse_attention_i8_planes(qi, qs, kvi, None, None, lut, **kw)
    assert si8._sparse_i8_planes_bs_cuda.launches == before + 1
    _close(got[:, :, :L], si8.sparse_attention_i8_planes_bs_plain(
        qi, qs, kvi, ksb, vcs, lut, block_q=bq, block_k=bk, kv_len=L)[:, :, :L])
    pk = kvi.clone()
    pk[:, :, L:] = 127
    poisoned = si8.sparse_attention_i8_planes(qi, qs, pk, None, None, lut, **kw)
    assert torch.equal(poisoned[:, :, :L], got[:, :, :L])


K28_CASES = ["ragged kv_len", "LUT ids out of range, a row with no live chunk",
             "batch 2", "40 heads", "NaN tail"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K28_CASES)
@pytest.mark.parametrize("bq,bk", [(512, 256), (128, 128)])
def test_k28_wgmma_form_matches_plain(dev, bq, bk, case):
    """K28's wgmma form (K7's kernel on K27's packed K|V rows) against its
    plain version at kv_len 1,000 of 1,024 padded rows: as it is; LUT
    entries -1 and nK + 3 in every row and a row whose only live id names a
    block past kv_len (zero rows; kv_len 700); batch 2; 40 heads; K|V rows past kv_len
    poisoned to +127 and q row scales past it NaN (rows before kv_len
    bit-equal to the clean run's)."""
    B = 2 if case == "batch 2" else 1
    H = 40 if case == "40 heads" else HEADS
    L, Lp = (700 if case.startswith("LUT") else 1000), 1024
    k = _randn(dev, B, H, Lp, DH, seed=91, std=2.0)
    k[:, :, L:] = 0
    k = (k + 0.5).bfloat16()
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi, vcs = si8.quantize_v_per_channel(_randn(dev, B, H, Lp, DH, seed=92).bfloat16(), L)
    qi, qs = sf._quant_rows(_randn(dev, B, H, Lp, DH, seed=93, std=3.0))
    kvi, ksb = sf.subquant_pack_kv_plain(k, mu, vi, bk, L)
    nQ, nK = Lp // bq, Lp // bk
    sel = nK // 2 + 2
    r = np.random.RandomState(94)
    a = np.stack([r.permutation(nK)[:sel] for _ in range(B * H * nQ)]).reshape(
        B, H, nQ, sel).astype(np.int32)
    if case.startswith("LUT"):
        a[..., 0], a[..., 1] = -1, nK + 3
        a[0, 0, 0] = -1
        a[0, 0, 0, 0] = nK - 1             # starts at or past kv_len: no live chunk
        assert (nK - 1) * bk >= L
    lut = torch.from_numpy(a).to(dev)
    assert si8.sparse_i8_planes_bs_form(Lp, Lp, L, bq, bk) == "wgmma"
    kw = dict(block_q=bq, block_k=bk, kv_len=L, k_block_scale=ksb, v_channel_scale=vcs)
    before = si8._sparse_i8_planes_bs_cuda.launches
    got = si8.sparse_attention_i8_planes(qi, qs, kvi, None, None, lut, **kw)
    assert si8._sparse_i8_planes_bs_cuda.launches == before + 1
    want = si8.sparse_attention_i8_planes_bs_plain(qi, qs, kvi, ksb, vcs, lut, block_q=bq,
                                                   block_k=bk, kv_len=L)
    _close(got[:, :, :L], want[:, :, :L])
    if case.startswith("LUT"):
        assert torch.equal(got[0, 0, :bq], torch.zeros_like(got[0, 0, :bq]))
    if case == "NaN tail":
        pk, pqs = kvi.clone(), qs.clone()
        pk[:, :, L:], pqs[:, :, L:] = 127, float("nan")
        poisoned = si8.sparse_attention_i8_planes(qi, pqs, pk, None, None, lut, **kw)
        assert torch.equal(poisoned[:, :, :L], got[:, :, :L])


K19_CASES = ["ragged kv_len", "LUT ids out of range, a row with no live chunk",
             "batch 2", "40 heads", "NaN tail"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K19_CASES)
@pytest.mark.parametrize("bq,bk", [(512, 256), (128, 128)])
def test_k19_wgmma_form_matches_plain(dev, bq, bk, case):
    """K19's wgmma form (K7's kernel on K18's packed K|V rows, a K and a V
    scale a key) against its plain version (bf16 atol 2e-2 + rtol 2^-8: on
    this sharp q an online softmax that rounds P to bf16 at a running max
    lands up to ~0.016 from the one-pass plain version on a few outputs,
    above chip_smoke's atol 4e-3 for path inputs), kv_len
    1,000 of 1,024 padded rows: as it is; LUT entries -1 and nK + 3 in every
    row and a row whose only live id names a block past kv_len (zero rows;
    kv_len 700); batch 2; 40 heads; K|V rows past kv_len poisoned to +127 and
    their K and V scales NaN (rows before kv_len bit-equal to the clean
    run's)."""
    B = 2 if case == "batch 2" else 1
    H = 40 if case == "40 heads" else HEADS
    L, Lp = (700 if case.startswith("LUT") else 1000), 1024
    k = _randn(dev, B, H, Lp, DH, seed=101, std=2.0)
    k[:, :, L:] = 0
    k = (k + 0.5).bfloat16()
    mu = k[:, :, :L].float().mean(2, keepdim=True)
    vi, vs = sf._quant_rows(_randn(dev, B, H, Lp, DH, seed=102))
    qi, qs = sf._quant_rows(_randn(dev, B, H, Lp, DH, seed=103, std=3.0))
    kvi, ks = sf.subquant_pack_kv_plain(k, mu, vi)
    nQ, nK = Lp // bq, Lp // bk
    sel = nK // 2 + 2
    r = np.random.RandomState(104)
    a = np.stack([r.permutation(nK)[:sel] for _ in range(B * H * nQ)]).reshape(
        B, H, nQ, sel).astype(np.int32)
    if case.startswith("LUT"):
        a[..., 0], a[..., 1] = -1, nK + 3
        a[0, 0, 0] = -1
        a[0, 0, 0, 0] = nK - 1             # starts at or past kv_len: no live chunk
        assert (nK - 1) * bk >= L
    lut = torch.from_numpy(a).to(dev)
    assert si8.sparse_i8_planes_form(Lp, Lp, L, bq, bk) == "wgmma"
    kw = dict(block_q=bq, block_k=bk, kv_len=L)
    before = si8._sparse_i8_planes_cuda.launches
    got = si8.sparse_attention_i8_planes(qi, qs, kvi, ks, vs, lut, **kw)
    assert si8._sparse_i8_planes_cuda.launches == before + 1
    want = si8.sparse_attention_i8_planes_plain(qi, qs, kvi, ks, vs, lut, **kw)
    _close(got[:, :, :L], want[:, :, :L])
    if case.startswith("LUT"):
        assert torch.equal(got[0, 0, :bq], torch.zeros_like(got[0, 0, :bq]))
    if case == "NaN tail":
        pk, pks, pvs = kvi.clone(), ks.clone(), vs.clone()
        pk[:, :, L:], pks[:, :, L:], pvs[:, :, L:] = 127, float("nan"), float("nan")
        poisoned = si8.sparse_attention_i8_planes(qi, qs, pk, pks, pvs, lut, **kw)
        assert torch.equal(poisoned[:, :, :L], got[:, :, :L])


@pytest.mark.cuda
def test_k29_matches_plain(dev):
    L = Lp = 1024
    k, mu, _, _ = _row_operands(dev, L, Lp, 51)
    before = sf._subquant_planes_cuda.launches
    i8, sc = sf.subquant_planes(k, mu)
    assert sf._subquant_planes_cuda.launches == before + 1
    i8_p, sc_p = sf.subquant_planes_plain(k, mu)
    _int8_close(i8, i8_p)
    torch.testing.assert_close(sc, sc_p, rtol=1e-5, atol=0)


def _k30_run(q, k, v, kv_len):
    """One K30 launch (exactly one counted), and a second that must be
    bit-equal to it."""
    before = fa._flash_i8qk_cuda.launches
    got = fa._flash_i8qk_cuda(q, k, v, DH ** -0.5, kv_len)
    assert fa._flash_i8qk_cuda.launches == before + 1
    assert torch.equal(fa._flash_i8qk_cuda(q, k, v, DH ** -0.5, kv_len), got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("L,kv_len", [(1100, 1100), (300, 250), (1000, 1000), (1024, 700),
                                      (1024, 1024), (130, 1)])
def test_k30_matches_plain(dev, L, kv_len):
    """K30 (`k4::flash_fwd_kernel<3>`: K4's dense walk of 128-row tiles on
    int8 Q and K) against its plain version: Lq a multiple of 128 or not,
    kv_len a multiple of the chunk or not (down to one key); two runs
    bit-equal, one launch each."""
    q = _randn(dev, 1, L, HEADS, DH, seed=52, std=3.0).bfloat16()
    k, v = (_randn(dev, 1, L, HEADS, DH, seed=s).bfloat16() for s in (53, 54))
    k = k - k.mean(dim=1, keepdim=True)
    got = _k30_run(q, k, v, kv_len)
    _close(got, fa.flash_attention_i8qk_plain(q, k, v, DH ** -0.5, kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [512, 500])
def test_k30_cross_shape_matches_plain(dev, kv_len):
    """K30 over 512 keys (the text's length) from 1,100 query rows."""
    q = _randn(dev, 1, 1100, HEADS, DH, seed=55, std=3.0).bfloat16()
    k, v = (_randn(dev, 1, 512, HEADS, DH, seed=s).bfloat16() for s in (56, 57))
    k = k - k.mean(dim=1, keepdim=True)
    got = _k30_run(q, k, v, kv_len)
    _close(got, fa.flash_attention_i8qk_plain(q, k, v, DH ** -0.5, kv_len))


@pytest.mark.cuda
def test_k30_reads_fused_qkv_views_at_batch_2(dev):
    """B = 2 with q, k and v strided views of one fused (B, L, 3, H, D)
    tensor (rows 3 H D apart): read in place, as a contiguous copy reads."""
    B, L = 2, 700
    qkv = _randn(dev, B, L, 3, HEADS, DH, seed=58).bfloat16()
    qkv[:, :, 0] *= 3
    qkv[:, :, 1] -= qkv[:, :, 1].mean(dim=1, keepdim=True)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert q.stride(1) == 3 * HEADS * DH
    got = _k30_run(q, k, v, L)
    _close(got, fa.flash_attention_i8qk_plain(q, k, v, DH ** -0.5, L))
    again = fa._flash_i8qk_cuda(q.contiguous(), k.contiguous(), v.contiguous(), DH ** -0.5, L)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("poison", [float("nan"), 1e4])
def test_k30_ignores_poisoned_rows_past_kv_len(dev, poison):
    """K and V rows past kv_len hold NaN or 1e4: the output is the clean
    inputs' output bit for bit (no key past kv_len is quantised, loaded or
    weighed)."""
    L, kv_len = 1100, 900
    q = _randn(dev, 1, L, HEADS, DH, seed=59, std=3.0).bfloat16()
    k, v = (_randn(dev, 1, L, HEADS, DH, seed=s).bfloat16() for s in (60, 61))
    k = k - k.mean(dim=1, keepdim=True)
    clean = _k30_run(q, k, v, kv_len)
    pk, pv = k.clone(), v.clone()
    pk[:, kv_len:], pv[:, kv_len:] = poison, poison
    assert torch.equal(_k30_run(q, pk, pv, kv_len), clean)
    _close(clean, fa.flash_attention_i8qk_plain(q, k, v, DH ** -0.5, kv_len))


@pytest.mark.cuda
@pytest.mark.parametrize("L,topk,pair", [(8600, 1.0, ("K27", "K28")),
                                         (1100, 0.5, ("K6", "K7"))])
def test_fused_sagesla_on_the_card_matches_cpu(dev, L, topk, pair):
    """sla_attention_fused with the linear branch on, card against CPU:
    the output and the gradients of the projections, norm weights and
    proj_l (the composable path's VJP: K2, K21, K23, K24); above
    sel * block_k 8,192 the block-scale pair and K21 run, below it K6 + K7;
    the backward's recompute launches no K20."""
    from turbodiffusion_tpu_torch.config import AttentionConfig
    from turbodiffusion_tpu_torch.ops.attention import sla_attention_fused
    xs = [_randn(dev, 1, L, DIM, seed=s).bfloat16() for s in (55, 56, 57)]
    wq = (3 * torch.ones(DIM, device=dev)).bfloat16()
    wk = (1 + _randn(dev, DIM, seed=58, std=0.1)).bfloat16()
    proj = torch.nn.Linear(DH, DH, device=dev)
    cos, sin = fn.rope_cos_sin_full(rope_freqs_3d(-(-L // 208), 8, 26, DH,
                                                  device=dev))
    cfg = AttentionConfig(backend="sagesla", sla_topk=topk, block_q=512,
                          block_k=256, linear_branch=True, v_quant="channel")
    Lp = -(-L // 512) * 512
    g = _randn(dev, 1, HEADS, Lp, DH, seed=59).bfloat16()
    g[:, :, L:] = 0
    launchers = {"K6": sf._subquant_pack_kvt_cuda, "K7": si8._sparse_i8_vt_cuda,
                 "K20": fa._sparse_flash_i8qk_cuda,
                 "K27": sf._subquant_pack_kv_blocks_cuda,
                 "K28": si8._sparse_i8_planes_bs_cuda}

    def run(d):
        ins = [t.detach().to(d).requires_grad_() for t in (*xs, wq, wk)]
        p = copy.deepcopy(proj).to(d)
        o = sla_attention_fused(*ins, (cos[:L].to(d), sin[:L].to(d)), p, cfg,
                                num_heads=HEADS, eps=1e-6)
        return [o, *torch.autograd.grad(o, ins + [p.weight, p.bias], g.to(d))]

    before = {n: f.launches for n, f in launchers.items()}
    got = run(dev)
    ran = {n for n, f in launchers.items() if f.launches > before[n]}
    assert ran == set(pair)
    want = run("cpu")
    for a, b in zip(got, want):
        a, b = a.detach().float().cpu(), b.detach().float()
        assert float((a - b).norm() / b.norm()) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1100, 300])
def test_k20_matches_plain(dev, L):
    q, k, v = (_randn(dev, 1, L, HEADS, DH, seed=s).bfloat16() for s in (35, 36, 37))
    k = k - k.mean(dim=1, keepdim=True)
    _, lut, _ = get_block_map(q, k, 0.3, 64, 64)
    before = fa._sparse_flash_i8qk_cuda.launches
    got = fa._sparse_flash_i8qk_cuda(q, k, v, lut, 64, 64, DH ** -0.5, L)
    assert fa._sparse_flash_i8qk_cuda.launches == before + 1
    _close(got, fa.sparse_flash_attention_i8qk_plain(q, k, v, lut, 64, 64))


K20_CASES = ["ragged kv_len", "LUT ids out of range, a row with no live chunk",
             "batch 2", "40 heads", "NaN tail"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K20_CASES)
@pytest.mark.parametrize("bq,bk", [(64, 64), (512, 256)])
def test_k20_wgmma_form_matches_plain(dev, bq, bk, case):
    """K20's wgmma form (K4's kernel on int8 Q and K rows, 64-row tiles and
    64-key chunks) against its plain version (bf16 atol 2e-2 + rtol 2^-8,
    as K19's wgmma test on a sharp q), Lq
    1,100 (a ragged last tile) over kv_len 900 of 1,100 keys: as it is; LUT
    entries -1 and nK + 3 in every row and a row whose only live id names a
    block past kv_len (zero rows); batch 2 (kv_len 1,100); 40 heads (Lq 600);
    k and v rows past kv_len NaN (held against the plain version on the
    live keys, and bit-equal to the clean run)."""
    B = 2 if case == "batch 2" else 1
    H = 40 if case == "40 heads" else HEADS
    L = 600 if case == "40 heads" else 1100
    kv_len = L if case in ("batch 2", "40 heads") else 900
    q = _randn(dev, B, L, H, DH, seed=111, std=3.0).bfloat16()
    k, v = (_randn(dev, B, L, H, DH, seed=s).bfloat16() for s in (112, 113))
    k = (k.float() - k[:, :kv_len].float().mean(1, keepdim=True)).bfloat16()
    nQ, nK = -(-L // bq), -(-L // bk)
    sel = nK // 2 + 2
    r = np.random.RandomState(114)
    a = np.stack([r.permutation(nK)[:sel] for _ in range(B * H * nQ)]).reshape(
        B, H, nQ, sel).astype(np.int32)
    if case.startswith("LUT"):
        a[..., 0], a[..., 1] = -1, nK + 3
        a[0, 0, 0] = -1
        a[0, 0, 0, 0] = nK - 1             # starts at or past kv_len: no live chunk
        assert (nK - 1) * bk >= kv_len
    lut = torch.from_numpy(a).to(dev)
    assert fa.sparse_flash_i8qk_form(bq, bk, kv_len, L, *fa._strides(q, k, v)) == "wgmma"
    before = fa._sparse_flash_i8qk_cuda.launches
    got = fa._sparse_flash_i8qk_cuda(q, k, v, lut, bq, bk, DH ** -0.5, kv_len)
    assert fa._sparse_flash_i8qk_cuda.launches == before + 1
    want = fa.sparse_flash_attention_i8qk_plain(q, k, v, lut, bq, bk, kv_len=kv_len)
    _close(got, want)
    if case.startswith("LUT"):
        assert torch.equal(got[0, :bq, 0], torch.zeros_like(got[0, :bq, 0]))
    if case == "NaN tail":
        pk, pv = k.clone(), v.clone()
        pk[:, kv_len:], pv[:, kv_len:] = float("nan"), float("nan")
        poisoned = fa._sparse_flash_i8qk_cuda(q, pk, pv, lut, bq, bk, DH ** -0.5, kv_len)
        assert torch.equal(poisoned, got)


def _v_beyond_fp16(dev, shape, seed, row_dim):
    """bf16 V of N(0, 1) whose rows 3, 19, ... lie at 2^17 (1 + |N(0, 1)|),
    past fp16's 65,504, and rows 7, 23, ... at 2^-20 N(0, 1), below fp16's
    normal 2^-14 (the large rows share a sign: a kv element that cancels
    +-2^17 terms to ~0.1 is beyond any fp32 sum)."""
    v = _randn(dev, *shape, seed=seed)
    big = v.narrow(row_dim, 3, shape[row_dim] - 3).unfold(row_dim, 1, 16)
    big.copy_(2.0 ** 17 * (1 + big.abs()))
    v.narrow(row_dim, 7, shape[row_dim] - 7).unfold(row_dim, 1, 16).mul_(2.0 ** -20)
    return v.bfloat16()


# (layout, B, heads, live rows, rows, V): planes (B, H, rows, 128) with
# rows past the live ones NaN, or (B, L, H, 128) views; V of N(0, 2^2),
# uniform int8 values, or past fp16's range
K21_CASES = {
    "planes, 2 heads, L 2500": ("planes", 1, HEADS, 2500, 2560, "normal"),
    "bhld, 2 heads, L 700": ("bhld", 1, HEADS, 700, 700, "normal"),
    "planes, 40 heads, L 3000": ("planes", 1, 40, 3000, 3072, "normal"),
    "bhld, 40 heads, L 1000": ("bhld", 1, 40, 1000, 1000, "normal"),
    "planes, kv_len 40 (under a chunk)": ("planes", 1, 12, 40, 64, "normal"),
    "planes, kv_len 130 (three chunks)": ("planes", 1, 12, 130, 192, "normal"),
    "bhld, batch 2, 12 heads": ("bhld", 2, 12, 500, 500, "normal"),
    "bhld, V past fp16's range": ("bhld", 1, 12, 3000, 3000, "beyond"),
    "planes, 40 heads, int8-valued V": ("planes", 1, 40, 3000, 3072, "int8"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K21_CASES))
def test_k21_matches_plain(dev, case):
    """K21 in its wgmma form (`la.linear_form`) over planes with NaN rows
    past the true length (which stay out of kv / ksum) and over (B, L, H, D)
    views read through strides, at 2, 12 and 40 heads, kv_len under one
    64-row chunk and across several, batch 2, bf16 V past fp16's range and
    int8-valued V: the output against the plain version (the file's bf16
    tolerance; rtol 2^-7, one bf16 step, where |o| reaches hundreds), kv and
    ksum as `_assert_kv_sums` holds them against float64 sums, and a second
    launch bit-identical."""
    layout, B, H, L, rows, vk = K21_CASES[case]
    w = _randn(dev, DH, DH, seed=41, std=0.05)
    b = _randn(dev, DH, seed=42, std=0.1)
    shape = (B, H, rows, DH) if layout == "planes" else (B, rows, H, DH)
    q, k = (_randn(dev, *shape, seed=s, std=2.0).bfloat16() for s in (38, 39))
    if vk == "beyond":
        v = _v_beyond_fp16(dev, shape, 40, 2 if layout == "planes" else 1)
    elif vk == "int8":
        v = torch.from_numpy(np.random.RandomState(40).randint(
            -127, 128, shape).astype(np.float32)).to(dev).bfloat16()
    else:
        v = _randn(dev, *shape, seed=40, std=2.0).bfloat16()
    before = la._linear_projected_cuda.launches
    if layout == "planes":
        want = la.linear_projected_planes_plain(q, k, v, w, b, L)
        k[:, :, L:], v[:, :, L:] = float("nan"), float("nan")
        got = la.linear_projected_planes(q, k, v, w, b, L)
        again = la.linear_projected_planes(q, k, v, w, b, L)
        got, want, again = got[:, :, :L], want[:, :, :L], again[:, :, :L]
        qv, kv_, vv = q, k, v
    else:
        want = la.linear_attention_projected_plain(q, k, v, w, b)
        got = la.linear_attention_projected(q, k, v, w, b)
        again = la.linear_attention_projected(q, k, v, w, b)
        qv, kv_, vv = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    assert la._linear_projected_cuda.launches == before + 2
    assert la.linear_form(B, H, qv.shape[2], L, [t.data_ptr() for t in (qv, kv_, vv, qv)],
                          [t.stride(i) for t in (qv, kv_, vv, qv) for i in range(3)]) == "wgmma"
    if vk == "normal":
        _close(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=ATOL, rtol=2.0 ** -7)
    assert torch.equal(got, again)
    sums = la._linear_kv_sums(kv_, vv, L)
    valid = (torch.arange(kv_.shape[2], device=dev) < L)[:, None]
    pk = torch.where(valid, torch.softmax(kv_.double(), -1), 0.0)
    exact = (torch.matmul(pk.transpose(-1, -2), torch.where(valid, vv.double(), 0.0)),
             pk.sum(2, keepdim=True))
    _assert_kv_sums(sums, la.linear_kv_plain(kv_, vv, L), exact)
    rerun = la._linear_kv_sums(kv_, vv, L)
    assert torch.equal(rerun[0], sums[0]) and torch.equal(rerun[1], sums[1])


# ---------------------------------------------------------------------------
# K22: the 128x128 block-scaled W8A8 GEMM (fp32 out bit-equal to the plain
# version, which forms the same fp32 terms in the same K-block order; bf16
# out within one bf16 step, the plain version's fp32 value rounded once)
# ---------------------------------------------------------------------------

def _block_scales(dev, rows, cols, seed):
    """Scales spanning a factor of ~50 across blocks."""
    a = np.random.RandomState(seed).uniform(0, 4, (rows, cols))
    return torch.from_numpy((1e-3 * np.exp(a)).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bias,out", [
    (300, 256, 384, True, torch.float32), (300, 256, 384, False, torch.float32),
    (1000, 200, 300, True, torch.float32),        # ragged K and N: padded
    (512, 1536, 1536, True, torch.bfloat16),
    (300, 1536, 256, True, torch.float32),        # 12 K blocks: the fold order
    (1000, 1536, 512, True, torch.bfloat16)])     # ragged M
def test_k22_matches_plain(dev, M, K, N, bias, out):
    cd = lambda n: -(-n // 128)                   # noqa: E731
    xq, wq = _i8(dev, M, K, seed=100), _i8(dev, N, K, seed=101)
    xs, ws = _block_scales(dev, cd(M), cd(K), 102), _block_scales(dev, cd(N), cd(K), 103)
    b = _randn(dev, N, seed=104) if bias else None
    before = qt._int8_block_matmul_cuda.launches
    got = qt.int8_block_matmul(xq, xs, wq, ws, b, out_dtype=out)
    assert qt._int8_block_matmul_cuda.launches == before + 1
    want = qt.int8_block_matmul_plain(xq, xs, wq, ws, b, out_dtype=out)
    assert got.dtype == out and got.shape == (M, N)
    if out == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -8, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1000, 512, 32760])
def test_k22_reads_no_scale_past_xs(dev, M):
    """xs (ceil(M / 128), Kb) ends where mapped memory ends
    (`ops._guard.guarded_copy`): the M that leave the last 192-row tile
    with a consumer wholly past M (its 64 rows past the last quant block)
    must not read a scale past xs. fp32 out bit-equal to the plain
    version."""
    from turbodiffusion_tpu_torch.ops._guard import guarded_copy
    K, N = 256, 256
    xq, wq = _i8(dev, M, K, seed=106), _i8(dev, N, K, seed=107)
    xs = guarded_copy(_block_scales(dev, -(-M // 128), K // 128, 108))
    ws = _block_scales(dev, N // 128, K // 128, 109)
    before = qt._int8_block_matmul_cuda.launches
    got = qt.int8_block_matmul(xq, xs, wq, ws, None, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert qt._int8_block_matmul_cuda.launches == before + 1
    assert torch.equal(got, qt.int8_block_matmul_plain(xq, xs, wq, ws, None))


@pytest.mark.cuda
def test_block_linear_on_the_card_matches_plain(dev):
    """An Int8BlockLinear over a (2, 200, 256) bf16 activation: the
    activation quantiser (plain torch on both devices) and K22 (bf16 out)
    against the CPU's plain composition."""
    lin = torch.nn.Linear(256, 384, dtype=torch.bfloat16)
    blk = qt.Int8BlockLinear.from_linear(lin).to(dev)
    x = (3 * _randn(dev, 2, 200, 256, seed=105)).bfloat16()
    before = qt._int8_block_matmul_cuda.launches
    got = blk(x)
    assert qt._int8_block_matmul_cuda.launches == before + 1
    want = blk.cpu()(x.cpu())
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2.0 ** -8,
                               atol=0)


# ---------------------------------------------------------------------------
# K23 / K24: the block-sparse attention backward (dq pass, inverse-LUT dk/dv
# pass). lse and delta are fp32 (atol 1e-4 + rtol 1e-5: another summation
# order, exp2 against exp); the gradients bf16 (ATOL / RTOL).
# ---------------------------------------------------------------------------

def _bwd_operands(dev, L, bq, bk, seed, B=1, kv_len=None, fused=False, do_t=False):
    """q, k, v, dO (B, L, HEADS, 128) bf16 views into buffers whose rows past
    L hold NaN, k and v NaN from kv_len on too; with `fused` q, k, v are the
    column groups of one (B, L + 64, 3, HEADS, 128) buffer; with `do_t` dO
    is a (B, HEADS, L, 128) tensor transposed, as autograd hands it over.
    The LUT never selects the last K-block but one, and its row (0, 0, 0)
    names the ids -1 and nK + 3 (no key) beside valid ones."""
    kv_len = L if kv_len is None else kv_len
    bufs = []
    for s in range(4):
        t = _randn(dev, B, L + 64, HEADS, DH, seed=seed + s).bfloat16()
        t[:, L:] = float("nan")
        if s in (1, 2):
            t[:, kv_len:] = float("nan")
        bufs.append(t[:, :L])
    if fused:
        buf = torch.full((B, L + 64, 3, HEADS, DH), float("nan"), device=dev,
                         dtype=torch.bfloat16)
        for i in range(3):
            buf[:, :L, i] = bufs[i]
        bufs[:3] = [buf[:, :L, i] for i in range(3)]
    if do_t:
        bufs[3] = _randn(dev, B, HEADS, L, DH, seed=seed + 3).bfloat16().transpose(1, 2)
    nQ, nK = -(-L // bq), -(-L // bk)
    r = np.random.RandomState(seed + 4)
    keep = [j for j in range(nK) if j != nK - 2]
    sel = max(3, len(keep) // 2)
    lut = np.stack([r.permutation(keep)[:sel] for _ in range(B * HEADS * nQ)])
    lut = lut.reshape(B, HEADS, nQ, sel).astype(np.int32)
    lut[0, 0, 0, :2] = [-1, nK + 3]
    return (*bufs, torch.from_numpy(lut).to(dev), nQ, nK)


# name: L, block_q, block_k, B, kv_len (None: L), fused QKV views, dO as
# autograd's transpose. The forms: 128-row tiles where the tile side's
# blocks (K23 block_q, K24 block_k) are multiples of 128, else 64-row.
_BWD_CASES = {
    "512/256": (1100, 512, 256, 1, None, False, False),
    "128/128": (520, 128, 128, 1, None, False, False),
    "64/64": (1000, 64, 64, 1, None, False, False),
    "192/128": (1100, 192, 128, 1, None, False, False),
    "512/64 kv_len 700": (1000, 512, 64, 1, 700, False, False),
    "512/256 kv_len 900": (1100, 512, 256, 1, 900, False, False),
    "512/256 B 2": (1100, 512, 256, 2, None, False, False),
    "64/64 B 2 fused": (1000, 64, 64, 2, None, True, False),
    "128/128 fused dO^T": (1100, 128, 128, 1, None, True, True),
    "64/64 kv_len 700 dO^T": (1000, 64, 64, 1, 700, False, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_BWD_CASES))
def test_k23_k24_match_plain(dev, case):
    """Each form against the plain versions: dq, dk, dv at ATOL / RTOL,
    (lse, delta) at atol 1e-4 + rtol 1e-5; K24 reading no (lse, delta) row
    past L (NaN there), the never-selected K-block exactly zero, two runs
    bit-equal."""
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    L, bq, bk, B, kv_len, fused, do_t = _BWD_CASES[case]
    kv_len = L if kv_len is None else kv_len
    q, k, v, do, lut, nQ, nK = _bwd_operands(dev, L, bq, bk, 50, B, kv_len, fused, do_t)
    scale = DH ** -0.5
    b23, b24 = sb._sparse_bwd_dq_cuda.launches, sb._sparse_bwd_dkv_cuda.launches
    dq, ld = sb._sparse_bwd_dq_cuda(q, k, v, do, lut, bq, bk, scale, kv_len)
    assert sb._sparse_bwd_dq_cuda.last_form == (128 if bq % 128 == 0 else 64)
    dq_p, ld_p = sb.sparse_bwd_dq_plain(q, k, v, do, lut, bq, bk, scale, kv_len)
    _close(dq, dq_p)
    torch.testing.assert_close(ld[:, :L], ld_p[:, :L], atol=1e-4, rtol=1e-5)
    inv = sb.inverse_lut(lut, nK)
    poisoned = ld.clone()
    poisoned[:, L:] = float("nan")           # rows past L are never read
    dk, dv = sb._sparse_bwd_dkv_cuda(q, k, v, do, poisoned, inv, bq, bk, scale, kv_len)
    assert sb._sparse_bwd_dkv_cuda.last_form == (128 if bk % 128 == 0 else 64)
    dk_p, dv_p = sb.sparse_bwd_dkv_plain(q, k, v, do, ld, inv, bq, bk, scale, kv_len)
    _close(dk, dk_p)
    _close(dv, dv_p)
    assert sb._sparse_bwd_dq_cuda.launches == b23 + 1
    assert sb._sparse_bwd_dkv_cuda.launches == b24 + 1
    # the never-selected K-block and the key rows past kv_len: exactly zero;
    # a second run: the same bits
    blk = slice((nK - 2) * bk, (nK - 1) * bk)
    assert not dk[:, blk].any() and not dv[:, blk].any()
    assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()
    dk2, dv2 = sb._sparse_bwd_dkv_cuda(q, k, v, do, ld, inv, bq, bk, scale, kv_len)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, sb._sparse_bwd_dq_cuda(q, k, v, do, lut, bq, bk,
                                                  scale, kv_len)[0])


@pytest.mark.cuda
def test_k24_matches_plain_over_seeds(dev):
    """K24 against its plain version over 8 draws of chip_smoke's kinds of
    inputs (q of std 3, k, v, dO of std 1; (lse, delta) from K23) at 2,000
    rows, 2 heads, blocks 512/256, at chip_smoke's tolerance: atol 2e-2 +
    rtol 2e-2 |want| (its error once reached 0.047 there)."""
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    from turbodiffusion_tpu_torch.ops.attention import get_block_map
    L, bq, bk, scale = 2000, 512, 256, DH ** -0.5
    nK = -(-L // bk)
    for seed in range(8):
        q = (3 * _randn(dev, 1, L, HEADS, DH, seed=700 + seed)).bfloat16()
        k, v, do = (_randn(dev, 1, L, HEADS, DH, seed=710 + 10 * seed + i).bfloat16()
                    for i in range(3))
        lut = get_block_map(q, k, 0.5, bq, bk)[1]
        ld = sb._sparse_bwd_dq_cuda(q, k, v, do, lut, bq, bk, scale, L)[1]
        inv = sb.inverse_lut(lut, nK)
        got = sb._sparse_bwd_dkv_cuda(q, k, v, do, ld, inv, bq, bk, scale, L)
        want = sb.sparse_bwd_dkv_plain(q, k, v, do, ld, inv, bq, bk, scale, L)
        for a, b in zip(got, want):
            torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_sparse_attention_autograd_on_the_card_matches_cpu(dev):
    """K3's autograd Function: the card's gradients (K23 + K24, dO strided
    as autograd hands it over) against the plain versions' on the CPU."""
    L, bq, bk = 1100, 512, 256
    q, k, v, _, lut, _, _ = _bwd_operands(dev, L, bq, bk, 60)
    g = _randn(dev, 1, HEADS, L, DH, seed=65).bfloat16().transpose(1, 2)

    def grads(q, k, v, lut, g):
        q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o = fa.sparse_flash_attention(q, k, v, lut, bq, bk)
        return (o, *torch.autograd.grad(o, (q, k, v), g))

    got = grads(q, k, v, lut, g)
    want = grads(*(t.cpu() for t in (q, k, v, lut, g)))
    for a, b in zip(got, want):
        _close(a.cpu(), b)


@pytest.mark.cuda
def test_k23_k24_refuse_what_they_do_not_take(dev):
    from turbodiffusion_tpu_torch.ops import sparse_attention_bwd as sb
    q = _randn(dev, 1, 256, HEADS, 64).bfloat16()
    lut = torch.zeros(1, HEADS, 2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim 128"):
        sb.sparse_flash_attention_bwd(q, q, q, q, lut, 128, 128)
    q = _randn(dev, 1, 256, HEADS, DH).bfloat16()
    with pytest.raises(ValueError, match="multiples of 64"):
        sb.sparse_flash_attention_bwd(q, q, q, q, lut[:, :, :1], 256, 32)


# ---------------------------------------------------------------------------
# K25 / K26: forward-mode (JVP) attention, dense and block-sparse. q has std
# 3 and the tangents the size of the primals, so that mu, P dv and each term
# of dS matter: the planted faults (mu dropped, P dv dropped, q dk^T dropped
# from dS, a LUT entry dropped; errors of 3 and more) must each fail the
# comparison. o at ATOL / RTOL; do at atol 2e-2 + rtol 2e-2, chip_smoke's
# bf16 tolerance: do = acc_t / l - mu o subtracts terms of up to ~10 whose
# bf16-rounded P dS the kernel rounds at the running max of the online
# softmax and the plain version at the row's final max, which leaves a few
# elements a bf16 step (2^-5 at 4 to 8) apart.
# ---------------------------------------------------------------------------

def _close_do(got, want):
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def _jvp_operands(dev, L, Lk, seed, B=1, fused=False):
    """q, k, v, dq, dk, dv (B, L or Lk, HEADS, 128) bf16 views into buffers
    whose rows past their length hold NaN; with `fused` (L == Lk) q, k, v are
    the column groups of one (B, L + 64, 3, HEADS, 128) buffer."""
    out = []
    for i, (n, std) in enumerate(((L, 3.0), (Lk, 1.0), (Lk, 1.0), (L, 1.0),
                                  (Lk, 1.0), (Lk, 1.0))):
        t = _randn(dev, B, n + 64, HEADS, DH, seed=seed + i, std=std).bfloat16()
        t[:, n:] = float("nan")
        out.append(t[:, :n])
    if fused:
        assert L == Lk
        qkv = torch.stack([t.float() for t in out[:3]], 2)       # (B, L, 3, H, D)
        buf = torch.full((B, L + 64, 3, HEADS, DH), float("nan"), device=dev)
        buf[:, :L] = qkv
        buf = buf.bfloat16()
        out[:3] = [buf[:, :L, i] for i in range(3)]
    return out


def _mu_hat(q, k, dq, dk, kv_len, lut=None, bq=None, bk=None):
    """rowsum(softmax(S) dS), (B, L, HEADS, 1) fp32: what do subtracts times
    o. Dense, or over the K-blocks the LUT selects."""
    scale = DH ** -0.5
    qh, kh, dqh, dkh = (t.float().transpose(1, 2) for t in (q, k, dq, dk))
    s = qh @ kh.transpose(-1, -2) * scale
    ds = (dqh @ kh.transpose(-1, -2) + qh @ dkh.transpose(-1, -2)) * scale
    cols = torch.arange(k.shape[1], device=q.device)
    live = (cols < kv_len).expand(s.shape)
    if lut is not None:
        allowed = torch.zeros((*lut.shape[:3], -(-k.shape[1] // bk)),
                              dtype=torch.bool, device=q.device)
        allowed.scatter_(-1, lut.long(), True)
        rows = torch.arange(q.shape[1], device=q.device) // bq
        live = live & allowed[:, :, rows][..., cols // bk]
    p = torch.softmax(torch.where(live, s, -1e30), -1)
    return (p * torch.where(live, ds, 0.0)).sum(-1, keepdim=True).transpose(1, 2)


def _rejects(bad, want):
    with pytest.raises(AssertionError):
        _close_do(bad, want)


def _jvp_case(kern, plain, ops, kv_len, lut=None, bq=None, bk=None, ref_lut=None):
    """One K25 / K26 case: kern(ops, dk, dv, lut) against plain(ops, lut) on
    the same operands (q, k, v, dq, dk, dv; `ref_lut`, the LUT the plain
    version reads, where ids out of range are renamed to a block wholly past
    kv_len); the planted faults each rejected (mu left out of do, P dv left
    out, q dk^T left out of dS, K26's last LUT entry dropped); two runs
    bit-equal. Returns (o, do) and the plain version's."""
    q, k, v, dq, dk, dv = ops
    ref_lut = lut if ref_lut is None else ref_lut
    o, do = kern(ops, dk, dv, lut)
    o_p, do_p = plain(ops, ref_lut)
    _close(o, o_p)
    _close_do(do, do_p)
    zero = torch.zeros_like
    mu = _mu_hat(q, k, dq, dk, kv_len, ref_lut, bq, bk)
    _rejects(do.float() + mu * o.float(), do_p)
    _rejects(kern(ops, dk, zero(dv), lut)[1], do_p)
    _rejects(kern(ops, zero(dk), dv, lut)[1], do_p)
    if lut is not None:
        _rejects(kern(ops, dk, dv, lut[..., :-1].contiguous())[0], o_p)
    o2, do2 = kern(ops, dk, dv, lut)
    assert torch.equal(o, o2) and torch.equal(do, do2)
    return (o, do), (o_p, do_p)


K25_CASES = {
    "1100-1100": (1100, 1100, 1100, 1, False),     # L, Lk, kv_len, B, fused
    "300-77": (300, 77, 77, 1, False),
    "cross 512, batch 2": (1000, 512, 512, 2, False),
    "qkv view, batch 2": (1000, 1000, 1000, 2, True),
    "ragged kv_len": (1000, 1100, 900, 1, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K25_CASES))
def test_k25_matches_plain_and_rejects_planted_faults(dev, case):
    """K25 (the wgmma form) against its plain version: Lq not a multiple of
    128 and kv_len not one of 64, the 512-key cross shape, batch 2, q, k, v
    as column views of a fused QKV buffer, NaN in the rows past each length
    (past kv_len in k, v and their tangents)."""
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    L, Lk, kv_len, B, fused = K25_CASES[case]
    ops = _jvp_operands(dev, L, Lk, 70, B, fused)
    if kv_len < Lk:
        for t in ops[1:3] + ops[4:]:
            t[:, kv_len:] = float("nan")
    scale = DH ** -0.5
    assert fj.jvp_form(0, 0, kv_len, *fa._strides(*ops)) == "wgmma"

    def kern(ops_, dk, dv, _):
        q, k, v, dq = ops_[:4]
        before = fj._flash_jvp_cuda.launches
        out = fj._flash_jvp_cuda(q, k, v, dq, dk, dv, scale, kv_len)
        assert fj._flash_jvp_cuda.launches == before + 1
        return out

    def plain(ops_, _):
        # the rows past kv_len as zeros: the plain version masks them, but
        # 0 x NaN would still reach its sums
        return fj.flash_attention_jvp_plain(*(t.nan_to_num(0.0) for t in ops_), scale,
                                            kv_len)
    _jvp_case(kern, plain, ops, kv_len)


K26_CASES = ["ragged", "LUT ids out of range, a row with no live chunk", "batch 2",
             "qkv view", "NaN tail"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K26_CASES)
@pytest.mark.parametrize("bq,bk,form", [(512, 256, "wgmma"), (128, 128, "wgmma"),
                                        (192, 64, "mma")])
def test_k26_matches_plain_and_rejects_planted_faults(dev, bq, bk, form, case):
    """K26 in each form against its plain version, Lq 1,100 (1,000 at batch
    2 and the fused view: ragged last tiles): kv_len 900 of 1,100 keys (not
    a multiple of 64; the last K block wholly past it), the keys past it
    finite or, in the NaN tail, NaN in k, v and their tangents; LUT entries
    -1 and nK + 3 in every row and a row whose only live id names a block
    past kv_len (zero rows; the plain version reads those ids as that
    block); batch 2; q, k, v column groups of a fused QKV buffer. Every
    buffer holds NaN in its rows past L."""
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    B = 2 if case in ("batch 2", "qkv view") else 1
    L = 1000 if B == 2 else 1100
    kv_len = L if B == 2 else 900
    ops = _jvp_operands(dev, L, L, 80, B, case == "qkv view")
    if case == "NaN tail":
        for t in ops[1:3] + ops[4:]:
            t[:, kv_len:] = float("nan")
    nQ, nK = -(-L // bq), -(-L // bk)
    sel = nK // 2 + 2
    r = np.random.RandomState(85)
    a = np.stack([r.permutation(nK)[:sel] for _ in range(B * HEADS * nQ)]).reshape(
        B, HEADS, nQ, sel).astype(np.int32)
    ref = a.copy()
    if case.startswith("LUT"):
        assert (nK - 1) * bk >= kv_len
        a[..., 0], a[..., 1] = -1, nK + 3
        a[0, 0, 0] = -1
        a[0, 0, 0, 0] = nK - 1             # starts at or past kv_len: no live chunk
        ref = np.where((a < 0) | (a >= nK), nK - 1, a)
    lut, ref_lut = (torch.from_numpy(x).to(dev) for x in (a, ref))
    scale = DH ** -0.5
    assert fj.jvp_form(bq, bk, kv_len, *fa._strides(*ops)) == form

    def kern(ops_, dk, dv, lut_):
        q, k, v, dq = ops_[:4]
        before = fj._sparse_flash_jvp_cuda.launches
        out = fj._sparse_flash_jvp_cuda(q, k, v, dq, dk, dv, lut_, bq, bk, scale, kv_len)
        assert fj._sparse_flash_jvp_cuda.launches == before + 1
        return out

    def plain(ops_, lut_):
        # the rows past kv_len as zeros: the plain version masks them, but
        # 0 x NaN would still reach its sums
        q, k, v, dq, dk, dv = (t.nan_to_num(0.0) for t in ops_)
        return _empty_rows_zero(fj.sparse_flash_attention_jvp_plain(
            q, k, v, dq, dk, dv, lut_, bq, bk, scale, kv_len), lut_, bq, bk, kv_len)
    (o, do), _ = _jvp_case(kern, plain, ops, kv_len, lut, bq, bk, ref_lut)
    if case.startswith("LUT"):
        for t in (o, do):
            assert torch.equal(t[0, :bq, 0], torch.zeros_like(t[0, :bq, 0]))


def _empty_rows_zero(out, lut, bq, bk, kv_len):
    """(o, do) with the rows of each Q block whose LUT row names no key
    before kv_len set to 0, as K26 writes them (ROADMAP, Decided
    divergences: a walk with no live chunk gives zero rows); the plain
    version, whose masked logits are finite, averages v over the masked
    keys there."""
    o, do = (t.clone() for t in out)
    empty = ((lut < 0) | (lut.long() * bk >= kv_len)).all(-1)        # (B, H, nQ)
    for b, h, i in empty.nonzero().tolist():
        o[b, i * bq:(i + 1) * bq, h] = 0
        do[b, i * bq:(i + 1) * bq, h] = 0
    return o, do


def _jvp_f64(q, k, v, dq, dk, dv, kv_len, rows):
    """(o, do) of batch 0 at query rows `rows`, every head, in float64 from
    the bf16 operands: exact sums, P and P dS unrounded."""
    scale = DH ** -0.5
    f = lambda t: t[0].double().transpose(0, 1)                 # noqa: E731
    qh, dqh = f(q[:, rows]), f(dq[:, rows])
    kh, vh, dkh, dvh = (f(t[:, :kv_len]) for t in (k, v, dk, dv))
    s = qh @ kh.transpose(-1, -2) * scale
    ds = (dqh @ kh.transpose(-1, -2) + qh @ dkh.transpose(-1, -2)) * scale
    p = torch.softmax(s, -1)
    mu = (p * ds).sum(-1, keepdim=True)
    o = p @ vh
    do = (p * (ds - mu)) @ vh + p @ dvh
    return o.transpose(0, 1), do.transpose(0, 1)


@pytest.mark.cuda
def test_k25_chained_ds_is_as_close_to_float64_as_the_plain_version(dev):
    """dS = dq k^T + q dk^T runs as one chain of 16 wgmma k-steps in one
    accumulator. On the 16 query rows where the kernel's do lies farthest
    from its plain version's, both are held against float64 (exact sums,
    unrounded P): the kernel's worst error is at most the plain version's
    plus one bf16 step of the outputs (2^-8 |o| + 2e-3), so the tensor
    core's chained accumulation adds nothing the bf16 rounding of P dS,
    which both share, does not already."""
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    L = 1100
    ops = _jvp_operands(dev, L, L, 120)
    scale = DH ** -0.5
    o, do = fj._flash_jvp_cuda(*ops, scale, L)
    o_p, do_p = fj.flash_attention_jvp_plain(*ops, scale, L)
    worst = (do.float() - do_p.float()).abs().amax((0, 2, 3)).topk(16).indices
    o64, do64 = _jvp_f64(*ops, L, worst)
    for got, plain, ref in ((o, o_p, o64), (do, do_p, do64)):
        e_k = (got[0, worst].double() - ref).abs()
        e_p = (plain[0, worst].double() - ref).abs()
        slack = 2.0 ** -8 * ref.abs() + 2e-3
        assert bool((e_k <= e_p.amax() + slack).all()), (float(e_k.max()), float(e_p.max()))


@pytest.mark.cuda
def test_jvp_wrappers_on_the_card_launch_one_kernel(dev):
    """Under forward AD a dense call launches one K25 and no K4, a sparse
    call one K26 and no K3; (o, do) equal the card's kernel outputs."""
    import torch.autograd.forward_ad as fwAD
    from turbodiffusion_tpu_torch.ops import flash_jvp as fj
    L, bq, bk = 1100, 512, 256
    q, k, v, dq, dk, dv = _jvp_operands(dev, L, L, 100)
    lut = _bwd_operands(dev, L, bq, bk, 110)[4]
    counters = (fa._flash_cuda, fa._sparse_flash_cuda, fj._flash_jvp_cuda,
                fj._sparse_flash_jvp_cuda)
    before = [c.launches for c in counters]
    with torch.no_grad(), fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) for p, t in ((q, dq), (k, dk), (v, dv))]
        dense = fwAD.unpack_dual(fj.flash_attention_jvp(*duals))
        sparse = fwAD.unpack_dual(fj.sparse_attention_jvp(*duals, lut, bq, bk))
    assert [c.launches - b for c, b in zip(counters, before)] == [0, 0, 1, 1]
    scale = DH ** -0.5
    for got, want in ((dense, fj._flash_jvp_cuda(q, k, v, dq, dk, dv, scale, L)),
                      (sparse, fj._sparse_flash_jvp_cuda(q, k, v, dq, dk, dv, lut,
                                                         bq, bk, scale, L))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
