"""Which kernel K3 (bf16 block-sparse flash attention), K20 (its int8-QK
form), K19 (per-row-scale int8 SageSLA attention) and K28 (its block-scale
form) launch for a shape: their form functions, on the CPU (the card test
`test_form_functions_agree_with_the_c_entries` holds them to the C queries
the launches use)."""

import pytest

from turbodiffusion_tpu_torch.ops import flash_attention as fa
from turbodiffusion_tpu_torch.ops import sparse_i8_attention as si8

L, H, DH = 32760, 12, 128
# (q, k, v, o) strides in elements, by batch, token, head
CONTIGUOUS = [L * H * DH, H * DH, DH] * 4
# q, k, v the column groups of a fused (B, L, 3 H Dh) QKV buffer
QKV_VIEW = [3 * L * H * DH, 3 * H * DH, DH] * 3 + [L * H * DH, H * DH, DH]
# heads 132 channels apart: rows off 16 bytes
OFF_16B = [L * H * 132, H * 132, 132] + [L * H * DH, H * DH, DH] * 3

K3_FORMS = [
    # the paths' blocks: 1.3B / 14B `sla`, training, rCM
    (512, 256, L, CONTIGUOUS, "wgmma"),
    (512, 256, 1000, CONTIGUOUS, "wgmma"),           # ragged kv_len
    (512, 256, L, QKV_VIEW, "wgmma"),
    (512, 128, L, CONTIGUOUS, "wgmma"),
    (128, 128, 300, CONTIGUOUS, "wgmma"),
    (256, 384, L, QKV_VIEW, "wgmma"),
    # `sla` at --sla_block 64, and the other multiples of 64
    (512, 64, L, CONTIGUOUS, "mma"),
    (512, 64, 1000, QKV_VIEW, "mma"),
    (128, 64, 300, CONTIGUOUS, "mma"),
    (64, 64, L, CONTIGUOUS, "mma"),
    (64, 128, 77, CONTIGUOUS, "mma"),
    (192, 256, L, CONTIGUOUS, "mma"),
    # neither form computes these
    (96, 64, L, CONTIGUOUS, None),
    (512, 32, L, CONTIGUOUS, None),
    (0, 256, L, CONTIGUOUS, None),
    (512, 256, 0, CONTIGUOUS, None),
    (512, 256, L, OFF_16B, None),
    (512, 64, L, OFF_16B, None),
]


@pytest.mark.parametrize("bq,bk,kv_len,strides,form", K3_FORMS,
                         ids=[f"{c[0]}-{c[1]}-kv{c[2]}-case{i}"
                              for i, c in enumerate(K3_FORMS)])
def test_sparse_flash_form_by_shape(bq, bk, kv_len, strides, form):
    """K3 takes K4's wgmma kernel at blocks that are multiples of 128, the
    mma.sync loop at the other multiples of 64, whatever kv_len and the
    strides; neither takes other blocks, no key or rows off 16 bytes."""
    if form is None:
        with pytest.raises(ValueError):
            fa.sparse_flash_form(bq, bk, kv_len, *strides)
    else:
        assert fa.sparse_flash_form(bq, bk, kv_len, *strides) == form


LP = 32768
K28_FORMS = [
    # fused sagesla's block-scale branch: 480p at --sla_topk 0.3
    (LP, LP, 32760, 512, 256, "wgmma"),
    (LP, LP, LP, 512, 256, "wgmma"),
    (LP, LP, 32760, 512, 128, "wgmma"),
    (1024, 1024, 1000, 128, 128, "wgmma"),
    (1024, 1024, 1, 128, 128, "wgmma"),
    (9728, 9472, 9360, 512, 256, "wgmma"),   # phase 3's block: 37 K blocks
    # the other multiples of 64 `sparse_attention_i8_planes` takes
    (LP, LP, 32760, 512, 64, "mma"),
    (512, 512, 300, 128, 64, "mma"),
    (512, 512, 300, 64, 64, "mma"),
    (LP, LP, 32760, 192, 256, None),          # 192 does not divide Lp
    (1536, 1536, 1500, 192, 256, "mma"),
    # refused
    (LP, LP, 32760, 96, 64, None),
    (LP, LP, 32760, 512, 100, None),
    (LP, LP, 0, 512, 256, None),
    (LP, LP, LP + 1, 512, 256, None),
    (LP, 32760, 32760, 512, 256, None),       # 256 does not divide Lkp
]


@pytest.mark.parametrize("Lp,Lkp,kv_len,bq,bk,form", K28_FORMS,
                         ids=[f"{c[3]}-{c[4]}-Lp{c[0]}-kv{c[2]}-case{i}"
                              for i, c in enumerate(K28_FORMS)])
def test_sparse_i8_planes_bs_form_by_shape(Lp, Lkp, kv_len, bq, bk, form):
    """K28 takes K7's wgmma kernel on the packed rows at blocks that are
    multiples of 128, the mma.sync loop at the other multiples of 64; the
    blocks must divide the padded lengths and kv_len lie in (0, Lkp]."""
    if form is None:
        with pytest.raises(ValueError):
            si8.sparse_i8_planes_bs_form(Lp, Lkp, kv_len, bq, bk)
    else:
        assert si8.sparse_i8_planes_bs_form(Lp, Lkp, kv_len, bq, bk) == form


K20_FORMS = [
    # sagesla at --sla_block 64: 64/64, and every other multiple of 64
    (64, 64, L, L, CONTIGUOUS, "wgmma"),
    (64, 64, 1000, 1100, CONTIGUOUS, "wgmma"),       # ragged kv_len
    (64, 64, L, L, QKV_VIEW, "wgmma"),
    (512, 256, L, L, CONTIGUOUS, "wgmma"),
    (512, 64, L, L, CONTIGUOUS, "wgmma"),
    (128, 64, 300, 300, CONTIGUOUS, "wgmma"),
    (64, 192, 1, 77, CONTIGUOUS, "wgmma"),
    # refused
    (96, 64, L, L, CONTIGUOUS, None),
    (64, 32, L, L, CONTIGUOUS, None),
    (0, 64, L, L, CONTIGUOUS, None),
    (64, 64, 0, L, CONTIGUOUS, None),
    (64, 64, L + 1, L, CONTIGUOUS, None),            # kv_len past Lk
    (64, 64, L, L, OFF_16B, None),
]


@pytest.mark.parametrize("bq,bk,kv_len,Lk,strides,form", K20_FORMS,
                         ids=[f"{c[0]}-{c[1]}-kv{c[2]}-case{i}"
                              for i, c in enumerate(K20_FORMS)])
def test_sparse_flash_i8qk_form_by_shape(bq, bk, kv_len, Lk, strides, form):
    """K20 takes K4's kernel in its int8-QK form at any blocks that are
    multiples of 64 (64-row tiles, each with its own LUT row; 64-key
    chunks), 64/64 and 512/256 alike; it refuses other blocks, kv_len
    outside (0, Lk] and rows off 16 bytes."""
    if form is None:
        with pytest.raises(ValueError):
            fa.sparse_flash_i8qk_form(bq, bk, kv_len, Lk, *strides)
    else:
        assert fa.sparse_flash_i8qk_form(bq, bk, kv_len, Lk, *strides) == form


K19_FORMS = [
    # every --v_quant row call: 480p at 512/256
    (LP, LP, 32760, 512, 256, "wgmma"),
    (LP, LP, LP, 512, 256, "wgmma"),
    (1024, 1024, 1000, 128, 128, "wgmma"),
    (1024, 1024, 700, 512, 128, "wgmma"),
    (9728, 9472, 9360, 512, 256, "wgmma"),   # phase 3's block: 37 K blocks
    # the other multiples of 64: the mma.sync loop
    (LP, LP, 32760, 64, 64, "mma"),
    (LP, LP, 32760, 512, 64, "mma"),
    (512, 512, 300, 128, 64, "mma"),
    (1536, 1536, 1500, 192, 256, "mma"),
    # refused
    (LP, LP, 32760, 96, 64, None),
    (LP, LP, 32760, 512, 100, None),
    (LP, LP, 0, 512, 256, None),
    (LP, LP, LP + 1, 512, 256, None),
    (LP, 32760, 32760, 512, 256, None),       # 256 does not divide Lkp
    (LP, LP, 32760, 192, 256, None),          # 192 does not divide Lp
]


@pytest.mark.parametrize("Lp,Lkp,kv_len,bq,bk,form", K19_FORMS,
                         ids=[f"{c[3]}-{c[4]}-Lp{c[0]}-kv{c[2]}-case{i}"
                              for i, c in enumerate(K19_FORMS)])
def test_sparse_i8_planes_form_by_shape(Lp, Lkp, kv_len, bq, bk, form):
    """K19 takes K7's wgmma kernel on the packed rows with per-key scales at
    blocks that are multiples of 128 (512/256), the mma.sync loop at the
    other multiples of 64 (64/64); the blocks must divide the padded
    lengths and kv_len lie in (0, Lkp]. K19 and K28 share the rule."""
    if form is None:
        with pytest.raises(ValueError):
            si8.sparse_i8_planes_form(Lp, Lkp, kv_len, bq, bk)
    else:
        assert si8.sparse_i8_planes_form(Lp, Lkp, kv_len, bq, bk) == form
    assert _form_or_none(si8.sparse_i8_planes_bs_form, Lp, Lkp, kv_len, bq, bk) == form


def _form_or_none(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return None
