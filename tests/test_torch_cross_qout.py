"""K14 / K17's host side (ops/flash_attention.py of the PyTorch port): the
launch shape `qout_shape` computes as `k14::launch` (csrc/flash_attention.cu)
does, and the operand checks that refuse what the kernel does not take.

The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py);
its plain versions are held against the JAX package in
tests/test_torch_int8_feeds.py (K14) and tests/test_torch_wide.py (K17).
These tests build nothing: a CPU tensor meets every refusal before the
device check.
"""

import pytest
import torch

from turbodiffusion_tpu_torch.ops import flash_attention as fa

DH = 128
# H -> (heads a block, cluster blocks, ring stages, Q tiles): the most G up
# to 4 with at most 8 blocks a cluster, else the least; two Q tiles where
# they fit with at least 2 ring stages beside G - 1 fp32 o slots (32 KB
# each), then as many 16 KB stages as fit, at most 4
SHAPES = {1: (1, 1, 4, 2), 2: (2, 1, 4, 2), 5: (1, 5, 4, 2), 12: (4, 3, 2, 2),
          16: (4, 4, 2, 2), 40: (5, 8, 2, 1)}


@pytest.mark.parametrize("heads", sorted(SHAPES))
def test_qout_shape_per_head_count(heads):
    """1.3B: 12 heads as 3 blocks of 4 (2 stages, two Q tiles); 14B: 40 as
    8 of 5 (2 stages and one Q tile in 214,016 of the 228,352 dynamic
    bytes); 512 text keys are 8 chunks, 4 a consumer, one pass."""
    got = fa.qout_shape(heads, 512)
    assert (got["heads_per_block"], got["cluster"], got["stages"],
            got["q_buffers"]) == SHAPES[heads]
    assert got["chunks"] == 8 and got["consumer0_chunks"] == 4 and got["single_pass"]
    G, stages, qbufs = got["heads_per_block"], got["stages"], got["q_buffers"]
    assert got["smem"] == fa._qout_smem(G, stages, qbufs) <= fa._QOUT_SMEM_LIMIT
    # one stage more would not fit, unless the ring is at its most; one Q
    # tile only where two do not fit with 2 stages
    if stages < fa._QOUT_MAX_STAGES:
        assert fa._qout_smem(G, stages + 1, qbufs) > fa._QOUT_SMEM_LIMIT
    if qbufs == 1:
        assert fa._qout_smem(G, 2, 2) > fa._QOUT_SMEM_LIMIT


@pytest.mark.parametrize("kv_len,chunks,n0,single", [
    (1, 1, 1, True), (64, 1, 1, True), (77, 2, 1, True), (300, 5, 3, True),
    (512, 8, 4, True), (513, 9, 5, False), (1100, 18, 9, False)])
def test_qout_shape_per_key_count(kv_len, chunks, n0, single):
    """Keys in 64-key chunks, consumer 0 the first half rounded up (a single
    chunk leaves consumer 1 none); past 512 keys (4 chunks a consumer) the
    two-pass form."""
    got = fa.qout_shape(12, kv_len)
    assert (got["chunks"], got["consumer0_chunks"], got["single_pass"]) == (chunks, n0, single)
    assert (got["heads_per_block"], got["cluster"]) == (4, 3)


@pytest.mark.parametrize("heads", [13, 41])
def test_qout_shape_refuses_heads_no_cluster_takes(heads):
    """13 and 41 heads: no G <= 5 with at most 8 blocks a cluster."""
    with pytest.raises(ValueError, match="clusters of <= 8"):
        fa.qout_shape(heads, 512)


def _operands(heads=2, lq=70, kv_len=77, ld=0):
    q = torch.zeros(1, lq, ld or heads * DH, dtype=torch.bfloat16)[..., :heads * DH]
    k = torch.zeros(1, kv_len, heads, DH, dtype=torch.bfloat16)
    return q, k, k.clone(), torch.ones(heads * DH)


def test_k14_k17_refuse_what_the_kernel_does_not_take():
    """Each refusal raises ValueError with its reason, before the device
    check; K17's launcher the same through `_qout_operands`."""
    q, k, v, w = _operands()
    cases = [
        ("bf16 q, k, v", (q.float(), k, v)),
        ("head dim 128", (q, k.reshape(1, 77, 4, 64), v.reshape(1, 77, 4, 64))),
        ("clusters of <= 8", _operands(heads=13)[:3]),
        ("16-byte aligned rows", (torch.zeros(1, 70, 2 * DH + 4, dtype=torch.bfloat16)
                                  [..., :2 * DH], k, v)),
        ("must agree", (q, k, v[:, :, :1])),
        ("unit last stride", (q, k.transpose(-1, -2).contiguous().transpose(-1, -2), v)),
    ]
    for match, (q_, k_, v_) in cases:
        with pytest.raises(ValueError, match=match):
            fa._cross_qout_cuda(q_, k_, v_, w, DH ** -0.5, 1e-6)
        with pytest.raises(ValueError, match=match):
            fa._cross_qout_wide_cuda(q_, torch.ones(1, q_.shape[1], 1), k_, v_, w, DH ** -0.5)
    # well-formed CPU operands reach the device check
    with pytest.raises(ValueError, match="one CUDA device"):
        fa._cross_qout_cuda(q, k, v, w, DH ** -0.5, 1e-6)
    # q a column slice (rows 3 x 256 wide) is taken: only the device refuses
    qs = _operands(ld=3 * 2 * DH)[0]
    with pytest.raises(ValueError, match="one CUDA device"):
        fa._cross_qout_cuda(qs, k, v, w, DH ** -0.5, 1e-6)
