"""Forward-mode attention of the PyTorch port (K25 / K26's plain versions and
the forward-AD wrappers) against the JAX package.

The same numpy-seeded inputs go through JAX's Pallas JVP kernels in
interpret mode (`_flash_jvp_dense_pallas`, `_flash_jvp_sparse_pallas`), its
jnp references (`flash_jvp_ref`, `_sparse_jvp_gather`) and `jax.jvp` of
`attention(..., jvp_mode=True)`, and through the port. q has std 3, so each
row's softmax leans on a few keys and mu (rowsum P dS) is not negligible, and
the tangents are the size of the primals (with flat attention a kernel that
left mu or a term of dS out would still pass). Ragged sequence lengths; the
sparse LUT has sel = 3, not a multiple of JAX's gather group of 4.
Tolerances: fp32 rtol 1e-3 with atol 1e-5 on o and 1e-3 on do (the
reference's own test, rcm/networks/wan2pt1_jvp_test.py:93-129); bf16 atol
2e-2 + rtol 2e-2 (P and P dS round to bf16 at other points of the online
softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from turbodiffusion_tpu.config import AttentionConfig as AttentionConfigJax
from turbodiffusion_tpu.ops.attention import attention as attention_jax
from turbodiffusion_tpu.ops.attention import get_block_map as get_block_map_jax
from turbodiffusion_tpu.ops.flash_jvp_pallas import (
    _flash_jvp_dense_pallas, _flash_jvp_sparse_pallas, _sparse_jvp_gather,
    flash_jvp_ref)
from turbodiffusion_tpu_torch.config import AttentionConfig
from turbodiffusion_tpu_torch.ops import flash_attention as fa
from turbodiffusion_tpu_torch.ops import flash_jvp as fj
from turbodiffusion_tpu_torch.ops.attention import attention

TOL = {"float32": dict(o=(1e-3, 1e-5), do=(1e-3, 1e-3)),
       "bfloat16": dict(o=(2e-2, 2e-2), do=(2e-2, 2e-2))}


def _inputs(L, Lk, H=2, D=64, seed=0):
    """q of std 3, k, v and the three tangents of std 1 (numpy, fp32)."""
    r = np.random.RandomState(seed)
    f = lambda n, std=1.0: (std * r.randn(1, n, H, D)).astype(np.float32)  # noqa: E731
    return f(L, 3.0), f(Lk), f(Lk), f(L), f(Lk), f(Lk)


def _check(got, want, dtype):
    for name, a, b in zip(("o", "do"), got, want):
        rtol, atol = TOL[dtype][name]
        np.testing.assert_allclose(np.asarray(a.float() if torch.is_tensor(a)
                                              else a, np.float32),
                                   np.asarray(b, np.float32), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,Lk", [(192, 192), (200, 77)])
def test_k25_plain_matches_jax_kernel_and_ref(L, Lk, dtype):
    arrs = _inputs(L, Lk)
    jx = [jnp.asarray(a, dtype) for a in arrs]
    scale = 64 ** -0.5
    want = _flash_jvp_dense_pallas(*jx, scale=scale, interpret=True)
    got = fj.flash_attention_jvp_plain(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs))
    _check(got, [np.asarray(w.astype(jnp.float32)) for w in want], dtype)
    if dtype == "float32":
        _check(got, flash_jvp_ref(*jx, scale), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k26_plain_matches_jax_kernel_and_gather(dtype):
    bq = bk = 128
    arrs = _inputs(520, 520, seed=1)
    jx = [jnp.asarray(a, dtype) for a in arrs]
    _, lut, sel = get_block_map_jax(jx[0], jx[1], 0.6, bq, bk)
    assert sel == 3
    scale = 64 ** -0.5
    want = _flash_jvp_sparse_pallas(*jx, lut, scale=scale, block_q=bq,
                                    block_k=bk, interpret=True)
    got = fj.sparse_flash_attention_jvp_plain(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
        torch.from_numpy(np.array(lut)), bq, bk)
    _check(got, [np.asarray(w.astype(jnp.float32)) for w in want], dtype)
    if dtype == "float32":
        _check(got, _sparse_jvp_gather(*jx, lut, scale=scale, block_q=bq,
                                       block_k=bk), dtype)


def _dual_attention(fn, arrs):
    """fn(q, k, v) under the port's forward AD: (o, do)."""
    q, k, v, dq, dk, dv = (torch.from_numpy(a) for a in arrs)
    with torch.no_grad(), fwAD.dual_level():
        out = fn(fwAD.make_dual(q, dq), fwAD.make_dual(k, dk),
                 fwAD.make_dual(v, dv))
        o, do = fwAD.unpack_dual(out)
    return o, do


@pytest.mark.parametrize("backend", ["dense", "sla"])
def test_forward_ad_attention_matches_jax_jvp(backend, monkeypatch):
    """The port's jvp_mode dispatch under forward AD against jax.jvp of
    JAX's (tests/test_jvp_attention.py:109-128), with a non-zero proj_l on
    sla. The tangent pass must not run the primal attention (JAX's rule
    returns (o, do) from one kernel): K4's and K3's plain versions raise
    while it runs."""
    arrs = _inputs(256, 256, seed=2)
    D = arrs[0].shape[-1]
    w = (0.01 * np.eye(D) + 0.05 * np.random.RandomState(3).randn(D, D)
         ).astype(np.float32)
    b = (0.1 * np.random.RandomState(4).randn(D)).astype(np.float32)
    cfg_j = AttentionConfigJax(backend=backend, sla_topk=0.5, block_q=64,
                               block_k=64, jvp_mode=True)
    proj = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    jx = [jnp.asarray(a) for a in arrs]
    want = jax.jvp(lambda q, k, v: attention_jax(q, k, v, cfg_j, proj),
                   tuple(jx[:3]), tuple(jx[3:]))
    cfg = AttentionConfig(backend=backend, sla_topk=0.5, block_q=64,
                          block_k=64, jvp_mode=True)
    lin = torch.nn.Linear(D, D)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))

    def primal_called(*a, **kw):
        raise AssertionError("the tangent pass ran the primal attention")
    with monkeypatch.context() as mp:
        mp.setattr(fa, "flash_attention_plain", primal_called)
        mp.setattr(fa, "sparse_flash_attention_plain", primal_called)
        got = _dual_attention(lambda q, k, v: attention(q, k, v, cfg, lin),
                              arrs)
    _check(got, want, "float32")
    # without a tangent the wrappers are the primal attention
    plain = attention(*(torch.from_numpy(a) for a in arrs[:3]), cfg, lin)
    np.testing.assert_allclose(plain.detach().numpy(), np.asarray(want[0]),
                               rtol=1e-3, atol=1e-5)


def test_wrappers_take_missing_tangents_as_zero():
    """Only q carries a tangent (the text-side k / v of cross attention
    carry none): do equals the full JVP with dk = dv = 0."""
    arrs = _inputs(130, 70, seed=5)
    q, k, v, dq = (torch.from_numpy(a) for a in arrs[:4])
    with torch.no_grad(), fwAD.dual_level():
        o, do = fwAD.unpack_dual(fj.flash_attention_jvp(
            fwAD.make_dual(q, dq), k, v))
    want = fj.flash_attention_jvp_plain(q, k, v, dq, torch.zeros_like(k),
                                        torch.zeros_like(v))
    torch.testing.assert_close(o, want[0])
    torch.testing.assert_close(do, want[1])
    assert do.abs().max() > 1e-2


def test_jvp_launchers_refuse_what_they_do_not_take():
    """The launchers check their operands before any launch: CPU tensors and
    blocks that are no multiple of 64 are refused, and the dispatch refuses
    a device without the kernels."""
    arrs = [torch.from_numpy(a).bfloat16() for a in _inputs(64, 64)]
    with pytest.raises(ValueError, match="CUDA device"):
        fj._flash_jvp_cuda(*arrs, 0.125, 64)
    lut = torch.zeros((1, 2, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of 64"):
        fj._sparse_flash_jvp_cuda(*arrs, lut, 32, 64, 0.125, 64)
    with pytest.raises(ValueError, match="no kernel for device"):
        fj.dense_jvp_pair(*(a.to("meta") for a in arrs), 0.125, 64)
