"""The SLA linear branch: kernel K21 (kv sums + apply).

The counterpart of `turbodiffusion_tpu/ops/linear_attention_pallas.py`:
  * `linear_projected_planes` — K21 `_linear_projected_cuda` replaces the
    TPU kernels of `_planes_impl` (launches :141 and :169, bodies
    `_kv_kernel` :41-65 and `_apply_kernel` :68-75) over (B, H, Lp, D) head
    planes with a true length: the fused SageSLA path at `v_quant="row"`
    (JAX `attention.py:500-503`);
  * `linear_attention_projected` — the same kernel replaces
    `_linear_projected_impl` (launches :198 and :226) over (B, L, H, D),
    read through strides, output in q's dtype: the `sla` path and the
    composable sagesla path with a non-zero `proj_l` (JAX
    `attention.py:254-259`).

Semantics (kernel and plain version), per (b, h), phi = softmax over D in
fp32:
  kv = sum over rows < kv_len of phi(k)^T v, ksum = sum of phi(k) (k and v
  rows at or past kv_len masked to 0, after the softmax: a NaN row stays
  out); kvw = kv @ W^T (W the (out, in) `proj_l` weight; torch.matmul
  between the passes, as JAX leaves it to XLA);
  o = phi(q) @ kvw / (1e-5 + phi(q) . ksum) + b.
Rows of q past the true length are garbage in, garbage out.

The kv pass (csrc/linear_attention.cu): per-2048-row partials, then an
ordered sum (K6 folds the same sums for int8 V into its own K/V walk).
Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. `_linear_projected_cuda.launches` counts the calls
(two launches each: the kv pass with its reduce, then the apply).
`linear_attention_projected` is differentiable (an autograd Function whose
backward recomputes the plain version, JAX's custom VJP); the planes form
is inference-only, as in JAX.
"""

from __future__ import annotations

import torch

from turbodiffusion_tpu_torch.ops import _build
from turbodiffusion_tpu_torch.ops.flash_attention import _cdiv, _require
from turbodiffusion_tpu_torch.ops.fused_norm import recompute_vjp

# rows of one linear-kv partial sum (csrc/linear_attention.cu kLinRows)
_LIN_ROWS = 2048


def _softmax_d(x):
    """softmax over the last dim as the JAX kernels write it:
    exp(x - max) / sum."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def linear_kv_plain(k, v, kv_len: int):
    """kv (B, H, D, D) and ksum (B, H, 1, D) fp32 over rows < kv_len of
    (B, H, L, D) k and v (`_kv_kernel`)."""
    valid = (torch.arange(k.shape[2], device=k.device) < kv_len)[:, None]
    pk = torch.where(valid, _softmax_d(k.float()), 0.0)
    vf = torch.where(valid, v.float(), 0.0)
    return torch.matmul(pk.transpose(-1, -2), vf), pk.sum(2, keepdim=True)


def linear_apply_plain(q, kvw, ksum, bias, out_dtype):
    """phi(q) @ kvw / (1e-5 + phi(q) . ksum) + bias over (B, H, L, D) q
    (`_apply_kernel`)."""
    pq = _softmax_d(q.float())
    num = torch.matmul(pq, kvw)
    den = 1e-5 + (pq * ksum).sum(-1, keepdim=True)
    return (num / den + bias.float()).to(out_dtype)


def _projected_plain(q, k, v, weight, bias, kv_len: int, out_dtype):
    kv, ksum = linear_kv_plain(k, v, kv_len)
    kvw = torch.matmul(kv, weight.float().t())
    return linear_apply_plain(q, kvw, ksum, bias, out_dtype)


def linear_projected_planes_plain(qp, kp, vp, weight, bias, true_len: int):
    """Plain version of K21 over (B, H, Lp, D) planes; bf16 out."""
    return _projected_plain(qp, kp, vp, weight, bias, true_len,
                            torch.bfloat16)


def linear_attention_projected_plain(q, k, v, weight, bias):
    """Plain version of K21 over (B, L, H, D); output in q's dtype."""
    o = _projected_plain(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), weight, bias, k.shape[1], q.dtype)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def _strides3(t):
    """(batch, head, row) strides of a (B, H, L, D) view."""
    return [t.stride(0), t.stride(1), t.stride(2)]


def _check_rows(name: str, *ts):
    for t in ts:
        _require(t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
                 and t.data_ptr() % 16 == 0,
                 f"{name} takes a unit last stride and 16-byte aligned rows")


def _linear_kv_sums(k, v, kv_len: int):
    """K21's kv pass: (B, H, L, D) bf16 k and v views -> (kv (B, H, D, D),
    ksum (B, H, 1, D)) fp32. Not counted here: its caller's launcher
    counts."""
    B, H, L, D = k.shape
    dev = k.device
    _require(D == 128 and k.dtype == torch.bfloat16,
             f"the linear kv pass takes bf16 k of head dim 128, got {k.dtype} "
             f"{D}")
    _require(v.shape == k.shape and v.device == dev and v.dtype == torch.bfloat16,
             "the linear kv pass takes bf16 v shaped like k")
    _require(0 < kv_len <= L, f"kv_len {kv_len} out of range")
    _check_rows("the linear kv pass", k, v)
    n_chunks = _cdiv(kv_len, _LIN_ROWS)
    part = torch.empty((B, H, n_chunks, D + 1, D), dtype=torch.float32,
                       device=dev)
    kv = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
    ksum = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)
    rc = _build.load().tdx_linear_kv(
        k.data_ptr(), v.data_ptr(), part.data_ptr(), kv.data_ptr(),
        ksum.data_ptr(), B, H, kv_len, n_chunks, *_strides3(k), *_strides3(v),
        _build.stream_ptr(k))
    _build.check(rc, "tdx_linear_kv")
    return kv, ksum


def _linear_projected_cuda(q, k, v, weight, bias, kv_len: int, out):
    """Launch K21 over (B, H, L, D) views: the kv pass, kvw = kv @ W^T,
    then the apply pass into `out` (a (B, H, Lq, D) bf16 view)."""
    B, H, Lq, D = q.shape
    dev = q.device
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
             "K21 takes bf16 q, k, v")
    _require(q.shape[:2] == k.shape[:2] and q.shape[-1] == D,
             "K21 q (B, H, Lq, D) and k, v (B, H, Lk, D) must agree")
    _check_rows("K21", q, out)
    w = weight.to(device=dev, dtype=torch.float32)
    b = bias.to(device=dev, dtype=torch.float32).contiguous()
    _require(w.shape == (D, D) and b.numel() == D,
             f"K21 proj_l must be ({D}, {D}) with {D} biases")
    kv, ksum = _linear_kv_sums(k, v, kv_len)
    kvw = torch.matmul(kv, w.t()).contiguous()
    rc = _build.load().tdx_linear_apply(
        q.data_ptr(), kvw.data_ptr(), ksum.data_ptr(), b.data_ptr(),
        out.data_ptr(), B, H, Lq, *_strides3(q), *_strides3(out),
        _build.stream_ptr(q))
    _build.check(rc, "tdx_linear_apply")
    _linear_projected_cuda.launches += 1
    return out


_linear_projected_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def linear_projected_planes(qp, kp, vp, weight, bias, true_len: int):
    """proj_l(linear attention) over (B, H, Lp, D) planes with a true length
    (linear_attention_pallas.linear_projected_planes); weight is the
    (out, in) `proj_l` weight. bf16 planes out; rows past true_len are
    garbage. The plain version on a CPU tensor, kernel K21 on a CUDA
    tensor."""
    if qp.device.type == "cpu":
        return linear_projected_planes_plain(qp, kp, vp, weight, bias,
                                             true_len)
    _require(qp.device.type == "cuda", f"no kernel for device {qp.device}")
    out = torch.empty(qp.shape, dtype=torch.bfloat16, device=qp.device)
    return _linear_projected_cuda(qp, kp, vp, weight, bias, true_len, out)


class _LinearProjectedFn(torch.autograd.Function):
    """K21 over (B, L, H, D) forward, plain-recompute backward
    (linear_attention_pallas.py:94-120)."""

    @staticmethod
    def forward(ctx, q, k, v, weight, bias):
        ctx.save_for_backward(q, k, v, weight, bias)
        if q.device.type == "cpu":
            return linear_attention_projected_plain(q, k, v, weight, bias)
        _require(q.device.type == "cuda", f"no kernel for device {q.device}")
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _linear_projected_cuda(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), weight, bias, k.shape[1],
                               out.transpose(1, 2))
        return out

    @staticmethod
    def backward(ctx, g):
        return recompute_vjp(linear_attention_projected_plain,
                             ctx.saved_tensors, ctx.needs_input_grad, g)


def linear_attention_projected(q, k, v, weight, bias):
    """proj_l(linear attention) over (B, L, H, D)
    (linear_attention_pallas.linear_attention_projected); weight is the
    (out, in) `proj_l` weight; output in q's dtype. The plain version on a
    CPU tensor, kernel K21 (reading through strides) on a CUDA tensor;
    differentiable in all five inputs (proj_l is SLA fine-tuning's main
    trainable), by recomputing the plain version, as JAX's custom VJP
    does."""
    return _LinearProjectedFn.apply(q, k, v, weight, bias)
