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

The kernels (csrc/linear_attention.cu): the kv pass (`k21::kv_kernel`,
persistent blocks walking runs of 64-row chunks, phi^T V on wgmma from phi
split exactly into three bf16 parts against bf16 V, Kahan-compensated fp32
sums, one partial a run and head, then `k21::kv_reduce_kernel` adding a
head's partials in run order) and the apply pass (`k21::apply_kernel`,
phi(q) in registers split into bf16 hi / lo against kvw's hi / lo on
wgmma). K6 folds the same kv sums for int8 V into its own K/V walk.
Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernels (`linear_form` names the one form) or raises.
`_linear_projected_cuda.launches` counts the calls (three launches each:
the kv pass, its reduce, then the apply).
`linear_attention_projected` is differentiable (an autograd Function whose
backward recomputes the plain version, JAX's custom VJP); the planes form
is inference-only, as in JAX.
"""

from __future__ import annotations

import functools

import torch

from turbodiffusion_tpu_torch.ops import _build
from turbodiffusion_tpu_torch.ops.flash_attention import _cdiv, _require
from turbodiffusion_tpu_torch.ops.fused_norm import recompute_vjp

# rows of a kv-pass chunk (csrc/linear_attention.cu k21::kRows) and floats
# of a partial (linear_kv.cuh linkv::kSlot: 128 kv rows, then ksum)
_KV_ROWS = 64
_SLOT = (128 + 1) * 128


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


def linear_form(B: int, H: int, Lq: int, kv_len: int, ptrs, strides) -> str:
    """The form a K21 launch takes (csrc/linear_attention.cu
    `tdx_linear_form`): "wgmma", the TMA-fed wgmma kv and apply passes, for
    q, k, v and out views with 16-byte aligned pointers (`ptrs`) and
    positive (batch, head, row) strides of 8-element multiples (`strides`,
    12: q, k, v, out); raises where no form computes."""
    _require(B > 0 and H > 0 and Lq > 0 and kv_len > 0,
             f"K21 takes B, H, Lq, kv_len > 0, got {B}, {H}, {Lq}, {kv_len}")
    _require(B * H * _cdiv(max(Lq, kv_len), _KV_ROWS) < 2 ** 31,
             "K21 takes fewer than 2^31 row chunks")
    _require(all(p % 16 == 0 for p in ptrs), "K21 takes 16-byte aligned views")
    _require(all(s > 0 and s % 8 == 0 for s in strides),
             "K21 takes strides of positive 8-element multiples")
    return "wgmma"


def kv_grid(B: int, H: int, kv_len: int, resident: int) -> int:
    """Blocks of a kv-pass launch (csrc/linear_attention.cu `k21::kv_grid`):
    one a resident block (`resident`: SMs x blocks an SM), at least one a
    (b, h) so that no run spans more than two heads, at most one a
    64-row chunk."""
    return min(B * H * _cdiv(kv_len, _KV_ROWS), max(max(1, resident), B * H))


@functools.lru_cache(maxsize=None)
def _kv_grid_on_card(device: int, B: int, H: int, kv_len: int) -> int:
    with torch.cuda.device(device):
        return _build.load().tdx_linear_kv_grid(B, H, kv_len)


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
    grid = _kv_grid_on_card(dev.index if dev.index is not None
                            else torch.cuda.current_device(), B, H, kv_len)
    _require(grid > 0, "the linear kv pass refused the shape")
    part = torch.empty((2 * grid, _SLOT), dtype=torch.float32, device=dev)
    kv = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
    ksum = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)
    rc = _build.load().tdx_linear_kv(
        k.data_ptr(), v.data_ptr(), part.data_ptr(), kv.data_ptr(),
        ksum.data_ptr(), B, H, kv_len, grid, *_strides3(k), *_strides3(v),
        _build.stream_ptr(k))
    _build.check(rc, "tdx_linear_kv")
    return kv, ksum


def _linear_projected_cuda(q, k, v, weight, bias, kv_len: int, out):
    """Launch K21 over (B, H, L, D) views in its form (`linear_form`): the
    kv pass, kvw = kv @ W^T, then the apply pass into `out` (a (B, H, Lq, D)
    bf16 view)."""
    B, H, Lq, D = q.shape
    dev = q.device
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
             "K21 takes bf16 q, k, v")
    _require(q.shape[:2] == k.shape[:2] and q.shape[-1] == D,
             "K21 q (B, H, Lq, D) and k, v (B, H, Lk, D) must agree")
    _require(out.shape == q.shape and out.dtype == torch.bfloat16
             and out.device == dev, "K21 writes a bf16 out shaped like q")
    _require(all(t.stride(-1) == 1 for t in (q, k, v, out)),
             "K21 takes views with a unit channel stride")
    linear_form(B, H, Lq, kv_len, [t.data_ptr() for t in (q, k, v, out)],
                _strides3(q) + _strides3(k) + _strides3(v) + _strides3(out))
    w = weight.to(device=dev, dtype=torch.float32)
    b = bias.to(device=dev, dtype=torch.float32).contiguous()
    if b.data_ptr() % 16:
        b = b.clone()
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
