"""W8A8 linears: kernels K8 (row quantiser), K9 (postscale GEMM), K10
(quant-out GEMM), K11 (block-activation GEMM) and K22 (128x128 block-scaled
GEMM).

Ports `turbodiffusion_tpu/ops/quant.py`. The postscale layout:
  * `quantize_int8_postscale` (:74-82) — per-out-channel weight quantiser;
  * `quantize_rows_int8` — K8 `_quantize_rows_cuda` replaces the TPU kernel
    `quantize_rows_int8_pallas` (launch :121, body `_rowquant_kernel`
    :101-106). K8 and its plain version follow `_rowquant_kernel` (fp32, no
    clip), not the jnp `quantize_rows_int8` (:89-98, a multiply in the input
    dtype and a clip), which JAX runs off the TPU;
  * `int8_gemm_postscale` — K9 replaces `int8_gemm_postscale_pallas` (:253,
    body `_postscale_gemm_kernel` :133-162, weight-resident `_postscale_wres`
    :408);
  * `int8_gemm_postscale_qout` — K10 replaces
    `int8_gemm_postscale_qout_pallas` (:561, `_postscale_gemm_qout_kernel`
    :277-317, `_qout_wres` :490);
  * `int8_gemm_blockact` — K11 replaces `int8_gemm_blockact_pallas` (:750,
    `_blockact_gemm_kernel` :577-610, `_blockact_wres` :679);
  * `int8_linear_prequant` (the consumer of the int8 feeds K12-K14),
    `int8_linear_postscale`, `linear_maybe_quant` (:763-810, :926-957),
    `fuse_linear_params`, `quantize_linear_params` and
    `quantize_wan_blocks` (:960-1012), over `Int8Linear` modules.

The block layout (the reference's `Int8Linear` checkpoints):
  * `quantize_int8_block` (:43-59) and `quantize_activation_block`
    (:62-71): scale = max(amax, 1e-8) / 127 per 128x128 block, q =
    round(x / scale) half to even (a division, not K8's `* (1/127)`);
  * `int8_block_matmul` — K22 replaces `_int8_block_matmul_pallas` (:890,
    body `_gemm_kernel` :837-858); its plain version loops over the K
    blocks in order as the TPU kernel does (`int8_block_matmul_ref`
    :817-834 sums the same terms in another order);
  * `int8_linear_block` (:904-919) and the block branch of
    `linear_maybe_quant` (:954-957: GELU, gate and residual after the GEMM,
    in the output dtype), over `Int8BlockLinear` modules.

Weights: both linears hold their int8 weight (out, in) — K-contiguous, the
operand layout of the GEMM kernels — where JAX stores (in, out); the JAX
tree loader transposes. An `Int8BlockLinear`'s scale is (out/128, in/128),
the reference's on-disk layout, so a checkpoint loads without a transpose.
`Int8BlockLinear` is not an `Int8Linear`: the model's `isinstance(...,
Int8Linear)` tests keep it off the postscale int8 feeds (K12-K14), as JAX's
`scale.ndim == 1` tests do.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel (csrc/quant.cu) or raises. `.launches` counts launches. The plain
GEMMs take the exact int32 product in float64 (|127 * 127 * K| < 2^53).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from turbodiffusion_tpu_torch.models.layers import gelu_tanh
from turbodiffusion_tpu_torch.ops import _build
from turbodiffusion_tpu_torch.ops.flash_attention import _require

INT8_MAX = 127.0
_GELU_C = 0.7978845608028654        # sqrt(2 / pi), rounded to fp32 in use
_ACTS = {None: 0, "gelu_tanh": 1}
_TILE = 128                         # N multiple of the GEMM kernels
QBLOCK = 128                        # block of the block layout (both axes)
_BK = 64                            # K multiple of the GEMM kernels


def pick_bn_div(N: int) -> int:
    """Largest multiple of 128 in [384, 1024] dividing N, else 0: the column
    block of K10's int8 scales and K11's K slab (quant.py:265-274)."""
    best = 0
    for m in range(3, 9):
        if N % (m * 128) == 0:
            best = m * 128
    return best


def gelu_tanh_f32(x):
    """jax.nn.gelu(approximate=True) as JAX writes it, in fp32:
    x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3))))."""
    inner = x + 0.044715 * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(_GELU_C * inner)))


# ---------------------------------------------------------------------------
# quantisers
# ---------------------------------------------------------------------------

def quantize_int8_postscale(w):
    """Per-out-channel weight quant of an (out, in) weight (quant.py:74-82 on
    the transposed layout): scale = max(amax, 1e-8) / 127, q = round(w /
    scale), half to even. Returns (int8 (out, in), fp32 scale (out,))."""
    wf = w.float()
    scale = wf.abs().amax(1).clamp_min(1e-8) / INT8_MAX
    return torch.round(wf / scale[:, None]).to(torch.int8), scale


def quantize_rows_int8_plain(x2):
    """Plain version of K8 (`_rowquant_kernel`): (M, K) -> (int8 (M, K),
    fp32 (M, 1)); scale = max(amax, 1e-8) * (1/127), q = round(x *
    (1/scale)) half to even, in fp32."""
    x = x2.float()
    scale = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / INT8_MAX)
    return torch.round(x * (1.0 / scale)).to(torch.int8), scale


def _quantize_rows_cuda(x2):
    """Launch K8. x2 (M, K) bf16, unit last stride, 16-byte aligned rows."""
    M, K = x2.shape
    _require(x2.dtype == torch.bfloat16, "K8 takes a bf16 activation")
    _require(x2.stride(1) == 1 and x2.stride(0) % 8 == 0 and K % 8 == 0
             and x2.data_ptr() % 16 == 0,
             "K8 takes 16-byte aligned rows with a unit last stride")
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    rs = torch.empty((M, 1), dtype=torch.float32, device=x2.device)
    rc = _build.load().tdx_quantize_rows_int8(
        x2.data_ptr(), x2.stride(0), xq.data_ptr(), rs.data_ptr(), M, K,
        _build.stream_ptr(x2))
    _build.check(rc, "tdx_quantize_rows_int8")
    _quantize_rows_cuda.launches += 1
    return xq, rs


_quantize_rows_cuda.launches = 0


def quantize_rows_int8(x2):
    """Per-row symmetric int8 of an (M, K) activation: the plain version on
    a CPU tensor, kernel K8 on a CUDA tensor."""
    if x2.device.type == "cpu":
        return quantize_rows_int8_plain(x2)
    _require(x2.device.type == "cuda", f"no kernel for device {x2.device}")
    return _quantize_rows_cuda(x2)


# ---------------------------------------------------------------------------
# K9-K11: plain versions
# ---------------------------------------------------------------------------

def _int_product(xq, wq):
    """Exact int32 (M, K) x (N, K)^T product, as float64."""
    return torch.matmul(xq.double(), wq.double().t())


def _epilogue(out, bias, act, gate, residual, out_dtype):
    """The fp32 epilogue after the scales (quant.py:152-162): + bias, GELU,
    * gate, + residual, one cast."""
    if bias is not None:
        out = out + bias.float()
    if act == "gelu_tanh":
        out = gelu_tanh_f32(out)
    if gate is not None:
        out = out * gate.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype)


def int8_gemm_postscale_plain(xq, row_scale, wq, col_scale, bias=None,
                              act: Optional[str] = None, gate=None,
                              residual=None, out_dtype=torch.bfloat16):
    """Plain version of K9: ((xq @ wq^T) * row_scale * col_scale) (+ bias)
    (GELU) (* gate) (+ residual). xq (M, K) int8; row_scale (M, 1); wq
    (N, K) int8; col_scale, bias, gate (N,); residual (M, N)."""
    out = _int_product(xq, wq).float() * row_scale.float() * col_scale.float()
    return _epilogue(out, bias, act, gate, residual, out_dtype)


def int8_gemm_postscale_qout_plain(xq, row_scale, wq, col_scale, bias=None,
                                   act: Optional[str] = None):
    """Plain version of K10: K9's values up to the GELU, then int8 with one
    fp32 scale per (row, BN columns), BN = pick_bn_div(N), from the fp32
    values. Returns (int8 (M, N), fp32 (M, N // BN))."""
    M, N = xq.shape[0], wq.shape[0]
    bn = pick_bn_div(N)
    _require(bn > 0, f"N={N} has no multiple of 128 in [384, 1024] dividing it")
    out = _int_product(xq, wq).float() * row_scale.float() * col_scale.float()
    out = _epilogue(out, bias, act, None, None, torch.float32)
    blocks = out.reshape(M, N // bn, bn)
    scale = blocks.abs().amax(-1, keepdim=True).clamp_min(1e-8) * (1.0 / INT8_MAX)
    q = torch.round(blocks * (1.0 / scale)).to(torch.int8)
    return q.reshape(M, N), scale[..., 0]


def int8_gemm_blockact_plain(xq, x_scale, wq, col_scale, bias=None,
                             act: Optional[str] = None, bk: int = 512,
                             gate=None, residual=None,
                             out_dtype=torch.bfloat16):
    """Plain version of K11: sum over K slabs kb of bk columns, in order, of
    float(xq_kb @ wq_kb^T) * x_scale[:, kb], in fp32; then * col_scale and
    K9's epilogue. x_scale (M, K // bk)."""
    K = xq.shape[1]
    _require(K % bk == 0, f"K={K} is not a multiple of the slab {bk}")
    acc = None
    for kb in range(K // bk):
        sl = slice(kb * bk, (kb + 1) * bk)
        term = (_int_product(xq[:, sl], wq[:, sl]).float()
                * x_scale[:, kb:kb + 1].float())
        acc = term if acc is None else acc + term
    out = acc * col_scale.float()
    return _epilogue(out, bias, act, gate, residual, out_dtype)


# ---------------------------------------------------------------------------
# K9-K11: launchers
# ---------------------------------------------------------------------------

def _f32(t, n: int, dev, what: str):
    if t is None:
        return None
    t = t.reshape(-1).to(torch.float32).contiguous()
    _require(t.numel() == n and t.device == dev,
             f"{what} must hold {n} values on the activation's device")
    return t


def _gemm_operands(name: str, xq, wq, col_scale, bias):
    M, K = xq.shape
    N = wq.shape[0]
    dev = xq.device
    _require(xq.dtype == wq.dtype == torch.int8, f"{name} takes int8 operands")
    _require(xq.is_contiguous() and wq.is_contiguous() and wq.device == dev
             and wq.shape[1] == K,
             f"{name} takes contiguous xq (M, K) and wq (N, K) on one device")
    _require(N % _TILE == 0 and K % _BK == 0 and M > 0,
             f"{name} takes N a multiple of {_TILE} and K of {_BK}, "
             f"got N={N}, K={K}")
    return (M, N, K, _f32(col_scale, N, dev, "col_scale"),
            _f32(bias, N, dev, "bias"))


def _residual(residual, M: int, N: int, dev):
    if residual is None:
        return None
    residual = residual.reshape(M, N)
    _require(residual.dtype == torch.bfloat16 and residual.is_contiguous()
             and residual.device == dev,
             "the residual must be a contiguous bf16 (M, N) tensor")
    return residual


def _ptr(t):
    return None if t is None else t.data_ptr()


def _int8_gemm_postscale_cuda(xq, row_scale, wq, col_scale, bias, act, gate,
                              residual):
    """Launch K9 (bf16 output, a fresh buffer)."""
    M, N, K, cs, b = _gemm_operands("K9", xq, wq, col_scale, bias)
    dev = xq.device
    rs = _f32(row_scale, M, dev, "row_scale")
    g = _f32(gate, N, dev, "gate")
    res = _residual(residual, M, N, dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    rc = _build.load().tdx_int8_gemm_postscale(
        xq.data_ptr(), wq.data_ptr(), rs.data_ptr(), cs.data_ptr(), _ptr(b),
        _ptr(g), _ptr(res), out.data_ptr(), M, N, K, _ACTS[act],
        _build.stream_ptr(xq))
    _build.check(rc, "tdx_int8_gemm_postscale")
    _int8_gemm_postscale_cuda.launches += 1
    return out


_int8_gemm_postscale_cuda.launches = 0


def _int8_gemm_qout_cuda(xq, row_scale, wq, col_scale, bias, act):
    """Launch K10: one thread-block cluster per (128 rows, BN columns)."""
    M, N, K, cs, b = _gemm_operands("K10", xq, wq, col_scale, bias)
    dev = xq.device
    bn = pick_bn_div(N)
    _require(bn > 0, f"N={N} has no multiple of 128 in [384, 1024] dividing it")
    rs = _f32(row_scale, M, dev, "row_scale")
    q = torch.empty((M, N), dtype=torch.int8, device=dev)
    s = torch.empty((M, N // bn), dtype=torch.float32, device=dev)
    rc = _build.load().tdx_int8_gemm_qout(
        xq.data_ptr(), wq.data_ptr(), rs.data_ptr(), cs.data_ptr(), _ptr(b),
        q.data_ptr(), s.data_ptr(), M, N, K, bn, _ACTS[act],
        _build.stream_ptr(xq))
    _build.check(rc, "tdx_int8_gemm_qout")
    _int8_gemm_qout_cuda.launches += 1
    return q, s


_int8_gemm_qout_cuda.launches = 0


def _int8_gemm_blockact_cuda(xq, x_scale, wq, col_scale, bias, act, bk,
                             gate, residual):
    """Launch K11 (bf16 output, a fresh buffer)."""
    M, N, K, cs, b = _gemm_operands("K11", xq, wq, col_scale, bias)
    dev = xq.device
    _require(bk % _BK == 0 and K % bk == 0,
             f"K11 takes a slab that is a multiple of {_BK} dividing K, got {bk}")
    xs = _f32(x_scale, M * (K // bk), dev, "x_scale")
    g = _f32(gate, N, dev, "gate")
    res = _residual(residual, M, N, dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    rc = _build.load().tdx_int8_gemm_blockact(
        xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), cs.data_ptr(), _ptr(b),
        _ptr(g), _ptr(res), out.data_ptr(), M, N, K, bk, _ACTS[act],
        _build.stream_ptr(xq))
    _build.check(rc, "tdx_int8_gemm_blockact")
    _int8_gemm_blockact_cuda.launches += 1
    return out


_int8_gemm_blockact_cuda.launches = 0


def int8_gemm_postscale(xq, row_scale, wq, col_scale, bias=None,
                        act: Optional[str] = None, gate=None, residual=None,
                        out_dtype=torch.bfloat16):
    """W8A8 postscale GEMM (quant.int8_gemm_postscale_pallas) over wq (N, K):
    the plain version on a CPU tensor, kernel K9 (bf16 out) on a CUDA
    tensor."""
    if xq.device.type == "cpu":
        return int8_gemm_postscale_plain(xq, row_scale, wq, col_scale, bias,
                                         act, gate, residual, out_dtype)
    _require(xq.device.type == "cuda", f"no kernel for device {xq.device}")
    _require(out_dtype == torch.bfloat16, "K9 writes bf16")
    return _int8_gemm_postscale_cuda(xq, row_scale, wq, col_scale, bias, act,
                                     gate, residual)


def int8_gemm_postscale_qout(xq, row_scale, wq, col_scale, bias=None,
                             act: Optional[str] = None):
    """W8A8 GEMM with an int8 + per-(row, BN) scale epilogue
    (quant.int8_gemm_postscale_qout_pallas): the plain version on a CPU
    tensor, kernel K10 on a CUDA tensor."""
    if xq.device.type == "cpu":
        return int8_gemm_postscale_qout_plain(xq, row_scale, wq, col_scale,
                                              bias, act)
    _require(xq.device.type == "cuda", f"no kernel for device {xq.device}")
    return _int8_gemm_qout_cuda(xq, row_scale, wq, col_scale, bias, act)


def int8_gemm_blockact(xq, x_scale, wq, col_scale, bias=None,
                       act: Optional[str] = None, bk: int = 512, gate=None,
                       residual=None, out_dtype=torch.bfloat16):
    """W8A8 GEMM over a per-(row, K slab)-scaled int8 activation
    (quant.int8_gemm_blockact_pallas): the plain version on a CPU tensor,
    kernel K11 (bf16 out) on a CUDA tensor."""
    if xq.device.type == "cpu":
        return int8_gemm_blockact_plain(xq, x_scale, wq, col_scale, bias, act,
                                        bk, gate, residual, out_dtype)
    _require(xq.device.type == "cuda", f"no kernel for device {xq.device}")
    _require(out_dtype == torch.bfloat16, "K11 writes bf16")
    return _int8_gemm_blockact_cuda(xq, x_scale, wq, col_scale, bias, act, bk,
                                    gate, residual)


# ---------------------------------------------------------------------------
# the 128x128 block layout: quantisers, K22
# ---------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad2(t, rows: int, cols: int):
    """t (R, C) zero-padded at the end to (rows, cols); t itself if no pad."""
    R, C = t.shape
    if (R, C) == (rows, cols):
        return t
    return torch.nn.functional.pad(t, (0, cols - C, 0, rows - R))


def quantize_int8_block(w, block: int = QBLOCK):
    """Per-(block x block) symmetric quant of an (out, in) weight
    (quant.py:43-59 on the transposed layout): scale = max(amax, 1e-8) / 127
    per block, q = round(w / scale) half to even. Returns (int8 (out, in),
    fp32 scale (cdiv(out, block), cdiv(in, block)))."""
    N, K = w.shape
    Nb, Kb = _cdiv(N, block), _cdiv(K, block)
    wb = _pad2(w.float(), Nb * block, Kb * block).reshape(Nb, block, Kb, block)
    scale = wb.abs().amax(dim=(1, 3)).clamp_min(1e-8) / INT8_MAX
    q = torch.round(wb / scale[:, None, :, None]).to(torch.int8)
    return q.reshape(Nb * block, Kb * block)[:N, :K].contiguous(), scale


def quantize_activation_block(x2, block: int = QBLOCK):
    """Per-(block x block) quant of an (M, K) activation (quant.py:62-71):
    the rule of `quantize_int8_block`. Returns (int8 (M, K), fp32 scales
    (cdiv(M, block), cdiv(K, block))). JAX returns its zero-padded
    (Mb * block, Kb * block) int8 and slices it back to (M, K); the port
    pads K only where it must and never M (K22 masks rows past M)."""
    M, K = x2.shape
    Mb, Kb = _cdiv(M, block), _cdiv(K, block)
    xp = _pad2(x2, M, Kb * block)
    amax = xp.abs().reshape(M, Kb, block).amax(-1).float()        # exact
    amax = _pad2(amax, Mb * block, Kb).reshape(Mb, block, Kb).amax(1)
    scale = amax.clamp_min(1e-8) / INT8_MAX                        # (Mb, Kb)
    rows = scale.repeat_interleave(block, 0)[:M]                   # (M, Kb)
    q = xp.float().reshape(M, Kb, block).div_(rows[..., None]).round_()
    return q.to(torch.int8).reshape(M, Kb * block)[:, :K], scale


def int8_block_matmul_plain(xq, xs, wq, ws, bias=None,
                            out_dtype=torch.float32, block: int = QBLOCK):
    """Plain version of K22, the TPU kernel's arithmetic: for each K block
    kb in order, acc += float(xq_kb @ wq_kb^T) * (xs[m, kb] * ws[n, kb]) in
    fp32, then + bias, one cast. xq (M, K) int8, xs (cdiv(M, 128), Kb); wq
    (N, K) int8, ws (cdiv(N, 128), Kb); K past its last full block
    zero-padded."""
    M, K = xq.shape
    N = wq.shape[0]
    Kb = _cdiv(K, block)
    xq, wq = _pad2(xq, M, Kb * block), _pad2(wq, N, Kb * block)
    acc = None
    for kb in range(Kb):
        sl = slice(kb * block, (kb + 1) * block)
        sc = xs[:, kb].float()[:, None] * ws[:, kb].float()[None, :]
        sc = sc.repeat_interleave(block, 0)[:M].repeat_interleave(block, 1)[:, :N]
        term = _int_product(xq[:, sl], wq[:, sl]).float() * sc
        acc = term if acc is None else acc + term
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(out_dtype)


def _int8_block_matmul_cuda(xq, xs, wq, ws, bias, out_dtype):
    """Launch K22. K and N are zero-padded to multiples of 128 as JAX pads
    them (quant.py:866-867); rows past M are masked in the kernel."""
    M, K = xq.shape
    N = wq.shape[0]
    dev = xq.device
    _require(xq.dtype == wq.dtype == torch.int8 and wq.shape[1] == K
             and wq.device == dev and M > 0,
             "K22 takes int8 xq (M, K) and wq (N, K) on one device")
    _require(out_dtype in (torch.float32, torch.bfloat16),
             "K22 writes fp32 or bf16")
    Mb, Kb, Nb = _cdiv(M, QBLOCK), _cdiv(K, QBLOCK), _cdiv(N, QBLOCK)
    xq = _pad2(xq, M, Kb * QBLOCK).contiguous()
    wq = _pad2(wq, Nb * QBLOCK, Kb * QBLOCK).contiguous()
    xs = _f32(xs, Mb * Kb, dev, "xs")
    ws = _f32(ws, Nb * Kb, dev, "ws")
    b = None if bias is None else _f32(
        torch.nn.functional.pad(bias.reshape(-1).float(), (0, Nb * QBLOCK - N)),
        Nb * QBLOCK, dev, "bias")
    out = torch.empty((M, Nb * QBLOCK), dtype=out_dtype, device=dev)
    rc = _build.load().tdx_int8_gemm_block(
        xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(), _ptr(b),
        out.data_ptr(), int(out_dtype == torch.float32), M, Nb * QBLOCK,
        Kb * QBLOCK, _build.stream_ptr(xq))
    _build.check(rc, "tdx_int8_gemm_block")
    _int8_block_matmul_cuda.launches += 1
    return out if Nb * QBLOCK == N else out[:, :N]


_int8_block_matmul_cuda.launches = 0


def int8_block_matmul(xq, xs, wq, ws, bias=None, out_dtype=torch.float32):
    """W8A8 GEMM with 128x128 block scales on both operands
    (quant._int8_block_matmul_pallas, over wq (N, K) and ws (Nb, Kb)): the
    plain version on a CPU tensor, kernel K22 on a CUDA tensor."""
    if xq.device.type == "cpu":
        return int8_block_matmul_plain(xq, xs, wq, ws, bias, out_dtype)
    _require(xq.device.type == "cuda", f"no kernel for device {xq.device}")
    return _int8_block_matmul_cuda(xq, xs, wq, ws, bias, out_dtype)


# ---------------------------------------------------------------------------
# linears
# ---------------------------------------------------------------------------

class _QuantLinear(nn.Module):
    """A W8A8 linear's storage: buffers `w_int8` (out, in) int8 and
    `scale` fp32 (its layout's shape), parameter `bias` (out,) in the model
    dtype or None. A subclass gives the layout: its scale shape and
    weight quantiser."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("w_int8", torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            self._scale_shape(in_features, out_features), dtype=torch.float32,
            device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device))
                     if bias else None)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear):
        """Quantise an nn.Linear to this layout (quant.py:1000-1012); the
        float weight is not kept."""
        q = cls(lin.in_features, lin.out_features, lin.bias is not None,
                lin.weight.device, lin.weight.dtype)
        q.w_int8, q.scale = cls._quantize(lin.weight)
        if lin.bias is not None:
            q.bias.copy_(lin.bias)
        return q

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")


class Int8Linear(_QuantLinear):
    """A W8A8 postscale linear (the JAX `{"w_int8", "scale", "b"}` leaf with
    a 1-D scale): `scale` (out,), one per output channel."""

    @staticmethod
    def _scale_shape(in_features, out_features):
        return (out_features,)

    @staticmethod
    def _quantize(w):
        return quantize_int8_postscale(w)

    def forward(self, x, act: Optional[str] = None, gate=None, residual=None):
        return int8_linear_postscale(x, self.w_int8, self.scale, self.bias,
                                     act, gate, residual)


class Int8BlockLinear(_QuantLinear):
    """A W8A8 linear with 128x128 block scales (the reference `Int8Linear`,
    ops/core.py:391-432; the JAX leaf with a 2-D scale): `scale`
    (cdiv(out, 128), cdiv(in, 128)). Not an `Int8Linear`, so the block
    keeps it off the postscale int8 feeds. The input is quantised per
    128x128 block at every call (plain torch), then K22."""

    @staticmethod
    def _scale_shape(in_features, out_features):
        return (_cdiv(out_features, QBLOCK), _cdiv(in_features, QBLOCK))

    @staticmethod
    def _quantize(w):
        return quantize_int8_block(w)

    def forward(self, x):
        return int8_linear_block(x, self.w_int8, self.scale, self.bias)


def int8_linear_block(x, w_int8, scale, bias=None):
    """Dynamic-activation-quant W8A8 linear with block scales
    (quant.py:904-919): `quantize_activation_block` (plain torch, as JAX
    leaves it to XLA), then K22; output in x's dtype (K22 writes it, one
    rounding as JAX's fp32 output + astype)."""
    shape = x.shape
    xq, xs = quantize_activation_block(x.reshape(-1, shape[-1]))
    y = int8_block_matmul(xq, xs, w_int8, scale, bias, out_dtype=x.dtype)
    return y.reshape(*shape[:-1], w_int8.shape[0])


def int8_linear_prequant(xq, row_scale, lin: Int8Linear,
                         act: Optional[str] = None, gate=None, residual=None,
                         out_dtype=torch.bfloat16):
    """A postscale linear over a quantised activation (xq (..., K) int8,
    row_scale (..., 1)) (quant.py:763-777), the consumer of the int8 feeds
    (K12, K13, K14): K9 with the residual (..., N) and a batch-1 gate ((N,)
    or (1, 1, N)) fused into the epilogue. A gate over a batch > 1 is
    applied after the GEMM as `residual + y * gate` in the output dtype
    (wan.py:146-149)."""
    _require(isinstance(lin, Int8Linear),
             f"the int8 feeds take postscale linears, not {type(lin).__name__}")
    shape = xq.shape
    N = lin.out_features
    if gate is not None and gate.dim() > 1 and gate.shape[0] > 1:
        y = int8_linear_prequant(xq, row_scale, lin, act, out_dtype=out_dtype)
        return _finish(y, gate, residual)
    y = int8_gemm_postscale(
        xq.reshape(-1, shape[-1]), row_scale.reshape(-1, 1), lin.w_int8,
        lin.scale, lin.bias, act, None if gate is None else gate.reshape(-1),
        None if residual is None else residual.reshape(-1, N), out_dtype)
    return y.reshape(*shape[:-1], N)


def int8_linear_postscale(x, w_int8, col_scale, bias=None,
                          act: Optional[str] = None, gate=None,
                          residual=None):
    """rowquant(x) then the postscale GEMM (quant.py:780-796, the TPU
    branch): K8 then K9, output in x's dtype; gate (N,) and residual fused
    into K9's epilogue."""
    shape = x.shape
    N = w_int8.shape[0]
    xq, rs = quantize_rows_int8(x.reshape(-1, shape[-1]))
    y = int8_gemm_postscale(
        xq, rs, w_int8, col_scale, bias, act, gate,
        None if residual is None else residual.reshape(-1, N), x.dtype)
    return y.reshape(*shape[:-1], N)


def _finish(y, gate=None, residual=None):
    """`residual + y * gate` as linear_maybe_quant's epilogue does it
    (quant.py:933-938): the gate is cast to y's dtype first."""
    if gate is not None:
        y = y * gate.to(y.dtype)
    if residual is not None:
        y = y + residual
    return y


def linear_maybe_quant(lin, x, act: Optional[str] = None, gate=None,
                       residual=None):
    """A float (nn.Linear), block-scaled (Int8BlockLinear) or postscale
    (Int8Linear) linear with an optional GELU-tanh and `residual + y * gate`
    (quant.py:926-957). On the postscale path a batch-1 gate and the
    residual ride K9's epilogue, a gate over a batch > 1 is applied after;
    on the float and block paths all three follow the GEMM, in the output
    dtype."""
    if isinstance(lin, (nn.Linear, Int8BlockLinear)):
        y = lin(x)
        return _finish(gelu_tanh(y) if act == "gelu_tanh" else y, gate,
                       residual)
    _require(isinstance(lin, Int8Linear), f"not a linear: {type(lin)}")
    if gate is None or gate.shape[0] == 1:
        g = None if gate is None else gate.reshape(-1)
        return lin(x, act=act, gate=g, residual=residual)
    return _finish(lin(x, act=act), gate, residual)


def fuse_linear_params(parts):
    """Concatenate linears that share one input into one wide linear along
    the output dim (quant.py:960-975): Int8Linear parts give an Int8Linear
    (per-channel scales concatenate exactly), nn.Linear parts an
    nn.Linear."""
    first = parts[0]
    _require(not isinstance(first, Int8BlockLinear),
             "QKV fusion takes float or postscale linears (pipeline.py:87-93 "
             "fuses only postscale)")
    has_bias = first.bias is not None
    out = sum(p.out_features for p in parts)
    with torch.no_grad():
        if isinstance(first, Int8Linear):
            fused = Int8Linear(first.in_features, out, has_bias,
                               first.w_int8.device,
                               first.bias.dtype if has_bias else None)
            fused.w_int8 = torch.cat([p.w_int8 for p in parts], 0)
            fused.scale = torch.cat([p.scale for p in parts], 0)
        else:
            fused = nn.Linear(first.in_features, out, has_bias,
                              device=first.weight.device,
                              dtype=first.weight.dtype)
            fused.weight.copy_(torch.cat([p.weight for p in parts], 0))
        if has_bias:
            fused.bias.copy_(torch.cat([p.bias for p in parts], 0))
    return fused


LINEAR_LAYOUTS = {"postscale": Int8Linear, "block": Int8BlockLinear}


def quantize_linear_params(lin, mode: str = "postscale"):
    """An nn.Linear -> its quantised layout (quant.py:1000-1012): "postscale"
    (Int8Linear) or "block" (Int8BlockLinear); anything else passes
    through."""
    _require(mode in LINEAR_LAYOUTS, f"unknown W8A8 layout {mode!r}")
    return (LINEAR_LAYOUTS[mode].from_linear(lin) if isinstance(lin, nn.Linear)
            else lin)


def quantize_wan_blocks(blocks, mode: str = "postscale",
                        fuse_qkv: bool = True):
    """Quantise every linear of the transformer blocks in place, skipping
    the SLA `proj_l` (quant.py:978-997). fuse_qkv (postscale mode only, as
    in JAX): self-attention Q/K/V become one `qkv` linear (q, k, v set to
    None) whose output the attention reads by column group. Returns
    `blocks`."""
    for blk in blocks:
        for attn in (blk.self_attn, blk.cross_attn):
            for name in ("q", "k", "v", "o"):
                setattr(attn, name,
                        quantize_linear_params(getattr(attn, name), mode))
        if fuse_qkv and mode == "postscale":
            sa = blk.self_attn
            sa.qkv = fuse_linear_params([sa.q, sa.k, sa.v])
            sa.q = sa.k = sa.v = None
        for name in ("fc1", "fc2"):
            setattr(blk.ffn, name,
                    quantize_linear_params(getattr(blk.ffn, name), mode))
    return blocks
