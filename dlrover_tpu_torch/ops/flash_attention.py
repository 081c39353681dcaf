"""Flash attention, forward and backward: the port of
``dlrover_tpu/ops/flash_attention.py``.

The public API is the JAX package's: :func:`flash_attention` over
``[batch, seq, heads, head_dim]`` tensors with an end-aligned causal mask,
and :func:`reference_attention`, the einsum oracle. The gradient is a
``torch.autograd.Function`` (the counterpart of the ``custom_vjp``) that
saves ``q, k, v, out, lse``.

Each of the three Pallas kernels has two counterparts here:

- a CUDA kernel written for Hopper, ``csrc/flash_attention.cu``, which the
  wrapper launches for CUDA tensors (bf16, head_dim 64 or 128) and which
  reads ``[B, T, H, D]`` through strides, by TMA into wgmma (see
  ``csrc/hopper.cuh``);
- a plain PyTorch version over the ``[batch*heads, seq, head_dim]`` layout
  with the reference's semantics (zero padding to the block sizes, the
  end-aligned causal offset ``kv_len - q_len``, the backward's
  ``q_idx < q_len`` mask), which the wrapper takes for CPU tensors and
  which the chip smoke test holds each kernel against.

A CUDA tensor the kernels do not take raises; nothing falls back.
``launches`` counts the kernel launches, one entry per kernel, so a run
can show that it went through the kernels.
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
_NEG_INF = -1e30
_KERNEL_HEAD_DIMS = (64, 128)

launches = {"fwd": 0, "bwd_dkdv": 0, "bwd_dq": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kernel_tiles(name: str, head_dim: int) -> Tuple[int, int]:
    """The CUDA kernel's tile as the plain versions' ``(block_q, block_k)``:
    the forward's 128 query rows by 128 keys; dK/dV's 128 keys by a streamed
    tile of 64 query rows (32 at head_dim 128, to fit its registers); dQ's
    128 query rows by a streamed tile of 128 keys (64 at head_dim 128, to fit
    its registers)."""
    if name == "fwd":
        return 128, 128
    if name == "bwd_dkdv":
        return (64 if head_dim == 64 else 32), 128
    if name == "bwd_dq":
        return 128, (128 if head_dim == 64 else 64)
    raise ValueError(f"no flash attention kernel named {name!r}")


# ---------------------------------------------------------------------------
# plain versions ([BH, T, D], the reference's blocking and masks)
# ---------------------------------------------------------------------------


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _clamp_blocks(dtype, t_q, t_kv, block_q, block_k):
    """Block sizes clamped to the sequence, kept a multiple of 16 for
    2-byte types and 8 otherwise, as the reference clamps them."""
    sublane = 16 if dtype.itemsize <= 2 else 8
    block_q = min(block_q, _round_up(max(t_q, sublane), sublane))
    block_k = min(block_k, _round_up(max(t_kv, sublane), sublane))
    return block_q, block_k


def _pad_rows(x, size):
    """Zero-pad dim 1 of ``x`` to ``size``."""
    pad = size - x.shape[1]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], dim=1)


def _blocking(q, k, block_q, block_k):
    t_q, t_kv = q.shape[1], k.shape[1]
    block_q, block_k = _clamp_blocks(q.dtype, t_q, t_kv, block_q, block_k)
    return block_q, block_k, _round_up(t_q, block_q), _round_up(t_kv, block_k)


def _visible(iq, ik, block_q, block_k, off, causal):
    """The reference's run condition: a K block strictly right of the Q
    block's last row is skipped."""
    return not causal or ik * block_k <= iq * block_q + block_q - 1 + off


def _mask(iq, ik, block_q, block_k, t_q, t_kv, causal, device, *, bwd):
    q_idx = iq * block_q + torch.arange(block_q, device=device)[:, None]
    k_idx = ik * block_k + torch.arange(block_k, device=device)[None, :]
    mask = k_idx < t_kv
    if bwd:
        mask = mask & (q_idx < t_q)
    if causal:
        mask = mask & (k_idx <= q_idx + (t_kv - t_q))
    return mask


def flash_fwd_plain(
    q, k, v, scale: float, causal: bool, block_q: int, block_k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel. q,k,v ``[BH, T, D]`` ->
    (out ``[BH, Tq, D]`` in q's dtype, lse ``[BH, Tq]`` fp32)."""
    bh, t_q, d = q.shape
    t_kv = k.shape[1]
    block_q, block_k, tq_pad, tk_pad = _blocking(q, k, block_q, block_k)
    qp = _pad_rows(q, tq_pad).float()
    kp = _pad_rows(k, tk_pad).float()
    vp = _pad_rows(v, tk_pad)
    off = t_kv - t_q
    out = q.new_empty((bh, tq_pad, d))
    lse = torch.empty((bh, tq_pad), dtype=torch.float32, device=q.device)
    for iq in range(tq_pad // block_q):
        rows = slice(iq * block_q, (iq + 1) * block_q)
        m = torch.full((bh, block_q, 1), _NEG_INF, device=q.device)
        l = torch.zeros((bh, block_q, 1), device=q.device)
        acc = torch.zeros((bh, block_q, d), device=q.device)
        for ik in range(tk_pad // block_k):
            if not _visible(iq, ik, block_q, block_k, off, causal):
                continue
            cols = slice(ik * block_k, (ik + 1) * block_k)
            s = qp[:, rows] @ kp[:, cols].transpose(1, 2) * scale
            mask = _mask(iq, ik, block_q, block_k, t_q, t_kv, causal, q.device, bwd=False)
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            m = m_new
            acc = acc * alpha + p.to(v.dtype).float() @ vp[:, cols].float()
        l_safe = torch.where(l == 0.0, 1.0, l)
        out[:, rows] = (acc / l_safe).to(q.dtype)
        lse[:, rows] = (m + torch.log(l_safe))[..., 0]
    return out[:, :t_q], lse[:, :t_q]


def _bwd_blocks(q, k, v, do, lse, delta, block_q, block_k):
    """Padded fp32 operands shared by the two backward plain versions."""
    block_q, block_k, tq_pad, tk_pad = _blocking(q, k, block_q, block_k)
    padded = dict(
        q=_pad_rows(q, tq_pad).float(),
        k=_pad_rows(k, tk_pad).float(),
        v=_pad_rows(v, tk_pad).float(),
        do=_pad_rows(do, tq_pad).float(),
        lse=_pad_rows(lse, tq_pad)[..., None],
        delta=_pad_rows(delta, tq_pad)[..., None],
    )
    return block_q, block_k, tq_pad, tk_pad, padded


def _probs_and_ds(x, iq, ik, block_q, block_k, t_q, t_kv, scale, causal):
    rows = slice(iq * block_q, (iq + 1) * block_q)
    cols = slice(ik * block_k, (ik + 1) * block_k)
    s = x["q"][:, rows] @ x["k"][:, cols].transpose(1, 2) * scale
    mask = _mask(iq, ik, block_q, block_k, t_q, t_kv, causal, s.device, bwd=True)
    p = torch.where(mask, torch.exp(s - x["lse"][:, rows]), 0.0)
    dp = x["do"][:, rows] @ x["v"][:, cols].transpose(1, 2)
    ds = p * (dp - x["delta"][:, rows]) * scale
    return rows, cols, p, ds


def flash_bwd_dkdv_plain(
    q, k, v, do, lse, delta, scale: float, causal: bool, block_q: int, block_k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel. q, do ``[BH, Tq, D]``; k, v
    ``[BH, Tk, D]``; lse, delta ``[BH, Tq]`` fp32 -> (dk, dv) ``[BH, Tk, D]``."""
    t_q, t_kv, d = q.shape[1], k.shape[1], q.shape[2]
    block_q, block_k, tq_pad, tk_pad, x = _bwd_blocks(
        q, k, v, do, lse, delta, block_q, block_k
    )
    dk = torch.zeros((q.shape[0], tk_pad, d), device=q.device)
    dv = torch.zeros_like(dk)
    for ik in range(tk_pad // block_k):
        for iq in range(tq_pad // block_q):
            if not _visible(iq, ik, block_q, block_k, t_kv - t_q, causal):
                continue
            rows, cols, p, ds = _probs_and_ds(
                x, iq, ik, block_q, block_k, t_q, t_kv, scale, causal
            )
            dv[:, cols] += p.to(do.dtype).float().transpose(1, 2) @ x["do"][:, rows]
            dk[:, cols] += ds.to(q.dtype).float().transpose(1, 2) @ x["q"][:, rows]
    return dk[:, :t_kv].to(k.dtype), dv[:, :t_kv].to(v.dtype)


def flash_bwd_dq_plain(
    q, k, v, do, lse, delta, scale: float, causal: bool, block_q: int, block_k: int
) -> torch.Tensor:
    """Plain version of the dQ kernel; arguments as for
    :func:`flash_bwd_dkdv_plain` -> dq ``[BH, Tq, D]``."""
    t_q, t_kv, d = q.shape[1], k.shape[1], q.shape[2]
    block_q, block_k, tq_pad, tk_pad, x = _bwd_blocks(
        q, k, v, do, lse, delta, block_q, block_k
    )
    dq = torch.zeros((q.shape[0], tq_pad, d), device=q.device)
    for iq in range(tq_pad // block_q):
        for ik in range(tk_pad // block_k):
            if not _visible(iq, ik, block_q, block_k, t_kv - t_q, causal):
                continue
            rows, cols, _, ds = _probs_and_ds(
                x, iq, ik, block_q, block_k, t_q, t_kv, scale, causal
            )
            dq[:, rows] += ds.to(k.dtype).float() @ x["k"][:, cols]
    return dq[:, :t_q].to(q.dtype)


def softmax_delta(do, out):
    """``rowsum(dO * O)`` in fp32 over the last dim: the backward's
    ``delta``, a plain tensor op in the reference too."""
    return (do.float() * out.float()).sum(-1)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------


@functools.cache
def _lib():
    """The kernels' library, built at first use, with its C signatures."""
    from . import _build

    lib = _build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i, i, i, i, i, f, i, p]  # B, H, q_len, kv_len, D, scale, causal, stream
    lib.flash_fwd.argtypes = [p] * 5 + [i] * 9 + tail
    lib.flash_bwd_dq.argtypes = [p] * 7 + [i] * 12 + tail
    lib.flash_bwd_dkdv.argtypes = [p] * 8 + [i] * 12 + tail
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkdv):
        fn.restype = i
    lib.flash_error_string.argtypes = [i]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _operand(x):
    """``x`` as the kernels read it: D stride 1, 16-byte aligned rows, and
    strides that fit the C interface's ints."""
    if (
        x.stride(-1) != 1
        or x.data_ptr() % 16
        or any(s % 8 for s in x.stride()[:3])
    ):
        x = x.contiguous()
    if max(x.stride()) >= 2**31:
        raise ValueError(f"tensor strides {x.stride()} exceed the kernels' int range")
    return x


def _check_kernel_inputs(q, k, v):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"flash attention kernels take bf16, got {name} {x.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be [B, T, H, D], got {tuple(x.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    b, t_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim 64 or 128, got {d}")
    if t_q == 0 or k.shape[1] == 0 or b * h == 0 or b * h > 65535:
        raise ValueError(f"shape {tuple(q.shape)} / {tuple(k.shape)} out of the kernels' range")


def _check_launch(err: int, name: str) -> None:
    if err:
        msg = _lib().flash_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def _dims(x):
    return x.stride(0), x.stride(1), x.stride(2)


def flash_fwd_cuda(q, k, v, scale: float, causal: bool):
    """Forward kernel. q,k,v ``[B, T, H, D]`` bf16 on the card ->
    (out ``[B, Tq, H, D]``, lse ``[B*H, Tq]`` fp32)."""
    _check_kernel_inputs(q, k, v)
    q, k, v = _operand(q), _operand(k), _operand(v)
    b, t_q, h, d = q.shape
    out = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            *_dims(q), *_dims(k), *_dims(v),
            b, h, t_q, k.shape[1], d, scale, int(causal), stream,
        )
    _check_launch(err, "flash_fwd")
    launches["fwd"] += 1
    return out, lse


def delta_bh(do, out):
    """``softmax_delta`` of ``[B, T, H, D]`` tensors in the kernels' layout,
    contiguous ``[B*H, T]`` fp32."""
    b, t, h, _ = do.shape
    # contiguous first: at B=1 the reshape alone would return a strided view
    return softmax_delta(do, out).transpose(1, 2).contiguous().view(b * h, t)


def _bwd_args(q, k, v, do, lse, delta, scale, causal):
    _check_kernel_inputs(q, k, v)
    _check_kernel_inputs(do, k, v)
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} and q {tuple(q.shape)} disagree")
    b, t_q, h, d = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.shape != (b * h, t_q) or not x.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous fp32 [B*H, Tq], got {x.dtype} {tuple(x.shape)}"
            )
    q, k, v, do = _operand(q), _operand(k), _operand(v), _operand(do)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (*_dims(q), *_dims(k), *_dims(v), *_dims(do),
            b, h, t_q, k.shape[1], d, scale, int(causal))
    return ptrs, dims


def flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, scale: float, causal: bool):
    """dK/dV kernel. q, do ``[B, Tq, H, D]``; k, v ``[B, Tk, H, D]``, bf16
    on the card; lse, delta ``[B*H, Tq]`` fp32 -> (dk, dv) ``[B, Tk, H, D]``."""
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, scale, causal)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_bwd_dkdv(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, stream)
    _check_launch(err, "flash_bwd_dkdv")
    launches["bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float, causal: bool):
    """dQ kernel; arguments as for :func:`flash_bwd_dkdv_cuda` -> dq
    ``[B, Tq, H, D]``."""
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, scale, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_bwd_dq(*ptrs, dq.data_ptr(), *dims, stream)
    _check_launch(err, "flash_bwd_dq")
    launches["bwd_dq"] += 1
    return dq


# ---------------------------------------------------------------------------
# public API over [B, T, H, D]
# ---------------------------------------------------------------------------


def _to_bht(x):
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d)


def _from_bht(x, b, h):
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).transpose(1, 2)


def _on_cpu(x, what):
    if x.device.type == "cuda":
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"flash attention has no {what} for device {x.device}")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        if _on_cpu(q, "forward"):
            b, h = q.shape[0], q.shape[2]
            out3, lse = flash_fwd_plain(
                _to_bht(q), _to_bht(k), _to_bht(v), scale, causal, block_q, block_k
            )
            out = _from_bht(out3, b, h)
        else:
            out, lse = flash_fwd_cuda(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, block_q, block_k = ctx.args
        if _on_cpu(q, "backward"):
            b, h = q.shape[0], q.shape[2]
            q3, k3, v3, do3 = _to_bht(q), _to_bht(k), _to_bht(v), _to_bht(g)
            delta = softmax_delta(do3, _to_bht(out))
            args = (q3, k3, v3, do3, lse, delta, scale, causal, block_q, block_k)
            dk3, dv3 = flash_bwd_dkdv_plain(*args)
            dq3 = flash_bwd_dq_plain(*args)
            dq, dk, dv = (_from_bht(x, b, h) for x in (dq3, dk3, dv3))
        else:
            delta = delta_bh(g, out)
            args = (q, k, v, g, lse, delta, scale, causal)
            dk, dv = flash_bwd_dkdv_cuda(*args)
            dq = flash_bwd_dq_cuda(*args)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q,
    k,
    v,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
):
    """Flash attention over ``[batch, seq, heads, head_dim]`` tensors.

    ``block_q``/``block_k`` set the blocking of the plain CPU version; the
    CUDA kernels size their own tiles."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, causal, scale, block_q, block_k)


def reference_attention(q, k, v, causal: bool = True, sm_scale=None):
    """Naive einsum attention, the correctness oracle for kernel tests."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        mask = torch.ones((t_q, t_k), dtype=torch.bool, device=q.device).tril(t_k - t_q)
        logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
