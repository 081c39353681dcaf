"""Llama-family decoder, training half: the port of
``dlrover_tpu/models/llama.py``.

RMSNorm, rotary embeddings, grouped-query attention, SwiGLU, and optional
GShard top-2 mixture-of-experts blocks, with the JAX model's configuration,
parameter shapes and numerics: fp32 parameters cast to the compute dtype
(bf16) at each use, RMSNorm and RoPE in fp32, an untied LM head and the
sequence-chunked fused cross-entropy of :mod:`.gpt`. Parameters are raw
``nn.Parameter``s of the JAX shapes (``wq (D, H, Hd)``, ``wk (D, KVH,
Hd)``, ``w_gate (E, D, F)``, ...), so carrying weights across is a rename
(:mod:`dlrover_tpu_torch.models.params`).

K and V heads are repeated in place before the attention (head ``g`` serves
query heads ``g*H/KVH .. (g+1)*H/KVH - 1``, as ``jnp.repeat`` orders them),
so the flash kernels serve GQA at equal head counts.

The MoE layer sows its load-balance term under ``("losses", "moe_aux")`` in
the JAX package, and the JAX train step adds ``aux_loss_weight`` times their
sum to the loss. Here each MoE block returns its term through the call that
``torch.utils.checkpoint`` recomputes, and the model collects the terms
outside it into ``aux_losses`` (one scalar a MoE block, from the last
forward), which ``parallel/train_step.py`` reads: a side effect inside the
checkpointed block would run again in backward.

``use_remat`` recomputes each block in backward (``nn.remat`` with
``nothing_saveable``). Not ported yet: decode (``apply_rope_at``, the GQA
KV cache and its int8 variant) and ring attention.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.platform import not_ported, resolve_device
from ..ops.flash_attention import flash_attention
from .gpt import _chunked_token_ce, cross_entropy_loss, dense_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    num_layers: int = 8
    num_heads: int = 8
    num_kv_heads: int = 4  # < num_heads: grouped-query attention
    head_dim: int = 64
    embed_dim: int = 512
    mlp_dim: int = 1408  # ~8/3 * embed, rounded to a multiple of 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_remat: bool = True
    # >0: with targets, compute per-token CE in seq chunks of this size
    # (gpt.GPTConfig.ce_chunk's contract)
    ce_chunk: int = 0
    attention_impl: str = ""  # "" or "dense" | "flash"; "ring" is not ported yet
    kv_cache_int8: bool = False  # decode only, which is not ported yet
    # MoE: num_experts > 0 replaces every `moe_every`-th block's MLP with a
    # top-2 expert layer (0 = dense model)
    num_experts: int = 0
    moe_every: int = 2
    expert_mlp_dim: int = 0  # 0: mlp_dim
    capacity_factor: float = 1.25

    @property
    def moe_mlp_dim(self) -> int:
        return self.expert_mlp_dim or self.mlp_dim

    def is_moe_block(self, layer_idx: int) -> bool:
        """The last block of each group of ``moe_every``: every block for
        1, blocks 1, 3, 5, ... for 2."""
        return self.num_experts > 0 and layer_idx % self.moe_every == self.moe_every - 1

    @staticmethod
    def tiny(**overrides) -> "LlamaConfig":
        base = dict(vocab_size=256, max_seq_len=128, num_layers=2, num_heads=4,
                    num_kv_heads=2, head_dim=8, embed_dim=32, mlp_dim=64, use_remat=False)
        base.update(overrides)
        return LlamaConfig(**base)


def _param(shape, cfg, device):
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))


def _residual_std(cfg) -> float:
    return 0.02 / math.sqrt(2 * cfg.num_layers)


class RMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.scale = _param((cfg.embed_dim,), cfg, device)

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.cfg.rms_eps)
        return (y * self.scale).to(self.cfg.dtype)


def rope_tables(seq_len: int, head_dim: int, theta: float, device=None):
    """(cos, sin) ``[T, head_dim // 2]`` in fp32."""
    freqs = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    angles = torch.outer(torch.arange(seq_len, dtype=torch.float32, device=device), freqs)
    return angles.cos(), angles.sin()


def apply_rope(x, cos, sin):
    """Rotate the two halves of the head dimension; x is ``[B, T, H, Hd]``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1).to(x.dtype)


class LlamaAttention(nn.Module):
    """GQA causal attention with rotary embeddings."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, H, KVH, Hd = cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if H % KVH:
            raise ValueError(f"num_heads {H} not a multiple of kv heads {KVH}")
        self.wq = _param((D, H, Hd), cfg, device)
        self.wk = _param((D, KVH, Hd), cfg, device)
        self.wv = _param((D, KVH, Hd), cfg, device)
        self.wo = _param((H, Hd, D), cfg, device)

    def reset_parameters(self, generator=None) -> None:
        for w in (self.wq, self.wk, self.wv):
            nn.init.normal_(w, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.wo, 0.0, _residual_std(self.cfg), generator=generator)

    def forward(self, x, *, decode: bool = False):
        if decode:
            raise not_ported("Llama decode (apply_rope_at and the GQA KV cache)")
        cfg = self.cfg
        dt = cfg.dtype
        q = torch.einsum("btd,dhk->bthk", x, self.wq.to(dt))
        k = torch.einsum("btd,dgk->btgk", x, self.wk.to(dt))
        v = torch.einsum("btd,dgk->btgk", x, self.wv.to(dt))
        cos, sin = rope_tables(x.shape[1], cfg.head_dim, cfg.rope_theta, x.device)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        # each kv head in place, g, g, ..., g+1 (jnp.repeat's order), and
        # contiguous, as the kernels read it
        rep = cfg.num_heads // cfg.num_kv_heads
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        impl = cfg.attention_impl or "dense"
        if impl == "flash":
            out = flash_attention(q, k, v, causal=True)
        elif impl == "dense":
            out = dense_attention(q, k, v, dt)
        elif impl == "ring":
            raise not_ported("attention_impl='ring' (ring attention)")
        else:
            raise ValueError(f"unknown attention_impl {impl!r}")
        return torch.einsum("bqhk,hkd->bqd", out, self.wo.to(dt))


class SwiGluMlp(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, Fd = cfg.embed_dim, cfg.mlp_dim
        self.w_gate = _param((D, Fd), cfg, device)
        self.w_up = _param((D, Fd), cfg, device)
        self.w_down = _param((Fd, D), cfg, device)

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.w_gate, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.w_up, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.w_down, 0.0, _residual_std(self.cfg), generator=generator)

    def forward(self, x):
        dt = self.cfg.dtype
        h = F.silu(x @ self.w_gate.to(dt)) * (x @ self.w_up.to(dt))
        return h @ self.w_down.to(dt)


def _one_hot(index, n: int):
    """fp32 one-hot of ``index`` (integer or integer-valued float) over
    ``n`` classes; an index outside ``[0, n)`` gives a zero row, as
    ``jax.nn.one_hot`` does."""
    classes = torch.arange(n, dtype=torch.float32, device=index.device)
    return (index[..., None].float() == classes).float()


class MoeMlp(nn.Module):
    """Top-2 SwiGLU experts in the GShard einsum formulation: a ``[B, S, E,
    C]`` dispatch mask from one-hot position-in-expert bookkeeping, with a
    static capacity C a batch row, and dispatch and combine as einsums.
    ``forward`` returns the output and the load-balance term."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, E, Fd = cfg.embed_dim, cfg.num_experts, cfg.moe_mlp_dim
        self.w_router = _param((D, E), cfg, device)
        self.w_gate = _param((E, D, Fd), cfg, device)
        self.w_up = _param((E, D, Fd), cfg, device)
        self.w_down = _param((E, Fd, D), cfg, device)

    def reset_parameters(self, generator=None) -> None:
        for w in (self.w_router, self.w_gate, self.w_up):
            nn.init.normal_(w, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.w_down, 0.0, _residual_std(self.cfg), generator=generator)

    def forward(self, x):
        cfg = self.cfg
        dt = cfg.dtype
        S, E = x.shape[1], cfg.num_experts
        C = max(1, int(cfg.capacity_factor * 2 * S / E))  # per expert, per batch row

        # top-2 gating in fp32; argmax ties take the first index, as in JAX
        probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(), self.w_router), dim=-1)
        gate1 = probs.argmax(-1)
        onehot1 = _one_hot(gate1, E)
        p1 = probs.gather(-1, gate1[..., None])[..., 0]
        masked = probs * (1.0 - onehot1)
        gate2 = masked.argmax(-1)
        p2 = masked.gather(-1, gate2[..., None])[..., 0]
        denom = (p1 + p2).clamp(min=1e-9)
        p1, p2 = p1 / denom, p2 / denom

        # load balance (GShard eq. 4): E * sum of mean gate probability
        # times mean first-choice fraction, per expert
        aux = E * (probs.mean((0, 1)) * onehot1.mean((0, 1))).sum()

        def dispatch_mask(gate, prio_offset):
            onehot = _one_hot(gate, E)  # [B, S, E]
            pos = onehot.cumsum(1) - 1 + prio_offset
            keep = (pos < C) & (onehot > 0)
            return _one_hot(pos, C) * keep[..., None]  # [B, S, E, C]

        mask1 = dispatch_mask(gate1, 0.0)
        # second choices queue behind every first-choice token of the row
        mask2 = dispatch_mask(gate2, onehot1.sum(1, keepdim=True))
        combine = (mask1 * p1[..., None, None] + mask2 * p2[..., None, None]).to(dt)
        dispatch = (mask1 + mask2).to(dt)

        xe = torch.einsum("bsec,bsd->becd", dispatch, x)
        h = F.silu(torch.einsum("becd,edf->becf", xe, self.w_gate.to(dt))) * torch.einsum(
            "becd,edf->becf", xe, self.w_up.to(dt))
        ye = torch.einsum("becf,efd->becd", h, self.w_down.to(dt))
        return torch.einsum("bsec,becd->bsd", combine, ye), aux


class LlamaBlock(nn.Module):
    """``forward(x) -> (x', aux)``: aux is the MoE layer's load-balance
    term, or None for a SwiGLU block."""

    def __init__(self, cfg: LlamaConfig, layer_idx: int = 0, device=None):
        super().__init__()
        self.norm_1 = RMSNorm(cfg, device)
        self.attn = LlamaAttention(cfg, device)
        self.norm_2 = RMSNorm(cfg, device)
        moe = cfg.is_moe_block(layer_idx)
        self.mlp = MoeMlp(cfg, device) if moe else SwiGluMlp(cfg, device)

    def forward(self, x):
        x = x + self.attn(self.norm_1(x))
        out = self.mlp(self.norm_2(x))
        y, aux = out if isinstance(self.mlp, MoeMlp) else (out, None)
        return x + y, aux


class Llama(nn.Module):
    """``forward(tokens [B, T]) -> logits [B, T, V]``; with ``targets``,
    per-token losses ``[B, T]`` through the fused chunked CE (pair with
    :func:`~dlrover_tpu_torch.models.gpt.token_loss_mean`). Each forward
    sets ``aux_losses``, the MoE blocks' load-balance terms.

    Parameters are allocated on ``device`` (resolved by
    :func:`~dlrover_tpu_torch.common.platform.resolve_device`) and
    initialised from ``seed`` as the JAX model's initialisers do (normal
    0.02, residual projections 0.02/sqrt(2L), RMSNorm scales 1).
    """

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.wte = _param((cfg.vocab_size, cfg.embed_dim), cfg, device)
        self.blocks = nn.ModuleList(LlamaBlock(cfg, i, device) for i in range(cfg.num_layers))
        self.norm_f = RMSNorm(cfg, device)
        self.lm_head = _param((cfg.embed_dim, cfg.vocab_size), cfg, device)
        self.aux_losses = []
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def reset_parameters(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            nn.init.normal_(self.wte, 0.0, 0.02, generator=g)
            for module in self.modules():
                if module is not self and hasattr(module, "reset_parameters"):
                    module.reset_parameters(g)
            nn.init.normal_(self.lm_head, 0.0, 0.02, generator=g)

    def forward(self, tokens, *, targets=None, decode: bool = False):
        if decode:
            raise not_ported("Llama decode (apply_rope_at and the GQA KV cache)")
        cfg = self.config
        x = self.wte.to(cfg.dtype)[tokens]
        remat = cfg.use_remat and torch.is_grad_enabled()
        aux_losses = []
        for block in self.blocks:
            x, aux = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if aux is not None:
                aux_losses.append(aux)
        self.aux_losses = aux_losses
        x = self.norm_f(x)
        w_head = self.lm_head.to(cfg.dtype)
        if targets is not None:
            return _chunked_token_ce(x, w_head, targets, cfg.ce_chunk or tokens.shape[1],
                                     vocab_first=False)
        return x @ w_head


def llama_loss(logits, targets, aux_weight: float = 0.01):
    """Mean next-token CE of ``logits``. As in the JAX package, the MoE
    terms are not added here (``aux_weight`` is unused): the train step
    adds them from the model's ``aux_losses``."""
    del aux_weight
    return cross_entropy_loss(logits, targets)
