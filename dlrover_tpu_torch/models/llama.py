"""Llama-family decoder, training and decode: the port of
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
``nothing_saveable``).

Decode mode (``forward(tokens, decode=True, positions=, kv_valid=,
cache_slots=, cache=)`` returns ``(logits, cache)``) takes the KV cache of
:mod:`.gpt` (its structure and in-place writes, its int8 variant): RoPE
turns q and k at each row's absolute positions (:func:`apply_rope_at`), the
cache holds the narrow pre-repeat K/V (``[B, max_seq_len, KVH, Hd]``, no
``repeat_kv``), and the attention contracts the query heads against it by
groups. A MoE block computes its ``B x T`` tokens as the training forward
does (the capacity of a one-token step is 1); its load-balance term is not
collected in decode.

Each parameter's logical axes are the JAX model's ``param_with_axes``
annotations (:func:`logical_axes`). On a mesh (``parallel/sharding.py``'s
``shard_model``) the forward runs on each process's blocks, with the
collectives XLA inserts for the JAX model, as :mod:`.gpt`'s does (fsdp
gathers before use, reduce-scatters in backward; column- and row-parallel
tp; the embedding and the untied head split over the vocabulary, the head
through the split cross-entropy):

- GQA under tp: ``wq`` and ``wo`` are split over the heads, ``wk`` and
  ``wv`` (``kv_heads``) are whole on every tp rank. Each rank projects only
  the kv groups of its own query heads and repeats them in
  ``jnp.repeat``'s order (:func:`kv_groups`, :func:`repeat_kv`), so the
  gradients of ``wk`` and ``wv`` are partial on each tp rank: they are
  summed over tp (in fp32, before the fsdp reduce-scatter).
- The MoE on ep: the gating (softmax over all experts, top-2, capacity) runs
  whole on every ep rank; each rank dispatches, computes and combines only
  its own experts, and the output is summed over ep. The combine weights'
  gradient reaches the router partial (this rank's experts), so it is
  summed over ep; the load-balance term's is whole on every rank and is
  not. The experts' hidden dim (``expert_mlp``) is split over tp as a
  column- then row-parallel pair.
- The load-balance term is the JAX program's, over the global batch: each
  process sums the gate probabilities and the first choices over its
  tokens, the sums go through one all-reduce over the tokens' axes ``(dp,
  fsdp, sp)`` (``collectives.sum_over_group``, which sums the gradient in
  backward too) and are divided by the global token count, so every process
  holds the same term. The train step's mean over those axes then averages
  the ranks' gradients of it, each of which is already that of the whole
  term.
- sp, as in :mod:`.gpt`: each process holds a block of the sequence, RoPE
  turns its rows at their global positions (:func:`rope_tables` from
  ``coord["sp"] * T_local``), ring attention runs after the GQA repeat, as
  the JAX model's does, and the loss is the mean over the whole sequence.
  A MoE row's expert capacity and positions are those of the whole row: the
  capacity counts the global sequence, and each process's positions in an
  expert start after the earlier blocks' tokens of that row (a prefix of the
  counts gathered over sp); second choices queue behind every first choice
  of the row.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.platform import resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import ring_attention_sharded
from ..parallel import collectives
from ..parallel.sharding import shard_layout
from .gpt import (_axis_group, _chunked_token_ce, _embed, _gathered, _mesh_of, _placed_mesh,
                  _ring_mesh, _tp_group, _vocab_split, advance_cache, cached_decode_attention,
                  cross_entropy_loss, decode_mask, dense_attention, seq_offset,
                  whole_params_only)

# each parameter's logical axes, as the JAX model's param_with_axes names them
_TOP_AXES = {
    "wte": ("vocab", "embed"),
    "norm_f.scale": ("norm",),
    "lm_head": ("embed", "vocab"),
}
_BLOCK_AXES = {
    "norm_1.scale": ("norm",),
    "norm_2.scale": ("norm",),
    "attn.wq": ("embed", "heads", "kv"),
    "attn.wk": ("embed", "kv_heads", "kv"),
    "attn.wv": ("embed", "kv_heads", "kv"),
    "attn.wo": ("heads", "kv", "embed"),
}
_SWIGLU_AXES = {
    "mlp.w_gate": ("embed", "mlp"),
    "mlp.w_up": ("embed", "mlp"),
    "mlp.w_down": ("mlp", "embed"),
}
_MOE_AXES = {
    "mlp.w_router": ("embed", None),
    "mlp.w_gate": ("expert", "embed", "expert_mlp"),
    "mlp.w_up": ("expert", "embed", "expert_mlp"),
    "mlp.w_down": ("expert", "expert_mlp", "embed"),
}


def logical_axes(name: str, moe: bool = False):
    """The logical axes of the parameter ``name`` of :class:`Llama`;
    ``moe`` says that its block's MLP is the expert layer."""
    if name in _TOP_AXES:
        return _TOP_AXES[name]
    rest = name.split(".", 2)[2]
    if rest in _BLOCK_AXES:
        return _BLOCK_AXES[rest]
    return (_MOE_AXES if moe else _SWIGLU_AXES)[rest]


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
    attention_impl: str = ""  # "" or "dense" | "flash" | "ring" (sp-sharded)
    # int8 decode KV cache with per-token per-kv-head scales (gpt.GPTConfig's)
    kv_cache_int8: bool = False
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


def rope_tables(seq_len: int, head_dim: int, theta: float, device=None, start: int = 0):
    """(cos, sin) ``[T, head_dim // 2]`` in fp32, for positions ``start ..
    start + seq_len - 1``: rows ``start ..`` of the JAX tables of a longer
    sequence."""
    freqs = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    positions = torch.arange(start, start + seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(positions, freqs)
    return angles.cos(), angles.sin()


def apply_rope(x, cos, sin):
    """Rotate the two halves of the head dimension; x is ``[B, T, H, Hd]``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1).to(x.dtype)


def apply_rope_at(x, cos_table, sin_table, positions):
    """RoPE at per-row absolute positions; x ``[B, T, H, Hd]``, positions
    ``[B, T]``: the decode path's variant of :func:`apply_rope`, whose
    left-padded rows sit at different positions for the same cache slot,
    so the angle tables are gathered per (row, slot)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos_table[positions][:, :, None, :]  # [B, T, 1, Hd // 2]
    sin = sin_table[positions][:, :, None, :]
    return torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1).to(x.dtype)


def kv_groups(first: int, heads: int, rep: int):
    """``(g0, g1, offset)``: query heads ``first .. first + heads - 1`` use
    kv groups ``g0 .. g1 - 1`` (group ``g`` serves heads ``g*rep ..
    (g+1)*rep - 1``), and head ``first`` is head ``offset`` of those groups
    repeated."""
    g0 = first // rep
    return g0, -(-(first + heads) // rep), first - g0 * rep


def repeat_kv(k, rep: int, offset: int, heads: int):
    """The kv heads ``k`` (``[B, T, G, Hd]``) repeated ``rep`` times each in
    place (g, g, ..., g+1: ``jnp.repeat``'s order), and ``heads`` of them
    from ``offset``: contiguous when they are every repeated head, as a
    rank's are when its query heads cover whole groups."""
    return k.repeat_interleave(rep, dim=2)[:, :, offset:offset + heads]


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

    def forward(self, x):
        cfg = self.cfg
        dt = cfg.dtype
        tp = _tp_group(self.wq, 1, _mesh_of(self.wq))  # the query heads split over tp
        heads = self.wq.shape[1]  # this rank's query heads
        first = shard_layout(self.wq).index[1][0] if tp is not None else 0
        rep = cfg.num_heads // cfg.num_kv_heads
        g0, g1, offset = kv_groups(first, heads, rep)
        wq, wo = _gathered((self.wq, self.wo), dt)
        # wk and wv are whole on every tp rank, and each rank uses only its
        # heads' kv groups: their gradients are summed over tp, in fp32
        wk, wv = (_gathered((collectives.copy_to_group(w, tp)[:, g0:g1],), dt, like=(w,))[0]
                  for w in (self.wk, self.wv))
        x = collectives.copy_to_group(x, tp)
        q = torch.einsum("btd,dhk->bthk", x, wq)
        k = torch.einsum("btd,dgk->btgk", x, wk)
        v = torch.einsum("btd,dgk->btgk", x, wv)
        impl = cfg.attention_impl or "dense"
        start = seq_offset(impl, x.shape[1])  # global positions under sp
        cos, sin = rope_tables(x.shape[1], cfg.head_dim, cfg.rope_theta, x.device, start)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        k, v = repeat_kv(k, rep, offset, heads), repeat_kv(v, rep, offset, heads)
        if impl == "flash":
            out = flash_attention(q, k, v, causal=True)
        elif impl == "dense":
            out = dense_attention(q, k, v, dt)
        elif impl == "ring":
            out = ring_attention_sharded(q, k, v, _ring_mesh(), causal=True)
        else:
            raise ValueError(f"unknown attention_impl {impl!r}")
        return collectives.reduce_from_group(torch.einsum("bqhk,hkd->bqd", out, wo), tp)

    def decode(self, x, layer, mask, slots, offset, positions, rope):
        """RoPE at ``positions`` from the tables ``rope`` (cos, sin of every
        position), then the KVH-narrow K/V into ``layer`` and attention over
        the cache (:func:`~.gpt.cached_decode_attention`)."""
        dt = self.cfg.dtype
        q = torch.einsum("btd,dhk->bthk", x, self.wq.to(dt))
        k = torch.einsum("btd,dgk->btgk", x, self.wk.to(dt))
        v = torch.einsum("btd,dgk->btgk", x, self.wv.to(dt))
        q, k = (apply_rope_at(t, *rope, positions) for t in (q, k))
        return cached_decode_attention(layer, q, k, v, mask, self.wo.to(dt), self.cfg, slots,
                                       offset)


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
        tp = _tp_group(self.w_gate, 1, _mesh_of(self.w_gate))  # the hidden columns split over tp
        w_gate, w_up, w_down = _gathered((self.w_gate, self.w_up, self.w_down), dt)
        x = collectives.copy_to_group(x, tp)
        h = F.silu(x @ w_gate) * (x @ w_up)
        return collectives.reduce_from_group(h @ w_down, tp)


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
        placed = _placed_mesh(self.w_router)
        sp = None if placed is None else placed.group_of("sp")  # the row's sequence split
        S, E = x.shape[1] * (1 if sp is None else placed.shape["sp"]), cfg.num_experts
        C = max(1, int(cfg.capacity_factor * 2 * S / E))  # per expert, per (whole) batch row
        mesh = _mesh_of(self.w_gate)
        ep = _axis_group(self.w_gate, 0, "ep", mesh)  # the experts split over ep
        tp = _tp_group(self.w_gate, 2, mesh)  # each expert's hidden dim split over tp
        (w_router,) = _gathered((self.w_router,), torch.float32)

        # top-2 gating in fp32; argmax ties take the first index, as in JAX
        probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(), w_router), dim=-1)
        gate1 = probs.argmax(-1)
        onehot1 = _one_hot(gate1, E)
        aux = _load_balance(probs, onehot1, placed)
        # the combine weights reach the router through this rank's experts
        # only: their gradient is summed over ep (the load balance's is not)
        gated = collectives.copy_to_group(probs, ep, part="ep")
        p1 = gated.gather(-1, gate1[..., None])[..., 0]
        masked = gated * (1.0 - onehot1)
        gate2 = masked.argmax(-1)
        p2 = masked.gather(-1, gate2[..., None])[..., 0]
        denom = (p1 + p2).clamp(min=1e-9)
        p1, p2 = p1 / denom, p2 / denom

        # this rank's experts (all of them off a mesh); positions within an
        # expert's capacity depend on that expert's choices alone
        first, last = shard_layout(self.w_gate).index[0] if ep is not None else (0, E)

        local1, local2 = onehot1[..., first:last], _one_hot(gate2, E)[..., first:last]
        # each choice's tokens of this block of the rows, by expert: [2, B, 1, E_local]
        counts = torch.stack((local1, local2)).sum(2, keepdim=True)
        before, row = torch.zeros_like(counts), counts
        if sp is not None:  # the blocks of the rows before this one, and the whole rows
            blocks = collectives.all_gather(counts[None], sp, part="moe_aux")
            before = blocks[:placed.coord["sp"]].sum(0)
            row = blocks.sum(0)

        def dispatch_mask(onehot, prio_offset):  # onehot: [B, S_local, E_local]
            pos = onehot.cumsum(1) - 1 + prio_offset
            keep = (pos < C) & (onehot > 0)
            return _one_hot(pos, C) * keep[..., None]  # [B, S_local, E_local, C]

        mask1 = dispatch_mask(local1, before[0])
        # second choices queue behind every first-choice token of the row
        mask2 = dispatch_mask(local2, row[0] + before[1])
        combine = (mask1 * p1[..., None, None] + mask2 * p2[..., None, None]).to(dt)
        dispatch = (mask1 + mask2).to(dt)

        w_gate, w_up, w_down = _gathered((self.w_gate, self.w_up, self.w_down), dt)
        xe = torch.einsum("bsec,bsd->becd", dispatch, collectives.copy_to_group(x, ep, part="ep"))
        xe = collectives.copy_to_group(xe, tp)
        h = F.silu(torch.einsum("becd,edf->becf", xe, w_gate)) * torch.einsum(
            "becd,edf->becf", xe, w_up)
        ye = collectives.reduce_from_group(torch.einsum("becf,efd->becd", h, w_down), tp)
        y = torch.einsum("bsec,becd->bsd", combine, ye)
        return collectives.reduce_from_group(y, ep, part="ep"), aux


def _load_balance(probs, onehot1, mesh):
    """GShard eq. 4, ``E * sum_e me_e * ce_e``: the mean gate probability
    and the mean first-choice fraction of each expert over the global
    batch. On a mesh whose tokens are split over several processes (the
    data axes and sp) the sums over this process's tokens go through one
    all-reduce over those axes whose backward sums too
    (``collectives.sum_over_group``), so every process holds the global term
    and its gradient is that of the whole term."""
    E = probs.shape[-1]
    sums = torch.cat([probs.sum((0, 1)), onehot1.sum((0, 1))])
    tokens = probs.shape[0] * probs.shape[1]
    if mesh is not None and mesh.token_extent > 1:
        sums = collectives.sum_over_group(sums, mesh.token_group)
        tokens *= mesh.token_extent
    me, ce = sums[:E] / tokens, sums[E:] / tokens
    return E * (me * ce).sum()


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

    def decode(self, x, layer, mask, slots, offset, positions, rope):
        x = x + self.attn.decode(self.norm_1(x), layer, mask, slots, offset, positions, rope)
        out = self.mlp(self.norm_2(x))
        return x + (out[0] if isinstance(self.mlp, MoeMlp) else out)


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

    def logical_axes(self, name: str):
        """The logical axes of the parameter ``name``."""
        block = name.split(".", 2)[1] if name.startswith("blocks.") else None
        return logical_axes(name, moe=block is not None and self.config.is_moe_block(int(block)))

    def reset_parameters(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            nn.init.normal_(self.wte, 0.0, 0.02, generator=g)
            for module in self.modules():
                if module is not self and hasattr(module, "reset_parameters"):
                    module.reset_parameters(g)
            nn.init.normal_(self.lm_head, 0.0, 0.02, generator=g)

    def forward(self, tokens, *, targets=None, decode: bool = False, positions=None,
                kv_valid=None, cache_slots=None, cache=None):
        if decode:
            return self._decode(tokens, positions, kv_valid, cache_slots, cache)
        cfg = self.config
        (wte,) = _gathered((self.wte,), cfg.dtype)
        x = _embed(wte, tokens, _vocab_split(self.wte, 0, _mesh_of(self.wte)))
        remat = cfg.use_remat and torch.is_grad_enabled()
        aux_losses = []
        for block in self.blocks:
            x, aux = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if aux is not None:
                aux_losses.append(aux)
        self.aux_losses = aux_losses
        x = self.norm_f(x)
        (w_head,) = _gathered((self.lm_head,), cfg.dtype)
        vocab = _vocab_split(self.lm_head, 1, _mesh_of(self.lm_head))  # the untied head's columns
        if vocab is not None:
            x = collectives.copy_to_group(x, vocab[0])
        if targets is not None:
            return _chunked_token_ce(x, w_head, targets, cfg.ce_chunk or tokens.shape[1],
                                     vocab_first=False, vocab=vocab)
        logits = x @ w_head
        return logits if vocab is None else collectives.gather_from_group(logits, vocab[0], -1)


    def _decode(self, tokens, positions, kv_valid, cache_slots, cache):
        """Decode mode: ``(logits [B, T, V], cache)``; see the module's
        docstring."""
        cfg = self.config
        if positions is None:
            raise ValueError("decode=True needs absolute positions")
        if cache is None:
            raise ValueError("decode=True needs a cache (generation.init_cache)")
        whole_params_only(self)
        mask, slots, offset = decode_mask(cache, tokens.shape, kv_valid, cache_slots)
        rope = self._rope_tables()
        x = self.wte.to(cfg.dtype)[tokens]
        for block, layer in zip(self.blocks, cache["layers"]):
            x = block.decode(x, layer, mask, slots, offset, positions, rope)
        advance_cache(cache, tokens.shape[1], slots)
        return self.norm_f(x) @ self.lm_head.to(cfg.dtype), cache

    def _rope_tables(self):
        """(cos, sin) of every position below ``max_seq_len`` on the model's
        device, made once (the JAX model makes them in each traced call)."""
        key = str(self.device)
        tables = self.__dict__.setdefault("_decode_rope", {})
        if key not in tables:
            cfg = self.config
            tables[key] = rope_tables(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, self.device)
        return tables[key]


def llama_loss(logits, targets, aux_weight: float = 0.01):
    """Mean next-token CE of ``logits``. As in the JAX package, the MoE
    terms are not added here (``aux_weight`` is unused): the train step
    adds them from the model's ``aux_losses``."""
    del aux_weight
    return cross_entropy_loss(logits, targets)
