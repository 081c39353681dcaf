"""GPT decoder-only transformer, training and decode: the port of
``dlrover_tpu/models/gpt.py``.

Same configuration, parameter shapes and numerics as the JAX model: fp32
parameters cast to the compute dtype (bf16) at each use, LayerNorm in fp32
with eps 1e-5, the tanh GELU (``jax.nn.gelu``'s default), a tied LM head,
and an optional sequence-chunked fused cross-entropy. Parameters are raw
``nn.Parameter``s of the JAX shapes (``wqkv (D, 3, H, Hd)``,
``wo (H, Hd, D)``, ...), so carrying weights across is a rename
(:mod:`dlrover_tpu_torch.models.params`).

``use_remat`` recomputes each block in backward with
``torch.utils.checkpoint`` (the counterpart of ``nn.remat`` with
``remat_policy="nothing"``). Not ported yet: the ``"dots"`` remat policy.

Decode mode (``forward(tokens, decode=True, positions=, kv_valid=,
cache_slots=, cache=)`` returns ``(logits, cache)``) is the JAX model's
incremental decoding over a KV cache. Torch has no flax ``"cache"``
collection, so the cache is an explicit structure (``empty_cache``):
``{"index": int, "layers": [{"k", "v"[, "k_scale", "v_scale"]}, ...]}``,
one entry a layer, ``k`` and ``v`` of ``[B, max_seq_len, KVH, Hd]`` in the
compute dtype (``int8`` with ``kv_cache_int8``, beside fp32 scales
``[B, max_seq_len, KVH]``), and ``index`` the shared write offset, a host
integer. The write is in place (a slice copy at ``index``, or an
``index_put_`` at ``cache_slots``), so no step copies the whole cache: the
returned cache is the object passed in, and a caller that keeps an older
reference sees the new contents. A caller that needs the old contents
(a stored prefix) clones it first (:func:`clone_cache`). Remat is bypassed
in decode, the learned positions are gathered per row (``wpe[positions]``),
and the attention is the plain masked one over the whole cache
(:func:`cached_decode_attention`), never the flash kernels, as in the JAX
model. Decode runs on whole parameters: on a mesh it raises.

Each parameter's logical axes are the JAX model's ``param_with_axes``
annotations (:func:`logical_axes`). On a mesh (``parallel/sharding.py``'s
``shard_model`` keeps each process's block of every parameter) the forward
runs on the blocks, with the collectives XLA would insert for the JAX
model, found through ``parallel.mesh.get_current_mesh``:

- fsdp: each layer gathers its fsdp-split weights (their compute-dtype
  cast) just before use, and the gradient is reduce-scattered in backward;
  under remat the block gathers again in its recompute;
- tp: ``wqkv`` is split over heads, so the attention (the flash kernels
  included) runs on this process's heads; ``w1``/``b1`` over the MLP's
  columns; ``wo`` and ``w2`` are row-parallel and their partial outputs are
  summed over the tp group;
- the tied ``wte`` is split over the vocabulary on tp: the lookup takes
  this process's rows and sums over tp, and the fused cross-entropy takes
  its max, its sum of exponentials and the target's logit across tp in
  fp32, chunk by chunk, recomputed with its collectives in backward;
- sp: each process holds a contiguous block of the sequence (its inputs are
  ``sharding.data_sharding_for``'s block), its positions are global (``wpe``
  rows from ``coord["sp"] * T_local``), ``attention_impl="ring"`` attends
  across the blocks (``ops/ring_attention.py``), and :func:`token_loss_mean`
  sums the token losses and their count over sp, so every process holds the
  global mean. The JAX model leaves any attention to XLA, which gathers the
  sequence for dense or flash; the port does not gather it, and raises for
  an sp above 1 without ring (:func:`seq_offset`).

A dim the mesh axis does not divide stays whole (the JAX cleaning), and so
does the layer's computation on every process of that axis.
"""

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.platform import not_ported, resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import ring_attention_sharded
from ..parallel import collectives
from ..parallel.mesh import get_current_mesh
from ..parallel.sharding import shard_layout

# each parameter's logical axes, as the JAX model's param_with_axes names them
_TOP_AXES = {
    "wte": ("vocab", "embed"),
    "wpe": (None, "embed"),
    "ln_f.scale": ("norm",),
    "ln_f.bias": ("norm",),
    "lm_head": ("embed", "vocab"),
}
_BLOCK_AXES = {
    "ln_1.scale": ("norm",),
    "ln_1.bias": ("norm",),
    "attn.wqkv": ("embed", None, "heads", "kv"),
    "attn.wo": ("heads", "kv", "embed"),
    "ln_2.scale": ("norm",),
    "ln_2.bias": ("norm",),
    "mlp.w1": ("embed", "mlp"),
    "mlp.b1": ("mlp",),
    "mlp.w2": ("mlp", "embed"),
    "mlp.b2": ("embed",),
}


def logical_axes(name: str):
    """The logical axes of the parameter ``name`` of :class:`GPT`."""
    if name in _TOP_AXES:
        return _TOP_AXES[name]
    return _BLOCK_AXES[name.split(".", 2)[2]]


def _placed_mesh(p):
    """The current mesh when ``p`` was placed on one (``shard_model`` gave
    it a layout, whole or a block), else None."""
    return None if shard_layout(p) is None else get_current_mesh()


def _mesh_of(p):
    """The current mesh when ``p`` is a block of a larger leaf, else None."""
    layout = shard_layout(p)
    if layout is None or layout.is_whole:
        return None
    mesh = get_current_mesh()
    if mesh is None:
        raise ValueError("a sharded GPT runs with parallel.mesh.current_mesh active")
    return mesh


def _gathered(params, dtype, like=None):
    """Each of ``params`` cast to ``dtype``, its fsdp blocks gathered; the
    blocks are those of the parameters ``like`` (``params`` by default)."""
    out = []
    for p, q in zip(params, like or params):
        mesh = _mesh_of(q)
        dim = None if mesh is None else shard_layout(q).dim_of("fsdp")
        out.append(collectives.gather_param(p, dtype, dim, mesh and mesh.group_of("fsdp")))
    return out


def _axis_group(p, dim: int, axis: str, mesh):
    """The group of mesh ``axis`` when ``p``'s ``dim`` is split over it, else
    None."""
    if mesh is None or shard_layout(p).dim_of(axis) != dim:
        return None
    return mesh.group_of(axis)


def _tp_group(p, dim: int, mesh):
    """The tp group when ``p``'s ``dim`` is split over tp, else None."""
    return _axis_group(p, dim, "tp", mesh)


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    head_dim: int = 64
    embed_dim: int = 768
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_remat: bool = True
    remat_policy: str = "nothing"
    # >0: with targets, compute per-token CE in seq chunks of this size so
    # the [B, T, V] logits never exist whole (0 = one whole-sequence chunk)
    ce_chunk: int = 0
    use_flash_attention: bool = False
    attention_impl: str = ""  # "dense" | "flash" | "ring" (sp-sharded exact attention)
    tie_embeddings: bool = True
    # int8 decode KV cache: values stored int8 with a per-token per-kv-head
    # scale (amax/127); decode attention runs on the int8 operands
    # (_masked_attention_int8). The training forward is untouched.
    kv_cache_int8: bool = False

    def resolved_attention_impl(self) -> str:
        if self.attention_impl:
            return self.attention_impl
        return "flash" if self.use_flash_attention else "dense"

    @property
    def mlp_dim(self) -> int:
        return self.mlp_ratio * self.embed_dim

    @staticmethod
    def tiny() -> "GPTConfig":
        return GPTConfig(
            vocab_size=256,
            max_seq_len=128,
            num_layers=2,
            num_heads=4,
            head_dim=8,
            embed_dim=32,
            use_remat=False,
        )

    @staticmethod
    def gpt2_small() -> "GPTConfig":
        return GPTConfig(num_layers=12, num_heads=12, head_dim=64, embed_dim=768)

    @staticmethod
    def gpt2_xl() -> "GPTConfig":
        return GPTConfig(num_layers=48, num_heads=25, head_dim=64, embed_dim=1600)


def _param(shape, cfg, device):
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device))


class LayerNorm(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.scale = _param((cfg.embed_dim,), cfg, device)
        self.bias = _param((cfg.embed_dim,), cfg, device)

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + 1e-5)
        return (y * self.scale + self.bias).to(self.cfg.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, H, Hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
        self.wqkv = _param((D, 3, H, Hd), cfg, device)
        self.wo = _param((H, Hd, D), cfg, device)

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.wqkv, 0.0, 0.02, generator=generator)
        std = 0.02 / math.sqrt(2 * self.cfg.num_layers)
        nn.init.normal_(self.wo, 0.0, std, generator=generator)

    def forward(self, x):
        cfg = self.cfg
        tp = _tp_group(self.wqkv, 2, _mesh_of(self.wqkv))  # heads split over tp
        wqkv, wo = _gathered((self.wqkv, self.wo), cfg.dtype)
        x = collectives.copy_to_group(x, tp)
        qkv = torch.einsum("btd,dchk->cbthk", x, wqkv)
        q, k, v = qkv.unbind(0)
        impl = cfg.resolved_attention_impl()
        if impl == "flash":
            out = flash_attention(q, k, v, causal=True)
        elif impl == "dense":
            out = dense_attention(q, k, v, cfg.dtype)
        elif impl == "ring":
            out = ring_attention_sharded(q, k, v, _ring_mesh(), causal=True)
        else:
            raise ValueError(
                f"unknown attention_impl {impl!r}; expected dense|flash|ring"
            )
        y = torch.einsum("bqhk,hkd->bqd", out, wo)
        return collectives.reduce_from_group(y, tp)

    def decode(self, x, layer, mask, slots, offset):
        """This call's K/V written into ``layer`` (its entry of the cache),
        then attention over the whole cache (:func:`cached_decode_attention`)."""
        dt = self.cfg.dtype
        qkv = torch.einsum("btd,dchk->cbthk", x, self.wqkv.to(dt))
        q, k, v = qkv.unbind(0)
        return cached_decode_attention(layer, q, k, v, mask, self.wo.to(dt), self.cfg, slots,
                                       offset)


def _ring_mesh():
    mesh = get_current_mesh()
    if mesh is None:
        raise ValueError("attention_impl='ring' needs parallel.mesh.current_mesh active around "
                         "model application")
    return mesh


def seq_offset(impl: str, t_local: int) -> int:
    """The global position of this process's first token: ``coord["sp"] *
    t_local`` on a current mesh with sp above 1, else 0. Only ring attention
    attends across the sequence's blocks, so another ``impl`` raises there."""
    mesh = get_current_mesh()
    if mesh is None or mesh.shape["sp"] == 1:
        return 0
    if impl != "ring":
        raise ValueError(f"attention_impl={impl!r} on a mesh with sp={mesh.shape['sp']}: the "
                         "sequence is split over sp, and only attention_impl='ring' attends "
                         "across its blocks")
    return mesh.coord["sp"] * t_local


@functools.lru_cache(maxsize=None)
def attention_scale(head_dim: int, dtype: torch.dtype) -> float:
    """1/sqrt(head_dim) rounded as the JAX models round it: sqrt in fp32,
    then the reciprocal in the compute dtype."""
    return torch.tensor(float(head_dim)).sqrt().to(dtype).reciprocal().item()


def dense_attention(q, k, v, dtype):
    """Causal softmax attention over ``[B, T, H, Hd]`` as the JAX models
    write their dense branch: logits in ``dtype``, masked with -1e9, the
    softmax in fp32 and its probabilities cast back to ``dtype``."""
    T, Hd = q.shape[1], q.shape[-1]
    logits = torch.einsum("bqhk,bshk->bhqs", q, k) * attention_scale(Hd, dtype)
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask[None, None], logits, -1e9)
    probs = torch.softmax(logits.float(), dim=-1).to(dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


class Mlp(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D, Fd = cfg.embed_dim, cfg.mlp_dim
        self.w1 = _param((D, Fd), cfg, device)
        self.b1 = _param((Fd,), cfg, device)
        self.w2 = _param((Fd, D), cfg, device)
        self.b2 = _param((D,), cfg, device)

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.w1, 0.0, 0.02, generator=generator)
        nn.init.zeros_(self.b1)
        std = 0.02 / math.sqrt(2 * self.cfg.num_layers)
        nn.init.normal_(self.w2, 0.0, std, generator=generator)
        nn.init.zeros_(self.b2)

    def forward(self, x):
        dt = self.cfg.dtype
        tp = _tp_group(self.w1, 1, _mesh_of(self.w1))  # the hidden columns split over tp
        w1, b1, w2, b2 = _gathered((self.w1, self.b1, self.w2, self.b2), dt)
        x = collectives.copy_to_group(x, tp)
        h = x @ w1 + b1
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        return collectives.reduce_from_group(h @ w2, tp) + b2


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg, device)
        self.attn = CausalSelfAttention(cfg, device)
        self.ln_2 = LayerNorm(cfg, device)
        self.mlp = Mlp(cfg, device)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))

    def decode(self, x, layer, mask, slots, offset):
        x = x + self.attn.decode(self.ln_1(x), layer, mask, slots, offset)
        return x + self.mlp(self.ln_2(x))


class GPT(nn.Module):
    """Decoder-only LM. ``forward(tokens [B, T]) -> logits [B, T, V]``.

    With ``targets`` the return value is per-token losses ``[B, T]`` (fp32,
    0.0 at ``ignore_index`` positions); pair it with
    :func:`token_loss_mean`. ``config.ce_chunk`` > 0 fuses head and CE
    chunk by chunk so the full logits tensor never exists.

    Parameters are allocated on ``device`` (resolved by
    :func:`~dlrover_tpu_torch.common.platform.resolve_device`) and
    initialised from ``seed`` as the JAX model's initialisers do (normal
    0.02, residual projections 0.02/sqrt(2L), wpe 0.01); the numbers differ
    from JAX's, whose generator is another.
    """

    def __init__(self, config: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        if config.use_remat and config.remat_policy != "nothing":
            if config.remat_policy == "dots":
                raise NotImplementedError("remat_policy='dots' is not ported yet")
            raise ValueError(
                f"unknown remat_policy {config.remat_policy!r}; "
                "expected one of ['dots', 'nothing']"
            )
        device = resolve_device(device)
        self.config = config
        cfg = config
        self.wte = _param((cfg.vocab_size, cfg.embed_dim), cfg, device)
        self.wpe = _param((cfg.max_seq_len, cfg.embed_dim), cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.embed_dim, cfg.vocab_size), cfg, device)
        self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    logical_axes = staticmethod(logical_axes)

    def reset_parameters(self, seed: int = 0) -> None:
        g = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            nn.init.normal_(self.wte, 0.0, 0.02, generator=g)
            nn.init.normal_(self.wpe, 0.0, 0.01, generator=g)
            for module in self.modules():
                if module is not self and hasattr(module, "reset_parameters"):
                    module.reset_parameters(g)
            if not self.config.tie_embeddings:
                nn.init.normal_(self.lm_head, 0.0, 0.02, generator=g)

    def forward(self, tokens, *, targets=None, decode: bool = False, positions=None,
                kv_valid=None, cache_slots=None, cache=None):
        if decode:
            return self._decode(tokens, positions, kv_valid, cache_slots, cache)
        cfg = self.config
        T = tokens.shape[1]
        # wte gathered once for the lookup and the head
        wte, wpe = _gathered((self.wte, self.wpe), cfg.dtype)
        vocab = _vocab_split(self.wte, 0, _mesh_of(self.wte))
        start = seq_offset(cfg.resolved_attention_impl(), T)  # global positions under sp
        x = _embed(wte, tokens, vocab) + wpe[None, start:start + T]
        remat = cfg.use_remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        x = self.ln_f(x)
        if cfg.tie_embeddings:
            w_head, vocab_first = wte, True  # [V, D]
        else:
            (w_head,), vocab_first = _gathered((self.lm_head,), cfg.dtype), False  # [D, V]
            vocab = _vocab_split(self.lm_head, 1, _mesh_of(self.lm_head))
        if vocab is not None:
            x = collectives.copy_to_group(x, vocab[0])
        if targets is not None:
            return _chunked_token_ce(x, w_head, targets, cfg.ce_chunk or T, vocab_first,
                                     vocab=vocab)
        logits = _head(x, w_head, vocab_first)
        return logits if vocab is None else collectives.gather_from_group(logits, vocab[0], -1)


    def _decode(self, tokens, positions, kv_valid, cache_slots, cache):
        """Decode mode: ``(logits [B, T, V], cache)``; see the module's
        docstring and :func:`decode_mask`."""
        cfg = self.config
        if positions is None:
            raise ValueError("decode=True needs absolute positions")
        if cache is None:
            raise ValueError("decode=True needs a cache (generation.init_cache)")
        whole_params_only(self)
        mask, slots, offset = decode_mask(cache, tokens.shape, kv_valid, cache_slots)
        dt = cfg.dtype
        wte = self.wte.to(dt)
        x = wte[tokens] + self.wpe.to(dt)[positions]
        for block, layer in zip(self.blocks, cache["layers"]):
            x = block.decode(x, layer, mask, slots, offset)
        advance_cache(cache, tokens.shape[1], slots)
        x = self.ln_f(x)
        if cfg.tie_embeddings:
            return _head(x, wte, True), cache
        return _head(x, self.lm_head.to(dt), False), cache


def _vocab_split(p, dim: int, mesh):
    """(tp group, first vocabulary row of this process) when ``p``'s
    vocabulary ``dim`` is split over tp, else None."""
    group = _tp_group(p, dim, mesh)
    return None if group is None else (group, shard_layout(p).index[dim][0])


def _embed(w, tokens, vocab):
    """Rows ``tokens`` of the embedding ``w``; with ``vocab`` (the tp group
    and this process's first row, :func:`_vocab_split`), this process's
    rows, summed over tp."""
    if vocab is None:
        return w[tokens]
    local = tokens - vocab[1]
    inside = (local >= 0) & (local < w.shape[0])
    emb = w[torch.where(inside, local, 0)] * inside[..., None].to(w.dtype)
    return collectives.reduce_from_group(emb, vocab[0])


def _head(x, w_head, vocab_first: bool):
    if vocab_first:
        return torch.einsum("btd,vd->btv", x, w_head)
    return x @ w_head


def _token_ce(logits, targets, ignore_index: int = -1):
    """Masked per-token CE in fp32: ``[..., V]`` logits -> ``[...]`` losses
    (0.0 at ignored positions)."""
    logits = logits.float()
    mask = targets != ignore_index
    safe_targets = torch.where(mask, targets, 0)
    logps = torch.log_softmax(logits, dim=-1)
    token_loss = -torch.gather(logps, -1, safe_targets[..., None])[..., 0]
    return torch.where(mask, token_loss, 0.0)


def cross_entropy_loss(logits, targets, ignore_index: int = -1):
    """Mean next-token CE in fp32."""
    return token_loss_mean(
        _token_ce(logits, targets, ignore_index), targets, ignore_index
    )


def _chunk_ce(xb, w_head, tb, vocab_first: bool, ignore_index: int, vocab=None):
    if vocab is None:
        return _token_ce(_head(xb, w_head, vocab_first), tb, ignore_index)
    return _split_vocab_ce(_head(xb, w_head, vocab_first), tb, ignore_index, *vocab)


def _split_vocab_ce(logits, targets, ignore_index: int, group, first: int):
    """``_token_ce`` of logits whose vocabulary is split over ``group``
    (this process holds columns ``first:first + V_local``): the max, the
    sum of exponentials and the target's logit are taken across the group
    in fp32."""
    logits = logits.float()
    m = collectives.all_reduce(logits.detach().amax(-1), group, op=dist.ReduceOp.MAX)
    sumexp = collectives.reduce_from_group(torch.exp(logits - m[..., None]).sum(-1), group)
    mask = targets != ignore_index
    local = targets - first
    inside = mask & (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    target_logit = collectives.reduce_from_group(torch.where(inside, picked, 0.0), group)
    return torch.where(mask, torch.log(sumexp) + m - target_logit, 0.0)


def _chunked_token_ce(
    x, w_head, targets, chunk: int, vocab_first: bool, ignore_index: int = -1, vocab=None
):
    """Per-token CE fused with the LM head, in sequence chunks:
    ``[B, T, D] -> [B, T]``. Each chunk's logits are recomputed in backward
    (``torch.utils.checkpoint``), so live logits are ``[B, chunk, V]``
    (``[B, chunk, V/tp]`` with ``vocab``, the tp group and this process's
    first vocabulary row)."""
    B, T, D = x.shape
    if T % chunk:
        raise ValueError(f"seq len {T} not divisible by ce_chunk {chunk}")
    losses = []
    for start in range(0, T, chunk):
        args = (x[:, start:start + chunk], w_head, targets[:, start:start + chunk],
                vocab_first, ignore_index, vocab)
        if torch.is_grad_enabled():
            losses.append(checkpoint(_chunk_ce, *args, use_reentrant=False))
        else:
            losses.append(_chunk_ce(*args))
    return torch.cat(losses, dim=1)


def token_loss_mean(token_losses, targets, ignore_index: int = -1):
    """Loss head for the fused-CE path: mean of per-token losses over the
    non-ignored positions (the model already zeroed the others). On a
    current mesh with sp above 1 the sum and the count are summed over sp
    first (``collectives.sum_over_group``, which sums the gradient too), so
    every process of an sp line holds the mean over the whole sequence, as
    the JAX loss of the global array is."""
    if token_losses.dim() != targets.dim():
        raise ValueError(
            f"token_loss_mean expects per-token losses shaped like targets "
            f"{tuple(targets.shape)}, got {tuple(token_losses.shape)}: a "
            f"[B,T,V] rank means the model ran with ce_chunk=0 (raw logits); "
            f"pair that with cross_entropy_loss instead"
        )
    mask = targets != ignore_index
    mesh = get_current_mesh()
    sp = None if mesh is None else mesh.group_of("sp")
    if sp is None:
        return token_losses.sum() / mask.sum().clamp(min=1)
    sums = torch.stack((token_losses.sum(), mask.sum().to(token_losses.dtype)))
    total, count = collectives.sum_over_group(sums, sp, part="sp_loss").unbind()
    return total / count.clamp(min=1)


# -- decode: the KV cache ------------------------------------------------------

# fp32 holds every integer up to 2**24 exactly: a contraction of int8 values
# (|x| <= 127) is exact in fp32 while n * 127**2 stays below it
_FP32_EXACT = 2 ** 24


def exact_int8_dtype(n: int) -> torch.dtype:
    """The float dtype in which a contraction of length ``n`` over int8
    values is exact: fp32 while every partial sum is an integer below 2**24
    (``n * 127**2 < 2**24``, n <= 1040: Hd=64 for QK, up to 1040 cache slots
    for PV), fp64 beyond (exact to 2**53). JAX contracts the int8 operands
    in int32; torch has no int8 x int8 -> int32 einsum on CUDA, and
    ``torch._int_mm`` needs more than 16 rows, which a decode step lacks."""
    return torch.float32 if n * 127 * 127 < _FP32_EXACT else torch.float64


def _quant_kv(x):
    """Per-token per-kv-head symmetric int8: ``[..., Hd]`` -> (int8 values,
    fp32 scales ``[...]``)."""
    xf = x.float()
    scale = (xf.abs().amax(-1) / 127.0).clamp(min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequant_kv(q, scale, dtype):
    """Inverse of :func:`_quant_kv`, a round-trip helper only: the attention
    reads the int8 operands directly (:func:`_masked_attention_int8`)."""
    return (q.float() * scale[..., None]).to(dtype)


def empty_cache(cfg, batch_size: int, kv_heads: int, device) -> Dict:
    """A zero decode cache for ``batch_size`` rows of ``cfg.max_seq_len``
    slots and ``kv_heads`` K/V heads (the structure of the module's
    docstring)."""
    shape = (batch_size, cfg.max_seq_len, kv_heads, cfg.head_dim)
    layers = []
    for _ in range(cfg.num_layers):
        if getattr(cfg, "kv_cache_int8", False):
            layer = {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                     "v": torch.zeros(shape, dtype=torch.int8, device=device),
                     "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                     "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=device)}
        else:
            layer = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                     "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
        layers.append(layer)
    return {"index": 0, "layers": layers}


def clone_cache(cache: Dict) -> Dict:
    """A copy of ``cache`` whose tensors are its own."""
    return {"index": cache["index"],
            "layers": [{k: t.clone() for k, t in layer.items()} for layer in cache["layers"]]}


def whole_params_only(model) -> None:
    """Decode runs on whole parameters: a model placed on a mesh raises."""
    if any(shard_layout(p) is not None and not shard_layout(p).is_whole
           for p in model.parameters()):
        raise not_ported("decode on a mesh (serving a sharded model)")


def decode_mask(cache: Dict, token_shape, kv_valid, cache_slots):
    """``(mask [B, T, max_len], slots [B, T] or None, offset)`` of one
    decode call: where this call's K/V go and which cache slots each of its
    queries attends, as the JAX ``_update_decode_cache`` computes them.

    Shared-offset mode (``cache_slots`` None, the generation convention of
    left-padded prompts): every row writes at ``offset = cache["index"]``;
    ``kv_valid [B, max_len]`` marks the slots that hold real tokens (None:
    every slot below the write frontier), and the query at slot ``offset +
    i`` sees valid slots up to its own. A write past the cache's end raises
    (``dynamic_update_slice`` clamps it in JAX, which would overwrite valid
    slots). ``cache_slots`` switches to per-row write slots, ``[B]`` for a
    one-token step or ``[B, T]`` for a window, and needs ``kv_valid``."""
    B, T = token_shape
    L = cache["layers"][0]["k"].shape[1]
    device = cache["layers"][0]["k"].device
    ar = torch.arange(L, device=device)
    if cache_slots is not None:
        if kv_valid is None:
            raise ValueError("cache_slots mode needs explicit kv_valid")
        slots = cache_slots[:, None] if cache_slots.dim() == 1 else cache_slots
        if tuple(slots.shape) != (B, T):
            raise ValueError(f"cache_slots {tuple(cache_slots.shape)} incompatible with "
                             f"tokens [B={B}, T={T}]")
        causal = ar[None, None, :] <= slots[:, :, None]  # [B, T, L]
        return kv_valid[:, None, :] & causal, slots, None
    offset = int(cache["index"])
    if offset + T > L:
        raise ValueError(f"decode write at slots [{offset}, {offset + T}) past the cache's "
                         f"{L} slots")
    if kv_valid is None:
        kv_valid = (ar < offset + T)[None, :].expand(B, L)
    slot_q = torch.arange(offset, offset + T, device=device)
    causal = ar[None, :] <= slot_q[:, None]  # [T, L]
    return kv_valid[:, None, :] & causal[None, :, :], None, offset


def advance_cache(cache: Dict, T: int, slots) -> None:
    """After a shared-offset call, the write frontier moves past its
    ``T`` tokens; per-row writes leave it where it is, as in JAX."""
    if slots is None:
        cache["index"] = int(cache["index"]) + T


def _update_decode_cache(layer: Dict, k, v, slots, offset: Optional[int]):
    """Write this call's K/V (``[B, T, KVH, Hd]``) into ``layer``, in place,
    at ``offset`` (shared) or at ``slots`` (``[B, T]``, per row), quantized
    first for an int8 cache. Returns the cache as the attention reads it:
    ``(k, v)``, or for int8 the raw operands ``(k8, k_scale, v8, v_scale)``:
    never a dequantized copy."""
    int8 = layer["k"].dtype == torch.int8
    if int8:
        (k, k_scale), (v, v_scale) = _quant_kv(k), _quant_kv(v)
        new = {"k": k, "v": v, "k_scale": k_scale, "v_scale": v_scale}
    else:
        new = {"k": k, "v": v}
    if slots is not None:
        rows = torch.arange(k.shape[0], device=k.device)[:, None].expand_as(slots)
        for name, value in new.items():
            layer[name].index_put_((rows, slots), value.to(layer[name].dtype))
    else:
        for name, value in new.items():
            layer[name][:, offset:offset + k.shape[1]] = value
    if int8:
        return layer["k"], layer["k_scale"], layer["v"], layer["v_scale"]
    return layer["k"], layer["v"]


def cached_decode_attention(layer: Dict, q, k, v, mask, wo, cfg, slots, offset):
    """Write this call's K/V into the layer's cache, then attend in the
    cache's storage precision: the plain masked attention over a bf16 (or
    fp32) cache, the int8 x int8 route over an int8 one. The one decode
    attention of GPT and Llama."""
    res = _update_decode_cache(layer, k, v, slots, offset)
    if len(res) == 2:
        return _masked_attention(q, res[0], res[1], mask, wo, cfg)
    return _masked_attention_int8(q, *res, mask, wo, cfg)


def _fp32_sqrt(n: int) -> float:
    """sqrt(n) rounded to fp32 (``jnp.sqrt(jnp.float32(n))``), as a host
    scalar: a device tensor made from it would copy to the card and wait
    for its queue at every call."""
    return float(np.float32(math.sqrt(n)))


def _masked_attention_int8(q, k8, ks, v8, vs, mask, wo, cfg):
    """Decode attention computed on the int8 cache, as the JAX model does:
    the query is quantized too, and the scales are factored out of the
    contractions.

    - QK: the per-(token, head) q scales and per-(token, kv-head) k scales
      are constant along the contracted Hd, so logits = (q8 . k8) * qs * ks.
    - PV: the v scale varies along the contracted slot axis, so it is
      folded into the probabilities, which are re-quantized per row, and the
      product is int8 x int8 again.

    Both contractions run in a float dtype in which they are exact
    (:func:`exact_int8_dtype`: fp32 up to 1040 along the contraction, the
    Hd of QK and the cache's slots of PV, fp64 beyond), so they equal JAX's
    int32 dots bit for bit; nothing is rounded quietly."""
    B, T, H, Hd = q.shape
    KVH, S = k8.shape[2], k8.shape[1]
    G = H // KVH
    q8, qs = _quant_kv(q.reshape(B, T, KVH, G, Hd))  # scales [B, T, KVH, G]
    acc = exact_int8_dtype(Hd)
    logits = torch.einsum("btgck,bsgk->bgcts", q8.to(acc), k8.to(acc)).float()
    logits = logits * qs.permute(0, 2, 3, 1)[..., None]
    logits = logits * ks.permute(0, 2, 1)[:, :, None, None, :]
    logits = logits / _fp32_sqrt(Hd)
    logits = torch.where(mask[:, None, None, :, :], logits, -1e9)
    probs = torch.softmax(logits, dim=-1)
    w = probs * vs.permute(0, 2, 1)[:, :, None, None, :]
    wscale = (w.abs().amax(-1) / 127.0).clamp(min=1e-12)
    w8 = torch.clamp(torch.round(w / wscale[..., None]), -127, 127)
    acc = exact_int8_dtype(S)
    out = torch.einsum("bgcts,bsgk->btgck", w8.to(acc), v8.to(acc)).float()
    out = out * wscale.permute(0, 3, 1, 2)[..., None]
    out = out.reshape(B, T, H, Hd).to(cfg.dtype)
    return torch.einsum("bqhk,hkd->bqd", out, wo)


def _masked_attention(q, k, v, mask, wo, cfg):
    """Dense attention over the whole decode cache with an explicit mask
    ``[B, T, S]``: logits in the compute dtype, masked with -1e9, the
    softmax in fp32. A GQA-narrow cache (fewer K/V heads than query heads)
    takes the grouped contraction: the cache is never widened."""
    Hd = q.shape[-1]
    H, KVH = q.shape[2], k.shape[2]
    scale = attention_scale(Hd, q.dtype)
    if H != KVH:
        B, T = q.shape[:2]
        qg = q.reshape(B, T, KVH, H // KVH, Hd)
        logits = torch.einsum("btgck,bsgk->bgcts", qg, k) * scale
        logits = torch.where(mask[:, None, None, :, :], logits, -1e9)
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bgcts,bsgk->btgck", probs, v).reshape(B, T, H, Hd)
    else:
        logits = torch.einsum("bqhk,bshk->bhqs", q, k) * scale
        logits = torch.where(mask[:, None, :, :], logits, -1e9)
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqs,bshk->bqhk", probs, v)
    return torch.einsum("bqhk,hkd->bqd", out, wo)
