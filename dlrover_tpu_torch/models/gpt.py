"""GPT decoder-only transformer, training half: the port of
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
``remat_policy="nothing"``). Not ported yet: decode mode (the KV cache and
its int8 variant), ring attention, and the ``"dots"`` remat policy.
"""

import math
from dataclasses import dataclass
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..common.platform import resolve_device
from ..ops.flash_attention import flash_attention


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
    attention_impl: str = ""  # "dense" | "flash"; "ring" is not ported yet
    tie_embeddings: bool = True

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
        qkv = torch.einsum("btd,dchk->cbthk", x, self.wqkv.to(cfg.dtype))
        q, k, v = qkv.unbind(0)
        impl = cfg.resolved_attention_impl()
        if impl == "flash":
            out = flash_attention(q, k, v, causal=True)
        elif impl == "dense":
            out = dense_attention(q, k, v, cfg.dtype)
        elif impl == "ring":
            raise NotImplementedError("attention_impl='ring' is not ported yet")
        else:
            raise ValueError(
                f"unknown attention_impl {impl!r}; expected dense|flash|ring"
            )
        return torch.einsum("bqhk,hkd->bqd", out, self.wo.to(cfg.dtype))


def dense_attention(q, k, v, dtype):
    """Causal softmax attention over ``[B, T, H, Hd]`` as the JAX models
    write their dense branch: logits in ``dtype``, masked with -1e9, the
    softmax in fp32 and its probabilities cast back to ``dtype``."""
    T, Hd = q.shape[1], q.shape[-1]
    # 1/sqrt(Hd) rounded as the JAX models round it: sqrt in fp32, then the
    # reciprocal in the compute dtype
    scale = torch.tensor(float(Hd)).sqrt().to(dtype).reciprocal()
    logits = torch.einsum("bqhk,bshk->bhqs", q, k) * scale.item()
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
        h = x @ self.w1.to(dt) + self.b1.to(dt)
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        return h @ self.w2.to(dt) + self.b2.to(dt)


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

    def forward(self, tokens, *, targets=None, decode: bool = False):
        if decode:
            raise NotImplementedError("decode mode is not ported yet")
        cfg = self.config
        T = tokens.shape[1]
        x = self.wte.to(cfg.dtype)[tokens] + self.wpe.to(cfg.dtype)[None, :T]
        remat = cfg.use_remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        x = self.ln_f(x)
        if cfg.tie_embeddings:
            w_head, vocab_first = self.wte.to(cfg.dtype), True  # [V, D]
        else:
            w_head, vocab_first = self.lm_head.to(cfg.dtype), False  # [D, V]
        if targets is not None:
            return _chunked_token_ce(x, w_head, targets, cfg.ce_chunk or T, vocab_first)
        return _head(x, w_head, vocab_first)


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


def _chunk_ce(xb, w_head, tb, vocab_first: bool, ignore_index: int):
    return _token_ce(_head(xb, w_head, vocab_first), tb, ignore_index)


def _chunked_token_ce(
    x, w_head, targets, chunk: int, vocab_first: bool, ignore_index: int = -1
):
    """Per-token CE fused with the LM head, in sequence chunks:
    ``[B, T, D] -> [B, T]``. Each chunk's logits are recomputed in backward
    (``torch.utils.checkpoint``), so live logits are ``[B, chunk, V]``."""
    B, T, D = x.shape
    if T % chunk:
        raise ValueError(f"seq len {T} not divisible by ce_chunk {chunk}")
    losses = []
    for start in range(0, T, chunk):
        args = (x[:, start:start + chunk], w_head, targets[:, start:start + chunk],
                vocab_first, ignore_index)
        if torch.is_grad_enabled():
            losses.append(checkpoint(_chunk_ce, *args, use_reentrant=False))
        else:
            losses.append(_chunk_ce(*args))
    return torch.cat(losses, dim=1)


def token_loss_mean(token_losses, targets, ignore_index: int = -1):
    """Loss head for the fused-CE path: mean of per-token losses over the
    non-ignored positions (the model already zeroed the others)."""
    if token_losses.dim() != targets.dim():
        raise ValueError(
            f"token_loss_mean expects per-token losses shaped like targets "
            f"{tuple(targets.shape)}, got {tuple(token_losses.shape)}: a "
            f"[B,T,V] rank means the model ran with ce_chunk=0 (raw logits); "
            f"pair that with cross_entropy_loss instead"
        )
    mask = targets != ignore_index
    return token_losses.sum() / mask.sum().clamp(min=1)
