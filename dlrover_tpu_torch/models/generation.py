"""Autoregressive generation over the training parameters: the port of
``dlrover_tpu/models/generation.py``.

The same design as the JAX module, in eager PyTorch:

- **Left-padded prompts.** Every batch row ends at the same cache slot, so
  the prefill and every decode step write the KV cache at one shared offset
  (a slice copy, never a per-row scatter). Per-row absolute positions (for
  RoPE and the learned position embeddings) and a per-slot validity mask
  carry the variable prompt lengths.
- **Prefill** runs the whole prompt through the model once in decode mode,
  filling cache slots ``[0, T0)``.
- **Decode** is a Python loop over one-token steps (the JAX ``lax.scan``):
  sample, write slot ``T0 + t``, advance. Rows that hit EOS keep stepping on
  a pad token and are masked out of the result. No step reads the device
  back, so the host queues the steps ahead of the card.
- **Sampling**: temperature, top-k and top-p composed in fp32, then a
  categorical draw from an explicit ``torch.Generator`` (the JAX key).
  Chosen-token logprobs, under the raw unfiltered distribution, are
  returned for RL objectives.

The cache is the explicit structure of :mod:`.gpt` (``empty_cache``),
updated in place: a call that takes a cache returns the same object.
``params`` is None for the model's own parameters, or a mapping of its
parameter names to tensors, applied through ``torch.func.functional_call``.
Everything runs under ``torch.no_grad``.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..common.platform import not_ported
from .gpt import empty_cache

__all__ = [
    "SamplingConfig",
    "build_generate_fn",
    "decode_apply",
    "filter_logits",
    "generate",
    "init_cache",
    "left_pad_prompts",
    "prefill_prompt",
    "sample_logits",
    "sample_step",
]


@dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: int = 0  # 0 = off
    top_p: float = 1.0  # 1.0 = off
    eos_id: int = -1  # -1 = never stop early
    pad_id: int = 0


def to_device(t, device):
    """``t`` on ``device``. A CPU tensor bound for the GPU is pinned and
    copied without blocking: PyTorch's blocking copy from pageable memory
    synchronises the stream, so it would wait for every queued kernel (a
    decode chunk in flight)."""
    if device is None or torch.device(device).type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def left_pad_prompts(prompts: list, pad_id: int = 0, width: int = 0, device=None):
    """Pack variable-length token lists into LEFT-padded ``[B, T0]``
    tensors (int64 tokens, bool mask, True on real tokens), on ``device``
    (the CPU by default; the decode calls move them to the model's)."""
    width = max(width, max(len(p) for p in prompts))
    tokens = np.full((len(prompts), width), pad_id, dtype=np.int64)
    mask = np.zeros((len(prompts), width), dtype=bool)
    for i, p in enumerate(prompts):
        if len(p):
            tokens[i, width - len(p):] = np.asarray(p, dtype=np.int64)
            mask[i, width - len(p):] = True
    return to_device(torch.from_numpy(tokens), device), to_device(torch.from_numpy(mask), device)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def init_cache(model, batch_size: int):
    """A zero decode cache for ``model`` at ``batch_size`` rows on its
    device: ``max_seq_len`` slots a layer, KVH-wide for GQA models, int8 with
    fp32 scales under ``kv_cache_int8``."""
    cfg = model.config
    return empty_cache(cfg, batch_size, getattr(cfg, "num_kv_heads", cfg.num_heads),
                       _device_of(model))


def filter_logits(logits, top_k: int = 0, top_p: float = 1.0):
    """Mask ``[..., V]`` fp32 logits to the top-k/top-p support (-inf out).

    top-k keeps the k largest; top-p keeps the smallest prefix of the
    sorted distribution whose mass reaches p (always at least the argmax).
    k first, then p."""
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p < 1.0:
        sort_idx = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, sort_idx)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose cumulative mass BEFORE them is < top_p
        keep_sorted = (cum - probs) < top_p
        inv = torch.argsort(sort_idx, dim=-1)
        keep = torch.gather(keep_sorted, -1, inv)
        logits = torch.where(keep, logits, float("-inf"))
    return logits


def sample_logits(logits, generator=None, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0):
    """Token ids from ``[B, V]`` logits: argmax at temperature 0 (the first
    of equal maxima, as ``jnp.argmax``), else a draw from the filtered
    distribution (:func:`filter_logits`) with ``generator``."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits / max(temperature, 1e-6), top_k, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def decode_apply(model, params, cache, tokens, positions, kv_valid, cache_slots=None):
    """One decode-mode model application over an explicit cache: ``(raw
    logits, cache)``. The one place the decode contract is spelled, shared
    by the one-shot engine and the continuous-batching scheduler (their
    token-exactness depends on applying the model identically).
    ``cache_slots`` selects per-row write slots, ``[B]`` or ``[B, T]``
    (``gpt.decode_mask``)."""
    kwargs = dict(decode=True, positions=positions, kv_valid=kv_valid, cache_slots=cache_slots,
                  cache=cache)
    with torch.no_grad():
        if params is None:
            return model(tokens, **kwargs)
        return torch.func.functional_call(model, dict(params), (tokens,), kwargs)


def sample_step(last_logits, done, generator, s: SamplingConfig):
    """One sampling decision: ``(token, emit mask, logprob, done')``.

    ``done`` rows emit pad and are masked; an EOS sample is emitted (the EOS
    token is kept) and marks the row done afterwards. Logprobs are of the
    logits as given: raw model logits in the one-shot engine, per-row masked
    logits in the continuous engine's constrained decoding."""
    tok = sample_logits(last_logits, generator, s.temperature, s.top_k, s.top_p)
    logp = torch.log_softmax(last_logits, dim=-1)
    tok_logp = torch.gather(logp, -1, tok[:, None])[:, 0]
    tok = torch.where(done, s.pad_id, tok)
    emit_mask = ~done
    if s.eos_id >= 0:
        done = done | (tok == s.eos_id)
    return tok, emit_mask, tok_logp, done


def prefill_prompt(model, params, tokens, mask):
    """Run a LEFT-padded ``[B, W]`` prompt through the model in decode mode,
    filling a FRESH cache's slots ``[0, W)``. Returns ``(cache,
    last_logits [B, V] fp32, last_pos [B], kv_valid [B, L])``."""
    device = _device_of(model)
    tokens, mask = to_device(tokens, device), to_device(mask, device)
    B, W = tokens.shape
    L = model.config.max_seq_len
    cache = init_cache(model, B)
    positions = (torch.cumsum(mask.long(), dim=1) - 1).clamp(min=0)
    kv_valid = torch.zeros((B, L), dtype=torch.bool, device=device)
    kv_valid[:, :W] = mask
    logits, cache = decode_apply(model, params, cache, tokens, positions, kv_valid)
    return cache, logits[:, -1].float(), positions[:, -1], kv_valid


def build_generate_fn(model, sampling: SamplingConfig, prompt_width: int, mesh=None,
                      param_shardings=None, rules=None) -> Callable:
    """A generation function for a fixed prompt width and sampling:
    ``fn(params, prompt_tokens [B, T0], prompt_mask [B, T0], generator) ->
    (tokens [B, N], mask [B, N], logprobs [B, N])``: the completions, a
    validity mask that cuts off after the first EOS (the EOS token kept),
    and per-token logprobs under the raw model distribution. ``mesh`` (the
    JAX function's SPMD program over a mesh) is not ported."""
    if mesh is not None or param_shardings is not None or rules is not None:
        raise not_ported("build_generate_fn on a mesh")
    s = sampling
    max_len = model.config.max_seq_len
    if prompt_width + s.max_new_tokens > max_len:
        raise ValueError(f"prompt width {prompt_width} + max_new {s.max_new_tokens} "
                         f"exceeds max_seq_len {max_len}")

    def _generate(params, prompt_tokens, prompt_mask, generator=None):
        B, T0 = prompt_tokens.shape
        if T0 != prompt_width:
            raise ValueError(f"prompt_tokens width {T0} != built prompt_width {prompt_width}")
        cache, last_logits, cur_pos, kv_valid = prefill_prompt(
            model, params, prompt_tokens, prompt_mask)
        done = torch.zeros((B,), dtype=torch.bool, device=last_logits.device)
        toks, masks, logps = [], [], []
        # N tokens need N-1 incremental forwards: the prefill gave the first
        # logits, and the last sampled token is never fed back
        for t in range(s.max_new_tokens):
            tok, emit, tok_logp, done = sample_step(last_logits, done, generator, s)
            toks.append(tok)
            masks.append(emit)
            logps.append(tok_logp)
            if t == s.max_new_tokens - 1:
                break
            kv_valid[:, T0 + t] = True
            cur_pos = cur_pos + 1
            logits, cache = decode_apply(model, params, cache, tok[:, None], cur_pos[:, None],
                                         kv_valid)
            last_logits = logits[:, 0].float()
        return torch.stack(toks, 1), torch.stack(masks, 1), torch.stack(logps, 1)

    return _generate


def generate(model, params, prompt_tokens, prompt_mask, generator=None,
             sampling: Optional[SamplingConfig] = None):
    """One-shot wrapper around :func:`build_generate_fn`."""
    sampling = sampling or SamplingConfig()
    fn = build_generate_fn(model, sampling, prompt_tokens.shape[1])
    return fn(params, prompt_tokens, prompt_mask, generator)
