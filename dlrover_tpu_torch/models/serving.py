"""Continuous batching over the generation engine: the port of
``dlrover_tpu/models/serving.py``.

A request-queue scheduler that admits new prompts into freed batch slots
while other rows keep decoding, so a stream of mixed-length prompts does
not pay worst-case padding in every batch. The JAX engine's design, in
eager PyTorch on one device:

- **Slot admission.** A new request's prompt is prefilled into a fresh
  one-row cache at slots ``[0, W)`` (W the smallest width bucket that fits
  it, at most the prompt width) and the row is copied into the batch cache;
  positions count only valid slots, so RoPE and the position embeddings
  never see pad holes.
- **Decode runs in chunks** of ``decode_chunk`` steps a scheduler round:
  one round's outputs (tokens, emit mask, logprobs, done flags) come back
  to the host in one copy.
- **Two cache layouts** (``cache_layout=``):

  - ``"frontier"`` (the engine's default): every row writes at one shared
    slot a step. Admissions leave kv_valid holes up to the frontier; when
    the frontier nears the cache's end the scheduler re-prefills every live
    row's history into a fresh cache (compaction). Liveness:
    ``aligned(prompt_width + max_new_tokens) + max(max_new_tokens,
    decode_chunk) <= max_seq_len``.
  - ``"per_row"`` (``tpurun-serve``'s default): every row writes at its own
    next slot (the ``cache_slots`` mode of ``gpt.decode_mask``), so there
    is no frontier and no compaction. Liveness: ``prompt_width +
    max_new_tokens <= max_seq_len``.

- **Overlapped round** (``overlap=True``, the default): each ``step()``
  enqueues chunk N+1 on the device *before* it reads chunk N's tokens. A
  chunk's outputs are copied ``non_blocking`` into pinned host memory right
  behind its last step and an event is recorded after the copy; reading
  them waits on that event only. Per-row stop enforcement lives on the
  device (cap counters and done-masking inside the chunk), so the one-chunk
  lag between device and host bookkeeping can neither over-emit nor
  corrupt KV. Greedy streams are identical to the synchronous round
  (``overlap=False``, the A/B baseline). Host work done while a chunk is
  in flight is stamped ``overlap_hidden`` (``attribution/phases.py``).
- **Weight hot-swap between chunks**: ``set_params`` binds new tensors
  into the model's parameters, adopted only at a drained pipeline, so no
  round is split between parameter versions.
- **decode_chunk auto-tuning** (``auto_chunk=True``): the measured
  ``serving_host_frac`` grows the chunk when the host dominates and
  shrinks it when the device does.

The engine serves through ``model``'s own parameters: ``params`` given to
the constructor or to ``set_params`` (a mapping of the model's parameter
names to tensors) are bound into it.

Not ported (each raises): the ``"paged"`` layout (``models/kv_blocks.py``),
``export_prefill`` / ``submit_prefilled`` (prefill/decode disaggregation),
``SpeculativeBatchingEngine`` (``models/speculative.py``), and a ``mesh``.
The JAX engine's fault-injection points (``serving.swap``,
``serving.admit``) are left out.
"""

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..attribution.phases import PhaseAccumulator
from ..common.log import logger
from ..common.platform import not_ported
from .generation import (SamplingConfig, decode_apply, init_cache, left_pad_prompts,
                         prefill_prompt, sample_step, to_device)
from .gpt import clone_cache

__all__ = ["Completion", "ContinuousBatchingEngine", "SpeculativeBatchingEngine"]

# a chunk's outputs travel to the host as one fp32 tensor; token ids are
# exact in fp32 below 2**24
_MAX_PACKED_VOCAB = 2 ** 24


@dataclass
class Completion:
    uid: int
    tokens: List[int]
    logprobs: List[float]
    # per-request service metrics (host wall-clock)
    queue_s: float = 0.0  # submit -> slot admission
    ttft_s: float = 0.0  # admission -> first emitted token
    total_s: float = 0.0  # admission -> retirement


@dataclass
class _Slot:
    uid: int = -1  # -1 = empty
    prompt: List[int] = field(default_factory=list)
    emitted: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    finished: bool = False  # EOS seen (device done flag)
    cap: int = 0  # this request's max_new_tokens (<= engine budget)
    submit_t: float = 0.0
    admit_t: float = 0.0
    first_tok_t: float = 0.0


class _ChunkAutoTuner:
    """Retunes ``decode_chunk`` between dispatches from the measured
    ``serving_host_frac``: a high host fraction over a window of rounds
    grows the chunk (one dispatch and readback amortized over more tokens),
    a low one shrinks it (fewer tail steps on finished rows, sooner
    admission). Every candidate satisfies the engine's liveness bound."""

    WINDOW = 8  # rounds per decision
    HIGH = 0.35
    LOW = 0.10

    def __init__(self, engine):
        s = engine.s
        cands = {engine.d} | {4, 8, 16, 32}
        cands = {c for c in cands if c == engine.d or 1 <= c <= s.max_new_tokens}
        if engine.layout == "frontier":
            worst = engine._align(engine.Pw + s.max_new_tokens)
            cands = {c for c in cands
                     if c == engine.d or worst + max(s.max_new_tokens, c) <= engine.L}
        self.candidates = sorted(cands)
        self.engine = engine
        self.retunes = 0
        self._mark = self._snapshot()

    def _snapshot(self):
        split = self.engine.phases.split()
        return (split.host_s, split.total_s, split.rounds)

    def maybe_retune(self) -> Optional[int]:
        """Called once a scheduler round; the new chunk length when a
        retune happened, else None."""
        h0, t0, r0 = self._mark
        rounds = self.engine.phases.rounds
        if rounds < r0:  # the accumulator was reset
            self._mark = self._snapshot()
            return None
        if rounds - r0 < self.WINDOW:
            return None
        split = self.engine.phases.split()
        dh, dt = split.host_s - h0, split.total_s - t0
        self._mark = (split.host_s, split.total_s, split.rounds)
        if dt <= 0 or dh < 0:
            return None
        frac = dh / dt
        idx = self.candidates.index(self.engine.d)
        if frac > self.HIGH and idx + 1 < len(self.candidates):
            self.engine.d = self.candidates[idx + 1]
        elif frac < self.LOW and idx > 0:
            self.engine.d = self.candidates[idx - 1]
        else:
            return None
        self.retunes += 1
        return self.engine.d


@dataclass
class _Inflight:
    """A dispatched chunk: its packed outputs on their way to ``host``
    (``[3d + 1, B]`` fp32: tokens, emit mask, logprobs, done flags), the
    event recorded after the copy (None on the CPU), and the per-slot uids
    at dispatch (emission credits only a slot whose uid still matches)."""
    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    uids: List[int]
    d: int


def _bind_params(model, params) -> None:
    """Point ``model``'s parameters at the tensors of ``params`` (a mapping
    of its parameter names), cast to each parameter's dtype and device.
    Every name and shape is checked before the first is bound."""
    named = dict(model.named_parameters())
    for name, p in named.items():
        if name not in params:
            raise KeyError(f"params missing {name}")
        if tuple(params[name].shape) != tuple(p.shape):
            raise ValueError(f"param {name}: shape {tuple(params[name].shape)} != "
                             f"{tuple(p.shape)}")
    with torch.no_grad():
        for name, p in named.items():
            p.data = params[name].to(device=p.device, dtype=p.dtype)


class ContinuousBatchingEngine:
    """Serve a stream of prompts through ``batch_size`` decode slots.

    ``submit(tokens)`` enqueues a request and returns its uid; ``run()``
    drives the scheduler until queue and slots drain, returning
    ``Completion``s. Greedy output is token-exact with
    :func:`generation.build_generate_fn` on the same prompt."""

    def __init__(self, model, params, sampling: SamplingConfig, batch_size: int,
                 prompt_width: int, decode_chunk: int = 8, mesh=None, rules=None,
                 cache_layout: str = "frontier", overlap: bool = True, auto_chunk: bool = False,
                 kv_block_size: int = 16, kv_pool_blocks: int = 0):
        cfg = model.config
        L = cfg.max_seq_len
        if mesh is not None or rules is not None:
            raise not_ported("ContinuousBatchingEngine on a mesh")
        if cache_layout == "paged":
            raise not_ported("cache_layout='paged' (models/kv_blocks.py)")
        if cache_layout not in ("frontier", "per_row"):
            raise ValueError(f"cache_layout {cache_layout!r}: frontier | per_row | paged")
        if cfg.vocab_size >= _MAX_PACKED_VOCAB:
            raise ValueError(f"vocab_size {cfg.vocab_size} >= 2**24: token ids would not be "
                             f"exact in the chunk's fp32 readback")
        self.layout = cache_layout
        if cache_layout == "per_row":
            if prompt_width + sampling.max_new_tokens > L:
                raise ValueError(
                    f"per_row liveness: prompt_width + max_new_tokens = "
                    f"{prompt_width + sampling.max_new_tokens} > max_seq_len {L}")
        else:
            # the worst compacted frontier is the aligned longest history;
            # after it there must be room for a whole request's decode and
            # for the next chunk's writes
            need = self._align(prompt_width + sampling.max_new_tokens) + max(
                sampling.max_new_tokens, decode_chunk)
            if need > L:
                raise ValueError(
                    f"continuous batching liveness: aligned(prompt_width + max_new_tokens) + "
                    f"max(max_new_tokens, decode_chunk) = {need} > max_seq_len {L}")
        self.model = model
        self.device = next(model.parameters()).device
        if params is not None:
            _bind_params(model, params)
        self.s = sampling
        self.B = batch_size
        self.Pw = prompt_width
        self.L = L
        self.d = decode_chunk
        self.overlap = bool(overlap)
        # chunks dispatched but not yet read (the overlapped round keeps at
        # most one behind the newest)
        self._inflight: List[_Inflight] = []
        self._host_bufs: Dict[int, List[torch.Tensor]] = {}
        # tokens emitted by drains outside a step (swap adoption), folded
        # into the next step()'s return
        self._drained_uncounted = 0
        self.swap_latency_s: Optional[float] = None
        self._pending_params = None  # (tensors, event) of an async swap
        self._pending_t0 = 0.0
        self.swap_failures = 0
        self.last_swap_error: Optional[str] = None
        self._uid = 0
        # (uid, tokens, submit_t, cap, prefix_id, allowed_tokens)
        self._queue: List[tuple] = []
        self._slots = [_Slot() for _ in range(batch_size)]
        self._completions: List[Completion] = []
        # rows prefilled while a chunk was in flight, by uid; dropped on a
        # weight swap (stale-weight KV) and on cancel
        self._prefilled: Dict[int, tuple] = {}
        # prefix caching: registered token lists and their lazily built row
        # states (dropped on a weight swap)
        self._prefixes: Dict[int, List[int]] = {}
        self._prefix_states: Dict[int, tuple] = {}
        self._next_prefix_id = 0
        self.phases = PhaseAccumulator()
        # rolling completion window: (retire_t, total_s, emitted tokens)
        self._lat_window: deque = deque(maxlen=256)
        self.completed_total = 0
        # kv_block_size and kv_pool_blocks size the paged layout, which is
        # not ported; its counters stay zero so stats() keys are uniform
        self.prefix_hits = 0
        self.alloc_failures = 0
        self.prefix_evictions = 0
        V = cfg.vocab_size
        self._allow_all = torch.ones((V,), dtype=torch.bool, device=self.device)
        self._reset_device_state()
        self._tuner = _ChunkAutoTuner(self) if auto_chunk else None

    # -- device programs -------------------------------------------------

    def _prefill_row(self, tokens, mask):
        """A ``[1, W]`` prompt -> (row cache, last logits [V], last pos,
        row kv_valid [L])."""
        cache, last_logits, last_pos, kv_valid = prefill_prompt(self.model, None, tokens, mask)
        return cache, last_logits[0], last_pos[0], kv_valid[0]

    def _continue_row(self, row_cache, tokens, mask, row_kv, last_pos, start: int):
        """Extend a stored prefix row with a LEFT-padded ``[1, W]`` suffix at
        slots ``[start, start + W)`` (``tokens`` and ``mask`` on the model's
        device): prefix caching's device half. The stored prefix is never
        written: every admission continues a clone of it. Positions continue
        the prefix's real-token count."""
        W = tokens.shape[1]
        cache = clone_cache(row_cache)
        cache["index"] = start
        positions = last_pos + torch.cumsum(mask.long(), dim=1)
        kvv = row_kv[None, :].clone()
        kvv[:, start:start + W] = mask
        logits, cache = decode_apply(self.model, None, cache, tokens, positions, kvv)
        return cache, logits[0, -1].float(), positions[0, -1], kvv[0]

    def _insert(self, slot: int, row, next_slot: int, cap: int) -> None:
        """Copy a prefilled row into the batch state at ``slot``. The batch
        cache's shared frontier is kept; the row's write slot restarts at
        ``next_slot`` (its bucket width, per_row layout); ``cap`` arms the
        row's device-side emission budget."""
        row_cache, row_logits, row_pos, row_kv, row_allow = row
        st = self._state
        for layer, row_layer in zip(st["cache"]["layers"], row_cache["layers"]):
            for name, t in layer.items():
                t[slot] = row_layer[name][0]
        st["kv_valid"][slot] = row_kv
        st["last_logits"][slot] = row_logits
        st["cur_pos"][slot] = row_pos
        st["allow"][slot] = row_allow
        st["budget"][slot] = cap
        st["done"][slot] = False
        st["row_f"][slot] = next_slot

    def _decode_chunk(self, d: int, frontier: int, generator) -> torch.Tensor:
        """``d`` decode steps over the batch state, in place; returns the
        packed ``[3d + 1, B]`` fp32 outputs (tokens, emits, logprobs, done).

        One step body serves both layouts: the frontier layout writes every
        row at the stream-wide ``frontier + t``; per_row writes each row at
        its own frontier, done and empty rows parked at slot L-1 (their
        kv bit and cache row are replaced at the next admission). Each row
        carries its remaining emission budget: at zero it is done-masked
        like EOS, so the host never needs to stop a row itself."""
        st, s, L = self._state, self.s, self.L
        per_row = self.layout == "per_row"
        cache, kv_valid = st["cache"], st["kv_valid"]
        if not per_row:
            cache["index"] = frontier
        last_logits, cur_pos, allow = st["last_logits"], st["cur_pos"], st["allow"]
        budget, done, row_f = st["budget"], st["done"], st["row_f"]
        rows = torch.arange(self.B, device=self.device)
        toks, emits, logps = [], [], []
        for t in range(d):
            # constrained decoding: sampling and behavior logprobs come from
            # the masked distribution (an all-True row is a no-op)
            tok, emit, tok_logp, done = sample_step(
                torch.where(allow, last_logits, float("-inf")), done, generator, s)
            # the token that exhausts the budget is still emitted, then the
            # row is done
            emit = emit & (budget > 0)
            budget = budget - emit.int()
            done = done | (budget <= 0)
            if per_row:
                write_slots = row_f.clamp(max=L - 1)
                kv_valid[rows, write_slots] = True
                row_f = row_f + 1
            else:
                write_slots = None
                kv_valid[:, frontier + t] = True
            cur_pos = cur_pos + 1
            logits, cache = decode_apply(self.model, None, cache, tok[:, None], cur_pos[:, None],
                                         kv_valid, cache_slots=write_slots)
            last_logits = logits[:, 0].float()
            toks.append(tok)
            emits.append(emit)
            logps.append(tok_logp)
        st.update(last_logits=last_logits, cur_pos=cur_pos, budget=budget, done=done,
                  row_f=row_f)
        return torch.cat([torch.stack(toks).float(), torch.stack(emits).float(),
                          torch.stack(logps), done.float()[None]])

    def _compact(self):
        """Rebuild the cache from live histories (frontier layout): the
        frontier drops from near L to the longest history's aligned
        width."""
        rows = [(st.prompt + st.emitted) if st.uid >= 0 else [] for st in self._slots]
        width = self._align(max((len(r) for r in rows), default=1))
        toks, mask = self._pad_rows(rows, width)
        cache, last_logits, last_pos, kv_valid = prefill_prompt(self.model, None, toks, mask)
        # the frontier never drops below Pw: admissions put prompt KV at
        # [0, W <= Pw); the budgets ride through
        self._frontier = max(width, self.Pw)
        cache["index"] = self._frontier
        self._state.update(cache=cache, kv_valid=kv_valid, last_logits=last_logits,
                           cur_pos=last_pos)

    def _reset_device_state(self):
        V, B, L, dev = self.model.config.vocab_size, self.B, self.L, self.device
        self._frontier = self.Pw  # decode writes start past prompt KV
        cache = init_cache(self.model, B)
        cache["index"] = self._frontier
        self._state = {
            "cache": cache,
            "kv_valid": torch.zeros((B, L), dtype=torch.bool, device=dev),
            "last_logits": torch.full((B, V), -1e9, dtype=torch.float32, device=dev),
            "cur_pos": torch.zeros((B,), dtype=torch.long, device=dev),
            "allow": torch.ones((B, V), dtype=torch.bool, device=dev),  # allowed tokens
            "budget": torch.zeros((B,), dtype=torch.int32, device=dev),  # emission budget
            "done": torch.ones((B,), dtype=torch.bool, device=dev),  # empty slots: done
            "row_f": torch.zeros((B,), dtype=torch.long, device=dev),  # per-row frontier
        }

    # -- host scheduler --------------------------------------------------

    def register_prefix(self, tokens: List[int]) -> int:
        """Register a shared prompt prefix (system prompt): requests that
        name the returned id prefill only their suffix; the prefix's KV is
        computed once per weight version, lazily at its first use."""
        if not tokens:
            raise ValueError("empty prefix")
        if self._bucket_width(len(tokens)) >= self.Pw:
            raise ValueError(f"prefix bucket width {self._bucket_width(len(tokens))} leaves no "
                             f"room for a suffix within prompt_width {self.Pw}")
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = list(tokens)
        return pid

    def _prefix_state(self, pid: int) -> tuple:
        """(row cache, last logits, last pos, row kv_valid, bucket width)
        of a registered prefix at the current weights."""
        if pid not in self._prefix_states:
            prefix = self._prefixes[pid]
            width = self._bucket_width(len(prefix))
            toks, mask = self._pad_rows([prefix], width)
            self._prefix_states[pid] = (*self._prefill_row(toks, mask), width)
        return self._prefix_states[pid]

    def unregister_prefix(self, prefix_id: int) -> None:
        """Drop a registered prefix. Refuses while queued requests still
        name it; live rows are fine (their KV was built at admission)."""
        if prefix_id not in self._prefixes:
            raise KeyError(f"unknown prefix_id {prefix_id}")
        if any(item[4] == prefix_id for item in self._queue):
            raise ValueError(f"prefix_id {prefix_id} still referenced by queued requests")
        del self._prefixes[prefix_id]
        self._prefix_states.pop(prefix_id, None)

    def export_prefill(self, tokens: List[int]) -> Dict:
        raise not_ported("export_prefill (prefill/decode disaggregation)")

    def submit_prefilled(self, payload: Dict, max_new_tokens: Optional[int] = None,
                         allowed_tokens: Optional[List[int]] = None) -> int:
        raise not_ported("submit_prefilled (prefill/decode disaggregation)")

    def submit(self, tokens: List[int], max_new_tokens: Optional[int] = None,
               prefix_id: Optional[int] = None,
               allowed_tokens: Optional[List[int]] = None) -> int:
        """Enqueue a request. ``max_new_tokens`` caps this request below the
        engine budget (``sampling.max_new_tokens``). With ``prefix_id``,
        ``tokens`` is the suffix after that registered prefix, and both
        buckets together must fit ``prompt_width``. ``allowed_tokens``
        constrains this request's sampling (and its logprobs) to those
        ids."""
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {prefix_id}")
            if not tokens:
                raise ValueError("prefix_id needs a non-empty suffix")
            total = self._bucket_width(len(self._prefixes[prefix_id])) + self._bucket_width(
                len(tokens))
            if total > self.Pw:
                raise ValueError(f"prefix bucket + suffix bucket = {total} > prompt_width "
                                 f"{self.Pw}")
        elif len(tokens) > self.Pw:
            raise ValueError(f"prompt length {len(tokens)} > prompt_width {self.Pw}")
        cap = self.s.max_new_tokens
        if max_new_tokens is not None:
            if not 1 <= max_new_tokens <= cap:
                raise ValueError(f"max_new_tokens {max_new_tokens} outside [1, {cap}] (the "
                                 f"engine's cache budget)")
            cap = max_new_tokens
        if allowed_tokens is not None:
            V = self.model.config.vocab_size
            allowed_tokens = sorted(set(int(t) for t in allowed_tokens))
            if not allowed_tokens:
                raise ValueError("allowed_tokens must not be empty")
            if allowed_tokens[0] < 0 or allowed_tokens[-1] >= V:
                raise ValueError(f"allowed_tokens outside [0, {V})")
        uid = self._uid
        self._uid += 1
        self._queue.append((uid, list(tokens), time.perf_counter(), cap, prefix_id,
                            allowed_tokens))
        return uid

    def set_params(self, params) -> float:
        """Hot-swap weights (a mapping of the model's parameter names to
        tensors of the same shapes) between chunks; returns the swap
        latency: the copy to the device and the adoption. A payload that
        does not fit raises (the old weights stay)."""
        failures = self.swap_failures
        self.set_params_async(params)
        if self.swap_failures != failures:
            raise RuntimeError(f"weight swap aborted: {self.last_swap_error}")
        event = self._pending_params[1]
        if event is not None:
            event.synchronize()
        self._maybe_adopt_pending()
        return self.swap_latency_s

    def set_params_async(self, params) -> None:
        """Begin a non-blocking swap: the copies to the device are enqueued
        (``non_blocking``) and the engine adopts the new weights at the
        first ``step()`` boundary after they have landed (an event). A
        second call before adoption supersedes the first. A payload that
        does not fit the model aborts the swap: the old weights stay, and
        the failure shows in :meth:`stats`."""
        self._pending_t0 = time.perf_counter()
        try:
            named = dict(self.model.named_parameters())
            tensors = {}
            for name, p in named.items():
                if tuple(params[name].shape) != tuple(p.shape):
                    raise ValueError(f"param {name}: shape {tuple(params[name].shape)} != "
                                     f"{tuple(p.shape)}")
                tensors[name] = params[name].to(device=p.device, dtype=p.dtype,
                                                non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            self._pending_params = (tensors, event)
        except Exception as e:  # noqa: BLE001 - the swap is aborted, not served
            self._abort_pending_swap(e)

    def _abort_pending_swap(self, err: BaseException) -> None:
        self._pending_params = None
        self.swap_failures += 1
        self.last_swap_error = repr(err)[:300]
        logger.error("weight swap aborted (serving old weights): %r", err)

    def _maybe_adopt_pending(self) -> bool:
        """Adopt a pending swap whose copies have landed, checked without
        blocking. The pipeline is drained first, so the swap lands where
        host bookkeeping matches the device."""
        pending = self._pending_params
        if pending is None:
            return False
        tensors, event = pending
        if event is not None and not event.query():
            return False
        self._drained_uncounted += self._drain_inflight()
        _bind_params(self.model, tensors)
        self._pending_params = None
        # stored prefix KV and eager-prefilled rows encode the old weights
        self._prefix_states.clear()
        self._prefilled.clear()
        self.swap_latency_s = time.perf_counter() - self._pending_t0
        return True

    def poll_pending_swap(self) -> bool:
        """Adoption poll for a driver whose engine may sit idle (``step()``
        adopts at chunk boundaries, and an idle server never steps)."""
        return self._maybe_adopt_pending()

    def _pad_rows(self, rows: List[List[int]], width: int):
        return left_pad_prompts(rows, pad_id=self.s.pad_id, width=width, device=self.device)

    @staticmethod
    def _align(n: int, unit: int = 16) -> int:
        """Compaction width alignment (the JAX engine's: bounds its
        distinct re-prefill shapes without the overshoot of powers of
        two)."""
        return max(unit, ((n + unit - 1) // unit) * unit)

    def _bucket_width(self, n: int) -> int:
        """Bucketed prefill width: a short prompt does not pay a ``[1, Pw]``
        forward. KV past the bucket stays a masked hole."""
        width = self.Pw
        for b in (max(8, self.Pw // 4), max(8, self.Pw // 2)):
            if n <= b < width:
                width = b
        return width

    def _build_row(self, uid: int, prompt: List[int], prefix_id: Optional[int] = None,
                   allowed_tokens: Optional[List[int]] = None):
        """Everything an admission needs short of the insert: the prefilled
        row (cache, logits, pos, kv, allow), its bucket width, and the full
        token history (prefix + suffix, for compaction)."""
        if allowed_tokens is None:
            row_allow = self._allow_all
        else:
            row_allow = torch.zeros_like(self._allow_all)
            row_allow[to_device(torch.tensor(allowed_tokens), self.device)] = True
        if prefix_id is not None:
            if prefix_id in self._prefix_states:
                self.prefix_hits += 1
            p_cache, _, p_pos, p_kv, p_width = self._prefix_state(prefix_id)
            s_width = self._bucket_width(len(prompt))
            toks, mask = self._pad_rows([prompt], s_width)
            row_cache, row_logits, row_pos, row_kv = self._continue_row(
                p_cache, toks, mask, p_kv, p_pos, p_width)
            width = p_width + s_width
            full_prompt = self._prefixes[prefix_id] + prompt
        else:
            pre = self._prefilled.pop(uid, None)
            if pre is not None:  # prefilled while a chunk ran: only the insert is left
                row_cache, row_logits, row_pos, row_kv, width = pre
            else:
                width = self._bucket_width(len(prompt))
                toks, mask = self._pad_rows([prompt], width)
                row_cache, row_logits, row_pos, row_kv = self._prefill_row(toks, mask)
            full_prompt = prompt
        return (row_cache, row_logits, row_pos, row_kv, row_allow), width, full_prompt

    def _finalize_slot(self, slot: int):
        """Record the Completion (with its service metrics) and free the
        host slot."""
        st = self._slots[slot]
        if st.uid >= 0:
            now = time.perf_counter()
            total_s = max(now - st.admit_t, 0.0)
            self._completions.append(Completion(
                st.uid, st.emitted, st.logprobs, queue_s=max(st.admit_t - st.submit_t, 0.0),
                ttft_s=max((st.first_tok_t or now) - st.admit_t, 0.0), total_s=total_s))
            self._lat_window.append((now, total_s, len(st.emitted)))
            self.completed_total += 1
        self._slots[slot] = _Slot()

    def _retire(self, slot: int):
        self._finalize_slot(slot)
        self._retire_device_slot(slot)

    def _admit_free_slots(self) -> float:
        """Fill empty slots from the queue while the budget allows; returns
        the seconds spent prefilling and inserting."""
        frontier_layout = self.layout == "frontier"
        prefill_s = 0.0
        for slot, st in enumerate(self._slots):
            if st.uid >= 0 or not self._queue:
                continue
            # the headroom gate uses the head request's own cap; a freed
            # per_row slot always has room
            if frontier_layout and self._frontier + self._queue[0][3] > self.L:
                break  # no room for this request until compaction
            uid, prompt, submit_t, cap, prefix_id, allowed = self._queue.pop(0)
            ta = time.perf_counter()
            row, width, full_prompt = self._build_row(uid, prompt, prefix_id, allowed)
            self._insert(slot, row, width, cap)
            # the full prefix + suffix history: compaction rebuilds rows
            # from these tokens
            self._slots[slot] = _Slot(uid=uid, prompt=full_prompt, submit_t=submit_t, cap=cap,
                                      admit_t=time.perf_counter())
            prefill_s += time.perf_counter() - ta
        return prefill_s

    def _frontier_housekeeping(self) -> int:
        """Frontier-layout cache management (a no-op for per_row): the idle
        reset and compaction, both pipeline drain points. Returns the tokens
        emitted by a drain."""
        emitted = 0
        if self.layout != "frontier":
            return emitted
        if (not self._inflight and self._queue and all(st.uid < 0 for st in self._slots)
                and self._frontier > self.Pw):
            # nothing live but the frontier has advanced: a fresh cache
            # beats dispatching dead chunks until the compaction threshold
            self._reset_device_state()
        if self._frontier + self.d > self.L:
            emitted += self._drain_inflight()
            tc = time.perf_counter()
            self._compact()
            self.phases.add("prefill", time.perf_counter() - tc)
        return emitted

    def _host_buffer(self, d: int) -> torch.Tensor:
        free = self._host_bufs.setdefault(d, [])
        if free:
            return free.pop()
        return torch.empty((3 * d + 1, self.B), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def _dispatch_round(self, generator) -> _Inflight:
        """Enqueue one decode chunk and the copy of its outputs to the host;
        reads nothing back."""
        d = self.d
        packed = self._decode_chunk(d, self._frontier, generator)
        if self.layout == "frontier":
            self._frontier += d
        host = self._host_buffer(d)
        host.copy_(packed, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return _Inflight(host, event, [st.uid for st in self._slots], d)

    def _read(self, entry: _Inflight):
        """Wait for ``entry``'s outputs: (tokens, emits, logprobs, done) as
        numpy arrays of ``[d, B]`` (done ``[B]``)."""
        if entry.event is not None:
            entry.event.synchronize()
        out = entry.host.numpy().copy()
        self._host_bufs.setdefault(entry.d, []).append(entry.host)
        d = entry.d
        return (out[:d].astype(np.int64), out[d:2 * d] > 0.5, out[2 * d:3 * d],
                out[3 * d] > 0.5)

    def _emit_outputs(self, fetched, uids) -> int:
        """Credit one read chunk's tokens to its slots and retire finished
        rows. A slot whose uid changed since dispatch (cancel, or cancel and
        re-admit during the lag) is skipped."""
        toks, emits, logps, done = fetched
        emitted = 0
        now = time.perf_counter()
        for slot, st in enumerate(self._slots):
            if st.uid < 0 or st.uid != uids[slot]:
                continue
            sel = emits[:, slot]
            if sel.any():
                new = toks[sel, slot].tolist()
                room = st.cap - len(st.emitted)
                if room < len(new):  # belt: the device budget enforces the cap
                    new = new[:max(room, 0)]
                if new:
                    if not st.emitted:
                        st.first_tok_t = now
                    st.emitted.extend(int(t) for t in new)
                    st.logprobs.extend(float(x) for x in logps[sel, slot][:len(new)])
                    emitted += len(new)
            st.finished = bool(done[slot])
            if st.finished or len(st.emitted) >= st.cap:
                # the device already done-masked this row
                self._finalize_slot(slot)
        return emitted

    def _process_oldest(self) -> int:
        """Read, emit and retire the oldest in-flight chunk. With a newer
        chunk in flight behind it, the host work is hidden: stamped
        ``overlap_hidden``."""
        entry = self._inflight.pop(0)
        ts = time.perf_counter()
        fetched = self._read(entry)
        t_sync = time.perf_counter()
        self.phases.add("host_sync", t_sync - ts)
        emitted = self._emit_outputs(fetched, entry.uids)
        self.phases.add("overlap_hidden" if self._inflight else "retirement",
                        time.perf_counter() - t_sync)
        return emitted

    def _drain_inflight(self) -> int:
        emitted = 0
        while self._inflight:
            emitted += self._process_oldest()
        return emitted

    def _eager_prefill(self) -> None:
        """Prefill queue-head prompts while a chunk is in flight: their
        admission later pays only the insert. At most B rows are held;
        prefix requests keep the lazy path."""
        held = 0
        for uid, prompt, _submit_t, _cap, prefix_id, _allowed in self._queue:
            if held >= self.B:
                break
            held += 1
            if prefix_id is not None or uid in self._prefilled:
                continue
            width = self._bucket_width(len(prompt))
            toks, mask = self._pad_rows([prompt], width)
            self._prefilled[uid] = (*self._prefill_row(toks, mask), width)

    def _oldest_ready(self) -> bool:
        """Non-blocking: has the oldest in-flight chunk finished?"""
        if not self._inflight:
            return False
        event = self._inflight[0].event
        return event is None or event.query()

    def step(self, generator=None) -> int:
        """One scheduler iteration; returns the tokens emitted. ``generator``
        (a ``torch.Generator`` on the model's device) draws the samples at
        a temperature above 0.

        Synchronous round (``overlap=False``): compact if out of headroom
        (frontier layout), admit into free slots, decode one chunk, wait for
        its outputs, retire finished rows.

        Overlapped round (default): admit and dispatch chunk N first, then
        read chunk N-1, whose execution overlapped the previous call's host
        work, while chunk N runs."""
        emitted = self._step_overlapped(generator) if self.overlap else self._step_sync(generator)
        emitted += self._drained_uncounted
        self._drained_uncounted = 0
        if self._tuner is not None:
            self._tuner.maybe_retune()
        return emitted

    def _step_sync(self, generator) -> int:
        """The host-serial round, kept as the A/B baseline."""
        t0 = time.perf_counter()
        self._maybe_adopt_pending()
        t_adopt = time.perf_counter()
        self._frontier_housekeeping()  # stamps its own compaction as prefill
        t_hk = time.perf_counter()
        prefill_s = self._admit_free_slots()
        t_admit = time.perf_counter()
        self.phases.add("prefill", prefill_s)
        self.phases.add("admission", (t_adopt - t0) + (t_admit - t_hk - prefill_s))
        entry = self._dispatch_round(generator)
        t_disp = time.perf_counter()
        self.phases.add("decode_dispatch", t_disp - t_admit)
        fetched = self._read(entry)
        t_sync = time.perf_counter()
        self.phases.add("host_sync", t_sync - t_disp)
        emitted = self._emit_outputs_sync(fetched, entry.uids)
        self.phases.add("retirement", time.perf_counter() - t_sync)
        self.phases.rounds += 1
        return emitted

    def _emit_outputs_sync(self, fetched, uids) -> int:
        """The synchronous round's per-token host loop (the baseline the
        overlapped round's emission is compared with)."""
        toks, emits, logps, done = fetched
        emitted = 0
        for slot, st in enumerate(self._slots):
            if st.uid < 0:
                continue
            for t in range(toks.shape[0]):
                if len(st.emitted) >= st.cap:
                    break
                if emits[t, slot]:
                    if not st.emitted:
                        st.first_tok_t = time.perf_counter()
                    st.emitted.append(int(toks[t, slot]))
                    st.logprobs.append(float(logps[t, slot]))
                    emitted += 1
            st.finished = bool(done[slot])
            if st.finished or len(st.emitted) >= st.cap:
                self._retire(slot)
        return emitted

    def _step_overlapped(self, generator) -> int:
        """The double-buffered round: dispatch chunk N before reading chunk
        N-1, so every host span between two dispatches runs under an
        executing chunk."""
        emitted = 0
        self._maybe_adopt_pending()
        emitted += self._frontier_housekeeping()
        # zero-lag retirement: when the device already finished the oldest
        # chunk, process it before dispatching, so the slots it freed refill
        # in this round's admission
        if self._oldest_ready():
            emitted += self._process_oldest()
        hidden = bool(self._inflight)
        ta = time.perf_counter()
        prefill_s = self._admit_free_slots()
        t_admit = time.perf_counter()
        if hidden:
            self.phases.add("overlap_hidden", t_admit - ta)
        else:
            self.phases.add("prefill", prefill_s)
            self.phases.add("admission", t_admit - ta - prefill_s)
        dispatched = False
        if any(st.uid >= 0 for st in self._slots):
            self._inflight.append(self._dispatch_round(generator))
            self.phases.add("decode_dispatch", time.perf_counter() - t_admit)
            dispatched = True
            # queued prompts prefill now, behind the chunk just dispatched
            tp = time.perf_counter()
            self._eager_prefill()
            self.phases.add("overlap_hidden", time.perf_counter() - tp)
        # keep the pipeline one deep: read the previous chunk while the new
        # one runs; with nothing dispatched, drain the tail
        if len(self._inflight) > (1 if dispatched else 0):
            emitted += self._process_oldest()
        self.phases.rounds += 1
        return emitted

    @property
    def pending(self) -> bool:
        """True while any request is queued or decoding, or a dispatched
        chunk's outputs are unread."""
        return (bool(self._queue) or any(st.uid >= 0 for st in self._slots)
                or bool(self._inflight))

    def _latency_stats(self) -> Dict:
        """p50/p95 completion latency and the rolling tokens/s over the
        retirement window (snapshot first: /healthz reads it from handler
        threads while the driver retires slots)."""
        window = list(self._lat_window)
        if not window:
            return {"latency_p50_s": None, "latency_p95_s": None, "tokens_per_s": None,
                    "completed_total": self.completed_total}
        lats = sorted(t for _, t, _ in window)
        # a single just-retired request: its own service time is the span
        span = max(time.perf_counter() - window[0][0], lats[-1], 1e-6)
        return {
            "latency_p50_s": round(lats[len(lats) // 2], 4),
            "latency_p95_s": round(lats[min(int(len(lats) * 0.95), len(lats) - 1)], 4),
            "tokens_per_s": round(sum(n for _, _, n in window) / span, 2),
            "completed_total": self.completed_total,
        }

    def stats(self) -> Dict:
        """Operational snapshot (``/healthz``): occupancy, queue depth,
        latency percentiles and the cache configuration, with the JAX
        engine's keys (the paged layout's are None)."""
        return {
            **self._latency_stats(),
            "cache_layout": self.layout,
            "overlap": self.overlap,
            "inflight_chunks": len(self._inflight),
            "decode_chunk": self.d,
            "auto_chunk_retunes": self._tuner.retunes if self._tuner is not None else None,
            "busy_slots": sum(1 for st in self._slots if st.uid >= 0),
            "queue_depth": len(self._queue),
            "registered_prefixes": len(self._prefixes),
            "prefix_states_cached": len(self._prefix_states),
            "prefix_hits": self.prefix_hits,
            "resident_prefixes": sorted(self._prefix_states)[:64],
            "kv_block_size": None,
            "blocks_total": None,
            "blocks_free": None,
            "alloc_failures": self.alloc_failures,
            "prefix_evictions": self.prefix_evictions,
            "kv_cache_int8": bool(getattr(self.model.config, "kv_cache_int8", False)),
            "last_swap_latency_s": self.swap_latency_s,
            "swap_pending": self._pending_params is not None,
            "swap_failures": self.swap_failures,
            "last_swap_error": self.last_swap_error,
            "phase_split": self.phases.split().summary(),
        }

    def partial(self, uid: int):
        """Tokens emitted so far for a live uid, or None when it is not
        decoding (queued, finished or unknown). Safe from other threads: a
        torn read under-reports by at most one chunk."""
        for st in self._slots:
            if st.uid == uid:
                return list(st.emitted)
        return None

    def cancel(self, uid: int) -> bool:
        """Abort a request: a queued one is dropped; a decoding one's slot
        is freed (its device row keeps stepping, emitting to nobody, until
        the next admission). No Completion is recorded."""
        for i, item in enumerate(self._queue):
            if item[0] == uid:
                del self._queue[i]
                self._prefilled.pop(uid, None)
                return True
        for slot, st in enumerate(self._slots):
            if st.uid == uid:
                self._slots[slot] = _Slot()
                self._retire_device_slot(slot)
                return True
        return False

    def _retire_device_slot(self, slot: int) -> None:
        """Silence a freed slot on the device until the next admission."""
        self._state["done"][slot] = True

    def drain_completions(self) -> List[Completion]:
        """Hand over (and clear) finished requests, uid-ordered."""
        out, self._completions = self._completions, []
        return sorted(out, key=lambda c: c.uid)

    def run(self, prompts=None, rng=None) -> List[Completion]:
        """Drive the scheduler until every queued request completes.
        ``rng`` is a ``torch.Generator`` on the model's device (seed 0 by
        default)."""
        if rng is None:
            rng = torch.Generator(device=self.device).manual_seed(0)
        for p in prompts or []:
            self.submit(p)
        while self.pending:
            self.step(rng)
        return self.drain_completions()


class SpeculativeBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching with in-scheduler speculative decoding: not
    ported (``models/speculative.py`` neither)."""

    def __init__(self, *args, **kwargs):
        raise not_ported("SpeculativeBatchingEngine (models/speculative.py)")
