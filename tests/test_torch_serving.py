"""The port's continuous-batching engine (``dlrover_tpu_torch/models/
serving.py``) against the JAX package's ``ContinuousBatchingEngine`` on the
same weights and prompts, on the CPU, greedy and token-exact.

Both engines run the same fp32 model (``tests/test_serving.py``'s small
GPT); logprobs agree within 1e-5. Covered: the frontier layout through a
compaction and the per_row layout, the overlapped round against the
synchronous one, per-request caps and EOS retirement, cancel, constrained
decoding (``allowed_tokens``), prefix caching, and a weight swap mid-stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.attribution import phases as jphases
from dlrover_tpu.models import generation as jg
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import serving as jserving
from dlrover_tpu_torch.attribution import phases as tphases
from dlrover_tpu_torch.models import generation as tg
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import params as tparams
from dlrover_tpu_torch.models import serving as tserving

TOL = 1e-5
_CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8, embed_dim=16, use_remat=False)


def _pair(seq=256, seed=0, int8=False):
    """(JAX model, its params, the port's model on the same weights), fp32."""
    jm = jgpt.GPT(jgpt.GPTConfig(**_CFG, max_seq_len=seq, dtype=jnp.float32,
                                 kv_cache_int8=int8))
    tm = tgpt.GPT(tgpt.GPTConfig(**_CFG, max_seq_len=seq, dtype=torch.float32,
                                 kv_cache_int8=int8), device="cpu")
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, params, tm, _state(params)


def _state(params):
    return tparams.params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _prompts(n, seed=0, lo=3, hi=14):
    r = np.random.default_rng(seed)
    return [[int(x) for x in r.integers(1, 64, r.integers(lo, hi))] for _ in range(n)]


def _sampling(n, **kw):
    return (jg.SamplingConfig(max_new_tokens=n, temperature=0.0, **kw),
            tg.SamplingConfig(max_new_tokens=n, temperature=0.0, **kw))


def _same(port, jax_done):
    assert [c.uid for c in port] == [c.uid for c in jax_done]
    for a, b in zip(port, jax_done):
        assert a.tokens == b.tokens, f"uid {a.uid}: {a.tokens} != {b.tokens}"
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=TOL, rtol=0)


@pytest.mark.parametrize("layout", ["frontier", "per_row"])
def test_stream_matches_the_jax_engine_overlapped_and_sync(layout, monkeypatch):
    """10 mixed prompts through 3 slots at max_seq_len 48 (the frontier
    layout's liveness edge, so it must compact mid-stream): the port's
    overlapped and synchronous rounds both give the JAX engine's tokens."""
    jm, params, tm, state = _pair(seq=48)
    s_j, s_t = _sampling(8)
    prompts = _prompts(10, seed=3)
    kw = dict(batch_size=3, prompt_width=16, decode_chunk=4, cache_layout=layout)
    want = jserving.ContinuousBatchingEngine(jm, params, s_j, **kw).run(prompts)
    compactions = []
    real = tserving.ContinuousBatchingEngine._compact
    monkeypatch.setattr(tserving.ContinuousBatchingEngine, "_compact",
                        lambda self: (compactions.append(1), real(self))[1])
    for overlap in (True, False):
        eng = tserving.ContinuousBatchingEngine(tm, state, s_t, overlap=overlap, **kw)
        got = eng.run(prompts)
        _same(got, want)
        assert all(0.0 <= c.ttft_s <= c.total_s and c.queue_s >= 0.0 for c in got)
    assert bool(compactions) == (layout == "frontier")
    # the stats carry the JAX engine's keys
    assert set(eng.stats()) == set(
        jserving.ContinuousBatchingEngine(jm, params, s_j, **kw).stats())


def test_caps_and_eos_retire_as_in_the_jax_engine():
    """Per-request caps below the engine budget and an EOS id: every
    request retires where the JAX engine retires it, with the same tokens
    (the EOS token kept); a capped request is a prefix of its uncapped
    twin."""
    jm, params, tm, state = _pair()
    plain = tserving.ContinuousBatchingEngine(tm, state, _sampling(10)[1], batch_size=2,
                                              prompt_width=8, decode_chunk=4)
    ref = plain.run([[5, 9, 2]])[0].tokens
    eos = ref[2]
    s_j, s_t = _sampling(10, eos_id=eos)
    requests = [([5, 9, 2], None), ([5, 9, 2], 2), ([7, 1, 4, 11], 3), ([3, 3], None),
                ([8, 6], 7)]
    done = []
    for cls, m, p, s in ((jserving.ContinuousBatchingEngine, jm, params, s_j),
                         (tserving.ContinuousBatchingEngine, tm, state, s_t)):
        eng = cls(m, p, s, batch_size=2, prompt_width=8, decode_chunk=4)
        for prompt, cap in requests:
            eng.submit(prompt, max_new_tokens=cap)
        done.append(eng.run())
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit([1], max_new_tokens=11)
    _same(done[1], done[0])
    port = done[1]
    assert port[0].tokens == ref[:ref.index(eos) + 1]  # the EOS token kept
    assert port[1].tokens == port[0].tokens[:2]


def test_cancel_frees_the_slot_and_leaves_the_others_exact():
    _, _, tm, state = _pair()
    s = _sampling(10)[1]
    prompts = _prompts(5, seed=4)
    eng = tserving.ContinuousBatchingEngine(tm, state, s, batch_size=2, prompt_width=16,
                                            decode_chunk=4)
    uids = [eng.submit(p) for p in prompts]
    eng.step()
    assert eng.cancel(uids[0])  # decoding
    assert eng.cancel(uids[4])  # queued
    assert not eng.cancel(999)
    got = {c.uid: c.tokens for c in eng.run()}
    assert sorted(got) == uids[1:4]
    for uid in uids[1:4]:
        toks, mask, _ = tg.generate(tm, None, *tg.left_pad_prompts([prompts[uid]]), None, s)
        assert got[uid] == toks[0][mask[0]].tolist()


@pytest.mark.parametrize("layout", ["frontier", "per_row"])
def test_allowed_tokens_match_the_jax_engine(layout):
    """Constrained decoding: sampling and logprobs from the masked
    distribution, unconstrained rows of the same batch unaffected."""
    jm, params, tm, state = _pair()
    s_j, s_t = _sampling(6)
    requests = [([5, 9, 2], [3, 7, 11]), ([7, 1, 4, 11], None), ([8, 6], [40, 2])]
    done = []
    for cls, m, p, s in ((jserving.ContinuousBatchingEngine, jm, params, s_j),
                         (tserving.ContinuousBatchingEngine, tm, state, s_t)):
        eng = cls(m, p, s, batch_size=2, prompt_width=8, decode_chunk=4, cache_layout=layout)
        for prompt, allowed in requests:
            eng.submit(prompt, allowed_tokens=allowed)
        done.append(eng.run())
        with pytest.raises(ValueError, match="allowed_tokens"):
            eng.submit([1], allowed_tokens=[64])
    _same(done[1], done[0])
    assert set(done[1][0].tokens) <= {3, 7, 11} and set(done[1][2].tokens) <= {40, 2}


@pytest.mark.parametrize("layout", ["frontier", "per_row"])
def test_prefix_caching_matches_the_jax_engine(layout):
    """Requests naming a registered prefix prefill only their suffix; the
    completions equal the JAX engine's, the prefix's row is computed once,
    and a prefix still named by queued requests cannot be unregistered."""
    jm, params, tm, state = _pair()
    s_j, s_t = _sampling(8)
    prefix = [11, 23, 5, 42, 9]
    suffixes = [[7, 1], [3, 3, 8, 2], [19], [4, 4, 4, 4, 4, 4]]
    done = []
    for cls, m, p, s in ((jserving.ContinuousBatchingEngine, jm, params, s_j),
                         (tserving.ContinuousBatchingEngine, tm, state, s_t)):
        eng = cls(m, p, s, batch_size=2, prompt_width=16, decode_chunk=4, cache_layout=layout)
        pid = eng.register_prefix(prefix)
        for sfx in suffixes:
            eng.submit(sfx, prefix_id=pid)
        with pytest.raises(ValueError, match="still referenced"):
            eng.unregister_prefix(pid)
        done.append(eng.run())
    _same(done[1], done[0])
    assert eng.prefix_hits == len(suffixes) - 1
    eng.unregister_prefix(pid)
    with pytest.raises(KeyError):
        eng.unregister_prefix(pid)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit([1], prefix_id=pid)


def test_a_weight_swap_mid_stream_matches_the_jax_engine():
    """The synchronous round, two chunks under the first weights, then
    ``set_params`` and the rest under the second: the same tokens as the
    JAX engine swapped at the same round."""
    jm, p1, tm, s1 = _pair(seed=0)
    p2 = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    s_j, s_t = _sampling(16)
    done = []
    for cls, m, a, b, s in ((jserving.ContinuousBatchingEngine, jm, p1, p2, s_j),
                            (tserving.ContinuousBatchingEngine, tm, s1, _state(p2), s_t)):
        eng = cls(m, a, s, batch_size=2, prompt_width=8, decode_chunk=4, overlap=False)
        eng.submit([5, 9, 2])
        eng.submit([7, 1, 4])
        for _ in range(2):
            eng.step(jax.random.PRNGKey(0) if cls is jserving.ContinuousBatchingEngine
                     else None)
        assert eng.set_params(b) > 0
        done.append(eng.run())
    _same(done[1], done[0])


def test_an_async_swap_lands_at_a_chunk_boundary_and_changes_the_tail():
    """``set_params_async`` in the overlapped round: the tokens before the
    swap are the unswapped run's, and the tail runs under the new weights;
    a payload that does not fit the model aborts the swap."""
    _, _, tm, s1 = _pair(seed=0)
    _, _, other, s2 = _pair(seed=1)
    s = _sampling(16)[1]

    def run(swap):
        eng = tserving.ContinuousBatchingEngine(tm, s1, s, batch_size=2, prompt_width=8,
                                                decode_chunk=4)
        eng.submit([5, 9, 2])
        for _ in range(2):
            eng.step()
        if swap:
            eng.set_params_async(s2)
        (c,) = eng.run()
        return c, eng

    base, _ = run(False)
    swapped, eng = run(True)
    assert len(swapped.tokens) == len(base.tokens) == 16
    assert swapped.tokens[:8] == base.tokens[:8]
    assert not np.allclose(swapped.logprobs[8:], base.logprobs[8:], atol=1e-4)
    assert eng.stats()["last_swap_latency_s"] is not None
    eng.set_params_async({"wte": torch.zeros(3)})
    stats = eng.stats()
    assert stats["swap_failures"] == 1 and not stats["swap_pending"]
    assert "shape" in stats["last_swap_error"] or "missing" in stats["last_swap_error"]


def test_the_int8_cache_serves_per_row_as_one_shot_generate():
    _, _, tm, state = _pair(int8=True)
    s = _sampling(6)[1]
    prompts = [[5, 9, 2], [7, 1, 4, 11], [3, 3]]
    eng = tserving.ContinuousBatchingEngine(tm, state, s, batch_size=2, prompt_width=8,
                                            decode_chunk=3, cache_layout="per_row")
    got = eng.run(prompts)
    assert eng.stats()["kv_cache_int8"] is True
    for c, p in zip(got, prompts):
        toks, _, _ = tg.generate(tm, None, *tg.left_pad_prompts([p]), None, s)
        assert c.tokens == toks[0].tolist()


def test_auto_chunk_retunes_and_stays_exact():
    _, _, tm, state = _pair()
    s = _sampling(12)[1]
    prompts = _prompts(12, seed=5)
    eng = tserving.ContinuousBatchingEngine(tm, state, s, batch_size=4, prompt_width=16,
                                            decode_chunk=4, cache_layout="per_row",
                                            auto_chunk=True)
    eng._tuner.HIGH = -1.0  # every window grows the chunk
    got = eng.run(prompts)
    assert eng.stats()["auto_chunk_retunes"] >= 1 and eng.d > 4
    ref = tserving.ContinuousBatchingEngine(tm, None, s, batch_size=4, prompt_width=16,
                                            decode_chunk=4, cache_layout="per_row").run(prompts)
    assert [c.tokens for c in got] == [c.tokens for c in ref]
    split = eng.stats()["phase_split"]
    assert split["rounds"] > 0 and split["overlap_hidden_s"] > 0


def test_what_is_not_ported_raises():
    _, _, tm, state = _pair()
    s = _sampling(4)[1]
    kw = dict(batch_size=2, prompt_width=8)
    with pytest.raises(NotImplementedError, match="paged"):
        tserving.ContinuousBatchingEngine(tm, state, s, cache_layout="paged", **kw)
    with pytest.raises(NotImplementedError, match="mesh"):
        tserving.ContinuousBatchingEngine(tm, state, s, mesh=object(), **kw)
    with pytest.raises(NotImplementedError, match="Speculative"):
        tserving.SpeculativeBatchingEngine(tm, state, s, **kw)
    eng = tserving.ContinuousBatchingEngine(tm, state, s, **kw)
    with pytest.raises(NotImplementedError, match="disaggregation"):
        eng.export_prefill([1, 2])
    with pytest.raises(NotImplementedError, match="disaggregation"):
        eng.submit_prefilled({})
    with pytest.raises(ValueError, match="liveness"):
        tserving.ContinuousBatchingEngine(tm, state, tg.SamplingConfig(max_new_tokens=250),
                                          cache_layout="per_row", **kw)


def test_the_phase_split_reduces_as_the_jax_accumulator():
    spans = [("admission", 0.002), ("prefill", 0.01), ("decode_dispatch", 0.004),
             ("host_sync", 0.02), ("retirement", 0.001), ("overlap_hidden", 0.003)]
    accs = [jphases.PhaseAccumulator(), tphases.PhaseAccumulator()]
    for acc in accs:
        acc.add_round(spans)
        acc.add_round(spans[1:4])
    assert accs[1].split().summary() == accs[0].split().summary()
    assert accs[1].split().phases == accs[0].split().phases
