"""The port's decode path (``dlrover_tpu_torch/models/generation.py`` and
the decode halves of ``models/gpt.py`` and ``models/llama.py``) against the
JAX package's on the same weights and prompts, on the CPU.

The tiny configs of ``tests/test_generation.py`` in fp32: prefill logits,
the cache after it (through ``params.cache_to_flax``) and every decode
step's logits within 1e-5 of JAX's, greedy tokens equal, logprobs within
1e-5, for GPT (with and without remat), Llama and its MoE, with the exact
and the int8 cache. The JAX side is a few compiled programs a model: its prefill, its
decode step and its ``generate``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import generation as jg
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.models import generation as tg
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import params as tparams
from dlrover_tpu_torch.parallel.mesh import Mesh
from dlrover_tpu_torch.parallel.sharding import shard_model

TOL = 1e-5
PROMPTS = [[5, 9, 2, 17, 3], [7, 1, 4]]
WIDTH = 8
STEPS = 5
_GPT = dict(vocab_size=256, max_seq_len=128, num_layers=2, num_heads=4, head_dim=8,
            embed_dim=32)


def _configs(name, int8=False):
    """(JAX config, port config) of ``name`` in fp32."""
    if name.startswith("gpt"):
        kw = dict(_GPT, use_remat=name == "gpt_remat", kv_cache_int8=int8)
        return (jgpt.GPTConfig(**kw, dtype=jnp.float32),
                tgpt.GPTConfig(**kw, dtype=torch.float32))
    over = dict(num_experts=4, moe_every=2) if name == "llama_moe" else {}
    return (jllama.LlamaConfig.tiny(dtype=jnp.float32, kv_cache_int8=int8, **over),
            tllama.LlamaConfig.tiny(dtype=torch.float32, kv_cache_int8=int8, **over))


def _pair(name, int8=False, seed=0):
    """(JAX model, its params, the port's model on the same weights)."""
    jcfg, tcfg = _configs(name, int8)
    if name.startswith("gpt"):
        jm, tm = jgpt.GPT(jcfg), tgpt.GPT(tcfg, device="cpu")
    else:
        jm, tm = jllama.Llama(jcfg), tllama.Llama(tcfg, device="cpu")
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 8), jnp.int32))["params"]
    tm.load_state_dict(tparams.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _family(name):
    return "gpt" if name.startswith("gpt") else "llama"


def _assert_cache_equal(jcache, tcache, family):
    flat_j = jax.tree_util.tree_flatten_with_path(jcache)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tparams.cache_to_flax(tcache, family))[0])
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        a, b = np.asarray(leaf), np.asarray(flat_t[path])
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == np.int8 or a.ndim == 0:
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        else:
            np.testing.assert_allclose(b, a, atol=TOL, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("int8", [False, True], ids=["exact", "int8"])
@pytest.mark.parametrize("name", ["gpt", "gpt_remat", "llama", "llama_moe"])
def test_prefill_cache_and_decode_steps_match_jax(name, int8):
    jm, params, tm = _pair(name, int8)
    jt, jmask = jg.left_pad_prompts(PROMPTS, width=WIDTH)
    tt, tmask = tg.left_pad_prompts(PROMPTS, width=WIDTH)
    jc, jlast, jpos, jkv = jax.jit(functools.partial(jg.prefill_prompt, jm))(params, jt, jmask)
    tc, tlast, tpos, tkv = tg.prefill_prompt(tm, None, tt, tmask)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkv))
    _assert_cache_equal(jc, tc, _family(name))
    L = tm.config.max_seq_len
    jstep = jax.jit(functools.partial(jg.decode_apply, jm))
    for t in range(STEPS):
        tok = jnp.argmax(jlast, axis=-1)
        np.testing.assert_array_equal(tlast.argmax(-1).numpy(), np.asarray(tok))
        jkv = jkv | (jnp.arange(L)[None, :] == WIDTH + t)
        tkv[:, WIDTH + t] = True
        jpos, tpos = jpos + 1, tpos + 1
        jl, jc = jstep(params, jc, tok[:, None], jpos[:, None], jkv)
        tl, tc = tg.decode_apply(tm, None, tc, torch.from_numpy(np.array(tok))[:, None],
                                 tpos[:, None], tkv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        jlast, tlast = jl[:, 0].astype(jnp.float32), tl[:, 0].float()
    _assert_cache_equal(jc, tc, _family(name))


@pytest.mark.parametrize("name", ["gpt", "gpt_remat", "llama", "llama_moe"])
def test_greedy_generate_tokens_and_logprobs_match_jax(name):
    jm, params, tm = _pair(name)
    s_j = jg.SamplingConfig(max_new_tokens=6, temperature=0.0)
    s_t = tg.SamplingConfig(max_new_tokens=6, temperature=0.0)
    jtoks, jmask, jlogp = jg.generate(jm, params, *jg.left_pad_prompts(PROMPTS, width=WIDTH),
                                      jax.random.PRNGKey(0), s_j)
    ttoks, tmask, tlogp = tg.generate(tm, None, *tg.left_pad_prompts(PROMPTS, width=WIDTH),
                                      None, s_t)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_greedy_decode_is_the_teacher_forced_argmax(name):
    """The keystone property: prefill plus incremental decode is the model;
    greedy decode reproduces the argmax of the full forward without a
    cache."""
    _, _, tm = _pair(name)
    prompt = [3, 7, 11]
    toks, mask, _ = tg.generate(tm, None, *tg.left_pad_prompts([prompt]), None,
                                tg.SamplingConfig(max_new_tokens=5, temperature=0.0))
    assert bool(mask.all())
    with torch.no_grad():
        logits = tm(torch.tensor([prompt + toks[0, :4].tolist()]))
    np.testing.assert_array_equal(logits[0, len(prompt) - 1:].argmax(-1).numpy(),
                                  toks[0].numpy())


@pytest.mark.parametrize("window", [1, 2], ids=["row_slots", "window_slots"])
@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_cache_slots_writes_match_jax(name, window):
    """Per-row write slots (the continuous engine's per_row layout, ``[B]``,
    and a window of ``[B, T]`` slots): the logits and the cache after the
    write equal JAX's."""
    jm, params, tm = _pair(name)
    jt, jmask = jg.left_pad_prompts(PROMPTS, width=WIDTH)
    jc, jlast, jpos, jkv = jg.prefill_prompt(jm, params, jt, jmask)
    tc, tlast, tpos, tkv = tg.prefill_prompt(tm, None, *tg.left_pad_prompts(PROMPTS, width=WIDTH))
    slots = np.array([[WIDTH + 3, WIDTH + 4], [WIDTH + 1, WIDTH + 2]])[:, :window]
    toks = np.array([[11, 12], [13, 14]])[:, :window]
    pos = np.asarray(jpos)[:, None] + 1 + np.arange(window)[None, :]
    kv = np.asarray(jkv).copy()
    kv[np.arange(2)[:, None], slots] = True
    jslots = jnp.asarray(slots[:, 0] if window == 1 else slots, jnp.int32)
    jl, jc = jg.decode_apply(jm, params, jc, jnp.asarray(toks), jnp.asarray(pos),
                             jnp.asarray(kv), cache_slots=jslots)
    tslots = torch.from_numpy(slots[:, 0] if window == 1 else slots)
    tl, tc = tg.decode_apply(tm, None, tc, torch.from_numpy(toks), torch.from_numpy(pos),
                             torch.from_numpy(kv), cache_slots=tslots)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert tc["index"] == WIDTH  # per-row writes leave the shared frontier
    _assert_cache_equal(jc, tc, _family(name))


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_a_padded_row_generates_as_the_unpadded_prompt(name):
    _, _, tm = _pair(name)
    s = tg.SamplingConfig(max_new_tokens=4, temperature=0.0)
    batch, _, _ = tg.generate(tm, None, *tg.left_pad_prompts([[9], [3, 7, 11, 2]]), None, s)
    alone, _, _ = tg.generate(tm, None, *tg.left_pad_prompts([[9]]), None, s)
    np.testing.assert_array_equal(batch[0].numpy(), alone[0].numpy())


def test_eos_masks_the_rest_of_the_row_as_jax_does():
    jm, params, tm = _pair("gpt")
    plain = tg.SamplingConfig(max_new_tokens=8, temperature=0.0)
    ref, _, _ = tg.generate(tm, None, *tg.left_pad_prompts(PROMPTS, width=WIDTH), None, plain)
    eos = int(ref[0, 2])
    s_t = dataclasses.replace(plain, eos_id=eos, pad_id=0)
    s_j = jg.SamplingConfig(max_new_tokens=8, temperature=0.0, eos_id=eos, pad_id=0)
    ttoks, tmask, tlogp = tg.generate(tm, None, *tg.left_pad_prompts(PROMPTS, width=WIDTH),
                                      None, s_t)
    jtoks, jmask, jlogp = jg.generate(jm, params, *jg.left_pad_prompts(PROMPTS, width=WIDTH),
                                      jax.random.PRNGKey(0), s_j)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    first = int(np.argmax(ref[0].numpy() == eos))
    # the EOS token is kept, everything after it is masked and padded
    assert tmask[0, :first + 1].all() and not tmask[0, first + 1:].any()
    assert (ttoks[0, first + 1:] == 0).all()


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.7), (7, 0.5), (0, 1.0)])
def test_filter_logits_masks_equal_jax(top_k, top_p):
    logits = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    want = np.asarray(jg.filter_logits(jnp.asarray(logits), top_k, top_p))
    got = tg.filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_sampling_draws_from_the_filtered_support():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(6, 64)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    top = logits.topk(3, dim=-1).indices
    for _ in range(20):
        tok = tg.sample_logits(logits, g, temperature=0.8, top_k=3)
        assert bool((top == tok[:, None]).any(-1).all())
    assert torch.equal(tg.sample_logits(logits, g, temperature=1.0, top_k=1), logits.argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_kv_is_bit_equal_to_jax(dtype):
    x = np.random.default_rng(2).normal(size=(2, 5, 3, 16)).astype(np.float32)
    jq, js = jgpt._quant_kv(jnp.asarray(x, getattr(jnp, dtype)))
    tq, ts = tgpt._quant_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (2, 5, 3)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tgpt._dequant_kv(tq, ts, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jgpt._dequant_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_int8_cache_logits_stay_close_to_the_exact_cache(name):
    """JAX's own bound: driven by the exact cache's tokens, every step's
    logits from the int8 cache have a cosine above 0.999 with the exact
    cache's; the cache holds int8 values and fp32 scales."""
    _, _, exact = _pair(name)
    _, _, quant = _pair(name, int8=True)
    tokens, mask = tg.left_pad_prompts(PROMPTS, width=WIDTH)
    traces = []
    for model in (exact, quant):
        cache, last, pos, kv = tg.prefill_prompt(model, None, tokens, mask)
        out, drive = [last], []
        for t in range(4):
            tok = (traces[0][t] if traces else last).argmax(-1)
            kv[:, WIDTH + t] = True
            pos = pos + 1
            logits, cache = tg.decode_apply(model, None, cache, tok[:, None], pos[:, None], kv)
            last = logits[:, 0]
            out.append(last)
        traces.append(out)
    for a, b in zip(*traces):
        assert bool((torch.nn.functional.cosine_similarity(a, b, dim=-1) > 0.999).all())
    layer = tg.init_cache(quant, 2)["layers"][0]
    assert layer["k"].dtype == torch.int8 and layer["k_scale"].dtype == torch.float32
    assert tuple(layer["k_scale"].shape) == tuple(layer["k"].shape[:3])


def test_int8_contractions_are_exact_up_to_their_bound():
    """fp32 holds the int8 contractions exactly while n * 127**2 < 2**24
    (n <= 1040: a head of 64, or 1024 cache slots); beyond it they run in
    fp64, never rounded."""
    assert tgpt.exact_int8_dtype(64) == torch.float32
    assert tgpt.exact_int8_dtype(1040) == torch.float32
    assert tgpt.exact_int8_dtype(1041) == torch.float64
    a = torch.full((1, 1040), 127.0)
    assert float(a.float() @ a.float().T) == 1040 * 127 * 127


def test_the_llama_cache_is_kvh_narrow():
    _, _, tm = _pair("llama")
    cfg = tm.config
    layer = tg.init_cache(tm, 3)["layers"][0]
    assert tuple(layer["k"].shape) == (3, cfg.max_seq_len, cfg.num_kv_heads, cfg.head_dim)
    assert cfg.num_kv_heads < cfg.num_heads


def test_decode_contract_errors():
    _, _, tm = _pair("gpt")
    cache = tg.init_cache(tm, 1)
    tokens = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="positions"):
        tm(tokens, decode=True, cache=cache)
    with pytest.raises(ValueError, match="needs a cache"):
        tm(tokens, decode=True, positions=tokens)
    with pytest.raises(ValueError, match="kv_valid"):
        tm(tokens, decode=True, positions=tokens, cache=cache,
           cache_slots=torch.zeros((1,), dtype=torch.long))
    cache["index"] = tm.config.max_seq_len
    with pytest.raises(ValueError, match="past the cache"):
        tm(tokens, decode=True, positions=tokens, cache=cache)
    with pytest.raises(NotImplementedError, match="not ported"):
        tg.build_generate_fn(tm, tg.SamplingConfig(), 8, mesh=object())
    fn = tg.build_generate_fn(tm, tg.SamplingConfig(max_new_tokens=2), 8)
    with pytest.raises(ValueError, match="prompt_width"):
        fn(None, *tg.left_pad_prompts([[1, 2]], width=4))
    with pytest.raises(ValueError, match="max_seq_len"):
        tg.build_generate_fn(tm, tg.SamplingConfig(max_new_tokens=tm.config.max_seq_len), 8)


def test_decode_on_a_mesh_raises_not_ported():
    """Decode runs on whole parameters; a model placed on a mesh (here its
    fsdp blocks at rank 0 of two) raises instead of decoding a block."""
    _, _, tm = _pair("llama")
    shard_model(tm, Mesh(dict(dp=1, fsdp=2, ep=1, tp=1, sp=1, pp=1), rank=0))
    with pytest.raises(NotImplementedError, match="mesh"):
        tg.prefill_prompt(tm, None, *tg.left_pad_prompts(PROMPTS, width=WIDTH))


def test_params_mapping_runs_through_functional_call():
    """``decode_apply`` with a parameter mapping applies those weights and
    leaves the model's own untouched."""
    _, _, tm = _pair("gpt")
    _, _, other = _pair("gpt", seed=1)
    tokens, mask = tg.left_pad_prompts(PROMPTS, width=WIDTH)
    want = tg.prefill_prompt(other, None, tokens, mask)[1]
    got = tg.prefill_prompt(tm, dict(other.named_parameters()), tokens, mask)[1]
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not torch.equal(tg.prefill_prompt(tm, None, tokens, mask)[1], want)
