"""The port's GPT (dlrover_tpu_torch/models/gpt.py) and weight bridge
(models/params.py) against the JAX GPT, on the CPU.

The JAX model is initialised, its parameters are perturbed with numpy noise
from a seed (so that the LayerNorm scales and biases differ from their
all-ones / all-zeros init and a swapped name would show), converted with
``params_from_flax``, and both models run on the same tokens. fp32 configs
are held to 2e-5 absolute; bf16 configs to 3e-2, since bf16 rounds at other
points in the two frameworks (matmul outputs, casts around the softmax).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models.params import params_from_flax, params_to_flax
from dlrover_tpu_torch.parallel.mesh import Mesh
from dlrover_tpu_torch.parallel.sharding import shard_model

torch.set_num_threads(2)

FP32_ATOL = 2e-5
BF16_ATOL = 3e-2
SMALL = dict(vocab_size=256, max_seq_len=32, num_layers=2, num_heads=4,
             head_dim=8, embed_dim=32, use_remat=False)


def _configs(dtype, **overrides):
    kw = {**SMALL, **overrides}
    jcfg = jgpt.GPTConfig(dtype={"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype], **kw)
    tcfg = tgpt.GPTConfig(dtype={"f32": torch.float32, "bf16": torch.bfloat16}[dtype], **kw)
    return jcfg, tcfg


def _tokens(seed=0, shape=(2, 32)):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, SMALL["vocab_size"], shape).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _pair(dtype, **overrides):
    """(jax model, jax params, torch model) sharing perturbed weights."""
    jcfg, tcfg = _configs(dtype, **overrides)
    tokens, _ = _tokens()
    jmodel = jgpt.GPT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    r = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * r.standard_normal(a.shape).astype(np.float32),
        params,
    )
    tmodel = tgpt.GPT(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return jmodel, params, tmodel


def _atol(dtype):
    return FP32_ATOL if dtype == "f32" else BF16_ATOL


def _close(jax_value, torch_value, atol):
    np.testing.assert_allclose(
        torch_value.detach().float().numpy(),
        np.asarray(jnp.asarray(jax_value, jnp.float32)),
        atol=atol,
        rtol=0,
    )


def test_weight_bridge_round_trip_is_lossless():
    jcfg, tcfg = _configs("f32", tie_embeddings=False)
    tokens, _ = _tokens()
    params = jgpt.GPT(jcfg).init(jax.random.PRNGKey(3), jnp.asarray(tokens))["params"]
    params = jax.tree.map(np.asarray, params)
    state = params_from_flax(params)
    model = tgpt.GPT(tcfg, device="cpu")
    assert set(state) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert state[name].shape == tensor.shape, name
    back = params_to_flax(state)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match(impl, dtype):
    jmodel, params, tmodel = _pair(dtype, attention_impl=impl)
    tokens, _ = _tokens(seed=2)
    logits_j = jmodel.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        logits_t = tmodel(torch.from_numpy(tokens).long())
    assert logits_t.shape == (2, 32, SMALL["vocab_size"])
    _close(logits_j, logits_t, _atol(dtype))


@pytest.mark.parametrize("ce_chunk", [0, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_token_losses_and_grads_match(impl, dtype, ce_chunk):
    jmodel, params, tmodel = _pair(dtype, attention_impl=impl, ce_chunk=ce_chunk)
    tokens, targets = _tokens(seed=4)
    targets[0, :3] = -1  # ignored positions

    def jax_loss(p):
        tl = jmodel.apply({"params": p}, jnp.asarray(tokens), targets=jnp.asarray(targets))
        return jgpt.token_loss_mean(tl, jnp.asarray(targets)), tl

    (loss_j, tl_j), grads_j = jax.value_and_grad(jax_loss, has_aux=True)(params)
    tt = torch.from_numpy(targets).long()
    tl_t = tmodel(torch.from_numpy(tokens).long(), targets=tt)
    loss_t = tgpt.token_loss_mean(tl_t, tt)
    names = [n for n, _ in tmodel.named_parameters()]
    grads_t = torch.autograd.grad(loss_t, [p for _, p in tmodel.named_parameters()])
    atol = _atol(dtype)
    assert float(tl_t.detach()[0, :3].abs().sum()) == 0.0
    _close(tl_j, tl_t, atol)
    _close(loss_j, loss_t, atol)
    grads_j = params_from_flax(jax.tree.map(np.asarray, grads_j))
    for name, g in zip(names, grads_t):
        np.testing.assert_allclose(
            g.numpy(), grads_j[name].numpy(), atol=atol, rtol=0, err_msg=name
        )


def test_cross_entropy_loss_matches_jax():
    r = np.random.default_rng(6)
    logits = r.standard_normal((2, 5, 11)).astype(np.float32)
    targets = r.integers(0, 11, (2, 5)).astype(np.int32)
    targets[1, 2] = -1
    loss_j = jgpt.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets))
    loss_t = tgpt.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets).long())
    _close(loss_j, loss_t, 1e-6)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_remat_gives_the_same_grads(impl):
    _, tcfg = _configs("f32", attention_impl=impl)
    tokens, targets = _tokens(seed=5)
    grads = []
    for remat in (False, True):
        model = tgpt.GPT(dataclasses.replace(tcfg, use_remat=remat), device="cpu", seed=7)
        loss = tgpt.cross_entropy_loss(
            model(torch.from_numpy(tokens).long()), torch.from_numpy(targets).long()
        )
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=0)


def test_unported_paths_raise():
    _, tcfg = _configs("f32")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    model = tgpt.GPT(tcfg, device="cpu")
    shard_model(model, Mesh(dict(dp=1, fsdp=1, ep=1, tp=2, sp=1, pp=1), rank=1))
    with pytest.raises(NotImplementedError, match="decode on a mesh"):
        model(tokens, decode=True, positions=tokens, cache=tgpt.empty_cache(tcfg, 1, 4, "cpu"))
    with pytest.raises(NotImplementedError, match="dots"):
        tgpt.GPT(dataclasses.replace(tcfg, use_remat=True, remat_policy="dots"), device="cpu")
    with pytest.raises(ValueError, match="ce_chunk"):
        tgpt._chunked_token_ce(torch.zeros(1, 6, 4), torch.zeros(3, 4),
                               torch.zeros(1, 6, dtype=torch.long), 4, True)
    with pytest.raises(ValueError, match="cross_entropy_loss"):
        tgpt.token_loss_mean(torch.zeros(1, 4, 3), torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.parametrize("int8", [False, True], ids=["exact", "int8"])
def test_decode_steps_give_the_full_forwards_logits(int8):
    """Decode mode, which raised before it was ported: a prefill of a
    prompt and one-token steps on the cache give the logits of the forward
    without a cache at the same positions (fp32; the int8 cache within its
    quantization's reach)."""
    _, tcfg = _configs("f32", kv_cache_int8=int8)
    model = tgpt.GPT(tcfg, device="cpu", seed=2)
    tokens = torch.from_numpy(_tokens(seed=3, shape=(2, 12))[0]).long()
    with torch.no_grad():
        want = model(tokens)
    cache = tgpt.empty_cache(tcfg, 2, tcfg.num_heads, "cpu")
    positions = torch.arange(12)[None].expand(2, 12)
    got, cache = model(tokens[:, :8], decode=True, positions=positions[:, :8], cache=cache)
    steps = [got]
    for t in range(8, 12):
        out, cache = model(tokens[:, t:t + 1], decode=True, positions=positions[:, t:t + 1],
                           cache=cache)
        steps.append(out)
    assert cache["index"] == 12
    tol = 5e-2 if int8 else FP32_ATOL
    torch.testing.assert_close(torch.cat(steps, 1), want, atol=tol, rtol=0)


def test_ring_attention_on_one_process_is_dense_attention():
    """``attention_impl="ring"`` on a mesh of one process (sp=1): a ring of
    one block, full causal attention, so the logits and the gradients equal
    the dense model's on the same weights; without a current mesh it raises,
    as the JAX model does, and so does dense attention on a mesh that splits
    the sequence."""
    from dlrover_tpu_torch.parallel import mesh as tmesh

    _, tcfg = _configs("f32")
    tokens, targets = (torch.from_numpy(t).long() for t in _tokens())
    dense = tgpt.GPT(tcfg, device="cpu")
    ring = tgpt.GPT(dataclasses.replace(tcfg, attention_impl="ring"), device="cpu")
    ring.load_state_dict(dense.state_dict())
    one = tmesh.build_mesh(tmesh.MeshConfig(dp=1))
    outs = []
    for model in (dense, ring):
        with tmesh.current_mesh(one):
            logits = model(tokens)
        loss = tgpt.cross_entropy_loss(logits, targets)
        outs.append((logits, torch.autograd.grad(loss, list(model.parameters()))))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=2e-5, rtol=0)
    for a, b in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=0)
    with pytest.raises(ValueError, match="current_mesh"):
        ring(tokens)
    split = tmesh.Mesh(shape=dict(dict.fromkeys(tmesh.MESH_AXES, 1), sp=2))
    with tmesh.current_mesh(split), pytest.raises(ValueError, match="sp=2"):
        dense(tokens)


def test_config_presets_match_jax():
    for preset in ("tiny", "gpt2_small", "gpt2_xl"):
        j, t = getattr(jgpt.GPTConfig, preset)(), getattr(tgpt.GPTConfig, preset)()
        for field in dataclasses.fields(t):
            if field.name not in ("dtype", "param_dtype"):
                assert getattr(t, field.name) == getattr(j, field.name), (preset, field.name)
        assert t.mlp_dim == j.mlp_dim
        assert t.resolved_attention_impl() == j.resolved_attention_impl()
