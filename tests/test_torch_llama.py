"""The port's Llama family (dlrover_tpu_torch/models/llama.py), its weight
bridge (models/params.py), the MoE example and the CPU twin of
chip_smoke.py's phase 9, against the JAX package on the CPU (the train step
with the MoE load-balance term: tests/test_torch_llama_train_step.py).

JAX parameter trees (their names and shapes read off ``init``) are drawn
from a numpy seed, so RMSNorm scales differ from 1 and a swapped name
shows, carried across, and both packages run on the same numpy inputs; the JAX
flash branch runs its Pallas kernels in interpret mode, the port its plain
kernel versions. Tolerances are those of tests/test_torch_gpt.py (fp32 2e-5
absolute, bf16 3e-2: bf16 rounds at other points in the two frameworks). The MoE router runs in fp32 from bf16
activations, so a one-ulp difference upstream can send a token to another
expert: whole MoE models are compared in fp32, and ``MoeMlp`` alone on
identical inputs in both dtypes.
"""

import dataclasses
import math
import os
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import multi_process
from dlrover_tpu_torch.examples import llama_moe
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.params import params_from_flax, params_to_flax
from dlrover_tpu_torch.parallel.mesh import Mesh
from dlrover_tpu_torch.parallel.sharding import shard_model

torch.set_num_threads(2)

FP32_ATOL = 2e-5
BF16_ATOL = 3e-2
SMALL = dict(vocab_size=256, max_seq_len=32, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=8, embed_dim=32, mlp_dim=64, use_remat=False)
MOE = dict(num_experts=4, moe_every=2)
VARIANTS = {"dense": {}, "moe": MOE}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
KEY = jax.random.PRNGKey(0)


def _configs(dtype, **overrides):
    kw = {**SMALL, **overrides}
    jd, td = DTYPES[dtype]
    return jllama.LlamaConfig(dtype=jd, **kw), tllama.LlamaConfig(dtype=td, **kw)


def _atol(dtype):
    return FP32_ATOL if dtype == "f32" else BF16_ATOL


def _random_params(module, *inputs, seed=1):
    """Parameters of the JAX tree's names and shapes (``eval_shape`` of
    ``init``: nothing is run) drawn from a seed: normal 0.05, RMSNorm
    scales around 1, so a swapped name shows."""
    shapes = jax.eval_shape(module.init, KEY, *inputs)["params"]
    r = np.random.default_rng(seed)

    def leaf(path, s):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.05 * r.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tokens(seed=0, shape=(2, 32)):
    r = np.random.default_rng(seed)
    tokens = r.integers(0, SMALL["vocab_size"], shape).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _activations(dtype, seed=3, shape=(2, 32, 32)):
    """The same input in both packages: numpy fp32, rounded to ``dtype``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(jax_value, torch_value, atol):
    np.testing.assert_allclose(
        torch_value.detach().float().numpy(),
        np.asarray(jnp.asarray(jax_value, jnp.float32)),
        atol=atol, rtol=0,
    )


def _module_pair(jmod, tmod, *inputs):
    """Perturbed JAX parameters of a leaf module, loaded into the port's."""
    params = _random_params(jmod, *inputs)
    tmod.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    return params


def _model_pair(dtype, variant, **overrides):
    """(jax model, perturbed jax params, torch model) sharing weights."""
    jcfg, tcfg = _configs(dtype, **VARIANTS[variant], **overrides)
    tokens, _ = _tokens()
    jmodel = jllama.Llama(jcfg)
    params = _random_params(jmodel, jnp.asarray(tokens))
    tmodel = tllama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_flax(params))
    return jmodel, params, tmodel


# -- configuration and weights ----------------------------------------------


def test_config_fields_and_defaults_match_jax():
    jfields = {f.name: f.default for f in dataclasses.fields(jllama.LlamaConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(tllama.LlamaConfig)}
    assert list(tfields) == list(jfields)
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for name, default in jfields.items():
        expect = dtypes[default] if name in ("dtype", "param_dtype") else default
        assert tfields[name] == expect, name
    jtiny, ttiny = jllama.LlamaConfig.tiny(num_experts=2), tllama.LlamaConfig.tiny(num_experts=2)
    for name in jfields:
        if name not in ("dtype", "param_dtype"):
            assert getattr(ttiny, name) == getattr(jtiny, name), name


@pytest.mark.parametrize("moe_every", [1, 2, 3])
def test_moe_placement_matches_jax(moe_every):
    for experts, expert_mlp_dim in ((0, 0), (4, 0), (4, 48)):
        kw = dict(num_experts=experts, moe_every=moe_every, expert_mlp_dim=expert_mlp_dim,
                  num_layers=9)
        jcfg, tcfg = jllama.LlamaConfig(**kw), tllama.LlamaConfig(**kw)
        assert tcfg.moe_mlp_dim == jcfg.moe_mlp_dim
        assert [tcfg.is_moe_block(i) for i in range(9)] == [jcfg.is_moe_block(i) for i in range(9)]


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("variant", ["dense", "moe"])
def test_weight_bridge_round_trip_is_lossless(variant, remat):
    jcfg, tcfg = _configs("f32", use_remat=remat, **VARIANTS[variant])
    tokens, _ = _tokens()
    params = _random_params(jllama.Llama(jcfg), jnp.asarray(tokens), seed=3)
    state = params_from_flax(params)
    model = tllama.Llama(tcfg, device="cpu")
    assert set(state) == set(model.state_dict())
    for name, tensor in model.state_dict().items():
        assert state[name].shape == tensor.shape, name
    model.load_state_dict(state)
    back = params_to_flax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert ("MoeMlp_0" in back["block_1"]) == (variant == "moe")


@pytest.mark.parametrize("variant", ["dense", "moe"])
def test_phase_9_parameter_counts_match_the_jax_tree(variant, monkeypatch):
    """chip_smoke.py phase 9's full-width configurations count the same
    parameters in both packages: the JAX tree's shapes by ``eval_shape``,
    the port's on the meta device (nothing is allocated)."""
    over = chip_smoke.LLAMA_MOE if variant == "moe" else {}
    kw = {**chip_smoke.LLAMA_125M, **over, "attention_impl": ""}
    shapes = jax.eval_shape(lambda: jllama.Llama(jllama.LlamaConfig(**kw)).init(
        KEY, jnp.zeros((1, 8), jnp.int32)))["params"]
    jax_count = sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))
    monkeypatch.setattr(tllama, "resolve_device", lambda device=None: torch.device("meta"))
    monkeypatch.setattr(tllama.Llama, "reset_parameters", lambda self, seed=0: None)
    model = tllama.Llama(tllama.LlamaConfig(**kw))
    assert sum(p.numel() for p in model.parameters()) == jax_count


# -- leaf modules -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches(dtype):
    jcfg, tcfg = _configs(dtype)
    xj, xt = _activations(dtype)
    tmod = tllama.RMSNorm(tcfg, device="cpu")
    params = _module_pair(jllama.RMSNorm(jcfg), tmod, xj)
    y_j = jllama.RMSNorm(jcfg).apply({"params": params}, xj)
    y_t = tmod(xt)
    assert y_t.dtype == DTYPES[dtype][1]
    _close(y_j, y_t, _atol(dtype))


@pytest.mark.parametrize("seq,head_dim,theta", [(32, 8, 10000.0), (1024, 64, 10000.0),
                                                (16, 16, 500000.0)])
def test_rope_tables_match(seq, head_dim, theta):
    cos_j, sin_j = jllama.rope_tables(seq, head_dim, theta)
    cos_t, sin_t = tllama.rope_tables(seq, head_dim, theta)
    assert cos_t.shape == (seq, head_dim // 2) and cos_t.dtype == torch.float32
    _close(cos_j, cos_t, 1e-5)
    _close(sin_j, sin_t, 1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rope_rotates_halves_as_jax(dtype):
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 16, 3, 8)).astype(np.float32)
    jd, td = DTYPES[dtype]
    out_j = jllama.apply_rope(jnp.asarray(x).astype(jd), *jllama.rope_tables(16, 8, 10000.0))
    out_t = tllama.apply_rope(torch.from_numpy(x).to(td), *tllama.rope_tables(16, 8, 10000.0))
    assert out_t.dtype == td
    _close(out_j, out_t, _atol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kv_heads", [4, 2, 1], ids=["kvh_h", "kvh_half", "kvh_1"])
def test_attention_matches(kv_heads, impl, dtype):
    """GQA at KVH = H, H/2 and 1: a K/V head repeated in another order than
    ``jnp.repeat``'s gives other outputs at KVH = H/2."""
    jcfg, tcfg = _configs(dtype, num_kv_heads=kv_heads, attention_impl=impl)
    xj, xt = _activations(dtype)
    tmod = tllama.LlamaAttention(tcfg, device="cpu")
    params = _module_pair(jllama.LlamaAttention(jcfg), tmod, xj)
    y_j = jllama.LlamaAttention(jcfg).apply({"params": params}, xj)
    y_t = tmod(xt)
    assert y_t.shape == (2, 32, 32)
    _close(y_j, y_t, _atol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swiglu_matches(dtype):
    jcfg, tcfg = _configs(dtype)
    xj, xt = _activations(dtype)
    tmod = tllama.SwiGluMlp(tcfg, device="cpu")
    params = _module_pair(jllama.SwiGluMlp(jcfg), tmod, xj)
    _close(jllama.SwiGluMlp(jcfg).apply({"params": params}, xj), tmod(xt), _atol(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("experts,capacity_factor", [(4, 1.25), (4, 0.5), (2, 1.25)],
                         ids=["e4", "e4_overflow", "e2"])
def test_moe_mlp_matches(experts, capacity_factor, dtype):
    """Output and load-balance term on identical inputs, and in fp32 the
    gradients of both with respect to the weights and the input."""
    jcfg, tcfg = _configs(dtype, num_experts=experts, capacity_factor=capacity_factor)
    xj, xt = _activations(dtype)
    seq = xj.shape[1]
    capacity = max(1, int(capacity_factor * 2 * seq / experts))
    if capacity_factor < 1:  # more top-2 choices in a row than the experts' slots
        assert 2 * seq > experts * capacity
    jmod = jllama.MoeMlp(jcfg)
    tmod = tllama.MoeMlp(tcfg, device="cpu")
    params = _module_pair(jmod, tmod, xj)
    r = np.random.default_rng(7).standard_normal((2, seq, 32)).astype(np.float32)

    def jax_fn(p, x):
        y, mutated = jmod.apply({"params": p}, x, mutable=["losses"])
        (aux,) = mutated["losses"]["moe_aux"]
        return jnp.sum(y.astype(jnp.float32) * r) + aux, (y, aux)

    (_, (y_j, aux_j)), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(params, xj)
    xt = xt.requires_grad_()
    y_t, aux_t = tmod(xt)
    _close(y_j, y_t, _atol(dtype))
    _close(aux_j, aux_t, FP32_ATOL)
    assert aux_t.dtype == torch.float32 and float(aux_t.detach()) > 0
    if dtype != "f32":
        return
    obj = (y_t.float() * torch.from_numpy(r)).sum() + aux_t
    names = [n for n, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(obj, [p for _, p in tmod.named_parameters()] + [xt])
    for name, g in zip(names, grads):
        _close(gp_j[name], g, FP32_ATOL)
    _close(gx_j, grads[-1], FP32_ATOL)


# -- the whole model --------------------------------------------------------


@pytest.mark.parametrize("variant,dtype,impl,ce_chunk", [
    (variant, dtype, "flash", ce_chunk)
    for variant, dtype in (("dense", "f32"), ("moe", "f32"), ("dense", "bf16"))
    for ce_chunk in (0, 8)
] + [("dense", "f32", "dense", 0), ("moe", "f32", "dense", 8)])
def test_logits_token_losses_and_grads_match(variant, dtype, impl, ce_chunk):
    jmodel, params, tmodel = _model_pair(dtype, variant, attention_impl=impl, ce_chunk=ce_chunk)
    tokens, targets = _tokens(seed=4)
    targets[0, :3] = -1  # ignored positions
    atol = _atol(dtype)

    logits_j = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        logits_t = tmodel(torch.from_numpy(tokens).long())
    assert logits_t.shape == (2, 32, SMALL["vocab_size"])
    _close(logits_j, logits_t, atol)

    def jax_loss(p):
        tl = jmodel.apply({"params": p}, jnp.asarray(tokens), targets=jnp.asarray(targets))
        return jgpt.token_loss_mean(tl, jnp.asarray(targets)), tl

    (loss_j, tl_j), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tt = torch.from_numpy(targets).long()
    tl_t = tmodel(torch.from_numpy(tokens).long(), targets=tt)
    loss_t = tgpt.token_loss_mean(tl_t, tt)
    _close(tl_j, tl_t, atol)
    _close(loss_j, loss_t, atol)
    names = [n for n, _ in tmodel.named_parameters()]
    grads_t = torch.autograd.grad(loss_t, [p for _, p in tmodel.named_parameters()])
    grads_j = params_from_flax(jax.tree.map(lambda g: np.asarray(g, np.float32), grads_j))
    for name, g in zip(names, grads_t):
        _close(grads_j[name], g, atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_remat_on_and_off_agree(dtype):
    """Remat recomputes each block in backward: the MoE terms are counted
    once a block, and loss, terms and gradients are those without remat."""
    _, tcfg = _configs(dtype, **MOE, num_layers=4)
    results = []
    for remat in (False, True):
        model = tllama.Llama(dataclasses.replace(tcfg, use_remat=remat), device="cpu", seed=3)
        tokens, targets = (torch.from_numpy(a).long() for a in _tokens(seed=6))
        ce = tllama.llama_loss(model(tokens), targets)
        aux = list(model.aux_losses)
        loss = ce + 0.01 * sum(aux)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        assert len(model.aux_losses) == 2  # blocks 1 and 3, once each
        results.append((loss.detach(), [a.detach() for a in aux], grads))
    (loss_a, aux_a, grads_a), (loss_b, aux_b, grads_b) = results
    torch.testing.assert_close(loss_b, loss_a, atol=0, rtol=0)
    for a, b in zip(aux_a, aux_b):
        torch.testing.assert_close(b, a, atol=0, rtol=0)
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(b, a, atol=0, rtol=0)


def test_a_dense_model_has_no_aux_terms():
    _, tcfg = _configs("f32")
    model = tllama.Llama(tcfg, device="cpu")
    model(torch.from_numpy(_tokens()[0]).long())
    assert model.aux_losses == []


# -- what is not ported, the example, phase 9 -------------------------------


def test_decode_raises_not_ported():
    """Decode runs on whole parameters: a model placed on a mesh raises
    ``not_ported`` in decode mode (serving on a mesh is not ported)."""
    _, tcfg = _configs("f32")
    model = tllama.Llama(tcfg, device="cpu")
    shard_model(model, Mesh(dict(dp=1, fsdp=2, ep=1, tp=1, sp=1, pp=1), rank=0))
    tokens = torch.from_numpy(_tokens()[0]).long()
    cache = tgpt.empty_cache(tcfg, tokens.shape[0], tcfg.num_kv_heads, "cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        model(tokens, decode=True, positions=tokens, cache=cache)


@pytest.mark.parametrize("variant", ["dense", "moe"])
def test_decode_steps_give_the_full_forwards_logits(variant):
    """Decode mode, which raised before it was ported: RoPE at absolute
    positions over the KVH-narrow cache gives the forward's logits without
    a cache (fp32). The MoE computes each call's tokens as the JAX MoE does,
    with a capacity from the call's length, so it is held to the forward at
    a capacity factor that drops no token in either (2 for 4 experts, top-2;
    ``tests/test_torch_generation.py`` holds it to the JAX decode)."""
    over = dict(VARIANTS[variant], capacity_factor=2.0) if variant == "moe" else {}
    _, tcfg = _configs("f32", **over)
    model = tllama.Llama(tcfg, device="cpu", seed=2)
    tokens = torch.from_numpy(_tokens(seed=3)[0]).long()[:, :12]
    with torch.no_grad():
        want = model(tokens)
    cache = tgpt.empty_cache(tcfg, 2, tcfg.num_kv_heads, "cpu")
    assert tuple(cache["layers"][0]["k"].shape)[2] == tcfg.num_kv_heads < tcfg.num_heads
    positions = torch.arange(12)[None].expand(2, 12)
    steps = []
    for t in range(12):
        out, cache = model(tokens[:, t:t + 1], decode=True, positions=positions[:, t:t + 1],
                           cache=cache)
        steps.append(out)
    torch.testing.assert_close(torch.cat(steps, 1), want, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["dense", "moe"])
def test_ring_attention_on_one_process_is_dense_attention(variant):
    """``attention_impl="ring"`` on a mesh of one process (sp=1), after the
    GQA repeat: the logits and the gradients equal the dense model's on the
    same weights; without a current mesh it raises, as the JAX model does."""
    from dlrover_tpu_torch.models import gpt as tgpt
    from dlrover_tpu_torch.parallel import mesh as tmesh

    _, tcfg = _configs("f32", **VARIANTS[variant])
    tokens, targets = (torch.from_numpy(t).long() for t in _tokens())
    dense = tllama.Llama(tcfg, device="cpu")
    ring = tllama.Llama(dataclasses.replace(tcfg, attention_impl="ring"), device="cpu")
    ring.load_state_dict(dense.state_dict())
    one = tmesh.build_mesh(tmesh.MeshConfig(dp=1))
    outs = []
    for model in (dense, ring):
        with tmesh.current_mesh(one):
            logits = model(tokens)
        loss = tgpt.cross_entropy_loss(logits, targets) + 0.01 * sum(model.aux_losses)
        outs.append((logits, torch.autograd.grad(loss, list(model.parameters()))))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=2e-5, rtol=0)
    for a, b in zip(outs[1][1], outs[0][1]):
        torch.testing.assert_close(a, b, atol=5e-5, rtol=0)
    with pytest.raises(ValueError, match="current_mesh"):
        ring(tokens)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_the_example_keeps_the_jax_mesh_rule(n):
    """ep 4 when 4 divides the device count, else 1, and dp the rest; a
    mesh of several processes needs a live torch.distributed world (the
    example at ep=2 in a gloo world of two is in
    ``tests/test_torch_llama_moe_world.py``)."""
    if n % 4 == 0:
        split = "ep=4" if n == 4 else f"dp={n // 4},ep=4"
        with pytest.raises(RuntimeError, match=f"{split} mesh needs torch.distributed"):
            llama_moe.mesh_for(n)
    elif n > 1:
        with pytest.raises(RuntimeError, match=f"dp={n} mesh needs torch.distributed"):
            llama_moe.mesh_for(n)
    else:
        assert llama_moe.mesh_for(n).shape == dict(dp=1, fsdp=1, ep=1, tp=1, sp=1, pp=1)


def test_the_example_trains_30_tiny_steps_on_the_cpu(capsys):
    assert llama_moe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "'ep': 1" in out
    losses = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 6 and f"step {llama_moe.STEPS - 5}: loss" in out
    assert all(math.isfinite(x) for x in losses)
    assert abs(losses[0] - math.log(256)) < 0.5


def test_phase_9_on_the_cpu(tmp_path, monkeypatch):
    """The CPU twin of chip_smoke.py's phase 9 at the 2-layer size: every
    check but those that need the card's kernels (``LLAMA_CARD_ONLY``: the
    launch counts)."""
    monkeypatch.setattr(AsyncCheckpointSaver, "_signals_installed", True)
    AsyncCheckpointSaver.reset()
    job = f"tll_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    saved_dir = multi_process.SOCKET_TMP_DIR
    result = chip_smoke.llama_phase(str(tmp_path), job, device="cpu", small=True)
    assert multi_process.SOCKET_TMP_DIR == saved_dir
    assert os.environ.get("DLROVER_JOB_NAME") != job
    assert result["skipped_checks"] == list(chip_smoke.LLAMA_CARD_ONLY) == ["launches"]
    for label in ("dense", "moe"):
        assert len(result[label]["losses"]) == chip_smoke.LLAMA_STEPS
        cmp = result[label]["flash_vs_dense"]
        assert cmp["max_diff_before_a_move"] <= 0.25 and cmp["tokens"] == 2 * 32
    assert result["dense"]["flash_vs_dense"]["tokens_moved"] == 0
    assert result["moe"]["n_params"] > result["dense"]["n_params"]
    assert result["moe"]["checkpoint"]["hash_equal"]
    assert result["moe"]["checkpoint"]["resumed_loss_bit_equal"]
    assert len(result["moe"]["aux"]) == 1 and result["moe"]["aux"][0] > 0
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(f"dlrover_{job}")]


@pytest.mark.parametrize("variant", ["dense", "moe"])
def test_each_blocks_attention_flash_against_dense_covers_every_token(variant):
    """Phase 9's block-level check with the plain versions on the CPU: each
    block's input, captured from the flash model's forward of a 2x32 slice,
    through the flash and the dense attention of that block; every element
    of every token is held to the main path's limits (mean 2e-2, max
    0.25), and a check that fails raises."""
    cfg = tllama.LlamaConfig(**chip_smoke.LLAMA_SMALL,
                             **(chip_smoke.LLAMA_MOE if variant == "moe" else {}))
    model = tllama.Llama(cfg, device="cpu", seed=0)
    dense = tllama.Llama(dataclasses.replace(cfg, attention_impl="dense"), device="cpu")
    dense.load_state_dict(model.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)))
    out = chip_smoke.block_attention_flash_vs_dense(model, dense, tokens)
    assert out["blocks"] == cfg.num_layers and out["tokens"] == 2 * 32
    assert out["max_abs_diff"] <= 0.25 and out["mean_abs_diff"] <= 2e-2
    assert out["max_abs_value"] > 0.25  # the limits are not wider than the values
    with torch.no_grad():
        dense.blocks[-1].attn.wv.mul_(-1.0)  # a wrong attention fails the check
    with pytest.raises(AssertionError, match="disagree"):
        chip_smoke.block_attention_flash_vs_dense(model, dense, tokens)


@pytest.mark.parametrize("num_heads,num_kv_heads,tp", [(12, 4, 2), (4, 2, 2), (4, 2, 4), (6, 2, 2)])
def test_a_tp_rank_repeats_only_the_kv_groups_of_its_heads(num_heads, num_kv_heads, tp):
    """Each tp rank's k heads, from its own kv groups repeated
    (``kv_groups``, ``repeat_kv``), are its query heads' slice of the JAX
    model's ``jnp.repeat`` over every group, also where a rank's heads
    split a group (4 heads over 2 groups at tp=4, 6 over 2 at tp=2)."""
    k = np.random.default_rng(0).standard_normal((2, 3, num_kv_heads, 8)).astype(np.float32)
    rep, heads = num_heads // num_kv_heads, num_heads // tp
    whole = np.asarray(jnp.repeat(jnp.asarray(k), rep, axis=2))
    for first in range(0, num_heads, heads):
        g0, g1, offset = tllama.kv_groups(first, heads, rep)
        got = tllama.repeat_kv(torch.from_numpy(k[:, :, g0:g1]), rep, offset, heads)
        np.testing.assert_array_equal(got.numpy(), whole[:, :, first:first + heads])
