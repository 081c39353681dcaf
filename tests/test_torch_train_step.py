"""The port's train step and optimizer (dlrover_tpu_torch/parallel/
train_step.py) against the JAX package's, on the CPU.

Both start from the same parameters (the JAX init, carried across with
``params_from_flax``) and take 3 steps on the same numpy tokens through
their own ``build_train_step`` (the JAX one on a 1-device mesh), with a
2-step warmup so the learning rate is non-zero after the first step.
Losses agree to 1e-5 relative. Parameters agree to 1e-4 absolute in fp32:
Adam divides by sqrt(nu), which turns last-digit differences in small
gradients into differences of up to ~lr * 1e-2 in the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.parallel import train_step as jts
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.models import gpt as tgpt
from dlrover_tpu_torch.models.params import params_from_flax
from dlrover_tpu_torch.parallel import train_step as tts

torch.set_num_threads(2)

SMALL = dict(vocab_size=256, max_seq_len=32, num_layers=2, num_heads=4,
             head_dim=8, embed_dim=32, use_remat=False, attention_impl="flash")
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4


def _run_both(steps=3, grad_accum_steps=1, ce_chunk=0, batch=4):
    r = np.random.default_rng(1)
    tokens = r.integers(0, SMALL["vocab_size"], (batch, 32)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)

    jmodel = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, ce_chunk=ce_chunk, **SMALL))
    jtx = jts.default_optimizer(learning_rate=1e-2, warmup_steps=2)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    jstate, shardings = jts.init_train_state(jmodel, jnp.asarray(tokens), mesh, jtx)
    jloss_fn = jgpt.token_loss_mean if ce_chunk else jgpt.cross_entropy_loss
    jstep = jts.build_train_step(
        jmodel, jtx, jloss_fn, mesh, shardings, donate=False,
        grad_accum_steps=grad_accum_steps,
    )

    tmodel = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, ce_chunk=ce_chunk, **SMALL),
                      device="cpu")
    ttx = tts.default_optimizer(learning_rate=1e-2, warmup_steps=2)
    tstate = tts.init_train_state(tmodel, torch.from_numpy(tokens), ttx, device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    tloss_fn = tgpt.token_loss_mean if ce_chunk else tgpt.cross_entropy_loss
    tstep = tts.build_train_step(tmodel, ttx, tloss_fn, grad_accum_steps=grad_accum_steps)

    history = []
    tin, ttg = torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()
    for _ in range(steps):
        before = {n: p.detach().clone() for n, p in tstate.params.items()}
        jstate, jloss = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        tstate, tloss = tstep(tstate, tin, ttg)
        history.append(dict(
            jloss=float(jloss), tloss=float(tloss), before=before,
            jparams=params_from_flax(jax.tree.map(np.asarray, jstate.params)),
            tparams={n: p.detach().clone() for n, p in tstate.params.items()},
        ))
    return history, tstate


@pytest.mark.parametrize(
    "grad_accum_steps,ce_chunk", [(1, 0), (2, 0), (1, 16)],
    ids=["plain", "grad_accum_2", "fused_ce"],
)
def test_three_steps_match_jax(grad_accum_steps, ce_chunk):
    history, state = _run_both(grad_accum_steps=grad_accum_steps, ce_chunk=ce_chunk)
    assert state.step == 3 and state.opt_state.count == 3
    for i, h in enumerate(history):
        np.testing.assert_allclose(h["tloss"], h["jloss"], rtol=LOSS_RTOL, err_msg=f"step {i}")
        for name, p in h["tparams"].items():
            np.testing.assert_allclose(
                p.numpy(), h["jparams"][name].numpy(), atol=PARAM_ATOL, rtol=0,
                err_msg=f"step {i} {name}",
            )
    # optax evaluates the schedule before the count increments: the first
    # update has learning rate 0 and leaves every parameter as it was
    first = history[0]
    for name, p in first["tparams"].items():
        torch.testing.assert_close(p, first["before"][name], atol=0, rtol=0)
    assert any(
        not torch.equal(history[1]["tparams"][n], history[1]["before"][n])
        for n in history[1]["tparams"]
    )


@pytest.mark.parametrize("count", [0, 1, 2, 50, 100, 5000, 10_000, 20_000])
def test_schedule_matches_optax(count):
    ours = tts.warmup_cosine_decay_schedule(0.0, 3e-4, 100, 10_000)
    theirs = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=100, decay_steps=10_000
    )
    # optax evaluates in float32, the port in Python floats
    np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_optimizer_update_matches_optax(grad_scale):
    """Two updates of every leaf kind (matrix, bias, LayerNorm scale), with
    the global norm below and above the clip threshold."""
    r = np.random.default_rng(2)
    start = {n: r.standard_normal(s).astype(np.float32)
             for n, s in (("w", (4, 3)), ("b", (3,)), ("scale", (3,)))}
    grads = {n: grad_scale * r.standard_normal(p.shape).astype(np.float32)
             for n, p in start.items()}
    tx = jts.default_optimizer(learning_rate=1e-2, warmup_steps=1)
    params_j, opt = start, tx.init(start)
    ours = tts.default_optimizer(learning_rate=1e-2, warmup_steps=1)
    params_t = {n: torch.from_numpy(p.copy()) for n, p in start.items()}
    state = ours.init(params_t)
    for _ in range(2):  # the first update has lr 0
        updates, opt = tx.update(grads, opt, params_j)
        params_j = optax.apply_updates(params_j, updates)
        state = ours.update(
            {n: torch.from_numpy(g.copy()) for n, g in grads.items()}, state, params_t
        )
    assert state.count == 2
    for n, p in params_t.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(params_j[n]), atol=1e-6, rtol=0)


def test_eval_step_matches_jax():
    r = np.random.default_rng(3)
    tokens = r.integers(0, SMALL["vocab_size"], (2, 32)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    jmodel = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **SMALL))
    params = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(tokens))["params"]
    loss_j = jgpt.cross_entropy_loss(
        jmodel.apply({"params": params}, jnp.asarray(tokens)), jnp.asarray(targets)
    )
    tmodel = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **SMALL), device="cpu")
    eval_fn = tts.build_eval_step(tmodel, tgpt.cross_entropy_loss)
    loss_t = eval_fn(params_from_flax(jax.tree.map(np.asarray, params)),
                     torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=LOSS_RTOL)


def test_grad_accum_needs_a_divisible_batch():
    model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **SMALL), device="cpu")
    tx = tts.default_optimizer()
    tokens = torch.zeros((3, 8), dtype=torch.long)
    state = tts.init_train_state(model, tokens, tx, device="cpu")
    step = tts.build_train_step(model, tx, tgpt.cross_entropy_loss, grad_accum_steps=2)
    with pytest.raises(ValueError, match="not divisible"):
        step(state, tokens, tokens)
