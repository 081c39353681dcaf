"""The port's train step with the Llama family (dlrover_tpu_torch/
parallel/train_step.py with models/llama.py) against the JAX step, on the
CPU: the MoE load-balance terms weighted by ``aux_loss_weight`` in the loss
the step differentiates and returns.

Both start from the same parameters (the JAX init, carried across with
``params_from_flax``) and take 3 steps on the same numpy tokens through
their own ``build_train_step`` (the JAX one on a 1-device mesh; flash
attention and remat in both), with a 2-step warmup. Tolerances are those of
tests/test_torch_train_step.py: losses 1e-5 relative, parameters 1e-4
absolute in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import gpt as jgpt
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import train_step as jts
from dlrover_tpu.parallel.mesh import MeshConfig, build_mesh
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.params import params_from_flax
from dlrover_tpu_torch.parallel import train_step as tts

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
SMALL = dict(vocab_size=256, max_seq_len=32, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=8, embed_dim=32, mlp_dim=64, use_remat=True, attention_impl="flash")
VARIANTS = {"dense": {}, "moe": dict(num_experts=4, moe_every=2)}


def _run_both(variant, grad_accum_steps, aux_loss_weight, steps=3, batch=4):
    kw = {**SMALL, **VARIANTS[variant]}
    r = np.random.default_rng(1)
    tokens = r.integers(0, SMALL["vocab_size"], (batch, 32)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)

    jmodel = jllama.Llama(jllama.LlamaConfig(dtype=jnp.float32, **kw))
    jtx = jts.default_optimizer(learning_rate=1e-2, warmup_steps=2)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    jstate, shardings = jts.init_train_state(jmodel, jnp.asarray(tokens), mesh, jtx)
    jstep = jts.build_train_step(jmodel, jtx, jgpt.cross_entropy_loss, mesh, shardings,
                                 donate=False, grad_accum_steps=grad_accum_steps,
                                 aux_loss_weight=aux_loss_weight)

    tmodel = tllama.Llama(tllama.LlamaConfig(dtype=torch.float32, **kw), device="cpu")
    ttx = tts.default_optimizer(learning_rate=1e-2, warmup_steps=2)
    tstate = tts.init_train_state(tmodel, torch.from_numpy(tokens), ttx, device="cpu")
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    tstep = tts.build_train_step(tmodel, ttx, tllama.llama_loss,
                                 grad_accum_steps=grad_accum_steps,
                                 aux_loss_weight=aux_loss_weight)

    tin, ttg = torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()
    with torch.no_grad():  # the first step's loss, split: CE and the MoE terms
        micro = batch // grad_accum_steps
        parts = []
        for m in range(grad_accum_steps):
            rows = slice(m * micro, (m + 1) * micro)
            ce = float(tllama.llama_loss(tmodel(tin[rows]), ttg[rows]))
            parts.append((ce, sum(float(a) for a in tmodel.aux_losses)))
    history = []
    for _ in range(steps):
        jstate, jloss = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        tstate, tloss = tstep(tstate, tin, ttg)
        history.append(dict(
            jloss=float(jloss), tloss=float(tloss),
            jparams=params_from_flax(jax.tree.map(np.asarray, jstate.params)),
            tparams={n: p.detach().clone() for n, p in tstate.params.items()},
        ))
    return history, parts


@pytest.mark.parametrize(
    "variant,grad_accum_steps,aux_loss_weight",
    [("dense", 1, 0.01), ("dense", 2, 0.01), ("moe", 1, 0.01), ("moe", 2, 0.01),
     ("moe", 1, 0.0), ("moe", 2, 0.0)],
    ids=["dense", "dense_accum2", "moe_aux", "moe_aux_accum2", "moe_no_aux",
         "moe_no_aux_accum2"],
)
def test_three_train_steps_match_jax(variant, grad_accum_steps, aux_loss_weight):
    history, parts = _run_both(variant, grad_accum_steps, aux_loss_weight)
    for i, h in enumerate(history):
        np.testing.assert_allclose(h["tloss"], h["jloss"], rtol=LOSS_RTOL, err_msg=f"step {i}")
        for name, p in h["tparams"].items():
            np.testing.assert_allclose(p.numpy(), h["jparams"][name].numpy(), atol=PARAM_ATOL,
                                       rtol=0, err_msg=f"step {i} {name}")
    # the step's loss is each micro-batch's CE plus the weighted MoE terms
    expect = sum(ce + aux_loss_weight * aux for ce, aux in parts) / len(parts)
    np.testing.assert_allclose(history[0]["tloss"], expect, rtol=LOSS_RTOL)
    aux_total = sum(aux for _, aux in parts)
    assert (aux_total > 0) == (variant == "moe")
