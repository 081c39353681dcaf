"""Train state, optimizer and train step: the port of
``dlrover_tpu/parallel/train_step.py``.

The JAX module jits a pure ``(state, inputs, targets) -> (state', loss)``
over a mesh and donates the old state. Here the step runs eagerly on this
process's device and updates the parameters and optimizer moments in
place, which stands in for ``donate_argnums=(0,)``: the returned state
holds the same tensors. On a data-parallel mesh (``parallel/mesh.py``)
each process steps its rows of the global batch and the step averages the
gradients and the loss over the mesh's group before the update, as XLA
does for the JAX step on a dp mesh; every process then applies the same
update to the same weights. Sharded layouts (fsdp, tp, ...) wait for the
parallel-layouts slice.

The optimizer is optax's ``chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(...), b1=0.9, b2=0.95, wd=0.1))``
written out, since ``torch.optim.AdamW`` differs from it in three ways:
optax decays every parameter (biases and LayerNorm included), evaluates
the schedule at the step count before the increment (the first update has
learning rate 0), and clips by ``max_norm / g_norm`` only when
``g_norm >= max_norm``, with no epsilon.
"""

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..common.platform import resolve_device
from .mesh import DataParallelMesh


class OptState(NamedTuple):
    count: int  # updates applied so far
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    step: int
    params: Dict[str, torch.nn.Parameter]  # the model's own parameters
    opt_state: OptState


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
) -> Callable[[int], float]:
    """optax's schedule of the same name: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine down to ``end_value``
    at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """Global-norm clipping followed by AdamW, updating in place."""

    def __init__(
        self,
        schedule: Callable[[int], float],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 1e-4,
        max_norm: float = 1.0,
    ):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_norm = max_norm

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        return OptState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(
        self,
        grads: Dict[str, torch.Tensor],
        opt_state: OptState,
        params: Dict[str, torch.Tensor],
    ) -> OptState:
        """Apply one update to ``params`` and the moments in place; return
        the new state. ``grads`` is consumed."""
        names = list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        mu = [opt_state.mu[n] for n in names]
        nu = [opt_state.nu[n] for n in names]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        clip = torch.where(g_norm < self.max_norm, 1.0, self.max_norm / g_norm)
        torch._foreach_mul_(g, clip)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        count = opt_state.count + 1
        denom = torch._foreach_div(nu, 1.0 - self.b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1**count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.schedule(opt_state.count))
        return OptState(count=count, mu=opt_state.mu, nu=opt_state.nu)


def default_optimizer(
    learning_rate: float = 3e-4, weight_decay: float = 0.1, warmup_steps: int = 100
) -> AdamW:
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=learning_rate,
        warmup_steps=warmup_steps,
        decay_steps=max(warmup_steps + 1, 10_000),
    )
    return AdamW(schedule, b1=0.9, b2=0.95, weight_decay=weight_decay)


def init_train_state(
    model, example_input, tx: AdamW, device=None, seed: int = 0
) -> TrainState:
    """Move ``model`` to ``device`` (the GPU unless ``"cpu"`` is asked
    for), initialise its parameters from ``seed`` and the optimizer state.
    ``example_input`` is a ``[batch, seq]`` token batch the model must take."""
    device = resolve_device(device)
    seq = example_input.shape[-1]
    if seq > model.config.max_seq_len:
        raise ValueError(
            f"example input seq {seq} exceeds max_seq_len {model.config.max_seq_len}"
        )
    model.to(device)
    model.reset_parameters(seed)
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def _no_mark(part: str) -> None:
    del part


def all_reduce_mean(grads: Dict[str, torch.Tensor], loss: torch.Tensor, group,
                    size: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The mean over ``group``'s ``size`` processes of every gradient and
    the loss, through one fp32 buffer and one collective: a sum divided by
    ``size`` (gloo has no average). The gradients returned are views of the
    buffer in their own dtype (no copy for fp32)."""
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1).float() for n in names]
                     + [loss.detach().reshape(1).float()])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(size)
    out, offset = {}, 0
    for n in names:
        g = grads[n]
        out[n] = flat[offset : offset + g.numel()].view(g.shape).to(g.dtype)
        offset += g.numel()
    return out, flat[offset].to(loss.dtype)


def build_train_step(
    model,
    tx: AdamW,
    loss_fn: Callable,
    grad_accum_steps: int = 1,
    aux_loss_weight: float = 0.01,
    mesh: Optional[DataParallelMesh] = None,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Tuple[TrainState, torch.Tensor]]:
    """``(state, inputs, targets) -> (state', loss)``, updating in place.

    ``grad_accum_steps`` > 1 keeps the global batch fixed: inputs of shape
    ``[accum*B, ...]`` are run in ``accum`` slices, gradients averaged in
    fp32, one optimizer update. Slices are weighted equally, as in the JAX
    step, so this matches the full-batch step only when each slice's loss
    mean covers the same number of tokens.

    ``aux_loss_weight`` scales the model's auxiliary losses, as the JAX
    step scales the ``("losses", ...)`` terms a model sows: a model with an
    ``aux_losses`` list (``models/llama.py``'s MoE load balance, one scalar
    a MoE block, set by each forward) has ``aux_loss_weight`` times their
    sum added to each micro-batch's loss, which the step differentiates and
    returns. 0, or a model without such terms, leaves the loss as it is.

    The step takes an optional ``mark``, called with ``"forward"``,
    ``"backward"`` and ``"optimizer"`` as each part has been queued (for
    each micro-batch, with accumulation), ``"all_reduce"`` on a mesh of
    several processes, and ``"optimizer"``, as each part has been queued: a
    caller that synchronises the device there splits the step's time by
    part.

    With a ``mesh`` from ``parallel/mesh.py`` whose dp extent is above 1,
    ``inputs`` are this process's rows of the global batch; once per step,
    after the accumulation and before the update (whose clipping reads the
    global norm), the fp32 gradients and the loss are averaged over the
    mesh's group (:func:`all_reduce_mean`), so every process returns the
    global mean loss and applies the same update. Without a mesh, or on a
    world of one, the step is the single-device one.
    """
    accum = max(1, int(grad_accum_steps))
    dp = mesh.dp if mesh is not None and mesh.group is not None else 1
    # Fused-CE contract (models/gpt.py): a model with ce_chunk > 0 computes
    # per-token losses itself when handed targets; loss_fn then receives
    # [B, T] token losses (pair with token_loss_mean), not [B, T, V] logits.
    fused_ce = model.config.ce_chunk > 0

    def grads_of(params, inputs, targets, mark):
        out = model(inputs, targets=targets) if fused_ce else model(inputs)
        loss = loss_fn(out, targets)
        aux = getattr(model, "aux_losses", ())
        if aux and aux_loss_weight:
            loss = loss + aux_loss_weight * sum(a.sum() for a in aux)
        mark("forward")
        grads = torch.autograd.grad(loss, list(params.values()))
        mark("backward")
        return loss.detach(), dict(zip(params, grads))

    def slice_micro(x):
        if x.shape[0] % accum:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by grad_accum_steps {accum}"
            )
        return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))

    def step_fn(state: TrainState, inputs, targets, mark: Callable[[str], None] = _no_mark):
        if accum == 1:
            loss, grads = grads_of(state.params, inputs, targets, mark)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=inputs.device)
            grads = {
                n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in state.params.items()
            }
            for mi, mt in zip(slice_micro(inputs), slice_micro(targets)):
                micro_loss, micro_grads = grads_of(state.params, mi, mt, mark)
                loss += micro_loss
                for n, g in micro_grads.items():
                    grads[n] += g.float()
            loss = loss / accum
            grads = {
                n: (g / accum).to(state.params[n].dtype) for n, g in grads.items()
            }
        if dp > 1:
            grads, loss = all_reduce_mean(grads, loss, mesh.group, dp)
            mark("all_reduce")
        opt_state = tx.update(grads, state.opt_state, state.params)
        mark("optimizer")
        return TrainState(state.step + 1, state.params, opt_state), loss

    return step_fn


def build_eval_step(model, loss_fn) -> Callable:
    """``(params, inputs, targets) -> loss`` without gradients, with the
    same fused-CE contract as :func:`build_train_step`."""
    fused_ce = model.config.ce_chunk > 0

    @torch.no_grad()
    def eval_fn(params, inputs, targets):
        kwargs = {"targets": targets} if fused_ce else {}
        out = torch.func.functional_call(model, params, (inputs,), kwargs)
        return loss_fn(out, targets)

    return eval_fn
