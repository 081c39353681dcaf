"""The port's flash attention (dlrover_tpu_torch/ops/flash_attention.py)
against the JAX package's, on the CPU.

Each plain PyTorch version is held against the JAX internal it mirrors
(``_flash_fwd`` and ``_flash_bwd``, whose Pallas kernels run in interpret
mode here), and the public ``flash_attention`` and its autograd gradients
against JAX's public function and ``jax.grad``. Inputs are made with numpy
from a seed and handed to both. Cases and tolerances follow
tests/test_ops.py: fp32 atol 2e-5 forward and 5e-5 gradients; bf16 atol
3e-2 (bf16 rounds at other points in the two frameworks).

The CUDA kernels cannot run here; chip_smoke.py holds them against these
plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import flash_attention as jfa
from dlrover_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

FWD_ATOL = 2e-5
GRAD_ATOL = 5e-5
BF16_ATOL = 3e-2

# (q_len, kv_len, block_q, block_k). The causal case q_len > kv_len with
# kv_len % block_k != 0 is left out: there the reference's rows that see no
# key average over its zero-padded keys (ROADMAP.md section C), so its value
# depends on the block size and is no attention result to hold a port to.
# Training never takes that path (q_len == kv_len).
LENGTHS = [(32, 32, 16, 16), (40, 40, 16, 16), (8, 24, 8, 8), (40, 56, 16, 16)]


def _arrays(shape_q, shape_kv, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    q = r.standard_normal(shape_q).astype(dtype)
    k = r.standard_normal(shape_kv).astype(dtype)
    v = r.standard_normal(shape_kv).astype(dtype)
    do = r.standard_normal(shape_q).astype(dtype)
    return q, k, v, do


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(jax_value, torch_value, atol):
    np.testing.assert_allclose(
        torch_value.detach().float().numpy(),
        np.asarray(jax_value, dtype=np.float32),
        atol=atol,
        rtol=0,
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t_q,t_kv,block_q,block_k", LENGTHS)
def test_plain_kernels_match_pallas(causal, t_q, t_kv, block_q, block_k):
    """flash_fwd_plain / flash_bwd_dkdv_plain / flash_bwd_dq_plain against
    _flash_fwd and _flash_bwd on the same [BH, T, D] inputs."""
    q, k, v, do = _arrays((4, t_q, 16), (4, t_kv, 16), seed=t_q + t_kv)
    scale = 0.25
    out_j, lse_j = jfa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal, block_q, block_k
    )
    dq_j, dk_j, dv_j = jfa._flash_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out_j, lse_j,
        jnp.asarray(do), scale, causal, block_q, block_k,
    )
    out_t, lse_t = tfa.flash_fwd_plain(
        _t(q), _t(k), _t(v), scale, causal, block_q, block_k
    )
    _close(out_j, out_t, FWD_ATOL)
    _close(lse_j, lse_t, FWD_ATOL)
    # the backward plain versions take the reference's residuals, so each
    # is checked on exactly the inputs the Pallas kernel saw
    delta = tfa.softmax_delta(_t(do), _t(out_j))
    args = (_t(q), _t(k), _t(v), _t(do), _t(lse_j), delta, scale, causal,
            block_q, block_k)
    dk_t, dv_t = tfa.flash_bwd_dkdv_plain(*args)
    dq_t = tfa.flash_bwd_dq_plain(*args)
    _close(dk_j, dk_t, GRAD_ATOL)
    _close(dv_j, dv_t, GRAD_ATOL)
    _close(dq_j, dq_t, GRAD_ATOL)


# The CUDA kernels' own tiles (``kernel_tiles``), at which chip_smoke.py holds
# each kernel against its plain version: two full tiles, and a ragged pair
# whose query and key ends both fall inside 128-row tiles (causal, with the
# end-aligned diagonal crossing tiles off their corners).
KERNEL_TILE_CASES = [("fwd", 64), ("bwd_dkdv", 64), ("bwd_dkdv", 128),
                     ("bwd_dq", 64), ("bwd_dq", 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t_q,t_kv", [(256, 256), (136, 264)])
@pytest.mark.parametrize("kernel,head_dim", KERNEL_TILE_CASES)
def test_plain_versions_match_pallas_at_kernel_tiles(kernel, head_dim, t_q, t_kv, causal):
    """Each plain version at its CUDA kernel's (block_q, block_k) against the
    Pallas kernel at the same blocks (narrow head dim: the tile shape, not the
    width, is what the blocking changes)."""
    block_q, block_k = tfa.kernel_tiles(kernel, head_dim)
    q, k, v, do = _arrays((2, t_q, 16), (2, t_kv, 16), seed=t_q + block_q)
    scale = 0.25
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out_j, lse_j = jfa._flash_fwd(jq, jk, jv, scale, causal, block_q, block_k)
    if kernel == "fwd":
        out_t, lse_t = tfa.flash_fwd_plain(_t(q), _t(k), _t(v), scale, causal, block_q, block_k)
        _close(out_j, out_t, FWD_ATOL)
        _close(lse_j, lse_t, FWD_ATOL)
        return
    dq_j, dk_j, dv_j = jfa._flash_bwd(
        jq, jk, jv, out_j, lse_j, jnp.asarray(do), scale, causal, block_q, block_k
    )
    delta = tfa.softmax_delta(_t(do), _t(out_j))
    args = (_t(q), _t(k), _t(v), _t(do), _t(lse_j), delta, scale, causal, block_q, block_k)
    if kernel == "bwd_dkdv":
        dk_t, dv_t = tfa.flash_bwd_dkdv_plain(*args)
        _close(dk_j, dk_t, GRAD_ATOL)
        _close(dv_j, dv_t, GRAD_ATOL)
    else:
        _close(dq_j, tfa.flash_bwd_dq_plain(*args), GRAD_ATOL)


def test_kernel_tiles_name_every_kernel():
    assert {name for name, _ in KERNEL_TILE_CASES} == set(tfa.launches)
    for name in tfa.launches:
        for head_dim in (64, 128):
            block_q, block_k = tfa.kernel_tiles(name, head_dim)
            assert block_q % 16 == 0 and block_k % 16 == 0
    with pytest.raises(ValueError, match="no flash attention kernel"):
        tfa.kernel_tiles("bwd", 64)


def test_chip_smoke_requires_wgmma_of_every_kernel():
    """chip_smoke.py fails on a kernel whose SASS has no HGMMA or UTMALDG
    only for the kernels it names: every launched kernel must be one."""
    import chip_smoke

    assert set(chip_smoke.WGMMA_KERNELS) == set(tfa.launches)
    assert set(chip_smoke.KERNEL_SYMBOLS) == set(tfa.launches)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [32, 40])
def test_public_forward_and_grads_match_jax(causal, t):
    q, k, v, do = _arrays((2, t, 2, 16), (2, t, 2, 16), seed=t)

    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal, None, 16, 16)
        return jnp.sum(out * jnp.asarray(do))

    out_j = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, 16, 16
    )
    grads_j = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out_t = tfa.flash_attention(qt, kt, vt, causal, None, 16, 16)
    grads_t = torch.autograd.grad(out_t, (qt, kt, vt), _t(do))
    _close(out_j, out_t, FWD_ATOL)
    for gj, gt in zip(grads_j, grads_t):
        _close(gj, gt, GRAD_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_attention(causal):
    """The port against its own einsum oracle, forward and gradients, as
    tests/test_ops.py holds the JAX kernel against reference_attention."""
    q, k, v, do = _arrays((2, 40, 2, 16), (2, 40, 2, 16), seed=7)
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal, None, 16, 16)
    ref = tfa.reference_attention(qt, kt, vt, causal)
    torch.testing.assert_close(out, ref, atol=FWD_ATOL, rtol=0)
    g_fa = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    g_ref = torch.autograd.grad(ref, (qt, kt, vt), _t(do))
    for a, b in zip(g_fa, g_ref):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


def test_reference_attention_matches_jax():
    q, k, v, _ = _arrays((1, 8, 2, 16), (1, 24, 2, 16), seed=5)
    ref_j = jfa.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    ref_t = tfa.reference_attention(_t(q), _t(k), _t(v), True)
    _close(ref_j, ref_t, FWD_ATOL)


def test_bf16_inputs_match_jax():
    q, k, v, do = _arrays((2, 32, 2, 16), (2, 32, 2, 16), seed=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    out_j = jfa.flash_attention(jq, jk, jv, True, None, 16, 16)
    grads_j = jax.grad(
        lambda q, k, v: jnp.sum(
            jfa.flash_attention(q, k, v, True, None, 16, 16).astype(jnp.float32)
            * jnp.asarray(do)
        ),
        argnums=(0, 1, 2),
    )(jq, jk, jv)
    tq, tk, tv = (_t(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    out_t = tfa.flash_attention(tq, tk, tv, True, None, 16, 16)
    grads_t = torch.autograd.grad(out_t, (tq, tk, tv), _t(do).to(torch.bfloat16))
    assert out_t.dtype == torch.bfloat16
    _close(out_j.astype(jnp.float32), out_t, BF16_ATOL)
    for gj, gt in zip(grads_j, grads_t):
        _close(gj.astype(jnp.float32), gt, BF16_ATOL)


def test_cpu_path_launches_no_kernel():
    tfa.reset_launches()
    q, k, v, do = _arrays((1, 40, 2, 16), (1, 40, 2, 16), seed=1)
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, True, None, 16, 16)
    torch.autograd.grad(out, (qt, kt, vt), _t(do))
    assert tfa.launches == {"fwd": 0, "bwd_dkdv": 0, "bwd_dq": 0}


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no forward for device meta"):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize(
    "shape,dtype,match",
    [
        ((1, 16, 2, 64), torch.float32, "take bf16"),
        ((1, 16, 2, 32), torch.bfloat16, "head_dim 64 or 128"),
        ((16, 2, 64), torch.bfloat16, r"\[B, T, H, D\]"),
    ],
)
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(shape, dtype, match):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        tfa._check_kernel_inputs(x, x, x)


def test_delta_layout_is_contiguous_at_batch_one():
    """The kernels read delta as contiguous [B*H, T]; at B=1 a bare reshape
    of the transposed [B, T, H] rowsum would be a strided view."""
    do = torch.randn(1, 5, 3, 8)
    out = torch.randn(1, 5, 3, 8)
    delta = tfa.delta_bh(do, out)
    assert delta.is_contiguous() and delta.shape == (3, 5)
    torch.testing.assert_close(delta[2], (do[0, :, 2] * out[0, :, 2]).sum(-1))
