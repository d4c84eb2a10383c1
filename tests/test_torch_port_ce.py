"""thunder_tpu_torch's fused cross-entropy against the JAX package, on the CPU.

The JAX train step reaches the Pallas CE kernel through the prim's ordinary
implementation (``jaxex._cross_entropy_fwd_impl`` tries ``_ce_fast_path``,
which ``pallasex`` sets to ``flash_cross_entropy``), whenever
``_ce_supported`` holds.  The port's kernel needs no TPU tiling, so its
``ltorch.cross_entropy`` takes the kernel on every 2-D float32 or bf16 input:

- ``cudaex.ce_supported`` admits every (N, V, dtype) of a grid that
  ``pallasex._ce_supported`` admits, and also the shapes its tiling refuses;
- ``flash_cross_entropy_plain`` against ``pallasex._flash_ce`` run
  interpreted, float32 and bf16 logits: loss and lse within 1e-5 relative
  (a float32 sum of exp over the vocabulary in another order);
- the port's ``TrainStep`` routes the loss through the wrapper once per
  micro-batch and declines nothing at the tiny config's shape; a declined
  dtype runs the plain version and counts a decline.

Tests marked ``cuda`` hold the kernel against its plain version on the card.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu_torch as ttt
from thunder_tpu.executors import pallasex
from thunder_tpu_torch import ltorch
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama as tllama

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("N", [0, 7, 8, 24, 256, 384, 2048, 4100])
def test_ce_supported_matches_pallas(N, dtype):
    """Every input the reference's kernel takes, the port's takes; the port's
    also takes the 2-D float32/bf16 shapes the TPU tiling refuses."""
    jd, td = DTYPES[dtype]
    kernel_dtype = dtype in ("float32", "bfloat16")
    for V in (100, 128, 256, 384, 1000, 4224, 32000, 50257, 128256):
        ref = pallasex._ce_supported((N, V), (N,), jd)
        assert cudaex.ce_supported((N, V), (N,), td) is kernel_dtype
        assert ref <= kernel_dtype
    assert cudaex.ce_supported((N, 256, 2), (N,), td) == pallasex._ce_supported(
        (N, 256, 2), (N,), jd) is False
    assert cudaex.ce_supported((N, 0), (N,), td) is pallasex._ce_supported(
        (N, 0), (N,), jd) is False
    assert not cudaex.ce_supported((N, 256), (N + 1,), td)


def _case(N, V, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((N, V)) * 3).astype(np.float32)
    target = rng.integers(0, V, N).astype(np.int32)
    return logits, target


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,V", [(16, 256), (64, 384), (8, 1280), (256, 128)])
def test_ce_plain_matches_pallas(N, V, dtype):
    jd, td = DTYPES[dtype]
    logits, target = _case(N, V, seed=N + V)
    want_loss, want_lse = pallasex._flash_ce(jnp.asarray(logits, jd), jnp.asarray(target))
    loss, lse = cudaex.flash_cross_entropy(torch.as_tensor(logits).to(td),
                                           torch.as_tensor(target))
    assert loss.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(want_lse)).max()))


def test_ce_wrapper_checks_and_counts_nothing_on_the_cpu():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cudaex.flash_cross_entropy(torch.zeros(8, 128, dtype=torch.float16),
                                   torch.zeros(8, dtype=torch.long))
    with pytest.raises(ValueError, match="2-D"):
        cudaex.flash_cross_entropy(torch.zeros(2, 8, 128), torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError, match="target must be integer"):
        cudaex.flash_cross_entropy(torch.zeros(8, 128), torch.zeros(8))
    cudaex.reset_launches()
    cudaex.flash_cross_entropy(torch.zeros(8, 128), torch.zeros(8, dtype=torch.long))
    assert cudaex.LAUNCHES["flash_ce"] == 0


@pytest.fixture
def counting_ce(monkeypatch):
    """Counts the calls ``ltorch`` makes to the CE wrapper."""
    calls = []

    def wrapper(logits, target):
        calls.append(tuple(logits.shape))
        return cudaex.flash_cross_entropy(logits, target)

    monkeypatch.setitem(ltorch.CE, "forward", wrapper)
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    return calls


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_routes_the_loss_through_the_wrapper(counting_ce, accum_steps):
    """One wrapper call per micro-batch at the (B·T, padded vocab) shape,
    no declines; the loss equals the plain CE's."""
    cfg = ttt.Config.from_name("tiny-llama-debug")
    params = ttt.init_params(cfg, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    B, T = 2, 128
    idx = torch.randint(0, cfg.vocab_size, (B, T), generator=gen)
    tgt = torch.randint(0, cfg.vocab_size, (B, T), generator=gen)
    cos, sin = tllama.build_rope_cache(cfg, T)
    with torch.no_grad():
        logits = tllama.gpt_forward(params, idx, cos, sin, cfg)
    want, _ = cudaex.flash_cross_entropy_plain(logits.reshape(-1, cfg.padded_vocab_size),
                                               tgt.reshape(-1))
    step = ttt.make_train_step(lambda p, i, t, c, s: ttt.gpt_loss(p, i, t, c, s, cfg),
                               ttt.adamw(1e-3), accum_steps=accum_steps)
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    _, _, loss = step(params, step.init_optimizer_state(params), idx, tgt, cos, sin)
    rows = B * T // accum_steps
    assert counting_ce == [(rows, cfg.padded_vocab_size)] * accum_steps
    assert ltorch.DECLINES == {"flash_sdpa": 0, "flash_sdpa_backward": 0,
                               "flash_cross_entropy": 0}
    torch.testing.assert_close(loss.detach(), want.mean(), rtol=1e-5, atol=0)


def test_declined_shape_runs_the_plain_version(counting_ce):
    """float16 logits are no input of the kernel: the plain CE runs (in
    float32, the result cast to float16), a decline is counted, and the loss
    and grads equal PyTorch's own on the float32 upcast, cast back."""
    rng = np.random.default_rng(2)
    logits = torch.as_tensor(rng.standard_normal((7, 256)).astype(np.float16),
                             ).requires_grad_()
    target = torch.as_tensor(rng.integers(0, 256, 7))
    loss = ltorch.cross_entropy(logits, target)
    loss.backward()
    assert counting_ce == [] and ltorch.DECLINES["flash_cross_entropy"] == 1
    ref = logits.detach().clone().requires_grad_()
    want = torch.nn.functional.cross_entropy(ref.float(), target).to(torch.float16)
    want.backward()
    torch.testing.assert_close(loss, want)
    torch.testing.assert_close(logits.grad, ref.grad)


@pytest.mark.parametrize("N,V", [(16, 384), (7, 256), (5, 1001)])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_through_the_wrapper_matches_torch(counting_ce, reduction, N, V):
    """Shapes the reference's TPU tiling takes (16, 384) and refuses (N = 7
    fits no row block, V = 1001 has no ×128 divisor) all take the wrapper."""
    rng = np.random.default_rng(3)
    logits = torch.as_tensor(rng.standard_normal((N, V)).astype(np.float32)).requires_grad_()
    target = torch.as_tensor(rng.integers(0, V, N))
    target[3] = -100
    got = ltorch.cross_entropy(logits, target, reduction=reduction)
    (got.sum() if reduction == "none" else got).backward()
    assert counting_ce == [(N, V)] and ltorch.DECLINES["flash_cross_entropy"] == 0
    ref = logits.detach().clone().requires_grad_()
    want = torch.nn.functional.cross_entropy(ref, target, reduction=reduction)
    (want.sum() if reduction == "none" else want).backward()
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(logits.grad, ref.grad)


#
# on the card
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,V", [(256, 128256), (24, 1000), (8, 1001), (64, 32000)])
def test_cuda_ce_matches_plain(card, N, V, dtype):
    """Loss and lse within 1e-5 relative of the plain version (float32 sums
    in another order), both vector widths and the scalar walk; one launch."""
    gen = torch.Generator(card).manual_seed(N + V)
    logits = (torch.randn((N, V), generator=gen, device=card) * 3).to(dtype)
    target = torch.randint(0, V, (N,), generator=gen, device=card)
    target[0], target[-1] = 0, V - 1
    cudaex.reset_launches()
    loss, lse = cudaex.flash_cross_entropy(logits, target)
    torch.cuda.synchronize()
    assert cudaex.LAUNCHES["flash_ce"] == 1
    want_loss, want_lse = cudaex.flash_cross_entropy_plain(logits, target)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=0)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5,
                               atol=1e-5 * float(want_lse.abs().max()))


@pytest.mark.cuda
def test_cuda_train_step_launches_ce_once_per_micro_batch(card):
    cfg = ttt.Config.from_name("tiny-llama-debug")
    params = ttt.init_params(cfg, generator=torch.Generator(card).manual_seed(0),
                             dtype=torch.float32, device=card)
    gen = torch.Generator(card).manual_seed(1)
    idx = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device=card)
    tgt = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device=card)
    cos, sin = tllama.build_rope_cache(cfg, 128, device=card)
    step = ttt.make_train_step(lambda p, i, t, c, s: ttt.gpt_loss(p, i, t, c, s, cfg),
                               ttt.adamw(1e-3), accum_steps=2)
    opt_state = step.init_optimizer_state(params)
    cudaex.reset_launches()
    step(params, opt_state, idx, tgt, cos, sin)
    torch.cuda.synchronize()
    assert cudaex.LAUNCHES["flash_ce"] == 2
