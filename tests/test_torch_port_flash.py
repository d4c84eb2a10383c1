"""thunder_tpu_torch's flash attention and ``ltorch`` ops against the JAX package.

On the CPU the flash wrappers run their plain PyTorch versions, which these
tests hold against ``thunder_tpu.executors.pallasex.flash_sdpa`` /
``flash_sdpa_backward`` run interpreted (``THUNDER_TPU_PALLAS_INTERPRET=1``,
as ``tests/test_pallas.py`` runs them) and against
``jaxex._sdpa_reference`` / ``_sdpa_backward_reference``, on the same
numpy-made inputs.  float32: within 1e-5 of each output's largest magnitude
(the same arithmetic in other summation orders).  bf16: both sides round
where the Pallas kernels round, but over other key tiles (64 keys against
128), so they are held against the float32 result: the port's error at most
1.5× the Pallas kernel's own plus 1e-3 of the output's scale.  Tests marked
``cuda`` hold the CUDA kernels against the plain versions on the card and
skip without one.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.executors import jaxex, pallasex
from thunder_tpu_torch import ltorch
from thunder_tpu_torch.executors import cudaex
from torch_port_threads import one_torch_thread  # noqa: F401

NEG = -0.7 * float(np.finfo(np.float32).max)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_PALLAS_INTERPRET", "1")


def _mask(kind, B, H, Tq, Tk, rng):
    """An additive mask in one ``_canon_mask`` layout (mq 1 or Tq)."""
    if kind is None:
        return None
    layout, mq = kind.split("-")
    mq = 1 if mq == "1" else Tq
    shape = {"shared": (mq, Tk), "batch": (B, 1, mq, Tk), "head": (1, H, mq, Tk),
             "full": (B, H, mq, Tk)}[layout]
    bias = rng.standard_normal(shape).astype(np.float32)
    return np.where(rng.random(shape) < 0.25, NEG, bias).astype(np.float32)


def _inputs(B, H, G, Tq, Tk, hs, mask=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, hs)).astype(np.float32)
    k = rng.standard_normal((B, G, Tk, hs)).astype(np.float32)
    v = rng.standard_normal((B, G, Tk, hs)).astype(np.float32)
    g = rng.standard_normal((B, H, Tq, hs)).astype(np.float32)
    return q, k, v, g, _mask(mask, B, H, Tq, Tk, rng)


def _jax(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dtype)


def _torch(x, dtype=torch.float32):
    return None if x is None else torch.as_tensor(x).to(dtype)


def _port(q, k, v, g, mask, causal, scale, window, dtype=torch.float32):
    t = [_torch(x, dtype) for x in (q, k, v, g)]
    m = _torch(mask)
    out, lse = cudaex.flash_sdpa(*t[:3], m, causal=causal, scale=scale, window=window)
    grads = cudaex.flash_sdpa_backward(t[3], *t[:3], out, lse, m, causal=causal, scale=scale,
                                       window=window)
    return [x.float().numpy() for x in (out, lse, *grads)]


def _pallas(q, k, v, g, mask, causal, scale, window, dtype=jnp.float32):
    j = [_jax(x, dtype) for x in (q, k, v, g)]
    m = _jax(mask)
    out, lse = pallasex.flash_sdpa(*j[:3], m, causal, scale, window)
    grads = pallasex.flash_sdpa_backward(j[3], *j[:3], out, lse, m, causal, scale, window)
    return [np.asarray(x).astype(np.float32) for x in (out, lse, *grads)]


def _reference(q, k, v, g, mask, causal, scale, window):
    j = [_jax(x) for x in (q, k, v, g)]
    m = _jax(mask)
    out, lse = jaxex._sdpa_reference(*j[:3], m, causal, scale, window)
    grads = jaxex._sdpa_backward_reference(j[3], *j[:3], out, lse, m, causal, scale, window)
    return [np.asarray(x) for x in (out, lse, *grads)]


def _close_f32(got, want, names=("out", "lse", "dq", "dk", "dv")):
    for name, a, b in zip(names, got, want):
        bar = 1e-5 * max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= bar, (name, float(np.abs(a - b).max()), bar)


# (B, H, G, Tq, Tk, hs, causal, window, mask): GQA rep 1, 2, 4; a window;
# Tq != Tk (top-left causal); hs 16, 64, 128; mask layouts
PALLAS_CASES = [
    pytest.param(1, 4, 4, 128, 128, 64, True, None, None, id="mha-causal"),
    pytest.param(2, 4, 2, 128, 128, 16, True, None, None, id="gqa2-causal-hs16"),
    pytest.param(1, 8, 2, 128, 256, 64, True, None, None, id="gqa4-causal-tq-ne-tk"),
    pytest.param(1, 4, 2, 256, 256, 64, True, 96, None, id="gqa2-window"),
    pytest.param(2, 2, 2, 128, 128, 128, False, None, "batch-1", id="noncausal-batch-mask"),
    pytest.param(1, 4, 1, 128, 128, 16, False, None, "full-T", id="mqa-full-mask"),
]


@pytest.mark.parametrize("B,H,G,Tq,Tk,hs,causal,window,mask", PALLAS_CASES)
def test_flash_plain_matches_pallas_f32(interpret, B, H, G, Tq, Tk, hs, causal, window, mask):
    x = _inputs(B, H, G, Tq, Tk, hs, mask)
    scale = 1.0 / np.sqrt(hs)
    _close_f32(_port(*x, causal, scale, window), _pallas(*x, causal, scale, window))


@pytest.mark.parametrize("B,H,G,Tq,Tk,hs,causal,window,mask", [
    pytest.param(1, 4, 2, 128, 128, 64, True, None, None, id="gqa2-causal"),
    pytest.param(1, 4, 4, 128, 256, 16, False, None, "head-T", id="head-mask-tq-ne-tk"),
])
def test_flash_plain_matches_pallas_bf16(interpret, B, H, G, Tq, Tk, hs, causal, window, mask):
    """bf16 (round the inputs first, so both sides see the same values):
    each side's error against the float32 result of those inputs; the
    port's at most 1.5× the Pallas kernel's own plus 1e-3 of the scale."""
    *qkvg, m = _inputs(B, H, G, Tq, Tk, hs, mask)
    x = (*(np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) for a in qkvg), m)
    scale = 1.0 / np.sqrt(hs)
    ref = _pallas(*x, causal, scale, window)
    got = _port(*x, causal, scale, window, dtype=torch.bfloat16)
    want = _pallas(*x, causal, scale, window, dtype=jnp.bfloat16)
    for name, a, b, r in zip(("out", "lse", "dq", "dk", "dv"), got, want, ref):
        err_port, err_pallas = np.abs(a - r).max(), np.abs(b - r).max()
        assert err_port <= 1.5 * err_pallas + 1e-3 * np.abs(r).max(), (name, err_port, err_pallas)


@pytest.mark.parametrize("mask", ["shared-1", "shared-T", "batch-1", "batch-T", "head-1",
                                  "head-T", "full-1", "full-T"])
def test_flash_plain_matches_reference_mask_layouts(mask):
    x = _inputs(2, 4, 2, 128, 128, 32, mask, seed=1)
    scale = 0.3
    _close_f32(_port(*x, False, scale, None), _reference(*x, False, scale, None))


@pytest.mark.parametrize("H,G,hs,causal,window,Tq,Tk", [
    (4, 4, 128, True, None, 128, 128), (4, 2, 64, True, 17, 256, 256),
    (8, 2, 16, False, None, 128, 256), (8, 2, 64, True, None, 256, 128)])
def test_flash_plain_matches_reference(H, G, hs, causal, window, Tq, Tk):
    x = _inputs(1, H, G, Tq, Tk, hs, seed=2)
    scale = 1.0 / np.sqrt(hs)
    _close_f32(_port(*x, causal, scale, window), _reference(*x, causal, scale, window))


def test_fully_masked_row_averages_like_the_pallas_kernel(interpret):
    """A row an additive mask masks whole: the kernels' finite mask value
    averages V uniformly (the reference, with -inf, gives NaN), so this is
    held against the Pallas kernel run interpreted."""
    q, k, v, g, _ = _inputs(1, 2, 2, 128, 128, 32, seed=3)
    mask = np.zeros((1, 1, 128, 128), np.float32)
    mask[..., 5, :] = NEG
    got = _port(q, k, v, g, mask, False, 0.2, None)
    _close_f32(got, _pallas(q, k, v, g, mask, False, 0.2, None))
    np.testing.assert_allclose(got[0][0, :, 5], v[0].mean(axis=1), atol=1e-5)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 100, 64)
    k = torch.zeros(1, 2, 100, 64)
    with pytest.raises(ValueError, match="do not take"):
        cudaex.flash_sdpa(q, k, k, causal=True, scale=1.0)
    q, k = torch.zeros(1, 4, 128, 64), torch.zeros(1, 3, 128, 64)
    with pytest.raises(ValueError, match="do not take"):
        cudaex.flash_sdpa(q, k, k, causal=True, scale=1.0)
    k = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="do not take"):
        cudaex.flash_sdpa(q.half(), k.half(), k.half(), causal=True, scale=1.0)
    with pytest.raises(ValueError, match="do not take"):
        cudaex.flash_sdpa(q, k, k, causal=False, scale=1.0, window=8)
    with pytest.raises(ValueError, match="do not take"):
        cudaex.flash_sdpa(q, k, k, torch.zeros(3, 1, 128), causal=False, scale=1.0)
    out, lse = cudaex.flash_sdpa(q, k, k, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="lse must be float32"):
        cudaex.flash_sdpa_backward(q, q, k, k, out, lse[..., :64], causal=True, scale=1.0)


@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype,hs,aligned,want", [
    (torch.bfloat16, 64, True, "wgmma"), (torch.bfloat16, 128, True, "wgmma"),
    (torch.bfloat16, 128, False, "scalar"), (torch.bfloat16, 16, True, "wmma"),
    (torch.bfloat16, 80, True, "wmma"), (torch.bfloat16, 256, True, "wmma"),
    (torch.bfloat16, 512, True, "wmma"), (torch.bfloat16, 72, True, "scalar"),
    (torch.float32, 64, True, "scalar"), (torch.float32, 128, True, "scalar"),
    (torch.float32, 512, True, "scalar")])
def test_flash_body_choice(kind, dtype, hs, aligned, want):
    """The body each (dtype, hs, alignment) gets on the card, and that its
    tiles' shared memory fits a Hopper block (232,448 B); the warpgroup
    body's tiles are the 64 x 64 ones the plain forward walks."""
    t = torch.zeros(64, dtype=dtype)
    body, R, KT = cudaex.flash_body(kind, hs, dtype, (t if aligned else t[1:],))
    assert body == want
    assert cudaex._flash_smem(kind, R, KT, hs, t.element_size(), body) <= 232448
    if body == "wgmma":
        assert (R, KT) == (64, 64)
    # the plain versions (no tensors) take the aligned body's tiles
    assert cudaex.flash_body(kind, hs, dtype)[1:] == cudaex.flash_body(kind, hs, dtype, (t,))[1:]


def test_dkv_splits():
    """The warpgroup dk/dv kernel shares a group's q heads between two
    blocks when their count is even; the other bodies never split."""
    assert cudaex.dkv_splits(32, 8, "wgmma") == 2
    assert cudaex.dkv_splits(6, 2, "wgmma") == 1
    assert cudaex.dkv_splits(4, 4, "wgmma") == 1
    assert cudaex.dkv_splits(32, 8, "wmma") == 1


def test_cpu_calls_launch_nothing():
    cudaex.reset_launches()
    x = [torch.zeros(1, 2, 128, 16) for _ in range(3)]
    out, lse = cudaex.flash_sdpa(*x, causal=True, scale=1.0)
    cudaex.flash_sdpa_backward(out, *x, out, lse, causal=True, scale=1.0)
    assert set(cudaex.LAUNCHES.values()) == {0}


#
# ltorch: the autograd function, its dispatch and cross-entropy
#


def _plain_flash(monkeypatch):
    """Let float64 through the flash path (the plain versions accumulate in
    float64 then), so gradcheck sees the flash backward's formulas."""
    real = cudaex.flash_supported

    def supported(q_shape, k_shape, v_shape, dtype, *a, **kw):
        return real(q_shape, k_shape, v_shape, torch.float32 if dtype == torch.float64 else dtype,
                    *a, **kw)

    monkeypatch.setattr(cudaex, "flash_supported", supported)
    monkeypatch.setitem(ltorch.FLASH, "forward", cudaex.flash_sdpa_plain)
    monkeypatch.setitem(ltorch.FLASH, "backward", cudaex.flash_sdpa_backward_plain)


@pytest.mark.parametrize("path", ["flash", "reference"])
@pytest.mark.parametrize("H,G,causal,window,with_lse", [
    (2, 1, True, None, False), (2, 2, True, None, True), (2, 2, False, None, True),
    (4, 2, True, 50, False)])
def test_sdpa_gradcheck(monkeypatch, path, H, G, causal, window, with_lse):
    """float64 gradcheck of the SDPA function through the flash formulas
    (the plain versions) and through the reference decomposition; with_lse
    also differentiates lse (the O(T²) term of the JAX rule)."""
    if path == "flash":
        _plain_flash(monkeypatch)
    rng = np.random.default_rng(4)
    T, hs = 128, 4
    q = torch.tensor(rng.standard_normal((1, H, T, hs)) * 0.5, requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, G, T, hs)) * 0.5, requires_grad=True)
    v = torch.tensor(rng.standard_normal((1, G, T, hs)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((1, H, T)))

    def fn(q, k, v):
        out, lse = ltorch._SDPA.apply(q, k, v, None, causal, 0.7, window)
        return (out, (lse * w).sum()) if with_lse else out

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-6, rtol=1e-4, fast_mode=True)


def test_sdpa_dispatch_counts_declines():
    """Shapes the kernels decline (T not a multiple of 128, f16) take the
    reference decomposition and count a decline each way; admitted shapes
    count nothing."""
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    q = torch.randn(1, 4, 100, 16, requires_grad=True)
    k = torch.randn(1, 2, 100, 16, requires_grad=True)
    out = ltorch.scaled_dot_product_attention(q, k, k, is_causal=True)
    out.sum().backward()
    assert ltorch.DECLINES == {"flash_sdpa": 1, "flash_sdpa_backward": 1,
                               "flash_cross_entropy": 0}
    want, _ = ltorch.sdpa_reference(q, k, k, None, True, 0.25)
    torch.testing.assert_close(out, want)
    q = torch.randn(1, 4, 128, 16, requires_grad=True)
    k = torch.randn(1, 2, 128, 16, requires_grad=True)
    ltorch.scaled_dot_product_attention(q, k, k, is_causal=True).sum().backward()
    assert ltorch.DECLINES == {"flash_sdpa": 1, "flash_sdpa_backward": 1,
                               "flash_cross_entropy": 0}
    ltorch.scaled_dot_product_attention(q.half(), k.half(), k.half(), is_causal=True)
    assert ltorch.DECLINES["flash_sdpa"] == 2


def test_sdpa_bool_mask_and_lse_limits():
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.standard_normal((2, 2, 128, 8)), dtype=torch.float32)
    keep = torch.tensor(rng.random((2, 1, 1, 128)) < 0.8)
    got = ltorch.scaled_dot_product_attention(q, q, q, attn_mask=keep)
    want = cudaex.flash_sdpa_plain(q, q, q, torch.where(keep, 0.0, NEG), causal=False,
                                   scale=8 ** -0.5)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # differentiating lse: the JAX rule's limits
    k = torch.randn(1, 1, 128, 8, requires_grad=True)
    qq = torch.randn(1, 2, 128, 8, requires_grad=True)
    _, lse = ltorch._SDPA.apply(qq, k, k, None, True, 0.5, None)
    with pytest.raises(NotImplementedError, match="grouped-query"):
        lse.sum().backward()
    q2 = torch.randn(1, 2, 128, 8, requires_grad=True)
    _, lse = ltorch._SDPA.apply(q2, q2, q2, None, True, 0.5, 16)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        lse.sum().backward()


def test_sdpa_decomposition_path_matches_torch():
    """Dropout-free calls whose mask needs grad take the explicit
    decomposition, as in the JAX package."""
    q = torch.randn(1, 2, 8, 4)
    mask = torch.randn(1, 1, 8, 8, requires_grad=True)
    got = ltorch.scaled_dot_product_attention(q, q, q, attn_mask=mask)
    want = torch.softmax(q @ q.transpose(-2, -1) / 2 + mask, dim=-1) @ q
    torch.testing.assert_close(got, want)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_the_jax_prim(reduction):
    """Row losses and lse against ``jaxex._cross_entropy_fwd_reference``;
    the reduction with ignore_index=-100 rows left out exactly; dlogits
    against autograd of the decomposition (float64); label smoothing
    against torch's."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((12, 40)).astype(np.float32)
    target = rng.integers(0, 40, 12)
    target[[2, 7]] = -100
    safe = np.where(target == -100, 0, target)
    want_rows, want_lse = jaxex._cross_entropy_fwd_reference(jnp.asarray(logits),
                                                              jnp.asarray(safe))
    rows, lse = ltorch._CrossEntropy.apply(torch.as_tensor(logits), torch.as_tensor(safe))
    np.testing.assert_allclose(rows.numpy(), np.asarray(want_rows), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-6)
    lg = torch.tensor(logits, dtype=torch.float64, requires_grad=True)
    got = ltorch.cross_entropy(lg, torch.as_tensor(target), reduction=reduction)
    want = torch.nn.functional.cross_entropy(lg, torch.as_tensor(target), reduction=reduction)
    torch.testing.assert_close(got, want)
    (g1,) = torch.autograd.grad(got.sum(), lg)
    (g2,) = torch.autograd.grad(want.sum(), lg)
    torch.testing.assert_close(g1, g2)
    # label smoothing takes the reference's decomposition (it raised before
    # the decomposed cases were ported): torch's values and grads
    got = ltorch.cross_entropy(lg, torch.as_tensor(target), reduction=reduction,
                               label_smoothing=0.1)
    want = torch.nn.functional.cross_entropy(lg, torch.as_tensor(target), reduction=reduction,
                                             label_smoothing=0.1)
    torch.testing.assert_close(got, want)
    (g1,) = torch.autograd.grad(got.sum(), lg)
    (g2,) = torch.autograd.grad(want.sum(), lg)
    torch.testing.assert_close(g1, g2)


#
# on the card (skipped here)
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(B, H, G, Tq, Tk, hs, mask, dtype, card, seed=7):
    q, k, v, g, m = _inputs(B, H, G, Tq, Tk, hs, mask, seed=seed)
    t = [torch.as_tensor(a, device=card).to(dtype) for a in (q, k, v, g)]
    return t, None if m is None else torch.as_tensor(m, device=card)


def _check_card_case(dtype, B, H, G, Tq, Tk, hs, causal, window, mask, card):
    """float32 within 1e-5 of each output's largest magnitude; bf16 held
    against the float32 plain result of the same inputs: the kernels' error
    at most twice the plain version's own; the kernels bitwise repeatable."""
    (q, k, v, g), m = _card_case(B, H, G, Tq, Tk, hs, mask, dtype, card)
    kw = dict(causal=causal, scale=hs ** -0.5, window=window)
    out, lse = cudaex.flash_sdpa(q, k, v, m, **kw)
    grads = cudaex.flash_sdpa_backward(g, q, k, v, out, lse, m, **kw)
    torch.cuda.synchronize()
    got = (out, lse, *grads)
    again = cudaex.flash_sdpa(q, k, v, m, **kw)
    again = (*again, *cudaex.flash_sdpa_backward(g, q, k, v, out, lse, m, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    pout, plse = cudaex.flash_sdpa_plain(q, k, v, m, **kw)
    want = (pout, plse, *cudaex.flash_sdpa_backward_plain(g, q, k, v, out, lse, m, **kw))
    if dtype == torch.float32:
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())
        return
    f = [x.float() for x in (q, k, v, g)]
    rout, rlse = cudaex.flash_sdpa_plain(*f[:3], m, **kw)
    ref = (rout, rlse, *cudaex.flash_sdpa_backward_plain(f[3], *f[:3], rout, rlse, m, **kw))
    for a, b, r in zip(got, want, ref):
        err_kernel = (a.float() - r).abs().max().item()
        err_plain = (b.float() - r).abs().max().item()
        floor = 1e-5 * r.abs().max().item()    # lse: both sides at f32 rounding
        assert torch.isfinite(a).all() and err_kernel <= 2 * err_plain + floor, (err_kernel,
                                                                                err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,G,Tq,Tk,hs,causal,window,mask", [
    (1, 32, 8, 2048, 2048, 128, True, None, None), (2, 4, 4, 256, 256, 64, False, None, None),
    (1, 8, 2, 256, 256, 64, True, 100, None), (1, 8, 2, 128, 256, 64, True, None, None),
    (1, 8, 2, 256, 128, 128, True, None, None), (1, 4, 2, 384, 384, 128, True, 200, None),
    (1, 6, 2, 256, 256, 64, True, None, None), (2, 4, 2, 128, 128, 64, False, None, "shared-1"),
    (2, 4, 2, 128, 128, 64, False, None, "shared-T"),
    (2, 4, 2, 128, 128, 64, False, None, "batch-1"), (2, 4, 2, 128, 128, 64, False, None, "batch-T"),
    (2, 4, 2, 128, 128, 128, False, None, "head-1"), (2, 4, 2, 128, 128, 64, False, None, "head-T"),
    (2, 4, 2, 128, 128, 64, True, None, "full-1"), (2, 4, 2, 128, 128, 128, True, None, "full-T")])
def test_cuda_flash_warpgroup_body_matches_plain(card, B, H, G, Tq, Tk, hs, causal, window, mask):
    """The warpgroup body (bf16, hs 64/128) at the training shape and at
    small shapes: non-causal, windows, Tq != Tk both ways, every mask
    layout, GQA with an odd and an even number of heads per group (split
    and unsplit dk/dv)."""
    assert cudaex.flash_body("fwd", hs, torch.bfloat16)[0] == "wgmma"
    _check_card_case(torch.bfloat16, B, H, G, Tq, Tk, hs, causal, window, mask, card)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,G,Tq,Tk,hs,causal,window,mask", [
    (1, 32, 8, 256, 256, 128, True, None, None), (2, 4, 4, 128, 128, 64, False, None, None),
    (1, 8, 2, 128, 256, 64, True, None, None), (1, 4, 2, 256, 256, 256, True, 100, None),
    (2, 4, 2, 128, 128, 64, False, None, "batch-1"), (1, 4, 1, 128, 128, 16, False, None, "full-T"),
    (1, 2, 2, 128, 128, 512, True, None, None), (2, 4, 2, 128, 128, 72, True, None, "head-T")])
def test_cuda_flash_kernels_match_plain(card, dtype, B, H, G, Tq, Tk, hs, causal, window, mask):
    """float32 within 1e-5 of each output's largest magnitude; bf16 held
    against the float32 plain result of the same inputs: the kernels' error
    at most twice the plain version's own; the kernels bitwise repeatable."""
    _check_card_case(dtype, B, H, G, Tq, Tk, hs, causal, window, mask, card)
