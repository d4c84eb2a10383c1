"""The eager ``ltorch`` ops of the training slice: attention and cross-entropy.

Counterpart of the two ``thunder_tpu.torch`` symbols a Llama training step
runs (``thunder_tpu/torch/__init__.py``: ``scaled_dot_product_attention``
:1061, ``cross_entropy`` :1164), of the prims they reach
(``thunder_tpu/executors/jaxex.py`` :518-607: ``_sdpa_impl``,
``_sdpa_reference``, ``_sdpa_backward_reference``,
``_cross_entropy_fwd_reference``) and of those prims' backward rules
(``thunder_tpu/core/transforms.py`` :652 SDPA, :699 CROSS_ENTROPY_FWD,
:720 FUSED_LINEAR_CE).

The traced path (``jit``, the train step) differentiates the trace with the
port's own rule table (``core/transforms.py``); this module serves eager
PyTorch autograd (the train step's eager twin, the serving forward), so
each prim with a backward rule is a ``torch.autograd.Function``:

- :class:`_SDPA` saves ``(q, k, v, out, lse)`` — never the (Tq, Tk)
  probabilities.  Its dispatch mirrors ``_sdpa_impl``: a shape
  :func:`~thunder_tpu_torch.executors.cudaex.flash_supported` admits runs
  the flash kernels (on a CUDA tensor they launch; on a CPU tensor their
  plain versions run), a shape it declines runs the reference decomposition
  and counts one decline in :data:`DECLINES`.  A kernel that fails raises;
  nothing falls back.  Under a selective checkpoint policy the function is
  opaque (a ``ctypes`` call inside), so its forward reruns in the recompute.
- :class:`_CrossEntropy` saves ``(logits, target, lse)`` and recomputes
  dlogits from them: no (N, C) log-probability residual.  Its forward
  mirrors ``_cross_entropy_fwd_impl`` (``jaxex.py:601``), which tries the
  Pallas CE kernel first: input the kernel takes
  (:func:`~thunder_tpu_torch.executors.cudaex.ce_supported`: 2-D float32 or
  bfloat16 logits of any shape) runs ``flash_cross_entropy`` (one launch
  per call), other dtypes run the plain version and count a decline.  The backward is the prim's rule
  in PyTorch, as the JAX package has no CE backward kernel.

This module is the eager half of the split with the torch language
(``thunder_tpu_torch/torch/__init__.py``, the traced ``ltorch`` surface):
the train step's eager twin, the serving forward and ``chip_smoke.py`` call
these functions on tensors, and handed proxies (``models/llama.py`` under
``jit`` and the train step) :func:`scaled_dot_product_attention`,
:func:`cross_entropy` and :func:`fused_linear_cross_entropy` bind the torch
language's symbols instead, which reach the ``SDPA``, ``CROSS_ENTROPY_FWD``
and ``FUSED_LINEAR_CE`` prims.  ``cross_entropy``'s decomposed cases (class
weights, label smoothing, ``(N, C, d1, ...)`` logits) follow the
reference's formulas (``thunder_tpu/torch/__init__.py:1133-1221``) under
autograd; only the fast path goes through :class:`_CrossEntropy`.
:func:`topk` is the MoE router's selection with ``lax.top_k``'s order of
ties, on tensors and proxies alike.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.executors import cudaex

__all__ = ["CE", "DECLINES", "FLASH", "cross_entropy", "fused_linear_cross_entropy",
           "scaled_dot_product_attention", "sdpa_backward_reference", "sdpa_reference", "topk"]

# shapes the kernels declined (the reference decomposition ran instead)
DECLINES = {"flash_sdpa": 0, "flash_sdpa_backward": 0, "flash_cross_entropy": 0}
# the kernel wrappers the attention and cross-entropy functions call; a check
# may swap in the plain versions to run the same step through them on the card
FLASH = {"forward": cudaex.flash_sdpa, "backward": cudaex.flash_sdpa_backward}
CE = {"forward": cudaex.flash_cross_entropy}

_NEG_F32_MAX = -0.7 * 3.4028235e38   # additive form of a False boolean mask


def _gqa_expand(q, k, v):
    """K/V repeated to q's head count (``_gqa_expand``, ``jaxex.py:518``)."""
    if q.shape[:-2] == k.shape[:-2]:
        return k, v, 1
    rep = q.shape[-3] // k.shape[-3]
    return k.repeat_interleave(rep, dim=-3), v.repeat_interleave(rep, dim=-3), rep


def sdpa_reference(q, k, v, mask, causal, scale, window=None):
    """The decomposed SDPA prim (``_sdpa_reference``, ``jaxex.py:538``):
    f32 scores, ``-inf`` outside the causal band, ``lse`` f32."""
    k, v, _ = _gqa_expand(q, k, v)
    ft = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(ft), k.to(ft).transpose(-2, -1)) * scale
    if mask is not None:
        s = s + mask.to(ft)
    if causal:
        keep = cudaex.causal_keep(q.shape[-2], k.shape[-2], window, q.device)
        s = torch.where(keep, s, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.matmul(p.to(v.dtype), v)
    return out.to(q.dtype), lse


def sdpa_backward_reference(g, q, k, v, out, lse, mask, causal, scale, window=None):
    """The decomposed SDPA backward prim (``_sdpa_backward_reference``,
    ``jaxex.py:561``)."""
    kx, vx, rep = _gqa_expand(q, k, v)
    ft = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(ft), kx.to(ft).transpose(-2, -1)) * scale
    if mask is not None:
        s = s + mask.to(ft)
    if causal:
        keep = cudaex.causal_keep(q.shape[-2], kx.shape[-2], window, q.device)
        s = torch.where(keep, s, -math.inf)
    p = torch.exp(s - lse[..., None])
    gf = g.to(ft)
    dv = torch.matmul(p.transpose(-2, -1), gf)
    dp = torch.matmul(gf, vx.to(ft).transpose(-2, -1))
    delta = (gf * out.to(ft)).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kx.to(ft))
    dk = torch.matmul(ds.transpose(-2, -1), q.to(ft))
    if rep > 1:   # sum the expanded heads' grads back onto the shared KV groups
        G = k.shape[-3]
        dk = dk.reshape(*dk.shape[:-3], G, rep, *dk.shape[-2:]).sum(dim=-3)
        dv = dv.reshape(*dv.shape[:-3], G, rep, *dv.shape[-2:]).sum(dim=-3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _SDPA(torch.autograd.Function):
    """The SDPA prim with its backward rule: ``(out, lse)`` from
    ``(q, k, v, mask)``."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale, window):
        kernels = cudaex.flash_supported(tuple(q.shape), tuple(k.shape), tuple(v.shape), q.dtype,
                                         causal, None if mask is None else tuple(mask.shape),
                                         window)
        if kernels:
            out, lse = FLASH["forward"](q, k, v, mask, causal=causal, scale=scale, window=window)
        else:
            DECLINES["flash_sdpa"] += 1
            out, lse = sdpa_reference(q, k, v, mask, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse, mask)
        ctx.meta = (causal, scale, window, kernels)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, mask = ctx.saved_tensors
        causal, scale, window, kernels = ctx.meta
        if g_out is None:
            g_out = torch.zeros_like(out)
        if kernels:
            dq, dk, dv = FLASH["backward"](g_out, q, k, v, out, lse, mask, causal=causal,
                                           scale=scale, window=window)
        else:
            DECLINES["flash_sdpa_backward"] += 1
            dq, dk, dv = sdpa_backward_reference(g_out, q, k, v, out, lse, mask, causal, scale,
                                                 window)
        if g_lse is not None:
            # lse's own contribution through the decomposed probabilities:
            # O(T²), paid only when something differentiates lse
            if window is not None:
                raise NotImplementedError("differentiating through sdpa's lse output with "
                                          "sliding_window is not supported")
            if q.shape[:-2] != k.shape[:-2]:
                raise NotImplementedError(
                    "differentiating through sdpa's lse output with grouped-query K/V is not "
                    "supported; expand K/V to the query head count first")
            s = torch.matmul(q, k.transpose(-2, -1)) * scale
            if mask is not None:
                s = s + mask
            if causal:
                keep = cudaex.causal_keep(q.shape[-2], k.shape[-2], None, q.device)
                s = torch.where(keep, s, -math.inf)
            p = torch.exp(s - lse[..., None]).to(q.dtype)
            gp = p * g_lse.to(q.dtype)[..., None]
            dq = dq + torch.matmul(gp, k) * scale
            dk = dk + torch.matmul(gp.transpose(-2, -1), q) * scale
        return dq, dk, dv, None, None, None, None


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, scale=None, enable_gqa=False,
                                 sliding_window=None):
    """``torch.nn.functional.scaled_dot_product_attention`` with the JAX
    package's semantics: default scale ``1/sqrt(hs)``, native GQA (fewer K/V
    heads than q heads), ``sliding_window`` (causal), boolean masks turned
    into an additive ``-0.7·f32max`` bias, causal top-left when Tq ≠ Tk.
    Without dropout and with a mask that needs no grad this is the SDPA prim
    (:class:`_SDPA`); otherwise the explicit decomposition.  Handed proxies
    (under ``jit``) it binds the torch language's symbol."""
    if isinstance(query, TensorProxy):
        from thunder_tpu_torch import torch as torch_lang

        return torch_lang.scaled_dot_product_attention(
            query, key, value, attn_mask, dropout_p, is_causal, scale, enable_gqa,
            sliding_window=sliding_window)
    d = query.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if is_causal and attn_mask is not None:
        raise ValueError("is_causal and attn_mask are mutually exclusive")
    gqa_ok = query.shape[:-2] == key.shape[:-2] == value.shape[:-2] or (
        query.ndim >= 3 and key.ndim >= 3 and key.shape[:-2] == value.shape[:-2]
        and query.shape[:-3] == key.shape[:-3] and key.shape[-3] != 0
        and query.shape[-3] % key.shape[-3] == 0)
    mask_ok = attn_mask is None or not attn_mask.requires_grad
    if dropout_p == 0.0 and gqa_ok and mask_ok:
        mask = attn_mask
        if mask is not None and mask.dtype == torch.bool:
            mask = torch.where(mask, 0.0, _NEG_F32_MAX).to(torch.float32)
        elif mask is not None:
            mask = mask.float()
        out, _lse = _SDPA.apply(query, key, value, mask, bool(is_causal), float(scale),
                                None if sliding_window is None else int(sliding_window))
        return out
    if sliding_window is not None:
        raise ValueError("sliding_window is only supported on the fused sdpa path "
                         "(no dropout, mask without requires_grad)")
    if enable_gqa and query.shape[-3] != key.shape[-3]:
        rep = query.shape[-3] // key.shape[-3]
        key = key.repeat_interleave(rep, dim=-3)
        value = value.repeat_interleave(rep, dim=-3)
    scores = torch.matmul(query * scale, key.transpose(-2, -1))
    L, S = query.shape[-2], key.shape[-2]
    if is_causal:
        scores = torch.where(cudaex.causal_keep(L, S, None, query.device), scores, -math.inf)
    elif attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, -math.inf)
        else:
            scores = scores + attn_mask
    probs = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0:
        probs = F.dropout(probs, dropout_p, training=True)
    return torch.matmul(probs, value)


def topk(a, k: int, dim: int = -1):
    """The ``k`` largest of ``a`` along ``dim`` and their indices, ties in
    index order (``jax.lax.top_k``'s order, which ``torch.topk`` on the card
    does not promise): a stable descending sort, differentiable through its
    gather.  Handed proxies it binds the torch language's ``topk``, whose
    torch executor sorts stably too."""
    if isinstance(a, TensorProxy):
        return torch.topk(a, k, dim)
    idx = torch.sort(a, dim=dim, descending=True, stable=True).indices.narrow(dim, 0, k)
    return a.gather(dim, idx), idx


class _CrossEntropy(torch.autograd.Function):
    """The CROSS_ENTROPY_FWD prim with its backward rule: f32 row losses
    ``lse - logits[target]`` and ``lse`` from (N, C) logits."""

    @staticmethod
    def forward(ctx, logits, target):
        if cudaex.ce_supported(tuple(logits.shape), tuple(target.shape), logits.dtype):
            losses, lse = CE["forward"](logits, target)
        else:
            DECLINES["flash_cross_entropy"] += 1
            losses, lse = cudaex.flash_cross_entropy_plain(logits, target)
        ctx.save_for_backward(logits, target, lse)
        ctx.set_materialize_grads(False)
        return losses, lse

    @staticmethod
    def backward(ctx, g_losses, g_lse):
        # dlogits = softmax(logits)·(g_losses + g_lse) - onehot(target)·g_losses,
        # recomputed from (logits, lse); the one-hot term lands by scatter
        logits, target, lse = ctx.saved_tensors
        if g_losses is None:
            g_losses = torch.zeros_like(lse)
        g_tot = g_losses + g_lse if g_lse is not None else g_losses
        dlogits = torch.exp(logits.float() - lse[:, None]) * g_tot[:, None]
        dlogits.scatter_add_(1, target[:, None], -g_losses[:, None])
        return dlogits.to(logits.dtype), None


class _FusedLinearCE(torch.autograd.Function):
    """The FUSED_LINEAR_CE prim with its backward rule, through the torch
    executor's chunked implementations: f32 row losses of ``h @ w.T``
    without the (N, V) logits; saves ``(h, w, target, lse)``."""

    @staticmethod
    def forward(ctx, h, w, target, ignore_index):
        from thunder_tpu_torch.executors import torchex

        losses, lse = torchex._fused_linear_ce_impl(h, w, target, ignore_index)
        ctx.save_for_backward(h, w, target, lse)
        ctx.ignore_index = ignore_index
        return losses

    @staticmethod
    def backward(ctx, g):
        from thunder_tpu_torch.executors import torchex

        h, w, target, lse = ctx.saved_tensors
        dh, dw = torchex._fused_linear_ce_backward_impl(g, h, w, target, lse,
                                                        ctx.ignore_index)
        return dh, dw, None, None


def fused_linear_cross_entropy(h, weight, target, ignore_index=-100, reduction="mean"):
    """``cross_entropy(h @ weight.T, target)`` without the (N, V) logits,
    as the torch language's ``fused_linear_cross_entropy`` computes it
    (``thunder_tpu/torch/__init__.py``): float32 row losses, ``ignore_index``
    rows zeroed and left out of the mean.  Handed proxies it binds the
    language's symbol (the FUSED_LINEAR_CE prim)."""
    if isinstance(h, TensorProxy):
        from thunder_tpu_torch import torch as torch_lang

        return torch_lang.fused_linear_cross_entropy(h, weight, target,
                                                     ignore_index=ignore_index,
                                                     reduction=reduction)
    if h.ndim != 2:
        raise ValueError(f"fused_linear_cross_entropy: h must be 2D, got {h.ndim}D")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"fused_linear_cross_entropy: unsupported reduction {reduction!r}")
    losses = _FusedLinearCE.apply(h, weight, target.to(torch.int32), int(ignore_index))
    if reduction == "none":
        return losses
    total = losses.sum()
    if reduction == "sum":
        return total
    n_valid = (target != ignore_index).to(losses.dtype).sum()
    return total / torch.clamp(n_valid, min=1.0)


def _log_softmax(a, dim):
    """The reference's ``log_softmax`` decomposition: computed in float32
    for low-precision input, ``a - max - log(sum(exp(a - max)))``, cast
    back."""
    ct = torch.float32 if a.dtype in (torch.bfloat16, torch.float16) else a.dtype
    af = a.to(ct)
    shifted = af - af.amax(dim=dim, keepdim=True)
    lse = torch.log(torch.exp(shifted).sum(dim=dim, keepdim=True))
    return (shifted - lse).to(a.dtype)


def _nll_loss(log_probs, target, weight=None, ignore_index=-100, reduction="mean"):
    """``torch.nn.functional.nll_loss`` as the reference decomposes it
    (``thunder_tpu/torch/__init__.py:1134``): class dim last, per-sample
    loss scaled by ``weight[target]``, ``ignore_index`` samples zeroed, the
    mean divided by the summed weights of the samples kept."""
    C = log_probs.shape[-1]
    flat_logp = log_probs.reshape(-1, C)
    flat_t = target.reshape(-1)
    safe_t = torch.where(flat_t == ignore_index, 0, flat_t).long()
    losses = -flat_logp.gather(1, safe_t[:, None])[:, 0]
    valid = flat_t != ignore_index
    if weight is not None:
        w = weight.index_select(0, safe_t)
        losses = losses * w
        norm = torch.where(valid, w, 0.0)
    else:
        norm = valid.to(losses.dtype)
    losses = torch.where(valid, losses, 0.0)
    if reduction == "none":
        return losses.reshape(target.shape)
    total = losses.sum()
    if reduction == "sum":
        return total
    return total / torch.clamp(norm.sum(), min=1e-12)


def cross_entropy(logits, target, weight=None, ignore_index=-100, reduction="mean",
                  label_smoothing=0.0):
    """``torch.nn.functional.cross_entropy`` as the JAX package computes it
    (``thunder_tpu/torch/__init__.py:1164``).  The fast path, (N, C) logits
    and (N,) class targets with no weight and no smoothing, runs the
    CROSS_ENTROPY_FWD prim (:class:`_CrossEntropy`, the ``flash_ce``
    kernel): float32 row losses, ``ignore_index`` rows zeroed and left out
    of the mean exactly, the reduction taken in float32 and only the result
    cast to the logits' dtype.  Class ``weight``, ``label_smoothing`` and
    ``(N, C, d1, ...)`` or ``(C,)`` logits take the reference's
    decomposition (``log_softmax`` over the class dim, moved last, then
    ``nll_loss`` and the smoothing term) under autograd.  Handed proxies
    (under ``jit``) it binds the torch language's symbol."""
    if isinstance(logits, TensorProxy):
        from thunder_tpu_torch import torch as torch_lang

        return torch_lang.cross_entropy(logits, target, weight, ignore_index=ignore_index,
                                        reduction=reduction, label_smoothing=label_smoothing)
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    if (weight is None and label_smoothing == 0.0 and logits.ndim == 2 and target.ndim == 1
            and not target.is_floating_point() and not target.is_complex()):
        safe_t = torch.where(target == ignore_index, 0, target).long()
        losses, _lse = _CrossEntropy.apply(logits, safe_t)
        valid = target != ignore_index
        losses = torch.where(valid, losses, 0.0)
        out_dtype = logits.dtype if logits.is_floating_point() else torch.float32
        if reduction == "none":
            return losses.to(out_dtype)
        total = losses.sum()
        if reduction == "sum":
            return total.to(out_dtype)
        n_valid = valid.to(losses.dtype).sum()
        return (total / torch.clamp(n_valid, min=1.0)).to(out_dtype)
    if logits.ndim > 2:
        # torch layout (N, C, d1, ...): log_softmax over C, then C moved last
        logp = _log_softmax(logits, 1).permute(0, *range(2, logits.ndim), 1)
    else:
        logp = _log_softmax(logits, -1 if logits.ndim != 1 else 0)
    nll = _nll_loss(logp, target, weight, ignore_index=ignore_index, reduction=reduction)
    if label_smoothing == 0.0:
        return nll
    # label smoothing (torch aten cross_entropy_loss_label_smoothing):
    # smooth_i = -sum_c w_c * logp[i, c]; final = (1-ls)*nll + ls/C * smooth
    C = logp.shape[-1]
    wl = logp * weight.reshape((1,) * (logp.ndim - 1) + (C,)) if weight is not None else logp
    smooth = -wl.sum(dim=-1)
    flat_t = target.reshape(-1)
    valid = flat_t != ignore_index
    smooth = torch.where(valid.reshape(smooth.shape), smooth, 0.0)
    if reduction == "sum":
        smooth_ret = smooth.sum()
    elif reduction == "mean":
        if weight is not None:
            safe_t = torch.where(valid, flat_t, 0).long()
            norm = torch.where(valid, weight.index_select(0, safe_t), 0.0)
        else:
            norm = valid.to(smooth.dtype)
        smooth_ret = smooth.sum() / torch.clamp(norm.sum(), min=1e-12)
    else:
        smooth_ret = smooth
    return nll * (1.0 - label_smoothing) + smooth_ret * (label_smoothing / C)
