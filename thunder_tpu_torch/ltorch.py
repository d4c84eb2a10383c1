"""The ``ltorch`` ops of the training slice: attention and cross-entropy.

Counterpart of the two ``thunder_tpu.torch`` symbols a Llama training step
runs (``thunder_tpu/torch/__init__.py``: ``scaled_dot_product_attention``
:1061, ``cross_entropy`` :1164), of the prims they reach
(``thunder_tpu/executors/jaxex.py`` :518-607: ``_sdpa_impl``,
``_sdpa_reference``, ``_sdpa_backward_reference``,
``_cross_entropy_fwd_reference``) and of those prims' backward rules
(``thunder_tpu/core/transforms.py`` :652 SDPA, :699 CROSS_ENTROPY_FWD).

The JAX package traces these ops and differentiates the trace; the port runs
eager PyTorch autograd, so each prim with a backward rule is a
``torch.autograd.Function``:

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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from thunder_tpu_torch.executors import cudaex

__all__ = ["CE", "DECLINES", "FLASH", "cross_entropy", "scaled_dot_product_attention",
           "sdpa_backward_reference", "sdpa_reference"]

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
    (:class:`_SDPA`); otherwise the explicit decomposition."""
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


def cross_entropy(logits, target, weight=None, ignore_index=-100, reduction="mean",
                  label_smoothing=0.0):
    """``torch.nn.functional.cross_entropy``'s fast path as the JAX package
    runs it: (N, C) logits and (N,) class targets, float32 row losses,
    ``ignore_index`` rows zeroed and left out of the mean exactly, the
    reduction taken in float32 and only the result cast to the logits'
    dtype.  Class weights, label smoothing and other layouts are not ported
    and raise ``NotImplementedError``."""
    if weight is not None or label_smoothing != 0.0:
        raise NotImplementedError("cross_entropy: weight= and label_smoothing= are not ported")
    if logits.ndim != 2 or target.ndim != 1 or target.is_floating_point():
        raise NotImplementedError("cross_entropy: only (N, C) logits with (N,) class targets "
                                  "are ported")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
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
