"""Autoregressive inference with a dense KV cache.

Counterpart of ``thunder_tpu/models/generate.py``: the same per-layer math
(norms, QKV projection with partial rotary, GQA attention, LLaMAMLP /
GemmaMLP / GptNeoxMLP / LLaMAMoE, head) over the same params dict and the same dense
cache layout ``(L, B, ng, Tc, hs)``, so the paged serving pool's gathered
block views feed it unchanged.  Written eagerly: ``generate()`` is a Python
loop where the JAX package runs ``lax.scan``, and caches update in place
where JAX returns new arrays.

Attention mirrors the JAX scoring tail exactly — float32 scores divided by
``sqrt(hs)``, a ``-inf`` keep-mask, softmax, then the weights cast to the
query dtype — with plain matmul and softmax rather than a fused SDPA call,
which would reorder the math and change greedy tokens.

``forward_with_cache(lora=...)`` takes per-request LoRA factors, one adapter
per batch row (the layout ``serving.lora.gather_adapter_slots`` produces), or
the registry's arenas with ``lora_slots=``, and adds each target's delta next
to its matmul.

``quantized=True`` runs every weight matmul (projections, MLP, experts,
head) through ``executors.quantex.int8_linear``, per-call absmax scales on
activations and weights, as the reference's ``quantized=`` does; the MoE
router and the LoRA deltas stay in full precision.

Sliding-window models whose cache is exactly one window long keep the
reference's **ring** layout (``ring_slot``, ``ring_gather_positions``):
global position ``p`` lives in slot ``p % window``; a prefill attends
within its own chunk and leaves each slot its latest prompt position.  As
in the reference, per-row positions with a ring cache are refused.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.models.llama import (
    Config,
    _linear,
    _lora_delta,
    _norm,
    _project_qkv,
    build_rope_cache,
    mlp,
)

__all__ = [
    "init_cache",
    "forward_with_cache",
    "generate",
    "cache_len",
    "cache_shape",
    "kv_block_shape",
    "sample_token",
    "ring_slot",
    "ring_gather_positions",
]


def cache_len(cfg: Config, T_max: int) -> int:
    """Sequence capacity of the dense cache: ``sliding_window`` bounds it
    (a cache exactly one window long is the JAX package's ring layout)."""
    if cfg.sliding_window is not None:
        return min(T_max, cfg.sliding_window)
    return T_max


def cache_shape(cfg: Config, B: int, T_max: int) -> tuple[int, int, int, int, int]:
    """Dense KV-cache geometry ``(L, B, n_query_groups, Tc, hs)``."""
    return (cfg.n_layer, B, cfg.n_query_groups, cache_len(cfg, T_max), cfg.head_size)


def kv_block_shape(cfg: Config, block_size: int) -> tuple[int, int, int, int]:
    """Per-block geometry ``(L, n_query_groups, block_size, hs)`` of the
    paged serving pool's arena."""
    return (cfg.n_layer, cfg.n_query_groups, block_size, cfg.head_size)


def ring_slot(pos, window: int):
    """Ring-cache slot of global position ``pos``: ``pos % window``."""
    return pos % window


def ring_gather_positions(T: int, window: int) -> np.ndarray:
    """Prefill→ring scatter map: for each ring slot ``j``, the latest prompt
    position ``p < T`` with ``p ≡ j (mod window)`` (clamped to 0 for slots no
    prompt position reaches; those stay garbage and are masked positionally
    at decode)."""
    src_pos = np.array([j + ((T - 1 - j) // window) * window for j in range(window)])
    return np.maximum(src_pos, 0)


def init_cache(cfg: Config, B: int, T_max: int, dtype=torch.bfloat16, *,
               device="cuda") -> dict:
    """Zeroed dense cache ``{"k"/"v": (L, B, ng, Tc, hs)}`` on ``device``."""
    shape = cache_shape(cfg, B, T_max)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _is_vec_pos(pos) -> bool:
    """True when ``pos`` is per-row positions (B,) rather than one scalar."""
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def _expand_groups(kk, vv, nh):
    B, ng, Tc, hs = kk.shape
    if ng != nh:
        rep = nh // ng
        kk = kk[:, :, None].expand(B, ng, rep, Tc, hs).reshape(B, nh, Tc, hs)
        vv = vv[:, :, None].expand(B, ng, rep, Tc, hs).reshape(B, nh, Tc, hs)
    return kk, vv


def _attn_with_cache(ap, x, cos_t, sin_t, ck, cv, pos, cfg: Config, *, lora=None,
                     lora_scaling=1.0, delta_fn=_lora_delta, quantized=False):
    """x: (B, T, C) new tokens at global positions [pos, pos+T).  Writes
    their K/V into the per-layer cache (ck/cv: (B, ng, Tc, hs), in place)
    and attends against every slot the model may see: the plain layout
    (slot = position) when the cache covers the sequence, the ring layout
    (slot = position % window) when ``sliding_window`` bounds it.  ``lora``: this layer's ``{target: (a, b)}`` factors, whose
    deltas ``delta_fn`` computes; ``quantized``: int8 weight matmuls."""
    B, T, _ = x.shape
    hs, nh = cfg.head_size, cfg.n_head
    q, k, v = _project_qkv(ap, x, cos_t, sin_t, cfg, lora=lora, lora_scaling=lora_scaling,
                           delta_fn=delta_fn, quantized=quantized)
    Tc = ck.shape[2]
    W = cfg.sliding_window
    ring = W is not None and Tc == W
    vec = _is_vec_pos(pos)
    if ring and vec:
        raise ValueError("per-row positions are not supported with a ring cache")
    t = torch.arange(T, device=x.device)
    kk, vv = ck, cv
    if not ring:
        if vec:
            slots = pos.long()[:, None] + t                      # (B, T)
            rows = torch.arange(B, device=x.device)[:, None]
            ck[rows, :, slots] = k.transpose(1, 2).to(ck.dtype)  # (B, T, ng, hs)
            cv[rows, :, slots] = v.transpose(1, 2).to(cv.dtype)
            qpos = slots[:, None, :, None]                       # (B, 1, T, 1)
        else:
            ck[:, :, pos:pos + T] = k.to(ck.dtype)
            cv[:, :, pos:pos + T] = v.to(cv.dtype)
            qpos = (pos + t)[None, None, :, None]
        j = torch.arange(Tc, device=x.device)
        keep = j <= qpos
        if W is not None:
            keep = keep & (j > qpos - W)
    elif T > 1:
        # ring prefill: the chunk attends within itself (banded); each ring
        # slot keeps its latest prompt position.  It starts at position 0: a
        # later chunk would need K/V the ring has already evicted
        if not (isinstance(pos, int) and pos == 0):
            raise ValueError("a ring-cache prefill must start at position 0")
        kk, vv = k, v
        row, col = t[:, None], t[None, :]
        keep = (col <= row) & (col > row - W)
        gather = torch.as_tensor(ring_gather_positions(T, W), device=x.device)
        ck.copy_(k.index_select(2, gather).to(ck.dtype))
        cv.copy_(v.index_select(2, gather).to(cv.dtype))
    else:
        # ring decode: one token at global position pos -> slot pos % W;
        # slot j holds global position pos - ((pos - j) mod W), always in
        # (pos - W, pos]: mask only the slots never written
        slot = ring_slot(pos, W)
        ck[:, :, slot:slot + 1] = k.to(ck.dtype)
        cv[:, :, slot:slot + 1] = v.to(cv.dtype)
        j = torch.arange(W, device=x.device)
        keep = (pos - (pos - j) % W) >= 0
    kk, vv = _expand_groups(kk, vv, nh)
    scores = torch.matmul(q.float(), kk.to(q.dtype).float().transpose(-1, -2)) / math.sqrt(hs)
    scores = scores.masked_fill(~keep, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    y = torch.matmul(w, vv.to(q.dtype))
    y = y.transpose(1, 2).reshape(B, T, nh * hs)
    out = _linear(y, ap["wo"], ap.get("bo"), quantized=quantized)
    if lora is not None and "wo" in lora:
        out = out + delta_fn(y, *lora["wo"], lora_scaling)
    return out


def _embed(params, idx, pos, cos_all, sin_all, cfg: Config):
    """Token (+ learned position) embedding and the rope rows for new
    tokens ``idx`` (B, T) at positions [pos, pos+T) — scalar or per-row."""
    T = idx.shape[1]
    x = params["wte"][idx.long()]
    if cfg.scale_embedding:
        x = x * (cfg.n_embd ** 0.5)
    t = torch.arange(T, device=idx.device)
    if _is_vec_pos(pos):
        p = pos.long()[:, None] + t                          # (B, T)
        cos_t, sin_t = cos_all[p][:, None], sin_all[p][:, None]   # (B, 1, T, n)
    else:
        p = pos + t
        cos_t, sin_t = cos_all[p], sin_all[p]                # (T, n)
    if cfg.learned_pos_embedding:
        x = x + params["wpe"][p]
    return x, cos_t, sin_t


def _head(params, x, cfg: Config, *, quantized=False):
    x = _norm(x, params["ln_f"], cfg, params.get("ln_f_b"))
    head = params["wte"] if cfg.tie_embeddings else params["lm_head"]
    return _linear(x, head, params.get("lm_head_b"), quantized=quantized).float()


def _block_tail(bp, x, n1, h, cfg: Config, *, lora=None, lora_scaling=1.0,
                delta_fn=_lora_delta, quantized=False):
    """Residual + MLP half of a block, given the attention output ``h``;
    ``delta_fn`` computes the MLP targets' LoRA deltas."""
    kw = dict(lora=lora, lora_scaling=lora_scaling, delta_fn=delta_fn, quantized=quantized)
    if cfg.parallel_residual:
        n2 = n1 if cfg.shared_attention_norm else _norm(x, bp["norm_2"], cfg, bp.get("norm_2_b"))
        return x + h + mlp(bp["mlp"], n2, cfg, **kw)
    x = x + h
    return x + mlp(bp["mlp"], _norm(x, bp["norm_2"], cfg, bp.get("norm_2_b")), cfg, **kw)


def _layer_lora(lora, l: int):
    """Layer ``l``'s ``{target: (a, b)}`` views of the stacks ``{target:
    {"a": (N, L, r, fin), "b": (N, L, fout, r)}}``, or None: N is the
    batch's rows, or the registry's slots where the step passes
    ``lora_slots``."""
    if not lora:
        return None
    return {t: (ab["a"][:, l], ab["b"][:, l]) for t, ab in lora.items()}


def forward_with_cache(params, idx, pos, cache, cos_all, sin_all, cfg: Config, *, lora=None,
                       lora_scaling=1.0, lora_slots=None, quantized=False):
    """Forward of new tokens ``idx`` (B, T) at global positions [pos, pos+T)
    against/into ``cache`` (updated in place).  ``pos`` is a Python int or
    a (B,) integer tensor of per-row positions.  ``lora``: optional
    per-request factors ``{target: {"a": (B, L, r, fin), "b": (B, L, fout,
    r)}}``, one adapter per batch row; with ``lora_slots`` ((B,) int32
    adapter slots) the registry's (S, L, ...) arenas instead, each row's
    factors taken by its slot layer by layer.  The delta ``lora_scaling *
    B(A(x))`` lands next to each target's matmul.  ``quantized``: every
    weight matmul through ``int8_linear``.  Returns (logits (B, T, V)
    float32, cache)."""
    x, cos_t, sin_t = _embed(params, idx, pos, cos_all, sin_all, cfg)
    delta = functools.partial(_lora_delta, slots=lora_slots)
    for l, bp in enumerate(params["blocks"]):
        lora_l = _layer_lora(lora, l)
        n1 = _norm(x, bp["norm_1"], cfg, bp.get("norm_1_b"))
        h = _attn_with_cache(bp["attn"], n1, cos_t, sin_t, cache["k"][l], cache["v"][l], pos, cfg,
                             lora=lora_l, lora_scaling=lora_scaling, delta_fn=delta,
                             quantized=quantized)
        x = _block_tail(bp, x, n1, h, cfg, lora=lora_l, lora_scaling=lora_scaling,
                        delta_fn=delta, quantized=quantized)
    return _head(params, x, cfg, quantized=quantized), cache


def sample_token(logits, temperature: float, generator: torch.Generator | None = None):
    """Greedy (``temperature == 0``) or temperature sampling over the last
    axis; returns int32 token ids.  Sampling draws one categorical sample
    per row from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    tok = torch.multinomial(flat, 1, generator=generator)
    return tok.reshape(probs.shape[:-1]).to(torch.int32)


def generate(params, prompt, cfg: Config, max_new_tokens: int, *,
             T_max: int | None = None, temperature: float = 0.0,
             generator: torch.Generator | None = None, cache_dtype=None,
             quantized: bool = False, device="cuda") -> torch.Tensor:
    """Greedy/temperature sampling.  ``prompt``: (B, T_prompt) int tokens.
    Returns (B, T_prompt + max_new_tokens) int32 on ``device`` (default:
    the card; raises without one unless ``device="cpu"``).  ``params`` must
    already live on ``device``.  ``generator`` (default: seed 0) supplies
    one draw at the prefill and one per decode step.  ``quantized``: int8
    weight matmuls (:func:`forward_with_cache`)."""
    dev = resolve_device(device)
    if params["wte"].device.type != dev.type:
        raise ValueError(f"params live on {params['wte'].device}, generate(device={dev})")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32, device=dev)
    B, T_prompt = prompt.shape
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_new_tokens == 0:
        return prompt
    if T_max is None:
        T_max = min(cfg.block_size, T_prompt + max_new_tokens)
    if T_prompt + max_new_tokens > T_max:
        raise ValueError("T_max too small")
    if cfg.learned_pos_embedding and T_max > cfg.block_size:
        raise ValueError(
            f"T_max {T_max} exceeds block_size {cfg.block_size} with learned position embeddings")
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = cache_dtype if cache_dtype is not None else params["wte"].dtype
    cos_all, sin_all = build_rope_cache(cfg, T_max, device=dev)
    cache = init_cache(cfg, B, T_max, dtype, device=dev)
    logits, cache = forward_with_cache(params, prompt, 0, cache, cos_all, sin_all, cfg,
                                       quantized=quantized)
    tok = sample_token(logits[:, -1], temperature, generator)
    toks = [tok]
    for i in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(
            params, tok[:, None], T_prompt + i, cache, cos_all, sin_all, cfg,
            quantized=quantized)
        tok = sample_token(logits[:, -1], temperature, generator)
        toks.append(tok)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
