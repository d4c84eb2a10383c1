"""Speculative decoding: a small draft model proposes K tokens, the target
model verifies them in one forward.

Counterpart of ``thunder_tpu/models/speculative.py``.  Greedy contract: the
emitted sequence is token-identical to plain greedy decoding with the target
alone — drafts are accepted while they match the target's argmax, and the
first mismatch is replaced by the target's own token.  Temperature > 0 is
speculative sampling (Leviathan et al.): draft ``i`` is accepted with
probability ``min(1, p_i(x_i) / q_i(x_i))`` and the first rejection
resamples from the normalized residual ``max(p - q, 0)``, so the emitted
distribution is the target's.

Randomness comes from a ``torch.Generator`` (JAX draws from threefry keys;
the two cannot match).  One generator per request, drawn in this order each
round: the K+1 draft iterations one categorical each, then K uniforms, then
the residual draw.  The serving engine draws in the same order from each
request's own generator, so a served request equals its solo
:func:`speculative_generate` at B = 1.  :func:`acceptance` holds the math
with the uniforms passed in, so a test can feed it the uniforms JAX drew.

Cache bookkeeping rides the plain dense-cache semantics: a rejected draft's
K/V sits above the accepted prefix, where the next verify chunk rewrites it
or the ``slot <= qpos`` keep-mask hides it.  Sliding-window models are not
supported.
"""
from __future__ import annotations

import numpy as np
import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.models.generate import (
    cache_len,
    forward_with_cache,
    init_cache,
    sample_token,
)
from thunder_tpu_torch.models.llama import Config, build_rope_cache

__all__ = ["acceptance", "accept_tokens", "greedy_acceptance", "speculative_generate"]


def acceptance(us, drafts, p_all, q_rows):
    """The rejection rule with its uniforms given: ``us`` (..., K) in
    [0, 1), ``drafts`` (..., K) int, ``p_all`` (..., K+1, V) target probs,
    ``q_rows`` (..., K, V) draft probs.  Returns ``(m, residual)``: the
    accepted-prefix length (..., ) and the normalized distribution (..., V)
    the correction (or, when every draft is accepted, the bonus) token is
    drawn from."""
    K = drafts.shape[-1]
    d = drafts.long()[..., None]
    p_x = torch.gather(p_all[..., :K, :], -1, d)[..., 0]
    q_x = torch.gather(q_rows, -1, d)[..., 0]
    accept = us < torch.minimum(p_x / torch.clamp(q_x, min=1e-20), torch.ones_like(p_x))
    stop = torch.cat([~accept, torch.ones_like(accept[..., :1])], dim=-1)
    m = torch.argmax(stop.to(torch.int32), dim=-1)         # first rejection, K if none
    # q extends with a zero row, so m == K samples the bonus from p_K
    q_ext = torch.cat([q_rows, torch.zeros_like(q_rows[..., :1, :])], dim=-2)
    idx = m[..., None, None].expand(*m.shape, 1, p_all.shape[-1])
    p_m = torch.gather(p_all, -2, idx)[..., 0, :]
    res = torch.clamp(p_m - torch.gather(q_ext, -2, idx)[..., 0, :], min=0.0)
    total = res.sum(dim=-1, keepdim=True)
    # p <= q everywhere yet rejected happens only through rounding: fall back
    # to the target row
    res = torch.where(total > 0, res / torch.clamp(total, min=1e-20), p_m)
    return m, res


def accept_tokens(generator, drafts, p_all, q_rows):
    """Speculative-sampling acceptance for one request: draws K uniforms,
    then the correction/bonus token, from ``generator``.  ``drafts`` (K,),
    ``p_all`` (K+1, V), ``q_rows`` (K, V).  Returns ``(m, y)``."""
    us = torch.rand(drafts.shape[-1], generator=generator, device=p_all.device)
    m, res = acceptance(us, drafts, p_all, q_rows)
    y = torch.multinomial(res[None], 1, generator=generator)[0, 0].to(torch.int32)
    return m, y


def greedy_acceptance(tlogits, drafts):
    """Greedy rule over rows: ``tlogits`` (B, K+1, V), ``drafts`` (B, K).
    Returns ``(m, y)``: drafts accepted while they equal the target's
    argmax, then the target's own token."""
    tgt = torch.argmax(tlogits, dim=-1).to(torch.int32)        # (B, K+1)
    miss = torch.cat([drafts != tgt[:, :-1], torch.ones_like(drafts[:, :1], dtype=torch.bool)],
                     dim=1)
    m = torch.argmax(miss.to(torch.int32), dim=1)
    return m, tgt.gather(1, m[:, None])[:, 0]


def emitted_tokens(drafts, m, y):
    """(B, K+1) round output: ``drafts[:, i]`` for ``i < m``, ``y`` at
    ``m``, ``y`` again above (masked by ``n_emit = m + 1``)."""
    B, K = drafts.shape
    iota = torch.arange(K + 1, device=drafts.device)[None, :]
    padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    return torch.where(iota < m[:, None], padded, y[:, None].to(padded.dtype))


def speculative_generate(params, draft_params, prompt, cfg: Config, draft_cfg: Config,
                         max_new_tokens: int, *, K: int = 4, T_max: int | None = None,
                         temperature: float = 0.0, generator: torch.Generator | None = None,
                         cache_dtype=None, lora=None, lora_scaling: float = 1.0,
                         device="cuda") -> torch.Tensor:
    """Speculative decoding over dense caches; returns (B, T_prompt +
    max_new_tokens) int32 tokens on ``device`` (default: the card; raises
    without one unless ``device="cpu"``).

    ``temperature=0``: token-identical to ``generate(params, ...)``.
    ``temperature>0``: speculative sampling from ``generator`` (default:
    seed 0), in the draw order the module docstring gives.  Rows advance at
    their own rates; finished rows freeze while slower rows catch up.
    ``speculative_generate.last_tokens_per_round`` holds the mean tokens a
    row emitted per active round (K+1: every draft accepted).

    ``lora``/``lora_scaling``: optional per-request LoRA factors
    (``forward_with_cache``'s layout, one adapter per row) applied to the
    target's forwards only; the draft stays the base model and the
    acceptance rule corrects the mismatch."""
    dev = resolve_device(device)
    if params["wte"].device.type != dev.type or draft_params["wte"].device.type != dev.type:
        raise ValueError(f"params must live on {dev}")
    if cfg.padded_vocab_size != draft_cfg.padded_vocab_size:
        raise ValueError("the draft must share the target's vocabulary")
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32, device=dev)
    B, T_prompt = prompt.shape
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_new_tokens == 0:
        return prompt
    if T_max is None:
        T_max = min(cfg.block_size, T_prompt + max_new_tokens + K + 1)
    if T_prompt + max_new_tokens + K > T_max:
        raise ValueError(
            f"T_max={T_max} too small for K-token speculation: the cache must hold "
            f"T_prompt+max_new_tokens+K = {T_prompt + max_new_tokens + K} positions")
    if cache_len(cfg, T_max) != T_max or cache_len(draft_cfg, T_max) != T_max:
        raise ValueError("speculative decoding needs full (non-ring) caches; sliding-window "
                         "models decode via generate()")
    if generator is None and temperature != 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = cache_dtype if cache_dtype is not None else params["wte"].dtype
    cos, sin = build_rope_cache(cfg, T_max, device=dev)
    cos_d, sin_d = build_rope_cache(draft_cfg, T_max, device=dev)
    tcache = init_cache(cfg, B, T_max, dtype, device=dev)
    dcache = init_cache(draft_cfg, B, T_max, dtype, device=dev)
    with torch.no_grad():
        tlora = dict(lora=lora, lora_scaling=lora_scaling)
        tlogits, tcache = forward_with_cache(params, prompt, 0, tcache, cos, sin, cfg, **tlora)
        forward_with_cache(draft_params, prompt, 0, dcache, cos_d, sin_d, draft_cfg)
        first = sample_token(tlogits[:, -1], temperature, generator)
        buf = torch.zeros((B, max_new_tokens + K + 1), dtype=torch.int32, device=dev)
        buf[:, 0] = first
        cur = first
        pos = torch.full((B,), T_prompt, dtype=torch.int32, device=dev)
        n = torch.ones(B, dtype=torch.int64, device=dev)
        rounds = torch.zeros(B, dtype=torch.int64, device=dev)
        while int(n.min()) < max_new_tokens:
            # frozen rows still run the lockstep forwards; clamp their chunk
            # start so every cache write stays in bounds
            pos_in = torch.clamp(pos, max=T_max - K - 1)
            tok, dpos, drafts, q_rows = cur, pos_in, [], []
            for _ in range(K + 1):
                dl, dcache = forward_with_cache(draft_params, tok[:, None], dpos, dcache,
                                                cos_d, sin_d, draft_cfg)
                row = dl[:, -1]
                tok = sample_token(row, temperature, generator)
                drafts.append(tok)
                if temperature != 0.0:
                    q_rows.append(torch.softmax(row / temperature, dim=-1))
                dpos = dpos + 1
            drafts = torch.stack(drafts[:K], dim=1)            # (B, K)
            chunk = torch.cat([cur[:, None], drafts], dim=1)
            tlogits, tcache = forward_with_cache(params, chunk, pos_in, tcache, cos, sin, cfg,
                                                 **tlora)
            if temperature == 0.0:
                m, y = greedy_acceptance(tlogits, drafts)
            else:
                p_all = torch.softmax(tlogits / temperature, dim=-1)
                us = torch.rand((B, K), generator=generator, device=dev)
                m, res = acceptance(us, drafts, p_all, torch.stack(q_rows[:K], dim=1))
                y = torch.multinomial(res, 1, generator=generator)[:, 0].to(torch.int32)
            n_emit = m + 1
            emitted = emitted_tokens(drafts, m, y)
            done = n >= max_new_tokens
            for i in range(B):
                if not bool(done[i]):
                    buf[i, int(n[i]):int(n[i]) + K + 1] = emitted[i]
            live = ~done
            cur = torch.where(live, y, cur)
            pos = torch.where(live, pos + n_emit.to(torch.int32), pos)
            n = torch.where(live, n + n_emit, n)
            rounds = rounds + live.long()
    per_row = (torch.clamp(n, max=max_new_tokens) - 1).double() / torch.clamp(rounds, min=1)
    speculative_generate.last_tokens_per_round = float(per_row.mean())
    return torch.cat([prompt, buf[:, :max_new_tokens]], dim=1)
