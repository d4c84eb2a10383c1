"""LitGPT-style Llama model family: configs, parameters, rope, forward, loss.

Counterpart of ``thunder_tpu/models/llama.py`` (lines 44-533): the same
``Config`` dataclass and config zoo, the same params layout (nested dicts /
a list of per-block dicts, linear weights stored ``(fan_out, fan_in)``), so
a JAX params pytree carries over key for key
(:func:`thunder_tpu_torch.models.weights.params_from_numpy`).

Parameters are drawn on the target device from an explicit
``torch.Generator``; the numbers differ from ``jax.random`` for the same
seed, so tests that compare the two packages build weights once (with JAX
or numpy) and carry them over.

The training forward (``gpt_hidden``/``gpt_forward``/``gpt_loss``) traces
as it is under ``thunder_tpu_torch.jit`` and the train step: its torch
calls on proxies divert into the torch language, and ``ltorch``'s
attention and cross-entropy (fused with the head under ``fused_head_ce``)
bind its symbols.  On tensors (the train step's eager twin) it runs under
autograd: attention and cross-entropy go through
:mod:`thunder_tpu_torch.ltorch` (the flash kernels and their backward), and
each block runs under the remat policy of the enclosing step
(:func:`thunder_tpu_torch.train.remat.run_block`).

MoE configs (``LLaMAMoE``) keep the reference's stacked expert weights and
its dense formulation: every expert runs on every token and the router's
top-k weight masks its output.  The training MLP (:func:`moe_mlp`) routes
in the activations' dtype, the serving one (:func:`mlp`) in float32, each
as its reference does; both select with ``ltorch.topk``, whose ties keep
index order as ``jax.lax.top_k``'s do.

The serving forward lives in :mod:`thunder_tpu_torch.models.generate`;
both share the block helpers here, which take per-request LoRA factors
(``lora=``, the serving engine's adapters) beside the training forward's
single-adapter hook (``ap["lora"]``), and ``quantized=`` (serving only):
every weight matmul through ``executors.quantex.int8_linear``, the router
and the LoRA deltas excepted, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from thunder_tpu_torch import ltorch
from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch._tree import tree_leaves
from thunder_tpu_torch.executors.cudaex import _as_dtype_scalar
from thunder_tpu_torch.executors.quantex import int8_linear
from thunder_tpu_torch.train import remat

__all__ = [
    "Config",
    "configs",
    "name_to_config",
    "init_params",
    "build_rope_cache",
    "param_count",
    "apply_rope",
    "attention",
    "mlp",
    "moe_mlp",
    "block_forward",
    "gpt_hidden",
    "gpt_forward",
    "gpt_loss",
    "batch_bucketer",
]


@dataclass
class Config:
    """Architecture description (same fields and derivations as the JAX
    package's ``Config``)."""

    name: str = "tiny-llama-debug"
    block_size: int = 4096
    vocab_size: int = 32000
    padded_vocab_size: int | None = None
    n_layer: int = 16
    n_head: int = 32
    n_embd: int = 4096
    head_size: int | None = None
    n_query_groups: int | None = None  # None → MHA; 1 → MQA; else GQA
    rotary_percentage: float = 1.0
    parallel_residual: bool = False
    bias: bool = False
    norm_eps: float = 1e-5
    intermediate_size: int | None = None
    mlp_class: str = "LLaMAMLP"  # or "GptNeoxMLP" / "GemmaMLP" / "LLaMAMoE"
    norm_class: str = "RMSNorm"  # or "LayerNorm"
    # Gemma style: hidden states scaled by sqrt(n_embd) after the embedding
    scale_embedding: bool = False
    rope_base: int = 10000
    rope_condense_ratio: float = 1.0
    shared_attention_norm: bool = False
    lm_head_bias: bool = False
    tie_embeddings: bool = False
    # GPT-2/nanoGPT style learned absolute position embeddings (wpe)
    learned_pos_embedding: bool = False
    # MoE (LLaMAMoE)
    n_expert: int = 0
    n_expert_per_token: int = 2
    # Mistral-style sliding-window attention: query i attends keys in
    # (i-window, i].  None = full causal
    sliding_window: int | None = None
    # Llama-3.1-style rope frequency rescaling (hf rope_type="llama3"),
    # stored as a sorted (key, value) tuple so configs stay hashable
    rope_scaling_llama3: tuple | dict | None = None
    # fused lm-head + cross-entropy (training; kept for config parity)
    fused_head_ce: bool = False
    # GPT-2 uses the tanh gelu approximation; the default is the exact erf form
    gelu_approximate: str = "none"

    def __post_init__(self):
        if isinstance(self.rope_scaling_llama3, dict):
            self.rope_scaling_llama3 = tuple(sorted(self.rope_scaling_llama3.items()))
        if self.padded_vocab_size is None:
            self.padded_vocab_size = ((self.vocab_size + 63) // 64) * 64
        if self.head_size is None:
            assert self.n_embd % self.n_head == 0
            self.head_size = self.n_embd // self.n_head
        if self.n_query_groups is None:
            self.n_query_groups = self.n_head
        assert self.n_head % self.n_query_groups == 0
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.n_embd
        if self.mlp_class == "LLaMAMoE":
            assert self.n_expert > 0, "LLaMAMoE requires n_expert > 0"
            assert 0 < self.n_expert_per_token <= self.n_expert
            assert not self.bias, "bias is not supported for the MoE MLP"
        if self.bias:
            assert self.norm_class == "LayerNorm", "bias implies LayerNorm (GPT-2/NeoX style)"
        assert not (self.lm_head_bias and self.fused_head_ce), (
            "fused_head_ce computes logits inside the fused prim and has no "
            "bias input — it would silently drop lm_head_b; disable one of "
            "lm_head_bias / fused_head_ce"
        )

    @property
    def rope_n_elem(self) -> int:
        return int(self.rotary_percentage * self.head_size)

    @classmethod
    def from_name(cls, name: str, **overrides) -> "Config":
        cfg = name_to_config[name]
        if not overrides:
            return cfg
        # rebuild so derived fields recompute when their source fields are
        # overridden — but only those whose stored value matches what
        # derivation produced (an explicitly-configured value is kept)
        base = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
        was_derived = {
            "padded_vocab_size": cfg.padded_vocab_size == ((cfg.vocab_size + 63) // 64) * 64,
            "head_size": cfg.head_size == cfg.n_embd // cfg.n_head,
            "n_query_groups": cfg.n_query_groups == cfg.n_head,
        }
        derived_sources = {
            "padded_vocab_size": ("vocab_size",),
            "head_size": ("n_embd", "n_head"),
            "n_query_groups": ("n_head",),
        }
        for derived, sources in derived_sources.items():
            if derived not in overrides and was_derived[derived] and any(s in overrides for s in sources):
                base[derived] = None
        base.update(overrides)
        return cls(**base)


# Public architecture hyperparameters: the JAX package's zoo, entry for entry.
configs: list[Config] = [
    Config(name="tiny-llama-debug", block_size=128, vocab_size=256, n_layer=2, n_head=4,
           n_embd=64, n_query_groups=2, intermediate_size=176),
    Config(name="llama1-like", block_size=2048, vocab_size=32000, n_layer=32, n_head=32,
           n_embd=4096, intermediate_size=11008),
    Config(name="long-context-like", block_size=32768, vocab_size=32000, n_layer=32,
           n_head=32, n_embd=4096, intermediate_size=11008, rope_condense_ratio=4.0),
    Config(name="llama2-like", block_size=4096, vocab_size=32000, n_layer=32, n_head=32,
           n_embd=4096, intermediate_size=11008),
    Config(name="Llama-2-7b-hf", block_size=4096, vocab_size=32000, n_layer=32, n_head=32,
           n_embd=4096, intermediate_size=11008),
    Config(name="Llama-2-13b-hf", block_size=4096, vocab_size=32000, n_layer=40, n_head=40,
           n_embd=5120, intermediate_size=13824),
    Config(name="Llama-2-70b-hf", block_size=4096, vocab_size=32000, n_layer=80, n_head=64,
           n_embd=8192, n_query_groups=8, intermediate_size=28672),
    Config(name="Llama-3-8B", block_size=8192, vocab_size=128000, padded_vocab_size=128256,
           n_layer=32, n_head=32, n_embd=4096, n_query_groups=8, rope_base=500000,
           intermediate_size=14336),
    Config(name="CodeLlama-2-like", block_size=16384, vocab_size=32016, n_layer=32,
           n_head=32, n_embd=4096, intermediate_size=11008, rope_base=1000000),
    Config(name="nanogpt-debug", block_size=128, vocab_size=256, n_layer=2, n_head=4,
           n_embd=64, rotary_percentage=0.0, learned_pos_embedding=True,
           parallel_residual=False, norm_class="LayerNorm", mlp_class="GptNeoxMLP",
           tie_embeddings=True, bias=True, gelu_approximate="tanh"),
    Config(name="gpt2-124m", block_size=1024, vocab_size=50257, n_layer=12, n_head=12,
           n_embd=768, rotary_percentage=0.0, learned_pos_embedding=True,
           norm_class="LayerNorm", mlp_class="GptNeoxMLP", tie_embeddings=True,
           bias=True, gelu_approximate="tanh"),
    Config(name="tiny-gemma-debug", block_size=128, vocab_size=256, n_layer=2, n_head=4,
           n_embd=64, intermediate_size=176, mlp_class="GemmaMLP", gelu_approximate="tanh",
           tie_embeddings=True, scale_embedding=True),
    Config(name="Gemma-7b-like", block_size=8192, vocab_size=256000, n_layer=28, n_head=16,
           n_embd=3072, head_size=256, intermediate_size=24576, mlp_class="GemmaMLP",
           gelu_approximate="tanh", tie_embeddings=True, scale_embedding=True),
    Config(name="tiny-falcon-debug", block_size=128, vocab_size=256, n_layer=2, n_head=4,
           n_embd=64, n_query_groups=1, intermediate_size=256, parallel_residual=True,
           shared_attention_norm=True, norm_class="LayerNorm", mlp_class="GptNeoxMLP"),
    Config(name="Falcon-7b-like", block_size=2048, vocab_size=65024, n_layer=32, n_head=71,
           n_embd=4544, n_query_groups=1, intermediate_size=18176, parallel_residual=True,
           shared_attention_norm=True, norm_class="LayerNorm", mlp_class="GptNeoxMLP"),
    Config(name="tiny-pythia-debug", block_size=128, vocab_size=256, n_layer=2, n_head=4,
           n_embd=64, intermediate_size=256, parallel_residual=True, norm_class="LayerNorm",
           mlp_class="GptNeoxMLP", bias=True, rotary_percentage=0.25),
    Config(name="Pythia-6.9b-like", block_size=2048, vocab_size=50254, n_layer=32, n_head=32,
           n_embd=4096, intermediate_size=16384, parallel_residual=True, norm_class="LayerNorm",
           mlp_class="GptNeoxMLP", bias=True, rotary_percentage=0.25),
    Config(name="tiny-mistral-debug", block_size=128, vocab_size=256, n_layer=2, n_head=4,
           n_embd=64, n_query_groups=2, intermediate_size=176, sliding_window=32),
    Config(name="Mistral-7B-like", block_size=32768, vocab_size=32000, n_layer=32,
           n_head=32, n_embd=4096, n_query_groups=8, intermediate_size=14336,
           sliding_window=4096),
    Config(name="tiny-moe-debug", block_size=128, vocab_size=256, n_layer=2, n_head=4,
           n_embd=64, n_query_groups=2, intermediate_size=96, mlp_class="LLaMAMoE",
           n_expert=4, n_expert_per_token=2),
    Config(name="mixtral-like", block_size=512, vocab_size=500, n_layer=2, n_head=64,
           n_embd=256, n_query_groups=8, intermediate_size=224, rope_base=1000000,
           mlp_class="LLaMAMoE", n_expert=8, n_expert_per_token=2),
    Config(name="Mixtral-8x7B-like", block_size=32768, vocab_size=32000, n_layer=32,
           n_head=32, n_embd=4096, n_query_groups=8, intermediate_size=14336,
           rope_base=1000000, mlp_class="LLaMAMoE", n_expert=8, n_expert_per_token=2),
]
name_to_config: dict[str, Config] = {c.name: c for c in configs}


def init_params(config: Config, *, generator: torch.Generator | None = None,
                dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """Builds the params dict on ``device`` (default: the card; raises
    without one unless ``device="cpu"``).  Same layout and init scheme as
    the JAX package: linear weights ``(fan_out, fan_in)`` drawn N(0, 0.02)
    in float32 then cast to ``dtype``, norm weights one, biases zero.  A MoE
    block's MLP holds the router ``gate`` (E, C) and the experts stacked on
    a leading E dim: ``fc_1``/``fc_2`` (E, I, C), ``proj`` (E, C, I).
    ``generator`` (default: seed 0) must live on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    hs, nh, ng = config.head_size, config.n_head, config.n_query_groups
    C, I, V = config.n_embd, config.intermediate_size, config.padded_vocab_size
    std = 0.02

    def normal(*shape):
        w = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (w * std).to(dtype)

    def ones(n):
        return torch.ones(n, device=dev, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, device=dev, dtype=dtype)

    params: dict[str, Any] = {"wte": normal(V, C), "blocks": [], "ln_f": ones(C)}
    if config.bias:
        params["ln_f_b"] = zeros(C)
    if config.lm_head_bias:
        params["lm_head_b"] = zeros(V)
    if not config.tie_embeddings:
        params["lm_head"] = normal(V, C)
    if config.learned_pos_embedding:
        params["wpe"] = normal(config.block_size, C)
    for _ in range(config.n_layer):
        block = {
            "norm_1": ones(C),
            "attn": {"wq": normal(nh * hs, C), "wk": normal(ng * hs, C),
                     "wv": normal(ng * hs, C), "wo": normal(C, nh * hs)},
        }
        if config.bias:
            block["norm_1_b"] = zeros(C)
            block["attn"].update(bq=zeros(nh * hs), bk=zeros(ng * hs),
                                 bv=zeros(ng * hs), bo=zeros(C))
        if not config.shared_attention_norm:
            block["norm_2"] = ones(C)
            if config.bias:
                block["norm_2_b"] = zeros(C)
        if config.mlp_class == "LLaMAMoE":
            E = config.n_expert
            block["mlp"] = {"gate": normal(E, C), "fc_1": normal(E, I, C),
                            "fc_2": normal(E, I, C), "proj": normal(E, C, I)}
        elif config.mlp_class in ("LLaMAMLP", "GemmaMLP"):
            block["mlp"] = {"fc_1": normal(I, C), "fc_2": normal(I, C), "proj": normal(C, I)}
            if config.bias:
                block["mlp"].update(fc_1_b=zeros(I), fc_2_b=zeros(I), proj_b=zeros(C))
        else:  # GptNeoxMLP
            block["mlp"] = {"fc": normal(I, C), "proj": normal(C, I)}
            if config.bias:
                block["mlp"].update(fc_b=zeros(I), proj_b=zeros(C))
        params["blocks"].append(block)
    return params


def param_count(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def _llama3_rescale_freqs(theta: torch.Tensor, params: dict) -> torch.Tensor:
    """Llama-3.1 rope rescaling (HF ``ROPE_INIT_FUNCTIONS["llama3"]``):
    wavelengths longer than ``original_max_position_embeddings /
    low_freq_factor`` divide by ``factor``; shorter than ``.../
    high_freq_factor`` stay; the band between interpolates smoothly."""
    factor = float(params["factor"])
    low = float(params.get("low_freq_factor", 1.0))
    high = float(params.get("high_freq_factor", 4.0))
    orig = float(params.get("original_max_position_embeddings", 8192))
    wavelen = 2 * math.pi / theta
    smooth = (orig / wavelen - low) / (high - low)
    return torch.where(
        wavelen > orig / low,          # low-frequency: full stretch
        theta / factor,
        torch.where(
            wavelen < orig / high,     # high-frequency: untouched
            theta,
            (1 - smooth) * theta / factor + smooth * theta,
        ),
    )


def build_rope_cache(config: Config, seq_len: int, dtype=torch.float32,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Precomputed (cos, sin) of shape (seq_len, rope_n_elem), float32 math."""
    n_elem = config.rope_n_elem
    theta = 1.0 / (config.rope_base ** (
        torch.arange(0, n_elem, 2, dtype=torch.float32, device=device) / n_elem))
    if config.rope_scaling_llama3 is not None:
        theta = _llama3_rescale_freqs(theta, dict(config.rope_scaling_llama3))
    seq = torch.arange(seq_len, dtype=torch.float32, device=device) / config.rope_condense_ratio
    idx_theta = torch.outer(seq, theta)                      # (T, n_elem/2)
    idx_theta = torch.cat([idx_theta, idx_theta], dim=-1)    # (T, n_elem)
    return torch.cos(idx_theta).to(dtype), torch.sin(idx_theta).to(dtype)


#
# Block helpers, shared by the training forward below and the serving
# forward (models/generate.py, serving/paged_attention.py)
#


def _linear(x, w, b=None, *, quantized=False):
    """``x @ w.T (+ b)``; ``quantized``: the product by
    ``quantex.int8_linear`` (the bias added after, in x's dtype)."""
    out = int8_linear(x, w) if quantized else F.linear(x, w)
    return out if b is None else out + b


def _norm(x, w, cfg: Config, b=None):
    xf = x.float()
    if cfg.norm_class == "RMSNorm":
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(ms + cfg.norm_eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    out = xf * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def apply_rope(x, cos, sin):
    # x: (B, h, T, n_elem); cos/sin: broadcastable (.., T, n_elem) float32
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


def _lora_delta(x, a, b, scaling, slots=None):
    """Per-request LoRA delta ``scaling * B(A(x))``, one adapter per batch
    row (``_lora_delta``, reference ``models/generate.py:123``): ``x``
    (B, T, fin), ``a`` (B, r, fin), ``b`` (B, fout, r) → (B, T, fout).  With
    ``slots`` ((B,) integer adapter slots) ``a``/``b`` are the registry's
    (S, r, fin)/(S, fout, r) arenas, and each row's factors are taken by its
    slot first.  The factors are cast to x's dtype; ``scaling`` takes x's
    dtype too, as the reference's weakly typed scalar does.  Row ``i``'s
    delta depends only on row ``i``, so a request's math is the same
    whatever shares its batch."""
    if slots is not None:
        idx = slots.long()
        a, b = a.index_select(0, idx), b.index_select(0, idx)
    d = torch.matmul(x, a.to(x.dtype).transpose(-1, -2))
    o = torch.matmul(d, b.to(x.dtype).transpose(-1, -2))
    return o * _as_dtype_scalar(scaling, x.dtype)


def _experts(mp, x, w, lin):
    """The dense expert sum ``sum_e w[..., e] * proj_e(silu(fc_1e x) *
    fc_2e x)`` in expert order, each routing weight cast to x's dtype."""
    y = None
    for e in range(mp["gate"].shape[0]):
        xe = lin(F.silu(lin(x, mp["fc_1"][e])) * lin(x, mp["fc_2"][e]), mp["proj"][e])
        contrib = xe * w[e].unsqueeze(-1).to(x.dtype)
        y = contrib if y is None else y + contrib
    return y


def _route(router, k: int, E: int):
    """Per-expert routing weights from the router logits: top-k (ties to
    the lower index), softmax over the k in float32, and for each expert
    the sum of its probabilities over the k slots (0 where unselected)."""
    top_logits, top_idx = ltorch.topk(router, k, -1)
    probs = torch.softmax(top_logits.to(torch.float32), dim=-1)
    return [torch.sum(probs * (top_idx == e).to(torch.float32), dim=-1) for e in range(E)]


def moe_mlp(mp, x, config: Config):
    """The training MoE MLP (reference ``models/llama.py:438 moe_mlp``):
    router logits ``linear(x, gate)`` in x's dtype, top-k, softmax over
    the selected k in float32, the dense expert sum.  Written in torch
    calls, so it traces into the torch language under ``jit`` and the
    train step."""
    w = _route(F.linear(x, mp["gate"]), config.n_expert_per_token, config.n_expert)
    return _experts(mp, x, w, _linear)


def mlp(mp, x, cfg: Config, *, lora=None, lora_scaling=1.0, delta_fn=None, quantized=False):
    """The serving block's MLP (reference ``_mlp``, ``models/generate.py:82``).
    ``lora``: optional ``{target: (a, b)}`` per-request factors of this
    layer; a targeted matmul adds the plain delta of its own input, through
    ``delta_fn(x, a, b, scaling)`` where given (the plain delta reading
    arenas by slot).  A MoE MLP routes in float32 (``x.float() @
    gate.float().T``) and takes no LoRA targets.  ``quantized``: every
    weight matmul through ``int8_linear``, the router excepted."""
    delta_fn = _lora_delta if delta_fn is None else delta_fn

    def lin(inp, w, b=None):
        return _linear(inp, w, b, quantized=quantized)

    def ll(name, inp, bias=None):
        o = lin(inp, mp[name], mp.get(bias) if bias else None)
        if lora is not None and name in lora:
            o = o + delta_fn(inp, *lora[name], lora_scaling)
        return o

    if cfg.mlp_class == "LLaMAMoE":
        router = torch.matmul(x.float(), mp["gate"].float().T)
        return _experts(mp, x, _route(router, cfg.n_expert_per_token, cfg.n_expert), lin)
    if cfg.mlp_class == "LLaMAMLP":
        return ll("proj", F.silu(ll("fc_1", x, "fc_1_b")) * ll("fc_2", x, "fc_2_b"), "proj_b")
    approx = "tanh" if cfg.gelu_approximate == "tanh" else "none"
    if cfg.mlp_class == "GemmaMLP":
        return ll("proj", F.gelu(ll("fc_1", x, "fc_1_b"), approximate=approx)
                  * ll("fc_2", x, "fc_2_b"), "proj_b")
    return ll("proj", F.gelu(ll("fc", x, "fc_b"), approximate=approx), "proj_b")


def _project_qkv(ap, x, cos_t, sin_t, cfg: Config, *, lora=None, lora_scaling=1.0,
                 delta_fn=None, quantized=False):
    """QKV projections + partial rotary for new tokens: x (B, T, C) →
    q (B, nh, T, hs), k/v (B, ng, T, hs) — K/V stay at the grouped head
    count.  ``lora``: optional ``{target: (a, b)}`` factors of this layer;
    ``delta_fn(x, a, b, scaling)`` computes a target's delta (default the
    plain :func:`_lora_delta`; the serving kernel path passes
    ``cudaex.lora_delta_fused``; either may read arenas by slot).
    ``quantized``: the projections through ``int8_linear``."""
    B, T, _ = x.shape
    hs, nh, ng = cfg.head_size, cfg.n_head, cfg.n_query_groups
    delta_fn = _lora_delta if delta_fn is None else delta_fn

    def proj(name, bias):
        o = _linear(x, ap[name], ap.get(bias), quantized=quantized)
        if lora is not None and name in lora:
            o = o + delta_fn(x, *lora[name], lora_scaling)
        return o

    q = proj("wq", "bq").reshape(B, T, nh, hs).transpose(1, 2)
    k = proj("wk", "bk").reshape(B, T, ng, hs).transpose(1, 2)
    v = proj("wv", "bv").reshape(B, T, ng, hs).transpose(1, 2)
    n_elem = cfg.rope_n_elem
    if n_elem > 0:
        q_r = apply_rope(q[..., :n_elem], cos_t, sin_t)
        k_r = apply_rope(k[..., :n_elem], cos_t, sin_t)
        q = torch.cat([q_r, q[..., n_elem:]], dim=-1) if n_elem < hs else q_r
        k = torch.cat([k_r, k[..., n_elem:]], dim=-1) if n_elem < hs else k_r
    return q, k, v



#
# Training forward (thunder_tpu/models/llama.py:372-533)
#


def _hook_delta(x, a, b, scaling):
    """The single-adapter hook's delta ``B(A(x))`` (a (r, fin), b (fout, r);
    any scaling is folded into b)."""
    return _linear(_linear(x, a), b)


def attention(ap, x, cos, sin, config: Config):
    """Causal self-attention of one block: x (B, T, C) → (B, T, C).  GQA
    K/V go to the SDPA op at the grouped head count (the flash kernels
    gather each group by index).  ``ap["lora"]``: the optional
    single-adapter hook ``{target: (a, b)}`` (reference
    ``models/llama.py:396-407``), whose ``B(A(x))`` rides next to each
    target's matmul."""
    B, T, _ = x.shape
    hook = ap.get("lora") or None
    q, k, v = _project_qkv(ap, x, cos, sin, config, lora=hook, delta_fn=_hook_delta)
    y = ltorch.scaled_dot_product_attention(q, k, v, is_causal=True,
                                            sliding_window=config.sliding_window)
    y = y.transpose(1, 2).reshape(B, T, config.n_head * config.head_size)
    out = _linear(y, ap["wo"], ap.get("bo"))
    if hook is not None and "wo" in hook:
        out = out + _hook_delta(y, *hook["wo"], 1.0)
    return out


def block_forward(bp, x, cos, sin, config: Config):
    ff = moe_mlp if config.mlp_class == "LLaMAMoE" else mlp
    n1 = _norm(x, bp["norm_1"], config, bp.get("norm_1_b"))
    h = attention(bp["attn"], n1, cos, sin, config)
    if config.parallel_residual:
        n2 = n1 if config.shared_attention_norm else _norm(x, bp["norm_2"], config,
                                                            bp.get("norm_2_b"))
        return x + h + ff(bp["mlp"], n2, config)
    x = x + h
    return x + ff(bp["mlp"], _norm(x, bp["norm_2"], config, bp.get("norm_2_b")), config)


def gpt_hidden(params, idx, cos, sin, config: Config):
    """Token ids (B, T) → final hidden states (B, T, C) (pre-head)."""
    x = F.embedding(idx.long(), params["wte"])
    if config.scale_embedding:
        x = x * (config.n_embd ** 0.5)
    if config.learned_pos_embedding:
        x = x + params["wpe"][:idx.shape[1]]
    for bp in params["blocks"]:
        x = remat.run_block(block_forward, bp, x, cos, sin, config)
    return _norm(x, params["ln_f"], config, params.get("ln_f_b"))


def gpt_forward(params, idx, cos, sin, config: Config):
    """Token ids (B, T) → logits (B, T, padded_vocab_size)."""
    x = gpt_hidden(params, idx, cos, sin, config)
    head = params["wte"] if config.tie_embeddings else params["lm_head"]
    return _linear(x, head, params.get("lm_head_b"))


def gpt_loss(params, idx, targets, cos, sin, config: Config):
    """Next-token cross-entropy over the padded vocab, float32 accumulation;
    targets of ``-100`` are ignored with exact mean normalization.
    ``fused_head_ce`` configs take the lm head and the loss in one op that
    never holds the (B·T, V) logits (``ltorch.fused_linear_cross_entropy``)."""
    if config.fused_head_ce:
        x = gpt_hidden(params, idx, cos, sin, config)
        head = params["wte"] if config.tie_embeddings else params["lm_head"]
        C = x.shape[-1]
        return ltorch.fused_linear_cross_entropy(x.reshape(-1, C), head, targets.reshape(-1))
    logits = gpt_forward(params, idx, cos, sin, config)
    V = logits.shape[-1]
    return ltorch.cross_entropy(logits.reshape(-1, V).to(torch.float32), targets.reshape(-1))


def _bucket_up(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def batch_bucketer(config: Config, *, min_b: int = 1, min_t: int = 16):
    """Pads ``(idx, targets, cos, sin)`` batches up to power-of-two (B, T)
    buckets so one built program serves every shape inside a bucket
    (reference ``thunder_tpu/models/llama.py:543``): the program count grows
    with the log of the shape range.

    Exact: padded positions sit at the sequence tail (causal attention —
    valid tokens never attend them), padded targets are ``-100`` (ignored
    with exact mean normalization in :func:`gpt_loss`), and the rope caches
    are rebuilt for the bucketed T.  Pass to ``make_train_step(bucketer=...)``."""
    rope_cache: dict = {}

    def bucket(batch):
        idx, targets, cos, sin = batch
        B, T = idx.shape
        B2, T2 = _bucket_up(B, min_b), _bucket_up(T, min_t)
        if (B2, T2) == (B, T):
            return batch
        pad = (0, T2 - T, 0, B2 - B)
        idx2 = torch.nn.functional.pad(idx, pad)
        tgt2 = torch.nn.functional.pad(targets, pad, value=-100)
        key = (T2, cos.dtype, cos.device)
        if key not in rope_cache:
            rope_cache[key] = build_rope_cache(config, T2, dtype=cos.dtype, device=cos.device)
        cos2, sin2 = rope_cache[key]
        return idx2, tgt2, cos2, sin2

    return bucket
