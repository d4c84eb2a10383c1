"""Load HuggingFace checkpoints' state dicts into the port's params.

Counterpart of ``thunder_tpu/models/hf_weights.py``.  The mapping is direct
per family: Llama/Mistral/Gemma state dicts share the params' layout
(rotate-half rope, separate q/k/v, gated MLP), so conversion is a key
rename plus vocab padding; GPT-2 undoes Conv1D transposes and the packed
``c_attn``; GPT-NeoX/Pythia and Falcon unpack their fused
``query_key_value`` layouts (per-head interleaved and grouped
respectively).  The converters read a local state dict (torch tensors or
numpy arrays) and need neither ``transformers`` nor a download; each leaf
is copied onto ``device`` (default: the card; ``device="cpu"`` on the CPU)
in ``dtype``, a torch dtype.  Values pass through float32 before the cast,
as the reference's numpy path does, so the params equal the reference's
bit for bit.

Usage::

    from transformers import AutoModelForCausalLM
    m = AutoModelForCausalLM.from_pretrained("meta-llama/Llama-2-7b-hf")
    cfg = config_from_hf(m.config)
    params = from_hf_state_dict(m.state_dict(), cfg)
    logits = ttt.jit(lambda p, i, c, s: llama.gpt_forward(p, i, c, s, cfg))(...)
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.models.llama import Config

__all__ = [
    "config_from_hf",
    "from_hf_state_dict",
    "from_gpt2_state_dict",
    "from_gpt_neox_state_dict",
    "from_falcon_state_dict",
]


def config_from_hf(hf_config: Any, **overrides) -> Config:
    """Builds a :class:`Config` from a HF ``LlamaConfig``/``MistralConfig``/
    ``GPT2Config``."""
    mt = getattr(hf_config, "model_type", "llama")
    if mt == "gpt2":
        return _gpt2_config(hf_config, overrides)
    if mt == "gpt_neox":
        return _gpt_neox_config(hf_config, overrides)
    if mt == "falcon":
        return _falcon_config(hf_config, overrides)
    if mt not in ("llama", "mistral", "gemma"):
        raise ValueError(
            f"unsupported HF model_type {mt!r} "
            "(llama/mistral/gemma/gpt2/gpt_neox/falcon family only)"
        )
    # reject config knobs the functional model does not implement — silent
    # acceptance would convert cleanly and return wrong logits
    scaling = getattr(hf_config, "rope_scaling", None)
    condense = 1.0
    llama3_scaling = None
    if scaling:
        stype = scaling.get("rope_type", scaling.get("type"))
        if stype == "linear":
            condense = float(scaling["factor"])
        elif stype == "llama3":
            llama3_scaling = dict(scaling)
        else:
            raise ValueError(
                f"unsupported rope_scaling {stype!r}: 'linear' maps onto "
                "rope_condense_ratio and 'llama3' onto rope_scaling_llama3; "
                "yarn/dynamic scaling is not implemented"
            )
    for knob in ("attention_bias", "mlp_bias"):
        if getattr(hf_config, knob, False):
            raise ValueError(f"unsupported HF config {knob}=True: the functional model has no biases")
    act = getattr(hf_config, "hidden_act", "silu")
    if mt == "gemma":
        # gemma: gelu-gated MLP, tied + sqrt(d)-scaled embeddings; the
        # RMSNorm (1 + w) offset folds into the weights at load time
        if act not in ("gelu", "gelu_pytorch_tanh"):
            raise ValueError(f"unsupported gemma hidden_act {act!r}")
        gemma_kw = dict(
            mlp_class="GemmaMLP",
            gelu_approximate="tanh" if act == "gelu_pytorch_tanh" else "none",
            scale_embedding=True,
        )
    else:
        if act not in ("silu", "swish"):
            raise ValueError(f"unsupported hidden_act {act!r}: the LLaMAMLP path is SwiGLU (silu)")
        gemma_kw = {}
    kw = dict(
        name=f"hf-{mt}",
        **gemma_kw,
        block_size=int(hf_config.max_position_embeddings),
        vocab_size=int(hf_config.vocab_size),
        padded_vocab_size=int(hf_config.vocab_size),  # HF head is exactly vocab-sized
        n_layer=int(hf_config.num_hidden_layers),
        n_head=int(hf_config.num_attention_heads),
        n_embd=int(hf_config.hidden_size),
        n_query_groups=int(getattr(hf_config, "num_key_value_heads", None)
                           or hf_config.num_attention_heads),
        intermediate_size=int(hf_config.intermediate_size),
        rope_base=int(getattr(hf_config, "rope_theta", 10000)),
        rope_condense_ratio=condense,
        rope_scaling_llama3=llama3_scaling,
        norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-5)),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        sliding_window=(int(hf_config.sliding_window)
                        if getattr(hf_config, "sliding_window", None) else None),
        head_size=(int(hf_config.head_dim)
                   if getattr(hf_config, "head_dim", None) else None),
    )
    kw.update(overrides)
    return Config(**kw)


def _gpt2_config(hf_config: Any, overrides: dict) -> Config:
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported GPT-2 activation {act!r}")
    # logit-changing attention variants the functional model does not
    # implement: silent acceptance would convert cleanly and be wrong
    if getattr(hf_config, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("unsupported GPT2Config scale_attn_by_inverse_layer_idx=True")
    if not getattr(hf_config, "scale_attn_weights", True):
        raise ValueError("unsupported GPT2Config scale_attn_weights=False")
    if getattr(hf_config, "add_cross_attention", False):
        raise ValueError("unsupported GPT2Config add_cross_attention=True")
    if getattr(hf_config, "reorder_and_upcast_attn", False):
        raise ValueError("unsupported GPT2Config reorder_and_upcast_attn=True")
    kw = dict(
        name="hf-gpt2",
        block_size=int(hf_config.n_positions),
        vocab_size=int(hf_config.vocab_size),
        padded_vocab_size=int(hf_config.vocab_size),
        n_layer=int(hf_config.n_layer),
        n_head=int(hf_config.n_head),
        n_embd=int(hf_config.n_embd),
        intermediate_size=int(getattr(hf_config, "n_inner", None) or 4 * hf_config.n_embd),
        norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
        rotary_percentage=0.0,
        learned_pos_embedding=True,
        norm_class="LayerNorm",
        mlp_class="GptNeoxMLP",
        tie_embeddings=True,
        bias=True,
        gelu_approximate="none" if act == "gelu" else "tanh",
    )
    kw.update(overrides)
    return Config(**kw)


def _gpt_neox_config(hf_config: Any, overrides: dict) -> Config:
    """GPT-NeoX / Pythia: biased LayerNorm + linears, partial rotary,
    parallel residual (reference zoo's pythia rows)."""
    act = getattr(hf_config, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported gpt_neox hidden_act {act!r}")
    if not getattr(hf_config, "use_parallel_residual", True):
        raise ValueError("unsupported GPTNeoXConfig use_parallel_residual=False")
    kw = dict(
        name="hf-gpt_neox",
        block_size=int(hf_config.max_position_embeddings),
        vocab_size=int(hf_config.vocab_size),
        padded_vocab_size=int(hf_config.vocab_size),
        n_layer=int(hf_config.num_hidden_layers),
        n_head=int(hf_config.num_attention_heads),
        n_embd=int(hf_config.hidden_size),
        intermediate_size=int(hf_config.intermediate_size),
        norm_eps=float(getattr(hf_config, "layer_norm_eps", 1e-5)),
        rotary_percentage=float(getattr(hf_config, "rotary_pct", 0.25)),
        rope_base=int(getattr(hf_config, "rotary_emb_base", None)
                      or getattr(hf_config, "rope_theta", 10000)),
        parallel_residual=True,
        norm_class="LayerNorm",
        mlp_class="GptNeoxMLP",
        bias=True,
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        gelu_approximate="none" if act == "gelu" else "tanh",
    )
    kw.update(overrides)
    return Config(**kw)


def from_gpt_neox_state_dict(sd: Mapping[str, Any], cfg: Config, dtype=torch.bfloat16,
                            device="cuda") -> dict:
    """Converts a HF ``GPTNeoXForCausalLM`` state dict.  NeoX fuses q/k/v
    into one ``query_key_value`` with a PER-HEAD interleave —
    (nh, 3, hs, C) — undone here."""
    get = _getter(sd, "gpt_neox.", "GPT-NeoX")
    leaf = _leaf_fn(dtype, device)
    C, nh = cfg.n_embd, cfg.n_head
    hs = cfg.head_size
    params: dict = {
        "wte": leaf(_pad_vocab(get("embed_in.weight"), cfg.padded_vocab_size)),
        "ln_f": leaf(get("final_layer_norm.weight")),
        "ln_f_b": leaf(get("final_layer_norm.bias")),
        "blocks": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf(
            _pad_vocab(_to_f32(sd["embed_out.weight"]), cfg.padded_vocab_size))
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        qkv_w = get(p + "attention.query_key_value.weight").reshape(nh, 3, hs, C)
        qkv_b = get(p + "attention.query_key_value.bias").reshape(nh, 3, hs)
        params["blocks"].append({
            "norm_1": leaf(get(p + "input_layernorm.weight")),
            "norm_1_b": leaf(get(p + "input_layernorm.bias")),
            "attn": {
                "wq": leaf(qkv_w[:, 0].reshape(nh * hs, C)),
                "wk": leaf(qkv_w[:, 1].reshape(nh * hs, C)),
                "wv": leaf(qkv_w[:, 2].reshape(nh * hs, C)),
                "bq": leaf(qkv_b[:, 0].reshape(nh * hs)),
                "bk": leaf(qkv_b[:, 1].reshape(nh * hs)),
                "bv": leaf(qkv_b[:, 2].reshape(nh * hs)),
                "wo": leaf(get(p + "attention.dense.weight")),
                "bo": leaf(get(p + "attention.dense.bias")),
            },
            "norm_2": leaf(get(p + "post_attention_layernorm.weight")),
            "norm_2_b": leaf(get(p + "post_attention_layernorm.bias")),
            "mlp": {
                "fc": leaf(get(p + "mlp.dense_h_to_4h.weight")),
                "fc_b": leaf(get(p + "mlp.dense_h_to_4h.bias")),
                "proj": leaf(get(p + "mlp.dense_4h_to_h.weight")),
                "proj_b": leaf(get(p + "mlp.dense_4h_to_h.bias")),
            },
        })
    return params


def _falcon_config(hf_config: Any, overrides: dict) -> Config:
    """Falcon: MQA/GQA, parallel residual with one shared attention norm
    (7B layout); rotary over the full head."""
    if not getattr(hf_config, "parallel_attn", True):
        raise ValueError("unsupported FalconConfig parallel_attn=False")
    if getattr(hf_config, "alibi", False):
        raise ValueError("unsupported FalconConfig alibi=True (rope only)")
    if getattr(hf_config, "bias", False):
        # HF gates falcon's linear biases on config.bias; the converter reads
        # no linear-bias keys, so accepting would silently drop them
        raise ValueError("unsupported FalconConfig bias=True")
    new_arch = bool(getattr(hf_config, "new_decoder_architecture", False))
    # Falcon2-11B ships new_decoder_architecture with ONE layernorm
    # (num_ln_in_parallel_attn=1) — that is exactly the shared-norm layout
    n_ln = int(getattr(hf_config, "num_ln_in_parallel_attn", None) or (2 if new_arch else 1))
    if new_arch:
        ng = int(getattr(hf_config, "num_kv_heads", None) or hf_config.num_attention_heads)
    else:
        ng = 1 if getattr(hf_config, "multi_query", True) else int(hf_config.num_attention_heads)
    kw = dict(
        name="hf-falcon",
        block_size=int(hf_config.max_position_embeddings),
        vocab_size=int(hf_config.vocab_size),
        padded_vocab_size=int(hf_config.vocab_size),
        n_layer=int(hf_config.num_hidden_layers),
        n_head=int(hf_config.num_attention_heads),
        n_embd=int(hf_config.hidden_size),
        n_query_groups=ng,
        intermediate_size=int(getattr(hf_config, "ffn_hidden_size", None)
                              or 4 * hf_config.hidden_size),
        norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
        rope_base=int(getattr(hf_config, "rope_theta", 10000)),
        parallel_residual=True,
        shared_attention_norm=n_ln == 1,
        norm_class="LayerNorm",
        mlp_class="GptNeoxMLP",
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", True)),
        gelu_approximate="none",
    )
    kw.update(overrides)
    return Config(**kw)


def from_falcon_state_dict(sd: Mapping[str, Any], cfg: Config, dtype=torch.bfloat16,
                            device="cuda") -> dict:
    """Converts a HF ``FalconForCausalLM`` state dict.  Falcon fuses q/k/v
    into ``query_key_value`` grouped as (ng, nh/ng + 2, hs, C) — each KV
    group's queries ride with its k and v — undone here.  LayerNorms carry
    biases even though the linears do not; the pytree is the source of
    truth, so the norm biases load without a global ``bias`` flag."""
    get = _getter(sd, "transformer.", "Falcon")
    leaf = _leaf_fn(dtype, device)
    C, nh, ng, hs = cfg.n_embd, cfg.n_head, cfg.n_query_groups, cfg.head_size
    per_g = nh // ng
    params: dict = {
        "wte": leaf(_pad_vocab(get("word_embeddings.weight"), cfg.padded_vocab_size)),
        "ln_f": leaf(get("ln_f.weight")),
        "ln_f_b": leaf(get("ln_f.bias")),
        "blocks": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf(
            _pad_vocab(_to_f32(sd["lm_head.weight"]), cfg.padded_vocab_size))
    for i in range(cfg.n_layer):
        p = f"h.{i}."
        qkv = get(p + "self_attention.query_key_value.weight").reshape(ng, per_g + 2, hs, C)
        block: dict = {
            "attn": {
                "wq": leaf(qkv[:, :per_g].reshape(nh * hs, C)),
                "wk": leaf(qkv[:, per_g].reshape(ng * hs, C)),
                "wv": leaf(qkv[:, per_g + 1].reshape(ng * hs, C)),
                "wo": leaf(get(p + "self_attention.dense.weight")),
            },
            "mlp": {
                "fc": leaf(get(p + "mlp.dense_h_to_4h.weight")),
                "proj": leaf(get(p + "mlp.dense_4h_to_h.weight")),
            },
        }
        if cfg.shared_attention_norm:
            block["norm_1"] = leaf(get(p + "input_layernorm.weight"))
            block["norm_1_b"] = leaf(get(p + "input_layernorm.bias"))
        else:  # new decoder architecture: separate attention/mlp norms
            block["norm_1"] = leaf(get(p + "ln_attn.weight"))
            block["norm_1_b"] = leaf(get(p + "ln_attn.bias"))
            block["norm_2"] = leaf(get(p + "ln_mlp.weight"))
            block["norm_2_b"] = leaf(get(p + "ln_mlp.bias"))
        params["blocks"].append(block)
    return params


def from_gpt2_state_dict(sd: Mapping[str, Any], cfg: Config, dtype=torch.bfloat16,
                            device="cuda") -> dict:
    """Converts a HF ``GPT2LMHeadModel`` state dict.  GPT-2 stores Conv1D
    weights as (in, out) — transposed vs nn.Linear — and packs q/k/v into one
    ``c_attn``; both are undone here."""
    get = _getter(sd, "transformer.", "GPT-2")
    leaf = _leaf_fn(dtype, device)
    C = cfg.n_embd
    params: dict = {
        "wte": leaf(_pad_vocab(get("wte.weight"), cfg.padded_vocab_size)),
        "wpe": leaf(get("wpe.weight")),
        "ln_f": leaf(get("ln_f.weight")),
        "ln_f_b": leaf(get("ln_f.bias")),
        "blocks": [],
    }
    for i in range(cfg.n_layer):
        p = f"h.{i}."
        ca_w = get(p + "attn.c_attn.weight").T  # (3C, C)
        ca_b = get(p + "attn.c_attn.bias")  # (3C,)
        params["blocks"].append({
            "norm_1": leaf(get(p + "ln_1.weight")),
            "norm_1_b": leaf(get(p + "ln_1.bias")),
            "attn": {
                "wq": leaf(ca_w[:C]),
                "wk": leaf(ca_w[C:2 * C]),
                "wv": leaf(ca_w[2 * C:]),
                "bq": leaf(ca_b[:C]),
                "bk": leaf(ca_b[C:2 * C]),
                "bv": leaf(ca_b[2 * C:]),
                "wo": leaf(get(p + "attn.c_proj.weight").T),
                "bo": leaf(get(p + "attn.c_proj.bias")),
            },
            "norm_2": leaf(get(p + "ln_2.weight")),
            "norm_2_b": leaf(get(p + "ln_2.bias")),
            "mlp": {
                "fc": leaf(get(p + "mlp.c_fc.weight").T),
                "fc_b": leaf(get(p + "mlp.c_fc.bias")),
                "proj": leaf(get(p + "mlp.c_proj.weight").T),
                "proj_b": leaf(get(p + "mlp.c_proj.bias")),
            },
        })
    return params


def _getter(sd: Mapping[str, Any], prefix: str, family: str):
    """Key lookup with the family's optional container prefix; the value in
    float32 on the CPU."""

    def get(name: str) -> torch.Tensor:
        for k in (name, f"{prefix}{name}"):
            if k in sd:
                return _to_f32(sd[k])
        raise KeyError(f"{family} checkpoint is missing {name!r}")

    return get


def _to_f32(t) -> torch.Tensor:
    """A state-dict value (torch tensor or numpy array) as a float32 CPU
    tensor: exact for bfloat16, float16 and float32 values."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32)
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16-bit patterns
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _leaf_fn(dtype: torch.dtype, device):
    """float32 CPU value → an owned, contiguous param leaf in ``dtype`` on
    ``device``."""
    dev = resolve_device(device)

    def leaf(x: torch.Tensor) -> torch.Tensor:
        return x.to(device=dev, dtype=dtype, copy=True).contiguous()

    return leaf


def _pad_vocab(x: torch.Tensor, padded: int) -> torch.Tensor:
    if x.shape[0] == padded:
        return x
    out = torch.zeros((padded,) + tuple(x.shape[1:]), dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def from_hf_state_dict(sd: Mapping[str, Any], cfg: Config, dtype=torch.bfloat16,
                            device="cuda") -> dict:
    """Converts a HF Llama/Mistral/Gemma ``state_dict`` into the
    ``models/llama.init_params`` layout (wq/wk/wv/wo, fc_1/fc_2/proj).

    Handles the optional ``model.`` prefix, vocab padding to
    ``cfg.padded_vocab_size``, and tied embeddings (no ``lm_head.weight``)."""
    get = _getter(sd, "model.", "HF")
    leaf = _leaf_fn(dtype, device)

    # gemma's RMSNorm computes x_norm * (1 + w): fold the unit offset into
    # the stored weights so models/llama's plain w-multiply norm matches.
    # The folded (1 + w) multiplier stays in float32: rounding it to bf16
    # would cost ~2^-8 relative precision on the whole scale (w sits near
    # 0, so bf16(1 + w) loses what bf16(w) alone keeps); the norm upcasts
    # weights to its float32 computation dtype, so float32 storage is free.
    off = 1.0 if cfg.mlp_class == "GemmaMLP" else 0.0
    norm_leaf = _leaf_fn(torch.float32 if off else dtype, device)

    def norm(name: str) -> torch.Tensor:
        return norm_leaf(get(name) + off)

    wte = _pad_vocab(get("embed_tokens.weight"), cfg.padded_vocab_size)
    blocks = []
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        blocks.append({
            "norm_1": norm(p + "input_layernorm.weight"),
            "attn": {
                "wq": leaf(get(p + "self_attn.q_proj.weight")),
                "wk": leaf(get(p + "self_attn.k_proj.weight")),
                "wv": leaf(get(p + "self_attn.v_proj.weight")),
                "wo": leaf(get(p + "self_attn.o_proj.weight")),
            },
            "norm_2": norm(p + "post_attention_layernorm.weight"),
            "mlp": {
                "fc_1": leaf(get(p + "mlp.gate_proj.weight")),
                "fc_2": leaf(get(p + "mlp.up_proj.weight")),
                "proj": leaf(get(p + "mlp.down_proj.weight")),
            },
        })
    params = {
        "wte": leaf(wte),
        "blocks": blocks,
        "ln_f": norm("norm.weight"),
    }
    if not cfg.tie_embeddings:
        head = sd.get("lm_head.weight")
        if head is None:
            raise KeyError("HF checkpoint has no lm_head.weight and tie_embeddings is False")
        params["lm_head"] = leaf(_pad_vocab(_to_f32(head), cfg.padded_vocab_size))
    return params
