"""The bytecode frontend on the card (``cuda``-marked; they skip without one).

``chip_smoke.py``'s ``user_loss`` (phase 19's user-code Llama loss, its
weights read from a global dict) over a small Llama-3-style config the
flash kernels take (head size 64, T=128), bf16 weights on the card:

- one call launches ``flash_fwd`` once per layer and ``flash_ce`` once,
  with no decline, every weight and both rope tables captured, and the loss
  bitwise ``jit(gpt_loss)``'s;
- a CPU tensor swapped into the dict fails the prologue's device guard: a
  retrace, never a kernel on a CPU pointer; the card's tensor put back is
  a cache hit with the first loss.

This file imports no JAX: run it on the card with
``python -m pytest tests/test_torch_port_bytecode_cuda.py -m cuda``.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
import thunder_tpu_torch as ttt
from thunder_tpu_torch import ltorch
from thunder_tpu_torch._tree import tree_leaves
from thunder_tpu_torch.models import llama
from torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels run on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny(card, monkeypatch):
    cfg = llama.Config.from_name("tiny-llama-debug", n_embd=256, n_head=4, n_query_groups=2,
                                 block_size=128)
    gen = torch.Generator(device=card).manual_seed(0)
    params = llama.init_params(cfg, generator=gen, dtype=torch.bfloat16, device=card)
    cos, sin = llama.build_rope_cache(cfg, 128, device=card)
    monkeypatch.setattr(chip_smoke, "BYTECODE_CFG", cfg)
    monkeypatch.setattr(chip_smoke, "BYTECODE_STATE", {"params": params, "cos": cos, "sin": sin})
    idx = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device=card)
    tgt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device=card)
    return cfg, params, cos, sin, idx, tgt


@pytest.mark.cuda
def test_cuda_captured_weights_launch_the_kernels(tiny):
    from thunder_tpu_torch.executors import cudaex

    cfg, params, cos, sin, idx, tgt = tiny
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    jfn = ttt.jit(chip_smoke.user_loss, interpretation="bytecode")
    cudaex.reset_launches()
    loss = jfn(idx, tgt)
    torch.cuda.synchronize()
    assert cudaex.LAUNCHES["flash_fwd"] == cfg.n_layer
    assert cudaex.LAUNCHES["flash_ce"] == 1
    assert not any(ltorch.DECLINES.values())
    state = ttt.compile_stats(jfn).interpreter_cache[0].key_meta["state"]
    assert state["n_state_tensors"] == len(tree_leaves(params)) + 2
    want = ttt.jit(lambda p, i, t, c, s: llama.gpt_loss(p, i, t, c, s, cfg))(
        params, idx, tgt, cos, sin)
    assert torch.equal(loss, want)


@pytest.mark.cuda
def test_cuda_cpu_tensor_in_the_global_retraces(tiny):
    from thunder_tpu_torch.executors import cudaex

    cfg, params, cos, sin, idx, tgt = tiny
    jfn = ttt.jit(chip_smoke.user_loss, interpretation="bytecode")
    loss = jfn(idx, tgt)
    w = params["blocks"][0]["attn"]["wq"]      # read before the first attention
    params["blocks"][0]["attn"]["wq"] = w.cpu()
    cudaex.reset_launches()
    try:
        out = jfn(idx, tgt)
    except RuntimeError as e:
        assert "device" in str(e).lower() or "cpu" in str(e).lower(), e
    else:
        assert out.device.type == "cuda" and torch.equal(out, loss)
    torch.cuda.synchronize()
    assert ttt.cache_misses(jfn) == 2
    assert ttt.compile_stats(jfn).guard_evictions == 1
    assert cudaex.LAUNCHES["flash_fwd"] == 0
    params["blocks"][0]["attn"]["wq"] = w
    assert torch.equal(jfn(idx, tgt), loss)
    assert ttt.cache_misses(jfn) == 2
