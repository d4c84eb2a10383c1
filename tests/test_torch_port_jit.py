"""The port's ``jit`` and its dispatch cache against the JAX package's, on
the CPU.

- ``BASELINE.json`` config 1: ``jit`` of an elementwise add claimed by the
  torch executor alone against the reference's eager-JAX claim: the same
  values and the same printed program (package and executor names
  normalized);
- the dispatch-cache scenarios of ``tests/test_dispatch_cache.py`` (key hit
  and miss; shape, dtype and number changes; the LRU bound and no bound;
  guard shadowing and its recovery by scan; ``NO_CACHING``;
  ``SYMBOLIC_VALUES``; unkeyable inputs) run as one call sequence through
  both packages: every output, ``cache_hits``, ``cache_misses`` and every
  ``dispatch_stats()`` counter equal after each step;
- ``jit(gpt_loss)`` of tiny-llama-debug and of each other model family's
  tiny config, weights made with numpy and carried by
  ``params_from_numpy``: within 1e-5 relative of ``tt.jit`` of the
  reference's ``gpt_loss`` and within 1e-6 of the port's eager
  ``gpt_loss``; the parameters stay inputs (the prologue guards every leaf)
  and the trace claims the SDPA and cross-entropy prims;
- a 32-layer tiny config compiles in a time that grows with the layer count
  and no faster (the guard against a pass quadratic in the trace length);
- each option that waits for a later ``ROADMAP.md`` item raises
  ``NotImplementedError`` naming it (the transforms' ``grad``,
  ``value_and_grad``, ``vjp`` and ``autocast=`` run since they were
  ported: ``tests/test_torch_port_transforms.py``; ``jit(..., donate=)``
  since donation was: ``tests/test_torch_port_donation.py``, and the
  donation option still waiting is ``TrainStep``'s ``donate_batch=``;
  ``profile=``, ``detect_anomalies=``, ``debug_hooks=`` and a
  ``torch.nn.Module`` since the profiler, the debug hooks and the module
  bridge were: ``tests/test_torch_port_profiler.py`` and
  ``tests/test_torch_port_interop.py``; ``interpretation="bytecode"``
  since the interpreter was: ``tests/test_torch_port_bytecode.py``).
"""
from __future__ import annotations

import copy
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu.core import cache_key as rcache_key
from thunder_tpu.models import llama as jllama
from thunder_tpu_torch.core import cache_key as pcache_key
from thunder_tpu_torch.models import llama as tllama
from torch_port_threads import one_torch_thread  # noqa: F401

SEED = 0


@pytest.fixture(autouse=True)
def _leave_jax_caches_as_found():
    """The JAX package's module caches, which other files count entries of."""
    from thunder_tpu.models import generate as jgen
    from thunder_tpu.serving import engine as jengine

    before = dict(jgen._generate_cache), dict(jengine._program_cache)
    yield
    for cache, saved in zip((jgen._generate_cache, jengine._program_cache), before):
        cache.clear()
        cache.update(saved)


def _normalize(program: str) -> str:
    program = program.replace("thunder_tpu_torch", "thunder_tpu")
    program = re.sub(r"\b(jax|torch)_(?=[a-z])", "EX_", program)
    return "\n".join(line for line in program.splitlines()
                     if not line.startswith("# Constructed by"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def test_baseline_config_1_elementwise_add():
    def foo(a, b):
        return a + b

    rng = np.random.default_rng(SEED)
    a, b = (rng.standard_normal((2, 3)).astype(np.float32) for _ in range(2))
    rj = tt.jit(foo, executors=["jax"])
    pj = ttt.jit(foo, executors=["torch"])
    np.testing.assert_array_equal(_np(pj(torch.from_numpy(a), torch.from_numpy(b))),
                                  _np(rj(jnp.asarray(a), jnp.asarray(b))))
    assert _normalize(ttt.last_traces(pj)[-1].python()) == \
        _normalize(tt.last_traces(rj)[-1].python())
    assert _normalize(ttt.last_prologue_traces(pj)[-1].python()) == \
        _normalize(tt.last_prologue_traces(rj)[-1].python())


#
# The dispatch cache, one call sequence through both packages
#


class _Side:
    """One package's view of the scenarios: its ``jit`` and introspection,
    its cache-key module and its arrays."""

    def __init__(self, pkg, key_mod, to_array):
        self.pkg, self.key_mod, self.to_array = pkg, key_mod, to_array

    def x(self, n=4, dtype=np.float32):
        return self.to_array(np.ones((n,), dtype=dtype))


REF = _Side(tt, rcache_key, jnp.asarray)
PORT = _Side(ttt, pcache_key, torch.from_numpy)


def _failing_prologue(*a, **k):
    raise RuntimeError("external guard changed")


def _scenarios(side: _Side, monkeypatch) -> list:
    """Runs every scenario; returns, per step, the output and the counters."""
    pkg, log = side.pkg, []

    def snap(label, jfn, out=None):
        stats = {k: v for k, v in pkg.dispatch_stats(jfn).items() if not k.endswith("_ns")}
        log.append((label, None if out is None else _np(out).tolist(), pkg.cache_hits(jfn),
                    pkg.cache_misses(jfn), stats))

    # key hit and miss; a shape change is a new key, not a failed prologue
    jfn = pkg.jit(lambda x: x * 2.0)
    for label, n in (("first", 4), ("repeat", 4), ("shape", 8)):
        snap(f"hit/{label}", jfn, jfn(side.x(n)))

    # dtype, number type and number value specialize; the first entry hits
    jfn = pkg.jit(lambda x, s: x * s)
    for label, args in (("f32", (side.x(), 2.0)), ("i32", (side.x(dtype=np.int32), 2)),
                        ("value", (side.x(), 3.0)), ("again", (side.x(), 2.0))):
        snap(f"specialize/{label}", jfn, jfn(*args))

    # a repeat call at 64 specializations: one key computation, one prologue
    jfn = pkg.jit(lambda x, k: x + float(k))
    snap("o1/first", jfn, jfn(side.x(), 0))
    cs = pkg.compile_stats(jfn)
    real = cs.interpreter_cache[0]
    for k in range(1, 64):
        clone = copy.copy(real)
        clone.cache_key = real.cache_key_fn((side.x(), k), {})
        cs.interpreter_cache.append(clone)
        cs.dispatch_cache.setdefault(clone.cache_key, []).insert(0, clone)
    snap("o1/repeat", jfn, jfn(side.x(), 0))

    # guard failure after a key hit shadows the entry; it recovers by scan
    jfn = pkg.jit(lambda x: x + 1.0)
    jfn(side.x())
    cs = pkg.compile_stats(jfn)
    entry = cs.interpreter_cache[0]
    real_prologue = entry.prologue_fn
    entry.prologue_fn = _failing_prologue
    snap("shadow/evicted", jfn, jfn(side.x()))
    (bucket,) = cs.dispatch_cache.values()
    assert bucket[0] is not entry and bucket[-1] is entry
    bucket[0].prologue_fn = _failing_prologue
    entry.prologue_fn = real_prologue
    snap("shadow/recovered", jfn, jfn(side.x()))
    assert bucket[0] is entry

    # the LRU bound, then no bound
    jfn = pkg.jit(lambda x, k: x + float(k), max_cached_specializations=4)
    for k in range(8):
        jfn(side.x(), k)
    snap("lru/filled", jfn)
    snap("lru/recent", jfn, jfn(side.x(), 7))
    snap("lru/evicted", jfn, jfn(side.x(), 0))
    jfn = pkg.jit(lambda x, k: x + float(k), max_cached_specializations=None)
    for k in range(6):
        jfn(side.x(), k)
    snap("unbounded", jfn)

    # NO_CACHING compiles every call and keys nothing
    jfn = pkg.jit(lambda x: x + 1.0, cache="no caching")
    jfn(side.x())
    snap("no_caching", jfn, jfn(side.x()))
    assert pkg.compile_stats(jfn).dispatch_cache == {}

    # SYMBOLIC_VALUES keys numbers by type: one entry serves every float
    jfn = pkg.jit(lambda x, n: x * n, cache="symbolic values")
    for label, n in (("2.0", 2.0), ("5.0", 5.0), ("int", 3)):
        snap(f"symbolic/{label}", jfn, jfn(side.x(), n))

    # unkeyable inputs fall back to the linear prologue scan
    with monkeypatch.context() as m:
        m.setattr(side.key_mod, "compute_cache_key", lambda *a, **k: None)
        jfn = pkg.jit(lambda x: x * 3.0)
        jfn(side.x())
        snap("unkeyable", jfn, jfn(side.x()))
        assert pkg.compile_stats(jfn).interpreter_cache[0].cache_key is None
    return log


def test_dispatch_cache_counters_equal_the_reference(monkeypatch):
    ref = _scenarios(REF, monkeypatch)
    port = _scenarios(PORT, monkeypatch)
    assert [step[0] for step in port] == [step[0] for step in ref]
    for r, p in zip(ref, port):
        assert p == r, (r[0], r, p)


def test_cache_key_reads_metadata_only():
    x = torch.ones(2, 3)
    k = pcache_key.leaf_token(x)
    assert k == ("T", (2, 3), "float32", "cpu", False)
    assert pcache_key.leaf_token(x.requires_grad_(True))[-1] is True
    assert pcache_key.leaf_token(torch.float32) != pcache_key.leaf_token(torch.bfloat16)
    # a meta tensor has no values to read: its key computes all the same
    assert pcache_key.compute_cache_key((torch.empty(4, device="meta"),), {}) is not None


def test_entry_key_metadata_emitted_at_trace_time():
    jfn = ttt.jit(lambda x, k: x + float(k))
    x = torch.ones(4)
    jfn(x, 1)
    entry = ttt.compile_stats(jfn).interpreter_cache[0]
    assert entry.cache_key_fn((x, 1), {}) == entry.cache_key
    assert entry.cache_key_fn((x, 2), {}) != entry.cache_key
    assert entry.has_state_guards is False and entry.key_meta["state"] is None
    snap = ttt.metrics_snapshot()
    assert snap["dispatch.calls"] >= 1 and snap["compile.count"] >= 1


#
# jit(gpt_loss) of a tiny Llama against the reference and the port's eager loss
#

B, T = 2, 64


def _numpy_params(jcfg):
    """Weights made with numpy in the reference's params layout."""
    rng = np.random.default_rng(SEED)
    shapes = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jax.tree_util.tree_map(
        lambda a: (0.02 * rng.standard_normal(a.shape) + (a.ndim == 1)).astype(np.float32),
        shapes)


# tiny-llama-debug is the Llama-3 path; the others carry each model family's
# own ops through the trace (a sliding window, MQA with parallel residual,
# LayerNorm with biases and partial rotary, GeGLU with a scaled embedding
# and tied head, learned positions)
FAMILIES = ["tiny-llama-debug", "tiny-mistral-debug", "tiny-falcon-debug", "tiny-pythia-debug",
            "tiny-gemma-debug", "nanogpt-debug"]


@pytest.mark.parametrize("name", FAMILIES)
def test_jit_gpt_loss_matches_the_reference_and_eager(name):
    jcfg, cfg = jllama.Config.from_name(name), tllama.Config.from_name(name)
    nparams = _numpy_params(jcfg)
    rng = np.random.default_rng(SEED + 1)
    idx = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    tgt[0, :5] = -100

    jcos, jsin = jllama.build_rope_cache(jcfg, T)
    ref = tt.jit(lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, nparams), jnp.asarray(idx), jnp.asarray(tgt),
        jcos, jsin)

    params = ttt.params_from_numpy(nparams, device="cpu")
    cos, sin = tllama.build_rope_cache(cfg, T)
    args = (params, torch.from_numpy(idx), torch.from_numpy(tgt).long(), cos, sin)
    jfn = ttt.jit(lambda p, i, t, c, s: ttt.gpt_loss(p, i, t, c, s, cfg))
    loss = jfn(*args)
    eager = ttt.gpt_loss(*args, cfg)
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))
    assert abs(loss.item() - eager.item()) <= 1e-6 * abs(eager.item())

    # the parameters are inputs, guarded leaf by leaf, never constants
    n_leaves = len(jax.tree_util.tree_leaves(nparams))
    prologue = ttt.last_prologue_traces(jfn)[-1].python()
    assert prologue.count("check_tensor_metadata") == n_leaves + 4
    final = ttt.last_traces(jfn)[-1]
    names = [b.sym.name for b in final.bound_symbols]
    assert names.count("torch_sdpa") == cfg.n_layer
    assert names.count("torch_cross_entropy_fwd") == 1
    # a second call hits the cache and gives the same loss
    assert torch.equal(jfn(*args), loss)
    assert (ttt.cache_hits(jfn), ttt.cache_misses(jfn)) == (1, 1)


def _compile_seconds(n_layer: int) -> float:
    cfg = tllama.Config.from_name("tiny-llama-debug", n_layer=n_layer)
    params = tllama.init_params(cfg, device="cpu", dtype=torch.float32)
    idx = torch.zeros((1, 16), dtype=torch.long)
    cos, sin = tllama.build_rope_cache(cfg, 16)
    best = float("inf")
    for _ in range(2):
        jfn = ttt.jit(lambda p, i, t, c, s: ttt.gpt_loss(p, i, t, c, s, cfg))
        t0 = time.perf_counter()
        jfn(params, idx, idx, cos, sin)
        best = min(best, time.perf_counter() - t0)
    return best


def test_compile_time_grows_linearly_with_depth():
    """32 layers against 8: a linear pipeline takes about 4x, a pass
    quadratic in the trace length about 16x."""
    t8, t32 = _compile_seconds(8), _compile_seconds(32)
    assert t32 < 60.0, t32
    assert t32 / t8 < 8.0, (t8, t32)


@pytest.mark.parametrize("policy", ["error", "warn"])
def test_sharp_edges_policy_matches_the_reference(policy):
    """An impure call while tracing raises or warns, as the reference's
    guard does; the clock is put back afterwards."""
    from thunder_tpu.core.sharp_edges import SharpEdgeError as RError
    from thunder_tpu_torch.core.sharp_edges import SharpEdgeError as PError

    def impure(x):
        return x * time.time()

    if policy == "error":
        with pytest.raises(RError, match="time.time"):
            tt.jit(impure, sharp_edges=policy)(jnp.ones(2))
        with pytest.raises(PError, match="time.time"):
            ttt.jit(impure, sharp_edges=policy)(torch.ones(2))
    else:
        with pytest.warns(UserWarning, match="time.time"):
            ttt.jit(impure, sharp_edges=policy)(torch.ones(2))
    assert time.time.__module__ == "time"
    ttt.jit(impure)(torch.ones(2))            # the default allows it


#
# Options that wait for later ROADMAP.md items
#


@pytest.mark.parametrize("call,item", [
    (lambda: ttt.make_train_step(lambda p, x: (p * x).sum(), ttt.adamw(0.1), donate_batch=True),
     "item 11"),
], ids=["donate"])
def test_deferred_options_raise_naming_their_item(call, item):
    """Item 11 (training past one device) is done: ``donate_batch=True``
    builds a step (the reference's signature; the port frees no caller
    tensor) and ``tp`` > 1, the next slice, names item 12."""
    assert call().donate_batch is True
    from thunder_tpu_torch.distributed.api import _NEXT_SLICE

    assert "ROADMAP.md Queue 1 item 12" in _NEXT_SLICE and item == "item 11"
