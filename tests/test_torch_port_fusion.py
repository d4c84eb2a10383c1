"""The fusion executor (``executors/inductorex.py``), the dataflow
partitioner (``executors/data_dependent_partition.py``) and the persistent
compile cache (``core/compile_cache.py``), against the JAX package on the
CPU; on the card (``cuda``-marked), the compiled regions themselves.

- **Partition.** The scenarios of ``tests/test_partition.py`` and
  ``gpt_loss`` of tiny-llama-debug and tiny-moe-debug, forward and
  backward: on the trace the fusion pass gets, the port's
  ``fuse_bound_symbols`` and the reference's form the same groups (member
  op lists, in order) under the port's predicate, and the fusion pass makes
  one region of each fusible group; where no ``item()`` barrier is
  involved, as many regions as the reference's ``xla`` executor makes.
- **Fusion.** The fused program's loss and grads equal the unfused port
  program's and the JAX package's (``executors=["xla", "jax"]``), float32,
  within 1e-5 relative.
- **No graph break.** Every distinct region of that forward and backward
  compiles whole (``fullgraph=True``) under ``backend="aot_eager"`` and
  equals its plain version.
- **Fuel, ``xla_min_fusion_size`` and forbidden regions.** Fuel 0 leaves
  the trace unfused; the size option fuses as the reference's does; no
  region holds a random prim, a kernel's prim or a claimed symbol.
- **The compile cache's surface** (``tests/test_compile_cache.py``): the
  off switch, an idempotent enable, the directory under ``build/``, the
  stats keys.  The second process's hit needs inductor on the card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu.torch as rltorch
import thunder_tpu_torch as ttt
import thunder_tpu_torch.torch as ltorch
from thunder_tpu.executors import data_dependent_partition as rpartition
from thunder_tpu.executors.xlaex import xla_ex
from thunder_tpu.models import llama as jllama
from thunder_tpu_torch.core import compile_cache
from thunder_tpu_torch.executors import data_dependent_partition as ppartition
from thunder_tpu_torch.executors import inductorex, quantex
from thunder_tpu_torch.executors.cudaex import cuda_ex
from thunder_tpu_torch.executors.inductorex import FusionCallable, inductor_ex
from thunder_tpu_torch.executors.torchex import torch_ex
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.models.weights import params_from_numpy
from torch_port_threads import one_torch_thread  # noqa: F401

UNFUSED = [cuda_ex, torch_ex]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture
def fusion_inputs(monkeypatch):
    """Records every trace the fusion pass gets, in order."""
    seen = []
    original = inductor_ex.fusion_pass

    def record(trace):
        seen.append(trace)
        return original(trace)

    monkeypatch.setattr(inductor_ex, "fusion_pass", record)
    return seen


def _groups(partition, trace):
    groups = partition.fuse_bound_symbols(trace.bound_symbols, inductor_ex.should_fuse(trace))
    return [(g.fusible and inductorex.region_weight(g.bsyms) >= 2, [b.sym.name for b in g.bsyms])
            for g in groups]


def _regions(trace) -> list:
    return [b for b in trace.bound_symbols if b.sym.is_fusion]


def _assert_same_groups(trace, final):
    """The two partitioners agree on ``trace``, and the fusion pass made
    one region of each fusible group that weighs 2 or more."""
    port, ref = _groups(ppartition, trace), _groups(rpartition, trace)
    assert port == ref
    regions = [[s.sym.name for s in r.subsymbols] for r in _regions(final)]
    assert regions == [names for fused, names in port if fused]
    assert not inductorex.region_violations(final)
    return port


#
# partition: the scenarios of tests/test_partition.py
#

def _barrier_split(lt):
    def f(a, b):
        x1 = lt.sin(a)
        k = lt.item(lt.sum(lt.zeros(1, dtype=lt.float32, device="cpu")))
        x2 = lt.cos(x1) * lt.exp(x1)
        y1 = lt.tanh(b)
        y2 = y1 * lt.sqrt(lt.abs(b) + 1.0)
        return x2 + y2 + k
    return f


def _through_barrier(lt):
    def f(a, b):
        front = lt.sin(a) + 1.0
        k = lt.item(lt.sum(front))
        return lt.cos(front) * k + b
    return f


def _topological(lt):
    def f(a, b):
        x = lt.sin(a)
        s = lt.item(lt.sum(x))
        return lt.cos(x) * s + b
    return f


def _islands(lt):
    def f(a, b, c):
        return lt.sin(a), lt.cos(b), lt.tanh(c), lt.exp(a) * lt.sqrt(lt.abs(b))
    return f


SCENARIOS = {"nonfusible_does_not_split_independent_chains": (_barrier_split, 2),
             "partitioner_respects_dependencies": (_through_barrier, 2),
             "group_topological_order": (_topological, 2),
             "many_independent_islands_fuse_together": (_islands, 3)}


def _ref_device_kw(fn, lt):
    """The reference's zeros takes no device= on the CPU: strip it."""
    if lt is rltorch:
        real = rltorch.zeros
        rltorch_zeros = lambda *a, device=None, **k: real(*a, **k)  # noqa: E731

        def wrapped(*args):
            rltorch.zeros = rltorch_zeros
            try:
                return fn(*args)
            finally:
                rltorch.zeros = real
        return wrapped
    return fn


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_partition_scenarios_match_the_reference(name, fusion_inputs):
    make, n_args = SCENARIOS[name]
    rng = np.random.default_rng(9)
    arrays = [rng.standard_normal((4, 4)).astype(np.float32) for _ in range(n_args)]
    pfn = ttt.jit(make(ltorch))
    got = pfn(*[torch.as_tensor(a) for a in arrays])
    rfn = tt.jit(_ref_device_kw(make(rltorch), rltorch))
    want = rfn(*arrays)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    (trace,) = fusion_inputs
    final = ttt.last_traces(pfn)[-1]
    _assert_same_groups(trace, final)
    # item() reads the card: a barrier the port's regions never absorb
    outside = [b.sym.name for b in final.bound_symbols if not b.sym.is_fusion]
    assert ("torch_item" in outside) == (name != "many_independent_islands_fuse_together")
    if name == "many_independent_islands_fuse_together":
        ref_regions = [b for b in tt.last_traces(rfn)[-1].bound_symbols if b.sym.is_fusion]
        assert len(_regions(final)) == len(ref_regions) == 1


def _pair(name):
    jcfg = jllama.Config.from_name(name)
    tcfg = tllama.Config.from_name(name)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    T = 32
    idx = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, T)).astype(np.int32)
    jrope, trope = jllama.build_rope_cache(jcfg, T), tllama.build_rope_cache(tcfg, T)
    return (jcfg, jp, (idx, idx, *jrope)), (tcfg, tp, (torch.as_tensor(idx),
                                                       torch.as_tensor(idx), *trope))


@pytest.mark.parametrize("name", ["tiny-llama-debug", "tiny-moe-debug"])
def test_gpt_loss_partition_matches_the_reference(name, fusion_inputs):
    _, (tcfg, tp, batch) = _pair(name)
    vg = ttt.value_and_grad(lambda p, i, t, c, s: tllama.gpt_loss(p, i, t, c, s, tcfg))
    vg(tp, *batch)
    bw_in, fw_in = fusion_inputs      # the backward is claimed first
    for trace, final in ((fw_in, ttt.last_traces(vg)[-1]),
                         (bw_in, ttt.last_backward_traces(vg)[-1])):
        groups = _assert_same_groups(trace, final)
        assert sum(fused for fused, _ in groups) >= tcfg.n_layer


#
# fusion: values against the unfused program and the JAX package
#

def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.fixture(scope="module")
def llama_grads():
    (jcfg, jp, jbatch), (tcfg, tp, batch) = _pair("tiny-llama-debug")
    loss_fn = lambda p, i, t, c, s: tllama.gpt_loss(p, i, t, c, s, tcfg)   # noqa: E731
    fused = ttt.value_and_grad(loss_fn)
    unfused = ttt.value_and_grad(loss_fn, executors=UNFUSED)
    ref = tt.value_and_grad(lambda p, i, t, c, s: jllama.gpt_loss(p, i, t, c, s, jcfg),
                            executors=["xla", "jax"])
    return fused, (tp, *batch), ref(jp, *jbatch), unfused(tp, *batch)


def test_fused_program_equals_unfused_and_the_jax_package(llama_grads):
    fused, args, (rloss, rgrads), (uloss, ugrads) = llama_grads
    loss, grads = fused(*args)
    assert _rel(loss.item(), uloss.item()) <= 1e-5
    assert _rel(loss.item(), float(rloss)) <= 1e-5
    flat, rflat = jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(rgrads)
    uflat = jax.tree_util.tree_leaves(ugrads)
    assert len(flat) == len(rflat) == len(uflat)
    for g, r, u in zip(flat, rflat, uflat):
        assert _rel(g.numpy(), u.numpy()) <= 1e-5
        assert _rel(g.numpy(), np.asarray(r)) <= 1e-5
    assert _regions(ttt.last_traces(fused)[-1]) and _regions(ttt.last_backward_traces(fused)[-1])


def test_every_region_compiles_whole_and_equals_its_plain_version(llama_grads, monkeypatch):
    fused, args, *_ = llama_grads
    calls = {}
    original = FusionCallable.__call__

    def record(self, *vals):
        out = original(self, *vals)
        calls.setdefault(self.key, (self, vals, out))
        return out

    monkeypatch.setattr(FusionCallable, "__call__", record)
    fused(*args)
    monkeypatch.undo()
    assert len(calls) >= 4
    for fusion, vals, plain in calls.values():
        got = inductorex.compile_fusion(fusion, vals, backend="aot_eager")(*vals)
        assert len(got) == len(plain)
        for g, p in zip(got, plain):
            if isinstance(p, torch.Tensor):
                assert g.shape == p.shape and g.dtype == p.dtype
                torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-6)


#
# fuel, xla_min_fusion_size, forbidden regions
#

def test_fuel_zero_leaves_the_trace_unfused():
    x = torch.randn(4, 4)
    inductor_ex.set_fuel(0)
    try:
        jf = ttt.jit(lambda a: torch.sin(a) * torch.cos(a) + 1.0)
        np.testing.assert_allclose(jf(x).numpy(), (torch.sin(x) * torch.cos(x) + 1.0).numpy(),
                                   rtol=1e-6)
        assert not _regions(ttt.last_traces(jf)[-1])
    finally:
        inductor_ex.set_fuel(None)
    jf = ttt.jit(lambda a: torch.sin(a) * torch.cos(a) + 1.0)
    jf(x)
    assert len(_regions(ttt.last_traces(jf)[-1])) == 1


def test_min_fusion_size_behaves_as_the_reference_option():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    w = rng.standard_normal((8, 8)).astype(np.float32)

    def chain(lt):
        return lambda x, y: lt.exp(lt.sin(x) * lt.cos(x)) + y

    def with_matmul(lt):
        return lambda x, y: lt.sin(lt.matmul(x, y))

    for make in (chain, with_matmul):
        for size in (1, 2, 3, 4, 5, 6, 1000, 1001, 1002):
            pf = ttt.jit(make(ltorch), xla_min_fusion_size=size)
            rf = tt.jit(make(rltorch), xla_min_fusion_size=size)
            np.testing.assert_allclose(pf(torch.as_tensor(a), torch.as_tensor(w)).numpy(),
                                       np.asarray(rf(a, w)), rtol=1e-5, atol=1e-5)
            pr = [[s.sym.name for s in b.subsymbols] for b in _regions(ttt.last_traces(pf)[-1])]
            rr = [[s.sym.name for s in b.subsymbols] for b in tt.last_traces(rf)[-1].bound_symbols
                  if b.sym.is_fusion]
            assert pr == rr, (make.__name__, size)


def test_no_region_holds_a_random_prim_a_kernel_prim_or_a_claimed_symbol():
    import torch.nn.functional as F

    def f(q, k, v, w, tgt):
        h = F.dropout(torch.tanh(q), p=0.5, training=True)
        y = F.scaled_dot_product_attention(h, k, v, is_causal=True)
        logits = torch.matmul(y.reshape(-1, y.shape[-1]), w) * 2.0
        return F.cross_entropy(logits, tgt)

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 64, generator=g) for _ in range(3))
    w = torch.randn(64, 96, generator=g)
    tgt = torch.randint(0, 96, (16,), generator=g)
    for executors in (None, [quantex.ex, *ttt.extend.get_default_executors()]):
        jf = ttt.jit(f, executors=executors)
        assert torch.isfinite(jf(q, k, v, w, tgt))
        final = ttt.last_traces(jf)[-1]
        assert _regions(final)
        assert not inductorex.region_violations(final)
        outside = {b.sym.name for b in final.bound_symbols if not b.sym.is_fusion}
        assert {"torch_sdpa", "torch_cross_entropy_fwd"} <= outside
        assert any(n.startswith("torch_uniform") for n in outside)
        if executors is not None:
            assert "int8_matmul" in outside


def test_region_violations_names_what_a_region_may_not_hold():
    import torch.nn.functional as F

    jf = ttt.jit(lambda q: F.dropout(torch.tanh(q), p=0.5, training=True) * 2.0)
    jf(torch.randn(4, 4))
    final = ttt.last_traces(jf)[-1]
    assert not inductorex.region_violations(final)
    region = _regions(final)[0]
    bad = region.from_bsym(subsymbols=(*region.subsymbols,
                                       *[b for b in ttt.last_traces(jf)[2].bound_symbols
                                         if b.sym.name == "dropout"]))
    final.bound_symbols = [bad if b is region else b for b in final.bound_symbols]
    assert any("random" in v for v in inductorex.region_violations(final))


class _CardLooking(torch.Tensor):
    """A CPU tensor that reports itself on the card: which path a region takes."""

    @property
    def is_cuda(self):
        return True


def test_a_region_compiles_when_any_input_is_on_the_card(monkeypatch):
    jf = ttt.jit(lambda s, x: torch.sin(s * x) + 1.0)
    s, x = torch.tensor(2.0), torch.randn(4)
    jf(s, x)
    (region,) = _regions(ttt.last_traces(jf)[-1])
    fusion = region._call_ctx[region.sym.name]
    assert fusion.input_names == [p.name for p in ttt.last_traces(jf)[-1].args]
    ran = []
    monkeypatch.setattr(fusion, "_run_compiled", lambda vals, backend: ran.append(backend))
    on_card = torch.Tensor._make_subclass(_CardLooking, x)
    # the first tensor input is a 0-dim CPU scalar: the region still compiles
    fusion(s, on_card)
    assert ran == ["inductor"]
    # CPU tensors alone: the plain version
    (out,) = fusion(s, x)
    torch.testing.assert_close(out, torch.sin(s * x) + 1.0)
    assert ran == ["inductor"]
    # a CPU tensor of any other rank beside a CUDA one raises
    with pytest.raises(inductorex.FusionError, match=f"{region.sym.name} got CUDA tensors"):
        fusion(torch.full((4,), 2.0), on_card)
    assert ran == ["inductor"]


#
# the persistent compile cache's surface
#

@pytest.fixture
def fresh_cache_state(monkeypatch):
    """Leaves the module's state and inductor's cache directory as found."""
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(compile_cache, "_before", None)
    before = os.environ.get("TORCHINDUCTOR_CACHE_DIR")
    yield
    if before is None:
        os.environ.pop("TORCHINDUCTOR_CACHE_DIR", None)
    else:
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = before


def test_compile_cache_off_switch(fresh_cache_state, monkeypatch):
    monkeypatch.setenv("THUNDER_TPU_COMPILATION_CACHE", "off")
    assert compile_cache.enable() is None
    assert compile_cache.ensure_enabled() is None
    assert compile_cache.stats()["dir"] is None


def test_compile_cache_enable_is_idempotent_and_env_resolved(fresh_cache_state, monkeypatch,
                                                             tmp_path):
    monkeypatch.setenv("THUNDER_TPU_COMPILATION_CACHE", str(tmp_path / "c"))
    d1 = compile_cache.enable()
    d2 = compile_cache.ensure_enabled()
    assert d1 == d2 == str(tmp_path / "c") == compile_cache.cache_dir()
    assert os.path.isdir(d1) and os.environ["TORCHINDUCTOR_CACHE_DIR"] == d1
    assert set(compile_cache.stats()) == {"persistent_cache_hits", "persistent_cache_misses",
                                          "dir"}


def test_compile_cache_min_compile_seconds_drops_faster_entries(fresh_cache_state, monkeypatch,
                                                                tmp_path):
    monkeypatch.setenv("THUNDER_TPU_COMPILATION_CACHE", str(tmp_path / "c"))
    monkeypatch.setenv("THUNDER_TPU_CACHE_MIN_COMPILE_S", "5")
    d = compile_cache.enable()
    entry = os.path.join(d, "fxgraph", "ab", "entry")
    os.makedirs(os.path.dirname(entry))
    open(entry, "w").close()
    compile_cache.compiled(0.1)            # a fast compile's entries go
    assert not os.path.exists(entry)
    open(entry, "w").close()
    compile_cache.compiled(6.0)            # a slow one's stay
    assert os.path.exists(entry)


def test_compile_cache_default_dir_is_under_build(fresh_cache_state, monkeypatch):
    monkeypatch.delenv("THUNDER_TPU_COMPILATION_CACHE", raising=False)
    d = compile_cache._default_dir()
    assert d == os.path.join(REPO, "build", "thunder_tpu_torch", "inductor")
    if not torch.cuda.is_available():
        # no card and no explicit directory: the hook changes nothing
        assert compile_cache.ensure_enabled() is None


def test_compile_stats_surface_and_a_plain_import_changes_nothing():
    jfn = ttt.jit(lambda x: x + 1)
    jfn(torch.ones(4))
    pc = ttt.compile_stats(jfn).persistent_cache
    assert {"persistent_cache_hits", "persistent_cache_misses", "dir"} <= set(pc)
    code = ("import os, sys; sys.path.insert(0, %r); import torch._inductor.config as c; "
            "before = dict(os.environ), c.save_config(); import thunder_tpu_torch; "
            "print((dict(os.environ), c.save_config()) == before)" % REPO)
    env = {k: v for k, v in os.environ.items() if k != "TORCHINDUCTOR_CACHE_DIR"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == "True"


#
# on the card
#

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fusion regions compile with inductor on the card")
    return torch.device("cuda")


def _mlp(x, w1, w2):
    h = torch.nn.functional.silu(torch.matmul(x, w1)) * 1.5
    return torch.matmul(h, w2).softmax(-1) + x


@pytest.mark.cuda
def test_cuda_compiled_region_equals_its_plain_version(card):
    g = torch.Generator(device=card).manual_seed(0)
    args = [torch.randn(64, 64, device=card, generator=g) for _ in range(3)]
    jf = ttt.jit(_mlp)
    got = jf(*args)
    (region,) = _regions(ttt.last_traces(jf)[-1])
    fusion = region._call_ctx[region.sym.name]
    (plain,) = fusion.plain(*args)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    assert inductorex.STATS["compiles"] >= 1


@pytest.mark.cuda
def test_cuda_structurally_equal_regions_compile_once(card):
    cfg = tllama.Config.from_name("tiny-llama-debug", n_layer=5)
    gen = torch.Generator(device=card).manual_seed(1)
    params = tllama.init_params(cfg, generator=gen, dtype=torch.float32, device=card)
    idx = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device=card)
    cos, sin = tllama.build_rope_cache(cfg, 128, device=card)
    before = inductorex.STATS["compiles"]
    jf = ttt.jit(lambda p, i, t, c, s: tllama.gpt_loss(p, i, t, c, s, cfg))
    loss = jf(params, idx, idx, cos, sin)
    regions = _regions(ttt.last_traces(jf)[-1])
    keys = {r._call_ctx[r.sym.name].key for r in regions}
    assert len(keys) < len(regions)
    assert inductorex.STATS["compiles"] - before <= len(keys)
    want = ttt.jit(lambda p, i, t, c, s: tllama.gpt_loss(p, i, t, c, s, cfg),
                   executors=UNFUSED)(params, idx, idx, cos, sin)
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())


_CHILD = r"""
import json, sys
sys.path.insert(0, %r)
import torch, thunder_tpu_torch as ttt
jf = ttt.jit(lambda x, y: torch.tanh(x) * y + 1.0)
x = torch.arange(512, dtype=torch.float32, device="cuda").reshape(8, 64) / 512
out = jf(x, x)
assert torch.allclose(out, torch.tanh(x) * x + 1.0, atol=1e-5)
print(json.dumps(ttt.compile_stats(jf).persistent_cache))
""" % REPO


@pytest.mark.cuda
def test_cuda_second_process_hits_the_persistent_cache(card, tmp_path):
    env = dict(os.environ, THUNDER_TPU_COMPILATION_CACHE=str(tmp_path / "inductor"))
    env.pop("TORCHINDUCTOR_CACHE_DIR", None)
    runs = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                              env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first, second = runs
    assert first["dir"] == str(tmp_path / "inductor")
    assert first["persistent_cache_misses"] > 0
    assert second["persistent_cache_hits"] > 0, second


@pytest.mark.cuda
def test_cuda_donated_input_frees_its_bytes(card):
    jf = ttt.jit(lambda p, g: p - 0.01 * g, donate=True)
    n = 1 << 22
    p = torch.ones(n, device=card)
    g = torch.full((n,), 0.5, device=card)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = jf(p, g)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    # the output takes n floats; both donated inputs' 2n floats are released
    assert after - before <= n * 4 - 2 * n * 4 + (1 << 20), (before, after)
    assert p.untyped_storage().nbytes() == 0 and g.untyped_storage().nbytes() == 0
    torch.testing.assert_close(out, torch.full((n,), 0.995, device=card))
    with pytest.raises(ttt.DonationError, match="donated by an earlier call"):
        jf(p, g)


@pytest.mark.cuda
def test_cuda_graph_break_raises_instead_of_running_eagerly(card, monkeypatch):
    jf = ttt.jit(lambda x: torch.sin(x) * torch.cos(x) + 2.0)
    x = torch.randn(16, device=card)
    jf(x)
    (region,) = _regions(ttt.last_traces(jf)[-1])
    fusion = region._call_ctx[region.sym.name]

    def data_dependent(a):
        if a.sum() > 0:              # a branch on a value: no whole graph
            return (a * 2.0,)
        return (a,)

    monkeypatch.setattr(fusion.trace, "_python_callable_impl", lambda: data_dependent)
    monkeypatch.setattr(inductorex, "_COMPILED", {})
    monkeypatch.setattr(fusion, "_last", None)
    with pytest.raises(inductorex.FusionError, match=region.sym.name):
        jf(torch.randn(16, device=card))
