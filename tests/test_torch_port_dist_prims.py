"""The port's collective prims and sharding rules against the JAX package.

One world of four gloo ranks (``thunder_tpu_torch.distributed.launch``,
one thread each, rendezvous through a ``FileStore`` under ``tmp_path``)
runs ``tests/torch_port_dist_workers.py``, which imports torch and the port
only; the JAX side runs here, on the virtual CPU mesh (``tests/
conftest.py``):

- each dist prim (the cases of ``tests/test_distributed.py:56-91`` and the
  rest) and its VJP, at world 4 and world 2 (a half of the world),
  against the JAX prim under ``shard_map_compat`` and ``jax.vjp``: exact
  in float32 (integer-valued inputs, so every sum is exact in any order);
  ``synchronize``'s VJP against the rule the sharded step needs, the mean
  over the axis (``psum_scatter``/``pmean`` of the cotangent);
- the specs of ``ddp_shardings``, ``fsdp_shardings(min_size=64)``,
  ``llama_shardings``, ``default_batch_shardings``, ``batch_spec`` and
  ``kv_cache_spec`` on four meshes, equal to the JAX specs leaf by leaf,
  and each rank's shard of the placed params equal to the JAX array's
  shard on the device of the same index;
- the ``train/overlap.py`` functions equal to the reference's on the same
  leaves, and the trace rewrite of ``bucketed_grad_sync``;
- the launcher kills a world whose rank failed or outlived its timeout
  and raises (its supervision driven by stand-in processes).
"""
from __future__ import annotations

import threading
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from thunder_tpu import distributed as jdist
from thunder_tpu.distributed.prims import shard_map_compat
from thunder_tpu.models import llama as jllama
from thunder_tpu.train import overlap as joverlap
from thunder_tpu_torch.distributed import launch
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama as tllama
from thunder_tpu_torch.models.weights import params_from_numpy
from thunder_tpu_torch.train import overlap as toverlap
import torch_port_dist_workers as workers
from torch_port_threads import one_torch_thread  # noqa: F401

WORLD_TIMEOUT_S = 120
NS = (4, 2)
CASES = list(workers.prim_cases(4))


def _jax_body(name: str, n: int):
    perm = [(i, (i + 1) % n) for i in range(n)]
    lax = jax.lax
    return {
        "all_gather": lambda x: lax.all_gather(x, "x", axis=0, tiled=True),
        "all_gather_dim1": lambda x: lax.all_gather(x, "x", axis=1, tiled=True),
        "all_gather_untiled": lambda x: lax.all_gather(x, "x", axis=0, tiled=False),
        "all_reduce_sum": lambda x: lax.psum(x, "x"),
        "all_reduce_mean": lambda x: lax.pmean(x, "x"),
        "all_reduce_tuple": lambda x: lax.psum((x, x[:, :2] * 3.0), "x"),
        "reduce_scatter_sum": lambda x: lax.psum_scatter(x, "x", scatter_dimension=0, tiled=True),
        "reduce_scatter_mean": lambda x: lax.psum_scatter(x, "x", scatter_dimension=0,
                                                          tiled=True) / n,
        # the reference's broadcast impl (thunder_tpu/distributed/prims.py)
        "broadcast": lambda x: lax.psum(jnp.where(lax.axis_index("x") == n - 1, x,
                                                  jnp.zeros_like(x)), "x"),
        "ppermute": lambda x: lax.ppermute(x, "x", perm=perm),
        "all_to_all": lambda x: lax.all_to_all(x, "x", 0, 1, tiled=True),
        "synchronize_sharded": lambda x: lax.all_gather(x, "x", axis=0, tiled=True),
        "synchronize_replicated": lambda x: x,
    }[name]


def _mean_rule(name: str, n: int):
    """synchronize's VJP in the sharded step: the mean over the axis."""
    if name == "synchronize_sharded":
        return lambda g: jax.lax.psum_scatter(g, "x", scatter_dimension=0, tiled=True) / n
    return lambda g: jax.lax.pmean(g, "x")


def _mesh(n: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:n]), ("x",))


def _sm(fn, n, n_out=1):
    out = JP("x") if n_out == 1 else (JP("x"),) * n_out
    return shard_map_compat(fn, _mesh(n), JP("x"), out)


def _inputs(n: int, name: str):
    """Integer-valued float32 global input and cotangent, split by rank."""
    shape = workers.prim_cases(n)[name][1]
    rng = np.random.default_rng(zlib.crc32(f"{n} {name}".encode()))
    x = rng.integers(-8, 9, (n * shape[0], *shape[1:])).astype(np.float32)
    body = _jax_body(name, n)
    out = jax.eval_shape(_sm(body, n, 2 if name == "all_reduce_tuple" else 1),
                         jax.ShapeDtypeStruct(x.shape, jnp.float32))
    outs = out if isinstance(out, tuple) else (out,)
    cts = tuple(rng.integers(-8, 9, o.shape).astype(np.float32) for o in outs)
    return x, cts if isinstance(out, tuple) else cts[0]


def _jax_refs(n, xs: dict, cts: dict) -> dict:
    """``{name: (outputs, grad)}`` of every case at axis size ``n``, from one
    jitted program: each case's forward under ``shard_map_compat`` and its
    ``jax.vjp`` of the cotangent."""

    def all_cases(xs, cts):
        out = {}
        for name in CASES:
            f = _sm(_jax_body(name, n), n, 2 if name == "all_reduce_tuple" else 1)
            value, vjp = jax.vjp(f, xs[name])
            if name.startswith("synchronize"):
                grad = _sm(_mean_rule(name, n), n)(cts[name])
            else:
                (grad,) = vjp(cts[name])
            out[name] = (value, grad)
        return out

    got = jax.jit(all_cases)(xs, cts)
    return jax.tree_util.tree_map(np.asarray, got)


def _split(a, n):
    return np.split(a, n) if not isinstance(a, tuple) else tuple(np.split(c, n) for c in a)


def _by_rank(a, n):
    """Rank-indexed pieces: ``[piece_0, ...]`` (tuples per rank for tuple
    outputs)."""
    parts = _split(a, n)
    return list(zip(*parts)) if isinstance(a, tuple) else parts


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of four ranks, started once; the JAX references are
    computed here while it runs."""
    xs, cts = {}, {}
    for n in NS:
        for name in CASES:
            x, ct = _inputs(n, name)
            xs[(n, name)], cts[(n, name)] = _split(x, n), _split(ct, n)
    cfg = jllama.Config.from_name("tiny-llama-debug")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_numpy(np_params, device="cpu")
    rng = np.random.default_rng(7)
    idx = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    cos, sin = jllama.build_rope_cache(cfg, 16)
    tbatch = (torch.as_tensor(idx), torch.as_tensor(idx).long(), *tllama.build_rope_cache(
        tllama.Config.from_name("tiny-llama-debug"), 16))
    got: dict = {}

    def run():
        try:
            got["prims"] = launch(workers.prims_and_placements, 4,
                                  args=(xs, cts, tparams, tbatch), threads=1,
                                  timeout_s=WORLD_TIMEOUT_S,
                                  workdir=str(tmp_path_factory.mktemp("world")))
        except Exception as e:    # re-raised in the test thread below
            got["error"] = e

    t = threading.Thread(target=run)
    t.start()
    refs = {}
    for n in NS:
        whole = {name: np.concatenate(xs[(n, name)]) for name in CASES}
        whole_ct = {name: tuple(np.concatenate(c) for c in cts[(n, name)])
                    if isinstance(cts[(n, name)], tuple) else np.concatenate(cts[(n, name)])
                    for name in CASES}
        refs.update({(n, name): v for name, v in _jax_refs(n, whole, whole_ct).items()})
    t.join(WORLD_TIMEOUT_S + 30)
    assert not t.is_alive(), "the world outlived its timeout"
    if "error" in got:
        raise got["error"]
    return dict(ranks=got["prims"], refs=refs, jparams=jparams, jbatch=(idx, idx, cos, sin))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", CASES)
def test_prim_and_vjp_equal_jax(world, name, n):
    out_ref, grad_ref = world["refs"][(n, name)]
    outs = _by_rank(out_ref, n)
    grads = np.split(grad_ref, n)
    for r in range(n):
        value, grad = world["ranks"][r]["prims"][(n, name)]
        if isinstance(value, tuple):
            for v, o in zip(value, outs[r]):
                np.testing.assert_array_equal(v.numpy(), o)
        else:
            np.testing.assert_array_equal(value.numpy(), outs[r])
        np.testing.assert_array_equal(grad.numpy(), grads[r])


@pytest.mark.parametrize("n", NS)
def test_axis_index(world, n):
    assert [world["ranks"][r]["prims"][(n, "axis_index")] for r in range(4)] == \
        [r % n for r in range(4)]


def _norm(spec) -> tuple:
    out = [None if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


MESHES = [{"dp": 4}, {"fsdp": 4}, {"dp": 2, "fsdp": 2}, {"fsdp": 2, "tp": 2}]


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_placements_equal_jax_specs(world, axes):
    mesh = jdist.make_mesh(axes, devices=jax.devices()[:4])
    p = world["jparams"]
    want = {"ddp": jdist.ddp_shardings(p, mesh), "llama": jdist.llama_shardings(p, mesh)}
    if "fsdp" in axes:                 # the rule reads the size of its axis
        want["fsdp"] = jdist.fsdp_shardings(p, mesh, min_size=64)
    got = world["ranks"][0]["placements"][tuple(axes.items())]
    assert got["shape"] == axes
    for k, tree in want.items():
        specs = [s.spec for s in jax.tree_util.tree_leaves(tree)]
        assert [_norm(s) for s in got[k]] == [_norm(s) for s in specs], k
    from thunder_tpu.distributed.api import default_batch_shardings

    jb = [s.spec for s in default_batch_shardings(mesh, world["jbatch"])]
    assert [_norm(s) for s in got["batch"]] == [_norm(s) for s in jb]
    assert _norm(got["batch_spec"]) == _norm(jdist.batch_spec(mesh))
    assert _norm(got["kv"]) == _norm(jdist.kv_cache_spec(jllama.Config.from_name(
        "tiny-llama-debug"), mesh))


@pytest.mark.parametrize("kind", ["fsdp", "llama"])
@pytest.mark.parametrize("axes", MESHES[1:3], ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_placed_shards_equal_jax_shards(world, axes, kind):
    mesh = jdist.make_mesh(axes, devices=jax.devices()[:4])
    p = world["jparams"]
    placed = (jdist.fsdp(p, mesh, min_size=64) if kind == "fsdp" else jdist.tp_fsdp(p, mesh))
    leaves = jax.tree_util.tree_leaves(placed)
    devices = list(mesh.devices.flat)
    for r in range(4):
        mine = world["ranks"][r]["placements"][tuple(axes.items())]["shards"][kind]
        for x, leaf in zip(mine, leaves):
            shard = next(s for s in leaf.addressable_shards if s.device == devices[r])
            np.testing.assert_array_equal(x.numpy(), np.asarray(shard.data))


def _leaves(seed: int):
    rng = np.random.default_rng(seed)
    shapes = [(64, 32), (7,), (128, 64), (3, 5, 2), (256,), (33, 17)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("bucket_mb", [0.0, 0.01, 0.05, 4.0])
def test_overlap_functions_equal_reference(bucket_mb):
    arrays = _leaves(3)
    jl = [jnp.asarray(a) for a in arrays]
    tl = [torch.as_tensor(a) for a in arrays]
    buckets = toverlap.assign_buckets(tl, bucket_mb)
    assert buckets == joverlap.assign_buckets(jl, bucket_mb)
    assert toverlap.overlap_fraction(tl, buckets) == joverlap.overlap_fraction(jl, buckets)
    assert toverlap.overlap_report(tl, buckets, bucket_mb) == \
        joverlap.overlap_report(jl, buckets, bucket_mb)
    assert toverlap.expected_all_reduces(buckets) == joverlap.expected_all_reduces(buckets)
    total = sum(a.nbytes for a in arrays)
    assert toverlap.bucket_cap_suggestion(total, 3) == joverlap.bucket_cap_suggestion(total, 3)
    assert toverlap.bucket_cap_suggestion(0) == joverlap.bucket_cap_suggestion(0)


def test_bucketed_grad_sync_rewrites_the_backward():
    """A traced backward whose grads leave as per-parameter mean
    all-reduces: one async all-reduce per bucket after its last grad, one
    wait per bucket before the return; traced on proxies, nothing runs."""
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.core.transforms import forward_and_backward_from_trace
    from thunder_tpu_torch.distributed import prims as dp
    from thunder_tpu_torch.functional import trace_from_fn

    def loss(ws, x):
        h = x
        for w in ws:
            h = torch.tanh(h @ dp.synchronize(w, "dp", 2, False).T)
        return h.sum()

    ws = [torch.randn(8, 8) for _ in range(3)]
    tr = trace_from_fn(loss, (ws, torch.randn(4, 8)), {}, grad_argnums=(0,)).computation_trace
    _, bw = forward_and_backward_from_trace(tr)
    buckets = [[2], [1, 0]]
    new = toverlap.bucketed_grad_sync(bw, axis="dp", buckets=buckets)
    names = [b.sym.name for b in new.bound_symbols]
    assert names.count("all_reduce") == 2 and names.count("wait") == 2
    starts = [i for i, b in enumerate(new.bound_symbols) if b.sym.name == "all_reduce"]
    assert all(b.kwargs.get("async_op") or b.args[-1] is True
               for b in new.bound_symbols if b.sym.name == "all_reduce")
    assert [len(new.bound_symbols[i].args[0]) for i in starts] == [1, 2]
    # the first bucket (the last layer's grad) is issued before the rest of the backward
    assert starts[0] < names.index("wait") and starts[0] < starts[1]
    assert new.bound_symbols[-1].sym.id is PrimIDs.RETURN
    assert names[-3:-1] == ["wait", "wait"]


def test_sharded_dispatch_is_counted():
    q = torch.randn(1, 2, 128, 16)
    before = dict(cudaex.DISPATCH)
    cudaex.flash_sdpa(q, q, q, causal=True, scale=0.25)
    with cudaex.mesh_context(object()):
        cudaex.flash_sdpa(q, q, q, causal=True, scale=0.25)
        cudaex.flash_cross_entropy(torch.randn(4, 8), torch.zeros(4, dtype=torch.long))
    assert cudaex.DISPATCH["direct"] - before["direct"] == 1
    assert cudaex.DISPATCH["sharded"] - before["sharded"] == 2


def test_worker_module_imports_no_jax():
    from test_torch_port_imports import FORBIDDEN, _imported_packages

    assert not _imported_packages(Path(workers.__file__)) & FORBIDDEN


class _StandIn:
    """A spawned rank as the launcher sees it: ``fails`` exits 1 at once
    after writing its traceback file, otherwise it runs until killed."""

    def __init__(self, target, args, daemon):
        self.rank, self.out_dir = args[0], args[-1]
        self.fails = args[-2][0] == self.rank
        self.exitcode = None

    def start(self):
        if self.fails:
            Path(self.out_dir, f"rank{self.rank}.err").write_text("ValueError: on purpose")
            self.exitcode = 1

    def is_alive(self):
        return self.exitcode is None

    def kill(self):
        self.exitcode = -9

    def join(self, timeout=None):
        pass


class _Context:
    Process = _StandIn


@pytest.mark.parametrize("failing", [1, None], ids=["a failed rank", "a hung world"])
def test_a_failed_or_hung_rank_fails_the_world(tmp_path, monkeypatch, failing):
    import multiprocessing

    monkeypatch.setattr(multiprocessing, "get_context", lambda method: _Context())
    match = "on purpose" if failing is not None else "killed after 0.2 s"
    with pytest.raises(RuntimeError, match=match):
        launch(print, 3, args=(failing,), timeout_s=0.2, workdir=str(tmp_path))
