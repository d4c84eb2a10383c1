"""thunder_tpu_torch quantized KV serving (``kv_dtype="int8"|"fp8"``) against the JAX package.

On the CPU, with numpy-made inputs fed to both packages:

- ``serving.quant``: ``quantize_kv``, ``dequantize_kv`` and the ``_q``
  gather/scatter twins store bytes and scales **bitwise** equal to the
  reference as its programs run it (jitted: XLA turns the division by the
  constant ``qmax`` into a multiply by ``f32(1/qmax)``, and the Pallas
  kernels run interpreted do the same), from float32 and bf16 inputs, with
  all-zero rows, values at exactly ±qmax and ±0.5 rounding ties; fp8 is
  compared as ``uint8`` bytes.  ``scatter_blocks_q``'s ``rel_err`` within
  1e-6 (f32 sums in another order);
- the byte helpers equal the reference's;
- the plain versions of ``paged_token_write_fused`` (plain and every
  masked offset) and ``paged_chunk_write_fused`` against
  ``pallasex`` interpreted: values and scales bitwise outside sink block 0,
  the chunk's error sums giving the same ``rel_err`` within 1e-6;
- ``paged_attn_decode`` / ``paged_attn_verify`` with scales against
  ``pallasex`` interpreted at atol 1e-5 in float32 (the tolerance of the
  unquantized cases), int8 and fp8, a window for decode, T=5 and T=16 for
  verify;
- served greedy tokens equal the JAX engine's exactly for int8 and fp8 on
  every lane (paged and gather decode, async and sync, prefix sharing,
  ``prefill_chunk=``, ``speculative=`` with and without
  ``draft_kv_dtype``), the ``serving.kv_quant.rel_err`` gauge within 1e-6,
  and an equal-bytes quantized pool admits more requests than a float one.
  The JAX engines run ``attn="gather"`` (their own tests hold their paged
  lanes to it, token for token), which compiles in a quarter of the time.

Tests marked ``cuda`` hold the four kernels against their plain versions
on the card; they skip without one.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tt
import thunder_tpu_torch as ttt
from thunder_tpu.executors import pallasex
from thunder_tpu.models import llama as jllama
from thunder_tpu.serving import SpecConfig as JSpecConfig
from thunder_tpu.serving import kv_pool as jkv
from thunder_tpu.serving import paged_attention as jpa
from thunder_tpu.serving import quant as jq
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.serving import paged_attention as tpa
from thunder_tpu_torch.serving import quant as tq
from thunder_tpu_torch.serving.kv_pool import ArenaMismatchError, PagedKVPool, chunk_tables
from torch_port_threads import one_torch_thread  # noqa: F401

STORAGE = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
QMAX = {"int8": 127.0, "fp8": 448.0}
KINDS = list(STORAGE)
# the gauge: two f32 sums over thousands of terms, added in another order
REL_ERR_ATOL = 1e-6


def _bytes(x) -> np.ndarray:
    """The raw bytes of a numpy/JAX/torch array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.uint8)


def _jq(fn, *args, **kw):
    """A reference ``serving.quant`` function run jitted, as the reference's
    programs run it."""
    return jax.jit(partial(fn, **kw))(*args)


def _vectors(kind, shape, seed=0):
    """Random (..., hs) vectors with the special rows the quantizer must
    get right: all zero (scale 1), exactly ±qmax with ±0.5 ties (the scale
    is then exactly 1, so x / scale is x itself), and one large row."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    hs, q = shape[-1], QMAX[kind]
    flat[0] = 0.0
    ties = np.array([0.5, -0.5, 1.5, -2.5, 3.5, 8.5, -17.0, 9.5, 0.25, 26.0], np.float32)
    flat[1] = np.resize(ties, hs)
    flat[1, 0], flat[1, 1] = q, -q                       # amax = qmax: scale exactly 1
    flat[2] = np.resize(np.array([q, -q, 0.0, 1.0], np.float32), hs)
    flat[3] *= 1e3
    return x


#
# serving.quant against the reference
#


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_kv_bitwise(kind, src):
    jst, tst = STORAGE[kind]
    x = _vectors(kind, (6, 2, 2, 16))
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    if src == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
        assert (_bytes(jx) == _bytes(tx)).all()
    jqv, js = _jq(jq.quantize_kv, jx, storage=jst)
    q, s = tq.quantize_kv(tx, tst)
    assert q.dtype == tst and s.dtype == torch.float32 and s.shape == x.shape[:-1]
    np.testing.assert_array_equal(_bytes(q), _bytes(jqv))
    np.testing.assert_array_equal(_bytes(s), _bytes(js))
    assert float(s.reshape(-1)[0]) == 1.0                 # the all-zero row
    assert float(s.reshape(-1)[1]) == 1.0                 # amax = qmax
    if kind == "int8":
        # the ties round half to even: 0.5 -> 0, -2.5 -> -2, 3.5 -> 4
        assert q.reshape(-1, 16)[1, 2:5].tolist() == [2, -2, 4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_dequantize_kv_bitwise(kind, dtype):
    jst, tst = STORAGE[kind]
    x = _vectors(kind, (4, 2, 2, 16), seed=1)
    jqv, js = _jq(jq.quantize_kv, jnp.asarray(x), storage=jst)
    q, s = tq.quantize_kv(torch.as_tensor(x), tst)
    want = _jq(jq.dequantize_kv, jqv, js, dtype=getattr(jnp, dtype))
    got = tq.dequantize_kv(q, s, getattr(torch, dtype))
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


def _quant_arenas(kind, num_blocks=12, L=2, ng=2, bs=4, hs=16, seed=2):
    """Quantized K and V arenas and their scales, the same bytes for both
    packages: ``(jax dict, torch dict)``."""
    jst, tst = STORAGE[kind]
    out_j, out_t = {}, {}
    for i, name in enumerate(("k", "v")):
        x = _vectors(kind, (num_blocks, L, ng, bs, hs), seed=seed + i)
        qj, sj = _jq(jq.quantize_kv, jnp.asarray(x), storage=jst)
        out_j[name], out_j[name + "_scale"] = qj, sj
        out_t[name] = torch.as_tensor(np.asarray(qj).view(np.uint8).copy()).view(tst)
        out_t[name + "_scale"] = torch.as_tensor(np.asarray(sj).copy())
    return out_j, out_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_gather_dense_q_bitwise(kind, dtype):
    ja, ta = _quant_arenas(kind)
    tables = np.array([[3, 1, 0], [5, 7, 9]], np.int32)
    want = _jq(jq.gather_dense_q, ja["k"], ja["v"], ja["k_scale"], ja["v_scale"],
               jnp.asarray(tables), dtype=getattr(jnp, dtype))
    got = tq.gather_dense_q(ta["k"], ta["v"], ta["k_scale"], ta["v_scale"],
                            torch.as_tensor(tables), getattr(torch, dtype))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 2, 2, 12, 16)
        np.testing.assert_array_equal(_bytes(g), _bytes(w))


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_scatter_token_q_bitwise(kind, src):
    ja, ta = _quant_arenas(kind)
    x = _vectors(kind, (3, 2, 2, 16), seed=5)
    blk, slot = np.array([4, 0, 8], np.int32), np.array([1, 0, 3], np.int32)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    if src == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    wa, ws = _jq(jq.scatter_token_q, ja["k"], ja["k_scale"], jx, jnp.asarray(blk),
                 jnp.asarray(slot))
    ga, gs = tq.scatter_token_q(ta["k"], ta["k_scale"], tx, torch.as_tensor(blk),
                                torch.as_tensor(slot))
    assert ga is ta["k"] and gs is ta["k_scale"]          # in place
    np.testing.assert_array_equal(_bytes(ga), _bytes(wa))
    np.testing.assert_array_equal(_bytes(gs), _bytes(ws))


@pytest.mark.parametrize("kind", KINDS)
def test_scatter_blocks_q_bitwise_and_rel_err(kind):
    ja, ta = _quant_arenas(kind)
    dense = _vectors(kind, (2, 1, 2, 12, 16), seed=6)     # (L, 1, ng, nb*bs, hs)
    dest = np.array([6, 0, 2], np.int32)                   # a sink entry in the middle
    wa, ws, werr = _jq(jq.scatter_blocks_q, ja["k"], ja["k_scale"], jnp.asarray(dense),
                       jnp.asarray(dest))
    ga, gs, gerr = tq.scatter_blocks_q(ta["k"], ta["k_scale"], torch.as_tensor(dense),
                                       torch.as_tensor(dest))
    np.testing.assert_array_equal(_bytes(ga)[1:], _bytes(wa)[1:])
    np.testing.assert_array_equal(_bytes(gs)[1:], _bytes(ws)[1:])
    assert gerr.dtype == torch.float32 and 0.0 < float(gerr) < 0.05
    assert abs(float(gerr) - float(werr)) <= REL_ERR_ATOL
    with pytest.raises(ArenaMismatchError, match="float dense cache"):
        tq.scatter_blocks_q(ta["k"], ta["k_scale"], torch.zeros(2, 1, 2, 12, 16,
                                                                 dtype=torch.int32),
                            torch.as_tensor(dest))


@pytest.mark.parametrize("name", ["tiny-llama-debug", "Llama-3-8B"])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_byte_helpers_equal_reference(name, kv_dtype, dtype):
    jcfg, tcfg = jllama.Config.from_name(name), ttt.Config.from_name(name)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jq.arena_block_bytes(jcfg, 16, jd, kv_dtype)
    assert tq.arena_block_bytes(tcfg, 16, td, kv_dtype) == want
    budget = 2048 * jq.arena_block_bytes(jcfg, 16, jnp.bfloat16)
    assert tq.blocks_for_arena_bytes(tcfg, 16, budget, td, kv_dtype) == \
        jq.blocks_for_arena_bytes(jcfg, 16, budget, jd, kv_dtype)
    if name == "Llama-3-8B" and kv_dtype is not None:
        assert want == 1081344                            # 1.94x the bf16 block's 2 MiB


def test_resolve_kv_dtype():
    f32 = torch.float32
    assert tq.resolve_kv_dtype(None, f32) is f32
    assert tq.resolve_kv_dtype("int8", f32) is torch.int8
    assert tq.resolve_kv_dtype(torch.int8, f32) is torch.int8
    for alias in ("fp8", "e4m3", "float8_e4m3fn", "FP8", torch.float8_e4m3fn):
        assert tq.resolve_kv_dtype(alias, f32) is torch.float8_e4m3fn
    assert tq.resolve_kv_dtype("float32", f32) is f32
    assert not tq.is_quantized_kv(f32, f32) and tq.is_quantized_kv(torch.int8, f32)
    assert tq._qmax(torch.int8) == 127.0 and tq._qmax(torch.float8_e4m3fn) == 448.0
    for bad in ("int4", torch.float16, "e5m2"):
        with pytest.raises(ValueError, match="unsupported kv_dtype"):
            tq.resolve_kv_dtype(bad, f32)


#
# the pool
#


@pytest.mark.parametrize("kind", KINDS)
def test_pool_geometry_bytes_and_validation(kind):
    jcfg = jllama.Config.from_name("tiny-llama-debug", n_layer=2)
    tcfg = ttt.Config.from_name("tiny-llama-debug", n_layer=2)
    ref = jkv.PagedKVPool(jcfg, num_blocks=8, block_size=4, dtype=jnp.float32, kv_dtype=kind)
    pool = PagedKVPool(tcfg, num_blocks=8, block_size=4, dtype=torch.float32, kv_dtype=kind,
                       device="cpu")
    assert pool.quantized_kv and pool.kv_dtype == STORAGE[kind][1]
    assert pool.k_arena.dtype == pool.kv_dtype and pool.k_scale.dtype == torch.float32
    assert tuple(pool.k_scale.shape) == tuple(ref.k_scale.shape) == pool.k_arena.shape[:-1]
    assert pool.block_bytes() == ref.block_bytes()
    assert set(pool.arenas) == {"k", "v", "k_scale", "v_scale"}
    assert pool.state_snapshot()["kv_dtype"] == str(pool.kv_dtype)
    assert pool.quantized_storage is pool.kv_dtype
    fresh = {n: torch.zeros_like(t) for n, t in pool.arenas.items()}
    pool.set_arenas(fresh)
    assert pool.k_scale is fresh["k_scale"]
    for name, bad, field in (("k_scale", torch.zeros(8, 2, 4, 4), "shape"),
                             ("v_scale", torch.zeros_like(pool.v_scale, dtype=torch.float64),
                              "dtype"),
                             ("k", torch.zeros_like(pool.k_arena, dtype=torch.float32),
                              "dtype")):
        with pytest.raises(ArenaMismatchError, match=name) as e:
            pool.set_arenas({**pool.arenas, name: bad})
        assert (e.value.arena, e.value.field) == (name, field)
    with pytest.raises(ArenaMismatchError, match="keys"):
        pool.set_arenas({"k": pool.k_arena, "v": pool.v_arena})
    plain = PagedKVPool(tcfg, num_blocks=8, block_size=4, dtype=torch.float32, device="cpu")
    assert not plain.quantized_kv and plain.k_scale is None and plain.quantized_storage is None
    assert set(plain.arenas) == {"k", "v"}


#
# the fused writes' plain versions against the Pallas kernels (interpreted)
#


def _tables(B, nbb, pos, bs, num_blocks, seed):
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, nbb), np.int32)
    free = rng.permutation(np.arange(1, num_blocks))
    k = 0
    for i, p in enumerate(pos):
        n = -(-int(p) // bs)
        tables[i, :n] = free[k:k + n]
        k += n
    return tables


@pytest.mark.parametrize("kind,offset", [("int8", None), *(("int8", k) for k in range(5)),
                                         ("fp8", None), ("fp8", 4)])
def test_paged_token_write_fused_plain_matches_pallas(kind, offset):
    """The plain write (``offset`` None) and every offset of a K=4 masked
    commit, n_emit from 0 (a padding row) to K+1 across the rows; fp8
    repeats the plain write and the last offset."""
    ja, ta = _quant_arenas(kind, num_blocks=32)
    pos = np.array([0, 5, 13, 9, 2, 11], np.int32)
    tables = _tables(6, 5, pos + 5, 4, 32, seed=7)
    vals = _vectors(kind, (6, 2, 2, 16), seed=8)
    n_emit = np.array([0, 5, 1, 3, 2, 4], np.int32)
    kw = {} if offset is None else {"offset": offset}
    wa, ws = pallasex.paged_token_write_fused(
        ja["k"], ja["k_scale"], jnp.asarray(vals), jnp.asarray(tables), jnp.asarray(pos),
        block_size=4, n_emit=None if offset is None else jnp.asarray(n_emit), **kw)
    before = _bytes(ta["k"]).copy()
    ga, gs = cudaex.paged_token_write_fused(
        ta["k"], ta["k_scale"], torch.as_tensor(vals), torch.as_tensor(tables),
        torch.as_tensor(pos), block_size=4,
        n_emit=None if offset is None else torch.as_tensor(n_emit), **kw)
    assert ga is ta["k"] and gs is ta["k_scale"]
    np.testing.assert_array_equal(_bytes(ga)[1:], _bytes(wa)[1:])
    np.testing.assert_array_equal(_bytes(gs)[1:], _bytes(ws)[1:])
    wrote = offset is None or bool((n_emit > offset).any())
    assert (_bytes(ga)[1:] != before[1:]).any() == wrote


@pytest.mark.parametrize("kind,pos,nc,leased", [
    ("int8", 0, 2, 4), ("int8", 8, 2, 5), ("int8", 12, 3, 4), ("int8", 16, 3, 6),
    ("fp8", 0, 2, 4), ("fp8", 16, 3, 6),
], ids=["int8-first-chunk", "int8-mid-chunk", "int8-past-leased", "int8-past-table",
        "fp8-first-chunk", "fp8-past-table"])
def test_paged_chunk_write_fused_plain_matches_pallas(kind, pos, nc, leased):
    bs, nbb = 4, 6
    ja, ta = _quant_arenas(kind, num_blocks=16)
    rng = np.random.default_rng(9)
    blocks = [int(b) for b in rng.permutation(np.arange(1, 16))[:leased]]
    _, dest = chunk_tables(blocks, pos, nc * bs, nbb, bs)
    vals = _vectors(kind, (nc, 2, 2, bs, 16), seed=10)
    p = np.array([pos], np.int32)
    wa, ws, werr = pallasex.paged_chunk_write_fused(
        ja["k"], ja["k_scale"], jnp.asarray(vals), jnp.asarray(dest), jnp.asarray(p),
        block_size=bs)
    ga, gs, gerr = cudaex.paged_chunk_write_fused(
        ta["k"], ta["k_scale"], torch.as_tensor(vals), torch.as_tensor(dest),
        torch.as_tensor(p), block_size=bs)
    np.testing.assert_array_equal(_bytes(ga)[1:], _bytes(wa)[1:])
    np.testing.assert_array_equal(_bytes(gs)[1:], _bytes(ws)[1:])
    werr = np.asarray(werr)
    assert tuple(gerr.shape) == (nc, 2)
    np.testing.assert_allclose(gerr.numpy(), werr[:, 0, :2], rtol=1e-5, atol=0)
    rel = float(gerr[:, 0].sum() / (gerr[:, 1].sum() + 1e-30))
    wrel = float(werr[:, 0, 0].sum() / (werr[:, 0, 1].sum() + 1e-30))
    assert abs(rel - wrel) <= REL_ERR_ATOL
    live = [c for c in range(nc) if pos // bs + c < nbb and dest[pos // bs + c]]
    assert all(gerr[c, 1] > 0 for c in live)
    assert all(gerr[c].abs().sum() == 0 for c in range(nc) if c not in live)


#
# dequantizing attention: the plain versions against the Pallas kernels
#


def _attn_case(kind, B, T, pos, nh=4, ng=2, hs=16, bs=4, nbb=6, L=2, num_blocks=24, seed=11):
    ja, ta = _quant_arenas(kind, num_blocks=num_blocks, L=L, ng=ng, bs=bs, hs=hs, seed=seed)
    rng = np.random.default_rng(seed + 1)
    tables = _tables(B, nbb, np.asarray(pos) + (T or 0), bs, num_blocks, seed)
    qshape = (B, nh, hs) if T is None else (B, nh, T, hs)
    fshape = (B, ng, hs) if T is None else (B, ng, T, hs)
    x = dict(q=rng.standard_normal(qshape).astype(np.float32),
             fresh_k=rng.standard_normal(fshape).astype(np.float32),
             fresh_v=rng.standard_normal(fshape).astype(np.float32),
             tables=tables, pos=np.asarray(pos, np.int32))
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.as_tensor(v) for k, v in x.items()}
    return (jx, ja), (tx, ta)


def _args(x, a):
    return (x["q"], a["k"], a["v"], x["fresh_k"], x["fresh_v"], x["tables"], x["pos"])


@pytest.mark.parametrize("kind,window,layer", [("int8", None, 1), ("fp8", 6, 0)],
                         ids=["int8-full", "fp8-window"])
def test_paged_attn_decode_dequant_matches_pallas(kind, window, layer):
    (jx, ja), (tx, ta) = _attn_case(kind, 4, None, [0, 5, 13, 19])
    want = pallasex.paged_attn_decode(*_args(jx, ja), layer=layer, window=window,
                                      k_scale=ja["k_scale"], v_scale=ja["v_scale"])
    got = cudaex.paged_attn_decode(*_args(tx, ta), layer=layer, window=window,
                                   k_scale=ta["k_scale"], v_scale=ta["v_scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind,T,pos", [("fp8", 5, [0, 5, 12, 14]), ("int8", 16, [8, 0, 4, 20])],
                         ids=["fp8-T5", "int8-T16"])
def test_paged_attn_verify_dequant_matches_pallas(kind, T, pos):
    (jx, ja), (tx, ta) = _attn_case(kind, 4, T, pos, nbb=10, num_blocks=40)
    want = pallasex.paged_attn_verify(*_args(jx, ja), layer=1, k_scale=ja["k_scale"],
                                      v_scale=ja["v_scale"])
    got = cudaex.paged_attn_verify(*_args(tx, ta), layer=1, k_scale=ta["k_scale"],
                                   v_scale=ta["v_scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_dequant_attention_rounds_through_the_compute_dtype():
    """bf16 compute: the dequantized K/V pass through bf16 before the
    float32 queries use them, as the Pallas kernel rounds (f32(x) * s ->
    cdtype -> q dtype); taking the f32 products directly differs."""
    (jx, ja), (tx, ta) = _attn_case("int8", 2, None, [7, 13])
    jx = {**jx, "fresh_k": jx["fresh_k"].astype(jnp.bfloat16),
          "fresh_v": jx["fresh_v"].astype(jnp.bfloat16)}
    tx = {**tx, "fresh_k": tx["fresh_k"].to(torch.bfloat16),
          "fresh_v": tx["fresh_v"].to(torch.bfloat16)}
    want = pallasex.paged_attn_decode(*_args(jx, ja), layer=1, k_scale=ja["k_scale"],
                                      v_scale=ja["v_scale"])
    got = cudaex.paged_attn_decode(*_args(tx, ta), layer=1, k_scale=ta["k_scale"],
                                   v_scale=ta["v_scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    f32 = cudaex.paged_attn_decode(*_args({**tx, "fresh_k": tx["fresh_k"].float(),
                                           "fresh_v": tx["fresh_v"].float()}, ta), layer=1,
                                   k_scale=ta["k_scale"], v_scale=ta["v_scale"])
    assert (f32 - got).abs().max() > 1e-5


def test_quantized_wrappers_validate_and_count_no_cpu_launches():
    (_, _), (tx, ta) = _attn_case("fp8", 2, None, [3, 9])
    cudaex.reset_launches()
    cudaex.paged_attn_decode(*_args(tx, ta), layer=0, k_scale=ta["k_scale"],
                             v_scale=ta["v_scale"])
    vals = torch.zeros(2, 2, 2, 16)
    cudaex.paged_token_write_fused(ta["k"], ta["k_scale"], vals, tx["tables"], tx["pos"],
                                   block_size=4)
    cudaex.paged_chunk_write_fused(ta["k"], ta["k_scale"], torch.zeros(1, 2, 2, 4, 16),
                                   tx["tables"][0], torch.tensor([4], dtype=torch.int32),
                                   block_size=4)
    assert set(cudaex.LAUNCHES.values()) == {0}
    args = _args(tx, ta)
    with pytest.raises(ValueError, match="both or neither"):
        cudaex.paged_attn_decode(*args, layer=0, v_scale=ta["v_scale"])
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        cudaex.paged_attn_decode(*args[:1], args[1].float(), args[2].float(), *args[3:],
                                 layer=0, k_scale=ta["k_scale"], v_scale=ta["v_scale"])
    with pytest.raises(ValueError, match="k_scale must be float32"):
        cudaex.paged_attn_verify(tx["q"][:, :, None].contiguous(), ta["k"], ta["v"],
                                 tx["fresh_k"][:, :, None].contiguous(),
                                 tx["fresh_v"][:, :, None].contiguous(), tx["tables"],
                                 tx["pos"], layer=0, k_scale=ta["k_scale"][..., :2].contiguous(),
                                 v_scale=ta["v_scale"])
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        cudaex.paged_token_write_fused(torch.zeros(12, 2, 2, 4, 16), ta["k_scale"], vals,
                                       tx["tables"], tx["pos"], block_size=4)
    with pytest.raises(ValueError, match="compute dtype"):
        cudaex.paged_token_write_fused(ta["k"], ta["k_scale"], vals.to(torch.int8),
                                       tx["tables"], tx["pos"], block_size=4)
    with pytest.raises(ValueError, match="needs n_emit"):
        cudaex.paged_token_write_fused(ta["k"], ta["k_scale"], vals, tx["tables"], tx["pos"],
                                       block_size=4, offset=1)
    with pytest.raises(ValueError, match="n_emit must be int32"):
        cudaex.paged_token_write_fused(ta["k"], ta["k_scale"], vals, tx["tables"], tx["pos"],
                                       block_size=4, n_emit=torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="scale_arena"):
        cudaex.paged_chunk_write_fused(ta["k"], ta["k_scale"][:, :1].contiguous(),
                                       torch.zeros(1, 2, 2, 4, 16), tx["tables"][0],
                                       torch.tensor([4], dtype=torch.int32), block_size=4)


#
# the serving functions of paged_attention on quantized arenas
#


def _micro(seed=0, **overrides):
    micro = dict(n_layer=2, n_head=4, n_query_groups=2, n_embd=32, intermediate_size=64,
                 vocab_size=64, block_size=64)
    jcfg = jllama.Config.from_name("tiny-llama-debug", **{**micro, **overrides})
    tcfg = ttt.Config.from_name("tiny-llama-debug", **{**micro, **overrides})
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = ttt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def target():
    return _micro()


@pytest.mark.parametrize("kind,T,pos", [("int8", 1, [0, 5, 8, 13]), ("fp8", 8, [8, 0, 4, 12])],
                         ids=["decode-int8", "chunk-fp8"])
def test_forward_paged_on_quantized_arenas_matches_jax(target, kind, T, pos):
    jcfg, tcfg, jp, tp = target
    (jx, ja), (tx, ta) = _attn_case(kind, 4, T, pos, nbb=7, num_blocks=32, hs=8)
    idx = np.random.default_rng(12).integers(0, 64, (4, T)).astype(np.int32)
    cap = 7 * 4
    jcos, jsin = jllama.build_rope_cache(jcfg, cap)
    # jitted, as the reference's engine runs it (one compile, not an XLA
    # compile per eager op)
    want, wfresh = jax.jit(partial(jpa.forward_paged, cfg=jcfg, cdtype=jnp.float32))(
        jp, jnp.asarray(idx), jx["pos"], ja, jx["tables"], jcos, jsin)
    tcos, tsin = ttt.models.llama.build_rope_cache(tcfg, cap, device="cpu")
    got, fresh = tpa.forward_paged(tp, torch.as_tensor(idx), tx["pos"], ta, tx["tables"], tcos,
                                   tsin, tcfg, cdtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(fresh["k"].numpy(), np.asarray(wfresh["k"]), atol=1e-5, rtol=0)


def _writer_case(kind, T, pos, seed=13):
    (jx, ja), (tx, ta) = _attn_case(kind, 4, T, pos, nbb=7, num_blocks=32, seed=seed)
    shape = (4, 2, 2, 16) if T == 1 else (4, 2, 2, T, 16)
    fresh = {n: _vectors(kind, shape, seed=seed + i) for i, n in enumerate(("k", "v"))}
    return ((jx, ja, {n: jnp.asarray(v) for n, v in fresh.items()}),
            (tx, ta, {n: torch.as_tensor(v) for n, v in fresh.items()}))


def _assert_arenas_equal(got, want):
    for n in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(_bytes(got[n])[1:], _bytes(want[n])[1:])


@pytest.mark.parametrize("kind", ["int8"])
def test_write_fresh_kv_quantized_matches_jax(kind):
    (jx, ja, jf), (tx, ta, tf) = _writer_case(kind, 1, [0, 5, 8, 13])
    jst, tst = STORAGE[kind]
    want = jpa.write_fresh_kv(ja, jf, jx["tables"], jx["pos"], block_size=4, kv_dtype=jst)
    got = tpa.write_fresh_kv(ta, tf, tx["tables"], tx["pos"], block_size=4, kv_dtype=tst)
    _assert_arenas_equal(got, want)


def test_write_fresh_kv_masked_quantized_matches_jax():
    jst, tst = STORAGE["int8"]
    (jx, ja, jf), (tx, ta, tf) = _writer_case("int8", 3, [0, 5, 8, 13])
    n_emit = np.array([0, 3, 2, 1], np.int32)
    want = jpa.write_fresh_kv_masked(ja, jf, jx["tables"], jx["pos"], jnp.asarray(n_emit),
                                     block_size=4, kv_dtype=jst)
    got = tpa.write_fresh_kv_masked(ta, tf, tx["tables"], tx["pos"], torch.as_tensor(n_emit),
                                    block_size=4, kv_dtype=tst)
    _assert_arenas_equal(got, want)


def test_write_fresh_kv_live_quantized_matches_jax():
    kind = "fp8"
    jst, tst = STORAGE[kind]
    (jx, ja, jf), (tx, ta, tf) = _writer_case(kind, 1, [0, 5, 8, 13], seed=14)
    live = np.array([False, True, False, True])
    want = jpa.write_fresh_kv_live(ja, jf, jx["tables"], jx["pos"], jnp.asarray(live),
                                   block_size=4, kv_dtype=jst)
    got = tpa.write_fresh_kv_live(ta, tf, tx["tables"], tx["pos"], torch.as_tensor(live),
                                  block_size=4, kv_dtype=tst)
    _assert_arenas_equal(got, want)


@pytest.mark.parametrize("kind,pos", [("int8", 0), ("fp8", 8)])
def test_write_fresh_kv_chunk_quantized_matches_jax(kind, pos):
    jst, tst = STORAGE[kind]
    (jx, ja, jf), (tx, ta, tf) = _writer_case(kind, 8, [pos, 0, 0, 0])
    jf = {n: v[:1] for n, v in jf.items()}
    tf = {n: v[:1].contiguous() for n, v in tf.items()}
    _, dest = chunk_tables([int(b) for b in np.asarray(jx["tables"])[0] if b], pos, 8, 7, 4)
    p = np.array([pos], np.int32)
    want, wq = jpa.write_fresh_kv_chunk(ja, jf, jnp.asarray(dest), jnp.asarray(p), block_size=4,
                                        kv_dtype=jst)
    got, gq = tpa.write_fresh_kv_chunk(ta, tf, torch.as_tensor(dest), torch.as_tensor(p),
                                       block_size=4, kv_dtype=tst)
    _assert_arenas_equal(got, want)
    assert 0.0 < float(gq) < 0.05 and abs(float(gq) - float(wq)) <= REL_ERR_ATOL


#
# served tokens against the JAX engine
#

ENGINE = dict(block_size=4, num_blocks=32, max_batch=4, batch_buckets=(4,), block_buckets=(6,),
              prefill_buckets=(16,))
CHUNKED = dict(block_size=4, num_blocks=32, max_batch=4, batch_buckets=(4,),
               block_buckets=(6, 12), prefill_buckets=(8, 16), prefill_chunk=8)
SPEC = dict(block_size=4, num_blocks=64, max_batch=4, batch_buckets=(4,), block_buckets=(8,),
            prefill_buckets=(16,))
LENS, CHUNK_LENS, SPEC_LENS = (3, 5, 9, 14), (13, 21, 9), (7, 5, 11)
PREFIX = (np.arange(10) * 7 + 3).astype(np.int32) % 64


def _prompts(lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in lens]


def _drive(eng, prompts, n=5):
    handles = [eng.submit(p, max_new_tokens=n) for p in prompts]
    eng.drain()
    return [tuple(int(t) for t in h.result(drive=False).tokens) for h in handles]


def _drive_shared(eng):
    ha = eng.submit(PREFIX, max_new_tokens=4)
    eng.step()
    hb = eng.submit(PREFIX.copy(), max_new_tokens=4)
    eng.step()
    eng.drain()
    ra, rb = ha.result(drive=False), hb.result(drive=False)
    return tuple(ra.tokens.tolist()), tuple(rb.tokens.tolist()), rb.shared_prefix_blocks


def _jax_gauge():
    from thunder_tpu.observability.metrics import registry

    return registry().gauge("serving.kv_quant.rel_err").value


def _port_gauge():
    from thunder_tpu_torch.observability import registry

    return registry().gauge("serving.kv_quant.rel_err").value


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_program_cache_as_found():
    """The JAX engine memoizes compiled programs in a bounded module cache
    that other test files count; leave it exactly as found."""
    from thunder_tpu.serving import engine as jengine

    before = dict(jengine._program_cache)
    yield
    jengine._program_cache.clear()
    jengine._program_cache.update(before)


@pytest.fixture(scope="module")
def draft():
    return _micro(seed=9, n_layer=1)


@pytest.fixture(scope="module", params=KINDS)
def served(request, target, draft):
    """The JAX engine's greedy tokens (and its last rel_err gauge) on each
    lane, for one storage kind."""
    kind = request.param
    jcfg, _, jp, _ = target
    jdcfg, _, jdp, _ = draft
    common = dict(attn="gather", cache_dtype=jnp.float32, kv_dtype=kind)
    out = {"kind": kind}
    out["plain"] = (_drive(tt.serve(None, jp, jcfg, **common, **ENGINE), _prompts(LENS)),
                    _jax_gauge())
    out["shared"] = _drive_shared(tt.serve(None, jp, jcfg, **common,
                                           **{**ENGINE, "max_batch": 2}))
    out["chunked"] = (_drive(tt.serve(None, jp, jcfg, **common, **CHUNKED),
                             _prompts(CHUNK_LENS), n=4), _jax_gauge())
    spec = tt.serve(None, jp, jcfg, speculative=JSpecConfig(jdp, jdcfg, K=2), **common, **SPEC)
    out["spec"] = (_drive(spec, _prompts(SPEC_LENS, seed=1), n=9), _jax_gauge())
    return out


def _port(tcfg, tp, **kw):
    return ttt.serve(None, tp, tcfg, device="cpu", **kw)


@pytest.mark.parametrize("async_step", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("attn", ["paged", "gather", "auto"])
def test_quantized_greedy_tokens_equal_jax_engine(target, served, attn, async_step):
    _, tcfg, _, tp = target
    want, gauge = served["plain"]
    eng = _port(tcfg, tp, attn=attn, async_step=async_step, kv_dtype=served["kind"], **ENGINE)
    assert _drive(eng, _prompts(LENS)) == want
    st = eng.stats()
    assert st["kv_dtype"] == str(STORAGE[served["kind"]][1])
    assert st["attn"]["mode"] == ("gather" if attn == "gather" else "paged")
    assert st["attn"]["kernel_steps"] == (0 if attn == "gather" else st["decode_steps"])
    assert abs(_port_gauge() - gauge) <= REL_ERR_ATOL and 0.0 < _port_gauge() < 0.05


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_quantized_shared_prefix_tokens_equal_jax_engine(target, served, attn):
    _, tcfg, _, tp = target
    got = _drive_shared(_port(tcfg, tp, attn=attn, kv_dtype=served["kind"],
                              **{**ENGINE, "max_batch": 2}))
    assert got == served["shared"] and got[2] == 2


@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_quantized_chunked_tokens_equal_jax_engine(target, served, attn):
    _, tcfg, _, tp = target
    want, gauge = served["chunked"]
    eng = _port(tcfg, tp, attn=attn, kv_dtype=served["kind"], **CHUNKED)
    assert _drive(eng, _prompts(CHUNK_LENS), n=4) == want
    st = eng.stats()
    assert st["chunk_runs"] == 4
    assert st["attn"]["kinds"]["prefill_chunk"]["mode"] == attn
    assert abs(_port_gauge() - gauge) <= REL_ERR_ATOL


@pytest.mark.parametrize("draft_kv_dtype", [None, "same", "float32"])
@pytest.mark.parametrize("attn", ["paged", "gather"])
def test_quantized_spec_tokens_equal_jax_spec_engine(target, draft, served, attn,
                                                     draft_kv_dtype):
    """``draft_kv_dtype`` None inherits the target's storage; "same" names
    it explicitly; "float32" keeps the draft arena unquantized."""
    _, tcfg, _, tp = target
    _, dcfg, _, dp = draft
    kind = served["kind"]
    dkv = kind if draft_kv_dtype == "same" else draft_kv_dtype
    want, gauge = served["spec"]
    eng = _port(tcfg, tp, attn=attn, kv_dtype=kind,
                speculative=ttt.SpecConfig(dp, dcfg, K=2, draft_kv_dtype=dkv), **SPEC)
    assert _drive(eng, _prompts(SPEC_LENS, seed=1), n=9) == want
    assert eng.draft_pool.kv_dtype == (torch.float32 if dkv == "float32" else STORAGE[kind][1])
    assert abs(_port_gauge() - gauge) <= REL_ERR_ATOL


def test_quantized_draft_arena_under_a_float_target(target, draft):
    """``draft_kv_dtype`` quantizes the draft arena alone: the JAX engine
    with the same split serves the same tokens."""
    jcfg, tcfg, jp, tp = target
    jdcfg, dcfg, jdp, dp = draft
    ref = tt.serve(None, jp, jcfg, attn="gather", cache_dtype=jnp.float32,
                   speculative=JSpecConfig(jdp, jdcfg, K=2, draft_kv_dtype="int8"), **SPEC)
    want = _drive(ref, _prompts(SPEC_LENS, seed=1), n=9)
    eng = _port(tcfg, tp, speculative=ttt.SpecConfig(dp, dcfg, K=2, draft_kv_dtype="int8"),
                **SPEC)
    assert _drive(eng, _prompts(SPEC_LENS, seed=1), n=9) == want
    assert not eng.pool.quantized_kv and eng.draft_pool.kv_dtype == torch.int8


def test_equal_bytes_quantized_pool_admits_more_requests(target):
    """At one arena-byte budget the int8 engine keeps more requests
    resident than the float32 engine (tests/test_serving_quant.py's
    capacity check, on the port)."""
    _, tcfg, _, tp = target
    budget = 13 * tq.arena_block_bytes(tcfg, 4, torch.float32)
    nb_f32 = tq.blocks_for_arena_bytes(tcfg, 4, budget, torch.float32)
    nb_i8 = tq.blocks_for_arena_bytes(tcfg, 4, budget, torch.float32, kv_dtype="int8")
    assert nb_i8 > nb_f32

    def peak(**kw):
        eng = _port(tcfg, tp, block_size=4, max_batch=16, batch_buckets=(16,),
                    block_buckets=(4,), prefill_buckets=(16,), **kw)
        for i in range(8):
            eng.submit(np.arange(4, dtype=np.int32) + i, max_new_tokens=12)
        top = 0
        while eng.scheduler.queue or eng.scheduler.running:
            eng.step()
            top = max(top, len(eng.scheduler.running))
        assert eng.pool.arena_bytes() <= budget
        return top

    assert peak(num_blocks=nb_i8, kv_dtype="int8") > peak(num_blocks=nb_f32)


def test_bytes_needed_reflects_storage_dtype(target):
    _, tcfg, _, tp = target
    f32 = _port(tcfg, tp, **ENGINE)
    i8 = _port(tcfg, tp, kv_dtype="int8", **ENGINE)
    p = np.arange(6, dtype=np.int32)
    rf = f32.scheduler.submit(p, 10, generator=torch.Generator())
    ri = i8.scheduler.submit(p, 10, generator=torch.Generator())
    hs = tcfg.head_size
    assert f32.scheduler.bytes_needed(rf) / i8.scheduler.bytes_needed(ri) == \
        pytest.approx(hs * 4 / (hs + 4))


#
# on the card (skipped here)
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_arenas(card, kind, num_blocks=64, L=3, ng=2, bs=16, hs=64, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    tst = STORAGE[kind][1]
    out = {}
    for name in ("k", "v"):
        x = torch.randn((num_blocks, L, ng, bs, hs), generator=gen, device=card) * 2
        out[name], out[name + "_scale"] = tq.quantize_kv(x, tst)
    return out


def _card_case(card, kind, B, nh, ng, hs, T, pos, dtype, num_blocks=64, nbb=8):
    a = _card_arenas(card, kind, num_blocks=num_blocks, ng=ng, hs=hs)
    gen = torch.Generator(device=card).manual_seed(1)
    qshape = (B, nh, hs) if T is None else (B, nh, T, hs)
    fshape = (B, ng, hs) if T is None else (B, ng, T, hs)
    tables = _tables(B, nbb, np.asarray(pos) + (T or 0), 16, num_blocks, seed=2)
    x = dict(q=torch.randn(qshape, generator=gen, device=card).to(dtype),
             k_arena=a["k"], v_arena=a["v"],
             fresh_k=torch.randn(fshape, generator=gen, device=card).to(dtype),
             fresh_v=torch.randn(fshape, generator=gen, device=card).to(dtype),
             tables=torch.as_tensor(tables, device=card),
             pos=torch.as_tensor(np.asarray(pos, np.int32), device=card),
             k_scale=a["k_scale"], v_scale=a["v_scale"])
    return x


def _held_to_plain(kernel, plain, x, **kw):
    """float32: within 1e-5 of the plain version; bf16/f16: the kernel's
    error against the float32 plain result of the same inputs at most twice
    the plain version's own."""
    got = kernel(**x, **kw)
    torch.cuda.synchronize()
    want = plain(**x, **kw)
    if x["q"].dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
        return
    ref = plain(**{k: v.float() if k in ("q", "fresh_k", "fresh_v") else v
                   for k, v in x.items()}, **kw)
    err_kernel = (got.float() - ref).abs().max().item()
    err_plain = (want.float() - ref).abs().max().item()
    assert torch.isfinite(got).all() and err_kernel <= 2 * err_plain, (err_kernel, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,ng,hs,window", [(32, 8, 128, None), (8, 2, 64, 40)])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_paged_attn_decode_dequant_matches_plain(card, kind, nh, ng, hs, window, dtype):
    x = _card_case(card, kind, 4, nh, ng, hs, None, [0, 1, 33, 100], dtype)
    _held_to_plain(cudaex.paged_attn_decode, cudaex.paged_attn_decode_plain, x, layer=2,
                   window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("nh,ng,hs,T", [(32, 8, 128, 5), (8, 2, 64, 40), (4, 2, 128, 130)])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_paged_attn_verify_dequant_matches_plain(card, kind, nh, ng, hs, T, dtype):
    """bf16/f16 run the tensor-core body on the quantized arena, float32 the
    scalar one."""
    x = _card_case(card, kind, 4, nh, ng, hs, T, [0, 1, 33, 64], dtype, nbb=24)
    _held_to_plain(cudaex.paged_attn_verify, cudaex.paged_attn_verify_plain, x, layer=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_fused_writes_match_plain_bitwise(card, kind, dtype):
    a = _card_arenas(card, kind)
    tables = torch.as_tensor(_tables(4, 8, [5, 17, 40, 64], 16, 64, seed=3), device=card)
    pos = torch.tensor([0, 1, 33, 64], dtype=torch.int32, device=card)
    gen = torch.Generator(device=card).manual_seed(4)
    for n_emit, offsets in ((None, [0]), (torch.tensor([0, 3, 1, 5], dtype=torch.int32,
                                                        device=card), range(5))):
        for off in offsets:
            vals = (torch.randn((4, 3, 2, 64), generator=gen, device=card) * 3).to(dtype)
            vals[0, 0, 0] = 0.0                               # an all-zero vector
            kw = {} if n_emit is None else {"n_emit": n_emit, "offset": off}
            want = cudaex.paged_token_write_fused_plain(a["k"].clone(), a["k_scale"].clone(),
                                                        vals, tables, pos, block_size=16, **kw)
            got = cudaex.paged_token_write_fused(a["k"], a["k_scale"], vals, tables, pos,
                                                 block_size=16, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0].view(torch.uint8)[1:], want[0].view(torch.uint8)[1:])
            assert torch.equal(got[1][1:], want[1][1:])
    dest = tables[3]
    for p0, nc in ((0, 2), (16, 3), (96, 4)):
        vals = (torch.randn((nc, 3, 2, 16, 64), generator=gen, device=card) * 3).to(dtype)
        p = torch.tensor([p0], dtype=torch.int32, device=card)
        wa, ws, werr = cudaex.paged_chunk_write_fused_plain(a["k"].clone(), a["k_scale"].clone(),
                                                            vals, dest, p, block_size=16)
        ga, gs, gerr = cudaex.paged_chunk_write_fused(a["k"], a["k_scale"], vals, dest, p,
                                                      block_size=16)
        torch.cuda.synchronize()
        assert torch.equal(ga.view(torch.uint8)[1:], wa.view(torch.uint8)[1:])
        assert torch.equal(gs[1:], ws[1:])
        torch.testing.assert_close(gerr, werr, rtol=1e-5, atol=0)
