"""The paged-attention bodies of thunder_tpu_torch: the split-K walk of
``paged_attn_decode`` and of ``paged_attn_verify`` at few rows, and the body
each call takes on the card (``cudaex.paged_body``).

On the CPU the plain versions cut the arena walk as the split-K body does
(``splits=s``: s contiguous shares of each request's live blocks, folded in
split order) and are held against the Pallas kernels run interpreted on
the same numpy-made inputs: float32 within 1e-5 (the same online softmax
in another order), bf16 by the ratio bar (the error against the float32
result at most twice the Pallas kernel's own in bf16).  The split count is
checked to come from shapes alone.  Tests marked ``cuda`` hold every body
against its plain version on the card and skip without one.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.executors import pallasex
from thunder_tpu.serving import quant as jq
from thunder_tpu_torch.executors import cudaex
from torch_port_threads import one_torch_thread  # noqa: F401

ATOL_F32 = 1e-5
LOWP_ERR_RATIO = 2.0
STORAGE = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
NAMES = ("q", "k_arena", "v_arena", "fresh_k", "fresh_v", "tables", "pos")


def _case(B, nh, ng, hs, bs, nbb, L, pos, T=None, seed=0, num_blocks=24):
    """Numpy inputs: ragged positions, sink-padded tables that also cover
    the chunk's own blocks (T tokens at pos; never attended)."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(pos, np.int32)
    tables = np.zeros((B, nbb), np.int32)
    free = rng.permutation(np.arange(1, num_blocks))
    k = 0
    for i, p in enumerate(pos):
        n = min(-(-(int(p) + (T or 0)) // bs), nbb)
        tables[i, :n] = free[k:k + n]
        k += n
    arena = (num_blocks, L, ng, bs, hs)
    qs, fs = ((B, nh, hs), (B, ng, hs)) if T is None else ((B, nh, T, hs), (B, ng, T, hs))
    return dict(q=rng.standard_normal(qs).astype(np.float32),
                k_arena=rng.standard_normal(arena).astype(np.float32),
                v_arena=rng.standard_normal(arena).astype(np.float32),
                fresh_k=rng.standard_normal(fs).astype(np.float32),
                fresh_v=rng.standard_normal(fs).astype(np.float32),
                tables=tables, pos=pos)


def _quantized(case, kind):
    """The case with its arenas quantized by the reference's jitted
    ``quantize_kv``: (numpy case, numpy scales) for both packages."""
    jst, _ = STORAGE[kind]
    out = dict(case)
    for name in ("k", "v"):
        qv, sc = jax.jit(partial(jq.quantize_kv, storage=jst))(jnp.asarray(case[f"{name}_arena"]))
        out[f"{name}_arena"], out[f"{name}_scale"] = np.asarray(qv), np.asarray(sc)
    return out


def _jax(case, dtype=None):
    out = {}
    for k, v in case.items():
        a = jnp.asarray(v)
        if dtype is not None and k in ("q", "fresh_k", "fresh_v", "k_arena", "v_arena") \
                and a.dtype == jnp.float32:
            a = a.astype(dtype)
        out[k] = a
    return out


def _torch(case, dtype=None, device="cpu"):
    out = {}
    for k, v in case.items():
        if v.dtype == jnp.float8_e4m3fn:
            t = torch.as_tensor(v.view(np.uint8).copy()).view(torch.float8_e4m3fn)
        else:
            t = torch.as_tensor(np.array(v))
        if dtype is not None and t.dtype == torch.float32 and k not in ("k_scale", "v_scale"):
            t = t.to(dtype)
        out[k] = t.to(device)
    return out


def _pallas(kind, jx, **kw):
    fn = pallasex.paged_attn_decode if kind == "decode" else pallasex.paged_attn_verify
    scales = {k: jx[k] for k in ("k_scale", "v_scale") if k in jx}
    return np.asarray(fn(*(jx[k] for k in NAMES), **scales, **kw).astype(jnp.float32))


def _plain(kind, tx, **kw):
    fn = cudaex.paged_attn_decode_plain if kind == "decode" else cudaex.paged_attn_verify_plain
    return fn(**tx, **kw).float().numpy()


# (B, nh, ng, hs, bs, nbb, L, pos, window, layer): ragged positions with a
# padding row (pos 0), block-edge positions, a row whose one live block
# leaves the other splits empty, sliding windows, GQA / MHA / MQA
DECODE_CASES = [
    pytest.param(4, 4, 2, 16, 4, 6, 3, [0, 3, 13, 24], None, 1, id="gqa-pad-edge-one-block"),
    pytest.param(4, 4, 2, 16, 4, 6, 3, [0, 5, 13, 19], 6, 2, id="gqa-window"),
    pytest.param(3, 4, 4, 8, 4, 5, 2, [4, 0, 16], None, 0, id="mha-block-edges"),
    pytest.param(3, 6, 1, 8, 3, 7, 2, [1, 7, 20], 4, 1, id="mqa-window"),
]


@lru_cache(maxsize=None)
def _reference(attn, dims, T=None, quant=None, seed=0, num_blocks=24, **kw):
    """A case and the Pallas kernel's output on it, computed once for every
    split count that is held against it."""
    case = _case(*dims, T=T, seed=seed, num_blocks=num_blocks)
    if quant is not None:
        case = _quantized(case, quant)
    return case, _pallas(attn, _jax(case), **kw)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("B,nh,ng,hs,bs,nbb,L,pos,window,layer", DECODE_CASES)
def test_decode_plain_splits_match_pallas(B, nh, ng, hs, bs, nbb, L, pos, window, layer, splits):
    case, want = _reference("decode", (B, nh, ng, hs, bs, nbb, L, tuple(pos)), layer=layer,
                            window=window)
    got = _plain("decode", _torch(case), layer=layer, window=window, splits=splits)
    np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)


# (B, nh, ng, hs, bs, nbb, L, T, pos, layer)
VERIFY_CASES = [
    pytest.param(4, 4, 2, 16, 4, 8, 3, 5, [0, 3, 12, 19], 1, id="gqa-T5-pad-edge-one-block"),
    pytest.param(3, 6, 1, 8, 3, 9, 2, 6, [1, 9, 12], 0, id="mqa-T6"),
    pytest.param(2, 4, 2, 16, 4, 6, 1, 8, [8, 0], 0, id="gqa-T2bs"),
]


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("B,nh,ng,hs,bs,nbb,L,T,pos,layer", VERIFY_CASES)
def test_verify_plain_splits_match_pallas(B, nh, ng, hs, bs, nbb, L, T, pos, layer, splits):
    case, want = _reference("verify", (B, nh, ng, hs, bs, nbb, L, tuple(pos)), T=T,
                            num_blocks=40, layer=layer)
    got = _plain("verify", _torch(case), layer=layer, splits=splits)
    np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("kind", list(STORAGE))
@pytest.mark.parametrize("attn", ["decode", "verify"])
def test_quantized_plain_splits_match_pallas(attn, kind, splits):
    T = None if attn == "decode" else 5
    kw = dict(layer=1) if T else dict(layer=1, window=9)
    case, want = _reference(attn, (4, 4, 2, 16, 4, 8, 2, (0, 3, 13, 22)), T=T, quant=kind,
                            seed=3, num_blocks=40, **kw)
    got = _plain(attn, _torch(case), splits=splits, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=0)


@lru_cache(maxsize=None)
def _bf16_reference(attn):
    """bf16-rounded inputs, the Pallas kernel's float32 result on them, and
    its own error in bf16."""
    T = None if attn == "decode" else 5
    case = _case(4, 4, 2, 16, 4, 12, 2, [0, 7, 29, 41], T=T, num_blocks=48, seed=5)
    rounded = {k: (np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
                   if v.dtype == np.float32 else v) for k, v in case.items()}
    ref = _pallas(attn, _jax(rounded), layer=1)
    return rounded, ref, np.abs(_pallas(attn, _jax(rounded, jnp.bfloat16), layer=1) - ref).max()


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("attn", ["decode", "verify"])
def test_bf16_plain_splits_by_the_ratio_bar(attn, splits):
    """bf16: the split walk's error against the float32 result of the same
    bf16-rounded inputs is at most twice the Pallas kernel's own in bf16."""
    rounded, ref, err_pallas = _bf16_reference(attn)
    got = _plain(attn, _torch(rounded, torch.bfloat16), layer=1, splits=splits)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= LOWP_ERR_RATIO * err_pallas


@pytest.mark.parametrize("window", [None, 3, 10])
def test_split_ranges_cover_every_live_block_once(window):
    """The shares of every split count tile [lo, hi) exactly, in order."""
    bs, nbb = 4, 9
    pos = torch.tensor([0, 1, 4, 5, 16, 17, 35, 36, 60], dtype=torch.int32)
    p = pos.long()
    hi = torch.clamp((p + bs - 1) // bs, max=nbb)
    lo = torch.clamp(p - (window - 1), min=0) // bs if window else torch.zeros_like(p)
    for splits in range(1, 12):
        cover = torch.zeros((len(pos), nbb), dtype=torch.int64)
        last = lo.clone()
        for s in range(splits):
            jb, je = cudaex._split_range(pos, bs, nbb, window, s, splits)
            assert torch.equal(jb, last) and bool((je >= jb).all())   # contiguous, in order
            for i in range(len(pos)):
                cover[i, int(jb[i]):int(je[i])] += 1
            last = je
        want = torch.zeros_like(cover)
        for i in range(len(pos)):
            want[i, int(lo[i]):int(hi[i])] = 1
        assert torch.equal(cover, want), (splits, cover)


@pytest.mark.parametrize("kind,rows,hs,bs,q,kv,want", [
    ("decode", 4, 128, 16, torch.bfloat16, torch.bfloat16, "split"),
    ("decode", 71, 64, 16, torch.float32, torch.float32, "split"),
    ("decode", 4, 16, 16, torch.float32, torch.int8, "split"),
    ("verify", 20, 128, 16, torch.bfloat16, torch.bfloat16, "split"),
    ("verify", 64, 128, 16, torch.float16, torch.float8_e4m3fn, "split"),
    ("verify", 2048, 128, 16, torch.bfloat16, torch.bfloat16, "wg"),
    ("verify", 2048, 128, 16, torch.bfloat16, torch.int8, "wg"),
    ("verify", 128, 64, 32, torch.float16, torch.float16, "wg"),
    ("verify", 2048, 80, 16, torch.bfloat16, torch.bfloat16, "mma"),
    ("verify", 130, 128, 128, torch.bfloat16, torch.bfloat16, "mma"),
    ("verify", 2048, 128, 16, torch.float32, torch.float32, "scalar"),
    ("verify", 260, 72, 16, torch.bfloat16, torch.bfloat16, "scalar"),
    ("verify", 2048, 128, 8, torch.bfloat16, torch.bfloat16, "scalar"),
])
def test_paged_body_names_the_body_of_each_call(kind, rows, hs, bs, q, kv, want):
    assert cudaex.paged_body(kind, rows, hs, bs, q, kv) == want
    assert want in cudaex.PAGED_BODIES


def test_split_products_and_row_tiles():
    bf, f32 = torch.bfloat16, torch.float32
    assert cudaex._split_products(128, 16, bf, bf, bf) == "mma"
    assert cudaex._split_products(128, 16, bf, torch.int8, bf) == "mma"
    assert cudaex._split_products(128, 16, bf, torch.int8, f32) == "fma"   # mixed compute dtype
    assert cudaex._split_products(256, 16, bf, bf, bf) == "fma"
    assert cudaex._split_products(72, 16, bf, bf, bf) == "fma"
    assert cudaex._split_products(128, 32, bf, bf, bf) == "fma"
    assert cudaex._split_products(128, 16, f32, f32, f32) == "fma"
    assert cudaex._split_row_tile(4, 128, 16, "mma") == 64
    assert cudaex._split_row_tile(20, 128, 16, "fma") == 20
    assert cudaex._split_row_tile(71, 256, 16, "fma") == 64
    assert cudaex._split_row_tile(4, 8192, 16, "fma") is None


def test_split_count_comes_from_shapes_alone():
    """The wrapper's launch plan takes shapes and dtypes only: tensors on
    the meta device (whose values cannot be read) give it everything it
    needs, and the count follows B, ng, the row tiles and the table's
    width."""
    B, nh, ng, hs, bs, nbb, L = 8, 32, 8, 128, 16, 64, 2
    shapes = dict(q=(B, nh, hs), k_arena=(8, L, ng, bs, hs), fresh_k=(B, ng, hs))
    meta = {k: torch.empty(v, dtype=torch.bfloat16, device="meta") for k, v in shapes.items()}
    tables = torch.empty((B, nbb), dtype=torch.int32, device="meta")
    plan = cudaex._split_plan("decode", meta["q"].shape, meta["k_arena"].shape, tables.shape[1],
                              1, meta["q"].dtype, meta["k_arena"].dtype, meta["fresh_k"].dtype)
    splits = cudaex.paged_splits(B, ng, 1, nbb)
    assert splits == 9                                      # ceil(4 * 132 / 64)
    assert (plan["products"], plan["row_tile"], plan["splits"]) == ("mma", 64, splits)
    assert plan["head"] == (B, ng, 4, 1, hs, bs, nbb, L)
    assert plan["tail"][:2] == (splits, 64) and plan["tail"][-1] == 0
    assert plan["n_partial"] == B * ng * splits * 4 * (hs + 2)
    assert cudaex.paged_splits(1, 8, 1, 192) == 64          # capped at kMaxSplits
    assert cudaex.paged_splits(1, 8, 1, 6) == 3              # two blocks a split at least
    assert cudaex.paged_splits(64, 8, 2, 256) == 1


def test_split_plan_of_a_verify_call():
    """A verify call's plan: rep·T rows per (request, group), row tiles of
    the FMA products (float32: 71 MQA rows in two tiles at most 64 rows),
    the verify code last, and one cached plan per shapes and dtypes."""
    f32, bf = torch.float32, torch.bfloat16
    plan = cudaex._split_plan("verify", (2, 71, 1, 64), (8, 2, 1, 16, 64), 24, 1, f32, f32, f32)
    assert plan["products"] == "fma" and plan["row_tile"] == 64
    assert plan["splits"] == cudaex.paged_splits(2, 1, 2, 24)
    assert plan["head"] == (2, 1, 71, 1, 64, 16, 24, 2) and plan["tail"][-1] == 1
    spec = cudaex._split_plan("verify", (8, 32, 5, 128), (8, 2, 8, 16, 128), 64, 5, bf, bf, bf)
    assert (spec["products"], spec["row_tile"], spec["head"][2]) == ("mma", 64, 20)
    assert spec is cudaex._split_plan("verify", (8, 32, 5, 128), (8, 2, 8, 16, 128), 64, 5,
                                      bf, bf, bf)


def test_decline_follows_the_split_body():
    assert cudaex.paged_kernels_decline(4, 16, 128) == ""
    assert cudaex.paged_kernels_decline(71, 16, 64) == ""
    assert cudaex.paged_kernels_decline(4, 16, 16) == ""
    why = cudaex.paged_kernels_decline(4, 16, 8192)
    assert why.startswith("paged_attn_decode needs") and "hs=8192" in why


#
# on the card (skipped here)
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_case(dtype, quant, T, hs=128, nh=32, ng=8, bs=16, nbb=24, seed=0):
    """Ragged positions on the card: a padding row, a block edge, one
    block, a long row."""
    case = _case(4, nh, ng, hs, bs, nbb, 3, [0, 16, 3, 290 - (T or 0)], T=T, seed=seed,
                 num_blocks=160)
    if quant is not None:
        case = _quantized(case, quant)
    return _torch(case, dtype, device="cuda")


def _splits(kind, x, T):
    """The split count of the split body's launch on ``x``."""
    return cudaex._split_plan(kind, x["q"].shape, x["k_arena"].shape, x["tables"].shape[1], T,
                              x["q"].dtype, x["k_arena"].dtype, x["fresh_k"].dtype)["splits"]


def _hold(kind, got, x, dtype, splits, **kw):
    """The kernel's output against the plain version with the same cut:
    float32 within 1e-5, else by the ratio bar against the float32 result."""
    plain = cudaex.paged_attn_decode_plain if kind == "decode" else cudaex.paged_attn_verify_plain
    want = plain(**x, splits=splits, **kw)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= ATOL_F32
        return
    x32 = {k: (v.float() if v.is_floating_point() and v.element_size() > 1 else v)
           for k, v in x.items()}
    ref = plain(**x32, splits=splits, **kw)
    err_kernel = (got.float() - ref).abs().max().item()
    err_plain = (want.float() - ref).abs().max().item()
    assert torch.isfinite(got).all() and err_kernel <= LOWP_ERR_RATIO * err_plain, \
        (err_kernel, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("kind,T,window", [("decode", None, None), ("decode", None, 40),
                                           ("verify", 5, None), ("verify", 16, None)])
def test_cuda_split_body_matches_plain_and_repeats(card, kind, T, window, dtype, quant):
    x = _card_case(dtype, quant, T)
    kw = dict(layer=2, **({"window": window} if kind == "decode" else {}))
    wrapper = cudaex.paged_attn_decode if kind == "decode" else cudaex.paged_attn_verify
    splits = _splits(kind, x, T or 1)
    got = wrapper(**x, **kw)
    again = wrapper(**x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)                           # a fixed-order fold
    _hold(kind, got, x, dtype, splits, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("dtype,hs,T", [(torch.bfloat16, 128, 80), (torch.float16, 64, 64),
                                        (torch.bfloat16, 128, 130), (torch.bfloat16, 80, 40),
                                        (torch.float32, 128, 40)])
def test_cuda_verify_bodies_match_plain_and_repeat(card, dtype, hs, T, quant):
    """The warpgroup body (bf16/f16 at hs 64/128; T 80 and 130 straddle
    heads), the WMMA body (hs 80) and the scalar one (float32)."""
    x = _card_case(dtype, quant, T, hs=hs)
    body = cudaex.paged_body("verify", 4 * T, hs, 16, dtype, x["k_arena"].dtype)
    assert body == {128: "wg", 64: "wg", 80: "mma"}[hs] if dtype != torch.float32 \
        else body == "scalar"
    got = cudaex.paged_attn_verify(**x, layer=2)
    again = cudaex.paged_attn_verify(**x, layer=2)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _hold("verify", got, x, dtype, 1, layer=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hs,nh,ng", [(16, 4, 2), (80, 32, 8), (256, 4, 2), (64, 71, 1)])
def test_cuda_split_body_takes_other_heads(card, dtype, hs, nh, ng):
    """hs 16 (tiny-llama-debug) and 80, hs 256 and MQA's 71 query rows per
    group (two row tiles) through the split body, decode and verify."""
    for kind, T in (("decode", None), ("verify", 3)):
        x = _card_case(dtype, None, T, hs=hs, nh=nh, ng=ng)
        wrapper = cudaex.paged_attn_decode if kind == "decode" else cudaex.paged_attn_verify
        if kind == "verify" and nh // ng * 3 > 64:
            continue
        splits = _splits(kind, x, T or 1)
        got = wrapper(**x, layer=1)
        torch.cuda.synchronize()
        _hold(kind, got, x, dtype, splits, layer=1)
