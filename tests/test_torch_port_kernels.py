"""thunder_tpu_torch kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version, which the tests hold
against ``thunder_tpu.executors.pallasex`` (interpreted off-TPU, as
``tests/test_paged_attention.py`` runs it) on the same numpy-made inputs:
``paged_attn_decode`` at atol 1e-5 in float32 (the same online softmax,
other summation orders, outputs of magnitude ~1), ``paged_token_write``
bitwise outside sink block 0 (padding rows race there; it is never read).
``paged_attn_verify`` (speculative verify and chunked prefill) is held at
atol 1e-5 in float32 like decode; ``paged_chunk_write`` and
``paged_token_write_masked`` bitwise outside sink block 0.  Tests marked
``cuda`` build the CUDA kernels and hold them against the plain versions on
the card; they skip without one.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.executors import pallasex
from thunder_tpu_torch.executors import cudaex
from torch_port_threads import one_torch_thread  # noqa: F401

NUM_BLOCKS = 16


def _case(B, nh, ng, hs, bs, nbb, L, pos, seed=0, dtype=np.float32, num_blocks=NUM_BLOCKS):
    rng = np.random.default_rng(seed)
    pos = np.asarray(pos, np.int32)
    tables = np.zeros((B, nbb), np.int32)                 # sink-padded
    free = rng.permutation(np.arange(1, num_blocks))
    k = 0
    for i, p in enumerate(pos):
        n = -(-int(p) // bs)
        tables[i, :n] = free[k:k + n]
        k += n
    arena = (num_blocks, L, ng, bs, hs)
    return dict(
        q=rng.standard_normal((B, nh, hs)).astype(dtype),
        k_arena=rng.standard_normal(arena).astype(dtype),
        v_arena=rng.standard_normal(arena).astype(dtype),
        fresh_k=rng.standard_normal((B, ng, hs)).astype(dtype),
        fresh_v=rng.standard_normal((B, ng, hs)).astype(dtype),
        tables=tables,
        pos=pos,
    )


def _torch(case, device="cpu"):
    return {k: torch.as_tensor(v, device=device) for k, v in case.items()}


# (B, nh, ng, hs, bs, nbb, L, pos, window, layer): GQA, MHA, MQA; ragged
# positions with pos=0 padding rows; block-boundary positions; windows
DECODE_CASES = [
    pytest.param(4, 4, 2, 16, 4, 5, 3, [0, 5, 13, 19], None, 1, id="gqa"),
    pytest.param(4, 4, 2, 16, 4, 5, 3, [0, 5, 13, 19], 6, 2, id="gqa-window"),
    pytest.param(3, 4, 4, 8, 4, 4, 2, [4, 0, 16], None, 0, id="mha-block-edges"),
    pytest.param(3, 6, 1, 8, 3, 4, 2, [1, 7, 11], 4, 1, id="mqa-window"),
    pytest.param(2, 4, 2, 16, 8, 2, 1, [9, 1], 1, 0, id="window-1"),
]


@pytest.mark.parametrize("B,nh,ng,hs,bs,nbb,L,pos,window,layer", DECODE_CASES)
def test_paged_attn_decode_plain_matches_pallas(B, nh, ng, hs, bs, nbb, L, pos, window, layer):
    case = _case(B, nh, ng, hs, bs, nbb, L, pos)
    want = pallasex.paged_attn_decode(
        *(jnp.asarray(case[k]) for k in ("q", "k_arena", "v_arena", "fresh_k", "fresh_v",
                                          "tables", "pos")),
        layer=layer, window=window)
    got = cudaex.paged_attn_decode(**_torch(case), layer=layer, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_padding_row_returns_fresh_v():
    case = _case(2, 4, 2, 16, 4, 3, 1, [0, 6])
    got = cudaex.paged_attn_decode(**_torch(case), layer=0)
    fv = np.repeat(case["fresh_v"][0], 2, axis=0)            # group g feeds heads 2g, 2g+1
    np.testing.assert_array_equal(got[0].numpy(), fv)


def test_plain_decode_ignores_sink_and_unlisted_blocks():
    """Only the listed live blocks feed the output: poisoning the sink block
    and every block no table lists changes nothing."""
    case = _case(3, 4, 2, 16, 4, 4, 2, [3, 9, 0])
    t = _torch(case)
    before = cudaex.paged_attn_decode(**t, layer=1)
    live = {int(b) for b in case["tables"].ravel()} - {0}
    for blk in set(range(NUM_BLOCKS)) - live:
        t["k_arena"][blk] = 1e4
        t["v_arena"][blk] = -1e4
    assert torch.equal(cudaex.paged_attn_decode(**t, layer=1), before)


@pytest.mark.parametrize("rank", [5, 4])
def test_paged_token_write_plain_matches_pallas_bitwise(rank):
    case = _case(4, 4, 2, 16, 4, 5, 3, [0, 5, 13, 19], seed=3)
    rng = np.random.default_rng(4)
    arena = case["k_arena"] if rank == 5 else case["k_arena"][..., 0].copy()
    vals = rng.standard_normal((4, 3, 2, 16) if rank == 5 else (4, 3, 2)).astype(np.float32)
    want = np.asarray(pallasex.paged_token_write(
        jnp.asarray(arena), jnp.asarray(vals), jnp.asarray(case["tables"]),
        jnp.asarray(case["pos"]), block_size=4))
    ta = torch.as_tensor(arena.copy())
    got = cudaex.paged_token_write(ta, torch.as_tensor(vals), torch.as_tensor(case["tables"]),
                                   torch.as_tensor(case["pos"]), block_size=4)
    assert got is ta                                           # in place
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    assert (got.numpy()[1:] != arena[1:]).any()


def test_cpu_calls_count_no_launches():
    cudaex.reset_launches()
    case = _torch(_case(2, 4, 2, 16, 4, 3, 2, [2, 7]))
    cudaex.paged_attn_decode(**case, layer=0)
    cudaex.paged_token_write(case["k_arena"], torch.zeros(2, 2, 2, 16), case["tables"],
                             case["pos"], block_size=4)
    assert set(cudaex.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda c: c.update(k_scale=c["k_arena"][..., 0]), ValueError, "both or neither"),
    (lambda c: c.update(tables=c["tables"].long()), ValueError, "int32"),
    (lambda c: c.update(pos=c["pos"][:1]), ValueError, "pos"),
    (lambda c: c.update(q=c["q"].transpose(1, 2).contiguous().transpose(1, 2)), ValueError,
     "contiguous"),
    (lambda c: c.update(fresh_k=c["fresh_k"].double()), ValueError, "dtype"),
    (lambda c: c.update(layer=5), ValueError, "layer"),
    (lambda c: c.update(window=0), ValueError, "window"),
    (lambda c: c.update(q=c["q"][:, :3].contiguous()), ValueError, "does not fit"),
])
def test_paged_attn_decode_rejects_bad_arguments(mutate, exc, match):
    c = dict(_torch(_case(2, 4, 2, 16, 4, 3, 2, [2, 7])), layer=0)
    mutate(c)
    with pytest.raises(exc, match=match):
        cudaex.paged_attn_decode(**c)


def test_paged_token_write_rejects_bad_arguments():
    c = _torch(_case(2, 4, 2, 16, 4, 3, 2, [2, 7]))
    with pytest.raises(ValueError, match="dtype"):
        cudaex.paged_token_write(c["k_arena"], torch.zeros(2, 2, 2, 16, dtype=torch.float64),
                                 c["tables"], c["pos"], block_size=4)
    with pytest.raises(ValueError, match="block_size"):
        cudaex.paged_token_write(c["k_arena"], torch.zeros(2, 2, 2, 16), c["tables"],
                                 c["pos"], block_size=8)
    with pytest.raises(ValueError, match="one rank lower"):
        cudaex.paged_token_write(c["k_arena"], torch.zeros(2, 2, 16), c["tables"], c["pos"],
                                 block_size=4)
    with pytest.raises(ValueError, match="vals must be"):
        cudaex.paged_token_write(c["k_arena"], torch.zeros(2, 2, 2, 8), c["tables"], c["pos"],
                                 block_size=4)


def _verify_case(B, nh, ng, hs, bs, nbb, L, T, pos, seed=0, dtype=np.float32,
                 num_blocks=NUM_BLOCKS):
    """A decode case with T-token queries and fresh K/V; tables cover the
    chunk's own blocks too (they are never attended)."""
    c = _case(B, nh, ng, hs, bs, nbb, L, np.asarray(pos) + T, seed=seed, dtype=dtype,
              num_blocks=num_blocks)
    rng = np.random.default_rng(seed + 100)
    c.update(q=rng.standard_normal((B, nh, T, hs)).astype(dtype),
             fresh_k=rng.standard_normal((B, ng, T, hs)).astype(dtype),
             fresh_v=rng.standard_normal((B, ng, T, hs)).astype(dtype),
             pos=np.asarray(pos, np.int32))
    return c


# (B, nh, ng, hs, bs, nbb, L, T, pos, layer): GQA, MHA, MQA; T = 2, 5 and
# 2*bs; ragged positions with pos=0 padding rows and block-edge positions
VERIFY_CASES = [
    pytest.param(4, 4, 2, 16, 4, 6, 3, 2, [0, 5, 12, 19], 1, id="gqa-T2"),
    pytest.param(4, 4, 2, 16, 4, 7, 3, 5, [0, 5, 12, 14], 2, id="gqa-T5"),
    pytest.param(3, 4, 4, 8, 4, 5, 2, 5, [4, 0, 8], 0, id="mha-block-edges"),
    pytest.param(3, 6, 1, 8, 3, 7, 2, 6, [1, 9, 12], 1, id="mqa-T2bs"),
    pytest.param(2, 4, 2, 16, 4, 5, 1, 8, [8, 0], 0, id="gqa-T2bs-chunk"),
]


@pytest.mark.parametrize("B,nh,ng,hs,bs,nbb,L,T,pos,layer", VERIFY_CASES)
def test_paged_attn_verify_plain_matches_pallas(B, nh, ng, hs, bs, nbb, L, T, pos, layer):
    case = _verify_case(B, nh, ng, hs, bs, nbb, L, T, pos)
    want = pallasex.paged_attn_verify(
        *(jnp.asarray(case[k]) for k in ("q", "k_arena", "v_arena", "fresh_k", "fresh_v",
                                          "tables", "pos")), layer=layer)
    got = cudaex.paged_attn_verify(**_torch(case), layer=layer)
    assert got.shape == (B, nh, T, hs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_verify_padding_row_is_causal_attention_over_the_chunk():
    """A pos=0 row reads no arena block: its output is plain causal
    attention over the chunk's own K/V."""
    case = _verify_case(2, 4, 2, 16, 4, 4, 1, 5, [0, 6])
    got = cudaex.paged_attn_verify(**_torch(case), layer=0)[0]
    q = torch.as_tensor(case["q"][0])
    k = torch.as_tensor(case["fresh_k"][0]).repeat_interleave(2, dim=0)
    v = torch.as_tensor(case["fresh_v"][0]).repeat_interleave(2, dim=0)
    s = q @ k.transpose(-1, -2) / 4.0
    s = s.masked_fill(torch.ones(5, 5, dtype=torch.bool).triu(1), float("-inf"))
    torch.testing.assert_close(got, torch.softmax(s, -1) @ v, atol=1e-5, rtol=0)


# (pos, nc, leased): the chunk at block-aligned pos covers nc blocks;
# table entries past the leased ones are sink, past nbb route to block 0
CHUNK_CASES = [
    pytest.param(0, 2, 4, id="first-chunk"),
    pytest.param(8, 2, 5, id="mid-chunk"),
    pytest.param(12, 3, 4, id="past-leased"),
    pytest.param(16, 3, 6, id="past-table"),
]


@pytest.mark.parametrize("pos,nc,leased", CHUNK_CASES)
def test_paged_chunk_write_plain_matches_pallas_bitwise(pos, nc, leased):
    from thunder_tpu.serving.kv_pool import chunk_tables

    bs, nbb = 4, 6
    case = _case(1, 4, 2, 16, bs, nbb, 3, [0], seed=5)
    rng = np.random.default_rng(6)
    blocks = [int(b) for b in rng.permutation(np.arange(1, NUM_BLOCKS))[:leased]]
    _, dest = chunk_tables(blocks, pos, nc * bs, nbb, bs)
    vals = rng.standard_normal((nc, 3, 2, bs, 16)).astype(np.float32)
    p = np.asarray([pos], np.int32)
    want = np.asarray(pallasex.paged_chunk_write(
        jnp.asarray(case["k_arena"]), jnp.asarray(vals), jnp.asarray(dest), jnp.asarray(p),
        block_size=bs))
    ta = torch.as_tensor(case["k_arena"].copy())
    got = cudaex.paged_chunk_write(ta, torch.as_tensor(vals), torch.as_tensor(dest),
                                   torch.as_tensor(p), block_size=bs)
    assert got is ta                                           # in place
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    written = {int(b) for b in dest[pos // bs:pos // bs + nc] if b}
    assert written and all((got.numpy()[b] != case["k_arena"][b]).any() for b in written)


@pytest.mark.parametrize("offset", range(5))
@pytest.mark.parametrize("rank", [5, 4])
def test_paged_token_write_masked_plain_matches_pallas_bitwise(rank, offset):
    """A K=4 commit: n_emit from 0 (padding row) to K+1 across the rows,
    every chunk offset."""
    pos = np.asarray([0, 5, 13, 9, 2, 11], np.int32)
    case = _case(6, 4, 2, 16, 4, 5, 3, pos + 5, seed=7, num_blocks=32)   # tables cover pos+K
    case["pos"] = pos
    rng = np.random.default_rng(8)
    arena = case["k_arena"] if rank == 5 else case["k_arena"][..., 0].copy()
    vals = rng.standard_normal((6, 3, 2, 16) if rank == 5 else (6, 3, 2)).astype(np.float32)
    n_emit = np.asarray([0, 5, 1, 3, 2, 4], np.int32)
    want = np.asarray(pallasex.paged_token_write_masked(
        jnp.asarray(arena), jnp.asarray(vals), jnp.asarray(case["tables"]),
        jnp.asarray(case["pos"]), jnp.asarray(n_emit), offset, block_size=4))
    ta = torch.as_tensor(arena.copy())
    got = cudaex.paged_token_write_masked(
        ta, torch.as_tensor(vals), torch.as_tensor(case["tables"]), torch.as_tensor(case["pos"]),
        torch.as_tensor(n_emit), offset, block_size=4)
    assert got is ta
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    assert (got.numpy()[1:] != arena[1:]).any() == bool((n_emit > offset).any())


def test_new_kernels_count_no_launches_on_cpu():
    cudaex.reset_launches()
    c = _torch(_verify_case(2, 4, 2, 16, 4, 4, 2, 3, [2, 7]))
    cudaex.paged_attn_verify(**c, layer=0)
    n_emit = torch.tensor([1, 2], dtype=torch.int32)
    cudaex.paged_token_write_masked(c["k_arena"], torch.zeros(2, 2, 2, 16), c["tables"], c["pos"],
                                    n_emit, 1, block_size=4)
    cudaex.paged_chunk_write(c["k_arena"], torch.zeros(1, 2, 2, 4, 16), c["tables"][0],
                             torch.tensor([4], dtype=torch.int32), block_size=4)
    assert set(cudaex.LAUNCHES.values()) == {0}


def test_new_kernels_reject_bad_arguments():
    c = dict(_torch(_verify_case(2, 4, 2, 16, 4, 4, 2, 3, [2, 7])), layer=0)
    with pytest.raises(ValueError, match="both or neither"):
        cudaex.paged_attn_verify(**c, k_scale=c["k_arena"][..., 0])
    with pytest.raises(ValueError, match="fresh K/V"):
        cudaex.paged_attn_verify(**{**c, "fresh_k": c["fresh_k"][:, :, :2].contiguous()})
    with pytest.raises(ValueError, match="layer"):
        cudaex.paged_attn_verify(**{**c, "layer": 2})
    arena, tables, pos = c["k_arena"], c["tables"], c["pos"]
    with pytest.raises(ValueError, match="n_emit"):
        cudaex.paged_token_write_masked(arena, torch.zeros(2, 2, 2, 16), tables, pos,
                                        torch.ones(2, dtype=torch.int64), 0, block_size=4)
    with pytest.raises(ValueError, match="offset"):
        cudaex.paged_token_write_masked(arena, torch.zeros(2, 2, 2, 16), tables, pos,
                                        torch.ones(2, dtype=torch.int32), -1, block_size=4)
    p1 = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError, match="pos must be int32"):
        cudaex.paged_chunk_write(arena, torch.zeros(1, 2, 2, 4, 16), tables[0], pos,
                                 block_size=4)
    with pytest.raises(ValueError, match="dest"):
        cudaex.paged_chunk_write(arena, torch.zeros(1, 2, 2, 4, 16), tables, p1, block_size=4)
    with pytest.raises(ValueError, match="vals"):
        cudaex.paged_chunk_write(arena, torch.zeros(1, 2, 2, 2, 16), tables[0], p1,
                                 block_size=4)


#
# on the card (skipped here)
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2),
                                        (torch.float16, 4e-3)])
@pytest.mark.parametrize("nh,ng,hs,window", [(32, 8, 128, None), (8, 8, 64, 40),
                                             (71, 1, 64, None), (4, 2, 256, 17)])
def test_cuda_paged_attn_decode_matches_plain(card, dtype, atol, nh, ng, hs, window):
    case = _torch(_case(4, nh, ng, hs, 16, 4, 3, [0, 1, 33, 64]), device=card)
    case = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in case.items()}
    got = cudaex.paged_attn_decode(**case, layer=2, window=window)
    torch.cuda.synchronize()
    want = cudaex.paged_attn_decode_plain(**case, layer=2, window=window)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_paged_token_write_matches_plain(card, dtype):
    c = _torch(_case(4, 4, 2, 64, 16, 4, 3, [0, 1, 33, 64]), device=card)
    arena = c["k_arena"].to(dtype)
    vals = torch.randn(4, 3, 2, 64, device=card).to(dtype)
    want = cudaex.paged_token_write_plain(arena.clone(), vals, c["tables"], c["pos"],
                                          block_size=16)
    got = cudaex.paged_token_write(arena, vals, c["tables"], c["pos"], block_size=16)
    torch.cuda.synchronize()
    assert torch.equal(got[1:], want[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("nh,ng,hs,T", [(32, 8, 128, 5), (8, 8, 64, 40), (8, 1, 64, 2),
                                        (4, 2, 256, 33), (32, 8, 128, 130)])
def test_cuda_paged_attn_verify_matches_plain(card, dtype, nh, ng, hs, T):
    """float32 within 1e-5 of the plain version; bf16 and f16 round where the
    plain version rounds, over other key tiles, so each is held against the
    float32 result of the same inputs: the kernel's error at most twice the
    plain version's own.  The cases take every body ``cudaex.paged_body``
    names: split-K at rep·T <= 64, the warpgroup body at T=130, WMMA (bf16,
    hs 256) and scalar (float32) at 66 rows."""
    case32 = _torch(_verify_case(4, nh, ng, hs, 16, 24, 3, T, [0, 1, 33, 64], num_blocks=64),
                    device=card)
    case = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in case32.items()}
    got = cudaex.paged_attn_verify(**case, layer=2)
    torch.cuda.synchronize()
    want = cudaex.paged_attn_verify_plain(**case, layer=2)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
        return
    ref = cudaex.paged_attn_verify_plain(
        **{k: (v.float() if v.is_floating_point() else v) for k, v in case.items()}, layer=2)
    err_kernel = (got.float() - ref).abs().max().item()
    err_plain = (want.float() - ref).abs().max().item()
    assert torch.isfinite(got).all() and err_kernel <= 2 * err_plain, (err_kernel, err_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_paged_chunk_and_masked_writes_match_plain(card, dtype):
    c = _torch(_case(4, 4, 2, 64, 16, 4, 3, [0, 1, 33, 64]), device=card)
    arena = c["k_arena"].to(dtype)
    dest = c["tables"][3]
    for pos, nc in ((0, 2), (16, 3), (32, 4)):
        vals = torch.randn(nc, 3, 2, 16, 64, device=card).to(dtype)
        p = torch.tensor([pos], dtype=torch.int32, device=card)
        want = cudaex.paged_chunk_write_plain(arena.clone(), vals, dest, p, block_size=16)
        got = cudaex.paged_chunk_write(arena, vals, dest, p, block_size=16)
        torch.cuda.synchronize()
        assert torch.equal(got[1:], want[1:])
    n_emit = torch.tensor([0, 3, 1, 2], dtype=torch.int32, device=card)
    for offset in range(3):
        vals = torch.randn(4, 3, 2, 64, device=card).to(dtype)
        want = cudaex.paged_token_write_masked_plain(arena.clone(), vals, c["tables"], c["pos"],
                                                     n_emit, offset, block_size=16)
        got = cudaex.paged_token_write_masked(arena, vals, c["tables"], c["pos"], n_emit,
                                              offset, block_size=16)
        torch.cuda.synchronize()
        assert torch.equal(got[1:], want[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hs", [16, 48, 72, 80])
def test_cuda_paged_kernels_take_any_head_size(card, dtype, hs):
    """Decode and verify at head sizes off the 64/128/256 grid (both take
    the split-K body at these rows: hs 72 on FMA products in bf16 too): the
    decode bars above, and the verify kernel within 1e-5 in float32, else at
    most twice the plain version's own error against the float32 result."""
    case = _torch(_case(4, 8, 2, hs, 16, 4, 3, [0, 1, 33, 64]), device=card)
    case = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in case.items()}
    got = cudaex.paged_attn_decode(**case, layer=2)
    torch.cuda.synchronize()
    want = cudaex.paged_attn_decode_plain(**case, layer=2)
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= atol
    case32 = _torch(_verify_case(4, 8, 2, hs, 16, 24, 3, 5, [0, 1, 33, 64], num_blocks=64),
                    device=card)
    vcase = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in case32.items()}
    got = cudaex.paged_attn_verify(**vcase, layer=2)
    torch.cuda.synchronize()
    want = cudaex.paged_attn_verify_plain(**vcase, layer=2)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
        return
    ref = cudaex.paged_attn_verify_plain(**case32, layer=2)
    err_kernel = (got.float() - ref).abs().max().item()
    err_plain = (want.float() - ref).abs().max().item()
    assert torch.isfinite(got).all() and err_kernel <= 2 * err_plain, (err_kernel, err_plain)
