"""thunder_tpu_torch KV-cache writes of both arenas in one launch, against the JAX package.

On the CPU, with numpy-made inputs fed to both packages (Pallas run
interpreted off-TPU, as ``tests/test_torch_port_kernels.py`` runs it):

- ``cudaex.paged_token_write_pair`` (its plain version, which CPU tensors
  take): K and V of T = 1 or T = 5 offsets, plain or keep-masked by
  ``n_emit`` (0 to K+1, a batch-padding row with an all-sink table), rank 5
  in float32 and bf16 and the rank-4 scale form, equal bit for bit on both
  arenas outside sink block 0 to the sequential single-offset calls of
  ``pallasex.paged_token_write`` / ``paged_token_write_masked``;
- ``cudaex.paged_chunk_write_fused_pair`` on int8 and fp8 arenas, reading
  the forward's (1, L, ng, T, hs) values: bytes and scales bitwise equal to
  ``pallasex.paged_chunk_write_fused`` over the values folded into block
  granules, the error sums within 1e-5 relative (f32 sums in another
  order) and the ``rel_err`` they give within 1e-6;
- ``cudaex.paged_token_write_fused_pair`` on int8 and fp8 arenas, from
  float32 and bf16 values read as strided views: T = 1 plain, a multi-step
  iteration's liveness mask and T = 5 masked (n_emit 0 to K+1, a padding
  row), stored bytes and scales of both arenas bitwise equal outside sink
  block 0 to the sequential single-offset calls of
  ``pallasex.paged_token_write_fused``;
- ``cudaex.paged_chunk_write_pair``, reading the forward's (1, L, ng, T,
  hs) values as a strided view, bitwise equal outside sink block 0 to
  ``pallasex.paged_chunk_write`` over the values folded into block
  granules (a first chunk, one past the leased blocks, one spilling past
  the table);
- the pair wrappers refuse mismatched K/V arenas, scale arenas or values,
  and the chunk pairs a T that is not a multiple of the block size, naming
  the argument.

Tests marked ``cuda`` hold the kernels against their plain versions on the
card, bitwise, two calls bitwise equal, one counted launch per call (the
single-arena entries launch the pairs' kernels with one arena); they skip
without one.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.executors import pallasex
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.serving import quant as tq
from thunder_tpu_torch.serving.kv_pool import chunk_tables
from torch_port_threads import one_torch_thread  # noqa: F401

L, NG, HS, BS, NBB, NUM_BLOCKS = 2, 2, 16, 4, 5, 32
POS = np.array([0, 5, 13, 9, 2, 11], np.int32)        # row 0: batch padding
N_EMIT = np.array([0, 5, 1, 3, 2, 4], np.int32)       # 0 to K+1 = 5
STORAGE = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
# the chunk write's error sums: f32 sums of 256 terms in another order, which
# differ by up to ~256 ulps (1.1e-6 relative read on these inputs), and the
# rel_err figure they give, the gauge's tolerance in test_torch_port_quant.py
ERR_SUMS_REL = 1e-5
REL_ERR_ATOL = 1e-6


def _bytes(x) -> np.ndarray:
    """The raw bytes of a numpy/JAX/torch array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _tables(B, pos, T, seed=7):
    """Sink-padded tables covering pos + T; row 0 all sink (batch padding)."""
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, NBB), np.int32)
    free = rng.permutation(np.arange(1, NUM_BLOCKS))
    k = 0
    for i, p in enumerate(pos):
        if i == 0:
            continue
        n = -(-(int(p) + T) // BS)
        tables[i, :n] = free[k:k + n]
        k += n
    return tables


def _as(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.as_tensor(x.copy())


# (rank, dtype, T, masked): rank 5 in f32 and bf16 and the rank-4 scale
# form; T = 1 (a decode step, or a multi-step iteration's offset-0 masked
# write) and T = 5 (a K=4 verify round)
TOKEN_CASES = {
    "r5-f32-T5-masked": (5, "float32", 5, True),
    "r5-bf16-T5-masked": (5, "bfloat16", 5, True),
    "r4-f32-T1-masked": (4, "float32", 1, True),
    "r5-bf16-T1": (5, "bfloat16", 1, False),
    "r4-f32-T1": (4, "float32", 1, False),
}


def _token_inputs(case: str, seed=3):
    rank, dtype, T, masked = TOKEN_CASES[case]
    rng = np.random.default_rng(seed)
    B = len(POS)
    tail = (HS,) if rank == 5 else ()
    arenas = [rng.standard_normal((NUM_BLOCKS, L, NG, BS, *tail)).astype(np.float32)
              for _ in range(2)]
    vals = [rng.standard_normal((B, L, NG, T, *tail)).astype(np.float32) for _ in range(2)]
    return arenas, vals, _tables(B, POS, T), N_EMIT if masked else None


@pytest.fixture(scope="module")
def pallas_token_writes():
    """Each case's arenas after the sequential single-offset Pallas calls,
    computed once per module (each interpreted call costs ~0.2 s)."""
    done = {}

    def get(case):
        if case not in done:
            rank, dtype, T, masked = TOKEN_CASES[case]
            arenas, vals, tables, n_emit = _token_inputs(case)
            out = []
            for arena, v in zip(arenas, vals):
                ja = _as(arena, dtype)[0]
                jv = _as(v, dtype)[0]
                for t in range(T):
                    if masked:
                        ja = pallasex.paged_token_write_masked(
                            ja, jv[:, :, :, t], jnp.asarray(tables), jnp.asarray(POS),
                            jnp.asarray(n_emit), t, block_size=BS)
                    else:
                        ja = pallasex.paged_token_write(
                            ja, jv[:, :, :, t], jnp.asarray(tables), jnp.asarray(POS + t),
                            block_size=BS)
                out.append(_bytes(ja))
            done[case] = out
        return done[case]

    return get


@pytest.mark.parametrize("case", list(TOKEN_CASES))
def test_token_pair_plain_matches_sequential_pallas_writes(pallas_token_writes, case):
    rank, dtype, T, masked = TOKEN_CASES[case]
    arenas, vals, tables, n_emit = _token_inputs(case)
    ta = [_as(a, dtype)[1] for a in arenas]
    tv = [_as(v, dtype)[1] for v in vals]
    if T == 1:
        tv = [v[:, :, :, 0] for v in tv]                 # the (B, L, ng, hs) decode form
    got = cudaex.paged_token_write_pair(
        *ta, *tv, torch.as_tensor(tables), torch.as_tensor(POS), block_size=BS,
        n_emit=None if n_emit is None else torch.as_tensor(n_emit))
    assert got[0] is ta[0] and got[1] is ta[1]           # in place
    for name, g, want, before in zip("kv", got, pallas_token_writes(case), arenas):
        np.testing.assert_array_equal(_bytes(g)[1:], want[1:], err_msg=f"{case} arena {name}")
        assert (_bytes(g)[1:] != _bytes(_as(before, dtype)[1])[1:]).any()


def test_token_pair_reads_strided_values_in_place():
    """A slice of a wider forward output (a view with T strides) lands as
    its contiguous copy does, and a live row's offsets land at distinct
    slots: the pair equals the single-offset wrappers called in order."""
    arenas, vals, tables, _ = _token_inputs("r5-f32-T5-masked")
    wide = torch.as_tensor(np.concatenate(vals, axis=3).copy())          # (B, L, ng, 10, hs)
    views = (wide[:, :, :, :5], wide[:, :, :, 5:])
    assert not views[0].is_contiguous()
    args = (torch.as_tensor(tables), torch.as_tensor(POS))
    ne = torch.as_tensor(N_EMIT)
    got = cudaex.paged_token_write_pair(*(torch.as_tensor(a.copy()) for a in arenas), *views,
                                        *args, block_size=BS, n_emit=ne, offset=1)
    for g, a, v in zip(got, arenas, views):
        want = torch.as_tensor(a.copy())
        for t in range(5):
            cudaex.paged_token_write_masked(want, v[:, :, :, t].contiguous(), *args, ne, 1 + t,
                                            block_size=BS)
        assert torch.equal(g[1:], want[1:])


# (kind, vals dtype, pos, chunk blocks, leased blocks): a first chunk, one
# past the leased blocks, one running past the table (its last blocks go to
# the sink)
CHUNK_CASES = {
    "int8-f32-first": ("int8", "float32", 0, 2, 4),
    "int8-bf16-past-table": ("int8", "bfloat16", 16, 3, 6),
    "fp8-f32-past-leased": ("fp8", "float32", 12, 3, 4),
    "fp8-bf16-first": ("fp8", "bfloat16", 0, 2, 4),
}
CHUNK_NUM_BLOCKS, CHUNK_NBB = 16, 6


def _chunk_inputs(case: str):
    kind, dtype, pos, nc, leased = CHUNK_CASES[case]
    rng = np.random.default_rng(11)
    blocks = [int(b) for b in rng.permutation(np.arange(1, CHUNK_NUM_BLOCKS))[:leased]]
    _, dest = chunk_tables(blocks, pos, nc * BS, CHUNK_NBB, BS)
    x = [(rng.standard_normal((CHUNK_NUM_BLOCKS, L, NG, BS, HS)) * 2).astype(np.float32)
         for _ in range(2)]
    vals = [(rng.standard_normal((1, L, NG, nc * BS, HS)) * 3).astype(np.float32)
            for _ in range(2)]
    vals[0][0, 0, 0, 1] = 0.0                            # an all-zero slot-head
    return kind, dtype, pos, nc, dest, x, vals


def _fold(v, nc):
    """(1, L, ng, T, hs) → (nc, L, ng, bs, hs): chunk block c, slot t is
    token c·bs + t."""
    return v[0].reshape(L, NG, nc, BS, HS).transpose(2, 0, 1, 3, 4)


@pytest.fixture(scope="module")
def pallas_chunk_writes():
    """Each case's Pallas result per arena (bytes, scales, error sums),
    computed once per module."""
    from thunder_tpu.serving import quant as jq
    import jax

    done = {}

    def get(case):
        if case not in done:
            kind, dtype, pos, nc, dest, x, vals = _chunk_inputs(case)
            out = []
            for xa, v in zip(x, vals):
                quantize = jax.jit(lambda a: jq.quantize_kv(a, storage=STORAGE[kind][0]))
                q, s = quantize(jnp.asarray(xa))
                wa, ws, werr = pallasex.paged_chunk_write_fused(
                    q, s, _as(np.ascontiguousarray(_fold(v, nc)), dtype)[0], jnp.asarray(dest),
                    jnp.asarray(np.array([pos], np.int32)), block_size=BS)
                out.append((_bytes(q), _bytes(s), _bytes(wa), _bytes(ws),
                            np.asarray(werr)[:, 0, :2]))
            done[case] = out
        return done[case]

    return get


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_pair_plain_matches_pallas(pallas_chunk_writes, case):
    kind, dtype, pos, nc, dest, _, vals = _chunk_inputs(case)
    tst = STORAGE[kind][1]
    ref = pallas_chunk_writes(case)
    arenas = [torch.as_tensor(r[0].copy()).view(tst) for r in ref]
    scales = [torch.as_tensor(r[1].copy()).view(torch.float32) for r in ref]
    tv = [_as(v, dtype)[1] for v in vals]
    got = cudaex.paged_chunk_write_fused_pair(
        *arenas, *scales, *tv, torch.as_tensor(dest), torch.as_tensor(np.array([pos], np.int32)),
        block_size=BS)
    assert all(g is t for g, t in zip(got[:4], (*arenas, *scales)))
    err = got[4]
    assert tuple(err.shape) == (2, nc, 2)
    for i, (_, _, wa, ws, werr) in enumerate(ref):
        np.testing.assert_array_equal(_bytes(arenas[i])[1:], wa[1:])
        np.testing.assert_array_equal(_bytes(scales[i])[1:], ws[1:])
        np.testing.assert_allclose(err[i].numpy(), werr, rtol=ERR_SUMS_REL, atol=0)
        rel = float(err[i, :, 0].sum() / (err[i, :, 1].sum() + 1e-30))
        assert abs(rel - float(werr[:, 0].sum() / (werr[:, 1].sum() + 1e-30))) <= REL_ERR_ATOL
    live = [c for c in range(nc) if pos // BS + c < CHUNK_NBB and dest[pos // BS + c]]
    assert all(err[:, c, 1].min() > 0 for c in live)
    assert all(err[:, c].abs().sum() == 0 for c in range(nc) if c not in live)


# (kind, vals dtype, T, masked): T = 1 plain (a decode step) and masked (a
# multi-step iteration's offset-0 write, n_emit the 0/1 liveness), T = 5
# masked (a K=4 round, n_emit 0 to K+1)
FUSED_CASES = {
    "int8-f32-T5-masked": ("int8", "float32", 5, True),
    "fp8-bf16-T5-masked": ("fp8", "bfloat16", 5, True),
    "int8-bf16-T1": ("int8", "bfloat16", 1, False),
    "fp8-f32-T1": ("fp8", "float32", 1, False),
    "int8-f32-T1-live": ("int8", "float32", 1, True),
}
LIVE = np.array([0, 1, 1, 0, 1, 1], np.int32)          # row 0 padding, row 3 finished


def _fused_inputs(case: str):
    """Arenas to quantize, values one offset wider on each side than T (the
    torch side reads offsets 1 .. T as a strided view), tables, n_emit."""
    kind, dtype, T, masked = FUSED_CASES[case]
    rng = np.random.default_rng(5)
    B = len(POS)
    base = [(rng.standard_normal((NUM_BLOCKS, L, NG, BS, HS)) * 2).astype(np.float32)
            for _ in range(2)]
    wide = [(rng.standard_normal((B, L, NG, T + 2, HS)) * 3).astype(np.float32)
            for _ in range(2)]
    wide[0][1, 0, 0] = 0.0                               # all-zero slot-heads
    n_emit = (N_EMIT if T > 1 else LIVE) if masked else None
    return kind, dtype, T, base, wide, _tables(B, POS, T), n_emit


@pytest.fixture(scope="module")
def pallas_fused_token_writes():
    """Each case's quantized arenas per arena (bytes and scales) before and
    after the sequential single-offset Pallas writes, computed once per
    module."""
    import jax
    from thunder_tpu.serving import quant as jq

    done = {}

    def get(case):
        if case not in done:
            kind, dtype, T, base, wide, tables, n_emit = _fused_inputs(case)
            quantize = jax.jit(lambda a: jq.quantize_kv(a, storage=STORAGE[kind][0]))
            out = []
            for x, w in zip(base, wide):
                q, s = quantize(jnp.asarray(x))
                before = (_bytes(q), _bytes(s))
                jv = _as(np.ascontiguousarray(w[:, :, :, 1:T + 1]), dtype)[0]
                for t in range(T):
                    if n_emit is None:
                        q, s = pallasex.paged_token_write_fused(
                            q, s, jv[:, :, :, t], jnp.asarray(tables), jnp.asarray(POS + t),
                            block_size=BS)
                    else:
                        q, s = pallasex.paged_token_write_fused(
                            q, s, jv[:, :, :, t], jnp.asarray(tables), jnp.asarray(POS),
                            block_size=BS, n_emit=jnp.asarray(n_emit), offset=t)
                out.append((*before, _bytes(q), _bytes(s)))
            done[case] = out
        return done[case]

    return get


@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_token_pair_plain_matches_sequential_pallas_writes(pallas_fused_token_writes,
                                                                  case):
    kind, dtype, T, _, wide, tables, n_emit = _fused_inputs(case)
    ref = pallas_fused_token_writes(case)
    tst = STORAGE[kind][1]
    arenas = [torch.as_tensor(r[0].copy()).view(tst) for r in ref]
    scales = [torch.as_tensor(r[1].copy()).view(torch.float32) for r in ref]
    tw = [_as(w, dtype)[1] for w in wide]
    vals = [w[:, :, :, 1:T + 1] if T > 1 else w[:, :, :, 1] for w in tw]
    assert not vals[0].is_contiguous()
    got = cudaex.paged_token_write_fused_pair(
        *arenas, *scales, *vals, torch.as_tensor(tables), torch.as_tensor(POS), block_size=BS,
        n_emit=None if n_emit is None else torch.as_tensor(n_emit))
    assert all(g is t for g, t in zip(got, (*arenas, *scales)))        # in place
    for i, (q0, s0, wa, ws) in enumerate(ref):
        np.testing.assert_array_equal(_bytes(arenas[i])[1:], wa[1:], err_msg=f"{case} arena {i}")
        np.testing.assert_array_equal(_bytes(scales[i])[1:], ws[1:], err_msg=f"{case} scale {i}")
        assert (_bytes(arenas[i])[1:] != q0[1:]).any() and (_bytes(scales[i])[1:] != s0[1:]).any()


# (vals dtype, pos, chunk blocks, leased blocks): a first chunk, one past the
# leased blocks, one running past the table (its last block goes to the sink)
CHUNK_PAIR_CASES = {
    "f32-first": ("float32", 0, 2, 4),
    "bf16-past-leased": ("bfloat16", 12, 3, 4),
    "f32-past-table": ("float32", 16, 3, 6),
}


def _chunk_pair_inputs(case: str):
    """Arenas, the values as a (1, L, ng, T + 2 bs, hs) tensor whose
    offsets bs .. bs + T the torch side reads as a strided view, dest."""
    dtype, pos, nc, leased = CHUNK_PAIR_CASES[case]
    rng = np.random.default_rng(13)
    blocks = [int(b) for b in rng.permutation(np.arange(1, CHUNK_NUM_BLOCKS))[:leased]]
    _, dest = chunk_tables(blocks, pos, nc * BS, CHUNK_NBB, BS)
    x = [rng.standard_normal((CHUNK_NUM_BLOCKS, L, NG, BS, HS)).astype(np.float32)
         for _ in range(2)]
    wide = [rng.standard_normal((1, L, NG, (nc + 2) * BS, HS)).astype(np.float32)
            for _ in range(2)]
    return dtype, pos, nc, dest, x, wide


@pytest.fixture(scope="module")
def pallas_chunk_pair_writes():
    """Each case's arenas after ``pallasex.paged_chunk_write`` of the folded
    values, per arena, computed once per module."""
    done = {}

    def get(case):
        if case not in done:
            dtype, pos, nc, dest, x, wide = _chunk_pair_inputs(case)
            out = []
            for xa, w in zip(x, wide):
                v = np.ascontiguousarray(_fold(w[:, :, :, BS:(nc + 1) * BS], nc))
                out.append(_bytes(pallasex.paged_chunk_write(
                    _as(xa, dtype)[0], _as(v, dtype)[0], jnp.asarray(dest),
                    jnp.asarray(np.array([pos], np.int32)), block_size=BS)))
            done[case] = out
        return done[case]

    return get


@pytest.mark.parametrize("case", list(CHUNK_PAIR_CASES))
def test_bf16_chunk_pair_plain_matches_pallas(pallas_chunk_pair_writes, case):
    dtype, pos, nc, dest, x, wide = _chunk_pair_inputs(case)
    arenas = [_as(a, dtype)[1] for a in x]
    vals = [_as(w, dtype)[1][:, :, :, BS:(nc + 1) * BS] for w in wide]
    assert not vals[0].is_contiguous()
    got = cudaex.paged_chunk_write_pair(*arenas, *vals, torch.as_tensor(dest),
                                        torch.as_tensor(np.array([pos], np.int32)), block_size=BS)
    assert got[0] is arenas[0] and got[1] is arenas[1]
    for i, want in enumerate(pallas_chunk_pair_writes(case)):
        np.testing.assert_array_equal(_bytes(arenas[i])[1:], want[1:], err_msg=f"{case} {i}")
        assert (_bytes(arenas[i])[1:] != _bytes(_as(x[i], dtype)[1])[1:]).any()


def _token_pair_args():
    arenas, vals, tables, _ = _token_inputs("r5-f32-T5-masked")
    return ([torch.as_tensor(a) for a in arenas], [torch.as_tensor(v) for v in vals],
            torch.as_tensor(tables), torch.as_tensor(POS))


def _chunk_pair_args(T=8):
    q, s = tq.quantize_kv(torch.randn(8, L, NG, BS, HS, generator=torch.Generator().manual_seed(0)),
                          torch.int8)
    vals = torch.zeros(1, L, NG, T, HS)
    return [q, q.clone()], [s, s.clone()], [vals, vals.clone()]


@pytest.mark.parametrize("mutate,match", [
    (lambda a, v: (a.__setitem__(1, a[1].to(torch.float64)), v), "v_arena must match k_arena"),
    (lambda a, v: (a.__setitem__(1, a[1][:, :1].contiguous()), v), "v_arena must match k_arena"),
    (lambda a, v: (a, v.__setitem__(1, v[1][:, :, :, :4].contiguous())), "v_vals must match"),
], ids=["dtype", "shape", "vals"])
def test_token_pair_refuses_mismatched_arenas(mutate, match):
    arenas, vals, tables, pos = _token_pair_args()
    mutate(arenas, vals)
    with pytest.raises(ValueError, match=match):
        cudaex.paged_token_write_pair(*arenas, *vals, tables, pos, block_size=BS,
                                      n_emit=torch.as_tensor(N_EMIT))


@pytest.mark.parametrize("mutate,match", [
    (lambda a, s, v: a.__setitem__(1, a[1][:4].clone()), "v_arena must match k_arena"),
    (lambda a, s, v: v.__setitem__(1, v[1].to(torch.bfloat16)), "v_vals must match k_vals"),
    (lambda a, s, v: (v.__setitem__(0, torch.zeros(1, L, NG, 6, HS)),
                      v.__setitem__(1, torch.zeros(1, L, NG, 6, HS))),
     r"T=6 of k_vals/v_vals is not a multiple of block_size=4"),
], ids=["arena", "vals", "T"])
def test_chunk_pair_refuses_mismatched_arenas_and_ragged_T(mutate, match):
    arenas, scales, vals = _chunk_pair_args()
    mutate(arenas, scales, vals)
    with pytest.raises(ValueError, match=match):
        cudaex.paged_chunk_write_fused_pair(*arenas, *scales, *vals,
                                            torch.tensor([1, 2, 3], dtype=torch.int32),
                                            torch.tensor([0], dtype=torch.int32), block_size=BS)


def _fused_pair_args(T=5):
    arenas, vals, tables, pos = _token_pair_args()
    q = [tq.quantize_kv(a, torch.int8) for a in arenas]
    return [a for a, _ in q], [s for _, s in q], vals, tables, pos


@pytest.mark.parametrize("mutate,match", [
    (lambda a, s, v: a.__setitem__(1, a[1].view(torch.float8_e4m3fn)),
     "v_arena must match k_arena"),
    (lambda a, s, v: s.__setitem__(1, s[1][:, :1].contiguous()), "v_scale must be float32"),
    (lambda a, s, v: v.__setitem__(1, v[1].to(torch.bfloat16)), "v_vals must match k_vals"),
    (lambda a, s, v: v.__setitem__(slice(None), [x.to(torch.int8) for x in v]),
     "compute dtype"),
], ids=["arena", "scale", "vals", "vals-dtype"])
def test_fused_token_pair_refuses_mismatched_arguments(mutate, match):
    arenas, scales, vals, tables, pos = _fused_pair_args()
    mutate(arenas, scales, vals)
    with pytest.raises(ValueError, match=match):
        cudaex.paged_token_write_fused_pair(*arenas, *scales, *vals, tables, pos, block_size=BS,
                                            n_emit=torch.as_tensor(N_EMIT))


@pytest.mark.parametrize("mutate,match", [
    (lambda a, v: a.__setitem__(1, a[1][:4].clone()), "v_arena must match k_arena"),
    (lambda a, v: v.__setitem__(1, v[1].to(torch.bfloat16)), "v_vals must match k_vals"),
    (lambda a, v: (v.__setitem__(0, torch.zeros(1, L, NG, 6, HS)),
                   v.__setitem__(1, torch.zeros(1, L, NG, 6, HS))),
     r"T=6 of k_vals/v_vals is not a multiple of block_size=4"),
    (lambda a, v: (v.__setitem__(0, v[0].transpose(3, 4).contiguous().transpose(3, 4)),),
     "k_vals must hold each head's tokens contiguously"),
], ids=["arena", "vals", "T", "strides"])
def test_bf16_chunk_pair_refuses_mismatched_arenas_and_ragged_T(mutate, match):
    arenas = [torch.zeros(8, L, NG, BS, HS) for _ in range(2)]
    vals = [torch.zeros(1, L, NG, 8, HS) for _ in range(2)]
    mutate(arenas, vals)
    with pytest.raises(ValueError, match=match):
        cudaex.paged_chunk_write_pair(*arenas, *vals, torch.tensor([1, 2, 3], dtype=torch.int32),
                                      torch.tensor([0], dtype=torch.int32), block_size=BS)


def test_pair_writes_count_no_launches_on_cpu():
    cudaex.reset_launches()
    arenas, vals, tables, pos = _token_pair_args()
    cudaex.paged_token_write_pair(*arenas, *vals, tables, pos, block_size=BS)
    arenas, scales, vals = _chunk_pair_args()
    cudaex.paged_chunk_write_fused_pair(*arenas, *scales, *vals,
                                        torch.tensor([1, 2, 3], dtype=torch.int32),
                                        torch.tensor([0], dtype=torch.int32), block_size=BS)
    cudaex.paged_chunk_write_pair(*arenas[:2], *(v.to(torch.int8) for v in vals),
                                  torch.tensor([1, 2, 3], dtype=torch.int32),
                                  torch.tensor([0], dtype=torch.int32), block_size=BS)
    arenas, scales, vals, tables, pos = _fused_pair_args()
    cudaex.paged_token_write_fused_pair(*arenas, *scales, *vals, tables, pos, block_size=BS)
    assert set(cudaex.LAUNCHES.values()) == {0}


#
# on the card (skipped here)
#


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_token_case(card, dtype, rank, T, hs=64, B=6, num_blocks=64, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    pos = torch.tensor([0, 1, 33, 17, 64, 15], dtype=torch.int32, device=card)[:B]
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, 8), np.int32)
    free = rng.permutation(np.arange(1, num_blocks))
    k = 0
    for i, p in enumerate(pos.tolist()):
        if i == 0:
            continue                                       # batch padding
        n = -(-(p + T) // 16)
        tables[i, :n] = free[k:k + n]
        k += n
    tail = (hs,) if rank == 5 else ()
    arenas = [torch.randn((num_blocks, 3, 2, 16, *tail), generator=gen, device=card).to(dtype)
              for _ in range(2)]
    # a wider forward output, sliced: the values are read in place by strides
    wide = torch.randn((B, 3, 2, T + 2, *tail), generator=gen, device=card).to(dtype)
    vals = [wide[:, :, :, 1:T + 1], wide[:, :, :, :T] * 2]
    return arenas, vals, torch.as_tensor(tables, device=card), pos


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rank,T,masked", [(5, 1, False), (5, 5, True), (5, 5, False),
                                           (4, 1, False), (4, 5, True), (5, 1, True)])
def test_cuda_token_pair_matches_plain(card, dtype, rank, T, masked):
    """Both arenas bitwise equal to the plain version outside sink block 0,
    T = 1 in the (B, L, ng, hs) form, every offset of a masked round (n_emit
    0 to K+1), strided values (K's and V's strides differ); two calls
    bitwise equal outside the sink (several rows write its slot 0 at once);
    one launch each."""
    arenas, vals, tables, pos = _card_token_case(card, dtype, rank, T)
    if T == 1:
        vals = [v[:, :, :, 0] for v in vals]
    n_emit = (torch.tensor([0, 5, 1, 3, 2, 4], dtype=torch.int32, device=card)
              if masked else None)
    want = cudaex.paged_token_write_pair_plain(*(a.clone() for a in arenas), *vals, tables, pos,
                                               block_size=16, n_emit=n_emit)
    cudaex.reset_launches()
    got = cudaex.paged_token_write_pair(*(a.clone() for a in arenas), *vals, tables, pos,
                                        block_size=16, n_emit=n_emit)
    again = cudaex.paged_token_write_pair(*(a.clone() for a in arenas), *vals, tables, pos,
                                          block_size=16, n_emit=n_emit)
    torch.cuda.synchronize()
    counter = "paged_token_write_masked" if masked else "paged_token_write"
    assert cudaex.LAUNCHES[counter] == 2 and sum(cudaex.LAUNCHES.values()) == 2
    for g, a, w in zip(got, again, want):               # block 0 is the sink: rows race there
        assert torch.equal(g[1:], w[1:]) and torch.equal(g[1:], a[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("hs", [64, 20, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(STORAGE))
def test_cuda_chunk_pair_matches_plain(card, kind, dtype, hs):
    """Stored bytes and scales of both arenas bitwise equal to the plain
    version outside sink block 0, the error sums within 1e-5 relative (f32
    sums in another order), two calls bitwise equal (sums included; bytes
    outside the sink, where chunk blocks past the table race), one launch;
    hs 64 takes 16-byte loads, hs 20 the element-wise path, hs 320 two
    8-value pieces per lane."""
    gen = torch.Generator(device=card).manual_seed(1)
    tst = STORAGE[kind][1]
    base = [tq.quantize_kv(torch.randn((64, 3, 2, 16, hs), generator=gen, device=card) * 2, tst)
            for _ in range(2)]
    rng = np.random.default_rng(2)
    blocks = [int(b) for b in rng.permutation(np.arange(1, 64))[:7]]
    # the last piece: a leased block, one the table leaves to the sink, one past the table
    for p0, nc in ((0, 2), (32, 4), (96, 3)):
        _, dest = chunk_tables(blocks, p0, nc * 16, 8, 16)
        dest, pos = (torch.as_tensor(dest, device=card),
                     torch.tensor([p0], dtype=torch.int32, device=card))
        vals = [(torch.randn((1, 3, 2, nc * 16, hs), generator=gen, device=card) * 3).to(dtype)
                for _ in range(2)]
        vals[0][0, 0, 0, 3] = 0.0                        # an all-zero slot-head

        def run(fn):
            a = [b[0].clone() for b in base]
            s = [b[1].clone() for b in base]
            return fn(*a, *s, *vals, dest, pos, block_size=16)

        want = run(cudaex.paged_chunk_write_fused_pair_plain)
        cudaex.reset_launches()
        got, again = run(cudaex.paged_chunk_write_fused_pair), run(
            cudaex.paged_chunk_write_fused_pair)
        torch.cuda.synchronize()
        assert cudaex.LAUNCHES["paged_chunk_write_fused"] == 2
        for i in range(4):
            g, w = got[i], want[i]
            if g.dtype == tst:
                g, w, a = g.view(torch.uint8), w.view(torch.uint8), again[i].view(torch.uint8)
            else:
                a = again[i]
            assert torch.equal(g[1:], w[1:]) and torch.equal(g[1:], a[1:])
        assert torch.equal(got[4], again[4])
        torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_single_arena_writes_take_the_pair_kernels(card):
    """The single-arena entry points (the reference's signatures) launch the
    same kernels with one arena: equal to their plain versions, one launch
    each."""
    arenas, vals, tables, pos = _card_token_case(card, torch.bfloat16, 5, 1)
    v = vals[0][:, :, :, 0].contiguous()
    n_emit = torch.tensor([0, 5, 1, 3, 2, 4], dtype=torch.int32, device=card)
    cudaex.reset_launches()
    got = cudaex.paged_token_write(arenas[0].clone(), v, tables, pos, block_size=16)
    gotm = cudaex.paged_token_write_masked(arenas[0].clone(), v, tables, pos, n_emit, 1,
                                           block_size=16)
    torch.cuda.synchronize()
    assert cudaex.LAUNCHES["paged_token_write"] == cudaex.LAUNCHES["paged_token_write_masked"] == 1
    want = cudaex.paged_token_write_plain(arenas[0].clone(), v, tables, pos, block_size=16)
    wantm = cudaex.paged_token_write_masked_plain(arenas[0].clone(), v, tables, pos, n_emit, 1,
                                                  block_size=16)
    assert torch.equal(got[1:], want[1:]) and torch.equal(gotm[1:], wantm[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("hs", [64, 20, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("T,masked", [(1, False), (1, True), (5, True), (5, False)])
@pytest.mark.parametrize("kind", list(STORAGE))
def test_cuda_fused_token_pair_matches_plain(card, kind, T, masked, dtype, hs):
    """Stored bytes and scales of both arenas bitwise equal to the plain
    version outside sink block 0: a decode step, a multi-step iteration's
    liveness mask, every offset of a round (masked: n_emit 0 to K+1) from
    values read as strided views (K's and V's strides differ); hs 64 takes
    16-byte loads, hs 20 the element-wise path, hs 320 two 8-value pieces
    per lane; two calls bitwise equal outside the sink; one launch each."""
    tst = STORAGE[kind][1]
    arenas, vals, tables, pos = _card_token_case(card, dtype, 5, T, hs=hs)
    base = [tq.quantize_kv(a, tst) for a in arenas]
    if T == 1:
        vals = [v[:, :, :, 0] for v in vals]
    n_emit = None
    if masked:
        n_emit = torch.tensor([0, 5, 1, 3, 2, 4] if T > 1 else [0, 1, 0, 1, 1, 1],
                              dtype=torch.int32, device=card)

    def run(fn):
        return fn(*(q.clone() for q, _ in base), *(s.clone() for _, s in base), *vals, tables,
                  pos, block_size=16, n_emit=n_emit)

    want = run(cudaex.paged_token_write_fused_pair_plain)
    cudaex.reset_launches()
    got, again = run(cudaex.paged_token_write_fused_pair), run(cudaex.paged_token_write_fused_pair)
    torch.cuda.synchronize()
    assert cudaex.LAUNCHES["paged_token_write_fused"] == 2 and sum(cudaex.LAUNCHES.values()) == 2
    for g, a, w in zip(got, again, want):                # block 0 is the sink: rows race there
        if g.dtype == tst:
            g, a, w = g.view(torch.uint8), a.view(torch.uint8), w.view(torch.uint8)
        assert torch.equal(g[1:], w[1:]) and torch.equal(g[1:], a[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("hs", [64, 20, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_cuda_chunk_pair_reads_values_in_place(card, dtype, hs):
    """``paged_chunk_write_pair`` off strided (1, L, ng, T, hs) views: both
    arenas bitwise equal to the plain version outside sink block 0 and two
    calls bitwise equal there, one launch per call; a first piece, one past
    the leased blocks, one past the table (into the sink); the views start
    one token in, so hs 64 bf16 moves 16-byte vectors, hs 20 bf16 8-byte
    ones and hs 3 float32 4-byte ones."""
    gen = torch.Generator(device=card).manual_seed(3)
    base = [torch.randn((64, 3, 2, 16, hs), generator=gen, device=card).to(dtype)
            for _ in range(2)]
    rng = np.random.default_rng(4)
    blocks = [int(b) for b in rng.permutation(np.arange(1, 64))[:7]]
    for p0, nc in ((0, 2), (32, 4), (96, 3)):
        _, dest = chunk_tables(blocks, p0, nc * 16, 8, 16)
        dest, pos = (torch.as_tensor(dest, device=card),
                     torch.tensor([p0], dtype=torch.int32, device=card))
        wide = [torch.randn((1, 3, 2, nc * 16 + 2, hs), generator=gen, device=card).to(dtype)
                for _ in range(2)]
        vals = [w[:, :, :, 1:nc * 16 + 1] for w in wide]

        def run(fn):
            return fn(*(a.clone() for a in base), *vals, dest, pos, block_size=16)

        want = run(cudaex.paged_chunk_write_pair_plain)
        cudaex.reset_launches()
        got, again = run(cudaex.paged_chunk_write_pair), run(cudaex.paged_chunk_write_pair)
        torch.cuda.synchronize()
        assert cudaex.LAUNCHES["paged_chunk_write"] == 2 and sum(cudaex.LAUNCHES.values()) == 2
        for g, a, w in zip(got, again, want):
            assert torch.equal(g[1:], w[1:]) and torch.equal(g[1:], a[1:])


@pytest.mark.cuda
def test_cuda_single_arena_fused_and_chunk_writes_take_the_pair_kernels(card):
    """``paged_token_write_fused`` (plain and masked) and
    ``paged_chunk_write`` (the reference's signatures) launch the pairs'
    kernels with one arena: equal to their plain versions, one launch each."""
    arenas, vals, tables, pos = _card_token_case(card, torch.bfloat16, 5, 1)
    v = vals[0][:, :, :, 0].contiguous()
    q, s = tq.quantize_kv(arenas[0], torch.int8)
    n_emit = torch.tensor([0, 5, 1, 3, 2, 4], dtype=torch.int32, device=card)
    cv = torch.randn((3, 3, 2, 16, 64), generator=torch.Generator(device=card).manual_seed(5),
                     device=card).to(torch.bfloat16)
    dest, p = tables[3], torch.tensor([16], dtype=torch.int32, device=card)
    cudaex.reset_launches()
    got = cudaex.paged_token_write_fused(q.clone(), s.clone(), v, tables, pos, block_size=16)
    gotm = cudaex.paged_token_write_fused(q.clone(), s.clone(), v, tables, pos, block_size=16,
                                          n_emit=n_emit, offset=1)
    gotc = cudaex.paged_chunk_write(arenas[1].clone(), cv, dest, p, block_size=16)
    torch.cuda.synchronize()
    assert cudaex.LAUNCHES["paged_token_write_fused"] == 2
    assert cudaex.LAUNCHES["paged_chunk_write"] == 1 and sum(cudaex.LAUNCHES.values()) == 3
    want = cudaex.paged_token_write_fused_plain(q.clone(), s.clone(), v, tables, pos,
                                                block_size=16)
    wantm = cudaex.paged_token_write_fused_plain(q.clone(), s.clone(), v, tables, pos,
                                                 block_size=16, n_emit=n_emit, offset=1)
    wantc = cudaex.paged_chunk_write_plain(arenas[1].clone(), cv, dest, p, block_size=16)
    for g, w in zip((*got, *gotm), (*want, *wantm)):
        assert torch.equal(g.view(torch.uint8)[1:], w.view(torch.uint8)[1:])
    assert torch.equal(gotc[1:], wantc[1:])
