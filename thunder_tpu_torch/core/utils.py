"""Core utilities: type promotion, dim canonicalization, dataflow maps.

Counterpart of ``thunder_tpu/core/utils.py``, copied but for two seams: the
promotion lattice is a literal table and the multi-process test reads
``torch.distributed``.  The reference is the analog of ``thunder/core/utils.py`` (elementwise_type_promotion
:402, OrderedSet :717, ProxyDict :896, producers/consumers :945,982).
"""
from __future__ import annotations

from enum import Enum
from numbers import Number
from typing import Any, Callable, Hashable, Iterable, Sequence

from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.baseutils import check, check_type
from thunder_tpu_torch.core.proxies import NumberProxy, Proxy, TensorProxy, Variable, pyval, variableify

__all__ = [
    "OrderedSet",
    "ProxyDict",
    "ELEMENTWISE_TYPE_PROMOTION_KIND",
    "elementwise_type_promotion",
    "get_numberlike_type",
    "get_numberlike_value",
    "canonicalize_dim",
    "canonicalize_dims",
    "check_no_duplicates",
    "same_shape",
    "check_same_shape",
    "check_same_device",
    "check_same_dtype",
    "safe_map",
    "safe_map_flat",
    "safe_zip",
    "dict_join",
    "producers",
    "consumers",
    "find_producer_symbols",
    "flatten_func",
]


#
# Containers
#


class OrderedSet:
    """A set that preserves insertion order (dict-backed)."""

    def __init__(self, items: Iterable | None = None):
        self._d: dict = {}
        if items is not None:
            for i in items:
                self._d[i] = None

    def add(self, x) -> None:
        self._d[x] = None

    def update(self, xs: Iterable) -> None:
        for x in xs:
            self._d[x] = None

    def remove(self, x) -> None:
        del self._d[x]

    def discard(self, x) -> None:
        self._d.pop(x, None)

    def pop(self):
        k = next(reversed(self._d))
        del self._d[k]
        return k

    def clear(self) -> None:
        self._d.clear()

    def union(self, *others) -> "OrderedSet":
        out = OrderedSet(self)
        for o in others:
            out.update(o)
        return out

    def __or__(self, other) -> "OrderedSet":
        return self.union(other)

    def __ior__(self, other) -> "OrderedSet":
        self.update(other)
        return self

    def __sub__(self, other) -> "OrderedSet":
        other = set(other)
        return OrderedSet(x for x in self if x not in other)

    def __and__(self, other) -> "OrderedSet":
        other = set(other)
        return OrderedSet(x for x in self if x in other)

    def __contains__(self, x) -> bool:
        return x in self._d

    def __iter__(self):
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __bool__(self) -> bool:
        return bool(self._d)

    def __repr__(self) -> str:
        return f"OrderedSet({list(self._d)})"


class ProxyDict:
    """Dict keyed by proxy name (reference utils.py:896)."""

    def __init__(self):
        self._d: dict[str, Any] = {}

    def __setitem__(self, p: Proxy, v: Any) -> None:
        self._d[p.name] = v

    def __getitem__(self, p: Proxy) -> Any:
        return self._d[p.name]

    def __contains__(self, p) -> bool:
        return isinstance(p, Proxy) and p.name in self._d

    def __delitem__(self, p: Proxy) -> None:
        del self._d[p.name]

    def get(self, p: Proxy, default=None):
        if not isinstance(p, Proxy):
            return default
        return self._d.get(p.name, default)

    def append(self, p: Proxy, v: Any) -> None:
        self._d.setdefault(p.name, []).append(v)

    def remove(self, p: Proxy, v: Any) -> None:
        self._d[p.name].remove(v)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()

    def __len__(self):
        return len(self._d)

    def __repr__(self) -> str:
        return f"ProxyDict({self._d})"


def safe_map(fn: Callable, *args):
    n = len(args[0])
    for a in args[1:]:
        check(len(a) == n, lambda: f"Length mismatch in safe_map: {len(a)} vs {n}")
    return list(map(fn, *args))


def safe_map_flat(fn: Callable, *args):
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten

    flats = []
    spec0 = None
    for a in args:
        flat, spec = tree_flatten(a)
        if spec0 is None:
            spec0 = spec
        flats.append(flat)
    out = safe_map(fn, *flats)
    return tree_unflatten(out, spec0)


def safe_zip(*args):
    n = len(args[0])
    for a in args[1:]:
        check(len(a) == n, lambda: f"Length mismatch in safe_zip: {len(a)} vs {n}")
    return list(zip(*args))


def dict_join(*dicts: dict) -> dict:
    out: dict = {}
    for d in dicts:
        out.update(d)
    return out


#
# Numbers
#


def get_numberlike_type(x):
    if isinstance(x, NumberProxy):
        return x.python_type
    if isinstance(x, bool):
        return bool
    if isinstance(x, int):
        return int
    if isinstance(x, float):
        return float
    if isinstance(x, complex):
        return complex
    raise ValueError(f"{x} is not number-like")


def get_numberlike_value(x):
    if isinstance(x, NumberProxy):
        return x.value
    if isinstance(x, Number):
        return x
    raise ValueError(f"{x} is not number-like")


#
# Type promotion (JAX's lattice, matching the reference's torch-style kinds)
#


class ELEMENTWISE_TYPE_PROMOTION_KIND(Enum):
    DEFAULT = 0  # computation dtype
    PRESERVE = 1  # no promotion
    INT_TO_FLOAT = 2  # ints promote to float
    ALWAYS_BOOL = 3  # result is bool
    COMPLEX_TO_FLOAT = 4  # complex results become real
    BOOL_TO_LONG = 5  # bools promote to int64
    NO_OPMATH = 6


_ordered_float = (dtypes.bfloat16, dtypes.float16, dtypes.float32, dtypes.float64)
_float_rank = {d: i for i, d in enumerate(_ordered_float)}


# JAX's promotion lattice over the strong dtypes, as a literal table: row
# promoted with column.  The reference calls ``jnp.promote_types``
# (thunder_tpu/core/utils.py:240-244); torch's lattice differs (uint64 with a
# signed int, the float8 pairs), so the port keeps JAX's as data.  It was
# generated once from ``jnp.promote_types``; ``tests/test_torch_port_ir.py``
# holds it against that.  "-" marks a pair JAX refuses to promote.
_PROMOTION_TABLE = (
    #         b   u8  u16  u32  u64   i8  i16  i32  i64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128
    "   b    b   u8  u16  u32  u64   i8  i16  i32  i64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128",
    "  u8   u8   u8  u16  u32  u64  i16  i16  i32  i64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128",
    " u16  u16  u16  u16  u32  u64  i32  i32  i32  i64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128",
    " u32  u32  u32  u32  u32  u64  i32  i32  i32  i64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128",
    " u64  u64  u64  u64  u64  u64  f64  f64  f64  f64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128",
    "  i8   i8  i16  i32  i32  f64   i8  i16  i32  i64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128",
    " i16  i16  i16  i32  i32  f64  i16  i16  i32  i64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128",
    " i32  i32  i32  i32  i32  f64  i32  i32  i32  i64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128",
    " i64  i64  i64  i64  i64  f64  i64  i64  i64  i64 bf16  f16  f32  f64 e4m3 e5m2  c64 c128",
    "bf16 bf16 bf16 bf16 bf16 bf16 bf16 bf16 bf16 bf16 bf16  f32  f32  f64    -    -  c64 c128",
    " f16  f16  f16  f16  f16  f16  f16  f16  f16  f16  f32  f16  f32  f64    -    -  c64 c128",
    " f32  f32  f32  f32  f32  f32  f32  f32  f32  f32  f32  f32  f32  f64    -    -  c64 c128",
    " f64  f64  f64  f64  f64  f64  f64  f64  f64  f64  f64  f64  f64  f64    -    - c128 c128",
    "e4m3 e4m3 e4m3 e4m3 e4m3 e4m3 e4m3 e4m3 e4m3 e4m3    -    -    -    - e4m3    -    -    -",
    "e5m2 e5m2 e5m2 e5m2 e5m2 e5m2 e5m2 e5m2 e5m2 e5m2    -    -    -    -    - e5m2    -    -",
    " c64  c64  c64  c64  c64  c64  c64  c64  c64  c64  c64  c64  c64 c128    -    -  c64 c128",
    "c128 c128 c128 c128 c128 c128 c128 c128 c128 c128 c128 c128 c128 c128    -    - c128 c128",
)
_PROMOTION_CODES = {
    "b": dtypes.bool8, "u8": dtypes.uint8, "u16": dtypes.uint16, "u32": dtypes.uint32,
    "u64": dtypes.uint64, "i8": dtypes.int8, "i16": dtypes.int16, "i32": dtypes.int32,
    "i64": dtypes.int64, "bf16": dtypes.bfloat16, "f16": dtypes.float16, "f32": dtypes.float32,
    "f64": dtypes.float64, "e4m3": dtypes.float8_e4m3, "e5m2": dtypes.float8_e5m2,
    "c64": dtypes.complex64, "c128": dtypes.complex128,
}


def _parse_promotion_table() -> dict:
    table = {}
    for line in _PROMOTION_TABLE:
        row, *results = line.split()
        a = _PROMOTION_CODES[row]
        for col, r in zip(_PROMOTION_CODES.values(), results):
            if r != "-":
                table[(a, col)] = _PROMOTION_CODES[r]
    return table


_PROMOTIONS = _parse_promotion_table()


def _promote_dtypes(a: dtypes.dtype, b: dtypes.dtype) -> dtypes.dtype:
    """Promotes two strong thunder dtypes on JAX's lattice (``_PROMOTION_TABLE``)."""
    key = (dtypes.to_strong_dtype(a), dtypes.to_strong_dtype(b))
    out = _PROMOTIONS.get(key)
    if out is None:
        raise ValueError(f"{key[0]} and {key[1]} have no implicit promotion")
    return out


def _typeof(x) -> tuple[dtypes.dtype, bool]:
    """Returns (strong dtype class value, is_tensor)."""
    if isinstance(x, TensorProxy):
        return x.dtype, True
    typ = get_numberlike_type(x)
    return dtypes.to_strong_dtype(dtypes.numbertype_to_dtype(typ)), False


def elementwise_type_promotion(*args, type_promotion_kind: ELEMENTWISE_TYPE_PROMOTION_KIND):
    """Computes (computation_dtype, result_dtype) for elementwise ops.

    Tensor dtypes dominate number (weak) dtypes of the same category, matching
    both torch's and JAX's weak-type semantics.
    """
    check(len(args) > 0, lambda: "Type promotion needs at least one argument")

    tensor_dtype: dtypes.dtype | None = None
    number_dtype: dtypes.dtype | None = None
    for a in args:
        d, is_tensor = _typeof(a)
        if is_tensor:
            tensor_dtype = d if tensor_dtype is None else _promote_dtypes(tensor_dtype, d)
        else:
            number_dtype = d if number_dtype is None else _promote_dtypes(number_dtype, d)

    if tensor_dtype is None:
        result = number_dtype
    elif number_dtype is None:
        result = tensor_dtype
    else:
        # numbers are weak: only their category promotes the tensor dtype
        tcat = dtypes.dtype_to_numbertype(tensor_dtype)
        ncat = dtypes.dtype_to_numbertype(number_dtype)
        cat_order = {bool: 0, int: 1, float: 2, complex: 3}
        if cat_order[ncat] > cat_order[tcat]:
            if ncat is float:
                result = dtypes.float32 if tensor_dtype not in (dtypes.float64,) else tensor_dtype
                # int/bool tensor + float number → default float
                if dtypes.is_exact_dtype(tensor_dtype):
                    result = dtypes.float32
            elif ncat is complex:
                result = dtypes.corresponding_complex_dtype(
                    tensor_dtype if dtypes.is_inexact_dtype(tensor_dtype) else dtypes.float32
                )
            else:  # int number over bool tensor
                result = dtypes.int64
        else:
            result = tensor_dtype

    k = type_promotion_kind
    K = ELEMENTWISE_TYPE_PROMOTION_KIND
    if k in (K.PRESERVE, K.NO_OPMATH):
        return result, result
    if k == K.ALWAYS_BOOL:
        return result, dtypes.bool8
    if k == K.INT_TO_FLOAT:
        if dtypes.is_exact_dtype(result):
            result = dtypes.float32
        return result, result
    if k == K.COMPLEX_TO_FLOAT:
        if dtypes.is_complex_dtype(result):
            return result, dtypes.corresponding_real_dtype(result)
        return result, result
    if k == K.BOOL_TO_LONG:
        if dtypes.is_boolean_dtype(result):
            return dtypes.int64, dtypes.int64
        return result, result
    # DEFAULT
    return result, result


#
# Shapes and dims
#


def canonicalize_dim(rank: int, dim: int, wrap_scalar: bool = True) -> int:
    if rank == 0 and wrap_scalar:
        rank = 1
    check(-rank <= dim < rank, lambda: f"Dimension {dim} out of range for rank {rank}", IndexError)
    if dim < 0:
        dim += rank
    return dim


def canonicalize_dims(rank: int, dims, wrap_scalar: bool = True):
    if isinstance(dims, (int,)) or isinstance(dims, NumberProxy):
        return canonicalize_dim(rank, int(pyval(dims) if isinstance(dims, NumberProxy) else dims), wrap_scalar)
    return tuple(canonicalize_dim(rank, int(d), wrap_scalar) for d in dims)


def check_no_duplicates(dims: Sequence) -> None:
    check(len(dims) == len(set(dims)), lambda: f"Duplicate value in {dims}")


def same_shape(a: Sequence[int], b: Sequence[int]) -> bool:
    return tuple(a) == tuple(b)


def check_same_shape(*args, name: str = "op"):
    shapes = [tuple(a.shape) for a in args if isinstance(a, TensorProxy)]
    if shapes:
        first = shapes[0]
        for s in shapes[1:]:
            check(s == first, lambda: f"{name}: shape mismatch {s} vs {first}")


def check_same_device(*args, name: str = "op"):
    devices_ = [a.device for a in args if isinstance(a, TensorProxy)]
    if devices_:
        first = devices_[0]
        for d in devices_[1:]:
            if d == first:
                continue
            if d.devicetype == first.devicetype and _multi_controller():
                # multi-controller: device INDICES legitimately diverge — a
                # globally-sharded value canonicalizes to global id 0 while a
                # process-local array carries this process's nonzero id; the runtime
                # owns placement, so only the device TYPE is checkable
                continue
            check(False, lambda: f"{name}: device mismatch {d} vs {first}")


def _multi_controller() -> bool:
    """More than one process (the reference reads ``jax.process_count()``)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def check_same_dtype(*args, name: str = "op"):
    ds = [a.dtype for a in args if isinstance(a, TensorProxy)]
    if ds:
        first = ds[0]
        for d in ds[1:]:
            check(
                dtypes.are_same_dtypes(d, first),
                lambda: f"{name}: dtype mismatch {d} vs {first}",
            )


#
# Dataflow
#


def producers(trace_or_bsyms, *, _map_to_numbers: bool = False) -> ProxyDict:
    """Maps each proxy to the bound symbol that produces it."""
    bsyms = trace_or_bsyms if isinstance(trace_or_bsyms, (list, tuple)) else trace_or_bsyms.bound_symbols
    result = ProxyDict()
    for idx, bsym in enumerate(bsyms):
        for out in bsym.flat_proxy_outs:
            vout = variableify(out)
            # a proxy is produced once; later rebinds (e.g. identity returns) don't count
            if any(variableify(a) == vout for a in bsym.flat_proxy_args):
                continue
            if out in result:
                continue
            result[out] = idx if _map_to_numbers else bsym
    return result


def consumers(trace_or_bsyms, *, _map_to_numbers: bool = False) -> ProxyDict:
    """Maps each proxy to the list of bound symbols that consume it."""
    bsyms = trace_or_bsyms if isinstance(trace_or_bsyms, (list, tuple)) else trace_or_bsyms.bound_symbols
    result = ProxyDict()
    for idx, bsym in enumerate(bsyms):
        for arg in bsym.flat_proxy_args:
            result.append(arg, idx if _map_to_numbers else bsym)
    return result


def find_producer_symbols(trace, proxies: Sequence[Proxy], stop_proxies: Sequence[Proxy]) -> tuple:
    """Returns the bsyms needed to produce ``proxies`` from ``stop_proxies``
    (reference utils.py analog used by rematerialization)."""
    pmap = producers(trace)
    stop = {variableify(p) for p in stop_proxies}
    seen: set = set()
    result: list = []
    queue = [p for p in proxies if variableify(p) not in stop]
    while queue:
        p = queue.pop()
        v = variableify(p)
        if v in seen or v in stop:
            continue
        seen.add(v)
        bsym = pmap.get(p)
        if bsym is None:
            continue
        if bsym not in result:
            result.append(bsym)
        for arg in bsym.flat_proxy_args:
            va = variableify(arg)
            if va not in seen and va not in stop:
                queue.append(arg)
    # order as in the original trace
    order = {id(b): i for i, b in enumerate(trace.bound_symbols)}
    result.sort(key=lambda b: order.get(id(b), 0))
    return tuple(result)


def flatten_func(fn: Callable, args: Sequence, kwargs: dict):
    """Returns (flat_fn, flat_args, spec) such that flat_fn(*flat_args) == fn(*args, **kwargs)."""
    from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten

    flat_args, spec = tree_flatten((tuple(args), dict(kwargs)))

    def flat_fn(*fargs):
        a, kw = tree_unflatten(list(fargs), spec)
        return fn(*a, **kw)

    return flat_fn, flat_args, spec
