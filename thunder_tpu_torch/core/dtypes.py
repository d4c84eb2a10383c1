"""Framework-independent dtype lattice with weak/strong dtypes.

Counterpart of ``thunder_tpu/core/dtypes.py`` (dtype class, ``to_dtype``,
promotion helpers).  The lattice is copied; every dtype maps to a torch
dtype where the reference maps to a ``jax.numpy`` one, and 64-bit dtypes
are not narrowed (torch computes int64 and float64).
"""
from __future__ import annotations

from numbers import Number
from typing import Any, Type

import numpy as np

__all__ = [
    "dtype",
    "exact",
    "signedinteger",
    "unsignedinteger",
    "bool_",
    "inexact",
    "floating",
    "complexfloating",
    # instances
    "bool8",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "int8",
    "int16",
    "int32",
    "int64",
    "bfloat16",
    "float16",
    "float32",
    "float64",
    "float8_e4m3",
    "float8_e5m2",
    "complex64",
    "complex128",
    # queries / conversions
    "all_dtypes",
    "weak_dtypes",
    "strong_dtypes",
    "is_boolean_dtype",
    "is_unsigned_dtype",
    "is_signedinteger_dtype",
    "is_exact_dtype",
    "is_low_precision_dtype",
    "is_float_dtype",
    "is_complex_dtype",
    "is_inexact_dtype",
    "is_numbertype",
    "is_dtype",
    "is_weak_dtype",
    "dtype_to_numbertype",
    "numbertype_to_dtype",
    "to_dtype",
    "to_strong_dtype",
    "has_subdtype",
    "are_same_dtypes",
    "corresponding_real_dtype",
    "corresponding_complex_dtype",
    "canonicalize_dtype",
    "to_torch_dtype",
    "from_torch_dtype",
    "default_float_dtype",
    "default_int_dtype",
]


class dtype:
    """A thunder_tpu dtype.

    ``weak`` dtypes model Python numbers participating in type promotion
    (a Python float is a "weak float32"-class value).
    """

    def __init__(self, *, python_type: Type, name: str, shortname: str, bytes: int, is_weak: bool):
        self._python_type = python_type
        self._name = name
        self._shortname = shortname
        self._bytes = bytes
        self._is_weak = is_weak

    @property
    def python_type(self) -> Type:
        return self._python_type

    @property
    def bytes(self) -> int:
        return self._bytes

    @property
    def itemsize(self) -> int:
        return self._bytes

    @property
    def is_weak(self) -> bool:
        return self._is_weak

    @property
    def name(self) -> str:
        return self._name

    def shortname(self) -> str:
        return f"{self._shortname}{8 * self._bytes}"

    def full_name(self) -> str:
        return f"{self._name}{8 * self._bytes}"

    def __repr__(self) -> str:
        return f"{self.full_name()}{'_' if self._is_weak else ''}"

    __str__ = __repr__

    def __hash__(self) -> int:
        return hash((self._name, self._bytes, self._is_weak))

    def __eq__(self, other) -> bool:
        if not isinstance(other, dtype):
            return False
        return self._name == other._name and self._bytes == other._bytes and self._is_weak == other._is_weak


class exact(dtype):
    """Abstract base for boolean and integer dtypes."""


class signedinteger(exact):
    def __init__(self, name, shortname, *, bytes, is_weak):
        super().__init__(python_type=int, name=name, shortname=shortname, bytes=bytes, is_weak=is_weak)


class unsignedinteger(exact):
    def __init__(self, name, shortname, *, bytes, is_weak):
        super().__init__(python_type=int, name=name, shortname=shortname, bytes=bytes, is_weak=is_weak)


class bool_(exact):
    def __init__(self, name, shortname, *, is_weak):
        super().__init__(python_type=bool, name=name, shortname=shortname, bytes=1, is_weak=is_weak)

    def __repr__(self):
        return f"{self._name}{'_' if self._is_weak else ''}"


class inexact(dtype):
    """Abstract base for floating and complex dtypes."""


class floating(inexact):
    def __init__(self, name, shortname, *, bytes, is_weak, variant: str | None = None):
        self._variant = variant
        super().__init__(python_type=float, name=name, shortname=shortname, bytes=bytes, is_weak=is_weak)

    def full_name(self):
        v = f"_{self._variant}" if self._variant else ""
        return f"{self._name}{8 * self._bytes}{v}"

    def __hash__(self):
        return hash((self._name, self._bytes, self._is_weak, self._variant))

    def __eq__(self, other):
        return (
            isinstance(other, floating)
            and super().__eq__(other)
            and self._variant == getattr(other, "_variant", None)
        )


class complexfloating(inexact):
    def __init__(self, name, shortname, *, bytes, is_weak):
        super().__init__(python_type=complex, name=name, shortname=shortname, bytes=bytes, is_weak=is_weak)


# Instances: (strong, weak) pairs
bool8_ = bool_("bool", "b", is_weak=True)
bool8 = bool_("bool", "b", is_weak=False)
uint8_ = unsignedinteger("uint", "u", bytes=1, is_weak=True)
uint8 = unsignedinteger("uint", "u", bytes=1, is_weak=False)
uint16_ = unsignedinteger("uint", "u", bytes=2, is_weak=True)
uint16 = unsignedinteger("uint", "u", bytes=2, is_weak=False)
uint32_ = unsignedinteger("uint", "u", bytes=4, is_weak=True)
uint32 = unsignedinteger("uint", "u", bytes=4, is_weak=False)
uint64_ = unsignedinteger("uint", "u", bytes=8, is_weak=True)
uint64 = unsignedinteger("uint", "u", bytes=8, is_weak=False)
int8_ = signedinteger("int", "i", bytes=1, is_weak=True)
int8 = signedinteger("int", "i", bytes=1, is_weak=False)
int16_ = signedinteger("int", "i", bytes=2, is_weak=True)
int16 = signedinteger("int", "i", bytes=2, is_weak=False)
int32_ = signedinteger("int", "i", bytes=4, is_weak=True)
int32 = signedinteger("int", "i", bytes=4, is_weak=False)
int64_ = signedinteger("int", "i", bytes=8, is_weak=True)
int64 = signedinteger("int", "i", bytes=8, is_weak=False)
float8_e4m3_ = floating("float", "f", bytes=1, is_weak=True, variant="e4m3")
float8_e4m3 = floating("float", "f", bytes=1, is_weak=False, variant="e4m3")
float8_e5m2_ = floating("float", "f", bytes=1, is_weak=True, variant="e5m2")
float8_e5m2 = floating("float", "f", bytes=1, is_weak=False, variant="e5m2")
bfloat16_ = floating("bfloat", "bf", bytes=2, is_weak=True)
bfloat16 = floating("bfloat", "bf", bytes=2, is_weak=False)
float16_ = floating("float", "f", bytes=2, is_weak=True)
float16 = floating("float", "f", bytes=2, is_weak=False)
float32_ = floating("float", "f", bytes=4, is_weak=True)
float32 = floating("float", "f", bytes=4, is_weak=False)
float64_ = floating("float", "f", bytes=8, is_weak=True)
float64 = floating("float", "f", bytes=8, is_weak=False)
complex64_ = complexfloating("complex", "c", bytes=8, is_weak=True)
complex64 = complexfloating("complex", "c", bytes=8, is_weak=False)
complex128_ = complexfloating("complex", "c", bytes=16, is_weak=True)
complex128 = complexfloating("complex", "c", bytes=16, is_weak=False)

all_dtypes = {
    bool8_, bool8, uint8_, uint8, uint16_, uint16, uint32_, uint32, uint64_, uint64,
    int8_, int8, int16_, int16, int32_, int32, int64_, int64,
    float8_e4m3_, float8_e4m3, float8_e5m2_, float8_e5m2,
    bfloat16_, bfloat16, float16_, float16, float32_, float32, float64_, float64,
    complex64_, complex64, complex128_, complex128,
}

all_numbertypes = {bool, int, float, complex}

weak_dtypes = {d for d in all_dtypes if d.is_weak}
strong_dtypes = {d for d in all_dtypes if not d.is_weak}

float_dtypes = {d for d in all_dtypes if isinstance(d, floating)}
float_math_dtypes = {d for d in all_dtypes if isinstance(d, floating) and d.bytes >= 2}
complex_dtypes = {d for d in all_dtypes if isinstance(d, complexfloating)}
inexact_dtypes = float_dtypes | complex_dtypes
exact_dtypes = {d for d in all_dtypes if isinstance(d, exact)}
low_precision_dtypes = {
    d for d in all_dtypes if isinstance(d, (floating, complexfloating)) and d.bytes <= 2
}
integer_dtypes = {d for d in all_dtypes if isinstance(d, (signedinteger, unsignedinteger))} | {bool8, bool8_}
signedinteger_dtypes = {d for d in all_dtypes if isinstance(d, signedinteger)}
unsignedinteger_dtypes = {d for d in all_dtypes if isinstance(d, unsignedinteger)}
boolean_dtypes = {bool8, bool8_}


def is_weak_dtype(d: Any) -> bool:
    if isinstance(d, dtype):
        return d.is_weak
    return True  # numbertypes are weak


def is_numbertype(x: Any) -> bool:
    return x in all_numbertypes


def is_dtype(x: Any) -> bool:
    return isinstance(x, dtype) or is_numbertype(x)


def is_boolean_dtype(d) -> bool:
    return d in boolean_dtypes or d is bool


def is_unsigned_dtype(d) -> bool:
    return is_boolean_dtype(d) or d in unsignedinteger_dtypes


def is_signedinteger_dtype(d) -> bool:
    if is_boolean_dtype(d) or d in unsignedinteger_dtypes:
        return False
    return d in signedinteger_dtypes or d is int


def is_exact_dtype(d) -> bool:
    return d in exact_dtypes or d in (bool, int)


def is_low_precision_dtype(d) -> bool:
    return d in low_precision_dtypes


def is_float_dtype(d) -> bool:
    return d in float_dtypes or d is float


def is_complex_dtype(d) -> bool:
    return d in complex_dtypes or d is complex


def is_inexact_dtype(d) -> bool:
    return is_float_dtype(d) or is_complex_dtype(d)


def dtype_to_numbertype(d) -> Type | None:
    if is_numbertype(d):
        return d
    if is_boolean_dtype(d):
        return bool
    if is_exact_dtype(d):
        return int
    if is_float_dtype(d):
        return float
    if is_complex_dtype(d):
        return complex
    raise ValueError(f"Trying to extract the numbertype of unknown dtype {d}!")


_numbertype_to_dtype_map = {
    bool: bool8_,
    int: int64_,
    float: float32_,
    complex: complex64_,
}


def numbertype_to_dtype(typ) -> dtype:
    if isinstance(typ, dtype):
        return typ
    return _numbertype_to_dtype_map[typ]


def has_subdtype(x, cls) -> bool:
    return isinstance(x, cls)


def to_strong_dtype(d) -> dtype:
    d = to_dtype(d)
    if not d.is_weak:
        return d
    # find the strong twin
    for cand in strong_dtypes:
        if (
            cand._name == d._name
            and cand._bytes == d._bytes
            and getattr(cand, "_variant", None) == getattr(d, "_variant", None)
        ):
            return cand
    raise ValueError(f"No strong dtype for {d}")


def to_weak_dtype(d) -> dtype:
    d = to_dtype(d)
    if d.is_weak:
        return d
    for cand in weak_dtypes:
        if (
            cand._name == d._name
            and cand._bytes == d._bytes
            and getattr(cand, "_variant", None) == getattr(d, "_variant", None)
        ):
            return cand
    raise ValueError(f"No weak dtype for {d}")


def are_same_dtypes(a, b, *, weak_and_strong_are_equivalent: bool = True) -> bool:
    a, b = to_dtype(a), to_dtype(b)
    if weak_and_strong_are_equivalent:
        return to_strong_dtype(a) == to_strong_dtype(b)
    return a == b


def corresponding_real_dtype(d) -> dtype:
    d = to_dtype(d)
    if d.bytes == 8:
        return float32_ if d.is_weak else float32
    return float64_ if d.is_weak else float64


def corresponding_complex_dtype(d) -> dtype:
    d = to_dtype(d)
    if d.bytes <= 4:
        return complex64_ if d.is_weak else complex64
    return complex128_ if d.is_weak else complex128


#
# torch / NumPy interop
#

import torch

# The reference maps to ``jax.numpy`` dtypes (thunder_tpu/core/dtypes.py:377-413);
# the port maps to torch's.  uint16/32/64 are torch's unsigned types (few
# operators take them), float8_e4m3 is torch's ``float8_e4m3fn``.
_torch_dtype_map = {
    bool8: torch.bool,
    uint8: torch.uint8,
    uint16: torch.uint16,
    uint32: torch.uint32,
    uint64: torch.uint64,
    int8: torch.int8,
    int16: torch.int16,
    int32: torch.int32,
    int64: torch.int64,
    bfloat16: torch.bfloat16,
    float16: torch.float16,
    float32: torch.float32,
    float64: torch.float64,
    float8_e4m3: torch.float8_e4m3fn,
    float8_e5m2: torch.float8_e5m2,
    complex64: torch.complex64,
    complex128: torch.complex128,
}

_from_torch_dtype_map = {v: k for k, v in _torch_dtype_map.items()}

# NumPy has no bfloat16 or float8; those come in only as torch tensors.
_from_numpy_dtype_map = {
    np.dtype(str(v).removeprefix("torch.")): k
    for k, v in _torch_dtype_map.items()
    if k not in (bfloat16, float8_e4m3, float8_e5m2)
}
_from_numpy_dtype_map[np.dtype(np.bool_)] = bool8


def to_torch_dtype(d):
    """thunder_tpu dtype (or numbertype) → torch dtype."""
    if d is None:
        return None
    if is_numbertype(d):
        d = numbertype_to_dtype(d)
    return _torch_dtype_map[to_strong_dtype(d)]


def from_torch_dtype(td) -> dtype:
    try:
        return _from_torch_dtype_map[td]
    except KeyError:
        raise ValueError(f"Unknown torch dtype {td}") from None


def to_dtype(x: Any, *, true_dtype: bool = False) -> dtype | None:
    """Extracts or converts to a thunder_tpu dtype from dtypes, numbers,
    numbertypes, torch dtypes and tensors, numpy dtypes and arrays, and proxies."""
    if x is None:
        return None
    if isinstance(x, dtype):
        return x
    if isinstance(x, Number) and not isinstance(x, (bool,)) or isinstance(x, bool):
        return numbertype_to_dtype(type(x) if type(x) in all_numbertypes else _py_number_type(x))
    if is_numbertype(x):
        return numbertype_to_dtype(x)
    # proxies
    from thunder_tpu_torch.core.baseutils import TensorProxyInterface

    if isinstance(x, TensorProxyInterface):
        return x.dtype
    if isinstance(x, torch.dtype):
        return from_torch_dtype(x)
    if isinstance(x, torch.Tensor):
        return from_torch_dtype(x.dtype)
    # numpy
    try:
        return _from_numpy_dtype_map[np.dtype(getattr(x, "dtype", x))]
    except (TypeError, KeyError):
        pass
    raise ValueError(f"Cannot convert {x} (type {type(x)}) to a thunder_tpu dtype")


def _py_number_type(x: Number) -> Type:
    if isinstance(x, bool):
        return bool
    if isinstance(x, int):
        return int
    if isinstance(x, complex):
        return complex
    return float


def resolve_dtype(d) -> dtype:
    """Numbertype or dtype → strong dtype (the one canonical resolution helper)."""
    if is_numbertype(d):
        d = numbertype_to_dtype(d)
    return to_strong_dtype(d)


def canonicalize_dtype(d: dtype) -> dtype:
    """The identity.  The reference narrows 64-bit dtypes to 32 bits because
    JAX's x64 mode is off; torch computes int64 and float64, so the port keeps
    them (a divergence kept on purpose, ``ROADMAP.md`` Queue 3)."""
    return d


def default_float_dtype() -> dtype:
    return float32


def default_int_dtype() -> dtype:
    return int64
