"""Devices of the port: ``cpu`` and ``cuda:N``.

Counterpart of ``thunder_tpu/core/devices.py`` (DeviceType, interned
Device, string parsing, framework conversion).  The reference's accelerator
is the TPU and it converts to ``jax.Device``; the port's is the CUDA card
and it converts to ``torch.device`` (``to_torch_device`` /
``from_torch_device``).  The default device is ``cuda``: without a card it
raises, as ``thunder_tpu_torch._device.resolve_device`` does, so factories
given ``device=None`` run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from enum import Enum, auto
from typing import Any, Optional

import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.core.baseutils import check

__all__ = [
    "DeviceType",
    "Device",
    "device_from_string",
    "to_device",
    "to_torch_device",
    "from_torch_device",
    "cpu",
    "available_device_types",
]


class DeviceType(Enum):
    CPU = auto()
    CUDA = auto()

    def __str__(self):
        return _devicetype_prettyprint_map[self]


_devicetype_prettyprint_map = {
    DeviceType.CPU: "cpu",
    DeviceType.CUDA: "cuda",
}
_inverse_devicetype_prettyprint_map = {v: k for k, v in _devicetype_prettyprint_map.items()}

all_devicetypes = (DeviceType.CPU, DeviceType.CUDA)


def devicetype_string(devicetype: DeviceType) -> str:
    return _devicetype_prettyprint_map[devicetype]


class Device(str):
    """An interned (devicetype, index) pair.

    ``Device`` objects are compared by value and safe to use as dict keys.
    The accelerator index is the CUDA ordinal (``cuda:N``).

    Subclasses ``str`` (raw value: the torch device string, ``"cuda:0"``)
    so torch's argument parser accepts a Device as a ``device=`` kwarg.
    """

    _interned: dict[tuple[DeviceType, int], "Device"] = {}

    def __new__(cls, devicetype: DeviceType | str, index: int | None = None):
        if isinstance(devicetype, Device):
            return devicetype
        if isinstance(devicetype, str):
            devicetype, parsed_index = _parse_device_string(devicetype)
            if index is None:
                index = parsed_index
            else:
                check(
                    parsed_index is None or parsed_index == index,
                    lambda: f"Conflicting device indices {parsed_index} vs {index}",
                )
        if index is None:
            index = 0
        check(isinstance(index, int) and index >= 0, lambda: f"Invalid device index {index}")
        key = (devicetype, index)
        cached = cls._interned.get(key)
        if cached is not None:
            return cached
        self = super().__new__(cls, f"{devicetype_string(devicetype)}:{index}")
        self._devicetype = devicetype
        self._index = index
        cls._interned[key] = self
        return self

    @property
    def devicetype(self) -> DeviceType:
        return self._devicetype

    @property
    def type(self) -> str:
        return devicetype_string(self._devicetype)

    @property
    def index(self) -> int:
        return self._index

    def device_str(self) -> str:
        return f"{devicetype_string(self._devicetype)}:{self._index}"

    def __repr__(self) -> str:
        return f'Device(type="{self.device_str()}")'

    def __str__(self) -> str:
        return self.device_str()

    def __format__(self, spec: str) -> str:
        return format(self.device_str(), spec)

    def __hash__(self) -> int:
        return hash((self._devicetype, self._index))

    def __eq__(self, other) -> bool:
        if isinstance(other, str) and not isinstance(other, Device):
            try:
                other = device_from_string(other)
            except Exception:
                return False  # e.g. device == "meta" in HF code: not equal, not an error
        return isinstance(other, Device) and self._devicetype == other._devicetype and self._index == other._index

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)


def _parse_device_string(s: str) -> tuple[DeviceType, Optional[int]]:
    parts = s.split(":")
    check(1 <= len(parts) <= 2, lambda: f"Invalid device string {s!r}")
    dt = _inverse_devicetype_prettyprint_map.get(parts[0])
    check(dt is not None, lambda: f"Unknown device type in {s!r}")
    index = int(parts[1]) if len(parts) == 2 else None
    return dt, index


def device_from_string(s: str) -> Device:
    return Device(s)


cpu = Device(DeviceType.CPU, 0)


def to_device(x: Any) -> Device:
    """Converts strings, torch devices, or Devices to a Device."""
    if x is None:
        return default_device()
    if isinstance(x, Device):
        return x
    if isinstance(x, str):
        return device_from_string(x)
    if isinstance(x, torch.device):
        return from_torch_device(x)
    raise ValueError(f"Cannot convert {x} to a Device")


def from_torch_device(td: torch.device) -> Device:
    dt = _inverse_devicetype_prettyprint_map.get(td.type)
    check(dt is not None, lambda: f"The port runs on cpu and cuda devices, not {td.type!r}")
    if dt == DeviceType.CUDA and td.index is None:
        return Device(dt, torch.cuda.current_device())
    return Device(dt, td.index or 0)


def to_torch_device(d: Device | str) -> torch.device:
    """The torch device; the CPU has no index (``torch.device("cpu")``, the
    device a CPU tensor reports, which compiled regions compare against)."""
    d = to_device(d)
    if d.devicetype is DeviceType.CPU:
        return torch.device("cpu")
    return torch.device(d.type, d.index)


def default_device() -> Device:
    """``cuda:<current>``; raises without a card (``resolve_device``), so a
    factory given ``device=None`` never lands on the CPU unasked."""
    return from_torch_device(resolve_device("cuda"))


def available_device_types() -> tuple[DeviceType, ...]:
    if torch.cuda.is_available():
        return (DeviceType.CPU, DeviceType.CUDA)
    return (DeviceType.CPU,)
