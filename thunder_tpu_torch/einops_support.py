"""einops interop: a custom einops backend for TensorProxy.

Counterpart of ``thunder_tpu/einops_support.py``.  einops dispatches on the
tensor's type, so proxies need their own registered backend.  Implemented
over the torch language: every einops call lowers to the
reshape/permute/reduction/tile/stack ops the executor stack already
handles, so ``rearrange``/``reduce``/``repeat``/``einsum``/``pack`` work on
traced tensors.

Imported from ``thunder_tpu_torch/__init__`` when ``einops`` is importable.
Defining the ``AbstractBackend`` subclass is the registration:
``einops.get_backend`` walks the subclasses whose ``framework_name`` module
is imported on first contact with an unknown tensor type.
"""
from __future__ import annotations

from einops._backends import AbstractBackend

from thunder_tpu_torch.core.proxies import TensorProxy


class ThunderTpuBackend(AbstractBackend):
    framework_name = "thunder_tpu_torch"

    def is_appropriate_type(self, tensor):
        return isinstance(tensor, TensorProxy)

    def shape(self, x):
        return tuple(x.shape)

    def reshape(self, x, shape):
        import thunder_tpu_torch.torch as ltorch

        return ltorch.reshape(x, tuple(int(s) for s in shape))

    def transpose(self, x, axes):
        import thunder_tpu_torch.torch as ltorch

        return ltorch.permute(x, tuple(axes))

    def reduce(self, x, operation, axes):
        import thunder_tpu_torch.torch as ltorch

        axes = tuple(axes)
        fn = {"min": ltorch.amin, "max": ltorch.amax, "sum": ltorch.sum,
              "mean": ltorch.mean, "prod": ltorch.prod,
              "any": ltorch.any_, "all": ltorch.all_}[operation]
        # reductions over multiple dims: fold right-to-left so indices of
        # the remaining axes stay valid
        for ax in sorted(axes, reverse=True):
            x = fn(x, ax)
        return x

    def stack_on_zeroth_dimension(self, tensors: list):
        import thunder_tpu_torch.torch as ltorch

        return ltorch.stack(list(tensors), 0)

    def add_axis(self, x, new_position):
        import thunder_tpu_torch.torch as ltorch

        return ltorch.unsqueeze(x, new_position)

    def tile(self, x, repeats):
        import thunder_tpu_torch.torch as ltorch

        return ltorch.tile(x, tuple(int(r) for r in repeats))

    def concat(self, tensors, axis: int):
        import thunder_tpu_torch.torch as ltorch

        return ltorch.cat(list(tensors), axis)

    def is_float_type(self, x):
        from thunder_tpu_torch.core import dtypes

        return dtypes.is_float_dtype(x.dtype)

    def einsum(self, pattern, *x):
        import thunder_tpu_torch.torch as ltorch

        return ltorch.einsum(pattern, *x)
