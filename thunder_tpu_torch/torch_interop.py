"""torch.nn.Module interop: ThunderModule and its autograd bridge.

Counterpart of ``thunder_tpu/torch_interop.py``.  The module's forward is
*functionalized*: its parameters and buffers are swapped for proxies while
it is traced, so the whole forward records through the
``TensorProxy.__torch_function__`` diversion (and :class:`ThunderTracingMode`
for calls that carry no proxy) into one trace of the torch language.  It
runs as the port's compiled forward and backward programs, and
:class:`ThunderFunction` stitches them into torch autograd.

Where the reference moves tensors between torch and JAX through host memory
(with a transfer cache keyed by tensor version), the port passes the
parameters straight through: the programs read the ``nn.Parameter``
tensors themselves, so an optimizer's in-place update is seen on the next
call, and nothing is copied.

Limitations (v1, as the reference's): gradients flow to module
*parameters* (inputs receive ``None`` grads); buffer mutation (BatchNorm
running stats) is not recorded; ``module.training`` is baked at trace time.
The forward's residuals are dropped right after backward.
"""
from __future__ import annotations

import itertools
from typing import Any

import torch

__all__ = ["ThunderModule", "ThunderFunction", "functional_call", "ThunderTracingMode"]


_const_counter = itertools.count()


def _translate_thunder_metadata(x):
    """The port's dtype → torch dtype; the port's Device → torch device;
    everything else unchanged."""
    from thunder_tpu_torch.core import dtypes as ttd
    from thunder_tpu_torch.core.devices import Device as _TDev
    from thunder_tpu_torch.core.devices import to_torch_device

    if isinstance(x, ttd.dtype):
        return ttd.to_torch_dtype(x)
    if isinstance(x, _TDev):
        return to_torch_device(x)
    return x


def _const_tensor_proxy(t: torch.Tensor):
    """Bakes a concrete torch tensor into the active trace as a constant:
    records a zero-input producer bsym whose call-ctx callable returns the
    tensor (detached), and returns its output proxy.  This is how native
    torch constant math (masks built by the concrete-factory fast path)
    re-enters the traced program.

    The proxy is memoized per tensor identity on the trace: baking the same
    tensor again returns the same proxy object, so an in-place traced edit
    (``m[1:3] = traced`` rebinding the proxy) is visible to every later
    diverted use of ``m``.  (Native real-tensor reads after a traced edit
    still see the old buffer: mixing directions is inherently lossy.)"""
    from thunder_tpu_torch.core.proxies import tensorproxy
    from thunder_tpu_torch.core.symbol import Symbol
    from thunder_tpu_torch.core.trace import get_tracectx

    trace = get_tracectx()
    aliases = getattr(trace, "_torch_const_aliases", None)
    if aliases is None:
        aliases = trace._torch_const_aliases = {}
    hit = aliases.get(id(t))
    if hit is not None and hit[0] is t:
        return hit[1]
    value = t.detach()
    p = tensorproxy(value, requires_grad=False)
    cname = f"TCONST{next(_const_counter)}"
    sym = Symbol(name=cname, meta=None, is_fusion=True)
    bsym = sym.bind(output=p, subsymbols=(), _call_ctx={cname: lambda value=value: value})
    trace.record(bsym)
    aliases[id(t)] = (t, p)  # pins t so the id can't be recycled mid-trace
    return p


def _bake_torch_constants(args, kwargs):
    """Replaces real torch.Tensor leaves in a diverted call's arguments with
    baked constant proxies (lists/tuples walked one level: the layouts the
    torch language accepts)."""
    from thunder_tpu_torch.core.trace import get_tracectx

    if get_tracectx() is None:
        return args, kwargs

    def conv(x):
        if isinstance(x, torch.Tensor):
            return _const_tensor_proxy(x)
        if isinstance(x, (list, tuple)) and any(isinstance(e, torch.Tensor) for e in x):
            return type(x)(conv(e) for e in x)
        return x

    return tuple(conv(a) for a in args), {k: conv(v) for k, v in kwargs.items()}


class ThunderTracingMode(torch.overrides.TorchFunctionMode):
    """Diverts every mapped ``torch.*`` call into the torch language while a
    trace is active, including factory calls with no proxy argument
    (``torch.arange(0, T, device=...)`` in HF models), which the per-proxy
    ``__torch_function__`` protocol can never see.

    ``device``: where a concrete factory call that names no device puts its
    constant (the module's device), so constants meet the traced tensors on
    the card."""

    # deterministic factories: a call with fully concrete arguments produces
    # a constant.  Keeping it a real torch.Tensor preserves downstream
    # `isinstance(x, torch.Tensor)` branches (HF mask plumbing decides "user
    # supplied a mask" that way) and lets constant mask math run natively
    # once instead of being traced.  RNG factories are not here: they must
    # divert so every compiled call resamples through the port's RNG
    # instead of baking one sample.
    _CONCRETE_FACTORIES = frozenset(
        f for f in (
            getattr(torch, n, None)
            for n in ("ones", "zeros", "full", "arange", "linspace", "eye", "empty")
        ) if f is not None
    )

    def __init__(self, device: torch.device | None = None):
        super().__init__()
        self.device = device

    @staticmethod
    def _any_thunder_arg(args, kwargs) -> bool:
        from thunder_tpu_torch.core import dtypes as ttd
        from thunder_tpu_torch.core.devices import Device as _TDev
        from thunder_tpu_torch.core.proxies import Proxy

        def is_thunder(x):
            return isinstance(x, (Proxy, ttd.dtype, _TDev))

        return any(is_thunder(a) for a in args) or any(is_thunder(v) for v in kwargs.values())

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        from thunder_tpu_torch.core.trace import get_tracectx
        from thunder_tpu_torch.torch import _torch_to_thunder_function_map

        if get_tracectx() is not None:
            mapped = _torch_to_thunder_function_map.get(func)
            if mapped is not None:
                if func in self._CONCRETE_FACTORIES and not self._any_thunder_arg(args, kwargs):
                    if kwargs.get("device") is None and self.device is not None:
                        kwargs["device"] = self.device
                    with torch._C.DisableTorchFunction():
                        return func(*args, **kwargs)
                args, kwargs = _bake_torch_constants(args, kwargs)
                return mapped(*args, **kwargs)
            # unmapped call on real tensors that only carries the port's
            # metadata (e.g. `real.to(dtype=proxy.dtype)` in T5): translate
            # the dtype/device objects to torch's and run natively; the
            # result stays a real-tensor constant
            from thunder_tpu_torch.core import dtypes as ttd
            from thunder_tpu_torch.core.devices import Device as _TDev
            from thunder_tpu_torch.core.proxies import Proxy

            flat_vals = list(args) + list(kwargs.values())
            if any(isinstance(v, (ttd.dtype, _TDev)) for v in flat_vals) and not any(
                isinstance(v, Proxy) for v in flat_vals
            ):
                with torch._C.DisableTorchFunction():
                    return func(
                        *(_translate_thunder_metadata(a) for a in args),
                        **{k: _translate_thunder_metadata(v) for k, v in kwargs.items()},
                    )
        return func(*args, **kwargs)

    # HF transformers builds 4D attention masks by torch.vmap-ing elementwise
    # index predicates (masking_utils._vmap_for_bhqkv); functorch can't batch
    # proxies, but for elementwise predicates vmap is broadcasting, so the
    # mode swaps in a broadcast implementation while tracing.
    @staticmethod
    def _broadcast_bhqkv(mask_function, bh_indices: bool = True):
        if bh_indices:
            def fn(b, h, q, kv):
                return mask_function(
                    b[:, None, None, None],
                    h[None, :, None, None],
                    q[None, None, :, None],
                    kv[None, None, None, :],
                )
        else:
            def fn(q, kv):
                return mask_function(q[:, None], kv[None, :])
        return fn

    # refcounted so nested modes don't restore the originals mid-trace
    _patch_depth = 0
    _patches: list = []

    @staticmethod
    def _tensor_shim(orig):
        # torch.tensor(scalar, dtype=<port dtype>, device=<Device>) in HF mask
        # code: translate the metadata, build the constant through the
        # torch language while a trace is active
        def shim(data, *args, dtype=None, device=None, **kwargs):
            from thunder_tpu_torch.core import dtypes as ttd
            from thunder_tpu_torch.core.trace import get_tracectx

            if get_tracectx() is not None and isinstance(data, (int, float, bool)):
                import thunder_tpu_torch.torch as ltorch

                return ltorch.full((), data, dtype=dtype,
                                   device=None if device is None else device)
            if isinstance(dtype, ttd.dtype):
                dtype = ttd.to_torch_dtype(dtype)
            if dtype is not None:
                kwargs["dtype"] = dtype
            if device is not None:
                kwargs["device"] = _translate_thunder_metadata(device)
            return orig(data, *args, **kwargs)

        return shim

    @staticmethod
    def _tensor_to_shim(orig):
        # real_tensor.to(dtype=<port dtype>) (T5 casts constants to a proxy's
        # dtype): torch's C parser rejects the foreign dtype before any
        # __torch_function__ dispatch, so Tensor.to is patched to translate
        # the port's dtype/Device objects first
        def shim(self_t, *args, **kwargs):
            return orig(
                self_t,
                *(_translate_thunder_metadata(a) for a in args),
                **{k: _translate_thunder_metadata(v) for k, v in kwargs.items()},
            )

        return shim

    @staticmethod
    def _factory_shim(orig):
        # torch.full/zeros/ones/... with dtype=<port dtype> (HF mask code
        # feeds a proxy's .dtype back into a factory): torch's C arg parser
        # rejects the foreign dtype before __torch_function__ dispatch can
        # divert, so these factories are patched to route through the
        # mapped op while a trace is active
        def shim(*args, **kwargs):
            from thunder_tpu_torch.core import dtypes as ttd
            from thunder_tpu_torch.core.devices import Device as _TDev
            from thunder_tpu_torch.core.trace import get_tracectx
            from thunder_tpu_torch.torch import _torch_to_thunder_function_map

            dtype = kwargs.get("dtype")
            if get_tracectx() is not None and isinstance(dtype, ttd.dtype):
                mapped = _torch_to_thunder_function_map.get(orig)
                if mapped is not None:
                    return mapped(*args, **kwargs)
                kwargs["dtype"] = ttd.to_torch_dtype(dtype)
            dev = kwargs.get("device")
            if isinstance(dev, _TDev):
                kwargs["device"] = _translate_thunder_metadata(dev)
            return orig(*args, **kwargs)

        return shim

    _FACTORY_NAMES = ("full", "zeros", "ones", "empty", "arange", "linspace", "eye")

    @staticmethod
    def _finfo_shim(orig):
        # torch.finfo/iinfo reject the port's dtypes at the C arg parser;
        # HF mask code calls torch.finfo(t.dtype).min
        def shim(dtype=None):
            from thunder_tpu_torch.core import dtypes as ttd

            if isinstance(dtype, ttd.dtype):
                dtype = ttd.to_torch_dtype(dtype)
            return orig(dtype) if dtype is not None else orig()

        return shim

    def __enter__(self):
        import sys as _sys

        cls = ThunderTracingMode
        if cls._patch_depth == 0:
            cls._patches = []
            mu = _sys.modules.get("transformers.masking_utils")
            if mu is not None and hasattr(mu, "_vmap_for_bhqkv"):
                cls._patches.append((mu, "_vmap_for_bhqkv", mu._vmap_for_bhqkv))
                mu._vmap_for_bhqkv = self._broadcast_bhqkv
            for name in ("finfo", "iinfo"):
                orig = getattr(torch, name)
                cls._patches.append((torch, name, orig))
                setattr(torch, name, self._finfo_shim(orig))
            cls._patches.append((torch, "tensor", torch.tensor))
            torch.tensor = self._tensor_shim(torch.tensor)
            for name in cls._FACTORY_NAMES:
                orig = getattr(torch, name)
                cls._patches.append((torch, name, orig))
                setattr(torch, name, self._factory_shim(orig))
            cls._patches.append((torch.Tensor, "to", torch.Tensor.to))
            torch.Tensor.to = self._tensor_to_shim(torch.Tensor.to)
            # HF mask utils guard data-dependent branches ("skip the mask if
            # torch.all(mask == 1)") behind torch.jit.is_tracing(); answer
            # True so they take the tracing-safe path instead of forcing a
            # TensorProxy into a Python bool
            cls._patches.append((torch.jit, "is_tracing", torch.jit.is_tracing))
            torch.jit.is_tracing = lambda: True
        cls._patch_depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        cls = ThunderTracingMode
        cls._patch_depth -= 1
        if cls._patch_depth == 0:
            for obj, name, orig in reversed(cls._patches):
                setattr(obj, name, orig)
            cls._patches = []
        return super().__exit__(*exc)


def functional_call(module: torch.nn.Module, params_and_buffers: dict, args: tuple, kwargs: dict):
    """Calls ``module`` with its parameters/buffers swapped for the values in
    ``params_and_buffers`` (dotted names), restoring the originals after.

    The swap goes through the ``_parameters``/``_buffers`` dicts directly so
    the replacement values may be TensorProxies: ``torch.nn.Module.__setattr__``
    would reject non-Parameters, but attribute reads return whatever the
    dicts hold, which is exactly what tracing needs.
    """
    mods = dict(module.named_modules())
    saved: list[tuple[dict, str, Any]] = []
    try:
        swapped: dict[int, Any] = {}  # id(original tensor) → replacement
        for name, value in params_and_buffers.items():
            mod_name, _, attr = name.rpartition(".")
            m = mods[mod_name]
            d = m._parameters if attr in m._parameters else m._buffers
            saved.append((d, attr, d[attr]))
            swapped[id(d[attr])] = value
            d[attr] = value
        # tied weights: named_parameters() deduplicates (e.g. lm_head.weight
        # is wte.weight), so swap any remaining entry that aliases a swapped
        # tensor by identity
        for m in mods.values():
            for d in (m._parameters, m._buffers):
                for attr, t in list(d.items()):
                    rep = swapped.get(id(t))
                    if rep is not None and t is not rep:
                        saved.append((d, attr, t))
                        d[attr] = rep
        return module(*args, **kwargs)
    finally:
        for d, attr, old in saved:
            d[attr] = old


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())


class ThunderFunction(torch.autograd.Function):
    """Stitches a compiled forward/backward pair into torch autograd.

    ``apply(holder, *param_tensors)``: ``holder`` carries the compiled vjp
    runner and the output structure; gradients are returned for the
    parameter tensors in the order given.  The residuals live in the
    pullback, which the backward drops right after it runs (the reference's
    saved-tensor release contract).
    """

    @staticmethod
    def forward(ctx, holder: dict, *param_tensors: torch.Tensor):
        from thunder_tpu_torch.core.pytree import tree_flatten

        out, pullback = holder["run"]()
        flat_out, out_spec = tree_flatten(out)
        ctx._pullback = pullback
        ctx._holder = holder
        holder["out_spec"] = out_spec
        diff = [_is_float(o) for o in flat_out]
        holder["diff"] = diff
        ctx.mark_non_differentiable(*[o for o, d in zip(flat_out, diff)
                                      if not d and isinstance(o, torch.Tensor)])
        return tuple(flat_out)

    @staticmethod
    def backward(ctx, *grad_outputs: torch.Tensor):
        holder = ctx._holder
        cts = [g.contiguous() for g, d in zip(grad_outputs, holder["diff"]) if d]
        grads_dict = ctx._pullback(cts)
        del ctx._pullback  # the residuals die here (memory contract)
        return (None,) + tuple(grads_dict.get(n) for n in holder["param_names"])


class ThunderModule(torch.nn.Module):
    """Wraps a ``torch.nn.Module`` so its forward runs as a compiled
    program while torch autograd keeps working on the outside.

    ``thunder_tpu_torch.jit(module)`` returns one of these (reference
    ``thunder_tpu.torch_interop.ThunderModule``).
    """

    def __init__(self, module: torch.nn.Module, **jit_kwargs):
        super().__init__()
        self._orig_mod = module
        self._jit_kwargs = jit_kwargs
        self._vjp_fn = None  # built lazily
        self._fwd_fn = None  # forward-only compiled path (no-grad inference)
        self._gen_shim = None  # cached GenerationMixin shim instance
        self._out_cls_cell = [None]

    def _make_functional_fwd(self):
        """The functionalized forward both compile paths share: swaps
        params/buffers for proxies, runs under the tracing mode, and unwraps
        HF ModelOutput (an OrderedDict subclass the pytree won't open) to a
        plain dict of present fields, remembering the class in one shared
        cell so forward() rewraps for the caller whichever path traced it."""
        module = self._orig_mod
        out_cls_cell = self._out_cls_cell
        first = next(itertools.chain(module.parameters(), module.buffers()), None)
        device = None if first is None else first.device

        def functional_fwd(params, buffers, *args, **kwargs):
            with ThunderTracingMode(device):
                out = functional_call(module, {**params, **buffers}, args, kwargs)
            if isinstance(out, dict) and type(out) is not dict:
                out_cls_cell[0] = type(out)
                out = {k: v for k, v in out.items() if v is not None}
            return out

        functional_fwd.__name__ = type(module).__name__
        return functional_fwd

    def _get_vjp(self):
        if self._vjp_fn is None:
            import thunder_tpu_torch as ttt

            self._vjp_fn = ttt.vjp(self._make_functional_fwd(), argnums=(0,), **self._jit_kwargs)
        self._last_compiled = self._vjp_fn
        return self._vjp_fn

    def _get_fwd_only(self):
        """Forward-only compiled path for no-grad inference (generate()
        decode loops, eval): no forward/backward split, no residuals."""
        if self._fwd_fn is None:
            import thunder_tpu_torch as ttt

            self._fwd_fn = ttt.jit(self._make_functional_fwd(), **self._jit_kwargs)
        self._last_compiled = self._fwd_fn
        return self._fwd_fn

    def forward(self, *args, **kwargs):
        from thunder_tpu_torch.core.pytree import tree_unflatten

        params = dict(self._orig_mod.named_parameters())
        buffers = dict(self._orig_mod.named_buffers())
        if not torch.is_grad_enabled():
            # inference: the forward-only compiled program, no residuals
            out = self._get_fwd_only()(params, buffers, *args, **kwargs)
        else:
            param_names = sorted(params)
            vjp_fn = self._get_vjp()
            holder = {
                "run": lambda: vjp_fn(params, buffers, *args, **kwargs),
                "param_names": param_names,
            }
            flat_out = ThunderFunction.apply(holder, *(params[n] for n in param_names))
            out = tree_unflatten(list(flat_out), holder["out_spec"])
        out_cls = self._out_cls_cell[0]
        if out_cls is not None and isinstance(out, dict):
            out = out_cls(**out)
        return out

    def generate(self, *args, **kwargs):
        """HF GenerationMixin support: runs the wrapped model's ``generate``
        with the main (decoder) forward dispatched through the compiled
        program (each new sequence length is one compile; repeated lengths
        hit the cache; no-grad forwards take the forward-only path).

        HF's mutating KV caches (``use_cache=True``) don't trace (the
        compiled step is functional), so the cache is disabled: every step
        recomputes the full prefix (``thunder_tpu_torch.serve`` and
        ``models.generate`` are the cached serving paths).  HF resolves
        decoding methods off ``type(self)``, so the call runs on a shim
        instance whose class subclasses the wrapped model's (keeping
        ``_sample``/config plumbing) while ``forward`` routes here; the shim
        shares the wrapped module's state dict for dict."""
        if kwargs.get("use_cache"):
            raise NotImplementedError(
                "generate(use_cache=True) would mutate an HF KV cache inside the "
                "compiled functional forward; pass use_cache=False (full-prefix "
                "recompute) or serve with thunder_tpu_torch.serve (paged KV-cache decode)"
            )
        kwargs["use_cache"] = False
        cls = type(self._orig_mod)
        if not hasattr(cls, "generate"):
            raise AttributeError(f"{cls.__name__} has no generate()")

        if self._gen_shim is None:
            import functools as _ft
            import inspect as _inspect

            tm = self

            def shim_forward(s, *a, **k):
                return ThunderModule.forward(tm, *a, **k)

            # HF validates model kwargs against inspect.signature(forward):
            # carry the wrapped forward's real signature onto the shim
            shim_forward = _ft.wraps(cls.forward)(shim_forward)
            shim_forward.__signature__ = _inspect.signature(cls.forward)
            shim_cls = type(f"Thunder{cls.__name__}", (cls,), {"forward": shim_forward})
            shim = object.__new__(shim_cls)  # share state; skip __init__
            shim.__dict__ = self._orig_mod.__dict__
            self._gen_shim = shim
        return type(self._gen_shim).generate(self._gen_shim, *args, **kwargs)

    def __getattr__(self, name):
        # delegate config/generation_config/prepare_inputs_for_generation/...
        # lookups to the wrapped module (nn.Module.__getattr__ covers
        # registered params/buffers/submodules first)
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(super().__getattr__("_orig_mod"), name)

    # the state dict and the parameters are the wrapped module's
    def state_dict(self, *args, **kwargs):
        return self._orig_mod.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        return self._orig_mod.load_state_dict(*args, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self._orig_mod.named_parameters(*args, **kwargs)

    def parameters(self, *args, **kwargs):
        return self._orig_mod.parameters(*args, **kwargs)
