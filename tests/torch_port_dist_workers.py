"""What the ranks of the port's multi-rank CPU tests run.

The tests spawn one gloo world per file (``thunder_tpu_torch.distributed.
launch``); each rank imports this module, which imports torch and the port
only, never JAX: the JAX side of each comparison runs in the test process.
Every entry takes ``(rank, world, ...)`` and returns plain tensors and
numbers, which the launcher hands back to the test.  World-4 cases run on
meshes over all four ranks; world-2 cases on the half of a ``(2, 2)`` mesh
a rank belongs to (both halves compute the same thing).
"""
from __future__ import annotations

import torch

import thunder_tpu_torch as ttt
from thunder_tpu_torch import distributed as D
from thunder_tpu_torch._tree import tree_flatten, tree_leaves
from thunder_tpu_torch.distributed import prims as dp
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import llama

SUM, MEAN = dp.DistributedReduceOps.SUM, dp.DistributedReduceOps.MEAN


def half_mesh(name: str):
    """A 1-D mesh ``{name: 2}`` over this rank's half of a world of 4."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", [[0, 1], [2, 3]], mesh_dim_names=("_half", name))[name]


#
# The collective prims (test_torch_port_dist_prims.py)
#

def prim_cases(n: int) -> dict:
    """``name -> (fn(x, ct) -> outputs, local input shape, tuple output)``
    over mesh axis ``"x"`` of size ``n``; the cases of
    ``tests/test_distributed.py:56-91`` and the rest of the prims."""
    perm = [[i, (i + 1) % n] for i in range(n)]
    return {
        "all_gather": (lambda x: dp.all_gather(x, "x", n, 0, True), (2, 3)),
        "all_gather_dim1": (lambda x: dp.all_gather(x, "x", n, 1, True), (2, 3)),
        "all_gather_untiled": (lambda x: dp.all_gather(x, "x", n, 0, False), (2, 3)),
        "all_reduce_sum": (lambda x: dp.all_reduce(x, "x", SUM), (2, 3)),
        "all_reduce_mean": (lambda x: dp.all_reduce(x, "x", MEAN), (2, 3)),
        "all_reduce_tuple": (lambda x: dp.all_reduce((x, x[:, :2] * 3.0), "x", SUM), (2, 3)),
        "reduce_scatter_sum": (lambda x: dp.reduce_scatter(x, "x", n, 0, SUM), (2 * n, 3)),
        "reduce_scatter_mean": (lambda x: dp.reduce_scatter(x, "x", n, 0, MEAN), (2 * n, 3)),
        "broadcast": (lambda x: dp.broadcast(x, "x", n - 1), (2, 3)),
        "ppermute": (lambda x: dp.ppermute(x, "x", perm), (2, 3)),
        "all_to_all": (lambda x: dp.all_to_all(x, "x", n, 0, 1), (2 * n, 3)),
        "synchronize_sharded": (lambda x: dp.synchronize(x, "x", n, True, 0), (2, 3)),
        "synchronize_replicated": (lambda x: dp.synchronize(x, "x", n, False), (2, 3)),
    }


def _prim_run(fn, x, ct):
    """``(outputs, grad)``: the traced prim's value and its VJP of ``ct``
    through the port's ``value_and_grad`` (the loss ``Σ out·ct``)."""
    outs = {}

    def loss(x, ct):
        out = fn(x)
        outs["v"] = out
        parts = out if isinstance(out, tuple) else (out,)
        cts = ct if isinstance(ct, tuple) else (ct,)
        return sum((o * c).sum() for o, c in zip(parts, cts))

    value = ttt.jit(lambda x: fn(x))(x)
    _, grad = ttt.value_and_grad(loss, argnums=0)(x, ct)
    return value, grad


def prims_world(rank: int, world: int, xs: dict, cts: dict) -> dict:
    """Each prim case at world 4 and 2, forward and VJP: ``{(n, case):
    (this rank's outputs, its grad)}``, plus the axis index."""
    from torch.distributed.device_mesh import DeviceMesh

    out = {}
    for n, mesh in ((4, DeviceMesh("cpu", list(range(4)), mesh_dim_names=("x",))),
                    (2, half_mesh("x"))):
        me = mesh.get_coordinate()[0]
        with cudaex.mesh_context(mesh):
            for name, (fn, _) in prim_cases(n).items():
                x = torch.as_tensor(xs[(n, name)][me])
                ct = cts[(n, name)]
                ct = tuple(torch.as_tensor(c[me]) for c in ct) if isinstance(ct, tuple) \
                    else torch.as_tensor(ct[me])
                out[(n, name)] = _prim_run(fn, x, ct)
            out[(n, "axis_index")] = int(ttt.jit(lambda: dp.axis_index("x"))())
    return out


def placements_world(rank: int, world: int, params, batch) -> dict:
    """The specs of ``ddp_shardings``, ``fsdp_shardings(min_size=64)`` and
    ``llama_shardings`` on four meshes, this rank's shards of the placed
    params, and the default batch specs."""
    from thunder_tpu_torch.distributed.sharding import kv_cache_spec, mesh_shape

    out = {}
    for axes in ({"dp": 4}, {"fsdp": 4}, {"dp": 2, "fsdp": 2}, {"fsdp": 2, "tp": 2}):
        mesh = D.make_mesh(axes)
        key = tuple(axes.items())
        specs = {"ddp": D.ddp_shardings(params, mesh), "llama": D.llama_shardings(params, mesh)}
        if "fsdp" in axes:             # the rule reads the size of its axis
            specs["fsdp"] = D.fsdp_shardings(params, mesh, min_size=64)
        out[key] = {k: [tuple(s) for s in tree_flatten(v)[0]] for k, v in specs.items()}
        out[key]["batch"] = [tuple(s) for s in D.default_batch_shardings(mesh, batch)]
        out[key]["batch_spec"] = tuple(D.batch_spec(mesh))
        out[key]["kv"] = tuple(kv_cache_spec(llama.Config.from_name("tiny-llama-debug"), mesh))
        out[key]["shape"] = mesh_shape(mesh)
        if "tp" not in axes and "fsdp" in axes:
            out[key]["shards"] = {
                k: [x.to_local().clone() for x in tree_leaves(placer(params, mesh))]
                for k, placer in (("fsdp", lambda p, m: D.fsdp(p, m, min_size=64)),
                                  ("llama", D.tp_fsdp))}
    return out


def prims_and_placements(rank: int, world: int, xs, cts, params, batch) -> dict:
    """The world of ``tests/test_torch_port_dist_prims.py``."""
    return dict(prims=prims_world(rank, world, xs, cts),
                placements=placements_world(rank, world, params, batch))


#
# The sharded train steps (test_torch_port_dist_train.py)
#

def _loss_fn(cfg):
    return lambda p, i, t, c, s: llama.gpt_loss(p, i, t, c, s, cfg)


def _full(tree):
    return D.full_state_dict(tree)


def _run(step, params, batch, steps: int) -> dict:
    """The grads at the start, then ``steps`` steps: each step's loss,
    collectives and (full) params."""
    opt = step.init_optimizer_state(params)
    grads = _full(step.grads(params, opt, *batch)[1])
    losses, collectives, trail = [], [], []
    for _ in range(steps):
        params, opt, loss = step(params, opt, *batch)
        losses.append(float(loss))
        collectives.append(dict(step.collectives))
        trail.append(_full(params))
    return dict(losses=losses, params=trail, grads=grads, collectives=collectives, opt=opt,
                placed=params, overlap=step.overlap_report)


def _region_keys(step) -> list:
    return sorted(repr(b._call_ctx[b.sym.name].key) for tr in (step.fw_trace, step.bw_trace)
                  for b in tr.bound_symbols if b.sym.is_fusion)


def _sharded_like(params, opt) -> bool:
    """Every moment of a sharded param is placed as the param is."""
    ps = tree_leaves(params)
    return all(m.placements == p.placements and tuple(m.to_local().shape) ==
               tuple(p.to_local().shape) for k in ("mu", "nu") for m, p in
               zip(tree_leaves(opt[k]), ps))


PORT_STEP_CASES = ("ddp", "zero2", "zero3", "zero3_w2", "ddp_w2", "combined")


def train_world(rank: int, world: int, params, batch, lr: float, steps: int,
                ckpt_dir: str) -> dict:
    """Every sharded-step case of the train test on one world of 4."""
    cfg = llama.Config.from_name("tiny-llama-debug")
    loss_fn = _loss_fn(cfg)
    kept = [x.clone() for x in tree_leaves(params)]
    out = {}

    def case(name, mesh, place, **kw):
        step = D.make_train_step(loss_fn, ttt.adamw(lr), mesh, **kw)
        got = _run(step, place(params, mesh), batch, steps)
        got["mesh"], got["step"] = mesh, step
        got["regions"] = _region_keys(step)
        got["programs"] = {n: [b.sym.name for b in tr.bound_symbols].count(n)
                           for tr in (step.fw_trace, step.bw_trace)
                           for n in ("torch_synchronize", "torch_all_reduce",
                                     "torch_reduce_scatter", "torch_wait")}
        out[name] = got
        return got

    fsdp64 = lambda p, m: D.fsdp(p, m, min_size=64)
    ddp = case("ddp", D.make_mesh({"dp": 4}), D.ddp, overlap=True, overlap_bucket_mb=0.05,
               remat="full_block")
    zero2 = case("zero2", D.make_mesh({"fsdp": 4}), fsdp64)
    case("zero3", D.make_mesh({"dp": 2, "fsdp": 2}), fsdp64, zero3=True)
    case("zero3_w2", half_mesh("fsdp"), fsdp64, zero3=True)
    case("ddp_w2", half_mesh("dp"), D.ddp)
    case("combined", D.make_mesh({"dp": 2, "fsdp": 2}), fsdp64, comm_combine_threshold_mb=0.02)
    out["zero2_state_sharded"] = _sharded_like(zero2["placed"], zero2["opt"])
    # the programs get each shard's own tensor, not DTensor's view of it
    from thunder_tpu_torch.distributed.api import _local

    out["locals_not_views"] = all(_local(x)._base is None and _local(x).data_ptr() ==
                                  x.to_local().data_ptr() for x in tree_leaves(zero2["placed"]))
    out["ddp_state_replicated"] = all(all(pl.is_replicate() for pl in m.placements)
                                      for m in tree_leaves(ddp["opt"]["mu"]))
    for k in PORT_STEP_CASES:
        del out[k]["opt"], out[k]["placed"]
    out["not_aliased"] = all(torch.equal(a, b) for a, b in zip(kept, tree_leaves(params)))

    # no_sync / accumulate over two micro batches against one step on both
    mesh = D.make_mesh({"dp": 4})
    halves = [tuple(b[i * 4:(i + 1) * 4] if b.shape[0] == 8 else b for b in batch)
              for i in range(2)]
    step = D.make_train_step(loss_fn, ttt.adamw(lr), mesh)
    p_big = D.ddp(params, mesh)
    p_big, _, big_loss = step(p_big, step.init_optimizer_state(p_big), *batch)
    p_acc = D.ddp(params, mesh)
    p_acc, _, acc_loss = step.accumulate(p_acc, step.init_optimizer_state(p_acc), halves)
    p_ns = D.ddp(params, mesh)
    o_ns = step.init_optimizer_state(p_ns)
    with step.no_sync() as micro:
        grads = [micro(p_ns, o_ns, *h)[1] for h in halves]
    grads = [(a + b) / 2 for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1]))]
    p_ns, _ = step.apply_gradients(p_ns, o_ns, grads)
    out["accum"] = dict(big=(float(big_loss), _full(p_big)), acc=(float(acc_loss), _full(p_acc)),
                        no_sync=_full(p_ns))

    # the micro batches' shape built a second program; the bucketer maps
    # two shapes to one
    bstep = D.make_train_step(loss_fn, ttt.adamw(lr), mesh, bucketer=llama.batch_bucketer(cfg))
    pb = D.ddp(params, mesh)
    ob = bstep.init_optimizer_state(pb)
    for t in (12, 14):
        cut = tuple(b[:, :t] if b.ndim == 2 and b.shape[0] == 8 else b[:t] for b in batch)
        bstep(pb, ob, *cut)
    out["builds"] = dict(plain=len(step._built), bucketed=len(bstep._built))

    # tensor parallelism is the next slice
    refused = []
    tp_mesh = D.make_mesh({"fsdp": 2, "tp": 2})
    for call in (lambda: D.tp_fsdp(params, tp_mesh),
                 lambda: D.make_train_step(loss_fn, ttt.adamw(lr), tp_mesh)):
        try:
            call()
        except NotImplementedError as e:
            refused.append(str(e))
    out["tp_refused"] = refused

    # a checkpoint saved on {"fsdp": 4}, loaded on {"dp": 2, "fsdp": 2}
    m4, step = zero2["mesh"], zero2["step"]
    p4 = fsdp64(params, m4)
    o4 = step.init_optimizer_state(p4)
    p4, o4, _ = step(p4, o4, *batch)
    D.save_checkpoint(ckpt_dir, {"params": p4, "opt_state": o4, "n": 7}, step=1)
    m22 = D.make_mesh({"dp": 2, "fsdp": 2})
    tmpl_p = fsdp64(params, m22)
    tmpl = {"params": tmpl_p, "opt_state": D.make_train_step(
        loss_fn, ttt.adamw(lr), m22).init_optimizer_state(tmpl_p), "n": 0}
    got = D.load_checkpoint(ckpt_dir, tmpl, step=1)
    same_place = all(a.placements == b.placements and a.device_mesh is b.device_mesh
                     for a, b in zip(tree_leaves(got["params"]), tree_leaves(tmpl["params"])))
    out["ckpt"] = dict(saved=_full({"params": p4, "opt_state": o4}),
                       loaded=_full({"params": got["params"], "opt_state": got["opt_state"]}),
                       n=got["n"], same_place=same_place,
                       template_untouched=all(torch.equal(a, b) for a, b in zip(
                           tree_leaves(_full(tmpl_p)), tree_leaves(_full(fsdp64(params, m22))))),
                       latest=D.latest_step(ckpt_dir))
    for k in PORT_STEP_CASES:
        del out[k]["mesh"], out[k]["step"]
    return out


def single_device_regions(params, batch, lr) -> list:
    """Region structures of the single-device step on a rank's slice (B/4),
    for the comparison with the DDP step's (both ``full_block``, phase
    20's policy: its cones reach the params)."""
    cfg = llama.Config.from_name("tiny-llama-debug")
    step = ttt.make_train_step(_loss_fn(cfg), ttt.adamw(lr), remat="full_block")
    local = tuple(b[:2] if b.shape[0] == 8 else b for b in batch)
    step(tree_map_clone(params), step.init_optimizer_state(tree_map_clone(params)), *local)
    return _region_keys(step)


def tree_map_clone(tree):
    from thunder_tpu_torch._tree import tree_map

    return tree_map(lambda x: x.clone(), tree)
