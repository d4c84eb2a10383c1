"""Pretraining CLI of the port.

Counterpart of the root ``train_cli.py``: a Llama config from the zoo,
random weights from seed 0, one fixed global batch drawn from seeds 1 and
2, AdamW (optax's defaults) through ``make_train_step`` for ``--steps``
steps after a first one, then a JSON summary line.  With
``--checkpoint-every``/``--resume`` the steps run in the elastic loop with
async atomic checkpoints (``--mode none``).  Examples::

    python -m thunder_tpu_torch.train_cli --config tiny-llama-debug --steps 20 --device cpu
    python -m thunder_tpu_torch.train_cli --config Llama-3-8B --batch 1 --seq 2048 \\
        --dtype bfloat16 --remat full_block --steps 4          # one H100
    python -m thunder_tpu_torch.train_cli --mode zero3 --devices 2 --device cpu --overlap-bucket-mb 1
    torchrun --nproc-per-node 4 -m thunder_tpu_torch.train_cli --mode fsdp --batch 8   # 4 cards

Modes map to the distributed API: ``none`` (one device), ``ddp``
(replicated params, ``--overlap`` for bucketed asynchronous grad
all-reduces), ``fsdp`` (ZeRO-2), ``zero3`` (re-gather in the backward),
``tp_fsdp`` (the Megatron rules at ``tp`` = 1).  ``--devices N`` starts N
ranks (gloo on the CPU with ``--device cpu`` or ``--virtual-cpu``, NCCL
over the first N cards with ``--device cuda``, never more ranks than
cards); under torchrun the CLI joins the given world instead.  Each rank
builds the same params and batch from the seeds and trains its slice; rank
0 prints the summary.  ``--quant int8|fp8`` runs the forward's linears and
matmuls quantized with full-precision grads, ``--fused-ce`` fuses the head
with the loss (``Config.fused_head_ce``), ``--bucket`` pads batches to
power-of-two shapes, ``--comm-combine-mb`` coalesces the sharded step's
collectives, ``--telemetry PATH`` writes one JSON line per step (with
``--telemetry-grad-norm`` the global grad norm too).  ``--device`` defaults
to ``cuda`` and raises without a card unless ``cpu`` is passed.  The modes
``sp``, ``pp`` and ``ep`` and ``--sp-impl`` are later slices and raise
``NotImplementedError`` naming themselves.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.distributed.api import make_train_step
from thunder_tpu_torch.models.llama import (
    Config,
    batch_bucketer,
    build_rope_cache,
    gpt_loss,
    init_params,
    param_count,
)
from thunder_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    restore_latest,
    save_checkpoint_atomic,
)
from thunder_tpu_torch.train.loop import train_loop
from thunder_tpu_torch.train.optim import adamw

MODES = ["none", "ddp", "fsdp", "zero3", "tp_fsdp", "sp", "pp", "ep"]
_LATER = ("a later slice of the port: sequence, pipeline and expert parallelism "
          "(ROADMAP.md Queue 1 item 12)")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _refuse_unported(args) -> None:
    if args.mode in ("sp", "pp", "ep"):
        raise NotImplementedError(f"--mode {args.mode} is not ported: {_LATER}")
    if args.sp_impl is not None:
        raise NotImplementedError(f"--sp-impl is not ported: {_LATER}")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="tiny-llama-debug", help="model config name")
    ap.add_argument("--mode", default="none", choices=MODES)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: min(block_size, 128))")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1,
                    help="host-loop gradient accumulation (k grads calls per optimizer step)")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="in-step gradient accumulation over k microbatches (f32 accumulator)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat", default=None,
                    choices=["on", "off", "auto", "none", "attention", "full_block"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--quant", default=None, choices=["int8", "fp8"],
                    help="quantized training: int8/fp8(e4m3) forward GEMMs, full-precision grads")
    ap.add_argument("--fused-ce", action="store_true",
                    help="fuse the lm-head matmul into a chunked-vocab cross-entropy")
    ap.add_argument("--comm-combine-mb", type=float, default=None,
                    help="bucket cap in MiB that coalesces the sharded step's collectives")
    ap.add_argument("--sp-impl", default=None, choices=["ring", "ulysses"])
    ap.add_argument("--bucket", action="store_true",
                    help="pad batches to power-of-two (B, T) buckets")
    ap.add_argument("--devices", type=int, default=1, help="ranks to start (one per device)")
    ap.add_argument("--virtual-cpu", action="store_true",
                    help="the --devices ranks run on the CPU (gloo)")
    ap.add_argument("--overlap", action="store_true",
                    help="bucketed asynchronous grad all-reduces overlapping the backward (ddp)")
    ap.add_argument("--overlap-bucket-mb", type=float, default=None,
                    help="gradient bucket cap in MiB for --overlap (default 4)")
    ap.add_argument("--telemetry", default=None, help="per-step JSONL telemetry path")
    ap.add_argument("--telemetry-grad-norm", action="store_true",
                    help="also log the global grad norm each step (one extra grads step)")
    return ap


def _mesh_and_params(args, params):
    """The mode's mesh over every rank and the params placed on it."""
    from thunder_tpu_torch import distributed as dist

    n = torch.distributed.get_world_size()
    if args.mode == "ddp":
        mesh = dist.make_mesh({"dp": n})
        return mesh, dist.ddp(params, mesh)
    if args.mode in ("fsdp", "zero3"):
        mesh = dist.make_mesh({"fsdp": n})
        return mesh, dist.fsdp(params, mesh)
    mesh = dist.make_mesh({"fsdp": n, "tp": 1})
    return mesh, dist.tp_fsdp(params, mesh)


def _grad_norm(grads) -> float:
    """The global L2 norm of a (placed) grad tree."""
    from torch.distributed.tensor import DTensor

    from thunder_tpu_torch._tree import tree_leaves

    total = 0.0
    for g in tree_leaves(grads):
        sq = (g.float() ** 2).sum()
        total += float(sq.full_tensor() if isinstance(sq, DTensor) else sq)
    return math.sqrt(total)


def train(args) -> dict:
    """Runs the configured training on this process (one rank of the world
    when a process group is up) and returns the summary."""
    dist_on = torch.distributed.is_available() and torch.distributed.is_initialized()
    rank = torch.distributed.get_rank() if dist_on else 0
    world = torch.distributed.get_world_size() if dist_on else 1
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dist_on:
        dev = torch.device("cuda", torch.cuda.current_device())
    say = log if rank == 0 else (lambda *a: None)
    cfg = Config.from_name(args.config, **({"fused_head_ce": True} if args.fused_ce else {}))
    T = args.seq or min(cfg.block_size, 128)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), dtype=dtype,
                         device=dev)
    say(f"config={cfg.name} n_layer={cfg.n_layer} n_embd={cfg.n_embd} "
        f"params={param_count(params) / 1e6:.1f}M B={args.batch} T={T} mode={args.mode} "
        f"devices={world} device={dev} dtype={args.dtype}")
    gen = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randint(0, cfg.vocab_size, (args.batch, T), generator=gen, device=dev)
    gen.manual_seed(2)
    tgt = torch.randint(0, cfg.vocab_size, (args.batch, T), generator=gen, device=dev)
    cos, sin = build_rope_cache(cfg, T, device=dev)
    mesh = None
    if args.mode != "none":
        mesh, params = _mesh_and_params(args, params)

    def loss_fn(p, i, t, c, s):
        return gpt_loss(p, i, t, c, s, cfg)

    remat_arg = ({"on": True, "off": False, "auto": "auto"}.get(args.remat, args.remat)
                 if args.remat else not args.no_remat)
    step = make_train_step(
        loss_fn, adamw(args.lr), mesh, remat=remat_arg, accum_steps=args.accum_steps,
        quant=args.quant, zero3=args.mode == "zero3", overlap=args.overlap,
        overlap_bucket_mb=4.0 if args.overlap_bucket_mb is None else args.overlap_bucket_mb,
        comm_combine_threshold_mb=args.comm_combine_mb,
        bucketer=batch_bucketer(cfg) if args.bucket else None)
    opt_state = step.init_optimizer_state(params)

    elastic = args.checkpoint_every > 0 or args.resume
    if elastic and not args.checkpoint_dir:
        raise ValueError("--checkpoint-every/--resume need --checkpoint-dir")
    if elastic and args.accum != 1:
        raise ValueError("--checkpoint-every composes with --accum-steps, not --accum")
    if elastic and mesh is not None:
        raise NotImplementedError("--checkpoint-every/--resume run the single-device elastic "
                                  "loop (--mode none); a sharded run saves at its end with "
                                  "--checkpoint-dir")
    micro = None
    if args.accum > 1:
        mb = args.batch // args.accum
        micro = [(idx[k * mb:(k + 1) * mb], tgt[k * mb:(k + 1) * mb], cos, sin)
                 for k in range(args.accum)]

    def one_step(p, o):
        if micro is not None:
            return step.accumulate(p, o, micro)
        return step(p, o, idx, tgt, cos, sin)

    losses = []
    collectives = None
    t0 = time.perf_counter()
    if not elastic:
        # the elastic loop runs every step itself, so a resumed run replays
        # the same step sequence
        params, opt_state, loss = one_step(params, opt_state)
        losses.append(float(loss))
        say(f"first step: {time.perf_counter() - t0:.1f}s loss={losses[-1]:.4f}")

    telemetry = peak_bytes = None
    if args.telemetry:
        from thunder_tpu_torch.observability.telemetry import StepLogger, trace_peak_bytes

        if step.fw_trace is not None:
            peak_bytes = max(trace_peak_bytes(step.fw_trace), trace_peak_bytes(step.bw_trace))
        if rank == 0:
            telemetry = StepLogger(args.telemetry, meta={
                "config": cfg.name, "mode": args.mode, "devices": world, "batch": args.batch,
                "seq": T, "dtype": args.dtype, "accum": args.accum, "quant": args.quant,
                "accum_steps": args.accum_steps,
                "remat": args.remat or ("off" if args.no_remat else "on"),
                "overlap": bool(args.overlap), "overlap_bucket_mb": args.overlap_bucket_mb,
                "checkpoint_dir": args.checkpoint_dir, "checkpoint_every": args.checkpoint_every,
                "resume": bool(args.resume),
                "mesh_axes": {} if mesh is None else dict(zip(mesh.mesh_dim_names,
                                                              mesh.mesh.shape)),
                "lr": args.lr})
        say(f"telemetry -> {args.telemetry} (peak_bytes_estimate={peak_bytes})")

    t0 = time.perf_counter()
    restarts = resumed_from = None
    if elastic:
        train_config = {"config": cfg.name, "mode": args.mode, "devices": world,
                        "batch": args.batch, "seq": T, "dtype": args.dtype,
                        "accum_steps": args.accum_steps, "lr": args.lr}
        start_step = 0
        if args.resume:
            got = restore_latest(args.checkpoint_dir, {"params": params, "opt_state": opt_state},
                                 config=train_config)
            if got is not None:
                start_step, state = got
                params, opt_state = state["params"], state["opt_state"]
                say(f"resumed from committed checkpoint step {start_step}")
            else:
                say("no committed checkpoint found; starting from scratch")
        resumed_from = start_step if args.resume else None
        t_prev = [time.perf_counter()]

        def on_step(s, loss_s):
            now = time.perf_counter()
            if telemetry is not None:
                telemetry.log_step(s, loss=float(loss_s), step_time_s=now - t_prev[0],
                                   tokens=args.batch * T, peak_bytes=peak_bytes)
            t_prev[0] = now

        with AsyncCheckpointer(args.checkpoint_dir, config=train_config) as ck:
            res = train_loop(step, params, opt_state, lambda s: (idx, tgt, cos, sin),
                             steps=args.steps, start_step=start_step, checkpointer=ck,
                             checkpoint_every=args.checkpoint_every, on_step=on_step)
        params, opt_state = res.params, res.opt_state
        losses = [float(x) for x in res.losses if x is not None]
        restarts = res.restarts
        steps_done = max(args.steps - start_step, 1)
    else:
        for k in range(args.steps):
            t_step = time.perf_counter()
            params, opt_state, last = one_step(params, opt_state)
            losses.append(float(last))              # waits for the device
            collectives = step.collectives
            if args.telemetry:
                gn = None
                if args.telemetry_grad_norm and args.accum == 1:
                    gn = _grad_norm(step.grads(params, opt_state, idx, tgt, cos, sin)[1])
                if telemetry is not None:
                    telemetry.log_step(k, loss=losses[-1], grad_norm=gn,
                                       step_time_s=time.perf_counter() - t_step,
                                       tokens=args.batch * T, peak_bytes=peak_bytes)
        steps_done = max(args.steps, 1)
    dt = time.perf_counter() - t0
    if telemetry is not None:
        telemetry.close()
    tps = args.batch * T * steps_done / dt
    last = losses[-1] if losses else float("nan")

    if args.checkpoint_dir and not elastic:
        state = {"params": params, "opt_state": opt_state}
        if mesh is None:
            save_checkpoint_atomic(args.checkpoint_dir, state, step=args.steps)
        else:
            from thunder_tpu_torch.distributed.checkpoint import save_checkpoint

            save_checkpoint(args.checkpoint_dir, state, step=args.steps)
        say(f"checkpoint saved to {args.checkpoint_dir}")

    return {
        "config": cfg.name, "mode": args.mode, "devices": world, "device": str(dev),
        "quant": args.quant, "fused_ce": bool(args.fused_ce), "accum_steps": args.accum_steps,
        "remat": args.remat or ("off" if args.no_remat else "on"), "overlap": bool(args.overlap),
        "checkpoint_every": args.checkpoint_every,
        "resumed_from": resumed_from, "restarts": restarts,
        "collectives": collectives, "losses": [round(x, 6) for x in losses],
        "tokens_per_sec": round(tps, 1), "ms_per_step": round(dt / steps_done * 1e3, 2),
        "final_loss": round(last, 4),
    }


def _rank_main(rank: int, world: int, argv: list) -> dict:
    """One spawned rank of ``--devices N``."""
    return train(_parser().parse_args(argv))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if args.virtual_cpu:
        args.device = "cpu"
        argv = [*argv, "--device", "cpu"]
    if args.mode == "none":
        if args.devices != 1:
            raise ValueError("--mode none trains on one device; --devices N needs a "
                             "distributed mode (ddp, fsdp, zero3, tp_fsdp)")
        summary = train(args)
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        # torchrun: this process is one rank of the given world
        from thunder_tpu_torch.distributed.multihost import initialize

        initialize(backend="nccl" if torch.device(args.device).type == "cuda" else "gloo")
        summary = train(args)
        if torch.distributed.get_rank() != 0:
            return
    else:
        from thunder_tpu_torch.distributed.launch import launch

        cpu = torch.device(args.device).type == "cpu"
        summary = launch(_rank_main, args.devices, args=(argv,), device=args.device,
                         threads=1 if cpu else None, timeout_s=3600)[0]
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
