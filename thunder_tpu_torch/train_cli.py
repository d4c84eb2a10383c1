"""Single-device pretraining CLI of the port.

Counterpart of the root ``train_cli.py`` in its default mode (``--mode
none``): a Llama config from the zoo, random weights from seed 0, one fixed
batch drawn from seeds 1 and 2, AdamW (optax's defaults) through
``make_train_step`` for ``--steps`` steps after a first one, then a JSON
summary line.  With ``--checkpoint-every``/``--resume`` the steps run in the
elastic loop with async atomic checkpoints.  Examples::

    python -m thunder_tpu_torch.train_cli --config tiny-llama-debug --steps 20 --device cpu
    python -m thunder_tpu_torch.train_cli --config Llama-3-8B --batch 1 --seq 2048 \\
        --dtype bfloat16 --remat full_block --steps 4          # one H100

``--device`` defaults to ``cuda`` and raises without a card unless
``cpu`` is passed.  Every other mode (``ddp``, ``fsdp``, ``zero3``,
``tp_fsdp``, ``sp``, ``pp``, ``ep``) and the options that need them or the
trace IR (``--fused-ce``, ``--quant``, ``--comm-combine-mb``, ``--sp-impl``,
``--bucket``, ``--devices``, ``--virtual-cpu``, ``--overlap``,
``--overlap-bucket-mb``, ``--telemetry``, ``--telemetry-grad-norm``) are not
ported and raise ``NotImplementedError`` naming themselves.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from thunder_tpu_torch._device import resolve_device
from thunder_tpu_torch.distributed.api import make_train_step
from thunder_tpu_torch.models.llama import (
    Config,
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


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _refuse_unported(args) -> None:
    if args.mode != "none":
        raise NotImplementedError(f"--mode {args.mode} is not ported (the port trains on one "
                                  "device: --mode none)")
    for flag, value, default in (
            ("--fused-ce", args.fused_ce, False), ("--quant", args.quant, None),
            ("--comm-combine-mb", args.comm_combine_mb, None), ("--sp-impl", args.sp_impl, None),
            ("--bucket", args.bucket, False), ("--devices", args.devices, 1),
            ("--virtual-cpu", args.virtual_cpu, False), ("--overlap", args.overlap, False),
            ("--overlap-bucket-mb", args.overlap_bucket_mb, None),
            ("--telemetry", args.telemetry, None),
            ("--telemetry-grad-norm", args.telemetry_grad_norm, False)):
        if value != default:
            raise NotImplementedError(f"{flag} is not ported")


def main(argv=None):
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
    # the reference's other options: accepted so that they raise by name
    ap.add_argument("--fused-ce", action="store_true")
    ap.add_argument("--quant", default=None, choices=["int8", "fp8"])
    ap.add_argument("--comm-combine-mb", type=float, default=None)
    ap.add_argument("--sp-impl", default=None, choices=["ring", "ulysses"])
    ap.add_argument("--bucket", action="store_true")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--virtual-cpu", action="store_true")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--overlap-bucket-mb", type=float, default=None)
    ap.add_argument("--telemetry", default=None)
    ap.add_argument("--telemetry-grad-norm", action="store_true")
    args = ap.parse_args(argv)
    _refuse_unported(args)

    dev = resolve_device(args.device)
    cfg = Config.from_name(args.config)
    T = args.seq or min(cfg.block_size, 128)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), dtype=dtype,
                         device=dev)
    log(f"config={cfg.name} n_layer={cfg.n_layer} n_embd={cfg.n_embd} "
        f"params={param_count(params) / 1e6:.1f}M B={args.batch} T={T} mode={args.mode} "
        f"device={dev} dtype={args.dtype}")
    gen = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randint(0, cfg.vocab_size, (args.batch, T), generator=gen, device=dev)
    gen.manual_seed(2)
    tgt = torch.randint(0, cfg.vocab_size, (args.batch, T), generator=gen, device=dev)
    cos, sin = build_rope_cache(cfg, T, device=dev)

    def loss_fn(p, i, t, c, s):
        return gpt_loss(p, i, t, c, s, cfg)

    remat_arg = ({"on": True, "off": False, "auto": "auto"}.get(args.remat, args.remat)
                 if args.remat else not args.no_remat)
    step = make_train_step(loss_fn, adamw(args.lr), remat=remat_arg,
                           accum_steps=args.accum_steps)
    opt_state = step.init_optimizer_state(params)

    elastic = args.checkpoint_every > 0 or args.resume
    if elastic and not args.checkpoint_dir:
        raise ValueError("--checkpoint-every/--resume need --checkpoint-dir")
    if elastic and args.accum != 1:
        raise ValueError("--checkpoint-every composes with --accum-steps, not --accum")
    micro = None
    if args.accum > 1:
        mb = args.batch // args.accum
        micro = [(idx[k * mb:(k + 1) * mb], tgt[k * mb:(k + 1) * mb], cos, sin)
                 for k in range(args.accum)]

    def one_step(p, o):
        if micro is not None:
            return step.accumulate(p, o, micro)
        return step(p, o, idx, tgt, cos, sin)

    t0 = time.perf_counter()
    if not elastic:
        # the elastic loop runs every step itself, so a resumed run replays
        # the same step sequence
        params, opt_state, loss = one_step(params, opt_state)
        log(f"first step: {time.perf_counter() - t0:.1f}s loss={float(loss):.4f}")

    t0 = time.perf_counter()
    restarts = resumed_from = None
    if elastic:
        train_config = {"config": cfg.name, "mode": args.mode, "devices": args.devices,
                        "batch": args.batch, "seq": T, "dtype": args.dtype,
                        "accum_steps": args.accum_steps, "lr": args.lr}
        start_step = 0
        if args.resume:
            got = restore_latest(args.checkpoint_dir, {"params": params, "opt_state": opt_state},
                                 config=train_config)
            if got is not None:
                start_step, state = got
                params, opt_state = state["params"], state["opt_state"]
                log(f"resumed from committed checkpoint step {start_step}")
            else:
                log("no committed checkpoint found; starting from scratch")
        resumed_from = start_step if args.resume else None
        with AsyncCheckpointer(args.checkpoint_dir, config=train_config) as ck:
            res = train_loop(step, params, opt_state, lambda s: (idx, tgt, cos, sin),
                             steps=args.steps, start_step=start_step, checkpointer=ck,
                             checkpoint_every=args.checkpoint_every)
        params, opt_state = res.params, res.opt_state
        last = res.losses[-1] if res.losses and res.losses[-1] is not None else float("nan")
        restarts = res.restarts
        steps_done = max(args.steps - start_step, 1)
        last = float(last)
    else:
        last = loss
        for _ in range(args.steps):
            params, opt_state, last = one_step(params, opt_state)
        last = float(last)              # waits for the device
        steps_done = max(args.steps, 1)
    dt = time.perf_counter() - t0
    tps = args.batch * T * steps_done / dt

    if args.checkpoint_dir and not elastic:
        save_checkpoint_atomic(args.checkpoint_dir, {"params": params, "opt_state": opt_state},
                               step=args.steps)
        log(f"checkpoint saved to {args.checkpoint_dir}")

    print(json.dumps({
        "config": cfg.name, "mode": args.mode, "devices": args.devices, "device": str(dev),
        "accum_steps": args.accum_steps,
        "remat": args.remat or ("off" if args.no_remat else "on"),
        "checkpoint_every": args.checkpoint_every,
        "resumed_from": resumed_from, "restarts": restarts,
        "tokens_per_sec": round(tps, 1), "ms_per_step": round(dt / steps_done * 1e3, 2),
        "final_loss": round(last, 4),
    }))


if __name__ == "__main__":
    main()
