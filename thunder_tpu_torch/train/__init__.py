"""Training orchestration of the port (counterpart of ``thunder_tpu/train``).

- :mod:`~thunder_tpu_torch.train.remat` — the remat policies (``none``,
  ``attention``, ``full_block``) realised with ``torch.utils.checkpoint``;
- :mod:`~thunder_tpu_torch.train.accum` — the microbatch split of
  ``accum_steps=k``;
- :mod:`~thunder_tpu_torch.train.optim` — AdamW with optax's defaults;
- :mod:`~thunder_tpu_torch.train.checkpoint` — async atomic checkpoints
  and torn-checkpoint-tolerant restore;
- :mod:`~thunder_tpu_torch.train.loop` — the elastic loop (retry, restart,
  bit-identical replay).

The submodules are imported by name: the model imports ``remat``, and the
loop's fault vocabulary lives in the serving package, which imports the
model.
"""
