#!/usr/bin/env python3
"""Chip smoke test of thunder_tpu_torch, the PyTorch/CUDA port, on one GPU.

    python3 chip_smoke.py            # needs one NVIDIA H100 (sm_90a) and nvcc
    python3 -P chip_smoke.py --paged-times LABEL   # paged attention device ms only
    python3 -P chip_smoke.py --write-times LABEL   # the engine's KV writers' ms only
    python3 chip_smoke.py --moe-depth               # int8 vs bf16 vs f32 MoE forward by depth
    python3 chip_smoke.py --bytecode                # the build and phase 19 alone

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: requires CUDA, prints the card's name and power limit, and turns
   TF32 off so float32 products run in full float32;
2. build: compiles every ``thunder_tpu_torch/csrc/*.cu`` with one nvcc call
   each, all at once, into ``build/thunder_tpu_torch/`` and prints ptxas'
   registers and spills;
3. kernels: each kernel against its plain PyTorch version at the shapes
   the served paths give it (Llama-3-8B: 32 heads over 8 KV groups,
   hs=128, block 16, a 1024-block 32-layer arena), ragged positions with
   batch-padding rows: the decode kernels at B=8 with and without a
   sliding window, bf16 and f32; ``paged_attn_verify`` at the speculative
   shape (B=8, T=5) and the chunk shape (B=1, T=512, pos 2560), bf16, f16
   and f32 (attention in float32 within 1e-5 of the plain version cut as
   the kernel's body cuts the arena walk, in bf16/f16 with an error
   against the float32 result at most twice the plain version's own); each
   case prints the body ``cudaex.paged_body`` names (split-K for decode and
   the spec shape, the warpgroup body for the chunk shape), the profiler
   must see that body's kernels by name, and two calls must agree
   bitwise; the chunk and masked writes bitwise outside sink
   block 0, every offset of the masked write; the engine's pair writes
   (``paged_token_write_pair``: K and V of a decode step, B=8, and of every
   offset of a K=4 round, T=5, n_emit [1, 5, 0, 3, 2, 4, 0, 5], in one
   launch) in bf16 and f32, rank 5 and the rank-4 scale form, both arenas
   bitwise outside sink block 0, two calls bitwise equal, device ms at most
   0.0030 (step) and 0.0063 (round), the step's CUDA-event time (the median
   of five rounds of 200 calls, taken right after the build) at most 0.030
   ms; ``paged_chunk_write_pair`` (K and V of a bf16 or f32 512-token piece
   read in place from the forward's (1, L, ng, T, hs) values, at pos 2560
   through the 192-entry table and at pos 2816, 16 blocks past it, into
   the sink) both arenas bitwise outside sink block 0, two calls bitwise
   equal, device ms at most 0.050.  Then CUDA-event and profiler times of
   kernel, plain version and one library call computing the same function,
   beside the bound.  On int8 and fp8 arenas (quantized KV): ``paged_attn_decode``
   (B=8) and ``paged_attn_verify`` (both shapes; the same body checks) in
   float32 within 1e-5 and
   in bf16 by the ratio bar; ``paged_token_write_fused`` (B=8, the plain
   write and every offset 0..4 of the masked one; and the engine's
   ``paged_token_write_fused_pair``: K and V of a decode step, of a
   multi-step iteration masked by its liveness and of a K=4 round read in
   place, n_emit 0 to K+1, from bf16 and float32 values, two calls bitwise
   equal, device ms at most 0.0035 (step) and 0.008 (round), the int8
   step's CUDA-event median, taken before the first profile, at most
   0.030 ms) and
   ``paged_chunk_write_fused`` (32 blocks; one arena, and the engine's
   ``paged_chunk_write_fused_pair``: K and V in one pass off the forward's
   (1, L, ng, T, hs) values, two calls bitwise equal, device ms at most
   0.0607, every launch summed) with stored bytes and scales
   bitwise equal to the plain versions' and error sums within 1e-5
   relative; their times beside the bounds (no single PyTorch call
   computes these functions, so no library time).  The decode and verify
   kernels at head sizes 16 and 80 (off the 64/128/256 grid), bf16 and
   float32, by the same bars; verify at hs 80 with 256 rows per group
   (the WMMA body) in bf16 and f16 and on int8 and fp8 arenas, by the
   same bars and body checks.  ``flash_ce`` at the
   training step's (2048, 128256), float32 and bf16 logits, random
   targets, loss and lse within 1e-5 of their largest magnitude, timed
   beside ``F.cross_entropy(..., reduction="none")`` (the losses only);
   ``lora_delta_fused`` at the decode (B=8, T=1), verify (B=8, T=5) and
   chunk (B=1, T=512) shapes for wq, wk and wo, ranks 8, 16, 64, 128 and
   256 (up to four of phase 2's 64-rank chunks), x in
   bf16 and float32, factors in float32 and bf16 (float32 within 1e-5 of
   the output's max magnitude, bf16 by the ratio bar, base-slot rows
   exactly 0, two calls bitwise equal); the slot read (8 requests over a
   4-slot arena of 32 layers, slots [1, 2, 0, 3, 1, 2, 0, 3]) bitwise equal
   to the gathered call and within 1.1x of its device time (the medians
   of five alternate rounds); the profiler
   must see both phases' kernels; timed at each shape and at rank 128
   beside two ``torch.bmm`` calls over the gathered factors (a reference:
   no single library call computes it), device ms at most 0.008 (decode),
   0.010 (verify), 0.020 (chunk, also below its plain version) and 0.030
   (rank 128), and the decode call's CUDA-event time (the median of five
   rounds of 200 calls, taken right after the build, before the first
   profile) at most 0.030 ms; a profile that records no kernel
   is taken again, up to three times;
4. serve: Llama-3-8B at full width (random weights from a seed) through
   ``serve(None, params, cfg, attn="paged")``: 8 greedy requests with
   prompts of 128-1024 tokens and 32 new tokens each; the kernels' launch
   counts must equal the decode steps times n_layer (attention) and times 1
   (the pair write of K and V); then one
   decode step's logits through the kernels against the dense path over
   the same gathered cache; then four decode steps profiled by kernel
   group: the ``paged_attn_decode`` group (the split-K body's two kernels)
   at most 2.0 ms per step, and the step's device busy time fallen from
   the 35.6 ms it read on the previous decode kernel by at least 0.9 of
   the group's saving on that kernel's 27.2 ms, and the ``kv_write`` group
   (every KV write kernel) at most 0.0034 ms per step (a profile that
   records no CUDA activity is taken again, up to three times, and then
   fails);
5. chunked serve: the same model with ``prefill_chunk=512``, block-aligned
   prefill buckets (16..512), 8 greedy requests with prompts of 1024-3072
   tokens, 32 new tokens each; the chunk kind must resolve "paged", and
   ``paged_attn_verify`` must launch n_layer times and ``paged_chunk_write``
   once (K and V) per intermediate piece, the decode kernels as in phase 4;
   then one steady chunk piece profiled by kernel group (``paged_attn_verify``
   / matmul / the rest), its ``kv_write`` group at most 0.055 ms;
6. speculative serve: the same target with a layer-skip draft (its own
   embedding, first two blocks, final norm and head), K=4, 8 greedy
   requests; ``paged_attn_verify`` launches n_layer times and
   ``paged_token_write_masked`` once per round, the decode kernels never;
   one verify round profiled by kernel group, its ``kv_write`` group at
   most 0.0056 ms; then once more with draft = target, which must accept K
   drafts in some round;
6b. quantized serves: the chunked serve with ``kv_dtype="int8"`` on a pool
   of the bf16 chunked pool's bytes (1.94x the blocks), then the
   speculative serve with ``kv_dtype="fp8"`` (the draft arena inherits
   fp8); exact launch counts (the fused writes only, never an unquantized
   write: ``paged_chunk_write_fused`` once per chunk piece,
   ``paged_token_write_fused`` once per decode step and per round), the
   ``serving.kv_quant.rel_err`` gauge in (0, 0.05), and one
   decode step's logits off the int8 arenas through the kernels against
   ``gather_dense_q`` and ``forward_with_cache`` (phase 4's bars); then one
   int8 chunk piece, four int8 decode steps and one fp8 verify round
   profiled by kernel group, their ``kv_write`` groups at most 0.065 /
   0.0042 / 0.0078 ms;
6c. LoRA serves: a registry of rank 16, alpha 32 (scaling 2), targets
   wq/wk/wv/wo, three adapters of std 0.05 from a seeded generator; the
   chunked serve of phase 5 and the speculative serve of phase 6 with two
   requests per adapter and two base ones; exact launch counts
   (``lora_delta_fused`` 4·n_layer per decode step, chunk piece and verify
   round, none elsewhere), the tenant counters, TTFT/TPOT/tokens/s beside
   the serves without LoRA, and one decode step's logits through the
   kernels against the dense path with the plain delta (phase 4's bars);
   then one decode step (8 rows) and one chunk piece of the chunked LoRA
   serve and one verify round of the speculative one profiled by kernel
   group: the ``lora_delta`` group (both phases' kernels) nonzero and at
   most 1.2 / 3.0 / 1.5 ms, and the LoRA chunk piece's busy time at most
   1.25x phase 5's chunk piece (a profile that records nothing is taken
   again, then fails);
7. correctness at full width: served tokens, exact, in float32 at
   Llama-3-8B widths and 4 layers (chunked = unchunked, speculative =
   plain; on an int8 pool paged = gather, unchunked and chunked, with
   chunked against unchunked reported; with LoRA paged = gather, alone =
   mixed, adapters change tokens, base in a LoRA engine = registry-free,
   and two adapters with a shared 2-block prefix each = their solo run;
   LoRA with MLP targets, and LoRA on an int8 pool, paged = gather);
   tiny-llama-debug at its own hs 16 served on the default attn, which must
   resolve paged, through the decode kernel, with the gather path's tokens;
   and at
   full depth one prefill chunk (T=512) and one verify chunk (T=5) through
   the kernels against ``forward_with_cache`` over the gathered cache,
   float32 within 1e-3, bf16 error within twice the dense bf16 path's own;
8. flash attention (run with the kernels of phase 3): the forward, dq and
   dk/dv kernels against their plain versions at the training shape (B=1,
   32 heads over 8 KV groups, T=2048, hs=128, causal) and at small shapes
   (non-causal, a window, Tq != Tk, hs 64 and 256, every mask layout), bf16
   and float32, each run twice bitwise equal, each case printing the body
   the wrappers picked (bf16 at hs 64/128: the warpgroup body); then their
   times beside the plain versions, ``F.scaled_dot_product_attention`` and
   the bounds;
9. train correctness: one step's loss and grads at Llama-3-8B widths and 4
   layers.  The eager twin (``make_eager_train_step``) through the kernels
   (flash attention and the fused cross-entropy, one launch) against their
   plain versions, float32 and bf16; the traced step (the main path)
   against the eager twin: float32 loss within 1e-5 relative and each grad
   within 1e-4 of its largest magnitude, bf16 against the float32 eager
   step within twice the eager bf16 step's error;
10. train at full width and depth through the trace: 4 AdamW steps of
    Llama-3-8B (bf16, B=1, T=2048, remat full_block, lr 1e-4) on one fixed
    batch with the traced ``TrainStep``: its forward and backward programs
    run ``cuda_*``, ``torch_*`` and fusion symbols only (every fusion region
    holding only torch-implementable, non-random prims:
    ``inductorex.region_violations``), with two ``cuda_sdpa`` per
    layer (the backward recomputes the forward's); the flash and
    ``flash_ce`` launch counts equal those programs' symbols per step
    exactly; no declines (attention or cross-entropy), finite losses and
    the last below the first; step time, tokens/s, model FLOPs and their
    share of peak, peak memory, ``saved_bytes`` before and after remat and
    the host ms of the build; then 3 steps of the eager twin on the same
    params, printed beside (step time, tokens/s, share of peak, peak
    memory); then two more traced steps profiled by kernel group, one on
    the flash bodies the wrappers pick (the warpgroup kernels, by name) and
    one on the WMMA body (the earlier tensor-core body): the step's device
    time must fall by at least 0.9 of the flash groups' saving;
11. the trace IR: ``ir_layer_loss`` (one Llama-3-8B layer at full width, its
    final norm, head and cross-entropy, weights from seed 0, B=1, T=2048)
    acquired by ``functional.trace_from_fn`` (``language=`` clang), claimed
    by cuda ≻ torch (the unfused stack: phase 16 holds the fusion) and run
    as the generated
    prologue and computation, float32 and bf16: the final trace runs
    ``cuda_sdpa`` and ``torch_*`` symbols only, each call launches exactly
    one ``flash_fwd`` and one ``flash_ce`` (the torch executor's fast
    path), two calls agree bitwise, float32 within 1e-5 (loss, relative)
    and 1e-4 (block output, of its max) of the eager layer, bf16 against
    the float32 eager layer within twice the eager bf16 layer's error; the
    prologue rejects a CPU tensor, a wrong dtype and a wrong shape; the SDPA
    backward prim alone at the same shape runs ``cuda_sdpa_backward`` (one
    ``flash_bwd_dq`` and one ``flash_bwd_dkv``), bitwise equal to the
    kernel called directly; the bf16 layer and the backward claimed by the
    torch executor alone launch the same kernels and agree bitwise; no
    decline is counted, on the IR path or the eager one; host ms of
    acquisition, claiming and codegen
    and the program's CUDA-event and device ms beside the eager layer's
    are printed, with no bar;
12. ``thunder_tpu_torch.jit(gpt_loss)`` of Llama-3-8B at full width and
    depth (32 layers, weights from seed 0, B=1, T=2048, the default
    executors cuda ≻ inductor ≻ torch): the model's own torch-written loss,
    traced through the torch language, claimed and run as the generated
    program.  The final trace runs ``cuda_sdpa``, ``torch_*`` and fusion
    symbols only (phase 10's region check); each
    call launches exactly 32 ``flash_fwd`` and one ``flash_ce``; the
    prologue guards every parameter; no decline, on the jit path or the
    eager one.  The bf16 loss against the float32 eager ``gpt_loss`` (under
    ``torch.no_grad()``) within twice the eager bf16 loss's error, and
    whether it equals the eager bf16 loss bitwise; the float32 loss within
    1e-5 relative of eager.  The cache: a second call is a key hit, one
    prologue run, bitwise equal; T=1024 misses into a second entry and
    T=2048 then hits again; the prologue rejects a CPU tensor, a wrong dtype
    and a wrong shape; a hit's key and prologue run under
    ``torch.cuda.set_sync_debug_mode("error")``.  Printed with no bar: host
    ms of acquisition, the passes, claiming and codegen, the guards, the
    cache-hit dispatch median over 20 calls, CUDA-event and device ms per
    call and kernels per call beside eager ``gpt_loss``;
13. the transforms under ``jit`` at Llama-3-8B widths and 4 layers (B=1,
    T=2048): ``value_and_grad(gpt_loss)`` of bf16 params runs ``cuda_*``,
    ``torch_*`` and fusion symbols only (phase 10's region check) in its
    forward and backward programs,
    launches exactly the flash and ``flash_ce`` kernels their symbols name
    (four ``flash_bwd_dq``/``flash_bwd_dkv``), and a second call is a cache
    hit bitwise equal to the first; ``jit(gpt_loss, autocast="bf16")`` of
    float32 params runs its SDPA at bf16 (four ``flash_fwd``, one
    ``flash_ce``) and returns a bf16 loss within twice the eager bf16 loss's
    error, plus half a bf16 ulp of the loss, of the float32 eager loss; no
    declines;
14. the Mixtral path at Mixtral-8x7B's widths (n_embd 4096, 32 heads over
    8 KV groups, hs 128, 8 experts of intermediate 14336 with 2 per token,
    vocab 32000, rope base 1e6; random bf16 weights from a seed, depth cut):
    (a) the quantization executor's four products (``quantex.int8_linear``,
    ``int8_matmul``, ``fp8_linear``, ``fp8_matmul``) at M = 8, 512 and 2048
    rows and (K, N) = (4096, 14336) and (14336, 4096) against their plain
    versions (int8 bitwise, fp8 within one ulp of the output's dtype at its
    largest magnitude, or 1e-4 of it: the library's float32 sum in its own
    order), two calls bitwise equal, one library call each
    (``torch._int_mm`` / ``torch._scaled_mm``), their CUDA-event ms beside
    bf16 ``F.linear``, and for the linears the device ms of the call, of
    the product alone and of ``F.linear``; (b) 3 steps of the traced
    ``TrainStep`` at 4 layers (2 where 4 do not fit, printed), B=1,
    T=2048, full_block, AdamW: programs of ``cuda_*``/``torch_*`` and
    fusion symbols only (phase 10's region check), 2·L ``flash_fwd``, L ``flash_bwd_dq`` and ``flash_bwd_dkv`` and
    the programs' CE symbols' ``flash_ce`` per step, exactly, no declines, losses finite and falling,
    step time, tokens/s, peak memory and the build's host ms; one more
    step profiled by kernel group with its top kernels; 2 steps of the
    eager twin; before those steps, one traced step with ``quant="int8"``
    on the fresh params and the same batch: ``int8_linear`` in the forward
    program, no ``int8_`` symbol in the backward, one ``_int_mm`` per
    ``int8_linear``, its loss within 1e-2 relative of the bf16 step's; the
    reference's ``test_quantized_moe_inference`` on the card
    (``jit(gpt_forward)`` of mixtral-like with the int8 executor first,
    B=2, T=32: mean |Δ| / mean |ref| < 0.1); (c) serving at 8 layers, 8
    greedy requests of 128-1024 prompt tokens and 32 new tokens, paged
    decode, with bf16 weights and with ``quantized=True``: exactly n_layer
    ``paged_attn_decode`` and one ``paged_token_write`` per decode step
    each, tokens/s, TTFT and TPOT p50 and memory, and the quantized serve's
    last decode step replayed (every served token re-derived), its logits
    against bf16 weights on the same tokens and K/V printed (random weights
    at these widths amplify any perturbation with depth, so the reference's
    bar holds on its own config above and not here); (d) float32
    tokens, exact, at 2 layers: paged = gather, ``prefill_chunk=512`` =
    unchunked, speculative with a 1-layer MoE layer-skip draft = plain, and
    ``quantized=True`` paged = ``quantized=True`` gather;
15. graphs, multi-step, recovery (every serve above already ran its
    decode, chunk-piece and speculative steps as CUDA graphs, one replay a
    step after each bucket's first; their bars hold as written): (a) phase
    4's serve on an engine run eagerly (the engine's private ``_graphs=False``)
    and on the default graphed one, a first pass each that meets (and
    captures) every bucket and a measured second that captures nothing:
    equal tokens, exactly n_layer ``paged_attn_decode`` and one pair write
    per decode step, the captures by kind, four decode steps profiled each
    way with the graphed idle share below the eager one, TPOT p50,
    tokens/s, peak memory and the memory each engine holds; (b) the same
    serve at ``decode_steps=4``: equal tokens, at most one host visit per 4
    decode steps plus the partial visit, n_layer ``paged_attn_decode`` and
    one masked pair write (the liveness keep-mask) per iteration; (c) phase 5's chunked and phase 6's
    speculative serves at 8 layers, graphed against eager: equal tokens and
    launches; (d) an ``oom`` injected at the 12th ``decode.dispatch`` of a
    graphed serve, in float32 at 4 layers: one recovery, the unfaulted
    tokens, the arenas at their addresses (the bf16 serve at full width
    recovers too; how many of its requests keep their tokens is printed,
    with no bar: the replay's chunk pieces round apart from the steps that
    wrote the lost cache);
16. fusion (the fusion executor, ``executors/inductorex.py``; phases 9-14
    ran on it, the default executors cuda ≻ inductor ≻ torch, each region
    one ``torch.compile`` program): (a) phase 12's ``jit(gpt_loss)``
    against the same loss on the unfused executors (cuda ≻ torch) in the
    same run: kernels and device ms per call, regions, distinct compiled
    structures, compile seconds, cache-hit dispatch ms; fused device ms at
    most the unfused; (b) phase 10's traced step against the same step
    unfused: step time, device busy by kernel group, peak memory beside the
    trace's donated-aware estimate and ``examine.train_memory_report``;
    fused busy at most the unfused; (c) ``jit(..., donate=True)`` on the
    card: the caller's donated bytes are freed, reusing them raises
    ``DonationError``, the results equal the undonated call's.  Each phase
    prints the regions it compiled and their seconds;
17. stateful and replicated serving (run before phase 9, on phase 4's
    params; every serve graphed on the paged lane, a first pass meeting
    every bucket and a measured pass that captures nothing, replays every
    decode iteration and chunk piece and launches exactly their kernels):
    (a) ``sessions=True``, 8 chats x 3 turns (turn-1 prompts of 400-900
    tokens, later turns the history plus 40-120 tokens, 32 new tokens a
    turn): 16 re-attaches, each later turn sharing the blocks its session
    parked; TTFT p50 of turns 2-3 beside a cold engine on the same
    full-history prompts and the table's resident blocks and bytes,
    printed; (b) ``priorities=True`` on a pool 7 low requests fill, then a
    high one: at least one preemption, every request finishes; the high
    request's TTFT beside a ``priorities=None`` engine's and the victims'
    recomputed positions, printed; (c) ``constraints=True``, 8 rows, 4
    constrained (1000 allowed ids; a sequence automaton), at
    ``decode_steps=1`` and 4: every constrained token allowed by its
    automaton; TPOT p50 beside an unconstrained engine and the mask
    upload's host ms a dispatch, printed; (d) ``replicas=2``, two families
    of 16 requests each sharing a 512-token prefix: each family on one
    replica, each replica's prefix hits > 0; tokens/s beside a solo engine
    of the same total blocks, printed; (e) gpt2-124m (learned positions) at
    full width and depth, bf16: 12 ``paged_attn_decode`` per decode step;
    (f) float32 at 4 layers: session turns 2-3 equal a cold engine's
    tokens, the preempted and the high request's tokens (greedy, and at
    temperature 0.7 with seeded generators) equal undisturbed solo runs,
    a constrained batch's unconstrained rows equal an unconstrained
    engine's, routed tokens equal the solo engine's; gpt2-124m float32
    paged equals gather.  The phase prints its seconds;
18. the front end (``frontend_phase``, on Llama-3-8B params from seed 0 at
    full width, B=1, T=2048, after phase 15): (a) ``ttt.jit(LlamaModule)``,
    a LitGPT-style Llama written with ``nn.Linear``, RMSNorm, RoPE,
    ``F.scaled_dot_product_attention(..., is_causal=True, enable_gqa=True)``
    and ``F.cross_entropy``, at 32 layers in bf16: one forward and
    ``loss.backward()`` launch exactly the flash kernels the forward and
    backward programs name (``flash_fwd`` per layer and per recompute,
    ``flash_bwd_dq``/``_dkv`` per layer, one ``flash_ce``), no declines,
    every parameter gets a ``.grad``; the second call is a cache hit after
    which ``memory_allocated`` is the pre-call level plus the grads (the
    residuals released); at 4 layers float32 against the eager module (loss
    1e-5 relative, each grad 1e-4 of its max), bf16 by the ratio bar against
    that float32 run, and after an AdamW step a cache hit that sees the new
    weights; step ms, device ms by kernel group, peak GiB and the regions
    compiled, printed beside phase 10's step; (b) phase 12's
    ``jit(gpt_loss)`` with ``profile=True``: the loss bitwise equal, one
    ``cuda_sdpa`` record per layer, times > 0 within the call's wall, each
    region's FLOPs the 2·M·N·K of its linears, the top ten printed; (c) with
    ``detect_anomalies=True``: the clean loss bitwise equal, a NaN planted
    in a weight row raises ``AnomalyError`` at the first symbol reading it;
    (d) an HF-layout gpt2-124m state dict from a seed, converted by
    ``models/hf_weights.py`` bitwise equal to the hand layout, served paged
    at full width and depth (12 ``paged_attn_decode`` and one write a
    step), float32 greedy tokens paged equal to gather.  The phase prints
    its seconds;
19. bytecode (after phase 18, on the seed-0 params and phase 12's batch):
    the bytecode interpreter, ``jit(..., interpretation="bytecode")``, over
    ``user_loss``, a Llama loss written in this file (so it runs opcode by
    opcode) with ``gpt_loss``'s op sequence, every weight and both rope
    tables read from the module-level ``BYTECODE_STATE`` and the config
    from ``BYTECODE_CFG``: (a) at 32 layers the captured tensors are every
    leaf plus the two tables, 0 constants are baked, one call launches 32
    ``flash_fwd`` and one ``flash_ce`` with no decline, the loss is bitwise
    phase 12's ``jit(gpt_loss)``'s and the second call a cache hit; an
    in-place edit of one weight row (made, then undone) is seen with no
    retrace, rebinding ``LOSS_SCALE`` costs one retrace and gives the
    functional frontend's loss bitwise, a CPU tensor in the dict fails the
    prologue's device guard (a retrace, no kernel launched) and the card's
    tensor back is a hit; it prints the first call's seconds (interpretation,
    trace to program, region compiles), the guards, the interpreter log's
    length and the cache-hit dispatch ms beside phase 12's; (b)
    ``value_and_grad(user_loss_p, interpretation="bytecode")`` at 32 layers,
    the params explicit: loss and every grad bitwise the functional
    frontend's, the launches its programs name; (c) phase 18's
    ``LlamaModule`` at 4 layers under ``jit(module,
    interpretation="bytecode")``: loss and grads bitwise ``jit(module)``'s.
    The phase prints its seconds (``--bytecode`` runs the build and this
    phase alone);
20. data-parallel and sharded training (``dist_phase``, last), on a
    one-rank NCCL world in this process (the card is one rank: every
    collective is a copy; the process group's timeout 120 s): (a0) each
    collective prim through ``jit`` on a bf16 and a float32 card tensor,
    bitwise its input; (a) a
    ``ddp(params, mesh)`` step with ``overlap=True`` (25 MiB buckets) and an
    ``fsdp(params, mesh)`` step with ``zero3=True``, Llama-3-8B at full
    width and depth, bf16, B=1, T=2048, ``full_block``, three steps each
    from the seed-0 params on phase 10's batch: losses and a per-tensor
    digest of the params after the steps bitwise phase 10's traced step's,
    built anew and run from the same params just before them (phase 10's
    own first steps, ``PHASE10_REF``, printed beside with no bar), the
    launches its programs name (2·L ``flash_fwd``, L
    of each backward kernel, 2 ``flash_ce`` a step), every dispatch of
    those kernels counted ``sharded``, the collectives per step as the
    placements and buckets say (all-reduces = ``expected_all_reduces``;
    at one rank ``fsdp`` replicates every param, as the reference's
    ``_prune_spec`` drops a size-1 axis, so the gathers and reduce-scatters
    on the card are (a0)'s);
    step ms, peak GiB, build and compile seconds printed beside phase 10's;
    (b) ``train_cli --mode zero3 --devices 1 --telemetry`` on
    tiny-llama-debug in a subprocess run beside (c): exit 0, finite
    falling losses, a telemetry record per step; (c) ZeRO-3 at 2 layers,
    full width: one step, a sharded save, a load into fresh DTensors
    (bitwise), the resumed step bitwise the continued one, bytes and
    seconds printed.  The phase prints its seconds (``--dist`` runs the
    build, phase 10 and this phase alone);
21. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

import thunder_tpu_torch as ttt
from thunder_tpu_torch import clang as ir_clang
from thunder_tpu_torch import ltorch
from thunder_tpu_torch._tree import tree_leaves
from thunder_tpu_torch.core import cache_key as jit_cache_key
from thunder_tpu_torch.core import prims as ir_prims
from thunder_tpu_torch.core.langctxs import Languages
from thunder_tpu_torch.distributed.api import make_eager_train_step, make_train_step
from thunder_tpu_torch import examine
from thunder_tpu_torch.executors import _build, cudaex, inductorex, torchex
from thunder_tpu_torch.core.rematerialization import peak_live_bytes
from thunder_tpu_torch.executors.passes import del_last_used, transform_for_execution
from thunder_tpu_torch.extend import resolve_executors
from thunder_tpu_torch.functional import trace_from_fn
from thunder_tpu_torch.models.generate import forward_with_cache
from thunder_tpu_torch.models.llama import (
    Config,
    _norm,
    block_forward,
    build_rope_cache,
    gpt_forward,
    gpt_loss,
    init_params,
    param_count,
)
from thunder_tpu_torch.observability import registry
from thunder_tpu_torch.observability.events import clear_events, events
from thunder_tpu_torch.train.optim import adamw
from thunder_tpu_torch.serving import (
    AdapterRegistry,
    ServingEngine,
    SpecConfig,
    TokenSetConstraint,
    make_lora_factors,
    sequence_constraint,
    serve,
)
from thunder_tpu_torch.serving.faults import FaultPlan, FaultSpec
from thunder_tpu_torch.serving.lora import gather_adapter_slots, valid_targets
from thunder_tpu_torch.serving.kv_pool import SINK_BLOCK, chunk_tables, gather_dense
from thunder_tpu_torch.serving.paged_attention import forward_paged
from thunder_tpu_torch.serving.quant import (
    arena_block_bytes,
    blocks_for_arena_bytes,
    gather_dense_q,
    quantize_kv,
)

SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
# attention kernel vs plain version.  float32: the same arithmetic in
# another summation order and exp, a few ulps of outputs of magnitude <= ~4.
ATOL_F32 = 1e-5
# bf16/f16: kernel and plain version round at the same places (K/V and the
# probabilities to the query dtype, the output) but over other key tiles,
# so they differ by rounding alone.  Both are held against the float32
# plain result of the same rounded inputs: the kernel's error may be at
# most LOWP_ERR_RATIO times the plain version's own.  (A fixed bar would
# sit near the outputs' own size at long contexts, |out| ~ 0.03 over 3000
# keys, and let a wrong kernel through.)
LOWP_ERR_RATIO = 2.0
# one decode step of the 32-layer model, kernel path vs dense path.  In
# float32 the two are the same math summed in another order.  In bf16 they
# round at different places (the dense path rounds normalized attention
# probabilities to bf16, the kernel unnormalized ones) and 32 residual
# layers carry those roundings to the logits, so the bar is relative: held
# against the float32 dense logits, the kernel path's error may be at most
# BF16_ERR_RATIO times the dense bf16 path's own.
LOGITS_ATOL_F32 = 1e-3
BF16_ERR_RATIO = 2.0

CARD = ""


# the executors before the fusion executor: phase 16's yardstick
UNFUSED = (cudaex.cuda_ex, torchex.torch_ex)


def say(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20, also=(), tries: int = 3,
              whole: bool = False) -> float | None:
    """Mean device time of the kernels whose name contains ``kernel``, from
    the profiler's CUDA activity (host launch overhead excluded), plus that
    of the kernels named like an entry of ``also`` that ``fn`` launches
    beside it.  A profile that records no such kernel (a short one now and
    then records nothing at all) is taken again, ``tries`` times in all;
    so is one that misses a launch when ``whole`` (``fn`` launches
    ``kernel`` and each entry of ``also`` once a call: a profile that lost
    one kernel's records would time the others alone).  None when no
    profile qualifies."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        seen = dict.fromkeys(also, 0)
        for evt in prof.key_averages():
            if kernel in evt.key:
                total += evt.device_time_total
                count += evt.count
            elif any(a in evt.key for a in also):
                total += evt.device_time_total
                for a in also:
                    if a in evt.key:
                        seen[a] += evt.count
        if count and not (whole and (count != iters or any(n != iters for n in seen.values()))):
            return total / count / 1e3
    return None


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


NO_LIBRARY = "no single PyTorch call computes this"


def timed(name, label, kernel, plain, library, library_name, bound_ms_by, *, iters,
          plain_iters, plain_warmup=3, device_kernel=None, device_also=(), device_whole=False,
          dtype_name="bf16") -> dict:
    """Per-call times of a kernel, its plain version and the library call
    computing the same function (``library`` None where no single PyTorch
    call does), the kernel's device time (of the CUDA kernels named like
    ``device_kernel``, default ``name``), and its bound."""
    ms = time_ms(kernel, iters=iters)
    dev_ms = device_ms(kernel, device_kernel or name, also=device_also, whole=device_whole)
    plain_ms = time_ms(plain, iters=plain_iters, warmup=plain_warmup)
    library_ms = time_ms(library, iters=iters) if library is not None else None
    bound_ms, bound_by = bound_ms_by
    lib = f"{library_name} {library_ms:.4f} ms" if library is not None else f"library: {NO_LIBRARY}"
    say(f"{name} {dtype_name}{label} timing per call: kernel {ms:.4f} ms (device {dev_ms} ms), "
        f"plain {plain_ms:.4f} ms, {lib}, bound {1e3 * bound_ms:.3f} us ({bound_by})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                **({} if library is not None else {"library": NO_LIBRARY}))


#
# phase 3: kernels against their plain versions at the serving shape
#

B, NH, NG, HS, BS, NBB, L, NUM_BLOCKS = 8, 32, 8, 128, 16, 64, 32, 1024


def decode_inputs(dtype, gen):
    dev = DEVICE
    rng = np.random.default_rng(SEED)
    pos = rng.integers(1, NBB * BS, B).astype(np.int32)
    pos[[2, 6]] = 0                                    # batch-padding rows
    tables = np.full((B, NBB), SINK_BLOCK, dtype=np.int32)
    free = rng.permutation(np.arange(1, NUM_BLOCKS))
    k = 0
    for i, p in enumerate(pos):
        n = -(-int(p) // BS)
        tables[i, :n] = free[k:k + n]
        k += n
    shape = (NUM_BLOCKS, L, NG, BS, HS)
    x = dict(
        q=torch.randn((B, NH, HS), generator=gen, device=dev).to(dtype),
        k_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        v_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        fresh_k=torch.randn((B, NG, HS), generator=gen, device=dev).to(dtype),
        fresh_v=torch.randn((B, NG, HS), generator=gen, device=dev).to(dtype),
        tables=torch.as_tensor(tables, device=dev),
        pos=torch.as_tensor(pos, device=dev),
    )
    return x, pos


def attn_bound(pos, window, dtype):
    esize = torch.empty((), dtype=dtype).element_size()
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    slots = int((pos - lo).sum())                      # arena slots the rows attend
    nbytes = (2 * slots * NG * HS * esize              # K and V read once
              + 2 * B * NH * HS * esize                # q in, out
              + 2 * B * NG * HS * esize                # fresh K/V
              + 4 * B * NBB + 4 * B)                   # tables, pos
    ops = 4 * NH * HS * (slots + B)                    # QK and PV, fresh included
    return bound(nbytes, ops, dtype)


def attn_body(name, x) -> tuple[str, int]:
    """The body a paged attention call on ``x`` takes (``cudaex.paged_body``)
    and the splits of its arena walk (1 off the split body)."""
    q, arena, fresh = x["q"], x["k_arena"], x["fresh_k"]
    T = q.shape[2] if q.ndim == 4 else 1
    kind = "decode" if name == "paged_attn_decode" else "verify"
    body = cudaex.paged_body(kind, q.shape[1] // arena.shape[2] * T, q.shape[-1], arena.shape[3],
                             q.dtype, arena.dtype, fresh.dtype)
    splits = (cudaex._split_plan(kind, q.shape, arena.shape, x["tables"].shape[1], T, q.dtype,
                                 arena.dtype, fresh.dtype)["splits"] if body == "split" else 1)
    return body, splits


# the kernels each body launches, as the profiler names them
BODY_KERNELS = {("paged_attn_decode", "split"): ("paged_attn_split", "paged_attn_decode_combine"),
                ("paged_attn_verify", "split"): ("paged_attn_split", "paged_attn_verify_combine"),
                ("paged_attn_verify", "wg"): ("paged_attn_verify_wg",),
                ("paged_attn_verify", "mma"): ("paged_attn_verify_mma",),
                ("paged_attn_verify", "scalar"): ("paged_attn_verify_kernel",)}


def check_attn(name, label, kernel, plain, x, **kw) -> float:
    """``kernel`` against ``plain`` on the inputs ``x``, the plain version
    cutting the arena walk as the kernel's body does (``splits``): float32
    within ATOL_F32; bf16/f16 against the float32 plain result of the same
    inputs, the kernel's error within LOWP_ERR_RATIO times the plain
    version's own.  Returns the kernel's max abs difference from the plain
    version."""
    body, splits = attn_body(name, x)
    plain = functools.partial(plain, splits=splits)
    label = f"{label} [body {body}, splits {splits}]"
    got = kernel(**x, **kw)
    torch.cuda.synchronize()
    want = plain(**x, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if x["q"].dtype == torch.float32:
        ok, bar = err <= ATOL_F32, f"atol {ATOL_F32:.0e}"
    else:
        ref = plain(**{k: v.float() if v.is_floating_point() and v.element_size() > 1 else v
                       for k, v in x.items()}, **kw)
        err_kernel = (got.float() - ref).abs().max().item()
        err_plain = (want.float() - ref).abs().max().item()
        ok = err_kernel <= LOWP_ERR_RATIO * err_plain
        bar = (f"against float32: kernel {err_kernel:.3e}, plain {err_plain:.3e}, ratio "
               f"{err_kernel / err_plain:.3f}, limit {LOWP_ERR_RATIO}")
        del ref
    ok = ok and bool(torch.isfinite(got).all())
    say(f"{name} {label} {str(x['q'].dtype)[6:]}: max_abs_err={err:.3e} ({bar}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its plain version")
    return err


def check_body_kernels(name, label, fn, x) -> str:
    """The profiler must see every kernel of the body the call takes, and
    two calls must agree bitwise.  Returns the body."""
    body, _ = attn_body(name, x)
    want = BODY_KERNELS[name, body]
    a = fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):         # a short profile now and then records no kernel at all
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        seen = sorted({e.key for e in prof.key_averages() if any(k in e.key for k in want)})
        if all(any(k in e for e in seen) for k in want):
            break
    b = fn()
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    ok = same and all(any(k in e for e in seen) for k in want)
    say(f"{name} {label}: body {body!r}, kernels seen {[e[:60] for e in seen]}; two calls "
        f"bitwise equal: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label}: the {body} body's kernels {want} did not run, or "
                             "two calls differ")
    return body


def check_decode(layer=L - 3):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, pos = decode_inputs(dtype, gen)
        for window in (None, 256):
            err = check_attn("paged_attn_decode", f"window={window}", cudaex.paged_attn_decode,
                             cudaex.paged_attn_decode_plain, x, layer=layer, window=window)
            if dtype == torch.bfloat16 and window is None:
                result["max_abs_err"] = err
        if dtype == torch.bfloat16:
            result["body"] = check_body_kernels(
                "paged_attn_decode", "B=8", lambda: cudaex.paged_attn_decode(**x, layer=layer), x)
            result.update(time_decode(x, pos, layer))
        del x
    return result


def time_decode(x, pos, layer):
    # the library yardstick: SDPA over K/V gathered dense beforehand, the
    # fresh token in its slot, a per-row keep-mask; only the call is timed
    S = NBB * BS + 1
    kd = x["k_arena"][x["tables"].long(), layer].permute(0, 2, 1, 3, 4).reshape(B, NG, NBB * BS, HS)
    vd = x["v_arena"][x["tables"].long(), layer].permute(0, 2, 1, 3, 4).reshape(B, NG, NBB * BS, HS)
    kd = torch.cat([kd, torch.zeros_like(kd[:, :, :1])], dim=2)
    vd = torch.cat([vd, torch.zeros_like(vd[:, :, :1])], dim=2)
    rows = torch.arange(B, device=DEVICE)
    p = x["pos"].long()
    kd[rows, :, p] = x["fresh_k"]
    vd[rows, :, p] = x["fresh_v"]
    mask = (torch.arange(S, device=DEVICE)[None, :] <= p[:, None])[:, None, None, :]
    q4 = x["q"][:, :, None]
    return timed("paged_attn_decode", "", lambda: cudaex.paged_attn_decode(**x, layer=layer),
                 lambda: cudaex.paged_attn_decode_plain(**x, layer=layer),
                 lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                                        enable_gqa=True),
                 "SDPA", attn_bound(pos, None, x["q"].dtype), iters=200, plain_iters=10,
                 plain_warmup=1, **device_names("paged_attn_decode", x))


def device_names(name, x) -> dict:
    """``timed``'s device kernel names for the body a call on ``x`` takes:
    every kernel of the body is timed (the split kernel with its combine)."""
    first, *rest = BODY_KERNELS[name, attn_body(name, x)[0]][::-1]
    return dict(device_kernel=first, device_also=tuple(rest))


def check_write():
    """The single-arena ``paged_token_write`` (the reference's signature):
    bitwise outside sink block 0, rank 5 in bf16 and f32 and the rank-4
    scale form; then its bf16 times beside ``index_put_``."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, pos = decode_inputs(dtype, gen)
        tables, posd = x["tables"], x["pos"]
        arena = x.pop("k_arena")
        del x
        vals = torch.randn((B, L, NG, HS), generator=gen, device=DEVICE).to(dtype)
        plain = cudaex.paged_token_write_plain(arena.clone(), vals, tables, posd, block_size=BS)
        got = cudaex.paged_token_write(arena, vals, tables, posd, block_size=BS)
        torch.cuda.synchronize()
        same = bool(torch.equal(got[1:], plain[1:]))    # block 0 is the sink
        say(f"paged_token_write {str(dtype)[6:]}: bitwise equal outside block 0: {same}")
        if not same:
            raise AssertionError("paged_token_write disagrees with its plain version")
        if dtype == torch.bfloat16:
            result.update(time_write(arena, vals, tables, posd, dtype))
        del arena, plain
    # the rank-4 (scale arena) form
    scale = torch.randn((NUM_BLOCKS, L, NG, BS), generator=gen, device=DEVICE)
    svals = torch.randn((B, L, NG), generator=gen, device=DEVICE)
    plain = cudaex.paged_token_write_plain(scale.clone(), svals, tables, posd, block_size=BS)
    got = cudaex.paged_token_write(scale, svals, tables, posd, block_size=BS)
    torch.cuda.synchronize()
    same = bool(torch.equal(got[1:], plain[1:]))
    say(f"paged_token_write rank-4 f32: bitwise equal outside block 0: {same}")
    if not same:
        raise AssertionError("paged_token_write (rank 4) disagrees with its plain version")
    result["max_abs_err"] = 0.0
    return result


def time_write(arena, vals, tables, pos, dtype):
    # the library yardstick: one index_put_ on the arena viewed (nb, L*ng, bs, hs)
    p = pos.long()
    blk = tables.long().gather(1, (p // BS)[:, None])
    rows = torch.arange(L * NG, device=DEVICE)[None, :]
    view = arena.view(NUM_BLOCKS, L * NG, BS, HS)
    idx = (blk.expand(B, L * NG), rows.expand(B, L * NG), (p % BS)[:, None].expand(B, L * NG))
    v3 = vals.reshape(B, L * NG, HS)
    esize = vals.element_size()
    return timed("paged_token_write", "",
                 lambda: cudaex.paged_token_write(arena, vals, tables, pos, block_size=BS),
                 lambda: cudaex.paged_token_write_plain(arena, vals, tables, pos, block_size=BS),
                 lambda: view.index_put_(idx, v3), "index_put_",
                 bound(2 * vals.numel() * esize + 4 * tables.numel() + 4 * B, 0, dtype),
                 iters=500, plain_iters=100)


#
# phase 3, continued: the kernels of chunked prefill and speculative serving
#

VERIFY_SHAPES = {"spec": dict(Bv=8, T=5, nbb=NBB), "chunk": dict(Bv=1, T=512, nbb=192)}
CHUNK_POS = 2560                                      # the chunk shape's block-aligned start


def verify_inputs(dtype, gen, Bv, T, nbb):
    """Arenas of the decode shape; ragged positions with padding rows at
    the spec shape, one chunk at ``CHUNK_POS`` (and its table) at the chunk
    shape."""
    dev = DEVICE
    rng = np.random.default_rng(SEED + T)
    if Bv == 1:
        pos = np.array([CHUNK_POS], np.int32)
    else:
        pos = rng.integers(1, nbb * BS - T, Bv).astype(np.int32)
        pos[[2, 6]] = 0                                # batch-padding rows
        pos[3] = 4 * BS                                # a block edge
    tables = np.full((Bv, nbb), SINK_BLOCK, dtype=np.int32)
    free = rng.permutation(np.arange(1, NUM_BLOCKS))
    k = 0
    for i, p in enumerate(pos):
        n = -(-(int(p) + T) // BS)                     # the blocks the chunk lands in too
        tables[i, :n] = free[k:k + n]
        k += n
    shape = (NUM_BLOCKS, L, NG, BS, HS)
    x = dict(
        q=torch.randn((Bv, NH, T, HS), generator=gen, device=dev).to(dtype),
        k_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        v_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        fresh_k=torch.randn((Bv, NG, T, HS), generator=gen, device=dev).to(dtype),
        fresh_v=torch.randn((Bv, NG, T, HS), generator=gen, device=dev).to(dtype),
        tables=torch.as_tensor(tables, device=dev),
        pos=torch.as_tensor(pos, device=dev),
    )
    return x, pos


def verify_bound(pos, T, nbb, dtype):
    esize = torch.empty((), dtype=dtype).element_size()
    Bv, slots = len(pos), int(pos.sum())               # arena slots the rows attend
    nbytes = (2 * slots * NG * HS * esize              # K and V read once
              + 2 * Bv * NH * T * HS * esize           # q in, out
              + 2 * Bv * NG * T * HS * esize           # fresh K/V
              + 4 * Bv * nbb + 4 * Bv)                 # tables, pos
    ops = 4 * NH * HS * (slots * T + Bv * T * (T + 1) // 2)   # QK and PV, causal fresh part
    return bound(nbytes, ops, dtype)


def check_verify(layer=L - 3):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    result = {"shapes": {}}
    for shape, dims in VERIFY_SHAPES.items():
        # the spec shape takes the split body; the chunk shape the
        # warpgroup body in bf16 and f16, the scalar one in float32
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            x, pos = verify_inputs(dtype, gen, **dims)
            label = f"{shape} B={dims['Bv']} T={dims['T']}"
            err = check_attn("paged_attn_verify", label, cudaex.paged_attn_verify,
                             cudaex.paged_attn_verify_plain, x, layer=layer)
            if dtype != torch.float32:
                body = check_body_kernels("paged_attn_verify", f"{label} {str(dtype)[6:]}",
                                          lambda: cudaex.paged_attn_verify(**x, layer=layer), x)
            if dtype == torch.bfloat16:
                rec = time_verify(x, pos, layer, dims["nbb"])
                rec.update(max_abs_err=err, body=body)
                result["shapes"][shape] = rec
            del x
    result.update(result["shapes"]["chunk"])
    return result


def time_verify(x, pos, layer, nbb):
    Bv, _, T, _ = x["q"].shape
    # the library yardstick: SDPA over the K/V gathered dense beforehand with
    # the chunk's own K/V appended, a (T, S) keep-mask per row; only the call
    # is timed
    S = nbb * BS + T
    tab = x["tables"].long()
    kd = x["k_arena"][tab, layer].permute(0, 2, 1, 3, 4).reshape(Bv, NG, nbb * BS, HS)
    vd = x["v_arena"][tab, layer].permute(0, 2, 1, 3, 4).reshape(Bv, NG, nbb * BS, HS)
    kd = torch.cat([kd, x["fresh_k"]], dim=2)
    vd = torch.cat([vd, x["fresh_v"]], dim=2)
    j = torch.arange(S, device=DEVICE)
    t = torch.arange(T, device=DEVICE)
    p = x["pos"].long()
    arena_keep = j[None, None, :] < p[:, None, None]                       # (B, 1, S)
    fresh_keep = (j[None, :] - nbb * BS <= t[:, None]) & (j[None, :] >= nbb * BS)   # (T, S)
    mask = (arena_keep | fresh_keep[None])[:, None]                        # (B, 1, T, S)
    return timed("paged_attn_verify", f" B={Bv} T={T}",
                 lambda: cudaex.paged_attn_verify(**x, layer=layer),
                 lambda: cudaex.paged_attn_verify_plain(**x, layer=layer),
                 lambda: F.scaled_dot_product_attention(x["q"], kd, vd, attn_mask=mask,
                                                        enable_gqa=True),
                 "SDPA", verify_bound(pos, T, nbb, x["q"].dtype), iters=50, plain_iters=5,
                 plain_warmup=1, **device_names("paged_attn_verify", x))


# the decode and verify kernels at head sizes off the 64/128/256 grid the
# wrappers once required: tiny-llama-debug's 16 and 80 (both take the split
# body: mma.sync products in bf16, FMA in float32); 32 heads over 8 groups,
# block 16, ragged positions with a padding row and a block edge
ODD_HEAD_SIZES = (16, 80)
MMA_T = 64             # verify tokens at hs 80: rep·T = 256 rows take the WMMA body


def odd_head_inputs(dtype, gen, hs, T=None):
    """Decode (T None) or verify (T tokens per request) inputs at head size
    ``hs``: 4 requests over a 2-layer, 128-block arena."""
    dev, Bo, nbb, nblocks = DEVICE, 4, 16, 128
    pos = np.array([0, 37, 128, 250 - (T or 0)], np.int32)
    tables = np.full((Bo, nbb), SINK_BLOCK, dtype=np.int32)
    free = np.random.default_rng(SEED + hs).permutation(np.arange(1, nblocks))
    k = 0
    for i, p in enumerate(pos):
        n = -(-(int(p) + (T or 0)) // BS)
        tables[i, :n] = free[k:k + n]
        k += n
    shape = (nblocks, 2, NG, BS, hs)
    qs, fs = ((Bo, NH, hs), (Bo, NG, hs)) if T is None else ((Bo, NH, T, hs), (Bo, NG, T, hs))
    return dict(
        q=torch.randn(qs, generator=gen, device=dev).to(dtype),
        k_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        v_arena=torch.randn(shape, generator=gen, device=dev).to(dtype),
        fresh_k=torch.randn(fs, generator=gen, device=dev).to(dtype),
        fresh_v=torch.randn(fs, generator=gen, device=dev).to(dtype),
        tables=torch.as_tensor(tables, device=dev),
        pos=torch.as_tensor(pos, device=dev),
    )


def check_head_sizes() -> None:
    """``paged_attn_decode`` and ``paged_attn_verify`` (T=5) at each of
    ODD_HEAD_SIZES against their plain versions, phase 3's bars; then
    verify at hs 80 with many rows (T=MMA_T), which takes the WMMA body, in
    bf16 and f16 and on int8 and fp8 arenas, whose kernel the profiler
    must see run, twice bitwise equal."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    for hs in ODD_HEAD_SIZES:
        for dtype in (torch.bfloat16, torch.float32):
            check_attn("paged_attn_decode", f"hs={hs}", cudaex.paged_attn_decode,
                       cudaex.paged_attn_decode_plain, odd_head_inputs(dtype, gen, hs), layer=1)
            check_attn("paged_attn_verify", f"hs={hs} T=5", cudaex.paged_attn_verify,
                       cudaex.paged_attn_verify_plain, odd_head_inputs(dtype, gen, hs, T=5),
                       layer=1)
    for dtype, storage in ((torch.bfloat16, None), (torch.float16, None),
                           (torch.bfloat16, "int8"), (torch.bfloat16, "fp8")):
        x = odd_head_inputs(dtype, gen, 80, T=MMA_T)
        if storage is not None:
            x = quantize_arenas(x, QUANT[storage])
        label = f"hs=80 T={MMA_T}{f' {storage} arena' if storage else ''}"
        check_attn("paged_attn_verify", label, cudaex.paged_attn_verify,
                   cudaex.paged_attn_verify_plain, x, layer=1)
        body = check_body_kernels("paged_attn_verify", f"{label} {str(dtype)[6:]}",
                                  lambda: cudaex.paged_attn_verify(**x, layer=1), x)
        if body != "mma":
            raise AssertionError(f"paged_attn_verify {label}: took the {body} body, not mma")


def check_chunk_write():
    """One chunk of the chunk shape (T=512 at pos 2560) through its
    192-entry scatter table, whose last entries run past the leased blocks
    (they route to the sink)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    nc, nbb = VERIFY_SHAPES["chunk"]["T"] // BS, VERIFY_SHAPES["chunk"]["nbb"]
    rng = np.random.default_rng(SEED + 3)
    leased = [int(b) for b in rng.permutation(np.arange(1, NUM_BLOCKS))[:nbb - 8]]
    pos = CHUNK_POS
    _, dest = chunk_tables(leased, pos, nc * BS, nbb, BS)
    dest_d = torch.as_tensor(dest, device=DEVICE)
    pos_d = torch.tensor([pos], dtype=torch.int32, device=DEVICE)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        arena = torch.randn((NUM_BLOCKS, L, NG, BS, HS), generator=gen, device=DEVICE).to(dtype)
        vals = torch.randn((nc, L, NG, BS, HS), generator=gen, device=DEVICE).to(dtype)
        plain = cudaex.paged_chunk_write_plain(arena.clone(), vals, dest_d, pos_d, block_size=BS)
        got = cudaex.paged_chunk_write(arena, vals, dest_d, pos_d, block_size=BS)
        torch.cuda.synchronize()
        same = bool(torch.equal(got[1:], plain[1:]))
        say(f"paged_chunk_write {str(dtype)[6:]}: bitwise equal outside block 0: {same}")
        if not same:
            raise AssertionError("paged_chunk_write disagrees with its plain version")
        if dtype == torch.bfloat16:
            # the library yardstick: one index_copy_ of the slabs, routing
            # computed beforehand
            idx = pos // BS + np.arange(nc)
            blk = torch.as_tensor(np.where(idx < nbb, dest[np.minimum(idx, nbb - 1)], 0),
                                  dtype=torch.long, device=DEVICE)
            result = timed(
                "paged_chunk_write", f" ({nc} blocks of {vals[0].numel() * 2 / 2**20:.2f} MiB)",
                lambda: cudaex.paged_chunk_write(arena, vals, dest_d, pos_d, block_size=BS),
                lambda: cudaex.paged_chunk_write_plain(arena, vals, dest_d, pos_d, block_size=BS),
                lambda: arena.index_copy_(0, blk, vals), "index_copy_",
                bound(2 * vals.numel() * vals.element_size() + 4 * nbb + 4, 0, dtype),
                iters=100, plain_iters=50)
            result["max_abs_err"] = 0.0
        del arena, vals, plain
    return result


def check_masked_write(K=4):
    """Every offset 0..K of a speculative commit with n_emit from 0 to K+1
    across the rows (padding rows carry n_emit 0), rank 5 in bf16 and f32
    and the rank-4 scale form."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, pos = decode_inputs(dtype, gen)
        tables, posd = x["tables"], x["pos"]
        arena = x.pop("k_arena")
        del x
        n_emit = torch.tensor([1, 5, 0, 3, 2, 4, 0, 5], dtype=torch.int32, device=DEVICE)
        for off in range(K + 1):
            vals = torch.randn((B, L, NG, HS), generator=gen, device=DEVICE).to(dtype)
            plain = cudaex.paged_token_write_masked_plain(arena.clone(), vals, tables, posd,
                                                          n_emit, off, block_size=BS)
            got = cudaex.paged_token_write_masked(arena, vals, tables, posd, n_emit, off,
                                                  block_size=BS)
            torch.cuda.synchronize()
            if not torch.equal(got[1:], plain[1:]):
                raise AssertionError(f"paged_token_write_masked offset {off} disagrees with "
                                     "its plain version")
        say(f"paged_token_write_masked {str(dtype)[6:]}: bitwise equal outside block 0 at "
            f"offsets 0..{K}")
        if dtype == torch.bfloat16:
            off = 2
            # the library yardstick: one index_put_ with the routing computed
            # beforehand (rejected rows to block 0, slot 0)
            p = posd.long() + off
            live = off < n_emit.long()
            blk = torch.where(live, tables.long().gather(1, (p // BS)[:, None])[:, 0], 0)
            slot = torch.where(live, p % BS, 0)
            rows = torch.arange(L * NG, device=DEVICE)[None, :]
            view = arena.view(NUM_BLOCKS, L * NG, BS, HS)
            idx = (blk[:, None].expand(B, L * NG), rows.expand(B, L * NG),
                   slot[:, None].expand(B, L * NG))
            v3 = vals.reshape(B, L * NG, HS)
            result = timed(
                "paged_token_write_masked", f" (offset {off})",
                lambda: cudaex.paged_token_write_masked(arena, vals, tables, posd, n_emit, off,
                                                        block_size=BS),
                lambda: cudaex.paged_token_write_masked_plain(arena, vals, tables, posd, n_emit,
                                                              off, block_size=BS),
                lambda: view.index_put_(idx, v3), "index_put_",
                bound(2 * vals.numel() * vals.element_size() + 4 * tables.numel() + 8 * B, 0,
                      dtype),
                iters=500, plain_iters=100,
                device_kernel="paged_token_write_kernel")   # the kernel both writes share
            result["max_abs_err"] = 0.0
        del arena
    scale = torch.randn((NUM_BLOCKS, L, NG, BS), generator=gen, device=DEVICE)
    svals = torch.randn((B, L, NG), generator=gen, device=DEVICE)
    plain = cudaex.paged_token_write_masked_plain(scale.clone(), svals, tables, posd, n_emit, 1,
                                                  block_size=BS)
    got = cudaex.paged_token_write_masked(scale, svals, tables, posd, n_emit, 1, block_size=BS)
    torch.cuda.synchronize()
    same = bool(torch.equal(got[1:], plain[1:]))
    say(f"paged_token_write_masked rank-4 f32: bitwise equal outside block 0: {same}")
    if not same:
        raise AssertionError("paged_token_write_masked (rank 4) disagrees with its plain version")
    return result


#
# phase 3, continued: the engine's pair writes, K and V of a decode step or
# of every offset of a verify round in one launch of the token-write kernel
#

# device ms per call at most: the decode step's pair (a 0.63 us bound), the
# K=4 round's (3.14 us: at least half of it), the 512-token int8/fp8 chunk
# piece's fused pair, every launch summed (30.36 us: at least half of it);
# and the step pair's CUDA-event time, the median of PAIR_EVENT_ROUNDS rounds
# of 200 calls taken after the build, before the process's first profile
PAIR_DEVICE_MAX_MS = {"step": 0.0030, "round": 0.0063, "chunk": 0.0607}
PAIR_STEP_EVENT_MAX_MS = 0.030
PAIR_EVENT_ROUNDS = 5
N_EMIT_ROUND = [1, 5, 0, 3, 2, 4, 0, 5]        # accepted counts of a K=4 round, 0 to K+1
# the quantized pairs (int8/fp8, every launch summed): the decode step's (a
# 0.49 us bound from bf16 values) and the K=4 round's (2.46 us), device ms
# at most, and the int8 step's CUDA-event median (bf16 values), the bf16
# pair's bar; the bf16 chunk pair's device ms at most (a 40.07 us bound)
Q_PAIR_DEVICE_MAX_MS = {"step": 0.0035, "round": 0.008}
Q_PAIR_STEP_EVENT_MAX_MS = 0.030
CHUNK_PAIR_DEVICE_MAX_MS = 0.050
# a multi-step iteration's per-row liveness: the padding rows 2 and 6 and a
# finished row 4 dead
LIVE_STEP = [1, 1, 0, 1, 0, 1, 0, 1]


def pair_inputs(dtype, gen, T, rank=5):
    """K and V arenas (rank 5 of the decode shape, or the rank-4 scale
    form), the values of T offsets ((B, L, ng, hs) at T = 1, as a decode
    step's forward returns them, else (B, L, ng, T, hs)), tables and
    positions: the decode inputs at T = 1, the spec shape's (tables covering
    pos + T, padding rows) at T = 5."""
    x, _ = (decode_inputs(dtype, gen) if T == 1
            else verify_inputs(dtype, gen, **VERIFY_SHAPES["spec"]))
    tables, pos = x["tables"], x["pos"]
    if rank == 5:
        arenas = [x.pop("k_arena"), x.pop("v_arena")]
        vshape = (B, L, NG, T, HS)
    else:
        arenas = [torch.randn((NUM_BLOCKS, L, NG, BS), generator=gen, device=DEVICE)
                  for _ in range(2)]
        vshape = (B, L, NG, T)
    del x
    vals = [torch.randn(vshape, generator=gen, device=DEVICE).to(dtype) for _ in range(2)]
    if T == 1:
        vals = [v[:, :, :, 0] for v in vals]
    return arenas, vals, tables, pos


def pair_bound(vals, tables, masked: bool):
    """Each value read once and written once, in both arenas; tables,
    positions (and n_emit)."""
    n = sum(v.numel() * v.element_size() for v in vals)
    return bound(2 * n + 4 * tables.numel() + 4 * B * (2 if masked else 1), 0, torch.bfloat16)


def pair_event_rounds() -> list:
    """The decode step pair's CUDA-event ms (bf16, B=8) in PAIR_EVENT_ROUNDS
    rounds of 200 calls, before the process's first profiler session (as
    ``lora_event_rounds``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    arenas, vals, tables, pos = pair_inputs(torch.bfloat16, gen, 1)
    rounds = [time_ms(lambda: cudaex.paged_token_write_pair(*arenas, *vals, tables, pos,
                                                            block_size=BS), iters=200)
              for _ in range(PAIR_EVENT_ROUNDS)]
    del arenas, vals
    return rounds


def check_pair_writes(event_rounds: list) -> dict:
    """``paged_token_write_pair`` at the decode step (B=8, T=1) and at a K=4
    verify round (B=8, T=5, n_emit N_EMIT_ROUND, padding rows), rank 5 in
    bf16 and f32 and the rank-4 scale form: both arenas bitwise equal to
    the plain version outside sink block 0 (every offset), two calls
    bitwise equal there too; then the bf16 times, the device bars
    PAIR_DEVICE_MAX_MS and the step's CUDA-event bar (rounds taken before
    the first profile).  Returns the step and round records."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    n_emit = torch.tensor(N_EMIT_ROUND, dtype=torch.int32, device=DEVICE)
    result = {}
    for kind, T in (("step", 1), ("round", 5)):
        kw = {} if kind == "step" else {"n_emit": n_emit}
        for rank, dtype in ((5, torch.bfloat16), (5, torch.float32), (4, torch.float32)):
            arenas, vals, tables, pos = pair_inputs(dtype, gen, T, rank)
            want = cudaex.paged_token_write_pair_plain(*(a.clone() for a in arenas), *vals,
                                                       tables, pos, block_size=BS, **kw)
            got = cudaex.paged_token_write_pair(*(a.clone() for a in arenas), *vals, tables,
                                                pos, block_size=BS, **kw)
            again = cudaex.paged_token_write_pair(*(a.clone() for a in arenas), *vals, tables,
                                                  pos, block_size=BS, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(g[1:], w[1:]) for g, w in zip(got, want))
            # outside the sink too: padding rows race on its slot 0
            twice = all(torch.equal(g[1:], a[1:]) for g, a in zip(got, again))
            say(f"paged_token_write_pair {kind} (T={T}) rank {rank} {str(dtype)[6:]}: K and V "
                f"bitwise equal to the plain version outside block 0: {same}; two calls "
                f"bitwise equal: {twice} {'ok' if same and twice else 'FAIL'}")
            if not (same and twice):
                raise AssertionError(f"paged_token_write_pair {kind} rank {rank} {dtype} "
                                     "disagrees with its plain version or with itself")
            del want, got, again
            if rank == 5 and dtype == torch.bfloat16:
                rec = timed(
                    "paged_token_write_kernel", f" pair: K+V, B={B}, T={T}"
                    + (f", n_emit {N_EMIT_ROUND}" if kw else ""),
                    lambda: cudaex.paged_token_write_pair(*arenas, *vals, tables, pos,
                                                          block_size=BS, **kw),
                    lambda: cudaex.paged_token_write_pair_plain(*arenas, *vals, tables, pos,
                                                                block_size=BS, **kw),
                    None, None, pair_bound(vals, tables, bool(kw)), iters=500, plain_iters=50)
                rec["max_abs_err"] = 0.0
                result[kind] = rec
            del arenas, vals
    result["step"]["event_rounds_ms"] = event_rounds
    event_ms = statistics.median(event_rounds)
    ok = event_ms <= PAIR_STEP_EVENT_MAX_MS and all(
        result[k]["device_ms"] is not None and result[k]["device_ms"] <= PAIR_DEVICE_MAX_MS[k]
        for k in ("step", "round"))
    say(f"paged_token_write_pair times: device ms step {result['step']['device_ms']}, round "
        f"{result['round']['device_ms']} (at most {PAIR_DEVICE_MAX_MS['step']} / "
        f"{PAIR_DEVICE_MAX_MS['round']}); step CUDA-event {event_ms:.4f} ms, the median of "
        f"rounds {[round(t, 4) for t in event_rounds]} taken before the first profile (at most "
        f"{PAIR_STEP_EVENT_MAX_MS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("paged_token_write_pair missed a time bar")
    return result


def check_chunk_pair() -> dict:
    """``paged_chunk_write_pair``, the engine's bf16 chunk write: K and V of
    a 512-token piece read in place from the forward's (1, L, ng, T, hs)
    values, at CHUNK_POS through the 192-entry table (its last 8 entries
    sink) and at CHUNK_POS + 256 (16 chunk blocks past the table, into the
    sink), bf16 and f32: both arenas bitwise equal to the plain version
    outside sink block 0, two calls bitwise equal there too; then the bf16
    times at CHUNK_POS, the device bar CHUNK_PAIR_DEVICE_MAX_MS."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    nc, nbb = VERIFY_SHAPES["chunk"]["T"] // BS, VERIFY_SHAPES["chunk"]["nbb"]
    rng = np.random.default_rng(SEED + 3)
    leased = [int(b) for b in rng.permutation(np.arange(1, NUM_BLOCKS))[:nbb - 8]]
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        base = [torch.randn((NUM_BLOCKS, L, NG, BS, HS), generator=gen, device=DEVICE).to(dtype)
                for _ in range(2)]
        fresh = [torch.randn((1, L, NG, nc * BS, HS), generator=gen, device=DEVICE).to(dtype)
                 for _ in range(2)]
        for p in (CHUNK_POS, CHUNK_POS + 256):
            _, dest = chunk_tables(leased, p, nc * BS, nbb, BS)
            dest_d = torch.as_tensor(dest, device=DEVICE)
            pos_d = torch.tensor([p], dtype=torch.int32, device=DEVICE)

            def run(fn):
                return fn(*(a.clone() for a in base), *fresh, dest_d, pos_d, block_size=BS)

            want = run(cudaex.paged_chunk_write_pair_plain)
            got = run(cudaex.paged_chunk_write_pair)
            again = run(cudaex.paged_chunk_write_pair)
            torch.cuda.synchronize()
            same = all(torch.equal(g[1:], w[1:]) for g, w in zip(got, want))
            twice = all(torch.equal(g[1:], a[1:]) for g, a in zip(got, again))
            say(f"paged_chunk_write_pair {str(dtype)[6:]} at pos {p} ({nc} blocks, table of "
                f"{nbb}): K and V bitwise equal to the plain version outside block 0: {same}; "
                f"two calls bitwise equal: {twice} {'ok' if same and twice else 'FAIL'}")
            if not (same and twice):
                raise AssertionError(f"paged_chunk_write_pair {dtype} at pos {p} disagrees with "
                                     "its plain version or with itself")
            del want, got, again
        if dtype == torch.bfloat16:
            _, dest = chunk_tables(leased, CHUNK_POS, nc * BS, nbb, BS)
            dest_d = torch.as_tensor(dest, device=DEVICE)
            pos_d = torch.tensor([CHUNK_POS], dtype=torch.int32, device=DEVICE)
            n = fresh[0].numel() * fresh[0].element_size()
            result = timed(
                "paged_chunk_write", f" pair: K+V, {nc} blocks read in place",
                lambda: cudaex.paged_chunk_write_pair(*base, *fresh, dest_d, pos_d,
                                                      block_size=BS),
                lambda: cudaex.paged_chunk_write_pair_plain(*base, *fresh, dest_d, pos_d,
                                                            block_size=BS),
                None, None, bound(2 * 2 * n + 4 * nbb + 4, 0, dtype), iters=100, plain_iters=10)
            result["max_abs_err"] = 0.0
            ok = result["device_ms"] is not None and result["device_ms"] <= CHUNK_PAIR_DEVICE_MAX_MS
            say(f"paged_chunk_write_pair bf16: device {result['device_ms']} ms (at most "
                f"{CHUNK_PAIR_DEVICE_MAX_MS}; bound {1e3 * result['bound_ms']:.3f} us) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("paged_chunk_write_pair missed its time bar")
        del base, fresh
    return result


#
# phase 3, continued: quantized KV (kv_dtype int8 / fp8) — the dequantizing
# attention kernels and the fused quantizing writes
#

QUANT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# the fused chunk write's error sums: f32 sums in another order
ERR_SUMS_REL = 1e-5


def quantize_arenas(x, storage):
    """``x`` with its K/V arenas quantized into ``storage`` and their
    scales beside them: what a quantized pool holds."""
    out = dict(x)
    for name in ("k", "v"):
        q, s = quantize_kv(out.pop(f"{name}_arena"), storage)
        out[f"{name}_arena"], out[f"{name}_scale"] = q, s
    return out


def quant_attn_bound(pos, T, nbb, dtype):
    """Bound of a dequantizing attention call: the live 1-byte K/V and
    their float32 scales read once, q in and out, the fresh K/V, tables and
    positions; the products as the float kernels count them."""
    esize = torch.empty((), dtype=dtype).element_size()
    Bv, slots = len(pos), int(pos.sum())
    nbytes = (2 * slots * NG * HS + 2 * slots * NG * 4         # K/V bytes and scales
              + 2 * Bv * NH * T * HS * esize + 2 * Bv * NG * T * HS * esize
              + 4 * Bv * nbb + 4 * Bv)
    ops = 4 * NH * HS * (slots * T + Bv * T * (T + 1) // 2)
    return bound(nbytes, ops, dtype)


def _cast_inputs(x, dtype):
    return {k: v.to(dtype) if k in ("q", "fresh_k", "fresh_v") else v for k, v in x.items()}


def check_decode_quant(layer=L - 3):
    """``paged_attn_decode`` on int8 and fp8 arenas at the decode shape:
    float32 within ATOL_F32 of the plain version, bf16 by the ratio bar,
    the split body's kernels seen by the profiler, twice bitwise equal;
    then the bf16 times."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    result = {}
    for kind, storage in QUANT.items():
        x, pos = decode_inputs(torch.bfloat16, gen)
        xq = quantize_arenas(x, storage)
        del x
        for dtype in (torch.bfloat16, torch.float32):
            xd = _cast_inputs(xq, dtype)
            err = check_attn("paged_attn_decode", f"{kind} arena", cudaex.paged_attn_decode,
                             cudaex.paged_attn_decode_plain, xd, layer=layer)
            if dtype == torch.bfloat16:
                def kernel():
                    return cudaex.paged_attn_decode(**xd, layer=layer)

                body = check_body_kernels("paged_attn_decode", f"{kind} arena", kernel, xd)
                rec = timed(
                    "paged_attn_decode", f" {kind} arena", kernel,
                    lambda: cudaex.paged_attn_decode_plain(**xd, layer=layer),
                    None, None, quant_attn_bound(pos, 1, NBB, dtype), iters=200, plain_iters=10,
                    plain_warmup=1, **device_names("paged_attn_decode", xd))
                rec.update(max_abs_err=err, body=body)
                result[kind] = rec
            del xd
        del xq
    return result


def check_verify_quant(layer=L - 3):
    """``paged_attn_verify`` on int8 and fp8 arenas at the spec and chunk
    shapes, bf16 (the split and warpgroup bodies, whose kernels the
    profiler must see run, twice bitwise equal) and float32; then the bf16
    times."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    result = {}
    for kind, storage in QUANT.items():
        result[kind] = {}
        for shape, dims in VERIFY_SHAPES.items():
            x, pos = verify_inputs(torch.bfloat16, gen, **dims)
            xq = quantize_arenas(x, storage)
            del x
            for dtype in (torch.bfloat16, torch.float32):
                xd = _cast_inputs(xq, dtype)
                err = check_attn("paged_attn_verify",
                                 f"{kind} arena, {shape} B={dims['Bv']} T={dims['T']}",
                                 cudaex.paged_attn_verify, cudaex.paged_attn_verify_plain, xd,
                                 layer=layer)
                if dtype == torch.bfloat16:
                    def kernel():
                        return cudaex.paged_attn_verify(**xd, layer=layer)

                    body = check_body_kernels("paged_attn_verify", f"{kind} arena, {shape}",
                                              kernel, xd)
                    rec = timed(
                        "paged_attn_verify", f" {kind} arena B={dims['Bv']} T={dims['T']}",
                        kernel, lambda: cudaex.paged_attn_verify_plain(**xd, layer=layer),
                        None, None, quant_attn_bound(pos, dims["T"], dims["nbb"], dtype),
                        iters=50, plain_iters=3, plain_warmup=1,
                        **device_names("paged_attn_verify", xd))
                    rec.update(max_abs_err=err, body=body)
                    result[kind][shape] = rec
                del xd
            del xq
    return result


def q_pair_case(kind: str, label: str, gen):
    """Quantized K and V arenas of the decode shape with their scales, and
    the tables, positions and n_emit of a decode step (``"step"``, the decode
    inputs), a multi-step iteration (``"live"``: the same, n_emit LIVE_STEP)
    or a K=4 round (``"round"``: the spec shape's, n_emit N_EMIT_ROUND);
    returns ``(arenas, scales, tables, pos, n_emit, T)``."""
    T = 5 if label == "round" else 1
    x, _ = (decode_inputs(torch.bfloat16, gen) if T == 1
            else verify_inputs(torch.bfloat16, gen, **VERIFY_SHAPES["spec"]))
    tables, pos = x["tables"], x["pos"]
    q = [quantize_kv(x.pop(name), QUANT[kind]) for name in ("k_arena", "v_arena")]
    del x
    n_emit = {"step": None, "live": LIVE_STEP, "round": N_EMIT_ROUND}[label]
    if n_emit is not None:
        n_emit = torch.tensor(n_emit, dtype=torch.int32, device=DEVICE)
    return [a for a, _ in q], [s for _, s in q], tables, pos, n_emit, T


def q_pair_vals(gen, T: int, dtype, zero_head: bool = True) -> list:
    """K and V values of T offsets as the forward returns them: (B, L, ng,
    hs) at T = 1, else (B, L, ng, T, hs); with ``zero_head`` one all-zero
    slot-head (the checks' edge case; the times are taken without it, on
    values like the engine's fresh K/V, which hold no exact zeros)."""
    shape = (B, L, NG, HS) if T == 1 else (B, L, NG, T, HS)
    vals = [(3 * torch.randn(shape, generator=gen, device=DEVICE)).to(dtype) for _ in range(2)]
    if zero_head:
        vals[0][1, 0, 0] = 0.0
    return vals


def q_pair_bound(vals, tables, masked: bool):
    """Each value read once, its byte and its slot-head's scale written
    once, in both arenas; tables, positions (and n_emit)."""
    n = vals[0].numel()
    nbytes = 2 * (n * vals[0].element_size() + n + n // HS * 4)
    return bound(nbytes + 4 * tables.numel() + 4 * B * (2 if masked else 1), 0, torch.bfloat16)


def q_pair_event_rounds() -> list:
    """The int8 decode step pair's CUDA-event ms (bf16 values, B=8) in
    PAIR_EVENT_ROUNDS rounds of 200 calls, before the process's first
    profiler session (as ``pair_event_rounds``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    arenas, scales, tables, pos, _, _ = q_pair_case("int8", "step", gen)
    vals = q_pair_vals(gen, 1, torch.bfloat16, zero_head=False)
    rounds = [time_ms(lambda: cudaex.paged_token_write_fused_pair(*arenas, *scales, *vals, tables,
                                                                  pos, block_size=BS), iters=200)
              for _ in range(PAIR_EVENT_ROUNDS)]
    del arenas, scales, vals
    return rounds


def check_q_pair_writes(event_rounds: list) -> dict:
    """``paged_token_write_fused_pair`` into int8 and fp8 arenas, from bf16
    and float32 values: a decode step (B=8, T=1), a multi-step iteration
    (T=1, n_emit LIVE_STEP) and a K=4 round read in place (B=8, T=5, n_emit
    N_EMIT_ROUND: 0 to K+1, padding rows); both arenas' stored bytes and
    scales bitwise equal to the plain version outside sink block 0, two
    calls bitwise equal there too.  Then the bf16-value times of the step
    and the round (on values without the zero slot-head), the device bars Q_PAIR_DEVICE_MAX_MS and the int8 step's
    CUDA-event bar (rounds taken before the first profile).  Returns the
    records by kind and label."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    result = {}
    for kind, storage in QUANT.items():
        result[kind] = {}
        for label in ("step", "live", "round"):
            arenas, scales, tables, pos, n_emit, T = q_pair_case(kind, label, gen)
            kw = {} if n_emit is None else {"n_emit": n_emit}
            for dtype in (torch.bfloat16, torch.float32):
                vals = q_pair_vals(gen, T, dtype)

                def run(fn):
                    return fn(*(a.clone() for a in arenas), *(s.clone() for s in scales), *vals,
                              tables, pos, block_size=BS, **kw)

                def raw(t):
                    return t.view(torch.uint8) if t.dtype == storage else t

                want = run(cudaex.paged_token_write_fused_pair_plain)
                got = run(cudaex.paged_token_write_fused_pair)
                again = run(cudaex.paged_token_write_fused_pair)
                torch.cuda.synchronize()
                same = all(torch.equal(raw(g)[1:], raw(w)[1:]) for g, w in zip(got, want))
                # outside the sink too: padding rows and rejected offsets race there
                twice = all(torch.equal(raw(g)[1:], raw(a)[1:]) for g, a in zip(got, again))
                say(f"paged_token_write_fused_pair {kind} {label} (T={T}) from "
                    f"{str(dtype)[6:]}: stored bytes and scales of K and V bitwise equal to the "
                    f"plain version outside block 0: {same}; two calls bitwise equal: {twice} "
                    f"{'ok' if same and twice else 'FAIL'}")
                if not (same and twice):
                    raise AssertionError(f"paged_token_write_fused_pair {kind} {label} {dtype} "
                                         "disagrees with its plain version or with itself")
                del want, got, again
                if dtype == torch.bfloat16 and label != "live":
                    vals = q_pair_vals(gen, T, dtype, zero_head=False)
                    rec = timed(
                        "paged_token_write_q", f" {kind} pair: K+V, B={B}, T={T}"
                        + (f", n_emit {N_EMIT_ROUND}" if kw else ""),
                        lambda: cudaex.paged_token_write_fused_pair(*arenas, *scales, *vals,
                                                                    tables, pos, block_size=BS,
                                                                    **kw),
                        lambda: cudaex.paged_token_write_fused_pair_plain(
                            *arenas, *scales, *vals, tables, pos, block_size=BS, **kw),
                        None, None, q_pair_bound(vals, tables, bool(kw)), iters=500,
                        plain_iters=20)
                    rec["max_abs_err"] = 0.0
                    result[kind][label] = rec
                del vals
            del arenas, scales
    result["int8"]["step"]["event_rounds_ms"] = event_rounds
    event_ms = statistics.median(event_rounds)
    device = {f"{kind} {label}": result[kind][label]["device_ms"]
              for kind in QUANT for label in ("step", "round")}
    ok = event_ms <= Q_PAIR_STEP_EVENT_MAX_MS and all(
        ms is not None and ms <= Q_PAIR_DEVICE_MAX_MS[key.split()[1]] for key, ms in device.items())
    say(f"paged_token_write_fused_pair times: device ms {device} (at most "
        f"{Q_PAIR_DEVICE_MAX_MS}); int8 step CUDA-event {event_ms:.4f} ms, the median of rounds "
        f"{[round(t, 4) for t in event_rounds]} taken before the first profile (at most "
        f"{Q_PAIR_STEP_EVENT_MAX_MS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("paged_token_write_fused_pair missed a time bar")
    return result


def check_token_write_fused(K=4):
    """``paged_token_write_fused`` at B=8 into int8 and fp8 arenas of the
    decode shape: the plain write and the masked one at every offset 0..K
    with n_emit from 0 to K+1, stored bytes and scales bitwise equal to the
    plain version's outside sink block 0; then the plain write's times."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    x, _ = decode_inputs(torch.bfloat16, gen)
    tables, posd = x["tables"], x["pos"]
    base = x.pop("k_arena")
    del x
    n_emit = torch.tensor([1, 5, 0, 3, 2, 4, 0, 5], dtype=torch.int32, device=DEVICE)
    result = {}
    for kind, storage in QUANT.items():
        arena, scale = quantize_kv(base, storage)
        for off in (None, *range(K + 1)):
            vals = (3 * torch.randn((B, L, NG, HS), generator=gen, device=DEVICE)).to(
                torch.bfloat16)
            vals[0, 0, 0] = 0.0                                  # an all-zero vector
            kw = {} if off is None else dict(n_emit=n_emit, offset=off)
            wa, ws = cudaex.paged_token_write_fused_plain(arena.clone(), scale.clone(), vals,
                                                          tables, posd, block_size=BS, **kw)
            ga, gs = cudaex.paged_token_write_fused(arena, scale, vals, tables, posd,
                                                    block_size=BS, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(ga.view(torch.uint8)[1:], wa.view(torch.uint8)[1:])
                    and torch.equal(gs[1:], ws[1:])):
                raise AssertionError(f"paged_token_write_fused {kind} offset {off} disagrees "
                                     "with its plain version")
            del wa, ws
        say(f"paged_token_write_fused {kind}: stored bytes and scales bitwise equal outside "
            f"block 0, plain write and masked offsets 0..{K}")
        # bf16 values in; bytes and scales out; tables, positions
        nbytes = (B * L * NG * HS * 2 + B * L * NG * HS + B * L * NG * 4
                  + 4 * tables.numel() + 4 * B)
        rec = timed(
            "paged_token_write_fused", f" {kind} (B={B})",
            lambda: cudaex.paged_token_write_fused(arena, scale, vals, tables, posd,
                                                   block_size=BS),
            lambda: cudaex.paged_token_write_fused_plain(arena, scale, vals, tables, posd,
                                                         block_size=BS),
            None, None, bound(nbytes, 0, torch.bfloat16), iters=500, plain_iters=100,
            device_kernel="paged_token_write_q")   # the pair's kernel, one arena
        rec["max_abs_err"] = 0.0
        result[kind] = rec
        del arena, scale
    return result


def check_chunk_write_fused():
    """One chunk piece of the chunk shape (T=512 at pos 2560, 32 blocks)
    through its 192-entry scatter table into int8 and fp8 arenas: the
    single-arena ``paged_chunk_write_fused`` (the reference's signature, the
    values folded into block granules) and the engine's
    ``paged_chunk_write_fused_pair`` (K and V in one pass, reading the
    forward's (1, L, ng, T, hs) values in place): bytes and scales bitwise
    equal to the plain versions' outside sink block 0, the error sums
    within ERR_SUMS_REL, rel_err in (0, 0.05), the pair's two calls bitwise
    equal (bytes outside the sink, sums whole); then times, every launch of
    a call summed, the pair's device time within PAIR_DEVICE_MAX_MS["chunk"]."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    nc, nbb = VERIFY_SHAPES["chunk"]["T"] // BS, VERIFY_SHAPES["chunk"]["nbb"]
    rng = np.random.default_rng(SEED + 3)
    leased = [int(b) for b in rng.permutation(np.arange(1, NUM_BLOCKS))[:nbb - 8]]
    _, dest = chunk_tables(leased, CHUNK_POS, nc * BS, nbb, BS)
    dest_d = torch.as_tensor(dest, device=DEVICE)
    pos_d = torch.tensor([CHUNK_POS], dtype=torch.int32, device=DEVICE)
    result = {}

    def held(label, got, want, twice=True):
        """Bytes and scales (outside block 0) bitwise, sums within
        ERR_SUMS_REL, rel_err of each arena in (0, 0.05)."""
        *ga, gerr = got
        *wa, werr = want
        same = all(torch.equal(g.view(torch.uint8)[1:], w.view(torch.uint8)[1:])
                   for g, w in zip(ga, wa))
        sums_rel = ((gerr - werr).abs() / werr.abs().clamp_min(1e-30)).max().item()
        e = gerr.reshape(-1, nc, 2)
        rels = [(x[:, 0].sum() / (x[:, 1].sum() + 1e-30)).item() for x in e]
        ok = same and twice and sums_rel <= ERR_SUMS_REL and all(0.0 < r < 0.05 for r in rels)
        say(f"{label}: bytes and scales bitwise equal outside block 0: {same}; two calls "
            f"bitwise equal: {twice}; error sums max relative difference {sums_rel:.2e} (bar "
            f"{ERR_SUMS_REL}); rel_err {[round(r, 5) for r in rels]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its plain version or with itself")
        return sums_rel

    for kind, storage in QUANT.items():
        base = [quantize_kv(torch.randn((NUM_BLOCKS, L, NG, BS, HS), generator=gen,
                                        device=DEVICE), storage) for _ in range(2)]
        fresh = [(3 * torch.randn((1, L, NG, nc * BS, HS), generator=gen, device=DEVICE)).to(
            torch.bfloat16) for _ in range(2)]
        # the single-arena entry on K, the values folded into block granules
        arena, scale = base[0][0].clone(), base[0][1].clone()
        vals = cudaex.chunk_blocks(fresh[0], BS)
        want = cudaex.paged_chunk_write_fused_plain(arena.clone(), scale.clone(), vals, dest_d,
                                                    pos_d, block_size=BS)
        got = cudaex.paged_chunk_write_fused(arena, scale, vals, dest_d, pos_d, block_size=BS)
        torch.cuda.synchronize()
        single_err = held(f"paged_chunk_write_fused {kind}", got, want)
        del want, got
        n = vals.numel()
        nbytes = 2 * n + n + (n // HS) * 4 + 4 * nbb + 4 + nc * 2 * 4
        single = timed(
            "paged_chunk_write_fused", f" {kind} ({nc} blocks, one arena)",
            lambda: cudaex.paged_chunk_write_fused(arena, scale, vals, dest_d, pos_d,
                                                   block_size=BS),
            lambda: cudaex.paged_chunk_write_fused_plain(arena, scale, vals, dest_d, pos_d,
                                                         block_size=BS),
            None, None, bound(nbytes, 0, torch.bfloat16), iters=100, plain_iters=20,
            device_also=("chunk_err_reduce",), device_whole=True)
        single["max_abs_err"] = single_err
        del arena, scale, vals

        # the engine's pair: K and V in one pass off the (1, L, ng, T, hs) values

        def pair_args():
            return (base[0][0].clone(), base[1][0].clone(), base[0][1].clone(),
                    base[1][1].clone(), *fresh, dest_d, pos_d)

        want = cudaex.paged_chunk_write_fused_pair_plain(*pair_args(), block_size=BS)
        got = cudaex.paged_chunk_write_fused_pair(*pair_args(), block_size=BS)
        again = cudaex.paged_chunk_write_fused_pair(*pair_args(), block_size=BS)
        torch.cuda.synchronize()
        # bytes and scales outside the sink (chunk blocks past the table race
        # there), the error sums whole
        twice = (all(torch.equal(g.view(torch.uint8)[1:], a.view(torch.uint8)[1:])
                     for g, a in zip(got[:4], again[:4]))
                 and torch.equal(got[4], again[4]))
        sums_rel = held(f"paged_chunk_write_fused_pair {kind}", got, want, twice)
        del want, got, again
        args = pair_args()
        rec = timed(
            "paged_chunk_write_fused", f" {kind} pair: K+V, {nc} blocks",
            lambda: cudaex.paged_chunk_write_fused_pair(*args, block_size=BS),
            lambda: cudaex.paged_chunk_write_fused_pair_plain(*args, block_size=BS),
            None, None, bound(2 * (nbytes - 4 * nbb - 4) + 4 * nbb + 4, 0, torch.bfloat16),
            iters=100, plain_iters=10,
            device_also=("chunk_err_reduce",), device_whole=True)
        rec.update(max_abs_err=sums_rel, single=single)
        ok = rec["device_ms"] is not None and rec["device_ms"] <= PAIR_DEVICE_MAX_MS["chunk"]
        say(f"paged_chunk_write_fused_pair {kind}: device {rec['device_ms']} ms, every launch "
            f"summed (at most {PAIR_DEVICE_MAX_MS['chunk']}; bound "
            f"{1e3 * rec['bound_ms']:.3f} us) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged_chunk_write_fused_pair {kind} missed its time bar")
        result[kind] = rec
        del args, base, fresh
    return result


#
# phase 3, continued: the adapter delta of LoRA serving and the training
# step's cross-entropy
#

# the per-request delta at the serving shapes: decode (B=8, T=1), verify
# (B=8, T=5) and a prefill chunk (B=1, T=512); wq (4096 -> 4096), wk (4096 ->
# 1024) and wo (4096 -> 4096) of Llama-3-8B
LORA_SHAPES = {"decode": (8, 1), "verify": (8, 5), "chunk": (1, 512)}
LORA_TARGETS = {"wq": (NH * HS, NH * HS), "wk": (NH * HS, NG * HS), "wo": (NH * HS, NH * HS)}
LORA_RANKS = (8, 16, 64, 128, 256)      # 128, 256: two and four of phase 2's 64-rank chunks
LORA_SCALING = 2.0                      # alpha 32 over rank 16, the serves' registry
# float32 delta: the same products summed in another order, within this
# share of the output's largest magnitude
LORA_REL_F32 = 1e-5
# the kernels of each body (``cudaex.lora_plan``), as the profiler names them
LORA_BODY_KERNELS = {"mma": ("lora_delta_d_mma", "lora_delta_fold", "lora_delta_out_mma"),
                     "fma": ("lora_delta_d_fma", "lora_delta_out_fma")}
# device ms per call (wq, rank 16, bf16 x, float32 factors) at most, and
# the decode call's CUDA-event ms; the slot read's device time at most this
# share of the gathered call's
LORA_DEVICE_MAX_MS = {"decode": 0.008, "verify": 0.010, "chunk": 0.020, "decode r=128": 0.030}
LORA_DECODE_EVENT_MAX_MS = 0.030
LORA_EVENT_ROUNDS = 5                   # rounds of 200 calls; a host's stall moves one
LORA_SLOT_TIME_RATIO = 1.1
LORA_SLOT_ROUNDS = 5                    # alternate rounds of the slot read's time bar
LORA_ARENA_SLOTS = [1, 2, 0, 3, 1, 2, 0, 3]   # 8 requests over 4 slots, slot 0 the base


def lora_bound(B_, T, fin, fout, r, x_dtype, f_dtype, n_factors=None):
    """x, the factors of ``n_factors`` requests (default every request)
    and the output, once each; the two products' operations."""
    xb = torch.empty((), dtype=x_dtype).element_size()
    fb = torch.empty((), dtype=f_dtype).element_size()
    nf = B_ if n_factors is None else n_factors
    nbytes = B_ * T * fin * xb + nf * r * (fin + fout) * fb + B_ * T * fout * xb
    return bound(nbytes, 2 * B_ * T * r * (fin + fout), x_dtype)


def lora_inputs(gen, B_, T, fin, fout, r, x_dtype, f_dtype):
    """Unit activations, factors of std 0.05 (the serves' adapters); rows 2
    and 6 of a batch of 8 ride the base slot (zero factors)."""
    x = torch.randn((B_, T, fin), generator=gen, device=DEVICE).to(x_dtype)
    a = (0.05 * torch.randn((B_, r, fin), generator=gen, device=DEVICE)).to(f_dtype)
    b = (0.05 * torch.randn((B_, fout, r), generator=gen, device=DEVICE)).to(f_dtype)
    base = [2, 6] if B_ == 8 else []
    a[base], b[base] = 0, 0
    return x, a, b, base


def lora_kernels(x, a) -> tuple:
    """The kernels a call on ``x`` and ``a`` launches, last first
    (``timed``'s device kernel, then the rest)."""
    B_, T, fin = x.shape
    return LORA_BODY_KERNELS[cudaex.lora_plan(B_, T, fin, a.shape[1], x.dtype)["body"]][::-1]


def lora_kernels_seen(fn, x, a, label) -> list:
    """The profiler must see every kernel of the body a call on ``x`` and
    ``a`` takes."""
    want, seen = lora_kernels(x, a), []
    for _ in range(3):         # a short profile now and then records no kernel at all
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        seen = sorted({e.key for e in prof.key_averages() if "lora_delta" in e.key})
        if all(any(k in e for e in seen) for k in want):
            break
    ok = all(any(k in e for e in seen) for k in want)
    say(f"lora_delta_fused {label}: kernels seen {[e[:60] for e in seen]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"lora_delta_fused {label}: the profiler did not see the kernels "
                             f"{want}")
    return seen


def lora_timed(label, x, a, b, bound_ms_by, slots=None):
    """``timed`` for ``lora_delta_fused`` (the device time of every kernel
    of its body), with the time of two ``torch.bmm`` calls over the
    gathered factors (cast to x's dtype beforehand) beside it as an
    unbarred reference."""
    last, *rest = lora_kernels(x, a)
    rec = timed("lora_delta_fused", label,
                lambda: cudaex.lora_delta_fused(x, a, b, LORA_SCALING, slots=slots),
                lambda: cudaex.lora_delta_fused_plain(x, a, b, LORA_SCALING, slots),
                None, None, bound_ms_by, iters=200, plain_iters=50,
                device_kernel=last, device_also=tuple(rest), device_whole=True)
    call = functools.partial(cudaex.lora_delta_fused, x, a, b, LORA_SCALING, slots=slots)
    rec["kernels_device_ms"] = {k: device_ms(call, k, whole=True) for k in (last, *rest)}
    idx = slots.long() if slots is not None else None
    ag = (a if idx is None else a[idx]).to(x.dtype).transpose(1, 2)
    bg = (b if idx is None else b[idx]).to(x.dtype).transpose(1, 2)
    rec["bmm_ms"] = time_ms(lambda: torch.bmm(torch.bmm(x, ag), bg), iters=200)
    say(f"lora_delta_fused{label}: device ms by kernel {rec['kernels_device_ms']}; two torch.bmm "
        f"over the gathered factors {rec['bmm_ms']:.4f} ms per call (a reference, not barred; "
        f"rounds d only to x's dtype)")
    return rec


def lora_event_rounds() -> list:
    """The decode call's CUDA-event ms (wq, rank 16, bf16 x, float32
    factors) in LORA_EVENT_ROUNDS rounds of 200 calls.  Taken before the
    process's first profiler session: once a profile has run, every launch
    costs the host more (the profiler's callbacks stay registered), which
    would bill the profiler to the wrapper."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    fin, fout = LORA_TARGETS["wq"]
    B_, T = LORA_SHAPES["decode"]
    x, a, b, _ = lora_inputs(gen, B_, T, fin, fout, 16, torch.bfloat16, torch.float32)
    return [time_ms(lambda: cudaex.lora_delta_fused(x, a, b, LORA_SCALING), iters=200)
            for _ in range(LORA_EVENT_ROUNDS)]


def check_lora(event_rounds: list):
    """``lora_delta_fused`` against its plain version at every shape,
    target and rank above, x in bf16 and float32, factors in float32 and
    bf16: float32 x within LORA_REL_F32 of the output's max magnitude; bf16
    x against the float32 plain result of the same inputs, the kernel's
    error at most LOWP_ERR_RATIO times the plain version's own; base-slot
    rows exactly 0; two calls bitwise equal.  Then the slot read: 8
    requests over a 4-slot arena of 32 layers (``LORA_ARENA_SLOTS``, one
    layer's view as the engine passes it) bitwise equal to the call on the
    gathered factors and within LORA_SLOT_TIME_RATIO of its device time
    (each side's median over LORA_SLOT_ROUNDS alternate rounds).
    Then times at each shape (wq, rank 16, bf16 x, float32 factors: what
    the bf16 serves run) and at rank 128, held to LORA_DEVICE_MAX_MS, the
    chunk also below its plain version, and the decode call's CUDA-event
    time (the median of ``event_rounds``, :func:`lora_event_rounds`) to
    LORA_DECODE_EVENT_MAX_MS."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 15)
    worst = {}
    main_err = None
    for shape, (B_, T) in LORA_SHAPES.items():
        for target, (fin, fout) in LORA_TARGETS.items():
            for r in LORA_RANKS:
                for x_dtype in (torch.bfloat16, torch.float32):
                    for f_dtype in (torch.float32, torch.bfloat16):
                        x, a, b, base = lora_inputs(gen, B_, T, fin, fout, r, x_dtype, f_dtype)
                        got = cudaex.lora_delta_fused(x, a, b, LORA_SCALING)
                        again = cudaex.lora_delta_fused(x, a, b, LORA_SCALING)
                        torch.cuda.synchronize()
                        want = cudaex.lora_delta_fused_plain(x, a, b, LORA_SCALING)
                        err = (got.float() - want.float()).abs().max().item()
                        zero = all(bool((got[i] == 0).all()) for i in base)
                        same = bool(torch.equal(got, again))
                        if x_dtype == torch.float32:
                            lim = LORA_REL_F32 * want.abs().max().item()
                            ok, bar = err <= lim, f"atol {lim:.2e}"
                        else:
                            ref = cudaex.lora_delta_fused_plain(x.float(), a.float(), b.float(),
                                                                LORA_SCALING)
                            ek = (got.float() - ref).abs().max().item()
                            ep = (want.float() - ref).abs().max().item()
                            ok = ek <= LOWP_ERR_RATIO * ep
                            bar = f"against float32: kernel {ek:.3e}, plain {ep:.3e}"
                        ok = ok and zero and same and bool(torch.isfinite(got).all())
                        label = (f"{shape} {target} r={r} x {str(x_dtype)[6:]} factors "
                                 f"{str(f_dtype)[6:]}")
                        key = str(x_dtype)[6:]
                        worst[key] = max(worst.get(key, 0.0), err)
                        if (shape, target, r, x_dtype, f_dtype) == (
                                "decode", "wq", 16, torch.bfloat16, torch.float32):
                            main_err = err
                        if not ok:
                            say(f"lora_delta_fused {label}: max_abs_err={err:.3e} ({bar}); "
                                f"base rows zero {zero}; two calls bitwise equal {same} FAIL")
                            raise AssertionError(f"lora_delta_fused {label} disagrees with its "
                                                 "plain version")
    n = len(LORA_SHAPES) * len(LORA_TARGETS) * len(LORA_RANKS) * 4
    say(f"lora_delta_fused: {n} cases (shapes {LORA_SHAPES}, targets {LORA_TARGETS}, ranks "
        f"{LORA_RANKS}, x bf16/float32, factors float32/bf16) ok; worst max_abs_err {worst}; "
        f"base-slot rows exactly 0; two calls bitwise equal")
    shapes = {}
    fin, fout = LORA_TARGETS["wq"]
    for shape, (B_, T) in LORA_SHAPES.items():
        x, a, b, _ = lora_inputs(gen, B_, T, fin, fout, 16, torch.bfloat16, torch.float32)
        plan = cudaex.lora_plan(B_, T, fin, 16, x.dtype)
        lora_kernels_seen(lambda: cudaex.lora_delta_fused(x, a, b, LORA_SCALING), x, a,
                          f"{shape} (plan {plan})")
        shapes[shape] = lora_timed(f" {shape} wq r=16 (B={B_}, T={T})", x, a, b,
                                   lora_bound(B_, T, fin, fout, 16, torch.bfloat16,
                                              torch.float32))
    B_, T = LORA_SHAPES["decode"]
    x, a, b, _ = lora_inputs(gen, B_, T, fin, fout, 128, torch.bfloat16, torch.float32)
    shapes["decode r=128"] = lora_timed(
        f" decode wq r=128 (B={B_}, T={T})", x, a, b,
        lora_bound(B_, T, fin, fout, 128, torch.bfloat16, torch.float32))
    shapes["slot read"] = check_lora_slots(gen)
    shapes["decode"]["event_rounds_ms"] = event_rounds
    event_ms = statistics.median(event_rounds)
    ok = event_ms <= LORA_DECODE_EVENT_MAX_MS
    for shape, lim in LORA_DEVICE_MAX_MS.items():
        dev_ms = shapes[shape]["device_ms"]
        ok = ok and dev_ms is not None and dev_ms <= lim
    ok = ok and shapes["chunk"]["ms"] < shapes["chunk"]["plain_ms"]
    say("lora_delta_fused times: device ms " + json.dumps(
        {k: v["device_ms"] for k, v in shapes.items()}) + f" (at most {LORA_DEVICE_MAX_MS}); "
        f"decode CUDA-event {event_ms:.4f} ms, the median of rounds "
        f"{[round(t, 4) for t in event_rounds]} taken before the first profile (at most "
        f"{LORA_DECODE_EVENT_MAX_MS}; {shapes['decode']['ms']:.4f} ms after this phase's "
        f"profiles, not barred); "
        f"chunk {shapes['chunk']['ms']:.4f} ms against its plain version's "
        f"{shapes['chunk']['plain_ms']:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("lora_delta_fused missed a time bar")
    return dict(shapes["decode"], max_abs_err=main_err, shapes=shapes)


def check_lora_slots(gen) -> dict:
    """The slot read at the decode shape (wq, rank 16, bf16 x, float32
    factors): request i reads slot ``LORA_ARENA_SLOTS[i]`` of one layer's
    view of a (4, 32, ...) arena, as the engine passes it."""
    fin, fout = LORA_TARGETS["wq"]
    B_, T = LORA_SHAPES["decode"]
    S = max(LORA_ARENA_SLOTS) + 1
    x = torch.randn((B_, T, fin), generator=gen, device=DEVICE).to(torch.bfloat16)
    arena_a = 0.05 * torch.randn((S, L, 16, fin), generator=gen, device=DEVICE)
    arena_b = 0.05 * torch.randn((S, L, fout, 16), generator=gen, device=DEVICE)
    arena_a[0], arena_b[0] = 0, 0
    a, b = arena_a[:, L - 3], arena_b[:, L - 3]
    slots = torch.as_tensor(LORA_ARENA_SLOTS, dtype=torch.int32, device=DEVICE)
    idx = slots.long()
    ga, gb = a[idx].contiguous(), b[idx].contiguous()
    got = cudaex.lora_delta_fused(x, a, b, LORA_SCALING, slots=slots)
    gathered = cudaex.lora_delta_fused(x, ga, gb, LORA_SCALING)
    torch.cuda.synchronize()
    want = cudaex.lora_delta_fused_plain(x, a, b, LORA_SCALING, slots)
    ref = cudaex.lora_delta_fused_plain(x.float(), a, b, LORA_SCALING, slots)
    ek = (got.float() - ref).abs().max().item()
    ep = (want.float() - ref).abs().max().item()
    same = bool(torch.equal(got, gathered))
    zero = bool((got[idx == 0] == 0).all())
    lora_kernels_seen(lambda: cudaex.lora_delta_fused(x, a, b, LORA_SCALING, slots=slots), x, a,
                      "slot read")
    rec = lora_timed(f" slot read wq r=16 (B={B_}, T={T}, slots {LORA_ARENA_SLOTS})", x, a, b,
                     lora_bound(B_, T, fin, fout, 16, torch.bfloat16, torch.float32,
                                n_factors=len(set(LORA_ARENA_SLOTS))), slots=slots)
    # the two device times in alternate rounds, each side's median: one
    # round's jitter (a few hundred ns on a 6 us call) moves neither
    last, *rest = lora_kernels(x, a)
    by_slot, gathered_ms = [], []
    for _ in range(LORA_SLOT_ROUNDS):
        by_slot.append(device_ms(lambda: cudaex.lora_delta_fused(x, a, b, LORA_SCALING,
                                                                 slots=slots),
                                 last, iters=50, also=tuple(rest), whole=True))
        gathered_ms.append(device_ms(lambda: cudaex.lora_delta_fused(x, ga, gb, LORA_SCALING),
                                     last, iters=50, also=tuple(rest), whole=True))
    measured = None not in by_slot and None not in gathered_ms
    rec["slot_rounds_device_ms"], rec["gathered_rounds_device_ms"] = by_slot, gathered_ms
    rec["gathered_device_ms"] = statistics.median(gathered_ms) if measured else None
    ratio = statistics.median(by_slot) / rec["gathered_device_ms"] if measured else None
    faults = [why for bad, why in (
        (not same, "differs from the gathered call"), (not zero, "base rows are not 0"),
        (ek > LOWP_ERR_RATIO * ep, "is further from float32 than the bar"),
        (not measured, "no profile saw every launch of its kernels"),
        (measured and ratio > LORA_SLOT_TIME_RATIO, "is slower than its time bar")) if bad]
    say(f"lora_delta_fused slot read: bitwise equal to the gathered call {same}; base rows "
        f"zero {zero}; against float32: kernel {ek:.3e}, plain {ep:.3e}; device ms in "
        f"{LORA_SLOT_ROUNDS} alternate rounds {by_slot} against the gathered call's "
        f"{gathered_ms} (ratio of medians {ratio}, at most {LORA_SLOT_TIME_RATIO}) "
        f"{'FAIL: ' + '; '.join(faults) if faults else 'ok'}")
    if faults:
        raise AssertionError("lora_delta_fused's slot read " + "; ".join(faults))
    rec["max_abs_err"] = (got.float() - want.float()).abs().max().item()
    return rec


CE_N, CE_V = 2048, 128256               # Llama-3-8B's training step: B=1, T=2048
# float32 row losses: a sum of exp over 128256 logits in another order,
# within this share of the largest loss (both paths upcast bf16 logits
# exactly and compute in float32, so bf16 takes the same bar)
CE_REL = 1e-5
# a shape the TPU kernel's tiling refuses (no row block divides N, no ×128
# tile divides V, GPT-2's vocabulary): the kernel takes it on its scalar walk
CE_ODD_N, CE_ODD_V = 2047, 50257


def check_ce():
    """``flash_cross_entropy`` against its plain version at (2048, 128256),
    float32 and bf16 logits, random targets: loss and lse within CE_REL of
    their largest magnitude; then times beside ``F.cross_entropy``
    (reduction "none": the losses only, no lse) and the bound."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.randn((CE_N, CE_V), generator=gen, device=DEVICE).to(dtype)
        target = torch.randint(0, CE_V, (CE_N,), generator=gen, device=DEVICE)
        loss, lse = cudaex.flash_cross_entropy(logits, target)
        torch.cuda.synchronize()
        want_loss, want_lse = cudaex.flash_cross_entropy_plain(logits, target)
        err = (loss - want_loss).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        lim = CE_REL * want_loss.abs().max().item()
        ok = (err <= lim and err_lse <= CE_REL * want_lse.abs().max().item()
              and bool(torch.isfinite(loss).all()))
        name = str(dtype)[6:]
        say(f"flash_ce {name} ({CE_N}, {CE_V}): loss max_abs_err={err:.3e}, lse "
            f"max_abs_err={err_lse:.3e} (bar {lim:.2e}; lse mean {want_lse.mean().item():.4f}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_ce {name} disagrees with its plain version")
        esize = logits.element_size()
        nbytes = CE_N * CE_V * esize + CE_N * target.element_size() + 2 * CE_N * 4
        rec[name] = dict(timed(
            "flash_ce", f" ({CE_N}, {CE_V})", lambda: cudaex.flash_cross_entropy(logits, target),
            lambda: cudaex.flash_cross_entropy_plain(logits, target),
            lambda: F.cross_entropy(logits, target, reduction="none"),
            "F.cross_entropy (reduction none, losses only)",
            bound(nbytes, 4 * CE_N * CE_V, torch.float32), iters=20, plain_iters=5,
            device_kernel="flash_ce_kernel", dtype_name=name), max_abs_err=err)
        del logits, loss, lse, want_loss, want_lse
    for dtype in (torch.float32, torch.bfloat16):
        logits = torch.randn((CE_ODD_N, CE_ODD_V), generator=gen, device=DEVICE).to(dtype)
        target = torch.randint(0, CE_ODD_V, (CE_ODD_N,), generator=gen, device=DEVICE)
        loss, lse = cudaex.flash_cross_entropy(logits, target)
        want_loss, want_lse = cudaex.flash_cross_entropy_plain(logits, target)
        err = (loss - want_loss).abs().max().item()
        err_lse = (lse - want_lse).abs().max().item()
        ok = (err <= CE_REL * want_loss.abs().max().item()
              and err_lse <= CE_REL * want_lse.abs().max().item())
        say(f"flash_ce {str(dtype)[6:]} ({CE_ODD_N}, {CE_ODD_V}), scalar walk: loss "
            f"max_abs_err={err:.3e}, lse max_abs_err={err_lse:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_ce disagrees with its plain version at "
                                 f"({CE_ODD_N}, {CE_ODD_V})")
    torch.cuda.empty_cache()
    return dict(rec["float32"], dtypes=rec,
                library="F.cross_entropy(logits, target, reduction='none'): the row losses "
                        "only (no lse)")


#
# phase 4: serve Llama-3-8B at full width
#


def make_params(cfg_name="Llama-3-8B"):
    cfg = Config.from_name(cfg_name)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg, generator=gen, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    say(f"{cfg_name} params: {param_count(params) / 1e9:.3f} B in bf16, "
        f"init {time.perf_counter() - t0:.1f} s")
    return params, cfg


def no_launches_but(**expected) -> dict:
    return {name: expected.get(name, 0) for name in cudaex.LAUNCHES}


def serve_full_width(params, cfg, n_requests=8, new_tokens=32):
    cfg_name = cfg.name
    eng = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=1024, max_batch=8,
                device=DEVICE)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(128, 1025, n_requests)]
    eng.run([prompts[0][:64]], max_new_tokens=2)            # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.decode_steps
    cudaex.reset_launches()
    t0 = time.perf_counter()
    handles = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    eng.step()                                              # admits and prefills every request
    tables = [list(h._req.block_table) for h in handles]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cudaex.LAUNCHES)
    steps = eng.decode_steps - steps0
    results = [h.result(drive=False) for h in handles]
    for r in results:
        toks = np.asarray(r.new_tokens)
        if (r.finish_reason != "length" or len(toks) != new_tokens
                or toks.min() < 0 or toks.max() >= cfg.padded_vocab_size):
            raise AssertionError(f"request {r.rid}: bad result {r.finish_reason} {toks}")
    n_tok = sum(len(r.new_tokens) for r in results)
    ttft = float(np.median([r.ttft_s for r in results]))
    tpot = float(np.median([r.tpot_s for r in results]))
    say(f"serve {cfg_name} bf16: {n_requests} requests, prompts "
        f"{sorted(len(p) for p in prompts)}, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; TTFT p50 {1e3 * ttft:.1f} ms; TPOT p50 "
        f"{1e3 * tpot:.2f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; decode steps {steps}")
    say(f"launches during serve: {launches} (expected paged_attn_decode "
        f"{steps * cfg.n_layer}, paged_token_write {steps}: K and V in one launch)")
    if launches != no_launches_but(paged_attn_decode=steps * cfg.n_layer,
                                   paged_token_write=steps):
        raise AssertionError(f"launch counts {launches} do not match {steps} decode steps")
    compare_logits(eng, params, cfg, prompts, results, tables)
    return launches, profile_decode(eng, prompts)


# the decode step on the previous decode kernel, one block per (request,
# group), in every run that profiled it (PERF.md 5): device busy per step
# and its paged_attn_decode group, ms
DECODE_STEP_BUSY_BEFORE_MS, DECODE_GROUP_BEFORE_MS = 35.6, 27.2
DECODE_GROUP_MAX_MS = 2.0        # the paged_attn_decode group per step, at most
DECODE_FALL_SHARE = 0.9          # the step's busy time falls by this share of its saving


KV_WRITE_KERNELS = ("paged_token_write", "paged_chunk_write", "chunk_err_reduce")
# the kv_write group per profiled step, ms at most: the decode step's pair
# write (phase 4), the bf16 chunk piece's pair (phase 5), the verify round's
# masked pair (phase 6), the int8 chunk piece's fused pair with its error
# sums, the int8 decode step's and the fp8 verify round's quantizing pairs
# (phase 6b); the four token-write bars sit at about 1.3x what they read on
# NVIDIA H100 80GB HBM3, 700.00 W (0.0026 / 0.0043 / 0.0032 / 0.0060 ms)
KV_WRITE_GROUP_MAX_MS = {"decode step": 0.0034, "chunk piece": 0.055, "verify round": 0.0056,
                         "int8 chunk piece": 0.065, "int8 decode step": 0.0042,
                         "fp8 verify round": 0.0078}


def _group(name: str, attn: str) -> str:
    """Kernel group of a serving profile: the paged attention call ``attn``
    (its split and combine kernels included), every KV write kernel (token,
    masked, fused and chunk writes: ``kv_write``), the LoRA delta (both
    phases' kernels), cuBLAS, or the rest."""
    low = name.lower()
    return ("lora_delta" if "lora_delta" in low
            else attn if attn in low or "paged_attn_split" in low
            else "kv_write" if any(k in low for k in KV_WRITE_KERNELS)
            else "matmul" if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet"))
            else "other")


def check_kv_write_group(rec: dict, step: str) -> float:
    """The ``kv_write`` group of a profiled ``step``: nonzero (the write
    ran) and within KV_WRITE_GROUP_MAX_MS."""
    group = rec["groups_ms"].get("kv_write", 0.0)
    lim = KV_WRITE_GROUP_MAX_MS[step]
    ok = 0.0 < group <= lim
    say(f"{step}: kv_write group {group:.4f} ms (at most {lim}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {step}'s kv_write group {group} ms missed its bar {lim}")
    return group


def device_kernels(prof) -> list:
    """A profile's device events less the ranges the profiler annotates on
    the device timeline (a schedule's ``ProfilerStep#n``, any
    ``record_function``), which span kernels rather than run."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")]


def profile_spans(prof, steps, attn, label) -> dict | None:
    """Device busy time per step, the idle share of the kernel span and the
    time by kernel group of a profile of ``steps`` engine steps."""
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in device_kernels(prof)]
    if not spans:
        say(f"{label} profile: not measured (the profiler saw no CUDA activity)")
        return None
    busy = sum(end - start for _, start, end in spans)
    window = max(end for *_, end in spans) - min(start for _, start, _ in spans)
    groups: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for name, start, end in spans:
        key = _group(name, attn)
        groups[key] = groups.get(key, 0.0) + (end - start)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    per_step = {k: round(v / steps / 1e3, 4) for k, v in sorted(groups.items())}
    say(f"{label} profile ({steps} step(s)): device busy {busy / steps / 1e3:.3f} ms per step "
        f"over a {window / steps / 1e3:.3f} ms kernel span (idle share {1 - busy / window:.3f}), "
        f"{len(spans) / steps:.0f} kernels per step; device ms per step by kernel group: "
        f"{per_step}")
    for name, total in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        say(f"  {total / steps / 1e3:.4f} ms per step: {name[:110]}")
    return dict(busy_ms=busy / steps / 1e3, span_ms=window / steps / 1e3,
                idle_share=1 - busy / window, kernels_per_step=len(spans) / steps,
                groups_ms=per_step)


# the kernels of a decode step as the profiler names them, each run once
# per launch of the cudaex.LAUNCHES counters beside it: a paged_attn_decode
# launch is its split kernel and its combine kernel, a pair write (plain or
# keep-masked) one token-write kernel
DECODE_SPAN_COUNTERS = (("paged_attn_split", ("paged_attn_decode",)),
                        ("paged_attn_decode_combine", ("paged_attn_decode",)),
                        ("paged_token_write_kernel", ("paged_token_write",
                                                      "paged_token_write_masked")))


def check_span_counts(prof, delta: dict, label: str) -> dict:
    """The decode kernels a profiled window ran, counted by name, against
    the ``cudaex.LAUNCHES`` the window added (under graphs, what the
    replays added from their captures' counts): equal, and nonzero."""
    names = [e.name for e in device_kernels(prof)]
    got = {k: sum(k in n for n in names) for k, _ in DECODE_SPAN_COUNTERS}
    want = {k: sum(delta.get(c, 0) for c in cs) for k, cs in DECODE_SPAN_COUNTERS}
    ok = got == want and all(want.values())
    say(f"{label}: kernels the profiler saw {got} against the launches counted {want} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the profiled kernels {got} differ from the counted "
                             f"launches {want}")
    return got


# the host's idle time on each side of a profiled window's counted steps,
# far above the few ms by which the profiler's clock conversion can put a
# device record before the window's opening
PROFILE_EDGE_S = 0.1


def profile_decode_steps(eng, prompts, label, ids=None, steps=4, tries=3,
                         count_spans=False) -> dict:
    """Device time of a few steady decode steps of the same batch, by
    kernel group, from the profiler's CUDA activity: where the decode
    step's time goes, and how much of the span between the first and the
    last kernel the card sits idle.  The prompts (with adapters ``ids``)
    are prefilled first; a profiled window must hold decode steps alone.
    The profiler traces one decode step first and drops it (its schedule's
    warm-up), and the card is synchronized on both sides of the counted
    window, so the window opens on a running trace.  The window keeps a
    device record only when the record's time, converted to the host's
    clock, falls inside it, and that conversion can put a kernel a few ms
    early: the first kernels of a window opened right before them are then
    dropped (``tools/profile_window_edges.py``).  So the host idles
    PROFILE_EDGE_S on both sides of the counted steps.  A profile that records
    no CUDA activity is taken again, ``tries`` times, and then fails.
    ``count_spans``: the window's decode kernels, counted by name, must
    equal the launches it counted (:func:`check_span_counts`)."""
    ids = ids or [None] * len(prompts)
    handles = [eng.submit(p, max_new_tokens=tries * (steps + 1) + 3, adapter_id=a)
               for p, a in zip(prompts, ids)]
    eng.step()                                             # admit + prefill
    eng.step()                                             # token 0, first decode dispatch
    while not all(h._req.generated for h in handles):      # chunked prompts: the last pieces
        eng.step()
    torch.cuda.synchronize()
    rec = None
    for _ in range(tries):     # a profile now and then records no kernel at all
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            eng.step()                                     # traced, dropped
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_EDGE_S)
            before = (eng.decode_steps, eng.chunk_runs, eng.prefill_runs)
            launched = dict(cudaex.LAUNCHES)
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            delta = {k: n - launched.get(k, 0) for k, n in cudaex.LAUNCHES.items()}
            after = (eng.decode_steps, eng.chunk_runs, eng.prefill_runs)
            time.sleep(PROFILE_EDGE_S)
            prof.step()
        if after != (before[0] + steps, *before[1:]):
            raise AssertionError(f"{label}: the profiled window was not {steps} decode steps "
                                 f"alone (decode steps, chunk pieces, prefills {before} -> "
                                 f"{after})")
        rec = profile_spans(prof, steps, "paged_attn_decode", label)
        if rec is not None:
            if count_spans:
                rec["span_counts"] = check_span_counts(prof, delta, label)
            break
    eng.drain()
    if not all(h.done() for h in handles):
        raise AssertionError("profiled requests did not finish")
    if rec is None:
        raise AssertionError(f"{label}: {tries} profiles recorded no CUDA activity, so its bars "
                             "were not measured")
    return rec


def profile_decode(eng, prompts) -> dict:
    """Four steady decode steps profiled (``profile_decode_steps``): the
    ``paged_attn_decode`` group (the split body's two kernels) must read at
    most DECODE_GROUP_MAX_MS per step, and the step's busy time must have
    fallen from the previous decode kernel's by at least DECODE_FALL_SHARE
    of the group's saving."""
    rec = profile_decode_steps(eng, prompts, "decode step (8 rows)")
    group = rec["groups_ms"].get("paged_attn_decode", 0.0)
    saving = DECODE_GROUP_BEFORE_MS - group
    fall = DECODE_STEP_BUSY_BEFORE_MS - rec["busy_ms"]
    ok = group <= DECODE_GROUP_MAX_MS and fall >= DECODE_FALL_SHARE * saving
    say(f"decode step: paged_attn_decode group {group:.4f} ms per step (at most "
        f"{DECODE_GROUP_MAX_MS}; {DECODE_GROUP_BEFORE_MS} on the previous kernel), busy "
        f"{rec['busy_ms']:.3f} ms fell {fall:.3f} ms from {DECODE_STEP_BUSY_BEFORE_MS} against "
        f"the group's saving {saving:.3f} ms (at least {DECODE_FALL_SHARE} of it) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the decode step's paged_attn_decode group or busy time missed "
                             "its bar")
    return rec


def profile_one_step(eng, counter: str, attn: str, label: str, tries: int = 6) -> dict:
    """Device time by kernel group of the first engine step that advances
    ``counter`` (``chunk_runs``: a chunk piece; ``spec_rounds``: a verify
    round) by exactly one, with its idle share; raises when no profiled
    step of ``tries`` did so with CUDA activity recorded."""
    for _ in range(tries):
        before = getattr(eng, counter)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
        if getattr(eng, counter) - before == 1:
            rec = profile_spans(prof, 1, attn, label)
            if rec is not None:
                return rec
    raise AssertionError(f"{label} profile: no profiled step of {tries} advanced {counter} by one "
                         "with CUDA activity recorded")


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def compare_logits(eng, params, cfg, prompts, results, tables, slots=None):
    """One decode step at the served rows' last positions (their blocks
    still hold the K/V the run wrote), through the kernels and through the
    dense path over the same gathered cache, in bf16 and in float32.  A
    quantized pool keeps its bytes and scales in both: the kernels
    dequantize them in-kernel, the dense path through ``gather_dense_q``,
    each into the compute dtype of the run.  ``slots``: the rows' adapter
    slots in a LoRA engine; the kernel path then adds the deltas through
    ``lora_delta_fused``, the dense path through the plain delta."""
    Bb = len(results)
    nbb = eng._nbb(max(len(t) for t in tables))
    tab = np.full((Bb, nbb), SINK_BLOCK, dtype=np.int32)
    for i, t in enumerate(tables):
        tab[i, :len(t)] = t
    pos = np.array([len(p) + len(r.new_tokens) - 2 for p, r in zip(prompts, results)], np.int32)
    toks = np.array([r.new_tokens[-2] for r in results], np.int32)
    dev = DEVICE
    tab_d, pos_d = torch.as_tensor(tab, device=dev), torch.as_tensor(pos, device=dev)
    toks_d = torch.as_tensor(toks, device=dev)[:, None]
    cos, sin = build_rope_cache(cfg, nbb * eng.pool.block_size, device=dev)

    quantized = eng.pool.quantized_kv
    reg = eng._registry
    lora = ({} if slots is None else
            {"lora": gather_adapter_slots(reg.arenas, torch.as_tensor(slots, device=dev)),
             "lora_scaling": reg.scaling})

    def both_paths(p, arenas, cdtype):
        lp, _ = forward_paged(p, toks_d, pos_d, arenas, tab_d, cos, sin, cfg, cdtype=cdtype,
                              **lora)
        if quantized:
            kd, vd = gather_dense_q(arenas["k"], arenas["v"], arenas["k_scale"],
                                    arenas["v_scale"], tab_d, cdtype)
        else:
            kd, vd = gather_dense(arenas["k"], arenas["v"], tab_d)
        lg, _ = forward_with_cache(p, toks_d, pos_d, {"k": kd, "v": vd}, cos, sin, cfg, **lora)
        return lp, lg

    with torch.no_grad():
        lp, lg = both_paths(params, eng.pool.arenas, torch.bfloat16)
        arenas32 = eng.pool.arenas if quantized else _cast(eng.pool.arenas, torch.float32)
        lp32, lg32 = both_paths(_cast(params, torch.float32), arenas32, torch.float32)
    torch.cuda.synchronize()
    err = (lp - lg).abs().max().item()
    err32 = (lp32 - lg32).abs().max().item()
    err_kernel = (lp - lg32).abs().max().item()          # bf16 paths against float32
    err_dense = (lg - lg32).abs().max().item()
    agree = int((lp.argmax(-1) == lg.argmax(-1)).sum())
    served = torch.as_tensor([r.new_tokens[-1] for r in results], device=dev)
    replay = int((lp.argmax(-1)[:, 0] == served).sum())
    ok = (bool(torch.isfinite(lp).all()) and err32 <= LOGITS_ATOL_F32
          and err_kernel <= BF16_ERR_RATIO * err_dense)
    say(f"decode logits{' off ' + str(eng.pool.kv_dtype)[6:] + ' arenas' if quantized else ''}"
        f"{', LoRA slots ' + str(slots) if slots is not None else ''}, "
        f"kernels vs dense path ({Bb} rows, nbb={nbb}, logits std "
        f"{lg32.std().item():.3f}): float32 max_abs_err={err32:.3e} (atol {LOGITS_ATOL_F32}); "
        f"bf16 max_abs_err={err:.4f}, against float32 dense: kernel path {err_kernel:.4f}, "
        f"dense path {err_dense:.4f} (ratio limit {BF16_ERR_RATIO}); bf16 argmax agree "
        f"{agree}/{Bb}; kernel path re-derives the served last token {replay}/{Bb} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("forward_paged disagrees with forward_with_cache")
    return dict(f32_max_abs_err=err32, bf16_kernel_err=err_kernel, bf16_dense_err=err_dense)


#
# phases 5-6: chunked prefill and speculative serving at full width
#


def serve_stats(name, results, wall):
    n_tok = sum(len(r.new_tokens) for r in results)
    ttft = float(np.median([r.ttft_s for r in results]))
    tpot = float(np.median([r.tpot_s for r in results]))
    say(f"{name}: {len(results)} requests, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; TTFT p50 {1e3 * ttft:.1f} ms; TPOT p50 "
        f"{1e3 * tpot:.2f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(tokens_per_s=n_tok / wall, ttft_p50_ms=1e3 * ttft, tpot_p50_ms=1e3 * tpot)


def check_results(results, new_tokens, vocab):
    for r in results:
        toks = np.asarray(r.new_tokens)
        if (r.finish_reason != "length" or len(toks) != new_tokens
                or toks.min() < 0 or toks.max() >= vocab):
            raise AssertionError(f"request {r.rid}: bad result {r.finish_reason} {toks}")


CHUNK = 512
CHUNK_BUCKETS = tuple(16 * 2 ** i for i in range(6))          # 16 .. 512, block-aligned


def quant_gauge() -> float | None:
    return registry().gauge("serving.kv_quant.rel_err").value


def check_gauge(name, kv_dtype) -> float | None:
    """A quantized serve's ``serving.kv_quant.rel_err`` gauge: finite and in
    (0, 0.05) (plausibly near 1e-2 for int8, 3e-2 for fp8)."""
    gauge = quant_gauge()
    say(f"{name}: serving.kv_quant.rel_err gauge {gauge} (kv_dtype {kv_dtype})")
    if kv_dtype is not None and not (gauge is not None and math.isfinite(gauge)
                                     and 0.0 < gauge < 0.05):
        raise AssertionError(f"{name}: rel_err gauge {gauge} outside (0, 0.05)")
    return gauge


def submit_all(eng, prompts, new_tokens, lora):
    """Submits every prompt; with a registry, two requests per adapter and
    two base ones (``LORA_IDS``)."""
    ids = LORA_IDS if lora is not None else [None] * len(prompts)
    return [eng.submit(p, max_new_tokens=new_tokens, adapter_id=a) for p, a in zip(prompts, ids)]


def lora_launches(cfg, lora, calls: int) -> dict:
    """The expected ``lora_delta_fused`` launches: wq, wk, wv, wo in every
    layer of every kernel-path call (decode step, chunk piece, verify
    round) of a LoRA engine."""
    return {"lora_delta_fused": 4 * cfg.n_layer * calls} if lora is not None else {}


def tenant_report(name, lora):
    if lora is None:
        return None
    snap = registry().snapshot("serving.tenant.")
    tenants = {a: {"tokens": snap[f"serving.tenant.{a}.tokens"],
                   "requests": snap[f"serving.tenant.{a}.requests"],
                   "ttft_p50_ms": 1e3 * snap[f"serving.tenant.{a}.ttft_s"]["p50"],
                   "e2e_p50_ms": 1e3 * snap[f"serving.tenant.{a}.e2e_s"]["p50"]}
               for a in LORA_ADAPTERS}
    say(f"{name}: tenant counters {tenants}")
    if any(t["requests"] != 2 for t in tenants.values()) or any(
            k.startswith("serving.tenant.None") for k in snap):
        raise AssertionError(f"{name}: tenant counters {snap}")
    return tenants


def chunked_serve(params, cfg, n_requests=8, new_tokens=32, kv_dtype=None, num_blocks=2048,
                  lora=None, profile=False):
    eng = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=num_blocks,
                max_batch=8, prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS,
                kv_dtype=kv_dtype, lora=lora, device=DEVICE)
    kind = eng.stats()["attn"]["kinds"]["prefill_chunk"]
    say(f"chunked serve (kv_dtype {kv_dtype}): chunk kind {kind['mode']!r} (fallback reason "
        f"{kind['fallback_reason']}), {eng.pool.num_blocks} blocks of "
        f"{eng.pool.block_bytes()} B, arena {eng.pool.arena_bytes()} B = "
        f"{eng.pool.arena_bytes() / 2**30:.3f} GiB")
    if kind["mode"] != "paged":
        raise AssertionError(f"the chunk kind resolved {kind['mode']!r}, not 'paged'")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(1024, 3073, n_requests)]
    eng.run([prompts[0][:600]], max_new_tokens=2)            # warm-up: one chunk + final piece
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry().reset()
    steps0, chunks0 = eng.decode_steps, eng.chunk_runs
    cudaex.reset_launches()
    t0 = time.perf_counter()
    handles = submit_all(eng, prompts, new_tokens, lora)
    eng.step()                                              # admits every request
    tables = [list(h._req.block_table) for h in handles]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cudaex.LAUNCHES)
    steps, pieces = eng.decode_steps - steps0, eng.chunk_runs - chunks0
    results = [h.result(drive=False) for h in handles]
    check_results(results, new_tokens, cfg.padded_vocab_size)
    tag = f", LoRA rank {lora.rank} ids {LORA_IDS}" if lora is not None else ""
    rec = serve_stats(f"chunked serve {cfg.name} bf16, kv_dtype {kv_dtype}{tag} (prompts "
                      f"{sorted(len(p) for p in prompts)}, prefill_chunk {CHUNK})", results, wall)
    # the engine's pair writes: K and V of a decode step or of a chunk piece
    # in one launch, bf16 or quantized
    writes = ({"paged_chunk_write": pieces, "paged_token_write": steps} if kv_dtype is None
              else {"paged_chunk_write_fused": pieces, "paged_token_write_fused": steps})
    want = no_launches_but(paged_attn_verify=pieces * cfg.n_layer,
                           paged_attn_decode=steps * cfg.n_layer, **writes,
                           **lora_launches(cfg, lora, pieces + steps))
    say(f"launches during chunked serve: {launches} ({pieces} intermediate pieces, "
        f"{steps} decode steps; expected {want})")
    if launches != want or not pieces:
        raise AssertionError(f"chunked serve launch counts {launches} != {want} "
                             f"({pieces} intermediate pieces)")
    rec.update(launches=launches, pieces=pieces, steps=steps, blocks=eng.pool.num_blocks,
               arena_bytes=eng.pool.arena_bytes(),
               rel_err=check_gauge("chunked serve", kv_dtype),
               tenants=tenant_report("chunked LoRA serve", lora))
    if profile:
        rec["chunk_piece_profile"] = profile_chunk_piece(eng, cfg, "chunked serve")
    return rec, eng, prompts, tables, results


def profile_chunk_piece(eng, cfg, label, adapter_id=None) -> dict:
    """One steady chunk piece alone, by kernel group: a 3.2 k-token
    prompt's second piece."""
    rng = np.random.default_rng(SEED + 13)
    prompt = rng.integers(0, cfg.vocab_size, 3 * CHUNK + 100).astype(np.int32)
    eng.submit(prompt, max_new_tokens=2, adapter_id=adapter_id)
    eng.step()                                          # admits, dispatches piece 0
    rec = profile_one_step(eng, "chunk_runs", "paged_attn_verify",
                           f"{label}, one chunk piece (T={CHUNK})")
    eng.drain()
    return rec


LORA_RANK, LORA_ALPHA = 16, 32         # scaling 2.0
LORA_ADAPTERS = ("tenant-a", "tenant-b", "tenant-c")
LORA_IDS = [*LORA_ADAPTERS, None] * 2   # two requests per adapter, two base


def make_registry(cfg, targets=("wq", "wk", "wv", "wo")):
    """Rank 16, alpha 32, the default targets wq/wk/wv/wo (or ``targets``),
    four slots, three adapters of std 0.05 from a seeded generator, float32
    factors."""
    reg = AdapterRegistry(cfg, rank=LORA_RANK, alpha=LORA_ALPHA, max_adapters=4, targets=targets,
                          device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    for name in LORA_ADAPTERS:
        reg.register(name, make_lora_factors(cfg, LORA_RANK, gen, targets, std=0.05))
    return reg


# the LoRA serves' lora_delta group (both phases' kernels) per profiled
# step, ms at most; the LoRA chunk piece's busy time at most this multiple
# of phase 5's chunk piece in the same run
LORA_GROUP_MAX_MS = {"decode step": 1.2, "chunk piece": 3.0, "verify round": 1.5}
LORA_CHUNK_BUSY_RATIO = 1.25


def profile_lora_serves(lrec, slrec, crec) -> dict:
    """The LoRA serves' profiles by kernel group: one decode step and one
    chunk piece of the chunked LoRA serve, one verify round of the
    speculative one; the ``lora_delta`` group nonzero and within
    LORA_GROUP_MAX_MS in each, and the chunk piece's busy time within
    LORA_CHUNK_BUSY_RATIO of phase 5's."""
    profiles = {"decode step": lrec["decode_step_profile"],
                "chunk piece": lrec["chunk_piece_profile"],
                "verify round": slrec["verify_round_profile"]}
    groups = {k: v["groups_ms"].get("lora_delta", 0.0) for k, v in profiles.items()}
    ratio = profiles["chunk piece"]["busy_ms"] / crec["chunk_piece_profile"]["busy_ms"]
    ok = (all(0 < groups[k] <= lim for k, lim in LORA_GROUP_MAX_MS.items())
          and ratio <= LORA_CHUNK_BUSY_RATIO)
    say(f"LoRA serves: lora_delta group ms per profiled step {groups} (at most "
        f"{LORA_GROUP_MAX_MS}); idle shares "
        f"{ {k: round(v['idle_share'], 3) for k, v in profiles.items()} }; the LoRA chunk "
        f"piece's busy {profiles['chunk piece']['busy_ms']:.3f} ms = {ratio:.3f} x phase 5's "
        f"{crec['chunk_piece_profile']['busy_ms']:.3f} (at most {LORA_CHUNK_BUSY_RATIO}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the LoRA serves' lora_delta group or chunk piece missed a bar")
    return dict(profiles, lora_delta_ms=groups, chunk_busy_ratio=ratio)


def layer_skip_draft(params, cfg, n_layer=2):
    """The target's own embedding, first ``n_layer`` blocks, final norm and
    head: a draft made from the target's weights, sharing its tensors."""
    return {**params, "blocks": params["blocks"][:n_layer]}, Config.from_name(cfg.name,
                                                                               n_layer=n_layer)


def spec_serve(params, cfg, K=4, n_requests=8, new_tokens=32, kv_dtype=None, self_draft=True,
               lora=None, profile=False):
    dparams, dcfg = layer_skip_draft(params, cfg)
    eng = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=1024, max_batch=8,
                speculative=SpecConfig(dparams, dcfg, K=K), kv_dtype=kv_dtype, lora=lora,
                device=DEVICE)
    rng = np.random.default_rng(SEED + 6)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(128, 1025, n_requests)]
    eng.run([prompts[0][:64]], max_new_tokens=8)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry().reset()
    rounds0 = eng.spec_rounds
    cudaex.reset_launches()
    t0 = time.perf_counter()
    handles = submit_all(eng, prompts, new_tokens, lora)
    eng.step()
    tables = [list(h._req.block_table) for h in handles]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cudaex.LAUNCHES)
    rounds = eng.spec_rounds - rounds0
    results = [h.result(drive=False) for h in handles]
    check_results(results, new_tokens, cfg.padded_vocab_size)
    st = eng.stats()["speculative"]
    tag = f", LoRA rank {lora.rank} on the target, ids {LORA_IDS}" if lora is not None else ""
    rec = serve_stats(f"speculative serve {cfg.name} bf16, kv_dtype {kv_dtype} (draft arena "
                      f"{eng.draft_pool.kv_dtype}), {dcfg.n_layer}-layer draft, K={K}{tag} "
                      f"(prompts {sorted(len(p) for p in prompts)})", results, wall)
    say(f"speculative serve: {rounds} rounds, acceptance rate {st['acceptance_rate']:.4f}, "
        f"tokens per round {st['tokens_per_round']:.3f}, accept_len histogram "
        f"{st['accept_len_hist']} (warm-up included)")
    # the masked pair write: K and V of every offset of a round in one
    # launch, bf16 or quantized
    writes = ({"paged_token_write_masked": rounds} if kv_dtype is None
              else {"paged_token_write_fused": rounds})
    want = no_launches_but(paged_attn_verify=rounds * cfg.n_layer, **writes,
                           **lora_launches(cfg, lora, rounds))
    say(f"launches during speculative serve: {launches} (expected {want}); pool "
        f"{eng.pool.num_blocks} blocks, arena {eng.pool.arena_bytes()} B")
    if launches != want or not rounds:
        raise AssertionError(f"speculative serve launch counts {launches} != {want} "
                             f"({rounds} rounds)")
    rec.update(launches=launches, rounds=rounds, acceptance_rate=st["acceptance_rate"],
               tokens_per_round=st["tokens_per_round"], blocks=eng.pool.num_blocks,
               arena_bytes=eng.pool.arena_bytes(),
               rel_err=check_gauge("speculative serve", kv_dtype),
               tenants=tenant_report("speculative LoRA serve", lora))
    if profile:        # one verify round of the 8 rows (the draft's K steps included)
        for p, a in zip(prompts, LORA_IDS if lora is not None else [None] * len(prompts)):
            eng.submit(p, max_new_tokens=8, adapter_id=a)
        eng.step()                                          # admits, prefills
        rec["verify_round_profile"] = profile_one_step(
            eng, "spec_rounds", "paged_attn_verify",
            f"speculative{' LoRA' if lora is not None else ''}"
            f"{f' {kv_dtype}' if kv_dtype is not None else ''} serve, one verify round (K={K})")
        eng.drain()
    if not self_draft:
        return rec, eng, prompts, results, tables
    # draft = target: every draft should be accepted (bf16 argmax flips
    # between the gathered draft path and the kernel verify path aside)
    same = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=256, max_batch=2,
                 speculative=SpecConfig(params, cfg, K=K), device=DEVICE)
    cudaex.reset_launches()
    res = same.run(prompts[:2], max_new_tokens=16)
    st2 = same.stats()["speculative"]
    check_results(res, 16, cfg.padded_vocab_size)
    say(f"speculative serve, draft = target: acceptance rate {st2['acceptance_rate']:.4f}, "
        f"accept_len histogram {st2['accept_len_hist']}, launches {dict(cudaex.LAUNCHES)}")
    if st2["accept_len_hist"][K + 1] == 0:
        raise AssertionError("draft = target never accepted all K drafts")
    rec["self_draft_acceptance_rate"] = st2["acceptance_rate"]
    return rec, eng, prompts, results, tables


#
# phase 7: correctness at full width
#


def _exact_tokens(params32, cfg4, n_new=8):
    """Tokens, exact, in float32 at Llama-3-8B widths and 4 layers:
    chunked = unchunked, speculative = plain."""
    rng = np.random.default_rng(SEED + 7)
    long = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (1100, 1600)]
    common = dict(attn="paged", block_size=16, num_blocks=512, max_batch=4, device=DEVICE)

    def tokens(eng, prompts, n):
        return [r.new_tokens for r in eng.run(prompts, max_new_tokens=n)]

    unchunked = tokens(serve(None, params32, cfg4, prefill_buckets=tuple(16 * 2 ** i
                                                                         for i in range(8)),
                             **common), long, n_new)
    chunked_eng = serve(None, params32, cfg4, prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS,
                        **common)
    chunked = tokens(chunked_eng, long, n_new)
    say(f"float32, 4 layers: chunked tokens {chunked} vs unchunked {unchunked} "
        f"({chunked_eng.chunk_runs} chunk pieces): {'equal' if chunked == unchunked else 'DIFFER'}")
    if chunked != unchunked:
        raise AssertionError("chunked prefill serves other tokens than the unchunked prefill")
    short = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (90, 200, 333, 411)]
    plain = tokens(serve(None, params32, cfg4, **common), short, 16)
    dparams, dcfg = layer_skip_draft(params32, cfg4)
    spec_eng = serve(None, params32, cfg4, speculative=SpecConfig(dparams, dcfg, K=4), **common)
    spec = tokens(spec_eng, short, 16)
    st = spec_eng.stats()["speculative"]
    say(f"float32, 4 layers: speculative tokens equal plain: {spec == plain} (acceptance rate "
        f"{st['acceptance_rate']:.4f}, {st['rounds']} rounds)")
    if spec != plain:
        raise AssertionError(f"speculative serving serves other tokens: {spec} vs {plain}")


def _exact_tokens_tiny(n_new=8):
    """tiny-llama-debug at its own head size (16): the default attn resolves
    paged on the card, every decode step goes through the kernels, and the
    float32 tokens equal the gather path's."""
    cfg = Config.from_name("tiny-llama-debug")
    params = init_params(cfg, generator=torch.Generator(DEVICE).manual_seed(SEED + 11),
                         dtype=torch.float32, device=DEVICE)
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (3, 17, 30, 61)]
    common = dict(block_size=16, num_blocks=64, max_batch=4, device=DEVICE)
    eng = serve(None, params, cfg, **common)
    cudaex.reset_launches()
    paged = [r.new_tokens for r in eng.run(prompts, max_new_tokens=n_new)]
    torch.cuda.synchronize()
    launches = cudaex.LAUNCHES["paged_attn_decode"]
    gather = [r.new_tokens for r in serve(None, params, cfg, attn="gather", **common).run(
        prompts, max_new_tokens=n_new)]
    ok = eng.attn == "paged" and launches == eng.decode_steps * cfg.n_layer > 0 and paged == gather
    say(f"float32, tiny-llama-debug (hs {cfg.head_size}): default attn {eng.attn!r}, "
        f"paged_attn_decode launches {launches} ({eng.decode_steps} decode steps x "
        f"{cfg.n_layer} layers); tokens equal gather: {paged == gather} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("tiny-llama-debug does not serve paged through the kernels with "
                             "the gather path's tokens")


def _exact_tokens_quant(params32, cfg4, n_new=8):
    """Tokens, exact, in float32 at Llama-3-8B widths and 4 layers on an
    int8 pool: the paged lanes (kernels) serve the gather lanes' tokens,
    unchunked and chunked.  Chunked against unchunked is reported, not
    held: a chunked prefill reads its earlier pieces back through the int8
    arena while an unchunked one attends them at full precision (the
    reference's chunk programs gather through ``gather_dense_q`` too), so
    the two are different computations that agree to the quantization
    error, and a near tie of two logits may flip."""
    rng = np.random.default_rng(SEED + 8)
    long = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (1100, 1600)]
    common = dict(block_size=16, num_blocks=512, max_batch=4, kv_dtype="int8", device=DEVICE)
    unchunked = dict(prefill_buckets=tuple(16 * 2 ** i for i in range(8)))
    chunked = dict(prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS)

    def tokens(**kw):
        eng = serve(None, params32, cfg4, **common, **kw)
        return [r.new_tokens for r in eng.run(long, max_new_tokens=n_new)]

    got = {(attn, name): tokens(attn=attn, **kw) for attn in ("paged", "gather")
           for name, kw in (("unchunked", unchunked), ("chunked", chunked))}
    same = {name: got["paged", name] == got["gather", name] for name in ("unchunked", "chunked")}
    rows = sum(a == b for a, b in zip(got["paged", "chunked"], got["paged", "unchunked"]))
    say(f"float32, 4 layers, int8 KV: paged = gather unchunked {same['unchunked']}, chunked "
        f"{same['chunked']}; chunked = unchunked on {rows} of {len(long)} rows (reported, not "
        f"held: the chunked prefill reads its earlier pieces through the int8 arena); "
        f"tokens {got}")
    if not all(same.values()):
        raise AssertionError(f"the int8 paged lanes serve other tokens than the gather lanes: "
                             f"{got}")


def _exact_tokens_lora(params32, cfg4, n_new=8):
    """LoRA tokens, exact, in float32 at Llama-3-8B widths and 4 layers:
    paged (the kernel) = gather (the plain delta); each request alone =
    mixed; every adapter changes the tokens of its prompt; a base request
    in a LoRA engine = a registry-free engine's; and two adapters with a
    shared 2-block prompt prefix each serve their solo tokens (no K/V
    shared across adapters), while a third request of the first adapter
    shares the prefix and serves its solo tokens too."""
    reg = make_registry(cfg4)
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (90, 200, 333, 411)]
    ids = [*LORA_ADAPTERS, None]
    common = dict(block_size=16, num_blocks=512, max_batch=4, device=DEVICE)

    def tokens(ps, ids_, lora=reg, attn="paged"):
        eng = serve(None, params32, cfg4, attn=attn, lora=lora, **common)
        hs = [eng.submit(p, max_new_tokens=n_new, adapter_id=a) for p, a in zip(ps, ids_)]
        eng.drain()
        return [h.result(drive=False).new_tokens for h in hs]

    cudaex.reset_launches()
    mixed = tokens(prompts, ids)
    kernel_launches = cudaex.LAUNCHES["lora_delta_fused"]
    gather = tokens(prompts, ids, attn="gather")
    solo = [tokens([p], [a])[0] for p, a in zip(prompts, ids)]
    base = tokens(prompts, [None] * 4)
    plain = tokens(prompts[3:], [None], lora=None)
    differ = [mixed[i] != base[i] for i in range(3)]
    say(f"float32, 4 layers, LoRA (rank {LORA_RANK}, scaling {reg.scaling}): paged = gather "
        f"{mixed == gather}; alone = mixed {solo == mixed}; adapters change their tokens "
        f"{differ}; base in a LoRA engine = registry-free {base[3] == plain[0] == mixed[3]} "
        f"(paged lora_delta_fused launches {kernel_launches}); tokens {mixed}")
    if not (mixed == gather and solo == mixed and all(differ) and base[3] == plain[0] == mixed[3]
            and kernel_launches > 0):
        raise AssertionError("LoRA float32 tokens: an equality failed")
    prefix = rng.integers(0, cfg4.vocab_size, 32).astype(np.int32)
    tails = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (40, 57, 23)]
    shared = [np.concatenate([prefix, t]) for t in tails]
    sids = [LORA_ADAPTERS[0], LORA_ADAPTERS[1], LORA_ADAPTERS[0]]
    eng = serve(None, params32, cfg4, attn="paged", lora=reg, **common)
    hs = []
    for p, a in zip(shared, sids):
        hs.append(eng.submit(p, max_new_tokens=n_new, adapter_id=a))
        eng.step()                                        # admit: the prefix registers
    eng.drain()
    got = [h.result(drive=False) for h in hs]
    want = [tokens([p], [a])[0] for p, a in zip(shared, sids)]
    blocks = [r.shared_prefix_blocks for r in got]
    ok = [r.new_tokens for r in got] == want and blocks == [0, 0, 2]
    say(f"float32, 4 layers, LoRA shared 2-block prefix: adapters {sids}, shared blocks "
        f"{blocks} (expected [0, 0, 2]), each = its solo run "
        f"{[r.new_tokens for r in got] == want} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("LoRA prefix sharing: a request differs from its solo run or "
                             "shared across adapters")


def _exact_tokens_lora_cases(params32, cfg4, n_new=8):
    """Two LoRA cases more, tokens exact in float32 at Llama-3-8B widths
    and 4 layers, paged (the kernel) = gather (the plain delta): MLP
    targets (wq..wo and fc_1/fc_2/proj: the kernel reads the attention
    targets' arenas by slot, the plain MLP deltas take theirs by slot layer
    by layer) and LoRA on an
    int8 pool; the paged lanes launch ``lora_delta_fused`` 4·n_layer times
    per decode step."""
    rng = np.random.default_rng(SEED + 14)
    prompts = [rng.integers(0, cfg4.vocab_size, n).astype(np.int32) for n in (90, 200, 333, 411)]
    ids = [*LORA_ADAPTERS, None]
    common = dict(block_size=16, num_blocks=512, max_batch=4, device=DEVICE)
    cases = {"MLP targets": (make_registry(cfg4, targets=valid_targets(cfg4)), {}),
             "int8 pool": (make_registry(cfg4), {"kv_dtype": "int8"})}
    for case, (reg, kw) in cases.items():
        got, launches = {}, {}
        for attn in ("paged", "gather"):
            eng = serve(None, params32, cfg4, attn=attn, lora=reg, **common, **kw)
            cudaex.reset_launches()
            hs = [eng.submit(p, max_new_tokens=n_new, adapter_id=a) for p, a in zip(prompts, ids)]
            eng.drain()
            torch.cuda.synchronize()
            got[attn] = [h.result(drive=False).new_tokens for h in hs]
            launches[attn] = (cudaex.LAUNCHES["lora_delta_fused"], eng.decode_steps)
        (n_paged, steps), (n_gather, _) = launches["paged"], launches["gather"]
        ok = got["paged"] == got["gather"] and n_paged == 4 * cfg4.n_layer * steps > 0 == n_gather
        say(f"float32, 4 layers, LoRA {case} (targets {list(reg.targets)}, KV "
            f"{kw.get('kv_dtype', 'float32')}): "
            f"paged = gather {got['paged'] == got['gather']}; paged lora_delta_fused launches "
            f"{n_paged} ({steps} decode steps), gather {n_gather}; tokens {got['paged']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"LoRA {case}: the paged lanes serve other tokens than gather, "
                                 "or the kernel's launches are off")


def _compact(arenas, table_rows):
    """The blocks ``table_rows`` list, copied into a small arena (block 0
    stays the sink) with the tables renumbered to match."""
    used = sorted({b for row in table_rows for b in row} - {SINK_BLOCK})
    remap = {b: i + 1 for i, b in enumerate(used)}
    idx = torch.as_tensor([SINK_BLOCK] + used, device=DEVICE)
    small = {k: arenas[k][idx] for k in ("k", "v")}
    return small, [[remap.get(b, SINK_BLOCK) for b in row] for row in table_rows]


def _logits_bars(name, lp, lg, lp32, lg32):
    err32 = (lp32 - lg32).abs().max().item()
    err_kernel = (lp - lg32).abs().max().item()
    err_dense = (lg - lg32).abs().max().item()
    ok = (bool(torch.isfinite(lp).all()) and err32 <= LOGITS_ATOL_F32
          and err_kernel <= BF16_ERR_RATIO * err_dense)
    say(f"{name} logits, kernels vs dense path (logits std {lg32.std().item():.3f}): float32 "
        f"max_abs_err={err32:.3e} (atol {LOGITS_ATOL_F32}); bf16 against float32 dense: kernel "
        f"path {err_kernel:.4f}, dense path {err_dense:.4f} (ratio limit {BF16_ERR_RATIO}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: forward_paged disagrees with forward_with_cache")
    return dict(f32_max_abs_err=err32, bf16_kernel_err=err_kernel, bf16_dense_err=err_dense)


def chunk_and_verify_logits(params, cfg, chunk_case, spec_case):
    """At full depth: the second prefill chunk (T=512 at pos 512) of a
    chunked-served request, and one verify chunk (T=5) at each speculative
    row's first decode position, through the kernels against
    ``forward_with_cache`` over the same gathered blocks, bf16 and float32.
    Each case carries its served blocks compacted into a small arena."""
    ((small, (row,)), chunk_prompt) = chunk_case
    ((spec_small, rows), spec_prompts, spec_results) = spec_case
    dev = DEVICE
    out = {}

    def run(p, arenas, tab, toks, pos_paged, pos_dense, cdtype, nbb):
        cos, sin = build_rope_cache(cfg, nbb * BS, device=dev)
        lp, _ = forward_paged(p, toks, pos_paged, arenas, tab, cos, sin, cfg, cdtype=cdtype)
        kd, vd = gather_dense(arenas["k"], arenas["v"], tab)
        lg, _ = forward_with_cache(p, toks, pos_dense, {"k": kd, "v": vd}, cos, sin, cfg)
        return lp, lg

    params32 = _cast(params, torch.float32)
    # one prefill chunk
    nbb = len(row)
    tab = torch.as_tensor([row], dtype=torch.int32, device=dev)
    toks = torch.as_tensor(chunk_prompt[CHUNK:2 * CHUNK], device=dev)[None]
    pv = torch.tensor([CHUNK], dtype=torch.int32, device=dev)
    with torch.no_grad():
        lp, lg = run(params, small, tab, toks, pv, CHUNK, torch.bfloat16, nbb)
        lp32, lg32 = run(params32, _cast(small, torch.float32), tab, toks, pv, CHUNK,
                         torch.float32, nbb)
    torch.cuda.synchronize()
    out["prefill_chunk"] = _logits_bars(f"prefill chunk (T={CHUNK}, pos {CHUNK}, "
                                        f"{cfg.n_layer} layers)",
                                        lp, lg, lp32, lg32)
    del lp, lg, lp32, lg32
    # one verify chunk per speculative row
    small = spec_small
    nbb = max(len(r) for r in rows)
    tab = torch.as_tensor([r + [SINK_BLOCK] * (nbb - len(r)) for r in rows], dtype=torch.int32,
                          device=dev)
    pos = torch.as_tensor([len(p) for p in spec_prompts], dtype=torch.int32, device=dev)
    toks = torch.as_tensor([r.new_tokens[:5] for r in spec_results], dtype=torch.int32,
                           device=dev)
    with torch.no_grad():
        lp, lg = run(params, small, tab, toks, pos, pos, torch.bfloat16, nbb)
        lp32, lg32 = run(params32, _cast(small, torch.float32), tab, toks, pos, pos,
                         torch.float32, nbb)
    torch.cuda.synchronize()
    out["verify"] = _logits_bars(f"verify chunk (T=5, {len(rows)} rows, {cfg.n_layer} layers)",
                                 lp, lg, lp32, lg32)
    del params32
    return out


#
# phase 8: the flash-attention kernels against their plain versions
#

# the training shape: Llama-3-8B attention at B=1, T=2048, causal
FB, FH, FG, FT, FHS = 1, 32, 8, 2048, 128
# float32: the same arithmetic in another summation order, within this
# share of each output's largest magnitude
FLASH_REL_F32 = 1e-5


def _flash_run(q, k, v, g, mask, kw, fwd, bwd):
    out, lse = fwd(q, k, v, mask, **kw)
    return (out, lse, *bwd(g, q, k, v, out, lse, mask, **kw))


FLASH_OUTPUTS = ("out", "lse", "dq", "dk", "dv")


def check_flash_case(label, q, k, v, g, mask, kw) -> float:
    """The kernels against their plain versions on one input set: float32
    within FLASH_REL_F32 of each output's largest magnitude; bf16 held
    against the float32 plain result of the same inputs, each output's
    error at most LOWP_ERR_RATIO times the plain version's own (lse, float32
    on both sides, under the float32 bar); every kernel run twice gives
    bitwise-equal outputs.  Returns the largest error against the plain
    version (bf16: of out, dq, dk, dv)."""
    got = _flash_run(q, k, v, g, mask, kw, cudaex.flash_sdpa, cudaex.flash_sdpa_backward)
    again = _flash_run(q, k, v, g, mask, kw, cudaex.flash_sdpa, cudaex.flash_sdpa_backward)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = _flash_run(q, k, v, g, mask, kw, cudaex.flash_sdpa_plain,
                      cudaex.flash_sdpa_backward_plain)
    errs = {n: (a.float() - b.float()).abs().max().item() for n, a, b in
            zip(FLASH_OUTPUTS, got, want)}
    bars = {n: FLASH_REL_F32 * max(1.0, b.float().abs().max().item())
            for n, b in zip(FLASH_OUTPUTS, want)}
    ok = same and all(bool(torch.isfinite(a).all()) for a in got)
    notes = []
    if q.dtype == torch.float32:
        ok = ok and all(errs[n] <= bars[n] for n in FLASH_OUTPUTS)
    else:
        ref = _flash_run(*(x.float() for x in (q, k, v, g)), mask, kw, cudaex.flash_sdpa_plain,
                         cudaex.flash_sdpa_backward_plain)
        ok = ok and errs["lse"] <= bars["lse"]
        for n, a, b, r in zip(FLASH_OUTPUTS, got, want, ref):
            if n == "lse":
                continue
            ek, ep = (a.float() - r).abs().max().item(), (b.float() - r).abs().max().item()
            ok = ok and ek <= LOWP_ERR_RATIO * ep
            notes.append(f"{n} {ek:.2e}/{ep:.2e}")
        del ref
    body = cudaex.flash_body("fwd", q.shape[-1], q.dtype, (q, k, v))[0]
    say(f"flash {label} {str(q.dtype)[6:]} ({body} body): max_abs_err vs plain "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + (f"; against float32 kernel/plain: {', '.join(notes)} (ratio limit {LOWP_ERR_RATIO})"
           if notes else f" (bar {FLASH_REL_F32:.0e} of each output's max)")
        + f"; bitwise repeatable: {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernels disagree with their plain versions ({label})")
    return max(e for n, e in errs.items() if n != "lse" or q.dtype == torch.float32)


def flash_inputs(gen, B_, H, G, Tq, Tk, hs, dtype, mask=None):
    dev = DEVICE
    x = [torch.randn(shape, generator=gen, device=dev).to(dtype)
         for shape in ((B_, H, Tq, hs), (B_, G, Tk, hs), (B_, G, Tk, hs), (B_, H, Tq, hs))]
    if mask is not None:
        layout, mq = mask
        mq = 1 if mq == 1 else Tq
        shape = {"shared": (mq, Tk), "batch": (B_, 1, mq, Tk), "head": (1, H, mq, Tk),
                 "full": (B_, H, mq, Tk)}[layout]
        bias = torch.randn(shape, generator=gen, device=dev)
        drop = torch.rand(shape, generator=gen, device=dev) < 0.25
        mask = torch.where(drop, cudaex.MASK_VALUE, bias)
    return x, mask


# small shapes: non-causal, a window, Tq != Tk, hs 64 and 256, each mask
# layout with mq 1 and Tq (B, H, G, Tq, Tk, hs, causal, window, mask)
FLASH_SMALL = [
    (2, 4, 4, 256, 256, 64, False, None, None),
    (1, 8, 2, 256, 256, 64, True, 100, None),
    (1, 8, 2, 128, 256, 64, True, None, None),
    (1, 4, 2, 256, 128, 256, False, None, None),
    (2, 4, 2, 128, 128, 64, False, None, ("shared", 1)),
    (2, 4, 2, 128, 128, 64, False, None, ("shared", "T")),
    (2, 4, 2, 128, 128, 64, False, None, ("batch", 1)),
    (2, 4, 2, 128, 128, 64, False, None, ("batch", "T")),
    (2, 4, 2, 128, 128, 64, False, None, ("head", 1)),
    (2, 4, 2, 128, 128, 64, False, None, ("head", "T")),
    (2, 4, 2, 128, 128, 64, False, None, ("full", 1)),
    (2, 4, 2, 128, 128, 64, False, None, ("full", "T")),
]


def flash_bounds(dtype):
    """(bytes, operations) each kernel needs at the training shape: inputs
    read once, outputs written once; the causal pairs' products (the
    forward 2, the dq kernel 3, the dk/dv kernel 4)."""
    esize = torch.empty((), dtype=dtype).element_size()
    qn, kn = FB * FH * FT * FHS, FB * FG * FT * FHS
    rows = FB * FH * FT
    pairs = FB * FH * FT * (FT + 1) // 2
    per_product = 2 * FHS * pairs
    return {
        "flash_fwd": bound(esize * (2 * qn + 2 * kn) + 4 * rows, 2 * per_product, dtype),
        "flash_bwd_dq": bound(esize * (3 * qn + 2 * kn) + 8 * rows, 3 * per_product, dtype),
        "flash_bwd_dkv": bound(esize * (2 * qn + 4 * kn) + 8 * rows, 4 * per_product, dtype),
    }


def check_flash():
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    result = {}
    kw = dict(causal=True, scale=FHS ** -0.5, window=None)
    for dtype in (torch.bfloat16, torch.float32):
        (q, k, v, g), _ = flash_inputs(gen, FB, FH, FG, FT, FT, FHS, dtype)
        err = check_flash_case(f"training shape B={FB} H={FH} G={FG} T={FT} hs={FHS} causal",
                               q, k, v, g, None, kw)
        if dtype == torch.bfloat16:
            result = time_flash(q, k, v, g, kw)
            for name in result:
                result[name]["max_abs_err"] = err
        del q, k, v, g
    for B_, H, G, Tq, Tk, hs, causal, window, mask in FLASH_SMALL:
        for dtype in (torch.bfloat16, torch.float32):
            (q, k, v, g), m = flash_inputs(gen, B_, H, G, Tq, Tk, hs, dtype, mask)
            check_flash_case(f"B={B_} H={H} G={G} Tq={Tq} Tk={Tk} hs={hs} causal={causal} "
                             f"window={window} mask={mask}", q, k, v, g, m,
                             dict(causal=causal, scale=hs ** -0.5, window=window))
    return result


def time_flash(q, k, v, g, kw):
    """Times of the three kernels, their plain versions and the library
    yardstick (``F.scaled_dot_product_attention(..., is_causal=True,
    enable_gqa=True)``: its forward beside ``flash_fwd``, its backward
    through autograd, which computes dq, dk and dv together, beside each
    backward kernel) at the training shape, beside the bounds.  The device
    times count the kernels of the body the wrappers pick (the dk/dv time
    includes the fixed-order sum of its split partials)."""
    out, lse = cudaex.flash_sdpa(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(dim=-1)
    mask3, ints = cudaex._flash_args(q, k, None, kw["causal"], kw["window"])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    body = cudaex.flash_body("fwd", q.shape[-1], q.dtype, (q, k, v))[0]
    tag = "_wg" if body == "wgmma" else ""

    def dq_kernel():       # the dq launch alone, as flash_sdpa_backward makes it
        cudaex._flash_bwd_dq(g, q, k, v, lse, delta, mask3, ints, kw["scale"], dq)

    def dkv_kernel():
        cudaex._flash_bwd_dkv(g, q, k, v, lse, delta, mask3, ints, kw["scale"], dk, dv)

    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)

    def lib_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    def lib_bwd():
        torch.autograd.grad(lib_out, (ql, kl, vl), g, retain_graph=True)

    bounds = flash_bounds(q.dtype)
    rec = {
        "flash_fwd": timed("flash_fwd", "", lambda: cudaex.flash_sdpa(q, k, v, **kw),
                           lambda: cudaex.flash_sdpa_plain(q, k, v, **kw), lib_fwd,
                           "SDPA forward", bounds["flash_fwd"], iters=20, plain_iters=3,
                           plain_warmup=1, device_kernel=f"flash_fwd{tag}_kernel"),
        "flash_bwd_dq": timed("flash_bwd_dq", "", dq_kernel,
                              lambda: cudaex.flash_sdpa_backward_plain(g, q, k, v, out, lse, **kw),
                              lib_bwd, "SDPA backward (dq, dk, dv)", bounds["flash_bwd_dq"],
                              iters=20, plain_iters=3, plain_warmup=1,
                              device_kernel=f"flash_bwd_dq{tag}_kernel"),
        "flash_bwd_dkv": timed("flash_bwd_dkv", "", dkv_kernel,
                               lambda: cudaex.flash_sdpa_backward_plain(g, q, k, v, out, lse,
                                                                        **kw),
                               lib_bwd, "SDPA backward (dq, dk, dv)", bounds["flash_bwd_dkv"],
                               iters=20, plain_iters=3, plain_warmup=1,
                               device_kernel=f"flash_bwd_dkv{tag}_kernel",
                               device_also=("flash_dkv_sum_kernel",)),
    }
    for name in rec:
        rec[name]["body"] = body
    say("flash plain times: the backward's plain version computes dq, dk and dv together, "
        "so both backward rows carry the same plain time")
    return rec


#
# phases 9-10: train Llama-3-8B at full width
#

TRAIN_B, TRAIN_T, TRAIN_LR, TRAIN_STEPS = 1, 2048, 1e-4, 4
TRAIN_LOSS_REL = 1e-5       # float32 step, kernels vs plain versions
TRAIN_GRAD_REL = 1e-4       # each grad, of its own largest magnitude
# the bf16 loss is one number, a mean of 2048 row losses: its error against
# float32 is rounding noise of ~1e-5 relative on either path, so a ratio of
# two such errors means little; it may exceed twice the plain path's by this
# share of the loss (the grads, millions of numbers, take the bare ratio)
TRAIN_LOSS_FLOOR_BF16 = 1e-4


def train_batch(cfg, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    idx = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T), generator=gen, device=DEVICE)
    tgt = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T), generator=gen, device=DEVICE)
    cos, sin = build_rope_cache(cfg, TRAIN_T, device=DEVICE)
    return idx, tgt, cos, sin


def make_step(cfg, remat="full_block", executors=None):
    """The train step over the trace (the main path; ``executors`` None:
    the defaults, cuda ≻ inductor ≻ torch)."""
    return make_train_step(lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg),
                           adamw(TRAIN_LR), remat=remat, executors=executors)


def make_eager_step(cfg, remat="full_block"):
    """The step's plain twin: eager autograd through ``ltorch``."""
    return make_eager_train_step(lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg),
                                 adamw(TRAIN_LR), remat=remat)


@contextlib.contextmanager
def plain_kernels():
    """The attention and cross-entropy functions call the kernels' plain
    versions."""
    saved, saved_ce = dict(ltorch.FLASH), dict(ltorch.CE)
    ltorch.FLASH.update(forward=cudaex.flash_sdpa_plain,
                        backward=cudaex.flash_sdpa_backward_plain)
    ltorch.CE.update(forward=cudaex.flash_cross_entropy_plain)
    try:
        yield
    finally:
        ltorch.FLASH.update(saved)
        ltorch.CE.update(saved_ce)


def _worst_grad_rel(got, want) -> tuple[float, str]:
    worst, worst_name = -1.0, None
    for name, a, b in zip(_names(want), tree_leaves(got), tree_leaves(want)):
        rel = (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def train_correctness(params, cfg):
    """One step's loss and grads at Llama-3-8B widths and 4 layers.  The
    eager twin through the kernels (flash attention and the fused
    cross-entropy) against their plain versions: float32 (TF32 off) within
    TRAIN_LOSS_REL / TRAIN_GRAD_REL; bf16 held against the float32 kernel
    step, the kernel path's error at most LOWP_ERR_RATIO times the plain
    path's own (loss, and the relative L2 error of all grads).  Then the
    traced step (the main path) against the eager twin: float32 within the
    same bars, bf16 against the float32 eager step within LOWP_ERR_RATIO
    times the eager bf16 step's own error."""
    cfg4 = Config.from_name(cfg.name, n_layer=4)
    batch = train_batch(cfg4, SEED + 9)
    eager = make_eager_step(cfg4)
    traced = make_step(cfg4)
    p16 = {**params, "blocks": params["blocks"][:4]}
    p32 = _cast(p16, torch.float32)
    cudaex.reset_launches()
    loss_k, g_k = eager.grads(p32, None, *batch)
    if cudaex.LAUNCHES["flash_ce"] != 1:
        raise AssertionError(f"the float32 step launched flash_ce {cudaex.LAUNCHES['flash_ce']} "
                             "times, not once")
    with plain_kernels():
        loss_p, g_p = eager.grads(p32, None, *batch)
    torch.cuda.synchronize()
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst, worst_name = _worst_grad_rel(g_k, g_p)
    ok = loss_err <= TRAIN_LOSS_REL and worst <= TRAIN_GRAD_REL and math.isfinite(loss_k.item())
    say(f"train step float32, {cfg4.n_layer} layers at full width (B={TRAIN_B}, T={TRAIN_T}): "
        f"loss kernels {loss_k.item():.6f} plain {loss_p.item():.6f} (rel {loss_err:.2e}, bar "
        f"{TRAIN_LOSS_REL:.0e}); worst grad rel max-abs diff {worst:.2e} ({worst_name}, bar "
        f"{TRAIN_GRAD_REL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the float32 train step through the kernels disagrees with the "
                             "plain versions")
    del g_p
    loss_t, g_t = traced.grads(p32, None, *batch)
    torch.cuda.synchronize()
    t_err = abs(loss_t.item() - loss_k.item()) / abs(loss_k.item())
    t_worst, t_name = _worst_grad_rel(g_t, g_k)
    ok = t_err <= TRAIN_LOSS_REL and t_worst <= TRAIN_GRAD_REL and math.isfinite(loss_t.item())
    say(f"traced train step float32 against the eager twin ({cfg4.n_layer} layers, remat "
        f"{traced.last_remat_policy}): loss {loss_t.item():.6f} eager {loss_k.item():.6f} (rel "
        f"{t_err:.2e}, bar {TRAIN_LOSS_REL:.0e}); worst grad rel max-abs diff {t_worst:.2e} "
        f"({t_name}, bar {TRAIN_GRAD_REL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the float32 traced train step disagrees with the eager twin")
    del p32, g_t
    loss16_k, g16_k = eager.grads(p16, None, *batch)
    with plain_kernels():
        loss16_p, g16_p = eager.grads(p16, None, *batch)
    loss16_t, g16_t = traced.grads(p16, None, *batch)
    torch.cuda.synchronize()

    def l2_err(gs):
        num = sum(((a.float() - r) ** 2).sum().item() for a, r in zip(tree_leaves(gs),
                                                                       tree_leaves(g_k)))
        den = sum((r ** 2).sum().item() for r in tree_leaves(g_k))
        return math.sqrt(num / den)

    lk, lp = abs(loss16_k.item() - loss_k.item()), abs(loss16_p.item() - loss_k.item())
    gk, gp = l2_err(g16_k), l2_err(g16_p)
    floor = TRAIN_LOSS_FLOOR_BF16 * abs(loss_k.item())
    ok = lk <= LOWP_ERR_RATIO * lp + floor and gk <= LOWP_ERR_RATIO * gp
    say(f"train step bf16 against the float32 step: loss error kernels {lk:.3e} plain {lp:.3e} "
        f"(limit {LOWP_ERR_RATIO}× plain + {floor:.2e}); grads relative L2 error kernels "
        f"{gk:.3e} plain {gp:.3e} (ratio limit {LOWP_ERR_RATIO}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 train step through the kernels strays further from float32 "
                             "than the plain versions")
    lt, gt = abs(loss16_t.item() - loss_k.item()), l2_err(g16_t)
    ok = lt <= LOWP_ERR_RATIO * lk + floor and gt <= LOWP_ERR_RATIO * gk
    say(f"traced train step bf16 against the float32 eager step: loss error traced {lt:.3e} "
        f"eager {lk:.3e} (limit {LOWP_ERR_RATIO}× eager + {floor:.2e}); grads relative L2 error "
        f"traced {gt:.3e} eager {gk:.3e} (ratio limit {LOWP_ERR_RATIO}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 traced train step strays further from float32 than the "
                             "eager twin")
    return dict(loss_rel_f32=loss_err, grad_rel_f32=worst, bf16_loss_err=(lk, lp),
                bf16_grad_l2=(gk, gp), traced_loss_rel_f32=t_err, traced_grad_rel_f32=t_worst,
                traced_bf16_loss_err=lt, traced_bf16_grad_l2=gt)


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _names(x, f"{prefix}[{i}]")
    else:
        yield prefix


def model_flops(cfg, n_params):
    """6·N·B·T (the matmuls of forward and backward, every parameter
    counted) + 3·n_layer·4·B·nh·hs·T²/2 (causal attention, forward and a
    backward of twice the forward); no remat recompute."""
    attn = 4 * TRAIN_B * cfg.n_head * cfg.head_size * TRAIN_T ** 2 / 2
    return 6 * n_params * TRAIN_B * TRAIN_T + 3 * cfg.n_layer * attn


# SDPA symbols per layer in the traced step's forward and backward programs
# under full_block: the forward's, and its recompute in the backward (the
# CPU tests fix this count against the reference's traces); the loss's CE
# is recomputed there too
TRAIN_SDPA_PER_LAYER = 2
TRAIN_EAGER_STEPS = 3       # the eager twin's steps beside the traced ones


def _symbols(step) -> dict:
    """Bound-symbol names of the traced step's claimed programs, counted."""
    names = [b.sym.name for tr in (step.fw_trace, step.bw_trace) for b in tr.bound_symbols]
    return {n: names.count(n) for n in sorted(set(names))}


def _stray(step, syms) -> list[str]:
    """Symbols of the step's programs other than ``cuda_*``, ``torch_*`` and
    fusion regions, and what a region holds that it may not."""
    fusions = {b.sym.name for tr in (step.fw_trace, step.bw_trace) for b in tr.bound_symbols
               if b.sym.is_fusion}
    return ([n for n in syms if not n.startswith(("cuda_", "torch_")) and n not in fusions
             and n != "python_return"] + region_problems([step.fw_trace, step.bw_trace]))


def _n_regions(step) -> tuple[int, int]:
    return tuple(sum(b.sym.is_fusion for b in tr.bound_symbols)
                 for tr in (step.fw_trace, step.bw_trace))


def step_launches_want(step, n_steps: int, L: int, label: str) -> dict:
    """The launches ``n_steps`` runs of the traced ``step`` must count, read
    from its programs: ``TRAIN_SDPA_PER_LAYER`` x L ``cuda_sdpa`` (each a
    ``flash_fwd``), L ``cuda_sdpa_backward`` (a ``flash_bwd_dq`` and a
    ``flash_bwd_dkv`` each) and every ``torch_cross_entropy_fwd`` (a
    ``flash_ce``) per step, nothing else.  Fails on a program symbol other
    than ``cuda_*``, ``torch_*`` and fusion regions, on a region holding
    what it may not, or on other kernel symbol counts."""
    syms = _symbols(step)
    stray = _stray(step, syms)
    n_sdpa, n_bwd, n_ce = (syms.get(k, 0) for k in ("cuda_sdpa", "cuda_sdpa_backward",
                                                     "torch_cross_entropy_fwd"))
    say(f"{label} programs: {len(step.fw_trace.bound_symbols)} forward and "
        f"{len(step.bw_trace.bound_symbols)} backward bound symbols; cuda_sdpa {n_sdpa} "
        f"(expected {TRAIN_SDPA_PER_LAYER} x {L}), cuda_sdpa_backward {n_bwd}, "
        f"torch_cross_entropy_fwd {n_ce}, fusion regions {_n_regions(step)}; other than "
        f"cuda_/torch_/regions, or in a region what may not be there: {stray}")
    if stray or n_sdpa != TRAIN_SDPA_PER_LAYER * L or n_bwd != L or not n_ce:
        raise AssertionError(f"{label}: the traced step's programs: {syms}")
    return no_launches_but(flash_fwd=n_sdpa * n_steps, flash_bwd_dq=n_bwd * n_steps,
                           flash_bwd_dkv=n_bwd * n_steps, flash_ce=n_ce * n_steps)


def _run_steps(step, params, opt_state, batch, n, after=None):
    """``n`` steps: losses, wall times (each waits for its loss), peak
    memory, launches and declines counted over them.  ``after(i, params)``
    runs after step ``i``, outside its time."""
    torch.cuda.reset_peak_memory_stats()
    cudaex.reset_launches()
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    losses, times = [], []
    for i in range(n):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, *batch)
        losses.append(loss.item())                     # waits for the step
        times.append(time.perf_counter() - t0)
        if after is not None:
            after(i, params)
    return (params, opt_state, losses, times, torch.cuda.max_memory_allocated(),
            dict(cudaex.LAUNCHES), dict(ltorch.DECLINES))


def train_full_width(params, cfg):
    """TRAIN_STEPS AdamW steps of Llama-3-8B at full width and depth on one
    fixed batch, remat full_block, bf16, through the traced step: its
    programs run ``cuda_*``, ``torch_*`` and fusion symbols only (each
    region holding only torch-implementable, non-random prims), exact launch
    counts read from them, no declines, finite losses, the last below the
    first; then TRAIN_EAGER_STEPS steps of the eager twin, printed beside;
    then two more traced steps under the profiler
    (``compare_train_profiles``); then phase 16 (b) (``fusion_train``)."""
    batch = train_batch(cfg, SEED + 10)
    step = make_step(cfg)
    t0 = time.perf_counter()
    opt_state = step.init_optimizer_state(params)
    torch.cuda.synchronize()
    say(f"AdamW state for {param_count(params) / 1e9:.3f} B params in "
        f"{time.perf_counter() - t0:.1f} s; memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # phase 20's reference: the start's and the DIST_STEPS-th step's digests
    PHASE10_REF["initial"] = param_digest(params)

    def keep(i, p):
        if i == DIST_STEPS - 1:
            PHASE10_REF["digest"] = param_digest(p)

    params, opt_state, losses, times, peak, launches, declines = _run_steps(
        step, params, opt_state, batch, TRAIN_STEPS, after=keep)
    L = cfg.n_layer
    want = step_launches_want(step, TRAIN_STEPS, L, "traced step")
    step_s = float(np.mean(times[1:]))
    PHASE10_STEP_MS.append(round(1e3 * step_s, 1))
    PHASE10_REF.update(losses=losses[:DIST_STEPS], step_ms=1e3 * step_s, peak_gib=peak / 2**30,
                       build_ms=step.build_ms)
    flops = model_flops(cfg, param_count(params))
    bw_peak = peak_live_bytes(del_last_used(step.bw_trace))
    say(f"train {cfg.name} bf16 through the trace, {L} layers, B={TRAIN_B} T={TRAIN_T}, remat "
        f"{step.last_remat_policy}, AdamW lr {TRAIN_LR}: losses {losses}; step times "
        f"{[round(t, 4) for t in times]} s (first includes the build, {step.build_ms:.0f} ms of "
        f"host for both programs); step time (steps 2-{TRAIN_STEPS}) {1e3 * step_s:.1f} ms = "
        f"{TRAIN_B * TRAIN_T / step_s:.1f} tokens/s; model FLOPs per step {flops:.4e} (6·N·B·T + "
        f"3·n_layer·4·B·nh·hs·T²/2, N = {param_count(params)}) = "
        f"{flops / step_s / 1e12:.1f} TFLOP/s, "
        f"{flops / step_s / PEAK_OPS_PER_S[torch.bfloat16]:.4f} of 989 TFLOP/s; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; saved_bytes {step.residual_bytes_no_remat} "
        f"before remat, {step.residual_bytes} after (parameters included); the backward "
        f"program's live-bytes peak by trace {bw_peak / 2**30:.2f} GiB ({CARD})")
    say(f"launches during {TRAIN_STEPS} traced train steps: {launches} (expected {want}); "
        f"declines {declines}")
    if launches != want or any(declines.values()):
        raise AssertionError(f"train launch counts {launches} != {want} or declines {declines}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}: not finite or not falling")
    # the eager twin, on the same params and optimizer state from here
    gc.collect()
    torch.cuda.empty_cache()
    eager = make_eager_step(cfg)
    params, opt_state, e_losses, e_times, e_peak, e_launches, e_declines = _run_steps(
        eager, params, opt_state, batch, TRAIN_EAGER_STEPS)
    e_step_s = float(np.mean(e_times[1:]))
    say(f"train step, traced against the eager twin ({cfg.name} bf16, {L} layers, B={TRAIN_B} "
        f"T={TRAIN_T}, full_block, the same run; {CARD}): step time {1e3 * step_s:.1f} ms "
        f"against {1e3 * e_step_s:.1f} ms; tokens/s {TRAIN_B * TRAIN_T / step_s:.1f} against "
        f"{TRAIN_B * TRAIN_T / e_step_s:.1f}; share of 989 TFLOP/s "
        f"{flops / step_s / PEAK_OPS_PER_S[torch.bfloat16]:.4f} against "
        f"{flops / e_step_s / PEAK_OPS_PER_S[torch.bfloat16]:.4f}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB against {e_peak / 2**30:.2f} GiB; eager losses {e_losses}, "
        f"step times {[round(t, 4) for t in e_times]} s; eager launches {e_launches}, declines "
        f"{e_declines}")
    profiles = compare_train_profiles(step, params, opt_state, batch)
    # the comparison's launches are its own, checked there: the main
    # path's counts are the TRAIN_STEPS steps above
    fusion = fusion_train(step, cfg, params, opt_state, batch, dict(
        step_ms=1e3 * step_s, peak=peak, profile=profiles and profiles["redesigned"]))
    return dict(launches=launches, losses=losses, step_ms=1e3 * step_s, peak_gib=peak / 2**30,
                fusion=fusion,
                build_ms=step.build_ms, residual_bytes=(step.residual_bytes_no_remat,
                                                        step.residual_bytes),
                eager=dict(step_ms=1e3 * e_step_s, peak_gib=e_peak / 2**30, losses=e_losses),
                profiles=profiles)


def fusion_train(step, cfg, params, opt_state, batch, fused) -> dict:
    """Phase 16 (b): the traced step of phase 10 (fused, the default
    executors) against the same step on the unfused executors, on the same
    params: step time, device busy by kernel group, peak memory; the fused
    step's peak beside its programs' donated-aware estimate and
    ``examine.train_memory_report``.  The fused busy must not exceed the
    unfused.  The unfused step's launches are held exactly against its own
    programs' kernel symbols (``step_launches_want``), apart from the main
    path's counts."""
    gc.collect()
    torch.cuda.empty_cache()
    unfused = make_step(cfg, executors=UNFUSED)
    params, opt_state, _, times, peak, launches, declines = _run_steps(
        unfused, params, opt_state, batch, FUSION_TRAIN_STEPS)
    want = step_launches_want(unfused, FUSION_TRAIN_STEPS, cfg.n_layer, "unfused traced step")
    if _n_regions(unfused) != (0, 0):
        raise AssertionError(f"the unfused traced step holds regions {_n_regions(unfused)}")
    say(f"launches during {FUSION_TRAIN_STEPS} unfused traced train steps: {launches} "
        f"(expected {want}); declines {declines}")
    if launches != want or any(declines.values()):
        raise AssertionError(f"unfused train launch counts {launches} != {want} or declines "
                             f"{declines}")
    prof = profile_train_step(unfused, params, opt_state, batch, "unfused executors")
    report = examine.train_memory_report(step)
    new = fused["profile"]
    step_ms = 1e3 * float(np.mean(times[1:]))
    ok = new is not None and prof is not None and new["busy_ms"] <= prof["busy_ms"]
    say(f"phase 16 (b) traced train step, fused against unfused ({cfg.name} bf16, "
        f"{cfg.n_layer} layers, B={TRAIN_B} T={TRAIN_T}, full_block; {CARD}): step "
        f"{fused['step_ms']:.1f} ms against {step_ms:.1f} ms; device busy "
        f"{new and round(new['busy_ms'], 3)} ms against {prof and round(prof['busy_ms'], 3)} ms "
        f"{'ok' if ok else 'FAIL'} (the fused busy at most the unfused); by group fused "
        f"{new and {k: round(v, 3) for k, v in new['groups'].items()}}, unfused "
        f"{prof and {k: round(v, 3) for k, v in prof['groups'].items()}}; regions "
        f"{_n_regions(step)} (forward, backward); max_memory_allocated "
        f"{fused['peak'] / 2**30:.2f} GiB fused against {peak / 2**30:.2f} GiB unfused; the "
        f"fused programs' donated-aware peak estimate "
        f"{report.get('peak_bytes_estimate', 0) / 2**30:.2f} GiB; train_memory_report "
        f"{json.dumps(report)}")
    if not ok:
        raise AssertionError("phase 16 (b): the fused traced step is busier than the unfused")
    del unfused
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_ms=fused["step_ms"], unfused_step_ms=step_ms,
                busy_ms=new["busy_ms"], unfused_busy_ms=prof["busy_ms"],
                groups=new["groups"], unfused_groups=prof["groups"],
                peak_gib=fused["peak"] / 2**30, unfused_peak_gib=peak / 2**30,
                memory_report=report, unfused_launches={k: n for k, n in launches.items() if n})


FUSION_TRAIN_STEPS = 2      # the unfused step's: its build, then one timed


FLASH_GROUPS = ("flash fwd", "flash dq", "flash dk/dv")


def _kernel_group(name: str) -> str:
    low = name.lower()
    return ("flash fwd" if "flash_fwd" in low
            else "flash dq" if "flash_bwd_dq" in low
            else "flash dk/dv" if "flash_bwd_dkv" in low or "flash_dkv_sum" in low
            else "flash ce" if "flash_ce_kernel" in low
            else "cuBLAS GEMMs" if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma",
                                                          "nvjet"))
            else "optimizer" if "adam" in low
            else "collectives" if "nccl" in low
            else "the rest")


def profile_train_step(step, params, opt_state, batch, label):
    """Device time of one more train step by kernel group, from the
    profiler's CUDA activity, the card's idle share of its kernel span, and
    the flash kernels' names; None when the profiler sees no CUDA
    activity."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, *batch)[2].item()
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        say(f"train step profile ({label}): not measured (the profiler saw no CUDA activity)")
        return None
    busy = sum(end - start for _, start, end in spans)
    window = max(end for *_, end in spans) - min(start for _, start, _ in spans)
    groups: dict[str, float] = {}
    names = set()
    for name, start, end in spans:
        key = _kernel_group(name)
        groups[key] = groups.get(key, 0.0) + (end - start)
        found = re.search(r"flash_\w+", name)
        if key in FLASH_GROUPS and found:
            names.add(found.group(0))
    groups = {k: v / 1e3 for k, v in groups.items()}
    say(f"train step profile ({label}): device busy {busy / 1e3:.3f} ms over a "
        f"{window / 1e3:.3f} ms kernel span (idle share {1 - busy / window:.4f}); device ms by "
        f"group: { {k: round(v, 3) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])} }"
        f"; flash kernels: {sorted(names)}")
    return dict(busy_ms=busy / 1e3, span_ms=window / 1e3, groups=groups, names=sorted(names))


@contextlib.contextmanager
def wmma_flash_body():
    """The flash wrappers take the WMMA body (the earlier tensor-core body)
    where they would take the warpgroup body: the same run's yardstick for
    the redesign."""
    pick = cudaex.flash_body

    def wmma(kind, hs, dtype, tensors=()):
        body, R, KT = pick(kind, hs, dtype, tensors)
        if body != "wgmma":
            return body, R, KT
        R, KT = next(rk for rk in cudaex._FLASH_TILES
                     if cudaex._flash_smem(kind, *rk, hs, 2, "wmma") <= cudaex._MAX_SMEM_BYTES)
        return "wmma", R, KT

    cudaex.flash_body = wmma
    try:
        yield
    finally:
        cudaex.flash_body = pick


# the step's device time must fall by at least this share of the flash
# kernels' own saving, both read from profiles of two steps in one run
TRAIN_FALL_SHARE = 0.9


def compare_train_profiles(step, params, opt_state, batch):
    """One profiled step on the kernels the wrappers pick, one on the WMMA
    body: the flash groups' saving and the step's device-time fall."""
    new = profile_train_step(step, params, opt_state, batch, "redesigned flash body")
    with wmma_flash_body():
        old = profile_train_step(step, params, opt_state, batch, "WMMA flash body")
    if new is None or old is None:
        return None
    want = {"flash_fwd_wg_kernel", "flash_bwd_dq_wg_kernel", "flash_bwd_dkv_wg_kernel",
            "flash_dkv_sum_kernel"}
    if set(new["names"]) != want:
        raise AssertionError(f"the train step ran flash kernels {new['names']}, not the "
                             f"warpgroup body's {sorted(want)}")
    saving = sum(old["groups"].get(g, 0.0) - new["groups"].get(g, 0.0) for g in FLASH_GROUPS)
    fall = old["busy_ms"] - new["busy_ms"]
    ok = fall >= TRAIN_FALL_SHARE * saving
    say(f"train step device time: {old['busy_ms']:.3f} ms on the WMMA body, {new['busy_ms']:.3f} "
        f"ms redesigned: fell {fall:.3f} ms against the flash groups' saving {saving:.3f} ms "
        f"(at least {TRAIN_FALL_SHARE} of it) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the train step's device time fell by less than the flash kernels' "
                             "saving")
    return dict(redesigned=new, wmma=old, flash_saving_ms=saving, step_fall_ms=fall)


#
# phase 11: a Llama-3-8B layer and its loss through the trace IR
#

IR_T = 2048                 # B=1, the training step's sequence
RMS_EPS = 1e-5              # Llama-3's norm_eps
IR_LOSS_REL = 1e-5          # float32: the traced loss against the eager layer's
IR_OUT_REL = 1e-4           # float32: the block output, of its largest magnitude
IR_REJECTS = {"a CPU tensor": "device changed", "a wrong dtype": "dtype changed",
              "a wrong shape": "shape changed"}


def ir_layer_loss(clang, prims, x, cos, sin, params, targets):
    """One Llama-3 block and the loss over its output, written in the IR's
    language, so that one source runs through either stack: ``clang`` and
    ``prims`` are ``thunder_tpu_torch.clang`` and ``thunder_tpu_torch.core.prims``
    here, the JAX package's own in the CPU tests.

    ``x`` (B, T, C) hidden states; ``cos``/``sin`` (T, hs) float32 from
    ``build_rope_cache``; ``params`` ``{"block": one block's params, "ln_f":
    ..., "lm_head": ...}`` in ``init_params``' layout; ``targets`` (B·T,)
    class ids.  It computes what ``models/llama.py``'s ``block_forward``
    computes for a Llama-3 block (RMSNorm, q/k/v projections, RoPE, causal
    GQA attention through ``prims.sdpa``, ``wo``, the residual, RMSNorm and
    the SwiGLU MLP), then the final norm, the head,
    ``prims.cross_entropy_fwd`` over float32 logits and the mean.  Returns
    ``(loss, block output)``."""
    f32 = cos.dtype
    bp, ap, mp = params["block"], params["block"]["attn"], params["block"]["mlp"]
    B, T, _ = x.shape
    hs = cos.shape[-1]
    nh, ng = ap["wq"].shape[0] // hs, ap["wk"].shape[0] // hs

    def rms_norm(t, w):
        tf = clang.maybe_convert_to_dtype(t, f32)
        ms = clang.mean(clang.mul(tf, tf), -1, True)
        tf = clang.mul(tf, clang.rsqrt(clang.add(ms, RMS_EPS)))
        return clang.maybe_convert_to_dtype(clang.mul(tf, clang.maybe_convert_to_dtype(w, f32)),
                                            t.dtype)

    def heads(t, n):                    # (B, T, n·hs) → (B, n, T, hs)
        return clang.transpose(clang.reshape(t, (B, T, n, hs)), 1, 2)

    def rope(t):
        half = hs // 2
        rotated = clang.cat([clang.neg(clang.slice_in_dim(t, half, hs, dim=3)),
                             clang.slice_in_dim(t, 0, half, dim=3)], 3)
        return clang.maybe_convert_to_dtype(
            clang.add(clang.mul(t, cos), clang.mul(rotated, sin)), t.dtype)

    n1 = rms_norm(x, bp["norm_1"])
    q = rope(heads(clang.linear(n1, ap["wq"]), nh))
    k = rope(heads(clang.linear(n1, ap["wk"]), ng))
    v = heads(clang.linear(n1, ap["wv"]), ng)
    y, _ = prims.sdpa(q, k, v, None, True, 1.0 / math.sqrt(hs), None)
    y = clang.reshape(clang.transpose(y, 1, 2), (B, T, nh * hs))
    x = clang.add(x, clang.linear(y, ap["wo"]))
    n2 = rms_norm(x, bp["norm_2"])
    gate = clang.linear(n2, mp["fc_1"])
    g = clang.maybe_convert_to_dtype(gate, f32)       # silu in float32, as F.silu
    silu = clang.maybe_convert_to_dtype(
        clang.true_divide(g, clang.add(clang.exp(clang.neg(g)), 1.0)), gate.dtype)
    out = clang.add(x, clang.linear(clang.mul(silu, clang.linear(n2, mp["fc_2"])), mp["proj"]))
    logits = clang.linear(rms_norm(out, params["ln_f"]), params["lm_head"])
    logits = clang.maybe_convert_to_dtype(clang.reshape(logits, (B * T, logits.shape[-1])), f32)
    losses, _ = prims.cross_entropy_fwd(logits, targets)
    return clang.mean(losses), out


def eager_layer_loss(x, cos, sin, params, targets, cfg):
    """``ir_layer_loss`` on the port's eager path: ``block_forward``, the
    final norm, the head and ``ltorch.cross_entropy`` over float32 logits."""
    out = block_forward(params["block"], x, cos, sin, cfg)
    logits = F.linear(_norm(out, params["ln_f"], cfg), params["lm_head"])
    return ltorch.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), targets), out


def ir_sdpa_backward(prims, g, q, k, v, out, lse):
    """The causal SDPA backward prim alone, for the backward claim."""
    return prims.sdpa_backward(g, q, k, v, out, lse, None, True, 1.0 / math.sqrt(q.shape[-1]),
                               None)


def ir_bad_inputs(x):
    """Inputs the prologue must reject in place of ``x``, by label."""
    return [("a CPU tensor", x.cpu()), ("a wrong dtype", x.float()),
            ("a wrong shape", x[:, : x.shape[1] // 2])]


def ir_program(fn, args, executors=UNFUSED):
    """Acquires ``fn`` over ``args`` (``language=`` clang), claims it with
    ``executors`` (default: cuda ≻ torch, the unfused stack) and compiles both
    programs.  Returns ``(call, final
    trace, host ms of acquisition, claiming and codegen)``; ``call(*args)``
    runs the prologue, then the computation."""
    t0 = time.perf_counter()
    traces = trace_from_fn(fn, args, {}, language=Languages.CLANG)
    t1 = time.perf_counter()
    final = transform_for_execution(traces.computation_trace, resolve_executors(executors))
    t2 = time.perf_counter()
    prologue, computation = traces.prologue_trace.python_callable(), final.python_callable()
    t3 = time.perf_counter()

    def call(*a):
        return computation(*prologue(*a))

    call.prologue = prologue
    return call, final, dict(acquire_ms=1e3 * (t1 - t0), claim_ms=1e3 * (t2 - t1),
                             codegen_ms=1e3 * (t3 - t2))


def region_problems(traces) -> list[str]:
    """What a program's fusion regions may not hold (``cuda_*`` symbols, a
    random prim, a kernel's prim, a ``quantex`` product, anything but
    ``torch_*`` calls in its program), over every trace given."""
    return [v for tr in traces for v in inductorex.region_violations(tr)]


def check_claims(final, label: str, cuda_ops: set) -> list[str]:
    """Every executed bound symbol of ``final`` is a cuda operator named in
    ``cuda_ops``, a ``torch_`` one or a fusion region that holds only
    torch-implementable, non-random prims, and each of ``cuda_ops`` is
    there."""
    names = [b.sym.name for b in final.bound_symbols
             if b.sym.id not in (ir_prims.PrimIDs.RETURN, ir_prims.PrimIDs.DEL)]
    fusions = {b.sym.name for b in final.bound_symbols if b.sym.is_fusion}
    stray = [n for n in names if n not in cuda_ops and not n.startswith("torch_")
             and n not in fusions]
    missing = cuda_ops - set(names)
    problems = region_problems([final])
    say(f"IR {label}: the final trace runs {len(names)} bound symbols, "
        f"{sorted(set(n for n in names if not n.startswith('torch_') and n not in fusions))} on "
        f"the cuda executor, {len(fusions)} fusion regions, the rest torch_*")
    if stray or missing or problems:
        raise AssertionError(f"IR {label}: unclaimed {stray}, cuda claims missing {missing}, "
                             f"regions holding {problems}\n{final.python()}")
    return names


def ir_counted(call, args, want: dict) -> tuple:
    """One call of an IR program with the launch counts read around it."""
    cudaex.reset_launches()
    res = call(*args)
    torch.cuda.synchronize()
    got = dict(cudaex.LAUNCHES)
    if got != no_launches_but(**want):
        raise AssertionError(f"IR program launched {got}, expected {want} per call")
    return res, got


def ir_layer(cfg):
    """Phase 11: ``ir_layer_loss`` at Llama-3-8B widths (one layer, B=1,
    T=2048, weights from seed 0) acquired by ``functional.trace_from_fn``,
    claimed by cuda ≻ torch (the unfused stack) and run as the
    generated prologue and computation on the card, float32 and bf16,
    against the eager layer; then the SDPA backward prim alone at the same
    shape.  The bf16 layer and the backward also run claimed by the torch
    executor alone, whose SDPA fast paths must launch the same kernels.
    Every decline, on the eager or the IR path, fails the phase.  Returns
    the phase's launch counts, summed."""
    cfg1 = Config.from_name(cfg.name, n_layer=1)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    full = init_params(cfg1, generator=gen, dtype=torch.bfloat16, device=DEVICE)
    p16 = {"block": full["blocks"][0], "ln_f": full["ln_f"], "lm_head": full["lm_head"]}
    del full
    x16 = torch.randn((1, IR_T, cfg.n_embd), generator=gen, device=DEVICE).to(torch.bfloat16)
    targets = torch.randint(0, cfg.vocab_size, (IR_T,), generator=gen, device=DEVICE,
                            dtype=torch.int32)
    cos, sin = build_rope_cache(cfg, IR_T, device=DEVICE)
    fn = functools.partial(ir_layer_loss, ir_clang, ir_prims)
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    total = dict.fromkeys(cudaex.LAUNCHES, 0)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        p = _cast(p16, dt) if dt == torch.float32 else p16
        args = (x16.to(dt), cos, sin, p, targets)
        call, final, host = ir_program(fn, args)
        check_claims(final, f"layer {dt}", {"cuda_sdpa"})
        if dt == torch.bfloat16:
            say("IR layer bf16, the final trace:\n" + final.python())
        (loss, out), got = ir_counted(call, args, dict(flash_fwd=1, flash_ce=1))
        (loss2, out2), _ = ir_counted(call, args, dict(flash_fwd=1, flash_ce=1))
        for k2 in total:
            total[k2] += 2 * got[k2]
        if not (torch.equal(loss, loss2) and torch.equal(out, out2)):
            raise AssertionError(f"IR layer {dt}: two calls differ")
        e_loss, e_out = eager_layer_loss(*args, cfg1)
        torch.cuda.synchronize()
        ms = time_ms(lambda: call(*args), iters=5, warmup=1)
        eager_ms = time_ms(lambda: eager_layer_loss(*args, cfg1), iters=5, warmup=1)
        dev, nk = device_ms_all(lambda: call(*args), iters=3)
        edev, enk = device_ms_all(lambda: eager_layer_loss(*args, cfg1), iters=3)
        res[dt] = dict(loss=loss, out=out, e_loss=e_loss, e_out=e_out)
        say(f"IR layer {dt} ({cfg.name} widths, 1 layer, B=1, T={IR_T}): acquisition "
            f"{host['acquire_ms']:.1f} ms, claiming {host['claim_ms']:.1f} ms, codegen "
            f"{host['codegen_ms']:.1f} ms (host); per call: generated program {ms:.3f} ms, "
            f"eager layer {eager_ms:.3f} ms (CUDA events); device {dev} ms over {nk} kernels, "
            f"eager {edev} ms over {enk} kernels; loss {loss.item():.6f}, eager "
            f"{e_loss.item():.6f}; launches per call {got}")
        if dt == torch.bfloat16:
            for label, bad in ir_bad_inputs(x16):
                try:
                    call.prologue(bad, cos, sin, p, targets)
                except RuntimeError as e:
                    if IR_REJECTS[label] not in str(e):
                        raise
                    say(f"IR prologue rejects {label}: {e}")
                else:
                    raise AssertionError(f"IR prologue accepted {label}")
            # the torch executor alone: its SDPA fast path launches the same
            # kernel the cuda executor's claim does
            tcall, tfinal, _ = ir_program(fn, args, executors=[torchex.torch_ex])
            check_claims(tfinal, "layer bf16, the torch executor alone", set())
            (tloss, tout), tgot = ir_counted(tcall, args, dict(flash_fwd=1, flash_ce=1))
            for k2 in total:
                total[k2] += tgot[k2]
            if not (torch.equal(tloss, loss) and torch.equal(tout, out)):
                raise AssertionError("IR layer bf16: the torch executor alone differs from "
                                     "cuda ≻ torch")
            say(f"IR layer bf16, the torch executor alone: launches {tgot}, bitwise equal to "
                f"cuda ≻ torch")
            del tcall, tfinal, tloss, tout
        del call, final
    r32, r16 = res[torch.float32], res[torch.bfloat16]
    loss_rel = abs(r32["loss"].item() - r32["e_loss"].item()) / abs(r32["e_loss"].item())
    out_rel = ((r32["out"] - r32["e_out"]).abs().max().item()
               / r32["e_out"].abs().max().item())
    ok = loss_rel <= IR_LOSS_REL and out_rel <= IR_OUT_REL
    say(f"IR layer float32 against the eager layer: loss rel {loss_rel:.2e} (bar "
        f"{IR_LOSS_REL:.0e}), block output {out_rel:.2e} of its max (bar {IR_OUT_REL:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the IR layer disagrees with the eager layer in float32")
    ref_loss, ref_out = r32["e_loss"].item(), r32["e_out"]
    lk = abs(r16["loss"].item() - ref_loss)
    le = abs(r16["e_loss"].item() - ref_loss)
    ok_ = (r16["out"].float() - ref_out).abs().max().item()
    oe = (r16["e_out"].float() - ref_out).abs().max().item()
    ok = lk <= LOWP_ERR_RATIO * le and ok_ <= LOWP_ERR_RATIO * oe
    say(f"IR layer bf16 against the float32 eager layer: loss error traced {lk:.3e} eager "
        f"{le:.3e} (ratio limit {LOWP_ERR_RATIO}); block output max error traced "
        f"{ok_:.3e} eager {oe:.3e} (ratio limit {LOWP_ERR_RATIO}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the bf16 IR layer strays further from float32 than the eager layer")
    del res, r32, r16
    # the backward claim: the SDPA backward prim alone at the training shape
    H, G, hs = cfg.n_head, cfg.n_query_groups, cfg.head_size
    q = torch.randn((1, H, IR_T, hs), generator=gen, device=DEVICE).to(torch.bfloat16)
    k = torch.randn((1, G, IR_T, hs), generator=gen, device=DEVICE).to(torch.bfloat16)
    v = torch.randn((1, G, IR_T, hs), generator=gen, device=DEVICE).to(torch.bfloat16)
    g = torch.randn((1, H, IR_T, hs), generator=gen, device=DEVICE).to(torch.bfloat16)
    out, lse = cudaex.flash_sdpa(q, k, v, causal=True, scale=1.0 / math.sqrt(hs))
    args = (g, q, k, v, out, lse)
    call, final, host = ir_program(functools.partial(ir_sdpa_backward, ir_prims), args)
    check_claims(final, "sdpa backward", {"cuda_sdpa_backward"})
    grads, got = ir_counted(call, args, dict(flash_bwd_dq=1, flash_bwd_dkv=1))
    grads2, _ = ir_counted(call, args, dict(flash_bwd_dq=1, flash_bwd_dkv=1))
    for k2 in total:
        total[k2] += 2 * got[k2]
    direct = cudaex.flash_sdpa_backward(g, q, k, v, out, lse, causal=True,
                                        scale=1.0 / math.sqrt(hs))
    if not all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(grads, grads2, direct)):
        raise AssertionError("IR sdpa backward: not bitwise equal to the direct kernel call, "
                             "or two calls differ")
    tcall, tfinal, _ = ir_program(functools.partial(ir_sdpa_backward, ir_prims), args,
                                  executors=[torchex.torch_ex])
    check_claims(tfinal, "sdpa backward, the torch executor alone", set())
    tgrads, tgot = ir_counted(tcall, args, dict(flash_bwd_dq=1, flash_bwd_dkv=1))
    for k2 in total:
        total[k2] += tgot[k2]
    if not all(torch.equal(a, b) for a, b in zip(tgrads, direct)):
        raise AssertionError("IR sdpa backward: the torch executor alone differs from the "
                             "direct kernel call")
    say(f"IR sdpa backward, the torch executor alone: launches {tgot}, bitwise equal to "
        f"cudaex.flash_sdpa_backward")
    del tcall, tfinal, tgrads
    ms = time_ms(lambda: call(*args), iters=10)
    dev, nk = device_ms_all(lambda: call(*args), iters=5)
    say(f"IR sdpa backward bf16 (B=1, {H}/{G} heads, T={IR_T}, hs {hs}): acquisition "
        f"{host['acquire_ms']:.1f} ms, claiming {host['claim_ms']:.1f} ms, codegen "
        f"{host['codegen_ms']:.1f} ms (host); {ms:.3f} ms per call (CUDA events), device {dev} "
        f"ms over {nk} kernels; bitwise equal to cudaex.flash_sdpa_backward; launches {got}")
    if any(ltorch.DECLINES.values()):
        raise AssertionError(f"declines during the IR phase: {ltorch.DECLINES}")
    return total


#
# phase 12: thunder_tpu_torch.jit(gpt_loss) of Llama-3-8B
#

JIT_T = 2048                # B=1, the training step's sequence
JIT_T_SHORT = 1024          # a second specialization of the same function
JIT_LOSS_REL_F32 = 1e-5     # float32: the jitted loss against eager gpt_loss
JIT_DISPATCH_CALLS = 20     # cache-hit calls whose dispatch times give the median
# host phases of a compile, by the spans the pipeline records: acquisition,
# the passes before claiming, claiming, and codegen (prologue and computation)
JIT_SPANS = {"acquisition": ("interpret",),
             "dce_cse": ("transform:dce", "transform:cse",
                         "transform:absorb_ce_widening_converts"),
             "claiming": ("lower", "lower:del_last_used"), "codegen": ("codegen",)}


def span_ms() -> dict:
    """Host ms of the recorded compile spans, summed by ``JIT_SPANS`` group."""
    open_at, total = {}, dict.fromkeys(JIT_SPANS, 0.0)
    for ev in events():
        if ev["ph"] == "B":
            open_at.setdefault(ev["name"], []).append(ev["ts"])
        elif ev["ph"] == "E" and open_at.get(ev["name"]):
            dur = (ev["ts"] - open_at[ev["name"]].pop()) / 1e3
            for group, names in JIT_SPANS.items():
                if ev["name"] in names:
                    total[group] += dur
    return total


def jit_batch(cfg, T, gen):
    idx = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=DEVICE)
    tgt = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=DEVICE)
    cos, sin = build_rope_cache(cfg, T, device=DEVICE)
    return idx, tgt, cos, sin


def jit_bad_inputs(idx):
    """Token ids the prologue must reject, by label."""
    return [("a CPU tensor", idx.cpu()), ("a wrong dtype", idx.int()),
            ("a wrong shape", idx[:, : idx.shape[1] // 2])]


def jit_counted(jfn, args, cfg) -> tuple:
    """One call of the jitted loss with the launch counts read around it:
    n_layer ``flash_fwd`` and one ``flash_ce``, nothing else."""
    cudaex.reset_launches()
    loss = jfn(*args)
    torch.cuda.synchronize()
    got = dict(cudaex.LAUNCHES)
    want = dict(flash_fwd=cfg.n_layer, flash_ce=1)
    if got != no_launches_but(**want):
        raise AssertionError(f"jit gpt_loss launched {got}, expected {want} per call")
    return loss, got


def eager_loss(params, batch, cfg):
    with torch.no_grad():
        return gpt_loss(params, *batch, cfg)


def jit_gpt_loss(cfg):
    """Phase 12: ``thunder_tpu_torch.jit(gpt_loss)`` of Llama-3-8B at full
    width and depth (weights from seed 0, B=1, T=2048, default executors
    cuda ≻ torch), bf16 and float32, against the eager ``gpt_loss`` of the
    same weights under ``torch.no_grad()``; the dispatch cache (hit, miss at
    T=1024, hit again, the prologue's rejections, no device sync in the key
    and the prologue).  Returns the phase's launch counts, summed."""
    params, _ = make_params(cfg.name)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    batch = jit_batch(cfg, JIT_T, gen)
    short = jit_batch(cfg, JIT_T_SHORT, gen)
    loss_fn = lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg)     # noqa: E731
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    total = dict.fromkeys(cudaex.LAUNCHES, 0)

    def add(got):
        for k in total:
            total[k] += got[k]

    # bf16: compile, claims, launches, a cache hit bitwise equal
    jfn = ttt.jit(loss_fn)
    args = (params, *batch)
    clear_events()
    before = dict(inductorex.STATS)
    loss, got = jit_counted(jfn, args, cfg)
    compiled = (inductorex.STATS["compiles"] - before["compiles"],
                inductorex.STATS["compile_s"] - before["compile_s"])
    add(got)
    host = span_ms()
    final = ttt.last_traces(jfn)[-1]
    names = check_claims(final, "jit gpt_loss bf16", {"cuda_sdpa"})
    if names.count("cuda_sdpa") != cfg.n_layer:
        raise AssertionError(f"jit gpt_loss: {names.count('cuda_sdpa')} cuda_sdpa, "
                             f"expected {cfg.n_layer}")
    ce_dtype = [b.args[0].dtype for b in final.bound_symbols
                if b.sym.name == "torch_cross_entropy_fwd"]
    prologue = ttt.last_prologue_traces(jfn)[-1].python()
    guards = prologue.count("check_tensor_metadata(")
    n_leaves = len(tree_leaves(params)) + len(batch)
    if guards != n_leaves:
        raise AssertionError(f"jit gpt_loss: the prologue guards {guards} tensors, expected "
                             f"{n_leaves} (every parameter an input)")
    loss2, got = jit_counted(jfn, args, cfg)
    add(got)
    stats = ttt.dispatch_stats(jfn)
    if (ttt.cache_hits(jfn), ttt.cache_misses(jfn), stats["prologue_runs"]) != (1, 1, 2):
        raise AssertionError(f"jit gpt_loss: hits {ttt.cache_hits(jfn)}, misses "
                             f"{ttt.cache_misses(jfn)}, {stats}; expected one hit, one miss and "
                             f"one prologue run per call")
    if not torch.equal(loss, loss2):
        raise AssertionError("jit gpt_loss: the cache hit differs from the first call")
    # a cache hit's key and prologue read metadata only: no device sync
    entry = ttt.compile_stats(jfn).interpreter_cache[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        key = jit_cache_key.compute_cache_key(args, {})
        entry.prologue_fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if key != entry.cache_key:
        raise AssertionError("jit gpt_loss: the recomputed key differs from the entry's")
    for label, bad in jit_bad_inputs(batch[0]):
        try:
            entry.prologue_fn(params, bad, *batch[1:])
        except RuntimeError as e:
            if IR_REJECTS[label] not in str(e):
                raise
            say(f"jit prologue rejects {label}: {e}")
        else:
            raise AssertionError(f"jit prologue accepted {label}")
    # cache-hit dispatch time (key, lookup, prologue), then device time
    cs = ttt.compile_stats(jfn)
    dispatch_ns = []
    for _ in range(JIT_DISPATCH_CALLS):
        jfn(*args)
        dispatch_ns.append(cs.last_dispatch_ns)
    torch.cuda.synchronize()
    # phase 16 (a): the same loss on the unfused executors, its host times
    # read before any profile, as the fused ones are; its launches (held per
    # call by jit_counted) stay out of the main path's counts
    ujfn = ttt.jit(loss_fn, executors=UNFUSED)
    uloss, ugot = jit_counted(ujfn, args, cfg)
    ucs = ttt.compile_stats(ujfn)
    udispatch_ns = []
    for _ in range(JIT_DISPATCH_CALLS):
        ujfn(*args)
        udispatch_ns.append(ucs.last_dispatch_ns)
    torch.cuda.synchronize()
    ms = time_ms(lambda: jfn(*args), iters=5, warmup=1)
    ums = time_ms(lambda: ujfn(*args), iters=5, warmup=1)
    eager_ms = time_ms(lambda: eager_loss(params, batch, cfg), iters=5, warmup=1)
    dev, nk = device_ms_all(lambda: jfn(*args), iters=3)
    udev, unk = device_ms_all(lambda: ujfn(*args), iters=3)
    edev, enk = device_ms_all(lambda: eager_loss(params, batch, cfg), iters=3)
    regions = [b for b in final.bound_symbols if b.sym.is_fusion]
    structures = len({b._call_ctx[b.sym.name].key for b in regions})
    okf = dev is not None and udev is not None and dev <= udev
    say(f"phase 16 (a) jit gpt_loss bf16, fused against unfused ({cfg.name}, {cfg.n_layer} "
        f"layers, B=1, T={JIT_T}; {CARD}): device {dev} ms over {nk} kernels a call against "
        f"{udev} ms over {unk} {'ok' if okf else 'FAIL'} (fused device ms at most the unfused); "
        f"CUDA events {ms:.3f} against {ums:.3f} ms; {len(regions)} regions of {structures} "
        f"structures, {compiled[0]} compiled in {compiled[1]:.1f} s; cache-hit dispatch median "
        f"{statistics.median(dispatch_ns) / 1e6:.3f} ms against "
        f"{statistics.median(udispatch_ns) / 1e6:.3f} ms (no bar); loss {loss.item():.6f} "
        f"against {uloss.item():.6f}")
    if not okf:
        raise AssertionError("phase 16 (a): the fused jit(gpt_loss) takes more device time "
                             "than the unfused")
    fusion = dict(device_ms=dev, kernels=nk, unfused_device_ms=udev, unfused_kernels=unk,
                  ms=ms, unfused_ms=ums, regions=len(regions), structures=structures,
                  compiles=compiled[0], compile_s=compiled[1],
                  dispatch_ms_median=statistics.median(dispatch_ns) / 1e6,
                  unfused_dispatch_ms_median=statistics.median(udispatch_ns) / 1e6,
                  loss=loss.item(), unfused_loss=uloss.item(),
                  unfused_launches={k: n for k, n in ugot.items() if n})
    del ujfn, ucs
    # T=1024 is a new key: a second entry; T=2048 then hits again
    sloss, got = jit_counted(jfn, (params, *short), cfg)
    add(got)
    misses = ttt.cache_misses(jfn)
    hits = ttt.cache_hits(jfn)
    _, got = jit_counted(jfn, args, cfg)
    add(got)
    if (misses, ttt.cache_misses(jfn), ttt.cache_hits(jfn) - hits,
            ttt.dispatch_stats(jfn)["cached_specializations"]) != (2, 2, 1, 2):
        raise AssertionError(f"jit gpt_loss: T={JIT_T_SHORT} then T={JIT_T}: misses {misses} "
                             f"-> {ttt.cache_misses(jfn)}, {ttt.dispatch_stats(jfn)}")
    e16 = eager_loss(params, batch, cfg)
    say(f"jit gpt_loss bf16 ({cfg.name}, {cfg.n_layer} layers, B=1, T={JIT_T}; {CARD}): "
        f"acquisition {host['acquisition']:.1f} ms, dce/cse {host['dce_cse']:.1f} ms, claiming "
        f"{host['claiming']:.1f} ms, codegen {host['codegen']:.1f} ms (host); "
        f"{len(final.bound_symbols)} bound symbols, {guards} guards; cache-hit dispatch "
        f"median {statistics.median(dispatch_ns) / 1e6:.3f} ms (min "
        f"{min(dispatch_ns) / 1e6:.3f}, max {max(dispatch_ns) / 1e6:.3f}, "
        f"{JIT_DISPATCH_CALLS} calls); per call: jitted {ms:.3f} ms, eager (no_grad) "
        f"{eager_ms:.3f} ms (CUDA events); device {dev} ms over {nk} kernels, eager {edev} ms "
        f"over {enk} kernels; CE takes {ce_dtype} logits; loss {loss.item():.6f}, eager "
        f"{e16.item():.6f}, T={JIT_T_SHORT} {sloss.item():.6f}; launches per call {got}")
    PHASE12.update(loss=loss.item(), dispatch_ms_median=statistics.median(dispatch_ns) / 1e6)
    rec = dict(acquire_ms=host["acquisition"], passes_ms=host["dce_cse"],
               claim_ms=host["claiming"], codegen_ms=host["codegen"], guards=guards,
               dispatch_ms_median=statistics.median(dispatch_ns) / 1e6, ms=ms,
               eager_ms=eager_ms, device_ms=dev, kernels=nk, eager_device_ms=edev,
               eager_kernels=enk, fusion=fusion, card=CARD)
    del jfn, entry, cs, final
    # float32: the same weights, the same depth
    l16 = loss.item()
    params32 = _cast(params, torch.float32)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    jfn32 = ttt.jit(loss_fn)
    args32 = (params32, *batch)
    loss32, got = jit_counted(jfn32, args32, cfg)
    add(got)
    check_claims(ttt.last_traces(jfn32)[-1], "jit gpt_loss float32", {"cuda_sdpa"})
    e32 = eager_loss(params32, batch, cfg).item()
    rel = abs(loss32.item() - e32) / abs(e32)
    ok32 = rel <= JIT_LOSS_REL_F32
    lk, le = abs(l16 - e32), abs(e16.item() - e32)
    ok16 = lk <= LOWP_ERR_RATIO * le
    say(f"jit gpt_loss float32 against eager: loss {loss32.item():.8f} eager {e32:.8f}, rel "
        f"{rel:.2e} (bar {JIT_LOSS_REL_F32:.0e}) {'ok' if ok32 else 'FAIL'}; bf16 against the "
        f"float32 eager loss: jitted error {lk:.3e}, eager bf16 error {le:.3e} (ratio limit "
        f"{LOWP_ERR_RATIO}) {'ok' if ok16 else 'FAIL'}; jitted bf16 loss bitwise equal to "
        f"eager bf16: {l16 == e16.item()} ({CARD})")
    if not ok32:
        raise AssertionError("jit gpt_loss disagrees with eager gpt_loss in float32")
    if not ok16:
        raise AssertionError("the jitted bf16 loss strays further from float32 than eager's")
    if any(ltorch.DECLINES.values()):
        raise AssertionError(f"declines during the jit phase: {ltorch.DECLINES}")
    rec.update(loss_bf16=l16, eager_bf16=e16.item(), loss_f32=loss32.item(), eager_f32=e32,
               f32_rel=rel, bf16_err=lk, eager_bf16_err=le)
    say("jit gpt_loss: " + json.dumps(rec))
    del params32, jfn32
    gc.collect()
    torch.cuda.empty_cache()
    return total


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    CARD = card_line()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    if not cudaex.paged_available():
        raise RuntimeError("the paged kernels cannot be built here: no nvcc found")
    _build.load_library()
    info = _build.build_info
    say(f"built {len(info['sources'])} sources in parallel in {info['seconds']:.1f} s "
        f"(cached: {info['cached']})")
    for name, src in info["sources"].items():
        say(f"{name} -> {src['path']}")
        for line in src["log"].splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                say(f"ptxas: {line.strip()}")
    lora_events = lora_event_rounds()       # before any profile (phase 3 reads them all)
    pair_events = pair_event_rounds()
    q_pair_events = q_pair_event_rounds()

    recs = {"paged_attn_decode": check_decode(), "paged_token_write": check_write(),
            "paged_attn_verify": check_verify(), "paged_chunk_write": check_chunk_write(),
            "paged_token_write_masked": check_masked_write(), **check_flash()}
    # the write kernels' entries are the engine's pair writes (K and V of a
    # decode step; of a K=4 round, masked; of a bf16 chunk piece), the
    # single-arena calls beside
    pair = check_pair_writes(pair_events)
    for name, kind in (("paged_token_write", "step"), ("paged_token_write_masked", "round")):
        recs[name] = {**pair[kind], "single": recs[name]}
    recs["paged_chunk_write"] = {**check_chunk_pair(), "single": recs["paged_chunk_write"]}
    # quantized arenas: the dequantizing attention bodies (extra rows of
    # their kernels' entries) and the two fused writes
    check_head_sizes()
    recs["paged_attn_decode"]["quantized"] = check_decode_quant()
    recs["paged_attn_verify"]["quantized"] = check_verify_quant()
    # the fused token write's entry is the int8 decode step's pair, which the
    # chunked int8 serve's decode steps run; fp8, the round and the
    # single-arena calls ride beside it
    qp = check_q_pair_writes(q_pair_events)
    recs["paged_token_write_fused"] = {**qp["int8"]["step"], "quantized": qp,
                                       "single": check_token_write_fused()}
    cw = check_chunk_write_fused()
    recs["paged_chunk_write_fused"] = {**cw["int8"], "quantized": cw}
    recs["flash_ce"] = check_ce()
    recs["lora_delta_fused"] = check_lora(lora_events)
    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    params, cfg = make_params()
    served = {}
    served["decode serve"], decode_profile = serve_full_width(params, cfg)
    kv_write = {"decode step": check_kv_write_group(decode_profile, "decode step")}
    crec, eng, prompts, tables, _ = chunked_serve(params, cfg, profile=True)
    served["chunked serve"] = crec["launches"]
    kv_write["chunk piece"] = check_kv_write_group(crec["chunk_piece_profile"], "chunk piece")
    say(f"chunk piece: the eager rest {crec['chunk_piece_profile']['groups_ms'].get('other')} ms "
        f"(6.762 / 6.862 ms on NVIDIA H100 80GB HBM3, 700.00 W while the engine staged each "
        f"arena's values in a 32 MiB copy)")
    chunk_case = (_compact(eng.pool.arenas, [tables[0]]), prompts[0])
    bf16_pool_bytes = eng.pool.arena_bytes()
    del eng
    torch.cuda.empty_cache()
    srec, eng, prompts, results, tables = spec_serve(params, cfg, profile=True)
    served["speculative serve"] = srec["launches"]
    kv_write["verify round"] = check_kv_write_group(srec["verify_round_profile"], "verify round")
    spec_case = (_compact(eng.pool.arenas, tables), prompts, results)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # quantized serves: chunked int8 on a pool of the bf16 chunked pool's
    # bytes, speculative fp8 with the draft inheriting fp8
    nb_int8 = blocks_for_arena_bytes(cfg, 16, bf16_pool_bytes, torch.bfloat16, kv_dtype="int8")
    say(f"equal-bytes int8 pool: {bf16_pool_bytes} B buys {nb_int8} int8 blocks of "
        f"{arena_block_bytes(cfg, 16, torch.bfloat16, 'int8')} B against 2048 bf16 blocks of "
        f"{arena_block_bytes(cfg, 16, torch.bfloat16)} B")
    qrec, eng, prompts, tables, results = chunked_serve(params, cfg, kv_dtype="int8",
                                                        num_blocks=nb_int8)
    served["chunked int8 serve"] = qrec["launches"]
    qrec["decode_logits"] = compare_logits(eng, params, cfg, prompts, results, tables)
    # profiled after the logits, whose rows' blocks the served run wrote
    qrec["chunk_piece_profile"] = profile_chunk_piece(eng, cfg, "chunked int8 serve")
    kv_write["int8 chunk piece"] = check_kv_write_group(qrec["chunk_piece_profile"],
                                                        "int8 chunk piece")
    qrec["decode_step_profile"] = profile_decode_steps(
        eng, [p[:CHUNK - 12] for p in prompts], "chunked int8 serve, decode step (8 rows)")
    kv_write["int8 decode step"] = check_kv_write_group(qrec["decode_step_profile"],
                                                        "int8 decode step")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    frec, eng, *_ = spec_serve(params, cfg, kv_dtype="fp8", self_draft=False, profile=True)
    served["speculative fp8 serve"] = frec["launches"]
    kv_write["fp8 verify round"] = check_kv_write_group(frec["verify_round_profile"],
                                                        "fp8 verify round")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # multi-tenant LoRA: the chunked and speculative serves again, two
    # requests per adapter and two base ones
    reg = make_registry(cfg)
    lrec, eng, prompts, tables, results = chunked_serve(params, cfg, lora=reg)
    served["chunked LoRA serve"] = lrec["launches"]
    lrec["decode_logits"] = compare_logits(
        eng, params, cfg, prompts, results, tables,
        slots=[reg.slot(a) if a is not None else 0 for a in LORA_IDS])
    # profiled after the logits, whose rows' blocks the served run wrote
    lrec["decode_step_profile"] = profile_decode_steps(
        eng, [p[:CHUNK - 12] for p in prompts], "chunked LoRA serve, decode step (8 rows)",
        ids=LORA_IDS)
    lrec["chunk_piece_profile"] = profile_chunk_piece(eng, cfg, "chunked LoRA serve",
                                                      adapter_id=LORA_ADAPTERS[0])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    slrec, eng, *_ = spec_serve(params, cfg, lora=reg, self_draft=False, profile=True)
    served["speculative LoRA serve"] = slrec["launches"]
    del eng, reg
    gc.collect()
    torch.cuda.empty_cache()
    lora_profiles = profile_lora_serves(lrec, slrec, crec)
    keys = ("tokens_per_s", "ttft_p50_ms", "tpot_p50_ms")
    say("LoRA serves beside the same run's serves without LoRA: " + json.dumps({
        "chunked": {"lora": {k: lrec[k] for k in keys}, "base": {k: crec[k] for k in keys}},
        "speculative": {"lora": {k: slrec[k] for k in keys},
                        "base": {k: srec[k] for k in keys}}}))
    cfg4 = Config.from_name(cfg.name, n_layer=4)
    params32_4 = _cast({**params, "blocks": params["blocks"][:4]}, torch.float32)
    _exact_tokens(params32_4, cfg4)
    _exact_tokens_quant(params32_4, cfg4)
    _exact_tokens_lora(params32_4, cfg4)
    _exact_tokens_lora_cases(params32_4, cfg4)
    _exact_tokens_tiny()
    del params32_4
    torch.cuda.empty_cache()
    chunk_and_verify_logits(params, cfg, chunk_case, spec_case)
    del chunk_case, spec_case
    gc.collect()                 # the serving engines' arenas, held in reference cycles
    torch.cuda.empty_cache()
    stateful_rec, stateful_launches = stateful_phase(params, cfg)
    served.update(stateful_launches)
    gc.collect()
    torch.cuda.empty_cache()
    compiled_in("phase 9", train_correctness, params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    # the serving params become the trained ones: updated in place from here
    served["train step"] = compiled_in("phase 10", train_full_width, params, cfg)["launches"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    served["IR layer"] = ir_layer(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    served["jit gpt_loss"] = compiled_in("phase 12", jit_gpt_loss, cfg)
    served["jit grad and autocast"] = compiled_in("phase 13", jit_grad_and_autocast, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    donation = fusion_donation()
    mix = compiled_in("phase 14", mixtral)
    served["mixtral train"] = mix.pop("train_launches")
    served["mixtral serve"] = mix.pop("serve_launches")
    served["mixtral float32 lanes"] = mix.pop("exact_launches")
    gc.collect()
    torch.cuda.empty_cache()
    graphs_rec, served["graphs phase"] = graphs_phase()
    gc.collect()
    torch.cuda.empty_cache()
    frontend_rec, frontend_launches = frontend_phase()
    served.update(frontend_launches)
    gc.collect()
    torch.cuda.empty_cache()
    bytecode_rec, bytecode_launches = bytecode_phase()
    served.update(bytecode_launches)
    gc.collect()
    torch.cuda.empty_cache()
    dist_rec, dist_launches = dist_phase(cfg)
    served.update(dist_launches)

    sources = {"paged_attn_decode": "paged_attention.cu", "paged_token_write": "paged_attention.cu",
               "paged_attn_verify": "paged_verify.cu", "paged_chunk_write": "paged_verify.cu",
               "paged_token_write_masked": "paged_attention.cu",
               "flash_fwd": "flash_attention.cu", "flash_bwd_dq": "flash_attention.cu",
               "flash_bwd_dkv": "flash_attention.cu",
               "paged_token_write_fused": "paged_attention.cu",
               "paged_chunk_write_fused": "paged_verify.cu", "flash_ce": "cross_entropy.cu",
               "lora_delta_fused": "lora_delta.cu"}
    replaces = {"paged_attn_decode": 1165, "paged_token_write": 1249, "paged_attn_verify": 1376,
                "paged_chunk_write": 1535, "paged_token_write_masked": 1462, "flash_fwd": 293,
                "flash_bwd_dq": 460, "flash_bwd_dkv": 460, "paged_token_write_fused": 1672,
                "paged_chunk_write_fused": 1616, "flash_ce": 911, "lora_delta_fused": 1740}
    # the Pallas function and its pallas_call site, where they differ
    counterpart = {"flash_fwd": "_flash_fwd (pallas_call :322)",
                   "flash_bwd_dq": "_flash_bwd (dq pallas_call :495)",
                   "flash_bwd_dkv": "_flash_bwd (dk/dv pallas_call :526)",
                   "flash_ce": "_flash_ce (pallas_call :921; flash_cross_entropy :984)",
                   "lora_delta_fused": "lora_delta_fused (pallas_call :1756)"}
    kernels = []
    for name, rec in recs.items():
        by_path = {path: counts[name] for path, counts in served.items() if counts[name]}
        launches = sum(by_path.values())
        if not launches:
            raise AssertionError(f"{name} launched on no path")
        line = f"thunder_tpu/executors/pallasex.py:{replaces[name]}"
        kernels.append(dict(
            name=name, route="cuda", source=f"thunder_tpu_torch/csrc/{sources[name]}",
            replaces=line, jax_counterpart=f"{line} {counterpart.get(name, name)}", check="pass",
            launches=launches,
            launches_by_path=by_path, max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            device_ms=rec["device_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_us=1e3 * rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"], card=CARD,
            **{k: rec[k] for k in ("shapes", "quantized", "dtypes", "library", "body", "single")
               if k in rec}))
    say("quantized serves: " + json.dumps({"chunked int8": qrec, "speculative fp8": frec}))
    say("mixtral: " + json.dumps(mix))
    say("graphs phase: " + json.dumps(graphs_rec))
    say("stateful phase: " + json.dumps(stateful_rec))
    say("frontend phase: " + json.dumps(frontend_rec))
    say("bytecode phase: " + json.dumps(bytecode_rec))
    say("dist phase: " + json.dumps(dist_rec))
    say("fusion: " + json.dumps({"regions compiled": inductorex.STATS["compiles"],
                                  "compile_s": inductorex.STATS["compile_s"],
                                  "compiled calls": inductorex.STATS["calls"],
                                  "donation": donation}))
    say("LoRA serves: " + json.dumps({"chunked": lrec, "speculative": slrec}))
    say("serve profiles: " + json.dumps({
        "decode step": decode_profile, "chunk piece": crec["chunk_piece_profile"],
        "verify round": srec["verify_round_profile"],
        "int8 chunk piece": qrec["chunk_piece_profile"],
        "int8 decode step": qrec["decode_step_profile"],
        "fp8 verify round": frec["verify_round_profile"], "LoRA": lora_profiles,
        "kv_write_ms": kv_write}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


JIT_GRAD_LAYERS = 4         # value_and_grad and autocast at Llama-3-8B widths
DONATE_N = 1 << 26          # phase 16 (c): float32 elements of each donated tensor


def fusion_donation() -> dict:
    """Phase 16 (c): ``jit(lambda p, g: p - lr * g, donate=True)`` on two
    256 MiB float32 tensors on the card: the region releases both inputs'
    storage (``memory_allocated`` rises by the output's bytes less the two
    inputs'), passing them again raises ``DonationError`` naming the input,
    and the result equals the undonated program's bitwise."""
    sgd = lambda p, g: p - 0.01 * g        # noqa: E731
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    p = torch.randn(DONATE_N, generator=gen, device=DEVICE)
    g = torch.randn(DONATE_N, generator=gen, device=DEVICE)
    want = ttt.jit(sgd)(p, g)
    jf = ttt.jit(sgd, donate=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = jf(p, g)
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - before
    nbytes = DONATE_N * 4
    freed = nbytes - grew                      # the output's bytes less the growth
    try:
        jf(p, g)
    except ttt.DonationError as e:
        raised = str(e)
    else:
        raised = None
    equal = torch.equal(out, want)
    report = ttt.donation_stats(jf)["forward"]
    ok = freed == 2 * nbytes and raised is not None and equal
    say(f"phase 16 (c) jit(sgd, donate=True) on the card: {report['buffers_donated']} buffers, "
        f"{report['bytes_donated']} bytes donated; memory_allocated grew {grew} B for a "
        f"{nbytes} B output: {freed} B of the caller's released (expected {2 * nbytes}); reuse "
        f"raised: {raised!r}; result bitwise equal to the undonated program's: {equal} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 16 (c): jit donation on the card failed its checks")
    del p, g, out, want
    torch.cuda.empty_cache()
    return dict(freed_bytes=freed, donated=report)


def compiled_in(label: str, fn, *args):
    """Runs one phase and prints the fusion regions it compiled and their
    seconds (a structure met before compiles nothing)."""
    before = dict(inductorex.STATS)
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"{label}: {inductorex.STATS['compiles'] - before['compiles']} fusion regions compiled "
        f"in {inductorex.STATS['compile_s'] - before['compile_s']:.1f} s of the phase's "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def _count(trace, name: str) -> int:
    return sum(b.sym.name == name for b in trace.bound_symbols)


def jit_grad_and_autocast(cfg):
    """Phase 13: the transforms under ``jit`` at Llama-3-8B widths and
    JIT_GRAD_LAYERS layers (weights from seed 0, B=1, T=2048).
    ``value_and_grad(gpt_loss)`` of bf16 params: the forward and backward
    programs run ``cuda_*`` and ``torch_*`` symbols only, each call launches
    the flash and CE kernels their SDPA, SDPA-backward and CE symbols name,
    the second call is a cache hit bitwise equal to the first.
    ``jit(gpt_loss, autocast="bf16")`` of float32 params: its SDPA takes
    bf16 (``flash_fwd`` at bf16, one per layer, one ``flash_ce``), and its
    loss, a bf16 number, against the float32 eager loss within
    LOWP_ERR_RATIO times the eager bf16 loss's error (phase 12's bar) plus
    half a bf16 ulp of the loss.  No declines.  Returns the
    phase's launch counts, summed."""
    cfg4 = Config.from_name(cfg.name, n_layer=JIT_GRAD_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg4, generator=gen, dtype=torch.bfloat16, device=DEVICE)
    batch = jit_batch(cfg4, JIT_T, torch.Generator(device=DEVICE).manual_seed(SEED + 13))
    loss_fn = lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg4)     # noqa: E731
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    total = dict.fromkeys(cudaex.LAUNCHES, 0)
    vg = ttt.value_and_grad(loss_fn)
    args = (params, *batch)
    runs = []
    for _ in range(2):
        cudaex.reset_launches()
        loss, grads = vg(*args)
        torch.cuda.synchronize()
        runs.append((loss, grads, dict(cudaex.LAUNCHES)))
    fw, bw = ttt.last_traces(vg)[-1], ttt.last_backward_traces(vg)[-2]
    check_claims(fw, "value_and_grad forward", {"cuda_sdpa"})
    check_claims(bw, "value_and_grad backward", {"cuda_sdpa_backward"} | (
        {"cuda_sdpa"} if _count(bw, "cuda_sdpa") else set()))
    n_sdpa = _count(fw, "cuda_sdpa") + _count(bw, "cuda_sdpa")
    n_bwd = _count(bw, "cuda_sdpa_backward")
    n_ce = _count(fw, "torch_cross_entropy_fwd") + _count(bw, "torch_cross_entropy_fwd")
    want = no_launches_but(flash_fwd=n_sdpa, flash_bwd_dq=n_bwd, flash_bwd_dkv=n_bwd,
                           flash_ce=n_ce)
    (loss, grads, got), (loss2, grads2, got2) = runs
    same = torch.equal(loss, loss2) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(grads2)))
    hits = (ttt.cache_hits(vg), ttt.cache_misses(vg))
    finite = math.isfinite(loss.item()) and all(torch.isfinite(g).all().item()
                                                for g in tree_leaves(grads))
    ok = got == want and got2 == want and same and hits == (1, 1) and finite and n_bwd == \
        JIT_GRAD_LAYERS
    say(f"jit value_and_grad(gpt_loss) bf16, {JIT_GRAD_LAYERS} layers at full width, B=1, "
        f"T={JIT_T}: loss {loss.item():.6f}; SDPA symbols {n_sdpa}, SDPA backward {n_bwd}, CE "
        f"{n_ce}; launches per call {got} then {got2} (expected {want}); hits/misses {hits}; "
        f"second call bitwise equal: {same}; finite: {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("jit value_and_grad(gpt_loss) failed its checks")
    for k in total:
        total[k] += got[k] + got2[k]
    del vg, grads, grads2, runs
    params32 = _cast(params, torch.float32)
    jac = ttt.jit(loss_fn, autocast="bf16")
    cudaex.reset_launches()
    lac = jac(params32, *batch)
    torch.cuda.synchronize()
    got = dict(cudaex.LAUNCHES)
    final = ttt.last_traces(jac)[-1]
    check_claims(final, "autocast bf16", {"cuda_sdpa"})
    sdpa_dtypes = {str(b.args[0].dtype) for b in final.bound_symbols if b.sym.name == "cuda_sdpa"}
    e32 = eager_loss(params32, batch, cfg4).item()
    e16 = eager_loss(params, batch, cfg4).item()
    la, le = abs(lac.item() - e32), abs(e16 - e32)
    # the autocast loss is itself a bf16 number (the cross-entropy takes the
    # head's bf16 logits, as in the reference): half its ulp rides on the bar
    half_ulp = 0.5 * 2.0 ** (math.floor(math.log2(abs(e32))) - 7)
    want = no_launches_but(flash_fwd=JIT_GRAD_LAYERS, flash_ce=1)
    ok = (got == want and sdpa_dtypes == {"bfloat16"} and lac.dtype == torch.bfloat16
          and la <= LOWP_ERR_RATIO * le + half_ulp)
    say(f"jit gpt_loss autocast bf16 on float32 params ({JIT_GRAD_LAYERS} layers): loss "
        f"{lac.item():.6f} ({lac.dtype}), float32 eager {e32:.6f}, bf16 eager {e16:.6f}: error "
        f"{la:.3e} against eager bf16's {le:.3e} (limit {LOWP_ERR_RATIO}× + half a bf16 ulp of "
        f"the loss, {half_ulp:.3e}); SDPA dtypes {sorted(sdpa_dtypes)}; "
        f"launches {got} (expected {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("jit(gpt_loss, autocast='bf16') failed its checks")
    if any(ltorch.DECLINES.values()):
        raise AssertionError(f"declines during the transforms phase: {ltorch.DECLINES}")
    for k in total:
        total[k] += got[k]
    del params, params32, jac
    gc.collect()
    torch.cuda.empty_cache()
    return total


#
# phase 14: the Mixtral path at Mixtral-8x7B's widths
#

MIXTRAL = "Mixtral-8x7B-like"
MIX_M = (8, 512, 2048)                     # decode (B=8), a chunk piece, a training row block
MIX_KN = ((4096, 14336), (14336, 4096))    # the experts' fc_1/fc_2 and proj
# fp8 products against the plain version's exact sum (float64, rounded
# once), of the output's largest magnitude: the card's e4m3 product keeps
# fewer accumulator bits than a float32 sum (1.4e-4-1.8e-4 read in float32 at
# K = 256-4096), and the result is then rounded to the input's dtype, so a
# bf16 output may land one ulp away (at most eps of the largest magnitude;
# 3.2e-3-5.3e-3 read at every shape; NVIDIA H100 80GB HBM3, 700.00 W).  Both
# are far below e4m3's own quantization error (~5e-2); a layout or scale
# fault leaves errors of order 1
FP8_ACC_REL = 1e-3


def fp8_bar(dtype) -> float:
    return max(FP8_ACC_REL, torch.finfo(dtype).eps)
MIX_TRAIN_LAYERS, MIX_TRAIN_LAYERS_FALLBACK = 4, 2
MIX_TRAIN_STEPS, MIX_EAGER_STEPS = 3, 2
# the int8 step's loss against the bf16 step's on the same params and batch
MIX_QUANT_LOSS_REL = 1e-2
MIX_SERVE_LAYERS = 8
# the reference's bar for the quantized MoE forward (tests/test_moe_quant.py
# test_quantized_moe_inference): mean |Δ| / mean |ref| of the logits, held
# on the reference's config and shapes (mixtral-like, float32, B=2, T=32).
# At Mixtral's widths with random weights it is no bar of the port: any
# perturbation grows with depth there, bf16 weights against float32 read
# 0.028 / 0.074 / 0.171 at 1 / 2 / 4 layers and int8 against bf16 0.090 /
# 0.178 / 0.342 / 0.609 at 1 / 2 / 4 / 8 (a 256-token prefill; routing
# decisions flip for 5.1-31.3% of tokens and layers; ``--moe-depth`` on
# NVIDIA H100 80GB HBM3, 700.00 W), so the full-width serve's figure is
# printed beside it
QUANT_LOGITS_REL = 0.1
MIX_EXACT_LAYERS = 2


def mix_params(n_layer: int, dtype=torch.bfloat16, seed=SEED + 14):
    cfg = Config.from_name(MIXTRAL, n_layer=n_layer)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(device=DEVICE).manual_seed(seed),
                         dtype=dtype, device=DEVICE)
    torch.cuda.synchronize()
    say(f"{MIXTRAL} params at {n_layer} layers: {param_count(params) / 1e9:.3f} B in "
        f"{str(dtype)[6:]}, init {time.perf_counter() - t0:.1f} s")
    return params, cfg


def mix_quantex() -> dict:
    """(a) The four quantized products at Mixtral's shapes against their
    plain versions on the card: int8 bitwise (the plain version's float64
    product is exact), fp8 within ``fp8_bar`` of the output's largest
    magnitude, two calls bitwise equal; each call's CUDA-event ms, the
    device ms of every kernel it launches, and of its library product
    alone, beside bf16 ``F.linear`` and the bound of the product."""
    from thunder_tpu_torch.executors import quantex

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 141)
    rows = []
    for K, N in MIX_KN:
        w = (torch.randn((N, K), generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        wt = w.T.contiguous()                              # (K, N): matmul's b
        qw8, _ = quantex.quantize_lastdim(w)
        qwf, _ = quantex.quantize_fp8_lastdim(w)
        for M in MIX_M:
            a = torch.randn((M, K), generator=gen, device=DEVICE).to(torch.bfloat16)
            for name, args in (("int8_linear", (a, w)), ("int8_matmul", (a, wt)),
                               ("fp8_linear", (a, w)), ("fp8_matmul", (a, wt))):
                fn = getattr(quantex, name)
                quantex.reset_calls()
                got = fn(*args)
                calls = dict(quantex.CALLS)
                again = fn(*args)
                want = getattr(quantex, f"{name}_plain")(*args)
                torch.cuda.synchronize()
                same = torch.equal(got, again)
                err = (got.float() - want.float()).abs().max().item()
                rel = err / max(want.float().abs().max().item(), 1e-30)
                exact = name.startswith("int8")
                ok = (same and tuple(got.shape) == (M, N) and sum(calls.values()) == 1
                      and (err == 0.0 if exact else rel <= fp8_bar(got.dtype)))
                ms = time_ms(lambda: fn(*args), iters=10)
                lin_ms = time_ms(lambda: F.linear(a, w), iters=10)
                row = dict(name=name, M=M, K=K, N=N, max_abs_err=err, rel_err=rel,
                           bitwise_twice=same, calls=calls, ms=ms, bf16_linear_ms=lin_ms)
                rows.append(row)
                msg = (f"quantex {name} M={M} K={K} N={N}: max_abs_err {err:.3e} against the "
                       f"plain version (rel {rel:.3e}; {'bitwise' if exact else f'bar {fp8_bar(got.dtype):.4g}'}"
                       f"), two calls bitwise equal {same}, library calls {calls}; {ms:.4f} ms "
                       f"per call, bf16 F.linear {lin_ms:.4f} ms")
                if not ok:
                    say(msg + " FAIL")
                    raise AssertionError(f"quantex {name} at M={M} K={K} N={N} failed its checks")
                if name.endswith("matmul"):       # the linears' device times cover the product
                    say(msg + " ok")
                    continue
                dev, n_kernels = device_ms_all(lambda: fn(*args), iters=5)
                if name.startswith("int8"):
                    qa = quantex.quantize_lastdim(a)[0]
                    prod = lambda: torch._int_mm(quantex._pad_rows(qa, 8, 32), qw8.T)  # noqa: E731
                else:
                    qa = quantex.quantize_fp8_lastdim(a)[0]
                    one = torch.ones((), device=DEVICE)
                    prod = lambda: torch._scaled_mm(  # noqa: E731
                        quantex._pad_rows(qa, 16, 16), qwf.T, scale_a=one, scale_b=one,
                        out_dtype=torch.float32, use_fast_accum=False)
                prod_ms, _ = device_ms_all(prod, iters=10)
                lin_dev, _ = device_ms_all(lambda: F.linear(a, w), iters=10)
                ops = 2.0 * M * K * N
                nbytes = M * K + N * K + 4 * M * N        # the product's 1-byte operands, f32 out
                rate = 1979e12                            # int8 TOP/s and fp8 TFLOP/s, dense
                bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / rate)
                row.update(device_ms=dev, kernels_per_call=n_kernels, product_device_ms=prod_ms,
                           bf16_linear_device_ms=lin_dev, product_bound_ms=bound_ms)
                say(msg + f" (device: the call {dev} ms over {n_kernels} kernels, the product "
                    f"alone {prod_ms} ms, its bound {bound_ms:.4f} ms; F.linear {lin_dev} ms) ok")
                del got, again, want
        del w, wt, qw8, qwf
    torch.cuda.empty_cache()
    return {f"{r['name']} M={r['M']} K={r['K']} N={r['N']}": r for r in rows}


def _top_kernels(prof, n=6) -> list:
    tot: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot[e.name] = tot.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return [(k[:80], round(v, 3)) for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _mix_quant_step(step, params, opt_state, batch, cfg) -> dict:
    """The bf16 step's loss (no update) and one traced ``quant="int8"`` step
    on the same params and batch: ``int8_linear`` in the forward program,
    no ``int8_`` symbol in the backward, one ``_int_mm`` per
    ``int8_linear``, the flash launches of a bf16 step, and the loss within
    MIX_QUANT_LOSS_REL of the bf16 step's.  The params are updated."""
    from thunder_tpu_torch.executors import quantex

    loss16, grads = step.grads(params, opt_state, *batch)
    loss16 = loss16.item()
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    qstep = make_train_step(lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg),
                            adamw(TRAIN_LR), remat="full_block", quant="int8")
    torch.cuda.reset_peak_memory_stats()
    quantex.reset_calls()
    cudaex.reset_launches()
    t0 = time.perf_counter()
    params, opt_state, qloss = qstep(params, opt_state, *batch)
    qloss = qloss.item()
    q_s = time.perf_counter() - t0
    q_launches, q_calls = dict(cudaex.LAUNCHES), dict(quantex.CALLS)
    syms = _symbols(step)
    want = no_launches_but(flash_fwd=syms.get("cuda_sdpa", 0),
                           flash_bwd_dq=syms.get("cuda_sdpa_backward", 0),
                           flash_bwd_dkv=syms.get("cuda_sdpa_backward", 0),
                           flash_ce=syms.get("torch_cross_entropy_fwd", 0))
    n_fw = _count(qstep.fw_trace, "int8_linear")
    n_bw = sum(b.sym.name.startswith("int8_") for b in qstep.bw_trace.bound_symbols)
    rel = abs(qloss - loss16) / abs(loss16)
    ok = (n_fw > 0 and n_bw == 0 and math.isfinite(qloss) and rel <= MIX_QUANT_LOSS_REL
          and q_launches == want and q_calls["int_mm"] == n_fw)
    say(f"mixtral traced step quant='int8' on the fresh params and the batch: loss {qloss:.6f} "
        f"against the bf16 step's {loss16:.6f} (rel {rel:.3e}, bar {MIX_QUANT_LOSS_REL}); "
        f"int8_linear symbols forward {n_fw}, int8_ symbols backward {n_bw}; library calls "
        f"{q_calls}; launches {q_launches} (expected {want}); {1e3 * q_s:.0f} ms with the "
        f"build ({qstep.build_ms:.0f} ms of host), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the quantized mixtral step failed its checks")
    return dict(params=params, opt_state=opt_state,
                rec=dict(loss=qloss, bf16_loss=loss16, rel=rel, int8_linear=n_fw,
                         launches=q_launches, ms_with_build=1e3 * q_s,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30))


def _mix_train_run(n_layer: int) -> dict:
    params, cfg = mix_params(n_layer)
    batch = train_batch(cfg, SEED + 142)
    step = make_step(cfg)
    opt_state = step.init_optimizer_state(params)
    torch.cuda.synchronize()
    say(f"{MIXTRAL} {n_layer} layers: params and AdamW state "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    quant = _mix_quant_step(step, params, opt_state, batch, cfg)
    params, opt_state = quant["params"], quant["opt_state"]
    gc.collect()
    torch.cuda.empty_cache()
    params, opt_state, losses, times, peak, launches, declines = _run_steps(
        step, params, opt_state, batch, MIX_TRAIN_STEPS)
    return dict(params=params, cfg=cfg, batch=batch, step=step, opt_state=opt_state,
                losses=losses, times=times, peak=peak, launches=launches, declines=declines,
                quant=quant["rec"])


def mix_train() -> dict:
    """(b) Mixtral-8x7B-like at full width through the traced TrainStep
    (bf16, B=1, T=2048, full_block, AdamW): MIX_TRAIN_LAYERS layers, or
    MIX_TRAIN_LAYERS_FALLBACK where those do not fit (printed).  First the
    bf16 program's build and loss and one ``quant="int8"`` step on the
    fresh params (``_mix_quant_step``: the loss of a model that has not yet
    memorized the batch); then MIX_TRAIN_STEPS bf16 steps: programs of
    ``cuda_*``/``torch_*`` symbols only, exact flash and ``flash_ce``
    launches read from them, no declines, losses finite and falling; one
    more step profiled by kernel group (the backward's per-expert pads and
    their sums are in "the rest"); then MIX_EAGER_STEPS steps of the eager
    twin on the same params."""
    try:
        run = _mix_train_run(MIX_TRAIN_LAYERS)
    except torch.cuda.OutOfMemoryError as e:
        gc.collect()
        torch.cuda.empty_cache()
        say(f"{MIXTRAL} at {MIX_TRAIN_LAYERS} layers does not fit the card ({e}); training "
            f"{MIX_TRAIN_LAYERS_FALLBACK} layers")
        run = _mix_train_run(MIX_TRAIN_LAYERS_FALLBACK)
    step, cfg, batch = run["step"], run["cfg"], run["batch"]
    params, opt_state, losses = run["params"], run["opt_state"], run["losses"]
    L = cfg.n_layer
    syms = _symbols(step)
    stray = _stray(step, syms)
    n_sdpa, n_bwd = syms.get("cuda_sdpa", 0), syms.get("cuda_sdpa_backward", 0)
    n_ce = syms.get("torch_cross_entropy_fwd", 0)
    want = no_launches_but(flash_fwd=n_sdpa * MIX_TRAIN_STEPS,
                           flash_bwd_dq=n_bwd * MIX_TRAIN_STEPS,
                           flash_bwd_dkv=n_bwd * MIX_TRAIN_STEPS,
                           flash_ce=n_ce * MIX_TRAIN_STEPS)
    step_s = float(np.mean(run["times"]))
    bw_peak = peak_live_bytes(del_last_used(step.bw_trace))
    say(f"mixtral train programs: {len(step.fw_trace.bound_symbols)} forward and "
        f"{len(step.bw_trace.bound_symbols)} backward bound symbols; cuda_sdpa {n_sdpa} "
        f"(expected {TRAIN_SDPA_PER_LAYER} x {L}), cuda_sdpa_backward {n_bwd}, "
        f"torch_cross_entropy_fwd {n_ce}, torch_topk {syms.get('torch_topk', 0)}, "
        f"torch_pad {syms.get('torch_pad', 0)}, fusion regions {_n_regions(step)}; other than "
        f"cuda_/torch_/regions, or in a region what may not be there: {stray}")
    say(f"train {MIXTRAL} bf16 through the trace, {L} layers, B={TRAIN_B} T={TRAIN_T}, remat "
        f"{step.last_remat_policy}, AdamW lr {TRAIN_LR}: losses {losses}; step times "
        f"{[round(t, 4) for t in run['times']]} s (the programs built before, "
        f"{step.build_ms:.0f} ms of host for both); step time {1e3 * step_s:.1f} ms = "
        f"{TRAIN_B * TRAIN_T / step_s:.1f} tokens/s; max_memory_allocated "
        f"{run['peak'] / 2**30:.2f} GiB; saved_bytes {step.residual_bytes_no_remat} before "
        f"remat, {step.residual_bytes} after; the backward program's live-bytes peak by trace "
        f"{bw_peak / 2**30:.2f} GiB ({CARD})")
    say(f"launches during {MIX_TRAIN_STEPS} mixtral train steps: {run['launches']} (expected "
        f"{want}); declines {run['declines']}")
    ok = (not stray and n_sdpa == TRAIN_SDPA_PER_LAYER * L and n_bwd == L and n_ce >= 1
          and run["launches"] == want and not any(run["declines"].values())
          and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0])
    if not ok:
        raise AssertionError(f"the mixtral train step failed its checks: {syms}")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, *batch)
        loss.item()
        prof_s = time.perf_counter() - t0
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    groups: dict[str, float] = {}
    for name, s, e in spans:
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + (e - s) / 1e3
    busy = sum(groups.values())
    top = _top_kernels(prof)
    say(f"mixtral train step profile: wall {1e3 * prof_s:.1f} ms (profiled), device busy "
        f"{busy:.3f} ms; device ms by group "
        f"{ {k: round(v, 3) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])} }; "
        f"top kernels {top}")
    build_ms = step.build_ms
    del step
    gc.collect()
    torch.cuda.empty_cache()
    eager = make_eager_step(cfg)
    params, opt_state, e_losses, e_times, e_peak, e_launches, e_declines = _run_steps(
        eager, params, opt_state, batch, MIX_EAGER_STEPS)
    say(f"mixtral eager twin, {MIX_EAGER_STEPS} steps on the same params: losses {e_losses}, step "
        f"times {[round(t, 4) for t in e_times]} s, max_memory_allocated "
        f"{e_peak / 2**30:.2f} GiB, launches {e_launches}, declines {e_declines}")
    if not all(math.isfinite(x) for x in e_losses) or any(e_declines.values()):
        raise AssertionError("the mixtral eager twin failed")
    rec = dict(launches=run["launches"], layers=L, losses=losses, step_ms=1e3 * step_s,
               tokens_per_s=TRAIN_B * TRAIN_T / step_s, peak_gib=run["peak"] / 2**30,
               build_ms=build_ms, bw_peak_gib=bw_peak / 2**30,
               profile=dict(busy_ms=busy, groups=groups, top=top),
               eager=dict(losses=e_losses, times=e_times, peak_gib=e_peak / 2**30),
               quant=run["quant"])
    del params, opt_state, eager, batch, run
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mix_reference_bar() -> dict:
    """The reference's ``test_quantized_moe_inference`` on the card:
    ``jit(gpt_forward)`` of mixtral-like (float32 weights from a seed, B=2,
    T=32) with the int8 executor first against the plain ``jit``: the
    forward program runs ``int8_linear`` (one ``_int_mm`` each), and mean
    |Δ| / mean |ref| of the logits stays below QUANT_LOGITS_REL."""
    from thunder_tpu_torch.executors import quantex

    cfg = Config.from_name("mixtral-like")
    params = init_params(cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED + 145),
                         dtype=torch.float32, device=DEVICE)
    idx = torch.randint(0, cfg.vocab_size, (2, 32), device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(SEED + 146))
    cos, sin = build_rope_cache(cfg, 32, device=DEVICE)
    fwd = lambda p, i, c, s: gpt_forward(p, i, c, s, cfg)        # noqa: E731
    ref = ttt.jit(fwd)(params, idx, cos, sin)
    jq = ttt.jit(fwd, executors=[quantex.ex, *ttt.extend.get_default_executors()])
    quantex.reset_calls()
    got = jq(params, idx, cos, sin)
    torch.cuda.synchronize()
    n = _count(ttt.last_traces(jq)[-1], "int8_linear")
    rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    ok = (n > 0 and quantex.CALLS["int_mm"] == n and bool(torch.isfinite(got).all())
          and rel < QUANT_LOGITS_REL)
    say(f"the reference's quantized MoE bar on the card (mixtral-like, float32, B=2, T=32, "
        f"jit with the int8 executor first): {n} int8_linear symbols, {quantex.CALLS} library "
        f"calls; mean |Δ| / mean |ref| {rel:.4e} (bar {QUANT_LOGITS_REL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the quantized mixtral-like forward misses the reference's bar")
    return dict(rel=rel, int8_linear=n)


def _quant_decode_logits(eng, params, cfg, prompts, results, tables) -> dict:
    """One decode step at the served rows' last positions over the
    quantized serve's arenas, with int8 weight matmuls (what the serve
    computed) and with the bf16 weights, on the same tokens and K/V: the
    int8 step must re-derive every served last token (the kernels and the
    library calls are deterministic), and mean |Δ| / mean |bf16| of the
    logits is printed (no bar at these widths: QUANT_LOGITS_REL's note)."""
    Bb = len(results)
    nbb = eng._nbb(max(len(t) for t in tables))
    tab = np.full((Bb, nbb), SINK_BLOCK, dtype=np.int32)
    for i, t in enumerate(tables):
        tab[i, :len(t)] = t
    pos = torch.as_tensor([len(p) + len(r.new_tokens) - 2 for p, r in zip(prompts, results)],
                          dtype=torch.int32, device=DEVICE)
    toks = torch.as_tensor([r.new_tokens[-2] for r in results], dtype=torch.int32,
                           device=DEVICE)[:, None]
    tab_d = torch.as_tensor(tab, device=DEVICE)
    cos, sin = build_rope_cache(cfg, nbb * eng.pool.block_size, device=DEVICE)
    with torch.no_grad():
        lq, _ = forward_paged(params, toks, pos, eng.pool.arenas, tab_d, cos, sin, cfg,
                              cdtype=eng.pool.dtype, quantized=True)
        lb, _ = forward_paged(params, toks, pos, eng.pool.arenas, tab_d, cos, sin, cfg,
                              cdtype=eng.pool.dtype)
    rel = ((lq - lb).abs().mean() / lb.abs().mean()).item()
    served = torch.as_tensor([r.new_tokens[-1] for r in results], device=DEVICE)
    replay = int((lq.argmax(-1)[:, 0] == served).sum())
    ok = bool(torch.isfinite(lq).all()) and replay == Bb
    say(f"quantized serve's decode logits against bf16 weights on the same tokens and K/V "
        f"({Bb} rows, {cfg.n_layer} layers): mean |Δ| / mean |bf16| {rel:.4e} (reported); the "
        f"int8 path re-derives the served last token {replay}/{Bb} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the quantized serve's decode step does not replay")
    return dict(rel=rel, replay=replay)


def mix_serve() -> dict:
    """(c) Mixtral-8x7B-like at MIX_SERVE_LAYERS layers through ``serve``
    (paged decode): 8 greedy requests of 128-1024 prompt tokens and 32 new
    tokens each, once with bf16 weights and once with ``quantized=True``
    (int8 weight matmuls per call); each serve launches exactly n_layer
    ``paged_attn_decode`` and one ``paged_token_write`` per decode step,
    the quantized one also ``_int_mm``; tokens/s, TTFT, TPOT and memory
    printed; the quantized serve's decode step replayed, its logits against
    bf16 weights printed.  Returns both serves' records, launches summed."""
    from thunder_tpu_torch.executors import quantex

    params, cfg = mix_params(MIX_SERVE_LAYERS)
    rng = np.random.default_rng(SEED + 143)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(128, 1025, 8)]
    recs = {}
    total = dict.fromkeys(cudaex.LAUNCHES, 0)
    for quantized in (False, True):
        name = "quantized (int8 weights)" if quantized else "bf16"
        eng = serve(None, params, cfg, attn="paged", block_size=16, num_blocks=1024,
                    max_batch=8, quantized=quantized, device=DEVICE)
        eng.run([prompts[0][:64]], max_new_tokens=2)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps0 = eng.decode_steps
        cudaex.reset_launches()
        quantex.reset_calls()
        t0 = time.perf_counter()
        handles = [eng.submit(p, max_new_tokens=32) for p in prompts]
        eng.step()
        tables = [list(h._req.block_table) for h in handles]
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, calls = dict(cudaex.LAUNCHES), dict(quantex.CALLS)
        steps = eng.decode_steps - steps0
        results = [h.result(drive=False) for h in handles]
        check_results(results, 32, cfg.padded_vocab_size)
        rec = serve_stats(f"serve {MIXTRAL} {name}, {cfg.n_layer} layers (prompts "
                          f"{sorted(len(p) for p in prompts)})", results, wall)
        want = no_launches_but(paged_attn_decode=steps * cfg.n_layer, paged_token_write=steps)
        say(f"launches during the {name} mixtral serve: {launches} (expected {want}, {steps} "
            f"decode steps); library calls {calls}")
        if launches != want or not steps or (calls["int_mm"] > 0) is not quantized:
            raise AssertionError(f"mixtral {name} serve launch counts {launches} != {want}")
        rec.update(launches=launches, steps=steps, calls=calls,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   tokens=[list(r.new_tokens) for r in results])
        if quantized:
            rec["logits"] = _quant_decode_logits(eng, params, cfg, prompts, results, tables)
        for k in total:
            total[k] += launches[k]
        recs[name] = rec
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(recs["bf16"]["tokens"],
                                      recs["quantized (int8 weights)"]["tokens"]))
    say(f"mixtral serves: quantized TPOT p50 {recs['quantized (int8 weights)']['tpot_p50_ms']:.2f} "
        f"ms against bf16 {recs['bf16']['tpot_p50_ms']:.2f} ms; requests with equal tokens "
        f"{same}/8 (reported)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=total, serves={k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                                        for k, v in recs.items()})


def mix_exact_tokens(n_new=8) -> dict:
    """(d) Tokens, exact, in float32 at Mixtral's widths and
    MIX_EXACT_LAYERS layers: paged = gather, ``prefill_chunk=512`` =
    unchunked, speculative with a 1-layer MoE layer-skip draft = plain,
    and ``quantized=True`` paged = ``quantized=True`` gather.  Returns the
    equalities and the kernels' launches over these serves."""
    params, cfg = mix_params(MIX_EXACT_LAYERS, dtype=torch.float32)
    cudaex.reset_launches()
    rng = np.random.default_rng(SEED + 144)
    short = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (90, 200, 333, 411)]
    long = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (1100, 1600)]
    common = dict(block_size=16, num_blocks=512, max_batch=4, device=DEVICE)

    def tokens(prompts, **kw):
        return [r.new_tokens for r in serve(None, params, cfg, **common, **kw).run(
            prompts, max_new_tokens=n_new)]

    dparams, dcfg = layer_skip_draft(params, cfg, n_layer=1)
    cases = {
        "paged = gather": (tokens(short, attn="paged"), tokens(short, attn="gather")),
        "prefill_chunk=512 = unchunked": (
            tokens(long, attn="paged", prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS),
            tokens(long, attn="paged", prefill_buckets=tuple(16 * 2 ** i for i in range(8)))),
        "speculative (1-layer MoE draft) = plain": (
            tokens(short, attn="paged", speculative=SpecConfig(dparams, dcfg, K=4)),
            tokens(short, attn="paged")),
        "quantized paged = quantized gather": (tokens(short, attn="paged", quantized=True),
                                               tokens(short, attn="gather", quantized=True)),
    }
    launches = dict(cudaex.LAUNCHES)
    out = {name: a == b for name, (a, b) in cases.items()}
    say(f"float32, {MIXTRAL} at {cfg.n_layer} layers: {out}; tokens "
        f"{ {name: a for name, (a, _) in cases.items()} }")
    if not all(out.values()):
        raise AssertionError(f"mixtral float32 token equalities failed: {out}")
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def mixtral() -> dict:
    """Phase 14: the Mixtral path (the MoE MLP, the int8/fp8 quantization
    executor) at Mixtral-8x7B's widths.  Returns the launch counts of the
    train, serve and float32 lanes' paths and the phase's records."""
    t0 = time.perf_counter()
    quant = mix_quantex()
    reference_bar = mix_reference_bar()
    train = mix_train()
    served = mix_serve()
    exact, exact_launches = mix_exact_tokens()
    say(f"phase 14 (mixtral) took {time.perf_counter() - t0:.1f} s")
    return dict(train_launches=train["launches"], serve_launches=served["launches"],
                exact_launches=exact_launches,
                quantex=quant, reference_bar=reference_bar, train=train,
                serve=served["serves"], exact=exact)


#
# phase 15: the bucket steps as CUDA graphs, multi-step decode, recovery
#


GRAPH_LANE_LAYERS = 8      # (c): the chunked and speculative serves, graphed against eager
MULTI_STEPS = 4            # (b): decode_steps
OOM_AT = 12                # (d): the decode dispatch an OOM is injected at


def phase4_prompts(cfg, n_requests=8):
    """Phase 4's prompts: 8 of 128-1024 tokens from the seed."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
            for n in rng.integers(128, 1025, n_requests)]


def held_bytes() -> int:
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def graph_serve(params, cfg, label, *, graphs=True, new_tokens=32, profile=True, **kw) -> dict:
    """Phase 4's serve on one engine whose bucket steps run as CUDA graphs
    (``graphs``) or eagerly (the engine's private switch): a first pass
    meets every bucket (on a graphed engine it captures them), the second
    is measured and must capture nothing.  Exact launches: n_layer
    ``paged_attn_decode`` and one pair write per decode iteration (N per
    dispatch at ``decode_steps=N``); then four decode steps profiled.
    Returns the tokens, the serve's figures, the memory the engine holds
    (its arenas and, graphed, its graph pool) and the profile."""
    r0 = held_bytes()
    eng = ServingEngine(params, cfg, attn="paged", block_size=16, num_blocks=1024, max_batch=8,
                        device=DEVICE, _graphs=graphs, **kw)
    prompts = phase4_prompts(cfg)
    eng.run(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    held = held_bytes() - r0
    torch.cuda.reset_peak_memory_stats()
    st0 = eng.stats()
    cudaex.reset_launches()
    t0 = time.perf_counter()
    results = eng.run(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cudaex.LAUNCHES)
    st = eng.stats()
    check_results(results, new_tokens, cfg.padded_vocab_size)
    rec = serve_stats(f"phase 15 {label}", results, wall)
    dispatches = st["decode_steps"] - st0["decode_steps"]
    iters = dispatches * eng.n_decode_steps
    # a multi-step iteration lands K and V through the masked pair write
    # (its liveness as n_emit)
    write = "paged_token_write" if eng.n_decode_steps == 1 else "paged_token_write_masked"
    want = no_launches_but(paged_attn_decode=iters * cfg.n_layer, **{write: iters})
    graphs_st = st["graphs"]
    replays = graphs_st["replays"] - st0["graphs"]["replays"]
    rec.update(tokens=[list(r.new_tokens) for r in results], launches=launches,
               capture_s=graphs_st["capture_s"],
               decode_dispatches=dispatches, decode_iterations=iters,
               host_visits=st["host_visits"] - st0["host_visits"], captures=graphs_st["captures"],
               replays=replays, held_gib=held / 2**30,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    say(f"phase 15 {label}: {dispatches} decode dispatches, {iters} iterations, "
        f"{rec['host_visits']} host visits; captures by kind {graphs_st['captures']} (all in the "
        f"first pass, {graphs_st['capture_s']:.3f} s of host), {replays} replays in the measured pass; launches {launches}; the engine "
        f"holds {rec['held_gib']:.3f} GiB, peak {rec['peak_gib']:.2f} GiB")
    if launches != want:
        raise AssertionError(f"phase 15 {label}: launches {launches} != {want}")
    if graphs and (graphs_st["captures"] != st0["graphs"]["captures"] or replays != iters):
        raise AssertionError(f"phase 15 {label}: the measured pass captured "
                             f"({st0['graphs']['captures']} -> {graphs_st['captures']}) or did "
                             f"not replay every decode iteration ({replays} of {iters})")
    if not graphs and (graphs_st["captures"] or replays):
        raise AssertionError(f"phase 15 {label}: the eager engine captured {graphs_st}")
    if profile:
        rec["profile"] = profile_decode_steps(eng, prompts,
                                              f"phase 15 {label}, decode step (8 rows)",
                                              count_spans=True)
    del eng
    return rec


def graph_lanes(params, cfg) -> dict:
    """Phase 5's chunked serve and phase 6's speculative serve at
    GRAPH_LANE_LAYERS layers, each on a graphed and an eager engine: the
    same tokens and the same launches; the graphed engine captured its
    chunk piece, draft and verify steps."""
    cfgL = Config.from_name(cfg.name, n_layer=GRAPH_LANE_LAYERS)
    pL = {**params, "blocks": params["blocks"][:GRAPH_LANE_LAYERS]}
    rng5, rng6 = np.random.default_rng(SEED + 5), np.random.default_rng(SEED + 6)
    lanes = {
        "chunked": (dict(prefill_chunk=CHUNK, prefill_buckets=CHUNK_BUCKETS, num_blocks=2048),
                    [rng5.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                     for n in rng5.integers(1024, 3073, 8)]),
        "speculative": (dict(speculative=SpecConfig(*layer_skip_draft(pL, cfgL)),
                             num_blocks=1024),
                        [rng6.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                         for n in rng6.integers(128, 1025, 8)]),
    }
    out = {}
    for lane, (kw, prompts) in lanes.items():
        got = {}
        for graphs in (False, True):
            eng = ServingEngine(pL, cfgL, attn="paged", block_size=16, max_batch=8,
                                device=DEVICE, _graphs=graphs, **kw)
            cudaex.reset_launches()
            t0 = time.perf_counter()
            res = eng.run(prompts, max_new_tokens=32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_results(res, 32, cfg.padded_vocab_size)
            st = eng.stats()
            got[graphs] = dict(tokens=[list(r.new_tokens) for r in res],
                               launches=dict(cudaex.LAUNCHES), wall_s=wall,
                               captures=st["graphs"]["captures"], replays=st["graphs"]["replays"],
                               capture_s=st["graphs"]["capture_s"])
            del eng
        ok = (got[True]["tokens"] == got[False]["tokens"]
              and got[True]["launches"] == got[False]["launches"]
              and got[True]["replays"] > 0)
        say(f"phase 15 {lane} serve at {GRAPH_LANE_LAYERS} layers: graphed {got[True]['wall_s']:.3f} "
            f"s ({got[True]['capture_s']:.3f} s of it capturing) against eager "
            f"{got[False]['wall_s']:.3f} s, captures {got[True]['captures']}, "
            f"{got[True]['replays']} replays, launches {got[True]['launches']}; tokens and "
            f"launches equal: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase 15 {lane}: the graphed engine's tokens or launches "
                                 f"differ from the eager engine's")
        out[lane] = {k: v for k, v in got[True].items() if k != "tokens"}
        out[lane]["eager_wall_s"] = got[False]["wall_s"]
    return out


RECOVERY_LAYERS = 4        # (d): the float32 serve whose recovery must give the unfaulted tokens
# (d), bf16 at full width: layer 0's replayed K/V within this many units of
# 2^-8 of their row's largest magnitude from the lost cache's.  One bf16
# rounding moves an element by at most 2 units (an ulp is at most 2^-7 of
# its magnitude); layer 0's K and V are one projection of the same
# embeddings, rounded, then rope's two products and their sum, each
# rounded: a few roundings, well under 16.  A replay that fed a wrong token
# or position moves a row by about its magnitude, 256 units.
KV_WITNESS_LAYER0_UNITS = 16


def kv_witness(eng, out: dict) -> None:
    """Wraps ``eng``'s recovery: the K/V of every request it replays,
    gathered through the request's block table before the arenas are
    zeroed and again after the replay, compared over the replayed
    positions (the prompt and all but the last emitted token).  ``out``
    gets, per layer, the largest difference in units of 2^-8 of the row's
    largest magnitude (over the head size), and the share of elements
    bitwise equal over the prompts' positions and over the positions the
    decode steps wrote."""
    inner = eng._recover_once

    def recover_once():
        reqs = [r for r in eng.scheduler.running if r.generated]
        spans = torch.tensor([r.prompt_len + len(r.generated) - 1 for r in reqs], device=DEVICE)
        prompts = torch.tensor([r.prompt_len for r in reqs], device=DEVICE)
        nbb = max(len(r.block_table) for r in reqs)
        tables = torch.full((len(reqs), nbb), SINK_BLOCK, dtype=torch.int32)
        for i, r in enumerate(reqs):
            tables[i, :len(r.block_table)] = torch.as_tensor(r.block_table, dtype=torch.int32)
        tables = tables.to(DEVICE)
        lost = eng.pool.gather(tables)                     # (L, B, ng, nbb*bs, hs) each
        inner()
        rebuilt = eng.pool.gather(tables)
        units, equal, n = [], [0, 0], [0, 0]
        for name in ("k", "v"):
            for layer in range(lost[name].shape[0]):
                a, b = lost[name][layer].float(), rebuilt[name][layer].float()
                at = torch.arange(a.shape[2], device=DEVICE)[None, :]
                keep = (at < spans[:, None])[:, None, :, None].expand_as(a)
                row = torch.maximum(a.abs(), b.abs()).amax(-1, keepdim=True) * 2.0 ** -8
                d = torch.where(keep, (a - b).abs() / row.clamp_min(1e-30), 0.0)
                if name == "k":
                    units.append(d.amax().item())
                else:
                    units[layer] = max(units[layer], d.amax().item())
                in_prompt = (at < prompts[:, None])[:, None, :, None].expand_as(a)
                for i, part in enumerate((keep & in_prompt, keep & ~in_prompt)):
                    equal[i] += int(((a == b) & part).sum().item())
                    n[i] += int(part.sum().item())
        del lost, rebuilt
        out.update(layer_units=units, equal_share=sum(equal) / sum(n),
                   prompt_equal_share=equal[0] / max(n[0], 1),
                   decode_equal_share=equal[1] / max(n[1], 1), requests=len(reqs),
                   positions=int(spans.sum().item()),
                   decode_positions=int((spans - prompts).sum().item()))

    eng._recover_once = recover_once


def faulted_serve(params, cfg, plan, witness=False) -> dict:
    """Phase 4's requests on a graphed engine with fault plan ``plan``:
    tokens, stats, whether the arenas kept their addresses, and with
    ``witness`` the recovery's K/V against the lost cache's
    (:func:`kv_witness`)."""
    eng = ServingEngine(params, cfg, attn="paged", block_size=16, num_blocks=1024, max_batch=8,
                        device=DEVICE, fault_plan=plan)
    ptrs = {k: t.data_ptr() for k, t in eng.pool.arenas.items()}
    kv = {}
    if witness:
        kv_witness(eng, kv)
    t0 = time.perf_counter()
    res = eng.run(phase4_prompts(cfg), max_new_tokens=32)
    torch.cuda.synchronize()
    out = dict(tokens=[list(r.new_tokens) for r in res], wall_s=time.perf_counter() - t0,
               stats=eng.stats(), kv=kv,
               same_ptrs={k: t.data_ptr() for k, t in eng.pool.arenas.items()} == ptrs)
    eng.__dict__.pop("_recover_once", None)                # the witness's closure holds eng
    del eng
    return out


def graph_recovery(params, cfg, bf16_tokens) -> dict:
    """An ``oom`` injected at the OOM_AT-th ``decode.dispatch`` of phase
    4's serve on a graphed engine.  In float32 at RECOVERY_LAYERS layers
    (phase 7's setting for chunked = unchunked): one recovery, the
    unfaulted run's tokens, the arenas at the addresses the graphs hold.
    The recovery replays prompts and emitted tokens through 512-row chunk
    pieces, whose products round apart from those of the prefill and the
    decode steps that wrote the lost cache.  In bf16 at full width the
    witness is the cache itself: one recovery, the arenas at their
    addresses, and layer 0's replayed K/V within KV_WITNESS_LAYER0_UNITS of
    the lost cache's (:func:`kv_witness`); the deeper layers' differences
    and the served tokens, which those roundings move through 32 layers of
    random weights, are printed with no bar."""
    plan = lambda: FaultPlan(specs=[FaultSpec(point="decode.dispatch", kind="oom",  # noqa
                                              at=OOM_AT)])
    cfgR = Config.from_name(cfg.name, n_layer=RECOVERY_LAYERS)
    p32 = _cast({**params, "blocks": params["blocks"][:RECOVERY_LAYERS]}, torch.float32)
    clean = faulted_serve(p32, cfgR, None)
    hit = faulted_serve(p32, cfgR, plan(), witness=True)
    del p32
    st = hit["stats"]
    ok = (st["recoveries"] == 1 and st["faults"]["injected"] == 1 and hit["same_ptrs"]
          and hit["tokens"] == clean["tokens"])
    wide = faulted_serve(params, cfg, plan(), witness=True)
    same = sum(a == b for a, b in zip(wide["tokens"], bf16_tokens))
    kv32, kv16 = hit["kv"], wide["kv"]
    u16 = kv16["layer_units"]
    ok16 = (wide["stats"]["recoveries"] == 1 and wide["same_ptrs"]
            and u16[0] <= KV_WITNESS_LAYER0_UNITS)
    say(f"phase 15 recovery: oom at decode dispatch {OOM_AT}, float32 at {RECOVERY_LAYERS} "
        f"layers: {st['recoveries']} recovery, {st['chunk_runs']} replay pieces, captures "
        f"{st['graphs']['captures']}, serve {hit['wall_s']:.3f} s against {clean['wall_s']:.3f} "
        f"s unfaulted; replayed K/V against the lost cache: largest {max(kv32['layer_units']):.3g} "
        f"units of 2^-8 of the row, {kv32['equal_share']:.4f} bitwise equal; unfaulted tokens "
        f"and arena addresses kept: {'ok' if ok else 'FAIL'}")
    say(f"phase 15 recovery, bf16 at full width: {wide['stats']['recoveries']} recovery, arena "
        f"addresses kept {wide['same_ptrs']}; replayed K/V of {kv16['requests']} requests over "
        f"{kv16['positions']} positions against the lost cache, largest difference in units of "
        f"2^-8 of the row by layer {[round(u, 2) for u in u16]} (layer 0 at most "
        f"{KV_WITNESS_LAYER0_UNITS}), {kv16['equal_share']:.4f} of the elements bitwise equal: "
        f"{kv16['prompt_equal_share']:.4f} over the prompts' positions, "
        f"{kv16['decode_equal_share']:.4f} over the {kv16['decode_positions']} the decode steps "
        f"wrote {'ok' if ok16 else 'FAIL'}; served tokens (no bar): {same} of "
        f"{len(bf16_tokens)} requests equal the unfaulted serve's")
    if not ok:
        raise AssertionError(f"phase 15 recovery: recoveries {st['recoveries']}, arena "
                             f"addresses kept {hit['same_ptrs']}, tokens equal "
                             f"{hit['tokens'] == clean['tokens']}")
    if not ok16:
        raise AssertionError(f"phase 15 recovery in bf16: recoveries "
                             f"{wide['stats']['recoveries']}, arena addresses kept "
                             f"{wide['same_ptrs']}, layer 0's K/V {u16[0]} units from the lost "
                             f"cache's (at most {KV_WITNESS_LAYER0_UNITS})")
    return dict(recoveries=st["recoveries"], replay_pieces=st["chunk_runs"],
                wall_s=hit["wall_s"], unfaulted_wall_s=clean["wall_s"],
                captures=st["graphs"]["captures"], kv_units_f32=max(kv32["layer_units"]),
                kv_equal_share_f32=kv32["equal_share"], bf16_kv_layer_units=u16,
                bf16_kv_equal_share=kv16["equal_share"],
                bf16_kv_prompt_equal_share=kv16["prompt_equal_share"],
                bf16_kv_decode_equal_share=kv16["decode_equal_share"], bf16_equal_requests=same,
                bf16_wall_s=wide["wall_s"])


def graphs_phase() -> dict:
    """Phase 15: (a) phase 4's Llama-3-8B serve eager and graphed (same
    tokens, exact launches, the graphed decode step's idle share below the
    eager one's); (b) the same serve at ``decode_steps=4`` (same tokens,
    at most one host visit per MULTI_STEPS decode steps plus the partial
    visits); (c) the chunked and speculative serves graphed against eager
    at GRAPH_LANE_LAYERS layers; (d) a recovered serve.  Returns the
    phase's records and its launches, summed."""
    t0 = time.perf_counter()
    params, cfg = make_params()
    eager = graph_serve(params, cfg, "decode serve, eager", graphs=False)
    graphed = graph_serve(params, cfg, "decode serve, graphed")
    multi = graph_serve(params, cfg, f"decode serve, graphed, decode_steps={MULTI_STEPS}",
                        decode_steps=MULTI_STEPS, profile=False)
    decode_tokens = 32 - 1
    max_visits = -(-decode_tokens // MULTI_STEPS) + 1
    ok = (graphed["tokens"] == eager["tokens"] and multi["tokens"] == graphed["tokens"]
          and graphed["profile"]["idle_share"] < eager["profile"]["idle_share"]
          and multi["host_visits"] <= max_visits)
    extra = graphed["held_gib"] - eager["held_gib"]
    say(f"phase 15 decode serve: tokens equal eager = graphed = decode_steps={MULTI_STEPS}: "
        f"{graphed['tokens'] == eager['tokens'] and multi['tokens'] == graphed['tokens']}; idle "
        f"share graphed {graphed['profile']['idle_share']:.4f} against eager "
        f"{eager['profile']['idle_share']:.4f}; TPOT p50 {graphed['tpot_p50_ms']:.2f} against "
        f"{eager['tpot_p50_ms']:.2f} ms; tokens/s {graphed['tokens_per_s']:.1f} against "
        f"{eager['tokens_per_s']:.1f}; the graphs hold {extra:.3f} GiB more; decode_steps="
        f"{MULTI_STEPS}: {multi['host_visits']} host visits for {decode_tokens} decode tokens "
        f"(at most {max_visits}), TPOT p50 {multi['tpot_p50_ms']:.2f} ms "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 15: the graphed or multi-step serve's tokens, idle share or "
                             "host visits missed their bars")
    lanes = graph_lanes(params, cfg)
    recovery = graph_recovery(params, cfg, graphed["tokens"])
    t_gc = time.perf_counter()
    gc.collect()
    gc_s = time.perf_counter() - t_gc
    say(f"phase 15: one gc.collect() at this point takes {gc_s:.4f} s (a capture no longer "
        f"runs one)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: eager["launches"][k] + graphed["launches"][k] + multi["launches"][k]
                for k in cudaex.LAUNCHES}
    strip = lambda r: {k: v for k, v in r.items() if k not in ("tokens", "launches")}  # noqa
    rec = dict(eager=strip(eager), graphed=strip(graphed), multi_step=strip(multi),
               graphs_extra_gib=extra, lanes=lanes, recovery=recovery, gc_collect_s=gc_s,
               card=CARD,
               seconds=time.perf_counter() - t0)
    say(f"phase 15 (graphs, multi-step, recovery) took {rec['seconds']:.1f} s")
    return rec, launches


#
# phase 17: stateful and replicated serving
#


STATEFUL_LAYERS = 4        # (f): the float32 token equalities
SESSION_CHATS, SESSION_TURNS, SESSION_NEW = 8, 3, 32
PRIORITY_LOWS, PRIORITY_PROMPT, PRIORITY_NEW = 7, 496, 32
PRIORITY_STEPS = 4         # (b): engine steps between the low requests and the high one
CONSTRAINED_ROWS = {0: "token set", 2: "token set", 4: "sequence", 6: "sequence"}
ROUTER_FAMILY, ROUTER_PREFIX = 16, 512
# block-aligned prefill buckets: a replay's chunk pieces (preemption,
# recovery) take the paged chunk kind, paged_attn_verify + paged_chunk_write
STATEFUL_PREFILL = tuple(16 * 2 ** i for i in range(8))       # 16 .. 2048


def stateful_engine(params, cfg, **kw):
    """A graphed engine (or ``replicas=N`` router) on the paged lane."""
    kw = {"attn": "paged", "block_size": 16, "num_blocks": 1024, "max_batch": 8,
          "prefill_buckets": STATEFUL_PREFILL, **kw}
    return serve(None, params, cfg, device=DEVICE, **kw)


def _lanes(eng) -> list:
    return list(eng.engines) if hasattr(eng, "engines") else [eng]


def _step_totals(eng) -> dict:
    """Decode iterations, chunk pieces, graph replays and captures summed
    over an engine's lanes."""
    lanes = _lanes(eng)
    sts = [e.stats() for e in lanes]
    captures = {}
    for st in sts:
        for k, v in st["graphs"]["captures"].items():
            captures[k] = captures.get(k, 0) + v
    return {"iters": sum(st["decode_steps"] * e.n_decode_steps for st, e in zip(sts, lanes)),
            "pieces": sum(st["chunk_runs"] for st in sts),
            "replays": sum(st["graphs"]["replays"] for st in sts), "captures": captures}


def stateful_pass(label, eng, cfg, run, *, passes=2) -> tuple:
    """``run(eng, i)`` ``passes`` times; the last pass is measured: it
    captures nothing, replays one graph per decode iteration and per chunk
    piece, and launches exactly ``n_layer`` ``paged_attn_decode`` and one
    pair write per iteration and ``n_layer`` ``paged_attn_verify`` and one
    ``paged_chunk_write`` per piece.  Returns ``(run's result, wall s,
    launches, totals of the measured pass)``."""
    for i in range(passes - 1):
        run(eng, i)
    torch.cuda.synchronize()
    t0 = _step_totals(eng)
    cudaex.reset_launches()
    w0 = time.perf_counter()
    out = run(eng, passes - 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    launches = dict(cudaex.LAUNCHES)
    t1 = _step_totals(eng)
    iters, pieces = t1["iters"] - t0["iters"], t1["pieces"] - t0["pieces"]
    replays = t1["replays"] - t0["replays"]
    multi = any(e.n_decode_steps > 1 for e in _lanes(eng))
    write = "paged_token_write_masked" if multi else "paged_token_write"
    want = no_launches_but(paged_attn_decode=iters * cfg.n_layer, **{write: iters},
                           paged_attn_verify=pieces * cfg.n_layer, paged_chunk_write=pieces)
    ok = launches == want and t1["captures"] == t0["captures"] and replays == iters + pieces
    say(f"phase 17 {label}: measured pass {wall:.3f} s, {iters} decode iterations and {pieces} "
        f"chunk pieces, {replays} graph replays, captures {t1['captures']} (none in the "
        f"measured pass: {t1['captures'] == t0['captures']}); launches {launches} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 17 {label}: launches {launches} != {want}, or the measured "
                             f"pass captured ({t0['captures']} -> {t1['captures']}) or replayed "
                             f"{replays} graphs for {iters} iterations and {pieces} pieces")
    return out, wall, launches, {"iters": iters, "pieces": pieces, "replays": replays}


def _p50_ms(xs) -> float:
    return 1e3 * float(np.median(xs))


def session_chats(cfg, seed):
    """Turn-1 prompts of 400-900 tokens and the 40-120 token messages of
    later turns, for SESSION_CHATS chats."""
    rng = np.random.default_rng(seed)
    first = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
             for n in rng.integers(400, 901, SESSION_CHATS)]
    msgs = [[rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
             for n in rng.integers(40, 121, SESSION_CHATS)] for _ in range(SESSION_TURNS - 1)]
    return first, msgs


def serve_chats(eng, first, msgs, new_tokens, tag=""):
    """SESSION_TURNS turns of every chat, each turn's requests served
    together; a later turn's prompt is the history plus its message.
    Returns per turn the results, the prompts and each session's parked
    block count after the turn."""
    prompts = list(first)
    turns = []
    for t in range(SESSION_TURNS):
        hs = [eng.submit(p, max_new_tokens=new_tokens, session_id=f"{tag}chat{i}")
              for i, p in enumerate(prompts)]
        eng.drain()
        res = [h.result(drive=False) for h in hs]
        parked = {e.session_id: len(e.blocks) for e in eng._sessions.entries()}
        turns.append({"results": res, "prompts": prompts, "parked": parked})
        if t + 1 < SESSION_TURNS:
            prompts = [np.concatenate([p, np.asarray(r.new_tokens, np.int32), m])
                       for p, r, m in zip(prompts, res, msgs[t])]
    return turns


def sessions_serve(params, cfg) -> tuple[dict, dict]:
    """(a): the session engine's measured pass of the chats (a first pass
    with other session ids met every bucket; its sessions are closed), the
    bars, and a cold engine serving turns 2-3's full-history prompts."""
    first, msgs = session_chats(cfg, SEED + 17)
    eng = stateful_engine(params, cfg, num_blocks=2048, sessions=True)

    def run(e, i):
        h0 = e.stats()["sessions"]["reattach_hits"]
        turns = serve_chats(e, first, msgs, SESSION_NEW, tag=f"p{i}-")
        if i == 0:
            for j in range(SESSION_CHATS):
                e.close_session(f"p0-chat{j}")
        return turns, e.stats()["sessions"]["reattach_hits"] - h0

    (turns, hits), wall, launches, steps = stateful_pass("(a) sessions, 8 chats x 3 turns", eng,
                                                         cfg, run)
    table = eng.stats()["sessions"]
    shared_ok = all(
        r.shared_prefix_blocks == turns[t - 1]["parked"][f"p1-chat{i}"]
        for t in range(1, SESSION_TURNS) for i, r in enumerate(turns[t]["results"]))
    later = [r for t in turns[1:] for r in t["results"]]
    for t in turns:
        check_results(t["results"], SESSION_NEW, cfg.padded_vocab_size)
    del eng
    gc.collect()
    cold = stateful_engine(params, cfg, num_blocks=2048)
    cold_prompts = [t["prompts"] for t in turns[1:]]

    def cold_run(e, i):
        out = []
        for ps in cold_prompts:
            out += e.run(ps, max_new_tokens=SESSION_NEW)
        return out

    # a comparison run: its launches stay out of the kernels line's paths
    cold_res, cold_wall, _, _ = stateful_pass("(a) cold engine, turns 2-3", cold, cfg, cold_run)
    del cold
    same = sum(a.new_tokens == b.new_tokens for a, b in zip(later, cold_res))
    first_same = sum(a.new_tokens[0] == b.new_tokens[0] for a, b in zip(later, cold_res))
    rec = dict(reattach_hits=hits, shared_blocks=[r.shared_prefix_blocks for r in later],
               ttft_p50_ms_turns23=_p50_ms([r.ttft_s for r in later]),
               cold_ttft_p50_ms=_p50_ms([r.ttft_s for r in cold_res]),
               resident_blocks=table["resident_blocks"], resident_bytes=table["resident_bytes"],
               wall_s=wall, cold_wall_s=cold_wall, bf16_equal_cold=same,
               bf16_first_token_equal_cold=first_same, **steps)
    ok = hits == 2 * SESSION_CHATS and shared_ok
    say(f"phase 17 (a) sessions on {CARD}: {hits} re-attaches (want {2 * SESSION_CHATS}), later "
        f"turns' shared blocks {rec['shared_blocks']} equal the blocks their sessions parked: "
        f"{shared_ok}; TTFT p50 turns 2-3 {rec['ttft_p50_ms_turns23']:.1f} ms against "
        f"{rec['cold_ttft_p50_ms']:.1f} ms on a cold engine; resident {table['resident_blocks']} "
        f"blocks, {table['resident_bytes']} B; bf16 tokens equal the cold engine's on {same} of "
        f"{len(later)} requests, their first token on {first_same} (no bar: the tail's prefill "
        f"rounds apart from the full prompt's) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 17 (a): re-attach count or shared blocks off their bars")
    return rec, {"sessions serve": launches}


def priority_prompts(cfg, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, PRIORITY_PROMPT).astype(np.int32)
            for _ in range(PRIORITY_LOWS + 1)]


def priority_run(prompts, prioritized):
    """The 7 low requests, PRIORITY_STEPS steps, then the high one; returns
    the results and the pass's preemptions."""
    def run(e, i):
        kw = (lambda p: {"priority": p}) if prioritized else (lambda p: {})
        p0 = e.preempted
        hs = [e.submit(p, max_new_tokens=PRIORITY_NEW, **kw("low")) for p in prompts[:-1]]
        for _ in range(PRIORITY_STEPS):
            e.step()
        hs.append(e.submit(prompts[-1], max_new_tokens=PRIORITY_NEW, **kw("high")))
        e.drain()
        return [h.result(drive=False) for h in hs], e.preempted - p0
    return run


def priority_serve(params, cfg) -> tuple[dict, dict]:
    """(b): a pool the 7 low requests fill (33 blocks each), then a high
    request: the prioritized engine preempts, the plain one queues it."""
    prompts = priority_prompts(cfg, SEED + 171)
    blocks = -(-(PRIORITY_PROMPT + PRIORITY_NEW) // 16)
    num_blocks = PRIORITY_LOWS * blocks + 1               # + the sink
    out, launches = {}, {}
    for prioritized in (True, False):
        eng = stateful_engine(params, cfg, num_blocks=num_blocks,
                              **({"priorities": True} if prioritized else {}))
        label = "(b) priorities" if prioritized else "(b) priorities=None"
        (res, preempted), wall, launches[prioritized], steps = stateful_pass(
            label, eng, cfg, priority_run(prompts, prioritized))
        check_results(res, PRIORITY_NEW, cfg.padded_vocab_size)
        out[prioritized] = dict(res=res, preempted=preempted, wall_s=wall, **steps)
        del eng
        gc.collect()
    pre, plain = out[True], out[False]
    victims = [r.tokens_recomputed for r in pre["res"] if r.tokens_recomputed]
    rec = dict(preempted=pre["preempted"], high_ttft_ms=1e3 * pre["res"][-1].ttft_s,
               plain_high_ttft_ms=1e3 * plain["res"][-1].ttft_s,
               victims_tokens_recomputed=victims, wall_s=pre["wall_s"],
               plain_wall_s=plain["wall_s"], pieces=pre["pieces"],
               bf16_equal_plain=sum(a.new_tokens == b.new_tokens
                                    for a, b in zip(pre["res"], plain["res"])))
    ok = pre["preempted"] >= 1
    say(f"phase 17 (b) priorities on {CARD}: {pre['preempted']} preemptions, every request "
        f"finished; the high request's TTFT {rec['high_ttft_ms']:.1f} ms against "
        f"{rec['plain_high_ttft_ms']:.1f} ms on a priorities=None engine; victims' recomputed "
        f"positions {victims} over {pre['pieces']} chunk pieces {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 17 (b): no preemption")
    return rec, {"priority serve": launches[True]}


def make_constraints(cfg):
    """Fresh automata of the constrained rows: 1000 allowed ids, and a
    cycle of three allow-lists of 8, 100 and 1 ids."""
    rng = np.random.default_rng(SEED + 172)
    V = cfg.padded_vocab_size
    ids = rng.choice(cfg.vocab_size, min(1000, cfg.vocab_size // 2), replace=False)
    steps = [rng.choice(cfg.vocab_size, n, replace=False) for n in (8, 100, 1)]
    return {i: (TokenSetConstraint(V, ids) if kind == "token set"
                else sequence_constraint(V, steps, cycle=True))
            for i, kind in CONSTRAINED_ROWS.items()}


def constraints_allowed(cfg, results) -> bool:
    """Every constrained row's tokens walked through a fresh copy of its
    automaton: each allowed by the mask of its draw."""
    for i, c in make_constraints(cfg).items():
        for tok in results[i].new_tokens:
            if not c.mask()[tok]:
                return False
            c.advance(tok)
    return True


def constrained_serve(params, cfg) -> tuple[dict, dict]:
    """(c): phase 4's prompts with 4 constrained rows at decode_steps=1 and
    MULTI_STEPS, beside unconstrained engines; the mask upload timed."""
    prompts = phase4_prompts(cfg)
    rec, launches = {}, {}
    for N in (1, MULTI_STEPS):
        got = {}
        for constrained in (True, False):
            eng = stateful_engine(params, cfg, decode_steps=N,
                                  **({"constraints": True} if constrained else {}))
            upload = [0.0, 0]
            if constrained:
                inner = eng._decode_masks

                def timed_masks(*a, _inner=inner):
                    t = time.perf_counter()
                    m = _inner(*a)
                    upload[0] += time.perf_counter() - t
                    upload[1] += 1
                    return m

                eng._decode_masks = timed_masks

            def run(e, i, constrained=constrained):
                upload[:] = [0.0, 0]                   # the pass's own mask uploads
                cs = make_constraints(cfg) if constrained else {}
                hs = [e.submit(p, max_new_tokens=32, **({"constraint": cs[j]} if j in cs else {}))
                      for j, p in enumerate(prompts)]
                e.drain()
                return [h.result(drive=False) for h in hs]

            label = f"(c) {'constrained' if constrained else 'unconstrained'}, decode_steps={N}"
            res, wall, ln, steps = stateful_pass(label, eng, cfg, run)
            eng.__dict__.pop("_decode_masks", None)
            check_results(res, 32, cfg.padded_vocab_size)
            got[constrained] = dict(res=res, wall_s=wall, tpot_p50_ms=_p50_ms(
                [r.tpot_s for r in res]), upload_ms=(1e3 * upload[0] / upload[1]
                                                     if upload[1] else None), **steps)
            if constrained:
                launches[f"constrained serve{'' if N == 1 else f', decode_steps={N}'}"] = ln
            del eng
            gc.collect()
        con, plain = got[True], got[False]
        allowed = constraints_allowed(cfg, con["res"])
        free = [i for i in range(len(prompts)) if i not in CONSTRAINED_ROWS]
        same = sum(con["res"][i].new_tokens == plain["res"][i].new_tokens for i in free)
        rec[f"decode_steps={N}"] = dict(
            allowed=allowed, tpot_p50_ms=con["tpot_p50_ms"], plain_tpot_p50_ms=plain["tpot_p50_ms"],
            mask_upload_ms_per_dispatch=con["upload_ms"], unconstrained_rows_equal=same,
            replays=con["replays"], iters=con["iters"])
        say(f"phase 17 (c) constraints, decode_steps={N}, on {CARD}: every constrained token "
            f"allowed by its automaton: {allowed}; TPOT p50 {con['tpot_p50_ms']:.2f} ms against "
            f"{plain['tpot_p50_ms']:.2f} ms unconstrained; mask upload "
            f"{con['upload_ms']:.4f} ms of host a dispatch; the unconstrained rows' bf16 tokens "
            f"equal the unconstrained engine's on {same} of {len(free)} (no bar) "
            f"{'ok' if allowed else 'FAIL'}")
        if not allowed:
            raise AssertionError(f"phase 17 (c): a constrained token at decode_steps={N} is not "
                                 f"allowed by its automaton")
    return rec, launches


def router_families(cfg, seed):
    """Two families of ROUTER_FAMILY prompts, each a shared ROUTER_PREFIX-
    token prefix and a 16-64 token suffix, interleaved A, B, A, B, ..."""
    rng = np.random.default_rng(seed)
    fams = []
    for _ in range(2):
        prefix = rng.integers(0, cfg.vocab_size, ROUTER_PREFIX).astype(np.int32)
        fams.append([np.concatenate([prefix, rng.integers(0, cfg.vocab_size, int(n)).astype(
            np.int32)]) for n in rng.integers(16, 65, ROUTER_FAMILY)])
    return [p for pair in zip(*fams) for p in pair]


def router_serve(params, cfg) -> tuple[dict, dict]:
    """(d): replicas=2 against a solo engine with the same total blocks and
    batch rows."""
    prompts = router_families(cfg, SEED + 173)

    def run(e, i):
        h0 = [x.stats()["prefix_hits"] for x in _lanes(e)]
        hs = [e.submit(p, max_new_tokens=32) for p in prompts]
        e.drain()
        return hs, [x.stats()["prefix_hits"] - h for x, h in zip(_lanes(e), h0)]

    fleet = stateful_engine(params, cfg, replicas=2)
    (hs, hits), wall, launches, steps = stateful_pass("(d) replicas=2", fleet, cfg, run)
    res = [h.result(drive=False) for h in hs]
    check_results(res, 32, cfg.padded_vocab_size)
    lanes = [{h.replica for h in hs[f::2]} for f in (0, 1)]
    n_tok = sum(len(r.new_tokens) for r in res)
    del fleet
    gc.collect()
    solo = stateful_engine(params, cfg, num_blocks=2048, max_batch=16)
    (shs, _), swall, _, _ = stateful_pass("(d) solo engine", solo, cfg, run)
    sres = [h.result(drive=False) for h in shs]
    del solo
    ok = all(len(s) == 1 for s in lanes) and all(h > 0 for h in hits)
    rec = dict(family_lanes=[sorted(s) for s in lanes], prefix_hits=hits,
               tokens_per_s=n_tok / wall, solo_tokens_per_s=n_tok / swall, wall_s=wall,
               solo_wall_s=swall,
               bf16_equal_solo=sum(a.new_tokens == b.new_tokens for a, b in zip(res, sres)),
               bf16_first_token_equal_solo=sum(a.new_tokens[0] == b.new_tokens[0]
                                               for a, b in zip(res, sres)), **steps)
    say(f"phase 17 (d) replicas=2 on {CARD}: families on replicas {rec['family_lanes']}, prefix "
        f"hits per replica {hits}; {rec['tokens_per_s']:.1f} tokens/s against "
        f"{rec['solo_tokens_per_s']:.1f} on a solo engine of the same 2048 blocks and 16 rows; "
        f"bf16 tokens equal the solo engine's on {rec['bf16_equal_solo']} of {len(res)}, their "
        f"first token on {rec['bf16_first_token_equal_solo']} (no bar: 8-row and 16-row steps "
        f"round apart) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase 17 (d): a family split across replicas or a replica without "
                             "prefix hits")
    return rec, {"routed serve": launches}


def gpt2_serve() -> tuple[dict, dict]:
    """(e): gpt2-124m (learned positions) at full width and depth in bf16,
    random weights, on the paged lane."""
    cfg = Config.from_name("gpt2-124m")
    params = init_params(cfg, generator=torch.Generator(DEVICE).manual_seed(SEED + 174),
                         dtype=torch.bfloat16, device=DEVICE)
    rng = np.random.default_rng(SEED + 174)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(128, 961, 8)]
    eng = stateful_engine(params, cfg, num_blocks=512)

    def run(e, i):
        return e.run(prompts, max_new_tokens=32)

    res, wall, launches, steps = stateful_pass("(e) gpt2-124m", eng, cfg, run)
    check_results(res, 32, cfg.padded_vocab_size)
    sch = eng.scheduler
    rec = dict(block_buckets=list(sch.block_buckets), prefill_buckets=list(sch.prefill_buckets),
               prefix_sharing=eng.prefix_sharing, wall_s=wall,
               **serve_stats("phase 17 (e) gpt2-124m bf16", res, wall), **steps)
    say(f"phase 17 (e) gpt2-124m on {CARD}: {launches['paged_attn_decode']} paged_attn_decode for "
        f"{steps['iters']} decode steps ({cfg.n_layer} a step); buckets capped at block_size "
        f"{cfg.block_size}: block {rec['block_buckets']}, prefill {rec['prefill_buckets']}, "
        f"prefix sharing {eng.prefix_sharing}")
    del eng, params
    return rec, {"gpt2 serve": launches}


def stateful_exact(params, cfg, n_new=8) -> dict:
    """(f): float32 at STATEFUL_LAYERS layers of Llama-3-8B, and gpt2-124m
    float32 at full depth: the token equalities of the stateful options."""
    cfg4 = Config.from_name(cfg.name, n_layer=STATEFUL_LAYERS)
    p32 = _cast({**params, "blocks": params["blocks"][:STATEFUL_LAYERS]}, torch.float32)
    common = dict(num_blocks=512)
    out = {}
    # sessions: turns 2-3 against a cold engine
    first, msgs = session_chats(cfg4, SEED + 175)
    first, msgs = first[:4], [m[:4] for m in msgs]
    eng = stateful_engine(p32, cfg4, sessions=True, num_blocks=1024)
    turns = serve_chats(eng, first, msgs, n_new)
    cold = stateful_engine(p32, cfg4, num_blocks=1024)
    want = [[r.new_tokens for r in cold.run(t["prompts"], max_new_tokens=n_new)]
            for t in turns[1:]]
    out["sessions"] = [[r.new_tokens for r in t["results"]] for t in turns[1:]] == want
    out["session_reattach_hits"] = eng.stats()["sessions"]["reattach_hits"]
    del eng, cold
    # priorities: the preempted and the high request against solo runs
    prompts = priority_prompts(cfg4, SEED + 176)[:3]
    for temp in (0.0, 0.7):
        def gens():
            return [torch.Generator(DEVICE).manual_seed(SEED + i) for i in range(3)]

        eng = stateful_engine(p32, cfg4, priorities=True, temperature=temp, max_batch=2,
                              num_blocks=2 * (-(-(PRIORITY_PROMPT + 2 * n_new) // 16)) + 1)
        g = gens()
        hs = [eng.submit(prompts[i], max_new_tokens=2 * n_new, generator=g[i], priority="low")
              for i in range(2)]
        for _ in range(PRIORITY_STEPS):
            eng.step()
        hs.append(eng.submit(prompts[2], max_new_tokens=2 * n_new, generator=g[2],
                             priority="high"))
        eng.drain()
        got = [h.result(drive=False).new_tokens for h in hs]
        preempted = eng.preempted
        g = gens()
        solo = [stateful_engine(p32, cfg4, temperature=temp, **common).submit(
            prompts[i], max_new_tokens=2 * n_new, generator=g[i]).result().new_tokens
            for i in range(3)]
        out[f"priority temperature {temp}"] = got == solo and preempted >= 1
        del eng
    # constraints: the unconstrained rows of a constrained batch
    ps = phase4_prompts(cfg4)[:4]
    cs = {1: make_constraints(cfg4)[0]}
    con = stateful_engine(p32, cfg4, constraints=True, **common)
    hs = [con.submit(p, max_new_tokens=n_new, **({"constraint": cs[i]} if i in cs else {}))
          for i, p in enumerate(ps)]
    con.drain()
    plain = stateful_engine(p32, cfg4, **common).run(ps, max_new_tokens=n_new)
    out["constraints"] = all(hs[i].result(drive=False).new_tokens == plain[i].new_tokens
                             for i in range(len(ps)) if i not in cs)
    del con
    # the router against the solo engine
    rp = router_families(cfg4, SEED + 177)[:8]
    routed = stateful_engine(p32, cfg4, replicas=2, **common).run(rp, max_new_tokens=n_new)
    solo = stateful_engine(p32, cfg4, num_blocks=1024, max_batch=16).run(rp, max_new_tokens=n_new)
    out["router"] = [r.new_tokens for r in routed] == [r.new_tokens for r in solo]
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    # gpt2-124m float32: paged against gather
    gcfg = Config.from_name("gpt2-124m")
    gp = init_params(gcfg, generator=torch.Generator(DEVICE).manual_seed(SEED + 178),
                     dtype=torch.float32, device=DEVICE)
    rng = np.random.default_rng(SEED + 178)
    gps = [rng.integers(0, gcfg.vocab_size, int(n)).astype(np.int32) for n in (90, 300, 700)]
    paged = [r.new_tokens for r in stateful_engine(gp, gcfg, num_blocks=256).run(
        gps, max_new_tokens=n_new)]
    gather = [r.new_tokens for r in stateful_engine(gp, gcfg, num_blocks=256, attn="gather").run(
        gps, max_new_tokens=n_new)]
    out["gpt2 paged = gather"] = paged == gather
    del gp
    ok = all(v for k, v in out.items() if k != "session_reattach_hits")
    say(f"phase 17 (f) float32 at {STATEFUL_LAYERS} layers (gpt2-124m at 12): {json.dumps(out)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 17 (f): a float32 token equality failed: {out}")
    return out


def stateful_phase(params, cfg) -> tuple[dict, dict]:
    """Phase 17: (a) sessions, (b) priorities, (c) constraints, (d) the
    replica router, (e) learned positions, (f) float32 token equalities.
    Returns the phase's records and its launches by path."""
    t0 = time.perf_counter()
    rec, launches = {}, {}
    for key, fn, args in (("sessions", sessions_serve, (params, cfg)),
                          ("priority", priority_serve, (params, cfg)),
                          ("constraints", constrained_serve, (params, cfg)),
                          ("router", router_serve, (params, cfg)),
                          ("gpt2", gpt2_serve, ())):
        rec[key], ln = fn(*args)
        launches.update(ln)
        gc.collect()
        torch.cuda.empty_cache()
    rec["exact"] = stateful_exact(params, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(card=CARD, seconds=time.perf_counter() - t0)
    say(f"phase 17 (stateful and replicated serving) took {rec['seconds']:.1f} s")
    return rec, launches


#
# Phase 18: the front end.  jit of a torch.nn.Module (ThunderModule and its
# autograd bridge), the runtime profiler, the anomaly hooks, and an HF
# state dict converted and served
#


class RMSNorm(torch.nn.Module):
    def __init__(self, size: int, eps: float):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(size))
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(ms + self.eps)
        return (xf * self.weight.float()).to(x.dtype)


def rope(x, cos, sin):
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x * cos + rotated * sin).to(x.dtype)


class Attention(torch.nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        C, hs = cfg.n_embd, cfg.head_size
        self.nh, self.ng, self.hs = cfg.n_head, cfg.n_query_groups, hs
        self.wq = torch.nn.Linear(C, self.nh * hs, bias=False)
        self.wk = torch.nn.Linear(C, self.ng * hs, bias=False)
        self.wv = torch.nn.Linear(C, self.ng * hs, bias=False)
        self.wo = torch.nn.Linear(self.nh * hs, C, bias=False)

    def forward(self, x, cos, sin):
        B, T, _ = x.shape
        q = self.wq(x).reshape(B, T, self.nh, self.hs).transpose(1, 2)
        k = self.wk(x).reshape(B, T, self.ng, self.hs).transpose(1, 2)
        v = self.wv(x).reshape(B, T, self.ng, self.hs).transpose(1, 2)
        # LitGPT ropes the first rope_n_elem channels (all of them here)
        q, k = rope(q[..., :self.hs], cos, sin), rope(k[..., :self.hs], cos, sin)
        y = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        return self.wo(y.transpose(1, 2).reshape(B, T, self.nh * self.hs))


class MLP(torch.nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        C, inter = cfg.n_embd, cfg.intermediate_size
        self.fc_1 = torch.nn.Linear(C, inter, bias=False)
        self.fc_2 = torch.nn.Linear(C, inter, bias=False)
        self.proj = torch.nn.Linear(inter, C, bias=False)

    def forward(self, x):
        return self.proj(F.silu(self.fc_1(x)) * self.fc_2(x))


class Block(torch.nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.norm_1 = RMSNorm(cfg.n_embd, cfg.norm_eps)
        self.attn = Attention(cfg)
        self.norm_2 = RMSNorm(cfg.n_embd, cfg.norm_eps)
        self.mlp = MLP(cfg)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.norm_1(x), cos, sin)
        return x + self.mlp(self.norm_2(x))


class LlamaModule(torch.nn.Module):
    """A LitGPT-style Llama written with stock ``torch``/``F`` calls: its
    forward takes token ids and targets and returns the mean next-token
    cross-entropy.  The rotary tables are non-persistent buffers built for
    ``seq_len`` tokens."""

    def __init__(self, cfg: Config, seq_len: int):
        super().__init__()
        self.wte = torch.nn.Embedding(cfg.padded_vocab_size, cfg.n_embd)
        self.blocks = torch.nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = RMSNorm(cfg.n_embd, cfg.norm_eps)
        self.lm_head = torch.nn.Linear(cfg.n_embd, cfg.padded_vocab_size, bias=False)
        cos, sin = build_rope_cache(cfg, seq_len, device=self.wte.weight.device)
        self.register_buffer("cos", cos, persistent=False)
        self.register_buffer("sin", sin, persistent=False)

    def forward(self, idx, targets):
        cos, sin = self.cos, self.sin
        if idx.shape[1] != cos.shape[0]:
            cos, sin = cos[:idx.shape[1]], sin[:idx.shape[1]]
        x = self.wte(idx)
        for block in self.blocks:
            x = block(x, cos, sin)
        logits = self.lm_head(self.ln_f(x))
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1))


# the module's parameter names against the functional params' paths
MODULE_PARAMS = {"wte.weight": ("wte",), "ln_f.weight": ("ln_f",), "lm_head.weight": ("lm_head",)}
BLOCK_PARAMS = {"norm_1.weight": ("norm_1",), "norm_2.weight": ("norm_2",),
                **{f"attn.{n}.weight": ("attn", n) for n in ("wq", "wk", "wv", "wo")},
                **{f"mlp.{n}.weight": ("mlp", n) for n in ("fc_1", "fc_2", "proj")}}


def llama_module(params, cfg: Config, seq_len: int, device=None) -> LlamaModule:
    """A :class:`LlamaModule` whose parameters are ``params``' tensors (no
    copies: each ``nn.Parameter`` wraps the functional param itself)."""
    with torch.device("meta"):
        module = LlamaModule(dataclasses.replace(cfg, n_layer=len(params["blocks"])), seq_len)
    device = params["wte"].device if device is None else device
    cos, sin = build_rope_cache(cfg, seq_len, device=device)
    module.cos, module.sin = cos, sin

    def put(mod, name, value):
        owner, _, attr = name.rpartition(".")
        setattr(mod.get_submodule(owner), attr, torch.nn.Parameter(value))

    for name, path in MODULE_PARAMS.items():
        put(module, name, functools.reduce(lambda d, k: d[k], path, params))
    for i, bp in enumerate(params["blocks"]):
        for name, path in BLOCK_PARAMS.items():
            put(module.blocks[i], name, functools.reduce(lambda d, k: d[k], path, bp))
    return module


FRONTEND_LAYERS = 32           # (a): the module's depth at full width
FRONTEND_CHECK_LAYERS = 4      # (a): the float32 and bf16 checks and the AdamW step
FRONTEND_MEM_SLACK = 64 << 20  # (a): memory_allocated after backward over the pre-call level + grads
MODULE_LOSS_REL_F32 = 1e-5     # (a): float32 loss against the eager module's, relative
MODULE_GRAD_REL_F32 = 1e-4     # (a): float32 grads against the eager module's, of each grad's max
HF_GPT2 = types.SimpleNamespace(model_type="gpt2", n_positions=1024, vocab_size=50257, n_layer=12,
                                n_head=12, n_embd=768, n_inner=None, layer_norm_epsilon=1e-5,
                                activation_function="gelu_new")   # (d): gpt2-124m's HF config
PHASE10_STEP_MS: list = []     # phase 10's traced step times, printed beside (a)'s
SDPA_SYMBOLS = ("cuda_sdpa", "cuda_sdpa_backward")   # the flash kernels' claimed symbols


def _module_run(tm, module, idx, tgt):
    """One forward and ``loss.backward()``: (loss, {name: grad})."""
    for p in module.parameters():
        p.grad = None
    loss = tm(idx, tgt)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in module.named_parameters()}


def _program_launches(tm, n_layer: int, label: str) -> dict:
    """The launches one forward and backward of ``tm`` must count, read
    from its programs: ``flash_fwd`` per ``cuda_sdpa`` of both (each layer
    once, once more per recompute), ``flash_bwd_dq``/``_dkv`` per
    ``cuda_sdpa_backward`` and ``flash_ce`` per ``torch_cross_entropy_fwd``;
    fails on a symbol other than ``cuda_*``, ``torch_*`` and regions, or on a
    region holding what it may not."""
    fw, bw = ttt.last_traces(tm)[-1], ttt.last_backward_traces(tm)[-1]
    count = {tr: [b.sym.name for b in t.bound_symbols] for tr, t in (("fw", fw), ("bw", bw))}
    stray = [n for t in (fw, bw) for b in t.bound_symbols for n in [b.sym.name]
             if not n.startswith(("cuda_", "torch_", "python_")) and not b.sym.is_fusion
             and b.sym.id is not ir_prims.PrimIDs.RETURN and n != "unpack_saved"
             ] + region_problems([fw, bw])
    n_fw = count["fw"].count(SDPA_SYMBOLS[0])
    n_re = count["bw"].count(SDPA_SYMBOLS[0])
    n_bwd = count["bw"].count(SDPA_SYMBOLS[1])
    n_ce = count["fw"].count("torch_cross_entropy_fwd")
    regions = [sum(b.sym.is_fusion for b in t.bound_symbols) for t in (fw, bw)]
    say(f"{label} programs: {len(fw.bound_symbols)} forward and {len(bw.bound_symbols)} backward "
        f"bound symbols, fusion regions {regions}; cuda_sdpa {n_fw} forward + {n_re} recomputed, "
        f"cuda_sdpa_backward {n_bwd}, torch_cross_entropy_fwd {n_ce}; stray {stray}")
    if stray or n_fw != n_layer or n_bwd != n_layer or n_ce != 1:
        raise AssertionError(f"{label}: the programs' symbols: {count}, stray {stray}")
    return no_launches_but(flash_fwd=n_fw + n_re, flash_bwd_dq=n_bwd, flash_bwd_dkv=n_bwd,
                           flash_ce=n_ce)


def _add(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def module_full_width(params, cfg) -> tuple[dict, dict]:
    """(a) ``jit(LlamaModule)`` of Llama-3-8B at full width and
    FRONTEND_LAYERS layers, bf16, B=1, T=JIT_T: exact launches from the
    programs, no declines, every parameter's ``.grad``; the second call a
    cache hit whose memory after backward is the pre-call level plus the
    grads (within FRONTEND_MEM_SLACK); step ms, peak GiB, device ms by
    kernel group, regions compiled against those met before."""
    n = FRONTEND_LAYERS
    cfgn = Config.from_name(cfg.name, n_layer=n)
    module = llama_module({**params, "blocks": params["blocks"][:n]}, cfgn, JIT_T)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    idx, tgt, _, _ = jit_batch(cfgn, JIT_T, gen)
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    total = {}
    tm = ttt.jit(module)
    before = dict(inductorex.STATS)
    cudaex.reset_launches()
    t0 = time.perf_counter()
    loss, grads = _module_run(tm, module, idx, tgt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = dict(cudaex.LAUNCHES)
    _add(total, got)
    compiles = inductorex.STATS["compiles"] - before["compiles"]
    compile_s = inductorex.STATS["compile_s"] - before["compile_s"]
    want = _program_launches(tm, n, f"phase 18 (a) jit(LlamaModule) {n} layers")
    missing = [k for k, g in grads.items() if g is None]
    fw, bw = ttt.last_traces(tm)[-1], ttt.last_backward_traces(tm)[-1]
    regions = [b._call_ctx[b.sym.name] for t in (fw, bw) for b in t.bound_symbols
               if b.sym.is_fusion]
    structures = len({r.key for r in regions})
    if got != want or any(ltorch.DECLINES.values()) or missing or not math.isfinite(loss.item()):
        raise AssertionError(f"phase 18 (a): launches {got} != {want}, declines "
                             f"{ltorch.DECLINES}, params without grad {missing[:4]}, loss {loss}")
    # the second call: a cache hit; the residuals die with backward
    del grads
    for p in module.parameters():
        p.grad = None
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cudaex.reset_launches()
    t0 = time.perf_counter()
    loss2, grads = _module_run(tm, module, idx, tgt)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    got2 = dict(cudaex.LAUNCHES)
    _add(total, got2)
    peak = torch.cuda.max_memory_allocated()
    grad_bytes = sum(g.numel() * g.element_size() for g in grads.values())
    del loss2
    gc.collect()
    left = torch.cuda.memory_allocated() - mem0 - grad_bytes
    hits = (ttt.cache_hits(tm), ttt.cache_misses(tm))
    ok = got2 == want and abs(left) <= FRONTEND_MEM_SLACK and hits == (1, 1)
    # device time by kernel group over one more call
    del grads
    for p in module.parameters():
        p.grad = None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        cudaex.reset_launches()
        _module_run(tm, module, idx, tgt)
        torch.cuda.synchronize()
    _add(total, cudaex.LAUNCHES)
    spans = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    groups: dict[str, float] = {}
    for name, dur in spans:
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + dur / 1e3
    busy = sum(groups.values()) if spans else None
    rec = dict(layers=n, first_call_s=first_s, step_ms=1e3 * step_s, peak_gib=peak / 2**30,
               grad_bytes=grad_bytes, left_after_backward_bytes=left, device_busy_ms=busy,
               device_ms_by_group={k: round(v, 3) for k, v in groups.items()},
               regions=len(regions), structures=structures, regions_compiled=compiles,
               compile_s=compile_s, cache=dict(zip(("hits", "misses"), hits)),
               launches_per_call=want, loss=loss.item())
    say(f"phase 18 (a) jit(LlamaModule) {cfg.name} {n} layers, bf16, B=1, T={JIT_T} ({CARD}): "
        f"first call (trace, claim, compile) {first_s:.1f} s with {compiles} of {structures} "
        f"region structures compiled in {compile_s:.1f} s (the rest met before in this run); "
        f"step (forward + loss.backward(), a cache hit) {1e3 * step_s:.1f} ms beside phase 10's "
        f"traced step {PHASE10_STEP_MS or 'not run'} ms (no bar); peak {peak / 2**30:.2f} GiB; "
        f"device busy {busy} ms by group {rec['device_ms_by_group']}; after backward "
        f"memory_allocated is the pre-call level + {grad_bytes} B of grads + {left} B (slack "
        f"{FRONTEND_MEM_SLACK}); launches per call {got2} (expected {want}); cache hits/misses "
        f"{hits}; loss {loss.item():.6f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 18 (a): second call launches {got2}, {left} B left after "
                             f"backward beyond the grads, cache {hits}")
    del tm, module
    gc.collect()
    torch.cuda.empty_cache()
    return rec, total


def _grad_err(grads, ref) -> float:
    """‖g − ref‖ / ‖ref‖ over every parameter's grad (float64)."""
    num = sum(float(((grads[k].double() - ref[k].double()) ** 2).sum()) for k in ref)
    den = sum(float((ref[k].double() ** 2).sum()) for k in ref)
    return math.sqrt(num / den)


def module_checks(params, cfg) -> tuple[dict, dict]:
    """(a) at FRONTEND_CHECK_LAYERS layers: float32 jitted against the eager
    module (loss within MODULE_LOSS_REL_F32, each grad within
    MODULE_GRAD_REL_F32 of its max); bf16 error against that float32 run at
    most LOWP_ERR_RATIO times the eager bf16 module's (loss and grads);
    then an AdamW step, and the next call a cache hit that sees the new
    weights: bitwise equal to a fresh ``jit`` of the updated module."""
    n = FRONTEND_CHECK_LAYERS
    cfgn = Config.from_name(cfg.name, n_layer=n)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 181)
    idx, tgt, _, _ = jit_batch(cfgn, JIT_T, gen)
    total = {}
    p4 = {**params, "blocks": params["blocks"][:n]}
    m32 = llama_module(_cast(p4, torch.float32), cfgn, JIT_T)
    cudaex.reset_launches()
    lj32, gj32 = _module_run(ttt.jit(m32), m32, idx, tgt)
    _add(total, cudaex.LAUNCHES)
    gj32 = {k: v.clone() for k, v in gj32.items()}
    le32, ge32 = _module_run(m32, m32, idx, tgt)
    rel = abs(lj32.item() - le32.item()) / abs(le32.item())
    gworst = max(float((gj32[k] - ge32[k]).abs().max() / ge32[k].abs().max()) for k in ge32)
    ok32 = rel <= MODULE_LOSS_REL_F32 and gworst <= MODULE_GRAD_REL_F32
    ge32 = {k: v.clone() for k, v in ge32.items()}
    del m32, gj32
    gc.collect()
    torch.cuda.empty_cache()
    m16 = llama_module(p4, cfgn, JIT_T)
    tm16 = ttt.jit(m16)
    cudaex.reset_launches()
    lj16, gj16 = _module_run(tm16, m16, idx, tgt)
    _add(total, cudaex.LAUNCHES)
    gj16 = {k: v.clone() for k, v in gj16.items()}
    le16, ge16 = _module_run(m16, m16, idx, tgt)
    loss_err, eager_loss_err = abs(lj16.item() - le32.item()), abs(le16.item() - le32.item())
    grad_err, eager_grad_err = _grad_err(gj16, ge32), _grad_err(ge16, ge32)
    ok16 = loss_err <= LOWP_ERR_RATIO * eager_loss_err and grad_err <= LOWP_ERR_RATIO * eager_grad_err
    del gj16, ge16, ge32
    # AdamW on the module's parameters, then a cache hit on the new weights
    _module_run(tm16, m16, idx, tgt)
    opt = torch.optim.AdamW(m16.parameters(), lr=1e-3, foreach=False)
    opt.step()
    hits, misses = ttt.cache_hits(tm16), ttt.cache_misses(tm16)
    cudaex.reset_launches()
    after, _ = _module_run(tm16, m16, idx, tgt)
    _add(total, cudaex.LAUNCHES)
    fresh, _ = _module_run(ttt.jit(m16), m16, idx, tgt)
    hit = (ttt.cache_hits(tm16) - hits, ttt.cache_misses(tm16) - misses) == (1, 0)
    okstep = hit and torch.equal(after, fresh) and after.item() != lj16.item()
    rec = dict(f32_loss=lj32.item(), f32_eager_loss=le32.item(), f32_rel=rel,
               f32_worst_grad_rel=gworst, bf16_loss_err=loss_err,
               eager_bf16_loss_err=eager_loss_err, bf16_grad_err=grad_err,
               eager_bf16_grad_err=eager_grad_err, loss_after_adamw=after.item(),
               fresh_jit_loss=fresh.item(), cache_hit=hit)
    say(f"phase 18 (a) at {n} layers ({CARD}): float32 loss {lj32.item():.8f} against eager "
        f"{le32.item():.8f} (rel {rel:.2e}, bar {MODULE_LOSS_REL_F32:.0e}), worst grad "
        f"{gworst:.2e} of its max (bar {MODULE_GRAD_REL_F32:.0e}) {'ok' if ok32 else 'FAIL'}; "
        f"bf16 against the float32 eager run: loss error {loss_err:.3e} (eager bf16 "
        f"{eager_loss_err:.3e}), grads ‖Δ‖/‖g‖ {grad_err:.3e} (eager bf16 {eager_grad_err:.3e}; "
        f"ratio limit {LOWP_ERR_RATIO}) {'ok' if ok16 else 'FAIL'}; after an AdamW step: loss "
        f"{after.item():.6f} (a cache hit: {hit}) = a fresh jit's {fresh.item():.6f}: "
        f"{torch.equal(after, fresh)} {'ok' if okstep else 'FAIL'}")
    if not (ok32 and ok16 and okstep):
        raise AssertionError(f"phase 18 (a) checks at {n} layers: {rec}")
    del m16, tm16, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rec, total


def _region_product_flops(bsym) -> float:
    """2·M·N·K summed over a region's linears and matmuls (the products
    ``FlopCounterMode`` counts)."""
    flops = 0.0
    for c in bsym._call_ctx[bsym.sym.name].trace.bound_symbols:
        if c.sym.name == "torch_linear":
            x, w = c.args[0], c.args[1]
            flops += 2.0 * math.prod(x.shape[:-1]) * x.shape[-1] * w.shape[0]
        elif c.sym.name == "torch_matmul":
            a, b = c.args[0], c.args[1]
            flops += 2.0 * math.prod(a.shape[:-1]) * a.shape[-1] * b.shape[-1]
    return flops


def profile_gpt_loss(params, cfg, batch, want_loss) -> tuple[dict, dict]:
    """(b) phase 12's ``jit(gpt_loss)`` with ``profile=True`` (barriers on):
    the loss bitwise equal to the unprofiled call's, one ``cuda_sdpa``
    record per layer, every record called once a call with time > 0, the
    second call's summed record time within its wall time, each region's
    FLOPs the 2·M·N·K of its linears; the top ten records printed."""
    loss_fn = lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg)     # noqa: E731
    pj = ttt.jit(loss_fn, profile=True)
    cudaex.reset_launches()
    l1 = pj(params, *batch)
    torch.cuda.synchronize()
    report = ttt.profile_stats(pj)
    first = {r.name: r.total_ns for r in report.records}
    t0 = time.perf_counter_ns()
    l2 = pj(params, *batch)
    torch.cuda.synchronize()
    wall = time.perf_counter_ns() - t0
    total = dict(cudaex.LAUNCHES)
    second = sum(r.total_ns - first[r.name] for r in report.records)
    sdpa = [r for r in report.records if r.symbol == SDPA_SYMBOLS[0]]
    calls = {r.calls for r in report.records}
    pre = ttt.last_traces(pj)[-2]
    flop_checks = [(r.name, r.cost()[0], _region_product_flops(pre.bound_symbols[r.index]))
                   for r in report.records if pre.bound_symbols[r.index].sym.is_fusion]
    flops_ok = all(got == want for _, got, want in flop_checks) and any(w for *_, w in flop_checks)
    ok = (torch.equal(l1, want_loss) and torch.equal(l2, want_loss) and len(sdpa) == cfg.n_layer
          and calls == {2} and all(r.min_ns > 0 for r in report.records) and second <= wall
          and flops_ok)
    say(f"phase 18 (b) jit(gpt_loss, profile=True) ({cfg.n_layer} layers; {CARD}): loss bitwise "
        f"equal to the unprofiled call's {torch.equal(l1, want_loss)}, {torch.equal(l2, want_loss)}; "
        f"{len(report)} records, {len(sdpa)} cuda_sdpa, calls per record {calls}; the second "
        f"call's records sum {second / 1e6:.3f} ms within its wall {wall / 1e6:.3f} ms; regions' "
        f"FLOPs = 2·M·N·K of their linears: {flops_ok} ({len(flop_checks)} regions) "
        f"{'ok' if ok else 'FAIL'}; top ten:\n" + report.table(limit=10))
    if not ok:
        raise AssertionError(f"phase 18 (b): {flop_checks[:4]}")
    return dict(records=len(report), sdpa_records=len(sdpa), second_call_records_ms=second / 1e6,
                second_call_wall_ms=wall / 1e6,
                top=[(r, round(report[r]["total_ns"] / 1e6, 3)) for r in
                     sorted(report, key=lambda k: -report[k]["total_ns"])[:10]]), total


def anomaly_gpt_loss(params, cfg, batch, want_loss) -> tuple[dict, dict]:
    """(c) phase 12's ``jit(gpt_loss)`` with ``detect_anomalies=True``: the
    clean call bitwise equal; with a NaN planted in one row of block 0's
    ``wq``, ``AnomalyError`` at the first executed symbol that reads it (the
    symbol the reference names, ``tests/test_torch_port_profiler.py``)."""
    loss_fn = lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg)     # noqa: E731
    w = params["blocks"][0]["attn"]["wq"]
    readers = []

    def pre(info, args, kwargs):
        if not readers and any(isinstance(a, torch.Tensor) and a.data_ptr() == w.data_ptr()
                               and a.shape == w.shape for a in args):
            readers.append(info.name)

    dj = ttt.jit(loss_fn, detect_anomalies=True, debug_hooks={"pre": pre})
    cudaex.reset_launches()
    clean = dj(params, *batch)
    torch.cuda.synchronize()
    total = dict(cudaex.LAUNCHES)
    row = w[3].clone()
    w[3] = float("nan")
    try:
        dj(params, *batch)
    except ttt.AnomalyError as e:
        err = e
    else:
        err = None
    finally:
        w[3] = row
    torch.cuda.synchronize()
    ok = torch.equal(clean, want_loss) and err is not None and readers and err.symbol == readers[0]
    say(f"phase 18 (c) jit(gpt_loss, detect_anomalies=True) ({CARD}): clean loss bitwise equal "
        f"{torch.equal(clean, want_loss)}; NaN in wq[3] of block 0: AnomalyError at "
        f"{getattr(err, 'symbol', None)!r} ({getattr(err, 'nan_count', None)} NaN), the first "
        f"reader of wq {readers[:1]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 18 (c): {err!r}")
    return dict(symbol=err.symbol, nan_count=err.nan_count, kind=err.kind), total


def _hf_gpt2_state_dict(hf, gen) -> dict:
    """An HF ``GPT2LMHeadModel`` state dict at ``hf``'s widths, float32 on
    the card, from ``gen`` (std 0.02, norms around 1)."""
    C, V, P, L = hf.n_embd, hf.vocab_size, hf.n_positions, hf.n_layer

    def rnd(*shape, mean=0.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * 0.02 + mean

    sd = {"transformer.wte.weight": rnd(V, C), "transformer.wpe.weight": rnd(P, C),
          "transformer.ln_f.weight": rnd(C, mean=1.0), "transformer.ln_f.bias": rnd(C)}
    for i in range(L):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": rnd(C, mean=1.0), p + "ln_1.bias": rnd(C),
                   p + "attn.c_attn.weight": rnd(C, 3 * C), p + "attn.c_attn.bias": rnd(3 * C),
                   p + "attn.c_proj.weight": rnd(C, C), p + "attn.c_proj.bias": rnd(C),
                   p + "ln_2.weight": rnd(C, mean=1.0), p + "ln_2.bias": rnd(C),
                   p + "mlp.c_fc.weight": rnd(C, 4 * C), p + "mlp.c_fc.bias": rnd(4 * C),
                   p + "mlp.c_proj.weight": rnd(4 * C, C), p + "mlp.c_proj.bias": rnd(C)})
    return sd


def _gpt2_by_hand(sd, hf, dtype) -> dict:
    """The same values laid out in the params' layout by hand: Conv1D
    weights transposed, ``c_attn`` split into q/k/v."""
    C = hf.n_embd

    def t(name):
        return sd["transformer." + name].to(dtype)

    blocks = []
    for i in range(hf.n_layer):
        p = f"h.{i}."
        ca, cb = sd[f"transformer.{p}attn.c_attn.weight"].T, t(p + "attn.c_attn.bias")
        blocks.append({"norm_1": t(p + "ln_1.weight"), "norm_1_b": t(p + "ln_1.bias"),
                       "attn": {"wq": ca[:C].to(dtype), "wk": ca[C:2 * C].to(dtype),
                                "wv": ca[2 * C:].to(dtype), "bq": cb[:C], "bk": cb[C:2 * C],
                                "bv": cb[2 * C:], "wo": t(p + "attn.c_proj.weight").T,
                                "bo": t(p + "attn.c_proj.bias")},
                       "norm_2": t(p + "ln_2.weight"), "norm_2_b": t(p + "ln_2.bias"),
                       "mlp": {"fc": t(p + "mlp.c_fc.weight").T, "fc_b": t(p + "mlp.c_fc.bias"),
                               "proj": t(p + "mlp.c_proj.weight").T,
                               "proj_b": t(p + "mlp.c_proj.bias")}})
    return {"wte": t("wte.weight"), "wpe": t("wpe.weight"), "ln_f": t("ln_f.weight"),
            "ln_f_b": t("ln_f.bias"), "blocks": blocks}


def _tree_bitwise(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.contiguous().view(torch.int16) if x.dtype == torch.bfloat16 else x,
                        y.contiguous().view(torch.int16) if y.dtype == torch.bfloat16 else y)
        for x, y in zip(la, lb))


def hf_gpt2_serve() -> tuple[dict, dict]:
    """(d) gpt2-124m's HF-layout state dict from a seed, converted by
    ``config_from_hf``/``from_gpt2_state_dict``: bitwise equal to the same
    values laid out by hand (bf16 and float32); served paged at full width
    and depth in bf16 (graphed, measured pass: 12 ``paged_attn_decode`` and
    one write a decode step); float32 greedy tokens paged equal to the
    gather lane's."""
    from thunder_tpu_torch.models.hf_weights import config_from_hf, from_gpt2_state_dict

    sd = _hf_gpt2_state_dict(HF_GPT2, torch.Generator(DEVICE).manual_seed(SEED + 184))
    cfg = config_from_hf(HF_GPT2)
    p16 = from_gpt2_state_dict(sd, cfg, dtype=torch.bfloat16, device=DEVICE)
    p32 = from_gpt2_state_dict(sd, cfg, dtype=torch.float32, device=DEVICE)
    same = (_tree_bitwise(p16, _gpt2_by_hand(sd, HF_GPT2, torch.bfloat16))
            and _tree_bitwise(p32, _gpt2_by_hand(sd, HF_GPT2, torch.float32)))
    del sd
    rng = np.random.default_rng(SEED + 184)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(128, 961, 8)]
    eng = stateful_engine(p16, cfg, num_blocks=512)
    res, wall, launches, steps = stateful_pass("(18 d) HF gpt2-124m", eng, cfg,
                                               lambda e, i: e.run(prompts, max_new_tokens=32))
    check_results(res, 32, cfg.padded_vocab_size)
    del eng
    short = [p[:300] for p in prompts[:3]]
    paged = [r.new_tokens for r in stateful_engine(p32, cfg, num_blocks=256).run(
        short, max_new_tokens=8)]
    gather = [r.new_tokens for r in stateful_engine(p32, cfg, num_blocks=256, attn="gather").run(
        short, max_new_tokens=8)]
    ok = same and paged == gather
    rec = dict(params_bitwise=same, float32_paged_equals_gather=paged == gather,
               decode_iters=steps["iters"], wall_s=wall,
               **serve_stats("phase 18 (d) HF gpt2-124m bf16", res, wall))
    say(f"phase 18 (d) HF gpt2-124m ({cfg.n_layer} layers, vocab {cfg.padded_vocab_size}; "
        f"{CARD}): converted params bitwise equal to the hand layout {same}; served paged: "
        f"{launches['paged_attn_decode']} paged_attn_decode and {launches['paged_token_write']} "
        f"paged_token_write for {steps['iters']} decode steps; float32 greedy tokens paged = "
        f"gather {paged == gather} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 18 (d): {rec}")
    del p16, p32
    return rec, launches


def frontend_phase() -> tuple[dict, dict]:
    """Phase 18: (a) ``jit`` of a ``torch.nn.Module`` at full width, (b)
    ``profile=True``, (c) ``detect_anomalies=True``, (d) an HF state dict
    converted and served.  Returns the phase's records and its launches by
    path."""
    t0 = time.perf_counter()
    params, cfg = make_params()
    launches, rec = {}, {}
    rec["module"], launches["jit(module)"] = compiled_in("phase 18 (a)", module_full_width,
                                                         params, cfg)
    rec["module_checks"], launches["jit(module) checks"] = compiled_in(
        "phase 18 (a) checks", module_checks, params, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    batch = jit_batch(cfg, JIT_T, gen)
    cudaex.reset_launches()
    want = ttt.jit(lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg))(params, *batch)
    torch.cuda.synchronize()
    launches["jit gpt_loss (18 b, c)"] = dict(cudaex.LAUNCHES)
    rec["profile"], got = profile_gpt_loss(params, cfg, batch, want)
    _add(launches["jit gpt_loss (18 b, c)"], got)
    rec["anomaly"], got = anomaly_gpt_loss(params, cfg, batch, want)
    _add(launches["jit gpt_loss (18 b, c)"], got)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec["hf_gpt2"], launches["HF gpt2 serve"] = hf_gpt2_serve()
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(card=CARD, seconds=time.perf_counter() - t0)
    say(f"phase 18 (the front end) took {rec['seconds']:.1f} s")
    return rec, launches


#
# phase 19: the bytecode interpreter, Llama-3-8B's weights captured from
# globals (jit(..., interpretation="bytecode"))
#

BYTECODE_STATE: dict = {}      # the weights and rope tables user_loss reads
BYTECODE_CFG = None            # the config the user-code losses read
LOSS_SCALE = 1.0               # (a): a guarded global scalar, rebound once
PHASE12: dict = {}             # phase 12's bf16 loss and cache-hit dispatch median
BYTECODE_MODULE_LAYERS = 4     # (c): phase 18's LlamaModule at this depth
BYTECODE_EDIT = 0.5            # (a): added to one weight row, then taken back


def _user_rms(x, w, eps):
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(x.dtype)


def _user_body(p, idx, targets, cos, sin, cfg):
    """``models/llama.py gpt_loss`` of a Llama-3 config, written as user code
    (this module's code runs opcode by opcode under the interpreter): the
    same op sequence, ``q[..., :n_elem]`` roped as LitGPT does, one Python
    loop over the layers; scaled by ``LOSS_SCALE`` when it is not 1."""
    x = F.embedding(idx.long(), p["wte"])
    for bp in p["blocks"]:
        n1 = _user_rms(x, bp["norm_1"], cfg.norm_eps)
        B, T, _ = n1.shape
        hs, nh, ng, n_elem = cfg.head_size, cfg.n_head, cfg.n_query_groups, cfg.rope_n_elem
        ap = bp["attn"]
        q = F.linear(n1, ap["wq"]).reshape(B, T, nh, hs).transpose(1, 2)
        k = F.linear(n1, ap["wk"]).reshape(B, T, ng, hs).transpose(1, 2)
        v = F.linear(n1, ap["wv"]).reshape(B, T, ng, hs).transpose(1, 2)
        q = rope(q[..., :n_elem], cos, sin)
        k = rope(k[..., :n_elem], cos, sin)
        y = ltorch.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                sliding_window=cfg.sliding_window)
        x = x + F.linear(y.transpose(1, 2).reshape(B, T, nh * hs), ap["wo"])
        mp = bp["mlp"]
        n2 = _user_rms(x, bp["norm_2"], cfg.norm_eps)
        x = x + F.linear(F.silu(F.linear(n2, mp["fc_1"])) * F.linear(n2, mp["fc_2"]), mp["proj"])
    x = _user_rms(x, p["ln_f"], cfg.norm_eps)
    logits = F.linear(x, p["lm_head"])
    loss = ltorch.cross_entropy(logits.reshape(-1, logits.shape[-1]).to(torch.float32),
                                targets.reshape(-1))
    if LOSS_SCALE != 1.0:
        loss = loss * LOSS_SCALE
    return loss


def user_loss(idx, targets):
    """The loss over weights read from ``BYTECODE_STATE``: none is an argument."""
    s = BYTECODE_STATE
    return _user_body(s["params"], idx, targets, s["cos"], s["sin"], BYTECODE_CFG)


def user_loss_p(params, idx, targets, cos, sin):
    """The same loss with the parameters and rope tables explicit; the
    config still read from a global (under the functional frontend a tensor
    read from a global is a constant of the program, under the bytecode
    frontend an input, so the two programs are equal only without one)."""
    return _user_body(params, idx, targets, cos, sin, BYTECODE_CFG)


def _nz(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _n_constants(traces) -> int:
    return sum(b.sym.name.startswith("TCONST") for t in traces for b in t.bound_symbols)


def bytecode_weights(params, cfg, batch) -> tuple[dict, dict]:
    """(a) ``jit(user_loss, interpretation="bytecode")`` at 32 layers: every
    weight and both rope tables captured (none baked), phase 12's launches
    and loss bitwise, a cache hit, the provenance guards on the card (an
    in-place row edit seen with no retrace, a rebound global one retrace,
    a CPU tensor in the dict a retrace by the device guard)."""
    global LOSS_SCALE
    idx, tgt, cos, sin = batch
    BYTECODE_STATE.update(params=params, cos=cos, sin=sin)
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    total: dict = {}
    want = no_launches_but(flash_fwd=cfg.n_layer, flash_ce=1)
    jfn = ttt.jit(user_loss, interpretation="bytecode")
    clear_events()
    before = dict(inductorex.STATS)
    cudaex.reset_launches()
    t0 = time.perf_counter()
    loss = jfn(idx, tgt)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = dict(cudaex.LAUNCHES)
    _add(total, got)
    host = span_ms()
    interp_s = host["acquisition"] / 1e3
    program_s = (host["dce_cse"] + host["claiming"] + host["codegen"]) / 1e3
    compiles = inductorex.STATS["compiles"] - before["compiles"]
    compile_s = inductorex.STATS["compile_s"] - before["compile_s"]
    entry = ttt.compile_stats(jfn).interpreter_cache[0]
    state = entry.key_meta["state"]
    n_tensors = len(tree_leaves(params)) + 2
    consts = _n_constants(ttt.last_traces(jfn))
    check_claims(ttt.last_traces(jfn)[-1], "phase 19 (a) bytecode", {"cuda_sdpa"})
    prologue = ttt.last_prologue_traces(jfn)[-1].python()
    checks = prologue.count("prims.check_")
    log_len = len(ttt.last_interpreter_log(jfn))
    if PHASE12:
        ref_loss, ref_from = PHASE12["loss"], "phase 12's jit(gpt_loss)"
    else:    # run alone: phase 12's program on the same params and batch
        ref_loss = ttt.jit(lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg))(
            params, *batch).item()
        ref_from = "jit(gpt_loss) in this phase"
    cudaex.reset_launches()
    loss2 = jfn(idx, tgt)
    torch.cuda.synchronize()
    _add(total, cudaex.LAUNCHES)
    cudaex.reset_launches()
    hit = (ttt.cache_hits(jfn), ttt.cache_misses(jfn)) == (1, 1) and torch.equal(loss, loss2)
    ok = (got == want and not any(ltorch.DECLINES.values()) and state is not None
          and state["n_state_tensors"] == n_tensors and consts == 0
          and loss.item() == ref_loss and hit)
    say(f"phase 19 (a) jit(user_loss, interpretation='bytecode') {cfg.name} {cfg.n_layer} layers, "
        f"bf16, B=1, T={JIT_T}, weights from globals (python {sys.version.split()[0]}; {CARD}): "
        f"launches {_nz(got)} (expected {_nz(want)}), declines {_nz(ltorch.DECLINES)}; captured "
        f"tensors "
        f"{state and state['n_state_tensors']} (expected {n_tensors}: every leaf and the rope "
        f"tables), value guards {state and state['n_guards']}, prologue checks {checks}, "
        f"baked constants {consts}; loss {loss.item():.6f} against {ref_from} {ref_loss:.6f}: "
        f"bitwise {loss.item() == ref_loss}; second call a hit, bitwise: {hit} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 19 (a): launches {got}, state {state}, constants {consts}, "
                             f"loss {loss.item()} against {ref_loss}, hit {hit}")
    # the cache hit's dispatch (key, lookup, prologue) and the prologue alone
    cs = ttt.compile_stats(jfn)
    dispatch_ns, prologue_ns = [], []
    for _ in range(JIT_DISPATCH_CALLS):
        jfn(idx, tgt)
        dispatch_ns.append(cs.last_dispatch_ns)
    torch.cuda.synchronize()
    for _ in range(JIT_DISPATCH_CALLS):
        t1 = time.perf_counter_ns()
        entry.prologue_fn(idx, tgt)
        prologue_ns.append(time.perf_counter_ns() - t1)
    # an in-place edit of one weight row, then undone: seen, no retrace
    w = params["blocks"][0]["attn"]["wq"]
    row = w[0].clone()
    misses = ttt.cache_misses(jfn)
    w[0].add_(BYTECODE_EDIT)
    edited = jfn(idx, tgt)
    w[0].copy_(row)
    restored = jfn(idx, tgt)
    torch.cuda.synchronize()
    ok_edit = (ttt.cache_misses(jfn) == misses and edited.item() != loss.item()
               and torch.equal(restored, loss))
    # a rebound global scalar: one retrace, the functional frontend's value
    LOSS_SCALE = 2.0
    scaled = jfn(idx, tgt)
    torch.cuda.synchronize()
    _add(total, cudaex.LAUNCHES)
    retraced = ttt.cache_misses(jfn) - misses
    fscaled = ttt.jit(user_loss_p)(params, idx, tgt, cos, sin)
    LOSS_SCALE = 1.0
    cudaex.reset_launches()
    back = jfn(idx, tgt)
    torch.cuda.synchronize()
    _add(total, cudaex.LAUNCHES)
    ok_rebind = (retraced == 1 and torch.equal(scaled, fscaled)
                 and ttt.cache_misses(jfn) == misses + 1
                 and torch.equal(back, loss))
    # a CPU tensor in the dict: the prologue's device guard fails, a retrace
    # (never a kernel on a CPU pointer); the card's tensor back is a hit
    ap = params["blocks"][0]["attn"]
    wq = ap["wq"]                          # read before the first attention
    ap["wq"] = wq.cpu()
    evictions = cs.guard_evictions
    cudaex.reset_launches()
    try:
        out = jfn(idx, tgt)
        swapped = f"returned {out.item():.6f} on {out.device}"
        ok_swap = out.device.type == "cuda" and torch.equal(out, loss)
    except RuntimeError as e:
        swapped = f"raised {type(e).__name__}: {str(e).splitlines()[0][:200]}"
        ok_swap = "device" in str(e).lower() or "cpu" in str(e).lower()
    torch.cuda.synchronize()
    swap_launches = {k: v for k, v in cudaex.LAUNCHES.items() if v}
    ok_swap = (ok_swap and ttt.cache_misses(jfn) == misses + 2 and cs.guard_evictions > evictions
               and not swap_launches.get("flash_fwd"))
    ap["wq"] = wq
    cudaex.reset_launches()
    again = jfn(idx, tgt)
    torch.cuda.synchronize()
    _add(total, cudaex.LAUNCHES)
    ok_swap = ok_swap and torch.equal(again, loss) and ttt.cache_misses(jfn) == misses + 2
    med = statistics.median(dispatch_ns) / 1e6
    rec = dict(first_call_s=first_s, interpret_s=interp_s, trace_to_program_s=program_s,
               region_compile_s=compile_s, regions_compiled=compiles,
               captured_tensors=state["n_state_tensors"], value_guards=state["n_guards"],
               prologue_checks=checks, interpreter_log=log_len, loss=loss.item(),
               dispatch_ms_median=med, dispatch_ms_min=min(dispatch_ns) / 1e6,
               prologue_ms_median=statistics.median(prologue_ns) / 1e6,
               phase12_dispatch_ms_median=PHASE12.get("dispatch_ms_median"),
               edited_loss=edited.item(), scaled_loss=scaled.item(), swap=swapped,
               python=sys.version.split()[0], card=CARD)
    say(f"phase 19 (a) first call {first_s:.2f} s: interpretation {interp_s:.2f} s, "
        f"trace to program {program_s:.2f} s, {compiles} regions compiled anew in "
        f"{compile_s:.2f} s (expected 0: phase 12's regions), the rest "
        f"{first_s - interp_s - program_s - compile_s:.2f} s; "
        f"{checks} prologue checks, interpreter log {log_len} events; cache-hit dispatch median "
        f"{med:.3f} ms (min {min(dispatch_ns) / 1e6:.3f}), the prologue alone "
        f"{rec['prologue_ms_median']:.3f} ms, beside phase 12's "
        f"{PHASE12.get('dispatch_ms_median', 'not run')} ms (no bar); in-place row edit: loss "
        f"{edited.item():.6f}, undone {restored.item():.6f}, misses unchanged "
        f"{'ok' if ok_edit else 'FAIL'}; LOSS_SCALE=2.0: {retraced} retrace, loss "
        f"{scaled.item():.6f} = the functional frontend's {fscaled.item():.6f}: "
        f"{torch.equal(scaled, fscaled)} {'ok' if ok_rebind else 'FAIL'}; a CPU wq: "
        f"{swapped}, misses {misses} -> {ttt.cache_misses(jfn)}, launches {swap_launches}, the "
        f"card's "
        f"tensor back a hit {'ok' if ok_swap else 'FAIL'}")
    if not (ok_edit and ok_rebind and ok_swap):
        raise AssertionError(f"phase 19 (a) provenance checks: edit {ok_edit}, rebind "
                             f"{ok_rebind}, device guard {ok_swap}")
    BYTECODE_STATE.clear()
    del jfn, entry, cs
    return rec, total


def bytecode_training(params, cfg, batch) -> tuple[dict, dict]:
    """(b) ``value_and_grad(user_loss_p, interpretation="bytecode")`` at 32
    layers, the config read from a global: the loss and every grad bitwise
    the functional frontend's ``value_and_grad`` of the same function; the
    launches its programs name (per layer ``flash_bwd_dq``/``_dkv`` once,
    ``flash_fwd`` per forward and recomputed SDPA), one ``flash_ce``, no
    declines."""
    for key in ltorch.DECLINES:
        ltorch.DECLINES[key] = 0
    before = dict(inductorex.STATS)
    vg = ttt.value_and_grad(user_loss_p, interpretation="bytecode")
    cudaex.reset_launches()
    t0 = time.perf_counter()
    lb, gb = vg(params, *batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    got = dict(cudaex.LAUNCHES)
    fw, bw = ttt.last_traces(vg)[-1], ttt.last_backward_traces(vg)[-2]
    check_claims(fw, "phase 19 (b) forward", {"cuda_sdpa"})
    check_claims(bw, "phase 19 (b) backward", {"cuda_sdpa_backward"} | (
        {"cuda_sdpa"} if _count(bw, "cuda_sdpa") else set()))
    n_sdpa = _count(fw, "cuda_sdpa") + _count(bw, "cuda_sdpa")
    n_bwd = _count(bw, "cuda_sdpa_backward")
    n_ce = _count(fw, "torch_cross_entropy_fwd") + _count(bw, "torch_cross_entropy_fwd")
    want = no_launches_but(flash_fwd=n_sdpa, flash_bwd_dq=n_bwd, flash_bwd_dkv=n_bwd,
                           flash_ce=n_ce)
    state = ttt.compile_stats(vg).interpreter_cache[0].key_meta["state"]
    consts = _n_constants(ttt.last_traces(vg))
    fvg = ttt.value_and_grad(user_loss_p)
    lf, gf = fvg(params, *batch)
    torch.cuda.synchronize()
    compiles = inductorex.STATS["compiles"] - before["compiles"]
    leaves_b, leaves_f = tree_leaves(gb), tree_leaves(gf)
    same = torch.equal(lb, lf) and len(leaves_b) == len(leaves_f) == len(tree_leaves(params)) \
        and all(torch.equal(a, b) for a, b in zip(leaves_b, leaves_f))
    ok = (got == want and n_bwd == cfg.n_layer and n_ce == 1 and same and consts == 0
          and not any(ltorch.DECLINES.values()) and math.isfinite(lb.item()))
    rec = dict(layers=cfg.n_layer, first_call_s=first_s, regions_compiled=compiles,
               launches_per_call=got, loss=lb.item(), bitwise=same,
               value_guards=state and state["n_guards"])
    say(f"phase 19 (b) value_and_grad(user_loss_p, interpretation='bytecode') {cfg.name} "
        f"{cfg.n_layer} layers, bf16, B=1, T={JIT_T} ({CARD}): first call {first_s:.2f} s; "
        f"SDPA {n_sdpa}, SDPA backward {n_bwd}, CE {n_ce}; launches {_nz(got)} (expected "
        f"{_nz(want)}), declines {_nz(ltorch.DECLINES)}; value guards {rec['value_guards']} "
        f"(the config), baked constants {consts}; loss {lb.item():.6f} and {len(leaves_b)} grads "
        f"bitwise the functional frontend's: {same}; {compiles} regions compiled in the two "
        f"builds {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 19 (b): launches {got} != {want}, bitwise {same}, "
                             f"constants {consts}, declines {ltorch.DECLINES}")
    del vg, fvg, gb, gf, leaves_b, leaves_f
    return rec, got


def bytecode_module(params, cfg, batch) -> tuple[dict, dict]:
    """(c) phase 18's ``LlamaModule`` at BYTECODE_MODULE_LAYERS layers under
    ``jit(module, interpretation="bytecode")``: loss and every grad bitwise
    ``jit(module)``'s; the launches its programs name."""
    n = BYTECODE_MODULE_LAYERS
    cfgn = Config.from_name(cfg.name, n_layer=n)
    module = llama_module({**params, "blocks": params["blocks"][:n]}, cfgn, JIT_T)
    idx, tgt = batch[0], batch[1]
    lf, gf = _module_run(ttt.jit(module), module, idx, tgt)
    gf = {k: v.clone() for k, v in gf.items()}
    tm = ttt.jit(module, interpretation="bytecode")
    cudaex.reset_launches()
    lb, gb = _module_run(tm, module, idx, tgt)
    torch.cuda.synchronize()
    got = dict(cudaex.LAUNCHES)
    want = _program_launches(tm, n, f"phase 19 (c) jit(LlamaModule, bytecode) {n} layers")
    same = torch.equal(lb, lf) and gf.keys() == gb.keys() and all(
        torch.equal(gb[k], gf[k]) for k in gf)
    log_len = len(ttt.last_interpreter_log(tm))
    ok = got == want and same and log_len > 0
    say(f"phase 19 (c) jit(LlamaModule, interpretation='bytecode') {n} layers ({CARD}): "
        f"launches {_nz(got)} (expected {_nz(want)}); loss {lb.item():.6f} and {len(gb)} grads "
        f"bitwise "
        f"jit(module)'s: {same}; interpreter log {log_len} events {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase 19 (c): launches {got} != {want}, bitwise {same}")
    del module, tm, gf, gb
    return dict(layers=n, loss=lb.item(), bitwise=same, interpreter_log=log_len), got


def bytecode_phase() -> tuple[dict, dict]:
    """Phase 19: the bytecode interpreter on the card, (a)-(c) on the seed-0
    Llama-3-8B params and phase 12's batch.  Returns the phase's records
    and its launches by path."""
    global BYTECODE_CFG
    t0 = time.perf_counter()
    params, cfg = make_params()
    BYTECODE_CFG = cfg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    batch = jit_batch(cfg, JIT_T, gen)
    rec, launches = {}, {}
    rec["weights"], launches["bytecode jit (19 a)"] = compiled_in(
        "phase 19 (a)", bytecode_weights, params, cfg, batch)
    gc.collect()
    torch.cuda.empty_cache()
    rec["training"], launches["bytecode value_and_grad (19 b)"] = compiled_in(
        "phase 19 (b)", bytecode_training, params, cfg, batch)
    gc.collect()
    torch.cuda.empty_cache()
    rec["module"], launches["bytecode module (19 c)"] = compiled_in(
        "phase 19 (c)", bytecode_module, params, cfg, batch)
    del params, batch
    BYTECODE_CFG = None
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(card=CARD, seconds=time.perf_counter() - t0)
    say(f"phase 19 (the bytecode interpreter) took {rec['seconds']:.1f} s")
    return rec, launches


def bytecode_alone() -> int:
    """``--bytecode``: the build and phase 19 alone (phase 12's loss computed
    in the phase), for iterating on the interpreter's path."""
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: --bytecode needs an NVIDIA GPU", file=sys.stderr)
        return 1
    CARD = card_line()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    rec, launches = bytecode_phase()
    say("bytecode phase: " + json.dumps(rec))
    say("bytecode launches: " + json.dumps(launches))
    return 0


#
# Phase 20: data-parallel and sharded training over torch.distributed
#

DIST_STEPS = 3              # (a): steps of each sharded step, held against phase 10's first 3
DIST_BUCKET_MB = 25.0       # (a): the DDP step's gradient buckets (torch DDP's default cap)
DIST_TIMEOUT_S = 120        # every collective fails after this long
DIST_CKPT_LAYERS = 2        # (c): the checkpoint's depth, at full width
DIST_CLI_TIMEOUT_S = 600    # (b): the CLI's subprocess is killed after this long
PHASE10_REF: dict = {}      # phase 10's first DIST_STEPS losses and digests, for (a)


def param_digest(tree) -> list:
    """Per-tensor digests that see every bit: the int64 sums of each
    tensor's raw 16- or 32-bit words and of the words times their position
    (mod 65521, plus 1), in chunks of 2^26 words."""
    from torch.distributed.tensor import DTensor

    out = []
    for x in tree_leaves(tree):
        x = x.to_local() if isinstance(x, DTensor) else x
        words = x.detach().reshape(-1).view(torch.int16 if x.element_size() == 2 else torch.int32)
        plain = weighted = 0
        for off in range(0, words.numel(), 1 << 26):
            w = words[off:off + (1 << 26)].long()
            pos = (torch.arange(off, off + w.numel(), device=w.device) % 65521) + 1
            plain += int(w.sum())
            weighted += int((w * pos).sum())
        out.append((plain, weighted))
    return out


def _dist_init():
    """A one-rank NCCL world on card 0 (every collective a copy), its store
    under ``build/``; collectives time out after DIST_TIMEOUT_S."""
    import datetime
    import os
    import tempfile

    import torch.distributed as dist

    os.makedirs("build", exist_ok=True)
    store = os.path.join(tempfile.mkdtemp(prefix="phase20_", dir="build"), "store")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{os.path.abspath(store)}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return os.path.dirname(store)


def _dist_cli(workdir: str):
    """(b): ``train_cli --mode zero3 --devices 1 --telemetry`` in a
    subprocess on the card, started after (a) so that its tiny config's
    region compiles run beside (c)."""
    import os

    tel = os.path.join(workdir, "cli_steps.jsonl")
    argv = [sys.executable, "-m", "thunder_tpu_torch.train_cli", "--config", "tiny-llama-debug",
            "--mode", "zero3", "--devices", "1", "--device", "cuda", "--steps", "3", "--batch",
            "2", "--seq", "128", "--telemetry", tel, "--telemetry-grad-norm"]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, tel, argv


def _dist_cli_check(proc, tel, argv) -> dict:
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=DIST_CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"phase 20 (b): {' '.join(argv[1:])} outlived "
                             f"{DIST_CLI_TIMEOUT_S} s")
    if proc.returncode != 0:
        raise AssertionError(f"phase 20 (b): the CLI exited {proc.returncode}:\n{err[-4000:]}")
    summary = json.loads(out.strip().splitlines()[-1])
    with open(tel) as f:
        recs = [json.loads(line) for line in f]
    losses = summary["losses"]
    steps = [r for r in recs if r["event"] == "step"]
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and len(steps) == 3 and all(r["grad_norm"] > 0 for r in steps))
    say(f"phase 20 (b) {' '.join(argv[2:])} ({CARD}): exit 0, losses {losses}, "
        f"{summary['ms_per_step']} ms a step, collectives per step {summary['collectives']}, "
        f"{len(steps)} telemetry step records (grad norms "
        f"{[round(r['grad_norm'], 4) for r in steps]}); waited {time.perf_counter() - t0:.1f} s "
        f"for it after (c) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"phase 20 (b): losses {losses} not finite and falling, or the "
                             f"telemetry {recs} short")
    return dict(losses=losses, ms_per_step=summary["ms_per_step"],
                collectives=summary["collectives"])


def _dist_prims() -> dict:
    """(a0): each collective prim through ``jit`` on a card tensor over the
    one-rank NCCL group (the torch.distributed calls the step issues, by
    the names this torch has): every result bitwise its input, as one rank's
    collectives are copies.  The mean reduce-scatter, the tiled gathers on
    dims 0 and 1 and the asynchronous all-reduce with its wait included; a
    bf16 (1024, 4096) tensor and a float32 one."""
    import thunder_tpu_torch as ttt
    from thunder_tpu_torch import distributed as D
    from thunder_tpu_torch.distributed import prims as dp

    SUM, MEAN = dp.DistributedReduceOps.SUM, dp.DistributedReduceOps.MEAN
    cases = {
        "all_gather": lambda x: dp.all_gather(x, "x", 1, 0, True),
        "all_gather_dim1": lambda x: dp.all_gather(x, "x", 1, 1, True),
        "all_gather_untiled": lambda x: dp.all_gather(x, "x", 1, 0, False)[0],
        "all_reduce_sum": lambda x: dp.all_reduce(x, "x", SUM),
        "all_reduce_mean": lambda x: dp.all_reduce(x, "x", MEAN),
        "all_reduce_async": lambda x: dp.wait(dp.all_reduce((x, x), "x", SUM, async_op=True))[1],
        "reduce_scatter_mean": lambda x: dp.reduce_scatter(x, "x", 1, 0, MEAN),
        "broadcast": lambda x: dp.broadcast(x, "x", 0),
        "ppermute": lambda x: dp.ppermute(x, "x", [[0, 0]]),
        "all_to_all": lambda x: dp.all_to_all(x, "x", 1, 0, 1),
        "synchronize_sharded": lambda x: dp.synchronize(x, "x", 1, True, 0),
    }
    mesh = D.make_mesh({"x": 1})
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    before = dict(dp.COLLECTIVES)
    bad = []
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(1024, 4096, generator=gen, device=DEVICE).to(dtype)
        with cudaex.mesh_context(mesh):
            for name, fn in cases.items():
                got = ttt.jit(fn)(x)
                if not (got.device == x.device and torch.equal(got, x)):
                    bad.append(f"{name} {dtype}")
    torch.cuda.synchronize()
    issued = {k: dp.COLLECTIVES[k] - before[k] for k in dp.COLLECTIVES}
    say(f"phase 20 (a0) the dist prims through jit over one NCCL rank ({CARD}): "
        f"{len(cases)} cases x bf16 and float32 (1024, 4096), collectives issued {issued}; "
        f"results bitwise their inputs: {not bad} {'ok' if not bad else 'FAILED ' + str(bad)}")
    if bad:
        raise AssertionError(f"phase 20 (a0): {bad} not bitwise their inputs")
    return dict(cases=len(cases), collectives=issued)


def _dist_reference(cfg) -> dict:
    """Phase 10's traced step, built anew and run DIST_STEPS steps from the
    seed-0 params on phase 10's batch just before (a): the sharded steps'
    bitwise reference (its regions are phase 10's, compiled; it is printed
    beside phase 10's own first steps)."""
    params, _ = make_params()
    step = make_step(cfg)
    opt_state = step.init_optimizer_state(params)
    batch = train_batch(cfg, SEED + 10)
    ref = {"initial": param_digest(params)}

    def keep(i, p):
        if i == DIST_STEPS - 1:
            ref["digest"] = param_digest(p)

    params, opt_state, losses, times, peak, launches, _ = _run_steps(
        step, params, opt_state, batch, DIST_STEPS, after=keep)
    ref.update(losses=losses, step_ms=1e3 * float(np.mean(times[1:])), peak_gib=peak / 2**30,
               build_ms=step.build_ms, launches=launches)
    p10 = PHASE10_REF
    same = {k: ref[k] == p10.get(k) for k in ("initial", "losses", "digest")}
    say(f"phase 20 (a) reference: phase 10's traced step anew, {DIST_STEPS} steps from the seed-0 "
        f"params ({CARD}): losses {losses}; against phase 10's own first {DIST_STEPS} steps "
        f"{p10.get('losses')}: start, losses and digest equal {same}; step {ref['step_ms']:.1f} "
        f"ms, max_memory_allocated {ref['peak_gib']:.2f} GiB")
    ref["phase10_equal"] = same
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _dist_steps(label, cfg, place, axes, ref, **kw) -> dict:
    """(a): one sharded step of Llama-3-8B at full width and depth over a
    one-rank ``axes`` mesh, DIST_STEPS steps from the seed-0 params on
    phase 10's batch, held against ``ref`` (phase 10's traced step, run
    anew in this phase): losses and the params' digest bitwise, launches
    read from the programs, dispatches sharded, collectives per step as the
    placements and buckets say."""
    from thunder_tpu_torch import distributed as D
    from thunder_tpu_torch.distributed import prims as dp
    from thunder_tpu_torch.train.overlap import expected_all_reduces

    full, _ = make_params()
    mesh = D.make_mesh(axes)
    params = place(full, mesh)
    del full
    initial = param_digest(params)
    step = make_train_step(lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg), adamw(TRAIN_LR),
                           mesh, remat="full_block", **kw)
    opt_state = step.init_optimizer_state(params)
    batch = train_batch(cfg, SEED + 10)
    per_step = []

    def keep(i, p):
        per_step.append(dict(step.collectives))

    before = dict(inductorex.STATS)
    d0 = dict(cudaex.DISPATCH)
    params, opt_state, losses, times, peak, launches, declines = _run_steps(
        step, params, opt_state, batch, DIST_STEPS, after=keep)
    sharded = cudaex.DISPATCH["sharded"] - d0["sharded"]
    digest = param_digest(params)
    L = cfg.n_layer
    want = step_launches_want(step, DIST_STEPS, L, f"phase 20 (a) {label}")
    # one more step, profiled by kernel group (after the digest)
    profile = profile_train_step(step, params, opt_state, batch, f"phase 20 (a) {label}")
    syms = _symbols(step)
    per_call = syms.get("cuda_sdpa", 0) + syms.get("cuda_sdpa_backward", 0) + \
        syms.get("torch_cross_entropy_fwd", 0)
    leaves = tree_leaves(params)
    n_sharded = sum(any(not pl.is_replicate() for pl in x.placements) for x in leaves)
    n_repl = len(leaves) - n_sharded
    regathers = sum(b.sym.name == "torch_synchronize" for b in step.bw_trace.bound_symbols)
    if step.overlap_report is not None:
        buckets = step.overlap_report["n_buckets"]
        coll_want = dict(all_reduce=expected_all_reduces([None] * buckets), all_gather=0,
                         reduce_scatter=0)
    else:
        coll_want = dict(all_reduce=n_repl + 1, all_gather=n_sharded + regathers,
                         reduce_scatter=n_sharded)
    coll_ok = all(all(c[k] == v for k, v in coll_want.items()) for c in per_step)
    same_start = ref["initial"] == initial
    bitwise = same_start and losses == ref["losses"] and digest == ref["digest"]
    step_s = float(np.mean(times[1:]))
    ok = (launches == want and not any(declines.values()) and coll_ok and bitwise
          and sharded == per_call * DIST_STEPS)
    say(f"phase 20 (a) {label} Llama-3-8B bf16 {L} layers, B={TRAIN_B} T={TRAIN_T}, full_block, "
        f"mesh {axes} over NCCL, one rank ({CARD}): losses {losses} against phase 10's step "
        f"anew {ref['losses']}; params' digest after {DIST_STEPS} steps equal to its: "
        f"{digest == ref['digest']} (same start: {same_start}); launches {launches} "
        f"(expected {want}), declines {declines}; kernel dispatches counted sharded {sharded} "
        f"(expected {per_call} x {DIST_STEPS}); collectives per step {per_step} (expected "
        f"{coll_want}: {n_sharded} sharded and {n_repl} replicated params"
        f"{'' if step.overlap_report is None else ', ' + str(step.overlap_report['n_buckets'])}"
        f"{' buckets of at most ' + str(DIST_BUCKET_MB) + ' MiB' if step.overlap_report else ''})"
        f"; step time (steps 2-{DIST_STEPS}) {1e3 * step_s:.1f} ms beside phase 10's "
        f"{PHASE10_REF.get('step_ms', float('nan')):.1f} ms (anew {ref['step_ms']:.1f}); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB beside "
        f"{PHASE10_REF.get('peak_gib', float('nan')):.2f} GiB; build {step.build_ms:.0f} ms of "
        f"host beside {PHASE10_REF.get('build_ms', float('nan')):.0f}; "
        f"{inductorex.STATS['compiles'] - before['compiles']} regions compiled in "
        f"{inductorex.STATS['compile_s'] - before['compile_s']:.1f} s (no bars) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"phase 20 (a) {label}: launches {launches} != {want}, declines "
                             f"{declines}, collectives {per_step} != {coll_want}, dispatches "
                             f"{sharded}, or not bitwise phase 10's step anew (same start "
                             f"{same_start}, losses {losses} vs {ref['losses']})")
    build_ms = step.build_ms
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, launches=launches, collectives=per_step, step_ms=1e3 * step_s,
                peak_gib=peak / 2**30, build_ms=build_ms, bitwise=bitwise, profile=profile)


def _dist_checkpoint(cfg_full, workdir: str) -> dict:
    """(c): ZeRO-3 at DIST_CKPT_LAYERS layers, full width: one step, a
    sharded save, a load into fresh DTensors (bitwise), then the resumed
    and the continued runs' next step (loss and params bitwise)."""
    import os
    import shutil

    from thunder_tpu_torch import distributed as D

    cfg = Config.from_name(cfg_full.name, n_layer=DIST_CKPT_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    full = init_params(cfg, generator=gen, dtype=torch.bfloat16, device=DEVICE)
    mesh = D.make_mesh({"fsdp": 1})
    step = make_train_step(lambda p, i, t, c, s: gpt_loss(p, i, t, c, s, cfg), adamw(TRAIN_LR),
                           mesh, zero3=True)
    batch = train_batch(cfg, SEED + 10)
    params = D.fsdp(full, mesh)
    opt = step.init_optimizer_state(params)
    params, opt, _ = step(params, opt, *batch)
    where = os.path.join(workdir, "ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    D.save_checkpoint(where, {"params": params, "opt_state": opt}, step=1)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(where) for f in fs)
    tmpl_p = D.fsdp(full, mesh)
    tmpl = {"params": tmpl_p, "opt_state": step.init_optimizer_state(tmpl_p)}
    t0 = time.perf_counter()
    got = D.load_checkpoint(where, tmpl, step=1)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    live = {"params": params, "opt_state": opt}
    loaded_equal = all(torch.equal(a.to_local(), b.to_local())
                       for a, b in zip(tree_leaves(got), tree_leaves(live)))
    r_params, _, r_loss = step(got["params"], got["opt_state"], *batch)
    c_params, _, c_loss = step(params, opt, *batch)
    resumed_equal = torch.equal(r_loss, c_loss) and all(
        torch.equal(a.to_local(), b.to_local())
        for a, b in zip(tree_leaves(r_params), tree_leaves(c_params)))
    usage = shutil.disk_usage(workdir)
    ok = loaded_equal and resumed_equal
    say(f"phase 20 (c) checkpoint of Llama-3-8B at {DIST_CKPT_LAYERS} layers, full width, ZeRO-3 "
        f"on one rank ({CARD}): {nbytes} bytes saved in {save_s:.2f} s, loaded into fresh "
        f"DTensors in {load_s:.2f} s (bitwise: {loaded_equal}); the resumed step's loss "
        f"{float(r_loss):.6f} and params bitwise the continued step's: {resumed_equal}; disk "
        f"free after the save {usage.free / 2**30:.1f} GiB {'ok' if ok else 'FAILED'}")
    shutil.rmtree(where, ignore_errors=True)
    if not ok:
        raise AssertionError("phase 20 (c): the checkpoint did not round-trip bitwise")
    return dict(bytes=nbytes, save_s=save_s, load_s=load_s)


def dist_phase(cfg) -> tuple[dict, dict]:
    """Phase 20: data-parallel and sharded training through
    ``torch.distributed`` on a one-rank NCCL world (one card): (a) a DDP
    step with bucketed asynchronous all-reduces and a ZeRO-3 FSDP step, each
    held bitwise against phase 10's traced step; (b) the CLI's ``zero3``
    mode in a subprocess; (c) a sharded checkpoint's round trip.  Returns
    the record and the launches of (a)'s main-path runs."""
    import shutil

    import torch.distributed as dist

    from thunder_tpu_torch import distributed as D

    t0 = time.perf_counter()
    workdir = _dist_init()
    cli = None
    try:
        rec, launches = {"prims": _dist_prims()}, {}
        ref = compiled_in("phase 20 (a) reference", _dist_reference, cfg)
        rec["reference"] = {k: ref[k] for k in ("losses", "step_ms", "peak_gib", "phase10_equal")}
        for label, place, axes, kw in (
                ("ddp", D.ddp, {"dp": 1}, dict(overlap=True, overlap_bucket_mb=DIST_BUCKET_MB)),
                ("fsdp zero3", D.fsdp, {"fsdp": 1}, dict(zero3=True))):
            r = compiled_in(f"phase 20 (a) {label}", functools.partial(_dist_steps, **kw), label,
                            cfg, place, axes, ref)
            launches[f"{label} train step"] = r.pop("launches")
            rec[label] = r
        # (b) beside (c): the subprocess's card memory (its context, its
        # compile workers') must not meet (a)'s 65 GiB peak
        cli = _dist_cli(workdir)
        rec["checkpoint"] = _dist_checkpoint(cfg, workdir)
        rec["cli"] = _dist_cli_check(*cli)
        cli = None
    finally:
        if cli is not None and cli[0].poll() is None:
            cli[0].kill()
            cli[0].communicate()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(workdir, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t0
    say(f"phase 20 (data-parallel and sharded training) took {rec['seconds']:.1f} s")
    return rec, launches


def dist_alone() -> int:
    """``--dist``: the build, phase 10 (phase 20's reference) and phase 20
    alone, for iterating on the distributed path."""
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: --dist needs an NVIDIA GPU", file=sys.stderr)
        return 1
    CARD = card_line()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    params, cfg = make_params()
    compiled_in("phase 10", train_full_width, params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec, launches = dist_phase(cfg)
    say("dist phase: " + json.dumps(rec))
    say("dist launches: " + json.dumps(launches))
    return 0


def moe_depth() -> int:
    """How far int8 weight matmuls move the Mixtral-8x7B-like forward with
    random weights, by depth: a 256-token prefill (``forward_with_cache``,
    no kernel of the port) at 1, 2, 4 and 8 layers with bf16 weights, with
    ``quantized=True`` and (to 4 layers, which fit beside the bf16 copy)
    with float32 weights; mean |Δ| / mean |ref| of the logits for each pair
    and the share of (token, layer) routing decisions that differ.  Prints
    one line per depth."""
    if not torch.cuda.is_available():
        print("chip_smoke: --moe-depth needs an NVIDIA GPU", file=sys.stderr)
        return 1
    global CARD
    CARD = card_line()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from thunder_tpu_torch.models import llama as llama_mod
    from thunder_tpu_torch.models.generate import init_cache

    picks = []
    route = llama_mod._route

    def recording_route(router, k, E):
        w = route(router, k, E)
        picks.append(torch.stack(w, -1) > 0)
        return w

    llama_mod._route = recording_route
    rng = np.random.default_rng(SEED + 143)
    idx = torch.as_tensor(rng.integers(0, 32000, 256).astype(np.int32)[None], device=DEVICE)
    try:
        for n_layer in (1, 2, 4, 8):
            params, cfg = mix_params(n_layer)
            cos, sin = build_rope_cache(cfg, 256, device=DEVICE)
            runs = {"bf16": (params, False), "int8": (params, True)}
            if n_layer <= 4:
                runs["f32"] = (_cast(params, torch.float32), False)
            logits, routes = {}, {}
            with torch.no_grad():
                for name, (p, quantized) in runs.items():
                    picks.clear()
                    cache = init_cache(cfg, 1, 256, dtype=p["wte"].dtype, device=DEVICE)
                    logits[name] = forward_with_cache(p, idx, 0, cache, cos, sin, cfg,
                                                      quantized=quantized)[0].float()
                    routes[name] = torch.stack(picks)
            pairs = [("int8", "bf16")] + ([("bf16", "f32"), ("int8", "f32")] if "f32" in runs
                                          else [])
            out = {f"{a} vs {b}": dict(
                rel=((logits[a] - logits[b]).abs().mean() / logits[b].abs().mean()).item(),
                routing_flips=(routes[a] != routes[b]).any(-1).float().mean().item())
                for a, b in pairs}
            say(f"moe depth {n_layer}: {json.dumps(out)}")
            del params, runs, logits, routes
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        llama_mod._route = route
    return 0


def paged_times(label: str) -> int:
    """Device ms per call of ``paged_attn_decode`` (B=8) and
    ``paged_attn_verify`` at the spec and chunk shapes, each on bf16, int8
    and fp8 arenas, from phase 3's inputs: every kernel of the call summed
    (a body's split and combine kernels together), over 20 profiled calls.
    Prints one line ``AB LABEL {...}``.  To compare two checkouts of the
    port on one card, run, in turns (A, B, B, A) in one call,

        PYTHONPATH=<checkout> python3 -P chip_smoke.py --paged-times LABEL

    (``-P`` keeps this script's directory off ``sys.path``, so the package
    and its kernels come from ``<checkout>``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = {"decode": decode_inputs(torch.bfloat16, gen)[0]}
    cases.update({shape: verify_inputs(torch.bfloat16, gen, **dims)[0]
                  for shape, dims in VERIFY_SHAPES.items()})
    times = {}
    for shape, x in cases.items():
        name = "paged_attn_decode" if shape == "decode" else "paged_attn_verify"
        for arena, storage in {"bf16": None, **QUANT}.items():
            xa = x if storage is None else quantize_arenas(x, storage)
            times[f"{shape} {arena}"] = device_ms(
                lambda: getattr(cudaex, name)(**xa, layer=L - 3), name,
                also=("paged_attn_split",))
            del xa
        torch.cuda.empty_cache()
    print("AB", label, json.dumps(times), flush=True)
    return 0


def device_ms_all(fn, iters: int = 20, tries: int = 3):
    """Device ms per call of every CUDA kernel ``fn`` launches (staging
    copies included) and kernels per call, over ``iters`` profiled calls; a
    profile that records nothing is taken again.  (None, None) when none
    records anything."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return sum(spans) / iters / 1e3, len(spans) / iters
    return None, None


def write_times(label: str) -> int:
    """Device and CUDA-event ms per call of the engine's KV writers at phase
    3's shapes (Llama-3-8B arenas): ``write_fresh_kv`` (a decode step, B=8;
    bf16 and int8 arenas), ``write_fresh_kv_masked`` (a K=4 round, B=8,
    T=5, n_emit N_EMIT_ROUND; bf16 and fp8) and ``write_fresh_kv_chunk``
    (one 512-token piece at pos 2560 through the 192-entry table; bf16 and
    int8).  Device: every kernel a call launches summed, staging copies
    included, over 20 profiled calls; CUDA-event: the median of three
    rounds of 100 calls, all taken before the first profile.  Prints one
    line ``AB LABEL {...}``.  The writers' signatures have not changed
    since the port gained quantized KV, so two checkouts compare in one
    call, in turns (A, B, B, A), as ``--paged-times`` does:

        PYTHONPATH=<checkout> python3 -P chip_smoke.py --write-times LABEL"""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from thunder_tpu_torch.serving.paged_attention import (
        write_fresh_kv,
        write_fresh_kv_chunk,
        write_fresh_kv_masked,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x, _ = decode_inputs(torch.bfloat16, gen)
    step_tables, step_pos = x["tables"], x["pos"]
    pools = {"bf16": ({"k": x.pop("k_arena"), "v": x.pop("v_arena")}, None)}
    del x
    for kind, storage in QUANT.items():
        arenas = {}
        for name in ("k", "v"):
            arenas[name], arenas[name + "_scale"] = quantize_kv(pools["bf16"][0][name], storage)
        pools[kind] = (arenas, storage)
    x, _ = verify_inputs(torch.bfloat16, gen, **VERIFY_SHAPES["spec"])
    round_tables, round_pos = x["tables"], x["pos"]
    del x
    n_emit = torch.tensor(N_EMIT_ROUND, dtype=torch.int32, device=DEVICE)
    nc, nbb = VERIFY_SHAPES["chunk"]["T"] // BS, VERIFY_SHAPES["chunk"]["nbb"]
    rng = np.random.default_rng(SEED + 3)
    leased = [int(b) for b in rng.permutation(np.arange(1, NUM_BLOCKS))[:nbb - 8]]
    _, dest = chunk_tables(leased, CHUNK_POS, nc * BS, nbb, BS)
    dest = torch.as_tensor(dest, device=DEVICE)
    chunk_pos = torch.tensor([CHUNK_POS], dtype=torch.int32, device=DEVICE)

    def fresh(shape):
        return {n: torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
                for n in ("k", "v")}

    step, rnd, chunk = fresh((B, L, NG, HS)), fresh((B, L, NG, 5, HS)), fresh((1, L, NG, nc * BS,
                                                                                 HS))
    cases = {}
    for kind in ("bf16", "int8"):
        arenas, storage = pools[kind]
        cases[f"write_fresh_kv {kind}"] = functools.partial(
            write_fresh_kv, arenas, step, step_tables, step_pos, block_size=BS, kv_dtype=storage)
        cases[f"write_fresh_kv_chunk {kind}"] = functools.partial(
            write_fresh_kv_chunk, arenas, chunk, dest, chunk_pos, block_size=BS,
            kv_dtype=storage)
    for kind in ("bf16", "fp8"):
        arenas, storage = pools[kind]
        cases[f"write_fresh_kv_masked {kind}"] = functools.partial(
            write_fresh_kv_masked, arenas, rnd, round_tables, round_pos, n_emit, block_size=BS,
            kv_dtype=storage)
    times = {name: {"event_rounds_ms": [time_ms(fn, iters=100) for _ in range(3)]}
             for name, fn in cases.items()}
    for name, fn in cases.items():
        rec = times[name]
        rec["event_ms"] = statistics.median(rec["event_rounds_ms"])
        rec["device_ms"], rec["kernels_per_call"] = device_ms_all(fn)
    print(CARD or card_line(), flush=True)
    print("AB", label, json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--paged-times"]:
        sys.exit(paged_times(sys.argv[2] if len(sys.argv) > 2 else "tree"))
    if sys.argv[1:2] == ["--write-times"]:
        sys.exit(write_times(sys.argv[2] if len(sys.argv) > 2 else "tree"))
    if sys.argv[1:2] == ["--moe-depth"]:
        sys.exit(moe_depth())
    if sys.argv[1:2] == ["--bytecode"]:
        sys.exit(bytecode_alone())
    if sys.argv[1:2] == ["--dist"]:
        sys.exit(dist_alone())
    sys.exit(main())
