#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out PATH]

Phases, each fatal on failure:

1. device — the card's name, the device count, and nvidia-smi's name and
   power limit;
2. build — compile the ten paper graphs (``repro_torch.graphs``) under the
   reference's spec (``ref_options``: ``TPU_V5E`` and 4 MiB, what every
   phase that holds a plan against the reference's counts compiles with)
   and under the default ``StitchOptions``, whose compile for the card
   plans with ``H100``: every plan's generated ``.cu`` is built with nvcc
   (one process per source, all started together) into
   ``build/repro_torch/``, then each graph is compiled for ``"cuda"``
   under both;
3. main path — one call of every compiled graph on seeded feeds under each
   spec, through the eager step loop (``jit_replay=False``, so each launch
   goes through its wrapper), with every kernel's launch counter set to 0
   just before and read just after: each graph must launch exactly its
   planned fused kernels (``REFERENCE_KERNELS``, 35, in all under
   ``TPU_V5E``) and every unique kernel at least once;
4. right — each graph's outputs under both specs against the port's
   ``reference_execute`` on the card (one torch op per instruction), and
   every unique kernel against its plain version on the card, on the
   inputs the main path gave it; no H100 plan may keep an ALLOC/SHARE slot
   in the workspace (``launch_shapes``).
   Then the stitched compiles beside the main path (``STITCHED_COMPILES``):
   StitchPipe under ``stitch_max_blocks`` 1 and 4 and ``max_blocks`` 8 and
   64 (phase 0 in 1, 4, 8 and 16 plan blocks; at 1 its slots outgrow shared
   memory and live in the workspace) and the (32, 48) break module of
   ``tests/test_stitching.py``, built with the port's own ``trace``, phases
   of 2 and 1 plan blocks.  Each takes one launch and is held against its
   plain version at ``TOL``.  Then the compiles in the dtypes the graphs do
   not use (``DTYPE_COMPILES``): an add, a mul, two row reduces and a
   convert in bf16, int8 and int16 through ``emit_fusion``, and the break
   module in bf16 and an integer kin of it in int8 through
   ``emit_stitched_fusion``, and a (128, 512) softmax in one plan block
   whose slots pass a block's shared memory (``FUSION_COMPILES``): each
   launch counted, every kernel held against its plain version and the
   outputs against ``reference_execute``, bf16 at one ulp, int8 exactly.
   Then the 64-bit cases (``index64_check``): x * 1.5 + 0.25 over
   ``INDEX64_SHAPES`` f32, 2,147,549,184 elements and 1,310,760,000 (under
   2^31 - 1, but its grid-stride loop's variable passes it), under the
   card's plan, whose kernel must index in 64 bits, held exactly against
   torch chunk by chunk.  Then the fused dots (``staged_dots_check``): NMT and the
   Figure-3 attention at granite width (``STAGED_CASES``) under
   ``TPU_V5E``, whose plan staging leaves unchanged, with their dots
   staged and on the register-tile loop (``register_tile_loops``), bit for
   bit, and under the card's default plan (``H100``, row-split dots)
   against their plain kernels and ``reference_execute`` at ``TOL``, the
   attention also in bf16, its dots on the tensor cores, at ``BF16_STEP``;
   then the benchmark's bf16 layer at its own 4 x 4096 tokens
   (``staged_cell_check``), its two dot kernels on the tensor cores and
   taking every rule of ``STAGING_RULES``, each generated kernel against
   its plain version at ``BF16_STEP``; with each dot kernel's device µs,
   loop, CUDA blocks and share of its bound (``dot_lines``);
5. numbers — CUDA-event times: microseconds per call of each compiled graph
   and of ``reference_execute``, and per launch of each kernel and of its
   plain version, beside the kernel's bound (bytes in and out over 3.35
   TB/s, or f32 operations over 67 TFLOP/s, whichever is larger).  Back to
   back, these launches are paced by the host, so ``torch.profiler`` also
   gives each kernel's device time, and each graph's device kernels and
   device time per call, from which its device idle share follows, and the
   device time of each graph's unfused ``reference_execute`` (the yardstick
   of StitchPipe's stitched kernel); the ten graphs' pass under each spec,
   naming each graph whose H100 plan takes over 1.05x its ``TPU_V5E``
   plan's device time.  Each ``emit_fusion`` kernel's line
   also gives its members, plan blocks, grid, threads, bytes of shared
   memory, and ``ptxas``'s registers and spill bytes, and each kernel that
   holds a fused dot a line of its own (``dot_lines``: the loop each dot
   took, CUDA blocks, device µs, share of its bound).

6. kernels — the hand-written kernels of ``repro_torch.kernels`` through
   their public entry point ``repro_torch.kernels.ops``, at the full width
   of granite-moe-3b-a800m: rmsnorm, the sampler's softmax over the vocab,
   causal GQA prefill attention, GQA decode attention over a KV cache with
   seeded lengths, and the MoE router gate.  The counters are set to 0
   just before those five calls and must read just after one launch each,
   two for decode (its split and combine kernels), through the expected
   launchers (``launchers``: bf16 flash at D = 64 on the wgmma kernel
   ``sx_flash_wgmma_kernel``, RMSNorm
   on its 16-byte kernel ``sx_rmsnorm_vec_kernel``, the vocab softmax on
   its cluster kernel ``sx_softmax_cluster_kernel``), and the gate's grid
   must hold at least 132 blocks (one per SM).  Then
   the small shapes of ``tests/test_kernels.py`` (f32, G = 8, D = 8 and 16,
   non-causal, E = 8..64 with k = 1..8), each call through its expected
   launchers (f32 flash on the f32 kernel), and calls the small sweep of
   the test file leaves out: flash and decode attention at D = 32 and 128
   in f32 and bf16 (the default blocks, whose f32 K/V tiles need more than
   48 KB of shared memory at D = 128), flash with block_q != block_k, bf16
   flash at S = 48 and 80 (not multiples of its 64- or 128-row tiles) with
   D = 8, 16 (the mma.sync kernel) and 64 (the wgmma kernel) and G = 8, bf16
   flash on the wgmma kernel over several 128-key tiles (D = 64 at S = 256
   and 2048, causal and not; D = 128 at S = 2048, causal), held at the
   full-width limits, bf16 decode at lengths 0, 1, split - 1, split, split
   + 1 and S with G = 1, 3 and 8 and D = 64 and 128, softmax and
   rmsnorm at 16 and 32 rows per block, the gate at E = 32, 33, 64, 65,
   128 and 256 (1, 2, 4 and 8 slots a lane), at T = 4100 (a short last
   block) and on rows whose softmax is NaN (a NaN logit, a +inf logit,
   only -inf) in f32 and bf16, and rmsnorm on its scalar kernel
   ``sx_rmsnorm_kernel`` (bf16 d = 300, a view 2 bytes off 16, d = 16,392
   past the width held in registers) and on its 16-byte kernel at f32 d =
   1536 and bf16 d = 16,384, and softmax where its cluster kernel
   splits: rows that start off 16 bytes (r % 4 != 0 at 49,155 and 10,001
   columns), widths 4,095 (the row kernel), 4,096 and 4,097 (the cluster),
   131,072 (the widest cluster row) and 131,073 (the row kernel again),
   bf16 at full width, rows with one block's slice wholly -inf, and rows
   that are NaN across (a NaN, a +inf, only -inf).  Every call is held against its
   plain version on the same inputs.  The small shapes keep the test
   file's rtol = atol: 2e-5 in f32 and 3e-2 in bf16, 2e-4 and 5e-2 for
   attention.  At full width the limits follow from the outputs they check
   (``FULL_TOL``).  The gate's indices may differ from the plain version's
   only where the two picks' probabilities are within 2e-6 (``expf`` on
   the card and torch's ``exp`` round differently); the count of such
   picks is printed.  At full width: CUDA-event times of the kernel, of its
   plain version and of one PyTorch library call that computes the same
   function (timed only: the port never calls it), the profiler's device
   time of the kernel and of the library call (the sum over every device
   kernel each runs), and the bound: bytes over 3.35 TB/s or operations
   over the peak of their type (989 TFLOP/s bf16 for attention, 67 TFLOP/s
   f32 otherwise).  RMSNorm's 25 MB fit in the 50 MB L2, so its device
   time and ``F.rms_norm``'s are also taken over a rotation of 8 inputs
   (101 MB of x), where each call finds its x in device memory.

7. replay — each graph compiled with the default options: its
   ``replay_mode`` must be the one its dispatch counts give (the CUDA graph
   where a replayed call dispatches no more than an eager one), and a
   default call must take that path.  Then every graph replays through its
   CUDA graph (``jit_execute``): two calls, each bit for bit equal to its
   eager call (a library dot that rounds differently under capture would be
   named and held at ``TOL``); microseconds per call eager and replayed
   (CUDA events, 200 calls), device microseconds and idle share both ways.
   The launches of a replayed call are read from torch.profiler: each
   generated kernel as many times a call as the plan launches it, and
   every device kernel of the eager call plus one a copy group of the
   feeds and roots (a profile that disagrees is retaken, then fails); the
   counters' replay ticks are the plan's bookkeeping, held against the plan;
8. loops — the RNN cell as a scan (``RNNScan``), the decode loop and the
   reversed scan of ``repro_torch.graphs.LOOP_GRAPHS``, eager and replayed:
   launches counted (the body's kernels once an iteration; replayed, by the
   profiler as in phase 7), outputs against the plain path
   (``reference_execute``, the body interpreted op by op) and, for the scan,
   its final state against the unrolled RNN graph's;
9. verify — ``python -m repro_torch.lint`` in-process on the card: the ten
   graphs under ``verify="strict"`` in both planners, exit status 0;
10. autotune — the ten graphs compiled with ``autotune=True`` into a fresh
   store under ``build/repro_torch/``, in each planner: under the greedy
   planner twice, and the second compile must take no new measurement;
   under the cost planner ``AUTOTUNE_ROUNDS`` times, reported (it re-plans
   from what it measured and measures what it newly commits).  In both a
   compile measures only kernels the store does not hold; measurements
   and store hits per compile, ``model_error_pct``, whether the plan
   changed from the default one, and the last plan's outputs against
   ``reference_execute``;
11. f16 and the fault modules — the five hand-written kernels in f16 at
   granite-moe-3b-a800m's full width through their f16 launchers, each
   against its plain version (``F16_TOL``) and timed as in phase 6; and the
   two modules that reached the emitters' former limits (a concat of
   composed reshapes; a SHARE member reading its slot transposed, which
   writes through the workspace's staging region), one launch each, against
   their plain versions and ``reference_execute``.
12. frontend — ``repro_torch.stitch`` with the device left at its default
   (the card), eager (``jit_replay=False``) and replayed, over
   ``frontend_cases``: the three ``TORCH_FAMILIES`` at the reference's
   dimensions, StitchPipe's computation (the stitched emitter's plan,
   held against ``stitch_pipeline_graph`` as a family is), four end-to-end
   functions at granite-moe-3b-a800m's width over 512 tokens
   (``model_width_cases``: rmsnorm and layer_stats on (512, 1536), the
   gated MLP with two (1536, 512) weights, the Figure-3 attention on q, k,
   v of (1, 24, 512, 64)) under the default options (the card's plan) and
   under the parent's (``TPU_V5E``, max_blocks 32, named with
   ``TPU_TAG``), a decode-loop scan, a counted while_loop, a cond
   both ways and ``grad_and_value`` of an MLP loss.  The plans' sources
   are built in phase 2.  Each function's counters are set to 0 just
   before one eager call and read just after: its planned launches, every
   generated kernel at least once, and for a family the hand-built
   graph's plan (stitched, standalone, library) and launches, compiled by
   the port under the same options.  Zero fallbacks; outputs against the
   plain function run eagerly on the card and against ``reference_execute``
   of the lowered module at ``TOL``; two default calls through ``stitch``
   (the path ``replay_mode`` picks) and two of the plan's replay
   (``jit_execute``) bit for bit the eager plan's.  Printed per function:
   capture, lower and compile seconds; fused kernels and library dots; the
   device kernels a call of the plain function launches against the plan's
   (the profiler); µs per call (CUDA events, 200 calls) through ``stitch``
   eager and by default, of the plan's own replay (which leaves out
   ``stitch``'s host path) and of the plain function; device µs and idle
   share of each.  For the four granite-width functions
   (``model_width_numbers``): each plan's plan and CUDA blocks and slot
   bytes in shared memory and in the workspace, its device µs under both
   specs, the plain function's, the one PyTorch call's
   (``F.scaled_dot_product_attention``, ``F.rms_norm``, ``F.layer_norm``;
   held against the plain function) and the bound; a default plan that
   keeps a slot in the workspace fails the phase; each kernel that holds a
   fused dot gets its ``dot_lines``.  Last,
   ``donate_argnums`` on the card: a donated input's
   buffer takes a later kernel's output, the other inputs unchanged.
13. models — ``repro_torch.models`` on the card, no kernel of the port on
   its path (every kernel's launch count, the hand-written kernels'
   counters and the generated kernels' tally by emitter, is set to 0
   before it and must read 0 after: the reference's models call no Pallas
   kernel).  Each
   of the ten architectures at ``reduced_config``: ``forward`` and
   ``decode_chunk`` (ragged lengths; Whisper after
   ``prefill_cross_attention``) on the card against the port on the CPU,
   same seeded weights, f32 with TF32 off, at ``FAMILY_TOL``.  Then
   granite-moe-3b-a800m at full width in f32: 2 layers, ``forward`` of
   1 x 64 tokens on the card against the CPU (``GRANITE_CPU_TOL``); at
   full depth (32 layers) with dense MoE, ``decode_chunk`` over a 4 x 64
   prompt with ragged lengths against ``forward``'s logits at each row's
   last position (``DECODE_TOL``), and the paged cache (blocks of 16 from a
   shuffled pool) against the slot cache over the same chunk, one row
   inactive: logits and the written K/V bit for bit, the two read views
   one shape (``SLOT_MAX_LEN``).  Last, in bf16 with the default scatter
   MoE at full width and depth: ``forward`` of 4 x 512 tokens (ms by CUDA
   events, tokens/s, device ms, device kernels and idle share from
   torch.profiler), a 512-token context built by ``decode_chunk`` of 32
   tokens (ms each), ``decode_step`` at batch 4 over it (ms, device ms,
   device kernels a step, idle share, and the bound: the parameters' bytes
   over 3.35 TB/s, as decode reads every expert), parameter bytes and peak
   allocated bytes beside the card's name and power limit.
14. serving — ``repro_torch.serve`` on the card, each engine step (decode,
   prefill chunk) captured once into a CUDA graph and replayed, no kernel
   of the port on its path (the launch counts are set to 0 before it and
   must read 0 after, as in phase 13).  (a) Each architecture at ``reduced_config``, f32 with
   TF32 off: a seeded trace through ``PagedServeEngine`` (Whisper through
   ``ServeEngine``: its paged cache raises, as the reference's does), the
   card's replayed engine against the CPU's eager engine: every request's
   tokens and every ``stats()`` counter equal.  (b) granite-moe-3b-a800m
   at full width and depth in its own bf16, tokens bit for bit: paged
   against slot for the reference's single-request prompt lengths at one
   width and ``max_len`` 31 (the slot ring's 32 slots equal the paged
   view's 2 blocks of 16); preemption-resume (a pool of one max-length
   context, two requests) against solo runs at that width; and (c)'s trace
   replayed against eager, counters equal.  (c) One seeded Poisson trace
   (16 requests, prompts of 16-64 tokens, 8-16 new) through the paged
   engine (width 8, ``max_len`` 255, blocks of 16, chunks of 16), eager then
   replayed: tokens/s, TTFT and latency p50/p99, a decode launch with every
   row active (ms by CUDA events; device ms, device kernels and idle share
   from torch.profiler; the bound: the parameters' bytes over 3.35 TB/s), a
   prefill launch (the median ms of ``SERVE_PREFILL_CALLS`` launches, each
   between its own CUDA events), each graph's capture and instantiation seconds, max
   inflight, KV peak utilization and peak allocated bytes, beside the
   card's name and power limit.  (d) ``repro_torch.launch.serve.main`` at
   full width for 8 requests must finish every one.
15. training — ``repro_torch.train`` on the card, each path driven with
   every launch count set to 0 just before it and read just after.  (a)
   Each architecture at ``reduced_config``, f32 with TF32 off: 3 steps of
   the ``Trainer`` on the card (its default step, ``CapturedTrainStep``:
   the eager warm-up step, then 2 replays of the captured CUDA graph)
   against 3 eager steps of the ``Trainer`` on the CPU, the same seeded
   weights and batches: every loss at ``TRAIN_LOSS_TOL``, the params at
   ``TRAIN_PARAM_TOL``; no kernel of the port launched.  (b) The stitched
   MLP step of the reference's ``examples/train_stitched.py``
   (``make_stitched_train_step``): 20 steps eager (the counted run: its
   generated kernels, planned launches a step x 20) and 20 replayed, each
   against the plain step (the captured function run by PyTorch on the
   CPU) at ``STITCH_TOL``, 0 fallbacks, one compile; kernels a step, µs a
   step both ways (CUDA events, 200 steps), device µs and idle share.  (c)
   Peak allocated bytes of one step's loss and gradients at granite's full
   width and ``REMAT_LAYERS`` layers in each ``remat`` mode and with the
   CE over chunks of ``LOSS_CHUNK`` positions, the loss bit for bit (the
   chunked one at rtol 1e-5: its sums run in another order); a
   replayed step against an eager one from the same state there (the loss
   bit for bit, the gradients' norm at ``REPLAY_NORM_TOL``, the params
   within 2 lr and a bf16 ulp).  Then granite-moe-3b-a800m at full width and depth in bf16,
   ``remat="full"``, batches of 4 x 512 tokens from ``SyntheticLM``: the
   memory reckoning (params, grads, AdamW state), the first eager step's
   loss against ``cross_entropy(forward(...))`` on the card
   (``TRAIN_LOSS0_TOL``), eager steps and replayed ``CapturedTrainStep``
   steps: ms a step (CUDA events), device ms, device kernels and idle share
   (torch.profiler), tokens/s, peak allocated bytes, capture and
   instantiation seconds, beside the card's name and power limit; the loss
   finite to the end.
16. the multi-device compiler — qwen2.5-14b's MLP (``QWEN14``: d_model
   5120, d_ff 13824, SwiGLU) Megatron-sharded four ways through
   ``stitch(mesh=...)``: x (512, 5120) replicated, w_gate and w_up split on
   columns, w_down on rows, the body
   ``all_reduce(silu(x @ w_gate) * (x @ w_up) @ w_down)``.  This process
   first runs the unsharded function on the card (f32 with TF32 off, and
   bf16).  Then ``torch.multiprocessing``
   spawns a world of ``SHARD_WORLD`` ranks, every one on the card, over
   gloo (NCCL refuses two ranks on one card) with a ``FileStore`` under
   ``build/`` and a ``SHARD_TIMEOUT_S`` timeout.  Each rank: the rules'
   specs of qwen2.5-14b's full-width params on a shape-only (data 1, model
   4) mesh must equal those on the world's ``make_smoke_mesh(1, 4)``; the
   sharded MLP in f32 and bf16 (rank 0 builds each plan's source, the
   others wait and load it), one counted call each (every launch count at
   0 just before, read after: exactly the planned generated kernels, no
   hand-written one, one collective step), then ms a call (CUDA events),
   ms in collectives (host clock), device µs, kernels and copies a call
   (torch.profiler), peak allocated bytes and each op's backend and form;
   the gather/scatter function of ``tests/test_sharded_compile.py`` at
   (4 x 512, 5120) f32 the same way; ``reshard_state`` of a reduced
   qwen1.5-0.5b onto ``make_elastic_mesh(4)``: each rank's shard is its
   block of the input and the blocks gather back to it (the port's
   gather: gloo's functional all-gather of CUDA tensors kills the process
   under torch 2.11, which ``DTensor.full_tensor`` would call).  The
   parent holds every rank's output against the unsharded function at
   ``TOL`` (bf16 at ``SHARD_BF16_TOL`` of the largest output) and the
   ranks against each other bit for bit.  Last, a one-rank NCCL world runs
   the f32 MLP at mesh (model 1), held at ``TOL``, and takes the numbers of
   the unsharded plan of the same function (its kernels a call beside a
   rank's), in a fresh process as the ranks take theirs.  Every rank's and
   the unsharded plan's generated kernels are printed with their grid,
   threads, workspace bytes and device µs a call; the bf16 plans' silu x
   mul kernel must keep no workspace (its convert held in a register).  The world's
   directory under ``build/`` is removed once read.  Any rank's failure
   fails the phase (``spawn`` raises), and so does a world still running
   after ``SHARD_WORLD_DEADLINE_S`` (its ranks are killed; each rank first
   prints its stack).  Each rank prints a line as it finishes each case.
17. sharded training and the launch tools.  (a) The sharded train step
   (``make_sharded_train_step``, behind ``launch.train --mesh``) on
   qwen1.5-0.5b at full width and depth (``SP_ARCH``: 24 layers, d_model
   1024, 16 heads, d_ff 2816, vocab 151,936, bf16, remat "full"),
   ``activation_sharding="sp"``, a global batch of ``SP_SHAPE`` (4 x 512)
   tokens, ``SP_STEPS`` steps, by a world of ``SHARD_WORLD`` gloo ranks on
   the one card on a (data 2, model 2) mesh, the params seeded alike in
   every rank and placed by ``reshard_state``.  The oracle is the same
   steps unsharded (``make_train_step``), in a fresh process on the card
   first.  Checks: each step's loss and gradient norm within
   ``SP_LOSS_RTOL`` of the unsharded one's; the gathered params within 2
   lr_t a step, summed, and one bf16 ulp of the unsharded step's,
   elementwise (``SP_PARAM_LR`` says why; the elements past 2 lr and the
   update's relative L2 error are printed); the replicated leaves bit for bit
   across ranks; every block at rest the rules' cut of the gathered
   params; no kernel of the port launched (every count at 0 before the
   steps, read after).  Per rank: ms a step (CUDA events), ms in
   collectives (host clock, ``CollectiveMeter`` around ``core.comm``),
   result bytes moved by kind, peak allocated bytes, and the bytes of
   params, m, v and step at rest against the unsharded step's.  (b)
   ``launch.train --mesh 2,2 --reduced --steps 2`` in every rank of the
   same world must exit 0.  (c) ``launch.costmodel.fn_cost`` of phase 15's
   granite-moe-3b-a800m train step (4 x 512, bf16, remat "full") and of
   phase 13's ``forward`` (4 x 512) on meta tensors, the seconds each count
   took, and ``launch.roofline.analyze``'s H100 terms and model flops
   beside the device ms those phases measured in this run: the fraction
   of the bound each reaches.  Then the H100 spec's measured constants
   (``launch_overheads``): the device time of the generated ``exp`` kernel
   over (8, 256) in one plan block (the launch overhead) and over (8448,
   256) in 1 and 8 plan blocks (the grid-step overhead); the SM count; the
   block-count curve (a generated kernel with a slot over the same bytes
   at 1 .. 264 plan blocks, one CUDA block each: the fraction of 3.35 TB/s
   each reaches); ``vmem_bw`` (two generated kernels that differ only in
   one ALLOC slot: the bytes its loop moves through shared memory over the
   difference in device time); and ``phase_loop_overhead_s`` (a stitched
   kernel of the same work in 1 .. 8 phases: the slope of its device
   time), each kernel held against its plain version; and the staged
   dots' constants (``staged_constants``): ``l2_bw`` and
   ``l2_read_limit`` (a row-split dot of one row a block, each block
   staging its batch's whole rhs: those bytes over its device time, at
   each of ``L2_CASES``' whole rhs from 128 KiB to 48 MiB) and
   ``staged_op_rates`` (a staged dot whose lhs composes
   ``STAGED_CHAIN`` applications of each of ``STAGED_OPS`` against the
   same dot on a stored lhs: elements over the added device time).  (d) ``launch.dryrun``'s measurement of (a)'s cell on a fake
   world of 4 ranks (2 x 2), in a fresh process: its
   ``argument_size_in_bytes`` must equal rank 0's measured blocks and
   rows, its collective census must equal rank 0's bytes of a step kind for
   kind, and its ``temp_size_in_bytes`` estimate is printed beside the
   ranks' peak allocated bytes.  Each world stays inside
   ``SHARD_WORLD_DEADLINE_S`` and its directory under ``build/`` is removed
   once read.

A profile is read only between two long marks, with a call and short pads
outside each (``PAD_KERNEL``).  Every profile that kept other than two
marks, or whose device kernels a call are none or not a whole number, or
disagree with the plan, is taken again (up to ``PROFILE_TRIES``), and each
refused reading, with the pads and marks it kept, goes into ``--out`` as
``profile_retakes``; each accepted one whose session lost pads goes in as
``profile_edge_losses``.  In phase 16's world of four ranks each profiled
call runs a collective, so a profile refused on one rank is taken again on
every rank.  A run still going after ``DUMP_AFTER_S`` prints every
thread's stack to standard error.

Before the last two lines, phase 13's, 14's, 15's, 16's and 17's numbers as
one JSON object each (``models``, ``serve``, ``train``, ``sharded``,
``sharded_train`` and ``launch``).  The line before the last
is one JSON object with a ``kernels`` list: one entry per emitter
(``emit_fusion`` and ``emit_stitched_fusion``, with its launches in phase
12's counted calls as ``frontend_launches``, in phase 13's as
``models_launches``, in phase 14's as ``serve_launches``, in phase 15's
as ``train_launches`` and in phase 16's ranks' counted calls, summed over
the ranks, as ``sharded_launches``, and in phase 17's ranks' steps as
``sharded_train_launches``) and one per hand-written kernel (with
its f16 numbers as ``f16_*`` keys); the last line is ``{"ok": true,
"device": {...}}``.  ``--out`` also writes every per-graph, per-kernel and
per-function number as JSON (phase 12's under ``"frontend"``, phase 14's
under ``"serve"``, phase 15's under ``"train"``, phase 16's under
``"sharded"``, phase 17's under ``"sharded_train"`` and ``"launch"``), with nvcc's register,
shared-memory and spill lines.  Exits non-zero with no result when no card
is present.
"""
import argparse
import contextlib
import faulthandler
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM data-sheet peaks (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# granite-moe-3b-a800m, written out because this script imports nothing of
# the JAX package: src/repro/configs/granite_moe_3b_a800m.py:5-10 and the
# bf16 dtype and norm_eps of src/repro/configs/base.py:50-51
GRANITE = dict(d_model=1536, heads=24, kv_heads=8, head_dim=64, experts=40,
               top_k=8, vocab=49155, norm_eps=1e-6, d_ff=512)

# Outputs are held at rtol = atol = TOL: the kernels accumulate sums and
# dot products in f32 in another order than torch's reductions and matmul,
# which moves results by a few ulp.  Speech is the exception: it normalises
# each (utterance, filter) column by rsqrt(var + 1e-5), and where every frame
# of a column is clamped at log(1e-6) the true centred value is 0 and what
# any implementation returns is a 50-term mean's roundoff (1-2 ulp of 13.8)
# times 316.  Those outputs, and only those, are held at DEGENERATE_TOL.
TOL = 2e-5
DEGENERATE_TOL = 1e-3

WARMUP = 10
CALLS = 200          # timed calls of a compiled graph, a kernel or the oracle
PLAIN_CALLS = 20     # timed calls of a plain (block-interpreted) kernel
PROFILED_CALLS = 20  # calls traced by torch.profiler for device times
DUMP_AFTER_S = 1100  # a run still going after this prints where it is
KERNEL_CALLS = 50    # timed calls of a hand-written kernel or its library call
FULL_PLAIN_CALLS = 5  # timed calls of a hand-written kernel's plain version
COLD_ROTATION = 8    # full-width RMSNorm inputs cycled to time it with a cold L2

# kernel vs plain version in phase 6 (tests/test_kernels.py:16,70,82): the
# kernels sum in another order than torch, and cast to bf16 once at the end
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
ATTENTION_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
GATE_TIE = 2e-6      # gate picks may swap only between probabilities this close


#: the fused kernels one pass of the ten graphs launches under the
#: reference's plans (the reference's count)
REFERENCE_KERNELS = 35


def ref_options(**kw):
    """Options that plan with the reference's ``TPU_V5E`` spec and 4 MiB, as
    every compile for the CPU does: the phases that hold the card's plans
    against the reference's counts compile with them, explicitly, since a
    compile for the card plans with ``H100`` by default."""
    from repro_torch.core import StitchOptions
    from repro_torch.core.latency import TPU_V5E

    return StitchOptions(device_spec=TPU_V5E, **kw)


def softmax_transpose(b, x, g):
    """The break module of tests/test_stitching.py: a row softmax feeding a
    2-D transpose, a schedule break once (32, 48) passes the replicate limit."""
    scaled = x * b.broadcast(g, x.shape, (1,))
    mx = b.reduce(scaled, (1,), "max")
    e = b.exp(scaled - b.broadcast(mx, x.shape, (0,)))
    s = b.reduce(e, (1,), "sum")
    p = e / b.broadcast(s, x.shape, (0,))
    t = b.transpose(p, (1, 0))
    return b.tanh(t) * 0.5


# stitched compiles beside the main path: (label, module, StitchOptions fields,
# plan blocks of each phase)
STITCHED_COMPILES = [
    ("StitchPipe stitch_max_blocks=1", "StitchPipe", {"stitch_max_blocks": 1}, [1, 1]),
    ("StitchPipe stitch_max_blocks=4", "StitchPipe", {"stitch_max_blocks": 4}, [4, 1]),
    ("StitchPipe max_blocks=8", "StitchPipe", {"max_blocks": 8}, [8, 1]),
    ("StitchPipe max_blocks=64", "StitchPipe", {"max_blocks": 64}, [16, 1]),
    ("break (32, 48) max_blocks=32 replicate_limit=1024", "break",
     {"max_blocks": 32, "replicate_limit": 1024}, [2, 1]),
]


def arith(b, x, y):
    """An add, a mul, two row reduces and a convert to f32."""
    s = (x + y) * y
    return b.reduce(s, (1,), "sum"), b.reduce(s, (1,), "max"), b.convert(s, "float32")


def int_break(b, x, g):
    """The break module's integer kin: a row max feeding a transpose."""
    s = x * b.broadcast(g, x.shape, (1,))
    d = s - b.broadcast(b.reduce(s, (1,), "max"), x.shape, (0,))
    t = b.transpose(d, (1, 0))
    return t + t


# compiles beside the main path in the dtypes the graphs do not use, each
# through the emitter named: (label, module, dtype, StitchOptions fields,
# emitter, (rtol, atol)).  bf16 values round where each member ends; a sum
# accumulates in f32 in another order than torch's, and exp and tanh of the
# card and of torch may differ by an f32 ulp, so either may tip a bf16
# rounding: held at one bf16 ulp (2**-7), plus 2**-12 near 0.  int8 wraps
# exactly.
DTYPE_COMPILES = [
    ("arith bf16 (64, 128)", "arith", "bfloat16", {}, "emit_fusion", (2.0 ** -7, 2.0 ** -12)),
    ("arith int8 (64, 128)", "arith", "int8", {}, "emit_fusion", (0.0, 0.0)),
    ("arith int16 (64, 128)", "arith", "int16", {}, "emit_fusion", (0.0, 0.0)),
    ("break bf16 (32, 48)", "break", "bfloat16", {"max_blocks": 32, "replicate_limit": 1024},
     "emit_stitched_fusion", (2.0 ** -7, 2.0 ** -12)),
    ("int break int8 (32, 48)", "int_break", "int8", {"max_blocks": 32, "replicate_limit": 1024},
     "emit_stitched_fusion", (0.0, 0.0)),
]
# single-phase compiles beside the main path: a softmax whose one plan
# block's slots (263,168 bytes) pass a block's shared memory, so they live
# in a per-block workspace region
FUSION_COMPILES = [("softmax (128, 512) max_blocks=1", "softmax", {"max_blocks": 1})]


def dtype_compile(module_name, dtype, opts, device):
    """One of DTYPE_COMPILES (or FUSION_COMPILES, in f32), compiled for ``device``."""
    import numpy as np

    from repro_torch.core import compile_module, trace
    from repro_torch.core.ir import BFLOAT16

    dt = BFLOAT16 if dtype == "bfloat16" else np.dtype(dtype)
    if module_name == "softmax":
        module = trace(lambda b, x: b.softmax(x), ("x", (128, 512), dt))
    elif module_name == "arith":
        module = trace(arith, ("x", (64, 128), dt), ("y", (64, 128), dt))
    else:
        fn = softmax_transpose if module_name == "break" else int_break
        module = trace(fn, ("x", (32, 48), dt), ("g", (48,), dt))
    return module, compile_module(module, ref_options(jit_replay=False, **opts), device=device)


def ptxas_by_kernel(logs):
    """Registers and spill bytes of each kernel nvcc built, from its
    ``-Xptxas -v`` lines: {name: {"registers": n, "spill_stores": n, ...}}."""
    import re

    out, name = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
            if m:
                # a generated kernel by its own name, not the C++ mangled one
                gen = re.search(r"stitch_[0-9a-f]{16}", m.group(1))
                name = gen.group(0) if gen else m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                out.setdefault(name, {}).update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def geometry(source):
    """The launch a single-phase kernel's header states: grid, threads and
    bytes of dynamic shared memory a block."""
    import re

    m = re.search(r"one launch of (\d+) blocks of (\d+) threads, (\d+) bytes of shared memory", source)
    return {"grid": int(m.group(1)), "threads": int(m.group(2)), "smem_bytes": int(m.group(3))}


def stitched_compile(module_name, opts, device):
    """One of STITCHED_COMPILES, compiled for ``device``."""
    import numpy as np

    from repro_torch.core import compile_module, trace
    from repro_torch.graphs import ALL_GRAPHS

    if module_name == "break":
        module = trace(softmax_transpose, ("x", (32, 48), np.float32), ("g", (48,), np.float32))
    else:
        module = ALL_GRAPHS[module_name]()
    return compile_module(module, ref_options(jit_replay=False, **opts), device=device)

# (rtol, atol) of each full-width call.  The kernel and its plain version
# both compute in f32 and round once to the output dtype, so a bf16 output
# may differ by one bf16 ulp (at most 2**-7 of the value, hence rtol 1e-2)
# where the f32 values straddle a rounding boundary; atol only covers the
# f32 difference near 0.  Output scales at these shapes: softmax over
# 49,155 entries has a mean of 2.0e-5; causal attention over 2048 keys and
# decode over ~2,300 keys give |o| of a few 1e-2 on most rows; rmsnorm and
# the gate's weights are of order 1 and 1e-1.
FULL_TOL = {
    "stitched_rmsnorm": (1e-2, 1e-4),
    "stitched_softmax": (2e-5, 1e-9),
    "stitched_flash_attention": (1e-2, 1e-4),
    "stitched_decode_attention": (1e-2, 1e-4),
    "stitched_moe_gate": (2e-5, 1e-6),
}


def degenerate_mask(graph, root, feeds, out_shape):
    """Outputs whose value is amplified roundoff (see DEGENERATE_TOL)."""
    import numpy as np

    if graph != "Speech" or out_shape != (8, 80):
        return None
    x, w = feeds["frames"], feeds["mel"]
    B, T, F = x.shape
    mel = ((x * x).reshape(B * T, F) @ w).reshape(B, T, F)
    const = (mel < 1e-6).all(axis=1)
    return np.concatenate([const, const], axis=1)


def max_err(got, want, mask):
    """Largest |got - want| and whether it passes the stated tolerances."""
    import torch

    g, w = got.double(), want.double()
    bad = ~torch.isclose(g, w, rtol=TOL, atol=TOL)
    if mask is not None:
        m = torch.as_tensor(mask, device=g.device)
        loose = torch.isclose(g, w, rtol=DEGENERATE_TOL, atol=DEGENERATE_TOL)
        bad = torch.where(m, ~loose, bad)
    err = float((g - w).abs().max()) if g.numel() else 0.0
    return err, not bool(bad.any())


def time_ms(fn, calls, warm=True):
    """Milliseconds per call: CUDA events around ``calls`` calls, after as
    many warm-up calls (up to ``WARMUP``) unless ``warm`` is False."""
    import torch

    for _ in range(min(WARMUP, calls) if warm else 0):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def work(kernel):
    """Bytes each launch must move (inputs read once, outputs written once)
    and the f32 operations it must do."""
    nbytes = sum(i.bytesize for i in kernel.inputs) + sum(r.bytesize for r in kernel.outputs)
    ops = 0
    for m in kernel.fusion.members:
        if m.opcode in ("elementwise", "select"):
            ops += m.num_elements
        elif m.opcode == "reduce":
            ops += m.operands[0].num_elements
        elif m.opcode == "dot":
            ops += 2 * m.num_elements * m.operands[0].shape[-1]
    return nbytes, ops


#: ``torch.cuda._sleep``'s kernel.  A profiled session launches, in order:
#: ``PAD_LAUNCHES`` short pads, one call of the function, a long mark, the
#: measured calls, a long mark, one more call and ``PAD_LAUNCHES`` short
#: pads; only the kernels between the two marks are read.  On an H100 the
#: profiler lost the kernels at a session's edge: whole sessions, or the 16
#: leading pads and 1-8 kernels after them, the same count in every retake of
#: one profile once a process had run a dozen phases, whatever the pads'
#: length or a host wait after the start.  The calls and pads around the
#: marks take such a loss in place of the measured calls.
PAD_KERNEL = "spin_kernel"
PAD_LAUNCHES = 64
PAD_CYCLES = 1_000
MARK_CYCLES = 200_000
#: a spin kernel that ran this long (about 100 µs for ``MARK_CYCLES``) is a
#: mark, a shorter one (about 1 µs) a pad
MARK_MIN_US = 20.0
#: profiles taken of one function before one whose kernel count is wrong fails
PROFILE_TRIES = 8
#: every profile taken again: (label, each reading that was refused)
RETAKES = []
#: every accepted profile whose session lost pads at an edge: (label, pads
#: kept before the first mark and after it)
EDGE_LOSSES = []


def device_events(fn, calls):
    """The device kernels of ``calls`` calls as torch.profiler records
    them, as ``between_marks`` reads them from a session that runs the
    calls between two long marks, with one call and ``PAD_LAUNCHES`` short
    pads outside each mark (see ``PAD_KERNEL``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(PAD_CYCLES)
        fn()
        torch.cuda._sleep(MARK_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(MARK_CYCLES)
        fn()
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    return between_marks([(e.time_range.start, e.name, e.time_range.elapsed_us())
                          for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA])


def between_marks(device):
    """(name, device µs) of the kernels that started between a session's
    two marks, from its device events (start, name, µs), or None where the
    profiler kept other than two marks; and what it kept at the edges: the
    pads before the first mark and after it, and the marks."""
    device = sorted(device)
    spins = [(i, us >= MARK_MIN_US) for i, (_, n, us) in enumerate(device) if PAD_KERNEL in n]
    marks = [i for i, mark in spins if mark]
    lead = sum(1 for i, mark in spins if not mark and (not marks or i < marks[0]))
    edges = {"pads": [lead, sum(1 for _, mark in spins if not mark) - lead], "marks": len(marks)}
    if len(marks) != 2:
        return None, edges
    return [(n, us) for _, n, us in device[marks[0] + 1:marks[1]]], edges


def edge_loss(label, edges):
    """Note an accepted profile whose session lost pads at an edge."""
    if edges["pads"] != [PAD_LAUNCHES, PAD_LAUNCHES]:
        EDGE_LOSSES.append({"label": label, "pads": edges["pads"]})


def profile_again(label, reading):
    """Record a refused profile (kept in ``--out`` as ``profile_retakes``)
    and say so."""
    if not RETAKES or RETAKES[-1]["label"] != label:
        RETAKES.append({"label": label, "refused": []})
    RETAKES[-1]["refused"].append(reading)
    print(f"{label}: profile {len(RETAKES[-1]['refused'])} refused, {reading}: taken again")


def device_profile(fn, calls, label="profile", per_call=None, ignore=(), counts=None,
                   every_rank=None):
    """Device activity of ``calls`` calls as torch.profiler records it: the
    device kernels per call, and their device microseconds per call by
    kernel name.  A profile whose session kept other than two marks, or
    whose device kernels a call are none or not a whole number (events
    lost), is taken again, up to ``PROFILE_TRIES``
    times, and so is one in which ``per_call`` (names, n), where given,
    does not hold: the kernels whose names hold one of ``names`` number n
    a call.  Events whose names start with one of ``ignore`` are left out
    of all of it; ``counts``, where given, is filled with each kept name's
    events a call.  Where ``fn`` runs a collective, every rank must call it
    as often as the others: ``every_rank(held)`` then says whether every
    rank holds a profile, and a rank that holds one profiles again (and
    keeps its first) for as long as another rank does not."""
    readings = []
    held = None
    for _ in range(PROFILE_TRIES):
        events, edges = device_events(fn, calls)
        if held is None:
            events = [(n, us) for n, us in events or () if not n.startswith(tuple(ignore))]
            seen = len(events) / calls
            mine = None
            if per_call is not None:
                mine = sum(1 for n, _ in events if any(k in n for k in per_call[0])) / calls
            if (edges["marks"] == 2 and seen > 0 and seen.is_integer()
                    and (per_call is None or mine == per_call[1])):
                by_name = {}
                for name, us in events:
                    by_name[name] = by_name.get(name, 0.0) + us / calls
                if counts is not None:
                    for name in by_name:
                        counts[name] = sum(1 for n, _ in events if n == name) / calls
                held = seen, by_name
                edge_loss(label, edges)
            else:
                reading = {"device_kernels_a_call": seen, "edges_seen": edges, "named_a_call": mine}
                readings.append(reading)
                profile_again(label, reading)
        if (held is not None) if every_rank is None else every_rank(held is not None):
            return held
    raise SystemExit(f"{label}: no profile in {PROFILE_TRIES} recorded whole calls; read {readings}")


def profiled_launches(label, fn, want, total=None):
    """Hold the device kernels that torch.profiler sees in ``PROFILED_CALLS``
    calls of ``fn`` against a plan: ``want`` maps each generated kernel's
    name to its launches a call, and ``total``, where given, is every
    device kernel a call must run.  Returns (device kernels a call, device
    µs a call by kernel name) of the profile that agreed.  The profiler
    drops a run's events now and then (it once saw 0.35 kernels a call of a
    graph that runs 4): a profile that disagrees, or whose device kernels a
    call are not a whole number (an event of a library call lost), is
    taken again, up to ``PROFILE_TRIES`` times, and one that never agrees
    fails the run; so does one whose session kept other than two marks."""
    readings = []
    for _ in range(PROFILE_TRIES):
        events, edges = device_events(fn, PROFILED_CALLS)
        events = events or []
        seen = len(events) / PROFILED_CALLS
        got = {k: sum(1 for name, _ in events if k in name) / PROFILED_CALLS for k in want}
        if (edges["marks"] == 2 and got == want and seen.is_integer()
                and (total is None or seen == total)):
            by_name = {}
            for name, us in events:
                by_name[name] = by_name.get(name, 0.0) + us / PROFILED_CALLS
            edge_loss(label, edges)
            return seen, by_name
        readings.append((seen, got))
        profile_again(label, {"device_kernels_a_call": seen, "edges_seen": edges,
                              "generated_a_call": got, "plan": want, "total": total})
    raise SystemExit(f"{label}: the profiler's device kernels a call disagree with the plan "
                     f"({PROFILE_TRIES} profiles): want {want}, total {total}; read {readings}")


# the __global__ functions of each hand-written kernel, as the profiler names
# them; a call's device time is the sum over all of them
DEVICE_KERNEL = {
    "stitched_rmsnorm": ("sx_rmsnorm_vec_kernel", "sx_rmsnorm_kernel"),
    "stitched_softmax": ("sx_softmax_kernel", "sx_softmax_cluster_kernel"),
    "stitched_flash_attention": ("sx_flash_kernel", "sx_flash_mma_kernel", "sx_flash_wgmma_kernel"),
    "stitched_decode_attention": ("sx_decode_split_kernel", "sx_decode_combine_kernel"),
    "stitched_moe_gate": ("sx_moe_gate_kernel",),
}


def device_us_of(kernel, by_name):
    """Device microseconds per call of a hand-written kernel's __global__s."""
    return sum(t for name, t in by_name.items() if any(g in name for g in DEVICE_KERNEL[kernel]))


# the head dims at which bf16 and f16 flash attention runs the wgmma kernel
FLASH_WGMMA_DIMS = (64, 128)


def launchers(kernel, dtype, scalar=False, cluster=False, head_dim=None):
    """The launchers one call of a kernel runs, each once: flash attention
    runs the wgmma kernel in bf16 and f16 at ``head_dim`` 64 and 128, the
    mma.sync kernel at the smaller head dims and the f32 kernel in f32, decode
    attention its split and combine kernels, RMSNorm its 16-byte kernel
    unless ``scalar`` (rows it cannot serve), softmax its cluster kernel
    where ``cluster`` (wide rows) and its row kernel else, the gate one."""
    import torch

    sfx = {torch.bfloat16: "bf16", torch.float16: "f16"}.get(dtype, "f32")
    if kernel == "stitched_flash_attention":
        if sfx == "f32":
            return {"sx_flash_attention_f32": 1}
        return {f"sx_flash_{'wgmma' if head_dim in FLASH_WGMMA_DIMS else 'mma'}_attention_{sfx}": 1}
    if kernel == "stitched_decode_attention":
        return {f"sx_decode_split_{sfx}": 1, f"sx_decode_combine_{sfx}": 1}
    if kernel == "stitched_rmsnorm":
        return {f"sx_rmsnorm_{sfx}" if scalar else f"sx_rmsnorm_vec_{sfx}": 1}
    if kernel == "stitched_softmax":
        return {f"sx_softmax_cluster_{sfx}" if cluster else f"sx_softmax_{sfx}": 1}
    return {f"sx_{kernel.removeprefix('stitched_')}_{sfx}": 1}


def compare(got, want, tol):
    """Largest |got - want|, and whether shapes, dtypes and values agree at
    ``tol = (rtol, atol)`` (NaN only where the plain version has NaN)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return float("inf"), False
    g, w = got.double(), want.double()
    rtol, atol = tol
    ok = bool(torch.isclose(g, w, rtol=rtol, atol=atol, equal_nan=True).all())
    both = ~(g.isnan() & w.isnan())
    return (float((g - w)[both].abs().max()) if bool(both.any()) else 0.0), ok


def compare_gate(logits, got, want, tol):
    """The gate's weights at ``tol``, and its indices: a pick may
    differ from the plain version's only where the plain probabilities of
    the two experts are within GATE_TIE.  Returns (error, ok, differing picks)."""
    from repro_torch.kernels.ref import softmax_ref

    (w, i), (w2, i2) = got, want
    err, ok = compare(w, w2, tol)
    if i.shape != i2.shape or i.dtype != i2.dtype:
        return err, False, -1
    p = softmax_ref(logits.float())
    differ = i != i2
    gap = (p.gather(1, i.long()) - p.gather(1, i2.long())).abs()[differ]
    ok = ok and (not bool(differ.any()) or float(gap.max()) <= GATE_TIE)
    return err, ok, int(differ.sum())


def full_width_calls(dev, rng, randn, wide, rows):
    """One call of each hand-written kernel at granite-moe-3b-a800m's full
    width (``GRANITE``): RMSNorm, flash and decode attention in ``wide``
    (bf16 or f16), the sampler's softmax and the gate's logits in ``rows``
    (f32, or f16), each with its plain version, its library call, and the
    bytes and operations of its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    name = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    g = GRANITE
    D, Hq, Hkv, d = g["head_dim"], g["heads"], g["kv_heads"], g["d_model"]
    full = []
    x, gamma = randn((8, 512, d), wide), randn((d,), wide)
    full.append(dict(
        kernel="stitched_rmsnorm", label=f"x{tuple(x.shape)} {name[wide]}", x=x, gamma=gamma,
        call=lambda: ops.rmsnorm(x, gamma, eps=g["norm_eps"]),
        plain=lambda: ref.rmsnorm_ref(x, gamma, g["norm_eps"]),
        library=(lambda: F.rms_norm(x, (d,), gamma, g["norm_eps"])) if hasattr(F, "rms_norm") else None,
        bytes=nbytes(x, gamma, x), ops=4 * x.numel(), peak=F32_OPS_PER_S, dtype=wide,
    ))
    lg = randn((16, g["vocab"]), rows)
    full.append(dict(
        kernel="stitched_softmax", label=f"logits{tuple(lg.shape)} {name[rows]}",
        call=lambda: ops.softmax(lg), plain=lambda: ref.softmax_ref(lg),
        library=lambda: torch.softmax(lg, dim=-1), bytes=nbytes(lg, lg), ops=4 * lg.numel(),
        peak=F32_OPS_PER_S, cluster=True, dtype=rows,
    ))
    S = 2048
    q, k, v = randn((1, Hq, S, D), wide), randn((1, Hkv, S, D), wide), randn((1, Hkv, S, D), wide)
    full.append(dict(
        kernel="stitched_flash_attention", label=f"q{tuple(q.shape)} kv{tuple(k.shape)} {name[wide]} causal",
        call=lambda: ops.attention(q, k, v, causal=True),
        plain=lambda: ref.attention_ref(q, k, v, causal=True),
        library=lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        bytes=nbytes(q, k, v, q), ops=4 * Hq * D * S * (S + 1) // 2, peak=BF16_OPS_PER_S, dtype=wide,
        head_dim=D,
    ))
    B, Sc = 16, 4096
    qd = randn((B, Hq, D), wide)
    kc, vc = randn((B, Hkv, Sc, D), wide), randn((B, Hkv, Sc, D), wide)
    lengths = torch.as_tensor(rng.randint(1, Sc + 1, size=B), dtype=torch.int32, device=dev)
    valid = int(lengths.sum())
    mask = (torch.arange(Sc, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    full.append(dict(
        kernel="stitched_decode_attention",
        label=f"q{tuple(qd.shape)} kv{tuple(kc.shape)} {name[wide]}, {valid} valid keys",
        call=lambda: ops.attention_decode(qd, kc, vc, lengths),
        plain=lambda: ref.decode_attention_ref(qd, kc, vc, lengths),
        library=lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
        # the keys these lengths make valid, read once: count what the data needs
        bytes=nbytes(qd, lengths, qd) + 2 * Hkv * D * kc.element_size() * valid,
        ops=4 * Hq * D * valid, peak=BF16_OPS_PER_S, dtype=wide,
    ))
    gl = randn((4096, g["experts"]), rows)
    top_k = g["top_k"]

    def gate_library():
        w, i = torch.topk(torch.softmax(gl.float(), dim=-1), top_k, dim=-1)
        return w / w.sum(dim=-1, keepdim=True), i

    full.append(dict(
        kernel="stitched_moe_gate", label=f"logits{tuple(gl.shape)} {name[rows]} top{top_k}",
        call=lambda: ops.moe_gate(gl, top_k), plain=lambda: ref.moe_gate_ref(gl, top_k),
        library=gate_library, logits=gl, dtype=rows,
        bytes=nbytes(gl) + gl.shape[0] * top_k * 8, ops=gl.numel() * (4 + top_k), peak=F32_OPS_PER_S,
    ))
    return full


def time_full(c):
    """A full-width call's numbers: CUDA-event ms, device ms, its plain
    version's ms, its library call's ms (events and device), and its bound."""
    ms = time_ms(c["call"], KERNEL_CALLS)
    mine = (DEVICE_KERNEL[c["kernel"]], len(launchers(c["kernel"], None)))
    device_us = device_us_of(c["kernel"], device_profile(
        c["call"], PROFILED_CALLS, f"{c['kernel']} {c['label']}", per_call=mine)[1])
    library_device_us = (sum(device_profile(c["library"], PROFILED_CALLS,
                                            f"library of {c['kernel']} {c['label']}")[1].values())
                         if c["library"] else None)
    b_ms, o_ms = 1e3 * c["bytes"] / HBM_BYTES_PER_S, 1e3 * c["ops"] / c["peak"]
    return {
        "ms": ms, "plain_ms": time_ms(c["plain"], FULL_PLAIN_CALLS),
        # None where the profiler recorded no device time for it
        "device_ms": device_us / 1e3 if device_us else None,
        "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "library_ms": time_ms(c["library"], KERNEL_CALLS) if c["library"] else None,
        # None where there is no library call or the profiler recorded no device time
        "library_device_ms": library_device_us / 1e3 if library_device_us else None,
    }


def kernels_phase(dev):
    """Phase 6 (see the module docstring).  Returns the five hand-written
    kernels' entries of the kernels line and one row per call."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stitched_attention import decode_splits
    from repro_torch.kernels.stitched_moe_gate import gate_grid

    kernels = ops.KERNELS
    rng = np.random.RandomState(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dtype):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev).to(dtype)

    # ---- the full-width calls: one per kernel -------------------------------------
    g = GRANITE
    full = full_width_calls(dev, rng, randn, bf16, f32)
    x, gamma, gl, d = full[0]["x"], full[0]["gamma"], full[4]["logits"], g["d_model"]
    for c in full:
        c["tol"] = FULL_TOL[c["kernel"]]

    # ---- the small shapes of tests/test_kernels.py ---------------------------------
    small = []

    def add(kernel, label, call, plain, tol, **extra):
        small.append(dict(kernel=kernel, label=label, call=call, plain=plain, tol=(tol, tol), **extra))

    for dtype, name in ((f32, "float32"), (bf16, "bfloat16")):
        for shape in [(8, 16), (4, 8, 32), (2, 3, 5, 64), (16, 128)]:
            t = randn(shape, dtype)
            add("stitched_softmax", f"{shape} {name}", lambda t=t: ops.softmax(t),
                lambda t=t: ref.softmax_ref(t), KERNEL_TOL[name], dtype=dtype)
        for shape in [(4, 32), (2, 8, 64), (3, 5, 128)]:
            t, gm = randn(shape, dtype), randn(shape[-1:], dtype)
            add("stitched_rmsnorm", f"{shape} {name}", lambda t=t, gm=gm: ops.rmsnorm(t, gm),
                lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm), KERNEL_TOL[name], dtype=dtype)
    for br in (1, 2, 4, 8):
        t = randn((8, 24), f32)
        add("stitched_softmax", f"(8, 24) block_rows={br}", lambda t=t, br=br: ops.softmax(t, block_rows=br),
            lambda t=t: ref.softmax_ref(t), KERNEL_TOL["float32"])
    for (b, hq, hkv, s, dd) in [(1, 2, 2, 16, 8), (2, 4, 2, 32, 16), (1, 8, 1, 16, 8)]:
        for causal in (True, False):
            qs, ks, vs = randn((b, hq, s, dd), f32), randn((b, hkv, s, dd), f32), randn((b, hkv, s, dd), f32)
            add("stitched_flash_attention", f"{(b, hq, hkv, s, dd)} causal={causal}",
                lambda qs=qs, ks=ks, vs=vs, c=causal: ops.attention(qs, ks, vs, causal=c, block_q=8, block_k=8),
                lambda qs=qs, ks=ks, vs=vs, c=causal: ref.attention_ref(qs, ks, vs, causal=c),
                ATTENTION_TOL["float32"], dtype=f32)
    qs, ks, vs = randn((1, 2, 16, 8), bf16), randn((1, 2, 16, 8), bf16), randn((1, 2, 16, 8), bf16)
    add("stitched_flash_attention", "(1, 2, 2, 16, 8) bfloat16",
        lambda qs=qs, ks=ks, vs=vs: ops.attention(qs, ks, vs, causal=True, block_q=8, block_k=8),
        lambda qs=qs, ks=ks, vs=vs: ref.attention_ref(qs, ks, vs, causal=True),
        ATTENTION_TOL["bfloat16"], dtype=bf16, head_dim=8)
    for (b, hq, hkv, s, dd) in [(2, 4, 2, 32, 8), (1, 8, 1, 64, 16), (3, 2, 2, 16, 8)]:
        qq, kk, vv = randn((b, hq, dd), f32), randn((b, hkv, s, dd), f32), randn((b, hkv, s, dd), f32)
        ln = torch.as_tensor(rng.randint(1, s + 1, size=b), dtype=torch.int32, device=dev)
        add("stitched_decode_attention", f"{(b, hq, hkv, s, dd)} lengths={ln.tolist()}",
            lambda qq=qq, kk=kk, vv=vv, ln=ln: ops.attention_decode(qq, kk, vv, ln, block_k=8),
            lambda qq=qq, kk=kk, vv=vv, ln=ln: ref.decode_attention_ref(qq, kk, vv, ln),
            ATTENTION_TOL["float32"], dtype=f32)
    # beyond the test file: the other head dims the kernels are built for,
    # at the default blocks (at D = 128 the flash K/V tiles take 128 KB of
    # shared memory), flash with block_q != block_k, and 16 and 32 rows per
    # block for the row kernels
    for dd in (32, 128):
        for dtype, name in ((f32, "float32"), (bf16, "bfloat16")):
            qs, ks, vs = randn((1, 4, 256, dd), dtype), randn((1, 2, 256, dd), dtype), randn((1, 2, 256, dd), dtype)
            add("stitched_flash_attention", f"(1, 4, 2, 256, {dd}) {name} causal default blocks",
                lambda qs=qs, ks=ks, vs=vs: ops.attention(qs, ks, vs, causal=True),
                lambda qs=qs, ks=ks, vs=vs: ref.attention_ref(qs, ks, vs, causal=True),
                ATTENTION_TOL[name], dtype=dtype, head_dim=dd)
            qq, kk, vv = randn((2, 4, dd), dtype), randn((2, 2, 512, dd), dtype), randn((2, 2, 512, dd), dtype)
            ln = torch.as_tensor(rng.randint(1, 513, size=2), dtype=torch.int32, device=dev)
            add("stitched_decode_attention", f"(2, 4, 2, 512, {dd}) {name} lengths={ln.tolist()}",
                lambda qq=qq, kk=kk, vv=vv, ln=ln: ops.attention_decode(qq, kk, vv, ln),
                lambda qq=qq, kk=kk, vv=vv, ln=ln: ref.decode_attention_ref(qq, kk, vv, ln),
                ATTENTION_TOL[name], dtype=dtype)
    for bq, bk, causal in ((8, 16, True), (16, 8, True), (8, 32, False)):
        qs, ks, vs = randn((1, 4, 64, 16), f32), randn((1, 2, 64, 16), f32), randn((1, 2, 64, 16), f32)
        add("stitched_flash_attention", f"(1, 4, 2, 64, 16) block_q={bq} block_k={bk} causal={causal}",
            lambda qs=qs, ks=ks, vs=vs, bq=bq, bk=bk, c=causal:
                ops.attention(qs, ks, vs, causal=c, block_q=bq, block_k=bk),
            lambda qs=qs, ks=ks, vs=vs, c=causal: ref.attention_ref(qs, ks, vs, causal=c),
            ATTENTION_TOL["float32"], dtype=f32)
    # the edges of the attention kernels' tiles and splits: bf16 flash at S =
    # 48 and 80 (not multiples of its 64-row tiles), D = 8 (padded to 16), 16
    # and 64, G = 8; bf16 decode at lengths 0 (NaN in both versions), 1,
    # split - 1, split, split + 1 and S, G = 1, 3 and 8, D = 64 and 128
    for s in (48, 80):
        for dd in (8, 16, 64):
            for causal in (True, False):
                qs, ks, vs = randn((1, 8, s, dd), bf16), randn((1, 1, s, dd), bf16), randn((1, 1, s, dd), bf16)
                add("stitched_flash_attention", f"(1, 8, 1, {s}, {dd}) bfloat16 causal={causal}",
                    lambda qs=qs, ks=ks, vs=vs, c=causal: ops.attention(qs, ks, vs, causal=c),
                    lambda qs=qs, ks=ks, vs=vs, c=causal: ref.attention_ref(qs, ks, vs, causal=c),
                    ATTENTION_TOL["bfloat16"], dtype=bf16, head_dim=dd)
    # the wgmma kernel over several KV tiles of 128 keys: D = 64 at S = 256
    # and 2048, causal and not (where an earlier wgmma attempt failed), and
    # D = 128 at S = 2048, held at the full-width limits
    for (hq, hkv, s, dd) in ((4, 2, 256, 64), (4, 2, 2048, 64), (16, 8, 2048, 128)):
        for causal in (True, False) if dd == 64 else (True,):
            qs, ks, vs = randn((1, hq, s, dd), bf16), randn((1, hkv, s, dd), bf16), randn((1, hkv, s, dd), bf16)
            small.append(dict(
                kernel="stitched_flash_attention", label=f"(1, {hq}, {hkv}, {s}, {dd}) bfloat16 causal={causal}",
                call=lambda qs=qs, ks=ks, vs=vs, c=causal: ops.attention(qs, ks, vs, causal=c),
                plain=lambda qs=qs, ks=ks, vs=vs, c=causal: ref.attention_ref(qs, ks, vs, causal=c),
                tol=FULL_TOL["stitched_flash_attention"], dtype=bf16, head_dim=dd))
    sd = 512
    split = decode_splits(sd)[0]
    edge_lengths = [0, 1, split - 1, split, split + 1, sd]
    for gg in (1, 3, 8):
        for dd in (64, 128):
            nb = len(edge_lengths)
            qq, kk, vv = randn((nb, 2 * gg, dd), bf16), randn((nb, 2, sd, dd), bf16), randn((nb, 2, sd, dd), bf16)
            ln = torch.tensor(edge_lengths, dtype=torch.int32, device=dev)
            add("stitched_decode_attention", f"({nb}, {2 * gg}, 2, {sd}, {dd}) bfloat16 lengths={edge_lengths}",
                lambda qq=qq, kk=kk, vv=vv, ln=ln: ops.attention_decode(qq, kk, vv, ln),
                lambda qq=qq, kk=kk, vv=vv, ln=ln: ref.decode_attention_ref(qq, kk, vv, ln),
                ATTENTION_TOL["bfloat16"], dtype=bf16)
    for br, shape in ((16, (64, 24)), (32, (64, 24)), (16, (32, 300))):
        t, gm = randn(shape, f32), randn(shape[-1:], f32)
        add("stitched_softmax", f"{shape} block_rows={br}", lambda t=t, br=br: ops.softmax(t, block_rows=br),
            lambda t=t: ref.softmax_ref(t), KERNEL_TOL["float32"])
        add("stitched_rmsnorm", f"{shape} block_rows={br}",
            lambda t=t, gm=gm, br=br: ops.rmsnorm(t, gm, block_rows=br),
            lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm), KERNEL_TOL["float32"])
    gate_cases = [(16, 8, 2), (32, 40, 8), (8, 16, 1), (64, 64, 4)]
    gate_cases += [(32, g["experts"], kk) for kk in range(1, 9)]
    for (t, e, kk) in gate_cases:
        lt = randn((t, e), f32)
        add("stitched_moe_gate", f"T={t} E={e} k={kk}",
            lambda lt=lt, kk=kk: ops.moe_gate(lt, kk, block_tokens=8),
            lambda lt=lt, kk=kk: ref.moe_gate_ref(lt, kk), KERNEL_TOL["float32"], logits=lt)
    # where the redesigned gate and RMSNorm split: the gate's slots a lane
    # (E = 32/33, 64/65, 128, 256), a T that leaves its last block short,
    # and the rows of tests/test_torch_kernels.py whose softmax is NaN (a
    # NaN logit, a +inf logit, only -inf) beside finite rows, f32 and bf16;
    # RMSNorm's scalar kernel (bf16 d = 300, a view 2 bytes off 16, a row
    # past the 32 KB held in registers) and its 16-byte kernel at f32 d =
    # 1536 (two warps a row) and at the widest row held (bf16 d = 16,384)
    for e in (32, 33, 64, 65, 128, 256):
        lt = randn((64, e), f32)
        add("stitched_moe_gate", f"T=64 E={e} k=8",
            lambda lt=lt: ops.moe_gate(lt, 8), lambda lt=lt: ref.moe_gate_ref(lt, 8),
            KERNEL_TOL["float32"], logits=lt)
    lt = randn((4100, g["experts"]), f32)
    add("stitched_moe_gate", "T=4100 E=40 k=8 (last block 4 tokens short)",
        lambda lt=lt: ops.moe_gate(lt, 8), lambda lt=lt: ref.moe_gate_ref(lt, 8),
        KERNEL_TOL["float32"], logits=lt)
    for dtype, name in ((f32, "float32"), (bf16, "bfloat16")):
        for e, kk in ((8, 3), (40, 8)):
            lt = randn((8, e), f32)
            lt[1, 3], lt[3, e - 1], lt[5], lt[6, 2] = float("nan"), float("inf"), float("-inf"), float("-inf")
            lt = lt.to(dtype)
            add("stitched_moe_gate", f"T=8 E={e} k={kk} {name} NaN/inf rows",
                lambda lt=lt, kk=kk: ops.moe_gate(lt, kk), lambda lt=lt, kk=kk: ref.moe_gate_ref(lt, kk),
                KERNEL_TOL["float32"], logits=lt, dtype=dtype)
    t, gm = randn((64, 300), bf16), randn((300,), bf16)
    add("stitched_rmsnorm", "(64, 300) bfloat16 (scalar kernel)", lambda t=t, gm=gm: ops.rmsnorm(t, gm),
        lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm), KERNEL_TOL["bfloat16"], dtype=bf16, scalar=True)
    t, gm = randn((64 * 1536 + 1,), bf16)[1:].view(64, 1536), randn((1536,), bf16)
    add("stitched_rmsnorm", "(64, 1536) bfloat16 view 2 bytes off 16 (scalar kernel)",
        lambda t=t, gm=gm: ops.rmsnorm(t, gm), lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm),
        KERNEL_TOL["bfloat16"], dtype=bf16, scalar=True)
    t, gm = randn((8, 16392), bf16), randn((16392,), bf16)
    add("stitched_rmsnorm", "(8, 16392) bfloat16 past the held width (scalar kernel)",
        lambda t=t, gm=gm: ops.rmsnorm(t, gm), lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm),
        KERNEL_TOL["bfloat16"], dtype=bf16, scalar=True)
    for shape, dtype, name in (((512, 1536), f32, "float32"), ((8, 16384), bf16, "bfloat16")):
        t, gm = randn(shape, dtype), randn(shape[-1:], dtype)
        add("stitched_rmsnorm", f"{shape} {name}", lambda t=t, gm=gm: ops.rmsnorm(t, gm),
            lambda t=t, gm=gm: ref.rmsnorm_ref(t, gm), KERNEL_TOL[name], dtype=dtype)

    # where softmax's cluster kernel splits: rows off 16 bytes, the widths
    # around its threshold and past what a cluster holds, bf16 at full
    # width, one block's slice wholly -inf, rows NaN across
    vocab = g["vocab"]
    eighth = -(-vocab // 8)
    for shape, dtype, name, cluster in (
            ((5, vocab), f32, "float32", True), ((3, 10001), f32, "float32", True),
            ((4, 4095), f32, "float32", False), ((4, 4096), f32, "float32", True),
            ((4, 4097), f32, "float32", True), ((2, 131072), f32, "float32", True),
            ((2, 131073), f32, "float32", False), ((16, vocab), bf16, "bfloat16", True)):
        t = randn(shape, dtype)
        add("stitched_softmax", f"{shape} {name}", lambda t=t: ops.softmax(t),
            lambda t=t: ref.softmax_ref(t), KERNEL_TOL[name], dtype=dtype, cluster=cluster)
    for dtype, name in ((f32, "float32"), (bf16, "bfloat16")):
        t = randn((8, vocab), f32)
        t[0, :eighth] = float("-inf")                 # block 0's slice
        t[1, eighth:2 * eighth] = float("-inf")       # block 1's slice
        t[2, 7 * eighth:] = float("-inf")             # the last, shorter slice
        t[3, 5], t[4, 9], t[5] = float("nan"), float("inf"), float("-inf")
        t = t.to(dtype)
        add("stitched_softmax", f"(8, {vocab}) {name} -inf slices, NaN/+inf/-inf rows",
            lambda t=t: ops.softmax(t), lambda t=t: ref.softmax_ref(t), KERNEL_TOL[name],
            dtype=dtype, cluster=True)

    # ---- the main path: one call of each kernel at full width -----------------------
    def expect(c):
        """The launches of one call of ``c``: each launcher's count."""
        return launchers(c["kernel"], c.get("dtype"), c.get("scalar", False), c.get("cluster", False),
                         c.get("head_dim"))

    for kern in kernels.values():
        kern.launches, kern.by_symbol = 0, {}
    outs = [c["call"]() for c in full]
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}
    want = {c["kernel"]: sum(expect(c).values()) for c in full}
    if sorted(want) != sorted(kernels) or launches != want:
        raise SystemExit(f"kernels: launches at full width {launches}, expected {want}")
    for c in full:
        if kernels[c["kernel"]].by_symbol != expect(c):
            raise SystemExit(f"{c['kernel']}: launchers {kernels[c['kernel']].by_symbol}, "
                             f"expected {expect(c)}")
    for c, out in zip(full, outs, strict=True):
        c["out"], c["full_width"] = out, True
    for c in small:
        kern = kernels[c["kernel"]]
        before, by = kern.launches, dict(kern.by_symbol)
        c["out"] = c["call"]()
        ran = {k: n - by.get(k, 0) for k, n in kern.by_symbol.items() if n != by.get(k, 0)}
        if kern.launches - before != sum(expect(c).values()) or ran != expect(c):
            raise SystemExit(f"{c['kernel']} {c['label']}: launched {ran}, expected {expect(c)}")
    torch.cuda.synchronize()
    gate_block, gate_blocks = gate_grid(gl.shape[0], 256)
    if gate_blocks < 132:
        raise SystemExit(f"stitched_moe_gate: {gate_blocks} blocks at full width, expected >= 132")
    print(f"kernels: main path {sum(launches.values())} launches at full width ({launches}); "
          f"{len(small)} small calls, each through its expected launchers; the gate's grid "
          f"{gate_blocks} blocks of {gate_block} tokens")

    # ---- right: every call against its plain version on the same inputs -----------
    rows, gate_differ = [], 0
    for c in full + small:
        want = c["plain"]()
        if "logits" in c:
            err, ok, n = compare_gate(c["logits"], c["out"], want, c["tol"])
            gate_differ += max(n, 0)
        else:
            err, ok = compare(c["out"], want, c["tol"])
        if not ok:
            raise SystemExit(f"{c['kernel']} {c['label']}: kernel vs plain {err:.3e} over "
                             f"(rtol, atol)={c['tol']}")
        mag = (want[0] if isinstance(want, tuple) else want).float().abs().nan_to_num()
        c["err"], c["out_scale"], c["out_median"] = err, float(mag.max()), float(mag.median())
        rows.append({"kernel": c["kernel"], "shape": c["label"], "full_width": "full_width" in c,
                     "max_abs_err": err, "max_abs_out": c["out_scale"],
                     "median_abs_out": c["out_median"], "tolerance": list(c["tol"])})
    for c in full:
        results = c["out"] if isinstance(c["out"], tuple) else (c["out"],)
        if not all(bool(torch.isfinite(o.float()).all()) for o in results):
            raise SystemExit(f"{c['kernel']} {c['label']}: non-finite output")
    print(f"right: {len(full) + len(small)} calls of the 5 hand-written kernels agree with their "
          f"plain versions; MoE gate picks that differ between near-equal probabilities: {gate_differ}")

    # ---- numbers at full width -------------------------------------------------------
    def cold_l2(c):
        """RMSNorm's and F.rms_norm's device ms over a rotation of
        COLD_ROTATION inputs of the full-width shape (8 x 12.6 MB, twice the
        50 MB L2), so each call finds its x in device memory, not in L2."""
        gen = torch.Generator(device=dev).manual_seed(1)
        xs = [torch.randn(x.shape, generator=gen, device=dev).to(bf16) for _ in range(COLD_ROTATION)]
        turn = itertools.count()
        kern_us = device_us_of("stitched_rmsnorm", device_profile(
            lambda: ops.rmsnorm(xs[next(turn) % COLD_ROTATION], gamma, eps=g["norm_eps"]),
            PROFILED_CALLS, "stitched_rmsnorm cold L2",
            per_call=(DEVICE_KERNEL["stitched_rmsnorm"], 1))[1])
        lib_us = (sum(device_profile(
            lambda: F.rms_norm(xs[next(turn) % COLD_ROTATION], (d,), gamma, g["norm_eps"]),
            PROFILED_CALLS, "F.rms_norm cold L2")[1].values()) if c["library"] else 0.0)
        print(f"kernel stitched_rmsnorm {c['label']} over {COLD_ROTATION} inputs (cold L2): "
              f"device_ms={kern_us / 1e3 if kern_us else 'not measured'} "
              f"library_device_ms={lib_us / 1e3 if lib_us else 'not measured'}")
        return {"cold_device_ms": kern_us / 1e3 if kern_us else None,
                "library_cold_device_ms": lib_us / 1e3 if lib_us else None}

    entries = []
    for c in full:
        kern = kernels[c["kernel"]]
        t = time_full(c)
        entry = {
            "name": kern.name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kern.source.path.name}",
            "replaces": kern.replaces, "launches": launches[kern.name],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == kern.name),
            **t,
            "shape": c["label"], "tolerance": list(c["tol"]),
            "full_width_err": c["err"], "max_abs_out": c["out_scale"],
            "median_abs_out": c["out_median"],
        }
        if kern.name == "stitched_rmsnorm":
            entry.update(cold_l2(c))
        entries.append(entry)
        print(
            f"kernel {kern.name} {c['label']}: launches={entry['launches']} ms={t['ms']:.4f} "
            f"device_ms={entry['device_ms'] or 'not measured'} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms'] if t['library_ms'] is not None else 'none'} "
            f"library_device_ms={entry['library_device_ms'] or 'not measured'} "
            f"bound_ms={entry['bound_ms']:.5f} ({entry['bound_by']}) err={entry['max_abs_err']:.2e} "
            f"full_width_err={c['err']:.3e} |out| max={c['out_scale']:.3e} "
            f"median={c['out_median']:.3e} (rtol, atol)={c['tol']}"
        )
    return entries, rows


# ---------------------------------------------------------------------------
# Phases 7-11: replay, loops, verify, autotune, f16 and the emission faults
# ---------------------------------------------------------------------------

# the fault modules of tests/test_torch_codegen.py, built with the port's own
# GraphBuilder: a concat of composed reshapes (one kernel of 6 members over 4
# plan blocks) and a stitched kernel whose SHARE member reads its slot
# transposed (it writes through the workspace's staging region)
def concat_module():
    from repro_torch.core import GraphBuilder

    b = GraphBuilder("concat_pieces")
    x = b.parameter("x", (64, 128), "float32")
    s, m = b.reduce(x, (1,), "sum"), b.reduce(x, (1,), "max")
    b.exp(b.concat([b.reshape(s, (64, 1)), b.reshape(m, (64, 1))], 1))
    return b.module


def share_module():
    from repro_torch.core import GraphBuilder

    b = GraphBuilder("share_transposed")
    x = b.parameter("x", (32, 32), "float32")
    a = b.tanh(b.transpose(b.exp(x), (1, 0)))
    m = b.transpose(a, (1, 0)) + b.neg(a)
    b.exp(m) + m * m
    return b.module


FAULT_MODULES = {"concat": concat_module, "share": share_module}
LOOPS = ("RNNScan", "DecodeLoop", "ReverseScan")
LINT_MAX_BLOCKS = 64          # what python -m repro_torch.lint compiles under
AUTOTUNE_ROUNDS = 3           # the cost planner's autotuned compiles of each graph

# f16 kernel vs plain version at full width: both compute in f32 and round
# once to f16, so an output may differ by one f16 ulp (2**-11 of the value,
# hence rtol 1e-3) where the f32 values straddle a rounding boundary; softmax
# outputs near 2e-5 are f16 subnormals, whose ulp is 2**-24 (atol 1e-7)
F16_TOL = {
    "stitched_rmsnorm": (1e-3, 1e-4),
    "stitched_softmax": (1e-3, 1e-7),
    "stitched_flash_attention": (2e-3, 1e-4),
    "stitched_decode_attention": (2e-3, 1e-4),
    "stitched_moe_gate": (2e-5, 1e-6),
}


def sources_of(compiled):
    """The CUDA sources of a compile and of its loop bodies' compiles."""
    out = [compiled.cuda_source] if "__global__" in compiled.cuda_source else []
    for instr in compiled.executable.module.instructions:
        if instr.opcode == "call":
            out += sources_of(instr.attrs["compiled_body"])
    return out


def programs_of(compiled):
    """Every generated kernel a compile launches, loop bodies included,
    each once: {id: program}."""
    out = {id(k.fn): k.fn for k in compiled.kernels}
    for instr in compiled.executable.module.instructions:
        if instr.opcode == "call":
            out.update(programs_of(instr.attrs["compiled_body"]))
    return out


def planned_launches(compiled):
    """Generated-kernel launches one call makes: the fused kernels, and each
    loop's body kernels once an iteration."""
    n = compiled.stats.stitched_kernels
    for instr in compiled.executable.module.instructions:
        if instr.opcode == "call":
            n += int(instr.attrs["trip_count"]) * planned_launches(instr.attrs["compiled_body"])
    return n


def same(a, b):
    """Bit for bit, NaN where NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def planned_by_program(compiled):
    """Generated-kernel launches one call makes, by kernel name: each fused
    kernel once, each loop's body kernels once an iteration."""
    out = {}
    for k in compiled.executable.kernels.values():
        out[k.fn.name] = out.get(k.fn.name, 0) + 1
    for instr in compiled.executable.module.instructions:
        if instr.opcode == "call":
            for name, n in planned_by_program(instr.attrs["compiled_body"]).items():
                out[name] = out.get(name, 0) + int(instr.attrs["trip_count"]) * n
    return out


def replay_ticks(compiled):
    """The launches a replay adds to the counters, by kernel name: what the
    plan recorded at its capture (bookkeeping, not a measurement)."""
    out = {}
    for p, n in compiled.executable.execution_plan._graph.ticks:
        out[p.name] = out.get(p.name, 0) + n
    return out


def replay_phase(dev, graphs, eager_out):
    """Phase 7: every graph replayed through its CUDA graph.  A default call
    takes the path its plan chose (``replay_mode``: eager where a replay
    would dispatch more); ``jit_execute`` replays every graph, so the
    replay is held and timed on all ten.  Launches per replayed call are
    the profiler's: each generated kernel as often as the plan says, and
    every device kernel of the eager call plus one a copy group."""
    import torch

    from repro_torch.core import compile_module

    rows = []
    for name, (module, eager, feeds, dfeeds) in graphs.items():
        rp = compile_module(module, ref_options(), device=dev)   # jit_replay=True
        s, ex = rp.stats, rp.executable
        mode = "graph" if s.traced_dispatches_per_call <= s.eager_dispatches_per_call else "eager"
        if s.replay_mode != mode or ex.replay_mode != mode:
            raise SystemExit(f"{name}: replay mode {s.replay_mode}, the dispatch counts "
                             f"({s.eager_dispatches_per_call} eager, {s.traced_dispatches_per_call} "
                             f"replayed) say {mode}")
        st0 = ex.launch_stats()
        rp(dfeeds)
        st1 = ex.launch_stats()
        took = "graph" if st1.traced_calls > st0.traced_calls else "eager"
        if took != mode or st1.traced_calls + st1.eager_calls != st0.traced_calls + st0.eager_calls + 1:
            raise SystemExit(f"{name}: a default call took the {took} path, its mode is {mode}")
        first = ex.jit_execute(dfeeds)                   # captured at the first replay
        second = ex.jit_execute(dfeeds)
        torch.cuda.synchronize()
        plan = planned_by_program(rp)
        if sum(plan.values()) != planned_launches(rp) or replay_ticks(rp) != plan:
            raise SystemExit(f"{name}: the capture recorded {replay_ticks(rp)}, the plan "
                             f"launches {plan}")
        ref = eager_out[name]
        bitwise = all(same(first[k], ref[k]) and same(second[k], ref[k]) for k in ref)
        held = []
        if not bitwise:
            # only a library dot may round differently under capture
            held = [i.name for i in ex.plan.standalone if i.is_library_call]
            for k in ref:
                for out in (first, second):
                    err, ok = max_err(out[k], ref[k], degenerate_mask(name, k, feeds, tuple(ref[k].shape)))
                    if not held or not ok:
                        raise SystemExit(f"{name}:{k}: replay vs eager {err:.3e}, library dots {held}")
        seg = ex.execution_plan._graph
        # the feeds' copies into the graph and the roots' out of it: the
        # small tensors' batched by dtype, a dispatch a group
        copied = len(seg.feed_slots) + len(seg.out_slots)
        copies = len(seg.in_groups) + len(seg.out_groups)
        eager_us = 1e3 * time_ms(lambda c=eager, f=dfeeds: c(f), CALLS)
        replay_us = 1e3 * time_ms(lambda x=ex, f=dfeeds: x.jit_execute(f), CALLS)
        e_seen, e_by = profiled_launches(f"{name} eager", lambda c=eager, f=dfeeds: c(f), plan)
        r_seen, r_by = profiled_launches(f"{name} replayed", lambda x=ex, f=dfeeds: x.jit_execute(f),
                                         plan, total=e_seen + copies)
        e_dev, r_dev = sum(e_by.values()), sum(r_by.values())
        row = {
            "graph": name, "replay_mode": mode, "bitwise": bitwise, "held_at_tol": held,
            "launches_per_call": sum(plan.values()), "copies_per_call": copies,
            "tensors_copied": copied,
            "eager_dispatches_per_call": s.eager_dispatches_per_call,
            "traced_dispatches_per_call": s.traced_dispatches_per_call,
            "eager_us_per_call": eager_us, "replay_us_per_call": replay_us,
            "eager_device_us_per_call": e_dev, "replay_device_us_per_call": r_dev,
            "eager_idle_share": 1.0 - e_dev / eager_us, "replay_idle_share": 1.0 - r_dev / replay_us,
            "eager_device_kernels": e_seen, "replay_device_kernels": r_seen,
        }
        rows.append(row)
        print(f"replay {name}: mode={mode} (dispatches eager {s.eager_dispatches_per_call}, "
              f"replayed {s.traced_dispatches_per_call}); "
              f"{'bitwise' if bitwise else 'held at TOL (library dots ' + ', '.join(held) + ')'} "
              f"vs eager over 2 calls; profiler: {sum(plan.values())} generated launches a "
              f"replayed call as planned, device kernels eager={e_seen} replay={r_seen} "
              f"(eager + {copies} copies, {copied} tensors) "
              f"us_per_call eager={eager_us:.1f} replay={replay_us:.1f} "
              f"device_us eager={e_dev:.2f} replay={r_dev:.2f} "
              f"idle_share eager={row['eager_idle_share']:.3f} replay={row['replay_idle_share']:.3f}")
    return rows


def loops_phase(dev):
    """Phase 8: the loop modules on the card, eager and replayed."""
    import numpy as np
    import torch

    from repro_torch.core import compile_module, reference_execute
    from repro_torch.core.ir import apply_op
    from repro_torch.graphs import LOOP_GRAPHS, rnn_graph

    rows = []
    for name in LOOPS:
        module = LOOP_GRAPHS[name]()
        rng = np.random.RandomState(2)
        feeds = {p.name: torch.as_tensor((rng.randn(*p.shape) * 0.3).astype(np.float32), device=dev)
                 for p in module.parameters}
        eager = compile_module(module, ref_options(jit_replay=False), device=dev)
        rp = compile_module(module, ref_options(), device=dev)
        plain = reference_execute(module, feeds, device=dev)
        progs = {**programs_of(eager), **programs_of(rp)}
        for p in progs.values():
            p.launches = 0
        out_e = eager(feeds)
        torch.cuda.synchronize()
        n_e = sum(p.launches for p in progs.values())
        out_r, out_r2 = rp(feeds), rp(feeds)
        for p in progs.values():
            p.launches = 0
        rp(feeds)
        torch.cuda.synchronize()
        n_r = sum(p.launches for p in progs.values())
        want = planned_launches(eager)
        plan = planned_by_program(rp)
        if rp.stats.replay_mode != "graph" or n_e != want or n_r != want or replay_ticks(rp) != plan:
            raise SystemExit(f"{name}: mode {rp.stats.replay_mode}, launches eager {n_e}, "
                             f"replayed {n_r} (bookkeeping), planned {want}")
        err = 0.0
        for k in plain:
            for out in (out_e, out_r, out_r2):
                e, ok = max_err(out[k], plain[k], None)
                err = max(err, e)
                if not ok or not bool(torch.isfinite(out[k]).all()):
                    raise SystemExit(f"{name}:{k}: vs plain path {e:.3e}")
        bitwise = all(same(out_r[k], out_e[k]) and same(out_r2[k], out_e[k]) for k in plain)
        if name == "RNNScan":
            # the unrolled RNN graph's last hidden state, op by op on the card
            unrolled = rnn_graph()
            uf = {k: feeds[k] for k in ("Wx", "Wh", "b", "h0")}
            uf.update({f"x{t}": feeds["xs"][t] for t in range(6)})
            uf["Wo"] = torch.zeros((32, 8), device=dev)
            vals = {}
            for instr in unrolled.instructions:
                vals[instr.id] = (uf[instr.name] if instr.opcode == "parameter" else
                                  apply_op(instr, *[vals[o.id] for o in instr.operands], device=dev))
            wo = next(i for i in unrolled.instructions if i.name == "Wo")
            h_unrolled = vals[wo.users[0].operands[0].id]
            final = out_r[module.roots[0].name]
            e, ok = max_err(final, h_unrolled, None)
            if not ok:
                raise SystemExit(f"RNNScan: final state vs the unrolled RNN graph's {e:.3e}")
            err = max(err, e)
        eager_us = 1e3 * time_ms(lambda c=eager, f=feeds: c(f), CALLS)
        replay_us = 1e3 * time_ms(lambda c=rp, f=feeds: c(f), CALLS)
        seg = rp.executable.execution_plan._graph
        e_seen, e_by = profiled_launches(f"{name} eager", lambda c=eager, f=feeds: c(f), plan)
        _, r_by = profiled_launches(f"{name} replayed", lambda c=rp, f=feeds: c(f), plan,
                                    total=e_seen + len(seg.in_groups) + len(seg.out_groups))
        e_dev, r_dev = sum(e_by.values()), sum(r_by.values())
        s = rp.stats
        rows.append({"module": name, "launches_per_call": want, "bitwise_replay_vs_eager": bitwise,
                     "max_abs_err": err, "loop_calls": s.loop_calls, "sub_compiles": s.sub_compiles,
                     "sub_kernels": s.sub_kernels, "eager_us_per_call": eager_us,
                     "replay_us_per_call": replay_us, "eager_device_us_per_call": e_dev,
                     "replay_device_us_per_call": r_dev})
        print(f"loop {name}: {want} launches a call eager and replayed (the profiler's), vs "
              f"plain path err={err:.2e}"
              f"{' (and the unrolled RNN graph)' if name == 'RNNScan' else ''}, replay "
              f"{'bitwise' if bitwise else 'within TOL'} vs eager; us_per_call eager={eager_us:.1f} "
              f"replay={replay_us:.1f} device_us eager={e_dev:.2f} replay={r_dev:.2f}")
    return rows


def verify_phase():
    """Phase 9: ``python -m repro_torch.lint`` on the card: the ten graphs
    under verify="strict" in both planners."""
    from repro_torch import lint

    t0 = time.perf_counter()
    rc = lint.main([])
    if rc != 0:
        raise SystemExit(f"repro_torch.lint exited {rc}")
    print(f"verify: repro_torch.lint clean on the card in {time.perf_counter() - t0:.1f} s")


def plan_shape(stats):
    return sorted((r.num_ops, r.blocks, r.num_phases) for r in stats.reports)


def autotune_phase(dev, graphs):
    """Phase 10: the ten graphs compiled with autotune=True, in each
    planner, into a fresh store under build/ and compiled again.  Under the
    greedy planner the plan does not depend on costs, so the second compile
    must take no new measurement.  The cost planner re-plans from what it
    measured and measures the kernels it newly commits: its compiles are
    reported, three of them.  In both, a compile measures only kernels the
    store does not hold, and the last compile's outputs agree with
    reference_execute."""
    import torch

    from repro_torch.core import compile_module, reference_execute
    from repro_torch.core.latency import TPU_V5E
    from repro_torch.core.measure import MeasuredCostStore, device_fingerprint
    from repro_torch.graphs import ALL_GRAPHS

    fp = device_fingerprint(TPU_V5E, dev)
    rows = []
    for planner, rounds in (("greedy", 2), ("cost", AUTOTUNE_ROUNDS)):
        path = os.path.join(HERE, "build", "repro_torch", f"autotune_{planner}.json")
        if os.path.exists(path):
            os.remove(path)
        store = MeasuredCostStore(path, device_fp=fp)
        opts = ref_options(planner=planner, autotune=True, tuning_store_path=path,
                           jit_replay=False)
        default = ref_options(planner=planner, jit_replay=False)
        for name, (module, _, feeds, dfeeds) in graphs.items():
            base = compile_module(ALL_GRAPHS[name](), default, device="cpu")
            compiles = []
            for _ in range(rounds):
                held = len(store)
                c = compile_module(ALL_GRAPHS[name](), opts, device=dev, measured_store=store)
                if len(store) - held != c.stats.measurements_taken:
                    raise SystemExit(f"{name} [{planner}]: measured a kernel the store holds")
                compiles.append(c)
            store.save()
            if planner == "greedy" and compiles[1].stats.measurements_taken:
                raise SystemExit(f"{name} [greedy]: the warm compile took "
                                 f"{compiles[1].stats.measurements_taken} new measurements")
            last = compiles[-1]
            want = reference_execute(last.executable.module, dfeeds, device=dev)
            got = last(dfeeds)
            for k, w in want.items():
                e, ok = max_err(got[k], w, degenerate_mask(name, k, feeds, tuple(w.shape)))
                if not ok:
                    raise SystemExit(f"{name}:{k} [{planner}]: autotuned plan vs "
                                     f"reference_execute {e:.3e}")
            torch.cuda.synchronize()
            row = {
                "graph": name, "planner": planner,
                "measurements": [c.stats.measurements_taken for c in compiles],
                "measured_hits": [c.stats.measured_hits for c in compiles],
                "model_error_pct": compiles[0].stats.model_error_pct,
                "fused_kernels": [c.stats.stitched_kernels for c in compiles],
                "default_fused_kernels": base.stats.stitched_kernels,
                "plan_changed": [plan_shape(c.stats) != plan_shape(base.stats) for c in compiles],
                "measured_us": [[r.measured_cost_s * 1e6 if r.measured_cost_s else None
                                 for r in c.stats.reports] for c in compiles],
                "model_us": [[r.model_cost_s * 1e6 if r.model_cost_s else None
                              for r in c.stats.reports] for c in compiles],
            }
            rows.append(row)
            err = row["model_error_pct"]
            print(f"autotune {name} [{planner}]: measurements per compile {row['measurements']}, "
                  f"store hits {row['measured_hits']}, model_error_pct="
                  f"{f'{err:.1f}' if err is not None else 'none'}, fused kernels "
                  f"{row['fused_kernels']} (default {row['default_fused_kernels']}), plan changed "
                  f"from the default {row['plan_changed']}")
        print(f"autotune [{planner}]: store {os.path.relpath(path, HERE)}, {len(store)} rows keyed "
              f"by device fingerprint {fp}")
    return rows


def f16_phase(dev):
    """Phase 11a: the five hand-written kernels in f16 at granite-moe-3b-a800m's
    full width (``full_width_calls``, every input f16), each once with the
    counters read, held against its plain version, and timed beside it and
    its library call."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    kernels = ops.KERNELS
    rng = np.random.RandomState(3)
    f16 = torch.float16

    def randn(shape, dtype):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev).to(dtype)

    calls = full_width_calls(dev, rng, randn, f16, f16)
    for kern in kernels.values():
        kern.launches, kern.by_symbol = 0, {}
    outs = [c["call"]() for c in calls]
    torch.cuda.synchronize()
    for c, out in zip(calls, outs, strict=True):
        kern = kernels[c["kernel"]]
        expect = launchers(c["kernel"], f16, cluster=c.get("cluster", False), head_dim=c.get("head_dim"))
        if kern.by_symbol != expect:
            raise SystemExit(f"{c['kernel']} f16: launchers {kern.by_symbol}, expected {expect}")
        want = c["plain"]()
        tol = F16_TOL[c["kernel"]]
        if "logits" in c:
            err, ok, _ = compare_gate(c["logits"], out, want, tol)
        else:
            err, ok = compare(out, want, tol)
        results = out if isinstance(out, tuple) else (out,)
        if not ok or not all(bool(torch.isfinite(o.float()).all()) for o in results):
            raise SystemExit(f"{c['kernel']} {c['label']}: kernel vs plain {err:.3e} over {tol}")
        c["err"], c["tol"] = err, tol
    print(f"f16: the 5 hand-written kernels at full width, one call each through their f16 "
          f"launchers ({', '.join(sorted(s for kk in kernels.values() for s in kk.by_symbol))}), "
          "each within its limit of its plain version")
    out = {}
    for c in calls:
        name = c["kernel"]
        t = time_full(c)
        out[name] = {f"f16_{k}": v for k, v in t.items() if k != "bound_by"}
        out[name].update({
            "f16_shape": c["label"], "f16_max_abs_err": c["err"], "f16_tolerance": list(c["tol"]),
            "f16_launches": sum(launchers(name, f16, cluster=c.get("cluster", False),
                                          head_dim=c.get("head_dim")).values()),
        })
        print(f"kernel {name} {c['label']}: ms={t['ms']:.4f} "
              f"device_ms={t['device_ms'] or 'not measured'} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms'] if t['library_ms'] is not None else 'none'} "
              f"library_device_ms={t['library_device_ms'] or 'not measured'} "
              f"bound_ms={t['bound_ms']:.5f} err={c['err']:.2e} (rtol, atol)={c['tol']}")
    return out


def faults_phase(dev):
    """Phase 11b: the modules that reached the two emission limits, compiled
    for the card: one launch each, the kernel against its plain version on
    the inputs the call gave it, the outputs against reference_execute."""
    import numpy as np
    import torch

    from repro_torch.core import compile_module, reference_execute

    rows = []
    for name, build in FAULT_MODULES.items():
        module = build()
        compiled = compile_module(module, ref_options(jit_replay=False), device=dev)
        (kernel,) = compiled.kernels
        rng = np.random.RandomState(4)
        feeds = {p.name: torch.as_tensor((rng.randn(*p.shape) * 0.1).astype(np.float32), device=dev)
                 for p in module.parameters}
        inputs = []

        def record(*a, device, _launch=kernel.fn.launch):
            inputs.append([t.clone() for t in a])
            return _launch(*a, device=device)

        kernel.fn.launch, kernel.fn.launches = record, 0
        got = compiled(feeds)
        torch.cuda.synchronize()
        del kernel.fn.launch
        if kernel.fn.launches != 1:
            raise SystemExit(f"{name}: {kernel.fn.launches} launches, expected 1")
        err = 0.0
        for g, w in zip(kernel.fn.launch(*inputs[0], device=dev), kernel.fn.plain(*inputs[0], device=dev),
                        strict=True):
            e, ok = max_err(g, w, None)
            err = max(err, e)
            if not ok:
                raise SystemExit(f"{name} {kernel.fn.name}: kernel vs plain {e:.3e}")
        for k, w in reference_execute(module, feeds, device=dev).items():
            e, ok = max_err(got[k], w, None)
            err = max(err, e)
            if not ok:
                raise SystemExit(f"{name}:{k}: vs reference_execute {e:.3e}")
        r = compiled.stats.reports[0]
        rows.append({"module": name, "kernel": kernel.fn.name, "emitter": kernel.fn.emitter,
                     "members": r.num_ops, "blocks": r.blocks, "phases": r.num_phases,
                     "workspace_bytes": kernel.fn.workspace_bytes, "max_abs_err": err})
        print(f"fault module {name}: {kernel.fn.emitter} {kernel.fn.name}, {r.num_ops} members, "
              f"{r.blocks} plan blocks, {r.num_phases} phases, one launch, vs plain and "
              f"reference_execute err={err:.2e}")
    return rows


# ---- phase 12: the frontend ----------------------------------------------------

#: the options the frontend's functions compile under, as in
#: tests/test_torch_frontend.py (each family adds its own overrides)
FRONTEND_MAX_BLOCKS = 32
#: tokens of the granite-width functions
FRONTEND_TOKENS = 512


#: the suffix of a phase-12 case compiled under the parent's plan
TPU_TAG = "@TPU_V5E"


def model_width_cases():
    """Four of tests/test_torch_frontend.py's functions at
    granite-moe-3b-a800m's width over ``FRONTEND_TOKENS`` tokens: (name, fn,
    numpy args, the one PyTorch call that computes the same function or
    None, the f32 operations of its products)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    def fig3_attention(q, k, v):
        d = q.shape[-1]
        s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / d ** 0.5)
        s = s - torch.amax(s, dim=-1, keepdim=True)
        e = torch.exp(s)
        return torch.matmul(e / torch.sum(e, dim=-1, keepdim=True), v)

    def rmsnorm(x, g):
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + 1e-6) * g

    def gated_mlp(x, w_gate, w_up):
        return F.silu(torch.matmul(x, w_gate)) * torch.matmul(x, w_up)

    def layer_stats(x):
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5)

    rng = np.random.RandomState(1)
    t, d, ff = FRONTEND_TOKENS, GRANITE["d_model"], GRANITE["d_ff"]
    h, hd = GRANITE["heads"], GRANITE["head_dim"]
    f4 = np.float32
    return [
        ("rmsnorm", rmsnorm, (rng.randn(t, d).astype(f4), rng.randn(d).astype(f4)),
         lambda x, g: F.rms_norm(x, (x.shape[-1],), g, eps=1e-6), 0.0),
        ("layer_stats", layer_stats, (rng.randn(t, d).astype(f4),),
         lambda x: F.layer_norm(x, (x.shape[-1],), eps=1e-5), 0.0),
        ("gated_mlp", gated_mlp, (rng.randn(t, d).astype(f4), rng.randn(d, ff).astype(f4),
                                  rng.randn(d, ff).astype(f4)), None, 2 * 2.0 * t * d * ff),
        ("fig3_attention", fig3_attention,
         tuple(rng.randn(1, h, t, hd).astype(f4) for _ in range(3)),
         lambda q, k, v: F.scaled_dot_product_attention(q, k, v), 2 * 2.0 * h * t * t * hd),
    ]


def frontend_cases():
    """Phase 12's functions: (name, fn, numpy args, StitchOptions, family).
    The three ``TORCH_FAMILIES`` at the reference's dimensions and
    StitchPipe's computation (held against its hand-built graph); the four
    ``model_width_cases`` under the default options (the card's plan) and
    under the parent's (``TPU_V5E``, max_blocks 32; name + ``TPU_TAG``); the
    control-flow functions and the MLP loss's gradient of
    tests/test_torch_frontend_controlflow.py at its sizes.  Every case but
    the four defaults plans with ``TPU_V5E`` (``ref_options``)."""
    import dataclasses

    import numpy as np
    import torch
    from torch._higher_order_ops.scan import scan
    from torch._higher_order_ops.while_loop import while_loop

    from repro_torch.core import StitchOptions
    from repro_torch.graphs import TORCH_FAMILIES, stitch_pipeline_graph

    opts = ref_options(max_blocks=FRONTEND_MAX_BLOCKS)

    def decode_loop(h, w):
        def step(carry, _x):
            carry = torch.tanh(carry @ w)
            return carry.clone(), carry.sum(dim=-1)

        return scan(step, h, torch.zeros(6, 0, device=h.device))

    def stitch_pipe(x, g):
        scaled = x * g
        e = torch.exp(scaled - torch.amax(scaled, dim=1, keepdim=True))
        p = e / torch.sum(e, dim=1, keepdim=True)
        return torch.tanh(p.transpose(0, 1)) * 0.5

    def counted_while(x):
        return while_loop(lambda i, v: i < 5, lambda i, v: (i + 1, v * 1.1 + 0.25),
                          (torch.tensor(0, device=x.device), x))[1]

    def cond(pred, x):
        return torch.cond(pred, lambda v: v * 2.0, lambda v: v - 1.0, (x,))

    def mlp_loss(params, x, y):
        h = torch.tanh(x @ params["w1"] + params["b1"])
        pred = h @ params["w2"] + params["b2"]
        return torch.mean((pred - y) ** 2)

    cases = []
    for name, fam in TORCH_FAMILIES.items():
        cases.append((name, fam["fn"], fam["args"](np.random.RandomState(0)),
                      dataclasses.replace(opts, **fam["options"]), fam))
    # StitchPipe's computation, whose plan takes the stitched emitter
    cases.append(("StitchPipe", stitch_pipe,
                  tuple(np.random.RandomState(0).randn(*sh).astype(np.float32)
                        for sh in ((512, 320), (320,))),
                  opts, {"module": stitch_pipeline_graph}))
    # the four granite-width functions under the parent's plan (TPU_V5E,
    # max_blocks 32) and under the default, the card's (H100)
    for name, fn, args, _, _ in model_width_cases():
        cases.append((name + TPU_TAG, fn, args, opts, None))
        cases.append((name, fn, args, StitchOptions(), None))
    f4 = np.float32
    g = np.random.default_rng(0)
    params = {"w1": g.normal(size=(8, 16), scale=0.3).astype(f4), "b1": np.zeros(16, f4),
              "w2": g.normal(size=(16, 4), scale=0.3).astype(f4), "b2": np.zeros(4, f4)}
    cases += [
        ("decode_loop_scan", decode_loop,
         (g.normal(size=(4, 16)).astype(f4), g.normal(size=(16, 16), scale=0.2).astype(f4)),
         opts, None),
        ("counted_while_loop", counted_while, (np.linspace(0.0, 1.0, 12, dtype=f4),), opts, None),
        ("cond_true", cond, (np.asarray(True), np.arange(8, dtype=f4)), opts, None),
        ("cond_false", cond, (np.asarray(False), np.arange(8, dtype=f4)), opts, None),
        ("grad_mlp_loss", torch.func.grad_and_value(mlp_loss),
         (params, g.normal(size=(32, 8)).astype(f4), g.normal(size=(32, 4)).astype(f4)),
         opts, None),
    ]
    return cases


def frontend_sources(cases):
    """The CUDA sources phase 12 builds: each function's plan, compiled here
    for the CPU (the same text the card's compile emits), and each family's
    hand-built module's, and ``donation_check``'s function's."""
    import dataclasses

    from repro_torch import stitch
    from repro_torch.core import compile_module

    from repro_torch.core.latency import H100

    out = []
    for _, fn, args, opts, fam in cases + [("donation", *donation_case(), None)]:
        if opts.device_spec is None:    # a default case: the card plans with H100
            opts = dataclasses.replace(opts, device_spec=H100)
        out += sources_of(stitch(fn, options=opts, device="cpu").lower(*args).compile())
        if fam is not None:
            out += sources_of(compile_module(fam["module"](), opts, device="cpu"))
    return out


def frontend_phase(dev, cases):
    """Phase 12: ``repro_torch.stitch`` on the card, the device left at its
    default, eager and replayed (see the module docstring).  Returns the
    rows and each emitter's launches in the counted eager calls."""
    import dataclasses

    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    from repro_torch import stitch
    from repro_torch.core import compile_module, reference_execute

    rows, by_emitter = [], {"emit_fusion": 0, "emit_stitched_fusion": 0}
    for name, fn, args, opts, fam in cases:
        dargs = pytree.tree_map(lambda a: torch.as_tensor(a, device=dev), args)
        st_e = stitch(fn, options=dataclasses.replace(opts, jit_replay=False))
        st_r = stitch(fn, options=opts)
        if st_e.device is not None or st_r.device is not None:
            raise SystemExit(f"frontend {name}: the device is not left at its default")
        t0 = time.perf_counter()
        st_e(*dargs)                                  # capture, lower, compile, run
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        lowered = st_e.lower()
        comp_e = lowered.compile()
        if comp_e.stats.device != "cuda":
            raise SystemExit(f"frontend {name}: compiled for {comp_e.stats.device}")
        progs = programs_of(comp_e)
        for p in progs.values():
            p.launches = 0
        out_e = st_e(*dargs)
        torch.cuda.synchronize()
        got = sum(p.launches for p in progs.values())
        want = planned_launches(comp_e)
        never = [p.name for p in progs.values() if p.launches == 0]
        if got != want or never:
            raise SystemExit(f"frontend {name}: {got} launches, planned {want}; never launched {never}")
        for p in progs.values():
            by_emitter[p.emitter] += p.launches
        s = comp_e.stats
        stats = (s.stitched_kernels, s.standalone_kernels, s.library_calls)
        if fam is not None:
            hand = compile_module(fam["module"](), opts, device=dev)
            hs = hand.stats
            if stats != (hs.stitched_kernels, hs.standalone_kernels, hs.library_calls) \
                    or want != planned_launches(hand):
                raise SystemExit(f"frontend {name}: plan {stats}, {want} launches; the hand-built "
                                 f"graph's ({hs.stitched_kernels}, {hs.standalone_kernels}, "
                                 f"{hs.library_calls}), {planned_launches(hand)} launches")
        if st_e.num_fallbacks or st_r.num_fallbacks:
            raise SystemExit(f"frontend {name}: {st_e.num_fallbacks + st_r.num_fallbacks} fallbacks")
        # right: against the plain function on the card and the lowered
        # module's reference_execute, on the same inputs
        leaves = pytree.tree_leaves(dargs)
        feeds = dict(zip(lowered.param_names, leaves, strict=True))
        flat_e = pytree.tree_leaves(out_e)
        plain = pytree.tree_leaves(fn(*dargs))
        ref = reference_execute(lowered.module, feeds, device=dev)
        ref_flat = [ref[n] for n in lowered._lowered.output_names]
        err = 0.0
        for label, want_flat in (("plain PyTorch", plain), ("reference_execute", ref_flat)):
            if len(want_flat) != len(flat_e):
                raise SystemExit(f"frontend {name}: {len(flat_e)} outputs, {label} {len(want_flat)}")
            for i, (g, w) in enumerate(zip(flat_e, want_flat, strict=True)):
                if g.device.type != "cuda" or tuple(g.shape) != tuple(w.shape) \
                        or not bool(torch.isfinite(g.double()).all()):
                    raise SystemExit(f"frontend {name}: output {i} is {g.device} {tuple(g.shape)}, "
                                     f"{label} {tuple(w.shape)}, or not finite")
                e, ok = max_err(g, w.to(g.dtype), None)
                err = max(err, e)
                if not ok:
                    raise SystemExit(f"frontend {name}: output {i} vs {label} {e:.3e} (TOL {TOL})")
        # replayed: two default calls through stitch (the path the plan's
        # replay_mode picks), then the plan's CUDA graph whatever the mode
        # (jit_execute, past stitch), each bit for bit the eager plan's (a
        # library dot may round otherwise under capture, held at TOL as in
        # phase 7)
        st_r(*dargs)
        lowered_r = st_r.lower()
        comp_r = lowered_r.compile()
        ex_r = comp_r.executable
        eager_d = comp_e(feeds)
        eager_flat = [eager_d[n] for n in lowered._lowered.output_names]
        replayed = [pytree.tree_leaves(st_r(*dargs)) for _ in range(2)]
        replayed += [[r[n] for n in lowered_r._lowered.output_names]
                     for r in (ex_r.jit_execute(feeds) for _ in range(2))]
        torch.cuda.synchronize()
        bitwise = all(same(g, w) for r in replayed for g, w in zip(r, eager_flat, strict=True))
        held = []
        if not bitwise:
            held = [i.name for i in ex_r.plan.standalone if i.is_library_call]
            for r in replayed:
                for i, (g, w) in enumerate(zip(r, eager_flat, strict=True)):
                    e, ok = max_err(g, w, None)
                    if not held or not ok:
                        raise SystemExit(f"frontend {name}: output {i} replayed vs eager {e:.3e}, "
                                         f"library dots {held}")
        # numbers: µs per call through stitch (eager, and the default path)
        # and of the plan's own replay, the plain function's device kernels
        # against the plan's, device µs and idle shares
        eager_us = 1e3 * time_ms(lambda: st_e(*dargs), CALLS)
        default_us = 1e3 * time_ms(lambda: st_r(*dargs), CALLS)
        replay_us = 1e3 * time_ms(lambda: ex_r.jit_execute(feeds), CALLS)
        plain_us = 1e3 * time_ms(lambda: fn(*dargs), CALLS)
        plan_e = planned_by_program(comp_e)
        e_seen, e_by = profiled_launches(f"frontend {name} eager", lambda: st_e(*dargs), plan_e)
        r_seen, r_by = profiled_launches(f"frontend {name} replayed",
                                         lambda: ex_r.jit_execute(feeds), planned_by_program(comp_r))
        p_seen, p_by = device_profile(lambda: fn(*dargs), PROFILED_CALLS, f"plain {name}")
        e_dev, r_dev, p_dev = sum(e_by.values()), sum(r_by.values()), sum(p_by.values())
        mode = comp_r.stats.replay_mode
        d_dev = r_dev if mode == "graph" else e_dev
        row = {
            "function": name, "args": [list(np.shape(a)) for a in pytree.tree_leaves(args)],
            "capture_s": st_e.capture_s, "lower_s": st_e.lower_s,
            "compile_s": s.compile_time_s, "nvcc_s": s.build_time_s, "first_call_s": first_call_s,
            "fused_kernels": s.stitched_kernels, "standalone": s.standalone_kernels,
            "library_dots": s.library_calls, "loop_calls": s.loop_calls,
            "sub_kernels": s.sub_kernels, "launches_per_call": want,
            "stitched_emitter_kernels": s.stitch_lowered_kernels,
            "fallbacks": st_e.num_fallbacks + st_r.num_fallbacks, "max_abs_err": err,
            "replay_mode": mode, "bitwise_replay_vs_eager": bitwise,
            "held_at_tol": held,
            "plain_device_kernels": p_seen, "stitched_device_kernels": e_seen,
            "replay_device_kernels": r_seen,
            # through stitch: the eager loop, and the default call (the path
            # replay_mode picks); the plan's own replay (jit_execute) leaves
            # out stitch's host path
            "eager_us_per_call": eager_us, "default_us_per_call": default_us,
            "plan_replay_us_per_call": replay_us, "plain_us_per_call": plain_us,
            "eager_device_us_per_call": e_dev, "replay_device_us_per_call": r_dev,
            "plain_device_us_per_call": p_dev,
            "eager_idle_share": 1.0 - e_dev / eager_us,
            "default_idle_share": 1.0 - d_dev / default_us,
            "plan_replay_idle_share": 1.0 - r_dev / replay_us,
            "plain_idle_share": 1.0 - p_dev / plain_us,
        }
        row["kernel_launches"] = launch_shapes(comp_e.kernels)
        row["dot_kernels"] = dot_lines(f"frontend {name}", comp_e.kernels, e_by)
        rows.append(row)
        print(f"frontend {name}: capture {row['capture_s']:.3f} s, lower {row['lower_s']:.3f} s, "
              f"compile {row['compile_s']:.3f} s; fused={s.stitched_kernels} "
              f"(stitched emitter {s.stitch_lowered_kernels}) standalone={s.standalone_kernels} "
              f"library={s.library_calls} loops={s.loop_calls}; {want} launches a call as planned"
              f"{' = the hand-built graph' if fam is not None else ''}; 0 fallbacks; "
              f"err={err:.2e} vs plain and reference_execute; replay "
              f"{'bitwise' if bitwise else 'held at TOL'} vs eager; device kernels a call "
              f"plain={p_seen} stitched={e_seen} replayed={r_seen}; us_per_call through stitch "
              f"eager={eager_us:.1f} default ({mode})={default_us:.1f}, the plan's "
              f"replay={replay_us:.1f}, plain={plain_us:.1f}; device_us "
              f"eager={e_dev:.2f} replay={r_dev:.2f} plain={p_dev:.2f}; idle_share "
              f"eager={row['eager_idle_share']:.3f} default={row['default_idle_share']:.3f} "
              f"plan_replay={row['plan_replay_idle_share']:.3f} "
              f"plain={row['plain_idle_share']:.3f}")
        if name == "fig3_attention" and (s.stitched_kernels, s.standalone_kernels,
                                         s.library_calls) != (1, 0, 0):
            print(f"frontend fig3_attention at granite width: {s.stitched_kernels} fused "
                  f"kernels, {s.standalone_kernels} standalone, {s.library_calls} library dots, "
                  f"not one stitched kernel, under the planner's budgets (vmem_limit "
                  f"{opts.vmem_limit} bytes, replicate_limit {opts.replicate_limit}, "
                  f"stitch_max_blocks {opts.stitch_max_blocks}, max_blocks {opts.max_blocks}):")
            print(st_e.report())
    donation_check(dev)
    return rows, by_emitter


#: the 64-bit cases of phase 4: x * 1.5 + 0.25 over 2,147,549,184 f32
#: elements, past 2^31 - 1 (8.59 GB in and 8.59 GB out), and over
#: 1,310,760,000, whose grid-stride loop's variable passes 2^31 - 1
INDEX64_SHAPES = ((65536, 32769), (40000, 32769))
#: rows of it compared with torch at a time (no third full-size copy)
INDEX64_CHUNK = 4096
#: the functions whose fused dots phase 4 holds against the register-tile
#: loop (``register_tile_loops``) bit for bit under ``TPU_V5E``
STAGED_CASES = ("NMT", "fig3_attention", "fig3_attention_bf16")
#: one rounding step of bf16: a bf16 dot on the tensor cores sums its exact
#: products in another order than the plain version, so an output may round
#: to its neighbour (at most 2^-7 of it); outputs are held within one step of
#: themselves plus one of the largest output
BF16_STEP = 2.0 ** -7
#: the benchmark cell whose bf16 layer phase 4 runs at its own shapes
#: (``staged_cell_check``), and the seed of its weights and input
STAGED_CELL, STAGED_CELL_SEED = "granite-moe-3b-a800m.attn-bf16.prefill-4k", 3400000301
#: what marks each staging rule of a dot on the tensor cores in a kernel's
#: text: its k-major operand staged 16 bytes at a time, its whole depth in
#: one k step, the next k step held in registers, two blocks an SM
STAGING_RULES = {"16-byte staging": "*reinterpret_cast<const uint4*>(&",
                 "one k step": "for (int k0 = 0; k0 < 64; k0 += 64)",
                 "prefetch": "pa[ek] = ", "two blocks an SM": "__launch_bounds__(512, 2)"}
#: elements of an output compared at a time (``bf16_close``)
CLOSE_CHUNK = 1 << 26


def index64_module(shape):
    import numpy as np

    from repro_torch.core import trace

    return trace(lambda b, x: x * 1.5 + 0.25, ("x", shape, np.float32), name="index64")


def index64_check(dev, shape):
    """Phase 4's 64-bit case: the generated map over ``shape`` f32
    under the card's default plan, which must index in 64 bits; its output
    held exactly, chunk by chunk, against torch: against x * 1.5 + 0.25
    rounded once (the FMA nvcc forms) or twice (torch's two ops), whichever
    the whole output equals."""
    import torch

    from repro_torch.core import StitchOptions, compile_module

    compiled = compile_module(index64_module(shape), StitchOptions(jit_replay=False), device=dev)
    (kernel,) = compiled.kernels
    if "64-bit indices and offsets" not in kernel.fn.source.splitlines()[0]:
        raise SystemExit(f"index64: {kernel.fn.name} does not index in 64 bits")
    x = torch.rand(shape, device=dev)
    kernel.fn.launches = 0
    (y,) = kernel.fn(x)
    torch.cuda.synchronize()
    if kernel.fn.launches != 1:
        raise SystemExit(f"index64: {kernel.fn.launches} launches, expected 1")
    once = twice = True
    for r in range(0, shape[0], INDEX64_CHUNK):
        xs, ys = x[r:r + INDEX64_CHUNK], y[r:r + INDEX64_CHUNK]
        once = once and torch.equal(ys, (xs.double() * 1.5 + 0.25).float())
        twice = twice and torch.equal(ys, xs * 1.5 + 0.25)
    if not (once or twice):
        raise SystemExit("index64: the 64-bit kernel's output differs from torch's")
    _, by_name = profiled_launches("index64", lambda: kernel.fn.launch(x, device=dev),
                                   {kernel.fn.name: 1}, total=1)
    device_us = sum(t for k, t in by_name.items() if kernel.fn.name in k)
    nbytes = 2 * x.numel() * 4
    row = {"shape": list(shape), "elements": x.numel(), "kernel": kernel.fn.name,
           "grid": geometry(kernel.fn.source)["grid"], "exact": "fma" if once else "two roundings",
           "device_us": device_us, "bound_us": 1e6 * nbytes / HBM_BYTES_PER_S}
    del x, y
    torch.cuda.empty_cache()
    print(f"index64: x * 1.5 + 0.25 over {shape} f32 ({row['elements']} elements) in 64-bit "
          f"indices, grid {row['grid']}, equal to torch ({row['exact']}); device_us "
          f"{device_us:.1f}, bound {row['bound_us']:.1f}")
    return row


@contextlib.contextmanager
def register_tile_loops():
    """A context in which the emitters put every fused dot on the
    register-tile loop: the launch geometry offers no dot a staging
    (``geometry.staged_dot_tiling`` gives None), so each launch record's
    dot tilings are None and a pure map's grid is that loop's.  Under
    ``TPU_V5E`` the planner reads no launch record: the plan is the same."""
    from unittest import mock

    from repro_torch.core import geometry

    with mock.patch.object(geometry, "staged_dot_tiling", lambda *a: None):
        yield


def staged_case(name, dev, spec_name, stage=True):
    """(compiled, feeds) of one of ``STAGED_CASES`` on ``dev`` under
    ``spec_name``'s plan, its dots staged or (``stage`` False) on the
    register-tile loop (``register_tile_loops``): NMT at its graph's size,
    the Figure-3 attention at granite width, in f32 or (``_bf16``) in bf16."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import stitch
    from repro_torch.core import StitchOptions, compile_module
    from repro_torch.core.latency import H100, TPU_V5E
    from repro_torch.graphs import ALL_GRAPHS, random_feeds

    opts = StitchOptions(device_spec=TPU_V5E if spec_name == "TPU_V5E" else H100, jit_replay=False)
    loops = contextlib.nullcontext() if stage else register_tile_loops()
    bf16 = name.endswith("_bf16")
    name = name.removesuffix("_bf16")
    if name == "NMT":
        module = ALL_GRAPHS["NMT"]()
        feeds = random_feeds(module, np.random.RandomState(0))
        with loops:
            compiled = compile_module(module, opts, device=dev)
        return module, compiled, {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}
    (fn, args) = next((fn, args) for n, fn, args, _, _ in model_width_cases() if n == name)
    if bf16:
        args = tuple(torch.as_tensor(a).to(torch.bfloat16) for a in args)
    lowered = stitch(fn, options=dataclasses.replace(opts, max_blocks=FRONTEND_MAX_BLOCKS)
                     if spec_name == "TPU_V5E" else opts, device=dev).lower(*args)
    feeds = dict(zip(lowered.param_names, args, strict=True))
    with loops:
        compiled = lowered.compile()
    return lowered.module, compiled, {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}


def staged_sources():
    """Phase 4's compiles of ``STAGED_CASES`` (under ``TPU_V5E`` on both
    loops, under ``H100`` staged) and the 64-bit cases, planned for the
    CPU: the text the card's compiles emit, built in phase 2."""
    out = [staged_case_cpu(name, spec, stage) for name in STAGED_CASES
           for spec, stage in (("TPU_V5E", True), ("TPU_V5E", False), ("H100", True))
           if spec == "H100" or not name.endswith("_bf16")]
    from repro_torch.core import StitchOptions, compile_module
    from repro_torch.core.latency import H100

    return out + [compile_module(index64_module(shape), StitchOptions(device_spec=H100),
                                 device="cpu").cuda_source for shape in INDEX64_SHAPES]


def staged_case_cpu(name, spec_name, stage):
    import torch

    return staged_case(name, torch.device("cpu"), spec_name, stage)[1].cuda_source


def dot_lines(label, kernels, by_name):
    """For each of ``kernels`` (generated kernels) that holds a fused dot:
    its device µs (from ``by_name``), which loop each dot took (staged or
    the register-tile loop), its CUDA blocks and its share of its bound."""
    out = []
    for k, shape in zip(kernels, launch_shapes(kernels), strict=True):
        if not any(m.opcode == "dot" for m in k.fusion.members):
            continue
        nbytes, ops = work(k)
        b_us, o_us = 1e6 * nbytes / HBM_BYTES_PER_S, 1e6 * ops / F32_OPS_PER_S
        us = sum(t for n, t in by_name.items() if k.fn.name in n)
        row = {"kernel": k.fn.name, "dots": shape["dots"], "staged": "staged in" in shape["dots"],
               "cuda_blocks": shape["cuda_blocks"], "threads": shape["threads"],
               "smem_bytes": shape["smem_bytes"], "device_us": us,
               "bound_us": max(b_us, o_us), "bound_by": "bytes" if b_us >= o_us else "operations",
               "share_of_bound": max(b_us, o_us) / us if us else None}
        out.append(row)
        print(f"  dot kernel {label} {k.fn.name}: {row['dots']}; {row['cuda_blocks']} CUDA blocks "
              f"x {row['threads']}, {row['smem_bytes']} B shared; device_us "
              f"{us if us else 'not measured'}; bound {row['bound_us']:.2f} ({row['bound_by']}); "
              f"share of bound {row['share_of_bound'] if us else 'not measured'}")
    return out


def bf16_close(g, w):
    """(largest error, within ``BF16_STEP``): each element of ``g`` within
    one step of ``w``'s element plus one step of ``w``'s largest, compared
    ``CLOSE_CHUNK`` elements at a time (a layer's scores are 1.6e9)."""
    g, w = g.reshape(-1), w.reshape(-1)
    top = max([0.0] + [float(w[i:i + CLOSE_CHUNK].double().abs().max())
                       for i in range(0, w.numel(), CLOSE_CHUNK)])
    err, ok = 0.0, True
    for i in range(0, w.numel(), CLOSE_CHUNK):
        gi, wi = g[i:i + CLOSE_CHUNK].double(), w[i:i + CLOSE_CHUNK].double()
        d = (gi - wi).abs()
        err = max(err, float(d.max()))
        ok = ok and bool((d <= BF16_STEP * wi.abs() + BF16_STEP * top).all())
    return err, ok


def staged_cell_check(dev):
    """Phase 4's cell case: the benchmark's bf16 layer (``STAGED_CELL``)
    at its own shapes under the card's default plan: both its dot kernels
    on the tensor cores, between them taking every rule of
    ``STAGING_RULES``, and every generated kernel against its plain
    version on the inputs one call gave it, at ``BF16_STEP``."""
    import torch

    from repro_torch import stitch
    from repro_torch.core import StitchOptions
    from repro_torch.core.latency import H100
    from stitchbench import harness

    cell = harness.load_cell(STAGED_CELL)
    prog = cell.program
    fn = prog.build(cell.config, cell.batch, cell.seq)
    layers, (cos, sin), (x,) = prog.make_inputs(cell.config, cell.batch, cell.seq,
                                                STAGED_CELL_SEED, 1, dev)
    args = (x, *layers[0].values(), cos, sin)
    lowered = stitch(fn, options=StitchOptions(device_spec=H100, jit_replay=False),
                     device=dev).lower(*args)
    compiled = lowered.compile()
    feeds = dict(zip(lowered.param_names, args, strict=True))
    dots = [k for k in compiled.kernels if "; dots: " in k.fn.source.splitlines()[0]]
    loops = [d for k in dots for d in k.fn.source.splitlines()[0].split("; dots: ")[1].split("; ")]
    if len(loops) != 2 or not all("on the tensor cores" in d for d in loops):
        raise SystemExit(f"staged {STAGED_CELL}: its dots are not both on the tensor cores: {loops}")
    rules = {rule: [k.fn.name for k in dots if mark in k.fn.source]
             for rule, mark in STAGING_RULES.items()}
    if not all(rules.values()):
        raise SystemExit(f"staged {STAGED_CELL}: no dot kernel takes "
                         f"{[r for r, ks in rules.items() if not ks]}")
    inputs = {}
    for k in compiled.kernels:
        def record(*a, device, out=None, _fn=k.fn, _launch=k.fn.launch):
            inputs.setdefault(id(_fn), [t.clone() for t in a])
            return _launch(*a, device=device) if out is None else _launch(*a, device=device, out=out)
        k.fn.launch = record
    try:
        got = compiled(feeds)
    finally:
        for k in compiled.kernels:
            k.fn.__dict__.pop("launch", None)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(v).all()) for v in got.values()):
        raise SystemExit(f"staged {STAGED_CELL}: an output is not finite")
    err = 0.0
    for k in compiled.kernels:
        a = inputs.pop(id(k.fn))
        for g, w in zip(k.fn.launch(*a, device=dev), k.fn.plain(*a, device=dev), strict=True):
            e, ok = bf16_close(g, w)
            err = max(err, e)
            if not ok:
                raise SystemExit(f"staged {STAGED_CELL} [H100] {k.fn.name}: kernel vs plain {e:.3e}")
        del a
        torch.cuda.empty_cache()
    _, by = profiled_launches(f"staged {STAGED_CELL} H100", lambda: compiled(feeds),
                              planned_by_program(compiled))
    row = {"case": STAGED_CELL, "tokens": cell.batch * cell.seq, "tpu_v5e_bitwise": "f32 cases only",
           "staging_rules": rules,
           "H100": {"device_us": sum(by.values()), "kernels": len(compiled.kernels),
                    "max_abs_err": err,
                    "dot_kernels": dot_lines(f"{STAGED_CELL} [H100]", compiled.kernels, by)}}
    print(f"staged {STAGED_CELL}: {cell.batch} x {cell.seq} tokens, both dots on the tensor cores, "
          f"rules {rules}; H100 {row['H100']['device_us']:.2f} in {len(compiled.kernels)} kernels, "
          f"err {err:.2e} vs plain")
    del compiled, got, feeds, layers, x
    torch.cuda.empty_cache()
    return row


def staged_dots_check(dev):
    """Phase 4: each f32 case of ``STAGED_CASES`` under ``TPU_V5E`` (the
    reference's plan, which staging leaves unchanged) with its dots staged
    and on the register-tile loop, bit for bit; and every case under the
    card's default plan (``H100``) against its plain kernels and
    ``reference_execute`` at ``TOL`` (a bf16 case, whose dots run on the
    tensor cores and sum in another order than the register-tile loop, at
    ``BF16_STEP``: no bitwise check); with each dot kernel's line
    (``dot_lines``); then the benchmark's bf16 layer at its own shapes
    (``staged_cell_check``)."""
    import torch

    from repro_torch.core import reference_execute

    def close(g, w, bf16):
        return bf16_close(g, w) if bf16 else max_err(g, w, None)

    out = []
    for name in STAGED_CASES:
        bf16 = name.endswith("_bf16")
        if bf16:
            row = {"case": name, "tpu_v5e_bitwise": "f32 cases only"}
            module, h100, feeds = staged_case(name, dev, "H100")
            heads = [k.fn.source.splitlines()[0] for k in h100.kernels]
            loops = [d for h in heads if "; dots: " in h for d in h.split("; dots: ")[1].split("; ")]
            if not loops or not all("on the tensor cores" in d for d in loops):
                raise SystemExit(f"staged {name}: a bf16 dot is not on the tensor cores: {loops}")
        else:
            row = staged_register_tile_check(name, dev)
            module, h100, feeds = staged_case(name, dev, "H100")
        got = h100(feeds)
        ref = reference_execute(module, feeds, device=dev)
        err = 0.0
        for root, w in ref.items():
            e, ok = close(got[root], w, bf16)
            err = max(err, e)
            if not ok or not bool(torch.isfinite(got[root]).all()):
                raise SystemExit(f"staged {name} [H100]: {root} vs reference_execute {e:.3e}")
        inputs = {}
        for k in h100.kernels:
            def record(*a, device, _fn=k.fn, _launch=k.fn.launch):
                inputs.setdefault(id(_fn), [t.clone() for t in a])
                return _launch(*a, device=device)
            k.fn.launch = record
        h100(feeds)
        for k in h100.kernels:
            del k.fn.launch
            a = inputs[id(k.fn)]
            for g, w in zip(k.fn.launch(*a, device=dev), k.fn.plain(*a, device=dev), strict=True):
                e, ok = close(g, w, bf16)
                err = max(err, e)
                if not ok:
                    raise SystemExit(f"staged {name} [H100] {k.fn.name}: kernel vs plain {e:.3e}")
        _, by = profiled_launches(f"staged {name} H100", lambda: h100(feeds),
                                  planned_by_program(h100))
        row["H100"] = {"device_us": sum(by.values()), "kernels": len(h100.kernels),
                       "max_abs_err": err, "dot_kernels": dot_lines(f"{name} [H100]", h100.kernels, by)}
        out.append(row)
        v5e = ("TPU_V5E bitwise: f32 cases only" if bf16 else
               f"TPU_V5E staged {row['TPU_V5E staged']['device_us']:.2f} device us, register-tile "
               f"loop {row['TPU_V5E register-tile']['device_us']:.2f}, bit for bit")
        print(f"staged {name}: {v5e}; H100 {row['H100']['device_us']:.2f} in "
              f"{row['H100']['kernels']} kernels, err {err:.2e} vs plain and reference_execute")
    return out + [staged_cell_check(dev)]


def staged_register_tile_check(name, dev):
    """An f32 case of ``STAGED_CASES`` under ``TPU_V5E`` with its dots
    staged and on the register-tile loop: the same plan, and the same
    outputs bit for bit; the row of ``staged_dots_check`` with both
    compiles' device µs and dot lines."""
    import torch

    _, staged, feeds = staged_case(name, dev, "TPU_V5E")
    _, loop, _ = staged_case(name, dev, "TPU_V5E", stage=False)
    if [k.solution.blocks if k.solution else k.blocks for k in staged.kernels] != \
            [k.solution.blocks if k.solution else k.blocks for k in loop.kernels]:
        raise SystemExit(f"staged {name}: the TPU_V5E plan changed with the dot loop")
    # two compiles name their roots apart: outputs in the plan's order
    got, want = list(staged(feeds).values()), list(loop(feeds).values())
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if not same(g, w):
            e, _ = max_err(g, w, None)
            raise SystemExit(f"staged {name} [TPU_V5E]: output {i} staged vs register-tile "
                             f"loop differs (max {e:.3e})")
    row = {"case": name, "tpu_v5e_bitwise": True}
    for label, compiled in (("TPU_V5E staged", staged), ("TPU_V5E register-tile", loop)):
        _, by = profiled_launches(f"staged {name} {label}", lambda c=compiled: c(feeds),
                                  planned_by_program(compiled))
        row[label] = {"device_us": sum(by.values()),
                      "dot_kernels": dot_lines(f"{name} [{label}]", compiled.kernels, by)}
    return row


def launch_shapes(kernels):
    """Each of ``kernels`` (a plan's generated kernels) as its source's
    header and phase comments state it: emitter, plan blocks, CUDA blocks
    (a cooperative kernel's most), threads, shared memory and workspace
    bytes a block, the bytes of its slots in shared memory and in the
    workspace, and the loop each of its fused dots took."""
    import re

    out = []
    for k in kernels:
        src = k.fn.source
        head = re.search(r"(\d+) plan blocks(?: in all)?, (?:one launch of|one cooperative launch "
                         r"of up to) (\d+) blocks of (\d+) threads, (\d+) bytes of shared memory "
                         r"a block, (\d+) workspace bytes", src)
        dots = re.search(r"; dots: (.*)$", src.splitlines()[0])
        out.append({
            "dots": dots.group(1) if dots else "",
            "fusion": k.fusion.name, "kernel": k.fn.name, "emitter": k.fn.emitter,
            "plan_blocks": int(head.group(1)), "cuda_blocks": int(head.group(2)),
            "threads": int(head.group(3)), "smem_bytes": int(head.group(4)),
            "workspace_bytes": int(head.group(5)),
            "slot_bytes_in_smem": sum(int(b) for b in re.findall(
                r"slots (\d+) bytes in shared memory", src)),
            "slot_bytes_in_workspace": sum(int(b) for b in re.findall(
                r"slots (\d+) bytes in a per-block workspace region", src)),
        })
    return out


def model_width_numbers(dev, rows):
    """Phase 12's four granite-width functions, each under the default (the
    card's plan) beside its ``TPU_V5E`` plan in the same run: plan and CUDA
    blocks, slot bytes in shared memory and in the workspace, device µs;
    beside them the plain function's, the one PyTorch call's (held against
    the plain function at ``TOL``) and the bound (the arguments read once
    and the output written once at ``HBM_BYTES_PER_S``, the products'
    operations at ``F32_OPS_PER_S``).  Fails if a default plan keeps a slot
    in the workspace."""
    import numpy as np
    import torch

    by_name = {r["function"]: r for r in rows}
    out = []
    for name, fn, args, library, ops in model_width_cases():
        dargs = [torch.as_tensor(a, device=dev) for a in args]
        plain = fn(*dargs)
        row = {"function": name, "args": [list(np.shape(a)) for a in args]}
        for label, key in (("default", name), ("tpu_v5e", name + TPU_TAG)):
            r = by_name[key]
            row[label] = {"device_us": r["eager_device_us_per_call"],
                          "launches": r["launches_per_call"], "max_abs_err": r["max_abs_err"],
                          "kernels": r["kernel_launches"]}
        kept = [k for k in row["default"]["kernels"] if k["slot_bytes_in_workspace"]
                or (k["emitter"] == "emit_fusion" and k["workspace_bytes"])]
        if kept:
            raise SystemExit(f"model width {name}: the default plan keeps slots in the workspace: "
                             f"{kept}")
        row["plain_device_us"] = by_name[name]["plain_device_us_per_call"]
        if library is not None:
            got = library(*dargs)
            e, ok = max_err(got, plain, None)
            if not ok:
                raise SystemExit(f"model width {name}: the library call vs plain {e:.3e}")
            _, lib_by = device_profile(lambda: library(*dargs), PROFILED_CALLS, f"library {name}")
            row["library_device_us"] = sum(lib_by.values())
            row["library_max_abs_err"] = e
        else:
            row["library_device_us"] = None
        nbytes = sum(a.nbytes for a in args) + plain.numel() * plain.element_size()
        b_us, o_us = 1e6 * nbytes / HBM_BYTES_PER_S, 1e6 * ops / F32_OPS_PER_S
        row.update(bound_us=max(b_us, o_us), bound_by="bytes" if b_us >= o_us else "operations")
        d, t = row["default"], row["tpu_v5e"]
        row["default_over_tpu_v5e"] = d["device_us"] / t["device_us"]
        out.append(row)

        def shape(p):
            return ", ".join(f"{k['plan_blocks']} plan / {k['cuda_blocks']} CUDA blocks x "
                             f"{k['threads']} (slots {k['slot_bytes_in_smem']} B smem, "
                             f"{k['slot_bytes_in_workspace']} B workspace)" for k in p["kernels"])
        print(f"model width {name}: default {d['device_us']:.2f} device us [{shape(d)}]; "
              f"TPU_V5E {t['device_us']:.2f} [{shape(t)}]; ratio "
              f"{row['default_over_tpu_v5e']:.3f}; plain {row['plain_device_us']:.2f}; library "
              f"{row['library_device_us'] if row['library_device_us'] is not None else 'none'}; "
              f"bound {row['bound_us']:.2f} ({row['bound_by']})")
    return out


def donation_case():
    """The function, numpy arguments and options of ``donation_check``."""
    import numpy as np
    import torch

    def fn(x, w, y):
        return torch.tanh(torch.exp(x) @ w) + y

    rng = np.random.RandomState(2)
    args = tuple(rng.randn(256, 256).astype(np.float32) * 0.1 for _ in range(3))
    return fn, args, ref_options(max_blocks=FRONTEND_MAX_BLOCKS, fuse_dot=False, jit_replay=False)


def donation_check(dev):
    """``donate_argnums`` on the card: in the eager loop the second kernel of
    tanh(exp(x) @ w) + y (the dot a library call) writes its output into
    x's buffer through the launcher's ``out``; w and y stay as they were,
    and the result is the undonated plan's, bit for bit."""
    import torch

    from repro_torch import stitch

    fn, args, opts = donation_case()
    x, w, y = (torch.as_tensor(a, device=dev) for a in args)
    want = stitch(fn, options=opts)(x.clone(), w, y)
    w0, y0 = w.clone(), y.clone()
    st = stitch(fn, options=opts, donate_argnums=(0,))
    got = st(x, w, y)
    torch.cuda.synchronize()
    if st.stats.donated_buffers != 1 or got.data_ptr() != x.data_ptr() or not same(got, want) \
            or not same(w, w0) or not same(y, y0):
        raise SystemExit(f"frontend donation: {st.stats.donated_buffers} donated buffers, output "
                         f"in x's buffer {got.data_ptr() == x.data_ptr()}, equal to the undonated "
                         f"plan {same(got, want)}, w and y kept {same(w, w0) and same(y, y0)}")
    print("frontend donation: the second kernel wrote its output into the donated input's "
          "buffer; the other inputs unchanged; bit for bit the undonated plan's")


# ---- phase 13: the models --------------------------------------------------------
MODEL_ARCH = "granite-moe-3b-a800m"
#: card against CPU in f32 with TF32 off (rtol = atol): the reduced families'
#: logits differ by a few f32 ulps of sums taken in another order; at granite's
#: full width the 1536- and 2048-term sums move them by a few 1e-5
FAMILY_TOL = 1e-4
GRANITE_CPU_TOL = 1e-3
#: decode_chunk against forward at granite's full depth in f32: the reference's
#: test_decode_matches_forward holds them at 2e-3
DECODE_TOL = 2e-3
GRANITE_CPU_LAYERS = 2
PROMPT = (4, 64)                    # decode against forward, paged against slot
PROMPT_LENGTHS = (64, 50, 33, 64)   # ragged; the last row inactive in the paged check
PAGED_BLOCK = 16
#: the slot ring's SLOT_MAX_LEN + 1 slots (its parking slot) equal the paged
#: view's 5 blocks of 16: both read views have one shape, so bit for bit
SLOT_MAX_LEN = 79
FORWARD_SHAPE = (4, 512)
DECODE_BATCH, DECODE_CONTEXT, DECODE_CHUNK = 4, 512, 32
DECODE_MAX_LEN = 1024
MODEL_CALLS = 5                     # timed forward calls (CUDA events), after as many warm
DECODE_CALLS = 20                   # timed decode steps, after as many warm
MODEL_PROFILED = 3                  # calls traced by torch.profiler


def model_batch(cfg, B, S, seed):
    """Seeded tokens (and the VLM's patches, Whisper's frames), as numpy."""
    import numpy as np

    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, min(cfg.vocab_size, 4096), (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(B, cfg.num_patches, cfg.d_model).astype(np.float32) * 0.02
    if cfg.family == "audio":
        batch["frames"] = rng.randn(B, cfg.encoder_seq, cfg.d_model).astype(np.float32) * 0.02
    return batch


def held(label, got, want, tol):
    """Max |got - want|; the run fails past rtol = atol = ``tol`` or on a
    value that is not finite."""
    import torch

    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        raise SystemExit(f"models {label}: shape {tuple(got.shape)}, expected {tuple(want.shape)}")
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or not torch.allclose(got, want, rtol=tol, atol=tol):
        raise SystemExit(f"models {label}: max |err| {err:.3g} past {tol}")
    return err


def family_checks(dev):
    """Every architecture at ``reduced_config``: ``forward`` and
    ``decode_chunk`` on the card against the port on the CPU, the same
    seeded weights, f32."""
    import numpy as np

    from repro_torch import models
    from repro_torch.configs import ARCHITECTURES, get_config, reduced_config
    from repro_torch.models.module import tree_map

    rows = []
    for arch in sorted(ARCHITECTURES):
        cfg = reduced_config(get_config(arch))
        cpu = models.init_params(cfg, 0, device="cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        batch = model_batch(cfg, 2, 16, seed=1)
        f_err = held(f"{arch} forward", models.forward(card, batch, cfg),
                     models.forward(cpu, batch, cfg), FAMILY_TOL)
        toks, lengths = batch["tokens"][:, :8], np.array([8, 5], np.int32)
        outs = []
        for params, where in ((cpu, "cpu"), (card, dev)):
            cache = models.init_cache(cfg, 2, 16, device=where)
            if cfg.is_encoder_decoder:     # Whisper's cache takes the encoder's cross K/V
                xk, xv = models.prefill_cross_attention(params, batch["frames"], cfg, 2)
                cache["xk"].copy_(xk)
                cache["xv"].copy_(xv)
            outs.append(models.decode_chunk(params, cache, toks, 0, cfg, lengths=lengths)[0])
        d_err = held(f"{arch} decode_chunk", outs[1], outs[0], FAMILY_TOL)
        rows.append({"arch": arch, "forward_err": f_err, "decode_chunk_err": d_err})
        print(f"models {arch}: reduced, card vs cpu, f32: forward max |err| {f_err:.3g}, "
              f"decode_chunk {d_err:.3g} (tol {FAMILY_TOL})")
    return rows


def granite_checks(dev):
    """granite-moe-3b-a800m at full width in f32 (see the module docstring):
    2 layers on the card against the CPU; at full depth with dense MoE,
    decode_chunk against forward, and the paged cache against the slot
    cache bit for bit."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models.module import tree_map

    base = dataclasses.replace(get_config(MODEL_ARCH), dtype="float32")
    row = {}
    # card against CPU, 2 layers, the config's own (scatter) MoE
    cfg = dataclasses.replace(base, num_layers=GRANITE_CPU_LAYERS)
    cpu = models.init_params(cfg, 0, device="cpu")
    batch = model_batch(cfg, 1, PROMPT[1], seed=2)
    want = models.forward(cpu, batch, cfg)
    card = tree_map(lambda t: t.to(dev), cpu)
    row["card_vs_cpu_err"] = held("granite 2 layers forward, card vs cpu",
                                  models.forward(card, batch, cfg), want, GRANITE_CPU_TOL)
    del cpu, card
    # full depth, dense MoE: decode against forward, paged against slot
    cfg = dataclasses.replace(base, moe_impl="dense")
    params = models.init_params(cfg, 0, device=dev)
    B, S = PROMPT
    toks = model_batch(cfg, B, S, seed=3)["tokens"]
    lengths = np.array(PROMPT_LENGTHS, np.int32)
    full = models.forward(params, {"tokens": toks}, cfg)
    at = full[torch.arange(B), torch.as_tensor(lengths - 1, device=dev)]
    cache = models.init_cache(cfg, B, SLOT_MAX_LEN, device=dev)
    t0 = time.perf_counter()
    got, cache = models.decode_chunk(params, cache, toks, 0, cfg, lengths=lengths)
    torch.cuda.synchronize()
    row["decode_chunk_64_f32_s"] = time.perf_counter() - t0
    row["decode_vs_forward_err"] = held("granite full depth decode_chunk vs forward", got, at,
                                        DECODE_TOL)
    # paged (blocks of 16 dealt from a seeded shuffle, a spare block) against slot
    active = np.array([True, True, True, False])
    nblk = -(-SLOT_MAX_LEN // PAGED_BLOCK)
    num_blocks = B * nblk + 1
    tables = np.random.RandomState(4).permutation(num_blocks)[: B * nblk].reshape(B, nblk)
    slot = models.init_cache(cfg, B, SLOT_MAX_LEN, device=dev)
    paged = models.init_paged_cache(cfg, num_blocks, PAGED_BLOCK, B, device=dev)
    a, slot = models.decode_chunk(params, slot, toks, 0, cfg, active, lengths)
    b, paged = models.decode_chunk(params, paged, toks, 0, cfg, active, lengths,
                                   tables, SLOT_MAX_LEN)
    torch.cuda.synchronize()
    tab = torch.as_tensor(tables, device=dev).long()
    kv_same = all(
        torch.equal(slot[n][:, r, :n_tok],
                    paged[n][:, tab[r]].flatten(1, 2)[:, :n_tok])
        for n in ("k", "v") for r, n_tok in enumerate(lengths) if active[r])
    if not torch.equal(a, b) or not kv_same or a[3].any():
        raise SystemExit(f"models granite paged vs slot: logits equal {torch.equal(a, b)}, "
                         f"K/V equal {kv_same}, inactive row zero {not a[3].any()}")
    row["paged_vs_slot"] = "bitwise"
    print(f"models {MODEL_ARCH}: full width f32, TF32 off: {GRANITE_CPU_LAYERS} layers card vs "
          f"cpu max |err| {row['card_vs_cpu_err']:.3g} (tol {GRANITE_CPU_TOL}); full depth "
          f"{cfg.num_layers} layers dense MoE: decode_chunk {PROMPT} (lengths {PROMPT_LENGTHS}) "
          f"vs forward max |err| {row['decode_vs_forward_err']:.3g} (tol {DECODE_TOL}); paged "
          f"(blocks of {PAGED_BLOCK}) vs slot cache bit for bit, one row inactive")
    return row


def top_kernels(by_name, n=8):
    """The ``n`` device kernels that take the most time a call: [name, µs]."""
    return [[name[:120], us] for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def granite_times(dev, smi):
    """granite-moe-3b-a800m at full width and depth in bf16 with the
    default scatter MoE: forward of FORWARD_SHAPE tokens, a context of
    DECODE_CONTEXT tokens built by decode_chunk of DECODE_CHUNK tokens,
    then decode_step at DECODE_BATCH (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config(MODEL_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = models.init_params(cfg, 0, device=dev)
    row = {"arch": MODEL_ARCH, "dtype": cfg.dtype, "moe_impl": cfg.moe_impl,
           "layers": cfg.num_layers, "param_count": models.count_params(params),
           "param_bytes": models.tree_bytes(params)}
    B, S = FORWARD_SHAPE
    batch = {"tokens": torch.as_tensor(model_batch(cfg, B, S, seed=5)["tokens"], device=dev)}
    logits = models.forward(params, batch, cfg)
    if tuple(logits.shape) != (B, S, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"models forward bf16: shape {tuple(logits.shape)}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    del logits

    def fwd():
        return models.forward(params, batch, cfg)

    row["forward_shape"] = [B, S]
    row["forward_ms"] = time_ms(fwd, MODEL_CALLS)
    row["forward_tokens_per_s"] = B * S / (row["forward_ms"] / 1e3)
    kernels, by_name = device_profile(fwd, MODEL_PROFILED, label="models forward")
    row["forward_device_ms"] = sum(by_name.values()) / 1e3
    row["forward_device_kernels"] = kernels
    row["forward_idle_share"] = 1 - row["forward_device_ms"] / row["forward_ms"]
    row["forward_top_kernels"] = top_kernels(by_name)

    Bd = DECODE_BATCH
    cache = models.init_cache(cfg, Bd, DECODE_MAX_LEN, device=dev)
    ctx = torch.as_tensor(model_batch(cfg, Bd, DECODE_CONTEXT, seed=6)["tokens"], device=dev)
    chunk_ms = []
    for start in range(0, DECODE_CONTEXT, DECODE_CHUNK):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        last, cache = models.decode_chunk(params, cache, ctx[:, start:start + DECODE_CHUNK],
                                          start, cfg)
        t1.record()
        torch.cuda.synchronize()
        chunk_ms.append(t0.elapsed_time(t1))
    if not bool(torch.isfinite(last).all()):
        raise SystemExit("models decode_chunk bf16: logits not finite")
    row["decode_chunk_tokens"] = DECODE_CHUNK
    row["decode_chunk_ms"] = float(np.mean(chunk_ms[1:]))   # the first also warms up
    row["decode_chunk_ms_each"] = chunk_ms
    pos = [DECODE_CONTEXT]
    tok = ctx[:, -1]

    def step():
        out, _ = models.decode_step(params, cache, tok, pos[0], cfg)
        pos[0] += 1
        return out

    row["decode_batch"], row["decode_context"] = Bd, DECODE_CONTEXT
    row["decode_step_ms"] = time_ms(step, DECODE_CALLS)
    kernels, by_name = device_profile(step, MODEL_PROFILED, label="models decode_step")
    row["decode_step_device_ms"] = sum(by_name.values()) / 1e3
    row["decode_step_device_kernels"] = kernels
    row["decode_step_idle_share"] = 1 - row["decode_step_device_ms"] / row["decode_step_ms"]
    row["decode_step_top_kernels"] = top_kernels(by_name)
    row["decode_step_bound_ms"] = row["param_bytes"] / HBM_BYTES_PER_S * 1e3
    if pos[0] > DECODE_MAX_LEN:
        raise SystemExit(f"models decode_step: ran to position {pos[0]} past the cache")
    torch.cuda.synchronize()
    row["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    row["card"] = smi
    print(f"models {MODEL_ARCH} bf16 {cfg.moe_impl}: forward {B}x{S} {row['forward_ms']:.2f} ms "
          f"({row['forward_tokens_per_s']:.0f} tokens/s), device {row['forward_device_ms']:.2f} ms "
          f"in {row['forward_device_kernels']:.0f} kernels; decode_chunk of "
          f"{DECODE_CHUNK} {row['decode_chunk_ms']:.2f} ms; decode_step at {Bd} over "
          f"{DECODE_CONTEXT} tokens {row['decode_step_ms']:.2f} ms, device "
          f"{row['decode_step_device_ms']:.3f} ms in {row['decode_step_device_kernels']:.0f} "
          f"kernels, idle share {row['decode_step_idle_share']:.3f}; params "
          f"{row['param_bytes']} bytes, peak allocated {row['peak_allocated_bytes']} bytes ({smi})")
    return row


def zero_launches():
    """Set every launch count the kernels line reads to 0: each hand-written
    kernel's counter and the generated kernels' tally by emitter."""
    from repro_torch.core.codegen import KernelProgram
    from repro_torch.kernels import ops

    for kern in ops.KERNELS.values():
        kern.launches = 0
    for emitter in KernelProgram.launches_by_emitter:
        KernelProgram.launches_by_emitter[emitter] = 0


def read_launches(label):
    """Every kernel's launches since ``zero_launches``, by the kernels
    line's names; ``label``'s path launches none of them."""
    import torch

    from repro_torch.core.codegen import KernelProgram
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    launches = {**KernelProgram.launches_by_emitter,
                **{name: kern.launches for name, kern in ops.KERNELS.items()}}
    if any(launches.values()):
        raise SystemExit(f"{label}: the path launched the port's kernels {launches}")
    return launches


def models_phase(dev, smi):
    """Phase 13: the models on the card (see the module docstring).  Every
    kernel's launch count, hand-written and generated, is set to 0 just
    before and read just after: the models' path launches none of them.
    Returns the models line's object and each kernel's launches."""
    zero_launches()
    families = family_checks(dev)
    checks = granite_checks(dev)
    times = granite_times(dev, smi)
    launches = read_launches("models")
    return {"families": families, "granite_checks": checks, **times,
            "tolerances": {"family_f32": FAMILY_TOL, "granite_card_vs_cpu_f32": GRANITE_CPU_TOL,
                           "decode_vs_forward_f32": DECODE_TOL, "paged_vs_slot": "bitwise"}}, launches


# ---- phase 14: serving -------------------------------------------------------------
#: (a) each family at reduced_config: a small seeded trace, card (replayed)
#: against CPU (eager); Whisper through the slot engine, whose paged cache raises
FAMILY_TRACE = dict(num_requests=6, mean_interarrival_ticks=1.0, prompt_len_lo=3,
                    prompt_len_hi=12, max_new_lo=3, max_new_hi=6, seed=1)
FAMILY_PAGED = dict(decode_width=4, max_len=32, block_size=4, prefill_chunk=4)
FAMILY_SLOT = dict(pool_size=4, max_len=32, prefill_chunk=4)
#: (b) paged against slot at one width and a max_len of 2 x 16 - 1: the slot
#: ring's W + 1 = 32 slots equal the paged view's 2 blocks of 16, so both read
#: views have one shape; the prompt lengths and chunks of the reference's
#: test_paged_matches_slot_engine_single_request
PARITY_WIDTH, PARITY_MAX_LEN, PARITY_BLOCK, PARITY_NEW = 2, 31, 16, 6
PARITY_PROMPTS = ((1, 4), (3, 4), (7, 4), (12, 8), (17, 4))
#: preemption-resume: a pool of one max-length context (2 blocks), two
#: 12-token prompts of 16 new tokens each, as test_preemption_resume_token_parity
PREEMPT_PROMPTS = ((1, 13), (20, 32))
PREEMPT_NEW = 16
#: (c) one seeded Poisson trace through the paged engine, eager then replayed
SERVE_TRACE = dict(num_requests=16, mean_interarrival_ticks=2, prompt_len_lo=16,
                   prompt_len_hi=64, max_new_lo=8, max_new_hi=16, seed=0)
SERVE_ENGINE = dict(decode_width=8, max_len=255, block_size=16, prefill_chunk=16)
SERVE_DECODE_CALLS = 10     # timed decode launches (CUDA events), after as many warm
SERVE_PREFILL_CALLS = 5     # prefill launches timed one by one (median), after one warm
SERVE_POSITION = 128        # every row's position in the timed launches
#: (d) the entry point at full width
SERVE_ARGV = ["--arch", MODEL_ARCH, "--requests", "8"]


def serve_trace(eng, trace):
    """``run_trace`` of ``trace`` through ``eng``: the report and each
    request's tokens by rid (the harness makes the requests)."""
    from repro_torch import serve

    reqs = {}
    admit = eng.admit

    def keep(req):
        reqs[req.rid] = req
        return admit(req)

    eng.admit = keep
    rep = serve.run_trace(eng, trace, max_ticks=20_000, strict=True)
    del eng.admit
    return rep, {rid: r.out_tokens for rid, r in reqs.items()}


def engine_counters(stats):
    """Every ``stats()`` entry but the times, the graphs' own keys and the
    process-wide step cache: the reference's counters."""
    return {k: v for k, v in stats.items()
            if k not in ("graph_captures", "graph_replays", "graphs", "decode_cache")}


def graphs_replayed(label, eng):
    """The engine replayed its steps: each captured once, one replay a launch."""
    st = eng.stats()
    launches = st["prefill_launches"] + st["decode_launches"]
    if not eng.replay or st["graph_replays"] != launches or st["graph_captures"] < 1:
        raise SystemExit(f"serve {label}: replay {eng.replay}, {st['graph_captures']} captures, "
                         f"{st['graph_replays']} replays for {launches} launches")


def serve_families(dev):
    """(a): each architecture at reduced_config, f32: the card's replayed
    engine against the CPU's eager engine on one seeded trace, tokens and
    counters."""
    from repro_torch import models, serve
    from repro_torch.configs import ARCHITECTURES, get_config, reduced_config
    from repro_torch.models.module import tree_map

    rows = []
    for arch in sorted(ARCHITECTURES):
        cfg = reduced_config(get_config(arch))
        cpu = models.init_params(cfg, 0, device="cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        trace = serve.generate_trace(serve.TraceConfig(vocab_size=cfg.vocab_size, **FAMILY_TRACE))
        runs = {}
        for where, params in (("cpu", cpu), ("card", card)):
            if cfg.family == "audio":
                eng = serve.ServeEngine(cfg, params, device=params["embed"]["tok"].device,
                                        **FAMILY_SLOT)
            else:
                eng = serve.PagedServeEngine(cfg, params, device=params["embed"]["tok"].device,
                                             **FAMILY_PAGED)
            rep, toks = serve_trace(eng, trace)
            runs[where] = (toks, engine_counters(eng.stats()), rep)
        graphs_replayed(arch, eng)
        (ctoks, cst, _), (gtoks, gst, rep) = runs["cpu"], runs["card"]
        if gtoks != ctoks or gst != cst:
            bad = [rid for rid in ctoks if gtoks.get(rid) != ctoks[rid]]
            raise SystemExit(f"serve {arch}: card (replayed) vs cpu (eager): requests {bad} differ, "
                             f"counters equal {gst == cst}")
        rows.append({"arch": arch, "engine": type(eng).__name__, "requests": rep.completed,
                     "tokens": rep.tokens_out, "ticks": rep.ticks})
        print(f"serve {arch}: reduced f32 {type(eng).__name__}, card replayed vs cpu eager: "
              f"{rep.completed} requests, {rep.tokens_out} tokens, {rep.ticks} ticks, tokens "
              "and counters equal")
    return rows


def serve_parity(cfg, params, dev):
    """(b) at full width: paged against slot for single requests, and
    preemption-resume against solo runs, tokens bit for bit."""
    import numpy as np

    from repro_torch import serve

    def solo_runs(make, prompts, n):
        eng = make()
        out = []
        for p in prompts:
            r = serve.Request(rid=len(out), prompt=p, max_new_tokens=n)
            eng.admit(r)
            if eng.run_until_done() != 0:
                raise SystemExit("serve parity: a request did not finish")
            out.append(r.out_tokens)
        graphs_replayed("parity", eng)
        return out

    rows = []
    for chunk in sorted({c for _, c in PARITY_PROMPTS}):
        prompts = [(np.arange(n) % 100 + 1).astype(np.int32) for n, c in PARITY_PROMPTS if c == chunk]
        slot = solo_runs(lambda: serve.ServeEngine(
            cfg, params, pool_size=PARITY_WIDTH, max_len=PARITY_MAX_LEN, prefill_chunk=chunk,
            device=dev), prompts, PARITY_NEW)
        paged = solo_runs(lambda: serve.PagedServeEngine(
            cfg, params, decode_width=PARITY_WIDTH, max_len=PARITY_MAX_LEN,
            block_size=PARITY_BLOCK, prefill_chunk=chunk, device=dev), prompts, PARITY_NEW)
        for p, a, b in zip(prompts, slot, paged, strict=True):
            if a != b:
                raise SystemExit(f"serve paged vs slot, prompt {len(p)} chunk {chunk}: {b} vs {a}")
            rows.append({"prompt": len(p), "chunk": chunk, "tokens": a})
    prompts = [np.arange(lo, hi, dtype=np.int32) for lo, hi in PREEMPT_PROMPTS]
    solo = solo_runs(lambda: serve.ServeEngine(
        cfg, params, pool_size=PARITY_WIDTH, max_len=PARITY_MAX_LEN, prefill_chunk=4,
        device=dev), prompts, PREEMPT_NEW)
    eng = serve.PagedServeEngine(cfg, params, decode_width=PARITY_WIDTH, max_len=PARITY_MAX_LEN,
                                 block_size=PARITY_BLOCK, num_blocks=-(-PARITY_MAX_LEN // PARITY_BLOCK),
                                 prefill_chunk=4, device=dev)
    reqs = [serve.Request(rid=i, prompt=p, max_new_tokens=PREEMPT_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.admit(r)
    if eng.run_until_done(max_ticks=1000) != 0 or eng.sched.preemptions == 0:
        raise SystemExit(f"serve preemption: unfinished or {eng.sched.preemptions} preemptions")
    graphs_replayed("preemption", eng)
    if [r.out_tokens for r in reqs] != solo:
        raise SystemExit(f"serve preemption-resume: {[r.out_tokens for r in reqs]} vs solo {solo}")
    eng.allocator.check_consistent()
    print(f"serve {MODEL_ARCH} bf16: paged vs slot at width {PARITY_WIDTH}, max_len "
          f"{PARITY_MAX_LEN}, blocks of {PARITY_BLOCK}: {len(rows)} single requests bit for bit; "
          f"preemption-resume ({eng.sched.preemptions} preemptions) equals the solo runs")
    return {"paged_vs_slot": rows, "preemptions": eng.sched.preemptions, "preempt_tokens": solo}


def serve_numbers(cfg, params, dev, smi):
    """(b) replayed against eager and (c) the numbers, on one trace."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import models, serve

    trace = serve.generate_trace(serve.TraceConfig(vocab_size=cfg.vocab_size, **SERVE_TRACE))
    runs = {}
    for mode, replay in (("eager", False), ("replayed", True)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = serve.PagedServeEngine(cfg, params, **SERVE_ENGINE, device=dev, replay=replay)
        t0 = time.perf_counter()
        rep, toks = serve_trace(eng, trace)
        wall = time.perf_counter() - t0
        if rep.completed != rep.total:
            raise SystemExit(f"serve {mode}: {rep.completed} of {rep.total} requests finished")
        st = eng.stats()
        if replay:
            graphs_replayed(mode, eng)
        row = {"trace_s": wall, "report": dataclasses.asdict(rep), "counters": engine_counters(st),
               "graphs": st["graphs"], "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        # a decode and a prefill launch with every row active, timed and profiled
        W, C = eng.width, eng.prefill_chunk
        rng = np.random.RandomState(7)
        table = (np.arange(eng._table.size) % eng.num_blocks).reshape(eng._table.shape).astype(np.int32)
        pos = np.full(W, SERVE_POSITION, np.int32)
        act = np.ones(W, bool)
        toks_v = rng.randint(0, cfg.vocab_size, W).astype(np.int32)
        toks_m = rng.randint(0, cfg.vocab_size, (W, C)).astype(np.int32)
        lens = np.full(W, C, np.int32)

        def decode():
            return eng._steps[0](toks_v, pos, act, table)

        def prefill():
            return eng._steps[1](toks_m, pos, act, lens, table)

        row["decode_launch_ms"] = time_ms(decode, SERVE_DECODE_CALLS)
        kernels, by_name = device_profile(decode, MODEL_PROFILED, label=f"serve {mode} decode")
        row["decode_device_ms"] = sum(by_name.values()) / 1e3
        row["decode_device_kernels"] = kernels
        row["decode_idle_share"] = 1 - row["decode_device_ms"] / row["decode_launch_ms"]
        row["decode_top_kernels"] = top_kernels(by_name)
        prefill()
        row["prefill_launch_ms_each"] = [time_ms(prefill, 1, warm=False)
                                         for _ in range(SERVE_PREFILL_CALLS)]
        row["prefill_launch_ms"] = float(np.median(row["prefill_launch_ms_each"]))
        runs[mode] = (row, toks)
        del eng
    (erow, etoks), (grow, gtoks) = runs["eager"], runs["replayed"]
    if gtoks != etoks or grow["counters"] != erow["counters"]:
        bad = [rid for rid in etoks if gtoks.get(rid) != etoks[rid]]
        raise SystemExit(f"serve replayed vs eager: requests {bad} differ, counters equal "
                         f"{grow['counters'] == erow['counters']}")
    bound_ms = models.tree_bytes(params) / HBM_BYTES_PER_S * 1e3
    for mode, (row, _) in runs.items():
        rep = row["report"]
        print(f"serve {MODEL_ARCH} bf16 paged {mode}: {rep['completed']} requests, "
              f"{rep['tokens_out']} tokens in {rep['ticks']} ticks, {rep['duration_s']:.3f} s: "
              f"{rep['tokens_per_s']:.1f} tokens/s; TTFT p50/p99 {rep['ttft_p50_ms']:.1f}/"
              f"{rep['ttft_p99_ms']:.1f} ms; latency p50/p99 {rep['latency_p50_ms']:.1f}/"
              f"{rep['latency_p99_ms']:.1f} ms; decode launch {row['decode_launch_ms']:.3f} ms "
              f"(device {row['decode_device_ms']:.3f} ms in {row['decode_device_kernels']:.0f} "
              f"kernels, idle share {row['decode_idle_share']:.3f}, bound {bound_ms:.3f}); prefill "
              f"launch of {SERVE_ENGINE['prefill_chunk']} {row['prefill_launch_ms']:.2f} ms (median "
              f"of {[round(t, 2) for t in row['prefill_launch_ms_each']]}); "
              f"max inflight {rep['max_inflight']}, KV peak {rep['kv_peak_utilization']:.3f}; "
              f"peak allocated {row['peak_allocated_bytes']} bytes; graphs {row['graphs']} ({smi})")
    print(f"serve {MODEL_ARCH}: replayed vs eager on one trace: every request's tokens bit for "
          f"bit, counters equal ({erow['counters']['ticks']} ticks, "
          f"{erow['counters']['prefill_launches']} prefill and "
          f"{erow['counters']['decode_launches']} decode launches, "
          f"{erow['counters']['preemptions']} preemptions)")
    return {"eager": erow, "replayed": grow, "decode_bound_ms": bound_ms}


def serve_phase(dev, smi):
    """Phase 14: serving on the card (see the module docstring).  Every
    kernel's launch count, hand-written and generated, is set to 0 just
    before and read just after: the serving path launches none of them.
    Returns the serve line's object and each kernel's launches."""
    import gc

    import torch

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve

    zero_launches()
    seconds = {}
    t0 = time.perf_counter()
    families = serve_families(dev)
    seconds["families"] = time.perf_counter() - t0
    cfg = get_config(MODEL_ARCH)
    params = models.init_params(cfg, 0, device=dev)
    t1 = time.perf_counter()
    parity = serve_parity(cfg, params, dev)
    seconds["parity"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    numbers = serve_numbers(cfg, params, dev, smi)
    seconds["numbers"] = time.perf_counter() - t1
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    if launch_serve.main(SERVE_ARGV) != 0:
        raise SystemExit(f"serve: python -m repro_torch.launch.serve {' '.join(SERVE_ARGV)} left "
                         "requests unfinished")
    seconds["entry_point"] = time.perf_counter() - t1
    launches = read_launches("serve")
    seconds["phase"] = time.perf_counter() - t0
    print(f"serve: launch.serve {' '.join(SERVE_ARGV)} finished every request; seconds "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return {"families": families, "parity": parity, **numbers, "seconds": seconds,
            "card": smi}, launches


# ---- phase 15: training --------------------------------------------------------------
#: (a) each family at reduced_config, f32 with TF32 off: the Trainer's steps on
#: the card (its default step: the eager warm-up step, then replays of the
#: captured CUDA graph) against the Trainer's eager steps on the CPU, the same
#: seeded weights and batches.  The losses differ by a few f32 ulps of sums
#: taken in another order (the CPU tests read 1e-6 against the reference); a
#: parameter whose gradient is near 0 may take the other sign's Adam update,
#: at most 2 lr a step, so the params are held at 2 lr x steps
TRAIN_FAMILY_STEPS = 3
TRAIN_FAMILY_SHAPE = (4, 16)        # batch, sequence
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_LOSS_TOL = 1e-4
TRAIN_PARAM_TOL = 2 * TRAIN_OPT["lr"] * TRAIN_FAMILY_STEPS
#: (b) the stitched MLP step of the reference's examples/train_stitched.py, its
#: sizes, options and schedule; the card's f32 kernels against the plain
#: step's torch ops on the CPU: sums in another order, f32 ulps (the CPU tests
#: read 2.4e-7 against jax.jit)
STITCH_SIZES = (64, 16, 32, 8)      # batch, in, hidden, out
STITCH_STEPS = 20
STITCH_OPT = dict(lr=1e-3, warmup_steps=10, total_steps=100)
STITCH_TOL = 1e-5
#: (c) granite-moe-3b-a800m at full width and depth, bf16, remat "full" (its
#: config's own), batch 4 x 512 tokens of the data pipeline.  The first eager
#: step's loss against cross_entropy(forward(...)) of the same params and
#: batch on the card: the same bf16 forward and f32 loss, so equal but for
#: the order of sums (held at rtol TRAIN_LOSS0_TOL)
TRAIN_SHAPE = (4, 512)
TRAIN_GRANITE_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
TRAIN_LOSS0_TOL = 1e-3
TRAIN_EAGER_STEPS = 3       # timed eager steps (CUDA events), after as many warm
TRAIN_REPLAY_STEPS = 5      # timed replays, after as many warm
TRAIN_PROFILED = 2          # steps traced by torch.profiler
#: remat at full width, REMAT_LAYERS layers (the peak of one step's loss and
#: gradients, each mode, and the CE over chunks of LOSS_CHUNK positions, each
#: under checkpoint, against the whole logits; the loss bit for bit, the
#: gradients' norm at REMAT_NORM_TOL: the MoE dispatch's backward adds rows
#: by atomics)
REMAT_LAYERS = 4
REMAT_NORM_TOL = 1e-3
LOSS_CHUNK = 128
#: a replayed step against an eager one from the same state, at full width
#: and REMAT_LAYERS layers in bf16: the loss is the same forward's, so bit
#: for bit; the gradients differ where the MoE dispatch's and the
#: embedding's backward add by atomics, so the grad norm is held at
#: REPLAY_NORM_TOL and each new parameter within 2 lr (an update whose
#: gradient is near 0 may take the other sign) plus a bf16 ulp of it
REPLAY_NORM_TOL = 1e-3


def train_batch(cfg, B, S, step, dev=None):
    """The data pipeline's batch ``step`` (numpy), on ``dev`` where given."""
    import torch

    from repro_torch.data import SyntheticLM

    batch = SyntheticLM(cfg, S, B, seed=0).batch_at(step)
    return batch if dev is None else {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def train_families(dev):
    """(a): every architecture at reduced_config, the Trainer on the card
    (captured step) against the Trainer on the CPU (eager)."""
    import torch

    from repro_torch import models, train
    from repro_torch.configs import ARCHITECTURES, get_config, reduced_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.module import tree_map
    from repro_torch.train.optimizer import tree_leaves_sorted

    B, S = TRAIN_FAMILY_SHAPE
    rows = []
    for arch in sorted(ARCHITECTURES):
        cfg = reduced_config(get_config(arch))
        cpu = models.init_params(cfg, 0, device="cpu")
        card = tree_map(lambda t: t.to(dev, copy=True), cpu)    # each run writes its own
        runs = {}
        for where, params in (("cpu", cpu), ("card", card)):
            trainer = train.Trainer(
                cfg, train.AdamWConfig(**TRAIN_OPT),
                train.TrainerConfig(total_steps=TRAIN_FAMILY_STEPS),
                lambda s, cfg=cfg: SyntheticLM(cfg, S, B, seed=0).iterate(s),
                device="cpu" if where == "cpu" else dev)
            runs[where] = (trainer, trainer.run(params)[0])
        step = runs["card"][0].train_step
        if not isinstance(step, train.CapturedTrainStep) or step.replays != TRAIN_FAMILY_STEPS - 1:
            raise SystemExit(f"train {arch}: the card's Trainer did not replay a captured step")
        loss_cpu = [h["loss"] for h in runs["cpu"][0].history]
        loss_card = [h["loss"] for h in runs["card"][0].history]
        loss_err = max(abs(a - b) for a, b in zip(loss_card, loss_cpu, strict=True))
        if not all(abs(a - b) <= TRAIN_LOSS_TOL * (1 + abs(b))
                   for a, b in zip(loss_card, loss_cpu, strict=True)):
            raise SystemExit(f"train {arch}: card losses {loss_card} vs cpu {loss_cpu}")
        param_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree_leaves_sorted(runs["card"][1]), tree_leaves_sorted(runs["cpu"][1]), strict=True))
        if not param_err <= TRAIN_PARAM_TOL:
            raise SystemExit(f"train {arch}: params after {TRAIN_FAMILY_STEPS} steps differ by "
                             f"{param_err:.3g} > {TRAIN_PARAM_TOL}")
        rows.append({"arch": arch, "losses": loss_card, "loss_err": loss_err,
                     "param_err": param_err, "capture_s": step.capture_s,
                     "instantiate_s": step.instantiate_s})
        print(f"train {arch}: reduced, f32, {TRAIN_FAMILY_STEPS} Trainer steps card (captured, "
              f"{step.replays} replays) vs cpu: loss max |err| {loss_err:.3g} (tol "
              f"{TRAIN_LOSS_TOL}), params {param_err:.3g} (tol {TRAIN_PARAM_TOL})")
        del runs, cpu, card
    return rows


def stitched_step_case():
    """(b)'s loss, params and batches (numpy), as examples/train_stitched.py."""
    import numpy as np
    import torch

    B, d_in, d_h, d_out = STITCH_SIZES
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(d_in, d_h), scale=0.1).astype(np.float32),
              "b1": np.zeros((d_h,), np.float32),
              "w2": rng.normal(size=(d_h, d_out), scale=0.1).astype(np.float32),
              "b2": np.zeros((d_out,), np.float32)}
    batches = [(rng.normal(size=(B, d_in)).astype(np.float32),
                rng.normal(size=(B, d_out)).astype(np.float32)) for _ in range(STITCH_STEPS)]

    def loss_fn(params, batch):
        x, y = batch
        h = torch.tanh(x @ params["w1"] + params["b1"])
        return torch.mean((h @ params["w2"] + params["b2"] - y) ** 2)

    return loss_fn, params, batches


def stitched_step(device, replay, spec=None):
    """examples/train_stitched.py's step; ``spec`` None plans for the
    device (the card's H100 there)."""
    from repro_torch.core import StitchOptions
    from repro_torch.train import AdamWConfig, make_stitched_train_step

    loss_fn, _, _ = stitched_step_case()
    opts = StitchOptions(max_blocks=32, jit_replay=replay, device_spec=spec)
    return make_stitched_train_step(loss_fn, AdamWConfig(**STITCH_OPT), options=opts,
                                    device=device)


def train_sources():
    """The CUDA source (b) builds: the stitched step's plan under the card's
    spec, compiled here for the CPU (the same text the card's compile emits)."""
    import torch

    from repro_torch.core.latency import H100
    from repro_torch.train import adamw_init

    _, params, batches = stitched_step_case()
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    x, y = (torch.as_tensor(a) for a in batches[0])
    return sources_of(stitched_step("cpu", False, H100).lower(p, adamw_init(p), (x, y)).compile())


def stitched_train(dev):
    """(b): 20 steps of the stitched step on the card, eager and replayed,
    against the plain step (the captured function run by PyTorch) on the
    CPU; kernels a call, µs a call both ways, device µs.  The eager run is
    the counted one: every kernel's launch count is set to 0 just before it
    and read just after.  Returns its row and those launches."""
    import torch

    from repro_torch.core.codegen import KernelProgram
    from repro_torch.kernels import ops
    from repro_torch.train import adamw_init

    _, params, batches = stitched_step_case()
    runs = {}
    for label, device, replay in (("plain_cpu", "cpu", False), ("eager", dev, False),
                                  ("replayed", dev, True)):
        step = stitched_step(device, replay)
        # copies: a donated buffer takes the step's outputs
        p = {k: torch.tensor(v, device=device) for k, v in params.items()}
        s = adamw_init(p)
        metrics = []
        if label == "eager":
            zero_launches()
        for x, y in batches:
            xb, yb = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
            if label == "plain_cpu":
                p, s, m = step._fn(p, s, (xb, yb))
            else:
                p, s, m = step(p, s, (xb, yb))
            metrics.append({k: float(v) for k, v in m.items()})
        if label == "eager":
            torch.cuda.synchronize()
            launches = {**KernelProgram.launches_by_emitter,
                        **{name: kern.launches for name, kern in ops.KERNELS.items()}}
        runs[label] = (step, p, s, metrics, (xb, yb))
    st_e = runs["eager"][0]
    if st_e.num_fallbacks or runs["replayed"][0].num_fallbacks or st_e.num_compiles != 1:
        raise SystemExit(f"train stitched: {st_e.num_fallbacks} fallbacks, "
                         f"{st_e.num_compiles} compiles")
    comp_e = st_e.lower().compile()
    comp_r = runs["replayed"][0].lower().compile()
    planned = planned_launches(comp_e)
    if sum(launches.values()) != STITCH_STEPS * planned or any(launches[k] for k in ops.KERNELS):
        raise SystemExit(f"train stitched: {launches} launches in {STITCH_STEPS} eager steps, "
                         f"planned {planned} a step")
    if comp_r.executable.replay_mode != "graph" \
            or comp_r.executable.execution_plan.stats.traced_calls != STITCH_STEPS:
        raise SystemExit("train stitched: the default step did not replay its CUDA graph")
    err = {}
    for label in ("eager", "replayed"):
        worst = 0.0
        for got, want in zip(runs[label][3], runs["plain_cpu"][3], strict=True):
            for k in want:
                d = abs(got[k] - want[k])
                if not d <= STITCH_TOL * (1 + abs(want[k])):
                    raise SystemExit(f"train stitched {label}: {k} {got[k]} vs plain {want[k]}")
                worst = max(worst, d)
        for k in params:
            d = float((runs[label][1][k].cpu() - runs["plain_cpu"][1][k]).abs().max())
            if not d <= STITCH_TOL:
                raise SystemExit(f"train stitched {label}: param {k} differs by {d:.3g}")
            worst = max(worst, d)
        err[label] = worst
    bitwise = runs["eager"][3] == runs["replayed"][3] and all(
        torch.equal(runs["eager"][1][k], runs["replayed"][1][k]) for k in params)
    row = {"steps": STITCH_STEPS, "fallbacks": 0, "compiles": 1, "kernels_per_call": planned,
           "library_dots": comp_e.stats.library_calls, "launches": launches,
           "max_err_vs_plain": err, "replayed_equals_eager_bitwise": bitwise,
           "emitters": sorted({k.fn.emitter for k in comp_e.kernels})}
    for label in ("eager", "replayed"):
        step, p, s, _, batch = runs[label]
        state = [p, s]

        def call(step=step, state=state, batch=batch):
            state[0], state[1], _ = step(state[0], state[1], batch)

        row[f"{label}_us"] = 1e3 * time_ms(call, CALLS)
        kernels, by_name = device_profile(call, PROFILED_CALLS, label=f"train stitched {label}")
        row[f"{label}_device_us"] = sum(by_name.values())
        row[f"{label}_device_kernels"] = kernels
        row[f"{label}_idle_share"] = 1 - row[f"{label}_device_us"] / row[f"{label}_us"]
    print(f"train stitched MLP step: {STITCH_STEPS} steps eager and replayed vs the plain step on "
          f"the cpu, max |err| {err} (tol {STITCH_TOL}), replayed = eager bit for bit "
          f"{bitwise}; 0 fallbacks, 1 compile, {planned} kernels a step ({row['emitters']}), "
          f"launches {launches}; us a step eager {row['eager_us']:.1f} (device "
          f"{row['eager_device_us']:.2f} in {row['eager_device_kernels']:.0f} kernels), "
          f"replayed {row['replayed_us']:.1f} (device {row['replayed_device_us']:.2f} in "
          f"{row['replayed_device_kernels']:.0f} kernels)")
    return row, launches


def remat_peaks(dev):
    """Peak allocated bytes of one step's loss and gradients at granite's
    full width, REMAT_LAYERS layers, in each remat mode; the loss bit for bit
    and the gradients' norm against ``none``."""
    import dataclasses

    import torch

    from repro_torch import models, train
    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config(MODEL_ARCH), num_layers=REMAT_LAYERS)
    params = models.init_params(base, 0, device=dev)
    batch = train_batch(base, *TRAIN_SHAPE, 0, dev)
    rows, ref = {}, None
    for remat, chunk in (("none", None), ("full", None), ("dots", None), ("selective", None),
                         ("full", LOSS_CHUNK)):
        cfg = dataclasses.replace(base, remat=remat)
        if chunk:
            cfg = dataclasses.replace(cfg, loss_chunk=chunk)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        loss, grads = train.value_and_grad(train.make_loss_fn(cfg), params, batch)
        norm = float(train.global_norm(grads))
        peak = torch.cuda.max_memory_allocated() - before
        del grads
        if ref is None:
            ref = (loss, norm)
        same = bool(torch.equal(loss, ref[0]))
        # the chunked CE sums its chunks' sums: the same terms in another order
        close = same or (chunk and abs(float(loss) - float(ref[0])) <= 1e-5 * float(ref[0]))
        if not close or abs(norm - ref[1]) > REMAT_NORM_TOL * ref[1]:
            raise SystemExit(f"train remat {remat}: loss {float(loss)} vs {float(ref[0])}, "
                             f"grad norm {norm} vs {ref[1]}")
        rows[f"{remat}, loss_chunk {cfg.loss_chunk}"] = {
            "peak_bytes_above_params": peak, "loss_bitwise": same, "grad_norm": norm}
    print(f"train remat at full width, {REMAT_LAYERS} layers, {TRAIN_SHAPE}: peak bytes above the "
          f"params {({k: v['peak_bytes_above_params'] for k, v in rows.items()})}; loss bit for "
          f"bit, grad norm within {REMAT_NORM_TOL}")
    return rows


def replay_parity(dev):
    """A replayed ``CapturedTrainStep`` step against an eager step from the
    same state (a copy taken after the warm-up step), at full width and
    ``REMAT_LAYERS`` layers in bf16 with the scatter MoE."""
    import dataclasses

    import torch

    from repro_torch import models, train
    from repro_torch.configs import get_config
    from repro_torch.models.module import tree_map
    from repro_torch.train.optimizer import tree_leaves_sorted

    cfg = dataclasses.replace(get_config(MODEL_ARCH), num_layers=REMAT_LAYERS)
    ocfg = train.AdamWConfig(**TRAIN_GRANITE_OPT)
    params = models.init_params(cfg, 0, device=dev)
    opt = train.adamw_init(params)
    step = train.make_train_step(cfg, ocfg)
    host = [train_batch(cfg, *TRAIN_SHAPE, i) for i in range(2)]
    cap = train.CapturedTrainStep(step, dev)
    cap(params, opt, host[0])
    snap_p = tree_map(torch.clone, params)
    snap_o = train.AdamWState(opt.step.clone(), tree_map(torch.clone, opt.m),
                              tree_map(torch.clone, opt.v))
    _, _, mr = cap(params, opt, host[1])
    _, _, me = step(snap_p, snap_o, host[1])
    torch.cuda.synchronize()
    lr = float(me["lr"])
    bitwise = all(torch.equal(a, b) for a, b in zip(
        tree_leaves_sorted(params) + tree_leaves_sorted(opt.m) + tree_leaves_sorted(opt.v),
        tree_leaves_sorted(snap_p) + tree_leaves_sorted(snap_o.m) + tree_leaves_sorted(snap_o.v),
        strict=True)) and all(torch.equal(mr[k], me[k]) for k in me)
    worst = 0.0
    for a, b in zip(tree_leaves_sorted(params), tree_leaves_sorted(snap_p), strict=True):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        if bool((d > 2 * lr + b.abs() * 2.0 ** -8).any()):
            raise SystemExit(f"train replay vs eager: a parameter differs by {float(d.max()):.3g}")
    norm_err = abs(float(mr["grad_norm"]) - float(me["grad_norm"])) / float(me["grad_norm"])
    if not torch.equal(mr["loss"], me["loss"]) or norm_err > REPLAY_NORM_TOL:
        raise SystemExit(f"train replay vs eager: loss {float(mr['loss'])} vs {float(me['loss'])}, "
                         f"grad norm {float(mr['grad_norm'])} vs {float(me['grad_norm'])}")
    row = {"layers": REMAT_LAYERS, "bitwise": bitwise, "loss_bitwise": True,
           "grad_norm_rel_err": norm_err, "param_max_abs_err": worst}
    print(f"train replay vs eager, full width, {REMAT_LAYERS} layers, bf16: bit for bit {bitwise}; "
          f"loss bit for bit, grad norm rel err {norm_err:.3g} (tol {REPLAY_NORM_TOL}), params max "
          f"|err| {worst:.3g} (tol 2 lr + a bf16 ulp)")
    del params, opt, snap_p, snap_o, cap
    return row


def granite_train(dev, smi):
    """(c): granite-moe-3b-a800m at full width and depth: the memory
    reckoning, the first step's loss against cross_entropy(forward), then
    eager and captured steps timed and profiled."""
    import gc

    import torch

    from repro_torch import models, train
    from repro_torch.configs import get_config

    cfg = get_config(MODEL_ARCH)
    B, S = TRAIN_SHAPE
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = models.init_params(cfg, 0, device=dev)
    opt = train.adamw_init(params)
    ocfg = train.AdamWConfig(**TRAIN_GRANITE_OPT)
    pb, sb = models.tree_bytes(params), models.tree_bytes(opt.m) + models.tree_bytes(opt.v)
    row = {"arch": MODEL_ARCH, "dtype": cfg.dtype, "remat": cfg.remat, "moe_impl": cfg.moe_impl,
           "layers": cfg.num_layers, "shape": [B, S], "param_count": models.count_params(params),
           "param_bytes": pb, "grad_bytes": pb, "adam_state_bytes": sb,
           "reckoned_bytes": 2 * pb + sb, "card_bytes": torch.cuda.get_device_properties(dev).total_memory}
    batches = [train_batch(cfg, B, S, i, dev) for i in range(4)]
    with torch.no_grad():
        want = train.cross_entropy(models.forward(params, batches[0], cfg), batches[0]["labels"],
                                   cfg.vocab_size)
    step = train.make_train_step(cfg, ocfg)
    params, opt, m = step(params, opt, batches[0])
    loss0 = float(m["loss"])
    row["loss0"], row["loss0_forward"] = loss0, float(want)
    if not (abs(loss0 - float(want)) <= TRAIN_LOSS0_TOL * abs(float(want))
            and torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
        raise SystemExit(f"train granite: step-0 loss {loss0} vs cross_entropy(forward) "
                         f"{float(want)}, grad norm {float(m['grad_norm'])}")
    it = [0]

    def eager():
        it[0] += 1
        step(params, opt, batches[it[0] % len(batches)])

    row["eager_step_ms"] = time_ms(eager, TRAIN_EAGER_STEPS)
    kernels, by_name = device_profile(eager, TRAIN_PROFILED, label="train granite eager")
    row["eager_device_ms"] = sum(by_name.values()) / 1e3
    row["eager_device_kernels"] = kernels
    row["eager_top_kernels"] = top_kernels(by_name)
    torch.cuda.synchronize()
    row["eager_peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    # captured: the first call is the eager warm-up step, then the capture
    torch.cuda.reset_peak_memory_stats()
    host = [{k: v.cpu().numpy() for k, v in b.items()} for b in batches]
    cap = train.CapturedTrainStep(step, dev)
    t0 = time.perf_counter()
    params, opt, m = cap(params, opt, host[0])
    torch.cuda.synchronize()
    row["first_call_s"] = time.perf_counter() - t0
    row["capture_s"], row["instantiate_s"] = cap.capture_s, cap.instantiate_s

    def replay():
        it[0] += 1
        cap(params, opt, host[it[0] % len(host)])

    row["replayed_step_ms"] = time_ms(replay, TRAIN_REPLAY_STEPS)
    kernels, by_name = device_profile(replay, TRAIN_PROFILED, label="train granite replayed")
    row["replayed_device_ms"] = sum(by_name.values()) / 1e3
    row["replayed_device_kernels"] = kernels
    row["replayed_top_kernels"] = top_kernels(by_name)
    params, opt, m = cap(params, opt, host[0])
    row["last_loss"], row["steps"] = float(m["loss"]), int(opt.step)
    if not torch.isfinite(m["loss"]):
        raise SystemExit(f"train granite: loss {row['last_loss']} after {row['steps']} steps")
    torch.cuda.synchronize()
    row["replayed_peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    for mode in ("eager", "replayed"):
        ms = row[f"{mode}_step_ms"]
        row[f"{mode}_idle_share"] = 1 - row[f"{mode}_device_ms"] / ms
        row[f"{mode}_tokens_per_s"] = B * S / (ms / 1e3)
    row["card"] = smi
    print(f"train {MODEL_ARCH} bf16 remat={cfg.remat}: {row['param_count']} params; reckoned "
          f"{row['reckoned_bytes']} bytes (params {pb}, grads {pb}, m and v {sb}) of "
          f"{row['card_bytes']}; step-0 loss {loss0:.6f} vs cross_entropy(forward) "
          f"{float(want):.6f}; {B}x{S} a step: eager {row['eager_step_ms']:.2f} ms (device "
          f"{row['eager_device_ms']:.2f} ms in {row['eager_device_kernels']:.0f} kernels, idle "
          f"share {row['eager_idle_share']:.3f}, {row['eager_tokens_per_s']:.0f} tokens/s, peak "
          f"{row['eager_peak_allocated_bytes']} bytes); replayed {row['replayed_step_ms']:.2f} ms "
          f"(device {row['replayed_device_ms']:.2f} ms in {row['replayed_device_kernels']:.0f} "
          f"kernels, idle share {row['replayed_idle_share']:.3f}, "
          f"{row['replayed_tokens_per_s']:.0f} tokens/s, peak "
          f"{row['replayed_peak_allocated_bytes']} bytes); capture {cap.capture_s:.2f} s, "
          f"instantiation {cap.instantiate_s:.2f} s; loss {row['last_loss']:.4f} after "
          f"{row['steps']} steps ({smi})")
    del params, opt, cap, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_phase(dev, smi):
    """Phase 15: training on the card (see the module docstring).  Each path
    is driven with every kernel's launch count set to 0 just before it and
    read just after: (a) and (c), the models' path, launch none of the
    port's kernels; (b)'s eager run launches the stitched step's generated
    kernels.  Returns the train line's object and each kernel's launches."""
    seconds = {}
    t0 = time.perf_counter()
    zero_launches()
    families = train_families(dev)
    read_launches("train families")
    seconds["families"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    stitched, launches = stitched_train(dev)
    seconds["stitched"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    zero_launches()
    remat = remat_peaks(dev)
    parity = replay_parity(dev)
    seconds["remat_and_parity"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    granite = granite_train(dev, smi)
    read_launches("train granite")
    seconds["granite"] = time.perf_counter() - t1
    seconds["phase"] = time.perf_counter() - t0
    if not launches["emit_fusion"]:
        raise SystemExit(f"train: the stitched step launched no generated kernel: {launches}")
    print(f"train: launches {launches}; seconds { {k: round(v, 1) for k, v in seconds.items()} }")
    return {"families": families, "stitched": stitched, "remat_full_width": remat,
            "replay_vs_eager": parity, "granite": granite, "seconds": seconds, "card": smi,
            "tolerances": {"family_loss": TRAIN_LOSS_TOL, "family_params": TRAIN_PARAM_TOL,
                           "stitched": STITCH_TOL, "loss0_rtol": TRAIN_LOSS0_TOL,
                           "remat_grad_norm": REMAT_NORM_TOL,
                           "replay_grad_norm": REPLAY_NORM_TOL}}, launches


# ---- phase 16: the multi-device compiler -----------------------------------------

# qwen2.5-14b's MLP width, written out because this script imports nothing of
# the JAX package: src/repro/configs/qwen2_5_14b.py (d_model 5120, d_ff 13824,
# SwiGLU)
QWEN14 = dict(d_model=5120, d_ff=13824)
SHARD_WORLD = 4
SHARD_TOKENS = 512
SHARD_SEED = 16
SHARD_CALLS = 10          # timed calls a rank makes of each sharded function
SHARD_PROFILED = 3        # calls a rank's profile traces
# bf16 holds the sharded MLP at four ulps of the largest output: the four
# ranks' partial products are rounded to bf16 before the all-reduce sums
# them, where the unsharded product rounds once
SHARD_BF16_TOL = 2.0 ** -6
SHARD_TIMEOUT_S = 120     # a hung rank fails its collective after this
# a world still running after this fails the phase and its ranks are killed
# (the gloo world took 41 s on an H100, the one-rank NCCL world 31 s)
SHARD_WORLD_DEADLINE_S = 240


def shard_specs():
    """The Megatron placement of the MLP's arguments: x replicated, w_gate
    and w_up split on columns, w_down on rows; the output replicated."""
    return dict(in_specs=((), (None, "model"), (None, "model"), ("model", None)), out_specs=())


def shard_mlp(mesh, dim):
    """The per-shard body: silu(x @ w_gate) * (x @ w_up) @ w_down, summed
    over the ranks of ``mesh``'s dim ``dim``."""
    import torch.distributed._functional_collectives as fc
    import torch.nn.functional as F

    def mlp(x, w_gate, w_up, w_down):
        return fc.all_reduce((F.silu(x @ w_gate) * (x @ w_up)) @ w_down, "sum", (mesh, dim))

    return mlp


def plain_mlp(x, w_gate, w_up, w_down):
    """The unsharded function the sharded runs are held against."""
    import torch.nn.functional as F

    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def shard_gs(mesh, dim):
    """tests/test_sharded_compile.py's gather/scatter function: gather the
    rows of every rank, double, reduce-scatter them back."""
    import warnings

    import torch.distributed._functional_collectives as fc

    def gs(x):
        with warnings.catch_warnings():   # torch 2.13 renames both; 2.11 has only these
            warnings.simplefilter("ignore", FutureWarning)
            g = fc.all_gather_tensor(x, 0, (mesh, dim))
            return fc.reduce_scatter_tensor(g * 2.0, "sum", 0, (mesh, dim))

    return gs


def shard_inputs(dev, dtype):
    """The MLP's global inputs, drawn from ``SHARD_SEED`` on the card: the
    same numbers in every process."""
    import torch

    d, f = QWEN14["d_model"], QWEN14["d_ff"]
    g = torch.Generator(device=dev)
    g.manual_seed(SHARD_SEED)
    x = torch.randn(SHARD_TOKENS, d, generator=g, device=dev)
    wg = torch.randn(d, f, generator=g, device=dev) / d ** 0.5
    wu = torch.randn(d, f, generator=g, device=dev) / d ** 0.5
    wd = torch.randn(f, d, generator=g, device=dev) / f ** 0.5
    return [t.to(dtype) for t in (x, wg, wu, wd)]


def gs_input(dev):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SHARD_SEED + 1)
    return torch.randn(SHARD_WORLD * SHARD_TOKENS, QWEN14["d_model"], generator=g, device=dev)


class CollectiveClock:
    """Counts and times (host clock) the collective steps a plan runs, by
    wrapping ``core.comm.run_collective``: a measurement, no change to what
    runs."""

    def __init__(self):
        from repro_torch.core import comm

        self.comm = comm
        self.inner = comm.run_collective
        self.calls = 0
        self.seconds = 0.0

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = self.inner(*args, **kw)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        comm.run_collective = timed

    def reset(self):
        self.calls, self.seconds = 0, 0.0


def generated_kernels(compiled, device_us_by_kernel):
    """Each generated kernel of a plan: its emitter, the grid and threads
    its launcher gives (None for a cooperative launch, whose grid is the
    card's), its workspace bytes and its device µs a call (from
    ``rank_numbers``' ``device_us_by_kernel``)."""
    import re

    out = []
    for k in compiled.kernels:
        launch = re.search(r"<<<(\d+), (\d+), ", k.fn.source)
        out.append({"name": k.fn.name, "emitter": k.fn.emitter,
                    "grid": int(launch[1]) if launch else None,
                    "threads": int(launch[2]) if launch else None,
                    "workspace_bytes": k.fn.workspace_bytes,
                    "device_us": sum(us for n, us in device_us_by_kernel.items() if k.fn.name in n)})
    return out


def rank_numbers(label, fn, args, planned, clock, every_rank=None):
    """One rank's numbers of one function: ms a call (CUDA events), ms
    inside its collectives (host clock), device µs, kernels and copies a
    call (torch.profiler: ``device_profile`` holds the whole call's device
    events and the generated kernels to the plan, and leaves out gloo's
    own device-timeline spans, ``gloo:*``, which overlap its copies), peak
    allocated bytes.  ``every_rank`` is ``device_profile``'s: in a world of
    several ranks each profile's calls run collectives, so the ranks take
    their profiles again together."""
    import torch

    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock.reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SHARD_CALLS):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / SHARD_CALLS
    coll_ms = clock.seconds * 1e3 / SHARD_CALLS
    coll_calls = clock.calls / SHARD_CALLS
    peak = torch.cuda.max_memory_allocated()
    counts = {}
    seen, by_name = device_profile(lambda: fn(*args), SHARD_PROFILED, label,
                                   per_call=(("stitch_",), planned), ignore=("gloo:",),
                                   counts=counts, every_rank=every_rank)

    def copy(name):   # gloo stages CUDA tensors through pinned host memory
        return name.startswith(("Memcpy", "Memset"))

    kernels = {n: us for n, us in by_name.items() if not copy(n)}
    return {"ms_per_call": ms, "collective_ms_per_call": coll_ms,
            "collective_steps_per_call": coll_calls, "peak_allocated_bytes": peak,
            "device_events_per_call": seen,
            "device_kernels_per_call": sum(k for n, k in counts.items() if not copy(n)),
            "device_us_per_call": sum(kernels.values()),
            "copies_per_call": sum(k for n, k in counts.items() if copy(n)),
            "copy_us_per_call": sum(us for n, us in by_name.items() if copy(n)),
            "device_us_by_kernel": kernels}


def counted_call(fn, args, clock):
    """One call with every launch count at 0 just before and read just
    after; the generated kernels' launches by emitter, the hand-written
    kernels' (none), and the collective steps it ran."""
    import torch

    from repro_torch.core.codegen import KernelProgram
    from repro_torch.kernels import ops

    zero_launches()
    clock.reset()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = dict(KernelProgram.launches_by_emitter)
    hand = {name: k.launches for name, k in ops.KERNELS.items()}
    if any(hand.values()):
        raise SystemExit(f"sharded: the path launched hand-written kernels {hand}")
    return out, {**launches, **hand}, clock.calls


def sharded_rank(rank, world, backend, outdir, device_type):
    """One rank of phase 16's world (module docstring): every case, its
    outputs and numbers saved under ``outdir`` for the parent to hold."""
    import datetime
    import faulthandler

    import torch
    import torch.distributed as dist

    from repro_torch import stitch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.shard import (
        MeshShape, assemble, block_cuts, local_block, spec_to_layout,
    )
    from repro_torch.distributed import make_elastic_mesh, params_shardings, reshard_state
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import init_params, param_specs

    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(0)       # every rank on the one card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a rank still running when the parent's deadline nears prints where it is
    faulthandler.dump_traceback_later(SHARD_WORLD_DEADLINE_S - 20, exit=True)
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(outdir, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    clock = CollectiveClock()
    res = {"rank": rank, "backend": backend}
    saved = {}
    t0 = time.perf_counter()

    def done(case):
        print(f"sharded rank {rank}/{world} {backend}: {case} done at "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    every_rank = None
    if world > 1:
        def every_rank(held):
            # a profile refused on one rank is taken again on all of them, so
            # that every rank runs the same collectives
            flag = torch.tensor([int(held)])
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
            return bool(flag.item())

    if world == 1:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(device_type, (1,), mesh_dim_names=("model",))
        dim = 0
        # the unsharded plan of the same function, its numbers taken in this
        # fresh process as the ranks' are
        for label, dtype in (("mlp_f32", torch.float32), ("mlp_bf16", torch.bfloat16)):
            args = shard_inputs(dev, dtype)
            f = stitch(plain_mlp, device=device_type)
            f(*args)
            compiled = f._last.compiled
            numbers = rank_numbers(f"unsharded {label}", f, args, planned_launches(compiled),
                                   clock)
            res[f"unsharded_{label}"] = {
                **{k: v for k, v in numbers.items() if k != "device_us_by_kernel"},
                "top_kernels": top_kernels(numbers["device_us_by_kernel"]),
                "generated": generated_kernels(compiled, numbers["device_us_by_kernel"]),
                "replay_mode": compiled.stats.replay_mode,
                "plan": {"stitched_kernels": compiled.stats.stitched_kernels,
                         "standalone_kernels": compiled.stats.standalone_kernels}}
            del args
            done(f"unsharded {label}")
    else:
        # the rules against the world: qwen2.5-14b's specs on a shape-only
        # (data 1, model 4) mesh and on the world's smoke mesh
        mesh = make_smoke_mesh(1, world, device=device_type)
        dim = 1
        specs = param_specs(get_config("qwen2.5-14b"))
        flat = {}

        def walk(tree, path=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, f"{path}/{k}")
            else:
                flat[path] = tree

        walk(params_shardings(specs, MeshShape(("data", "model"), (1, world))))
        shape_only = {k: s.spec for k, s in flat.items()}
        flat.clear()
        walk(params_shardings(specs, mesh))
        res["rules"] = {"specs": shape_only,
                        "same_on_the_world": {k: s.spec for k, s in flat.items()} == shape_only}
        done("rules")

    cases = [("mlp_f32", torch.float32), ("mlp_bf16", torch.bfloat16)]
    for label, dtype in cases:
        args = shard_inputs(dev, dtype)
        f = stitch(shard_mlp(mesh, dim), mesh=mesh, device=device_type, **shard_specs())
        if rank == 0:
            f.lower(*args).compile()   # builds the plan's source before the others load it
        dist.barrier()
        out, launches, steps = counted_call(f, args, clock)
        compiled = f._last.compiled
        ep = compiled.executable.execution_plan
        saved[label] = out.cpu()
        numbers = rank_numbers(f"sharded {label} rank {rank}", f, args,
                               planned_launches(compiled), clock, every_rank)
        res[label] = {
            "launches": launches, "planned": planned_launches(compiled),
            "collective_steps": steps, "collective_calls": compiled.stats.collective_calls,
            "replay_mode": compiled.stats.replay_mode,
            "sharded_instrs": compiled.stats.sharded_instrs,
            "plan": {"stitched_kernels": compiled.stats.stitched_kernels,
                     "standalone_kernels": compiled.stats.standalone_kernels,
                     "library_calls": compiled.stats.library_calls},
            "collectives": [list(c) for c in ep.collectives],
            "numbers": numbers,
            "generated": generated_kernels(compiled, numbers["device_us_by_kernel"]),
        }
        del args
        done(label)

    if world > 1:
        x = gs_input(dev)
        f = stitch(shard_gs(mesh, dim), mesh=mesh, device=device_type, in_specs=(("model",),),
                   out_specs=("model",))
        if rank == 0:
            f.lower(x).compile()
        dist.barrier()
        out, launches, steps = counted_call(f, [x], clock)
        compiled = f._last.compiled
        ex = compiled.executable
        saved["gather_scatter"] = out.cpu()
        res["gather_scatter"] = {
            "launches": launches, "planned": planned_launches(compiled),
            "collective_steps": steps, "collective_calls": compiled.stats.collective_calls,
            "assembly_gathers": ex.launch_stats().assembly_gathers,
            "collectives": [list(c) for c in ex.execution_plan.collectives],
            "assembly_forms": [[form for _, _, form in g] for g in ex._assembly],
            "numbers": rank_numbers(f"sharded gather_scatter rank {rank}", f, [x],
                                    planned_launches(compiled), clock, every_rank),
        }
        done("gather_scatter")

        # reshard a reduced qwen1.5-0.5b onto the elastic mesh: each rank's
        # shard is its block of the input, and the blocks gather back to it
        params = init_params(reduced_config(get_config("qwen1.5-0.5b")), SHARD_SEED, device=dev)
        emesh = make_elastic_mesh(world, device=device_type)
        placed, _ = reshard_state(params, None, emesh)
        shard = params_shardings(params, emesh)
        leaves = blocks_ok = gathered_ok = split = 0
        stack = [(params, placed, shard)]
        while stack:
            a, b, s = stack.pop()
            if isinstance(a, dict):
                stack.extend((a[k], b[k], s[k]) for k in a)
                continue
            lay = spec_to_layout(s.spec, a.ndim)
            local = b.to_local()
            leaves += 1
            split += int(local.numel() < a.numel())
            blocks_ok += int(torch.equal(local, local_block(a, block_cuts(lay, emesh))))
            gathered_ok += int(torch.equal(assemble(local, lay, emesh), a))
        res["reshard"] = {"mesh": [list(emesh.shape), list(emesh.mesh_dim_names)],
                          "leaves": leaves, "split_leaves": split, "blocks_equal": blocks_ok,
                          "gathered_equal": gathered_ok}
        done("reshard")

    res["profile_retakes"] = RETAKES
    res["profile_edge_losses"] = EDGE_LOSSES
    torch.save(saved, os.path.join(outdir, f"rank{rank}.pt"))
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()


def world_dir(prefix):
    """A fresh directory under ``build/`` for a world's store and files."""
    import tempfile

    base = os.path.join(HERE, "build")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=base)


def spawn_ranks(target, args, nprocs, label):
    """``nprocs`` processes of ``target(rank, *args)``: a failing one raises
    here (``torch.multiprocessing.spawn``), and so does a world still
    running after ``SHARD_WORLD_DEADLINE_S``, whose processes are killed."""
    import torch.multiprocessing as mp

    join_ranks(mp.spawn(target, args=args, nprocs=nprocs, join=False), label)


def join_ranks(ctx, label):
    """Wait for a spawned context as ``spawn_ranks`` does, from when this
    is called."""
    deadline = time.monotonic() + SHARD_WORLD_DEADLINE_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                alive = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                raise SystemExit(f"{label} still ran after {SHARD_WORLD_DEADLINE_S} s "
                                 f"(ranks {alive} alive)")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def run_world(world, backend, device_type):
    """Spawn ``world`` ranks of ``sharded_rank``; a failing rank raises here
    (``torch.multiprocessing.spawn``), and fails the phase, and so does a
    world still running after ``SHARD_WORLD_DEADLINE_S``: its ranks are
    killed.  Returns each rank's numbers and outputs, and adds the ranks'
    refused profiles to ``RETAKES``; the world's directory under ``build/``
    (its store and the ranks' saved outputs) is removed once read."""
    import torch

    outdir = world_dir("sharded.")
    out = []
    try:
        spawn_ranks(sharded_rank, (world, backend, outdir, device_type), world,
                    f"sharded: the {backend} world of {world}")
        for r in range(world):
            with open(os.path.join(outdir, f"rank{r}.json")) as fh:
                res = json.load(fh)
            res["outputs"] = torch.load(os.path.join(outdir, f"rank{r}.pt"))
            RETAKES.extend(res.pop("profile_retakes"))
            EDGE_LOSSES.extend(res.pop("profile_edge_losses"))
            out.append(res)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    return out


def sharded_phase(dev, smi):
    """Phase 16: the multi-device compiler on the card (module docstring).
    Returns the sharded line's object and the generated kernels' launches
    in the ranks' counted calls, by emitter."""
    import torch

    import gc

    # what earlier phases keep cached goes back to the card, for the ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the unsharded function on the card, in this process, f32 and bf16
    want = {}
    for label, dtype in (("mlp_f32", torch.float32), ("mlp_bf16", torch.bfloat16)):
        args = shard_inputs(dev, dtype)
        want[label] = plain_mlp(*args).cpu()
        del args
    want["gather_scatter"] = (8.0 * gs_input(dev)).cpu()
    torch.cuda.empty_cache()
    seconds = {"unsharded": time.perf_counter() - t0}

    t1 = time.perf_counter()
    # the backend rule: NCCL refuses two ranks on one card ("Duplicate GPU
    # detected"), so the four ranks run over gloo; one rank runs over NCCL
    # (gloo on the CPU)
    ranks = run_world(SHARD_WORLD, "gloo", dev.type)
    seconds["gloo_world"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    nccl = run_world(1, "nccl" if dev.type == "cuda" else "gloo", dev.type)
    seconds["nccl_world"] = time.perf_counter() - t1

    # ---- right ---------------------------------------------------------------------
    tols = {"mlp_f32": (TOL, TOL), "gather_scatter": (TOL, TOL)}
    errs = {}
    for label in ("mlp_f32", "mlp_bf16", "gather_scatter"):
        w = want[label].float()
        if label == "mlp_bf16":
            tol = SHARD_BF16_TOL
            atol = tol * float(w.abs().max())
            tols[label] = (tol, atol)
        rtol, atol = tols[label]
        for res in ranks:
            got = res["outputs"][label].float()
            if got.shape != w.shape or not torch.allclose(got, w, rtol=rtol, atol=atol):
                raise SystemExit(f"sharded {label} rank {res['rank']}: max |err| "
                                 f"{float((got - w).abs().max())} past rtol {rtol} atol {atol}")
            if not same(res["outputs"][label], ranks[0]["outputs"][label]):
                raise SystemExit(f"sharded {label}: rank {res['rank']} differs from rank 0")
        errs[label] = max(float((r["outputs"][label].float() - w).abs().max()) for r in ranks)
        for res in ranks:
            row = res[label]
            emitted = row["launches"]["emit_fusion"] + row["launches"]["emit_stitched_fusion"]
            if emitted != row["planned"] or row["planned"] < 1 and label != "gather_scatter":
                raise SystemExit(f"sharded {label} rank {res['rank']}: {emitted} generated "
                                 f"launches, planned {row['planned']}")
            if row["collective_steps"] != row["collective_calls"]:
                raise SystemExit(f"sharded {label} rank {res['rank']}: ran "
                                 f"{row['collective_steps']} collectives, planned "
                                 f"{row['collective_calls']}")
    for res in ranks:
        for label in ("mlp_f32", "mlp_bf16"):
            if res[label]["collective_steps"] != 1 or res[label]["replay_mode"] != "sharded":
                raise SystemExit(f"sharded {label} rank {res['rank']}: "
                                 f"{res[label]['collective_steps']} collectives a call")
        if not res["rules"]["same_on_the_world"]:
            raise SystemExit(f"sharded rank {res['rank']}: the world's specs differ")
        rs = res["reshard"]
        if rs["blocks_equal"] != rs["leaves"] or rs["gathered_equal"] != rs["leaves"] \
                or rs["split_leaves"] < 1:
            raise SystemExit(f"sharded rank {res['rank']}: reshard {rs}")
    n0 = nccl[0]
    w = want["mlp_f32"]
    if not torch.allclose(n0["outputs"]["mlp_f32"], w, rtol=TOL, atol=TOL):
        raise SystemExit(f"sharded nccl: max |err| "
                         f"{float((n0['outputs']['mlp_f32'] - w).abs().max())}")
    errs["nccl_mlp_f32"] = float((n0["outputs"]["mlp_f32"] - w).abs().max())
    seconds["phase"] = time.perf_counter() - t0

    # ---- numbers -------------------------------------------------------------------
    d, f = QWEN14["d_model"], QWEN14["d_ff"]
    flop = 3 * 2 * SHARD_TOKENS * d * (f // SHARD_WORLD)
    launches = {"emit_fusion": 0, "emit_stitched_fusion": 0}
    per_rank = []
    for res in ranks:
        row = {"rank": res["rank"]}
        for label in ("mlp_f32", "mlp_bf16", "gather_scatter"):
            for k in launches:
                launches[k] += res[label]["launches"][k]
            row[label] = {k: v for k, v in res[label].items() if k != "numbers"}
            row[label].update({k: v for k, v in res[label]["numbers"].items()
                               if k != "device_us_by_kernel"})
            row[label]["top_kernels"] = top_kernels(res[label]["numbers"]["device_us_by_kernel"])
        row["reshard"] = res["reshard"]
        per_rank.append(row)
        for label in ("mlp_f32", "mlp_bf16", "gather_scatter"):
            n = res[label]["numbers"]
            print(f"sharded rank {res['rank']} {label}: {n['ms_per_call']:.3f} ms a call, "
                  f"{n['collective_ms_per_call']:.3f} ms in collectives, "
                  f"{n['device_us_per_call']:.1f} device us in "
                  f"{n['device_kernels_per_call']:.2f} kernels and {n['copy_us_per_call']:.1f} "
                  f"in {n['copies_per_call']:.2f} copies a call, generated launches "
                  f"{res[label]['launches']['emit_fusion']}+"
                  f"{res[label]['launches']['emit_stitched_fusion']} "
                  f"(planned {res[label]['planned']}), peak {n['peak_allocated_bytes']} bytes, "
                  f"ops {res[label]['collectives']} ({smi})")
    for label in ("mlp_f32", "mlp_bf16"):
        # the generated kernels (silu x mul) of each rank and of the unsharded plan
        for who, gen in [(f"rank {res['rank']}", res[label]["generated"]) for res in ranks] + [
                ("unsharded", n0[f"unsharded_{label}"]["generated"])]:
            for k in gen:
                print(f"sharded {label} {who}: generated kernel {k['name']} ({k['emitter']}): "
                      f"grid {k['grid']} x {k['threads']} threads, {k['workspace_bytes']} workspace "
                      f"bytes, {k['device_us']:.2f} device us a call ({smi})")
                # silu x mul holds its convert in a register: a pure map, no workspace
                if k["emitter"] == "emit_fusion" and k["workspace_bytes"]:
                    raise SystemExit(f"sharded {label} {who}: {k['name']} keeps "
                                     f"{k['workspace_bytes']} workspace bytes")
    for label in ("mlp_f32", "mlp_bf16"):
        n = n0[f"unsharded_{label}"]
        print(f"sharded: unsharded plan {label}, one process: {n['ms_per_call']:.3f} ms a call, "
              f"{n['device_us_per_call']:.1f} device us in {n['device_kernels_per_call']:.2f} "
              f"kernels and {n['copy_us_per_call']:.1f} in {n['copies_per_call']:.2f} copies "
              f"and memsets a call, peak {n['peak_allocated_bytes']} bytes ({smi})")
    rules = ranks[0]["rules"]["specs"]
    for path in sorted(rules):
        print(f"sharded rules: {path} {rules[path]}")
    print("sharded: gloo stages CUDA tensors through the host: its collective times are "
          "not NCCL's")
    row = {
        "card": smi, "world": SHARD_WORLD, "backend": "gloo", "tokens": SHARD_TOKENS,
        "width": QWEN14, "flop_per_rank_mlp": flop,
        "f32_bound_ms_per_rank": flop / F32_OPS_PER_S * 1e3,
        "max_abs_err": errs, "tolerances": {k: list(v) for k, v in tols.items()},
        "unsharded": {label: n0[f"unsharded_{label}"] for label in ("mlp_f32", "mlp_bf16")},
        "ranks": per_rank,
        "nccl_one_rank": {k: v for k, v in n0["mlp_f32"]["numbers"].items()
                          if k != "device_us_by_kernel"}
        | {"collectives": n0["mlp_f32"]["collectives"], "launches": n0["mlp_f32"]["launches"]},
        "rules_qwen2_5_14b_data1_model4": rules,
        "gloo_stages_through_host": True, "seconds": seconds,
    }
    print(f"sharded: launches {launches}; seconds { {k: round(v, 1) for k, v in seconds.items()} }")
    return row, launches


# ---- phase 17: sharded training and the launch tools -------------------------------

# qwen1.5-0.5b, written out because this script imports nothing of the JAX
# package: src/repro/configs/qwen1_5_0_5b.py (24 layers, d_model 1024, 16
# heads, d_ff 2816, vocab 151,936, bf16, remat "full")
SP_ARCH = "qwen1.5-0.5b"
SP_MESH = (2, 2)                  # (data, model): SHARD_WORLD ranks on the one card
SP_SHAPE = (4, 512)               # global batch, tokens
SP_STEPS = 3
SP_SEED = 17
SP_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
SP_LOSS_RTOL = 2e-3
# the gathered params against the unsharded step's, elementwise: 2 lr_t a
# step summed over the steps, and one bf16 ulp of the value.  AdamW's first
# updates are ±lr_t wherever the gradient is not zero, so an element whose
# gradient is near zero, and whose sign the ranks' bf16 sums flip, moves by
# 2 lr_t a step (the first chip run: 14,291 of 619,832,320 elements past 2 lr,
# the largest 0.00146 = 2 (1.5e-4 + 3e-4 + 3e-4)).  The count past 2 lr and
# |p - p_oracle| over |p_oracle - p_0| (L2 norms) are reported; each step's
# gradient norm, a sum over every element, is held at SP_LOSS_RTOL.
SP_PARAM_LR = 2 * SP_OPT["lr"]
SP_LAUNCH_ARGV = ["--arch", SP_ARCH, "--mesh", "2,2", "--reduced", "--steps", "2",
                  "--batch", "4", "--seq", "64"]
#: the generated kernel whose device time gives the H100 spec's launch and
#: grid-step overheads: exp over (rows, 256) f32
OVERHEAD_ROWS = (8, 8448)
OVERHEAD_BLOCKS = 8


def sp_setup():
    """(a)'s config (``activation_sharding="sp"``), optimizer config and
    the global batches (numpy, from ``SyntheticLM``): the same in every
    process."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.train import AdamWConfig

    cfg = dataclasses.replace(get_config(SP_ARCH), activation_sharding="sp")
    B, S = SP_SHAPE
    data = SyntheticLM(cfg, S, B, seed=SP_SEED).iterate(0)
    return cfg, AdamWConfig(**SP_OPT), [next(data) for _ in range(SP_STEPS)]


def sp_oracle(rank, outdir, device_type):
    """(a)'s oracle: the same steps unsharded (``make_train_step``, eager),
    in a fresh process on the card; the losses, ms a step and the final
    params, saved under ``outdir``."""
    import torch

    from repro_torch import models
    from repro_torch.train import adamw_init, make_train_step

    dev = torch.device(device_type)
    cfg, ocfg, batches = sp_setup()
    params = models.init_params(cfg, SP_SEED, device=dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, ocfg)
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for b in batches:
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        params, opt, m = step(params, opt, b)
        t1.record()
        torch.cuda.synchronize()
        rows.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "ms": t0.elapsed_time(t1)})
    res = {"steps": rows, "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": models.tree_bytes(params) + models.tree_bytes(opt.m)
           + models.tree_bytes(opt.v) + opt.step.numel() * opt.step.element_size(),
           "param_count": models.count_params(params)}
    torch.save({k: t.cpu() for k, t in flat_leaves(params).items()},
               os.path.join(outdir, "oracle.pt"))
    with open(os.path.join(outdir, "oracle.json"), "w") as fh:
        json.dump(res, fh)


def flat_leaves(tree, prefix=""):
    """{path: leaf} of a tree of dicts."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


class CollectiveMeter:
    """Counts, sizes (result bytes, by the census's kinds) and times (host
    clock) every collective ``core.comm`` runs, by wrapping its tensor
    collectives: a measurement, no change to what runs."""

    KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter"}

    def __init__(self):
        from repro_torch.core import comm

        self.reset()
        for name, kind in self.KINDS.items():
            inner = getattr(comm, name)

            def timed(*args, _inner=inner, _kind=kind, **kw):
                t0 = time.perf_counter()
                out = _inner(*args, **kw)
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                self.bytes[_kind] = self.bytes.get(_kind, 0) + out.numel() * out.element_size()
                return out

            setattr(comm, name, timed)

    def reset(self):
        self.calls, self.seconds, self.bytes = 0, 0.0, {}


def sp_rank(rank, world, outdir, device_type):
    """One rank of (a) and (b): the sharded steps, their checks and
    numbers, then ``launch.train --mesh 2,2`` (module docstring)."""
    import datetime
    import faulthandler

    import torch
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.core.shard import block_cuts, dtensor_layout, local_block
    from repro_torch.distributed import reshard_state
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.train import (
        adamw_init, gather_tree, lr_at, make_sharded_train_step, rank_rows, row_axes,
    )

    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(0)       # every rank on the one card
    faulthandler.dump_traceback_later(SHARD_WORLD_DEADLINE_S - 20, exit=True)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(outdir, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    t_start = time.perf_counter()

    def done(case):
        print(f"sharded_train rank {rank}/{world}: {case} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    cfg, ocfg, batches = sp_setup()
    mesh = make_smoke_mesh(*SP_MESH, device=device_type)
    params = models.init_params(cfg, SP_SEED, device=dev)
    # params, f32 m and v, the int32 step, held whole by the unsharded step
    unsharded = models.tree_bytes(params) + 2 * 4 * models.count_params(params) + 4
    params, opt = reshard_state(params, adamw_init(params), mesh)
    torch.cuda.synchronize()
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    meter = CollectiveMeter()
    step = make_sharded_train_step(cfg, ocfg, mesh)
    mine = rank_rows({k: torch.as_tensor(v) for k, v in batches[0].items()}, mesh)
    res = {"rank": rank, "row_axes": list(row_axes(mesh, SP_SHAPE[0])),
           "at_rest_bytes": dryrun.rank_argument_bytes(params, opt, {}),
           "argument_bytes": dryrun.rank_argument_bytes(params, opt, mine),
           "unsharded_state_bytes": unsharded, "steps": []}
    zero_launches()
    for b in batches:
        meter.reset()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        params, opt, m = step(params, opt, b)
        t1.record()
        torch.cuda.synchronize()
        res["steps"].append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                             "ms": t0.elapsed_time(t1), "collective_ms": meter.seconds * 1e3,
                             "collective_calls": meter.calls, "bytes_by_kind": dict(meter.bytes)})
    res["launches"] = read_launches("sharded train")
    res["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    done("steps")

    # the checks: blocks at rest are the rules' cut of the gathered params,
    # replicated leaves bit for bit across ranks, the params against the
    # unsharded step's (rank 0)
    full = gather_tree(params)
    blocks_ok, leaves, replicated = 0, 0, {}
    for path, p in flat_leaves(params).items():
        g = flat_leaves(full)[path]
        lay = dtensor_layout(p)
        leaves += 1
        blocks_ok += int(torch.equal(p.to_local(), local_block(g, block_cuts(lay, mesh))))
        if not any(lay):
            replicated[path] = p.to_local().cpu()
    res["blocks_equal"], res["leaves"] = blocks_ok, leaves
    torch.save(replicated, os.path.join(outdir, f"replicated{rank}.pt"))
    if rank == 0:
        want = torch.load(os.path.join(outdir, "oracle.pt"))
        init = flat_leaves(models.init_params(cfg, SP_SEED, device=dev))
        lr_sum = sum(float(lr_at(ocfg, i)) for i in range(SP_STEPS))
        worst, over, over_2lr, diff2, upd2 = 0.0, 0, 0, 0.0, 0.0
        for path, w in want.items():
            g = flat_leaves(full)[path].cpu().float()
            w = w.float()
            err = (g - w).abs()
            ulp = torch.finfo(torch.bfloat16).eps * torch.maximum(g.abs(), w.abs())
            over += int((err > 2 * lr_sum + ulp).sum())
            over_2lr += int((err > SP_PARAM_LR + ulp).sum())
            worst = max(worst, float(err.max()))
            diff2 += float((err.double() ** 2).sum())
            upd2 += float(((w - init[path].cpu().float()).double() ** 2).sum())
        res.update(param_max_abs_err=worst, params_over_bound=over, params_over_2lr=over_2lr,
                   param_bound=2 * lr_sum, update_rel_err=(diff2 / upd2) ** 0.5)
    del full
    done("checks")

    # (b) the entry point in every rank of this world
    ck = os.path.join(outdir, "ck")
    t0 = time.perf_counter()
    res["launch_rc"] = tlaunch.main(SP_LAUNCH_ARGV + ["--ckpt-dir", ck])
    res["launch_s"] = time.perf_counter() - t0
    done("launch.train")
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()


def gc_collect():
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sp_dryrun(rank, outdir):
    """(d): ``run_cell``'s measurement of (a)'s cell, rank 0 of a fake
    world of SHARD_WORLD ranks on a (data 2, model 2) mesh, on meta
    tensors, in a fresh process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun

    _, ocfg, _ = sp_setup()
    dryrun.fake_world(SHARD_WORLD)
    try:
        mesh = init_device_mesh("cpu", SP_MESH, mesh_dim_names=("data", "model"))
        B, S = SP_SHAPE
        t0 = time.perf_counter()
        cell = dryrun.build_cell(SP_ARCH, "phase17", mesh, 1,
                                 shape=dict(seq_len=S, global_batch=B, kind="train"),
                                 opt_cfg=ocfg)
        rec = dryrun.measure_cell(cell, "2x2", SHARD_WORLD, SP_ARCH, "phase17",
                                  time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, "dryrun.json"), "w") as fh:
        json.dump(rec, fh)


def overhead_module(rows, blocks, device):
    """exp over (rows, 256) f32 compiled under ``max_blocks=blocks``."""
    import numpy as np

    from repro_torch.core import StitchOptions, compile_module, trace
    from repro_torch.core.latency import TPU_V5E

    module = trace(lambda b, x: b.exp(x), ("x", (rows, 256), np.float32))
    return compile_module(module, StitchOptions(jit_replay=False, max_blocks=blocks,
                                                device_spec=TPU_V5E), device=device)


OVERHEAD_CASES = ((OVERHEAD_ROWS[0], 1), (OVERHEAD_ROWS[1], 1), (OVERHEAD_ROWS[1], OVERHEAD_BLOCKS))


#: (c)'s block-count curve: one generated memory-bound kernel with a slot
#: (x * rsqrt(mean(x * x)) over (CURVE_ROWS, CURVE_WIDTH) f32), so that each
#: plan block runs on a CUDA block of its own, at each of these plan blocks
CURVE_ROWS, CURVE_WIDTH = 8448, 256
CURVE_BLOCKS = (1, 2, 4, 8, 16, 32, 64, 128, 132, 256, 264)
#: (c)'s shared-memory rate: kernels over (CURVE_ROWS, VMEM_WIDTH) f32 in
#: VMEM_BLOCKS plan blocks that keep 1 .. VMEM_STEPS[-1] chained slots, the
#: same bytes in and out of global memory in each
VMEM_BLOCKS, VMEM_WIDTH = 264, 64
VMEM_STEPS = (1, 2, 3, 4, 5, 6, 7, 8)
#: (c)'s grid barrier: one stitched kernel of an elementwise chain over
#: PHASE_SHAPE cut into 1 .. PHASE_COUNTS[-1] phases, the same work in each
PHASE_SHAPE = (528, 128)
PHASE_CHAIN = 8
PHASE_COUNTS = (1, 2, 3, 4, 5, 6, 7, 8)


def forced_kernel(module, blocks, vmem_limit=None):
    """The one fusion of ``module``'s plan emitted under a chosen schedule:
    its root split into ``blocks`` plan blocks on dim 0, memory planned for
    the H100 within ``vmem_limit`` (the spec's budget when None)."""
    from repro_torch.core import StitchOptions, compile_module
    from repro_torch.core.codegen import emit_fusion
    from repro_torch.core.latency import H100
    from repro_torch.core.memory import plan_memory
    from repro_torch.core.pipeline import default_vmem_limit
    from repro_torch.core.schedule import ROW, Sched, resolve_schedules

    (fusion,) = compile_module(module, StitchOptions(device_spec=H100, jit_replay=False),
                               device="cpu").executable.plan.fusions
    roots = fusion.roots
    sol = resolve_schedules(fusion.members, roots,
                            {r.id: Sched("chunked", 0, blocks, ROW) for r in roots}, 512 * 1024)
    limit = default_vmem_limit(H100) if vmem_limit is None else vmem_limit
    return emit_fusion(fusion, sol, plan_memory(fusion.members, roots, sol, limit, H100))


def curve_module():
    import numpy as np

    from repro_torch.core import trace

    def f(b, x):
        r = b.rsqrt(b.reduce(x * x, (1,)) * (1.0 / CURVE_WIDTH) + 1e-6)
        return x * b.broadcast(r, x.shape, (0,))

    return trace(f, ("x", (CURVE_ROWS, CURVE_WIDTH), np.float32), name="curve")


def vmem_module(steps):
    """a_1 = 1.5 x + 0.25, a_i = 1.5 a_(i-1) + 0.25, each read by a reduce
    r_i and by the next step, and out = a_steps * (r_1 + ... + r_steps):
    each a_i keeps a slot (a reduce reads it), and each step adds a loop
    that reads a slot and writes one and a reduce that reads it again, and
    no byte of global memory."""
    import numpy as np

    from repro_torch.core import trace

    def f(b, x):
        a, total = x, None
        for _ in range(steps):
            a = a * 1.5 + 0.25
            r = b.reduce(a, (1,))
            total = r if total is None else total + r
        return a * b.broadcast(total, x.shape, (0,))

    return trace(f, ("x", (CURVE_ROWS, VMEM_WIDTH), np.float32), name=f"vmem{steps}")


def vmem_kernels():
    """One generated kernel for each count of VMEM_STEPS, every a_i in a
    slot of shared memory (none shrunk), and the bytes one step moves
    through shared memory in all plan blocks (a slot read, a slot written,
    the reduce's read)."""
    from repro_torch.core.memory import ALLOC, SHARE

    out = []
    for n in VMEM_STEPS:
        kernel = forced_kernel(vmem_module(n), VMEM_BLOCKS)
        slots = [e for e in kernel.plan.entries.values() if e.action in (ALLOC, SHARE)]
        if kernel.plan.shrunk or len([e for e in slots if e.nbytes > 4 * 64]) < n:
            raise SystemExit(f"vmem kernel of {n} steps: shrunk {kernel.plan.shrunk}, "
                             f"{len(slots)} slots")
        out.append(kernel)
    tile = (CURVE_ROWS // VMEM_BLOCKS) * VMEM_WIDTH * 4
    return out, 3 * tile * VMEM_BLOCKS


def phase_kernels():
    """One stitched kernel per count in PHASE_COUNTS: the chain
    x -> x * 1.5 + 0.25 (PHASE_CHAIN times) cut into that many phases."""
    import numpy as np

    from repro_torch.core import StitchOptions, compile_module, trace
    from repro_torch.core.codegen import emit_stitched_fusion
    from repro_torch.core.fusion import FusedComputation, constant_like
    from repro_torch.core.latency import H100
    from repro_torch.core.memory import plan_stitched_memory
    from repro_torch.core.pipeline import default_vmem_limit
    from repro_torch.core.schedule import (
        ROW, PhaseSolution, Sched, StitchedSolution, resolve_schedules)

    def f(b, x):
        for _ in range(PHASE_CHAIN):
            x = x * 1.5 + 0.25
        return x

    module = trace(f, ("x", PHASE_SHAPE, np.float32), name="phases")
    (fusion,) = compile_module(module, StitchOptions(device_spec=H100, jit_replay=False),
                               device="cpu").executable.plan.fusions
    ops = [m for m in fusion.members if not constant_like(m)]
    out = []
    for n in PHASE_COUNTS:
        cut = {m.id: k * n // len(ops) for k, m in enumerate(ops)}
        phase_of = {}
        for m in reversed(fusion.members):
            phase_of[m.id] = cut.get(m.id, min((phase_of[u.id] for u in m.users
                                                if u.id in phase_of), default=0))
        phases = []
        for k in range(n):
            members = [m for m in fusion.members if phase_of[m.id] == k]
            ids = {m.id for m in members}
            roots = [m for m in members if not m.users or any(u.id not in ids for u in m.users)]
            sol = resolve_schedules(members, roots,
                                    {r.id: Sched("chunked", 0, 1, ROW) for r in roots}, 512 * 1024)
            phases.append(PhaseSolution(members, roots, sol))
        ifaces = [m for m in fusion.members
                  if any(phase_of.get(u.id, -1) > phase_of[m.id] for u in m.users)]
        st = StitchedSolution(phases, ifaces)
        mem = plan_stitched_memory(st, default_vmem_limit(H100), H100)
        out.append(emit_stitched_fusion(FusedComputation(list(fusion.members), name="phases"),
                                        st, mem))
    return out


#: (c)'s L2 read rate: a batched dot split at its rows, one row a plan
#: block, each block staging its batch's whole (L2_K, L2_N) rhs (131,072
#: bytes) from the L2; (batches, rows a batch), the whole rhs 128 KiB, 3 MiB
#: (the Figure-3 attention's v at granite width), 12 MiB and 48 MiB
L2_CASES = ((1, 2048), (24, 512), (96, 512), (384, 512))
L2_K, L2_N = 512, 64
#: the replicate limit those plans are resolved under: every case's rhs,
#: whatever the spec's own L2 limit
L2_REPLICATE_LIMIT = 64 << 20
#: (c)'s rates of ops composed into a staged dot's lhs: a chain of
#: STAGED_CHAIN applications of each op over the (B, M, K) lhs of a dot with
#: an (B, K, N) rhs, split into STAGED_ROW_BLOCKS row blocks a batch (a
#: multiply's added time stayed within the run's noise: it is left unpriced)
STAGED_OPS = ("exp", "div")
STAGED_CHAIN = 8
STAGED_B, STAGED_M, STAGED_K, STAGED_N = 8, 512, 512, 256
STAGED_ROW_BLOCKS = 16


def staged_modules():
    """(c)'s modules: ("l2 B", the row-split dot of B batches) for each of
    L2_CASES, ("plain", the staged dot on a stored lhs) and (op, the same
    dot on STAGED_CHAIN applications of op composed into its lhs) for each
    of STAGED_OPS."""
    import numpy as np

    from repro_torch.core import trace

    f4 = np.float32
    out = [(f"l2 {bs}", trace(lambda b, x, w: b.dot(x, w, fusable=True),
                              ("x", (bs, rows, L2_K), f4), ("w", (bs, L2_K, L2_N), f4),
                              name="l2_dot")) for bs, rows in L2_CASES]
    step = {"plain": None, "exp": lambda b, y: b.exp(-y), "div": lambda b, y: y / 1.01}
    for op in ("plain",) + STAGED_OPS:
        def f(b, x, w, op=op):
            for _ in range(STAGED_CHAIN if step[op] else 0):
                x = step[op](b, x)
            return b.dot(x, w, fusable=True)
        out.append((op, trace(f, ("x", (STAGED_B, STAGED_M, STAGED_K), f4),
                              ("w", (STAGED_B, STAGED_K, STAGED_N), f4), name=f"staged_{op}")))
    return out


def staged_kernel(module, row_blocks, replicate_limit=512 * 1024):
    """The fusion of ``module`` holding its dot, split at the dot's rows
    into ``row_blocks`` plan blocks a batch (``schedule.dot_row_split``),
    every member composed (a memory plan of 0 bytes), emitted; its rhs
    replicated up to ``replicate_limit`` bytes or the spec's L2 limit."""
    from repro_torch.core import StitchOptions, compile_module
    from repro_torch.core.codegen import emit_fusion
    from repro_torch.core.latency import H100
    from repro_torch.core.memory import plan_memory
    from repro_torch.core.schedule import ROW, Sched, resolve_schedules

    fusions = compile_module(module, StitchOptions(device_spec=H100, jit_replay=False),
                             device="cpu").executable.plan.fusions
    (fusion,) = [f for f in fusions if any(m.opcode == "dot" for m in f.members)]
    if len(fusion.members) != len([i for i in module.instructions if i.opcode != "parameter"]):
        raise SystemExit(f"{module.name}: the dot's fusion leaves members out")
    (root,) = fusion.roots
    sol = resolve_schedules(fusion.members, fusion.roots,
                            {root.id: Sched("chunked", root.ndim - 2, row_blocks, ROW)},
                            replicate_limit, H100)
    return emit_fusion(fusion, sol, plan_memory(fusion.members, fusion.roots, sol, 0, H100))


def staged_constants(dev, held):
    """(c)'s staged-dot constants: ``l2_bw``, the rhs bytes every block of
    a row-split dot reads from the L2 over its device time, at each of
    L2_CASES' whole rhs (``l2_read_limit``: the largest of them), and
    ``staged_op_rates``, each op's elements a second where it is composed
    into a staged dot's lhs: STAGED_CHAIN x the lhs's elements over the
    device time the chain adds to the dot on a stored lhs."""
    import torch

    mods = dict(staged_modules())
    out = {"l2": []}
    for bs, rows in L2_CASES:
        k = staged_kernel(mods[f"l2 {bs}"], rows, L2_REPLICATE_LIMIT)
        x = torch.rand(bs, rows, L2_K, device=dev)
        w = torch.rand(bs, L2_K, L2_N, device=dev)
        label = f"l2 row-split dot, {bs} batches"
        us = kernel_device_us(label, k, (x, w), dev)
        held(label, k, (x, w))
        l2_bytes = bs * rows * L2_K * L2_N * 4
        out["l2"].append({"kernel": k.fn.source.splitlines()[0], "device_us": us,
                          "whole_rhs_bytes": w.numel() * 4, "rhs_bytes_read": l2_bytes,
                          "l2_bw": l2_bytes / (us * 1e-6)})
        del x, w
    x = torch.rand(STAGED_B, STAGED_M, STAGED_K, device=dev)
    w = torch.rand(STAGED_B, STAGED_K, STAGED_N, device=dev)
    times = {}
    for op in ("plain",) + STAGED_OPS:
        k = staged_kernel(mods[op], STAGED_ROW_BLOCKS)
        times[op] = kernel_device_us(f"staged dot {op}", k, (x, w), dev)
        held(f"staged dot {op}", k, (x, w))
    elems = STAGED_CHAIN * x.numel()
    out["ops"] = {op: {"device_us": times[op], "plain_device_us": times["plain"],
                       "rate": elems / ((times[op] - times["plain"]) * 1e-6)
                       if times[op] > times["plain"] else None} for op in STAGED_OPS}
    l2 = [(r["whole_rhs_bytes"], round(r["l2_bw"] / 1e12, 4), round(r["device_us"], 2))
          for r in out["l2"]]
    print(f"H100 staged dots: (whole rhs bytes, l2_bw TB/s, device us) {l2}; composed op "
          f"rates {[(op, r['rate']) for op, r in out['ops'].items()]} (plain {times['plain']:.2f} us)")
    return out


def overhead_sources():
    """The sources of (c)'s kernels, built in phase 2 with the rest."""
    from repro_torch.core.codegen import assemble_source

    kernels = [forced_kernel(curve_module(), b) for b in CURVE_BLOCKS]
    kernels += vmem_kernels()[0] + phase_kernels()
    mods = dict(staged_modules())
    kernels += [staged_kernel(mods[f"l2 {bs}"], rows, L2_REPLICATE_LIMIT) for bs, rows in L2_CASES]
    kernels += [staged_kernel(mods[op], STAGED_ROW_BLOCKS) for op in ("plain",) + STAGED_OPS]
    return ([overhead_module(rows, blocks, "cpu").cuda_source for rows, blocks in OVERHEAD_CASES]
            + [assemble_source([k.fn]) for k in kernels])


def kernel_device_us(label, kernel, args, dev):
    """Device µs of one launch of a generated kernel (built and loaded)."""
    from repro_torch.core import cuda_build
    from repro_torch.core.codegen import assemble_source

    lib, _ = cuda_build.load(assemble_source([kernel.fn]))
    kernel.fn.load(lib)
    _, by_name = profiled_launches(label, lambda p=kernel.fn, a=args: p.launch(*a, device=dev),
                                   {kernel.fn.name: 1}, total=1)
    return sum(t for k, t in by_name.items() if kernel.fn.name in k)


def launch_overheads(dev):
    """The H100 spec's measured constants from the port's own generated
    kernels: the launch and grid-step overheads (exp over (8, 256) f32 in
    one plan block, and over (8448, 256) f32 in 1 and in OVERHEAD_BLOCKS
    plan blocks, the same bytes: the difference over the added blocks);
    ``sm_count``; the block-count curve (the fraction of ``hbm_bw`` the
    CURVE kernel reaches at each of CURVE_BLOCKS plan blocks, each on a
    CUDA block of its own); ``vmem_bw`` (the bytes a step of
    ``vmem_kernels`` moves through shared memory over the least-squares
    slope of their device time over their steps); and
    ``phase_loop_overhead_s`` (the least-squares slope of the stitched
    chain's device time over its phase count: one grid barrier and one
    staged interface of PHASE_SHAPE f32).  Each kernel is held against its
    plain version at ``TOL``."""
    import numpy as np
    import torch

    from repro_torch.core.latency import H100

    out = {}
    for rows, blocks in OVERHEAD_CASES:
        (kernel,) = overhead_module(rows, blocks, dev).kernels
        x = torch.rand(rows, 256, device=dev)
        _, by_name = profiled_launches(f"overhead exp ({rows}, 256) in {kernel.blocks} blocks",
                                       lambda p=kernel.fn, x=x: p.launch(x, device=dev),
                                       {kernel.fn.name: 1}, total=1)
        out[f"{rows}x256_{kernel.blocks}_blocks_device_us"] = sum(
            t for k, t in by_name.items() if kernel.fn.name in k)
    one = out[f"{OVERHEAD_ROWS[0]}x256_1_blocks_device_us"]
    few = out[f"{OVERHEAD_ROWS[1]}x256_1_blocks_device_us"]
    many = [v for k, v in out.items() if k.startswith(f"{OVERHEAD_ROWS[1]}x") and v != few]
    out["launch_overhead_us"] = one
    out["grid_step_overhead_us"] = ((many[0] - few) / (OVERHEAD_BLOCKS - 1)) if many else None
    out["sm_count"] = torch.cuda.get_device_properties(dev).multi_processor_count

    def held(label, kernel, args):
        got = kernel.fn.launch(*args, device=dev)
        want = kernel.fn.plain(*args, device=dev)
        for g, w in zip(got, want, strict=True):
            e, ok = max_err(g, w, None)
            if not ok:
                raise SystemExit(f"{label}: kernel vs plain {e:.3e} (TOL {TOL})")

    x = torch.rand(CURVE_ROWS, CURVE_WIDTH, device=dev) + 0.5
    nbytes = 2 * x.numel() * 4
    curve = []
    for b in CURVE_BLOCKS:
        kernel = forced_kernel(curve_module(), b)
        us = kernel_device_us(f"curve {b} plan blocks", kernel, (x,), dev)
        held(f"curve {b} plan blocks", kernel, (x,))
        grid = int(geometry(kernel.fn.source)["grid"])
        if grid != b:
            raise SystemExit(f"curve: {b} plan blocks launched {grid} CUDA blocks")
        curve.append({"blocks": b, "device_us": us, "fraction_of_hbm_bw":
                      nbytes / (us * 1e-6) / H100.hbm_bw})
    out["block_curve"] = curve

    kernels, step_bytes = vmem_kernels()
    xv = torch.rand(CURVE_ROWS, VMEM_WIDTH, device=dev)
    tv = []
    for n, kernel in zip(VMEM_STEPS, kernels, strict=True):
        tv.append(kernel_device_us(f"vmem chain of {n} slots", kernel, (xv,), dev))
        held(f"vmem chain of {n} slots", kernel, (xv,))
    vslope = float(np.polyfit(np.asarray(VMEM_STEPS, float), np.asarray(tv), 1)[0])
    out["vmem"] = {"steps": list(VMEM_STEPS), "device_us": tv, "bytes_a_step": step_bytes,
                   "us_a_step": vslope,
                   "vmem_bw": step_bytes / (vslope * 1e-6) if vslope > 0 else None}

    xs = torch.rand(*PHASE_SHAPE, device=dev)
    ts = []
    for n, kernel in zip(PHASE_COUNTS, phase_kernels(), strict=True):
        if kernel.num_phases != n:
            raise SystemExit(f"phases: {kernel.num_phases} phases, built for {n}")
        ts.append(kernel_device_us(f"stitched chain in {n} phases", kernel, (xs,), dev))
        held(f"stitched chain in {n} phases", kernel, (xs,))
    slope = float(np.polyfit(np.asarray(PHASE_COUNTS, float), np.asarray(ts), 1)[0])
    out["phases"] = {"counts": list(PHASE_COUNTS), "device_us": ts,
                     "phase_loop_overhead_us": slope}
    out["staged"] = staged_constants(dev, held)
    print(f"H100 constants: sm_count {out['sm_count']}; block curve "
          f"{[(c['blocks'], round(c['device_us'], 2), round(c['fraction_of_hbm_bw'], 4)) for c in curve]}; "
          f"vmem {out['vmem']}; phases {ts} -> {slope:.4f} us a phase")
    return out


def roofline_rows(models_row, train_row):
    """(c): ``costmodel.fn_cost`` of phase 15's granite train step and of
    phase 13's forward on meta tensors, ``roofline.analyze``'s H100 terms
    for them, beside the device ms those phases measured in this run."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import costmodel, roofline
    from repro_torch.train import AdamWConfig, adamw_init_specs, make_train_step

    cfg = get_config(MODEL_ARCH)
    pspecs = models.param_specs(cfg)
    out = {}
    for label, (B, S), kind, device_ms in (
            ("train_step", TRAIN_SHAPE, "train", train_row["granite"]["replayed_device_ms"]),
            ("forward", FORWARD_SHAPE, "prefill", models_row["forward_device_ms"])):
        tokens = costmodel.to_meta({"tokens": torch_empty((B, S)), "labels": torch_empty((B, S))})
        t0 = time.perf_counter()
        if kind == "train":
            step = make_train_step(cfg, AdamWConfig(**TRAIN_GRANITE_OPT))
            cost = costmodel.fn_cost(step, pspecs, adamw_init_specs(pspecs), tokens)
        else:
            cost = costmodel.fn_cost(lambda p, b: models.forward(p, b, cfg), pspecs,
                                     {"tokens": tokens["tokens"]})
        count_s = time.perf_counter() - t0
        rec = {"arch": MODEL_ARCH, "shape": f"{kind} {B}x{S}", "num_devices": 1,
               "shape_spec": dict(seq_len=S, global_batch=B, kind=kind),
               "flops": cost["flops"], "dot_flops": cost["dot_flops"],
               "bytes_accessed": cost["bytes"], "bytes_min": cost["bytes_min"],
               "collective_bytes": {}}
        row = roofline.analyze(rec)
        bound_ms = 1e3 * max(row["t_compute_s"], row["t_memory_s"], row["t_collective_s"])
        out[label] = {k: row[k] for k in ("flops", "dot_flops", "bytes_accessed", "bytes_min",
                                          "t_compute_s", "t_memory_s", "t_collective_s",
                                          "dominant", "model_flops", "useful_ratio",
                                          "roofline_fraction")}
        out[label].update(count_s=count_s, device_ms=device_ms, bound_ms=bound_ms,
                          fraction_of_bound=bound_ms / device_ms,
                          model_flops_ms=1e3 * row["model_flops"] / roofline.PEAK_FLOPS,
                          model_flops_fraction=1e3 * row["model_flops"] / roofline.PEAK_FLOPS
                          / device_ms)
        print(f"launch roofline {MODEL_ARCH} {label} {B}x{S}: counted in {count_s:.1f} s, "
              f"{row['flops']:.4e} flops ({row['dot_flops']:.4e} in products), bytes "
              f"{row['bytes_min']:.4e}..{row['bytes_accessed']:.4e}; H100 terms compute "
              f"{row['t_compute_s'] * 1e3:.3f} ms, memory {row['t_memory_s'] * 1e3:.3f} ms "
              f"({row['dominant']}); model flops {row['model_flops']:.4e}; device "
              f"{device_ms:.2f} ms = {bound_ms / device_ms:.4f} of the bound, "
              f"{out[label]['model_flops_fraction']:.4f} of model flops at peak")
    return out


def torch_empty(shape):
    import torch

    return torch.empty(shape, dtype=torch.int32, device="meta")


def sharded_train_phase(dev, smi, models_row, train_row):
    """Phase 17: the sharded train step and the launch tools on the card
    (module docstring).  Returns the sharded_train and launch lines'
    objects and each kernel's launches in (a)'s counted steps."""
    import torch

    gc_collect()
    t0 = time.perf_counter()
    seconds = {}
    import torch.multiprocessing as mp

    outdir = world_dir("sharded_train.")
    try:
        # the dry run (CPU, meta tensors) beside the oracle (the card), both
        # before the world, whose host-staged collectives it would slow
        dry = mp.spawn(sp_dryrun, args=(outdir,), nprocs=1, join=False)
        try:
            spawn_ranks(sp_oracle, (outdir, dev.type), 1, "sharded_train: the unsharded oracle")
            seconds["oracle"] = time.perf_counter() - t0
        finally:
            join_ranks(dry, "sharded_train: the dry run")
        seconds["oracle_and_dryrun"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        spawn_ranks(sp_rank, (SHARD_WORLD, outdir, dev.type), SHARD_WORLD,
                    f"sharded_train: the gloo world of {SHARD_WORLD}")
        seconds["world"] = time.perf_counter() - t1
        with open(os.path.join(outdir, "oracle.json")) as fh:
            oracle = json.load(fh)
        with open(os.path.join(outdir, "dryrun.json")) as fh:
            drec = json.load(fh)
        ranks = []
        for r in range(SHARD_WORLD):
            with open(os.path.join(outdir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        replicated = [torch.load(os.path.join(outdir, f"replicated{r}.pt"))
                      for r in range(SHARD_WORLD)]
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    for res in ranks:
        timed = res["steps"][1:]
        res["ms_per_step"] = sum(s["ms"] for s in timed) / len(timed)
        res["collective_ms_per_step"] = sum(s["collective_ms"] for s in timed) / len(timed)
        print(f"sharded_train rank {res['rank']} {SP_ARCH} bf16 sp {SP_SHAPE[0]}x{SP_SHAPE[1]}: "
              f"{res['ms_per_step']:.1f} ms a step ({res['collective_ms_per_step']:.1f} in "
              f"collectives, {res['steps'][-1]['collective_calls']} calls, bytes "
              f"{res['steps'][-1]['bytes_by_kind']}), losses "
              f"{[round(s['loss'], 5) for s in res['steps']]}, peak "
              f"{res['peak_allocated_bytes']} bytes, at rest {res['at_rest_bytes']} of "
              f"{res['unsharded_state_bytes']} unsharded, launch.train "
              f"{res['launch_s']:.1f} s ({smi})")
    r0 = ranks[0]
    oms = sum(s["ms"] for s in oracle["steps"][1:]) / (SP_STEPS - 1)
    print(f"sharded_train: unsharded oracle {oms:.1f} ms a step, losses "
          f"{[s['loss'] for s in oracle['steps']]}, grad norms "
          f"{[s['grad_norm'] for s in oracle['steps']]} (rank 0: "
          f"{[s['grad_norm'] for s in r0['steps']]}), peak {oracle['peak_allocated_bytes']} bytes; "
          f"params max |err| {r0['param_max_abs_err']:.3e} (bound {r0['param_bound']:.3e} + a "
          f"bf16 ulp; {r0['params_over_2lr']} elements past 2 lr), update rel err "
          f"{r0['update_rel_err']:.3e}")

    # ---- right ---------------------------------------------------------------------
    loss_err = {"loss": 0.0, "grad_norm": 0.0}
    for res in ranks:
        for key in loss_err:
            want = [s[key] for s in oracle["steps"]]
            got = [s[key] for s in res["steps"]]
            for g, w in zip(got, want, strict=True):
                loss_err[key] = max(loss_err[key], abs(g - w) / abs(w))
            if loss_err[key] > SP_LOSS_RTOL:
                raise SystemExit(f"sharded_train rank {res['rank']}: {key} {got} vs unsharded "
                                 f"{want}, past rtol {SP_LOSS_RTOL}")
        if res["blocks_equal"] != res["leaves"]:
            raise SystemExit(f"sharded_train rank {res['rank']}: {res['blocks_equal']} of "
                             f"{res['leaves']} blocks equal the rules' cut")
        if res["launch_rc"] != 0:
            raise SystemExit(f"sharded_train rank {res['rank']}: launch.train --mesh 2,2 "
                             f"exited {res['launch_rc']}")
    for r, rep in enumerate(replicated[1:], 1):
        for path, t in rep.items():
            if not same(t, replicated[0][path]):
                raise SystemExit(f"sharded_train: replicated {path} differs on rank {r}")
    if r0["params_over_bound"]:
        raise SystemExit(f"sharded_train: {r0['params_over_bound']} params past "
                         f"{r0['param_bound']} + a bf16 ulp of the unsharded step's (max |err| "
                         f"{r0['param_max_abs_err']})")
    # (d) the dry run against the ranks: rank 0's argument bytes exactly, the
    # census kind for kind against a step's bytes
    if drec["memory"]["argument_size_in_bytes"] != r0["argument_bytes"]:
        raise SystemExit(f"sharded_train dry run: argument bytes "
                         f"{drec['memory']['argument_size_in_bytes']} vs rank 0's measured "
                         f"{r0['argument_bytes']}")
    measured = {k: float(v) for k, v in r0["steps"][-1]["bytes_by_kind"].items()}
    if drec["collective_bytes"] != measured:
        raise SystemExit(f"sharded_train dry run: census {drec['collective_bytes']} vs a "
                         f"step's bytes {measured}")
    seconds["checked"] = time.perf_counter() - t0

    # ---- numbers -------------------------------------------------------------------
    t1 = time.perf_counter()
    overheads = launch_overheads(dev)
    roof = roofline_rows(models_row, train_row)
    seconds["roofline"] = time.perf_counter() - t1
    launches = {}
    for res in ranks:
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"sharded_train: max rel err against the unsharded step: {loss_err}")
    print(f"sharded_train dry run (2x2 fake world, meta): argument "
          f"{drec['memory']['argument_size_in_bytes']} bytes (rank 0 measured "
          f"{r0['argument_bytes']}); temp estimate {drec['memory']['temp_size_in_bytes']} bytes "
          f"against max allocated {[r['peak_allocated_bytes'] for r in ranks]}; census "
          f"{drec['collective_bytes']} against a step's {measured}; counted in "
          f"{drec['compile_s']} s")
    print(f"launch overheads: {overheads}")
    seconds["phase"] = time.perf_counter() - t0
    print(f"sharded_train: launches {launches}; seconds "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    sharded_row = {
        "card": smi, "arch": SP_ARCH, "mesh": list(SP_MESH), "world": SHARD_WORLD,
        "backend": "gloo", "shape": list(SP_SHAPE), "steps": SP_STEPS, "opt": SP_OPT,
        "param_count": oracle["param_count"], "oracle": oracle, "ranks": ranks,
        "max_rel_err": loss_err, "param_max_abs_err": r0["param_max_abs_err"],
        "params_over_2lr": r0["params_over_2lr"], "update_rel_err": r0["update_rel_err"],
        "oracle_ms_per_step": oms,
        "tolerances": {"loss_and_grad_norm_rtol": SP_LOSS_RTOL,
                       "params": "2 sum(lr_t) + one bf16 ulp"},
        "seconds": seconds,
    }
    launch_row = {"card": smi, "dryrun_2x2": drec, "roofline": roof, "overheads": overheads}
    return sharded_row, launch_row, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number as JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from repro_torch.core import StitchOptions, compile_module, cuda_build, reference_execute
    from repro_torch.core.codegen import REPLACES
    from repro_torch.core.latency import H100
    from repro_torch.graphs import ALL_GRAPHS, LOOP_GRAPHS, random_feeds
    from repro_torch.kernels.cuda import SOURCES as HAND_SOURCES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    faulthandler.dump_traceback_later(DUMP_AFTER_S, exit=False)

    # ---- 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")

    # ---- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    # the ten graphs under the reference's spec (the CPU's default) and
    # under the card's (phase 3 runs both)
    sources = [compile_module(g(), device="cpu").cuda_source for g in ALL_GRAPHS.values()]
    sources += [compile_module(g(), StitchOptions(device_spec=H100), device="cpu").cuda_source
                for g in ALL_GRAPHS.values()]
    extra = [stitched_compile(name, opts, "cpu").cuda_source for _, name, opts, _ in STITCHED_COMPILES]
    extra += [dtype_compile(name, dt, opts, "cpu")[1].cuda_source
              for _, name, dt, opts, _, _ in DTYPE_COMPILES]
    extra += [dtype_compile(name, "float32", opts, "cpu")[1].cuda_source for _, name, opts in FUSION_COMPILES]
    # phases 8-11: the loops' bodies, the greedy plans, the lint's compiles
    # in both planners, the fault modules
    for name in LOOPS:
        extra += sources_of(compile_module(LOOP_GRAPHS[name](), device="cpu"))
    for g in ALL_GRAPHS.values():
        extra += sources_of(compile_module(g(), StitchOptions(planner="greedy"), device="cpu"))
        for planner in ("cost", "greedy"):
            # repro_torch.lint compiles for the card: the H100's plans
            lint_opts = StitchOptions(max_blocks=LINT_MAX_BLOCKS, planner=planner,
                                      device_spec=H100)
            extra += sources_of(compile_module(g(), lint_opts, device="cpu"))
    extra += [compile_module(build(), device="cpu").cuda_source for build in FAULT_MODULES.values()]
    # phase 12: the frontend's functions and the families' hand-built graphs
    cases = frontend_cases()
    extra += frontend_sources(cases)
    # phase 15: the stitched train step's plan; phase 17: the overhead kernels
    extra += train_sources()
    extra += overhead_sources()
    # phase 4: the staged dots against the register-tile loop, the 64-bit case
    extra += staged_sources()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    logs = cuda_build.build_all(sources + extra + [src.path.read_text() for src in HAND_SOURCES])
    build_s = time.perf_counter() - t0
    print(f"build: planned 10 graphs under TPU_V5E and H100 and {len(extra)} more compiles in "
          f"{plan_s:.2f} s; "
          f"nvcc built {len(logs)} libraries (the compiles' and {len(HAND_SOURCES)} "
          f"hand-written) in parallel in {build_s:.2f} s")
    ptxas = [line.split("ptxas info    :")[-1].strip()
             for log in logs.values() for line in log.splitlines()
             if "Compiling entry" in line or "Used" in line or "spill" in line]
    for line in ptxas:
        print("  ptxas:", line)
    regs = ptxas_by_kernel(logs)
    graphs, h100_graphs = {}, {}
    for name, build in ALL_GRAPHS.items():
        module = build()
        # the eager step loop: phase 3 counts each launch through its wrapper,
        # under the reference's spec (the reference's plans: 35 kernels) and
        # under the default, the card's
        compiled = compile_module(module, ref_options(jit_replay=False), device=dev)
        feeds = random_feeds(module, np.random.RandomState(0))
        dfeeds = {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}
        graphs[name] = (module, compiled, feeds, dfeeds)
        h100 = compile_module(module, StitchOptions(jit_replay=False), device=dev)
        h100_graphs[name] = (module, h100, feeds, dfeeds)
    by_spec = {"TPU_V5E": graphs, "H100": h100_graphs}

    # ---- 3. the main path, with launch counters ---------------------------------
    programs = {}          # id -> (graph, program, kernel, spec)
    for spec, gs in by_spec.items():
        for name, (_, compiled, _, _) in gs.items():
            for k in compiled.kernels:
                programs[id(k.fn)] = (name, k.fn, k, spec)
    for _, prog, _, _ in programs.values():
        prog.launches = 0
    outputs = {name: compiled(dfeeds) for name, (_, compiled, _, dfeeds) in graphs.items()}
    h100_outputs = {name: compiled(dfeeds) for name, (_, compiled, _, dfeeds) in h100_graphs.items()}
    torch.cuda.synchronize()
    launches = {pid: prog.launches for pid, (_, prog, _, _) in programs.items()}
    planned_by_spec = {}
    for spec, gs in by_spec.items():
        planned_by_spec[spec] = 0
        for name, (_, compiled, _, _) in gs.items():
            got = sum(launches[id(k.fn)] for k in compiled.kernels)
            want = compiled.stats.stitched_kernels
            planned_by_spec[spec] += want
            if got != want:
                raise SystemExit(f"{name} [{spec}]: {got} kernel launches, planned {want}")
    if planned_by_spec["TPU_V5E"] != REFERENCE_KERNELS:
        raise SystemExit(f"the TPU_V5E plans launch {planned_by_spec['TPU_V5E']} kernels, the "
                         f"reference's {REFERENCE_KERNELS}")
    never = [prog.name for pid, (_, prog, _, _) in programs.items() if launches[pid] == 0]
    if never:
        raise SystemExit(f"kernels the main path never launched: {never}")
    print(f"main path: {sum(launches.values())} launches of {len(programs)} unique kernels "
          f"= {planned_by_spec} planned fused kernels by spec")

    # ---- 4. right ---------------------------------------------------------------
    # an H100 plan keeps every ALLOC/SHARE slot in shared memory
    for name, (_, compiled, _, _) in h100_graphs.items():
        kept = [k for k in launch_shapes(compiled.kernels) if k["slot_bytes_in_workspace"]
                or (k["emitter"] == "emit_fusion" and k["workspace_bytes"])]
        if kept:
            raise SystemExit(f"{name} [H100]: slots in the workspace: {kept}")
    for spec, outs in (("TPU_V5E", outputs), ("H100", h100_outputs)):
        for name, (module, compiled, feeds, dfeeds) in graphs.items():
            want = reference_execute(module, dfeeds, device=dev)
            for root, w in want.items():
                g = outs[name][root]
                if g.device.type != "cuda" or tuple(g.shape) != tuple(w.shape):
                    raise SystemExit(f"{name}:{root} [{spec}]: {g.device} {tuple(g.shape)} vs "
                                     f"{tuple(w.shape)}")
                if not bool(torch.isfinite(g).all()):
                    raise SystemExit(f"{name}:{root} [{spec}]: non-finite output")
                err, ok = max_err(g, w, degenerate_mask(name, root, feeds, tuple(g.shape)))
                if not ok:
                    raise SystemExit(f"{name}:{root} [{spec}]: max |compiled - reference| "
                                     f"{err:.3e} over tolerance")
    captured = {}
    for pid, (_, prog, _, _) in programs.items():
        def record(*a, device, _pid=pid, _launch=prog.launch):
            captured.setdefault(_pid, [t.clone() for t in a])
            return _launch(*a, device=device)
        prog.launch = record
    for gs in by_spec.values():
        for name, (_, compiled, _, dfeeds) in gs.items():
            compiled(dfeeds)
    for _, prog, _, _ in programs.values():
        del prog.launch
    rows, timed = [], []
    for pid, (gname, prog, kernel, spec) in programs.items():
        a = captured[pid]
        got = prog.launch(*a, device=dev)
        want = prog.plain(*a, device=dev)
        torch.cuda.synchronize()
        err, ok = 0.0, True
        feeds = graphs[gname][2]
        for r, g, w in zip(kernel.outputs, got, want, strict=True):
            mask = degenerate_mask(gname, r.name, feeds, tuple(g.shape)) if not r.users else None
            e, o = max_err(g, w, mask)
            err, ok = max(err, e), ok and o
        if not ok:
            raise SystemExit(f"{gname}:{kernel.fusion.name} {prog.name}: kernel vs plain {err:.3e}")
        nbytes, ops = work(kernel)
        rows.append({
            "graph": gname, "spec": spec, "fusion": kernel.fusion.name, "kernel": prog.name,
            "emitter": prog.emitter, "blocks": kernel.blocks, "phases": kernel.num_phases,
            "members": len(kernel.fusion.members), "launches": launches[pid], "max_abs_err": err, "bytes": nbytes, "ops": ops,
        })
        timed.append((prog, a))
    print(f"right: 10 graphs under TPU_V5E and H100 vs reference_execute and {len(rows)} "
          f"kernels vs their plain versions on the card, within rtol=atol={TOL} "
          f"({DEGENERATE_TOL} on Speech's degenerate columns); no H100 plan keeps a slot in "
          "the workspace")
    stitched_rows = []
    rng = np.random.RandomState(1)
    for label, name, opts, blocks in STITCHED_COMPILES:
        compiled = stitched_compile(name, opts, dev)
        (kernel,) = [k for k in compiled.kernels if k.fn.emitter == "emit_stitched_fusion"]
        if [p.solution.blocks for p in kernel.stitched.phases] != blocks:
            raise SystemExit(f"{label}: phases of {[p.solution.blocks for p in kernel.stitched.phases]} "
                             f"plan blocks, expected {blocks}")
        a = [torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32), device=dev)
             for shape, _ in kernel.fn.in_specs]
        kernel.fn.launches = 0
        got = kernel.fn(*a)
        torch.cuda.synchronize()
        if kernel.fn.launches != 1:
            raise SystemExit(f"{label}: {kernel.fn.launches} launches, expected 1")
        want = kernel.fn.plain(*a, device=dev)
        err, ok = 0.0, True
        for g, w in zip(got, want, strict=True):
            e, o = max_err(g, w, None)
            err, ok = max(err, e), ok and o and bool(torch.isfinite(g).all())
        if not ok:
            raise SystemExit(f"{label} {kernel.fn.name}: kernel vs plain {err:.3e}")
        _, by_name = profiled_launches(f"stitched compile {label}",
                                       lambda p=kernel.fn, a=a: p.launch(*a, device=dev),
                                       {kernel.fn.name: 1}, total=1)
        device_us = sum(t for k, t in by_name.items() if kernel.fn.name in k)
        stitched_rows.append({"compile": label, "kernel": kernel.fn.name, "phase_blocks": blocks,
                              "workspace_bytes": kernel.fn.workspace_bytes, "max_abs_err": err,
                              "device_us": device_us})
        print(f"stitched compile {label}: {kernel.fn.name} phases of {blocks} plan blocks, one "
              f"launch, err={err:.2e} device_us={device_us or 'not measured'}")

    extra_rows = []
    for label, name, dt, opts, emitter, tol in (
            DTYPE_COMPILES + [(lb, nm, "float32", op, "emit_fusion", (TOL, TOL)) for lb, nm, op in FUSION_COMPILES]):
        module, compiled = dtype_compile(name, dt, opts, dev)
        if {k.fn.emitter for k in compiled.kernels} != {emitter}:
            raise SystemExit(f"{label}: emitters {sorted({k.fn.emitter for k in compiled.kernels})}, "
                             f"expected {emitter}")
        feeds = {}
        for p in module.parameters:
            if dt in ("int8", "int16"):
                feeds[p.name] = torch.as_tensor(rng.randint(-60, 120, p.shape).astype(dt), device=dev)
            else:
                f = torch.as_tensor(rng.uniform(-2, 2, p.shape).astype(np.float32), device=dev)
                feeds[p.name] = f.to(torch.bfloat16) if dt == "bfloat16" else f
        inputs = {}
        for k in compiled.kernels:
            k.fn.launches = 0

            def record(*a, device, _fn=k.fn, _launch=k.fn.launch):
                inputs.setdefault(id(_fn), [t.clone() for t in a])
                return _launch(*a, device=device)
            k.fn.launch = record
        got = compiled(feeds)
        torch.cuda.synchronize()
        for k in compiled.kernels:
            del k.fn.launch
        n = sum(k.fn.launches for k in compiled.kernels)
        if n != compiled.stats.stitched_kernels:
            raise SystemExit(f"{label}: {n} launches, planned {compiled.stats.stitched_kernels}")
        want = reference_execute(module, feeds, device=dev)
        err, ok = 0.0, True
        for root, w in want.items():
            e, o = compare(got[root], w, tol)
            err, ok = max(err, e), ok and o
        # and each kernel against its plain version, on the inputs the run gave it
        for k in compiled.kernels:
            a = inputs[id(k.fn)]
            for g, w in zip(k.fn.launch(*a, device=dev), k.fn.plain(*a, device=dev), strict=True):
                e, o = compare(g, w, tol)
                err, ok = max(err, e), ok and o
        torch.cuda.synchronize()
        if not ok:
            raise SystemExit(f"{label}: kernels vs plain and reference_execute {err:.3e} over {tol}")
        names = [k.fn.name for k in compiled.kernels]
        _, by_name = profiled_launches(f"{emitter} compile {label}", lambda c=compiled, f=feeds: c(f),
                                       planned_by_program(compiled))
        device_us = sum(t for k, t in by_name.items() if any(nm in k for nm in names))
        extra_rows.append({"compile": label, "emitter": emitter, "kernels": names, "launches": n,
                           "max_abs_err": err, "tolerance": tol, "device_us": device_us,
                           "workspace_bytes": [k.fn.workspace_bytes for k in compiled.kernels]})
        print(f"{emitter} compile {label}: {n} launches, vs plain and reference_execute "
              f"err={err:.2e} (rtol, atol)={tol} device_us={device_us or 'not measured'}")

    index64_rows = [index64_check(dev, shape) for shape in INDEX64_SHAPES]
    staged_rows = staged_dots_check(dev)

    # ---- 5. numbers -------------------------------------------------------------
    for row, (prog, a) in zip(rows, timed, strict=True):
        row["us"] = 1e3 * time_ms(lambda p=prog, a=a: p.launch(*a, device=dev), CALLS)
        _, by_name = profiled_launches(f"kernel {row['graph']}:{row['fusion']} [{row['spec']}]",
                                       lambda p=prog, a=a: p.launch(*a, device=dev),
                                       {prog.name: 1}, total=1)
        row["device_us"] = sum(t for k, t in by_name.items() if prog.name in k)
        row["plain_us"] = 1e3 * time_ms(lambda p=prog, a=a: p.plain(*a, device=dev), PLAIN_CALLS)
        b_us = 1e6 * row["bytes"] / HBM_BYTES_PER_S
        o_us = 1e6 * row["ops"] / F32_OPS_PER_S
        row["bound_us"] = max(b_us, o_us)
        row["bound_by"] = "bytes" if b_us >= o_us else "operations"
        if any(m.opcode == "dot" for m in kernel.fusion.members):
            row["dot_kernel"] = dot_lines(f"{row['graph']}:{row['fusion']} [{row['spec']}]",
                                          [kernel], by_name)[0]
        if row["emitter"] == "emit_fusion":
            row.update(geometry(prog.source), **regs.get(prog.name, {}))
            print(f"  {row['graph']}:{row['fusion']} [{row['spec']}] {prog.name}: "
                  f"{row['members']} members, "
                  f"{row['blocks']} plan blocks, grid {row['grid']} x {row['threads']} threads, "
                  f"{row['smem_bytes']} bytes of shared memory, "
                  f"registers {row.get('registers', 'not built here')}, spill stores "
                  f"{row.get('spill_stores', '-')} loads {row.get('spill_loads', '-')}")
        print(
            f"kernel {row['graph']}:{row['fusion']} [{row['spec']}] {row['emitter']} {row['kernel']} "
            f"blocks={row['blocks']} launches/call={row['launches']} "
            f"us={row['us']:.2f} device_us={row['device_us'] or 'not measured'} "
            f"plain_us={row['plain_us']:.2f} "
            f"bound_us={row['bound_us']:.4f} ({row['bound_by']}) err={row['max_abs_err']:.2e}"
        )
    per_graph, unfused = [], {}
    for spec, name in [(sp, n) for sp in by_spec for n in ALL_GRAPHS]:
        module, compiled, _, dfeeds = by_spec[spec][name]
        st = compiled.stats
        us = 1e3 * time_ms(lambda c=compiled, f=dfeeds: c(f), CALLS)
        planned = st.stitched_kernels + st.standalone_kernels + st.library_calls
        seen, by_name = profiled_launches(f"graph {name} [{spec}]",
                                          lambda c=compiled, f=dfeeds: c(f),
                                          planned_by_program(compiled))
        device_us = sum(by_name.values())
        idle = 1.0 - device_us / us if device_us else None
        if name not in unfused:
            # the unfused path's device time: every device kernel its torch ops
            # run (one module, the same under both specs)
            ref_us = 1e3 * time_ms(lambda m=module, f=dfeeds: reference_execute(m, f, device=dev),
                                   CALLS)
            ref_seen, ref_by_name = device_profile(
                lambda m=module, f=dfeeds: reference_execute(m, f, device=dev), PROFILED_CALLS,
                f"unfused {name}")
            unfused[name] = (ref_us, ref_seen, sum(ref_by_name.values()) or None)
        ref_us, ref_seen, ref_device_us = unfused[name]
        per_graph.append({
            "graph": name, "spec": spec, "us_per_call": us, "reference_us_per_call": ref_us,
            "fused_kernels": st.stitched_kernels, "standalone": st.standalone_kernels,
            "library_dots": st.library_calls, "unique_kernels": st.unique_kernels,
            "xla_baseline_kernels": st.xla_baseline_kernels, "planned_launches": planned,
            "profiler_device_kernels": seen, "device_us_per_call": device_us,
            "device_idle_share": idle, "reference_device_kernels": ref_seen,
            "reference_device_us_per_call": ref_device_us,
        })
        print(
            f"graph {name} [{spec}]: us_per_call={us:.1f} reference_us_per_call={ref_us:.1f} "
            f"fused={st.stitched_kernels} standalone={st.standalone_kernels} "
            f"library={st.library_calls} planned_launches={planned} "
            f"profiler_device_kernels={seen if seen else 'none seen'} "
            f"device_us_per_call={device_us or 'not measured'} "
            f"idle_share={idle if idle is not None else 'not measured'} "
            f"reference_device_kernels={ref_seen if ref_seen else 'none seen'} "
            f"reference_device_us_per_call={ref_device_us or 'not measured'}"
        )
    passes = {spec: sum(g["device_us_per_call"] for g in per_graph if g["spec"] == spec)
              for spec in by_spec}
    print(f"the ten graphs' pass, device us per call: {passes}")
    for g in per_graph:
        if g["spec"] == "H100":
            t = next(x for x in per_graph if x["spec"] == "TPU_V5E" and x["graph"] == g["graph"])
            g["over_tpu_v5e"] = g["device_us_per_call"] / t["device_us_per_call"]
            if g["over_tpu_v5e"] > 1.05:
                print(f"graph {g['graph']}: the H100 plan takes {g['over_tpu_v5e']:.3f}x the "
                      "TPU_V5E plan's device time")

    entries = []
    for emitter in ("emit_fusion", "emit_stitched_fusion"):
        mine = [r for r in rows if r["emitter"] == emitter]
        total_bytes = sum(r["bytes"] * r["launches"] for r in mine)
        total_ops = sum(r["ops"] * r["launches"] for r in mine)
        b_ms, o_ms = 1e3 * total_bytes / HBM_BYTES_PER_S, 1e3 * total_ops / F32_OPS_PER_S
        entries.append({
            "name": emitter, "route": "cuda", "source": "src/repro_torch/core/codegen.py",
            "replaces": REPLACES[emitter],
            "launches": sum(r["launches"] for r in mine),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            # this emitter's launches in one pass of the main path, each at
            # its CUDA-event time per back-to-back launch of the wrapper
            "ms": sum(r["us"] * r["launches"] for r in mine) / 1e3,
            "plain_ms": sum(r["plain_us"] * r["launches"] for r in mine) / 1e3,
            # the same launches' device time alone, as torch.profiler traced it
            "device_ms": (
                sum(r["device_us"] * r["launches"] for r in mine) / 1e3
                if all(r["device_us"] for r in mine) else None
            ),
            "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": None,
            "unique_kernels": len(mine), "tolerance": TOL,
            # one pass of the ten graphs under each spec: launches, event ms
            # and device ms of this emitter's kernels
            "by_spec": {spec: {
                "launches": sum(r["launches"] for r in mine if r["spec"] == spec),
                "ms": sum(r["us"] * r["launches"] for r in mine if r["spec"] == spec) / 1e3,
                "device_ms": sum(r["device_us"] * r["launches"] for r in mine
                                 if r["spec"] == spec) / 1e3,
            } for spec in by_spec},
        })
        if emitter == "emit_stitched_fusion":
            # the same graphs unfused (reference_execute), device time per pass
            ref_us = [g["reference_device_us_per_call"] for g in per_graph
                      if g["spec"] == "TPU_V5E" and g["graph"] in {r["graph"] for r in mine}]
            entries[-1]["unfused_device_ms"] = sum(ref_us) / 1e3 if all(ref_us) else None

    # ---- 6. kernels ---------------------------------------------------------------
    hand_entries, hand_calls = kernels_phase(dev)
    entries += hand_entries

    # ---- 7-11. replay, loops, verify, autotune, f16 and the fault modules ---------
    replay_rows = replay_phase(dev, graphs, outputs)
    loop_rows = loops_phase(dev)
    verify_phase()
    autotune_rows = autotune_phase(dev, graphs)
    f16 = f16_phase(dev)
    for entry in hand_entries:
        entry.update(f16[entry["name"]])
    fault_rows = faults_phase(dev)

    # ---- 12. the frontend ---------------------------------------------------------
    frontend_rows, frontend_launches = frontend_phase(dev, cases)
    model_rows = model_width_numbers(dev, frontend_rows)
    for entry in entries:
        # the hand-written kernels are not on the frontend's path: 0
        entry["frontend_launches"] = frontend_launches.get(entry["name"], 0)

    # ---- 13. the models -------------------------------------------------------------
    models_row, models_launches = models_phase(dev, smi)
    for entry in entries:
        # the models call no hand-written kernel and compile nothing: 0, as counted
        entry["models_launches"] = models_launches[entry["name"]]

    # ---- 14. serving -------------------------------------------------------------------
    serve_row, serve_launches = serve_phase(dev, smi)
    for entry in entries:
        # the serving path calls the models only: no hand-written kernel, no
        # compile; 0, as counted
        entry["serve_launches"] = serve_launches[entry["name"]]

    # ---- 15. training ------------------------------------------------------------------
    train_row, train_launches = train_phase(dev, smi)
    for entry in entries:
        # the generated kernels of the stitched train step's counted eager run;
        # the models' training calls no hand-written kernel: 0, as counted
        entry["train_launches"] = train_launches[entry["name"]]

    # ---- 16. the multi-device compiler ----------------------------------------------
    sharded_row, sharded_launches = sharded_phase(dev, smi)
    for entry in entries:
        # the generated kernels of the ranks' counted calls; the sharded
        # path calls no hand-written kernel (counted: each rank fails on one)
        entry["sharded_launches"] = sharded_launches.get(entry["name"], 0)

    # ---- 17. sharded training and the launch tools -----------------------------------
    sp_row, launch_row, sp_launches = sharded_train_phase(dev, smi, models_row, train_row)
    for entry in entries:
        # the sharded step runs the models' training: no kernel of the port,
        # counted in every rank (each fails on one)
        entry["sharded_train_launches"] = sp_launches[entry["name"]]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "build_s": build_s, "ptxas": ptxas,
                       "graphs": per_graph, "kernels": rows, "emitters": entries,
                       "stitched_compiles": stitched_rows, "extra_compiles": extra_rows,
                       "index64": index64_rows, "staged_dots": staged_rows,
                       "hand_kernel_calls": hand_calls, "replay": replay_rows, "loops": loop_rows,
                       "autotune": autotune_rows, "fault_modules": fault_rows,
                       "frontend": frontend_rows, "model_width": model_rows,
                       "models": models_row, "serve": serve_row,
                       "train": train_row, "sharded": sharded_row,
                       "sharded_train": sp_row, "launch": launch_row,
                       "profile_retakes": RETAKES, "profile_edge_losses": EDGE_LOSSES},
                      f, indent=1)
    print(f"profiles taken again: {sum(len(r['refused']) for r in RETAKES)} "
          f"({', '.join(r['label'] for r in RETAKES) or 'none'})")
    lost = ", ".join(f"{e['label']} {e['pads']}" for e in EDGE_LOSSES)
    print(f"profiles kept whose sessions lost pads at an edge: {len(EDGE_LOSSES)} ({lost or 'none'})")
    print(f"card: {smi}")
    print(json.dumps({"model_width": model_rows}))
    print(json.dumps({"models": models_row}))
    print(json.dumps({"serve": serve_row}))
    print(json.dumps({"train": train_row}))
    print(json.dumps({"sharded": sharded_row}))
    print(json.dumps({"sharded_train": sp_row}))
    print(json.dumps({"launch": launch_row}))
    print(json.dumps({"kernels": entries}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
