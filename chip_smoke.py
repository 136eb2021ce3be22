#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``torchx_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. build — compile the CUDA kernels from ``torchx_tpu_torch/csrc``; ptxas's
   registers and spills by instance, and no mma instance may spill.
2. kernels — each kernel of the training step against its plain PyTorch
   version on the card. The flash kernels by variant, per kernel
   (``ops.fused.flash_variant``): the tensor-core ``wgmma`` ones for bf16
   at head_dim 64 and 128; elsewhere the ``mma`` forward, dq and dk/dv
   (mma.sync, f32 in three TF32 passes). In
   f32 (``F32_ATTN_CASES``) at the CPU tests' tolerances; the wgmma ones in
   bf16 at the llama3_1b main-path shapes and at head_dim 128 with n_rep 1
   and 4, causal and full, each at the tile the default table gives
   (``ops.fused.DEFAULT_TILES``; the kernels line names it), and one other
   compiled tile of each wgmma kernel at llama3_1b's and Mixtral's shapes;
   the mma ones in bf16 at head_dim 256 (``BF16_D256_CASES``).
   The wgmma and mma dq and dk/dv and the norm backward's dw must
   be bitwise repeatable. Segment ids (packed documents of 1-1024 tokens,
   the last row one document): the masked kernels of every variant (wgmma
   in bf16; mma in f32) at llama3_1b's and Mixtral-8x7B's
   attention shapes, causal and full, against their masked plain versions
   at the unmasked tolerances; the one-document row bitwise the unmasked
   kernels' output; the masked wgmma and mma dq and dk/dv bitwise
   repeatable; then ``attention(impl="flash", segment_ids=...)`` forward
   and backward in bf16 and f32, whose launch counts are the masked rows'
   launches. On the
   routes off the wgmma kernels (``ROUTES``: f32 at llama3_1b's attention
   shape, f32 and bf16 at head_dim 256, b 4, s 2048, causal), unmasked and
   masked, the rule's kernels timed beside SDPA in the same dtype (the
   backend its dispatcher picks), their launches from
   ``attention(impl="flash")`` forward and backward on the route, the f32
   bound three TF32 passes over 495 TFLOP/s. Times (CUDA events after
   warm-up) of every kernel, the plain version and one PyTorch library
   call as a yardstick (for the masked ones SDPA with the boolean
   block-diagonal mask), and the least time the card could take
   (``bound_ms``; a mask's bound counts the pairs it keeps), at the main
   path's shapes and, for the wgmma flash and the norm kernels, at the
   moe phase's (head_dim 128, dim 4096). The int8-weight matmul of
   weight-only serving (``csrc/int8_matmul.cu``) at llama3_8b's shapes:
   wq/wo, wk/wv, w_gate/w_up and w_down with 8 rows (decode: the
   mma.sync kernel, its k range split, one launch), 512 (a mid prefill
   bucket) and 2048 (the burst's largest prefill chunk: the wgmma
   kernel), the lm head with f32 output at 4 rows (a prefill's last rows)
   and 8 (decode) and, off the serving path, 2048; bf16 activations; f32
   activations (the TF32 mma.sync kernel) at the five decode shapes (8
   rows) and one ragged case (``INT8_F32_CASE``): within 1e-5 (f32
   outputs) or one bf16 rounding (8e-3) of its plain version, two calls
   bitwise equal; timed beside its plain version and ``torch.matmul`` on
   the weight dequantized to x's dtype and held resident (for the bf16 head
   it writes bf16, the kernel f32), with the host's time to issue a call,
   the device kernels a call runs (torch.profiler) and the allocations a
   repeated call makes.
3. train — ``train`` on llama3_1b at full width (16 layers, dim 2048,
   32/8 heads, vocab 128256, tied), bf16, ``kernels="cuda"``, batch 4,
   seq 2048, synthetic tokens; launch counts reset just before and read just
   after, checked against n_layers x (1 + remat recompute) per step for the
   forward kernels and n_layers for the backward ones: the bf16 step runs
   the ``wgmma`` flash kernels and no ``mma`` one, at the preset's tiles
   (``attn_block_q/kv`` 64/64). Then one step at ``attn_block_q=128,
   attn_block_kv=128`` (``OTHER_TILE``): the same weights and batch, its loss
   within 1e-2 of the run's first, the same launches.
   remat — the remat policies on the train phase's setting: its run is
   ``full``; ``dots``, ``dots_attn`` and remat off run 3 steps each. Each
   prints step time, tokens/s, MFU, ``max_memory_allocated`` beside the
   fit probe's traced peak (``parallel/aot_fit.py``: within 10%) and the
   analytic ``hbm_fit``'s total, the flash forward's launches a step (2 x
   16 under ``full`` and ``dots``, 16 under ``dots_attn`` and remat off)
   and the losses (bitwise ``full``'s where the train phase's two runs
   were, else within 1e-3). Then ``--remat-policy auto`` at 28 rows, where
   the fit table refuses ``dots_attn`` and ``dots`` on the card: the table,
   the policy the trainer resolves (the table's), 2 steps, and their peak
   under 0.9 of the card's memory (which the phase prints: the port's H100
   default budget).
4. reference — one step of the same config at 2 layers with the kernels
   and with plain PyTorch ops, losses and gradient norms compared.
   gang — the trainer launched as a gang through ``spmd_main``. A: the train
   phase's run (llama3_1b at full width, 6 steps) as one replica, one
   worker a card on NCCL, ``--mesh fsdp=-1 --grad-bucket-mb 32
   --remat-policy dots`` (the bits and launches of the train phase's
   ``full``), unprofiled, submitted as a user would through the port's
   control daemon and its ``dist.spmd`` component on the local scheduler: a
   ``ControlDaemon`` on loopback (its state under the phase's directory,
   its telemetry ``Collector`` over the job's obs session), the client
   found as ``tpx-torch run`` finds it with ``$TPX_CONTROL_ADDR`` set,
   ``/v1/submit`` of ``dist.spmd --gpu h100-<cards> --coordinator_port 0
   ...`` (one replica of one H100 slice, given the cards as
   ``CUDA_VISIBLE_DEVICES``; the daemon's dryrun under ``$TPX_NO_LINT``),
   ``/v1/wait`` until ``SUCCEEDED`` (it wakes on the reconciler's terminal
   event), ``cancel`` past the time limit, rank 0's ``final:`` line read
   from the replica's ``stdout.log``, then the daemon stopped. Prints the
   daemon's start, the submit's round trip, the replica's exit to the
   wait's return, ``/v1/status`` beside ``Runner.status``, the local
   scheduler's describe calls during the wait, and checks that
   ``/v1/metrics/query`` gives ``tpx_step_seconds`` as the job's own
   textfile holds it. Then it runs profiled as the train
   phase's profiled run (by hand, one replica of ``spmd_main``): state ``SUCCEEDED`` / exit 0,
   every rank's kernel launches the train phase's, and at a world of one
   the losses the train phase's (bitwise where that phase's two runs were,
   else within 1e-3; on more cards within 1e-2). Prints the world, backend
   and mesh, the step time against the train phase's (unprofiled and
   profiled), tokens/s per card, MFU, each rank's peak memory, the
   device's busy time and idle share, and the collectives' device time a
   step (the GPU work launched inside their CPU spans in the trainer's
   trace) beside the bytes a step's gathers and reduce-scatter move. B:
   several ranks with 32 MiB gradient buckets at 2 layers against one
   process on the same global batch, 3 steps, losses within 1e-2 and
   gradient norms within 5e-2 (the reference phase's): four ranks on NCCL
   as ``dp=2,fsdp=2`` with four cards or more, two as ``fsdp=2`` on NCCL
   with two or three, else two on gloo sharing the one card (NCCL refuses
   two ranks on one card); B checkpoints its last step and each rank
   leaves its final state, which the gangckpt phase restores. The
   profiled A run prints the step profiler's
   modeled ``grad_sync`` seconds a step per data axis (the cost model's
   bytes over NVLink's rate; none at a world of one) beside the NCCL
   device time it measures.
   gangckpt — the gang's checkpoints. A: A's run (llama3_1b at full width
   and depth, 16 layers, one worker a card on NCCL, ``--mesh fsdp=-1``)
   with ``--ckpt-dir``, SIGTERM to ``spmd_main`` after its second step
   line: exit 0, preempted, the step it saved passing
   ``verify_checkpoint``; a supervised session resumes on that step as a
   user would (``tpx-torch supervise`` of ``dist.spmd`` on the local
   scheduler, resuming from a hard-link copy of the directory): its first
   attempt is SIGKILLed, its replica's process group, after its first
   step line, is classified PREEMPTED, and is resubmitted from the step
   after the backoff; the second runs the rest of six steps. The ledger
   reads submitted, resubmitting from the step, submitted, finished
   SUCCEEDED; the first attempt's first loss and the second's losses are
   the gang phase's uninterrupted ones (bitwise where the drill's own
   steps were, else within 1e-3); the second resumed from the step with
   its steps' launches; the gang monitor, reading the job's heartbeats and
   leases, gave no verdict. Prints the ledger, the seconds from the kill
   to PREEMPTED, the backoff, the kill to the second attempt's first step
   and that launch's split. With four cards
   or more the step is also restored at ``fsdp=2`` on two of them, every
   restored block bitwise its half of the whole tensor that a reader
   without a mesh assembles from the step's files, and continued (losses
   within 1e-2: another world sums in another order). B: two ranks train
   llama3_1b cut to 2 layers at ``fsdp=2`` and save a file a rank (the
   gang phase's B launch where it ran so, two gloo ranks sharing the one
   card, since the supervised resume joined the phase; else a launch of
   two gloo ranks of its own); the step is restored onto the card at a
   world of one, every entry bitwise the two ranks' final state. Prints each rank's
   host buffer (pinned) bytes, snapshot stall, serialize / fsync / digest
   seconds and rank 0's wait for the other ranks' files
   (``commit_wait_s``; the others' wait for its commit, ``commit_s``), the
   restore's verify, read and H2D seconds, launch-to-first-step on resume,
   SIGTERM to exit against the 30 s notice, and the phase's own seconds
   by part.
   tp — the model axes ``tp`` and ``sp``. On one card: llama3_1b at full
   width cut to 2 layers, bf16, ``kernels="cuda"``, the train phase's
   batch, 3 steps, at ``tp=2`` and then ``sp=2`` in one ``spmd_main``
   launch of two gloo ranks sharing the card (NCCL refuses two ranks on
   one card), each held to one process on the same global batch (the gang
   phase's B run, or its own): losses within 1e-2 and gradient norms
   within 5e-2, every rank's launches one process's (the wgmma flash
   kernels on ``n_heads / tp`` heads over the whole sequence, the norm
   kernels on ``b x s / sp`` rows, no mma). Prints each rank's peak
   memory, the profiled step time, rank 0's collectives by group (the
   port's ``collective:<axes>`` ranges: host and device milliseconds a
   step) and the cost model's bytes a step by axis beside them. With four
   cards or more (``--phases build,train,gang,tp``; not in the default
   run's one-card form): NCCL at full depth, 6 steps, llama3_1b at
   ``fsdp=4``, ``tp=4``, ``fsdp=2,tp=2`` and ``dp=2,sp=2`` (losses within
   1e-2 of ``fsdp=4``'s) and llama3_8b at ``fsdp=2,tp=2``, each with its
   step time, tokens/s a card, MFU, peak memory a rank, collectives by
   group and modeled bytes.
5. serve — ``generate_server`` in-process on 127.0.0.1 (continuous engine,
   8 slots, block size 16, the default pool) with llama3_1b at full width
   and depth, bf16, seeded random weights: 8 concurrent ``/v1/generate``
   requests (six greedy prompts of 32, 257, 512, 700, 1024 and 1500
   tokens, the 1024 one sharing its first 512 tokens with the 512 one, and
   two sampled at temperature 0.8, seed 7, on one 100-token prompt; 64 new
   tokens each; admitted once all are queued), a seed-8 request, a greedy
   re-send that must hit the prefix cache, then ``/healthz`` and
   ``/metricz``. Checks: each greedy
   token's logit within 5e-2 of its row's maximum when the prompt and
   completion are teacher-forced through the plain KV-cache path in the
   engine's chunks (the prompt at its prefill bucket's width, then one
   token at a time); at 2 layers
   in f32 the engine's greedy tokens equal the dense ``generate``'s; the
   same-seed pair is token-identical and seed 8 differs; the re-send
   equals its cold answer; pools and parameters on the card. Prints
   TTFT, TPOT, the decode-step time with all 8 slots busy, tokens/s, peak
   memory and the pool's geometry. The serving path launches none of the
   kernels of the kernels line, which the phase checks. A telemetry
   ``Collector`` over a fresh ``MetricStore`` scrapes the server's
   ``/metricz`` before and after the burst: the ``tpx_serve_ttft_seconds``
   bucket deltas count the burst's requests by their reported TTFT
   exactly (the delta above 0.5 s too), and the store's p50 lies in the
   bucket of the burst's own p50 (the histogram's rank), and an
   ``SloEngine`` with the ``p99-ttft`` preset, evaluated once over the
   store, gives an error fraction equal to the burst's share of replies
   above 0.5 s; prints those counts, the burn and each scrape's seconds.
   pool — a ``ServePool`` (one replica, ``min_replicas=max_replicas=1``)
   submits llama3_1b's ``generate_server`` through the port's ``Runner``
   and the local scheduler with ``gpu="h100-1"`` (the serve phase's slots
   and block size; its base port from a free port, launched again on
   another when the bind fails, at most 3 times); its obs session is its
   own, as a replica's on another host. Submit to healthy (``/healthz``,
   which must name a CUDA device), split at the submit's return and the
   server's ``listening`` line. Four of the serve phase's greedy prompts
   (32, 257, 512, 700 tokens) one at a time through ``serve_router``: the
   32-token answer equals the serve phase's re-send, the others'
   teacher-forced gaps within 5e-2; each request's seconds at the client
   beside the replica's own ``timing`` (the difference is the router's hop
   and the replica's HTTP; the re-sent prompt once more straight to the
   replica gives the replica's share). The replica's ``/metricz`` scraped through
   ``pool.replica_url(0)`` before and after them; ``SloEngine`` with the
   ``p99-ttft`` preset evaluated once: its error fraction equals the share
   of the four replies above 0.5 s. ``obs.stitch`` of one request's trace
   id (the router's ``X-Tpx-Trace-Id``) gives one trace over two session
   dirs, root ``serve.route`` (this process's) with the replica's
   ``serve.unified`` under it, and ``tpx-torch trace <id> --stitch`` in a
   subprocess prints the same. ``pool.stop()`` cancels the app: no process
   of the replica's group is left (the server drains on SIGTERM under the
   local scheduler's ``/bin/sh`` wrapper) and the card's free memory is
   back before the next phase.
6. ckpt — the trainer's checkpoint path at llama3_1b's full width cut to
   2 layers (the gangckpt phase drills and resumes at full depth), the
   train phase's batch, fresh directories under ``$TMPDIR`` (the free
   space is checked first), deleted at the end. A: ``train`` 3 steps with
   ``ckpt_dir`` d, ``ckpt_every`` 2 (the JAX trainer's policy leaves one
   forced save, step 3). B: 3 more steps on d: resumed from 3 to 6, its
   restored state bitwise A's, the kernels' launches over A and B those of
   6 steps. Repeatability: where A's steps equal the first three of an
   uninterrupted 6-step run bitwise, B's must equal its last three
   bitwise, else within 1e-3 relative. Serve:
   ``generate_server --ckpt-dir d`` in-process, two greedy requests of 64
   tokens equal to an engine's on B's final in-memory parameters,
   ``/healthz`` ``ckpt_step`` 6, d's files and manifest unchanged. A copy
   of d's newest step with one payload byte flipped: ``eval_main`` rc 1.
   Overlap: 31 steps saving at step 16 (one periodic save), the step times
   during the background write against the others. Drill: the trainer's
   module in a subprocess saving every 2 steps, SIGTERM after its step-7
   line while step 6's write is in flight: exit 0 within 30 s,
   ``preempted``, the step it saved durable (the manifest's newest, its
   digest verified), ``eval_main`` rc 0. Prints the checkpoint's bytes,
   the stall of each save, each write's seconds (serialization, fsync,
   digest), the restore's verify, read and H2D seconds, SIGTERM to exit
   and the server's load seconds.

7. moe — the MoE family at Mixtral-8x7B's published width (dim 4096,
   32/8 heads, head_dim 128, ffn 14336, 8 experts, top-2, vocab 32000).
   Train: ``train`` on ``mixtral_8x7b_shape(n_layers=2)`` (depth cut from
   32 so that parameters, gradients and two bf16 moments, 25.3 GB, fit
   beside the activations), bf16, ``kernels="cuda"``, full remat, chunked
   cross-entropy, batch 4, seq 2048, synthetic tokens, AdamW, 6 steps;
   launch counts reset just before and read just after: 2 layers x (1 +
   remat) forward flash and norm_res launches a step, 2 of dq, dk/dv and
   the norm backward, all wgmma at head_dim 128; the router's aux,
   entropy and overflow each step; tokens/s, MFU on active parameters,
   the executed FLOPs reckoned beside it, peak memory; then 3 steps under
   ``--remat-policy dots_attn``: the losses the run's own, one flash
   forward a layer a step, peak memory beside the fit probe's. Reference:
   one step
   at 1 layer with the kernels and with plain ops, loss within 1e-2 and
   gradient norm within 5e-2. Serve: the serve phase's burst through
   ``generate_server`` with ``mixtral_8x7b_shape(n_layers=4)`` (6.07 B
   parameters, 12.13 GB; 16 layers before the remat phase, 8 before the
   mma kernels' checks), seeded random weights initialised one expert
   matrix at a time, without the prefix cache (a prefix hit prefills the
   rest of a prompt as its own chunk, whose expert capacity differs);
   greedy tokens teacher-forced through the plain KV-cache path in the
   engine's chunks, at least 90% of them within 5e-2 of their row's
   maximum (a near-tie in the router flips an expert under bf16
   rounding); at 2 layers in f32 the engine's tokens equal the dense
   ``generate``'s for the 32- and 512-token prompts (each its prefill
   bucket's width, neither prefill overflowing an expert); pools and
   parameters on the card, no kernel launched.
   ep — expert parallelism: mixtral_8x7b's width at 2 layers, the train
   phase's batch, 3 steps. A world of one through ``spmd_main`` on NCCL
   under ``--remat-policy auto`` (resolved once for the gang: rank 0's
   probe in a subprocess), its losses and gradient norms bitwise one
   process's (the moe phase's first 3 steps, or a run of its own); then
   ``ep=2`` under ``--remat-policy dots``, two gloo ranks
   sharing the card (each holds half the experts and computes attention
   and the router on the whole batch), profiled: losses within 1e-2 and
   gradient norms within 5e-2 of one process, every rank's launches one
   process's (the wgmma flash kernels at head_dim 128, the norm kernels at
   dim 4096, no mma), the router's aux values finite, and a collective
   over the expert group in rank 0's trace (in the default run the tp
   phase's launch carries this run after its own). Prints each rank's peak
   memory beside the parameters a rank holds, the profiled step time, rank
   0's collectives by group (``ep,tp``: host and device milliseconds a
   step) and the cost model's bytes a step by axis. With four cards or
   more (``--phases build,ep``): NCCL, 8 layers, 6 steps, ``fsdp=4``,
   ``ep=4`` and ``fsdp=2,ep=2`` at the same global batch (the first loss
   within 1e-2 of ``fsdp=4``'s), each with its step time, tokens/s a card,
   MFU on active parameters, peak memory a rank, collectives by group and
   modeled bytes; then the three meshes in f32 with plain ops at 2 layers,
   every loss within 1e-3 of ``fsdp=4``'s (bf16 trajectories part as
   rounding flips near-tied router choices: ``EP_F32``).
   pp — pipeline stages and ring attention. On one card, in the tp phase's
   launch of two gloo ranks sharing the card (or one of its own):
   llama3_1b at full width cut to 2 layers, the train phase's batch, 3
   steps, at ``pp=2`` (GPipe, 4 microbatches of one row, a layer a stage)
   and at ``sp=2`` with ``--ring-attention``, each held to one process on
   the same global batch (the tp phase's, or its own): losses within 1e-2
   and gradient norms within 5e-2, every rank's launches the expected
   count (under ``pp`` microbatches x a stage's layers x (1 + remat) flash
   forwards and norm forwards a step; under the ring no flash launch, the
   ring's products in its place, and the norm kernels on a rank's
   positions). Prints each rank's peak memory, the profiled step time,
   rank 0's collectives by group (``pp``, ``sp``: host and device
   milliseconds a step) beside the cost model's bytes. Then
   ``ring_attention`` and ``ulysses_attention`` in f32 at llama3_1b's
   attention shape (b 4, s 2048, 32/8 heads, head_dim 64) over ``sp=2``,
   each rank's output and dq against the plain whole-sequence attention
   on the card (the JAX tests' tolerances: 2e-5 / 1e-4 for the ring, 1e-6
   / 1e-5 for Ulysses). With four cards or more (``--phases build,pp``):
   NCCL, llama3_1b at full depth, 4 steps, at ``pp=4``, ``pp=2,fsdp=2``,
   ``pp=2,tp=2`` and ``pp=2,sp=2`` with ring attention, each held to one
   process (losses within 1e-2), its peak memory a rank beside the fit
   probe's; then the long sequence, b 1, s 16384, ``sp=4``, with ring
   attention against the sequence gather: step time, peak memory a rank,
   the ``sp`` collectives' device milliseconds beside the modeled bytes.

8. int8 — int8 train: ``train`` on llama3_1b in the train phase's
   setting under ``--int8-scope all`` and ``ffn`` (the trainer's own flag
   mapping, ``int8_config``): losses finite, the first within 0.2 of the
   bf16 run's on the same weights and batch, the flash and norm kernels'
   launches those of the bf16 run, and the int8 training dot's calls the
   reckoning (per step and projection: the forward, the remat recompute
   and two backward products; 7 projections a layer under ``all``, 3 under
   ``ffn``); step time, tokens/s, MFU (bf16 formula) and peak memory
   beside the bf16 run's. int8 serve: ``generate_server`` in-process with
   llama3_8b at full width cut to 4 of its 32 layers (seeded weights; 8
   before the pool phase, 16 layers, 4.54 B parameters, before the gangckpt
   phase's supervised resume, full depth before the remat phase), the serve
   phase's burst, first
   bf16 and then ``--int8``, each freed before the next: every projection
   int8 with f32 scales and the embedding bf16; resident parameter bytes
   (allocated after setup less the KV pools) within 1% of the reckoning
   (9.08 GB, 5.07 GB at 16 layers); each decode step and prefill chunk of
   the burst launches the int8-weight matmul 7 x layers + 1 times and the plain int8
   path never runs on the card; the int8 greedy tokens teacher-forced
   through the plain int8 path in the engine's chunks, at least 90% of them
   within 5e-2 of
   their row's maximum (the MoE cell's check; the tokens beyond are
   printed); int8 against bf16 logits on one token stream (the 257-token
   prompt and its bf16 completion): the mean relative gap is printed at
   the cell's depth, and held under 0.05 (tests/test_quant.py's criterion) at
   that test's depth, 2 layers, at llama3_8b's width: the gap grows with
   depth from the weights' rounding alone (PERF.md, PR 8). Prints
   TTFT, TPOT, the decode step, tokens/s, peak memory and one profiled
   decode step's device time (the int8 matmuls, the K/V gathers, the
   rest) for both.
9. specs — the launcher's specs layer (``torchx_tpu_torch.specs``, no
   kernel) on the card, right after the build: ``named_resources["h100-1"]``
   resolves to one H100 slice whose ``hbm_bytes_per_gpu`` (the generation
   table that ``parallel/aot_fit.py`` and ``analyze/costmodel.py`` read)
   equals the card's ``total_memory``, and the card's name names an H100;
   both printed beside the ``nvidia-smi`` reading.
10. local — the launcher's local scheduler on the card, after the gang
   phase (whose A run the control daemon's runner submitted to it): the
   cards it counts
   without torch (``local_gpu_count()``: the launcher's own
   ``CUDA_VISIBLE_DEVICES``, else the CUDA driver's count through ctypes)
   equal ``torch.cuda.device_count()``; the ``CUDA_VISIBLE_DEVICES`` it
   gave A's replica; A's final state; seconds from submit to rank 0's first
   ``step`` line and to ``SUCCEEDED`` (with the trainer's launch stages,
   ``launch_breakdown_s``, and the marks of the job's own trace,
   ``launch_marks_s``); and a dryrun of a role asking for one card more
   than the host has must be refused for over-subscription; the daemon's
   figures of the gang phase under ``gang_a.daemon``. ``--phases
   ...,gang,local,gangspmd`` also runs A unprofiled by hand through
   ``spmd_main`` as before the launcher took it, for its step time beside
   the daemon's run in one call.
11. remote — the launcher's remote backends on the card's machine, after
   local: gang A's ``dist.spmd --gpu h100-<cards>`` app dryrun through gke,
   slurm, local_docker, vertex and gcp_batch in a subprocess, every client
   a stub that raises if called (no cluster, registry or cloud here). The
   subprocess leaves neither torch nor jax in ``sys.modules``; the docker
   request names exactly ``torch.cuda.device_count()`` cards (by UUID,
   beside torch's UUIDs and the ``/dev/nvidia<N>`` nodes found); the GKE
   limit, the slurm ``--gpus-per-node``, the Batch accelerator count and
   the Vertex ``acceleratorCount`` each equal the slice's ``gpus_per_host``
   under ``nvidia-h100-80gb`` / ``NVIDIA_H100_80GB``; each slurm het
   group's identity env equals ``role_replica_env``'s; no request names a
   TPU. Its seconds are on the ``end`` line.

The train phase also runs the trainer once more with the step profiler and
a torch.profiler trace (``profile=True, profile_dir=...``): one
``profile.jsonl`` record per timed step, the phases within 5% of each
step's wall time, the launches of the unprofiled run, the metrics textfile
holding ``tpx_step_seconds``; it prints the profiled step time against the
unprofiled one, the trace's size and each step's data wait. The serve
phase then drives the same burst through a prefill and a decode replica
(``--serve-role prefill --kv-transfer http:<decode>``, ``--serve-role
decode``): greedy tokens equal the unified server's, a re-send is a prefix
hit on the prefill replica, ``/v1/kv`` answers 400 for a body that is no
payload and 503 at the prefill role; TTFT and TPOT beside the unified
numbers, the handoff's bytes and seconds by stage.

``--phases build,rematoom`` runs the policy the auto case's table refuses
(``dots`` at 28 rows) in a subprocess, which must run out of memory.
``--phases build,hostus`` times the host's microseconds to enqueue each
kernel's entry point (flash attention, the fused residual-add + RMSNorm,
the RMSNorm with the fused backward; forward, and forward with backward);
``--package-root DIR`` imports the port from another tree (a parent
commit's ``git archive``), so that one call compares the two. With four
cards the tp and ep phases' four-card runs print the fit probe's rank-0
peak (traced in a subprocess) and ``hbm_fit``'s total beside each rank's
measured peak.
``--phases build,routes`` times the flash kernels that the package's own
rule picks (``ops.fused.flash_variant``) on the routes that do not reach
the wgmma kernels (``ROUTES``: f32 at llama3_1b's attention shape, f32 and
bf16 at head_dim 256), each held to its plain version first, unmasked and
masked, beside SDPA and the bound; with ``--package-root`` the same rows of
another tree's kernels (the kernels phase prints this tree's among its
rows). ``--phases build,int8f32`` does the same for the int8-weight
matmul's f32-activation rows. ``--phases build,dqgrid`` builds the mma
dq's candidate tiles by group (``csrc/flash_dq_mma.cuh``
``TPX_FLASH_DQ_MMA_GRID_<n>``), prints ptxas's registers and spills for
each, holds each candidate without spills to the plain dq and times it at
its group's shape: the source of the dq rows of ``ops.fused.MMA_TILES``.
``--phases build,sweep`` times the RMSNorm backward kernel over its launch
settings (``ops.norms.BWD_CONFIG``), then every compiled tile of the three
wgmma flash kernels at llama3_1b's and Mixtral's attention shapes, masked
and not, each first held to the plain version: the source of
``ops.fused.DEFAULT_TILES`` and of the presets' ``attn_block_q/kv``.
``--phases build,profile`` profiles a
training step and a decode step, splits the trainer's own trace
(``--profile-dir``) of llama3_1b's step into kernel groups with the
elementwise group split into the optimizer, casts, RoPE, cross-entropy and
the rest, and times the step profiler's overhead. ``--phases
build,notice`` runs the full-depth drill under both designs of a save
during a write, in turns: (a) join the write, then write; (b) write beside
it (the checkpointer's). ``--phases build,moeprofile`` splits the moe
phase's training step (3 steps through the trainer's ``--profile-dir``
trace) by part: the experts, the dispatch and combine einsums, the router,
AdamW, cross-entropy, RoPE, attention and the rest. ``--phases
build,int8profile`` profiles one llama3_1b training step in bf16 and with
int8 matmuls: device time by group, the int8 products apart, and the
change from bf16 to int8. ``--phases build,int8sweep`` times the
int8-weight matmul's bf16 paths (decode, and wgmma at 128- and 256-row
tiles, each with its own k split) at llama3_8b's shapes from 8 to 512
rows, each checked against the plain version, and prints where the wgmma
kernel starts to win and where its 256-row tiles do: the sources of
``ops.quant``'s launch-plan constants. ``--phases build,int8parts`` times
the wgmma kernel's parts: the kernel rebuilt without its widening,
without its products, and with neither (the TMA loads alone). ``--phases
build,gangparts`` splits the world-1 sharded step's cost in this process:
single-device, sharded, and sharded with its collectives swapped for
local copies, in turns. ``--phases build,tracecost`` times what tracing
costs the serving path: the serve burst in turns with ``$TPX_TRACE`` on
and off, and a root span, a child span and a span with tracing off
(``phase_trace_cost``).

Prints the kernels line, the card's name and power limit, an ``end`` line
with the run's seconds and each phase's, and as its last line ``{"ok":
true, "device": {...}}``. Exits non-zero, printing no result,
where no CUDA device is present or the port cannot be imported.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import json
import math
import os
import pstats
import re
import subprocess
import sys
import time

PHASES = ("build", "specs", "kernels", "train", "remat", "reference", "gang", "local",
          "remote", "gangckpt", "tp", "serve", "pool", "ckpt", "moe", "ep", "pp", "int8")
#: Run only when asked for (``--phases ...,profile``): where a training
#: step's and a decode step's device time goes, by kernel.
EXTRA_PHASES = ("profile", "sweep", "notice", "moeprofile", "int8profile", "int8sweep",
                "int8parts", "gangparts", "rematoom", "hostus", "routes", "int8f32", "dqgrid",
                "gangspmd", "tracecost")

#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core rate and
#: HBM bandwidth; its L2 cache.
PEAK_BF16_FLOPS = 989e12
#: The f32 flash kernels' rate: f32 accuracy (2e-5) on this card's tensor
#: cores takes three TF32 passes a product (hi*hi + hi*lo + lo*hi, each
#: operand split into two TF32 parts: one pass keeps ~3 decimal digits), so
#: an f32 bound is three times the operations over the TF32 peak.
PEAK_TF32_FLOPS = 495e12
F32_PASSES = 3
PEAK_BYTES = 3.35e12
L2_BYTES = 50e6

#: Where each kernel lives in the repo, and the TPU kernel it replaces.
KERNEL_INFO = {
    "flash_fwd_wgmma": ("cuda", "torchx_tpu_torch/csrc/flash_fwd_wgmma.cuh",
                        "torchx_tpu/ops/fused.py:87"),
    "flash_fwd_mma": ("cuda", "torchx_tpu_torch/csrc/flash_fwd_mma.cuh",
                      "torchx_tpu/ops/fused.py:87"),
    "flash_dq_wgmma": ("cuda", "torchx_tpu_torch/csrc/flash_dq_wgmma.cuh",
                       "torchx_tpu/ops/fused.py:167"),
    "flash_dq_mma": ("cuda", "torchx_tpu_torch/csrc/flash_dq_mma.cuh",
                     "torchx_tpu/ops/fused.py:167"),
    "flash_dkv_wgmma": ("cuda", "torchx_tpu_torch/csrc/flash_dkv_wgmma.cuh",
                        "torchx_tpu/ops/fused.py:198"),
    "flash_dkv_mma": ("cuda", "torchx_tpu_torch/csrc/flash_dkv_mma.cuh",
                      "torchx_tpu/ops/fused.py:198"),
    "norm_res_fwd": ("triton", "torchx_tpu_torch/ops/fused.py",
                     "torchx_tpu/ops/fused.py:361"),
    "rms_norm_bwd": ("triton", "torchx_tpu_torch/ops/norms.py",
                     "torchx_tpu/ops/norms.py:54"),
}
#: The segment-masked launches (``_seg``) replace the library splash
#: kernel's ``SegmentIds`` masking; the Mixtral-shape rows (``_d128``,
#: ``_d4096``) are the same kernels on the moe phase's path.
SPLASH = "torchx_tpu/ops/attention.py:148"
KERNEL_INFO.update({
    f"{name}_seg": (KERNEL_INFO[name][0], KERNEL_INFO[name][1], SPLASH)
    for name in ("flash_fwd_wgmma", "flash_fwd_mma", "flash_dq_wgmma", "flash_dq_mma",
                 "flash_dkv_wgmma", "flash_dkv_mma")
})
#: The CUDA-core kernels that the mma and TF32 kernels replaced, as a
#: parent's tree imported by ``--package-root`` still launches them (the
#: routes and int8f32 phases).
KERNEL_INFO.update({
    "flash_fwd_simt": ("cuda", "torchx_tpu_torch/csrc/flash_attn.cu", "torchx_tpu/ops/fused.py:87"),
    "flash_dq_simt": ("cuda", "torchx_tpu_torch/csrc/flash_attn.cu", "torchx_tpu/ops/fused.py:167"),
    "flash_dq_simt_seg": ("cuda", "torchx_tpu_torch/csrc/flash_attn.cu", SPLASH),
    "flash_dkv_simt": ("cuda", "torchx_tpu_torch/csrc/flash_attn.cu", "torchx_tpu/ops/fused.py:198"),
    "int8_matmul_simt": ("cuda", "torchx_tpu_torch/csrc/int8_matmul.cu", "torchx_tpu/ops/quant.py:63"),
})
KERNEL_INFO.update({f"{name}_d128": KERNEL_INFO[name]
                    for name in ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma")})
KERNEL_INFO.update({f"{name}_d4096": KERNEL_INFO[name]
                    for name in ("norm_res_fwd", "rms_norm_bwd")})
#: The same kernels at a tp or sp rank's local shapes (the tp phase's path).
KERNEL_INFO.update({f"{name}_tp2": KERNEL_INFO[name]
                    for name in ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma")})
KERNEL_INFO.update({f"{name}_sp2": KERNEL_INFO[name]
                    for name in ("norm_res_fwd", "rms_norm_bwd")})
#: The int8-weight matmul of weight-only serving: no Pallas kernel in the
#: JAX package (XLA lowers its dot_general), the port's own kernel.
KERNEL_INFO.update({name: ("cuda", "torchx_tpu_torch/csrc/int8_matmul.cu",
                           "torchx_tpu/ops/quant.py:63")
                    for name in ("int8_matmul", "int8_matmul_tf32")})

# main-path shapes: llama3_1b attention and the [batch*seq, dim] norm rows
ATTN = dict(b=4, s=2048, h=32, kvh=8, d=64)
NORM = dict(n=4 * 2048, d=2048)
# the moe phase's: Mixtral-8x7B attention (head_dim 128) and dim 4096
ATTN_MOE = dict(b=4, s=2048, h=32, kvh=8, d=128)
NORM_MOE = dict(n=4 * 2048, d=4096)
# the tp phase's, a rank's local shapes: llama3_1b attention at tp=2 (16/4
# heads over the whole sequence) and the norm rows at sp=2
ATTN_TP = dict(b=4, s=2048, h=16, kvh=4, d=64)
NORM_SP = dict(n=4 * 2048 // 2, d=2048)
EPS = 1e-5
#: Packed documents of the segment checks: lengths drawn in [1, 1024], so
#: that boundaries fall inside the kernels' 32- to 128-row tiles.
SEG = dict(max_len=1024, seed=7)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    raise SystemExit(1)


#: Cycles of the sleep kernel that each timing starts with (~50 ms at the
#: H100's clock): the host enqueues every timed call while the card sleeps.
HOST_LEAD_CYCLES = 100_000_000


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:  # noqa: ANN001
    """Mean device milliseconds per call: CUDA events around ``iters``
    calls, all enqueued behind a sleep kernel, so that the events time the
    card and not the host's launch overhead (which exceeds a short kernel's
    run: two Triton launches take longer to enqueue than the norm backward
    takes to run)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 200) -> float:  # noqa: ANN001
    """Host microseconds to issue one call of ``fn``, the card busy behind
    a sleep kernel so that no launch waits for it (after warm-up)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def free_card() -> None:
    """Collect the garbage of earlier phases and return the allocator's
    cached blocks: an engine and its timing wrappers form reference
    cycles, which only the cyclic collector frees (a Mixtral-width
    server's 47 GB among them)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def max_err(a, b) -> float:  # noqa: ANN001
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:  # noqa: ANN001
    """max |a - b| over max |b| (max |b| floored at 1)."""
    return max_err(a, b) / max(1.0, float(b.float().abs().max()))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _attn_inputs(b, s, h, kvh, d, dtype, gen):  # noqa: ANN001, ANN202
    import torch

    def rnd(*shape):  # noqa: ANN001, ANN202
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(b, s, h, d), rnd(b, s, kvh, d), rnd(b, s, kvh, d), rnd(b, s, h, d)


def _flash_case(b, s, h, kvh, d, causal, dtype, gen, variants, seg=None):  # noqa: ANN001, ANN202
    """Errors (relative, absolute) of the flash kernels of the given
    variants (None: each kernel's by the package's rule,
    ``ops.fused.flash_variant``) against their plain versions, masked by
    the segment ids ``seg`` where given (names end ``_seg`` then, and
    ``one_doc_row_bitwise_<variant or "rule">`` says whether the
    one-document row, the last, equals the unmasked kernels' output
    bitwise)."""
    import torch

    from torchx_tpu_torch.ops import fused

    q, k, v, do = _attn_inputs(b, s, h, kvh, d, dtype, gen)
    o_p, lse_p = fused._flash_fwd_plain(q, k, v, causal, seg)
    delta = fused._flash_delta(do, o_p)
    args = (q, k, v, do, lse_p, delta, causal)
    dq_p = fused._flash_dq_plain(*args, seg)
    dk_p, dv_p = fused._flash_dkv_plain(*args, seg)
    out, sfx = {}, "" if seg is None else "_seg"
    for var in variants:
        name = {fn: f"{fn}_{var or fused.flash_variant(fn, dtype, d)}{sfx}"
                for fn in fused.FLASH_KERNELS}
        o_k, lse_k = fused._flash_fwd(q, k, v, causal, seg, variant=var)
        dq_k = fused._flash_dq(*args, seg, variant=var)
        dk_k, dv_k = fused._flash_dkv(*args, seg, variant=var)
        out[name["flash_fwd"]] = (max(rel_err(o_k, o_p), rel_err(lse_k, lse_p)),
                                  max(max_err(o_k, o_p), max_err(lse_k, lse_p)))
        out[name["flash_dq"]] = (rel_err(dq_k, dq_p), max_err(dq_k, dq_p))
        out[name["flash_dkv"]] = (max(rel_err(dk_k, dk_p), rel_err(dv_k, dv_p)),
                                  max(max_err(dk_k, dk_p), max_err(dv_k, dv_p)))
        if seg is not None:
            unmasked = (*fused._flash_fwd(q, k, v, causal, variant=var),
                        fused._flash_dq(*args, variant=var),
                        *fused._flash_dkv(*args, variant=var))
            out[f"one_doc_row_bitwise_{var or 'rule'}"] = all(
                torch.equal(m[-1], u[-1])
                for m, u in zip((o_k, lse_k, dq_k, dk_k, dv_k), unmasked))
    return out


def family(name: str) -> str:
    """A kernel's name without its shape or route, its mask and its
    variant: the key of its tolerance (every variant computes the same
    function)."""
    name = re.sub(r"_(f32|bf16)_hd\d+$", "", name)
    name = re.sub(r"_(d|tp|sp)\d+$", "", name).removesuffix("_seg")
    return re.sub(r"_(wgmma|mma|simt)$", "", name)


def packed_segment_ids(b: int, s: int, max_len: int, seed: int):  # noqa: ANN201
    """int32 [b, s] segment ids on the card: rows of packed documents with
    lengths drawn in [1, max_len] from ``seed``; the last row is one
    document."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for row in range(b - 1):
        pos, doc = 0, 0
        while pos < s:
            n = int(rng.integers(1, max_len + 1))
            seg[row, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return torch.tensor(seg, device="cuda")


def kept_pairs(seg, causal: bool) -> int:  # noqa: ANN001
    """Query-key pairs per head that a segment mask keeps: per document of
    n tokens, n(n+1)/2 causal or n*n full."""
    import torch

    total = 0
    for row in seg.cpu():
        _, n = torch.unique_consecutive(row, return_counts=True)
        n = n.to(torch.int64)
        total += int((n * (n + 1) // 2).sum() if causal else (n * n).sum())
    return total


def _norm_case(n, d, dtype, gen):  # noqa: ANN001, ANN202
    """Errors of the two norm kernels against their plain versions; the
    residual stream s must be bitwise equal."""
    import torch

    from torchx_tpu_torch.ops import fused, norms

    x = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    r = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(dtype)
    dy = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    y_k, s_k = fused._norm_res_fwd(x, r, w, EPS)
    y_p, s_p = fused._rms_norm_residual_math(x, r, w, EPS)
    if not torch.equal(s_k, s_p):
        fail("kernels", f"norm_res_fwd: residual stream s not bitwise ({dtype})")
    dx_k, dw_k = norms._bwd(x, dy, w, EPS)
    dx_p, dw_p = norms._bwd_math(x, w, dy, EPS)
    return {
        "norm_res_fwd": (rel_err(y_k, y_p), max_err(y_k, y_p)),
        "rms_norm_bwd": (max(rel_err(dx_k, dx_p), rel_err(dw_k, dw_p)),
                         max(max_err(dx_k, dx_p), max_err(dw_k, dw_p))),
    }


#: f32 tolerances: those of the CPU parity tests (tests/test_torch_ops.py)
F32_TOL = {"flash_fwd": 2e-5, "flash_dq": 5e-4, "flash_dkv": 5e-4,
           "norm_res_fwd": 1e-6, "rms_norm_bwd": 2e-5}
#: bf16 tolerances at the main-path shapes, relative to the largest
#: reference value. Kernel and plain version read the same bf16 values and
#: sum in f32, so the kernels differ by summation order and by the bf16
#: hi + lo split of P and dS (~1e-6,
#: where one bf16 rounding would cost ~2e-3:
#: tests/test_torch_flash_variants.py);
#: the norm kernels' bf16 outputs (y, dx) may differ by one bf16 rounding
#: step (2**-8 relative) where the f32 sums round to either side.
BF16_TOL = {"flash_fwd": 1e-3, "flash_dq": 1e-3, "flash_dkv": 1e-3,
            "norm_res_fwd": 2 ** -7, "rms_norm_bwd": 2 ** -7}

F32_ATTN_CASES = [  # b, s, h, kvh, d, causal
    (2, 256, 2, 2, 64, True), (1, 128, 2, 2, 64, False),
    (2, 256, 4, 2, 64, True), (1, 256, 4, 1, 64, True),
    (1, 128, 2, 1, 128, True), (1, 256, 2, 2, 256, False),
    (1, 256, 4, 2, 256, True),
]
#: bf16 cases of the wgmma kernels beside the main shapes: head_dim 128
#: (llama3_8b), n_rep 1 and 4, causal and full
BF16_WGMMA_CASES = [  # b, s, h, kvh, d, causal
    (2, 1024, 4, 4, 128, True), (2, 1024, 8, 2, 128, True),
    (2, 1024, 4, 4, 128, False), (2, 1024, 8, 2, 128, False),
    (2, 1024, 8, 2, 64, False),
]
#: bf16 at head_dim 256 (the mma forward, dq and dk/dv): n_rep 1
#: and 2, causal and full
BF16_D256_CASES = [  # b, s, h, kvh, d, causal
    (2, 1024, 4, 4, 256, True), (2, 1024, 8, 4, 256, True),
    (2, 1024, 4, 4, 256, False), (2, 1024, 8, 4, 256, False),
]


def _bounds(dtype_bytes: int = 2, attn: dict = ATTN, norm: dict = NORM,
            pairs_per_head: float | None = None) -> dict[str, tuple[float, str, float, float]]:
    """-> kernel -> (bound_ms, bound_by, flops, bytes) at the given shapes.

    Each input read once and each output written once; the causal mask
    means s(s+1)/2 query-key pairs per head and batch row need computing,
    a segment mask only the pairs it keeps (``pairs_per_head``, summed over
    the batch: :func:`kept_pairs`), and the kernels then also read the
    int32 ids. Operations count at the bf16 peak, or for f32 (4-byte
    elements: the flash kernels only) three times over the TF32 peak
    (``F32_PASSES``)."""
    b, s, h, kvh, d = (attn[x] for x in ("b", "s", "h", "kvh", "d"))
    if pairs_per_head is None:
        pairs = b * h * s * (s + 1) / 2
        ids = 0
    else:
        pairs = h * pairs_per_head
        ids = b * s * 4
    qo = b * s * h * d
    kv = b * s * kvh * d
    rows = b * h * s
    n, dn = norm["n"], norm["d"]
    work = {
        # QK^T and PV
        "flash_fwd": (2 * 2 * pairs * d,
                      (qo + 2 * kv) * dtype_bytes + qo * 4 + rows * 4 + ids),
        # QK^T, dO V^T, dS K
        "flash_dq": (3 * 2 * pairs * d,
                     (2 * qo + 2 * kv) * dtype_bytes + 2 * rows * 4 + qo * 4 + ids),
        # K Q^T, V dO^T, P^T dO, dS^T Q
        "flash_dkv": (4 * 2 * pairs * d,
                      (2 * qo + 2 * kv) * dtype_bytes + 2 * rows * 4 + 2 * kv * 4 + ids),
        # add, square, sum, scale, weight: ~6 per element
        "norm_res_fwd": (6 * n * dn, (4 * n * dn + dn) * dtype_bytes),
        # ~10 per element
        "rms_norm_bwd": (10 * n * dn, (3 * n * dn + dn) * dtype_bytes + dn * 4),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = (flops / PEAK_BF16_FLOPS if dtype_bytes == 2
                 else F32_PASSES * flops / PEAK_TF32_FLOPS)
        t_bytes = nbytes / PEAK_BYTES
        out[name] = (
            1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes",
            flops,
            nbytes,
        )
    return out


#: SDPA's backward computes dq, dk and dv in one call: the share of its time
#: that each backward kernel's function takes, by FLOPs of the seven products
#: of the port's split backward (dq: Q K^T, dO V^T, dS K; dk/dv: K Q^T,
#: V dO^T, P^T dO, dS^T Q)
LIBRARY_SHARE = {
    "flash_dq": (3 / 7, "dq: 3 of the split backward's 7 products, by FLOPs"),
    "flash_dkv": (4 / 7, "dk, dv: 4 of the split backward's 7 products, by FLOPs"),
}


def _time_row(name, kern, plain, lib, lib_call, bound, err, f32_err=None):  # noqa: ANN001, ANN202
    """One entry of the kernels line: the kernel's, its plain version's and
    the library call's device times beside the bound."""
    route, source, replaces = KERNEL_INFO[name]
    bound_ms, bound_by, flops, nbytes = bound
    ms = time_ms(kern)
    library_ms = time_ms(lib)
    share, share_of = LIBRARY_SHARE.get(family(name), (None, None))
    return {
        "name": name, "route": route, "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err[1], "rel_err": err[0],
        "tol": BF16_TOL[family(name)],
        # the wgmma kernels take bf16 only
        "f32_rel_err": f32_err,
        "f32_tol": F32_TOL[family(name)] if f32_err is not None else None,
        "ms": ms, "plain_ms": time_ms(plain, iters=3),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_call": lib_call,
        "library_share_ms": share and share * library_ms, "library_share": share_of,
        "flops": flops, "bytes": nbytes,
        "roofline_share": bound_ms / ms,
    }


def _sdpa_calls(q, k, v, do, mask=None):  # noqa: ANN001, ANN202
    """SDPA forward and backward (dq, dk, dv in one autograd.grad call) on
    the kernels' inputs in SDPA's [b, h, s, d] layout: causal, or under a
    boolean ``mask`` [b, 1, s, s] (True = attend)."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kw = dict(is_causal=True) if mask is None else dict(attn_mask=mask)
    qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True, **kw)
    do_t = do.transpose(1, 2)

    def fwd():  # noqa: ANN202
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)

    def bwd():  # noqa: ANN202
        return torch.autograd.grad(out, (qg, kg, vg), do_t, retain_graph=True)

    return fwd, bwd


def _flash_rows(attn, variants, suffix, gen, errs, seg=None):  # noqa: ANN001, ANN202
    """Timed rows of the flash kernels of ``variants`` at ``attn`` (causal,
    bf16), masked by ``seg`` where given, named ``flash_<fn>_<variant>`` +
    ``suffix``; ``errs`` holds each one's (relative, absolute) error."""
    import torch

    from torchx_tpu_torch.ops import fused

    q, k, v, do = _attn_inputs(*attn.values(), torch.bfloat16, gen)
    o, lse = fused._flash_fwd(q, k, v, True, seg)
    delta = fused._flash_delta(do, o)
    args = (q, k, v, do, lse, delta, True)
    mask = None
    if seg is not None:
        same = seg[:, :, None] == seg[:, None, :]
        mask = (same & torch.ones_like(same).tril())[:, None]
    sdpa_fwd, sdpa_bwd = _sdpa_calls(q, k, v, do, mask)
    masked = "" if seg is None else " with the boolean block-diagonal causal attn_mask"
    fwd_call = f"F.scaled_dot_product_attention(enable_gqa=True){masked}, forward"
    bwd_call = f"SDPA{masked} backward: dq, dk and dv in one call"
    bounds = _bounds(attn=attn, pairs_per_head=None if seg is None else kept_pairs(seg, True))
    rows = []
    for var in variants:
        calls = {
            "flash_fwd": (lambda var=var: fused._flash_fwd(q, k, v, True, seg, variant=var),
                          lambda: fused._flash_fwd_plain(q, k, v, True, seg),
                          sdpa_fwd, fwd_call),
            "flash_dq": (lambda var=var: fused._flash_dq(*args, seg, variant=var),
                         lambda: fused._flash_dq_plain(*args, seg), sdpa_bwd, bwd_call),
            "flash_dkv": (lambda var=var: fused._flash_dkv(*args, seg, variant=var),
                          lambda: fused._flash_dkv_plain(*args, seg), sdpa_bwd, bwd_call),
        }
        for fn, (kern, plain, lib, lib_call) in calls.items():
            name = f"{fn}_{var}{suffix}"
            rows.append(_time_row(name, kern, plain, lib, lib_call, bounds[fn], errs[name]))
            # the (block_q, block_kv) it ran with: the default table's
            rows[-1]["tile"] = list(fused.fit_tile(fn, var, attn["d"], attn["s"]))
    return rows


def _norm_rows(norm, suffix, gen, errs):  # noqa: ANN001, ANN202
    """Timed rows of the two norm kernels at ``norm`` (bf16)."""
    import torch
    import torch.nn.functional as F

    from torchx_tpu_torch.ops import fused, norms

    n, dn = norm["n"], norm["d"]
    x = torch.randn((n, dn), generator=gen, device="cuda").to(torch.bfloat16)
    r = torch.randn((n, dn), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.ones((dn,), device="cuda", dtype=torch.bfloat16)
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    rms_out = F.rms_norm(xg, (dn,), wg, EPS)

    def rms_bwd():  # noqa: ANN202
        return torch.autograd.grad(rms_out, (xg, wg), r, retain_graph=True)

    bounds = _bounds(norm=norm)
    return [
        _time_row(f"norm_res_fwd{suffix}", lambda: fused._norm_res_fwd(x, r, w, EPS),
                  lambda: fused._rms_norm_residual_math(x, r, w, EPS),
                  lambda: F.rms_norm(x + r, (dn,), w, EPS),
                  "F.rms_norm(x + r) (the add is a second call)",
                  bounds["norm_res_fwd"], errs["norm_res_fwd"][:2], errs.get("f32_norm_res_fwd")),
        _time_row(f"rms_norm_bwd{suffix}", lambda: norms._bwd(x, r, w, EPS),
                  lambda: norms._bwd_math(x, w, r, EPS), rms_bwd,
                  "F.rms_norm backward: dx and dw in one autograd.grad call",
                  bounds["rms_norm_bwd"], errs["rms_norm_bwd"][:2], errs.get("f32_rms_norm_bwd")),
    ]


#: The int8-weight matmul's shapes on llama3_8b's serving path: (K, N, the
#: projections of that shape, f32 output). One layer's seven projections
#: and the untied lm head, whose logits stay f32.
INT8_SHAPES = [(4096, 4096, "wq_wo", False), (4096, 1024, "wk_wv", False),
               (4096, 14336, "w_gate_w_up", False), (14336, 4096, "w_down", False),
               (4096, 128256, "lm_head", True)]
#: Rows a call: the serve burst's 8 busy slots (decode), a mid prefill
#: bucket (512) and its largest prefill chunk: the 1500-token prompt alone
#: at its bucket's width, 2048 (four rows of one bucket never exceed it;
#: the int8 run checks). The head runs on a prefill's last rows (one per
#: prompt, at most 4) and at decode on the busy slots; its 2048-row case
#: is off the serving path.
INT8_M = (8, 512, 2048)
INT8_HEAD_M = (4, 8, 2048)
INT8_OFF_PATH = {("lm_head", 2048)}
#: The f32 case (the TF32 kernel): ragged N, K no multiple of the stage.
INT8_F32_CASE = (17, 520, 1040)
#: Rows of the f32 rows at llama3_8b's shapes: the decode step's 8 slots.
INT8_F32_M = 8
#: f32 outputs within 1e-5 of the largest value (the sums' order differs);
#: bf16 outputs within one bf16 rounding of the f32 sum, elementwise.
INT8_F32_TOL = 1e-5
INT8_BF16_RTOL = 8e-3
#: The int8 kernels' path names, by ``quant.Plan.path``.
#: (a parent's tree, under ``--package-root``, runs its CUDA-core kernel
#: on path 0; the row's name says which).
INT8_PATHS = {0: "f32 x", 1: "decode (mma.sync)", 2: "wgmma (TMA)"}
#: TF32 products an f32-activation call issues a weight: x_hi q + x_lo q.
INT8_F32_PASSES = 2


def int8_row_name(k: int, n: int, m: int) -> str:
    """The kernels line's name of an int8 row: ``int8_matmul`` at the decode
    shape of the largest layer projection (w_gate / w_up), the others with
    their projections and rows."""
    tag = next(t for kk, nn, t, _ in INT8_SHAPES if (kk, nn) == (k, n))
    return "int8_matmul" if (tag, m) == ("w_gate_w_up", 8) else f"int8_matmul_{tag}_m{m}"


def _int8_check(y, want) -> tuple[float, float, bool]:  # noqa: ANN001
    """(max |y - want| over max |want|, max |y - want|, within tolerance)."""
    import torch

    diff = (y.float() - want.float()).abs()
    big = float(want.float().abs().max())
    rel = float(diff.max()) / max(big, 1e-30)
    if y.dtype == torch.float32:
        return rel, float(diff.max()), rel <= INT8_F32_TOL
    ok = bool((diff <= INT8_BF16_RTOL * want.float().abs() + 1e-5 * big).all())
    return rel, float(diff.max()), ok


def device_kernels(fn, sessions: int = 5) -> list[str]:  # noqa: ANN001
    """The names of the device kernels one call of ``fn`` runs (after a
    warm-up call), by torch.profiler: the most that any of ``sessions``
    sessions of one call each recorded. On the H100 the profiler now and
    then drops the record of a kernel of ~10 us, the port's or cuBLAS's
    (at M 8, one of 25 sessions of a cuBLAS matmul came back empty, and
    sessions of ten int8 calls lost one record or all ten), and never adds
    one, so the largest count is the call's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen: list[str] = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        seen = max(seen, names, key=len)
    return seen


def allocations(fn) -> int:  # noqa: ANN001
    """The caching allocator's allocations in one call of ``fn`` after a
    warm-up call."""
    import torch

    fn()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    fn()
    return torch.cuda.memory_stats()["allocation.all.allocated"] - before


def _weight_pool(q, nbytes: int) -> list:  # noqa: ANN001
    """``q`` and copies of it that together exceed the 50 MB L2 twice: a
    timed call rotating over them reads its weight from device memory, as
    a decode step does (one read per layer and step)."""
    return [q] + [q.clone() for _ in range(math.ceil(2 * L2_BYTES / nbytes) - 1)]


def _int8_rows(gen, f32_only: bool = False) -> list[dict]:  # noqa: ANN001
    """The int8-weight matmul against its plain version on the same
    tensors at llama3_8b's shapes (decode, a mid and the largest prefill
    chunk, bf16; the head at the rows it runs on), f32 activations at the
    decode shapes (``INT8_F32_M`` rows) and one ragged f32 case, two calls
    bitwise equal; then the timed rows: the kernel, the plain version, and
    ``torch.matmul`` on the weight dequantized to x's dtype and held
    resident (cuBLAS doing what the float model does: the yardstick, never
    called by the port); the host's time per call, the device kernels a
    call runs and the allocations of a repeated call. ``f32_only``: the f32
    rows alone (``--phases build,int8f32``)."""
    import torch

    from torchx_tpu_torch.ops import quant

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [] if f32_only else [
        (m, k, n, bf16, head_f32, tag) for k, n, tag, head_f32 in INT8_SHAPES
        for m in (INT8_HEAD_M if tag == "lm_head" else INT8_M)]
    cases += [(INT8_F32_M, k, n, f32, True, tag) for k, n, tag, _ in INT8_SHAPES]
    cases.append((*INT8_F32_CASE, f32, True, "f32_case"))
    rows = []
    for m, k, n, dtype, out_f32, tag in cases:
        x_f32 = dtype == f32
        out = f32 if out_f32 else None
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        q, scale = quant.quantize(w)
        del w
        y = quant.int8_matmul(x, q, scale, out_dtype=out)
        want = quant._int8_matmul_plain(x, q, scale, out)
        rel, err, ok = _int8_check(y, want)
        repeat = torch.equal(y, quant.int8_matmul(x, q, scale, out_dtype=out))
        kernel = quant.kernel_name(dtype)
        name = (int8_row_name(k, n, m) if not x_f32 else kernel if tag == "f32_case"
                else f"{kernel}_{tag}_m{m}")
        plan = quant.launch_plan(m, n, k, x_f32, sms, out_f32 and not x_f32)
        emit({"phase": "kernels", "check": name, "m": m, "k": k, "n": n,
              "dtype": str(dtype).removeprefix("torch."),
              "out": str(out or dtype).removeprefix("torch."), "path": INT8_PATHS[plan.path],
              "rel_err": rel, "max_abs_err": err,
              "tol": INT8_F32_TOL if y.dtype == f32 else INT8_BF16_RTOL,
              "within_tol": ok, "bitwise_repeat": repeat})
        if not ok:
            fail("kernels", f"{name} ({m}, {k}, {n}): error {rel} beyond tolerance")
        if not repeat:
            fail("kernels", f"{name} ({m}, {k}, {n}): two calls differ")
        del y, want
        qs = _weight_pool(q, q.numel())
        libs = _weight_pool(quant.dequantize(q, scale, dtype), q.numel() * x.element_size())
        turn = {"q": 0, "lib": 0}

        def rotate(key: str, pool: list):  # noqa: ANN202
            turn[key] = (turn[key] + 1) % len(pool)
            return pool[turn[key]]

        def call():  # noqa: ANN202
            return quant.int8_matmul(x, q, scale, out_dtype=out)

        out_bytes = 4 if out_f32 else 2
        nbytes = x.element_size() * m * k + k * n + 4 * n + m * n * out_bytes
        flops = 2 * m * k * n
        # f32 x: two TF32 products (x_hi q + x_lo q) at the TF32 rate
        t_ops = (INT8_F32_PASSES * flops / PEAK_TF32_FLOPS if x_f32
                 else flops / PEAK_BF16_FLOPS)
        t_bytes = nbytes / PEAK_BYTES
        ms = time_ms(lambda: quant.int8_matmul(x, rotate("q", qs), scale, out_dtype=out))
        kernels = device_kernels(call)
        row = {
            "name": name, "route": "cuda", "source": KERNEL_INFO[kernel][1],
            "replaces": KERNEL_INFO[kernel][2], "launches": None,
            "shape": {"m": m, "k": k, "n": n, "x": str(dtype).removeprefix("torch."),
                      "out": "float32" if out_f32 else "bfloat16"},
            "path": INT8_PATHS[plan.path], "split_k": plan.splits,
            "on_serving_path": (tag, m) not in INT8_OFF_PATH and not x_f32,
            "max_abs_err": err, "rel_err": rel, "f32_rel_err": None, "f32_tol": None,
            "tol": INT8_F32_TOL if out_f32 else INT8_BF16_RTOL,
            "ms": ms, "plain_ms": time_ms(lambda: quant._int8_matmul_plain(
                x, rotate("q", qs), scale, out), iters=3),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": time_ms(lambda: torch.matmul(x, rotate("lib", libs))),
            "weight_copies": [len(qs), len(libs)],
            # the host's time to issue one call, which a decode step pays for
            # every projection (the card runs behind it)
            "host_us": host_us(call),
            "library_host_us": host_us(lambda: torch.matmul(x, libs[0])),
            "device_kernels_per_call": len(kernels), "device_kernel_names": sorted(set(kernels)),
            "allocations_per_call": allocations(call),
            "library_call": "torch.matmul(x, w) on the weight dequantized to x's dtype,"
                            " resident (cuBLAS" + (", TF32 off)" if x_f32 else ")")
                            + ("; it writes bf16, the kernel f32" if out_f32 and not x_f32
                               else ""),
            "flops": flops, "bytes": nbytes, "roofline_share": 1e3 * max(t_bytes, t_ops) / ms,
        }
        rows.append(row)
        if len(kernels) != 1 or row["allocations_per_call"] != 1:
            fail("kernels", f"{name}: {kernels} device kernels and"
                            f" {row['allocations_per_call']} allocations a call (want 1 and 1)")
        del x, q, scale, qs, libs
    torch.cuda.synchronize()
    free_card()
    return rows


#: The segment checks: (variant, dtype name, shape) x causal and full;
#: None is each kernel's variant by the package's rule (in f32 and at head
#: dim 256: the mma forward, dq and dk/dv).
SEG_CASES = [("wgmma", "bfloat16", "llama3_1b"), ("wgmma", "bfloat16", "mixtral_8x7b"),
             (None, "float32", "llama3_1b"), (None, "float32", "mixtral_8x7b")]


def _segment_checks(gen, seg) -> dict:  # noqa: ANN001
    """The masked kernels of every variant at llama3_1b's and Mixtral's
    attention shapes, causal and full, against their masked plain versions
    at the unmasked tolerances; the one-document row bitwise the unmasked
    kernels'; the masked wgmma and mma dq and dk/dv bitwise repeatable
    (head_dim 256 masked: the route rows, and the card tests' one-document
    rows). -> the f32 errors by kernel name."""
    import torch

    from torchx_tpu_torch.ops import fused

    shapes = {"llama3_1b": ATTN, "mixtral_8x7b": ATTN_MOE}
    f32_err: dict[str, float] = {}
    for variant, dtype_name, shape in SEG_CASES:
        dtype = getattr(torch, dtype_name)
        tols = F32_TOL if dtype == torch.float32 else BF16_TOL
        for causal in (True, False):
            errs = _flash_case(*shapes[shape].values(), causal, dtype, gen, (variant,), seg)
            one_doc = errs.pop(f"one_doc_row_bitwise_{variant or 'rule'}")
            for name, (rel, _) in errs.items():
                tol = tols[family(name)]
                emit({"phase": "kernels", "check": name, "dtype": dtype_name, "shape": shape,
                      "causal": causal, "err": rel, "tol": tol,
                      "one_doc_row_bitwise": one_doc})
                if not rel <= tol:
                    fail("kernels", f"{name} {dtype_name} {shape} causal={causal}:"
                                    f" err {rel} > {tol}")
                if dtype == torch.float32:
                    f32_err[name] = max(f32_err.get(name, 0.0), rel)
            if not one_doc:
                fail("kernels", f"masked {variant or 'rule'} {dtype_name} {shape}"
                                f" causal={causal}: the one-document row differs from the"
                                " unmasked kernels' output")
    for attn, dtype, names in ((ATTN, torch.bfloat16, ["flash_dq_wgmma_seg", "flash_dkv_wgmma_seg"]),
                               (ATTN, torch.float32, ["flash_dq_mma_seg", "flash_dkv_mma_seg"]),
                               (ATTN_D256, torch.bfloat16, ["flash_dq_mma_seg", "flash_dkv_mma_seg"])):
        q, k, v, do = _attn_inputs(*attn.values(), dtype, gen)
        o, lse = fused._flash_fwd(q, k, v, True, seg)
        args = (q, k, v, do, lse, fused._flash_delta(do, o), True, seg)
        same = all(torch.equal(a, b) for a, b in zip(fused._flash_dkv(*args),
                                                      fused._flash_dkv(*args)))
        same = same and torch.equal(fused._flash_dq(*args), fused._flash_dq(*args))
        if not same:
            fail("kernels", f"masked {names} ({dtype}, head_dim {attn['d']}): two calls differ")
        emit({"phase": "kernels", "check": "bitwise repeatable", "kernels": names,
              "dtype": str(dtype).removeprefix("torch."), "shape": list(attn.values())})
        del q, k, v, do, o, lse, args
    return f32_err


def _other_tile_checks(gen) -> None:  # noqa: ANN001
    """Beside the default table (every other check of the phase), one other
    compiled tile of each wgmma kernel against the plain version, at
    llama3_1b's and Mixtral's attention shapes (causal, bf16, at
    ``BF16_TOL``); the full grid is the sweep phase's."""
    import torch

    from torchx_tpu_torch.ops import fused

    for attn in (ATTN, ATTN_MOE):
        d, s = attn["d"], attn["s"]
        q, k, v, do = _attn_inputs(*attn.values(), torch.bfloat16, gen)
        o_p, lse_p = fused._flash_fwd_plain(q, k, v, True)
        args = (q, k, v, do, lse_p, fused._flash_delta(do, o_p), True)
        want = {"flash_fwd": (o_p, lse_p), "flash_dq": (fused._flash_dq_plain(*args),),
                "flash_dkv": fused._flash_dkv_plain(*args)}
        for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
            q_tiles, kv_tiles = fused.WGMMA_TILES[(kernel, d)]
            default = fused.fit_tile(kernel, "wgmma", d, s)
            tile = next((bq, bk) for bq in q_tiles for bk in kv_tiles if (bq, bk) != default)
            got = {"flash_fwd": lambda: fused._flash_fwd(q, k, v, True, tile=tile),
                   "flash_dq": lambda: (fused._flash_dq(*args, tile=tile),),
                   "flash_dkv": lambda: fused._flash_dkv(*args, tile=tile)}[kernel]()
            err = max(rel_err(a, b) for a, b in zip(got, want[kernel]))
            tol = BF16_TOL[kernel]
            emit({"phase": "kernels", "check": f"{kernel}_wgmma", "dtype": "bfloat16",
                  "shape": list(attn.values()), "tile": list(tile), "default": list(default),
                  "err": err, "tol": tol})
            if not err <= tol:
                fail("kernels", f"{kernel}_wgmma tile {tile} at head_dim {d}: err {err} > {tol}")
        del q, k, v, do, o_p, lse_p, args, want, got


def _packed_attention_launches(seg) -> dict[str, int]:  # noqa: ANN001
    """The masked path through its entry point: ``attention(impl="flash",
    segment_ids=...)`` forward and backward at llama3_1b's shape, in bf16
    (the wgmma kernels) and f32 (the mma kernels),
    launch counts reset just before and read just after."""
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.ops.attention import attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    torch.cuda.synchronize()
    _build.reset_launches()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _ = (t.requires_grad_() for t in _attn_inputs(*ATTN.values(), dtype, gen))
        out = attention(q, k, v, segment_ids=seg, impl="flash")
        out.float().square().mean().backward()
        if not all(torch.isfinite(t.grad).all() for t in (q, k, v)):
            fail("kernels", f"packed-document attention: non-finite gradient ({dtype})")
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    emit({"phase": "kernels", "path": "attention(impl='flash', segment_ids)",
          "launches": {k: n for k, n in counts.items() if n}})
    return counts


#: Gemma-2-2B's attention (8 query heads over 4 KV heads of 256) at the
#: train cell's batch and sequence: a head dim the wgmma kernels do not take.
ATTN_D256 = dict(b=4, s=2048, h=8, kvh=4, d=256)
#: The routes off the wgmma kernels, causal: f32 (the bf16 tensor-core path
#: cannot take it) at llama3_1b's shape and at head_dim 256, and bf16 at
#: head_dim 256. Row names end with the route's tag.
ROUTES = (("f32_hd64", ATTN, "float32"), ("f32_hd256", ATTN_D256, "float32"),
          ("bf16_hd256", ATTN_D256, "bfloat16"))


def _sdpa_backend(q, k, v, mask) -> str:  # noqa: ANN001
    """The backend SDPA's dispatcher picks for :func:`_sdpa_calls` on these
    inputs (its backward runs the same backend's)."""
    import torch
    from torch.nn.attention import SDPBackend

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    choice = torch._fused_sdp_choice(qt, kt, vt, mask, 0.0, mask is None, enable_gqa=True)
    return SDPBackend(choice).name.lower()


def _route_launches(route: str, attn: dict, dtype, seg) -> dict[str, int]:  # noqa: ANN001
    """The route's path through its entry point: ``attention(impl="flash")``
    forward and backward, unmasked then with the segment ids, launch counts
    reset just before and read just after."""
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.ops.attention import attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    torch.cuda.synchronize()
    _build.reset_launches()
    for ids in (None, seg):
        q, k, v, _ = (t.requires_grad_() for t in _attn_inputs(*attn.values(), dtype, gen))
        out = attention(q, k, v, segment_ids=ids, impl="flash")
        out.float().square().mean().backward()
        if not all(torch.isfinite(t.grad).all() for t in (q, k, v)):
            fail("kernels", f"{route} attention: non-finite gradient")
    torch.cuda.synchronize()
    counts = {k: n for k, n in _build.launch_counts().items() if n}
    emit({"phase": "kernels", "path": f"attention(impl='flash'), {route}, unmasked and masked",
          "launches": counts})
    return counts


def _route_rows(gen) -> list[dict]:  # noqa: ANN001
    """Timed rows of the flash kernels that the package's rule picks on each
    of ``ROUTES``, unmasked and masked by packed documents: each kernel's
    output first held to its plain version (f32 at ``F32_TOL``, bf16 at
    ``BF16_TOL``), its name read from the launch it counted; beside it the
    plain version, SDPA (``enable_gqa``, the same dtype and inputs; the
    backend its dispatcher picks) and the bound (f32: three TF32 passes,
    ``F32_PASSES``). Launches from :func:`_route_launches`."""
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.ops import fused

    rows, seconds = [], {}
    for route, attn, dtype_name in ROUTES:
        t0 = time.monotonic()
        dtype = getattr(torch, dtype_name)
        tols = F32_TOL if dtype == torch.float32 else BF16_TOL
        masks = packed_segment_ids(attn["b"], attn["s"], SEG["max_len"], SEG["seed"])
        launches = _route_launches(route, attn, dtype, masks)
        q, k, v, do = _attn_inputs(*attn.values(), dtype, gen)
        for seg in (None, masks):
            o_p, lse_p = fused._flash_fwd_plain(q, k, v, True, seg)
            args = (q, k, v, do, lse_p, fused._flash_delta(do, o_p), True)
            want = {"flash_fwd": (o_p, lse_p), "flash_dq": (fused._flash_dq_plain(*args, seg),),
                    "flash_dkv": fused._flash_dkv_plain(*args, seg)}
            calls = {
                "flash_fwd": (lambda seg=seg: fused._flash_fwd(q, k, v, True, seg),
                              lambda seg=seg: fused._flash_fwd_plain(q, k, v, True, seg)),
                "flash_dq": (lambda seg=seg, a=args: (fused._flash_dq(*a, seg),),
                             lambda seg=seg, a=args: fused._flash_dq_plain(*a, seg)),
                "flash_dkv": (lambda seg=seg, a=args: fused._flash_dkv(*a, seg),
                              lambda seg=seg, a=args: fused._flash_dkv_plain(*a, seg)),
            }
            mask = None
            if seg is not None:
                same = seg[:, :, None] == seg[:, None, :]
                mask = (same & torch.ones_like(same).tril())[:, None]
            sdpa_fwd, sdpa_bwd = _sdpa_calls(q, k, v, do, mask)
            backend = _sdpa_backend(q, k, v, mask)
            masked = "" if seg is None else " with the boolean block-diagonal causal attn_mask"
            bounds = _bounds(dtype_bytes=torch.finfo(dtype).bits // 8, attn=attn,
                             pairs_per_head=None if seg is None else kept_pairs(seg, True))
            for fn, (kern, plain) in calls.items():
                _build.reset_launches()
                got = kern()
                torch.cuda.synchronize()
                launched = [n for n, c in _build.launch_counts().items() if c]
                if len(launched) != 1:
                    fail("kernels", f"{fn} {route}: launched {launched}, want one kernel")
                base = launched[0]
                if not launches.get(base):
                    fail("kernels", f"{base} {route}: the route's attention never launched it")
                rel = max(rel_err(a, b) for a, b in zip(got, want[fn]))
                err = max(max_err(a, b) for a, b in zip(got, want[fn]))
                emit({"phase": "kernels", "check": f"{base}_{route}", "dtype": dtype_name,
                      "shape": list(attn.values()), "causal": True, "err": rel,
                      "tol": tols[fn]})
                if not rel <= tols[fn]:
                    fail("kernels", f"{base} {route}: err {rel} > {tols[fn]}")
                del got
                lib, call = ((sdpa_fwd, f"F.scaled_dot_product_attention(enable_gqa=True)"
                                        f"{masked}, forward")
                             if fn == "flash_fwd" else
                             (sdpa_bwd, f"SDPA{masked} backward: dq, dk and dv in one call"))
                bound_ms, bound_by, flops, nbytes = bounds[fn]
                ms = time_ms(kern, iters=5, warmup=1)
                library_ms = time_ms(lib, iters=5, warmup=1)
                share, share_of = LIBRARY_SHARE.get(fn, (None, None))
                rows.append({
                    "name": f"{base}_{route}", "route": "cuda",
                    "source": KERNEL_INFO[base.removesuffix("_seg")][1],
                    "replaces": SPLASH if seg is not None else KERNEL_INFO[
                        base.removesuffix("_seg")][2],
                    "launches": launches.get(base, 0),
                    "launches_from": f"attention(impl='flash') fwd + bwd, {route},"
                                     " unmasked and masked",
                    "dtype": dtype_name, "shape": attn, "masked": seg is not None,
                    "max_abs_err": err, "rel_err": rel, "tol": tols[fn],
                    "f32_rel_err": rel if dtype == torch.float32 else None,
                    "f32_tol": tols[fn] if dtype == torch.float32 else None,
                    "ms": ms, "plain_ms": time_ms(plain, iters=2, warmup=0),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_basis": ("operations over 989 TFLOP/s (bf16)" if dtype_name == "bfloat16"
                                    else f"{F32_PASSES} x operations over 495 TFLOP/s (TF32)")
                                   + ", bytes over 3.35 TB/s",
                    "library_ms": library_ms, "library_call": call,
                    "library_backend": backend,
                    "library_share_ms": share and share * library_ms, "library_share": share_of,
                    "flops": flops, "bytes": nbytes, "roofline_share": bound_ms / ms,
                })
            del o_p, lse_p, args, want, calls, sdpa_fwd, sdpa_bwd, mask
        del q, k, v, do
        seconds[route] = time.monotonic() - t0
    free_card()
    emit({"phase": "kernels", "routes_seconds": seconds})
    return rows


def phase_routes() -> None:
    """``--phases build,routes``: :func:`_route_rows` alone, one line a row."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for row in _route_rows(gen):
        emit({"phase": "routes", **row})


def phase_int8_f32_rows() -> None:
    """``--phases build,int8f32``: the f32-activation rows of
    :func:`_int8_rows` alone, one line a row (under ``--package-root``, a
    parent tree's kernel on the same shapes)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    for row in _int8_rows(gen, f32_only=True):
        emit({"phase": "int8f32", **row})


#: The mma dq's candidate tiles by group (``csrc/flash_dq_mma.cuh``
#: ``TPX_FLASH_DQ_MMA_GRID_<n>``) and the shape each group is timed at,
#: causal: llama3_1b's attention (f32 at head_dim 64), Mixtral's (f32 at
#: 128), Gemma-2-2B's (f32 and bf16 at 256).
DQ_GRID = {1: ("f32_hd64", ATTN, "float32"), 2: ("f32_hd128", ATTN_MOE, "float32"),
           3: ("f32_hd256", ATTN_D256, "float32"), 4: ("bf16_hd256", ATTN_D256, "bfloat16")}


def phase_dq_grid() -> None:
    """``--phases build,dqgrid``: the source of the mma dq's tiles
    (``ops.fused.MMA_TILES``). Each group of ``DQ_GRID`` built apart
    (``flash_dq_mma.cu`` with ``TPX_FLASH_DQ_MMA_GRID``, one nvcc each, side
    by side) with ptxas's registers and spills by candidate, masked and
    not; each candidate whose two instances spill nothing held to the plain
    dq at its group's shape (unmasked, at ``F32_TOL`` / ``BF16_TOL``), then
    timed; a line a group with the fastest beside the compiled tile."""
    import ctypes

    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.ops import fused

    torch.backends.cuda.matmul.allow_tf32 = False
    src = _build.CSRC_DIR / "flash_dq_mma.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sos = {g: _build.BUILD_DIR / f"dq_grid_{g}.{os.getpid()}.so" for g in DQ_GRID}
    log, seconds = _build._run([
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-DTPX_FLASH_DQ_MMA_GRID={g}",
         "-I", str(_build.CSRC_DIR), "-o", str(so), str(src)] for g, so in sos.items()])
    ptxas = ptxas_summary(log)
    emit({"phase": "dqgrid", "nvcc_seconds": dict(zip(DQ_GRID, seconds)), "ptxas": ptxas})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for group, (route, attn, dtype_name) in DQ_GRID.items():
        lib = ctypes.CDLL(str(sos[group]))
        lib.tpx_flash_dq_mma_grid.argtypes = [i] + [p] * 7 + [i] * 5 + [p]
        lib.tpx_flash_dq_mma_grid.restype = i
        lib.tpx_flash_dq_mma_grid_size.argtypes, lib.tpx_flash_dq_mma_grid_size.restype = [], i
        lib.tpx_flash_dq_mma_grid_tile.argtypes = [i, ctypes.POINTER(i)]
        lib.tpx_flash_dq_mma_grid_tile.restype = i
        dtype = getattr(torch, dtype_name)
        b, s, h, kvh, d = attn.values()
        q, k, v, do = _attn_inputs(b, s, h, kvh, d, dtype, gen)
        o, lse = fused._flash_fwd_plain(q, k, v, True)
        args = (q, k, v, do, lse, fused._flash_delta(do, o), True)
        want = fused._flash_dq_plain(*args)
        tol = (F32_TOL if dtype == torch.float32 else BF16_TOL)["flash_dq"]
        dq = torch.empty(q.shape, dtype=torch.float32, device="cuda")
        ptrs = [t.data_ptr() for t in (*args[:6], dq)]
        times = {}
        for idx in range(lib.tpx_flash_dq_mma_grid_size()):
            tile = (i * 5)()
            if lib.tpx_flash_dq_mma_grid_tile(idx, tile):
                fail("dqgrid", f"group {group}: no candidate {idx}")
            dt, dd, bq, bk, dsplit = tile
            name = f"flash_dq_mma_kernel<{'f32' if dt == 0 else 'bf16'},{dd},{bq},{bk},{dsplit}>"
            line = {"phase": "dqgrid", "route": route, "tile": [bq, bk], "dsplit": dsplit,
                    "ptxas": ptxas.get(name), "ptxas_seg": ptxas.get(name[:-1] + ",seg>")}
            if re.search(r"[1-9]\d* bytes spill", f"{line['ptxas']} {line['ptxas_seg']}"):
                emit({**line, "spills": True})
                continue

            def call(idx=idx, name=name):  # noqa: ANN001, ANN202
                rc = lib.tpx_flash_dq_mma_grid(idx, *ptrs, b, s, h, kvh, 1, stream)
                if rc:
                    fail("dqgrid", f"{name}: launch failed ({rc})")

            dq.zero_()
            call()
            torch.cuda.synchronize()
            err = rel_err(dq, want)
            if not err <= tol:
                fail("dqgrid", f"{name} at {route}: err {err} > {tol}")
            times[(bq, bk, dsplit)] = time_ms(call, iters=5, warmup=1)
            emit({**line, "spills": False, "err": err, "tol": tol, "ms": times[(bq, bk, dsplit)]})
        best = min(times, key=times.get)
        emit({"phase": "dqgrid", "route": route, "fastest": list(best), "fastest_ms": times[best],
              "compiled": list(fused.MMA_TILES[("flash_dq", dtype, d)]),
              "ms_by_tile": {f"{bq}/{bk}/{ds}": ms for (bq, bk, ds), ms in times.items()}})
        del q, k, v, do, o, lse, args, want, dq
        free_card()
    for so in sos.values():
        so.unlink()


def phase_specs(card: str) -> None:
    """The launcher's specs layer on the card: ``named_resources["h100-1"]``
    is one H100 whose memory, as the generation table gives it, is the
    card's own ``total_memory``."""
    import torch

    from torchx_tpu_torch.specs import named_resources

    res = named_resources["h100-1"]
    name = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory
    emit({"phase": "specs", "resource": "h100-1", "accelerator_type": res.gpu.accelerator_type,
          "hosts": res.gpu.hosts, "devices": res.devices, "cpu": res.cpu, "memMB": res.memMB,
          "hbm_bytes_per_gpu": res.gpu.hbm_bytes_per_gpu, "total_memory": total,
          "device_name": name, "card": card})
    if "H100" not in name:
        fail("specs", f"the card is {name!r}, not an H100")
    if res.gpu.hbm_bytes_per_gpu != total:
        fail("specs", f"hbm_bytes_per_gpu {res.gpu.hbm_bytes_per_gpu} != the card's"
             f" total_memory {total}")


def phase_kernels() -> list[dict]:
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.ops import fused, norms

    # f32 comparisons are exact f32: no TF32 in the plain versions' matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    f32_err: dict[str, float] = {}
    for case in F32_ATTN_CASES:
        for name, (rel, _) in _flash_case(
            *case, torch.float32, gen, (None,)
        ).items():
            tol = F32_TOL[family(name)]
            emit({"phase": "kernels", "check": name, "dtype": "float32",
                  "shape": list(case), "err": rel, "tol": tol})
            if not rel <= tol:
                fail("kernels", f"{name} f32 {case}: err {rel} > {tol}")
            f32_err[name] = max(f32_err.get(name, 0.0), rel)
    for name, (rel, _) in _norm_case(32, 128, torch.float32, gen).items():
        if not rel <= F32_TOL[name]:
            fail("kernels", f"{name} f32: err {rel} > {F32_TOL[name]}")
        f32_err[name] = rel
    torch.cuda.synchronize()

    # bf16: the wgmma kernels at the main-path shapes, at the other shapes
    # they take and at Mixtral's, the norms at both widths; the mma kernels
    # at head_dim 256
    bf16 = {**_flash_case(*ATTN.values(), True, torch.bfloat16, gen, ("wgmma",)),
            **_norm_case(NORM["n"], NORM["d"], torch.bfloat16, gen)}
    bf16_moe = {**{f"{k}_d128": e for k, e in _flash_case(
                    *ATTN_MOE.values(), True, torch.bfloat16, gen, ("wgmma",)).items()},
                **{f"{k}_d4096": e for k, e in _norm_case(
                    NORM_MOE["n"], NORM_MOE["d"], torch.bfloat16, gen).items()}}
    bf16_tp = {**{f"{k}_tp2": e for k, e in _flash_case(
                   *ATTN_TP.values(), True, torch.bfloat16, gen, ("wgmma",)).items()},
               **{f"{k}_sp2": e for k, e in _norm_case(
                   NORM_SP["n"], NORM_SP["d"], torch.bfloat16, gen).items()}}
    checks = [("main", name, rel)
              for name, (rel, _) in {**bf16, **bf16_moe, **bf16_tp}.items()]
    for case in BF16_WGMMA_CASES:
        checks += [(case, name, rel) for name, (rel, _) in _flash_case(
            *case, torch.bfloat16, gen, ("wgmma",)).items()]
    for case in BF16_D256_CASES:
        checks += [(case, name, rel) for name, (rel, _) in _flash_case(
            *case, torch.bfloat16, gen, (None,)).items()]
    for case, name, rel in checks:
        tol = BF16_TOL[family(name)]
        if case != "main":
            emit({"phase": "kernels", "check": name, "dtype": "bfloat16",
                  "shape": list(case), "err": rel, "tol": tol})
        if not rel <= tol:
            fail("kernels", f"{name} bf16 {case}: err {rel} > {tol}")

    _other_tile_checks(gen)

    # segment ids (packed documents), then the masked path's launches
    seg = packed_segment_ids(ATTN["b"], ATTN["s"], SEG["max_len"], SEG["seed"])
    f32_err.update(_segment_checks(gen, seg))
    seg_launches = _packed_attention_launches(seg)

    # the wgmma and mma backward kernels and the norm backward's dw own
    # their sums (no atomics): two calls must agree bitwise
    def backward_args(attn, dtype):  # noqa: ANN001, ANN202
        q, k, v, do = _attn_inputs(*attn.values(), dtype, gen)
        o, lse = fused._flash_fwd(q, k, v, True)
        return q, k, v, do, lse, fused._flash_delta(do, o), True

    args = backward_args(ATTN, torch.bfloat16)
    f32_args = backward_args(ATTN, torch.float32)
    d256_args = backward_args(ATTN_D256, torch.bfloat16)
    x = torch.randn((NORM["n"], NORM["d"]), generator=gen, device="cuda").to(torch.bfloat16)
    r = torch.randn_like(x)
    w = torch.ones((NORM["d"],), device="cuda", dtype=torch.bfloat16)
    repeat = {"flash_dq_wgmma": lambda: (fused._flash_dq(*args),),
              "flash_dkv_wgmma": lambda: fused._flash_dkv(*args),
              "flash_dq_mma_f32_hd64": lambda: (fused._flash_dq(*f32_args),),
              "flash_dkv_mma_f32_hd64": lambda: fused._flash_dkv(*f32_args),
              "flash_dq_mma_bf16_hd256": lambda: (fused._flash_dq(*d256_args),),
              "flash_dkv_mma_bf16_hd256": lambda: fused._flash_dkv(*d256_args),
              "rms_norm_bwd": lambda: norms._bwd(x, r, w, EPS)}
    for name, fn in repeat.items():
        if not all(torch.equal(a, b) for a, b in zip(fn(), fn())):
            fail("kernels", f"{name}: two calls differ")
    emit({"phase": "kernels", "check": "bitwise repeatable", "kernels": list(repeat)})
    del args, f32_args, d256_args, x, r, w

    # timings: at the main-path shapes, then masked, then at Mixtral's, at
    # the tp phase's local shapes, on the routes off the wgmma kernels
    seg_errs = _flash_case(*ATTN.values(), True, torch.bfloat16, gen, ("wgmma",), seg)
    for name, val in seg_errs.items():
        if name.startswith("one_doc_row_bitwise") and not val:
            fail("kernels", f"bf16 masked {name.rsplit('_', 1)[1]}: the one-document row differs")
        if not name.startswith("one_doc") and not val[0] <= BF16_TOL[family(name)]:
            fail("kernels", f"{name} bf16 main: err {val[0]} > {BF16_TOL[family(name)]}")
    norm_errs = {**bf16, "f32_norm_res_fwd": f32_err["norm_res_fwd"],
                 "f32_rms_norm_bwd": f32_err["rms_norm_bwd"]}
    rows = _flash_rows(ATTN, ("wgmma",), "", gen, bf16)
    rows += _norm_rows(NORM, "", gen, norm_errs)
    rows += _flash_rows(ATTN, ("wgmma",), "_seg", gen, seg_errs, seg=seg)
    rows += _flash_rows(ATTN_MOE, ("wgmma",), "_d128", gen, bf16_moe)
    rows += _norm_rows(NORM_MOE, "_d4096", gen,
                       {k.removesuffix("_d4096"): e for k, e in bf16_moe.items()})
    rows += _flash_rows(ATTN_TP, ("wgmma",), "_tp2", gen, bf16_tp)
    rows += _norm_rows(NORM_SP, "_sp2", gen,
                       {k.removesuffix("_sp2"): e for k, e in bf16_tp.items()})
    rows += _route_rows(gen)
    rows += _int8_rows(gen)
    for row in rows:
        row["f32_rel_err"] = f32_err.get(row["name"], row["f32_rel_err"])
        if row["f32_rel_err"] is not None:
            row["f32_tol"] = F32_TOL[family(row["name"])]
        if row["name"].endswith("_seg"):
            row["launches"] = seg_launches[row["name"]]
            row["launches_from"] = "attention(impl='flash', segment_ids) fwd + bwd, bf16 and f32"
            if not row["launches"]:
                fail("kernels", f"{row['name']}: the masked path never launched it")
    torch.cuda.synchronize()
    _build.reset_launches()
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the trainer
# ---------------------------------------------------------------------------

TRAIN = dict(batch=4, seq=2048, steps=6)
#: bf16 tolerances of the reference check, relative: the kernels keep the
#: attention probabilities in f32 where the plain path rounds them to bf16
#: before the PV product (as the JAX plain path does), about 2**-9 per layer
#: on the loss; the gradient norm is summed in bf16 as optax sums it, three
#: significant digits.
REF_LOSS_RTOL = 1e-2
REF_GRAD_NORM_RTOL = 5e-2


def expected_launches(cfg, steps: int) -> dict[str, int]:  # noqa: ANN001
    """Each kernel's launches over ``steps`` training steps of ``cfg`` in
    bf16 at head_dim 64 or 128 (``flash_variant`` picks the wgmma kernels):
    remat recomputes each layer's forward in the backward; no mma and no
    masked launch (the trainer passes no segment ids)."""
    from torchx_tpu_torch import _build

    fwd = cfg.n_layers * (1 + int(cfg.remat)) * steps
    bwd = cfg.n_layers * steps
    return {**dict.fromkeys(_build.KERNELS, 0),
            "flash_fwd_wgmma": fwd, "norm_res_fwd": fwd, "flash_dq_wgmma": bwd,
            "flash_dkv_wgmma": bwd, "rms_norm_bwd": bwd}


def phase_train() -> tuple[dict, dict, dict]:
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama

    cfg = llama.llama3_1b()
    torch.cuda.empty_cache()
    _build.reset_launches()
    out = train(cfg, TRAIN["batch"], TRAIN["seq"], TRAIN["steps"],
                kernels="cuda", device="cuda", warmup=1, log_every=1)
    counts = _build.launch_counts()
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail("train", f"non-finite loss: {losses}")
    expected = expected_launches(cfg, TRAIN["steps"])
    emit({"phase": "train", "config": "llama3_1b", "n_layers": cfg.n_layers,
          "dim": cfg.dim, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "vocab": cfg.vocab_size, "tied": cfg.tie_embeddings, **TRAIN,
          "losses": losses, "grad_norms": out["grad_norms"],
          "step_times_s": out["step_times_s"], "step_time_s": out["step_time_s"],
          "tokens_per_sec": out["tokens_per_sec"], "mfu": out["mfu"],
          "peak_memory_bytes": out["peak_memory_bytes"],
          "launches": counts, "expected_launches": expected})
    if counts != expected:
        fail("train", f"launch counts {counts} != expected {expected}")
    phase_train_tile(cfg, losses[0])
    return counts, expected, out


#: The train phase's step at another tile than the preset's (64/64).
OTHER_TILE = dict(attn_block_q=128, attn_block_kv=128)


def phase_train_tile(cfg, first_loss: float) -> None:  # noqa: ANN001
    """One step of the train phase's run with ``OTHER_TILE`` in place of the
    preset's tiles: the same weights and batch, so its loss is the run's
    first within the bf16 step tolerance (``REF_LOSS_RTOL``), and the same
    kernels launch as often."""
    import dataclasses

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.examples.train_llama import train

    other = dataclasses.replace(cfg, **OTHER_TILE)
    free_card()
    _build.reset_launches()
    out = train(other, TRAIN["batch"], TRAIN["seq"], 1, kernels="cuda", device="cuda",
                warmup=1, log_every=0)
    counts = _build.launch_counts()
    rel = abs(out["losses"][0] - first_loss) / abs(first_loss)
    emit({"phase": "train", "run": "other tile", **OTHER_TILE,
          "preset": [cfg.attn_block_q, cfg.attn_block_kv], "loss": out["losses"][0],
          "preset_loss": first_loss, "rel": rel, "tol": REF_LOSS_RTOL,
          "launches": {k: n for k, n in counts.items() if n}})
    if not (math.isfinite(out["losses"][0]) and rel <= REF_LOSS_RTOL):
        fail("train", f"the step at {OTHER_TILE}: loss {out['losses'][0]} vs {first_loss}")
    if counts != expected_launches(cfg, 1):
        fail("train", f"the step at {OTHER_TILE}: launches {counts}")


#: A profiled step's measured phases may miss its wall time by this share
#: (the loop's own bookkeeping between the phases is not attributed).
PHASE_SUM_RTOL = 0.05


class _ObsDir:
    """``$TPX_OBS_DIR`` set to ``path`` inside the block, restored after:
    the profiled runs' journals and textfiles land in a scratch dir."""

    def __init__(self, path: str) -> None:
        self.path = path

    def __enter__(self) -> None:
        self.saved = os.environ.get("TPX_OBS_DIR")
        os.environ["TPX_OBS_DIR"] = self.path

    def __exit__(self, *exc: object) -> None:
        if self.saved is None:
            os.environ.pop("TPX_OBS_DIR", None)
        else:
            os.environ["TPX_OBS_DIR"] = self.saved


def phase_train_profiled(unprofiled: dict, counts: dict) -> dict:
    """The train phase's run again with the step profiler and a
    torch.profiler trace (``profile=True, profile_dir=...``): one
    ``profile.jsonl`` record per timed step, phases summing to within
    ``PHASE_SUM_RTOL`` of each step's wall time, the launches of the
    unprofiled run, the metrics textfile holding ``tpx_step_seconds``;
    the profiled step time against the unprofiled one."""
    import shutil
    import tempfile

    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.obs import profile, sinks

    cfg = llama.llama3_1b()
    root = tempfile.mkdtemp(prefix="tpx_profile_smoke_")
    try:
        with _ObsDir(os.path.join(root, "obs")):
            torch.cuda.empty_cache()
            _build.reset_launches()
            out = train(cfg, TRAIN["batch"], TRAIN["seq"], TRAIN["steps"], kernels="cuda",
                        device="cuda", warmup=1, log_every=1, profile=True,
                        profile_dir=os.path.join(root, "trace"))
            launches = _build.launch_counts()
            recs = [r for r in profile.load_profile(sinks.session_dir())
                    if r["kind"] == "step"]
            prom = open(sinks.metrics_path()).read()
            trace_bytes = os.path.getsize(out["profile_trace"])
            with open(out["profile_trace"]) as f:
                busy = device_busy(json.load(f)["traceEvents"], TRAIN["steps"] - 1)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gaps = [abs(sum(r["phases"].values()) - r["wall_s"]) / r["wall_s"] for r in recs]
    res = {
        "phase": "train", "run": "profiled", "steps": TRAIN["steps"],
        "records": len(recs), "steps_profiled": [r["step"] for r in recs],
        "wall_s": [r["wall_s"] for r in recs],
        "phases_s": [r["phases"] for r in recs],
        "phase_sum_max_rel_gap": max(gaps, default=None), "phase_sum_rtol": PHASE_SUM_RTOL,
        "data_wait_s": [r["phases"]["data_wait"] for r in recs],
        "step_time_s": out["step_time_s"], "unprofiled_step_time_s": unprofiled["step_time_s"],
        "profiled_overhead": out["step_time_s"] / unprofiled["step_time_s"] - 1,
        "summary": {k: out["profile"][k] for k in
                    ("step_s", "mfu", "data_wait_frac", "phase_fracs")},
        "trace_bytes": trace_bytes, **busy,
        "prom_has_step_seconds": "tpx_step_seconds_bucket" in prom,
        "launches": launches, "launches_equal_unprofiled": launches == counts,
        "losses": out["losses"],
    }
    emit(res)
    if len(recs) != TRAIN["steps"] - 1:
        fail("train", f"{len(recs)} profile records for {TRAIN['steps'] - 1} timed steps")
    if max(gaps) > PHASE_SUM_RTOL:
        fail("train", f"profiled phases miss a step's wall time by {max(gaps):.3f}")
    if launches != counts:
        fail("train", f"profiled launches {launches} != the unprofiled run's {counts}")
    if not res["prom_has_step_seconds"] or not trace_bytes:
        fail("train", "no tpx_step_seconds in the metrics textfile, or an empty trace")
    if not all(math.isfinite(x) for x in out["losses"]):
        fail("train", f"non-finite profiled loss: {out['losses']}")
    return res


def phase_reference() -> None:
    import dataclasses

    import torch

    from torchx_tpu_torch.examples.train_llama import (
        make_optimizer, make_train_step, synthetic_batch,
    )
    from torchx_tpu_torch.models import llama

    res = {}
    for kernels, attn_impl in (("cuda", "auto"), ("reference", "xla")):
        # the reference run takes the plain attention ("xla") too: under
        # "auto" a CUDA tensor would reach the flash kernels
        cfg = dataclasses.replace(
            llama.llama3_1b(n_layers=2), max_seq=TRAIN["seq"], kernels=kernels,
            attn_impl=attn_impl,
        )
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda")
        step = make_train_step(cfg, make_optimizer(llama.leaves(params)))
        batch = synthetic_batch(cfg, TRAIN["batch"], TRAIN["seq"], device="cuda")
        out = step(params, batch)
        res[kernels] = {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"])}
        del params, step, out
    k, r = res["cuda"], res["reference"]
    loss_rel = abs(k["loss"] - r["loss"]) / abs(r["loss"])
    gn_rel = abs(k["grad_norm"] - r["grad_norm"]) / abs(r["grad_norm"])
    emit({"phase": "reference", "n_layers": 2, "cuda": k, "reference": r,
          "loss_rel_diff": loss_rel, "loss_rtol": REF_LOSS_RTOL,
          "grad_norm_rel_diff": gn_rel, "grad_norm_rtol": REF_GRAD_NORM_RTOL})
    if not (math.isfinite(k["loss"]) and loss_rel <= REF_LOSS_RTOL
            and gn_rel <= REF_GRAD_NORM_RTOL):
        fail("reference", f"kernels {k} vs reference {r}")



# ---------------------------------------------------------------------------
# the remat policies and the memory fit
# ---------------------------------------------------------------------------

#: The remat phase: each policy's run on the train phase's setting
#: (``steps`` steps), and ``--remat-policy auto`` at ``auto_batch`` rows,
#: where the fit table refuses ``dots_attn`` and ``dots`` on one H100 80GB
#: and names ``full``; ``oom_policy`` at that batch is the rematoom phase's
#: run out of memory.
REMAT = dict(steps=3, auto_batch=28, auto_steps=2, oom_policy="dots")
#: The fit probe's peak against the measured ``max_memory_allocated``: what
#: it does not model is the allocator's slack and cuBLAS's workspace.
REMAT_PEAK_RTOL = 0.10
#: Flash forward launches a layer a step, by policy: the recompute runs it
#: again under ``full`` and ``dots``.
REMAT_FLASH_FWD = {"full": 2, "dots": 2, "dots_attn": 1, "off": 1}


def _remat_cfg(policy: str):  # noqa: ANN202
    import dataclasses

    from torchx_tpu_torch.models import llama

    base = dataclasses.replace(llama.llama3_1b(), kernels="cuda")
    if policy == "off":
        return dataclasses.replace(base, remat=False)
    return dataclasses.replace(base, remat=True, remat_policy=policy)


def _fit_estimates(cfg, batch: int, seq: int, total: int) -> dict:  # noqa: ANN001
    """The fit probe's traced rank-0 step and the analytic ``hbm_fit`` of
    ``cfg`` on one card of ``total`` bytes (the reference has no reckoning
    for remat off: None there)."""
    from torchx_tpu_torch.analyze import costmodel
    from torchx_tpu_torch.parallel import aot_fit

    r = aot_fit.trace_fit(cfg, None, batch, seq, hbm_bytes=total)
    analytic = None
    if cfg.remat:
        plan = costmodel.ParallelPlan(
            model=costmodel.ModelShape.of(cfg), sizes={}, batch=batch, seq=seq,
            remat_policy=cfg.remat_policy, hbm_bytes_per_chip=total, hbm_source="device")
        analytic = costmodel.hbm_fit(plan).total_bytes
    return {"probe_args_bytes": r.args_bytes, "probe_temp_bytes": r.temp_bytes,
            "probe_peak_bytes": r.peak_bytes, "probe_fits": r.fits,
            "hbm_fit_total_bytes": analytic}


def _profiled_busy(cfg, batch: int, seq: int, steps: int) -> dict:  # noqa: ANN001
    """The device's busy milliseconds a step and idle share over the timed
    steps of a run of ``cfg`` with the trainer's torch.profiler trace."""
    import shutil
    import tempfile

    from torchx_tpu_torch.examples.train_llama import train

    root = tempfile.mkdtemp(prefix="tpx_remat_smoke_")
    try:
        out = train(cfg, batch, seq, steps, kernels="cuda", device="cuda", warmup=1,
                    log_every=0, profile_dir=root)
        with open(out["profile_trace"]) as f:
            return device_busy(json.load(f)["traceEvents"], steps - 1)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_remat(train_out: dict, train_profiled: dict) -> dict:
    """llama3_1b (16 layers, batch 4, seq 2048, bf16, the kernels) under
    each remat policy: the train phase's run is ``full``; ``dots``,
    ``dots_attn`` and remat off run ``REMAT["steps"]`` steps each. Per
    policy: step time, tokens/s, MFU, the device's busy time a step and
    idle share (a second run with a torch.profiler trace; ``full``'s from
    the train phase's profiled run), ``max_memory_allocated`` beside the
    fit probe's peak (within ``REMAT_PEAK_RTOL``) and ``hbm_fit``'s total,
    the flash forward's launches a step (``REMAT_FLASH_FWD``), and the
    losses against ``full``'s (bitwise where the train phase's two runs
    were, else within GANG_LOSS_RTOL). Then ``--remat-policy auto`` at
    ``REMAT["auto_batch"]`` rows: the fit table of the three candidates on
    this card, the trainer's resolution (the policy the table names), its
    steps, and its peak under the budget (``DEFAULT_HEADROOM`` of the
    card)."""
    import dataclasses

    import torch

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.parallel import aot_fit, remat_auto

    t0 = time.monotonic()
    total = torch.cuda.get_device_properties(0).total_memory
    emit({"phase": "remat", "run": "card", "total_memory": total,
          "default_bytes": aot_fit.H100_HBM_BYTES, "card": card_line()})
    b, s, steps = TRAIN["batch"], TRAIN["seq"], REMAT["steps"]
    bitwise = train_out["losses"] == train_profiled["losses"]
    rows = {}
    for policy in ("full", "dots", "dots_attn", "off"):
        cfg = _remat_cfg(policy)
        if policy == "full":
            out, busy = train_out, {k: train_profiled[k] for k in
                                    ("device_busy_ms_per_step", "device_idle_share")}
        else:
            free_card()
            out = train(cfg, b, s, steps, kernels="cuda", device="cuda", warmup=1, log_every=0)
            busy = _profiled_busy(cfg, b, s, steps)
        per_step = out["launches_per_step"]
        row = {"phase": "remat", "policy": policy, "remat_policy": out["remat_policy"],
               "steps": len(out["losses"]), "losses": out["losses"],
               "step_time_s": out["step_time_s"], "tokens_per_sec": out["tokens_per_sec"],
               "mfu": out["mfu"], "peak_memory_bytes": out["peak_memory_bytes"],
               **_fit_estimates(cfg, b, s, total), "profiled": busy,
               "flash_fwd_per_step": per_step["flash_fwd_wgmma"],
               "norm_res_fwd_per_step": per_step["norm_res_fwd"],
               "flash_bwd_per_step": [per_step["flash_dq_wgmma"], per_step["flash_dkv_wgmma"]]}
        row["probe_peak_rel_gap"] = (row["probe_peak_bytes"] / row["peak_memory_bytes"]) - 1
        want = full_losses = train_out["losses"][:len(out["losses"])]
        row["losses_bitwise_full"] = out["losses"] == full_losses
        row["loss_max_rel_diff_vs_full"] = _rel_diff(out["losses"], want)
        emit(row)
        rows[policy] = row
        n = cfg.n_layers
        if per_step["flash_fwd_wgmma"] != REMAT_FLASH_FWD[policy] * n:
            fail("remat", f"{policy}: {per_step['flash_fwd_wgmma']} flash forward launches a"
                 f" step, want {REMAT_FLASH_FWD[policy] * n}")
        if (per_step["flash_dq_wgmma"], per_step["flash_dkv_wgmma"],
                per_step["rms_norm_bwd"]) != (n, n, n):
            fail("remat", f"{policy}: backward launches {per_step}")
        if out["remat_policy"] != ("none" if policy == "off" else policy):
            fail("remat", f"{policy}: the trainer ran {out['remat_policy']}")
        if (not row["losses_bitwise_full"]) if bitwise else \
                row["loss_max_rel_diff_vs_full"] > GANG_LOSS_RTOL:
            fail("remat", f"{policy}: losses {out['losses']} against full's {full_losses}")
        if abs(row["probe_peak_rel_gap"]) > REMAT_PEAK_RTOL:
            fail("remat", f"{policy}: the probe's peak {row['probe_peak_bytes']} against the"
                 f" measured {row['peak_memory_bytes']}")
    # --remat-policy auto where the table refuses the first candidates
    ab = REMAT["auto_batch"]
    table = {p: _fit_estimates(_remat_cfg(p), ab, s, total) for p in remat_auto.POLICY_ORDER}
    named = next((p for p in remat_auto.POLICY_ORDER if table[p]["probe_fits"]), "full")
    emit({"phase": "remat", "run": "fit table", "batch": ab, "seq": s, "table": table,
          "budget_bytes": int(total * aot_fit.DEFAULT_HEADROOM), "names": named})
    if named == remat_auto.POLICY_ORDER[0]:
        fail("remat", f"batch {ab}: the table accepts {named}, so auto selects nothing")
    free_card()
    out = train(dataclasses.replace(_remat_cfg("full"), remat_policy="auto"), ab, s,
                REMAT["auto_steps"], kernels="cuda", device="cuda", warmup=1, log_every=1)
    res = {"phase": "remat", "run": "auto", "batch": ab, "seq": s,
           "remat_policy": out["remat_policy"], "remat_trials": out["remat_trials"],
           "remat_select_s": out["launch_breakdown"]["remat_select"],
           "losses": out["losses"], "step_time_s": out["step_time_s"],
           "tokens_per_sec": out["tokens_per_sec"], "mfu": out["mfu"],
           "peak_memory_bytes": out["peak_memory_bytes"],
           "budget_bytes": int(total * aot_fit.DEFAULT_HEADROOM),
           "probe_peak_bytes": table[named]["probe_peak_bytes"]}
    emit(res)
    if out["remat_policy"] != named:
        fail("remat", f"auto resolved to {out['remat_policy']}, the table names {named}")
    if not all(math.isfinite(x) for x in out["losses"]):
        fail("remat", f"auto: non-finite loss {out['losses']}")
    if out["peak_memory_bytes"] > res["budget_bytes"]:
        fail("remat", f"auto: peak {out['peak_memory_bytes']} above the budget")
    emit({"phase": "remat", "run": "seconds", "seconds": time.monotonic() - t0})
    return rows


def phase_remat_oom() -> None:
    """The policy the auto case's table refuses (``REMAT["oom_policy"]`` at
    ``REMAT["auto_batch"]`` rows) run anyway, in a subprocess: it must run
    out of the card's memory, as the probe says (its peak beside)."""
    import subprocess

    import torch

    total = torch.cuda.get_device_properties(0).total_memory
    policy, ab = REMAT["oom_policy"], REMAT["auto_batch"]
    est = _fit_estimates(_remat_cfg(policy), ab, TRAIN["seq"], total)
    free_card()
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torchx_tpu_torch.examples.train_llama", "--config",
         "llama3_1b", "--batch", str(ab), "--seq", str(TRAIN["seq"]), "--steps", "1",
         "--kernels", "cuda", "--remat-policy", policy],
        capture_output=True, text=True, timeout=600, check=False)
    oom = "out of memory" in proc.stderr.lower()
    emit({"phase": "rematoom", "policy": policy, "batch": ab, "rc": proc.returncode,
          "out_of_memory": oom, "seconds": time.monotonic() - t0, "total_memory": total,
          **est, "stderr_tail": proc.stderr[-400:]})
    if proc.returncode == 0 or not oom:
        fail("rematoom", f"{policy} at batch {ab}: rc {proc.returncode}, no out-of-memory error")


#: Calls timed by the hostus phase: few enough that the launches of the
#: slowest (the flash forward with its backward, ~10 launches) never fill
#: the card's launch queue while it sleeps.
HOSTUS_CALLS = 50


def phase_hostus() -> None:
    """Host microseconds a call of each kernel's entry point, the card busy
    behind a sleep kernel: the flash attention forward and forward with
    backward, the fused residual-add + RMSNorm likewise, and the RMSNorm
    with the fused backward. Run it under ``--package-root`` of another
    tree to compare two versions' wrappers in one call."""
    import torch

    from torchx_tpu_torch.ops import fused, norms

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = _attn_inputs(**ATTN, dtype=torch.bfloat16, gen=gen)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    x = torch.randn((NORM["n"], NORM["d"]), generator=gen, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    r = torch.randn_like(x)
    w = torch.ones(NORM["d"], device="cuda", dtype=torch.bfloat16, requires_grad=True)

    def flash_fwd():  # noqa: ANN202
        with torch.no_grad():
            fused.flash_attention(q, k, v, True, "cuda")

    def flash_fwd_bwd():  # noqa: ANN202
        fused.flash_attention(q, k, v, True, "cuda").backward(do)

    def norm_res_fwd():  # noqa: ANN202
        with torch.no_grad():
            fused.rms_norm_residual(x, r, w, EPS, kernels="cuda")

    def norm_res_fwd_bwd():  # noqa: ANN202
        y, s_ = fused.rms_norm_residual(x, r, w, EPS, kernels="cuda")
        torch.autograd.backward((y, s_), (r, r))

    def rms_norm_fused_fwd_bwd():  # noqa: ANN202
        norms.rms_norm(x, w, EPS, fused="cuda").backward(r)

    calls = {"flash_fwd": flash_fwd, "flash_fwd_bwd": flash_fwd_bwd,
             "norm_res_fwd": norm_res_fwd, "norm_res_fwd_bwd": norm_res_fwd_bwd,
             "rms_norm_fused_fwd_bwd": rms_norm_fused_fwd_bwd}
    root = os.path.dirname(os.path.dirname(os.path.abspath(fused.__file__)))
    emit({"phase": "hostus", "package": root, "calls": HOSTUS_CALLS,
          "host_us": {name: host_us(fn, HOSTUS_CALLS) for name, fn in calls.items()}})


# ---------------------------------------------------------------------------
# the gang: the trainer launched through spmd_main
# ---------------------------------------------------------------------------

#: The gang phase: A, the train phase's run through ``spmd_main`` (one
#: worker a card, NCCL, ``--mesh fsdp=-1``, 32 MiB gradient buckets,
#: profiled as the train phase's profiled run is); B, two or four ranks at
#: 2 layers against one process on the same global batch (3 steps).
GANG = dict(bucket_mb=32, timeout_s=420, b_layers=2, b_steps=3, remat_policy="dots")
#: A's losses against the train phase's where that phase's runs were not
#: bitwise repeatable (the ckpt phase's rule).
GANG_LOSS_RTOL = 1e-3


def _spmd(args: list[str], target: list[str], env: dict, phase: str,
          timeout_s: float | None = None) -> tuple[dict, str]:
    """``python -m torchx_tpu_torch.apps.spmd_main ARGS TARGET`` as one
    replica of a gang (``TPX_REPLICA_ID`` 0 of 1 on 127.0.0.1), in a session
    of its own that is killed past ``timeout_s`` (default
    ``GANG["timeout_s"]``). -> (rank 0's final summary, the output)."""
    import signal

    full = dict(os.environ, PYTHONPATH=REPO, TPX_REPLICA_ID="0", TPX_NUM_REPLICAS="1",
                TPX_COORDINATOR_HOST="127.0.0.1", **env)
    cmd = [sys.executable, "-m", "torchx_tpu_torch.apps.spmd_main", "--port", "0",
           "--timeout", "120", *args, *target]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=full, cwd=REPO, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s or GANG["timeout_s"])
    except subprocess.TimeoutExpired:
        out = ""
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait()
    if proc.returncode != 0 or "final:" not in out:
        fail(phase, f"spmd_main exit {proc.returncode}: {' '.join(cmd)}\n{out[-4000:]}")
    return json.loads(out.split("final:", 1)[1].splitlines()[0]), out


def gang_bytes(cfg) -> dict[str, int]:  # noqa: ANN001
    """Bytes a step's fsdp collectives move at any world (the whole
    tensors gathered and reduce-scattered): each layer's matrices gathered
    in the forward and again in the remat recompute, the embedding (and an
    untied head) once; every sharded gradient reduce-scattered once; the
    norms' gradients all-reduced."""
    b = torch_itemsize(cfg.dtype)
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    layer = d * cfg.n_heads * hd * 2 + 2 * d * cfg.n_kv_heads * hd + 3 * d * f
    top = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    gathers = (cfg.n_layers * (1 + int(cfg.remat)) * layer + top) * b
    return {"gathers": gathers, "reduce_scatter": (cfg.n_layers * layer + top) * b,
            "norms_all_reduce": (2 * cfg.n_layers * d + d) * b}


def torch_itemsize(dtype) -> int:  # noqa: ANN001
    import torch

    return torch.empty((), dtype=dtype).element_size()


def collective_device_ms(events: list[dict]) -> dict:
    """Device time of the collectives in a torch.profiler Chrome trace, by
    collective: the GPU events (kernels and copies) launched, through the
    runtime or the driver API, from inside the CPU spans of the collectives
    (``nccl:*`` / ``c10d::*``), matched by correlation id (NCCL copies with
    a memcpy where a group has one rank), and any other GPU event whose
    name is NCCL's (``nccl*`` kernels). A kernel waiting for its peers
    counts its wait."""
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "cpu_op"
             and e.get("name", "").startswith(("nccl:", "c10d::"))]
    by_corr: dict[int, str] = {}
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or \
                "correlation" not in e.get("args", {}):
            continue
        around = [(b - a, n) for tid, a, b, n in spans if tid == e["tid"] and a <= e["ts"] <= b]
        if around:  # the outermost span's name: the collective's own op
            by_corr[e["args"]["correlation"]] = max(around)[1]
    ms: dict[str, float] = {}
    count = 0
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = by_corr.get(e.get("args", {}).get("correlation"))
        if name is None and "nccl" in e.get("name", "").lower():
            name = "nccl kernels"
        if name is not None:
            ms[name] = ms.get(name, 0.0) + e["dur"] / 1e3
            count += 1
    return {"ms": ms, "events": count}


def device_busy(events: list[dict], steps: int) -> dict:
    """Device busy time a step (the GPU events' durations) and the idle
    share of the span from the first GPU event to the last, in a trace of
    ``steps`` steps."""
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e["dur"] for e in gpu) / 1e3
    span = (max(e["ts"] + e["dur"] for e in gpu) - min(e["ts"] for e in gpu)) / 1e3
    return {"device_busy_ms_per_step": busy / steps, "span_ms_per_step": span / steps,
            "device_idle_share": 1 - busy / span}


def _daemon_spmd(cards: int, root: str, phase: str,
                 timeout_s: float | None = None) -> tuple[dict, dict]:
    """Gang A submitted as ``tpx-torch run`` submits with
    ``$TPX_CONTROL_ADDR`` set: a port ``ControlDaemon`` started on loopback
    (its state dir under ``root``, inside the job's ``$TPX_OBS_DIR``, so its
    telemetry ``Collector`` reads the job's obs session), the client found
    as the CLI finds it (``maybe_client``), ``dist.spmd`` with
    :func:`gang_a_component_args` on the local scheduler through
    ``/v1/submit`` (the daemon's dryrun passes ``$TPX_NO_LINT``: the port's
    lint gate waits for its analyzer), ``/v1/wait`` until terminal (past
    ``timeout_s``, default ``GANG["timeout_s"]``, the job is cancelled and
    the phase fails), then the daemon stopped. A daemon that does not
    start, a refused submit or a wait that does not return fails the
    phase: nothing falls back to the direct ``Runner``. -> (rank 0's final
    summary from the replica's ``stdout.log``, the launcher's record: the
    app handle, the component, final state, the replica's
    ``CUDA_VISIBLE_DEVICES``, seconds from submit to rank 0's first
    ``step`` line and to ``/v1/wait``'s terminal answer, the trainer's
    launch stages and :func:`_launch_marks`; and the daemon's: its start,
    the submit's round trip beside its handler's and the scheduler's
    seconds, the replica's exit (its ``exitcode`` sidecar) to the wait's
    return, the reconciler's terminal event, ``/v1/status`` beside
    ``Runner.status``, the local scheduler's describe calls during the
    wait, and ``tpx_step_seconds`` through ``/v1/metrics/query`` beside the
    job's own textfile)."""
    import glob
    import threading

    from torchx_tpu_torch import settings
    from torchx_tpu_torch.control.client import ControlClientError, maybe_client
    from torchx_tpu_torch.control.daemon import ControlDaemon
    from torchx_tpu_torch.control.watch import watch_interval
    from torchx_tpu_torch.obs import metrics as obs_metrics
    from torchx_tpu_torch.obs.telemetry import parse_exposition
    from torchx_tpu_torch.runner import get_runner
    from torchx_tpu_torch.schedulers.local_scheduler import EXITCODE_FILE
    from torchx_tpu_torch.specs.api import parse_app_handle

    app = gang_a_app(root, cards)
    (role,) = app.roles
    obs = os.path.join(root, "obs")
    cfg = {"log_dir": os.path.join(root, "apps")}
    names = (settings.ENV_TPX_CONTROL_ADDR, settings.ENV_TPX_CONTROL_DIR,
             settings.ENV_TPX_NO_LINT, settings.ENV_TPX_CONTROL_TOKEN)
    saved = {k: os.environ.get(k) for k in names}
    handle = daemon = status = None
    with _ObsDir(obs):  # the daemon's and the runner's traces beside the job's
        t = time.perf_counter()
        try:
            daemon = ControlDaemon(runner=get_runner("chip_smoke"),
                                   state_dir=os.path.join(root, "control"),
                                   scrape_interval=3600.0).start()
        except Exception as e:  # noqa: BLE001 - the phase's verdict
            fail(phase, f"the control daemon did not start: {type(e).__name__}: {e}")
        daemon_start_s = time.perf_counter() - t
        try:
            os.environ.pop(settings.ENV_TPX_CONTROL_TOKEN, None)
            os.environ[settings.ENV_TPX_CONTROL_ADDR] = daemon.addr
            os.environ[settings.ENV_TPX_CONTROL_DIR] = daemon.state_dir
            os.environ[settings.ENV_TPX_NO_LINT] = "1"
            client = maybe_client()  # the discovery file's token, as the CLI reads it
            sched = daemon.runner._scheduler("local")
            # the reference command: gang A's app materialized directly
            (direct,) = daemon.runner.dryrun(app, "local", cfg, no_lint=True) \
                .request.role_params[role.name]
            describes = [0]
            describe = sched.describe

            def counted(app_id: str):  # noqa: ANN202
                describes[0] += 1
                return describe(app_id)

            sched.describe = counted
            submit_s = obs_metrics.CONTROL_REQUEST_SECONDS.sum(op="submit")
            schedule_s = obs_metrics.LAUNCH_SECONDS.sum(scheduler="local")
            t0, t0_epoch = time.monotonic(), time.time()
            try:
                handle = client.submit("dist.spmd", gang_a_component_args(root, cards),
                                       "local", cfg=cfg)
            except ControlClientError as e:
                fail(phase, f"the control daemon refused gang A: {e.code} {e.message}")
            submit_rtt = time.monotonic() - t0
            submit_s = obs_metrics.CONTROL_REQUEST_SECONDS.sum(op="submit") - submit_s
            schedule_s = obs_metrics.LAUNCH_SECONDS.sum(scheduler="local") - schedule_s
            describes[0] = 0
            _, _, app_id = parse_app_handle(handle)
            (replica,) = sched._apps[app_id].request.role_params[role.name]
            if replica.args != direct.args:
                fail(phase, f"the daemon materialized {replica.args}, not gang A's"
                     f" {direct.args}")
            first: list[float] = []
            stop = threading.Event()

            def watch_first_step() -> None:
                while not stop.is_set():
                    if os.path.exists(replica.stdout):
                        with open(replica.stdout, errors="replace") as f:
                            if any(line.startswith("step ") for line in f):
                                first.append(time.monotonic() - t0)
                                return
                    stop.wait(0.05)

            watcher = threading.Thread(target=watch_first_step, daemon=True)
            watcher.start()
            try:
                status = client.wait(handle, timeout=timeout_s or GANG["timeout_s"])
            except (TimeoutError, ControlClientError) as e:
                fail(phase, f"/v1/wait did not return gang A's end: {e}")
            finally:
                stop.set()
                watcher.join(timeout=5)
            wait_epoch, done = time.time(), time.monotonic() - t0
            waited_describes = describes[0]
            # the wait returns on the terminal event, or (rarely) on its
            # 2 s status poll just before the watch stream delivers it
            event = daemon.reconciler.latest("local", app_id)
            settle = time.monotonic() + 5 * watch_interval()
            while (event is None or not event.terminal) and time.monotonic() < settle:
                time.sleep(0.02)
                event = daemon.reconciler.latest("local", app_id)
            exit_epoch = os.path.getmtime(
                os.path.join(os.path.dirname(replica.stdout), EXITCODE_FILE))
            daemon_state = client.status(handle)["state"]
            runner_state = daemon.runner.status(handle).state.name
            # the telemetry plane: one collect over the job's obs session,
            # then the job's own textfile beside /v1/metrics/query's series
            daemon.collector.collect_once()
            prom = [path for path in glob.glob(os.path.join(obs, "*", "metrics-*.prom"))
                    if os.path.basename(path) != f"metrics-{os.getpid()}.prom"
                    and "\ntpx_step_seconds_count" in open(path).read()]
            telemetry: dict = {"textfiles": [os.path.relpath(path, obs) for path in prom]}
            if len(prom) == 1:
                text = open(prom[0]).read()
                source = (f"file:{os.path.basename(os.path.dirname(prom[0]))}/"
                          f"{os.path.basename(prom[0])}")
                for name in ("tpx_step_seconds_bucket", "tpx_step_seconds_sum",
                             "tpx_step_seconds_count"):
                    want = sorted((sorted(smp.labels), smp.value)
                                  for smp in parse_exposition(text) if smp.name == name)
                    got = sorted((sorted(ser["labels"].items()), ser["points"][-1][1])
                                 for ser in client.metrics_query(name=name)["series"]
                                 if ser["source"] == source)
                    telemetry[name] = {"textfile": len(want), "daemon": len(got),
                                       "equal": want == got}
                telemetry["steps_counted"] = next(
                    (smp.value for smp in parse_exposition(text)
                     if smp.name == "tpx_step_seconds_count"), None)
            with open(replica.stdout, errors="replace") as f:
                out = f.read()
            if status["state"] != "SUCCEEDED" or "final:" not in out:
                with open(replica.stderr, errors="replace") as f:
                    err = f.read()
                fail(phase, f"gang A through the daemon ended {status['state']}:"
                     f" {' '.join(replica.args)}\n{out[-3000:]}\n{err[-3000:]}")
            daemon.runner.delete(handle)  # its registry entry; the logs go with ``root``
        finally:
            if handle is not None and (status is None or not status.get("terminal")):
                daemon.runner.cancel(handle)  # past the limit: the kill ladder
            daemon.close()
            daemon.runner.close()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    final = json.loads(out.split("final:", 1)[1].splitlines()[0])
    record = {"app_handle": handle, "component": "dist.spmd", "route": "control daemon",
              "app_id": app_id, "state": status["state"],
              "gpu": role.resource.gpu and role.resource.gpu.accelerator_type,
              "entrypoint": replica.args[0],
              "cuda_visible_devices": replica.env.get("CUDA_VISIBLE_DEVICES"),
              "submit_to_first_step_s": first[0] if first else None,
              "submit_to_succeeded_s": done,
              "launch_breakdown_s": final.get("launch_breakdown"),
              "launch_marks_s": _launch_marks(obs, t0_epoch),
              "daemon": {
                  "start_s": daemon_start_s, "submit_round_trip_s": submit_rtt,
                  "submit_handler_s": submit_s, "scheduler_submit_s": schedule_s,
                  "exit_to_wait_s": wait_epoch - exit_epoch,
                  "terminal_event": None if event is None else {
                      "state": event.state.name, "source": event.source,
                      "cell": event.cell, "to_wait_s": wait_epoch - event.time_usec / 1e6},
                  "watch_interval_s": watch_interval(),
                  "status_state": daemon_state, "runner_status_state": runner_state,
                  "describes_during_wait": waited_describes, "telemetry": telemetry}}
    d = record["daemon"]
    if event is None or not event.terminal:
        fail(phase, f"the reconciler recorded no terminal event for gang A: {event}")
    if daemon_state != runner_state:
        fail(phase, f"/v1/status says {daemon_state}, Runner.status {runner_state}")
    if len(prom) != 1 or not all(v["equal"] and v["textfile"] for k, v in
                                 telemetry.items() if k.startswith("tpx_step_seconds")):
        fail(phase, f"the daemon's tpx_step_seconds against gang A's textfile: {telemetry}")
    if d["exit_to_wait_s"] > max(5.0, 5 * d["watch_interval_s"]):
        fail(phase, f"/v1/wait returned {d['exit_to_wait_s']:.3f} s after the replica's exit")
    return final, record


def gang_a_component_args(root: str, cards: int) -> list[str]:
    """Gang A as ``dist.spmd``'s command-line arguments, the ones ``tpx-torch
    run dist.spmd ...`` hands the control daemon, which materializes them
    into :func:`gang_a_app`'s command (checked in :func:`_daemon_spmd`)."""
    return ["--gpu", f"h100-{cards}", "--image", REPO, "--env",
            f"PYTHONPATH={REPO},TPX_OBS_DIR={os.path.join(root, 'obs')}",
            "--coordinator_port", "0", "-m", GANG_A_MODULE, "--", *gang_a_args()]


def _trace_spans(obs_root: str, since: float = 0.0) -> list[dict]:
    """Every span in the traces under ``obs_root`` (one ``trace.jsonl`` a
    session) that started at epoch ``since`` or later, in file order."""
    import glob

    out = []
    for path in glob.glob(os.path.join(obs_root, "*", "trace.jsonl")):
        with open(path, errors="replace") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("kind") == "span" and \
                        rec.get("start_epoch_usec", 0) / 1e6 >= since:
                    out.append(rec)
    return out


def _launch_marks(obs_root: str, t_submit: float) -> dict:
    """Seconds from submit (epoch ``t_submit``) to each mark of rank 0's
    launch in the job's trace (the runner hands the job its trace context,
    so ``spmd_main`` and the trainer write their spans under ``obs_root``;
    spans from before the submit, an earlier attempt's, are not read):
    the ``spmd_main`` process's start (its ``job.bootstrap`` span's start
    less the ``import_s`` it spent importing), its card and process group
    (the span's start and end), the target's start (``job.exec``), the
    trainer's first stage (``launch.backend_init``) and its first step
    (``job.first_step``)."""
    spans: dict[str, dict] = {}
    for rec in _trace_spans(obs_root, since=t_submit):
        name = rec.get("name", "")
        if name.startswith(("job.", "launch.")) and \
                rec.get("attrs", {}).get("local_rank", 0) == 0:
            spans.setdefault(name, rec)  # rank 0's, the first of each
    marks = {}
    boot = spans.get("job.bootstrap")
    if boot is not None:
        start = boot["start_epoch_usec"] / 1e6
        marks["spmd_main_start"] = start - boot["attrs"].get("import_s", 0.0) - t_submit
        marks["bootstrap_start"] = start - t_submit
        marks["group_up"] = boot["end_epoch_usec"] / 1e6 - t_submit
    for mark, name in (("target_exec", "job.exec"), ("train_start", "launch.backend_init"),
                       ("first_step", "job.first_step")):
        if name in spans:
            marks[mark] = spans[name]["start_epoch_usec"] / 1e6 - t_submit
    return marks


GANG_A_MODULE = "torchx_tpu_torch.examples.train_llama"


def gang_a_args() -> list[str]:
    """Gang A's trainer arguments: the train phase's llama3_1b run under
    ``GANG["remat_policy"]``, its buckets at ``GANG["bucket_mb"]``."""
    return ["--config", "llama3_1b", "--batch", str(TRAIN["batch"]), "--seq",
            str(TRAIN["seq"]), "--steps", str(TRAIN["steps"]), "--kernels", "cuda",
            "--warmup", "1", "--mesh", "fsdp=-1", "--grad-bucket-mb",
            str(GANG["bucket_mb"]), "--remat-policy", GANG["remat_policy"]]


def gang_a_app(root: str, cards: int):  # noqa: ANN201
    """Gang A as the port's ``dist.spmd`` app on ``h100-<cards>`` (standard
    library only: the remote phase materializes it without torch). The
    component's entrypoint is ``python``: on the card's machine it is this
    interpreter (PERF.md §6, the run path)."""
    from torchx_tpu_torch.components import dist

    return dist.spmd(*gang_a_args(), m=GANG_A_MODULE, image=REPO, gpu=f"h100-{cards}",
                     env={"PYTHONPATH": REPO, "TPX_OBS_DIR": os.path.join(root, "obs")},
                     coordinator_port=0)


def _gang_a(cfg, root: str, profiled: bool, scheduled: bool = True) -> dict:  # noqa: ANN001
    """The train phase's run through ``spmd_main`` (module docstring) under
    ``--remat-policy dots`` (``GANG["remat_policy"]``: the same bits and
    launches as the train phase's ``full``, so a remat policy runs through
    ``spmd_main`` on the card): unprofiled and ``scheduled``, submitted
    through the port's control daemon as ``dist.spmd`` (:func:`_daemon_spmd`,
    its record under ``"launcher"``); with
    ``profiled``, by hand as the train phase's profiled run (the step
    profiler and the trainer's torch.profiler trace, read here)."""
    import torch

    extra = ["--profile", "--profile-dir", os.path.join(root, "trace")] if profiled else []
    if scheduled and not profiled:
        final, record = _daemon_spmd(torch.cuda.device_count(), root, "gang")
        final["launcher"] = record
        return final
    env = {"TPX_OBS_DIR": os.path.join(root, "obs")}
    final, _ = _spmd([], ["-m", GANG_A_MODULE, "--", *gang_a_args(), *extra], env, "gang")
    if profiled:
        with open(final["profile_trace"]) as f:
            events = json.load(f)["traceEvents"]
        timed = TRAIN["steps"] - 1
        coll = collective_device_ms(events)
        final["collective_device_ms_per_step"] = {k: v / timed for k, v in coll["ms"].items()}
        final["collective_device_ms_per_step_total"] = sum(coll["ms"].values()) / timed
        final["collective_gpu_events"] = coll["events"]
        final.update(device_busy(events, timed))
    return final


def phase_gang(train_out: dict, train_profiled: dict, spmd_too: bool = False) -> dict:
    """A: the train phase's llama3_1b run (6 steps, warm-up 1) through
    ``spmd_main`` as one replica with one worker a card on NCCL, ``--mesh
    fsdp=-1 --grad-bucket-mb 32``, unprofiled and then profiled as the
    train phase's profiled run: exit 0, every rank's launches the train
    phase's, at a world of one the losses the train phase's (bitwise where
    its two runs were, else within ``GANG_LOSS_RTOL``; on more cards within
    ``REF_LOSS_RTOL``). The unprofiled run is submitted through the port's
    control daemon as ``dist.spmd``; with ``spmd_too`` (the gangspmd phase) it runs once more by
    hand, unprofiled, for its step time beside the scheduler's. B:
    :func:`phase_gang_ranks`."""
    import shutil
    import tempfile

    import torch

    from torchx_tpu_torch.models import llama

    cfg = llama.llama3_1b()
    cards = torch.cuda.device_count()
    root = tempfile.mkdtemp(prefix="tpx_gang_smoke_")
    free_card()
    try:
        plain = _gang_a(cfg, root, profiled=False)
        prof = _gang_a(cfg, root, profiled=True)
        by_hand = _gang_a(cfg, root, profiled=False, scheduled=False) if spmd_too else None
    finally:
        shutil.rmtree(root, ignore_errors=True)
    expected = expected_launches(cfg, TRAIN["steps"])
    repeatable = train_profiled["losses"] == train_out["losses"]
    rel = max(_rel_diff(f["losses"], train_out["losses"]) for f in (plain, prof))
    res = {
        "phase": "gang", "run": "A", "config": "llama3_1b", "world": plain["world"],
        "cards": cards, "backend": plain["backend"], "mesh": plain["mesh"],
        "grad_bucket_mb": plain["grad_bucket_mb"], "grad_buckets": plain["grad_buckets"],
        "losses": plain["losses"], "profiled_losses": prof["losses"],
        "train_losses": train_out["losses"], "train_runs_repeatable": repeatable,
        "losses_bitwise": plain["losses"] == prof["losses"] == train_out["losses"],
        "loss_max_rel_diff": rel, "grad_norms": plain["grad_norms"],
        "step_times_s": plain["step_times_s"], "step_time_s": plain["step_time_s"],
        "train_step_time_s": train_out["step_time_s"],
        "step_time_over_train": plain["step_time_s"] / train_out["step_time_s"] - 1,
        "profiled_step_times_s": prof["step_times_s"],
        "profiled_step_time_s": prof["step_time_s"],
        "train_profiled_step_time_s": train_profiled["step_time_s"],
        "profiled_over_train_profiled": prof["step_time_s"] / train_profiled["step_time_s"]
        - 1,
        "tokens_per_sec_per_card": plain["tokens_per_sec_per_card"], "mfu": plain["mfu"],
        "peak_memory_bytes_by_rank": plain["peak_memory_bytes_by_rank"],
        "train_peak_memory_bytes": train_out["peak_memory_bytes"],
        "train_profiled_trace": {k: train_profiled[k] for k in
                                 ("device_busy_ms_per_step", "span_ms_per_step",
                                  "device_idle_share")},
        **{k: prof[k] for k in ("device_busy_ms_per_step", "span_ms_per_step",
                                "device_idle_share", "collective_device_ms_per_step",
                                "collective_device_ms_per_step_total",
                                "collective_gpu_events")},
        "collective_bytes_per_step_reckoned": gang_bytes(cfg),
        # the step profiler's grad_sync: the cost model's seconds a step per
        # data axis (bytes over NVLink's 450 GB/s), and what it attributed
        "grad_sync_modeled_s_per_step": prof["profile"]["meta"]["comm_modeled_axis_s"],
        "grad_sync_attributed_s_per_step": {
            k: v / prof["profile"]["steps"]
            for k, v in prof["profile"]["grad_sync_seconds"].items()},
        "launches_by_rank": plain["launches_by_rank"], "expected_launches": expected,
        "launcher": plain["launcher"],
    }
    if by_hand is not None:
        res["spmd_by_hand"] = {
            "step_times_s": by_hand["step_times_s"], "step_time_s": by_hand["step_time_s"],
            "step_time_over_train": by_hand["step_time_s"] / train_out["step_time_s"] - 1,
            "scheduled_over_by_hand": plain["step_time_s"] / by_hand["step_time_s"] - 1,
            "losses_bitwise_scheduled": by_hand["losses"] == plain["losses"]}
    emit(res)
    for final in (plain, prof, *([by_hand] if by_hand else [])):
        if final["backend"] != "nccl" or final["world"] != cards:
            fail("gang", f"A ran {final['world']} ranks on {final['backend']}, not one a card"
                 " on NCCL")
        if any(launches != expected for launches in final["launches_by_rank"]):
            fail("gang", f"a rank's launches differ from the train phase's:"
                 f" {final['launches_by_rank']}")
        if final["world"] == 1 and (final["losses"] != train_out["losses"] if repeatable
                                    else rel > GANG_LOSS_RTOL):
            fail("gang", f"world-1 losses {final['losses']} against the train phase's"
                 f" {train_out['losses']}")
        if final["world"] > 1 and rel > REF_LOSS_RTOL:  # another summation order
            fail("gang", f"world-{final['world']} losses {final['losses']} against the"
                 f" train phase's {train_out['losses']}")
    return {"A": res, "A_final": plain,
            "B": phase_gang_ranks(cards, tempfile.mkdtemp(prefix="tpx_gang_b_"))}


def phase_local(gang_a: dict, card: str) -> dict:
    """The local scheduler on the card (module docstring): its card count
    against torch's, gang A's launcher record, and the over-subscription
    refusal of a dryrun asking one card more than the host has."""
    import torch

    from torchx_tpu_torch.schedulers.local_scheduler import LocalScheduler, local_gpu_count
    from torchx_tpu_torch.specs.api import AppDef, GpuSlice, Resource, Role

    t = time.monotonic()
    cards = torch.cuda.device_count()
    counted = local_gpu_count()
    # one card more than the host has (a slice above one host's eight
    # takes whole hosts: 16)
    over = GpuSlice("h100", cards + 1 if cards < 8 else 16)
    role = Role(name="over", image="", entrypoint=sys.executable, args=["-c", "pass"],
                resource=Resource(cpu=1, memMB=64, gpu=over))
    sched = LocalScheduler(session_name="chip_smoke")
    try:
        sched.submit_dryrun(AppDef(name="over", roles=[role]), {})
        refused = None
    except ValueError as e:
        refused = str(e)
    finally:
        sched.close()
    launcher = gang_a["launcher"]
    res = {"phase": "local", "local_gpu_count": counted, "device_count": cards,
           "cuda_visible_devices_env": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "gang_a": launcher, "over_subscribed": over.accelerator_type,
           "over_subscription_refused": refused,
           "phase_s_without_gang_a": time.monotonic() - t, "card": card}
    emit(res)
    if counted != cards:
        fail("local", f"local_gpu_count() {counted} != torch.cuda.device_count() {cards}")
    if launcher["state"] != "SUCCEEDED" or launcher["submit_to_first_step_s"] is None:
        fail("local", f"gang A through the scheduler: {launcher}")
    if refused is None or "cards" not in refused:
        fail("local", f"a dryrun asking {over.accelerator_type} of {cards} card(s) was not"
             f" refused for over-subscription: {refused}")
    return res


#: The remote backends the remote phase dryruns, each with its run config.
REMOTE_BACKENDS = {"gke": {}, "slurm": {}, "local_docker": {},
                   "vertex": {"project": "chip-smoke"}, "gcp_batch": {"project": "chip-smoke"}}
#: Names no port request may carry: the TPU slice surface it replaced.
TPU_NAMES = ("google.com/tpu", "gke-tpu-", "hightpu", "tpuTopology", "MEGASCALE", "TPX_TPU_")


class _Refuse:
    """A backend client stub: every attribute it is asked for raises (and is
    counted in ``calls``), so a dryrun that reached a daemon or a cloud
    fails the phase."""

    def __init__(self, name: str, calls: dict) -> None:
        self._name, self._calls = name, calls

    def __getattr__(self, attr: str):  # noqa: ANN204
        self._calls[self._name] = self._calls.get(self._name, 0) + 1
        raise RuntimeError(f"{self._name}: the dryrun called its client ({attr})")


def remote_requests(cards: int, root: str) -> dict:
    """Gang A's app (:func:`gang_a_app`) through each remote backend's
    ``submit_dryrun``, every client a :class:`_Refuse` stub (a CLI backend's
    ``_run_cmd`` raises ``FileNotFoundError``, as on a host without it: the
    slurm dryrun's ``sinfo`` memory probe meets it and keeps ``--mem``).
    -> each request's cards a host, their names, each slurm group's identity
    beside ``role_replica_env``'s, the TPU names found, the stub calls and
    the modules of torch, jax or the JAX package that got loaded. Standard
    library only: the remote phase runs it in a subprocess."""
    from torchx_tpu_torch import settings
    from torchx_tpu_torch.schedulers import get_scheduler_factories
    from torchx_tpu_torch.schedulers.api import role_replica_env

    calls: dict[str, int] = {}

    def no_cli(name):  # noqa: ANN001, ANN202
        def run(cmd, **kwargs):  # noqa: ANN001, ANN003, ANN202
            calls[name] = calls.get(name, 0) + 1
            raise FileNotFoundError(f"{cmd[0]}: no {name} control plane on this machine")
        return run

    app = gang_a_app(root, cards)
    (role,) = app.roles
    gpu = role.resource.gpu
    factories = get_scheduler_factories()
    out: dict = {"accelerator_type": gpu.accelerator_type, "gpus_per_host": gpu.gpus_per_host,
                 "hosts": gpu.hosts, "backends": {}}
    for name, cfg in REMOTE_BACKENDS.items():
        kwargs = {} if name == "slurm" else {"docker_client": _Refuse(f"{name}.docker", calls)}
        if name in ("gke", "vertex"):
            kwargs["client"] = _Refuse(name, calls)
        sched = factories[name](session_name="chip_smoke", **kwargs)
        if hasattr(sched, "_run_cmd"):
            sched._run_cmd = no_cli(name)
        t = time.monotonic()
        req = sched.submit_dryrun(app, dict(cfg)).request
        got: dict = {"dryrun_s": time.monotonic() - t,
                     "tpu_names": [n for n in TPU_NAMES if n in str(req)]}
        if name == "gke":
            (rj,) = req.resource["spec"]["replicatedJobs"]
            pod = rj["template"]["spec"]["template"]["spec"]
            got.update(hosts=rj["replicas"] * rj["template"]["spec"]["parallelism"],
                       cards_per_host=pod["containers"][0]["resources"]["limits"]
                       ["nvidia.com/gpu"],
                       accelerator=pod["nodeSelector"]["cloud.google.com/gke-accelerator"])
        elif name == "slurm":
            identity = []
            for rid, group in enumerate(req.replicas):
                want = role_replica_env(role, rid, "", settings.TPX_COORDINATOR_PORT)
                want.pop(settings.ENV_TPX_COORDINATOR_HOST)
                identity.append({k: group.env.get(k) for k in want} == want)
            per_node = [int(o.split("=", 1)[1]) for g in req.replicas for o in g.sbatch_opts
                        if o.startswith("--gpus-per-node=")]
            got.update(hosts=len(req.replicas), cards_per_host=per_node,
                       identity_equals_role_replica_env=identity,
                       coordinator_exported="export TPX_COORDINATOR_HOST=" in req.script())
        elif name == "local_docker":
            got["device_ids"] = [c.kwargs["device_requests"][0]["device_ids"]
                                 for c in req.containers]
            got.update(hosts=len(req.containers),
                       cards_per_host=[len(ids) for ids in got["device_ids"]],
                       driver={c.kwargs["device_requests"][0]["driver"] for c in req.containers}
                       .pop(),
                       node_mounts=[d for c in req.containers for d in c.kwargs.get("devices", [])])
        elif name == "vertex":
            pools = req.custom_job["jobSpec"]["workerPoolSpecs"]
            got.update(hosts=sum(p["replicaCount"] for p in pools),
                       cards_per_host=[p["machineSpec"]["acceleratorCount"] for p in pools],
                       accelerator=[p["machineSpec"]["acceleratorType"] for p in pools],
                       machine=[p["machineSpec"]["machineType"] for p in pools])
        else:
            (group,) = req.config["taskGroups"]
            (inst,) = req.config["allocationPolicy"]["instances"]
            (accel,) = inst["policy"]["accelerators"]
            got.update(hosts=group["taskCount"], cards_per_host=accel["count"],
                       accelerator=accel["type"], machine=inst["policy"]["machineType"],
                       install_gpu_drivers=inst.get("installGpuDrivers"))
        out["backends"][name] = got
    out["stub_calls"] = calls
    out["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("torch", "jax", "torchx_tpu", "triton"))
    return out


def phase_remote(card: str) -> dict:
    """The remote backends on the card's machine (module docstring): gang
    A's app dryrun through gke, slurm, local_docker, vertex and gcp_batch
    in a subprocess that loads no torch (:func:`remote_requests`), each
    request's cards held to the slice's and docker's to this machine's."""
    import glob
    import tempfile

    import torch

    t = time.monotonic()
    cards = torch.cuda.device_count()
    nodes = sorted((p for p in glob.glob("/dev/nvidia*") if re.fullmatch(r"/dev/nvidia\d+", p)),
                   key=lambda p: int(p[len("/dev/nvidia"):]))
    # the subprocess stamps its start, chip_smoke.py's import and the
    # dryruns on the epoch clock, against this process's launch
    code = ("import time; t = [time.time()]\n"
            "import importlib.util, json, sys\n"
            "spec = importlib.util.spec_from_file_location('chip_smoke_remote', sys.argv[1])\n"
            "smoke = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(smoke)\n"
            "t.append(time.time())\n"
            "out = smoke.remote_requests(int(sys.argv[2]), sys.argv[3])\n"
            "t.append(time.time())\n"
            "print(json.dumps({**out, 'stamps': t}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    t_sub, t_epoch = time.monotonic(), time.time()
    proc = subprocess.run([sys.executable, "-c", code, os.path.abspath(__file__), str(cards),
                           tempfile.mkdtemp(prefix="tpx_remote_")],
                          env=env, capture_output=True, text=True, timeout=300)
    subprocess_s = time.monotonic() - t_sub
    if proc.returncode != 0:
        fail("remote", f"the dryruns' subprocess failed:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    start, imported, done = got.pop("stamps")
    split = {"interpreter_start": start - t_epoch, "chip_smoke_import": imported - start,
             "dryruns_with_imports": done - imported,
             "dryruns": sum(b["dryrun_s"] for b in got["backends"].values())}
    torch_uuids = []
    for i in range(cards):
        uuid = getattr(torch.cuda.get_device_properties(i), "uuid", None)
        torch_uuids.append(None if uuid is None else str(uuid))
    docker = got["backends"]["local_docker"]
    named = docker["device_ids"][0] if docker["device_ids"] else []
    uuid_like = all(u and re.fullmatch(r"[0-9a-f]{8}(-[0-9a-f]{4}){3}-[0-9a-f]{12}", u)
                    for u in torch_uuids)
    res = {"phase": "remote", "device_count": cards, "dev_nvidia_nodes": nodes,
           "torch_uuids": torch_uuids,
           "docker_ids_are_torch_uuids": named == [f"GPU-{u}" for u in torch_uuids]
           if uuid_like else None, **got, "subprocess_s": subprocess_s, "subprocess_split_s": split,
           "seconds": time.monotonic() - t, "card": card}
    emit(res)
    problems = []
    if got["loaded"]:
        problems.append(f"materializing the requests loaded {got['loaded']}")
    # slurm's dryrun probes sinfo for the partition's memory, best effort
    if {k: v for k, v in got["stub_calls"].items() if k != "slurm"}:
        problems.append(f"a dryrun called a client: {got['stub_calls']}")
    per_host = got["gpus_per_host"]
    for name, b in got["backends"].items():
        want = [per_host] * got["hosts"] if isinstance(b["cards_per_host"], list) else per_host
        if name == "vertex":
            want = [per_host] * len(b["cards_per_host"])
        if b["cards_per_host"] != want or b["hosts"] != got["hosts"]:
            problems.append(f"{name}: {b['hosts']} host(s) of {b['cards_per_host']} card(s),"
                            f" the slice is {got['hosts']} of {per_host}")
        if b["tpu_names"]:
            problems.append(f"{name} names {b['tpu_names']}")
    b = got["backends"]
    if b["gke"]["accelerator"] != "nvidia-h100-80gb" \
            or b["gcp_batch"]["accelerator"] != "nvidia-h100-80gb" \
            or set(b["vertex"]["accelerator"]) != {"NVIDIA_H100_80GB"}:
        problems.append("an accelerator name is not nvidia-h100-80gb / NVIDIA_H100_80GB")
    if sum(len(ids) for ids in docker["device_ids"]) != cards or docker["node_mounts"]:
        problems.append(f"the docker request names {docker['device_ids']} (and mounts"
                        f" {docker['node_mounts']}) for {cards} card(s)")
    if res["docker_ids_are_torch_uuids"] is False:
        problems.append(f"the docker ids {named} are not torch's cards {torch_uuids}")
    if not all(b["slurm"]["identity_equals_role_replica_env"]) \
            or not b["slurm"]["coordinator_exported"]:
        problems.append("a slurm het group's identity is not role_replica_env's")
    if problems:
        fail("remote", "; ".join(problems))
    return res


def phase_gang_parts() -> None:
    """Where the world-1 sharded step's time goes, in this process (no
    ``spmd_main``): the train phase's run on one device, sharded
    (``mesh="fsdp=-1"``, a world-1 NCCL group), and sharded with every
    gather and reduce-scatter swapped for a local copy of the same layout
    (the NCCL calls gone, the copies kept), after a warm-up run, in turns
    single, sharded, local, local, sharded, single, twice; the mean step
    time of each."""
    import contextlib
    from unittest import mock

    import torch.distributed as dist

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama

    cfg = llama.llama3_1b()

    def local_copy(out, inp, group=None):  # noqa: ANN001, ANN202, ARG001
        return out.copy_(inp.reshape(out.shape))  # a world of one's gather or sum

    times: dict[str, list[float]] = {}
    # a first run warms the process (the first run's steps ran slower than
    # any later run's); then turns, each order forward and back
    order = ("warm-up",) + ("single", "sharded", "local", "local", "sharded", "single") * 2
    for run in order:
        free_card()
        with contextlib.ExitStack() as stack:
            if run == "local":  # the mesh's two FSDP collectives become copies
                for name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
                    stack.enter_context(mock.patch.object(dist, name, local_copy))
            out = train(cfg, TRAIN["batch"], TRAIN["seq"], TRAIN["steps"], kernels="cuda",
                        device="cuda", warmup=1, log_every=0,
                        mesh=None if run in ("single", "warm-up") else "fsdp=-1")
        times.setdefault(run, []).append(out["step_time_s"])
        if run in ("sharded", "local") and out["backend"] != "nccl":
            fail("gangparts", f"{run} ran on {out['backend']}")
    mean = {k: sum(v) / len(v) for k, v in times.items() if k != "warm-up"}
    emit({"phase": "gangparts", "step_time_s": times, "mean_s": mean,
          "sharded_over_single": mean["sharded"] / mean["single"] - 1,
          "local_over_single": mean["local"] / mean["single"] - 1})


#: B's script: the trainer's module as ``__main__`` with llama3_1b cut to
#: GANG["b_layers"] layers (the ckpt drill's way of cutting the preset).
#: B's script, the gang phase's and the gangckpt phase's: the trainer on
#: llama3_1b cut to ``layers`` layers, its ranks over ``mesh``, checkpointing
#: into ``<out>/ck`` (the forced save of its last step); each rank also
#: leaves its final state (its shards) in ``<out>/rank<r>.pt`` to hold a
#: restore to.
_B_SCRIPT = """import json, os, sys
import torch, torch.distributed as dist
from torchx_tpu_torch.examples import train_llama
from torchx_tpu_torch.models import llama
out = sys.argv[1]

def dump(event, state):
    if event == "final":
        torch.save({{k: v.detach().cpu().clone() for k, v in state.items()}},
                   os.path.join(out, f"rank{{dist.get_rank()}}.pt"))

res = train_llama.train(llama.llama3_1b(n_layers={layers}), {batch}, {seq}, {steps},
                        warmup=1, kernels="cuda", device="cuda", log_every=0,
                        mesh="{mesh}", grad_bucket_mb={bucket_mb},
                        ckpt_dir=os.path.join(out, "ck"), on_state=dump)
if dist.get_rank() == 0:
    print("final:", json.dumps(res), flush=True)
"""


def _b_save(out: str, layers: int, steps: int, ranks: int, backend: str, mesh: str,
            phase: str) -> dict:
    """B's launch (``_B_SCRIPT``) into ``out``: ``ranks`` ranks on ``backend``
    over ``mesh``, llama3_1b at ``layers`` layers for ``steps`` steps on the
    train phase's batch. -> rank 0's final summary."""
    os.makedirs(out, exist_ok=True)
    script = os.path.join(out, "b_train.py")
    with open(script, "w") as f:
        f.write(_B_SCRIPT.format(layers=layers, batch=TRAIN["batch"], seq=TRAIN["seq"],
                                 steps=steps, mesh=mesh, bucket_mb=GANG["bucket_mb"]))
    final, _ = _spmd(["--nproc-per-node", str(ranks), "--backend", backend],
                     ["--script", script, "--", out], {}, phase)
    return final


def b_layout(cards: int) -> tuple[int, str, str]:
    """B's (ranks, backend, mesh) on a machine of ``cards`` cards, chosen
    from the count: four ranks on NCCL as ``dp=2,fsdp=2`` with four cards
    or more (the dp gradient sum and its buckets on NCCL); two on NCCL as
    ``fsdp=2`` with two or three; else two ranks sharing the one card on
    gloo (NCCL refuses two ranks on one card), which takes CUDA tensors in
    all_gather_into_tensor, reduce_scatter_tensor and all_reduce in bf16
    and f32 (torch 2.11's, checked on the card)."""
    if cards >= 4:
        return 4, "nccl", "dp=2,fsdp=2"
    return 2, "nccl" if cards >= 2 else "gloo", "fsdp=2"


def phase_gang_ranks(cards: int, out: str) -> dict:
    """B: several ranks (:func:`b_layout`, ``--grad-bucket-mb 32``) train
    llama3_1b cut to 2 layers on the train phase's global batch, against
    ``train`` in this process: losses within REF_LOSS_RTOL, gradient norms
    within REF_GRAD_NORM_RTOL, every rank's launches one process's. Its
    last step's checkpoint and each rank's final state stay in ``out``
    (:func:`_b_save`) for the gangckpt phase's restore; the line's
    ``"final"`` is rank 0's summary."""
    import torch

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.parallel.mesh_config import mesh_sizes_spec, parse_mesh_spec

    ranks, backend, mesh = b_layout(cards)
    steps, layers = GANG["b_steps"], GANG["b_layers"]
    cfg = llama.llama3_1b(n_layers=layers)
    free_card()
    one = train(cfg, TRAIN["batch"], TRAIN["seq"], steps, kernels="cuda", device="cuda",
                warmup=1, log_every=0)
    free_card()
    final = _b_save(out, layers, steps, ranks, backend, mesh, "gang")
    loss_rel = _rel_diff(final["losses"], one["losses"])
    gn_rel = _rel_diff(final["grad_norms"], one["grad_norms"])
    expected = expected_launches(cfg, steps)
    res = {"phase": "gang", "run": "B", "n_layers": layers, "steps": steps, "cards": cards,
           "ranks_share_a_card": cards < 2, "backend": final["backend"],
           "mesh": final["mesh"], "world": final["world"],
           "grad_bucket_mb": final["grad_bucket_mb"], "grad_buckets": final["grad_buckets"],
           "losses": final["losses"],
           "one_process_losses": one["losses"], "loss_max_rel_diff": loss_rel,
           "loss_rtol": REF_LOSS_RTOL, "grad_norms": final["grad_norms"],
           "one_process_grad_norms": one["grad_norms"], "grad_norm_max_rel_diff": gn_rel,
           "grad_norm_rtol": REF_GRAD_NORM_RTOL, "step_time_s": final["step_time_s"],
           "one_process_step_time_s": one["step_time_s"],
           "one_process_peak_memory_bytes": one["peak_memory_bytes"],
           "launches_by_rank": final["launches_by_rank"], "expected_launches": expected}
    emit(res)
    want_mesh = mesh_sizes_spec(parse_mesh_spec(mesh).resolve(ranks))
    if (final["world"], final["backend"], final["mesh"]) != (ranks, backend, want_mesh):
        fail("gang", f"B ran {final['world']} ranks on {final['backend']} as"
             f" {final['mesh']}, not {ranks} on {backend} as {want_mesh}")
    if "dp=2" in mesh and final["grad_buckets"] < 2:
        fail("gang", f"B's dp sum ran in {final['grad_buckets']} bucket(s), not several")
    if loss_rel > REF_LOSS_RTOL or gn_rel > REF_GRAD_NORM_RTOL:
        fail("gang", f"{ranks} ranks {final['losses']} / {final['grad_norms']} against one"
             f" process {one['losses']} / {one['grad_norms']}")
    if any(launches != expected for launches in final["launches_by_rank"]):
        fail("gang", f"B's launches {final['launches_by_rank']} != {expected}")
    return {**res, "final": final, "out": out}


#: The gangckpt phase (module docstring): A's SIGTERM after its step line
#: ``term_after`` (the notice lands within the next step: a save of step 2
#: to 4 of the 6 the gang phase's A ran uninterrupted), the wait for its
#: exit; B, where the gang phase's B did not save two ranks at ``fsdp=2``,
#: at ``b_layers`` layers for ``b_steps`` steps.
GANGCKPT = dict(term_after=2, limit_s=150.0, b_layers=2, b_steps=2)

#: The resize's script: A's trainer as two ranks at ``fsdp=-1`` resuming
#: from ``<ck>``. Right after the restore each rank holds every restored
#: block against its chunk of the whole tensor that a reader without a mesh
#: assembles from the step's files, one entry at a time, and leaves the
#: names that differ in ``<out>/restored<r>.json``.
_GANGCKPT_RESIZE_SCRIPT = """import json, os, sys, time
import torch, torch.distributed as dist
from torchx_tpu_torch.examples import train_llama
from torchx_tpu_torch.models import llama
from torchx_tpu_torch.parallel.checkpoint import Checkpointer
out, ck = sys.argv[1], sys.argv[2]
cfg = llama.llama3_1b()
specs = train_llama.checkpoint_specs(cfg)

def check(event, state):
    if event != "restored":
        return
    t0 = time.monotonic()
    rank, world = dist.get_rank(), dist.get_world_size()
    reader = Checkpointer(ck, read_only=True)
    step = reader.latest_step()
    bad = []
    for name, live in state.items():
        whole = reader.restore(step, prefix=name)[name]
        for d, axis in enumerate(specs.get(name, ())):
            if axis == "fsdp":
                whole = whole.chunk(world, d)[rank]
        if not torch.equal(live.detach().cpu(), whole):
            bad.append(name)
    with open(os.path.join(out, f"restored{{rank}}.json"), "w") as f:
        json.dump({{"step": step, "entries": len(state), "mismatched": bad,
                   "check_s": time.monotonic() - t0}}, f)

res = train_llama.train(cfg, {batch}, {seq}, {steps}, warmup=1, kernels="cuda",
                        log_every=1, mesh="fsdp=-1", grad_bucket_mb={bucket_mb},
                        ckpt_dir=ck, on_state=check)
if dist.get_rank() == 0:
    print("final:", json.dumps(res), flush=True)
"""


def _link_copy(src: str, dst: str) -> str:
    """A copy of the checkpoint directory ``src`` made of hard links: a run
    on it writes new files and replaces the manifest, never a file in place,
    so ``src`` stays as it was."""
    import shutil

    shutil.copytree(src, dst, copy_function=os.link)
    return dst


def _spmd_drill(args: list[str], target: list[str], term_after: int, limit_s: float,
                phase: str) -> dict:
    """:func:`_spmd`'s gang, SIGTERM to ``spmd_main`` (the launcher's
    notice; it forwards the signal to every worker) after rank 0's
    ``term_after``-th step line; the exit awaited ``limit_s``. -> rank 0's
    final summary, SIGTERM to exit, and whether the notice was printed."""
    import signal

    full = dict(os.environ, PYTHONPATH=REPO, TPX_REPLICA_ID="0", TPX_NUM_REPLICAS="1",
                TPX_COORDINATOR_HOST="127.0.0.1")
    cmd = [sys.executable, "-m", "torchx_tpu_torch.apps.spmd_main", "--port", "0",
           "--timeout", "120", *args, *target]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=full, cwd=REPO, start_new_session=True)
    lines = []
    try:
        while sum(x.startswith("step ") for x in lines) < term_after:
            line = proc.stdout.readline()
            if not line:
                fail(phase, f"drill: the gang ended before its step line {term_after}:\n"
                     + "".join(lines)[-3000:])
            lines.append(line)
        t_term = time.monotonic()
        proc.send_signal(signal.SIGTERM)  # spmd_main forwards it to every worker
        try:
            rest, _ = proc.communicate(timeout=limit_s)
        except subprocess.TimeoutExpired:
            fail(phase, f"drill: no exit within {limit_s} s of SIGTERM")
        exit_s = time.monotonic() - t_term
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait()
    out = "".join(lines) + rest
    if proc.returncode != 0 or "final:" not in out:
        fail(phase, f"drill: spmd_main exit {proc.returncode}:\n{out[-4000:]}")
    final = json.loads(out.split("final:", 1)[1].splitlines()[0])
    notice = f"preemption notice: checkpointed step {final['final_step']}, exiting"
    return {"final": final, "sigterm_to_exit_s": exit_s, "notice_printed": notice in out}


#: The gangckpt phase's supervised resume: the policy's backoff, its status
#: poll (``poll_interval``) and its gang monitor, whose hang deadline
#: outlasts every gap between evidence of a healthy attempt (the launch to
#: the first step, 20-35 s on the card, carries none; the last step's
#: forced save, a 7.4 GB write, ~20 s) and the monitor's check interval;
#: ``limit_s`` bounds the whole session.
SUPERVISED = dict(backoff_s=1.0, poll_s=0.5, hang_deadline_s=90.0, gang_check_s=2.0,
                  limit_s=420.0)


def _sigkill_exit_code(root: str) -> int:
    """The exit code the port's local scheduler records for a replica whose
    process group is SIGKILLed, read from a real one (``sleep`` on the
    scheduler, killed as :func:`_supervised_resume` kills a gang)."""
    import signal

    from torchx_tpu_torch.schedulers.local_scheduler import LocalScheduler
    from torchx_tpu_torch.specs.api import AppDef, Role

    sched = LocalScheduler(session_name="chip_smoke_probe", cache_size=2)
    try:
        app = AppDef(name="probe", roles=[Role(name="p", image="", entrypoint="sleep",
                                               args=["60"])])
        app_id = sched.schedule(sched.submit_dryrun(app, {"log_dir": os.path.join(root,
                                                                                   "probe")}))
        (replica,) = sched._apps[app_id].replicas()
        os.killpg(replica.proc.pid, signal.SIGKILL)
        replica.proc.wait(timeout=30)
        return replica.proc.returncode
    finally:
        sched.close()


def _supervised_resume(root: str, ck: str, n: int, steps: int, a_args: list[str]) -> dict:
    """The resume of the drill's step ``n`` as a user would run it under
    the supervisor: ``tpx-torch supervise --no-lint`` (a child process)
    runs ``dist.spmd`` with A's arguments on ``h100-<cards>`` from
    ``ck``, its policy (``SUPERVISED``) resuming from ``ck`` within one
    preemption, the role's env arming ``TPX_SIMULATE_PREEMPTION_EXIT``
    with the code the scheduler records for a SIGKILLed gang. After
    attempt 1's first ``step`` line its replica's process group is
    SIGKILLed, by the pid in the scheduler's state file as ``cancel``
    finds it: a host lost without notice. -> the session's ledger, the
    CLI's output, attempt 1's first loss (from its ``step.window``
    heartbeat), attempt 2's final summary and launch marks, and the
    seconds from the kill to PREEMPTED seen, through the backoff, to
    attempt 2's first step."""
    import glob
    import signal

    import torch

    from torchx_tpu_torch.schedulers.local_scheduler import _pid_alive
    from torchx_tpu_torch.supervisor.ledger import AttemptLedger

    code = _sigkill_exit_code(root)
    logs, obs = os.path.join(root, "sup_apps"), os.path.join(root, "sup_obs")
    sup_dir, session = os.path.join(root, "supervisor"), "gangckpt"
    policy = os.path.join(root, "policy.json")
    with open(policy, "w") as f:
        json.dump({"checkpoint_dir": ck, "max_preemptions": 1,
                   "backoff_seconds": SUPERVISED["backoff_s"],
                   "poll_interval": SUPERVISED["poll_s"],
                   "hang_deadline_seconds": SUPERVISED["hang_deadline_s"],
                   "gang_check_interval": SUPERVISED["gang_check_s"]}, f)
    env = dict(os.environ, PYTHONPATH=REPO, TPX_OBS_DIR=obs, TPX_SUPERVISOR_DIR=sup_dir)
    cmd = [sys.executable, "-m", "torchx_tpu_torch.cli.main", "supervise", "--no-lint",
           "-s", "local", "-cfg", f"log_dir={logs}", "--policy", policy,
           "--session", session, "dist.spmd", "--gpu", f"h100-{torch.cuda.device_count()}",
           "--coordinator_port", "0", "--image", REPO,
           "--env", f"PYTHONPATH={REPO},TPX_SIMULATE_PREEMPTION_EXIT={code}",
           "-m", "torchx_tpu_torch.examples.train_llama", "--", *a_args,
           "--steps", str(steps - n), "--ckpt-dir", ck, "--log-every", "1"]
    ledger = AttemptLedger(session, root=sup_dir)

    def stdout_of(app_id: str) -> str:
        paths = glob.glob(os.path.join(logs, app_id, "*", "0", "stdout.log"))
        if not paths:
            return ""
        with open(paths[0], errors="replace") as f:
            return f.read()

    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=REPO, start_new_session=True)
    try:
        first = t_kill = None
        while t_kill is None:
            if time.monotonic() - t0 > SUPERVISED["limit_s"] or proc.poll() is not None:
                fail("gangckpt", "supervised: attempt 1 never reached its first step:\n"
                     + (proc.communicate()[0] if proc.poll() is not None else "")[-4000:])
            first = first or next((e for e in ledger.entries()
                                   if e["transition"] == "submitted"), None)
            if first is not None and any(x.startswith("step ") for x in
                                         stdout_of(first["app_id"]).splitlines()):
                with open(os.path.join(logs, first["app_id"], ".tpx_state.json")) as f:
                    ((replica,),) = json.load(f)["roles"].values()
                os.killpg(replica["pid"], signal.SIGKILL)
                t_kill = time.time()
            time.sleep(0.05)
        try:
            out, _ = proc.communicate(timeout=max(1.0, SUPERVISED["limit_s"]
                                                  - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            fail("gangckpt", f"supervised: no end within {SUPERVISED['limit_s']} s")
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait()
        for app in glob.glob(os.path.join(logs, "*", ".tpx_state.json")):
            with open(app) as f:  # no replica outlives the phase
                for replicas in json.load(f)["roles"].values():
                    for r in replicas:
                        if _pid_alive(r["pid"], r.get("pid_start")):  # not a reused pid
                            try:
                                os.killpg(r["pid"], signal.SIGKILL)
                            except ProcessLookupError:
                                pass
    entries = list(ledger.entries())
    submits = [e for e in entries if e["transition"] == "submitted"]
    if proc.returncode != 0 or len(submits) != 2:
        fail("gangckpt", f"supervised: exit {proc.returncode}, ledger"
             f" {[e['transition'] for e in entries]}:\n{out[-4000:]}")
    second = submits[1]
    text = stdout_of(second["app_id"])
    if "final:" not in text:
        fail("gangckpt", f"supervised: attempt 2 left no final summary:\n{text[-3000:]}")
    final = json.loads(text.split("final:", 1)[1].splitlines()[0])
    t_submit1, t_submit2 = first["time_usec"] / 1e6, second["time_usec"] / 1e6
    spans = _trace_spans(obs, since=t_submit1)
    window1 = next((sp["attrs"] for sp in spans if sp["name"] == "step.window"
                    and sp["start_epoch_usec"] / 1e6 < t_kill), {})
    slept = [(sp["end_epoch_usec"] - sp["start_epoch_usec"]) / 1e6 for sp in spans
             if sp["name"] == "supervisor.backoff"]
    resub = next(e for e in entries if e["transition"] == "resubmitting")
    marks = _launch_marks(obs, t_submit2)
    leases = glob.glob(os.path.join(obs, "*", "leases", "*.json"))
    heartbeats = sum(sp["name"] in ("job.first_step", "step.window")
                     for sp in _trace_spans(obs))
    return {"ledger": entries, "cli_output": out, "final": final,
            "attempt1_first_step": window1.get("step"),
            "attempt1_first_loss": window1.get("loss"),
            "sigkill_exit_code": code, "launch_marks_s": marks,
            "kill_to_preempted_s": resub["time_usec"] / 1e6 - t_kill,
            "backoff_s": resub["backoff_seconds"],
            "backoff_slept_s": slept[0] if slept else None,
            "resubmitted_after_s": t_submit2 - resub["time_usec"] / 1e6,
            "kill_to_attempt2_first_step_s": t_submit2 - t_kill + marks.get("first_step",
                                                                            float("nan")),
            "monitor_evidence": {"heartbeats": heartbeats, "lease_files": len(leases)},
            "session_s": time.monotonic() - t0}


def _ckpt_by_rank(final: dict) -> list[dict]:
    """Each rank's checkpoint numbers of a run: its host buffers (pinned),
    the last save's stall, the last write's split, and its restore."""
    out = []
    for ck in final["checkpoint_by_rank"]:
        row = {"buffer_bytes": ck["buffer_bytes"]}
        saves = [x for x in ck["saves"] if not x.get("rewrite_skipped")]
        if saves:
            row["snapshot_s"] = saves[-1]["snapshot_s"]
            row["snapshot_bytes"] = saves[-1]["bytes"]
        if ck["writes"]:
            row["write"] = ck["writes"][-1]
        if ck["restores"]:
            row["restore"] = ck["restores"][0]
        out.append(row)
    return out


def phase_gang_ckpt(gang_a: dict | None, gang_b: dict | None = None) -> dict:
    """A: llama3_1b at full width and depth through ``spmd_main``, one
    worker a card on NCCL, ``--mesh fsdp=-1`` (the gang phase's A run,
    which gives the uninterrupted losses), saving with ``--ckpt-dir``,
    SIGTERM to ``spmd_main`` mid-run; the step it committed passes
    ``verify_checkpoint``, and a resume on it runs the remaining steps of
    six as a supervised session (:func:`_supervised_resume`: ``tpx-torch
    supervise``, attempt 1 SIGKILLed after its first step, PREEMPTED,
    resubmitted from the step): the ledger reads submitted, resubmitting
    from the step, submitted, finished SUCCEEDED; attempt 1's first loss
    and attempt 2's losses are the uninterrupted run's (bitwise where the
    drill's own steps were, else within RESUME_RTOL); attempt 2 resumed
    from the step with the launches of its steps; the gang monitor gave no
    verdict. With four cards or
    more, the step is also restored at ``fsdp=2`` on two of them, every
    block bitwise (``_GANGCKPT_RESIZE_SCRIPT``), and continued (losses
    within REF_LOSS_RTOL: another summation order). B: two ranks at
    ``fsdp=2`` save llama3_1b cut to 2 layers (``gang_b``, the gang phase's
    B line, where it ran so: its launch saved the step; else two gloo ranks
    sharing the card, launched here at ``GANGCKPT["b_layers"]`` layers); a
    checkpointer at a world of one restores the step onto the card, every
    entry bitwise the two ranks' state. ``gang_b``'s directory is removed
    at the end. Prints each rank's checkpoint numbers and the phase's
    seconds by part."""
    import shutil
    import tempfile

    import torch

    from torchx_tpu_torch.apps.eval_main import verify_checkpoint
    from torchx_tpu_torch.examples.train_llama import checkpoint_specs
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.parallel.checkpoint import Checkpointer
    from torchx_tpu_torch.parallel.mesh import shard_extent
    from torchx_tpu_torch.parallel.mesh_config import AXES, mesh_sizes_spec, parse_mesh_spec

    t_phase = time.monotonic()
    seconds: dict[str, float] = {}
    cfg = llama.llama3_1b()
    cards = torch.cuda.device_count()
    steps = TRAIN["steps"]
    step_bytes = 3 * cfg.param_count() * torch_itemsize(cfg.dtype)
    root = tempfile.mkdtemp(prefix="tpx_gangckpt_")
    try:
        free = shutil.disk_usage(root).free
        if free < 4 * step_bytes:
            fail("gangckpt", f"{free / 1e9:.1f} GB free under {root}: the phase writes up to"
                 f" four {step_bytes / 1e9:.1f} GB steps")
        free_card()
        t0 = time.monotonic()
        if gang_a is None:
            gang_a = _gang_a(cfg, root, profiled=False)
            seconds["uninterrupted"] = time.monotonic() - t0
        ref = gang_a["losses"]
        d = os.path.join(root, "ck")
        a_args = ["--config", "llama3_1b", "--batch", str(TRAIN["batch"]), "--seq",
                  str(TRAIN["seq"]), "--kernels", "cuda", "--warmup", "1", "--mesh",
                  "fsdp=-1", "--grad-bucket-mb", str(GANG["bucket_mb"])]
        trainer = ["-m", "torchx_tpu_torch.examples.train_llama", "--"]
        t0 = time.monotonic()
        drill = _spmd_drill([], trainer + a_args + ["--steps", "1000", "--ckpt-dir", d,
                                                     "--log-every", "1"],
                            GANGCKPT["term_after"], GANGCKPT["limit_s"], "gangckpt")
        n = drill["final"]["final_step"]
        seconds["drill"] = time.monotonic() - t0
        if not (drill["final"]["preempted"] and drill["notice_printed"] and 0 < n < steps):
            fail("gangckpt", f"drill: {drill}")
        t0 = time.monotonic()
        verified, _ = verify_checkpoint(d)
        verify_s = seconds["verify_checkpoint"] = time.monotonic() - t0
        if verified != n:
            fail("gangckpt", f"verify_checkpoint: step {verified}, not {n}")
        t0 = time.monotonic()
        sup = _supervised_resume(root, _link_copy(d, d + "_resume"), n, steps, a_args)
        resume = sup["final"]
        seconds["resume"] = time.monotonic() - t0
        repeatable = drill["final"]["losses"] == ref[:n]
        bitwise = resume["losses"] == ref[n:]
        loss1 = sup["attempt1_first_loss"]
        transitions = [e["transition"] for e in sup["ledger"]]
        hangs = [t for t in transitions if t.startswith("gang_")]
        expected_2 = expected_launches(cfg, steps - n)
        res_s = {
            "phase": "gangckpt", "run": "supervised", "session": "gangckpt",
            "transitions": [
                {k: e.get(k) for k in ("transition", "attempt", "app_id", "state",
                                       "failure_class", "resume_step", "backoff_seconds")}
                for e in sup["ledger"]],
            "attempts": len([t for t in transitions if t == "submitted"]),
            "sigkill_exit_code": sup["sigkill_exit_code"],
            "kill_to_preempted_s": sup["kill_to_preempted_s"],
            "poll_interval_s": SUPERVISED["poll_s"], "backoff_s": sup["backoff_s"],
            "backoff_slept_s": sup["backoff_slept_s"],
            "resubmitted_after_s": sup["resubmitted_after_s"],
            "kill_to_attempt2_first_step_s": sup["kill_to_attempt2_first_step_s"],
            "attempt2_launch_marks_s": sup["launch_marks_s"],
            "attempt2_launch_breakdown": resume["launch_breakdown"],
            "attempt1_first_step": sup["attempt1_first_step"], "attempt1_first_loss": loss1,
            "attempt2_resumed_from_step": resume["resumed_from_step"],
            "attempt2_launches_by_rank": resume["launches_by_rank"],
            "attempt2_expected_launches": expected_2,
            "gang_verdicts": hangs, "monitor_evidence": sup["monitor_evidence"],
            "hang_deadline_s": SUPERVISED["hang_deadline_s"], "session_s": sup["session_s"],
        }
        emit(res_s)
        ledger_ok = (
            transitions == ["submitted", "resubmitting", "submitted", "finished"]
            and sup["ledger"][1].get("state") == "PREEMPTED"
            and sup["ledger"][1].get("failure_class") == "PREEMPTION"
            and sup["ledger"][1].get("resume_step") == n
            and sup["ledger"][2].get("resume_step") == n
            and sup["ledger"][3].get("state") == "SUCCEEDED")
        loss1_ok = loss1 is not None and sup["attempt1_first_step"] == n + 1 and (
            loss1 == ref[n] if repeatable else _rel_diff([loss1], ref[n:n + 1]) <= RESUME_RTOL)
        if not ledger_ok or res_s["attempts"] != 2 or hangs or not loss1_ok or \
                resume["resumed_from_step"] != n or \
                any(x != expected_2 for x in resume["launches_by_rank"]):
            fail("gangckpt", f"supervised resume from step {n}: {res_s}; attempt 1's first"
                 f" loss {loss1} against {ref[n]}\n{sup['cli_output'][-3000:]}")
        res_a = {
            "phase": "gangckpt", "run": "A", "world": drill["final"]["world"],
            "backend": drill["final"]["backend"], "mesh": drill["final"]["mesh"],
            "saved_step": n, "step_files": sorted(os.listdir(os.path.join(d, str(n)))),
            "step_bytes": sum(os.path.getsize(os.path.join(d, str(n), x))
                              for x in os.listdir(os.path.join(d, str(n)))),
            "sigterm_to_exit_s": drill["sigterm_to_exit_s"], "notice_s": CKPT["notice_s"],
            "within_notice": drill["sigterm_to_exit_s"] <= CKPT["notice_s"],
            "verify_checkpoint_s": verify_s,
            "launch_to_first_step_s": drill["final"]["launch_to_first_step_s"],
            "resume_launch_to_first_step_s": resume["launch_to_first_step_s"],
            "resume_launch_breakdown": resume["launch_breakdown"],
            "resumed_from_step": resume["resumed_from_step"],
            "drill_losses": drill["final"]["losses"], "resumed_losses": resume["losses"],
            "uninterrupted_losses": ref, "drill_steps_bitwise": repeatable,
            "resume_bitwise": bitwise,
            "resume_max_rel_diff": _rel_diff(resume["losses"], ref[n:]),
            "drill_by_rank": _ckpt_by_rank(drill["final"]),
            "resume_by_rank": _ckpt_by_rank(resume),
        }
        emit(res_a)
        if resume["resumed_from_step"] != n or (
                not bitwise if repeatable else res_a["resume_max_rel_diff"] > RESUME_RTOL):
            fail("gangckpt", f"A's resume from step {n}: {resume['losses']} against the"
                 f" uninterrupted {ref[n:]}")
        out = {"A": res_a}
        if cards >= 4:
            t0 = time.monotonic()
            r_out = os.path.join(root, "resize")
            os.makedirs(r_out)
            script = os.path.join(root, "resize_train.py")
            with open(script, "w") as f:
                f.write(_GANGCKPT_RESIZE_SCRIPT.format(
                    batch=TRAIN["batch"], seq=TRAIN["seq"], steps=steps - n,
                    bucket_mb=GANG["bucket_mb"]))
            resize, _ = _spmd(["--nproc-per-node", "2"], [
                "--script", script, "--", r_out, _link_copy(d, d + "_resize")], {},
                "gangckpt")
            seconds["resize"] = time.monotonic() - t0
            checks = []
            for r in range(resize["world"]):
                with open(os.path.join(r_out, f"restored{r}.json")) as f:
                    checks.append(json.load(f))
            res_r = {"phase": "gangckpt", "run": "resize", "from_world": res_a["world"],
                     "world": resize["world"], "mesh": resize["mesh"],
                     "resumed_from_step": resize["resumed_from_step"],
                     "restored_step_by_rank": [c["step"] for c in checks],
                     "entries_by_rank": [c["entries"] for c in checks],
                     "mismatched_by_rank": [c["mismatched"] for c in checks],
                     "restore_check_s_by_rank": [c["check_s"] for c in checks],
                     "losses": resize["losses"], "uninterrupted_losses": ref[n:],
                     "max_rel_diff": _rel_diff(resize["losses"], ref[n:]),
                     "launch_to_first_step_s": resize["launch_to_first_step_s"],
                     "by_rank": _ckpt_by_rank(resize)}
            emit(res_r)
            if (resize["resumed_from_step"] != n or res_r["max_rel_diff"] > REF_LOSS_RTOL
                    or any(c["step"] != n or c["mismatched"] or not c["entries"]
                           for c in checks)):
                fail("gangckpt", f"resize to fsdp=2: {res_r}")
            out["resize"] = res_r
        shutil.rmtree(d + "_resume", ignore_errors=True)
        shutil.rmtree(d, ignore_errors=True)
        free_card()
        # B: two ranks save (the gang phase's B where it ran as two ranks at
        # fsdp=2, else two gloo ranks sharing the card); a world of one restores
        t0 = time.monotonic()
        if gang_b is not None and (gang_b["world"], gang_b["mesh"]) == (
                2, mesh_sizes_spec(parse_mesh_spec("fsdp=2").resolve(2))):
            b_out, saved, b_layers = gang_b["out"], gang_b["final"], gang_b["n_layers"]
        else:
            b_out, b_layers = os.path.join(root, "b"), GANGCKPT["b_layers"]
            saved = _b_save(b_out, b_layers, GANGCKPT["b_steps"], 2, "gloo", "fsdp=2",
                            "gangckpt")
        cfg_b = llama.llama3_1b(n_layers=b_layers)
        specs = checkpoint_specs(cfg_b)
        sizes = parse_mesh_spec("fsdp=2").resolve(2)
        whole: dict = {}
        for r in range(2):
            coords = {a: (r if a == "fsdp" else 0) for a in AXES}
            for k, v in torch.load(os.path.join(b_out, f"rank{r}.pt")).items():
                spec = specs.get(k, (None,) * v.dim())
                shape = tuple(n_ * (2 if ax == "fsdp" else 1) for n_, ax in zip(v.shape, spec))
                if k not in whole:
                    whole[k] = torch.empty(shape, dtype=v.dtype)
                whole[k][shard_extent(spec, shape, sizes, coords)] = v
        live = {k: torch.empty_like(v, device="cuda") for k, v in whole.items()}
        one = Checkpointer(os.path.join(b_out, "ck"))
        restored_step, _ = one.restore_latest(into=live)
        one.close()
        mismatched = sorted(k for k in whole if not torch.equal(live[k].cpu(), whole[k]))
        seconds["B"] = time.monotonic() - t0
        res_b = {"phase": "gangckpt", "run": "B", "n_layers": b_layers,
                 "saved_by": "gang phase B" if b_out != os.path.join(root, "b") else "gangckpt",
                 "ranks_share_a_card": saved["backend"] == "gloo", "backend": saved["backend"],
                 "world": saved["world"], "mesh": saved["mesh"],
                 "saved_step": saved["final_step"],
                 "save_launch_to_first_step_s": saved["launch_to_first_step_s"],
                 "save_step_times_s": saved["step_times_s"], "restored_world": 1,
                 "restored_step": restored_step,
                 "entries": len(whole), "entries_bitwise": len(whole) - len(mismatched),
                 "save_by_rank": _ckpt_by_rank(saved), "restore": one.restores}
        emit(res_b)
        if saved["world"] != 2 or restored_step != saved["final_step"] or mismatched:
            fail("gangckpt", f"B: {res_b}; entries not bitwise: {mismatched[:5]}")
        out["B"] = res_b
        seconds["total"] = time.monotonic() - t_phase
        emit({"phase": "gangckpt", "run": "seconds", **seconds})
        out["seconds"] = seconds
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if gang_b is not None:
            shutil.rmtree(gang_b["out"], ignore_errors=True)


# ---------------------------------------------------------------------------
# the tp phase: the model axes tp and sp
# ---------------------------------------------------------------------------

#: One card: llama3_1b at full width cut to ``layers`` layers, ``steps``
#: steps on the train phase's batch, each mesh of ``meshes`` on two gloo
#: ranks sharing the card (NCCL refuses two ranks on one card), all in one
#: ``spmd_main`` launch. Four cards or more: NCCL at full depth, ``steps4``
#: steps, llama3_1b at each mesh of ``meshes4`` (``fsdp=4`` the one the
#: others are held to) and llama3_8b at ``mesh8b``.
TP = dict(layers=2, steps=3, meshes=("tp=2", "sp=2"), steps4=6,
          meshes4=("fsdp=4", "tp=4", "fsdp=2,tp=2", "dp=2,sp=2"), mesh8b="fsdp=2,tp=2")

#: The runs' script under ``spmd_main``: each run of the JSON in argv[1]
#: (config, layers or null for full depth, mesh, steps, and optionally
#: ``profile``, default true, ``dtype``, ``kernels``, ``remat_policy``,
#: ``ring`` (ring attention), ``batch`` and ``seq``, default the config's,
#: "cuda", the config's, off and the job's) through
#: ``train_llama.train`` with the step profiler and
#: its torch.profiler trace, the card's cache emptied after each; a run of
#: ``kind`` ``attn`` is :data:`_ATTN_CHECK` instead. Rank 0 prints every
#: run's results and seconds on one ``final:`` line.
_TP_SCRIPT = """import gc, json, os, sys, time
import torch
import torch.distributed as dist
from torchx_tpu_torch.examples import train_llama
from torchx_tpu_torch.models import llama
job = json.loads(sys.argv[1])
out = []
{attn_check}
for run in job["runs"]:
    if run.get("kind") == "attn":
        out.append(attn_check(run))
        continue
    kw = {{"n_layers": run["layers"]}} if run["layers"] else {{}}
    if run.get("dtype"):
        kw["dtype"] = getattr(torch, run["dtype"])
    if run.get("remat_policy"):
        kw.update(remat=True, remat_policy=run["remat_policy"])
    if run.get("ring"):
        kw["use_ring_attention"] = True
    cfg = llama.all_configs()[run["config"]](**kw)
    profiled = run.get("profile", True)
    t0 = time.monotonic()
    res = train_llama.train(cfg, run.get("batch", job["batch"]), run.get("seq", job["seq"]),
                            run["steps"],
                            kernels=run.get("kernels", "cuda"),
                            device="cuda", warmup=1, log_every=0, mesh=run["mesh"],
                            profile=profiled,
                            profile_dir=os.path.join(job["root"], run["name"]) if profiled
                            else None)
    out.append({{k: res.get(k) for k in ("losses", "grad_norms", "step_times_s", "step_time_s",
                                       "tokens_per_sec_per_card", "mfu", "world", "mesh",
                                       "backend", "launches_by_rank", "peak_memory_bytes_by_rank",
                                       "profile_trace", "router_aux", "router_entropy",
                                       "router_overflow", "launch_breakdown", "remat_policy",
                                       "remat_trials")}})
    out[-1]["comm_modeled_axis_s"] = res["profile"]["meta"]["comm_modeled_axis_s"] \
        if res["profile"] else None
    out[-1]["seconds"] = time.monotonic() - t0
    del res
    gc.collect()
    torch.cuda.empty_cache()  # the next run's model starts on a clean card
if dist.get_rank() == 0:
    print("final:" + json.dumps(out), flush=True)
"""

#: A run of ``kind`` ``attn`` in :data:`_TP_SCRIPT`: ``ring_attention`` and
#: ``ulysses_attention`` in f32 over the run's mesh on seeded q, k, v of
#: ``shape`` (b, s, heads, kv heads, head_dim), the same on every rank;
#: each rank's positions of the output and of dq (the sum of the output's
#: squares) against the plain whole-sequence attention on the card, every
#: rank's maximum errors gathered, with each op's forward-and-backward
#: seconds.
_ATTN_CHECK = """def attn_check(run):
    from torchx_tpu_torch.ops.attention import xla_attention
    from torchx_tpu_torch.ops.ring_attention import ring_attention
    from torchx_tpu_torch.ops.ulysses import ulysses_attention
    from torchx_tpu_torch.parallel.mesh import make_mesh
    from torchx_tpu_torch.parallel.mesh_config import parse_mesh_spec
    t0 = time.monotonic()
    mesh = make_mesh(parse_mesh_spec(run["mesh"]))
    b, s, h, kvh, d = run["shape"]
    gen = torch.Generator(device="cuda").manual_seed(run["seed"])
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda") for n in (h, kvh, kvh))
    pos = mesh.positions(s)
    whole = q.clone().requires_grad_(True)
    ref = xla_attention(whole, k, v, causal=True)
    (ref ** 2).sum().backward()
    ref, ref_dq = ref.detach()[:, pos], whole.grad[:, pos]
    del whole
    mine = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        ql = q[:, pos].clone().requires_grad_(True)
        torch.cuda.synchronize()
        t = time.monotonic()
        o = fn(ql, k[:, pos].contiguous(), v[:, pos].contiguous(), mesh)
        (o ** 2).sum().backward()
        torch.cuda.synchronize()
        mine[name] = {"max_abs_err": (o.detach() - ref).abs().max().item(),
                      "dq_max_abs_err": (ql.grad - ref_dq).abs().max().item(),
                      "fwd_bwd_s": time.monotonic() - t}
        del o, ql
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, mine)
    del q, k, v, ref, ref_dq
    gc.collect()
    torch.cuda.empty_cache()
    return {"kind": "attn", "mesh": run["mesh"], "shape": run["shape"], "by_rank": by_rank,
            "seconds": time.monotonic() - t0}
"""


def collectives_by_group(events: list[dict], steps: int) -> dict:
    """The collectives of a torch.profiler Chrome trace by group: the
    port's ``collective:<axes>`` ranges (``parallel/mesh.py``
    ``collective_range``), each group's host milliseconds a step (the
    ranges' own durations) and device milliseconds a step (the GPU events
    launched inside them, matched by correlation id: NCCL's kernels, or
    gloo's copies between the card and the host)."""
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"][len("collective:"):])
             for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("collective:")]
    host: dict[str, float] = {}
    for _, a, b, name in spans:
        host[name] = host.get(name, 0.0) + (b - a) / 1e3 / steps
    by_corr: dict[int, str] = {}
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or \
                "correlation" not in e.get("args", {}):
            continue
        around = [(b - a, n) for tid, a, b, n in spans if tid == e["tid"] and a <= e["ts"] <= b]
        if around:
            by_corr[e["args"]["correlation"]] = min(around)[1]
    device: dict[str, float] = {}
    for e in events:
        name = by_corr.get(e.get("args", {}).get("correlation"))
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and name is not None:
            device[name] = device.get(name, 0.0) + e["dur"] / 1e3 / steps
    return {"host_ms_per_step": host, "device_ms_per_step": device,
            "ranges": len(spans) // max(steps, 1)}


def _tp_runs(runs: list[dict], ranks: int, backend: str, phase: str = "tp",
             probe: bool = False, timeout_s: float | None = None) -> list[dict]:
    """``runs`` in one ``spmd_main`` launch of ``ranks`` ranks on
    ``backend``; each run's results with its collectives by group (rank
    0's trace, for a profiled run) and the cost model's bytes a step by
    axis; with ``probe``, the fit probe's rank-0 peak (traced in a
    subprocess, no card) and ``hbm_fit``'s total beside each rank's
    measured peak."""
    import shutil
    import tempfile

    from torchx_tpu_torch.analyze import costmodel
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.parallel.mesh_config import parse_mesh_spec

    root = tempfile.mkdtemp(prefix=f"tpx_{phase}_smoke_")
    try:
        script = os.path.join(root, "tp_runs.py")
        with open(script, "w") as f:
            f.write(_TP_SCRIPT.format(attn_check=_ATTN_CHECK))
        job = {"runs": runs, "batch": TRAIN["batch"], "seq": TRAIN["seq"], "root": root}
        finals, _ = _spmd(["--nproc-per-node", str(ranks), "--backend", backend],
                          ["--script", script, "--", json.dumps(job)], {}, phase,
                          timeout_s=timeout_s)
        for run, final in zip(runs, finals):
            if run.get("kind") == "attn":
                continue
            trace = final.pop("profile_trace")
            if trace:
                with open(trace) as f:
                    events = json.load(f)["traceEvents"]
                final["collectives"] = collectives_by_group(events, run["steps"] - 1)
            kw = {"n_layers": run["layers"]} if run["layers"] else {}
            if run.get("dtype"):
                import torch

                kw["dtype"] = getattr(torch, run["dtype"])
            batch, seq = run.get("batch", TRAIN["batch"]), run.get("seq", TRAIN["seq"])
            cfg = llama.all_configs()[run["config"]](
                **kw, use_ring_attention=bool(run.get("ring")), max_seq=seq)
            plan = costmodel.ParallelPlan(
                model=costmodel.ModelShape.of(cfg), batch=batch, seq=seq,
                sizes=parse_mesh_spec(run["mesh"]).resolve(ranks),
                ring_attention=bool(run.get("ring")))
            final["modeled_bytes_per_step"] = {
                t.axis: t.bytes_per_step for t in costmodel.collective_traffic(plan)}
            final["hbm_fit_total_bytes"] = costmodel.hbm_fit(plan).total_bytes
            run["cfg"] = cfg
        if probe:
            import dataclasses

            from torchx_tpu_torch.parallel import aot_fit

            trained = [(run, final) for run, final in zip(runs, finals)
                       if run.get("kind") != "attn"]
            requests = [aot_fit.probe_request(
                dataclasses.replace(run.pop("cfg"), kernels=run.get("kernels", "cuda")),
                run["mesh"], run.get("batch", TRAIN["batch"]), run.get("seq", TRAIN["seq"]),
                devices=ranks) for run, _ in trained]
            for (_, final), r in zip(trained, aot_fit.run_probe(requests)):
                final["probe_peak_bytes_rank0"] = r.get("peak_bytes", r.get("error"))
        for run in runs:
            run.pop("cfg", None)
        return finals
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_tp(one: dict | None, extra: list[dict] = ()) -> tuple[dict, list[dict]]:
    """The model axes (module docstring). ``one``: the one-process run of
    llama3_1b at ``TP["layers"]`` layers and ``TP["steps"]`` steps on the
    train phase's batch (the ``one_process_*`` entries of the gang phase's
    B line), made here when None. ``extra``: runs of another phase that
    share the launch of two gloo ranks (the ep phase's), after the tp
    phase's own. -> (the tp lines by mesh, the extra runs' results)."""
    import torch

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.parallel.mesh_config import mesh_sizes_spec, parse_mesh_spec

    t0 = time.monotonic()
    cards = torch.cuda.device_count()
    if cards >= 4:
        return phase_tp_cards(), []
    cfg = llama.llama3_1b(n_layers=TP["layers"])
    if one is None:
        free_card()
        run = train(cfg, TRAIN["batch"], TRAIN["seq"], TP["steps"], kernels="cuda",
                    device="cuda", warmup=1, log_every=0)
        one = {"one_process_" + k: run[k] for k in
               ("losses", "grad_norms", "step_time_s", "peak_memory_bytes")}
    free_card()
    runs = [{"name": m.replace("=", ""), "config": "llama3_1b", "layers": TP["layers"],
             "mesh": m, "steps": TP["steps"]} for m in TP["meshes"]]
    finals = _tp_runs(runs + list(extra), 2, "gloo")
    finals, extra_finals = finals[:len(runs)], finals[len(runs):]
    expected = expected_launches(cfg, TP["steps"])
    out = {}
    for run, final in zip(runs, finals):
        loss_rel = _rel_diff(final["losses"], one["one_process_losses"])
        gn_rel = _rel_diff(final["grad_norms"], one["one_process_grad_norms"])
        res = {"phase": "tp", "mesh": final["mesh"], "config": "llama3_1b",
               "n_layers": TP["layers"], "steps": TP["steps"], "cards": cards,
               "ranks_share_a_card": True, "backend": final["backend"],
               "world": final["world"], "losses": final["losses"], **one,
               "loss_max_rel_diff": loss_rel, "loss_rtol": REF_LOSS_RTOL,
               "grad_norms": final["grad_norms"], "grad_norm_max_rel_diff": gn_rel,
               "grad_norm_rtol": REF_GRAD_NORM_RTOL,
               "profiled_step_times_s": final["step_times_s"],
               "profiled_step_time_s": final["step_time_s"],
               "peak_memory_bytes_by_rank": final["peak_memory_bytes_by_rank"],
               "collectives_rank0": final["collectives"],
               "modeled_bytes_per_step": final["modeled_bytes_per_step"],
               "modeled_grad_sync_s_per_step": final["comm_modeled_axis_s"],
               "launches_by_rank": final["launches_by_rank"], "expected_launches": expected}
        emit(res)
        want = mesh_sizes_spec(parse_mesh_spec(run["mesh"]).resolve(2))
        if (final["world"], final["backend"], final["mesh"]) != (2, "gloo", want):
            fail("tp", f"{run['mesh']} ran {final['world']} ranks on {final['backend']} as"
                 f" {final['mesh']}")
        if loss_rel > REF_LOSS_RTOL or gn_rel > REF_GRAD_NORM_RTOL:
            fail("tp", f"{run['mesh']}: {final['losses']} / {final['grad_norms']} against one"
                 f" process {one['one_process_losses']} / {one['one_process_grad_norms']}")
        if any(launches != expected for launches in final["launches_by_rank"]):
            fail("tp", f"{run['mesh']}: launches {final['launches_by_rank']} != {expected}")
        out[run["mesh"]] = res
    emit({"phase": "tp", "run": "seconds", "seconds": time.monotonic() - t0
          - sum(f["seconds"] for f in extra_finals)})
    return out, extra_finals


def phase_tp_cards() -> dict:
    """Four cards or more: NCCL at full depth, one rank a card on four.
    llama3_1b at each mesh of ``TP["meshes4"]`` (losses within
    REF_LOSS_RTOL of ``fsdp=4``'s on the same batches) and llama3_8b at
    ``TP["mesh8b"]``; for each the step time, tokens/s a card, MFU, peak
    memory a rank, the collectives by group and the modeled bytes."""
    t0 = time.monotonic()
    free_card()
    runs = [{"name": m.replace("=", "").replace(",", "_"), "config": "llama3_1b",
             "layers": None, "mesh": m, "steps": TP["steps4"]} for m in TP["meshes4"]]
    runs.append({"name": "llama3_8b", "config": "llama3_8b", "layers": None,
                 "mesh": TP["mesh8b"], "steps": TP["steps4"]})
    finals = _tp_runs(runs, 4, "nccl", probe=True)
    base = finals[0]
    out = {}
    for run, final in zip(runs, finals):
        same_model = run["config"] == "llama3_1b"
        rel = _rel_diff(final["losses"], base["losses"]) if same_model else None
        res = {"phase": "tp", "cards": 4, "config": run["config"], "mesh": final["mesh"],
               "backend": final["backend"], "world": final["world"],
               "losses": final["losses"], "grad_norms": final["grad_norms"],
               "loss_max_rel_diff_vs_fsdp4": rel,
               "profiled_step_times_s": final["step_times_s"],
               "profiled_step_time_s": final["step_time_s"],
               "tokens_per_sec_per_card": final["tokens_per_sec_per_card"], "mfu": final["mfu"],
               "peak_memory_bytes_by_rank": final["peak_memory_bytes_by_rank"],
               "probe_peak_bytes_rank0": final["probe_peak_bytes_rank0"],
               "hbm_fit_total_bytes": final["hbm_fit_total_bytes"],
               "collectives_rank0": final["collectives"],
               "modeled_bytes_per_step": final["modeled_bytes_per_step"],
               "launches_by_rank": final["launches_by_rank"]}
        emit(res)
        if final["backend"] != "nccl" or final["world"] != 4:
            fail("tp", f"{run['mesh']} ran {final['world']} ranks on {final['backend']}")
        if not all(math.isfinite(x) for x in final["losses"]):
            fail("tp", f"{run['config']} {run['mesh']}: non-finite loss {final['losses']}")
        if same_model and rel > REF_LOSS_RTOL:
            fail("tp", f"{run['mesh']} losses {final['losses']} against fsdp=4's"
                 f" {base['losses']}")
        out[f"{run['config']} {run['mesh']}"] = res
    emit({"phase": "tp", "run": "seconds", "seconds": time.monotonic() - t0})
    return out


# ---------------------------------------------------------------------------
# phase 5: serving
# ---------------------------------------------------------------------------

#: The serve phase's traffic: (prompt length, temperature, seed) of the 8
#: concurrent requests; the two sampled ones share one prompt.
SERVE_REQUESTS = [(32, 0.0, 0), (100, 0.8, 7), (100, 0.8, 7), (257, 0.0, 0),
                  (512, 0.0, 0), (700, 0.0, 0), (1024, 0.0, 0), (1500, 0.0, 0)]
SERVE = dict(max_batch=8, block_size=16, new_tokens=64, seed=0)
#: A greedy token's logit may lie this far below its row's maximum when
#: the sequence is teacher-forced through the plain KV-cache path in bf16:
#: the engine (paged attention, grouped rows) and the plain path round
#: differently, and a near-tie may go either way.
SERVE_LOGIT_GAP = 5e-2
#: The share of a MoE model's greedy tokens that must lie within
#: SERVE_LOGIT_GAP: its router picks each token's experts discontinuously,
#: and where a token's top_k-th and next router probabilities nearly tie,
#: bf16 rounding that differs between the engine and the plain path picks
#: another expert for it (the serve line prints the router margin at each
#: token beyond the tolerance beside all positions' quartiles; PERF.md has
#: the measurement). The f32 check at 2 layers holds the engine to the
#: plain path exactly. The int8 cell holds the same share: at llama3_8b's
#: 32 layers the kernel's bf16 outputs, summed in another order than the
#: plain int8 path's, move near-tied logits past 5e-2 (PERF.md, PR 8).
SERVE_MOE_GAP_SHARE = 0.9
#: Prompts (by index into SERVE_REQUESTS) of the exact f32 check at 2 layers.
F32_PROMPTS = (0, 3, 5)


def _serve_prompts(vocab: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(SERVE["seed"])
    prompts, by_len = [], {}
    for n, _, _ in SERVE_REQUESTS:
        if n not in by_len:
            by_len[n] = [int(t) for t in rng.integers(0, vocab, n)]
        prompts.append(by_len[n])
    # the 1024-token prompt opens with the 512-token one
    prompts[6] = prompts[4] + prompts[6][512:]
    return prompts


def _post(port: int, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _post_raw(port: int, path: str, raw: bytes) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=raw, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get(port: int, path: str) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _teacher_forced_gaps(params, cfg, prompt, completion, width):  # noqa: ANN001, ANN202
    """Per generated token: (row max - the token's logit, argmax matched),
    the sequence teacher-forced through the plain KV-cache path
    (``models.generate.forward_with_cache``) in the engine's chunks: the
    prompt prefilled at its bucket ``width`` (padded after its last
    token), then one token at a time. A GShard MoE layer's capacity
    follows the chunk's width, so a token's experts (and which routings
    drop) depend on the chunk it is computed in. -> (gaps, matched,
    margins): for a MoE config ``margins`` holds, per generated token, the
    smallest router margin over the layers at the position whose logits
    chose it (the top_k-th router probability less the next one), else
    None."""
    import torch

    from torchx_tpu_torch.models import generate as gen
    from torchx_tpu_torch.models import moe

    calls: list = []
    route = moe.route
    if getattr(cfg, "n_experts", 0):
        def recording_route(cfg_, layer, x, *rest):  # noqa: ANN001, ANN002, ANN202
            probs = torch.softmax(x.float() @ layer["w_router"].float(), dim=-1)
            top = probs.topk(cfg_.top_k + 1, dim=-1).values
            calls.append((top[..., -2] - top[..., -1])[0])
            return route(cfg_, layer, x, *rest)

        moe.route = recording_route
    try:
        t = len(prompt)
        cache = gen.init_kv_cache(cfg, 1, max(width, t + len(completion)), "cuda")
        padded = torch.tensor([prompt + [0] * (width - t)], device="cuda")
        logits, _ = gen.forward_with_cache(params, padded, cache, 0, cfg)
        rows = [logits[0, t - 1]]
        for i, tok in enumerate(completion[:-1]):
            step, _ = gen.forward_with_cache(
                params, torch.tensor([[tok]], device="cuda"), cache, t + i, cfg)
            rows.append(step[0, 0])
    finally:
        moe.route = route
    logits = torch.stack(rows)
    tok = torch.tensor(completion, device="cuda")
    chosen = logits.gather(1, tok[:, None])[:, 0]
    gaps = (logits.max(dim=1).values - chosen).tolist()
    matched = (logits.argmax(dim=1) == tok).tolist()
    margins = None
    if calls:
        # the prefill's n_layers calls, then n_layers per decode step
        L = cfg.n_layers
        first = torch.stack(calls[:L]).amin(0)[t - 1:t]
        steps = torch.stack([torch.cat(calls[L + i * L:L + (i + 1) * L]).amin()
                             for i in range(len(completion) - 1)])
        margins = torch.cat([first, steps]).tolist()
    return gaps, matched, margins


#: The serving path's TTFT histogram (the ``p99-ttft`` SLO preset's metric).
TTFT_METRIC = "tpx_serve_ttft_seconds"


class _Scrape:
    """A telemetry ``Collector`` over a fresh ``MetricStore`` with one
    ``/metricz`` target at ``url`` and no textfile sessions (this process's
    own textfile holds the same registry), on a clock of one second a
    scrape. :meth:`once` scrapes; ``seconds`` holds each scrape's."""

    def __init__(self, url: str, phase: str) -> None:
        import tempfile

        from torchx_tpu_torch.obs.telemetry import Collector, MetricStore

        self.now, self.phase, self.seconds = 0.0, phase, []
        self.store = MetricStore(clock=lambda: self.now)
        self.collector = Collector(self.store, interval_s=3600.0,
                                   obs_dir=tempfile.mkdtemp(prefix="tpx_no_sessions_"),
                                   clock=lambda: self.now)
        self.collector.add_target(url, name="replica-0")

    def once(self) -> None:
        self.now += 1.0
        t = time.perf_counter()
        n = self.collector.collect_once()
        self.seconds.append(time.perf_counter() - t)
        if self.collector.errors or not n:
            fail(self.phase, f"scrape of /metricz: {n} samples, {self.collector.errors}")


def _ttft_scrape_check(scrape: _Scrape, ttft_s: list[float]) -> dict:
    """The TTFT histogram's deltas between the scrape's two ingests against
    the replies' own TTFTs: every bucket's count, the count above 0.5 s
    (the ``p99-ttft`` threshold), the store's p50 against the bucket of
    the replies' p50 (the histogram's rank, ``ceil(n / 2)``), and the
    ``p99-ttft`` preset's error fraction, evaluated once by an ``SloEngine``
    over the store, against the replies' share above 0.5 s."""
    from torchx_tpu_torch.obs.slo import SloEngine, parse_slo

    (deltas,) = scrape.store.histogram_deltas(TTFT_METRIC, None).values()
    want = [(le, float(sum(t <= le for t in ttft_s))) for le, _ in deltas]
    above = deltas[-1][1] - dict(deltas)[0.5]
    own = sorted(ttft_s)[math.ceil(len(ttft_s) / 2) - 1]
    lo = max([0.0] + [le for le, _ in deltas if le < own])
    hi = min(le for le, _ in deltas if le >= own)
    (p50,) = scrape.store.percentile(TTFT_METRIC, 50).values()
    slo = SloEngine(scrape.store, [parse_slo("p99-ttft")], clock=lambda: scrape.now)
    slo.evaluate()
    burn_short, burn_long = slo.burns()["p99-ttft"]
    share = sum(t > 0.5 for t in ttft_s) / len(ttft_s)
    fraction = burn_long * slo.specs[0].budget

    def le_(x: float):  # noqa: ANN202 - JSON has no infinity
        return x if math.isfinite(x) else "+Inf"

    return {"requests": len(ttft_s), "bucket_deltas": [[le_(le), d] for le, d in deltas],
            "bucket_deltas_equal": deltas == want, "above_0_5_s": above,
            "replies_above_0_5_s": sum(t > 0.5 for t in ttft_s),
            "above_0_5_s_equal": above == sum(t > 0.5 for t in ttft_s),
            "p50_estimate_s": p50, "replies_p50_s": own, "p50_bucket_s": [lo, le_(hi)],
            "p50_in_bucket": lo <= p50 <= hi, "burn_short": burn_short,
            "burn_long": burn_long, "error_fraction": fraction,
            "replies_above_0_5_s_share": share,
            "slo_equal": abs(burn_short - burn_long) <= 1e-12 and abs(fraction - share) <= 1e-9,
            "scrape_s": scrape.seconds}


def _percentile(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def phase_serve(config: str = "llama3_1b", phase: str = "serve", f32_cfg=None,  # noqa: ANN001
                f32_prompts: tuple = F32_PROMPTS, prefix_cache: bool = True,
                int8: bool | None = None, inspect=None) -> dict:  # noqa: ANN001
    """The serving path at ``config``'s full width (module docstring, phase
    5; the moe phase passes a Mixtral config cut in depth, without the
    prefix cache, its f32 prompts those whose length is their prefill
    bucket's width). ``f32_cfg()`` builds the 2-layer f32 config of the
    exact check (llama3_1b's by default).

    The int8 phase passes ``int8``: False for its bf16 run, True for the
    server's ``--int8``. Then the f32 check and the re-send's equality are
    left to the serve phase (a llama3_8b re-send's answer is printed), the
    greedy tokens are held to the MoE cell's share, the bf16 run's are not
    teacher-forced, and the int8 run's are, through the plain int8 path;
    its burst launches the int8-weight matmul for each projection and an
    untied lm head of every decode step and prefill chunk, and never the
    plain int8 path on the card. ``inspect(run)`` adds numbers while the
    server is up. -> the serve line's numbers."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.apps import generate_server
    from torchx_tpu_torch.models import generate as gen
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.ops import quant
    from torchx_tpu_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    free_card()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    # the plain int8 path must never run on the card while the server does
    plain_int8 = quant._int8_matmul_plain
    plain_on_card: list[tuple] = []

    def guarded_plain(x, *args, **kw):  # noqa: ANN001, ANN202
        if x.is_cuda:
            plain_on_card.append(tuple(x.shape))
        return plain_int8(x, *args, **kw)

    quant._int8_matmul_plain = guarded_plain
    # threads an earlier run left alive share the host with this one
    threads_at_start = sorted(t.name for t in threading.enumerate())
    allocated0 = torch.cuda.memory_allocated()
    t_setup = time.monotonic()
    server = generate_server.serve(
        config, port=0, device="cuda", max_batch=SERVE["max_batch"],
        block_size=SERVE["block_size"], enable_prefix_cache=prefix_cache, int8=bool(int8))
    setup_peak = torch.cuda.max_memory_allocated()
    setup_allocated = torch.cuda.memory_allocated() - allocated0
    service = server.service
    engine = service._engine
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    cfg, params = service.cfg, service.params
    setup_s = time.monotonic() - t_setup

    # time every decode step of the engine's loop with its active slots
    steps: list[tuple[int, float]] = []
    decode_once = engine._decode_once

    # and the int8-weight matmul's launches of each decode step and prefill
    step_int8: list[int] = []
    prefill_int8: list[int] = []

    def int8_launches() -> int:
        return _build.launch_counts()["int8_matmul"]

    def timed_decode() -> bool:
        active = sum(s is not None for s in engine._slots)
        n0 = int8_launches()
        t0 = time.perf_counter()
        worked = decode_once()
        if worked:
            steps.append((active, time.perf_counter() - t0))
            step_int8.append(int8_launches() - n0)
        return worked

    engine._decode_once = timed_decode
    # and every prefill group: (rows, bucket width, seconds to its tokens)
    prefills: list[tuple[int, int, float]] = []
    prefill_chunk = gen.paged_prefill_chunk

    def timed_prefill(params_, tokens, *args):  # noqa: ANN001, ANN202
        n0 = int8_launches()
        t0 = time.perf_counter()
        first = prefill_chunk(params_, tokens, *args).cpu()
        prefills.append((*tokens.shape, time.perf_counter() - t0))
        prefill_int8.append(int8_launches() - n0)
        return first

    gen.paged_prefill_chunk = timed_prefill
    # the measured batch arrives as one burst: admission waits until all
    # of it is queued (otherwise the first arrival is prefilled alone)
    gate = threading.Event()
    gate.set()
    admit = engine._admit

    def gated_admit() -> bool:
        gate.wait()
        return admit()

    engine._admit = gated_admit
    try:
        prompts = _serve_prompts(cfg.vocab_size)
        n_new = SERVE["new_tokens"]
        bodies = [{"tokens": [p], "max_new_tokens": n_new, "temperature": t, "seed": sd}
                  for p, (_, t, sd) in zip(prompts, SERVE_REQUESTS)]
        # one short request first: cuBLAS and the allocator warm up outside
        # the measured batch
        _post(port, {"tokens": [[1, 2, 3]], "max_new_tokens": 2})
        # the server's /metricz into a telemetry store, before and after
        scrape = _Scrape(f"http://127.0.0.1:{port}", phase)
        scrape.once()
        steps.clear()
        prefills.clear()
        step_int8.clear()
        prefill_int8.clear()
        gate.clear()
        launches0 = _build.launch_counts()
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(bodies)) as pool:
            futures = [pool.submit(_post, port, b) for b in bodies]
            deadline = time.monotonic() + 60
            while engine.queue_depth < len(bodies) and time.monotonic() < deadline:
                time.sleep(0.001)
            gate.set()
            replies = [f.result() for f in futures]
        batch_s = time.monotonic() - t0
        scrape.once()
        burst_launches = {k: v - launches0[k] for k, v in _build.launch_counts().items()}
        burst_steps, burst_prefills = list(steps), list(prefills)
        burst_int8 = {"decode": list(step_int8), "prefill": list(prefill_int8)}
        full_steps = [dt for active, dt in burst_steps if active == SERVE["max_batch"]]
        outs = [r["tokens"][0] for r in replies]
        completions = [o[len(p):] for o, p in zip(outs, prompts)]
        if any(len(c) != n_new for c in completions):
            fail(phase, f"completion lengths {[len(c) for c in completions]} != {n_new}")

        # sampled: the same-seed pair agrees, seed 8 differs
        seed8 = _post(port, {**bodies[1], "seed": 8})["tokens"][0][len(prompts[1]):]
        # prefix cache: a greedy re-send hits and equals its cold answer
        # (the shortest prompt: its cold and warm prefills differ least in
        # width, so bf16 rounding differs least)
        no_cache = {"hits": 0}
        hits0 = engine.stats().get("prefix_cache", no_cache)["hits"]
        resend = _post(port, bodies[0])["tokens"][0]
        prefix = engine.stats().get("prefix_cache", no_cache)
        health_code, health = _get(port, "/healthz")
        metric_code, metricz = _get(port, "/metricz")
        peak = torch.cuda.max_memory_allocated()
        pool_bytes = sum(t.numel() * t.element_size() for t in engine.pools.values())
        on_card = all(t.is_cuda for t in list(engine.pools.values()) + llama.leaves(params))

        quant._int8_matmul_plain = plain_int8  # the plain path runs on purpose below
        # while the server's state is the burst's (before the teacher
        # forcing below allocates its large temporaries)
        extra = inspect(dict(engine=engine, cfg=cfg, params=params, prompts=prompts,
                             completions=completions, setup_allocated=setup_allocated,
                             port=port, bodies=bodies, gate=gate, steps=steps)
                        ) if inspect else {}
        # greedy, bf16, full depth: teacher-forced logit gaps (an int8
        # tree's through the plain int8 path)
        moe = bool(getattr(cfg, "n_experts", 0))
        gaps, matched, margins = [], [], []
        kernel_int8, gen_int8 = quant.int8_matmul, gen.int8_matmul
        if int8:
            quant.int8_matmul = gen.int8_matmul = plain_int8
        try:
            for i, (_, temp, _) in enumerate(SERVE_REQUESTS):
                if temp == 0 and int8 is not False:
                    g, m, r = _teacher_forced_gaps(params, cfg, prompts[i], completions[i],
                                                   engine._bucket_width(len(prompts[i])))
                    gaps += g
                    matched += m
                    margins += r or []
        finally:
            quant.int8_matmul, gen.int8_matmul = kernel_int8, gen_int8
    finally:
        quant._int8_matmul_plain = plain_int8
        gen.paged_prefill_chunk = prefill_chunk
        server.shutdown()
        service.close()
        server.server_close()
    launches = _build.launch_counts()
    ttft = [r["timing"]["ttft_ms"] for r in replies]
    tpot = [(r["timing"]["total_ms"] - r["timing"]["ttft_ms"]) / (n_new - 1) for r in replies]
    out = {
        "phase": phase, "run": "serve", "config": config, "n_layers": cfg.n_layers,
        "dim": cfg.dim, "params": cfg.param_count(),
        "dtype": "bfloat16", "int8": bool(int8), "engine": "continuous", "setup_s": setup_s,
        "threads_at_start": threads_at_start,
        "param_bytes": quant.size_bytes(params), "setup_allocated_bytes": setup_allocated,
        "setup_peak_bytes": setup_peak,
        "requests": len(replies), "new_tokens": n_new,
        "prompt_lens": [n for n, _, _ in SERVE_REQUESTS],
        "ttft_ms": ttft, "ttft_p50_ms": _percentile(ttft, 0.5), "ttft_max_ms": max(ttft),
        "ttft_1500_ms": ttft[7], "tpot_ms": tpot, "tpot_p50_ms": _percentile(tpot, 0.5),
        "tpot_max_ms": max(tpot),
        "decode_steps": len(burst_steps), "full_steps": len(full_steps),
        "decode_step_full_ms": 1e3 * sum(full_steps) / max(1, len(full_steps)),
        "decode_ms_total": 1e3 * sum(dt for _, dt in burst_steps),
        "prefills": [{"rows": r, "width": w, "ms": 1e3 * dt} for r, w, dt in burst_prefills],
        "batch_s": batch_s, "tokens_per_s": len(replies) * n_new / batch_s,
        "peak_memory_bytes": peak,
        "pool": {"num_blocks": engine.num_blocks, "block_size": engine.block_size,
                 "blocks_per_slot": engine.blocks_per_slot, "max_slots": engine.max_slots,
                 "bytes": pool_bytes},
        "greedy_max_logit_gap": max(gaps, default=None), "greedy_gap_tol": SERVE_LOGIT_GAP,
        "greedy_within_tol_share": sum(g <= SERVE_LOGIT_GAP for g in gaps) / len(gaps)
        if gaps else None,
        "greedy_path": ("plain int8" if int8 else "plain") if gaps else None,
        # MoE: the router margin at the position of each token beyond the
        # tolerance, against all positions' quartiles
        "router_margin_beyond_tol": sorted(r for g, r in zip(gaps, margins)
                                           if g > SERVE_LOGIT_GAP),
        "router_margin_quartiles": [_percentile(margins, q) for q in (0.25, 0.5, 0.75)]
        if margins else None,
        "greedy_argmax_share": sum(matched) / len(matched) if matched else None,
        "greedy_tokens": len(gaps),
        "sampled_equal": completions[1] == completions[2],
        "seed8_differs": seed8 != completions[1],
        "prefix_hits": prefix["hits"] - hits0, "prefix_cache": prefix,
        "resend_equal": resend == outs[0],
        "healthz": health_code, "metricz": metric_code,
        "on_card": on_card, "launches": launches, "burst_launches": burst_launches,
        "plain_int8_on_card": len(plain_on_card),
        "host_threads": threading.active_count(), **extra,
    }
    emit(out)
    scraped = _ttft_scrape_check(scrape, [t / 1e3 for t in ttft])
    emit({"phase": phase, "check": "metricz scrape", **scraped})
    if not scraped["bucket_deltas_equal"] or not scraped["above_0_5_s_equal"]:
        fail(phase, f"the scraped TTFT buckets do not count the burst: {scraped}")
    if not scraped["p50_in_bucket"]:
        fail(phase, f"the store's p50 lies outside the burst p50's bucket: {scraped}")
    if not scraped["slo_equal"]:
        fail(phase, f"p99-ttft error fraction {scraped['error_fraction']} (burns"
             f" {scraped['burn_short']}, {scraped['burn_long']}) against the burst's share"
             f" above 0.5 s {scraped['replies_above_0_5_s_share']}")
    share = SERVE_MOE_GAP_SHARE if moe or int8 is not None else None
    out["greedy_gaps_beyond_tol"] = sorted(g for g in gaps if g > SERVE_LOGIT_GAP)
    if share is not None and gaps and not out["greedy_within_tol_share"] >= share:
        fail(phase, f"{out['greedy_within_tol_share']:.3f} of the greedy tokens within"
                    f" {SERVE_LOGIT_GAP} of their row's maximum < {share}")
    if share is None and gaps and not max(gaps) <= SERVE_LOGIT_GAP:
        fail(phase, f"greedy logit gap {max(gaps)} > {SERVE_LOGIT_GAP}")
    if not (out["sampled_equal"] and out["seed8_differs"]):
        fail(phase, "sampled requests: same seed differs or seed 8 agrees")
    if not (out["prefix_hits"] > 0 or not prefix_cache):
        fail(phase, "the greedy re-send missed the prefix cache")
    if int8 is None and not out["resend_equal"]:
        fail(phase, "the greedy re-send's answer changed on the prefix cache's hit")
    if not on_card:
        fail(phase, "pools or parameters are not on the card")
    if health_code != 200 or metric_code != 200 or "tpx_serve_tokens_total" not in metricz:
        fail(phase, f"healthz {health_code} / metricz {metric_code}: {health[:200]}")
    allowed = {"int8_matmul"} if int8 else set()
    if any(v for k, v in launches.items() if k not in allowed):
        fail(phase, f"the serving path launched a kernel of the kernels line: {launches}")
    if int8:
        # one launch per projection and one for an untied lm head, in every
        # decode step and every prefill chunk of the burst
        per_call = 7 * cfg.n_layers + int(not cfg.tie_embeddings)
        largest = max(r * w for r, w, _ in burst_prefills)
        out.update(int8_launches_per_call=per_call, int8_burst=burst_launches["int8_matmul"],
                   largest_prefill_rows=largest)
        emit({"phase": phase, "check": "int8 launches", "per_call": per_call,
              "decode_steps": sorted(set(burst_int8["decode"])),
              "prefills": sorted(set(burst_int8["prefill"])),
              "burst": burst_launches["int8_matmul"], "largest_prefill_rows": largest,
              "plain_int8_on_card": len(plain_on_card)})
        counted = burst_int8["decode"] + burst_int8["prefill"]
        if not counted or any(n != per_call for n in counted):
            fail(phase, f"int8_matmul launches per decode step / prefill "
                        f"{sorted(set(counted))} != {per_call}")
        if plain_on_card:
            fail(phase, f"the plain int8 path ran on the card: {plain_on_card[:4]}")
        if largest > INT8_M[-1]:
            fail(phase, f"a prefill chunk of {largest} rows: the kernels phase times {INT8_M}")
    if not full_steps:
        fail(phase, "no decode step ran with all slots busy")
    if int8 is not None:
        return {**out, "outs": outs, "resend": resend}

    # greedy, f32, 2 layers: the engine equals the dense generate exactly
    del service, engine, params, server, thread, decode_once, timed_decode, admit, gated_admit
    free_card()
    cfg32 = (f32_cfg or (lambda: llama.llama3_1b(n_layers=2, dtype=torch.float32)))()
    gen32 = torch.Generator(device="cuda")
    gen32.manual_seed(SERVE["seed"])
    params32 = llama.init_params(cfg32, gen32, "cuda")
    for leaf in llama.leaves(params32):
        leaf.requires_grad_(False)
    eng32 = ServeEngine(params32, cfg32, max_slots=SERVE["max_batch"],
                        block_size=SERVE["block_size"], enable_prefix_cache=prefix_cache).start()
    try:
        reqs = [eng32.generate(prompts[i], n_new, timeout=300) for i in f32_prompts]
    finally:
        eng32.stop()
    exact, overflow = [], []
    for i, r in zip(f32_prompts, reqs):
        prompt = torch.tensor([prompts[i]], device="cuda")
        dense = gen.generate(params32, prompt, cfg32, n_new)
        exact.append(r.tokens == dense[0].tolist())
        with torch.no_grad():  # the dense prefill's routing (0 for dense models)
            overflow.append(float(llama.forward_features(params32, prompt, cfg32)[1][
                llama.AUX_OVERFLOW]))
    emit({"phase": phase, "check": "f32 engine equals dense generate", "n_layers": 2,
          "prompt_lens": [SERVE_REQUESTS[i][0] for i in f32_prompts], "equal": exact,
          "prefill_overflow": overflow})
    if any(overflow):
        fail(phase, f"an f32 prompt's prefill overflowed an expert: {overflow}")
    if not all(exact):
        fail(phase, f"f32 engine tokens differ from the dense generate: {exact}")
    return {**out, "outs": outs, "resend": resend}


#: f32 K/V bytes per token of a llama3_1b handoff: layers x KV heads x
#: head_dim x (K, V) x 4 B.
def _handoff_bytes_per_token(cfg) -> int:  # noqa: ANN001
    return cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2 * 4


def phase_serve_disagg(unified: dict) -> dict:
    """The serve phase's burst through a prefill replica and a decode
    replica (``--serve-role prefill`` with ``--kv-transfer http:<decode>``,
    and ``--serve-role decode``) in-process on 127.0.0.1, llama3_1b at full
    width and depth, bf16, the same seeded weights. Checks: the greedy
    tokens equal the unified server's (the decode step's shapes are static
    over its slots, so a row's tokens do not depend on the other rows),
    the sampled ones too, a re-send hits the prefill replica's prefix
    cache, and ``/v1/kv`` answers 400 for a body that is no payload and
    503 at the prefill role. Prints TTFT and TPOT beside the unified
    numbers, and the handoff's bytes and seconds by stage: export (the
    D2H copy), ``to_bytes``, the POST (wire and the decode side's
    ``from_bytes``), and the H2D scatter into the decode pool."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.apps import generate_server
    from torchx_tpu_torch.obs import metrics
    from torchx_tpu_torch.serve import kv_transfer as kvt

    torch.cuda.empty_cache()
    _build.reset_launches()
    t_setup = time.monotonic()
    kw = dict(device="cuda", max_batch=SERVE["max_batch"], block_size=SERVE["block_size"])
    dec_srv = generate_server.serve("llama3_1b", port=0, serve_role="decode", **kw)
    dec_port = dec_srv.server_address[1]
    pre_srv = generate_server.serve(
        "llama3_1b", port=0, serve_role="prefill",
        kv_transfer=f"http:http://127.0.0.1:{dec_port}", **kw)
    pre_port = pre_srv.server_address[1]
    for srv in (dec_srv, pre_srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    setup_s = time.monotonic() - t_setup
    pre_eng, dec_eng = pre_srv.service._engine, dec_srv.service._engine
    cfg = pre_srv.service.cfg

    # the handoff's stages, per request id
    stages: dict = {}
    lock = threading.Lock()

    def note(rid: str, key: str, value: float) -> None:
        with lock:
            stages.setdefault(rid, {})[key] = value

    export = pre_eng._export_handoff

    def timed_export(req, toks, blocks):  # noqa: ANN001, ANN202
        t0 = time.perf_counter()
        payload = export(req, toks, blocks)
        note(payload.request_id, "export_s", time.perf_counter() - t0)
        note(payload.request_id, "tokens", len(toks))
        return payload

    to_bytes, from_bytes = kvt.KvPayload.to_bytes, kvt.KvPayload.from_bytes.__func__

    def timed_to_bytes(self):  # noqa: ANN001, ANN202
        t0 = time.perf_counter()
        raw = to_bytes(self)
        note(self.request_id, "to_bytes_s", time.perf_counter() - t0)
        note(self.request_id, "bytes", len(raw))
        return raw

    def timed_from_bytes(cls, raw):  # noqa: ANN001, ANN202
        t0 = time.perf_counter()
        payload = from_bytes(cls, raw)
        note(payload.request_id, "from_bytes_s", time.perf_counter() - t0)
        return payload

    transfer = kvt.HttpTransfer.transfer

    def timed_transfer(self, payload, target, timeout=60.0):  # noqa: ANN001, ANN202
        note(payload.request_id, "t_send", time.perf_counter())
        return transfer(self, payload, target, timeout)

    handle = dec_srv.service.handle_kv_payload

    def timed_handle(payload):  # noqa: ANN001, ANN202
        note(payload.request_id, "t_arrive", time.perf_counter())
        return handle(payload)

    admit_s: list[float] = []
    admit_handoffs = dec_eng._admit_handoffs

    def timed_admit() -> bool:
        t0 = time.perf_counter()
        worked = admit_handoffs()
        if worked:
            torch.cuda.synchronize()
            admit_s.append(time.perf_counter() - t0)
        return worked

    pre_eng._export_handoff = timed_export
    kvt.KvPayload.to_bytes = timed_to_bytes
    kvt.KvPayload.from_bytes = classmethod(timed_from_bytes)
    kvt.HttpTransfer.transfer = timed_transfer
    dec_srv.service.handle_kv_payload = timed_handle
    dec_eng._admit_handoffs = timed_admit
    gate = threading.Event()
    gate.set()
    admit = pre_eng._admit

    def gated_admit() -> bool:
        gate.wait()
        return admit()

    pre_eng._admit = gated_admit
    try:
        prompts = _serve_prompts(cfg.vocab_size)
        n_new = SERVE["new_tokens"]
        bodies = [{"tokens": [p], "max_new_tokens": n_new, "temperature": t, "seed": sd}
                  for p, (_, t, sd) in zip(prompts, SERVE_REQUESTS)]
        _post(pre_port, {"tokens": [[1, 2, 3]], "max_new_tokens": 2})  # warm-up
        with lock:
            stages.clear()
        admit_s.clear()
        bytes0 = metrics.SERVE_KV_TRANSFER_BYTES.value()
        gate.clear()
        t0 = time.monotonic()
        with ThreadPoolExecutor(len(bodies)) as pool:
            futures = [pool.submit(_post, pre_port, b) for b in bodies]
            deadline = time.monotonic() + 60
            while pre_eng.queue_depth < len(bodies) and time.monotonic() < deadline:
                time.sleep(0.001)
            gate.set()
            replies = [f.result() for f in futures]
        batch_s = time.monotonic() - t0
        sent_bytes = metrics.SERVE_KV_TRANSFER_BYTES.value() - bytes0
        with lock:
            burst = {rid: dict(v) for rid, v in stages.items()}
        outs = [r["tokens"][0] for r in replies]
        hits0 = pre_eng.stats()["prefix_cache"]["hits"]
        resend = _post(pre_port, bodies[0])["tokens"][0]
        prefix_hits = pre_eng.stats()["prefix_cache"]["hits"] - hits0
        code_garbage, _ = _post_raw(dec_port, "/v1/kv", b"not an npz payload")
        shape = (cfg.n_layers, 1, SERVE["block_size"], cfg.n_kv_heads, cfg.head_dim)
        probe = kvt.KvPayload(
            request_id="probe", tokens=[1], generated=[2], cache_len=1, max_new_tokens=2,
            temperature=0.0, seed=0, eos_id=None, block_size=SERVE["block_size"],
            k=np.zeros(shape, np.float32), v=np.zeros(shape, np.float32))
        code_role, _ = _post_raw(pre_port, "/v1/kv", to_bytes(probe))
        health = {}
        for name, port in (("prefill", pre_port), ("decode", dec_port)):
            code, body = _get(port, "/healthz")
            health[name] = (code, json.loads(body).get("serve_role"))
    finally:
        kvt.KvPayload.to_bytes = to_bytes
        kvt.KvPayload.from_bytes = classmethod(from_bytes)
        kvt.HttpTransfer.transfer = transfer
        for srv in (pre_srv, dec_srv):
            srv.shutdown()
            srv.service.close()
            srv.server_close()
    launches = _build.launch_counts()
    ttft = [r["timing"]["ttft_ms"] for r in replies]
    tpot = [(r["timing"]["total_ms"] - r["timing"]["ttft_ms"]) / (n_new - 1) for r in replies]
    handoffs = []
    for st in burst.values():
        post_s = st["t_arrive"] - st["t_send"] - st["to_bytes_s"] - st["from_bytes_s"]
        handoffs.append({"tokens": st["tokens"], "bytes": st["bytes"],
                         "export_s": st["export_s"], "to_bytes_s": st["to_bytes_s"],
                         "post_s": post_s, "from_bytes_s": st["from_bytes_s"],
                         "send_to_arrive_s": st["t_arrive"] - st["t_send"]})
    handoffs.sort(key=lambda h: h["tokens"])
    greedy = [i for i, (_, temp, _) in enumerate(SERVE_REQUESTS) if temp == 0]
    out = {
        "phase": "serve", "run": "disaggregated", "config": "llama3_1b",
        "n_layers": cfg.n_layers, "dtype": "bfloat16", "setup_s": setup_s,
        "requests": len(replies), "new_tokens": n_new,
        "ttft_ms": ttft, "ttft_p50_ms": _percentile(ttft, 0.5), "ttft_max_ms": max(ttft),
        "tpot_ms": tpot, "tpot_p50_ms": _percentile(tpot, 0.5), "tpot_max_ms": max(tpot),
        "unified": {k: unified[k] for k in ("ttft_p50_ms", "ttft_max_ms", "tpot_p50_ms",
                                            "tpot_max_ms", "tokens_per_s")},
        "batch_s": batch_s, "tokens_per_s": len(replies) * n_new / batch_s,
        "handoff_bytes": sent_bytes,
        "handoff_bytes_reckoned": sum(
            -(-len(p) // SERVE["block_size"]) * SERVE["block_size"]
            * _handoff_bytes_per_token(cfg) for p in prompts),
        "bytes_per_token_f32": _handoff_bytes_per_token(cfg),
        "handoffs": handoffs,
        "handoff_s_max": max(h["export_s"] + h["send_to_arrive_s"] for h in handoffs),
        "decode_admit_s": admit_s,
        "greedy_equal_unified": all(outs[i] == unified["outs"][i] for i in greedy),
        "sampled_equal_unified": outs[1] == unified["outs"][1] and outs[2] == unified["outs"][2],
        "resend_equal": resend == outs[0], "prefix_hits": prefix_hits,
        "kv_garbage_code": code_garbage, "kv_at_prefill_code": code_role,
        "healthz": health, "launches": launches,
    }
    emit(out)
    if not out["greedy_equal_unified"]:
        diff = [i for i in greedy if outs[i] != unified["outs"][i]]
        fail("serve", f"disaggregated greedy tokens differ from unified for requests {diff}")
    if not (out["resend_equal"] and prefix_hits > 0):
        fail("serve", "the disaggregated re-send missed the prefix cache or changed")
    if (code_garbage, code_role) != (400, 503):
        fail("serve", f"/v1/kv answered {code_garbage} to garbage and {code_role} at prefill")
    if health != {"prefill": (200, "prefill"), "decode": (200, "decode")}:
        fail("serve", f"healthz of the roles: {health}")
    if len(handoffs) != len(replies) or sent_bytes != sum(h["bytes"] for h in handoffs):
        fail("serve", f"{len(handoffs)} handoffs of {sent_bytes} B for {len(replies)} requests")
    if any(launches.values()):
        fail("serve", f"the disaggregated path launched a kernel of the kernels line: {launches}")
    return out


# ---------------------------------------------------------------------------
# phase 6: checkpoint, preempt, resume, serve and evaluate what was saved
# ---------------------------------------------------------------------------

#: Every run of the phase is llama3_1b at full width cut to ``layers``
#: layers: the gangckpt phase drills and resumes at full depth. A trains
#: ``steps`` steps saving every ``every`` (the JAX trainer's policy saves
#: none of them but the forced last one), B resumes for ``steps`` more; the
#: drill must exit within ``notice_s`` of its SIGTERM; the overlap run saves
#: at step ``overlap_every`` and steps on to ``overlap_steps``, through the
#: background write and past it.
CKPT = dict(layers=2, steps=3, every=2, notice_s=30.0, overlap_every=16,
            overlap_steps=31, prompts=(24, 40), new_tokens=64)
#: The drill with a write in flight: saves every ``every`` steps (the first
#: periodic save is step 6: none on the first step and the three warm-up
#: steps), SIGTERM after the line of step ``term_after``, while step 6's
#: write is in flight; the notice then lands on step 8's periodic save and
#: its forced save. ``limit_s`` bounds the wait for the exit, which is
#: printed against ``notice_s``.
FULL_DRILL = dict(every=2, term_after=7, limit_s=150.0)
#: Option (a) of a save during a write, for the ``notice`` phase's
#: comparison: join the write in flight, then write the new step (the
#: checkpointer's design until this drill). The kept design, (b), writes
#: the new step beside the old one's fsync and digest.
JOIN_FIRST_PATCH = (
    "from torchx_tpu_torch.parallel import checkpoint as _c\n"
    "_save = _c.Checkpointer.save\n"
    "def _join_first(self, step, state, force=False):\n"
    "    if (force or step % self._save_interval == 0) and step not in self._jobs:\n"
    "        self.wait()\n"
    "    return _save(self, step, state, force)\n"
    "_c.Checkpointer.save = _join_first\n")
#: Repeatability fallback: where the first three steps are not bitwise
#: those of the train phase, steps 4-6 are held this close, relative.
RESUME_RTOL = 1e-3
REPO = os.path.dirname(os.path.abspath(__file__))


#: The pool phase: the serve phase's greedy prompts it routes (by index
#: into SERVE_REQUESTS; the first is the serve phase's re-sent one), its
#: launch attempts, and the seconds a replica may take to probe healthy.
POOL = dict(prompts=(0, 3, 4, 5), attempts=3, healthy_timeout_s=300.0)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post_timed(url: str, body: dict) -> tuple[dict, dict, float]:
    """POST ``body`` to ``url``'s ``/v1/generate`` -> (reply, headers,
    seconds at the client)."""
    import urllib.request

    req = urllib.request.Request(f"{url}/v1/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        reply, headers = json.loads(resp.read()), dict(resp.headers)
    return reply, headers, time.perf_counter() - t


def _group_pids(pgid: int) -> list[int]:
    """The live (not zombie) processes of process group ``pgid``, read
    from ``/proc``: a local replica is ``/bin/sh`` (which keeps its exit
    code) over the server, so the wrapper's exit alone does not say the
    server has gone."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            pids.append(int(entry))
    return pids


def _stop_replica(pool, replica, limit_s: float = 60.0) -> None:  # noqa: ANN001
    """Cancel the pool's app and wait until no process of its replica's
    group is left (the server drains on SIGTERM after its wrapper dies)."""
    pool.stop()
    t = time.monotonic()
    while _group_pids(replica.proc.pid) and time.monotonic() - t < limit_s:
        time.sleep(0.05)


def _launch_replica(runner, sched, root: str, session: str) -> tuple:  # noqa: ANN001
    """One llama3_1b ``generate_server`` replica on ``h100-1`` through a
    ``ServePool`` (one replica), its obs session ``session``; launched again
    on another free port when its bind fails, at most ``POOL["attempts"]``
    times. -> (pool, seconds of the submit call, seconds to the server's
    ``listening`` line, its reported load seconds, seconds to healthy)."""
    import glob

    from torchx_tpu_torch.components.serve import generate_server
    from torchx_tpu_torch.serve.pool import AutoscalePolicy, ServePool, http_probe

    for attempt in range(POOL["attempts"]):
        port = _free_port()
        app = generate_server("llama3_1b", port=port, port_stride=1, image=REPO,
                              gpu="h100-1", max_batch=SERVE["max_batch"],
                              block_size=SERVE["block_size"])
        (role,) = app.roles
        role.env.update({"PYTHONPATH": REPO, "TPX_INTERNAL_SESSION_ID": session})
        pool = ServePool(runner, app, cfg={"log_dir": os.path.join(root, "apps")},
                         base_port=port, policy=AutoscalePolicy(min_replicas=1,
                                                                max_replicas=1))
        t0 = time.monotonic()
        pool.start()
        submit_s = time.monotonic() - t0
        app_id = pool.handle.rsplit("/", 1)[-1]
        (replica,) = sched._apps[app_id].roles["server"]
        listening_s = load_s = None
        deadline = t0 + POOL["healthy_timeout_s"]
        launched = False
        try:
            while time.monotonic() < deadline:
                if listening_s is None:
                    for path in glob.glob(os.path.join(root, "apps", "**", app_id, "server",
                                                       "0", "stdout.log"), recursive=True):
                        with open(path, errors="replace") as f:
                            m = re.search(r"generate_server: .* on :\d+ \((\S+)\)"
                                          r" \(loaded in ([\d.]+)s\)", f.read())
                        if m:
                            listening_s, load_s = time.monotonic() - t0, float(m.group(2))
                            if not m.group(1).startswith("cuda"):
                                fail("pool", f"the replica serves on {m.group(1)}")
                if http_probe(pool.replica_url(0), timeout=1.0).healthy:
                    launched = True
                    return pool, submit_s, listening_s, load_s, time.monotonic() - t0
                if replica.proc.poll() is not None:
                    break
                time.sleep(0.05)
            logs = "".join(open(p, errors="replace").read() for p in glob.glob(
                os.path.join(root, "apps", "**", app_id, "server", "0", "stderr.log"),
                recursive=True))
            if "Address already in use" not in logs or attempt == POOL["attempts"] - 1:
                fail("pool", f"the replica did not probe healthy (rc {replica.proc.poll()}):"
                     f" {logs[-3000:]}")
        finally:  # a replica that failed its launch is stopped before the next
            if not launched:
                _stop_replica(pool, replica)
    raise AssertionError("unreachable")


def phase_pool(serve: dict, card: str) -> dict:
    """The serve pool on the card (module docstring, the pool phase): one
    llama3_1b replica through ``Runner`` + the local scheduler, four of the
    serve phase's prompts through ``serve_router``, the replica's
    ``/metricz`` into a ``MetricStore`` and the ``p99-ttft`` SLO, one
    request stitched across the router's and the replica's sessions, and
    ``pool.stop()`` leaving no replica and the card's memory free."""
    import shutil
    import tempfile
    import threading
    import uuid

    import torch

    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.obs import sinks, stitch, timeline
    from torchx_tpu_torch.obs import trace as obs_trace
    from torchx_tpu_torch.obs.slo import SloEngine, parse_slo
    from torchx_tpu_torch.runner import get_runner
    from torchx_tpu_torch.serve.engine import _next_pow2
    from torchx_tpu_torch.serve.pool import serve_router

    t_phase = time.monotonic()
    free_card()
    free_before = torch.cuda.mem_get_info()[0]
    root = tempfile.mkdtemp(prefix="tpx_pool_smoke_")
    obs = os.path.join(root, "obs")
    session = uuid.uuid4().hex
    no_lint = os.environ.get("TPX_NO_LINT")
    os.environ["TPX_NO_LINT"] = "1"  # the port's lint gate waits for its analyzer
    cfg = llama.llama3_1b()
    prompts = _serve_prompts(cfg.vocab_size)
    n_new = SERVE["new_tokens"]
    pool = router = None
    try:
        with _ObsDir(obs):
            runner = get_runner("chip_smoke")
            sched = runner._scheduler("local")
            pool, submit_s, listening_s, load_s, healthy_s = _launch_replica(
                runner, sched, root, session)
            (replica,) = sched._apps[pool.handle.rsplit("/", 1)[-1]].roles["server"]
            replica_url = pool.replica_url(0)
            health = json.loads(_get(int(replica_url.rsplit(":", 1)[1]), "/healthz")[1])
            free_up = torch.cuda.mem_get_info()[0]
            # cuBLAS and the allocator warm up outside the routed requests
            # (the serve phase's warm-up request); then one probe sweep
            marks = {"healthy": time.monotonic()}
            _post_timed(replica_url, {"tokens": [[1, 2, 3]], "max_new_tokens": 2})
            marks["warm"] = time.monotonic()
            pool.step()
            router = serve_router(pool, 0)
            threading.Thread(target=router.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{router.server_address[1]}"
            scrape = _Scrape(replica_url, "pool")
            scrape.once()
            routed = []
            for i in POOL["prompts"]:
                _, temp, seed = SERVE_REQUESTS[i]
                reply, headers, client_s = _post_timed(
                    url, {"tokens": [prompts[i]], "max_new_tokens": n_new,
                          "temperature": temp, "seed": seed})
                routed.append((i, reply, headers.get(obs_trace.HDR_TRACE_ID), client_s))
            scrape.once()
            marks["routed"] = time.monotonic()
            engine = SloEngine(scrape.store, [parse_slo("p99-ttft")],
                               clock=lambda: scrape.now)
            engine.evaluate()
            burn_short, burn_long = engine.burns()["p99-ttft"]
            budget = engine.specs[0].budget
            # one request's trace, stitched across this process's session
            # (the router's span) and the replica's
            tid = routed[0][2]
            st = stitch.stitch(tid)
            mine = os.path.dirname(sinks.trace_path())
            theirs = os.path.join(obs, f"tpx_{session[:8]}")
            rendered = stitch.render_stitched(st) if st is not None else ""
            cli = subprocess.run(
                [sys.executable, "-m", "torchx_tpu_torch.cli.main", "trace", tid, "--stitch"],
                cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                text=True, timeout=120)
            replica_spans = {r.get("span_id") for r in timeline.load_records(
                os.path.join(theirs, sinks.TRACE_FILE)) if timeline.is_span(r)}
            marks["stitched"] = time.monotonic()
            # the re-sent prompt once more, straight to the replica: its
            # client seconds less its own total are the replica's HTTP
            # share of the routed requests' hop
            direct, _, direct_s = _post_timed(replica_url, {
                "tokens": [prompts[POOL["prompts"][0]]], "max_new_tokens": n_new,
                "temperature": 0.0, "seed": 0})
            # teardown: the app cancelled, its replica gone
            router.shutdown()
            router = None
            t_stop = time.monotonic()
            pool.stop()
            stop_s = time.monotonic() - t_stop
            state = runner.status(pool.handle, fresh=True).state
            pool = None
            runner.close()
        # the server under the wrapper drains (SIGTERM) and exits on its own
        while _group_pids(replica.proc.pid) and time.monotonic() - t_stop < 60:
            time.sleep(0.05)
        survivors = _group_pids(replica.proc.pid)
        replica_gone_s = time.monotonic() - t_stop
        free_card()
        free_after = torch.cuda.mem_get_info()[0]
        marks["gone"] = time.monotonic()
        # the routed greedy answers against the plain path (the replica's
        # seeded weights, made here the way the server makes them)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda")
        for leaf in llama.leaves(params):
            leaf.requires_grad_(False)
        gaps = {}
        for i, reply, _, _ in routed[1:]:
            width = min(max(SERVE["block_size"], _next_pow2(len(prompts[i]))),
                        _next_pow2(cfg.max_seq))
            g, _, _ = _teacher_forced_gaps(params, cfg, prompts[i],
                                           reply["tokens"][0][len(prompts[i]):], width)
            gaps[SERVE_REQUESTS[i][0]] = max(g)
        del params
        free_card()
        marks["teacher_forced"] = time.monotonic()
    finally:
        if router is not None:
            router.shutdown()
        if pool is not None:
            _stop_replica(pool, replica)
        if no_lint is None:
            os.environ.pop("TPX_NO_LINT", None)
        else:
            os.environ["TPX_NO_LINT"] = no_lint
        shutil.rmtree(root, ignore_errors=True)
    requests = [{"prompt_len": SERVE_REQUESTS[i][0], "client_ms": 1e3 * client_s,
                 "replica_ttft_ms": r["timing"]["ttft_ms"],
                 "replica_total_ms": r["timing"]["total_ms"],
                 "hop_ms": 1e3 * client_s - r["timing"]["total_ms"],
                 "client_ttft_ms": 1e3 * client_s - r["timing"]["total_ms"]
                 + r["timing"]["ttft_ms"]} for i, r, _, client_s in routed]
    slow_share = sum(r["timing"]["ttft_ms"] > 500 for _, r, _, _ in routed) / len(routed)
    roots = [n.span for n in st.roots] if st is not None else []
    children = [c.span for n in st.roots for c in n.children] if st is not None else []
    res = {
        "phase": "pool", "config": "llama3_1b", "gpu": "h100-1", "replicas": 1,
        "submit_s": submit_s, "submit_to_listening_s": listening_s, "replica_load_s": load_s,
        "submit_to_healthy_s": healthy_s, "healthz_device": health.get("device"),
        "replica_memory_bytes": free_before - free_up, "requests": requests,
        "hop_ms_mean": sum(r["hop_ms"] for r in requests) / len(requests),
        "direct": {"client_ms": 1e3 * direct_s, "replica_total_ms": direct["timing"]["total_ms"],
                   "http_ms": 1e3 * direct_s - direct["timing"]["total_ms"],
                   "equal": direct["tokens"][0] == serve["resend"]},
        "resend_equal": routed[0][1]["tokens"][0] == serve["resend"],
        "greedy_max_logit_gap": gaps, "greedy_gap_tol": SERVE_LOGIT_GAP,
        "scrape_s": scrape.seconds, "ttft_count_delta": scrape.store.histogram_deltas(
            TTFT_METRIC, None)[()][-1][1],
        "burn_short": burn_short, "burn_long": burn_long,
        "error_fraction": burn_long * budget, "replies_above_0_5_s_share": slow_share,
        "trace_id": tid, "stitched_spans": st.span_count if st is not None else 0,
        "stitched_sessions": len(st.sessions) if st is not None else 0,
        "stitched_roots": [sp.name for sp in roots],
        "stitched_children": [sp.name for sp in children],
        "cli_equal": cli.stdout == rendered + "\n", "cli_rc": cli.returncode,
        "app_state": state.name, "stop_s": stop_s, "replica_gone_s": replica_gone_s,
        "survivors": survivors,
        "free_before_bytes": free_before, "free_after_bytes": free_after,
        "seconds": time.monotonic() - t_phase, "card": card,
        # the phase's wall seconds by step: to a healthy replica, its
        # warm-up request, the routed requests with their scrapes, the SLO
        # and stitch (with the CLI's subprocess), the direct request and
        # the stop until the group is gone, the teacher forcing
        "split_s": {k: b - a for k, a, b in zip(
            ("launch", "warm_up", "routed", "slo_stitch", "direct_stop", "teacher_forcing"),
            [t_phase, *(marks[m] for m in ("healthy", "warm", "routed", "stitched", "gone"))],
            [marks[m] for m in ("healthy", "warm", "routed", "stitched", "gone",
                                "teacher_forced")])},
    }
    emit(res)
    if not str(health.get("device", "")).startswith("cuda"):
        fail("pool", f"the replica serves on {health.get('device')}")
    if not res["resend_equal"]:
        fail("pool", "the routed re-sent prompt's tokens differ from the serve phase's")
    if any(g > SERVE_LOGIT_GAP for g in gaps.values()):
        fail("pool", f"routed greedy logit gaps {gaps} > {SERVE_LOGIT_GAP}")
    if res["ttft_count_delta"] != len(routed):
        fail("pool", f"the scraped TTFT count moved by {res['ttft_count_delta']}, not"
             f" {len(routed)}")
    if abs(burn_short - burn_long) > 1e-12 or abs(res["error_fraction"] - slow_share) > 1e-9:
        fail("pool", f"p99-ttft error fraction {res['error_fraction']} (burns {burn_short},"
             f" {burn_long}) against the replies' share above 0.5 s {slow_share}")
    if st is None or len(st.sessions) != 2 or sorted(st.sessions) != sorted([mine, theirs]):
        fail("pool", f"the request's trace is not stitched across two sessions: {res}")
    if [sp.name for sp in roots] != ["serve.route"] or \
            [sp.name for sp in children] != ["serve.unified"] or \
            children[0].span_id not in replica_spans or children[0].span_id == roots[0].span_id:
        fail("pool", f"stitched tree: roots {res['stitched_roots']} children"
             f" {res['stitched_children']}")
    if cli.returncode != 0 or not res["cli_equal"]:
        fail("pool", f"tpx-torch trace --stitch: rc {cli.returncode}\n{cli.stdout}\n"
             f"{cli.stderr}\nexpected\n{rendered}")
    if not state.name == "CANCELLED" or survivors:
        fail("pool", f"after stop: app {state.name}, replica processes {survivors} alive")
    if free_after < free_before - (256 << 20):
        fail("pool", f"the card's free memory {free_after} did not come back to"
             f" {free_before} after the replica exited; on the card: {_card_holders()}")
    return res


def _card_holders() -> list[dict]:
    """The processes that hold memory on the card, as ``nvidia-smi`` lists
    them, each with its process group and command line from ``/proc``
    (a failure's evidence: which process kept what)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout
    holders = []
    for line in filter(None, (ln.strip() for ln in out.splitlines())):
        pid, _, used = line.partition(",")
        holder = {"pid": pid.strip(), "used": used.strip()}
        try:
            with open(f"/proc/{holder['pid']}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            holder["state"], holder["pgid"] = fields[0], int(fields[2])
            with open(f"/proc/{holder['pid']}/cmdline", "rb") as f:
                holder["cmdline"] = f.read().replace(b"\0", b" ").decode(errors="replace")[:300]
        except OSError as e:
            holder["proc"] = str(e)
        holders.append(holder)
    return holders


#: The tracecost phase's bursts, in turns: tracing on (the default) and off
#: (``$TPX_TRACE=0``); and the spans it times in each of three kinds.
TRACE_COST = dict(turns=("on", "off", "off", "on") * 3, spans=2000)


def _trace_cost_spans(n: int) -> dict:
    """Microseconds a span costs its thread on this host: a root span (its
    ``trace.jsonl`` line and the metrics textfile's flush), a child span
    (the line alone), and a span with tracing off; ``n`` of each, in turns
    of 100."""
    from torchx_tpu_torch.obs import trace as obs_trace

    took = {"root": 0.0, "child": 0.0, "off": 0.0}
    for _ in range(n // 100):
        for kind in took:
            if kind == "off":
                os.environ["TPX_TRACE"] = "0"
            outer = (obs_trace.span("tracecost.outer") if kind == "child"
                     else contextlib.nullcontext())
            with outer:
                t = time.perf_counter()
                for _ in range(100):
                    with obs_trace.span("tracecost.span"):
                        pass
                took[kind] += time.perf_counter() - t
            os.environ.pop("TPX_TRACE", None)
    return {k: 1e6 * v / n for k, v in took.items()}


def phase_trace_cost() -> None:
    """What tracing costs the serving path (``--phases build,tracecost``):
    the serve phase's llama3_1b server (its checks held as there) then
    runs its gated 8-request burst again in turns with tracing on and off
    (``TRACE_COST``), each turn from an empty prefix cache (so every turn
    prefills alike): TTFT p50, TPOT p50, the decode step with all 8 slots
    busy, and the root spans the turn wrote (each one asks for a flush of
    the metrics textfile). Then times the spans themselves
    (``_trace_cost_spans``). Prints one line; fails only where a reply is
    short."""
    from concurrent.futures import ThreadPoolExecutor

    from torchx_tpu_torch.obs import sinks

    def roots() -> int:
        try:
            with open(sinks.trace_path()) as f:
                return sum(json.loads(line).get("parent_span_id") is None for line in f)
        except FileNotFoundError:
            return 0

    def turns(run: dict) -> dict:
        engine, gate, steps, bodies = run["engine"], run["gate"], run["steps"], run["bodies"]
        n_new = SERVE["new_tokens"]
        out = []
        for i, mode in enumerate(TRACE_COST["turns"]):
            engine.prefix_cache.evict(engine.prefix_cache.cached_blocks)
            if engine.prefix_cache.cached_blocks:
                fail("tracecost", f"turn {i}: the prefix cache kept"
                     f" {engine.prefix_cache.cached_blocks} blocks")
            if mode == "off":
                os.environ["TPX_TRACE"] = "0"
            roots0 = roots()
            steps.clear()
            gate.clear()
            try:
                with ThreadPoolExecutor(len(bodies)) as pool:
                    futures = [pool.submit(_post, run["port"], b) for b in bodies]
                    deadline = time.monotonic() + 60
                    while engine.queue_depth < len(bodies) and time.monotonic() < deadline:
                        time.sleep(0.001)
                    gate.set()
                    replies = [f.result() for f in futures]
            finally:
                os.environ.pop("TPX_TRACE", None)
            if any(len(r["tokens"][0]) != len(b["tokens"][0]) + n_new
                   for r, b in zip(replies, bodies)):
                fail("tracecost", f"turn {i} ({mode}): a reply is short")
            ttft = [r["timing"]["ttft_ms"] for r in replies]
            tpot = [(r["timing"]["total_ms"] - r["timing"]["ttft_ms"]) / (n_new - 1)
                    for r in replies]
            full = [dt for active, dt in steps if active == SERVE["max_batch"]]
            out.append({"turn": i, "tracing": mode, "ttft_p50_ms": _percentile(ttft, 0.5),
                        "tpot_p50_ms": _percentile(tpot, 0.5),
                        "decode_step_full_ms": 1e3 * sum(full) / max(1, len(full)),
                        "full_steps": len(full), "root_spans": roots() - roots0})
        return {"turns": out}

    t0 = time.monotonic()
    res = phase_serve("llama3_1b", phase="tracecost", inspect=turns)
    by = {mode: [t for t in res["turns"] if t["tracing"] == mode] for mode in ("on", "off")}
    mean = {mode: {k: sum(t[k] for t in ts) / len(ts)
                   for k in ("ttft_p50_ms", "tpot_p50_ms", "decode_step_full_ms", "root_spans")}
            for mode, ts in by.items()}
    emit({"phase": "tracecost", "turns": res["turns"], "mean": mean,
          "span_us": _trace_cost_spans(TRACE_COST["spans"]),
          "seconds": time.monotonic() - t0})


def _listing(directory: str) -> dict[str, tuple[int, int]]:
    """Every file under ``directory`` with its size and mtime."""
    out = {}
    for root, _, files in os.walk(directory):
        for name in files:
            p = os.path.join(root, name)
            st = os.stat(p)
            out[os.path.relpath(p, directory)] = (st.st_size, st.st_mtime_ns)
    return out


def _manifest(directory: str) -> dict:
    with open(os.path.join(directory, "MANIFEST.json")) as f:
        return json.load(f)


def _rel_diff(a: list[float], b: list[float]) -> float:
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))


def _drill(d2: str, n_layers: int = CKPT["layers"], every: int = 0,
           term_after: int = 2, limit_s: float = CKPT["notice_s"], patch: str = "") -> dict:
    """The trainer's module run as ``__main__`` (``runpy``, as ``python -m``
    does) in a subprocess, with the llama3_1b preset cut to ``n_layers``
    layers (``patch``, Python source, runs first), saving every ``every``
    steps (the trainer's default when 0), and SIGTERM after its
    ``term_after``-th step line; the exit is awaited ``limit_s``."""
    import signal

    code = (f"{patch}import functools, runpy\n"
            "from torchx_tpu_torch.models import llama\n"
            "llama.CONFIGS['llama3_1b'] = functools.partial("
            f"llama.llama3_1b, n_layers={n_layers})\n"
            "runpy.run_module('torchx_tpu_torch.examples.train_llama',"
            " run_name='__main__', alter_sys=True)\n")
    cmd = [sys.executable, "-c", code, "--config", "llama3_1b", "--batch",
           str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]), "--steps", "1000",
           "--kernels", "cuda", "--warmup", "1", "--log-every", "1", "--ckpt-dir", d2,
           "--ckpt-every", str(every)]
    env = dict(os.environ, PYTHONPATH=REPO)
    t_start = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=REPO)
    lines = []
    try:
        while sum(x.startswith("step ") for x in lines) < term_after:
            line = proc.stdout.readline()
            if not line:
                fail("ckpt", f"drill: the trainer ended before its step line {term_after}:\n"
                     + "".join(lines)[-3000:])
            lines.append(line)
        t_term = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        try:
            rest, _ = proc.communicate(timeout=limit_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail("ckpt", f"drill: no exit within {limit_s} s of SIGTERM")
        exit_s = time.monotonic() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines) + rest
    if proc.returncode != 0 or "final:" not in out:
        fail("ckpt", f"drill: exit code {proc.returncode}:\n{out[-3000:]}")
    final = json.loads(out.split("final:", 1)[1].splitlines()[0])
    saved = final["final_step"]
    notice = f"preemption notice: checkpointed step {saved}, exiting"
    return {"exit_code": proc.returncode, "sigterm_to_exit_s": exit_s,
            "start_to_sigterm_s": t_term - t_start, "preempted": final["preempted"],
            "saved_step": saved, "notice_printed": notice in out,
            "launch_to_first_step_s": final["launch_to_first_step_s"],
            "checkpoint": final["checkpoint"]}


@contextlib.contextmanager
def _cut_preset(n_layers: int):  # noqa: ANN202
    """The ``llama3_1b`` preset cut to ``n_layers`` layers in this process
    (for a server that loads a checkpoint of the cut model by name)."""
    import functools

    from torchx_tpu_torch.models import llama

    whole = llama.CONFIGS["llama3_1b"]
    llama.CONFIGS["llama3_1b"] = functools.partial(llama.llama3_1b, n_layers=n_layers)
    try:
        yield
    finally:
        llama.CONFIGS["llama3_1b"] = whole


def phase_ckpt() -> dict:
    """The trainer's checkpoint path at llama3_1b's full width, cut to
    ``CKPT["layers"]`` layers (module docstring, phase 6). -> the summary
    line's numbers."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.apps import eval_main, generate_server
    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.serve.engine import ServeEngine

    cfg = llama.llama3_1b(n_layers=CKPT["layers"])
    kw = dict(kernels="cuda", device="cuda", warmup=1, log_every=1)
    step_bytes = 3 * cfg.param_count() * 2  # params, mu, nu in bf16
    # d's two steps and the flipped copy of one, beside the drill's up to two
    need = 5 * step_bytes
    root = tempfile.mkdtemp(prefix="tpx_ckpt_smoke_")
    try:
        free = shutil.disk_usage(root).free
        emit({"phase": "ckpt", "dir": root, "free_bytes": free, "need_bytes": need,
              "step_bytes_expected": step_bytes})
        if free < need:
            fail("ckpt", f"{free / 1e9:.1f} GB free under {root}; the phase needs"
                 f" {need / 1e9:.1f} GB (two steps of {step_bytes / 1e9:.2f} GB,"
                 " a copy of one and the drill's)")
        # the uninterrupted six steps to compare with
        torch.cuda.empty_cache()
        whole_run = train(cfg, TRAIN["batch"], TRAIN["seq"], 2 * CKPT["steps"], **kw)
        whole_losses, whole_norms = whole_run["losses"], whole_run["grad_norms"]

        # A, then B resuming from A's last step
        d = os.path.join(root, "d")
        held: dict = {}

        def on_a(event, state):  # noqa: ANN001, ANN202
            if event == "final":
                held["a"] = state

        restored: dict = {}

        def on_b(event, state):  # noqa: ANN001, ANN202
            if event == "restored":
                a_state = held.pop("a")
                restored["tensors"] = len(a_state)
                restored["differ"] = [k for k in a_state if not torch.equal(state[k], a_state[k])]
                del a_state
            else:
                held["b"] = {k: v for k, v in state.items() if k.startswith("params.")}

        torch.cuda.empty_cache()
        _build.reset_launches()
        a = train(cfg, TRAIN["batch"], TRAIN["seq"], CKPT["steps"], ckpt_dir=d,
                  ckpt_every=CKPT["every"], on_state=on_a, **kw)
        a_manifest = _manifest(d)
        a_listing = sorted(os.listdir(d))
        torch.cuda.empty_cache()
        b = train(cfg, TRAIN["batch"], TRAIN["seq"], CKPT["steps"], ckpt_dir=d,
                  on_state=on_b, **kw)
        counts = _build.launch_counts()
        expected = expected_launches(cfg, 2 * CKPT["steps"])
        a_ck, b_ck = a["checkpoint"], b["checkpoint"]
        a_bitwise = (a["losses"] == whole_losses[: CKPT["steps"]]
                     and a["grad_norms"] == whole_norms[: CKPT["steps"]])
        b_vs_whole = {
            "loss_max_rel_diff": _rel_diff(b["losses"], whole_losses[CKPT["steps"]:]),
            "grad_norm_max_rel_diff": _rel_diff(b["grad_norms"], whole_norms[CKPT["steps"]:]),
            "bitwise": (b["losses"] == whole_losses[CKPT["steps"]:]
                        and b["grad_norms"] == whole_norms[CKPT["steps"]:]),
        }
        emit({"phase": "ckpt", "run": "A", "steps": CKPT["steps"], "every": CKPT["every"],
              "losses": a["losses"], "grad_norms": a["grad_norms"],
              "step_times_s": a["step_times_s"], "final_step": a["final_step"],
              "launch_breakdown": a["launch_breakdown"],
              "manifest_steps": sorted(a_manifest["steps"]),
              "latest_step": a_manifest["latest_step"], "listing": a_listing,
              "saves": a_ck["saves"], "writes": a_ck["writes"]})
        emit({"phase": "ckpt", "run": "B", "resumed_from_step": b["resumed_from_step"],
              "final_step": b["final_step"], "losses": b["losses"],
              "grad_norms": b["grad_norms"], "step_times_s": b["step_times_s"],
              "launch_breakdown": b["launch_breakdown"],
              "restores": b_ck["restores"], "saves": b_ck["saves"], "writes": b_ck["writes"],
              "restored_tensors": restored.get("tensors"),
              "restored_differ": restored.get("differ"),
              "launches": counts, "expected_launches": expected})
        emit({"phase": "ckpt", "check": "repeatability",
              "a_equals_train_steps_1_3": a_bitwise,
              "a_loss_max_rel_diff": _rel_diff(a["losses"], whole_losses[: CKPT["steps"]]),
              "a_grad_norm_max_rel_diff": _rel_diff(a["grad_norms"],
                                                    whole_norms[: CKPT["steps"]]),
              "b_vs_train_steps_4_6": b_vs_whole,
              "rule": "bitwise" if a_bitwise else f"within {RESUME_RTOL} relative"})
        if a_manifest["latest_step"] != CKPT["steps"] or sorted(a_manifest["steps"]) != [
                str(CKPT["steps"])]:
            fail("ckpt", f"A's manifest {a_manifest} is not its forced save of step"
                 f" {CKPT['steps']} alone")
        if (b["resumed_from_step"], b["final_step"]) != (CKPT["steps"], 2 * CKPT["steps"]):
            fail("ckpt", f"B resumed from {b['resumed_from_step']} to {b['final_step']}")
        if restored.get("differ") != [] or not restored.get("tensors"):
            fail("ckpt", f"B's restored state differs from A's in {restored}")
        if counts != expected:
            fail("ckpt", f"launch counts over A and B {counts} != {expected}")
        if a_bitwise and not b_vs_whole["bitwise"]:
            fail("ckpt", f"steps 4-6 after the resume differ from the uninterrupted run"
                 f" though steps 1-3 agree bitwise: {b_vs_whole}")
        if max(b_vs_whole["loss_max_rel_diff"], b_vs_whole["grad_norm_max_rel_diff"]) > RESUME_RTOL:
            fail("ckpt", f"steps 4-6 after the resume: {b_vs_whole} > {RESUME_RTOL}")

        # serve what B saved, and compare with an engine on B's own params
        listing, manifest_bytes = _listing(d), open(os.path.join(d, "MANIFEST.json"), "rb").read()
        rng = np.random.default_rng(SERVE["seed"])
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in CKPT["prompts"]]
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        with _cut_preset(CKPT["layers"]):
            server = generate_server.serve(
                "llama3_1b", port=0, ckpt_dir=d, device="cuda",
                max_batch=SERVE["max_batch"], block_size=SERVE["block_size"])
        load_s = time.monotonic() - t0
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            code, health = _get(port, "/healthz")
            served = [_post(port, {"tokens": [p], "max_new_tokens": CKPT["new_tokens"]})
                      ["tokens"][0][len(p):] for p in prompts]
            served_cfg = server.service.cfg
        finally:
            server.shutdown()
            server.service.close()
            server.server_close()
        b_params = llama.unflatten(
            {k.removeprefix("params."): v.detach() for k, v in held.pop("b").items()})
        eng = ServeEngine(b_params, served_cfg, max_slots=SERVE["max_batch"],
                          block_size=SERVE["block_size"]).start()
        try:
            own = [eng.generate(p, CKPT["new_tokens"], timeout=300).generated for p in prompts]
        finally:
            eng.stop()
        del b_params, eng
        ckpt_step = json.loads(health).get("ckpt_step") if code == 200 else None
        unchanged = (_listing(d) == listing
                     and open(os.path.join(d, "MANIFEST.json"), "rb").read() == manifest_bytes)
        serve = {"load_s": load_s, "healthz": code, "ckpt_step": ckpt_step,
                 "prompt_lens": list(CKPT["prompts"]), "new_tokens": CKPT["new_tokens"],
                 "tokens_equal_own": served == own, "dir_unchanged": unchanged,
                 "listing": sorted(listing)}
        emit({"phase": "ckpt", "run": "serve", **serve})
        if not (serve["tokens_equal_own"] and ckpt_step == 2 * CKPT["steps"] and unchanged):
            fail("ckpt", f"serve from the checkpoint: {serve}")

        # a copy of d (its manifest and newest step) with one payload byte flipped
        flip = os.path.join(root, "flip")
        os.makedirs(flip)
        latest = str(2 * CKPT["steps"])
        shutil.copy2(os.path.join(d, "MANIFEST.json"), flip)
        t0 = time.monotonic()
        shutil.copytree(os.path.join(d, latest), os.path.join(flip, latest))
        copy_s = time.monotonic() - t0
        payload = os.path.join(flip, latest, "state.pt")
        with open(payload, "r+b") as f:
            f.seek(os.path.getsize(payload) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        t0 = time.monotonic()
        flip_rc = eval_main.main(["--ckpt", flip, "--out", os.path.join(root, "flip.json")])
        flipped = {"eval_main_rc": flip_rc, "eval_s": time.monotonic() - t0, "copy_s": copy_s}
        emit({"phase": "ckpt", "check": "flipped payload byte", **flipped})
        if flip_rc != 1:
            fail("ckpt", f"eval_main passed a checkpoint with a flipped byte (rc {flip_rc})")
        shutil.rmtree(flip)
        shutil.rmtree(d)

        # steps overlapping a background write against the others
        torch.cuda.empty_cache()
        c = train(cfg, TRAIN["batch"], TRAIN["seq"], CKPT["overlap_steps"],
                  ckpt_dir=os.path.join(root, "d3"), ckpt_every=CKPT["overlap_every"], **kw)
        c_ck = c["checkpoint"]
        # the first two steps pay one-off costs (builds, allocator): left out
        pairs = list(zip(c["step_times_s"], c_ck["step_overlaps_write"]))[2:]
        during = [t for t, o in pairs if o]
        clear = [t for t, o in pairs if not o]
        overlap = {"steps_during_write": len(during), "steps_clear": len(clear),
                   "step_s_during_write": sum(during) / max(1, len(during)),
                   "step_s_clear": sum(clear) / max(1, len(clear)),
                   "step_s_during_write_max": max(during, default=None),
                   "step_s_clear_max": max(clear, default=None),
                   "saves": c_ck["saves"], "writes": c_ck["writes"]}
        emit({"phase": "ckpt", "run": "overlap", "every": CKPT["overlap_every"],
              "steps": CKPT["overlap_steps"], "step_times_s": c["step_times_s"],
              "overlaps": c_ck["step_overlaps_write"], **overlap})
        if not during or not clear:
            fail("ckpt", f"overlap run: {len(during)} steps during a write, {len(clear)} clear")
        shutil.rmtree(os.path.join(root, "d3"))

        # the preemption drill, in a subprocess, with a write in flight
        drill = _full_drill(os.path.join(root, "d4"), step_bytes, n_layers=CKPT["layers"],
                            eval_gate=True)
        emit({"phase": "ckpt", "run": "drill", **drill})

        restore = b_ck["restores"][0]
        summary = {
            "checkpoint_bytes": a_ck["writes"][0]["bytes"],
            "save_stall_s": {f"{run}{s['step']}": s["wait_s"] + s["snapshot_s"]
                             for run, ck in (("A", a_ck), ("B", b_ck), ("C", c_ck))
                             for s in ck["saves"]},
            **{key: [w[key] for ck in (a_ck, b_ck, c_ck) for w in ck["writes"]]
               for key in ("write_s", "serialize_s", "fsync_s", "digest_s")},
            "restore_s": {k: restore[k] for k in ("verify_s", "read_s", "h2d_s")},
            "step_s_during_write": overlap["step_s_during_write"],
            "step_s_clear": overlap["step_s_clear"],
            "sigterm_to_exit_s": drill["sigterm_to_exit_s"],
            "server_load_s": load_s,
            "resume_bitwise": b_vs_whole["bitwise"],
        }
        emit({"phase": "ckpt", "summary": summary})
        return summary
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _full_drill(d: str, step_bytes: int, patch: str = "", n_layers: int = 16,
                eval_gate: bool = False) -> dict:
    """The drill at llama3_1b's width and ``n_layers`` layers (the notice
    phase: full depth) with step 6's write in flight when SIGTERM lands
    (``FULL_DRILL``): exit 0 with the step it saved durable (in the
    manifest, its digest verified) and, with ``eval_gate``, passing
    ``eval_main``. -> the drill's numbers, SIGTERM to exit beside the
    notice."""
    import shutil

    from torchx_tpu_torch.apps import eval_main
    from torchx_tpu_torch.parallel.checkpoint import Checkpointer

    free = shutil.disk_usage(os.path.dirname(d)).free
    if free < 3 * step_bytes:
        fail("ckpt", f"{free / 1e9:.1f} GB free for the drill's two steps")
    drill = _drill(d, n_layers=n_layers, every=FULL_DRILL["every"],
                   term_after=FULL_DRILL["term_after"], limit_s=FULL_DRILL["limit_s"],
                   patch=patch)
    saved = drill["saved_step"]
    t0 = time.monotonic()
    durable = (_manifest(d)["latest_step"] == saved
               and Checkpointer(d, read_only=True).verify_step(saved) is True)
    ck = drill.pop("checkpoint")
    out = {"n_layers": n_layers, "every": FULL_DRILL["every"],
           "term_after_step": FULL_DRILL["term_after"], **drill,
           "notice_s": CKPT["notice_s"],
           "within_notice": drill["sigterm_to_exit_s"] <= CKPT["notice_s"],
           "durable": durable, "verify_s": time.monotonic() - t0,
           "saves": ck["saves"], "writes": ck["writes"],
           # step term_after + 1 started after the SIGTERM
           "write_in_flight_at_notice": ck["step_overlaps_write"][FULL_DRILL["term_after"]]}
    if eval_gate:
        out["eval_main_rc"] = eval_main.main(["--ckpt", d, "--out", d + "_score.json"])
        if out["eval_main_rc"] != 0 or not out["within_notice"]:
            fail("ckpt", f"drill: eval_main refused its step, or no exit within the notice:"
                 f" {out}")
    shutil.rmtree(d, ignore_errors=True)
    if not (drill["preempted"] and drill["notice_printed"] and durable):
        fail("ckpt", f"drill with a write in flight: {out}")
    if saved <= FULL_DRILL["term_after"] or not out["write_in_flight_at_notice"]:
        fail("ckpt", f"drill: step {saved} saved, or no write in flight: {out}")
    return out


def phase_notice() -> None:
    """The full-depth drill under the two designs of a save during a
    write, in turns (a, b, b, a): (a) joins the write in flight, then
    writes the new step (``JOIN_FIRST_PATCH``); (b), the checkpointer's,
    writes it beside the old write's fsync and digest."""
    import shutil
    import tempfile

    from torchx_tpu_torch.models import llama

    step_bytes = 3 * llama.llama3_1b().param_count() * 2
    root = tempfile.mkdtemp(prefix="tpx_notice_smoke_")
    runs = []
    try:
        for option in ("a", "b", "b", "a"):
            patch = JOIN_FIRST_PATCH if option == "a" else ""
            res = _full_drill(os.path.join(root, f"d_{option}{len(runs)}"), step_bytes, patch)
            emit({"phase": "notice", "option": option, **res})
            runs.append((option, res["sigterm_to_exit_s"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "notice", "summary": {
        opt: [t for o, t in runs if o == opt] for opt in ("a", "b")}})


#: Kernel-name fragments -> the group a step's device time is booked to.
PROFILE_GROUPS = (
    ("int8_matmul", ("int8_decode_kernel", "int8_wgmma_kernel", "int8_tf32_kernel")),
    ("flash_fwd", ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel")),
    ("flash_dq", ("flash_dq_wgmma_kernel", "flash_dq_mma_kernel")),
    ("flash_dkv", ("flash_dkv_wgmma_kernel", "flash_dkv_mma_kernel")),
    ("norm_res_fwd", ("norm_res_fwd_kernel",)),
    ("rms_norm_bwd", ("rms_norm_bwd_kernel", "dw_reduce_kernel")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("gather/scatter", ("index", "gather", "scatter")),
)


def phase_profile() -> None:
    """Profile one llama3_1b step after a warm-up step (torch.profiler,
    CUDA activity): device time by kernel group and the device's busy share
    of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchx_tpu_torch.examples.train_llama import (
        make_optimizer, make_train_step, synthetic_batch,
    )
    from torchx_tpu_torch.models import llama

    import dataclasses

    cfg = dataclasses.replace(llama.llama3_1b(), max_seq=TRAIN["seq"], kernels="cuda")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, "cuda")
    step = make_train_step(cfg, make_optimizer(llama.leaves(params)))
    batch = synthetic_batch(cfg, TRAIN["batch"], TRAIN["seq"], device="cuda")
    step(params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    emit({"phase": "profile", "path": "train step", **_device_summary(prof, wall)})
    del params, step, batch
    _profile_trainer_trace()
    _profile_overhead()
    _profile_decode()


def _profile_overhead() -> None:
    """The step profiler's own cost: the train phase's run unprofiled and
    with ``profile=True`` (no torch.profiler trace), in turns (u, p, p, u),
    step times after the first."""
    import shutil
    import tempfile

    import torch

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama

    root = tempfile.mkdtemp(prefix="tpx_overhead_smoke_")
    runs = []
    try:
        with _ObsDir(root):
            for profiled in (False, True, True, False):
                torch.cuda.empty_cache()
                out = train(llama.llama3_1b(), TRAIN["batch"], TRAIN["seq"], TRAIN["steps"],
                            kernels="cuda", device="cuda", warmup=1, log_every=1,
                            profile=profiled)
                runs.append({"profiled": profiled, "step_time_s": out["step_time_s"],
                             "step_times_s": out["step_times_s"][1:]})
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def mean(flag: bool) -> float:
        xs = [r["step_time_s"] for r in runs if r["profiled"] == flag]
        return sum(xs) / len(xs)

    emit({"phase": "profile", "path": "step profiler overhead", "runs": runs,
          "unprofiled_step_s": mean(False), "profiled_step_s": mean(True),
          "overhead": mean(True) / mean(False) - 1})


#: The port's functions the elementwise split wraps in a record_function
#: range, and the part of the split each names: (owner, attribute, part).
SPLIT_RANGES = (
    ("torchx_tpu_torch.examples.train_llama:AdamW", "step", "optimizer"),
    ("torchx_tpu_torch.models.llama", "apply_rope", "rope"),
    ("torchx_tpu_torch.models.llama", "_chunk_nll_sum", "cross_entropy"),
)
#: The MoE FFN's parts (moeprofile phase): the router, the experts' SwiGLU,
#: and the rest of the MoE FFN, which is the dispatch and combine einsums.
MOE_RANGES = (
    ("torchx_tpu_torch.models.moe", "moe_ffn", "moe_dispatch_combine"),
    ("torchx_tpu_torch.models.moe", "route", "moe_router"),
    ("torchx_tpu_torch.models.moe", "experts", "moe_experts"),
)
#: Kernel-name fragments of PyTorch's dtype casts and copies.
CAST_KERNELS = ("copy_kernel",)


def _annotate_ranges(ranges=SPLIT_RANGES):  # noqa: ANN001, ANN202
    """Wrap each of ``ranges`` in ``record_function("tpx.<part>")``.
    -> a callable that restores the originals. The remat recompute calls
    the wrapped functions too, so recomputed kernels fall in their part."""
    import importlib

    import torch

    saved = []
    for target, attr, part in ranges:
        mod, _, cls = target.partition(":")
        owner = importlib.import_module(mod)
        if cls:
            owner = getattr(owner, cls)
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _name=f"tpx.{part}", **k):  # noqa: ANN002, ANN003, ANN202
            with torch.profiler.record_function(_name):
                return _fn(*a, **k)

        saved.append((owner, attr, fn))
        setattr(owner, attr, wrapped)
    return lambda: [setattr(o, a, f) for o, a, f in saved]


def split_elementwise(events: list[dict], every_group: bool = False) -> dict[str, float]:
    """Device ms of a Chrome trace's kernels, by group (``PROFILE_GROUPS``),
    with the elementwise group ("other") split into the annotated parts,
    casts and the rest; with ``every_group`` a kernel of any group goes to
    the part that holds it, and only the rest to their groups.

    A kernel belongs to the part whose ``tpx.<part>`` range holds the CPU
    launch of the kernel (the ``cuda_runtime`` event of its correlation id,
    on the launching thread), or, in the backward, whose range holds the
    forward op that the launching autograd node's flow (``fwdbwd``) starts
    at; else, by name, to the casts; else to the rest."""
    import bisect
    from collections import defaultdict

    ranges: dict = defaultdict(list)  # tid -> [(start, end, part)]
    nodes: dict = defaultdict(list)  # tid -> [(start, end)] autograd nodes
    starts: dict = defaultdict(list)  # flow id -> [(ts, tid)] forward ends
    finishes: list = []  # (flow id, tid, ts) backward ends
    launches: dict = {}  # correlation -> (tid, ts)
    kernels = []
    for e in events:
        cat, name, args = e.get("cat"), e.get("name", ""), e.get("args") or {}
        if cat == "user_annotation" and name.startswith("tpx."):
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], name[4:]))
        elif cat == "cpu_op" and name.startswith("autograd::engine::evaluate_function"):
            nodes[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
        elif cat == "fwdbwd":
            if e.get("ph") == "s":
                starts[e["id"]].append((e["ts"], e["tid"]))
            else:
                finishes.append((e["id"], e["tid"], e["ts"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], e["ts"])
        elif cat == "kernel":
            kernels.append(e)

    def part_at(table: dict, tid, ts) -> str | None:  # noqa: ANN001
        inner = None
        for start, end, part in table.get(tid, ()):
            if start <= ts <= end and (inner is None or start >= inner[0]):
                inner = (start, end, part)
        return inner[2] if inner else None

    backward: dict = defaultdict(list)
    for fid, tid, ts in finishes:
        # the forward end of this flow: its latest start before the node
        fwd = [x for x in starts.get(fid, ()) if x[0] <= ts]
        if not fwd:
            continue
        f_ts, f_tid = max(fwd)
        part = part_at(ranges, f_tid, f_ts)
        if part is None:
            continue
        spans = sorted(nodes.get(tid, ()))
        i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
        if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
            backward[tid].append((*spans[i], part))

    out: dict[str, float] = defaultdict(float)
    for k in kernels:
        name = k.get("name", "")
        group = next((g for g, frags in PROFILE_GROUPS if any(f in name for f in frags)),
                     "other")
        ms = k.get("dur", 0.0) / 1e3
        if group != "other" and not every_group:
            out[group] += ms
            continue
        tid, ts = launches.get((k.get("args") or {}).get("correlation"), (None, None))
        part = part_at(ranges, tid, ts) or part_at(backward, tid, ts)
        if every_group and (part is not None or group != "other"):
            out[part or group] += ms
            continue
        if part is None:
            part = "casts" if any(f in name for f in CAST_KERNELS) else "rest"
        out[f"elementwise.{part}"] += ms
    return dict(out)


def _profile_trainer_trace() -> None:
    """``train(..., profile_dir=...)`` at llama3_1b for 3 steps, with the
    ``SPLIT_RANGES`` annotated, and the trainer's own trace of its 2 timed
    steps split (``split_elementwise``): device ms per step by group, the
    elementwise group by part."""
    import shutil
    import tempfile

    import torch

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama

    steps = 3
    root = tempfile.mkdtemp(prefix="tpx_trace_smoke_")
    restore = _annotate_ranges()
    try:
        torch.cuda.empty_cache()
        out = train(llama.llama3_1b(), TRAIN["batch"], TRAIN["seq"], steps, kernels="cuda",
                    device="cuda", warmup=1, log_every=1, profile_dir=root)
        with open(out["profile_trace"]) as f:
            events = json.load(f)["traceEvents"]
        trace_bytes = os.path.getsize(out["profile_trace"])
    finally:
        restore()
        shutil.rmtree(root, ignore_errors=True)
    timed = steps - 1
    split = {k: v / timed for k, v in sorted(split_elementwise(events).items())}
    elementwise = {k: v for k, v in split.items() if k.startswith("elementwise.")}
    emit({"phase": "profile", "path": "trainer trace, elementwise split",
          "steps_traced": timed, "trace_bytes": trace_bytes,
          "step_time_s": out["step_times_s"][1:], "per_step_ms": split,
          "elementwise_ms": sum(elementwise.values()),
          "device_ms": sum(split.values())})


def _device_summary(prof, wall_s: float) -> dict:  # noqa: ANN001
    """Device time by kernel group and the top kernels of a profile, and
    the device's busy share of ``wall_s``."""
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            kernels[ev.key] = (us / 1e3, ev.count)
    groups: dict[str, float] = {}
    for name, (ms, _) in kernels.items():
        group = next((g for g, frags in PROFILE_GROUPS
                      if any(f in name for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    busy = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {"step_wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3), "groups_ms": groups,
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c} for n, (ms, c) in top]}


def _profile_decode() -> None:
    """Profile one paged decode step of llama3_1b at 8 busy slots, each
    1024 tokens deep in the engine's default pool (after two warm-up
    steps): the host's share of an eager decode step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchx_tpu_torch.models import generate as gen
    from torchx_tpu_torch.models import llama

    cfg = llama.llama3_1b()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    params = llama.init_params(cfg, g, "cuda")
    for leaf in llama.leaves(params):
        leaf.requires_grad_(False)
    slots, bs, depth = SERVE["max_batch"], SERVE["block_size"], 1024
    bpr = cfg.max_seq // bs
    pools = gen.init_kv_pools(cfg, 1 + slots * (bpr // 2), bs, "cuda")
    tables = torch.zeros((slots, bpr), dtype=torch.int64, device="cuda")
    per = depth // bs
    tables[:, :per] = 1 + torch.arange(slots * per, device="cuda").view(slots, per)
    positions = torch.full((slots,), depth - 1, dtype=torch.int64, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (slots,), generator=g, device="cuda")
    seeds = torch.zeros((slots,), dtype=torch.int64, device="cuda")
    temps = torch.zeros((slots,), device="cuda")

    def step():  # noqa: ANN202
        return gen.paged_decode_step(params, tokens, positions, tables, pools, cfg,
                                     seeds, temps).cpu()

    step()
    step()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        wall = time.monotonic() - t0
    emit({"phase": "profile", "path": "decode step", "slots": slots, "depth": depth,
          **_device_summary(prof, wall)})


#: The RMSNorm backward's launch settings the sweep phase times (see
#: ``ops.norms.BWD_CONFIG``): rows per block, warps, programs per SM,
#: pipeline stages of the row loop, columns per program of the dw pass.
#: (1, 8, 2, 1, 128) is the design the kernel had before it took row blocks.
SWEEP = dict(rows=(1, 2, 4, 8), warps=(4, 8, 16), per_sm=(1, 2, 4), stages=(1, 2),
             reduce_cols=(16, 32, 128))
#: The flash tile sweep's cells: llama3_1b's attention (head_dim 64; the
#: train phase's launches a step) and Mixtral-8x7B's (128; the moe phase's).
TILE_SWEEP = {"llama3_1b": ATTN, "mixtral_8x7b": ATTN_MOE}
#: The wgmma kernels' first tiles (before they were a setting), which a default
#: replaces only where the sweep's fastest setting beats it by more than
#: the kernels' spread between calls (PERF.md: 3%).
FIRST_TILES = {("flash_fwd", 64): (128, 128), ("flash_fwd", 128): (128, 128),
               ("flash_dq", 64): (128, 128), ("flash_dq", 128): (128, 64),
               ("flash_dkv", 64): (64, 128), ("flash_dkv", 128): (32, 128)}
TILE_SPREAD = 0.03


def _cell_cfg(cell: str):  # noqa: ANN202
    """The config whose launches a step the sweep's cell weighs tiles by."""
    from torchx_tpu_torch.models import llama, moe

    if cell == "mixtral_8x7b":
        return moe.mixtral_8x7b_shape(n_layers=MOE_TRAIN["n_layers"])
    return llama.llama3_1b()


def _flash_tile_sweep(gen) -> None:  # noqa: ANN001
    """Every compiled tile of the three wgmma flash kernels at each cell's
    attention shape (causal, bf16), unmasked and with packed documents:
    first held to the plain version (``BF16_TOL``; the phase fails if one
    disagrees), then timed beside the bound, SDPA and the launches a step.
    Then, from the unmasked times: the fastest tile per kernel and head dim
    (the default table's source, where it beats the first design's tile by
    more than ``TILE_SPREAD``) and the (block_q, block_kv) request whose
    fits cost a step least (a preset's)."""
    import itertools

    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.ops import fused

    bad = []
    for cell, attn in TILE_SWEEP.items():
        d, s = attn["d"], attn["s"]
        per_step = expected_launches(_cell_cfg(cell), 1)
        times: dict = {}
        for masked in (False, True):
            seg = packed_segment_ids(attn["b"], s, SEG["max_len"], SEG["seed"]) if masked else None
            q, k, v, do = _attn_inputs(*attn.values(), torch.bfloat16, gen)
            o_p, lse_p = fused._flash_fwd_plain(q, k, v, True, seg)
            args = (q, k, v, do, lse_p, fused._flash_delta(do, o_p), True, seg)
            want = {"flash_fwd": (o_p, lse_p), "flash_dq": (fused._flash_dq_plain(*args),),
                    "flash_dkv": fused._flash_dkv_plain(*args)}
            mask = None
            if masked:
                same = seg[:, :, None] == seg[:, None, :]
                mask = (same & torch.ones_like(same).tril())[:, None]
            sdpa_fwd, sdpa_bwd = _sdpa_calls(q, k, v, do, mask)
            sdpa = {"flash_fwd": time_ms(sdpa_fwd), "backward": time_ms(sdpa_bwd)}
            bounds = _bounds(attn=attn, pairs_per_head=kept_pairs(seg, True) if masked else None)
            for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
                q_tiles, kv_tiles = fused.WGMMA_TILES[(kernel, d)]
                call = {"flash_fwd": lambda t: fused._flash_fwd(q, k, v, True, seg, tile=t),
                        "flash_dq": lambda t: (fused._flash_dq(*args, tile=t),),
                        "flash_dkv": lambda t: fused._flash_dkv(*args, tile=t)}[kernel]
                share = LIBRARY_SHARE.get(kernel, (1.0, None))[0]
                library_ms = share * sdpa["flash_fwd" if kernel == "flash_fwd" else "backward"]
                name = f"{kernel}_wgmma" + ("_seg" if masked else "")
                for tile in itertools.product(q_tiles, kv_tiles):
                    _build.reset_launches()
                    err = max(rel_err(a, b) for a, b in zip(call(tile), want[kernel]))
                    launched = _build.launch_counts()[name]
                    ms = time_ms(lambda t=tile: call(t), iters=20)  # noqa: B023
                    bound_ms, bound_by = bounds[kernel][:2]
                    row = {"phase": "sweep", "kernel": name, "cell": cell, "head_dim": d,
                           "tile": list(tile), "default": tile == fused.fit_tile(
                               kernel, "wgmma", d, s), "err": err, "tol": BF16_TOL[kernel],
                           "launched": launched, "ms": ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "share": bound_ms / ms,
                           "library_ms": library_ms,
                           "launches_per_step": per_step[f"{kernel}_wgmma"]}
                    emit(row)
                    if not (err <= BF16_TOL[kernel] and launched == 1):
                        bad.append(f"{name} {cell} tile {tile}: err {err}, launches {launched}")
                    if not masked:
                        times[(kernel, tile)] = ms
            del q, k, v, do, o_p, lse_p, args, want, sdpa_fwd, sdpa_bwd, mask, seg
            free_card()
        # the default table's candidates, and the request a preset names
        for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
            mine = {t: ms for (kern, t), ms in times.items() if kern == kernel}
            fastest = min(mine, key=mine.get)
            first = FIRST_TILES[(kernel, d)]
            pick = fastest if mine[fastest] < (1 - TILE_SPREAD) * mine[first] else first
            emit({"phase": "sweep", "default_for": kernel, "head_dim": d, "cell": cell,
                  "fastest": list(fastest), "fastest_ms": mine[fastest], "first": list(first),
                  "first_ms": mine[first], "pick": list(pick),
                  "table": list(fused.DEFAULT_TILES[(kernel, d)]),
                  "table_is_pick": tuple(fused.DEFAULT_TILES[(kernel, d)]) == pick})
        # a request's flash time a step (0, 0: the default table), a pair
        # preferred where it ties the table
        axes = sorted({t for (kern, tile) in times for t in tile})
        cost = {req: sum(per_step[f"{kern}_wgmma"] * times[(kern, fused.fit_tile(
                    kern, "wgmma", d, s, *req))] for kern in ("flash_fwd", "flash_dq", "flash_dkv"))
                for req in [*itertools.product(axes, axes), (0, 0)]}
        best = min(cost, key=lambda req: (cost[req], req == (0, 0)))
        emit({"phase": "sweep", "preset_for": cell, "head_dim": d, "request": list(best),
              "ms_per_step": cost[best],
              "by_request": {f"{a},{b}": c for (a, b), c in sorted(cost.items())}})
    if bad:
        fail("sweep", "; ".join(bad))


def phase_sweep() -> None:
    """Time the RMSNorm backward at the main-path shape over ``SWEEP``,
    each setting checked against the plain version first; then every
    compiled tile of the wgmma flash kernels (:func:`_flash_tile_sweep`)."""
    import itertools

    import torch
    import torch.nn.functional as F

    from torchx_tpu_torch.ops import norms

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n, dn = NORM["n"], NORM["d"]
    x, dy = (torch.randn((n, dn), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    w = (1 + 0.1 * torch.randn((dn,), generator=gen, device="cuda")).to(torch.bfloat16)
    dx_p, dw_p = norms._bwd_math(x, w, dy, EPS)
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    out = F.rms_norm(xg, (dn,), wg, EPS)
    library_ms = time_ms(lambda: torch.autograd.grad(out, (xg, wg), dy, retain_graph=True))
    bound_ms = _bounds()["rms_norm_bwd"][0]
    results = []
    for cfg in itertools.product(*SWEEP.values()):
        try:
            dx, dw = norms._bwd(x, dy, w, EPS, config=cfg)
            err = max(rel_err(dx, dx_p), rel_err(dw, dw_p))
            ms = time_ms(lambda: norms._bwd(x, dy, w, EPS, config=cfg), iters=20)  # noqa: B023
            results.append({"config": cfg, "ms": ms, "share_of_bound": bound_ms / ms,
                            "err": err, "ok": err <= BF16_TOL["rms_norm_bwd"]})
        except Exception as e:  # noqa: BLE001 - a setting that fails to build is a result
            results.append({"config": cfg, "error": f"{type(e).__name__}: {e}"[:300]})
    results.sort(key=lambda r: r.get("ms", math.inf))
    emit({"phase": "sweep", "kernel": "rms_norm_bwd", "shape": [n, dn],
          "config_keys": list(SWEEP), "default": norms.BWD_CONFIG,
          "bound_ms": bound_ms, "library_ms": library_ms, "results": results})
    if not all(r.get("ok", True) for r in results):
        fail("sweep", "a setting disagrees with the plain version")
    del x, dy, w, dx_p, dw_p, xg, wg, out
    free_card()
    _flash_tile_sweep(gen)


# ---------------------------------------------------------------------------
# phase 7: the MoE family at Mixtral-8x7B's width
# ---------------------------------------------------------------------------

#: The moe phase's training run: Mixtral-8x7B's width at 2 of its 32
#: layers. Parameters, gradients and two bf16 moments of 3.165 B parameters
#: take 25.3 GB; the op-by-op AdamW's temporaries on the largest leaf
#: (0.94 B elements) 1.88 GB each; the expert activations [b, E, C, f] in
#: bf16 0.94 GB a tensor. 4 layers would come to ~75 GB of the card's 80.
MOE_TRAIN = dict(n_layers=2, batch=4, seq=2048, steps=6)
#: The serve cell's depth: 4 of 32 layers, 6.07 B parameters, 12.13 GB in
#: bf16 (the whole model, 93 GB, does not fit on one card; 16 layers before
#: the remat phase joined the default run, 8 before the mma flash kernels'
#: checks and route rows did, each cut to pay for them).
MOE_SERVE_LAYERS = 4
#: The exact f32 check's prompts (by index into SERVE_REQUESTS): 32 and 512
#: tokens, each its own prefill bucket's width, so that the engine's
#: prefill and the dense generate's have one capacity per expert; the
#: check also asserts that neither prefill overflows an expert.
MOE_F32_PROMPTS = (0, 4)


def moe_executed_flops(cfg, batch: int, seq: int) -> tuple[float, dict]:  # noqa: ANN001
    """FLOPs one training step of ``cfg`` executes, reckoned from its
    shapes (MFU's model FLOPs count active parameters instead): every
    product of a layer runs once forward, twice backward and once more
    under remat; the experts' SwiGLU runs over all E x C capacity slots
    (cf x k / E of the tokens per expert), the dispatch and combine einsums
    over [b, s, E, C]; attention over the causal pairs (2 products forward,
    7 backward with the recomputed S); the lm head forward, recomputed by
    the chunked loss and twice backward. -> (total, {part: flops})."""
    b, s, d, f, E = batch, seq, cfg.dim, cfg.ffn_dim, cfg.n_experts
    cap = max(1, int(cfg.capacity_factor * s * cfg.top_k / E))
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    tokens = b * s
    passes = 3 + int(cfg.remat)
    pairs = b * h * s * (s + 1) / 2
    parts = {
        "projections": 2 * tokens * d * (2 * h * hd + 2 * kvh * hd) * passes,
        "attention": 2 * pairs * hd * (2 * (1 + int(cfg.remat)) + 7),
        "router": 2 * tokens * d * E * passes,
        "dispatch_combine": 2 * 2 * b * s * E * cap * d * passes,
        "experts": 3 * 2 * b * E * cap * d * f * passes,
    }
    parts = {k: v * cfg.n_layers for k, v in parts.items()}
    parts["lm_head"] = 4 * 2 * tokens * d * cfg.vocab_size
    return sum(parts.values()), parts


def phase_moe_train() -> dict:
    """``train`` on ``mixtral_8x7b_shape(n_layers=2)`` (module docstring,
    phase 7): launch counts reset just before and read just after."""
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import moe
    from torchx_tpu_torch.ops.fused import flash_variant

    cfg = moe.mixtral_8x7b_shape(n_layers=MOE_TRAIN["n_layers"])
    batch, seq, steps = MOE_TRAIN["batch"], MOE_TRAIN["seq"], MOE_TRAIN["steps"]
    free_card()
    _build.reset_launches()
    out = train(cfg, batch, seq, steps, kernels="cuda", device="cuda", warmup=1, log_every=1)
    counts = _build.launch_counts()
    expected = expected_launches(cfg, steps)
    executed, parts = moe_executed_flops(cfg, batch, seq)
    model_flops = batch * seq * moe.mixtral_8x7b_shape(
        n_layers=MOE_TRAIN["n_layers"], max_seq=seq).flops_per_token()
    res = {
        "phase": "moe", "run": "train", "config": "mixtral_8x7b",
        "n_layers": cfg.n_layers, "dim": cfg.dim, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.head_dim,
        "flash_variant": flash_variant("flash_fwd", torch.bfloat16, cfg.head_dim),
        "ffn_dim": cfg.ffn_dim, "experts": [cfg.n_experts, cfg.top_k],
        "capacity_factor": cfg.capacity_factor, "vocab": cfg.vocab_size,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "batch": batch, "seq": seq, "steps": steps,
        "losses": out["losses"], "grad_norms": out["grad_norms"],
        "router_aux": out["router_aux"], "router_entropy": out["router_entropy"],
        "router_overflow": out["router_overflow"],
        "step_times_s": out["step_times_s"], "step_time_s": out["step_time_s"],
        "tokens_per_sec": out["tokens_per_sec"], "mfu": out["mfu"],
        "model_tflop_per_step": model_flops / 1e12,
        "executed_tflop_per_step": executed / 1e12,
        "executed_tflop_by_part": {k: v / 1e12 for k, v in parts.items()},
        "executed_share_of_peak": executed / out["step_time_s"] / PEAK_BF16_FLOPS,
        "peak_memory_bytes": out["peak_memory_bytes"],
        "launches": counts, "expected_launches": expected,
    }
    emit(res)
    if not all(math.isfinite(x) for x in out["losses"]):
        fail("moe", f"non-finite loss: {out['losses']}")
    if not all(len(out[k]) == steps and all(math.isfinite(x) for x in out[k])
               for k in ("router_aux", "router_entropy", "router_overflow")):
        fail("moe", "the router aux values are missing from a step")
    if cfg.head_dim != 128 or res["flash_variant"] != "wgmma":
        fail("moe", f"head_dim {cfg.head_dim} does not take the wgmma kernels")
    if counts != expected:
        fail("moe", f"launch counts {counts} != expected {expected}")
    return res


def phase_moe_remat(moe_train: dict) -> None:
    """The moe phase's run under ``dots_attn``, 3 steps (the ep phase runs
    ``dots`` and ``auto``): the losses its own (bitwise expected; within
    GANG_LOSS_RTOL), the flash forward launched once a layer a step, peak
    memory beside the fit probe's."""
    import dataclasses

    import torch

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import moe

    total = torch.cuda.get_device_properties(0).total_memory
    batch, seq = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    base = moe.mixtral_8x7b_shape(n_layers=MOE_TRAIN["n_layers"], kernels="cuda")
    for policy in ("dots_attn",):
        cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
        free_card()
        out = train(cfg, batch, seq, REMAT["steps"], kernels="cuda", device="cuda", warmup=1,
                    log_every=0)
        want = moe_train["losses"][:len(out["losses"])]
        rel = _rel_diff(out["losses"], want)
        fwd = out["launches_per_step"]["flash_fwd_wgmma"]
        emit({"phase": "moe", "run": "remat", "policy": out["remat_policy"],
              "losses": out["losses"], "losses_bitwise_full": out["losses"] == want,
              "loss_max_rel_diff_vs_full": rel, "step_time_s": out["step_time_s"],
              "tokens_per_sec": out["tokens_per_sec"], "mfu": out["mfu"],
              "peak_memory_bytes": out["peak_memory_bytes"],
              **_fit_estimates(cfg, batch, seq, total), "flash_fwd_per_step": fwd})
        if rel > GANG_LOSS_RTOL or fwd != REMAT_FLASH_FWD[policy] * cfg.n_layers:
            fail("moe", f"{policy}: losses {out['losses']} against full's {want}, {fwd}"
                 " flash forward launches a step")


def phase_moe_reference() -> None:
    """One step of ``mixtral_8x7b_shape(n_layers=1)`` with the kernels and
    with plain ops: loss and gradient norm within the dense reference
    phase's tolerances."""
    import dataclasses

    import torch

    from torchx_tpu_torch.examples.train_llama import (
        make_optimizer, make_train_step, synthetic_batch,
    )
    from torchx_tpu_torch.models import llama, moe

    res = {}
    for kernels, attn_impl in (("cuda", "auto"), ("reference", "xla")):
        cfg = dataclasses.replace(
            moe.mixtral_8x7b_shape(n_layers=1), max_seq=MOE_TRAIN["seq"], kernels=kernels,
            attn_impl=attn_impl,
        )
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda")
        step = make_train_step(cfg, make_optimizer(llama.leaves(params)))
        batch = synthetic_batch(cfg, MOE_TRAIN["batch"], MOE_TRAIN["seq"], device="cuda")
        out = step(params, batch)
        res[kernels] = {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
                        "aux": out["aux"].tolist()}
        del params, step, out
    k, r = res["cuda"], res["reference"]
    loss_rel = abs(k["loss"] - r["loss"]) / abs(r["loss"])
    gn_rel = abs(k["grad_norm"] - r["grad_norm"]) / abs(r["grad_norm"])
    emit({"phase": "moe", "run": "reference", "n_layers": 1, "cuda": k, "reference": r,
          "loss_rel_diff": loss_rel, "loss_rtol": REF_LOSS_RTOL,
          "grad_norm_rel_diff": gn_rel, "grad_norm_rtol": REF_GRAD_NORM_RTOL})
    if not (math.isfinite(k["loss"]) and loss_rel <= REF_LOSS_RTOL
            and gn_rel <= REF_GRAD_NORM_RTOL):
        fail("moe", f"kernels {k} vs reference {r}")


def phase_moe_serve() -> dict:
    """The serve phase's burst through ``generate_server`` with
    ``mixtral_8x7b_shape(n_layers=MOE_SERVE_LAYERS)`` (the preset's depth cut in-process,
    its width the published one), then the exact f32 check at 2 layers.
    Without the prefix cache: a prefix hit prefills the rest of a prompt as
    a chunk of its own, whose expert capacity differs from the cold
    prefill's, so a re-sent prompt's answer may change wherever a chunk
    overflows an expert (random routers overflow: the train line's
    ``router_overflow``)."""
    import torch

    from torchx_tpu_torch.models import moe

    preset = moe.CONFIGS["mixtral_8x7b"]
    moe.CONFIGS["mixtral_8x7b"] = lambda: preset(n_layers=MOE_SERVE_LAYERS)
    try:
        return phase_serve("mixtral_8x7b", "moe", lambda: preset(
            n_layers=2, dtype=torch.float32), f32_prompts=MOE_F32_PROMPTS, prefix_cache=False)
    finally:
        moe.CONFIGS["mixtral_8x7b"] = preset


def phase_moe_profile() -> None:
    """Where a MoE training step's device time goes: the moe phase's
    config, 3 steps through ``train(..., profile_dir=...)`` with the
    router, the experts, the MoE FFN (whose rest is the dispatch and
    combine einsums), AdamW, RoPE and the loss annotated; the 2 timed
    steps' kernels by part (``split_elementwise`` over every kernel)."""
    import shutil
    import tempfile

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import moe

    root = tempfile.mkdtemp(prefix="tpx_moe_trace_smoke_")
    restore = _annotate_ranges(SPLIT_RANGES + MOE_RANGES)
    try:
        free_card()
        out = train(moe.mixtral_8x7b_shape(n_layers=MOE_TRAIN["n_layers"]),
                    MOE_TRAIN["batch"], MOE_TRAIN["seq"], 3, kernels="cuda", device="cuda",
                    warmup=1, log_every=1, profile_dir=root)
        with open(out["profile_trace"]) as f:
            events = json.load(f)["traceEvents"]
    finally:
        restore()
        shutil.rmtree(root, ignore_errors=True)
    split = {k: v / 2 for k, v in sorted(split_elementwise(events, every_group=True).items())}
    emit({"phase": "moeprofile", "path": "mixtral_8x7b train step, by part",
          "step_time_s": out["step_times_s"][1:], "per_step_ms": split,
          "device_ms": sum(split.values())})


# ---------------------------------------------------------------------------
# phase 7b: ep -- expert parallelism, the MoE family as a gang
# ---------------------------------------------------------------------------

#: The ep phase: mixtral_8x7b's width cut to ``layers`` layers, ``steps``
#: steps on the train phase's batch; on one card two gloo ranks sharing it
#: at ``mesh`` (NCCL refuses two ranks on one card), against one process
#: (the moe phase's run, or its own), and a world of one through spmd_main
#: on NCCL against that process bitwise. Four cards or more: NCCL at
#: ``layers4`` layers, ``steps4`` steps, each mesh of ``meshes4`` at the
#: same global batch (``fsdp=4`` the one the others are held to). The whole
#: model (32 layers, 46.7 B parameters, 373 GB at 8 B a parameter with its
#: gradient and two bf16 moments) fits no four cards at any mesh.
EP = dict(layers=2, steps=3, mesh="ep=2", layers4=8, steps4=6,
          meshes4=("fsdp=4", "ep=4", "fsdp=2,ep=2"))
#: The four-card trajectories are held to ``fsdp=4``'s in f32 at 2 layers
#: with plain ops (the CPU tests' arithmetic, which equals the JAX step's
#: at every mesh): in bf16 a rounding that differs between meshes flips a
#: near-tied router choice, which moves the capacity slots of the row's
#: later tokens, and the losses part by more than 1e-2 within 4 updates
#: (fsdp=2,ep=2 1.6% at step 6 on four H100s, PERF.md §6), so the bf16
#: runs, the speed cell, are held to fsdp=4's on the first step (the same
#: weights) only.
EP_F32 = dict(layers=2, kernels="reference", dtype="float32", profile=False)


def rank_param_count(cfg, sizes: dict[str, int]) -> int:  # noqa: ANN001
    """Parameters one rank holds under a mesh of ``sizes``: each leaf's
    elements over the shards its spec splits it into."""
    from torchx_tpu_torch import convert
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.parallel.mesh import parts

    zero = dict.fromkeys(sizes, 0)
    specs = dict(llama.named_leaves(llama.param_specs(cfg)))
    return sum(math.prod(shape) // math.prod(parts(axes, sizes, zero)[0]
                                             for axes in specs[name])
               for name, shape in llama.named_leaves(convert.expected_shapes(cfg)))


def _ep_line(run: dict, final: dict, cards: int) -> dict:
    """The printed line of one ep run: its mesh, losses, router health,
    step times, memory a rank beside the reckoned parameters a rank, rank
    0's collectives by group beside the cost model's bytes."""
    from torchx_tpu_torch.models import moe
    from torchx_tpu_torch.parallel.mesh_config import parse_mesh_spec

    cfg = moe.mixtral_8x7b_shape(n_layers=run["layers"])
    sizes = parse_mesh_spec(run["mesh"]).resolve(final["world"])
    held = rank_param_count(cfg, sizes)
    return {"phase": "ep", "cards": cards, "config": "mixtral_8x7b",
            "n_layers": run["layers"], "steps": run["steps"], "mesh": final["mesh"],
            "backend": final["backend"], "world": final["world"],
            "losses": final["losses"], "grad_norms": final["grad_norms"],
            "router_aux": final["router_aux"], "router_overflow": final["router_overflow"],
            "profiled_step_times_s": final["step_times_s"],
            "profiled_step_time_s": final["step_time_s"],
            "tokens_per_sec_per_card": final["tokens_per_sec_per_card"], "mfu": final["mfu"],
            "params": cfg.param_count(), "params_per_rank": held,
            "reckoned_state_bytes_per_rank": 8 * held,
            "peak_memory_bytes_by_rank": final["peak_memory_bytes_by_rank"],
            "collectives_rank0": final.get("collectives"),
            "modeled_bytes_per_step": final["modeled_bytes_per_step"],
            "launches_by_rank": final["launches_by_rank"]}


def ep_run() -> dict:
    """The ep phase's run of two gloo ranks sharing the card, under
    ``--remat-policy dots`` (the launches and bits of ``full``)."""
    return {"config": "mixtral_8x7b", "layers": EP["layers"], "steps": EP["steps"],
            "name": "ep2", "mesh": EP["mesh"], "remat_policy": "dots"}


def phase_ep(moe_train: dict | None, final: dict | None = None) -> dict:
    """Expert parallelism (module docstring). ``moe_train``: the moe
    phase's one-process run at ``EP["layers"]`` layers on the train phase's
    batch, whose first ``EP["steps"]`` steps the gangs are held to; made
    here when None. ``final``: the results of :func:`ep_run` where the tp
    phase's launch carried it, else it is launched here. -> the ep=2 run's
    line, its ``launches_by_rank`` each rank's launches."""
    import torch

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import moe
    from torchx_tpu_torch.parallel.mesh_config import mesh_sizes_spec, parse_mesh_spec

    t0 = time.monotonic()
    cards = torch.cuda.device_count()
    if cards >= 4:
        return phase_ep_cards()
    cfg = moe.mixtral_8x7b_shape(n_layers=EP["layers"])
    n = EP["steps"]
    if moe_train is None or moe_train["n_layers"] != EP["layers"]:
        free_card()
        moe_train = train(cfg, TRAIN["batch"], TRAIN["seq"], n, kernels="cuda",
                          device="cuda", warmup=1, log_every=0)
    one = {k: moe_train[k][:n] for k in ("losses", "grad_norms")}
    free_card()
    run = ep_run()
    # under --remat-policy auto: one resolution for the gang (rank 0's probe
    # in a subprocess, the smallest card's budget), the same bits as full
    world1, = _tp_runs([{**run, "name": "world1", "mesh": "fsdp=-1", "profile": False,
                         "remat_policy": "auto"}], 1, "nccl", "ep")
    bitwise = (world1["losses"], world1["grad_norms"]) == (one["losses"], one["grad_norms"])
    emit({"phase": "ep", "run": "world 1", "mesh": world1["mesh"], "backend": world1["backend"],
          "losses": world1["losses"], "grad_norms": world1["grad_norms"],
          "one_process_losses": one["losses"], "one_process_grad_norms": one["grad_norms"],
          "bitwise": bitwise, "step_times_s": world1["step_times_s"],
          "remat_policy": world1["remat_policy"], "remat_trials": world1["remat_trials"],
          "launch_breakdown": world1["launch_breakdown"], "run_seconds": world1["seconds"]})
    if world1["remat_policy"] not in ("full", "dots", "dots_attn") or not world1["remat_trials"]:
        fail("ep", f"world 1 under --remat-policy auto ran {world1['remat_policy']}")
    if world1["world"] != 1 or not bitwise:
        fail("ep", f"world 1 {world1['losses']} / {world1['grad_norms']} against one process"
             f" {one['losses']} / {one['grad_norms']}")
    if final is None:
        final, = _tp_runs([run], 2, "gloo", "ep")
    expected = expected_launches(cfg, n)
    loss_rel = _rel_diff(final["losses"], one["losses"])
    gn_rel = _rel_diff(final["grad_norms"], one["grad_norms"])
    res = {**_ep_line(run, final, cards), "ranks_share_a_card": True,
           "remat_policy": final["remat_policy"],
           "one_process_losses": one["losses"], "one_process_grad_norms": one["grad_norms"],
           "one_process_params": cfg.param_count(),
           "loss_max_rel_diff": loss_rel, "loss_rtol": REF_LOSS_RTOL,
           "grad_norm_max_rel_diff": gn_rel, "grad_norm_rtol": REF_GRAD_NORM_RTOL,
           "modeled_grad_sync_s_per_step": final["comm_modeled_axis_s"],
           "run_seconds": final["seconds"], "expected_launches": expected}
    emit(res)
    want = mesh_sizes_spec(parse_mesh_spec(EP["mesh"]).resolve(2))
    if (final["world"], final["backend"], final["mesh"]) != (2, "gloo", want):
        fail("ep", f"{EP['mesh']} ran {final['world']} ranks on {final['backend']} as"
             f" {final['mesh']}")
    if loss_rel > REF_LOSS_RTOL or gn_rel > REF_GRAD_NORM_RTOL:
        fail("ep", f"{EP['mesh']}: {final['losses']} / {final['grad_norms']} against one"
             f" process {one['losses']} / {one['grad_norms']}")
    if any(launches != expected for launches in final["launches_by_rank"]):
        fail("ep", f"{EP['mesh']}: launches {final['launches_by_rank']} != {expected}")
    if not all(math.isfinite(x) for k in ("router_aux", "router_overflow") for x in final[k]):
        fail("ep", f"{EP['mesh']}: the router's aux values are not finite")
    if "ep,tp" not in (final.get("collectives") or {}).get("host_ms_per_step", {}):
        fail("ep", f"{EP['mesh']}: no collective over the expert group in rank 0's trace")
    emit({"phase": "ep", "run": "seconds", "seconds": time.monotonic() - t0})
    return res


def phase_ep_cards() -> dict:
    """Four cards or more: NCCL, one rank a card on four, mixtral_8x7b's
    width at ``EP["layers4"]`` layers in bf16, each mesh of
    ``EP["meshes4"]`` at the same global batch, its first loss within
    REF_LOSS_RTOL of ``fsdp=4``'s; for each the step time, tokens/s a
    card, MFU (active parameters), peak memory a rank, the collectives by
    group and the modeled bytes. Then each mesh again in f32 (``EP_F32``),
    its losses within GANG_LOSS_RTOL of ``fsdp=4``'s at every step."""
    t0 = time.monotonic()
    free_card()
    runs = [{"name": m.replace("=", "").replace(",", "_"), "config": "mixtral_8x7b",
             "layers": EP["layers4"], "mesh": m, "steps": EP["steps4"]} for m in EP["meshes4"]]
    f32 = [{**run, **EP_F32, "name": run["name"] + "_f32"} for run in runs]
    finals = _tp_runs(runs + f32, 4, "nccl", "ep", probe=True)
    finals, finals_f32 = finals[:len(runs)], finals[len(runs):]
    out = {}
    for run, final, exact in zip(runs, finals, finals_f32):
        first = _rel_diff(final["losses"][:1], finals[0]["losses"][:1])
        rel = _rel_diff(final["losses"], finals[0]["losses"])
        rel_f32 = _rel_diff(exact["losses"], finals_f32[0]["losses"])
        res = {**_ep_line(run, final, 4), "loss_max_rel_diff_vs_fsdp4": rel,
               "probe_peak_bytes_rank0": final["probe_peak_bytes_rank0"],
               "hbm_fit_total_bytes": final["hbm_fit_total_bytes"],
               "first_loss_rel_diff_vs_fsdp4": first, "loss_rtol_first_step": REF_LOSS_RTOL,
               "f32": {"n_layers": EP_F32["layers"], "kernels": EP_F32["kernels"],
                       "losses": exact["losses"], "grad_norms": exact["grad_norms"],
                       "router_overflow": exact["router_overflow"],
                       "loss_max_rel_diff_vs_fsdp4": rel_f32, "loss_rtol": GANG_LOSS_RTOL}}
        emit(res)
        if final["backend"] != "nccl" or final["world"] != 4:
            fail("ep", f"{run['mesh']} ran {final['world']} ranks on {final['backend']}")
        if not all(math.isfinite(x) for x in final["losses"] + exact["losses"]):
            fail("ep", f"{run['mesh']}: non-finite loss {final['losses']} {exact['losses']}")
        if first > REF_LOSS_RTOL or rel_f32 > GANG_LOSS_RTOL:
            fail("ep", f"{run['mesh']} losses {final['losses']} (f32 {exact['losses']})"
                 f" against fsdp=4's {finals[0]['losses']} (f32 {finals_f32[0]['losses']})")
        out[run["mesh"]] = res
    emit({"phase": "ep", "run": "seconds", "seconds": time.monotonic() - t0})
    return out


# ---------------------------------------------------------------------------
# phase 7c: pp -- pipeline stages, ring attention and Ulysses attention
# ---------------------------------------------------------------------------

#: One card: llama3_1b at full width cut to ``layers`` layers, ``steps``
#: steps on the train phase's batch, at each mesh of ``meshes`` (those of
#: ``ring`` with ring attention) on two gloo ranks sharing the card; the
#: attention check at ``attn`` (b, s, heads, kv heads, head_dim) over
#: ``sp=2`` within ``tols`` (forward, dq) by op, the JAX package's tests'
#: (``tests/test_model_stack.py``). Four cards: NCCL at full depth,
#: ``steps4`` steps at ``meshes4`` (``ring4`` with ring attention), then
#: the long sequence ``long`` with ring attention and with the gather.
PP = dict(layers=2, steps=3, meshes=("pp=2", "sp=2"), ring=("sp=2",),
          attn=(4, 2048, 32, 8, 64), tols={"ring": (2e-5, 1e-4), "ulysses": (1e-6, 1e-5)},
          steps4=4, meshes4=("pp=4", "pp=2,fsdp=2", "pp=2,tp=2", "pp=2,sp=2"),
          ring4=("pp=2,sp=2",), long=dict(batch=1, seq=16384, mesh="sp=4"))


def _run_name(prefix: str, mesh: str) -> str:
    return prefix + mesh.replace("=", "").replace(",", "_")


def pp_runs() -> list[dict]:
    """The pp phase's runs on one card (two gloo ranks): its meshes, then
    the attention check."""
    runs = [{"name": _run_name("pp_", m), "config": "llama3_1b", "layers": PP["layers"],
             "mesh": m, "steps": PP["steps"], "ring": m in PP["ring"]} for m in PP["meshes"]]
    runs.append({"name": "attn", "kind": "attn", "mesh": "sp=2,fsdp=1",
                 "shape": list(PP["attn"]), "seed": 11})
    return runs


def pp_launches(cfg, steps: int, sizes: dict[str, int], ring: bool,  # noqa: ANN001
                batch: int) -> dict[str, int]:
    """A rank's launches over ``steps`` steps of ``cfg`` under a mesh of
    ``sizes``: :func:`expected_launches` with a stage's layers times the
    pipeline's microbatches in place of the layers under ``pp``, and no
    flash launch under ring attention over ``sp`` (the ring's products
    take the kernels' place)."""
    import dataclasses

    from torchx_tpu_torch.parallel.pipeline import auto_microbatches

    pp, n = sizes["pp"], cfg.n_layers
    if pp > 1:
        rows = batch // (sizes["dp"] * sizes["fsdp"])
        n = cfg.n_layers // pp * auto_microbatches(cfg.pp_microbatches, pp, rows)
    out = expected_launches(dataclasses.replace(cfg, n_layers=n), steps)
    if ring and sizes["sp"] > 1:
        out.update({k: 0 for k in out if k.startswith("flash_")})
    return out


def _pp_line(run: dict, final: dict, cards: int) -> dict:
    return {"phase": "pp", "cards": cards, "config": run["config"],
            "n_layers": run["layers"], "steps": run["steps"], "mesh": final["mesh"],
            "ring_attention": bool(run.get("ring")), "backend": final["backend"],
            "world": final["world"], "batch": run.get("batch", TRAIN["batch"]),
            "seq": run.get("seq", TRAIN["seq"]), "losses": final["losses"],
            "grad_norms": final["grad_norms"],
            "profiled_step_times_s": final["step_times_s"],
            "profiled_step_time_s": final["step_time_s"],
            "tokens_per_sec_per_card": final["tokens_per_sec_per_card"], "mfu": final["mfu"],
            "peak_memory_bytes_by_rank": final["peak_memory_bytes_by_rank"],
            "probe_peak_bytes_rank0": final.get("probe_peak_bytes_rank0"),
            "hbm_fit_total_bytes": final["hbm_fit_total_bytes"],
            "collectives_rank0": final.get("collectives"),
            "modeled_bytes_per_step": final["modeled_bytes_per_step"],
            "launches_by_rank": final["launches_by_rank"], "run_seconds": final["seconds"]}


def _check_attn(final: dict) -> None:
    emit({"phase": "pp", "run": "attention", **final, "tols": PP["tols"]})
    for rank, by_op in enumerate(final["by_rank"]):
        for op, (fwd_tol, dq_tol) in PP["tols"].items():
            err = by_op[op]
            if not (err["max_abs_err"] <= fwd_tol and err["dq_max_abs_err"] <= dq_tol):
                fail("pp", f"{op} on rank {rank}: {err} beyond {fwd_tol} / {dq_tol}")


def phase_pp(one: dict | None, finals: list[dict] | None = None) -> dict:
    """Pipeline stages and ring attention (module docstring). ``one``: the
    one-process run of llama3_1b at ``PP["layers"]`` layers and
    ``PP["steps"]`` steps on the train phase's batch (the tp phase's
    ``one_process_*`` entries), made here when None. ``finals``: the
    results of :func:`pp_runs` where the tp phase's launch carried them,
    else they are launched here. -> the lines by mesh."""
    import torch

    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.parallel.mesh_config import mesh_sizes_spec, parse_mesh_spec

    t0 = time.monotonic()
    cards = torch.cuda.device_count()
    if cards >= 4:
        return phase_pp_cards()
    cfg = llama.llama3_1b(n_layers=PP["layers"])
    if one is None:
        free_card()
        run = train(cfg, TRAIN["batch"], TRAIN["seq"], PP["steps"], kernels="cuda",
                    device="cuda", warmup=1, log_every=0)
        one = {"one_process_" + k: run[k] for k in
               ("losses", "grad_norms", "step_time_s", "peak_memory_bytes")}
    runs = pp_runs()
    if finals is None:
        free_card()
        finals = _tp_runs(runs, 2, "gloo", "pp")
    out = {}
    for run, final in zip(runs, finals):
        if run.get("kind") == "attn":
            _check_attn(final)
            continue
        sizes = parse_mesh_spec(run["mesh"]).resolve(2)
        expected = pp_launches(cfg, PP["steps"], sizes, run["ring"], TRAIN["batch"])
        loss_rel = _rel_diff(final["losses"], one["one_process_losses"])
        gn_rel = _rel_diff(final["grad_norms"], one["one_process_grad_norms"])
        res = {**_pp_line(run, final, cards), "ranks_share_a_card": True, **one,
               "loss_max_rel_diff": loss_rel, "loss_rtol": REF_LOSS_RTOL,
               "grad_norm_max_rel_diff": gn_rel, "grad_norm_rtol": REF_GRAD_NORM_RTOL,
               "modeled_grad_sync_s_per_step": final["comm_modeled_axis_s"],
               "expected_launches": expected}
        emit(res)
        if (final["world"], final["backend"], final["mesh"]) != (2, "gloo",
                                                                 mesh_sizes_spec(sizes)):
            fail("pp", f"{run['mesh']} ran {final['world']} ranks on {final['backend']} as"
                 f" {final['mesh']}")
        if loss_rel > REF_LOSS_RTOL or gn_rel > REF_GRAD_NORM_RTOL:
            fail("pp", f"{run['mesh']}: {final['losses']} / {final['grad_norms']} against one"
                 f" process {one['one_process_losses']} / {one['one_process_grad_norms']}")
        if any(launches != expected for launches in final["launches_by_rank"]):
            fail("pp", f"{run['mesh']}: launches {final['launches_by_rank']} != {expected}")
        axis = "pp" if sizes["pp"] > 1 else "sp"
        if axis not in (final.get("collectives") or {}).get("host_ms_per_step", {}):
            fail("pp", f"{run['mesh']}: no collective:{axis} range in rank 0's trace")
        out[run["mesh"]] = res
    emit({"phase": "pp", "run": "seconds", "seconds": time.monotonic() - t0})
    return out


def phase_pp_cards() -> dict:
    """Four cards or more: NCCL, one rank a card on four, llama3_1b at
    full depth (module docstring)."""
    from torchx_tpu_torch.examples.train_llama import train
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.parallel.mesh_config import parse_mesh_spec

    t0 = time.monotonic()
    free_card()
    cfg = llama.llama3_1b()
    one = train(cfg, TRAIN["batch"], TRAIN["seq"], PP["steps4"], kernels="cuda",
                device="cuda", warmup=1, log_every=0)
    emit({"phase": "pp", "run": "one process", "cards": 4, "losses": one["losses"],
          "grad_norms": one["grad_norms"], "step_time_s": one["step_time_s"],
          "peak_memory_bytes": one["peak_memory_bytes"]})
    free_card()
    runs = [{"name": _run_name("pp4_", m), "config": "llama3_1b", "layers": None, "mesh": m,
             "steps": PP["steps4"], "ring": m in PP["ring4"]} for m in PP["meshes4"]]
    long = PP["long"]
    runs += [{"name": f"long_{kind}", "config": "llama3_1b", "layers": None,
              "mesh": long["mesh"], "steps": PP["steps4"], "batch": long["batch"],
              "seq": long["seq"], "ring": kind == "ring"} for kind in ("gather", "ring")]
    finals = _tp_runs(runs, 4, "nccl", "pp", probe=True, timeout_s=1500)
    out = {}
    for run, final in zip(runs, finals):
        sizes = parse_mesh_spec(run["mesh"]).resolve(4)
        batch = run.get("batch", TRAIN["batch"])
        expected = pp_launches(cfg, run["steps"], sizes, run["ring"], batch)
        res = {**_pp_line(run, final, 4), "expected_launches": expected}
        if "seq" not in run:
            res["loss_max_rel_diff"] = _rel_diff(final["losses"], one["losses"])
            res["one_process_losses"] = one["losses"]
        emit(res)
        if final["backend"] != "nccl" or final["world"] != 4:
            fail("pp", f"{run['mesh']} ran {final['world']} ranks on {final['backend']}")
        if not all(math.isfinite(x) for x in final["losses"]):
            fail("pp", f"{run['name']}: non-finite loss {final['losses']}")
        if res.get("loss_max_rel_diff", 0.0) > REF_LOSS_RTOL:
            fail("pp", f"{run['mesh']}: losses {final['losses']} against one process"
                 f" {one['losses']}")
        if any(launches != expected for launches in final["launches_by_rank"]):
            fail("pp", f"{run['name']}: launches {final['launches_by_rank']} != {expected}")
        out[run["name"]] = res
    gather, ring = out["long_gather"], out["long_ring"]
    rel = _rel_diff(ring["losses"], gather["losses"])
    emit({"phase": "pp", "run": "long sequence", "mesh": long["mesh"], "seq": long["seq"],
          "ring_vs_gather_loss_max_rel_diff": rel,
          "step_time_s": {"gather": gather["profiled_step_time_s"],
                          "ring": ring["profiled_step_time_s"]},
          "peak_memory_bytes_by_rank": {"gather": gather["peak_memory_bytes_by_rank"],
                                        "ring": ring["peak_memory_bytes_by_rank"]},
          "sp_device_ms_per_step": {
              k: (v["collectives_rank0"] or {}).get("device_ms_per_step", {}).get("sp")
              for k, v in (("gather", gather), ("ring", ring))},
          "modeled_sp_bytes_per_step": {"gather": gather["modeled_bytes_per_step"].get("sp"),
                                        "ring": ring["modeled_bytes_per_step"].get("sp")}})
    if rel > REF_LOSS_RTOL:
        fail("pp", f"the long sequence: ring {ring['losses']} against gather"
             f" {gather['losses']}")
    emit({"phase": "pp", "run": "seconds", "seconds": time.monotonic() - t0})
    return out


# ---------------------------------------------------------------------------
# phase 8: int8 -- the trainer's int8 matmuls, weight-only llama3_8b serving
# ---------------------------------------------------------------------------

#: Projections a layer sends through the int8 training dot, by scope.
INT8_DOTS_PER_LAYER = {"all": 7, "ffn": 3}
#: The first step's int8 loss may lie this far from the bf16 one on the
#: same weights and batch (tests/test_quant.py's criterion).
INT8_LOSS_GAP = 0.2
#: int8 against bf16 logits on one token stream: mean |gap| over mean
#: |bf16 logit| below this at tests/test_quant.py's depth (2 layers), here
#: at llama3_8b's width. The gap grows with depth from the weights'
#: rounding alone (PERF.md, PR 8): the full-depth gap is printed beside.
INT8_LOGIT_GAP = 0.05
INT8_LOGIT_LAYERS = 2
#: The serve burst's prompt whose bf16 completion is the compared stream.
INT8_STREAM_PROMPT = 3
#: Parameter bytes resident after the server's setup may miss the
#: reckoning by this share.
INT8_BYTES_RTOL = 0.01
#: The int8 serve cell's depth: llama3_8b's width at 4 of its 32 layers
#: (8.03 B parameters at full depth before the remat phase joined the
#: default run, 16 layers until the gangckpt phase's supervised resume
#: joined it, 8 until the pool phase did: each cut to pay for them).
INT8_SERVE_LAYERS = 4
#: The projection matrices weight-only int8 quantizes.
INT8_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def reckoned_param_bytes(cfg, int8: bool) -> int:  # noqa: ANN001
    """Parameter bytes of a dense config in bf16 or, under weight-only
    int8, with every projection (and an untied head) one byte a weight
    plus an f32 scale per output column, from the config's shapes."""
    if not int8:
        return 2 * cfg.param_count()
    d, f, v, L, hd = cfg.dim, cfg.ffn_dim, cfg.vocab_size, cfg.n_layers, cfg.head_dim
    proj = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd), (d, cfg.n_kv_heads * hd),
            (cfg.n_heads * hd, d), (d, f), (d, f), (f, d)]
    heads = [] if cfg.tie_embeddings else [(d, v)]
    return (2 * (v * d + (2 * L + 1) * d) + L * sum(i * o + 4 * o for i, o in proj)
            + sum(i * o + 4 * o for i, o in heads))


def phase_int8_train(bf16: dict | None) -> list[dict]:
    """llama3_1b trained with int8 matmuls under both scopes, in the train
    phase's setting, through the trainer's own flag mapping; beside the
    bf16 run (the train phase's, or one run here)."""
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.examples.train_llama import int8_config, train
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.ops import quant

    args = (TRAIN["batch"], TRAIN["seq"], TRAIN["steps"])
    kw = dict(kernels="cuda", device="cuda", warmup=1, log_every=1)
    if bf16 is None:
        free_card()
        bf16 = train(llama.llama3_1b(), *args, **kw)
    lines = []
    for scope in INT8_DOTS_PER_LAYER:
        cfg = int8_config(llama.llama3_1b(), scope=scope)  # --int8-scope <scope>
        free_card()
        _build.reset_launches()
        quant.reset_int8_dot_calls()
        out = train(cfg, *args, **kw)
        counts, dots = _build.launch_counts(), quant.int8_dot_calls()
        expected = expected_launches(cfg, TRAIN["steps"])
        # each projection: the forward, its remat recompute, two backward dots
        want_dots = (TRAIN["steps"] * cfg.n_layers * INT8_DOTS_PER_LAYER[scope]
                     * (3 + int(cfg.remat)))
        losses = out["losses"]
        line = {"phase": "int8", "run": "train", "config": "llama3_1b", "int8_scope": scope,
                "reported_scope": out["int8_scope"], **TRAIN, "losses": losses,
                "bf16_first_loss": bf16["losses"][0],
                "first_loss_gap": abs(losses[0] - bf16["losses"][0]),
                "grad_norms": out["grad_norms"], "step_times_s": out["step_times_s"],
                "step_time_s": out["step_time_s"], "bf16_step_time_s": bf16["step_time_s"],
                "tokens_per_sec": out["tokens_per_sec"],
                "bf16_tokens_per_sec": bf16["tokens_per_sec"],
                "mfu": out["mfu"], "bf16_mfu": bf16["mfu"],
                "peak_memory_bytes": out["peak_memory_bytes"],
                "bf16_peak_memory_bytes": bf16["peak_memory_bytes"],
                "int8_dots": dots, "expected_int8_dots": want_dots, "launches": counts}
        emit(line)
        if not all(math.isfinite(x) for x in losses):
            fail("int8", f"scope {scope}: non-finite loss {losses}")
        if out["int8_scope"] != scope:
            fail("int8", f"the run's record names scope {out['int8_scope']}, not {scope}")
        if not line["first_loss_gap"] < INT8_LOSS_GAP:
            fail("int8", f"scope {scope}: first loss {losses[0]} vs bf16 {bf16['losses'][0]}")
        if counts != expected:
            fail("int8", f"scope {scope}: launch counts {counts} != the bf16 run's {expected}")
        if dots != want_dots:
            fail("int8", f"scope {scope}: {dots} int8 dots, reckoned {want_dots}")
        lines.append(line)
        del out
    torch.cuda.synchronize()
    return lines


def _profile_decode_step(params, cfg, pools, block_size: int) -> dict:  # noqa: ANN001
    """One paged decode step at 8 busy slots, each 1024 tokens deep in the
    server's own (idle) pools, after two warm-up steps: five steps timed
    unprofiled in this thread (``step_alone_ms``), one under cProfile (the
    host's time by Python function), one profiled on the card: device time
    split into the int8-weight matmuls, the K/V gathers and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchx_tpu_torch.models import generate as gen

    slots, depth = SERVE["max_batch"], 1024
    bpr = cfg.max_seq // block_size
    per = depth // block_size
    tables = torch.zeros((slots, bpr), dtype=torch.int64, device="cuda")
    tables[:, :per] = 1 + torch.arange(slots * per, device="cuda").view(slots, per)
    positions = torch.full((slots,), depth - 1, dtype=torch.int64, device="cuda")
    tokens = torch.arange(slots, device="cuda") * 997 % cfg.vocab_size
    seeds = torch.zeros((slots,), dtype=torch.int64, device="cuda")
    temps = torch.zeros((slots,), device="cuda")

    def step():  # noqa: ANN202
        return gen.paged_decode_step(params, tokens, positions, tables, pools, cfg,
                                     seeds, temps).cpu()

    step()
    step()
    # unprofiled, and the host's own time by Python function (cProfile)
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    alone_ms = 1e3 * (time.perf_counter() - t0) / 5
    host = cProfile.Profile()
    host.enable()
    step()
    host.disable()
    stats = pstats.Stats(host)
    host_top = sorted(((v[2], v[1], f"{k[0].rsplit('/', 1)[-1]}:{k[1]}({k[2]})")
                       for k, v in stats.stats.items()), reverse=True)[:12]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        wall = time.monotonic() - t0
    summary = _device_summary(prof, wall)
    summary.update(step_alone_ms=alone_ms, host_top=[
        {"fn": fn, "calls": calls, "self_ms": 1e3 * t} for t, calls, fn in host_top])
    int8_ms = summary["groups_ms"].get("int8_matmul", 0.0)
    # the K/V reads: the block gathers and the strided copies that lay the
    # gathered K and V out for the attention products (ops/paged_attention.py
    # _attend)
    kv_ms = 0.0
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0))
        if "gather" in ev.key or ("direct_copy_kernel" in ev.key
                                  and "unrolled_elementwise" not in ev.key):
            kv_ms += us / 1e3
    return {"slots": slots, "depth": depth, **summary, "int8_matmul_ms": int8_ms,
            "kv_gather_ms": kv_ms, "rest_ms": summary["device_busy_ms"] - int8_ms - kv_ms}


def _int8_inspect(run: dict, shared: dict, int8: bool) -> dict:
    """While a llama3_8b server is up: its parameters' dtypes and resident
    bytes against the reckoning, the logits of one token stream (the bf16
    run keeps them; the int8 run compares), a profiled decode step."""
    import torch

    from torchx_tpu_torch.models import generate as gen
    from torchx_tpu_torch.ops import quant

    cfg, params, engine = run["cfg"], run["params"], run["engine"]
    proj = {k: params["layers"][k] for k in INT8_KEYS} | {"lm_head": params["lm_head"]}

    def is_int8(v) -> bool:  # noqa: ANN001
        return (isinstance(v, dict) and v["q"].dtype == torch.int8
                and v["scale"].dtype == torch.float32)

    wrong = [k for k, v in proj.items()
             if (not is_int8(v) if int8 else getattr(v, "dtype", None) != torch.bfloat16)]
    if wrong:
        fail("int8", f"projection leaves {wrong} are not "
                     + ("int8 with f32 scales" if int8 else "bf16"))
    if params["embed"].dtype != torch.bfloat16:
        fail("int8", f"the embedding is {params['embed'].dtype}, not bf16")
    # what the server's setup left allocated, less its KV pools: the
    # parameters, and nothing of the float tree an int8 server quantized
    pool_bytes = sum(t.numel() * t.element_size() for t in engine.pools.values())
    resident = run["setup_allocated"] - pool_bytes
    reckoned = reckoned_param_bytes(cfg, int8)
    tree = quant.size_bytes(params)
    line = {"resident_param_bytes": resident, "param_tree_bytes": tree,
            "reckoned_param_bytes": reckoned,
            "resident_rel_gap": abs(resident - reckoned) / reckoned}
    if not (line["resident_rel_gap"] <= INT8_BYTES_RTOL
            and abs(tree - reckoned) <= INT8_BYTES_RTOL * reckoned):
        fail("int8", f"parameter bytes: resident {resident}, tree {tree}, reckoned {reckoned}")
    line["decode_profile"] = _profile_decode_step(params, cfg, engine.pools,
                                                  engine.block_size)
    # the same token stream through both trees: the bf16 run's prompt and
    # completion
    if not int8:
        shared["stream"] = run["prompts"][INT8_STREAM_PROMPT] + run["completions"][
            INT8_STREAM_PROMPT]
    stream = torch.tensor([shared["stream"]], device="cuda")
    cache = gen.init_kv_cache(cfg, 1, stream.shape[1], "cuda")
    logits = gen.forward_with_cache(params, stream, cache, 0, cfg)[0][0].cpu()
    del cache
    if int8:
        ref = shared.pop("logits")
        # the same stream through the plain int8 path: what the kernel adds
        # to the weights' rounding (bf16 sums in another order)
        kernel_int8 = quant.int8_matmul, gen.int8_matmul
        quant.int8_matmul = gen.int8_matmul = quant._int8_matmul_plain
        try:
            cache = gen.init_kv_cache(cfg, 1, stream.shape[1], "cuda")
            plain = gen.forward_with_cache(params, stream, cache, 0, cfg)[0][0].cpu()
            del cache
        finally:
            quant.int8_matmul, gen.int8_matmul = kernel_int8
        line.update(full_depth_logit_gap=_logit_gap(logits, ref),
                    full_depth_argmax_agreement=_argmax_agreement(logits, ref),
                    kernel_vs_plain_logit_gap=_logit_gap(logits, plain),
                    kernel_vs_plain_argmax_agreement=_argmax_agreement(logits, plain),
                    stream_tokens=len(shared["stream"]))
    else:
        shared["logits"] = logits
    return line


def _logit_gap(logits, ref) -> float:  # noqa: ANN001
    """Mean |logits - ref| over mean |ref| (tests/test_quant.py's measure)."""
    return float((logits - ref).abs().mean() / ref.abs().mean())


def _argmax_agreement(logits, ref) -> float:  # noqa: ANN001
    return float((logits.argmax(-1) == ref.argmax(-1)).float().mean())


def _int8_logits_check(stream: list[int], full_depth: dict) -> dict:
    """tests/test_quant.py's criterion where it was set, at 2 layers, here
    at llama3_8b's width: the seeded bf16 weights and their int8 tree (the
    int8-weight matmul on the card) on the serve run's token stream."""
    import torch

    from torchx_tpu_torch.models import generate as gen
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.ops import quant

    free_card()
    cfg = llama.llama3_8b(n_layers=INT8_LOGIT_LAYERS)
    g = torch.Generator(device="cuda")
    g.manual_seed(SERVE["seed"])
    params = llama.init_params(cfg, g, "cuda")
    for leaf in llama.leaves(params):
        leaf.requires_grad_(False)
    tokens = torch.tensor([stream], device="cuda")

    def logits(tree):  # noqa: ANN001, ANN202
        cache = gen.init_kv_cache(cfg, 1, tokens.shape[1], "cuda")
        return gen.forward_with_cache(tree, tokens, cache, 0, cfg)[0][0].cpu()

    ref = logits(params)
    got = logits(quant.quantize_params(params))
    line = {"phase": "int8", "check": "int8 against bf16 logits", "n_layers": cfg.n_layers,
            "dim": cfg.dim, "tokens": len(stream), "mean_rel_gap": _logit_gap(got, ref),
            "argmax_agreement": _argmax_agreement(got, ref), "tol": INT8_LOGIT_GAP,
            "full_depth": full_depth}
    emit(line)
    del params
    free_card()
    if not line["mean_rel_gap"] < INT8_LOGIT_GAP:
        fail("int8", f"int8 logits' mean relative gap {line['mean_rel_gap']} >= {INT8_LOGIT_GAP}"
                     f" at {cfg.n_layers} layers")
    return line


#: The f32 int8 path's check: llama3_8b's width at one layer in f32 (5.1 GB
#: of f32 weights before quantizing), a 32-token prompt and 4 new tokens;
#: its logits within 1e-4 of the largest of the same forward on the weights
#: dequantized to f32 (the int8 product and the plain f32 one differ by the
#: order of their f32 sums only).
INT8_F32_PATH = dict(layers=1, prompt=32, new_tokens=4, tol=1e-4)


def phase_int8_f32_path() -> dict:
    """The f32-activation int8 kernel through the serving path's entry
    points: llama3_8b's width at ``INT8_F32_PATH["layers"]`` layer in f32,
    seeded weights quantized in place, one ``forward_with_cache`` prefill
    and ``generate`` (the dense generate) with the launch counts reset just
    before and read just after; the prefill's logits held to the same
    forward on the weights dequantized to f32 (plain f32 matmuls, TF32
    off). -> its line, with the launches by kernel."""
    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.models import generate as gen
    from torchx_tpu_torch.models import llama
    from torchx_tpu_torch.ops import quant

    free_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.llama3_8b(n_layers=INT8_F32_PATH["layers"], dtype=torch.float32)
    g = torch.Generator(device="cuda")
    g.manual_seed(SERVE["seed"])
    tree = llama.init_params(cfg, g, "cuda")
    for leaf in llama.leaves(tree):
        leaf.requires_grad_(False)
    tree = quant.quantize_params(tree, inplace=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, INT8_F32_PATH["prompt"]), generator=g,
                           device="cuda")

    def logits(params):  # noqa: ANN001, ANN202
        cache = gen.init_kv_cache(cfg, 1, tokens.shape[1], "cuda")
        return gen.forward_with_cache(params, tokens, cache, 0, cfg)[0][0]

    torch.cuda.synchronize()
    _build.reset_launches()
    got = logits(tree)
    new = gen.generate(tree, tokens, cfg, INT8_F32_PATH["new_tokens"])
    torch.cuda.synchronize()
    launches = {k: n for k, n in _build.launch_counts().items() if n}

    def dequantized(node):  # noqa: ANN001, ANN202
        if isinstance(node, dict) and "q" in node:
            return quant.dequantize(node["q"], node["scale"], torch.float32)
        if isinstance(node, dict):
            return {k: dequantized(v) for k, v in node.items()}
        return node

    ref = logits(dequantized(tree))
    line = {"phase": "int8", "check": "int8 f32 against dequantized f32 logits",
            "n_layers": cfg.n_layers, "dim": cfg.dim, "tokens": tokens.shape[1],
            "rel_err": rel_err(got, ref), "tol": INT8_F32_PATH["tol"],
            "finite": bool(torch.isfinite(got).all()),
            "new_tokens": new[0, tokens.shape[1]:].tolist(), "launches": launches}
    emit(line)
    del tree, got, ref
    free_card()
    if not line["finite"] or not line["rel_err"] <= INT8_F32_PATH["tol"]:
        fail("int8", f"f32 int8 logits: err {line['rel_err']} > {INT8_F32_PATH['tol']}")
    if set(launches) != {"int8_matmul_tf32"}:
        fail("int8", f"the f32 int8 path launched {launches}, want int8_matmul_tf32 alone")
    return line


def phase_int8_serve() -> dict:
    """``generate_server`` in-process with llama3_8b at full width (dim
    4096, untied) cut to ``INT8_SERVE_LAYERS`` layers in-process, seeded
    weights, the serve phase's burst: first bf16, then ``--int8``, each
    freed before the next. -> the int8 run's serve line."""
    from torchx_tpu_torch.models import llama

    shared: dict = {}
    runs = {}
    preset = llama.CONFIGS["llama3_8b"]
    llama.CONFIGS["llama3_8b"] = lambda: preset(n_layers=INT8_SERVE_LAYERS)
    try:
        for int8 in (False, True):
            free_card()
            runs[int8] = phase_serve(
                "llama3_8b", "int8", int8=int8,
                inspect=lambda run, int8=int8: _int8_inspect(run, shared, int8))
    finally:
        llama.CONFIGS["llama3_8b"] = preset
    free_card()
    logits_check = _int8_logits_check(shared["stream"], {
        "n_layers": runs[True]["n_layers"], "mean_rel_gap": runs[True]["full_depth_logit_gap"],
        "argmax_agreement": runs[True]["full_depth_argmax_agreement"]})
    keys = ("ttft_p50_ms", "ttft_max_ms", "tpot_p50_ms", "tokens_per_s",
            "decode_step_full_ms", "peak_memory_bytes", "setup_peak_bytes",
            "resident_param_bytes")
    emit({"phase": "int8", "run": "serve summary", "config": "llama3_8b",
          "logit_gap": {"layers_2": logits_check["mean_rel_gap"],
                        f"layers_{INT8_SERVE_LAYERS}": runs[True]["full_depth_logit_gap"]},
          **{f"{k}": {"bf16": runs[False][k], "int8": runs[True][k]} for k in keys},
          "decode_device_ms": {
              name: {"bf16": runs[False]["decode_profile"][k],
                     "int8": runs[True]["decode_profile"][k]}
              for name, k in (("busy", "device_busy_ms"), ("int8_matmul", "int8_matmul_ms"),
                              ("kv_gather", "kv_gather_ms"), ("rest", "rest_ms"),
                              ("wall", "step_wall_ms"), ("alone", "step_alone_ms"))}})
    return runs[True]


def phase_int8_profile() -> None:
    """One llama3_1b training step profiled in bf16 and with int8 matmuls
    (scope all), each after a warm-up step: device time by kernel group,
    the int8 products (cuBLASLt's int8 kernels, by name) apart, and each
    group's change from bf16 to int8 (the quantize passes run op by op in
    the elementwise group)."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchx_tpu_torch.examples.train_llama import (
        int8_config, make_optimizer, make_train_step, synthetic_batch,
    )
    from torchx_tpu_torch.models import llama

    out = {}
    for scope in (None, "all"):
        cfg = int8_config(dataclasses.replace(
            llama.llama3_1b(), max_seq=TRAIN["seq"], kernels="cuda"), scope=scope)
        free_card()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = llama.init_params(cfg, gen, "cuda")
        step = make_train_step(cfg, make_optimizer(llama.leaves(params)))
        batch = synthetic_batch(cfg, TRAIN["batch"], TRAIN["seq"], device="cuda")
        step(params, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            step(params, batch)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        summary = _device_summary(prof, wall)
        int8_gemm = elementwise = 0.0
        for ev in prof.key_averages():
            us = (getattr(ev, "self_device_time_total", None)
                  or getattr(ev, "self_cuda_time_total", 0))
            name = ev.key.lower()
            if (any(t in name for t in ("s8", "i8", "imma", "int8"))
                    and not name.startswith("void at::")):
                int8_gemm += us / 1e3
            elif "elementwise" in name or "reduce_kernel" in name:
                elementwise += us / 1e3
        summary.update(int8_gemm_ms=int8_gemm, elementwise_ms=elementwise)
        out[scope or "bf16"] = summary
        emit({"phase": "int8profile", "path": "train step", "int8_scope": scope, **summary})
        del params, step, batch
    emit({"phase": "int8profile", "path": "int8 step less bf16 step", "ms": {
        k: out["all"][k] - out["bf16"][k]
        for k in ("step_wall_ms", "device_busy_ms", "int8_gemm_ms", "elementwise_ms")}})


def ptxas_summary(log: str) -> dict[str, str]:
    """kernel<type,head_dim> (a wgmma flash kernel: <head_dim,block_q,
    block_kv>; an mma one: <type,head_dim,block_q,block_kv,warps along the
    head dim>) -> ptxas's
    spill and register lines, from the ``-Xptxas -v`` build log, and
    ptxas's warnings (such as a wgmma serialised for want of registers)."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function .*?\d(flash_\w+_wgmma_kernel)"
                          r"ILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", line):
            # flash_*_wgmma_kernel<head_dim,block_q,block_kv[,seg]>
            seg = ",seg" if m.group(5) == "1" else ""
            name = f"{m.group(1)}<{m.group(2)},{m.group(3)},{m.group(4)}{seg}>"
            out[name] = ""
            continue
        if m := re.search(r"Compiling entry function .*?\d(flash_\w+_mma_kernel)I(f|13__nv_bfloat16)"
                          r"Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E", line):
            # flash_*_mma_kernel<dtype,head_dim,block_q,block_kv,warps along d[,seg]>
            dtype = "f32" if m.group(2) == "f" else "bf16"
            seg = ",seg" if m.group(7) == "1" else ""
            name = (f"{m.group(1)}<{dtype},{m.group(3)},{m.group(4)},{m.group(5)},"
                    f"{m.group(6)}{seg}>")
            out[name] = ""
            continue
        m = re.search(
            r"Compiling entry function .*?\d(flash_\w+?_kernel)I(\w*?)Li(\d+)E(Lb1E)?", line)
        if m:
            dtype = "f32" if m.group(2) == "f" else "bf16"
            seg = ",seg" if m.group(4) else ""
            name = f"{m.group(1)}<{dtype},{m.group(3)}{seg}>"
            out[name] = ""
        elif m := re.search(r"Compiling entry function .*?\d((?:int8_decode|int8_wgmma|int8_tf32)"
                            r"_kernel)(I\w*?E)?E", line):
            # int8_decode_kernel<f32 output>, int8_wgmma_kernel<warpgroups, f32 output>
            name = f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2) or ''))}>"
            out[name] = ""
        elif name and ("spill" in line or "Used" in line):
            out[name] = (out[name] + "; " + line.split(":", 1)[-1].strip()).strip("; ")
        elif re.search(r"\(C\d+\)", line):
            out.setdefault("warnings", []).append(line.split(":", 1)[-1].strip()[:200])
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


#: The wgmma kernel's parts, each a build of ``csrc/int8_matmul.cu`` with
#: ``TPX_INT8_ABLATE`` set: the whole kernel, without the widening, without
#: the products, and the TMA loads with their barriers alone.
INT8_PARTS = {"whole": 0, "no_widening": 1, "no_products": 2, "loads_only": 3}


def phase_int8_parts() -> None:
    """Where the int8 wgmma kernel's time goes: at llama3_8b's four layer
    shapes with 2048 and 512 rows, the kernel built as it ships and with
    its widening, its products or both left out (``INT8_PARTS``), each on
    the shipped launch plan, beside ``torch.matmul`` on the weight
    dequantized to bf16. Only the whole kernel's output is checked."""
    import ctypes

    import torch

    from torchx_tpu_torch import _build
    from torchx_tpu_torch.ops import quant

    src = _build.CSRC_DIR / "int8_matmul.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sos = {name: _build.BUILD_DIR / f"int8_parts_{v}.{os.getpid()}.so"
           for name, v in INT8_PARTS.items()}
    _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-DTPX_INT8_ABLATE={v}",
                  "-I", str(_build.CSRC_DIR), "-o", str(sos[name]), str(src)]
                 for name, v in INT8_PARTS.items()])
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, so in sos.items():
        fn = ctypes.CDLL(str(so)).tpx_int8_matmul
        fn.argtypes, fn.restype = [p] * 6 + [i] * 8 + [p], i
        fns[name] = fn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    scratch = quant._Scratch()
    for k, n, tag, f32 in INT8_SHAPES:
        if f32:
            continue  # the head's prefill is off the serving path
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        q, scale = quant.quantize(w)
        lib_w = quant.dequantize(q, scale, torch.bfloat16)
        del w
        for m in (2048, 512):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            plan = quant.launch_plan(m, n, k, False, sms)
            if plan.path != quant.PATH_WGMMA:
                continue
            work, counters = scratch.fit(plan, torch.device("cuda"))
            times = {}
            for name, fn in fns.items():
                def call(fn=fn):  # noqa: ANN001, ANN202
                    rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                            work.data_ptr(), counters.data_ptr(), m, n, k, plan.path,
                            plan.block_m, 0, plan.splits, plan.per, stream)
                    if rc:
                        fail("int8parts", f"{name}: launch failed ({rc})")

                call()
                if name == "whole":
                    rel, _, ok = _int8_check(y, quant._int8_matmul_plain(x, q, scale))
                    if not ok:
                        fail("int8parts", f"{tag} m={m}: error {rel} beyond tolerance")
                times[name] = time_ms(call, iters=20)
            emit({"phase": "int8parts", "proj": tag, "m": m, "k": k, "n": n,
                  "block_m": plan.block_m, "splits": plan.splits,
                  **times, "library_ms": time_ms(lambda: torch.matmul(x, lib_w), iters=20),
                  "bound_ms": 1e3 * 2 * m * k * n / PEAK_BF16_FLOPS,
                  "l2_to_smem_bytes": (m * k * 2 * math.ceil(n / quant.BLOCK_N)
                                       + k * n * math.ceil(m / plan.block_m))})
        del q, scale, lib_w
    for so in sos.values():
        so.unlink()


#: Rows the int8 sweep times the bf16 paths at: a decode step's slots to a
#: few prefill buckets of one or more rows.
INT8_SWEEP_M = (8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512)
#: The configurations the sweep compares, as settings of ``ops.quant``'s
#: launch plan: the decode kernel, the wgmma kernel's 128-row tiles, its
#: 256-row tiles.
INT8_PLAN_KNOBS = ("DECODE_MAX_M", "DECODE_MIN_STEPS", "WGMMA_TALL_M", "TALL_MIN_STEPS")
INT8_SWEEP_CONFIGS = {
    "decode": {"DECODE_MAX_M": 1 << 30},
    "wgmma128": {"DECODE_MAX_M": 0, "DECODE_MIN_STEPS": 0, "WGMMA_TALL_M": 1 << 30},
    "wgmma256": {"DECODE_MAX_M": 0, "DECODE_MIN_STEPS": 0, "WGMMA_TALL_M": 0,
                 "TALL_MIN_STEPS": 0},
}


def phase_int8_sweep() -> None:
    """The int8-weight matmul's decode (mma.sync) path and its wgmma path
    at 128- and 256-row tiles, each with its own launch plan, at llama3_8b's
    shapes and ``INT8_SWEEP_M`` rows: checked against the plain version,
    timed with weights read from device memory. Prints a line per shape and
    rows, with the configuration the launch plan picks there and whether it
    was the fastest; then the rows up to which the decode path is at least
    as fast on every shape (the sources of ``ops.quant``'s
    ``INT8_PLAN_KNOBS``)."""
    import torch

    from torchx_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = {knob: getattr(quant, knob) for knob in INT8_PLAN_KNOBS}
    decode_wins: dict[int, bool] = {}
    picked_fastest: list[bool] = []
    try:
        for k, n, tag, f32 in INT8_SHAPES:
            out = torch.float32 if f32 else None
            w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
            q, scale = quant.quantize(w)
            del w
            qs = _weight_pool(q, q.numel())
            for m in INT8_SWEEP_M:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                want = quant._int8_matmul_plain(x, q, scale, out)
                times = {}
                for path, knobs in INT8_SWEEP_CONFIGS.items():
                    if f32 and path == "wgmma256":
                        continue  # f32 outputs take 128-row tiles only
                    for knob, value in {**chosen, **knobs}.items():
                        setattr(quant, knob, value)
                    quant._PLANS.clear()
                    rel, _, ok = _int8_check(quant.int8_matmul(x, q, scale, out_dtype=out), want)
                    if not ok:
                        fail("int8sweep", f"{tag} m={m} {path}: error {rel} beyond tolerance")
                    turn = [0]

                    def call():  # noqa: ANN202
                        turn[0] = (turn[0] + 1) % len(qs)
                        return quant.int8_matmul(x, qs[turn[0]], scale, out_dtype=out)

                    times[path] = time_ms(call, iters=20)
                    plan = quant.launch_plan(m, n, k, False, sms, f32)
                    times[f"{path}_splits"] = plan.splits
                    times[f"{path}_per"] = plan.per
                best_wgmma = min(times["wgmma128"], times.get("wgmma256", math.inf))
                decode_wins[m] = decode_wins.get(m, True) and times["decode"] <= best_wgmma
                for knob, value in chosen.items():
                    setattr(quant, knob, value)
                plan = quant.launch_plan(m, n, k, False, sms, f32)
                times["chosen"] = ("decode" if plan.path == quant.PATH_DECODE
                                   else f"wgmma{plan.block_m}")
                times["chosen_is_fastest"] = times[times["chosen"]] <= min(
                    times[c] for c in INT8_SWEEP_CONFIGS if c in times)
                picked_fastest.append(times["chosen_is_fastest"])
                emit({"phase": "int8sweep", "proj": tag, "m": m, "k": k, "n": n, **times,
                      "bound_ms": 1e3 * max((2 * m * k + k * n + (4 if f32 else 2) * m * n)
                                            / PEAK_BYTES, 2 * m * k * n / PEAK_BF16_FLOPS)})
            del q, scale, qs
    finally:
        for knob, value in chosen.items():
            setattr(quant, knob, value)
        quant._PLANS.clear()
    below = [m for m in INT8_SWEEP_M if all(decode_wins[r] for r in INT8_SWEEP_M if r <= m)]
    emit({"phase": "int8sweep", "decode_at_least_as_fast_up_to": max(below, default=None),
          "decode_wins_by_m": decode_wins, "plan_picked_the_fastest":
          f"{sum(picked_fastest)} of {len(picked_fastest)}", **chosen})


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    parser.add_argument("--package-root", default=None,
                        help="import torchx_tpu_torch from this tree (another version's"
                        " checkout, for the hostus phase's comparison)")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port runs on the card", file=sys.stderr)
        return 2
    try:
        from torchx_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    # The phases' subprocesses (gang ranks, drills) cache Python bytecode
    # under the build directory: where the environment turns bytecode
    # writing off, every new process would compile torch's modules again
    # (a world-1 gang's first MoE step took 15.2 s in a fresh process, 1.1 s
    # in a warm one on an H100 machine: PERF.md §6).
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ.setdefault("PYTHONPYCACHEPREFIX", str(_build.BUILD_DIR / "pycache"))
    t0 = time.monotonic()
    card = card_line()
    emit({"phase": "start", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def timed(name: str):  # noqa: ANN202 - each phase's wall seconds
        t = time.monotonic()
        try:
            yield
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.monotonic() - t

    with timed("build"):
        build_s = _build.build()
    ptxas = ptxas_summary(_build.build_info.get("log", ""))
    # the mma flash instances are kept only where ptxas spills nothing
    mma_spills = sorted(name for name, line in ptxas.items()
                        if "_mma_kernel" in name and re.search(r"[1-9]\d* bytes spill", line))
    emit({"phase": "build", "ok": True, "seconds": build_s,
          "library": _build.build_info.get("library"),
          "file_seconds": _build.build_info.get("files"), "ptxas": ptxas,
          "mma_spills": mma_spills})
    if mma_spills:
        fail("build", f"ptxas spilled in {mma_spills}")

    if "specs" in phases:
        with timed("specs"):
            phase_specs(card)
    with timed("kernels"):
        kernel_rows = phase_kernels() if "kernels" in phases else []
    for row in kernel_rows:
        emit({"phase": "kernels", **row})
    # each row's launches: the llama3_1b rows from the train phase's run,
    # the Mixtral-shape rows from the moe phase's, the masked rows from the
    # packed-document attention of the kernels phase
    if "train" in phases:
        with timed("train"):
            counts, expected, train_out = phase_train()
        for row in kernel_rows:
            if (row["name"] in counts and not row["name"].endswith("_seg")
                    and not row["name"].startswith("int8_matmul")):
                row["launches"] = counts[row["name"]]
                row["launches_per_step"] = counts[row["name"]] / TRAIN["steps"]
                row["launches_from"] = "train phase, llama3_1b"
        # the mma flash kernels are off the bf16 main path (expected 0)
        if any(row["launches"] == 0 for row in kernel_rows if expected.get(row["name"])):
            fail("train", "a kernel of the path was never launched")
        with timed("train"):
            train_profiled = phase_train_profiled(train_out, counts)
    if "remat" in phases:
        if "train" not in phases:
            fail("remat", "the remat phase's full row is the train phase's run: add train")
        with timed("remat"):
            phase_remat(train_out, train_profiled)
    if "reference" in phases:
        with timed("reference"):
            phase_reference()
    gang_out = None
    if "gang" in phases:
        if "train" not in phases:
            fail("gang", "the gang phase compares with the train phase: add train")
        with timed("gang"):
            gang_out = phase_gang(train_out, train_profiled, spmd_too="gangspmd" in phases)
    if "local" in phases:
        if gang_out is None:
            fail("local", "the local phase reads gang A's scheduled run: add train,gang")
        with timed("local"):
            phase_local(gang_out["A_final"], card)
    if "remote" in phases:
        with timed("remote"):
            phase_remote(card)
    if "gangckpt" in phases:
        with timed("gangckpt"):
            phase_gang_ckpt(gang_out["A_final"] if gang_out else None,
                            gang_out["B"] if gang_out else None)
    elif gang_out is not None:  # B's saved step, kept for the gangckpt phase
        import shutil

        shutil.rmtree(gang_out["B"]["out"], ignore_errors=True)
    # the ep and pp phases' two-rank runs, carried by the tp launch
    ep_shared = pp_shared = tp_out = None
    if "tp" in phases:
        b = gang_out["B"] if gang_out else None
        one_card = torch.cuda.device_count() < 4
        ep_extra = [ep_run()] if "ep" in phases and one_card else []
        pp_extra = pp_runs() if "pp" in phases and one_card else []
        with timed("tp"):
            tp_out, extra_finals = phase_tp(
                {k: v for k, v in b.items() if k.startswith("one_process_")}
                if b and (b["n_layers"], b["steps"]) == (TP["layers"], TP["steps"]) else None,
                ep_extra + pp_extra)
        if ep_extra:
            ep_shared = extra_finals[0]
            seconds["tp"] -= ep_shared["seconds"]  # booked to the ep phase
            seconds["ep"] = ep_shared["seconds"]
        if pp_extra:
            pp_shared = extra_finals[len(ep_extra):]
            pp_s = sum(f["seconds"] for f in pp_shared)
            seconds["tp"] -= pp_s  # booked to the pp phase
            seconds["pp"] = pp_s
        # the local-shape rows' launches: rank 0's in the tp phase's run
        for row in kernel_rows:
            suffix = {"_tp2": "tp=2", "_sp2": "sp=2"}.get(row["name"][-4:])
            if suffix is None or suffix not in tp_out:
                continue
            base = row["name"][:-4]
            row["launches"] = tp_out[suffix]["launches_by_rank"][0][base]
            row["launches_per_step"] = row["launches"] / TP["steps"]
            row["launches_from"] = f"tp phase, rank 0 of {suffix}, llama3_1b at 2 layers"
            if not row["launches"]:
                fail("tp", f"{row['name']}: the {suffix} step never launched it")
    serve_out = None
    if "serve" in phases:
        with timed("serve"):
            serve_out = phase_serve()
            phase_serve_disagg(serve_out)
    if "pool" in phases:
        if serve_out is None:
            fail("pool", "the pool phase holds its answers to the serve phase's: add serve")
        with timed("pool"):
            phase_pool(serve_out, card)
    if "ckpt" in phases:
        with timed("ckpt"):
            phase_ckpt()
    if "moe" in phases:
        with timed("moe"):
            moe_train = phase_moe_train()
        for row in kernel_rows:
            base = re.sub(r"_d\d+$", "", row["name"])
            if base != row["name"]:
                row["launches"] = moe_train["launches"][base]
                row["launches_per_step"] = row["launches"] / MOE_TRAIN["steps"]
                row["launches_from"] = "moe phase, mixtral_8x7b at 2 layers"
                if not row["launches"]:
                    fail("moe", f"{row['name']}: the MoE step never launched it")
        with timed("moe"):
            phase_moe_remat(moe_train)
            phase_moe_reference()
            phase_moe_serve()
    if "ep" in phases:
        with timed("ep"):
            ep_out = phase_ep(moe_train if "moe" in phases else None, ep_shared)
        # each rank's launches of the Mixtral-shape rows' kernels in the ep
        # phase's ep=2 run (the shapes of one process: tp 1)
        if "launches_by_rank" in ep_out:
            for row in kernel_rows:
                base = re.sub(r"_d\d+$", "", row["name"])
                if base == row["name"]:
                    continue
                row["launches_ep_by_rank"] = [r[base] for r in ep_out["launches_by_rank"]]
                if not all(row["launches_ep_by_rank"]):
                    fail("ep", f"{row['name']}: a rank of the ep=2 step never launched it")
    if "pp" in phases:
        # the tp phase's one-process run (the same layers and steps)
        one = ({k: v for k, v in next(iter(tp_out.values())).items()
                if k.startswith("one_process_")}
               if tp_out and (TP["layers"], TP["steps"]) == (PP["layers"], PP["steps"])
               else None)
        with timed("pp"):
            pp_out = phase_pp(one, pp_shared)
        # each rank's launches of the llama3_1b rows' kernels in the pp=2 run
        if "pp=2" in pp_out:
            for row in kernel_rows:
                if row["name"] in pp_out["pp=2"]["expected_launches"]:
                    row["launches_pp_by_rank"] = [
                        r[row["name"]] for r in pp_out["pp=2"]["launches_by_rank"]]
                    row["launches_pp_from"] = "pp phase, each rank of pp=2, llama3_1b at 2 layers"
    if "int8" in phases:
        with timed("int8"):
            phase_int8_train(train_out if "train" in phases else None)
            int8_serve = phase_int8_serve()
            int8_f32 = phase_int8_f32_path()
        per_call = int8_serve["int8_launches_per_call"]
        for row in kernel_rows:
            if row["name"].startswith("int8_matmul_tf32"):
                row["launches"] = int8_f32["launches"]["int8_matmul_tf32"]
                row["launches_from"] = ("int8 phase, llama3_8b f32 --int8 at 1 layer:"
                                        " forward_with_cache and generate")
            elif row["name"].startswith("int8_matmul"):
                row["launches"] = int8_serve["burst_launches"]["int8_matmul"]
                row["launches_from"] = "int8 phase, the llama3_8b --int8 serve burst"
                row["launches_per_decode_step"] = row["launches_per_prefill"] = per_call
                if not row["launches"]:
                    fail("int8", f"{row['name']}: the int8 serve burst never launched it")
    extra = {"profile": phase_profile, "sweep": phase_sweep, "notice": phase_notice,
             "moeprofile": phase_moe_profile, "int8profile": phase_int8_profile,
             "int8sweep": phase_int8_sweep, "int8parts": phase_int8_parts,
             "gangparts": phase_gang_parts, "rematoom": phase_remat_oom,
             "hostus": phase_hostus, "routes": phase_routes, "int8f32": phase_int8_f32_rows,
             "dqgrid": phase_dq_grid, "tracecost": phase_trace_cost}
    for name, run in extra.items():
        if name in phases:
            with timed(name):
                run()

    if kernel_rows:
        print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card, flush=True)
    emit({"phase": "end", "seconds": time.monotonic() - t0, "phase_seconds": seconds})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
