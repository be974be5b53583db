#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py            # from the root of the checkout

Phases, each printing JSON lines:

1. device: the card's name and power limit, and the kernel build
   (``nvcc`` for ``sm_90a`` from ``src/repro_torch/kernels/csrc``) with
   each kernel's registers, shared memory, stack and spills from
   ``-Xptxas -v`` (the ``lstm_scan`` register body at H 16, the main
   path's, must not spill and must leave room for three blocks a SM);
   the simt decode body's resources, which must show no spills, and its
   tile of entries and shared-memory bytes at each wide shape
   (``device.decode_simt``); the simt ``lstm_scan`` body's resources,
   which must show no spills either, and its tile of sequences and
   shared-memory bytes at H 68, 96, 114 and 256 (``device.lstm_simt``);
   the flash kernel's tf32x3 body's resources (four kernels: f32 at D 8,
   64 and 128, bf16 at D 8), none of which may spill, and its launch plan
   at each D (``device.flash_tf32x3``); then the count of
   tensor-core instructions (``HGMMA``) per kernel in the library's SASS
   (``cuobjdump -sass``), which must be non-zero in both flash bodies.
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   over the reference's test grid (R in {4, 8, 32}, T in {2, 3, 8}, f32
   and bf16, B = 33 and B = 0), at the main path's shapes, at H = 64,
   R = 32, at every instantiated (H, R) bucket of ``decode_tile`` and at
   shapes padded to one (H 12, R 5; the paper's 12/6 and 18/10), and
   at a step of the stream phase (B 8192, T 14, M 8, H 12, R 6: K 12),
   through its simt body above the largest bucket at the reference budget
   rule's (68, 34) and (114, 57) (B 4096, T 10) and (256, 128) (B 1000,
   T 5), on inputs scaled to the width; every decode case names its body
   (``decode_body``) and bucket or simt tile of entries
   (``kernels.decode_buckets``);
   ``lstm_scan`` at B 1000, T 10 at every hidden bucket of its register
   body (12, 16, 20, 32, 64), at widths padded into one (5, 18, 24), on an
   x whose rows are off the 16-byte grid (the scalar-load route), and at
   H 68, 96, 114 and 256 through its simt body; every lstm case names its
   body, bucket or simt tile of sequences, and load route
   (``kernels.lstm_buckets``);
   ``tt_contract`` over the reference's grid and at R 34, 57 and 128, each
   case with its lanes per entry (``kernels.tt_cases``);
   ``flash_attention`` over the reference's
   attention grid, ``q_offset`` 128, odd and ragged lengths (the pad path),
   starcoder2's 48/4 grouping, fully masked rows (``q_offset`` < 0), head
   dims 8, 64 and 128, the serve path's shapes up to S 4096, and the edges
   of the tensor-core body (B 2 with GQA 4/1, D 64 at S 1024, ``q_offset``
   > 0 with Skv > Sq, ``kv_valid`` inside a kv tile, fully masked rows at
   D 128); every flash case names the body that ran (``flash_body``:
   ``wgmma`` for bf16 at D 64 and 128, else ``tf32x3``), whose launch it
   must have counted, and every f32 flash case its per-element reading.
   Tolerance: 1e-5 in f32, 0.1 in bf16 (rtol = atol); in bf16
   also at most 2 bf16 ulps of the case's largest plain value, a limit
   that scales with the data.  Every bf16 flash output is also held
   element by element: within 1 bf16 ulp of each element's own value plus
   2^-16 of its row's largest, which a kernel that rounds p to bf16
   fails (the timing row shows that on a bf16-p control).
   kernels.bwd: the two backward kernels (``lstm_scan``'s, ``csrc/lstm_bwd.cu``,
   and ``tt_contract``'s, ``csrc/tt_contract_bwd.cu``) against their plain
   versions, autograd of the plain forwards: ``lstm_scan`` at (B 8192, T 10,
   H 12), (8192, 10, 18), (4096, 10, 68), (1024, 5, 256) and the stream's
   (8192, 14, 12), ``tt_contract`` at (B 8192, K 8, R 6), (8192, 8, 10),
   (4096, 8, 34), (256, 4, 128), (1001, 8, 10), B off the block, (1001, 3,
   5), the stream's (8192, 12, 6) and the wide plan's (517, 5, 57),
   (16384, 8, 43), (16384, 8, 57) and (8192, 8, 128) (the last three also
   timed, ``kernels.bwd.wide_timing``), on the operands a training step makes
   (``training_inputs``); each gradient within atol 1e-5 + rtol 1e-4 of its
   largest value, and every ``lstm_scan`` gradient no further from an f64
   evaluation than 4x the plain version's (a weight's gradient sums B T
   rows, which near 0 no two f32 summation orders hold to 1e-5); then once
   through autograd, where the Functions' backward passes must be the
   kernels.  The device phase prints their ptxas rows and the
   ``lstm_scan`` backward's plan at each case (``device.bwd``); that kernel
   must not spill.
3. golden: the four golden files (``tests/golden/v2_nttd.bin``,
   ``v3_mono.tcdc``, ``v3_chunked.tcdc`` and ``v4_delta.tcdc`` at its
   latest version) loaded with ``load_bytes(..., device="cuda")`` and
   decoded against ``tests/golden/expected.npz`` (rtol 1e-5, atol 1e-6),
   and the chunked
   NTTD payload ``benchmarks/results/fig5_stream_payload.tcdc`` decoded
   whole through the kernel against the plain version.
4. main path: a PEMS-SF-shaped (963 x 144 x 440) NTTD payload at the
   default architecture (rank 8, hidden 16) with random weights from a
   seed is saved to a v3 container, loaded onto the card with
   ``load_bytes``, answers 8 ``decode_at`` requests of 65,536 entries
   through the fused kernel and 2 through ``lstm_scan`` + ``tt_contract``,
   and reconstructs all 61,015,680 entries with ``to_dense``.  Everything
   is compared with the plain version on the card, and every kernel must
   have been launched by this phase.
5. wide: the payloads the reference's budget rule makes at 1 MB, decoded
   through the default impl: a PEMS-SF-shaped payload at hidden 68, rank
   34 saved, loaded onto the card and asked two ``decode_at`` requests of
   65,536 entries, and an Uber-shaped one (183 x 24 x 1140, paper Table II)
   reconstructed whole with ``to_dense``, both against the plain version
   on the card (rtol = atol = 1e-5).  Every fused launch of the phase must
   be the simt decode body's.  Two more ``decode_at`` requests of the
   PEMS-SF payload go through the unfused route (``kernel_impl="cuda"``):
   ``lstm_scan`` at B 65,536, T 10, H 68 on its simt body, then
   ``tt_contract`` at K 8, R 34, held to the plain route at 1e-5; the
   phase launches each exactly twice.
6. fit: Alg. 1 at full width, ``get_codec("nttd").fit`` on its default
   device with the paper's MEDIUM (rank 10, hidden 18, batch 8192, lr
   1e-2) on the PEMS-SF replica at its Table II shape (963 x 144 x 440,
   ``repro_torch.data.synthetic_tensors``), 6 epochs of 2^21 entries with
   one Alg. 3 sweep (the cuts are in its ``reduced`` field).  Every
   training step launches the forward and backward ``lstm_scan`` and
   ``tt_contract`` kernels once, every epoch's fitness the fused decode,
   and no plain version runs (counted).  It prints the seconds of TSP
   init, training, reorder and fitness, steps/s, entries/s, the fitness
   and loss per epoch, the swaps, the launches and the payload's size; the
   payload's exact fitness over all entries must match the best sampled
   one within 1e-2, and the saved payload must load and answer as fitted.
   fit.parity: ``compress`` twice on the mini replica from the same seed,
   the plain versions ("ref") against the kernels ("auto"): fitness within
   1e-3 at every epoch; a mode whose accepted swaps differ is printed.
   fit_budget: ``get_codec("nttd").fit(x, budget=4_000_000)`` on the same
   replica, the adapter's defaults (batch 16384, lr 5e-3, TSP init, Alg.
   3), 6 epochs of 2^21 entries: the budget rule's rank 57, hidden 114 (d'
   10), whose step runs the simt ``lstm_scan``, both backward kernels'
   wide plans and ``tt_contract`` at R 57, and whose fitness runs the simt
   decode.  Every step launches each training kernel once, no plain
   version runs, the payload is within the budget and answers as fitted
   and as the plain route, and one step from the fitted params gives the
   plain route's loss and gradients; ``timing.fit_budget`` gives each
   kernel's time at that fit's shapes beside its bound, and
   ``fit_budget.parity`` runs ``fitness_parity`` (as fit.parity) at that
   rank, hidden and d' on the mini replica, every backward launch of its
   kernel route in the wide plan.
   stream: out-of-core compression at the reference's fig5 FULL shape,
   ``fit_stream("nttd", SyntheticTensorSource((16384, 64, 64),
   slab_entries=2^18, seed=1), rank=6, hidden=12, steps_per_slab=2,
   batch_size=8192, lr=2e-2, seed=0)`` on its default device: 2^26
   entries in 256 slabs, 512 steps, the tensor never materialised (lr is
   the reference's end-to-end stream test's; ``STREAM_CHANGED``).  Every
   step launches the forward and backward ``lstm_scan`` and
   ``tt_contract`` kernels once and no plain version runs (counted).  The
   payload goes through ``write_chunked(..., chunk_bytes=2048)`` with a
   ``sample_heldout`` sample of five slabs into a temporary directory,
   ``load_file(..., device="cuda")`` reads it back and answers 65,536
   entries through the fused kernel, equal to the fitted payload's
   answers; its decode must correlate with ``values_at`` over 2^20
   entries above 0.5; a second fitter resumed at slab 128 must give the
   same ``save_bytes``.  It prints the seconds by part (source values,
   host sampling, training dispatch, the device's drain, reservoir, write,
   read), slabs/s, steps/s, entries/s, the correlation, the payload's
   bytes, the launches and the card's name and power limit.
   stream.parity: the first 16 slabs through "ref" and "auto" from the
   same seed: every param within rtol 1e-4 / atol 1e-6, the sampled
   fitness within 1e-3.  stream.delta: a (256, 64, 64) keyframe from
   ``fit_stream`` and two residuals (0.05 x the seed-2 and seed-3
   sources) from one ``DeltaFitter``, written by the delta-mode
   ``ChunkedWriter`` with a ``sync()`` after each version; read back on
   the card it is a ``ChainEncoded`` whose answers are the f64 sum of its
   components', one fused launch each.
   service (``phase_service``): the codec service on the card.  Phase
   main's PEMS-SF payload is written as a chunked v3 file of 8 chunks
   with a held-out block of 4,096 entries (the plain route's decode), and
   a ``VersionedStore`` is written on the card at fig10's NTTD settings
   ((24, 16, 16), 8 versions, keyframe interval 8; its fits launch the
   four training kernels and the fused decode, no plain version;
   ``service.store``).  ``CodecService(cache_bytes=64 MiB,
   canary_fraction=0.25, canary_min_fitness=0.999)`` serves the PEMS-SF
   file lazily, direct and through tiles of 65,536 entries (932 tiles of
   256 KiB), phase stream's fig5 file and phase stream.delta's and the
   store's v4 files: 32 direct requests of 65,536 entries, 64 tiled
   requests inside a window of 64 tiles, one request swept over 512 tiles
   (which must evict), 64 submits of 1,024 entries and one flush, every
   version of both v4 files and 8 requests of the fig5 file (canaries).
   The traffic runs with prefetch off, on, with tracing on, and through
   the plain route (``REPRO_DECODE_IMPL=ref``): answers and stats of the
   first three bitwise equal, every answer within 1e-5 of the plain
   pass's, versioned answers equal to ``VersionedReader.decode_at``.  The
   first pass runs no plain version and launches ``decode_tile`` exactly
   once per counted decode call and canary check; resident bytes stay
   within the budget; device memory is what the materialized payloads hold
   (within 1 MiB) at every check and back to the baseline after the
   unloads; the trace holds the service's spans and ``kernel_decode`` and
   exports to JSON that loads.  It prints request ms (direct, tiled miss
   and hit, sweep, flush, versioned), the traced materialize ms, the hit
   ratio, resident bytes, launches, the canary stats and breach events.
   fleet (``phase_fleet``): the serving fleet on the card, over phase
   service's PEMS-SF file and traffic (direct requests, window requests,
   the sweep, 64 submits and a flush).  ``fleet.local``: 4 in-process
   members, replication 2, 64 MiB and canaries 0.25 each; every answer
   bitwise phase service's first pass, zero failed tickets, each member's
   resident bytes within its budget, a rebalance removing ``i3`` and one
   adding ``i4`` (submits queued before each all answered after it; the
   add warms tiles into ``i4``), the direct requests again after each,
   ``decode_tile`` launched exactly once per decode call and canary check
   the members report, no plain version.  ``fleet.procs``: 3
   ``repro_torch.fleet.worker`` processes on the card, started together,
   over the same file and traffic, bitwise the same; each worker holds a
   CUDA context (its pid in ``nvidia-smi``, or, where nvidia-smi reports
   the container's processes under another pid, the card's device node
   open in the worker and the card's used memory grown by 100 MiB a
   worker); one traced request is one trace whose worker spans, down to
   ``kernel_decode``, hang under the frontend's ``transport.flush``; the
   frontend launches nothing; ``close()`` leaves no worker behind.  Both
   print request ms, spawn seconds and a traced request's split between
   the frontend and its members.  ``fleet.slo`` and ``fleet.repair`` run
   ``scripts/torch_slo_smoke.py`` and ``scripts/torch_repair_drill.py``
   on the card (the controller admits and retires ``s0``; a corrupt chunk
   restored byte-exactly; the quality refit launching ``lstm_scan``,
   ``tt_contract`` and both backward kernels here, no plain version, the
   canary clearing), printing ``time_to_repair_s`` and the refit's
   entries/s.  Every kernel row gets ``launches_fleet``: this process's
   launches in the phase (workers count theirs in their own processes).
7. serve: the LM serving path, ``repro_torch.launch.serve.main`` on
   qwen1.5-4b at full width (40 layers, d_model 2560, 20 heads of 128,
   vocab 151,936) in bf16 with random weights from seed 0: 8 requests of
   seeded prompt lengths (128, 2048 and six others, at least one not a
   multiple of 128) over 4 slots, 16 new tokens each, max_len 4096.  Every
   prefill attention must go through the flash kernel (40 launches per
   prompt).  The same requests are served again through the oracle
   (``--attn-impl ref``): the prefill logits must agree within
   ``LOGIT_REL_TOL`` of max|logit|, and the greedy tokens wherever the
   oracle run's top-2 margin exceeds twice the largest logit difference.
   families (``phase_families``): the MoE, Mamba2 and hybrid layouts and
   the embedding configs, each model built from seed 0 and freed before
   the next.  ``families.ssm``: mamba2-1.3b at full width and depth (48
   layers, d_model 2048) in bf16 through the launcher, requests of 1,
   2, 300 (across the 256-token chunk) and 1000 tokens over 2 slots, 16
   new tokens each: finite tokens, no flash launch; then in f32 a prefill
   of 300 and of 2 tokens (below the conv's k-1, ROADMAP C.8) plus one
   decode step against ``forward`` on S + 1 tokens, within
   ``SSM_TF_TOL`` of max|logit|.  ``families.moe``: grok-1 (3 layers) and
   llama4-maverick (2 layers: one dense and one MoE) at full width in
   bf16 through the launcher on both routes, 6 requests of 1, 128, 300,
   2048, 5 and 33 tokens over 2 slots: flash launches = attention
   sublayers x requests, prefill logits within ``FAMILY_LOGIT_REL_TOL``,
   greedy tokens by the serve phase's margin rule.  bf16 router logits
   sit near ties that the attention's rounding can move, so the compared
   routes share one routing: a second kernel-route run records every MoE
   sublayer's expert ids (``RouteLog``) and the plain route replays them,
   with gate values from its own probabilities; every prefill and token is
   then compared.  Times, launches and peak bytes come from a first
   kernel-route run with no hook.  ``families.hybrid``: jamba's smoke
   config on the card in f32 (every flash launch on the kernel's tf32x3
   body at D 8, counted apart): both
   routes within ``HYBRID_TOL`` of max|logit|, and prefill then two decode
   steps against teacher forcing within ``HYBRID_TF_TOL``, at the
   capacity factor E / k (no token dropped: a forward over S + 2 tokens
   and a prefill over S drop differently at the config's 1.25).
   ``families.embeds``: musicgen-medium at full width and depth (48
   layers, D 64: flash's ``wgmma`` body) and internvl2-76b at full width,
   8 layers, through the launcher on both routes as ``families.moe``, then
   a 300-row ``embeds`` prefill and two decode steps through
   ``train.step.make_prefill_step``/``make_decode_step`` on both routes
   (flash launches = layers).  Each line prints weight and peak bytes,
   prefill ms by prompt length and decode ms a token, and its depth cut
   in ``reduced``; every kernel row gets ``launches_families``.
8. train (``phase_train_all``): LM training at minicpm-2b's full width.
   ``train``: ``repro_torch.launch.train.run`` (``main``'s losses with
   the step times and final state) for 8 steps at full depth (40 layers,
   d_model 2304, d_ff 5760, vocab 122,753, remat "dots", f32 masters,
   bf16 compute) at the launcher's batch 8 x seq 128 and WSD schedule,
   lr 1e-4 (``TRAIN_LR``: the default 3e-4 spikes without warmup):
   every loss finite, the last below the first, the parameters moved, no
   kernel launched (training attention is the oracle, as in the
   reference); the median step ms after the first, tokens/s, peak memory
   against the card's, and 6·N·tokens / 989 TFLOP/s beside them; the
   in-place Adam update bitwise the out-of-place one on the card.
   ``train.resume``: the same width cut to 2 layers, 6 steps uninterrupted
   against 4 steps ended by a SIGTERM (``--ckpt-dir``, ``--ckpt-every 2``:
   its checkpoint at step 4) and a second run with ``--resume auto`` to
   step 6 (losses within ``RESUME_TOL`` relative); checkpoint save
   seconds and bytes.  ``train.codec``: ``compress_tree`` of the resumed
   params under the default ``CodecCheckpointConfig`` (per leaf: elements,
   seconds, fitness, kind), ``decompress_tree`` (raw leaves bitwise), then
   ``CODEC_GATED_LEAF`` alone at gate -1, so that ``decompress_tree``
   decodes a codec leaf on the card (its device, dtype and shape, 1e-5 of
   the plain route's decode; the eval loss before and after, with that
   leaf in the restored tree), the NTTD training kernels and the fused
   decode launched and no plain version run (the MLP's three leaves are
   left out: ``CODEC_SKIP``), and a ``VersionedCheckpointer`` over one
   leaf at steps 4 and 6 (gate -1 so that its store runs, one delta
   pass), whose keyframe payload is decoded through the kernel and the
   plain route.  ``train.embed``:
   ``NTTDEmbedding.fit`` on the 122,880 x 2304 table with its cuts printed
   and a [8, 128] ``lookup`` through the kernel and the plain route.
   Every kernel row gets ``launches_train``: the launches of these phases.
   dist (``phase_dist``): the data-parallel NTTD fit epoch
   (``core.codec._make_train_epoch(..., mesh=)``) at the MEDIUM fit shape
   (rank 10, hidden 18, lr 1e-2, the PEMS-SF replica's entries), 4 steps
   of 8192 entries, in worlds of child processes spawned with a
   ``FileStore`` in the work directory (this process joins no group):
   ``dist.a``, one NCCL rank on the card, whose epoch must equal the
   single-device epoch of this process bitwise; ``dist.b``, two gloo
   ranks on ``cuda:0`` (NCCL refuses two ranks on one card; gloo's
   all-reduce takes CUDA tensors), 4096 entries a rank, loss within rtol
   1e-5 and params within rtol 1e-4 / atol 1e-6 of the single-device
   epoch, the ranks' params bitwise equal, then elastic restore of a leaf
   saved on one device with ``Shard(0)`` and ``Shard(1)``, each rank's
   chunk its slice of the leaf.  Every rank must launch the four training
   kernels once a step and run no plain version; each prints its backend,
   device, the ms of a step and the all-reduce's share of a step.  A
   rank's non-zero exit or a timeout fails the run.  ``dist.rules``: the
   dry-run's rule check of all 128 LM cells (and the 32 it skips) and the
   codec's DP cell on both production meshes.  Every kernel row gets
   ``launches_dist``: the launches of the ranks' checked epochs.
   tp (``phase_tp``): the LM train step through the launcher's mesh path,
   minicpm-2b at full width cut to 8 of 40 layers (``depth_cut``), 3
   steps at lr 1e-4, in world ``tp`` (one NCCL rank): the launcher twice
   without a process group (the plain route and its repeat), then with
   ``--mesh 1x1`` in the group, every leaf a ``DTensor`` on a (data,
   model) mesh; the params bitwise the plain route's, or else losses
   within rtol 1e-4 and params within rtol = atol = 2e-3 (the max abs
   errors printed, and the plain repeat's beside them: how far two plain
   runs differ); each route's step ms and peak memory; no kernel
   launched.  fsdp (``phase_fsdp``, after tp): the train step under
   ``FSDP_RULES`` on two gloo ranks sharing ``cuda:0`` over a (data 2,
   model 1) mesh, minicpm-2b at full width cut to 8 layers (f32 compute)
   and grok-1's smoke config (the expert leaves), batch 8 x 128, against
   the same step on one device in each rank: every gradient the optimizer
   gets in its master's placements and local shape, each within 1e-5 of
   its leaf's largest magnitude, the loss and grad norm within rtol 1e-4,
   the params after the step within atol 5e-5; each cell's step run
   again in bf16 compute under ``layout_trace`` all-gathers each weight
   the rules split over ``data`` in bf16 before its products
   (``sharding.gather_dp``; again in a "dots" recompute), runs each
   leaf's layout node (``sharding.layout_grad``; a stacked leaf's once a
   block) once, each gradient, the norms' too, coming in as a ``Partial``
   sum over ``data`` and reduced there by one reduce-scatter or
   all-reduce, in f32 (``needed_none``, the nodes whose gradient came in
   otherwise, must be empty), and issues no other reduction over
   ``data`` than FSDP_OTHER_REDUCTIONS' (the cross-entropy's, the MoE
   load-balance loss's and the gradient norm's, in f32: ``unlisted``
   must be empty); the step's collectives are printed by kind and
   dtype, and its other reductions by the autograd node or source line
   that issued them (``other_reductions``).  Under gloo, torch 2.11's functional
   all-gather (DTensor's) crashes on CUDA tensors where
   ``dist.all_gather_into_tensor`` works: the ranks route the first
   through the second (``route_all_gather_through_c10d``).
   pp (``phase_pp``): minicpm-2b's block stack at full width,
   8 layers (4 a stage), f32, as a 2-stage GPipe pipeline
   (``dist.pipeline_parallel``) of M = 4 microbatches of 2 x 128 tokens
   on two gloo ranks sharing ``cuda:0`` (each hop copied through the
   host), against this process's stack forward of the same layers at
   rtol = atol = 2e-4, the ranks' outputs bitwise equal; the bubble
   fraction, ms a tick and the host copies' share of the ticks.  decode
   (``phase_decode``, between tp and pp): qwen1.5-4b at full width cut to
   4 of 40 layers, f32, batch 4, a 256-token prompt (prefill through the
   flash kernel, once a layer) and 8 greedy tokens, on two gloo ranks on
   ``cuda:0`` over a 1-D (data) mesh, the cache laid out by
   ``cache_shardings`` twice: ``batch`` (its rows split) and ``long`` (the
   long-context rules: its length split, each rank attending its piece and
   the pieces combined by all-reduces of their log-sum-exps); against this
   process's decode on one device: the tokens equal, the logits within
   1e-4 of their largest magnitude, the cache still in its layout; each
   layout's prefill ms, decode ms a token and peak memory a rank; every
   prefill's flash launches on the tf32x3 body.  Then one timed f32
   prefill on one device, batch 1, a 2048-token prompt, through the flash
   kernel and through the oracle (``prefill_f32_ms`` of each), the last
   logits within 1e-4 of their largest and the greedy token equal.  All
   three print ``not_shown``: NCCL collectives across cards.
   dryrun (``phase_dryrun``): the dry-run's cost pass held against the
   card.  A spawned process (``dryrun_fake``, this process joins no
   group) runs the cost passes in fake process groups: the ``tp``
   configuration (minicpm-2b, full width, TP_LAYERS layers, batch 8 x 128)
   on a 1 x 1 mesh, the codec's step at the MEDIUM widths with 8192
   entries a device (impl "ref", the PEMS-SF replica's shape),
   ``dryrun_codec.run`` on both production meshes at its defaults and
   ``run_cell("mamba2-1.3b", "decode_32k", "single")`` and
   ``run_cell("qwen1.5-4b", "decode_32k", "single", "auto")``, whose
   predicted peak must fit one 80 GB card.  Meanwhile world
   ``dryrun`` (one NCCL rank, a 1 x 1 mesh) runs the ``tp`` step for real
   on ``DTensor``s: ``FlopCounterMode`` over it and
   ``torch.cuda.max_memory_allocated`` over it, the arguments included.
   The predicted FLOPs must be within 1 % of the counted, the predicted
   peak within 25 % of the card's, the codec step's FLOPs within 1 % of
   one real "ref" step on the card, and every cost cell ``ok``.  The
   ``long`` cell (``scripts/torch_long_step.py``: minicpm-2b at full width,
   4 layers, batch 2 x 4096, remat "dots", the q-chunked oracle) too: its
   predicted peak within 25 % of the card's, and the largest term at the
   predicted peak made by the oracle (``kernels/ref.py``) at most one
   512-row chunk's two f32 score blocks (1.21 GB), and what the oracle
   holds at once over the step at most those, the chunk's mask and its f32
   operands (``torch_long_step.oracle_bound``).
   examples (``phase_examples``): the four port examples
   (``examples/torch_*.py``) at their default sizes on the card, as
   subprocesses started together; each must exit 0, and their printed
   lines are recorded.
9. timing: each kernel, its plain version and, where one exists, one
   PyTorch call computing the same function (cuDNN ``nn.LSTM`` for
   ``lstm_scan``, one ``torch.einsum`` over the whole chain for
   ``tt_contract``, ``scaled_dot_product_attention`` for
   ``flash_attention``, with its error beside the kernel's) at the main
   paths' shapes, with CUDA events; the bound is computed from the shapes
   against the H100 SXM's published peaks.  At the flash timing shape the
   kernel's error must be below SDPA's and pass the per-element check,
   and a bf16-p control must fail it.  The flash kernel in f32, its
   tf32x3 body, is timed at that shape and at phase decode's prefill (4,
   256, 20, 128), and with q and k x 3 (logits of std ~9) at D 128, 64
   and 8, beside its plain version, SDPA in f32 (the device kernel it ran
   named) and two floors, 3 TF32 products a product over 495 TFLOP/s and
   FP32 FMAs over 67 (``timing.flash_f32``, the ``flash_attention_f32``
   row); the one profiler session requires that an f32 call runs the
   tf32x3 kernel alone; every element must lie within f32's tolerance of
   an f64 evaluation, and of the plain version at randn's logits, where
   at FLASH_SHAPE a single-TF32 control (the plain version with TF32
   matmuls) must not.  The ``lstm_scan`` row names the
   body, bucket and load route that ran, and the device kernels one call
   runs as ``torch.profiler`` sees them, which must be the register kernel
   alone; the ``tt_contract`` row likewise names its body and lanes per
   entry, its one device kernel a call, and its bf16 time and bound at the
   same shape.  The simt decode body is timed at B 65,536, T 10 at (68, 34)
   and (114, 57) like every row (``timing.decode_simt``, with the plain
   version and the bound beside each, and its error there held to 1e-5);
   the first is the ``decode_tile_simt`` row, with the wide phase's
   launches.  The simt ``lstm_scan`` body is timed at B 65,536, T 10 at
   H 68, 96 and 114 beside its plain version, cuDNN ``nn.LSTM`` and the
   bound (``timing.lstm_simt``, its error there held to 1e-5); the first
   is the ``lstm_scan_simt`` row, with the wide phase's launches, and the
   one profiler session also requires that a call at H 68 runs the simt
   kernel alone.  The two backward kernels are timed at the MEDIUM fit
   shape (B 8192, T 10, H 18, R 10, K 8): the whole backward call a step
   makes (for ``lstm_scan`` also the kernel alone, dx and G, with its own
   bound, its plan, and the device operations of one call from the same
   profiler session as the forward rows', which must hold the backward
   kernel once), the plain version and, for ``lstm_scan``, cuDNN
   ``nn.LSTM``'s backward; a ``timing.fit_step`` line sets the four kernels
   of a step beside the fit's seconds a step, and a ``timing.stream_step``
   line the same four at a step of the stream (B 8192, T 14, H 12, R 6)
   beside the stream's seconds a step.  The ``tt_contract`` backward's
   wide plan has a row of its own (``tt_contract_bwd_wide``) at the 4 MB
   budget fit's step (B 16384, K 8, R 57), with its launches in phase
   ``fit_budget``.
   Every forward row also carries its launches on the fit path
   (``launches_fit``), every row on the stream path its launches in phase
   ``stream`` (``launches_stream``), and every row its launches in phase
   ``fit_budget`` (``launches_fit_budget``).

The line before the last is the card's ``name, power.limit`` as
``nvidia-smi`` reports them; the last line is the result object.  Any
failure exits non-zero without printing it.  Without CUDA, or without the
rest of the checkout beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
SEED = 0
PEMS_SHAPE = (963, 144, 440)  # paper Table II, PEMS-SF
RANK, HIDDEN = 8, 16          # the repo's default NTTD architecture
REQUEST = 65_536              # entries per decode_at request
DENSE_BATCH = 65_536          # entries per launch of to_dense (its default batch)
TOL = {"float32": 1e-5, "bfloat16": 0.1}
BF16_ULPS = 2                 # bf16 also within 2 ulps of the case's largest |value|
# bf16 flash outputs, element by element: within 1 bf16 ulp of the element's
# own |value| plus this fraction of its row's largest |value| (2^-16: the
# precision to which the split P.V keeps p); rounding p to bf16 fails it
FLASH_ROW_FLOOR = 2.0**-16
PEAK_FP32 = 67e12             # H100 SXM, FP32 outside the tensor cores
PEAK_TF32 = 495e12            # H100 SXM, dense TF32 on the tensor cores
PEAK_BF16 = 989e12            # H100 SXM, dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PROFILE_PAD_S = 0.05          # idle host time around each profiled call
SOURCES = {
    "decode_tile": ("src/repro_torch/kernels/csrc/decode_tile.cu",
                    "src/repro/kernels/decode_tile.py:147"),
    "decode_tile_simt": ("src/repro_torch/kernels/csrc/decode_tile_simt.cu",
                         "src/repro/kernels/decode_tile.py:147"),
    "lstm_scan": ("src/repro_torch/kernels/csrc/lstm.cu",
                  "src/repro/kernels/lstm.py:67"),
    "lstm_scan_simt": ("src/repro_torch/kernels/csrc/lstm_dispatch.cu",
                       "src/repro/kernels/lstm.py:67"),
    "tt_contract": ("src/repro_torch/kernels/csrc/tt_contract.cu",
                    "src/repro/kernels/tt_contract.py:60"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/attention.py:114"),
    "flash_attention_f32": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/attention.py:114"),
    "lstm_scan_bwd": ("src/repro_torch/kernels/csrc/lstm_bwd.cu",
                      "src/repro/kernels/lstm.py:67"),
    "tt_contract_bwd": ("src/repro_torch/kernels/csrc/tt_contract_bwd.cu",
                        "src/repro/kernels/tt_contract.py:60"),
}
NTTD_KERNELS = ("decode_tile", "lstm_scan", "tt_contract")
SERVE_ARCH = "qwen1.5-4b"
SERVE_REQUESTS, SERVE_SLOTS, SERVE_NEW, SERVE_MAX_LEN = 8, 4, 16, 4096
# The kernel and the oracle routes differ only in how attention rounds to
# bf16 (1 ulp of an output, here and there); carried through 40 bf16
# layers that stays well under 5 % of the largest logit, about 13 bf16
# ulps at the top of the logits.
LOGIT_REL_TOL = 5e-2
FLASH_SHAPE = (1, 2048, 20, 128)  # B, S, H, D of one full-width prefill
# the f32 body's timing cases (B, S, H, D, q and k scale): FLASH_SHAPE,
# phase decode's prefill, and at D 128, 64 and 8 logits of 3^2 = 9 times
# randn's spread (std ~9), as trained LMs reach.  At that scale the plain
# f32 version itself is off the exact function by more than f32's
# tolerance (~2x on an H100), so every case is also held against an f64
# evaluation (``flash_f64``)
FLASH_F32_SHAPES = ((*FLASH_SHAPE, 1.0), (4, 256, 20, 128, 1.0), (*FLASH_SHAPE, 3.0),
                    (1, 2048, 24, 64, 3.0), (1, 1024, 8, 8, 3.0))
# phase families: the MoE, Mamba2 and hybrid layouts and the embedding
# configs (each model's depth cut, where one is made, is in its line's
# ``reduced``)
FAMILY_REQUESTS, FAMILY_SLOTS, FAMILY_NEW = 6, 2, 16
FAMILY_LENS = (1, 128, 300, 2048, 5, 33)
FAMILY_MAX_LEN = 2048 + 16 + 1
# the routes differ in bf16 attention rounding, as in phase serve (an MoE
# model's plain route replays the kernel route's experts, ``RouteLog``)
FAMILY_LOGIT_REL_TOL = LOGIT_REL_TOL
SSM_ARCH = "mamba2-1.3b"
SSM_LENS = (1, 2, 300, 1000)        # 300 crosses the 256-token chunk
SSM_TF_LENS = (300, 2)              # f32 prefill + 1 decode step vs forward on S + 1
SSM_TF_TOL = 1e-4                   # f32, of max|logit|
MOE_CUTS = {"grok-1-314b": 3, "llama4-maverick-400b-a17b": 2}  # n_layers on the card
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_LENS = (1, 2, 37, 5)         # the smoke chunk is 16
HYBRID_TOL = 1e-5                   # f32, of max|logit|: both routes
HYBRID_TF_TOL = 1e-4                # f32, of max|logit|: prefill + decode vs forward
EMBED_CUTS = {"musicgen-medium": None, "internvl2-76b": 8}  # None: full depth
EMBED_PROMPT, EMBED_DECODE = 300, 3  # embeds: a prompt, then 2 decode steps
TRAIN_ARCH = "minicpm-2b"
TRAIN_STEPS = 8                     # at full depth; the launcher's batch 8 x seq 128
# The launcher's default lr 3e-4 has no warmup in an 8-step run (min(20,
# 8 // 10) = 0): Adam's first, sign-like updates move every weight by ~lr
# and the loss spikes (12.19 -> 16.96 at step 2, 12.25 at step 7 on the
# H100, scripts/torch_train_probe.py); at 1e-4 it ends at 10.19.
TRAIN_LR = 1e-4
RESUME_LAYERS = 2                   # train.resume's depth cut (widths kept)
RESUME_STEPS, RESUME_STOP, RESUME_EVERY = 6, 4, 2
# PyTorch does not promise a bitwise-repeatable backward of the embedding
# gather on CUDA, so the resumed losses are held to a tolerance (``max_rel_
# loss_diff`` prints what the run gave)
RESUME_TOL = 1e-4
# train.codec's cut of leaves, to keep the train phases near two minutes:
# compress_tree leaves out the MLP's three (80 M of 405 M entries)
CODEC_SKIP = "blocks/mlp"
# random-init weights fit to fitness ~0, so under the default gate every
# leaf stays raw: this leaf is compressed once more at gate -1 (VERSIONED_
# GATE), so that decompress_tree decodes a codec leaf on the card too
CODEC_GATED_LEAF = "blocks/attn/wo"
# the VersionedCheckpointer leaf, whose keyframe payload is also decoded
# through the kernel and the plain route
VERSIONED_LEAF = "blocks/attn/wk"
# random-init weights six steps in fit to fitness ~0 (below any gate >= 0):
# the gate is -1 so that the store path (keyframe fit, delta fit, chain
# decode) runs on the card instead of demoting the leaf to raw
VERSIONED_GATE = -1.0
VERSIONED_KEYFRAME = dict(rank=8, hidden=16, epochs=15, batch_size=65536, lr=1e-2,
                          init_reorder=False, update_reorder=False, seed=0,
                          entries_per_epoch=2_000_000)
VERSIONED_DELTA = dict(rank=4, hidden=8, batch_size=16384, seed=0)
# one pass of the delta fit over the leaf's 10.6 M entries (the default is
# 2), a cut of its epochs that keeps the train phases near two minutes
VERSIONED_DELTA_PASSES = 1
DIST_STEPS = 4                      # the data-parallel epoch's steps
DIST_BATCH = 8192                   # entries a step: the MEDIUM fit's batch
DIST_TIMING_EPOCHS = 3              # epochs timed after the checked one
DIST_LOSS_RTOL = 1e-5
DIST_PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
DIST_TIMEOUT = 240                  # seconds a world may take, start-up included
DIST_LEAF = (2048, 1024)            # the leaf dist.b restores
DIST_CELLS = (128, 32)              # the dry-run sweep's cells kept and skipped
TRAIN_KERNELS = ("lstm_scan", "lstm_scan_bwd", "tt_contract", "tt_contract_bwd")
TP_LAYERS = 8                       # tp's depth cut of minicpm-2b's 40 layers (widths kept)
TP_STEPS = 3
TP_LOSS_RTOL = 1e-4                 # tests/test_spmd.py's loss bound, where not bitwise
# where not bitwise, params within half an Adam step at TRAIN_LR: a step
# moves an element by about TRAIN_LR whatever its gradient, so only the
# gradients (TP_GRAD_REL of each leaf's largest) and the losses tell a
# wrong gradient from a right one; a zero or sign-flipped one reads >= lr
TP_PARAM_TOL = dict(rtol=0.0, atol=0.5 * TRAIN_LR)
TP_GRAD_REL = 1e-5
TP_GRAD_BATCH = (8, 128)            # the launcher's default batch x seq
PP_LAYERS, PP_STAGES, PP_MICROBATCHES = 8, 2, 4   # pp: 4 layers a stage
PP_MICROBATCH = (2, 128)            # sequences x tokens a microbatch: 8 x 128 in all
PP_TOL = 2e-4                       # rtol = atol, tests/test_spmd.py's pipeline bound
PP_TIMED = 3                        # timed pipeline runs after the checked one
EMBED_EPOCHS = 1                    # the reference's default is 150
EMBED_LOOKUP = (8, 128)


def tt_bwd_wide_row(torch, device, launches, errs):
    """The ``tt_contract`` backward's wide plan at the 4 MB budget fit's
    step (B 16384, K 8, R 57; ``tt_bwd_inputs``): the call (CUDA events, 20
    after 2 warm-ups; mid is 1.7 GB, far above the L2), the plain version
    (5), the byte bound; ``launches`` its launches in phase fit_budget."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tt_contract as _tt

    b, k, r = BWD_TT_WIDE_TIMED[1]
    first, mid, last, dout = tt_bwd_inputs(torch, torch.Generator().manual_seed(SEED), b, k, r,
                                           device)
    plan = _tt.bwd_plan(r, k, b, torch.cuda.get_device_properties(device).multi_processor_count)
    require(plan.kind == "wide", f"the budget fit's step takes the {plan.kind} plan")
    n_ops, n_bytes = tt_bwd_cost(b, k, r)
    row = {"name": "tt_contract_bwd_wide", "route": "cuda",
           "source": SOURCES["tt_contract_bwd"][0], "replaces": SOURCES["tt_contract_bwd"][1],
           "launches": launches,
           "max_abs_err": errs["tt_contract_bwd_wide"],
           "ms": time_ms(torch, lambda: _tt.tt_contract_bwd(first, mid, last, dout), 20),
           "plain_ms": time_ms(torch, lambda: ref.tt_contract_bwd(first, mid, last, dout), 5),
           **bound(n_ops, n_bytes, PEAK_FP32), "library_ms": None, "library": None,
           "library_max_abs_err": None, "plan": dataclasses.asdict(plan),
           "shape": {"B": b, "K": k, "R": r}, "ops": n_ops, "bytes": n_bytes,
           "note": "the wide plan's kernel (tt_contract_bwd_wide_cluster_kernel); launches: "
                   "phase fit_budget's; max_abs_err: over kernels.bwd's wide cases"}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) in the binade of ``x``."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8) if x else 0.0


def compare(torch, got, want, dtype_name: str) -> tuple[float, float]:
    """(max abs error, in bf16 that error in ulps of the largest |want|).

    Fails beyond the dtype's tolerance (rtol = atol) and, in bf16, beyond
    ``BF16_ULPS`` ulps of the largest |want|: both versions compute in f32
    and round once, so they may differ by the last bit only.
    """
    require(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(got.dtype == want.dtype, f"dtype {got.dtype} != {want.dtype}")
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), "non-finite kernel output")
    tol = TOL[dtype_name]
    err = (g - w).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    bad = int((err > tol + tol * w.abs()).sum())
    require(bad == 0, f"{bad} values beyond tolerance {tol}, max abs err {max_err}")
    ulps = 0.0
    if dtype_name == "bfloat16" and w.numel():
        ulp = bf16_ulp(float(w.abs().max()))
        ulps = max_err / ulp if ulp else (0.0 if max_err == 0 else math.inf)
        require(ulps <= BF16_ULPS,
                f"bf16 max abs err {max_err} is {ulps} ulps of the largest value")
    return max_err, ulps


def flash_elementwise(torch, got, want) -> dict:
    """Per-element reading of a bf16 attention output against the plain
    one: how many elements lie beyond 1 bf16 ulp of their own |want| plus
    ``FLASH_ROW_FLOOR`` of their row's (last axis) largest |want|, and the
    largest error in units of that limit."""
    g, w = got.float(), want.float()
    a = w.abs()
    ulp = torch.where(a > 0, torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8),
                      torch.zeros_like(a))
    limit = ulp + FLASH_ROW_FLOOR * a.amax(-1, keepdim=True)
    err = (g - w).abs()
    beyond = err > limit
    ratio = torch.where(limit > 0, err / limit, torch.where(err > 0, math.inf, 0.0))
    return {"beyond": int(beyond.sum()), "elements": int(err.numel()),
            "worst_over_limit": float(ratio.max()) if err.numel() else 0.0}


def flash_elementwise_f32(torch, got, want) -> dict:
    """Per-element reading of an f32 attention output against the plain
    one (or an f64 one): how many elements lie beyond f32's tolerance,
    1e-5 + 1e-5 of their own |want| (``compare``'s rule, element by
    element), and the largest error in units of that limit."""
    g, w = (got.float(), want.float()) if want.dtype != torch.float64 else (got, want)
    limit = TOL["float32"] * (1 + w.abs())
    err = (g - w).abs()
    return {"beyond": int((err > limit).sum()), "elements": int(err.numel()),
            "worst_over_limit": float((err / limit).max()) if err.numel() else 0.0}


def flash_f64(torch, q, k, v):
    """Causal MHA attention, the plain version's function (q scaled by
    1/sqrt(D) before the product, softmax, P V), evaluated in f64."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() * (1.0 / d**0.5), k.double())
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).tril()
    s = torch.where(keep, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double()) / p.sum(-1).transpose(1, 2)[..., None]


def flash_bf16p_control(torch, q, k, v):
    """Causal attention as the plain version computes it, but with p rounded
    to bf16 before P.V (as SDPA's kernels do): the weaker design that the
    per-element check must reject.  MHA, no offset, no padding."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / d**0.5), k.float())
    n = s.shape[-1]
    keep = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    s = torch.where(keep, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v.float())
    return (out / p.sum(-1).permute(0, 2, 1)[..., None]).to(q.dtype)


def device_kernels(torch, fns, times: bool = False) -> list[list]:
    """Names of the device kernels and copies that each of the calls
    ``fns`` runs, in the order the device ran them, from one
    ``torch.profiler`` session: one list a call (with ``times``, (name,
    device microseconds) pairs).

    One session serves every call: a second session in one process has
    been seen to return no device events.  Each call is synchronised and
    framed by ``PROFILE_PAD_S`` of idle host time, so that a kernel whose
    device timestamp maps a little off the host clock stays inside the
    capture window, and the calls' events are told apart by those gaps
    (a call's own operations follow each other within microseconds).
    Fails unless there are as many groups as calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            time.sleep(PROFILE_PAD_S)
            fn()
            torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    groups, last = [], None
    for e in events:
        if last is None or e.time_range.start - last > PROFILE_PAD_S * 1e6 / 2:
            groups.append([])
        groups[-1].append((e.name, e.time_range.elapsed_us()) if times else e.name)
        last = e.time_range.end
    require(len(groups) == len(fns),
            f"{len(fns)} profiled calls ran {len(groups)} groups of device operations: {groups}")
    return groups


def flash_cost(b: int, s: int, h: int, d: int, elem_bytes: int) -> tuple[int, int]:
    """(FLOP, bytes) of causal MHA flash attention over S positions: two
    products over the S (S + 1) / 2 visible (q, k) pairs of each head;
    q, k, v read once and out written once."""
    return 4 * b * h * d * (s * (s + 1) // 2), 4 * b * s * h * d * elem_bytes


def bound(n_ops: int, n_bytes: int, peak_ops: float) -> dict:
    """``bound_ms`` and ``bound_by``: the larger of ``n_ops`` over
    ``peak_ops`` and ``n_bytes`` over ``PEAK_BYTES``."""
    t_ops, t_bytes = n_ops / peak_ops * 1e3, n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lstm_cost(b: int, t: int, h: int) -> tuple[int, int]:
    """(FLOP, bytes) of an f32 LSTM scan: 16 h^2 FLOP per entry and step;
    x read and every h written once, the weights read once."""
    return b * t * 16 * h * h, (2 * b * t * h + 8 * h * h + 4 * h) * 4


def cudnn_lstm(torch, wi, wh, bias):
    """cuDNN ``torch.nn.LSTM`` holding wi, wh [H, 4H] and b [4H] (gates i,
    f, g, o), as a function x [B, T, H] -> every h: ``lstm_scan``'s
    library yardstick."""
    h = wi.shape[0]
    net = torch.nn.LSTM(h, h, batch_first=True).to(wi.device)
    with torch.no_grad():
        net.weight_ih_l0.copy_(wi.T)
        net.weight_hh_l0.copy_(wh.T)
        net.bias_ih_l0.copy_(bias)
        net.bias_hh_l0.zero_()

    def run(x):
        with torch.no_grad():
            return net(x)[0]
    return run


def chain_equation(k: int) -> str:
    """``torch.einsum`` equation of first . mid_1 ... mid_k . last -> [B]."""
    chain = "acdefghijklmnopqrstuvwxyz"[: k + 1]
    terms = ["b" + chain[0]] + ["b" + chain[j : j + 2] for j in range(k)] + ["b" + chain[k]]
    return ",".join(terms) + "->b"


def decode_inputs(torch, gen, b, t, m, hid, rank, dtype, device, width_scaled=False):
    """Random operands of the fused decode, scaled as the reference's tests.
    ``width_scaled`` multiplies every product over the hidden width by
    sqrt(16 / hid), so a wide shape's values stay O(1) as they do at H 16
    (with fixed scales the chain grows like (0.5 sqrt(R))^(T-2), and where
    such values cancel an f32 sum's rounding outgrows the tolerance)."""
    width = (16 / hid) ** 0.5 if width_scaled else 1.0

    def mk(*shape, scale=0.3):
        return (torch.randn(shape, generator=gen) * scale).to(device=device, dtype=dtype)

    idx = torch.randint(0, m, (b, t), generator=gen, dtype=torch.int32).to(device)
    return idx, (
        mk(t, m, hid),
        mk(hid, 4 * hid, scale=0.3 * width), mk(hid, 4 * hid, scale=0.3 * width),
        mk(4 * hid, scale=0.1),
        mk(hid, rank, scale=0.3 * width), mk(rank, scale=0.1),
        mk(hid, rank * rank, scale=0.5 / rank**0.5 * width), mk(rank * rank, scale=0.1),
        mk(hid, rank, scale=0.3 * width), mk(rank, scale=0.1),
    )


def decode_cost(b: int, t: int, hid: int, rank: int) -> int:
    """FP32 operations of the fused decode: the LSTM gates, the head
    projections and the chain, per entry."""
    return b * (t * 16 * hid * hid + 2 * hid * (2 * rank + (t - 2) * rank * rank)
                + 2 * (t - 2) * rank * rank + 2 * rank)


def simt_tile(hid: int, rank: int) -> dict:
    """The simt decode body's block at (hid, rank): the rank it runs (R
    rounded up to 4), its tile of entries and its shared-memory bytes."""
    from repro_torch.kernels import decode_tile as _decode_tile

    rp = _decode_tile.simt_rank(rank)
    tile = _decode_tile.simt_tile(hid, rp)
    return {"H": hid, "R": rank, "simt_rank": rp, "tile": tile,
            "smem_bytes": _decode_tile.simt_smem_bytes(hid, rp, tile)}


def lstm_simt_tile(hid: int) -> dict:
    """The simt lstm_scan body's block at ``hid``: its tile of sequences
    and its shared-memory bytes."""
    from repro_torch.kernels import lstm as _lstm

    tile = _lstm.simt_tile(hid)
    return {"H": hid, "tile": tile, "smem_bytes": _lstm.simt_smem_bytes(hid, tile)}


def tt_bytes(b: int, k: int, r: int, elem: int) -> int:
    """Bytes ``tt_contract`` must move: first, mid and last read once, the
    output written once."""
    return (2 * b * r + b * k * r * r + b) * elem


def lstm_inputs(torch, gen, b, t, h, dtype, device, offset=0):
    """x [b, t, h], starting ``offset`` elements into its buffer, and wi,
    wh, b scaled as the reference's tests."""
    x = torch.randn((b * t * h + offset,), generator=gen).to(device, dtype)[offset:]
    return x.view(b, t, h), tuple(
        (torch.randn(shape, generator=gen) * scale).to(device, dtype)
        for shape, scale in (((h, 4 * h), 0.3), ((h, 4 * h), 0.3), ((4 * h,), 0.1)))


def flash_inputs(torch, gen, b, sq, skv, hq, hkv, d, dtype, device):
    """q, k, v padded to the 128 tile as ``ops.attention`` pads them, and
    the ``kv_valid`` it passes."""
    def mk(s, h):
        x = torch.randn((b, s, h, d), generator=gen)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, (-s) % 128))
        return x.to(device=device, dtype=dtype)

    return mk(sq, hq), mk(skv, hkv), mk(skv, hkv), (skv if skv % 128 else None)


# (b, sq, skv, hq, hkv, d, q_offset, causal)
FLASH_CASES = (
    (1, 128, 128, 4, 4, 64, 0, True),     # the reference's grid
    (2, 256, 256, 8, 2, 64, 0, True),
    (2, 128, 128, 4, 1, 128, 0, True),
    (2, 128, 256, 4, 4, 64, 128, True),   # q_offset = 128
    (1, 130, 130, 2, 2, 64, 0, True),     # odd Sq and Skv: the pad path
    (1, 130, 130, 2, 2, 64, 0, False),
    (1, 128, 130, 2, 2, 64, 0, True),     # ragged kv only
    (1, 200, 200, 48, 4, 128, 0, True),   # starcoder2's 48 / 4 grouping
    (1, 128, 128, 2, 2, 64, -64, True),   # rows 0..63 fully masked
    (1, 130, 130, 2, 1, 8, -100, True),   # fully masked rows, padded grid
    (1, 256, 256, 6, 6, 8, 0, True),      # the smoke configs' head dim
    (1, 128, 128, 20, 20, 128, 0, True),  # the serve path's shapes
    (1, 300, 300, 20, 20, 128, 0, True),
    (1, 2048, 2048, 20, 20, 128, 0, True),
    # the tensor-core body's edges
    (2, 512, 512, 4, 1, 128, 0, True),    # B 2, GQA 4/1: two kv heads of work
    (1, 1024, 1024, 4, 4, 64, 0, True),   # minicpm's head dim 64
    (1, 128, 384, 4, 4, 128, 256, True),  # q_offset > 0 with Skv > Sq
    (1, 256, 230, 4, 2, 128, 0, True),    # kv_valid 230 inside a 64-row kv tile
    (1, 128, 128, 2, 2, 128, -64, True),  # rows 0..63 fully masked at D 128
    (1, 4096, 4096, 20, 20, 128, 0, True),  # the serve shape at S 4096
    # the families' prefills: musicgen 24/24 at D 64, grok 48/8, llama4
    # 40/8, internvl2 64/8 at D 128, at the longest and a ragged prompt
    (1, 2048, 2048, 24, 24, 64, 0, True),
    (1, 300, 300, 24, 24, 64, 0, True),
    (1, 2048, 2048, 48, 8, 128, 0, True),
    (1, 300, 300, 48, 8, 128, 0, True),
    (1, 2048, 2048, 40, 8, 128, 0, True),
    (1, 2048, 2048, 64, 8, 128, 0, True),
)
# shapes off the buckets, run on zero-padded weights: (12, 5) in (12, 8),
# the paper's SMALL 12/6 in (12, 8), its MEDIUM 18/10 in (20, 12)
PADDED_DECODE = ((12, 5), (12, 6), (18, 10))
# the simt decode body's cases, (hidden, rank, B, T): the reference's budget
# rule (NTTDCodec._rank_for_budget) picks (68, 34) at 1 MB and (114, 57) at
# 4 MB for PEMS-SF and Uber, and reaches (256, 128)
WIDE_DECODE = ((68, 34, 4096, 10), (114, 57, 4096, 10), (256, 128, 1000, 5))
# the wide phase: the 1 MB rule's architecture on a PEMS-SF-shaped payload
# (two decode_at requests) and an Uber-shaped one (183 x 24 x 1140, paper
# Table II, 5,006,880 entries: one to_dense)
WIDE_RANK, WIDE_HIDDEN = 34, 68
UBER_SHAPE = (183, 24, 1140)
WIDE_REQUESTS = 2
# the simt decode body timed at B REQUEST, T 10 (f32)
WIDE_TIMING = ((68, 34), (114, 57))
# lstm_scan cases beside its register body's buckets: (hidden, x's offset
# in elements into its buffer).  5 (fig8), 18 (paper MEDIUM) and 24 (fleet
# repair) are padded inside the kernel, 18's 72-byte rows and an x one
# element off the 16-byte grid take the scalar loads; 68 and 114 (the
# budget rule at 1 and 4 MB), 96 and 256 (its widest) the simt body.
LSTM_EXTRA = ((5, 0), (18, 0), (24, 0), (16, 1), (68, 0), (96, 0), (114, 0), (256, 0))
# the simt lstm_scan body timed at B REQUEST, T 10 (f32); the first is the
# wide phase's width
LSTM_SIMT_TIMING = (68, 96, 114)
# tt_contract cases (B, K, R): the reference's grid, then the budget rule's
# ranks 34, 57 and 128
TT_CASES = ((64, 5, 8), (100, 10, 16), (7, 3, 8), (256, 8, 32), (1000, 8, 34), (517, 5, 57),
            (200, 3, 128))
LSTM_B, LSTM_T = 1000, 10
# registers a thread that leave room for three blocks of 128 threads a SM
# (65,536 registers, allocated in steps of 8 a thread)
LSTM_H16_REGISTERS = 168
# the backward kernels against their plain versions, per gradient
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
# lstm_scan backward cases (B, T, H): the paper's SMALL and MEDIUM widths
# at their fit batches, the budget rule's 1 MB width and its widest, and a
# step of the stream phase (d' 14)
BWD_LSTM_CASES = ((8192, 10, 12), (8192, 10, 18), (4096, 10, 68), (1024, 5, 256),
                  (8192, 14, 12))
# tt_contract backward cases (B, K, R): SMALL's and MEDIUM's ranks at K 8
# (PEMS-SF's d' 10), the 1 MB rank, the widest at K 4, a B off the slab of
# entries (16 a slab at R 10), a K R^2 that is not a multiple of 4 (the slab
# plan's ragged heads and tails), a step of the stream phase (K 12); then
# the wide plan at the 4 MB rank at K 5 on a batch off the card's SMs
# (517, as the forward's TT_CASES), the first rank past the slab plan at K
# 8 (43), the 4 MB fit's step (57, at the adapter's batch 16384) and the
# budget rule's widest at K 8 (128)
BWD_TT_CASES = ((8192, 8, 6), (8192, 8, 10), (4096, 8, 34), (256, 4, 128), (1001, 8, 10),
                (1001, 3, 5), (8192, 12, 6), (517, 5, 57), (16384, 8, 43), (16384, 8, 57),
                (8192, 8, 128))
BWD_TT_WIDE_TIMED = BWD_TT_CASES[-3:]
# the fit phase: the paper's MEDIUM on the PEMS-SF replica at its Table II
# shape, 6 epochs so that one Alg. 3 sweep runs after the fifth, 2^21
# entries (256 steps of 8192) an epoch
FIT_DATASET = "pems_sf"
FIT_EPOCHS, FIT_REORDER = 6, 5
FIT_ENTRIES = 1 << 21
FIT_REDUCED = [
    "epochs: 6 of MEDIUM's 200, so that exactly one Alg. 3 sweep runs (reorder_warmup = "
    "reorder_every = 5)",
    "entries_per_epoch: 2^21 (256 steps of 8192) of the tensor's 61,015,680",
]
# the fit.parity phase: fitness histories of the "ref" and "auto" routes
FIT_PARITY_TOL = 1e-3
# the stream phase: the reference's fig5 FULL streaming run
# (benchmarks/fig5_compress_scaling.py:104-113), 2^26 entries in 256 slabs
# of 2^18, two steps of 8192 a slab; d' 14, so the kernels run at T 14, K
# 12.  The learning rate is the reference's end-to-end stream test's
# (tests/test_stream.py:400-420): at fig5's default 5e-3 the fit learns no
# signal at this shape (scripts/torch_stream_signal.py)
STREAM_SHAPE = (16384, 64, 64)
STREAM_SLAB = 1 << 18
STREAM_OPTS = dict(rank=6, hidden=12, steps_per_slab=2, batch_size=8192, lr=2e-2, seed=0)
STREAM_CHANGED = ["lr 2e-2, the reference's end-to-end stream test's, where fig5 keeps the "
                  "default 5e-3, at which the fit learns no signal at this shape "
                  "(scripts/torch_stream_signal.py)"]
STREAM_SOURCE_SEED = 1
STREAM_CHUNK_BYTES = 2048
STREAM_HELDOUT = ((0, 64, 128, 192, 255), 64)  # slabs sampled, entries a slab
STREAM_CORR_ENTRIES = 1 << 20
STREAM_CORR_MIN = 0.5  # the reference's bar, tests/test_stream.py:400-420
STREAM_PARITY_SLABS = 16
STREAM_PARITY_RTOL, STREAM_PARITY_ATOL = 1e-4, 1e-6  # tests/test_torch_fit.py:9-10
STREAM_PARITY_ENTRIES = 1 << 18
STREAM_DELTA_SHAPE = (256, 64, 64)
STREAM_DELTA_OPTS = dict(rank=3, hidden=6, steps_per_slab=2, batch_size=8192, seed=0)
STREAM_DELTA_SCALE, STREAM_DELTA_SEEDS = 0.05, (2, 3)
# a training step of the stream (B, T, H, R): the kernel cases at its shapes
STREAM_STEP = (8192, 14, 12, 6)
# phase service: CodecService on the card over phase main's PEMS-SF payload
# (a chunked v3 file with a held-out block of the plain route's decode),
# phase stream's fig5 file, phase stream.delta's v4 file and a
# VersionedStore at fig10's NTTD settings (benchmarks/fig10_temporal.py:120-131)
SERVICE_CACHE_BYTES = 64 << 20
SERVICE_TILE = 65_536               # entries a decode tile: 932 tiles of 256 KiB
SERVICE_CANARY = dict(canary_fraction=0.25, canary_seed=0, canary_min_fitness=0.999)
SERVICE_HELDOUT = 4096              # held-out entries in the PEMS-SF file
SERVICE_CHUNKS = 8                  # the PEMS-SF body in this many chunks
SERVICE_DIRECT = 32                 # direct requests of REQUEST entries
SERVICE_WINDOW = (100, 64, 64)      # first tile, tiles, requests of REQUEST entries
SERVICE_SWEEP_TILES = 512           # one request over this many tiles: must evict
SERVICE_SUBMITS = (64, 1024)        # submits of this many entries, one flush
SERVICE_FIG5_REQUESTS = 8           # requests of the fig5 file (canaries at calls 0, 4)
SERVICE_MEM_SLACK = 1 << 20         # device bytes beyond the payloads' own tensors
SERVICE_TOL = 1e-5                  # rtol = atol against the plain route
FLEET_INSTANCES = 4                 # in-process members of fleet.local
FLEET_WORKERS = 3                   # repro_torch.fleet.worker processes of fleet.procs
FLEET_REPLICATION = 2
FLEET_DRAIN_SUBMITS = 8             # submits queued before each rebalance
STORE_SHAPE, STORE_VERSIONS, STORE_KEYFRAME_INTERVAL = (24, 16, 16), 8, 8
STORE_DRIFT = dict(drift=0.04, noise=0.03, seed=11)
STORE_KEYFRAME_OPTS = dict(rank=8, hidden=16, epochs=30, batch_size=2048, eval_batch=2048,
                           init_reorder=False, update_reorder=False, seed=0)
STORE_DELTA_OPTS = dict(rank=2, hidden=8, d_prime=2, lr=1e-2, batch_size=1024,
                        steps_per_slab=150, seed=0)
STORE_CHUNK_BYTES = 4096


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def cuda_tool(name: str) -> str | None:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    return path if os.path.exists(path) else None


def demangle(names: list[str]) -> list[str]:
    tool = cuda_tool("cu++filt")
    if not tool or not names:
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


def ptxas_resources(log: str) -> list[dict]:
    """Per kernel from ``-Xptxas -v``: registers, shared memory, stack, spills."""
    rows = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            rows.append({"kernel": line.split("'")[1]})
        elif rows and "spill stores" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
            rows[-1].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                            spill_load_bytes=nums[2])
        elif rows and "Used" in line and "registers" in line:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    for row, name in zip(rows, demangle([r["kernel"] for r in rows])):
        row["kernel"] = name
    return rows


def sass_hgmma(path) -> dict:
    """Tensor-core (HGMMA) instructions per kernel in the built library."""
    tool = cuda_tool("cuobjdump")
    if tool is None:
        return {"tool": None, "note": "cuobjdump not found: no SASS count"}
    res = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                         timeout=300)
    require(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()[:500]}")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and re.search(r"\bHGMMA\b", line):
            counts[name] += 1
    names = sorted(counts)
    return {"tool": "cuobjdump -sass",
            "hgmma": {pretty: counts[raw] for raw, pretty in zip(names, demangle(names))}}


def phase_device(torch):
    from repro_torch.kernels import _build

    smi = nvidia_smi_line()
    path, seconds, log = _build.build()
    _build.library()
    resources = ptxas_resources(log)
    emit({"phase": "device", "name_power_limit": smi,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": seconds,
          "nvcc_seconds": {m.group(1): float(m.group(2))
                           for m in re.finditer(r"^== (\S+) \(([\d.]+) s\)$", log, re.M)},
          "library": os.path.relpath(path, ROOT),
          "ptxas": resources})
    h16 = [r for r in resources if "lstm_scan_register_kernel" in r["kernel"]
           and "(int)16>" in r["kernel"]]
    require(len(h16) == 2 and all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0
                                  and r["registers"] <= LSTM_H16_REGISTERS for r in h16),
            f"lstm_scan's H 16 register body spills or exceeds {LSTM_H16_REGISTERS} "
            f"registers: {h16}")
    # the simt decode body: its ptxas resources, and the tile of entries a
    # block owns at each wide shape; it must not spill
    simt = [r for r in resources if "decode_tile_simt_kernel" in r["kernel"]]
    emit({"phase": "device.decode_simt", "ptxas": simt,
          "tiles": [simt_tile(h, r) for h, r in sorted({(h, r) for h, r, _, _ in WIDE_DECODE}
                                                        | set(WIDE_TIMING))]})
    require(len(simt) == 2 and all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0
                                   for r in simt),
            f"the simt decode body spills: {simt}")
    # the simt lstm_scan body likewise, with its tile of sequences
    simt = [r for r in resources if "lstm_scan_simt_kernel" in r["kernel"]]
    emit({"phase": "device.lstm_simt", "ptxas": simt,
          "tiles": [lstm_simt_tile(h) for h, _ in LSTM_EXTRA if h > 64]})
    require(len(simt) == 2 and all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0
                                   for r in simt),
            f"the simt lstm_scan body spills: {simt}")
    # the backward kernels: their resources, one kernel a plan, and each
    # backward's plan at the shapes it is held at (lstm: where the weights
    # are read from, tile of sequences, threads, shared memory; tt: slab or
    # wide, entries a slab, threads, blocks, shared memory, blocks a
    # cluster); none may spill
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import tt_contract as _tt

    bwd = [r for r in resources if "_bwd_" in r["kernel"] and "_kernel" in r["kernel"]]
    emit({"phase": "device.bwd", "ptxas": bwd,
          "lstm_bwd_plans": [dataclasses.asdict(_lstm.bwd_plan(h, b))
                             for b, _, h in BWD_LSTM_CASES],
          "tt_bwd_plans": [{"B": b, "K": k, "R": r, **dataclasses.asdict(_tt.bwd_plan(r, k, b))}
                           for b, k, r in BWD_TT_CASES]})
    require(len(bwd) == 5,
            f"ptxas reports {len(bwd)} backward kernels, expected 5 (the lstm_scan backward's "
            f"three plans, tt_contract's slab and wide plans): {bwd}")
    require(all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0 for r in bwd),
            f"a backward kernel spills: {bwd}")
    # the tf32x3 flash body: one kernel per (dtype, D) it serves, its launch
    # plan at each D; none may spill
    from repro_torch.kernels import attention as _attention

    tf32x3 = [r for r in resources if "flash_attention_tf32x3_kernel" in r["kernel"]]
    emit({"phase": "device.flash_tf32x3", "ptxas": tf32x3,
          "plans": {d: dataclasses.asdict(_attention.tf32x3_plan(d))
                    for d in _attention.HEAD_DIMS}})
    require(len(tf32x3) == 4 and all(r["spill_store_bytes"] == r["spill_load_bytes"] == 0
                                     for r in tf32x3),
            f"ptxas reports {len(tf32x3)} tf32x3 flash kernels, expected 4 (f32 at D 8, 64 "
            f"and 128, bf16 at D 8), or one spills: {tf32x3}")
    sass = sass_hgmma(path)
    if sass["tool"]:
        wgmma = {k: n for k, n in sass["hgmma"].items() if "flash_attention_wgmma" in k}
        require(len(wgmma) == 2 and all(wgmma.values()),
                f"the wgmma flash body has no HGMMA in its SASS: {wgmma}")
        tf32 = {k: n for k, n in sass["hgmma"].items() if "flash_attention_tf32x3" in k}
        require(len(tf32) == 4 and all(tf32.values()),
                f"the tf32x3 flash body has no HGMMA in its SASS: {tf32}")
    emit({"phase": "sass", **sass})
    return smi


def phase_kernels(torch, device):
    """Every kernel against its plain version on the card."""
    from repro_torch.kernels import attention as _attention
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tt_contract as _tt

    gen = torch.Generator().manual_seed(SEED)
    flash_cases, decode_cases, lstm_cases, tt_cases = [], [], [], []
    errs = {name: {"float32": 0.0, "bfloat16": 0.0, "bfloat16_ulps": 0.0}
            for name in SOURCES}
    cases = 0

    def record(name, dt_name, got, want):
        nonlocal cases
        err, ulps = compare(torch, got, want, dt_name)
        errs[name][dt_name] = max(errs[name][dt_name], err)
        errs[name]["bfloat16_ulps"] = max(errs[name]["bfloat16_ulps"], ulps)
        cases += 1
        return err, ulps

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        # the reference's decode grid (tests/test_kernels.py), B = 33 and 0
        for rank in (4, 8, 32):
            for t in (2, 3, 8):
                for b in (33, 0):
                    idx, ws = decode_inputs(torch, gen, b, t, 10, 16, rank, dtype, device)
                    got = ops.nttd_decode_tile(idx, *ws, impl="cuda")
                    want = ops.nttd_decode_tile(idx, *ws, impl="ref")
                    record("decode_tile", dn, got, want)
                    x = (torch.randn((b, t, 16), generator=gen)).to(device, dtype)
                    record("lstm_scan", dn, ops.lstm_scan(x, *ws[1:4], impl="cuda"),
                           ref.lstm_scan(x, *ws[1:4]))
                    k = max(t - 2, 1)
                    first = torch.randn((b, rank), generator=gen).to(device, dtype)
                    mid = (torch.randn((b, k, rank, rank), generator=gen)
                           * (0.5 / rank**0.5)).to(device, dtype)
                    last = torch.randn((b, rank), generator=gen).to(device, dtype)
                    record("tt_contract", dn, ops.tt_contract(first, mid, last, impl="cuda"),
                           ref.tt_contract(first, mid, last))
        # the reference's lstm and tt grids
        for b, t, h in ((16, 6, 8), (50, 9, 16), (33, 12, 32), (8, 3, 64)):
            _, ws = decode_inputs(torch, gen, 1, 2, 2, h, 4, dtype, device)
            x = torch.randn((b, t, h), generator=gen).to(device, dtype)
            record("lstm_scan", dn, ops.lstm_scan(x, *ws[1:4], impl="cuda"),
                   ref.lstm_scan(x, *ws[1:4]))
        for b, k, r in TT_CASES:
            first = torch.randn((b, r), generator=gen).to(device, dtype)
            mid = (torch.randn((b, k, r, r), generator=gen) * (0.5 / r**0.5)).to(device, dtype)
            last = torch.randn((b, r), generator=gen).to(device, dtype)
            err, ulps = record("tt_contract", dn, ops.tt_contract(first, mid, last, impl="cuda"),
                               ref.tt_contract(first, mid, last))
            tt_cases.append({"B": b, "K": k, "R": r, "dtype": dn, "body": "lane_group",
                             "lanes_per_entry": _tt.lanes_per_entry(r),
                             "max_abs_err": err, "ulps": ulps})
        # main-path shapes (T = 10, M = 8, H = 16, R = 8), H = 64, R = 32, and
        # a step of the stream phase (B 8192, T 14, M 8, H 12, R 6: K 12)
        sb, st, sh, sr = STREAM_STEP
        for b, t, m, h, r in ((REQUEST, 10, 8, HIDDEN, RANK), (4096, 10, 8, 64, 32),
                              (sb, st, 8, sh, sr)):
            idx, ws = decode_inputs(torch, gen, b, t, m, h, r, dtype, device)
            record("decode_tile", dn, ops.nttd_decode_tile(idx, *ws, impl="cuda"),
                   ops.nttd_decode_tile(idx, *ws, impl="ref"))
            x = torch.randn((b, t, h), generator=gen).to(device, dtype)
            record("lstm_scan", dn, ops.lstm_scan(x, *ws[1:4], impl="cuda"),
                   ref.lstm_scan(x, *ws[1:4]))
            first = torch.randn((b, r), generator=gen).to(device, dtype)
            mid = (torch.randn((b, t - 2, r, r), generator=gen) * (0.5 / r**0.5)).to(
                device, dtype)
            last = torch.randn((b, r), generator=gen).to(device, dtype)
            record("tt_contract", dn, ops.tt_contract(first, mid, last, impl="cuda"),
                   ref.tt_contract(first, mid, last))
        # every instantiated (H, R) bucket, and a shape padded to one
        for h, r in _decode_tile.BUCKETS + PADDED_DECODE:
            idx, ws = decode_inputs(torch, gen, 1000, 5, 9, h, r, dtype, device)
            err, ulps = record("decode_tile", dn, ops.nttd_decode_tile(idx, *ws, impl="cuda"),
                               ops.nttd_decode_tile(idx, *ws, impl="ref"))
            decode_cases.append({"H": h, "R": r, "dtype": dn, "body": _decode_tile.decode_body(h, r),
                                 "bucket": list(_decode_tile.bucket_for(h, r)),
                                 "max_abs_err": err, "ulps": ulps})
        # the simt body above the largest bucket, inputs scaled to the width
        for h, r, b, t in WIDE_DECODE:
            idx, ws = decode_inputs(torch, gen, b, t, 9, h, r, dtype, device, width_scaled=True)
            simt_before = _decode_tile.simt_launches
            err, ulps = record("decode_tile_simt", dn,
                               ops.nttd_decode_tile(idx, *ws, impl="cuda"),
                               ops.nttd_decode_tile(idx, *ws, impl="ref"))
            require(_decode_tile.simt_launches == simt_before + 1,
                    f"decode_tile ({h}, {r}) did not run the simt body")
            decode_cases.append({"H": h, "R": r, "B": b, "T": t, "dtype": dn,
                                 "body": _decode_tile.decode_body(h, r), "bucket": None,
                                 "tile": simt_tile(h, r)["tile"],
                                 "max_abs_err": err, "ulps": ulps})
        # lstm_scan's register body at every bucket, padded widths, both
        # load routes, and its simt body above the largest bucket
        for h, offset in [(h, 0) for h in _lstm.BUCKETS] + list(LSTM_EXTRA):
            x, lw = lstm_inputs(torch, gen, LSTM_B, LSTM_T, h, dtype, device, offset)
            body = _lstm.lstm_body(h)
            simt_before = _lstm.simt_launches
            got = ops.lstm_scan(x, *lw, impl="cuda")
            require(_lstm.simt_launches == simt_before + (body == "simt"),
                    f"lstm_scan at H {h} did not run the {body} body")
            err, ulps = record("lstm_scan" if body == "register" else "lstm_scan_simt", dn, got,
                               ref.lstm_scan(x, *lw))
            lstm_cases.append({
                "H": h, "dtype": dn, "body": body,
                "bucket": _lstm.bucket_for(h) if body == "register" else None,
                "tile": _lstm.simt_tile(h) if body == "simt" else None,
                "loads": "vector" if body == "register" and _lstm.vector_rows(x, got)
                else "scalar", "x_offset_bytes": x.data_ptr() % 16,
                "max_abs_err": err, "ulps": ulps})
        routes = {(c["body"], c["loads"]) for c in lstm_cases if c["dtype"] == dn}
        require(routes == {("register", "vector"), ("register", "scalar"), ("simt", "scalar")},
                f"lstm_scan cases in {dn} ran the routes {sorted(routes)}")
        # an index outside [0, M) gathers a zero row in both versions
        idx, ws = decode_inputs(torch, gen, 33, 3, 10, 16, 8, dtype, device)
        idx[0, 1] = 10
        idx[1, 2] = -1
        record("decode_tile", dn, ops.nttd_decode_tile(idx, *ws, impl="cuda"),
               ops.nttd_decode_tile(idx, *ws, impl="ref"))
        for b, sq, skv, hq, hkv, d, q_offset, causal in FLASH_CASES:
            q, k, v, kv_valid = flash_inputs(torch, gen, b, sq, skv, hq, hkv, d, dtype, device)
            kw = dict(causal=causal, q_offset=q_offset, kv_valid=kv_valid)
            body = _attention.flash_body(dtype, d)
            tf32x3_before = _attention.tf32x3_launches
            got = _attention.flash_attention(q, k, v, **kw)
            require(_attention.tf32x3_launches == tf32x3_before + (body == "tf32x3"),
                    f"flash case {(b, sq, skv, hq, hkv, d)} {dn} did not run the {body} body")
            want = ref.flash_attention(q, k, v, **kw)
            err, ulps = record("flash_attention_f32" if body == "tf32x3" else "flash_attention",
                               dn, got, want)
            row = {"case": [b, sq, skv, hq, hkv, d, q_offset, causal], "dtype": dn,
                   "body": body, "max_abs_err": err, "ulps": ulps}
            if dtype == torch.float32:
                row["elementwise"] = flash_elementwise_f32(torch, got, want)
            if dtype == torch.bfloat16:
                row["elementwise"] = flash_elementwise(torch, got, want)
                require(row["elementwise"]["beyond"] == 0,
                        f"flash case {row['case']}: {row['elementwise']} beyond 1 ulp of "
                        f"each value plus {FLASH_ROW_FLOOR} of its row's largest")
            flash_cases.append(row)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "cases": cases, "tolerance": TOL, "bf16_ulps": BF16_ULPS,
          "flash_row_floor": FLASH_ROW_FLOOR, "max_abs_err": errs})
    emit({"phase": "kernels.decode_buckets", "cases": decode_cases})
    emit({"phase": "kernels.lstm_buckets", "cases": lstm_cases})
    emit({"phase": "kernels.tt_cases", "cases": tt_cases})
    emit({"phase": "kernels.flash", "cases": flash_cases})
    return errs


# the golden files and their keys in expected.npz (the v4 file at its
# latest version)
GOLDEN_FILES = (("v2_nttd.bin", "v2_nttd"), ("v3_mono.tcdc", "v3"), ("v3_chunked.tcdc", "v3"),
                ("v4_delta.tcdc", "v4_version2"))


def phase_golden(torch, device):
    import numpy as np

    from repro_torch.codecs import load_bytes
    from repro_torch.codecs.adapters import NTTDEncoded

    npz = np.load(os.path.join(ROOT, "tests", "golden", "expected.npz"))
    golden = {}
    for name, key in GOLDEN_FILES:
        with open(os.path.join(ROOT, "tests", "golden", name), "rb") as f:
            enc = load_bytes(f.read(), device=device)
        got = np.asarray(enc.decode_at(npz["indices"]), np.float64)
        np.testing.assert_allclose(got, npz[key], rtol=1e-5, atol=1e-6)
        golden[name] = {"key": key, "payload": type(enc).__name__,
                        "max_abs_err": float(np.abs(got - npz[key]).max())}

    with open(os.path.join(ROOT, "benchmarks", "results", "fig5_stream_payload.tcdc"),
              "rb") as f:
        enc5 = load_bytes(f.read(), device=device)
    dense = enc5.to_dense()
    plain = _with_impl(enc5, "ref", NTTDEncoded).to_dense()
    require(dense.shape == (64, 32, 32) and bool(np.isfinite(dense).all()),
            "fig5 payload decode shape or values")
    np.testing.assert_allclose(dense, plain, rtol=1e-5, atol=1e-5)
    emit({"phase": "golden", "tolerance": {"rtol": 1e-5, "atol": 1e-6}, "files": golden,
          "fig5_entries": int(dense.size),
          "fig5_max_abs_err_vs_plain": float(np.abs(dense - plain).max())})


def _with_impl(enc, impl, cls):
    ct = enc.ct
    return cls(dataclasses.replace(ct, cfg=dataclasses.replace(ct.cfg, kernel_impl=impl)))


def phase_main(torch, device):
    import numpy as np

    from repro_torch.codecs import container, load_bytes
    from repro_torch.codecs.adapters import NTTDEncoded
    from repro_torch.core import nttd
    from repro_torch.core.codec import CompressedTensor
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    spec = make_folding_spec(PEMS_SHAPE)
    cfg = nttd.NTTDConfig(rank=RANK, hidden=HIDDEN)
    params = nttd.init_params(torch.Generator().manual_seed(SEED), spec, cfg, device)
    rng = np.random.default_rng(SEED)
    pi = [rng.permutation(n) for n in PEMS_SHAPE]
    ct = CompressedTensor(params, pi, spec, cfg, norm_mean=0.25, norm_std=2.0)
    blob = container.save_bytes(NTTDEncoded(ct))
    enc = load_bytes(blob)  # default device: the card
    require(enc.ct.device.type == "cuda", "load_bytes did not load onto the card")
    requests = [np.stack([rng.integers(0, n, REQUEST) for n in PEMS_SHAPE], axis=1)
                for _ in range(10)]
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()

    enc_cuda = _with_impl(enc, "cuda", NTTDEncoded)
    ops.reset_launch_counts()
    answers, req_ms = [], []
    for i, idx in enumerate(requests):
        t = time.perf_counter()
        answers.append((enc if i < 8 else enc_cuda).decode_at(idx))
        req_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dense = enc.to_dense()
    dense_s = time.perf_counter() - t
    launches = ops.launch_counts()
    for name in NTTD_KERNELS:
        require(launches[name] >= 1, f"{name} was not launched on the main path")

    plain = _with_impl(enc, "ref", NTTDEncoded)
    req_err = 0.0
    for idx, got in zip(requests, answers):
        require(got.shape == (REQUEST,) and bool(np.isfinite(got).all()), "request output")
        want = plain.decode_at(idx)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        req_err = max(req_err, float(np.abs(got - want).max()))
    t = time.perf_counter()
    dense_plain = plain.to_dense()
    plain_dense_s = time.perf_counter() - t
    require(dense.shape == PEMS_SHAPE and bool(np.isfinite(dense).all()), "to_dense output")
    np.testing.assert_allclose(dense, dense_plain, rtol=1e-5, atol=1e-5)
    dense_err = float(np.abs(dense - dense_plain).max())
    # a dense read-back agrees with point queries at the same entries
    idx = requests[0][:1024]
    np.testing.assert_allclose(dense[tuple(idx.T)], answers[0][:1024], rtol=1e-5, atol=1e-5)
    n = int(np.prod(PEMS_SHAPE))
    emit({"phase": "main", "shape": list(PEMS_SHAPE), "folded_shape": list(spec.folded_shape),
          "rank": RANK, "hidden": HIDDEN, "payload_bytes": len(blob),
          "setup_s": setup_s, "request_entries": REQUEST,
          "request_ms_fused": req_ms[:8], "request_ms_cuda_unfused": req_ms[8:],
          "to_dense_entries": n, "to_dense_s": dense_s,
          "to_dense_entries_per_s": n / dense_s,
          "plain_to_dense_s": plain_dense_s,
          "max_abs_err_requests": req_err, "max_abs_err_to_dense": dense_err,
          "launches": launches})
    return enc, requests[0], launches


def phase_wide(torch, device):
    """The wide payloads the reference's budget rule makes, decoded on the
    card through the default impl ("auto"): at (hidden 68, rank 34), the
    1 MB rule's pick for PEMS-SF and Uber, the fused decode runs its simt
    body.  A PEMS-SF-shaped payload goes through ``save_bytes`` and
    ``load_bytes`` and answers ``WIDE_REQUESTS`` ``decode_at`` requests; an
    Uber-shaped one is reconstructed whole with ``to_dense``.  Both are held
    against the plain route on the card (rtol = atol = 1e-5), and every
    fused launch of this phase must have been the simt body's.  The
    PEMS-SF payload answers ``WIDE_REQUESTS`` more requests through the
    unfused route (``kernel_impl="cuda"``), each one ``lstm_scan`` launch on
    its simt body and one ``tt_contract`` launch, held to the plain route
    likewise.  Returns the launches of the two simt bodies."""
    import numpy as np

    from repro_torch.codecs import container, load_bytes
    from repro_torch.codecs.adapters import NTTDEncoded
    from repro_torch.core import nttd
    from repro_torch.core.codec import CompressedTensor
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops

    require(_decode_tile.decode_body(WIDE_HIDDEN, WIDE_RANK) == "simt",
            "the wide architecture does not take the simt decode body")
    require(_lstm.lstm_body(WIDE_HIDDEN) == "simt",
            "the wide architecture does not take the simt lstm_scan body")
    rng = np.random.default_rng(SEED)
    cfg = nttd.NTTDConfig(rank=WIDE_RANK, hidden=WIDE_HIDDEN)
    require(cfg.kernel_impl == "auto", f"the default impl is {cfg.kernel_impl!r}")
    payloads = {}
    for name, shape in (("pems", PEMS_SHAPE), ("uber", UBER_SHAPE)):
        spec = make_folding_spec(shape)
        params = nttd.init_params(torch.Generator().manual_seed(SEED), spec, cfg, device)
        pi = [rng.permutation(n) for n in shape]
        ct = CompressedTensor(params, pi, spec, cfg, norm_mean=0.25, norm_std=2.0)
        payloads[name] = (spec, NTTDEncoded(ct))
    blob = container.save_bytes(payloads["pems"][1])
    enc = load_bytes(blob)  # default device: the card
    require(enc.ct.device.type == "cuda", "load_bytes did not load onto the card")
    uber = payloads["uber"][1]
    requests = [np.stack([rng.integers(0, n, REQUEST) for n in PEMS_SHAPE], axis=1)
                for _ in range(2 * WIDE_REQUESTS)]
    enc_cuda = _with_impl(enc, "cuda", NTTDEncoded)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    answers, req_ms = [], []
    for i, idx in enumerate(requests):
        t = time.perf_counter()
        answers.append((enc if i < WIDE_REQUESTS else enc_cuda).decode_at(idx))
        req_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dense = uber.to_dense()
    dense_s = time.perf_counter() - t
    launches, simt = ops.launch_counts(), _decode_tile.simt_launches
    lstm_simt = _lstm.simt_launches
    n_uber = int(np.prod(UBER_SHAPE))
    batches = -(-n_uber // DENSE_BATCH)
    require(simt == launches["decode_tile"] == WIDE_REQUESTS + batches,
            f"the wide phase launched decode_tile {launches['decode_tile']} times, "
            f"{simt} of them the simt body; expected {WIDE_REQUESTS + batches}")
    require(lstm_simt == launches["lstm_scan"] == launches["tt_contract"] == WIDE_REQUESTS,
            f"the wide phase's unfused requests launched lstm_scan {launches['lstm_scan']} "
            f"times, {lstm_simt} of them the simt body, and tt_contract "
            f"{launches['tt_contract']} times; expected {WIDE_REQUESTS} each")

    req_err = 0.0
    plain = _with_impl(enc, "ref", NTTDEncoded)
    for idx, got in zip(requests, answers):
        require(got.shape == (REQUEST,) and bool(np.isfinite(got).all()), "wide request output")
        want = plain.decode_at(idx)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        req_err = max(req_err, float(np.abs(got - want).max()))
    t = time.perf_counter()
    dense_plain = _with_impl(uber, "ref", NTTDEncoded).to_dense()
    plain_dense_s = time.perf_counter() - t
    require(dense.shape == UBER_SHAPE and bool(np.isfinite(dense).all()), "wide to_dense output")
    np.testing.assert_allclose(dense, dense_plain, rtol=1e-5, atol=1e-5)
    dense_err = float(np.abs(dense - dense_plain).max())
    emit({"phase": "wide", "rank": WIDE_RANK, "hidden": WIDE_HIDDEN, "impl": cfg.kernel_impl,
          "body": _decode_tile.decode_body(WIDE_HIDDEN, WIDE_RANK),
          **simt_tile(WIDE_HIDDEN, WIDE_RANK),
          "lstm_body": _lstm.lstm_body(WIDE_HIDDEN), "lstm_tile": _lstm.simt_tile(WIDE_HIDDEN),
          "pems_shape": list(PEMS_SHAPE), "pems_folded": list(payloads["pems"][0].folded_shape),
          "payload_bytes": len(blob), "request_entries": REQUEST,
          "request_ms": req_ms[:WIDE_REQUESTS], "request_ms_cuda_unfused": req_ms[WIDE_REQUESTS:],
          "uber_shape": list(UBER_SHAPE), "uber_folded": list(payloads["uber"][0].folded_shape),
          "to_dense_entries": n_uber, "to_dense_s": dense_s,
          "to_dense_entries_per_s": n_uber / dense_s, "plain_to_dense_s": plain_dense_s,
          "max_abs_err_requests": req_err, "max_abs_err_to_dense": dense_err,
          "max_abs_value_to_dense": float(np.abs(dense_plain).max()),
          "launches": launches, "simt_launches": simt, "lstm_simt_launches": lstm_simt})
    return simt, lstm_simt


class RouteLog:
    """The MoE routers' expert ids inside ``serve.main``, by request:
    ``calls[uid][c]`` is call c of request uid (0 its prefill, j + 1 its
    decode step j), a list of ids [1, S, k] by MoE sublayer, kept on the
    device.  Requests are numbered in prefill order (the engine's queue:
    uid order); a decode step is the request last prefilled into its
    cache.  ``recording`` keeps the ids one run's routers pick;
    ``replaying`` makes another run's routers take them, with gate values
    from that run's own probabilities."""

    def __init__(self):
        self.calls: dict = {}
        self.recorded = self.replayed = 0

    @contextlib.contextmanager
    def _patched(self, routed):
        """``moe.route`` replaced by ``routed(route, p, x, cfg, uid, call,
        sublayer)`` for the duration."""
        from repro_torch.models import model, moe

        route, prefill, decode = moe.route, model.prefill, model.decode_step
        uid_of, calls_made, where = {}, {}, {}

        def tracked(fn, first):
            def call(*args, cache=None, **kwargs):
                if first:
                    uid_of[id(cache)] = len(calls_made)
                    calls_made[len(calls_made)] = 0
                uid = uid_of[id(cache)]
                where.update(uid=uid, call=calls_made[uid], sub=0)
                calls_made[uid] += 1
                try:
                    return fn(*args, cache=cache, **kwargs)
                finally:
                    where.clear()
            return call

        def hooked(p, x, cfg):
            require(bool(where), "an MoE router ran outside the engine's prefill and decode")
            out = routed(route, p, x, cfg, where["uid"], where["call"], where["sub"])
            where["sub"] += 1
            return out

        moe.route, model.prefill = hooked, tracked(prefill, True)
        model.decode_step = tracked(decode, False)
        try:
            yield self
        finally:
            moe.route, model.prefill, model.decode_step = route, prefill, decode

    def recording(self):
        def record(route, p, x, cfg, uid, call, sub):
            probs, gate_vals, gate_idx = route(p, x, cfg)
            self.calls.setdefault(uid, {}).setdefault(call, []).append(gate_idx)
            self.recorded += 1
            return probs, gate_vals, gate_idx
        return self._patched(record)

    def replaying(self):
        def replay(route, p, x, cfg, uid, call, sub):
            probs, _, _ = route(p, x, cfg)
            ids = self.calls.get(uid, {}).get(call, [])
            require(sub < len(ids) and ids[sub].shape == probs.shape[:-1] + (cfg.moe_top_k,),
                    f"request {uid} call {call}: no recorded experts for MoE sublayer {sub}")
            vals = probs.gather(-1, ids[sub])
            self.replayed += 1
            return probs, vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), ids[sub]
        return self._patched(replay)


def serve_route(torch, argv, route: str, hook=None) -> tuple:
    """``serve.main(argv)`` once on ``route`` ("kernel": the flash kernel,
    "plain": ``--attn-impl ref``), inside the context manager ``hook``
    where given: (results by uid, seconds, launches, peak bytes)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with hook or contextlib.nullcontext():
        results = serve.main(argv + (["--attn-impl", "ref"] if route == "plain" else []))
    torch.cuda.synchronize()
    out = (sorted(results, key=lambda r: r.uid), time.perf_counter() - t0,
           launch_counts_by_body(), torch.cuda.max_memory_allocated())
    del results
    gc.collect()
    torch.cuda.empty_cache()
    return out


def launch_counts_by_body() -> dict:
    """``ops.launch_counts()`` and, as ``flash_attention_f32``, the launches
    of the flash kernel's tf32x3 body alone (the f32 calls)."""
    from repro_torch.kernels import attention as _attention
    from repro_torch.kernels import ops

    return {**ops.launch_counts(), "flash_attention_f32": _attention.tf32x3_launches}


def serve_routes(torch, argv, routes=("kernel", "plain")) -> dict:
    """{route: ``serve_route``'s tuple} for each of ``routes``."""
    return {route: serve_route(torch, argv, route) for route in routes}


def route_agreement(torch, got, want, vocab: int, new_tokens: int, rel_tol: float) -> dict:
    """The kernel route's results against the plain route's: prefill logits
    within ``rel_tol`` of max|logit|, and greedy tokens equal wherever the
    plain run's margin exceeds twice the largest logit difference (after
    the first allowed divergence the two runs continue from different
    prefixes and are not compared further)."""
    diff = rel = 0.0
    for a, b in zip(got, want):
        require(len(a.tokens) == new_tokens and a.prefill_logits.shape == (vocab,)
                and bool(torch.isfinite(a.prefill_logits).all()), f"request {a.uid} output")
        d = float((a.prefill_logits - b.prefill_logits).abs().max())
        diff = max(diff, d)
        rel = max(rel, d / float(b.prefill_logits.abs().max()))
    require(rel <= rel_tol,
            f"prefill logits differ by {rel} of max|logit| (limit {rel_tol})")
    agree = compared = 0
    for a, b in zip(got, want):
        for ta, tb, margin in zip(a.tokens, b.tokens, b.margins):
            if ta != tb:
                require(margin <= 2 * diff,
                        f"request {a.uid}: tokens {ta} != {tb} at margin {margin}")
                break
            agree += 1
        compared += len(a.tokens)
    return {"prefill_logits_max_abs_diff": diff, "prefill_logits_rel_diff": rel,
            "logit_rel_tol": rel_tol, "greedy_tokens_agree": agree, "greedy_tokens": compared}


def serve_timings(results, lens, prefix: str = "") -> dict:
    decode = [ms for r in results for ms in r.decode_ms]
    return {f"{prefix}prefill_len_ms": [[lens[r.uid], r.prefill_ms] for r in results],
            f"{prefix}decode_ms_per_token": sum(decode) / len(decode)}


def weight_bytes_of(cfg) -> int:
    """Bytes of the launcher's weights (held in the compute dtype)."""
    from repro_torch.dist.sharding import leaves
    from repro_torch.models import model

    weights = model.abstract_params(dataclasses.replace(cfg, param_dtype=cfg.compute_dtype))
    return sum(t.numel() * t.element_size() for t in leaves(weights))


def phase_serve(torch, device):
    """The LM serving path at qwen1.5-4b's full width, through the flash
    kernel, held against the same requests served through the oracle."""
    import numpy as np

    from repro_torch import configs

    rng = np.random.default_rng(SEED)
    lens = [128, 2048] + [int(n) for n in rng.integers(1, 2048, size=SERVE_REQUESTS - 2)]
    rng.shuffle(lens)
    require(any(n % 128 for n in lens), "no prompt length off the 128 tile")
    argv = ["--arch", SERVE_ARCH, "--requests", str(SERVE_REQUESTS),
            "--slots", str(SERVE_SLOTS), "--prompt-len", ",".join(map(str, lens)),
            "--max-new", str(SERVE_NEW), "--max-len", str(SERVE_MAX_LEN), "--keep-logits"]
    cfg = configs.get(SERVE_ARCH)
    runs = serve_routes(torch, argv)
    (got, wall, launches, peak), (want, plain_wall, plain_launches, _) = (
        runs["kernel"], runs["plain"])
    require(launches["flash_attention"] == cfg.n_layers * SERVE_REQUESTS,
            f"flash_attention launched {launches['flash_attention']} times, expected "
            f"{cfg.n_layers} per prefill x {SERVE_REQUESTS}")
    require(plain_launches["flash_attention"] == 0, "the oracle route launched the kernel")
    agreement = route_agreement(torch, got, want, cfg.vocab, SERVE_NEW, LOGIT_REL_TOL)
    n_new = sum(len(r.tokens) for r in got)
    emit({"phase": "serve", "arch": SERVE_ARCH, "dtype": cfg.compute_dtype,
          "requests": SERVE_REQUESTS, "slots": SERVE_SLOTS, "new_tokens": SERVE_NEW,
          "max_len": SERVE_MAX_LEN, "prompt_lens": lens, "weight_bytes": weight_bytes_of(cfg),
          "peak_bytes": peak, "seconds": wall, "plain_seconds": plain_wall,
          **serve_timings(got, lens), **serve_timings(want, lens, "plain_"),
          "tokens_per_s": n_new / wall, "launches": launches, **agreement,
          "tokens_uid0": got[0].tokens, "plain_tokens_uid0": want[0].tokens})
    return launches


def family_serve(torch, arch: str, lens, requests: int, slots: int, new_tokens: int,
                 max_len: int, routes=("kernel", "plain"), smoke: bool = False) -> dict:
    """One family model through the launcher on ``routes``; the flash
    launches must be the config's attention sublayers x requests on the
    kernel route and 0 on the plain one.  An MoE model's plain route
    replays the experts of a second, recorded kernel-route run, and that
    run is the one compared; the first kernel-route run is unhooked and
    gives the times.  Returns the runs and the figures the phase lines
    print."""
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    argv = ["--arch", arch, "--requests", str(requests), "--slots", str(slots),
            "--prompt-len", ",".join(map(str, lens)), "--max-new", str(new_tokens),
            "--max-len", str(max_len), "--keep-logits"] + (["--smoke"] if smoke else [])
    replay = bool(cfg.moe_experts) and "plain" in routes
    runs = serve_routes(torch, argv, [r for r in routes if not (replay and r == "plain")])
    checked = dict(runs)
    if replay:
        log = RouteLog()
        checked["kernel, recorded"] = serve_route(torch, argv, "kernel", log.recording())
        runs["plain"] = checked["plain"] = serve_route(torch, argv, "plain", log.replaying())
        require(log.replayed == log.recorded > 0,
                f"{arch}: {log.replayed} of {log.recorded} recorded routings replayed")
    attn = cfg.n_blocks * transformer._counts(cfg)["attn"]
    for route, (results, _, launches, _) in checked.items():
        want = 0 if route == "plain" else attn * requests
        require(launches["flash_attention"] == want,
                f"{arch} {route}: flash_attention launched {launches['flash_attention']} "
                f"times, expected {want} ({attn} attention sublayers x {requests} prefills)")
        for r in results:
            require(len(r.tokens) == new_tokens and all(0 <= t < cfg.vocab for t in r.tokens)
                    and bool(torch.isfinite(r.prefill_logits).all()),
                    f"{arch} {route}: request {r.uid} output")
    results, wall, launches, peak = runs[routes[0]]
    line = {"arch": arch, "dtype": cfg.compute_dtype, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "requests": requests, "slots": slots,
            "new_tokens": new_tokens, "max_len": max_len,
            "prompt_lens": [lens[i % len(lens)] for i in range(requests)],
            "weight_bytes": weight_bytes_of(cfg), "peak_bytes": peak, "seconds": wall,
            **serve_timings(results, [lens[i % len(lens)] for i in range(requests)]),
            "flash_launches": launches["flash_attention"],
            "flash_launches_per_prefill": attn}
    if "plain" in runs and "kernel" in runs:
        plain, plain_wall, _, plain_peak = runs["plain"]
        compared = checked["kernel, recorded" if replay else "kernel"][0]
        line.update({"plain_seconds": plain_wall, "plain_peak_bytes": plain_peak,
                     **serve_timings(plain, line["prompt_lens"], "plain_"),
                     "plain_replays_kernel_experts": replay,
                     **route_agreement(torch, compared, plain, cfg.vocab, new_tokens,
                                       FAMILY_LOGIT_REL_TOL if not smoke else HYBRID_TOL)})
    return {"runs": runs, "line": line, "cfg": cfg}


def teacher_forcing_rel(torch, cfg, params, prompt_len: int, decode_steps: int) -> float:
    """Prefill of ``prompt_len`` seeded tokens then ``decode_steps`` decode
    steps against ``forward`` on the whole sequence: the largest logit
    difference over max|logit| of the forward."""
    from repro_torch.models import model

    device = params["tok"]["embed"].device
    gen = torch.Generator().manual_seed(SEED + prompt_len)
    toks = torch.randint(0, cfg.vocab, (1, prompt_len + decode_steps), generator=gen)
    toks = toks.to(device)
    with torch.no_grad():
        want, _ = model.forward(params, cfg, tokens=toks)
        want = want[0, :, : cfg.vocab].float()
        cache = model.init_cache(cfg, 1, prompt_len + decode_steps + 1, device=device)
        got, cache = model.prefill(params, cfg, tokens=toks[:, :prompt_len], cache=cache)
        rows = [got[0, -1]]
        for step in range(decode_steps):
            pos = prompt_len + step
            got, cache = model.decode_step(params, cfg, token=toks[:, pos:pos + 1],
                                           cache=cache, cache_len=pos)
            rows.append(got[0, -1])
    got = torch.stack(rows)[:, : cfg.vocab].float()
    ref = want[prompt_len - 1:]
    require(bool(torch.isfinite(got).all()), f"{cfg.arch_id}: non-finite decode logits")
    return float((got - ref).abs().max() / ref.abs().max())


def phase_families_ssm(torch, device) -> dict:
    """mamba2-1.3b at full width and depth through the launcher, then the
    f32 decode against teacher forcing (ROADMAP C.8's short prompt too)."""
    from repro_torch import configs
    from repro_torch.models import model

    serve = family_serve(torch, SSM_ARCH, SSM_LENS, len(SSM_LENS), FAMILY_SLOTS,
                         FAMILY_NEW, max(SSM_LENS) + FAMILY_NEW + 1, routes=("kernel",))
    cfg = dataclasses.replace(configs.get(SSM_ARCH), param_dtype="float32",
                              compute_dtype="float32")
    params = model.init_params(cfg, SEED, device)
    rel = {str(n): teacher_forcing_rel(torch, cfg, params, n, 1) for n in SSM_TF_LENS}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for n, r in rel.items():
        require(r <= SSM_TF_TOL, f"{SSM_ARCH} f32: prefill {n} + decode differs from "
                                 f"teacher forcing by {r} of max|logit| (limit {SSM_TF_TOL})")
    emit({"phase": "families.ssm", **serve["line"], "reduced": [],
          "teacher_forcing_dtype": "float32", "teacher_forcing_rel": rel,
          "teacher_forcing_tol": SSM_TF_TOL})
    return serve["runs"]["kernel"][2]


def phase_families_moe(torch, device) -> dict:
    """grok-1 and llama4-maverick at full width, depth cut, in bf16 through
    the launcher on both routes."""
    from repro_torch import configs

    launches = {}
    for arch, layers in MOE_CUTS.items():
        full = configs.get(arch)
        with depth_cut(configs, layers):
            serve = family_serve(torch, arch, FAMILY_LENS, FAMILY_REQUESTS, FAMILY_SLOTS,
                                 FAMILY_NEW, FAMILY_MAX_LEN)
        emit({"phase": "families.moe", **serve["line"], "experts": full.moe_experts,
              "top_k": full.moe_top_k, "reduced": [f"n_layers {full.n_layers} -> {layers}"]})
        for name, n in serve["runs"]["kernel"][2].items():
            launches[name] = launches.get(name, 0) + n
    return launches


def phase_families_hybrid(torch, device) -> dict:
    """jamba's smoke config on the card in f32: both routes within
    ``HYBRID_TOL``, and prefill then decode against teacher forcing."""
    from repro_torch import configs
    from repro_torch.kernels import attention as _attention
    from repro_torch.models import model

    serve = family_serve(torch, HYBRID_ARCH, HYBRID_LENS, len(HYBRID_LENS), FAMILY_SLOTS,
                         FAMILY_NEW, max(HYBRID_LENS) + FAMILY_NEW + 1, smoke=True)
    launches = serve["runs"]["kernel"][2]
    require(launches["flash_attention_f32"] == launches["flash_attention"] > 0,
            f"{HYBRID_ARCH} smoke in f32: {launches['flash_attention_f32']} of "
            f"{launches['flash_attention']} flash launches on the tf32x3 body")
    cfg = configs.get_smoke(HYBRID_ARCH)
    # teacher forcing equals prefill + decode only where no capacity drop
    # differs between them: at factor E / k every expert can take every token
    cfg = dataclasses.replace(cfg, attn_impl="auto",
                              moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    params = model.init_params(cfg, SEED, device)
    rel = {str(n): teacher_forcing_rel(torch, cfg, params, n, 2) for n in HYBRID_LENS}
    for n, r in rel.items():
        require(r <= HYBRID_TF_TOL, f"{HYBRID_ARCH} smoke: prefill {n} + decode differs "
                                    f"from teacher forcing by {r} (limit {HYBRID_TF_TOL})")
    emit({"phase": "families.hybrid", **serve["line"], "config": "smoke",
          "flash_body": _attention.flash_body(torch.float32, cfg.resolved_head_dim),
          "flash_launches_tf32x3": launches["flash_attention_f32"],
          "teacher_forcing_rel": rel, "teacher_forcing_tol": HYBRID_TF_TOL,
          "teacher_forcing_capacity_factor": cfg.moe_capacity_factor,
          "reduced": ["the smoke config: one 8-sublayer block at full width is 44.2 B "
                      "parameters, 88 GB in bf16, more than one 80 GB card"]})
    return serve["runs"]["kernel"][2]


def phase_families_embeds(torch, device) -> dict:
    """musicgen-medium at full width and depth and internvl2-76b at full
    width, depth cut, through the launcher on both routes, then prefill and
    decode from ``embeds`` through ``train.step``'s factories."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.train import step

    launches = {}
    for arch, layers in EMBED_CUTS.items():
        full = configs.get(arch)
        with depth_cut(configs, layers or full.n_layers):
            serve = family_serve(torch, arch, FAMILY_LENS, FAMILY_REQUESTS, FAMILY_SLOTS,
                                 FAMILY_NEW, FAMILY_MAX_LEN)
            cfg = dataclasses.replace(configs.get(arch), attn_impl="auto",
                                      param_dtype=full.compute_dtype)
        for name, n in serve["runs"]["kernel"][2].items():
            launches[name] = launches.get(name, 0) + n
        # embeds in, through the step factories, on both routes
        params = model.init_params(cfg, SEED, device)
        gen = torch.Generator().manual_seed(SEED)
        emb = torch.randn((1, EMBED_PROMPT + EMBED_DECODE, cfg.d_model), generator=gen)
        emb = emb.to(device, torch.bfloat16)
        outs = {}
        for route, impl in (("kernel", "auto"), ("plain", "ref")):
            rcfg = dataclasses.replace(cfg, attn_impl=impl)
            prefill, decode = step.make_prefill_step(rcfg), step.make_decode_step(rcfg)
            cache = model.init_cache(rcfg, 1, EMBED_PROMPT + EMBED_DECODE, device=device)
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, cache, {"embeds": emb[:, :EMBED_PROMPT]})
            rows = [logits[0, -1]]
            for i in range(EMBED_DECODE - 1):
                pos = EMBED_PROMPT + i
                logits, cache = decode(params, cache, {"embeds": emb[:, pos:pos + 1]}, pos)
                rows.append(logits[0, -1])
            rows = torch.stack(rows)[:, : cfg.vocab].float()
            torch.cuda.synchronize()
            outs[route] = (rows, time.perf_counter() - t0, ops.launch_counts())
            del cache
        (got, step_s, got_launches), (want, plain_step_s, plain_launches) = (
            outs["kernel"], outs["plain"])
        require(got_launches["flash_attention"] == cfg.n_layers
                and plain_launches["flash_attention"] == 0,
                f"{arch} embeds: flash launched {got_launches['flash_attention']} / "
                f"{plain_launches['flash_attention']} times, expected {cfg.n_layers} / 0")
        require(bool(torch.isfinite(got).all()), f"{arch} embeds: non-finite logits")
        rel = float((got - want).abs().max() / want.abs().max())
        require(rel <= FAMILY_LOGIT_REL_TOL,
                f"{arch} embeds: routes differ by {rel} of max|logit| "
                f"(limit {FAMILY_LOGIT_REL_TOL})")
        launches["flash_attention"] += got_launches["flash_attention"]
        del params, outs, got, want
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": "families.embeds", **serve["line"],
              "reduced": [f"n_layers {full.n_layers} -> {layers}"] if layers else [],
              "embeds_prompt": EMBED_PROMPT, "embeds_decode_steps": EMBED_DECODE - 1,
              "embeds_seconds": step_s, "embeds_plain_seconds": plain_step_s,
              "embeds_flash_launches": got_launches["flash_attention"],
              "embeds_logits_rel_diff": rel})
    return launches


def phase_families(torch, device) -> dict:
    """The MoE, Mamba2 and hybrid layouts and the embedding configs: the
    kernel launches of the phases' measured (kernel-route) runs."""
    total: dict = {}
    for fn in (phase_families_ssm, phase_families_moe, phase_families_hybrid,
               phase_families_embeds):
        t0 = time.perf_counter()
        for name, n in fn(torch, device).items():
            total[name] = total.get(name, 0) + n
        gc.collect()
        torch.cuda.empty_cache()
        emit({"phase": f"{fn.__name__[6:].replace('_', '.', 1)}.done",
              "seconds": time.perf_counter() - t0})
    return total


def _leaves(tree) -> list:
    """The leaves of nested dicts, tuples and NamedTuples, in checkpoint order."""
    from repro_torch.train.checkpoint import _flatten

    return [leaf for _, leaf in _flatten(tree)]


def _tree_equal(torch, a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _eval_loss(torch, cfg, params, batch) -> float:
    """The training step's loss (bf16 compute copy of the masters)."""
    from repro_torch.models import layers, model
    from repro_torch.optim.optimizers import tree_map

    dt = layers.dtype_of(cfg.compute_dtype)
    with torch.no_grad():
        return float(model.loss_fn(tree_map(lambda w: w.to(dt), params), cfg, batch)[0])


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def inplace_adam_bitwise(torch, device) -> bool:
    """The in-place Adam update against the out-of-place one on the card:
    3 steps of ``adamw(wsd)`` with clipping and weight decay, over leaves of
    several sizes in groups of a few leaves."""
    from repro_torch.optim import optimizers, schedules

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = {"a": torch.randn((1000, 37), generator=gen, device=device),
              "b": {"c": torch.randn((4096,), generator=gen, device=device),
                    "d": torch.randn((3, 5, 7), generator=gen, device=device)},
              "e": torch.randn((1 << 16,), generator=gen, device=device)}
    opt = optimizers.adamw(schedules.wsd(1e-2, 10, warmup=1), weight_decay=0.1,
                           max_grad_norm=1.0)
    saved, optimizers.GROUP_ELEMENTS = optimizers.GROUP_ELEMENTS, 40_000
    try:
        p1 = optimizers.tree_map(torch.clone, params)
        p2 = optimizers.tree_map(torch.clone, params)
        s1, s2 = opt.init(p1), opt.init(p2)
        for _ in range(3):
            grads = optimizers.tree_map(lambda x: 3 * torch.randn(x.shape, generator=gen,
                                                                  device=device), params)
            upd, s1 = opt.update(grads, s1, p1)
            p1 = optimizers.apply_updates(p1, upd)
            s2 = opt.apply_(optimizers.tree_map(torch.clone, grads), s2, p2)
    finally:
        optimizers.GROUP_ELEMENTS = saved
    return _tree_equal(torch, (p1, s1.mu, s1.nu), (p2, s2.mu, s2.nu))


def phase_train(torch, device, smi):
    """minicpm-2b at full width and depth through the launcher on the card."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import model

    cfg = configs.get(TRAIN_ARCH)
    args = train.parse_args(["--arch", TRAIN_ARCH])
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR),
            "--log-every", "1"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    run = train.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    card = torch.cuda.get_device_properties(device).total_memory
    losses = run.losses
    require(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
            f"losses {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    require(not any(launches.values()),
            f"training launched {launches}; its attention is the oracle")
    require(peak < card, f"peak memory {peak} above the card's {card}")
    # the step moved the parameters: the norms left 1, the embedding its init
    init = sharding.materialize(0, {"tok": model.param_specs(cfg)["tok"]}, torch.float32,
                                device)["tok"]["embed"]
    moved = {"tok/embed": float((run.params["tok"]["embed"] - init).abs().max()),
             "final_norm": float((run.params["final_norm"] - 1).abs().max()),
             "blocks/mixer_norm": float((run.params["blocks"]["mixer_norm"] - 1).abs().max())}
    del init
    require(moved["tok/embed"] > 0 and moved["final_norm"] > 0
            and moved["blocks/mixer_norm"] > 0, f"parameters did not move: {moved}")
    bitwise = inplace_adam_bitwise(torch, device)
    require(bitwise, "the in-place Adam update differs from the out-of-place one")
    n = model.param_count(cfg)
    tokens = args.batch * args.seq
    step_s = float(np.median(run.step_seconds[1:]))
    bound_ms = 6 * n * tokens / PEAK_BF16 * 1e3
    emit({"phase": "train", "arch": TRAIN_ARCH, "argv": argv, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "remat": cfg.remat,
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
          "params": n, "batch": args.batch, "seq": args.seq, "schedule": args.schedule,
          "lr": TRAIN_LR, "lr_default": args.lr,
          "losses": losses, "step_ms": [t * 1e3 for t in run.step_seconds],
          "step_ms_median_after_first": step_s * 1e3, "tokens_per_s": tokens / step_s,
          "seconds": wall, "peak_bytes": peak, "card_bytes": card,
          "peak_share_of_card": peak / card, "moved": moved,
          "bound_ms_6nt_bf16": bound_ms, "bound_share": bound_ms / (step_s * 1e3),
          "bound_note": "6*N*tokens over 989 TFLOP/s; for information, no gain",
          "launches": launches, "inplace_adam_bitwise": bitwise, "name_power_limit": smi})
    del run
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def depth_cut(configs, n_layers: int):
    """The launcher's config, which it reads through ``configs.get``, cut to
    ``n_layers`` (every width kept)."""
    get = configs.get
    configs.get = lambda arch: dataclasses.replace(get(arch), n_layers=n_layers)
    try:
        yield
    finally:
        configs.get = get


def phase_train_resume(torch, device, workdir):
    """Resume at full width, depth cut: 6 steps against 4 (a SIGTERM ends
    them, the checkpoint at step 4 stays) + a resumed run to step 6.
    Returns (the resumed run's params, the step-4 checkpoint's params)."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.train import checkpoint as ckpt_lib

    argv = ["--arch", TRAIN_ARCH, "--steps", str(RESUME_STEPS), "--log-every", "1"]
    d = os.path.join(workdir, "train_ckpt")
    free = shutil.disk_usage(workdir).free
    with depth_cut(configs, RESUME_LAYERS):
        full = train.run(argv)
    real = train.SyntheticSource.batch_at

    def batch_at(self, step):
        if step == RESUME_STOP - 1:  # the 4th step finishes, then the run stops
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, step)

    train.SyntheticSource.batch_at = batch_at
    try:
        with depth_cut(configs, RESUME_LAYERS):
            first = train.run(argv + ["--ckpt-dir", d, "--ckpt-every", str(RESUME_EVERY)])
    finally:
        train.SyntheticSource.batch_at = real
    ck = ckpt_lib.Checkpointer(d)
    require(first.stopped and first.last_step == RESUME_STOP
            and len(first.losses) == RESUME_STOP and ck.latest_step() == RESUME_STOP,
            f"SIGTERM run: stopped {first.stopped} at {first.last_step}, checkpoints "
            f"{ck.all_steps()}")
    ckpt_bytes = _dir_bytes(os.path.join(d, f"step_{RESUME_STOP:010d}"))
    t0 = time.perf_counter()
    state4, _ = ck.restore(RESUME_STOP, {"params": first.params, "opt": first.opt_state})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require(_tree_equal(torch, state4, {"params": first.params, "opt": first.opt_state}),
            "the step-4 checkpoint does not restore bitwise")
    params4 = state4["params"]
    first_losses = first.losses
    del first, state4
    with depth_cut(configs, RESUME_LAYERS):
        rest = train.run(argv + ["--ckpt-dir", d, "--resume", "auto"])
    require(rest.start_step == RESUME_STOP and len(rest.losses) == RESUME_STEPS - RESUME_STOP,
            f"resumed at {rest.start_step} for {len(rest.losses)} steps")
    losses = first_losses + rest.losses
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, full.losses))
    require(rel <= RESUME_TOL, f"resumed losses {losses} vs {full.losses}: rel {rel}")
    param_diff = max(float((a - b).abs().max()) for a, b in zip(
        _leaves(rest.params), _leaves(full.params)))
    steps_saved = ck.all_steps()
    full_losses = full.losses
    del full
    shutil.rmtree(d)
    timed = os.path.join(workdir, "train_ckpt_timed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt_lib.Checkpointer(timed, async_save=False).save(
        RESUME_STEPS, {"params": rest.params, "opt": rest.opt_state})
    save_s = time.perf_counter() - t0
    save_bytes = _dir_bytes(timed)
    shutil.rmtree(timed)
    emit({"phase": "train.resume", "arch": TRAIN_ARCH, "argv": argv,
          "reduced": [f"n_layers 40 -> {RESUME_LAYERS} (every width kept)"],
          "steps": RESUME_STEPS, "sigterm_after_steps": RESUME_STOP,
          "ckpt_every": RESUME_EVERY, "checkpoints": steps_saved,
          "losses_uninterrupted": full_losses, "losses_resumed": losses,
          "max_rel_loss_diff": rel, "tol": RESUME_TOL,
          "max_abs_param_diff": param_diff, "checkpoint_bytes": ckpt_bytes,
          "restore_seconds": restore_s, "save_seconds_sync": save_s,
          "save_bytes": save_bytes, "disk_free_bytes": free})
    return rest.params, params4


def _subtree(params, key: str) -> dict:
    """``{"a": {"b": leaf}}`` for the key ``a/b`` of ``params``."""
    node = params
    for part in key.split("/"):
        node = node[part]
    for part in reversed(key.split("/")):
        node = {part: node}
    return node


def phase_train_codec(torch, device, params, params4, workdir):
    """NTTD-compressed checkpoints of the resumed run's params on the card."""
    import numpy as np

    from repro_torch import codecs, configs
    from repro_torch.codecs.adapters import NTTDEncoded
    from repro_torch.compress import checkpoint_codec as cc
    from repro_torch.data.pipeline import PipelineConfig, SyntheticSource
    from repro_torch.kernels import ops, ref
    from repro_torch.temporal import VersionedStore
    from repro_torch.train.checkpoint import _flatten

    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    ccfg = cc.CodecCheckpointConfig()
    skip, mlp = CODEC_SKIP.split("/")
    tree = {**params, skip: {k: v for k, v in params[skip].items() if k != mlp}}
    with plain_calls_counted(ref) as plain:
        torch.cuda.synchronize()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        payload, stats = cc.compress_tree(tree, ccfg)
        compress_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = cc.decompress_tree(payload, tree)
        torch.cuda.synchronize()
        decompress_s = time.perf_counter() - t0
        gated = _subtree(params, CODEC_GATED_LEAF)
        t0 = time.perf_counter()
        gpayload, gstats = cc.compress_tree(
            gated, dataclasses.replace(ccfg, min_fitness=VERSIONED_GATE))
        gcompress_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        grestored = cc.decompress_tree(gpayload, gated)
        torch.cuda.synchronize()
        gdecompress_s = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    require(sum(plain.values()) == 0, f"plain versions ran in compress/decompress: {plain}")
    for name in ("lstm_scan", "lstm_scan_bwd", "tt_contract", "tt_contract_bwd", "decode_tile"):
        require(launches[name] > 0, f"{name} was not launched by compress_tree: {launches}")
    require(launches["flash_attention"] == 0, "compress_tree launched flash_attention")
    got, want = dict(_flatten(restored)), dict(_flatten(tree))
    for key, item in payload.items():
        require(got[key].device == want[key].device, f"{key} restored off its device")
        if item["kind"] == "raw":
            require(torch.equal(got[key], want[key]), f"raw leaf {key} not restored bitwise")
    # the codec leaf: on its template's device and dtype, and equal to the
    # plain route's decode of the same payload
    gitem = gpayload[CODEC_GATED_LEAF]
    require(gitem["kind"] == ccfg.codec, f"{CODEC_GATED_LEAF} at gate {VERSIONED_GATE} "
            f"stayed {gitem['kind']}")
    gleaf, gwant = dict(_flatten(grestored))[CODEC_GATED_LEAF], dict(_flatten(gated))[
        CODEC_GATED_LEAF]
    require(gleaf.device == gwant.device and gleaf.dtype == gwant.dtype
            and gleaf.shape == gwant.shape and bool(torch.isfinite(gleaf).all()),
            f"{CODEC_GATED_LEAF} restored as {gleaf.dtype} {tuple(gleaf.shape)} on "
            f"{gleaf.device}")
    gplain = torch.from_numpy(_with_impl(codecs.load_bytes(gitem["data"], device=device),
                                         "ref", NTTDEncoded).to_dense()).to(device)
    gerr = float((gleaf - gplain).abs().max())
    require(torch.allclose(gleaf, gplain, rtol=TOL["float32"], atol=TOL["float32"]),
            f"{CODEC_GATED_LEAF}: decompress_tree and the plain decode differ by {gerr}")
    del gplain
    src = SyntheticSource(PipelineConfig(batch_size=8, seq_len=128, vocab=cfg.vocab, seed=0))
    batch = {k: torch.from_numpy(v).to(device) for k, v in src.batch_at(RESUME_STEPS).items()}
    # the restored tree, with the MLP left out of compress_tree and the
    # codec leaf in place of its raw copy
    gattn, gname = CODEC_GATED_LEAF.split("/")[1:]
    full_restored = {**restored, skip: {**restored[skip], mlp: params[skip][mlp],
                                        gattn: {**restored[skip][gattn], gname: gleaf}}}
    loss_before, loss_after = (_eval_loss(torch, cfg, p, batch) for p in (params, full_restored))
    del restored, full_restored, grestored, gleaf
    # a VersionedCheckpointer over one leaf at steps 4 and 6
    vdir = os.path.join(workdir, "versioned")
    vcfg = cc.VersionedCheckpointConfig(min_fitness=VERSIONED_GATE,
                                        delta_passes=VERSIONED_DELTA_PASSES,
                                        keyframe_opts=VERSIONED_KEYFRAME,
                                        delta_opts=VERSIONED_DELTA)
    subs = [_subtree(p, VERSIONED_LEAF) for p in (params4, params)]
    with plain_calls_counted(ref) as vplain:
        before = ops.launch_counts()
        t0 = time.perf_counter()
        with cc.VersionedCheckpointer(vdir, vcfg) as vc:
            vstats = [vc.save_step(t) for t in subs]
        vsave_s = time.perf_counter() - t0
        reader = cc.VersionedCheckpointer(vdir)
        vrel = []
        t0 = time.perf_counter()
        for step, t in enumerate(subs):
            back = reader.restore_step(step, t)
            for (key, a), (_, b) in zip(_flatten(back), _flatten(t)):
                require(a.shape == b.shape and a.device == b.device
                        and bool(torch.isfinite(a).all()), f"versioned step {step} {key}")
                vrel.append([step, key, float((a - b).norm() / b.norm())])
        vrestore_s = time.perf_counter() - t0
        vlaunches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    require(sum(vplain.values()) == 0, f"plain versions ran in the versioned store: {vplain}")
    require(vstats[0]["leaves_store"] == 1 and vstats[1]["leaves_store"] == 1
            and vstats[0]["keyframes"] == 1, f"versioned stats {vstats}")
    # the keyframe payload of that leaf through the kernel and the plain route
    with open(os.path.join(vdir, "manifest.json")) as f:
        fname = json.load(f)["leaves"][VERSIONED_LEAF]["file"]
    with VersionedStore.open(os.path.join(vdir, fname)) as vr:
        enc = vr.component(0)
    idx = np.stack([np.random.default_rng(SEED).integers(0, n, REQUEST) for n in enc.shape],
                   axis=1)
    kern = enc.decode_at(idx)
    plain_route = _with_impl(enc, "ref", NTTDEncoded).decode_at(idx)
    probe_err = float(np.abs(kern - plain_route).max())
    require(np.allclose(kern, plain_route, rtol=TOL["float32"], atol=TOL["float32"]),
            f"{VERSIONED_LEAF}: kernel and plain decodes differ by {probe_err}")
    vbytes = _dir_bytes(vdir)
    shutil.rmtree(vdir)
    emit({"phase": "train.codec", "arch": TRAIN_ARCH,
          "reduced": [f"n_layers 40 -> {RESUME_LAYERS} (train.resume's params)",
                      f"compress_tree without {CODEC_SKIP}'s 3 leaves (80 M of 405 M entries)",
                      f"VersionedCheckpointer over {VERSIONED_LEAF} alone, delta passes 2 -> "
                      f"{VERSIONED_DELTA_PASSES}"],
          "config": dataclasses.asdict(ccfg),
          "leaves": stats["leaves"], "raw_bytes": stats["raw_bytes"],
          "compressed_bytes": stats["compressed_bytes"], "ratio": stats["ratio"],
          "leaves_codec": stats["leaves_codec"], "leaves_raw": stats["leaves_raw"],
          "compress_seconds": compress_s, "decompress_seconds": decompress_s,
          "codec_leaf": {"leaf": CODEC_GATED_LEAF, "gate": VERSIONED_GATE,
                         "leaves": gstats["leaves"], "raw_bytes": gstats["raw_bytes"],
                         "compressed_bytes": gstats["compressed_bytes"],
                         "ratio": gstats["ratio"], "compress_seconds": gcompress_s,
                         "decompress_seconds": gdecompress_s,
                         "max_abs_err_vs_plain": gerr},
          "eval_loss_before": loss_before, "eval_loss_after": loss_after,
          "eval_loss_after_note": f"restored tree, {CODEC_GATED_LEAF} the codec leaf",
          "launches": launches, "plain_calls": plain,
          "probe": {"leaf": VERSIONED_LEAF, "payload": "the store's keyframe",
                    "entries": REQUEST, "max_abs_err": probe_err},
          "versioned": {"leaf": VERSIONED_LEAF, "gate": VERSIONED_GATE,
                        "delta_passes": VERSIONED_DELTA_PASSES,
                        "keyframe_opts": VERSIONED_KEYFRAME, "delta_opts": VERSIONED_DELTA,
                        "steps": [RESUME_STOP, RESUME_STEPS], "stats": vstats,
                        "bytes": vbytes, "save_seconds": vsave_s,
                        "restore_seconds": vrestore_s, "rel_err": vrel,
                        "launches": vlaunches, "plain_calls": vplain}})


def phase_train_embed(torch, device, table):
    """``NTTDEmbedding`` of the resumed run's 122,880 x 2304 table."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import ops, ref
    from repro_torch.models.nttd_embed import NTTDEmbedding

    vocab = configs.get(TRAIN_ARCH).vocab
    arr = table.detach().float().cpu().numpy()
    with plain_calls_counted(ref) as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = NTTDEmbedding.fit(arr, epochs=EMBED_EPOCHS, reorder=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        ids = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, vocab, size=EMBED_LOOKUP)).to(device)
        before = ops.launch_counts()["decode_tile"]
        t0 = time.perf_counter()
        got = emb.lookup(ids)
        torch.cuda.synchronize()
        lookup_ms = (time.perf_counter() - t0) * 1e3
        lookups = ops.launch_counts()["decode_tile"] - before
    require(sum(plain.values()) == 0, f"plain versions ran in the embedding: {plain}")
    require(lookups == 1, f"one lookup launched decode_tile {lookups} times")
    ct = emb.ct
    plain_emb = dataclasses.replace(
        emb, ct=dataclasses.replace(ct, cfg=dataclasses.replace(ct.cfg, kernel_impl="ref")))
    want = plain_emb.lookup(ids)
    err = float((got - want).abs().max())
    require(got.shape == (*EMBED_LOOKUP, arr.shape[1]) and bool(torch.isfinite(got).all()),
            "lookup output")
    require(torch.allclose(got, want, rtol=TOL["float32"], atol=TOL["float32"]),
            f"lookup: kernel and plain route differ by {err}")
    rows = torch.from_numpy(arr).to(device)[ids]
    rel = float((got - rows).norm() / rows.norm())
    emit({"phase": "train.embed", "table": list(arr.shape),
          "reduced": [f"epochs 150 -> {EMBED_EPOCHS}",
                      "reorder off: the TSP init's distance matrix over 122,880 rows is "
                      f"{arr.shape[0] ** 2 * 8 / 1e9:.0f} GB of f64 on the host"],
          "rank": ct.cfg.rank, "hidden": ct.cfg.hidden, "fit_seconds": fit_s,
          "lookup": list(EMBED_LOOKUP), "lookup_ms": lookup_ms, "lookup_launches": lookups,
          "max_abs_err_vs_plain": err, "rel_err_vs_table": rel,
          "payload_bytes": emb.payload_bytes(), "raw_bytes": emb.raw_bytes(),
          "plain_calls": plain})


def phase_train_all(torch, device, smi, workdir) -> dict:
    """The train phases; returns each kernel's launches in them (the simt
    bodies under their row names)."""
    from repro_torch.kernels import decode_tile as _dt
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    phase_train(torch, device, smi)
    params, params4 = phase_train_resume(torch, device, workdir)
    phase_train_codec(torch, device, params, params4, workdir)
    del params4
    phase_train_embed(torch, device, params["tok"]["embed"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    launches.update(decode_tile_simt=_dt.simt_launches, lstm_scan_simt=_lstm.simt_launches)
    return launches


def flash_timing_row(torch, device, launches, errs):
    """flash_attention at one full-width prefill: kernel, plain and SDPA."""
    from repro_torch.kernels import attention as _attention
    from repro_torch.kernels import ref

    b, s, h, d = FLASH_SHAPE
    gen = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to(device, torch.bfloat16)
               for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # [B, H, S, D]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    plain = ref.flash_attention(q, k, v, causal=True)
    outs = {"kernel": _attention.flash_attention(q, k, v, causal=True),
            "library": library().transpose(1, 2),
            "bf16_p_control": flash_bf16p_control(torch, q, k, v)}
    errs_at = {key: float((o.float() - plain.float()).abs().max()) for key, o in outs.items()}
    readings = {key: {"max_abs_err": errs_at[key], **flash_elementwise(torch, o, plain)}
                for key, o in outs.items()}
    kernel_err, lib_err = errs_at["kernel"], errs_at["library"]
    require(readings["kernel"]["beyond"] == 0, f"flash at the serve shape: {readings}")
    require(kernel_err < lib_err,
            f"flash error {kernel_err} not below SDPA's {lib_err}: p is not kept in f32")
    require(readings["bf16_p_control"]["beyond"] > 0,
            f"the per-element check passes a bf16-p control: {readings['bf16_p_control']}")
    n_ops, n_bytes = flash_cost(b, s, h, d, 2)
    return {
        "name": "flash_attention", "route": "cuda", "source": SOURCES["flash_attention"][0],
        "replaces": SOURCES["flash_attention"][1], "launches": launches["flash_attention"],
        "max_abs_err": errs["flash_attention"]["bfloat16"],
        "max_abs_err_bf16": errs["flash_attention"]["bfloat16"],
        "body": _attention.flash_body(q.dtype, d), "max_abs_err_at_shape": kernel_err,
        "ms": time_ms(torch, lambda: _attention.flash_attention(q, k, v, causal=True), 20),
        "plain_ms": time_ms(torch, lambda: ref.flash_attention(q, k, v, causal=True), 5),
        **bound(n_ops, n_bytes, PEAK_BF16),
        "library_ms": time_ms(torch, library, 20),
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True) "
                   "on [B, H, S, D] bf16", "library_max_abs_err": lib_err,
        "elementwise_at_shape": readings,
        "shape": {"B": b, "S": s, "H": h, "D": d, "dtype": "bfloat16", "causal": True},
        "ops": n_ops, "bytes": n_bytes,
    }


def phase_timing(torch, device, enc, idx_np, launches, errs, simt_lstm, bwd_calls,
                 flash_calls):
    """Kernel, plain and library times at the main path's shapes.
    ``simt_lstm`` is (the ``lstm_scan_simt`` row, a call of that kernel at
    the wide shape): the call is profiled with the main path's, and the row
    gains the device kernels it ran.  ``bwd_calls`` are one
    ``lstm_scan_bwd`` and one ``tt_contract_bwd`` call at the fit shape,
    and ``flash_calls`` the f32 flash kernel and SDPA at each
    FLASH_F32_SHAPES shape (``flash_f32_calls``), profiled in the same
    session: each f32 flash call must run the tf32x3 kernel alone.
    Returns the rows and the device operations of the backward calls and
    of the flash calls, (name, device microseconds) pairs."""
    from repro_torch.core import nttd
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tt_contract as _tt

    ct = enc.ct
    spec, cfg, params = ct.spec, ct.cfg, ct.params
    pos = torch.stack([torch.as_tensor(inv[idx_np[:, j]], device=device)
                       for j, inv in enumerate(ct.inv_pi)], dim=1)
    folded = spec.fold_indices(pos).to(torch.int32).contiguous()
    ws = ct.decode_operands  # as the main path hands them to the kernel
    b, t = folded.shape
    m, h, r = ws[0].shape[1], HIDDEN, RANK
    lstm = params["lstm"]
    x = torch.stack([params[f"embed_{mm}"][folded[:, j].long()]
                     for j, mm in enumerate(spec.folded_shape)], dim=1).contiguous()
    hs = ops.lstm_scan(x, lstm["wi"], lstm["wh"], lstm["b"], impl="ref")
    first = (hs[:, 0] @ params["head_first"]["w"] + params["head_first"]["b"]).contiguous()
    last = (hs[:, -1] @ params["head_last"]["w"] + params["head_last"]["b"]).contiguous()
    mids = (hs[:, 1:-1] @ params["head_mid"]["w"] + params["head_mid"]["b"]).reshape(
        b, t - 2, r, r).contiguous()

    weight_elems = sum(int(w.numel()) for w in ws)
    rows = []

    # decode_tile: LSTM gates, head projections and the chain, per entry
    ops_dt = decode_cost(b, t, h, r)
    bytes_dt = b * t * 4 + b * 4 + weight_elems * 4
    rows.append(("decode_tile", ops_dt, bytes_dt,
                 lambda: ops.nttd_decode_tile(folded, *ws, impl="cuda"),
                 lambda: ref.nttd_decode_tile(folded, *ws), None, None))

    ops_l, bytes_l = lstm_cost(b, t, h)
    library_lstm = cudnn_lstm(torch, lstm["wi"], lstm["wh"], lstm["b"])
    rows.append(("lstm_scan", ops_l, bytes_l,
                 lambda: ops.lstm_scan(x, lstm["wi"], lstm["wh"], lstm["b"], impl="cuda"),
                 lambda: ref.lstm_scan(x, lstm["wi"], lstm["wh"], lstm["b"]),
                 lambda: library_lstm(x), "cuDNN torch.nn.LSTM, gates (i, f, g, o)"))

    ops_t = b * ((t - 2) * 2 * r * r + 2 * r)
    bytes_t = tt_bytes(b, t - 2, r, 4)
    equation = chain_equation(t - 2)
    mid_list = mids.unbind(1)
    opt = torch.backends.opt_einsum
    path = "opt_einsum path" if opt.enabled and opt.is_available() else "left to right"
    rows.append(("tt_contract", ops_t, bytes_t,
                 lambda: ops.tt_contract(first, mids, last, impl="cuda"),
                 lambda: ref.tt_contract(first, mids, last),
                 lambda: torch.einsum(equation, first, *mid_list, last),
                 f"torch.einsum('{equation}'), {path}"))

    kernels = []
    for name, n_ops, n_bytes, kern, plain, library, library_name in rows:
        lib_err = float((library() - plain()).abs().max()) if library else None
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "max_abs_err": errs[name]["float32"],
            "max_abs_err_bf16": errs[name]["bfloat16"],
            "ms": time_ms(torch, kern, 20),
            "plain_ms": time_ms(torch, plain, 5),
            **bound(n_ops, n_bytes, PEAK_FP32),
            "library_ms": time_ms(torch, library, 20) if library else None,
            "library": library_name, "library_max_abs_err": lib_err,
            "shape": {"B": b, "T": t, "M": m, "H": h, "R": r},
            "ops": n_ops, "bytes": n_bytes,
        })
    kernels[0].update(body=_decode_tile.decode_body(h, r),
                      bucket=list(_decode_tile.bucket_for(h, r)))
    # every device kernel or copy that one lstm_scan call, then one
    # tt_contract call, then one wide lstm_scan call runs: the register
    # kernel, the tt_contract kernel and the simt lstm_scan kernel, each
    # alone; and lstm_scan's body, bucket and load route
    lstm_call, tt_call = rows[1][3], rows[2][3]
    simt_row, simt_call = simt_lstm
    flash_fns = [fn for call in flash_calls for fn in (call["kernel"], call["library"])]
    timed = device_kernels(torch, (lstm_call, tt_call, simt_call, *bwd_calls, *flash_fns),
                           times=True)
    seen = [[name for name, _ in call] for call in timed]
    flash_timed = timed[len(timed) - len(flash_fns):]
    for call, ops_run in zip(flash_calls, flash_timed[::2]):
        require(len(ops_run) == 1 and "flash_attention_tf32x3_kernel" in ops_run[0][0],
                f"an f32 flash call at {call['shape']} ran {ops_run}, not the tf32x3 kernel "
                "alone")
    require(all(len(call) == 1 for call in seen[:3])
            and "lstm_scan_register_kernel" in seen[0][0] and "tt_contract_kernel" in seen[1][0]
            and "lstm_scan_simt_kernel" in seen[2][0],
            f"an lstm_scan call, a tt_contract call and a wide lstm_scan call ran {seen[:3]}, "
            "not the register kernel, the tt_contract kernel and the simt kernel alone")
    require(sum("lstm_scan_bwd_kernel" in name for name in seen[3]) == 1,
            f"an lstm_scan_bwd call ran {seen[3]}, not the backward kernel once")
    require(len(seen[4]) == 1 and "tt_contract_bwd_" in seen[4][0],
            f"a tt_contract_bwd call ran {seen[4]}, not the backward kernel alone")
    simt_row["device_ops_per_call"] = seen[2]
    kernels[1].update(body=_lstm.lstm_body(h), bucket=_lstm.bucket_for(h),
                      loads="vector" if _lstm.vector_rows(x, lstm_call()) else "scalar",
                      device_ops_per_call=seen[0])
    # tt_contract: its body and the same shape in bf16 against its own
    # byte bound
    bf = [a.to(torch.bfloat16) for a in (first, mids, last)]
    kernels[2].update(body="lane_group", lanes_per_entry=_tt.lanes_per_entry(r),
                      device_ops_per_call=seen[1],
                      ms_bf16=time_ms(torch, lambda: ops.tt_contract(*bf, impl="cuda"), 20),
                      bound_ms_bf16=bound(ops_t, tt_bytes(b, t - 2, r, 2), PEAK_FP32)["bound_ms"])
    return kernels, timed[3:3 + len(bwd_calls)], flash_timed


def flash_f32_calls(torch, device, shapes=None, seed: int = SEED) -> list[dict]:
    """At each (B, S, H, D, qk_scale) of ``shapes`` (default
    FLASH_F32_SHAPES), causal MHA q, k and v in f32 from ``seed``, q and k
    times qk_scale (the logits grow with its square), and the calls that
    ``flash_f32_case`` times: the kernel (its tf32x3 body), the plain
    version, SDPA on [B, H, S, D] and the f64 evaluation ``flash_f64``."""
    from repro_torch.kernels import attention as _attention
    from repro_torch.kernels import ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = []
    for b, s, h, d, qk_scale in FLASH_F32_SHAPES if shapes is None else shapes:
        gen = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn((b, s, h, d), generator=gen).to(device) for _ in range(3))
        q, k = q * qk_scale, k * qk_scale
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        calls.append({
            "shape": (b, s, h, d), "qk_scale": qk_scale,
            "kernel": lambda q=q, k=k, v=v: _attention.flash_attention(q, k, v, causal=True),
            "plain": lambda q=q, k=k, v=v: ref.flash_attention(q, k, v, causal=True),
            "library": lambda qt=qt, kt=kt, vt=vt: sdpa(qt, kt, vt, is_causal=True),
            "exact": lambda q=q, k=k, v=v: flash_f64(torch, q, k, v)})
    return calls


def flash_f32_case(torch, call, kernel_ms: float, library_ms: float,
                   library_ops: list) -> dict:
    """One ``flash_f32_calls`` call's reading: kernel ms (CUDA events, 20
    after 2 warm-ups) beside its device ms (``kernel_ms``, measured by the
    caller), plain ms (5), SDPA in f32 (20) beside its device ms and
    kernels, the bound (3 TF32 products a product over 495 TFLOP/s, or the
    bytes) and the FP32-FMA floor, and the kernel's, SDPA's and the plain
    version's errors, element by element against f32's tolerance
    (``flash_elementwise_f32``), against the plain version (``elementwise``)
    and against ``flash_f64`` (``elementwise_f64``)."""
    from repro_torch.kernels import attention as _attention

    b, s, h, d = call["shape"]
    n_ops, n_bytes = flash_cost(b, s, h, d, 4)
    want, got = call["plain"](), call["kernel"]()
    library = call["library"]().transpose(1, 2)
    case = {"shape": {"B": b, "S": s, "H": h, "D": d, "dtype": "float32", "causal": True},
            "qk_scale": call["qk_scale"], "body": _attention.flash_body(torch.float32, d),
            "ms": time_ms(torch, call["kernel"], 20), "kernel_ms": kernel_ms,
            "plain_ms": time_ms(torch, call["plain"], 5),
            "library_ms": time_ms(torch, call["library"], 20),
            "library_kernel_ms": library_ms,
            "library_ops": [name[:80] for name in library_ops],
            **bound(3 * n_ops, n_bytes, PEAK_TF32),
            "fp32_floor_ms": n_ops / PEAK_FP32 * 1e3,
            "max_abs_err": float((got - want).abs().max()),
            "library_max_abs_err": float((library - want).abs().max()),
            "elementwise": {key: {"max_abs_err": float((o - want).abs().max()),
                                  **flash_elementwise_f32(torch, o, want)}
                            for key, o in (("kernel", got), ("library", library))},
            "ops": n_ops, "bytes": n_bytes}
    exact = call["exact"]()
    case["elementwise_f64"] = {key: {"max_abs_err": float((o.double() - exact).abs().max()),
                                     **flash_elementwise_f32(torch, o.double(), exact)}
                               for key, o in (("kernel", got), ("library", library),
                                              ("plain", want))}
    del exact
    case.update(share=case["bound_ms"] / case["ms"],
                kernel_share=case["bound_ms"] / case["kernel_ms"])
    if (b, s, h, d) == FLASH_SHAPE and call["qk_scale"] == 1:
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = call["plain"]()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        case["elementwise"]["single_tf32_control"] = {
            "max_abs_err": float((control - want).abs().max()),
            **flash_elementwise_f32(torch, control, want)}
    return case


def flash_f32_timing(torch, calls, profiled, launches: dict, errs) -> dict:
    """The flash kernel in f32 (its tf32x3 body) at each FLASH_F32_SHAPES
    case (``flash_f32_calls``, read by ``flash_f32_case``; device ms from
    ``profiled``, ``phase_timing``'s one profiler session).  At every case
    every element of the kernel's output must lie within f32's tolerance
    of the f64 evaluation's, and of the plain version's where the logits
    are randn's (qk_scale 1: at 3 the plain version is itself off the f64
    one by more); at FLASH_SHAPE a single-TF32 control, the plain version
    with TF32 matmuls, must not lie within it of the plain version.  Prints
    ``timing.flash_f32`` with ``launches`` (the tf32x3 body's, by path);
    returns the kernels-table row at FLASH_SHAPE."""
    from repro_torch.kernels import attention as _attention

    cases = []
    for n, call in enumerate(calls):
        kernel_ops, library_ops = profiled[2 * n], profiled[2 * n + 1]
        case = flash_f32_case(torch, call, sum(us for _, us in kernel_ops) / 1e3,
                              sum(us for _, us in library_ops) / 1e3,
                              [name for name, _ in library_ops])
        case["plan"] = dataclasses.asdict(_attention.tf32x3_plan(call["shape"][3]))
        require(case["elementwise_f64"]["kernel"]["beyond"] == 0
                and (call["qk_scale"] != 1 or case["elementwise"]["kernel"]["beyond"] == 0),
                f"flash f32 at {call['shape']} x {call['qk_scale']}: {case['elementwise']} "
                f"(against the plain version), {case['elementwise_f64']} (against f64)")
        if "single_tf32_control" in case["elementwise"]:
            require(case["elementwise"]["single_tf32_control"]["beyond"] > 0,
                    "the per-element f32 check passes a single-TF32 control: "
                    f"{case['elementwise']['single_tf32_control']}")
        cases.append(case)
    require(any("single_tf32_control" in c["elementwise"] for c in cases),
            "timing.flash_f32 ran no single-TF32 control")
    emit({"phase": "timing.flash_f32", "cases": cases, "launches": launches})
    first = cases[0]
    return {
        "name": "flash_attention_f32", "route": "cuda",
        "source": SOURCES["flash_attention_f32"][0],
        "replaces": SOURCES["flash_attention_f32"][1], "launches": launches["decode"],
        "max_abs_err": errs["flash_attention_f32"]["float32"],
        "max_abs_err_bf16": errs["flash_attention_f32"]["bfloat16"],
        "body": first["body"], "plan": first["plan"],
        **{key: first[key] for key in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                       "fp32_floor_ms", "share", "kernel_share",
                                       "library_ms", "library_kernel_ms", "library_ops",
                                       "library_max_abs_err", "elementwise", "shape", "ops",
                                       "bytes")},
        "max_abs_err_at_shape": first["max_abs_err"],
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True) on "
                   "[B, H, S, D] f32",
        "elementwise_f64": first["elementwise_f64"],
        "other_cases": [{key: c[key] for key in (
            "shape", "qk_scale", "ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "fp32_floor_ms", "max_abs_err", "elementwise", "elementwise_f64")}
            for c in cases[1:]],
    }


def decode_simt_timing(torch, device, launches, errs):
    """The simt decode body at B ``REQUEST``, T 10, M 8 (f32, inputs scaled
    to the width) for each shape of ``WIDE_TIMING``: kernel (mean of 20
    launches after 2 warm-ups, as every row), plain version (5) and bound,
    with the tile of entries, on a ``timing.decode_simt`` line; returns the
    kernels-table row of the first shape, the wide phase's."""
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(SEED)
    cases = []
    for h, r in WIDE_TIMING:
        b, t, m = REQUEST, 10, 8
        idx, ws = decode_inputs(torch, gen, b, t, m, h, r, torch.float32, device,
                                width_scaled=True)
        kern = functools.partial(ops.nttd_decode_tile, idx, *ws, impl="cuda")
        plain = functools.partial(ref.nttd_decode_tile, idx, *ws)
        n_bytes = b * t * 4 + b * 4 + sum(int(w.numel()) for w in ws) * 4
        cases.append({"H": h, "R": r, "B": b, "T": t, "M": m,
                      "body": _decode_tile.decode_body(h, r),
                      **simt_tile(h, r),
                      "max_abs_err_at_shape": float((kern() - plain()).abs().max()),
                      "ms": time_ms(torch, kern, 20),
                      "plain_ms": time_ms(torch, plain, 5),
                      **bound(decode_cost(b, t, h, r), n_bytes, PEAK_FP32),
                      "ops": decode_cost(b, t, h, r), "bytes": n_bytes})
        require(cases[-1]["max_abs_err_at_shape"] <= TOL["float32"],
                f"simt decode at ({h}, {r}): {cases[-1]['max_abs_err_at_shape']} from the plain "
                "version")
    emit({"phase": "timing.decode_simt", "cases": cases})
    first = cases[0]
    return {
        "name": "decode_tile_simt", "route": "cuda", "source": SOURCES["decode_tile_simt"][0],
        "replaces": SOURCES["decode_tile_simt"][1], "launches": launches,
        "max_abs_err": errs["decode_tile_simt"]["float32"],
        "max_abs_err_bf16": errs["decode_tile_simt"]["bfloat16"],
        "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "library_ms": None, "library": None,
        "library_max_abs_err": None, "body": first["body"], "tile": first["tile"],
        "shape": {k: first[k] for k in ("B", "T", "M", "H", "R")},
        "ops": first["ops"], "bytes": first["bytes"],
    }


def lstm_simt_timing(torch, device, launches, errs):
    """The simt lstm_scan body at B ``REQUEST``, T 10 (f32) for each width of
    ``LSTM_SIMT_TIMING``: kernel (mean of 20 launches after 2 warm-ups, as
    every row), plain version (5), cuDNN ``nn.LSTM`` (20) and the bound, with
    the tile of sequences and the bound's share of the kernel's time, on a
    ``timing.lstm_simt`` line.  Returns the kernels-table row of the first
    width, the wide phase's, and a call of the kernel at that width."""
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(SEED)
    cases, first_call = [], None
    for h in LSTM_SIMT_TIMING:
        b, t = REQUEST, 10
        x, lw = lstm_inputs(torch, gen, b, t, h, torch.float32, device)
        kern = functools.partial(ops.lstm_scan, x, *lw, impl="cuda")
        plain = functools.partial(ref.lstm_scan, x, *lw)
        library = cudnn_lstm(torch, *lw)
        n_ops, n_bytes = lstm_cost(b, t, h)
        case = {"H": h, "B": b, "T": t, "body": _lstm.lstm_body(h), **lstm_simt_tile(h),
                "max_abs_err_at_shape": float((kern() - plain()).abs().max()),
                "library_max_abs_err": float((library(x) - plain()).abs().max()),
                "ms": time_ms(torch, kern, 20), "plain_ms": time_ms(torch, plain, 5),
                "library_ms": time_ms(torch, lambda: library(x), 20),
                **bound(n_ops, n_bytes, PEAK_FP32), "ops": n_ops, "bytes": n_bytes}
        case["share_of_bound"] = case["bound_ms"] / case["ms"]
        require(case["max_abs_err_at_shape"] <= TOL["float32"],
                f"simt lstm_scan at H {h}: {case['max_abs_err_at_shape']} from the plain "
                "version")
        cases.append(case)
        first_call = first_call or kern
    emit({"phase": "timing.lstm_simt", "cases": cases})
    first = cases[0]
    return {
        "name": "lstm_scan_simt", "route": "cuda", "source": SOURCES["lstm_scan_simt"][0],
        "replaces": SOURCES["lstm_scan_simt"][1], "launches": launches,
        "max_abs_err": errs["lstm_scan_simt"]["float32"],
        "max_abs_err_bf16": errs["lstm_scan_simt"]["bfloat16"],
        "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "library_ms": first["library_ms"],
        "library": "cuDNN torch.nn.LSTM, gates (i, f, g, o)",
        "library_max_abs_err": first["library_max_abs_err"], "body": first["body"],
        "tile": first["tile"], "shape": {k: first[k] for k in ("B", "T", "H")},
        "ops": first["ops"], "bytes": first["bytes"],
    }, first_call


def compare_grads(torch, got, want) -> list[float]:
    """Max abs error of each gradient; fails unless it is within
    ``BWD_ATOL`` + ``BWD_RTOL`` x the gradient's largest |value| (the
    tolerance a gradient as a whole, not element by element: a weight's
    gradient sums B T rows, and where such a sum cancels to near 0 any two
    f32 orders of summation differ by more than the atol, though both sit
    as close to an f64 evaluation: ``lstm_f64_bwd``)."""
    errs = []
    require(len(got) == len(want), f"{len(got)} gradients, expected {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"gradient {i}: {tuple(g.shape)} {g.dtype} != {tuple(w.shape)} {w.dtype}")
        require(bool(torch.isfinite(g).all()), f"gradient {i} is not finite")
        worst = float((g - w).abs().max()) if g.numel() else 0.0
        largest = float(w.abs().max()) if w.numel() else 0.0
        require(worst <= BWD_ATOL + BWD_RTOL * largest,
                f"gradient {i}: max abs err {worst} beyond atol {BWD_ATOL} + rtol {BWD_RTOL} "
                f"x its largest value {largest}")
        errs.append(worst)
    return errs


def beyond_elementwise(torch, got, want) -> list[int]:
    """Elements of each gradient beyond ``BWD_ATOL`` + ``BWD_RTOL`` x their
    own |value| (printed beside the check)."""
    return [int(((g - w).abs() > BWD_ATOL + BWD_RTOL * w.abs()).sum())
            for g, w in zip(got, want)]


def training_inputs(torch, gen, b, t, hid, rank, device):
    """The operands a training step hands the backward kernels: an NTTD at
    (hid, rank) from the codec's own init (its biases drawn N(0, 0.1), as
    after some training, so the bias paths carry values), B random entries
    of the PEMS-SF index space folded to d' = T, normalized targets drawn
    N(0, 1), the summed squared error's gradient taken through the plain
    route.  Returns the lstm_scan backward's (x, (wi, wh, b), dhs) and the
    tt_contract backward's (first, mid, last, dout)."""
    from repro_torch.core import nttd
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.kernels import ref

    spec = make_folding_spec(PEMS_SHAPE, t)
    cfg = nttd.NTTDConfig(rank=rank, hidden=hid)
    params = nttd.init_params(gen, spec, cfg, device)
    for head in ("lstm", "head_first", "head_mid", "head_last"):
        params[head]["b"] = params[head]["b"] + 0.1 * torch.randn(
            params[head]["b"].shape, generator=gen).to(device)
    pos = torch.stack([torch.randint(0, n, (b,), generator=gen) for n in PEMS_SHAPE], 1)
    folded = spec.fold_indices(pos.to(device))
    x = torch.stack([params[f"embed_{m}"][folded[:, j]]
                     for j, m in enumerate(spec.folded_shape)], dim=1).contiguous()
    lstm = params["lstm"]
    vals = torch.randn((b,), generator=gen).to(device)
    with torch.enable_grad():
        hs = ref.lstm_scan(x, lstm["wi"], lstm["wh"], lstm["b"]).requires_grad_()
        first = hs[:, 0] @ params["head_first"]["w"] + params["head_first"]["b"]
        last = hs[:, -1] @ params["head_last"]["w"] + params["head_last"]["b"]
        mid = (hs[:, 1:-1] @ params["head_mid"]["w"] + params["head_mid"]["b"]).reshape(
            b, t - 2, rank, rank)
        cores = [a.detach().contiguous().requires_grad_() for a in (first, mid, last)]
        pred = ref.tt_contract(*cores)
        dout = 2 * (pred - vals).detach()
        dhs = torch.autograd.grad((first, mid, last), hs, torch.autograd.grad(
            pred, cores, dout))[0]
    return ((x, (lstm["wi"], lstm["wh"], lstm["b"]), dhs.contiguous()),
            tuple(a.detach() for a in cores) + (dout,))


def lstm_bwd_inputs(torch, gen, b, t, h, device):
    """``training_inputs``' lstm_scan operands at hidden ``h`` (rank h / 2,
    the budget rule's ratio)."""
    return training_inputs(torch, gen, b, t, h, max(1, h // 2), device)[0]


def tt_bwd_inputs(torch, gen, b, k, r, device):
    """``training_inputs``' tt_contract operands at rank ``r`` and K mid
    cores (hidden 2 r, d' = K + 2)."""
    return training_inputs(torch, gen, b, k + 2, 2 * r, r, device)[1]


def lstm_f64_bwd(torch, x, wi, wh, b, dhs):
    """The lstm_scan gradients evaluated in f64 (autograd of the plain
    forward's math without its f32 casts): the yardstick of the unit-scale
    reading."""
    with torch.enable_grad():
        leaves = [a.double().requires_grad_() for a in (x, wi, wh, b)]
        xd, wid, whd, bd = leaves
        bsz, t_steps, hid = x.shape
        h = c = torch.zeros((bsz, hid), dtype=torch.float64, device=x.device)
        outs = []
        for t in range(t_steps):
            i, f, g, o = (xd[:, t] @ wid + h @ whd + bd).split(hid, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.autograd.grad(torch.stack(outs, 1), leaves, dhs.double())


def lstm_bwd_cost(b: int, t: int, h: int) -> tuple[int, int]:
    """(FLOP, bytes) of the whole ``lstm_scan`` backward: per entry and step
    16 H^2 to recompute the gates, 16 H^2 for [dx | dh] = dG [wi; wh]^T and
    16 H^2 for dwi and dwh; x, hs, dhs and the weights read once, dx and
    the weights' gradients written once."""
    return b * t * 48 * h * h, (4 * b * t * h + 16 * h * h + 8 * h) * 4


def lstm_bwd_kernel_cost(b: int, t: int, h: int) -> tuple[int, int]:
    """(FLOP, bytes) of the backward kernel alone: per entry and step the
    gates once (16 H^2) and [dx | dh] = dG [wi; wh]^T (16 H^2), the least
    work (the narrow plan recomputes the gates in its reverse sweep,
    which this does not count); x, hs, dhs and the weights read, dx [B, T,
    H] and G [B T, 4H] written.  The kernel also writes A [B T, 2H + 1],
    a copy of x and hs for the weight gradients' one product: the design's
    overhead, which the function does not need and the bound does not
    count."""
    return b * t * 32 * h * h, (b * t * 8 * h + 8 * h * h + 4 * h) * 4


def tt_bwd_cost(b: int, k: int, r: int) -> tuple[int, int]:
    """(FLOP, bytes) of the ``tt_contract`` backward: per entry 2 R^2 a mid
    core for the prefix, 2 R^2 for the suffix and 2 R^2 for dmid; first,
    mid, last and dout read once, dfirst, dmid and dlast written once."""
    return b * (6 * k * r * r + 4 * r), (4 * b * r + 2 * b * k * r * r + b) * 4


def cudnn_lstm_backward(torch, x, wi, wh, bias, dhs):
    """cuDNN ``torch.nn.LSTM`` holding wi, wh, b as ``cudnn_lstm`` does, run
    forward once with its graph kept: a function that runs its backward
    (dx and every weight's gradient) against ``dhs``, ``lstm_scan_bwd``'s
    library yardstick.  Returns (run, a function giving dx, dwi, dwh, db in
    ``lstm_scan``'s layout)."""
    h = wi.shape[0]
    net = torch.nn.LSTM(h, h, batch_first=True).to(wi.device)
    with torch.no_grad():
        net.weight_ih_l0.copy_(wi.T)
        net.weight_hh_l0.copy_(wh.T)
        net.bias_ih_l0.copy_(bias)
        net.bias_hh_l0.zero_()
    xg = x.detach().clone().requires_grad_()
    out = net(xg)[0]
    inputs = (xg, net.weight_ih_l0, net.weight_hh_l0, net.bias_ih_l0, net.bias_hh_l0)

    def run():
        return torch.autograd.grad(out, inputs, dhs, retain_graph=True)

    def grads():
        dx, dwi, dwh, db, _ = run()
        return dx, dwi.T, dwh.T, db
    return run, grads


def phase_kernels_bwd(torch, device):
    """Each backward kernel against its plain version (autograd of the plain
    forward) on the card, every gradient within ``BWD_RTOL`` / ``BWD_ATOL``;
    each call must launch its kernel once."""
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tt_contract as _tt

    gen = torch.Generator().manual_seed(SEED)
    errs = {"lstm_scan_bwd": 0.0, "tt_contract_bwd": 0.0, "tt_contract_bwd_wide": 0.0}
    lstm_cases, tt_cases, wide_timing = [], [], []
    for b, t, h in BWD_LSTM_CASES:
        x, lw, dhs = lstm_bwd_inputs(torch, gen, b, t, h, device)
        hs = ops.lstm_scan(x, *lw, impl="cuda")  # the forward kernel's, as training saves it
        before = _lstm.bwd_launches
        got = _lstm.lstm_scan_bwd(x, *lw, hs, dhs)
        require(_lstm.bwd_launches == before + 1, f"lstm_scan_bwd at H {h} launched no kernel")
        plain = ref.lstm_scan_bwd(x, *lw, dhs)
        err = compare_grads(torch, got, plain)
        errs["lstm_scan_bwd"] = max(errs["lstm_scan_bwd"], *err)
        # both against an f64 evaluation: the kernel's route may be no less
        # accurate than the plain version's, within a factor of 4
        exact = lstm_f64_bwd(torch, x, *lw, dhs)
        vs_f64 = [(float((g.double() - e).abs().max()), float((p.double() - e).abs().max()))
                  for g, p, e in zip(got, plain, exact)]
        require(all(k <= 4 * p + BWD_ATOL for k, p in vs_f64),
                f"lstm_scan_bwd at H {h}: (kernel, plain) errors against f64 {vs_f64}")
        names = ("dx", "dwi", "dwh", "db")
        plan = _lstm.bwd_plan(h, b)
        lstm_cases.append({"B": b, "T": t, "H": h, "tile": plan.tile, "kind": plan.kind,
                           "max_abs_err": dict(zip(names, err)),
                           "largest": dict(zip(names, (float(p.abs().max()) for p in plain))),
                           "kernel_plain_vs_f64": dict(zip(names, vs_f64)),
                           "beyond_elementwise": dict(zip(names, beyond_elementwise(
                               torch, got, plain)))})
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for b, k, r in BWD_TT_CASES:
        first, mid, last, dout = tt_bwd_inputs(torch, gen, b, k, r, device)
        before = _tt.bwd_launches
        got = _tt.tt_contract_bwd(first, mid, last, dout)
        require(_tt.bwd_launches == before + 1, f"tt_contract_bwd at R {r} launched no kernel")
        plain = ref.tt_contract_bwd(first, mid, last, dout)
        err = compare_grads(torch, got, plain)
        errs["tt_contract_bwd"] = max(errs["tt_contract_bwd"], *err)
        names = ("dfirst", "dmid", "dlast")
        plan = _tt.bwd_plan(r, k, b, sms)
        if plan.kind == "wide":
            errs["tt_contract_bwd_wide"] = max(errs["tt_contract_bwd_wide"], *err)
        tt_cases.append({"B": b, "K": k, "R": r, "plan": plan.kind, "entries": plan.entries,
                         "blocks": plan.blocks, "threads": plan.threads,
                         "cluster": plan.cluster,
                         "max_abs_err": dict(zip(names, err)),
                         "largest": dict(zip(names, (float(p.abs().max()) for p in plain))),
                         "beyond_elementwise": dict(zip(names, beyond_elementwise(
                             torch, got, plain)))})
        if (b, k, r) in BWD_TT_WIDE_TIMED:
            del got, plain
            ms = time_ms(torch, lambda: _tt.tt_contract_bwd(first, mid, last, dout), 20)
            cost = bound(*tt_bwd_cost(b, k, r), PEAK_FP32)
            wide_timing.append({"B": b, "K": k, "R": r, "plan": plan.kind,
                                "cluster": plan.cluster, "ms": ms, **cost,
                                "bound_share": cost["bound_ms"] / ms})
    emit({"phase": "kernels.bwd.wide_timing", "cases": wide_timing,
          "note": "ms: CUDA events, mean of 20 back-to-back calls after 2 warm-ups (mid is "
                  "1.2-4.3 GB, far above the 50 MB L2; a call's host work is far shorter than "
                  "its kernel)"})
    # mid one float off the 16-byte grid (a view one float into a larger
    # buffer): the slab plan copies each entry's ragged head and tail by
    # plain loads and allocates dmid at the same offset from the grid
    b, k, r = 1001, 8, 10
    first, mid, last, dout = tt_bwd_inputs(torch, gen, b, k, r, device)
    mid_off = torch.empty(mid.numel() + 1, device=device)[1:].view(mid.shape).copy_(mid)
    got = _tt.tt_contract_bwd(first, mid_off, last, dout)
    require(mid_off.data_ptr() % 16 == got[1].data_ptr() % 16 == 4,
            "the off-grid case's mid or dmid lies on the 16-byte grid")
    off_grid_err = compare_grads(torch, got, ref.tt_contract_bwd(first, mid, last, dout))
    errs["tt_contract_bwd"] = max(errs["tt_contract_bwd"], *off_grid_err)
    off_grid = {"B": b, "K": k, "R": r,
                "max_abs_err": dict(zip(("dfirst", "dmid", "dlast"), off_grid_err))}
    # a reading at unit scale (x, dhs ~ N(0, 1), weights 0.3): there the
    # weight gradients' f32 sums over B T = 81,920 rows differ between any two
    # summation orders by more than the atol near 0, so both versions are
    # held against an f64 evaluation instead, and printed
    b, t, h = BWD_LSTM_CASES[0]
    x, lw = lstm_inputs(torch, gen, b, t, h, torch.float32, device)
    dhs = torch.randn((b, t, h), generator=gen).to(device)
    exact = lstm_f64_bwd(torch, x, *lw, dhs)
    got = _lstm.lstm_scan_bwd(x, *lw, ops.lstm_scan(x, *lw, impl="cuda"), dhs)
    plain = ref.lstm_scan_bwd(x, *lw, dhs)
    unit = {"B": b, "T": t, "H": h, **{
        name: {"kernel_vs_f64": float((g.double() - e).abs().max()),
               "plain_vs_f64": float((p.double() - e).abs().max()),
               "kernel_vs_plain": float((g - p).abs().max()), "largest": float(e.abs().max())}
        for name, g, p, e in zip(("dx", "dwi", "dwh", "db"), got, plain, exact)}}
    # through autograd: the Functions' backward passes are the kernels
    x, lw, dhs = lstm_bwd_inputs(torch, gen, 64, 10, 18, device)
    leaves = [a.clone().requires_grad_() for a in (x, *lw)]
    before = (_lstm.bwd_launches, _tt.bwd_launches)
    torch.autograd.backward(ops.lstm_scan(*leaves, impl="cuda"), dhs)
    first, mid, last, dout = tt_bwd_inputs(torch, gen, 64, 8, 10, device)
    tt_leaves = [a.clone().requires_grad_() for a in (first, mid, last)]
    torch.autograd.backward(ops.tt_contract(*tt_leaves, impl="cuda"), dout)
    require((_lstm.bwd_launches, _tt.bwd_launches) == (before[0] + 1, before[1] + 1),
            "autograd through lstm_scan and tt_contract did not run the backward kernels")
    compare_grads(torch, [a.grad for a in leaves], ref.lstm_scan_bwd(x, *lw, dhs))
    compare_grads(torch, [a.grad for a in tt_leaves], ref.tt_contract_bwd(first, mid, last, dout))
    torch.cuda.synchronize()
    emit({"phase": "kernels.bwd", "rtol": BWD_RTOL, "atol": BWD_ATOL,
          "inputs": "training_inputs: an NTTD at its init scales on PEMS-SF's index space",
          "lstm_scan_bwd": lstm_cases, "tt_contract_bwd": tt_cases,
          "tt_contract_bwd_off_grid": off_grid, "max_abs_err": errs,
          "lstm_scan_bwd_unit_scale": unit})
    return errs


@contextlib.contextmanager
def plain_calls_counted(ref):
    """Count the calls of every plain kernel version in ``ref`` while the
    block runs (the wrappers and ``ops`` call them through the module)."""
    names = ("nttd_decode_tile", "lstm_scan", "tt_contract", "lstm_scan_bwd", "tt_contract_bwd")
    counts = dict.fromkeys(names, 0)
    saved = {name: getattr(ref, name) for name in names}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in names:
        setattr(ref, name, counted(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(ref, name, fn)


def fit_options(**extra) -> dict:
    """The paper's MEDIUM (rank 10, hidden 18, batch 8192, lr 1e-2) as
    ``NTTDCodec.fit`` options, cut to ``FIT_EPOCHS`` epochs with one Alg. 3
    sweep."""
    from repro_torch.configs import tensorcodec_paper

    return {**dataclasses.asdict(tensorcodec_paper.MEDIUM), "epochs": FIT_EPOCHS,
            "reorder_warmup": FIT_REORDER, "reorder_every": FIT_REORDER, **extra}


def phase_fit(torch, device):
    """Alg. 1 at full width: the paper's MEDIUM on the PEMS-SF replica at
    its Table II shape, through ``get_codec("nttd").fit`` on its default
    device (the card).  Every training step must launch the forward and
    backward ``lstm_scan`` and ``tt_contract`` kernels once, every epoch's
    fitness the fused decode, and no plain version may run.  The payload's
    whole-tensor fitness must match the best sampled fitness of the fit,
    and the payload must load and answer as fitted.  Returns the phase's
    launches and its seconds per training step."""
    import numpy as np

    from repro_torch.codecs import get_codec, load_bytes
    from repro_torch.data import synthetic_tensors
    from repro_torch.kernels import ops, ref

    t0 = time.perf_counter()
    x = synthetic_tensors.load(FIT_DATASET, mini=False, seed=SEED)
    tensor_s = time.perf_counter() - t0
    require(x.shape == PEMS_SHAPE, f"the {FIT_DATASET} replica has shape {x.shape}")
    opts = fit_options(entries_per_epoch=FIT_ENTRIES)
    require(opts["kernel_impl"] == "auto", f"the default impl is {opts['kernel_impl']!r}")
    with plain_calls_counted(ref) as plain:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        enc = get_codec("nttd").fit(x, **opts)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches = ops.launch_counts()
    require(enc.ct.device.type == "cuda", "the fit did not run on the card")
    require(sum(plain.values()) == 0, f"plain versions ran on the fit path: {plain}")
    log = enc.log
    steps = FIT_ENTRIES // opts["batch_size"] * log.epochs_run
    train = {k: launches[k] for k in ("lstm_scan", "lstm_scan_bwd", "tt_contract",
                                      "tt_contract_bwd")}
    require(set(train.values()) == {steps},
            f"{steps} training steps launched {train}; expected one of each a step")
    require(launches["decode_tile"] >= log.epochs_run,
            f"decode_tile launched {launches['decode_tile']} times in {log.epochs_run} epochs")
    require(len(log.reorder_stats) == (log.epochs_run > FIT_REORDER),
            f"{len(log.reorder_stats)} Alg. 3 sweeps in {log.epochs_run} epochs")
    require(all(math.isfinite(v) for v in log.fitness_history + log.loss_history),
            "non-finite fitness or loss")
    # what comes out: the returned payload's exact fitness over all entries
    # is the best epoch's sampled one (4M entries), and it reloads intact
    t = time.perf_counter()
    full = enc.fitness(x)
    full_s = time.perf_counter() - t
    best = max(log.fitness_history)
    require(abs(full - best) < 1e-2, f"payload fitness {full} vs the fit's best {best}")
    blob = enc.save()
    idx = np.stack([np.random.default_rng(SEED).integers(0, n, REQUEST) for n in PEMS_SHAPE],
                   axis=1)
    got = load_bytes(blob).decode_at(idx)
    require(bool(np.isfinite(got).all()), "non-finite decode of the fitted payload")
    np.testing.assert_allclose(got, enc.decode_at(idx), rtol=1e-5, atol=1e-6)
    steps_per_s = steps / log.seconds_train
    emit({"phase": "fit", "dataset": FIT_DATASET, "shape": list(x.shape),
          "folded_shape": list(enc.ct.spec.folded_shape), "config": {
              k: opts[k] for k in ("rank", "hidden", "batch_size", "lr", "epochs",
                                   "reorder_warmup", "reorder_every", "reorder_samples",
                                   "entries_per_epoch", "kernel_impl")},
          "reduced": FIT_REDUCED, "tensor_seconds": tensor_s, "seconds": fit_s,
          "seconds_init_order": log.seconds_init_order, "seconds_train": log.seconds_train,
          "seconds_reorder": log.seconds_reorder,
          "seconds_fitness": fit_s - log.seconds_init_order - log.seconds_train
          - log.seconds_reorder,
          "epochs_run": log.epochs_run, "steps": steps, "steps_per_s": steps_per_s,
          "train_entries_per_s": steps_per_s * opts["batch_size"],
          "fitness_history": log.fitness_history, "loss_history": log.loss_history,
          "swaps": [[s.mode, s.pairs, s.accepted] for s in log.reorder_stats[0]]
          if log.reorder_stats else [],
          "fitness_full": full, "fitness_full_seconds": full_s, "launches": launches,
          "plain_calls": plain, "payload_bytes": len(blob),
          "payload_bytes_v_a": enc.payload_bytes()})
    return launches, log.seconds_train / steps


def fitness_parity(torch, x, opts) -> dict:
    """``compress`` twice on the card from the same seed (so the same
    initial params) on ``x`` with ``opts``: the plain versions ("ref") and
    the kernels ("auto").  The fitness histories must agree within
    ``FIT_PARITY_TOL`` at every epoch; where the accepted swaps of a mode
    differ, the mode is printed.  Returns the fields to print."""
    from repro_torch.core import codec
    from repro_torch.kernels import ops
    from repro_torch.kernels import tt_contract as _tt

    runs = {}
    for impl in ("ref", "auto"):
        ops.reset_launch_counts()
        t = time.perf_counter()
        _, log = codec.compress(x, codec.CodecConfig(**{**opts, "kernel_impl": impl}))
        torch.cuda.synchronize()
        runs[impl] = (log, time.perf_counter() - t,
                      {**ops.launch_counts(), "tt_contract_bwd_wide": _tt.wide_launches})
    (plain, plain_s, plain_launches), (kern, kern_s, launches) = runs["ref"], runs["auto"]
    require(not any(plain_launches.values()), f"the ref route launched {plain_launches}")
    require(all(launches[k] > 0 for k in ("decode_tile", "lstm_scan", "lstm_scan_bwd",
                                          "tt_contract", "tt_contract_bwd")),
            f"the auto route launched {launches}")
    require(len(kern.fitness_history) == len(plain.fitness_history),
            f"{kern.epochs_run} epochs against the ref route's {plain.epochs_run}")
    diffs = [abs(a - b) for a, b in zip(kern.fitness_history, plain.fitness_history)]
    require(max(diffs) <= FIT_PARITY_TOL,
            f"fitness histories differ by {max(diffs)} (limit {FIT_PARITY_TOL}): "
            f"{kern.fitness_history} vs {plain.fitness_history}")
    swaps = [[[s.mode, s.pairs, s.accepted] for s in stats] for stats in kern.reorder_stats]
    plain_swaps = [[[s.mode, s.pairs, s.accepted] for s in stats]
                   for stats in plain.reorder_stats]
    differ = [a[0] for sweep, psweep in zip(swaps, plain_swaps) for a, b in zip(sweep, psweep)
              if a != b]
    return {"dataset": FIT_DATASET, "shape": list(x.shape), "tolerance": FIT_PARITY_TOL,
            "fitness_auto": kern.fitness_history, "fitness_ref": plain.fitness_history,
            "max_fitness_diff": max(diffs), "loss_auto": kern.loss_history,
            "loss_ref": plain.loss_history, "swaps_auto": swaps, "swaps_ref": plain_swaps,
            "modes_whose_swaps_differ": differ, "seconds_auto": kern_s, "seconds_ref": plain_s,
            "launches_auto": launches}


def phase_fit_parity(torch, device):
    """``fitness_parity`` of the paper's MEDIUM (``fit_options``) on the mini
    PEMS-SF replica."""
    from repro_torch.data import synthetic_tensors

    x = synthetic_tensors.load(FIT_DATASET, mini=True, seed=SEED)
    emit({"phase": "fit.parity", **fitness_parity(torch, x, fit_options())})


FIT_BUDGET = 4_000_000
FIT_BUDGET_ARCH = (57, 114)          # (rank, hidden) the budget rule picks on PEMS-SF
FIT_BUDGET_EPOCHS, FIT_BUDGET_REORDER = 6, 5
FIT_BUDGET_ENTRIES = 1 << 21
FIT_BUDGET_REDUCED = [
    "epochs: 6 of the adapter's default 60, so that exactly one Alg. 3 sweep runs "
    "(reorder_warmup = reorder_every = 5)",
    "entries_per_epoch: 2^21 (128 steps of 16384) of the tensor's 61,015,680",
]
FIT_BUDGET_LOSS_RTOL = 1e-5          # one step's summed loss, kernels against the plain route


def fit_budget_step(torch, enc, x, opts):
    """One training step's loss and gradients from the fitted params on one
    batch of ``opts["batch_size"]`` entries of ``x`` (the adapter's
    positions and normalized values), through the kernels (``kernel_impl``
    "cuda": one launch of each training kernel) and through the plain
    versions ("ref": none), held together: the loss within
    ``FIT_BUDGET_LOSS_RTOL``, each leaf's gradient by ``compare_grads``."""
    import numpy as np

    from repro_torch.core import codec
    from repro_torch.optim import optimizers
    from repro_torch.kernels import ops

    ct = enc.ct
    rng = np.random.default_rng(SEED)
    pos = np.stack([rng.integers(0, n, opts["batch_size"]) for n in x.shape], axis=1)
    orig = np.stack([ct.pi[j][pos[:, j]] for j in range(x.ndim)], axis=1)
    vals = (x[tuple(orig.T)] - ct.norm_mean) / ct.norm_std
    pos_t = torch.as_tensor(pos, device=ct.device)
    vals_t = torch.as_tensor(vals.astype(np.float32), device=ct.device)
    out = {}
    for impl in ("cuda", "ref"):
        cfg = dataclasses.replace(ct.cfg, kernel_impl=impl)
        ops.reset_launch_counts()
        with codec.full_f32():
            loss, grads = codec._make_value_and_grad(ct.spec, cfg)(ct.params, pos_t, vals_t)
        torch.cuda.synchronize()
        out[impl] = (float(loss), optimizers.tree_leaves(grads), ops.launch_counts())
    (loss, grads, launches), (plain_loss, plain_grads, plain_launches) = out["cuda"], out["ref"]
    require(all(launches[k] == 1 for k in TRAIN_KERNELS),
            f"the kernels' step launched {launches}; expected one of each training kernel")
    require(not any(plain_launches.values()), f"the plain route's step launched {plain_launches}")
    require(abs(loss - plain_loss) <= FIT_BUDGET_LOSS_RTOL * abs(plain_loss),
            f"step loss {loss} vs the plain route's {plain_loss}")
    errs = compare_grads(torch, grads, plain_grads)
    return {"entries": opts["batch_size"], "loss": loss, "loss_plain": plain_loss,
            "loss_rtol": FIT_BUDGET_LOSS_RTOL, "grad_max_abs_err": max(errs),
            "grad_worst_share_of_largest": max(e / max(float(w.abs().max()), 1e-30)
                                               for e, w in zip(errs, plain_grads)),
            "launches": launches}


def fit_budget_kernels(torch, device, opts, spec):
    """The four training kernels and the fitness's decode at the budget
    fit's shapes: B 16384 (the adapter's batch), T = d' 10, H 114, R 57, K
    8 (``training_inputs``), and the decode at its fitness batch
    (``eval_batch`` 65,536 entries, T 10, M 8): CUDA events over 20
    back-to-back calls after 2 warm-ups, device time (every call here
    outlasts its host work); the ``lstm_scan`` backward's kernel alone and
    its whole call; each beside its bound and its plan or body."""
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops
    from repro_torch.kernels import tt_contract as _tt

    r, h = FIT_BUDGET_ARCH
    b, t = opts["batch_size"], spec.d_prime
    k = t - 2
    gen = torch.Generator().manual_seed(SEED)
    (x, lw, dhs), (first, mid, last, dout) = training_inputs(torch, gen, b, t, h, r, device)
    hs = ops.lstm_scan(x, *lw, impl="cuda")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tt_plan = _tt.bwd_plan(r, k, b, sms)
    be, m = opts["eval_batch"], 8
    idx, ws = decode_inputs(torch, gen, be, t, m, h, r, torch.float32, device, width_scaled=True)
    dec_bytes = be * t * 4 + be * 4 + sum(int(w.numel()) for w in ws) * 4
    rows = {
        "lstm_scan": {"body": _lstm.lstm_body(h), "tile": _lstm.simt_tile(h),
                      "ms": time_ms(torch, lambda: ops.lstm_scan(x, *lw, impl="cuda"), 20),
                      **bound(*lstm_cost(b, t, h), PEAK_FP32)},
        "lstm_scan_bwd": {"plan": dataclasses.asdict(_lstm.bwd_plan(h, b)),
                          "ms": time_ms(torch, lambda: _lstm.bwd_gates(x, *lw, hs, dhs), 20),
                          "call_ms": time_ms(torch, lambda: _lstm.lstm_scan_bwd(x, *lw, hs, dhs),
                                             20),
                          **bound(*lstm_bwd_kernel_cost(b, t, h), PEAK_FP32)},
        "tt_contract": {"body": "lane_group", "lanes_per_entry": _tt.lanes_per_entry(r),
                        "ms": time_ms(torch, lambda: ops.tt_contract(first, mid, last,
                                                                     impl="cuda"), 20),
                        **bound(b * (k * 2 * r * r + 2 * r), tt_bytes(b, k, r, 4), PEAK_FP32)},
        "tt_contract_bwd": {"plan": dataclasses.asdict(tt_plan),
                            "ms": time_ms(torch, lambda: _tt.tt_contract_bwd(first, mid, last,
                                                                            dout), 20),
                            **bound(*tt_bwd_cost(b, k, r), PEAK_FP32)},
        "decode_tile": {"body": _decode_tile.decode_body(h, r), **simt_tile(h, r),
                        "ms": time_ms(torch, lambda: ops.nttd_decode_tile(idx, *ws, impl="cuda"),
                                      20),
                        **bound(decode_cost(be, t, h, r), dec_bytes, PEAK_FP32)},
    }
    for row in rows.values():
        row["bound_share"] = row["bound_ms"] / row["ms"]
    rows["lstm_scan_bwd"]["note"] = ("ms: the kernel alone (bwd_gates); call_ms: the wrapper, "
                                     "with the weight gradients' product")
    return {"shape": {"B": b, "T": t, "H": h, "R": r, "K": k, "decode_B": be, "decode_M": m},
            "kernels": rows}


def phase_fit_budget(torch, device):
    """The budget-driven fit at its wide pick, on the card: ``get_codec(
    "nttd").fit(x, budget=FIT_BUDGET)`` on the PEMS-SF replica at its Table
    II shape, the adapter's defaults (batch 16384, lr 5e-3, TSP init, Alg.
    3) cut in depth only (``FIT_BUDGET_REDUCED``).  The rule picks rank 57,
    hidden 114 (d' 10, so K 8), where the training step runs the simt
    ``lstm_scan`` forward, the ``lstm_scan`` backward's wide plan,
    ``tt_contract`` at R 57 and the ``tt_contract`` backward's wide plan,
    and the fitness the simt decode.  Every step must launch each training
    kernel once and no plain version may run; the payload must be within
    the budget, load, and answer ``decode_at`` as fitted and as the plain
    route on the card (rtol = atol = 1e-5); one step from the fitted params
    must give the plain route's loss and gradients (``fit_budget_step``).
    Prints the seconds by part, steps/s, the fitness, the launches with
    each kernel's plan or body, and the kernels' times at this fit's shapes
    (``fit_budget_kernels``).  Returns the phase's launches."""
    import numpy as np

    from repro_torch.codecs import get_codec, load_bytes
    from repro_torch.codecs.adapters import NTTDEncoded
    from repro_torch.core.codec import CodecConfig
    from repro_torch.data import synthetic_tensors
    from repro_torch.kernels import decode_tile as _decode_tile
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tt_contract as _tt

    t0 = time.perf_counter()
    x = synthetic_tensors.load(FIT_DATASET, mini=False, seed=SEED)
    tensor_s = time.perf_counter() - t0
    require(x.shape == PEMS_SHAPE, f"the {FIT_DATASET} replica has shape {x.shape}")
    opts = dict(epochs=FIT_BUDGET_EPOCHS, reorder_warmup=FIT_BUDGET_REORDER,
                reorder_every=FIT_BUDGET_REORDER, entries_per_epoch=FIT_BUDGET_ENTRIES)
    codec = get_codec("nttd")
    rank = codec._rank_for_budget(x.shape, FIT_BUDGET, opts)
    require((rank, 2 * rank) == FIT_BUDGET_ARCH,
            f"the budget rule picks rank {rank} at {FIT_BUDGET} bytes, not {FIT_BUDGET_ARCH[0]}")
    with plain_calls_counted(ref) as plain:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        enc = codec.fit(x, budget=FIT_BUDGET, **opts)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
        launches = ops.launch_counts()
        simt = {"decode_tile": _decode_tile.simt_launches, "lstm_scan": _lstm.simt_launches,
                "tt_contract_bwd": _tt.wide_launches}
    cfg = CodecConfig(**opts)
    ct, log = enc.ct, enc.log
    require(ct.device.type == "cuda", "the fit did not run on the card")
    require((ct.cfg.rank, ct.cfg.hidden, ct.spec.d_prime) == (*FIT_BUDGET_ARCH, 10),
            f"the fit ran at rank {ct.cfg.rank}, hidden {ct.cfg.hidden}, d' {ct.spec.d_prime}")
    require(cfg.kernel_impl == "auto" and (cfg.batch_size, cfg.lr) == (16384, 5e-3)
            and cfg.init_reorder and cfg.update_reorder,
            f"the adapter's defaults moved: {cfg}")
    require(sum(plain.values()) == 0, f"plain versions ran on the budget fit's path: {plain}")
    steps = FIT_BUDGET_ENTRIES // cfg.batch_size * log.epochs_run
    train = {k: launches[k] for k in TRAIN_KERNELS}
    require(set(train.values()) == {steps},
            f"{steps} training steps launched {train}; expected one of each a step")
    require(simt["lstm_scan"] == launches["lstm_scan"]
            and simt["decode_tile"] == launches["decode_tile"] >= log.epochs_run
            and simt["tt_contract_bwd"] == launches["tt_contract_bwd"],
            f"the simt bodies and the wide backward plan ran {simt} of {launches}")
    require(len(log.reorder_stats) == 1, f"{len(log.reorder_stats)} Alg. 3 sweeps")
    require(all(math.isfinite(v) for v in log.fitness_history + log.loss_history),
            "non-finite fitness or loss")
    # what comes out: within the budget, reloaded intact, as the plain route
    payload = enc.payload_bytes()
    require(payload <= FIT_BUDGET, f"payload {payload} bytes beyond the budget {FIT_BUDGET}")
    blob = enc.save()
    idx = np.stack([np.random.default_rng(SEED).integers(0, n, REQUEST) for n in PEMS_SHAPE],
                   axis=1)
    loaded = load_bytes(blob)
    got = loaded.decode_at(idx)
    require(bool(np.isfinite(got).all()), "non-finite decode of the fitted payload")
    np.testing.assert_allclose(got, enc.decode_at(idx), rtol=1e-5, atol=1e-5)
    want = _with_impl(loaded, "ref", NTTDEncoded).decode_at(idx)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    step = fit_budget_step(torch, enc, x, dataclasses.asdict(cfg))
    kernels = fit_budget_kernels(torch, device, dataclasses.asdict(cfg), ct.spec)
    seconds_fitness = fit_s - log.seconds_init_order - log.seconds_train - log.seconds_reorder
    emit({"phase": "fit_budget", "dataset": FIT_DATASET, "shape": list(x.shape),
          "budget": FIT_BUDGET, "rank": ct.cfg.rank, "hidden": ct.cfg.hidden,
          "d_prime": ct.spec.d_prime, "folded_shape": list(ct.spec.folded_shape),
          "config": {k: getattr(cfg, k) for k in (
              "batch_size", "lr", "epochs", "reorder_warmup", "reorder_every",
              "reorder_samples", "entries_per_epoch", "eval_batch", "kernel_impl")},
          "reduced": FIT_BUDGET_REDUCED, "tensor_seconds": tensor_s, "seconds": fit_s,
          "seconds_by_part": {"tsp_init": log.seconds_init_order, "training": log.seconds_train,
                              "alg3": log.seconds_reorder, "fitness": seconds_fitness},
          "epochs_run": log.epochs_run, "steps": steps, "steps_per_s": steps / log.seconds_train,
          "fitness_history": log.fitness_history, "loss_history": log.loss_history,
          "fitness_reached": max(log.fitness_history),
          "payload_bytes_v_a": payload, "saved_bytes": len(blob),
          "launches": launches, "simt_launches": simt, "plain_calls": plain,
          "bodies": {"lstm_scan": _lstm.lstm_body(ct.cfg.hidden),
                     "lstm_scan_bwd": _lstm.bwd_plan(ct.cfg.hidden, cfg.batch_size).kind,
                     "tt_contract": "lane_group",
                     "tt_contract_bwd": kernels["kernels"]["tt_contract_bwd"]["plan"]["kind"],
                     "decode_tile": _decode_tile.decode_body(ct.cfg.hidden, ct.cfg.rank)},
          "step_parity": step, "max_abs_err_decode": float(np.abs(got - want).max())})
    emit({"phase": "timing.fit_budget", **kernels})
    # the fitness of each epoch against the plain route at this width, on
    # the mini replica folded to the same d' (K 8)
    parity = fitness_parity(torch, synthetic_tensors.load(FIT_DATASET, mini=True, seed=SEED),
                            {**opts, "rank": ct.cfg.rank, "hidden": ct.cfg.hidden,
                             "d_prime": ct.spec.d_prime})
    require(parity["launches_auto"]["tt_contract_bwd_wide"]
            == parity["launches_auto"]["tt_contract_bwd"],
            f"the parity fit's backward ran outside the wide plan: {parity['launches_auto']}")
    emit({"phase": "fit_budget.parity", "rank": ct.cfg.rank, "hidden": ct.cfg.hidden,
          "d_prime": ct.spec.d_prime, **parity})
    return {**launches, "decode_tile_simt": simt["decode_tile"],
            "lstm_scan_simt": simt["lstm_scan"], "tt_contract_bwd_wide": simt["tt_contract_bwd"]}


class TimedSource:
    """A slab source whose ``slab_at`` adds its host seconds to ``seconds``
    (the source values' share of a streaming run)."""

    def __init__(self, source):
        self.source, self.seconds = source, 0.0
        self.shape, self.n_slabs = source.shape, source.n_slabs

    def slab_at(self, cursor):
        t = time.perf_counter()
        slab = self.source.slab_at(cursor)
        self.seconds += time.perf_counter() - t
        return slab


def stream_heldout(source):
    """``sample_heldout`` of a few whole slabs (the tensor is never
    materialised): flat indices into the tensor and their exact values."""
    import numpy as np

    from repro_torch.stream import sample_heldout

    cursors, n = STREAM_HELDOUT
    parts = [sample_heldout(source.slab_at(c).values, n=n, seed=c) for c in cursors]
    return (np.concatenate([idx + c * source.slab_entries for c, (idx, _) in zip(cursors, parts)]),
            np.concatenate([vals for _, vals in parts]))


def sampled_fitness(source, enc, n, seed) -> float:
    """1 - ||x - x_hat|| / ||x|| over ``n`` entries drawn from ``seed``,
    the truth from the source's ``values_at``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, n) for s in source.shape], axis=1)
    truth = source.values_at(idx).astype(np.float64)
    err = np.asarray(enc.decode_at(idx), np.float64) - truth
    return 1.0 - float(np.linalg.norm(err)) / max(float(np.linalg.norm(truth)), 1e-30)


def phase_stream(torch, device, smi, workdir):
    """The reference's fig5 FULL streaming run at full size on the card:
    ``fit_stream("nttd", ...)`` over 2^26 synthetic entries in 256 slabs,
    the tensor never materialised.  Every step must launch the forward and
    backward ``lstm_scan`` and ``tt_contract`` kernels once and no plain
    version may run.  The payload is written by ``write_chunked`` with a
    held-out sample, read back onto the card, and must answer as fitted
    through the fused decode; its decode must correlate with the truth
    above ``STREAM_CORR_MIN``.  A second fitter, resumed at slab 128, must
    give the same bytes.  Returns the phase's launches (fit, write and
    read), its seconds a step and the written file's path (in ``workdir``,
    which phase ``service`` serves)."""
    import numpy as np

    from repro_torch.codecs import get_codec, load_file, save_bytes
    from repro_torch.codecs.container import open_container
    from repro_torch.kernels import ops, ref
    from repro_torch.stream import SyntheticTensorSource, fit_stream, write_chunked

    source = SyntheticTensorSource(STREAM_SHAPE, slab_entries=STREAM_SLAB,
                                   seed=STREAM_SOURCE_SEED)
    timed = TimedSource(source)
    fitter = get_codec("nttd").stream_fitter(source.shape, **STREAM_OPTS)
    require(fitter.device.type == "cuda" and fitter.cfg.kernel_impl == "auto",
            f"the stream fitter runs {fitter.cfg.kernel_impl!r} on {fitter.device}")
    steps = source.n_slabs * STREAM_OPTS["steps_per_slab"]
    rng = np.random.default_rng(SEED)
    idx = np.stack([rng.integers(0, n, REQUEST) for n in STREAM_SHAPE], axis=1)
    corr_idx = np.stack([rng.integers(0, n, STREAM_CORR_ENTRIES) for n in STREAM_SHAPE], axis=1)
    with plain_calls_counted(ref) as plain:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        enc = fit_stream("nttd", timed, fitter=fitter)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        drain_s = time.perf_counter() - t1
        fit_launches = ops.launch_counts()
        # write and read back: a chunked v3 file with held-out truth
        t = time.perf_counter()
        heldout = stream_heldout(source)
        heldout_s = time.perf_counter() - t
        path = os.path.join(workdir, "stream.tcdc")
        t = time.perf_counter()
        file_bytes = write_chunked(path, enc, chunk_bytes=STREAM_CHUNK_BYTES, heldout=heldout)
        write_s = time.perf_counter() - t
        oc = open_container(path)
        try:
            n_chunks, got_heldout = len(oc.chunks), oc.heldout
        finally:
            oc.close()
        t = time.perf_counter()
        back = load_file(path, device=device)
        served = back.decode_at(idx)
        read_s = time.perf_counter() - t
        direct = enc.decode_at(idx)
        heldout_pos = np.stack(np.unravel_index(heldout[0], STREAM_SHAPE), axis=1)
        heldout_corr = float(np.corrcoef(back.decode_at(heldout_pos), heldout[1])[0, 1])
        t = time.perf_counter()
        truth = source.values_at(corr_idx)
        corr = float(np.corrcoef(truth, back.decode_at(corr_idx))[0, 1])
        corr_s = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    require(sum(plain.values()) == 0, f"plain versions ran on the stream path: {plain}")
    train = {k: fit_launches[k] for k in ("lstm_scan", "lstm_scan_bwd", "tt_contract",
                                          "tt_contract_bwd")}
    require(set(train.values()) == {steps} and fit_launches["decode_tile"] == 0,
            f"{steps} stream steps launched {fit_launches}; expected one of each a step")
    # four fused requests: the read-back, the fitted payload, the held-out
    # entries and the correlation sample; no training kernel after the fit
    require(launches["decode_tile"] == 4 and {k: launches[k] for k in train} == train,
            f"the write and read-back launched {launches} after the fit's {fit_launches}")
    require(bool(torch.isfinite(fitter.loss)), "non-finite loss in the last slab")
    require(back.ct.device.type == "cuda", "the stream payload did not load onto the card")
    np.testing.assert_array_equal(got_heldout.indices, heldout[0])
    np.testing.assert_array_equal(got_heldout.values, heldout[1])
    np.testing.assert_array_equal(source.values_at(heldout_pos), heldout[1])  # the truth
    require(bool(np.isfinite(served).all()), "non-finite decode of the stream payload")
    np.testing.assert_array_equal(served, direct)
    require(corr > STREAM_CORR_MIN, f"stream payload correlation {corr} <= {STREAM_CORR_MIN}")

    # resume: slabs [0, 128) and then [128, 256) on a second fitter
    half = source.n_slabs // 2
    t = time.perf_counter()
    resumed_fitter = get_codec("nttd").stream_fitter(source.shape, **STREAM_OPTS)
    fit_stream("nttd", source, stop=half, fitter=resumed_fitter)
    resumed = fit_stream("nttd", source, start=half, fitter=resumed_fitter)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t
    blob = save_bytes(enc)
    require(save_bytes(resumed) == blob, "the resumed stream fit's bytes differ from the "
            "uninterrupted run's")
    n = source.n_entries
    emit({"phase": "stream", "shape": list(STREAM_SHAPE), "entries": n,
          "slab_entries": STREAM_SLAB, "slabs": source.n_slabs, "steps": steps,
          "folded_shape": list(enc.ct.spec.folded_shape), "config": STREAM_OPTS,
          "source": f"SyntheticTensorSource seed {STREAM_SOURCE_SEED}",
          "reduced": [], "changed": STREAM_CHANGED, "seconds": fit_s,
          "seconds_by_part": {"source_values": timed.seconds,
                              "host_sampling": fitter.seconds["sampling"],
                              "training_dispatch": fitter.seconds["training"],
                              "device_drain": drain_s,
                              "reservoir": fitter.seconds["reservoir"],
                              "heldout_sample": heldout_s, "write": write_s,
                              "read_and_request": read_s, "correlation": corr_s},
          "slabs_per_s": source.n_slabs / fit_s, "steps_per_s": steps / fit_s,
          "entries_per_s": n / fit_s, "correlation": corr,
          "correlation_entries": STREAM_CORR_ENTRIES, "heldout_entries": len(heldout[0]),
          "heldout_correlation": heldout_corr, "payload_bytes": len(blob),
          "payload_bytes_v_a": enc.payload_bytes(), "file_bytes": file_bytes,
          "chunks": n_chunks, "request_entries": REQUEST,
          "resumed_at_slab": half, "resume_identical": True, "resume_seconds": resume_s,
          "launches_fit": fit_launches, "launches": launches, "plain_calls": plain,
          "name_power_limit": smi})
    return launches, fit_s / steps, path


def stream_step_timing(torch, device, step_s):
    """The four training kernels at a step of the stream (``STREAM_STEP``:
    B 8192, T 14, H 12, R 6, K 12) on ``training_inputs``' operands, with
    CUDA events like every row, each beside its bound, and the stream
    phase's seconds a step (its whole fit over its steps)."""
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops
    from repro_torch.kernels import tt_contract as _tt

    b, t, h, r = STREAM_STEP
    k = t - 2
    gen = torch.Generator().manual_seed(SEED)
    (x, lw, dhs), (first, mid, last, dout) = training_inputs(torch, gen, b, t, h, r, device)
    hs = ops.lstm_scan(x, *lw, impl="cuda")
    ms = {"lstm_scan": time_ms(torch, lambda: ops.lstm_scan(x, *lw, impl="cuda"), 20),
          "lstm_scan_bwd": time_ms(torch, lambda: _lstm.lstm_scan_bwd(x, *lw, hs, dhs), 20),
          "tt_contract": time_ms(torch, lambda: ops.tt_contract(first, mid, last, impl="cuda"),
                                 20),
          "tt_contract_bwd": time_ms(torch, lambda: _tt.tt_contract_bwd(first, mid, last, dout),
                                     20)}
    bounds = {"lstm_scan": bound(*lstm_cost(b, t, h), PEAK_FP32),
              "lstm_scan_bwd": bound(*lstm_bwd_cost(b, t, h), PEAK_FP32),
              "tt_contract": bound(b * (k * 2 * r * r + 2 * r), tt_bytes(b, k, r, 4), PEAK_FP32),
              "tt_contract_bwd": bound(*tt_bwd_cost(b, k, r), PEAK_FP32)}
    kernel_ms = sum(ms.values())
    emit({"phase": "timing.stream_step", "shape": {"B": b, "T": t, "H": h, "R": r, "K": k},
          "ms": ms, "bounds": bounds, "kernels_ms": kernel_ms, "step_ms": step_s * 1e3,
          "kernels_share_of_step": kernel_ms / (step_s * 1e3)})


def phase_stream_parity(torch, device):
    """Both routes, "ref" (the plain versions) and "auto" (the kernels),
    from the same seed over the first ``STREAM_PARITY_SLABS`` slabs of the
    stream's source: every param within ``STREAM_PARITY_RTOL`` /
    ``STREAM_PARITY_ATOL``, and their sampled fitness within
    ``FIT_PARITY_TOL``."""
    from repro_torch.codecs import get_codec
    from repro_torch.kernels import ops
    from repro_torch.stream import SyntheticTensorSource, fit_stream

    source = SyntheticTensorSource(STREAM_SHAPE, slab_entries=STREAM_SLAB,
                                   seed=STREAM_SOURCE_SEED)
    runs = {}
    for impl in ("ref", "auto"):
        fitter = get_codec("nttd").stream_fitter(source.shape, **STREAM_OPTS, kernel_impl=impl)
        ops.reset_launch_counts()
        t = time.perf_counter()
        enc = fit_stream("nttd", source, stop=STREAM_PARITY_SLABS, fitter=fitter)
        torch.cuda.synchronize()
        runs[impl] = (fitter, enc, time.perf_counter() - t, ops.launch_counts())
    (plain, plain_enc, plain_s, plain_launches) = runs["ref"]
    (kern, kern_enc, kern_s, launches) = runs["auto"]
    require(not any(plain_launches.values()), f"the ref route launched {plain_launches}")
    steps = STREAM_PARITY_SLABS * STREAM_OPTS["steps_per_slab"]
    require(launches["lstm_scan_bwd"] == launches["tt_contract_bwd"] == steps,
            f"the auto route launched {launches} in {steps} steps")
    diffs = {}
    worst = 0.0
    for (key, got), (_, want) in zip(_param_leaves(kern.params), _param_leaves(plain.params)):
        excess = ((got - want).abs() - STREAM_PARITY_ATOL
                  - STREAM_PARITY_RTOL * want.abs()).max().item()
        diffs[key] = float((got - want).abs().max())
        worst = max(worst, excess)
    fit_auto = sampled_fitness(source, kern_enc, STREAM_PARITY_ENTRIES, SEED)
    fit_ref = sampled_fitness(source, plain_enc, STREAM_PARITY_ENTRIES, SEED)
    emit({"phase": "stream.parity", "slabs": STREAM_PARITY_SLABS, "steps": steps,
          "rtol": STREAM_PARITY_RTOL, "atol": STREAM_PARITY_ATOL,
          "max_abs_param_diff": diffs, "worst_excess_over_tolerance": worst,
          "fitness_auto": fit_auto, "fitness_ref": fit_ref,
          "fitness_entries": STREAM_PARITY_ENTRIES, "fitness_tolerance": FIT_PARITY_TOL,
          "seconds_auto": kern_s, "seconds_ref": plain_s, "launches_auto": launches})
    require(worst <= 0, f"stream params differ beyond rtol {STREAM_PARITY_RTOL} / atol "
            f"{STREAM_PARITY_ATOL}: {diffs}")
    require(abs(fit_auto - fit_ref) <= FIT_PARITY_TOL,
            f"sampled fitness {fit_auto} (auto) against {fit_ref} (ref)")


def _param_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _param_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def phase_stream_delta(torch, device, workdir):
    """A delta chain on the card: a keyframe from ``fit_stream`` at
    ``STREAM_DELTA_SHAPE``, two residuals (``STREAM_DELTA_SCALE`` times the
    sources of ``STREAM_DELTA_SEEDS``) fitted by one ``DeltaFitter``, written
    by the delta-mode ``ChunkedWriter`` with a ``sync`` after each version.
    Read back on the card the file is a ``ChainEncoded`` whose answers are
    the f64 sum of its components', each decoded by one fused launch.
    Returns the file's path (in ``workdir``)."""
    import numpy as np

    from repro_torch.codecs import load_file
    from repro_torch.kernels import ops, ref
    from repro_torch.stream import ChunkedWriter, SyntheticTensorSource, fit_stream
    from repro_torch.temporal import ChainEncoded, DeltaFitter

    t0 = time.perf_counter()
    key_source = SyntheticTensorSource(STREAM_DELTA_SHAPE, slab_entries=STREAM_SLAB,
                                       seed=STREAM_SOURCE_SEED)
    keyframe = fit_stream("nttd", key_source, **STREAM_OPTS)
    fitter = DeltaFitter(STREAM_DELTA_SHAPE, "nttd", slab_entries=1 << 16,
                         opts=STREAM_DELTA_OPTS)
    parts = [keyframe]
    for seed in STREAM_DELTA_SEEDS:
        src = SyntheticTensorSource(STREAM_DELTA_SHAPE, slab_entries=STREAM_SLAB, seed=seed)
        dense = np.concatenate([s.values for s in src.iter_slabs()]).reshape(STREAM_DELTA_SHAPE)
        parts.append(fitter.fit_residual(STREAM_DELTA_SCALE * dense))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    idx = np.stack([rng.integers(0, n, REQUEST) for n in STREAM_DELTA_SHAPE], axis=1)
    path = os.path.join(workdir, "delta.tcdc")
    synced = []
    with ChunkedWriter(path, "nttd", delta=True) as w:
        for v, enc in enumerate(parts):
            w.begin_version(v - 1)
            body = enc.to_bytes()
            for at in range(0, len(body), STREAM_CHUNK_BYTES):
                w.append(body[at:at + STREAM_CHUNK_BYTES])
            synced.append(w.sync())
    chain = load_file(path, device=device)
    require(isinstance(chain, ChainEncoded) and len(chain.components) == len(parts),
            f"the delta file read back as {type(chain).__name__}")
    require(all(c.ct.device.type == "cuda" and c.ct.cfg.kernel_impl == "auto"
                for c in chain.components), "a chain component is not on the card's decode")
    with plain_calls_counted(ref) as plain:
        ops.reset_launch_counts()
        got = chain.decode_at(idx)
        launches = ops.launch_counts()
    require(sum(plain.values()) == 0 and launches["decode_tile"] == len(parts),
            f"the chain's request launched {launches}, plain {plain}")
    want = np.zeros(REQUEST)
    for c in chain.components:
        want += np.asarray(c.decode_at(idx), np.float64)
    np.testing.assert_array_equal(got, want)
    fitted = sum(np.asarray(p.decode_at(idx), np.float64) for p in parts)
    np.testing.assert_allclose(got, fitted, rtol=1e-6, atol=1e-7)
    emit({"phase": "stream.delta", "shape": list(STREAM_DELTA_SHAPE),
          "keyframe": STREAM_OPTS, "delta": STREAM_DELTA_OPTS,
          "residuals": [f"{STREAM_DELTA_SCALE} x SyntheticTensorSource seed {s}"
                        for s in STREAM_DELTA_SEEDS],
          "versions": len(parts), "bytes_after_each_sync": synced,
          "component_bytes": [len(p.to_bytes()) for p in parts], "fit_seconds": fit_s,
          "max_abs_vs_fitted": float(np.abs(got - fitted).max()),
          "request_entries": REQUEST, "launches": launches})
    return path


def service_pems_file(enc, workdir):
    """Phase main's PEMS-SF payload as a chunked v3 file of
    ``SERVICE_CHUNKS`` chunks, with a held-out block of ``SERVICE_HELDOUT``
    entries whose values are the plain route's decode."""
    import numpy as np

    from repro_torch.codecs.adapters import NTTDEncoded
    from repro_torch.stream import write_chunked

    rng = np.random.default_rng(SEED + 7)
    flat = np.sort(rng.choice(int(np.prod(PEMS_SHAPE)), SERVICE_HELDOUT, replace=False))
    pos = np.stack(np.unravel_index(flat, PEMS_SHAPE), axis=1)
    truth = _with_impl(enc, "ref", NTTDEncoded).decode_at(pos).astype(np.float64)
    path = os.path.join(workdir, "pems.tcdc")
    chunk = -(-len(enc.to_bytes()) // SERVICE_CHUNKS)
    return path, write_chunked(path, enc, chunk_bytes=chunk, heldout=(flat.astype(np.int64),
                                                                        truth))


def service_store(torch, smi, workdir):
    """A ``VersionedStore`` written on the card at fig10's NTTD settings:
    the keyframe fitted by ``compress`` and seven residuals by one
    ``DeltaFitter``, both on the default device through the training
    kernels, forward and backward; no plain version may run.  Returns the
    file's path and the launches of the writing."""
    import numpy as np

    from repro_torch.kernels import ops, ref
    from repro_torch.temporal import VersionedStore, drifting_versions

    data = drifting_versions(STORE_SHAPE, STORE_VERSIONS, **STORE_DRIFT)
    path = os.path.join(workdir, "store.tcdc")
    appends = []
    with plain_calls_counted(ref) as plain:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with VersionedStore.create(path, "nttd", keyframe_interval=STORE_KEYFRAME_INTERVAL,
                                   chunk_bytes=STORE_CHUNK_BYTES,
                                   keyframe_opts=STORE_KEYFRAME_OPTS,
                                   delta_opts=STORE_DELTA_OPTS, delta_passes=2) as store:
            for x in data:
                t = time.perf_counter()
                stats = store.append(x)  # ends in a host read: the fitness
                appends.append({**stats, "seconds": time.perf_counter() - t})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
    require(sum(plain.values()) == 0, f"plain versions ran writing the store: {plain}")
    for name in ("decode_tile", "lstm_scan", "lstm_scan_bwd", "tt_contract", "tt_contract_bwd"):
        require(launches[name] > 0, f"{name} was not launched writing the store: {launches}")
    require(all(np.isfinite(a["fitness"]) for a in appends), f"store appends {appends}")
    emit({"phase": "service.store", "shape": list(STORE_SHAPE), "versions": STORE_VERSIONS,
          "keyframe_interval": STORE_KEYFRAME_INTERVAL, "drift": STORE_DRIFT,
          "keyframe": STORE_KEYFRAME_OPTS, "delta": STORE_DELTA_OPTS,
          "source": "benchmarks/fig10_temporal.py:120-131 (the NTTD cell, default mode)",
          "appends": appends, "seconds": seconds, "file_bytes": os.path.getsize(path),
          "launches": launches, "plain_calls": plain, "name_power_limit": smi})
    return path, launches


def service_traffic():
    """The requests of one pass, drawn once from a seed."""
    import numpy as np

    rng = np.random.default_rng(SEED + 23)

    def uniform(shape, n):
        return np.stack([rng.integers(0, s, n) for s in shape], axis=1)

    def flat_range(lo, hi, n):
        return np.stack(np.unravel_index(rng.integers(lo, hi, n), PEMS_SHAPE), axis=1)

    first, tiles, n_window = SERVICE_WINDOW
    t = SERVICE_TILE
    sweep_lo = (first + tiles) * t
    return {
        "direct": [uniform(PEMS_SHAPE, REQUEST) for _ in range(SERVICE_DIRECT)],
        "window": [flat_range(first * t, (first + tiles) * t, REQUEST) for _ in range(n_window)],
        "sweep": flat_range(sweep_lo, sweep_lo + SERVICE_SWEEP_TILES * t, REQUEST),
        "submits": [uniform(PEMS_SHAPE, SERVICE_SUBMITS[1]) for _ in range(SERVICE_SUBMITS[0])],
        "delta": uniform(STREAM_DELTA_SHAPE, REQUEST),
        "store": uniform(STORE_SHAPE, REQUEST),
        "fig5": [uniform(STREAM_SHAPE, REQUEST) for _ in range(SERVICE_FIG5_REQUESTS)],
    }


def payload_device_bytes(svc) -> int:
    """Device bytes the service's materialized NTTD payloads hold: their
    params and, once built, the fused decode's operands (each storage once:
    an operand already in its layout is the param itself)."""
    storages = {}
    encs = [sp.enc for sp in svc._streams.values() if sp.enc is not None]
    encs += [e for sp in svc._streams.values() for e in sp.vencs.values()]
    for enc in encs:
        tensors = [t for _, t in _param_leaves(enc.ct.params)]
        tensors += list(enc.ct.__dict__.get("decode_operands", ()))
        for t in tensors:
            if t.is_cuda:
                storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(storages.values())


def service_pass(torch, paths, traffic, prefetch):
    """One pass of the traffic through a fresh ``CodecService`` on the
    card.  Returns the answers, the request ms, the stats, the device memory
    checks and the predicted ``decode_tile`` launches."""
    import gc

    import numpy as np

    from repro_torch.serve.codec_service import CodecService

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    svc = CodecService(cache_bytes=SERVICE_CACHE_BYTES, prefetch=prefetch, **SERVICE_CANARY)
    require(svc.device.type == "cuda", f"the service runs on {svc.device}")
    answers, ms, resident, memory = {}, {}, [], {}

    def ask(label, name, idx, version=None):
        t = time.perf_counter()
        answers[label] = svc.decode_at(name, idx, version=version)
        ms[label] = (time.perf_counter() - t) * 1e3
        resident.append(svc.cache_stats.resident_bytes)

    def held(label):  # device memory is what the materialized payloads hold
        gc.collect()
        memory[label] = (torch.cuda.memory_allocated() - base, payload_device_bytes(svc))

    svc.load_stream("pems", paths["pems"])
    svc.load_stream("pems_tiled", paths["pems"], tile_entries=SERVICE_TILE)
    for name in ("delta", "store", "fig5"):
        svc.load_stream(name, paths[name])
    for i, idx in enumerate(traffic["direct"]):
        ask(f"direct{i}", "pems", idx)
    for i, idx in enumerate(traffic["window"]):
        ask(f"window{i}", "pems_tiled", idx)
    held("before_sweep")
    ask("sweep", "pems_tiled", traffic["sweep"])
    held("after_sweep")
    t = time.perf_counter()
    tickets = [svc.submit("pems", idx) for idx in traffic["submits"]]
    out = svc.flush()
    ms["flush"] = (time.perf_counter() - t) * 1e3
    require(not svc.failed, f"flush failed: {svc.failed}")
    answers["flush"] = np.concatenate([out[k] for k in tickets])
    for name in ("delta", "store"):
        for v in range(svc.info(name).n_versions):
            ask(f"{name}_v{v}", name, traffic[name], v)
    for i, idx in enumerate(traffic["fig5"]):
        ask(f"fig5_{i}", "fig5", idx)
    held("after_queries")
    on_card = [sp.enc.ct.device.type for sp in svc._streams.values() if sp.enc is not None]
    on_card += [e.ct.device.type for sp in svc._streams.values() for e in sp.vencs.values()]
    stats = {"cache": svc.cache_stats.as_dict(),
             "info": {n: dataclasses.asdict(svc.info(n)) for n in svc.payloads()},
             "canary": svc.canary_stats(), "metrics": svc.metrics.as_dict()}
    checks = sum(c["value"] for c in stats["metrics"]["counters"] if c["name"] == "canary_checks")
    predicted = sum(i["decode_calls"] for i in stats["info"].values()) + checks
    for name in svc.payloads():
        svc.unload(name)
        held(f"unload_{name}")
    torch.cuda.synchronize()
    return {"answers": answers, "ms": ms, "stats": stats, "resident": resident,
            "memory": memory, "on_card": on_card, "predicted_decode_tile": predicted,
            "canary_checks": checks}


def service_summary(run) -> dict:
    """The timing and cache numbers of a pass, for the phase's line."""
    import numpy as np

    ms, cache = run["ms"], run["stats"]["cache"]
    n_window = SERVICE_WINDOW[2]
    return {
        "direct_ms": [ms[f"direct{i}"] for i in range(SERVICE_DIRECT)],
        "direct_ms_median": float(np.median([ms[f"direct{i}"] for i in range(SERVICE_DIRECT)])),
        "tiled_miss_ms": ms["window0"],
        "tiled_hit_ms_median": float(np.median([ms[f"window{i}"] for i in range(1, n_window)])),
        "sweep_ms": ms["sweep"], "flush_ms": ms["flush"],
        "versioned_ms": {k: v for k, v in ms.items() if k.startswith(("delta", "store"))},
        "fig5_ms": [ms[f"fig5_{i}"] for i in range(SERVICE_FIG5_REQUESTS)],
        "hits": cache["hits"], "misses": cache["misses"], "evictions": cache["evictions"],
        "hit_ratio": cache["hits"] / max(cache["hits"] + cache["misses"], 1),
        "resident_bytes_max": max(run["resident"]), "resident_bytes_end": run["resident"][-1],
        "device_bytes": run["memory"],
    }


def phase_service(torch, device, smi, enc, workdir, stream_path, delta_path):
    """``CodecService`` on the card (ROADMAP A.5): phase main's PEMS-SF
    payload as a lazily loaded chunked v3 file, direct and through 256 KiB
    decode tiles under a 64 MiB budget, coalesced submits, every version of
    phase stream.delta's v4 file and of a ``VersionedStore`` written here,
    and canaries on phase stream's fig5 file.  The traffic runs with
    prefetch off, on, with tracing on, and once through the plain route
    (``REPRO_DECODE_IMPL=ref``): the first three bitwise equal in answers
    and stats, the plain pass within ``SERVICE_TOL``.  The first pass must
    launch ``decode_tile`` exactly once per counted decode call and canary
    check and run no plain version; every materialized payload is on the
    card; evictions happen and resident bytes stay within the budget; device
    memory is at every check what the materialized payloads hold, within
    ``SERVICE_MEM_SLACK``, and back to the baseline after the last unload.
    Returns the first pass's launches and the store's."""
    import json

    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels import ops, ref
    from repro_torch.temporal import VersionedReader

    t0 = time.perf_counter()
    pems_path, pems_bytes = service_pems_file(enc, workdir)
    store_path, store_launches = service_store(torch, smi, workdir)
    paths = {"pems": pems_path, "fig5": stream_path, "delta": delta_path, "store": store_path}
    traffic = service_traffic()
    setup_s = time.perf_counter() - t0

    obs.clear_events()
    with plain_calls_counted(ref) as plain:
        ops.reset_launch_counts()
        runs = {"prefetch_off": service_pass(torch, paths, traffic, prefetch=False)}
        launches = ops.launch_counts()
    breaches = obs.events("quality_breach")
    require(sum(plain.values()) == 0, f"plain versions ran in the service pass: {plain}")
    first = runs["prefetch_off"]
    require(launches["decode_tile"] == first["predicted_decode_tile"],
            f"decode_tile launched {launches['decode_tile']} times; the rule "
            f"(decode calls + canary checks) predicts {first['predicted_decode_tile']}")
    runs["prefetch_on"] = service_pass(torch, paths, traffic, prefetch=True)
    rec = obs.enable_tracing(capacity=1 << 17)
    rec.clear()
    try:
        runs["tracing_on"] = service_pass(torch, paths, traffic, prefetch=False)
        spans = rec.snapshot()
        trace_path = os.path.join(workdir, "service_trace.json")
        n_spans = obs.export_chrome_trace(trace_path)
    finally:
        obs.disable_tracing()
        rec.clear()
    os.environ["REPRO_DECODE_IMPL"] = "ref"
    try:
        plain_run = service_pass(torch, paths, traffic, prefetch=False)
    finally:
        os.environ.pop("REPRO_DECODE_IMPL")

    for key, run in runs.items():
        require(all(d == "cuda" for d in run["on_card"]) and run["on_card"],
                f"{key}: materialized payloads on {run['on_card']}")
        cache = run["stats"]["cache"]
        require(cache["evictions"] > 0, f"{key}: no eviction under the budget")
        require(max(run["resident"]) <= SERVICE_CACHE_BYTES, f"{key}: resident bytes "
                f"{max(run['resident'])} above the budget")
        for label, (allocated, payloads) in run["memory"].items():
            require(abs(allocated - payloads) <= SERVICE_MEM_SLACK,
                    f"{key} {label}: {allocated} device bytes allocated, payloads hold "
                    f"{payloads}")
        last = [v for k, v in run["memory"].items() if k.startswith("unload_")][-1]
        require(last[0] <= SERVICE_MEM_SLACK, f"{key}: {last[0]} bytes left after unloads")
        if key != "prefetch_off":  # observational: bitwise the first pass
            require(run["answers"].keys() == first["answers"].keys(), key)
            for label, got in run["answers"].items():
                np.testing.assert_array_equal(got, first["answers"][label], err_msg=label)
            require(run["stats"] == first["stats"], f"{key}: stats differ from prefetch off")
    for label, got in first["answers"].items():
        require(got.shape[0] > 0 and bool(np.isfinite(got).all()), f"answer {label}")
        np.testing.assert_allclose(got, plain_run["answers"][label], rtol=SERVICE_TOL,
                                   atol=SERVICE_TOL, err_msg=label)
    err = max(float(np.abs(got - plain_run["answers"][label]).max())
              for label, got in first["answers"].items())
    for name in ("delta", "store"):  # the eager reader's chain sums, bitwise
        with VersionedReader(paths[name]) as reader:
            for v in range(reader.n_versions):
                np.testing.assert_array_equal(first["answers"][f"{name}_v{v}"],
                                              reader.decode_at(traffic[name], v))
    names = {s.name for s in spans}
    want = {"decode_at", "materialize", "chunk_read", "tile_decode", "canary", "kernel_decode"}
    require(want <= names, f"the trace lacks {want - names}")
    with open(trace_path) as f:
        doc = json.load(f)
    require(len([e for e in doc["traceEvents"] if e["ph"] == "X"]) == n_spans == len(spans),
            "the exported trace does not hold the recorded spans")
    materialize_ms = {}
    for s in spans:
        if s.name == "materialize":
            materialize_ms.setdefault(s.attrs["payload"], []).append(s.duration * 1e3)
    emit({"phase": "service", "payloads": {
              "pems": {"shape": list(PEMS_SHAPE), "file_bytes": pems_bytes,
                       "chunks": SERVICE_CHUNKS, "heldout": SERVICE_HELDOUT,
                       "tile_entries": SERVICE_TILE,
                       "tiles": -(-int(np.prod(PEMS_SHAPE)) // SERVICE_TILE)},
              "fig5": {"shape": list(STREAM_SHAPE)}, "delta": {"shape": list(STREAM_DELTA_SHAPE)},
              "store": {"shape": list(STORE_SHAPE), "versions": STORE_VERSIONS}},
          "cache_bytes": SERVICE_CACHE_BYTES, "canary": SERVICE_CANARY,
          "request_entries": REQUEST, "setup_s": setup_s,
          "passes": {k: service_summary(r) for k, r in runs.items()},
          "plain_pass": service_summary(plain_run),
          "identical_across_passes": True, "max_abs_err_vs_plain": err,
          "tol_vs_plain": SERVICE_TOL, "launches": launches,
          "predicted_decode_tile": first["predicted_decode_tile"],
          "canary_checks": first["canary_checks"], "canary_stats": first["stats"]["canary"],
          "quality_breach_events": [{k: v for k, v in e.items() if k != "t"} for e in breaches],
          "spans": len(spans), "span_names": sorted(names),
          "materialize_ms_traced": materialize_ms,
          "mem_slack_bytes": SERVICE_MEM_SLACK, "plain_calls": plain,
          "seconds": time.perf_counter() - t0, "name_power_limit": smi})
    return launches, store_launches, pems_path, traffic, first["answers"]


def fleet_member_decodes(svc) -> int:
    """The ``decode_tile`` launches a member's service accounts for, by
    phase service's rule: its NTTD payloads' decode calls plus its canary
    checks."""
    calls = sum(svc.info(name).decode_calls for name in svc.payloads())
    return calls + sum(c["value"] for c in svc.metrics.as_dict()["counters"]
                       if c["name"] == "canary_checks")


def fleet_serve(fleet, traffic, want, after_request=None) -> dict:
    """Phase service's PEMS-SF traffic through a fleet: the direct requests
    (untiled), the window requests and the sweep (tiled), the submits and
    one flush.  Every answer must be bitwise phase service's single
    ``CodecService``'s.  Returns the request ms by label."""
    import numpy as np

    ms = {}

    def same(label, got):
        require(got.dtype == want[label].dtype, f"{label}: {got.dtype} != {want[label].dtype}")
        np.testing.assert_array_equal(got, want[label], err_msg=label)

    def ask(label, name, idx):
        t = time.perf_counter()
        got = fleet.decode_at(name, idx)
        ms[label] = (time.perf_counter() - t) * 1e3
        same(label, got)
        if after_request is not None:
            after_request()

    for i, idx in enumerate(traffic["direct"]):
        ask(f"direct{i}", "pems", idx)
    for i, idx in enumerate(traffic["window"]):
        ask(f"window{i}", "pems_tiled", idx)
    ask("sweep", "pems_tiled", traffic["sweep"])
    t = time.perf_counter()
    tickets = [fleet.submit("pems", idx) for idx in traffic["submits"]]
    out = fleet.flush()
    ms["flush"] = (time.perf_counter() - t) * 1e3
    require(not fleet.failed, f"the fleet failed tickets: {fleet.failed}")
    same("flush", np.concatenate([out[k] for k in tickets]))
    return ms


def fleet_rebalance(flt, fleet, traffic, want, after_request=None, **change) -> dict:
    """A membership change behind the drain barrier: submits queued before
    it must all be answered after it, bitwise; then the direct requests
    again."""
    import numpy as np

    n = FLEET_DRAIN_SUBMITS
    tickets = [fleet.submit("pems", idx) for idx in traffic["submits"][:n]]
    t = time.perf_counter()
    report = flt.rebalance(fleet, **change)
    seconds = time.perf_counter() - t
    out = fleet.flush()
    require(all(k in out for k in tickets) and not fleet.failed,
            f"rebalance {change}: queued tickets lost ({sorted(set(tickets) - set(out))}, "
            f"failed {fleet.failed})")
    np.testing.assert_array_equal(np.concatenate([out[k] for k in tickets]),
                                  want["flush"][:n * SERVICE_SUBMITS[1]])
    ms = []
    for i, idx in enumerate(traffic["direct"]):
        t = time.perf_counter()
        got = fleet.decode_at("pems", idx)
        ms.append((time.perf_counter() - t) * 1e3)
        np.testing.assert_array_equal(got, want[f"direct{i}"], err_msg=f"direct{i} {change}")
        if after_request is not None:
            after_request()
    return {"change": change, "seconds": seconds, "chunks_moved": report.chunks_moved,
            "tiles_moved": report.tiles_moved, "tiles_warmed": report.tiles_warmed,
            "bytes_dropped": report.bytes_dropped, "drained_tickets": len(tickets),
            "direct_ms_median": float(np.median(ms))}


def gpu_pids() -> dict:
    """pid -> used memory of every process holding a context on the card,
    as ``nvidia-smi`` sees them (in a container, pids of its namespace)."""
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    rows = [line.split(",") for line in res.stdout.splitlines() if line.strip()]
    return {int(r[0]): r[1].strip() for r in rows if r[0].strip().isdigit()}


def gpu_memory_used_mib() -> int:
    res = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return int(res.stdout.split()[0])


def device_files(pid: int) -> list[str]:
    """The card's device nodes a process holds open (``/dev/nvidia<N>`` is
    opened by a process with a context on card N)."""
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def worker_contexts(procs, used_before_mib: int) -> dict:
    """Each worker must hold a CUDA context on the card.  Where
    ``nvidia-smi`` lists the workers' pids, that is the evidence; where it
    does not (a container whose processes it reports under another pid
    namespace), each worker must hold the card's device node open and the
    card's used memory must have grown by at least 100 MiB a worker since
    before they started."""
    listed = gpu_pids()
    used = gpu_memory_used_mib()
    rows = {iid: {"pid": p.pid, "in_nvidia_smi": p.pid in listed,
                  "device_files": device_files(p.pid)} for iid, p in procs.items()}
    by_smi = all(r["in_nvidia_smi"] for r in rows.values())
    by_node = all(any(re.fullmatch(r"/dev/nvidia\d+", f) for f in r["device_files"])
                  for r in rows.values())
    grown = used - used_before_mib
    require(by_smi or (by_node and grown >= 100 * len(procs)),
            f"workers without a CUDA context: {rows}; nvidia-smi lists {listed}, the card's "
            f"used memory grew {grown} MiB")
    return {"workers": rows, "nvidia_smi_pids": listed, "evidence":
            "nvidia-smi pids" if by_smi else "device node open + used memory",
            "used_mib_before": used_before_mib, "used_mib_after": used}


def traced_split(obs, fleet, idx) -> tuple:
    """One traced direct request -> (answer, spans, the frontend's ms
    outside its members' ``transport.flush`` spans, the members' ms)."""
    rec = obs.enable_tracing(capacity=1 << 16)
    rec.clear()
    try:
        got = fleet.decode_at("pems", idx)
        spans = rec.snapshot()
    finally:
        obs.disable_tracing()
        rec.clear()
    total = sum(s.duration for s in spans if s.name == "fleet.decode_at")
    members = {s.attrs["instance"]: s.duration * 1e3 for s in spans
               if s.name == "transport.flush"}
    return got, spans, {"request_ms": total * 1e3,
                        "frontend_ms": total * 1e3 - sum(members.values()),
                        "member_flush_ms": members}


def fleet_local(torch, device, flt, traffic, want):
    """fleet.local: ``FLEET_INSTANCES`` in-process members on the card."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.kernels import ops

    class Fleet(flt.FleetFrontend):
        """Keeps the decode count of a member as it retires (its service's
        payload stats go with it)."""
        retired_decodes = 0

        def retire_instance(self, iid):
            self.retired_decodes += fleet_member_decodes(self.transports[iid].service)
            return super().retire_instance(iid)

    resident = []

    def within_budget():
        resident.append(max(s.cache_stats.resident_bytes for s in fleet.services.values()))
        require(resident[-1] <= SERVICE_CACHE_BYTES,
                f"a member holds {resident[-1]} resident bytes, above {SERVICE_CACHE_BYTES}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fleet = Fleet(FLEET_INSTANCES, replication=FLEET_REPLICATION,
                  cache_bytes=SERVICE_CACHE_BYTES, device=device, **SERVICE_CANARY)
    try:
        require(all(s.device.type == device.type for s in fleet.services.values()),
                f"fleet members off {device}")
        fleet.load_stream("pems", want["path"])
        fleet.load_stream("pems_tiled", want["path"], tile_entries=SERVICE_TILE)
        ms = fleet_serve(fleet, traffic, want, within_budget)
        removed = fleet_rebalance(flt, fleet, traffic, want, within_budget,
                                  remove=[f"i{FLEET_INSTANCES - 1}"])
        added = fleet_rebalance(flt, fleet, traffic, want, within_budget,
                                add=[f"i{FLEET_INSTANCES}"])
        require(added["tiles_warmed"]["pems_tiled"] > 0,
                f"no tile warmed into the joining member: {added}")
        require(not fleet.failed, f"failed tickets {fleet.failed}")
        traced, _, split = traced_split(obs, fleet, traffic["direct"][1])
        np.testing.assert_array_equal(traced, want["direct1"])
        torch.cuda.synchronize()
        predicted = fleet.retired_decodes + sum(fleet_member_decodes(s)
                                                for s in fleet.services.values())
        metrics = flt.collect(fleet).as_dict()
    finally:
        fleet.close()
    launches = ops.launch_counts()
    require(launches["decode_tile"] == predicted,
            f"fleet.local launched decode_tile {launches['decode_tile']} times; the members "
            f"report {predicted} decode calls and canary checks")
    direct = [ms[f"direct{i}"] for i in range(SERVICE_DIRECT)]
    return launches, {
        "instances": FLEET_INSTANCES, "replication": FLEET_REPLICATION,
        "direct_ms": direct, "direct_ms_median": float(np.median(direct)),
        "tiled_hit_ms_median": float(np.median([ms[f"window{i}"]
                                                for i in range(1, SERVICE_WINDOW[2])])),
        "sweep_ms": ms["sweep"], "flush_ms": ms["flush"],
        "rebalance_remove": removed, "rebalance_add": added,
        "resident_bytes_max": max(resident), "traced_request": split, "launches": launches,
        "predicted_decode_tile": predicted, "fleet_cache": metrics["fleet"],
        "canary": metrics["canary"], "seconds": time.perf_counter() - t0}


def fleet_procs(torch, device, flt, obs, traffic, want):
    """fleet.procs: ``FLEET_WORKERS`` worker processes on the same card,
    started together."""
    import numpy as np
    from torch_slo_smoke import start_workers

    from repro_torch.kernels import ops

    spawn_s = {}

    def spawn(iid):
        t = time.perf_counter()
        transport = flt.SocketTransport.spawn(iid, cache_bytes=SERVICE_CACHE_BYTES,
                                              device=str(device), timeout=120.0,
                                              **SERVICE_CANARY)
        transport.ping()
        spawn_s[iid] = time.perf_counter() - t
        return transport

    ops.reset_launch_counts()
    used_before = gpu_memory_used_mib()
    t0 = time.perf_counter()
    fleet = flt.FleetFrontend(start_workers(spawn, [f"w{k}" for k in range(FLEET_WORKERS)]),
                              replication=FLEET_REPLICATION, transport_factory=spawn,
                              device=device)
    spawn_wall = time.perf_counter() - t0
    procs = {iid: t._proc for iid, t in fleet.transports.items()}
    try:
        fleet.load_stream("pems", want["path"])
        fleet.load_stream("pems_tiled", want["path"], tile_entries=SERVICE_TILE)
        ms = fleet_serve(fleet, traffic, want)
        contexts = worker_contexts(procs, used_before)
        traced, spans, split = traced_split(obs, fleet, traffic["direct"][1])
        np.testing.assert_array_equal(traced, want["direct1"])
        metrics = flt.collect(fleet).as_dict()
    finally:
        fleet.close()
    for iid, p in procs.items():
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            require(False, f"worker {iid} outlived close()")
    launches = ops.launch_counts()
    require(sum(launches.values()) == 0, f"the frontend launched kernels itself: {launches}")
    flushes = {s.span_id: s.attrs.get("instance") for s in spans if s.name == "transport.flush"}
    remote = [s for s in spans if s.instance in procs]
    ids = {s.span_id for s in remote}
    roots = [s for s in remote if s.parent_id not in ids]
    require(len({s.trace_id for s in spans}) == 1, "the traced request is not one trace")
    require(any(s.name == "kernel_decode" for s in remote),
            f"no worker kernel_decode span: {sorted({s.name for s in remote})}")
    require(roots and all(flushes.get(s.parent_id) == s.instance for s in roots),
            "worker spans not under the frontend's transport.flush")
    direct = [ms[f"direct{i}"] for i in range(SERVICE_DIRECT)]
    return {"workers": FLEET_WORKERS, "replication": FLEET_REPLICATION,
            "spawn_s": spawn_s, "spawn_wall_s": spawn_wall, "cuda_contexts": contexts,
            "direct_ms": direct, "direct_ms_median": float(np.median(direct)),
            "tiled_hit_ms_median": float(np.median([ms[f"window{i}"]
                                                    for i in range(1, SERVICE_WINDOW[2])])),
            "sweep_ms": ms["sweep"], "flush_ms": ms["flush"],
            "traced_request": split, "traced_spans": len(spans), "worker_spans": len(remote),
            "worker_kernel_decode_spans": sum(s.name == "kernel_decode" for s in remote),
            "fleet_cache": metrics["fleet"], "canary": metrics["canary"],
            "exited": {iid: p.returncode for iid, p in procs.items()},
            "seconds": time.perf_counter() - t0}


def phase_fleet(torch, device, smi, workdir, pems_path, traffic, answers):
    """The serving fleet on the card (ROADMAP A.6): phase service's PEMS-SF
    file and traffic through ``FLEET_INSTANCES`` in-process members
    (``fleet.local``: bitwise phase service's answers, rebalances behind
    the drain barrier with a warm handoff, resident bytes within each
    member's budget, ``decode_tile`` launched once per decode call and
    canary check the members report), through ``FLEET_WORKERS`` worker
    processes (``fleet.procs``: bitwise the same, each worker holding a
    CUDA context, one stitched trace), then the SLO and repair drills of
    ``scripts/torch_slo_smoke.py`` and ``scripts/torch_repair_drill.py``
    (the repair's NTTD refit launching the training kernels, no plain
    version).  Returns this process's launches over the phase."""
    from repro_torch import fleet as flt
    from repro_torch import obs
    from repro_torch.kernels import ops, ref

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_repair_drill
    import torch_slo_smoke

    t0 = time.perf_counter()
    want = {**answers, "path": pems_path}
    with plain_calls_counted(ref) as plain:
        local_launches, local = fleet_local(torch, device, flt, traffic, want)
        emit({"phase": "fleet.local", **local, "name_power_limit": smi})
        procs = fleet_procs(torch, device, flt, obs, traffic, want)
        emit({"phase": "fleet.procs", **procs, "name_power_limit": smi})
        ops.reset_launch_counts()
        slo = torch_slo_smoke.run(str(device))
        slo_launches = ops.launch_counts()
        emit({"phase": "fleet.slo", **slo, "launches": slo_launches, "name_power_limit": smi})
        ops.reset_launch_counts()
        repair = torch_repair_drill.run(str(device), out=os.path.join(workdir, "repair_drill"))
        torch.cuda.synchronize()
        repair_launches = ops.launch_counts()
    require(sum(plain.values()) == 0, f"plain versions ran in phase fleet: {plain}")
    require(slo["decisions"].count("scale_up") == 1 and slo["decisions"].count("scale_down") == 1,
            f"slo drill {slo['decisions']}")
    quality = repair["runs"][1]
    training = ["lstm_scan", "lstm_scan_bwd"]
    if quality["middle_cores"] >= 1:
        training += ["tt_contract", "tt_contract_bwd"]
    require(quality["device"].startswith(device.type), f"the refit ran on {quality['device']}")
    for name in training + ["decode_tile"]:
        require(repair_launches[name] > 0,
                f"the repair's refit did not launch {name}: {repair_launches}")
    emit({"phase": "fleet.repair", **repair, "launches": repair_launches,
          "kernels_of_the_refit": training,
          "time_to_repair_s": {r["kind"]: r["time_to_repair_s"] for r in repair["runs"]},
          "refit_entries_per_sec": quality["refit_entries_per_sec"],
          "name_power_limit": smi})
    total = {k: local_launches[k] + slo_launches[k] + repair_launches[k]
             for k in local_launches}
    emit({"phase": "fleet", "seconds": time.perf_counter() - t0, "launches": total,
          "plain_calls": plain, "name_power_limit": smi})
    return total


# ---------------------------------------------------------------------------
# phase dist: the data-parallel fit epoch over spawned ranks, the rule check
# ---------------------------------------------------------------------------
def dist_epoch_setup(torch, device, inputs):
    """(spec, cfg, opt, params, positions, values) of the DP epoch on
    ``device`` from the arrays ``dist_inputs`` wrote."""
    from repro_torch import convert
    from repro_torch.configs import tensorcodec_paper
    from repro_torch.core import nttd
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.optim import optimizers

    spec = make_folding_spec(tuple(int(n) for n in inputs["shape"]))
    med = tensorcodec_paper.MEDIUM
    cfg = nttd.NTTDConfig(rank=med.rank, hidden=med.hidden, kernel_impl="cuda")
    params = convert.params_from_numpy(_unflat_npz(inputs, "params/"), device)
    return (spec, cfg, optimizers.adam(med.lr), params,
            torch.as_tensor(inputs["pos"], device=device),
            torch.as_tensor(inputs["vals"], device=device))


def _unflat_npz(npz, prefix: str) -> dict:
    tree: dict = {}
    for key in npz.files:
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = npz[key]
    return tree


def _flat_tree(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        return {key: leaf for k, v in tree.items()
                for key, leaf in _flat_tree(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree.detach().cpu().numpy()}


def dist_inputs(torch, workdir) -> str:
    """The MEDIUM fit's first epoch inputs: the port's init (seed 0) and
    DIST_STEPS x DIST_BATCH random entries of the normalized PEMS-SF
    replica; written to ``workdir/dist/inputs.npz``."""
    import numpy as np

    from repro_torch.codecs.indexing import flat_to_multi
    from repro_torch.configs import tensorcodec_paper
    from repro_torch.core import nttd
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.data import synthetic_tensors

    x = synthetic_tensors.load(FIT_DATASET, mini=False, seed=SEED)
    xn = (x - float(x.mean())) / float(x.std())
    rng = np.random.default_rng(SEED)
    pos = flat_to_multi(rng.integers(0, x.size, DIST_STEPS * DIST_BATCH), x.shape)
    vals = xn[tuple(pos.T)]
    med = tensorcodec_paper.MEDIUM
    params = nttd.init_params(torch.Generator().manual_seed(SEED), make_folding_spec(x.shape),
                              nttd.NTTDConfig(rank=med.rank, hidden=med.hidden), "cpu")
    path = os.path.join(workdir, "dist", "inputs.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, shape=np.asarray(x.shape),
             pos=pos.reshape(DIST_STEPS, DIST_BATCH, -1).astype(np.int32),
             vals=vals.reshape(DIST_STEPS, DIST_BATCH).astype(np.float32),
             **_flat_tree(params, "params/"))
    return path


def dist_rank(rank: int, world: int, backend: str, device_type: str, workdir: str,
              name: str) -> None:
    """One rank of world ``name``, in a spawned process: joins the group
    through a FileStore, runs the DP epoch once with every launch counted
    (the checked run), then DIST_TIMING_EPOCHS untimed-collective epochs
    for the step's ms and as many with each all-reduce timed; world "b"
    also restores ``leaf`` with Shard(0) and Shard(1).  Writes its results
    to ``workdir/dist/<name><rank>.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import codec
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = os.path.join(workdir, "dist")
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(out, f"store_{name}"), world)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, **kwargs)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(device.type, (world,), mesh_dim_names=("data",))
        inputs = np.load(os.path.join(out, "inputs.npz"))
        spec, cfg, opt, params, pos, vals = dist_epoch_setup(torch, device, inputs)
        epoch = codec._make_train_epoch(spec, cfg, opt, mesh=mesh)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        with plain_calls_counted(ref) as plain:
            sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            p, o, loss = epoch(params, opt.init(params), pos, vals)
            sync()
            first_s = time.perf_counter() - t0
            launches = ops.launch_counts()
        res = {"loss": loss.cpu().numpy(), **_flat_tree(p, "params/")}

        def timed_epochs():
            nonlocal p, o
            sync()
            t = time.perf_counter()
            for _ in range(DIST_TIMING_EPOCHS):
                p, o, _ = epoch(p, o, pos, vals)
            sync()
            return time.perf_counter() - t

        steps = DIST_TIMING_EPOCHS * DIST_STEPS
        step_s = timed_epochs() / steps
        all_reduce, reduce_s = dist.all_reduce, [0.0]

        def timed_all_reduce(*args, **kw):  # the host clock around a drained stream
            sync()
            t = time.perf_counter()
            work = all_reduce(*args, **kw)
            sync()
            reduce_s[0] += time.perf_counter() - t
            return work

        dist.all_reduce = timed_all_reduce
        try:
            timed_s = timed_epochs()
        finally:
            dist.all_reduce = all_reduce
        if name == "b":
            res.update(dist_restore(torch, mesh, workdir))
        np.savez(os.path.join(out, f"{name}{rank}.npz"), **res, meta=np.array(json.dumps({
            "backend": dist.get_backend(), "world": dist.get_world_size(), "rank": rank,
            "device": str(pos.device), "device_name": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu", "launches": launches, "plain_calls": plain,
            "first_epoch_s": first_s, "step_ms": step_s * 1e3,
            "step_ms_reduce_timed": timed_s / steps * 1e3,
            "all_reduce_ms_per_step": reduce_s[0] / steps * 1e3,
            "all_reduce_share": reduce_s[0] / timed_s})))
    finally:
        dist.destroy_process_group()


def dist_restore(torch, mesh, workdir) -> dict:
    """The leaf ``phase_dist`` saved on one device, restored on ``mesh``
    with Shard(0) and Shard(1): each rank's chunk must be its slice."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist.sharding import NamedSharding, PartitionSpec
    from repro_torch.train import checkpoint as ckpt_lib

    want = torch.randn(DIST_LEAF, generator=torch.Generator().manual_seed(SEED))
    rank, world = mesh.get_coordinate()[0], mesh.size()
    ck = ckpt_lib.Checkpointer(os.path.join(workdir, "dist", "ckpt"))
    template = {"w": torch.empty(DIST_LEAF, device="meta")}
    checked = {}
    for dim, spec in ((0, PartitionSpec("data", None)), (1, PartitionSpec(None, "data"))):
        tree, _ = ck.restore(1, template, {"w": NamedSharding(mesh, spec)})
        w = tree["w"]
        n = DIST_LEAF[dim] // world
        piece = want.narrow(dim, rank * n, n)
        require(tuple(w.placements) == (Shard(dim),), f"restored with {w.placements}")
        require(w.to_local().device.type == mesh.device_type, f"on {w.to_local().device}")
        require(torch.equal(w.to_local().cpu(), piece), f"Shard({dim}): rank {rank}'s chunk "
                f"is not its slice")
        checked[f"restore_shard{dim}_local_shape"] = list(w.to_local().shape)
    return {"restore": json.dumps(checked)}


def run_world(name: str, world: int, backend: str, device_type: str, workdir: str,
              target=None) -> list:
    """Spawn ``world`` ranks of ``target`` (``dist_rank`` unless given),
    each called as ``target(rank, world, backend, device_type, workdir,
    name)``; each must exit 0 within DIST_TIMEOUT, and a rank's non-zero
    exit ends the world at once.  Returns each rank's results, the
    ``workdir/dist/<name><rank>.npz`` it wrote."""
    import multiprocessing

    import numpy as np

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or dist_rank,
                         args=(r, world, backend, device_type, workdir, name))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT
    try:  # until all exit, one fails (its peers may wait on it forever) or time is up
        while (any(p.is_alive() for p in procs) and time.monotonic() < deadline
               and not any(p.exitcode for p in procs)):
            time.sleep(0.1)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    require(not any(c for c, p in zip(codes, procs) if p not in alive),
            f"dist.{name}: rank exit codes {codes} (killed: {len(alive)})")
    require(not alive, f"dist.{name}: {len(alive)} of {world} ranks timed out")
    out = []
    for r in range(world):
        res = dict(np.load(os.path.join(workdir, "dist", f"{name}{r}.npz")))
        res["meta"] = json.loads(str(res["meta"]))
        if "restore" in res:
            res["meta"]["restore"] = json.loads(str(res.pop("restore")))
        out.append(res)
    return out


def dist_rule_check() -> dict:
    """The dry-run rule check of every LM cell and of the codec's DP cell."""
    from repro_torch.launch import dryrun, dryrun_codec

    t0 = time.perf_counter()
    status, leaves, largest = {"ok": 0, "skip": 0}, 0, {}
    for rules in ("base", "fsdp"):
        for arch, shape, mesh in dryrun.cells("both"):
            res = dryrun.check_cell(arch, shape, mesh, rules)
            status[res["status"]] += 1
            if res["status"] == "ok":
                leaves += sum(len(v) for v in res["specs"].values())
                total = sum(res["bytes_per_device"].values())
                if total > largest.get("bytes", 0):
                    largest = {"cell": [arch, shape, mesh, rules], "bytes": total}
    codec = {m: dryrun_codec.check(m)["bytes_per_device"] for m in ("single", "multi")}
    require((status["ok"], status["skip"]) == DIST_CELLS,
            f"dry-run cells {status}, expected {DIST_CELLS}")
    return {"cells": status, "leaves": leaves, "largest_bytes_per_device": largest,
            "codec_bytes_per_device": codec, "seconds": time.perf_counter() - t0}


def phase_dist(torch, device, smi, workdir) -> dict:
    """The DP epoch in worlds ``a`` (one NCCL rank) and ``b`` (two gloo
    ranks on one card), held against this process's single-device epoch;
    elastic restore; the rule check.  Returns each kernel's launches in
    the ranks' checked epochs, summed over ranks."""
    import numpy as np

    from repro_torch.core import codec
    from repro_torch.train import checkpoint as ckpt_lib

    t0 = time.perf_counter()
    inputs = np.load(dist_inputs(torch, workdir))
    ckpt_lib.Checkpointer(os.path.join(workdir, "dist", "ckpt"), async_save=False).save(
        1, {"w": torch.randn(DIST_LEAF, generator=torch.Generator().manual_seed(SEED)).to(
            device)})
    spec, cfg, opt, params, pos, vals = dist_epoch_setup(torch, device, inputs)
    p, _, loss = codec._make_train_epoch(spec, cfg, opt)(params, opt.init(params), pos, vals)
    want = {"loss": loss.cpu().numpy(), **_flat_tree(p, "params/")}
    nccl = "nccl" if device.type == "cuda" else "gloo"
    worlds = {"a": run_world("a", 1, nccl, device.type, workdir),
              "b": run_world("b", 2, "gloo", device.type, workdir)}
    launches = dict.fromkeys(TRAIN_KERNELS, 0)
    report = {}
    for name, ranks in worlds.items():
        for r, res in enumerate(ranks):
            meta = res["meta"]
            require(all(meta["launches"][k] == DIST_STEPS for k in TRAIN_KERNELS),
                    f"dist.{name} rank {r} launched {meta['launches']}; expected "
                    f"{DIST_STEPS} of each training kernel")
            require(sum(meta["plain_calls"].values()) == 0,
                    f"dist.{name} rank {r} ran plain versions: {meta['plain_calls']}")
            for k in launches:
                launches[k] += meta["launches"][k]
        for r, res in enumerate(ranks[1:], 1):  # replicated params stay bitwise equal
            require(all(np.array_equal(res[k], ranks[0][k]) for k in want),
                    f"dist.{name}: rank {r}'s params differ from rank 0's")
        got = ranks[0]
        errs = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
        if name == "a":
            require(all(np.array_equal(got[k], want[k]) for k in want),
                    f"dist.a: the one-rank epoch is not the single-device one bitwise: {errs}")
        else:
            require(abs(float(got["loss"]) - float(want["loss"]))
                    <= DIST_LOSS_RTOL * abs(float(want["loss"])),
                    f"dist.b: loss {float(got['loss'])} vs {float(want['loss'])}")
            for k in want:
                if k != "loss":
                    np.testing.assert_allclose(got[k], want[k], **DIST_PARAM_TOL, err_msg=k)
        report[name] = {"ranks": [r["meta"] for r in ranks], "max_abs_err": errs,
                        "loss": float(got["loss"]), "loss_single_device": float(want["loss"])}
        emit({"phase": f"dist.{name}", "world": len(ranks), "steps": DIST_STEPS,
              "batch": DIST_BATCH, "entries_per_rank": DIST_BATCH // len(ranks),
              **report[name], "name_power_limit": smi})
    rules = dist_rule_check()
    emit({"phase": "dist.rules", **rules})
    emit({"phase": "dist", "seconds": time.perf_counter() - t0, "launches": launches,
          "not_shown": "NCCL collectives across cards: one card holds world a's one rank "
                       "and world b's two gloo ranks"})
    return launches


def _join_group(torch, rank: int, world: int, backend: str, device_type: str, workdir: str,
                name: str):
    """This spawned rank's device, in a process group of ``world`` joined
    through a FileStore in ``workdir/dist``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(workdir, "dist", f"store_{name}"), world)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, **kwargs)
    return device


def _peak_reset(torch, device) -> None:
    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(torch, device) -> int:
    return torch.cuda.max_memory_allocated() if device.type == "cuda" else 0


def tp_grads(torch, device, mesh) -> dict:
    """The gradients minicpm-2b's train step (cut to TP_LAYERS) hands its
    optimizer at the launcher's init on a TP_GRAD_BATCH batch from SEED,
    on one device and on ``mesh`` (its ``grad_transform`` hook): bitwise,
    the largest per-leaf difference over the leaf's largest magnitude, and
    both ``grad_norm``."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.models import model
    from repro_torch.optim import optimizers
    from repro_torch.train import step as step_lib

    rules = sharding.BASE_RULES
    with depth_cut(configs, TP_LAYERS):
        cfg = configs.get(TRAIN_ARCH)
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, TP_GRAD_BATCH),
                             device=device)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    opt = optimizers.adamw(TRAIN_LR, weight_decay=0.1, max_grad_norm=1.0)

    def grads(shardings=None):
        seen = {}

        def capture(g):  # whole copies: the update clips the gradients in place
            seen.update(sharding.keyed_leaves(optimizers.tree_map(
                lambda x: (x.full_tensor() if sharding.is_dtensor(x) else x).clone(), g)))
            return g

        params = model.init_params(cfg, 0, device, shardings and shardings["params"])
        state, b = opt.init(params), batch
        ctx = contextlib.nullcontext()
        if shardings:
            state = sharding.device_put(state, shardings["opt"])
            b = sharding.device_put(batch, step_lib.batch_shardings(mesh, cfg, batch, rules))
            ctx = sharding.sharding_ctx(mesh, rules)
        with ctx:
            _, _, metrics = step_lib.make_train_step(cfg, opt, capture)(params, state, b)
        return seen, float(metrics["grad_norm"])

    want, norm_plain = grads()
    got, norm_mesh = grads({"params": step_lib.param_shardings(mesh, cfg, rules),
                            "opt": step_lib.opt_shardings(mesh, cfg, rules)})
    rel = {k: float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
           for k in want}
    return {"grads_bitwise": all(torch.equal(got[k], want[k]) for k in want),
            "grad_max_rel_err": max(rel.values()), "grad_max_rel_err_leaf": max(rel, key=rel.get),
            "grad_norm_mesh": norm_mesh, "grad_norm_plain": norm_plain}


def tp_rank(rank: int, world: int, backend: str, device_type: str, workdir: str,
            name: str) -> None:
    """World ``tp``'s rank: ``launch.train.run`` of minicpm-2b cut to
    TP_LAYERS, twice without a process group (the plain route, and its
    repeat: how far two plain runs differ), then in a group of one rank on
    a 1 x 1 (data, model) mesh; writes the routes' losses, step times,
    peak memory and the params' largest differences."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    argv = ["--arch", TRAIN_ARCH, "--steps", str(TP_STEPS), "--lr", str(TRAIN_LR),
            "--log-every", "1", "--device", device_type]
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    routes = {}

    def route(label: str, extra: list):
        _peak_reset(torch, device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with depth_cut(configs, TP_LAYERS):
            run = train.run(argv + extra)
        seconds = time.perf_counter() - t0
        routes[label] = {"losses": run.losses, "step_ms": [t * 1e3 for t in run.step_seconds],
                         "step_ms_median_after_first": float(np.median(run.step_seconds[1:]))
                         * 1e3, "seconds": seconds, "peak_bytes": _peak(torch, device),
                         "launches": ops.launch_counts()}
        return run

    def max_err(a: dict, b: dict) -> tuple[float, str]:
        errs = {k: float((a[k] - b[k]).abs().max()) for k in b}
        return max(errs.values()), max(errs, key=errs.get)

    want = sharding.keyed_leaves(route("plain", []).params)
    repeat = sharding.keyed_leaves(route("plain_repeat", []).params)
    repeat_err = max_err(repeat, want)
    del repeat
    _join_group(torch, rank, world, backend, device_type, workdir, name)
    try:
        run = route("mesh", ["--mesh", "1x1"])
        leaves = sharding.keyed_leaves(run.params)
        require(all(sharding.is_dtensor(v) for v in leaves.values()),
                "the mesh route's params are not DTensors")
        mesh = next(iter(leaves.values())).device_mesh
        got = {k: v.full_tensor() for k, v in leaves.items()}
        del run, leaves
        bitwise = all(torch.equal(got[k], want[k]) for k in want)
        err, err_leaf = max_err(got, want)
        close = all(torch.allclose(got[k], want[k], **TP_PARAM_TOL) for k in want)
        del got, want
        _peak_reset(torch, device)
        meta = {**tp_grads(torch, device, mesh), "backend": dist.get_backend(), "world": dist.get_world_size(),
                "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "device_name": torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu", "routes": routes,
                "params_bitwise": bitwise, "params_close": close,
                "max_abs_err": err, "max_abs_err_leaf": err_leaf,
                "plain_repeat_max_abs_err": repeat_err[0],
                "plain_repeat_max_abs_err_leaf": repeat_err[1]}
        np.savez(os.path.join(workdir, "dist", f"{name}{rank}.npz"),
                 meta=np.array(json.dumps(meta)))
    finally:
        dist.destroy_process_group()


def phase_tp(torch, device, smi, workdir) -> None:
    """minicpm-2b's train step through the launcher's mesh path: one NCCL
    rank, a 1 x 1 (data, model) mesh, full width cut to TP_LAYERS layers,
    against the launcher without a process group in the same rank."""
    from repro_torch import configs

    t0 = time.perf_counter()
    os.makedirs(os.path.join(workdir, "dist"), exist_ok=True)
    backend = "nccl" if device.type == "cuda" else "gloo"
    (res,) = run_world("tp", 1, backend, device.type, workdir, target=tp_rank)
    meta = res["meta"]
    plain, mesh = meta["routes"]["plain"], meta["routes"]["mesh"]
    repeat = meta["routes"]["plain_repeat"]
    for label, r in meta["routes"].items():
        require(len(r["losses"]) == TP_STEPS and all(math.isfinite(v) for v in r["losses"]),
                f"tp.{label}: losses {r['losses']}")
        require(not any(r["launches"].values()),
                f"tp.{label} launched {r['launches']}; training attention is the oracle")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mesh["losses"], plain["losses"]))
    norm_rel = abs(meta["grad_norm_mesh"] - meta["grad_norm_plain"]) / meta["grad_norm_plain"]
    require(meta["grads_bitwise"] or (meta["grad_max_rel_err"] <= TP_GRAD_REL
                                      and norm_rel <= TP_LOSS_RTOL),
            f"tp: the mesh step's gradients differ by {meta['grad_max_rel_err']} of a leaf's "
            f"largest ({meta['grad_max_rel_err_leaf']}), grad_norm {meta['grad_norm_mesh']} vs "
            f"{meta['grad_norm_plain']}")
    require(meta["params_bitwise"] or (loss_rel <= TP_LOSS_RTOL and meta["params_close"]),
            f"tp: the mesh route's losses {mesh['losses']} vs {plain['losses']} (rel "
            f"{loss_rel}), params max abs err {meta['max_abs_err']} "
            f"({meta['max_abs_err_leaf']})")
    cfg = configs.get(TRAIN_ARCH)
    emit({"phase": "tp", "arch": TRAIN_ARCH, "layers": TP_LAYERS, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "vocab": cfg.vocab, "steps": TP_STEPS,
          "reduced": [f"n_layers {cfg.n_layers} -> {TP_LAYERS} (every width kept)"],
          "backend": meta["backend"], "world": meta["world"], "mesh": meta["mesh"],
          "losses_mesh": mesh["losses"], "losses_plain": plain["losses"],
          "losses_plain_repeat": repeat["losses"],
          "max_rel_loss_diff": loss_rel, "params_bitwise": meta["params_bitwise"],
          "max_abs_err": meta["max_abs_err"], "max_abs_err_leaf": meta["max_abs_err_leaf"],
          "plain_repeat_max_abs_err": meta["plain_repeat_max_abs_err"],
          "plain_repeat_max_abs_err_leaf": meta["plain_repeat_max_abs_err_leaf"],
          "grads_bitwise": meta["grads_bitwise"], "grad_max_rel_err": meta["grad_max_rel_err"],
          "grad_max_rel_err_leaf": meta["grad_max_rel_err_leaf"],
          "grad_norm_mesh": meta["grad_norm_mesh"], "grad_norm_plain": meta["grad_norm_plain"],
          "tol_if_not_bitwise": {"loss_rtol": TP_LOSS_RTOL, "grad_rel": TP_GRAD_REL,
                                 "grad_norm_rtol": TP_LOSS_RTOL, **TP_PARAM_TOL},
          "step_ms_mesh": mesh["step_ms"], "step_ms_plain": plain["step_ms"],
          "step_ms_median_after_first_mesh": mesh["step_ms_median_after_first"],
          "step_ms_median_after_first_plain": plain["step_ms_median_after_first"],
          "step_ms_median_after_first_plain_repeat": repeat["step_ms_median_after_first"],
          "peak_bytes_mesh": mesh["peak_bytes"], "peak_bytes_plain": plain["peak_bytes"],
          "seconds": time.perf_counter() - t0,
          "not_shown": "NCCL collectives across cards", "name_power_limit": smi})


FSDP_RANKS = 2                      # gloo ranks on cuda:0: a (data 2, model 1) mesh
FSDP_CELLS = ((TRAIN_ARCH, TP_LAYERS), ("grok-1-314b", None))  # layers; None: smoke config
FSDP_COUNTED_DTYPE = "bfloat16"     # the compute dtype of the step whose collectives are traced
FSDP_REDUCTIONS = ("all-reduce", "reduce-scatter")


def route_all_gather_through_c10d(torch, device_type: str):
    """Under gloo, torch 2.11's functional all-gather (the one DTensor's
    redistributes call) crashes on CUDA tensors, while
    ``dist.all_gather_into_tensor`` works: this process's functional
    all-gather of ``device_type`` tensors calls the second.  Returns the
    registration, which lasts while it is referenced."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    def all_gather(x, group_size, group_name):
        out = x.new_empty((x.shape[0] * group_size, *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=distributed_c10d._resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather, "CUDA" if device_type == "cuda" else "CPU")
    return lib


@contextlib.contextmanager
def layout_trace(torch, params):
    """Trace the collectives of one train step on ``params`` (``DTensor``
    masters): yields ``(counter, nodes)``.  ``counter``, a ``CostCounter``,
    records every collective, ``counter.where`` where each was issued (the
    port's source line and function, a remat recompute's too, or else the
    autograd node it ran in) and ``counter.axis`` the mesh axis of its group
    (``?`` for a group of no mesh dim); ``counter.gathers`` are the
    indexes of those that ``sharding.gather_dp`` issued, and
    ``counter.gathered`` the (leaf, block) of each weight it gathered,
    found through the weight's layout node.  Each layout node of a
    master's gradient (one a leaf outside the blocks, one a block's slice
    of a stacked leaf; made by ``sharding.layout_grad``) appends to
    ``nodes`` its leaf, its block, the placements its gradient came in
    with and those it lays it out in, the mesh axes (of more than one
    rank) over which it came in as a ``Partial`` sum, and the indexes in
    ``counter.collectives`` of what it issued.  Runs on real and on fake
    (``FakeTensor``) shards alike."""
    from torch.distributed import ProcessGroup
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer

    port = os.path.dirname(os.path.dirname(dryrun.__file__))
    mesh = next(v for v in sharding.keyed_leaves(params).values()
                if isinstance(v, DTensor)).device_mesh
    axis_of = {mesh.get_group(i).group_name: a for i, a in enumerate(mesh.mesh_dim_names)}

    engine = torch.autograd.graph.__file__  # where the backward pass enters the engine

    def site() -> str:  # the innermost frame of the port outside its helpers
        f = sys._getframe(2)
        while f is not None and f.f_code.co_filename != engine:
            name = f.f_code.co_filename
            if name.startswith(port) and name not in (dryrun.__file__, sharding.__file__):
                return f"{os.path.relpath(name, port)}:{f.f_lineno} ({f.f_code.co_qualname})"
            f = f.f_back
        return "other"

    def axis(func, args, kwargs) -> str:
        for i, a in enumerate(func._schema.arguments):
            if a.name in ("group_name", "process_group"):
                g = kwargs[a.name] if a.name in kwargs else args[i]
                if not isinstance(g, str):
                    g = (g if isinstance(g, ProcessGroup) else ProcessGroup.unbox(g)).group_name
                return axis_of.get(g, "?")
        return "?"

    class Traced(dryrun.CostCounter):
        def __init__(self):
            super().__init__()
            self.where: list[str] = []
            self.axis: list[str] = []
            self.gathers: set[int] = set()
            self.gathered: list[tuple] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            n = len(self.collectives) - len(self.where)
            if n:  # the port's code that issued it (a recompute's too), else the node
                here, node = site(), torch._C._current_autograd_node()
                self.where += [node.name() if here == "other" and node is not None
                               else here] * n
                self.axis += [axis(func, args, kwargs or {})] * n
            return out

    def key(t) -> int:  # a storage's identity, on real and fake tensors
        return t.untyped_storage()._cdata

    with torch.no_grad():
        leaf_of = {key(v.to_local()): k for k, v in sharding.keyed_leaves(params).items()}
    counter, nodes = Traced(), []
    layout, backward = sharding.layout_grad, sharding._ForwardLayoutGrad.backward
    gather = sharding.gather_dp

    def named_layout(t):
        out = layout(t)
        if out is not t:
            with torch.no_grad():
                local = t.to_local()
            name = leaf_of.get(key(local), "?")
            block = (local.storage_offset() // max(local.numel(), 1)
                     if name.startswith("['blocks']") else None)
            out.grad_fn.layout_leaf = (name, block)
        return out

    def counted_backward(ctx, g):
        start = len(counter.collectives)
        out = backward(ctx, g)
        if hasattr(ctx, "layout_leaf"):
            nodes.append({"leaf": ctx.layout_leaf[0], "block": ctx.layout_leaf[1],
                          "came_in": [str(p) for p in g.placements],
                          "laid_as": [str(p) for p in ctx.placements],
                          "partial": [a for i, (a, p) in enumerate(zip(mesh.mesh_dim_names,
                                                                       g.placements))
                                      if p.is_partial() and mesh.size(i) > 1],
                          "issued": list(range(start, len(counter.collectives)))})
        return out

    def layout_leaf(t) -> tuple:  # the layout node upstream of a weight, by its leaf
        todo, seen = [t.grad_fn], set()
        while todo:
            fn = todo.pop(0)
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            if hasattr(fn, "layout_leaf"):
                return fn.layout_leaf
            todo += [f for f, _ in fn.next_functions]
        return ("?", None)

    def counted_gather(w):
        start = len(counter.collectives)
        out = gather(w)
        issued = range(start, len(counter.collectives))
        counter.gathers.update(issued)
        if len(issued):
            counter.gathered.append(layout_leaf(w))
        return out

    sharding.layout_grad = transformer.layout_grad = named_layout
    sharding._ForwardLayoutGrad.backward = staticmethod(counted_backward)
    sharding.gather_dp = counted_gather
    try:
        with counter:
            yield counter, nodes
    finally:
        sharding.layout_grad = transformer.layout_grad = layout
        sharding._ForwardLayoutGrad.backward = staticmethod(backward)
        sharding.gather_dp = gather


#: the reductions over the DP axes that a train step issues outside its
#: gradients' layout nodes, by the port's function that issues them
#: (``layout_trace``'s site without its line): the losses' and the
#: metrics', each of a scalar or of one [E] vector, in f32.  No
#: activation is reduced over the DP axes.
FSDP_OTHER_REDUCTIONS = {
    "models/layers.py (_VocabParallelXent.forward)":
        "the cross-entropy: the sum of the tokens' losses over the batch shards",
    "models/moe.py (moe_ffn)":
        "the MoE load-balance loss: its two [E] means over the batch shards, a MoE layer",
    "optim/optimizers.py (global_norm)":
        "the gradient norm (the grad_norm metric and the clip): a split leaf's sum of squares",
}


def layout_reductions(counter, nodes, masters: dict, n_blocks: int,
                      compute_dtype: str = "torch.bfloat16") -> dict:
    """What ``layout_trace`` saw, checked: each leaf's layout node, a
    stacked leaf's once a block, ran once (``nodes_wrong``: the (leaf,
    block)s that ran another number of times); a node issued one
    reduction (all-reduce or reduce-scatter), in f32, over each mesh axis
    over which its gradient came in as a ``Partial`` sum and none over
    the others (``reductions_wrong``); the leaves whose gradients came in
    as no ``Partial`` sum, by name, with their nodes' count, placements
    and what they issued (``needed_none``); every reduction over a DP
    axis outside the nodes that is not one of FSDP_OTHER_REDUCTIONS in f32
    (``unlisted``); what the nodes issued, by its kinds and mesh axes in
    order (``node_issued``: how many nodes issued each); the all-gathers
    over a DP axis not in ``compute_dtype`` (``gathers_off_dtype``), and
    what ``sharding.gather_dp`` issued (``gather_dp``); every other
    reduction of the step by where it was issued, kind, dtype and mesh
    axis, and the step's collectives by kind and dtype (count and bytes;
    and a device's bytes with the ring factor, the sweep's measure)."""
    from repro_torch.launch import dryrun

    dp = ("pod", "data")
    want = Counter({(k, b): 1 for k in masters
                    for b in (range(n_blocks) if k.startswith("['blocks']") else (None,))})
    ran = Counter((n["leaf"], n["block"]) for n in nodes)
    wrong, none = [], {}
    for n in nodes:
        issued = [(*counter.collectives[i], counter.axis[i]) for i in n["issued"]]
        reduced = sorted((axis, dtype) for kind, dtype, _, axis in issued
                         if kind in FSDP_REDUCTIONS)
        if reduced != sorted((axis, "torch.float32") for axis in n["partial"]):
            wrong.append([n["leaf"], n["block"], n["came_in"], n["laid_as"], issued])
        if not n["partial"]:
            c = none.setdefault(n["leaf"], {"nodes": 0, "came_in": n["came_in"],
                                            "laid_as": n["laid_as"], "issued": Counter()})
            c["nodes"] += 1
            c["issued"].update(f"{kind} {dtype.replace('torch.', '')} {axis}"
                               for kind, dtype, _, axis in issued)
    in_nodes = {i for n in nodes for i in n["issued"]}
    others, unlisted, off_dtype, by_kind = {}, {}, {}, {}

    def add(table, key, nbytes):
        c = table.setdefault(key, [0, 0])
        c[0], c[1] = c[0] + 1, c[1] + nbytes

    for i, ((kind, dtype, nbytes), where, axis) in enumerate(
            zip(counter.collectives, counter.where, counter.axis)):
        name = f"{kind} {dtype.replace('torch.', '')}"
        add(by_kind, name, nbytes)
        if kind == "all-gather" and axis in dp and dtype != compute_dtype:
            add(off_dtype, f"{where} {name} {axis}", nbytes)
        if i in in_nodes or kind not in FSDP_REDUCTIONS:
            continue
        add(others, f"{where} {name} {axis}", nbytes)
        listed = re.sub(r":\d+ ", " ", where) in FSDP_OTHER_REDUCTIONS
        if axis in dp and not (listed and dtype == "torch.float32"):
            add(unlisted, f"{where} {name} {axis}", nbytes)
    gathers = [counter.collectives[i] for i in sorted(counter.gathers)]
    coll = dryrun.collective_bytes_per_device(counter.collectives, by_dtype=True)
    node_issued = Counter(", ".join(f"{counter.collectives[i][0]} {counter.axis[i]}"
                                    for i in n["issued"]) for n in nodes)
    return {"layout_nodes": sum(ran.values()), "layout_nodes_expected": sum(want.values()),
            "nodes_wrong": [[k, b, ran[(k, b)]] for k, b in (want | ran) if ran[(k, b)] != 1],
            "reductions_wrong": wrong, "node_issued": dict(node_issued),
            "gradient_reductions": sum(kind in FSDP_REDUCTIONS for n in nodes
                                       for kind, _, _ in (counter.collectives[i]
                                                          for i in n["issued"])),
            "needed_none": {k: {**v, "issued": dict(v["issued"])} for k, v in none.items()},
            "unlisted": unlisted, "gathers_off_dtype": off_dtype,
            "gather_dp": {"count": len(gathers), "bytes": sum(b for _, _, b in gathers),
                          "dtypes": sorted({d for _, d, _ in gathers}),
                          "weights": len(counter.gathered),
                          "leaves": dict(Counter(k for k, _ in counter.gathered))},
            "other_reductions": dict(sorted(others.items(), key=lambda kv: -kv[1][1])),
            "collectives": dict(sorted(by_kind.items())),
            "collective_bytes_per_device": {k: v for k, v in coll.items() if v}}


def fsdp_config(arch: str, layers: int | None, compute_dtype: str = "float32"):
    """The fsdp world's config: ``arch`` at full width cut to ``layers``,
    or its smoke config, in ``compute_dtype`` (f32 for the comparison with
    one device at f32 tolerances)."""
    from repro_torch import configs

    if layers is None:
        cfg = configs.get_smoke(arch)
    else:
        with depth_cut(configs, layers):
            cfg = configs.get(arch)
    return dataclasses.replace(cfg, compute_dtype=compute_dtype)


def fsdp_rank(rank: int, world: int, backend: str, device_type: str, workdir: str,
              name: str) -> None:
    """World ``fsdp``'s rank: for each of FSDP_CELLS the train step on one
    device, then on a (data ``world``, model 1) mesh under ``FSDP_RULES``
    twice: in FSDP_COUNTED_DTYPE compute under ``layout_trace`` (its
    collectives), and with a ``grad_transform`` hook that keeps each
    gradient's local shard and placements; writes the layouts that differ
    from the masters', each gradient's and param's largest difference from
    one device's, the metrics and the traced reductions."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model
    from repro_torch.optim import optimizers
    from repro_torch.train import step as step_lib

    device = _join_group(torch, rank, world, backend, device_type, workdir, name)
    registration = route_all_gather_through_c10d(torch, device.type)
    try:
        mesh = mesh_lib.make_debug_mesh(world, 1, device=device.type)
        rules = sharding.FSDP_RULES
        meta = {"rank": rank, "backend": dist.get_backend(), "world": world, "cells": {}}
        for arch, layers in FSDP_CELLS:
            _peak_reset(torch, device)
            cfg = fsdp_config(arch, layers)
            tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
                0, cfg.vocab, TP_GRAD_BATCH), device=device)
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
            opt = optimizers.adamw(TRAIN_LR, weight_decay=0.1, max_grad_norm=1.0)
            want = {}

            def whole(g):  # copies: the update clips the gradients in place
                want.update({k: v.clone() for k, v in sharding.keyed_leaves(g).items()})
                return g

            params = model.init_params(cfg, SEED, device)
            params, _, m1 = step_lib.make_train_step(cfg, opt, whole)(params, opt.init(params),
                                                                     batch)
            params = sharding.keyed_leaves(params)

            def mesh_step(cfg, hook=None, trace=None):
                p = model.init_params(cfg, SEED, device, step_lib.param_shardings(mesh, cfg,
                                                                                  rules))
                state = sharding.device_put(opt.init(p), step_lib.opt_shardings(mesh, cfg, rules))
                b = sharding.device_put(batch, step_lib.batch_shardings(mesh, cfg, batch, rules))
                masters = {k: ([str(x) for x in v.placements], list(v.to_local().shape))
                           for k, v in sharding.keyed_leaves(p).items()}
                traced = trace is not None
                with sharding.sharding_ctx(mesh, rules), (
                        layout_trace(torch, p) if traced else contextlib.nullcontext()) as t:
                    p, _, m = step_lib.make_train_step(cfg, opt, hook)(p, state, b)
                if traced:
                    trace.update(layout_reductions(*t, masters, cfg.n_blocks,
                                                   f"torch.{cfg.compute_dtype}"))
                return p, m, masters

            # the step's collectives, traced in the production compute dtype
            traced = {}
            mesh_step(fsdp_config(arch, layers, FSDP_COUNTED_DTYPE), trace=traced)
            shards = {}

            def keep(g):
                shards.update({k: (v.to_local().clone(), v.placements, v.shape, v.stride())
                               for k, v in sharding.keyed_leaves(g).items()})
                return g

            got, m2, masters = mesh_step(cfg, keep)
            laid = {k: ([str(x) for x in placements], list(local.shape))
                    for k, (local, placements, _, _) in shards.items()}
            grad_rel = {}
            for k, (local, placements, shape, stride) in shards.items():
                full = DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                                          stride=stride).full_tensor()
                grad_rel[k] = float((full - want[k]).abs().max()) / max(
                    float(want[k].abs().max()), 1e-30)
            param_err = {k: float((v.full_tensor() - params[k]).abs().max())
                         for k, v in sharding.keyed_leaves(got).items()}
            meta["cells"][arch] = {
                "layers": cfg.n_layers, "n_blocks": cfg.n_blocks, "d_model": cfg.d_model,
                "compute_dtype": cfg.compute_dtype, "family": cfg.family,
                "layout_wrong": {k: [masters[k], v] for k, v in laid.items() if v != masters[k]},
                "leaves": len(masters), "traced_compute_dtype": FSDP_COUNTED_DTYPE,
                **traced,
                "grad_max_rel_err": max(grad_rel.values()),
                "grad_max_rel_err_leaf": max(grad_rel, key=grad_rel.get),
                "param_max_abs_err": max(param_err.values()),
                "param_max_abs_err_leaf": max(param_err, key=param_err.get),
                "loss_mesh": float(m2["loss"].full_tensor()), "loss_one": float(m1["loss"]),
                "grad_norm_mesh": float(m2["grad_norm"].full_tensor()),
                "grad_norm_one": float(m1["grad_norm"]), "peak_bytes": _peak(torch, device)}
            del params, got, want, shards
        np.savez(os.path.join(workdir, "dist", f"{name}{rank}.npz"),
                 meta=np.array(json.dumps(meta)))
    finally:
        del registration
        dist.destroy_process_group()


def phase_fsdp(torch, device, smi, workdir) -> None:
    """The train step under ``FSDP_RULES`` on FSDP_RANKS gloo ranks sharing
    ``cuda:0`` (``fsdp_rank``), each held against one device: gradients in
    their masters' layout and values, params after the step; and in bf16
    compute (``layout_reductions``) each weight all-gathered in bf16 over
    ``data`` before its products (``sharding.gather_dp``), each gradient
    arriving at its layout node as a ``Partial`` sum and reduced there
    once, in f32, and no other reduction over ``data`` than the losses'
    and the metrics' (FSDP_OTHER_REDUCTIONS)."""
    t0 = time.perf_counter()
    os.makedirs(os.path.join(workdir, "dist"), exist_ok=True)
    ranks = run_world("fsdp", FSDP_RANKS, "gloo", device.type, workdir, target=fsdp_rank)
    for res in ranks:
        for arch, c in res["meta"]["cells"].items():
            where = f"fsdp.{arch} rank {res['meta']['rank']}"
            require(not c["layout_wrong"],
                    f"{where}: gradients not laid out as their masters: {c['layout_wrong']}")
            require(c["grad_max_rel_err"] <= TP_GRAD_REL,
                    f"{where}: gradients differ by {c['grad_max_rel_err']} of a leaf's largest "
                    f"({c['grad_max_rel_err_leaf']})")
            for m in ("loss", "grad_norm"):
                rel = abs(c[f"{m}_mesh"] - c[f"{m}_one"]) / abs(c[f"{m}_one"])
                require(rel <= TP_LOSS_RTOL, f"{where}: {m} {c[f'{m}_mesh']} vs {c[f'{m}_one']}")
            require(c["param_max_abs_err"] <= TP_PARAM_TOL["atol"],
                    f"{where}: params differ by {c['param_max_abs_err']} "
                    f"({c['param_max_abs_err_leaf']})")
            require(not c["nodes_wrong"],
                    f"{where}: layout nodes [leaf, block, ran] not run once: {c['nodes_wrong']}")
            require(not c["reductions_wrong"],
                    f"{where}: gradients [leaf, block, came in, laid out as, issued] not "
                    f"reduced once in f32 over each axis where partial (else not at all): "
                    f"{c['reductions_wrong'][:8]}")
            require(not c["needed_none"],
                    f"{where}: gradients that came in as no Partial sum (split where their "
                    f"masters are not: a product split the activations): {c['needed_none']}")
            require(not c["unlisted"],
                    f"{where}: reductions over the DP axes outside the layout nodes and "
                    f"FSDP_OTHER_REDUCTIONS [count, bytes]: {c['unlisted']}")
            require(c["gather_dp"]["count"] > 0 and not c["gathers_off_dtype"],
                    f"{where}: weights not all-gathered in {FSDP_COUNTED_DTYPE}: gather_dp "
                    f"{c['gather_dp']}, others {c['gathers_off_dtype']}")
    emit({"phase": "fsdp", "world": FSDP_RANKS, "backend": "gloo",
          "mesh": {"data": FSDP_RANKS, "model": 1}, "rules": "fsdp", "batch": TP_GRAD_BATCH,
          "reduced": [f"{TRAIN_ARCH}: n_layers 40 -> {TP_LAYERS} (every width kept), f32 "
                      f"compute (the traced step: {FSDP_COUNTED_DTYPE})",
                      "grok-1-314b: its smoke config"],
          "tol": {"grad_rel": TP_GRAD_REL, "loss_rtol": TP_LOSS_RTOL, **TP_PARAM_TOL},
          # rank 0's traced step: its collectives by kind and dtype, [count, bytes]
          "collectives": {arch: c["collectives"]
                          for arch, c in ranks[0]["meta"]["cells"].items()},
          "ranks": [r["meta"] for r in ranks], "seconds": time.perf_counter() - t0,
          "not_shown": "NCCL collectives across cards: two gloo ranks share one card, each "
                       "collective copied through the host", "name_power_limit": smi})


DECODE_ARCH = "qwen1.5-4b"
DECODE_LAYERS = 4                   # of qwen1.5-4b's 40 (every width kept)
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 256, 8
DECODE_RANKS = 2
DECODE_REL_TOL = 1e-4               # logits, of their largest magnitude
DECODE_F32_PROMPT = 2048            # the one-device run's timed f32 prefill, batch 1
DECODE_LAYOUTS = ("batch", "long")  # the batch on 'data'; the cache's length on 'data'


def decode_setup(torch, device):
    """(cfg, params, prompts) of phase decode: qwen1.5-4b at full width cut
    to DECODE_LAYERS layers, f32, prefill through the flash kernel
    (``attn_impl`` "auto"), random weights and prompts from SEED."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import model

    cfg = dataclasses.replace(configs.get(DECODE_ARCH), n_layers=DECODE_LAYERS,
                              compute_dtype="float32", param_dtype="float32", attn_impl="auto")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (DECODE_BATCH, DECODE_PROMPT))
    return cfg, model.init_params(cfg, SEED, device), torch.as_tensor(prompts, device=device)


def decode_greedy(torch, cfg, params, cache, prompts, put, sync) -> dict:
    """Prefill ``prompts`` then DECODE_NEW greedy tokens through
    ``train.step``'s steps; ``put(tokens)`` lays out a block of tokens (on a
    mesh: this rank's rows, as ``prompts`` are), and each step's logits
    are read from this rank's shard of them.  Returns the last position's
    logits of every step and the tokens (this rank's rows), the times and
    the cache."""
    from repro_torch.dist.sharding import is_dtensor
    from repro_torch.train import step as step_lib

    def local(t):
        return t.to_local() if is_dtensor(t) else t

    prefill, decode = step_lib.make_prefill_step(cfg), step_lib.make_decode_step(cfg)
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, {"tokens": put(prompts)})
    out = [local(logits)[:, -1]]
    sync()
    prefill_ms, t0 = (time.perf_counter() - t0) * 1e3, time.perf_counter()
    tokens = []
    for i in range(DECODE_NEW):
        tokens.append(out[-1].argmax(-1)[:, None])
        logits, cache = decode(params, cache, {"tokens": put(tokens[-1])}, DECODE_PROMPT + i)
        out.append(local(logits)[:, -1])
    sync()
    return {"logits": torch.stack(out).cpu().numpy(), "tokens": torch.cat(tokens, 1).cpu().numpy(),
            "prefill_ms": prefill_ms,
            "decode_ms_per_token": (time.perf_counter() - t0) * 1e3 / DECODE_NEW,
            "cache": cache}


def decode_rank(rank: int, world: int, backend: str, device_type: str, workdir: str,
                name: str) -> None:
    """World ``decode``'s rank: qwen1.5-4b's prefill and greedy decode
    (``decode_setup``) on a 1-D (data) mesh of the world's ranks, the
    params replicated and the cache laid out by ``cache_shardings`` under
    each of DECODE_LAYOUTS' rules: ``batch``, the serving rules at the
    batch (its rows split over ``data``), and ``long``, the long-context
    rules ``effective_rules`` gives a batch of 1 (the batch whole, the
    cache's length split over ``data``: each rank attends its piece, the
    pieces combined by all-reduces, which gloo takes on CUDA tensors).
    Writes this rank's logits and tokens, times, peak memory, launches,
    collectives (``CommDebugMode``'s counts) and the cache's placements
    after the last token."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import sharding
    from repro_torch.kernels import ops
    from repro_torch.models import model
    from repro_torch.train import step as step_lib

    device = _join_group(torch, rank, world, backend, device_type, workdir, name)
    try:
        mesh = init_device_mesh(device.type, (world,), mesh_dim_names=("data",))
        cfg, whole, prompts = decode_setup(torch, device)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        max_len = DECODE_PROMPT + DECODE_NEW
        res, meta = {}, {"rank": rank, "backend": dist.get_backend(), "world": world,
                         "layouts": {}}
        for label in DECODE_LAYOUTS:
            rules = step_lib.effective_rules(mesh, ShapeConfig(
                label, max_len, DECODE_BATCH if label == "batch" else 1, "decode"),
                sharding.BASE_RULES, cfg)
            long_ctx = rules["batch"] is None
            params = sharding.device_put(whole, step_lib.param_shardings(mesh, cfg, rules))
            layout = step_lib.cache_shardings(mesh, cfg, DECODE_BATCH, max_len, long_ctx, rules)
            cache = sharding.device_put(model.init_cache(cfg, DECODE_BATCH, max_len, long_ctx,
                                                         device), layout)
            placements = step_lib.batch_shardings(mesh, cfg, {"tokens": 0}, rules)[
                "tokens"].placements
            split = placements[0].is_shard()
            _peak_reset(torch, device)
            ops.reset_launch_counts()
            with CommDebugMode() as comm, sharding.sharding_ctx(mesh, rules):
                run = decode_greedy(torch, cfg, params, cache,
                                    prompts.chunk(world)[rank] if split else prompts,
                                    lambda t: DTensor.from_local(t, mesh, placements,
                                                                 run_check=False), sync)
            cache = run.pop("cache")
            res[f"{label}/logits"], res[f"{label}/tokens"] = run.pop("logits"), run.pop("tokens")
            meta["layouts"][label] = {
                **run, "peak_bytes": _peak(torch, device), "launches": launch_counts_by_body(),
                "collectives": {str(k): v for k, v in comm.get_comm_counts().items()},
                "rows": list(range(rank * DECODE_BATCH // world, (rank + 1) * DECODE_BATCH
                                   // world)) if split else list(range(DECODE_BATCH)),
                "cache_placements": [str(p) for p in cache["attn"]["k"].placements],
                "cache_layout": [str(p) for p in layout["attn"]["k"].placements],
                "cache_local_shape": list(cache["attn"]["k"].to_local().shape)}
            del params, cache
        np.savez(os.path.join(workdir, "dist", f"{name}{rank}.npz"),
                 meta=np.array(json.dumps(meta)), **res)
    finally:
        dist.destroy_process_group()


def decode_prefill_f32(torch, cfg, params, sync) -> dict:
    """One timed f32 prefill of a DECODE_F32_PROMPT-token prompt from SEED,
    batch 1, through the flash kernel (``attn_impl`` "auto": its tf32x3
    body) and through the oracle ("ref"), each after an untimed one: per
    route the host ms around the timed prefill (it ends in a synchronise)
    and the launches read after each prefill, the untimed one's under
    ``launches_untimed``; the last position's logits within DECODE_REL_TOL of
    their largest magnitude and the greedy next token equal."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import model

    device = params["tok"]["embed"].device
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (1, DECODE_F32_PROMPT)), device=device)
    out, logits = {}, {}
    for impl in ("auto", "ref"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        counts = []
        for timed in (False, True):
            cache = model.init_cache(c, 1, DECODE_F32_PROMPT, device=device)
            ops.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            with torch.no_grad():
                got, _ = model.prefill(params, c, tokens=tokens, cache=cache)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            counts.append(launch_counts_by_body())
            del cache
        logits[impl] = got[0, -1, : cfg.vocab].float()
        del got
        out[impl] = {"prefill_f32_ms": ms, "launches": counts[1], "launches_untimed": counts[0]}
    top = float(logits["ref"].abs().max())
    err = float((logits["auto"] - logits["ref"]).abs().max())
    greedy = [int(logits[impl].argmax()) for impl in ("auto", "ref")]
    require(err <= DECODE_REL_TOL * top,
            f"decode.prefill_f32: logits differ by {err} (largest {top})")
    require(greedy[0] == greedy[1], f"decode.prefill_f32: greedy tokens {greedy}")
    for run in ("launches_untimed", "launches"):
        require(out["auto"][run]["flash_attention"]
                == out["auto"][run]["flash_attention_f32"] == cfg.n_layers
                and out["ref"][run]["flash_attention"] == 0,
                f"decode.prefill_f32: flash launches {out['auto'][run]} (kernel route), "
                f"{out['ref'][run]} (oracle route) in {run}; one a layer, all on the tf32x3 "
                "body")
    return {"prompt": DECODE_F32_PROMPT, "batch": 1, "routes": out, "max_abs_err": err,
            "max_abs_logit": top, "max_abs_err_rel": err / top, "greedy_token": greedy[0]}


def phase_decode(torch, device, smi, workdir) -> int:
    """qwen1.5-4b's sharded decode (``decode_rank``) on DECODE_RANKS gloo
    ranks sharing ``cuda:0``, against this process's decode of the same
    layers on one device: the greedy tokens equal and the logits within
    DECODE_REL_TOL of their largest magnitude under each layout, the cache
    still in its layout after the last token; every prefill's flash
    launches on the tf32x3 body.  Then one timed f32 prefill of
    DECODE_F32_PROMPT tokens on each route (``decode_prefill_f32``).
    Returns the launches of the tf32x3 body on the phase's kernel-route
    runs (one device, the ranks, the timed prefill and its warm-up)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models import model

    t0 = time.perf_counter()
    os.makedirs(os.path.join(workdir, "dist"), exist_ok=True)
    cfg, params, prompts = decode_setup(torch, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    _peak_reset(torch, device)
    ops.reset_launch_counts()
    with torch.no_grad():
        want = decode_greedy(torch, cfg, params, model.init_cache(
            cfg, DECODE_BATCH, DECODE_PROMPT + DECODE_NEW, device=device), prompts,
            lambda t: t, sync)
    want.pop("cache")
    one = {"prefill_ms": want["prefill_ms"], "decode_ms_per_token": want["decode_ms_per_token"],
           "peak_bytes": _peak(torch, device), "launches": launch_counts_by_body()}
    require(one["launches"]["flash_attention"] == one["launches"]["flash_attention_f32"]
            == DECODE_LAYERS, f"decode: one device's flash launches {one['launches']}; the "
                              "prefill runs the tf32x3 body once a layer")
    prefill_f32 = decode_prefill_f32(torch, cfg, params, sync)
    del params
    ranks = run_world("decode", DECODE_RANKS, "gloo", device.type, workdir, target=decode_rank)
    top = float(np.abs(want["logits"]).max())
    report = {}
    for label in DECODE_LAYOUTS:
        metas = [r["meta"]["layouts"][label] for r in ranks]
        logits = np.zeros_like(want["logits"])
        tokens = np.zeros_like(want["tokens"])
        for res, m in zip(ranks, metas):
            logits[:, m["rows"]] = res[f"{label}/logits"]
            tokens[m["rows"]] = res[f"{label}/tokens"]
        err = float(np.abs(logits - want["logits"]).max())
        report[label] = {"max_abs_err": err, "max_abs_err_rel": err / top,
                         "tokens_equal": bool(np.array_equal(tokens, want["tokens"])),
                         "ranks": metas}
        require(report[label]["tokens_equal"],
                f"decode.{label}: greedy tokens {tokens.tolist()} vs {want['tokens'].tolist()}")
        require(err <= DECODE_REL_TOL * top,
                f"decode.{label}: logits differ by {err} (largest {top})")
        for m in metas:
            require(m["cache_placements"] == m["cache_layout"],
                    f"decode.{label}: the cache left its layout: {m['cache_placements']} vs "
                    f"{m['cache_layout']}")
            require(m["launches"]["flash_attention"] == m["launches"]["flash_attention_f32"]
                    == DECODE_LAYERS,
                    f"decode.{label}: flash launches {m['launches']}; the prefill runs the "
                    "tf32x3 body once a layer")
    emit({"phase": "decode", "arch": DECODE_ARCH, "layers": DECODE_LAYERS,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "compute_dtype": cfg.compute_dtype,
          "batch": DECODE_BATCH, "prompt": DECODE_PROMPT, "new_tokens": DECODE_NEW,
          "reduced": [f"n_layers 40 -> {DECODE_LAYERS} (every width kept)"],
          "world": DECODE_RANKS, "backend": "gloo", "mesh": {"data": DECODE_RANKS},
          "tol_rel": DECODE_REL_TOL, "max_abs_logit": top, "one_device": one,
          "tokens": want["tokens"].tolist(), "layouts": report, "prefill_f32": prefill_f32,
          "prefill_f32_ms": {impl: r["prefill_f32_ms"]
                             for impl, r in prefill_f32["routes"].items()},
          "seconds": time.perf_counter() - t0,
          "not_shown": "NCCL collectives across cards: two gloo ranks share one card, "
                       "each all-reduce copied through the host",
          "name_power_limit": smi})
    return (one["launches"]["flash_attention_f32"]
            + sum(r["meta"]["layouts"][label]["launches"]["flash_attention_f32"]
                  for r in ranks for label in DECODE_LAYOUTS)
            + sum(prefill_f32["routes"]["auto"][run]["flash_attention_f32"]
                  for run in ("launches_untimed", "launches")))


def pp_setup(torch, device):
    """(cfg, the blocks' params, microbatches [M, mb, S, d]) of phase pp:
    minicpm-2b at full width, PP_LAYERS layers, f32 compute, the inputs
    the embedding of random tokens (seed SEED)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models import layers, model

    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=PP_LAYERS,
                              compute_dtype="float32")
    params = model.init_params(cfg, SEED, device)
    mb, seq = PP_MICROBATCH
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab, (PP_MICROBATCHES * mb, seq))
    with torch.no_grad():
        x = layers.embed_lookup(params["tok"], torch.as_tensor(tokens, device=device),
                                torch.float32)
    return cfg, params["blocks"], x.reshape(PP_MICROBATCHES, mb, seq, cfg.d_model)


def pp_stack(cfg):
    """``fn(stage_params, x)``: the blocks of a stage applied in turn."""
    from repro_torch.dist.sharding import leaves
    from repro_torch.models import transformer

    def fn(blocks, x):
        n = leaves(blocks)[0].shape[0]
        for bp in transformer._unstack(blocks, n):
            x, _ = transformer.apply_block(bp, x, cfg, None, None, "full")
        return x

    return fn


def pp_rank(rank: int, world: int, backend: str, device_type: str, workdir: str,
            name: str) -> None:
    """World ``pp``'s rank: its stage of minicpm-2b's block stack (its
    slice of every leaf, a ``DTensor`` sharded over ``pod``), run through
    ``pipeline_forward`` once checked and PP_TIMED times with its stats;
    writes the output and the timings."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import pipeline_parallel as pp
    from repro_torch.dist.sharding import NamedSharding, PartitionSpec, device_put, leaves
    from repro_torch.kernels import ops

    device = _join_group(torch, rank, world, backend, device_type, workdir, name)
    try:
        mesh = init_device_mesh(device.type, (world,), mesh_dim_names=("pod",))
        cfg, blocks, x = pp_setup(torch, device)
        stages = device_put(pp.split_stages(blocks, world),
                            NamedSharding(mesh, PartitionSpec("pod")))
        del blocks
        fn = pp_stack(cfg)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        ops.reset_launch_counts()
        with torch.no_grad():
            out = pp.pipeline_forward(fn, stages, x, mesh, axis="pod")
            runs = []
            for _ in range(PP_TIMED):
                stats = {}
                sync()
                t0 = time.perf_counter()
                pp.pipeline_forward(fn, stages, x, mesh, axis="pod", stats=stats)
                sync()
                stats["seconds"] = time.perf_counter() - t0
                runs.append(stats)
        ticks = [t for r in runs for t in r["tick_seconds"]]
        tick_s = sum(ticks)
        meta = {"backend": dist.get_backend(), "world": dist.get_world_size(), "rank": rank,
                "device": str(x.device), "stage": mesh.get_local_rank("pod"),
                "stage_leaf_local_shape": list(leaves(stages)[0].to_local().shape),
                "launches": ops.launch_counts(),
                "ticks": runs[0]["ticks"], "bubble_fraction": runs[0]["bubble_fraction"],
                "run_ms": [r["seconds"] * 1e3 for r in runs],
                "ms_per_tick_median": float(np.median(ticks)) * 1e3,
                "staging_share": sum(r["staging_seconds"] for r in runs) / tick_s,
                "compute_share": sum(r["compute_seconds"] for r in runs) / tick_s}
        np.savez(os.path.join(workdir, "dist", f"{name}{rank}.npz"), out=out.cpu().numpy(),
                 meta=np.array(json.dumps(meta)))
    finally:
        dist.destroy_process_group()


def phase_pp(torch, device, smi, workdir) -> None:
    """minicpm-2b's block stack as a PP_STAGES-stage GPipe pipeline on two
    gloo ranks sharing the card (hops staged through the host), against
    this process's stack forward of the same layers."""
    import numpy as np

    t0 = time.perf_counter()
    os.makedirs(os.path.join(workdir, "dist"), exist_ok=True)
    cfg, blocks, x = pp_setup(torch, device)
    with torch.no_grad():
        want = pp_stack(cfg)(blocks, x.reshape(-1, *x.shape[2:])).reshape(x.shape)
    want = want.cpu().numpy()
    del blocks, x
    ranks = run_world("pp", PP_STAGES, "gloo", device.type, workdir, target=pp_rank)
    got = ranks[0]["out"]
    for r, res in enumerate(ranks[1:], 1):
        require(np.array_equal(res["out"], got), f"pp: rank {r}'s output differs from rank 0's")
    err = float(np.abs(got - want).max())
    require(np.allclose(got, want, rtol=PP_TOL, atol=PP_TOL),
            f"pp: the pipeline's output is {err} from the stack forward's")
    metas = [r["meta"] for r in ranks]
    for m in metas:
        require(not any(m["launches"].values()),
                f"pp rank {m['rank']} launched {m['launches']}; its attention is the oracle")
    emit({"phase": "pp", "arch": TRAIN_ARCH, "layers": PP_LAYERS, "stages": PP_STAGES,
          "microbatches": PP_MICROBATCHES, "microbatch": list(PP_MICROBATCH),
          "d_model": cfg.d_model, "compute_dtype": cfg.compute_dtype,
          "reduced": [f"n_layers 40 -> {PP_LAYERS} (every width kept)"],
          "max_abs_err": err, "max_abs_want": float(np.abs(want).max()), "tol": PP_TOL,
          "bubble_fraction": metas[0]["bubble_fraction"], "ranks": metas,
          "seconds": time.perf_counter() - t0,
          "not_shown": "NCCL collectives across cards: two gloo ranks share one card, "
                       "each hop copied through the host",
          "name_power_limit": smi})


DRYRUN_FLOPS_RTOL = 0.01            # the cost pass's FLOPs against the card's count
DRYRUN_PEAK_RTOL = 0.25             # its peak against torch.cuda.max_memory_allocated
DRYRUN_CODEC = dict(rank=10, hidden=18, entries=8192)  # MEDIUM widths, entries a step
DRYRUN_SINGLE_DP = 16               # the single mesh's data-parallel ranks
DRYRUN_DECODE_CELL = ("qwen1.5-4b", "decode_32k", "single", "auto")
DRYRUN_CARD_BYTES = 80e9            # one card: the decode cell's predicted peak must fit
EXAMPLES = ("torch_quickstart.py", "torch_serve_llm.py", "torch_train_lm.py",
            "torch_compressed_checkpoint.py")
EXAMPLE_TIMEOUT = 420               # seconds an example may take, start-up included


def long_step_script():
    """``scripts/torch_long_step.py``, the long cell's cost pass and step."""
    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import torch_long_step

    return torch_long_step


def dryrun_fake(workdir: str) -> None:
    """Phase dryrun's cost passes, in fake process groups of this spawned
    process; writes ``workdir/dist/dryrun_fake.json``."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, dryrun_codec
    from repro_torch.launch import mesh as mesh_lib

    out = {}
    t0 = time.perf_counter()
    dryrun.fake_world(1)
    with depth_cut(configs, TP_LAYERS):
        cfg = configs.get(TRAIN_ARCH)
    shape = ShapeConfig("tp", TP_GRAD_BATCH[1], TP_GRAD_BATCH[0], "train")
    out["tp"] = dryrun.cost_cell(TRAIN_ARCH, shape, mesh_lib.make_debug_mesh(1, 1, device="cpu"),
                                 "base", cfg=cfg)
    out["tp"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["long"] = long_step_script().cost()
    out["long"]["seconds"] = time.perf_counter() - t0
    c = DRYRUN_CODEC
    out["codec_step"] = dryrun_codec.run("single", "ref", c["entries"] * DRYRUN_SINGLE_DP, 1,
                                         c["rank"], c["hidden"], PEMS_SHAPE, verbose=False)
    for mesh in ("single", "multi"):
        t0 = time.perf_counter()
        out[f"codec_{mesh}"] = dryrun_codec.run(mesh, "ref", 1 << 20, 4, 8, 16, verbose=False)
        out[f"codec_{mesh}"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["mamba"] = dryrun.run_cell("mamba2-1.3b", "decode_32k", "single", verbose=False)
    out["mamba"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["qwen_decode"] = dryrun.run_cell(*DRYRUN_DECODE_CELL, verbose=False)
    out["qwen_decode"]["seconds"] = time.perf_counter() - t0
    with open(os.path.join(workdir, "dist", "dryrun_fake.json"), "w") as f:
        json.dump(out, f)


def dryrun_rank(rank: int, world: int, backend: str, device_type: str, workdir: str,
                name: str) -> None:
    """World ``dryrun``'s rank: phase tp's step (minicpm-2b cut to
    TP_LAYERS, a TP_GRAD_BATCH batch) on ``DTensor``s of a 1 x 1 mesh,
    once to warm up and once under ``FlopCounterMode`` with the peak
    memory reset before it; writes the count and the peak."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import model
    from repro_torch.optim import optimizers
    from repro_torch.train import step as step_lib

    device = _join_group(torch, rank, world, backend, device_type, workdir, name)
    try:
        mesh = mesh_lib.make_debug_mesh(1, 1, device=device_type)
        rules = sharding.BASE_RULES
        with depth_cut(configs, TP_LAYERS):
            cfg = configs.get(TRAIN_ARCH)
        tokens = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                                      TP_GRAD_BATCH),
                                 dtype=torch.int32, device=device)
        batch = sharding.device_put({"tokens": tokens, "labels": torch.roll(tokens, -1, 1)},
                                    step_lib.batch_shardings(mesh, cfg, {"tokens": 0,
                                                                         "labels": 0}, rules))
        params = model.init_params(cfg, SEED, device, step_lib.param_shardings(mesh, cfg, rules))
        opt = optimizers.adamw(TRAIN_LR, weight_decay=0.1, max_grad_norm=1.0)
        state = sharding.device_put(opt.init(params), step_lib.opt_shardings(mesh, cfg, rules))
        step = step_lib.make_train_step(cfg, opt)
        with sharding.sharding_ctx(mesh, rules):
            step(params, state, batch)
            _peak_reset(torch, device)
            before = torch.cuda.memory_allocated() if device.type == "cuda" else 0
            with FlopCounterMode(display=False) as counter:
                step(params, state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize()
        meta = {"flops": counter.get_total_flops(), "peak_bytes": _peak(torch, device),
                "allocated_before_bytes": before, "world": dist.get_world_size(),
                "backend": dist.get_backend()}
        del params, state, batch, step
        if device.type == "cuda":  # the long cell's step: its own peak
            _peak_reset(torch, device)
            meta["long"] = long_step_script().card_step(torch, seed=SEED)
        np.savez(os.path.join(workdir, "dist", f"{name}{rank}.npz"),
                 meta=np.array(json.dumps(meta)))
    finally:
        dist.destroy_process_group()


def codec_step_flops(torch, device) -> int:
    """``FlopCounterMode``'s count over one real "ref" step of the NTTD fit
    at the MEDIUM widths, DRYRUN_CODEC's entries of the PEMS-SF shape."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import codec as codec_lib
    from repro_torch.core import nttd
    from repro_torch.core.folding import make_folding_spec
    from repro_torch.optim import optimizers

    c = DRYRUN_CODEC
    spec = make_folding_spec(PEMS_SHAPE)
    cfg = nttd.NTTDConfig(rank=c["rank"], hidden=c["hidden"], kernel_impl="ref")
    params = nttd.init_params(torch.Generator().manual_seed(SEED), spec, cfg, device)
    opt = optimizers.adam(1e-2)
    rng = np.random.default_rng(SEED)
    pos = torch.as_tensor(np.stack([rng.integers(0, s, c["entries"]) for s in PEMS_SHAPE], 1),
                          device=device)
    vals = torch.as_tensor(rng.random(c["entries"]), dtype=torch.float32, device=device)
    with FlopCounterMode(display=False) as counter:
        codec_lib._make_train_step(spec, cfg, opt)(params, opt.init(params), pos, vals)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return counter.get_total_flops()


def phase_dryrun(torch, device, smi, workdir) -> None:
    """The cost pass's FLOPs and peak against the card's readings (world
    ``dryrun``), the codec step's FLOPs against a real step, and the cost
    cells of ``dryrun_fake``, which runs beside the world."""
    import multiprocessing

    t0 = time.perf_counter()
    os.makedirs(os.path.join(workdir, "dist"), exist_ok=True)
    fake = multiprocessing.get_context("spawn").Process(target=dryrun_fake, args=(workdir,))
    fake.start()
    try:
        backend = "nccl" if device.type == "cuda" else "gloo"
        (res,) = run_world("dryrun", 1, backend, device.type, workdir, target=dryrun_rank)
        codec_flops = codec_step_flops(torch, device)
        fake.join(DIST_TIMEOUT)
    finally:
        if fake.is_alive():
            fake.kill()
            fake.join()
    require(fake.exitcode == 0, f"dryrun: the cost passes' process exited {fake.exitcode}")
    with open(os.path.join(workdir, "dist", "dryrun_fake.json")) as f:
        pred = json.load(f)
    real = res["meta"]
    tp = pred["tp"]
    flops_rel = abs(tp["flops_per_device"] - real["flops"]) / real["flops"]
    peak = tp["memory"]["peak_per_device"]
    peak_rel = abs(peak - real["peak_bytes"]) / max(real["peak_bytes"], 1)
    codec_rel = abs(pred["codec_step"]["flops_per_device"] - codec_flops) / codec_flops
    cells = {k: pred[k]["status"] for k in ("codec_single", "codec_multi", "mamba",
                                            "qwen_decode")}
    qwen = pred["qwen_decode"]
    long = pred["long"]
    long_card = real.get("long", {"peak_bytes": 0})
    long_rel = abs(long["peak_bytes"] - long_card["peak_bytes"]) / max(long_card["peak_bytes"], 1)
    block = long["score_block_bytes"]
    attention = (long["attention_term"] or {"bytes": 0})["bytes"]
    cell = long_step_script().CELL
    emit({"phase": "dryrun.long", **cell,
          "reduced": [f"n_layers 40 -> {cell['layers']} (every width kept)"],
          "mesh": "1x1", "peak_predicted_bytes": long["peak_bytes"],
          "peak_card_bytes": long_card["peak_bytes"], "peak_rel_err": long_rel,
          "loss_card": long_card.get("loss"), "flops_predicted": long["flops"],
          "score_block_bytes": block, "attention_term": long["attention_term"],
          "oracle_most_bytes": long["oracle_most_bytes"],
          "oracle_most_score_blocks": long["oracle_most_bytes"] / block,
          "oracle_bound_bytes": long["oracle_bound_bytes"],
          "peak_terms": long["peak_terms"], "predicted_memory": long["memory"],
          "cost_pass_seconds": long["seconds"], "name_power_limit": smi})
    emit({"phase": "dryrun", "arch": TRAIN_ARCH, "layers": TP_LAYERS, "batch": TP_GRAD_BATCH,
          "mesh": "1x1", "backend": real["backend"],
          "flops_predicted": tp["flops_per_device"], "flops_card": real["flops"],
          "flops_rel_err": flops_rel, "peak_predicted_bytes": peak,
          "peak_card_bytes": real["peak_bytes"], "peak_rel_err": peak_rel,
          "allocated_before_step_bytes": real["allocated_before_bytes"],
          "predicted_memory": tp["memory"], "cost_pass_seconds": tp["seconds"],
          "codec_step": {**DRYRUN_CODEC, "shape": list(PEMS_SHAPE),
                         "flops_predicted": pred["codec_step"]["flops_per_device"],
                         "flops_card": codec_flops, "flops_rel_err": codec_rel},
          "codec_cells": {m: {k: pred[f"codec_{m}"][k] for k in (
              "status", "flops_per_device", "hlo_bytes_per_device",
              "collective_bytes_per_device", "memory", "roofline", "seconds")}
              for m in ("single", "multi")},
          "mamba2_decode_32k_single": {k: pred["mamba"][k] for k in (
              "status", "seconds", "seconds_lower", "seconds_cost_passes", "flops_per_device",
              "hlo_bytes_per_device", "memory", "roofline")},
          "qwen1.5-4b_decode_32k_single": {k: qwen.get(k) for k in (
              "status", "rules", "seconds", "seconds_cost_passes", "flops_per_device",
              "hlo_bytes_per_device", "collective_bytes_per_device", "collective_ops",
              "memory", "roofline")},
          "tol": {"flops_rtol": DRYRUN_FLOPS_RTOL, "peak_rtol": DRYRUN_PEAK_RTOL,
                  "decode_cell_peak_bytes_below": DRYRUN_CARD_BYTES},
          "seconds": time.perf_counter() - t0, "name_power_limit": smi})
    require(flops_rel <= DRYRUN_FLOPS_RTOL,
            f"dryrun: predicted FLOPs {tp['flops_per_device']} vs the card's {real['flops']}")
    require(peak_rel <= DRYRUN_PEAK_RTOL,
            f"dryrun: predicted peak {peak} vs the card's {real['peak_bytes']}")
    require(codec_rel <= DRYRUN_FLOPS_RTOL,
            f"dryrun: the codec step's predicted FLOPs {pred['codec_step']['flops_per_device']} "
            f"vs the card's {codec_flops}")
    require(all(v == "ok" for v in cells.values()), f"dryrun: cost cells {cells}")
    require(long_rel <= DRYRUN_PEAK_RTOL,
            f"dryrun.long: predicted peak {long['peak_bytes']} vs the card's "
            f"{long_card['peak_bytes']}")
    require(attention <= 2 * block,
            f"dryrun.long: the oracle's largest term at the peak is {attention} bytes, more "
            f"than one chunk's two f32 score blocks ({2 * block})")
    require(long["oracle_most_bytes"] <= long["oracle_bound_bytes"],
            f"dryrun.long: the oracle holds {long['oracle_most_bytes']} bytes at once, more "
            f"than one chunk's score blocks and operands ({long['oracle_bound_bytes']})")
    require(qwen["memory"]["peak_per_device"] < DRYRUN_CARD_BYTES,
            f"dryrun: {DRYRUN_DECODE_CELL} peaks at {qwen['memory']['peak_per_device']} bytes "
            "a card")


def phase_examples(smi, workdir) -> None:
    """The four port examples on the card at their default sizes, started
    together as subprocesses (temporary files in ``workdir``); each must
    exit 0 within EXAMPLE_TIMEOUT."""
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "2", "TMPDIR": workdir}
    procs = {name: subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", name)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, env=env, cwd=workdir)
             for name in EXAMPLES}
    started = time.perf_counter()
    runs = {}
    try:
        for name, p in procs.items():
            left = max(1.0, EXAMPLE_TIMEOUT - (time.perf_counter() - started))
            try:
                text, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            runs[name] = {"rc": p.returncode,
                          "finished_within_s": time.perf_counter() - started,
                          "lines": text.splitlines()[-24:]}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    emit({"phase": "examples", "examples": runs, "seconds": time.perf_counter() - t0,
          "name_power_limit": smi})
    failed = {k: v["rc"] for k, v in runs.items() if v["rc"] != 0}
    require(not failed, f"examples: exit codes {failed}")


FIT_STEP_SHAPE = (8192, 10, 18, 10)  # B, T (PEMS-SF's d'), H, R of the MEDIUM fit


def fit_step_operands(torch, device):
    """The backward kernels' operands at the MEDIUM fit shape: the
    lstm_scan backward's (x, (wi, wh, b), hs, dhs), hs from the forward
    kernel as training saves it, and the tt_contract backward's (first,
    mid, last, dout) at K = T - 2."""
    from repro_torch.kernels import ops

    b, t, h, r = FIT_STEP_SHAPE
    gen = torch.Generator().manual_seed(SEED)
    x, lw, dhs = lstm_bwd_inputs(torch, gen, b, t, h, device)
    hs = ops.lstm_scan(x, *lw, impl="cuda")
    return (x, lw, hs, dhs), tt_bwd_inputs(torch, gen, b, t - 2, r, device)


def bwd_timing(torch, device, fit_launches, errs, step_s, operands, bwd_ops):
    """The two backward kernels at the MEDIUM fit shape (B 8192, T 10 (PEMS-
    SF's d'), H 18, R 10, K 8; ``operands`` from ``fit_step_operands``): the
    whole backward call a training step makes, the kernel alone where the
    call adds products, the plain version and, for ``lstm_scan``, cuDNN's
    backward, with CUDA events like every row; each row also names its plan
    and the device operations of one call with their device microseconds
    (``bwd_ops``, from ``phase_timing``'s profiler session), and the
    ``tt_contract`` row its share of the bound by both times.  A
    ``timing.fit_step`` line sets the four kernels of a step beside the fit
    phase's seconds a step.  Returns the two rows."""
    from repro_torch.kernels import lstm as _lstm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import tt_contract as _tt

    b, t, h, r = FIT_STEP_SHAPE
    k = t - 2
    (x, lw, hs, dhs), (first, mid, last, dout) = operands
    lib_run, lib_grads = cudnn_lstm_backward(torch, x, *lw, dhs)
    plain_grads = ref.lstm_scan_bwd(x, *lw, dhs)
    lib_err = max(float((g - w).abs().max()) for g, w in zip(lib_grads(), plain_grads))
    rows = []
    n_ops, n_bytes = lstm_bwd_cost(b, t, h)
    k_ops, k_bytes = lstm_bwd_kernel_cost(b, t, h)
    kernel_bound = bound(k_ops, k_bytes, PEAK_FP32)
    rows.append({
        "name": "lstm_scan_bwd", "route": "cuda", "source": SOURCES["lstm_scan_bwd"][0],
        "replaces": SOURCES["lstm_scan_bwd"][1], "launches": fit_launches["lstm_scan_bwd"],
        "max_abs_err": errs["lstm_scan_bwd"],
        "ms": time_ms(torch, lambda: _lstm.lstm_scan_bwd(x, *lw, hs, dhs), 20),
        "plain_ms": time_ms(torch, lambda: ref.lstm_scan_bwd(x, *lw, dhs), 5),
        **bound(n_ops, n_bytes, PEAK_FP32),
        "library_ms": time_ms(torch, lib_run, 20),
        "library": "cuDNN torch.nn.LSTM backward: autograd.grad of a kept forward graph, "
                   "dx and every weight", "library_max_abs_err": lib_err,
        "kernel_ms": time_ms(torch, lambda: _lstm.bwd_gates(x, *lw, hs, dhs), 20),
        "kernel_bound_ms": kernel_bound["bound_ms"], "kernel_bound_by": kernel_bound["bound_by"],
        "kernel_ops": k_ops, "kernel_bytes": k_bytes,
        "plan": dataclasses.asdict(_lstm.bwd_plan(h, b)), "device_ops_per_call": bwd_ops[0],
        "shape": {"B": b, "T": t, "H": h}, "ops": n_ops, "bytes": n_bytes,
        "note": "ms: the wrapper (the kernel: dx, G and A; then [dwi; dwh; db] = A^T G, one "
                "matmul); kernel_ms: the kernel alone; plain_ms: autograd of the plain forward, "
                "forward included",
    })
    n_ops, n_bytes = tt_bwd_cost(b, k, r)
    plan = _tt.bwd_plan(r, k, b, torch.cuda.get_device_properties(device).multi_processor_count)
    rows.append({
        "name": "tt_contract_bwd", "route": "cuda", "source": SOURCES["tt_contract_bwd"][0],
        "replaces": SOURCES["tt_contract_bwd"][1], "launches": fit_launches["tt_contract_bwd"],
        "max_abs_err": errs["tt_contract_bwd"],
        "ms": time_ms(torch, lambda: _tt.tt_contract_bwd(first, mid, last, dout), 20),
        "plain_ms": time_ms(torch, lambda: ref.tt_contract_bwd(first, mid, last, dout), 5),
        **bound(n_ops, n_bytes, PEAK_FP32), "library_ms": None,
        "library": None, "library_max_abs_err": None,
        "plan": plan.kind, "entries": plan.entries, "blocks": plan.blocks,
        "threads": plan.threads, "device_ops_per_call": bwd_ops[1],
        "kernel_ms": bwd_ops[1][0][1] / 1e3, "shape": {"B": b, "K": k, "R": r},
        "ops": n_ops, "bytes": n_bytes,
        "note": "ms: back-to-back calls (CUDA events), host work included where it outlasts "
                "the kernel; kernel_ms: the kernel's device time in one profiled call",
    })
    rows[1].update(bound_share=rows[1]["bound_ms"] / rows[1]["ms"],
                   kernel_bound_share=rows[1]["bound_ms"] / rows[1]["kernel_ms"])
    step = {"lstm_scan": time_ms(torch, lambda: ops.lstm_scan(x, *lw, impl="cuda"), 20),
            "lstm_scan_bwd": rows[0]["ms"],
            "tt_contract": time_ms(torch, lambda: ops.tt_contract(first, mid, last,
                                                                  impl="cuda"), 20),
            "tt_contract_bwd": rows[1]["ms"]}
    # each kernel's bound at this shape (the forward rows of the kernel
    # table are at a decode request's shape)
    bounds = {"lstm_scan": bound(*lstm_cost(b, t, h), PEAK_FP32),
              "lstm_scan_bwd": {"bound_ms": rows[0]["bound_ms"],
                                "bound_by": rows[0]["bound_by"]},
              "tt_contract": bound(b * (k * 2 * r * r + 2 * r), tt_bytes(b, k, r, 4), PEAK_FP32),
              "tt_contract_bwd": {"bound_ms": rows[1]["bound_ms"],
                                  "bound_by": rows[1]["bound_by"]}}
    kernel_ms = sum(step.values())
    emit({"phase": "timing.fit_step", "shape": {"B": b, "T": t, "H": h, "R": r},
          "ms": step, "bounds": bounds, "kernels_ms": kernel_ms, "step_ms": step_s * 1e3,
          "kernels_share_of_step": kernel_ms / (step_s * 1e3)})
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # full f32 everywhere: no TF32 in matmuls (the unfused heads, the plain
    # versions) or in cuDNN (the nn.LSTM yardstick)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")  # files phase service serves
    try:
        smi = phase_device(torch)
        errs = phase_kernels(torch, device)
        errs.update(phase_kernels_bwd(torch, device))
        phase_golden(torch, device)
        enc, idx, launches = phase_main(torch, device)
        simt_launches, lstm_simt_launches = phase_wide(torch, device)
        fit_launches, step_s = phase_fit(torch, device)
        phase_fit_parity(torch, device)
        fit_budget_launches = phase_fit_budget(torch, device)
        stream_launches, stream_step_s, stream_path = phase_stream(torch, device, smi, workdir)
        phase_stream_parity(torch, device)
        delta_path = phase_stream_delta(torch, device, workdir)
        service_launches, store_launches, *served = phase_service(
            torch, device, smi, enc, workdir, stream_path, delta_path)
        fleet_launches = phase_fleet(torch, device, smi, workdir, *served)
        serve_launches = phase_serve(torch, device)
        family_launches = phase_families(torch, device)
        train_launches = phase_train_all(torch, device, smi, workdir)
        dist_launches = phase_dist(torch, device, smi, workdir)
        phase_tp(torch, device, smi, workdir)
        phase_fsdp(torch, device, smi, workdir)
        decode_f32_launches = phase_decode(torch, device, smi, workdir)
        phase_pp(torch, device, smi, workdir)
        phase_dryrun(torch, device, smi, workdir)
        phase_examples(smi, workdir)
        simt_lstm = lstm_simt_timing(torch, device, lstm_simt_launches, errs)
        from repro_torch.kernels import lstm as _lstm
        from repro_torch.kernels import tt_contract as _tt

        fit_ops = fit_step_operands(torch, device)
        (x, lw, hs, dhs), tt_ops = fit_ops
        flash_calls = flash_f32_calls(torch, device)
        kernels, bwd_ops, flash_ops = phase_timing(
            torch, device, enc, idx, launches, errs, simt_lstm,
            (lambda: _lstm.lstm_scan_bwd(x, *lw, hs, dhs), lambda: _tt.tt_contract_bwd(*tt_ops)),
            flash_calls)
        for row in kernels:  # the forward kernels' launches on the fit path too
            row["launches_fit"] = fit_launches[row["name"]]
        kernels.append(decode_simt_timing(torch, device, simt_launches, errs))
        kernels.append(simt_lstm[0])
        kernels.append(flash_timing_row(torch, device, serve_launches, errs))
        kernels.append(flash_f32_timing(
            torch, flash_calls, flash_ops, {"decode": decode_f32_launches,
                                            "families": family_launches["flash_attention_f32"]},
            errs))
        del flash_calls
        kernels.extend(bwd_timing(torch, device, fit_launches, errs, step_s, fit_ops, bwd_ops))
        kernels.append(tt_bwd_wide_row(torch, device, fit_budget_launches["tt_contract_bwd_wide"],
                                       errs))
        for row in kernels:  # and on the budget fit's path (phase fit_budget)
            row["launches_fit_budget"] = fit_budget_launches.get(row["name"], 0)
        stream_step_timing(torch, device, stream_step_s)
        for row in kernels:  # and on the stream path (phase stream)
            if row["name"] in stream_launches:
                row["launches_stream"] = stream_launches[row["name"]]
        for row in kernels:  # and on the service path: its first pass, the store's fits
            if row["name"] in service_launches:
                row["launches_service"] = (service_launches[row["name"]]
                                           + store_launches[row["name"]])
        for row in kernels:  # and in phase fleet, this process's launches (the simt
            # bodies never run there: hidden 16 and 24 are register buckets)
            row["launches_fleet"] = fleet_launches.get(row["name"], 0)
        for row in kernels:  # and in the families phases' kernel-route runs
            row["launches_families"] = family_launches.get(row["name"], 0)
        for row in kernels:  # and in the train phases (flash: 0, training runs the oracle)
            row["launches_train"] = train_launches.get(row["name"], 0)
        for row in kernels:  # and in the data-parallel epochs' ranks (phase dist)
            row["launches_dist"] = dist_launches.get(row["name"], 0)
        torch.cuda.synchronize()
        emit({"kernels": kernels})
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
