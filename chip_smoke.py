#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (``PATH`` or ``/usr/local/cuda``) and the
repository checkout around this file; imports no jax and nothing of the
JAX package. Phases, each printing one JSON line:

  1. device and build: the card, ``nvidia-smi``'s name and power limit,
     and the seven kernels built from ``src/repro_torch/kernels/csrc``
     into ``build/repro_torch_kernels/`` with ptxas's registers / smem;

DISGD (K1-K3):

  2. main path at deployment size: ``run_stream`` (backend ``"cuda"``)
     over ``synth_stream(MOVIELENS_25M)`` on a 4 x 4 grid with tables
     that hold each column's users and each split's items without
     collisions (the ``rated`` tables alone are 4.2 GB); launch counts
     are zeroed just before and read just after;
     then its first ``PROFILE_STEPS`` micro-batches again under
     ``torch.profiler`` for the device busy share and the kernel time by name; the run folds
     the telemetry vector (on by default): its events equal
     ``events_processed`` and its hits / evals the Recall@10;
  2a. ``telemetry_cost``: the first ``TELEMETRY_COST_BATCHES``
     micro-batches with telemetry off
     and on, twice each (events/s), and once each under
     ``torch.profiler`` (device operations and card busy ms a step);
  3. serving: ``grid_topn`` for 8,192 stream users in calls of 1,024,
     against the plain path (``use_kernel=False``);
  3a. ``session_path``: the user's lifecycle on the same deployment.
     ``StreamSession(cfg, publish=PublishPolicy(every=64, mode="async"))``
     ingests the whole stream in one call (12 publish boundaries, each a
     copy of the 4.26 GB states timed on the card); ``dropped`` 0,
     Recall@10 and the final states equal to phase 2's (bit for bit),
     ``async_rotations + coalesced`` equal to the boundaries and the front
     the last snapshot; then ``recommend`` on phase 3's first call's
     1,024 users plus 256 ids no worker knows, twice: known rows equal to
     ``grid_topn`` on the final states (K3; ids and score bits), unknown
     rows to a numpy popularity head, the second call all cache hits;
     the session's ``stream_*`` registry counters equal to phase 2's
     telemetry vector; and the p50 of recommend calls that miss and that
     hit;
  3b. ``session_concurrent``: a second session ingests the first 128
     micro-batches (publishing every 16) while a reader thread holds the
     front snapshot, calls ``grid_topn`` on it, waits for two more
     publishes and calls it again (equal answers), then calls
     ``recommend`` in a loop (versions never go down, no exception
     escapes the thread): the recommend p50 during ingest;
  3c. ``storage_path``: phase 2's stream under ``StoragePolicy.
     compressed()`` (packed ``rated``, quantized ``co``): ``dropped`` 0, one
     K1 and one K2 launch a step, recall bits and the decoded final states
     equal to phase 2's bit for bit; resident bytes, peak memory and
     events/s beside phase 2's; the codecs' card ms a step (decode =
     unpack, encode = pack, CUDA events around each call) against their
     bound, over its first 32 micro-batches under ``torch.profiler``;
  3d. ``storage_bf16``: the first 128 micro-batches under
     ``compressed(factors="bf16")`` and under the default policy: integer
     tables and ``rated`` equal, Recall@10 of both;
  3e. ``session_storage``: phase 3a under ``compressed()``: states and
     recall equal to ``storage_path``'s, ``recommend`` answers equal to
     phase 3a's; publish copy card ms and peak memory beside phase 3a's;
  3f. ``checkpoint_path``: a compressed session ingests the first half of
     the stream and checkpoints (file bytes, write and read seconds,
     written under ``build/``); the restore at 4 x 4 equals it bit for bit,
     its second half ends at ``storage_path``'s states and recall bits, and
     a restore at 8 x 4 equals a live ``regrid`` of the same states;
  3g. ``rescale_path``: that session rescaled to its own grid (the
     identity, bit for bit), to 8 x 4 and back (ids, ``rated`` and
     vectors unchanged), and to the default policy (answers equal to
     phase 3a's), each rescale's wall seconds;
  4. kernels against their plain versions on the main path's shapes: a
     real micro-batch from the middle of the stream on the trained
     state (one event in ten given an unseen id, so evictions run) for
     ``factor_update`` (both modes; pairwise with random negative slots)
     and ``masked_scores``, and ISGD
     also on the same micro-batch without the fresh ids (the stream's own
     evictions); the staged kernels' CTAs per worker, staged chunk,
     dynamic shared memory and ptxas registers beside them; the serving
     inputs for ``fused_topn``; each timed beside its plain version and
     a PyTorch library call, with its bound; every kernel (and library
     call) also by its card time alone (``device_ms``,
     ``library_device_ms``); ``isgd_update`` (K6) on one
     worker's tables and bucket of that micro-batch, at
     ``bench_kernels``' shapes (U 4,096, I 2,048, E 1,024 and 16,384)
     and at E 16,384 with every event on one user row, each case beside
     its chain depth; the rows of K2 / K3 / K5 / K6 carry ptxas's
     registers, shared memory and stack per instance, and the instance
     each path runs must have no stack frame or spill;
  5. the ``cuda`` and ``scan`` backends agree on the card on a smaller
     stream with slot collisions, and the ``host`` loop equals ``scan``
     (states and recall bits);
  5f. ``forgetting_path``: the whole stream of phase 2 again under each
     of the repo's forgetting presets (LRU every 2,048 events with age
     3,000, LFU with min frequency 2, gradual with gamma 0.9): ``forgets``
     = floor(events / 2,048), ``dropped`` 0, one K1 and one K2 launch a
     step, occupancy below phase 2's for LRU / LFU, peak memory within
     phase 2's + 1 GiB; events/s and Recall@10 beside phase 2's; the card
     ms of one forgetting pass on a copy of the final states, with its
     bound;
  5g. ``forgetting_serve``: K3 on the LRU run's final states for phase
     3's queries, equal to the plain path; no id of an emptied slot
     served.

BPR-MF (K1 pairwise, K2, K3), after the DISGD state is freed:

  5a. ``bpr_path``: ``run_stream(algorithm="bpr")`` over the same whole
     MovieLens-25M stream, grid and caps as phase 2 (``rated`` 4.2 GB);
     counts zeroed just before, read just after (``factor_update`` and
     ``masked_scores`` once a step); ``dropped`` must be 0; then
     ``bpr_profile``: its first ``PROFILE_STEPS`` micro-batches under
     ``torch.profiler``,
     with the negative sampler's device operations and times a step;
  5b. ``bpr_serve``: ``grid_topn(algorithm="bpr")`` for phase 3's queries,
     equal to the plain path;
  5c. ``factor_update`` in pairwise mode against its plain version on the
     kernels line's mid-stream micro-batch of the BPR-trained state with
     the worker's own negative slots (and without the fresh ids), timed
     with its bound and ptxas's report; phase 4's random negatives on the
     DISGD state ride along on the same row;
  5d. ``bpr_backends_agree``: ``cuda``, ``scan`` and ``host`` on the card
     and ``cuda`` on CPU tensors, on a small stream with slot collisions
     (its first ``BPR_AGREE_EVENTS``).

DICS (K4, K5), after the DISGD state is freed:

  6. ``dics_path``: ``run_stream(algorithm="dics")`` over the first
     quarter of ``synth_stream(NETFLIX)`` (``DICS_PATH_EVENTS``, 346,112 of
     1,386,968 events) on a 4 x 4 grid whose tables hold every column's
     users and split's items (``rated`` 1.21 GB, ``co`` 37.7 MB); counts
     zeroed just before, read just after; then its first
     ``PROFILE_STEPS`` micro-batches again under ``torch.profiler``;
  7. ``dics_serve``: ``grid_topn(algorithm="dics", k_nn=10)`` for 8,192
     stream users in calls of 1,024, equal to the plain path;
  7a. ``storage_serve``: ``grid_topn(storage=compressed())`` on the
     compressed DISGD (K3, phase 3c's states) and DICS (K5) states, ids
     and score bits equal to the dense states' answers; p50 beside phases
     3 and 7;
  8. ``dics_update`` on a mid-stream micro-batch of the trained state (one
     event in ten given an unseen id, and again without them) and
     ``dics_topn`` on one serve call's inputs, each equal to its plain
     version, timed beside it with its bound; the bucket-start scoring of
     the same micro-batch timed;
  8a. ``dics_session``: DICS through ``StreamSession`` at the full Netflix
     width on the first 32 micro-batches (cut: a second run of phase 6's
     would take ~36 s; 64 before the script came within 15% of its
     time limit), publishing every 16, a reader thread calling
     ``recommend`` (K5) during the ingest; states and recall bits equal
     to a plain ``run_stream`` over the same events, and phase 3a's
     publish and recommend checks;
  8b. ``dics_storage``: phase 8a's cut under ``compressed()``: decoded
     states and recall bits equal to the plain run's, resident bytes;
  9. DICS ``cuda`` and ``scan`` agree on the card on a small stream with
     colliding item slots, and the card's ``cuda`` run equals the same run
     on CPU tensors, and the ``host`` loop equals ``scan``: state and
     recall bits.

Drift control, after the DICS state is freed:

  9a. ``drift_path``: the DICS deployment of phase 6 on
     ``make_scenario("abrupt", events=131_072, profile=Netflix with item
     zipf 1.3, at=0.3)`` under no policy, the fixed LRU cadence and the
     adaptive ``DriftPolicy()``: ``recovery_report``, fires, forgets,
     events/s, ``dropped`` 0;
  9b. ``drift_backends_agree``: ``benchmarks/bench_drift.py``'s small
     configuration (DEFAULT_PROFILE, abrupt at 0.3; DISGD and BPR-MF on
     its first ``DRIFT_SMALL_CUT`` events, BPR-MF's fixed cadence on
     its first ``DRIFT_POLICY_CUT``) for DISGD, BPR-MF and DICS under
     the fixed cadence and the adaptive policy on ``cuda`` and ``scan``
     on the card and ``cuda`` on CPU tensors, and DICS's on ``host``
     against ``scan`` on its first ``DRIFT_HOST_CUT`` events
     (``_drift_agree`` says what each pair must equal; each host run
     forgets, the adaptive one fires); DICS adaptive fires and recovers
     faster than the fixed cadence on ``cuda`` and ``scan``.

The ensemble, service and autoscaler runtime (K1-K5 through the
sessions), after the drift runs are freed:

  9c. ``ensemble_path``: ``EnsembleSession`` of every registered
     algorithm (BPR-MF, DICS, DISGD) on the DICS deployment (4 x 4,
     micro-batch 2,048, u_cap 98,560, i_cap 768, k = 10, each with
     ``DriftPolicy()``) over ``make_scenario("recurring", events=131_072,
     profile=Netflix with item zipf 1.3)`` in ``ENSEMBLE_PATH_SEGMENTS``
     segments (4, cut for the script's time; bench_ensemble has 32),
     then 8 ``recommend`` calls of 1,024 users in blend mode and 8 in switch
     mode; counts zeroed before the ingest, read after the serving (K1 both
     modes, K2-K5); each member's states and recall bits equal to a
     standalone ``StreamSession`` fed the same segments, the weights to a
     float64 host replay of ``weigher_update`` (within 1e-6), blend answers
     to ``fuse_topn`` of the members' own answers and switch answers to the
     argmax member's, ``dropped`` 0; events/s and the overhead over the
     standalone members' walls, the weight trail, resets, windowed
     Recall@10 (window 400) of blend, switch, best and worst single member,
     recommend p50s, ``fuse_topn`` ms a call, peak memory;
  9d. ``ensemble_checkpoint``: that ensemble checkpointed after segment 2
     (``build/chip_smoke_ensemble``), restored at the same grid and run
     through segments 3-4: weigher, states and recall bits equal to the
     uninterrupted run's; file bytes, write and restore seconds;
  9e. ``ensemble_bar``: ``bench_ensemble.smoke_rows``'s configuration (DICS
     + DISGD, recurring, 8,192 events, 2 x 2, micro-batch 256, u_cap 256,
     i_cap 64, backend ``scan``) held to its two bars: blended windowed
     recall >= best single - 0.01, and ``resets`` >= 1;
  9f. ``service_path``: ``run_service`` on the DISGD deployment
     (``PublishPolicy(every=1, mode="async")``): interleaved over the first
     16 micro-batches with 16 query batches of 64 Zipf users (5% unknown),
     then threaded over the next 128 under Poisson arrivals at 200 batches
     a second; states equal to a twin fed the same chunks without queries,
     the trainer finished, ``dropped`` 0, batches under load; ``summary()``
     whole and the twin's ingest-only events/s;
  9g. ``autoscale_path``: DISGD at the MovieLens-25M caps from
     ``balanced_grid(4)`` (2 x 2) with capacity factor 0.25 and 256 carry
     slots, the first 64 micro-batches in 16 calls with
     ``Autoscaler(AutoscalePolicy(max_workers=16, cooldown=0)).step()``
     after each, beside a twin that stays at 2 x 2: the grid reaches 16
     workers, the decisions sum to the steps, ``autoscaler_workers`` = n_c,
     ``dropped`` not above the twin's; each rescale's ms and resident
     bytes; then tests/test_storage.py's floored ``_overloaded_run`` on the
     card, where growing must drop fewer events than the fixed grid;
  9h. ``drivers``: ``main(argv)`` of ``serve_rs``, ``drift_rs``
     (``--ckpt-dir``), ``rescale_rs``, ``service_rs`` and ``quickstart``
     in-process at their own defaults on the card, ``--metrics-json``
     under ``build/chip_smoke_drivers``: each returns, prints its lines and
     launches its kernels.

The S&R grid across processes (``backend="shard_map"``: one worker a
rank of a ``torch.distributed`` group started by
``launch.mesh.run_on_ranks``, each rank on the eager reference worker,
as JAX's ``shard_map``; no kernel is launched):

  9i. ``grid_path``: the DISGD deployment's widths (``GridSpec(n_i=4)``,
     16 ranks sharing the card over gloo, the MovieLens-25M caps, k 10,
     micro-batch 2,048; ``GRID_CARRY_SLOTS`` re-queue slots, so one
     drain step) on the first ``GRID_EVENTS`` events of phase 2's
     stream (cut for the eager worker and the time limit), against
     ``backend="scan"`` in this process on the same cut: counters,
     loads, the telemetry vector and integers exactly, each rank's
     worker against its row, floats within STREAM_RTOL / STREAM_ATOL,
     recall bits equal (else the count and the first step); wall seconds
     and events/s of both, collectives and their card ms a step, each
     rank's peak memory, the backend and the ranks a card;
  9j. ``grid_agree``: ``drift_backends_agree``'s small configuration on
     ``GridSpec(2)``, 4 ranks: DICS and BPR-MF (its first
     ``DRIFT_SMALL_CUT`` events) under ``DriftPolicy()``, DISGD under
     bench_drift's LRU cadence, each against phase 9b's ``scan`` run of
     the same configuration, and DISGD under
     ``StoragePolicy.compressed()`` against its own, as in 9i (forgets
     and drift flags too);
  9k. ``grid_nccl``: NCCL at world size 1 on ``GridSpec.rect(1, 1)``,
     every loop step under ``torch.cuda.set_sync_debug_mode("error")``,
     against ``scan``; then a session publishing every step
     asynchronously with a reader thread's ``GRID_NCCL_READS`` calls
     during its second ingest, every step, async boundary and
     ``publish_async`` under the same mode (the reader takes turns with
     them: the mode is the process's), each read against a ``scan``
     replay at the agreed snapshot;
  9l. ``grid_session``: in 9i's group of 16 ranks, after its stream, a
     ``StreamSession`` on ``backend="shard_map"`` at the same widths on
     the first ``GRID_SESSION_EVENTS`` events, publishing every 2
     micro-batches (sync), then ``recommend`` on 1,024 trained users and
     256 unknown ids twice (a miss, then a hit), each rank serving its
     own worker with K3 (``fused_topn``) and one all-gather a plane
     call; against the same session on ``backend="scan"`` in this
     process: every rank's worker (a digest of its bytes) equal to its
     row, recall bits and answers equal; recommend p50 for a miss and a
     hit over the ranks, collectives and their card ms a call, K3
     launches a rank (the ``scan`` session's count, one a plane call);
     then ``rescale`` live to ``GridSpec.rect(2, 4)`` (8 workers, 8 ranks
     idle) and back, ``recommend`` after each, against the ``scan``
     session's rescales: each rank's card peak over the two (the
     exchange carries live records and entries, never a dense table)
     must stay under the grid's dense ``rated``, and its ms;
  9m. ``grid_elastic``: in 9j's group of 4 ranks, after its streams, a
     DISGD and a DICS session on 9j's small configuration
     (``GRID_ELASTIC_EVENTS`` events of its stream): ``checkpoint``
     (rank 0 writes), ``restore`` at ``GridSpec.rect(2, 1)`` (2 workers,
     2 ranks idle), then ``rescale`` back to ``GridSpec(2)``,
     ``recommend`` after each; against ``scan``: the file's bytes, each
     rank's worker and the answers equal at every step, and the serve
     leaf's kernel (K3, K5) launched as often as by ``scan`` on every
     rank that holds a worker (none on an idle rank); file bytes, write
     and read seconds, rescale ms;
  9n. ``grid_async``: in 9i's group, after ``grid_session``, the same
     session under ``PublishPolicy(every=2, mode="async")`` through
     ``run_service(mode="threaded")``: closed-loop query batches of
     ``GRID_ASYNC_QUERY_BATCH`` ids while it ingests, each rank a reader
     thread; every answer and agreement equal to rank 0's, rank 0's equal
     to the ``scan`` session of 9l replayed at the agreed snapshot (a
     fresh front-end on each served snapshot as it rotates), every worker
     its ``scan`` row, K3 launches a rank = plane calls, ``async_rotations``
     = the boundaries and nothing coalesced; ingest s beside the sync
     session's, query p50 / p99 / max, the positions served, agreement
     ms, launch counts;
  9o. ``grid_service``: in 9j's group, after ``grid_elastic``, on 9m's
     configuration under an async policy: interleaved ``run_service``
     (DISGD), the ``Autoscaler`` from one worker (micro-batch 64,
     capacity factor 0.25, 8 carry slots) and a DICS + DISGD
     ``EnsembleSession`` over two segments, each against ``scan``
     (answers, records, decisions, weights, K3 / K5 launches a rank,
     every worker its row).

LLM serving (K7), after the DICS state is freed:

 10. ``llm_serve``: ``h2o_danube_1p8b`` at full width and depth (24
     layers, 1.83 B parameters in f32) from a ``torch.Generator`` seeded
     0, through ``repro_torch.launch.serve.generate``: 4 prompts of 8,192
     tokens (two windows) from ``TokenPipeline(32000, seed=0)``, prefill,
     then 32 greedy decode steps; counts zeroed just before, read just
     after (24 ``swa_attention`` launches, one per layer of the prefill);
     then one prefill and 8 decode steps again under ``torch.profiler``
     (``llm_profile``: device busy share, kernel time by name);
 11. ``llm_consistency``: prefill over 8,192 tokens plus one decode step
     against a prefill over all 8,193 (ragged for K7), last-position
     logits held to ``tests/test_decode.py``'s contract;
 12. ``swa_attention`` against its plain version at the full shape, on
     layer 0's real q / k / v of phase 10 (S 8,192) and of phase 11's
     ragged 8,193 tokens, each row by its relative error, and on unit-
     variance q / k / v of both lengths at the JAX test's tolerance too;
     the same check must fail the kernel run with a wrong window; timed
     beside its plain version and ``scaled_dot_product_attention`` with
     a window mask.

MoE and full-attention serving (K7 at ``window=None``), after the
danube parameters are freed:

 13. ``moe_serve``: ``olmoe_1b_7b`` at full width and depth (16 layers,
     6.92 B parameters in f32) from a ``torch.Generator`` seeded 0,
     through ``serve.generate``: 4 prompts of OLMoE's 4,096-token context
     from ``TokenPipeline(50304, seed=0)``, prefill, then 32 greedy decode
     steps (16 ``swa_attention`` launches, one per layer of the prefill);
     one more decode step under ``torch.cuda.set_sync_debug_mode("error")``;
     then ``moe_profile`` (one prefill and 8 decode steps under
     ``torch.profiler``);
 14. ``moe_consistency``: prefill over 2 x 1,024 tokens plus one decode
     step against a prefill over all 1,025, the capacity factor raised
     to 8 (``tests/test_decode.py:45-50``), at that test's contract;
 15. ``moe_routing_card``: layer 0's MoE on 512 token activations on the
     card and on the host CPU: experts, positions and kept assignments
     exactly equal (no near-tie within 1e-5 first), output and aux loss
     at the CPU tests' tolerances;
 16. ``swa_attention`` at olmoe's shape (B 4, 16 / 16 heads, S 4,096, D
     128, causal, no window) against its plain version as in phase 12,
     with a window 64 short and a non-causal run as the wrong ones, timed
     beside ``scaled_dot_product_attention(is_causal=True)``: the kernels
     line's second K7 row (``instance``);
 17. ``zoo_serve``: moonshot (4 layers: the dense layer 0 and 3 MoE with
     shared experts), dbrx (2 layers; K7 group 6), stablelm-3b (all 32)
     and granite-34b (2 layers; K7 group 48) at full width, each 2 x
     1,024-token prompts and 8 decode steps, K7 launches = layers; then
     K7 on each arch's layer 0 q / k / v of those prompts against its
     plain version, a window 64 short and a non-causal run caught.

The hybrid, xLSTM, VLM and audio families (K7 at head dims 64, 96 and
80, with and without a causal mask), after the MoE parameters are freed:

 18. ``family_serve``: hymba-1.5b, xlstm-350m, phi-3-vision-4.2b and
     hubert-xlarge at full width and depth (f32, ``torch.Generator``
     seeded 0), each on 2 requests: hymba 2,048-token prompts (its
     window of 1,024 binds and the rolling buffer wraps), xLSTM 1,024,
     phi-3-vision 576 patches + 1,024 tokens (S 1,600), each through
     ``serve.generate`` with 8 decode steps; hubert 1,024 frames with the
     span mask through ``bundle.prefill`` and logits over every frame.
     K7 launches = attention layers (0 for xLSTM), logits finite, tokens
     in range, peak memory, prefill ms and decode ms a step; one decode
     step of hymba and xLSTM under ``set_sync_debug_mode("error")``; K7
     on layer 0's real q / k / v held to its plain version, a window of
     960 (hymba), a non-causal (phi-3) and a causal (hubert) run caught;
 19. ``family_consistency``: hymba, xLSTM (one group of 6) and
     phi-3-vision at full width and 2 layers, prefill over 2,048 (hymba:
     two windows), 256 (xLSTM) and 576 patches + 256 tokens (phi-3)
     positions plus one decode step against a
     prefill over all of them and one more token, at
     ``tests/test_decode.py``'s contract: the mamba and xLSTM states
     that prefill hands to decode, on the card;
 20. ``swa_attention`` at phi-3-vision's shape (B 4, 32 / 32 heads, S
     4,096: 576 patches + 3,520 tokens, D 96, causal), run inside phase
     18 while phi-3-vision's parameters live, against its plain version
     as in phase 16, timed beside
     ``scaled_dot_product_attention(is_causal=True)``: the kernels line's
     third K7 row, with ptxas's report of every K7 instance.

LM training (K7 as the attention forward, a plain backward), after the
families' parameters are freed:

 21. ``attention_grad``: ``SwaAttention`` (K7 forward, the plain chunked
     backward) at h2o-danube-1.8b's head layout (32 / 8 heads, D 80,
     window 4,096), B 1 x S 6,144 bf16 unit-variance q / k / v and
     output gradient, against ``ref.swa_attention`` under autograd: the
     max row relative error of out, dq, dk and dv within SWA_ROW_RTOL,
     and a run with a wrong window (none, or 64 keys short) caught;
     forward + backward ms of the Function, of the plain version and of
     ``scaled_dot_product_attention`` with the window as a bool mask
     (``enable_gqa``), with the bound of the work;
 22. ``train_path``: h2o-danube-1.8b whole (24 layers, d 2,560, f32
     master weights from ``torch.Generator`` seeded 0, remat on) through
     ``ModelBundle.train_step`` and AdamW at B 2 x S 8,192 (``make_batch``
     from ``TokenPipeline(32000, seed=0)``), lr from ``cosine_schedule``
     (peak 3e-4, warmup 0): three steps on one batch, whose losses must
     fall strictly, then one on a fresh batch; losses and gradient norms
     finite, K7 launched 2 x 24 times a step (the forward and remat's
     recompute), the second step under ``set_sync_debug_mode("error")``;
     step ms, tokens/s, peak memory, and the fresh step profiled (device
     busy share, top kernels): the kernels line's fourth K7 row
     (``instance`` "h2o-danube-1.8b train": the Function's forward +
     backward times from phase 21, the launches of this phase).

The tooling (``sharding/``, ``launch/dryrun.py``, ``roofline/``):

 23. ``sharded_train``: four gloo ranks sharing the card on the layout
     (data 2, model 2) train h2o-danube-1.8b at full width, 2 of its 24
     layers, B 4 x 2,048 from ``make_batch``, two steps of
     ``sharding.fsdp.train_step``; then the same two steps on one rank
     (``ModelBundle.train_step``): losses within 1e-3 relative, gradient
     norms within 1e-2, each parameter within GRAD_TOL relative L2 with
     ``tests/train_parity.py``'s element rules; each rank's resident parameter + m + v bytes three times its
     spec blocks' bytes; K7 launched 2 layers x 2 x 2 steps a rank; each
     rank's collective records equal to the dry-run's prediction for the
     same configuration and layout (``launch.dryrun.run_step`` under
     ``FakeTensorMode``, two steps);
 24. ``dryrun``: ``lower_combo`` of (h2o_danube_1p8b, prefill_32k),
     (h2o_danube_1p8b, train_4k), (olmoe_1b_7b, decode_32k) on 16 x 16
     and ``lower_recsys(algorithm="disgd")``, run in a subprocess on the
     host (it needs no card) beside phases 21-22, which keep the card
     busy, and waited for before phase 23: each roofline row, its memory
     and its seconds;
 25. ``dryrun_card``: rank 0's program of (h2o_danube_1p8b, prefill_32k)
     on 16 x 16 run for real on the card, on the layout (its collectives
     return uninitialised results): ``max_memory_allocated`` within 15%
     of the report's ``peak_bytes``, ``FlopCounterMode``'s total equal to
     the report's ``flops``, 24 K7 launches, the wall ms beside the
     roofline's ``max(compute_s, memory_s)``.

Then the kernels line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
the last line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import atexit
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
_START = time.perf_counter()
SRC = ROOT / "src"


# Main-path configuration: MovieLens-25M's Table 1 statistics, the
# README's 4 x 4 grid (16 workers), caps that fit each user column
# (155,002 / 4 users) and item split (27,133 / 4 items) without collisions.
N_I = 4
U_CAP, I_CAP = 38_912, 6_784
# DICS path: Netflix's Table 1 statistics (394,106 users, 3,001 items),
# item-CF's natural shape; caps that fit each column's users (394,106 / 4)
# and each split's items (3,001 / 4) without collisions.
DICS_U_CAP, DICS_I_CAP, K_NN = 98_560, 768, 10
# dics_path trains on the stream's first quarter (169 of its 678 micro-
# batches; the first half until the LLM families' phases came and the
# script ran 850-950 s): the tables keep their deployment size; the
# whole stream took ~70 s of the script's time limit at ~102 ms a step.
DICS_PATH_EVENTS = 346_112
MICRO_BATCH = 2048
SERVE_USERS, SERVE_BATCH = 8192, 1024
# The session phases: publish cadences in micro-batches (DISGD's whole
# stream: 12 boundaries), the cuts of the concurrent DISGD run and of the
# DICS run, and the ids no worker knows added to recommend's queries.
SESSION_EVERY = 64
CONCURRENT_BATCHES, CONCURRENT_EVERY = 128, 16
DICS_SESSION_BATCHES, DICS_SESSION_EVERY = 32, 16
UNKNOWN_QUERIES = 256
# The reader's pause between recommend calls during an ingest: a paced
# client, so that cache hits (pure host work) do not take the trainer's
# host thread for themselves.
RECOMMEND_GAP_S = 0.005
DEVICE = "cuda"
# Micro-batches under torch.profiler in the DISGD, BPR-MF, forgetting and
# DICS profiles (64 until the grid session phases needed the time, 32
# until the script came within 15% of its time limit).
PROFILE_STEPS = 16

# Card cycles of the busy wait that _time_ms(cover_enqueue=True) queues
# ahead of its start event (~2 ms at the H100's 1.98 GHz boost clock).
ENQUEUE_COVER_CYCLES = 4_000_000
# Tolerances. Kernels and plain versions sum the k = 10 products in other
# orders (nvcc contracts to FMAs): a few f32 ulp per score or update.
RTOL, ATOL = 1e-5, 1e-6
# Whole-stream backend comparison: the same rounding differences compound
# over every SGD step a vector takes.
STREAM_RTOL, STREAM_ATOL = 1e-4, 1e-5
# Ids are compared wherever neighbouring scores are further apart.
SCORE_GAP = 1e-4
# LLM serving: h2o-danube-1.8b, 4 requests of two windows each, 32 greedy
# decode steps after the prefill's token.
LLM_ARCH, LLM_BATCH, LLM_PROMPT, LLM_DECODE_STEPS = "h2o_danube_1p8b", 4, \
    8192, 32
# swa_attention against its plain version. On layer 0's real q / k / v
# the logits are ~1e-3, the softmax is near uniform and outputs are ~1e-3,
# so an absolute tolerance says nothing: each output row is held by its
# relative L2 error |got - want| / |want| (the kernel rounds P to bf16
# before P.V and both round the output to bf16: ~3e-3 of a row). On unit-
# variance q / k / v the JAX kernel test's bf16 tolerance
# (tests/test_kernels.py:90) holds as well. A kernel whose window is wrong
# (none, or 64 keys short) must fail the check.
SWA_ROW_RTOL = 1e-2
SWA_RTOL = SWA_ATOL = 3e-2
LOGIT_TOL, LOGIT_GAP = 0.15, 0.05
# MoE serving: olmoe-1b-7b, 4 requests of OLMoE's context (arXiv:2409.02060),
# 32 greedy decode steps; the consistency check at 2 x 1,024 tokens with
# the capacity factor raised to 8; the card-vs-host routing check on 512
# tokens, whose router probabilities must be 1e-5 apart where the top-k
# ends, output at tests/test_torch_moe.py's tolerance (of the output's
# scale) and aux 1e-5 relative. The other four archs at full width, cut
# in depth to fit the card and the script's time (PERF.md section 4).
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_DECODE_STEPS = "olmoe_1b_7b", 4, \
    4096, 32
MOE_CONSISTENCY_BATCH, MOE_CONSISTENCY_PROMPT = 2, 1024
MOE_ROUTING_TOKENS, MOE_NEAR_TIE, MOE_OUT_TOL, MOE_AUX_RTOL = 512, 1e-5, \
    1e-2, 1e-5
ZOO_LAYERS = {"moonshot_v1_16b_a3b": 4, "dbrx_132b": 2, "stablelm_3b": None,
              "granite_34b": 2}
ZOO_BATCH, ZOO_PROMPT, ZOO_DECODE_STEPS = 2, 1024, 8
# The hybrid, xLSTM, VLM and audio families, whole (all four fit the card
# in f32), ZOO_BATCH requests each: prompt positions (hymba's 2,048 bind
# its window of 1,024; phi-3-vision's are its 576 patches and 1,024
# tokens, a ragged S of 1,600 for K7; hubert's are frames), decode steps. The consistency check at full width, 2
# layers (xLSTM: one group of 6), FAMILY_CONSISTENCY_PROMPT positions
# after a VLM's patches: hymba's are its serving prompt's 2,048, because
# below its window the decode cache holds only the prompt's slots and the
# first decode step evicts position 0 (the reference's rule; hymba-smoke
# at 32 positions drifts 0.203 of the logits' scale in JAX itself, the
# port 0.204), while at two windows the rolling buffer is exact and
# wraps. K7 at phi-3-vision's shape: 4 requests of 4,096 positions.
FAMILY_PROMPT = {"hymba_1p5b": 2048, "xlstm_350m": 1024,
                 "phi3_vision_4p2b": 576 + 1024, "hubert_xlarge": 1024}
FAMILY_DECODE_STEPS = 8
FAMILY_CONSISTENCY_PROMPT = {"hymba_1p5b": 2048, "xlstm_350m": 256,
                             "phi3_vision_4p2b": 256}
FAMILY_CONSISTENCY_LAYERS = 2
VLM_SWA_BATCH, VLM_SWA_SEQ = 4, 4096
# LM training: h2o-danube-1.8b whole at 2 sequences of two windows,
# three steps on one batch (the loss must fall) and one on a fresh one;
# the attention Function held to its plain version at one sequence of
# 1.5 windows (the plain version's [32, S, S] f32 logits and their
# gradients fit the card).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_FIXED_STEPS, TRAIN_PEAK_LR = 2, 8192, 3, 3e-4
ATTN_GRAD_SEQ = 6144


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def disgd_config(rt):
    """The DISGD main path's ``StreamConfig`` (MovieLens-25M caps)."""
    return rt.StreamConfig(
        grid=rt.GridSpec(n_i=N_I), micro_batch=MICRO_BATCH,
        capacity_factor=2.0,
        hyper=rt.DisgdHyper(k=10, u_cap=U_CAP, i_cap=I_CAP, top_n=10),
        backend="cuda", device=DEVICE)


def dics_config(rt):
    """The DICS path's ``StreamConfig`` (Netflix caps)."""
    return rt.StreamConfig(
        algorithm="dics", grid=rt.GridSpec(n_i=N_I), micro_batch=MICRO_BATCH,
        capacity_factor=2.0,
        hyper=rt.DicsHyper(k_nn=K_NN, top_n=10, u_cap=DICS_U_CAP,
                           i_cap=DICS_I_CAP),
        backend="cuda", device=DEVICE)


def serve_batches(torch, np, users, dev):
    """SERVE_USERS distinct stream users (seed 0), in calls of
    SERVE_BATCH: the serve phases' queries."""
    rng = np.random.default_rng(0)
    queries = rng.choice(np.unique(users), SERVE_USERS, replace=False)
    return [torch.as_tensor(queries[s:s + SERVE_BATCH], dtype=torch.int32,
                            device=dev)
            for s in range(0, SERVE_USERS, SERVE_BATCH)]


def kernel_batch(torch, np, users, items, cfg, rng, fresh_rate=0.1):
    """``_middle_batch`` and what the cuda worker derives from it: (ev_u,
    ev_i, u_slot, i_slot, init_u, init_i), the events' slots and their
    init vectors."""
    from repro_torch.core import disgd, prng, state as state_lib

    hyper = cfg.resolved_hyper()
    ev_u, ev_i = _middle_batch(torch, np, users, items, cfg, rng, fresh_rate)
    cap = ev_u.shape[1]
    init = disgd.init_vector(prng.key(cfg.seed, device=ev_u.device),
                             torch.cat([ev_u, ev_i], 1), hyper.k,
                             hyper.init_scale)
    return (ev_u, ev_i, state_lib.slot_of(ev_u, hyper.g, hyper.u_cap),
            state_lib.slot_of(ev_i, hyper.n_i, hyper.i_cap),
            init[:, :cap].contiguous(), init[:, cap:].contiguous())


def masked_scores_inputs(torch, states, ev_u, u_slot, init_u):
    """K2's inputs on the kernels line: the bucket-start scoring of
    ``kernel_batch``'s micro-batch (users ``ev_u`` in slots ``u_slot``,
    init vectors ``init_u``) on the trained DISGD state, as the cuda
    worker builds them: (u_vecs, item_vecs, candidate mask)."""
    t = states.tables
    w = torch.arange(ev_u.shape[0], device=ev_u.device)[:, None]
    us = u_slot.long()
    known_u = t.user_ids.gather(1, us) == ev_u
    u_vecs = torch.where(known_u[..., None], states.user_vecs[w, us], init_u)
    cand = ((t.item_ids >= 0)[:, None, :] & ~(states.rated[w, us]
                                              & known_u[..., None])
            & (ev_u >= 0)[..., None])
    return u_vecs, states.item_vecs, cand


def fused_topn_inputs(torch, states, cfg, serve_q):
    """K3's inputs on the kernels line: one ``grid_topn`` call's query
    rows (``serve_q``, bucketed by user column as the serve plane does)
    on the trained DISGD state: ((u_vecs, item_vecs, mask, item_ids),
    dict(top_n))."""
    from repro_torch.core import routing, serve
    from repro_torch.serve.plane import query_capacity

    hyper = cfg.resolved_hyper()
    g, n_i = cfg.grid.g, cfg.grid.n_i
    col = torch.where(serve_q >= 0, serve_q % g, g)
    buckets, _, _ = routing.bucket_dispatch(col, g,
                                            query_capacity(SERVE_BATCH, g))
    qu = torch.where(buckets >= 0, serve_q[buckets.clamp(min=0).long()], -1)
    qu = qu.repeat(n_i, 1)
    sv, mask, _ = serve._gather_queries(states, qu, g, hyper.u_cap)
    return ((sv, states.item_vecs, mask, states.tables.item_ids),
            dict(top_n=hyper.top_n))


def isgd_cases(torch, np, states, u_slot, i_slot, ev_u, k):
    """K6's inputs on the kernels line: DISGD worker 0's tables and bucket
    of ``kernel_batch``'s micro-batch, then ``benchmarks/bench_kernels.py``'s
    shapes (U 4,096, I 2,048, E 1,024 and 16,384; seeded tables, random
    slots with repeats, every event valid), and E 16,384 again with every
    event on user row 0 (one chain as long as the batch). Returns [(case,
    (user_tab, item_tab, u_slots, i_slots, valid))]."""
    cases = [("worker", (states.user_vecs[0], states.item_vecs[0],
                         u_slot[0].contiguous(), i_slot[0].contiguous(),
                         (ev_u[0] >= 0).contiguous()))]
    rng = np.random.default_rng(2)
    dev = states.user_vecs.device
    for e in (1024, 16384):
        u_cap, i_cap = 4096, 2048
        tabs = [torch.tensor(rng.normal(size=(n, k)), dtype=torch.float32,
                             device=dev) for n in (u_cap, i_cap)]
        slots = [torch.tensor(rng.integers(0, n, e), dtype=torch.int32,
                              device=dev) for n in (u_cap, i_cap)]
        cases.append((f"bench_{e}", (*tabs, *slots, torch.ones(
            e, dtype=torch.bool, device=dev))))
    _, (ut, it, us, is_, ok) = cases[-1]
    cases.append(("one_row_16384", (ut, it, torch.zeros_like(us), is_, ok)))
    return cases


def chain_depth(np, u_slot, i_slot, valid, n_u, n_i) -> int:
    """The longest chain of dependent events in an ISGD batch: an event
    follows the last valid earlier event on its user row and on its item
    row (slots outside the tables, like invalid events, run nothing)."""
    us, is_, ok = (x.cpu().numpy() for x in (u_slot, i_slot, valid))
    ok = ok.astype(bool) & (us >= 0) & (us < n_u) & (is_ >= 0) & (is_ < n_i)
    lu, li, depth = {}, {}, 0
    for e in np.flatnonzero(ok).tolist():
        d = 1 + max(lu.get(int(us[e]), 0), li.get(int(is_[e]), 0))
        lu[int(us[e])] = li[int(is_[e])] = d
        depth = max(depth, d)
    return depth


def dics_topn_inputs(torch, states, cfg, serve_q):
    """K5's inputs on the kernels line: one ``grid_topn`` call's query
    rows (``serve_q``, bucketed by user column as the serve plane does)
    on the trained DICS state: ((co, item_cnt, hist, known, item_ids),
    dict(top_n, k_nn))."""
    from repro_torch.core import routing, state as state_lib
    from repro_torch.serve.plane import query_capacity

    hyper = cfg.resolved_hyper()
    g, n_i = cfg.grid.g, cfg.grid.n_i
    col = torch.where(serve_q >= 0, serve_q % g, g)
    buckets, _, _ = routing.bucket_dispatch(col, g,
                                            query_capacity(SERVE_BATCH, g))
    qu = torch.where(buckets >= 0, serve_q[buckets.clamp(min=0).long()], -1)
    qu = qu.repeat(n_i, 1)
    slots = state_lib.slot_of(qu, g, hyper.u_cap).long()
    t = states.tables
    known = t.user_ids.gather(1, slots) == qu
    w = torch.arange(qu.shape[0], device=qu.device)[:, None]
    hist = states.rated[w, slots] & known[..., None]
    return ((states.co, states.item_cnt, hist, known, t.item_ids),
            dict(top_n=hyper.top_n, k_nn=hyper.k_nn))


def serve_kw(cfg):
    """``grid_topn``'s keywords for the serve calls of ``cfg`` (DISGD or
    DICS)."""
    from repro_torch.serve.plane import query_capacity

    hyper = cfg.resolved_hyper()
    kw = dict(algorithm=cfg.algorithm, grid=cfg.grid, top_n=hyper.top_n,
              u_cap=hyper.u_cap, qcap=query_capacity(SERVE_BATCH, cfg.grid.g))
    if cfg.algorithm == "dics":
        kw["k_nn"] = hyper.k_nn
    if not cfg.storage.is_default:
        kw["storage"] = cfg.storage
    return kw


def serve_calls(torch, rt, states, kw, batches, rounds=1):
    """The calls of phases ``serve`` and ``dics_serve``: one warm-up
    call, the launch counts set to 0, then ``grid_topn(states, q, **kw)``
    for every serve batch ``q``, ``rounds`` times over, each call's wall
    time taken from the end of the previous call's synchronisation to the
    end of its own.
    Returns (seconds of each call, the last round's outputs, the launch
    counts of all rounds)."""
    from repro_torch.kernels import ops

    rt.grid_topn(states, batches[0], **kw)          # warm the allocator
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    lat = []
    for _ in range(rounds):
        outs = []
        for q in batches:
            t0 = time.perf_counter()
            outs.append(rt.grid_topn(states, q, **kw))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    return lat, outs, ops.launch_counts()


def _steps(n: int, cfg) -> int:
    """Micro-batch steps of a device-loop stream of ``n`` events: the
    batches plus the static drain tail (``core/engine.py``: the re-queue
    buffer's slots over a bucket's)."""
    return (math.ceil(n / cfg.micro_batch)
            + math.ceil((cfg.carry_slots or cfg.micro_batch)
                        / cfg.bucket_capacity))


def emit(phase: str, **fields):
    """One phase's JSON line; ``at_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.perf_counter() - _START, 1)}),
          flush=True)


def main():
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}

    # -- 1. device and build ------------------------------------------------
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    infos = build.build_all(force=True)
    build_s = time.perf_counter() - t0
    emit("build", **card, seconds=round(build_s, 3), kernels={
        n: {"nvcc_s": round(b.seconds, 3), **_ptxas(b.ptxas),
            "entries": _ptxas_entries(b.ptxas)}
        for n, b in infos.items()})

    # -- 2. main path at deployment size ------------------------------------
    import numpy as np
    import repro_torch as rt
    from repro_torch.data.stream import MOVIELENS_25M, synth_stream
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    users, items, _ = synth_stream(MOVIELENS_25M, seed=0)
    gen_s = time.perf_counter() - t0
    n = int(users.size)
    cfg = disgd_config(rt)
    hyper, grid = cfg.hyper, cfg.grid
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = rt.run_stream(users, items, cfg)
    main_counts = ops.launch_counts()
    steps = _steps(n, cfg)
    if res.events_processed + res.dropped != n:
        fail(f"events_processed {res.events_processed} + dropped "
             f"{res.dropped} != {n}")
    for name in ("factor_update", "masked_scores"):
        if main_counts[name] != steps:
            fail(f"{name} launched {main_counts[name]} times on the main "
                 f"path, expected one per step ({steps})")
    main_tel = _telemetry_checks(np, res, "main_path")
    emit("main_path", stream="synth_stream(MOVIELENS_25M, seed=0)", events=n,
         cut=None, generate_s=round(gen_s, 3), grid=[grid.n_i, grid.g],
         u_cap=U_CAP, i_cap=I_CAP, micro_batch=MICRO_BATCH,
         bucket_capacity=cfg.bucket_capacity, steps=steps,
         wall_s=res.wall_seconds, events_per_s=res.throughput,
         recall_at_10=res.recall.mean(),
         events_processed=res.events_processed, dropped=res.dropped,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         precision_at_10=res.precision, telemetry=main_tel,
         launches=main_counts)
    main = dict(events_per_s=res.throughput, recall=res.recall.mean(),
                occupancy=res.occupancy_summary(),
                peak=torch.cuda.max_memory_allocated())
    states = res.final_states
    _profile_steps(torch, rt, users, items, cfg, steps=PROFILE_STEPS)
    _telemetry_cost(torch, rt, users, items, cfg)

    # -- 3. serving ----------------------------------------------------------
    batches = serve_batches(torch, np, users, dev)
    outs, serve_counts, serve_p50 = _topn_serve(torch, rt, states, cfg,
                                                batches, "serve")

    # -- 3a-3b. the session runtime ------------------------------------------
    session = _session_phases(torch, np, rt, users, items, cfg, res,
                              main_tel, batches, serve_p50)

    # -- 3c-3g. storage policies, checkpoints and regrid ---------------------
    disgd_serve, _ = _storage_phases(torch, np, rt, users, items, cfg, res,
                                     main, batches, serve_p50, session)

    # -- 4. kernels against their plain versions -----------------------------
    kernels, random_j = _kernel_checks(torch, np, rt, users, items, states,
                                       cfg, batches[0], main_counts,
                                       serve_counts, infos)
    batches_q = batches
    del states, res, outs, batches

    # -- 5. backends agree on the card ---------------------------------------
    _backends_agree(torch, np, rt)
    torch.cuda.empty_cache()

    # -- 5f-5g. forgetting on the DISGD deployment -------------------------------
    _forgetting_phases(torch, np, rt, users, items, cfg, main, batches_q)
    torch.cuda.empty_cache()

    # -- 5a-5e. BPR-MF -----------------------------------------------------------
    kernels += _bpr_phases(torch, np, rt, dev, users, items, random_j, infos)
    torch.cuda.empty_cache()

    # -- 6-9. DICS -------------------------------------------------------------
    kernels += _dics_phases(torch, np, rt, dev, infos, disgd_serve)
    torch.cuda.empty_cache()

    # -- 9a-9b. drift control ------------------------------------------------------
    drift_scans = _drift_phases(torch, np, rt)
    torch.cuda.empty_cache()

    # -- 9c-9h. ensemble, service, autoscaler and the launch drivers ---------------
    _ensemble_phases(torch, np, rt)
    torch.cuda.empty_cache()
    _service_phases(torch, np, rt, users, items)
    torch.cuda.empty_cache()
    _autoscale_phases(torch, np, rt, users, items)
    torch.cuda.empty_cache()
    _driver_phases(torch, np)
    torch.cuda.empty_cache()

    # -- 9i-9k. the S&R grid across processes ---------------------------------
    _grid_phases(torch, np, rt, users, items, drift_scans)
    torch.cuda.empty_cache()

    # -- 10-12. LLM serving ------------------------------------------------------
    kernels += _llm_phases(torch, np, dev)

    # -- 13-17. MoE and full-attention serving -----------------------------------
    kernels += _moe_phases(torch, np, dev)

    # -- 18-20. the hybrid, xLSTM, VLM and audio families --------------------------
    kernels += _family_phases(torch, np, dev, infos)
    torch.cuda.empty_cache()

    # -- 21-22. LM training ------------------------------------------------------
    # The dry-run (24) needs no card: its subprocess runs on one host core
    # beside these two phases, which keep the card busy.
    dryrun_proc = _start_dryrun()
    kernels += _train_phases(torch, np, dev)

    # -- 23-25. sharded training and the dry-run ----------------------------------
    _sharding_phases(torch, np, dev, dryrun_proc)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))


def _profile_steps(torch, rt, users, items, cfg, steps: int,
                   phase: str = "profile", **extra):
    """Where the time goes: the first ``steps`` micro-batches of the main
    path again, under ``torch.profiler`` (device activity only, so the
    host loop is not slowed by CPU-side recording). Device busy share =
    summed kernel time / the loop's wall time; device operations (kernel
    launches and copies) a step from the profiler's counts. ``extra``
    rides along on the phase's line."""
    emit(phase, **_profiled(torch, rt, users, items, cfg, steps), **extra)


def _profiled(torch, rt, users, items, cfg, steps: int) -> dict:
    """``_profile_steps``'s fields: the first ``steps`` micro-batches of
    ``users`` / ``items`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    n = steps * cfg.micro_batch
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = rt.run_stream(users[:n], items[:n], cfg)
    rows, busy_ms = _device_rows(prof)
    events = int(min(n, users.size))
    total_steps = _steps(events, cfg)
    return dict(steps=total_steps, events=events,
                wall_ms=1e3 * res.wall_seconds,
                wall_ms_per_step=1e3 * res.wall_seconds / total_steps,
                device_busy_ms=busy_ms,
                device_busy_share=busy_ms / (1e3 * res.wall_seconds),
                device_ops_per_step=sum(r[1] for r in rows) / total_steps,
                top=[{"kernel": k[:90], "ms": us / 1e3, "count": c}
                     for us, c, k in rows[:10]])


def _device_rows(prof):
    """(self device us, launches, kernel name) per kernel, largest first,
    and the summed device ms."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows) / 1e3


def _kernel_name(mangled: str) -> str | None:
    """The ``*_kernel`` identifier of a mangled entry name, read as the
    sequence of length-prefixed names after ``_Z`` / ``_ZN`` (an
    anonymous namespace's hash holds digits too), and a template instance
    as ``name<N>`` (its integer argument)."""
    i = len(re.match(r"_ZN?", mangled).group()) if mangled.startswith(
        "_Z") else 0
    while m := re.match(r"\d+", mangled[i:]):
        i += m.end() + int(m.group())
        ident = mangled[i - int(m.group()):i]
        if ident.endswith("_kernel"):
            inst = re.match(r"ILi(\d+)E", mangled[i:])
            return ident + (f"<{inst.group(1)}>" if inst else "")
    return None


def _ptxas_entries(log: str) -> dict:
    """ptxas's report per entry function of one library (registers,
    static shared memory, stack, spills), by ``_kernel_name``."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        key = _kernel_name(block.split("'", 1)[0])
        if key:
            out.setdefault(key, _ptxas(block))
    return out


def _staged_layout(name: str, events: int, width: int, log: str,
                   entry: str, layout: str | None = None) -> dict:
    """A staged kernel's launch (``csrc/bucket_stage.cuh``) for a bucket
    of ``events``: CTAs per worker, events per staged chunk, dynamic
    shared memory per CTA (``width``: I for dics_update, k for
    factor_update; ``layout`` the library's layout function, by default
    ``<name>_layout``), and ptxas's registers / static shared memory."""
    import ctypes

    from repro_torch.kernels import build

    out = (ctypes.c_int * 3)()
    fn = getattr(build.load(name), layout or f"{name}_layout")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    fn(events, width, out)
    ptxas = _ptxas_entries(log).get(entry)
    if ptxas is None:
        fail(f"{name}: no ptxas report for {entry}")
    return {"ctas_per_worker": out[0], "chunk_events": out[1],
            "smem_dynamic_bytes": out[2], "registers": ptxas["registers"],
            "smem_static_bytes": ptxas["smem_bytes"],
            "stack_bytes": ptxas["stack_bytes"],
            "spill_store_bytes": ptxas["spill_store_bytes"]}


def _ptxas(log: str) -> dict:
    regs = re.search(r"Used (\d+) registers", log)
    smem = re.search(r"(\d+) bytes smem", log)
    stack = re.search(r"(\d+) bytes stack frame", log)
    spill_st = re.search(r"(\d+) bytes spill stores", log)
    spill_ld = re.search(r"(\d+) bytes spill loads", log)
    return {"registers": int(regs.group(1)) if regs else None,
            "smem_bytes": int(smem.group(1)) if smem else 0,
            "stack_bytes": int(stack.group(1)) if stack else 0,
            "spill_store_bytes": int(spill_st.group(1)) if spill_st else 0,
            "spill_load_bytes": int(spill_ld.group(1)) if spill_ld else 0}


def _ptxas_instances(log: str, kernel: str) -> dict:
    """``_ptxas_entries`` of each instance of the kernel template."""
    out = {k: v for k, v in _ptxas_entries(log).items()
           if k.startswith(kernel + "<")}
    if not out:
        fail(f"no ptxas report for {kernel}")
    return out



def _registers_only(log: str, kernel: str, width: int) -> dict:
    """``_ptxas_instances`` of a serving kernel (instances by k or k_nn
    up to 4, 8, 10, 16, 32); the instance the path runs at ``width`` must
    keep its per-thread arrays in registers: no stack frame, no spill."""
    instances = _ptxas_instances(log, f"{kernel}_kernel")
    kcap = min(c for c in (4, 8, 10, 16, 32) if c >= width)
    used = instances.get(f"{kernel}_kernel<{kcap}>")
    if used is None or used["stack_bytes"] or used["spill_store_bytes"]:
        fail(f"{kernel}: the path's instance has a stack frame or spills: "
             f"{instances}")
    return instances

def _close(got, want, what):
    import torch

    g, w = got.float(), want.float()
    if not torch.equal(torch.isneginf(g), torch.isneginf(w)):
        fail(f"{what}: -inf pattern differs")
    fin = torch.isfinite(w)
    if not torch.allclose(g[fin], w[fin], rtol=RTOL, atol=ATOL):
        err = (g[fin] - w[fin]).abs().max().item()
        fail(f"{what}: max abs error {err} beyond rtol={RTOL} atol={ATOL}")
    return (g[fin] - w[fin]).abs().max().item() if fin.any() else 0.0


def _ids_mismatch(ids, want_ids, want_sc) -> int:
    """Count id mismatches where the plain list's neighbouring scores are
    more than SCORE_GAP apart (or exactly tied: then ids break the tie)."""
    import torch

    gap = (want_sc[..., 1:] - want_sc[..., :-1]).abs()
    tied = (want_sc[..., 1:] == want_sc[..., :-1])
    near = ~((gap > SCORE_GAP) | tied)
    sep = torch.ones_like(want_sc, dtype=torch.bool)
    sep[..., 1:] &= ~near
    sep[..., :-1] &= ~near
    return int((ids != want_ids)[sep].sum())


def _time_ms(torch, fn, reps=20, setup=None, cover_enqueue=False,
             warmup=True) -> float:
    """Median ms of ``fn`` by CUDA events, after one warm-up call (none
    without ``warmup``); ``setup`` runs outside the timed region before
    every call. The time
    holds the host's enqueue of ``fn`` where the card waits for it. With
    ``cover_enqueue``, a ~2 ms busy wait queued ahead of the start event
    hides that enqueue, so a sub-millisecond kernel is timed on the card
    alone (the ``device_ms`` fields)."""
    times = []
    first = 1 if warmup else 0
    for r in range(reps + first):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if cover_enqueue:
            torch.cuda._sleep(ENQUEUE_COVER_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if r >= first:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def _hw():
    """The card's published peaks (NVIDIA's H100 SXM datasheet), one
    source for the port: ``repro_torch.roofline.analysis.HW``: the HBM3
    rate, the f32 rate outside the tensor cores (the recommender's kernels
    do f32 FMAs on CUDA cores) and the dense bf16 tensor-core rate
    (swa_attention)."""
    from repro_torch.roofline.analysis import HW

    return HW()


def _bound_ms(n_bytes: float, flops: float, bf16: bool = False):
    hw = _hw()
    t_bytes = n_bytes / hw.hbm_bw * 1e3
    t_ops = flops / (hw.peak_flops if bf16 else hw.f32_flops) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _middle_batch(torch, np, users, items, cfg, rng, fresh_rate=0.1):
    """One micro-batch from the middle of the stream, bucketed as the
    engine buckets it, with one event in ten (``fresh_rate``) given an
    unseen id."""
    from repro_torch.core import routing

    n = users.size
    lo = (n // 2) // cfg.micro_batch * cfg.micro_batch
    bu = users[lo:lo + cfg.micro_batch].copy()
    bi = items[lo:lo + cfg.micro_batch].copy()
    fresh = rng.random(bu.size) < fresh_rate
    # Unseen ids on the same worker and the same slot as the ids they
    # replace (the shift is a multiple of the grid and of slots * stride),
    # so the slots' tenants are evicted.
    hyper = cfg.resolved_hyper()
    bu[fresh] += cfg.grid.g * hyper.u_cap
    bi[fresh] += cfg.grid.n_i * hyper.i_cap
    dev = torch.device(cfg.device)
    bu_t = torch.as_tensor(bu, dtype=torch.int32, device=dev)
    bi_t = torch.as_tensor(bi, dtype=torch.int32, device=dev)
    g, n_i = cfg.grid.g, cfg.grid.n_i
    keys = (bi_t % n_i) * g + (bu_t % g)
    buckets, _, _ = routing.bucket_dispatch(keys, cfg.grid.n_c,
                                            cfg.bucket_capacity)
    src = buckets.clamp(min=0).long()
    ev_u = torch.where(buckets >= 0, bu_t[src], -1).contiguous()
    ev_i = torch.where(buckets >= 0, bi_t[src], -1).contiguous()
    return ev_u, ev_i


def _touched_bytes(np, st_ids, ev_u, ev_i, u_slot, i_slot, u_cap, i_cap, k):
    """Bytes factor_update must move for this batch: its event inputs
    read once, and every table entry it touches read and written once
    (vectors, bookkeeping, the rated row / column cleared on a new
    tenant). Replays the slot tenancy event by event."""
    uid, iid = (x.cpu().numpy() for x in st_ids)
    ev_u, ev_i, u_slot, i_slot = (x.cpu().numpy() for x in
                                  (ev_u, ev_i, u_slot, i_slot))
    n_w, n_ev = ev_u.shape
    total = n_w * n_ev * (4 * 4 + 2 * k * 4)        # ids, slots, inits
    for w in range(n_w):
        u_ten, i_ten = {}, {}
        for e in range(n_ev):
            if ev_u[w, e] < 0:
                continue
            us, is_ = int(u_slot[w, e]), int(i_slot[w, e])
            new_u = u_ten.get(us, uid[w, us]) != ev_u[w, e]
            new_i = i_ten.get(is_, iid[w, is_]) != ev_i[w, e]
            u_ten[us], i_ten[is_] = ev_u[w, e], ev_i[w, e]
            total += 2 * (2 * k * 4 + 6 * 4) + 1      # vectors, tables, (u,i)
            total += u_cap * new_i + i_cap * new_u    # evictions
    return total


def _k1_case(torch, states, events, hyper, plain=True):
    """factor_update against its plain version on clones of ``states``
    (integers exactly, floats within RTOL / ATOL), each timed on fresh
    clones: (max abs error, ms, plain ms or None, device ms)."""
    from repro_torch.core import state as state_lib
    from repro_torch.kernels import ops, ref

    mode = "isgd" if events[4] is None else "pairwise"
    work = {}

    def run(fn, name):
        s = work[name]
        fn(s.user_vecs, s.item_vecs, s.rated, tuple(s.tables), events,
           eta=hyper.eta, lam=hyper.lam)

    results = {}
    for name, fn in (("kernel", ops.factor_update),
                     ("plain", ref.factor_apply)):
        work[name] = state_lib.clone_state(states)
        run(fn, name)
        torch.cuda.synchronize()
        results[name] = work.pop(name)
    got, want = results["kernel"], results["plain"]
    for a, b, what in zip(got.tables, want.tables, state_lib.Tables._fields):
        if not torch.equal(a, b):
            fail(f"factor_update ({mode}): {what} differs")
    if not torch.equal(got.rated, want.rated):
        fail(f"factor_update ({mode}): rated differs")
    err = max(_close(got.user_vecs, want.user_vecs, f"factor_update {mode} u"),
              _close(got.item_vecs, want.item_vecs, f"factor_update {mode} i"))
    del got, want, results

    def fresh(name):
        def setup():
            work[name] = state_lib.clone_state(states)
        return setup

    ms = _time_ms(torch, lambda: run(ops.factor_update, "kernel"), reps=5,
                  setup=fresh("kernel"))
    device_ms = _time_ms(torch, lambda: run(ops.factor_update, "kernel"),
                         reps=5, setup=fresh("kernel"), cover_enqueue=True)
    plain_ms = None
    if plain:
        plain_ms = _time_ms(torch, lambda: run(ref.factor_apply, "plain"),
                            reps=2, setup=fresh("plain"))
    work.clear()
    return err, ms, plain_ms, device_ms


def _pairwise_steps(torch, np, states, events) -> int:
    """How many events of a pairwise batch take the BPR step (neg_ok),
    by the plain version's rule replayed on the host from the batch-start
    tenants and rated bytes the batch reads: the data-dependent part of
    K1's bound."""
    ev_u, ev_i, u_slot, i_slot, j_slot, _, _ = events
    t = states.tables
    w = torch.arange(ev_u.shape[0], device=ev_u.device)[:, None]
    uid0, iid0, jid0 = (tab.gather(1, s.long()).cpu().numpy() for tab, s in
                        ((t.user_ids, u_slot), (t.item_ids, i_slot),
                         (t.item_ids, j_slot)))
    byte0 = states.rated[w, u_slot.long(), j_slot.long()].cpu().numpy()
    ev_u, ev_i, u_slot, i_slot, j_slot = (
        x.cpu().numpy() for x in (ev_u, ev_i, u_slot, i_slot, j_slot))
    steps = 0
    for wk in range(ev_u.shape[0]):
        ten_u, ten_i, sets, row_clr, col_clr = {}, {}, {}, {}, {}
        for e in np.flatnonzero(ev_u[wk] >= 0).tolist():
            u, i = int(ev_u[wk, e]), int(ev_i[wk, e])
            us, is_, js = (int(x[wk, e]) for x in (u_slot, i_slot, j_slot))
            new_u = ten_u.get(us, uid0[wk, e]) != u
            new_i = ten_i.get(is_, iid0[wk, e]) != i
            tenant = ten_i.get(js, jid0[wk, e])
            byte = 0
            if not new_u:   # an event's clears (2e) come before its set (2e+1)
                t_set = sets.get((us, js), -1)
                t_clr = max(row_clr.get(us, -1), col_clr.get(js, -1))
                byte = 1 if t_set > t_clr else (0 if t_clr >= 0
                                                else int(byte0[wk, e]))
            steps += bool(js != is_ and tenant >= 0 and tenant != i
                          and not byte)
            if new_i:
                col_clr[is_] = 2 * e
            if new_u:
                row_clr[us] = 2 * e
            sets[(us, is_)] = 2 * e + 1
            ten_u[us], ten_i[is_] = u, i
    return steps


def _pairwise_bound(n_bytes, n_valid, n_steps, k):
    """K1's pairwise bound: ISGD's bytes, plus each valid event's negative
    slot, tenant and rated byte read once, plus the negative vector read
    and written for each event that takes the BPR step; 18 k flops an
    event that does (two dots, three updates)."""
    return _bound_ms(n_bytes + n_valid * (4 + 4 + 1) + n_steps * 8 * k,
                     18 * k * n_steps)


def _kernel_checks(torch, np, rt, users, items, states, cfg, serve_q,
                   main_counts, serve_counts, infos):
    from repro_torch.kernels import ops, ref

    hyper = cfg.resolved_hyper()
    k = hyper.k
    rng = np.random.default_rng(1)
    ev_u, ev_i, u_slot, i_slot, init_u, init_i = kernel_batch(
        torch, np, users, items, cfg, rng)
    n_w, cap = ev_u.shape
    t = states.tables
    rows = []

    # K1 factor_update (ISGD) on clones of the trained state, also on the
    # same micro-batch without the fresh ids (the stream's own evictions:
    # none at these caps); pairwise mode with random negative slots on
    # this DISGD state too (the case K1's pairwise mode was first timed
    # on, kept beside the BPR path's own batch, _bpr_kernel_row).
    n_bytes = _touched_bytes(np, (t.user_ids, t.item_ids), ev_u, ev_i, u_slot,
                             i_slot, hyper.u_cap, hyper.i_cap, k)
    n_valid = int((ev_u >= 0).sum())
    j_slot = torch.as_tensor(rng.integers(0, hyper.i_cap, (n_w, cap)),
                             dtype=torch.int32, device=ev_u.device)
    nf_u, nf_i, nf_us, nf_is, nf_init_u, nf_init_i = kernel_batch(
        torch, np, users, items, cfg, np.random.default_rng(1),
        fresh_rate=0.0)
    cases = {
        "isgd": (ev_u, ev_i, u_slot, i_slot, None, init_u, init_i),
        "pairwise": (ev_u, ev_i, u_slot, i_slot, j_slot, init_u, init_i),
        "isgd_no_fresh": (nf_u, nf_i, nf_us, nf_is, None, nf_init_u,
                          nf_init_i)}
    k1 = {case: _k1_case(torch, states, events, hyper,
                         plain=case != "isgd_no_fresh")
          for case, events in cases.items()}
    bound, by = _bound_ms(n_bytes, 12 * k * n_valid)
    err, ms, plain_ms, device_ms = k1["isgd"]
    log = infos["factor_update"].ptxas
    rows.append(dict(
        name="factor_update", route="cuda", matched=True, mode="isgd",
        source="src/repro_torch/kernels/csrc/factor_update.cu",
        replaces="src/repro/kernels/factor_update.py:41",
        launches=main_counts["factor_update"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        ms_no_fresh=k1["isgd_no_fresh"][1],
        max_abs_err_no_fresh=k1["isgd_no_fresh"][0],
        device_ms=device_ms, device_ms_no_fresh=k1["isgd_no_fresh"][3],
        **_staged_layout("factor_update", cap, k, log,
                         "factor_update_isgd_kernel"),
        shape=f"W={n_w} E={cap} U={hyper.u_cap} I={hyper.i_cap} k={k}",
        valid_events=n_valid))
    p_err, p_ms, p_plain_ms, p_device_ms = k1["pairwise"]
    n_upd = _pairwise_steps(torch, np, states, cases["pairwise"])
    p_bound, p_by = _pairwise_bound(n_bytes, n_valid, n_upd, k)
    random_j = {"state": "DISGD main path", "negatives": "uniform random",
                "max_abs_err": p_err, "ms": p_ms, "plain_ms": p_plain_ms,
                "device_ms": p_device_ms, "bound_ms": p_bound,
                "bound_by": p_by, "pairwise_steps": n_upd}

    # K2 masked_scores on the same micro-batch, as the cuda worker builds it.
    u_vecs, _, cand = masked_scores_inputs(torch, states, ev_u, u_slot,
                                           init_u)
    got = ops.masked_scores(u_vecs, states.item_vecs, cand)
    want = ref.masked_scores(u_vecs, states.item_vecs, cand)
    err = _close(got, want, "masked_scores")
    b, i = cand.shape[1], cand.shape[2]
    ms = _time_ms(torch, lambda: ops.masked_scores(u_vecs, states.item_vecs,
                                                   cand))
    device_ms = _time_ms(torch, lambda: ops.masked_scores(
        u_vecs, states.item_vecs, cand), cover_enqueue=True)
    plain_ms = _time_ms(torch, lambda: ref.masked_scores(
        u_vecs, states.item_vecs, cand))
    not_cand = ~cand
    it_t = states.item_vecs.transpose(1, 2)
    buf = torch.empty_like(got)

    def library():
        torch.baddbmm(buf, u_vecs, it_t, beta=0).masked_fill_(
            not_cand, float("-inf"))

    lib_ms = _time_ms(torch, library)
    lib_device_ms = _time_ms(torch, library, cover_enqueue=True)
    bound, by = _bound_ms(4 * n_w * (b * k + i * k) + 5 * n_w * b * i,
                          2 * n_w * b * i * k)
    rows.append(dict(
        name="masked_scores", route="cuda", matched=True,
        source="src/repro_torch/kernels/csrc/masked_scores.cu",
        replaces="src/repro/kernels/scoring.py:32",
        launches=main_counts["masked_scores"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
        device_ms=device_ms, library_device_ms=lib_device_ms,
        ptxas=_ptxas_instances(infos["masked_scores"].ptxas,
                               "masked_scores_kernel"),
        shape=f"W={n_w} B={b} I={i} k={k}"))
    del got, want, cand, not_cand, buf

    # K3 fused_topn on the serving inputs of one grid_topn call.
    (sv, items_t, mask, ids), k3_kw = fused_topn_inputs(torch, states, cfg,
                                                        serve_q)
    got_ids, got_sc = ops.fused_topn(sv, items_t, mask, ids, **k3_kw)
    want_ids, want_sc = ref.fused_topn(sv, items_t, mask, ids, **k3_kw)
    err = _close(got_sc, want_sc, "fused_topn scores")
    bad = _ids_mismatch(got_ids, want_ids, want_sc)
    if bad:
        fail(f"fused_topn: {bad} ids differ away from score ties")
    b = mask.shape[1]
    ms = _time_ms(torch, lambda: ops.fused_topn(sv, items_t, mask, ids,
                                                **k3_kw))
    device_ms = _time_ms(torch, lambda: ops.fused_topn(
        sv, items_t, mask, ids, **k3_kw), cover_enqueue=True)
    plain_ms = _time_ms(torch, lambda: ref.fused_topn(
        sv, items_t, mask, ids, **k3_kw), reps=5)
    not_mask = ~mask
    buf = torch.empty(mask.shape, device=sv.device)

    def library():
        torch.topk(torch.baddbmm(
            buf, sv, items_t.transpose(1, 2), beta=0)
            .masked_fill_(not_mask, float("-inf")), hyper.top_n, dim=-1)

    lib_ms = _time_ms(torch, library)
    lib_device_ms = _time_ms(torch, library, cover_enqueue=True)
    bound, by = _bound_ms(
        4 * n_w * (b * k + i * k + i) + n_w * b * i + 8 * n_w * b * hyper.top_n,
        2 * n_w * b * i * k)
    n_cand = mask.sum(-1)
    rows.append(dict(
        name="fused_topn", route="cuda", matched=True,
        source="src/repro_torch/kernels/csrc/fused_topn.cu",
        replaces="src/repro/kernels/topn.py:73",
        launches=serve_counts["fused_topn"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
        device_ms=device_ms, library_device_ms=lib_device_ms,
        ptxas=_registers_only(infos["fused_topn"].ptxas, "fused_topn", k),
        shape=f"W={n_w} B={b} I={i} k={k} N={hyper.top_n}",
        rows_without_candidate=int((n_cand == 0).sum()),
        rows_short=int(((n_cand > 0) & (n_cand < hyper.top_n)).sum())))
    del not_mask, buf

    # K6 isgd_update on worker 0's tables and bucket of the same batch.
    rows.append(_isgd_row(torch, np, isgd_cases(torch, np, states, u_slot,
                                                i_slot, ev_u, k),
                          hyper, infos))
    emit("kernels_vs_plain", matched=[r["name"] for r in rows],
         rtol=RTOL, atol=ATOL, score_gap=SCORE_GAP)
    return rows, random_j


def _isgd_case(torch, user_tab, item_tab, u_slot, i_slot, valid, hyper,
               plain_reps=2, plain_warmup=True):
    """isgd_update against its plain version, each timed on fresh clones
    of the tables and compared on its last timed run's tables (the plain
    version after no warm-up call without ``plain_warmup``): (max abs
    error, kernel ms, plain ms, bound ms, bound by, valid events, kernel
    device ms)."""
    from repro_torch.kernels import ops, ref

    events = (u_slot.contiguous(), i_slot.contiguous(), valid.contiguous())

    def timed(fn, reps, cover_enqueue=False, warmup=True):
        work = []

        def setup():
            work[:] = [user_tab.clone(), item_tab.clone()]

        ms = _time_ms(torch, lambda: fn(*work, *events, eta=hyper.eta,
                                        lam=hyper.lam), reps=reps,
                      setup=setup, cover_enqueue=cover_enqueue,
                      warmup=warmup)
        return ms, work

    device_ms, _ = timed(ops.isgd_update, 10, cover_enqueue=True)
    ms, got = timed(ops.isgd_update, 10)
    plain_ms, want = timed(ref.isgd_apply, plain_reps, warmup=plain_warmup)
    err = max(_close(g, w, "isgd_update") for g, w in zip(got, want))
    k = user_tab.shape[1]
    v = valid.bool()
    n_valid = int(v.sum())
    rows = int(torch.unique(u_slot[v]).numel() + torch.unique(i_slot[v])
               .numel())
    # Event arrays read once; every row a valid event touches read and
    # written once; 12 k flops per valid event (dot, two updates).
    bound, by = _bound_ms(9 * u_slot.numel() + 2 * 4 * k * rows,
                          12 * k * n_valid)
    return err, ms, plain_ms, bound, by, n_valid, device_ms


def _isgd_row(torch, np, cases, hyper, infos):
    """K6 on ``isgd_cases``: one DISGD worker's tables and bucket (its
    path is ``ops.isgd_update`` itself: counts zeroed, one call, read),
    then ``benchmarks/bench_kernels.py``'s shapes; each case beside its
    chain depth."""
    from repro_torch.kernels import ops

    (_, (user_tab, item_tab, u_slot, i_slot, valid)), *bench_cases = cases
    ops.reset_launch_counts()
    ops.isgd_update(user_tab.clone(), item_tab.clone(), u_slot, i_slot,
                    valid, eta=hyper.eta, lam=hyper.lam)
    launches = ops.launch_counts()["isgd_update"]
    if launches != 1:
        fail(f"isgd_update launched {launches} times for one call")
    err, ms, plain_ms, bound, by, n_valid, device_ms = _isgd_case(
        torch, user_tab, item_tab, u_slot, i_slot, valid, hyper)
    bench = []
    for case, (ut, it, us, is_, ok) in bench_cases:
        # The plain version's eager loop takes 0.4-6 s a call here: one
        # call, unwarmed (two took ~11 s more of the script's time).
        b_err, b_ms, b_plain, b_bound, b_by, _, b_device = _isgd_case(
            torch, ut, it, us, is_, ok, hyper, plain_reps=1,
            plain_warmup=False)
        bench.append({"case": case,
                      "shape": f"U={ut.shape[0]} I={it.shape[0]} "
                               f"E={us.numel()} k={ut.shape[1]}",
                      "chain_depth": chain_depth(np, us, is_, ok,
                                                 ut.shape[0], it.shape[0]),
                      "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain,
                      "device_ms": b_device, "bound_ms": b_bound,
                      "bound_by": b_by})
    entry = _ptxas_entries(infos["isgd_update"].ptxas).get(
        "isgd_update_kernel")
    if entry is None or entry["stack_bytes"] or entry["spill_store_bytes"]:
        fail(f"isgd_update: no ptxas report, a stack frame or spills: {entry}")
    return dict(
        name="isgd_update", route="cuda", matched=True,
        source="src/repro_torch/kernels/csrc/isgd_update.cu",
        replaces="src/repro/kernels/isgd.py:31", launches=launches,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=None, device_ms=device_ms,
        library="none: no single PyTorch call runs a chain of dependent "
                "SGD steps",
        ptxas=entry,
        shape=f"U={user_tab.shape[0]} I={item_tab.shape[0]} "
              f"E={u_slot.numel()} k={user_tab.shape[1]} (one worker)",
        valid_events=n_valid,
        chain_depth=chain_depth(np, u_slot, i_slot, valid,
                                user_tab.shape[0], item_tab.shape[0]),
        bench=bench)


def _topn_serve(torch, rt, states, cfg, batches, phase):
    """Phases ``serve`` and ``bpr_serve``: ``serve_calls`` on the factor-
    model ``states`` (one ``fused_topn`` a call), each call's lists held
    to the plain path's (``use_kernel=False``): scores within RTOL /
    ATOL, ids away from score ties, known / served equal. Returns (the
    calls' outputs, their launch counts)."""
    kw = serve_kw(cfg)
    lat, outs, counts = serve_calls(torch, rt, states, kw, batches)
    if counts["fused_topn"] != len(batches):
        fail(f"{phase}: fused_topn launched {counts['fused_topn']} times "
             f"for {len(batches)} serve calls")
    mismatched = 0
    for q, (ids, sc, known, served) in zip(batches, outs):
        p_ids, p_sc, p_known, p_served = rt.grid_topn(
            states, q, use_kernel=False, **kw)
        _close(sc, p_sc, f"{phase} scores")
        mismatched += _ids_mismatch(ids, p_ids, p_sc)
        if not (torch.equal(known, p_known) and torch.equal(served, p_served)):
            fail(f"{phase}: known/served differ from the plain path")
    if mismatched:
        fail(f"{phase}: {mismatched} served ids differ from the plain path "
             "away from score ties")
    served = sum(int(o[3].sum()) for o in outs)
    p50_ms = 1e3 * statistics.median(lat)
    emit(phase, algorithm=cfg.algorithm, queries=SERVE_USERS,
         batch=SERVE_BATCH, qcap=kw["qcap"], served=served,
         qps=served / sum(lat), p50_ms=p50_ms,
         max_ms=1e3 * max(lat), known=sum(int(o[2].sum()) for o in outs),
         launches=counts)
    return outs, counts, p50_ms


@contextlib.contextmanager
def _call_times(torch, module, names):
    """Card time of every call of ``module``'s functions ``names`` made in
    the block (the loop calls them through the module): a pair of CUDA
    events around each call, read after the block. Yields ``{name: [ms,
    ...]}``."""
    real = {n: getattr(module, n) for n in names}
    pairs = {n: [] for n in names}
    out = {n: [] for n in names}

    def timed(name):
        def call(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            r = real[name](*args, **kwargs)
            end.record()
            pairs[name].append((start, end))
            return r
        return call

    for n in names:
        setattr(module, n, timed(n))
    try:
        yield out
    finally:
        for n in names:
            setattr(module, n, real[n])
    torch.cuda.synchronize()
    for n in names:
        out[n].extend(a.elapsed_time(b) for a, b in pairs[n])


@contextlib.contextmanager
def _copy_times(torch):
    """Card time of every publish copy made in the block (each
    ``state.clone_state`` call: the engine's boundary copy and the
    session's final one)."""
    from repro_torch.core import state as state_lib

    with _call_times(torch, state_lib, ("clone_state",)) as times:
        yield times["clone_state"]


def _wait_for(cond, what: str, timeout: float = 120.0):
    t_end = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > t_end:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.001)


def _serve_while_ingesting(torch, rt, session, users, items, queries,
                           held_kw=None):
    """``session.ingest(users, items)`` on this thread while a reader
    thread serves: it waits for the first snapshot, then (with
    ``held_kw``) holds it, calls ``grid_topn`` on it, waits until the
    trainer has published twice more and calls it again; then it calls
    ``session.recommend(queries)`` every RECOMMEND_GAP_S until the
    ingest returns.
    Fails if any exception escapes the reader. Returns (the ingest's
    result, its wall seconds, the recommend calls' fields, each call's
    snapshot version, the held snapshot's (version, latest version,
    equal)). A call after a rotation misses the cache and waits for
    ``grid_topn`` behind the training steps queued on the stream; a call
    between rotations is answered from the cache."""
    import threading
    import traceback

    done = threading.Event()
    errors, lat, versions, held = [], [], [], []
    store = session.store
    q_dev = torch.as_tensor(queries, dtype=torch.int32, device=DEVICE)

    def reader():
        try:
            _wait_for(lambda: store.latest_version >= 1, "a first snapshot")
            if held_kw is not None:
                snap = store.acquire()
                first = rt.grid_topn(snap.states, q_dev, **held_kw)
                torch.cuda.synchronize()
                v0 = store.latest_version
                _wait_for(lambda: store.latest_version >= v0 + 2,
                          "two more publishes")
                again = rt.grid_topn(snap.states, q_dev, **held_kw)
                held.extend([snap.version, store.latest_version,
                             all(torch.equal(a, b)
                                 for a, b in zip(first, again))])
            while not done.wait(RECOMMEND_GAP_S):
                t0 = time.perf_counter()
                resp = session.recommend(queries)
                lat.append((time.perf_counter() - t0,
                            resp.cache_hits < queries.size))
                versions.append(resp.snapshot_version)
        except BaseException:
            errors.append(traceback.format_exc())

    thread = threading.Thread(target=reader, name="reader")
    thread.start()
    try:
        t0 = time.perf_counter()
        res = session.ingest(users, items)
        wall = time.perf_counter() - t0
    finally:
        done.set()
        thread.join(timeout=300)
    if thread.is_alive():
        fail("the reader thread did not finish")
    if errors:
        fail(f"an exception escaped the reader thread:\n{errors[0]}")
    if any(b < a for a, b in zip(versions, versions[1:])):
        fail(f"recommend's snapshot versions went down: {versions}")
    if not lat:
        fail("no recommend call ran during the ingest")

    def p50(sel):
        got = [1e3 * t for t, miss in lat if sel(miss)]
        return statistics.median(got) if got else None

    calls = dict(recommend_calls_during_ingest=len(lat),
                 recommend_misses_during_ingest=sum(m for _, m in lat),
                 recommend_gap_ms=1e3 * RECOMMEND_GAP_S,
                 recommend_p50_during_ingest_ms=p50(lambda m: True),
                 recommend_miss_p50_during_ingest_ms=p50(lambda m: m),
                 recommend_hit_p50_during_ingest_ms=p50(lambda m: not m),
                 recommend_max_during_ingest_ms=1e3 * max(t for t, _ in lat))
    return res, wall, calls, versions, held


def _host_popularity(np, item_ids, weight, top_n):
    """The popularity head on the host, by ``np.bincount`` over global
    ids: (ids, float32 mass), mass descending, ids ascending on ties."""
    ids, w = item_ids.reshape(-1), weight.reshape(-1).astype(np.float64)
    mass = np.bincount(ids[ids >= 0], weights=w[ids >= 0])
    head = np.lexsort((np.arange(mass.size), -mass))[:top_n]
    if not (mass[head] > 0).all():
        fail("the popularity head has fewer live items than top_n")
    return head, mass[head].astype(np.float32)


def _recommend_checks(torch, np, rt, session, cfg, batches, weight, phase):
    """After an ingest: ``recommend`` on ``batches[0]`` plus
    UNKNOWN_QUERIES ids no worker knows, twice. Known rows must equal
    ``grid_topn`` on the final states (ids exact, scores bit for bit),
    unknown rows the host popularity head of ``weight`` (the per-slot
    popularity weight), the second call must be all cache hits. Then
    the p50 of recommend calls that miss (``batches[1:]``, each
    unseen) and that hit (the same calls again). Returns the phase's
    serve fields and, under ``first``, the first call's response."""
    kw = serve_kw(cfg)
    known_q = batches[0].cpu().numpy()
    unknown = np.arange(UNKNOWN_QUERIES) + 10**7
    q = np.concatenate([known_q, unknown])
    first = session.recommend(q)
    second = session.recommend(q)
    ids, scores, known, served = (t.cpu().numpy() for t in rt.grid_topn(
        session.states, batches[0], **kw))
    k = known_q.size
    if not (served.all() and known.all() and first.known[:k].all()):
        fail(f"{phase}: the known users were not served as known")
    if first.known[k:].any() or first.fallbacks != UNKNOWN_QUERIES:
        fail(f"{phase}: unknown ids were answered as known")
    if not (np.array_equal(first.ids[:k], ids)
            and np.array_equal(first.scores[:k].view(np.uint32),
                               scores.view(np.uint32))):
        fail(f"{phase}: recommend's known rows differ from grid_topn on "
             "the final states")
    head, mass = _host_popularity(
        np, session.states.tables.item_ids.cpu().numpy(),
        weight(session.states).cpu().numpy(), cfg.resolved_hyper().top_n)
    if not (np.array_equal(first.ids[k:], np.broadcast_to(
            head, (UNKNOWN_QUERIES, head.size)))
            and np.array_equal(first.scores[k:], np.broadcast_to(
                mass, (UNKNOWN_QUERIES, mass.size)))):
        fail(f"{phase}: unknown rows differ from the host popularity head")
    if second.cache_hits != q.size or not (
            np.array_equal(second.ids, first.ids)
            and np.array_equal(second.scores, first.scores)):
        fail(f"{phase}: the repeated call was not answered from the cache")
    lat = {"miss": [], "hit": []}
    for kind in ("miss", "hit"):
        for qb in batches[1:]:
            t0 = time.perf_counter()
            resp = session.recommend(qb.cpu().numpy())
            lat[kind].append(time.perf_counter() - t0)
            if resp.cache_hits != (qb.numel() if kind == "hit" else 0):
                fail(f"{phase}: a {kind} call had {resp.cache_hits} hits")
    return dict(recommend_queries=q.size, unknown_queries=UNKNOWN_QUERIES,
                recommend_calls=len(batches) - 1,
                recommend_miss_p50_ms=1e3 * statistics.median(lat["miss"]),
                recommend_hit_p50_ms=1e3 * statistics.median(lat["hit"]),
                frontend=session.frontend.stats_snapshot(), first=first)


def _publish_checks(store, n, boundaries, phase):
    """Every async boundary rotated or was coalesced, the final publish
    rotated synchronously, and the front is the last snapshot."""
    stats = store.stats_snapshot()
    if stats["async_rotations"] + stats["coalesced"] != boundaries:
        fail(f"{phase}: {stats} does not account for {boundaries} "
             "publish boundaries")
    front = store.acquire()
    if (stats["sync_rotations"] != 1 or front.version != store.latest_version
            or front.events_processed != n):
        fail(f"{phase}: the front snapshot (v{front.version}, "
             f"{front.events_processed} events) is not the last one")
    return dict(boundaries=boundaries, publishes=boundaries + 1,
                rotations=stats["rotations"],
                async_rotations=stats["async_rotations"],
                coalesced=stats["coalesced"], front_version=front.version)


def _ingest_checks(res, n, steps, counts, kernels, phase):
    if res.events_processed + res.dropped != n or res.dropped:
        fail(f"{phase}: events_processed {res.events_processed} + dropped "
             f"{res.dropped} != {n}, or dropped != 0")
    for name in kernels:
        if counts[name] != steps:
            fail(f"{phase}: {name} launched {counts[name]} times, expected "
                 f"one per step ({steps})")


def _states_equal(torch, got, want) -> bool:
    """Two states equal table by table, bit for bit, in their resident
    dtypes (unsigned and bf16 tables compared through their bits)."""
    from repro_torch.core import convert, state as state_lib

    def bits(t):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else state_lib.signed(t))

    g, w = convert.flatten_state(got), convert.flatten_state(want)
    return sorted(g) == sorted(w) and all(
        g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
        and torch.equal(bits(g[k]), bits(w[k])) for k in w)


def _session_phases(torch, np, rt, users, items, cfg, main, main_tel,
                    batches, serve_p50):
    """``session_path`` and ``session_concurrent`` on the DISGD
    deployment. ``main`` holds the main path's result (final states,
    recall, events/s), ``main_tel`` its telemetry vector."""
    from repro_torch.kernels import ops

    # -- session_path -----------------------------------------------------------
    n = int(users.size)
    steps = _steps(n, cfg)
    serve_cfg = rt.ServeConfig.from_stream(
        cfg, batch_size=SERVE_BATCH,
        cache_capacity=SERVE_USERS + UNKNOWN_QUERIES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    session = rt.StreamSession(cfg, serve=serve_cfg, publish=rt.PublishPolicy(
        every=SESSION_EVERY, mode="async"))
    ops.reset_launch_counts()
    with _copy_times(torch) as copy_ms:
        t0 = time.perf_counter()
        res = session.ingest(users, items)
        ingest_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _ingest_checks(res, n, steps, counts, ("factor_update", "masked_scores"),
                   "session_path")
    if not (res.recall.mean() == main.recall.mean() and np.array_equal(
            res.recall.bits(), main.recall.bits(), equal_nan=True)):
        fail(f"session_path: Recall@10 {res.recall.mean()} differs from the "
             f"main path's {main.recall.mean()}")
    if not _states_equal(torch, session.states, main.final_states):
        fail("session_path: the final states differ from the main path's")
    counters = _stream_counters(session.metrics)
    if counters != {f: main_tel[f] for f in counters}:
        fail(f"session_path: registry counters {counters} differ from the "
             f"main path's telemetry vector {main_tel}")
    publish = _publish_checks(session.store, n, math.ceil(
        steps / SESSION_EVERY), "session_path")
    serve = _recommend_checks(torch, np, rt, session, cfg, batches,
                              lambda st: st.tables.item_freq, "session_path")
    out = dict(first=serve.pop("first"), copy_ms=copy_ms, peak=peak)
    emit("session_path", stream="synth_stream(MOVIELENS_25M, seed=0)",
         events=n, cut=None, publish_every=SESSION_EVERY, mode="async",
         steps=steps, wall_s=res.wall_seconds, ingest_wall_s=ingest_s,
         events_per_s=res.throughput, main_path_events_per_s=main.throughput,
         ingest_events_per_s=n / ingest_s, recall_at_10=res.recall.mean(),
         events_processed=res.events_processed, dropped=res.dropped,
         **publish, copy_ms=copy_ms, copy_bytes=_state_bytes(session.states),
         memory_allocated_before=before, max_memory_allocated=peak,
         serve_p50_ms=serve_p50, **serve, stream_counters=counters,
         recommend_p50_during_ingest_ms=None,
         during_ingest="phase session_concurrent", launches=counts)
    del session, res
    torch.cuda.empty_cache()

    # -- session_concurrent -----------------------------------------------------
    n = CONCURRENT_BATCHES * MICRO_BATCH
    steps = _steps(n, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    session = rt.StreamSession(cfg, serve=serve_cfg, publish=rt.PublishPolicy(
        every=CONCURRENT_EVERY, mode="async"))
    with _copy_times(torch) as copy_ms:
        res, ingest_s, calls, versions, held = _serve_while_ingesting(
            torch, rt, session, users[:n], items[:n],
            batches[0].cpu().numpy(), held_kw=serve_kw(cfg))
    peak = torch.cuda.max_memory_allocated()
    if not held[2]:
        fail("session_concurrent: grid_topn on a held snapshot changed "
             "while training published")
    publish = _publish_checks(session.store, n, math.ceil(
        steps / CONCURRENT_EVERY), "session_concurrent")
    _ingest_checks(res, n, steps, {}, (), "session_concurrent")
    emit("session_concurrent", stream="synth_stream(MOVIELENS_25M, seed=0)",
         events=n, cut=f"first {CONCURRENT_BATCHES} micro-batches",
         publish_every=CONCURRENT_EVERY, mode="async", steps=steps,
         wall_s=res.wall_seconds, ingest_wall_s=ingest_s,
         events_per_s=res.throughput, main_path_events_per_s=main.throughput,
         dropped=res.dropped, **publish, copy_ms=copy_ms,
         memory_allocated_before=before, max_memory_allocated=peak,
         held_snapshot={"version": held[0], "latest_at_recheck": held[1],
                        "answers_equal": held[2]},
         **calls, versions_seen=sorted(set(versions)),
         serve_p50_ms=serve_p50)
    del session, res
    torch.cuda.empty_cache()
    return out


def _dics_session(torch, np, rt, users, items, cfg, dics_path, serve_p50):
    """``dics_session``: DICS through the session on the first
    DICS_SESSION_BATCHES micro-batches at the full Netflix width, a
    reader serving during the ingest; states equal to a plain run over
    the same events. Its queries are users of those events."""
    from repro_torch.kernels import ops

    n = DICS_SESSION_BATCHES * MICRO_BATCH
    u, i = users[:n], items[:n]
    steps = _steps(n, cfg)
    batches = serve_batches(torch, np, u, DEVICE)
    plain = rt.run_stream(u, i, cfg)
    serve_cfg = rt.ServeConfig.from_stream(
        cfg, batch_size=SERVE_BATCH,
        cache_capacity=SERVE_USERS + UNKNOWN_QUERIES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    session = rt.StreamSession(cfg, serve=serve_cfg, publish=rt.PublishPolicy(
        every=DICS_SESSION_EVERY, mode="async"))
    ops.reset_launch_counts()
    with _copy_times(torch) as copy_ms:
        res, ingest_s, calls, versions, _ = _serve_while_ingesting(
            torch, rt, session, u, i, batches[0].cpu().numpy())
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _ingest_checks(res, n, steps, counts, ("dics_update",), "dics_session")
    if not counts["dics_topn"]:
        fail("dics_session: no recommend ran on dics_topn during the ingest")
    if not (_states_equal(torch, session.states, plain.final_states)
            and np.array_equal(res.recall.bits(), plain.recall.bits(),
                               equal_nan=True)):
        fail("dics_session: states or recall differ from a plain run")
    publish = _publish_checks(session.store, n, math.ceil(
        steps / DICS_SESSION_EVERY), "dics_session")
    serve = _recommend_checks(torch, np, rt, session, cfg, batches,
                              lambda st: st.item_cnt, "dics_session")
    serve.pop("first")
    emit("dics_session", stream="synth_stream(NETFLIX, seed=0)", events=n,
         cut=f"first {DICS_SESSION_BATCHES} micro-batches of "
             f"{math.ceil(users.size / MICRO_BATCH)} trained by dics_path "
             "(at ~106 ms a step a second run of them would take ~36 s of "
             "the script's time limit)",
         publish_every=DICS_SESSION_EVERY, mode="async", steps=steps,
         wall_s=res.wall_seconds, ingest_wall_s=ingest_s,
         events_per_s=res.throughput, plain_events_per_s=plain.throughput,
         dics_path_events_per_s=dics_path.throughput,
         recall_at_10=res.recall.mean(), dropped=res.dropped, **publish,
         copy_ms=copy_ms, copy_bytes=_state_bytes(session.states),
         memory_allocated_before=before, max_memory_allocated=peak,
         serve_p50_ms=serve_p50, **serve, **calls, launches=counts)
    del session, res
    torch.cuda.empty_cache()
    return plain


# -- storage policies, regrid and checkpoints -----------------------------------

# The bf16 phase's cut, the profiled steps of the codecs (64 until the
# script came within 15% of its time limit), and the checkpoint phase's
# second grid (a refine of the item splits, with caps that still hold
# every split's items: 27,133 / 8 <= 3,392).
STORAGE_BF16_BATCHES = 128
CODEC_PROFILE_STEPS = 32
REFINED = (8, 4)
REFINED_I_CAP = 3_392
CHECKPOINT_DIR = ROOT / "build" / "chip_smoke_checkpoints"


def _decoded_equal(torch, states, policy, dense) -> bool:
    from repro_torch.core import storage

    return _states_equal(torch, storage.decode_state(states, policy), dense)


def _bits_equal(np, a, b) -> bool:
    return np.array_equal(a.recall.bits(), b.recall.bits(), equal_nan=True)


def _codec_profile(torch, rt, users, items, cfg, policy) -> dict:
    """The first CODEC_PROFILE_STEPS micro-batches under ``policy``, under
    ``torch.profiler`` and with the codecs timed by CUDA events: codec
    card ms a step (decode = unpack, encode = pack) beside their bound
    (the packed words read and the bitmap written, and back, over the
    HBM rate), and the step's kernels by name."""
    from repro_torch.core import storage

    n = CODEC_PROFILE_STEPS * cfg.micro_batch
    c_cfg = dataclasses.replace(cfg, storage=policy)
    with _call_times(torch, storage, ("decode_state", "encode_into")) as t:
        prof = _profiled(torch, rt, users, items, c_cfg,
                         CODEC_PROFILE_STEPS)
    codec = {"decode": t["decode_state"], "encode": t["encode_into"]}
    hyper = cfg.resolved_hyper()
    n_c = cfg.grid.n_c
    dense = n_c * hyper.u_cap * hyper.i_cap
    packed = 4 * n_c * hyper.u_cap * storage.packed_width(hyper.i_cap)
    per_step = {k: statistics.median(v) for k, v in codec.items()}
    bound = (dense + packed) / _hw().hbm_bw * 1e3
    return dict(events=int(min(n, users.size)), steps=prof["steps"],
                unpack_ms=per_step["decode"], pack_ms=per_step["encode"],
                unpack_bound_ms=bound, pack_bound_ms=bound,
                codec_ms_per_step=per_step["decode"] + per_step["encode"],
                codec_bound_ms_per_step=2 * bound,
                codec_calls=len(codec["decode"]),
                rated_dense_bytes=dense, rated_packed_bytes=packed,
                profile=prof)


def _storage_phases(torch, np, rt, users, items, cfg, main_res, main,
                    batches, serve_p50, session):
    """``storage_path``, ``storage_bf16``, ``session_storage``,
    ``checkpoint_path`` and ``rescale_path`` on the DISGD deployment.
    ``main_res`` is the main path's result (dense final states), ``main``
    its numbers, ``session`` session_path's copy times, peak and first
    recommend answer. Returns the DISGD half of ``storage_serve``."""
    import shutil

    from repro_torch.core import convert, regrid, state as state_lib, storage
    from repro_torch.kernels import ops

    comp = rt.StoragePolicy.compressed()
    c_cfg = dataclasses.replace(cfg, storage=comp)
    n = int(users.size)
    steps = _steps(n, cfg)

    # -- storage_path -----------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    res = rt.run_stream(users, items, c_cfg)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _ingest_checks(res, n, steps, counts, ("factor_update", "masked_scores"),
                   "storage_path")
    if not _bits_equal(np, res, main_res):
        fail(f"storage_path: recall bits differ from the main path's "
             f"({res.recall.mean()} against {main_res.recall.mean()})")
    if not _decoded_equal(torch, res.final_states, comp,
                          main_res.final_states):
        fail("storage_path: the decoded final states differ from the main "
             "path's")
    codec = _codec_profile(torch, rt, users, items, cfg, comp)
    emit("storage_path", stream="synth_stream(MOVIELENS_25M, seed=0)",
         events=n, cut=None, policy=comp.describe(), steps=steps,
         wall_s=res.wall_seconds, events_per_s=res.throughput,
         main_path_events_per_s=main["events_per_s"],
         recall_at_10=res.recall.mean(), dropped=res.dropped,
         resident_bytes=storage.total_nbytes(res.final_states),
         main_path_resident_bytes=storage.total_nbytes(main_res.final_states),
         tables=storage.state_nbytes(res.final_states),
         memory_allocated_before=before, max_memory_allocated=peak,
         main_path_max_memory_allocated=main["peak"], launches=counts,
         codec=codec)
    comp_states = res.final_states
    comp_bits = res.recall.bits()
    comp_bits = comp_bits[~np.isnan(comp_bits)]
    del res

    # -- storage_bf16 -------------------------------------------------------------
    bf16 = rt.StoragePolicy.compressed(factors="bf16")
    m = STORAGE_BF16_BATCHES * MICRO_BATCH
    dense = rt.run_stream(users[:m], items[:m], cfg)
    half = rt.run_stream(users[:m], items[:m],
                         dataclasses.replace(cfg, storage=bf16))
    dec = storage.decode_state(half.final_states, bf16)
    ints_equal = all(torch.equal(a, b) for a, b in zip(
        dec.tables, dense.final_states.tables)) and torch.equal(
            dec.rated, dense.final_states.rated)
    if not ints_equal:
        fail("storage_bf16: the integer tables or rated differ from the "
             "default policy's run over the same batches")
    if half.final_states.user_vecs.dtype != torch.bfloat16:
        fail("storage_bf16: the factors are not stored as bf16")
    vec_err = max(float((dec.user_vecs - dense.final_states.user_vecs).abs()
                        .max()), float((dec.item_vecs - dense.final_states
                                        .item_vecs).abs().max()))
    emit("storage_bf16", stream="synth_stream(MOVIELENS_25M, seed=0)",
         events=m, cut=f"first {STORAGE_BF16_BATCHES} micro-batches",
         policy=bf16.describe(), integer_tables_equal=ints_equal,
         recall_at_10=half.recall.mean(),
         default_recall_at_10=dense.recall.mean(),
         recall_bits_equal=_bits_equal(np, half, dense),
         max_abs_factor_difference=vec_err,
         events_per_s=half.throughput, default_events_per_s=dense.throughput,
         resident_bytes=storage.total_nbytes(half.final_states),
         default_resident_bytes=storage.total_nbytes(dense.final_states))
    del dense, half, dec

    # -- storage_serve (DISGD half, K3) ------------------------------------------
    kw = serve_kw(cfg)
    lat, outs, s_counts = serve_calls(torch, rt, comp_states,
                                      dict(kw, storage=comp), batches)
    if s_counts["fused_topn"] != len(batches):
        fail(f"storage_serve: fused_topn launched {s_counts['fused_topn']} "
             f"times for {len(batches)} calls")
    for q, out in zip(batches, outs):
        want = rt.grid_topn(main_res.final_states, q, **kw)
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            fail("storage_serve: DISGD answers on compressed states differ "
                 "from the dense states' (ids or score bits)")
    disgd_serve = dict(p50_ms=1e3 * statistics.median(lat),
                       serve_p50_ms=serve_p50, calls=len(batches),
                       answers_equal=True, launches=s_counts)

    # -- session_storage ------------------------------------------------------------
    serve_cfg = rt.ServeConfig.from_stream(
        c_cfg, batch_size=SERVE_BATCH,
        cache_capacity=SERVE_USERS + UNKNOWN_QUERIES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sess = rt.StreamSession(c_cfg, serve=serve_cfg, publish=rt.PublishPolicy(
        every=SESSION_EVERY, mode="async"))
    with _copy_times(torch) as copy_ms:
        t0 = time.perf_counter()
        res = sess.ingest(users, items)
        ingest_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _ingest_checks(res, n, steps, {}, (), "session_storage")
    if not (_states_equal(torch, sess.states, comp_states)
            and _bits_equal(np, res, main_res)):
        fail("session_storage: states or recall differ from storage_path's")
    publish = _publish_checks(sess.store, n, math.ceil(
        steps / SESSION_EVERY), "session_storage")
    serve = _recommend_checks(torch, np, rt, sess, c_cfg, batches,
                              lambda st: st.tables.item_freq,
                              "session_storage")
    first = serve.pop("first")
    if not (np.array_equal(first.ids, session["first"].ids)
            and np.array_equal(first.scores.view(np.uint32),
                               session["first"].scores.view(np.uint32))):
        fail("session_storage: recommend answers differ from session_path's")
    emit("session_storage", stream="synth_stream(MOVIELENS_25M, seed=0)",
         events=n, cut=None, policy=comp.describe(),
         publish_every=SESSION_EVERY, mode="async", steps=steps,
         wall_s=res.wall_seconds, ingest_wall_s=ingest_s,
         events_per_s=res.throughput, dropped=res.dropped, **publish,
         copy_ms=copy_ms, copy_bytes=_state_bytes(sess.states),
         session_path_copy_ms=session["copy_ms"],
         memory_allocated_before=before, max_memory_allocated=peak,
         session_path_max_memory_allocated=session["peak"],
         recommend_equal_to_session_path=True, **serve)
    del sess, res
    torch.cuda.empty_cache()

    # -- checkpoint_path ---------------------------------------------------------------
    n_batches = math.ceil(n / MICRO_BATCH)
    cut = (n_batches // 2) * MICRO_BATCH
    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    sess = rt.StreamSession(c_cfg)
    first = sess.ingest(users[:cut], items[:cut])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = sess.checkpoint(str(CHECKPOINT_DIR))
    write_s = time.perf_counter() - t0
    file_bytes = Path(path).stat().st_size
    t0 = time.perf_counter()
    back = rt.StreamSession.restore(str(CHECKPOINT_DIR), c_cfg)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    if not _states_equal(torch, back.states, sess.states):
        fail("checkpoint_path: restore at 4 x 4 differs from the saved "
             "states")
    if back.events_processed != sess.events_processed:
        fail("checkpoint_path: restore lost events_processed")
    second = back.ingest(users[cut:], items[cut:])
    if first.telemetry.requeued or second.telemetry.requeued:
        fail("checkpoint_path: events re-queued across the cut, so the two "
             "halves are not the whole stream's steps")
    if not _states_equal(torch, back.states, comp_states):
        fail("checkpoint_path: resuming the second half does not end at "
             "storage_path's final states")
    bits = np.concatenate([first.recall.bits(), second.recall.bits()])
    if not np.array_equal(bits[~np.isnan(bits)], comp_bits):
        fail("checkpoint_path: the resumed stream's recall bits differ from "
             "storage_path's")
    grid2 = rt.GridSpec.rect(*REFINED)
    cfg2 = dataclasses.replace(c_cfg, grid=grid2, hyper=c_cfg.hyper._replace(
        i_cap=REFINED_I_CAP))
    t0 = time.perf_counter()
    wide = rt.restore_stream_checkpoint(str(CHECKPOINT_DIR), cfg2)
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    live = regrid.regrid(sess.states, c_cfg.grid, grid2, i_cap=REFINED_I_CAP,
                         storage=comp)
    if not _states_equal(torch, wide.states, live):
        fail("checkpoint_path: restore at 8 x 4 differs from a live regrid "
             "of the same states")
    emit("checkpoint_path", stream="synth_stream(MOVIELENS_25M, seed=0)",
         events=n, cut=f"checkpoint after {cut // MICRO_BATCH} of "
         f"{n_batches} micro-batches", policy=comp.describe(),
         format="sr-logical-v1", file_bytes=file_bytes,
         resident_bytes=_state_bytes(sess.states), write_s=write_s,
         read_s=read_s, restore_8x4_s=wide_s, restored_equal=True,
         resumed_equal_to_storage_path=True,
         resumed_events=second.events_processed,
         regrid_equal_to_restore_8x4=True)
    del sess, wide, live, second, first
    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- rescale_path: on the trained compressed session -------------------------
    before = {k: state_lib.signed(v).clone() for k, v in
              convert.flatten_state(back.states).items()}
    walls = {}

    def rescale(name, grid, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back.rescale(grid, **kw)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0

    def same(fields):
        now = convert.flatten_state(back.states)
        return all(torch.equal(state_lib.signed(now[k]), before[k])
                   for k in fields)

    rescale("identity_4x4", c_cfg.grid)
    if not same(before):
        fail("rescale_path: rescale to the same grid is not the identity")
    rescale("refine_8x4", grid2, i_cap=REFINED_I_CAP)
    rescale("coarsen_4x4", c_cfg.grid, i_cap=I_CAP)
    kept = ("user_ids", "item_ids", "rated", "user_vecs", "item_vecs")
    if not same(kept):
        fail("rescale_path: 4 x 4 -> 8 x 4 -> 4 x 4 changed the rated "
             "relation, the id sets or the vectors")
    rescale("migrate_to_default", c_cfg.grid, storage=rt.StoragePolicy())
    if (back.states.rated.dtype != torch.bool
            or back.frontend.cfg.storage is not None):
        fail("rescale_path: the migration left the compressed encoding")
    q = np.concatenate([batches[0].cpu().numpy(),
                        np.arange(UNKNOWN_QUERIES) + 10**7])
    again = back.recommend(q)
    if not (np.array_equal(again.ids, session["first"].ids)
            and np.array_equal(again.scores.view(np.uint32),
                               session["first"].scores.view(np.uint32))):
        fail("rescale_path: answers after the migration differ from the "
             "dense session's")
    emit("rescale_path", stream="synth_stream(MOVIELENS_25M, seed=0)",
         events=n, policy=comp.describe(), grids=[[N_I, N_I], list(REFINED),
                                                  [N_I, N_I]],
         i_caps=[I_CAP, REFINED_I_CAP, I_CAP], wall_s=walls,
         identity_equal=True, round_trip_equal=list(kept),
         migrated_answers_equal_to_session_path=True,
         resident_bytes_after_migration=_state_bytes(back.states),
         regrid_spans=back.metrics.get("span_seconds").labels(
             stage="regrid").count)
    del back, before
    torch.cuda.empty_cache()
    return disgd_serve, comp_states


def _state_bytes(states) -> int:
    from repro_torch.core import storage

    return storage.total_nbytes(states)


# bpr_backends_agree: the first half of its small stream (4 of 8 micro-
# batches: the eager host and scan loops set its time; the whole stream
# until the LLM families' phases came and the script ran 850-950 s).
BPR_AGREE_EVENTS = 1950


def bpr_config(rt):
    """The BPR-MF path's ``StreamConfig``: the DISGD deployment
    (MovieLens-25M caps) with the pairwise trainer."""
    return rt.StreamConfig(
        algorithm="bpr", grid=rt.GridSpec(n_i=N_I), micro_batch=MICRO_BATCH,
        capacity_factor=2.0,
        hyper=rt.BprHyper(k=10, u_cap=U_CAP, i_cap=I_CAP, top_n=10),
        backend="cuda", device=DEVICE)


def bpr_batch(torch, np, users, items, states, cfg, fresh_rate=0.1):
    """K1's pairwise inputs on the kernels line: ``kernel_batch``'s mid-
    stream micro-batch (rng seed 1) on the BPR-trained ``states``, with
    the negative slots the BPR worker draws for it (clock at batch start
    plus the valid events before each)."""
    from repro_torch.algos import bpr
    from repro_torch.core import prng

    hyper = cfg.resolved_hyper()
    ev_u, ev_i, u_slot, i_slot, init_u, init_i = kernel_batch(
        torch, np, users, items, cfg, np.random.default_rng(1), fresh_rate)
    clocks = bpr.event_clocks(states.tables.clock, ev_u >= 0)
    j_slot = bpr.negative_slots(prng.key(cfg.seed, device=ev_u.device),
                                clocks, ev_u, hyper.i_cap)
    return ev_u, ev_i, u_slot, i_slot, j_slot, init_u, init_i


def _sampler_cost(torch, np, users, items, states, cfg):
    """The BPR worker's negative draws for one step (``negative_slots`` on
    ``bpr_batch``'s events): device operations (profiler counts), their
    device ms, and the host's ms to issue them, synchronised."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.algos import bpr
    from repro_torch.core import prng

    ev_u = bpr_batch(torch, np, users, items, states, cfg)[0]
    key = prng.key(cfg.seed, device=ev_u.device)
    clocks = bpr.event_clocks(states.tables.clock, ev_u >= 0)
    i_cap = cfg.resolved_hyper().i_cap

    def draw():
        return bpr.negative_slots(key, clocks, ev_u, i_cap)

    draw()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        draw()
        torch.cuda.synchronize()
    rows, busy_ms = _device_rows(prof)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        draw()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    return {"device_ops_per_step": sum(r[1] for r in rows),
            "device_ms_per_step": busy_ms,
            "host_ms_per_step": statistics.median(host)}


def _bpr_phases(torch, np, rt, dev, users, items, random_j, infos):
    """BPR-MF trained over the whole MovieLens-25M stream on K1's pairwise
    mode and K2, profiled, served on K3, K1 pairwise held against its
    plain version on its own batch, and the backends held to each other.
    Returns K1's pairwise row of the kernels line."""
    from repro_torch.kernels import ops

    # -- 5a. bpr_path ----------------------------------------------------------
    n = int(users.size)
    cfg = bpr_config(rt)
    grid = cfg.grid
    steps = _steps(n, cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = rt.run_stream(users, items, cfg)
    path_counts = ops.launch_counts()
    if res.events_processed + res.dropped != n:
        fail(f"bpr: events_processed {res.events_processed} + dropped "
             f"{res.dropped} != {n}")
    if res.dropped:
        fail(f"bpr: {res.dropped} events dropped")
    for name in ("factor_update", "masked_scores"):
        if path_counts[name] != steps:
            fail(f"{name} launched {path_counts[name]} times on the BPR "
                 f"path, expected one per step ({steps})")
    states = res.final_states
    emit("bpr_path", stream="synth_stream(MOVIELENS_25M, seed=0)", events=n,
         cut=None, grid=[grid.n_i, grid.g], u_cap=U_CAP, i_cap=I_CAP,
         micro_batch=MICRO_BATCH, bucket_capacity=cfg.bucket_capacity,
         steps=steps, wall_s=res.wall_seconds,
         wall_ms_per_step=1e3 * res.wall_seconds / steps,
         events_per_s=res.throughput, recall_at_10=res.recall.mean(),
         events_processed=res.events_processed, dropped=res.dropped,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=path_counts)
    _profile_steps(torch, rt, users, items, cfg, steps=PROFILE_STEPS,
                   phase="bpr_profile",
                   sampler=_sampler_cost(torch, np, users, items, states,
                                         cfg))

    # -- 5b. bpr_serve -----------------------------------------------------------
    batches = serve_batches(torch, np, users, dev)
    _, serve_counts, _ = _topn_serve(torch, rt, states, cfg, batches,
                                     "bpr_serve")
    del batches

    # -- 5c. K1 pairwise on the BPR path's own batch ------------------------------
    row = _bpr_kernel_row(torch, np, users, items, states, cfg, path_counts,
                          infos, random_j)
    del states, res
    torch.cuda.empty_cache()

    # -- 5d. backends agree on the card ---------------------------------------------
    _bpr_backends_agree(torch, np, rt)
    return [row]


def _bpr_kernel_row(torch, np, users, items, states, cfg, path_counts, infos,
                    random_j):
    """K1 in pairwise mode against its plain version on ``bpr_batch`` (the
    kernels line's fresh batch, and the same without the fresh ids) of the
    BPR-trained state; ``random_j`` is the random-negative case on the
    DISGD state."""
    hyper = cfg.resolved_hyper()
    k = hyper.k
    rows = {}
    for case, rate in (("fresh", 0.1), ("no_fresh", 0.0)):
        events = bpr_batch(torch, np, users, items, states, cfg, rate)
        ev_u, ev_i, u_slot, i_slot = events[:4]
        n_valid = int((ev_u >= 0).sum())
        n_steps = _pairwise_steps(torch, np, states, events)
        n_bytes = _touched_bytes(np, (states.tables.user_ids,
                                      states.tables.item_ids), ev_u, ev_i,
                                 u_slot, i_slot, hyper.u_cap, hyper.i_cap, k)
        bound, by = _pairwise_bound(n_bytes, n_valid, n_steps, k)
        err, ms, plain_ms, device_ms = _k1_case(torch, states, events, hyper,
                                                plain=case == "fresh")
        rows[case] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          device_ms=device_ms, bound_ms=bound, bound_by=by,
                          valid_events=n_valid, pairwise_steps=n_steps)
    log = infos["factor_update"].ptxas
    layout = _staged_layout("factor_update", events[0].shape[1], k, log,
                            "factor_update_pairwise_kernel",
                            layout="factor_update_pairwise_layout")
    if layout["stack_bytes"] or layout["spill_store_bytes"]:
        fail(f"factor_update pairwise: a stack frame or spills: {layout}")
    fresh = rows["fresh"]
    n_w, cap = events[0].shape
    row = dict(
        name="factor_update", route="cuda", matched=True, mode="pairwise",
        source="src/repro_torch/kernels/csrc/factor_update.cu",
        replaces="src/repro/kernels/factor_update.py:41",
        launches=path_counts["factor_update"], **fresh, library_ms=None,
        library="none: no single PyTorch call runs a chain of evicting "
                "pairwise SGD steps",
        no_fresh=rows["no_fresh"], random_j_on_disgd_state=random_j,
        **layout,
        shape=f"W={n_w} E={cap} U={hyper.u_cap} I={hyper.i_cap} k={k} "
              "(BPR-trained state, the worker's own negatives)")
    emit("bpr_kernels_vs_plain", matched=["factor_update (pairwise)"],
         rtol=RTOL, atol=ATOL)
    return row


def _bpr_backends_agree(torch, np, rt):
    """BPR on a small stream with slot collisions: ``cuda``, ``scan`` and
    ``host`` on the card, and ``cuda`` on CPU tensors. ``scan`` and
    ``host`` run the same eager worker: states and evaluated recall bits
    equal. ``cuda`` against ``scan``: integers exactly, floats within
    STREAM_RTOL / STREAM_ATOL. The card's ``cuda`` run against the same
    run on CPU tensors (the plain versions, which the CPU tests hold to
    JAX): integers and recall bits (the bucket-start contract) equal."""
    from repro_torch.core import convert
    from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream

    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.003), seed=0)
    # Its first BPR_AGREE_EVENTS events: ~96 users per column and ~20
    # items per split, so both tables collide.
    users, items = users[:BPR_AGREE_EVENTS], items[:BPR_AGREE_EVENTS]
    hyper = rt.BprHyper(u_cap=32, i_cap=8)
    cfg = rt.StreamConfig(algorithm="bpr", grid=rt.GridSpec(n_i=N_I),
                          micro_batch=512, hyper=hyper, backend="cuda",
                          device=DEVICE)
    runs = {name: rt.run_stream(users, items, dataclasses.replace(cfg, **kw))
            for name, kw in (("cuda", {}), ("scan", dict(backend="scan")),
                             ("host", dict(backend="host")),
                             ("cpu", dict(device="cpu")))}
    counts = {(r.events_processed, r.dropped) for r in runs.values()}
    if len(counts) != 1:
        fail(f"bpr backends processed / dropped different counts: {counts}")
    st = {name: convert.states_to_numpy(r.final_states)
          for name, r in runs.items()}
    err = 0.0
    for name in st["cuda"]:
        if not np.array_equal(st["scan"][name], st["host"][name]):
            fail(f"bpr scan and host: {name} differs")
        for other in ("scan", "cpu"):
            a, b = st["cuda"][name], st[other][name]
            if a.dtype.kind != "f":
                if not np.array_equal(a, b):
                    fail(f"bpr cuda and {other}: {name} differs")
                continue
            if not np.allclose(a, b, rtol=STREAM_RTOL, atol=STREAM_ATOL):
                fail(f"bpr cuda and {other}: {name} beyond "
                     f"rtol={STREAM_RTOL} atol={STREAM_ATOL}")
            err = max(err, float(np.abs(a - b).max()))
    bits = {name: r.recall.bits() for name, r in runs.items()}
    scan_b, host_b = (bits[n][~np.isnan(bits[n])] for n in ("scan", "host"))
    if not np.array_equal(scan_b, host_b):
        fail("bpr scan and host: recall bits differ")
    if not np.array_equal(bits["cuda"], bits["cpu"], equal_nan=True):
        fail("bpr cuda on the card and on the cpu: recall bits differ")
    emit("bpr_backends_agree",
         stream="synth_stream(scaled(MOVIELENS_25M, 0.003))",
         cut=f"first {BPR_AGREE_EVENTS} of 3,901 events",
         events=int(users.size), u_cap=hyper.u_cap, i_cap=hyper.i_cap,
         max_abs_err=err, rtol=STREAM_RTOL, atol=STREAM_ATOL,
         wall_s={name: r.wall_seconds for name, r in runs.items()},
         recall={name: r.recall.mean() for name, r in runs.items()})


def _host_agrees(np, rt, users, items, cfg, scan, what):
    """The ``host`` loop on the card against the ``scan`` run ``scan`` of
    the same stream and config: the same eager worker, so every state
    array and every evaluated recall bit equal. Returns the host run."""
    from repro_torch.core import convert

    host = rt.run_stream(users, items, dataclasses.replace(cfg,
                                                           backend="host"))
    if ((host.events_processed, host.dropped)
            != (scan.events_processed, scan.dropped)):
        fail(f"{what}: host and scan processed / dropped different counts")
    sh = convert.states_to_numpy(host.final_states)
    ss = convert.states_to_numpy(scan.final_states)
    for name in ss:
        if not np.array_equal(sh[name], ss[name]):
            fail(f"{what} host and scan: {name} differs")
    hb, sb = host.recall.bits(), scan.recall.bits()
    if not np.array_equal(hb[~np.isnan(hb)], sb[~np.isnan(sb)]):
        fail(f"{what} host and scan: recall bits differ")
    return host


def _backends_agree(torch, np, rt):
    from repro_torch.core import convert
    from repro_torch.data.stream import MOVIELENS_25M, scaled, synth_stream

    users, items, _ = synth_stream(scaled(MOVIELENS_25M, 0.01), seed=0)
    # ~387 users per column and ~68 items per split: both tables collide.
    hyper = rt.DisgdHyper(u_cap=64, i_cap=16)
    cfg = rt.StreamConfig(grid=rt.GridSpec(n_i=N_I), micro_batch=MICRO_BATCH,
                          hyper=hyper, backend="cuda", device=DEVICE)
    a = rt.run_stream(users, items, cfg)
    b = rt.run_stream(users, items, dataclasses.replace(cfg, backend="scan"))
    if (a.events_processed, a.dropped) != (b.events_processed, b.dropped):
        fail("cuda and scan backends processed / dropped different counts")
    h = _host_agrees(np, rt, users, items, cfg, b, "disgd")
    sa, sb = convert.states_to_numpy(a.final_states), \
        convert.states_to_numpy(b.final_states)
    err = 0.0
    for name in sa:
        if sa[name].dtype.kind == "f":
            if not np.allclose(sa[name], sb[name], rtol=STREAM_RTOL,
                               atol=STREAM_ATOL):
                fail(f"backends: {name} beyond rtol={STREAM_RTOL} "
                     f"atol={STREAM_ATOL}")
            err = max(err, float(np.abs(sa[name] - sb[name]).max()))
        elif not np.array_equal(sa[name], sb[name]):
            fail(f"backends: {name} differs")
    emit("backends_agree", stream="synth_stream(scaled(MOVIELENS_25M, 0.01))",
         events=int(users.size), u_cap=hyper.u_cap, i_cap=hyper.i_cap,
         max_abs_err=err, rtol=STREAM_RTOL, atol=STREAM_ATOL,
         cuda_wall_s=a.wall_seconds, scan_wall_s=b.wall_seconds,
         host_wall_s=h.wall_seconds, host_equals_scan=True,
         recall_cuda=a.recall.mean(), recall_scan=b.recall.mean())


# -- telemetry, forgetting and drift control -------------------------------------

# The registry counters a session's TelemetryFolder keeps, by vector field.
STREAM_COUNTERS = {"events": "stream_events_total",
                   "dropped": "stream_dropped_total",
                   "requeued": "stream_requeued_total",
                   "evictions": "stream_evictions_total",
                   "hits": "stream_recall_hits_total",
                   "evals": "stream_recall_evals_total",
                   "list_len": "stream_list_len_total"}
# The repo's forgetting presets for the paper's Figs. 5-7
# (benchmarks/common.py:80-81, benchmarks/bench_forgetting.py:18).
FORGETTING_PRESETS = {
    "lru": dict(policy="lru", trigger_every=2048, lru_max_age=3000),
    "lfu": dict(policy="lfu", trigger_every=2048, lfu_min_freq=2),
    "gradual": dict(policy="gradual", trigger_every=2048,
                    gradual_gamma=0.9)}
# Cut from 128, then 64, to leave the grid phases room within the time
# limit, then 32 when the script came within 15% of it.
TELEMETRY_COST_BATCHES = 16
# drift_path: the DICS deployment on an abrupt drift of Netflix's
# profile with the scenarios' steeper popularity (DEFAULT_PROFILE's
# item_zipf), cut to DRIFT_EVENTS raw events for the run's time limit.
DRIFT_EVENTS, DRIFT_AT = 131_072, 0.3
# drift_backends_agree: benchmarks/bench_drift.py's small configuration;
# BPR-MF cut to the stream's first events (its eager worker, on scan and
# host, takes ~45 s over the whole stream on the card: ~1.3 s a step of
# 128 events a worker; 2,048 until the grid's async phases needed the
# time, 1,024 until the script came within 15% of its time limit). DISGD
# is cut to 18 micro-batches (4,608 of 8,958 events), past the drift at
# 3,293 and two LRU passes, so its backends still agree across the
# drift (each scan run ~10 s on the whole stream). DICS keeps the whole
# stream: its adaptive run must fire and recover. DISGD's and BPR-MF's
# ``host`` runs (~35 s of the script's time limit) were cut when the MoE
# phases came. DICS's host loop runs under both policies on the first
# DRIFT_HOST_CUT events (cut from the whole stream, ~23 s, when the
# sharded training and dry-run phases came), held to ``scan`` on the same
# events: past the drift, so the fixed cadence forgets twice and the
# adaptive detector fires and its controller forgets. BPR-MF's fixed
# policy runs on its first DRIFT_POLICY_CUT events (cut then from 512,
# ~7.5 s).
DRIFT_SMALL_EVENTS = 32_768
DRIFT_SMALL_CUT = {"bpr": 512, "disgd": 4608}
DRIFT_POLICY_CUT = {("bpr", "fixed"): 256}
DRIFT_HOST_CUT = {"dics": 4608}


def _stream_counters(registry) -> dict:
    return {f: int(registry.counter(name).value)
            for f, name in STREAM_COUNTERS.items()}


def _telemetry_checks(np, res, phase) -> dict:
    """The run's telemetry vector as ints: its events equal
    ``events_processed``, its hits / evals the recall bits' mean."""
    from repro_torch.obs.telemetry import telemetry_ints

    tel = telemetry_ints(res.telemetry)
    bits = res.recall.bits()
    bits = bits[~np.isnan(bits)]
    if tel["events"] != res.events_processed or tel["evals"] != bits.size:
        fail(f"{phase}: telemetry events {tel['events']} / evals "
             f"{tel['evals']} differ from events_processed "
             f"{res.events_processed} / evaluated bits {bits.size}")
    if tel["hits"] != int(bits.sum()) or (
            tel["hits"] / tel["evals"] != res.recall.mean()):
        fail(f"{phase}: telemetry hits / evals {tel['hits']} / "
             f"{tel['evals']} differ from the recall bits' mean "
             f"{res.recall.mean()}")
    return tel


def _telemetry_cost(torch, rt, users, items, cfg):
    """``telemetry_cost``: the main path's first TELEMETRY_COST_BATCHES
    micro-batches with telemetry off and on, twice each, alternating
    (events/s of each run), then once each under ``torch.profiler``
    (device operations a step and card busy ms)."""
    n = TELEMETRY_COST_BATCHES * cfg.micro_batch
    u, i = users[:n], items[:n]
    cfgs = {"off": dataclasses.replace(cfg, telemetry=False), "on": cfg}
    rt.run_stream(u, i, cfg)                         # warm the allocator
    rates = {"off": [], "on": []}
    for name in ("off", "on", "on", "off"):
        res = rt.run_stream(u, i, cfgs[name])
        rates[name].append(res.throughput)
        del res
    steps = _steps(n, cfg)
    prof = {name: _profiled(torch, rt, u, i, c, steps)
            for name, c in cfgs.items()}
    emit("telemetry_cost", stream="synth_stream(MOVIELENS_25M, seed=0)",
         cut=f"first {TELEMETRY_COST_BATCHES} micro-batches", events=n,
         steps=steps, events_per_s=rates,
         wall_ms_per_step={k: 1e3 * n / statistics.mean(v) / steps
                           for k, v in rates.items()},
         device_ops_per_step={k: p["device_ops_per_step"]
                              for k, p in prof.items()},
         device_busy_ms_per_step={k: p["device_busy_ms"] / steps
                                  for k, p in prof.items()},
         profiled_wall_ms_per_step={k: p["wall_ms_per_step"]
                                    for k, p in prof.items()})


def _forgetting_bytes(states, policy) -> int:
    """Bytes one ``apply_forgetting`` pass must move: every table it
    writes read and written once (``gradual``: the factor vectors; an
    eviction pass: every table but the clock, which it only reads)."""
    from repro_torch.core import storage

    tabs = storage.table_arrays(states)
    if policy == "gradual":
        return 2 * sum(tabs[k].numel() * tabs[k].element_size()
                       for k in ("user_vecs", "item_vecs"))
    return sum((1 if k == "clock" else 2) * t.numel() * t.element_size()
               for k, t in tabs.items())


def _forgetting_phases(torch, np, rt, users, items, cfg, main, batches):
    """``forgetting_path``: the main path's deployment, whole stream, under
    each of the repo's presets; ``forgetting_serve``: K3 on the LRU run's
    final states against the plain path."""
    from repro_torch.core import forgetting, state as state_lib
    from repro_torch.kernels import ops

    n = int(users.size)
    steps = _steps(n, cfg)
    lru_states = None
    main_occ = main["occupancy"]["user_total"] + main["occupancy"][
        "item_total"]
    for name, preset in FORGETTING_PRESETS.items():
        fcfg = forgetting.ForgettingConfig(**preset)
        run_cfg = dataclasses.replace(cfg, forgetting=fcfg)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = rt.run_stream(users, items, run_cfg)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        phase = f"forgetting_path.{name}"
        _ingest_checks(res, n, steps, counts,
                       ("factor_update", "masked_scores"), phase)
        if res.forgets != res.events_processed // fcfg.trigger_every:
            fail(f"{phase}: forgets {res.forgets} != floor("
                 f"{res.events_processed} / {fcfg.trigger_every})")
        if peak - before > main["peak"] + 2**30:
            fail(f"{phase}: peak {peak - before} B over the main path's "
                 f"{main['peak']} B + 1 GiB")
        tel = _telemetry_checks(np, res, phase)
        occ = res.occupancy_summary()
        occ_total = occ["user_total"] + occ["item_total"]
        if name != "gradual" and not occ_total < main_occ:
            fail(f"{phase}: occupancy {occ_total} not below the main "
                 f"path's {main_occ}")
        if name != "gradual" and tel["evictions"] <= 0:
            fail(f"{phase}: no eviction counted")
        # One pass on a copy of the final states, with its trigger set:
        # the card time every step of this run paid.
        copy = state_lib.clone_state(res.final_states)
        gate = torch.ones((), dtype=torch.bool, device=DEVICE)
        pass_ms = _time_ms(torch, lambda: forgetting.apply_forgetting(
            copy, fcfg, gate=gate), reps=5)
        n_bytes = _forgetting_bytes(copy, name)
        del copy
        emit("forgetting_path", policy=name, config=preset,
             source="benchmarks/common.py:80-81 (lru, lfu), "
                    "benchmarks/bench_forgetting.py:18 (gradual)",
             stream="synth_stream(MOVIELENS_25M, seed=0)", events=n,
             cut=None, steps=steps, wall_s=res.wall_seconds,
             events_per_s=res.throughput,
             main_path_events_per_s=main["events_per_s"],
             recall_at_10=res.recall.mean(),
             main_path_recall_at_10=main["recall"],
             events_processed=res.events_processed, dropped=res.dropped,
             forgets=res.forgets, occupancy=occ,
             main_path_occupancy=main["occupancy"],
             telemetry_evictions=tel["evictions"], telemetry=tel,
             memory_allocated_before=before, max_memory_allocated=peak,
             main_path_max_memory_allocated=main["peak"],
             pass_ms=pass_ms, pass_bytes=n_bytes,
             pass_bound_ms=_bound_ms(n_bytes, 0)[0], launches=counts)
        if name == "lru":
            lru_states = res.final_states
        del res
        torch.cuda.empty_cache()
        if name == "lru":
            # Where the time goes with a pass every step.
            _profile_steps(torch, rt, users, items, run_cfg,
                           steps=PROFILE_STEPS, phase="forgetting_profile",
                           policy=name)

    # -- forgetting_serve ------------------------------------------------------
    kw = serve_kw(cfg)
    live = set()
    ids_all = lru_states.tables.item_ids
    for w in range(ids_all.shape[0]):
        live |= set(ids_all[w][ids_all[w] >= 0].tolist())
    empty_slots = int((ids_all < 0).sum())
    lat, outs, counts = serve_calls(torch, rt, lru_states, kw, batches)
    if counts["fused_topn"] != len(batches):
        fail(f"forgetting_serve: fused_topn launched {counts['fused_topn']} "
             f"times for {len(batches)} serve calls")
    listed = 0
    for q, out in zip(batches, outs):
        plain = rt.grid_topn(lru_states, q, use_kernel=False, **kw)
        for a, b, what in zip(out, plain, ("ids", "scores", "known",
                                           "served")):
            if not torch.equal(a, b):
                fail(f"forgetting_serve: {what} differ from the plain path")
        ids = out[0][out[0] >= 0].tolist()
        listed += len(ids)
        if not set(ids) <= live:
            fail("forgetting_serve: an id on an empty slot was served")
        if not torch.equal(out[0] < 0, torch.isneginf(out[1])):
            fail("forgetting_serve: a -1 id with a finite score")
    emit("forgetting_serve", policy="lru", queries=SERVE_USERS,
         batch=SERVE_BATCH, empty_item_slots=empty_slots, listed=listed,
         known=sum(int(o[2].sum()) for o in outs),
         p50_ms=1e3 * statistics.median(lat), tolerance="exact",
         launches=counts)
    del lru_states, outs


def _drift_cfgs(base):
    """The three drift policies on ``base``: none, bench_drift's fixed
    LRU cadence (benchmarks/bench_drift.py:56-57), adaptive."""
    from repro_torch.core import forgetting
    from repro_torch.drift import DriftPolicy

    return {"none": base,
            "fixed": dataclasses.replace(base, forgetting=(
                forgetting.ForgettingConfig(policy="lru", trigger_every=2048,
                                            lru_max_age=512))),
            "adaptive": dataclasses.replace(base, drift=DriftPolicy())}


def _drift_phases(torch, np, rt) -> dict:
    """``drift_path`` on the DICS deployment and ``drift_backends_agree``
    on bench_drift's small configuration. Returns the latter's ``scan``
    runs by ``"algorithm.policy"`` (``grid_agree`` holds the grid to
    them)."""
    from repro_torch.data.stream import NETFLIX
    from repro_torch.drift import make_scenario, recovery_report
    from repro_torch.kernels import ops

    # -- drift_path -------------------------------------------------------------
    t0 = time.perf_counter()
    sc = make_scenario("abrupt", events=DRIFT_EVENTS, seed=0,
                       profile=dataclasses.replace(NETFLIX, item_zipf=1.3),
                       at=DRIFT_AT)
    gen_s = time.perf_counter() - t0
    d = sc.drift_events[0]
    cfg = dics_config(rt)
    steps = _steps(sc.n, cfg)
    reports = {}
    for name, run_cfg in _drift_cfgs(cfg).items():
        ops.reset_launch_counts()
        res = rt.run_stream(sc.users, sc.items, run_cfg)
        counts = ops.launch_counts()
        phase = f"drift_path.{name}"
        _ingest_checks(res, sc.n, steps, counts, ("dics_update",), phase)
        rep = recovery_report(res.recall.bits(), d)
        fires = (int(res.drift_flags.sum()) if res.drift_flags is not None
                 else 0)
        reports[name] = rep
        emit("drift_path", policy=name,
             stream=f"make_scenario('abrupt', events={DRIFT_EVENTS}, "
                    f"seed=0, profile=replace(NETFLIX, item_zipf=1.3), "
                    f"at={DRIFT_AT})",
             events=sc.n, drift_event=d, generate_s=round(gen_s, 3),
             cut=f"{DRIFT_EVENTS} raw events (the run's time limit)",
             steps=steps, wall_s=res.wall_seconds,
             events_per_s=res.throughput, recall_at_10=res.recall.mean(),
             dropped=res.dropped, fires=fires, forgets=res.forgets,
             recovery=dataclasses.asdict(rep),
             recovery_or_censored=rep.recovery_or_censored,
             telemetry_evictions=int(res.telemetry.evictions),
             launches=counts)
        del res
    torch.cuda.empty_cache()

    # -- drift_backends_agree ------------------------------------------------------
    sc = make_scenario("abrupt", events=DRIFT_SMALL_EVENTS, seed=0, at=0.3)
    d = sc.drift_events[0]
    rows, scans = {}, {}
    for algo in ("disgd", "bpr", "dics"):
        hyper = rt.get_algorithm(algo).default_hyper()._replace(
            u_cap=256, i_cap=64)
        base = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2),
                               micro_batch=256, hyper=hyper, backend="cuda",
                               device=DEVICE)
        for policy, run_cfg in _drift_cfgs(base).items():
            if policy == "none":
                continue
            cut = DRIFT_POLICY_CUT.get((algo, policy),
                                       DRIFT_SMALL_CUT.get(algo, sc.n))
            runs, scans[f"{algo}.{policy}"] = _drift_agree(
                np, rt, sc.users[:cut], sc.items[:cut], d, run_cfg,
                f"drift_backends_agree.{algo}.{policy}")
            rows[f"{algo}.{policy}"] = dict(events=min(cut, sc.n), **runs)
            if algo not in DRIFT_HOST_CUT:
                continue
            cut = DRIFT_HOST_CUT[algo]
            what = f"drift_backends_agree.{algo}.{policy}.host"
            runs, _ = _drift_agree(np, rt, sc.users[:cut], sc.items[:cut],
                                   d, run_cfg, what,
                                   backends=("scan", "host"))
            if runs["host"]["forgets"] < 1:
                fail(f"{what}: no forgetting pass ran")
            if policy == "adaptive" and runs["host"]["fires"] < 1:
                fail(f"{what}: the detector never fired")
            rows[f"{algo}.{policy}.host"] = dict(events=min(cut, sc.n),
                                                 **runs)
    for what in ("cuda", "scan"):
        fixed, adaptive = (rows[f"dics.{p}"][what] for p in ("fixed",
                                                             "adaptive"))
        if adaptive["fires"] < 1:
            fail(f"drift_backends_agree: DICS adaptive on {what} never fired")
        if not adaptive["recovery_or_censored"] < fixed[
                "recovery_or_censored"]:
            fail(f"drift_backends_agree: DICS adaptive recovery on {what} "
                 f"({adaptive['recovery_or_censored']}) does not beat the "
                 f"fixed cadence's ({fixed['recovery_or_censored']})")
    emit("drift_backends_agree",
         stream=f"make_scenario('abrupt', events={DRIFT_SMALL_EVENTS}, "
                "seed=0, at=0.3)", events=sc.n, drift_event=d,
         cut={**{algo: f"first {n} events" for algo, n in
                 DRIFT_SMALL_CUT.items()},
              **{".".join(k): f"first {n} events" for k, n in
                 DRIFT_POLICY_CUT.items()},
              **{f"{algo}.host": f"first {n} events" for algo, n in
                 DRIFT_HOST_CUT.items()}},
         grid=[2, 2], u_cap=256, i_cap=64, micro_batch=256,
         rtol=STREAM_RTOL, atol=STREAM_ATOL, runs=rows)
    return scans


def _drift_agree(np, rt, users, items, d, cfg, what,
                 backends=("cuda", "scan", "cpu")):
    """One policy of one algorithm on ``backends``: ``cuda``, ``scan``
    and ``host`` on the card, ``cpu`` (``cuda`` on CPU tensors). ``host``
    = ``scan`` (the same eager worker): flags, forgets, evaluated recall
    bits, every state array and the telemetry vector exactly. The card's
    ``cuda`` = ``cuda`` on CPU tensors (the plain versions the CPU tests
    hold to JAX): flags, forgets, recall bits, integers and the telemetry
    vector exactly, floats within STREAM_RTOL / STREAM_ATOL. ``cuda``
    against ``scan`` under the fixed cadence, whose passes do not read
    the recall bits: forgets, integers and the telemetry vector but its
    hits exactly, floats within the tolerance (the cuda worker scores at
    bucket start, the scan worker live: their recall bits, and so an
    adaptive run's flags, differ by design in both packages). Each pair
    of ``backends`` so named is compared. Returns the summary and the
    ``scan`` run."""
    from repro_torch.core import convert
    from repro_torch.drift import recovery_report
    from repro_torch.obs.telemetry import telemetry_ints

    kws = {"cuda": {}, "scan": dict(backend="scan"),
           "host": dict(backend="host"), "cpu": dict(device="cpu")}
    runs = {name: rt.run_stream(users, items,
                                dataclasses.replace(cfg, **kws[name]))
            for name in backends}
    st = {k: convert.states_to_numpy(r.final_states) for k, r in runs.items()}
    tel = {k: telemetry_ints(r.telemetry) for k, r in runs.items()}
    flags = {k: (r.drift_flags if r.drift_flags is not None
                 else np.zeros(0, np.int32)) for k, r in runs.items()}
    adaptive = cfg.drift is not None
    pairs = [("host", "scan", True), ("cuda", "cpu", True)]
    if not adaptive:
        pairs.append(("cuda", "scan", False))
    for a, b, same_bits in pairs:
        if a not in runs or b not in runs:
            continue
        ra, rb = runs[a], runs[b]
        if (ra.events_processed, ra.dropped, ra.forgets) != (
                rb.events_processed, rb.dropped, rb.forgets):
            fail(f"{what}: {a} and {b} processed / dropped / forgets differ")
        if ra.dropped:
            fail(f"{what}: {a} dropped {ra.dropped} events")
        if not np.array_equal(flags[a], flags[b]):
            fail(f"{what}: {a} and {b} drift flags differ")
        ta, tb = dict(tel[a]), dict(tel[b])
        if not same_bits:
            ta.pop("hits"), tb.pop("hits")
        if ta != tb:
            fail(f"{what}: {a} and {b} telemetry differs: {ta} / {tb}")
        exact_floats = a == "host"
        for name in st[a]:
            x, y = st[a][name], st[b][name]
            if x.dtype.kind != "f" or exact_floats:
                if not np.array_equal(x, y):
                    fail(f"{what}: {a} and {b}: {name} differs")
            elif not np.allclose(x, y, rtol=STREAM_RTOL, atol=STREAM_ATOL):
                fail(f"{what}: {a} and {b}: {name} beyond rtol="
                     f"{STREAM_RTOL} atol={STREAM_ATOL}")
        if same_bits:
            xb, yb = ra.recall.bits(), rb.recall.bits()
            if a == "host":
                xb, yb = xb[~np.isnan(xb)], yb[~np.isnan(yb)]
            if not np.array_equal(xb, yb, equal_nan=True):
                fail(f"{what}: {a} and {b} recall bits differ")
    out = {}
    for k, r in runs.items():
        rep = recovery_report(r.recall.bits(), d)
        out[k] = dict(wall_s=r.wall_seconds, recall=r.recall.mean(),
                      fires=int(flags[k].sum()), forgets=r.forgets,
                      recovery_events=rep.recovery_events,
                      recovery_or_censored=rep.recovery_or_censored,
                      evictions=tel[k]["evictions"])
    return out, runs["scan"]


def _dics_phases(torch, np, rt, dev, infos, disgd_serve):
    """DICS trained over the first DICS_PATH_EVENTS events of the Netflix
    stream, served (dense and
    compressed: ``storage_serve``, with ``disgd_serve``, its DISGD half),
    its two kernels held against their plain versions, the session and
    ``dics_storage``. Returns the kernel rows."""
    from repro_torch.core import storage
    from repro_torch.data.stream import NETFLIX, synth_stream
    from repro_torch.kernels import ops

    # -- 6. dics_path ----------------------------------------------------------
    t0 = time.perf_counter()
    users, items, _ = synth_stream(NETFLIX, seed=0)
    gen_s = time.perf_counter() - t0
    stream_events = int(users.size)
    users, items = users[:DICS_PATH_EVENTS], items[:DICS_PATH_EVENTS]
    n = int(users.size)
    cfg = dics_config(rt)
    grid = cfg.grid
    steps = _steps(n, cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = rt.run_stream(users, items, cfg)
    path_counts = ops.launch_counts()
    if res.events_processed + res.dropped != n:
        fail(f"dics: events_processed {res.events_processed} + dropped "
             f"{res.dropped} != {n}")
    if path_counts["dics_update"] != steps:
        fail(f"dics_update launched {path_counts['dics_update']} times on "
             f"the DICS path, expected one per step ({steps})")
    states = res.final_states
    emit("dics_path", stream="synth_stream(NETFLIX, seed=0)", events=n,
         cut=f"first {n} of {stream_events} events (at ~102 ms a step the "
             "whole stream took ~70 s of the script's time limit)",
         generate_s=round(gen_s, 3), grid=[grid.n_i, grid.g],
         u_cap=DICS_U_CAP, i_cap=DICS_I_CAP, k_nn=K_NN,
         micro_batch=MICRO_BATCH, bucket_capacity=cfg.bucket_capacity,
         steps=steps, wall_s=res.wall_seconds,
         wall_ms_per_step=1e3 * res.wall_seconds / steps,
         events_per_s=res.throughput, recall_at_10=res.recall.mean(),
         events_processed=res.events_processed, dropped=res.dropped,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         rated_bytes=states.rated.numel(), co_bytes=4 * states.co.numel(),
         launches=path_counts)
    _profile_steps(torch, rt, users, items, cfg, steps=PROFILE_STEPS,
                   phase="dics_profile")

    # -- 7. dics_serve ----------------------------------------------------------
    kw = serve_kw(cfg)
    qcap = kw["qcap"]
    batches = serve_batches(torch, np, users, dev)
    lat, outs, serve_counts = serve_calls(torch, rt, states, kw, batches)
    if serve_counts["dics_topn"] != len(batches):
        fail(f"dics_topn launched {serve_counts['dics_topn']} times for "
             f"{len(batches)} serve calls")
    for q, out in zip(batches, outs):
        plain = rt.grid_topn(states, q, use_kernel=False, **kw)
        for a, b, what in zip(out, plain, ("ids", "scores", "known",
                                           "served")):
            if not torch.equal(a, b):
                fail(f"dics serve {what} differ from the plain path")
    served = sum(int(o[3].sum()) for o in outs)
    serve_p50 = 1e3 * statistics.median(lat)
    emit("dics_serve", queries=SERVE_USERS, batch=SERVE_BATCH, qcap=qcap,
         served=served, qps=served / sum(lat),
         p50_ms=serve_p50, max_ms=1e3 * max(lat),
         known=sum(int(o[2].sum()) for o in outs),
         listed=sum(int(torch.isfinite(o[1]).sum()) for o in outs),
         launches=serve_counts)

    # -- 7a. storage_serve: K3 (DISGD, above) and K5 on compressed states ----------
    comp = rt.StoragePolicy.compressed()
    comp_states = storage.encode_state(states, comp)
    c_lat, c_outs, c_counts = serve_calls(torch, rt, comp_states,
                                          dict(kw, storage=comp), batches)
    if c_counts["dics_topn"] != len(batches):
        fail(f"storage_serve: dics_topn launched {c_counts['dics_topn']} "
             f"times for {len(batches)} calls")
    for out, want in zip(c_outs, outs):
        if not all(torch.equal(a, b) for a, b in zip(out, want)):
            fail("storage_serve: DICS answers on compressed states differ "
                 "from the dense states' (ids or score bits)")
    emit("storage_serve", policy=comp.describe(), queries=SERVE_USERS,
         batch=SERVE_BATCH, disgd=disgd_serve,
         dics=dict(p50_ms=1e3 * statistics.median(c_lat),
                   dics_serve_p50_ms=serve_p50, calls=len(batches),
                   answers_equal=True, launches=c_counts,
                   resident_bytes=storage.total_nbytes(comp_states),
                   dense_resident_bytes=storage.total_nbytes(states)))
    del comp_states, c_outs

    # -- 8. kernels against their plain versions ---------------------------------
    rows = _dics_kernel_checks(torch, np, users, items, states, cfg,
                               batches[0], path_counts, serve_counts, infos)
    del states, outs, batches
    torch.cuda.empty_cache()

    # -- 8a. dics_session ----------------------------------------------------------
    plain = _dics_session(torch, np, rt, users, items, cfg, res, serve_p50)
    del res

    # -- 8b. dics_storage: the session's cut under compressed() ------------------------
    m = DICS_SESSION_BATCHES * MICRO_BATCH
    c_cfg = dataclasses.replace(cfg, storage=comp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = rt.run_stream(users[:m], items[:m], c_cfg)
    counts = ops.launch_counts()
    _ingest_checks(res, m, _steps(m, cfg), counts, ("dics_update",),
                   "dics_storage")
    if not (_decoded_equal(torch, res.final_states, comp, plain.final_states)
            and _bits_equal(np, res, plain)):
        fail("dics_storage: decoded states or recall bits differ from the "
             "default policy's run over the same batches")
    emit("dics_storage", stream="synth_stream(NETFLIX, seed=0)", events=m,
         cut=f"first {DICS_SESSION_BATCHES} micro-batches, as dics_session",
         policy=comp.describe(), events_per_s=res.throughput,
         default_events_per_s=plain.throughput,
         recall_at_10=res.recall.mean(), dropped=res.dropped,
         resident_bytes=storage.total_nbytes(res.final_states),
         default_resident_bytes=storage.total_nbytes(plain.final_states),
         tables=storage.state_nbytes(res.final_states),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=counts)
    del res, plain
    torch.cuda.empty_cache()

    # -- 9. backends agree on the card -------------------------------------------
    _dics_backends_agree(torch, np, rt)
    return rows


def _dics_touched_bytes(np, uid, iid, rows, ev_u, ev_i, u_slot, i_slot,
                        u_cap, i_cap):
    """Bytes dics_update must move for this batch: the event inputs read
    once; every rated row read once; every co entry and cnt it adds to read
    and written once; the clears written once (rated row I bytes, rated
    column U bytes, co row and column); the bookkeeping. Replays the slot
    tenancy and the histories event by event from the batch-start rows."""
    ev_u, ev_i, u_slot, i_slot = (x.cpu().numpy() for x in
                                  (ev_u, ev_i, u_slot, i_slot))
    uid, iid, rows = uid.cpu().numpy(), iid.cpu().numpy(), rows.cpu().numpy()
    n_w, n_ev = ev_u.shape
    total = 16 * n_w * n_ev
    for w in range(n_w):
        u_ten, i_ten, hist = {}, {}, {}
        co_cells, cnt_cells, rows_read = set(), set(), set()
        for e in range(n_ev):
            us, is_ = int(u_slot[w, e]), int(i_slot[w, e])
            new_u = u_ten.get(us, uid[w, us]) != ev_u[w, e]
            new_i = i_ten.get(is_, iid[w, is_]) != ev_i[w, e]
            if us not in hist:
                hist[us] = set(np.flatnonzero(rows[w, e]).tolist())
            if new_u:
                hist[us] = set()
                total += i_cap
            if new_i:
                for h in hist.values():
                    h.discard(is_)
                total += u_cap + 8 * i_cap + 4
            if ev_u[w, e] < 0:
                continue
            u_ten[us], i_ten[is_] = ev_u[w, e], ev_i[w, e]
            if us not in rows_read:
                rows_read.add(us)
                total += i_cap
            for q in hist[us]:
                co_cells.add((is_, q))
                co_cells.add((q, is_))
            cnt_cells.add(is_)
            hist[us].add(is_)
            total += 2 * 6 * 4 + 1                    # tables, rated[u, i]
        total += 8 * (len(co_cells) + len(cnt_cells))
    return total


def _dics_kernel_checks(torch, np, users, items, states, cfg, serve_q,
                        path_counts, serve_counts, infos):
    from repro_torch.core import dics, state as state_lib
    from repro_torch.kernels import ops, ref

    hyper = cfg.resolved_hyper()
    rng = np.random.default_rng(1)
    ev_u, ev_i = _middle_batch(torch, np, users, items, cfg, rng)
    n_w, cap = ev_u.shape
    t = states.tables
    u_slot = state_lib.slot_of(ev_u, hyper.g, hyper.u_cap)
    i_slot = state_lib.slot_of(ev_i, hyper.n_i, hyper.i_cap)
    events = (ev_u, ev_i, u_slot, i_slot)
    w = torch.arange(n_w, device=ev_u.device)[:, None]
    rows_at_start = states.rated[w, u_slot.long()]
    rows = []

    # K4 dics_update on clones of the trained state.
    n_bytes = _dics_touched_bytes(np, t.user_ids, t.item_ids, rows_at_start,
                                  ev_u, ev_i, u_slot, i_slot, hyper.u_cap,
                                  hyper.i_cap)
    del rows_at_start
    nf_u, nf_i = _middle_batch(torch, np, users, items, cfg,
                               np.random.default_rng(1), fresh_rate=0.0)
    cases = {"fresh": events,
             "no_fresh": (nf_u, nf_i,
                          state_lib.slot_of(nf_u, hyper.g, hyper.u_cap),
                          state_lib.slot_of(nf_i, hyper.n_i, hyper.i_cap))}
    k4 = {}
    for case, case_events in cases.items():
        work = {}

        def run(fn, name):
            s = work[name]
            fn(s.co, s.item_cnt, s.rated, tuple(s.tables), case_events)

        results = {}
        for name, fn in (("kernel", ops.dics_update),
                         ("plain", ref.dics_apply)):
            work[name] = state_lib.clone_state(states)
            run(fn, name)
            torch.cuda.synchronize()
            results[name] = work.pop(name)
        got, want = results["kernel"], results["plain"]
        for a, b, what in zip(got, want, type(got)._fields):
            if a is None and b is None:     # co_scale: compute form
                continue
            pairs = zip(a, b) if what == "tables" else [(a, b)]
            if not all(torch.equal(x, y) for x, y in pairs):
                fail(f"dics_update ({case}): {what} differs from the plain "
                     "version")
        del got, want, results

        def fresh(name):
            def setup():
                work[name] = state_lib.clone_state(states)
            return setup

        ms = _time_ms(torch, lambda: run(ops.dics_update, "kernel"), reps=5,
                      setup=fresh("kernel"))
        device_ms = _time_ms(torch, lambda: run(ops.dics_update, "kernel"),
                             reps=5, setup=fresh("kernel"), cover_enqueue=True)
        plain_ms = None
        if case == "fresh":
            plain_ms = _time_ms(torch, lambda: run(ref.dics_apply, "plain"),
                                reps=2, setup=fresh("plain"))
        work.clear()
        k4[case] = (ms, plain_ms, device_ms)
    evicted = int(((t.item_ids.gather(1, i_slot.long()) != ev_i)
                   & (t.item_ids.gather(1, i_slot.long()) >= 0)).sum())
    ms, plain_ms, device_ms = k4["fresh"]
    n_valid = int((ev_u >= 0).sum())
    bound, by = _bound_ms(n_bytes, 2 * hyper.i_cap * n_valid)
    rows.append(dict(
        name="dics_update", route="cuda", matched=True,
        source="src/repro_torch/kernels/csrc/dics_update.cu",
        replaces="src/repro/kernels/dics_update.py:33",
        launches=path_counts["dics_update"], max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        library="none: no single PyTorch call applies a sequential chain "
                "of evicting co-count updates",
        ms_no_fresh=k4["no_fresh"][0],
        device_ms=device_ms, device_ms_no_fresh=k4["no_fresh"][2],
        **_staged_layout("dics_update", cap, hyper.i_cap,
                         infos["dics_update"].ptxas, "dics_update_kernel"),
        shape=f"W={n_w} E={cap} U={hyper.u_cap} I={hyper.i_cap}",
        valid_events=n_valid, evicting_events=evicted, bytes=n_bytes))

    # The bucket-start scoring of the same micro-batch (PyTorch, not a
    # kernel): its share of a DICS step.
    score_ms = _time_ms(torch, lambda: dics.bucket_start_scores(
        states, ev_u, hyper), reps=5)

    # K5 dics_topn on the inputs of one serve call.
    args, kw = dics_topn_inputs(torch, states, cfg, serve_q)
    hist, known = args[2], args[3]
    got_ids, got_sc = ops.dics_topn(*args, **kw)
    want_ids, want_sc = ref.dics_topn(*args, **kw)
    if not (torch.equal(got_ids, want_ids) and torch.equal(got_sc, want_sc)):
        bad = int((got_ids != want_ids).sum() + (got_sc != want_sc).sum())
        fail(f"dics_topn: {bad} entries differ from the plain version")
    ms = _time_ms(torch, lambda: ops.dics_topn(*args, **kw))
    device_ms = _time_ms(torch, lambda: ops.dics_topn(*args, **kw),
                         cover_enqueue=True)
    plain_ms = _time_ms(torch, lambda: ref.dics_topn(*args, **kw), reps=5)
    k5_ptxas = _registers_only(infos["dics_topn"].ptxas, "dics_topn",
                               hyper.k_nn)
    b, i = hist.shape[1], hist.shape[2]
    h_len = hist.sum(-1)                                    # [W, B]
    cols = hist.any(1).sum(-1)                              # [W] distinct q
    cand = ((t.item_ids >= 0)[:, None, :] & ~hist).sum(-1)  # [W, B]
    k5_bytes = (n_w * b * i + n_w * b + 4 * int(cols.sum()) * i
                + 8 * n_w * i + 8 * n_w * b * hyper.top_n)
    k5_ops = 4 * int((cand * h_len).sum())   # mul, sqrt, divide, compare
    bound, by = _bound_ms(k5_bytes, k5_ops)
    rows.append(dict(
        name="dics_topn", route="cuda", matched=True,
        source="src/repro_torch/kernels/csrc/dics_topn.cu",
        replaces="src/repro/kernels/topn.py:144",
        launches=serve_counts["dics_topn"], max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        device_ms=device_ms,
        library="none: no single PyTorch call computes the Eq. 7 "
                "neighbour mass and a top-N",
        ptxas=k5_ptxas,
        shape=f"W={n_w} B={b} I={i} k_nn={hyper.k_nn} N={hyper.top_n}",
        mean_history=float(h_len[known].float().mean()),
        max_history=int(h_len.max())))
    emit("dics_kernels_vs_plain", matched=[r["name"] for r in rows],
         tolerance="exact", bucket_start_scores_ms=score_ms,
         bucket_start_shape=f"W={n_w} E={cap} I={hyper.i_cap} "
                            f"k_nn={hyper.k_nn}")
    return rows


def _dics_backends_agree(torch, np, rt):
    from repro_torch.core import convert
    from repro_torch.data.stream import NETFLIX, scaled, synth_stream

    users, items, _ = synth_stream(scaled(NETFLIX, 0.0015, n_items=128),
                                   seed=0)
    # 64 items per split over 32 slots: item slots collide.
    hyper = rt.DicsHyper(u_cap=128, i_cap=32)
    cfg = rt.StreamConfig(algorithm="dics", grid=rt.GridSpec(2),
                          micro_batch=256, hyper=hyper, backend="cuda",
                          device=DEVICE)
    a = rt.run_stream(users, items, cfg)
    b = rt.run_stream(users, items, dataclasses.replace(cfg, backend="scan"))
    # The same kernel worker on CPU tensors (the plain versions), which the
    # CPU tests hold to the JAX package bit for bit: the card's bucket-start
    # scoring and hit bits must equal it.
    c = rt.run_stream(users, items, dataclasses.replace(cfg, device="cpu"))
    h = _host_agrees(np, rt, users, items, cfg, b, "dics")
    for r, what in ((b, "scan"), (c, "cpu")):
        if (a.events_processed, a.dropped) != (r.events_processed, r.dropped):
            fail(f"dics: cuda and {what} processed / dropped different counts")
    sa, sb, sc = (convert.states_to_numpy(r.final_states) for r in (a, b, c))
    for name in sa:
        if not np.array_equal(sa[name], sb[name]):
            fail(f"dics backends: {name} differs")
        if not np.array_equal(sa[name], sc[name]):
            fail(f"dics cuda on the card and on the cpu: {name} differs")
    if not np.array_equal(a.recall.bits(), c.recall.bits(), equal_nan=True):
        fail("dics cuda on the card and on the cpu: recall bits differ")
    emit("dics_backends_agree",
         stream="synth_stream(scaled(NETFLIX, 0.0015, n_items=128))",
         events=int(users.size), u_cap=hyper.u_cap, i_cap=hyper.i_cap,
         tolerance="exact", cuda_wall_s=a.wall_seconds,
         scan_wall_s=b.wall_seconds, cpu_wall_s=c.wall_seconds,
         host_wall_s=h.wall_seconds, host_equals_scan=True,
         recall_bits_equal_cpu=True, recall_cuda=a.recall.mean(),
         recall_scan=b.recall.mean(), recall_cpu=c.recall.mean())


def _logits_agree(np, got, want, what):
    """tests/test_decode.py's contract on [B, 1, V] logits: values within
    LOGIT_TOL of the scale, greedy tokens equal away from near-ties."""
    got, want = (x.float().cpu().numpy() for x in (got, want))
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        fail(f"{what}: logits not finite")
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max()) / scale
    if not np.allclose(got / scale, want / scale, atol=LOGIT_TOL,
                       rtol=LOGIT_TOL):
        fail(f"{what}: scaled logit error {err} beyond {LOGIT_TOL}")
    disagree = got.argmax(-1) != want.argmax(-1)
    top2 = np.sort(want, axis=-1)
    gap = (top2[..., -1] - top2[..., -2]) / scale
    if np.any(disagree & (gap >= LOGIT_GAP)):
        fail(f"{what}: greedy tokens differ on confident logits")
    return err, int(disagree.sum())


def _window_pairs(np, s, window, causal):
    """(query, key) pairs the attention mask keeps for one head."""
    r = np.arange(s, dtype=np.int64)
    hi = r if causal else np.full(s, s - 1)
    lo = np.zeros(s, np.int64) if window is None else np.maximum(
        0, r - window + 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


# -- the ensemble, service and autoscaler runtime ----------------------------

# ensemble_path: every registered algorithm on the DICS deployment, on
# drift_path's profile and size under the recurring scenario, ingested
# in 4 segments (bench_ensemble's 32, benchmarks/bench_ensemble.py:40-46;
# 16 until the script came within 15% of its time limit, 8 until the LLM
# families' phases came: every ingest call runs the 8-step drain tail,
# so the calls set the phase's time), windowed recall over its 400-event
# window, served in 8 blend and 8 switch calls of SERVE_BATCH users;
# checkpointed after segment 2.
# ensemble_bar keeps bench_ensemble's 32 segments.
ENSEMBLE_EVENTS = 131_072
ENSEMBLE_SEGMENTS = 32
ENSEMBLE_PATH_SEGMENTS, ENSEMBLE_CHECKPOINT_AT = 4, 2
ENSEMBLE_WINDOW, ENSEMBLE_MARGIN = 400, 0.01
ENSEMBLE_SERVE_CALLS = 8
# ensemble_bar: bench_ensemble.smoke_rows's configuration.
ENSEMBLE_BAR_EVENTS, ENSEMBLE_BAR_MEMBERS = 8192, ("dics", "disgd")
ENSEMBLE_DIR = ROOT / "build" / "chip_smoke_ensemble"
# service_path: the DISGD deployment's first 16 micro-batches interleaved
# with 16 query batches (64 until the script came within 15% of its time
# limit, 32 until the LLM families' phases came: each ingest call of one
# micro-batch runs the 8-step drain tail), then the next 128 threaded
# under Poisson load.
SERVICE_INTERLEAVED_BATCHES, SERVICE_THREADED_BATCHES = 16, 128
SERVICE_QUERY_BATCH = 64
# autoscale_path: the MovieLens-25M deployment from a 2 x 2 grid with
# tests/test_storage.py's undersizing (_overloaded_run), its first 64
# micro-batches in 16 ingest calls.
AUTOSCALE_BATCHES, AUTOSCALE_CALLS, AUTOSCALE_MAX = 64, 16, 16
DRIVERS_DIR = ROOT / "build" / "chip_smoke_drivers"
# grid_path: the first events of the DISGD stream (2 micro-batches and
# the 8 of the drain tail). The eager worker runs every event of a bucket
# as its own few dozen launches, and 16 ranks share the card and the
# host's cores: 32,768 events took 69 s with start-up; 16,384, then 8,192
# once grid_session ran in the same group, then 4,096 (2 micro-batches)
# once the script came within 15% of its time limit.
GRID_EVENTS = 4_096
# ... and the 16-rank group's re-queue buffer: one bucket, so each run
# drains in one step instead of micro_batch / bucket_capacity = 8 (the
# eager worker walks every slot of a bucket, full or empty, at ~2 s a
# step on 16 ranks). No bucket of these micro-batches overflows (at most
# 149 events of 256), so nothing is carried or dropped either way.
GRID_CARRY_SLOTS = 256
# Seconds each group of ranks may take, start-up included.
GRID_TIMEOUT = 420.0
# grid_nccl: the first events of grid_agree's stream on one worker (a
# bucket of 512 events a step; the LRU pass runs gated, without firing).
GRID_NCCL_EVENTS = 1024
# grid_session: the first events of the DISGD stream through a session
# on the 16 ranks (2 micro-batches and the drain tail, publishing every
# 2; 4 micro-batches until the script came within 15% of its time
# limit), and its queries: trained users, then ids no worker knows.
GRID_SESSION_EVENTS, GRID_SESSION_EVERY = 4096, 2
GRID_SESSION_USERS, GRID_SESSION_UNKNOWN = 1024, 256
# ... and the grid it is then rescaled to live, and back.
GRID_SESSION_RESCALE = (2, 4)
# grid_elastic: the first events of grid_agree's stream through a DISGD
# and a DICS session on its small configuration.
GRID_ELASTIC_EVENTS = 2048
GRID_ELASTIC_DIR = ROOT / "build" / "chip_smoke_grid_elastic"
# grid_async: grid_session's session again under an async policy, through
# run_service(mode="threaded"): closed-loop query batches of this many ids
# during the ingest, at least GRID_ASYNC_BATCHES of them.
GRID_ASYNC_BATCHES, GRID_ASYNC_QUERY_BATCH = 8, 64
# grid_service: interleaved run_service on grid_elastic's DISGD session
# (chunks of 512 events, this many query batches of 64 ids), the
# autoscaler from one worker (tests/test_torch_autoscaler.py's undersized
# grid: micro-batch 64, capacity factor 0.25, 8 carry slots) over this many
# ingest calls of 512 random events, and a DICS + DISGD ensemble over two
# segments of this many events.
GRID_SERVICE_BATCHES, GRID_AUTOSCALE_ROUNDS, GRID_ENSEMBLE_SEGMENT = 8, 6, 512
# grid_nccl's session: the first events of its stream, publishing every
# step, a reader's calls during the second of two ingests.
GRID_NCCL_SESSION_EVENTS, GRID_NCCL_READS = 512, 4


def ensemble_configs(rt):
    """``ensemble_path``'s members: every registered algorithm on the DICS
    deployment (``dics_config``'s grid, micro-batch and caps, k = 10 for
    the factor models), each with ``DriftPolicy()`` as
    ``bench_ensemble._cfg`` gives it."""
    from repro_torch.drift import DriftPolicy

    base = dataclasses.replace(dics_config(rt), drift=DriftPolicy())
    out = []
    for algo in rt.registered():
        hyper = (base.hyper if algo == base.algorithm else
                 rt.get_algorithm(algo).default_hyper()._replace(
                     k=10, top_n=10, u_cap=DICS_U_CAP, i_cap=DICS_I_CAP))
        out.append(dataclasses.replace(base, algorithm=algo, hyper=hyper))
    return out


def _segments(np, n: int, segments: int):
    """bench_ensemble._segment_bounds."""
    edges = np.linspace(0, n, segments + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _windowed(np, bits) -> float:
    """bench_ensemble._windowed: mean of the moving average."""
    from repro_torch.core.evaluator import moving_average

    return (float(moving_average(bits, ENSEMBLE_WINDOW).mean()) if bits.size
            else float("nan"))


def _ensemble_run(np, ens, users, items, bounds, phase, on_segment=None):
    """bench_ensemble._run's loop over ``ens``: per segment each member's
    recall bits (stream order, NaN kept), the blended and switched bits
    under the weights chosen before the segment, each member's (hits,
    evals), the drift flag and the post-update weights; the ingest wall."""
    names = list(ens.member_names)
    out = dict(bits={m: [] for m in names}, blend=[], switch=[],
               rewards=[], drift=[], trail=[], wall=0.0,
               fires={m: 0 for m in names})
    for k, (lo, hi) in enumerate(bounds):
        w_prev = ens.weights
        t0 = time.perf_counter()
        r = ens.ingest(users[lo:hi], items[lo:hi])
        out["wall"] += time.perf_counter() - t0
        seg = {}
        for m in names:
            res = r.members[m]
            if res.dropped:
                fail(f"{phase}: member {m} dropped {res.dropped} events in "
                     f"segment {k}")
            bits = res.recall.bits()
            out["bits"][m].append(bits)
            seg[m] = bits[~np.isnan(bits)]
            if res.drift_flags is not None:
                out["fires"][m] += int(np.sum(res.drift_flags))
        kk = min(len(seg[m]) for m in names)
        out["blend"].append(sum(w_prev[m] * seg[m][:kk] for m in names))
        best = max(names, key=lambda m: (w_prev[m], m))
        out["switch"].append(seg[best][:kk])
        out["rewards"].append(np.array(
            [[float(r.members[m].telemetry.hits),
              float(r.members[m].telemetry.evals)] for m in names]))
        out["drift"].append(bool(r.drift))
        out["trail"].append({m: round(r.weight(m), 6) for m in names})
        if on_segment is not None:
            on_segment(k + 1)
    return out


def _ensemble_summary(np, run) -> dict:
    names = list(run["bits"])
    singles = {m: _windowed(np, np.concatenate(
        [b[~np.isnan(b)] for b in run["bits"][m]])) for m in names}
    best = max(names, key=lambda m: singles[m])
    worst = min(names, key=lambda m: singles[m])
    return dict(recall_blend=_windowed(np, np.concatenate(run["blend"])),
                recall_switch=_windowed(np, np.concatenate(run["switch"])),
                best_single=best, best_single_recall=singles[best],
                worst_single=worst, worst_single_recall=singles[worst],
                singles=singles, drift_segments=int(sum(run["drift"])),
                fires=run["fires"])


def _weigher_replay(np, rewards, drifts, cfg):
    """``weigher_update`` replayed in float64 on the host from each
    segment's (hits, evals) and drift flag: the final weights."""
    m = rewards[0].shape[0]
    reward, mass, w = np.zeros(m), np.zeros(m), np.full(m, 1.0 / m)
    for rw, drift in zip(rewards, drifts):
        hits, evals = rw[:, 0], rw[:, 1]
        seen = evals > 0
        r = hits / np.maximum(evals, 1.0)
        reward = np.where(seen, cfg.decay * reward + (1 - cfg.decay) * r,
                          reward)
        mass = np.where(seen, cfg.decay * mass + (1 - cfg.decay), mass)
        if cfg.drift_reset and drift:
            k = cfg.drift_discount
            reward, mass = reward * k, mass * k
        x = cfg.eta * reward / np.maximum(mass, 1e-6)
        e = np.exp(x - x.max())
        w = (1 - cfg.gamma) * e / e.sum() + cfg.gamma / m
        if cfg.drift_reset and drift:
            w = np.full(m, 1.0 / m)
    return w


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def _ensemble_phases(torch, np, rt):
    """``ensemble_path``, ``ensemble_checkpoint`` and ``ensemble_bar``."""
    import shutil

    from repro_torch.data.stream import NETFLIX
    from repro_torch.drift import DriftPolicy, make_scenario
    from repro_torch.ensemble import fuse_topn, switch_choice
    from repro_torch.kernels import ops

    # -- ensemble_path -------------------------------------------------------
    phase = "ensemble_path"
    t0 = time.perf_counter()
    sc = make_scenario("recurring", events=ENSEMBLE_EVENTS, seed=0,
                       profile=dataclasses.replace(NETFLIX, item_zipf=1.3))
    gen_s = time.perf_counter() - t0
    cfgs = ensemble_configs(rt)
    bounds = _segments(np, sc.n, ENSEMBLE_PATH_SEGMENTS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ens = rt.EnsembleSession(cfgs)
    names = list(ens.member_names)
    if ENSEMBLE_DIR.is_dir():
        shutil.rmtree(ENSEMBLE_DIR)
    ckpt = {}

    def checkpoint_at(k):
        if k != ENSEMBLE_CHECKPOINT_AT:
            return
        torch.cuda.synchronize()
        tw = time.perf_counter()
        ens.checkpoint(str(ENSEMBLE_DIR))
        ckpt["write_s"] = time.perf_counter() - tw

    ops.reset_launch_counts()
    run = _ensemble_run(np, ens, sc.users, sc.items, bounds, phase,
                        on_segment=checkpoint_at)

    # Serving: 8 blend calls, then 8 switch calls on other users.
    rng = np.random.default_rng(0)
    pool = rng.choice(np.unique(sc.users),
                      2 * ENSEMBLE_SERVE_CALLS * SERVE_BATCH, replace=False)
    calls = pool.reshape(2 * ENSEMBLE_SERVE_CALLS, SERVE_BATCH)
    w = ens.weigher_state.weights.cpu().numpy().astype(np.float64)
    w_rows = np.broadcast_to(w[:, 0], (SERVE_BATCH, len(names)))
    lat = {"blend": [], "switch": []}
    fuse_ms = []
    for q in calls[:ENSEMBLE_SERVE_CALLS]:
        t0 = time.perf_counter()
        got = ens.recommend(q, mode="blend")
        lat["blend"].append(time.perf_counter() - t0)
        own = [ens.members[m].recommend(q) for m in names]
        t0 = time.perf_counter()
        ids, _, known = fuse_topn(
            [o.ids for o in own], [o.scores for o in own],
            [o.known for o in own], w_rows, top_n=own[0].ids.shape[1],
            method=ens.blend.method, rrf_k=ens.blend.rrf_k)
        fuse_ms.append((time.perf_counter() - t0) * 1e3)
        for row in np.flatnonzero(~known):
            ids[row] = own[switch_choice(w_rows[row], names)].ids[row]
        if not (np.array_equal(ids, got.ids)
                and np.array_equal(known, got.known)):
            fail(f"{phase}: blend answers differ from fuse_topn of the "
                 f"members' own answers")
    best = names[switch_choice(w[:, 0], names)]
    for q in calls[ENSEMBLE_SERVE_CALLS:]:
        t0 = time.perf_counter()
        got = ens.recommend(q, mode="switch")
        lat["switch"].append(time.perf_counter() - t0)
        own = ens.members[best].recommend(q)
        if not (np.array_equal(own.ids, got.ids)
                and np.array_equal(own.known, got.known)):
            fail(f"{phase}: switch answers differ from {best}'s own")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ("factor_update", "masked_scores", "fused_topn",
                 "dics_update", "dics_topn"):
        if counts[name] < 1:
            fail(f"{phase}: {name} never launched")

    # Each member against a standalone session fed the same segments.
    replay = _weigher_replay(np, run["rewards"], run["drift"],
                             ens.weigher_config)
    w_err = float(np.max(np.abs(replay - w[:, 0])))
    if w_err > 1e-6:
        fail(f"{phase}: weights {w[:, 0]} differ from the float64 replay "
             f"{replay} by {w_err}")
    standalone = {}
    for cfg in cfgs:
        m = cfg.algorithm
        solo = rt.StreamSession(cfg)
        wall, same_bits = 0.0, True
        for k, (lo, hi) in enumerate(bounds):
            t0 = time.perf_counter()
            res = solo.ingest(sc.users[lo:hi], sc.items[lo:hi])
            wall += time.perf_counter() - t0
            same_bits &= np.array_equal(res.recall.bits(),
                                        run["bits"][m][k], equal_nan=True)
        if not same_bits:
            fail(f"{phase}: member {m}'s recall bits differ from a "
                 f"standalone session's")
        if not _states_equal(torch, ens.members[m].states, solo.states):
            fail(f"{phase}: member {m}'s states differ from a standalone "
                 f"session's")
        standalone[m] = wall
        del solo
        torch.cuda.empty_cache()
    summary = _ensemble_summary(np, run)
    emit(phase, stream=f"make_scenario('recurring', events={ENSEMBLE_EVENTS}"
         f", seed=0, profile=replace(NETFLIX, item_zipf=1.3))",
         events=sc.n, generate_s=round(gen_s, 3), members=names,
         grid=[N_I, N_I], u_cap=DICS_U_CAP, i_cap=DICS_I_CAP,
         micro_batch=MICRO_BATCH, segments=len(bounds), cut=None,
         wall_s=run["wall"], events_per_s=sc.n / run["wall"],
         standalone_wall_s=standalone,
         overhead_x=run["wall"] / sum(standalone.values()),
         weights=dict(zip(names, w[:, 0].tolist())),
         weights_replay_max_err=w_err, weight_trail=run["trail"],
         resets=ens.exploration_resets, **summary,
         recommend_p50_ms={k: statistics.median(v) * 1e3
                           for k, v in lat.items()},
         fuse_topn_ms=statistics.median(fuse_ms), serve_batch=SERVE_BATCH,
         max_memory_allocated=peak, launches=counts)

    # -- ensemble_checkpoint -------------------------------------------------
    phase = "ensemble_checkpoint"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = rt.EnsembleSession.restore(str(ENSEMBLE_DIR), cfgs)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    rest = _ensemble_run(np, back, sc.users, sc.items,
                         bounds[ENSEMBLE_CHECKPOINT_AT:], phase)
    for a, b in zip(back.weigher_state, ens.weigher_state):
        if not torch.equal(a, b):
            fail(f"{phase}: the restored weigher differs after segment "
                 f"{len(bounds)}")
    for m in names:
        if not _states_equal(torch, back.members[m].states,
                             ens.members[m].states):
            fail(f"{phase}: member {m}'s states differ from the "
                 f"uninterrupted run's")
        for got, want in zip(rest["bits"][m],
                             run["bits"][m][ENSEMBLE_CHECKPOINT_AT:]):
            if not np.array_equal(got, want, equal_nan=True):
                fail(f"{phase}: member {m}'s recall bits differ from the "
                     f"uninterrupted run's")
    emit(phase, directory=str(ENSEMBLE_DIR.relative_to(ROOT)),
         at_segment=ENSEMBLE_CHECKPOINT_AT,
         file_bytes=_dir_bytes(ENSEMBLE_DIR),
         json_bytes=(ENSEMBLE_DIR / "ensemble.json").stat().st_size,
         write_s=ckpt["write_s"], restore_s=restore_s,
         resumed_wall_s=rest["wall"], weights_equal=True,
         states_equal=True, bits_equal=True)
    del ens, back, run, rest
    torch.cuda.empty_cache()

    # -- ensemble_bar --------------------------------------------------------
    phase = "ensemble_bar"
    sc = make_scenario("recurring", events=ENSEMBLE_BAR_EVENTS, seed=0)
    bar_cfgs = []
    for algo in ENSEMBLE_BAR_MEMBERS:
        hyper = rt.get_algorithm(algo).default_hyper()._replace(u_cap=256,
                                                                 i_cap=64)
        bar_cfgs.append(rt.StreamConfig(
            algorithm=algo, grid=rt.GridSpec(2), micro_batch=256,
            hyper=hyper, backend="scan", device=DEVICE,
            drift=DriftPolicy()))
    ens = rt.EnsembleSession(bar_cfgs)
    run = _ensemble_run(np, ens, sc.users, sc.items,
                        _segments(np, sc.n, ENSEMBLE_SEGMENTS), phase)
    summary = _ensemble_summary(np, run)
    margin = summary["recall_blend"] - summary["best_single_recall"]
    emit(phase, stream=f"make_scenario('recurring', "
         f"events={ENSEMBLE_BAR_EVENTS}, seed=0)", events=sc.n,
         members=list(ens.member_names), grid=[2, 2], u_cap=256, i_cap=64,
         micro_batch=256, backend="scan", segments=ENSEMBLE_SEGMENTS,
         **summary, margin_vs_best=margin, bar=-ENSEMBLE_MARGIN,
         resets=ens.exploration_resets,
         events_per_s=sc.n / run["wall"],
         final_weights=ens.weights)
    if margin < -ENSEMBLE_MARGIN:
        fail(f"{phase}: blended windowed recall {summary['recall_blend']} "
             f"falls more than {ENSEMBLE_MARGIN} below the best single "
             f"member's ({summary['best_single_recall']})")
    if ens.exploration_resets < 1:
        fail(f"{phase}: no drift flag re-opened exploration")


def _service_phases(torch, np, rt, users, items):
    """``service_path``: ``run_service`` interleaved, then threaded, on the
    DISGD deployment, each against a twin fed the same events without
    queries."""
    from repro_torch.kernels import ops
    from repro_torch.serve.loadgen import LoadConfig
    from repro_torch.serve.service import ServiceConfig, run_service

    phase = "service_path"
    cfg = disgd_config(rt)
    mb = cfg.micro_batch
    policy = rt.PublishPolicy(every=1, mode="async")
    n1 = SERVICE_INTERLEAVED_BATCHES * mb
    n2 = SERVICE_THREADED_BATCHES * mb
    u1, i1 = users[:n1], items[:n1]
    u2, i2 = users[n1:n1 + n2], items[n1:n1 + n2]
    load = LoadConfig(n_users=int(users.max()) + 1, seed=1,
                      query_batch=SERVICE_QUERY_BATCH, zipf_a=1.1,
                      unknown_frac=0.05)
    torch.cuda.reset_peak_memory_stats()
    session = rt.StreamSession(cfg, publish=policy)
    ops.reset_launch_counts()
    rep = run_service(session, u1, i1, load, ServiceConfig(
        mode="interleaved", events_per_chunk=mb,
        query_batches=SERVICE_INTERLEAVED_BATCHES))
    counts = ops.launch_counts()
    twin = rt.StreamSession(cfg, publish=policy)
    twin_wall = 0.0
    for lo in range(0, n1, mb):
        t0 = time.perf_counter()
        twin.ingest(u1[lo:lo + mb], i1[lo:lo + mb])
        twin_wall += time.perf_counter() - t0
    if not _states_equal(torch, session.states, twin.states):
        fail(f"{phase}: interleaved states differ from the query-free twin's")
    for name in ("factor_update", "masked_scores", "fused_topn"):
        if counts[name] < 1:
            fail(f"{phase}: {name} never launched in the interleaved run")
    reg = _stream_counters(session.metrics)
    emit(phase, mode="interleaved", stream="synth_stream(MOVIELENS_25M, "
         "seed=0)", events=n1, cut=f"first {SERVICE_INTERLEAVED_BATCHES} "
         "micro-batches", grid=[N_I, N_I], publish="every 1, async",
         events_per_chunk=mb, query_batches=SERVICE_INTERLEAVED_BATCHES,
         query_batch=SERVICE_QUERY_BATCH, summary=rep.summary(),
         ingest_only_events_per_s=n1 / twin_wall,
         requeued=reg["requeued"], dropped=reg["dropped"],
         states_equal_twin=True, launches=counts)

    ops.reset_launch_counts()
    rep = run_service(
        session, u2, i2,
        dataclasses.replace(load, arrival="poisson", rate_qps=200.0),
        ServiceConfig(mode="threaded", query_batches=200))
    counts = ops.launch_counts()
    summary = rep.summary()
    t0 = time.perf_counter()
    twin.ingest(u2, i2)
    twin_s = time.perf_counter() - t0
    reg = _stream_counters(session.metrics)
    if session.events_processed != n1 + n2:
        fail(f"{phase}: the trainer stopped at {session.events_processed} "
             f"of {n1 + n2} events")
    if reg["dropped"]:
        fail(f"{phase}: {reg['dropped']} events dropped")
    if summary["query_batches_under_load"] < 1:
        fail(f"{phase}: no query batch was answered under load")
    if not _states_equal(torch, session.states, twin.states):
        fail(f"{phase}: threaded states differ from the query-free twin's")
    for name in ("factor_update", "masked_scores", "fused_topn"):
        if counts[name] < 1:
            fail(f"{phase}: {name} never launched in the threaded run")
    emit(phase, mode="threaded", events=n2,
         cut=f"micro-batches {SERVICE_INTERLEAVED_BATCHES}-"
             f"{SERVICE_INTERLEAVED_BATCHES + SERVICE_THREADED_BATCHES - 1}",
         arrival="poisson", rate_qps=200.0, query_batches=200,
         query_batch=SERVICE_QUERY_BATCH, summary=summary,
         ingest_only_events_per_s=n2 / twin_s, requeued=reg["requeued"],
         dropped=reg["dropped"], states_equal_twin=True,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=counts)


def _autoscaled(torch, np, rt, cfg, chunks, max_workers):
    """Ingest ``chunks`` into a session of ``cfg``, stepping an
    ``Autoscaler`` after each call when ``max_workers`` is set: (session,
    steps, dropped, ingest wall, recall bits)."""
    s = rt.StreamSession(cfg)
    scaler = (rt.Autoscaler(s, rt.AutoscalePolicy(max_workers=max_workers,
                                                  cooldown=0))
              if max_workers else None)
    steps, dropped, wall, bits = [], 0, 0.0, []
    for u, i in chunks:
        t0 = time.perf_counter()
        res = s.ingest(u, i)
        wall += time.perf_counter() - t0
        dropped += res.dropped
        bits.append(res.recall.bits())
        if scaler is None:
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        action = scaler.step()
        torch.cuda.synchronize()
        steps.append(dict(action=action, n_c=s.grid.n_c,
                          ms=(time.perf_counter() - t0) * 1e3,
                          resident_bytes=_state_bytes(s.states)))
    return s, steps, dropped, wall, np.concatenate(bits)


def _autoscale_phases(torch, np, rt, users, items):
    """``autoscale_path``: the MovieLens-25M deployment grown by the
    autoscaler from an undersized 2 x 2 grid, beside a twin that stays
    there; and the floored regime of tests/test_storage.py's
    ``_overloaded_run`` on the card."""
    from repro_torch.kernels import ops
    from repro_torch.serve import balanced_grid

    phase = "autoscale_path"
    base = dataclasses.replace(disgd_config(rt), grid=balanced_grid(4),
                               capacity_factor=0.25, carry_slots=256)
    n = AUTOSCALE_BATCHES * base.micro_batch
    chunks = [(users[c], items[c]) for c in
              np.array_split(np.arange(n), AUTOSCALE_CALLS)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    s, steps, dropped, wall, bits = _autoscaled(torch, np, rt, base, chunks,
                                                AUTOSCALE_MAX)
    counts = ops.launch_counts()
    fam = s.metrics.get("autoscaler_decisions_total")
    trail = {lab["action"]: c.value for lab, c in fam.series()}
    if s.grid.n_c != AUTOSCALE_MAX:
        fail(f"{phase}: the grid stopped at {s.grid.n_c} workers")
    if sum(trail.values()) != len(steps):
        fail(f"{phase}: decisions {trail} do not sum to {len(steps)} steps")
    if s.metrics.get("autoscaler_workers").value != s.grid.n_c:
        fail(f"{phase}: autoscaler_workers != n_c {s.grid.n_c}")
    for name in ("factor_update", "masked_scores"):
        if counts[name] < 1:
            fail(f"{phase}: {name} never launched")
    peak = torch.cuda.max_memory_allocated()
    del s
    torch.cuda.empty_cache()
    _, _, twin_dropped, twin_wall, twin_bits = _autoscaled(
        torch, np, rt, base, chunks, 0)
    # Above the bucket floor of 8 the dispatch capacity of a step is
    # micro_batch x capacity_factor at every grid size, so growing cannot
    # drop fewer events here; it must not drop more.
    if dropped > twin_dropped:
        fail(f"{phase}: the scaled run dropped {dropped} events, the fixed "
             f"twin {twin_dropped}")
    emit(phase, config="deployment", stream="synth_stream(MOVIELENS_25M, "
         "seed=0)", events=n, cut=f"first {AUTOSCALE_BATCHES} micro-batches",
         start_grid=list(balanced_grid(4).shape), u_cap=U_CAP, i_cap=I_CAP,
         capacity_factor=0.25, carry_slots=256, calls=AUTOSCALE_CALLS,
         steps=steps, decisions=trail, final_grid=[N_I, N_I],
         dropped=dropped, twin_dropped=twin_dropped,
         events_per_s=n / wall, twin_events_per_s=n / twin_wall,
         recall_at_10=float(np.nanmean(bits)),
         twin_recall_at_10=float(np.nanmean(twin_bits)),
         max_memory_allocated=peak, launches=counts)

    # The floored regime: tests/test_storage.py's _overloaded_run on the
    # card (one worker, micro-batch 64, buckets at the floor of 8 once
    # grown), where a bigger grid holds more events a step.
    rng = np.random.default_rng(7)
    small = rt.StreamConfig(grid=rt.GridSpec.rect(1, 1), micro_batch=64,
                            capacity_factor=0.25, carry_slots=8,
                            backend="cuda", device=DEVICE)
    chunks = [(rng.integers(0, 400, 512).astype(np.int32),
               rng.integers(0, 160, 512).astype(np.int32)) for _ in range(8)]
    ops.reset_launch_counts()
    s, steps, dropped, _, _ = _autoscaled(torch, np, rt, small, chunks, 8)
    counts = ops.launch_counts()
    _, _, fixed_dropped, _, _ = _autoscaled(torch, np, rt, small, chunks, 0)
    if not dropped < fixed_dropped:
        fail(f"{phase}: floored: the scaled run dropped {dropped} events, "
             f"the fixed grid {fixed_dropped}")
    emit(phase, config="floored", stream="tests/test_storage.py "
         "_overloaded_run (rng 7, 8 x 512 events)", start_grid=[1, 1],
         micro_batch=64, capacity_factor=0.25, carry_slots=8,
         steps=[(x["action"], x["n_c"]) for x in steps],
         final_grid=list(s.grid.shape), dropped=dropped,
         twin_dropped=fixed_dropped, launches=counts)


def _driver_phases(torch, np):
    """``drivers``: each launch driver's ``main(argv)`` in-process at its
    own defaults on the card, its metrics JSON (and checkpoints) under
    ``build/``."""
    import contextlib
    import io
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import (drift_rs, quickstart, rescale_rs,
                                    serve_rs, service_rs)

    if DRIVERS_DIR.is_dir():
        shutil.rmtree(DRIVERS_DIR)
    DRIVERS_DIR.mkdir(parents=True)
    drivers = {
        "serve_rs": (serve_rs, [], ("factor_update", "masked_scores",
                                    "fused_topn")),
        "drift_rs": (drift_rs, ["--ckpt-dir", str(DRIVERS_DIR / "drift")],
                     ("dics_update",)),
        "rescale_rs": (rescale_rs, ["--ckpt-dir",
                                    str(DRIVERS_DIR / "rescale")],
                       ("factor_update", "masked_scores", "fused_topn")),
        "service_rs": (service_rs, [], ("factor_update", "masked_scores",
                                        "fused_topn")),
        "quickstart": (quickstart, [], ("factor_update", "masked_scores",
                                        "fused_topn")),
    }
    rows = {}
    for name, (module, argv, kernels) in drivers.items():
        argv = argv + ["--metrics-json", str(DRIVERS_DIR / f"{name}.json")]
        out = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                module.main(argv)
        except Exception as e:  # the phase fails on any driver's exception
            fail(f"drivers: {name} raised {type(e).__name__}: {e}")
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        lines = out.getvalue().splitlines()
        if len(lines) < 3:
            fail(f"drivers: {name} printed {len(lines)} lines")
        for k in kernels:
            if counts[k] < 1:
                fail(f"drivers: {name} never launched {k}")
        wrote = (DRIVERS_DIR / f"{name}.json").is_file()
        if name != "quickstart" and not wrote:
            fail(f"drivers: {name} wrote no metrics JSON")
        rows[name] = dict(argv=argv, seconds=seconds, lines=lines,
                          launches=counts)
        torch.cuda.empty_cache()
    emit("drivers", defaults="each driver's own, --backend cuda --device "
         "cuda", directory=str(DRIVERS_DIR.relative_to(ROOT)), drivers=rows)


def _grid_agrees(np, rows, scan, cfg, what) -> float:
    """Each rank's ``RankStream`` of a ``shard_map`` run against the
    ``scan`` run of the same stream and config in this process: counters,
    loads, occupancy history, the telemetry vector, drift flags and
    integer state exactly, each rank's worker against its row, floats
    within STREAM_RTOL / STREAM_ATOL, recall bits equal (a differing bit
    is reported with its step: ``cfg``'s carry slots and micro-batch
    make a step's row). Returns the largest float difference."""
    from repro_torch.core import convert

    st = convert.states_to_numpy(scan.final_states)
    bits = scan.recall.bits()
    layout = (cfg.carry_slots or cfg.micro_batch) + cfg.micro_batch
    err = 0.0
    for rank, row in enumerate(rows):
        r = row.result
        if (r.events_processed, r.dropped, r.forgets) != (
                scan.events_processed, scan.dropped, scan.forgets):
            fail(f"{what}: rank {rank} processed / dropped / forgets differ "
                 f"from scan")
        for name, a, b in (
                ("loads", r.load_history, scan.load_history),
                ("user occupancy", [o for _, o in r.user_occupancy],
                 [o for _, o in scan.user_occupancy]),
                ("telemetry", list(r.telemetry), list(scan.telemetry)),
                ("drift flags", [r.drift_flags], [scan.drift_flags])):
            if not all(np.array_equal(x, y) for x, y in zip(a, b)) or (
                    len(a) != len(b)):
                fail(f"{what}: rank {rank}'s {name} differ from scan")
        got = r.recall.bits()
        differ = np.flatnonzero(~((got == bits)
                                  | (np.isnan(got) & np.isnan(bits))))
        if got.shape != bits.shape or differ.size:
            fail(f"{what}: rank {rank}: {differ.size} recall bits differ "
                 f"from scan, the first in step {differ[:1] // layout}")
        for name, want in st.items():
            x, y = r.final_states[name][0], want[rank]
            if want.dtype.kind != "f":
                if not np.array_equal(x, y):
                    fail(f"{what}: rank {rank}: {name} differs from scan")
                continue
            d = float(np.abs(x - y).max(initial=0.0))
            if not np.allclose(x, y, rtol=STREAM_RTOL, atol=STREAM_ATOL):
                fail(f"{what}: rank {rank}: {name} beyond rtol="
                     f"{STREAM_RTOL} atol={STREAM_ATOL} (max abs {d:.3g} "
                     f"at {np.unravel_index(np.abs(x - y).argmax(), x.shape)})")
            err = max(err, d)
    return err


def _grid_row(run, rows, scan, steps, events) -> dict:
    """A grid run's numbers beside its ``scan`` twin's."""
    calls = {row.collectives["calls"] for row in rows}
    if len(calls) != 1:
        fail(f"grid ranks issued different collective counts: {calls}")
    wall = max(row.result.wall_seconds for row in rows)
    return dict(
        events=events, steps=steps, backend=run.backend,
        ranks=len(rows), ranks_per_card=run.ranks_per_card,
        grid_wall_s=wall,
        grid_events_per_s=rows[0].result.events_processed / wall,
        scan_wall_s=scan.wall_seconds, scan_events_per_s=scan.throughput,
        collectives_per_step=calls.pop() / steps,
        collective_ms_per_step=[row.collectives["ms"] / steps
                                for row in rows],
        peak_bytes_per_rank=[row.peak_bytes for row in rows],
        recall_at_10=rows[0].result.recall.mean(),
        forgets=rows[0].result.forgets,
        fires=(int(rows[0].result.drift_flags.sum())
               if rows[0].result.drift_flags is not None else None))


def _grid_nccl_rank(info, cases, session):
    """``stream_on_rank`` with every loop step under sync debug mode
    "error" (a synchronizing call inside the loop raises); then a session
    publishing every step asynchronously with a reader thread during its
    second ingest, every step, every boundary (``engine._publish_event``)
    and every ``publish_async`` under the same mode. The mode is global
    to the process: the reader's calls (which read their answers back)
    take turns with them behind one lock."""
    import threading

    import torch

    import repro_torch as rt
    from repro_torch.core import distributed, engine

    gate = threading.Lock()

    def checked(fn):
        def call(*a, **k):
            with gate:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        return call

    make = engine._make_batch_step
    engine._make_batch_step = lambda *a: checked(make(*a))
    rows = distributed.stream_on_rank(info, cases)
    engine._publish_event = checked(engine._publish_event)
    users, items, cfg, queries = session
    cfg = dataclasses.replace(cfg, backend="shard_map", device=info.device)
    s = rt.StreamSession(cfg, publish=rt.PublishPolicy(every=1,
                                                       mode="async"))
    s.store.publish_async = checked(s.store.publish_async)
    half = users.size // 2
    s.ingest(users[:half], items[:half])
    reads, errors = [], []

    def reader():
        try:
            for _ in range(GRID_NCCL_READS):
                with gate:
                    r = s.recommend(queries)
                    reads.append((_answer(r), s.store.last_agreement))
                time.sleep(0.01)
        except BaseException as e:      # reported by the parent
            errors.append(repr(e))

    t = threading.Thread(target=reader)
    t.start()
    res = s.ingest(users[half:], items[half:])
    t.join(GRID_TIMEOUT)
    return rows, dict(reads=reads, errors=errors, alive=t.is_alive(),
                      final=_answer(s.recommend(queries)),
                      bits=res.recall.bits(), store=s.store.stats_snapshot(),
                      digests=_digests(s.states))


def _digests(states) -> dict:
    """A SHA-256 of each leaf's bytes (``convert.states_to_numpy``): a
    rank's worker is held to its row of the ``scan`` states without being
    sent back."""
    import hashlib

    from repro_torch.core import convert

    return {name: hashlib.sha256(leaf.tobytes()).hexdigest()
            for name, leaf in convert.states_to_numpy(states).items()}


def _row_digests(states, n_c) -> list:
    """``_digests`` of every worker's row of a whole grid's states."""
    import hashlib

    from repro_torch.core import convert

    host = convert.states_to_numpy(states)
    return [{name: hashlib.sha256(leaf[w:w + 1].tobytes()).hexdigest()
             for name, leaf in host.items()} for w in range(n_c)]


def _grid_session_queries(np, users, known=GRID_SESSION_USERS,
                          unknown=GRID_SESSION_UNKNOWN):
    """``known`` distinct users of the cut, then ``unknown`` ids past
    every user id (no worker knows them)."""
    trained = np.random.default_rng(0).choice(np.unique(users), known,
                                              replace=False)
    return np.concatenate([trained, users.max() + 1 + np.arange(unknown)])


def _answer(resp) -> dict:
    return dict(ids=resp.ids, scores=resp.scores, known=resp.known,
                version=resp.snapshot_version, hits=resp.cache_hits,
                fallbacks=resp.fallbacks)


def _answers_equal(np, a, b) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in a)


def _bits_same(np, a, b) -> bool:
    return a.shape == b.shape and bool(
        ((a == b) | (np.isnan(a) & np.isnan(b))).all())


def _grid_session(rt, cfg):
    return rt.StreamSession(cfg, publish=rt.PublishPolicy(
        every=GRID_SESSION_EVERY, mode="sync"))


def _timed_recommend(torch, session, queries):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp = session.recommend(queries)
    return _answer(resp), (time.perf_counter() - t0) * 1e3


SERVE_KERNEL = {"disgd": "fused_topn", "bpr": "fused_topn",
                "dics": "dics_topn"}


def _counted_recommend(torch, session, queries):
    """``_timed_recommend``'s answer with the launches of the session's
    serve kernel (K3 or K5) in the call."""
    from repro_torch.kernels import ops

    kernel = SERVE_KERNEL[session.cfg.algorithm]
    before = ops.launch_counts()[kernel]
    answer = _timed_recommend(torch, session, queries)[0]
    return answer, ops.launch_counts()[kernel] - before


def _rescales(torch, rt, session, queries, digests):
    """``rescale`` live to ``GridSpec.rect(*GRID_SESSION_RESCALE)`` and
    back, ``recommend`` after each: ``(ms, digests, answer)`` a step and
    the card's peak bytes over both."""
    dev = session.states.tables.user_ids.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for grid in (rt.GridSpec.rect(*GRID_SESSION_RESCALE), session.cfg.grid):
        t0 = time.perf_counter()
        session.rescale(grid)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append((ms, digests(session.states, grid),
                      _timed_recommend(torch, session, queries)[0]))
    return steps, torch.cuda.max_memory_allocated(dev)


def _session_rank(info, users, items, cfg, queries) -> dict:
    """A ``shard_map`` session on this rank: ``ingest`` with publishing,
    then ``recommend`` twice (a miss, then a hit)."""
    import torch

    import repro_torch as rt
    from repro_torch.core import distributed, storage
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(cfg, backend="shard_map", device=info.device)
    ops.reset_launch_counts()
    s = _grid_session(rt, cfg)
    distributed.reset_collective_stats()
    t0 = time.perf_counter()
    res = s.ingest(users, items)
    ingest_s = time.perf_counter() - t0
    ingest_coll = distributed.collective_stats()
    distributed.reset_collective_stats()
    calls = [_timed_recommend(torch, s, queries) for _ in range(2)]
    out = dict(bits=res.recall.bits(),
               counts=(res.events_processed, res.dropped),
               digests=_digests(s.states), answers=[a for a, _ in calls],
               ms=[t for _, t in calls], ingest_s=ingest_s,
               ingest_collectives=ingest_coll,
               serve_collectives=distributed.collective_stats("serve"),
               serve=s.frontend.stats_snapshot(),
               store=s.store.stats_snapshot(),
               fused_topn=ops.launch_counts()["fused_topn"],
               nbytes=storage.total_nbytes(s.states))
    distributed.reset_collective_stats()
    out["rescales"], out["rescale_peak_bytes"] = _rescales(
        torch, rt, s, queries, lambda st, grid: _digests(st))
    out["rescale_collectives"] = distributed.collective_stats()
    return out


def _elastic_rank(info, users, items, cfg, queries) -> dict:
    """``_elastic_steps`` on ``backend="shard_map"`` on this rank."""
    import torch

    import repro_torch as rt

    cfg = dataclasses.replace(cfg, backend="shard_map", device=info.device)
    return _elastic_steps(torch, rt, cfg, users, items, queries, "grid")


def _elastic_steps(torch, rt, cfg, users, items, queries, name) -> dict:
    """Ingest, ``checkpoint``, ``restore`` at ``GridSpec.rect(2, 1)``,
    ``rescale`` back to ``cfg.grid``; ``recommend`` after each step, with
    the serve kernel's launches. The states' digests are a rank's
    worker's on the process grid, every row's in one process."""
    import hashlib

    from repro_torch.core import storage

    def digests(states, grid):
        if cfg.backend == "shard_map":
            return _digests(states)
        return _row_digests(states, grid.n_c)

    name = f"{name}.{cfg.algorithm}"
    s = _grid_session(rt, cfg)
    s.ingest(users, items)
    out = {"trained": (digests(s.states, cfg.grid),
                       *_counted_recommend(torch, s, queries))}
    t0 = time.perf_counter()
    path = s.checkpoint(str(GRID_ELASTIC_DIR / name))
    out["write_s"] = time.perf_counter() - t0
    with open(path, "rb") as f:
        data = f.read()
    out["file"] = (len(data), hashlib.sha256(data).hexdigest())
    small = dataclasses.replace(cfg, grid=rt.GridSpec.rect(2, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = rt.StreamSession.restore(
        str(GRID_ELASTIC_DIR / name), small,
        publish=rt.PublishPolicy(every=GRID_SESSION_EVERY, mode="sync"))
    torch.cuda.synchronize()
    out["read_s"] = time.perf_counter() - t0
    out["restored"] = (digests(t.states, small.grid),
                       *_counted_recommend(torch, t, queries))
    out["restored_bytes"] = storage.total_nbytes(t.states)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t.rescale(cfg.grid)
    torch.cuda.synchronize()
    out["rescale_ms"] = (time.perf_counter() - t0) * 1e3
    out["rescaled"] = (digests(t.states, cfg.grid),
                       *_counted_recommend(torch, t, queries))
    return out


def _answer_digest(answer) -> str:
    import hashlib

    h = hashlib.sha256()
    for key in sorted(answer):
        h.update(repr(answer[key]).encode() if not hasattr(
            answer[key], "tobytes") else answer[key].tobytes())
    return h.hexdigest()


def _capturing(session, answers):
    """Record each ``recommend`` answer of ``session`` with its agreement
    (None in one process) and its ids (``run_service`` calls
    ``session.recommend``)."""
    import numpy as np

    call = session.recommend

    def recommend(user_ids, n=None):
        resp = call(user_ids, n)
        answers.append((_answer(resp), session.store.last_agreement,
                        np.asarray(user_ids, np.int64).copy()))
        return resp
    session.recommend = recommend


def _same_but_version(np, a, b) -> bool:
    """Answers equal but for the snapshot version (an async ``scan``
    session's versions count what it coalesced; the grid's do not)."""
    return all(np.array_equal(a[k], b[k]) for k in a if k != "version")


def _async_rank(info, users, items, cfg) -> dict:
    """``grid_async`` on this rank: ``grid_session``'s session under an
    async policy through ``run_service(mode="threaded")``; every answer
    (rank 0) or its digest (the others), with its agreement; the time of
    each agreement; K3 launches and the plane's calls."""
    import torch

    import repro_torch as rt
    from repro_torch.core import distributed
    from repro_torch.kernels import ops
    from repro_torch.serve.loadgen import LoadConfig
    from repro_torch.serve.service import ServiceConfig, run_service

    cfg = dataclasses.replace(cfg, backend="shard_map", device=info.device)
    s = rt.StreamSession(cfg, publish=rt.PublishPolicy(
        every=GRID_SESSION_EVERY, mode="async"))
    answers, agree_ms = [], []
    agree = s.store.agree

    def timed_agree(*a, **k):
        t0 = time.perf_counter()
        try:
            return agree(*a, **k)
        finally:
            agree_ms.append((time.perf_counter() - t0) * 1e3)
    s.store.agree = timed_agree
    _capturing(s, answers)
    ops.reset_launch_counts()
    distributed.reset_collective_stats()
    torch.cuda.synchronize()
    rep = run_service(
        s, users, items,
        LoadConfig(n_users=int(users.max()) + 1, seed=0,
                   query_batch=GRID_ASYNC_QUERY_BATCH, arrival="closed"),
        ServiceConfig(mode="threaded", query_batches=GRID_ASYNC_BATCHES))
    return dict(
        ingest_s=rep.ingest_wall_s, wall_s=rep.wall_s,
        summary=rep.summary(),
        under_load=[r.under_load for r in rep.records],
        answers=[(a if not info.rank else _answer_digest(a), g, q)
                 for a, g, q in answers],
        agree_ms=agree_ms, fused_topn=ops.launch_counts()["fused_topn"],
        serve=s.frontend.stats_snapshot(), store=s.store.stats_snapshot(),
        train_collectives=distributed.collective_stats("train"),
        serve_collectives=distributed.collective_stats("serve"),
        events=s.events_processed, digests=_digests(s.states))


def _grid_path_rank(info, cases, session):
    """``grid_path``'s stream, then ``grid_session``'s session and
    ``grid_async``'s."""
    from repro_torch.core import distributed

    return (distributed.stream_on_rank(info, cases),
            _session_rank(info, *session), _async_rank(info, *session[:3]))


def _service_steps(torch, np, rt, cfgs, users, items, queries) -> dict:
    """``grid_service``'s steps under an async policy on ``cfgs`` (DISGD,
    DICS; their backend decides where): interleaved ``run_service`` on
    DISGD, the ``Autoscaler`` from one worker, a two-segment DICS + DISGD
    ensemble; answers, states (digests: a rank's worker on the grid,
    every row in one process) and the serve kernels' launches."""
    from repro_torch.kernels import ops
    from repro_torch.serve.loadgen import LoadConfig
    from repro_torch.serve.service import ServiceConfig, run_service

    disgd, dics = cfgs
    grid = disgd.backend == "shard_map"

    def digests(states, g):
        return _digests(states) if grid else _row_digests(states, g.n_c)

    def policy():
        return rt.PublishPolicy(every=GRID_SESSION_EVERY, mode="async")

    def launches():
        c = ops.launch_counts()
        return c["fused_topn"], c["dics_topn"]

    out = {}
    s = rt.StreamSession(disgd, publish=policy())
    answers = []
    _capturing(s, answers)
    before = launches()
    rep = run_service(
        s, users, items, LoadConfig(n_users=int(users.max()) + 1, seed=5,
                                    query_batch=64),
        ServiceConfig(mode="interleaved", events_per_chunk=512,
                      query_batches=GRID_SERVICE_BATCHES))
    out["interleaved"] = dict(
        answers=[a for a, _, _ in answers],
        records=[(r.staleness_events, r.snapshot_forgets, r.cache_hits,
                  r.fallbacks) for r in rep.records],
        store=s.store.stats_snapshot(), digests=digests(s.states, disgd.grid),
        p50_ms=rep.summary().get("p50_ms"),
        launches=[a - b for a, b in zip(launches(), before)])

    a_cfg = dataclasses.replace(disgd, grid=rt.GridSpec.rect(1, 1),
                                micro_batch=64, capacity_factor=0.25,
                                carry_slots=8)
    s = rt.StreamSession(a_cfg, publish=policy())
    scaler = rt.Autoscaler(s, rt.AutoscalePolicy(max_workers=4, cooldown=0))
    rng = np.random.default_rng(7)
    actions, dropped, answers = [], 0, []
    for _ in range(GRID_AUTOSCALE_ROUNDS):
        u = rng.integers(0, 400, 512).astype(np.int32)
        i = rng.integers(0, 160, 512).astype(np.int32)
        dropped += s.ingest(u, i).dropped
        answers.append(_answer(s.recommend(u[:8])))
        actions.append(scaler.step())
    out["autoscale"] = dict(actions=actions, dropped=dropped,
                            answers=answers, grid=list(s.grid.shape),
                            store=s.store.stats_snapshot(),
                            digests=digests(s.states, s.grid))

    e = rt.EnsembleSession([dics, disgd], publish=policy())
    weights = []
    for j in range(2):
        lo, hi = j * GRID_ENSEMBLE_SEGMENT, (j + 1) * GRID_ENSEMBLE_SEGMENT
        weights.append({k: v.tolist() for k, v in
                        e.ingest(users[lo:hi], items[lo:hi]).weights.items()})
    before = launches()
    answer = _answer(e.recommend(queries))
    out["ensemble"] = dict(
        weights=weights, answer=answer, resets=e.exploration_resets,
        launches=[a - b for a, b in zip(launches(), before)],
        digests={name: digests(m.states, m.grid)
                 for name, m in e.members.items()})
    return out


def _grid_agree_rank(info, cases, elastic, service):
    """``grid_agree``'s streams, then ``grid_elastic``'s sessions and
    ``grid_service``'s steps."""
    import numpy as np
    import torch

    import repro_torch as rt
    from repro_torch.core import distributed

    cfgs, users, items, queries = service
    cfgs = [dataclasses.replace(c, backend="shard_map", device=info.device)
            for c in cfgs]
    return (distributed.stream_on_rank(info, cases),
            [_elastic_rank(info, *e) for e in elastic],
            _service_steps(torch, np, rt, cfgs, users, items, queries))


def _grid_session_check(torch, np, rt, sessions, users, items, cfg,
                        queries, served):
    """``grid_session``: each rank's session against the ``scan`` session
    of the same cut in this process; emits the phase's line. The
    ``scan`` session also replays ``grid_async``: ``served`` maps a
    version to the ids the grid answered from it, and each is answered
    by a fresh front-end on that snapshot as it rotates (no copy kept).
    Returns ``({(version, ids): (events, answer)}, the scan worker
    rows' digests)``."""
    from repro_torch.kernels import ops

    s = _grid_session(rt, cfg)
    replay = _replayed(rt, s, served)
    t0 = time.perf_counter()
    res = s.ingest(users, items)
    scan_ingest_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    calls = [_timed_recommend(torch, s, queries) for _ in range(2)]
    scan_launches = ops.launch_counts()["fused_topn"]
    rows = _row_digests(s.states, cfg.grid.n_c)
    bits = res.recall.bits()
    scan_rescales, scan_peak = _rescales(
        torch, rt, s, queries, lambda st, g: _row_digests(st, g.n_c))
    small = rt.GridSpec.rect(*GRID_SESSION_RESCALE)
    dense_rated = cfg.grid.n_c * U_CAP * I_CAP
    for rank, got in enumerate(sessions):
        what = f"grid_session: rank {rank}"
        if got["counts"] != (res.events_processed, res.dropped):
            fail(f"{what}: processed / dropped differ from scan")
        if not _bits_same(np, got["bits"], bits):
            fail(f"{what}: recall bits differ from scan")
        differ = [k for k, v in rows[rank].items() if got["digests"][k] != v]
        if differ:
            fail(f"{what}: worker differs from its scan row in {differ}")
        for j, (a, (b, _)) in enumerate(zip(got["answers"], calls)):
            if not _answers_equal(np, a, b):
                fail(f"{what}: recommend call {j} differs from scan")
        if got["fused_topn"] != scan_launches or scan_launches < 1:
            fail(f"{what}: fused_topn launched {got['fused_topn']} times, "
                 f"the scan session {scan_launches}")
        for (_, want_rows, want), (_, got_d, got_a), grid in zip(
                scan_rescales, got["rescales"], (small, cfg.grid)):
            if not _answers_equal(np, got_a, want):
                fail(f"{what}: recommend after rescale to {grid.shape} "
                     f"differs from scan")
            if rank < grid.n_c and got_d != want_rows[rank]:
                fail(f"{what}: worker after rescale to {grid.shape} "
                     f"differs from its scan row")
        if got["rescale_peak_bytes"] >= dense_rated:
            fail(f"{what}: {got['rescale_peak_bytes']} bytes at the peak "
                 f"of a rescale, the grid's dense rated {dense_rated}")
        if got["serve"]["collectives"] != got["serve"]["plane_batches"]:
            fail(f"{what}: plane collectives != plane batches")
    miss, hit = calls[0][0], calls[1][0]
    if miss["hits"] != 0 or hit["hits"] != int((queries >= 0).sum()):
        fail("grid_session: the second recommend is not all cache hits")
    ranks = len(sessions)
    serve = [g["serve_collectives"] for g in sessions]
    emit("grid_session", stream="synth_stream(MOVIELENS_25M, seed=0)",
         cut=f"first {GRID_SESSION_EVENTS} events",
         grid=[cfg.grid.n_i, cfg.grid.g], ranks=ranks, u_cap=U_CAP,
         i_cap=I_CAP, micro_batch=MICRO_BATCH, publish_every=GRID_SESSION_EVERY,
         queries=int(queries.size), unknown_ids=GRID_SESSION_UNKNOWN,
         recall_at_10=res.recall.mean(),
         fallbacks=miss["fallbacks"],
         recommend_miss_ms_p50=statistics.median(g["ms"][0]
                                                 for g in sessions),
         recommend_hit_ms_p50=statistics.median(g["ms"][1]
                                                for g in sessions),
         scan_recommend_miss_ms=calls[0][1], scan_recommend_hit_ms=calls[1][1],
         plane_calls=sessions[0]["serve"]["plane_batches"],
         serve_collectives=serve[0]["calls"],
         serve_collective_ms_per_call=[c["ms"] / max(c["calls"], 1)
                                       for c in serve],
         ingest_collectives=sessions[0]["ingest_collectives"]["calls"],
         ingest_s=[g["ingest_s"] for g in sessions],
         scan_ingest_s=scan_ingest_s,
         publishes=sessions[0]["store"]["rotations"],
         fused_topn_per_rank=[g["fused_topn"] for g in sessions],
         scan_fused_topn=scan_launches,
         resident_bytes_per_rank=sessions[0]["nbytes"],
         rescaled_to=[small.n_i, small.g],
         rescale_ms=[[r[0] for r in g["rescales"]] for g in sessions],
         scan_rescale_ms=[r[0] for r in scan_rescales],
         rescale_peak_bytes_per_rank=[g["rescale_peak_bytes"]
                                      for g in sessions],
         scan_rescale_peak_bytes=scan_peak, dense_rated_bytes=dense_rated,
         rescale_collectives=sessions[0]["rescale_collectives"]["calls"],
         rescale_collective_bytes_per_rank=[
             g["rescale_collectives"]["bytes"] for g in sessions])
    return replay, rows


def _replayed(rt, session, served) -> dict:
    """Answer, as ``session``'s snapshots rotate, the ids a grid answered
    from the same version (``served``: version -> ids arrays), each by a
    fresh front-end on that snapshot alone, so that no snapshot is kept.
    Returns the dict it fills: ``{(version, ids bytes): (events,
    answer)}``."""
    replay = {}

    def answer_at(snap):
        for ids in served.get(snap.version, ()):
            one = rt.SnapshotStore()
            one.publish(snap.states, snap.events_processed, snap.forgets)
            front = rt.QueryFrontend(one, session.frontend.cfg)
            replay[(snap.version, ids.tobytes())] = (
                snap.events_processed, _answer(front.serve(ids)))

    session.store.subscribe(answer_at)
    return replay


def _replay_equal(np, answer, agreement, ids, replay) -> bool:
    events, want = replay[(agreement.version, ids.tobytes())]
    return agreement.events_processed == events and all(
        np.array_equal(answer[k], want[k])
        for k in ("ids", "scores", "known", "fallbacks"))


def _grid_async_check(np, asyncs, sessions, cfg, replay, rows, n) -> dict:
    """``grid_async``: every rank's threaded service run under an async
    policy against rank 0's and the ``scan`` replay; returns the phase's
    numbers."""
    base = asyncs[0]
    boundaries = math.ceil(_steps(n, cfg) / GRID_SESSION_EVERY)
    for rank, got in enumerate(asyncs):
        what = f"grid_async: rank {rank}"
        if len(got["answers"]) != len(base["answers"]):
            fail(f"{what}: {len(got['answers'])} query batches, rank 0 "
                 f"{len(base['answers'])}")
        for j, ((a, ga, qa), (b, gb, qb)) in enumerate(
                zip(got["answers"], base["answers"])):
            if ga != gb or not np.array_equal(qa, qb) or (
                    rank and a != _answer_digest(b)):
                fail(f"{what}: batch {j} differs from rank 0's")
        if got["under_load"] != base["under_load"]:
            fail(f"{what}: under-load batches differ from rank 0's")
        if got["events"] != n:
            fail(f"{what}: {got['events']} events processed of {n}")
        st = got["store"]
        if st["coalesced"] or st["async_rotations"] != boundaries:
            fail(f"{what}: {st} against {boundaries} boundaries")
        plane = got["serve"]["plane_batches"]
        if got["fused_topn"] != plane or plane < 1:
            fail(f"{what}: fused_topn launched {got['fused_topn']} times "
                 f"for {plane} plane calls")
        if got["serve_collectives"]["calls"] != (
                got["serve"]["collectives"] + got["serve"]["agreements"]):
            fail(f"{what}: serve-group calls are not the plane's and the "
                 f"agreements'")
        differ = [k for k, v in rows[rank].items() if got["digests"][k] != v]
        if differ:
            fail(f"{what}: worker differs from its scan row in {differ}")
    positions = []
    for j, (answer, agreement, ids) in enumerate(base["answers"]):
        if not _replay_equal(np, answer, agreement, ids, replay):
            fail(f"grid_async: batch {j} differs from the scan replay at "
                 f"v{agreement.version}")
        positions.append(agreement.events_processed)
    if sum(base["under_load"]) < 1:
        fail("grid_async: no query batch ran during the ingest")
    lat = [g["summary"] for g in asyncs]
    return dict(
        query_batches=len(base["answers"]),
        under_load=sum(base["under_load"]),
        positions_served=sorted(set(positions)),
        ingest_s=[g["ingest_s"] for g in asyncs],
        sync_ingest_s=[g["ingest_s"] for g in sessions],
        query_p50_ms=statistics.median(x["p50_ms"] for x in lat),
        query_p99_ms=statistics.median(x["p99_ms"] for x in lat),
        query_max_ms=max(x["max_ms"] for x in lat),
        agree_ms_p50=[statistics.median(g["agree_ms"]) for g in asyncs],
        agree_ms_max=[max(g["agree_ms"]) for g in asyncs],
        agreements=base["serve"]["agreements"],
        plane_calls=base["serve"]["plane_batches"],
        fused_topn_per_rank=[g["fused_topn"] for g in asyncs],
        serve_collective_ms=[g["serve_collectives"]["ms"] for g in asyncs],
        train_collectives=base["train_collectives"]["calls"],
        boundaries=boundaries,
        async_rotations_plus_coalesced=(base["store"]["async_rotations"]
                                        + base["store"]["coalesced"]))


def _grid_service_check(torch, np, rt, ranks, cfgs, users, items,
                        queries) -> dict:
    """``grid_service``: each rank's steps against ``scan``'s; returns the
    phase's numbers."""
    scan = _service_steps(torch, np, rt, cfgs, users, items, queries)
    for rank, got in enumerate(ranks):
        what = f"grid_service: rank {rank}"
        a, b = got["interleaved"], scan["interleaved"]
        if a["records"] != b["records"] or len(a["answers"]) != len(
                b["answers"]) or not all(
                _same_but_version(np, x, y)
                for x, y in zip(a["answers"], b["answers"])):
            fail(f"{what}: interleaved run differs from scan")
        if a["store"]["coalesced"] or a["store"]["async_rotations"] != (
                b["store"]["async_rotations"] + b["store"]["coalesced"]):
            fail(f"{what}: async publishes {a['store']} against scan's "
                 f"{b['store']}")
        if a["digests"] != b["digests"][rank] or a["launches"] != b[
                "launches"]:
            fail(f"{what}: interleaved worker or K3 launches differ")
        a, b = got["autoscale"], scan["autoscale"]
        if [a[k] for k in ("actions", "dropped", "grid")] != [
                b[k] for k in ("actions", "dropped", "grid")] or not all(
                _same_but_version(np, x, y)
                for x, y in zip(a["answers"], b["answers"])):
            fail(f"{what}: autoscaler {a['actions']} / {a['dropped']} "
                 f"against scan's {b['actions']} / {b['dropped']}")
        n_c = b["grid"][0] * b["grid"][1]
        if rank < n_c and a["digests"] != b["digests"][rank]:
            fail(f"{what}: autoscaled worker differs from its scan row")
        a, b = got["ensemble"], scan["ensemble"]
        if (a["weights"], a["resets"], a["launches"]) != (
                b["weights"], b["resets"], b["launches"]) or not (
                _same_but_version(np, a["answer"], b["answer"])):
            fail(f"{what}: ensemble differs from scan")
        for name, rows in b["digests"].items():
            if a["digests"][name] != rows[rank]:
                fail(f"{what}: ensemble member {name} differs from its row")
    if "grow" not in scan["autoscale"]["actions"]:
        fail("grid_service: the autoscaler never grew")
    if min(scan["ensemble"]["launches"]) < 1:
        fail("grid_service: the ensemble's recommend launched no K3 / K5")
    return dict(
        interleaved_batches=GRID_SERVICE_BATCHES,
        interleaved_p50_ms=[r["interleaved"]["p50_ms"] for r in ranks],
        scan_interleaved_p50_ms=scan["interleaved"]["p50_ms"],
        k3_per_rank=[r["interleaved"]["launches"][0] for r in ranks],
        autoscale_actions=scan["autoscale"]["actions"],
        autoscale_grid=scan["autoscale"]["grid"],
        ensemble_weights=scan["ensemble"]["weights"][-1],
        ensemble_k3_k5_per_rank=[r["ensemble"]["launches"] for r in ranks])


def _grid_elastic_check(torch, np, rt, ranks, users, items, cfg, queries):
    """``grid_elastic``: each rank's steps against ``scan``'s on one
    configuration; returns its numbers."""
    scan = _elastic_steps(torch, rt, cfg, users, items, queries, "scan")
    small = rt.GridSpec.rect(2, 1)
    kernel = SERVE_KERNEL[cfg.algorithm]
    steps = ("trained", "restored", "rescaled")
    for step, grid in zip(steps, (cfg.grid, small, cfg.grid)):
        rows, want, launches = scan[step]
        if launches < 1:
            fail(f"grid_elastic {cfg.algorithm}: scan {step}: {kernel} "
                 f"never launched")
        for rank, got in enumerate(ranks):
            what = f"grid_elastic {cfg.algorithm}: rank {rank} {step}"
            if not _answers_equal(np, got[step][1], want):
                fail(f"{what}: answers differ from scan")
            if rank < grid.n_c and got[step][0] != rows[rank]:
                fail(f"{what}: worker differs from its scan row")
            if got[step][2] != (launches if rank < grid.n_c else 0):
                fail(f"{what}: {kernel} launched {got[step][2]} times, "
                     f"scan {launches}")
    for rank, got in enumerate(ranks):
        if (got["restored_bytes"] == 0) != (rank >= small.n_c):
            fail(f"grid_elastic {cfg.algorithm}: rank {rank} holds "
                 f"{got['restored_bytes']} bytes at {small}")
    if any(r["file"] != scan["file"] for r in ranks):
        fail(f"grid_elastic {cfg.algorithm}: the grid's checkpoint file is "
             f"not scan's")
    return dict(
        grid=[cfg.grid.n_i, cfg.grid.g], restored_at=[small.n_i, small.g],
        file_bytes=scan["file"][0],
        write_s=[r["write_s"] for r in ranks], scan_write_s=scan["write_s"],
        read_s=[r["read_s"] for r in ranks], scan_read_s=scan["read_s"],
        rescale_ms=[r["rescale_ms"] for r in ranks],
        scan_rescale_ms=scan["rescale_ms"],
        restored_bytes_per_rank=[r["restored_bytes"] for r in ranks],
        kernel=kernel,
        launches_per_rank={step: [r[step][2] for r in ranks]
                           for step in steps},
        scan_launches={step: scan[step][2] for step in steps})


def _grid_phases(torch, np, rt, users, items, drift_scans):
    """``grid_path``, ``grid_agree`` and ``grid_nccl``: ``backend=
    "shard_map"`` over ranks started by ``launch.mesh.run_on_ranks``,
    each against ``scan`` in this process (``drift_scans``:
    ``_drift_phases``' scan runs of the same configurations)."""
    import shutil

    from repro_torch.core import distributed
    from repro_torch.drift import make_scenario
    from repro_torch.launch import mesh as mesh_lib

    # -- grid_path ----------------------------------------------------------------
    u, i = users[:GRID_EVENTS], items[:GRID_EVENTS]
    cfg = dataclasses.replace(disgd_config(rt), backend="scan",
                              carry_slots=GRID_CARRY_SLOTS)
    su, si = users[:GRID_SESSION_EVENTS], items[:GRID_SESSION_EVENTS]
    queries = _grid_session_queries(np, su)
    t0 = time.perf_counter()
    run = mesh_lib.run_on_ranks(_grid_path_rank, cfg.grid.n_c, "cuda",
                                [(u, i, cfg)], (su, si, cfg, queries),
                                timeout=GRID_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    sessions = [r[1] for r in run.results]
    asyncs = [r[2] for r in run.results]
    rows = [r[0][0] for r in run.results]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    scan = rt.run_stream(u, i, cfg)
    scan_peak = torch.cuda.max_memory_allocated()
    err = _grid_agrees(np, rows, scan, cfg, "grid_path")
    emit("grid_path", **_grid_row(run, rows, scan, _steps(u.size, cfg),
                                  int(u.size)),
         stream="synth_stream(MOVIELENS_25M, seed=0)",
         cut=f"first {GRID_EVENTS} events (the eager worker, and 16 ranks "
             f"on one card within the script's time limit)",
         grid=[cfg.grid.n_i, cfg.grid.g], u_cap=U_CAP, i_cap=I_CAP,
         micro_batch=MICRO_BATCH, bucket_capacity=cfg.bucket_capacity,
         carry_slots=cfg.carry_slots, run_s=spawn_s,
         scan_peak_bytes=scan_peak, max_abs_err=err,
         rtol=STREAM_RTOL, atol=STREAM_ATOL,
         staging=("gloo stages the CUDA buffer through the host: each "
                  "collective waits for the step's work"))
    del scan, rows
    torch.cuda.empty_cache()

    # -- grid_session -------------------------------------------------------------
    served = {}
    for _, agreement, ids in asyncs[0]["answers"]:
        served.setdefault(agreement.version, []).append(ids)
    replay, scan_rows = _grid_session_check(torch, np, rt, sessions, su, si,
                                            cfg, queries, served)

    # -- grid_async ---------------------------------------------------------------
    emit("grid_async", stream="synth_stream(MOVIELENS_25M, seed=0)",
         cut=f"first {GRID_SESSION_EVENTS} events",
         grid=[cfg.grid.n_i, cfg.grid.g], ranks=len(asyncs),
         publish=f"every {GRID_SESSION_EVERY}, async",
         service=f"threaded, closed loop, {GRID_ASYNC_QUERY_BATCH} ids a "
                 f"batch, at least {GRID_ASYNC_BATCHES} batches",
         **_grid_async_check(np, asyncs, sessions, cfg, replay, scan_rows,
                             int(su.size)))
    del sessions, asyncs, replay, run
    torch.cuda.empty_cache()

    # -- grid_agree ---------------------------------------------------------------
    # drift_backends_agree's configurations and its scan runs, and DISGD
    # under compressed() with its own.
    sc = make_scenario("abrupt", events=DRIFT_SMALL_EVENTS, seed=0, at=0.3)
    cases, scans = {}, {}
    for algo, policy in (("dics", "adaptive"), ("bpr", "adaptive"),
                         ("disgd", "fixed"), ("disgd", "compressed")):
        cut = DRIFT_SMALL_CUT.get(algo, sc.n)
        hyper = rt.get_algorithm(algo).default_hyper()._replace(
            u_cap=256, i_cap=64)
        base = rt.StreamConfig(algorithm=algo, grid=rt.GridSpec(2),
                               micro_batch=256, hyper=hyper, backend="scan",
                               device=DEVICE)
        cfg_p = (dataclasses.replace(base,
                                     storage=rt.StoragePolicy.compressed())
                 if policy == "compressed" else _drift_cfgs(base)[policy])
        name = f"{algo}.{policy}"
        cases[name] = (sc.users[:cut], sc.items[:cut], cfg_p)
        scans[name] = drift_scans.get(name)
    eu, ei = sc.users[:GRID_ELASTIC_EVENTS], sc.items[:GRID_ELASTIC_EVENTS]
    eq = _grid_session_queries(np, eu, known=256, unknown=64)
    elastic = [(eu, ei, dataclasses.replace(cases["disgd.fixed"][2],
                                            forgetting=None), eq),
               (eu, ei, dataclasses.replace(cases["dics.adaptive"][2],
                                            drift=None), eq)]
    service = ((elastic[0][2], elastic[1][2]), eu, ei, eq)
    # A stale checkpoint of another cut would be restored by both sides.
    shutil.rmtree(GRID_ELASTIC_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    run = mesh_lib.run_on_ranks(_grid_agree_rank, 4, "cuda",
                                list(cases.values()), elastic, service,
                                timeout=GRID_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    out = {}
    for j, (name, (cu, ci, ccfg)) in enumerate(cases.items()):
        rows = [r[0][j] for r in run.results]
        scan = scans[name] or rt.run_stream(cu, ci, ccfg)
        err = _grid_agrees(np, rows, scan, ccfg, f"grid_agree.{name}")
        out[name] = dict(**_grid_row(run, rows, scan,
                                     _steps(cu.size, ccfg), int(cu.size)),
                         max_abs_err=err,
                         scan_from=("drift_backends_agree"
                                    if scans[name] else "this phase"))
    if out["dics.adaptive"]["fires"] < 1:
        fail("grid_agree: DICS adaptive never fired")
    emit("grid_agree", stream=f"make_scenario('abrupt', events="
         f"{DRIFT_SMALL_EVENTS}, seed=0, at=0.3)",
         cut={a: f"first {n} events" for a, n in DRIFT_SMALL_CUT.items()},
         grid=[2, 2], u_cap=256, i_cap=64, micro_batch=256, run_s=spawn_s,
         rtol=STREAM_RTOL, atol=STREAM_ATOL, runs=out)

    # -- grid_elastic -------------------------------------------------------------
    emit("grid_elastic", stream=f"make_scenario('abrupt', events="
         f"{DRIFT_SMALL_EVENTS}, seed=0, at=0.3)",
         cut=f"first {GRID_ELASTIC_EVENTS} events", ranks=len(run.results),
         runs={e[2].algorithm: _grid_elastic_check(
             torch, np, rt, [r[1][j] for r in run.results], *e)
             for j, e in enumerate(elastic)})

    # -- grid_service -------------------------------------------------------------
    emit("grid_service", stream=f"make_scenario('abrupt', events="
         f"{DRIFT_SMALL_EVENTS}, seed=0, at=0.3)",
         cut=f"first {GRID_ELASTIC_EVENTS} events", ranks=len(run.results),
         publish=f"every {GRID_SESSION_EVERY}, async",
         autoscale=f"from GridSpec.rect(1, 1), micro-batch 64, capacity "
                   f"factor 0.25, {GRID_AUTOSCALE_ROUNDS} ingests of 512 "
                   f"random events",
         **_grid_service_check(torch, np, rt, [r[2] for r in run.results],
                               *service))

    # -- grid_nccl ----------------------------------------------------------------
    ncfg = dataclasses.replace(cases["disgd.fixed"][2],
                               grid=rt.GridSpec.rect(1, 1))
    nu, ni = sc.users[:GRID_NCCL_EVENTS], sc.items[:GRID_NCCL_EVENTS]
    scfg = dataclasses.replace(ncfg, forgetting=None)
    su, si = nu[:GRID_NCCL_SESSION_EVENTS], ni[:GRID_NCCL_SESSION_EVENTS]
    nq = _grid_session_queries(np, su, known=64, unknown=16)
    t0 = time.perf_counter()
    run = mesh_lib.run_on_ranks(_grid_nccl_rank, 1, "cuda",
                                [(nu, ni, ncfg)], (su, si, scfg, nq),
                                timeout=GRID_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    if run.backend != "nccl":
        fail(f"grid_nccl: the launcher chose {run.backend}")
    rows = [run.results[0][0][0]]
    scan = rt.run_stream(nu, ni, ncfg)
    err = _grid_agrees(np, rows, scan, ncfg, "grid_nccl")
    # The async session against a sync scan session (the same versions:
    # the grid never coalesces), replayed at the versions the reader got.
    got = run.results[0][1]
    if got["errors"] or got["alive"] or len(got["reads"]) != GRID_NCCL_READS:
        fail(f"grid_nccl: the reader failed: {got['errors']}")
    served = {}
    for _, agreement in got["reads"]:
        served.setdefault(agreement.version, []).append(nq)
    s = rt.StreamSession(scfg, publish=rt.PublishPolicy(every=1,
                                                        mode="sync"))
    replay = _replayed(rt, s, served)
    half = su.size // 2
    s.ingest(su[:half], si[:half])
    res = s.ingest(su[half:], si[half:])
    for j, (answer, agreement) in enumerate(got["reads"]):
        if not _replay_equal(np, answer, agreement, nq, replay):
            fail(f"grid_nccl: read {j} differs from the scan replay")
    if not (_bits_same(np, got["bits"], res.recall.bits())
            and got["digests"] == _row_digests(s.states, 1)[0]
            and all(np.array_equal(got["final"][k], v)
                    for k, v in _answer(s.recommend(nq)).items()
                    if k in ("ids", "scores", "known", "fallbacks"))):
        fail("grid_nccl: the async session differs from scan")
    if got["store"]["coalesced"]:
        fail(f"grid_nccl: {got['store']['coalesced']} publishes coalesced")
    emit("grid_nccl", **_grid_row(run, rows, scan,
                                  _steps(nu.size, ncfg), int(nu.size)),
         policy="lru (bench_drift)", grid=[1, 1], run_s=spawn_s,
         sync_debug="error inside every step, async boundary and "
                    "publish_async",
         session=dict(publish="every 1, async", events=int(su.size),
                      reads=len(got["reads"]),
                      versions_read=[a.version for _, a in got["reads"]],
                      async_rotations=got["store"]["async_rotations"]),
         max_abs_err=err)


def _llm_phases(torch, np, dev):
    """h2o-danube-1.8b served at full size through the port, the prefill
    + decode consistency check, and K7 held against its plain version.
    Returns the K7 kernel row."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.factory import build

    # -- 10. llm_serve -----------------------------------------------------------
    cfg = get_config(LLM_ARCH)
    bundle = build(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    numel = sum(p.numel() for p in params.parameters())
    pipe = TokenPipeline(cfg.vocab, seed=0)
    prompts = torch.as_tensor(pipe.sample(LLM_BATCH, LLM_PROMPT), device=dev)
    # Warm-up on a short prompt: cuBLAS handles, the allocator.
    serve.generate(bundle, params, {"tokens": prompts[:, :256]}, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens, t = serve.generate(bundle, params, {"tokens": prompts},
                               LLM_DECODE_STEPS + 1)
    counts = ops.launch_counts()
    if counts["swa_attention"] != cfg.n_layers:
        fail(f"swa_attention launched {counts['swa_attention']} times in one "
             f"prefill of {cfg.n_layers} layers")
    tokens = tokens.cpu()
    if tokens.shape != (LLM_BATCH, LLM_DECODE_STEPS + 1) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        fail(f"llm_serve: generated tokens {tuple(tokens.shape)} out of range")
    emit("llm_serve", arch=cfg.name, source=cfg.source,
         layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
         kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, window=cfg.window,
         param_count=cfg.param_count(), numel=numel, weights="f32 random, "
         "torch.Generator seeded 0", init_s=init_s, batch=LLM_BATCH,
         prompt_len=LLM_PROMPT, prompts="TokenPipeline(32000, seed=0)", **t,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=counts, first_tokens_request0=tokens[0, :8].tolist())
    del tokens
    _profile_llm(torch, bundle, params, prompts)

    # -- 11. llm_consistency -----------------------------------------------------
    seq = torch.as_tensor(pipe.sample(LLM_BATCH, LLM_PROMPT + 1), device=dev)
    with torch.no_grad():
        _, caches = bundle.prefill(params, {"tokens": seq[:, :-1]})
        x1 = tfm.embed_tokens(params, seq[:, -1:], cfg)
        h1, _ = tfm.decode_step(params, x1, cfg, caches)
        got = tfm.logits_from_hidden(params, h1, cfg)[..., :cfg.vocab]
        del caches, h1
        ops.reset_launch_counts()
        want, _ = bundle.prefill(params, {"tokens": seq})
        ragged = ops.launch_counts()["swa_attention"]
        want = want[..., :cfg.vocab]
    if ragged != cfg.n_layers:
        fail(f"prefill over {LLM_PROMPT + 1} tokens launched swa_attention "
             f"{ragged} times")
    err, disagree = _logits_agree(np, got, want, "llm_consistency")
    emit("llm_consistency", batch=LLM_BATCH, prefill=LLM_PROMPT,
         full=LLM_PROMPT + 1, scaled_max_abs_err=err, tol=LOGIT_TOL,
         greedy_disagree_near_ties=disagree, near_tie_gap=LOGIT_GAP,
         ragged_swa_launches=ragged)
    del got, want
    torch.cuda.empty_cache()

    # -- 12. swa_attention against its plain version -----------------------------
    row = _swa_row(torch, np, params, cfg, {"tokens": prompts},
                   {"tokens": seq}, counts)
    del params
    torch.cuda.empty_cache()
    return [row]


def _profile_llm(torch, bundle, params, prompts, decode_steps=8,
                 phase="llm_profile"):
    """Where the serving time goes: one prefill, then ``decode_steps``
    decode steps, each window under ``torch.profiler`` (device activity
    only). Device busy share = summed kernel time / the window's wall."""
    from torch.profiler import ProfilerActivity, profile

    cfg = bundle.cfg
    out = {}
    state = {}

    def prefill():
        logits, state["caches"] = bundle.prefill(params, {"tokens": prompts})
        state["tok"] = torch.argmax(logits[..., : cfg.vocab], dim=-1).to(
            torch.int32)

    def decode():
        for _ in range(decode_steps):
            state["tok"], state["caches"] = bundle.decode(
                params, state["caches"], state["tok"])

    for name, fn in (("prefill", prefill), ("decode", decode)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        rows, busy_ms = _device_rows(prof)
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "device_busy_share": busy_ms / wall_ms,
                     "launches": sum(r[1] for r in rows),
                     "top": [{"kernel": k[:90], "ms": us / 1e3, "count": c}
                             for us, c, k in rows[:8]]}
    emit(phase, batch=prompts.shape[0], prompt_len=prompts.shape[1],
         decode_steps=decode_steps, **out)
    del state
    torch.cuda.empty_cache()


def _layer0_qkv(torch, params, cfg, batch):
    """Layer 0's q / k / v (roped, bf16, contiguous) for ``batch`` (a
    prefill's batch dict: tokens, a VLM's patches, an audio model's
    frames)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.factory import _embed_inputs
    from repro_torch.models.layers import attention as attn_lib

    with torch.no_grad():
        x, positions = _embed_inputs(params, batch, cfg)
        xn = tfm._norm(cfg)(params.layers[0].ln1, x, cfg.norm_eps)
        return tuple(t.contiguous() for t in attn_lib._qkv(
            params.layers[0].attn, xn, positions, cfg))


def _head_slices(n_heads, g, hq=8):
    """(q heads, their kv heads) in slices of about ``hq`` q heads that
    never split a kv head's group across two slices, nor give a slice a
    kv head it does not read: whole groups where the group is at most
    ``hq`` (danube's 4, dbrx's 6), else a divisor of the group (granite's
    48, in slices of 8 reading one kv head)."""
    hq = g * max(1, hq // g) if g <= hq else math.gcd(g, hq)
    for h in range(0, n_heads, hq):
        yield slice(h, h + hq), slice(h // g, (h + hq - 1) // g + 1)


def _swa_errors(torch, q, k, v, outs, kw):
    """Hold each ``outs[name]`` [B, Hq, S, D] to the plain version on q /
    k / v, in slices of one request and about 8 q heads
    (``_head_slices``; the plain version's [8, S, S] f32 logits). Per
    name: the max abs error, the max over rows of |got - want|_2 /
    |want|_2 (a row norm below 1e-3 of its slice's mean counts as that
    floor) and whether ``allclose`` at the JAX test's rtol / atol holds;
    and the plain output's RMS."""
    from repro_torch.kernels import ref

    g = q.shape[1] // k.shape[1]
    errs = {n: {"max_abs_err": 0.0, "max_row_rel_err": 0.0, "allclose": True}
            for n in outs}
    sq = 0.0
    for bi in range(q.shape[0]):
        for qs, kv in _head_slices(q.shape[1], g):
            want = ref.swa_attention(q[bi:bi + 1, qs], k[bi:bi + 1, kv],
                                     v[bi:bi + 1, kv], **kw).float()
            sq += want.square().sum().item()
            norm = want.norm(dim=-1)
            norm = norm.clamp_min(1e-3 * norm.mean().item())
            for name, out in outs.items():
                got = out[bi:bi + 1, qs].float()
                d = got - want
                e = errs[name]
                e["max_abs_err"] = max(e["max_abs_err"], d.abs().max().item())
                e["max_row_rel_err"] = max(e["max_row_rel_err"], (
                    d.norm(dim=-1) / norm).max().item())
                e["allclose"] &= torch.allclose(got, want, rtol=SWA_RTOL,
                                                atol=SWA_ATOL)
    return errs, math.sqrt(sq / q.numel())


def _swa_row(torch, np, params, cfg, prompts, seq, counts, instance=None):
    """K7 against its plain version at a serving path's full shape: layer
    0's real q / k / v of the served prompts (danube: S 8,192) and of the
    ragged sequence (S + 1), and unit-variance q / k / v of the prompts'
    shape and one token longer, each held by ``_swa_hold``; on the
    prompts' shape the kernel with a wrong mask must fail the same check.
    ``prompts`` and ``seq`` are prefill batch dicts. Returns the
    kernels-line row (``instance`` names another shape of K7)."""
    from repro_torch.kernels import ops, ref

    kw = dict(window=cfg.window, causal=cfg.causal)
    q, k, v = _layer0_qkv(torch, params, cfg, prompts)
    gen = torch.Generator(device=q.device).manual_seed(0)
    checks = {}
    for what, qkv in (
            ("real", (q, k, v)),
            ("real_ragged", _layer0_qkv(torch, params, cfg, seq)),
            ("unit", None), ("unit_ragged", None)):
        if qkv is None:
            s = q.shape[2] + what.endswith("ragged")
            qkv = tuple(torch.randn(
                (q.shape[0], h, s, cfg.head_dim), generator=gen,
                device=q.device, dtype=torch.bfloat16)
                for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
        checks[what] = _swa_hold(torch, qkv, cfg, f"{cfg.name}, {what}",
                                 unit=what.startswith("unit"),
                                 wrong=not what.endswith("ragged"))
        del qkv
    torch.cuda.empty_cache()

    ms = _time_ms(torch, lambda: ops.swa_attention(q, k, v, **kw), reps=10)
    device_ms = _time_ms(torch, lambda: ops.swa_attention(q, k, v, **kw),
                         reps=10, cover_enqueue=True)
    b, s, d = q.shape[0], q.shape[2], q.shape[3]
    g = cfg.n_heads // cfg.n_kv_heads

    def plain():
        # The plain version's [8, S, S] f32 logits fit; the full input in
        # slices of one request and about 8 q heads.
        for bi in range(b):
            for qs, kv in _head_slices(cfg.n_heads, g):
                ref.swa_attention(q[bi:bi + 1, qs], k[bi:bi + 1, kv],
                                  v[bi:bi + 1, kv], **kw)

    plain_ms = _time_ms(torch, plain, reps=2)
    lib_ms, lib_device_ms, lib_err = _sdpa_ms(torch, q, k, v, cfg)
    pairs = _window_pairs(np, s, cfg.window, cfg.causal)
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, o, k, v bf16
    flops = 4 * pairs * d * b * cfg.n_heads
    bound, by = _bound_ms(n_bytes, flops, bf16=True)
    emit("swa_vs_plain", instance=instance or cfg.name,
         row_rtol=SWA_ROW_RTOL, rtol=SWA_RTOL, atol=SWA_ATOL,
         shape=f"B={b} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} D={d}",
         checks=checks, library_vs_kernel_max_abs_err=lib_err)
    row = dict(
        name="swa_attention", route="cuda", matched=True,
        source="src/repro_torch/kernels/csrc/swa_attention.cu",
        replaces="src/repro/kernels/swa_attention.py:35",
        launches=counts["swa_attention"],
        max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        max_row_rel_err=max(c["max_row_rel_err"] for c in checks.values()),
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=lib_ms, device_ms=device_ms,
        library_device_ms=lib_device_ms,
        library="scaled_dot_product_attention(attn_mask=window, "
                "enable_gqa=True)" if cfg.window is not None else
                f"scaled_dot_product_attention(is_causal={cfg.causal})",
        bytes=n_bytes, flops=flops, window_pairs=pairs,
        shape=f"B={b} Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} S={s} D={d} "
              f"window={cfg.window} bf16")
    if instance is not None:
        row["instance"] = instance
    return row


def _swa_hold(torch, qkv, cfg, what, unit, wrong=True):
    """K7 on ``qkv`` at ``cfg``'s mask, held to its plain version: the max
    row relative error within SWA_ROW_RTOL, and for unit-variance inputs
    (``unit``) ``allclose`` at rtol = atol = SWA_RTOL too. With ``wrong``,
    the kernel run with a wrong mask (a window: none, or 64 keys short; no
    window: 64 keys short, or the other causality) must fail the same
    check. Returns the check's record."""
    from repro_torch.kernels import ops

    kw = dict(window=cfg.window, causal=cfg.causal)
    s = qkv[0].shape[2]
    bad = {}
    if wrong and cfg.window is None:
        bad = {f"window={s - 64}": dict(window=s - 64, causal=cfg.causal),
               f"causal={not cfg.causal}": dict(window=None,
                                                 causal=not cfg.causal)}
    elif wrong:
        bad = {"window=None": dict(window=None, causal=cfg.causal),
               f"window={cfg.window - 64}": dict(window=cfg.window - 64,
                                                  causal=cfg.causal)}
    outs = {"kernel": ops.swa_attention(*qkv, **kw)}
    outs.update((n, ops.swa_attention(*qkv, **w)) for n, w in bad.items())
    errs, rms = _swa_errors(torch, *qkv, outs, kw)
    e = errs.pop("kernel")
    if e["max_row_rel_err"] > SWA_ROW_RTOL or (unit and not e["allclose"]):
        fail(f"swa_attention ({what}, S={s}): max row relative error "
             f"{e['max_row_rel_err']} (limit {SWA_ROW_RTOL}), max abs error "
             f"{e['max_abs_err']} (allclose rtol=atol={SWA_RTOL}: "
             f"{e['allclose']}), RMS of the plain output {rms}")
    for name, m in errs.items():
        if m["max_row_rel_err"] <= SWA_ROW_RTOL and (
                not unit or m["allclose"]):
            fail(f"swa_attention ({what}): the check passes a kernel run "
                 f"with {name}")
    return dict(s=s, rms_want=rms, **e, wrong_window_caught={
        n: {"max_row_rel_err": m["max_row_rel_err"],
            "allclose_alone": not m["allclose"]} for n, m in errs.items()})


def _sdpa_ms(torch, q, k, v, cfg):
    """The library yardstick: one ``scaled_dot_product_attention`` call
    with a bool window mask (or ``is_causal`` without a window) and
    ``enable_gqa``, on a fused backend (the math backend would
    materialise [B, Hq, S, S] in f32). Returns its ms, its card time alone
    and its max abs difference from the kernel's output."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import ops

    if cfg.window is None:
        def call():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION]):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=cfg.causal, enable_gqa=True)
    else:
        r = torch.arange(q.shape[2], device=q.device)
        mask = (r[None, :] <= r[:, None]) & (
            r[None, :] > r[:, None] - cfg.window)

        def call():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION]):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)

    err = (call().float() - ops.swa_attention(
        q, k, v, window=cfg.window, causal=cfg.causal).float()
           ).abs().max().item()
    return (_time_ms(torch, call, reps=5),
            _time_ms(torch, call, reps=5, cover_enqueue=True), err)


# -- MoE and full-attention serving ------------------------------------------


def _moe_phases(torch, np, dev):
    """olmoe-1b-7b served at full size through the port, its prefill +
    decode consistency, its MoE layer on the card against the host, K7
    at its shape against the plain version, then the other four archs
    cut in depth. Returns the K7 row of olmoe's shape."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.factory import build
    from repro_torch.models.layers import moe

    # -- 13. moe_serve -----------------------------------------------------------
    cfg = get_config(MOE_ARCH)
    bundle = build(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    numel = sum(p.numel() for p in params.parameters())
    pipe = TokenPipeline(cfg.vocab, seed=0)
    prompts = torch.as_tensor(pipe.sample(MOE_BATCH, MOE_PROMPT), device=dev)
    serve.generate(bundle, params, {"tokens": prompts[:, :256]}, 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens, t = serve.generate(bundle, params, {"tokens": prompts},
                               MOE_DECODE_STEPS + 1)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if counts["swa_attention"] != cfg.n_layers:
        fail(f"moe_serve: swa_attention launched {counts['swa_attention']} "
             f"times in one prefill of {cfg.n_layers} layers")
    tokens = tokens.cpu()
    if tokens.shape != (MOE_BATCH, MOE_DECODE_STEPS + 1) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        fail(f"moe_serve: generated tokens {tuple(tokens.shape)} out of range")
    no_sync, _ = _decode_without_sync(torch, bundle, params,
                                      {"tokens": prompts[:, :256]})
    e = cfg.moe
    emit("moe_serve", arch=cfg.name, source=cfg.source, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.head_dim, window=cfg.window, experts=e.n_experts,
         top_k=e.top_k, d_expert=e.d_expert,
         capacity_factor=e.capacity_factor, group_size=e.group_size,
         param_count=cfg.param_count(),
         active_param_count=cfg.active_param_count(), numel=numel,
         weights="f32 random, torch.Generator seeded 0", init_s=init_s,
         batch=MOE_BATCH, prompt_len=MOE_PROMPT,
         prompts=f"TokenPipeline({cfg.vocab}, seed=0)", **t,
         max_memory_allocated=peak, launches=counts,
         decode_under_sync_debug_error=no_sync,
         first_tokens_request0=tokens[0, :8].tolist())
    del tokens
    _profile_llm(torch, bundle, params, prompts, phase="moe_profile")

    # -- 14. moe_consistency -----------------------------------------------------
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=8.0))
    bundle8 = build(cfg8, device=DEVICE)
    b, s = MOE_CONSISTENCY_BATCH, MOE_CONSISTENCY_PROMPT
    seq = torch.as_tensor(pipe.sample(b, s + 1), device=dev)
    with torch.no_grad():
        _, caches = bundle8.prefill(params, {"tokens": seq[:, :-1]})
        x1 = tfm.embed_tokens(params, seq[:, -1:], cfg8)
        h1, _ = tfm.decode_step(params, x1, cfg8, caches)
        got = tfm.logits_from_hidden(params, h1, cfg8)[..., :cfg.vocab]
        del caches, h1
        ops.reset_launch_counts()
        want, _ = bundle8.prefill(params, {"tokens": seq})
        ragged = ops.launch_counts()["swa_attention"]
        want = want[..., :cfg.vocab]
    if ragged != cfg.n_layers:
        fail(f"moe_consistency: a prefill over {s + 1} tokens launched "
             f"swa_attention {ragged} times")
    groups = {n: moe.group_shape(n, cfg8.moe)
              for n in (b * s, b * (s + 1), b)}
    if any(cap < gs for _, gs, cap in groups.values()):
        fail(f"moe_consistency: a group can drop tokens: {groups}")
    err, disagree = _logits_agree(np, got, want, "moe_consistency")
    emit("moe_consistency", batch=b, prefill=s, full=s + 1,
         capacity_factor=8.0,
         groups_gs_cap={str(n): [gs, cap] for n, (_, gs, cap) in
                        groups.items()},
         scaled_max_abs_err=err, tol=LOGIT_TOL,
         greedy_disagree_near_ties=disagree, near_tie_gap=LOGIT_GAP,
         ragged_swa_launches=ragged)
    del got, want
    torch.cuda.empty_cache()

    # -- 15. moe_routing_card ----------------------------------------------------
    _moe_routing_card(torch, np, params, cfg)

    # -- 16. swa_attention at olmoe's shape --------------------------------------
    row = _swa_row(torch, np, params, cfg, {"tokens": prompts},
                   {"tokens": seq}, counts, instance=cfg.name)
    del params, bundle, bundle8
    torch.cuda.empty_cache()

    # -- 17. zoo_serve -----------------------------------------------------------
    _zoo_serve(torch, np, dev)
    return [row]


def _decode_without_sync(torch, bundle, params, batch):
    """One decode step after a prefill of ``batch``, under
    ``torch.cuda.set_sync_debug_mode("error")``: a step that waits for
    the card (``.item()``, ``nonzero``, a blocking copy) fails the run.
    Returns ("passed", the prefill's last-position logits)."""
    cfg = bundle.cfg
    logits, caches = bundle.prefill(params, batch)
    tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok, caches = bundle.decode(params, caches, tok)
    except RuntimeError as err:
        fail(f"{cfg.name}: a decode step synchronised with the card: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return "passed", logits


def _tie_free_tokens(torch, router, n: int):
    """``n`` token activations [1, n, D] (bf16) whose router logits are
    each a random permutation of E levels 0.1 apart (least squares
    through the router's columns), so that no token's k-th and (k+1)-th
    router probabilities nearly tie: the condition for comparing two
    devices' choices exactly. The caller checks it on the probabilities
    the layer computes."""
    n_e = router.shape[1]
    gen = torch.Generator().manual_seed(0)
    levels = torch.argsort(torch.rand((n, n_e), generator=gen), dim=-1)
    z = 0.1 * levels.double()
    w = router.double()
    x = z @ torch.linalg.solve(w.T @ w, w.T)         # [n, D]: x @ w = z
    return x.to(torch.bfloat16)[None]


def _moe_routing_card(torch, np, params, cfg):
    """Layer 0's MoE at full width on MOE_ROUTING_TOKENS tokens, on the
    card and on the host CPU from the same parameters and inputs."""
    from repro_torch.models.layers import moe

    e = cfg.moe
    layer = dict(params.layers[0].moe.named_parameters())
    host = {k: v.detach().cpu() for k, v in layer.items()}
    x = _tie_free_tokens(torch, host["router"], MOE_ROUTING_TOKENS)
    g, gs, cap = moe.group_shape(MOE_ROUTING_TOKENS, e)
    xt = x.reshape(g, gs, cfg.d_model)
    want = moe.route(host, xt, e)
    got = moe.route(layer, xt.to(layer["router"].device), e)
    ranked = torch.sort(want.probs, dim=-1, descending=True).values
    gaps = ranked[..., :e.top_k] - ranked[..., 1:e.top_k + 1]
    min_gap = gaps.min().item()
    if min_gap < MOE_NEAR_TIE:
        fail(f"moe_routing_card: router probabilities {min_gap} apart where "
             f"the top-{e.top_k} ends (near-tie limit {MOE_NEAR_TIE})")
    for f in ("top_i", "pos", "kept"):
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
            fail(f"moe_routing_card: {f} differs between the card and the "
                 "host")
    t0 = time.perf_counter()
    y_host, aux_host = moe.moe_apply(host, x, cfg)
    host_s = time.perf_counter() - t0
    y, aux = moe.moe_apply(layer, x.to(layer["router"].device), cfg)
    y, y_host = y.float().cpu(), y_host.float()
    scale = max(y_host.abs().max().item(), 1.0)
    err = (y - y_host).abs().max().item() / scale
    aux_err = abs(aux.item() / aux_host.item() - 1)
    if not (err <= MOE_OUT_TOL and aux_err <= MOE_AUX_RTOL
            and torch.isfinite(y).all()):
        fail(f"moe_routing_card: scaled output error {err} (limit "
             f"{MOE_OUT_TOL}), aux relative error {aux_err} (limit "
             f"{MOE_AUX_RTOL})")
    emit("moe_routing_card", tokens=MOE_ROUTING_TOKENS, groups=g,
         group_size=gs, capacity=cap,
         inputs="router logits a permutation of E levels 0.1 apart",
         min_gap_at_top_k=min_gap, near_tie_limit=MOE_NEAR_TIE,
         dropped=int((~want.kept).sum()),
         assignments=int(want.kept.numel()), routing="exactly equal",
         scaled_max_abs_err=err, tol=MOE_OUT_TOL, aux=aux.item(),
         aux_host=aux_host.item(), aux_rel_err=aux_err, host_s=host_s)


def _zoo_serve(torch, np, dev):
    """moonshot, dbrx, stablelm-3b and granite-34b at full width, cut in
    depth (ZOO_LAYERS), each through ``serve.generate``: ZOO_BATCH prompts
    of ZOO_PROMPT tokens, ZOO_DECODE_STEPS greedy steps; K7 launches =
    layers, the warm-up prefill's logits finite, tokens in range. Then K7
    on layer 0's real q / k / v of the prompts is held to its plain version
    (``_swa_hold``: dbrx's group 6, granite's 48, stablelm's D 80), a
    kernel run with a wrong mask failing the same check."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.factory import build

    rows = {}
    for arch, layers in ZOO_LAYERS.items():
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, n_layers=layers)
        bundle = build(cfg, device=DEVICE)
        t0 = time.perf_counter()
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        prompts = torch.as_tensor(TokenPipeline(cfg.vocab, seed=0).sample(
            ZOO_BATCH, ZOO_PROMPT), device=dev)
        logits, caches = bundle.prefill(params, {"tokens": prompts[:, :128]})
        bundle.decode(params, caches, torch.argmax(
            logits[..., :cfg.vocab], dim=-1).to(torch.int32))   # warm-up
        if not bool(torch.isfinite(logits.float()).all()):
            fail(f"zoo_serve: {cfg.name} prefill logits not finite")
        del logits, caches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        tokens, t = serve.generate(bundle, params, {"tokens": prompts},
                                   ZOO_DECODE_STEPS + 1)
        launches = ops.launch_counts()["swa_attention"]
        tokens = tokens.cpu()
        if launches != cfg.n_layers:
            fail(f"zoo_serve: {cfg.name} launched swa_attention {launches} "
                 f"times in one prefill of {cfg.n_layers} layers")
        if not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
            fail(f"zoo_serve: {cfg.name} generated tokens out of range")
        swa_check = _swa_hold(torch, _layer0_qkv(torch, params, cfg,
                                                 {"tokens": prompts}),
                              cfg, f"zoo_serve, {cfg.name}", unit=False)
        rows[cfg.name] = dict(
            source=cfg.source, layers=cfg.n_layers, full_layers=full.n_layers,
            d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, d_ff=cfg.d_ff,
            moe=None if cfg.moe is None else dataclasses.asdict(cfg.moe),
            numel=sum(p.numel() for p in params.parameters()),
            init_s=init_s, **t, swa_launches=launches, swa_check=swa_check,
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            first_tokens_request0=tokens[0].tolist())
        del params, bundle, prompts, tokens
        torch.cuda.empty_cache()
    emit("zoo_serve", batch=ZOO_BATCH, prompt_len=ZOO_PROMPT,
         decode_steps=ZOO_DECODE_STEPS, swa_row_rtol=SWA_ROW_RTOL,
         weights="f32 random, torch.Generator seeded 0", archs=rows)


# -- the hybrid, xLSTM, VLM and audio families --------------------------------


def _family_batch(torch, cfg, positions: int, dev, batch=ZOO_BATCH):
    """A family's served batch over ``positions`` on the card:
    ``serve.serve_batch``'s tokens (a VLM's patches first), or an audio
    model's ``make_batch`` (frames, span mask, targets; seed 0)."""
    from repro_torch.data.tokens import make_batch
    from repro_torch.launch import serve

    if cfg.decoder:
        return serve.serve_batch(cfg, batch, positions, dev)
    return {k: torch.as_tensor(v, device=dev) for k, v in
            make_batch(cfg, batch, positions, seed=0).items()}


def _family_phases(torch, np, dev, infos):
    """Phases 18-20: each family served whole (phi-3-vision's K7 row
    while its parameters live), then the consistency checks. Returns the
    K7 row of phi-3-vision's shape."""
    rows, kernels = {}, []
    for arch in FAMILY_PROMPT:
        rows[arch] = _family_serve(torch, np, dev, arch, infos, kernels)
    emit("family_serve", batch=ZOO_BATCH, decode_steps=FAMILY_DECODE_STEPS,
         swa_row_rtol=SWA_ROW_RTOL,
         weights="f32 random, torch.Generator seeded 0", archs=rows)
    _family_consistency(torch, np, dev)
    return kernels


def _family_serve(torch, np, dev, arch, infos, kernels):
    """One family at full width and depth: served, its checks made;
    phi-3-vision's K7 row appended to ``kernels``. Returns the arch's
    record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.factory import _embed_inputs, build

    cfg = get_config(arch)
    n_attn = 0 if cfg.family == "ssm" else cfg.n_layers
    bundle = build(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = _family_batch(torch, cfg, FAMILY_PROMPT[arch], dev)
    # Warm-up on a short input: cuBLAS handles, the allocator.
    logits, caches = bundle.prefill(params, _family_batch(
        torch, cfg, cfg.vlm_patches + 128, dev))
    if cfg.decoder:
        bundle.decode(params, caches, torch.argmax(
            logits[..., :cfg.vocab], dim=-1).to(torch.int32))
    del logits, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rec = {}
    if cfg.decoder:
        tokens, t = serve.generate(bundle, params, batch,
                                   FAMILY_DECODE_STEPS + 1)
        launches = ops.launch_counts()["swa_attention"]
        tokens = tokens.cpu()
        if tokens.shape != (ZOO_BATCH, FAMILY_DECODE_STEPS + 1) or not bool(
                ((tokens >= 0) & (tokens < cfg.vocab)).all()):
            fail(f"family_serve: {cfg.name} generated tokens "
                 f"{tuple(tokens.shape)} out of range")
        peak = torch.cuda.max_memory_allocated()
        rec["decode_under_sync_debug_error"], logits = _decode_without_sync(
            torch, bundle, params, batch)
        if not bool(torch.isfinite(logits.float()).all()):
            fail(f"family_serve: {cfg.name} prefill logits not finite")
        first = tokens[0].tolist()
    else:
        t0 = time.perf_counter()
        logits, caches = bundle.prefill(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.launch_counts()["swa_attention"]
        peak = torch.cuda.max_memory_allocated()
        del caches
        s = batch["frames"].shape[1]
        t = {"prefill_ms": 1e3 * secs,
             "prefill_tokens_per_s": ZOO_BATCH * s / secs}
        with torch.no_grad():
            x, positions = _embed_inputs(params, batch, cfg)
            h, _, _ = tfm.forward_full(params, x, positions, cfg)
            frames = tfm.logits_from_hidden(params, h, cfg)[..., :cfg.vocab]
        del x, h
        if frames.shape != (ZOO_BATCH, s, cfg.vocab) or not bool(
                torch.isfinite(frames.float()).all()):
            fail(f"family_serve: {cfg.name} frame logits "
                 f"{tuple(frames.shape)} not finite")
        err, _ = _logits_agree(np, logits[..., :cfg.vocab], frames[:, -1:],
                               f"family_serve, {cfg.name} last frame")
        rec["prefill_vs_frame_logits_scaled_err"] = err
        rec["masked_frames"] = int(batch["mask"].sum().item())
        first = frames[0, :8].argmax(-1).tolist()
        del frames, logits
    if launches != n_attn:
        fail(f"family_serve: {cfg.name} launched swa_attention {launches} "
             f"times in one prefill of {n_attn} attention layers")
    if n_attn:
        rec["swa_check"] = _swa_hold(
            torch, _layer0_qkv(torch, params, cfg, batch), cfg,
            f"family_serve, {cfg.name}", unit=False)
    if cfg.vlm_patches:
        # ptxas allocates every instance within the 168 registers the
        # launch bound leaves; D = 96 keeps 4 packed P registers in local
        # memory (48 B of spill stores a thread) and D = 128 more: kept
        # in the row, as PERF.md section 6 reports them.
        ptxas = _ptxas_entries(infos["swa_attention"].ptxas)
        if f"swa_bf16_kernel<{cfg.head_dim}>" not in ptxas:
            fail(f"swa_attention: no ptxas report of the D = {cfg.head_dim} "
                 f"instance: {sorted(ptxas)}")
        prompts, seq = (_family_batch(torch, cfg, VLM_SWA_SEQ + extra, dev,
                                      VLM_SWA_BATCH) for extra in (0, 1))
        row = _swa_row(torch, np, params, cfg, prompts, seq,
                       {"swa_attention": launches}, instance=cfg.name)
        row["ptxas"] = ptxas
        kernels.append(row)
        del prompts, seq
    rec.update(
        family=cfg.family, source=cfg.source, layers=cfg.n_layers,
        d_model=cfg.d_model, heads=cfg.n_heads,
        kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, window=cfg.window,
        causal=cfg.causal, positions=FAMILY_PROMPT[arch],
        numel=sum(p.numel() for p in params.parameters()), init_s=init_s,
        **t, swa_launches=launches, max_memory_allocated=peak,
        first_ids_request0=first)
    del params, bundle, batch
    torch.cuda.empty_cache()
    return rec


def _family_consistency(torch, np, dev):
    """Phase 19: prefill + one decode step against a full pass, at full
    width and FAMILY_CONSISTENCY_LAYERS (xLSTM: one group)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.factory import build

    rows = {}
    for arch, prompt in FAMILY_CONSISTENCY_PROMPT.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=(
            full.xlstm.slstm_period if full.family == "ssm"
            else FAMILY_CONSISTENCY_LAYERS))
        bundle = build(cfg, device=DEVICE)
        params = bundle.init(torch.Generator(device=dev).manual_seed(0))
        s = cfg.vlm_patches + prompt
        batch = _family_batch(torch, cfg, s + 1, dev)
        prefix = dict(batch, tokens=batch["tokens"][:, :-1])
        with torch.no_grad():
            _, caches = bundle.prefill(params, prefix)
            x1 = tfm.embed_tokens(params, batch["tokens"][:, -1:], cfg)
            h1, _ = tfm.decode_step(params, x1, cfg, caches)
            got = tfm.logits_from_hidden(params, h1, cfg)[..., :cfg.vocab]
            del caches, h1
            want, _ = bundle.prefill(params, batch)
            want = want[..., :cfg.vocab]
        err, disagree = _logits_agree(np, got, want,
                                      f"family_consistency, {cfg.name}")
        rows[cfg.name] = dict(layers=cfg.n_layers, prefill=s, full=s + 1,
                              scaled_max_abs_err=err,
                              greedy_disagree_near_ties=disagree)
        del params, bundle, got, want
        torch.cuda.empty_cache()
    emit("family_consistency", batch=ZOO_BATCH, tol=LOGIT_TOL,
         near_tie_gap=LOGIT_GAP, archs=rows)


# -- LM training ----------------------------------------------------------------


def _row_rel_err(torch, got, want) -> float:
    """Max over rows (the last axis) of |got - want|_2 / |want|_2, a row
    norm below 1e-3 of the mean counting as that floor (``_swa_errors``'
    rule)."""
    got, want = got.float(), want.float()
    norm = want.norm(dim=-1)
    norm = norm.clamp_min(1e-3 * norm.mean().item())
    return ((got - want).norm(dim=-1) / norm).max().item()


def _attention_grad(torch, np, dev, cfg):
    """Phase 21: ``SwaAttention`` against ``ref.swa_attention`` under
    autograd at danube's head layout, B 1 x ATTN_GRAD_SEQ. Returns the
    record and the times for the kernels line."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import ops, ref
    from repro_torch.models.layers.attention import SwaAttention, q_chunk

    s, d = ATTN_GRAD_SEQ, cfg.head_dim
    window, causal = cfg.window, cfg.causal
    qc = q_chunk(s, cfg.q_chunk)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, h, s, d), generator=gen, device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    dout = torch.randn((1, cfg.n_heads, s, d), generator=gen, device=dev,
                       dtype=torch.bfloat16)
    inputs = (q, k, v)

    def function(w=window):
        out = SwaAttention.apply(q, k, v, w, causal, qc)
        return (out,) + torch.autograd.grad(out, inputs, dout)

    def plain():
        out = ref.swa_attention(q, k, v, window=window, causal=causal)
        return (out,) + torch.autograd.grad(out, inputs, dout)

    r = torch.arange(s, device=dev)
    mask = (r[None, :] <= r[:, None]) & (r[None, :] > r[:, None] - window)
    library = "scaled_dot_product_attention(attn_mask=window, enable_gqa=True)"

    def sdpa():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                 enable_gqa=True)
        return (out,) + torch.autograd.grad(out, inputs, dout)

    names = ("out", "dq", "dk", "dv")
    before = ops.launch_counts()["swa_attention"]
    got = function()
    if ops.launch_counts()["swa_attention"] != before + 1:
        fail("attention_grad: the Function did not launch K7 once")
    want = plain()
    errs = {n: _row_rel_err(torch, g, w) for n, g, w in zip(names, got,
                                                            want)}
    abs_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    if max(errs.values()) > SWA_ROW_RTOL:
        fail(f"attention_grad: max row relative errors {errs} beyond "
             f"{SWA_ROW_RTOL}")
    caught = {}
    for name, w in (("window=None", None), (f"window={window - 64}",
                                            window - 64)):
        bad = {n: _row_rel_err(torch, g, x) for n, g, x in
               zip(names, function(w), want)}
        if max(bad.values()) <= SWA_ROW_RTOL:
            fail(f"attention_grad: the check passes a Function run with "
                 f"{name}: {bad}")
        caught[name] = bad
    lib_err = max(_row_rel_err(torch, x, w) for x, w in zip(sdpa(), want))
    del got, want
    torch.cuda.empty_cache()

    ms = _time_ms(torch, function, reps=5)
    plain_ms = _time_ms(torch, plain, reps=3)
    lib_ms = _time_ms(torch, sdpa, reps=5)
    pairs = _window_pairs(np, s, window, causal)
    # Forward: Q.K^T and P.V; backward: dV, dP, dQ, dK (given P): six
    # products of pairs x D a head, in bf16 on the tensor cores; each
    # input (q, k, v, dout) read once, each output (out, dq, dk, dv)
    # written once, in bf16.
    flops = 12 * pairs * d * cfg.n_heads
    n_bytes = 2 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel()
                   + dout.numel())
    bound, by = _bound_ms(n_bytes, flops, bf16=True)
    record = dict(shape=f"B=1 Hq={cfg.n_heads} Hkv={cfg.n_kv_heads} S={s} "
                        f"D={d} window={window} bf16", q_chunk=qc,
                  row_rtol=SWA_ROW_RTOL, max_row_rel_err=errs,
                  max_abs_err=abs_err, wrong_window_caught=caught,
                  library_max_row_rel_err=lib_err, ms=ms, plain_ms=plain_ms,
                  library_ms=lib_ms, library=library, bound_ms=bound,
                  bound_by=by, flops=flops, bytes=n_bytes,
                  window_pairs=pairs)
    emit("attention_grad", **record)
    del q, k, v, dout, mask
    torch.cuda.empty_cache()
    return record


def _train_phases(torch, np, dev):
    """Phases 21-22: the attention Function against its plain version,
    then h2o-danube-1.8b trained whole. Returns the K7 training row."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, make_batch
    from repro_torch.kernels import ops
    from repro_torch.models.factory import build
    from repro_torch.optim import adamw_init, cosine_schedule

    cfg = get_config(LLM_ARCH)
    grad = _attention_grad(torch, np, dev, cfg)

    # -- 22. train_path -------------------------------------------------------
    if not cfg.remat:
        fail(f"{cfg.name}: remat off, expected on for training")
    bundle = build(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    numel = sum(p.numel() for p in params.parameters())
    pipe = TokenPipeline(cfg.vocab, seed=0)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in make_batch(
        cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed, pipeline=pipe).items()}
        for seed in (0, 1)]
    steps = TRAIN_FIXED_STEPS + 1
    per_layer = 2 * cfg.n_layers          # the forward and remat's recompute
    losses, gnorms, step_ms, launches = [], [], [], []
    prof = None
    ops.reset_launch_counts()
    for step in range(steps):
        batch = batches[0] if step < TRAIN_FIXED_STEPS else batches[1]
        lr = cosine_schedule(np.float32(step), peak=TRAIN_PEAK_LR, warmup=0,
                             total=steps)
        before = ops.launch_counts()["swa_attention"]
        profiled = step == steps - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof_step:
            # The second step enqueues its work without a host sync.
            torch.cuda.set_sync_debug_mode("error" if step == 1 else 0)
            try:
                params, opt, metrics = bundle.train_step(
                    params, opt, batch, step, peak_lr=lr)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if profiled:
            prof = prof_step
        launches.append(ops.launch_counts()["swa_attention"] - before)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != [per_layer] * steps:
        fail(f"train_path: swa_attention launched {launches} times a step, "
             f"expected {per_layer} (2 x {cfg.n_layers} layers)")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        fail(f"train_path: losses {losses}, gradient norms {gnorms}")
    fixed = losses[:TRAIN_FIXED_STEPS]
    if not all(a > b for a, b in zip(fixed, fixed[1:])):
        fail(f"train_path: the loss on one batch did not fall: {fixed}")
    rows, busy_ms = _device_rows(prof)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    warm = step_ms[TRAIN_FIXED_STEPS - 1]       # the last unprofiled step
    emit("train_path", arch=cfg.name, source=cfg.source, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.head_dim, window=cfg.window, vocab=cfg.vocab,
         param_count=cfg.param_count(), numel=numel, remat=cfg.remat,
         weights="f32 random, torch.Generator seeded 0", init_s=init_s,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         data="make_batch(seed 0 x 3 steps, seed 1), TokenPipeline(32000, "
              "seed=0)", schedule=f"cosine_schedule(peak={TRAIN_PEAK_LR}, "
                                  f"warmup=0, total={steps})",
         losses=losses, gnorms=gnorms, step_ms=step_ms, warm_step_ms=warm,
         tokens_per_s=tokens / (warm / 1e3), sync_free_step=1,
         swa_launches_per_step=launches, max_memory_allocated=peak,
         profiled_step={"step": steps - 1, "wall_ms": step_ms[-1],
                        "device_busy_ms": busy_ms,
                        "device_busy_share": busy_ms / step_ms[-1],
                        "launches": sum(r[1] for r in rows),
                        "top": [{"kernel": k[:90], "ms": us / 1e3,
                                 "count": c} for us, c, k in rows[:10]]})
    del params, opt, metrics, batches, prof
    torch.cuda.empty_cache()
    return [dict(
        name="swa_attention", route="cuda", matched=True,
        instance=f"{cfg.name} train",
        source="src/repro_torch/kernels/csrc/swa_attention.cu",
        replaces="src/repro/kernels/swa_attention.py:35",
        launches=counts["swa_attention"], launches_per_step=per_layer,
        max_abs_err=grad["max_abs_err"],
        max_row_rel_err=max(grad["max_row_rel_err"].values()),
        ms=grad["ms"], plain_ms=grad["plain_ms"], bound_ms=grad["bound_ms"],
        bound_by=grad["bound_by"], library_ms=grad["library_ms"],
        library=grad["library"], bytes=grad["bytes"], flops=grad["flops"],
        window_pairs=grad["window_pairs"],
        timed="forward + backward: K7 and the plain chunked backward "
              "(models/layers/attention.SwaAttention)",
        shape=grad["shape"])]


# -- sharded training and the dry-run ----------------------------------------

# sharded_train: h2o-danube-1.8b at full width, cut to 2 of its 24 layers,
# on the (data 2, model 2) layout; B 4 x 2,048, two steps at a constant lr.
SHARDED_LAYOUT, SHARDED_LAYERS, SHARDED_BATCH, SHARDED_SEQ = (2, 2), 2, 4, \
    2048
SHARDED_STEPS, SHARDED_LR = 2, 3e-4
# tests/train_parity.py's LOSS_RTOL, GNORM_RTOL, GRAD_TOL and FLIP_FRACTION.
SHARDED_LOSS_RTOL, SHARDED_GNORM_RTOL, SHARDED_GRAD_TOL = 1e-3, 1e-2, 5e-2
SHARDED_FLIP_FRACTION = 0.05
DRYRUN_COMBOS = (("h2o_danube_1p8b", "prefill_32k"),
                 ("h2o_danube_1p8b", "train_4k"),
                 ("olmoe_1b_7b", "decode_32k"))
DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun.json"
DRYRUN_PEAK_RTOL = 0.15
DRYRUN_CODE = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
from repro_torch.launch import dryrun
out = []
for arch, shape in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    r = dryrun.lower_combo(arch, shape)
    r["seconds"] = time.perf_counter() - t0
    out.append(r)
t0 = time.perf_counter()
r = dryrun.lower_recsys(algorithm="disgd")
r["seconds"] = time.perf_counter() - t0
out.append(r)
with open(sys.argv[3], "w") as f:
    json.dump(out, f)
"""


def _start_dryrun():
    """Phase 24's subprocess (the host only, one thread, at a lower
    priority than the script's), stopped at exit if it is still
    running."""
    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_OUT.unlink(missing_ok=True)
    log = open(DRYRUN_OUT.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CODE, str(SRC),
         json.dumps(DRYRUN_COMBOS), str(DRYRUN_OUT)],
        stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        preexec_fn=lambda: os.nice(10))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()

    atexit.register(stop)
    return proc


def _sharded_train_rank(info, cfg, batches, layout):
    """Phase 23 on one rank: its blocks, two steps, its records."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import ctx, fsdp

    mesh = ctx.bind_mesh(make_cpu_mesh(*layout))
    dev = torch.device(info.device)
    t0 = time.perf_counter()
    model = fsdp.shard_model(cfg, mesh, generator=torch.Generator(
        device=dev).manual_seed(0))
    opt = adamw_init(model)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    init_s = time.perf_counter() - t0
    out = {"resident_bytes": fsdp.resident_bytes(model, opt),
           "spec_bytes": fsdp.shard_bytes(cfg, mesh), "init_s": init_s}
    ctx.reset_records()
    ops.reset_launch_counts()
    metrics, step_s = [], []
    for step, batch in enumerate(batches):
        t0 = time.perf_counter()
        model, opt, met = fsdp.train_step(model, opt, batch, step, cfg,
                                          peak_lr=SHARDED_LR)
        metrics.append({k: float(v) for k, v in met.items()})
        step_s.append(time.perf_counter() - t0)
    out.update(metrics=metrics, step_s=step_s,
               records=[tuple(r) for r in ctx.records()],
               launches=ops.launch_counts()["swa_attention"],
               peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda
               else None)
    tree = fsdp.gathered_state(model)["params"]
    if info.rank == 0:
        out["params"] = tree
    return out


def _sharding_phases(torch, np, dev, dryrun_proc):
    """Phases 23-25: sharded training on four ranks against one, the
    dry-run's reports, and its program run for real on the card. The
    dry-run's subprocess is waited for first, so that phase 23's ranks
    have the host to themselves."""
    waited = _dryrun_wait(dryrun_proc)
    _sharded_train(torch, np, dev)
    reports = _dryrun_reports(waited)
    _dryrun_card(torch, reports)


def _sharded_train(torch, np, dev):
    """Phase 23."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.core import convert
    from repro_torch.data.tokens import TokenPipeline, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.factory import build
    from repro_torch.optim import adamw_init

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LLM_ARCH), n_layers=SHARDED_LAYERS)
    pipe = TokenPipeline(cfg.vocab, seed=0)
    batches = [make_batch(cfg, SHARDED_BATCH, SHARDED_SEQ, seed=step,
                          pipeline=pipe) for step in range(SHARDED_STEPS)]
    n_ranks = math.prod(SHARDED_LAYOUT)
    t0 = time.perf_counter()
    run = mesh_lib.run_on_ranks(_sharded_train_rank, n_ranks, DEVICE, cfg,
                                batches, SHARDED_LAYOUT, timeout=600)
    ranks_s = time.perf_counter() - t0
    ranks = run.results
    # The same two steps on one rank, from the same draws.
    bundle = build(cfg, device=DEVICE)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params)
    ops.reset_launch_counts()
    one = []
    for step, batch in enumerate(batches):
        params, opt, met = bundle.train_step(params, opt, batch, step,
                                             peak_lr=SHARDED_LR)
        one.append({k: float(v) for k, v in met.items()})
    one_launches = ops.launch_counts()["swa_attention"]
    final = convert.params_to_numpy(params)
    del params, opt
    torch.cuda.empty_cache()
    # The dry-run's prediction of each rank's collectives.
    with dryrun._fake():
        pred = dryrun.run_step(
            cfg, InputShape("sharded_train", SHARDED_SEQ, SHARDED_BATCH,
                            "train"), mesh_lib.make_cpu_mesh(*SHARDED_LAYOUT),
            count=False)["records"]
    pred = [tuple(r) for r in pred] * SHARDED_STEPS
    want_launches = 2 * SHARDED_LAYERS * SHARDED_STEPS
    if one_launches != want_launches:
        fail(f"sharded_train: the one-rank run launched K7 {one_launches} "
             f"times, expected {want_launches}")
    worst = {}
    for r, got in enumerate(ranks):
        for step, (g, w) in enumerate(zip(got["metrics"], one)):
            for key, rtol in (("loss", SHARDED_LOSS_RTOL),
                              ("gnorm", SHARDED_GNORM_RTOL)):
                if not math.isfinite(g[key]) or \
                        abs(g[key] - w[key]) > rtol * abs(w[key]):
                    fail(f"sharded_train: rank {r} step {step} {key} "
                         f"{g[key]} against one rank's {w[key]}")
        if got["resident_bytes"] != 3 * got["spec_bytes"]:
            fail(f"sharded_train: rank {r} holds {got['resident_bytes']} "
                 f"bytes of parameters, m and v, its spec blocks "
                 f"{got['spec_bytes']} x 3")
        if got["launches"] != want_launches:
            fail(f"sharded_train: rank {r} launched K7 {got['launches']} "
                 f"times, expected {want_launches}")
        if got["records"] != pred:
            fail(f"sharded_train: rank {r}'s {len(got['records'])} "
                 f"collectives differ from the dry-run's {len(pred)}")
    # Each parameter: relative L2 within GRAD_TOL of one rank's; each
    # element within 2.05 x lr a step (Adam moves it by about lr), and at
    # most FLIP_FRACTION of a leaf's elements more than 0.1 x lr apart
    # (an element whose gradient is rounding noise may step the other
    # way: tests/train_parity.py's rules).
    for (key, g), (_, w) in zip(_tree_leaves(ranks[0]["params"]),
                                _tree_leaves(final)):
        d = np.abs(g - w)
        err = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        flips = float((d > 0.1 * SHARDED_LR).mean())
        worst[key] = (err, flips)
        if not (err <= SHARDED_GRAD_TOL and flips <= SHARDED_FLIP_FRACTION
                and d.max() <= 2.05 * SHARDED_LR * SHARDED_STEPS):
            fail(f"sharded_train: {key} {err} relative L2 from one rank's, "
                 f"{flips} of its elements 0.1 lr apart, max "
                 f"{d.max() / SHARDED_LR} lr")
    del final
    kinds = {}
    for kind, nbytes, group in ranks[0]["records"]:
        k = kinds.setdefault(kind, {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += nbytes
    emit("sharded_train", arch=cfg.name, layers=cfg.n_layers,
         cut=f"{SHARDED_LAYERS} of 24 layers", d_model=cfg.d_model,
         layout=dict(zip(("data", "model"), SHARDED_LAYOUT)),
         backend=run.backend, ranks_per_card=run.ranks_per_card,
         batch=SHARDED_BATCH, seq=SHARDED_SEQ, steps=SHARDED_STEPS,
         lr=SHARDED_LR, losses=[m["loss"] for m in ranks[0]["metrics"]],
         one_rank_losses=[m["loss"] for m in one],
         gnorms=[m["gnorm"] for m in ranks[0]["metrics"]],
         one_rank_gnorms=[m["gnorm"] for m in one],
         worst_param_rel_l2=max(e for e, _ in worst.values()),
         worst_flip_fraction=max(f for _, f in worst.values()),
         resident_bytes=[r["resident_bytes"] for r in ranks],
         spec_bytes=[r["spec_bytes"] for r in ranks],
         peak_bytes=[r["peak_bytes"] for r in ranks],
         init_s=[r["init_s"] for r in ranks],
         step_s=[r["step_s"] for r in ranks], launches_per_rank=[
             r["launches"] for r in ranks], collectives=kinds,
         records_match_dryrun=True, ranks_s=ranks_s,
         seconds=time.perf_counter() - t_phase)


def _dryrun_wait(dryrun_proc) -> float:
    """Phase 24's subprocess to its end; the seconds waited."""
    t_wait = time.perf_counter()
    try:
        code = dryrun_proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        fail("dryrun: the subprocess did not finish in 900 s")
    if code != 0 or not DRYRUN_OUT.is_file():
        log = DRYRUN_OUT.with_suffix(".log").read_text()[-3000:]
        fail(f"dryrun: the subprocess exited {code}: {log}")
    return time.perf_counter() - t_wait


def _dryrun_reports(waited: float) -> list:
    """Phase 24: the subprocess's reports."""
    reports = json.loads(DRYRUN_OUT.read_text())
    for r in reports:
        if r.get("plan") != "run" or "roofline" not in r:
            fail(f"dryrun: {r.get('arch')} {r.get('shape')}: {r}")
        emit("dryrun", arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
             seconds=r["seconds"], microbatches=r.get("microbatches"),
             trace_device=r.get("trace_device"),
             analysis_mode=r.get("analysis_mode"), memory=r["memory"],
             roofline=r["roofline"], collectives=r["collectives"])
    emit("dryrun_total", combos=len(reports),
         reports_s=sum(r["seconds"] for r in reports), waited_s=waited)
    return reports


def _dryrun_card(torch, reports):
    """Phase 25."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    report = reports[0]
    if (report["arch"], report["shape"]) != DRYRUN_COMBOS[0]:
        fail(f"dryrun_card: first report is {report['arch']} "
             f"{report['shape']}")
    cfg = get_config(report["arch"])
    shape = SHAPES[report["shape"]]
    mesh = mesh_lib.make_production_mesh()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    got = dryrun.run_step(cfg, shape, mesh, device=DEVICE)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = ops.launch_counts()["swa_attention"]
    del got
    want_peak = report["memory"]["peak_bytes"]
    # The step again without counters, timed.
    step, _ = dryrun.make_step(cfg, shape, mesh, device=DEVICE)
    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with FlopCounterMode(display=False) as counter:
        step()
    torch.cuda.synchronize()
    flops = counter.get_total_flops()
    del step
    torch.cuda.empty_cache()
    roof = report["roofline"]
    if flops != roof["flops"]:
        fail(f"dryrun_card: FlopCounterMode counted {flops} FLOPs on the "
             f"card, the report {roof['flops']}")
    if launches != cfg.n_layers:
        fail(f"dryrun_card: K7 launched {launches} times, expected "
             f"{cfg.n_layers}")
    if abs(peak - want_peak) > DRYRUN_PEAK_RTOL * want_peak:
        fail(f"dryrun_card: max_memory_allocated {peak} against the "
             f"report's peak_bytes {want_peak}")
    bound_ms = 1e3 * max(roof["compute_s"], roof["memory_s"])
    emit("dryrun_card", arch=report["arch"], shape=report["shape"],
         mesh=report["mesh"], rank=0, flops=flops, report_flops=roof["flops"],
         max_memory_allocated=peak, report_peak_bytes=want_peak,
         peak_rel_err=(peak - want_peak) / want_peak,
         swa_launches=launches, wall_ms=statistics.median(walls),
         walls_ms=walls, roofline_bound_ms=bound_ms,
         compute_ms=1e3 * roof["compute_s"], memory_ms=1e3 * roof["memory_s"],
         seconds=time.perf_counter() - t_phase)


def _tree_leaves(tree, prefix=""):
    """(path, leaf) of a nested dict in sorted-key order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _tree_leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


if __name__ == "__main__":
    main()
