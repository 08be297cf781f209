#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

What it does, in order; any failure raises and the exit code is not 0:

1. prints the card's name and power limit (``nvidia-smi``) and builds every
   CUDA kernel of the port from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, ``sm_90a``, all started together), printing the build times and
   each kernel's registers and spills (the tensor-core flash body must not
   spill); then worker processes make the main-path graphs (each graph's
   cardinality by scipy and its CPU solve, checked after step 15, are
   started in workers as it arrives; the cardinality is read in step 4)
   and the graphs of step 5b with their scipy cardinalities, and solve the
   small corpus on the CPU through every solve path (for step 4); the
   workers run at the lowest priority, so that the card's phases and the
   ranks of step 5c go first; steps 7-9, 16 and 17, which need no graph,
   run on the card while the workers draw the graphs;
2. drives the matching main path, ``TorchCSR.from_host`` (then ``with_csc``
   for the direction-optimizing paths) -> warm start -> APFB/APsB solve, on
   three full-size graphs made by the port's own generators, through every
   solve path: the fused push sweep, the legacy proposal kernel, the pull
   kernel, the compact pull and the adaptive compact gather.  ``Matcher.
   run`` is one compile-cache entry per (bucket, config, warm start) whose
   steps are CUDA graphs and whose loops are conditional WHILE nodes: each
   run is made cold (the entry built and its graphs captured, as a jit
   compile) and then warm (a cache hit, no new capture), each timed with
   its upload (``upload_s``, ``TorchCSR.
   from_host`` alone, beside the wall), and once more under torch's sync
   debug mode, whose count of host waits must be the solver's own
   ``host_syncs``.  Every kernel launch counter (device counters, so
   replayed launches count) and solver counter is set to 0 just before each
   run and read just after; the warm run is the one the launch checks read.
   Each result is checked five ways: a valid matching, a cardinality equal
   to scipy's ``maximum_bipartite_matching`` (independent of the code under
   test; in step 4), ``certified`` True, the CPU's state bit for bit (a
   worker's run of the main-path config on the same graph; every path
   gives the same state; after step 15), and the run's own kernel launched
   or compact branch taken.  The
   entry's bytes are read: its static buffers, and the memory the card
   holds for it (buffers and the graphs' pool);
3. holds each frontier kernel against its plain PyTorch version on the
   card, over the first BFS phase of the main-path graphs, level by level,
   bit for bit (tolerance 0: the outputs are integers): the fused sweep on
   every graph and body (on kron also with the edge slots in a random
   order and with ``ecol``/``cadj`` as views 1-3 slots into their
   buffers), the proposal kernel, the pull kernel and the pull's column
   pass (``frontier_bits``) on kron (WR) and the random graph (plain), the
   pull kernel also against the fused one, and each sweep with its level
   read from a device scalar and an open gate (as the captured solve
   launches it) against the immediate; times each kernel (both ways, 20
   repetitions) and plain version (once over the phase: it takes
   milliseconds a level) with CUDA events, each level alone too, prints
   the pull's and
   the fused sweep's times level by level side by side, and splits each
   kernel's device time (the pull's into column pass, sweep and fill)
   with ``torch.profiler``;
4. solves ``instance_sets("small")`` (all nine families) through every
   solve path on the card, the sharded one included (a mesh of the one
   card), and requires the CPU's ``cmatch``, ``rmatch``, ``phases``,
   ``fallbacks`` and ``certified``; reads scipy's cardinalities of the
   main-path graphs and holds step 2's results to them;
5. profiles one more solve of each main-path graph with ``torch.profiler``
   (device time by kernel, the fused sweep's and torch's scatter kernels'
   share, the device's busy share of the wall time), and times one in CUDA
   events (the card's span from the first launch to the last);
5b. the edge-sharded matcher: ``ShardedMatcher`` over a mesh of four
   shards on the one card (``make_mesh((4,), ("data",), devices=["cuda"] *
   4)``), each run as in step 2 (``TorchCSR.from_host``, ``with_csc``,
   ``shard``, ``run``; cold, then warm, then under the sync debug mode):
   kron-21 under ``MatcherConfig()`` with ``cheap`` through the fused,
   legacy and ``dirop_pallas`` paths, random-4M under ``kernel="gpubfs"``
   with ``karp_sipser``; each held to step 2's state of the same graph
   and path bit for bit (cold and warm), valid, certified, at scipy's
   cardinality, with step 2's host syncs and levels, one merge a level,
   and each of its kernels launched once a shard a level (the counts set
   to 0 just before, read just after); prints the warm wall beside step
   2's, the merges, the bytes a ring all-reduce of them would move, and
   the entry's bytes.  Then K1a, K2a and K3a on each shard's slice of
   kron's edge buffers over the first BFS phase, level by level, against
   their plain versions bit for bit, the merged rows against the whole
   edge list's winners, each timed a shard launch beside its bound; a
   graph of the 2^16 serving bucket sharded 1, 2 and 3 ways against its
   single-device run; and the service's oversize lane:
   ``MatchingService(mesh=...)`` over step 6's ladder takes
   ``random_bipartite(1<<19, 1<<19, 8.0)`` (past the ladder's top) to
   ``route="sharded"``, certified, at scipy's cardinality, bit for bit the
   card's single-device ``Matcher.run`` of the bucketed graph;
5c. the data axis over ranks (``repro_torch.distributed``): phase 1's
   kron-21 and random-4M written once to ``.npz`` files that the ranks
   read; (a) gloo worlds of 2 and 4 ranks sharing the card
   (``run_world``), each rank solving step 5b's runs over a mesh of the
   world (``make_mesh``; ``ShardedMatcher.run`` of the host graph, each
   rank uploading its shard only, the warm start on rank 0 and broadcast,
   the merge an ``all_reduce_min_`` a level, the solve uncaptured under
   gloo), the kron ``jnp`` run also warm: every rank's state step 2's bit
   for bit (by a sha256 of the matching), one merge a level, host syncs
   step 2's plus one a test of the uncaptured level and ``ALTERNATE``
   loops, the run's kernels (K1a, K2a, K3a, K1b) launched once a level on
   every rank (the counts set to 0 just before, read just after); the
   walls, each rank's peak device memory, bytes handed to each merge and
   whether gloo took the card tensors printed; the world of 2 then trains
   mamba2-2.7b at full width cut to 4 layers two steps (ZeRO-1) and saves
   collectively; before that, the world of 2 runs the service's lane over
   a world: rank 0 a ``MatchingService`` over step 6's ladder with a mesh
   of the world, rank 1 ``serve_followers``; kron-21 (past the ladder's
   top) takes ``route="sharded"``, certified, at scipy's cardinality, every
   rank's state step 2's (by digest); an in-bucket graph takes
   ``route="bucket"`` on rank 0 alone (no header sent); on step 5b's
   oversize graph a poisoned request is quarantined, a flush thread killed
   before a sharded dispatch is restarted, and one more request is served
   on both ranks; ``close()`` releases rank 1, whose served count equals
   rank 0's ``sharded`` metric; K1a launched once a level on each rank of
   each lane run (counts set to 0 just before each run on rank 0 and
   before rank 1's loop, read just after), the lane's wall printed beside
   the kron row's; (b) a world of one NCCL rank in this process: kron-21
   cold and warm, step 2's state and host syncs (the merge captured in the
   level's graph), the same through the service's lane (its host syncs
   step 2's), and mamba2-2.7b FULL two steps through the world's train
   step (ZeRO-1; the peak memory printed beside the one-device step's
   50.02 GB recorded in PERF.md), held in step 18
   to its first two steps on one device (``TRAIN_GATE_RTOL``; bit for bit
   or not printed); (c) the
   world's losses against the one-device ``microbatch=2`` steps
   (``TRAIN_GATE_RTOL``), the ``W=2`` checkpoint restored at ``W=1`` held
   to the one-device tree leaf by leaf (the train gate), and one more step
   from it against the uninterrupted run's;
5d. the model axis (tensor and sequence parallelism, FSDP;
   ``build_model(cfg, world)``), its ranks phase 5c's worlds of 2 and 4
   remeshed (``World.remesh``) after 5c's work, its checks in this
   process: (a) the gloo world of 1 x 2 ranks sharing the card:
   granite-20b at full width cut to 4 layers, bf16,
   ``attn_impl="pallas"``, each rank drawing the whole tree from the seed a
   layer at a time and keeping its slices; the prefill B=1 x 4096 with K4
   on each rank's 24 query heads and the one replicated K/V head (K4's
   counts set to 0 just before, read just after: once a layer a rank, on
   the tensor-core body), the gathered logits held to the one-device
   prefill of the same weights within ``LOGIT_GAP_TOL``, which a control
   with the middle layer's attention zeroed must exceed; 8 greedy decode
   steps over each rank's KV cache, each step's gathered logits held to
   the one-device decode of the same tokens within ``LOGIT_GAP_TOL``, the
   cache bytes of each rank printed; K4 at a rank's layer shape (1, 4096,
   24, 1, 128), both masks, against its plain version (2e-2), timed beside
   the plain version, SDPA and its bound; (b) the gloo world of 2 x 2
   ranks: granite-20b at full width (FSDP over ``data``, sequence
   parallelism over ``model``, remat): the fp32 gate, one layer, two steps
   of B=2 x 512, saved at 2 x 2 (every leaf gathered onto rank 0's host)
   and restored on one device, held leaf by leaf to the one-device
   ``microbatch=2`` steps (the train gate) and one more step from each
   (``TRAIN_GATE_RTOL``), the losses too; then bf16, two layers, two steps
   of B=4 x 2048: seconds a step, peak bytes a rank and the bytes handed
   to each axis's collectives printed;
5e. the model axis of the MoE, SSM and hybrid families (the expert axis,
   ``d_inner`` and the SSM heads cut over ``model``, the hybrid's shared
   block by heads), its ranks phase 5c's worlds remeshed as 5d's, after
   5d's work; one device's side first (before the worlds start), the
   checks after 5d's: (a) the gloo world of 1 x 2 ranks sharing the card,
   bf16, seeded weights at full width: dbrx-132b at 2 of its 40 layers
   (``attn_impl="pallas"``, FULL's sequence parallelism) with a prefill of
   B=1 x 2048, mamba2-2.7b at 8 of 64 layers and zamba2-7b at 14 of 81
   (one shared-block invocation) with prefills of B=1 x 4096, each timed
   after a warm one (K4's counts set to 0 just before, read just after:
   once a layer a rank on dbrx's 24 local query heads on 4 K/V heads, the
   tensor-core body), then 8 decode steps teacher-forced on one device's
   greedy tokens; the gathered last logits held to one device's prefill
   of the same weights and depth within ``LOGIT_GAP_TOL``, which a control
   with the middle block skipped must exceed (dbrx's free-running, with
   the routes that differ from one device's printed, and again under one
   device's routes, ``pinned_routing``), the routes' digest equal
   on both ranks, each decode step's logits within ``LOGIT_GAP_TOL`` and
   its argmax one device's (dbrx's decode under one device's routes), the
   SSM state's bytes a rank half one device's; the prefill walls beside
   one device's, decode ms a step, cache and peak bytes a rank printed; K4
   at dbrx's local shape (1, 2048, 24, 4, 128), both masks, against its
   plain version (2e-2), timed beside the plain version, SDPA and its
   bound; (b) the gloo world of 2 x 2 ranks: mamba2-2.7b at full width,
   one layer, fp32, two steps of B=2 x 512, saved at 2 x 2 and restored on
   one device, held to the one-device ``microbatch=2`` steps as 5d(b)'s
   gate; dbrx-132b at full width, one layer, bf16, under the launcher's
   optimizer (the factored state), one step of B=2 x 512 (FSDP over
   ``data``, the experts and sequence over ``model``): the loss finite and
   equal on every rank, seconds a step, peak bytes a rank and the bytes
   handed to each axis's collectives printed;
5f. the model axis where ``M`` does not divide the heads: a gloo world
   of 1 x 3 ranks sharing the card (a spawn of its own, after 5e's
   checks), bf16, seeded weights at full width cut to two layers:
   deepseek-coder-33b (``attn_impl="pallas"``, FULL's sequence
   parallelism; 56 heads 19/19/18 on its 8 replicated K/V heads, every
   rank's block straddling groups of 7, its K/V expanded to one a query
   head) with a prefill of B=1 x 3072, and paligemma-3b (8 heads 3/3/2 on
   its one K/V head, hd 256, ``d_ff`` 16384 as 5462/5462/5460) with B=1 x
   (256 patches + 2816 tokens); one device's side first: the prefill
   (after a warm one), a control with the middle layer zeroed (K4's call
   for it returning zeros; paligemma's block skipped) and 8 greedy decode
   steps; then the ranks' prefills (K4's counts set to 0 just before,
   read just after: once a layer a rank, on the tensor-core body) and 8
   decode steps teacher-forced on one device's tokens: the gathered last
   logits within ``LOGIT_GAP_TOL`` of one device's, which the control
   must exceed, and each decode step's too; the walls, each rank's heads,
   K/V heads, parameter, cache and peak bytes printed; K4 at rank 0's
   shape (1, 3072, 19, 19, 128), both masks, against its plain version
   (2e-2), timed beside the plain version, SDPA and its bound;
5g. experts and SSM heads that ``M`` does not divide: a gloo world of 1 x
   3 ranks sharing the card (a spawn of its own, after 5f), run as 5e(a)
   is: dbrx-132b at 2 layers (16 experts 6/6/4, 48 heads 16/16/16 over its
   8 replicated K/V heads, each rank's K/V expanded to one a query head,
   ``attn_impl="pallas"``) with a prefill of B=1 x 3072, mamba2-2.7b at 4
   layers (80 SSM heads 27/27/26) and zamba2-7b at 7 in fp32 (112 SSM
   heads 38/38/36, one shared-block invocation after the seventh; in bf16
   its decode drifts past the gate by rounding alone) with prefills of
   B=1 x 4096:
   5e(a)'s checks (the gathered logits within ``LOGIT_GAP_TOL`` of one
   device's, which the skipped-block control must exceed, 8 decode steps
   teacher-forced on one device's greedy tokens within it, their argmax
   agreement printed as 5f's, each rank's SSM state its share of the
   heads), and each of K4's calls on every rank held against
   its plain version (2e-2) in a prefill under one device's routes; K4 at
   rank 0's shape (1, 3072, 16, 16, 128) against its plain version, timed
   beside the plain version, SDPA and its bound;
5h. the dry run (``repro_torch.launch.dryrun``, one rank traced on the
   ``meta`` device) held to the card: (a) in step 9, granite-20b's
   prefill: the dry run's parameter bytes equal the card's, its FLOPs
   ``hlo_cost``'s over the card's prefill (K4's recorded work included),
   its peak estimate within 0.75-1.25x the card's measured peak, its
   compute term printed beside the wall; (b) after 5g, 5f's
   deepseek-coder-33b prefill traced dry for each rank of 1 x 3: its
   collectives (calls and bytes by axis and op) equal the gloo ranks';
6. the serving path: ``repro_torch.serving.MatchingService`` on the card
   over the ladder 16,384² .. 262,144² (edge factor 8, ``max_batch`` 16),
   a 256-request trace (the four families of ``serve_matching.FAMILIES``
   round-robin, size hints 2^14 / 2^16 / 2^18, made by the workers with
   scipy's cardinality): ``warm_up()`` (every step of its entries
   captured; their bytes, captures included, against the cache's budget;
   nothing evicted, and the two loops after it capture and evict nothing), a
   closed loop (saturation graphs/s), an open-loop Poisson replay at 0.7×
   that rate (latency, occupancy, dispatches, host syncs per flush, no
   compile miss), a burst through the plain push body, the legacy kernel
   and the pull kernel (forced, both bodies) on the 2^16 bucket, all three
   with the counts set to 0 just before and read just after (every
   body's batched instantiation, a flush of more than one lane, must
   launch; a flush of one lane launches the single-graph one), and the ``--chaos`` drill of
   ``serve_matching``.
   Every served request: a valid matching at scipy's cardinality,
   certified, and the card's single-graph ``Matcher.run`` of the same
   bucket-padded graph bit for bit; one batch of the 2^14 bucket equals the
   CPU's ``run_many``.  Then each frontier kernel body with its lane
   dimension on a 16-lane batch of the 2^18 bucket over the first BFS
   phase (lanes started at staggered levels, lanes gated off, at most
   ``LANE_CHECK_LEVELS`` levels): one launch against its plain version and
   against 16 single-graph launches, bit for bit, each timed (CUDA events)
   beside its bound;
6b. the differential fuzzer, the dirop replay, the warm-start wrappers and
   the examples on the card, with no JAX: (a) ``repro_torch.corpus.
   verify_corpus`` over every solve path x warm start (none, cheap,
   Karp-Sipser) x mini instance (the families, the ``.mtx`` fixture and
   their RCP twins: 420 cells, one shared size bucket) against the port's
   Hopcroft-Karp, no failure, at most one compile-cache miss per (path,
   warm start), K1a, K2a and K3a launched; (b) ``corpus.heuristic.
   trace_instance`` of kron-21 (cheap) and random-4M (Karp-Sipser) on the
   card, K1a launched twice a traced level (the replay's sweep and the
   one-phase solves between), held to (i) the default solve's phases,
   (ii) its BFS levels and (iii) ``modelled_rel``'s pull count against a
   ``dirop_pallas`` solve's ``pull_levels`` (kron: step 2's runs;
   random-4M: both solved here under Karp-Sipser, cold then warm), and
   the modelled rel over the sweep grid printed beside the measured
   ``dirop_pallas`` / ``jnp`` warm-wall ratio; the nine small families'
   traces equal a CPU worker's, entry for entry; (c) ``cheap_matching_
   torch`` and ``karp_sipser_torch`` on the small families equal the
   CPU's bit for bit, and on kron-21 and random-4M give a valid matching,
   cold and warm alike; (d) every ``examples/torch`` script once at its
   default size, in this process, ending normally (the quickstart prints
   Hopcroft-Karp's cardinality);
7. holds the flash-attention kernel against its plain version on the card
   (TF32 off): the shapes of ``tests/test_kernels.py`` in fp32 (the CUDA-core
   body, 2e-5) and bf16 (the tensor-core body, 2e-2), granite-20b's
   layer shape (B=4, S=4096, H=48, KV=1, hd=128, bf16) and dbrx-132b's
   (B=4, S=2048, H=48, KV=8, hd=128, bf16, timed beside the plain version,
   SDPA with ``enable_gqa`` and its bound), both masks, each
   launch counted on the body its dtype routes to; at granite's shape also
   in scaled norms (``FA_REL_TOL``: l2, max and the worst query row), each
   of which a control with one key tile dropped must exceed; times it
   (both masks, with its TFLOP/s), the plain version and
   ``scaled_dot_product_attention`` (the yardstick, never called by the
   port) at granite's shape; and the fp32 body at granite's shape against
   its plain version (2e-5), timed beside both in fp32;
8. granite-20b at full width with two layers in fp32: the forward through
   the kernel against the torch-op attention (1e-3), and teacher-forced
   ``decode_step`` over 64 tokens against the forward (2e-3);
9. the LM main path: granite-20b FULL, bf16, 52 layers, seeded weights.
   ``build_prefill_step`` on 4 prompts of 4096 tokens with the flash-kernel
   counts set to 0 just before and read just after (52 launches, all on the
   tensor-core body; finite logits); the same prefill through ``blockwise_attn`` (gap of the
   last-position logits within ``LOGIT_GAP_TOL``) and once more with one
   layer's attention zeroed (a control that must exceed the gap's gate);
   greedy serving (batch 4, a 64-token prompt stepped, 16 tokens
   generated); the prefill and serving profiled;
10. the MoE routers on dbrx-132b's layer-0 router logits of one prefill
   sequence (T=2048, E=16, k=4, m=6, C=640; the seeded full-width model):
   ``route_topk``, ``route_matching`` and ``route_matching_exact``, each
   feasible (loads <= C, unique (expert, slot), no expert twice in a
   token) and timed; the exact router's gadget graph (20,480 x 22,528,
   7,925,760 edges) solved by ``Matcher(MatcherConfig(), "cheap")``,
   certified at scipy's cardinality, K1a against its plain version bit for
   bit at every level of that solve (run again uncaptured), the fused
   kernel K1a launched in the route (its count read), a drop rate no higher
   than the other two; the
   first 256 tokens (C=80) also on the CPU, ``assign`` and ``slot`` bit for
   bit and the probabilities within 1e-6;
11. dbrx-132b at full width, two layers, fp32: the forward through K4 (the
   CUDA-core body, once a layer) against the torch-op attention (1e-3), and
   teacher-forced decode against the forward (2e-3) under
   ``capacity_factor = n_experts / top_k`` (no token can drop);
12. dbrx-132b at full width, bf16, as many of its 40 layers as leave 12 GB
   free (the cut printed): the prefill B=4 x 2048 through K4 (counts set to
   0 just before, read just after; once a layer on the tensor-core body),
   each layer's drop rate and load-balance loss, the same prefill through
   the torch-op attention (free-running: gap and router assignments that
   differ printed, since bf16 roundings flip router near-ties and the flips
   compound; with every layer routed as the kernel's run routed it: the
   logits within ``LOGIT_GAP_TOL`` and each layer's attention output within
   ``LAYER_GAP_TOL``) and with layer 0's or the middle layer's attention
   zeroed under that routing (controls that must exceed the per-layer gate,
   layer 0's also the logits gate), greedy serving, and the router's share
   of device
   time (``torch.profiler``, a ``record_function`` range around each
   route) in the prefill and in serve steps;
13. llama4-maverick at full width, one layer (chunked attention, window
   8192), and h2o-danube-1.8b FULL (sliding window 4096), bf16: a prefill
   past the window, then greedy decode steps from 4 positions before the
   window's end to 4 past it on a fresh ring cache (finite logits, the
   ring holding exactly those positions);
14. mamba2-2.7b FULL (64 mamba blocks), bf16: the prefill B=4 x 4096 (16
   SSD chunks; tokens/s, peak memory), greedy serving (batch 4, a 64-token
   prompt stepped, 16 generated); two layers in fp32 at full width,
   teacher-forced decode over 512 tokens (two chunks) against the
   forward's logits at every position (2e-3);
15. zamba2-7b FULL (81 mamba blocks, the shared attention block after every
   14th), bf16: the prefill B=1 x 8192 (the shared block through
   ``blockwise_attn`` under its 4096 window, once an invocation), 8 greedy
   decode steps at positions 4092-4099 on a fresh cache (its rings hold
   exactly those); four layers with the shared block after every second
   in fp32, decode against the forward (2e-3), each invocation with a KV
   slice of its own;
16. seamless-m4t-medium FULL (12 encoder + 12 decoder layers), bf16: K4 at
   its layer shape (B=4, S=1024, H=KV=16, hd 64, both masks) against its
   plain version and timed beside it, SDPA and its bound; the prefill B=4
   x 1024 tokens over frames (4, 1024, 1024) through K4, counts set to 0
   just before and read just after (12 full launches and 12 causal, all
   on the tensor-core body), each launch of one prefill against its plain
   version (2e-2), the cross-attention never on K4; the same prefill
   through the torch-op attention (the logits within ``LOGIT_GAP_TOL``,
   each of the 36 attention outputs within ``LAYER_GAP_TOL``) and with the
   self-attention of encoder layer 0 or of the middle decoder layer zeroed
   (controls that must exceed the per-layer gate, the encoder's the logits
   gate too);
   greedy
   serving over ``prefill_encoder``'s cache; two encoder and two decoder
   layers in fp32: K4 against the torch-op attention (1e-3) and decode
   against the forward (2e-3);
17. paligemma-3b FULL (18 layers, hd 256, one K/V head), bf16: the prefill
   B=2 x (256 patches + 3840 tokens) through ``blockwise_attn`` under the
   prefix mask, 8 greedy decode steps after it; two layers in fp32 at
   S=4096: ``blockwise_attn`` against ``_plain_attn`` under the prefix
   mask, the logits within 1e-3;
18. training (no kernel of the port is on this path: the flash kernel has
   no backward, and the train step refuses it under autograd):
   mamba2-2.7b FULL (64 blocks, bf16, remat) for 4 steps of B=2 x 2048
   ``synthetic_batch`` tokens under the optimizer ``launch/train.py``
   picks (fp32 masters), each step's loss, wall, tokens/s and peak memory
   printed, one more step profiled; the crash and restart at full width
   cut to 4 layers (2 steps, ``save_checkpoint``, every tree dropped,
   ``restore_checkpoint`` into fresh state, 2 steps) against the 4 steps
   straight through, the last loss bit for bit under
   ``torch.use_deterministic_algorithms``; dbrx-132b at full width, one
   layer, the factored state, 2 steps through ``route_matching`` under
   autograd; then the gate: one fp32 step of mamba2 (two layers) and of
   dbrx (one layer) at full width on the card against the same step on
   the CPU (taken just before, its seconds and the process's peak
   resident set after it printed), every parameter and optimizer leaf
   after it
   (``TRAIN_GATE_RTOL``, Adam's near-zero-gradient entries counted and
   bounded by ``TRAIN_GATE_SHARE``), each with a control whose gradients
   are scaled by 0 (``clip_norm = 0``) that must fail it; every run's
   losses finite, and the loss of its first batch, taken again after the
   run, below that first step's loss (each step trains on a fresh batch,
   whose spread at ln(vocab) hides a few steps' progress; the last loss
   against the first is printed beside it);
19. the two knobs: granite-20b at full width, its depth cut to
   ``KVQ_CUTS`` (a quarter of its 52 layers, for the script's time), served
   as in phase 9 with the bf16 cache and with the int8 one (``opt_kv_quant``: the cache's bytes, the
   decode ms a step of both, the logits gap over the decode steps of a
   lockstep run of both caches on the same tokens); two fp32 granite
   layers at full width, the int8 codes and bf16 scales of 8 decode steps
   on the card against the CPU (codes may differ by one, never more;
   scales by one bf16 ulp); two fp32 dbrx layers at full width, the
   prefill at S=4096 with ``opt_attn_layout`` (``hflat_blockwise_attn``
   once a layer) against without it (``blockwise_attn``), within 1e-3;
20. prints one ``{"kernels": [...]}`` line (the batched launch of each
   body as its own entry, ``lanes`` 16; every body's launches include step
   5b's, also on their own as ``launches_sharded``, step 5c's (every
   rank's), as ``launches_world``, and step 6b's, as
   ``launches_corpus``, and K1a, K2a and K3a
   carry their shard-slice checks and times; K1a's launches include the
   exact route's, K4's dbrx's and seamless's prefills' and the model
   axis's ranks' (``launches_model_axis``) and phase 5e's dbrx prefills'
   (``launches_model_axis_families``) and phase 5f's deepseek prefills'
   (``launches_model_axis_uneven``) and phase 5g's dbrx prefills'
   (``launches_model_axis_experts_heads``), and K4 carries its times at
   dbrx's and seamless's shapes and at a rank's heads under the model
   axis, for granite's, dbrx's, deepseek's uneven heads and dbrx's under
   ``M = 3``), then as its last line
   ``{"ok": true, "device": {...}}``.

It imports neither JAX nor the JAX package.  It needs a CUDA card and the
repository's ``src/``; without either it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import torch

# cuBLAS's fixed workspace, which torch.use_deterministic_algorithms needs
# for the crash-and-restart run (phase 18); 32 MiB, torch's own size on
# Hopper
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)

# (generator, its arguments, config, warm start, what it exercises)
MAIN_PATH = [
    ("kron_graph", (21, 16), dict(seed=1), dict(), "cheap", "WR body"),
    ("random_bipartite", (1 << 22, 1 << 22, 8.0), dict(seed=2),
     dict(kernel="gpubfs"), "karp_sipser", "plain body"),
    ("grid_graph", (1024,), dict(), dict(algo="apsb", wr_exact=True),
     "cheap", "exact-WR encoding"),
]
KRON, RANDOM, GRID = range(3)
# threads of the CPU main-path solves: the random graph's is the longest
# job of the workers (244-416 s on two threads), and sets when the last
# check can run
CPU_THREADS = {KRON: 2, RANDOM: 4, GRID: 2}
_APSB_EXACT = dict(algo="apsb", wr_exact=True)
# the other solve paths: (main-path graph, solve path, config on top of the
# path's overrides, warm start, what the run must show: a launch counter or
# a solver counter that must be > 0, and counters that must stay 0)
PATH_RUNS = [
    (KRON, "legacy", dict(), "cheap", ("frontier_expand_wr",),
     ("frontier_expand_fused_wr", "frontier_expand_fused_plain")),
    (RANDOM, "legacy", dict(kernel="gpubfs"), "karp_sipser",
     ("frontier_expand_plain",), ()),
    (KRON, "dirop_pallas", dict(), "cheap",
     ("frontier_expand_pull_wr", "frontier_bits_wr"), ()),
    # forced pull: every level streams the mirror
    (RANDOM, "dirop_pallas", dict(kernel="gpubfs", dirop_alpha=1e6,
                                  dirop_beta=1e6), "karp_sipser",
     ("frontier_expand_pull_plain", "frontier_bits_plain"), ()),
    # the auto pull geometry (1024 rows of degree <= 8) admits the compact
    # pull on no level of this grid (the first run shows it); a quarter of
    # the rows does, still a gather of fewer slots than the dense sweep's
    (GRID, "dirop", _APSB_EXACT, "cheap", ("push_levels",), ()),
    (GRID, "dirop", dict(_APSB_EXACT, pull_cap=1 << 18), "cheap",
     ("pull_levels",), ()),
    (GRID, "adaptive", _APSB_EXACT, "cheap", ("compact_levels",), ()),
]
_SRC = "src/repro/kernels/frontier_expand/frontier_expand.py"
KERNELS = {          # kernel body -> the TPU kernel it replaces
    "frontier_expand_fused_wr": f"{_SRC}:187",
    "frontier_expand_fused_plain": f"{_SRC}:195",
    "frontier_expand_wr": f"{_SRC}:146",
    "frontier_expand_plain": f"{_SRC}:154",
    "frontier_expand_pull_wr": f"{_SRC}:233",
    "frontier_expand_pull_plain": f"{_SRC}:241",
    # the pull's column pass: the column half of _proposals (:125) that
    # _kernel_pull_wr / _kernel_pull evaluate per edge
    "frontier_bits_wr": f"{_SRC}:233",
    "frontier_bits_plain": f"{_SRC}:241",
}


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in ``nvcc -Xptxas -v``
    output, by kernel and template argument (``flash_fwd_tc<128>``); empty
    for a library that was already built.  The registers are those of the
    launch; a body that moves registers between warpgroups with
    ``setmaxnreg`` gives its consumer warpgroups more."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"\d+((?:flash_fwd|fused_sweep|proposals|"
                          r"pull_sweep|frontier_bits)\w*?)"
                          r"(?:I((?:L[a-z]\d+E)+)E|E)",
                          m.group(1))
            args = re.findall(r"L[a-z](\d+)E", k.group(2) or "") if k else []
            name = m.group(1) if k is None else k.group(1) + (
                f"<{','.join(args)}>" if args else "")
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(*parts) -> None:
    print(*parts, flush=True)


def label(entry) -> str:
    name, args, kw = entry[:3]
    parts = [repr(a) for a in args] + [f"{k}={v!r}" for k, v in kw.items()]
    return f"{name}({', '.join(parts)})"


def import_in_background() -> threading.Thread:
    """Import ``torch._dynamo`` in a thread of its own while this process
    does other work: ``torch.utils.checkpoint``'s first call (remat, in
    every train step) imports it, 13 s in each rank of a world sharing the
    card host.  Join the thread before the first train step."""
    import importlib
    t = threading.Thread(target=importlib.import_module,
                         args=("torch._dynamo",), daemon=True)
    t.start()
    return t


def use_src() -> None:
    """Import the port from this checkout (worker processes start bare)."""
    if os.path.join(HERE, "src") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "src"))


def generate(entry):
    """Worker process: one graph from the port's generators, and the
    seconds it took."""
    use_src()
    from repro_torch import graphs
    name, args, kw = entry[:3]
    t0 = time.perf_counter()
    g = getattr(graphs, name)(*args, **kw)
    return g, time.perf_counter() - t0


def scipy_cardinality(g) -> tuple:
    """Worker process: the maximum cardinality of ``g`` by scipy
    (independent of the code under test), and the seconds it took."""
    from scipy.sparse.csgraph import maximum_bipartite_matching
    t0 = time.perf_counter()
    m = maximum_bipartite_matching(g.to_scipy().tocsr(), perm_type="column")
    return int((m >= 0).sum()), time.perf_counter() - t0


def make_graph(entry):
    """Worker process: one graph and its scipy cardinality together."""
    g, gen_s = generate(entry)
    want, scipy_s = scipy_cardinality(g)
    return g, want, gen_s, scipy_s


def main_path_cpu(entry, g, threads: int) -> tuple:
    """Worker process: the main-path graph ``g`` solved on the CPU with its
    main-path config and warm start, on ``threads`` threads.  Returns the
    outcome and the seconds it took."""
    use_src()
    torch.set_num_threads(threads)
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
    t0 = time.perf_counter()
    state = Matcher(MatcherConfig(**entry[3]), entry[4]).run(
        TorchCSR.from_host(g, device="cpu"))
    return outcome(state), time.perf_counter() - t0


def small_sets_cpu(path: str) -> dict:
    """Worker process: ``instance_sets("small")`` solved on the CPU through
    one solve path; family -> (cmatch, rmatch, phases, fallbacks,
    certified), the matching as numpy arrays with sentinel slots."""
    use_src()
    torch.set_num_threads(1)
    return {name: outcome(run_path(path, g, "cpu"))
            for name, g in small_sets().items()}


def small_sets() -> dict:
    from repro_torch.graphs import instance_sets
    return instance_sets("small")


def run_path(path: str, g, device):
    """One solve of ``g`` through a registered solve path, cheap start."""
    from repro_torch.matching import SOLVE_PATHS
    return SOLVE_PATHS[path].solve(g, device=device)


def outcome(state) -> tuple:
    return (state.cmatch.cpu().numpy(), state.rmatch.cpu().numpy(),
            int(state.phases), int(state.fallbacks), bool(state.certified))


def start_workers(pool, paths) -> tuple:
    """Start the graph workers, the sharded phase's graph workers, the CPU
    small-set workers and the CPU small-set traces (phase 6b) together.
    The CPU main-path solves start as their graphs arrive
    (:func:`collect_graphs`), on those graphs: none of them draws a graph
    again while the graphs are being drawn."""
    graphs = [pool.apply_async(generate, (e,)) for e in MAIN_PATH]
    extra = [pool.apply_async(make_graph, (e,)) for e in SHARDED_GRAPHS]
    small = {p: pool.apply_async(small_sets_cpu, (p,)) for p in paths}
    traces = pool.apply_async(small_traces_cpu)
    return graphs, extra, small, traces


def collect_graphs(pool, pending) -> tuple:
    """The main-path graphs as they arrive, each graph's scipy cardinality
    (read by :func:`check_scipy`) and its CPU main-path solve (read by
    :func:`check_cpu`) started in workers at once: (graphs, pending
    cardinalities, pending CPU solves)."""
    graphs, wants, cpu = [], [], []
    for i, (entry, r) in enumerate(zip(MAIN_PATH, pending)):
        g, gen_s = r.get()
        graphs.append(g)
        wants.append(pool.apply_async(scipy_cardinality, (g,)))
        cpu.append(pool.apply_async(main_path_cpu,
                                    (entry, g, CPU_THREADS[i])))
        say(f"graph {label(entry)}: {g.nc} x {g.nr}, {g.nnz} edges, "
            f"generated in {gen_s:.1f} s")
    return graphs, wants, cpu


def check_scipy(rows, wants) -> list:
    """Phase 2's cardinalities against scipy's, which workers computed
    meanwhile; returns scipy's cardinality of each main-path graph."""
    got = [w.get() for w in wants]
    for entry, (want, scipy_s) in zip(MAIN_PATH, got):
        say(f"scipy cardinality of {label(entry)}: {want} in "
            f"{scipy_s:.1f} s")
    for row in rows:
        want = got[[label(e) for e in MAIN_PATH].index(row["graph"])][0]
        if row["cardinality"] != want:
            fail(f"{row['graph']} via {row['path']}: cardinality "
                 f"{row['cardinality']} != scipy's {want}")
    say(f"main path: all {len(rows)} runs at scipy's cardinality")
    return [w for w, _ in got]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def distinct(ids, n: int) -> int:
    """How many distinct values in [0, n) ``ids`` holds."""
    seen = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    seen[ids.long().clamp(0, n)] = True
    return int(seen[:n].sum())


def push_bytes(ecol, cadj, bfs, root, rmatch, level: int) -> int:
    """Bytes one push sweep (the fused kernel) must move for this level's
    inputs: ecol and bfs whole, the (nr+1,) winner write; cadj only for
    the edges whose column is on the frontier (WR: and whose root is
    alive), root and rmatch once per distinct column and row those edges
    touch."""
    nc, nr = bfs.numel() - 1, rmatch.numel() - 1
    c = ecol.long()
    on = bfs[c] == level
    nbytes = 4 * ecol.numel() + 4 * (nc + 1) + 4 * (nr + 1)
    if root is not None:
        nbytes += 4 * distinct(c[on], nc)
        on &= bfs[root[c].long()] >= 1
    return nbytes + 4 * int(on.sum()) + 4 * distinct(cadj[on], nr)


def proposal_bytes(ecol, cadj, bfs, root, rmatch, level: int) -> int:
    """The proposal kernel's bytes: the push sweep's reads, and the
    (nnz_pad,) proposal write in place of the winner write."""
    return (push_bytes(ecol, cadj, bfs, root, rmatch, level)
            - 4 * rmatch.numel() + 4 * ecol.numel())


def pull_bytes(radj, erow, bfs, root, rmatch, level: int) -> int:
    """Bytes one pull sweep must move for this level's inputs: erow whole;
    rmatch once per distinct row of the mirror; bfs of the matched column
    once per distinct matched row; radj only for the edges of unreached
    rows; bfs (WR: and root) once per distinct column those edges touch;
    the (nr+1,) winner write."""
    nc, nr = bfs.numel() - 1, rmatch.numel() - 1
    real = erow < nr
    r = erow[real].long()
    cm = rmatch[r]
    unreached = (cm == -1) | ((cm >= 0) & (bfs[cm.clamp(0, nc).long()] == 1))
    rows = distinct(r, nr)
    matched_rows = distinct(r[cm >= 0], nr)
    cols = distinct(radj[real][unreached], nc)
    return (4 * erow.numel() + 4 * rows + 4 * matched_rows
            + 4 * int(unreached.sum())
            + 4 * cols * (2 if root is not None else 1) + 4 * (nr + 1))


def bits_bytes(bfs, root, level: int) -> int:
    """Bytes the pull's column pass must move: bfs whole, the
    ceil((nc+1)/32) words written; WR also root for each column on the
    frontier and bfs once per distinct root of those."""
    nc = bfs.numel() - 1
    nbytes = 4 * (nc + 1) + 4 * ((nc + 32) // 32)
    if root is not None:
        on = bfs == level
        nbytes += 4 * int(on.sum()) + 4 * distinct(root[on], nc)
    return nbytes


def bound_ms(nbytes: int) -> float:
    """Least time on this card to move ``nbytes`` over HBM bandwidth."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def warm_up() -> None:
    """One small solve first, so CUDA context and module loading do not
    land in the first main-path wall time."""
    from repro_torch.graphs import instance_sets
    from repro_torch.matching import Matcher, TorchCSR
    Matcher(warm_start="cheap").run(
        TorchCSR.from_host(instance_sets("mini")["rand"]))
    torch.cuda.synchronize()


def matcher_for(cfg, ws: str, mesh=None):
    """``Matcher(cfg, ws)``, or over ``mesh`` the ``ShardedMatcher``."""
    from repro_torch.matching import Matcher, ShardedMatcher
    if mesh is None:
        return Matcher(cfg, ws)
    return ShardedMatcher(mesh, "data", cfg, ws)


def counted_run(g, cfg, ws: str, mesh=None) -> tuple:
    """``TorchCSR.from_host`` (and ``with_csc``; over ``mesh`` then
    ``shard``) then the matcher's ``run``, every launch and solver count
    set to 0 just before and read just after; returns (state, graph,
    row): the wall, the upload alone, the counts."""
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.matching import TorchCSR
    from repro_torch.matching.solve import COUNTERS

    torch.cuda.synchronize()
    reset_launches()
    COUNTERS.reset()
    t0 = time.perf_counter()
    graph = TorchCSR.from_host(g)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    csc_s = 0.0
    if cfg.dirop:
        t1 = time.perf_counter()
        graph = graph.with_csc()
        torch.cuda.synchronize()
        csc_s = time.perf_counter() - t1
    if mesh is not None:
        graph = graph.shard(mesh, "data")
    matcher = matcher_for(cfg, ws, mesh)
    state = matcher.run(graph)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, graph, dict(wall_s=wall, upload_s=upload, with_csc_s=csc_s,
                              launches=dict(LAUNCHES), **matcher.last_counts)


def sync_debug_count(matcher, graph) -> tuple:
    """``matcher.run(graph)`` under torch's sync debug mode: (waits of the
    host for the card that it reports, the solver's own host syncs)."""
    from repro_torch.matching.solve import COUNTERS
    torch.cuda.synchronize()
    before = COUNTERS.host_syncs
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            matcher.run(graph)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (sum("synchroniz" in str(w.message) for w in caught),
            COUNTERS.host_syncs - before)


WARM_RUNS = 3


def solve_once(g, cfg, ws: str, mesh=None) -> tuple:
    """One configuration cold (its cache entry built, graphs captured) and
    ``WARM_RUNS`` times warm (hits: no new entry, no new capture), each
    through the user's entry points with every count set to 0 just before
    it; then one run under the sync debug mode.  Returns (last warm state,
    cold state, row): the last warm run's counts, the best warm wall and
    all of them, the cold wall, and the entry's bytes.  ``mesh``: through
    ``ShardedMatcher`` over it."""
    from repro_torch.matching import compile_cache_info
    from repro_torch.matching.cache import compile_cache_entry

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    misses = compile_cache_info()["misses"]
    cold, graph, cold_row = counted_run(g, cfg, ws, mesh)
    key = compile_cache_info()["keys"][-1]
    prog = compile_cache_entry(key)
    if compile_cache_info()["misses"] != misses + 1 or prog is None:
        fail(f"the cold run of {cfg.name} built no cache entry")
    dev = graph.device
    captures = prog.captures(dev)
    del graph
    torch.cuda.empty_cache()
    # the entry's buffers and its graphs' pool, less the state it returned
    entry_reserved = (torch.cuda.memory_reserved() - reserved
                      - 4 * (cold.cmatch.numel() + cold.rmatch.numel()))
    torch.cuda.reset_peak_memory_stats()
    # three warm runs, each with its upload: the best wall is reported (the
    # upload from pageable host memory varies from run to run)
    walls = []
    for _ in range(WARM_RUNS):
        warm, graph, row = counted_run(g, cfg, ws, mesh)
        walls.append(row["wall_s"])
    if compile_cache_info()["misses"] != misses + 1:
        fail(f"the warm run of {cfg.name} missed the cache")
    if prog.captures(dev) != captures:
        fail(f"the warm run of {cfg.name} captured "
             f"{prog.captures(dev) - captures} more graphs")
    debug_waits, debug_syncs = sync_debug_count(matcher_for(cfg, ws, mesh),
                                                graph)
    row.update(
        cold_wall_s=cold_row["wall_s"], cold_upload_s=cold_row["upload_s"],
        warm_wall_s=min(walls), warm_walls_s=walls,
        cold_host_syncs=cold_row["host_syncs"],
        cold_launches=cold_row["launches"], sync_debug_waits=debug_waits,
        sync_debug_host_syncs=debug_syncs, graphs_captured=captures,
        entry_static_bytes=prog.static_bytes(dev),
        entry_bytes=prog.nbytes(dev), entry_reserved_bytes=entry_reserved,
        phases=int(warm.phases), fallbacks=int(warm.fallbacks),
        certified=bool(warm.certified),
        max_memory_allocated=torch.cuda.max_memory_allocated())
    return warm, cold, row


def same_outcome(a, b) -> bool:
    ca, ra, *rest_a = a
    cb, rb, *rest_b = b
    return bool((ca == cb).all() and (ra == rb).all()) and rest_a == rest_b


def main_path(graphs) -> tuple:
    """Phase 2: every run of ``MAIN_PATH`` and ``PATH_RUNS``, cold and warm,
    each checked for a valid matching, the warm state against the cold
    one, for no wait beyond its host syncs and for its own kernel or
    branch (the cardinality against scipy's later, :func:`check_scipy`).
    The cache is cleared after each graph's runs.  Returns the rows and,
    per run, its main-path graph and warm outcome (for :func:`check_cpu`
    and the sharded phase)."""
    from repro_torch.core import validate_matching
    from repro_torch.matching import (SOLVE_PATHS, MatcherConfig,
                                      compile_cache_clear)

    runs = []
    for i, entry in enumerate(MAIN_PATH):
        body = "wr" if entry[3].get("kernel", "gpubfs_wr") == "gpubfs_wr" \
            else "plain"
        runs.append((i, "jnp", entry[3], entry[4],
                     (f"frontier_expand_fused_{body}",), ()))
    runs += PATH_RUNS
    runs.sort(key=lambda r: r[0])                     # graph by graph
    results, outcomes = [], []
    for i, (gi, path, cfg_kw, ws, must, zero) in enumerate(runs):
        g, expr = graphs[gi], label(MAIN_PATH[gi])
        cfg = SOLVE_PATHS[path].configure(MatcherConfig(**cfg_kw))
        state, cold, row = solve_once(g, cfg, ws)
        got = outcome(state)
        outcomes.append((gi, path, got))
        same_cold = same_outcome(got, outcome(cold))
        cm, rm = state.to_host()
        card = validate_matching(g, cm, rm)
        row = dict(graph=expr, path=path, config=cfg.name,
                   overrides={k: v for k, v in dataclasses.asdict(cfg).items()
                              if v != getattr(MatcherConfig(), k)},
                   warm_start=ws, nc=g.nc, nr=g.nr, nnz=g.nnz,
                   cardinality=card, cold_equal_warm=same_cold, **row)
        say("main path:", json.dumps(row))
        what = f"{expr} via {path}"
        if not row["certified"]:
            fail(f"{what}: result not certified maximum")
        if not same_cold:
            fail(f"{what}: the warm run's state differs from the cold run's")
        if row["sync_debug_waits"] != row["sync_debug_host_syncs"]:
            fail(f"{what}: the sync debug mode saw "
                 f"{row['sync_debug_waits']} waits for "
                 f"{row['sync_debug_host_syncs']} host syncs")
        for m in must:
            seen = row["launches"].get(m, row.get(m))
            if not seen:
                fail(f"{what}: {m} is {seen}, the run did not take its path")
        for k in zero:
            if row["launches"][k]:
                fail(f"{what}: {k} launched {row['launches'][k]} times")
        results.append(row)
        if i + 1 == len(runs) or runs[i + 1][0] != gi:
            del state, cold
            compile_cache_clear()
            torch.cuda.empty_cache()
    return results, outcomes


def check_cpu(outcomes, cpu_pending) -> None:
    """Every main-path and path run's state equals the CPU's bit for bit:
    the workers' runs of each main-path graph with its main-path config
    (``cpu_pending``); every path gives that config's state."""
    cpu = {}
    for gi, path, got in outcomes:
        if gi not in cpu:
            cpu[gi], cpu_s = cpu_pending[gi].get()
            say(f"cpu run of {label(MAIN_PATH[gi])}: {cpu_s:.1f} s")
        if not same_outcome(got, cpu[gi]):
            fail(f"{label(MAIN_PATH[gi])} via {path}: the card's state "
                 f"differs from the CPU's")
    say(f"main path: all {len(outcomes)} runs equal the CPU's state")


def edge_variants(graph) -> dict:
    """The fused kernel's other edge layouts, each the same edge set:
    the slots in a seeded random order (ecol no longer sorted), and ecol /
    cadj as views 1, 2 and 3 int32 slots into larger buffers (offsets of
    4, 8 and 12 bytes, so the vector body has head and tail slots), also at
    two offsets that differ (cadj then read slot by slot)."""
    gen = torch.Generator(device=graph.ecol.device).manual_seed(15)
    perm = torch.randperm(graph.ecol.numel(), generator=gen,
                          device=graph.ecol.device)

    def view(t, offset):
        buf = torch.full((t.numel() + offset,), -99, dtype=torch.int32,
                         device=t.device)
        buf[offset:] = t
        return buf[offset:]

    out = {"permuted": (graph.ecol[perm], graph.cadj[perm])}
    for oe, oc in ((1, 1), (2, 2), (3, 3), (1, 3)):
        out[f"views at +{oe}/+{oc}"] = (view(graph.ecol, oe),
                                        view(graph.cadj, oc))
    return out


def device_args(kind: str, args: tuple) -> tuple:
    """A kernel's arguments as the captured solve passes them: the level a
    0-d int32 tensor on the card, and (the sweeps) an open gate."""
    level = torch.full((), args[-1], dtype=torch.int32, device=CARD)
    if kind == "bits":
        return (*args[:-1], level)
    return (*args[:-1], level, torch.ones_like(level))


def check_levels(graph, warm, wr: bool, wr_exact: bool, extra: bool,
                 variants=None) -> dict:
    """The first BFS phase from ``warm``, level by level: the fused kernel
    against its plain version and, with ``extra``, the proposal kernel,
    the pull kernel and the pull's column pass against theirs (the pull
    also against the fused kernel), all bit for bit; the fused kernel also
    on each of ``variants`` (name -> (ecol, cadj), the same edges in
    another layout) against the same winners; each also with its level
    read from a device scalar and an open gate (:func:`device_args`)
    against its immediate-level launch.  Returns, per kernel, one dict a
    level: its arguments, bound, level and rows won."""
    from repro_torch.kernels.frontier_expand import (
        frontier_bits, frontier_bits_ref, frontier_expand,
        frontier_expand_fused, frontier_expand_fused_ref,
        frontier_expand_pull, frontier_expand_pull_ref, frontier_expand_ref)
    from repro_torch.matching.solve import _apply_winner, level0_state

    nc, nr = graph.nc, graph.nr
    bfs, root = level0_state(warm.cmatch)
    pred = torch.full((nr + 1,), nc, dtype=torch.int32,
                      device=warm.cmatch.device)
    rmatch, level = warm.rmatch, 2
    out = {k: [] for k in ("fused", "proposals", "pull", "bits")}
    body = "WR" if wr else "plain"

    def check(name, fn, got, want, args, nbytes):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{name} ({body}) differs from its plain version at "
                 f"level {level}")
        if not torch.equal(fn(*device_args(name, args)), got):
            fail(f"{name} ({body}) with its level on the card differs from "
                 f"its launch with the immediate at level {level}")
        out[name].append(dict(args=args, bound=bound_ms(nbytes),
                              level=level, won=won))

    while True:
        rt = root if wr else None
        args = (graph.ecol, graph.cadj, bfs, rt, rmatch, level)
        win = frontier_expand_fused(*args)
        won = int((win < 2**30).sum())
        check("fused", frontier_expand_fused, win,
              frontier_expand_fused_ref(*args), args, push_bytes(*args))
        for vname, (ve, vc) in (variants or {}).items():
            if not torch.equal(frontier_expand_fused(ve, vc, *args[2:]),
                               win):
                fail(f"fused kernel ({body}) on the {vname} edges differs "
                     f"from its plain version at level {level}")
        if extra:
            check("proposals", frontier_expand, frontier_expand(*args),
                  frontier_expand_ref(*args), args, proposal_bytes(*args))
            pargs = (graph.radj, graph.erow, bfs, rt, rmatch, level)
            pull = frontier_expand_pull(*pargs)
            check("pull", frontier_expand_pull, pull,
                  frontier_expand_pull_ref(*pargs), pargs, pull_bytes(*pargs))
            if not torch.equal(pull, win):
                fail(f"pull kernel ({body}) differs from the fused kernel "
                     f"at level {level}")
            bargs = (bfs, rt, level)
            check("bits", frontier_bits, frontier_bits(*bargs),
                  frontier_bits_ref(*bargs), bargs, bits_bytes(*bargs))
        bfs, root, pred, rmatch, ins, _ = _apply_winner(
            win, bfs, root, pred, rmatch, level, wr=wr, wr_exact=wr_exact)
        level += 1
        if not bool(ins):
            return out


# kernel -> the parts of its device time in the profiler: part -> a
# fragment of the device kernels' names
SPLITS = {"fused": {"sweep": "fused_sweep", "fill": "emset"},
          "proposals": {"sweep": "proposals"},
          "pull": {"bits": "frontier_bits", "sweep": "pull_sweep",
                   "fill": "emset"},
          "bits": {"bits": "frontier_bits"}}


def kernel_checks(graphs) -> list:
    """Phase 3: each kernel against its plain version over the first BFS
    phase of the main-path graphs (the fused sweep on every graph and both
    bodies, on kron also with its edge slots permuted and as misaligned
    views; the proposal kernel, the pull kernel and its column pass on
    kron WR and random plain), timed with CUDA events over the phase and
    each of its first 16 levels alone, and in profiler device time by
    part; the pull beside the fused sweep level by level."""
    from repro_torch.kernels.frontier_expand import (
        frontier_bits, frontier_bits_ref, frontier_expand,
        frontier_expand_fused, frontier_expand_fused_ref,
        frontier_expand_pull, frontier_expand_pull_ref, frontier_expand_ref)
    from repro_torch.matching import (Matcher, MatcherConfig, TorchCSR,
                                      compile_cache_clear)

    fns = {"fused": ("frontier_expand_fused", frontier_expand_fused,
                     frontier_expand_fused_ref),
           "proposals": ("frontier_expand", frontier_expand,
                         frontier_expand_ref),
           "pull": ("frontier_expand_pull", frontier_expand_pull,
                    frontier_expand_pull_ref),
           "bits": ("frontier_bits", frontier_bits, frontier_bits_ref)}
    rows = []
    for gi, (entry, g) in enumerate(zip(MAIN_PATH, graphs)):
        expr, cfg_kw, ws = label(entry), entry[3], entry[4]
        graph = TorchCSR.from_host(g)
        if gi in (KRON, RANDOM):
            graph = graph.with_csc()
        warm = Matcher(MatcherConfig(**cfg_kw), ws).init(graph)
        variants = edge_variants(graph) if gi == KRON else {}
        for wr in (True, False):
            extra = (gi, wr) in ((KRON, True), (RANDOM, False))
            per = check_levels(graph, warm, wr,
                               wr and cfg_kw.get("wr_exact", False), extra,
                               variants)
            mine = {}
            for kind, levels in per.items():
                if not levels:
                    continue
                name, kernel, plain = fns[kind]
                states = [lv["args"] for lv in levels]
                n = len(states)
                k_ms = cuda_ms(lambda: [kernel(*a) for a in states]) / n
                dev_states = [device_args(kind, a) for a in states]
                kd_ms = cuda_ms(lambda: [kernel(*a) for a in dev_states]) / n
                # the plain versions once over the phase: milliseconds a
                # level, where the kernels take tenths of one
                p_ms = cuda_ms(lambda: [plain(*a) for a in states],
                               reps=1, warmup=0) / n
                row = dict(graph=expr, kernel=f"{name}_{'wr' if wr else 'plain'}",
                           levels_checked=n, max_abs_err=0, kernel_ms=k_ms,
                           kernel_ms_device_level=kd_ms, plain_ms=p_ms,
                           bound_ms=sum(lv["bound"] for lv in levels) / n,
                           nnz_pad=graph.nnz_pad)
                # each of the first 16 levels alone: [level, bound ms, ms,
                # rows won]
                row["per_level"] = [
                    [lv["level"], lv["bound"],
                     cuda_ms(lambda: kernel(*lv["args"])), lv["won"]]
                    for lv in levels[:16]]
                # device time by part (the pull: column pass, sweep, fill)
                prof = device_profile(lambda: [kernel(*a) for a in states],
                                      SPLITS[kind])
                for part in SPLITS[kind]:
                    v = prof[f"{part}_ms"]
                    row[f"device_ms_{part}"] = (
                        v / n if isinstance(v, float) else v)
                if kind == "fused" and variants:
                    row["variants_checked"] = list(variants)
                    ve, vc = variants["permuted"]
                    row["kernel_ms_permuted"] = cuda_ms(
                        lambda: [kernel(ve, vc, *a[2:]) for a in states]) / n
                say("kernel vs plain:", json.dumps(row))
                rows.append(row)
                mine[kind] = row
            if "pull" in mine:
                # does the pull pay on the card: [level, rows won, fused
                # ms, pull ms, its column pass ms, fused bound, pull bound]
                say("pull vs push per level:", json.dumps(dict(
                    graph=expr, body="WR" if wr else "plain", levels=[
                        [f[0], f[3], f[2], p[2], b[2], f[1], p[1]]
                        for f, p, b in zip(mine["fused"]["per_level"],
                                           mine["pull"]["per_level"],
                                           mine["bits"]["per_level"])])))
        del graph, warm, variants
        compile_cache_clear()
        torch.cuda.empty_cache()
    return rows


def device_profile(fn, share_of: dict, split_ops=(), ranges=()) -> dict:
    """``fn()`` once under ``torch.profiler``: the wall time, the device's
    kernel time and busy share of the wall time (the profiler's own cost
    lands in the wall time, so the share is a floor), for each ``name:
    text`` of ``share_of`` the device time, launches and share of device
    time of the kernels whose name holds ``text``, the top kernels, for
    each torch op named in ``split_ops`` its device time by input shape,
    and for each ``record_function`` range named in ``ranges`` the device
    time of the kernels launched inside it and its share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(split_ops)) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: a CPU op's device time repeats its kernels', and
    # a range of ``ranges`` also shows as a device event spanning its own
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or \
                evt.key in ranges:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    out = dict(wall_s=wall,
               device_s=device_s if rows else "not measured",
               busy_share=device_s / wall if rows else "not measured")
    for name, text in share_of.items():
        part = sum(r[0] for r in rows if text in r[2]) / 1e6
        out[f"{name}_ms"] = part * 1e3 if rows else "not measured"
        out[f"{name}_launches"] = sum(r[1] for r in rows if text in r[2])
        out[f"{name}_share_of_device"] = (part / device_s if rows
                                          else "not measured")
    out["top"] = [dict(kernel=k[:80], ms=us / 1e3, count=n)
                  for us, n, k in rows[:8]]
    for name in ranges:
        us = sum(getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0))
                 for e in prof.key_averages() if e.key == name
                 and e.device_type == torch.autograd.DeviceType.CPU)
        seen = rows and us > 0
        out[f"{name}_ms"] = us / 1e3 if seen else "not measured"
        out[f"{name}_share_of_device"] = (us / 1e6 / device_s if seen
                                          else "not measured")
    if split_ops:
        ops = [(getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0)), e.count, e.key,
                str(e.input_shapes))
               for e in prof.key_averages(group_by_input_shape=True)
               if e.key in split_ops]
        out["by_shape"] = [dict(op=k, shapes=sh[:100], ms=us / 1e3, count=n)
                           for us, n, k, sh in sorted(ops, reverse=True)[:8]]
    return out


# kernel-name fragments read in the profiles: the fused sweep K1, and torch's
# scatter kernel (scatter_reduce and scatter_, the solver's min-scatters)
PROFILE_SHARES = {"sweep": "fused_sweep", "scatter": "scatter_gather"}


def profile_main_path(entry, g) -> dict:
    """Phase 5: one main-path solve again under ``torch.profiler``."""
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR

    graph = TorchCSR.from_host(g)
    matcher = Matcher(MatcherConfig(**entry[3]), entry[4])
    matcher.run(graph)                      # the cache entry and its graphs
    out = dict(graph=label(entry), **device_profile(
        lambda: matcher.run(graph), PROFILE_SHARES,
        ("aten::scatter_reduce", "aten::scatter_", "aten::where",
         "aten::arange")))
    # the card's span of one warm solve in CUDA events (the profiler may
    # not see every kernel inside a conditional node's body)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    matcher.run(graph)
    end.record()
    end.synchronize()
    out["event_wall_s"] = time.perf_counter() - t0
    out["event_span_s"] = start.elapsed_time(end) / 1e3
    # every wait of the host for the card, counted by torch's sync debug
    # mode, beside the solver's own count of the device values it reads
    out["device_syncs"], out["host_syncs"] = sync_debug_count(matcher, graph)
    say("profile:", json.dumps(out))
    return out


def small_sets_bit_exact(cpu_results) -> None:
    """Phase 4: every solve path on the card gives the CPU's answer, which
    worker processes computed (``cpu_results``: path -> pending result)."""
    from repro_torch.matching import SOLVE_PATHS

    for path in SOLVE_PATHS:
        t0 = time.perf_counter()
        cuda = {name: outcome(run_path(path, g, "cuda"))
                for name, g in small_sets().items()}
        cuda_s = time.perf_counter() - t0
        cpu = cpu_results[path].get()
        for name, (ca, ra, *rest) in cuda.items():
            cb, rb, *rest_b = cpu[name]
            if not ((ca == cb).all() and (ra == rb).all()
                    and rest == rest_b):
                fail(f"instance_sets('small')[{name!r}] via {path} differs "
                     f"between the card and the CPU")
        say(f"small sets via {path}: card == CPU on {len(cuda)} families, "
            f"phases {[v[2] for v in cuda.values()]}, all certified "
            f"{all(v[4] for v in cuda.values())}, card {cuda_s:.2f} s")


# ---------------------------------------------------------------------------
# the edge-sharded matcher: ShardedMatcher on one card (phase 5b)
# ---------------------------------------------------------------------------
SHARDS = 4
# (main-path graph, solve path, config on top of the path's overrides,
# warm start): each sharded SHARDS ways on the card
SHARDED_RUNS = [
    (KRON, "jnp", dict(), "cheap"),
    (KRON, "legacy", dict(), "cheap"),
    (KRON, "dirop_pallas", dict(), "cheap"),
    (RANDOM, "jnp", dict(kernel="gpubfs"), "karp_sipser"),
]
# the phase's other graphs, made with their scipy cardinality by phase 1's
# workers: one of the 2^16 serving bucket (sharded 1, 2 and 3 ways) and
# the service's oversize request, past the ladder's top of 262,144^2
SHARDED_GRAPHS = [
    ("random_bipartite", (60000, 60000, 8.0), dict(seed=5)),
    ("random_bipartite", (1 << 19, 1 << 19, 8.0), dict(seed=6)),
]
BUCKET_SHARDS = (1, 2, 3)


def sharded_bodies(path: str, cfg) -> dict:
    """The kernel bodies a sharded run of ``path`` launches, each with the
    solver count whose levels it sweeps (once a shard a level)."""
    body = "wr" if cfg.kernel == "gpubfs_wr" else "plain"
    push = "frontier_expand" if path == "legacy" else "frontier_expand_fused"
    out = {f"{push}_{body}": "push_levels"}
    if path == "dirop_pallas":
        out[f"frontier_expand_pull_{body}"] = "pull_levels"
        out[f"frontier_bits_{body}"] = "pull_levels"
    return out


def sharded_checks(what, row, got, cold, single, single_row, want, g,
                   path, cfg, shards) -> None:
    """A sharded run against the single-device run of the same graph and
    path: the state bit for bit (warm and cold), valid, certified, at
    scipy's cardinality, the same host syncs and levels, one merge a
    level, no wait beyond its host syncs, and its kernels launched once a
    shard a level."""
    from repro_torch.core import validate_matching
    if not (same_outcome(got, single) and same_outcome(outcome(cold),
                                                       single)):
        fail(f"{what}: the state differs from the single-device run's")
    card = validate_matching(g, got[0][:g.nc], got[1][:g.nr])
    if card != want or not row["certified"]:
        fail(f"{what}: cardinality {card} (scipy's {want}), certified "
             f"{row['certified']}")
    for k in ("host_syncs", "cold_host_syncs", "levels", "push_levels",
              "pull_levels"):
        if row[k] != single_row[k]:
            fail(f"{what}: {k} {row[k]} != the single-device run's "
                 f"{single_row[k]}")
    if row["merges"] != row["levels"]:
        fail(f"{what}: {row['merges']} merges for {row['levels']} levels")
    if row["sync_debug_waits"] != row["sync_debug_host_syncs"]:
        fail(f"{what}: the sync debug mode saw {row['sync_debug_waits']} "
             f"waits for {row['sync_debug_host_syncs']} host syncs")
    for body, levels in sharded_bodies(path, cfg).items():
        if not row[levels] or row["launches"][body] != shards * row[levels]:
            fail(f"{what}: {body} launched {row['launches'][body]} times "
                 f"for {shards} shards x {row[levels]} levels")


def shard_slice_checks(g, mesh) -> dict:
    """K1a, K2a and K3a on each shard's slice of kron's edge buffers over
    the first BFS phase from the cheap warm start, level by level, against
    their plain versions on the same slices, bit for bit; K1a and K3a
    writing into rows of one winner buffer, whose min is the whole edge
    list's winners; each timed a shard launch (CUDA events) beside its
    bound, and the merge."""
    from repro_torch.kernels.frontier_expand import (
        frontier_expand, frontier_expand_fused, frontier_expand_fused_ref,
        frontier_expand_pull, frontier_expand_pull_ref, frontier_expand_ref)
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
    from repro_torch.matching.solve import _apply_winner, level0_state

    graph = TorchCSR.from_host(g).with_csc().shard(mesh, "data")
    d, nr = graph.shards, graph.nr
    warm = Matcher(MatcherConfig(), "cheap").init(graph)
    bfs, root = level0_state(warm.cmatch)
    pred = torch.full((nr + 1,), graph.nc, dtype=torch.int32,
                      device=bfs.device)
    rmatch, level = warm.rmatch, 2
    push = list(zip(graph.shard_slices("ecol"), graph.shard_slices("cadj")))
    pull = list(zip(graph.shard_slices("radj"), graph.shard_slices("erow")))
    win = torch.empty((2 * d, nr + 1), dtype=torch.int32, device=bfs.device)
    merged = torch.empty(nr + 1, dtype=torch.int32, device=bfs.device)
    kinds = {"fused": (frontier_expand_fused, frontier_expand_fused_ref,
                       push, push_bytes),
             "proposals": (frontier_expand, frontier_expand_ref, push,
                           proposal_bytes),
             "pull": (frontier_expand_pull, frontier_expand_pull_ref, pull,
                      pull_bytes)}
    states, bounds = [], {k: [] for k in kinds}
    while True:
        state = (bfs, root, rmatch, level)
        for kind, (kernel, plain, edges, nbytes) in kinds.items():
            for i, (cols, rows) in enumerate(edges):
                out = {} if kind == "proposals" else dict(
                    out=win[i + (d if kind == "pull" else 0)])
                got = kernel(cols, rows, *state, **out)
                if not torch.equal(got, plain(cols, rows, *state)):
                    fail(f"{kind} kernel on shard {i} differs from its "
                         f"plain version at level {level}")
                bounds[kind].append(bound_ms(nbytes(cols, rows, *state)))
        torch.amin(win[:d], dim=0, out=merged)
        if not (torch.equal(merged, frontier_expand_fused(
                graph.ecol, graph.cadj, *state))
                and torch.equal(win[d:].amin(0), merged)):
            fail(f"the shards' merged winners differ from the whole edge "
                 f"list's at level {level}")
        states.append(state)
        bfs, root, pred, rmatch, ins, _ = _apply_winner(
            merged, bfs, root, pred, rmatch, level, wr=True, wr_exact=False)
        level += 1
        if not bool(ins):
            break
    out = dict(levels_checked=len(states), shards=d,
               per_shard=graph.nnz_pad // d, max_abs_err=0)
    n = len(states) * d
    for kind, (kernel, _, edges, _) in kinds.items():
        launch = lambda: [kernel(c, r, *s)                  # noqa: E731
                          for s in states for c, r in edges]
        # events over a loop of Python calls also time the wrapper, as
        # phase 3's do; the profiler's device time does not
        prof = device_profile(launch, SPLITS[kind])
        out[kind] = dict(
            ms=cuda_ms(launch, reps=5) / n, bound_ms=sum(bounds[kind]) / n,
            **{f"device_ms_{part}": (prof[f"{part}_ms"] / n if isinstance(
                prof[f"{part}_ms"], float) else prof[f"{part}_ms"])
               for part in SPLITS[kind]})
    out["merge"] = dict(
        ms=cuda_ms(lambda: torch.amin(win[:d], dim=0, out=merged)),
        bound_ms=bound_ms(4 * (d + 1) * (nr + 1)))
    return out


def sharded_phase(graphs, wants, extra, phase2) -> dict:
    """Phase 5b (module doc).  ``graphs``/``wants``: the main-path graphs
    and scipy's cardinalities; ``extra``: the pending (graph, scipy
    cardinality, ...) of ``SHARDED_GRAPHS``; ``phase2``: (graph index,
    path) -> (row, warm outcome) of phase 2.  Returns per kernel body the
    launches of its sharded runs (the counts set to 0 just before each
    and read just after) and the shard-slice levels checked."""
    from repro_torch.core import validate_matching
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.matching import (SOLVE_PATHS, Matcher, MatcherConfig,
                                      TorchCSR, compile_cache_clear,
                                      make_mesh)
    from repro_torch.serving import Bucketizer, MatchingService, ladder

    mesh = make_mesh((SHARDS,), ("data",), devices=[CARD] * SHARDS)
    launches = {body: 0 for body in KERNELS}

    def counted(row):
        for body in KERNELS:
            launches[body] += row["launches"][body]

    for gi, path, kw, ws in SHARDED_RUNS:
        g, expr = graphs[gi], label(MAIN_PATH[gi])
        cfg = SOLVE_PATHS[path].configure(MatcherConfig(**kw))
        state, cold, row = solve_once(g, cfg, ws, mesh)
        single_row, single = phase2[(gi, path)]
        row = dict(graph=expr, path=path, config=cfg.name, warm_start=ws,
                   shards=SHARDS, single_warm_wall_s=single_row["warm_wall_s"],
                   warm_over_single=row["warm_wall_s"]
                   / single_row["warm_wall_s"], **row)
        say("sharded:", json.dumps(row))
        sharded_checks(f"{expr} via {path}, {SHARDS} shards", row,
                       outcome(state), cold, single, single_row, wants[gi],
                       g, path, cfg, SHARDS)
        counted(row)
        del state, cold
        compile_cache_clear()
        torch.cuda.empty_cache()

    # the shards' kernels against their plain versions on kron's slices
    slices = shard_slice_checks(graphs[KRON], mesh)
    say("sharded kernel slices:", json.dumps(dict(
        graph=label(MAIN_PATH[KRON]), **slices)))
    compile_cache_clear()
    torch.cuda.empty_cache()

    # the 2^16 serving bucket, sharded 1, 2 and 3 ways
    (g16, want16, *_), (big, big_want, *_) = [r.get() for r in extra]
    cfg, ws = MatcherConfig(), "cheap"
    bz = Bucketizer(ladder(**SERVE_LADDER))
    padded = bz.admit(g16).graph.to_host()
    single, _, single_row = solve_once(padded, cfg, ws)
    single = outcome(single)
    expr = f"{label(SHARDED_GRAPHS[0])} in the 2^16 bucket"
    for d in BUCKET_SHARDS:
        m = make_mesh((d,), ("data",), devices=[CARD] * d)
        state, cold, row = solve_once(padded, cfg, ws, m)
        row = dict(graph=expr, path="jnp", shards=d,
                   single_warm_wall_s=single_row["warm_wall_s"], **row)
        say("sharded:", json.dumps(row))
        sharded_checks(f"{expr}, {d} shards", row, outcome(state), cold,
                       single, single_row, want16, padded, "jnp", cfg, d)
        counted(row)
    compile_cache_clear()
    torch.cuda.empty_cache()

    # the service's oversize lane
    svc = MatchingService(
        bucketizer=Bucketizer(ladder(**SERVE_LADDER), oversize="shard",
                              validate=True),
        config=cfg, warm_start=ws, mesh=mesh)
    torch.cuda.synchronize()
    reset_launches()
    res = svc.submit(big).result(timeout=600)
    torch.cuda.synchronize()
    served = dict(LAUNCHES)
    snap = svc.metrics.snapshot()
    svc.close()
    want = Matcher(cfg, ws).run(TorchCSR.from_host(big).bucketed())
    cm, rm = res.matching()
    card = validate_matching(big, cm, rm)
    row = dict(graph=label(SHARDED_GRAPHS[1]), nnz=big.nnz,
               route=res.route, bucket=res.bucket, certified=res.certified,
               cardinality=card, scipy_cardinality=big_want,
               latency_s=res.latency_s, sharded=snap["sharded"],
               launches=served)
    say("sharded oversize request:", json.dumps(row))
    if res.route != "sharded" or res.bucket is not None:
        fail(f"the oversize request took route {res.route!r}")
    if not res.certified or card != big_want or res.cardinality != big_want:
        fail(f"the oversize request: cardinality {card} (scipy's "
             f"{big_want}), certified {res.certified}")
    if not same_outcome(outcome(res.state), outcome(want)):
        fail("the oversize request's state differs from the card's "
             "single-device Matcher.run of the bucketed graph")
    if snap["sharded"] != 1 or not served["frontier_expand_fused_wr"] or \
            served["frontier_expand_fused_wr"] % SHARDS:
        fail(f"the sharded lane: sharded {snap['sharded']}, K1a launched "
             f"{served['frontier_expand_fused_wr']} times")
    for body in KERNELS:
        launches[body] += served[body]
    compile_cache_clear()
    torch.cuda.empty_cache()
    return dict(launches=launches,
                levels_checked=slices["levels_checked"] * SHARDS,
                slices=slices)


# ---------------------------------------------------------------------------
# the data axis over ranks: worlds on the card (phase 5c)
# ---------------------------------------------------------------------------
# gloo worlds of these sizes share the card; every rank solves
# SHARDED_RUNS (phase 2's configs), those in WORLD_WARM once more warm
WORLD_SIZES = (2, 4)
WORLD_WARM = ((KRON, "jnp"),)
# data-parallel training in the world of 2: mamba2-2.7b at full width cut
# to this depth (two full replicas at 64 layers do not fit one card), the
# launcher's optimizer, steps of TRAIN_BATCH x TRAIN_SEQ tokens
WORLD_TRAIN_CUTS = dict(n_layers=4)
WORLD_TRAIN_STEPS = 2
WORLD_TIMEOUT = 600
# the NCCL world's mamba2 FULL steps, held by phase 18 to its own first
# WORLD_TRAIN_STEPS steps (the same weights, optimizer and batches)
NCCL_TRAIN: dict = {}


def digest(cmatch, rmatch) -> str:
    """A sha256 of a matching (the ranks' states are compared with phase
    2's through it, not shipped whole)."""
    import hashlib
    h = hashlib.sha256()
    for a in (cmatch, rmatch):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        h.update(a.astype("int32").tobytes())
    return h.hexdigest()


def save_graph(g, path: str) -> None:
    import numpy as np
    np.savez(path, nc=g.nc, nr=g.nr, nnz=g.nnz, cxadj=g.cxadj, cadj=g.cadj,
             ecol=g.ecol)


def load_graph(path: str):
    import numpy as np
    from repro_torch.core.csr import BipartiteCSR
    z = np.load(path)
    return BipartiteCSR(nc=int(z["nc"]), nr=int(z["nr"]), nnz=int(z["nnz"]),
                        cxadj=z["cxadj"], cadj=z["cadj"], ecol=z["ecol"])


def world_solve(world, g, path: str, kw: dict, ws: str) -> dict:
    """One solve over a mesh of ``world``'s ranks (``ShardedMatcher.run``
    of the host graph: each rank uploads its shard, rank 0 the whole graph
    for the warm start), every count set to 0 just before and read just
    after, and this rank's peak device memory over it."""
    from repro_torch.distributed import comm
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.matching import (SOLVE_PATHS, MatcherConfig,
                                      ShardedMatcher, make_mesh)
    from repro_torch.matching.solve import COUNTERS
    cfg = SOLVE_PATHS[path].configure(MatcherConfig(**kw))
    mesh = make_mesh((world.size,), ("data",))
    torch.cuda.synchronize()
    reset_launches()
    COUNTERS.reset()
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = ShardedMatcher(mesh, "data", cfg, ws)
    state = m.run(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    merge = comm.counts()["all_reduce"]
    return dict(wall_s=wall, digest=digest(state.cmatch, state.rmatch),
                phases=int(state.phases), fallbacks=int(state.fallbacks),
                certified=bool(state.certified), launches=dict(LAUNCHES),
                merge_calls=merge["calls"], merge_bytes_sent=merge["bytes"],
                merge_tensors=str(state.cmatch.device),
                peak_bytes=torch.cuda.max_memory_allocated(), **m.last_counts)


def lane_service(world, faults=None):
    """A ``MatchingService`` over step 6's ladder whose oversize lane spans
    ``world`` (this must be rank 0)."""
    from repro_torch.matching import MatcherConfig, make_mesh
    from repro_torch.serving import Bucketizer, MatchingService, ladder
    return MatchingService(
        bucketizer=Bucketizer(ladder(**SERVE_LADDER), oversize="shard",
                              validate=True, device=world.device),
        config=MatcherConfig(), warm_start="cheap",
        mesh=make_mesh((world.size,), ("data",)), faults=faults)


def lane_run(svc, g, **kw) -> dict:
    """One request through ``svc``, K1a counted from 0 just before and read
    just after; its route, state digest, counts, cardinality and wall."""
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = svc.submit(g, **kw).result(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1a = LAUNCHES["frontier_expand_fused_wr"]
    out = dict(route=res.route, wall_s=wall, k1a=k1a,
               digest=digest(res.state.cmatch, res.state.rmatch),
               phases=int(res.state.phases),
               fallbacks=int(res.state.fallbacks), certified=res.certified,
               cardinality=res.cardinality)
    if res.route == "sharded":
        counts = svc.sharded_matcher().last_counts
        out.update(levels=counts["push_levels"],
                   host_syncs=counts["host_syncs"], variant=res.stats.variant)
    return out


def lane_rank(world, graph_files: dict) -> dict:
    """Phase 5c(a)'s lane on a rank of the gloo world of 2 (module doc):
    rank 0 serves kron-21, an in-bucket graph and the chaos pair on step
    5b's oversize graph; rank 1 follows, K1a counted over its loop."""
    from repro_torch.graphs import random_bipartite
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.serving import FaultInjector, serve_followers
    if world.rank:
        torch.cuda.synchronize()
        reset_launches()
        out = serve_followers(world)
        torch.cuda.synchronize()
        out["k1a"] = LAUNCHES["frontier_expand_fused_wr"]
        return out
    faults = FaultInjector(seed=0)
    t0 = time.perf_counter()
    svc = lane_service(world, faults)
    out = dict(start_s=time.perf_counter() - t0)
    out["kron"] = lane_run(svc, load_graph(graph_files[KRON]))
    sent = svc.lane.sent["run"]
    n = SERVE_LADDER["min_vertices"] * 5 // 8         # the ladder's first
    out["bucket"] = lane_run(svc, random_bipartite(n, n, 4.0, seed=7))
    out["bucket"]["headers"] = svc.lane.sent["run"] - sent
    big = load_graph(graph_files["big"])
    faults.poison("bad")
    bad = svc.submit(big, tag="bad").exception(timeout=600)
    faults.cure("bad")
    faults.kill_thread_after(0)
    killed = svc.submit(big).exception(timeout=600)
    out["chaos"] = dict(poisoned=type(bad).__name__,
                        killed=type(killed).__name__)
    out["after"] = lane_run(svc, big)
    t0 = time.perf_counter()
    svc.close()
    out.update(close_s=time.perf_counter() - t0,
               snap=svc.metrics.snapshot(), sent=dict(svc.lane.sent))
    return out


def world_rank(world, graph_files: dict, runs, train: bool, ckpt: str,
               axis_ckpt: str, refs: dict, family_ckpt: str):
    """A rank of phase 5c: every run of ``runs`` (cold, and warm where
    WORLD_WARM says), then, in the world of 2, the service's lane
    (``lane_rank``), then, with ``train``, WORLD_TRAIN_STEPS data-parallel
    steps of mamba2 cut to WORLD_TRAIN_CUTS, saved at ``ckpt``.  Then the
    same ranks as phase 5d's mesh (``World.remesh``: a world of 2 as 1 x 2,
    of 4 as 2 x 2) run phase 5d's part (saving at ``axis_ckpt``) and phase
    5e's (against the one-device ``refs``, saving at ``family_ckpt``),
    each timed."""
    use_src()
    dynamo = import_in_background()
    from repro_torch.kernels._build import load_library
    from repro_torch.matching import compile_cache_clear
    for name in ("frontier_expand", "graph_loop"):
        load_library(name)
    out = {"rank": world.rank, "backend": world.backend, "runs": []}
    graphs = {}
    for gi, path, kw, ws in runs:
        if gi not in graphs:
            graphs[gi] = load_graph(graph_files[gi])
        row = dict(cold=world_solve(world, graphs[gi], path, kw, ws))
        if (gi, path) in WORLD_WARM:
            row["warm"] = world_solve(world, graphs[gi], path, kw, ws)
        out["runs"].append(row)
        compile_cache_clear()
    del graphs
    torch.cuda.empty_cache()
    if world.size == 2:
        t0 = time.perf_counter()
        out["lane"] = lane_rank(world, graph_files)
        out["lane_s"] = time.perf_counter() - t0
        compile_cache_clear()
        torch.cuda.empty_cache()
    dynamo.join()
    if train:
        out["train"] = world_train(world, ckpt)
    t0 = time.perf_counter()
    if world.size == 2:
        mesh = world.remesh((1, 2))
        out["axis"] = axis_serve_rank(mesh)
    else:
        mesh = world.remesh((2, 2))
        out["axis"] = train_rank(mesh, axis_ckpt, AXIS_GATE_RUN,
                                 AXIS_BF16_RUN)
    torch.cuda.synchronize()
    out["axis_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["family"] = (family_serve_rank(mesh, refs) if world.size == 2
                     else train_rank(mesh, family_ckpt, AXIS_FAMILY_GATE,
                                     AXIS_FAMILY_BF16))
    torch.cuda.synchronize()
    out["family_s"] = time.perf_counter() - t0
    return out


def world_train(world, ckpt: str) -> dict:
    """WORLD_TRAIN_STEPS steps of the world's train step (ZeRO-1) from the
    seeded weights, each step's loss and wall, the peak memory, then a
    collective save at ``ckpt``."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, state_cuts
    from repro_torch.train import build_train_step
    cfg = get_config(MAMBA_ARCH, **WORLD_TRAIN_CUTS)
    model = build_model(cfg)
    opt = train_opt_config(MAMBA_ARCH)
    params = model.init(TRAIN_SEED)
    state = adamw_init(params, opt, world)
    step = build_train_step(model, opt, world=world)
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for s in range(WORLD_TRAIN_STEPS):
        b = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, s, device=world.device)
        (params, state, met), wall, _ = timed(lambda: step(params, state, b))
        losses.append(float(met["loss"]))
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated()
    _, save_s, _ = timed(lambda: save_checkpoint(
        ckpt, WORLD_TRAIN_STEPS, {"params": params, "opt": state},
        world=world, dims={"opt": state_cuts(params, opt, world, None)}))
    return dict(losses=losses, step_s=walls, peak_memory_bytes=peak,
                save_s=save_s)


def world_checks(size, results, phase2, wants_digest) -> dict:
    """Phase 5c's checks of a gloo world of ``size``: every rank's state
    phase 2's bit for bit (by digest), the counts equal on every rank, one
    merge a level, the single-device host syncs plus one a test of the
    uncaptured level and ``ALTERNATE`` loops, and each run's kernels
    launched on every rank once a level.  Returns the launches of every
    rank's runs, per body."""
    launches = {body: 0 for body in KERNELS}
    for i, (gi, path, kw, ws) in enumerate(SHARDED_RUNS):
        single_row, single = phase2[(gi, path)]
        cfg_name = f"{label(MAIN_PATH[gi])} via {path}"
        from repro_torch.matching import SOLVE_PATHS, MatcherConfig
        cfg = SOLVE_PATHS[path].configure(MatcherConfig(**kw))
        for kind in ("cold", "warm"):
            rows = [r["runs"][i].get(kind) for r in results]
            if rows[0] is None:
                continue
            what = f"{cfg_name}, {kind}, a gloo world of {size}"
            for rank, row in enumerate(rows):
                if row["digest"] != wants_digest[(gi, path)] or [
                        row["phases"], row["fallbacks"],
                        row["certified"]] != list(single[2:]):
                    fail(f"{what}: rank {rank}'s state differs from phase "
                         f"2's")
                if not row["merges"] == row["levels"] == \
                        single_row["levels"]:
                    fail(f"{what}: rank {rank}: {row['merges']} merges, "
                         f"{row['levels']} levels (phase 2: "
                         f"{single_row['levels']})")
                # the level loop's tests: levels + phases; the ALTERNATE
                # loop's: steps + one a run (every phase but the last,
                # twice where it fell back)
                want_syncs = (single_row["host_syncs"] + row["levels"]
                              + row["alternate_steps"] + 2 * row["phases"]
                              - 1 + row["fallbacks"])
                if row["host_syncs"] != want_syncs:
                    fail(f"{what}: rank {rank}: {row['host_syncs']} host "
                         f"syncs, not {want_syncs}")
                for body, levels in sharded_bodies(path, cfg).items():
                    if not row[levels] or \
                            row["launches"][body] != row[levels]:
                        fail(f"{what}: rank {rank}: {body} launched "
                             f"{row['launches'][body]} times for "
                             f"{row[levels]} levels")
                for body in KERNELS:
                    launches[body] += row["launches"][body]
            say("world:", json.dumps(dict(
                graph=label(MAIN_PATH[gi]), path=path, config=cfg.name,
                warm_start=ws, ranks=size, backend="gloo", run=kind,
                wall_s=[r["wall_s"] for r in rows],
                single_warm_wall_s=single_row["warm_wall_s"],
                peak_bytes_by_rank=[r["peak_bytes"] for r in rows],
                host_syncs=rows[0]["host_syncs"],
                single_host_syncs=single_row["host_syncs"],
                levels=rows[0]["levels"], merges=rows[0]["merges"],
                merge_bytes_sent=rows[0]["merge_bytes_sent"],
                merge_bytes_modelled=rows[0]["merge_bytes"],
                gloo_took=f"card tensors ({rows[0]['merge_tensors']}; "
                f"none staged by hand)",
                launches_by_rank=[{b: n for b, n in r["launches"].items()
                                   if n} for r in rows])))
    return launches


def world_lane_checks(results, phase2, wants, wants_digest,
                      big_want) -> int:
    """Phase 5c(a)'s lane checks (module doc) on the gloo world of 2's
    results; returns the K1a launches of its runs on every rank."""
    lane, follower = results[0]["lane"], results[1]["lane"]
    single_row, single = phase2[(KRON, "jnp")]
    kron, after, snap = lane["kron"], lane["after"], lane["snap"]
    kron_row = results[0]["runs"][0]["cold"]
    say("world lane:", json.dumps(dict(
        ranks=2, backend="gloo", kron_wall_s=kron["wall_s"],
        world_kron_cold_wall_s=kron_row["wall_s"],
        single_warm_wall_s=single_row["warm_wall_s"],
        **{k: lane[k] for k in ("start_s", "close_s", "chaos", "sent")},
        kron=kron, bucket=lane["bucket"], after=after,
        follower={k: follower[k] for k in ("served", "failed", "idle",
                                           "k1a", "errors")},
        lane_s=results[0]["lane_s"])))
    for what, run, want, digest_want in (
            ("kron-21", kron, wants[KRON], wants_digest[(KRON, "jnp")]),
            ("the oversize graph after the chaos pair", after, big_want,
             follower["runs"][1]["digest"] if len(follower["runs"]) > 1
             else None)):
        if run["route"] != "sharded" or run["variant"] != \
                "sharded-apfb-gpubfs_wr-ct@2":
            fail(f"the lane: {what} took {run['route']} "
                 f"({run.get('variant')})")
        if not run["certified"] or run["cardinality"] != want:
            fail(f"the lane: {what} at {run['cardinality']} (scipy's "
                 f"{want}), certified {run['certified']}")
        if run["digest"] != digest_want:
            fail(f"the lane: {what}'s state on rank 0 differs from "
                 f"{'step 2' if run is kron else 'rank 1'}'s")
        if not 0 < run["k1a"] == run["levels"]:
            fail(f"the lane: {what}: K1a launched {run['k1a']} times on "
                 f"rank 0 for {run['levels']} levels")
    if follower["served"] != 2 or follower["failed"] or \
            follower["runs"][0]["digest"] != kron["digest"] or \
            [kron["phases"], kron["fallbacks"], kron["certified"]] != \
            list(single[2:]):
        fail(f"the lane: rank 1 served {follower['served']}, failed "
             f"{follower['failed']} ({follower['errors']}), or kron's state "
             f"differs from step 2's")
    if follower["k1a"] != kron["levels"] + after["levels"]:
        fail(f"the lane: K1a launched {follower['k1a']} times on rank 1 for "
             f"{kron['levels'] + after['levels']} levels")
    if lane["bucket"]["route"] != "bucket" or lane["bucket"]["headers"]:
        fail(f"the in-bucket request took {lane['bucket']['route']} with "
             f"{lane['bucket']['headers']} headers sent")
    if lane["chaos"] != dict(poisoned="PoisonedGraphFault",
                             killed="FlushThreadDiedError") or \
            snap["quarantined"] != 1 or snap["restarts"] != 1:
        fail(f"the lane's chaos pair: {lane['chaos']}, quarantined "
             f"{snap['quarantined']}, restarts {snap['restarts']}")
    if snap["sharded"] != follower["served"] or lane["sent"]["run"] != 2 \
            or lane["sent"]["stop"] != 1:
        fail(f"the lane: rank 0's sharded metric {snap['sharded']}, rank "
             f"1 served {follower['served']}, headers {lane['sent']}")
    return kron["k1a"] + after["k1a"] + follower["k1a"]


def nccl_world_of_one(graphs, phase2, wants_digest) -> dict:
    """Phase 5c(b): a world of one NCCL rank in this process.  kron-21
    under ``MatcherConfig()`` / cheap, cold then warm: phase 2's state,
    its host syncs (the merge is captured in the level's graph); then two
    steps of mamba2-2.7b FULL through the world's train step (ZeRO-1)
    against the same two steps on one device.  Returns the launches."""
    from repro_torch.distributed import close_world, init_world
    from repro_torch.matching import compile_cache_clear
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step

    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    world = init_world(0, 1, f"file://{store}/store", device=CARD)
    launches = {body: 0 for body in KERNELS}
    try:
        if world.backend != "nccl":
            fail(f"a world of one rank on the card chose {world.backend}")
        single_row, single = phase2[(KRON, "jnp")]
        for kind in ("cold", "warm"):
            row = world_solve(world, graphs[KRON], "jnp", {}, "cheap")
            what = f"{label(MAIN_PATH[KRON])}, {kind}, an NCCL world of 1"
            say("world:", json.dumps(dict(
                graph=label(MAIN_PATH[KRON]), path="jnp", ranks=1,
                backend=world.backend, run=kind, single_warm_wall_s=single_row[
                    "warm_wall_s"], single_host_syncs=single_row[
                    "host_syncs"], **{k: v for k, v in row.items()
                                      if k != "launches"},
                launches={b: n for b, n in row["launches"].items() if n})))
            if row["digest"] != wants_digest[(KRON, "jnp")] or \
                    [row["phases"], row["fallbacks"], row["certified"]] \
                    != list(single[2:]):
                fail(f"{what}: the state differs from phase 2's")
            if row["host_syncs"] != single_row["host_syncs"] or \
                    row["merges"] != row["levels"]:
                fail(f"{what}: {row['host_syncs']} host syncs (phase 2: "
                     f"{single_row['host_syncs']}), {row['merges']} merges "
                     f"for {row['levels']} levels: the merge is not "
                     f"captured in the level")
            if row["launches"]["frontier_expand_fused_wr"] != row["levels"]:
                fail(f"{what}: K1a launched "
                     f"{row['launches']['frontier_expand_fused_wr']} times "
                     f"for {row['levels']} levels")
            for body in KERNELS:
                launches[body] += row["launches"][body]
        # the service's lane over this world (no other rank to follow)
        svc = lane_service(world)
        row = lane_run(svc, graphs[KRON])
        svc.close()
        say("world lane, nccl 1:", json.dumps(dict(
            single_host_syncs=single_row["host_syncs"],
            single_warm_wall_s=single_row["warm_wall_s"], **row)))
        if row["route"] != "sharded" or \
                row["digest"] != wants_digest[(KRON, "jnp")] or \
                row["host_syncs"] != single_row["host_syncs"] or \
                not 0 < row["k1a"] == row["levels"]:
            fail(f"the lane over an NCCL world of one: route "
                 f"{row['route']}, {row['host_syncs']} host syncs (step 2: "
                 f"{single_row['host_syncs']}), K1a {row['k1a']} for "
                 f"{row['levels']} levels, or the state differs from step "
                 f"2's")
        launches["frontier_expand_fused_wr"] += row["k1a"]
        compile_cache_clear()
        torch.cuda.empty_cache()

        cfg, model, params = full_model(MAMBA_ARCH)
        opt = train_opt_config(MAMBA_ARCH)
        state = adamw_init(params, opt, world)
        step = build_train_step(model, opt, world=world)
        losses, walls = [], []
        torch.cuda.reset_peak_memory_stats()
        for s in range(WORLD_TRAIN_STEPS):
            b = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, s)
            (params, state, met), wall, _ = timed(
                lambda: step(params, state, b))
            losses.append(float(met["loss"]))
            walls.append(wall)
        NCCL_TRAIN.update(
            arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=losses,
            step_s=walls, peak_memory_bytes=torch.cuda.max_memory_allocated(),
            one_device_peak_gb_recorded=50.02)
        say("world train, nccl 1:", json.dumps(NCCL_TRAIN))
        del params, state, b, met
        torch.cuda.empty_cache()
    finally:
        compile_cache_clear()
        close_world()
        shutil.rmtree(store, ignore_errors=True)
    return launches


def world_train_checks(result, ckpt: str) -> dict:
    """Phase 5c(c): the gloo world of 2's training against one device.
    The same steps with ``microbatch=2`` on the card (the two ranks' row
    blocks) held to the world's losses and, leaf by leaf, to the world's
    checkpoint restored at ``W=1`` (the train gate); then one more step
    from the restored tree against the uninterrupted one-device run's
    next step."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    cfg = get_config(MAMBA_ARCH, **WORLD_TRAIN_CUTS)
    model = build_model(cfg)
    opt = train_opt_config(MAMBA_ARCH)
    step = build_train_step(model, opt, microbatch=2)
    params = model.init(TRAIN_SEED)
    state = adamw_init(params, opt)
    one = []
    for s in range(WORLD_TRAIN_STEPS):
        params, state, met = step(params, state, train_batch(
            cfg, TRAIN_BATCH, TRAIN_SEQ, s))
        one.append(float(met["loss"]))
    fresh = model.init(TRAIN_SEED + 1)
    (tree, at), restore_s, _ = timed(lambda: restore_checkpoint(
        ckpt, {"params": fresh, "opt": adamw_init(fresh, opt)}))
    del fresh
    gate = leaf_gate(tree, {"params": params, "opt": state}, opt.lr)
    nxt = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, WORLD_TRAIN_STEPS)
    _, _, met = step(params, state, nxt)
    straight = float(met["loss"])
    _, _, met = step(tree["params"], tree["opt"], nxt)
    resumed = float(met["loss"])
    world = result["losses"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(world, one)]
    reading = dict(arch=cfg.name, cuts=WORLD_TRAIN_CUTS, ranks=2,
                   backend="gloo", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   world_losses=world, one_device_losses=one,
                   loss_rel_gaps=gaps, bit_exact=world == one,
                   world_step_s=result["step_s"],
                   world_peak_memory_bytes=result["peak_memory_bytes"],
                   save_s=result["save_s"], restore_s=restore_s,
                   restored_step=at, gate=gate,
                   step_after_restore=resumed, step_straight=straight,
                   restore_rel_gap=abs(resumed - straight) / abs(straight))
    say("world train, gloo 2:", json.dumps(reading))
    if not all(g <= TRAIN_GATE_RTOL for g in gaps):
        fail(f"the world's training differs from one device's: {gaps}")
    if at != WORLD_TRAIN_STEPS or not gate["passes"]:
        fail(f"the W=2 checkpoint restored at W=1 fails the train gate: "
             f"step {at}, {gate}")
    if not reading["restore_rel_gap"] <= TRAIN_GATE_RTOL:
        fail(f"the step after the W=2 -> 1 restore: {resumed} against "
             f"{straight}")
    return reading


def world_phase(graphs, phase2, axis_ckpt: str, refs: dict,
                family_ckpt: str, wants, extra) -> tuple:
    """Phase 5c (module doc): (a) gloo worlds of WORLD_SIZES ranks on the
    card, the world of 2 also running the service's lane and training, (b)
    an NCCL world of one rank in this process, (c) the world of 2's
    training against one device.  ``phase2``: (graph index, path) -> (row,
    warm outcome) of phase 2; ``wants``: scipy's cardinalities of the
    main-path graphs; ``extra``: phase 5b's pending graphs.
    The worlds of (a) then run phase 5d's ranks (saving at
    ``axis_ckpt``) and phase 5e's (against ``refs``, saving at
    ``family_ckpt``).  Returns (per kernel body the launches of every
    rank's runs, phase 5d's and phase 5e's rank results by world size,
    the seconds the ranks spent on each)."""
    from repro_torch.distributed import run_world
    wants_digest = {k: digest(v[1][0], v[1][1]) for k, v in phase2.items()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    ckpt = os.path.join(HERE, "build", "chip_smoke_world_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    launches = {body: 0 for body in KERNELS}
    axis, axis_s, family, family_s = {}, 0.0, {}, 0.0
    try:
        files = {}
        for gi in {r[0] for r in SHARDED_RUNS}:
            files[gi] = os.path.join(tmp, f"graph{gi}.npz")
            save_graph(graphs[gi], files[gi])
        big, big_want, *_ = extra[1].get()
        files["big"] = os.path.join(tmp, "big.npz")
        save_graph(big, files["big"])
        del big
        trained = None
        for size in WORLD_SIZES:
            t0 = time.perf_counter()
            results = run_world(world_rank, size, files, SHARDED_RUNS,
                                size == 2, ckpt, axis_ckpt, refs,
                                family_ckpt, timeout=WORLD_TIMEOUT)
            axis[size] = [r["axis"] for r in results]
            axis_s += max(r["axis_s"] for r in results)
            family[size] = [r["family"] for r in results]
            family_s += max(r["family_s"] for r in results)
            lane = (f"the service's lane {results[0]['lane_s']:.1f} s, "
                    if "lane_s" in results[0] else "")
            say(f"phase 5c, a gloo world of {size} on the card: "
                f"{time.perf_counter() - t0:.1f} s, of which {lane}phase "
                f"5d's ranks {max(r['axis_s'] for r in results):.1f} s, "
                f"phase 5e's {max(r['family_s'] for r in results):.1f} s")
            if {r["backend"] for r in results} != {"gloo"}:
                fail(f"ranks sharing the card chose "
                     f"{[r['backend'] for r in results]}")
            for body, n in world_checks(size, results, phase2,
                                        wants_digest).items():
                launches[body] += n
            if size == 2:
                launches["frontier_expand_fused_wr"] += world_lane_checks(
                    results, phase2, wants, wants_digest, big_want)
                trained = results[0]["train"]
                if any(r["train"]["losses"] != trained["losses"]
                       for r in results):
                    fail("the ranks' losses differ")
        t0 = time.perf_counter()
        for body, n in nccl_world_of_one(graphs, phase2,
                                         wants_digest).items():
            launches[body] += n
        say(f"phase 5c, the NCCL world of one: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        world_train_checks(trained, ckpt)
        say(f"phase 5c, the training against one device: "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches, (axis, family), (axis_s, family_s)


# ---------------------------------------------------------------------------
# the model axis: tensor and sequence parallelism, FSDP (phase 5d)
# ---------------------------------------------------------------------------
# Its ranks are phase 5c's worlds, remeshed (World.remesh).
# (a) a world of 1 x 2 ranks sharing the card: granite-20b at full width cut
# to AXIS_SERVE_CUTS, bf16, K4 on each rank's heads: the prefill (rows,
# positions) and greedy decode steps; K4 at a rank's layer shape
AXIS_SERVE_CUTS = dict(n_layers=4, attn_impl="pallas")
AXIS_PREFILL = (1, 4096)
AXIS_DECODE = 8
FA_LOCAL = (1, 4096, 24, 1, 128)
# (b) a world of 2 x 2 ranks: granite-20b at full width (FSDP over data,
# sequence parallelism over model, remat); the fp32 gate (arch, cuts;
# rows, positions, steps) against one device's microbatch=2 steps, saved
# at 2x2 and restored on one device; then a bf16 run (arch, cuts; rows,
# positions, steps) under the launcher's optimizer for its seconds a step,
# peak bytes and collective bytes
AXIS_GATE_RUN = ("granite-20b", dict(n_layers=1, dtype="float32"),
                 (2, 512, 2))
AXIS_BF16_RUN = ("granite-20b", dict(n_layers=2), (4, 2048, 2))
# phase 5d's K4 launches and times, for the kernels' line
AXIS: dict = {}


def gate_opt(arch: str):
    """A train gate's optimizer: the launcher's for ``arch``, without fp32
    masters (the gate's params are fp32 already)."""
    return dataclasses.replace(train_opt_config(arch), master_fp32=False)


def axis_tokens(cfg, batch: int, seq: int) -> torch.Tensor:
    """Seeded prompt tokens (on the CPU: every rank and the parent draw
    the same)."""
    gen = torch.Generator().manual_seed(LM_SEED)
    return torch.randint(0, cfg.vocab, (batch, seq), generator=gen)


def axis_serve_rank(world) -> dict:
    """Phase 5d(a) on one rank: the prefill through K4 on this rank's heads
    (K4's counts set to 0 just before, read just after), then AXIS_DECODE
    greedy steps on a fresh cache from the prefill's argmax; the gathered
    logits, the tokens, the cache's bytes on this rank."""
    use_src()
    from repro_torch.configs import get_config
    from repro_torch.distributed import comm
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step, build_serve_step
    cfg = get_config(LM_ARCH, **AXIS_SERVE_CUTS)
    model = build_model(cfg, world)
    params, init_s, _ = timed(lambda: model.init(LM_SEED))
    B, S = AXIS_PREFILL
    batch = {"tokens": axis_tokens(cfg, B, S).to(world.device)}
    prefill = build_prefill_step(model)
    prefill(params, batch)                             # warm
    torch.cuda.synchronize()
    reset_launches()
    comm.reset_counts()
    logits, wall, peak = timed(lambda: prefill(params, batch))
    launches = dict(LAUNCHES)
    prefill_comm = comm.axis_counts()
    serve = build_serve_step(model)
    cache = model.init_cache(B, AXIS_DECODE)
    tok = logits[:, -1:].argmax(-1)
    toks, steps = [], []
    t0 = time.perf_counter()
    for _ in range(AXIS_DECODE):
        toks.append(tok.cpu())
        lg, cache = serve(params, cache, tok)
        steps.append(lg.cpu())
        tok = lg[:, -1:].argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values()
                      if isinstance(t, torch.Tensor))
    return dict(rank=world.rank, backend=world.backend, init_s=init_s,
                logits=logits.cpu(), launches=launches, prefill_s=wall,
                peak_bytes=peak, prefill_comm=prefill_comm,
                tokens=torch.cat(toks, 1), decode=torch.cat(steps, 1),
                decode_ms_per_step=decode_s / AXIS_DECODE * 1e3,
                cache_bytes=cache_bytes)


def axis_run(world, cfg, opt, batch: int, seq: int, steps: int,
             ckpt=None) -> dict:
    """``steps`` train steps of ``cfg`` built over ``world`` from the
    seeded weights, each timed (the losses, the walls), with the peak
    bytes and the bytes handed to each axis's collectives; with ``ckpt`` a
    collective save there (rank 0 writes), timed."""
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.distributed import comm
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map_paths
    from repro_torch.optim import adamw_init, state_cuts
    from repro_torch.train import build_train_step
    model = build_model(cfg, world)
    params = model.init(TRAIN_SEED)
    places = model.places(params)
    state = adamw_init(params, opt, world, places)
    step = build_train_step(model, opt)
    losses, walls = [], []
    comm.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for s in range(steps):
        b = train_batch(cfg, batch, seq, s, device=world.device)
        (params, state, met), wall, _ = timed(
            lambda: step(params, state, b))
        losses.append(float(met["loss"]))
        walls.append(wall)
    out = dict(losses=losses, step_s=walls,
               peak_bytes=torch.cuda.max_memory_allocated(),
               comm=comm.axis_counts())
    if ckpt:
        dims = {"params": tree_map_paths(lambda _, pl: pl.cuts, places),
                "opt": state_cuts(params, opt, world, places)}
        _, out["save_s"], _ = timed(lambda: save_checkpoint(
            ckpt, steps, {"params": params, "opt": state}, world=world,
            dims=dims))
    del params, state
    torch.cuda.empty_cache()
    return out


def train_rank(world, ckpt: str, gate_run, bf16_run) -> dict:
    """Phase 5d(b) or 5e(b) on one rank: the fp32 gate's steps of
    ``gate_run`` (arch, cuts, (rows, positions, steps)), saved at
    ``ckpt`` (collectively: rank 0 writes), then ``bf16_run``'s steps
    under the launcher's optimizer, each timed, with the peak bytes and
    the bytes handed to each axis's collectives."""
    use_src()
    from repro_torch.configs import get_config
    arch, cuts, (B, S, n) = gate_run
    gate = axis_run(world, get_config(arch, **cuts), gate_opt(arch), B, S,
                    n, ckpt)
    arch, cuts, (B, S, n) = bf16_run
    bf16 = axis_run(world, get_config(arch, **cuts), train_opt_config(arch),
                    B, S, n)
    return dict(rank=world.rank, backend=world.backend, gate=gate,
                bf16=bf16)


def axis_serve_checks(results) -> dict:
    """Phase 5d(a)'s checks on one device: the same weights' prefill
    (the gathered logits within LOGIT_GAP_TOL, which a control with one
    layer's attention zeroed must exceed), K4 launched once a layer on
    every rank, and the world's greedy tokens teacher-forced here, each
    step's logits within LOGIT_GAP_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step, build_serve_step
    cfg = get_config(LM_ARCH, **AXIS_SERVE_CUTS)
    model = build_model(cfg)
    params = model.init(LM_SEED)
    B, S = AXIS_PREFILL
    batch = {"tokens": axis_tokens(cfg, B, S).to(CARD)}
    prefill = build_prefill_step(model)
    want, one_s, _ = timed(lambda: prefill(params, batch))
    control = with_attention(skip_attention(cfg.n_layers // 2),
                             lambda: prefill(params, batch))
    got = results[0]["logits"].to(CARD)
    what = f"{cfg.name} ({cfg.n_layers} layers) over a 1 x 2 world"
    gap, control_gap = logit_gap(got, want), logit_gap(control, want)
    for r in results:
        if not torch.equal(r["logits"], results[0]["logits"]):
            fail(f"{what}: the ranks' gathered logits differ")
        if r["launches"]["flash_attention"] != cfg.n_layers or \
                r["launches"]["flash_attention_tc"] != cfg.n_layers:
            fail(f"{what}: rank {r['rank']} launched K4 "
                 f"{r['launches']} times for {cfg.n_layers} layers")
    serve = build_serve_step(model)
    cache = model.init_cache(B, AXIS_DECODE)
    toks = results[0]["tokens"].to(CARD)
    gaps, agree = [], 0
    for t in range(AXIS_DECODE):
        lg, cache = serve(params, cache, toks[:, t:t + 1])
        mine = results[0]["decode"][:, t:t + 1].to(CARD)
        gaps.append(logit_gap(mine, lg))
        agree += int((mine.argmax(-1) == lg.argmax(-1)).sum())
    out = dict(arch=cfg.name, layers=cfg.n_layers, mesh="1x2",
               backend=results[0]["backend"], batch=B, seq=S,
               logits_gap=gap, control_gap=control_gap,
               gate=LOGIT_GAP_TOL, prefill_s=[r["prefill_s"] for r in results],
               one_device_prefill_s=one_s,
               peak_bytes_by_rank=[r["peak_bytes"] for r in results],
               init_s=[r["init_s"] for r in results],
               prefill_collectives=results[0]["prefill_comm"],
               launches_by_rank=[r["launches"]["flash_attention"]
                                 for r in results],
               decode_gaps=gaps, decode_argmax_agree=f"{agree}/"
               f"{B * AXIS_DECODE}",
               decode_ms_per_step=[r["decode_ms_per_step"] for r in results],
               cache_bytes_by_rank=[r["cache_bytes"] for r in results])
    say("model axis, serve:", json.dumps(out))
    if not gap <= LOGIT_GAP_TOL < control_gap:
        fail(f"{what}: logits gap {gap}, control {control_gap}, gate "
             f"{LOGIT_GAP_TOL}")
    if not max(gaps) <= LOGIT_GAP_TOL:
        fail(f"{what}: decode logits gaps {gaps} against one device")
    del params, cache, control, want
    torch.cuda.empty_cache()
    return out


def one_device_gate(cfg, opt, B: int, S: int, n: int, ckpt: str) -> tuple:
    """The one-device side of a 2 x 2 world's train gate: ``n``
    ``microbatch=2`` steps (the data axis's row blocks) from the seeded
    weights, the world's save at ``ckpt`` restored here and read against
    their tree leaf by leaf (``leaf_gate``), and one more step from each.
    Returns (the losses, the restore's seconds, its step, the gate's
    reading, the step after the restore, the same step straight on)."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    model = build_model(cfg)
    step = build_train_step(model, opt, microbatch=2)
    params = model.init(TRAIN_SEED)
    state = adamw_init(params, opt)
    one = []
    for s in range(n):
        params, state, met = step(params, state, train_batch(cfg, B, S, s))
        one.append(float(met["loss"]))
    fresh = model.init(TRAIN_SEED + 1)
    (tree, at), restore_s, _ = timed(lambda: restore_checkpoint(
        ckpt, {"params": fresh, "opt": adamw_init(fresh, opt)}))
    del fresh
    gate = leaf_gate(tree, {"params": params, "opt": state}, opt.lr)
    nxt = train_batch(cfg, B, S, n)
    _, _, met = step(params, state, nxt)
    straight = float(met["loss"])
    del params, state
    torch.cuda.empty_cache()
    _, _, met = step(tree["params"], tree["opt"], nxt)
    resumed = float(met["loss"])
    del tree
    torch.cuda.empty_cache()
    return one, restore_s, at, gate, resumed, straight


def train_checks(phase: str, results, ckpt: str, gate_run, bf16_run
                 ) -> dict:
    """Phase 5d(b)'s or 5e(b)'s checks on one device: the fp32 gate's
    steps with ``microbatch=2`` (the data axis's row blocks) against the
    world's losses, the 2 x 2 checkpoint restored here against those
    steps' tree leaf by leaf (the train gate), and one more step from each
    (``one_device_gate``); the bf16 run's losses finite and equal on every
    rank."""
    from repro_torch.configs import get_config
    arch, cuts, (B, S, n) = gate_run
    one, restore_s, at, gate, resumed, straight = one_device_gate(
        get_config(arch, **cuts), gate_opt(arch), B, S, n, ckpt)
    g = results[0]["gate"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(g["losses"], one)]
    bf = results[0]["bf16"]
    b_arch, b_cuts, (b_rows, b_seq, _) = bf16_run
    out = dict(mesh="2x2", backend=results[0]["backend"],
               gate=dict(arch=arch, cuts=cuts, batch=B, seq=S,
                         world_losses=g["losses"], one_device_losses=one,
                         loss_rel_gaps=gaps,
                         step_s=[r["gate"]["step_s"] for r in results],
                         peak_bytes_by_rank=[r["gate"]["peak_bytes"]
                                             for r in results],
                         save_s=g["save_s"], restore_s=restore_s,
                         restored_step=at, leaves=gate,
                         step_after_restore=resumed, step_straight=straight,
                         restore_rel_gap=abs(resumed - straight)
                         / abs(straight)),
               bf16=dict(arch=b_arch, cuts=b_cuts, batch=b_rows, seq=b_seq,
                         factored=train_opt_config(b_arch).factored,
                         losses=bf["losses"],
                         step_s=[r["bf16"]["step_s"] for r in results],
                         peak_bytes_by_rank=[r["bf16"]["peak_bytes"]
                                             for r in results],
                         collectives_rank0=bf["comm"]))
    say(f"{phase}, train:", json.dumps(out))
    if any(r["gate"]["losses"] != g["losses"] or r["bf16"]["losses"] !=
           bf["losses"] for r in results):
        fail(f"{phase}: the ranks' losses differ")
    if not all(x <= TRAIN_GATE_RTOL for x in gaps):
        fail(f"{phase}: the 2 x 2 world's losses against one device's "
             f"microbatch=2 steps: {gaps}")
    if at != n or not gate["passes"]:
        fail(f"{phase}: the 2 x 2 checkpoint restored on one device fails "
             f"the train gate: step {at}, {gate}")
    if not out["gate"]["restore_rel_gap"] <= TRAIN_GATE_RTOL:
        fail(f"{phase}: the step after the 2x2 -> 1 restore: {resumed} "
             f"against {straight}")
    if not all(math.isfinite(x) for x in bf["losses"]):
        fail(f"{phase}: bf16 losses {bf['losses']}")
    return out


def model_axis_phase(axis: dict, ckpt: str) -> dict:
    """Phase 5d's checks on one device (module doc) of the ranks' results
    ``axis`` (phase 5c's worlds of 2 and 4 as 1 x 2 and 2 x 2), and K4 at
    the 1 x 2 world's layer shape.  Returns K4's launches over the ranks'
    prefills and its times at the local shape."""
    try:
        t0 = time.perf_counter()
        axis_serve_checks(axis[2])
        times = flash_at(FA_LOCAL, torch.Generator(device=CARD).manual_seed(
            LM_SEED), "granite-20b under M = 2 (one rank's heads)")
        say(f"phase 5d, the 1 x 2 world's checks and K4 at the local shape: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_checks("phase 5d", axis[4], ckpt, AXIS_GATE_RUN,
                     AXIS_BF16_RUN)
        say(f"phase 5d, the 2 x 2 world's checks: "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
    return dict(launches=sum(r["launches"]["flash_attention"]
                             for r in axis[2]), times=times)


# ---------------------------------------------------------------------------
# the model axis of the MoE, SSM and hybrid families (phase 5e)
# ---------------------------------------------------------------------------
# Its ranks are phase 5c's worlds, remeshed as phase 5d's, after 5d's work.
# (a) 1 x 2 serving, bf16, seed LM_SEED: (arch, cuts of the FULL config,
# prompt (rows, positions)); then AXIS_DECODE greedy decode steps.  dbrx's
# K4 runs on each rank's 24 query heads on 4 K/V heads (FA_DBRX_LOCAL)
AXIS_FAMILIES = (("dbrx-132b", dict(n_layers=2, attn_impl="pallas"),
                  (1, 2048)),
                 ("mamba2-2.7b", dict(n_layers=8), (1, 4096)),
                 ("zamba2-7b", dict(n_layers=14), (1, 4096)))
FA_DBRX_LOCAL = (1, 2048, 24, 4, 128)
# (b) 2 x 2 training: the fp32 gate (arch, cuts; rows, positions, steps)
# against one device's microbatch=2 steps, saved at 2x2 and restored on
# one device; then one bf16 step of dbrx under the launcher's optimizer
# (the factored state) for its seconds, peak bytes and collective bytes
AXIS_FAMILY_GATE = ("mamba2-2.7b", dict(n_layers=1, dtype="float32"),
                    (2, 512, 2))
AXIS_FAMILY_BF16 = ("dbrx-132b", dict(n_layers=1), (2, 512, 1))
# phase 5e's K4 launches and times, for the kernels' line
AXIS_FAMILY: dict = {}


@contextlib.contextmanager
def routes_kept(seen: list):
    """Every ``route_matching`` call of the MoE layers while the block
    runs: its ``(assign, slot)`` on the host appended to ``seen``."""
    from repro_torch.models import moe as moe_mod
    with spying(moe_mod, "route_matching", seen,
                lambda args, out: (out[0].cpu(), out[1].cpu())):
        yield seen


@contextlib.contextmanager
def pinned_or_free(routes, device):
    """``pinned_routing`` of the MoE layers to ``routes`` (host tensors,
    moved to ``device``; None: as they route)."""
    from repro_torch.models import moe as moe_mod
    with (pinned_routing(moe_mod, [(a.to(device), s.to(device))
                                   for a, s in routes])
          if routes is not None else contextlib.nullcontext()):
        yield


def routes_digest(routes) -> str:
    """A sha256 of a run's routes (``(assign, slot)`` a call)."""
    import hashlib
    h = hashlib.sha256()
    for a, sl in routes:
        h.update(a.cpu().numpy().astype("int32").tobytes())
        h.update(sl.cpu().numpy().astype("int32").tobytes())
    return h.hexdigest()


def skip_block(index: int):
    """A control: the ``index``-th block call of a forward (counted from 0,
    the hybrid's shared block counted too) returns its input unchanged, as
    if its output were zero."""
    from repro_torch.models import transformer as tm
    calls, real = [], tm.block_fwd

    @contextlib.contextmanager
    def ctx():
        def fault(params, x, *args, **kw):
            calls.append(None)
            y, aux = real(params, x, *args, **kw)
            return (x, aux) if len(calls) == index + 1 else (y, aux)
        tm.block_fwd = fault
        try:
            yield
        finally:
            tm.block_fwd = real
    return ctx()


def family_references(runs=AXIS_FAMILIES) -> dict:
    """Phase 5e(a)'s (or 5g's) one-device side, before the world runs: for
    each of ``runs`` at its cut, the prefill's last logits (timed, after a
    warm one) and its routes, a control with the middle block skipped,
    AXIS_DECODE greedy steps (the tokens, each step's logits and routes)
    and the SSM state's bytes.  The ranks replay dbrx's routes and
    teacher-force these tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step, build_serve_step
    out = {}
    for arch, cuts, (B, S) in runs:
        cfg = get_config(arch, **cuts)
        model = build_model(cfg)
        params = model.init(LM_SEED)
        batch = {"tokens": axis_tokens(cfg, B, S).to(CARD)}
        prefill = build_prefill_step(model)
        V = cfg.vocab                      # the padded columns dropped
        prefill(params, batch)                         # warm
        with routes_kept([]) as routes:
            logits, wall, peak = timed(lambda: prefill(params, batch))
        logits = logits[..., :V]
        with skip_block(cfg.n_layers // 2):
            control = prefill(params, batch)[..., :V]
        serve = build_serve_step(model)
        cache = model.init_cache(B, AXIS_DECODE)
        tok = logits[:, -1:].argmax(-1)
        toks, steps, dec_routes = [], [], []
        with routes_kept(dec_routes):
            for _ in range(AXIS_DECODE):
                toks.append(tok.cpu())
                lg, cache = serve(params, cache, tok)
                steps.append(lg[..., :V].cpu())
                tok = lg[:, -1:, :V].argmax(-1)
        out[arch] = dict(
            logits=logits.cpu(), control=control.cpu(), prefill_s=wall,
            peak_bytes=peak, routes=list(routes), tokens=torch.cat(toks, 1),
            decode=torch.cat(steps, 1), decode_routes=dec_routes,
            h_bytes=(cache["h"].numel() * cache["h"].element_size()
                     if "h" in cache else 0))
        del model, params, cache, logits, control
        torch.cuda.empty_cache()
    return out


def family_serve_rank(world, refs, runs=AXIS_FAMILIES,
                      check_k4: bool = False) -> dict:
    """Phase 5e(a) (or 5g) on one rank, for each of ``runs``: the prefill
    (after a warm one; K4's counts set to 0 just before, read just after)
    with its routes' digest, for dbrx again under one device's routes
    (``refs``), then AXIS_DECODE steps teacher-forced on one device's
    greedy tokens (dbrx's under its decode routes): the gathered logits,
    the walls, the cache's bytes on this rank, the collectives' bytes;
    with ``check_k4``, once more under one device's routes with each of
    K4's calls held against its plain version (``k4_checked``)."""
    use_src()
    from repro_torch.configs import get_config
    from repro_torch.distributed import comm
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step, build_serve_step
    out = {}
    for arch, cuts, (B, S) in runs:
        ref = refs[arch]
        cfg = get_config(arch, **cuts)
        model = build_model(cfg, world)
        params, init_s, _ = timed(lambda: model.init(LM_SEED))
        batch = {"tokens": axis_tokens(cfg, B, S).to(world.device)}
        prefill = build_prefill_step(model)
        prefill(params, batch)                         # warm
        torch.cuda.synchronize()
        reset_launches()
        comm.reset_counts()
        with routes_kept([]) as routes:
            logits, wall, peak = timed(lambda: prefill(params, batch))
        V = cfg.vocab                      # the padded columns dropped
        row = dict(logits=logits[..., :V].cpu(), prefill_s=wall,
                   peak_bytes=peak,
                   init_s=init_s, launches=dict(LAUNCHES),
                   prefill_comm=comm.axis_counts(),
                   routes_digest=routes_digest(routes),
                   routes_differing=sum(
                       int((a != b[0]).sum()) for (a, _), b in
                       zip(routes, ref["routes"])))
        moe = cfg.family == "moe"
        if moe:
            with pinned_or_free(ref["routes"], world.device):
                row["pinned"] = prefill(params, batch)[..., :V].cpu()
        if check_k4 and cfg.attn_impl == "pallas":
            with pinned_or_free(ref["routes"] if moe else None,
                                world.device):
                row["k4_checked"] = k4_held_to_plain(
                    lambda: prefill(params, batch))
        serve = build_serve_step(model)
        cache = model.init_cache(B, AXIS_DECODE)
        toks = ref["tokens"].to(world.device)
        steps = []
        t0 = time.perf_counter()
        with pinned_or_free(ref["decode_routes"] if moe else None,
                            world.device):
            for t in range(AXIS_DECODE):
                lg, cache = serve(params, cache, toks[:, t:t + 1])
                steps.append(lg[..., :V].cpu())
        torch.cuda.synchronize()
        row.update(decode=torch.cat(steps, 1),
                   decode_ms_per_step=(time.perf_counter() - t0)
                   / AXIS_DECODE * 1e3,
                   cache_bytes=sum(
                       t.numel() * t.element_size()
                       for t in [*cache.values(),
                                 *cache.get("shared_kv", {}).values()]
                       if isinstance(t, torch.Tensor)),
                   h_bytes=(cache["h"].numel() * cache["h"].element_size()
                            if "h" in cache else 0))
        out[arch] = row
        del model, params, cache, logits
        torch.cuda.empty_cache()
    return dict(rank=world.rank, backend=world.backend, serve=out)


def k4_held_to_plain(fn) -> list:
    """``fn()`` with each of K4's calls in the model's attention held
    against its plain version on the same inputs: per call, the shape,
    the largest absolute difference and the values outside rtol = atol =
    ``FA_TOL`` (bf16)."""
    from repro_torch.models import attention as att
    seen = []

    def check(args, out):
        (q, k, v), causal = args, True
        want = fa_plain(q, k, v, causal).float()
        err = (out.float() - want).abs()
        tol = FA_TOL[q.dtype]
        return dict(shape=tuple(q.shape) + (k.shape[2],),
                    max_abs_err=float(err.max()),
                    outside=int((err > tol + tol * want.abs()).sum()),
                    finite=bool(torch.isfinite(out.float()).all()))

    with spying(att, "flash_attention", seen, check):
        fn()
    return seen


def family_serve_checks(refs, results, runs=AXIS_FAMILIES,
                        mesh=(1, 2), argmax_gate: bool = True) -> dict:
    """Phase 5e(a)'s (or 5g's) checks against ``refs`` (one device, the
    same weights and depth) over a world of ``mesh``: the gathered last
    logits (the vocab's columns) within LOGIT_GAP_TOL, which the control
    with the middle block skipped must exceed (dbrx also under one
    device's routes), the routes' digest equal on every rank, K4 once a
    layer a rank on the tensor-core body where the model takes it (and,
    where the ranks held them, each call against its plain version), each
    decode step's logits within LOGIT_GAP_TOL and, with ``argmax_gate``,
    its argmax one device's (printed either way: over 3 ranks bf16's
    near-ties flip, as in 5f), and each rank's share of the SSM state's
    bytes its share of the SSM heads (blocks of ``ceil(Hs / M)``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import axis_range, model_block
    rows = []
    for arch, cuts, (B, S) in runs:
        ref = refs[arch]
        cfg = get_config(arch, **cuts)
        mine = [r["serve"][arch] for r in results]
        what = (f"{cfg.name} ({cfg.n_layers} layers) over a {mesh[0]} x "
                f"{mesh[1]} world")
        size = mesh[1]
        blocks = {n: [hi - lo for lo, hi in (
            axis_range(n, model_block(n, size), i) for i in range(size))]
            for n in (cfg.ssm_heads, cfg.n_experts, cfg.n_heads)}
        want = ref["logits"].to(CARD)
        gap = logit_gap(mine[0]["logits"].to(CARD), want)
        control_gap = logit_gap(ref["control"].to(CARD), want)
        moe = cfg.family == "moe"
        pinned_gap = (logit_gap(mine[0]["pinned"].to(CARD), want) if moe
                      else None)
        gaps = [logit_gap(mine[0]["decode"][:, t:t + 1].to(CARD),
                          ref["decode"][:, t:t + 1].to(CARD))
                for t in range(AXIS_DECODE)]
        argmax = [bool(torch.equal(mine[0]["decode"][:, t].argmax(-1),
                                   ref["decode"][:, t].argmax(-1)))
                  for t in range(AXIS_DECODE)]
        k4 = cfg.attn_impl == "pallas"
        row = dict(arch=cfg.name, layers=cfg.n_layers,
                   mesh=f"{mesh[0]}x{mesh[1]}",
                   backend=results[0]["backend"], batch=B, seq=S,
                   heads_by_rank=blocks[cfg.n_heads],
                   experts_by_rank=(blocks[cfg.n_experts]
                                    if cfg.family == "moe" else None),
                   ssm_heads_by_rank=(blocks[cfg.ssm_heads]
                                      if ref["h_bytes"] else None),
                   k4_checked_by_rank=[
                       [(c["max_abs_err"], c["outside"])
                        for c in x["k4_checked"]]
                       for x in mine if "k4_checked" in x] or None,
                   logits_gap=gap, control_gap=control_gap,
                   pinned_gap=pinned_gap, gate=LOGIT_GAP_TOL,
                   routes_differing_from_one_device=[
                       m["routes_differing"] for m in mine],
                   routes_digests_equal=len({m["routes_digest"]
                                             for m in mine}) == 1,
                   prefill_s=[m["prefill_s"] for m in mine],
                   one_device_prefill_s=ref["prefill_s"],
                   peak_bytes_by_rank=[m["peak_bytes"] for m in mine],
                   one_device_peak_bytes=ref["peak_bytes"],
                   init_s=[m["init_s"] for m in mine],
                   prefill_collectives=mine[0]["prefill_comm"],
                   k4_launches_by_rank=[m["launches"]["flash_attention"]
                                        for m in mine],
                   decode_gaps=gaps, decode_argmax_equal=argmax,
                   decode_ms_per_step=[m["decode_ms_per_step"]
                                       for m in mine],
                   cache_bytes_by_rank=[m["cache_bytes"] for m in mine],
                   h_bytes_by_rank=[m["h_bytes"] for m in mine],
                   one_device_h_bytes=ref["h_bytes"])
        say("model axis, families, serve:", json.dumps(row))
        rows.append(row)
        for m in mine:
            if not torch.equal(m["logits"], mine[0]["logits"]):
                fail(f"{what}: the ranks' gathered logits differ")
        if not row["routes_digests_equal"]:
            fail(f"{what}: the ranks routed differently")
        for g in (gap, pinned_gap) if moe else (gap,):
            if not g <= LOGIT_GAP_TOL < control_gap:
                fail(f"{what}: logits gap {g} (under one device's routes "
                     f"{pinned_gap}), control {control_gap}, gate "
                     f"{LOGIT_GAP_TOL}")
        if not max(gaps) <= LOGIT_GAP_TOL or (argmax_gate and
                                              not all(argmax)):
            fail(f"{what}: decode against one device: gaps {gaps}, argmax "
                 f"equal {argmax}")
        for i, r in enumerate(mine):
            if k4 and (r["launches"]["flash_attention"] != cfg.n_layers or
                       r["launches"]["flash_attention_tc"] != cfg.n_layers):
                fail(f"{what}: K4 launched {r['launches']} times for "
                     f"{cfg.n_layers} layers")
            held = r.get("k4_checked")
            if held is not None and (len(held) != cfg.n_layers or any(
                    c["outside"] or not c["finite"] for c in held)):
                fail(f"{what}: K4's calls on rank {i} against the plain "
                     f"version: {held}")
            heads = blocks[cfg.ssm_heads][i]
            if ref["h_bytes"] and \
                    r["h_bytes"] * cfg.ssm_heads != ref["h_bytes"] * heads:
                fail(f"{what}: {r['h_bytes']} bytes of SSM state on rank "
                     f"{i} ({heads} of {cfg.ssm_heads} heads) against one "
                     f"device's {ref['h_bytes']}")
    return rows


def family_axis_phase(family: dict, refs: dict, ckpt: str) -> dict:
    """Phase 5e's checks (module doc) of the ranks' results ``family``
    (phase 5c's worlds of 2 and 4 as 1 x 2 and 2 x 2), and K4 at dbrx's
    local shape.  Returns K4's launches over the ranks' prefills and its
    times at the local shape."""
    try:
        t0 = time.perf_counter()
        family_serve_checks(refs, family[2])
        times = flash_at(FA_DBRX_LOCAL, torch.Generator(
            device=CARD).manual_seed(LM_SEED),
            "dbrx-132b under M = 2 (one rank's heads)")
        say(f"phase 5e, the 1 x 2 world's checks and K4 at the local shape: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_checks("phase 5e", family[4], ckpt, AXIS_FAMILY_GATE,
                     AXIS_FAMILY_BF16)
        say(f"phase 5e, the 2 x 2 world's checks: "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
    return dict(launches=sum(r["serve"][AXIS_FAMILIES[0][0]]["launches"]
                             ["flash_attention"] for r in family[2]),
                times=times)


# ---------------------------------------------------------------------------
# the model axis where it does not divide the heads (phase 5f)
# ---------------------------------------------------------------------------
# A gloo world of 1 x 3 ranks sharing the card (a spawn of its own), bf16,
# seed LM_SEED, full width cut in depth: (arch, cuts, (rows, positions of
# the prefill, the vision prefix's patches included)); then AXIS_DECODE
# decode steps teacher-forced on one device's greedy tokens.
# deepseek-coder-33b's 56 heads go 19/19/18 over its 8 replicated K/V heads
# in groups of 7 (every rank's block straddles groups: its K/V expanded to
# one a query head, K4 on it, FA_DEEPSEEK_LOCAL); paligemma-3b's 8 heads
# 3/3/2 on its one K/V head, its d_ff 16384 5462/5462/5460
UNEVEN_MESH = (1, 3)
UNEVEN_RUNS = (("deepseek-coder-33b", dict(n_layers=2, attn_impl="pallas"),
                (1, 3072)),
               ("paligemma-3b", dict(n_layers=2), (1, 3072)))
FA_DEEPSEEK_LOCAL = (1, 3072, 19, 19, 128)
UNEVEN_TIMEOUT = 600
# phase 5f's K4 launches and times, for the kernels' line
UNEVEN: dict = {}


def uneven_inputs(cfg, batch: int, seq: int) -> dict:
    """A prefill's inputs on the host (every rank and the parent read the
    same): seeded tokens, or for the vision prefix ``family_inputs``'
    tokens and patches."""
    if cfg.frontend == "vision":
        return {k: v.cpu() for k, v in family_inputs(cfg, batch,
                                                     seq).items()}
    return {"tokens": axis_tokens(cfg, batch, seq)}


def uneven_references() -> dict:
    """Phase 5f's one-device side, before the world runs: for each of
    UNEVEN_RUNS, the inputs, the prefill's last logits (timed, after a warm
    one), a control with the middle layer zeroed (K4's call for it
    returning zeros where the prefill takes K4, else the block skipped)
    and AXIS_DECODE greedy steps on a fresh cache (the tokens, each step's
    logits)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step, build_serve_step
    out = {}
    for arch, cuts, (B, S) in UNEVEN_RUNS:
        cfg = get_config(arch, **cuts)
        model = build_model(cfg)
        params = model.init(LM_SEED)
        inputs = uneven_inputs(cfg, B, S)
        batch = {k: v.to(CARD) for k, v in inputs.items()}
        prefill = build_prefill_step(model)
        V = cfg.vocab                      # the padded columns dropped
        prefill(params, batch)                         # warm
        logits, wall, peak = timed(lambda: prefill(params, batch))
        logits = logits[..., :V]
        middle = cfg.n_layers // 2
        if cfg.attn_impl == "pallas":
            control = with_attention(skip_attention(middle),
                                     lambda: prefill(params, batch))
        else:
            with skip_block(middle):
                control = prefill(params, batch)
        serve = build_serve_step(model)
        cache = model.init_cache(B, AXIS_DECODE)
        tok = logits[:, -1:].argmax(-1)
        toks, steps = [], []
        for _ in range(AXIS_DECODE):
            toks.append(tok.cpu())
            lg, cache = serve(params, cache, tok)
            steps.append(lg[..., :V].cpu())
            tok = lg[:, -1:, :V].argmax(-1)
        out[arch] = dict(inputs=inputs, logits=logits.cpu(),
                         control=control[..., :V].cpu(), prefill_s=wall,
                         peak_bytes=peak, tokens=torch.cat(toks, 1),
                         decode=torch.cat(steps, 1))
        del model, params, cache, logits, control, batch
        torch.cuda.empty_cache()
    return out


def uneven_rank(world, feeds) -> dict:
    """Phase 5f on one rank, for each of UNEVEN_RUNS: the prefill of
    ``feeds[arch]``'s inputs (after a warm one; K4's counts set to 0 just
    before, read just after), then AXIS_DECODE steps teacher-forced on its
    tokens: the gathered logits, the walls, this rank's heads and K/V
    heads, its parameter, cache and peak bytes, the collectives' bytes."""
    use_src()
    from repro_torch.configs import get_config
    from repro_torch.distributed import comm
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import build_prefill_step, build_serve_step
    out = {}
    for arch, cuts, (B, S) in UNEVEN_RUNS:
        cfg = get_config(arch, **cuts)
        model = build_model(cfg, world)
        params, init_s, _ = timed(lambda: model.init(LM_SEED))
        batch = {k: v.to(world.device)
                 for k, v in feeds[arch]["inputs"].items()}
        prefill = build_prefill_step(model)
        prefill(params, batch)                         # warm
        torch.cuda.synchronize()
        reset_launches()
        comm.reset_counts()
        logits, wall, peak = timed(lambda: prefill(params, batch))
        V = cfg.vocab
        row = dict(logits=logits[..., :V].cpu(), prefill_s=wall,
                   peak_bytes=peak, init_s=init_s, launches=dict(LAUNCHES),
                   prefill_comm=comm.axis_counts(),
                   heads=model.par.head_range(cfg),
                   kv_heads=model.par.kv_range(cfg),
                   param_bytes=sum(t.numel() * t.element_size()
                                   for t in tree_leaves(params)))
        serve = build_serve_step(model)
        cache = model.init_cache(B, AXIS_DECODE)
        toks = feeds[arch]["tokens"].to(world.device)
        steps = []
        t0 = time.perf_counter()
        for t in range(AXIS_DECODE):
            lg, cache = serve(params, cache, toks[:, t:t + 1])
            steps.append(lg[..., :V].cpu())
        torch.cuda.synchronize()
        row.update(decode=torch.cat(steps, 1),
                   decode_ms_per_step=(time.perf_counter() - t0)
                   / AXIS_DECODE * 1e3,
                   cache_bytes=sum(t.numel() * t.element_size()
                                   for t in cache.values()
                                   if isinstance(t, torch.Tensor)))
        out[arch] = row
        del model, params, cache, logits
        torch.cuda.empty_cache()
    return dict(rank=world.rank, backend=world.backend, serve=out)


def uneven_checks(refs, results) -> list:
    """Phase 5f's checks against ``refs`` (one device, the same weights and
    depth): the ranks' gathered last logits equal, within LOGIT_GAP_TOL of
    one device's, which the control must exceed; K4 once a layer on every
    rank, on the tensor-core body, where the model takes it; each decode
    step's logits within LOGIT_GAP_TOL (argmax agreement printed)."""
    from repro_torch.configs import get_config
    rows = []
    for arch, cuts, (B, S) in UNEVEN_RUNS:
        ref = refs[arch]
        cfg = get_config(arch, **cuts)
        mine = [r["serve"][arch] for r in results]
        what = (f"{cfg.name} ({cfg.n_layers} layers) over a "
                f"{UNEVEN_MESH[0]} x {UNEVEN_MESH[1]} world")
        want = ref["logits"].to(CARD)
        gap = logit_gap(mine[0]["logits"].to(CARD), want)
        control_gap = logit_gap(ref["control"].to(CARD), want)
        gaps = [logit_gap(mine[0]["decode"][:, t:t + 1].to(CARD),
                          ref["decode"][:, t:t + 1].to(CARD))
                for t in range(AXIS_DECODE)]
        agree = sum(int((mine[0]["decode"][:, t].argmax(-1) ==
                         ref["decode"][:, t].argmax(-1)).sum())
                    for t in range(AXIS_DECODE))
        k4 = cfg.attn_impl == "pallas"
        row = dict(arch=cfg.name, layers=cfg.n_layers,
                   mesh=f"{UNEVEN_MESH[0]}x{UNEVEN_MESH[1]}",
                   backend=results[0]["backend"], batch=B, seq=S,
                   heads_by_rank=[m["heads"] for m in mine],
                   kv_heads_by_rank=[m["kv_heads"] for m in mine],
                   logits_gap=gap, control_gap=control_gap,
                   gate=LOGIT_GAP_TOL,
                   prefill_s=[m["prefill_s"] for m in mine],
                   one_device_prefill_s=ref["prefill_s"],
                   peak_bytes_by_rank=[m["peak_bytes"] for m in mine],
                   one_device_peak_bytes=ref["peak_bytes"],
                   param_bytes_by_rank=[m["param_bytes"] for m in mine],
                   init_s=[m["init_s"] for m in mine],
                   prefill_collectives=mine[0]["prefill_comm"],
                   k4_launches_by_rank=[m["launches"]["flash_attention"]
                                        for m in mine],
                   decode_gaps=gaps,
                   decode_argmax_agree=f"{agree}/{B * AXIS_DECODE}",
                   decode_ms_per_step=[m["decode_ms_per_step"]
                                       for m in mine],
                   cache_bytes_by_rank=[m["cache_bytes"] for m in mine])
        say("model axis, uneven heads, serve:", json.dumps(row))
        rows.append(row)
        for m in mine:
            if not torch.equal(m["logits"], mine[0]["logits"]):
                fail(f"{what}: the ranks' gathered logits differ")
            if k4 and (m["launches"]["flash_attention"] != cfg.n_layers or
                       m["launches"]["flash_attention_tc"] != cfg.n_layers):
                fail(f"{what}: K4 launched {m['launches']} times for "
                     f"{cfg.n_layers} layers")
        if not gap <= LOGIT_GAP_TOL < control_gap:
            fail(f"{what}: logits gap {gap}, control {control_gap}, gate "
                 f"{LOGIT_GAP_TOL}")
        if not max(gaps) <= LOGIT_GAP_TOL:
            fail(f"{what}: decode logits gaps {gaps} against one device")
    return rows


def uneven_phase() -> dict:
    """Phase 5f (module doc): one device's side, the world of 1 x 3 ranks,
    the checks, and K4 at rank 0's heads of deepseek-coder-33b.  Returns
    K4's launches over the ranks' prefills and its times at that shape."""
    from repro_torch.distributed import run_world
    t0 = time.perf_counter()
    refs = uneven_references()
    refs_s = time.perf_counter() - t0
    feeds = {a: dict(inputs=r["inputs"], tokens=r["tokens"])
             for a, r in refs.items()}
    t0 = time.perf_counter()
    results = run_world(uneven_rank, UNEVEN_MESH[0] * UNEVEN_MESH[1], feeds,
                        mesh=UNEVEN_MESH, timeout=UNEVEN_TIMEOUT)
    world_s = time.perf_counter() - t0
    if {r["backend"] for r in results} != {"gloo"}:
        fail(f"ranks sharing the card chose "
             f"{[r['backend'] for r in results]}")
    t0 = time.perf_counter()
    uneven_checks(refs, results)
    times = flash_at(FA_DEEPSEEK_LOCAL, torch.Generator(
        device=CARD).manual_seed(LM_SEED),
        "deepseek-coder-33b under M = 3 (rank 0's 19 heads, K/V expanded)")
    say(f"phase 5f, the model axis where it does not divide the heads: "
        f"one device's side {refs_s:.1f} s, the 1 x 3 world "
        f"{world_s:.1f} s, its checks and K4 at the local shape "
        f"{time.perf_counter() - t0:.1f} s")
    del refs
    torch.cuda.empty_cache()
    k4 = UNEVEN_RUNS[0][0]
    return dict(launches=sum(r["serve"][k4]["launches"]["flash_attention"]
                             for r in results), times=times,
                prefill_comm=[r["serve"][k4]["prefill_comm"]
                              for r in results])


# ---------------------------------------------------------------------------
# experts and SSM heads that the model axis does not divide (phase 5g)
# ---------------------------------------------------------------------------
# A gloo world of 1 x 3 ranks sharing the card (a spawn of its own), bf16,
# seed LM_SEED, full width cut in depth (dbrx 2 layers, mamba2 4, zamba2 7
# with its shared block after the seventh: the script's time), run as
# phase 5e's: dbrx-132b's 16
# experts 6/6/4 and 48 heads 16/16/16 over its 8 replicated K/V heads (each
# rank's block straddles groups of 6 unevenly: K/V expanded to one a query
# head, K4 on it, FA_DBRX_UNEVEN), mamba2-2.7b's 80 SSM heads 27/27/26,
# zamba2-7b's 112 SSM heads 38/38/36 (its shared block's 32 heads
# 11/11/10) with one shared-block invocation; dbrx's prefill of 3072
# positions, which its FULL config's sequence parallelism splits over 3.
# zamba2 runs in fp32: in bf16 at 14 layers its teacher-forced decode over
# 1 x 3 drifts from one device's by bf16's rounding alone (0.027 at the
# first step, 0.051 at the eighth; 0.025-0.048 over phase 5e's 1 x 2,
# where bf16 alone moves it 0.049), past LOGIT_GAP_TOL, which then tests
# the rounding, not the model axis
FAMILY_UNEVEN_MESH = (1, 3)
FAMILY_UNEVEN_RUNS = (("dbrx-132b", dict(n_layers=2, attn_impl="pallas"),
                       (1, 3072)),
                      ("mamba2-2.7b", dict(n_layers=4), (1, 4096)),
                      ("zamba2-7b", dict(n_layers=7, shared_every=7,
                                         dtype="float32"), (1, 4096)))
FA_DBRX_UNEVEN = (1, 3072, 16, 16, 128)
FAMILY_UNEVEN_TIMEOUT = 600
# phase 5g's K4 launches and times, for the kernels' line
FAMILY_UNEVEN: dict = {}


def family_uneven_phase() -> dict:
    """Phase 5g (module doc): one device's side, the world of 1 x 3 ranks
    (each rank's K4 calls also held against the plain version), phase
    5e's checks over it, and K4 at rank 0's heads of dbrx-132b.  Returns
    K4's launches over the ranks' prefills and its times at that
    shape."""
    from repro_torch.distributed import run_world
    t0 = time.perf_counter()
    refs = family_references(FAMILY_UNEVEN_RUNS)
    refs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    size = FAMILY_UNEVEN_MESH[0] * FAMILY_UNEVEN_MESH[1]
    results = run_world(family_serve_rank, size, refs, FAMILY_UNEVEN_RUNS,
                        True, mesh=FAMILY_UNEVEN_MESH,
                        timeout=FAMILY_UNEVEN_TIMEOUT)
    world_s = time.perf_counter() - t0
    if {r["backend"] for r in results} != {"gloo"}:
        fail(f"ranks sharing the card chose "
             f"{[r['backend'] for r in results]}")
    t0 = time.perf_counter()
    family_serve_checks(refs, results, FAMILY_UNEVEN_RUNS,
                        FAMILY_UNEVEN_MESH, argmax_gate=False)
    times = flash_at(FA_DBRX_UNEVEN, torch.Generator(
        device=CARD).manual_seed(LM_SEED),
        "dbrx-132b under M = 3 (rank 0's 16 heads, K/V expanded)")
    say(f"phase 5g, experts and SSM heads the model axis does not divide: "
        f"one device's side {refs_s:.1f} s, the 1 x 3 world {world_s:.1f} "
        f"s, its checks and K4 at the local shape "
        f"{time.perf_counter() - t0:.1f} s")
    del refs
    torch.cuda.empty_cache()
    k4 = FAMILY_UNEVEN_RUNS[0][0]
    return dict(launches=sum(r["serve"][k4]["launches"]["flash_attention"]
                             for r in results), times=times)


# ---------------------------------------------------------------------------
# the dry run held to the card (phase 5h)
# ---------------------------------------------------------------------------
# The dry run (repro_torch.launch.dryrun) traces one rank on the meta
# device.  (a) granite-20b FULL's prefill of lm_main_path (B=PREFILL_BATCH x
# PREFILL_SEQ, attn_impl="pallas", one device): its parameter bytes and its
# FLOPs (hlo_cost over the card's prefill, K4's recorded work included)
# exactly, its peak estimate within DRY_PEAK_RATIO of the card's, its
# compute term printed beside the wall; (b) phase 5f's deepseek-coder-33b
# prefill over 1 x 3: every rank's collectives (calls and bytes by axis and
# op) exactly the gloo ranks' counts
DRY_PEAK_RATIO = (0.75, 1.25)
DRYRUN: dict = {}


def dry_granite(model, params, batch, prefill, wall: float, peak: int,
                before: int) -> dict:
    """Phase 5h(a) (above), from lm_main_path's prefill (``wall`` s,
    ``peak`` bytes allocated at most, ``before`` allocated before it):
    the card's side under ``hlo_cost``, then the dry trace at (1, 1)."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_cost import analyze
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    card = analyze(prefill, params, batch)
    del card["result"]
    nbytes = lambda tree: sum(t.numel() * t.element_size()  # noqa: E731
                              for t in tree_leaves(tree))
    param_bytes, args = nbytes(params), nbytes(params) + nbytes(batch)
    # the step's own peak: what was allocated besides its arguments before
    # it (earlier phases' tensors) taken out
    measured = peak - (before - args)
    B, S = batch["tokens"].shape
    dry = dryrun.trace_rank(model.cfg, ShapeCell("prefill", S, B, "prefill"),
                            (1, 1), exact=True)
    row = dict(arch=model.cfg.name, batch=B, seq=S, mesh="1x1",
               param_bytes=param_bytes, dry_param_bytes=dry["param_bytes"],
               flops=card["flops"], dry_flops=dry["flops"],
               k4=card["kernels"], dry_k4=dry["kernels"],
               bytes=card["bytes"], dry_bytes=dry["bytes"],
               peak_bytes=measured, peak_bytes_raw=peak,
               dry_peak_bytes=dry["peak_bytes"],
               peak_ratio=dry["peak_bytes"] / measured,
               card_hlo_cost_peak_bytes=card["peak_bytes"],
               wall_s=wall, dry_terms=dryrun.terms(dry),
               seconds=time.perf_counter() - t0)
    say("dry run against the card:", json.dumps(row))
    if dry["param_bytes"] != param_bytes:
        fail(f"dry run: {dry['param_bytes']} parameter bytes against the "
             f"card's {param_bytes}")
    if dry["flops"] != card["flops"] or not card["kernels"]:
        fail(f"dry run: {dry['flops']} FLOPs against hlo_cost's "
             f"{card['flops']} over the card's prefill ({card['kernels']})")
    lo, hi = DRY_PEAK_RATIO
    if not lo <= row["peak_ratio"] <= hi:
        fail(f"dry run: peak estimate {dry['peak_bytes']} against the "
             f"card's {measured} ({row['peak_ratio']:.3f}, allowed "
             f"{DRY_PEAK_RATIO})")
    return row


def _counted(axis_counts: dict) -> dict:
    """``comm.axis_counts()`` without the ops of no calls."""
    return {a: {op: c for op, c in ops.items() if c["calls"]}
            for a, ops in axis_counts.items()
            if any(c["calls"] for c in ops.values())}


def dry_collectives(ranks_comm: list) -> dict:
    """Phase 5h(b) (above): phase 5f's deepseek prefill traced dry for
    every rank of 1 x 3, its collectives against ``ranks_comm`` (each gloo
    rank's ``comm.axis_counts()`` over its prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    arch, cuts, (B, S) = UNEVEN_RUNS[0]
    cfg = get_config(arch, **cuts)
    t0 = time.perf_counter()
    rows = []
    for rank, real in enumerate(ranks_comm):
        dry = dryrun.trace_rank(cfg, ShapeCell("prefill", S, B, "prefill"),
                                UNEVEN_MESH, rank, exact=True)
        rows.append(dict(rank=rank, dry=dry["collective_detail"],
                         gloo=_counted(real)))
        if dry["collective_detail"] != rows[-1]["gloo"]:
            fail(f"dry run: {cfg.name} rank {rank}'s collectives "
                 f"{dry['collective_detail']} against the gloo rank's "
                 f"{rows[-1]['gloo']}")
    row = dict(arch=cfg.name, mesh=f"{UNEVEN_MESH[0]}x{UNEVEN_MESH[1]}",
               batch=B, seq=S, ranks=rows,
               seconds=time.perf_counter() - t0)
    say("dry run against the gloo ranks:", json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# the serving path: MatchingService on the card, batched run_many (phase 6)
# ---------------------------------------------------------------------------
SERVE_LADDER = dict(max_vertices=1 << 18, min_vertices=1 << 14)
SERVE_MAX_BATCH = 16
SERVE_DELAY_MS = 2.0
SERVE_REQUESTS = 256
SERVE_HINTS = (1 << 14, 1 << 16, 1 << 18)
SERVE_SEED = 0                     # request i: seed SERVE_SEED + i
SERVE_RATE_FRACTION = 0.7          # the open loop's rate / saturation
BURST_HINT = 1 << 16
BURST_REQUESTS = 16                # per configuration
# the batched bodies the default config (K1a) leaves out; the pull paths
# forced (every level pulls, as PATH_RUNS forces it), so that K3 launches
_FORCED_PULL = dict(dirop=True, use_pallas=True, dirop_alpha=1e6,
                    dirop_beta=1e6)
BURST_CONFIGS = {
    "gpubfs": dict(kernel="gpubfs"),
    "legacy": dict(use_pallas=True, pallas_fused=False),
    "legacy+gpubfs": dict(use_pallas=True, pallas_fused=False,
                          kernel="gpubfs"),
    "dirop_pallas": _FORCED_PULL,
    "dirop_pallas+gpubfs": dict(_FORCED_PULL, kernel="gpubfs"),
}
LANE_CHECK_LANES = 16
LANE_CHECK_LEVELS = 40             # levels of the first phase checked


def make_request(i: int) -> tuple:
    """Worker process: request ``i`` of the serving trace, its family
    (round-robin over ``serve_matching.FAMILIES``) at size hint
    ``SERVE_HINTS[i % 3]``, seed ``SERVE_SEED + i``; and its cardinality by
    scipy."""
    use_src()
    from scipy.sparse.csgraph import maximum_bipartite_matching
    from repro_torch.launch.serve_matching import FAMILIES
    names = list(FAMILIES)
    family, hint = names[i % len(names)], SERVE_HINTS[i % len(SERVE_HINTS)]
    g = FAMILIES[family](hint, SERVE_SEED + i)
    m = maximum_bipartite_matching(g.to_scipy().tocsr(), perm_type="column")
    return family, hint, g, int((m >= 0).sum())


def serve_cpu_batch(graphs) -> list:
    """Worker process: the bucket-padded ``graphs`` as one ``run_many`` on
    the CPU with the service's config and warm start; per lane the
    outcome."""
    use_src()
    torch.set_num_threads(2)
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
    from repro_torch.serving import Bucketizer, ladder
    bz = Bucketizer(ladder(**SERVE_LADDER), device="cpu")
    out = Matcher(MatcherConfig(), "cheap").run_many(
        TorchCSR.stack([bz.admit(g).graph for g in graphs]))
    return [outcome(s) for s in out.unstack()]


def make_trace(pool) -> list:
    """The serving trace's graphs, made by the workers.  Started when the
    serving phase starts, so that no worker competes with the earlier
    phases' host-clock timings."""
    return pool.map(make_request, range(SERVE_REQUESTS), chunksize=4)


def served_rows(results, trace, singles) -> None:
    """Every served request: a valid matching at scipy's cardinality,
    certified, and the single-graph run's state bit for bit."""
    from repro_torch.core import validate_matching
    for i, res in enumerate(results):
        family, hint, g, want = trace[i]
        cm, rm = res.matching()
        card = validate_matching(g, cm, rm)
        what = f"served request {i} ({family}, hint {hint})"
        if card != want or res.cardinality != want:
            fail(f"{what}: cardinality {card} != scipy's {want}")
        if not res.certified:
            fail(f"{what}: not certified")
        if not same_outcome(outcome(res.state), singles[i]):
            fail(f"{what}: state differs from the card's Matcher.run of "
                 f"the same bucket-padded graph")


def run_loop(svc, graphs, rate=None) -> tuple:
    """All of ``graphs`` through ``svc`` (closed loop: submit all, then
    drain; open loop: Poisson arrivals at ``rate``), the counts set to 0
    just before; returns (results, wall seconds, snapshot, host syncs)."""
    from repro_torch.launch.serve_matching import replay
    from repro_torch.matching.solve import COUNTERS
    syncs0 = COUNTERS.host_syncs
    t0 = time.perf_counter()
    if rate is None:
        futs = [svc.submit(g) for g in graphs]
    else:
        futs = [f for _, _, f in replay(svc, [("", g) for g in graphs],
                                        rate, SERVE_SEED)]
    results = [f.result(timeout=600) for f in futs]
    svc.drain()
    wall = time.perf_counter() - t0
    return (results, wall, svc.metrics.snapshot(),
            COUNTERS.host_syncs - syncs0)


def serving_phase(pool) -> list:
    """Phase 6 (module doc): returns the batched bodies' kernel entries."""
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.launch.serve_matching import chaos_drill
    from repro_torch.matching import (Matcher, MatcherConfig, TorchCSR,
                                      compile_cache_clear,
                                      compile_cache_info)
    from repro_torch.matching.cache import compile_cache_entry, max_bytes
    from repro_torch.matching.solve import COUNTERS
    from repro_torch.serving import (Bucketizer, FaultInjector,
                                     MatchingService, batch_ladder, ladder)

    compile_cache_clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trace = make_trace(pool)
    graphs = [g for _, _, g, _ in trace]
    buckets = ladder(**SERVE_LADDER)
    cfg, ws = MatcherConfig(), "cheap"
    say("serving trace:", json.dumps(dict(
        requests=len(trace), seeds=[SERVE_SEED, SERVE_SEED + len(trace) - 1],
        hints=SERVE_HINTS, families=sorted({f for f, *_ in trace}),
        buckets=[b.key for b in buckets], max_batch=SERVE_MAX_BATCH,
        max_delay_ms=SERVE_DELAY_MS, edges=sum(g.nnz for g in graphs),
        graphs_s=time.perf_counter() - t0)))

    def service(**kw):
        return MatchingService(
            bucketizer=Bucketizer(buckets, validate=True), config=cfg,
            warm_start=ws, max_batch=SERVE_MAX_BATCH,
            max_delay_ms=SERVE_DELAY_MS, **kw)

    def held():
        """The cache's bytes and evictions, and the graphs its entries
        captured so far."""
        info = compile_cache_info()
        return dict(cache_bytes=info["bytes"], evictions=info["evictions"],
                    captures=sum(compile_cache_entry(k).captures(CARD)
                                 for k in info["keys"]))

    # 1. warm-up: every step of the grid's entries captured, their bytes
    # measured after
    svc = service()
    ev0 = compile_cache_info()["evictions"]
    report = svc.warm_up()
    warmed = held()
    warm = dict(cells=report.cells, compiled=report.compiled,
                seconds=report.seconds, entry_bytes=report.entry_bytes,
                budget_bytes=max_bytes(), **warmed,
                batch_ladder=batch_ladder(SERVE_MAX_BATCH))
    say("serving warm-up:", json.dumps(warm))
    if warmed["evictions"] != ev0 or report.compiled != report.cells \
            or not warmed["captures"]:
        fail(f"warm-up evicted {warmed['evictions'] - ev0} entries, built "
             f"{report.compiled} of {report.cells} or captured "
             f"{warmed['captures']} graphs")

    # 2.-4. the serving main path, the counts set to 0 just before
    torch.cuda.synchronize()
    reset_launches()
    closed, closed_s, snap1, syncs1 = run_loop(svc, graphs)
    svc.close()
    rate = SERVE_RATE_FRACTION * len(graphs) / closed_s
    svc = service()
    opened, open_s, snap2, syncs2 = run_loop(svc, graphs, rate)
    svc.close()
    # the loops ran on the warmed entries alone: nothing captured, nothing
    # evicted, the bytes as warm-up left them
    looped = held()
    if looped != warmed:
        fail(f"the loops after warm-up changed the cache: {warmed} -> "
             f"{looped}")
    burst_graphs = [g for _, h, g, _ in trace if h == BURST_HINT]
    burst_graphs = burst_graphs[:BURST_REQUESTS]
    svc = service()
    burst = {}
    for name, kw in BURST_CONFIGS.items():
        bcfg = dataclasses.replace(cfg, **kw)
        futs = [svc.submit(g, config=bcfg) for g in burst_graphs]
        burst[name] = (bcfg, [f.result(timeout=600) for f in futs])
    svc.drain()
    snap3 = svc.metrics.snapshot()
    svc.close()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    loop = lambda snap, wall, syncs: dict(              # noqa: E731
        wall_s=wall, graphs_per_s=len(graphs) / wall,
        latency_p50_ms=snap["latency_p50_ms"],
        latency_p99_ms=snap["latency_p99_ms"],
        queue_wait_p50_ms=snap["queue_wait_p50_ms"],
        occupancy=snap["occupancy"], dispatches=snap["dispatches"],
        requests=snap["submitted"], host_syncs=syncs,
        host_syncs_per_flush=syncs / max(1, snap["dispatches"]),
        compile_hits=snap["compile_hits"],
        compile_misses=snap["compile_misses"],
        pad_edge_waste=snap["pad_edge_waste"],
        flushes=[snap["flushes_full"], snap["flushes_deadline"],
                 snap["flushes_drain"]])
    rows = dict(closed_loop=loop(snap1, closed_s, syncs1),
                open_loop=dict(loop(snap2, open_s, syncs2),
                               offered_rate=rate),
                burst=dict(dispatches=snap3["dispatches"],
                           requests=snap3["submitted"]),
                cache_after_loops=looped, launches=launches)
    say("serving main path:", json.dumps(rows))
    if snap2["compile_misses"] or snap1["compile_misses"]:
        fail(f"the warmed service missed the cache "
             f"({snap1['compile_misses']} closed, "
             f"{snap2['compile_misses']} open loop)")
    for body in KERNELS:
        if not launches[f"{body}_batched"]:
            fail(f"{body}_batched was not launched by the serving path")

    # every served request against scipy and the card's single-graph run
    t1 = time.perf_counter()
    bz = Bucketizer(buckets)
    single = Matcher(cfg, ws)
    singles = [outcome(single.run(bz.admit(g).graph)) for g in graphs]
    served_rows(closed, trace, singles)
    served_rows(opened, trace, singles)
    for name, (bcfg, results) in burst.items():
        m = Matcher(bcfg, ws)
        want = [outcome(m.run(bz.admit(g, csc=bcfg.dirop or None).graph))
                for g in burst_graphs]
        idx = [i for i, (_, h, _, _) in enumerate(trace)
               if h == BURST_HINT][:BURST_REQUESTS]
        served_rows(results, [trace[i] for i in idx], want)
    # one batch of the 2^14 bucket: the card's run_many against the CPU's
    small = [g for _, h, g, _ in trace if h == SERVE_HINTS[0]]
    small = small[:SERVE_MAX_BATCH]
    cpu_pending = pool.apply_async(serve_cpu_batch, (small,))
    card = single.run_many(TorchCSR.stack([bz.admit(g).graph
                                           for g in small]))
    for i, (a, b) in enumerate(zip([outcome(s) for s in card.unstack()],
                                   cpu_pending.get())):
        if not same_outcome(a, b):
            fail(f"lane {i} of the 2^14 batch differs from the CPU's "
                 f"run_many")
    say(f"serving checks: {len(closed) + len(opened)} loop requests and "
        f"{sum(len(r) for _, r in burst.values())} burst requests valid, at "
        f"scipy's cardinality, certified and equal to the single-graph "
        f"run; the {len(small)}-lane 2^14 batch equals the CPU's run_many "
        f"({time.perf_counter() - t1:.1f} s)")

    # 5. the chaos drill
    injector = FaultInjector(seed=SERVE_SEED)
    svc = service(faults=injector)
    failures = chaos_drill(svc, injector, SERVE_HINTS[0], SERVE_SEED)
    svc.close()
    if failures:
        fail(f"the chaos drill found {failures} violations")
    compile_cache_clear()
    torch.cuda.empty_cache()
    phase("serving", t0)

    t0 = time.perf_counter()
    lane = [g for _, h, g, _ in trace if h == SERVE_HINTS[-1]]
    entries = lane_checks(bz, lane[:LANE_CHECK_LANES], launches)
    phase("batched kernel checks", t0)
    return entries


def lane_checks(bz, graphs, launches) -> list:
    """Each kernel body with its lane dimension over the first BFS phase of
    a batch of ``graphs`` (module doc): the lanes start at staggered
    levels and leave as their BFS ends (gated off); one launch against the
    plain version and the single-graph launch of each lane, bit for bit;
    times and bounds.  Returns the batched entries of the kernels line."""
    from repro_torch.kernels.frontier_expand import (
        frontier_bits, frontier_bits_ref, frontier_expand,
        frontier_expand_fused, frontier_expand_fused_ref,
        frontier_expand_pull, frontier_expand_pull_ref, frontier_expand_ref)
    from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
    from repro_torch.matching.solve import _apply_winner, level0_state

    b = TorchCSR.stack([bz.admit(g, csc=True).graph for g in graphs])
    nb, nr = b.batch_shape[0], b.nr
    warm = [Matcher(MatcherConfig(), "cheap").init(ln) for ln in b.unstack()]
    cm = torch.stack([w.cmatch for w in warm])
    rm = torch.stack([w.rmatch for w in warm])
    bfs, root = level0_state(cm)
    pred = torch.full_like(rm, b.nc)
    level = torch.full((nb,), 2, dtype=torch.int32, device=CARD)
    delay = torch.arange(nb, device=CARD) % 3
    alive = torch.ones(nb, dtype=torch.bool, device=CARD)
    bodies = {
        "frontier_expand_fused": (frontier_expand_fused,
                                  frontier_expand_fused_ref, "push"),
        "frontier_expand": (frontier_expand, frontier_expand_ref, "prop"),
        "frontier_expand_pull": (frontier_expand_pull,
                                 frontier_expand_pull_ref, "pull"),
        "frontier_bits": (frontier_bits, frontier_bits_ref, "bits")}
    states = []
    for step in range(LANE_CHECK_LEVELS):
        gate = (alive & (delay <= step)).to(torch.int32)
        if not bool(gate.any()):
            break
        lv = level.clone()
        st = (bfs.clone(), root.clone(), rm.clone(), lv, gate.clone())
        for name, (kernel, plain, kind) in bodies.items():
            for wr in (True, False):
                args = lane_args(b, st, kind, wr)
                got = kernel(*args)
                if not torch.equal(got, plain(*args)):
                    fail(f"{name} ({'WR' if wr else 'plain'}) with {nb} "
                         f"lanes differs from its plain version at step "
                         f"{step}")
                for i in range(nb):
                    one = kernel(*[a[i] if isinstance(a, torch.Tensor)
                                   else a for a in args])
                    if not torch.equal(got[i], one):
                        fail(f"{name} lane {i} differs from its single "
                             f"launch at step {step}")
        states.append(st)
        win = frontier_expand_fused(b.ecol, b.cadj, bfs, root, rm, lv, gate)
        live = gate != 0
        *_, ins, _ = _apply_winner(win, bfs, root, pred, rm, level,
                                   wr=True, wr_exact=False, inplace=True)
        level += live
        alive &= ~live | ins
    say(f"batched kernels: {len(states)} steps of {nb} lanes bit for bit "
        f"against the plain version and the single launches")
    entries = []
    for name, (kernel, plain, kind) in bodies.items():
        for wr in (True, False):
            body = f"{name}_{'wr' if wr else 'plain'}"
            per = [lane_args(b, st, kind, wr) for st in states]
            n = len(per)
            ms = cuda_ms(lambda: [kernel(*a) for a in per]) / n
            singles_ms = cuda_ms(lambda: [
                kernel(*[x[i] if isinstance(x, torch.Tensor) else x
                         for x in a]) for a in per for i in range(nb)],
                reps=5, warmup=1) / n
            plain_ms = cuda_ms(lambda: [plain(*a) for a in per], reps=3,
                               warmup=1) / n
            bound = sum(lane_bound(kind, a, nr) for a in per) / n
            entries.append(dict(
                name=f"{body}_batched", route="cuda",
                source="src/repro_torch/csrc/frontier_expand.cu",
                replaces=KERNELS[body],
                launches=launches[f"{body}_batched"],
                max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=None, lanes=nb,
                singles_ms=singles_ms, levels_checked=n,
                timed_on=f"{nb} lanes of the {b.nc}^2 bucket"))
            say("batched kernel:", json.dumps(entries[-1]))
    return entries


def lane_args(b, st, kind: str, wr: bool) -> tuple:
    """A batched kernel's arguments for one checked step."""
    bfs, root, rm, level, gate = st
    rt = root if wr else None
    if kind == "bits":
        return (bfs, rt, level)
    cols, rows = (b.radj, b.erow) if kind == "pull" else (b.ecol, b.cadj)
    return (cols, rows, bfs, rt, rm, level, gate)


def lane_bound(kind: str, args: tuple, nr: int) -> float:
    """Least time for one batched launch: each lane that runs moves its
    single-graph bytes, a gated-off lane only writes its output."""
    nbytes = 0
    for i in range(args[2 if kind != "bits" else 0].shape[0]):
        one = [a[i] if isinstance(a, torch.Tensor) else a for a in args]
        if kind == "bits":
            one[-1] = int(one[-1])
            nbytes += bits_bytes(*one)
            continue
        on, one = int(one[-1]), one[:-2] + [int(one[-2])]
        if kind == "push":
            nbytes += push_bytes(*one) if on else 4 * (nr + 1)
        elif kind == "prop":
            nbytes += (proposal_bytes(*one) if on
                       else 4 * one[0].numel())
        else:
            nbytes += pull_bytes(*one) if on else 4 * (nr + 1)
    return bound_ms(nbytes)


# ---------------------------------------------------------------------------
# the fuzzer, the dirop traces, the warm-start wrappers and the examples on
# the card (phase 6b)
# ---------------------------------------------------------------------------
FUZZ_WARM_STARTS = ("none", "cheap", "karp_sipser")
FUZZ_CELLS = 420                   # 20 mini instances x 7 paths x 3 starts
# the bodies the fuzz's paths launch under MatcherConfig(): K1a (jnp, fused,
# adaptive, dirop, sharded and dirop_pallas's push levels), K2a (legacy),
# K3a (dirop_pallas's pull levels)
FUZZ_BODIES = ("frontier_expand_fused_wr", "frontier_expand_wr",
               "frontier_expand_pull_wr")
# the traced main-path graphs and their warm starts (the main path's)
TRACES = ((KRON, "cheap"), (RANDOM, "karp_sipser"))
EXAMPLES = ("quickstart", "distributed_matching", "matching_service",
            "moe_matching_router", "serve_lm", "train_lm")


def small_traces_cpu() -> dict:
    """Worker process: each ``instance_sets("small")`` family's dirop trace
    (``cheap`` start) and both warm-start wrappers' matchings on the CPU;
    (family -> (trace, cheap (cmatch, rmatch), Karp-Sipser (cmatch,
    rmatch)), the seconds it took)."""
    use_src()
    torch.set_num_threads(1)
    from repro_torch.core import cheap_matching_torch, karp_sipser_torch
    from repro_torch.corpus.heuristic import trace_instance
    t0 = time.perf_counter()
    out = {name: (trace_instance(g, "cheap", device="cpu"),
                  cheap_matching_torch(g, device="cpu"),
                  karp_sipser_torch(g, device="cpu"))
           for name, g in small_sets().items()}
    return out, time.perf_counter() - t0


def counted(fn):
    """``fn()`` with the frontier kernels' launch counts set to 0 just
    before and read just after: (its result, body -> launches)."""
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def fuzz_on_card() -> dict:
    """(a): the differential fuzzer over every solve path x warm start x
    mini instance on the card, against the port's Hopcroft-Karp; returns
    its launches by body."""
    from repro_torch.corpus.verify import verify_corpus
    from repro_torch.matching import compile_cache_clear, compile_cache_info

    compile_cache_clear()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report, launches = counted(lambda: verify_corpus(
            scale="mini", warm_starts=FUZZ_WARM_STARTS, device="cuda",
            artifact_dir=tmp))
    secs = time.perf_counter() - t0
    misses = compile_cache_info()["misses"]
    combos = len({(r.path, r.warm_start) for r in report.results})
    compile_cache_clear()
    say(report.summary())
    say("fuzz on the card:", json.dumps(dict(
        cells=len(report.results), failures=len(report.failures),
        path_warm_starts=combos, cache_misses=misses, seconds=secs,
        launches={b: launches[b] for b in FUZZ_BODIES})))
    if report.failures:
        fail(f"the fuzz found {len(report.failures)} failing cells on the "
             f"card")
    if len(report.results) != FUZZ_CELLS:
        fail(f"the fuzz ran {len(report.results)} cells, not {FUZZ_CELLS}")
    if misses > combos:
        fail(f"{misses} compile-cache misses for {combos} (path, warm "
             f"start) cells: the shared bucket did not hold")
    for body in FUZZ_BODIES:
        if not launches[body]:
            fail(f"the fuzz did not launch {body}")
    return launches


def warm_row(g, cfg, ws) -> tuple:
    """One configuration cold, then once warm: (the warm run's row
    (:func:`counted_run`) with its phases, both runs' launches)."""
    _, _, cold = counted_run(g, cfg, ws)
    state, _, row = counted_run(g, cfg, ws)
    launches = collections.Counter(cold["launches"])
    launches.update(row["launches"])
    return dict(row, phases=int(state.phases),
                warm_wall_s=row["wall_s"]), launches


def trace_checks(graphs, runs) -> dict:
    """(b) at full width: the dirop trace of kron-21 (cheap) and random-4M
    (Karp-Sipser) on the card, held to relations (i)-(iii) against solves
    of the same graph, config and warm start: phase 2's on kron, this
    phase's on random-4M (phase 2 solves it under ``kernel="gpubfs"``);
    the modelled rel over the sweep grid beside the measured
    ``dirop_pallas`` / ``jnp`` warm-wall ratio.  Returns the launches."""
    from repro_torch.corpus.heuristic import (modelled_rel, sweep_grid,
                                              trace_instance)
    from repro_torch.matching import (SOLVE_PATHS, MatcherConfig,
                                      compile_cache_clear)

    total = collections.Counter()
    for gi, ws in TRACES:
        g, expr = graphs[gi], label(MAIN_PATH[gi])
        t0 = time.perf_counter()
        tr, launches = counted(lambda: trace_instance(g, ws))
        secs = time.perf_counter() - t0
        total.update(launches)
        k1a = launches["frontier_expand_fused_wr"]
        # once a traced level by the replay, once a level by the one-phase
        # solves that advance it (relation ii)
        if k1a != 2 * tr.levels or sum(launches.values()) != k1a:
            fail(f"trace of {expr}: launches {launches} for {tr.levels} "
                 f"traced levels (want K1a alone, twice a level)")
        cfg = MatcherConfig()
        pull_cfg = SOLVE_PATHS["dirop_pallas"].configure(cfg)
        if gi == KRON:
            base, pull = (next(r for r in runs if r["graph"] == expr
                               and r["path"] == p and r["warm_start"] == ws)
                          for p in ("jnp", "dirop_pallas"))
        else:
            (base, n_base), (pull, n_pull) = (warm_row(g, c, ws)
                                              for c in (cfg, pull_cfg))
            compile_cache_clear()
            total.update(n_base)
            total.update(n_pull)
        alpha, beta = pull_cfg.dirop_alpha, pull_cfg.dirop_beta
        rel, pulls = modelled_rel(tr, alpha, beta)
        relations = dict(
            phases=(len(tr.phases), base["phases"]),
            levels=(tr.levels, base["levels"], pull["levels"]),
            pull_levels=(pulls, pull["pull_levels"]))
        say("dirop trace:", json.dumps(dict(
            graph=expr, warm_start=ws, seconds=secs, phases=len(tr.phases),
            levels=tr.levels, k1a_launches=k1a, relations=relations,
            modelled_rel={f"{a:g}/{b:g}": modelled_rel(tr, a, b)
                          for a, b in sweep_grid()},
            measured_dirop_pallas_over_jnp=(
                pull["warm_wall_s"] / base["warm_wall_s"]),
            warm_wall_s=dict(jnp=base["warm_wall_s"],
                             dirop_pallas=pull["warm_wall_s"],
                             dirop_pallas_with_csc=pull["with_csc_s"]))))
        if len(tr.phases) != base["phases"]:
            fail(f"trace of {expr}: {len(tr.phases)} phases, the solve "
                 f"{base['phases']} (relation i)")
        if not tr.levels == base["levels"] == pull["levels"]:
            fail(f"trace of {expr}: {tr.levels} levels, the solves "
                 f"{base['levels']} / {pull['levels']} (relation ii)")
        if pulls != pull["pull_levels"]:
            fail(f"trace of {expr}: {pulls} modelled pulls at {alpha:g}/"
                 f"{beta:g}, dirop_pallas pulled {pull['pull_levels']} "
                 f"levels (relation iii)")
    return total


def small_checks(cpu_pending) -> dict:
    """(b) and (c) on the nine small families: the card's trace (cheap)
    and both warm-start wrappers equal the CPU worker's, entry for entry
    and bit for bit.  Returns the launches."""
    from repro_torch.core import cheap_matching_torch, karp_sipser_torch
    from repro_torch.corpus.heuristic import trace_instance

    t0 = time.perf_counter()
    cpu, cpu_s = cpu_pending.get()
    wait = time.perf_counter() - t0
    total = collections.Counter()
    t0 = time.perf_counter()
    levels = {}
    for name, g in small_sets().items():
        tr, launches = counted(lambda: trace_instance(g, "cheap"))
        total.update(launches)
        levels[name] = tr.levels
        if launches["frontier_expand_fused_wr"] != 2 * tr.levels:
            fail(f"trace of small {name}: {launches} for {tr.levels} "
                 f"traced levels")
        if tr != cpu[name][0]:
            fail(f"the card's trace of small {name} differs from the CPU's")
        for fn, want in zip((cheap_matching_torch, karp_sipser_torch),
                            cpu[name][1:]):
            if not all((a == b).all() for a, b in zip(fn(g), want)):
                fail(f"{fn.__name__} on small {name}: card != CPU")
    say(f"small sets: traces and wrappers card == CPU on {len(levels)} "
        f"families, levels {levels}, card {time.perf_counter() - t0:.2f} s "
        f"(the CPU worker's {cpu_s:.1f} s, waited {wait:.1f} s)")
    return total


def wrapper_checks(graphs) -> None:
    """(c) at full width: each warm-start wrapper on kron-21 and random-4M
    gives a valid matching, the same cold (its entry built) and warm."""
    from repro_torch.core import (cheap_matching_torch, karp_sipser_torch,
                                  validate_matching)
    for gi in (KRON, RANDOM):
        g = graphs[gi]
        for fn in (cheap_matching_torch, karp_sipser_torch):
            secs = []
            outs = []
            for _ in range(2):
                t0 = time.perf_counter()
                outs.append(fn(g))
                secs.append(time.perf_counter() - t0)
            card = validate_matching(g, *outs[1])
            same = all((a == b).all() for a, b in zip(*outs))
            say("wrapper:", json.dumps(dict(
                graph=label(MAIN_PATH[gi]), wrapper=fn.__name__,
                cardinality=card, cold_s=secs[0], warm_s=secs[1],
                cold_equal_warm=same)))
            if not same:
                fail(f"{fn.__name__} on {label(MAIN_PATH[gi])}: the warm "
                     f"call differs from the cold one")


def example_runs() -> dict:
    """(d): each ``examples/torch`` script once on the card at its default
    size, in this process (``runpy`` with ``sys.argv`` set); each must end
    normally, the quickstart with Hopcroft-Karp's cardinality.  Returns
    the launches."""
    import runpy

    total = collections.Counter()
    argv = sys.argv
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLES:
            path = os.path.join(HERE, "examples", "torch", f"{name}.py")
            sys.argv = [path] + (["--ckpt-dir", tmp] if name == "train_lm"
                                 else [])
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    _, launches = counted(
                        lambda: runpy.run_path(path, run_name="__main__"))
            finally:
                sys.argv = argv
            secs = time.perf_counter() - t0
            total.update(launches)
            out = buf.getvalue()
            say(out.rstrip())
            say(f"example {name}: ended normally in {secs:.2f} s, "
                f"launches {dict((k, v) for k, v in launches.items() if v)}")
            if name == "quickstart" and "Hopcroft-Karp cardinality" not in out:
                fail("quickstart did not print Hopcroft-Karp's cardinality")
    return total


def corpus_phase(graphs, runs, cpu_traces) -> dict:
    """Phase 6b (module doc); returns its launches by kernel body."""
    from repro_torch.matching import compile_cache_clear

    total = collections.Counter()
    for part, fn in (("fuzz", fuzz_on_card),
                     ("traces", lambda: trace_checks(graphs, runs)),
                     ("small sets", lambda: small_checks(cpu_traces)),
                     ("wrappers", lambda: wrapper_checks(graphs)),
                     ("examples", example_runs)):
        t0 = time.perf_counter()
        total.update(fn() or {})
        compile_cache_clear()
        torch.cuda.empty_cache()
        say(f"phase 6b {part}: {time.perf_counter() - t0:.1f} s")
    return dict(total)


# ---------------------------------------------------------------------------
# the LM serving path: granite-20b, prefill + decode, flash attention (K4)
# ---------------------------------------------------------------------------
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12           # H100 SXM fp32 on the CUDA cores
CARD = "cuda"
LM_ARCH = "granite-20b"
LM_SEED = 0
PREFILL_BATCH, PREFILL_SEQ = 4, 4096
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 64, 16
# the two-layer full-width fp32 checks: batch, sequence
FP32_BATCH, FP32_SEQ = 2, 64
# (B, S, H, KV, hd) of tests/test_kernels.py, then granite-20b's layer
FA_SHAPES = [(2, 512, 4, 2, 64), (1, 1024, 8, 8, 128), (2, 256, 4, 1, 64),
             (1, 512, 6, 2, 128), (2, 256, 4, 4, 32)]
FA_GRANITE = (PREFILL_BATCH, PREFILL_SEQ, 48, 1, 128)
# dbrx-132b's layer shape at its prefill (B=4, S=2048; 48 heads, 8 K/V)
FA_DBRX = (4, 2048, 48, 8, 128)
# the kernel tolerances of tests/test_kernels.py (rtol = atol)
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the body each dtype must launch (the port's routing table)
FA_BODY = {torch.float32: "flash_attention_simt",
           torch.bfloat16: "flash_attention_tc"}
# At granite's shape the output is a softmax average over thousands of keys,
# of typical magnitude ~sqrt(e / S), about as large as the elementwise 2e-2
# floor.  There K4 is also held to |got - want| / |want| in three norms,
# each gated between the kernel's reading and a control's.  The l2 norm
# over the whole output and the max norm face the plain version with one
# key tile (keys FA_DROP, one K4 tile in the middle) masked for every
# query, which is what a kernel that skips that tile returns.  The worst
# query row's l2 ratio faces the same tile masked for one 128-row query
# tile only (FA_DROP_ROWS): a fault confined to a few rows, which the
# whole-output norms hardly see, and the kind a wrong swizzle or diagonal
# mask in one tile makes.  Readings on an H100 (bf16, seed LM_SEED; causal
# / full): kernel l2 0.0043 / 0.0050, max 0.0050 / 0.0163, row 0.018 /
# 0.019; control l2 0.066 / 0.177, max 0.074 / 0.483; one-query-tile
# control row 0.90 / 0.79 (its whole-output l2 0.022 / 0.031).  The script
# fails if a control does not exceed its gate.
FA_REL_TOL = {"l2": 1.5e-2, "max": 3e-2, "row": 5e-2}
K4_TILE = 128                      # keys per tile of flash_fwd_tc<128>
FA_DROP = (PREFILL_SEQ // 2, PREFILL_SEQ // 2 + K4_TILE)
FA_DROP_ROWS = (FA_DROP[1], FA_DROP[1] + 128)     # sees FA_DROP either way
K4_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:29"
# Gate of the 52-layer bf16 prefill, pallas against xla: max |d| / max |ref|
# of the last-position logits.  Both run bf16 end to end and differ only in
# where the attention rounds (the kernel rounds p to bf16 and keeps its
# accumulator in fp32; blockwise_attn, as the JAX package's, rounds p and
# the accumulator to bf16), a perturbation of a few bf16 ulps (2^-8) per layer that the
# residual stream carries through 52 layers.  The gate lies between that
# reading and the same reading of a control prefill whose attention output
# is zero in one layer (skip_attention).  Readings on an H100: pallas
# 0.0112 (argmax 4/4), the control 0.20 (argmax 2/4).  A fault as small as
# one dropped key tile stays under this gate; the kernel's scaled check
# above is the one that sees it.  The script fails if the control does not
# exceed the gate.  The model path is also held at 1e-3 in fp32
# (fp32_checks).
LOGIT_GAP_TOL = 5e-2


def fa_flops(B, S, H, hd, causal: bool) -> int:
    """Flops of one attention call: q.k and p.v, 2 hd each per (query,
    key) pair the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * H * hd * pairs


def fa_bytes(B, S, H, KV, hd, itemsize) -> int:
    """q, k and v read once, out written once."""
    return itemsize * hd * B * S * (2 * H + 2 * KV)


def fa_inputs(shape, dtype, gen):
    B, S, H, KV, hd = shape
    return [torch.randn(s, generator=gen, device=CARD).to(dtype)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def fa_plain(q, k, v, causal):
    """The plain version one batch element at a time (its fp32 scores are
    12.9 GB at granite's shape for the whole batch)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    return torch.cat([flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                          v[i:i + 1], causal=causal)
                      for i in range(q.shape[0])])


def close(name, got, want, tol) -> float:
    """Fail unless ``got`` is finite and within rtol = atol = ``tol`` of
    ``want``; returns the largest absolute difference."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > tol + tol * want.abs()).sum())
    say(f"{name}: max |d| {float(err.max()):.3e}, {bad} outside "
        f"rtol = atol = {tol}")
    if bad or not torch.isfinite(got).all():
        fail(f"{name}: {bad} values outside rtol = atol = {tol}")
    return float(err.max())


def rel_gaps(got, want) -> dict:
    """|got - want| / |want| in the l2 norm over all values, in the max
    norm, and per query row (the worst row's l2 ratio over its hd
    values)."""
    d, w = (got.float() - want.float()), want.float()
    rows = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return {"l2": float(d.norm() / w.norm()),
            "max": float(d.abs().max() / w.abs().max()),
            "row": float(rows.max())}


def fa_tile_dropped(q, k, v, causal, lo, hi, rows=(0, None)):
    """Control: the plain version with keys [lo, hi) masked for the queries
    ``rows`` (all by default), one batch element at a time."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    keep = torch.ones(S, k.shape[1], dtype=torch.bool, device=q.device)
    keep = keep.tril() if causal else keep
    keep[rows[0]:rows[1], lo:hi] = False
    out = []
    for i in range(B):
        qg = q[i:i + 1].reshape(1, S, KV, H // KV, hd)
        s = torch.einsum("bskgh,btkh->bkgst", qg, k[i:i + 1]).float()
        s = (s * hd ** -0.5).masked_fill_(~keep, -1e30)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        del s
        out.append(torch.einsum("bkgst,btkh->bskgh", p, v[i:i + 1])
                   .reshape(1, S, H, hd))
    return torch.cat(out)


def scaled_check(name, got, want, control, row_control) -> None:
    """Fail unless ``got`` is within FA_REL_TOL of ``want`` in every norm of
    ``rel_gaps`` and each control is outside its gate: ``control`` (the key
    tile dropped for every query) in the l2 and max norms, ``row_control``
    (dropped for one query tile) in the per-row norm."""
    mine = rel_gaps(got, want)
    ctrl, ctrl_rows = rel_gaps(control, want), rel_gaps(row_control, want)
    seen = {"l2": ctrl["l2"], "max": ctrl["max"], "row": ctrl_rows["row"]}
    say("flash scaled check:", json.dumps(dict(
        check=name, rel_gap=mine, control_rel_gap=ctrl,
        row_control_rel_gap=ctrl_rows, tolerance=FA_REL_TOL)))
    for norm, tol in FA_REL_TOL.items():
        if not mine[norm] <= tol:
            fail(f"{name}: |d| / |ref| in the {norm} norm {mine[norm]} > "
                 f"{tol}")
        what = (f"keys {FA_DROP} dropped" + (
            f" for queries {FA_DROP_ROWS}" if norm == "row" else ""))
        if not seen[norm] > tol:
            fail(f"{name}: the control ({what}) reads {seen[norm]} in the "
                 f"{norm} norm, within the gate {tol}: the gate would not "
                 f"see that fault")


def flash_checks() -> dict:
    """K4 against its plain version on the card at every checked shape and
    both masks, and at granite's layer shape also in scaled norms against
    a control; times at granite's layer shape.  Runs before the weights
    exist.  Returns the kernel's entry, without ``launches``."""
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("flash attention checks: TF32 off (torch.backends.cuda.matmul."
        "allow_tf32 = False); tolerance rtol = atol = 2e-5 fp32, 2e-2 bf16")
    gen = torch.Generator(device=CARD).manual_seed(LM_SEED)
    worst = 0.0
    cases = [(s, dt) for s in FA_SHAPES for dt in FA_TOL]
    cases.append((FA_GRANITE, torch.bfloat16))
    for shape, dtype in cases:
        q, k, v = fa_inputs(shape, dtype, gen)
        for causal in (True, False):
            what = f"flash vs plain, {shape} {str(dtype)[6:]} causal={causal}"
            before = LAUNCHES[FA_BODY[dtype]]
            got = flash_attention(q, k, v, causal=causal)
            if LAUNCHES[FA_BODY[dtype]] != before + 1:
                fail(f"{what}: not launched on {FA_BODY[dtype]}")
            want = fa_plain(q, k, v, causal)
            worst = max(worst, close(what, got, want, FA_TOL[dtype]))
            if shape == FA_GRANITE:
                scaled_check(what, got, want,
                             fa_tile_dropped(q, k, v, causal, *FA_DROP),
                             fa_tile_dropped(q, k, v, causal, *FA_DROP,
                                             rows=FA_DROP_ROWS))
            del got, want
        torch.cuda.empty_cache()
    # q, k, v are granite's now
    B, S, H, KV, hd = FA_GRANITE
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    lib_err = float((lib.float() - fa_plain(q, k, v, True).float())
                    .abs().max())
    times = {}
    for causal in (True, False):
        times[causal] = dict(
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                       reps=10),
            plain_ms=cuda_ms(lambda: fa_plain(q, k, v, causal), reps=2,
                             warmup=1),
            library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                            enable_gqa=True), reps=10))
        times[causal]["tflops"] = (fa_flops(B, S, H, hd, causal)
                                   / times[causal]["ms"] / 1e9)
    flops = fa_flops(B, S, H, hd, True)
    nbytes = fa_bytes(B, S, H, KV, hd, 2)
    bound = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    row = dict(shape=FA_GRANITE, dtype="bfloat16", flops_causal=flops,
               bytes=nbytes, bound_ms_causal=bound,
               bound_ms_full=max(fa_flops(B, S, H, hd, False)
                                 / BF16_FLOPS_PER_S,
                                 nbytes / HBM_BYTES_PER_S) * 1e3,
               causal=times[True], full=times[False],
               sdpa_vs_plain_max_abs_err=lib_err)
    say("flash attention at granite's layer shape:", json.dumps(row))
    del q, k, v, qt, kt, vt, lib
    torch.cuda.empty_cache()
    fp32 = fp32_granite(gen)
    dbrx = flash_at(FA_DBRX, gen, "dbrx")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces=K4_REPLACES, launches=0, max_abs_err=worst,
                ms=times[True]["ms"], plain_ms=times[True]["plain_ms"],
                bound_ms=bound,
                bound_by=("operations" if flops / BF16_FLOPS_PER_S
                          >= nbytes / HBM_BYTES_PER_S else "bytes"),
                library_ms=times[True]["library_ms"],
                body="flash_fwd_tc<128>", tflops=times[True]["tflops"],
                timed_on=f"B={B} S={S} H={H} KV={KV} hd={hd} bf16 causal",
                fp32=fp32, dbrx=dbrx)


def flash_at(shape, gen, name: str) -> dict:
    """K4 at a model's prefill shape (B, S, H, KV, hd), bf16, both masks:
    against its plain version (2e-2, the tensor-core body), then timed
    beside the plain version and ``scaled_dot_product_attention`` (with
    ``enable_gqa``), and its bound."""
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention)

    B, S, H, KV, hd = shape
    q, k, v = fa_inputs(shape, torch.bfloat16, gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = fa_bytes(B, S, H, KV, hd, 2)
    out = dict(body=f"flash_fwd_tc<{hd}>", shape=shape, dtype="bfloat16")
    for causal in (True, False):
        what = f"flash vs plain, {shape} bfloat16 causal={causal}"
        before = LAUNCHES["flash_attention_tc"]
        got = flash_attention(q, k, v, causal=causal)
        if LAUNCHES["flash_attention_tc"] != before + 1:
            fail(f"{what}: not launched on flash_attention_tc")
        err = close(what, got, fa_plain(q, k, v, causal),
                    FA_TOL[torch.bfloat16])
        del got
        flops = fa_flops(B, S, H, hd, causal)
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                     reps=10)
        out["causal" if causal else "full"] = dict(
            ms=ms, tflops=flops / ms / 1e9, max_abs_err=err,
            plain_ms=cuda_ms(lambda: fa_plain(q, k, v, causal), reps=2,
                             warmup=1),
            library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                            enable_gqa=True), reps=10),
            bound_ms=max(flops / BF16_FLOPS_PER_S,
                         nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by=("operations" if flops / BF16_FLOPS_PER_S
                      >= nbytes / HBM_BYTES_PER_S else "bytes"))
        torch.cuda.empty_cache()
    say(f"flash attention at {name}'s layer shape:", json.dumps(out))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def fp32_granite(gen) -> dict:
    """K4's fp32 body (``flash_fwd_simt``, CUDA cores) at granite's layer
    shape, both masks, TF32 off: against its plain version (2e-5), then
    timed beside the plain version and ``scaled_dot_product_attention`` in
    fp32.  Its bound: flops over the fp32 peak of the CUDA cores, or bytes
    over HBM bandwidth, whichever is larger."""
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention)

    B, S, H, KV, hd = FA_GRANITE
    q, k, v = fa_inputs(FA_GRANITE, torch.float32, gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = fa_bytes(B, S, H, KV, hd, 4)
    out = dict(body="flash_fwd_simt<128>", shape=FA_GRANITE, dtype="float32",
               tf32=torch.backends.cuda.matmul.allow_tf32)
    for causal in (True, False):
        what = f"flash vs plain, {FA_GRANITE} float32 causal={causal}"
        before = LAUNCHES["flash_attention_simt"]
        got = flash_attention(q, k, v, causal=causal)
        if LAUNCHES["flash_attention_simt"] != before + 1:
            fail(f"{what}: not launched on flash_attention_simt")
        err = close(what, got, fa_plain(q, k, v, causal),
                    FA_TOL[torch.float32])
        del got
        flops = fa_flops(B, S, H, hd, causal)
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), reps=5)
        out["causal" if causal else "full"] = dict(
            ms=ms, tflops=flops / ms / 1e9, max_abs_err=err,
            plain_ms=cuda_ms(lambda: fa_plain(q, k, v, causal), reps=2,
                             warmup=1),
            library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                            enable_gqa=True), reps=5),
            bound_ms=max(flops / FP32_FLOPS_PER_S,
                         nbytes / HBM_BYTES_PER_S) * 1e3,
            bound_by=("operations" if flops / FP32_FLOPS_PER_S
                      >= nbytes / HBM_BYTES_PER_S else "bytes"))
        torch.cuda.empty_cache()
    say("flash attention fp32 at granite's layer shape:", json.dumps(out))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def fp32_checks() -> None:
    """granite-20b at full width, two layers, fp32 on the card: forward
    with the kernel against forward with the torch-op attention (last
    position, 1e-3), and teacher-forced decode against forward (2e-3, the
    JAX package's test_decode_matches_forward tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.models import build_model

    cfg = get_config(LM_ARCH, n_layers=2, dtype="float32",
                     attn_impl="pallas")
    pallas = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = pallas.init(LM_SEED)
    gen = torch.Generator(device=CARD).manual_seed(LM_SEED + 1)
    toks = torch.randint(0, cfg.vocab, (FP32_BATCH, FP32_SEQ), generator=gen,
                         device=CARD)
    reset_launches()
    full, _ = pallas.forward(params, {"tokens": toks})
    torch.cuda.synchronize()
    say("fp32 2-layer forward, flash launches:", json.dumps(LAUNCHES))
    if LAUNCHES["flash_attention_simt"] != cfg.n_layers or \
            LAUNCHES["flash_attention"] != cfg.n_layers:
        fail(f"fp32 forward launched the flash kernel {dict(LAUNCHES)}, not "
             f"{cfg.n_layers} times on the CUDA-core body")
    ref, _ = xla.forward(params, {"tokens": toks})
    close("fp32 2-layer forward, pallas vs xla (last position)",
          full[:, -1], ref[:, -1], 1e-3)
    cache = pallas.init_cache(FP32_BATCH, FP32_SEQ)
    outs = []
    for t in range(FP32_SEQ):
        lg, cache = pallas.decode_step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    close(f"fp32 2-layer teacher-forced decode ({FP32_SEQ} steps) vs "
          f"forward", torch.stack(outs, 1), full, 2e-3)
    del params, cache, full, ref, outs
    torch.cuda.empty_cache()


def skip_attention(layer: int):
    """A faulty flash kernel, for a control: its call for ``layer``
    (counted from 0) returns zeros, every other call the kernel's output."""
    from repro_torch.kernels.flash_attention import flash_attention
    calls = []

    def fault(q, k, v, *, causal=True):
        calls.append(None)
        out = flash_attention(q, k, v, causal=causal)
        return torch.zeros_like(out) if len(calls) == layer + 1 else out
    return fault


def with_attention(fault, fn):
    """``fn()`` with ``fault`` in place of the flash kernel in the model."""
    from repro_torch.models import attention as att
    real, att.flash_attention = att.flash_attention, fault
    try:
        return fn()
    finally:
        att.flash_attention = real


def timed(fn):
    """(result, wall seconds, peak device bytes) of ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def greedy_steps(model, params, logits, first: int, steps: int) -> tuple:
    """``steps`` greedy decode steps from position ``first`` on a fresh
    cache (B = the prefill's batch), the first token the prefill's argmax:
    (the cache, wall seconds, peak bytes).  Fails on non-finite logits."""
    cache = model.init_cache(logits.shape[0], first + steps)
    tok = logits[:, -1:].argmax(-1)

    def decode():
        nonlocal cache, tok
        for pos in range(first, first + steps):
            lg, cache = model.decode_step(params, cache, tok, pos)
            if not torch.isfinite(lg.float()).all():
                fail(f"{model.cfg.name}: decode logits at position {pos} "
                     f"not finite")
            tok = lg[:, -1:].argmax(-1)
    _, wall, peak = timed(decode)
    return cache, wall, peak


def served(model, params, inputs: dict, gen: int) -> dict:
    """Greedy serving of ``inputs``' prompt (seamless: over its frames):
    the launch path's ``generate``, timed; fails on tokens outside the
    vocab."""
    from repro_torch.launch.serve import generate
    prompt = inputs["tokens"]
    (out, t), wall, peak = timed(lambda: generate(
        model, params, prompt, gen, enc_frames=inputs.get("enc_frames")))
    if out.shape != (prompt.shape[0], gen) or int(out.min()) < 0 or \
            int(out.max()) >= model.cfg.vocab:
        fail(f"{model.cfg.name}: serving gave tokens of shape "
             f"{tuple(out.shape)} outside [0, {model.cfg.vocab})")
    return dict(run="serve (prefill by stepping, greedy decode)",
                batch=prompt.shape[0], prompt=prompt.shape[1],
                generated=gen, wall_s=wall, encoder_s=t["encoder_s"],
                prompt_ms_per_step=t["prompt_s"] / t["prompt_steps"] * 1e3,
                decode_ms_per_step=t["gen_s"] / t["gen_steps"] * 1e3,
                peak_memory_bytes=peak, first_tokens=out[:, :4].tolist())


def lm_main_path() -> int:
    """granite-20b FULL, bf16, 52 layers, seeded weights: the serving
    prefill through the flash kernel (counts set to 0 just before, read
    just after), the same prefill through the torch-op attention, and
    greedy serving.  Returns the kernel's launches in the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell, make_inputs
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step

    cfg = get_config(LM_ARCH, attn_impl="pallas")
    model = build_model(cfg)
    params, init_s, _ = timed(lambda: model.init(LM_SEED))
    say(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.params_count():,} parameters (analytic), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
        f"initialised in {init_s:.1f} s")
    batch = make_inputs(cfg, ShapeCell("prefill", PREFILL_SEQ, PREFILL_BATCH,
                                       "prefill"), seed=LM_SEED)
    prefill = build_prefill_step(model)
    prefill(params, {"tokens": batch["tokens"][:1, :128]})   # warm-up
    reset_launches()
    before = torch.cuda.memory_allocated()
    logits, wall, peak = timed(lambda: prefill(params, batch))
    launches, by_body = LAUNCHES["flash_attention"], dict(LAUNCHES)
    tokens = PREFILL_BATCH * PREFILL_SEQ
    say("lm main path:", json.dumps(dict(
        run="prefill", attn_impl="pallas", batch=PREFILL_BATCH,
        seq=PREFILL_SEQ, wall_s=wall, prefill_tokens_per_s=tokens / wall,
        peak_memory_bytes=peak, flash_launches=by_body)))
    if launches != cfg.n_layers or \
            by_body["flash_attention_tc"] != cfg.n_layers:
        fail(f"prefill launched the flash kernel {by_body}, not "
             f"{cfg.n_layers} times on the tensor-core body")
    if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or \
            not torch.isfinite(logits.float()).all():
        fail(f"prefill logits {tuple(logits.shape)} not finite or not of "
             f"shape ({PREFILL_BATCH}, 1, {cfg.vocab})")
    DRYRUN["granite"] = dry_granite(model, params, batch, prefill, wall,
                                    peak, before)

    xla = build_prefill_step(build_model(
        dataclasses.replace(cfg, attn_impl="xla")))
    ref, wall_x, peak_x = timed(lambda: xla(params, batch))
    got, want = logits[:, 0].float(), ref[:, 0].float()
    gap = float((got - want).abs().max() / want.abs().max())
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    say("lm main path:", json.dumps(dict(
        run="prefill", attn_impl="xla (blockwise_attn)", wall_s=wall_x,
        prefill_tokens_per_s=tokens / wall_x, peak_memory_bytes=peak_x,
        pallas_vs_xla_rel_gap=gap, tolerance=LOGIT_GAP_TOL,
        argmax_agree=f"{agree}/{PREFILL_BATCH}")))
    if not gap <= LOGIT_GAP_TOL:
        fail(f"prefill logits, pallas vs xla: max |d| / max |ref| = {gap} "
             f"> {LOGIT_GAP_TOL}")
    skipped = cfg.n_layers // 2
    control, wall_c, _ = timed(lambda: with_attention(
        skip_attention(skipped), lambda: prefill(params, batch)))
    ctrl = control[:, 0].float()
    ctrl_gap = float((ctrl - want).abs().max() / want.abs().max())
    say("lm main path:", json.dumps(dict(
        run="prefill, control", fault=f"attention of layer {skipped} zero",
        wall_s=wall_c, control_vs_xla_rel_gap=ctrl_gap,
        tolerance=LOGIT_GAP_TOL,
        argmax_agree=f"{int((ctrl.argmax(-1) == want.argmax(-1)).sum())}"
                     f"/{PREFILL_BATCH}")))
    if not ctrl_gap > LOGIT_GAP_TOL:
        fail(f"the control prefill reads {ctrl_gap}, within the gate "
             f"{LOGIT_GAP_TOL}: the gate would not see that fault")
    del logits, ref, control

    inputs = make_inputs(cfg, ShapeCell("serve", SERVE_PROMPT, SERVE_BATCH,
                                        "prefill"), seed=LM_SEED)
    prompt = inputs["tokens"]
    say("lm main path:", json.dumps(served(model, params, inputs,
                                           SERVE_GEN)))

    # where the time goes: the prefill and eight serve steps, profiled
    say("profile:", json.dumps(dict(run="prefill, pallas", **device_profile(
        lambda: prefill(params, batch), {"flash": "flash_fwd"}))))
    say("profile:", json.dumps(dict(
        run="serve, 4 prompt + 4 decode steps", **device_profile(
            lambda: generate(model, params, prompt[:, :4], 5), {}))))
    del params, batch
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the MoE family: the routers, dbrx-132b, llama4-maverick, h2o-danube
# ---------------------------------------------------------------------------
MOE_ARCH = "dbrx-132b"
MOE_SEED = 0
ROUTER_CPU_TOKENS = 256            # the routers held card against CPU
DBRX_BATCH, DBRX_SEQ = FA_DBRX[:2]
DBRX_PROMPT, DBRX_GEN = 16, 16     # served: prompt stepped, tokens generated
DBRX_FREE_BYTES = 12e9             # left free after the weights are drawn
LLAMA4_ARCH = "llama4-maverick-400b-a17b"
DANUBE_ARCH = "h2o-danube-1.8b"
# (arch, layers or 0 for all, prefill length, first decode position, decode
# steps): each prefill is a multiple of blockwise_attn's 1024-row blocks
# (both packages require it above 2048 positions); each decode runs on a
# fresh cache from 4 positions before the window's end to 4 past it, so the
# ring wraps (the port, like the JAX package, has no cache-filling prefill,
# and stepping the whole prompt would take minutes)
WINDOW_RUNS = [(LLAMA4_ARCH, 1, 8192, 8188, 8),
               (DANUBE_ARCH, 0, 5120, 4092, 8)]
ROUTER_RANGE = "moe_router"        # the record_function around each route
# Gate of dbrx's bf16 prefill by layer, both prefills routed alike: the
# attention output's ||pallas - xla||_2 / ||xla||_2 in each layer.  Layer 0
# sees only the two attentions' roundings (K4's scaled check reads ~0.005 in
# this norm); each later layer also what the residual carries from the
# layers before it.  A control with one layer's attention zeroed reads 1 in
# that layer.  The script fails if a control does not exceed the gate.
LAYER_GAP_TOL = 5e-2


@contextlib.contextmanager
def spying(module, name: str, seen: list, pick=None, label: str = ""):
    """``module.name`` wrapped while the block runs: ``pick(arguments,
    result)`` of each call appended to ``seen``, and the call inside a
    ``record_function(label)`` range when ``label`` is given."""
    real = getattr(module, name)

    def spy(*args, **kw):
        with (torch.profiler.record_function(label) if label
              else contextlib.nullcontext()):
            out = real(*args, **kw)
        if pick is not None:
            seen.append(pick(args, out))
        return out
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def pinned_routing(module, routes: list):
    """``module.route_matching`` replaced while the block runs by the
    routes of an earlier run: its i-th call returns that run's i-th
    ``(assign, slot)`` and the combine probabilities of these logits for
    them."""
    from repro_torch.moe.matching_router import _combine_probs
    real, it = module.route_matching, iter(routes)

    def replay(logits, k, capacity, **kw):
        assign, slot = next(it)
        probs = torch.softmax(logits.float(), dim=-1)
        return assign, slot, _combine_probs(probs, assign, logits.shape[1])
    module.route_matching = replay
    try:
        yield
    finally:
        module.route_matching = real


@contextlib.contextmanager
def attention_outputs(pick):
    """While the block runs, ``pick(i, output)`` of the i-th attention call
    of the model (the flash kernel's or the torch-op attention's output,
    (B, S, H, hd), before the output projection), whichever of the two is
    in place when the block starts (a control's faulty kernel too)."""
    from repro_torch.models import attention as att
    calls = []

    def each(args, out):
        calls.append(None)
        return pick(len(calls) - 1, out)
    with spying(att, "flash_attention", [], each), \
            spying(att, "_plain_attn", [], each):
        yield


def rel_l2(got, want) -> float:
    """||got - want||_2 / ||want||_2, in fp32."""
    want = want.float()
    return float(torch.linalg.vector_norm(got.float() - want)
                 / torch.linalg.vector_norm(want))


def param_bytes(cfg) -> tuple:
    """(embedding + head bytes, bytes a layer) of an attention + MoE
    config: the layer's leaves in the model dtype, its norms and router in
    fp32."""
    D, F_, E, V = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    item = cfg.tdtype.itemsize
    attn = D * hd * (H + 2 * KV) + H * hd * D
    experts = (3 if cfg.act in ("swiglu", "geglu") else 2) * E * D * F_
    shared = 3 * D * F_ if cfg.moe_shared_expert else 0
    layer = (attn + experts + shared) * item + (2 * D + D * E) * 4
    return 2 * V * D * item + D * 4, layer


def check_routing(name, assign, slot, E, C) -> None:
    """Fail unless the routing is feasible: loads <= C, (expert, slot)
    unique, no expert twice in a token."""
    live = assign >= 0
    loads = torch.zeros(E + 1, dtype=torch.int64, device=assign.device)
    loads.scatter_add_(0, torch.where(live, assign, E).long().reshape(-1),
                       torch.ones(assign.numel(), dtype=torch.int64,
                                  device=assign.device))
    pairs = (assign.long() * C + slot)[live]
    a = assign.sort(dim=1).values
    dup = ((a[:, 1:] == a[:, :-1]) & (a[:, 1:] >= 0)).any()
    if int(loads[:E].max()) > C or pairs.unique().numel() != pairs.numel() \
            or bool(dup):
        fail(f"{name}: infeasible routing (max load {int(loads[:E].max())}"
             f" of {C}, {pairs.numel() - pairs.unique().numel()} slot "
             f"collisions, duplicate expert in a token: {bool(dup)})")


def router_logits(cfg, tokens) -> torch.Tensor:
    """Layer 0's router logits of ``cfg``'s seeded model on ``tokens``
    (one layer drawn: layer 0 is the same in the deeper model, whose
    generator draws the embedding and then layer 0 first)."""
    from repro_torch.models import build_model
    from repro_torch.models import moe

    model = build_model(dataclasses.replace(cfg, n_layers=1))
    params = model.init(MOE_SEED)
    with spying(moe, "route_matching", [], lambda a, o: a[0]) as seen:
        model.forward(params, {"tokens": tokens}, last_only=True)
    del params
    torch.cuda.empty_cache()
    return seen[0]


def gadget_cardinality(cxadj, cadj, nc: int, nr: int) -> tuple:
    """Worker process: the maximum cardinality of a CSR graph by scipy
    (independent of the code under test), and its seconds."""
    import numpy as np
    import scipy.sparse
    from scipy.sparse.csgraph import maximum_bipartite_matching
    t0 = time.perf_counter()
    a = scipy.sparse.csr_matrix((np.ones(len(cadj), np.int8), cadj, cxadj),
                                shape=(nc, nr))
    got = int((maximum_bipartite_matching(a, perm_type="column") >= 0).sum())
    return got, time.perf_counter() - t0


def route_levels_checked(g, captured, levels: int) -> int:
    """The exact route's solve of its gadget graph ``g`` again, uncaptured
    on the card: the steps of its compile-cache entry (the cheap warm
    start, then ``MatcherConfig()``'s solve) run one by one from the host,
    every K1a launch held against the kernel's plain version on the same
    inputs, bit for bit.  Fails unless it ran the ``levels`` levels of the
    captured run ``captured`` and ended in its matching.  Returns the
    levels checked."""
    from repro_torch.kernels.frontier_expand import frontier_expand_fused_ref
    from repro_torch.matching import MatcherConfig, solve
    from repro_torch.matching.warmstart import stages

    real, checked = solve.frontier_expand_fused, []

    def held(*args):
        got = real(*args)
        if not torch.equal(got, frontier_expand_fused_ref(*args)):
            fail(f"K1a differs from its plain version at level "
                 f"{int(args[5])} of the exact route's solve")
        checked.append(None)
        return got
    prog = solve.MatcherProgram(g.nc, g.nr, g.nnz_pad, MatcherConfig(),
                                stages("cheap"))
    prog.program(g.device).capture = False
    solve.frontier_expand_fused = held
    try:
        state = prog(g)
    finally:
        solve.frontier_expand_fused = real
    if len(checked) != levels or not torch.equal(
            state.cmatch, captured.cmatch) or not torch.equal(
            state.rmatch, captured.rmatch):
        fail(f"the exact route's solve run uncaptured: {len(checked)} "
             f"levels (captured: {levels}), matching equal to the captured "
             f"run's: {torch.equal(state.cmatch, captured.cmatch)}")
    return len(checked)


def router_phase(cfg, pool) -> tuple:
    """The three routers on dbrx's layer-0 router logits of one prefill
    sequence: feasible, the exact router certified and dropping no more
    than the other two, timed; the first ROUTER_CPU_TOKENS tokens also on
    the CPU, bit for bit; K1a against its plain version at every level of
    the exact route's solve (:func:`route_levels_checked`).  scipy's cardinality of the gadget graph is
    left to a worker of ``pool``.  Returns (K1a's launches in one exact
    route, the levels it was checked at, the matcher's cardinality, the
    worker's future)."""
    from repro_torch.configs.shapes import ShapeCell, make_inputs
    from repro_torch.kernels.frontier_expand import LAUNCHES, reset_launches
    from repro_torch.matching import (Matcher, MatcherConfig,
                                      compile_cache_clear)
    from repro_torch.models.moe import capacity_for
    from repro_torch.moe import (route_matching, route_matching_exact,
                                 route_topk, router_stats)
    from repro_torch.moe.matching_router import _gadget_graph, _top

    tokens = make_inputs(cfg, ShapeCell("prefill", DBRX_SEQ, DBRX_BATCH,
                                        "prefill"), seed=MOE_SEED)["tokens"]
    logits = router_logits(cfg, tokens[:1])
    T, E = logits.shape
    k, m = cfg.top_k, min(E, cfg.top_k + 2)
    C = capacity_for(cfg, T)
    routers = {"topk": route_topk, "matching": route_matching,
               "exact": route_matching_exact}
    row = dict(tokens=T, experts=E, top_k=k, candidates=m, capacity=C)

    g = _gadget_graph(_top(logits, m), k, E, C)
    row["gadget"] = dict(nc=g.nc, nr=g.nr, nnz=g.nnz)
    say("router gadget graph:", json.dumps(row["gadget"]))
    scipy_check = pool.submit(gadget_cardinality, g.cxadj.cpu().numpy(),
                              g.cadj.cpu().numpy(), g.nc, g.nr)
    matcher = Matcher(MatcherConfig(), warm_start="cheap")
    state = matcher.run(g)
    got = int(state.cardinality)
    row.update(cardinality=got, certified=bool(state.certified),
               solver_counts=matcher.last_counts)
    if not state.certified:
        fail("exact router's matching: not certified")
    levels = route_levels_checked(g, state, row["solver_counts"]["levels"])
    row["k1a_levels_checked"] = levels
    del g, state

    reset_launches()
    torch.cuda.synchronize()
    out = {"exact": route_matching_exact(logits, k, C)}
    torch.cuda.synchronize()
    launches = LAUNCHES["frontier_expand_fused_wr"]
    row["k1a_launches_one_exact_route"] = launches
    if not launches:
        fail("the exact router did not launch the fused frontier kernel")
    out["topk"] = route_topk(logits, k, C)
    out["matching"] = route_matching(logits, k, C)
    drops = {}
    for name, fn in routers.items():
        check_routing(f"router {name}", out[name][0], out[name][1], E, C)
        drops[name] = float(router_stats(out[name][0], k)["drop_rate"])
        row[f"{name}_ms"] = cuda_ms(lambda: fn(logits, k, C),
                                    reps=3 if name == "exact" else 10,
                                    warmup=1)
    row["drop_rate"] = drops
    if drops["exact"] > min(drops["topk"], drops["matching"]) + 1e-9:
        fail(f"the exact router drops more than another: {drops}")

    # the first tokens on the CPU, the plain versions, bit for bit
    Tc = ROUTER_CPU_TOKENS
    Cc = capacity_for(cfg, Tc)
    row["cpu_check"] = dict(tokens=Tc, capacity=Cc, gadget_nnz=Tc * m * (
        k + 1 + Cc))
    for name, fn in routers.items():
        card = fn(logits[:Tc], k, Cc)
        cpu = fn(logits[:Tc].cpu(), k, Cc)
        same = all(torch.equal(x.cpu(), y) for x, y in zip(card[:2], cpu[:2]))
        perr = float((card[2].cpu() - cpu[2]).abs().max())
        row["cpu_check"][name] = dict(assign_slot_equal=same, p_max_abs=perr)
        if not same or not perr <= 1e-6:
            fail(f"router {name} at T={Tc}: card and CPU differ (assign "
                 f"and slot equal: {same}, p max |d| {perr})")
    say("routers:", json.dumps(row))
    del logits, out
    compile_cache_clear()
    torch.cuda.empty_cache()
    return launches, row["k1a_levels_checked"], got, scipy_check


def moe_fp32_checks(cfg) -> None:
    """dbrx-132b at full width, two layers, fp32 on the card: the forward
    with K4 (on the CUDA-core body, once a layer) against the torch-op
    attention (1e-3), and teacher-forced decode against the forward (2e-3,
    the JAX package's test_decode_matches_forward tolerance) with
    ``capacity_factor = n_experts / top_k``.  Only with that override can
    no token drop: otherwise the capacity depends on the token count,
    which differs between the forward (B*S tokens) and a decode step (B
    tokens), so decode does not equal the forward for an MoE in either
    package."""
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.models import build_model

    cfg = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    pallas = build_model(cfg)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    params = pallas.init(MOE_SEED)
    gen = torch.Generator(device=CARD).manual_seed(MOE_SEED + 1)
    toks = torch.randint(0, cfg.vocab, (FP32_BATCH, FP32_SEQ), generator=gen,
                         device=CARD)
    reset_launches()
    full, _ = pallas.forward(params, {"tokens": toks})
    torch.cuda.synchronize()
    say(f"{cfg.name} fp32 2-layer forward, flash launches:",
        json.dumps(LAUNCHES))
    if LAUNCHES["flash_attention_simt"] != cfg.n_layers or \
            LAUNCHES["flash_attention"] != cfg.n_layers:
        fail(f"fp32 forward launched the flash kernel {dict(LAUNCHES)}, not "
             f"{cfg.n_layers} times on the CUDA-core body")
    ref, _ = xla.forward(params, {"tokens": toks})
    close(f"{cfg.name} fp32 2-layer forward, pallas vs xla", full, ref, 1e-3)
    nodrop = build_model(dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k))
    full, _ = nodrop.forward(params, {"tokens": toks})
    cache = nodrop.init_cache(FP32_BATCH, FP32_SEQ)
    outs = []
    for t in range(FP32_SEQ):
        lg, cache = nodrop.decode_step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    close(f"{cfg.name} fp32 2-layer teacher-forced decode ({FP32_SEQ} "
          f"steps, capacity_factor {nodrop.cfg.capacity_factor}) vs forward",
          torch.stack(outs, 1), full, 2e-3)
    del params, cache, full, ref, outs
    torch.cuda.empty_cache()


def moe_main_path(cfg) -> int:
    """dbrx-132b at full width, bf16, as many layers as leave
    DBRX_FREE_BYTES free, seeded weights: the serving prefill through K4
    (counts set to 0 just before, read just after), each layer's drop rate
    and load-balance loss, the same prefill through the torch-op attention
    (free-running: its gap and the router assignments that differ printed;
    routed as the kernel's run: the logits within LOGIT_GAP_TOL and each
    layer's attention output within LAYER_GAP_TOL) and with layer 0's or
    the middle layer's attention zeroed under that routing (controls that
    must exceed the per-layer gate, layer 0's also the logits gate), greedy
    serving, and the router's share of device time in the prefill and in
    serve steps.  Returns K4's launches in the prefill."""
    from repro_torch.configs.shapes import ShapeCell, make_inputs
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models import moe
    from repro_torch.train import build_prefill_step

    emb, layer = param_bytes(cfg)
    # left free after the weights: DBRX_FREE_BYTES, and at least what
    # drawing the last layer holds beside the stack (that layer, and its
    # largest leaf's fp32 draw and bf16 copy)
    margin = max(DBRX_FREE_BYTES,
                 layer + 6 * cfg.n_experts * cfg.d_model * cfg.d_ff)
    free = torch.cuda.mem_get_info()[0]
    depth = min(cfg.n_layers, int((free - margin - emb) // layer))
    if depth < 1:
        fail(f"{cfg.name}: {free / 1e9:.1f} GB free holds no layer")
    cfg = dataclasses.replace(cfg, n_layers=depth)
    model = build_model(cfg)
    params, init_s, _ = timed(lambda: model.init(MOE_SEED))
    say(f"{cfg.name}: {depth} of 40 layers (reduced: n_layers 40 -> "
        f"{depth}; {layer / 1e9:.2f} GB a layer, {emb / 1e9:.2f} GB "
        f"embeddings, {free / 1e9:.1f} GB free before, "
        f"{margin / 1e9:.2f} GB kept free), "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
        f"{torch.cuda.mem_get_info()[0] / 1e9:.1f} GB free, initialised in "
        f"{init_s:.1f} s")
    batch = make_inputs(cfg, ShapeCell("prefill", DBRX_SEQ, DBRX_BATCH,
                                       "prefill"), seed=MOE_SEED)
    prefill = build_prefill_step(model)
    prefill(params, {"tokens": batch["tokens"][:1, :128]})   # warm-up
    aux, routed = [], []
    reset_launches()
    with spying(moe, "moe_ffn", aux, lambda a, o: o[1]), \
            spying(moe, "route_matching", routed, lambda a, o: o[:2]):
        logits, wall, peak = timed(lambda: prefill(params, batch))
    launches, by_body = LAUNCHES["flash_attention"], dict(LAUNCHES)
    tokens = DBRX_BATCH * DBRX_SEQ
    layers = [dict(drop_rate=float(a["drop_rate"]),
                   lb_loss=float(a["lb_loss"])) for a in aux]
    say("moe main path:", json.dumps(dict(
        run="prefill", arch=cfg.name, n_layers=depth, attn_impl="pallas",
        batch=DBRX_BATCH, seq=DBRX_SEQ, wall_s=wall,
        prefill_tokens_per_s=tokens / wall, peak_memory_bytes=peak,
        flash_launches=by_body, layers=layers)))
    if launches != depth or by_body["flash_attention_tc"] != depth:
        fail(f"prefill launched the flash kernel {by_body}, not {depth} "
             f"times on the tensor-core body")
    if len(layers) != depth or len(routed) != depth:
        fail(f"{len(layers)} MoE layers and {len(routed)} routes ran, not "
             f"{depth}")
    if logits.shape != (DBRX_BATCH, 1, cfg.vocab) or \
            not torch.isfinite(logits.float()).all():
        fail(f"prefill logits {tuple(logits.shape)} not finite or not of "
             f"shape ({DBRX_BATCH}, 1, {cfg.vocab})")

    # The gates.  In bf16 the two attentions round differently (a few
    # ulps), which moves the router's fp32 logits by ~1 % at layer 0, whose
    # MoE input the attention alone sets, and flips near-ties; a flipped
    # token changes the matching router's cascade for others, and the flips
    # compound layer by layer (on an H100 at 10 layers: 458 of 32,768
    # assignments at layer 0, 9,140 at layer 9; logits 0.274 apart).  So
    # the free-running xla prefill's gap and flips are printed, and the
    # gates hold the attentions under one routing: the xla prefill with
    # every layer routed as the kernel's run routed it (pinned_routing).
    # Two gates: the last-position logits (LOGIT_GAP_TOL, as granite's) and
    # each layer's attention output (LAYER_GAP_TOL), which sees a fault in
    # any layer, where the logits see only layer 0's (below).
    xla = build_prefill_step(build_model(
        dataclasses.replace(cfg, attn_impl="xla")))
    routed_x = []
    with spying(moe, "route_matching", routed_x, lambda a, o: o[0]):
        free, wall_x, peak_x = timed(lambda: xla(params, batch))
    flips = [int((a != b).sum()) for (a, _), b in zip(routed, routed_x)]
    flipped = [int((a != b).any(1).sum())
               for (a, _), b in zip(routed, routed_x)]
    del routed_x
    free_gap = float((logits[:, 0].float() - free[:, 0].float()).abs().max()
                     / free[:, 0].float().abs().max())
    del free, logits
    want_attn = []
    with pinned_routing(moe, routed), \
            attention_outputs(lambda i, o: want_attn.append(o)):
        ref = xla(params, batch)
    want = ref[:, 0].float()
    del ref
    if len(want_attn) != depth:
        fail(f"the xla prefill made {len(want_attn)} attention calls, not "
             f"{depth}")

    def pinned_prefill(fault=None):
        """(last-position logits, per-layer attention gaps) of the kernel's
        prefill routed as its first run, ``fault`` in place of the kernel
        when given."""
        gaps = []

        def run():
            with attention_outputs(lambda i, o: gaps.append(
                    rel_l2(o, want_attn[i]))):
                return prefill(params, batch)
        with pinned_routing(moe, routed):
            out = with_attention(fault, run) if fault else run()
        got = out[:, 0].float()
        return got, float((got - want).abs().max() / want.abs().max()), gaps

    got, gap, gaps = pinned_prefill()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    say("moe main path:", json.dumps(dict(
        run="prefill", attn_impl="xla (_plain_attn)", wall_s=wall_x,
        prefill_tokens_per_s=tokens / wall_x, peak_memory_bytes=peak_x,
        free_running=dict(
            pallas_vs_xla_rel_gap=free_gap,
            router_assignments_differing_by_layer=flips,
            tokens_routed_differently_by_layer=flipped,
            assignments_per_layer=tokens * cfg.top_k),
        pinned_routing=dict(pallas_vs_xla_rel_gap=gap,
                            tolerance=LOGIT_GAP_TOL,
                            argmax_agree=f"{agree}/{DBRX_BATCH}",
                            attention_rel_l2_by_layer=gaps,
                            layer_tolerance=LAYER_GAP_TOL))))
    if not gap <= LOGIT_GAP_TOL:
        fail(f"prefill logits, pallas vs xla (one routing): max |d| / max "
             f"|ref| = {gap} > {LOGIT_GAP_TOL}")
    if len(gaps) != depth or not max(gaps) <= LAYER_GAP_TOL:
        fail(f"attention outputs, pallas vs xla (one routing), by layer: "
             f"{gaps}, not {depth} within {LAYER_GAP_TOL}")
    # Controls, under the same routing: one layer's attention zero, layer
    # 0's and the middle layer's; each must fail the per-layer gate.  The
    # logits gate must see layer 0's.  From layer 1 on, a layer's attention
    # output (~1-10) is small beside the MoE outputs the residual carries
    # (~1e3-1e4: dense_init draws the expert weights with fan_in = E, std
    # 1/4), so the logits gate does not see the middle layer's zeroed (its
    # reading is printed).
    for skipped in (0, depth // 2):
        t0 = time.perf_counter()
        ctrl, ctrl_gap, ctrl_gaps = pinned_prefill(skip_attention(skipped))
        say("moe main path:", json.dumps(dict(
            run="prefill, control, one routing",
            fault=f"attention of layer {skipped} zero",
            logits_gated=skipped == 0, wall_s=time.perf_counter() - t0,
            control_vs_xla_rel_gap=ctrl_gap, tolerance=LOGIT_GAP_TOL,
            argmax_agree=f"{int((ctrl.argmax(-1) == want.argmax(-1)).sum())}"
                         f"/{DBRX_BATCH}",
            attention_rel_l2_by_layer=ctrl_gaps,
            layer_tolerance=LAYER_GAP_TOL)))
        if skipped == 0 and not ctrl_gap > LOGIT_GAP_TOL:
            fail(f"the control prefill reads {ctrl_gap}, within the gate "
                 f"{LOGIT_GAP_TOL}: the gate would not see that fault")
        if not max(ctrl_gaps) > LAYER_GAP_TOL:
            fail(f"the control prefill's attention gaps {ctrl_gaps} are "
                 f"within {LAYER_GAP_TOL}: the per-layer gate would not see "
                 f"that fault")
    del routed, want_attn, want, got

    inputs = make_inputs(cfg, ShapeCell("serve", DBRX_PROMPT, DBRX_BATCH,
                                        "prefill"), seed=MOE_SEED)
    prompt = inputs["tokens"]
    say("moe main path:", json.dumps(served(model, params, inputs,
                                            DBRX_GEN)))

    # where the time goes, the router's share of device time included
    with spying(moe, "route_matching", [], label=ROUTER_RANGE):
        say("profile:", json.dumps(dict(
            run=f"{cfg.name} prefill, pallas", **device_profile(
                lambda: prefill(params, batch), {"flash": "flash_fwd"},
                ranges=(ROUTER_RANGE,)))))
        say("profile:", json.dumps(dict(
            run=f"{cfg.name} serve, 1 prompt + 1 decode step",
            **device_profile(lambda: generate(model, params, prompt[:, :1],
                                              2), {},
                             ranges=(ROUTER_RANGE,)))))
    del params, batch
    torch.cuda.empty_cache()
    return launches


def window_run(arch, n_layers, seq, first, steps) -> None:
    """A sliding-window or chunked config at full width, bf16, seeded
    weights (``n_layers`` of them, 0 for all): a B=1 prefill of ``seq``
    tokens, then ``steps`` greedy decode steps from position ``first`` on a
    fresh ring cache, across the window's end.  Gate: finite logits, the
    ring's positions as the wrap leaves them."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell, make_inputs
    from repro_torch.models import build_model
    from repro_torch.models import moe
    from repro_torch.train import build_prefill_step

    cfg = get_config(arch)
    reduced = {}
    if n_layers and n_layers != cfg.n_layers:
        reduced = {"n_layers": [cfg.n_layers, n_layers]}
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    params, init_s, _ = timed(lambda: model.init(MOE_SEED))
    tokens = make_inputs(cfg, ShapeCell("prefill", seq, 1, "prefill"),
                         seed=MOE_SEED)["tokens"]
    prefill = build_prefill_step(model)
    prefill(params, {"tokens": tokens[:, :128]})            # warm-up
    aux = []
    with spying(moe, "moe_ffn", aux, lambda a, o: o[1]["drop_rate"]):
        logits, wall, peak = timed(lambda: prefill(params,
                                                   {"tokens": tokens}))
    if not torch.isfinite(logits.float()).all():
        fail(f"{cfg.name}: prefill logits not finite")
    cache, wall_d, peak_d = greedy_steps(model, params, logits, first, steps)
    ring = cache["k"].shape[2]
    idx = cache["idx"]
    held = sorted(int(i) for i in idx[idx >= 0].tolist())
    if held != list(range(first, first + steps)):
        fail(f"{cfg.name}: the ring holds positions {held}")
    say("window run:", json.dumps(dict(
        arch=cfg.name, attn=cfg.attn, window=cfg.window, ring=ring,
        reduced=reduced, init_s=init_s, prefill_seq=seq,
        prefill_wall_s=wall, prefill_tokens_per_s=seq / wall,
        prefill_peak_memory_bytes=peak,
        drop_rate=[float(d) for d in aux],
        decode_positions=[first, first + steps - 1],
        ring_slots=[first % ring, (first + steps - 1) % ring],
        decode_ms_per_step=wall_d / steps * 1e3,
        decode_peak_memory_bytes=peak_d)))
    del params, cache, logits
    torch.cuda.empty_cache()


def moe_phases() -> tuple:
    """Phases 10-14: the routers, dbrx-132b in fp32 and at full width in
    bf16, llama4-maverick and h2o-danube past their windows.  Returns
    (K1a's launches in one exact route, the levels K1a was checked at on
    its gadget graph, K4's launches in dbrx's prefill)."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH, attn_impl="pallas")
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        t0 = time.perf_counter()
        k1a, k1a_levels, got, scipy_check = router_phase(cfg, pool)
        phase("routers", t0)
        t0 = time.perf_counter()
        moe_fp32_checks(cfg)
        phase("moe fp32 two-layer checks", t0)
        t0 = time.perf_counter()
        k4 = moe_main_path(cfg)
        phase("moe main path", t0)
        for run in WINDOW_RUNS:
            t0 = time.perf_counter()
            window_run(*run)
            phase(f"{run[0]} past its window", t0)
        want, scipy_s = scipy_check.result()
    finally:
        pool.shutdown(cancel_futures=True)
    say("router gadget graph:", json.dumps(dict(
        cardinality=got, scipy_cardinality=want, scipy_s=scipy_s)))
    if got != want:
        fail(f"exact router's matching: cardinality {got}, scipy {want}")
    return k1a, k1a_levels, k4


# ---------------------------------------------------------------------------
# the SSM, hybrid, enc-dec and vision-prefix families
# ---------------------------------------------------------------------------
FAMILY_SEED = 0
MAMBA_ARCH, ZAMBA_ARCH = "mamba2-2.7b", "zamba2-7b"
SEAMLESS_ARCH, PALI_ARCH = "seamless-m4t-medium", "paligemma-3b"
# mamba2: the prefill (B, S: 16 chunks of 256, so the loop over chunks
# carries the state 15 times) and greedy serving (batch, prompt stepped,
# tokens generated)
MAMBA_PREFILL = (4, 4096)
MAMBA_SERVE = (4, 64, 16)
# zamba2: a prefill past the shared block's 4096 window (blockwise_attn
# under the swa mask), then decode steps from 4 positions before the
# window's end on a fresh cache, so the shared block's rings wrap
ZAMBA_PREFILL = (1, 8192)
ZAMBA_DECODE = (4092, 8)
# the fp32 gates at full width: teacher-forced decode against the forward
# over (batch, sequence), two SSD chunks, in models cut to these overrides
STATE_CHECK = (2, 512)
STATE_CHECK_CUTS = {MAMBA_ARCH: dict(n_layers=2),
                    ZAMBA_ARCH: dict(n_layers=4, shared_every=2)}
# seamless: the prefill (B, S tokens; frames (B, max(1024, S // 4), D)),
# its self-attention's shape (K4: the encoder's full mask, the decoder's
# causal one), serving (batch, prompt stepped, tokens generated), and the
# fp32 gates' cut: two encoder and two decoder layers
SEAMLESS_PREFILL = (4, 1024)
FA_SEAMLESS = (4, 1024, 16, 16, 64)
SEAMLESS_SERVE = (4, 16, 16)
SEAMLESS_CHECK_CUTS = dict(n_layers=2, enc_layers=2)
# paligemma: the prefill (B, S = 256 patches + 3840 tokens; the prefix
# mask through blockwise_attn), decode steps after it on a fresh cache,
# and the fp32 gate (B, S) of blockwise_attn against _plain_attn
PALI_PREFILL = (2, 4096)
PALI_DECODE_STEPS = 8
PALI_CHECK = (1, 4096)
PALI_CHECK_CUTS = dict(n_layers=2)


def full_model(arch, **overrides):
    """(config, model, params) of ``arch`` at full width, the weights drawn
    on the card from FAMILY_SEED."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch, **overrides)
    model = build_model(cfg)
    params, init_s, _ = timed(lambda: model.init(FAMILY_SEED))
    say(f"{cfg.name}: {cfg.n_layers} layers"
        + (f" + {cfg.enc_layers} encoder layers" if cfg.enc_layers else "")
        + f", d_model {cfg.d_model}, {cfg.dtype}"
        + (f" (overrides: {json.dumps(overrides)})" if overrides else "")
        + f", {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
        f"initialised in {init_s:.1f} s")
    return cfg, model, params


def family_inputs(cfg, batch: int, seq: int) -> dict:
    """``make_inputs`` of a prefill of ``seq`` positions, drawn on the card
    from FAMILY_SEED."""
    from repro_torch.configs.shapes import ShapeCell, make_inputs
    return make_inputs(cfg, ShapeCell("prefill", seq, batch, "prefill"),
                       seed=FAMILY_SEED)


def last_logits(cfg, logits, batch: int, what: str) -> torch.Tensor:
    """Fail unless the prefill's logits are finite, of shape (batch, 1,
    padded vocab), with -1e30 past the vocab; returns the vocab's
    columns."""
    from repro_torch.models.transformer import vocab_padded
    Vp = vocab_padded(cfg)
    if logits.shape != (batch, 1, Vp) or \
            not torch.isfinite(logits.float()).all():
        fail(f"{what}: prefill logits {tuple(logits.shape)} not finite or "
             f"not of shape ({batch}, 1, {Vp})")
    if Vp != cfg.vocab and not bool((logits[..., cfg.vocab:] == -1e30).all()):
        fail(f"{what}: the padded vocab's columns are not -1e30")
    return logits[..., :cfg.vocab]


def logit_gap(got, want) -> float:
    """max |got - want| / max |want| of (B, 1, vocab) logits, in fp32."""
    got, want = got[:, 0].float(), want[:, 0].float()
    return float((got - want).abs().max() / want.abs().max())


def decode_against_forward(model, params, batch, what: str) -> dict:
    """Teacher-forced ``decode_step`` over the batch's tokens against
    ``forward``'s logits at every position (2e-3, the JAX package's
    test_decode_matches_forward tolerance); an enc-dec model decodes over
    ``prefill_encoder``'s cache of the same frames.  Returns the cache."""
    toks = batch["tokens"]
    B, S = toks.shape
    full, _ = model.forward(params, batch)
    frames = batch.get("enc_frames")
    cache = model.init_cache(B, S,
                             enc_len=0 if frames is None else frames.shape[1])
    if frames is not None:
        cache = model.prefill_encoder(params, cache, batch)
    outs = []
    for t in range(S):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    close(f"{what}: teacher-forced decode ({S} steps) vs forward",
          torch.stack(outs, 1), full, 2e-3)
    del full, outs
    return cache


def mamba_phase() -> None:
    """mamba2-2.7b FULL (64 mamba blocks), bf16: the prefill B=4 x 4096
    (16 SSD chunks), greedy serving; then two layers in fp32 at full
    width, decode stepped over two chunks against the forward's logits at
    every position."""
    from repro_torch.models.ssm import CHUNK
    from repro_torch.train import build_prefill_step

    cfg, model, params = full_model(MAMBA_ARCH)
    B, S = MAMBA_PREFILL
    batch = family_inputs(cfg, B, S)
    prefill = build_prefill_step(model)
    prefill(params, {"tokens": batch["tokens"][:1, :CHUNK]})   # warm-up
    logits, wall, peak = timed(lambda: prefill(params, batch))
    last_logits(cfg, logits, B, cfg.name)
    say("family:", json.dumps(dict(
        arch=cfg.name, run="prefill", batch=B, seq=S, chunks=S // CHUNK,
        reduced={}, wall_s=wall, prefill_tokens_per_s=B * S / wall,
        peak_memory_bytes=peak)))
    bs, prompt, gen = MAMBA_SERVE
    say("family:", json.dumps(dict(arch=cfg.name, **served(
        model, params, family_inputs(cfg, bs, prompt), gen))))
    say("profile:", json.dumps(dict(
        arch=cfg.name, run="prefill",
        **device_profile(lambda: prefill(params, batch), {}))))
    del params, batch, logits
    torch.cuda.empty_cache()

    cfg, model, params = full_model(MAMBA_ARCH, dtype="float32",
                                    **STATE_CHECK_CUTS[MAMBA_ARCH])
    B, S = STATE_CHECK
    decode_against_forward(model, params, family_inputs(cfg, B, S),
                           f"{cfg.name} fp32 two layers")
    del params
    torch.cuda.empty_cache()


def zamba_phase() -> None:
    """zamba2-7b FULL (81 mamba blocks, the shared block after every 14th:
    5 invocations), bf16: the prefill B=1 x 8192 (the shared block through
    blockwise_attn under its 4096 window), greedy decode steps across the
    window's end on a fresh cache; then four layers in fp32 at full width
    with the shared block after every second (two invocations, each with
    its own KV slice), decode against the forward."""
    from repro_torch.models import attention as att
    from repro_torch.models.ssm import CHUNK
    from repro_torch.train import build_prefill_step

    cfg, model, params = full_model(ZAMBA_ARCH)
    B, S = ZAMBA_PREFILL
    batch = family_inputs(cfg, B, S)
    prefill = build_prefill_step(model)
    prefill(params, {"tokens": batch["tokens"][:, :CHUNK]})    # warm-up
    n_inv = cfg.n_layers // cfg.shared_every
    masks = []
    with spying(att, "blockwise_attn", masks, lambda a, o: a[5]):
        logits, wall, peak = timed(lambda: prefill(params, batch))
    if masks != ["swa"] * n_inv:
        fail(f"{cfg.name}: the prefill ran blockwise_attn under {masks}, "
             f"not {n_inv} times under swa")
    lg = last_logits(cfg, logits, B, cfg.name)
    first, steps = ZAMBA_DECODE
    cache, wall_d, peak_d = greedy_steps(model, params, lg, first, steps)
    kv = cache["shared_kv"]
    idx = kv["idx"]
    held = sorted(int(i) for i in idx[idx >= 0].tolist())
    ring = kv["k"].shape[2]
    if held != list(range(first, first + steps)) or \
            kv["k"].shape[0] != n_inv or ring != cfg.window:
        fail(f"{cfg.name}: the shared block's rings {tuple(kv['k'].shape)} "
             f"hold positions {held}")
    say("family:", json.dumps(dict(
        arch=cfg.name, run="prefill, then decode past the window",
        reduced={}, window=cfg.window, shared_invocations=n_inv,
        blockwise_masks=masks, prefill_seq=S, prefill_wall_s=wall,
        prefill_tokens_per_s=B * S / wall, prefill_peak_memory_bytes=peak,
        decode_positions=[first, first + steps - 1],
        ring_slots=[first % ring, (first + steps - 1) % ring],
        decode_ms_per_step=wall_d / steps * 1e3,
        decode_peak_memory_bytes=peak_d)))
    say("profile:", json.dumps(dict(
        arch=cfg.name, run="prefill",
        **device_profile(lambda: prefill(params, batch), {}))))
    del params, batch, logits, cache, kv
    torch.cuda.empty_cache()

    cfg, model, params = full_model(ZAMBA_ARCH, dtype="float32",
                                    **STATE_CHECK_CUTS[ZAMBA_ARCH])
    B, S = STATE_CHECK
    cache = decode_against_forward(model, params, family_inputs(cfg, B, S),
                                   f"{cfg.name} fp32 four layers")
    k = cache["shared_kv"]["k"]
    if k.shape[0] != 2 or torch.equal(k[0], k[1]):
        fail(f"{cfg.name} fp32: the two invocations do not keep KV slices "
             f"of their own")
    del params, cache, k
    torch.cuda.empty_cache()


def seamless_phase(gen) -> tuple:
    """seamless-m4t-medium FULL (12 encoder + 12 decoder layers, hd 64),
    bf16: K4 at its layer shape timed; the prefill B=4 x 1024 with frames
    (4, 1024, 1024) through K4 (counts set to 0 just before, read just
    after: 12 full launches on the tensor-core body, 12 causal), each of
    one prefill's launches against its plain version, the same prefill
    through the torch-op attention (the logits and each attention output
    gated) and with encoder layer 0's or the middle decoder layer's
    self-attention zeroed (controls), greedy serving over the encoder's
    cache; two encoder and two decoder layers in fp32: K4 against the
    torch-op attention (1e-3), decode against the forward.  Returns (K4's
    launches in the prefill, K4's times at the shape)."""
    from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
    from repro_torch.models import attention as att
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step

    times = flash_at(FA_SEAMLESS, gen, "seamless")
    cfg, model, params = full_model(SEAMLESS_ARCH, attn_impl="pallas")
    B, S = SEAMLESS_PREFILL
    batch = family_inputs(cfg, B, S)
    if tuple(batch["enc_frames"].shape) != (B, max(cfg.frontend_len, S // 4),
                                            cfg.d_model):
        fail(f"{cfg.name}: frames of shape {tuple(batch['enc_frames'].shape)}")
    prefill = build_prefill_step(model)
    prefill(params, {k: t[:1, :128] for k, t in batch.items()})  # warm-up
    reset_launches()
    before = torch.cuda.memory_allocated()
    logits, wall, peak = timed(lambda: prefill(params, batch))
    launches, by_body = LAUNCHES["flash_attention"], dict(LAUNCHES)
    n_k4 = cfg.enc_layers + cfg.n_layers
    if launches != n_k4 or by_body["flash_attention_tc"] != n_k4:
        fail(f"{cfg.name}: the prefill launched the flash kernel {by_body}, "
             f"not {n_k4} times on the tensor-core body")
    got = last_logits(cfg, logits, B, cfg.name)

    # each launch of one more prefill against its plain version
    seen, real = [], att.flash_attention

    def keep(q, k, v, *, causal=True):
        out = real(q, k, v, causal=causal)
        seen.append((q, k, v, causal, out))
        return out
    att.flash_attention = keep
    try:
        prefill(params, batch)
    finally:
        att.flash_attention = real
    masks = [c for _, _, _, c, _ in seen]
    if masks != [False] * cfg.enc_layers + [True] * cfg.n_layers:
        fail(f"{cfg.name}: K4's masks in the prefill {masks}")
    worst = max(close(f"{cfg.name} prefill, K4 launch {i} "
                      f"({'causal' if c else 'full'}) vs plain",
                      o, fa_plain(q, k, v, c), FA_TOL[torch.bfloat16])
                for i, (q, k, v, c, o) in enumerate(seen))
    del seen
    say("family:", json.dumps(dict(
        arch=cfg.name, run="prefill", attn_impl="pallas", reduced={},
        batch=B, seq=S, enc_frames=list(batch["enc_frames"].shape),
        wall_s=wall, prefill_tokens_per_s=B * S / wall,
        peak_memory_bytes=peak, flash_launches=by_body,
        k4_launches_max_abs_err=worst)))

    # The gates, pallas against xla: the last-position logits
    # (LOGIT_GAP_TOL) and each attention output by ||d||_2 / ||ref||_2
    # (LAYER_GAP_TOL), the model's 36 calls in order (12 encoder layers,
    # then each decoder layer's self- and cross-attention).  Controls, K4's
    # output zeroed in one call: encoder layer 0's and the middle decoder
    # layer's; each must fail the per-layer gate, the encoder's the logits
    # gate too.  The decoder's residual is carried by the cross-attention
    # over the frames, and a self-attention output at the last position is
    # a mean over ~1,000 values, so the logits gate does not see one
    # decoder layer's self-attention zeroed (on an H100: layer 0 0.0059,
    # one bf16 ulp as the fault-free run; layer 6 0.0122); the encoder's
    # first layer feeds every cross-attention (zeroed: 0.61 in fp32 on the
    # CPU).
    xla = build_prefill_step(build_model(
        dataclasses.replace(cfg, attn_impl="xla")))
    want_attn = []
    with attention_outputs(lambda i, o: want_attn.append(o)):
        ref, wall_x, _ = timed(lambda: xla(params, batch))
    want = last_logits(cfg, ref, B, f"{cfg.name} (xla)")
    n_attn = cfg.enc_layers + 2 * cfg.n_layers
    if len(want_attn) != n_attn:
        fail(f"{cfg.name}: the xla prefill made {len(want_attn)} attention "
             f"calls, not {n_attn}")

    def gated(fault=None) -> tuple:
        """(logits gap, attention gaps by call) of the kernel's prefill,
        ``fault`` in place of the kernel when given."""
        gaps = []

        def run():
            with attention_outputs(lambda i, o: gaps.append(
                    rel_l2(o, want_attn[i]))):
                return prefill(params, batch)
        out = with_attention(fault, run) if fault else run()
        return logit_gap(out[..., :cfg.vocab], want), gaps
    gap, gaps = gated()
    say("family:", json.dumps(dict(
        arch=cfg.name, run="prefill, xla (torch-op attention)",
        wall_s=wall_x, prefill_tokens_per_s=B * S / wall_x,
        pallas_vs_xla_rel_gap=gap, tolerance=LOGIT_GAP_TOL,
        attention_rel_l2_by_call=gaps, layer_tolerance=LAYER_GAP_TOL)))
    if not gap <= LOGIT_GAP_TOL:
        fail(f"{cfg.name}: prefill logits, pallas vs xla: {gap} > "
             f"{LOGIT_GAP_TOL}")
    if len(gaps) != n_attn or not max(gaps) <= LAYER_GAP_TOL:
        fail(f"{cfg.name}: attention outputs, pallas vs xla: {gaps}, not "
             f"{n_attn} within {LAYER_GAP_TOL}")
    middle = cfg.n_layers // 2
    for call, what in ((0, "encoder layer 0"),
                       (cfg.enc_layers + middle, f"decoder layer {middle}")):
        ctrl_gap, ctrl_gaps = gated(skip_attention(call))
        say("family:", json.dumps(dict(
            arch=cfg.name, run="prefill, control",
            fault=f"self-attention of {what} zero",
            logits_gated=call == 0, control_vs_xla_rel_gap=ctrl_gap,
            tolerance=LOGIT_GAP_TOL, attention_rel_l2_by_call=ctrl_gaps,
            layer_tolerance=LAYER_GAP_TOL)))
        if call == 0 and not ctrl_gap > LOGIT_GAP_TOL:
            fail(f"{cfg.name}: the control prefill reads {ctrl_gap}, within "
                 f"the gate {LOGIT_GAP_TOL}: the gate would not see that "
                 f"fault")
        if not max(ctrl_gaps) > LAYER_GAP_TOL:
            fail(f"{cfg.name}: the control's attention gaps {ctrl_gaps} are "
                 f"within {LAYER_GAP_TOL}: the per-layer gate would not see "
                 f"that fault")
    del ref, want_attn
    bs, prompt, gen_n = SEAMLESS_SERVE
    say("family:", json.dumps(dict(arch=cfg.name, **served(
        model, params, family_inputs(cfg, bs, prompt), gen_n))))
    say("profile:", json.dumps(dict(
        arch=cfg.name, run="prefill, pallas", **device_profile(
            lambda: prefill(params, batch), {"flash": "flash_fwd"}))))
    del params, batch
    torch.cuda.empty_cache()

    cfg, model, params = full_model(SEAMLESS_ARCH, dtype="float32",
                                    attn_impl="pallas", **SEAMLESS_CHECK_CUTS)
    xla = build_model(dataclasses.replace(cfg, attn_impl="xla"))
    batch = family_inputs(cfg, FP32_BATCH, FP32_SEQ)
    reset_launches()
    full, _ = model.forward(params, batch)
    torch.cuda.synchronize()
    if LAUNCHES["flash_attention_simt"] != cfg.enc_layers + cfg.n_layers:
        fail(f"{cfg.name} fp32: the flash kernel launched {dict(LAUNCHES)}")
    ref, _ = xla.forward(params, batch)
    close(f"{cfg.name} fp32 2 + 2 layers, pallas vs xla", full, ref, 1e-3)
    del full, ref
    decode_against_forward(model, params, batch,
                           f"{cfg.name} fp32 2 + 2 layers")
    del params, batch
    torch.cuda.empty_cache()
    return launches, times


def paligemma_phase() -> None:
    """paligemma-3b FULL (18 layers, hd 256, one K/V head), bf16: the
    prefill B=2 x (256 patches + 3840 tokens) under the prefix mask through
    blockwise_attn, greedy decode steps after it; then two layers in fp32
    at full width, the forward through blockwise_attn against the same
    forward through _plain_attn under the prefix mask (1e-3)."""
    from repro_torch.models import attention as att
    from repro_torch.train import build_prefill_step

    cfg, model, params = full_model(PALI_ARCH)
    B, S = PALI_PREFILL
    batch = family_inputs(cfg, B, S)
    prefill = build_prefill_step(model)
    prefill(params, {"tokens": batch["tokens"][:1, :128],
                     "frontend": batch["frontend"][:1]})         # warm-up
    masks = []
    with spying(att, "blockwise_attn", masks, lambda a, o: a[5]):
        logits, wall, peak = timed(lambda: prefill(params, batch))
    if masks != ["prefix"] * cfg.n_layers:
        fail(f"{cfg.name}: the prefill ran blockwise_attn under {masks}")
    lg = last_logits(cfg, logits, B, cfg.name)
    steps = PALI_DECODE_STEPS
    _, wall_d, peak_d = greedy_steps(model, params, lg, S, steps)
    say("family:", json.dumps(dict(
        arch=cfg.name, run="prefill, then decode", reduced={},
        batch=B, seq=S, patches=cfg.frontend_len, blockwise_masks=masks[:1],
        prefill_wall_s=wall, prefill_tokens_per_s=B * S / wall,
        prefill_peak_memory_bytes=peak, decode_positions=[S, S + steps - 1],
        decode_ms_per_step=wall_d / steps * 1e3,
        decode_peak_memory_bytes=peak_d)))
    say("profile:", json.dumps(dict(
        arch=cfg.name, run="prefill",
        **device_profile(lambda: prefill(params, batch), {}))))
    del params, batch, logits
    torch.cuda.empty_cache()

    cfg, model, params = full_model(PALI_ARCH, dtype="float32",
                                    **PALI_CHECK_CUTS)
    batch = family_inputs(cfg, *PALI_CHECK)
    masks = []
    with spying(att, "blockwise_attn", masks, lambda a, o: a[5]):
        got, _ = model.forward(params, batch)
    if masks != ["prefix"] * cfg.n_layers:
        fail(f"{cfg.name} fp32: blockwise_attn ran under {masks}")

    def plain(q, k, v, qpos, kpos, mask_kind, window, prefix_len, **_):
        return att._plain_attn(q, k, v, qpos, kpos, mask_kind, window,
                               prefix_len)
    real, att.blockwise_attn = att.blockwise_attn, plain
    try:
        want, _ = model.forward(params, batch)
    finally:
        att.blockwise_attn = real
    close(f"{cfg.name} fp32 two layers, S={PALI_CHECK[1]}, blockwise_attn "
          f"vs _plain_attn (prefix mask)", got[..., :cfg.vocab],
          want[..., :cfg.vocab], 1e-3)
    del params, batch, got, want
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training and the two knobs (phases 18-19)
# ---------------------------------------------------------------------------
TRAIN_SEED = 0
# mamba2-2.7b FULL: synthetic_batch rows x positions, steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
# the crash and restart at full width, cut in depth so the checkpoint is
# ~4 GB (params bf16 + fp32 m, v and masters); steps before and after it
RESTART_CUTS = dict(n_layers=4)
RESTART_STEPS = (2, 2)
RESTART_RTOL = 1e-6       # only if an op of the path is nondeterministic
# dbrx-132b at full width, one of its 40 layers, the factored state
DBRX_TRAIN_CUTS = dict(n_layers=1)
DBRX_TRAIN_STEPS = 2
# The gate, card against CPU: one step of the model cut to these overrides
# (fp32) from the same weights and batch (rows, positions).  Every leaf
# after the step: fp32 within TRAIN_GATE_RTOL * (|cpu| + max |leaf|), bf16
# within one bf16 ulp plus that floor; the parameters (and masters) may
# have up to TRAIN_GATE_SHARE of their entries outside it, where Adam's
# m / (sqrt(v) + eps) amplifies the two devices' summation orders on
# near-zero gradients; the moments none.  (Such an entry is also held to
# 2 lr, but that is the most two first Adam steps can differ by, so it
# is no limit of its own.)
TRAIN_GATE = {MAMBA_ARCH: (dict(n_layers=2, dtype="float32"), (1, 512)),
              MOE_ARCH: (dict(n_layers=1, dtype="float32"), (1, 32))}
TRAIN_GATE_RTOL = 1e-4
TRAIN_GATE_SHARE = 1e-3
# opt_kv_quant: granite-20b FULL served as phase 9 serves it (batch,
# prompt stepped, tokens generated), and a lockstep run of both caches
# over the same tokens (prompt, decode steps) for the logits gap; the
# codes card against CPU over (batch, steps) of two fp32 layers
KVQ_CUTS = dict(n_layers=13)
KVQ_GAP_RUN = (8, 8)
KVQ_CHECK = (2, 8)
# opt_attn_layout: two fp32 dbrx layers, the prefill (batch, positions)
LAYOUT_CHECK = (1, 4096)


def train_opt_config(arch: str):
    """The optimizer the launcher picks for the FULL config of ``arch``
    (``launch/train.py``: the factored state above 60e9 parameters), with a
    warm-up of one step, whatever cut of it runs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import opt_config_for
    return dataclasses.replace(opt_config_for(get_config(arch), 1),
                               warmup=1)


def train_batch(cfg, batch: int, seq: int, step: int, device=None) -> dict:
    """``synthetic_batch`` of ``step`` as tensors on ``device`` (the
    card)."""
    from repro_torch.data import DataConfig, synthetic_batch
    nb = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=TRAIN_SEED),
                         step)
    return {k: torch.from_numpy(v).to(device or CARD)
            for k, v in nb.items()}


def train_run(model, params, opt_cfg, batch: int, seq: int, steps,
              what: str) -> tuple:
    """Steps ``steps`` (a range of data steps, the launcher's batches) of
    the train step (params and state updated in place) from ``params``:
    each step's loss, wall, tokens/s and peak memory printed.  Returns
    (params, state, losses)."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    state = adamw_init(params, opt_cfg)
    step_fn = build_train_step(model, opt_cfg)
    losses = []
    for s in steps:
        b = train_batch(model.cfg, batch, seq, s)
        (params, state, met), wall, peak = timed(
            lambda: step_fn(params, state, b))
        loss = float(met["loss"])
        losses.append(loss)
        say("train:", json.dumps(dict(
            run=what, step=s + 1, loss=loss,
            grad_norm=float(met["grad_norm"]), lr=float(met["lr"]),
            step_s=wall, tokens_per_s=batch * seq / wall,
            peak_memory_bytes=peak)))
        if not torch.isfinite(met["loss"]):
            fail(f"{what}: loss at step {s + 1} is {loss}")
    return params, state, losses


def falls(model, params, losses, batch: int, seq: int, first: int,
          what: str) -> dict:
    """The learning check of a run: the loss of its first step's batch,
    taken again with the trained params, must be below that step's loss.
    (Each step's loss is on a fresh batch, and at ln(vocab) after a few
    steps the batch-to-batch spread is larger than the progress: mamba2
    FULL read 10.842, 10.857, 10.853, 10.840 on an H100.)  The last loss
    against the first is printed beside it."""
    from repro_torch.train import cross_entropy
    b = train_batch(model.cfg, batch, seq, first)
    with torch.no_grad():
        logits, aux = model.forward(params, b)
        again = cross_entropy(logits, b["labels"])
        if model.cfg.family == "moe":
            again = again + 0.01 * aux["lb_loss"] / max(1, model.cfg.n_layers)
    again = float(again)
    del logits
    out = dict(run=what, first_loss=losses[0], last_loss=losses[-1],
               last_below_first=losses[-1] < losses[0],
               first_batch_after=again)
    say("train, learning check:", json.dumps(out))
    if not again < losses[0]:
        fail(f"{what}: the first batch's loss after the run, {again}, is "
             f"not below its loss at the first step, {losses[0]}")
    return out


def flat_items(tree, prefix: str = ""):
    """(key path joined by "/", leaf) in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_items(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def leaf_gate(card: dict, cpu: dict, lr: float, first_fault: bool = False
              ) -> dict:
    """The train gate's reading of the card's tree against the CPU's (each
    CPU leaf copied to the card in turn, compared there): entries outside
    the tolerance in the parameters and masters, their share of the
    parameter and master entries, the largest move among them, and the
    moments' entries outside it (which fail the gate).  ``first_fault``
    (a control's reading) stops at the first leaf that fails the gate on
    its own: a moment leaf with an entry outside the tolerance, or a
    parameter leaf with more than its share outside it or an entry moved
    more than 2 lr; ``leaves_read`` says how far it got."""
    ours = dict(flat_items(card))
    off = total = moment_off = read = 0
    worst_param = worst_rel = 0.0
    for key, want in flat_items(cpu):
        read += 1
        leaf = ours.pop(key)
        got, want = leaf.float(), want.to(CARD).float()
        diff = (got - want).abs()
        floor = TRAIN_GATE_RTOL * float(want.abs().max())
        if leaf.dtype == torch.bfloat16:
            lim = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + floor
        else:
            lim = TRAIN_GATE_RTOL * want.abs() + floor
        bad = diff > lim
        n = int(bad.sum())
        is_param = key.split("/")[0] == "params" or \
            key.startswith("opt/master")
        total += want.numel() if is_param else 0
        worst_rel = max(worst_rel, float((diff / (lim + 1e-30)).max()))
        if not n:
            continue
        if is_param:
            off += n
            moved = float(diff[bad].max())
            worst_param = max(worst_param, moved)
            fails = n > TRAIN_GATE_SHARE * want.numel() or moved > 2 * lr
        else:
            moment_off += n
            fails = True
        if first_fault and fails:
            break
    if ours and not first_fault:
        raise KeyError(f"leaves on the card only: {sorted(ours)}")
    share = off / max(1, total)
    return dict(param_entries_off=off, param_entries=total, share=share,
                largest_move_off=worst_param, moment_entries_off=moment_off,
                worst_over_tolerance=worst_rel, leaves_read=read,
                passes=(moment_off == 0 and share <= TRAIN_GATE_SHARE
                        and worst_param <= 2 * lr))


def gate_model(arch: str):
    """(config, model, optimizer, batch, positions) of ``arch``'s gate."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cuts, (B, S) = TRAIN_GATE[arch]
    cfg = get_config(arch, **cuts)
    return cfg, build_model(cfg), train_opt_config(arch), B, S


def host_peak_bytes() -> int:
    """The process's peak resident set so far (``ru_maxrss``)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def gate_cpu_step(arch: str) -> tuple:
    """The CPU half of ``arch``'s gate: the weights drawn on the card
    (the card's step draws the same ones) copied to the host, and one
    train step there.  Returns (the tree after the step, its loss,
    seconds, the process's peak resident set after it in bytes)."""
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step

    cfg, model, opt, B, S = gate_model(arch)
    params = tree_map(lambda t: t.to("cpu"), model.init(TRAIN_SEED))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    p, s, met = build_train_step(model, opt)(
        params, adamw_init(params, opt), train_batch(cfg, B, S, 0,
                                                     device="cpu"))
    return ({"params": p, "opt": s}, float(met["loss"]),
            time.perf_counter() - t0, host_peak_bytes())


def gate_step(arch: str, cpu, control: bool = False) -> dict:
    """One train step of ``arch`` cut to TRAIN_GATE's overrides on the card,
    held against ``cpu`` (``gate_cpu_step``'s result for it: the same
    step on the CPU from the same weights and batch); the card's run with
    ``clip_norm = 0`` (every gradient scaled by 0) when ``control``."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step

    cfg, model, opt, B, S = gate_model(arch)
    cpu_tree, cpu_loss, cpu_s, cpu_rss = cpu
    card_opt = dataclasses.replace(opt, clip_norm=0.0) if control else opt
    params = model.init(TRAIN_SEED)
    (p, s, met), wall, peak = timed(lambda: build_train_step(
        model, card_opt)(params, adamw_init(params, card_opt),
                                      train_batch(cfg, B, S, 0)))
    del params
    reading = leaf_gate({"params": p, "opt": s}, cpu_tree, opt.lr,
                        first_fault=control)
    card_loss = float(met["loss"])
    reading.update(arch=cfg.name, cuts=TRAIN_GATE[arch][0], batch=B, seq=S,
                   optimizer=dataclasses.asdict(card_opt),
                   card_loss=card_loss, card_step_s=wall,
                   card_peak_memory_bytes=peak)
    if not control:
        reading.update(cpu_loss=cpu_loss, cpu_step_s=cpu_s,
                       host_peak_rss_bytes=cpu_rss,
                       loss_rel_gap=abs(card_loss - cpu_loss) / abs(cpu_loss))
    del p, s
    torch.cuda.empty_cache()
    return reading


def train_gates() -> dict:
    """The gate on mamba2's and dbrx's cuts, each with its control, against
    the CPU's step."""
    out = {}
    for arch in TRAIN_GATE:
        cpu = gate_cpu_step(arch)
        reading = gate_step(arch, cpu)
        say("train gate:", json.dumps(reading))
        if not reading["passes"] or \
                not reading["loss_rel_gap"] <= TRAIN_GATE_RTOL:
            fail(f"{arch}: one train step on the card differs from the "
                 f"CPU's: {reading}")
        ctrl = gate_step(arch, cpu, control=True)
        say("train gate, control (clip_norm 0):", json.dumps(ctrl))
        if ctrl["passes"]:
            fail(f"{arch}: the control step (gradients scaled by 0) passes "
                 f"the gate: {ctrl}")
        del cpu
        out[arch] = dict(gate=reading, control=ctrl)
    return out


def restart_run() -> dict:
    """mamba2 at full width cut to RESTART_CUTS, under
    ``torch.use_deterministic_algorithms``: the steps straight through,
    then the same steps with a checkpoint saved after the first part,
    every tree dropped, fresh state restored from it, and the rest run.
    The last losses must be equal bit for bit; were an op of the path
    without a deterministic CUDA implementation (the mode's warning names
    it), they would be held within RESTART_RTOL instead."""
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step

    cfg = get_config(MAMBA_ARCH, **RESTART_CUTS)
    model = build_model(cfg)
    opt = train_opt_config(MAMBA_ARCH)
    first, second = RESTART_STEPS
    ckpt = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gp, _, gold = train_run(model, model.init(TRAIN_SEED), opt,
                                    TRAIN_BATCH, TRAIN_SEQ,
                                    range(first + second),
                                    "restart: straight")
            learned = falls(model, gp, gold, TRAIN_BATCH, TRAIN_SEQ, 0,
                            "restart, straight run")
            del gp
            torch.cuda.empty_cache()
            p, s, before = train_run(model, model.init(TRAIN_SEED), opt,
                                     TRAIN_BATCH, TRAIN_SEQ, range(first),
                                     "restart: before the crash")
            _, save_s, _ = timed(lambda: save_checkpoint(
                ckpt, first, {"params": p, "opt": s}))
            nbytes = sum(os.path.getsize(os.path.join(dp, f))
                         for dp, _, fs in os.walk(ckpt) for f in fs)
            del p, s
            torch.cuda.empty_cache()
            fresh = model.init(TRAIN_SEED + 1)     # not the weights saved
            (state, step), restore_s, _ = timed(lambda: restore_checkpoint(
                ckpt, {"params": fresh, "opt": adamw_init(fresh, opt)}))
            del fresh
            p, s = state["params"], state["opt"]
            del state
            if step != first or int(s["step"]) != first:
                fail(f"restart: restored step {step} / {int(s['step'])}, "
                     f"not {first}")
            step_fn = build_train_step(model, opt)
            after = []
            for k in range(first, first + second):
                p, s, met = step_fn(p, s, train_batch(cfg, TRAIN_BATCH,
                                                      TRAIN_SEQ, k))
                after.append(float(met["loss"]))
            del p, s
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught
                     if "deterministic implementation" in str(w.message)})
    out = dict(arch=cfg.name, cuts=RESTART_CUTS, steps=RESTART_STEPS,
               straight=gold, resumed=before + after,
               checkpoint_bytes=nbytes, save_s=save_s, restore_s=restore_s,
               nondeterministic_ops=nondet,
               bit_exact=gold[-1] == after[-1])
    say("train restart:", json.dumps(out))
    if nondet:
        gap = abs(gold[-1] - after[-1]) / abs(gold[-1])
        if not gap <= RESTART_RTOL:
            fail(f"restart: the resumed run ends {gap} from the straight "
                 f"run (ops without a deterministic implementation: "
                 f"{nondet})")
    elif gold[-1] != after[-1] or gold[:first] != before:
        fail(f"restart: the resumed run ends on {after[-1]!r}, the straight "
             f"run on {gold[-1]!r}")
    out["learning"] = learned
    torch.cuda.empty_cache()
    return out


def train_phase() -> dict:
    """Phase 18: training on the card.  mamba2-2.7b FULL (64 blocks, bf16,
    remat) for TRAIN_STEPS steps of B x S synthetic tokens under the
    launcher's optimizer (fp32 masters), one more step profiled; the crash
    and restart; dbrx-132b at full width, one layer, the factored state,
    through route_matching under autograd; the card-against-CPU gates with
    their controls."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train import build_train_step
    from repro_torch.train import steps as steps_mod

    out = {}
    cfg, model, params = full_model(MAMBA_ARCH)
    opt = train_opt_config(MAMBA_ARCH)
    say("train:", json.dumps(dict(arch=cfg.name, remat=cfg.remat,
                                  optimizer=dataclasses.asdict(opt),
                                  params=cfg.params_count())))
    params, state, losses = train_run(model, params, opt, TRAIN_BATCH,
                                      TRAIN_SEQ, range(TRAIN_STEPS),
                                      f"{cfg.name} FULL")
    if NCCL_TRAIN:
        # phase 5c's NCCL world of one took these steps through ZeRO-1
        one = losses[:WORLD_TRAIN_STEPS]
        gaps = [abs(a - b) / abs(b) for a, b in zip(NCCL_TRAIN["losses"],
                                                     one)]
        say("world train, nccl 1 against one device:", json.dumps(dict(
            nccl_world=NCCL_TRAIN["losses"], one_device=one,
            loss_rel_gaps=gaps, bit_exact=NCCL_TRAIN["losses"] == one)))
        if not all(g <= TRAIN_GATE_RTOL for g in gaps):
            fail(f"the NCCL world's mamba2 steps differ from one device's: "
                 f"{gaps}")
    learned = falls(model, params, losses, TRAIN_BATCH, TRAIN_SEQ, 0,
                    f"{cfg.name} FULL")
    step_fn = build_train_step(model, opt)
    b = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS)
    with spying(steps_mod, "adamw_update", [], label="adamw_update"):
        say("profile:", json.dumps(dict(
            arch=cfg.name, run=f"train step {TRAIN_STEPS + 1}",
            **device_profile(lambda: step_fn(params, state, b), {},
                             ranges=("adamw_update",)))))
    out["mamba2"] = dict(losses=losses, learning=learned)
    del params, state, b
    torch.cuda.empty_cache()

    out["restart"] = restart_run()

    cfg = get_config(MOE_ARCH, **DBRX_TRAIN_CUTS)
    model = build_model(cfg)
    opt = train_opt_config(MOE_ARCH)
    if not opt.factored:
        fail(f"{cfg.name}: the launcher's optimizer is not factored")
    params, init_s, _ = timed(lambda: model.init(TRAIN_SEED))
    say("train:", json.dumps(dict(
        arch=cfg.name, cuts=DBRX_TRAIN_CUTS, router=cfg.router,
        remat=cfg.remat, optimizer=dataclasses.asdict(opt),
        gb_on_card=torch.cuda.memory_allocated() / 1e9, init_s=init_s)))
    params, _, losses = train_run(model, params, opt, TRAIN_BATCH, TRAIN_SEQ,
                                  range(DBRX_TRAIN_STEPS),
                                  f"{cfg.name} 1 layer, factored")
    out["dbrx"] = dict(losses=losses, learning=falls(
        model, params, losses, TRAIN_BATCH, TRAIN_SEQ, 0,
        f"{cfg.name} 1 layer"))
    del params
    torch.cuda.empty_cache()

    out["gates"] = train_gates()
    return out


def kv_cache_bytes(cache) -> int:
    return sum(cache[k].numel() * cache[k].element_size()
               for k in ("k", "v", "k_scale", "v_scale") if k in cache)


def kvq_codes_check() -> dict:
    """Two fp32 granite layers at full width with the int8 cache: the same
    decode steps on the card and on the CPU, from the same weights and
    tokens; the codes may differ by one (the devices' matmuls round
    differently), never by more, and the bf16 scales by one bf16 ulp."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(LM_ARCH, n_layers=2, dtype="float32", opt_kv_quant=True)
    model = build_model(cfg)
    params = model.init(LM_SEED)
    cpu_params = tree_map(lambda t: t.cpu(), params)
    B, steps = KVQ_CHECK
    gen = torch.Generator(device=CARD).manual_seed(LM_SEED + 2)
    toks = torch.randint(0, cfg.vocab, (B, steps), generator=gen,
                         device=CARD)
    card = model.init_cache(B, steps)
    cpu = model.init_cache(B, steps, device="cpu")
    for t in range(steps):
        lg, card = model.decode_step(params, card, toks[:, t:t + 1], t)
        lc, cpu = model.decode_step(cpu_params, cpu,
                                    toks[:, t:t + 1].cpu(), t)
    out = dict(arch=cfg.name, layers=2, batch=B, steps=steps,
               logits_max_abs_diff=float((lg.cpu() - lc).abs().max()))
    for name in ("k", "v"):
        d = (card[name].cpu().int() - cpu[name].int()).abs()
        out[f"{name}_codes"] = int(d.numel())
        out[f"{name}_codes_off_by_1"] = int((d == 1).sum())
        out[f"{name}_codes_off_by_more"] = int((d > 1).sum())
    for name in ("k_scale", "v_scale"):
        a, b = card[name].cpu().float(), cpu[name].float()
        off = (a - b).abs() > 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
        out[f"{name}_differ"] = int((a != b).sum())
        out[f"{name}_off_by_more_than_an_ulp"] = int(off.sum())
    say("kv quant, card vs CPU:", json.dumps(out))
    if out["k_codes_off_by_more"] or out["v_codes_off_by_more"] or \
            out["k_scale_off_by_more_than_an_ulp"] or \
            out["v_scale_off_by_more_than_an_ulp"]:
        fail(f"int8 cache, card vs CPU: {out}")
    del params, cpu_params, card, cpu
    torch.cuda.empty_cache()
    return out


def kvq_serving() -> dict:
    """granite-20b at full width cut to KVQ_CUTS, served with the bf16
    cache and with the int8 one (phase 9's greedy serving), then both
    caches stepped in lockstep over the same tokens (the bf16 run's greedy
    ones): the logits gap at each decode step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCell, make_inputs
    from repro_torch.models import build_model

    cfg = get_config(LM_ARCH, **KVQ_CUTS)
    plain, quant = build_model(cfg), build_model(
        dataclasses.replace(cfg, opt_kv_quant=True))
    params, init_s, _ = timed(lambda: plain.init(LM_SEED))
    inputs = make_inputs(cfg, ShapeCell("serve", SERVE_PROMPT, SERVE_BATCH,
                                        "prefill"), seed=LM_SEED)
    max_len = SERVE_PROMPT + SERVE_GEN
    out = {"arch": cfg.name, "cuts": KVQ_CUTS, "batch": SERVE_BATCH,
           "max_len": max_len,
           "cache_bytes_bf16": kv_cache_bytes(
               plain.init_cache(SERVE_BATCH, max_len)),
           "cache_bytes_int8": kv_cache_bytes(
               quant.init_cache(SERVE_BATCH, max_len))}
    torch.cuda.empty_cache()
    out["bf16"] = served(plain, params, inputs, SERVE_GEN)
    out["int8"] = served(quant, params, inputs, SERVE_GEN)
    prompt, gen = KVQ_GAP_RUN
    cp = plain.init_cache(SERVE_BATCH, prompt + gen)
    cq = quant.init_cache(SERVE_BATCH, prompt + gen)
    toks = inputs["tokens"][:, :prompt]
    gaps, agree = [], 0
    tok = toks[:, :1]
    for t in range(prompt + gen):
        if t < prompt:
            tok = toks[:, t:t + 1]
        lp, cp = plain.decode_step(params, cp, tok, t)
        lq, cq = quant.decode_step(params, cq, tok, t)
        if not torch.isfinite(lq.float()).all():
            fail(f"int8 cache: logits at position {t} not finite")
        if t >= prompt - 1:
            gaps.append(logit_gap(lq, lp))
            agree += int((lq.argmax(-1) == lp.argmax(-1)).sum())
        tok = lp[:, -1:].argmax(-1)
    out.update(logits_gap_decode_max=max(gaps),
               logits_gap_decode_mean=sum(gaps) / len(gaps),
               argmax_agree=f"{agree}/{SERVE_BATCH * len(gaps)}")
    say("kv quant:", json.dumps(out))
    if not out["cache_bytes_int8"] < 0.52 * out["cache_bytes_bf16"]:
        fail(f"int8 cache of {out['cache_bytes_int8']} bytes against "
             f"{out['cache_bytes_bf16']} in bf16")
    del params, cp, cq
    torch.cuda.empty_cache()
    return out


def layout_check() -> dict:
    """Two fp32 dbrx layers at full width, the prefill at S=4096 with
    ``opt_attn_layout`` (hflat_blockwise_attn, once a layer) against
    without it (blockwise_attn), within 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as att
    from repro_torch.models import build_model
    from repro_torch.train import build_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(MOE_ARCH, n_layers=2, dtype="float32")
    off, on = build_model(cfg), build_model(
        dataclasses.replace(cfg, opt_attn_layout=True))
    params = off.init(MOE_SEED)
    B, S = LAYOUT_CHECK
    gen = torch.Generator(device=CARD).manual_seed(MOE_SEED + 3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=CARD)}
    want, wall_off, _ = timed(lambda: build_prefill_step(off)(params, batch))
    one = lambda args, out: 1                  # noqa: E731
    with spying(att, "hflat_blockwise_attn", [], one) as calls, \
            spying(att, "blockwise_attn", [], one) as plain_calls:
        got, wall_on, peak = timed(
            lambda: build_prefill_step(on)(params, batch))
    err = close(f"{cfg.name} fp32 2 layers, prefill S={S}, opt_attn_layout "
                f"on vs off", got, want, 1e-3)
    out = dict(arch=cfg.name, layers=2, batch=B, seq=S, max_abs_err=err,
               hflat_calls=len(calls), blockwise_calls=len(plain_calls),
               on_s=wall_on, off_s=wall_off, on_peak_memory_bytes=peak)
    say("attn layout:", json.dumps(out))
    if len(calls) != cfg.n_layers or plain_calls:
        fail(f"opt_attn_layout prefill called hflat_blockwise_attn "
             f"{len(calls)} times and blockwise_attn {len(plain_calls)}")
    del params, got, want
    torch.cuda.empty_cache()
    return out


def knob_phase() -> dict:
    """Phase 19: the int8 KV cache (granite-20b FULL served both ways, the
    codes card against CPU) and the H-flat attention layout."""
    return dict(kv_quant=kvq_serving(), kv_quant_codes=kvq_codes_check(),
                attn_layout=layout_check())


def family_phases() -> None:
    """Phases 14-15: mamba2, zamba2."""
    t0 = time.perf_counter()
    mamba_phase()
    phase(MAMBA_ARCH, t0)
    t0 = time.perf_counter()
    zamba_phase()
    phase(ZAMBA_ARCH, t0)


def attention_family_phases() -> tuple:
    """Phases 16-17: seamless, paligemma.  Returns (K4's launches in
    seamless's prefill, K4's times at seamless's shape)."""
    t0 = time.perf_counter()
    k4, times = seamless_phase(
        torch.Generator(device=CARD).manual_seed(FAMILY_SEED))
    phase(SEAMLESS_ARCH, t0)
    t0 = time.perf_counter()
    paligemma_phase()
    phase(PALI_ARCH, t0)
    return k4, times


def lm_phases() -> dict:
    """Phases 7-9: K4 against its plain version, the fp32 two-layer checks,
    the granite-20b main path.  Returns the kernel's entry."""
    t0 = time.perf_counter()
    entry = flash_checks()
    phase("flash attention checks", t0)
    t0 = time.perf_counter()
    fp32_checks()
    phase("fp32 two-layer checks", t0)
    t0 = time.perf_counter()
    entry["launches"] = lm_main_path()
    phase("lm main path", t0)
    return entry


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a card",
              file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found; run from the root of a "
              "checkout of the repository", file=sys.stderr)
        return 2
    use_src()
    dynamo = import_in_background()
    from repro_torch.kernels._build import load_library
    from repro_torch.matching import SOLVE_PATHS

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    say(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    say("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    sources = ["frontier_expand", "graph_loop", "flash_attention"]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        libs = dict(zip(sources, ex.map(load_library, sources)))
    say(f"kernel builds (one nvcc per source, in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        report = ptxas_report(lib.build_log)
        say(f"  {name}.cu: nvcc {lib.build_seconds:.2f} s, "
            f"{json.dumps(report)}")
        spilled = {k: v for k, v in report.items()
                   if k.startswith("flash_fwd_tc") and v["spill_bytes"]}
        if spilled:
            fail(f"tensor-core flash bodies spill registers: {spilled}")

    dynamo.join()
    # graphs, the CPU half of the small-set check and the CPU main-path
    # solves, in worker processes at the lowest priority (the card's
    # phases and the ranks of phase 5c's worlds, which the host bounds, go
    # first); terminated on the way out whatever happens
    pool = multiprocessing.get_context("spawn").Pool(
        2 * len(MAIN_PATH) + 1, initializer=os.nice, initargs=(19,))
    try:
        kernels, lm, (k4_seamless, seamless_times), cpu = run_phases(
            pool, list(SOLVE_PATHS))
        torch.cuda.empty_cache()
        k1a, k1a_levels, k4 = moe_phases()
        family_phases()
        t0 = time.perf_counter()
        check_cpu(*cpu)
        phase("the main path against the CPU", t0)
    finally:
        pool.terminate()
        pool.join()
    kernels.append(lm)
    t0 = time.perf_counter()
    train_phase()
    phase("training", t0)
    t0 = time.perf_counter()
    knob_phase()
    phase("opt_kv_quant and opt_attn_layout", t0)
    for entry in kernels:
        if entry["name"] == "frontier_expand_fused_wr":
            entry["launches"] += k1a
            entry["launches_exact_router"] = k1a
            entry["levels_checked"] += k1a_levels
            entry["levels_checked_exact_router"] = k1a_levels
        if entry["name"] == "flash_attention":
            entry["launches"] += (k4 + k4_seamless + AXIS["launches"]
                                  + AXIS_FAMILY["launches"]
                                  + UNEVEN["launches"]
                                  + FAMILY_UNEVEN["launches"])
            entry["launches_dbrx_prefill"] = k4
            entry["launches_seamless_prefill"] = k4_seamless
            entry["seamless"] = seamless_times
            entry["launches_model_axis"] = AXIS["launches"]
            entry["model_axis_local_heads"] = AXIS["times"]
            entry["launches_model_axis_families"] = AXIS_FAMILY["launches"]
            entry["model_axis_dbrx_local_heads"] = AXIS_FAMILY["times"]
            entry["launches_model_axis_uneven"] = UNEVEN["launches"]
            entry["model_axis_deepseek_uneven_heads"] = UNEVEN["times"]
            entry["launches_model_axis_experts_heads"] = \
                FAMILY_UNEVEN["launches"]
            entry["model_axis_dbrx_uneven_heads"] = FAMILY_UNEVEN["times"]

    say(f"total: {time.perf_counter() - started:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(pool, paths) -> tuple:
    """The matching paths (phases 1-6b), with phases 7-9, 16 and 17 run on
    the card while the workers draw the graphs (the matching phases wait
    for them; those need none).  Returns (the matching kernels' entries,
    K4's, ``attention_family_phases``' result, the arguments of
    ``check_cpu``: the CPU's main-path solves, the longest of the
    workers' jobs, are checked after phase 15)."""
    from repro_torch.matching import compile_cache_clear
    t0 = time.perf_counter()
    pending_graphs, extra, cpu_small, cpu_traces = start_workers(pool, paths)
    lm = lm_phases()
    torch.cuda.empty_cache()
    seamless = attention_family_phases()
    torch.cuda.empty_cache()
    graphs, wants, cpu_main = collect_graphs(pool, pending_graphs)
    phase("graphs (phases 7-9, 16 and 17 on the card meanwhile)", t0)

    t0 = time.perf_counter()
    warm_up()
    runs, outcomes = main_path(graphs)
    phase("main path", t0)
    t0 = time.perf_counter()
    checks = kernel_checks(graphs)
    phase("kernel checks", t0)
    t0 = time.perf_counter()
    small_sets_bit_exact(cpu_small)
    compile_cache_clear()
    wants = check_scipy(runs, wants)
    phase("small sets against the CPU, the main path against scipy", t0)
    t0 = time.perf_counter()
    for entry, g in zip(MAIN_PATH, graphs):
        profile_main_path(entry, g)
        compile_cache_clear()
        torch.cuda.empty_cache()
    phase("profile", t0)
    phase2 = {(gi, path): (row, got)
              for row, (gi, path, got) in zip(runs, outcomes)}
    t0 = time.perf_counter()
    sharded = sharded_phase(graphs, wants, extra, phase2)
    phase("sharded matcher", t0)
    t0 = time.perf_counter()
    refs = family_references()
    refs_s = time.perf_counter() - t0
    say(f"phase 5e, one device's side: {refs_s:.1f} s")
    t0 = time.perf_counter()
    axis_ckpt = os.path.join(HERE, "build", "chip_smoke_axis_ckpt")
    family_ckpt = os.path.join(HERE, "build", "chip_smoke_family_ckpt")
    for d in (axis_ckpt, family_ckpt):
        shutil.rmtree(d, ignore_errors=True)
    world, (axis, family), (axis_s, family_s) = world_phase(
        graphs, phase2, axis_ckpt, refs, family_ckpt, wants, extra)
    say(f"phase 5c worlds of ranks: "
        f"{time.perf_counter() - t0 - axis_s - family_s:.1f} s (less phase "
        f"5d's ranks, {axis_s:.1f} s, and 5e's, {family_s:.1f} s)")
    t0 = time.perf_counter()
    AXIS.update(model_axis_phase(axis, axis_ckpt))
    say(f"phase 5d the model axis: {time.perf_counter() - t0 + axis_s:.1f} "
        f"s (its ranks {axis_s:.1f} s in phase 5c's worlds, its checks "
        f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    AXIS_FAMILY.update(family_axis_phase(family, refs, family_ckpt))
    del refs
    say(f"phase 5e the model axis of the MoE, SSM and hybrid families: "
        f"{time.perf_counter() - t0 + family_s + refs_s:.1f} s (one "
        f"device's side {refs_s:.1f} s, its ranks {family_s:.1f} s in "
        f"phase 5c's worlds, its checks {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    UNEVEN.update(uneven_phase())
    phase("5f the model axis where it does not divide the heads", t0)
    t0 = time.perf_counter()
    FAMILY_UNEVEN.update(family_uneven_phase())
    phase("5g experts and SSM heads the model axis does not divide", t0)
    t0 = time.perf_counter()
    DRYRUN["collectives"] = dry_collectives(UNEVEN.pop("prefill_comm"))
    phase(f"5h the dry run against the card (granite's part "
          f"{DRYRUN['granite']['seconds']:.1f} s in phase 9)", t0)

    # one line for the kernels, each timed on the main-path graph of its
    # body: kron for WR, the random graph for plain
    timed_on = {"wr": label(MAIN_PATH[KRON]), "plain": label(MAIN_PATH[RANDOM])}
    slices = sharded["slices"]
    kernels = []
    for name, replaces in KERNELS.items():
        mine = [r for r in checks if r["kernel"] == name]
        row = next(r for r in mine
                   if r["graph"] == timed_on[name.rsplit("_", 1)[1]])
        entry = dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/frontier_expand.cu",
            replaces=replaces,
            launches=(sum(r["launches"][name] for r in runs)
                      + sharded["launches"][name] + world[name]),
            launches_sharded=sharded["launches"][name],
            launches_world=world[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"],
            ms_device_level=row["kernel_ms_device_level"],
            bound_ms=row["bound_ms"], bound_by="bytes", library_ms=None,
            timed_on=row["graph"],
            levels_checked=sum(r["levels_checked"] for r in mine),
            **{k: v for k, v in row.items() if k.startswith("device_ms_")})
        kind = {"frontier_expand_fused_wr": "fused",
                "frontier_expand_wr": "proposals",
                "frontier_expand_pull_wr": "pull"}.get(name)
        if kind:
            # held on kron's shard slices too, and timed a shard launch
            entry.update(
                levels_checked_sharded=sharded["levels_checked"],
                ms_shard_launch=slices[kind]["ms"],
                device_ms_shard_sweep=slices[kind]["device_ms_sweep"],
                bound_ms_shard_launch=slices[kind]["bound_ms"])
        kernels.append(entry)
    kernels += serving_phase(pool)
    t0 = time.perf_counter()
    corpus = corpus_phase(graphs, runs, cpu_traces)
    phase("6b fuzz, traces, wrappers, examples", t0)
    for entry in kernels:
        entry["launches_corpus"] = corpus.get(entry["name"], 0)
        entry["launches"] += entry["launches_corpus"]
    return kernels, lm, seamless, (outcomes, cpu_main)


def phase(name: str, t0: float) -> None:
    say(f"phase {name}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    sys.exit(main())
