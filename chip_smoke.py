#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (knn_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one JSON line (a failed check raises, so the script
exits non-zero and prints no result):

1. device  — the card's name, ``nvidia-smi`` name and power limit, versions;
   lint    — ``python -m knn_tpu_torch.cli lint --json`` in a subprocess
             with no card visible (``CUDA_VISIBLE_DEVICES=""``): exit 0, no
             finding, the five registered checkers, at least one justified
             suppression, the report's counts on the phase's line;
2. build   — builds every CUDA kernel of the port from ``knn_tpu_torch/csrc``
             with nvcc (one process per arm of each source, all at once);
             every bf16x3, bf16x3f and default build must hold bf16
             tensor-core (HMMA) instructions, every highest build FP64
             tensor-core (DMMA) ones and every int8 and int4 build s8
             tensor-core (IMMA) ones; the registers, local bytes, emitter
             build and passes a tile of every build a launch can take (the
             deep grouped builds at 1, 3, 4 and 8 survivors and on
             512-group tiles among them);
3. kernel  — K1 (the fused bf16x3 binned-select kernel) and K10 (the
             db-streaming kernel) against their plain PyTorch version on
             the card: dim 24 with ragged rows, dim 300 (three dim chunks),
             one full 16,384-row SIFT tile at Q=256; cd and bounds within
             coarse_knn.kernel_plain_tolerance_scale (||q||^2 +
             max||t||^2), ci equal wherever a bin's
             values are separated by more than that, the exclusion bound
             sound against float64 scores, and K10's outputs bitwise equal
             to K1's; K11 (the fused early-out kernel) against its plain
             version at the kernel's own geometry on the far-tile case (a
             near 16,384-row tile, two far ones, 4,096 queries; at least
             one tile must skip) and on the full SIFT tile: the same
             skipped (block, tile) cells, the rest within the tolerance;
             the tensor-core k-step's rounding probe (bf16, and highest's
             f64 step against its model: ties, products far below the
             accumulator, cancellation), and fault 18's construction
             through every bf16x3 and bf16x3f entry;
4. main    — certified-exact k=100 search at the SIFT1M shape (1,000,000 x
             128 f32 rows and 4,096 queries drawn as bench.py draws them,
             seed 0) through ``ShardedKNN.search_certified(selector=
             "pallas")`` with the default knobs: K1 against its plain
             version at this shape, both timed with CUDA events; the
             search's q/s (its first call, then a second one), K1
             launches in the first call and certificate stats; recall@100 =
             1.0 and index equality against a float64 direct-difference
             oracle on the first 256 queries; then ``profile`` traces one
             more certified search with torch.profiler (device time by
             kernel, device busy time, device idle share), one trace that
             must hold K1 and at least one of its warm-up kernels (a trace
             that lost them may have lost the block's first kernels);
4b. mesh   — the db-sharded mesh (knn_tpu_torch.parallel) at the ``main``
             shape and draw: ``ShardedKNN(mesh=make_mesh(1, 4,
             devices=[cuda:0] * 4))`` (four logical shards of 250,000 rows
             on the one card), ``search_certified()`` with the default
             knobs under ``merge="ring"`` and ``"allgather"``: K1 launched
             4 times (once a shard) and no other kernel, the indices
             bitwise the ``main`` (1, 1) placement's and the oracle's on
             256 queries (recall@100 = 1.0), every row whose distances
             differ from the (1, 1) placement's one that either placement
             repaired (it holds a value f32 cannot represent; there within
             RANK_SLACK, equal where both are float64), ring bitwise
             allgather; ``make_host_mesh(1, 2, 2)`` under the four
             ``(merge, dcn_merge)`` pairs, each bitwise the flat mesh;
             two processes on the card (``MultiHostKNN`` over a TCPStore,
             500,000 rows each, K1 / K5 / K2 once a process): bf16x3 on the
             4,096 queries with the flat mesh's indices, int8 (K5, on the
             draw cast to uint8, the quant phase's byte-exact placement,
             where its lists certify queries) and highest (K2) on the
             first 1,024 queries (a cut for time: the int8 repair), each
             held against the (1, 1) placement's same arm and draw as
             above (the rows whose distances differ counted), each
             process certifying at least one query,
             ``MERGE_BYTES{level="dcn"}``
             = merge_bytes(4096, 100, 2, "allgather"), ``health``'s
             multihost section naming 2 hosts, one stitched cross-host
             waterfall per request, the store exchange's seconds and bytes
             (the host-mediated TCP store on one machine: no NVLink, no
             InfiniBand); a failed child fails the phase; the mesh and
             (1, 1) calls timed in turns (logical shards of one card: no
             speed claim follows); then the process-spanning mesh
             (``spanning``, :data:`SPAN_CHILD`): two processes, each on
             cuda:0, ``backend="nccl"`` refused by name (one card), then
             a gloo group: ``global_mesh(1, 2)`` with the full rows in
             each, ``search_certified`` bf16x3 (4,096 queries), highest
             and int8 on the uint8 cast (1,024 each): the arm's kernel
             once a process, every process's ``(d, i, stats)`` equal and
             bitwise process 0's one-process ``make_mesh(1, 2,
             devices=[cuda:0] * 2)``, timed in turns with it, recall@100
             = 1.0 with the oracle's indices on 256 queries (int8: the
             uint8 draw's own oracle); ``shard_across_hosts`` of each
             process's half, ``search`` (1,024) bitwise the logical
             mesh's, a certified search on it refused by name;
             ``global_host_mesh(1, 2, 2)`` (two logical positions a
             process) under the four ``(merge, dcn_merge)`` pairs,
             bitwise the flat spanning ``global_mesh(1, 4)`` of the same
             four shards (itself the 1 x 2 mesh's indices), K1 twice a
             process; then
             four processes on ``global_mesh(2, 2)`` at the main draw's
             first 262,144 rows (a cut for time), bf16x3 on 1,024
             queries bitwise the one-process ``(2, 2)`` logical mesh, K1
             once a process; each exchange's seconds and bytes/s (gloo
             over loopback through the host: no interconnect, no NCCL);
             no child imports jax, jaxlib or knn_tpu;
4c. tiers_mesh — (run after ``serving``, the last phase on the main
             draw) the tiers on the 1 x 4 logical mesh at the ``main``
             shape (launch counts reset before each path: K1 once a db
             shard a batch, or a superblock, and no other kernel; 0
             kernels on the exact paths): ``MutableIndex`` (reserve 32,
             4,096 rows inserted across three tail rungs, the reserve
             deleted, 1,024 queries) bitwise the same writes on the (1, 1)
             placement (256 queries: a cut for time) and the f64 oracle
             (256 queries, recall@100 = 1.0),
             ``compact()`` on the mesh; the compacted rows on the 1 x 2 x
             2 host mesh, bitwise the flat mesh; ``IVFIndex`` on the ivf
             anchor (the main rows cut to 65,536, 32 queries, every list
             probed; 32 lists and 2 k-means iterations, a cut for time),
             counted exact and pallas bf16x3 tiled, both brute force
             bitwise and the oracle's; ``knn_join`` of the 4,096 queries in
             1,024-row superblocks, stream and certified, each bitwise its
             looped mesh search; the certified stream (the first 2,048
             queries in two segments, a cut for time) bitwise the direct
             mesh ``search_certified``;
             ``ServingEngine`` on the mesh over the bench trace (48
             requests, the 16..512 ladder): each request bitwise the eager
             mesh search of its padded batch, no capture on the second
             replay; ``MutableServingEngine`` reads across a background
             compaction, each bitwise its epoch's direct search; K1 on one
             shard's rows against its plain version and timed; the mesh /
             (1, 1) seconds of each tier call in turns (logical shards of
             one card: no speed claim follows); ``autotune_ivf(mesh=)`` on
             the ivf anchor (32 lists, candidates nprobe 32 and 8, its
             first 8 queries, ``runs=1``, ``selector="pallas"``): both
             candidates through the bitwise gate, the winner's certified
             search bitwise the (1, 1) index's, and the selector's kernel
             (knn_search_pallas over each probe group's gathered block at
             IVF's default precision highest: K2's tiled entry, on the
             mesh's first device, as the JAX package runs it) launched once
             a probe group of each gated and timed search and no other
             kernel; and, beside the phase's own calls, the spanning block
             (``TIERS_SPAN_CHILD``): two processes on cuda:0 under gloo on
             ``global_mesh(1, 4)``, two positions a process, making the
             phase's calls on its inputs — the ``MutableIndex`` writes and
             its 1,024-query certified call, reads of 64 queries across a
             background compaction (``compact_tail_rows`` at the 4,096
             written rows: every read from one epoch in both processes, 0
             first, 1 last), the compacted call (in turns with process 0's
             one-process logical index of the same rows); the ivf anchor
             trained and searched by both selectors (pallas at its default
             precision, highest: K2 once a probe group a process); the
             IVF tuner; the stream and certified joins; the 2,048-query
             certified stream interrupted after its first segment and
             resumed; ``sharded_minmax`` over the main rows and queries —
             each path's results equal in both processes and bitwise the
             phase's own logical 1 x 4 results, K1 twice a process a
             certified call (once an owned shard) and no other kernel,
             K1 on one owned shard against its plain version and timed,
             each path's seconds and exchanges; no child imports jax,
             jaxlib or knn_tpu;
4d. mesh_paths — (run after ``tiers_mesh``, on its 1 x 4 logical
             placement of the ``main`` draw; launch counts reset before
             each path) the host-RAM tier on the 1 x 4 and a 2 x 2 logical
             mesh behind the ``hosttier`` phase's 128 MiB budget, 4,096
             queries: sweeps ``hbm.n_sweeps(..., shard_multiple=db
             shards)``, no coarse kernel, recall@100 = 1.0 against the f64
             oracle (256 queries), against the resident mesh search every
             distance within 64 eps_f32 (||q||^2 + max||t||^2) and the
             index sets equal where its k-th and (k+1)-th are twice that
             apart, the slots holding each db block once a slot (below one
             corpus); the tiered join of the 4,096 queries by 1,024
             bitwise the looped mesh tier search; pq with the ``pq``
             phase's trained state carried across (``pq_from_numpy``),
             1,024 queries (a cut: every uniform query falls back to the
             host repair), tiled, db-major and streaming: the entry 4
             times a batch (once a db shard) and no other kernel, indices
             bitwise the (1, 1) pq placement's and the oracle's (256), K7
             on one 250,000-row shard bitwise its plain version and timed,
             the mesh's own training on 65,536 rows' first 32 dims (8
             subspaces) bitwise the (1, 1) training's codebooks; the pipeline (4,096 queries in four
             1,024-query batches, depth 2) under ``kernel="fused"`` and
             ``"tiled"``: K11 / K1 16 times a call, bitwise the sequential
             mesh call, indices bitwise the (1, 1) pipelined call's
             (distances as in ``mesh``), K11 on one shard at the
             pipeline's geometry against its plain version and timed; int8
             on the draw cast to uint8 (1,024 queries in four batches, a
             cut: the int8 repair) bitwise its sequential call, K5 16
             times; ``search_bucketed`` over the bench trace's first 16
             requests, each bitwise the eager mesh search of its padded
             batch; the mesh / (1, 1) seconds of each path in turns (no
             speed claim: one card);
5. obs     — the telemetry core (knn_tpu_torch.obs) at the ``main`` shape
             and placement: warm ``main`` calls with obs on and off in
             turns (on / off / off / on, twelve rounds; twelve more, up
             to 36, while the medians differ by more than 3%), bitwise the
             same, both q/s medians and their ratio (>= 0.97); the
             ``CERTIFIED_*`` counters against one call's stats and the
             counted certificate's margin histogram against its certified
             queries (512 queries through ``selector="exact"``); one
             ``device_trace("main")`` with obs on and one with it off: K1
             in the trace, the top device operations, the idle share, and
             the same host synchronizations and device-to-host copies; the
             roofline share of the call and of the K1 launch, each <= 1;
             32 requests through a ``QueryQueue`` over a 65,536-row
             engine's graphs, each with its own trace id and span chain,
             and each request's waterfall rebuilt (obs.waterfall), its
             segments tiling its latency within the stated tolerance;
             ``/metrics`` and ``/statusz`` scraped from
             ``start_metrics_server`` on an ephemeral port (the inventory
             names the card); the fleet plane over that exporter: the live
             member's /metrics.json and /statusz (obs.fleet.collect_live)
             merged with a snapshot taken under
             ``set_identity(process_index=1)``, the merged counters equal
             to the two members' sums, each member's own device inventory
             naming the card,
             ``/fleetz``, and ``cli fleet --snapshot-dir`` exiting 0 on two
             snapshots and 2 once one is torn;
6. campaign — the measured-ceiling loop (knn_tpu_torch.campaign) at the
             ``main`` shape, launch counts read around it: the
             ``bf16x3_tiled`` (K1) and ``bf16x3_streaming`` (K10) arms,
             each through all seven stages on the card (tune on the 4,096
             queries over tiles of 124,928, 249,856 and 16,384 rows under
             the Hopper resource gate, the timed ``search_certified`` calls
             on a placement made once with the batch's fallbacks counted,
             a device trace read back from disk by obs.traceread holding
             the arm's kernel with profiler.summarize's busy time, the fit
             of each sample — host phase and device trace — against the
             H100 roofline, the store, the curated artifact); two store
             entries under distinct keys, each calibrated ceiling within
             RESIDUAL_TOLERANCE_PCT of its measured q/s and at least the
             arm's own wall rate; the ``main`` block re-rendered under the
             store carries the applied calibration, its calibrated ceiling
             at least every q/s the main search reached in this run, and
             ``health`` names the entries; each arm's line carries the
             sentinel's verdict (obs.sentinel against this checkout's
             history): ``no_baseline`` under its ``cuda`` key, every
             curated field it carries listed, valid under the ``sentinel``
             schema and the line under ``bench_line``;
7. stream  — at the ``main`` shape and placement: ``search_certified``
             with ``grid_order="db_major"`` (K9), ``kernel="streaming"``,
             ``kernel="fused"`` and ``kernel="fused", overlap=True,
             batch_size=1024, overlap_depth=2``; each run's d and i bitwise
             equal to the tiled run's, recall@100 = 1.0 with the oracle's
             indices on the first 256 queries, each run's own kernel
             launched once per batch and no other; K10's and the db-major
             K1's outputs bitwise K1's; q/s of each run (second call, then
             five rounds of all five configurations in turns, tiled
             included), K9, K10 and K11 ms per launch at Q=4,096 against
             their plain versions and the bound, K11 against its plain
             version at Q=4,096 and at
             the pipelined run's own geometry (each 1,024-query batch),
             K11's skipped cells, the pipeline stats, pipelined calls on
             the kept CUDA streams against fresh ones (wall and the
             allocator's new segments) and the device idle share of the
             pipelined run (torch.profiler);
8. selectors — the counted certificate at the ``main`` shape and
             placement: ``search_certified(selector="exact")`` and
             ``("approx")`` (no coarse kernel launched), each with the
             ``pallas`` run's indices for every query, recall@100 = 1.0 and
             the oracle's indices on the first 256 queries and float64
             distances within 1e-12 of the oracle's, fallbacks; warm q/s of
             exact, approx and pallas timed in turns; where an exact call's
             time goes (coarse distance blocks, coarse top-m, float64 refine
             on the host, the count pass) and a profile of a 512-query call; a
             ``compute_dtype="bfloat16"`` program on the same placement:
             ``search`` recall@100 on 256 queries, the certified exact
             selector's indices, and which half-precision matmul form ran
             (ops.distance.half_matmul_form);
9. metrics — dot: a ``metric="dot"`` placement of the ``main`` rows
             (norm-augmented to 129 dims, Dp = 256), its certified search
             launching K1 once and no other kernel, recall@100 = 1.0 and
             the indices of a float64 MIPS oracle on 256 queries, the exact
             selector's indices equal; K1 at Dp = 256 against its plain
             version on 512 queries, timed at 4,096 against its plain
             version and its bound; l1: ``search`` on 256 queries, recall@100
             >= 0.999 against a float64 L1 oracle; radius: ``radius_search``
             on 256 queries at a radius between two oracle distances,
             counts and masks equal the oracle's; the estimators
             (KNNRegressor, NearestNeighbors, RadiusNeighborsClassifier) on
             100,000 rows equal to their ShardedKNN outputs;
10.f32arms — the f32-family arms bf16x3f (K4), highest (K2) and default
             (K3): each of their nine entries (tiled, streaming, fused)
             against its plain version within coarse_knn.
             kernel_plain_tolerance_scale (||q||^2 + max||t||^2) (bf16x3f
             and default: the proved sum of the tensor-core summation's
             bound and the plain version's; highest: (2 nd + 4) 2^-24, nd
             = Dp / 128), ci equal on separated slots, on
             the ``kernel`` phase's small cases, the far-tile case (the
             fused entries must skip) and at the ``main`` shape (the fused
             entries also at the pipelined run's geometry), K3's error
             over that tolerance and over the 128 2^-24 it replaced (Dp =
             128 and 896, all-positive and normal data); every
             streaming entry bitwise its tiled entry and the db-major tiled
             entry (K9) bitwise the query-major one, as the ``stream`` and
             ``quant`` phases check for the other three arms; the tiled,
             streaming and fused entries of bf16x3, bf16x3f and highest on
             all-positive data at Dp = 896, each score within the worst
             case csrc/binned_select.cuh states; then ``search_certified(precision=
             "bf16x3f")`` and ``("highest")`` at the ``main`` shape through
             five configurations (tiled, tiled db-major, streaming, fused,
             the pipeline): recall@100 = 1.0 with the oracle's indices, d
             and i bitwise equal across the five, each run's own kernel
             launched once per batch and no other, fallback counts, q/s, a
             profile of the tiled call; the counted certificate
             ``knn_search_certified(candidate_fn=pallas_candidate_fn(
             precision="default"))`` through K3's tiled, db-major, streaming
             and fused entries, each with the oracle's indices; the max over
             the emitted candidates of |s_kernel - s_f64| / tolerance for
             bf16x3, bf16x3f and highest at Dp = 128 (must stay below 1);
             every entry's ms per launch against its plain version and its
             bound;
11. quant  — the int8 (K5) and int4 (K6) arms: each of the six int
             entries (tiled, streaming, fused x int8, int4) against its
             plain version on the card, bitwise (cd, ci, bounds), on
             integer data with exact ties at dim 24 (ragged rows), dim 300
             and one full 16,384-row tile at Q=256, the streaming outputs
             bitwise the tiled ones, the fused ones at the kernel's own
             geometry, and the far-tile case, where the fused kernels must
             skip the plain version's cells; at the SIFT1M shape each
             entry bitwise its plain version at Q=4,096, the fused ones
             also at the pipelined run's own geometry (each 1,024-query
             batch, its own tile segments); then ``search_certified(
             precision="int8")`` on the SIFT1M-shape data cast to uint8
             (byte-exact placement) and ``precision="int4"`` on the ``main``
             f32 data, each with ``kernel`` tiled (query- and db-major),
             streaming, fused and fused through the pipeline: recall@100 =
             1.0 with the oracle's indices, d and i bitwise equal across
             the five runs, each arm's kernels launched once per batch and
             no other kernel, fallback counts, max ε, q/s; the six entries'
             and the db-major grid's ms per launch at Q=4,096 against their
             plain versions and the int bound;
             the device idle share of the int8 tiled run;
12. pq     — K7, the pq arm: its tiled, db-major and streaming entries
             bitwise their plain version (grouped binning, and lane
             binning at 2 and 8 survivors, 128- and 256-row bins) on a
             random LUT and codes with exact ties at the ``kernel``
             phase's shapes and at m = 196, C = 200 with 45 queries and a
             1,280-row tile (a full 1,024-row block of K7's walk and a
             shorter one); the pq placement of the ``main`` data (codebooks
             trained on its first 100,000 rows, every row encoded; its
             seconds), the three entries bitwise their
             plain version at Q=4,096 and timed against it and the bound;
             ``search_certified(precision="pq")`` through tiled, db-major
             and streaming (each run's own kernel launched once and no
             other, d and i bitwise across the three, recall@100 = 1.0
             with the oracle's indices, fallback counts, ε, q/s); then a
             lattice case (65,536 x 128 rows whose every 4-dim subspace
             takes one of 256 points: the training recovers them, the
             residuals are 0, so most queries certify) the same way;
13. lane   — K8, lane binning: every arm's tiled, db-major and streaming
             lane entries against their plain versions (int8, int4 and pq
             bitwise, the f32 family within its tolerance with ci equal on
             separated slots) at 1 to 8 survivors and 128-, 256- and
             512-row bins, and each lane score bitwise the grouped entry's
             score of the same row; at the main shape each entry against
             its plain version, its scores against the grouped entry's,
             timed beside the grouped entry in turns (the lane / grouped
             ratio); ``search_certified(binning="lane")`` for bf16x3,
             bf16x3f, highest, int8, int4 and pq, tiled and streaming, on
             the ``main`` data (the indices of the grouped bf16x3 run for
             every query, the oracle's, distances within RANK_SLACK,
             fallbacks, q/s), and the counted certificate through the
             default arm's lane entries;
14. survivors — grouped binning at 1 and 3-8 survivors (the deep builds):
             every entry of every arm against its plain version (int, pq
             bitwise; the f32 family within its tolerance) on small shapes
             at every count, on 256- and 512-group tiles with ties between
             their first and last groups and on 512 queries of the
             ``main`` placement at 1, 3, 4, 5 and 8, the fused skip on far
             tiles at 1, 3, 5 and 8, the deep entries timed at 4,096
             queries at 1, 3, 4, 5 and 8 in turns beside the two-survivor
             ones, ``search_certified`` at 4 and 8 survivors against the
             oracle (recall@100 1.0), and every deep entry driven through a
             search at 3;
15. tune   — the autotuner: the quick grid on the ``main`` rows and the
             standard grid at 100,000 rows, every candidate timed, gated
             out by the bitwise gate or refused by the resource gate (one
             that raised fails the phase), a second call timing 0
             candidates, and a search resolving its knobs from the cache.
             The script runs with an empty HOME of its own, so no cached
             winner picks the knobs of another phase;
16. classify — the reference job (``python -m knn_tpu_torch.cli ... --k 50
             --mode certified --selector pallas``, run in-process through
             run_job) on make_mnist_like CSVs (20,000 train, 2,000 test,
             2,000 val), then again with ``--pallas-precision int8`` and
             ``highest``; labels must equal the port's ``--mode exact``; the
             |s_kernel - s_f64| / tolerance ratio of bf16x3, bf16x3f and
             highest at Dp = 896 on the job's rows (must stay below 1), and
             K2's three entries timed there; then with ``--backend native``
             (the C++ CPU backend), whose labels must equal the certified
             job's; every job's three CSVs must go through the native
             reader (``native.calls``);
17. index  — a ``MutableIndex`` of the ``main`` rows (k=100, reserve 32):
             4,096 rows inserted in three writes across the tail's rungs
             (256, 2,048, 4,096), the whole reserve deleted and a 33rd
             delete refused (MutationBudgetError), ``search_certified`` on
             1,024 queries launching K1 once and no other kernel, bitwise a
             fresh index of the survivors built on the card, recall@100 =
             1.0 with the float64 oracle's indices on 256 queries, bitwise
             again after ``compact()`` and across a background compaction
             while this thread searches; the tail's float64 host refine's
             share of a call; ``search()``'s recall; then its serving
             frontend (``MutableServingEngine``, graphs on the 16..512
             ladder) through a ``QueryQueue``: reads, ``submit_write``
             inserts and deletes, a background compaction whose new engine
             captures its graphs beside live reads, every read bitwise the
             direct search of its epoch and, after the swap, bitwise a
             fresh index of the survivors;
18. ivf    — an ``IVFIndex`` of 131,072 x 128 clustered rows
             (``make_blobs(131072 + 128, 128, 362, seed=0)``, the last 128
             rows the queries; 362 lists, nprobe 90): the exact selector
             and the pallas selector through K2, K1, K5 in each of tiled,
             streaming and fused (K10, K11), every combination bitwise,
             recall@100 = 1.0 with the oracle's indices, one launch per
             probe group, the host split of each call and the placement of
             one group's block; ``nprobe = ncentroids`` on the uniform
             ``main`` rows cut to 65,536, 32 queries, bitwise
             ``refine_shared_exact`` brute force; the default nprobe there
             (every query repaired); an insert, delete and compact cycle
             exact; its serving frontend (``IVFServingEngine``, pallas
             bf16x3) through a ``QueryQueue``, bitwise ``search_certified``
             with K1 launched per probe group, every served answer audited
             against the float64 oracle (recall 1.0, 0 deficient, none
             dropped); the drift sketch: the norm PSI of the held-out
             queries below that of the same queries scaled x4;
19. hosttier — the host-RAM tier: the ``main`` rows behind a 128 MiB
             budget (``ShardedKNN(hbm_budget_bytes=)``, k=100, 4,096
             queries): 4 sweeps of 260,111-row segments planned, run and
             counted (``HOSTTIER_SWEEPS``), one dispatch shape, no coarse
             kernel, recall@100 = 1.0 against the float64 oracle on the
             first 256 queries, against the resident ``search`` bitwise
             or within 64 eps_f32 (|q|^2 + max |t|^2) with the indices
             wherever the k-th and (k+1)-th are separated, the tier's
             two segment buffers held and at most one budget more a call
             (besides the queries and the carry), below the corpus's
             516 MB in all, every
             resident-only entry refused by name; the call's and each
             sweep's seconds, the copies' GB/s; the lock-order hammer over
             the tier (``tier_lock_order``);
20. join   — ``knn_join`` of 16,384 rows against the ``main`` placement in
             4,096-row superblocks: ``mode="stream"`` bitwise the looped
             ``search`` (rows/s, overlap_ratio), ``mode="certified"``
             bitwise the looped ``search_certified`` with K1 launched 4
             times; the tiered join of the same rows against the
             ``hosttier`` placement, db-major (4,096-row superblocks) and
             query-major (one 16,384-row superblock), each bitwise the
             looped host-tier ``search`` at its block shape;
21. native — the C++ CPU backend built from ``knn_tpu_torch/native`` on
             this machine: ``knn_search`` within 64 eps_f32 of the port's
             CPU path (indices where separated), ``knn_predict`` equal to
             it, and 16 queries at the ``main`` shape timed;
22. serving — ``ServingEngine`` on the ``main`` placement with the bench
             ladder 16..512 (``bench.py:805-818``): six CUDA graphs after
             ``warmup()``, the 48-request log-uniform trace (seed 42)
             replayed twice at depth 2 (no capture the second time), every
             request bitwise an eager ``search`` of its padded batch,
             recall@100 = 1.0 against the float64 oracle on the trace's
             first 256 rows, sustained q/s, p50/p95/p99, warmup seconds
             and the graph pool's bytes; ``predict`` through the engine on
             the placement with labels equal to ``ShardedKNN.predict``;
             256 concurrent 1-8-row requests through a ``QueryQueue``, each
             bitwise its coalesced batch's search; a knee sweep (3 rates x
             1 s, sizes 1-8, SLO 100 ms); ``streaming_certified_knn`` of
             the 4,096 queries in 1,024-query segments, two segments
             removed and resumed, bitwise the direct ``search_certified``,
             K1 launched once a segment; then the audit sampler
             (obs.audit) on the engine's graphs: the float64 oracle's host
             rows/s, 32 requests of 1-8 rows at rate 1.0 and that budget
             (replayed + dropped = sampled, recall 1.0, 0 deficient, every
             waterfall complete, ``stats()`` with ``slo``,
             ``slowest_requests`` and ``quality``), the bench trace at the
             default budget (requests over 5 rows dropped under
             ``budget``), and a seeded fault on one tenant under 1 s / 4 s
             SLO windows: one ``audit_recall:<tenant>`` firing transition
             and one postmortem bundle, read back by ``cli waterfall`` and
             ``cli audit``; and the lock-order hammer on the warm graphs
             (the engine's ``_lock`` and ``_launch_lock``, a queue's
             ``_cond`` and admission controller, the SLO engine, the
             registry, one histogram, the audit sampler at rate 1.0
             instrumented by knn_tpu_torch.analysis.lockorder; 8 threads x
             4 barrier rounds of one 1-8-row request): no thread raises,
             every instrumented lock taken, a batch a round at least,
             edges recorded, no cycle, every request bitwise its coalesced
             batch's eager search, one graph replay per queue batch and no
             capture (the index phase runs the same over the mutable
             frontend across a background compaction, with the index's
             ``_lock`` and ``_compact_lock`` and the placement's
             ``_engines_lock``, the locks instrumented through reads
             across the swap, some served on the old epoch; the hosttier
             phase over the host-RAM tier's ``_tier_lock`` /
             ``_engines_lock`` with direct searches);
    catalog — every bench block the run built (the ``main``, ``obs`` and
             re-rendered roofline blocks, each campaign arm's roofline,
             calibration, campaign and sentinel block and its line, the
             fleet block, the knee, the tune entries) validated by
             knn_tpu_torch.analysis.artifacts in both styles (each phase
             fails on a refusal; this line lists them); the ``main``
             phase's warm call as a record in ``bench.py``'s line shape
             (its own ``bench_line`` line, written to no file): valid,
             ``obs.roofline.block_for_bench_line`` of it the bound seconds,
             ceiling and bound class of the block ``main`` published,
             ``curate_line`` refusing nothing and hoisting that block's
             ``roofline_pct`` and ``bound_class``, a non-empty
             ``line_summary``, the sentinel's verdict ``no_baseline``; and
             ``sweep_records`` / ``sweep_multichip`` over the repo's
             history giving :data:`HISTORY_SWEEP` / HISTORY_MULTICHIP;
23. kernels — one JSON line per the contract: each ported kernel (K1,
             K10, K11, K1 at Dp = 256 on the dot path, the entries of K4,
             K2, K3, K5, K6, K7, the db-major grid K9, the lane entries K8
             and the deep grouped entries of every arm)
             with its launches on its own path, its max error against its
             plain version, its time, its plain version's time and its
             bound (one per arm).

Then the ``nvidia-smi`` name/power line and, last, ``{"ok": true, ...}``.
``--phases`` runs a subset (e.g. ``--phases device,lint``,
``--phases device,build,kernel``,
``--phases device,build,kernel,stream``, ``--phases device,build,quant``,
``--phases device,build,f32arms``, ``--phases device,build,pq``,
``--phases device,build,lane``, ``--phases device,build,survivors,tune``,
``--phases device,build,selectors,metrics``,
``--phases device,build,index,ivf,join``,
``--phases device,build,hosttier,join``, ``--phases device,native``,
``--phases device,build,serving``, ``--phases device,build,main,obs``,
``--phases device,build,main,obs,campaign`` or
``--phases device,build,main,mesh`` or
``--phases device,build,main,tiers_mesh``).
"""

from __future__ import annotations

import argparse
import atexit
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the H100's peaks and the per-kernel bounds (f32_bound: K1, K4, K2, K3 and
# their streaming / fused entries; int_bound: K5, K6; pq_bound: K7) and the
# device-trace summary live in the port's obs package
from knn_tpu_torch.obs.profiler import WARMUP_KERNELS, device_trace
from knn_tpu_torch.obs.roofline import f32_bound, int_bound, pq_bound

#: rows of the main placement its pq codebooks train on (every row is
#: encoded against them)
PQ_TRAIN_ROWS = 100_000

EPS32 = float(np.finfo(np.float32).eps)
U32 = 2.0 ** -24
#: kernel scores of PAD_VAL rows are ~1e35 and above; compare them by class
PAD_SCALE = 1e30


#: the script's start, for each phase line's ``elapsed_s``
T0 = time.perf_counter()

#: the repo this script runs from (the lint phase lints it)
REPO = Path(__file__).resolve().parent

#: every bench block of the run validated through the artifact catalog
CATALOG_CHECKS: list = []

#: the repo's bench history (TPU_BENCH_r*.jsonl, BENCH_r*.json) swept
#: through the catalog: blocks validated by schema, none refused; and its
#: MULTICHIP_r*.json records (tests/test_torch_artifacts.py pins the same
#: counts against the JAX package's sweep)
HISTORY_SWEEP = {"bench_line": 12}
HISTORY_MULTICHIP = 5

#: one of the mesh phase's two processes: its half of the ``main`` rows in
#: a MultiHostKNN over a TCPStore; writes its results into ``out_dir``
MESH_CHILD = r"""
import json, sys, time
import numpy as np
import torch

pid, port, out_dir = int(sys.argv[1]), sys.argv[3], sys.argv[4]
from knn_tpu_torch import obs
from knn_tpu_torch.obs import names as mn
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel import multihost

obs.reset(enabled=True)
obs.reset_event_log(path=f"{out_dir}/events{pid}.jsonl")
multihost.initialize(f"localhost:{port}", 2, pid, timeout_s=300,
                     backend="gloo")
n, dim, n_q, k = 1_000_000, 128, 4096, 100
rng = np.random.default_rng(0)
db = (rng.random(size=(n, dim)) * 128.0).astype(np.float32)
q = (rng.random(size=(n_q, dim)) * 128.0).astype(np.float32)
half = n // 2
knn = multihost.MultiHostKNN(db[pid * half:(pid + 1) * half], k=k)
# int8 runs on the main draw cast to uint8, the quant phase's byte-exact
# placement, where K5's lists certify queries and so reach the merge (on
# the f32 draw int8 certifies none: every list would be a host repair)
knn8 = multihost.MultiHostKNN(
    db[pid * half:(pid + 1) * half].astype(np.uint8), k=k)
q8 = q.astype(np.uint8).astype(np.float32)
del db
res = {"pid": pid}
for arm, rows in (("bf16x3", n_q), ("int8", 1024), ("highest", 1024)):
    before = dict(ck.binned_select.launches)
    t0 = time.perf_counter()
    d, i, st = (knn8 if arm == "int8" else knn).search_certified(
        (q8 if arm == "int8" else q)[:rows], margin=28, precision=arm)
    wall = time.perf_counter() - t0
    launched = {a: ck.binned_select.launches[a] - before[a]
                for a in before if ck.binned_select.launches[a] != before[a]}
    np.save(f"{out_dir}/d_{arm}_{pid}.npy", d)
    np.save(f"{out_dir}/i_{arm}_{pid}.npy", i)
    rep = multihost.last_report()
    res[arm] = {"wall_s": wall, "launches": launched,
                "per_host": st["per_host"],
                "straggler_gap_s": st["straggler_gap_s"],
                "exchange_s": rep["exchange_s"],
                "exchange_bytes": rep["exchange_bytes"],
                "dcn_bytes_total": obs.counter(
                    mn.MERGE_BYTES, level="dcn",
                    strategy="allgather").get()}
res["health"] = obs.health.report()["multihost"]
res["foreign"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "knn_tpu"))
print("RESULT " + json.dumps(res), flush=True)
"""


#: one process of the mesh phase's process-spanning runs: ``n_proc``
#: processes, each driving cuda:0, join a gloo group (nccl, with every
#: process on the one card, refused by name first) and run ShardedKNN on a
#: mesh whose positions belong to the processes; process 0 also runs the
#: one-process logical mesh of the same shape, in turns with the spanning
#: calls, and holds the two bitwise.  Results go to ``out_dir``.
SPAN_CHILD = r"""
import json, sys, time
import numpy as np
import torch

pid, n_proc, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                              sys.argv[4])
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel import multihost
from knn_tpu_torch.parallel.mesh import make_mesh
from knn_tpu_torch.parallel.sharded import ShardedKNN

dev = torch.device("cuda", 0)
res = {"pid": pid, "n_proc": n_proc}
try:
    multihost.initialize(f"localhost:{port}", n_proc, pid, timeout_s=600,
                         backend="nccl")
    res["nccl_refused"] = None
except ValueError as e:
    res["nccl_refused"] = str(e)
multihost.initialize(f"localhost:{port}", n_proc, pid, timeout_s=600,
                     backend="gloo", devices=[dev])
k, n_q = 100, 4096
rng = np.random.default_rng(0)
db = (rng.random(size=(1_000_000, 128)) * 128.0).astype(np.float32)
q = (rng.random(size=(n_q, 128)) * 128.0).astype(np.float32)
if n_proc == 4:  # the reduced four-process draw: the main draw's first rows
    db = np.ascontiguousarray(db[:262_144])


def sync():
    torch.cuda.synchronize()
    torch.distributed.barrier()


def launches():
    # every kernel counter: the tiled grouped entry by its arm, any other
    # entry (streaming, fused, deep, lane, db-major) by wrapper and counter
    out = {}
    for fn in (ck.binned_select, ck.stream_select, ck.fused_select):
        for attr in ("launches", "deep_launches", "lane_launches",
                     "db_major_launches"):
            for a, n in getattr(fn, attr, {}).items():
                tiled = fn is ck.binned_select and attr == "launches"
                out[a if tiled else f"{fn.__name__}.{attr}.{a}"] = n
    return out


def run(fn):
    # (result, seconds, the kernels it launched, the in-mesh report)
    before = launches()
    sync()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = launches()
    sync()
    return (out, wall, {a: after[a] - before[a] for a in after
                        if after[a] != before[a]}, multihost.last_report())


def logical_turn(fn):
    # process 0's one-process call while the others wait at the barrier
    sync()
    out, wall = None, None
    if pid == 0:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sync()
    return out, wall


def same(a, b):
    da, ia, sa = a
    db_, ib, sb = b
    return bool(np.array_equal(da, db_) and np.array_equal(ia, ib)
                and json.dumps(sa, sort_keys=True)
                == json.dumps(sb, sort_keys=True))


def certified_case(label, prog, ref, qq, arm, rows):
    call = lambda p: p.search_certified(qq[:rows], margin=28, precision=arm)
    (d, i, st), wall, launched, rep = run(lambda: call(prog))
    times = {"spanning": [wall], "logical": []}
    want, lw = logical_turn(lambda: call(ref) if ref is not None else None)
    times["logical"].append(lw)
    times["logical"].append(logical_turn(
        lambda: call(ref) if ref is not None else None)[1])
    times["spanning"].append(run(lambda: call(prog))[1])
    np.save(f"{out_dir}/d_{label}_{pid}.npy", d)
    np.save(f"{out_dir}/i_{label}_{pid}.npy", i)
    with open(f"{out_dir}/stats_{label}_{pid}.json", "w") as f:
        json.dump(st, f, sort_keys=True)
    res[label] = {
        "queries": rows, "launches": launched, "seconds_in_turns": times,
        "bitwise_logical": None if want is None else same((d, i, st), want),
        "fallback_queries": st["fallback_queries"],
        "transport": rep["transport"], "exchanges": rep["exchanges"],
        "exchange_s": rep["exchange_s"],
        "exchange_bytes": rep["exchange_bytes"],
        "exchange_log": [dict(e, bytes_per_s=e["bytes"] / e["s"]
                              if e["s"] > 0 else None)
                         for e in rep["exchange_log"]],
        "dcn_merge": rep["dcn_merge"],
        "dcn_merge_bytes": rep["dcn_merge_bytes"]}
    return d, i


if n_proc == 2:
    mesh = multihost.global_mesh(1, 2, devices=[dev])
    res["mesh"] = repr(mesh)
    logical = make_mesh(1, 2, devices=[dev, dev])
    u8 = db.astype(np.uint8)
    q8 = q.astype(np.uint8).astype(np.float32)
    knn = ShardedKNN(db, k=k, mesh=mesh)
    ref = ShardedKNN(db, k=k, mesh=logical) if pid == 0 else None
    d_flat, i_flat = certified_case("bf16x3", knn, ref, q, "bf16x3", n_q)
    certified_case("highest", knn, ref, q, "highest", 1024)
    knn8 = ShardedKNN(u8, k=k, mesh=mesh)
    ref8 = ShardedKNN(u8, k=k, mesh=logical) if pid == 0 else None
    certified_case("int8", knn8, ref8, q8, "int8", 1024)
    del knn8, ref8
    # (b) each process's own half placed on its own position
    half = db.shape[0] // 2
    placed = multihost.shard_across_hosts(db[pid * half:(pid + 1) * half],
                                          mesh)
    sk = ShardedKNN(placed, k=k, mesh=mesh)
    (d, i), wall, launched, rep = run(lambda: sk.search(q[:1024]))
    want, lw = logical_turn(lambda: ref.search(q[:1024]))
    try:
        sk.search_certified(q[:8])
        refused = None
    except ValueError as e:
        refused = str(e)
    res["placed_search"] = {
        "queries": 1024, "launches": launched,
        "seconds_in_turns": {"spanning": [wall], "logical": [lw]},
        "bitwise_logical": None if want is None else bool(
            torch.equal(d, want[0]) and torch.equal(i, want[1])),
        "certified_refused": refused, "transport": rep["transport"],
        "exchange_s": rep["exchange_s"],
        "exchange_bytes": rep["exchange_bytes"]}
    del sk, placed
    # (c) the host axis is the process axis: two logical positions each,
    # held against the flat spanning mesh of the same four shards (a
    # mesh's exclusion bounds come from its shards' bins, so the 1 x 2
    # mesh may repair other queries: its indices, not its distances)
    fk = ShardedKNN(db, k=k, mesh=multihost.global_mesh(1, 4,
                                                        devices=[dev, dev]))
    (d_flat, i4, _), wall, launched, rep = run(
        lambda: fk.search_certified(q, margin=28, precision="bf16x3"))
    res["flat_1x4"] = {"launches": launched, "seconds": wall,
                       "indices_of_1x2": bool(np.array_equal(i4, i_flat))}
    i_flat = i4
    del fk
    hmesh = multihost.global_host_mesh(1, 2, 2, devices=[dev, dev])
    res["host_mesh"] = repr(hmesh)
    for merge, dcn in [(a, b) for a in ("ring", "allgather")
                       for b in ("ring", "allgather")]:
        hk = ShardedKNN(db, k=k, mesh=hmesh, merge=merge, dcn_merge=dcn)
        (d, i, st), wall, launched, rep = run(
            lambda: hk.search_certified(q, margin=28, precision="bf16x3"))
        res[f"host_{merge}_{dcn}"] = {
            "launches": launched, "seconds": wall,
            "bitwise_flat": bool(np.array_equal(d, d_flat)
                                 and np.array_equal(i, i_flat)),
            "exchange_ops": sorted({e["op"] for e in rep["exchange_log"]}),
            "dcn_merge": rep["dcn_merge"],
            "dcn_merge_bytes": rep["dcn_merge_bytes"]}
        del hk
else:
    mesh = multihost.global_mesh(2, 2, devices=[dev])
    res["mesh"] = repr(mesh)
    knn = ShardedKNN(db, k=k, mesh=mesh)
    ref = (ShardedKNN(db, k=k, mesh=make_mesh(2, 2, devices=[dev] * 4))
           if pid == 0 else None)
    certified_case("bf16x3_2x2", knn, ref, q, "bf16x3", 1024)
res["foreign"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "knn_tpu"))
multihost.shutdown()
print("RESULT " + json.dumps(res), flush=True)
"""


#: one process of the tiers_mesh phase's process-spanning block: two
#: processes, each driving cuda:0 under gloo, run the tiers on
#: ``global_mesh(1, 4)`` (two positions a process) with the phase's own
#: inputs and calls; the parent holds their results against the phase's
#: one-process 1 x 4 logical results.  Process 0 also times the compacted
#: index's certified call in turns with a one-process logical index of the
#: same rows.  Arrays go to ``out_dir``, the rest to the RESULT line.
TIERS_SPAN_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch

pid, n_proc, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                              sys.argv[4])
import chip_smoke as cs
from knn_tpu_torch import streaming
from knn_tpu_torch.index import MutableIndex
from knn_tpu_torch.ivf import IVFIndex
from knn_tpu_torch.join import knn_join
from knn_tpu_torch.ops import coarse_knn as ck
from knn_tpu_torch.parallel import multihost
from knn_tpu_torch.parallel.mesh import make_mesh
from knn_tpu_torch.parallel.sharded import ShardedKNN, sharded_minmax
from knn_tpu_torch.tuning import autotune_ivf

dev = torch.device("cuda", 0)
multihost.initialize(f"localhost:{port}", n_proc, pid, timeout_s=600,
                     backend="gloo", devices=[dev])
mesh = multihost.global_mesh(1, 4, devices=[dev, dev])
n, dim, k = 1_000_000, 128, 100
rng = np.random.default_rng(0)
db = (rng.random(size=(n, dim)) * 128.0).astype(np.float32)
q_all = (rng.random(size=(4096, dim)) * 128.0).astype(np.float32)
res = {"pid": pid, "mesh": repr(mesh),
       "local_positions": [list(p) for p in mesh.local_positions]}
k1_main = 0


def sync():
    torch.cuda.synchronize()
    torch.distributed.barrier()


def launches():
    out = {}
    for fn in (ck.binned_select, ck.stream_select, ck.fused_select):
        for attr in ("launches", "deep_launches", "lane_launches",
                     "db_major_launches"):
            for a, c in getattr(fn, attr, {}).items():
                tiled = fn is ck.binned_select and attr == "launches"
                out[a if tiled else f"{fn.__name__}.{attr}.{a}"] = c
    return out


def run(label, fn):
    # fn() on the spanning mesh: its seconds, the kernels it launched and
    # its exchanges (multihost.last_report)
    global k1_main
    before = launches()
    sync()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = launches()
    rep = multihost.last_report() or {}
    sync()
    got = {a: after[a] - before[a] for a in after if after[a] != before[a]}
    k1_main += got.get("bf16x3", 0)
    res.setdefault(label, {}).update(
        seconds=wall, launches=got, exchange_s=rep.get("exchange_s"),
        exchange_bytes=rep.get("exchange_bytes"),
        exchanges=rep.get("exchanges"))
    return out


def save(label, *arrays):
    for j, a in enumerate(arrays):
        np.save(f"{out_dir}/{label}_{j}_{pid}.npy",
                a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a))


# -- MutableIndex: the phase's writes, 1,024 queries
q = q_all[:1024]
t0 = time.perf_counter()
idx = MutableIndex(db, k=k, reserve=32, mesh=mesh, compact_tail_rows=4096)
res["build_s"] = time.perf_counter() - t0
new = (np.random.default_rng(5).random(size=(4096, dim))
       * 128.0).astype(np.float32)
rungs = []
for lo, hi in ((0, 200), (200, 1100), (1100, 4096)):
    idx.insert(new[lo:hi], np.arange(n + lo, n + hi))
    rungs.append(idx.stats()["tail_capacity"])
dead = [int(j) for j in range(0, n, n // 24)][:24]
dead += [n + j for j in range(0, 4096, 512)][: 32 - len(dead)]
idx.delete(dead)
res["tail_rungs"] = rungs
d, i, st = run("mutable", lambda: idx.search_certified(q))
save("mutable", d, i)
res["mutable"]["fallback_queries"] = st["fallback_queries"]
# -- reads across a background compaction: the compactor cuts at its
# start (the tail is at its 4,096-row threshold); each read agrees on the
# epoch, so the swap lands at the same read in both processes
idx.start_compactor()
reads = []
while True:
    d, i, st = run("read", lambda: idx.search_certified(q[:64]))
    reads.append({"epoch": st["index"]["epoch"],
                  "launches": res["read"]["launches"],
                  "seconds": res["read"]["seconds"]})
    save(f"read{len(reads) - 1}", d, i)
    if st["index"]["epoch"] == 1 or len(reads) >= 120:
        break
    time.sleep(0.25)
idx.close()
res.pop("read")
res["reads"] = reads
d, i, st = run("mutable_compacted", lambda: idx.search_certified(q))
save("compacted", d, i)
# the compacted call in turns with a one-process logical index of the same
# rows (process 0; process 1 waits at the barrier)
snap = idx._snapshot()
logical = (MutableIndex(snap.main._host_train(), snap.base_ids, k=k,
                        reserve=32, mesh=make_mesh(1, 4, devices=[dev] * 4))
           if pid == 0 else None)
turns = {"spanning": [], "logical": []}
for _ in range(2):
    run("turn", lambda: idx.search_certified(q))
    turns["spanning"].append(res.pop("turn")["seconds"])
    sync()
    if pid == 0:
        t0 = time.perf_counter()
        ld, li, _ = logical.search_certified(q)
        torch.cuda.synchronize()
        turns["logical"].append(time.perf_counter() - t0)
        res["logical_bitwise"] = bool(np.array_equal(ld, d)
                                      and np.array_equal(li, i))
    sync()
res["mutable_compacted"]["seconds_in_turns"] = turns
del logical
# K1 on one of this process's shards of the compacted index: against its
# plain version at the phase's tolerance, then timed
sub = next(iter(idx._main._shards.values()))
pl = sub.placement
q_dev = torch.from_numpy(q).to(dev)
qp = ck.pad_queries(q_dev)
args = (qp, pl.th, pl.tl, pl.tnorm)
kern = ck.binned_select(*args, tile_n=ck.TILE_N, arm="bf16x3")
plain = ck.binned_select_plain(*args, tile_n=ck.TILE_N, arm="bf16x3")
tol_q = cs.tolerance_q(q_dev, tmax=pl.db_norm_max)
check = cs.Check()
check.values("cd@span_shard", kern[0], plain[0], tol_q)
check.values("bounds@span_shard", kern[2], plain[2], tol_q)
del kern, plain
n_p, dp = pl.th.shape
res["k1_shard"] = {
    "rows": pl.n_train, "queries": int(qp.shape[0]), "dp": dp,
    "tiles": n_p // ck.TILE_N, "max_abs_err": check.max_abs_err,
    "ms": cs.time_cuda(lambda: ck.binned_select(*args, tile_n=ck.TILE_N,
                                                arm="bf16x3"), 3),
    "plain_ms": cs.time_cuda(lambda: ck.binned_select_plain(
        *args, tile_n=ck.TILE_N, arm="bf16x3"), 1)}
del args, qp, sub, pl, idx, snap
torch.cuda.empty_cache()

# -- IVFIndex on the ivf anchor: every list probed, both selectors
uni = np.ascontiguousarray(db[:65_536])
qu = q_all[:32]
uidx = run("ivf_train", lambda: IVFIndex(uni, k=k, ncentroids=32,
                                         train_iters=2, mesh=mesh))
save("ivf_centroids", uidx._centroids)
for label, kw in (("ivf_exact", {"selector": "exact"}),
                  ("ivf_pallas", {"selector": "pallas"})):
    d, i, st = run(label, lambda kw=kw: uidx.search_certified(
        qu, nprobe=32, **kw))
    save(label, d, i)
    res[label]["groups"] = st["groups"]
del uidx

# -- the IVF tuner: the phase's grid, 8 queries, one run
tune_grid = [{"ncentroids": 32, "nprobe": p} for p in (32, 8)]
entry = run("autotune_ivf", lambda: autotune_ivf(
    uni, q_all[:8], k, mesh=mesh, runs=1, grid=tune_grid,
    selector="pallas", train_iters=2, seed=0))
res["autotune_ivf"]["entry"] = entry

# -- the joins of the 4,096 queries by 1,024 on the main rows
knn = ShardedKNN(db, k=k, mesh=mesh, merge="allgather")
for mode in ("stream", "certified"):
    d, i, st = run(f"join_{mode}", lambda mode=mode: knn_join(
        knn, q_all, mode=mode, superblock_rows=1024))
    save(f"join_{mode}", d, i)
    res[f"join_{mode}"]["superblocks"] = st["superblocks"]
del knn

# -- the certified stream of 2,048 queries in two segments, interrupted
# after its first, then resumed from the segments both processes hold
sdir = os.path.join(out_dir, f"stream_p{pid}")
real = ShardedKNN.search_certified
calls = {"n": 0}


def interrupted(self, *a, **kw):
    calls["n"] += 1
    if calls["n"] == 2:
        raise ValueError("interrupted")
    return real(self, *a, **kw)


def stream():
    ShardedKNN.search_certified = interrupted
    try:
        streaming.streaming_certified_knn(db, q_all[:2048], k, sdir,
                                          segment_size=1024, mesh=mesh)
    except ValueError as e:
        res["stream_interrupted"] = str(e)
    finally:
        ShardedKNN.search_certified = real
    res["stream_done_before_resume"] = sorted(os.listdir(sdir))
    return streaming.streaming_certified_knn(db, q_all[:2048], k, sdir,
                                             segment_size=1024, mesh=mesh)


d, i, st = run("certified_stream", stream)
save("certified_stream", d, i)
res["certified_stream"]["certified"] = st["certified"]

# -- sharded_minmax over the main rows and queries
lo, hi = run("minmax", lambda: sharded_minmax([db, q_all], mesh=mesh))
save("minmax", lo, hi)
res["k1_main_path"] = k1_main
res["foreign"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "knn_tpu"))
multihost.shutdown()
print("RESULT " + json.dumps(res), flush=True)
"""


def spawn_children(script, n_proc, work, tag):
    """``n_proc`` processes of ``script`` (argv: process index, count, a
    free local port, ``work``), each with the repo on its path."""
    import socket

    child = os.path.join(work, f"{tag}.py")
    with open(child, "w") as f:
        f.write(script)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return [subprocess.Popen(
        [sys.executable, child, str(pid), str(n_proc), str(port), work],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(n_proc)]


def stop_children(procs):
    """Stops every child of ``procs`` still running (a phase that failed
    before collecting them)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def collect_children(procs, label, timeout):
    """Each child's ``RESULT`` line; a child that fails, prints none or
    outlives ``timeout`` seconds fails the phase (every child is stopped)."""
    results = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=timeout)
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if p.returncode != 0 or not line:
                raise AssertionError(
                    f"{label} child {len(results)}: rc {p.returncode}, "
                    f"{stderr[-3000:]}")
            results.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def catalog_check(label, name, block):
    """Validate one block this run built through the artifact catalog
    (knn_tpu_torch.analysis.artifacts) in both styles; any violation
    fails the phase."""
    from knn_tpu_torch.analysis import artifacts

    errs = {style: artifacts.validate(name, block, style=style)
            for style in ("legacy", "normalized")}
    if any(errs.values()):
        raise AssertionError(f"catalog: {label} ({name}): {errs}")
    CATALOG_CHECKS.append(f"{label}: {name}")


def bench_line_record(*, n, dim, k, n_q, qps, knobs, kind, recall,
                      commit):
    """One certified call as a line in ``bench.py``'s line shape: the
    shape in the metric name, the rate, the mode, the card, the resolved
    knobs and the batch (written to no file)."""
    return {"metric": f"knn_qps_main_n{n}_d{dim}_k{k}", "value": qps,
            "unit": "queries/s", "mode": "certified_pallas",
            "backend": "cuda", "device_kind": kind, "devices": 1,
            "batch": n_q, "pallas_knobs": dict(knobs),
            "recall_at_k": recall, "measured_at_commit": commit}


def bench_line_checks(record, block):
    """The bench-line half of the catalog on one record and the roofline
    ``block`` its call published: the record valid in both styles;
    ``obs.roofline.block_for_bench_line`` of it the block's bound seconds,
    ceiling, bound class and share; ``curate_line`` refusing nothing and
    hoisting the block's ``roofline_pct`` and ``bound_class``; a non-empty
    ``line_summary``; the sentinel's verdict ``no_baseline`` under the
    record's ``cuda`` key (no H100 history), every curated field it
    carries listed.  Any miss raises."""
    from knn_tpu_torch.analysis import artifacts
    from knn_tpu_torch.obs import roofline, sentinel

    catalog_check("main bench line", "bench_line", record)
    derived = roofline.block_for_bench_line(record)
    bound_s = max(block["term_times_s"].values())
    if derived is None or (
            max(derived["term_times_s"].values()), derived["bound_class"],
            derived["ceiling_qps"], derived["roofline_pct"]) != (
            bound_s, block["bound_class"], block["ceiling_qps"],
            block["roofline_pct"]):
        raise AssertionError(f"bench line: block_for_bench_line "
                             f"{derived and derived['term_times_s']} against "
                             f"the published {block['term_times_s']}")
    curated = json.loads(json.dumps(record))
    refusal = artifacts.curate_line(curated)
    if refusal is not None or not curated["roofline"].get("derived") or (
            curated["roofline_pct"], curated["bound_class"]) != (
            block["roofline_pct"], block["bound_class"]):
        raise AssertionError(f"bench line: curate_line {refusal!r}, hoisted "
                             f"{curated.get('roofline_pct')} / "
                             f"{curated.get('bound_class')}")
    catalog_check("main bench line curated", "bench_line", curated)
    catalog_check("main bench line derived", "roofline", curated["roofline"])
    summary = artifacts.line_summary(curated)
    verdict = sentinel.verdict_for_line(record, repo_dir=str(REPO))
    carried = sorted(f for f, _ in sentinel.CURATED_FIELDS
                     if isinstance(sentinel.curated_value(record, f),
                                   (int, float)))
    if (not summary or verdict["verdict"] != "no_baseline"
            or verdict["baseline_key"] != f"{record['metric']}|cuda|default"
            or sorted(verdict["fields"]) != carried):
        raise AssertionError(f"bench line: summary {summary!r}, sentinel "
                             f"{verdict}")
    catalog_check("main bench line", "sentinel", verdict)
    return {"bound_s": bound_s, "bound_class": block["bound_class"],
            "ceiling_qps": block["ceiling_qps"],
            "roofline_pct": block["roofline_pct"],
            "curated_roofline_pct": curated["roofline_pct"],
            "line_summary": summary, "sentinel": verdict["verdict"],
            "baseline_key": verdict["baseline_key"],
            "sentinel_fields": sorted(verdict["fields"])}


def history_sweep():
    """``artifacts.sweep_records`` over the repo's bench history and
    ``sweep_multichip`` over its MULTICHIP records: the counts
    :data:`HISTORY_SWEEP` / :data:`HISTORY_MULTICHIP`, no problem."""
    from knn_tpu_torch.analysis import artifacts
    from knn_tpu_torch.obs import sentinel

    counts, problems = artifacts.sweep_records(
        list(sentinel.iter_history_lines(str(REPO))))
    mc_n, mc_problems = artifacts.sweep_multichip(str(REPO))
    got = {name: c["validated"] for name, c in counts.items()
           if c["validated"]}
    if (problems or mc_problems or got != HISTORY_SWEEP
            or mc_n != HISTORY_MULTICHIP):
        raise AssertionError(f"history sweep: {got}, {mc_n} multichip, "
                             f"problems {(problems + mc_problems)[:3]}")
    return {"validated": got, "multichip_records": mc_n}


def lint_phase():
    """``python -m knn_tpu_torch.cli lint --json`` in a subprocess with no
    card visible: exit 0, no finding, the five registered checkers, at
    least one justified suppression."""
    from knn_tpu_torch import analysis

    t0 = time.perf_counter()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "knn_tpu_torch.cli", "lint", "--json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    try:
        rep = json.loads(proc.stdout)
    except json.JSONDecodeError:
        rep = {}
    if (proc.returncode != 0 or rep.get("findings") != []
            or sorted(rep.get("checkers") or ()) != sorted(analysis.CHECKERS)
            or len(analysis.CHECKERS) != 5
            or not rep.get("suppressed", 0) >= 1):
        raise AssertionError(f"lint: rc {proc.returncode}, "
                             f"{proc.stdout[-3000:]} {proc.stderr[-3000:]}")
    return {"phase": "lint", "rc": proc.returncode,
            "checkers": rep["checkers"], "findings": len(rep["findings"]),
            "suppressed": rep["suppressed"],
            "seconds": time.perf_counter() - t0}


def lock_order_hammer(queue, frontend, pool, named, eager_fns, *,
                      calls=(), threads=8, requests=4, before=None,
                      during=None):
    """The lock-order hammer over one serving stack: the locks ``named``
    (name -> object, or (object, attribute)) instrumented with one
    knn_tpu_torch.analysis.lockorder recorder; ``threads`` threads meet
    at a barrier before each of ``requests`` rounds, and in a round each
    submits one request of 1-8 rows of ``pool`` (disjoint slices) through
    ``queue``, runs ``calls`` and waits for its request, so the queue
    forms at least one batch a round.  ``before`` runs once the locks are
    instrumented, ``during`` after the rounds while they still are (its
    return value is returned as ``during``).  Every batch the queue hands
    ``frontend.submit`` in the rounds is recorded, and each request's
    result must equal, bit for bit, its rows of one of ``eager_fns``
    applied to its batch (an eager search of the batch padded to its
    rung; two where a swap may fall between dispatches).  No thread may
    raise, every instrumented lock must be taken, and the order graph
    must hold edges and no cycle.  The locks are restored after.  Returns
    the edge count, the edges, the locks seen and the batches."""
    import threading

    from knn_tpu_torch.analysis.lockorder import LockOrderRecorder, instrument

    rec = LockOrderRecorder()
    saved = []
    for name, obj in named.items():
        target, attrs = ((obj[0], (obj[1],)) if isinstance(obj, tuple)
                         else (obj, ("_lock", "_cond")))
        attr = next(a for a in attrs if getattr(target, a, None) is not None)
        saved.append((target, attr, getattr(target, attr)))
    batches = []
    real_submit = frontend.submit

    def recording_submit(q, **kw):
        batches.append(np.array(q, copy=True))
        return real_submit(q, **kw)

    def rows_of(i, j):
        lo = 8 * (i * requests + j)
        return pool[lo:lo + 1 + (i + j) % 8]

    barrier = threading.Barrier(threads)
    results, errors, out_lock = {}, [], threading.Lock()

    def run(i):
        try:
            for j in range(requests):
                barrier.wait(120)
                fut = queue.submit(rows_of(i, j))
                for fn in calls:
                    fn()
                res = fut.result(timeout=120)
                with out_lock:
                    results[(i, j)] = res
        except BaseException as e:  # noqa: BLE001 — raised below
            with out_lock:
                errors.append(e)
            barrier.abort()

    frontend.submit = recording_submit
    instrument(rec, **named)
    during_out = None
    try:
        try:
            if before is not None:
                before()
            ts = [threading.Thread(target=run, args=(i,),
                                   name=f"hammer-{i}")
                  for i in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        finally:
            del frontend.submit
        if not errors and during is not None:
            during_out = during()
    finally:
        for target, attr, lock in saved:
            setattr(target, attr, lock)
    if errors:
        raise AssertionError(f"lock order: a hammer thread raised: "
                             f"{errors[:3]!r}")
    missing = sorted(set(named) - rec.seen())
    if missing:
        raise AssertionError(f"lock order: instrumented locks never taken: "
                             f"{missing}")
    if len(batches) < requests:
        raise AssertionError(f"lock order: {len(batches)} batches for "
                             f"{requests} rounds")
    edges = rec.edges()
    if not edges:
        raise AssertionError("lock order: the hammer recorded no lock "
                             "interleaving")
    rec.assert_acyclic()
    where = {}
    for b, cat in enumerate(batches):
        for off in range(cat.shape[0]):
            where.setdefault(cat[off].tobytes(), (b, off))
    wants = {}
    for (i, j), res in sorted(results.items()):
        rows = rows_of(i, j)
        b, off = where[rows[0].tobytes()]
        if not np.array_equal(batches[b][off:off + rows.shape[0]], rows):
            raise AssertionError(f"lock order: request {(i, j)} is not a "
                                 f"slice of its batch")
        if b not in wants:
            wants[b] = [fn(batches[b]) for fn in eager_fns]
        if not any(all(np.array_equal(x, y[off:off + rows.shape[0]])
                       for x, y in zip(res, want)) for want in wants[b]):
            raise AssertionError(f"lock order: request {(i, j)} differs "
                                 f"from the eager search of its batch")
    return {"edges": len(edges),
            "edge_list": sorted(f"{a}->{b}" for a, b in edges),
            "locks_seen": sorted(rec.seen()),
            "locks_instrumented": sorted(named),
            "requests": len(results), "batches": len(batches),
            "batch_rows": [int(c.shape[0]) for c in batches],
            "during": during_out}


def tier_lock_order(tier, pool):
    """The lock-order hammer over the host-RAM tier, the one placement
    that takes ShardedKNN._tier_lock: 8 threads x 4 rounds, each
    thread a search of 1-8 rows straight through ``tier.search`` (the
    tier serves no queue or graph), then compile_cache_stats(),
    hosttier_stats() and the SLO engine's evaluate(), with the tier's
    _tier_lock and _engines_lock, the registry, the sweep histogram
    and the SLO engine instrumented; every search bitwise the same
    rows' search run alone."""
    import concurrent.futures

    from knn_tpu_torch import obs
    from knn_tpu_torch.obs import names as mn

    def search(rows):
        return tuple(t.cpu().numpy() for t in tier.search(rows))

    class Direct:
        """A queue and frontend in one: each request answered at once
        by ``search``."""

        def submit(self, rows):
            fut = concurrent.futures.Future()
            fut.set_result(search(rows))
            return fut

    t0 = time.perf_counter()
    direct = Direct()
    slo_eng = obs.reset_slo_engine()
    try:
        out = lock_order_hammer(
            direct, direct, pool,
            {"tier": (tier, "_tier_lock"),
             "engines": (tier, "_engines_lock"),
             "registry": obs.get_registry(),
             "sweep_hist": obs.histogram(mn.HOSTTIER_SWEEP_SECONDS),
             "slo": slo_eng},
            [search], calls=(tier.compile_cache_stats,
                             tier.hosttier_stats, slo_eng.evaluate))
    finally:
        obs.reset_slo_engine()
    out["elapsed_s"] = time.perf_counter() - t0
    return out


def emit(obj: dict) -> None:
    """Prints one JSON line; a phase line also gets the seconds since the
    script started (``elapsed_s``)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Check:
    """Accumulates the largest kernel-vs-plain error seen."""

    def __init__(self):
        self.max_abs_err = 0.0

    def values(self, name, kern, plain, tol_q):
        """Kernel vs plain scores: pad-scale values by class, +inf exactly,
        the rest within the per-query tolerance."""
        import torch

        pad_p = plain >= PAD_SCALE
        pad_k = kern >= PAD_SCALE
        if not torch.equal(pad_p, pad_k):
            raise AssertionError(f"{name}: pad-scale entries differ")
        if not torch.equal(torch.isinf(plain), torch.isinf(kern)):
            raise AssertionError(f"{name}: +inf entries differ")
        real = ~pad_p
        err = torch.where(real, (kern - plain).abs(), 0.0)
        worst = float(err.max())
        over = err > tol_q[:, None]
        if bool(over.any()):
            raise AssertionError(
                f"{name}: {int(over.sum())} entries over tolerance, max "
                f"error {worst:.4g}")
        self.max_abs_err = max(self.max_abs_err, worst)
        return worst


def tolerance_q(q, db=None, tmax=None, arm="bf16x3"):
    """Per-query kernel-vs-plain tolerance, as f32 on q's device:
    coarse_knn.kernel_plain_tolerance_scale (||q||^2 + M), M =
    max||t||^2 -- for bf16x3 and bf16x3f the proved sum of the tensor-core
    summation's bound and the plain version's (csrc/binned_mma.cuh); 64
    eps_f32 for default, whose kernel and plain version sum f32 products
    in different orders; for highest, whose two differ only in the order
    of each chunk's f64 sum, (2 nd + 4) u, u = 2^-24, nd = 128-dim chunks:
    the chunk sums round to f32 at most an ulp apart, each f32 chunk
    addition and the rounding of s add at most one more.  ``tmax`` plugs
    in a precomputed M (a placement's ``db_norm_max``) in place of
    ``db``."""
    from knn_tpu_torch.ops.coarse_knn import kernel_plain_tolerance_scale

    q64 = q.double()
    qn = (q64 * q64).sum(-1)
    if tmax is None:
        tmax = float((db.double() ** 2).sum(-1).max())
    scale = kernel_plain_tolerance_scale(arm, -(-q.shape[1] // 128))
    return (scale * (qn + tmax)).float()


def check_ci(name, kern, plain, tol_q, n_tiles):
    """ci of the kernel equal to the plain version's wherever the slot's
    value is separated from its neighbours in the bin's sorted order
    (survivor j vs j-1, j+1, and the bound), and wherever the plain
    version padded a skipped tile (+inf).  Returns the slots checked."""
    import torch

    from knn_tpu_torch.ops.coarse_knn import BIN_W

    n_q = kern[0].shape[0]
    survivors = kern[0].shape[1] // (n_tiles * BIN_W)
    cd_p = plain[0].view(n_q, n_tiles, survivors, BIN_W)
    bd_p = plain[2].view(n_q, n_tiles, 1, BIN_W)
    seq = torch.cat([cd_p, bd_p], dim=2)  # [Q, T, S+1, 128] ascending
    gap = (seq[:, :, 1:] - seq[:, :, :-1]).abs()
    tol4 = tol_q[:, None, None, None]
    sep = torch.ones_like(cd_p, dtype=torch.bool)
    sep &= gap[:, :, :survivors] > tol4  # above the next value
    sep[:, :, 1:] &= gap[:, :, : survivors - 1] > tol4  # below the previous
    sep &= torch.isfinite(cd_p)
    sep |= torch.isinf(cd_p)
    ci_k = kern[1].view(n_q, n_tiles, survivors, BIN_W)
    ci_p = plain[1].view(n_q, n_tiles, survivors, BIN_W)
    mism = int((sep & (ci_k != ci_p)).sum())
    if mism:
        raise AssertionError(f"{name} ci: {mism} separated slots differ")
    return int(sep.sum())


def compare_k1(checks, q, db, tile_n):
    """K1 and K10 against their plain version (the same function) on one
    input, K10 bitwise against K1, and K1's exclusion bound against
    float64 scores; returns a summary dict."""
    import torch

    from knn_tpu_torch.ops.coarse_knn import (BIN_W, binned_select,
                                              binned_select_plain,
                                              kernel_tolerance, pad_queries,
                                              prepare_db, stream_select)

    th, tl, tnorm = prepare_db(db, tile_n)
    qp = pad_queries(q)
    ops = (qp, th, tl, tnorm)
    kern = binned_select(*ops, tile_n=tile_n, arm="bf16x3")
    k10 = stream_select(*ops, tile_n=tile_n, arm="bf16x3")
    plain = binned_select_plain(*ops, tile_n=tile_n, arm="bf16x3")
    torch.cuda.synchronize()
    tol_q = tolerance_q(q, db)
    n_q = q.shape[0]
    n_tiles = th.shape[0] // tile_n
    out = {"q": n_q, "rows": db.shape[0], "dim": db.shape[1],
           "tile_n": tile_n}
    for key, res in (("k1", kern), ("k10", k10)):
        out[f"{key}_max_abs_err_cd"] = checks[key].values(
            f"{key} cd", res[0], plain[0], tol_q)
        out[f"{key}_max_abs_err_bounds"] = checks[key].values(
            f"{key} bounds", res[2], plain[2], tol_q)
        out[f"{key}_ci_separated_checked"] = check_ci(key, res, plain, tol_q,
                                                      n_tiles)
    if not all(torch.equal(a, b) for a, b in zip(k10, kern)):
        raise AssertionError("K10's outputs are not bitwise equal to K1's")
    out["k10_bitwise_k1"] = True
    # soundness: every real row that is not a candidate scores (f64) >= its
    # bin bound - kernel_tolerance
    n = db.shape[0]
    q64, db64 = q.double(), db.double()
    s64 = (db64 * db64).sum(-1)[None, :] - 2.0 * q64 @ db64.T  # [Q, N]
    cand = torch.zeros((n_q, th.shape[0] + 1), dtype=torch.bool,
                       device=q.device)
    cand.scatter_(1, kern[1].long().clamp(max=th.shape[0]), True)
    cand = cand[:, :n]
    rows = torch.arange(n, device=q.device)
    bound = kern[2][:, (rows // tile_n) * BIN_W + rows % BIN_W].double()
    ktol = torch.from_numpy(kernel_tolerance(
        q.cpu().numpy(), db.cpu().numpy(), precision="bf16x3")).to(q.device)
    viol = (~cand) & (s64 < bound - ktol[:, None])
    if bool(viol.any()):
        raise AssertionError(f"exclusion bound unsound at {int(viol.sum())} rows")
    out["soundness_rows_checked"] = int((~cand).sum())
    return out


def compare_k11(check, q, db, tile_n, keep, parts=None, arm="bf16x3",
                plain=None):
    """The fused entry of f32-family arm ``arm`` (K11 for bf16x3) against
    its plain version at the kernel's own geometry (query block, tile
    segments): the same skipped (block, tile) cells, cd and bounds within
    the tolerance, ci equal on separated and skipped slots.  ``parts``
    plugs in prepared db operands, ``plain`` a precomputed plain output
    (the fused plain version at this geometry).  Returns a summary
    dict."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    if parts is None:
        parts = ck.prepare_db_arm(db, tile_n, arm)
    qp = ck.pad_queries(q)
    n_tiles = parts[0].shape[0] // tile_n
    block_q = ck.QUERY_BLOCK
    seg = ck.kernel_segment_tiles(q.shape[0], n_tiles, q.device, "fused", arm)
    kern = ck.fused_select(qp, *parts, tile_n=tile_n, keep=keep, arm=arm)
    if plain is None:
        plain = ck.fused_select_plain(qp, *parts, tile_n=tile_n, keep=keep,
                                      block_q=block_q, seg_tiles=seg, arm=arm)
    torch.cuda.synchronize()
    skip = ck.skipped_cells(kern[0], n_tiles, block_q)
    if not torch.equal(skip, ck.skipped_cells(plain[0], n_tiles, block_q)):
        raise AssertionError(
            f"fused {arm} skipped other cells than its plain version")
    tol_q = tolerance_q(q, db, arm=arm)
    name = f"fused_{arm}"
    return {"arm": arm, "q": q.shape[0], "rows": db.shape[0],
            "dim": db.shape[1], "tile_n": tile_n, "keep": keep,
            "block_q": block_q, "seg_tiles": seg,
            "skipped_cells": int(skip.sum()), "cells": skip.numel(),
            "max_abs_err_cd": check.values(f"{name} cd", kern[0], plain[0],
                                           tol_q),
            "max_abs_err_bounds": check.values(f"{name} bounds", kern[2],
                                               plain[2], tol_q),
            "ci_checked": check_ci(name, kern, plain, tol_q, n_tiles)}


def compare_f32(checks, arm, q, db, tile_n, keep):
    """The tiled, streaming and fused entries of f32-family arm ``arm``
    against their plain versions on one input (the fused one at its own
    geometry), the streaming and db-major tiled outputs bitwise the tiled
    ones; returns a summary dict."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    parts = ck.prepare_db_arm(db, tile_n, arm)
    qp = ck.pad_queries(q)
    ops = (qp, *parts)
    tiled = ck.binned_select(*ops, tile_n=tile_n, arm=arm)
    plain = ck.binned_select_plain(*ops, tile_n=tile_n, arm=arm)
    torch.cuda.synchronize()
    n_tiles = parts[0].shape[0] // tile_n
    tol_q = tolerance_q(q, db, arm=arm)
    out = {"arm": arm, "q": q.shape[0], "rows": db.shape[0],
           "dim": db.shape[1], "tile_n": tile_n,
           "tolerance_max": float(tol_q.max())}
    err = max(checks[f"tiled_{arm}"].values(f"tiled_{arm} cd", tiled[0],
                                            plain[0], tol_q),
              checks[f"tiled_{arm}"].values(f"tiled_{arm} bounds", tiled[2],
                                            plain[2], tol_q))
    out["max_abs_err"] = err
    out["ci_separated_checked"] = check_ci(f"tiled_{arm}", tiled, plain,
                                           tol_q, n_tiles)
    for key, got in (("streaming", ck.stream_select(*ops, tile_n=tile_n,
                                                    arm=arm)),
                     ("db_major", ck.binned_select(*ops, tile_n=tile_n,
                                                   arm=arm,
                                                   grid_order="db_major"))):
        bitwise(f"{key}_{arm} vs tiled", got, tiled)
        checks[f"{key}_{arm}"].max_abs_err = max(
            checks[f"{key}_{arm}"].max_abs_err, err)
        out[f"{key}_bitwise_tiled"] = True
    out["fused"] = compare_k11(checks[f"fused_{arm}"], q, db, tile_n, keep,
                               parts=parts, arm=arm)
    return out


def score_error_ratio(q, db, arm, db_norm_max=None, tile_n=16384):
    """The largest |s_kernel - s_f64| / tolerance over the candidates the
    tiled entry of arm ``arm`` emits for queries ``q`` against ``db``
    (tolerance = the certificate's, coarse_knn.kernel_tolerance; s_f64 =
    ||t||^2 - 2 q.t of the f32 values in float64)."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    parts = ck.prepare_db_arm(db, tile_n, arm)
    cd, ci, _ = ck.binned_select(ck.pad_queries(q), *parts, tile_n=tile_n,
                                 arm=arm)
    q64, db64 = q.double(), db.double()
    s64 = (db64 * db64).sum(-1)[None, :] - 2.0 * (q64 @ db64.T)
    real = ci < db.shape[0]
    got = torch.gather(s64, 1, torch.where(real, ci, 0).long())
    tol = torch.from_numpy(ck.kernel_tolerance(
        q.cpu().numpy(), db.cpu().numpy(), precision=arm,
        db_norm_max=db_norm_max)).to(q.device)
    ratio = torch.where(real, (cd.double() - got).abs(), 0.0) / tol[:, None]
    return float(ratio.max())


def header_bound_ratio(dev, arm, kernel, n_q=64, n=512, dim=896):
    """The largest |s_kernel - s_ref| / bound over every db row, for the
    ``kernel`` entry of f32-family arm ``arm`` on all-positive data at
    Dp = 896 (7 chunks, every product positive: the chains' worst shape).
    s_ref is the exact f64 score of the kernel's own operands (the bf16
    parts' three products, or the f32 values' one); the bound is the
    headers' worst case for the arm's qt (coarse_knn.
    accumulation_coefficient: csrc/binned_mma.cuh for bf16x3 and bf16x3f,
    csrc/binned_select.cuh for highest), doubled in s, plus the
    rounding of s.  With ``tile_n = 128`` every tile is one
    group, so every row's score is survivor 0 of its bin."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.uniform(1.0, 2.0, size=(n_q, dim))
                         .astype(np.float32)).to(dev)
    db = torch.from_numpy(rng.uniform(1.0, 2.0, size=(n, dim))
                          .astype(np.float32)).to(dev)
    qp = ck.pad_queries(q)
    parts = ck.prepare_db_arm(db, ck.BIN_W, arm)
    nd = qp.shape[1] // ck.DIM_CHUNK
    b_qt = ck.accumulation_coefficient(arm, nd)
    if arm == "highest":
        pairs = [(qp, parts[0])]
    else:
        qh, ql = ck.split_bf16(qp)
        pairs = [(qh, parts[0]), (qh, parts[1]), (ql, parts[0])]
    qt = sum(a.double() @ b.double().T for a, b in pairs)
    p = sum(a.double().abs() @ b.double().abs().T for a, b in pairs)
    s_ref = parts[-1][0].double()[None, :] - 2.0 * qt
    bound = 2 * b_qt * U32 * p * (1 + U32) + U32 * s_ref.abs()
    fn = {"tiled": ck.binned_select, "streaming": ck.stream_select,
          "fused": ck.fused_select}[kernel]
    kw = {"keep": 15} if kernel == "fused" else {}
    cd, ci, _ = fn(qp, *parts, tile_n=ck.BIN_W, arm=arm, **kw)
    real = ci < n
    if kernel != "fused" and not bool(
            real.view(n_q, -1, ck.SURVIVORS, ck.BIN_W)[:, :, 0].all()):
        raise AssertionError(f"{kernel}_{arm}: a row's score is missing")
    rows = torch.where(real, ci, 0).long()
    err = (cd.double() - torch.gather(s_ref, 1, rows)).abs()
    return float(torch.where(real, err / torch.gather(bound, 1, rows),
                             0.0).max())


def default_plain_ratio(dev, dim, data, n_q=64, n=2048):
    """K3's tiled, streaming and fused (disarmed) entries against their
    plain version at Dp = round_up(dim, 128): the largest |s_kernel -
    s_plain| over every row's score, per unit of the proved tolerance
    (coarse_knn.kernel_plain_tolerance_scale("default", nd) (||q||^2 + M))
    and of the 128 u (||q||^2 + M) the port allowed before it was proved.
    ``data`` "all_positive" (q, t in [1, 2): every partial sum grows, the
    chains' worst shape) or "normal".  With ``tile_n = 128`` every tile is
    one group, so every row's score is survivor 0 of its bin, in both."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    rng = np.random.default_rng(dim + len(data))
    draw = ((lambda shape: rng.uniform(1.0, 2.0, size=shape))
            if data == "all_positive" else
            (lambda shape: rng.normal(size=shape) * 10))
    q = torch.from_numpy(draw((n_q, dim)).astype(np.float32)).to(dev)
    db = torch.from_numpy(draw((n, dim)).astype(np.float32)).to(dev)
    qp = ck.pad_queries(q)
    parts = ck.prepare_db_arm(db, ck.BIN_W, "default")
    ka = {"tile_n": ck.BIN_W, "arm": "default"}
    plain = ck.binned_select_plain(qp, *parts, **ka)
    q64 = q.double()
    scale = (q64 * q64).sum(-1) + float((db.double() ** 2).sum(-1).max())
    nd = qp.shape[1] // ck.DIM_CHUNK
    out = {"dim": dim, "data": data}
    for kern, fn, kw in (("tiled", ck.binned_select, {}),
                         ("streaming", ck.stream_select, {}),
                         ("fused", ck.fused_select, {"keep": None})):
        cd, ci, _ = fn(qp, *parts, **ka, **kw)
        if not torch.equal(ci, plain[1]):
            raise AssertionError(f"K3 {kern} at Dp={qp.shape[1]}: rows differ")
        real = ci < n
        err = torch.where(real, (cd.double() - plain[0].double()).abs(),
                          0.0).amax(-1) / scale
        out[kern] = {
            "error_over_tolerance": float(err.max()) / ck.
            kernel_plain_tolerance_scale("default", nd),
            "error_over_128u": float(err.max()) / (128 * U32)}
        if out[kern]["error_over_tolerance"] > 1.0:
            raise AssertionError(f"K3 {kern} past its proved tolerance: {out}")
    return out


def pq_bound_ratio(dev, kernel, n_q=64, n=1024, m=196, dsub=4, ncodes=256):
    """The largest |s_kernel - s_ref| / bound over every real row for K7's
    ``kernel`` entry at ``m`` subspaces (196: 784 dims), on rows that are
    their own reconstruction (residuals 0) and all-nonnegative LUT entries
    (q in [1, 2], codebook values in [0, 1]: every partial sum of the
    chain grows).  s_ref is the exact f64 score ||t||^2 - 2 q.t; the bound
    is csrc/binned_pq.cuh's worst case, ops.pq.k7_rounding (||q||^2 +
    2 M) (norm_err_max is 0 here).  With ``tile_n = 128`` every row's
    score is survivor 0 of its bin."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck
    from knn_tpu_torch.ops import pq as ppq

    rng = np.random.default_rng(m)
    books = rng.uniform(0.0, 1.0, size=(m, ncodes, dsub)).astype(np.float32)
    codes = rng.integers(0, ncodes, size=(n, m)).astype(np.uint8)
    q = rng.uniform(1.0, 2.0, size=(n_q, m * dsub)).astype(np.float32)
    t64 = ppq.reconstruct(books, codes, m * dsub, dsub).astype(np.float64)
    q64 = q.astype(np.float64)
    tn = (t64 ** 2).sum(-1)
    s_ref = torch.from_numpy(tn[None, :] - 2.0 * (q64 @ t64.T)).to(dev)
    bound = torch.from_numpy(ppq.k7_rounding(m, dsub) * (
        (q64 ** 2).sum(-1) + 2.0 * tn.max())).to(dev)
    lut = ck.pq_luts(torch.from_numpy(q).to(dev),
                     torch.from_numpy(books).to(dev))
    parts = ck.prepare_db_pq(torch.from_numpy(codes).to(dev), ck.BIN_W)
    fn = {"tiled": ck.binned_select, "streaming": ck.stream_select}[kernel]
    cd, ci, _ = fn(lut, *parts, tile_n=ck.BIN_W, arm="pq")
    real = ci < n
    if not bool(real.view(n_q, -1, ck.SURVIVORS, ck.BIN_W)[:, :, 0].all()):
        raise AssertionError(f"{kernel}_pq: a row's score is missing")
    rows = torch.where(real, ci, 0).long()
    err = (cd.double() - torch.gather(s_ref, 1, rows)).abs()
    return float(torch.where(real, err / bound[:, None], 0.0).max())


def fault18_ratios(dev, dim, arm, n_q=64, n=1024):
    """Fault 18's construction on the card: queries and rows whose every
    value is one of the f32 values in [1, 1 + 2^-8) whose bf16 split errs
    most (the split's error in s nears half of 2^-14 (||q||^2 + M)).  For
    every entry of ``arm`` (bf16x3 or bf16x3f: tiled in both grids,
    streaming, fused, lane tiled and streaming) the largest |s_kernel -
    s_f64| over the certificate's tolerance (coarse_knn.kernel_tolerance)
    and over the reference's 2^-14 (||q||^2 + M), over every emitted
    candidate; raises when the first passes 1."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    one = np.float32(1.0).view(np.int32)
    x = (one + np.arange(2 ** 15, dtype=np.int32)).view(np.float32)
    xh, xl = (a.double().numpy() for a in ck.split_bf16(torch.from_numpy(x)))
    x64 = x.astype(np.float64)
    vals = x[np.argsort(-(x64 * x64 - (xh * xh + 2 * xh * xl)))[:8]]
    rng = np.random.default_rng(dim)
    q = vals[rng.integers(0, 8, size=(n_q, dim))]
    db = vals[rng.integers(0, 8, size=(n, dim))]
    q64, db64 = q.astype(np.float64), db.astype(np.float64)
    s64 = torch.from_numpy((db64 ** 2).sum(-1)[None, :]
                           - 2.0 * q64 @ db64.T).to(dev)
    scale = (q64 ** 2).sum(-1) + (db64 ** 2).sum(-1).max()
    tol = torch.from_numpy(ck.kernel_tolerance(q, db, precision=arm)).to(dev)
    old = torch.from_numpy(2.0 ** -14 * scale).to(dev)
    qp = ck.pad_queries(torch.from_numpy(q).to(dev))
    th, tl, tnorm = ck.prepare_db(torch.from_numpy(db).to(dev), ck.BIN_W)
    out = {}
    for name, fn, kw in (
            ("tiled", ck.binned_select, {}),
            ("db_major", ck.binned_select, {"grid_order": "db_major"}),
            ("streaming", ck.stream_select, {}),
            ("fused", ck.fused_select, {"keep": None}),
            ("lane_tiled", ck.binned_select, {"binning": "lane"}),
            ("lane_streaming", ck.stream_select, {"binning": "lane"})):
        cd, ci, _ = fn(qp, th, tl, tnorm, tile_n=ck.BIN_W, arm=arm, **kw)
        real = ci < n
        err = torch.where(real, (cd.double() - torch.gather(
            s64, 1, torch.where(real, ci, 0).long())).abs(), 0.0).amax(-1)
        out[name] = {"error_over_tolerance": float((err / tol).max()),
                     "error_over_2^-14": float((err / old).max())}
        if out[name]["error_over_tolerance"] > 1.0:
            raise AssertionError(f"fault 18 case, {arm} {name} at Dp={dim}: "
                                 f"{out[name]}")
    return out


def far_tile_case(dev, n_q=4096, tile_n=16384, n_tiles=8, dim=16):
    """tests/test_fused_overlap.py:87-89 scaled up: every query sits near a
    row of tiles 0-1; tile t >= 2 is shifted by 500 t, so each segment's
    later tiles are far above its carry and skip."""
    import torch

    rng = np.random.default_rng(7)
    db = rng.normal(size=(n_tiles * tile_n, dim)).astype(np.float32)
    for t in range(2, n_tiles):
        db[t * tile_n : (t + 1) * tile_n] += 500.0 * t
    q = (db[rng.integers(0, 2 * tile_n, size=n_q)]
         + rng.normal(size=(n_q, dim)).astype(np.float32) * 1e-2)
    return torch.from_numpy(q).to(dev), torch.from_numpy(db).to(dev)


def f64_oracle(q, db, k, chunk=4096):
    """Exact lexicographic top-k on the card: float64 direct differences,
    (distance, index) order."""
    import torch

    from knn_tpu_torch.ops.topk import merge_topk

    q64 = q.double()
    best_d = torch.full((q.shape[0], k), torch.inf, dtype=torch.float64,
                        device=q.device)
    best_i = torch.full((q.shape[0], k), 2 ** 62, dtype=torch.int64,
                        device=q.device)
    for lo in range(0, db.shape[0], chunk):
        t = db[lo : lo + chunk].double()
        diff = q64[:, None, :] - t[None, :, :]
        d = (diff * diff).sum(-1)
        idx = torch.arange(lo, lo + t.shape[0], device=q.device).expand_as(d)
        best_d, best_i = merge_topk(best_d, best_i, d, idx, k)
    return best_d, best_i


def time_cuda(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_timed(fn):
    """(fn(), seconds) on the host clock, the card synchronized before and
    after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pq_case(dev, n_q, n, m, ncodes, tile_n, seed, ties=()):
    """A random LUT [n_q, m*ncodes] and codes [n, m] with exact ties (rows
    3 and 90 equal to row 10 of one 128-row bin, rows 128-159 equal to
    rows 0-31, and the (to, from) slices ``ties`` names), padded for
    ``tile_n``: the pq entries' operands."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    rng = np.random.default_rng(seed)
    lut = (rng.normal(size=(n_q, m * ncodes)) * 10).astype(np.float32)
    codes = rng.integers(0, ncodes, size=(n, m)).astype(np.uint8)
    codes[3] = codes[90] = codes[10]
    codes[128:160] = codes[:32]
    for dst, src in ties:
        codes[dst] = codes[src]
    return (torch.from_numpy(lut).to(dev),
            *ck.prepare_db_pq(torch.from_numpy(codes).to(dev), tile_n))


def lattice_case(dev, n=65_536, dim=128, n_q=4096, seed=3):
    """Rows whose every 4-dim subspace takes one of 256 fixed integer
    points (the codes drawn uniformly), and queries uniform over the same
    box: the farthest-point init recovers the points exactly, so the pq
    residuals are 0 and ε is the f32 terms alone."""
    rng = np.random.default_rng(seed)
    m = dim // 4
    rows = np.empty((n, dim), np.float32)
    for s in range(m):
        pts = rng.permutation(16 ** 4)[:256]
        pts = np.stack([pts // 16 ** j % 16 for j in range(4)], 1)
        rows[:, 4 * s : 4 * s + 4] = pts[rng.integers(0, 256, size=n)]
    q = (rng.random((n_q, dim)) * 16.0).astype(np.float32)
    return rows, q


#: (survivors, bin_w) of the lane phase's small cases: every survivor
#: count, every bin width of a 512-row tile
#: the grouped survivor counts the deep builds are checked and timed at on
#: the main placement: one per build of csrc/binned_select.cuh's table and
#: its edges; the small shapes take every count but the two-survivor one
SURVIVOR_COUNTS = (1, 3, 4, 5, 8)
SMALL_SURVIVOR_COUNTS = (1, 3, 4, 5, 6, 7, 8)
LANE_GEOMETRIES = ((1, 128), (2, 128), (2, 256), (3, 512), (4, 128),
                   (5, 256), (6, 512), (7, 128), (8, 256), (8, 512))


def check_ci_lane(name, kern, plain, tol_q, geo):
    """check_ci for lane binning at geometry ``geo``: ci of the kernel
    equal to the plain version's wherever the survivor's value is apart
    from its neighbours in the bin's order (the previous survivor, the
    next one, the bound) by more than the tolerance.  Returns the slots
    checked."""
    import torch

    n_bins, surv, out_w, bound_w = geo
    n_q = kern[0].shape[0]
    n_tiles = kern[0].shape[1] // out_w

    def bins(x):
        return x.view(n_q, n_tiles, out_w)[:, :, : n_bins * surv].reshape(
            n_q, n_tiles, surv, n_bins)

    vals = bins(plain[0])
    bnd = plain[2].view(n_q, n_tiles, bound_w)[:, :, None, :n_bins]
    seq = torch.cat([vals, bnd], dim=2)
    gap = (seq[:, :, 1:] - seq[:, :, :-1]).abs()
    tol4 = tol_q[:, None, None, None]
    sep = gap[:, :, :surv] > tol4
    sep[:, :, 1:] &= gap[:, :, : surv - 1] > tol4
    sep &= torch.isfinite(vals)
    sep |= torch.isinf(vals)
    mism = int((sep & (bins(kern[1]) != bins(plain[1]))).sum())
    if mism:
        raise AssertionError(f"{name} ci: {mism} separated slots differ")
    return int(sep.sum())


def lane_scores_equal_grouped(name, lane, grouped, n_rows, rows=None):
    """Raises unless every row that both the lane and the grouped output
    emit carries the bitwise same score in both (query rows ``rows``, all
    by default, 64 at a time); returns the rows compared."""
    import torch

    n_q = lane[0].shape[0]
    rows = range(n_q) if rows is None else rows
    common = 0
    for lo in range(rows.start, rows.stop, 64):
        sl = slice(lo, min(lo + 64, rows.stop))
        g = torch.full((sl.stop - sl.start, n_rows + 1), torch.nan,
                       device=lane[0].device)
        g.scatter_(1, grouped[1][sl].long().clamp(max=n_rows), grouped[0][sl])
        li = lane[1][sl].long().clamp(max=n_rows)
        got = torch.gather(g, 1, li)
        both = (li < n_rows) & ~torch.isnan(got)
        if not torch.equal(lane[0][sl][both].view(torch.int32),
                           got[both].view(torch.int32)):
            raise AssertionError(f"{name}: a lane score differs from the "
                                 f"grouped score of its row")
        common += int(both.sum())
    if common == 0:
        raise AssertionError(f"{name}: no row emitted by both")
    return common


def wide_ties(tile_n, n):
    """(to, from) row slices tying rows 0-31 of each tile's first group to
    the same lanes of its last group and, past 256 groups (the packed deep
    builds' 8-bit group indices), of groups 255 and 256."""
    ties = []
    for t0 in range(0, n - tile_n + 1, tile_n):
        groups = [tile_n // 128 - 1] + ([255, 256] if tile_n > 256 * 128
                                        else [])
        ties += [(slice(t0 + g * 128, t0 + g * 128 + 32),
                  slice(t0, t0 + 32)) for g in groups]
    return ties


def int_case(dev, arm, n_q, n, dim, tile_n, seed, ties=()):
    """Integer rows in the uint8 range with exact ties (rows 0-31 copied
    into the next two 128-row groups and the (to, from) slices ``ties``
    names, four queries equal to db rows), quantized on the fly at the
    uint8 shift: the int entries' operands."""
    import torch

    from knn_tpu_torch.ops import coarse_knn as ck

    rng = np.random.default_rng(seed)
    db = rng.integers(0, 256, size=(n, dim)).astype(np.float32)
    for lo in (128, 256):
        db[lo : lo + 32] = db[:32]
    for dst, src in ties:
        db[dst] = db[src]
    q = rng.integers(0, 256, size=(n_q, dim)).astype(np.float32)
    q[:4] = db[:4]
    qi, qsc = ck.quantize_queries(torch.from_numpy(q).to(dev), 128.0)
    t, aux = ck.prepare_db_int(torch.from_numpy(db).to(dev), tile_n, arm,
                               128.0)
    return qi, qsc, t, aux


def held(name, d, i, st, rd, ri, rst):
    """Raises unless the certified indices ``i`` are bitwise the
    reference's ``ri`` and every row whose distances differ is one that
    either placement repaired: a repaired query carries float64 distances,
    which f32 cannot represent, a certified one f32 direct differences.
    There the distances must be within RANK_SLACK, equal where both are
    float64.  Returns the rows whose d differ."""
    from knn_tpu_torch.ops.coarse_knn import RANK_SLACK

    if not np.array_equal(i, ri):
        raise AssertionError(f"{name}: indices differ")
    differ = (d != rd).any(axis=1)
    rows = int(differ.sum())
    if not rows:
        return 0
    if st["fallback_queries"] == rst["fallback_queries"] == 0:
        raise AssertionError(f"{name}: distances differ")
    repaired = ((d != d.astype(np.float32)).any(axis=1)
                | (rd != rd.astype(np.float32)).any(axis=1))
    if (differ & ~repaired).any():
        raise AssertionError(
            f"{name}: {int((differ & ~repaired).sum())} rows that neither "
            f"placement repaired differ")
    rel = float(np.max(np.abs(d - rd) / np.maximum(rd, 1e-30)))
    both = (d != d.astype(np.float32)) & (rd != rd.astype(np.float32))
    if rel > RANK_SLACK or not np.array_equal(d[both], rd[both]):
        raise AssertionError(f"{name}: distances {rel} apart")
    return rows


def nonzero_launches(launches):
    return {key: n for key, n in launches.items() if n}


def in_turns(a, b, reps=1):
    """{"mesh": seconds of a, "one": seconds of b} in turns a b b a,
    ``reps`` rounds."""
    import torch

    times = {"mesh": [], "one": []}
    for _ in range(reps):
        for label, fn in (("mesh", a), ("one", b), ("one", b), ("mesh", a)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    return times


def bitwise(name, got, want):
    """Raises unless every tensor of ``got`` equals ``want``'s bitwise;
    returns the largest |difference| of the finite scores (0.0)."""
    import torch

    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: not bitwise equal")
    err = 0.0
    for a, b in ((got[0], want[0]), (got[2], want[2])):
        fin = torch.isfinite(b)
        if bool(fin.any()):
            err = max(err, float((a[fin].double() - b[fin].double()).abs().max()))
    return err


def traced_search(knn, q_np, selector="pallas", section="search",
                  require=None, **knobs) -> dict:
    """One more certified search through ``selector`` (``knobs`` passed on)
    under ``obs.profiler.device_trace`` (a Chrome trace in a temporary
    directory, dropped afterwards): its summary — device time by kernel
    name, busy time (the union of kernel intervals), the idle share of the
    call's wall time, the host's synchronizations and device-to-host
    copies — and the wall time, measured between two synchronizations
    inside the traced block.  ``require``: a kernel-name substring the
    trace must hold, and with it at least one of the trace's warm-up
    kernels (a trace that lost them all may have lost the block's first
    kernels too).  One trace is taken; one that fails either check fails
    the phase, its unfiltered events written to
    ``trace_dumps/trace_<section>_missing.json`` beside this script
    first."""
    import torch

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(section, out_dir=tmp) as cap:
            t0 = time.perf_counter()
            knn.search_certified(q_np, margin=28, selector=selector, **knobs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        s = cap.summary(wall_s=wall)
        held = require is None or any(require in n
                                      for n in s["kernel_names"])
        if require is not None and (not held
                                    or s["device_events_before"] < 1):
            out = Path(__file__).resolve().parent / "trace_dumps"
            out.mkdir(exist_ok=True)
            dump = out / f"trace_{section}_missing.json"
            dump.write_text(json.dumps([
                (e.name[:80], getattr(e.device_type, "name", ""),
                 e.time_range.start, e.time_range.end)
                for e in cap.profiler.events()]))
            raise AssertionError(
                f"the {section} trace lost kernels: {require} "
                f"{'held' if held else 'missing'}, "
                f"{s['device_events_before']} of {WARMUP_KERNELS} warm-up "
                f"kernels, "
                f"{s['kernel_events']} device events in the block; its "
                f"events are in {dump}")
    return s


def profile_search(knn, q_np, selector="pallas", require=None,
                   **knobs) -> dict:
    """:func:`traced_search` (``require`` passed on) as a ``profile`` phase
    line, with whether the trace holds the coarse kernel."""
    s = traced_search(knn, q_np, selector, require=require, **knobs)
    return {"phase": "profile", "wall_ms": s["wall_ms"],
            "device_busy_ms": s["device_busy_ms"],
            "device_idle_share": s["device_idle_share"],
            "kernels_ms": s["kernels_ms"],
            "kernel_events": s["kernel_events"],
            "syncs": s["syncs"], "d2h_copies": s["d2h_copies"],
            "coarse_kernel_traced": any(
                key in name for name in s["kernel_names"]
                for key in ("binned_select_", "stream_select_"))}


def tensor_core_counts(paths):
    """Tensor-core instructions in each kernel of the built libraries, by
    library, kernel and kind: HMMA / HGMMA (bf16), DMMA (f64) and IMMA /
    IGMMA (s8) lines of ``cuobjdump -sass`` where the toolkit has it, else
    the mma / wgmma instructions of the sources' PTX (``nvcc -ptx``; those
    ending ``.f64`` count as DMMA, ``.s32`` as IMMA).  Returns (tool,
    {library: {kernel: {"HMMA": n, "DMMA": n, "IMMA": n}}})."""
    from pathlib import Path

    from knn_tpu_torch.ops import _cuda

    counts = {}
    # cuobjdump sits beside nvcc in the toolkit
    tool = Path(_cuda._nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else None
    kinds = {"H": "HMMA", "D": "DMMA", "I": "IMMA", None: "HMMA",
             ".f64": "DMMA", ".s32": "IMMA"}
    for name, path in paths.items():
        per = counts.setdefault(name, {})
        if tool:
            text = subprocess.run([tool, "-sass", str(path)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            pattern, head = r"\b(H|D|I)G?MMA\b", r"Function : (\S+)"
        else:
            with tempfile.TemporaryDirectory() as tmp:
                ptx = f"{tmp}/{name}.ptx"
                subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS[:4], "-ptx",
                                "-o", ptx, str(_cuda.SOURCES[name])],
                               check=True, capture_output=True)
                text = open(ptx).read()
            pattern, head = (r"\b(?:w?gmma|mma\.sync)\S*?(\.f64|\.s32)?\s",
                             r"\.entry (\S+)\(")
        current = None
        for line in text.splitlines():
            m = re.search(head, line)
            if m:
                current = m.group(1)
                per.setdefault(current, {"HMMA": 0, "DMMA": 0, "IMMA": 0})
            elif current:
                hit = re.search(pattern, line)
                if hit:
                    per[current][kinds[hit.group(1)]] += 1
    return ("cuobjdump -sass" if tool else "nvcc -ptx"), counts


def kernel_record(name, source, replaces):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": None,
            "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="device,lint,build,kernel,main,profile,mesh,obs,"
                    "campaign,"
                    "stream,selectors,metrics,quant,f32arms,pq,lane,"
                    "survivors,tune,"
                    "index,ivf,hosttier,join,serving,tiers_mesh,"
                    "mesh_paths,native,classify",
                    help="comma list of phases to run")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    # the run's own empty HOME: a search resolves the knobs it leaves at
    # None with no cached autotuner winner, whatever the user's
    # ~/.cache/knn_tpu_torch/autotune.json holds (it would pick the kernels
    # the phases count and time); the tune phase passes its own cache files
    home = tempfile.TemporaryDirectory(prefix="chip_smoke_home_")
    os.environ["HOME"] = home.name
    from knn_tpu_torch.device import set_precision_policy
    from knn_tpu_torch.ops import _cuda
    from knn_tpu_torch.ops import coarse_knn as ck

    set_precision_policy()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    # library_ms stays null for every entry: no single PyTorch call computes
    # a per-bin top-2 with exclusion bounds
    records = {
        "k1": kernel_record("binned_select_bf16x3",
                            "knn_tpu_torch/csrc/binned_coarse.cu",
                            "knn_tpu/ops/pallas_knn.py:856"),
        "k10": kernel_record("stream_select_bf16x3",
                             "knn_tpu_torch/csrc/binned_stream.cu",
                             "knn_tpu/ops/pallas_knn.py:1201"),
        "k11": kernel_record("fused_select_bf16x3",
                             "knn_tpu_torch/csrc/binned_stream.cu",
                             "knn_tpu/ops/pallas_knn.py:722"),
        # K1 at Dp 256: the dot metric's certified search on the
        # norm-augmented rows (129 dims); its launches are the main
        # counter's, read around the dot run alone (metrics phase)
        "k1_dp256": kernel_record("binned_select_bf16x3 (dot, Dp 256)",
                                  "knn_tpu_torch/csrc/binned_coarse.cu",
                                  "knn_tpu/ops/pallas_knn.py:856"),
        # K1 on one db shard of the tiers on a 1 x 4 mesh (the compacted
        # index's shard is timed); its launches are the main counter's on
        # the mesh shards, read around the tiers' certified paths
        # (tiers_mesh phase)
        "k1_tiers_mesh": kernel_record(
            "binned_select_bf16x3 (tiers, 1 x 4 mesh shard)",
            "knn_tpu_torch/csrc/binned_coarse.cu",
            "knn_tpu/ops/pallas_knn.py:856"),
        # K1 on one process's shard of the tiers on global_mesh(1, 4) over
        # two processes (the compacted index's shard is timed in process
        # 0); its launches are both processes' on their shards along the
        # spanning block's paths (tiers_mesh phase)
        "k1_tiers_span": kernel_record(
            "binned_select_bf16x3 (tiers, spanning mesh shard)",
            "knn_tpu_torch/csrc/binned_coarse.cu",
            "knn_tpu/ops/pallas_knn.py:856"),
        # K7 (tiled entry) on one db shard of the pq placement on a 1 x 4
        # mesh, and K11 on one shard at the mesh pipeline's geometry; their
        # launches are the counters' on the mesh paths (mesh_paths phase)
        "k7_mesh": kernel_record("binned_select_pq (1 x 4 mesh shard)",
                                 "knn_tpu_torch/csrc/binned_coarse.cu",
                                 "knn_tpu/ops/pallas_knn.py:443"),
        "k11_mesh": kernel_record(
            "fused_select_bf16x3 (1 x 4 mesh shard, pipeline)",
            "knn_tpu_torch/csrc/binned_stream.cu",
            "knn_tpu/ops/pallas_knn.py:722"),
    }
    # the other arms' entries: (kernel, arm) -> C library, TPU kernel line
    # (K5, K6 int8 / int4; K4 bf16x3f; K2 highest; K3 default)
    arm_entries = {
        ("tiled", "int8"): ("binned_coarse", 415),
        ("tiled", "int4"): ("binned_coarse", 432),
        ("streaming", "int8"): ("binned_stream", 686),
        ("streaming", "int4"): ("binned_stream", 690),
        ("fused", "int8"): ("binned_stream", 753),
        ("fused", "int4"): ("binned_stream", 753),
        ("tiled", "pq"): ("binned_coarse", 443),
        ("streaming", "pq"): ("binned_stream", 679),
        **{(kern, arm): (lib, line)
           for arm, lines in (("bf16x3f", (407, 704)),
                              ("highest", (453, 711)),
                              ("default", (453, 711)))
           for kern, lib, line in (("tiled", "binned_coarse", lines[0]),
                                   ("streaming", "binned_stream", lines[1]),
                                   ("fused", "binned_stream", 722))},
    }
    wrappers = {"tiled": ck.binned_select, "streaming": ck.stream_select,
                "fused": ck.fused_select}
    for (kern, arm), (lib, line) in arm_entries.items():
        records[f"{kern}_{arm}"] = kernel_record(
            f"{wrappers[kern].__name__}_{arm}", f"knn_tpu_torch/csrc/{lib}.cu",
            f"knn_tpu/ops/pallas_knn.py:{line}")
    # K9: the db-major grid of every arm's tiled entry
    for arm in ck.ARMS:
        records[f"db_major_{arm}"] = kernel_record(
            f"binned_select_{arm} grid_order=db_major",
            "knn_tpu_torch/csrc/binned_coarse.cu",
            "knn_tpu/ops/pallas_knn.py:1135")
    # K8: the lane-binning entries of every arm (the lane emitter,
    # pallas_knn.py:506)
    for arm in ck.ARMS:
        for kern, lib in (("tiled", "binned_coarse"),
                          ("streaming", "binned_stream")):
            records[f"{kern}_lane_{arm}"] = kernel_record(
                f"{wrappers[kern].__name__}_{arm} binning=lane",
                f"knn_tpu_torch/csrc/{lib}.cu",
                "knn_tpu/ops/pallas_knn.py:506")
        # the lane emitter in the db-major grid (its launches are those of
        # db_major_launches in a lane-binned run)
        records[f"db_major_lane_{arm}"] = kernel_record(
            f"binned_select_{arm} grid_order=db_major binning=lane",
            "knn_tpu_torch/csrc/binned_coarse.cu",
            "knn_tpu/ops/pallas_knn.py:506")
    # the deep grouped build (survivors other than 2, binned_select.cuh's
    # Emitter<kGroupedDeep>) of every entry: tiled, streaming, fused (not
    # pq) and the db-major grid, the grouped emitter at pallas_knn.py:575
    deep_entries = [(kern, arm) for arm in ck.ARMS
                    for kern in ("tiled", "streaming", "fused")
                    if (kern, arm) != ("fused", "pq")]
    for kern, arm in deep_entries:
        lib = "binned_coarse" if kern == "tiled" else "binned_stream"
        records[f"{kern}_deep_{arm}"] = kernel_record(
            f"{wrappers[kern].__name__}_{arm} survivors=1..8 (deep build)",
            f"knn_tpu_torch/csrc/{lib}.cu",
            "knn_tpu/ops/pallas_knn.py:575")
    for arm in ck.ARMS:
        records[f"db_major_deep_{arm}"] = kernel_record(
            f"binned_select_{arm} grid_order=db_major survivors=1..8 "
            f"(deep build)", "knn_tpu_torch/csrc/binned_coarse.cu",
            "knn_tpu/ops/pallas_knn.py:575")
    checks = {key: Check() for key in records}
    # record key -> (wrapper, counter attribute, arm) whose count it reads
    counters = {"k1": (ck.binned_select, "launches", "bf16x3"),
                "k10": (ck.stream_select, "launches", "bf16x3"),
                "k11": (ck.fused_select, "launches", "bf16x3"),
                **{f"{kern}_{arm}": (wrappers[kern], "launches", arm)
                   for kern, arm in arm_entries},
                **{f"db_major_{arm}": (ck.binned_select, "db_major_launches",
                                       arm) for arm in ck.ARMS},
                **{f"{kern}_lane_{arm}": (wrappers[kern], "lane_launches", arm)
                   for arm in ck.ARMS for kern in ("tiled", "streaming")},
                **{f"{kern}_deep_{arm}": (wrappers[kern], "deep_launches", arm)
                   for kern, arm in deep_entries}}

    def reset_launches():
        for fn in wrappers.values():
            fn.launches = dict.fromkeys(ck.ARMS, 0)
            fn.deep_launches = dict.fromkeys(ck.ARMS, 0)
        ck.binned_select.db_major_launches = dict.fromkeys(ck.ARMS, 0)
        for fn in (ck.binned_select, ck.stream_select):
            fn.lane_launches = dict.fromkeys(ck.ARMS, 0)

    def read_launches():
        return {key: getattr(fn, attr)[arm]
                for key, (fn, attr, arm) in counters.items()}

    def counted(phase, label, fn, want):
        """``fn()`` with the launch counts read around it alone: exactly
        ``want`` (record key -> launches).  Returns (result, seconds)."""
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = nonzero_launches(read_launches())
        if got != want:
            raise AssertionError(f"{phase} {label}: launches {got}, "
                                 f"expected {want}")
        return res, wall

    if "device" in phases:
        emit({"phase": "device", "device": kind, "nvidia_smi": smi,
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0],
              "sms": torch.cuda.get_device_properties(0).multi_processor_count})

    if "lint" in phases:
        emit(lint_phase())

    def build_resources():
        """[registers, static shared, local, dynamic shared bytes, CTAs per
        SM, emitter code, passes a tile] of every build, by
        "entry/arm/emitter/dp": the two-survivor grouped build (s2), the
        deep grouped builds at 1, 3, 4 and 8 survivors (deep_s1 .. deep_s8:
        builds A, B, C, C of csrc/binned_select.cuh's table) and at 8 on
        512-group tiles (deep_s8_wide: W), the lane builds (lane3, lane9),
        at Dp 128 and 256 (pq: at 32 subspaces of 256 codes)."""
        emitters = {"s2": (0, 2, ck.TILE_N), "deep_s1": (0, 1, ck.TILE_N),
                    "deep_s3": (0, 3, ck.TILE_N),
                    "deep_s4": (0, 4, ck.TILE_N),
                    "deep_s8": (0, 8, ck.TILE_N),
                    "deep_s8_wide": (0, 8, 65536),
                    "lane3": (128, 2, ck.TILE_N),
                    "lane9": (128, 8, ck.TILE_N)}
        out = {}
        for kern in ("tiled", "streaming", "fused"):
            for arm in ck.ARMS:
                for emit_name, (bin_w, surv, tile) in emitters.items():
                    if kern == "fused" and (arm == "pq" or bin_w):
                        continue
                    for dp in ((32,) if arm == "pq" else (128, 256)):
                        res = ck.kernel_resources(
                            kern, arm, bin_w=bin_w, survivors=surv, dp=dp,
                            tile_n=tile, device=dev)
                        out[f"{kern}/{arm}/{emit_name}/dp{dp}"] = [
                            res[f] for f in ck.RESOURCE_FIELDS]
        return out

    if "build" in phases:
        t0 = time.perf_counter()
        paths = _cuda.build()
        build_s = time.perf_counter() - t0
        # every entry's kernel but pq's (every arm's tiled entry in either
        # grid, streaming and fused entries, lane builds, Dp = 128 and Dp >
        # 128 builds) must run on its tensor cores: bf16x3, bf16x3f and
        # default on the bf16 ones (HMMA), highest on the FP64 ones (DMMA),
        # int8 and int4 on the s8 ones (IMMA).  A build's arm is its kernel
        # template's first argument (binned::Arm, mangled "ArmE<code>E")
        tc_tool, tc = tensor_core_counts(paths)
        unit = {"bf16x3": "HMMA", "bf16x3f": "HMMA", "default": "HMMA",
                "highest": "DMMA", "int8": "IMMA", "int4": "IMMA"}
        mma_tc = {arm: {} for arm in unit}
        for lib, fns in tc.items():
            for fn, n in fns.items():
                code = re.search(r"ArmE(\d+)E", fn)
                if "mma_kernel" in fn and code:
                    arm = ck.ARMS[int(code.group(1))]
                    mma_tc.setdefault(arm, {})[f"{lib}:{fn}"] = n[unit[arm]]
        for arm, builds in mma_tc.items():
            if len(builds) < 2 or min(builds.values()) < 1:
                raise AssertionError(
                    f"{arm} kernels without {unit[arm]} instructions: "
                    f"{builds}")
        emit({"phase": "build", "seconds": round(build_s, 3),
              "tensor_core_tool": tc_tool,
              "tensor_core_instructions": {
                  f"{arm} ({unit[arm]})": builds
                  for arm, builds in mma_tc.items()},
              "other_kernels_tensor_core_instructions": sum(
                  sum(n.values()) for lib, fns in tc.items()
                  for fn, n in fns.items()
                  if "mma_kernel" not in fn and "probe" not in fn),
              "libraries": {n: str(p.name) for n, p in paths.items()},
              "ptxas": {n: [ln.split(":", 1)[-1].strip()
                            for ln in log.splitlines()
                            if any(s in ln for s in ("Compiling entry",
                                                     "registers", "spill"))]
                        for n, log in _cuda.build_logs.items()},
              # every build a launch can take, read from the built kernel:
              # [registers, static shared, local, dynamic shared bytes,
              # CTAs per SM, emitter code, passes a tile]
              "resource_fields": list(ck.RESOURCE_FIELDS),
              "resources": build_resources()})

    if "kernel" in phases:
        rng = np.random.default_rng(0)
        cases = []
        # (queries, rows, dim, tile_n): ragged rows at dim 24 with 2 and 4
        # groups per tile, then dim 300 (three dim chunks)
        for n_q, n, dim, tile in ((37, 5 * 128 + 60, 24, 256),
                                  (37, 5 * 128 + 60, 24, 512),
                                  (11, 3 * 128 + 40, 300, 256)):
            q = torch.from_numpy(
                (rng.normal(size=(n_q, dim)) * 10).astype(np.float32)).to(dev)
            db = torch.from_numpy(
                (rng.normal(size=(n, dim)) * 10).astype(np.float32)).to(dev)
            cases.append(compare_k1(checks, q, db, tile))
        q = torch.from_numpy((rng.random((256, 128)) * 128).astype(np.float32)).to(dev)
        db = torch.from_numpy((rng.random((16384, 128)) * 128).astype(np.float32)).to(dev)
        cases.append(compare_k1(checks, q, db, ck.TILE_N))
        # K11 at the main path's keep (m+2 = 130: a depth-2 carry)
        k11_cases = [compare_k11(checks["k11"], q, db, ck.TILE_N, 130)]
        fq, fdb = far_tile_case(dev)
        far = compare_k11(checks["k11"], fq, fdb, ck.TILE_N, 130)
        if far["skipped_cells"] < 1:
            raise AssertionError("K11 skipped no tile on the far-tile case")
        k11_cases.append(far)
        del fq, fdb
        # the tensor-core step's rounding against the header's model, and
        # fault 18's construction through every bf16x3 and bf16x3f entry
        probe = ck.mma_rounding_probe(dev)
        if max(r["max_error_over_bound"] for r in probe.values()) > 1.0:
            raise AssertionError(f"mma step outside the header's model: {probe}")
        # ... and highest's f64 step against its model (round to nearest,
        # any order): highest's tolerance is proved from it
        dprobe = ck.dmma_rounding_probe(dev)
        if max(r["max_error_over_bound"] for r in dprobe.values()) > 1.0:
            raise AssertionError(
                f"f64 mma step outside the header's model: {dprobe}")
        fault18 = {arm: {f"dp{dim}": fault18_ratios(dev, dim, arm)
                         for dim in (128, 896)}
                   for arm in ("bf16x3", "bf16x3f")}
        emit({"phase": "kernel", "cases": cases, "k11_cases": k11_cases,
              "mma_rounding_probe": probe, "dmma_rounding_probe": dprobe,
              "fault18_case": fault18,
              "max_abs_err": {key: c.max_abs_err for key, c in checks.items()}})

    # the SIFT1M-shape placement, queries and oracle, shared by main and
    # stream and built on first use
    sift = {}

    def sift_data():
        if sift:
            return sift
        from knn_tpu_torch import ShardedKNN

        n, dim, n_q, k = 1_000_000, 128, 4096, 100
        rng = np.random.default_rng(0)
        db_np = (rng.random(size=(n, dim)) * 128.0).astype(np.float32)
        q_np = (rng.random(size=(n_q, dim)) * 128.0).astype(np.float32)
        t0 = time.perf_counter()
        knn = ShardedKNN(db_np, k=k)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        q_dev = torch.from_numpy(q_np).to(dev)
        pl = knn.placement
        n_p, dp = pl.th.shape
        sift.update(n=n, dim=dim, n_q=n_q, k=k, q_np=q_np, knn=knn,
                    db_np=db_np,
                    setup_s=setup_s, q_dev=q_dev, qp=ck.pad_queries(q_dev),
                    n_or=256,
                    # one bound for K1, K10 and K11: the same products
                    bound=f32_bound(n_q, n, dp, n_p // ck.TILE_N,
                                    ck.SURVIVORS))
        return sift

    def oracle_check(S, d, i, label):
        n_or, k = S["n_or"], S["k"]
        if "oi" not in S:  # after the first search: it times a cold call
            od, oi = f64_oracle(S["q_dev"][:n_or], S["knn"].placement.db, k)
            S["od"], S["oi"] = od.cpu().numpy(), oi.cpu().numpy()
        recall = float(np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(i[:n_or], S["oi"])]))
        same = bool((i[:n_or] == S["oi"]).all())
        rel = float(np.max(np.abs(d[:n_or] - S["od"])
                           / np.maximum(S["od"], 1e-30)))
        if recall != 1.0 or not same or rel > ck.RANK_SLACK:
            raise AssertionError(
                f"{label}: oracle mismatch: recall@{k}={recall} "
                f"same_order={same} max_rel_dist_err={rel}")
        return recall, same, rel

    def timed_search(S, **knobs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = S["knn"].search_certified(S["q_np"], margin=28,
                                        selector="pallas", **knobs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def timed_on(knn, q, **knobs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = knn.search_certified(q, margin=28, selector="pallas", **knobs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the kernel configurations of search_certified that every arm runs
    kernel_configs = {"tiled": {"kernel": "tiled"},
                      "tiled_db_major": {"kernel": "tiled",
                                         "grid_order": "db_major"},
                      "streaming": {"kernel": "streaming"},
                      "fused": {"kernel": "fused"},
                      "fused_overlap": {"kernel": "fused", "overlap": True,
                                        "batch_size": 1024,
                                        "overlap_depth": 2}}
    bf16x3_keys = {"tiled": "k1", "streaming": "k10", "fused": "k11"}

    def run_configs(D, arm, labels, ref=None, binning="grouped",
                    ref_i=None, **extra):
        """search_certified(precision=arm, binning=binning, **extra) on D's
        placement through the kernel_configs ``labels``, the launch counts
        read around each call alone: each run launches its own kernel once
        per batch and no other kernel, returns ``ref``'s d and i bitwise
        (the first run's when None) — or, given ``ref_i``, those indices
        for every query — and the oracle's on D's first queries."""
        n_q, n = D["q_np"].shape[0], D["knn"].n_train
        runs = {}
        for label in labels:
            knobs = dict(kernel_configs[label], precision=arm,
                         binning=binning, **extra)
            kernel = knobs["kernel"]
            if binning == "lane":
                own = [f"{kernel}_lane_{arm}"]
            elif extra.get("survivors") not in (None, ck.SURVIVORS):
                own = [f"{kernel}_deep_{arm}"]
            else:
                own = [bf16x3_keys[kernel] if arm == "bf16x3"
                       else f"{kernel}_{arm}"]
            if knobs.get("grid_order") == "db_major":
                own.append(f"db_major_{arm}")  # counted by both
            name = f"{arm} {label}" + (" lane" if binning == "lane" else "")
            reset_launches()
            (d, i, stats), wall = timed_search(D, **knobs)
            launches = read_launches()
            n_batches = -(-n_q // knobs.get("batch_size", n_q))
            want = n_batches * ck.kernel_launches_per_batch(kernel, n,
                                                            ck.TILE_N)
            if any(launches[key] != want for key in own) \
                    or sum(launches.values()) != want * len(own):
                raise AssertionError(
                    f"{name}: launches {launches}, expected {want} of {own} "
                    f"and no other kernel")
            _, wall_warm = timed_search(D, **knobs)
            if ref_i is not None:
                if not np.array_equal(i, ref_i):
                    raise AssertionError(
                        f"{name}: indices differ from the grouped run's")
            elif ref is None:
                ref = (d, i)
            elif not (np.array_equal(d, ref[0]) and np.array_equal(i, ref[1])):
                raise AssertionError(f"{name}: d, i differ from the tiled run")
            recall, same, rel = oracle_check(D, d, i, name)
            if knobs.get("overlap"):
                pipe = stats.get("pipeline")
                if not pipe or pipe["batches"] != n_batches or pipe["depth"] != 2:
                    raise AssertionError(f"{name}: pipeline stats {pipe}")
            runs[label] = {"launches": launches, "batches": n_batches,
                           "qps_first_call": n_q / wall,
                           "qps_second_call": n_q / wall_warm,
                           "bitwise_tiled": ref_i is None,
                           "same_indices_all_queries": True,
                           "recall_at_k": recall,
                           "same_indices": same, "max_rel_dist_err": rel,
                           "certified": stats["certified"],
                           "fallback_queries": stats["fallback_queries"],
                           "host_exact_queries": stats.get("host_exact_queries", 0),
                           "pipeline": stats.get("pipeline")}
        return runs

    def phase_main(S):
        knn, pl, qp = S["knn"], S["knn"].placement, S["qp"]
        n, dim, n_q, k = S["n"], S["dim"], S["n_q"], S["k"]

        # K1 against its plain version at the main path's shape, then both
        # timed with CUDA events
        args = (qp, pl.th, pl.tl, pl.tnorm)
        kern = ck.binned_select(*args, tile_n=ck.TILE_N, arm="bf16x3")
        plain = ck.binned_select_plain(*args, tile_n=ck.TILE_N, arm="bf16x3")
        tol_q = tolerance_q(S["q_dev"], tmax=pl.db_norm_max)
        full_err = max(
            checks["k1"].values("cd@main", kern[0], plain[0], tol_q),
            checks["k1"].values("bounds@main", kern[2], plain[2], tol_q))
        S["k1_err"] = full_err
        del kern, plain
        ms = time_cuda(lambda: ck.binned_select(*args, tile_n=ck.TILE_N,
                                                arm="bf16x3"), 3)
        plain_ms = time_cuda(lambda: ck.binned_select_plain(
            *args, tile_n=ck.TILE_N, arm="bf16x3"), 1)
        bound = S["bound"]

        # the main path, with the launch count read around it alone
        reset_launches()
        (d, i, stats), wall = timed_search(S)
        launches = read_launches()
        want = ck.kernel_launches_per_batch("tiled", n, ck.TILE_N)
        if launches["k1"] != want or sum(launches.values()) != want:
            raise AssertionError(
                f"main: launches {launches}, expected {want} of k1 (one "
                f"batch) and no other kernel")
        # the same call again: the first one also pays one-time library
        # and allocator set-up
        _, wall_warm = timed_search(S)
        S.setdefault("measured_qps", []).extend((n_q / wall, n_q / wall_warm))
        if d.shape != (n_q, k) or i.shape != (n_q, k) or not np.isfinite(d).all():
            raise AssertionError(f"bad result shapes {d.shape} {i.shape}")
        recall, same, rel = oracle_check(S, d, i, "main")
        S["tiled"] = (d, i)
        S["tiled_stats"] = stats
        # the main call's roofline block, held against the catalog, and the
        # warm call as a bench line (the catalog's bench-line half)
        from knn_tpu_torch.obs import ident, roofline

        main_block = roofline.attribute(
            roofline.pallas_cost_model(n=n, d=dim, k=k, nq=n_q,
                                       device_kind=kind), n_q / wall_warm)
        catalog_check("main", "roofline", main_block)
        record = bench_line_record(
            n=n, dim=dim, k=k, n_q=n_q, qps=n_q / wall_warm,
            knobs=stats["pallas_knobs"], kind=kind, recall=recall,
            commit=ident.identity()["commit"])
        bench_line = bench_line_checks(record, main_block)
        records["k1"].update(launches=launches["k1"], ms=ms, plain_ms=plain_ms,
                             bound_ms=bound["bound_ms"],
                             bound_by=bound["bound_by"])
        emit({"phase": "main", "n": n, "dim": dim, "queries": n_q, "k": k,
              "qps": n_q / wall, "wall_s": wall, "setup_s": S["setup_s"],
              "qps_second_call": n_q / wall_warm,
              "k1_ms_per_launch": ms, "k1_plain_ms": plain_ms,
              "k1_launches": launches["k1"], "launches": launches,
              "k1_max_abs_err": full_err, "k1_bound": bound,
              "certified": stats["certified"],
              "fallback_queries": stats["fallback_queries"],
              "rank_corrected_queries": stats["rank_corrected_queries"],
              "host_exact_queries": stats.get("host_exact_queries", 0),
              "oracle_queries": S["n_or"], "recall_at_k": recall,
              "same_indices": same, "max_rel_dist_err": rel,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
        emit({"phase": "bench_line", "record": record, **bench_line})
        if "profile" in phases:
            emit(profile_search(knn, S["q_np"], require="binned_select_"))

    def phase_mesh(S):
        """Docstring item 4b: the flat and host meshes on logical shards of
        the card, two processes merging through the store, the times."""
        from knn_tpu_torch import ShardedKNN
        from knn_tpu_torch.obs.waterfall import stitch_multihost
        from knn_tpu_torch.parallel.crossover import merge_bytes
        from knn_tpu_torch.parallel.mesh import make_host_mesh, make_mesh

        t_phase = time.perf_counter()
        n, n_q, k, q_np = S["n"], S["n_q"], S["k"], S["q_np"]
        if "tiled" not in S:
            (d, i, st), _ = timed_search(S)
            S["tiled"], S["tiled_stats"] = (d, i), st
        one = (*S["tiled"], S["tiled_stats"])
        # the (1, 1) placement's int8 and highest results on the first
        # 1,024 queries (also builds their kernels before the children
        # load them); int8 on the main draw cast to uint8 (the quant
        # phase's byte-exact placement: K5 certifies queries there, none
        # on the f32 draw)
        n_cut = 1024
        q8 = q_np.astype(np.uint8).astype(np.float32)
        knn8 = ShardedKNN(S["knn"].placement.db_host.astype(np.uint8), k=k)
        one_arm = {"int8": knn8.search_certified(q8[:n_cut], margin=28,
                                                 precision="int8"),
                   "highest": S["knn"].search_certified(
                       q_np[:n_cut], margin=28, precision="highest")}
        del knn8

        # the store's two processes and the spanning mesh's two start
        # first: their import, draw and placement overlap the in-process
        # meshes below
        work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
        span_work = {n_proc: os.path.join(work, f"span{n_proc}")
                     for n_proc in (2, 4)}
        for d in span_work.values():
            os.makedirs(d)
        procs = spawn_children(MESH_CHILD, 2, work, "store")
        span_procs = spawn_children(SPAN_CHILD, 2, span_work[2], "span2")
        try:
            devs = [torch.device("cuda", torch.cuda.current_device())] * 4
            flat, out = {}, {}
            for merge in ("ring", "allgather"):
                knn = ShardedKNN(S["db_np"], k=k, merge=merge,
                                 mesh=make_mesh(1, 4, devices=devs))
                reset_launches()
                (d, i, st), wall = timed_on(knn, q_np)
                launches = read_launches()
                if launches["k1"] != 4 or sum(launches.values()) != 4:
                    raise AssertionError(
                        f"mesh 1x4 {merge}: launches {launches}, expected 4 "
                        f"of k1 (one a shard) and no other kernel")
                recall, same, rel = oracle_check(S, d, i, f"mesh {merge}")
                out[f"flat_{merge}"] = {
                    "k1_launches": launches["k1"], "wall_s": wall,
                    "recall_at_k": recall, "same_indices": same,
                    "max_rel_dist_err": rel,
                    "fallback_queries": st["fallback_queries"],
                    "fallback_queries_one_device": one[2]["fallback_queries"],
                    "d_rows_not_bitwise_one_device": held(
                        f"mesh {merge}", d, i, st, *one)}
                flat[merge] = (d, i, st)
                if merge == "ring":
                    del knn
            if not all(np.array_equal(a, b) for a, b in
                       zip(flat["ring"][:2], flat["allgather"][:2])):
                raise AssertionError("mesh: ring and allgather differ")
            mesh_knn = knn
            for merge, dcn in [(a, b) for a in ("ring", "allgather")
                               for b in ("ring", "allgather")]:
                hknn = ShardedKNN(S["db_np"], k=k, merge=merge,
                                  dcn_merge=dcn,
                                  mesh=make_host_mesh(1, 2, 2, devices=devs))
                reset_launches()
                (d, i, st), wall = timed_on(hknn, q_np)
                launches = read_launches()
                if launches["k1"] != 4 or sum(launches.values()) != 4 or \
                        not np.array_equal(d, flat["ring"][0]) or \
                        not np.array_equal(i, flat["ring"][1]):
                    raise AssertionError(
                        f"host mesh {merge}/{dcn}: launches {launches} or "
                        f"a result other than the flat mesh's")
                out[f"host_{merge}_{dcn}"] = {"k1_launches": launches["k1"],
                                              "bitwise_flat": True}
                del hknn
            torch.cuda.empty_cache()
            results = collect_children(procs, "mesh", 300)
            span2 = collect_children(span_procs, "spanning", 900)
            # the four-process run after the two-process one: each times
            # its calls against process 0's logical mesh in turns
            span_procs = spawn_children(SPAN_CHILD, 4, span_work[4], "span4")
            span4 = collect_children(span_procs, "spanning 4", 600)
        finally:
            for p in procs + span_procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        spanning = spanning_checks(S, span2, span4, span_work)
        two = {}
        for arm in ("bf16x3", "int8", "highest"):
            d0, i0, d1, i1 = (np.load(os.path.join(work, f"{x}_{arm}_{p}.npy"))
                              for p in (0, 1) for x in ("d", "i"))
            if not (np.array_equal(d0, d1) and np.array_equal(i0, i1)):
                raise AssertionError(f"two processes: {arm} results differ")
            r0 = results[0][arm]
            st = {"fallback_queries": sum(r0["per_host"]["fallback_queries"])}
            if arm == "bf16x3":
                rows = held("two processes bf16x3", d0, i0, st, *one)
                if not np.array_equal(i0, flat["ring"][1]):
                    raise AssertionError(
                        "two processes: bf16x3 indices other than the flat "
                        "mesh's")
                want = merge_bytes(n_q, k, 2, "allgather")
                if r0["dcn_bytes_total"] != want or want != 6_553_600:
                    raise AssertionError(
                        f"two processes: MERGE_BYTES dcn "
                        f"{r0['dcn_bytes_total']} != {want}")
            else:
                rows = held(f"two processes {arm}", d0, i0, st,
                            *one_arm[arm])
            if any(r[arm]["launches"] != {arm: 1} for r in results):
                raise AssertionError(
                    f"two processes {arm}: launches "
                    f"{[r[arm]['launches'] for r in results]}")
            if min(r0["per_host"]["certified"]) < 1:
                raise AssertionError(
                    f"two processes {arm}: a process certified no query "
                    f"({r0['per_host']}): its kernel's lists never reached "
                    f"the merge")
            two[arm] = {
                "queries": d0.shape[0],
                "draw": ("main, cast to uint8" if arm == "int8" else "main"),
                "d_rows_not_bitwise_one_device": rows,
                "fallback_queries_one_device": (
                    one if arm == "bf16x3" else one_arm[arm])[2][
                        "fallback_queries"],
                "launches_per_process": results[0][arm]["launches"],
                "fallback_queries_per_host":
                    r0["per_host"]["fallback_queries"],
                "certified_per_host": r0["per_host"]["certified"],
                "walls_s": r0["per_host"]["walls_s"],
                "straggler_gap_s": r0["straggler_gap_s"],
                "exchange_s": r0["exchange_s"],
                "exchange_bytes": r0["exchange_bytes"],
                "exchange_bytes_per_s": (r0["exchange_bytes"]
                                         / r0["exchange_s"]
                                         if r0["exchange_s"] else None)}
        for r in results:
            if r["health"]["hosts"] != 2 or r["foreign"]:
                raise AssertionError(
                    f"two processes: health {r['health']}, foreign imports "
                    f"{r['foreign']}")
        events = []
        for p in (0, 1):
            with open(os.path.join(work, f"events{p}.jsonl")) as f:
                events += [json.loads(ln) for ln in f if ln.strip()]
        stitched = stitch_multihost(events)
        if len(stitched) != 3 or not all(w["kind"] == "multihost"
                                         for w in stitched.values()):
            raise AssertionError(f"two processes: {len(stitched)} stitched "
                                 f"waterfalls for 3 requests")
        # the mesh and (1, 1) calls in turns: logical shards of one card
        times = {"one": [], "mesh": []}
        for order in (("one", "mesh"), ("mesh", "one")) * 2:
            for label in order:
                times[label].append(timed_on(
                    mesh_knn if label == "mesh" else S["knn"], q_np)[1])
        del mesh_knn
        torch.cuda.empty_cache()
        emit({"phase": "mesh", "n": n, "queries": n_q, "k": k,
              "shards": 4, "devices": "cuda:0 x 4 (logical)",
              "runs": out, "spanning": spanning, "two_processes": {
                  "rows_each": n // 2, "transport":
                      "host-mediated TCP store, two processes on one "
                      "machine (not NVLink, not InfiniBand)",
                  "arms": two,
                  "dcn_merge_bytes": results[0]["bf16x3"]["dcn_bytes_total"],
                  "health": results[0]["health"],
                  "stitched_waterfalls": len(stitched)},
              "seconds_mesh_vs_one_in_turns": times,
              "phase_s": time.perf_counter() - t_phase})

    def spanning_checks(S, span2, span4, span_work):
        """The spanning-mesh children's results held: every process's
        results equal, bitwise process 0's one-process logical mesh, the
        arm's kernel once a process (twice on the host mesh, two
        positions a process), the oracle's indices on 256 queries, the
        refusals by name and no foreign import."""
        k, n_or = S["k"], S["n_or"]

        def loaded(n_proc, label, pid):
            d = np.load(os.path.join(span_work[n_proc], f"d_{label}_{pid}.npy"))
            i = np.load(os.path.join(span_work[n_proc], f"i_{label}_{pid}.npy"))
            with open(os.path.join(span_work[n_proc],
                                   f"stats_{label}_{pid}.json")) as f:
                return d, i, f.read()

        for res in (span2, span4):
            for r in res:
                if r["foreign"] or "backend='gloo'" not in str(
                        r["nccl_refused"]):
                    raise AssertionError(
                        f"spanning: foreign imports {r['foreign']} or nccl "
                        f"on one card not refused: {r['nccl_refused']}")
        # the uint8 draw's own oracle (int8 runs on the main draw cast)
        q8 = S["q_dev"][:n_or].to(torch.uint8).float()
        od8, oi8 = f64_oracle(q8, S["knn"].placement.db.to(torch.uint8)
                              .float(), k)
        oracle = {"int8": (od8.cpu().numpy(), oi8.cpu().numpy())}
        for n_proc, res, arms in ((2, span2, {"bf16x3": "bf16x3",
                                              "highest": "highest",
                                              "int8": "int8"}),
                                  (4, span4, {"bf16x3_2x2": "bf16x3"})):
            for label, arm in arms.items():
                got = [loaded(n_proc, label, pid) for pid in range(n_proc)]
                if any(not (np.array_equal(g[0], got[0][0])
                            and np.array_equal(g[1], got[0][1])
                            and g[2] == got[0][2]) for g in got):
                    raise AssertionError(
                        f"spanning {n_proc} processes {label}: the "
                        f"processes' (d, i, stats) differ")
                if res[0][label]["bitwise_logical"] is not True or any(
                        r[label]["launches"] != {arm: 1} for r in res):
                    raise AssertionError(
                        f"spanning {n_proc} processes {label}: bitwise "
                        f"logical {res[0][label]['bitwise_logical']}, "
                        f"launches {[r[label]['launches'] for r in res]}")
                d, i = got[0][0], got[0][1]
                if label in oracle:
                    od, oi = oracle[label]
                    recall = float(np.mean([len(set(a) & set(b)) / k
                                            for a, b in zip(i[:n_or], oi)]))
                    if recall != 1.0 or not (i[:n_or] == oi).all():
                        raise AssertionError(
                            f"spanning {label}: recall@{k} {recall} against "
                            f"the uint8 draw's oracle")
                    res[0][label]["recall_at_k"] = recall
                elif n_proc == 2:
                    res[0][label]["recall_at_k"] = oracle_check(
                        S, d, i, f"spanning {label}")[0]
        placed = span2[0]["placed_search"]
        if placed["bitwise_logical"] is not True or "needs a host copy" \
                not in str(placed["certified_refused"]):
            raise AssertionError(f"spanning shard_across_hosts: {placed}")
        pairs = {key: span2[0][key] for key in span2[0]
                 if key.startswith("host_") and key != "host_mesh"}
        if any(not r["flat_1x4"]["indices_of_1x2"]
               or r["flat_1x4"]["launches"] != {"bf16x3": 2} for r in span2):
            raise AssertionError(
                f"spanning flat 1 x 4: {[r['flat_1x4'] for r in span2]}")
        for r in span2:
            for key in pairs:
                if not r[key]["bitwise_flat"] or \
                        r[key]["launches"] != {"bf16x3": 2}:
                    raise AssertionError(f"spanning {key}: {r[key]}")
        if len(pairs) != 4:
            raise AssertionError(f"spanning: {len(pairs)} host-mesh pairs")
        return {
            "transport": "torch.distributed gloo over loopback TCP, every "
                         "process on cuda:0, exchanges staged through the "
                         "host: no interconnect and no NCCL measured",
            "two_processes": {key: span2[0][key] for key in span2[0]
                              if key not in ("foreign", "pid")},
            "four_processes": {key: span4[0][key] for key in span4[0]
                               if key not in ("foreign", "pid")},
            "children_foreign_imports": {
                f"{len(res)}_processes": [r["foreign"] for r in res]
                for res in (span2, span4)},
            "seconds_per_process": {
                label: [r[label]["seconds_in_turns"]["spanning"]
                        for r in span2]
                for label in ("bf16x3", "highest", "int8")}}

    def tiers_spanning_checks(S, span, span_work, ref, want_k2, groups):
        """The tiers_mesh phase's spanning block held: both processes'
        results equal and bitwise the phase's one-process 1 x 4 logical
        results (``ref``: path -> (arrays, seconds)), every read across
        the background compaction from one epoch in both, each path's
        launches exactly its kernel's on a process's two shards (K1 twice
        a certified MutableIndex call, K2 once a probe group), no foreign
        import.  Returns the block's line, each path's seconds spanning /
        logical (concurrent with each other: no speed claim) and its
        exchanges."""
        def loaded(label, n_arrays):
            got = [[np.load(os.path.join(span_work,
                                         f"{label}_{j}_{pid}.npy"))
                    for j in range(n_arrays)] for pid in range(2)]
            if not all_equal(got[0], got[1]):
                raise AssertionError(f"tiers_mesh spanning {label}: the "
                                     f"processes' results differ")
            return got[0]

        def host(x):
            return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

        for r in span:
            if r["foreign"]:
                raise AssertionError(f"tiers_mesh spanning: foreign imports "
                                     f"{r['foreign']}")
        two = {"bf16x3": 2}
        want = {"mutable": two, "mutable_compacted": two, "ivf_train": {},
                "ivf_exact": {}, "ivf_pallas": {"highest": 1},
                "autotune_ivf": {"highest": want_k2}, "join_stream": {},
                "join_certified": {"bf16x3": 8},
                "certified_stream": {"bf16x3": 4}, "minmax": {}}
        paths = {}
        for label, launches_want in want.items():
            arrays, logical_s = ref[label]
            if arrays:
                files = {"mutable_compacted": "compacted",
                         "ivf_train": "ivf_centroids"}.get(label, label)
                got = loaded(files, len(arrays))
                if not all_equal(got, [host(a) for a in arrays]):
                    raise AssertionError(
                        f"tiers_mesh spanning {label}: not bitwise the "
                        f"logical 1 x 4 result")
            for r in span:
                if r[label]["launches"] != launches_want:
                    raise AssertionError(
                        f"tiers_mesh spanning {label}: launches "
                        f"{r[label]['launches']}, expected {launches_want}")
            paths[label] = {
                "seconds_spanning": [r[label]["seconds"] for r in span],
                "seconds_logical": logical_s,
                "launches_per_process": launches_want,
                "exchanges": span[0][label]["exchanges"],
                "exchange_s": [r[label]["exchange_s"] for r in span],
                "exchange_bytes": span[0][label]["exchange_bytes"],
                "bitwise_logical": bool(arrays)}
        if span[0]["ivf_pallas"]["groups"] != 1:
            raise AssertionError("tiers_mesh spanning ivf: "
                                 f"{span[0]['ivf_pallas']['groups']} groups")
        entries = [r["autotune_ivf"]["entry"] for r in span]
        if entries[0] != entries[1] or entries[0]["errors"] or None in \
                entries[0]["timings_ms"].values():
            raise AssertionError(f"tiers_mesh spanning autotune_ivf: "
                                 f"{entries}")
        # the reads across the background compaction: one epoch a read in
        # both processes, epoch 0 first and 1 last; every read's answer
        # the logical index's (a certified answer is the survivors')
        reads = span[0]["reads"]
        if [x["epoch"] for x in reads] != [x["epoch"] for x in
                                           span[1]["reads"]] or \
                reads[0]["epoch"] != 0 or reads[-1]["epoch"] != 1:
            raise AssertionError(f"tiers_mesh spanning reads: "
                                 f"{[r['reads'] for r in span]}")
        d_m, i_m = ref["mutable"][0]
        for j, x in enumerate(reads):
            if not all_equal(loaded(f"read{j}", 2), (d_m[:64], i_m[:64])) \
                    or any(r["reads"][j]["launches"] != two for r in span):
                raise AssertionError(f"tiers_mesh spanning read {j}")
        for r in span:
            if r["stream_interrupted"] != "interrupted" or \
                    r["stream_done_before_resume"] != [
                        "batch_000000.npz", "manifest.json"]:
                raise AssertionError(f"tiers_mesh spanning stream: {r}")
        if span[0]["logical_bitwise"] is not True:
            raise AssertionError("tiers_mesh spanning: the compacted call "
                                 "differs from the logical index's")
        shard = span[0]["k1_shard"]
        bound = f32_bound(shard["queries"], shard["rows"], shard["dp"],
                          shard["tiles"], ck.SURVIVORS)
        launches = sum(r["k1_main_path"] for r in span)
        checks["k1_tiers_span"].max_abs_err = max(
            r["k1_shard"]["max_abs_err"] for r in span)
        records["k1_tiers_span"].update(
            launches=launches, ms=shard["ms"], plain_ms=shard["plain_ms"],
            bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
        return {
            "layout": "global_mesh(1, 4) over two processes on cuda:0 "
                      "(gloo), two positions a process",
            "mesh": span[0]["mesh"],
            "local_positions": [r["local_positions"] for r in span],
            "transport": "torch.distributed gloo over loopback TCP, "
                         "exchanges staged through the host",
            "build_s": [r["build_s"] for r in span],
            "tail_rungs": span[0]["tail_rungs"],
            "paths": paths,
            "reads_across_compaction": [x["epoch"] for x in reads],
            "compacted_in_turns": span[0]["mutable_compacted"][
                "seconds_in_turns"],
            "autotune_ivf_winner": entries[0]["winner"],
            "autotune_ivf_timings_ms": entries[0]["timings_ms"],
            "probe_groups": groups,
            "k1_launches_main_path": launches,
            "k1_shard": dict(shard, bound=bound),
            "children_foreign_imports": [r["foreign"] for r in span]}

    def phase_tiers_mesh(S):
        """Docstring item 4c: the tiers on the 1 x 4 logical mesh of the
        card at the main shape, each path's launches read around it."""
        import shutil

        from knn_tpu_torch import ShardedKNN
        from knn_tpu_torch.index import MutableIndex
        from knn_tpu_torch.ivf import IVFIndex
        from knn_tpu_torch.join import knn_join
        from knn_tpu_torch.ops.refine import refine_shared_exact
        from knn_tpu_torch.parallel.mesh import make_host_mesh, make_mesh
        from knn_tpu_torch.parallel.sharded import sharded_minmax
        from knn_tpu_torch.serving import ServingEngine, bucket_for
        from knn_tpu_torch.streaming import streaming_certified_knn
        from knn_tpu_torch.tuning import ivf_label

        t_phase = time.perf_counter()
        # the spanning block's two processes run beside the phase's own
        # calls (the card and the host shared), and are held against the
        # phase's results at its end
        span_work = tempfile.mkdtemp(prefix="chip_smoke_tiers_span_")
        span_procs = spawn_children(TIERS_SPAN_CHILD, 2, span_work,
                                    "tiers_span")
        atexit.register(stop_children, span_procs)
        n, dim, k, q_all = S["n"], S["dim"], S["k"], S["q_np"]
        db = S["db_np"]
        devs = [torch.device("cuda", torch.cuda.current_device())] * 4
        mesh = make_mesh(1, 4, devices=devs)
        shards = 4
        # the phase's logical results the spanning block is held against,
        # with each path's seconds
        ref = {}
        out = {"phase": "tiers_mesh", "n": n, "dim": dim, "k": k,
               "mesh": "1 x 4", "devices": "cuda:0 x 4 (logical)",
               "nvidia_smi": smi}
        k1_total = k1_on_shards = 0

        def run(label, fn, k1_want, on_shards=True):
            """``fn()`` with the launch counts read around it alone: K1
            ``k1_want`` times and no other kernel; ``on_shards``: those
            launches run on the mesh's db shards (not on the (1, 1)
            placement or IVF's gathered block).  Returns (result,
            seconds)."""
            nonlocal k1_total, k1_on_shards
            res = counted("tiers_mesh", label, fn,
                          {"k1": k1_want} if k1_want else {})
            k1_total += k1_want
            k1_on_shards += k1_want if on_shards else 0
            return res

        # -- MutableIndex: writes across three tail rungs, the reserve
        # deleted, 1,024 queries; the same writes on the (1, 1) placement
        q = q_all[:1024]
        t0 = time.perf_counter()
        idx = MutableIndex(db, k=k, reserve=32, mesh=mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        one = MutableIndex(db, k=k, reserve=32)
        new = (np.random.default_rng(5).random(size=(4096, dim))
               * 128.0).astype(np.float32)
        rungs = []
        for lo, hi in ((0, 200), (200, 1100), (1100, 4096)):
            for x in (idx, one):
                x.insert(new[lo:hi], np.arange(n + lo, n + hi))
            rungs.append(idx.stats()["tail_capacity"])
        if len(set(rungs)) != 3 or any(r % shards for r in rungs):
            raise AssertionError(f"tiers_mesh: tail rungs {rungs}")
        dead = [int(j) for j in range(0, n, n // 24)][:24]
        dead += [n + j for j in range(0, 4096, 512)][: 32 - len(dead)]
        for x in (idx, one):
            x.delete(dead)
        (d_m, i_m, st_m), mesh_s = run(
            "mutable", lambda: idx.search_certified(q), shards)
        ref["mutable"] = ((d_m, i_m), mesh_s)
        # the (1, 1) index on the first 256 queries (a cut for time: the
        # tail's host f64 scan is most of a mutated call)
        (d_1, i_1, _), one_s = run(
            "mutable (1, 1)", lambda: one.search_certified(q[:256]), 1,
            on_shards=False)
        if not (np.array_equal(i_m[:256], i_1)
                and np.array_equal(d_m[:256], d_1)):
            raise AssertionError("tiers_mesh: the mesh index differs from "
                                 "the (1, 1) index")
        rows = np.concatenate([db, new])
        ids = np.arange(n + 4096)
        live = ~np.isin(ids, dead)
        oi, od = live_oracle(S["q_dev"][:256], rows[live], ids[live], k)
        recall = float(np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(i_m[:256], oi)]))
        rel = float(np.max(np.abs(d_m[:256] - od) / np.maximum(od, 1e-30)))
        if recall != 1.0 or not np.array_equal(i_m[:256], oi) or rel > 1e-12:
            raise AssertionError(f"tiers_mesh: oracle recall {recall}, "
                                 f"rel {rel}")
        # the exact f32 search: near ties may swap against the f64 oracle
        # (as the index phase's search() does), so its recall is held
        (_, i_s), search_s = run("mutable search", lambda: idx.search(q[:256]),
                                 0)
        search_recall = float(np.mean([len(set(a) & set(b)) / k
                                       for a, b in zip(i_s, oi)]))
        if search_recall < 0.999:
            raise AssertionError(f"tiers_mesh: the mesh search's recall@{k} "
                                 f"{search_recall}")
        t0 = time.perf_counter()
        rep = idx.compact()
        one.compact()
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        (d_c, i_c, _), compacted_s = run(
            "mutable compacted", lambda: idx.search_certified(q), shards)
        ref["mutable_compacted"] = ((d_c, i_c), compacted_s)
        if not (np.array_equal(i_c, i_m) and np.array_equal(d_c, d_m)):
            raise AssertionError("tiers_mesh: the compacted mesh index "
                                 "differs")
        mutable_turns = in_turns(lambda: idx.search_certified(q),
                                 lambda: one.search_certified(q), reps=2)
        del one
        # the K1 record: one shard of the compacted index against the
        # plain version, then both timed
        sub = idx._main._shards[(0, devs[0])]
        pl = sub.placement
        qp = ck.pad_queries(S["q_dev"][:1024])
        args = (qp, pl.th, pl.tl, pl.tnorm)
        kern = ck.binned_select(*args, tile_n=ck.TILE_N, arm="bf16x3")
        plain = ck.binned_select_plain(*args, tile_n=ck.TILE_N, arm="bf16x3")
        tol_q = tolerance_q(S["q_dev"][:1024], tmax=pl.db_norm_max)
        k1_err = max(
            checks["k1_tiers_mesh"].values("cd@shard", kern[0], plain[0],
                                           tol_q),
            checks["k1_tiers_mesh"].values("bounds@shard", kern[2], plain[2],
                                           tol_q))
        del kern, plain
        k1_ms = time_cuda(lambda: ck.binned_select(*args, tile_n=ck.TILE_N,
                                                   arm="bf16x3"), 3)
        k1_plain_ms = time_cuda(lambda: ck.binned_select_plain(
            *args, tile_n=ck.TILE_N, arm="bf16x3"), 1)
        n_p, dp = pl.th.shape
        k1_bound = f32_bound(qp.shape[0], pl.n_train, dp, n_p // ck.TILE_N,
                             ck.SURVIVORS)
        k1_rows = pl.n_train
        del args, qp, sub, pl
        # -- the compacted rows on the 1 x 2 x 2 host mesh: bitwise flat
        snap = idx._snapshot()
        host = MutableIndex(snap.main._host_train(), snap.base_ids, k=k,
                            reserve=32,
                            mesh=make_host_mesh(1, 2, 2, devices=devs))
        (d_h, i_h, _), host_s = run(
            "mutable host mesh", lambda: host.search_certified(q), shards)
        if not (np.array_equal(d_h, d_c) and np.array_equal(i_h, i_c)):
            raise AssertionError("tiers_mesh: the host mesh differs from "
                                 "the flat mesh")
        try:
            host.insert(new[:1], [n + 99_999])
        except Exception as e:  # noqa: BLE001 - the refusal's text
            host_refusal = f"{type(e).__name__}: {e}"
        else:
            raise AssertionError("tiers_mesh: a host-mesh write was taken")
        del host, snap
        out["mutable"] = {
            "queries": 1024, "reserve": 32, "tail_rungs": rungs,
            "deleted": len(dead), "build_s": build_s,
            "k1_launches_per_call": shards,
            "fallback_queries": st_m["fallback_queries"],
            "bitwise_one_device": True, "oracle_queries": 256,
            "recall_at_k": recall, "max_rel_dist_err_f64": rel,
            "search_recall_at_k": search_recall, "search_s": search_s,
            "compaction": rep, "compact_both_s": compact_s,
            "bitwise_after_compact": True, "first_call_s": {
                "mesh_1024_queries": mesh_s, "one_256_queries": one_s},
            "seconds_mesh_vs_one_in_turns": mutable_turns,
            "host_mesh": {"bitwise_flat": True, "k1_launches": shards,
                          "search_s": host_s,
                          "write_refused": host_refusal}}
        torch.cuda.empty_cache()

        # -- the MutableServingEngine reads across a background compaction
        front = idx.serving_engine(buckets=(16, 64))
        _, warm_s = host_timed(front.warmup)
        idx.insert(new[:64] + np.float32(0.5),
                   np.arange(n + 20_000, n + 20_064))
        blocks = [q[lo:lo + size] for lo, size in
                  zip((0, 64, 128, 256), (5, 16, 40, 64))]
        pre = [padded_search(idx.search, (16, 64), b) for b in blocks]
        epoch0 = idx.epoch
        reads = []
        idx.start_compactor(interval_s=0.05)
        t0 = time.perf_counter()
        while idx.epoch == epoch0 or len(reads) < 3 * len(blocks):
            if time.perf_counter() - t0 > 120:
                raise AssertionError("tiers_mesh frontend: compaction "
                                     "stalled")
            j = len(reads) % len(blocks)
            reads.append((j, front.submit(blocks[j]).result(), idx.epoch))
        idx.close()
        post = [padded_search(idx.search, (16, 64), b) for b in blocks]
        n_pre = sum(all_equal(r, pre[j]) for j, r, _ in reads)
        n_post = sum(all_equal(r, post[j]) for j, r, _ in reads)
        if any(not (all_equal(r, pre[j]) or all_equal(r, post[j]))
               for j, r, _ in reads) or not n_post:
            raise AssertionError("tiers_mesh frontend: a read is neither "
                                 "epoch's direct search")
        out["mutable_frontend"] = {
            "ladder": [16, 64], "warmup_s": warm_s, "reads": len(reads),
            "reads_equal_pre_swap": n_pre, "reads_equal_post_swap": n_post,
            "epoch": idx.epoch}
        del front, idx
        torch.cuda.empty_cache()

        # -- IVFIndex on the ivf anchor: every list probed
        n_anchor = 65_536
        uni = np.ascontiguousarray(db[:n_anchor])
        qu = q_all[:32]
        t0 = time.perf_counter()
        uidx = IVFIndex(uni, k=k, ncentroids=32, train_iters=2, mesh=mesh)
        ivf_train_s = time.perf_counter() - t0
        ref["ivf_train"] = ((uidx._centroids,), ivf_train_s)
        brute = refine_shared_exact(uni, qu, np.arange(n_anchor,
                                                       dtype=np.int64), k)
        ivf = {}
        for label, kw, want in (
                ("exact", {"selector": "exact"}, 0),
                ("pallas_bf16x3_tiled", {"selector": "pallas",
                                         "precision": "bf16x3",
                                         "kernel": "tiled"}, 1)):
            (d, i, st), wall = run(
                f"ivf {label}", lambda kw=kw: uidx.search_certified(
                    qu, nprobe=uidx.ncentroids, **kw), want,
                on_shards=False)
            if st["groups"] != 1 or not all_equal((d, i), brute):
                raise AssertionError(f"tiers_mesh ivf {label}: not brute "
                                     f"force bitwise ({st['groups']} "
                                     f"groups)")
            ivf[label] = {"wall_s": wall, "groups": st["groups"],
                          "k1_launches": want,
                          "fallback_queries": st["fallback_queries"]}
            ref["ivf_exact" if label == "exact" else "ivf_pallas"] = (
                (d, i), wall)
        oi_a, od_a = live_oracle(torch.from_numpy(qu).to(dev), uni,
                                 np.arange(n_anchor), k)
        if not np.array_equal(brute[1], oi_a):
            raise AssertionError("tiers_mesh ivf: ids are not the oracle's")
        uone = IVFIndex(uni, k=k, ncentroids=32, train_iters=2)
        ivf_turns = in_turns(
            lambda: uidx.search_certified(qu, nprobe=32),
            lambda: uone.search_certified(qu, nprobe=32), reps=1)
        out["ivf"] = {"rows": n_anchor, "queries": 32, "ncentroids": 32,
                      "train_iters": 2, "train_s": ivf_train_s,
                      "runs": ivf, "bitwise_brute_force": True,
                      "oracle_ids": True,
                      "seconds_mesh_vs_one_in_turns": ivf_turns}

        # -- the IVF tuner on the mesh: two candidates of the anchor's 32
        # lists under the pallas selector, one timed run each, on the first
        # 8 queries (a cut for time: every uniform query is a probe group
        # of its own at nprobe 8, each group's block placed afresh and all
        # repaired on the host, 0.17 s a group).  Its index trains as uidx
        # did (same seed and iterations), so uidx gives each candidate's
        # probe groups; every gated and timed search launches the
        # selector's kernel (knn_search_pallas over a group's gathered
        # block at IVF's default precision, highest: K2's tiled entry) once
        # a probe group, on the mesh's first device, and no other kernel
        from knn_tpu_torch.tuning import autotune_ivf

        qt = qu[:8]
        tune_grid = [{"ncentroids": 32, "nprobe": p} for p in (32, 8)]
        groups = {c["nprobe"]: uidx.search_certified(
            qt, nprobe=c["nprobe"], selector="pallas")[2]["groups"]
            for c in tune_grid}
        want_k2 = 2 * sum(groups.values())  # the gate's search + one run
        entry, tune_s = counted(
            "tiers_mesh", "autotune_ivf", lambda: autotune_ivf(
                uni, qt, k, mesh=mesh, runs=1, grid=tune_grid,
                selector="pallas", train_iters=2, seed=0),
            {"tiled_highest": want_k2})
        ref["autotune_ivf"] = ((), tune_s)
        win = entry["knobs"]["nprobe"]
        if (entry["errors"] or None in entry["timings_ms"].values()
                or len(entry["timings_ms"]) != 2 or not all_equal(
                    uidx.search_certified(qt, nprobe=win,
                                          selector="pallas")[:2],
                    uone.search_certified(qt, nprobe=win,
                                          selector="pallas")[:2])):
            raise AssertionError(f"tiers_mesh autotune_ivf: {entry}")
        out["autotune_ivf"] = {
            "queries": 8, "grid": [ivf_label(c) for c in tune_grid],
            "runs": 1,
            "selector": "pallas", "winner": entry["winner"],
            "timings_ms": entry["timings_ms"], "gate_passed": 2,
            "probe_groups": {ivf_label(c): groups[c["nprobe"]]
                             for c in tune_grid},
            "k2_launches": want_k2, "winner_bitwise_one_device": True,
            "stats_per_candidate": entry["stats_per_candidate"],
            "seconds": tune_s}
        del uidx, uone

        # -- the join of the 4,096 queries and the certified stream on a
        # placement of the main rows on the mesh
        knn = ShardedKNN(db, k=k, mesh=mesh, merge="allgather")
        n_sb = -(-q_all.shape[0] // 1024)
        (sd, si, sst), stream_s = run(
            "join stream", lambda: knn_join(knn, q_all, mode="stream",
                                            superblock_rows=1024), 0)
        ref["join_stream"] = ((sd, si), stream_s)
        loop = [knn.search(q_all[lo:lo + 1024])
                for lo in range(0, q_all.shape[0], 1024)]
        if not (np.array_equal(sd, np.concatenate(
                [x[0].cpu().numpy() for x in loop]))
                and np.array_equal(si, np.concatenate(
                    [x[1].cpu().numpy() for x in loop]))):
            raise AssertionError("tiers_mesh join stream: not its looped "
                                 "mesh search")
        del loop
        (cd, ci, cst), cert_s = run(
            "join certified", lambda: knn_join(
                knn, q_all, mode="certified", superblock_rows=1024),
            shards * n_sb)
        ref["join_certified"] = ((cd, ci), cert_s)
        looped = [knn.search_certified(q_all[lo:lo + 1024])
                  for lo in range(0, q_all.shape[0], 1024)]
        if not (np.array_equal(cd, np.concatenate([x[0] for x in looped]))
                and np.array_equal(ci, np.concatenate(
                    [x[1] for x in looped]))):
            raise AssertionError("tiers_mesh join certified: not its looped "
                                 "mesh search_certified")
        oracle_check(S, cd, ci, "tiers_mesh join certified")
        # the certified stream on the first 2,048 queries, two segments
        # (a cut for time)
        q_st = q_all[:2048]
        n_seg = -(-q_st.shape[0] // 1024)
        direct = knn.search_certified(q_st)
        work = tempfile.mkdtemp(prefix="chip_smoke_tiers_")
        try:
            (pd, pi, pst), stream_cert_s = run(
                "certified stream", lambda: streaming_certified_knn(
                    db, q_st, k, os.path.join(work, "s"),
                    segment_size=1024, mesh=mesh), shards * n_seg)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if not (np.array_equal(pd, direct[0])
                and np.array_equal(pi, direct[1])):
            raise AssertionError("tiers_mesh: the certified stream is not "
                                 "the direct mesh search_certified")
        ref["certified_stream"] = ((pd, pi), stream_cert_s)
        (lo, hi), minmax_s = run(
            "minmax", lambda: sharded_minmax([db, q_all], mesh=mesh), 0)
        ref["minmax"] = ((lo, hi), minmax_s)
        join_turns = in_turns(
            lambda: knn_join(knn, q_all, mode="certified",
                             superblock_rows=1024),
            lambda: knn_join(S["knn"], q_all, mode="certified",
                             superblock_rows=1024), reps=1)
        out["join"] = {
            "rows": q_all.shape[0], "superblock_rows": 1024,
            "stream": {"wall_s": stream_s, "superblocks": sst["superblocks"],
                       "bitwise_looped_search": True, "launches": 0},
            "certified": {"wall_s": cert_s, "k1_launches": shards * n_sb,
                          "fallback_queries": cst["fallback_queries"],
                          "bitwise_looped_search_certified": True},
            "seconds_certified_mesh_vs_one_in_turns": join_turns}
        out["certified_stream"] = {
            "queries": q_st.shape[0], "segments": n_seg,
            "wall_s": stream_cert_s, "k1_launches": shards * n_seg,
            "bitwise_direct_search_certified": True,
            "certified": pst["certified"]}
        del looped, direct

        # -- ServingEngine on the mesh: the bench trace
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        eng = ServingEngine(knn, min_bucket=16, max_bucket=512)
        _, serve_warm_s = host_timed(eng.warmup)
        t_rng = np.random.default_rng(42)
        sizes = np.exp(t_rng.uniform(0.0, np.log(512), size=48)).astype(
            np.int64).clip(1, 512)
        reqs = []
        for size in sizes:
            lo = int(t_rng.integers(0, max(1, q_all.shape[0] - int(size))))
            reqs.append(q_all[lo:lo + int(size)])
        (res1, rep1), _ = run("serving", lambda: eng.replay(reqs, depth=2),
                              0)
        (res2, rep2), _ = run("serving again",
                              lambda: eng.replay(reqs, depth=2), 0)
        if not (rep1["compile_count"] == rep2["compile_count"] == 6):
            raise AssertionError(
                f"tiers_mesh serving: {rep1['compile_count']} / "
                f"{rep2['compile_count']} captures, not 6 and 6")
        for j, req in enumerate(reqs):
            padded = np.zeros((bucket_for(eng.buckets, req.shape[0]), dim),
                              np.float32)
            padded[:req.shape[0]] = req
            want = tuple(t.cpu().numpy()[:req.shape[0]]
                         for t in knn.search(padded))
            if not (all_equal(res1[j], want) and all_equal(res2[j], want)):
                raise AssertionError("tiers_mesh serving: a request differs "
                                     "from the eager mesh search")
        one_eng = ServingEngine(S["knn"], min_bucket=16, max_bucket=512)
        one_eng.warmup()
        serve_turns = in_turns(lambda: eng.replay(reqs, depth=2),
                               lambda: one_eng.replay(reqs, depth=2),
                               reps=1)
        out["serving"] = {
            "requests": 48, "ladder": list(eng.buckets),
            "warmup_s": serve_warm_s,
            "graphs": rep2["compile_count"],
            "captures_second_replay": 0,
            "bitwise_eager_mesh_search": True,
            "sustained_qps": rep2["sustained_qps"],
            "seconds_mesh_vs_one_in_turns": serve_turns}
        # the placement stays for the mesh_paths phase
        S["mesh_knn"] = knn
        del eng, one_eng, knn
        torch.cuda.empty_cache()
        records["k1_tiers_mesh"].update(
            launches=k1_on_shards, ms=k1_ms, plain_ms=k1_plain_ms,
            bound_ms=k1_bound["bound_ms"], bound_by=k1_bound["bound_by"])
        t_span = time.perf_counter()
        span = collect_children(span_procs, "tiers_mesh spanning", 900)
        out["spanning"] = tiers_spanning_checks(
            S, span, span_work, ref, want_k2, groups)
        out["spanning"]["waited_s"] = time.perf_counter() - t_span
        out.update(k1_launches_total=k1_total,
                   k1_launches_on_shards=k1_on_shards,
                   k1_shard={"rows": k1_rows, "queries": 1024,
                             "ms": k1_ms, "plain_ms": k1_plain_ms,
                             "bound": k1_bound, "max_abs_err": k1_err},
                   phase_s=time.perf_counter() - t_phase)
        emit(out)

    def phase_mesh_paths(S):
        """Docstring item 4d: the host-RAM tier, pq, the pipeline and
        search_bucketed on the 1 x 4 logical mesh of the card at the main
        shape (the tier also on 2 x 2), each path's launches read around
        it alone."""
        from knn_tpu_torch import ShardedKNN
        from knn_tpu_torch.analysis import hbm
        from knn_tpu_torch.convert import pq_from_numpy
        from knn_tpu_torch.join import knn_join
        from knn_tpu_torch.ops import pq as ppq
        from knn_tpu_torch.parallel.mesh import make_mesh

        t_phase = time.perf_counter()
        n, dim, k, q_all = S["n"], S["dim"], S["k"], S["q_np"]
        db, one, n_or = S["db_np"], S["knn"], S["n_or"]
        devs = [torch.device("cuda", torch.cuda.current_device())] * 4
        mesh = make_mesh(1, 4, devices=devs)
        knn = S.get("mesh_knn")
        if knn is None:
            knn = S["mesh_knn"] = ShardedKNN(db, k=k, mesh=mesh,
                                             merge="allgather")
        out = {"phase": "mesh_paths", "n": n, "dim": dim, "k": k,
               "mesh": "1 x 4", "devices": "cuda:0 x 4 (logical)",
               "nvidia_smi": smi}
        if "oi" not in S:
            od, oi = f64_oracle(S["q_dev"][:n_or], one.placement.db, k)
            S["od"], S["oi"] = od.cpu().numpy(), oi.cpu().numpy()

        def run(label, fn, want):
            return counted("mesh_paths", label, fn, want)

        # -- the host-RAM tier on 1 x 4 and 2 x 2 behind 128 MiB
        budget = 128 << 20
        corpus = hbm.placement_bytes(n, dim)
        (dr, ir), _ = run("resident mesh search",
                          lambda: knn.search(q_all, k=k + 1), {})
        dr, ir = dr.cpu().numpy().astype(np.float64), ir.cpu().numpy()
        q64 = q_all.astype(np.float64)
        tol = 64 * float(np.finfo(np.float32).eps) * (
            (q64 ** 2).sum(-1) + float(one.placement.db_norm_max))
        sep = (dr[:, k] - dr[:, k - 1]) > 2 * tol
        tiers = {}
        for label, shape in (("1 x 4", (1, 4)), ("2 x 2", (2, 2))):
            m = make_mesh(*shape, devices=devs)
            tier = ShardedKNN(db, k=k, mesh=m, hbm_budget_bytes=budget)
            plan = tier.hosttier_stats()
            want = hbm.n_sweeps(n, dim, budget, shard_multiple=shape[1])
            (d, i), wall = run(f"tier {label}", lambda: tier.search(q_all),
                               {})
            last = tier.hosttier_stats()["last_search"]
            # one card holds each db block once a slot, whatever the
            # query shards
            slot_bytes = plan["depth"] * plan["segment_rows"] * dim * 4
            if plan["sweeps"] != want or last["sweeps"] != want \
                    or last["device_buffer_bytes"] != slot_bytes \
                    or slot_bytes >= corpus:
                raise AssertionError(
                    f"mesh_paths tier {label}: sweeps {last['sweeps']} / "
                    f"{plan['sweeps']}, planned {want}; slots "
                    f"{last['device_buffer_bytes']} B (want {slot_bytes}, "
                    f"corpus {corpus})")
            d, i = d.cpu().numpy().astype(np.float64), i.cpu().numpy()
            ratio = float((np.abs(d - dr[:, :k]) / tol[:, None]).max())
            sets = all(set(a) == set(b) for a, b, s in
                       zip(i, ir[:, :k], sep) if s)
            recall = float(np.mean([len(set(a) & set(b)) / k
                                    for a, b in zip(i[:n_or], S["oi"])]))
            if ratio > 1.0 or not sets or recall != 1.0:
                raise AssertionError(
                    f"mesh_paths tier {label}: distance error / bound "
                    f"{ratio}, sets equal where separated {sets}, "
                    f"recall@{k} {recall}")
            tiers[label] = {
                "db_shards": shape[1], "query_shards": shape[0],
                "segment_rows": plan["segment_rows"], "sweeps": want,
                "wall_s": wall, "sweep_walls_s": last["sweep_walls_s"],
                "h2d_gbps": last["h2d_gbps"], "slot_bytes": slot_bytes,
                "corpus_bytes": corpus, "dist_err_over_bound": ratio,
                "separated_queries": int(sep.sum()),
                "bitwise_resident": bool(
                    np.array_equal(d, dr[:, :k])
                    and np.array_equal(i, ir[:, :k])),
                "recall_at_k": recall}
            if shape == (1, 4):
                tier14 = tier
            else:
                del tier
        # the tiered join: 1,024-row superblocks, bitwise the looped tier
        (jd, ji, jst), join_s = run(
            "tiered join", lambda: knn_join(tier14, q_all,
                                            superblock_rows=1024), {})
        loop = [tier14.search(q_all[lo:lo + 1024])
                for lo in range(0, q_all.shape[0], 1024)]
        if not (np.array_equal(jd, np.concatenate(
                [x[0].cpu().numpy() for x in loop]))
                and np.array_equal(ji, np.concatenate(
                    [x[1].cpu().numpy() for x in loop]))):
            raise AssertionError("mesh_paths: the tiered join is not its "
                                 "looped mesh tier search")
        del loop
        tier_turns = in_turns(lambda: tier14.search(q_all),
                              lambda: hosttier_program(S).search(q_all))
        out["tier"] = {"budget_bytes": budget, "queries": q_all.shape[0],
                       "meshes": tiers, "launches": 0,
                       "join": {"superblock_rows": 1024,
                                "order": jst["order"],
                                "superblocks": jst["superblocks"],
                                "db_segments": jst["db_segments"],
                                "wall_s": join_s,
                                "bitwise_looped_tier_search": True},
                       "seconds_mesh_vs_one_in_turns": tier_turns}
        del tier14
        torch.cuda.empty_cache()

        # -- pq: the main pq state carried across, 1,024 queries
        q = q_all[:1024]
        pq = main_pq(S)
        t0 = time.perf_counter()
        pq_from_numpy(knn, pq["books"].cpu().numpy(),
                      pq["codes"].cpu().numpy(), pq["stats"], pq["dsub"],
                      dim, ncodes=pq["ncodes"])
        carry_s = time.perf_counter() - t0
        pq_runs = {}
        k7_launches = 0
        for label, kw, own in (
                ("tiled", {"kernel": "tiled"}, {"tiled_pq": 4}),
                ("tiled_db_major", {"kernel": "tiled",
                                    "grid_order": "db_major"},
                 {"tiled_pq": 4, "db_major_pq": 4}),
                ("streaming", {"kernel": "streaming"}, {"streaming_pq": 4})):
            (d, i, st), wall = run(
                f"pq {label}", lambda kw=kw: knn.search_certified(
                    q, margin=28, precision="pq", **kw), own)
            k7_launches += own.get("tiled_pq", 0)
            (rd, ri, rst), one_s = run(
                f"pq {label} (1, 1)", lambda kw=kw: one.search_certified(
                    q, margin=28, precision="pq", **kw),
                {key: 1 for key in own})
            if not np.array_equal(i, ri) or \
                    not np.array_equal(i[:n_or], S["oi"]):
                raise AssertionError(f"mesh_paths pq {label}: indices "
                                     f"differ from the (1, 1) placement's "
                                     f"or the oracle's")
            pq_runs[label] = {"wall_s": wall, "one_wall_s": one_s,
                              "launches": own,
                              "certified": st["certified"],
                              "fallback_queries": st["fallback_queries"]}
        pq_turns = in_turns(
            lambda: knn.search_certified(q, margin=28, precision="pq"),
            lambda: one.search_certified(q, margin=28, precision="pq"))
        # K7 on one shard: bitwise its plain version, timed
        sub = knn._shards[(0, devs[0])]
        entry = sub._pq_placement()
        q_dev = torch.from_numpy(q).to(dev)
        args = (ck.pq_luts(q_dev, entry["books"]), *entry["parts"])
        ka = {"tile_n": ck.TILE_N, "arm": "pq"}
        plain, k7_plain_ms = timed_once(
            lambda: ck.binned_select_plain(*args, **ka))
        k7_err = bitwise("binned_select_pq@mesh shard",
                         ck.binned_select(*args, **ka), plain)
        checks["k7_mesh"].max_abs_err = k7_err
        del plain
        k7_ms = time_cuda(lambda: ck.binned_select(*args, **ka), 3)
        geo = ck.emit_geometry(ck.TILE_N)
        m_sub = args[1].shape[1]
        k7_bound = pq_bound(q.shape[0], sub._n_valid, m_sub,
                            args[0].shape[1] // m_sub,
                            args[-1].shape[1] // ck.TILE_N, geo[2], geo[3],
                            n_sm, sm_clock_hz())
        k7_rows, k7_padded = sub._n_valid, args[1].shape[0]
        del args, sub, entry
        # the mesh's own training bitwise the (1, 1)'s, on 65,536 rows and
        # their first 32 dims: 8 of the 32 subspaces, each trained as the
        # main placement's are (cuts for time: a subspace's farthest-point
        # init alone takes ~0.4 s of host time)
        rows = np.ascontiguousarray(db[:65_536, :32])
        own_res, own_s = host_timed(lambda: ppq.train_pq(rows, mesh=mesh))
        one_res, one_train_s = host_timed(
            lambda: ppq.train_pq(rows, device=dev))
        if not (np.array_equal(own_res.codebooks, one_res.codebooks)
                and np.array_equal(own_res.codes, one_res.codes)):
            raise AssertionError("mesh_paths: the mesh's pq training differs "
                                 "from the (1, 1) training")
        del own_res, one_res, rows
        out["pq"] = {"queries": q.shape[0], "carried_s": carry_s,
                     "runs": pq_runs,
                     "seconds_mesh_vs_one_in_turns": pq_turns,
                     "k7_shard": {"rows": k7_rows, "padded_rows": k7_padded,
                                  "queries": q.shape[0], "ms": k7_ms,
                                  "plain_ms": k7_plain_ms, "bound": k7_bound,
                                  "bitwise_plain": True},
                     "training_65536": {"dims": 32, "subspaces": 8,
                                        "mesh_s": own_s,
                                        "one_s": one_train_s,
                                        "bitwise_one": True}}
        records["k7_mesh"].update(
            launches=k7_launches, ms=k7_ms, plain_ms=k7_plain_ms,
            bound_ms=k7_bound["bound_ms"], bound_by=k7_bound["bound_by"])

        # -- the pipeline: four 1,024-query batches, depth 2
        pipe = {}
        for kern, key in (("fused", "k11"), ("tiled", "k1")):
            kw = dict(margin=28, kernel=kern, batch_size=1024)
            (d, i, st), seq_s = run(f"{kern} sequential",
                                    lambda kw=kw: knn.search_certified(
                                        q_all, **kw), {key: 16})
            (pd, pi, pst), pipe_s = run(
                f"{kern} pipeline", lambda kw=kw: knn.search_certified(
                    q_all, overlap=True, overlap_depth=2, **kw), {key: 16})
            if not (np.array_equal(pd, d) and np.array_equal(pi, i)):
                raise AssertionError(f"mesh_paths {kern}: the pipeline is "
                                     f"not the sequential mesh call")
            if pst["pipeline"]["batches"] != 4 or \
                    pst["pipeline"]["depth"] != 2:
                raise AssertionError(f"mesh_paths {kern}: pipeline stats "
                                     f"{pst['pipeline']}")
            (rd, ri, rst), one_s = run(
                f"{kern} pipeline (1, 1)", lambda kw=kw: one.search_certified(
                    q_all, overlap=True, overlap_depth=2, **kw), {key: 4})
            rows_differ = held(f"mesh_paths {kern} pipeline", pd, pi, pst,
                               rd, ri, rst)
            pipe[kern] = {"launches": 16, "sequential_s": seq_s,
                          "pipeline_s": pipe_s, "one_pipeline_s": one_s,
                          "bitwise_sequential": True,
                          "indices_bitwise_one": True,
                          "d_rows_not_bitwise_one": rows_differ,
                          "pipeline": pst["pipeline"],
                          "fallback_queries": pst["fallback_queries"]}
        kw = dict(margin=28, kernel="fused", batch_size=1024, overlap=True,
                  overlap_depth=2)
        pipe_turns = in_turns(lambda: knn.search_certified(q_all, **kw),
                              lambda: one.search_certified(q_all, **kw))
        # K11 on one shard at the pipeline's geometry (a 1,024-query
        # batch, keep m + 2 = 130)
        sub = knn._shards[(0, devs[0])]
        spl = sub.placement
        q1 = S["q_dev"][:1024]
        parts = (spl.th, spl.tl, spl.tnorm)
        k11_case = compare_k11(checks["k11_mesh"], q1, spl.db, ck.TILE_N, 130,
                               parts=parts)
        qp1 = ck.pad_queries(q1)
        k11_ms = time_cuda(lambda: ck.fused_select(
            qp1, *parts, tile_n=ck.TILE_N, keep=130, arm="bf16x3"), 3)
        seg = ck.kernel_segment_tiles(1024, spl.th.shape[0] // ck.TILE_N,
                                      q1.device, "fused", "bf16x3")
        _, k11_plain_ms = timed_once(lambda: ck.fused_select_plain(
            qp1, *parts, tile_n=ck.TILE_N, keep=130, block_q=ck.QUERY_BLOCK,
            seg_tiles=seg, arm="bf16x3"))
        n_p, dp = spl.th.shape
        k11_bound = f32_bound(1024, spl.n_train, dp, n_p // ck.TILE_N,
                              ck.SURVIVORS)
        k11_rows = spl.n_train
        del sub, spl, parts, qp1
        records["k11_mesh"].update(
            launches=pipe["fused"]["launches"], ms=k11_ms,
            plain_ms=k11_plain_ms, bound_ms=k11_bound["bound_ms"],
            bound_by=k11_bound["bound_by"])
        # int8 on the draw cast to uint8: 1,024 queries in four batches
        u8 = ShardedKNN(db.astype(np.uint8), k=k, mesh=mesh)
        q8 = q.astype(np.uint8).astype(np.float32)
        kw8 = dict(margin=28, precision="int8", kernel="tiled",
                   batch_size=256)
        (d8, i8, st8), int8_seq_s = run(
            "int8 sequential", lambda: u8.search_certified(q8, **kw8),
            {"tiled_int8": 16})
        (p8d, p8i, p8st), int8_pipe_s = run(
            "int8 pipeline", lambda: u8.search_certified(
                q8, overlap=True, overlap_depth=2, **kw8),
            {"tiled_int8": 16})
        if not (np.array_equal(p8d, d8) and np.array_equal(p8i, i8)):
            raise AssertionError("mesh_paths int8: the pipeline is not the "
                                 "sequential mesh call")
        del u8
        pipe["int8"] = {"queries": 1024, "batches": 4, "launches": 16,
                        "sequential_s": int8_seq_s,
                        "pipeline_s": int8_pipe_s, "bitwise_sequential": True,
                        "certified": p8st["certified"],
                        "fallback_queries": p8st["fallback_queries"]}
        out["pipeline"] = {
            "queries": q_all.shape[0], "batch_size": 1024, "depth": 2,
            "runs": pipe, "seconds_mesh_vs_one_in_turns": pipe_turns,
            "k11_shard": {"rows": k11_rows, "queries": 1024, "keep": 130,
                          "ms": k11_ms, "plain_ms": k11_plain_ms,
                          "bound": k11_bound, **k11_case}}
        torch.cuda.empty_cache()

        # -- search_bucketed: the bench trace's first 16 requests
        t_rng = np.random.default_rng(42)
        sizes = np.exp(t_rng.uniform(0.0, np.log(512), size=48)).astype(
            np.int64).clip(1, 512)
        reqs = []
        for size in sizes[:16]:
            lo = int(t_rng.integers(0, max(1, q_all.shape[0] - int(size))))
            reqs.append(q_all[lo:lo + int(size)])
        ladder = dict(min_bucket=16, max_bucket=512)
        (served, bucketed_s) = host_timed(
            lambda: [knn.search_bucketed(r, **ladder) for r in reqs])
        buckets = knn._serving_engines[(None, 16, 512)].buckets
        for req, res in zip(reqs, served):
            if not all_equal(res, padded_search(knn.search, buckets, req)):
                raise AssertionError("mesh_paths search_bucketed: a request "
                                     "differs from the eager mesh search")
        bucket_turns = in_turns(
            lambda: [knn.search_bucketed(r, **ladder) for r in reqs],
            lambda: [one.search_bucketed(r, **ladder) for r in reqs])
        out["search_bucketed"] = {
            "requests": len(reqs), "ladder": list(buckets),
            "first_pass_s": bucketed_s,
            "bitwise_eager_mesh_search": True,
            "compile_cache": knn.compile_cache_stats()["program_cache"],
            "seconds_mesh_vs_one_in_turns": bucket_turns}
        out["phase_s"] = time.perf_counter() - t_phase
        emit(out)

    def phase_obs(S):
        """The telemetry core on the main path: warm main calls with obs on
        and off in turns (bitwise the same, q/s medians and their ratio),
        the certified counters against the stats, the counted
        certificate's margin histogram, a device trace of a main call with
        obs on and one with it off (the same synchronizations and
        device-to-host copies), the roofline shares of the call and of K1,
        the metrics server's /metrics and /statusz, and 32 requests through
        a QueryQueue, each with its own trace id."""
        import urllib.request

        from knn_tpu_torch import ShardedKNN, obs
        from knn_tpu_torch.obs import names as mn
        from knn_tpu_torch.obs import roofline
        from knn_tpu_torch.serving import QueryQueue, ServingEngine

        t_phase = time.perf_counter()
        knn, n_q = S["knn"], S["n_q"]
        ref = S.get("tiled")
        walls = {"on": [], "off": []}

        def paired_rounds(n_rounds):
            nonlocal ref
            for mode in ("on", "off", "off", "on") * n_rounds:
                obs.reset(enabled=mode == "on")
                (d, i, _), wall = timed_search(S)
                walls[mode].append(wall)
                if ref is None:
                    ref = (d, i)
                elif not (np.array_equal(d, ref[0])
                          and np.array_equal(i, ref[1])):
                    raise AssertionError(
                        f"obs {mode}: d, i differ from the main run")

        def median_qps(mode):
            return float(np.median([n_q / w for w in walls[mode]]))

        # a call's wall is half host work and varies by ~6% (sd ~3 ms of
        # ~50 ms on an H100's host); obs on adds ~0.1 ms of it.  Twelve
        # rounds (48 calls) before the first verdict, two more sets of
        # twelve while the medians differ by more than 3%: three rounds
        # to nine read 0.963 and 0.954 on two runs, where 160 calls in
        # turns after the same phases read 1.003 and 0.996
        gc.collect()  # no pending full collection inside a timed call
        paired_rounds(12)
        rounds = 12
        while median_qps("on") < 0.97 * median_qps("off") and rounds < 36:
            paired_rounds(12)
            rounds += 12
        qps_on, qps_off = median_qps("on"), median_qps("off")
        S.setdefault("measured_qps", []).extend(
            n_q / w for mode in walls for w in walls[mode])
        if qps_on < 0.97 * qps_off:
            raise AssertionError(
                f"obs on {qps_on:.0f} q/s < 0.97 x obs off {qps_off:.0f}")

        obs.reset(enabled=True)
        obs.reset_event_log()
        (d, i, stats), _ = timed_search(S)
        counters = {
            "certified_queries": obs.counter(
                mn.CERTIFIED_QUERIES, selector="pallas").get(),
            "certified_fallbacks": obs.counter(
                mn.CERTIFIED_FALLBACKS, selector="pallas").get(),
            "rank_corrected": obs.counter(mn.CERTIFIED_RANK_CORRECTED).get()}
        if (counters["certified_queries"] != n_q
                or counters["certified_fallbacks"] != stats["fallback_queries"]
                or counters["rank_corrected"]
                != stats["rank_corrected_queries"]):
            raise AssertionError(f"obs counters {counters} != stats {stats}")
        # the pallas certificate records no margin (its bound stays on the
        # card); the counted one does, for each query it certifies
        n_ex = 512
        _, _, st_ex = knn.search_certified(S["q_np"][:n_ex], margin=28,
                                           selector="exact")
        margins = obs.histogram(mn.CERTIFIED_MARGIN,
                                path="sharded").summary()
        if margins["count"] != st_ex["certified"] or obs.counter(
                mn.CERTIFIED_QUERIES, selector="exact").get() != n_ex:
            raise AssertionError(
                f"margin count {margins['count']} != certified "
                f"{st_ex['certified']}")

        # one warm main call traced with obs on, one with it off
        trace_on = traced_search(knn, S["q_np"], section="main",
                                 require="binned_select_")
        obs.reset(enabled=False)
        trace_off = traced_search(knn, S["q_np"], section="main",
                                  require="binned_select_")
        obs.reset(enabled=True)
        for key in ("syncs", "d2h_copies", "memcpy_async_calls"):
            if trace_on[key] != trace_off[key]:
                raise AssertionError(
                    f"obs on/off {key}: {trace_on[key]} != {trace_off[key]}")

        # the roofline shares: the measured call and the K1 launch
        block = roofline.attribute(
            roofline.pallas_cost_model(n=S["n"], d=S["dim"], k=S["k"],
                                       nq=n_q, device_kind=kind), qps_on)
        k1_ms = records["k1"]["ms"] or time_cuda(
            lambda: ck.binned_select(S["qp"], knn.placement.th,
                                     knn.placement.tl, knn.placement.tnorm,
                                     tile_n=ck.TILE_N, arm="bf16x3"), 3)
        k1_pct = S["bound"]["bound_ms"] / k1_ms
        if roofline.validate_block(block) or block["roofline_pct"] > 1.0 \
                or k1_pct > 1.0:
            raise AssertionError(
                f"roofline: call {block['roofline_pct']}, K1 {k1_pct}, "
                f"{roofline.validate_block(block)}")
        catalog_check("obs", "roofline", block)
        label = roofline.config_label(S["n"], S["dim"], S["k"],
                                      device_kind=kind)
        roofline.publish(label, block)

        # 32 requests through a queue over a small engine's graphs
        rng = np.random.default_rng(5)
        small = ShardedKNN((rng.random((65_536, S["dim"])) * 128.0).astype(
            np.float32), k=10)
        eng = ServingEngine(small, buckets=(8, 16, 32, 64, 128))
        eng.warmup()
        obs.reset_event_log()
        # a full collection of this process's objects pauses every thread
        # for 0.13-0.20 s on the H100's host (two of them in this phase),
        # over the queue-wait SLO's 0.1 s: collect before the window, so
        # none lands in the 32 requests' waits
        gc.collect()
        with QueryQueue(eng, max_wait_ms=2.0) as qq:
            futs = [qq.submit(S["q_np"][4 * j: 4 * j + 4])
                    for j in range(32)]
            res = [f.result(timeout=120) for f in futs]
            ready = obs.health.probe()
        ids = [f.trace_id for f in futs]
        events = obs.get_event_log().recent()
        queued = {e["trace_id"] for e in events
                  if e.get("span") == "serving.queued_request"}
        batches = {e["batch_trace_id"]: e["member_trace_ids"]
                   for e in events if e.get("name") == "queue.dispatch"}
        requests = {e.get("trace_id") for e in events
                    if e.get("span") == "serving.request"}
        if (None in ids or len(set(ids)) != 32 or queued != set(ids)
                or sorted(t for m in batches.values() for t in m)
                != sorted(ids) or not set(batches) <= requests
                or not ready["ready"]
                or any(r[1].shape != (4, 10) for r in res)):
            raise AssertionError(
                f"queue trace ids: {len(set(ids))} distinct, queued spans "
                f"{len(queued)}, batches {len(batches)}, ready {ready}")
        # every queued request's waterfall rebuilds from the spans, its
        # segments tiling its arrival-to-result latency within tolerance
        from knn_tpu_torch.obs import waterfall

        t_step = time.perf_counter()
        wfs = waterfall.reconstruct(events)
        broken = [t for t in ids
                  if t not in wfs or not wfs[t]["complete"]
                  or wfs[t]["kind"] != "queued"]
        if broken:
            raise AssertionError(f"queue waterfalls: {len(broken)} of 32 "
                                 f"do not tile: {wfs.get(broken[0])}")
        agg = waterfall.attribute({t: wfs[t] for t in ids})
        queue_wf = {
            "requests": len(ids),
            "max_gap_over_tolerance": max(
                max(wfs[t]["unattributed_s"], wfs[t]["overlap_s"])
                / wfs[t]["tolerance_s"] for t in ids),
            "p50_dominant": agg["overall"]["p50_band"]["dominant"],
            "p99_dominant": agg["overall"]["p99_band"]["dominant"],
            "p99_share": agg["overall"]["p99_band"]["share"],
            "elapsed_s": time.perf_counter() - t_step}

        # the exporters, scraped from an ephemeral port; then the fleet
        # plane over it (after the paired rounds: nothing here is timed)
        server = obs.start_metrics_server(0)
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}"
            text = urllib.request.urlopen(f"{base}/metrics",
                                          timeout=30).read().decode()
            statusz = json.loads(urllib.request.urlopen(
                f"{base}/statusz", timeout=30).read())
            fleet_out = fleet_checks(base)
        finally:
            server.shutdown()
            server.server_close()
        samples = 0
        for line in text.splitlines():
            if line.startswith("#"):
                continue
            float(line.rsplit(" ", 1)[1])  # "name{labels} value"
            samples += 1
        inv = statusz["devices"]
        if (samples == 0 or "knn_tpu_queue_requests_total 32.0" not in text
                or f'knn_tpu_roofline_pct{{config="{label}"}}' not in text
                or inv.get("kinds") != ["NVIDIA H100 80GB HBM3"]
                or label not in statusz["roofline"]):
            raise AssertionError(f"/metrics or /statusz malformed: {inv}")
        del eng, small, res
        torch.cuda.empty_cache()
        top = dict(list(trace_on["kernels_ms"].items())[:5])
        emit({"phase": "obs", "rounds": rounds,
              "qps_on_median": qps_on, "qps_off_median": qps_off,
              "qps_on_over_off": qps_on / qps_off,
              "walls_on_s": walls["on"], "walls_off_s": walls["off"],
              "bitwise_on_off": True, "counters": counters,
              "fallback_queries": stats["fallback_queries"],
              "exact_margin_count": margins["count"],
              "exact_certified": st_ex["certified"],
              "trace_on": {k: trace_on[k] for k in (
                  "wall_ms", "device_busy_ms", "device_idle_share",
                  "syncs", "d2h_copies", "memcpy_async_calls",
                  "device_events_before")},
              "trace_off": {k: trace_off[k] for k in (
                  "wall_ms", "device_busy_ms", "device_idle_share",
                  "syncs", "d2h_copies", "memcpy_async_calls",
                  "device_events_before")},
              "top_device_ops_ms": top,
              "roofline": {k: block[k] for k in (
                  "ceiling_qps", "bound_class", "roofline_pct",
                  "measured_qps", "model_version")},
              "k1_roofline_pct": k1_pct, "k1_ms": k1_ms,
              "k1_bound_ms": S["bound"]["bound_ms"],
              "metrics_samples": samples, "statusz_devices": inv,
              "queue_requests": len(ids), "queue_batches": len(batches),
              "queue_waterfalls": queue_wf, "fleet": fleet_out,
              "phase_s": time.perf_counter() - t_phase})

    def phase_campaign(S):
        """The measured-ceiling loop at the main shape: the campaign's
        bf16x3_tiled (K1) and bf16x3_streaming (K10) arms, every stage on
        the card, with the launch counts read around it; two store
        entries under distinct keys, each arm's calibrated ceiling within
        the tolerance of its measured q/s, each trace read back holding
        the arm's kernel with profiler.summarize's busy time; the main
        block re-rendered under the store applies it with a calibrated
        ceiling at least every q/s the main search reached in this run
        (main, obs and two calls here), and health names the entries."""
        from knn_tpu_torch import campaign, obs
        from knn_tpu_torch.obs import calibrate, roofline, sentinel

        t_phase = time.perf_counter()
        arms = ("bf16x3_tiled", "bf16x3_streaming")
        shape = dict(n=S["n"], d=S["dim"], k=S["k"], nq=S["n_q"])
        with tempfile.TemporaryDirectory() as out:
            calibrate.configure(os.path.join(out, "calibration.json"))
            try:
                reset_launches()
                summary = campaign.run_campaign(
                    rehearse=True, arms=arms, shape=shape, device="cuda",
                    out_dir=out, round_no=18)
                launches = read_launches()
                # the main search's rates: this run's earlier phases and
                # two calls here (the phase may run alone)
                rates = list(S.get("measured_qps", ())) + [
                    S["n_q"] / timed_search(S)[1] for _ in range(2)]
                main_block = roofline.attribute(roofline.pallas_cost_model(
                    nq=S["n_q"], device_kind=kind,
                    **{f: shape[f] for f in ("n", "d", "k")}), max(rates))
                cal_status = obs.health.report()["calibration"]
            finally:
                calibrate.configure(None)
        keys = [a["entry_key"] for a in summary["arms"]]
        others = {key: v for key, v in launches.items()
                  if key not in ("k1", "k10") and v}
        if launches["k1"] < 1 or launches["k10"] < 1 or others:
            raise AssertionError(
                f"campaign: launches {launches}: K1 and K10 each at least "
                f"once and no other kernel")
        arms_out = {}
        catalog_check("campaign main block", "roofline", main_block)
        for r in summary["results"]:
            line = r["line"]
            for name, block in (("roofline", line["roofline"]),
                                ("calibration",
                                 line["roofline"].get("calibration")),
                                ("campaign", line["campaign"])):
                catalog_check(f"campaign {r['arm']}", name, block)
            # the sentinel's verdict: no H100 history, so no baseline
            # under the line's cuda key, every curated field it carries
            # listed (a verdict of "error" fails)
            sent = line["sentinel"]
            catalog_check(f"campaign {r['arm']}", "sentinel", sent)
            catalog_check(f"campaign {r['arm']}", "bench_line", line)
            carried = sorted(f for f, _ in sentinel.CURATED_FIELDS
                             if isinstance(sentinel.curated_value(line, f),
                                           (int, float)))
            if (sent["verdict"] != "no_baseline"
                    or sent["baseline_key"]
                    != f"{line['metric']}|cuda|default"
                    or sorted(sent["fields"]) != carried):
                raise AssertionError(f"campaign {r['arm']}: sentinel "
                                     f"{sent!r}, carried {carried}")
            stages = {st["stage"]: st for st in line["campaign"]["stages"]}
            cap = stages["capture"].get("live_capture") or {}
            rec = stages["reconcile"]
            cal = stages["calibrate"]
            tol_busy = 1e-6 + 1e-9 * (cap.get("kernel_events") or 0)
            busy_gap = (abs(cap["device_busy_s"] - cap["summarize_busy_s"])
                        if cap else None)
            bench = stages["bench"]
            if (not r["ok"] or list(stages) != list(campaign.STAGES)
                    or any(st["status"] != "ok" for st in stages.values())
                    or not cap.get("kernel_held")
                    or not cap.get("device_tracks_matched")
                    or busy_gap is None or busy_gap > tol_busy
                    or rec["source"] != "device_trace"
                    or any("error" in f for f in rec["fits"].values())
                    or cal["reconstruction_residual_pct"]
                    > calibrate.RESIDUAL_TOLERANCE_PCT
                    or cal["ceiling_below"]
                    or bench["tile_n"] not in stages["tune"]["tiles"]
                    or bench["certified"] + bench["fallback_queries"]
                    < S["n_q"]):
                raise AssertionError(
                    f"campaign arm {r['arm']}: ok {r['ok']}, errors "
                    f"{r['errors']}, stages "
                    f"{[(s, st['status']) for s, st in stages.items()]}, "
                    f"capture {cap or stages['capture']}, fits "
                    f"{rec['fits']}, busy gap {busy_gap}")
            arms_out[r["arm"]] = {
                "key": r["entry_key"],
                "tune": {f: stages["tune"].get(f) for f in (
                    "winner", "winner_ms", "candidates", "pruned",
                    "resource_gate", "refused", "tiles", "n_queries")},
                "bench": {f: bench[f] for f in (
                    "place_s", "tile_n", "certified", "fallback_queries")},
                "host_phase_qps": rec["fits"]["host_phase"]["qps"],
                "host_phase_device_s": rec["fits"]["host_phase"]["device_s"],
                "device_trace_qps": rec["fits"]["device_trace"]["qps"],
                "device_trace_device_s":
                    rec["fits"]["device_trace"]["device_s"],
                "fits": {src: {f: fit[f] for f in (
                    "method", "model_residual_pct", "factors")}
                    for src, fit in rec["fits"].items()},
                "stored": rec["source"],
                "ceiling_qps_calibrated": cal["ceiling_qps"],
                "ceiling_qps_analytic":
                    line["roofline"]["ceiling_qps_analytic"],
                "reconstruction_residual_pct":
                    cal["reconstruction_residual_pct"],
                "sentinel": {"verdict": sent["verdict"],
                             "baseline_key": sent["baseline_key"],
                             "fields": sorted(sent["fields"])},
                "trace": {"kernel_events": cap["kernel_events"],
                          "events_before_body": cap["events_before_body"],
                          "traceread_busy_s": cap["device_busy_s"],
                          "summarize_busy_s": cap["summarize_busy_s"]},
            }
        if (len(set(keys)) != len(arms)
                or not main_block["calibration"].get("applied")
                or main_block["roofline_pct"] > 1.0
                or sorted(cal_status.get("keys") or ()) != sorted(keys)):
            raise AssertionError(
                f"campaign: keys {keys}, the main block's calibration "
                f"{main_block['calibration']}, its calibrated ceiling "
                f"{main_block['ceiling_qps']} against the main search's "
                f"best {max(rates)} q/s, health {cal_status}")
        emit({"phase": "campaign", "n": S["n"], "dim": S["dim"],
              "k": S["k"], "queries": S["n_q"], "launches": {
                  key: launches[key] for key in ("k1", "k10")},
              "arms": arms_out, "store_keys": keys,
              "main_block_calibrated": {
                  f: main_block[f] for f in ("ceiling_qps",
                                             "ceiling_qps_analytic",
                                             "bound_class", "measured_qps",
                                             "roofline_pct")},
              "main_search_qps": rates,
              "main_block_calibration_method":
                  main_block["calibration"]["method"],
              "health_calibration_entries": cal_status["entries"],
              "tolerance_pct": calibrate.RESIDUAL_TOLERANCE_PCT,
              "nvidia_smi": smi,
              "phase_s": time.perf_counter() - t_phase})

    def fleet_checks(base):
        """The fleet plane over the obs phase's exporter at ``base``: the
        live member (process 0 of 2) collected from its /metrics.json and
        /statusz, a second member written as a snapshot under
        ``set_identity(process_index=1)``; the merged counters equal the
        two members' sums and each member's own device inventory names
        the card; /fleetz serves the merge; ``cli fleet --snapshot-dir`` exits 0
        on two snapshots and 2 once one is torn."""
        import contextlib
        import io
        import urllib.request

        from knn_tpu_torch import obs
        from knn_tpu_torch.cli import main as cli_main
        from knn_tpu_torch.obs import fleet

        t_step = time.perf_counter()
        ep = base.split("://", 1)[1]
        obs.ident.set_identity(process_count=2)
        try:
            live = fleet.collect_live([ep], timeout_s=30)
            if live[0]["error"] or (live[0]["health"] or {}).get(
                    "devices", {}).get("kinds") != [kind]:
                raise AssertionError(f"fleet: the live member: {live[0]}")
            with tempfile.TemporaryDirectory() as snapdir:
                obs.write_json_snapshot(os.path.join(snapdir, "m0.json"))
                obs.ident.set_identity(process_index=1)
                m1 = os.path.join(snapdir, "m1.json")
                obs.write_json_snapshot(m1)
                obs.ident.set_identity(process_index=0)
                second = fleet.collect_snapshot_files([m1])
                rep = fleet.merge(live + second)
                members = [live[0], second[0]]
                sums = {}
                for rec in members:
                    for name, m in rec["metrics"].items():
                        if m.get("type") != "counter":
                            continue
                        for s in m["series"]:
                            key = (name, tuple(sorted(s["labels"].items())))
                            sums.setdefault(key, []).append(
                                float(s["value"]))
                merged = {(name, tuple(sorted(s["labels"].items()))):
                          s["value"]
                          for name, series in rep["counters"].items()
                          for s in series}
                bad = {key: (merged.get(key), vals)
                       for key, vals in sums.items()
                       if merged.get(key) != sum(vals)}
                # each member's own inventory names the card (the smoke
                # stamps no device kind)
                kinds = {tuple((rec.get("health") or {}).get(
                    "devices", {}).get("kinds") or ()) for rec in members}
                if (rep["partial"] or rep["member_count"] != 2 or bad
                        or set(merged) != set(sums) or kinds != {(kind,)}
                        or sorted(m["identity"]["process_index"]
                                  for m in rep["members"]) != [0, 1]):
                    raise AssertionError(
                        f"fleet: merge of the live member and a snapshot: "
                        f"partial {rep['partial']}, members "
                        f"{rep['member_count']}, kinds {kinds}, counters "
                        f"off their sums {list(bad.items())[:3]}")
                catalog_check("obs fleet", "fleet",
                              fleet.artifact_block(rep))
                fleet.configure(members=[ep])
                fz = json.loads(urllib.request.urlopen(
                    f"{base}/fleetz", timeout=30).read())
                fleet.configure()
                with contextlib.redirect_stdout(io.StringIO()) as out_txt:
                    rc_ok = cli_main(["fleet", "--snapshot-dir", snapdir])
                    good = open(os.path.join(snapdir, "m0.json")).read()
                    with open(os.path.join(snapdir, "torn.json"), "w") as f:
                        f.write(good[: len(good) // 2])
                    rc_torn = cli_main(["fleet", "--snapshot-dir", snapdir])
                if (not fz.get("enabled") or fz.get("member_count") != 1
                        or rc_ok != 0 or rc_torn != 2):
                    raise AssertionError(
                        f"fleet: /fleetz {fz.get('member_count')} "
                        f"member(s), cli fleet exits {rc_ok} on two "
                        f"snapshots and {rc_torn} with one torn: "
                        f"{out_txt.getvalue()[-2000:]}")
        finally:
            obs.ident.reset_identity()
            fleet.configure()
        return {"members": rep["member_count"],
                "member_keys": [m["key"] for m in rep["members"]],
                "device_kinds": [list(x) for x in sorted(kinds)],
                "counter_series": len(merged),
                "counters_equal_member_sums": True,
                "staleness_s": rep["staleness_s"],
                "slo_breached": (rep.get("slo") or {}).get("breached"),
                "fleetz_members": fz["member_count"],
                "cli_exit_two_snapshots": rc_ok,
                "cli_exit_one_torn": rc_torn,
                "elapsed_s": time.perf_counter() - t_step}

    def phase_stream(S):
        knn, pl, qp = S["knn"], S["knn"].placement, S["qp"]
        n, n_q, k = S["n"], S["n_q"], S["k"]
        if "tiled" not in S:
            (d, i, _), _ = timed_search(S)
            S["tiled"] = (d, i)
        keep = min(k + 28, n) + 2
        n_tiles = pl.th.shape[0] // ck.TILE_N
        args = (qp, pl.th, pl.tl, pl.tnorm)

        # K10 and the db-major K1 (K9) bitwise K1 at the main shape; K11
        # against its plain version at its own geometry
        bf = {"tile_n": ck.TILE_N, "arm": "bf16x3"}
        k1_out = ck.binned_select(*args, **bf)
        bitwise("K10 vs K1 at the main shape",
                ck.stream_select(*args, **bf), k1_out)
        bitwise("db-major K1 vs K1 at the main shape",
                ck.binned_select(*args, **bf, grid_order="db_major"), k1_out)
        del k1_out
        if "k1_err" in S:
            # bitwise K1's outputs: K1's error against the same plain version
            for key in ("k10", "db_major_bf16x3"):
                checks[key].max_abs_err = max(checks[key].max_abs_err,
                                              S["k1_err"])
        parts = (pl.th, pl.tl, pl.tnorm)
        k11_main = compare_k11(checks["k11"], S["q_dev"], pl.db, ck.TILE_N,
                               keep, parts=parts)
        # ... and at the pipelined run's geometry: each of its four
        # 1,024-query batches, with that batch size's own tile segments
        pipe_bs = kernel_configs["fused_overlap"]["batch_size"]
        k11_batches = [
            compare_k11(checks["k11"], S["q_dev"][lo : lo + pipe_bs], pl.db,
                        ck.TILE_N, keep, parts=parts)
            for lo in range(0, n_q, pipe_bs)]
        block_q = ck.QUERY_BLOCK
        seg = ck.kernel_segment_tiles(n_q, n_tiles, dev, "fused")
        ms10 = time_cuda(lambda: ck.stream_select(*args, **bf), 3)
        ms9 = time_cuda(lambda: ck.binned_select(*args, **bf,
                                                 grid_order="db_major"), 3)
        ms11 = time_cuda(lambda: ck.fused_select(*args, **bf, keep=keep), 3)
        plain10_ms = time_cuda(lambda: ck.binned_select_plain(*args, **bf), 1)
        plain11_ms = time_cuda(lambda: ck.fused_select_plain(
            *args, **bf, keep=keep, block_q=block_q, seg_tiles=seg), 1)

        runs = run_configs(S, "bf16x3", ("tiled_db_major", "streaming",
                                         "fused", "fused_overlap"),
                           ref=S["tiled"])
        # warm q/s of every configuration, tiled included, in five rounds
        # of turns, so that host noise falls on all of them alike
        qps_turns = {label: [] for label in kernel_configs}
        for _ in range(5):
            for label, knobs in kernel_configs.items():
                _, wall = timed_search(S, **knobs)
                qps_turns[label].append(n_q / wall)
        # the pipeline keeps its two CUDA streams per ShardedKNN: pipelined
        # calls on the kept streams against calls on two fresh ones, with
        # the caching allocator's new device segments (cudaMalloc calls)
        stream_turns = {"kept": [], "fresh": []}
        for _ in range(3):
            for label in stream_turns:
                if label == "fresh":
                    knn._streams = None
                torch.cuda.synchronize()
                segs = torch.cuda.memory_stats()["segment.all.allocated"]
                _, wall = timed_search(S, **kernel_configs["fused_overlap"])
                stream_turns[label].append({
                    "wall_ms": wall * 1e3,
                    "new_segments": torch.cuda.memory_stats()[
                        "segment.all.allocated"] - segs})
        prof = profile_search(knn, S["q_np"],
                              **kernel_configs["fused_overlap"])
        bound = S["bound"]
        records["k10"].update(launches=runs["streaming"]["launches"]["k10"],
                              ms=ms10, plain_ms=plain10_ms,
                              bound_ms=bound["bound_ms"],
                              bound_by=bound["bound_by"])
        records["k11"].update(launches=runs["fused"]["launches"]["k11"],
                              ms=ms11, plain_ms=plain11_ms,
                              bound_ms=bound["bound_ms"],
                              bound_by=bound["bound_by"])
        # K9 computes K1's function: K1's plain version and bound
        records["db_major_bf16x3"].update(
            launches=runs["tiled_db_major"]["launches"]["db_major_bf16x3"],
            ms=ms9, plain_ms=plain10_ms, bound_ms=bound["bound_ms"],
            bound_by=bound["bound_by"])
        emit({"phase": "stream", "n": n, "queries": n_q, "k": k,
              "keep": keep, "block_q": block_q, "seg_tiles": seg,
              "k10_ms_per_launch": ms10, "k10_plain_ms": plain10_ms,
              "k1_db_major_ms_per_launch": ms9,
              "k11_ms_per_launch": ms11, "k11_plain_ms": plain11_ms,
              "bound": bound, "k11_at_main": k11_main,
              "k11_skipped_cells": k11_main["skipped_cells"],
              "k11_cells": k11_main["cells"],
              "k11_at_pipelined_batches": k11_batches, "runs": runs,
              "qps_in_turns": qps_turns,
              "pipeline_streams_kept_vs_fresh": stream_turns,
              "pipelined_profile": prof})


    def time_arm(D, arm):
        """The arm's three entries against their plain versions at the main
        path's shapes (bitwise), the fused entry also at the pipelined
        run's own geometry (each 1,024-query batch, with that batch size's
        tile segments: bitwise, so the same skipped cells), then each
        entry timed with CUDA events."""
        knn, q_dev = D["knn"], D["q_dev"]
        t, aux = knn._coarse_parts(ck.TILE_N, arm)
        qi, qsc = ck.quantize_queries(q_dev, knn._quant_placement(arm)["offset"])
        args = (qi, qsc, t, aux)
        n_q, n_tiles = qi.shape[0], t.shape[0] // ck.TILE_N
        keep = min(D["k"] + 28, knn.n_train) + 2
        seg = ck.kernel_segment_tiles(n_q, n_tiles, dev, "fused", arm)
        ka = {"tile_n": ck.TILE_N, "arm": arm}
        plain = ck.binned_select_plain(*args, **ka)
        tiled = ck.binned_select(*args, **ka)
        out = {"seg_tiles": seg, "keep": keep}
        for kern, got in (("tiled", tiled),
                          ("streaming", ck.stream_select(*args, **ka)),
                          ("db_major", ck.binned_select(
                              *args, **ka, grid_order="db_major"))):
            err = bitwise(f"{kern}_{arm}@main", got, plain)
            checks[f"{kern}_{arm}"].max_abs_err = max(
                checks[f"{kern}_{arm}"].max_abs_err, err)
        del plain

        def fused_vs_plain(name, sl):
            sub = (qi[sl], qsc[sl], t, aux)
            g = ck.kernel_segment_tiles(sub[0].shape[0], n_tiles, dev,
                                        "fused", arm)
            kern = ck.fused_select(*sub, **ka, keep=keep)
            fplain = ck.fused_select_plain(*sub, **ka, keep=keep,
                                           block_q=ck.QUERY_BLOCK,
                                           seg_tiles=g)
            err = bitwise(name, kern, fplain)
            checks[f"fused_{arm}"].max_abs_err = max(
                checks[f"fused_{arm}"].max_abs_err, err)
            skip = ck.skipped_cells(kern[0], n_tiles)
            return kern, {"q": sub[0].shape[0], "seg_tiles": g,
                          "skipped_cells": int(skip.sum()),
                          "cells": skip.numel(), "bitwise_plain": True}

        fused, at_main = fused_vs_plain(f"fused_{arm}@main", slice(None))
        out["skipped_cells"] = at_main["skipped_cells"]
        pipe_bs = kernel_configs["fused_overlap"]["batch_size"]
        out["fused_at_pipelined_batches"] = [
            fused_vs_plain(f"fused_{arm}@batch{lo // pipe_bs}",
                           slice(lo, lo + pipe_bs))[1]
            for lo in range(0, n_q, pipe_bs)]
        out["tied_bins"] = int((tiled[0].view(n_q, n_tiles, 2, 128)[:, :, 0]
                                == tiled[0].view(n_q, n_tiles, 2, 128)[:, :, 1]
                                ).sum())
        del tiled, fused
        for kern, fn, pfn, kw in (
                ("tiled", ck.binned_select, ck.binned_select_plain, {}),
                ("streaming", ck.stream_select, ck.binned_select_plain, {}),
                ("fused", ck.fused_select, ck.fused_select_plain,
                 {"keep": keep})):
            pkw = dict(kw, block_q=ck.QUERY_BLOCK, seg_tiles=seg) if kw else {}
            out[f"{kern}_ms"] = time_cuda(lambda: fn(*args, **ka, **kw), 3)
            out[f"{kern}_plain_ms"] = time_cuda(
                lambda: pfn(*args, **ka, **pkw), 1)
        # K9 computes the tiled entry's function: the same plain version
        out["db_major_ms"] = time_cuda(lambda: ck.binned_select(
            *args, **ka, grid_order="db_major"), 3)
        out["db_major_plain_ms"] = out["tiled_plain_ms"]
        out["bound"] = int_bound(n_q, knn.n_train, qi.shape[1], n_tiles,
                                 ck.SURVIVORS, arm)
        return out

    def phase_quant(S):
        from knn_tpu_torch import ShardedKNN
        from knn_tpu_torch.ops.quantize import score_error_bound

        # the six int entries against their plain versions, bitwise, on
        # integer data with exact ties; streaming bitwise tiled
        keep = min(S["k"] + 28, S["n"]) + 2
        cases = []
        for arm in ck.INT_ARMS:
            for n_q, n, dim, tile in ((37, 5 * 128 + 60, 24, 256),
                                      (11, 3 * 128 + 40, 300, 256),
                                      (256, 16384, 128, ck.TILE_N)):
                args = int_case(dev, arm, n_q, n, dim, tile, dim + n_q)
                n_tiles = args[2].shape[0] // tile
                seg = ck.kernel_segment_tiles(n_q, n_tiles, dev, "fused", arm)
                ka = {"tile_n": tile, "arm": arm}
                plain = ck.binned_select_plain(*args, **ka)
                tiled = ck.binned_select(*args, **ka)
                got = {"tiled": (tiled, plain),
                       "streaming": (ck.stream_select(*args, **ka), plain),
                       "fused": (ck.fused_select(*args, **ka, keep=keep),
                                 ck.fused_select_plain(
                                     *args, **ka, keep=keep,
                                     block_q=ck.QUERY_BLOCK, seg_tiles=seg))}
                for kern, (k_out, p_out) in got.items():
                    err = bitwise(f"{kern}_{arm} case", k_out, p_out)
                    checks[f"{kern}_{arm}"].max_abs_err = max(
                        checks[f"{kern}_{arm}"].max_abs_err, err)
                bitwise(f"streaming_{arm} vs tiled", got["streaming"][0], tiled)
                cd = tiled[0].view(n_q, n_tiles, 2, 128)
                cases.append({"arm": arm, "q": n_q, "rows": n, "dim": dim,
                              "tile_n": tile, "bitwise": True,
                              "tied_bins": int((cd[:, :, 0] == cd[:, :, 1]).sum())})
        # the fused entries on the far-tile case: the same skipped cells
        fq, fdb = far_tile_case(dev)
        far = {}
        for arm in ck.INT_ARMS:
            qi, qsc = ck.quantize_queries(fq)
            t, aux = ck.prepare_db_int(fdb, ck.TILE_N, arm)
            n_tiles = t.shape[0] // ck.TILE_N
            seg = ck.kernel_segment_tiles(fq.shape[0], n_tiles, dev, "fused",
                                          arm)
            kern = ck.fused_select(qi, qsc, t, aux, tile_n=ck.TILE_N,
                                   keep=keep, arm=arm)
            plain = ck.fused_select_plain(qi, qsc, t, aux, tile_n=ck.TILE_N,
                                          keep=keep, arm=arm,
                                          block_q=ck.QUERY_BLOCK,
                                          seg_tiles=seg)
            bitwise(f"fused_{arm} far-tile", kern, plain)
            skipped = int(ck.skipped_cells(kern[0], n_tiles).sum())
            if skipped < 1:
                raise AssertionError(f"fused_{arm} skipped no far tile")
            far[arm] = {"seg_tiles": seg, "skipped_cells": skipped,
                        "cells": int(n_tiles * -(-fq.shape[0] // ck.QUERY_BLOCK))}
        del fq, fdb
        emit({"phase": "quant_kernels", "cases": cases, "far_tile": far,
              "max_abs_err": {f"{kern}_{arm}": checks[f"{kern}_{arm}"].max_abs_err
                              for kern in ("tiled", "streaming", "fused")
                              for arm in ck.INT_ARMS}})

        # int8 on the main draw cast to uint8 (byte-exact placement), int4
        # on the main f32 data
        u8 = S["knn"].placement.db_host.astype(np.uint8)
        q8 = S["q_np"].astype(np.uint8).astype(np.float32)
        t0 = time.perf_counter()
        knn8 = ShardedKNN(u8, k=S["k"])
        knn8._quant_placement("int8")
        torch.cuda.synchronize()
        D8 = {"knn": knn8, "q_np": q8, "q_dev": torch.from_numpy(q8).to(dev),
              "n_or": S["n_or"], "k": S["k"], "setup_s": time.perf_counter() - t0}
        del u8
        t0 = time.perf_counter()
        S["knn"]._quant_placement("int4")
        torch.cuda.synchronize()
        D4 = dict(S, setup_s=time.perf_counter() - t0)
        out = {"phase": "quant"}
        for arm, D in (("int8", D8), ("int4", D4)):
            qp = D["knn"]._quant_placement(arm)
            eps = score_error_bound(D["q_np"], qp["stats"], offset=qp["offset"])
            runs = run_configs(D, arm, kernel_configs)
            timing = time_arm(D, arm)
            prof = (profile_search(D["knn"], D["q_np"], precision=arm)
                    if arm == "int8" else None)
            for kern, label in (("tiled", "tiled"),
                                ("db_major", "tiled_db_major"),
                                ("streaming", "streaming"),
                                ("fused", "fused")):
                records[f"{kern}_{arm}"].update(
                    launches=runs[label]["launches"][f"{kern}_{arm}"],
                    ms=timing[f"{kern}_ms"],
                    plain_ms=timing[f"{kern}_plain_ms"],
                    bound_ms=timing["bound"]["bound_ms"],
                    bound_by=timing["bound"]["bound_by"])
            out[arm] = {"placement_s": D["setup_s"], "offset": qp["offset"],
                        "stats": qp["stats"], "eps_max": float(eps.max()),
                        "eps_median": float(np.median(eps)),
                        "runs": runs, "kernels": timing, "profile": prof}
        emit(out)
        del D8, knn8

    def timed_once(fn):
        """fn()'s output and its time on the card (CUDA events, one call)."""
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def f32_arm_at_main(S, arm, pipelined):
        """The four entries of f32-family arm ``arm`` (tiled, db-major,
        streaming, fused) at the main path's shapes: the tiled and fused
        ones against their plain versions (the fused one at its own
        geometry, and at the pipelined run's when ``pipelined``), the
        streaming and db-major ones bitwise the tiled one; then each timed
        with CUDA events."""
        knn, q_dev, pl = S["knn"], S["q_dev"], S["knn"].placement
        parts = knn._coarse_parts(ck.TILE_N, arm)
        args = (S["qp"], *parts)
        n_q, n_tiles = q_dev.shape[0], parts[0].shape[0] // ck.TILE_N
        keep = min(S["k"] + 28, knn.n_train) + 2
        seg = ck.kernel_segment_tiles(n_q, n_tiles, dev, "fused", arm)
        tol_q = tolerance_q(q_dev, tmax=pl.db_norm_max, arm=arm)
        plain, plain_ms = timed_once(lambda: ck.binned_select_plain(
            *args, tile_n=ck.TILE_N, arm=arm))
        tiled = ck.binned_select(*args, tile_n=ck.TILE_N, arm=arm)
        err = max(checks[f"tiled_{arm}"].values(f"tiled_{arm}@main cd",
                                                tiled[0], plain[0], tol_q),
                  checks[f"tiled_{arm}"].values(f"tiled_{arm}@main bounds",
                                                tiled[2], plain[2], tol_q))
        real = (plain[0] < PAD_SCALE) & torch.isfinite(plain[0])
        ratio = float((torch.where(real, (tiled[0] - plain[0]).abs(), 0.0)
                       .amax(-1) / tol_q).max())
        nd = S["qp"].shape[1] // ck.DIM_CHUNK
        out = {"seg_tiles": seg, "keep": keep, "max_abs_err": err,
               "error_over_tolerance": ratio,
               "error_over_128u": ratio * ck.kernel_plain_tolerance_scale(
                   arm, nd) / (128 * U32),
               "ci_separated_checked": check_ci(f"tiled_{arm}@main", tiled,
                                                plain, tol_q, n_tiles)}
        del plain
        for key, kw, fn in (("streaming", {}, ck.stream_select),
                            ("db_major", {"grid_order": "db_major"},
                             ck.binned_select)):
            bitwise(f"{key}_{arm}@main vs tiled",
                    fn(*args, tile_n=ck.TILE_N, arm=arm, **kw), tiled)
            checks[f"{key}_{arm}"].max_abs_err = max(
                checks[f"{key}_{arm}"].max_abs_err, err)
        del tiled
        fplain, fplain_ms = timed_once(lambda: ck.fused_select_plain(
            *args, tile_n=ck.TILE_N, keep=keep, arm=arm,
            block_q=ck.QUERY_BLOCK, seg_tiles=seg))
        out["fused_at_main"] = compare_k11(checks[f"fused_{arm}"], q_dev,
                                           pl.db, ck.TILE_N, keep,
                                           parts=parts, arm=arm, plain=fplain)
        del fplain
        if pipelined:
            pipe_bs = kernel_configs["fused_overlap"]["batch_size"]
            out["fused_at_pipelined_batches"] = [
                compare_k11(checks[f"fused_{arm}"], q_dev[lo : lo + pipe_bs],
                            pl.db, ck.TILE_N, keep, parts=parts, arm=arm)
                for lo in range(0, n_q, pipe_bs)]
        for key, fn, kw in (("tiled", ck.binned_select, {}),
                            ("db_major", ck.binned_select,
                             {"grid_order": "db_major"}),
                            ("streaming", ck.stream_select, {}),
                            ("fused", ck.fused_select, {"keep": keep})):
            out[f"{key}_ms"] = time_cuda(
                lambda: fn(*args, tile_n=ck.TILE_N, arm=arm, **kw), 3)
        # the streaming and db-major entries compute the tiled function
        out.update(tiled_plain_ms=plain_ms, db_major_plain_ms=plain_ms,
                   streaming_plain_ms=plain_ms, fused_plain_ms=fplain_ms)
        out["bound"] = f32_bound(n_q, knn.n_train, S["qp"].shape[1], n_tiles,
                                 ck.SURVIVORS, arm)
        return out

    def phase_f32arms(S):
        from knn_tpu_torch import knn_search_certified, pallas_candidate_fn

        knn, n, n_q, k = S["knn"], S["n"], S["n_q"], S["k"]
        keep = min(k + 28, n) + 2
        new_arms = ("bf16x3f", "highest", "default")
        # each new entry against its plain version on the kernel phase's
        # small cases; streaming and db-major bitwise tiled
        rng = np.random.default_rng(4)
        cases = []
        for arm in new_arms:
            for c_q, c_n, dim, tile in ((37, 5 * 128 + 60, 24, 256),
                                        (11, 3 * 128 + 40, 300, 256),
                                        (256, 16384, 128, ck.TILE_N)):
                q = torch.from_numpy((rng.normal(size=(c_q, dim)) * 10)
                                     .astype(np.float32)).to(dev)
                db = torch.from_numpy((rng.normal(size=(c_n, dim)) * 10)
                                      .astype(np.float32)).to(dev)
                cases.append(compare_f32(checks, arm, q, db, tile, keep))
        fq, fdb = far_tile_case(dev)
        far = {}
        for arm in new_arms:
            far[arm] = compare_k11(checks[f"fused_{arm}"], fq, fdb,
                                   ck.TILE_N, keep, arm=arm)
            if far[arm]["skipped_cells"] < 1:
                raise AssertionError(f"fused_{arm} skipped no far tile")
        del fq, fdb
        # every entry of the certified f32 arms on all-positive data at
        # Dp = 896 against the worst case the headers state
        header = {f"{kern}_{arm}": header_bound_ratio(dev, arm, kern)
                  for arm in ("bf16x3", "bf16x3f", "highest")
                  for kern in ("tiled", "streaming", "fused")}
        if max(header.values()) > 1.0:
            raise AssertionError(
                f"score error past the header's bound at Dp = 896: {header}")
        # K3 against its plain version per unit of its proved tolerance and
        # of the unproved 128 u it replaced, at Dp = 128 and 896
        k3_ratio = [default_plain_ratio(dev, dim, data)
                    for dim in (128, 896)
                    for data in ("all_positive", "normal")]
        emit({"phase": "f32arms_kernels", "cases": cases, "far_tile": far,
              "dp896_error_over_header_bound": header,
              "default_kernel_vs_plain": k3_ratio})

        out = {"phase": "f32arms"}
        for arm in new_arms:
            t0 = time.perf_counter()
            knn._coarse_parts(ck.TILE_N, arm)  # highest: the f32 rows
            torch.cuda.synchronize()
            placement_s = time.perf_counter() - t0
            out[arm] = {"placement_s": placement_s,
                        "kernels": f32_arm_at_main(S, arm,
                                                   pipelined=arm != "default")}
        # the one-pass certificate through each certified arm's five
        # configurations
        for arm in ("bf16x3f", "highest"):
            runs = run_configs(S, arm, kernel_configs)
            out[arm].update(runs=runs, profile=profile_search(
                knn, S["q_np"], precision=arm))
        # the counted certificate through K3's four configurations
        db_np = knn.placement.db_host
        counted, ref = {}, None
        for label in ("tiled", "tiled_db_major", "streaming", "fused"):
            knobs = {key: v for key, v in kernel_configs[label].items()}
            own = [f"{knobs['kernel']}_default"]
            if knobs.get("grid_order") == "db_major":
                own.append("db_major_default")
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, i, stats = knn_search_certified(
                S["q_np"], db_np, k, margin=28,
                candidate_fn=pallas_candidate_fn(precision="default",
                                                 **knobs))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            if any(launches[key] != 1 for key in own) \
                    or sum(launches.values()) != len(own):
                raise AssertionError(
                    f"counted certificate {label}: launches {launches}, "
                    f"expected one of {own} and no other kernel")
            if ref is None:
                ref = (d, i)
            elif not (np.array_equal(d, ref[0]) and np.array_equal(i, ref[1])):
                raise AssertionError(
                    f"counted certificate {label}: d, i differ from tiled")
            recall, same, rel = oracle_check(S, d, i, f"counted {label}")
            counted[label] = {"launches": launches, "wall_s": wall,
                              "qps": n_q / wall, "recall_at_k": recall,
                              "same_indices": same, "max_rel_dist_err": rel,
                              "fallback_queries": stats["fallback_queries"],
                              "host_exact_queries":
                                  stats.get("host_exact_queries", 0)}
        out["default"]["counted_certificate"] = counted
        # the certified arms' rounding against their tolerance at Dp = 128
        n_or = S["n_or"]
        out["score_error_over_tolerance_dp128"] = {
            arm: score_error_ratio(S["q_dev"][:n_or], knn.placement.db, arm,
                                   db_norm_max=knn.placement.db_norm_max)
            for arm in ("bf16x3", "bf16x3f", "highest")}
        if max(out["score_error_over_tolerance_dp128"].values()) >= 1.0:
            raise AssertionError(
                f"kernel score error reached its tolerance: "
                f"{out['score_error_over_tolerance_dp128']}")
        for arm in new_arms:
            timing = out[arm]["kernels"]
            runs = out[arm].get("runs") or counted
            for key, label in (("tiled", "tiled"),
                               ("db_major", "tiled_db_major"),
                               ("streaming", "streaming"),
                               ("fused", "fused")):
                records[f"{key}_{arm}"].update(
                    launches=runs[label]["launches"][f"{key}_{arm}"],
                    ms=timing[f"{key}_ms"],
                    plain_ms=timing[f"{key}_plain_ms"],
                    bound_ms=timing["bound"]["bound_ms"],
                    bound_by=timing["bound"]["bound_by"])
        emit(out)


    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def arm_operands(S, arm):
        """The main placement's operands of arm ``arm`` for the main
        queries, as the coarse wrappers take them."""
        knn, q = S["knn"], S["q_dev"]
        if arm in ck.INT_ARMS:
            off = knn._quant_placement(arm)["offset"]
            return (*ck.quantize_queries(q, off),
                    *knn._coarse_parts(ck.TILE_N, arm))
        if arm == "pq":
            pq = main_pq(S)
            return (ck.pq_luts(q, pq["books"]), *pq["parts"])
        return (S["qp"], *knn._coarse_parts(ck.TILE_N, arm))

    def main_pq(S):
        """The main placement's pq placement (4 dims a subspace, 256
        codes), placed on first use and kept: codebooks trained on its
        first PQ_TRAIN_ROWS rows (ops.pq.train_pq), every row encoded
        against them (ops.pq.encode_pq) and the certificate's bound
        statistics taken over every row (ops.pq.pq_bound_stats), so the
        certificate stays sound; ``knn._pq_placement()`` returns it
        after.  Training on every row held the script ~200 s on an H100
        machine's host (PERF.md)."""
        from knn_tpu_torch.ops import pq as ppq

        knn = S["knn"]
        if (ppq.PQ_DSUB_DEFAULT, ppq.PQ_NCODES_DEFAULT) not in knn._pq:
            t0 = time.perf_counter()
            db = knn.placement.db_host
            res = ppq.train_pq(db[:PQ_TRAIN_ROWS], device=dev)
            codes = ppq.encode_pq(db, res.codebooks, device=dev,
                                  dsub=res.dsub)
            stats = ppq.pq_bound_stats(res.codebooks, codes, db,
                                       dsub=res.dsub)
            entry = knn._place_pq(res.codebooks, codes, stats,
                                  dsub=res.dsub, ncodes=ppq.PQ_NCODES_DEFAULT)
            entry["train_s"] = time.perf_counter() - t0
        return knn._pq_placement()

    def arm_bound(S, arm, args, geo):
        """The arm's bound at the main shape (f32_bound, int_bound or
        pq_bound) for emit geometry ``geo``."""
        n_q, n = S["n_q"], S["n"]
        n_tiles = args[-1].shape[1] // ck.TILE_N
        if arm == "pq":
            m = args[1].shape[1]
            return pq_bound(n_q, n, m, args[0].shape[1] // m, n_tiles,
                            geo[2], geo[3], n_sm, sm_clock_hz())
        if arm in ck.INT_ARMS:
            return int_bound(n_q, n, args[0].shape[1], n_tiles, geo[2] // 128,
                             arm)
        return f32_bound(n_q, n, args[0].shape[1], n_tiles, geo[2] // 128,
                         arm)

    def phase_pq(S):
        from knn_tpu_torch import ShardedKNN
        from knn_tpu_torch.convert import pq_from_numpy
        from knn_tpu_torch.ops import pq as ppq

        def cert_eps(q, placed):
            # the certificate's ε (ops.pq.score_error_bound_pq_t)
            return ppq.score_error_bound_pq_t(
                torch.from_numpy(q).to(dev), placed["consts"],
                dsub=placed["dsub"])[1].cpu().numpy()

        # K7's three entries bitwise their plain version at the kernel
        # phase's shapes, in grouped and lane binning
        emits = {"grouped": {}, "lane": {"binning": "lane"},
                 "lane_s8_b256": {"binning": "lane", "survivors": 8,
                                  "bin_w": 256}}
        cases = []
        # (the last: m = 196, C = 200, queries not a multiple of 32, a tile
        # of one full 1,024-row block and a shorter one)
        for n_q, n, m, ncodes, tile in ((37, 5 * 128 + 60, 7, 200, 256),
                                        (11, 3 * 128 + 40, 32, 256, 256),
                                        (256, 16384, 32, 256, ck.TILE_N),
                                        (45, 1280 + 60, 196, 200, 1280)):
            args = pq_case(dev, n_q, n, m, ncodes, tile, n_q + m)
            for label, kw in emits.items():
                kw = dict(kw, tile_n=tile, arm="pq")
                plain = ck.binned_select_plain(*args, **kw)
                for key, out in (
                        ("tiled", ck.binned_select(*args, **kw)),
                        ("db_major", ck.binned_select(
                            *args, **kw, grid_order="db_major")),
                        ("streaming", ck.stream_select(*args, **kw))):
                    err = bitwise(f"{key}_pq {label} case", out, plain)
                    rec = (f"{key}_pq" if label == "grouped"
                           else f"{key}_lane_pq")
                    checks[rec].max_abs_err = max(checks[rec].max_abs_err,
                                                  err)
                cases.append({"q": n_q, "rows": n, "m": m, "ncodes": ncodes,
                              "tile_n": tile, "binning": label,
                              "bitwise": True})
        emit({"phase": "pq_kernels", "cases": cases})

        # the main placement's pq placement, trained on a sample, every row
        # encoded
        knn, n_q = S["knn"], S["n_q"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pq = main_pq(S)
        torch.cuda.synchronize()
        placement_s = time.perf_counter() - t0
        args = arm_operands(S, "pq")
        ka = {"tile_n": ck.TILE_N, "arm": "pq"}
        plain, plain_ms = timed_once(lambda: ck.binned_select_plain(*args,
                                                                    **ka))
        for key, fn, kw in (("tiled", ck.binned_select, {}),
                            ("db_major", ck.binned_select,
                             {"grid_order": "db_major"}),
                            ("streaming", ck.stream_select, {})):
            bitwise(f"{key}_pq@main", fn(*args, **ka, **kw), plain)
        del plain
        timing = {f"{key}_ms": time_cuda(lambda: fn(*args, **ka, **kw), 3)
                  for key, fn, kw in (("tiled", ck.binned_select, {}),
                                      ("db_major", ck.binned_select,
                                       {"grid_order": "db_major"}),
                                      ("streaming", ck.stream_select, {}))}
        bound = arm_bound(S, "pq", args, ck.emit_geometry(ck.TILE_N))
        del args
        eps = cert_eps(S["q_np"], pq)
        runs = run_configs(S, "pq", ("tiled", "tiled_db_major", "streaming"))
        for key, label in (("tiled", "tiled"), ("db_major", "tiled_db_major"),
                           ("streaming", "streaming")):
            records[f"{key}_pq"].update(
                launches=runs[label]["launches"][f"{key}_pq"],
                ms=timing[f"{key}_ms"], plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])

        # the lattice case: residuals 0, so ε is the f32 terms alone
        rows, q_lat = lattice_case(dev)
        lat = ShardedKNN(rows, k=S["k"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pql = lat._pq_placement()
        torch.cuda.synchronize()
        DL = {"knn": lat, "q_np": q_lat, "q_dev": torch.from_numpy(q_lat).to(dev),
              "n_or": S["n_or"], "k": S["k"]}
        # 2,048-row tiles: 4,096 bins, so three of a query's 100 neighbours
        # rarely share one
        lat_runs = {}
        for label in ("tiled", "streaming"):
            reset_launches()
            (d, i, st), wall = timed_search(DL, precision="pq", kernel=label,
                                            tile_n=2048)
            launches = read_launches()
            if launches[f"{label}_pq"] != 1 or sum(launches.values()) != 1:
                raise AssertionError(f"lattice {label}: launches {launches}")
            _, wall_warm = timed_search(DL, precision="pq", kernel=label,
                                        tile_n=2048)
            recall, same, rel = oracle_check(DL, d, i, f"lattice {label}")
            lat_runs[label] = {
                "recall_at_k": recall, "same_indices": same,
                "max_rel_dist_err": rel, "certified": st["certified"],
                "fallback_queries": st["fallback_queries"],
                "qps_first_call": q_lat.shape[0] / wall,
                "qps_second_call": q_lat.shape[0] / wall_warm}
        if lat_runs["tiled"]["certified"] <= q_lat.shape[0] // 2:
            raise AssertionError(
                f"lattice: only {lat_runs['tiled']['certified']} of "
                f"{q_lat.shape[0]} queries certified")
        lat_eps = cert_eps(q_lat, pql)
        del lat, DL

        # K7 at 196 subspaces (784 dims, dsub 4): its f32 error inside the
        # worst case binned_pq.cuh states, which the certificate's ε
        # carries (ops.pq.k7_rounding), and a certified search on rows
        # with zero residuals, where ε is the f32 terms alone
        ratio196 = {kern: pq_bound_ratio(dev, kern)
                    for kern in ("tiled", "streaming")}
        if max(ratio196.values()) > 1.0:
            raise AssertionError(
                f"K7's error passed the header's bound at m = 196: "
                f"{ratio196}")
        rng = np.random.default_rng(196)
        m196, n196, k196 = 196, 16384, S["k"]
        books = (rng.normal(size=(m196, 256, 4)) * 3).astype(np.float32)
        codes = rng.integers(0, 256, size=(n196, m196)).astype(np.uint8)
        rows196 = ppq.reconstruct(books, codes, 4 * m196, 4)
        q196 = (rng.normal(size=(512, 4 * m196)) * 3).astype(np.float32)
        knn196 = ShardedKNN(rows196, k=k196)
        placed = pq_from_numpy(
            knn196, books, codes,
            ppq.pq_bound_stats(books, codes, rows196, dsub=4), 4, 4 * m196)
        reset_launches()
        d196, i196, st196 = knn196.search_certified(
            q196, margin=28, selector="pallas", precision="pq", tile_n=2048)
        if read_launches()["tiled_pq"] != 1:
            raise AssertionError("m = 196: K7 was not launched once")
        od, oi = f64_oracle(torch.from_numpy(q196).to(dev),
                            knn196.placement.db, k196)
        od, oi = od.cpu().numpy(), oi.cpu().numpy()
        rel196 = float(np.max(np.abs(d196 - od) / np.maximum(od, 1e-30)))
        if not np.array_equal(i196, oi) or rel196 > ck.RANK_SLACK:
            raise AssertionError(
                f"m = 196: certified search differs from the oracle "
                f"(max_rel_dist_err={rel196})")
        eps196 = cert_eps(q196, placed)
        many = {"m": m196, "rows": n196, "queries": q196.shape[0],
                "error_over_header_bound": ratio196,
                "same_indices_all_queries": True,
                "max_rel_dist_err": rel196,
                "certified": st196["certified"],
                "fallback_queries": st196["fallback_queries"],
                "eps_max": float(eps196.max()),
                "k7_term_share_of_eps": float(np.max(
                    ppq.k7_rounding(m196, 4)
                    * ((q196.astype(np.float64) ** 2).sum(-1)
                       + 2 * placed["stats"]["db_norm_max"]) / eps196))}
        del knn196, placed
        emit({"phase": "pq", "n": S["n"], "queries": n_q, "k": S["k"],
              "placement_s": placement_s, "train_s": pq["train_s"],
              "train_rows": PQ_TRAIN_ROWS,
              # placement_s / train_s time main_pq's own steps, not
              # ShardedKNN._pq_placement (the lattice case runs that)
              "placed_by": "chip_smoke.main_pq",
              "m": int(pq["books"].shape[0]), "ncodes": pq["ncodes"],
              "dsub": pq["dsub"], "norm_err_max": pq["stats"]["norm_err_max"],
              "r_sub_max": float(np.max(pq["stats"]["r_sub"])),
              "eps_max": float(eps.max()), "eps_median": float(np.median(eps)),
              "kernels": dict(timing, plain_ms=plain_ms, bound=bound),
              "runs": runs,
              "lattice": {"rows": rows.shape[0], "tile_n": 2048,
                          "train_s": pql["train_s"],
                          "r_sub_max": float(np.max(pql["stats"]["r_sub"])),
                          "norm_err_max": pql["stats"]["norm_err_max"],
                          "eps_max": float(lat_eps.max()), "runs": lat_runs},
              "many_subspaces": many})
        del pql

    def phase_lane(S):
        from knn_tpu_torch import knn_search_certified, pallas_candidate_fn

        # every arm's lane entries against their plain versions at small
        # shapes, every survivor count and bin width; lane scores bitwise
        # the grouped ones
        rng = np.random.default_rng(9)
        cases = []
        for arm in ck.ARMS:
            for surv, bin_w in LANE_GEOMETRIES:
                tile, n_q, n = 512, 37, 5 * 128 + 60
                if arm == "pq":
                    args, tol_q = pq_case(dev, n_q, n, 7, 200, tile, 1), None
                elif arm in ck.INT_ARMS:
                    args = int_case(dev, arm, n_q, n, 24, tile, surv)
                    tol_q = None
                else:
                    q = torch.from_numpy((rng.normal(size=(n_q, 24)) * 10)
                                         .astype(np.float32)).to(dev)
                    db = torch.from_numpy((rng.normal(size=(n, 24)) * 10)
                                          .astype(np.float32)).to(dev)
                    db[3] = db[10]
                    db[90] = db[10]
                    args = (ck.pad_queries(q),
                            *ck.prepare_db_arm(db, tile, arm))
                    tol_q = tolerance_q(q, db, arm=arm)
                kw = {"tile_n": tile, "arm": arm, "binning": "lane",
                      "survivors": surv, "bin_w": bin_w}
                geo = ck.emit_geometry(tile, "lane", bin_w, surv)
                plain = ck.binned_select_plain(*args, **kw)
                n_p = args[-1].shape[1]
                for key, out in (
                        ("tiled", ck.binned_select(*args, **kw)),
                        ("db_major", ck.binned_select(
                            *args, **kw, grid_order="db_major")),
                        ("streaming", ck.stream_select(*args, **kw))):
                    name = f"{key}_lane_{arm} s{surv} b{bin_w}"
                    chk = checks[f"{key}_lane_{arm}"]
                    if tol_q is None:
                        err = bitwise(name, out, plain)
                    else:
                        err = max(chk.values(f"{name} cd", out[0], plain[0],
                                             tol_q),
                                  chk.values(f"{name} bounds", out[2],
                                             plain[2], tol_q))
                        check_ci_lane(name, out, plain, tol_q, geo)
                    chk.max_abs_err = max(chk.max_abs_err, err)
                    grouped_fn = (ck.stream_select if key == "streaming"
                                  else ck.binned_select)
                    lane_scores_equal_grouped(
                        name, out, grouped_fn(*args, tile_n=tile, arm=arm),
                        n_p)
                cases.append({"arm": arm, "survivors": surv, "bin_w": bin_w,
                              "geometry": geo, "bitwise": tol_q is None,
                              "scores_equal_grouped": True})
        emit({"phase": "lane_kernels", "cases": cases})

        # each arm's lane entries at the main shape: against the plain
        # version, against the grouped scores on every query, timed beside
        # the grouped entries in turns
        out = {"phase": "lane"}
        geo = ck.emit_geometry(ck.TILE_N, "lane")
        for arm in ck.ARMS:
            args = arm_operands(S, arm)
            ka = {"tile_n": ck.TILE_N, "arm": arm, "binning": "lane"}
            plain, plain_ms = timed_once(
                lambda: ck.binned_select_plain(*args, **ka))
            tiled = ck.binned_select(*args, **ka)
            if arm in ck.INT_ARMS or arm == "pq":
                err = bitwise(f"tiled_lane_{arm}@main", tiled, plain)
                ci_checked = None
            else:
                tol_q = tolerance_q(S["q_dev"],
                                    tmax=S["knn"].placement.db_norm_max,
                                    arm=arm)
                chk = checks[f"tiled_lane_{arm}"]
                err = max(chk.values(f"tiled_lane_{arm}@main cd", tiled[0],
                                     plain[0], tol_q),
                          chk.values(f"tiled_lane_{arm}@main bounds",
                                     tiled[2], plain[2], tol_q))
                ci_checked = check_ci_lane(f"tiled_lane_{arm}@main", tiled,
                                           plain, tol_q, geo)
            del plain
            for key, fn, kw in (("db_major", ck.binned_select,
                                 {"grid_order": "db_major"}),
                                ("streaming", ck.stream_select, {})):
                bitwise(f"{key}_lane_{arm}@main vs tiled",
                        fn(*args, **ka, **kw), tiled)
            for kern in ("tiled", "db_major", "streaming"):
                rec = f"{kern}_lane_{arm}"
                checks[rec].max_abs_err = max(checks[rec].max_abs_err, err)
            common = lane_scores_equal_grouped(
                f"lane_{arm}@main", tiled,
                ck.binned_select(*args, tile_n=ck.TILE_N, arm=arm),
                args[-1].shape[1])
            del tiled
            entries = {"tiled": (ck.binned_select, {}),
                       "db_major": (ck.binned_select,
                                    {"grid_order": "db_major"}),
                       "streaming": (ck.stream_select, {})}
            timing, ratio = {}, {}
            for kern, (fn, kw) in entries.items():
                # grouped, lane, lane, grouped
                g1 = time_cuda(lambda: fn(*args, tile_n=ck.TILE_N, arm=arm,
                                          **kw), 3)
                lane_ms = [time_cuda(lambda: fn(*args, **ka, **kw), 3)
                           for _ in range(2)]
                g2 = time_cuda(lambda: fn(*args, tile_n=ck.TILE_N, arm=arm,
                                          **kw), 3)
                timing[f"{kern}_ms"] = sum(lane_ms) / 2
                timing[f"{kern}_grouped_ms"] = (g1 + g2) / 2
                ratio[kern] = timing[f"{kern}_ms"] / timing[f"{kern}_grouped_ms"]
            bound = arm_bound(S, arm, args, geo)
            del args
            out[arm] = {"kernels": dict(timing, plain_ms=plain_ms,
                                        lane_over_grouped=ratio,
                                        bound=bound, max_abs_err=err,
                                        ci_separated_checked=ci_checked,
                                        rows_compared_with_grouped=common)}
            for kern in ("tiled", "db_major", "streaming"):
                records[f"{kern}_lane_{arm}"].update(
                    ms=timing[f"{kern}_ms"], plain_ms=plain_ms,
                    bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])

        # the certified search in lane binning through every certified arm:
        # every query's indices are the grouped bf16x3 run's
        if "tiled" not in S:
            (d, i, _), _ = timed_search(S)
            S["tiled"] = (d, i)
        for arm in ("bf16x3", "bf16x3f", "highest", "int8", "int4", "pq"):
            runs = run_configs(S, arm, ("tiled", "tiled_db_major",
                                        "streaming"),
                               binning="lane", ref_i=S["tiled"][1])
            out[arm]["runs"] = runs
            for kern in ("tiled", "streaming"):
                records[f"{kern}_lane_{arm}"]["launches"] = \
                    runs[kern]["launches"][f"{kern}_lane_{arm}"]
            records[f"db_major_lane_{arm}"]["launches"] = \
                runs["tiled_db_major"]["launches"][f"db_major_{arm}"]
        # the default arm's lane entries through the counted certificate
        counted = {}
        for label in ("tiled", "tiled_db_major", "streaming"):
            kern = kernel_configs[label]["kernel"]
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, i, st = knn_search_certified(
                S["q_np"], S["knn"].placement.db_host, S["k"], margin=28,
                candidate_fn=pallas_candidate_fn(
                    precision="default", binning="lane",
                    **kernel_configs[label]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            key = f"{kern}_lane_default"
            own = [key] + (["db_major_default"] if label != kern else [])
            if any(launches[k] != 1 for k in own) \
                    or sum(launches.values()) != len(own):
                raise AssertionError(
                    f"counted certificate lane {label}: launches {launches}")
            if not np.array_equal(i, S["tiled"][1]):
                raise AssertionError(
                    f"counted certificate lane {label}: indices differ")
            recall, same, rel = oracle_check(S, d, i, f"counted lane {label}")
            if label == kern:
                records[key]["launches"] = launches[key]
            else:
                records["db_major_lane_default"]["launches"] = \
                    launches["db_major_default"]
            counted[label] = {"launches": launches, "wall_s": wall,
                             "qps": S["n_q"] / wall, "recall_at_k": recall,
                             "same_indices": same, "max_rel_dist_err": rel,
                             "fallback_queries": st["fallback_queries"]}
        out["default"]["counted_certificate"] = counted
        emit(out)

    def grouped_compare(name, key, out, plain, tol_q, n_tiles):
        """A grouped entry's output against its plain version: bitwise
        (int, pq: ``tol_q`` None), else cd and bounds within ``tol_q`` and
        ci equal on separated slots; folds the error into ``key``'s
        check."""
        chk = checks[key]
        if tol_q is None:
            err = bitwise(name, out, plain)
        else:
            err = max(chk.values(f"{name} cd", out[0], plain[0], tol_q),
                      chk.values(f"{name} bounds", out[2], plain[2], tol_q))
            check_ci(name, out, plain, tol_q, n_tiles)
        chk.max_abs_err = max(chk.max_abs_err, err)
        return err

    def deep_fused_compare(name, key, args, kw, plain, tol_q, keep, n_tiles):
        """The fused entry at ``kw``'s survivors against its plain version
        at the kernel's own geometry (query blocks, tile segments): the
        same skipped (block, tile) cells and the rest as grouped_compare;
        returns the skipped cells."""
        surv = ck.emit_geometry(kw["tile_n"], survivors=kw["survivors"])[1]
        seg = ck.kernel_segment_tiles(args[0].shape[0], n_tiles, dev,
                                      "fused", kw["arm"], (0, surv))
        kern = ck.fused_select(*args, **kw, keep=keep)
        fplain = ck._early_out(tuple(t.clone() for t in plain), n_tiles,
                               keep, ck.QUERY_BLOCK, seg)
        skip = ck.skipped_cells(kern[0], n_tiles)
        if not torch.equal(skip, ck.skipped_cells(fplain[0], n_tiles)):
            raise AssertionError(f"{name}: skipped other cells than its "
                                 f"plain version")
        grouped_compare(name, key, kern, fplain, tol_q, n_tiles)
        return int(skip.sum())

    def counted_deep_runs(D, labels, ref_i):
        """The counted certificate through the default arm's deep entries
        at 3 survivors on D's queries, the launch counts read around each
        call alone: each its own entry once, the oracle's indices."""
        from knn_tpu_torch import knn_search_certified, pallas_candidate_fn

        runs = {}
        for label in labels:
            kern = kernel_configs[label]["kernel"]
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, i, st = knn_search_certified(
                D["q_np"], D["knn"].placement.db_host, D["k"], margin=28,
                candidate_fn=pallas_candidate_fn(
                    precision="default", survivors=3,
                    **kernel_configs[label]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_launches()
            own = [f"{kern}_deep_default"] + (
                ["db_major_default"] if label != kern else [])
            if any(launches[k] != 1 for k in own) \
                    or sum(launches.values()) != len(own):
                raise AssertionError(
                    f"counted certificate deep {label}: launches {launches}")
            if not np.array_equal(i, ref_i):
                raise AssertionError(
                    f"counted certificate deep {label}: indices differ")
            recall, same, rel = oracle_check(D, d, i,
                                             f"counted deep {label}")
            runs[label] = {"launches": launches, "wall_s": wall,
                           "recall_at_k": recall, "same_indices": same,
                           "max_rel_dist_err": rel,
                           "fallback_queries": st["fallback_queries"]}
        return runs

    def phase_survivors(S):
        """Grouped binning at 1, 3 and 8 survivors (the deep build) in
        every entry of every arm against its plain version, the fused
        skip, the deep builds at the main shape beside the two-survivor
        ones in turns, and certified searches through them."""
        rng = np.random.default_rng(11)
        cases = []
        # seconds of each part of the phase
        t_part = time.perf_counter()
        part_s = {}

        def part_done(name):
            nonlocal t_part
            now = time.perf_counter()
            part_s[name] = round(now - t_part, 1)
            t_part = now

        # small shapes: dim 24 with ragged rows, 4 and 8 groups a tile,
        # exact ties; dim 300 (three chunks: the multi-chunk builds), each
        # at every deep count; then 256 and 512 groups a tile (the widest
        # tile of the packed builds, and the four-pass build's geometry)
        # with ties between the first and last groups of each tile
        shapes = [((37, 5 * 128 + 60, 24, 512), SMALL_SURVIVOR_COUNTS),
                  ((37, 9 * 128 + 60, 24, 1024), SMALL_SURVIVOR_COUNTS),
                  ((11, 3 * 128 + 40, 300, 512), SMALL_SURVIVOR_COUNTS),
                  ((37, 2 * 32768 + 60, 24, 32768), SURVIVOR_COUNTS),
                  ((37, 2 * 65536 + 60, 24, 65536), SURVIVOR_COUNTS)]
        for arm in ck.ARMS:
            for (n_q, n, dim, tile), counts in shapes:
                ties = wide_ties(tile, n) if tile > 1024 else ()
                if arm == "pq":
                    args = pq_case(dev, n_q, n, 7, 200, tile, 2, ties)
                    tol_q = None
                elif arm in ck.INT_ARMS:
                    args = int_case(dev, arm, n_q, n, dim, tile, 5, ties)
                    tol_q = None
                else:
                    q = torch.from_numpy((rng.normal(size=(n_q, dim)) * 10)
                                         .astype(np.float32)).to(dev)
                    db = torch.from_numpy((rng.normal(size=(n, dim)) * 10)
                                          .astype(np.float32)).to(dev)
                    db[3] = db[10]
                    db[90] = db[10]
                    for dst, src in ties:
                        db[dst] = db[src]
                    args = (ck.pad_queries(q), *ck.prepare_db_arm(db, tile,
                                                                  arm))
                    tol_q = tolerance_q(q, db, arm=arm)
                n_tiles = args[-1].shape[1] // tile
                for surv in counts:
                    kw = {"tile_n": tile, "arm": arm, "survivors": surv}
                    plain = ck.binned_select_plain(*args, **kw)
                    tiled = ck.binned_select(*args, **kw)
                    name = f"deep {arm} s{surv} dim{dim} tile{tile}"
                    grouped_compare(f"tiled {name}", f"tiled_deep_{arm}",
                                    tiled, plain, tol_q, n_tiles)
                    for key, fn, extra in (
                            ("db_major", ck.binned_select,
                             {"grid_order": "db_major"}),
                            ("streaming", ck.stream_select, {})):
                        bitwise(f"{key} {name} vs tiled",
                                fn(*args, **kw, **extra), tiled)
                        checks[f"{key}_deep_{arm}"].max_abs_err = max(
                            checks[f"{key}_deep_{arm}"].max_abs_err,
                            checks[f"tiled_deep_{arm}"].max_abs_err)
                    case = {"arm": arm, "survivors": surv, "q": n_q,
                            "rows": n, "dim": dim, "tile_n": tile,
                            "bitwise": tol_q is None}
                    if arm != "pq":
                        bitwise(f"fused disarmed {name} vs streaming",
                                ck.fused_select(*args, **kw, keep=None),
                                ck.stream_select(*args, **kw))
                        case["fused_skipped_cells"] = deep_fused_compare(
                            f"fused {name}", f"fused_deep_{arm}", args, kw,
                            plain, tol_q, 130, n_tiles)
                    cases.append(case)
                # above MAX_SURVIVORS the count is capped, as the JAX
                # package caps it
                bitwise(f"deep {arm} s12 vs s8",
                        ck.binned_select(*args, tile_n=tile, arm=arm,
                                         survivors=12),
                        ck.binned_select(*args, tile_n=tile, arm=arm,
                                         survivors=8))
        part_done("small_shapes")
        emit({"phase": "survivors_kernels", "cases": cases})

        # the fused skip at 1, 3, 5 and 8 survivors (builds A, B, C) on the
        # far-tile case: the same skipped cells as the plain version, some
        # of them skipped
        fq, fdb = far_tile_case(dev)
        far = {}
        for arm in ck.ARMS:
            if arm == "pq":
                continue
            if arm in ck.INT_ARMS:
                fargs = (*ck.quantize_queries(fq),
                         *ck.prepare_db_int(fdb, ck.TILE_N, arm))
                tol_q = None
            else:
                fargs = (ck.pad_queries(fq),
                         *ck.prepare_db_arm(fdb, ck.TILE_N, arm))
                tol_q = tolerance_q(fq, fdb, arm=arm)
            n_tiles = fargs[-1].shape[1] // ck.TILE_N
            for surv in (1, 3, 5, 8):
                kw = {"tile_n": ck.TILE_N, "arm": arm, "survivors": surv}
                plain = ck.binned_select_plain(*fargs, **kw)
                skipped = deep_fused_compare(
                    f"fused deep {arm} s{surv} far tiles", f"fused_deep_{arm}",
                    fargs, kw, plain, tol_q, 130, n_tiles)
                if skipped < 1:
                    raise AssertionError(f"fused deep {arm} s{surv} skipped "
                                         f"no cell on the far-tile case")
                far[f"{arm}_s{surv}"] = skipped
            del fargs, plain
        del fq, fdb
        part_done("far_tiles")

        # the main placement, a 512-query subset: every entry at 1, 3 and
        # 8 survivors against its plain version.  pq's placement is the pq
        # phase's (its training is that phase's cost): without it, pq is
        # left out here
        sub = 512
        pl = S["knn"].placement
        arms = [arm for arm in ck.ARMS if arm != "pq" or S["knn"]._pq]
        main = {}
        for arm in arms:
            args = arm_operands(S, arm)
            nq_args = 2 if arm in ck.INT_ARMS else 1
            sargs = (*(a[:sub] for a in args[:nq_args]), *args[nq_args:])
            tol_q = (None if arm in ck.INT_ARMS or arm == "pq" else
                     tolerance_q(S["q_dev"][:sub], tmax=pl.db_norm_max,
                                 arm=arm))
            n_tiles = args[-1].shape[1] // ck.TILE_N
            out = {}
            for surv in SURVIVOR_COUNTS:
                kw = {"tile_n": ck.TILE_N, "arm": arm, "survivors": surv}
                plain = ck.binned_select_plain(*sargs, **kw)
                tiled = ck.binned_select(*sargs, **kw)
                name = f"deep {arm} s{surv}@main"
                err = grouped_compare(f"tiled {name}", f"tiled_deep_{arm}",
                                      tiled, plain, tol_q, n_tiles)
                for key, fn, extra in (
                        ("db_major", ck.binned_select,
                         {"grid_order": "db_major"}),
                        ("streaming", ck.stream_select, {})):
                    bitwise(f"{key} {name} vs tiled",
                            fn(*sargs, **kw, **extra), tiled)
                    checks[f"{key}_deep_{arm}"].max_abs_err = max(
                        checks[f"{key}_deep_{arm}"].max_abs_err, err)
                out[f"s{surv}"] = {"max_abs_err": err}
                if arm != "pq":
                    out[f"s{surv}"]["fused_skipped_cells"] = \
                        deep_fused_compare(f"fused {name}",
                                           f"fused_deep_{arm}", sargs, kw,
                                           plain, tol_q, 130, n_tiles)
                del plain, tiled
            # every entry at 4,096 queries in turns with its two-survivor
            # build: 2, then each of SURVIVOR_COUNTS, then 2 again (CUDA
            # events, mean of 2)
            entries = {"tiled": (ck.binned_select, {}),
                       "db_major": (ck.binned_select,
                                    {"grid_order": "db_major"}),
                       "streaming": (ck.stream_select, {})}
            if arm != "pq":
                entries["fused"] = (ck.fused_select, {"keep": 130})
            times = {}
            for key, (fn, extra) in entries.items():
                def run(surv):
                    return fn(*args, tile_n=ck.TILE_N, arm=arm,
                              survivors=surv, **extra)

                def timed(surv):
                    run(surv)
                    torch.cuda.synchronize()
                    return time_cuda(lambda: run(surv), 2)

                t2 = timed(2)
                deep = {f"s{surv}": timed(surv) for surv in SURVIVOR_COUNTS}
                times[key] = {"s2_ms": [t2, timed(2)], **{
                    f"{k}_ms": v for k, v in deep.items()}}
            out["times_4096"] = times
            # the records: the 8-survivor build at 4,096 queries against
            # its plain version there and the bound of its work
            geo8 = ck.emit_geometry(ck.TILE_N, survivors=8)
            plain8, plain_ms = timed_once(lambda: ck.binned_select_plain(
                *args, tile_n=ck.TILE_N, arm=arm, survivors=8))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck._early_out(plain8, n_tiles, 130, ck.QUERY_BLOCK, None)
            torch.cuda.synchronize()
            early_ms = (time.perf_counter() - t0) * 1e3
            del plain8
            bound = arm_bound(S, arm, args, geo8)
            for key in entries:
                records[f"{key}_deep_{arm}"].update(
                    ms=times[key]["s8_ms"],
                    plain_ms=plain_ms + (early_ms if key == "fused" else 0),
                    bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                    ms_by_survivors={s: times[key][f"s{s}_ms"]
                                     for s in SURVIVOR_COUNTS},
                    two_survivor_ms=times[key]["s2_ms"])
            out["plain_s8_ms"] = plain_ms
            out["bound_s8"] = bound
            main[arm] = out
            del args, sargs
            torch.cuda.empty_cache()

        part_done("main_subset_and_timings")
        # certified searches through the deep build: bf16x3 at 4 and 8
        # survivors on every query (recall@100 = 1.0 against the oracle,
        # the two-survivor run's indices), the launch count read around
        # each call alone
        if "tiled" not in S:
            (d, i, _), _ = timed_search(S)
            S["tiled"] = (d, i)
        searches = {}
        for surv in (4, 8):
            searches[f"s{surv}"] = run_configs(
                S, "bf16x3", ("tiled",), ref_i=S["tiled"][1],
                survivors=surv)["tiled"]
        # ... and every entry of every arm at 3 survivors on the subset
        D = {key: S[key] for key in ("knn", "k", "od", "oi") if key in S}
        D.update(q_np=S["q_np"][:sub], q_dev=S["q_dev"][:sub], n_or=256)
        for arm in arms:
            labels = ("tiled", "tiled_db_major", "streaming") + (
                () if arm == "pq" else ("fused",))
            if arm == "default":   # no one-pass certificate: the counted one
                runs = counted_deep_runs(D, labels, S["tiled"][1][:sub])
            else:
                runs = run_configs(D, arm, labels, ref_i=S["tiled"][1][:sub],
                                   survivors=3)
            for label in labels:
                kern = kernel_configs[label]["kernel"]
                if label == "tiled_db_major":
                    records[f"db_major_deep_{arm}"]["launches"] = \
                        runs[label]["launches"][f"db_major_{arm}"]
                else:
                    records[f"{kern}_deep_{arm}"]["launches"] = \
                        runs[label]["launches"][f"{kern}_deep_{arm}"]
            searches[f"{arm}_s3"] = runs
        for arm in arms:
            db_times = main[arm]["times_4096"]["db_major"]
            records[f"db_major_deep_{arm}"].update(
                {f: records[f"tiled_deep_{arm}"][f]
                 for f in ("plain_ms", "bound_ms", "bound_by")},
                ms=db_times["s8_ms"],
                ms_by_survivors={s: db_times[f"s{s}_ms"]
                                 for s in SURVIVOR_COUNTS},
                two_survivor_ms=db_times["s2_ms"])
            checks[f"db_major_deep_{arm}"].max_abs_err = \
                checks[f"tiled_deep_{arm}"].max_abs_err
        part_done("searches")
        emit({"phase": "survivors", "part_seconds": part_s,
              "far_tile_skipped_cells": far,
              "main_subset_queries": sub, "arms_at_main": arms, "main": main,
              "searches": searches})

    def phase_tune(S):
        """The autotuner: the quick grid on the main placement's rows, a
        second call from the cache, the standard grid at 100,000 rows
        (pq's training among its candidates), and a search resolving its
        knobs from the cache."""
        import importlib

        from knn_tpu_torch import tuning

        # the module (the package exports its ``autotune`` function)
        tune_mod = importlib.import_module("knn_tpu_torch.tuning.autotune")
        db_np = S["knn"].placement.db_host
        q_np = S["q_np"][:256]
        out = {"phase": "tune"}
        with tempfile.TemporaryDirectory() as tmp:
            cache = f"{tmp}/autotune.json"
            for label, rows, level in (("quick_1m", db_np, "quick"),
                                       ("standard_100k", db_np[:100_000],
                                        "standard")):
                tuning.reset_counters()
                t0 = time.perf_counter()
                entry = tuning.autotune(rows, q_np, S["k"], grid_level=level,
                                        runs=2, cache_path=cache)
                first_s = time.perf_counter() - t0
                first = tuning.counters()
                grid = tuning.knob_grid(level)
                labels = [tune_mod._label({**tuning.DEFAULT_KNOBS, **c})
                          for c in grid]
                timed = [lb for lb in labels
                         if entry["timings_ms"].get(lb) is not None]
                # every candidate timed, or gated out / refused with its
                # reason recorded; one that raised (its error is the
                # exception's type and message) is a build or launch fault
                missing = [lb for lb in labels if lb not in entry["timings_ms"]
                           or (entry["timings_ms"][lb] is None
                               and lb not in entry["errors"])]
                raised = {lb: e for lb, e in entry["errors"].items()
                          if not e.startswith(("bitwise gate",
                                               "smem-refused"))}
                if entry["cached"] or missing or raised or \
                        first["candidates_timed"] != len(timed):
                    raise AssertionError(f"tune {label}: {entry}, missing "
                                         f"{missing}, raised {raised}, "
                                         f"counters {first}")
                tuning.reset_counters()
                t0 = time.perf_counter()
                again = tuning.autotune(rows, q_np, S["k"], grid_level=level,
                                        runs=2, cache_path=cache)
                second_s = time.perf_counter() - t0
                second = tuning.counters()
                if not again["cached"] or second["candidates_timed"] != 0 \
                        or again["knobs"] != entry["knobs"]:
                    raise AssertionError(f"tune {label}: the second call "
                                         f"re-timed: {second}")
                catalog_check(f"tune {label}", "tuning_cache_entry", entry)
                catalog_check(f"tune {label} cached", "tuning_cache_entry",
                              again)
                out[label] = {
                    "rows": int(rows.shape[0]), "queries": int(q_np.shape[0]),
                    "candidates": len(labels), "timed": len(timed),
                    "winner": entry["winner"], "winner_ms": entry["winner_ms"],
                    "timings_ms": entry["timings_ms"],
                    "errors": entry["errors"], "smem": entry.get("smem"),
                    "cache_key": entry["cache_key"], "first_s": first_s,
                    "counters_first": first, "second_s": second_s,
                    "counters_second": second}
            # the consumer: search_certified on the 1M placement resolves
            # its knobs from the cache (the quick grid's winner)
            win = out["quick_1m"]
            d, i, st = S["knn"].search_certified(S["q_np"], tune_cache=cache)
            if st["tuning"]["source"] != "cache" or st["pallas_knobs"] != {
                    **tuning.DEFAULT_KNOBS,
                    **tuning.TuneCache(cache).get(win["cache_key"])["knobs"]}:
                raise AssertionError(f"tune: search did not resolve from the "
                                     f"cache: {st['tuning']}")
            if "tiled" in S and not np.array_equal(i, S["tiled"][1]):
                raise AssertionError(
                    "tune: the cached winner's indices differ")
            out["search_from_cache"] = {"tuning": st["tuning"],
                                        "pallas_knobs": st["pallas_knobs"],
                                        "fallback_queries":
                                            st["fallback_queries"]}
        emit(out)

    def f64_mips_oracle(q, db, k, chunk=65536):
        """Exact lexicographic top-k of -q.t on the card in float64,
        (value, index) order."""
        from knn_tpu_torch.ops.topk import merge_topk

        q64 = q.double()
        best_d = torch.full((q.shape[0], k), torch.inf, dtype=torch.float64,
                            device=q.device)
        best_i = torch.full((q.shape[0], k), 2 ** 62, dtype=torch.int64,
                            device=q.device)
        for lo in range(0, db.shape[0], chunk):
            d = -(q64 @ db[lo : lo + chunk].double().T)
            idx = torch.arange(lo, lo + d.shape[1], device=q.device)
            best_d, best_i = merge_topk(best_d, best_i, d, idx.expand_as(d), k)
        return best_d.cpu().numpy(), best_i.cpu().numpy()

    def f64_l1_oracle(q, db, k, chunk=4096):
        """Exact lexicographic top-k of the L1 distance on the card in
        float64."""
        from knn_tpu_torch.ops.topk import merge_topk

        q64 = q.double()
        best_d = torch.full((q.shape[0], k), torch.inf, dtype=torch.float64,
                            device=q.device)
        best_i = torch.full((q.shape[0], k), 2 ** 62, dtype=torch.int64,
                            device=q.device)
        for lo in range(0, db.shape[0], chunk):
            t = db[lo : lo + chunk].double()
            d = (q64[:, None, :] - t[None, :, :]).abs().sum(-1)
            idx = torch.arange(lo, lo + t.shape[0], device=q.device)
            best_d, best_i = merge_topk(best_d, best_i, d, idx.expand_as(d), k)
        return best_d.cpu().numpy(), best_i.cpu().numpy()

    def safe_radius_sq(dists, norm_scale):
        """A squared radius between two of the [Q, M] ascending distances
        ``dists``, below every query's M-th (so every in-radius row is among
        the M) and in the upper half of those values, in the widest gap
        there; the gap must clear the f32 count's tolerance (8 eps_f32 the
        ``norm_scale``, ops.certified.certification_tolerance) on both
        sides.  Returns (radius^2, gap)."""
        vals = np.unique(dists[dists < dists[:, -1].min()])
        vals = vals[len(vals) // 2 :]
        g = int(np.argmax(np.diff(vals)))
        gap = float(vals[g + 1] - vals[g])
        if gap <= 16 * float(np.finfo(np.float32).eps) * norm_scale:
            raise AssertionError(f"no radius clears the f32 tolerance: widest "
                                 f"gap {gap}")
        return 0.5 * float(vals[g] + vals[g + 1]), gap

    def counted_run(knn, q_np, selector, label, **kw):
        """search_certified through a counted selector with the launch
        counts read around it alone: the counted path runs no coarse
        kernel, so every count must stay 0."""
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = knn.search_certified(q_np, margin=28, selector=selector, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if any(launches.values()):
            raise AssertionError(f"{label}: launched {launches}")
        return out, wall

    def phase_selectors(S):
        """The counted exact / approx selectors and a bf16 placement on
        the main rows, beside the pallas selector."""
        from knn_tpu_torch import ShardedKNN
        from knn_tpu_torch.ops import distance as pdist
        from knn_tpu_torch.ops.certified import (certification_tolerance,
                                                 count_below)
        from knn_tpu_torch.ops.refine import refine_exact

        knn, q_np, n_q, k, n_or = S["knn"], S["q_np"], S["n_q"], S["k"], S["n_or"]
        part_s, t_part = {}, [time.perf_counter()]

        def part(name):
            now = time.perf_counter()
            part_s[name] = now - t_part[0]
            t_part[0] = now

        if "tiled" not in S:
            (d, i, _), _ = timed_search(S)
            S["tiled"] = (d, i)
        pallas_i = S["tiled"][1]
        out = {"phase": "selectors", "n": S["n"], "queries": n_q, "k": k,
               "part_seconds": part_s}
        for sel in ("exact", "approx"):
            (d, i, st), wall = counted_run(knn, q_np, sel, sel)
            if not np.array_equal(i, pallas_i):
                raise AssertionError(f"{sel}: indices differ from pallas's")
            # the counted selectors' distances are float64-refined: the
            # oracle's within 1e-12 relative
            recall, same, _ = oracle_check(S, d, i, sel)
            rel = float(np.max(np.abs(d[:n_or] - S["od"])
                               / np.maximum(S["od"], 1e-30)))
            if rel > 1e-12:
                raise AssertionError(f"{sel}: f64 distances off the oracle's "
                                     f"by {rel}")
            out[sel] = {"recall_at_k": recall, "same_indices": same,
                        "same_indices_as_pallas_all_queries": True,
                        "max_rel_dist_err_f64": rel,
                        "certified": st["certified"],
                        "fallback_queries": st["fallback_queries"],
                        "host_exact_queries": st.get("host_exact_queries", 0),
                        "qps_first_call": n_q / wall}
        part("first_calls")
        # warm q/s, the three selectors in turns (two rounds)
        walls = {sel: [] for sel in ("pallas", "exact", "approx")}
        for _ in range(2):
            for sel in walls:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                knn.search_certified(q_np, margin=28, selector=sel)
                torch.cuda.synchronize()
                walls[sel].append(time.perf_counter() - t0)
        out["warm_qps"] = {sel: [n_q / w for w in ws]
                           for sel, ws in walls.items()}
        part("turns")
        # where a counted call's time goes: the coarse distance blocks
        # (matmul and norms), the coarse top-m (the stable sort, coarse
        # minus distance), the float64 refine on the host, the count pass
        q, db, m = S["q_dev"], knn.placement.db, k + 28
        rows = max(1, (1 << 27) // S["n"])

        def dist_blocks():
            for lo in range(0, n_q, rows):
                pdist.pairwise_sq_l2(q[lo : lo + rows], db)

        _, t_dist = host_timed(dist_blocks)
        ci, t_coarse = host_timed(lambda: knn._exact_topk(q, m, "l2")[1])
        t0 = time.perf_counter()
        ci = ci.cpu().numpy()
        d_m, _ = refine_exact(knn.placement.db_host, q_np, ci, m)
        t_refine = time.perf_counter() - t0
        thr = torch.from_numpy(
            (d_m[:, k - 1] + certification_tolerance(
                q_np, None, db_norm_max=knn.placement.db_norm_max)
             ).astype(np.float32))
        _, t_count = host_timed(lambda: count_below(db, q, thr))
        out["exact_breakdown_s"] = {
            "coarse_distance_blocks": t_dist, "coarse_top_m": t_coarse - t_dist,
            "refine_f64_host": t_refine, "count": t_count}
        part("breakdown")
        # the trace of a 512-query call: a 4,096-query one records ~50,000
        # kernel events, whose processing after two earlier traces in the
        # process took minutes
        out["profile_exact_512"] = profile_search(knn, q_np[:512],
                                                  selector="exact")
        part("profile")
        # a bf16 placement of the same rows: search ranks in bf16 products
        # with f32 accumulation, the certificate stays exact
        bknn = ShardedKNN(knn.placement, k=k, compute_dtype="bfloat16")
        reset_launches()
        bd, bi = bknn.search(q_np[:n_or])
        if any(read_launches().values()):
            raise AssertionError("bf16 search: a coarse kernel was launched")
        bi = bi.cpu().numpy()
        b_recall = float(np.mean([len(set(a) & set(b)) / k
                                  for a, b in zip(bi, S["oi"])]))
        (d, i, st), wall = counted_run(bknn, q_np, "exact", "bf16 exact")
        if not np.array_equal(i, pallas_i):
            raise AssertionError("bf16 exact: indices differ from pallas's")
        recall, same, _ = oracle_check(S, d, i, "bf16 exact")
        out["bfloat16"] = {
            "matmul_form": pdist.half_matmul_form(dev),
            "search_recall_at_k": b_recall,
            "search_queries": n_or,
            "certified_exact": {"recall_at_k": recall, "same_indices": same,
                                "certified": st["certified"],
                                "fallback_queries": st["fallback_queries"],
                                "qps_first_call": n_q / wall}}
        del bknn
        part("bfloat16")
        emit(out)

    def phase_metrics(S):
        """dot (K1 at Dp 256), l1, radius and the estimators on the main
        rows."""
        from knn_tpu_torch import (KNNRegressor, NearestNeighbors,
                                   RadiusNeighborsClassifier, ShardedKNN)
        from knn_tpu_torch.models.regressor import _weighted_targets
        from knn_tpu_torch.ops.radius import SENTINEL_IDX
        from knn_tpu_torch.ops.vote import majority_vote

        db_np, q_np = S["knn"].placement.db_host, S["q_np"]
        n, n_q, k, n_or = S["n"], S["n_q"], S["k"], S["n_or"]
        out = {"phase": "metrics"}

        # dot: the norm-augmented placement, K1 at Dp 256
        t0 = time.perf_counter()
        dknn = ShardedKNN(db_np, k=k, metric="dot")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        dpl = dknn.placement
        dp = dpl.th.shape[1]
        if dp != 256:
            raise AssertionError(f"dot placement at Dp {dp}, not 256")
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, i, st = dknn.search_certified(q_np, margin=28, selector="pallas")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = ck.kernel_launches_per_batch("tiled", n, ck.TILE_N)
        if launches["k1"] != want or sum(launches.values()) != want:
            raise AssertionError(f"dot: launches {launches}, expected {want} "
                                 f"of k1 and no other kernel")
        qa = dknn._to_device(q_np)
        od, oi = f64_mips_oracle(qa[:n_or, :-1], dpl.db[:, :-1], k)
        recall = float(np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(i[:n_or], oi)]))
        if recall != 1.0 or not np.array_equal(i[:n_or], oi):
            raise AssertionError(f"dot: recall@{k} {recall} against the f64 "
                                 f"MIPS oracle")
        aug = 2 * od + (q_np[:n_or].astype(np.float64) ** 2).sum(-1)[:, None] \
            + dpl.db_norm_max
        rel = float(np.max(np.abs(d[:n_or] - od) / aug))
        if rel > ck.RANK_SLACK:
            raise AssertionError(f"dot: values off the oracle by {rel} of the "
                                 f"augmented distance")
        (_, ei, est), _ = counted_run(dknn, q_np, "exact", "dot exact")
        if not np.array_equal(ei, i):
            raise AssertionError("dot: the exact selector's indices differ "
                                 "from pallas's")
        # K1 at Dp 256 against its plain version on 512 queries, then both
        # timed at the main path's 4,096
        args = (ck.pad_queries(qa[:512]), dpl.th, dpl.tl, dpl.tnorm)
        kern = ck.binned_select(*args, tile_n=ck.TILE_N, arm="bf16x3")
        plain = ck.binned_select_plain(*args, tile_n=ck.TILE_N, arm="bf16x3")
        tol_q = tolerance_q(qa[:512], tmax=dpl.db_norm_max)
        err = max(checks["k1_dp256"].values("cd@dot", kern[0], plain[0], tol_q),
                  checks["k1_dp256"].values("bounds@dot", kern[2], plain[2],
                                            tol_q))
        check_ci("ci@dot", kern, plain, tol_q, dpl.th.shape[0] // ck.TILE_N)
        del kern, plain
        args = (ck.pad_queries(qa), dpl.th, dpl.tl, dpl.tnorm)
        ms = time_cuda(lambda: ck.binned_select(*args, tile_n=ck.TILE_N,
                                                arm="bf16x3"), 3)
        plain_ms = time_cuda(lambda: ck.binned_select_plain(
            *args, tile_n=ck.TILE_N, arm="bf16x3"), 1)
        # the bound counts the 129 augmented dims, not the 256 padded ones
        bound = f32_bound(n_q, n, dp, dpl.th.shape[0] // ck.TILE_N,
                          ck.SURVIVORS, d_real=dpl.dim_in + 1)
        records["k1_dp256"].update(launches=launches["k1"], ms=ms,
                                   plain_ms=plain_ms,
                                   bound_ms=bound["bound_ms"],
                                   bound_by=bound["bound_by"])
        out["dot"] = {"dp": dp, "setup_s": setup_s, "qps_first_call": n_q / wall,
                      "launches": {key: v for key, v in launches.items() if v},
                      "recall_at_k": recall,
                      "oracle_queries": n_or, "same_indices": True,
                      "max_err_over_augmented_distance": rel,
                      "certified": st["certified"],
                      "fallback_queries": st["fallback_queries"],
                      "exact_selector_same_indices": True,
                      "exact_selector_fallback_queries":
                          est["fallback_queries"],
                      "k1_dp256_ms": ms, "k1_dp256_plain_ms": plain_ms,
                      "k1_dp256_max_abs_err": err, "k1_dp256_bound": bound}
        del dknn, dpl, qa, args
        torch.cuda.empty_cache()

        # l1: the exact search on 256 queries against the f64 L1 oracle
        lknn = ShardedKNN(db_np, k=k, metric="l1")
        reset_launches()
        (_, li), wall = host_timed(lambda: lknn.search(q_np[:n_or]))
        if any(read_launches().values()):
            raise AssertionError("l1: a coarse kernel was launched")
        _, loi = f64_l1_oracle(S["q_dev"][:n_or], lknn.placement.db, k)
        li = li.cpu().numpy()
        l1_recall = float(np.mean([len(set(a) & set(b)) / k
                                   for a, b in zip(li, loi)]))
        if l1_recall < 0.999:
            raise AssertionError(f"l1: recall@{k} {l1_recall} < 0.999")
        out["l1"] = {"queries": n_or, "recall_at_k": l1_recall,
                     "same_indices_queries": int((li == loi).all(-1).sum()),
                     "search_s": wall}
        del lknn
        torch.cuda.empty_cache()

        # radius on the main placement: a radius between two oracle
        # distances below every query's 100th, so every in-radius row is
        # among the oracle's 100 and no row sits near the boundary
        if "od" not in S:
            od, oi = f64_oracle(S["q_dev"][:n_or], S["knn"].placement.db, k)
            S["od"], S["oi"] = od.cpu().numpy(), oi.cpu().numpy()
        od, oi = S["od"], S["oi"]
        q_norm_max = float((q_np[:n_or].astype(np.float64) ** 2).sum(-1).max())
        r2, gap = safe_radius_sq(od, q_norm_max
                                 + S["knn"].placement.db_norm_max)
        reset_launches()
        rd, ri, rc = S["knn"].radius_search(q_np[:n_or], float(np.sqrt(r2)),
                                            max_neighbors=k)
        want_in = od < r2
        # the in-radius sets: the f32 order among rows closer together
        # than its rounding may differ from the f64 one
        if not (np.array_equal(rc, want_in.sum(-1))
                and np.array_equal(ri != SENTINEL_IDX, want_in)
                and np.array_equal(np.sort(np.where(want_in, ri, -1), -1),
                                   np.sort(np.where(want_in, oi, -1), -1))):
            raise AssertionError("radius: counts or masks differ from the "
                                 "f64 oracle's")
        out["radius"] = {"queries": n_or, "radius_sq": r2,
                         "gap_around_radius": gap,
                         "in_radius_total": int(rc.sum()),
                         "max_count": int(rc.max()),
                         "queries_with_neighbors": int((rc > 0).sum()),
                         "counts_equal_oracle": True,
                         "masks_equal_oracle": True,
                         "launches": sum(read_launches().values())}

        # the estimators on 100,000 rows, each against its ShardedKNN
        X, Q = db_np[:100_000], q_np[:n_or]
        y = X[:, 0] * 0.5 + X[:, 1]
        labels = (np.arange(X.shape[0]) % 10).astype(np.int32)
        ek = 10
        base = ShardedKNN(X, k=32)
        bd, bi = base.search(Q)
        bd = bd.cpu().numpy()
        er2, _ = safe_radius_sq(bd, float(
            (Q.astype(np.float64) ** 2).sum(-1).max()
            + (X.astype(np.float64) ** 2).sum(-1).max()))
        er = float(np.sqrt(er2))
        reset_launches()
        t0 = time.perf_counter()
        reg = KNNRegressor(k=ek, weights="distance").fit(X, y).predict(Q)
        nn = NearestNeighbors(k=ek, max_neighbors=32).fit(X)
        graph = nn.kneighbors_graph(Q)
        rnn = nn.radius_neighbors(Q, er)
        rclf = RadiusNeighborsClassifier(er, max_neighbors=32,
                                         outlier_label=-1).fit(X, labels)
        rpred = rclf.predict(Q)
        est_s = time.perf_counter() - t0
        if any(read_launches().values()):
            raise AssertionError("estimators: a coarse kernel was launched")
        sk = ShardedKNN(X, k=ek)
        qd = torch.from_numpy(Q).to(dev)
        sd, si = sk.search(qd)
        want_reg = _weighted_targets(sd, torch.from_numpy(y).to(dev)[si],
                                     "distance", "l2", queries=qd).cpu().numpy()
        si = si.cpu().numpy()
        rd, ri, rc = base.radius_search(Q, er, max_neighbors=32)
        lab = np.where(ri == SENTINEL_IDX, -1, labels[np.clip(ri, 0, None)])
        want_cls = majority_vote(torch.from_numpy(lab), 10).numpy()
        want_cls = np.where(rc == 0, -1, want_cls)
        if not (np.allclose(reg, want_reg, rtol=1e-6, atol=0)
                and np.array_equal(graph[1], si.ravel())
                and np.array_equal(rnn[2], rc)
                and np.array_equal(np.sort(rnn[1], -1), np.sort(ri, -1))
                and np.array_equal(rpred, want_cls)):
            raise AssertionError("estimators differ from their ShardedKNN "
                                 "outputs")
        out["estimators"] = {"rows": X.shape[0], "queries": Q.shape[0],
                             "k": ek, "radius": er,
                             "radius_in_total": int(rc.sum()),
                             "equal_sharded": True, "seconds": est_s}
        del base, sk, nn, rclf
        emit(out)

    def live_oracle(q_dev, rows_np, ids_np, k):
        """(ids [Q, k], d [Q, k]) of the float64 oracle over ``rows_np``
        (in the order a fresh index would hold them), on the card."""
        rows_dev = torch.from_numpy(np.ascontiguousarray(rows_np)).to(dev)
        od, oi = f64_oracle(q_dev, rows_dev, k)
        del rows_dev
        return ids_np[oi.cpu().numpy()], od.cpu().numpy()

    def all_equal(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    def phase_index(S):
        """MutableIndex over the main rows (k=100, reserve 32): 4,096 rows
        inserted in three writes that cross ladder rungs, the whole reserve
        deleted (a 33rd delete refused), search_certified through K1
        bitwise a fresh index of the survivors and the f64 oracle,
        compaction, a background compaction under searches, search()'s
        recall."""
        from knn_tpu_torch.index import MutableIndex, MutationBudgetError

        k, n, dim = S["k"], S["n"], S["dim"]
        db = S["knn"].placement.db_host
        q = S["q_np"][:1024]
        out = {"phase": "index", "n": n, "dim": dim, "k": k, "reserve": 32,
               "queries": 1024, "nvidia_smi": smi}
        t0 = time.perf_counter()
        idx = MutableIndex(db, k=k, reserve=32)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        new = (np.random.default_rng(2).random(size=(4096, dim))
               * 128.0).astype(np.float32)
        rungs = []
        for lo, hi in ((0, 200), (200, 1100), (1100, 4096)):
            idx.insert(new[lo:hi], np.arange(n + lo, n + hi))
            rungs.append(idx.stats()["tail_capacity"])
        if rungs != [256, 2048, 4096]:
            raise AssertionError(f"index: tail rungs {rungs}")
        # the whole reserve: the nearest rows of the first queries, then
        # tail rows
        _, i0, _ = idx.search_certified(q[:64])
        dead = list(dict.fromkeys(int(x) for x in i0[:, 0]))[:24]
        dead += [n + j for j in range(0, 4096, 256)][: 32 - len(dead)]
        idx.delete(dead)
        try:
            idx.delete([n + 1])
        except MutationBudgetError as e:
            refusal = f"MutationBudgetError: {e}"
        else:
            raise AssertionError("index: a 33rd delete was not refused")
        rows = np.concatenate([db, new])
        ids = np.arange(n + 4096)
        live = ~np.isin(ids, dead)
        walls = {}
        splits = {}

        def certified(index, label, queries=q):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = index.search_certified(
                queries, timings=splits.setdefault(label, {}))
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            launches = nonzero_launches(read_launches())
            if launches != {"k1": 1}:
                raise AssertionError(f"index {label}: launches {launches}, "
                                     f"expected K1 once and nothing else")
            return res

        mutated = certified(idx, "mutated")
        t0 = time.perf_counter()
        fresh = MutableIndex(rows[live], ids[live], k=k, reserve=32)
        torch.cuda.synchronize()
        fresh_build_s = time.perf_counter() - t0
        if not all_equal(mutated[:2], certified(fresh, "fresh")[:2]):
            raise AssertionError("index: mutated differs from fresh")
        del fresh
        oi, od = live_oracle(S["q_dev"][:256], rows[live], ids[live], k)
        d_m, i_m = mutated[:2]
        recall = float(np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(i_m[:256], oi)]))
        rel = float(np.max(np.abs(d_m[:256] - od) / np.maximum(od, 1e-30)))
        if recall != 1.0 or not np.array_equal(i_m[:256], oi) or rel > 1e-12:
            raise AssertionError(f"index: oracle recall {recall}, rel {rel}")
        rep = idx.compact()
        if not all_equal(mutated[:2], certified(idx, "compacted")[:2]):
            raise AssertionError("index: the compacted index differs")
        # a background compaction while this thread searches: every search
        # across the swap returns the same answer, bitwise
        extra = new[:64] + np.float32(0.5)
        extra_ids = np.arange(n + 10_000, n + 10_064)
        idx.insert(extra, extra_ids)
        dead2 = [int(i_m[0, 0]), int(extra_ids[1])]
        idx.delete(dead2)
        q256 = q[:256]
        ref = idx.search_certified(q256)
        swaps0 = idx.stats()["compactions"]
        t0 = time.perf_counter()
        idx.start_compactor(interval_s=0.05)
        searches = 0
        while idx.stats()["compactions"] == swaps0 or searches < 3:
            if time.perf_counter() - t0 > 120:
                raise AssertionError("index: background compaction stalled")
            if not all_equal(ref[:2], idx.search_certified(q256)[:2]):
                raise AssertionError("index: a search across the swap "
                                     "differs")
            searches += 1
        idx.close()  # re-raises a failed compaction's error
        if not all_equal(ref[:2], idx.search_certified(q256)[:2]):
            raise AssertionError("index: the search after the swap differs")
        rows2 = np.concatenate([rows[live], extra])
        ids2 = np.concatenate([ids[live], extra_ids])
        live2 = ~np.isin(ids2, dead2)
        oi2, _ = live_oracle(S["q_dev"][:256], rows2[live2], ids2[live2], k)
        _, i_s = idx.search(q256)
        recall_search = float(np.mean([len(set(a) & set(b)) / k
                                       for a, b in zip(i_s, oi2)]))
        if not np.array_equal(ref[1], oi2):
            raise AssertionError("index: certified ids after the swap are "
                                 "not the oracle's")
        out["serving_frontend"] = index_frontend(S, idx, rows2[live2],
                                                 ids2[live2])
        out.update(
            fresh_build_s=fresh_build_s,
            tail_rungs=rungs, deleted=len(dead), delete_33_refused=refusal,
            certified_qps={key: q.shape[0] / w for key, w in walls.items()},
            walls_s=walls, host_split_s=splits,
            tail_refine_share=(splits["mutated"]["tail_refine"]
                               / sum(splits["mutated"].values())),
            fallback_queries=mutated[2]["fallback_queries"],
            index_stats=mutated[2]["index"], launches_per_call={"k1": 1},
            bitwise_fresh=True, bitwise_after_compact=True,
            oracle_queries=256, recall_at_k=recall, same_indices=True,
            max_rel_dist_err_f64=rel, compaction=rep,
            background={"searches_bitwise": searches,
                        "stats": idx.stats()},
            search_recall_at_k=recall_search)
        emit(out)

    def index_frontend(S, idx, rows, ids):
        """The mutated 1M index's serving frontend (MutableServingEngine,
        graphs on the 16..512 ladder) through a QueryQueue: reads,
        submit_write inserts and deletes, then a background compaction
        whose replacement engine captures its graphs while reads go on.
        Every read is bitwise the direct search of its padded batch at its
        epoch (the snapshot before the swap, or after it); the reads after
        the swap are bitwise a fresh index of the survivors."""
        from knn_tpu_torch import obs
        from knn_tpu_torch.index import MutableIndex
        from knn_tpu_torch.obs import audit
        from knn_tpu_torch.obs import names as mn
        from knn_tpu_torch.serving import QueryQueue, bucket_for
        from knn_tpu_torch.serving import engine as engine_mod

        n, k, dim = S["n"], S["k"], S["dim"]
        q = S["q_np"]
        blocks = [q[lo:lo + size] for lo, size in
                  zip(range(0, 2048, 128), (1, 7, 16, 33, 64, 100, 128, 5))]

        def direct(index, block):
            padded = np.zeros((bucket_for(eng.buckets, block.shape[0]), dim),
                              np.float32)
            padded[:block.shape[0]] = block
            d, i = index.search(padded)
            return d[:block.shape[0]], i[:block.shape[0]]

        eng = idx.serving_engine(min_bucket=16, max_bucket=512)
        _, warm_s = host_timed(eng.warmup)
        qq = QueryQueue(eng, max_wait_ms=1.0)
        reads0 = [qq.submit(b).result() for b in blocks]
        if not all(all_equal(r, direct(idx, b))
                   for r, b in zip(reads0, blocks)):
            raise AssertionError("index frontend: a read differs from the "
                                 "direct search")
        new = (np.random.default_rng(4).random(size=(256, dim))
               * 128.0).astype(np.float32)
        new_ids = np.arange(n + 30_000, n + 30_256)
        w1 = qq.submit_write("insert", vectors=new, ids=new_ids).result()
        gone = [int(reads0[0][1][0, 0]), int(new_ids[5])]
        w2 = qq.submit_write("delete", ids=gone).result()
        pre = [direct(idx, b) for b in blocks]
        epoch0 = idx.epoch
        # the lock-order hammer across the background compaction: the
        # index's lock and compaction lock, the placement's engines lock
        # (a direct search beside the queue takes it), the epoch's engine,
        # the queue, the SLO engine, the registry, one histogram and the
        # audit sampler; each request bitwise the direct search of its
        # batch at the snapshot before the swap or after it.  The reads
        # across the swap run while the locks are still instrumented, so
        # the build, the captures and the swap are recorded too.
        snap0 = idx._snapshot()

        def at_snapshot(cat):
            idx._snapshot = lambda: snap0
            try:
                return padded_search(idx.search, snap0.engine.buckets, cat)
            finally:
                del idx._snapshot

        reads, captures, t0 = [], [], time.perf_counter()

        def across_swap():
            """Reads through the queue until the swap and 3 rounds of the
            blocks: (block, result, epoch after the result, seconds)."""
            while idx.epoch == epoch0 or len(reads) < 3 * len(blocks):
                if time.perf_counter() - t0 > 120:
                    raise AssertionError("index frontend: compaction "
                                         "stalled")
                j = len(reads) % len(blocks)
                r = qq.submit(blocks[j]).result()
                reads.append((j, r, idx.epoch, time.perf_counter() - t0))

        def timed_capture(*a, **kw):
            """The replacement engine's captures, timed (start, end)."""
            t_c = time.perf_counter() - t0
            try:
                return real_capture(*a, **kw)
            finally:
                captures.append((t_c, time.perf_counter() - t0))

        real_capture = engine_mod.capture_graph
        engine_mod.capture_graph = timed_capture
        slo_eng = obs.reset_slo_engine()
        aud = audit.reset_auditor(rate=1.0)
        try:
            lock_out = lock_order_hammer(
                qq, eng, q[2048:2304],
                {"index": idx, "index_compact": (idx, "_compact_lock"),
                 "engines": (snap0.main, "_engines_lock"),
                 "engine": snap0.engine,
                 "engine_launch": (snap0.engine, "_launch_lock"),
                 "queue": qq, "slo": slo_eng,
                 "registry": obs.get_registry(),
                 "latency_hist": obs.histogram(
                     mn.SERVING_REQUEST_LATENCY, op="search"),
                 "audit": aud},
                [at_snapshot,
                 lambda cat: padded_search(idx.search, eng.buckets, cat)],
                calls=(qq.stats, slo_eng.evaluate,
                       lambda: idx.search(q[:8])),
                before=lambda: idx.start_compactor(interval_s=0.05),
                during=across_swap)
        finally:
            engine_mod.capture_graph = real_capture
            audit.reset_auditor()
            obs.reset_slo_engine()
        del snap0
        lock_out["elapsed_s"] = time.perf_counter() - t0
        # reads served on the old epoch while the compaction built and
        # captured: the epoch had not moved when their results came back;
        # of them, those that came back between the replacement engine's
        # first capture and its last
        before_swap = [t for _, _, e, t in reads if e == epoch0]
        after_swap = [t for _, _, e, t in reads if e != epoch0]
        in_captures = [t for t in before_swap
                       if captures and captures[0][0] < t < captures[-1][1]]
        if not before_swap or len(captures) != 6 or not in_captures:
            raise AssertionError(
                f"index frontend: {len(before_swap)} reads on the old "
                f"epoch, {len(in_captures)} of them during the "
                f"{len(captures)} captures {captures} (read times "
                f"{before_swap[-8:]})")
        reads = [(j, r) for j, r, _, _ in reads]
        idx.close()
        post = [direct(idx, b) for b in blocks]
        last = [qq.submit(b).result() for b in blocks]
        qq.close()
        fst = qq.stats()
        n_pre = sum(all_equal(r, pre[j]) for j, r in reads)
        n_post = sum(all_equal(r, post[j]) for j, r in reads)
        if any(not (all_equal(r, pre[j]) or all_equal(r, post[j]))
               for j, r in reads):
            raise AssertionError("index frontend: a read across the swap is "
                                 "neither epoch's direct search")
        if not all(all_equal(r, p) for r, p in zip(last, post)):
            raise AssertionError("index frontend: a read after the swap "
                                 "differs from the direct search")
        if fst["engine"]["compile_count"] != 6:
            raise AssertionError(
                f"index frontend: the swapped-in engine holds "
                f"{fst['engine']['compile_count']} graphs, not 6")
        # the survivors, as a fresh index holds them: the compacted
        # placement's row order
        surv = ~np.isin(ids, gone)
        rows_s = np.concatenate([rows[surv], new[~np.isin(new_ids, gone)]])
        ids_s = np.concatenate([ids[surv], new_ids[~np.isin(new_ids, gone)]])
        snap = idx._snapshot()
        if not np.array_equal(np.sort(snap.base_ids), np.sort(ids_s)):
            raise AssertionError("index frontend: the compacted ids are not "
                                 "the survivors")
        fresh = MutableIndex(snap.main._host_train(), snap.base_ids, k=k,
                             reserve=32)
        if not all(all_equal(p, direct(fresh, b))
                   for p, b in zip(post, blocks)):
            raise AssertionError("index frontend: reads after the swap "
                                 "differ from a fresh index of the survivors")
        del fresh
        oi, _ = live_oracle(S["q_dev"][:256], rows_s, ids_s, k)
        if not np.array_equal(idx.search_certified(q[:256])[1], oi):
            raise AssertionError("index frontend: certified ids after the "
                                 "writes are not the oracle's")
        return {"warmup_s": warm_s, "ladder": list(eng.buckets),
                "reads_before_writes": len(blocks),
                "writes": {"insert": w1, "delete": w2},
                "reads_across_swap": len(reads),
                "reads_before_swap": len(before_swap),
                "reads_before_swap_s": before_swap[-1],
                "last_read_before_to_first_after_s":
                    after_swap[0] - before_swap[-1],
                "reads_during_captures": len(in_captures),
                "captures_s": captures,
                "compaction_wall_s": idx.stats()["last_compaction"]["wall_s"],
                "reads_equal_pre_swap": n_pre, "reads_equal_post_swap": n_post,
                "pre_equals_post": all(all_equal(a, b)
                                       for a, b in zip(pre, post)),
                "bitwise_fresh_after_swap": True,
                "queue": {key: fst[key] for key in (
                    "requests", "dispatches", "writes", "latency_ms")},
                "engine_graphs_after_swap": fst["engine"]["compile_count"],
                "epoch": idx.epoch, "lock_order": lock_out}

    def phase_ivf(S):
        """IVFIndex at 131,072 x 128 on clustered data (362 blobs): the
        exact selector and the pallas selector through K2, K1, K5, K10 and
        K11, all bitwise; the nprobe = ncentroids anchor on the uniform
        main rows; an insert, delete and compact cycle."""
        from knn_tpu_torch.data.datasets import make_blobs
        from knn_tpu_torch.ivf import IVFIndex
        from knn_tpu_torch.ops.refine import refine_shared_exact

        n, k = 131072, S["k"]
        feats, _ = make_blobs(n + 128, S["dim"], 362, seed=0)
        rows, q = feats[:n], feats[n:]
        q_dev = torch.from_numpy(q).to(dev)
        out = {"phase": "ivf", "n": n, "dim": S["dim"], "k": k,
               "queries": 128, "nvidia_smi": smi}
        t0 = time.perf_counter()
        idx = IVFIndex(rows, k=k)
        out["train_s"] = time.perf_counter() - t0
        oi, od = live_oracle(q_dev, rows, np.arange(n), k)
        combos = [("exact", None, None)] + [
            ("pallas", prec, kern) for prec in ("highest", "bf16x3", "int8")
            for kern in ("tiled", "streaming", "fused")]
        # the kernel each pallas combination's launches are counted under
        own = {("highest", "tiled"): "tiled_highest",
               ("highest", "streaming"): "streaming_highest",
               ("highest", "fused"): "fused_highest",
               ("bf16x3", "tiled"): "k1", ("bf16x3", "streaming"): "k10",
               ("bf16x3", "fused"): "k11", ("int8", "tiled"): "tiled_int8",
               ("int8", "streaming"): "streaming_int8",
               ("int8", "fused"): "fused_int8"}
        runs, ref = {}, None
        for sel, prec, kern in combos:
            kw = {"selector": sel}
            if sel == "pallas":
                kw.update(precision=prec, kernel=kern)
            label = sel if sel == "exact" else f"{prec}_{kern}"
            timings = {}
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d, i, st = idx.search_certified(q, timings=timings, **kw)
            wall = time.perf_counter() - t0
            launches = nonzero_launches(read_launches())
            want = {} if sel == "exact" else {own[(prec, kern)]: st["groups"]}
            if launches != want:
                raise AssertionError(f"ivf {label}: launches {launches}, "
                                     f"expected {want}")
            if ref is None:
                ref = (d, i)
                recall = float(np.mean([len(set(a) & set(b)) / k
                                        for a, b in zip(i, oi)]))
                rel = float(np.max(np.abs(d - od) / np.maximum(od, 1e-30)))
                if recall != 1.0 or not np.array_equal(i, oi) or rel > 1e-12:
                    raise AssertionError(
                        f"ivf: oracle recall {recall}, rel {rel}")
            elif not all_equal(ref, (d, i)):
                raise AssertionError(f"ivf {label}: differs from exact")
            runs[label] = {
                "wall_s": wall, "qps": q.shape[0] / wall,
                "launches": launches, "host_split_s": timings,
                **{key: st[key] for key in (
                    "groups", "certified_queries", "fallback_queries",
                    "probe_fraction", "bytes_streamed_ratio",
                    "recall_at_k")}}
        # one block's placement alone (the pallas selector places each
        # probe group's block afresh): the device step's placement share
        from knn_tpu_torch import ShardedKNN

        snap = idx._snapshot()
        probes, _, _ = idx._probe(q[:1].astype(np.float64), snap, idx.nprobe)
        block = snap.all_rows[snap.positions_for(tuple(probes[0].tolist()))]
        _, place_s = host_timed(lambda: ShardedKNN(block, k=k))
        # the anchor: nprobe = ncentroids on the uniform main rows is
        # float64 brute force, bitwise (half the clustered set's rows and
        # 32 queries: the campaign phase took the seconds of the rest;
        # 256 lists of ~256 rows where 131,072 rows had 362 of ~362, and
        # with every list probed the answer does not depend on the count)
        n_anchor = n // 2
        uni = np.ascontiguousarray(S["knn"].placement.db_host[:n_anchor])
        qu = S["q_np"][:32]
        t0 = time.perf_counter()
        uidx = IVFIndex(uni, k=k)
        anchor_train_s = time.perf_counter() - t0
        d_a, i_a, st_a = uidx.search_certified(qu, nprobe=uidx.ncentroids)
        t0 = time.perf_counter()
        if not all_equal((d_a, i_a), refine_shared_exact(
                uni, qu, np.arange(n_anchor, dtype=np.int64), k)):
            raise AssertionError("ivf: nprobe = ncentroids is not brute "
                                 "force bitwise")
        brute_s = time.perf_counter() - t0
        # uniform data at the default nprobe: the residual bound fails
        # and every query is repaired on the host (16 queries: ~0.25 s each)
        timings = {}
        _, _, st_u = uidx.search_certified(qu[:16], timings=timings)
        del uidx
        # one insert, delete and compact cycle stays exact
        extra = (rows[:256] + np.float32(0.25)).astype(np.float32)
        idx.insert(extra, np.arange(n, n + 256))
        gone = [int(x) for x in ref[1][:4, 0]] + [n + 3]
        idx.delete(gone)
        rows2 = np.concatenate([rows, extra])
        ids2 = np.arange(n + 256)
        live2 = ~np.isin(ids2, gone)
        oi2, _ = live_oracle(q_dev, rows2[live2], ids2[live2], k)
        before = idx.search_certified(q)
        if not np.array_equal(before[1], oi2):
            raise AssertionError("ivf: mutated ids are not the oracle's")
        rep = idx.compact()
        after = idx.search_certified(q, selector="pallas", precision="bf16x3")
        if not all_equal(before[:2], after[:2]):
            raise AssertionError("ivf: the compacted index differs")
        # the serving frontend through a QueryQueue (K1 per probe group),
        # bitwise the direct search_certified, every served answer audited
        # (rate 1.0; the budget holds the four requests' rows, so none
        # drops) and the drift sketch fed by every search
        from knn_tpu_torch import obs
        from knn_tpu_torch.obs import audit
        from knn_tpu_torch.obs.drift import QueryDriftMonitor
        from knn_tpu_torch.serving import QueryQueue

        t_step = time.perf_counter()
        obs.reset(enabled=True)
        ieng = idx.serving_engine(buckets=(8, 16), selector="pallas",
                                  precision="bf16x3")
        n_live = idx.stats()["live_rows"]
        aud = audit.reset_auditor(rate=1.0, budget_rows_s=64.0 * n_live)
        reset_launches()
        try:
            with QueryQueue(ieng, max_wait_ms=1.0) as qq:
                futs = [qq.submit(q[lo:lo + 16]) for lo in range(0, 64, 16)]
                served = [f.result() for f in futs]
                ivf_q = qq.stats()
            ivf_launches = nonzero_launches(read_launches())
            if not aud.drain(timeout=600):
                raise AssertionError("ivf frontend: the audit did not drain")
            ivf_audit = aud.summary()
        finally:
            audit.reset_auditor()
        if set(ivf_launches) != {"k1"}:
            raise AssertionError(f"ivf frontend: launches {ivf_launches}")
        if (ivf_audit["replayed_queries"] != 64 or ivf_audit["dropped"]
                or ivf_audit["deficient_queries"] != 0
                or ivf_audit["last_recall_at_k"] != 1.0
                or obs.histogram(obs.names.AUDIT_RECALL, tenant="-")
                .summary().get("min") != 1.0):
            raise AssertionError(f"ivf frontend audit: {ivf_audit}")
        audit_s = time.perf_counter() - t_step
        direct = idx.search_certified(q[:64], selector="pallas",
                                      precision="bf16x3")
        if not all_equal([np.concatenate(x) for x in zip(*served)],
                         direct[:2]):
            raise AssertionError("ivf frontend: served reads differ from "
                                 "the direct search_certified")
        # drift: the index's sketch since the compaction (held-out rows of
        # the same blobs) against a monitor of the same baseline fed the
        # same queries scaled x4 through the same search
        t_step = time.perf_counter()
        held = idx.stats()["drift"]
        b64 = idx._base.astype(np.float64)
        kept, idx._drift = idx._drift, QueryDriftMonitor(
            train_norms=np.sqrt(np.einsum("nd,nd->n", b64, b64)),
            assign_baseline=idx._base_counts)
        try:
            idx.search_certified(q[:16] * np.float32(4.0),
                                 selector="pallas", precision="bf16x3")
            scaled = idx.stats()["drift"]
        finally:
            idx._drift = kept
        if not held["norm_psi"] < scaled["norm_psi"]:
            raise AssertionError(f"ivf drift: held-out {held} vs x4 "
                                 f"{scaled}")
        drift_s = time.perf_counter() - t_step
        out.update(
            ncentroids=idx.ncentroids, nprobe=idx.nprobe, runs=runs,
            bitwise_all_combinations=True, recall_at_k=recall,
            same_indices=True, max_rel_dist_err_f64=rel,
            block_rows=int(block.shape[0]), block_placement_s=place_s,
            anchor={"rows": n_anchor, "queries": 32,
                    "train_s": anchor_train_s,
                    "ncentroids": st_a["ncentroids"],
                    "probe_fraction": st_a["probe_fraction"],
                    "bitwise_brute_force": True, "brute_force_s": brute_s},
            uniform_default_nprobe={
                key: st_u[key] for key in ("queries", "fallback_queries",
                                           "probe_fraction", "wall_s")},
            uniform_host_split_s=timings,
            mutation={"inserted": 256, "deleted": len(gone),
                      "oracle_ids": True, "bitwise_after_compact": True,
                      "compaction": rep},
            serving_frontend={"requests": 4, "queries": 64,
                              "k1_launches": ivf_launches["k1"],
                              "dispatches": ivf_q["dispatches"],
                              "latency_ms": ivf_q["latency_ms"],
                              "bitwise_direct": True,
                              "audit": ivf_audit, "audit_elapsed_s": audit_s},
            drift={"held_out": held, "scaled_x4": scaled,
                   "elapsed_s": drift_s})
        emit(out)

    def hosttier_program(S):
        """The main rows behind a 128 MiB budget: the host-RAM tier (made
        once, shared by the hosttier and join phases)."""
        from knn_tpu_torch import ShardedKNN

        if "tier" not in S:
            t0 = time.perf_counter()
            S["tier"] = ShardedKNN(S["db_np"], k=S["k"],
                                   hbm_budget_bytes=128 << 20)
            S["tier_setup_s"] = time.perf_counter() - t0
        return S["tier"]

    def phase_hosttier(S):
        """The host-RAM tier on the main draw: 1M x 128 rows behind a 128
        MiB budget, k=100, 4,096 queries.  The plan's sweeps (hbm.n_sweeps,
        4) equal hosttier_stats()'s, the HOSTTIER_SWEEPS count and the
        sweeps run; one dispatch shape; recall@100 = 1.0 against the f64
        oracle on the first 256 queries; against the resident search,
        bitwise or, where not, the indices wherever the resident k-th and
        (k+1)-th distances are separated by more than 64 eps_f32 (|q|^2 +
        max |t|^2) and every distance within that bound; the tier holds
        its `depth` segment buffers and a call adds at most one budget
        besides the queries and the carry, below the corpus's bytes in
        all; no coarse kernel;
        every resident-only entry refuses the tier by name.  Times: the
        call against the resident search's, each sweep, the copies' GB/s."""
        from knn_tpu_torch import obs
        from knn_tpu_torch.analysis import hbm
        from knn_tpu_torch.index import MutableIndex
        from knn_tpu_torch.index.artifact import MutationUnsupportedError
        from knn_tpu_torch.obs import names as mn
        from knn_tpu_torch.serving import ServingEngine

        knn, k, n, dim, q_np = S["knn"], S["k"], S["n"], S["dim"], S["q_np"]
        n_or, budget = S["n_or"], 128 << 20
        tier = hosttier_program(S)
        plan = tier.hosttier_stats()
        want = hbm.n_sweeps(n, dim, budget)
        corpus = hbm.placement_bytes(n, dim)
        if plan["sweeps"] != want or want != 4:
            raise AssertionError(f"hosttier plan {plan}, n_sweeps {want}")
        # the device memory the tier holds: its first call makes the
        # `depth` segment buffers it keeps (a matmul first, so a process
        # that ran no earlier phase has its cuBLAS workspace already)
        torch.mm(S["q_dev"][:8], S["q_dev"][:8].T)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        wall_first = host_timed(lambda: tier.search(q_np))[1]
        first_added = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base
        buffers = tier.hosttier_stats()["last_search"]["device_buffer_bytes"]
        reset_launches()
        sweeps0 = obs.counter(mn.HOSTTIER_SWEEPS).get()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (d, i), wall = host_timed(lambda: tier.search(q_np))
        peak = torch.cuda.max_memory_allocated() - base
        last = tier.hosttier_stats()["last_search"]
        counted = obs.counter(mn.HOSTTIER_SWEEPS).get() - sweeps0
        launches = nonzero_launches(read_launches())
        shapes = tier.compile_cache_stats()["distinct_shapes"]
        if last["sweeps"] != want or counted != want or shapes != 1 \
                or launches:
            raise AssertionError(
                f"hosttier: sweeps {last['sweeps']}, counted {counted}, "
                f"planned {want}, shapes {shapes}, launches {launches}")
        # the tier's contract: `depth` segment buffers held, and a call
        # adds at most one budget besides the queries and the top-k carry
        # (128 B a kept neighbour: the carry, a sweep's top-k, their merge)
        allowance = budget + q_np.nbytes + 128 * q_np.shape[0] * k
        seg_bytes = plan["segment_rows"] * dim * 4
        if held != buffers or buffers != plan["depth"] * seg_bytes \
                or peak > allowance or buffers + peak >= corpus:
            raise AssertionError(
                f"hosttier: holds {held} B (buffers {buffers} B, "
                f"{plan['depth']} x {seg_bytes}), a call adds {peak} B "
                f"(allowed {allowance}), the corpus is {corpus} B")
        _, wall_warm = host_timed(lambda: tier.search(q_np))
        warm_last = tier.hosttier_stats()["last_search"]
        (dr, ir), wall_res = host_timed(lambda: knn.search(q_np, k=k + 1))
        _, wall_res_warm = host_timed(lambda: knn.search(q_np, k=k + 1))
        d, i = d.cpu().numpy(), i.cpu().numpy()
        dr, ir = dr.cpu().numpy(), ir.cpu().numpy()
        bitwise = bool(np.array_equal(d, dr[:, :k])
                       and np.array_equal(i, ir[:, :k]))
        q64 = q_np.astype(np.float64)
        tol = 64 * float(np.finfo(np.float32).eps) * (
            (q64 ** 2).sum(-1) + float(knn.placement.db_norm_max))
        dist_ratio = float((np.abs(d.astype(np.float64) - dr[:, :k])
                            / tol[:, None]).max())
        sep = (dr[:, k].astype(np.float64) - dr[:, k - 1]) > tol
        sets_equal = all(set(a) == set(b) for a, b, s in
                         zip(i, ir[:, :k], sep) if s)
        if dist_ratio > 1.0 or not sets_equal:
            raise AssertionError(
                f"hosttier vs resident: distance error / bound "
                f"{dist_ratio}, index sets equal where separated "
                f"{sets_equal} ({int(sep.sum())} queries)")
        if "oi" not in S:
            od, oi = f64_oracle(S["q_dev"][:n_or], knn.placement.db, k)
            S["od"], S["oi"] = od.cpu().numpy(), oi.cpu().numpy()
        recall = float(np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(i[:n_or], S["oi"])]))
        if recall != 1.0:
            raise AssertionError(f"hosttier recall@{k} {recall}")
        refused = {}
        for what, call in (
                ("search_certified", lambda: tier.search_certified(q_np[:4])),
                ("predict", lambda: tier.predict(q_np[:4])),
                ("radius_search", lambda: tier.radius_search(
                    q_np[:4], 1.0, max_neighbors=3)),
                ("search_bucketed", lambda: tier.search_bucketed(q_np[:4])),
                ("ServingEngine", lambda: ServingEngine(tier))):
            try:
                call()
            except ValueError as e:
                if "host-RAM shard tier" not in str(e):
                    raise
                refused[what] = True
            else:
                raise AssertionError(f"hosttier: {what} was not refused")
        mi = MutableIndex(S["db_np"], k=k, hbm_budget_bytes=budget)
        try:
            mi.insert(q_np[:2], [n, n + 1])
        except MutationUnsupportedError:
            refused["MutableIndex.insert"] = True
        else:
            raise AssertionError("hosttier: MutableIndex.insert was not "
                                 "refused")
        del mi
        lock_out = tier_lock_order(tier, q_np[:256])
        emit({"phase": "hosttier", "n": n, "dim": dim, "queries": q_np.shape[0],
              "k": k, "budget_bytes": budget, "corpus_bytes": corpus,
              "plan": {key: plan[key] for key in (
                  "segment_rows", "bytes_per_sweep", "depth", "sweeps")},
              "segments": tier._host_tier["segments"],
              "sweeps_run": last["sweeps"], "sweeps_counted": counted,
              "dispatch_shapes": shapes, "setup_s": S["tier_setup_s"],
              "wall_s_first_call": wall_first, "wall_s": wall,
              "wall_s_third_call": wall_warm,
              "resident_wall_s": wall_res,
              "resident_wall_s_second_call": wall_res_warm,
              "sweep_walls_s": warm_last["sweep_walls_s"],
              "h2d_s": warm_last["h2d_s"], "h2d_gbps": warm_last["h2d_gbps"],
              "held_bytes": held, "first_call_added_bytes": first_added,
              "peak_added_bytes": peak, "peak_allowed_bytes": allowance,
              "card_bytes_over_budget": (held + peak) / budget,
              "card_bytes_over_corpus": (held + peak) / corpus,
              "bitwise_resident": bitwise,
              "dist_err_over_bound": dist_ratio,
              "separated_queries": int(sep.sum()),
              "sets_equal_where_separated": True,
              "recall_at_k": recall, "oracle_queries": n_or,
              "refused": refused, "lock_order": lock_out,
              "nvidia_smi": smi})

    def phase_join(S):
        """knn_join on the main placement: A = 16,384 rows, superblocks of
        4,096 — the stream bitwise the looped search at that block shape,
        the certified join bitwise the looped search_certified, K1 once a
        superblock."""
        from knn_tpu_torch.join import knn_join

        knn, k = S["knn"], S["k"]
        a = (np.random.default_rng(3).random(size=(16384, S["dim"]))
             * 128.0).astype(np.float32)
        out = {"phase": "join", "n": S["n"], "rows": a.shape[0], "k": k,
               "superblock_rows": 4096, "nvidia_smi": smi}
        reset_launches()
        torch.cuda.synchronize()
        d, i, st = knn_join(knn, a, mode="stream", superblock_rows=4096)
        if nonzero_launches(read_launches()):
            raise AssertionError("join stream launched a coarse kernel")
        looped = [tuple(t.cpu().numpy() for t in knn.search(a[lo:lo + 4096]))
                  for lo in range(0, a.shape[0], 4096)]
        if not all_equal((d, i), [np.concatenate(x) for x in zip(*looped)]):
            raise AssertionError("join stream differs from the looped search")
        # the certified join: the main path's certified search per block
        reset_launches()
        torch.cuda.synchronize()
        dc, ic, stc = knn_join(knn, a, mode="certified", superblock_rows=4096)
        launches = nonzero_launches(read_launches())
        if launches != {"k1": 4}:
            raise AssertionError(f"join certified: launches {launches}")
        looped = [knn.search_certified(a[lo:lo + 4096])[:2]
                  for lo in range(0, a.shape[0], 4096)]
        if not all_equal((dc, ic), [np.concatenate(x) for x in zip(*looped)]):
            raise AssertionError("join certified differs from the looped "
                                 "search_certified")
        agree = float((i == ic).mean())
        # the tiered join: the same rows against the main rows behind a
        # 128 MiB budget, in both orders, bitwise the looped host-tier
        # search at the same block shape
        tier = hosttier_program(S)
        tiered = {}
        for sb, order in ((4096, "db_major"), (16384, "query_major")):
            reset_launches()
            torch.cuda.synchronize()
            dt, it, stt = knn_join(tier, a, mode="stream", superblock_rows=sb)
            if nonzero_launches(read_launches()):
                raise AssertionError("the tiered join launched a coarse "
                                     "kernel")
            segs = len(tier._host_tier["segments"])
            blocks = -(-a.shape[0] // sb)
            if (stt["order"] != order or stt["db_segments"] != segs
                    or stt["superblocks"] != blocks
                    or stt["dispatches"] != segs * blocks):
                raise AssertionError(f"tiered join {order}: {stt}")
            looped = [tuple(t.cpu().numpy() for t in tier.search(a[lo:lo + sb]))
                      for lo in range(0, a.shape[0], sb)]
            if not all_equal((dt, it), [np.concatenate(x)
                                        for x in zip(*looped)]):
                raise AssertionError(f"tiered join {order} differs from the "
                                     f"looped host-tier search")
            tiered[order] = {key: stt[key] for key in (
                "rows_per_s", "overlap_ratio", "wall_s", "superblocks",
                "db_segments", "dispatches", "superblock_rows")}
            tiered[order].update(
                bitwise_looped=True,
                h2d_bytes_planned=stt["plan"]["h2d_bytes"][order],
                ids_equal_resident_stream_share=float((it == i).mean()))
        out.update(tiered=tiered)
        out.update(
            stream={key: st[key] for key in (
                "rows_per_s", "overlap_ratio", "wall_s", "superblocks",
                "dispatches", "depth", "order")},
            certified={key: stc[key] for key in (
                "rows_per_s", "wall_s", "superblocks", "dispatches",
                "fallback_queries")},
            certified_launches=launches, stream_bitwise_looped=True,
            certified_bitwise_looped=True,
            stream_ids_equal_certified_share=agree)
        emit(out)

    def serving_audit(S, eng, reqs):
        """The audit sampler, the SLO engine, the flight recorder and the
        waterfalls on the main engine's graphs.  (1) the oracle's host
        rate: one float64 ``refine_shared_exact`` pass over the placed
        rows for 4 queries (rows/s, peak traced host bytes); (2) a clean
        run: 32 requests of 1-8 rows with chosen trace ids at rate 1.0 and
        a budget of the measured rate (at least the largest request's
        rows, so a record can replay): replayed + dropped == sampled,
        replayed > 0, recall 1.0, 0 deficient, every request's waterfall
        complete, ``stats()`` with ``slo``, ``slowest_requests`` and
        ``quality``; (3) the bench trace at the default budget: every
        request over 5 rows dropped under ``budget``; (4) a seeded fault
        on one tenant under 1 s / 4 s windows (the real clock, waited
        out): one ``audit_recall:<tenant>`` firing transition, one
        bundle, read back by ``read_bundle``, ``cli waterfall --bundle``
        and ``cli audit --bundle``."""
        import contextlib
        import io
        import shutil
        import tracemalloc

        from knn_tpu_torch import obs
        from knn_tpu_torch.cli import main as cli_main
        from knn_tpu_torch.obs import audit, blackbox, waterfall
        from knn_tpu_torch.obs import names as mn
        from knn_tpu_torch.ops.refine import refine_shared_exact

        knn, k, n, q_np = S["knn"], S["k"], S["n"], S["q_np"]
        out = {}
        scored = []

        def count_scored(rec):  # the fault seam as a counter: identity
            scored.append((rec.trace_id, int(rec.queries.shape[0])))
            return rec

        # (1) the oracle's host rate and peak host bytes
        t_step = time.perf_counter()
        db_host = knn._host_train()
        tracemalloc.start()
        t0 = time.perf_counter()
        refine_shared_exact(db_host, q_np[:4], np.arange(n), k)
        rate_s = time.perf_counter() - t0
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        rate = 4 * n / rate_s
        budget = max(rate, 8.0 * n)
        emit({"phase": "serving_audit_rate", "oracle_queries": 4,
              "rows": n, "seconds": rate_s, "rows_per_s": rate,
              "peak_traced_host_bytes": peak, "budget_rows_s": budget,
              "nvidia_smi": smi, "elapsed_s": time.perf_counter() - t_step})

        # (2) the clean run
        t_step = time.perf_counter()
        obs.reset(enabled=True)
        obs.reset_event_log()
        obs.reset_slo_engine()
        a = audit.reset_auditor(rate=1.0, budget_rows_s=budget)
        audit.set_fault(count_scored)
        rng = np.random.default_rng(13)
        sizes = rng.integers(1, 9, 32)
        starts = rng.integers(0, q_np.shape[0] - 8, 32)
        tids = [f"audit-clean-{j:02d}" for j in range(32)]
        try:
            for tid, lo, size in zip(tids, starts, sizes):
                eng.submit(q_np[lo:lo + size], trace_id=tid).result()
            if not a.drain(timeout=600):
                raise AssertionError("audit: the clean run did not drain")
        finally:
            audit.clear_fault()
        summ = a.summary()
        dropped = sum(summ["dropped"].values())
        rows_of = dict(zip(tids, sizes.tolist()))
        recall_min = obs.histogram(mn.AUDIT_RECALL, tenant="-").summary()
        err = obs.histogram(mn.AUDIT_DISTANCE_ERROR, tenant="-").summary()
        if (summ["sampled_requests"] != 32
                or len(scored) + dropped != 32 or not scored
                or summ["replayed_queries"]
                != sum(rows_of[t] for t, _ in scored)
                or summ["deficient_queries"] != 0
                or recall_min.get("min") != 1.0
                or set(summ["dropped"]) - {"budget"}):
            raise AssertionError(f"audit clean run: {summ}, "
                                 f"{len(scored)} scored")
        events = obs.get_event_log().recent()
        wfs = waterfall.reconstruct(events)
        bad = [t for t in tids if t not in wfs or not wfs[t]["complete"]]
        if bad:
            raise AssertionError(f"audit clean run: {len(bad)} requests "
                                 f"do not rebuild within tolerance: "
                                 f"{[wfs.get(t) for t in bad[:2]]}")
        st = eng.stats()
        if not ({"slo", "slowest_requests", "quality"} <= set(st)
                and st["quality"]["replayed_queries"]
                == summ["replayed_queries"]):
            raise AssertionError(f"serving stats sections: {sorted(st)}")
        agg = waterfall.attribute({t: wfs[t] for t in tids})
        seg_ms = {name: float(np.mean([
            next(x["dur_s"] for x in wfs[t]["segments"] if x["name"] == name)
            for t in tids]) * 1e3) for name in waterfall.DIRECT_SEGMENTS}
        out["clean"] = {
            "requests": 32, "rows": int(sizes.sum()), "summary": summ,
            "replayed_requests": len(scored), "dropped_requests": dropped,
            "recall_min": recall_min.get("min"),
            "max_distance_rel_error": err.get("max"),
            "waterfalls_complete": len(tids),
            "max_gap_over_tolerance": max(
                max(wfs[t]["unattributed_s"], wfs[t]["overlap_s"])
                / wfs[t]["tolerance_s"] for t in tids),
            "mean_segment_ms": seg_ms,
            "p99_dominant": (agg["overall"]["p99_band"] or {}).get(
                "dominant"),
            "stats_sections": ["quality", "slo", "slowest_requests"],
            "elapsed_s": time.perf_counter() - t_step}

        # (3) the bench trace at the default budget
        t_step = time.perf_counter()
        a = audit.reset_auditor(rate=1.0)
        scored.clear()
        audit.set_fault(count_scored)
        try:
            for j, req in enumerate(reqs):
                eng.submit(req, trace_id=f"audit-trace-{j:02d}").result()
            if not a.drain(timeout=600):
                raise AssertionError("audit: the trace did not drain")
        finally:
            audit.clear_fault()
        summ = a.summary()
        over = sum(1 for r in reqs if r.shape[0] * n > a.summary()[
            "budget_rows_s"])
        dropped = sum(summ["dropped"].values())
        if (summ["sampled_requests"] != len(reqs)
                or len(scored) + dropped != len(reqs)
                or summ["dropped"].get("budget", 0) < over
                or set(summ["dropped"]) - {"budget"}
                or summ["deficient_queries"] != 0):
            raise AssertionError(f"audit trace: {summ}, over budget {over}")
        out["trace_default_budget"] = {
            "requests": len(reqs), "over_budget_requests": over,
            "summary": summ, "replayed_requests": len(scored),
            "elapsed_s": time.perf_counter() - t_step}

        # (4) a seeded fault on one tenant: one transition, one bundle
        t_step = time.perf_counter()
        pm_dir = tempfile.mkdtemp(prefix="chip_smoke_pm_")
        tenant = "acme"
        try:
            obs.reset(enabled=True)
            obs.reset_event_log()
            eng_slo = obs.reset_slo_engine(windows=(("fast", 1.0),
                                                    ("slow", 4.0)))
            blackbox.configure(postmortem_dir=pm_dir, keep=8)
            a = audit.reset_auditor(rate=1.0, budget_rows_s=budget)

            def shift_ids(rec):  # every served id moved to the next row
                rec.served_ids = (np.asarray(rec.served_ids) + 1) % n
                return rec

            audit.set_fault(shift_ids)
            t_base = time.monotonic()
            eng_slo.evaluate()
            try:
                for j in range(3):
                    eng.submit(q_np[j:j + 1], tenant=tenant,
                               trace_id=f"audit-fault-{j}").result()
                if not a.drain(timeout=600):
                    raise AssertionError("audit: the faulted run did not "
                                         "drain")
            finally:
                audit.clear_fault()
            # the slow window confirms once 2 s (half of 4 s) have passed
            time.sleep(max(0.0, 2.5 - (time.monotonic() - t_base)))
            rep = eng_slo.evaluate()
            eng_slo.evaluate()  # still breached: no second transition
            firing = [(e["objective"], e.get("tenant"))
                      for e in obs.get_event_log().recent()
                      if e.get("name") == "slo.alert"
                      and e.get("state") == "firing"]
            bundles = sorted(os.listdir(pm_dir))
            if (firing != [(f"audit_recall:{tenant}", tenant)]
                    or rep["breached"] != [f"audit_recall:{tenant}"]
                    or len(bundles) != 1):
                raise AssertionError(f"audit breach: firing {firing}, "
                                     f"breached {rep['breached']}, "
                                     f"bundles {bundles}")
            path = os.path.join(pm_dir, bundles[0])
            payload = blackbox.read_bundle(path)
            ev = payload["audit"]
            if not (ev["failures"] and ev["summary"]["deficient_queries"]
                    == 3 and payload["objective"]
                    == f"audit_recall:{tenant}"
                    and payload["env"]["slo_windows"]
                    == [["fast", 1.0], ["slow", 4.0]]):
                raise AssertionError(f"audit bundle: {ev['summary']}")
            rcs = {}
            for cmd in ("waterfall", "audit"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rcs[cmd] = cli_main([cmd, "--bundle", path])
                rcs[cmd + "_lines"] = len(buf.getvalue().splitlines())
                if cmd == "waterfall" and "audit-fault-0" not in \
                        buf.getvalue():
                    raise AssertionError("cli waterfall --bundle: no "
                                         "waterfall of the faulted request")
            if rcs["waterfall"] != 0 or rcs["audit"] != 2:
                raise AssertionError(f"cli on the bundle: {rcs}")
            out["breach"] = {
                "tenant": tenant, "firing": firing,
                "bundles": len(bundles),
                "bundle_bytes": os.path.getsize(path),
                "bundle_events": len(payload["events"]),
                "deficient_queries": ev["summary"]["deficient_queries"],
                "cli_exit": rcs,
                "elapsed_s": time.perf_counter() - t_step}
        finally:
            audit.clear_fault()
            audit.reset_auditor()
            blackbox.configure()
            obs.reset_slo_engine()
            shutil.rmtree(pm_dir, ignore_errors=True)
        return out

    def padded_search(search, buckets, block):
        """``search`` of ``block`` padded to its rung, as host arrays of the
        block's rows."""
        from knn_tpu_torch.serving import bucket_for

        padded = np.zeros((bucket_for(buckets, block.shape[0]),
                           block.shape[1]), np.float32)
        padded[:block.shape[0]] = block
        return tuple((t.cpu().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t))[:block.shape[0]]
                     for t in search(padded))

    def serving_lock_order(S, eng):
        """The lock-order hammer on the warm CUDA-graph engine at the main
        shape: its _lock and _launch_lock, a QueryQueue's _cond and its
        admission controller, the SLO engine, the registry, one registry
        histogram and the audit sampler (rate 1.0) instrumented; 8 threads
        x 4 rounds of one 1-8-row request; every request bitwise the
        eager search of its coalesced batch, one graph replay per queue
        batch and no capture.  The engine's program is the exact search (divergence
        27), so no coarse kernel launches."""
        from knn_tpu_torch import obs
        from knn_tpu_torch.obs import audit
        from knn_tpu_torch.obs import names as mn
        from knn_tpu_torch.serving import AdmissionConfig, QueryQueue

        t_step = time.perf_counter()
        knn = S["knn"]
        slo_eng = obs.reset_slo_engine()
        aud = audit.reset_auditor(rate=1.0)
        hist = obs.histogram(mn.SERVING_REQUEST_LATENCY, op="search")
        st0 = eng.stats()
        reset_launches()
        try:
            with QueryQueue(eng, max_wait_ms=1.0, admission=AdmissionConfig(
                    max_depth=4096)) as hq:
                out = lock_order_hammer(
                    hq, eng, S["q_np"][:256],
                    {"engine": eng, "engine_launch": (eng, "_launch_lock"),
                     "queue": hq, "admission": hq._ctrl, "slo": slo_eng,
                     "registry": obs.get_registry(), "latency_hist": hist,
                     "audit": aud},
                    [lambda cat: padded_search(knn.search, eng.buckets,
                                               cat)],
                    calls=(hq.stats, slo_eng.evaluate))
                q_disp = hq.stats()["dispatches"]
        finally:
            audit.reset_auditor()
            obs.reset_slo_engine()
        launches = nonzero_launches(read_launches())
        st1 = eng.stats()
        replays = (sum(st1["per_bucket_dispatches"].values())
                   - sum(st0["per_bucket_dispatches"].values()))
        if (replays != q_disp or q_disp != out["batches"] or launches
                or st1["compile_count"] != st0["compile_count"]):
            raise AssertionError(
                f"serving lock order: {replays} graph replays for "
                f"{q_disp} queue dispatches ({out['batches']} batches), "
                f"captures {st0['compile_count']} -> "
                f"{st1['compile_count']}, coarse launches {launches}")
        out.update(graph_replays=replays, coarse_launches=launches,
                   elapsed_s=time.perf_counter() - t_step)
        return out

    def phase_serving(S):
        """The serving stack at the main shape (1M x 128, k=100): a
        ServingEngine on the main placement with the JAX package's bench
        ladder (16..512, bench.py:805-818) captures one CUDA graph per rung
        in warmup, holding no more than its graph pool and 128 MiB; a
        48-request log-uniform trace (seed 42) replayed at depth 2 through
        the graphs, twice through an aot=False engine, then through the
        graphs again (which captures nothing), every request bitwise an
        eager search of its padded batch and the f64 oracle's neighbours
        on the trace's first 256 rows; predict through the engine against
        ShardedKNN.predict; 256 concurrent 1-8-row requests through a
        QueryQueue, scattered bitwise; a short knee sweep; a certified
        stream of 4,096 queries in 1,024-query segments resumed after two,
        bitwise the direct search_certified."""
        import dataclasses
        import shutil

        from knn_tpu_torch import ShardedKNN, loadgen
        from knn_tpu_torch.serving import (QueryQueue, ServingEngine,
                                           bucket_for, latency_summary)
        from knn_tpu_torch.streaming import streaming_certified_knn

        knn, k, n, q_np = S["knn"], S["k"], S["n"], S["q_np"]
        out = {"phase": "serving", "n": n, "dim": S["dim"], "k": k,
               "nvidia_smi": smi}
        # the allocator's free cached blocks (earlier phases') go first, so
        # the reserved bytes after warmup are what the warmup holds: the
        # graph pool and the warm-up runs' cached blocks
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved()
        eng = ServingEngine(knn, min_bucket=16, max_bucket=512)
        _, warm_s = host_timed(eng.warmup)
        st = eng.stats()
        if not (st["compile_count"] == st["executables"] == 6
                and eng.graphs):
            raise AssertionError(f"serving: warmup built {st}")
        pool_bytes = eng.graph_pool_bytes()
        reserved_delta = torch.cuda.memory_reserved() - reserved0
        # each capture releases its eager warm-up's cached blocks: what
        # warmup holds is the pool and at most 128 MiB more (the capture
        # stream's cuBLAS workspace, the static inputs)
        if pool_bytes is None or reserved_delta > pool_bytes + (128 << 20):
            raise AssertionError(
                f"serving: warmup reserved {reserved_delta} bytes against "
                f"a graph pool of {pool_bytes}")
        # the bench trace: log-uniform sizes in [1, 512], seed 42
        t_rng = np.random.default_rng(42)
        sizes = np.exp(t_rng.uniform(0.0, np.log(512), size=48)).astype(
            np.int64).clip(1, 512)
        reqs = []
        for size in sizes:
            lo = int(t_rng.integers(0, max(1, q_np.shape[0] - int(size))))
            reqs.append(q_np[lo:lo + int(size)])
        # the same trace through the eager program (aot=False) in turns
        # with the graphs: graphs, eager, eager, graphs; each replay's
        # latency summary is its own 48 requests
        eager = ServingEngine(knn, min_bucket=16, max_bucket=512, aot=False)
        eager.warmup()
        turns = []
        for e in (eng, eager, eager, eng):
            res, rep = e.replay(reqs, depth=2)
            rep["latency_ms"] = latency_summary(list(e._latencies_s)[-48:])
            turns.append((res, rep))
        (res1, rep1), (res_e1, rep_e1), (res_e2, rep_e2), (res2, rep2) = turns
        if rep2["compile_count"] != 6:
            raise AssertionError(
                f"serving: the second replay captured "
                f"{rep2['compile_count'] - 6} graphs")
        # every request bitwise an eager search of its padded batch (all
        # four replays), and the oracle on the trace's first 256 rows
        for j, req in enumerate(reqs):
            rows = bucket_for(eng.buckets, req.shape[0])
            padded = np.zeros((rows, req.shape[1]), np.float32)
            padded[:req.shape[0]] = req
            de, ie = (t.cpu().numpy()[:req.shape[0]]
                      for t in knn.search(padded))
            if not all(all_equal(res[j], (de, ie))
                       for res in (res1, res_e1, res_e2, res2)):
                raise AssertionError("serving: a replayed request differs "
                                     "from its eager search")
        del eager
        i_trace = np.concatenate([r[1] for r in res1])[:256]
        q_trace = np.concatenate(reqs)[:256]
        _, oi = f64_oracle(torch.from_numpy(q_trace).to(dev),
                           knn.placement.db, k)
        oi = oi.cpu().numpy()
        recall = float(np.mean([len(set(a) & set(b)) / k
                                for a, b in zip(i_trace, oi)]))
        same_order = float((i_trace == oi).all(axis=1).mean())
        if recall != 1.0:
            raise AssertionError(f"serving: recall@{k} {recall} against "
                                 f"the f64 oracle")
        # predict through the engine on a labelled placement (the main
        # placement's tensors with labels)
        labels = torch.from_numpy(np.random.default_rng(7).integers(
            0, 10, n).astype(np.int32)).to(dev)
        lab_knn = ShardedKNN(dataclasses.replace(
            knn.placement, labels=labels, num_classes=10), k=k)
        peng = ServingEngine(lab_knn, min_bucket=16, max_bucket=512)
        peng.warmup(ops=("predict",))
        for size in (7, 100, 512, 600):
            got = peng.predict(q_np[:size])
            want = []
            for lo in range(0, size, 512):
                chunk = q_np[lo:min(size, lo + 512)]
                padded = np.zeros((bucket_for(peng.buckets, chunk.shape[0]),
                                   chunk.shape[1]), np.float32)
                padded[:chunk.shape[0]] = chunk
                want.append(lab_knn.predict(padded).cpu().numpy()
                            [:chunk.shape[0]])
            if not np.array_equal(got, np.concatenate(want)):
                raise AssertionError(f"serving: predict of {size} rows "
                                     f"differs from ShardedKNN.predict")
        del peng, lab_knn
        # 256 concurrent 1-8-row requests: every future's rows bitwise its
        # coalesced batch's eager search (one submitting thread and a long
        # max-wait: batches are the FIFO cut at max_rows, then the close)
        q_rng = np.random.default_rng(11)
        rsz = q_rng.integers(1, 9, 256)
        starts = q_rng.integers(0, q_np.shape[0] - 8, 256)
        qq = QueryQueue(eng, max_wait_ms=5000.0)
        t0 = time.perf_counter()
        futs = [qq.submit(q_np[a:a + b]) for a, b in zip(starts, rsz)]
        qq.close()
        got = [f.result() for f in futs]
        queue_wall = time.perf_counter() - t0
        qst = qq.stats()
        batches, cur, rows = [], [], 0
        for j, size in enumerate(rsz):
            if cur and rows + size > qq.max_rows:
                batches.append(cur)
                cur, rows = [], 0
            cur.append(j)
            rows += size
            if rows >= qq.max_rows:
                batches.append(cur)
                cur, rows = [], 0
        if cur:
            batches.append(cur)
        if qst["dispatches"] != len(batches):
            raise AssertionError(f"serving queue: {qst['dispatches']} "
                                 f"dispatches, expected {len(batches)}")
        for batch in batches:
            cat = np.concatenate([q_np[starts[j]:starts[j] + rsz[j]]
                                  for j in batch])
            padded = np.zeros((bucket_for(eng.buckets, cat.shape[0]),
                               cat.shape[1]), np.float32)
            padded[:cat.shape[0]] = cat
            de, ie = (t.cpu().numpy() for t in knn.search(padded))
            lo = 0
            for j in batch:
                want = (de[lo:lo + rsz[j]], ie[lo:lo + rsz[j]])
                if not all_equal(got[j], want):
                    raise AssertionError("serving queue: a scattered "
                                         "result differs from its batch")
                lo += rsz[j]
        # a short knee sweep: 3 rates x 1 s, sizes 1-8, SLO 100 ms
        with QueryQueue(eng, max_wait_ms=2.0) as q0:
            anchor = loadgen.closed_loop_anchor(q0, q_np)
        base = loadgen.WorkloadSpec(
            rate_qps=1.0, duration_s=1.0, seed=0,
            tenants=loadgen.parse_tenants("default:1"))
        rates = loadgen.rates_around(anchor, (0.1, 0.4, 1.0))
        knee = loadgen.knee_sweep(
            lambda: QueryQueue(eng, max_wait_ms=2.0), base, rates,
            queries=q_np[:64], slo_p99_ms=100.0)
        problems = loadgen.validate_knee_block(knee)
        if problems or any(s["errors"] for s in knee["rate_steps"]):
            raise AssertionError(f"serving: knee block {problems} "
                                 f"{knee['rate_steps']}")
        catalog_check("serving knee", "loadgen_knee", knee)
        # the certified stream: 4,096 queries in 1,024-query segments,
        # stopped after two (the last two segments' files gone) and
        # resumed, bitwise the direct search_certified
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_stream_")
        db_np = knn.placement.db_host
        try:
            reset_launches()
            (d_s, i_s, st_s), stream_s = host_timed(
                lambda: streaming_certified_knn(db_np, q_np, k, ckpt,
                                                segment_size=1024))
            launches_full = nonzero_launches(read_launches())
            for b in (2, 3):
                os.remove(os.path.join(ckpt, f"batch_{b:06d}.npz"))
            reset_launches()
            (d_r, i_r, st_r), resume_s = host_timed(
                lambda: streaming_certified_knn(db_np, q_np, k, ckpt,
                                                segment_size=1024))
            launches_resumed = nonzero_launches(read_launches())
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        d_dir, i_dir, _ = knn.search_certified(q_np)
        per_segment = ck.kernel_launches_per_batch("tiled", n, ck.TILE_N)
        if launches_full != {"k1": 4 * per_segment} \
                or launches_resumed != {"k1": 2 * per_segment}:
            raise AssertionError(
                f"serving stream: launches {launches_full} then "
                f"{launches_resumed}, expected K1 x{4 * per_segment} then "
                f"x{2 * per_segment}")
        if not (all_equal((d_r, i_r), (d_dir, i_dir))
                and all_equal((d_s, i_s), (d_dir, i_dir))):
            raise AssertionError("serving stream: the resumed stream "
                                 "differs from the direct search_certified")
        lock_out = serving_lock_order(S, eng)
        audit_out = serving_audit(S, eng, reqs)
        lat1, lat2 = rep1["latency_ms"], rep2["latency_ms"]
        out.update(
            audit=audit_out, lock_order=lock_out,
            ladder=list(eng.buckets), warmup_s=warm_s,
            graphs=st["executables"], graph_pool_bytes=pool_bytes,
            reserved_bytes_after_warmup=reserved_delta,
            trace_requests=48, trace_queries=int(sizes.sum()), depth=2,
            sustained_qps_first=rep1["sustained_qps"],
            sustained_qps_second=rep2["sustained_qps"],
            latency_ms_first=lat1, latency_ms_second=lat2,
            eager={"sustained_qps": [rep_e1["sustained_qps"],
                                     rep_e2["sustained_qps"]],
                   "latency_ms": [rep_e1["latency_ms"],
                                  rep_e2["latency_ms"]],
                   "bitwise_graphs": True},
            per_bucket_dispatches=rep2["per_bucket_dispatches"],
            new_captures_second_replay=rep2["compile_count"] - 6,
            bitwise_eager=True, oracle_rows=256, recall_at_k=recall,
            oracle_same_order_share=same_order,
            predict_equals_sharded=True,
            queue={"requests": 256, "rows": int(rsz.sum()),
                   "dispatches": qst["dispatches"],
                   "wall_s": queue_wall, "scatter_bitwise": True,
                   "latency_ms": qst["latency_ms"]},
            knee={"anchor_qps": anchor, **knee},
            stream={"queries": 4096, "segment": 1024,
                    "k1_launches_full": launches_full["k1"],
                    "k1_launches_resumed": launches_resumed["k1"],
                    "full_s": stream_s, "resumed_s": resume_s,
                    "fallback_queries": st_r.get("fallback_queries"),
                    "bitwise_direct": True})
        emit(out)
        del eng
        torch.cuda.empty_cache()

    if phases & {"main", "mesh", "tiers_mesh", "mesh_paths", "obs",
                  "campaign", "stream",
                  "selectors",
                  "metrics", "quant",
                  "f32arms", "pq", "lane", "survivors", "tune", "index",
                  "ivf", "hosttier", "join", "serving"}:
        if "main" in phases:
            phase_main(sift_data())
        if "mesh" in phases:
            phase_mesh(sift_data())
        if "obs" in phases:
            phase_obs(sift_data())
        if "campaign" in phases:
            phase_campaign(sift_data())
        if "stream" in phases:
            phase_stream(sift_data())
        if "selectors" in phases:
            phase_selectors(sift_data())
        if "metrics" in phases:
            phase_metrics(sift_data())
        # before quant: after the int8 trace (tens of thousands of events)
        # later traces in the process lost their first kernels
        if "f32arms" in phases:
            phase_f32arms(sift_data())
        if "quant" in phases:
            phase_quant(sift_data())
        if "pq" in phases:
            phase_pq(sift_data())
        if "lane" in phases:
            phase_lane(sift_data())
        if "survivors" in phases:
            phase_survivors(sift_data())
        if "tune" in phases:
            phase_tune(sift_data())
        if "index" in phases:
            phase_index(sift_data())
        if "ivf" in phases:
            phase_ivf(sift_data())
        if "hosttier" in phases:
            phase_hosttier(sift_data())
        if "join" in phases:
            phase_join(sift_data())
        if "serving" in phases:
            phase_serving(sift_data())
        # last of the main-draw phases: the timing checks of the phases
        # above (obs on / off) run in the order they were calibrated in
        if "tiers_mesh" in phases:
            phase_tiers_mesh(sift_data())
        if "mesh_paths" in phases:
            phase_mesh_paths(sift_data())
        sift.clear()  # frees the placement before the classify job
        torch.cuda.empty_cache()

    if "native" in phases:
        from knn_tpu_torch import native
        from knn_tpu_torch.models.classifier import knn_predict
        from knn_tpu_torch.ops.topk import knn_search

        t0 = time.perf_counter()
        native.load()
        build_s = time.perf_counter() - t0
        rng = np.random.default_rng(11)
        tr = (rng.random((2000, 32)) * 16).astype(np.float32)
        tr[1500:1600] = tr[:100]  # exact ties through both paths
        lab = rng.integers(0, 7, 2000).astype(np.int32)
        qs = (rng.random((200, 32)) * 16).astype(np.float32)
        nd, ni = native.knn_search(tr, qs, 10)
        pd, pi = knn_search(torch.from_numpy(qs), torch.from_numpy(tr), 10)
        q64 = qs.astype(np.float64)
        tol = 64 * float(np.finfo(np.float32).eps) * (
            (q64 ** 2).sum(-1) + (tr.astype(np.float64) ** 2).sum(-1).max())
        err = float((np.abs(nd - pd.numpy()) / tol[:, None]).max())
        sep = np.ones(ni.shape, bool)
        gap = np.diff(nd, axis=-1) > tol[:, None]
        sep[:, :-1] &= gap
        sep[:, 1:] &= gap
        if err > 1.0 or not np.array_equal(ni[sep], pi.numpy()[sep]):
            raise AssertionError(
                f"native knn_search vs the CPU path: error / bound {err}")
        np_pred = native.knn_predict(tr, lab, qs, k=9, num_classes=7)
        pt_pred = knn_predict(torch.from_numpy(tr), torch.from_numpy(lab),
                              torch.from_numpy(qs), k=9,
                              num_classes=7).numpy()
        if not np.array_equal(np_pred, pt_pred):
            raise AssertionError("native knn_predict differs from the CPU "
                                 "path")
        # the C++ brute force at the main shape, 16 queries (the
        # benchmark's CPU baseline): host seconds, every core
        main_rows = (np.random.default_rng(0).random((1_000_000, 128))
                     * 128.0).astype(np.float32)
        _, base_s = host_timed(lambda: native.knn_search(
            main_rows, main_rows[:16] + 0.5, 100))
        del main_rows
        emit({"phase": "native", "library": native.library_path().name,
              "build_s": build_s, "search_err_over_bound": err,
              "separated_share": float(sep.mean()),
              "predict_equal_cpu_path": True,
              "main_shape_16_queries_s": base_s,
              "cpu_count": os.cpu_count()})

    if "classify" in phases:
        from knn_tpu_torch import native
        from knn_tpu_torch.cli import args_to_config, build_parser
        from knn_tpu_torch.data.datasets import (make_mnist_like,
                                                 save_labeled_csv,
                                                 save_unlabeled_csv)
        from knn_tpu_torch.pipeline import run_job

        tr, trl, te, _, va, val = make_mnist_like(
            n_train=20_000, n_test=2_000, n_val=2_000)
        with tempfile.TemporaryDirectory() as tmp:
            files = {name: os.path.join(tmp, name + ".csv")
                     for name in ("train", "test", "val")}
            save_labeled_csv(files["train"], tr, trl)
            save_unlabeled_csv(files["test"], te)
            save_labeled_csv(files["val"], va, val)
            results = {}
            runs = {"certified": ("--mode", "certified"),
                    "certified_int8": ("--mode", "certified",
                                       "--pallas-precision", "int8"),
                    "certified_highest": ("--mode", "certified",
                                          "--pallas-precision", "highest"),
                    "exact": ("--mode", "exact"),
                    "native": ("--backend", "native")}
            for label, extra in runs.items():
                argv = ["--train", files["train"], "--test", files["test"],
                        "--val", files["val"], "--k", "50", *extra,
                        "--selector", "pallas",
                        "--out", os.path.join(tmp, f"Test_label_{label}.csv")]
                reset_launches()
                native.calls["read_csv"] = 0
                results[label] = run_job(args_to_config(build_parser().parse_args(argv)))
                results[label + "_launches"] = read_launches()
                # the three CSVs went through the native reader
                if native.calls["read_csv"] != 3:
                    raise AssertionError(
                        f"the {label} job read {native.calls['read_csv']} "
                        f"CSVs through the native reader, not 3")
            if nonzero_launches(results["native_launches"]):
                raise AssertionError("the native job launched a kernel")
        cert, exact = results["certified"], results["exact"]
        cert8 = results["certified_int8"]
        cert_hi = results["certified_highest"]
        for label, key in (("certified", "k1"),
                           ("certified_int8", "tiled_int8"),
                           ("certified_highest", "tiled_highest")):
            if results[f"{label}_launches"][key] < 1:
                raise AssertionError(f"the {label} job launched {key} no time")
        for job in (cert, cert8, cert_hi):
            if not (np.array_equal(job.test_labels, exact.test_labels)
                    and np.array_equal(job.val_labels, exact.val_labels)):
                raise AssertionError("certified labels differ from exact labels")
        nat = results["native"]
        if not (np.array_equal(nat.test_labels, cert.test_labels)
                and np.array_equal(nat.val_labels, cert.val_labels)):
            raise AssertionError("native labels differ from the certified "
                                 "job's")
        # the certified arms' rounding against their tolerance at Dp = 896
        # (784 dims): the job's train rows and test queries
        te_dev = torch.from_numpy(np.asarray(te, np.float32)).to(dev)
        tr_dev = torch.from_numpy(np.asarray(tr, np.float32)).to(dev)
        ratio896 = {arm: score_error_ratio(te_dev, tr_dev, arm)
                    for arm in ("bf16x3", "bf16x3f", "highest")}
        # K2's entries at Dp = 896 on the job's rows (2,000 queries x 20,000
        # rows, two 16,384-row tiles), CUDA events, mean of 3
        hi_args = (ck.pad_queries(te_dev),
                   *ck.prepare_db_arm(tr_dev, ck.TILE_N, "highest"))
        hi = {"tiled_ms": time_cuda(lambda: ck.binned_select(
                  *hi_args, tile_n=ck.TILE_N, arm="highest"), 3),
              "streaming_ms": time_cuda(lambda: ck.stream_select(
                  *hi_args, tile_n=ck.TILE_N, arm="highest"), 3),
              "fused_ms": time_cuda(lambda: ck.fused_select(
                  *hi_args, tile_n=ck.TILE_N, keep=80, arm="highest"), 3),
              "bound": f32_bound(te_dev.shape[0], tr_dev.shape[0],
                                 hi_args[0].shape[1],
                                 hi_args[1].shape[0] // ck.TILE_N,
                                 ck.SURVIVORS, "highest")}
        del te_dev, tr_dev, hi_args
        if max(ratio896.values()) >= 1.0:
            raise AssertionError(
                f"kernel score error reached its tolerance at Dp = 896: "
                f"{ratio896}")
        emit({"phase": "classify", "n_train": 20_000, "k": 50,
              "val_accuracy": cert.val_accuracy,
              "exact_val_accuracy": exact.val_accuracy,
              "labels_equal_exact": True,
              "k1_launches": results["certified_launches"]["k1"],
              "int8_labels_equal_exact": True,
              "int8_k5_launches": results["certified_int8_launches"]["tiled_int8"],
              "highest_labels_equal_exact": True,
              "highest_k2_launches":
                  results["certified_highest_launches"]["tiled_highest"],
              "highest_certified_stats": {
                  key: v for key, v in cert_hi.certified_stats.items()
                  if key != "pallas_knobs"},
              "score_error_over_tolerance_dp896": ratio896,
              "highest_kernels_dp896": hi,
              "int8_certified_stats": {key: v for key, v in
                                       cert8.certified_stats.items()
                                       if key != "pallas_knobs"},
              "native_labels_equal_certified": True,
              "native_phase_times_s": nat.phase_times,
              "csvs_through_native_reader": 3,
              "certified_qps": cert.queries_per_sec,
              "exact_qps": exact.queries_per_sec,
              "certified_stats": {key: v for key, v in cert.certified_stats.items()
                                  if key != "pallas_knobs"},
              "phase_times_s": cert.phase_times})

    for key, rec in records.items():
        rec["max_abs_err"] = checks[key].max_abs_err
    if phases >= set(ap.get_default("phases").split(",")):
        # every phase ran: every entry was launched, checked and timed
        for key, rec in records.items():
            if not rec["launches"] or any(
                    rec[f] is None for f in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms")):
                raise AssertionError(f"kernel record {key} is incomplete: "
                                     f"{rec}")
    emit({"phase": "catalog", "history_sweep": history_sweep(),
          "blocks_validated": len(CATALOG_CHECKS),
          "blocks": CATALOG_CHECKS})
    emit({"phase": "done", "phases": sorted(phases)})
    emit({"kernels": list(records.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
