#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py                 # every phase, full size
    python3 chip_smoke.py --phases A      # kernel build + parity only
    python3 chip_smoke.py --phases CF     # the segment lifecycle only
    python3 chip_smoke.py --phases CG     # the observability plane only
    python3 chip_smoke.py --phases CH     # the durability plane only
    python3 chip_smoke.py --phases CI     # shards and replica groups only
    python3 chip_smoke.py --phases CIJ    # the cluster control plane only
    python3 chip_smoke.py --phases K      # the launcher runs only
    python3 chip_smoke.py --phases L      # the LM and its training only
    python3 chip_smoke.py --phases M      # the recsys models and GIN only
    python3 chip_smoke.py --phases N      # the MoE LMs only
    python3 chip_smoke.py --phases O      # the dry run's cells only

It builds the hand-written kernels from the sources in this checkout (one
nvcc per library, all started together), holds each against its plain
PyTorch version on the card, drives the port's search paths at the
paper's scale -- a 4,181,504 x 400 Wikipedia-shaped index
(RoundingEncoder(2), int8 codes), trim 0.05, page 320, k 10 -- runs the
paper's quality pipeline on the card, takes that index through the
segment lifecycle (ingest, seal, delete, merge, compact), serves it
with the observability plane on and off, commits, kills and recovers it
through the durability plane, splits it into 4 doc-shards x 1 and
x 2 replica groups, serves those groups through the cluster control
plane (routing, failover, health, restore and background merges) and
reads their device bytes, cost rows and diagnostics bundle, and runs
the port's serving launcher as an operator would, trains, resumes,
prefills and decodes the dense LM qwen2-0.5b at its published widths,
trains and serves the four recsys models and GIN at theirs, the
paper's two-phase search retrieving from 1,000,000 candidates, and
trains, resumes, prefills and decodes the two MoE LMs, mixtral-8x22b and
llama4-maverick, at their published widths, and runs the dry run's
cells of the paper's own system at full width against their meta
traces, with an elastic move of a training run to the host and back.

Phases, each printing one JSON line (D and G one per engine, then a
summary):
  A  each kernel against its plain version: fused_phase1 (scores
     bit-equal, ids equal where finite), code_match (rtol/atol 1e-5, and
     bit-equal to the match_scores tree) and fused_phase1_quant (scores
     within rtol 1e-5 / atol 1e-4, ids equal away from near-ties, and
     scores and finite ids bit-equal to ref.quant_split_scores' stable
     top-page, the tensor-core arithmetic in torch), ids in
     range, at four shapes or more each, page = d = 5000 and page 16,384
     (the fold in device memory) included; rerank_topk's two bodies
     (rtol 1e-4 / atol 5e-5, and bit-equal to each other where both run)
     at eleven shapes: page 8192, ragged n, a bulk ring that wraps, n = 4
     and 4096, duplicate and out-of-range ids, a table 4 bytes off
     16-byte alignment, each with the body its plan picks; bucketize
     (>= 99.99% of codes equal, the rest one bucket off) in both modes,
     int8 and int16, ragged rows; postings_walk at the postings cell's
     shapes (a 4,181,504 x 400 index, 32 noisy rows, trim 0.05, about
     480M posting entries) bit-equal to its plain version, timed beside
     it and its bound, its two kernels split by the profiler; page_select
     on that walk's 32 x 4,181,504 scores at page 320, bit-equal to
     stable_topk on the card and the CPU, timed beside its bound, the
     plain version and torch.topk, its host issue and its nine kernels
     split by the profiler;
  B  encoders and the int8 quant table on the card against the CPU (codes,
     scale and zero bit-equal);
  C  the ``fused`` path: build, serve 128 noisy corpus rows through
     BatchedSearchEngine(engine="fused"), check rank-1 hits, exact fp32
     scores and the kernel's launch count; kernel time, plain time and
     bound at the served shape;
  D  every other engine on phase C's index: BatchedSearchEngine with no
     engine named (``codes``), ``codes_pallas`` and ``fused_int8`` (128
     rows each), ``index.search`` with no engine named (``postings``, 32
     rows, served twice: both answers, and two runs of its phase-1
     scores, bit-equal), and ``onehot`` on the first 65,536 rows (32
     rows); one ``fused_int8`` batch under torch.profiler (host time,
     device busy time, idle share and synchronise calls), through
     ``index.search`` and through a default BatchedSearchEngine, whose
     synchronise calls must be the index's plus the answers' two copies
     to the host; the same checks, the kernels' launch counts, and each
     kernel's time, plain time and bound at Q 32; then
     ``bucketize.ops.encode`` of the raw 4,181,504 x 400 rows held to
     ``index.codes`` (the encode_4m cell of
     ``src/repro/configs/vectordb_wiki.py``), and
     ``rerank_topk.ops.rerank_topk`` on the served candidates at page 320
     and 8192 held to ``core.rerank.rerank_topk``, with its gathered
     signature (``ops.rerank_scores`` on pre-gathered rows) timed beside
     the einsum on the same rows, the bulk body's launches counted; at
     page 320 both bodies and the einsum again over 8 random candidate
     sets rotated in one graph (131 MB of rows: cold in L2), at page 8192
     the kernel, the simple body and the einsum in turns, three each;
  E  the paper's quality path: make_corpus (262,144 docs, vocabulary
     100,000, 400 topics) -> build_lsa(400) on the card -> VectorIndex
     (CombinedEncoder(P1, I10)) with bucketize held to its codes -> P@10,
     nDCG and avg.diff of ``codes``, ``fused`` and More-Like-This against
     brute force, the claims C1-C5 of tests/test_quality_claims.py, and
     rerank_topk on the ``fused`` candidates; the LSA is built twice and
     the MLT scores taken twice, each pair bit-equal;
  F  the segment lifecycle on phase C's index (run before E):
     ShardedVectorIndex.from_index (no copy) served through
     BatchedSearchEngine(donate_ingest=True), 65,536 seeded unit rows
     added in 16 batches of 4,096 between served batches (each seals: 16
     generations) and 200 more left in the active buffer, 4,096 ids
     deleted (2,048 base, 1,848 sealed, the 200 active),
     merge_segments(0, 16), compact(); after every stage 128 queries
     (noisy base, sealed and active rows) through ``fused``,
     ``fused_int8``, ``codes_pallas`` and ``postings`` (``codes`` once,
     after the deletes): no deleted id, every live appended source at
     rank 1, scores within 1e-5 of a fresh cosine, each kernel launched as
     the generations predict, and the answers bit-identical to those of a
     flat index (seal_threshold=None) given the same history, run first
     and freed; after the deletes, in both histories, the kernels called
     on the tombstoned tables with their live masks and held to their
     plain versions as in A (fused_phase1 and fused_phase1_quant on the
     base, the two and code_match on the first sealed segment and the
     active or flat buffer); add, delete, merge and compact
     seconds, batch latency per stage and peak memory.  At 17 generations
     each engine is served once more with the full observability plane
     and a profile on every request (as in G): answers bit-equal to the
     bare pass, and the phase1 node carries base, gen0..gen16 and active,
     whose candidates add up to its own;
  G  the observability plane on phase C's index (run after D): ``fused``,
     ``fused_int8``, ``codes_pallas`` and ``postings`` (128 rows) and
     ``codes`` (32 rows) each served three times, bare
     (MetricsRegistry(enabled=False)), with metrics only, and with the
     full plane (registry, Tracer(sample=1.0, annotate=True),
     SlowLog(threshold_s=0), CompileWatch) and ``profile=True`` on every
     request: the three answers bit-equal, every profile tree tiling its
     root within 1e-6 s, phase1 naming the engine (or ``composed``), the
     batches' dispatch nodes adding up to the dispatch-latency
     histogram, submitted = completed = n and no failure, one
     ``kernel_path`` count a batch, the slow log capturing every request,
     no kernel build after the warm-up batch, and one
     ``engine_requests_completed_total`` series of value n; batch latency
     medians of the three and the profiles' encode / phase1 / rescore
     split (printed, not gated); then one ``fused_int8`` batch traced
     through ``index.search``, bare and with the full plane: the bare
     engine's synchronise calls must be the index's plus the answers'
     two copies (bare serving adds none), the full plane's the bare
     engine's plus one fence per profiled phase, and the
     ``repro.engine.dispatch`` range must enclose every kernel and copy
     of the full one;
  H  the durability plane on phase C's index (run after F): a Store with
     request durability in a fresh directory under this checkout's
     build/ (its filesystem and free bytes printed, the room for the
     largest moment -- two bases during the compact commit -- checked
     first), open_index(ShardedVectorIndex.from_index(...)) writing the
     baseline commit, F's 16 x 4,096 + 200 rows and 4,096 deletes
     through BatchedSearchEngine(donate_ingest=True) serving the
     DurableIndex (never donated: no buffer of a served state written in
     place), a commit after the 8th batch (8 blobs, under 1% of the
     bytes it references); then three kills -- the engine and the store
     dropped unclosed -- each followed by recover(dir, device="cuda")
     from the directory alone: after the deletes (10 ops replayed), after
     merge_segments(0, 16) and its commit, after compact() and its
     commit.  Each recovered index has the live one's seq, every leaf
     (base, posting tables, active buffer, each segment) torch.equal, and
     the answers of ``fused``, ``fused_int8``, ``codes_pallas`` and
     ``postings`` to the 128 queries bit-identical; commit seconds and
     bytes, validate / restore / replay seconds, durable add latency
     beside F's, peak device memory and host RSS, and ``store.stats()``
     printed; the directory removed at the end;
  I  doc-shards and replica groups on phase C's index (run after H):
     ShardedVectorIndex.from_index onto 4 x 2 (views of the vectors,
     codes and int8 table, checked; per-shard posting tables built, their
     seconds and bytes printed) and its replica_group(0), the 4 x 1
     index sharing every tensor; ``fused``, ``fused_int8``,
     ``codes_pallas``, ``postings`` (128 rows) and ``codes`` (32 rows)
     served through BatchedSearchEngine on one shard, 4 x 1, 4 x 2 and 4
     x 2 with the stream transport: the three sharded answers bit-equal,
     live_groups=(1,) and replica_group(0 and 1) bit-equal to them, rank
     1 for >= 0.95 of the sources, scores within 1e-5, every top-1
     cosine at least the one-shard index's (the shards' pages hold its
     page), each kernel launched once per shard and row-block; the three
     kernels held to their plain versions on shard 1's slice as in A;
     the first 65,536 rows at page >= n_ids: 4 x 2 (both transports)
     bit-equal to one shard for all six engines, then F's history at a
     sixteenth of its size (16 x 1,024 + 50 rows, 1,024 deletes, a
     16-segment merge, a compact) on a segmented 4 x 2, a flat 4 x 1 and
     a segmented one-shard index, bit-equal at every stage for four
     engines and both transports; the store: the 4 x 1 index committed
     and recovered onto 4 x 2 (every leaf and four engines' answers
     identical), the depth history made durable, two ops replayed onto
     4 x 2, and a one-shard commit restored onto 4 shards equal to
     from_index; last F's history at full width on 4 shards, served as F
     serves it, with its add, delete, merge and compact seconds.  Batch
     medians beside phase C's and D's, launches a batch by kernel, one
     ``fused_int8`` batch traced on 4 x 1 and 4 x 2 (host time, device
     busy time, idle share: one shard's is D's and G's), peak memory and
     the card's name and power limit in its line;
  J  the cluster control plane on phase C's index (run after I, which it
     needs: its answers are phase I's; C's flat posting tables are freed
     first): ShardedVectorIndex.from_index onto 4 x 2 as I builds it.
     1. ClusterEngine serving ``fused_int8`` and ``fused`` (batch 32,
     max_wait_s 0.005, page 320, k 10, trim 0.05) on 4 x 2 (two groups),
     4 x 1 (one group) and 4 x 2 with group 1 marked down, by 1, 4 and 16
     client threads, each one stream id submitting the 128 queries
     open-loop: every answer bit-equal to phase I's 4 x 2 answer for the
     row, rank 1 for >= 0.95 of the sources, submitted = completed = the
     requests issued = the groups' completions, each kernel launched once
     per shard of each dispatch; QPS, p50 / p99 submit-to-done latency,
     spills and each group's completions; one ``fused_int8`` batch per
     group under 2-group load traced on every thread (each group's
     searches in its ``repro.cluster.group<g>`` range, each kernel
     launched inside an op-scope record, so a device event belongs to the
     group whose thread made its runtime call; checked: no more than 5% of
     the device time to no group): host time, device busy time and idle
     share, each group's device time.
     2. Failover on the 2-group ``fused_int8`` cluster: a failure injected
     into group 0 a quarter of the way through a 16-stream run (every
     answer bit-equal, one ``down`` transition), heal and re-admission by
     ``MaintenanceDaemon.probe_once``, a drain of group 1 with 64
     requests in flight (they finish there, 32 new ones go to group 0),
     every group failing one request (the future carries the error, the
     rollback readmits both); cluster_health green -> yellow -> green ->
     yellow -> green, its ledger reconciled with the counters, each
     ``format_health_line`` printed.
     3. Writes at full width: ClusterEngine(s42, store=Store(<build/...>,
     "request")) writing the baseline commit (free room checked first),
     8 x 4,096 seeded rows and 2,048 deletes (1,024 base rows, a quarter
     of the third generation) between served batches, the bytes each
     group owns after them; the three kernels held to their plain
     versions on group 1's shard 1 slice (the tombstoned base and the
     generation the deletes hit) as in F and I; ``restore_group(1)`` from
     disk (every leaf torch.equal to group 0's, four engines' answers
     bit-equal, restores_completed 1, its peak memory); then
     MaintenanceDaemon(TieredMergePolicy(merge_factor=4)) folding the 8
     generations in three passes (two delete rewrites, four tier merges)
     under 4-stream traffic: no request fails and every answer is the
     pre-merge one, each swap answers as an explicit merge_segments of
     its snapshot, each group 0 pass lands a commit.
     4. The demoted full compact on I's depth cut (65,536 rows) at 4 x 2:
     1,024 rows added, 16,384 base rows deleted, the daemon of
     ClusterEngine(auto_compact=0.2) compacting both groups under traffic
     (no deleted id served): n_appended, the tombstone ratio, the
     segments and the active buffer 0, answers bit-equal to an explicit
     compact.  Add, delete, restore, merge and commit seconds, launches
     by kernel, peak memory and the card's name and power limit in its
     line.
     Device accounting in step 3: ``device_bytes`` of a group before the
     writes (its storage bytes at most ``torch.cuda.memory_allocated``,
     checked at every read) and the bytes each group owns after the
     deletes (``repro_torch.obs.device.resident_storages``: the rebuilt
     base and 8 segments, their count checked, and the int8 tables
     apart); after the merges one ``codes`` and one ``fused`` batch on
     group 0 beside the cluster's ``fused_int8``, under the cluster's
     CompileWatch, then each group's ``device_bytes``, ``node_stats``
     (storages counted once, checked), a diagnostics bundle written under
     build/ and accepted by ``tools/validate_diag_bundle_torch.py``, no
     building region without a cost row, and the fused-vs-composed byte
     claim of ``artifacts/BENCH_kernel_scale.json`` holding live;
  K  the port's launcher, ``python -m repro_torch.launch.serve``, as
     four processes of its own (K_RUNS), each of which must exit 0
     with its own assertions: K1 ``fused_int8`` on 262,144 docs x 400
     (phase E's cut) at 4 x 2 through the cluster, 4,096 docs ingested,
     group 0 failed and healed (bit-identical, health green -> yellow ->
     green), a store killed and recovered (bit-identical), stats every
     second, every request profiled and slow-logged, metrics to build/,
     diagnostics bundles at the failover, the kill and the exit
     (accepted by the validator); K2 ``fused`` on 65,536 docs, 4 x 2,
     ``stream``, the background compaction; K3 ``codes`` on 65,536 docs
     at 4 x 1 with ``--fail-on-recompile --profile --slow-threshold 0``;
     K4 ``codes_pallas`` on K3's corpus with ``--fail-on-recompile``,
     its kernels built into an empty directory (its first pass builds
     ``code_match`` in a serving region: counted, with a cost row, and
     no build after the steady state, read from its exit bundle).  K2,
     K3 (plain torch) and K4 serve the same ids, bit for bit (the digest
     each run prints).  K2-K4 run while K1 generates its corpus, and
     meanwhile each kernel is held to its plain version at the runs'
     shapes (shard 1 of 64,512 rows and of K1's 1,024 ingested rows for
     ``fused_phase1_quant``, of 16,384 rows before and after 19,660
     deletes and compacted for ``fused_phase1`` and ``code_match``, Q 32,
     page 320, the served live masks).  P@10, ms a query,
     kill-and-recover seconds, bundle count and the kernels each run
     launched (its last line) in the K line.
  L  the dense transformer LM and the training substrate, qwen2-0.5b
     (24 layers, d_model 896, 14 heads over 2 KV heads, d_ff 4864, vocab
     151,936, tied embeddings, QKV biases), run last with every earlier
     phase's tensors released and bf16 products accumulated in f32:
     L0 two of its layers at its widths, seq 512, batch 2, params carried
     from one seeded CPU tree: logits (<= 2e-2 of the largest), lm_loss
     (<= 2e-3 relative), gradients (global norm within 1e-2, cosine >=
     0.999) and one AdamW step fed the CPU's gradients (<= 1e-6 of each
     leaf's largest) on the card against the CPU; L1 the full config
     (494,032,768 parameters) from init_params seeded on the card, 4 steps
     of make_train_step with AdamW and a cosine schedule at global batch 16
     x 4,096 (train_4k's length) at accum 16: step-0 loss within 0.5 of
     ln 151,936, finite losses and gradient norms, seconds a step, tokens
     a second, peak memory; L2 the reference's test_resume_is_bit_exact at
     full widths under torch.use_deterministic_algorithms: batch 2 x
     4,096 at accum 2, 6 steps straight against 3, a checkpoint and a
     resume to 6 through run_train_loop, every parameter and AdamW moment
     equal bit for bit, checkpoint bytes and seconds (the directories
     under a temporary directory, removed); L3 serving: a 32,768-token prefill
     (prefill_32k's length), serve_step against forward at 4 x 4,096
     (relative error < 0.05, the reference's bound), then a 512-token
     prefill at batch 64 into a 32,768-slot cache (decode_32k's;
     25,769,803,776 B, checked) and 16 greedy decode steps, each reading
     every slot: prefill seconds, decode ms a step; L4 ``python -m
     repro_torch.launch.train --arch qwen2-0.5b --smoke --steps 20
     --ckpt-every 10``, then ``--steps 30`` on the same directory, which
     must resume at step 20 (run beside L0-L3).  The LM path launches
     none of the five search kernels (checked).  Cuts: train_4k at batch
     16 and accum 16 (256 at accum 8), prefill_32k at batch 1 (32),
     decode_32k at batch 64 (128).
  M  the recsys models (xDeepFM, AutoInt, DIN, BST) and GIN, float32 with
     TF32 off: M0 each recsys model at its smoke config (batch 256) and
     GIN at 2 layers of full_graph_sm's widths on a Cora-sized graph, on
     the card against the CPU from one seeded tree (logits, user
     embedding, loss, gradients' norm and cosine, one AdamW step fed the
     CPU's gradients, within the CPU parity tests' bounds), and two
     training steps run twice on the card, every leaf bit-equal; M1 each
     recsys model at its published config (453,586,306 / 654,350,798 /
     302,025,171 / 538,242,786 parameters) 4 AdamW steps at train_batch's
     65,536 rows: step-0 loss within 0.1 of ln 2, seconds a step,
     examples a second, peak memory; then DIN 2 + 2 steps with a
     checkpoint and a resume through run_train_loop against 4 straight,
     every parameter and moment bit-equal (the directories under a
     temporary directory, removed); M2 each trained model forward under
     no_grad at serve_p99 (512 rows: the first of the bulk batch, whose
     logits must equal the bulk's within 1e-5) and serve_bulk (262,144),
     median ms of 5 calls; M3 retrieval_cand: the user tower on one
     request, then serve/retrieval.py's retrieval_step over 1,000,000
     seeded Gaussian candidates of the model's embed_dim (page 512, k
     100, trim 0.05): at page = N the ids and score bits of
     brute_force_retrieval (which ranks by one (1, N) product) but where
     two scores lie within 4 * D * 2**-24 of each other, at page 512 the
     page's ids bit-equal to the same phase 1 on the CPU, recall@100 and
     the ms of both (reported, not gated); beside it the code_match
     kernel through its wrapper on the same problem within 1e-5 of
     score_codes, both timed, its launches counted by the wrapper and
     taken off the path's; M4 gin-tu at its four shapes, 3 AdamW steps each:
     full_graph_sm (a Cora-sized random graph, 1,433 features, padded
     x512), molecule (128 graphs of 30 nodes and 64 edges), minibatch_lg
     (a block sampled with fanouts 15, 10 from 1,024 seeds a step, over a
     Reddit-sized graph of 232,965 nodes, 11,606,919 edges, 602
     features) and ogb_products (2,449,029 nodes x 100 features,
     61,859,140 edges, 47 classes, in full): seconds a step, peak memory.
     The path launches none of the five search kernels (checked).  Cuts:
     xDeepFM's train_batch at accum 2 and its serve_bulk in row chunks of
     16,384 (CIN's (B, D, H*m) product); checks are gathered and raised
     at the phase's end.
  N  the two MoE LMs, run last with every earlier phase's tensors
     released, bf16 products accumulated in f32 and the allocator's
     segments expandable (restored after): N0 mixtral-smoke and
     llama4-smoke from one seeded CPU tree on the card against the CPU,
     the card run on the CPU's routing (``NRoutes`` forcing ``moe.route``;
     the routing it picks on its own counted against the CPU's): logits
     (<= 2e-2 of the largest), aux (<= 1e-4), lm_loss (<= 2e-3), gradients
     (norm within 1e-2, cosine >= 0.999) and one step of the arch's
     optimizer (AdamW, Adafactor) fed the CPU's gradients (<= 1e-6), two
     identical training steps run twice on the card, every leaf
     bit-equal; one moe_ffn at mixtral's layer widths (D 6,144, F 16,384,
     8 experts, top-2, 256 bf16 tokens, cf 8.0) on the card against the
     CPU: routing equal wherever the top-2 gap exceeds 1e-5 (the tokens
     under it counted), y within 1e-2 of the largest; N1 the cuts at
     train_4k's length, 4 donated steps of global batch 16 x 4,096 each:
     mixtral at 1 of its 56 layers (2,906,714,112 parameters, f32 AdamW,
     accum 8) and llama4 at one super-block of 12 with 16 of its 128
     experts (6,850,682,880 parameters, bf16, Adafactor, accum 16), each
     the smallest accum in {4, 8, 16} under about 75 GB
     (``tools/moe_profile.py``): step-0 loss within 0.5 of ln V + 0.01,
     seconds a step, tokens a second, peak memory, the share of (token,
     choice) pairs dropped at cf 1.25; N2 llama4's cut through L2's
     protocol under torch.use_deterministic_algorithms (batch 2 x 4,096,
     accum 2, 6 steps straight, outside the loop, against 3 through
     run_train_loop, a checkpoint and a resume to 6, every parameter
     and Adafactor leaf bit-equal; checkpoint bytes and seconds; the
     checkpoints, 27.4 GB each, in /dev/shm, host memory checked first,
     so the script's disk writes stay small); N3, serving at kv_chunk
     256, mixtral at 8 of its layers in bf16 (20,435,140,608
     parameters): a 32,768-token prefill, one 65,536-token forward (two
     moe_token_chunk chunks a layer, counted), serve_step against
     forward at 4 x 4,096 at cf E / top_k so nothing drops, on the
     routing the prefill gave its tokens (relative error < 0.05; its own
     routing's error and flips reported), a 512-token prefill at batch
     64 into a 32,768-slot cache (its bytes predicted and checked) and
     16 greedy decode steps at cf 1.25 (ms a step, pairs dropped a
     step); llama4's resumed cut: the 32,768-token prefill and the
     decode at batch 64;
     N4 ``python -m repro_torch.launch.train --arch <id> --smoke --steps
     20 --ckpt-every 10`` then ``--steps 30`` for both ids, resuming at 20
     (run beside N0-N3).  The MoE path launches none of the five search
     kernels (checked).  Cuts: mixtral trains 1 of 56 layers and serves
     8, llama4 runs one super-block of 12 with 16 of 128 experts,
     train_4k at batch 16 (256), prefill_32k at batch 1 (32),
     decode_32k at batch 64 (128).
  O  the dry-run slice, run last: O1 vectordb-wiki's three cells
     (``configs/vectordb_wiki.py``: ``search_b128``, ``search_b1``,
     ``encode_4m``) on 4,181,504 seeded Gaussian unit rows x 400 and 128
     noisy copies of rows among the first 65,536: first each cell's fn on
     those 65,536 rows on the card and on the CPU (codes of the bucketize
     kernel against its plain version under the bucketize contract, the
     search pages equal, ids equal but in runs of scores within 2e-5,
     scores within it), then at full size once as the main path (one
     bucketize launch and no other, checked; every source row at rank
     1), then each cell under the op census of
     ``launch/op_analysis.py``, timed (median of 3) with its peak memory,
     and the bucketize kernel, its plain version and its bound at
     4,181,504 x 400; O2 ``launch/dryrun.run_cell`` for the three cells
     on ``make_local_mesh(1, 1)``: input bytes equal to O1's real
     arguments (8,363,212,800 / 8,363,009,600 / 6,690,406,400 B) and the
     meta trace's FLOPs and dot FLOPs equal to O1's card census, the
     records on the 16 x 16 and 2 x 16 x 16 meshes (their bytes a device
     checked), and qwen2-0.5b's prefill_32k and decode_32k traced; O3
     qwen2-0.5b at its published widths, AdamW, 2 x 4,096 at accum 1:
     four steps straight against two, the parameters and AdamW state
     moved to a (1, 1) mesh on the CPU and back by
     ``train/elastic.resize_data_axis``, and two more, under
     torch.use_deterministic_algorithms: losses, parameters and moments
     bit-equal.  Checks are gathered and raised at the phase's end.
     Cuts: O3 trains at batch 2 (train_4k's 256 at accum 8).
Then the ``kernels`` line (launches summed over the phases' main paths,
phase K's as its runs printed them,
and by phase; each library's largest ptxas stack frame
of a kernel: 0 bytes for the code-match scorers, checked; both rerank
bodies' registers and spill bytes, 0 for the bulk body, checked), the card's
name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, and the exit
code is not 0.  Without a CUDA device, or without the ``src/repro_torch``
package beside this file, it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

# phase L's bit-exact resume runs under torch.use_deterministic_algorithms,
# which needs cuBLAS's workspace fixed before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

N_DOCS = 4_181_504                 # English Wikipedia 4,181,352, padded x512
N_FEATURES = 400
BATCH = 32
N_QUERIES = 128
PAGE = 320
K = 10
NOISE = 0.01
SERVE_MAX_WAIT_S = 1.0             # phases C-I: see make_engine
ONEHOT_DOCS = 65_536               # onehot's (d, C*201) table, cut to size
F_NEW = 65_536                     # phase F: docs appended in batches that
F_BATCH = 4_096                    # each seal (16 generations), then a
F_TAIL = 200                       # tail left in the active buffer
F_SEAL = 256                       # the reference's seal_threshold
F_DELETE_BASE = 2_048              # deletes: base rows, sealed rows, and
F_DELETE_SEALED = 1_848            # every tail row
F_ENGINES = ("fused", "fused_int8", "codes_pallas", "postings")
ENGINES = ("postings", "codes", "onehot", "codes_pallas", "fused",
           "fused_int8")
I_DEPTH = 65_536                   # phase I: rows served at page >= n_ids,
I_BATCH = 1_024                    # F's history at a sixteenth of its size
I_TAIL = 50
G_ENGINES = ("fused", "fused_int8", "codes_pallas", "postings", "codes")
J_ENGINES = ("fused_int8", "fused")
J_STREAMS = (1, 4, 16)             # phase J: client streams of 128 requests
J_ADDS = 8                         # 8 x 4,096 rows through the cluster, and
J_DELETE_BASE = 1_024              # 2,048 deletes: base rows and a quarter
J_DELETE_SEALED = 1_024            # of one sealed generation
J_COMPACT_DELETES = 16_384         # a quarter of I's depth cut: past 0.2
K_TIMEOUT_S = 600                  # phase K: each launcher run's limit
E_DOCS = 262_144                   # phase E corpus, cut from 4,181,352
E_VOCAB = 100_000                  # gensim make_wiki: keep_n=100000
E_TOPICS = 400
E_QUERIES = 128
E_EXACT_QUERIES = 16               # C4 at page = n_docs: (16, d, 400) rescore
L_ARCH = "qwen2-0.5b"              # phase L: the one assigned LM whose
L0_LAYERS, L0_SEQ, L0_BATCH = 2, 512, 2    # training fits one card
L_SEQ = 4_096                      # train_4k's length; batch 16 at accum 16,
L_BATCH, L_ACCUM, L_STEPS = 16, 16, 4      # not 256 at accum 8
L2_BATCH, L2_ACCUM, L2_STEPS = 2, 2, 6     # 6 steps against 3 + resume to 6
L_PREFILL = 32_768                 # prefill_32k's length, at batch 1 (not 32)
L_DECODE_BATCH = 64                # decode_32k at batch 64 (not 128)
L_DECODE_CACHE = 32_768            # decode_32k's cache (max_seq)
L_DECODE_PROMPT = 512
L_DECODE_STEPS = 16
L_LAUNCHER_STEPS = (20, 30)        # launch.train, then its resume


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events,
    after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` without the host's share: after
    one warm-up call, ``reps`` calls are captured in one CUDA graph, which
    is replayed once (warm) and then once between CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rerank_bound_ms(ids: torch.Tensor, n: int) -> tuple:
    """Least time for rerank_scores on these ids: each distinct candidate
    row read once (a count this run's data gives), the rest as
    :func:`repro_torch.obs.cost.rerank_work` counts it."""
    from repro_torch.obs import cost

    Q, P = ids.shape
    return cost.bound_ms(cost.rerank_work(Q, P, n,
                                          int(torch.unique(ids).numel())))


def host_ms(fn) -> float:
    """Milliseconds of one call of ``fn`` on the host clock, synchronised
    before and after."""
    torch.cuda.synchronize()
    t = time.monotonic()
    fn()
    torch.cuda.synchronize()
    return (time.monotonic() - t) * 1e3


def assert_quant_parity(got, want, d, ctx, tol=1e-4) -> float:
    """The fused int8 contract: scores within rtol 1e-5 / atol 1e-4, ids
    equal wherever the plain version separates neighbours by more than
    that same tolerance (tol + 1e-5 |s|: at |s| ~ 180 a legal difference
    of 1e-4 swaps neighbours 1.2e-4 apart), ids in range; -> max |score
    difference| over finite entries.  ``want`` may hold one column more
    than ``got`` (the plain version at page + 1), so that a near-tie
    across the page's last slot counts as one."""
    s_g, i_g = (t.cpu().numpy() for t in got)
    s_w, i_w = (t.cpu().numpy() for t in want)
    page = s_g.shape[1]
    sep = np.isfinite(s_w)
    if s_w.shape[1] > 1:
        with np.errstate(invalid="ignore"):
            tie = (np.abs(s_w[:, :-1] - s_w[:, 1:])
                   <= tol + 1e-5 * np.abs(s_w[:, :-1]))
        sep[:, 1:] &= ~tie
        sep[:, :-1] &= ~tie
    s_w, i_w, sep = s_w[:, :page], i_w[:, :page], sep[:, :page]
    fin = np.isfinite(s_w)
    check(np.array_equal(fin, np.isfinite(s_g)), f"{ctx}: -inf slots differ")
    err = float(np.abs(s_g[fin] - s_w[fin]).max()) if fin.any() else 0.0
    check(bool(np.all(np.abs(s_g[fin] - s_w[fin])
                      <= tol + 1e-5 * np.abs(s_w[fin]))),
          f"{ctx}: scores off by {err}")
    bad = np.argwhere(sep & (i_g != i_w))
    near = [(s_w[q, max(j - 1, 0):j + 2].tolist(),
             s_g[q, max(j - 1, 0):j + 2].tolist()) for q, j in bad[:2]]
    check(bad.size == 0, f"{ctx}: ids differ at (query, slot) "
          f"{bad[:4].tolist()}; (plain, kernel) scores around: {near}")
    check(bool(((i_g >= 0) & (i_g < d)).all()), f"{ctx}: id out of range")
    return err


def stack_frames(log_lines) -> dict:
    """{mangled kernel name: bytes of its stack frame} from a library's
    ``nvcc -Xptxas -v`` log."""
    out, fn = {}, None
    for ln in log_lines:
        if "Function properties for" in ln:
            fn = ln.rsplit(" ", 1)[-1]
        elif "bytes stack frame" in ln and fn is not None:
            if "kernel" in fn:
                out[fn] = int(ln.split()[0])
            fn = None
    return out


def spill_bytes(log_lines) -> dict:
    """{mangled kernel name: bytes of spill stores + loads} from a
    library's ``nvcc -Xptxas -v`` log."""
    out, fn = {}, None
    for ln in log_lines:
        if "Function properties for" in ln:
            fn = ln.rsplit(" ", 1)[-1]
        elif "bytes spill stores" in ln and fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if "kernel" in fn and m:
                out[fn] = int(m.group(1)) + int(m.group(2))
            fn = None
    return out


def registers(log_lines) -> dict:
    """{mangled kernel name: registers a thread} from a library's
    ``nvcc -Xptxas -v`` log."""
    out, fn = {}, None
    for ln in log_lines:
        if "Function properties for" in ln:
            fn = ln.rsplit(" ", 1)[-1]
        elif "registers" in ln and fn is not None:
            m = re.search(r"Used (\d+) registers", ln)
            if "kernel" in fn and m:
                out[fn] = int(m.group(1))
            fn = None
    return out


def code_match_plain(D, Qc, W, block=32768):
    """The plain version at any size: code_match_ref a doc block at a
    time, so no (Q, d, C) tensor exists."""
    from repro_torch.kernels.code_match import ref as cm_ref

    out = torch.empty((Qc.shape[0], D.shape[0]), device=D.device)
    for lo in range(0, D.shape[0], block):
        out[:, lo:lo + block] = cm_ref.code_match_ref(D[lo:lo + block], Qc,
                                                      W)
    return out


def assert_code_match_close(got, want, ctx) -> float:
    err = float((got - want).abs().max())
    check(bool(torch.isclose(got, want, rtol=1e-5, atol=1e-5).all()),
          f"{ctx}: code_match off the plain version by {err}")
    return err


def assert_fused_parity(got, want, d, ctx) -> float:
    """Scores bit-equal everywhere, ids equal where finite, ids in range;
    -> max |score difference| over finite entries (0 when bit-equal)."""
    s_g, i_g = got
    s_w, i_w = want
    fin = torch.isfinite(s_w)
    err = float((s_g[fin] - s_w[fin]).abs().max()) if fin.any() else 0.0
    check(torch.equal(s_g, s_w), f"{ctx}: scores differ (max |d|={err})")
    check(torch.equal(i_g[fin], i_w[fin].to(i_g.dtype)),
          f"{ctx}: ids differ where finite")
    check(bool(((i_g >= 0) & (i_g < d)).all()), f"{ctx}: id out of range")
    return err


def phase_a(gen) -> dict:
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ref as fp_ref
    from repro_torch.obs import cost

    shapes = [(131072, 8, 400, 320, torch.int8, None),
              (5001, 9, 23, 33, torch.int16, None),
              (700, 5, 37, 17, torch.int32, None),
              (60, 3, 12, 32, torch.int8, 0.3)]
    rows = []
    worst = 0.0
    for d, Q, C, page, dt, live_frac in shapes:
        D = torch.randint(-8, 8, (d, C), generator=gen, device="cuda").to(dt)
        Qc = torch.randint(-8, 8, (Q, C), generator=gen, device="cuda").to(dt)
        W = torch.rand((Q, C), generator=gen, device="cuda")
        live = None
        if live_frac is not None:
            live = torch.rand(d, generator=gen, device="cuda") < live_frac
            check(0 < int(live.sum()) < page, "live case needs < page live")
        got = fp_kernel.fused_phase1_cuda(D, Qc, W, page, live)
        torch.cuda.synchronize()
        want = fp_ref.fused_phase1_ref(D, Qc, W, page, live)
        err = assert_fused_parity(got, want, d, (d, Q, C, page, str(dt)))
        if live is not None:
            n_live = int(live.sum())
            check(bool((torch.isfinite(got[0]).sum(1) == n_live).all()),
                  "live case: finite count != live docs")
        worst = max(worst, err)
        rows.append({"d": d, "Q": Q, "C": C, "page": page,
                     "dtype": str(dt).replace("torch.", ""),
                     "live": live is not None, "max_abs_err": err})
        if len(rows) == 1:
            first = D, Qc, W       # timed below: the slice's C and page
    # page = d = 5000: past the old 1024 limit
    D = torch.randint(-8, 8, (5000, 400), generator=gen,
                      device="cuda").to(torch.int8)
    Qc = torch.randint(-8, 8, (4, 400), generator=gen,
                       device="cuda").to(torch.int8)
    W = torch.rand((4, 400), generator=gen, device="cuda")
    got = fp_kernel.fused_phase1_cuda(D, Qc, W, 5000)
    torch.cuda.synchronize()
    err = assert_fused_parity(got, fp_ref.fused_phase1_ref(D, Qc, W, 5000),
                              5000, "page = d = 5000")
    check(bool(torch.isfinite(got[0]).all()), "page 5000: -inf slot")
    worst = max(worst, err)
    rows.append({"d": 5000, "Q": 4, "C": 400, "page": 5000,
                 "dtype": "int8", "live": False, "max_abs_err": err})
    # page 16,384: the accumulator and tile in the device workspace
    D = torch.randint(-8, 8, (65536, 400), generator=gen,
                      device="cuda").to(torch.int8)
    Qc = torch.randint(-8, 8, (8, 400), generator=gen,
                       device="cuda").to(torch.int8)
    W = torch.rand((8, 400), generator=gen, device="cuda")
    got = fp_kernel.fused_phase1_cuda(D, Qc, W, 16384)
    torch.cuda.synchronize()
    err = assert_fused_parity(got, fp_ref.fused_phase1_ref(D, Qc, W, 16384),
                              65536, "page 16384")
    worst = max(worst, err)
    rows.append({"d": 65536, "Q": 8, "C": 400, "page": 16384,
                 "dtype": "int8", "live": False, "max_abs_err": err,
                 "ms": cuda_ms(lambda: fp_kernel.fused_phase1_cuda(
                     D, Qc, W, 16384), 2)})
    del D, Qc, W, got
    d, Q, C, page, _, _ = shapes[0]
    D, Qc, W = first
    plain_ms = cuda_ms(lambda: fp_ref.fused_phase1_ref(D, Qc, W, page), 3)
    kernel_ms = cuda_ms(lambda: fp_kernel.fused_phase1_cuda(D, Qc, W, page),
                        5)
    bound, by = cost.bound_ms(cost.fused_phase1_work(d, Q, C, page, 1,
                                                     False))
    return {"phase": "A", "kernel": "fused_phase1", "shapes": rows,
            "max_abs_err": worst,
            "first_shape": {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
                            "bound_ms": bound, "bound_by": by}}


def phase_a_code_match(gen) -> dict:
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

    shapes = [(131072, 8, 400, torch.int8), (5001, 9, 23, torch.int16),
              (700, 5, 37, torch.int32), (1031, 3, 96, torch.int16),
              (3000, 40, 800, torch.int8)]
    rows = []
    worst = 0.0
    for d, Q, C, dt in shapes:
        hi = 100 if dt == torch.int8 else 3000
        D = torch.randint(-hi, hi, (d, C), generator=gen,
                          device="cuda").to(dt)
        Qc = D[torch.randint(0, d, (Q,), generator=gen, device="cuda")]
        Qc[:, ::3] = torch.randint(-hi, hi, Qc[:, ::3].shape, generator=gen,
                                   device="cuda").to(dt)
        W = torch.rand((Q, C), generator=gen, device="cuda")
        got = cm_kernel.code_match_cuda(D, Qc, W)
        torch.cuda.synchronize()
        err = assert_code_match_close(got, code_match_plain(D, Qc, W),
                                      (d, Q, C, str(dt)))
        check(torch.equal(got, fp_ref.match_scores(D, Qc, W)),
              f"{(d, Q, C, str(dt))}: not bit-equal to match_scores")
        worst = max(worst, err)
        rows.append({"d": d, "Q": Q, "C": C,
                     "dtype": str(dt).replace("torch.", ""),
                     "max_abs_err": err})
    return {"phase": "A", "kernel": "code_match", "shapes": rows,
            "max_abs_err": worst}


def phase_a_postings_walk(gen) -> tuple:
    """The posting walk at ``wiki-postings-closed``'s shapes: the kernel
    bit-equal to its plain version on the ranges and folded weights
    ``score_postings_batch`` hands it, its time beside its bound, the
    plain version's and the benchmark's 12-byte model's; the cut's and
    the walk's device time apart; -> (that line, the walk's (Q, d)
    scores, for the page selection's phase)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TrimFilter, VectorIndex
    from repro_torch.core.postings import lookup
    from repro_torch.kernels.postings_walk import kernel as pw_kernel
    from repro_torch.kernels.postings_walk import ref as pw_ref
    from repro_torch.obs import cost

    d, n, Q = N_DOCS, N_FEATURES, BATCH
    t = time.monotonic()
    index = VectorIndex.build(torch.randn((d, n), generator=gen,
                                          device="cuda"), device="cuda")
    rows = torch.randint(0, d, (Q,), generator=gen, device="cuda")
    q = index.vectors[rows] + 0.05 * torch.randn((Q, n), generator=gen,
                                                 device="cuda")
    _, qc, w = index.encode_queries(q, TrimFilter(0.05), None, "idf")
    lo, hi = lookup(index.postings, qc)
    hi = torch.where((w != 0) & (hi > lo), hi, lo)
    entries = int((hi - lo).sum())
    docs = index.postings.post_docs
    torch.cuda.synchronize()
    build_s = time.monotonic() - t

    def walk():
        return pw_kernel.postings_walk_cuda(docs, lo, hi, w)

    got = walk()
    torch.cuda.synchronize()
    want = pw_ref.postings_walk_ref(docs, lo, hi, w)
    check(torch.equal(got, want), "postings_walk: not bit-equal to its "
          "plain version at the cell's shapes")
    del want
    kernel_ms = cuda_ms(walk, 10)
    plain_ms = cuda_ms(lambda: pw_ref.postings_walk_ref(docs, lo, hi, w), 3)
    split = {}
    walk()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            walk()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "postings_" in ev.key and "_kernel" in ev.key:
            split[ev.key] = getattr(ev, "device_time_total",
                                    getattr(ev, "cuda_time_total", 0)) \
                / 5 / 1e3
    bound, by = cost.bound_ms(cost.postings_walk_work(entries, Q, d))
    model, _ = cost.bound_ms(cost.postings_work(entries, Q, d))
    C = docs.shape[0]
    props = torch.cuda.get_device_properties(0)
    tile, n_tiles = pw_kernel.tile_width(
        d, C, getattr(props, "shared_memory_per_multiprocessor", 233472),
        props.shared_memory_per_block_optin,
        pw_kernel.library().postings_walk_smem_bytes)
    del index, q, qc, w, lo, hi, docs
    torch.cuda.empty_cache()
    return {"phase": "A", "kernel": "postings_walk", "max_abs_err": 0.0,
            "d": d, "Q": Q, "C": C, "entries": entries,
            "tile": tile, "n_tiles": n_tiles, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "model_12B_ms": model, "kernels_ms": split,
            "index_build_s": build_s}, got


def phase_a_page_select(scores) -> dict:
    """The page selection at ``wiki-postings-closed``'s shapes (Q 32, d
    4,181,504, page 320) on a real walk's scores: the kernels bit-equal
    to the plain version, ``stable_topk``, on the card and on the CPU;
    their time beside their bound, the plain version's and
    ``torch.topk``'s (the library yardstick, which promises no order of
    ties); the host's issue of one call; each kernel's device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.rerank import stable_topk
    from repro_torch.kernels.page_select import kernel as ps_kernel
    from repro_torch.obs import cost

    Q, d = scores.shape

    def select():
        return ps_kernel.page_select_cuda(scores, PAGE)

    vals, pos = select()
    torch.cuda.synchronize()
    want_v, want_p = stable_topk(scores, PAGE)
    check(torch.equal(pos, want_p)
          and torch.equal(vals.view(torch.int32), want_v.view(torch.int32)),
          "page_select: not bit-equal to stable_topk on the card")
    cpu_v, cpu_p = stable_topk(scores.cpu(), PAGE)
    check(torch.equal(pos.cpu(), cpu_p) and torch.equal(vals.cpu(), cpu_v),
          "page_select: not bit-equal to stable_topk on the CPU")
    del vals, pos, want_v, want_p, cpu_v, cpu_p
    kernel_ms = cuda_ms(select, 20)
    plain_ms = cuda_ms(lambda: stable_topk(scores, PAGE), 5)
    library_ms = cuda_ms(lambda: torch.topk(scores, PAGE, dim=1), 10)
    issue = []
    for _ in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        select()
        issue.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    split = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            select()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "page_select_" in ev.key:
            split[ev.key] = getattr(ev, "device_time_total",
                                    getattr(ev, "cuda_time_total", 0)) \
                / 5 / 1e3
    bound, by = cost.bound_ms(cost.page_select_work(Q, d, PAGE))
    n_splits, split_len, n_tiles = ps_kernel.launch_plan(
        Q, d, PAGE, torch.cuda.get_device_properties(0).multi_processor_count)
    return {"phase": "A", "kernel": "page_select", "max_abs_err": 0.0,
            "Q": Q, "d": d, "page": PAGE, "n_splits": n_splits,
            "split_len": split_len, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by,
            "host_issue_ms": median_after_first(issue), "kernels_ms": split}


def quant_inputs(gen, d, n, Q):
    from repro_torch.core import quantize as tq

    V = torch.randn((d, n), generator=gen, device="cuda") * (
        0.1 + 3.9 * torch.rand((d, 1), generator=gen, device="cuda"))
    codes, scale, zero = tq.quantize_rows(V)
    return codes, scale, zero, torch.randn((Q, n), generator=gen,
                                           device="cuda")


def phase_a_quant(gen) -> dict:
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

    shapes = [(131072, 400, 8, 320, None), (5001, 23, 9, 33, None),
              (90, 12, 3, 48, 0.3), (5000, 400, 4, 5000, None),
              (3000, 401, 40, 1024, 0.9), (65536, 400, 8, 16384, None)]
    rows = []
    worst = 0.0
    for d, n, Q, page, live_frac in shapes:
        codes, scale, zero, q = quant_inputs(gen, d, n, Q)
        live = None
        if live_frac is not None:
            live = torch.rand(d, generator=gen, device="cuda") < live_frac
        got = fp_kernel.fused_phase1_quant_cuda(codes, scale, zero, q, page,
                                                live)
        torch.cuda.synchronize()
        want = fp_ref.fused_phase1_quant_ref(codes, scale, zero, q,
                                             min(page + 1, d), live)
        err = assert_quant_parity(got, want, d, (d, n, Q, page))
        split = fp_ref.fused_phase1_quant_split_ref(codes, scale, zero, q,
                                                    page, live)
        fin = torch.isfinite(split[0])
        check(torch.equal(got[0], split[0])
              and torch.equal(got[1][fin], split[1][fin]),
              f"{(d, n, Q, page)}: not bit-equal to quant_split_scores")
        del split, fin
        if live is not None and int(live.sum()) < page:
            check(bool((torch.isfinite(got[0]).sum(1)
                        == int(live.sum())).all()),
                  "live case: finite count != live docs")
        worst = max(worst, err)
        rows.append({"d": d, "n": n, "Q": Q, "page": page,
                     "live": live is not None, "max_abs_err": err,
                     "split_bit_equal": True})
        if page > 8192:        # the fold in device memory: timed
            rows[-1]["ms"] = cuda_ms(
                lambda: fp_kernel.fused_phase1_quant_cuda(codes, scale, zero,
                                                          q, page), 2)
    return {"phase": "A", "kernel": "fused_phase1_quant", "shapes": rows,
            "max_abs_err": worst}


def phase_a_rerank(gen) -> dict:
    """Both rerank bodies against the plain gather + einsum (rtol 1e-4 /
    atol 5e-5) at phase D's shapes and at the shapes that stress the bulk
    body's ring (P not a multiple of the rows a stage, more work items
    than blocks, n = 4 and 4096) or its inputs (duplicate ids, ids out of
    range -- clamped --, a table 4 bytes off 16-byte alignment, which
    takes the simple body); the body the launch plan picks, read from the
    wrapper's per-body launch counts; and the two bodies bit-equal where
    both run, as their one summation order says."""
    from repro_torch.core.rerank import normalize
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel
    from repro_torch.kernels.rerank_topk import ops as rk_ops
    from repro_torch.kernels.rerank_topk import ref as rk_ref

    shapes = [(131072, 32, 320, 400, "random"),
              (131072, 32, 8192, 400, "random"),
              (5000, 9, 777, 37, "random"), (1000, 3, 50, 401, "random"),
              (64, 1, 1, 1, "random"), (100000, 32, 3000, 400, "random"),
              (100000, 5, 999, 4, "random"), (20000, 4, 777, 4096, "random"),
              (50000, 8, 1000, 400, "duplicate"),
              (50000, 8, 1000, 400, "out_of_range"),
              (50000, 8, 1000, 400, "misaligned")]
    rows = []
    worst = 0.0
    for d, Q, P, n, kind in shapes:
        V = normalize(torch.randn((d, n), generator=gen, device="cuda"))
        if kind == "misaligned":                   # 4 bytes past 16
            buf = torch.empty(d * n + 1, device="cuda")
            buf[1:].copy_(V.flatten())
            V = buf[1:].view(d, n)
        lo, hi = {"duplicate": (0, 64), "out_of_range": (-d, 2 * d)}.get(
            kind, (0, d))
        ids = torch.randint(lo, hi, (Q, P), generator=gen, device="cuda",
                            dtype=torch.int32)
        if kind == "duplicate":
            ids[:, 1::2] = ids[:, ::2][:, :P // 2]
        q = normalize(torch.randn((Q, n), generator=gen, device="cuda"))
        want = rk_ref.candidate_scores_ref(V, ids.clamp(0, d - 1), q)
        expect = "bulk" if n % 4 == 0 and kind != "misaligned" else "simple"
        check(rk_kernel.plan_for(V, ids, q).body == expect,
              f"rerank {(d, Q, P, n, kind)}: plan is not {expect}")
        counts = dict(rk_ops.launches_by_body)
        n_launched = rk_ops.launches
        by_id = rk_ops.candidate_scores(V, ids, q)
        ran = [b for b in counts if rk_ops.launches_by_body[b] > counts[b]]
        rk_ops.launches_by_body.update(counts)     # not a main-path launch
        rk_ops.launches = n_launched
        check(ran == [expect], f"rerank {(d, Q, P, n, kind)}: launched "
              f"{ran}, want {expect}")
        got = {b: rk_kernel.rerank_scores_cuda(V, ids, q, body=b)
               for b in ("bulk", "simple") if b == "simple" or
               expect == "bulk"}
        torch.cuda.synchronize()
        errs = {}
        for b, t in got.items():
            errs[b] = float((t - want).abs().max())
            check(bool(torch.isclose(t, want, rtol=1e-4, atol=5e-5).all()),
                  f"rerank {(d, Q, P, n, kind)} {b}: off the plain version "
                  f"by {errs[b]}")
        check(torch.equal(by_id, got[expect]),
              f"rerank {(d, Q, P, n, kind)}: the wrapper's scores are not "
              f"the {expect} body's")
        if len(got) == 2:
            check(torch.equal(got["bulk"], got["simple"]),
                  f"rerank {(d, Q, P, n, kind)}: bodies not bit-equal")
        worst = max(worst, *errs.values())
        rows.append({"d": d, "Q": Q, "P": P, "n": n, "ids": kind,
                     "body": expect, "max_abs_err": errs})
    return {"phase": "A", "kernel": "rerank_topk", "shapes": rows,
            "max_abs_err": worst}


def assert_codes(got, want, ctx) -> int:
    """The bucketize contract: >= 99.99% of codes equal, every other one
    bucket off; -> the largest code difference."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{ctx}: dtype or shape differs")
    diff = (got.long() - want.long()).abs()
    share = float((diff == 0).float().mean())
    worst = int(diff.max())
    check(share >= 0.9999 and worst <= 1,
          f"{ctx}: {share:.6f} of codes equal, max difference {worst}")
    return worst


def phase_a_bucketize(gen) -> dict:
    from repro_torch.kernels.bucketize import kernel as bk_kernel
    from repro_torch.kernels.bucketize import ref as bk_ref

    rows = []
    worst = 0
    for B, n in ((131071, 400), (5001, 37), (64, 800), (3, 1)):
        x = torch.randn((B, n), generator=gen, device="cuda") * (
            0.1 + 3 * torch.rand((B, 1), generator=gen, device="cuda"))
        x[0] = 0.0
        for mode, param, dt in (("round", 100.0, torch.int8),
                                ("round", 1000.0, torch.int16),
                                ("floor", 0.1, torch.int8),
                                ("floor", 0.05, torch.int16)):
            got = bk_kernel.bucketize_cuda(x, mode, param, dt)
            torch.cuda.synchronize()
            ctx = (B, n, mode, param, str(dt))
            err = assert_codes(got, bk_ref.bucketize_ref(x, mode, param, dt),
                               ctx)
            check(bool((got[0] == 0).all()), f"{ctx}: zero row not 0")
            worst = max(worst, err)
            rows.append({"B": B, "n": n, "mode": mode, "param": param,
                         "dtype": str(dt).replace("torch.", ""),
                         "max_abs_err": err})
    return {"phase": "A", "kernel": "bucketize", "shapes": rows,
            "max_abs_err": worst}


def phase_b() -> dict:
    from repro_torch.core import encoding as enc

    gen = torch.Generator().manual_seed(1)
    x = torch.randn((65536, N_FEATURES), generator=gen)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    # exact bucket edges and their float neighbours, where a division by
    # width done as a multiply by 1/width would move a code
    edges = torch.arange(-10, 11, dtype=torch.float32) * 0.1
    edges = torch.cat([edges, torch.nextafter(edges, edges + 1),
                       torch.nextafter(edges, edges - 1)])
    x[: edges.numel() // N_FEATURES + 1].view(-1)[: edges.numel()] = edges
    xg = x.cuda()
    encoders = {"RoundingEncoder(2)": enc.RoundingEncoder(2),
                "IntervalEncoder(0.1)": enc.IntervalEncoder(0.1),
                "CombinedEncoder(R1,I0.1)": enc.CombinedEncoder(
                    enc.RoundingEncoder(1), enc.IntervalEncoder(0.1))}
    out = {}
    for name, e in encoders.items():
        cpu = e.encode(x)
        gpu = e.encode(xg).cpu()
        check(cpu.dtype == gpu.dtype, f"{name}: dtype differs")
        out[name] = int((cpu != gpu).sum())
    check(all(v == 0 for v in out.values()), f"encode mismatches {out}")
    from repro_torch.core import quantize as tq

    # the int8 table at mixed row scales, degenerate rows included
    xq = x * (0.05 + 5 * torch.rand((x.shape[0], 1), generator=gen))
    xq[-2] = 0.0
    xq[-1] = 1.75
    cpu = tq.quantize_table(xq)
    card = tq.quantize_table(xq.cuda())
    quant = {name: int((getattr(cpu, name) != getattr(card, name).cpu())
                       .sum()) for name in ("codes", "scale", "zero")}
    check(all(v == 0 for v in quant.values()), f"quant mismatches {quant}")
    return {"phase": "B", "rows": x.shape[0], "mismatches": out,
            "quant_mismatches": quant}


def serve_check(index, queries, src, results, ctx) -> dict:
    """The end-to-end checks of one served engine: shapes, ids in range,
    finite scores, the source row at rank 1 for >= 0.95 of the queries,
    reported scores within 1e-5 of a fresh fp32 cosine."""
    from repro_torch.core.rerank import normalize

    n = len(results)
    ids = torch.from_numpy(np.stack([r[0] for r in results]))
    scores = torch.from_numpy(np.stack([r[1] for r in results]))
    check(ids.shape == (n, K) and scores.shape == (n, K),
          f"{ctx}: result shapes")
    check(bool(((ids >= 0) & (ids < index.n_docs)).all()),
          f"{ctx}: id out of range")
    check(bool(torch.isfinite(scores).all()), f"{ctx}: non-finite score")
    rank1 = float((ids[:, 0].long() == src).float().mean())
    check(rank1 >= 0.95, f"{ctx}: source doc at rank 1 for only {rank1:.3f}")
    qn = normalize(torch.from_numpy(queries).cuda())
    exact = torch.einsum("qkn,qn->qk", index.vectors[ids.long().cuda()], qn)
    score_err = float((exact.cpu() - scores).abs().max())
    check(score_err <= 1e-5, f"{ctx}: scores off the exact cosine by "
          f"{score_err}")
    return {"rank1_share": rank1, "score_max_abs_err": score_err}


def make_engine(index, **engine_kw):
    """The engine phases C-I serve through.  They submit whole batches of
    BATCH and count launches and dispatch nodes a batch, so the wait for
    a batch to fill is long: a full batch dispatches on its last request
    either way, and a host stall while it is submitted cannot cut it in
    two (phase J serves at the 5 ms wait and counts dispatches)."""
    from repro_torch.core import TrimFilter
    from repro_torch.serve import BatchedSearchEngine

    return BatchedSearchEngine(index, batch_size=BATCH,
                               max_wait_s=SERVE_MAX_WAIT_S, k=K, page=PAGE,
                               trim=TrimFilter(0.05), **engine_kw)


def serve_engine(index, queries, ctx, reset_peak=True, profile=False,
                 after_first=None, **engine_kw):
    """Serve ``queries`` through BatchedSearchEngine in batches of BATCH
    (every request profiled with ``profile``; ``after_first`` called after
    the first batch) -> (results, per-batch seconds, peak device bytes).
    The engine is closed, so its counters and traces are final."""
    if reset_peak:
        torch.cuda.reset_peak_memory_stats()
    engine = make_engine(index, **engine_kw)
    kw = {"profile": True} if profile else {}
    batch_s, results = [], []
    try:
        for b in range(0, len(queries), BATCH):
            t = time.monotonic()
            futs = [engine.submit(q, **kw) for q in queries[b:b + BATCH]]
            results += [f.result(timeout=600) for f in futs]
            batch_s.append(time.monotonic() - t)
            progress(f"{ctx}: batch {b // BATCH} served in "
                     f"{batch_s[-1]:.3f} s")
            if b == 0 and after_first is not None:
                after_first()
    finally:
        engine.close()
    return results, batch_s, torch.cuda.max_memory_allocated()


def union_us(spans) -> float:
    """Length of the union of sorted (start, end) spans: the device's
    busy time."""
    busy, lo, hi = 0.0, None, None
    for s, e in spans:
        if hi is None or s > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return busy + (0.0 if hi is None else hi - lo)


def trace_batch(fn, enclose=None) -> dict:
    """One call of ``fn`` under torch.profiler, after one warm call: its
    host-clock time, the device's busy time (the union of its kernels and
    copies), the idle share of the call, its three largest kernels' device
    time, and its count of synchronise calls (CUDA runtime calls named
    ``*Synchronize``).  With ``enclose``, every thread is traced and the
    call must hold exactly one host range of that name, enclosing every
    kernel and copy of the call."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if enclose is not None:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], **kw) as prof:
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t) * 1e6
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    # the profiler mirrors a host range onto the device timeline as well
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == cuda and e.name != enclose)
    syncs = sum(1 for e in events
                if "Synchronize" in e.name and e.device_type == cpu)
    enclosed = None
    if enclose is not None:
        ranges = [e.time_range for e in events
                  if e.name == enclose and e.device_type == cpu]
        check(len(ranges) == 1, f"{len(ranges)} {enclose} ranges in the "
              "trace, want 1")
        r = ranges[0]
        check(bool(spans), "the trace holds no device time")
        lead = min(s for s, _, _ in spans) - r.start
        tail = r.end - max(e for _, e, _ in spans)
        check(lead >= 0 and tail >= 0, f"{enclose} does not enclose the "
              f"batch's kernels: {lead} us before the first, {tail} us "
              "after the last")
        enclosed = {"range": enclose, "device_events": len(spans),
                    "range_us": r.end - r.start, "lead_us": lead,
                    "tail_us": tail}
    by_name = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    busy = union_us([(s, e) for s, e, _ in spans])
    check(busy > 0, "the trace holds no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    out = {"host_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "top_kernels_ms": {name[:60]: us / 1e3 for name, us in top},
           "sync_calls": syncs}
    if enclosed is not None:
        out["enclosing_range"] = enclosed
    return out


def trace_engine_batch(index, qs, profile=False, enclose=None,
                       **engine_kw) -> tuple:
    """``trace_batch`` of one batch of ``qs`` served through a new
    BatchedSearchEngine -> (the trace, the batch's results)."""
    eng = make_engine(index, **engine_kw)
    sub = {"profile": True} if profile else {}
    out = []
    try:
        trace = trace_batch(
            lambda: out.append([f.result(timeout=600) for f in
                                [eng.submit(q, **sub) for q in qs]]),
            enclose=enclose)
    finally:
        eng.close()
    return trace, out[-1]


def median_after_first(xs):
    lat = sorted(xs[1:] or xs)
    return lat[len(lat) // 2]


def reset_launches() -> None:
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.code_match import ops as cm_ops
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.page_select import ops as ps_ops
    from repro_torch.kernels.postings_walk import ops as pw_ops
    from repro_torch.kernels.rerank_topk import ops as rk_ops

    fp_ops.launches = fp_ops.quant_launches = cm_ops.launches = 0
    bk_ops.launches = rk_ops.launches = pw_ops.launches = 0
    ps_ops.launches = 0
    rk_ops.launches_by_body.update(dict.fromkeys(rk_ops.launches_by_body, 0))


def phase_c(gen) -> tuple:
    from repro_torch.core import RoundingEncoder, TrimFilter, VectorIndex
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.fused_phase1 import ref as fp_ref
    from repro_torch.obs import cost

    n_docs = N_DOCS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    raw_state = gen.get_state()        # phase D draws the raw rows again
    vectors = torch.randn((n_docs, N_FEATURES), generator=gen, device="cuda")
    index = VectorIndex.build(vectors, encoder=RoundingEncoder(2),
                              device="cuda")
    del vectors
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    progress(f"index of {n_docs} docs built in {build_s:.1f} s")
    check(index.codes.dtype == torch.int8, "P2 codes must be int8")

    src = torch.randint(0, n_docs, (N_QUERIES,), generator=gen,
                        device="cuda")
    noise = torch.randn((N_QUERIES, N_FEATURES), generator=gen,
                        device="cuda") * NOISE
    queries = (index.vectors[src] + noise).cpu().numpy()
    src = src.cpu()

    build_peak = torch.cuda.max_memory_allocated()
    reset_launches()
    results, batch_s, _ = serve_engine(index, queries, "fused",
                                       engine="fused")
    launches = fp_ops.launches
    want = fp_kernel.KERNELS_PER_CALL * (N_QUERIES // BATCH)
    check(launches >= want,
          f"fused_phase1 launched {launches} CUDA kernels for "
          f"{N_QUERIES // BATCH} batches, want at least {want}")
    served = serve_check(index, queries, src, results, "fused")
    ids = np.stack([r[0] for r in results])
    gold_ids, _ = index.gold_topk(torch.from_numpy(queries).cuda(), k=K)
    gold = gold_ids.cpu().numpy()
    recall = sum(len(set(ids[i].tolist()) & set(gold[i].tolist()))
                 for i in range(N_QUERIES)) / (N_QUERIES * K)

    # the kernel alone at the served shape, against its plain version
    q, qcodes, w = index.encode_queries(
        torch.from_numpy(queries[:BATCH]).cuda(), TrimFilter(0.05), None,
        "idf")
    got = fp_kernel.fused_phase1_cuda(index.codes, qcodes, w, PAGE)
    torch.cuda.synchronize()
    t = time.monotonic()
    want = fp_ref.fused_phase1_stream(index.codes, qcodes, w, PAGE,
                                      block=16384)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t) * 1e3
    err = assert_fused_parity(got, want, n_docs, "served shape")
    progress(f"kernel matches plain at the served shape ({plain_ms:.0f} ms "
             "plain)")
    kernel_ms = cuda_ms(
        lambda: fp_kernel.fused_phase1_cuda(index.codes, qcodes, w, PAGE), 3)
    bound, by = cost.bound_ms(cost.fused_phase1_work(
        n_docs, BATCH, index.codes.shape[1], PAGE, 1, False))
    return {"phase": "C", "n_docs": n_docs, "n_features": N_FEATURES,
            "build_s": build_s,
            "batch_latency_s_median": median_after_first(batch_s),
            "batch_latency_s": batch_s,
            "max_memory_allocated": max(build_peak,
                                        torch.cuda.max_memory_allocated()),
            "launches": launches, **served, "recall_at_10_vs_gold": recall,
            "kernel": {"Q": BATCH, "ms": kernel_ms, "plain_ms": plain_ms,
                       "max_abs_err": err, "bound_ms": bound,
                       "bound_by": by}}, index, queries, src, raw_state


def alternate_ms(fns: dict, rounds: int = 3, reps: int = 20,
                 per_call: int = 1) -> dict:
    """{name: [device ms of one call, a round each]}: each fn timed by
    ``graph_ms`` in turns, the order reversed every other round (A B B A
    A B ...); ``per_call`` divides a fn that makes that many launches."""
    out = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            out[name].append(graph_ms(fns[name], reps) / per_call)
    return out


def rerank_case(index, q, cand, ctx, cold_sets: int = 0,
                alternated: bool = False) -> dict:
    """rerank_topk.ops.rerank_topk on ``cand`` against the core path:
    ids equal except where the k-th and (k+1)-th plain scores lie within
    the kernel's tolerance, scores bit-equal where the ids are; the
    kernel's scores within rtol 1e-4 / atol 5e-5 of the plain version;
    times of the kernel (the body the plan picks, and the simple body),
    the plain version (gather + einsum) and the einsum alone on
    pre-gathered rows (device time, from a CUDA graph: at page 320 the
    wrapper's host work outlasts the kernel, so ``call_ms`` times the calls
    as a caller makes them), the gathered signature (``ops.rerank_scores``
    over the pre-gathered rows, the like-for-like peer of the einsum), and
    the bound.  Those rows stay in L2 from launch to launch; with
    ``cold_sets`` the bodies and the einsum are timed again over that many
    random candidate sets of the same shape in turn, whose rows together
    outgrow the 50 MB L2, as a caller meets them.  ``alternated``: the
    kernel, the simple body and the einsum timed in turns three times each
    and their medians reported (with each run)."""
    from repro_torch.core.rerank import rerank_topk as core_rerank
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel
    from repro_torch.kernels.rerank_topk import ops as rk_ops
    from repro_torch.kernels.rerank_topk import ref as rk_ref

    V = index.vectors
    ids_g, s_g = rk_ops.rerank_topk(V, cand, q, K)
    ids_c, s_c = core_rerank(V, cand, q, K)
    cand = cand.to(torch.int32).contiguous()
    plain = rk_ref.candidate_scores_ref(V, cand, q)
    got = rk_kernel.rerank_scores_cuda(V, cand, q)
    err = float((got - plain).abs().max())
    check(bool(torch.isclose(got, plain, rtol=1e-4, atol=5e-5).all()),
          f"{ctx}: kernel off the plain version by {err}")
    srt = torch.sort(plain, dim=1, descending=True).values
    apart = srt[:, K - 1] - srt[:, K] > 5e-5 + 1e-4 * srt[:, K].abs()
    check(torch.equal(ids_g[apart], ids_c[apart]),
          f"{ctx}: ids differ from core.rerank.rerank_topk away from ties")
    same = ids_g == ids_c
    check(torch.equal(s_g[same], s_c[same]),
          f"{ctx}: scores of equal ids not bit-equal")
    gathered = V[cand.long()]
    # the gathered signature against the einsum on the same rows; these
    # timing calls are not main-path launches, so the counts are restored
    counts = (rk_ops.launches, dict(rk_ops.launches_by_body))
    g_err = float((rk_ops.rerank_scores(gathered, q) - plain).abs().max())
    check(g_err <= 5e-5 + 1e-4 * float(plain.abs().max()),
          f"{ctx}: gathered signature off the plain version by {g_err}")
    gathered_ms = graph_ms(lambda: rk_ops.rerank_scores(gathered, q), 20)
    rk_ops.launches = counts[0]
    rk_ops.launches_by_body.update(counts[1])
    plan = rk_kernel.plan_for(V, cand, q)
    bound, by = rerank_bound_ms(cand, index.n_features)
    fns = {"kernel": lambda: rk_kernel.rerank_scores_cuda(V, cand, q),
           "simple": lambda: rk_kernel.rerank_scores_cuda(V, cand, q,
                                                          body="simple"),
           "einsum": lambda: torch.einsum("qpn,qn->qp", gathered, q)}
    runs = alternate_ms(fns, rounds=3 if alternated else 1)
    med = {name: sorted(v)[len(v) // 2] for name, v in runs.items()}
    row = {"Q": cand.shape[0], "page": cand.shape[1], "body": plan.body,
           "plan": {"blocks": plan.blocks, "rows": plan.rows,
                    "stages": plan.stages, "smem": plan.smem},
           "ids_equal_share": float(same.float().mean()),
           "queries_apart": int(apart.sum()), "max_abs_err": err,
           "ms": med["kernel"], "simple_ms": med["simple"],
           "call_ms": cuda_ms(lambda: rk_kernel.rerank_scores_cuda(
               V, cand, q), 20),
           "plain_ms": graph_ms(lambda: rk_ref.candidate_scores_ref(
               V, cand, q), 5),
           "library_ms": med["einsum"],
           "gathered_ms": gathered_ms, "gathered_max_abs_err": g_err,
           "bound_ms": bound, "bound_by": by,
           "bound_share": bound / med["kernel"]}
    if alternated:
        row["alternated_ms"] = runs
        row["beats_library"] = med["kernel"] <= med["einsum"]
    del gathered
    if cold_sets:
        Q, P = cand.shape
        gen = torch.Generator(device="cuda").manual_seed(1)
        sets = [torch.randint(0, V.shape[0], (Q, P), generator=gen,
                              device="cuda", dtype=torch.int32)
                for _ in range(cold_sets)]
        rows = [V[s.long()] for s in sets]
        for s, g in zip(sets, rows):
            check(bool(torch.isclose(
                rk_kernel.rerank_scores_cuda(V, s, q),
                torch.einsum("qpn,qn->qp", g, q), rtol=1e-4,
                atol=5e-5).all()), f"{ctx}: cold set off the einsum")

        def rotate(body):
            return lambda: [rk_kernel.rerank_scores_cuda(V, s, q, body=body)
                            for s in sets]

        cold = alternate_ms({
            "bulk": rotate("bulk"), "simple": rotate("simple"),
            "einsum": lambda: [torch.einsum("qpn,qn->qp", g, q)
                               for g in rows]},
            rounds=3, reps=4, per_call=cold_sets)
        row["cold"] = {
            "sets": cold_sets,
            "rows_bytes": cold_sets * Q * P * index.n_features * 4,
            **{f"{name}_ms": sorted(v)[1] for name, v in cold.items()},
            "alternated_ms": cold,
            "bound_ms": sum(rerank_bound_ms(s, index.n_features)[0]
                            for s in sets) / cold_sets}
        del rows
    return row


def phase_d(gen, index, queries, src, raw_state) -> tuple:
    """Every other engine on phase C's index, then bucketize at full size
    and rerank_topk on the served candidates; -> (summary line, the
    ``kernels`` entries of code_match, fused_phase1_quant, bucketize and
    rerank_topk)."""
    import inspect

    from repro_torch.core import TrimFilter, VectorIndex
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ref as fp_ref
    from repro_torch.kernels.page_select import kernel as ps_kernel
    from repro_torch.obs import cost
    from repro_torch.serve import BatchedSearchEngine

    check(inspect.signature(BatchedSearchEngine).parameters["engine"]
          .default == "codes", "BatchedSearchEngine default is not codes")
    check(inspect.signature(VectorIndex.search).parameters["engine"]
          .default == "postings", "VectorIndex.search default is not "
          "postings")
    per_batch = N_QUERIES // BATCH
    ps = {"page_select": ps_kernel.KERNELS_PER_CALL * per_batch}
    want_launches = {"codes": ps,
                     "codes_pallas": {"code_match":
                                      cm_kernel.KERNELS_PER_CALL
                                      * per_batch, **ps},
                     "fused_int8": {"fused_phase1_quant":
                                    fp_kernel.KERNELS_PER_CALL * per_batch}}
    engines = {}
    launches = {}
    for name in ("codes", "codes_pallas", "fused_int8"):
        kw = {} if name == "codes" else {"engine": name}
        reset_launches()
        results, batch_s, peak = serve_engine(index, queries, name, **kw)
        got = launch_counts()
        for kname, n in want_launches[name].items():
            check(got[kname] >= n, f"{name}: {kname} launched {got[kname]} "
                  f"CUDA kernels for {per_batch} batches, want {n}")
            launches[kname] = got[kname]
        row = {"engine": name, "engine_named": bool(kw),
               "batch_latency_s_median": median_after_first(batch_s),
               "batch_latency_s": batch_s, "max_memory_allocated": peak,
               "launches": got,
               **serve_check(index, queries, src, results, name)}
        engines[name] = row
        emit({"phase": "D", **row})

    # one fused_int8 batch traced: device time against host time
    qs = torch.from_numpy(queries[:BATCH])
    engines["fused_int8"]["trace"] = trace_batch(lambda: index.search(
        qs, k=K, page=PAGE, trim=TrimFilter(0.05), engine="fused_int8"))
    # the same batch through a default engine: the index's synchronise
    # calls and the answers' two copies to the host, no more
    search_syncs = engines["fused_int8"]["trace"]["sync_calls"]
    eng_trace, _ = trace_engine_batch(index, queries[:BATCH],
                                      engine="fused_int8")
    check(eng_trace["sync_calls"] == search_syncs + 2,
          f"fused_int8: an engine batch made {eng_trace['sync_calls']} "
          f"synchronise calls, want the index's {search_syncs} + 2")
    engines["fused_int8"]["trace_engine"] = eng_trace
    emit({"phase": "D", "engine": "fused_int8",
          "trace": engines["fused_int8"]["trace"],
          "trace_engine": eng_trace})

    # index.search with no engine named: postings, exact; served twice,
    # and its phase-1 scores taken twice: each pair bit-equal
    lat, answers = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        t = time.monotonic()
        answers.append(index.search(qs, k=K, page=PAGE,
                                    trim=TrimFilter(0.05)))
        torch.cuda.synchronize()
        lat.append(time.monotonic() - t)
        progress(f"postings: batch served in {lat[-1]:.3f} s")
    ids, scores = answers[-1]
    served_equal = all(torch.equal(a, b) for a, b in zip(*answers))
    check(served_equal, "postings: two servings differ")
    _, qcodes, w = index.encode_queries(qs.cuda(), TrimFilter(0.05), None,
                                        "idf")
    first = index.phase1_scores(qcodes, w, "postings", None)
    scores_equal = torch.equal(first,
                               index.phase1_scores(qcodes, w, "postings",
                                                   None))
    check(scores_equal, "postings: two runs of phase-1 scores differ")
    del first, answers
    row = {"engine": "postings", "engine_named": False, "queries": BATCH,
           "batch_latency_s": lat, "batch_latency_s_median": lat[-1],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "runs_bit_equal": {"served": served_equal,
                              "phase1_scores": scores_equal},
           **serve_check(index, queries[:BATCH], src[:BATCH],
                         list(zip(ids.cpu().numpy(), scores.cpu().numpy())),
                         "postings")}
    engines["postings"] = row
    emit({"phase": "D", **row})

    # onehot on the first ONEHOT_DOCS rows: its (d, C * 201) one-hot table
    # is walked a block at a time, but a full-size pass is out of budget
    small = VectorIndex.build(index.vectors[:ONEHOT_DOCS],
                              encoder=index.encoder, device="cuda")
    s_src = torch.randint(0, ONEHOT_DOCS, (BATCH,), generator=gen,
                          device="cuda")
    s_q = (small.vectors[s_src] + torch.randn(
        (BATCH, N_FEATURES), generator=gen, device="cuda") * NOISE)
    s_q = s_q.cpu().numpy()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(2):
        t = time.monotonic()
        ids, scores = small.search(torch.from_numpy(s_q), k=K, page=PAGE,
                                   trim=TrimFilter(0.05), engine="onehot")
        torch.cuda.synchronize()
        lat.append(time.monotonic() - t)
    row = {"engine": "onehot", "engine_named": True, "queries": BATCH,
           "n_docs": ONEHOT_DOCS,
           "cut": f"index of the first {ONEHOT_DOCS} of {index.n_docs} rows",
           "batch_latency_s": lat, "batch_latency_s_median": lat[-1],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **serve_check(small, s_q, s_src.cpu(),
                         list(zip(ids.cpu().numpy(), scores.cpu().numpy())),
                         "onehot")}
    engines["onehot"] = row
    emit({"phase": "D", **row})
    del small

    # the kernels alone at Q 32 on the served index
    q, qcodes, w = index.encode_queries(qs.cuda(), TrimFilter(0.05), None,
                                        "idf")
    got = cm_kernel.code_match_cuda(index.codes, qcodes, w)
    plain = code_match_plain(index.codes, qcodes, w)
    cm_err = assert_code_match_close(got, plain, "code_match served shape")
    del got, plain
    cm_plain_ms = host_ms(lambda: code_match_plain(index.codes, qcodes, w))
    cm_ms = cuda_ms(lambda: cm_kernel.code_match_cuda(index.codes, qcodes,
                                                      w), 3)
    cm_bound, cm_by = cost.bound_ms(cost.code_match_work(
        index.n_docs, BATCH, index.codes.shape[1], 1))
    qt = index.quantized
    got = fp_kernel.fused_phase1_quant_cuda(qt.codes, qt.scale, qt.zero, q,
                                            PAGE)
    want = fp_ref.fused_phase1_quant_ref(qt.codes, qt.scale, qt.zero, q,
                                         PAGE + 1)
    qn_err = assert_quant_parity(got, want, index.n_docs, "quant served "
                                 "shape")
    qn_plain_ms = host_ms(lambda: fp_ref.fused_phase1_quant_ref(
        qt.codes, qt.scale, qt.zero, q, PAGE))
    qn_ms = cuda_ms(lambda: fp_kernel.fused_phase1_quant_cuda(
        qt.codes, qt.scale, qt.zero, q, PAGE), 3)
    qn_bound, qn_by = cost.bound_ms(cost.quant_work(
        index.n_docs, BATCH, N_FEATURES, PAGE, False))
    # bucketize at full size: the raw rows phase C's index was built from
    from repro_torch.core.rerank import normalize
    from repro_torch.kernels.bucketize import kernel as bk_kernel
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.bucketize import ref as bk_ref
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.kernels.rerank_topk import ops as rk_ops

    g = torch.Generator(device="cuda")
    g.set_state(raw_state)
    raw = torch.randn((index.n_docs, N_FEATURES), generator=g, device="cuda")
    check(torch.equal(normalize(raw[:65536]), index.vectors[:65536]),
          "raw rows drawn again differ from the index's")
    reset_launches()
    codes = bk_ops.encode(raw, index.encoder)
    torch.cuda.synchronize()
    bk_launches = launch_counts()["bucketize"]
    check(bk_launches == bk_kernel.KERNELS_PER_CALL,
          f"bucketize launched {bk_launches} CUDA kernels, want 1")
    bk_err = assert_codes(codes, index.codes, "bucketize 4,181,504 rows")
    bk_differ = int((codes != index.codes).sum())
    del codes
    scale = float(index.encoder.scale)
    dt = index.codes.dtype
    bk_ms = cuda_ms(lambda: bk_kernel.bucketize_cuda(raw, "round", scale,
                                                     dt), 5)

    def bk_plain():
        for lo in range(0, raw.shape[0], 1 << 18):
            bk_ref.bucketize_ref(raw[lo:lo + (1 << 18)], "round", scale, dt)

    bk_plain_ms = cuda_ms(bk_plain, 2)
    bk_bound, bk_by = cost.bound_ms(cost.bucketize_work(
        index.n_docs, N_FEATURES, index.codes.element_size()))
    del raw
    bucketize = {"B": index.n_docs, "n": N_FEATURES, "launches": bk_launches,
                 "codes_differing": bk_differ, "max_abs_err": bk_err,
                 "ms": bk_ms, "plain_ms": bk_plain_ms, "bound_ms": bk_bound,
                 "bound_by": bk_by, "library_ms": None}
    emit({"phase": "D", "kernel": "bucketize", **bucketize})

    # rerank_topk on the served candidates (page 320) and at page 8192
    reset_launches()
    _, cand = fp_ops.fused_phase1(index.codes, qcodes, w, PAGE)
    served = rerank_case(index, q, cand, "rerank page 320", cold_sets=8)
    rk_launches = launch_counts()["rerank_topk"]
    by_body = dict(rk_ops.launches_by_body)
    check(rk_launches >= 1, "rerank_topk launched no CUDA kernel")
    check(by_body["bulk"] >= 1, f"the bulk body did not run at n = "
          f"{N_FEATURES}: launches by body {by_body}")
    _, cand = fp_kernel.fused_phase1_cuda(index.codes, qcodes, w, 8192)
    wide = rerank_case(index, q, cand, "rerank page 8192", alternated=True)
    del cand
    rerank = {**served, "launches": rk_launches, "launches_by_body": by_body,
              "page_8192": wide}
    emit({"phase": "D", "kernel": "rerank_topk", **rerank})

    kernels = {
        "bucketize": bucketize,
        "rerank_topk": rerank,
        "code_match": {"launches": launches["code_match"],
                       "max_abs_err": cm_err, "ms": cm_ms,
                       "plain_ms": cm_plain_ms, "bound_ms": cm_bound,
                       "bound_by": cm_by},
        "fused_phase1_quant": {"launches": launches["fused_phase1_quant"],
                               "max_abs_err": qn_err, "ms": qn_ms,
                               "plain_ms": qn_plain_ms, "bound_ms": qn_bound,
                               "bound_by": qn_by,
                               "batch_latency_s_median": engines[
                                   "fused_int8"]["batch_latency_s_median"]}}
    summary = {"phase": "D", "n_docs": index.n_docs,
               "batch_latency_s_median": {
                   k: v["batch_latency_s_median"] for k, v in engines.items()},
               "max_memory_allocated": {
                   k: v["max_memory_allocated"] for k, v in engines.items()},
               "kernels_at_Q32": kernels}
    return summary, kernels


def full_plane(n: int) -> dict:
    """The whole observability plane for ``n`` requests, as engine
    arguments: a registry, a tracer keeping every trace (annotated), a
    slow log capturing every request, a build watch."""
    from repro_torch.obs import CompileWatch, MetricsRegistry, SlowLog, Tracer

    reg = MetricsRegistry()
    return {"metrics": reg,
            "tracer": Tracer(capacity=n, sample=1.0, annotate=True),
            "slowlog": SlowLog(threshold_s=0.0, capacity=n, metrics=reg),
            "compile_watch": CompileWatch(metrics=reg)}


def plane_checks(results, plane, name, n_batches, ctx) -> dict:
    """The plane's own checks on a profiled run: every tree tiles its root
    (1e-6 s, the reference's), its phase1 node names the kernel path, the
    batch's dispatch nodes add up to the dispatch-latency histogram,
    submitted == completed == n, no failure, one ``kernel_path`` count a
    batch, the slow log captured every request, no build after the warm-up
    batch, and one ``engine_requests_completed_total`` series of value n;
    -> the dispatch children's medians over batches 2.. (ms), and the
    first batch's phase1 node."""
    from repro_torch.obs import format_profile_tree, prometheus_text

    n = len(results)
    reg, watch = plane["metrics"], plane["compile_watch"]
    kernel = name if name in ("fused", "fused_int8") else "composed"
    phases, disp_total = {}, 0.0
    for i, (_, _, tree) in enumerate(results):
        kids = {c["name"]: c for c in tree["children"]}
        check(list(kids) == ["queue_wait", "batch_form", "dispatch"],
              f"{ctx}: tree children {list(kids)}")
        tiled = sum(c["duration_s"] for c in kids.values())
        check(abs(tree["duration_s"] - tiled) < 1e-6,
              f"{ctx}: phases {tiled} s do not tile the root "
              f"{tree['duration_s']} s")
        disp = kids["dispatch"]
        first = results[i - i % BATCH][2]["children"][2]
        check(disp == first, f"{ctx}: request {i} has its own dispatch node")
        p1 = [c for c in disp["children"] if c["name"] == "phase1"]
        check(len(p1) == 1 and p1[0]["attrs"]["kernel"] == kernel,
              f"{ctx}: phase1 node {p1}")
        if i % BATCH == 0:
            disp_total += disp["duration_s"]
            for c in disp["children"]:
                phases.setdefault(c["name"], []).append(c["duration_s"])
    hist = reg.histogram("engine.dispatch.latency_s").snapshot()
    check(hist["count"] == n_batches
          and abs(hist["sum"] - disp_total) < 1e-6,
          f"{ctx}: dispatch nodes {disp_total} s against the histogram's "
          f"{hist['sum']} s over {hist['count']} batches")
    req = {k: reg.value(f"engine.requests.{k}")
           for k in ("submitted", "completed", "failed")}
    check(req == {"submitted": n, "completed": n, "failed": 0},
          f"{ctx}: requests {req}")
    paths = reg.series("engine.kernel_path")
    check(paths == {f"engine={name}": n_batches},
          f"{ctx}: kernel_path {paths}, want {n_batches} on {name}")
    slow = plane["slowlog"].stats()
    check(slow["captured"] == slow["seen"] == n,
          f"{ctx}: slow log {slow}")
    check(watch.compiles_steady_state == 0,
          f"{ctx}: {watch.compiles_steady_state} builds after warm-up")
    watch.check()
    done = [ln for ln in prometheus_text(reg.snapshot()).splitlines()
            if ln.startswith("repro_engine_requests_completed_total")]
    check(done == [f"repro_engine_requests_completed_total {n}"],
          f"{ctx}: exposition {done}")
    tracer = plane["tracer"].stats()
    check(tracer["seen"] == tracer["retained"] == n,
          f"{ctx}: tracer {tracer}")
    return {"split_ms": {k: median_after_first(v) * 1e3
                         for k, v in phases.items()},
            "dispatch_ms": median_after_first(
                [results[b][2]["children"][2]["duration_s"]
                 for b in range(0, n, BATCH)]) * 1e3,
            "builds": watch.compiles_total,
            "tree": format_profile_tree(results[0][2]).splitlines()}


def phase_g(index, queries, src) -> tuple:
    """The observability plane on phase C's index: each engine served
    bare, with metrics only, and with the full plane and a profile on
    every request; answers bit-equal across the three, the plane's checks,
    and one fused_int8 batch traced three times (``index.search``, a bare
    engine, the full plane with the ``repro.engine.dispatch`` range around
    its kernels) with their synchronise calls reconciled; -> (summary
    line, the kernels' launches)."""
    from repro_torch.core import TrimFilter
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.page_select import kernel as ps_kernel
    from repro_torch.kernels.postings_walk import kernel as pw_kernel
    from repro_torch.obs import MetricsRegistry

    ps = {"page_select": ps_kernel.KERNELS_PER_CALL}
    per = {"fused": {"fused_phase1": fp_kernel.KERNELS_PER_CALL},
           "fused_int8": {"fused_phase1_quant": fp_kernel.KERNELS_PER_CALL},
           "codes_pallas": {"code_match": cm_kernel.KERNELS_PER_CALL,
                            **ps},
           "postings": {"postings_walk": pw_kernel.KERNELS_PER_CALL, **ps},
           "codes": ps}
    t_phase = time.monotonic()
    rows, launches, answers_4x2 = {}, {}, {}
    for name in G_ENGINES:
        qs = queries[:BATCH] if name == "codes" else queries
        n_b = len(qs) // BATCH
        reset_launches()
        bare, bare_s, _ = serve_engine(
            index, qs, f"G {name} bare", engine=name,
            metrics=MetricsRegistry(enabled=False))
        met, met_s, _ = serve_engine(index, qs, f"G {name} metrics",
                                     engine=name, metrics=MetricsRegistry())
        plane = full_plane(len(qs))
        full, full_s, _ = serve_engine(
            index, qs, f"G {name} full", profile=True,
            after_first=plane["compile_watch"].mark_steady, engine=name,
            **plane)
        got = launch_counts()
        for kname, c in got.items():
            want = 3 * n_b * per[name].get(kname, 0)
            check(c == want, f"G {name}: {kname} launched {c} CUDA kernels, "
                  f"want {want}")
            launches[kname] = launches.get(kname, 0) + c
        same = all(np.array_equal(b[0], m[0]) and np.array_equal(b[1], m[1])
                   and np.array_equal(b[0], f[0])
                   and np.array_equal(b[1], f[1])
                   for b, m, f in zip(bare, met, full))
        check(same, f"G {name}: bare, metrics-only and full-plane answers "
              "differ")
        row = {"engine": name, "queries": len(qs),
               "batch_latency_s_median": {
                   "bare": median_after_first(bare_s),
                   "metrics": median_after_first(met_s),
                   "full_profiled": median_after_first(full_s)},
               "batch_latency_s": {"bare": bare_s, "metrics": met_s,
                                   "full_profiled": full_s},
               "bit_equal": same, "launches": got,
               **serve_check(index, qs, src[:len(qs)], bare, f"G {name}"),
               **plane_checks(full, plane, name, n_b, f"G {name}")}
        rows[name] = row
        emit({"phase": "G", **row})

    # one fused_int8 batch traced through the index, through a bare
    # engine and through the full plane: bare serving adds no synchronise
    # call but the answers' two copies to the host, a profile one fence
    # for each of its phases
    qs = queries[:BATCH]
    traces = {"index_search": trace_batch(lambda: index.search(
        torch.from_numpy(qs), k=K, page=PAGE, trim=TrimFilter(0.05),
        engine="fused_int8"))}
    traces["bare"], _ = trace_engine_batch(
        index, qs, engine="fused_int8",
        metrics=MetricsRegistry(enabled=False))
    traces["full_profiled"], res = trace_engine_batch(
        index, qs, profile=True, enclose="repro.engine.dispatch",
        engine="fused_int8", **full_plane(2 * BATCH))
    syncs = {k: t["sync_calls"] for k, t in traces.items()}
    check(syncs["bare"] == syncs["index_search"] + 2,
          f"G: a bare engine batch made {syncs['bare']} synchronise calls, "
          f"want the index's {syncs['index_search']} + 2")
    fences = len(res[0][2]["children"][2]["children"])
    check(syncs["full_profiled"] == syncs["bare"] + fences,
          f"G: the full plane made {syncs['full_profiled']} synchronise "
          f"calls, want bare's {syncs['bare']} + {fences} fences")
    line = {"phase": "G", "n_docs": index.n_docs, "engines": list(rows),
            "batch_latency_s_median": {n: r["batch_latency_s_median"]
                                       for n, r in rows.items()},
            "split_ms": {n: r["split_ms"] for n, r in rows.items()},
            "trace_fused_int8": traces, "profile_fences": fences,
            "launches": launches,
            "phase_s": time.monotonic() - t_phase}
    return line, launches


def f_workload(index):
    """Phase F's seeded data: the appended unit rows on the card, the 128
    queries (64 noisy base rows, 60 noisy sealed rows, 4 noisy tail rows)
    with their source ids, and the 4,096 ids to delete (8 base and 8 sealed
    query sources among them, and every tail row)."""
    from repro_torch.core.rerank import normalize

    rng = np.random.default_rng(0)
    n = index.n_docs
    g = torch.Generator(device="cuda").manual_seed(6)
    new = normalize(torch.randn((F_NEW + F_TAIL, N_FEATURES), generator=g,
                                device="cuda"))
    src_base = rng.choice(n, 64, replace=False)
    src_sealed = rng.choice(F_NEW, 60, replace=False)
    src_tail = F_NEW + rng.choice(F_TAIL, 4, replace=False)
    rows = torch.cat([index.vectors[torch.from_numpy(src_base).cuda()],
                      new[torch.from_numpy(np.concatenate(
                          [src_sealed, src_tail])).cuda()]])
    queries = (rows + torch.randn(rows.shape, generator=g, device="cuda")
               * NOISE).cpu().numpy()
    src = np.concatenate([src_base, n + src_sealed, n + src_tail])
    del_base = np.concatenate([src_base[:8], rng.choice(
        np.setdiff1d(np.arange(n), src_base), F_DELETE_BASE - 8,
        replace=False)])
    del_sealed = n + np.concatenate([src_sealed[:8], rng.choice(
        np.setdiff1d(np.arange(F_NEW), src_sealed), F_DELETE_SEALED - 8,
        replace=False)])
    victims = np.concatenate([del_base, del_sealed,
                              n + F_NEW + np.arange(F_TAIL)])
    return new, queries, src, victims


def f_stage(idx, base, new, queries, src, dead, stage, launches,
            engines=F_ENGINES, plane=False) -> tuple:
    """Serve ``queries`` through every engine of ``engines`` on ``idx``
    and check each answer: no deleted id, every live appended source at
    rank 1 and >= 0.95 of the live base sources, scores within 1e-5 of a
    fresh fp32 cosine, and the kernels launched as the generations
    predict; with ``plane``, through the full observability plane with a
    profile on every request, held to ``plane_checks`` and to a phase1
    node carrying ``base``, ``gen0``... and ``active`` whose candidates
    add up; -> ({engine: (ids, scores)}, {engine: row of numbers})."""
    from repro_torch.core.rerank import normalize
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.page_select import kernel as ps_kernel
    from repro_torch.kernels.postings_walk import kernel as pw_kernel

    n_base = base.n_docs
    gens = idx.n_segments + (1 if idx.seg_capacity else 0)
    # one query phase per shard and per group's row-block of a batch
    n_batches = len(queries) // BATCH * idx.n_shards * idx.n_replicas
    per = fp_kernel.KERNELS_PER_CALL
    ps = ps_kernel.KERNELS_PER_CALL       # one page cut a shard's search
    want = {"fused": {"fused_phase1": per * (1 + gens)},
            "fused_int8": {"fused_phase1_quant": per * (1 + gens)},
            "codes_pallas": {"code_match": (1 + gens)
                             * cm_kernel.KERNELS_PER_CALL,
                             "page_select": ps},
            "postings": {"code_match": gens * cm_kernel.KERNELS_PER_CALL,
                         "postings_walk": pw_kernel.KERNELS_PER_CALL,
                         "page_select": ps},
            "codes": {"code_match": gens * cm_kernel.KERNELS_PER_CALL,
                      "page_select": ps}}
    answers, rows = {}, {}
    qn = normalize(torch.from_numpy(queries).cuda())
    appended = idx.n_ids > n_base
    dead_t = torch.from_numpy(np.asarray(sorted(dead), np.int64))
    for name in engines:
        reset_launches()
        obs = full_plane(len(queries)) if plane else {}
        results, batch_s, _ = serve_engine(
            idx, queries, f"{stage} {name}", reset_peak=False,
            profile=plane, after_first=obs["compile_watch"].mark_steady
            if plane else None, engine=name, **obs)
        got = launch_counts()
        for kname, n in got.items():
            launches[kname] = launches.get(kname, 0) + n
            check(n == want[name].get(kname, 0) * n_batches,
                  f"{stage} {name}: {kname} launched {n} CUDA kernels, "
                  f"want {want[name].get(kname, 0) * n_batches} at {gens} "
                  f"generations, {idx.n_shards} x {idx.n_replicas} shards")
        ids = torch.from_numpy(np.stack([r[0] for r in results])).long()
        scores = torch.from_numpy(np.stack([r[1] for r in results]))
        check(bool(((ids >= 0) & (ids < idx.n_ids)).all()),
              f"{stage} {name}: id out of range")
        check(bool(torch.isfinite(scores).all()),
              f"{stage} {name}: non-finite score")
        check(not bool(torch.isin(ids, dead_t).any()),
              f"{stage} {name}: a deleted id surfaced")
        live_src = ~torch.isin(torch.from_numpy(src), dead_t)
        hit = ids[:, 0] == torch.from_numpy(src)
        base_q = torch.arange(len(src)) < 64
        base_share = float(hit[base_q & live_src].float().mean())
        check(base_share >= 0.95, f"{stage} {name}: base sources at rank "
              f"1 for only {base_share:.3f}")
        if appended:
            check(bool(hit[~base_q & live_src].all()),
                  f"{stage} {name}: a live appended source missed rank 1")
        ig = ids.cuda()
        vecs = torch.where(
            (ig < n_base)[..., None], base.vectors[ig.clamp(max=n_base - 1)],
            new[(ig - n_base).clamp(0, new.shape[0] - 1)])
        exact = torch.einsum("qkn,qn->qk", vecs, qn).cpu()
        err = float((exact - scores).abs().max())
        check(err <= 1e-5, f"{stage} {name}: scores off the exact cosine "
              f"by {err}")
        answers[name] = (ids.numpy(), scores.numpy())
        rows[name] = {"batch_latency_s_median": median_after_first(batch_s),
                      "batch_latency_s": batch_s, "launches": got,
                      "base_rank1_share": base_share,
                      "score_max_abs_err": err}
        if plane:
            rows[name].update(plane_checks(results, obs, name, n_batches,
                                           f"{stage} {name}"))
            want_gens = ["base"] + [f"gen{i}" for i in range(idx.n_segments)]
            want_gens += ["active"] if idx.n_active else []
            for _, _, tree in results[::BATCH]:
                (p1,) = [c for c in tree["children"][2]["children"]
                         if c["name"] == "phase1"]
                parts = {c["name"]: c["attrs"]["candidates"]
                         for c in p1["children"] if c["name"] != "group0"}
                check(list(parts) == want_gens,
                      f"{stage} {name}: phase1 children {list(parts)}")
                check(sum(parts.values()) == p1["attrs"]["candidates"],
                      f"{stage} {name}: candidates {parts} do not add up "
                      f"to {p1['attrs']['candidates']}")
            rows[name]["candidates"] = parts
    return answers, {"generations": gens, "n_ids": idx.n_ids,
                     "engines": rows}


def match_scores_blocked(D, Qc, W, block=16384):
    """``ref.match_scores`` at any size, a doc block at a time: a row's
    tree depends on C only, so the bits are those of one call."""
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

    out = torch.empty((Qc.shape[0], D.shape[0]), device=D.device)
    for lo in range(0, D.shape[0], block):
        out[:, lo:lo + block] = fp_ref.match_scores(D[lo:lo + block], Qc, W)
    return out


def quant_split_blocked(codes, scale, zero, q, page, live, block=65536):
    """``ref.fused_phase1_quant_split_ref`` at any size: the split scores
    a doc block at a time (each cell exact float64 sums, so the bits are
    those of one call), then the mask and the stable top-page."""
    from repro_torch.core.rerank import stable_topk
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

    qsum = q.sum(dim=-1)
    s = torch.empty((q.shape[0], codes.shape[0]), device=q.device)
    for lo in range(0, codes.shape[0], block):
        hi = lo + block
        s[:, lo:hi] = fp_ref.quant_split_scores(codes[lo:hi], scale[lo:hi],
                                                zero[lo:hi], q, qsum)
    top_s, top_i = stable_topk(s.masked_fill(~live[None, :], float("-inf")),
                               page)
    return top_s, top_i.to(torch.int32)


def hold_live(ids, scores, live, ctx) -> None:
    """No tombstoned row among a kernel's finite ids, and every query's
    finite count the live rows the page can hold."""
    fin = torch.isfinite(scores)
    check(not bool((~live[ids.long().clamp(0, live.shape[0] - 1)]
                    & fin).any()), f"{ctx}: a tombstoned row surfaced")
    want = min(int(live.sum()), scores.shape[1])
    check(bool((fin.sum(1) == want).all()),
          f"{ctx}: finite count != {want} live rows the page holds")


def hold_table(codes, live, quant, q, qcodes, w, where, errs,
               scorers) -> None:
    """The kernels of ``scorers`` (``fused_phase1``, ``code_match``) and
    ``fused_phase1_quant`` held to their plain versions on one table with
    its live mask, at page ``min(d, PAGE)``: ``fused_phase1`` bit-equal to
    ``ref.fused_phase1_stream``, ``code_match`` bit-equal to
    ``ref.match_scores`` and within rtol / atol 1e-5 of
    ``code_match_plain``, ``fused_phase1_quant`` bit-equal to the split
    reference and within ``assert_quant_parity`` of
    ``fused_phase1_quant_ref``; the largest |error| of each goes into
    ``errs``."""
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.fused_phase1 import ref as fp_ref

    c8, sc, zp = quant
    d = codes.shape[0]
    page = min(d, PAGE)
    if "fused_phase1" in scorers:
        got = fp_kernel.fused_phase1_cuda(codes, qcodes, w, page, live)
        want = fp_ref.fused_phase1_stream(codes, qcodes, w, page, live,
                                          block=16384)
        errs["fused_phase1"] = max(errs["fused_phase1"], assert_fused_parity(
            got, want, d, where))
        hold_live(got[1], got[0], live, where)
        del got, want
    if "code_match" in scorers:
        got = cm_kernel.code_match_cuda(codes, qcodes, w)
        errs["code_match"] = max(errs["code_match"], assert_code_match_close(
            got, code_match_plain(codes, qcodes, w), where))
        check(torch.equal(got, match_scores_blocked(codes, qcodes, w)),
              f"{where}: code_match not bit-equal to match_scores")
        del got
    got = fp_kernel.fused_phase1_quant_cuda(c8, sc, zp, q, page, live)
    want = fp_ref.fused_phase1_quant_ref(c8, sc, zp, q, min(page + 1, d),
                                         live)
    errs["fused_phase1_quant"] = max(errs["fused_phase1_quant"],
                                     assert_quant_parity(got, want, d, where))
    del want
    split = quant_split_blocked(c8, sc, zp, q, page, live)
    fin = torch.isfinite(split[0])
    check(torch.equal(got[0], split[0])
          and torch.equal(got[1][fin], split[1][fin]),
          f"{where}: fused_phase1_quant not bit-equal to the split "
          "reference")
    hold_live(got[1], got[0], live, where)


def served_weights(idx, queries) -> tuple:
    """(unit queries, their codes, the trimmed idf weights) as a sharded
    index's search hands them to its kernels."""
    from repro_torch.core import TrimFilter
    from repro_torch.core.filtering import expand_mask, feature_mask
    from repro_torch.core.postings import idf_weights
    from repro_torch.core.rerank import normalize

    q = normalize(torch.from_numpy(queries).cuda())
    qcodes = idx.encoder.encode(q)
    mask = expand_mask(feature_mask(q, trim=TrimFilter(0.05)),
                       qcodes.shape[-1])
    return q, qcodes, torch.where(
        mask, idf_weights(idx.token_df(q), idx.n_ids), 0.0)


def f_holds(idx, queries, ctx) -> dict:
    """Each kernel of the lifecycle held to its plain version on the
    tombstoned tables and live masks the served path hands it, at Q 32:
    ``fused_phase1`` and ``fused_phase1_quant`` on the base (when
    ``idx`` has tombstones in it), ``fused_phase1``,
    ``fused_phase1_quant`` and ``code_match`` on the first sealed segment
    and the active buffer.
    ``fused_phase1`` bit-equal to ``ref.fused_phase1_stream`` (the tile
    fold of ``fused_phase1_ref``, whose (Q, d, C) temporary the full base
    cannot hold), ``fused_phase1_quant`` bit-equal to the split reference and
    within ``assert_quant_parity`` of ``fused_phase1_quant_ref``,
    ``code_match`` bit-equal to ``ref.match_scores`` and within rtol /
    atol 1e-5 of ``code_match_plain``; -> {kernel: max |error|}."""
    q, qcodes, w = served_weights(idx, queries[:BATCH])
    errs = {"fused_phase1": 0.0, "fused_phase1_quant": 0.0,
            "code_match": 0.0}
    tables = []
    if not bool(idx.live.all()):
        tables.append(("base", idx.codes[0], idx.live[0],
                       [t[0] for t in idx._quant_base()]))
    tables += [(f"generation 0 of {idx.n_segments}", s.codes[0], s.live[0],
                [t[0] for t in s.quantized()]) for s in idx.segments[:1]]
    if idx.seg_capacity:
        tables.append(("active buffer", idx.seg_codes[0], idx.seg_live[0],
                       [t[0] for t in idx._quant_active()]))
    for name, codes, live, quant in tables:
        where = (f"{ctx} {name} ({codes.shape[0]} rows, "
                 f"{int((~live).sum())} dead)")
        hold_table(codes, live, quant, q, qcodes, w, where, errs,
                   ("fused_phase1",) if name == "base"
                   else ("fused_phase1", "code_match"))
    check(len(tables) >= 2, f"{ctx}: {len(tables)} tables held")
    return {"tables": [t[0] for t in tables], "max_abs_err": errs}


def f_history(index, seal_threshold, new, queries, src, victims,
              launches, mesh=None, tag="F", plane=True) -> tuple:
    """The lifecycle on a ShardedVectorIndex over phase C's index (one
    shard, or ``mesh``'s layout), served through one BatchedSearchEngine:
    16 ingest batches between served batches, the tail, delete, merge
    (segmented only), compact, with ``f_stage`` after each stage (and,
    segmented with ``plane``, the full observability plane and two traced
    batches at 17 generations); -> ({stage: answers}, the history's
    numbers)."""
    from repro_torch.core import TrimFilter
    from repro_torch.dist import ShardedVectorIndex
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import BatchedSearchEngine

    sidx = ShardedVectorIndex.from_index(index, seal_threshold=seal_threshold,
                                         mesh=mesh)
    check(sidx.vectors.data_ptr() == index.vectors.data_ptr()
          and (sidx.n_shards > 1 or sidx.post_docs.data_ptr()
               == index.postings.post_docs.data_ptr()),
          "from_index copied the base")
    kind = (f"{tag} " + ("flat" if seal_threshold is None else "segmented")
            + (f" {sidx.n_shards}x{sidx.n_replicas}" if mesh else ""))
    answers, stages = {}, {}
    answers["built"], stages["built"] = f_stage(
        sidx, index, new, queries, src, (), f"{kind} built", launches)
    eng = BatchedSearchEngine(sidx, batch_size=BATCH, max_wait_s=0.005, k=K,
                              page=PAGE, trim=TrimFilter(0.05),
                              engine="fused", donate_ingest=True)
    add_s = []
    try:
        reset_launches()
        for b in range(F_NEW // F_BATCH + 1):
            lo = (b % (len(queries) // BATCH)) * BATCH
            futs = [eng.submit(q) for q in queries[lo:lo + BATCH]]
            for f in futs:
                f.result(timeout=600)
            rows = (new[b * F_BATCH:(b + 1) * F_BATCH] if b < F_NEW // F_BATCH
                    else new[F_NEW:])
            t = time.monotonic()
            first = eng.add_documents(rows)
            torch.cuda.synchronize()
            add_s.append(time.monotonic() - t)
            check(first == index.n_docs + b * F_BATCH,
                  f"ingest batch {b}: first id {first}")
        for kname, n in launch_counts().items():
            launches[kname] = launches.get(kname, 0) + n
        idx = eng.index
        check(idx.n_segments == (16 if seal_threshold else 0)
              and idx.n_active == (F_TAIL if seal_threshold
                                   else F_NEW + F_TAIL),
              f"{kind}: {idx.n_segments} segments, {idx.n_active} active")
        progress(f"{kind}: ingested, median add "
                 f"{median_after_first(add_s):.4f} s")
        answers["ingested"], stages["ingested"] = f_stage(
            idx, index, new, queries, src, (), f"{kind} ingested", launches)
        if seal_threshold is not None and plane:
            # every engine again with the full plane, profiled: the same
            # bits as the bare pass
            planed, stages["ingested"]["plane"] = f_stage(
                idx, index, new, queries, src, (), f"{kind} ingested plane",
                launches, plane=True)
            for name, (ids, scores) in planed.items():
                check(np.array_equal(ids, answers["ingested"][name][0])
                      and np.array_equal(scores,
                                         answers["ingested"][name][1]),
                      f"F ingested {name}: full plane and bare answers "
                      "differ")
            # one batch of each fused engine traced at 17 generations
            qs = torch.from_numpy(queries[:BATCH])
            stages["ingested"]["trace"] = {
                name: trace_batch(lambda: idx.search(
                    qs, k=K, page=PAGE, trim=TrimFilter(0.05), engine=name))
                for name in ("fused", "fused_int8")}
        t = time.monotonic()
        eng.delete(victims)
        torch.cuda.synchronize()
        delete_s = time.monotonic() - t
        idx = eng.index
        check(idx.n_tombstones == len(victims),
              f"{kind}: {idx.n_tombstones} tombstones")
        progress(f"{kind}: deleted {len(victims)} ids in {delete_s:.3f} s")
        dead = set(victims.tolist())
        answers["deleted"], stages["deleted"] = f_stage(
            idx, index, new, queries, src, dead, f"{kind} deleted", launches,
            engines=F_ENGINES + ("codes",))
        if plane:
            stages["deleted"]["holds"] = f_holds(idx, queries,
                                                 f"{kind} deleted")
        merge_s = merged = None
        if seal_threshold is not None:
            t = time.monotonic()
            merged = idx.merge_segments(0, 16)
            torch.cuda.synchronize()
            merge_s = time.monotonic() - t
            check(eng.swap_index(merged, expected=idx), "merge swap lost")
            check(merged.n_segments == 1
                  and merged.n_reclaimed == F_DELETE_SEALED
                  and merged.n_tombstones == len(victims) - F_DELETE_SEALED,
                  "merge_segments(0, 16) reclaimed the wrong rows")
            idx = merged
            progress(f"{kind}: merged 16 segments in {merge_s:.3f} s")
            answers["merged"], stages["merged"] = f_stage(
                idx, index, new, queries, src, dead, f"{kind} merged",
                launches)
        t = time.monotonic()
        packed = idx.compact()
        torch.cuda.synchronize()
        compact_s = time.monotonic() - t
        check(eng.swap_index(packed, expected=idx), "compact swap lost")
        check(packed.n_docs == index.n_docs + F_NEW + F_TAIL
              and packed.n_segments == 0 and packed.n_tombstones == 0,
              f"{kind}: compacted to {packed.n_docs} docs")
        progress(f"{kind}: compacted in {compact_s:.3f} s")
        idx = merged = None        # only the compacted index stays alive
        answers["compacted"], stages["compacted"] = f_stage(
            packed, index, new, queries, src, dead, f"{kind} compacted",
            launches)
    finally:
        eng.close()
    return answers, {"add_s": add_s,
                     "add_s_median": median_after_first(add_s),
                     "delete_s": delete_s, "merge_s": merge_s,
                     "compact_s": compact_s, "stages": stages}


def phase_f(index) -> tuple:
    """The segment lifecycle at full width on phase C's index; -> (the
    phase line, the kernels' launches in its main-path runs)."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.monotonic()
    index.quantized                # shared by both histories' fused_int8
    new, queries, src, victims = f_workload(index)
    launches = {}
    flat, flat_info = f_history(index, None, new, queries, src, victims,
                                launches)
    torch.cuda.empty_cache()
    seg, seg_info = f_history(index, F_SEAL, new, queries, src, victims,
                              launches)
    same = {}
    for stage, other in (("built", "built"), ("ingested", "ingested"),
                         ("deleted", "deleted"), ("merged", "deleted"),
                         ("compacted", "compacted")):
        for name, (ids, scores) in seg[stage].items():
            f_ids, f_scores = flat[other][name]
            ok = np.array_equal(ids, f_ids) and np.array_equal(scores,
                                                               f_scores)
            check(ok, f"F {stage} {name}: segmented and flat answers differ")
            same[f"{stage}/{name}"] = ok
    gens = {st: seg_info["stages"][st]["generations"]
            for st in ("built", "ingested", "merged", "compacted")}
    check(list(gens.values()) == [0, 17, 2, 0],
          f"F: generations by stage {gens}")
    holds = {kind: info["stages"]["deleted"]["holds"]
             for kind, info in (("flat", flat_info), ("segmented", seg_info))}
    hold_err = {name: max(h["max_abs_err"][name] for h in holds.values())
                for name in holds["flat"]["max_abs_err"]}
    latency = {st: {name: row["batch_latency_s_median"] for name, row
                    in seg_info["stages"][st]["engines"].items()}
               for st in seg_info["stages"]}
    line = {"phase": "F", "n_base": index.n_docs, "n_appended": F_NEW + F_TAIL,
            "batches": f"{F_NEW // F_BATCH} x {F_BATCH} + {F_TAIL}",
            "seal_threshold": F_SEAL, "deleted": {
                "base": F_DELETE_BASE, "sealed": F_DELETE_SEALED,
                "active": F_TAIL},
            "generations_by_stage": gens,
            "bit_identical_segmented_vs_flat": same,
            "kernels_vs_plain_after_delete": holds,
            "kernels_max_abs_err": hold_err,
            "add_s_median": seg_info["add_s_median"],
            "add_s": seg_info["add_s"], "delete_s": seg_info["delete_s"],
            "merge_s": seg_info["merge_s"],
            "compact_s": seg_info["compact_s"],
            "batch_latency_s_median": latency,
            "plane_at_17": {
                name: {k: row[k] for k in ("batch_latency_s_median",
                                           "split_ms", "candidates")}
                for name, row in seg_info["stages"]["ingested"]["plane"]
                ["engines"].items()},
            "flat": {k: flat_info[k] for k in ("add_s_median", "delete_s",
                                               "compact_s")},
            "launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "phase_s": time.monotonic() - t_phase,
            "stages": seg_info["stages"]}
    return line, launches


def filesystem(path) -> tuple:
    """-> ({mount, type, device} of the mount holding ``path``, from
    /proc/mounts: the longest mount point that prefixes it; its free
    bytes)."""
    real = str(pathlib.Path(path).resolve())
    best = ("", "?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fs = line.split()[:3]
            if ((real + "/").startswith(mnt.rstrip("/") + "/")
                    and len(mnt) >= len(best[0])):
                best = (mnt, fs, dev)
    st = os.statvfs(real)
    return {"mount": best[0], "type": best[1], "device": best[2]}, \
        st.f_bavail * st.f_frsize


def h_bytes_needed(index) -> int:
    """The store's largest moment, the compact commit: the old base and
    the compacted base, both referenced by retained commits, the appended
    rows three times over (sealed segments, the merged segment, the
    translog) and 1 GiB of manifests, small blobs and slack."""
    C = index.codes.shape[1] * index.codes.element_size()
    row = N_FEATURES * 4 + C + 1
    n_new = F_NEW + F_TAIL
    return (row * index.n_docs + row * (index.n_docs + n_new)
            + 3 * (row + 4) * n_new + (1 << 30))


def h_same_leaves(live, rec, ctx) -> None:
    """Every leaf of ``rec`` -- base, posting tables, active buffer, each
    segment's leaves and posting tables -- and every counter equal to
    ``live``'s, on the card."""
    for name in ("vectors", "codes", "post_docs", "post_codes", "offsets",
                 "live", "seg_vectors", "seg_codes", "seg_gids", "seg_live"):
        a, b = getattr(live, name), getattr(rec, name)
        check(a.dtype == b.dtype and a.shape == b.shape
              and bool(torch.equal(a, b)), f"H {ctx}: leaf {name} differs")
    check(len(live.segments) == len(rec.segments),
          f"H {ctx}: {len(rec.segments)} segments, want "
          f"{len(live.segments)}")
    for i, (sa, sb) in enumerate(zip(live.segments, rec.segments)):
        check((sa.n_rows, sa.tombstones) == (sb.n_rows, sb.tombstones),
              f"H {ctx}: segment {i} counters")
        for name in ("vectors", "codes", "gids", "live", "post_docs",
                     "post_codes"):
            check(bool(torch.equal(getattr(sa, name), getattr(sb, name))),
                  f"H {ctx}: segment {i} leaf {name} differs")
    for name in ("n_docs", "n_appended", "seg_base", "active_tombstones",
                 "shard_tombstones", "seal_threshold", "index_best",
                 "encoder"):
        check(getattr(live, name) == getattr(rec, name),
              f"H {ctx}: {name} differs")


def h_recover(store_dir, live, index, new, queries, src, dead, stage,
              launches, answers) -> dict:
    """Recover from ``store_dir`` alone on the card and hold the result to
    the never-crashed ``live``: seq, every leaf, and the answers of four
    engines bit-identical (``answers``: the live index's, by engine);
    -> the recovery's numbers."""
    from repro_torch.store import recover

    stats = {}
    t = time.monotonic()
    rec, seq = recover(store_dir, device="cuda", stats=stats)
    recover_s = time.monotonic() - t
    check(rec.device.type == "cuda", f"H {stage}: recovered on {rec.device}")
    check(seq == live.translog_seq,
          f"H {stage}: recovered seq {seq}, live {live.translog_seq}")
    progress(f"H {stage}: recovered in {recover_s:.2f} s ({stats})")
    h_same_leaves(live.inner, rec, stage)
    got, rows = f_stage(rec, index, new, queries, src, dead,
                        f"H {stage} recovered", launches)
    for name, (ids, scores) in got.items():
        check(np.array_equal(ids, answers[name][0])
              and np.array_equal(scores, answers[name][1]),
              f"H {stage} {name}: recovered and live answers differ")
    out = {"recover_s": recover_s, **stats, "seq": seq,
           "generations": rows["generations"],
           "batch_latency_s_median": {
               name: r["batch_latency_s_median"]
               for name, r in rows["engines"].items()}}
    del rec
    torch.cuda.empty_cache()
    return out


def h_commit(store, idx, what) -> dict:
    stats = {}
    t = time.monotonic()
    store.commit(idx, stats=stats)
    out = {"s": time.monotonic() - t, **stats}
    progress(f"H: {what} commit in {out['s']:.2f} s, {stats}")
    return out


def phase_h(index, f_add_s=None) -> tuple:
    """The durability plane at full width on phase C's index: a store in
    a fresh directory under the checkout's build/, a baseline commit, F's
    ingest and deletes through a durable engine with a commit after the
    8th batch, then three kill-and-recover rounds (after the deletes,
    after a merge and its commit, after a compact and its commit), each
    held leaf for leaf and answer for answer to the never-crashed index;
    -> (the phase line, the kernels' launches in its main-path runs)."""
    import inspect
    import resource
    import shutil
    import tempfile

    from repro_torch.dist import ShardedVectorIndex
    from repro_torch.obs import MetricsRegistry
    from repro_torch.store import DurableIndex, Store

    t_phase = time.monotonic()
    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_store_", dir=root)
    try:
        fs, free = filesystem(store_dir)
        need = h_bytes_needed(index)
        progress(f"H: store in {store_dir} on {fs}, {free} bytes free, "
                 f"{need} needed")
        if free < need:
            raise RuntimeError(
                f"H: the disk holding {store_dir} has {free} bytes free; the "
                f"store's largest moment needs {need}")
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        torch.cuda.reset_peak_memory_stats()
        new, queries, src, victims = f_workload(index)
        reg = MetricsRegistry()
        launches = {}
        commits = {}

        store = Store(store_dir, durability="request", metrics=reg)
        sidx = ShardedVectorIndex.from_index(index, seal_threshold=F_SEAL)
        base_stats = {}
        t = time.monotonic()
        live = store.open_index(sidx, stats=base_stats)
        commits["baseline"] = {"s": time.monotonic() - t, **base_stats}
        progress(f"H: baseline commit in {commits['baseline']['s']:.2f} s, "
                 f"{base_stats}")
        check(base_stats["blobs_written"] == 2
              and base_stats["bytes_written"] == base_stats["bytes_total"],
              f"H: baseline commit {base_stats}")

        eng = make_engine(live, engine="fused", donate_ingest=True)
        check("donate" not in inspect.signature(
            eng.index.add_documents).parameters,
            "H: a durable index's add_documents takes donate")
        add_s = []
        try:
            for b in range(F_NEW // F_BATCH + 1):
                lo = (b % (len(queries) // BATCH)) * BATCH
                for f in [eng.submit(q) for q in queries[lo:lo + BATCH]]:
                    f.result(timeout=600)
                rows = (new[b * F_BATCH:(b + 1) * F_BATCH]
                        if b < F_NEW // F_BATCH else new[F_NEW:])
                prev = eng.index.inner
                versions = [t_._version for t_ in (
                    prev.seg_vectors, prev.seg_codes, prev.seg_gids,
                    prev.seg_live)]
                t = time.monotonic()
                first = eng.add_documents(rows)
                torch.cuda.synchronize()
                add_s.append(time.monotonic() - t)
                check(first == index.n_docs + b * F_BATCH,
                      f"H: ingest batch {b}: first id {first}")
                check(versions == [t_._version for t_ in (
                    prev.seg_vectors, prev.seg_codes, prev.seg_gids,
                    prev.seg_live)],
                      f"H: ingest batch {b} wrote the served index in place")
                if b == 7:
                    commits["after_8_batches"] = h_commit(
                        store, eng.index, "incremental")
            t = time.monotonic()
            eng.delete(victims)
            torch.cuda.synchronize()
            delete_s = time.monotonic() - t
            live = eng.index
        finally:
            eng.close()
        inc = commits["after_8_batches"]
        check(inc["blobs_written"] == 8
              and inc["bytes_written"] < 0.01 * inc["bytes_total"],
              f"H: the commit after 8 batches wrote {inc}")
        check(live.translog_seq == F_NEW // F_BATCH + 2
              and live.n_segments == 16 and live.n_active == F_TAIL
              and live.n_tombstones == len(victims),
              f"H: seq {live.translog_seq}, {live.n_segments} segments, "
              f"{live.n_active} active, {live.n_tombstones} tombstones")
        progress(f"H: ingested, median add {median_after_first(add_s):.4f} s;"
                 f" deleted in {delete_s:.3f} s")
        dead = set(victims.tolist())

        def served(idx, stage):
            answers, rows = f_stage(idx, index, new, queries, src, dead,
                                    f"H {stage} live", launches)
            return answers, {name: r["batch_latency_s_median"]
                             for name, r in rows["engines"].items()}

        # the kill: the engine is gone and the store is dropped unclosed;
        # the restarted process recovers from the directory alone
        recoveries, latency = {}, {}
        answers, latency["deleted"] = served(live.inner, "deleted")
        recoveries["deleted"] = h_recover(
            store_dir, live, index, new, queries, src, dead, "deleted",
            launches, answers)
        first = recoveries["deleted"]
        check(first["replay_ops"] == 10
              and first["replay_rows"] == 8 * F_BATCH + F_TAIL,
              f"H: replayed {first['replay_ops']} ops, "
              f"{first['replay_rows']} rows")
        store = Store(store_dir, durability="request", metrics=reg)
        live = DurableIndex(live.inner, store, live.translog_seq)

        t = time.monotonic()
        live = live.merge_segments(0, 16)
        torch.cuda.synchronize()
        merge_s = time.monotonic() - t
        commits["merged"] = h_commit(store, live, "merge")
        check(commits["merged"]["blobs_written"] == 3,
              f"H: the merge commit wrote {commits['merged']}")
        answers, latency["merged"] = served(live.inner, "merged")
        recoveries["merged"] = h_recover(
            store_dir, live, index, new, queries, src, dead, "merged",
            launches, answers)

        t = time.monotonic()
        live = live.compact()
        torch.cuda.synchronize()
        compact_s = time.monotonic() - t
        commits["compacted"] = h_commit(store, live, "compact")
        check(commits["compacted"]["blobs_written"] == 2
              and commits["compacted"]["bytes_written"]
              == commits["compacted"]["bytes_total"],
              f"H: the compact commit wrote {commits['compacted']}")
        answers, latency["compacted"] = served(live.inner, "compacted")
        recoveries["compacted"] = h_recover(
            store_dir, live, index, new, queries, src, dead, "compacted",
            launches, answers)
        check(recoveries["compacted"]["replay_ops"] == 0,
              "H: ops replayed past the compact commit")
        stats = store.stats()
        check(stats["commits"] == 4 and stats["commit"]["seq"]
              == live.translog_seq, f"H: store stats {stats}")
        store.close()
        line = {
            "phase": "H", "store": store_dir, "filesystem": fs,
            "free_bytes": free, "bytes_needed": need,
            "durability": "request", "commits": commits,
            "recoveries": recoveries,
            "add_s_median": median_after_first(add_s), "add_s": add_s,
            "f_add_s_median": f_add_s, "delete_s": delete_s,
            "merge_s": merge_s, "compact_s": compact_s,
            "batch_latency_s_median": latency,
            "bit_identical_recovered_vs_live": True,
            "donated": False,
            "launches": launches, "store_stats": stats,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "max_rss_bytes": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024,
            "max_rss_bytes_before": rss0,
            "phase_s": time.monotonic() - t_phase}
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    return line, launches


def i_answers(results) -> tuple:
    return (np.stack([r[0] for r in results]),
            np.stack([r[1] for r in results]))


def i_serve(index, s4, s42, queries, src) -> tuple:
    """Each engine of G_ENGINES served through BatchedSearchEngine on the
    one-shard index, on 4 x 1, on 4 x 2 and on 4 x 2 with the stream
    transport, with the checks of phase I step 2; -> ({engine: row},
    the kernels' launches in the sharded runs, {engine: the 4 x 2 answers
    (ids, scores)})."""
    from repro_torch.core import TrimFilter
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.page_select import kernel as ps_kernel
    from repro_torch.kernels.postings_walk import kernel as pw_kernel

    ps = {"page_select": ps_kernel.KERNELS_PER_CALL}
    per = {"fused": {"fused_phase1": fp_kernel.KERNELS_PER_CALL},
           "fused_int8": {"fused_phase1_quant": fp_kernel.KERNELS_PER_CALL},
           "codes_pallas": {"code_match": cm_kernel.KERNELS_PER_CALL,
                            **ps},
           "postings": {"postings_walk": pw_kernel.KERNELS_PER_CALL, **ps},
           "codes": ps}
    rows, launches, answers_4x2 = {}, {}, {}
    for name in G_ENGINES:
        qs = queries[:BATCH] if name == "codes" else queries
        n_b = len(qs) // BATCH
        flat, flat_s, _ = serve_engine(index, qs, f"I {name} one shard",
                                       reset_peak=False, engine=name)
        row = {"batch_latency_s_median": {
            "1x1": median_after_first(flat_s)}, "launches_per_batch": {}}
        answers = {}
        for label, idx, merge in (("4x1", s4, None), ("4x2", s42, None),
                                  ("4x2 stream", s42, "stream")):
            reset_launches()
            res, batch_s, _ = serve_engine(idx, qs, f"I {name} {label}",
                                           reset_peak=False, engine=name,
                                           merge=merge)
            got = launch_counts()
            calls = n_b * idx.n_shards * idx.n_replicas
            for kname, c in got.items():
                want = calls * per[name].get(kname, 0)
                check(c == want, f"I {name} {label}: {kname} launched {c} "
                      f"CUDA kernels, want {want}")
                launches[kname] = launches.get(kname, 0) + c
            answers[label] = i_answers(res)
            row["batch_latency_s_median"][label] = median_after_first(
                batch_s)
            row["launches_per_batch"][label] = {
                k: c // n_b for k, c in got.items() if c}
            if label == "4x2":
                row.update(serve_check(index, qs, src[:len(qs)], res,
                                       f"I {name} 4x2"))
        ids, scores = answers_4x2[name] = answers["4x2"]
        for other in ("4x1", "4x2 stream"):
            check(np.array_equal(ids, answers[other][0])
                  and np.array_equal(scores, answers[other][1]),
                  f"I {name}: 4x2 and {other} answers differ")
        # the union of the shards' pages holds the one-shard page, and a
        # hit's reported score is the same einsum in both; the selections
        # differ in the page scorer, so an exact tie may move an ulp
        top1 = i_answers(flat)[1][:, 0]
        short = float(np.max(top1 - scores[:, 0]))
        check(short <= 1e-6, f"I {name}: a sharded top-1 cosine is "
              f"{short} below the one-shard index's")
        q = torch.from_numpy(qs[:BATCH])
        kw = dict(k=K, page=PAGE, trim=TrimFilter(0.05), engine=name)
        for what, got in (
                ("live_groups=(1,)", s42.search(q, live_groups=(1,), **kw)),
                ("replica_group(1)", s42.replica_group(1).search(q, **kw)),
                ("replica_group(0)", s42.replica_group(0).search(q, **kw))):
            check(np.array_equal(got[0].cpu().numpy(), ids[:BATCH])
                  and np.array_equal(got[1].cpu().numpy(), scores[:BATCH]),
                  f"I {name}: {what} answers differ from the whole")
        row["top1_margin_over_one_shard_min"] = float(
            np.min(scores[:, 0] - top1))
        row["bit_equal"] = True
        rows[name] = row
        progress(f"I {name}: {row['batch_latency_s_median']}")
    return rows, launches, answers_4x2


def i_depth(index, queries) -> dict:
    """Phase I step 4: the first I_DEPTH rows at page >= n_ids, where every
    live doc reaches the exact rescore.  4 x 2 (both transports) against
    one shard for all six engines; then F's history at a sixteenth of its
    size on a segmented 4 x 2, a flat 4 x 1 and a segmented one-shard
    index, all three bit-equal at every stage; -> (the step's numbers,
    the 65,536-row index, the segmented 4 x 2 history after its merge)."""
    from repro_torch.core import TrimFilter, VectorIndex
    from repro_torch.core.postings import build_postings
    from repro_torch.core.rerank import normalize
    from repro_torch.launch import make_shard_mesh

    t0 = time.monotonic()
    small = VectorIndex(index.vectors[:I_DEPTH], index.codes[:I_DEPTH],
                        build_postings(index.codes[:I_DEPTH]),
                        index.encoder, index.index_best)
    q = torch.from_numpy(queries[:BATCH])
    one = small.shard(seal_threshold=F_SEAL)
    wide = small.shard(make_shard_mesh(4, 2))
    for name in ENGINES:
        kw = dict(k=K, page=I_DEPTH, trim=TrimFilter(0.05), engine=name)
        want = one.search(q, **kw)
        for merge in ("gather", "stream"):
            got = wide.search(q, merge=merge, **kw)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"I depth {I_DEPTH} {name} {merge}: 4x2 and one shard "
                  "differ")
    del wide
    g = torch.Generator(device="cuda").manual_seed(7)
    new = normalize(torch.randn((16 * I_BATCH + I_TAIL, N_FEATURES),
                                generator=g, device="cuda"))
    rng = np.random.default_rng(7)
    n = I_DEPTH
    victims = np.concatenate([
        rng.choice(n, 512, replace=False),
        n + rng.choice(16 * I_BATCH, I_BATCH // 2 - I_TAIL, replace=False),
        n + 16 * I_BATCH + np.arange(I_TAIL)])
    hist = {"segmented 4x2": small.shard(make_shard_mesh(4, 2),
                                         seal_threshold=F_SEAL),
            "flat 4x1": small.shard(make_shard_mesh(4), seal_threshold=None),
            "segmented 1x1": one}

    def same(stage):
        idxs = list(hist.values())
        for name in F_ENGINES:
            kw = dict(k=K, page=2 * idxs[0].n_ids, trim=TrimFilter(0.05),
                      engine=name)
            want = idxs[-1].search(q, **kw)
            for label, idx in hist.items():
                for merge in ("gather", "stream"):
                    got = idx.search(q, merge=merge, **kw)
                    check(torch.equal(got[0], want[0])
                          and torch.equal(got[1], want[1]),
                          f"I depth {stage} {name} {label} {merge}: "
                          "answers differ from one shard")

    same("built")
    for b in range(16):
        rows = new[b * I_BATCH:(b + 1) * I_BATCH]
        hist = {k: v.add_documents(rows) for k, v in hist.items()}
    hist = {k: v.add_documents(new[16 * I_BATCH:]) for k, v in hist.items()}
    check(hist["segmented 4x2"].n_segments == 16
          and hist["segmented 4x2"].n_active == I_TAIL,
          "I depth: the ingest did not seal 16 segments")
    same("ingested")
    hist = {k: v.delete(victims) for k, v in hist.items()}
    same("deleted")
    for k in ("segmented 4x2", "segmented 1x1"):
        hist[k] = hist[k].merge_segments(0, 16)
    same("merged")
    durable = hist["segmented 4x2"]
    hist = {k: v.compact() for k, v in hist.items()}
    same("compacted")
    del hist
    return {"n_docs": I_DEPTH, "engines_at_build": list(ENGINES),
            "lifecycle_engines": list(F_ENGINES),
            "appended": 16 * I_BATCH + I_TAIL, "deleted": len(victims),
            "bit_equal_4x2_flat_4x1_one_shard": True,
            "s": time.monotonic() - t0}, small, durable


def i_store(s4, small, durable, queries) -> dict:
    """Phase I step 6: the 4-shard index of phase C's rows committed and
    recovered onto 4 x 2 (every leaf and answer identical); at depth, a
    segmented 4 x 2 history made durable, killed and recovered onto 4 x 2
    with its ops replayed, and a one-shard commit restored onto 4 shards
    equal to from_index; -> the step's numbers."""
    import shutil
    import tempfile

    from repro_torch.core import TrimFilter
    from repro_torch.launch import make_shard_mesh
    from repro_torch.store import Store, latest_commit, recover, restore
    from repro_torch.store import write_commit

    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_shards_", dir=root)
    out = {}
    q = torch.from_numpy(queries[:BATCH])
    try:
        fs, free = filesystem(store_dir)
        row = N_FEATURES * 4 + s4.codes.shape[-1] * s4.codes.element_size() + 1
        need = row * s4.n_docs + (2 << 30)     # one base, the depth stores
        check(free >= need, f"I: {free} bytes free under {store_dir}, "
              f"{need} needed")
        store = Store(os.path.join(store_dir, "full"))
        stats = {}
        t = time.monotonic()
        store.open_index(s4, stats=stats)
        out["commit_s"] = time.monotonic() - t
        out["commit_bytes"] = stats["bytes_written"]
        store.close()
        rstats = {}
        t = time.monotonic()
        rec, seq = recover(os.path.join(store_dir, "full"),
                           mesh=make_shard_mesh(4, 2), stats=rstats)
        out["recover_s"] = time.monotonic() - t
        out["recover"] = rstats
        check(rec.n_shards == 4 and rec.n_replicas == 2 and seq == 0,
              f"I: recovered {rec.n_shards} x {rec.n_replicas} at seq {seq}")
        h_same_leaves(s4, rec, "I 4x2 recovery")
        for name in F_ENGINES:
            kw = dict(k=K, page=PAGE, trim=TrimFilter(0.05), engine=name)
            a, b = s4.search(q, **kw), rec.search(q, **kw)
            check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                  f"I {name}: recovered 4x2 and live 4x1 answers differ")
        del rec
        torch.cuda.empty_cache()
        progress(f"I: 4-shard commit in {out['commit_s']:.2f} s, recovery "
                 f"onto 4x2 in {out['recover_s']:.2f} s")

        # at depth: ops replayed onto 4 x 2, and a one-shard commit
        # re-placed onto 4 shards
        path = os.path.join(store_dir, "depth")
        store = Store(path)
        live = store.open_index(durable)
        g = torch.Generator(device="cuda").manual_seed(8)
        live = live.add_documents(torch.randn((3 * I_BATCH, N_FEATURES),
                                              generator=g, device="cuda"))
        live = live.delete(np.arange(0, durable.n_ids, 97))
        store.close()
        store = Store(path)
        rec, seq = store.recover(mesh=make_shard_mesh(4, 2))
        store.close()
        check(seq == live.translog_seq == 2,
              f"I depth: recovered seq {seq}, live {live.translog_seq}")
        h_same_leaves(live.inner, rec.inner, "I depth 4x2 recovery")
        for name in ENGINES:
            kw = dict(k=K, page=2 * live.n_ids, trim=TrimFilter(0.05),
                      engine=name)
            a, b = live.search(q, **kw), rec.search(q, **kw)
            check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                  f"I depth {name}: recovered and live answers differ")
        path = os.path.join(store_dir, "one")
        write_commit(path, small.shard(), 0)
        got = restore(latest_commit(path), mesh=make_shard_mesh(4))
        h_same_leaves(small.shard(make_shard_mesh(4)), got,
                      "I one-shard commit onto 4 shards")
        out.update(depth_replay_ops=2, one_shard_onto_four=True,
                   filesystem=fs)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    return out


def phase_i(index, queries, src, smi, one_shard_medians=None) -> tuple:
    """Doc-sharding and replica groups on phase C's index (run after H):
    4 doc-shards x 1 and x 2 replica groups viewing its tensors, served,
    held to one shard, its kernels held to their plain versions on a
    shard, the lifecycle and the store at 4 shards; -> (the phase line,
    the kernels' launches in its main-path runs, {engine: the 4 x 2
    answers})."""
    from repro_torch.core import TrimFilter
    from repro_torch.dist import ShardedVectorIndex
    from repro_torch.launch import make_shard_mesh

    t_phase = time.monotonic()
    qt = index.quantized            # the int8 table the shards view
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t = time.monotonic()
    s42 = ShardedVectorIndex.from_index(index, mesh=make_shard_mesh(4, 2))
    torch.cuda.synchronize()
    postings_s = time.monotonic() - t
    s4 = s42.replica_group(0)
    b8, bsc, bzp = s42._quant_base()
    check(s42.vectors.data_ptr() == index.vectors.data_ptr()
          and s42.codes.data_ptr() == index.codes.data_ptr()
          and b8.data_ptr() == qt.codes.data_ptr()
          and bsc.data_ptr() == qt.scale.data_ptr()
          and bzp.data_ptr() == qt.zero.data_ptr(),
          "I: from_index copied the vectors, codes or int8 table")
    check(s42.docs_per_shard * 4 == index.n_docs
          and tuple(s42.vectors.shape[:2]) == (4, index.n_docs // 4),
          f"I: shards of {tuple(s42.vectors.shape)}")
    check(s4.n_replicas == 1 and s42.n_replicas == 2
          and all(getattr(s4, n) is getattr(s42, n) for n in (
              "vectors", "codes", "post_docs", "post_codes", "live"))
          and s42.replica_group(1)._quant_base() is s42._quant_base(),
          "I: replica groups do not share the tensors")
    build = {"postings_s": postings_s,
             "postings_bytes": s42.post_docs.nbytes + s42.post_codes.nbytes,
             "peak_bytes_over_held": torch.cuda.max_memory_allocated() - held}
    progress(f"I: 4 x {index.n_docs // 4} shards, per-shard postings in "
             f"{postings_s:.2f} s")

    rows, launches, answers = i_serve(index, s4, s42, queries, src)
    # one fused_int8 batch traced on each layout (one shard: phases D and
    # G): S (and R) times the launches and host steps of a batch, against
    # the device's busy time
    qs = torch.from_numpy(queries[:BATCH])
    kw = dict(k=K, page=PAGE, trim=TrimFilter(0.05), engine="fused_int8")
    traces = {label: trace_batch(lambda idx=idx: idx.search(qs, **kw))
              for label, idx in (("4x1", s4), ("4x2", s42))}

    q, qcodes, w = served_weights(s4, queries[:BATCH])
    errs = {"fused_phase1": 0.0, "fused_phase1_quant": 0.0,
            "code_match": 0.0}
    hold_table(s4.codes[1], s4.live[1], (b8[1], bsc[1], bzp[1]), q, qcodes,
               w, "I shard 1 of 4", errs, ("fused_phase1", "code_match"))
    del q, qcodes, w

    depth, small, durable = i_depth(index, queries)
    store = i_store(s4, small, durable, queries)
    del s4, s42, small, durable
    torch.cuda.empty_cache()

    new, f_queries, f_src, victims = f_workload(index)
    _, hist = f_history(index, F_SEAL, new, f_queries, f_src, victims,
                        launches, mesh=make_shard_mesh(4), tag="I",
                        plane=False)
    line = {"phase": "I", "device": smi, "n_docs": index.n_docs,
            "layouts": ["4x1", "4x2"],
            "docs_per_shard": index.n_docs // 4, "build": build,
            "batch_latency_s_median": {
                n: r["batch_latency_s_median"] for n, r in rows.items()},
            "one_shard_phase_cd_median": one_shard_medians,
            "launches_per_batch": {n: r["launches_per_batch"]
                                   for n, r in rows.items()},
            "engines": rows, "trace_fused_int8": traces,
            "kernels_vs_plain_shard_1": errs,
            "kernels_max_abs_err": errs, "depth": depth,
            "lifecycle_4x1": {k: hist[k] for k in (
                "add_s_median", "add_s", "delete_s", "merge_s",
                "compact_s")},
            "lifecycle_latency_s_median": {
                st: {n: r["batch_latency_s_median"] for n, r
                     in hist["stages"][st]["engines"].items()}
                for st in hist["stages"]},
            "store": store, "launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "phase_s": time.monotonic() - t_phase}
    return line, launches, answers


def j_cluster(index, engine, metrics, **kw):
    """A ClusterEngine at phase J's serving settings."""
    from repro_torch.cluster import ClusterEngine
    from repro_torch.core import TrimFilter

    return ClusterEngine(index, batch_size=BATCH, max_wait_s=0.005, k=K,
                         page=PAGE, trim=TrimFilter(0.05), engine=engine,
                         metrics=metrics, **kw)


def j_drive(cluster, queries, n_streams, timeout=600.0) -> tuple:
    """N client threads, each one stream id submitting every query
    open-loop (thread ``s`` starting at row 8 s), then waiting for its
    answers -- the reference's ``benchmarks/cluster_scale.py`` ``_drive``;
    -> (wall seconds, {(stream, row): (ids, scores)}, submit-to-done
    seconds of every request)."""
    import threading

    results, latencies, errors = {}, [], []
    n = len(queries)

    def client(sid):
        try:
            futs = []
            for qi in np.roll(np.arange(n), -8 * sid):
                t_sub = time.perf_counter()
                f = cluster.submit(queries[qi], stream=sid)
                f.add_done_callback(
                    lambda _f, t_sub=t_sub: latencies.append(
                        time.perf_counter() - t_sub))
                futs.append((int(qi), f))
            for qi, f in futs:
                results[(sid, qi)] = f.result(timeout=timeout)
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(sid,))
               for sid in range(n_streams)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    # done-callbacks run in the worker after result() unblocks
    deadline = time.perf_counter() + 5.0
    while (len(latencies) < n_streams * n
           and time.perf_counter() < deadline):
        time.sleep(0.001)
    check(len(latencies) == n_streams * n, f"{len(latencies)} latencies "
          f"for {n_streams * n} requests")
    return wall, results, latencies


def j_hold_answers(results, want, ctx) -> None:
    """Every answer of a drive bit-equal to ``want`` (ids, scores by
    row)."""
    for (sid, qi), (ids, scores) in results.items():
        check(np.array_equal(ids, want[0][qi])
              and np.array_equal(scores, want[1][qi]),
              f"{ctx}: stream {sid} row {qi} differs from phase I's answer")


def j_reconcile(cl, issued, ctx) -> dict:
    """submitted = completed = issued, nothing failed, and the groups'
    completions add up to it; -> the cluster's stats."""
    st = cl.stats()
    req = st["requests"]
    check(req["submitted"] == req["completed"] == issued
          and req["failed"] == 0
          and sum(req["group_completed"].values()) == issued,
          f"{ctx}: requests {req}, {issued} issued")
    return st


def j_dispatches(reg, engine, n_groups) -> int:
    return sum(reg.value("engine.kernel_path", engine=engine, group=g)
               for g in range(n_groups))


def j_hold_launches(got, dispatches, engine, ctx) -> None:
    """One launch of the engine's kernel per shard of each dispatch (4
    shards, no generations), and no other kernel."""
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel

    name = "fused_phase1_quant" if engine == "fused_int8" else "fused_phase1"
    want = {k: 0 for k in got}
    want[name] = dispatches * 4 * fp_kernel.KERNELS_PER_CALL
    check(got == want, f"{ctx}: launches {got}, want {want}")


def take_launches(into: dict) -> dict:
    """Add the kernels' counts since the last reset into ``into``, reset
    them; -> the counts taken."""
    from repro_torch.kernels import launch_counts

    got = launch_counts()
    for k, v in got.items():
        into[k] = into.get(k, 0) + v
    reset_launches()
    return got


def j_serve(s42, s41, queries, src, i_answers, launches) -> dict:
    """Phase J step 1: fused_int8 and fused served through ClusterEngine
    on 4 x 2 (two groups), 4 x 1 (one group) and 4 x 2 with group 1
    marked down, by 1, 4 and 16 client streams of 128 open-loop requests;
    every answer bit-equal to phase I's, the counters reconciled, each
    kernel launched once per shard of each dispatch; -> {engine: {layout:
    {streams: row}}}."""
    from repro_torch.obs import MetricsRegistry

    out = {}
    for engine in J_ENGINES:
        out[engine] = {}
        for layout, idx, down in (("4x2", s42, None), ("4x1", s41, None),
                                  ("4x2 group 1 down", s42, 1)):
            rows = {}
            for n in J_STREAMS:
                reg = MetricsRegistry()
                cl = j_cluster(idx, engine, reg)
                try:
                    if down is not None:
                        cl.mark_down(down)
                    reset_launches()
                    wall, res, lat = j_drive(cl, queries, n)
                    got = take_launches(launches)
                    ctx = f"J {engine} {layout} x{n} streams"
                    issued = n * len(queries)
                    st = j_reconcile(cl, issued, ctx)
                    j_hold_launches(got, j_dispatches(reg, engine,
                                                      cl.n_groups),
                                    engine, ctx)
                finally:
                    cl.close()
                j_hold_answers(res, i_answers[engine], ctx)
                rank1 = float(np.mean([ids[0] == src[qi] for (_, qi), (
                    ids, _) in res.items()]))
                check(rank1 >= 0.95, f"{ctx}: rank 1 for {rank1:.3f}")
                done = st["requests"]["group_completed"]
                if down is not None:
                    check(done[down] == 0, f"{ctx}: group {down} served "
                          f"{done[down]} while down")
                lat = np.sort(np.asarray(lat))
                rows[n] = {
                    "qps": issued / wall, "wall_s": wall,
                    "latency_s_p50": float(lat[len(lat) // 2]),
                    "latency_s_p99": float(lat[int(0.99 * (len(lat) - 1))]),
                    "spills": st["routing"]["spills"],
                    "group_completed": done,
                    "dispatches": j_dispatches(reg, engine, cl.n_groups),
                    "dispatch_s_mean": {
                        g: s["dispatch_latency_s"]["mean"]
                        for g, s in st["groups"].items()},
                    "occupancy_p50": {g: s["batches"]["p50"]
                                      for g, s in st["groups"].items()},
                    "rank1_share": rank1}
                progress(f"{ctx}: {rows[n]['qps']:.0f} QPS, p50 "
                         f"{rows[n]['latency_s_p50'] * 1e3:.1f} ms, p99 "
                         f"{rows[n]['latency_s_p99'] * 1e3:.1f} ms, "
                         f"{rows[n]['spills']} spills, groups {done}")
            out[engine][layout] = rows
    return out


def trace_groups(s42, queries) -> dict:
    """One fused_int8 batch per group under 2-group load, traced on every
    thread: two streams of 32 requests pinned to the two groups, served
    at once.  Each group's searches run in its ``repro.cluster.group<g>``
    range (a tracer that annotates) on its batcher's thread; a device
    event is the group's whose runtime call (the CUDA API event with the
    event's correlation id) ran on that thread; -> host time, device busy
    time and idle share of the whole, each group's ranges, their host
    milliseconds and the group's device milliseconds, and the device
    milliseconds no group launched."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import MetricsRegistry, Tracer

    cl = j_cluster(s42, "fused_int8", MetricsRegistry(),
                   tracer=Tracer(sample=1.0 / 16, annotate=True))
    qs = queries[:2 * BATCH]

    def two_batches():
        futs = [cl.submit(q, stream="a") for q in qs[:BATCH]]
        futs += [cl.submit(q, stream="b") for q in qs[BATCH:]]
        return [f.result(timeout=600) for f in futs]

    try:
        two_batches()                       # pins a and b, warm
        check(cl._streams == {"a": 0, "b": 1},
              f"J trace: streams pinned {dict(cl._streams)}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            t = time.monotonic()
            two_batches()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t) * 1e6
    finally:
        cl.close()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    names = {f"repro.cluster.group{g}": g for g in range(2)}
    events = prof.events()
    groups = {g: {"ranges": 0, "range_ms": 0.0, "device_ms": 0.0,
                  "device_events": 0} for g in range(2)}
    thread_group = {}
    for e in events:
        if e.device_type == cpu and e.name in names:
            g = names[e.name]
            thread_group[e.thread] = g
            groups[g]["ranges"] += 1
            groups[g]["range_ms"] += (e.time_range.end
                                      - e.time_range.start) / 1e3
    # CUDA API calls carry the id of the device event they start
    launched_by = {e.id: e.thread for e in events
                   if e.device_type == cpu and e.name.startswith("cu")}
    spans, other_ms = [], 0.0
    for e in events:
        if e.device_type != cuda or e.name in names:
            continue
        s_, e_ = e.time_range.start, e.time_range.end
        spans.append((s_, e_))
        g = thread_group.get(launched_by.get(e.id))
        if g is None:
            other_ms += (e_ - s_) / 1e3
        else:
            groups[g]["device_ms"] += (e_ - s_) / 1e3
            groups[g]["device_events"] += 1
    busy = union_us(sorted(spans))
    return {"host_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_event_ms": sum(e_ - s_ for s_, e_ in spans) / 1e3,
            "unattributed_ms": other_ms, "threads": len(thread_group),
            "groups": groups}


def j_trace(s42, queries) -> dict:
    """:func:`trace_groups`, checked: both groups' ranges on their own
    threads, each with device time, and no more than 5% of the device
    time launched outside them."""
    out = trace_groups(s42, queries)
    check(out["device_busy_ms"] > 0, "J trace: no device time")
    check(out["threads"] == 2
          and all(r["device_ms"] > 0 for r in out["groups"].values())
          and out["unattributed_ms"] <= 0.05 * out["device_event_ms"],
          f"J trace: device time not attributed to the groups: {out}")
    return out


def j_health_ledger(h) -> None:
    """The ledger reconciles with the counters one for one, and replaying
    it lands on the reported down set."""
    events = [e["event"] for e in h["transitions"]]
    c = h["counters"]
    check(events.count("down") == c["down_transitions"]
          and events.count("up") == c["mark_ups"]
          and events.count("readmit") == c["readmits"],
          f"J health: ledger {events} against counters {c}")
    down = set()
    for e in h["transitions"]:
        if e["event"] == "down":
            down.add(e["group"])
        elif e["event"] in ("up", "readmit"):
            down.discard(e["group"])
    check(tuple(sorted(down)) == tuple(h["down"]),
          f"J health: the ledger replays to {down}, health says {h['down']}")
    gens = [e["generation"] for e in h["transitions"]]
    check(gens == sorted(gens) and (not gens or gens[-1] == h["generation"]),
          f"J health: generations {gens}, at {h['generation']}")


def j_failover(s42, queries, i_answers, launches) -> dict:
    """Phase J step 2 on the 2-group fused_int8 cluster: a group failure
    injected during a 16-stream run, its heal and re-admission by the
    canary prober, a drain with requests in flight, and a full outage
    with its rollback -- every answer bit-equal to phase I's, health
    green -> yellow -> green, its ledger reconciled; -> the step's
    numbers."""
    import threading

    from repro_torch.cluster import MaintenanceDaemon
    from repro_torch.obs import MetricsRegistry, format_health_line

    want = i_answers["fused_int8"]
    reg = MetricsRegistry()
    cl = j_cluster(s42, "fused_int8", reg)
    statuses, lines = [], []

    def health(what):
        h = cl.cluster_health()
        statuses.append(h["status"])
        lines.append(format_health_line(h))
        progress(f"J {what}: {lines[-1]}")
        return h

    out = {}
    issued = 0
    try:
        reset_launches()
        health("healthy")
        # 1. a failure injected a quarter of the way through a 16-stream run
        drive = {}
        n = 16 * len(queries)
        runner = threading.Thread(target=lambda: drive.update(
            zip(("wall", "res", "lat"), j_drive(cl, queries, 16))))
        runner.start()
        deadline = time.monotonic() + 300
        while reg.value("cluster.requests.completed") < n // 4:
            check(time.monotonic() < deadline, "J: the run never got going")
            time.sleep(0.001)
        cl.inject_failure(0)
        runner.join()
        check("res" in drive, "J: the run under a failure raised")
        issued += n
        j_hold_answers(drive["res"], want, "J failover")
        h = health("group 0 failed")
        check(h["status"] == "yellow" and h["down"] == (0,)
              and [e["event"] for e in h["transitions"]] == ["down"],
              f"J: after the injected failure {h}")
        out["failover"] = {
            "resubmits": reg.value("cluster.failover.resubmits"),
            "group_completed": cl.stats()["requests"]["group_completed"],
            "qps": n / drive["wall"]}
        check(out["failover"]["resubmits"] >= 1, "J: nothing failed over")
        # 2. heal, and the canary prober re-admits
        cl.heal(0)
        daemon = MaintenanceDaemon(cl.batchers, health=cl.health, probe=True,
                                   merge_policy=None, metrics=reg)
        t = time.monotonic()
        check(daemon.probe_once() == 1, "J: the prober did not re-admit")
        out["probe_s"] = time.monotonic() - t
        check(health("probed")["status"] == "green", "J: not green")
        # 3. a drain with requests in flight: they finish, new work moves
        s1 = next((s for s, g in cl._streams.items() if g == 1), None)
        check(s1 is not None, f"J: no stream pinned to group 1: "
              f"{dict(cl._streams)}")
        before = dict(cl.stats()["requests"]["group_completed"])
        inflight = [(qi, cl.submit(queries[qi], stream=s1))
                    for qi in range(2 * BATCH)]
        check(cl.mark_down(1), "J: the drain changed nothing")
        moved = [(qi, cl.submit(queries[qi], stream=s1))
                 for qi in range(2 * BATCH, 3 * BATCH)]
        drained = health("group 1 drained")
        for qi, f in inflight + moved:
            ids, scores = f.result(timeout=600)
            check(np.array_equal(ids, want[0][qi])
                  and np.array_equal(scores, want[1][qi]),
                  f"J drain: row {qi} differs")
        issued += 3 * BATCH
        after = cl.stats()["requests"]["group_completed"]
        out["drain"] = {"in_flight": 2 * BATCH, "rerouted": BATCH,
                        "group_completed_delta": {
                            g: after[g] - before[g] for g in after}}
        check(out["drain"]["group_completed_delta"] == {
            0: BATCH, 1: 2 * BATCH}, f"J drain: {out['drain']}")
        check(drained["status"] == "yellow" and drained["drained"] == (1,),
              f"J drain: {drained}")
        check(daemon.probe_once() == 0, "J: the prober undid a drain")
        check(cl.mark_up(1), "J: mark_up changed nothing")
        health("undrained")
        # 4. every group fails the same request: the error surfaces and
        #    the rollback readmits both
        for g in range(2):
            cl.inject_failure(g, RuntimeError(f"J outage {g}"))
        fut = cl.submit(queries[0], stream="outage")
        err = fut.exception(timeout=600)
        issued += 1
        check(err is not None and "J outage" in str(err),
              f"J outage: the future carries {err!r}")
        for g in range(2):
            cl.heal(g)
        h = health("after the outage")
        check(h["status"] == "green" and h["down"] == (),
              f"J outage: not rolled back {h}")
        ids, scores = cl.search(queries[1], stream="outage", timeout=600)
        check(np.array_equal(ids, want[0][1])
              and np.array_equal(scores, want[1][1]), "J: after the outage")
        issued += 1
        j_health_ledger(h)
        st = cl.stats()
        req = st["requests"]
        check(req["submitted"] == issued and req["failed"] == 1
              and req["completed"] == issued - 1
              and sum(req["group_completed"].values()) == issued - 1,
              f"J failover: requests {req}, {issued} issued")
        got = take_launches(launches)
        j_hold_launches(got, j_dispatches(reg, "fused_int8", 2),
                        "fused_int8", "J failover")
        out.update(statuses=statuses, health_lines=lines,
                   transitions=[e["event"] for e in h["transitions"]],
                   counters=h["counters"], requests=req,
                   routing=st["routing"])
    finally:
        cl.close()
    check(statuses == ["green", "yellow", "green", "yellow", "green",
                       "green"], f"J: health went {statuses}")
    return out


def own_bytes(idx, shared) -> int:
    """Bytes of the storages behind ``idx``'s leaves, its derived int8
    tables left out, that ``shared`` (an index) does not hold: what a
    group's writes have made its own
    (:func:`repro_torch.obs.device.resident_storages`)."""
    from repro_torch.obs.device import resident_storages

    held = resident_storages(shared)
    mine = resident_storages(idx, skip_sections=("quant",))
    return sum(b for k, (_, b) in mine.items() if k not in held)


def j_own_bytes_expected(n: int, C: int) -> int:
    """A group's own bytes after phase J's writes: its rebuilt base codes,
    live mask and 4-shard posting tables (codes int8, ids int32), and
    J_ADDS sealed segments of F_BATCH rows (vectors, codes, gids, live and
    their posting tables)."""
    base = n * (C + 1) + C * n * (4 + 1)
    segment = F_BATCH * (N_FEATURES * 4 + C + 4 + 1) + C * F_BATCH * (4 + 1)
    return base + J_ADDS * segment


def j_writes(s42, queries, src, launches, errs) -> dict:
    """Phase J step 3 at full width: a cluster with a store (group 0 the
    write-through primary, a baseline commit), 8 x 4,096 rows and 2,048
    deletes between served batches, the kernels held on group 1's shard 1
    slice, ``restore_group(1)`` from disk held leaf for leaf and answer
    for answer to group 0, then the merge daemon folding the 8
    generations under 4-stream traffic, each swap held to an explicit
    merge and each commit landing; -> the step's numbers."""
    import shutil
    import tempfile

    from repro_torch.obs import CompileWatch, MetricsRegistry
    from repro_torch.store import Store

    root = pathlib.Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_cluster_", dir=root)
    out = {}
    n = s42.n_docs
    try:
        fs, free = filesystem(store_dir)
        cb = s42.codes.shape[-1] * s42.codes.element_size()
        # the baseline, two base-state blobs after the deletes (the
        # fallback commit's and the newest), the segments, 2 GiB of slack
        need = (N_FEATURES * 4 + cb + 1) * n + 2 * (cb + 1) * n + (2 << 30)
        check(free >= need, f"J: {free} bytes free under {store_dir}, "
              f"{need} needed")
        out.update(filesystem=fs, free_bytes=free, bytes_needed=need)
        reg = MetricsRegistry()
        watch = CompileWatch(metrics=reg)
        store = Store(store_dir, durability="request", metrics=reg)
        out["group_device_bytes_before_writes"] = j_device_bytes(
            s42.replica_group(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        cl = j_cluster(s42, "fused_int8", reg, store=store,
                       compile_watch=watch)
        out["baseline_commit_s"] = time.monotonic() - t
        out["baseline_commit_bytes"] = reg.value("store.commit.bytes_written")
        progress(f"J: baseline commit in {out['baseline_commit_s']:.2f} s")
        try:
            out.update(j_write_history(cl, s42, store, reg, queries, src,
                                       launches, errs))
            out["diagnostics"] = j_diagnostics(cl, watch, queries, root)
        finally:
            cl.close()
            store.close()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    return out


def j_device_bytes(idx) -> dict:
    """``device_bytes`` of one group, its leaf table left out: total,
    sections, storage bytes on the card and the reconciliation with the
    allocator (index storage <= allocated, checked)."""
    from repro_torch.obs import device_bytes

    dev = device_bytes(idx)
    rec = dev["reconciliation"]
    check(rec["accounted_bytes"] == sum(dev["per_device"].values())
          <= rec["process_live_bytes"],
          f"J: device bytes do not reconcile with the allocator: {rec}")
    return {k: dev[k] for k in ("total_bytes", "sections", "per_device",
                                "n_leaves", "aliased_leaves",
                                "reconciliation")}


def j_diagnostics(cl, watch, queries, root) -> dict:
    """The device side of the obs plane on the written cluster: each
    group's ``device_bytes``, ``node_stats``, a diagnostics bundle
    written under ``root`` and accepted by
    ``tools/validate_diag_bundle_torch.py``, and the cost rows of the
    cluster's watch -- no building region without a row, and the fused
    phase 1's bytes under the composed one's as
    ``artifacts/BENCH_kernel_scale.json`` claims (one ``codes`` and one
    ``fused`` batch served on group 0 beside the cluster's
    ``fused_int8``)."""
    import shutil
    import tempfile

    from repro_torch.core import TrimFilter
    from repro_torch.obs import (MetricsRegistry, missing_cost_regions,
                                 node_stats, resident_storages,
                                 verify_kernel_claim, write_diagnostics)
    from repro_torch.serve.engine import BatchedSearchEngine

    here = pathlib.Path(__file__).resolve().parent
    for name in ("codes", "fused"):
        eng = BatchedSearchEngine(
            cl.batchers[0].index, batch_size=BATCH, max_wait_s=0.005, k=K,
            page=PAGE, trim=TrimFilter(0.05), engine=name,
            metrics=MetricsRegistry(), compile_watch=watch)
        try:
            [f.result(timeout=600) for f in
             [eng.submit(q) for q in queries[:BATCH]]]
        finally:
            eng.close()
    out = {"groups": [j_device_bytes(cl.group_index(g))
                      for g in range(cl.n_groups)]}
    ns = node_stats(cl)
    union = {}
    for g in range(cl.n_groups):
        union.update(resident_storages(cl.group_index(g)))
    node = ns["nodes"]["cuda:0"]
    check(node["index_bytes"] == sum(b for _, b in union.values())
          <= torch.cuda.memory_allocated(),
          f"J: node_stats index bytes {node['index_bytes']}")
    out["node_stats"] = {
        k: ns[k] for k in ("n_devices", "total_index_bytes",
                           "device_resident_bytes")}
    out["node_stats"]["index_bytes_by_group"] = node["index_bytes_by_group"]
    diag = tempfile.mkdtemp(prefix="chip_smoke_diag_", dir=root)
    try:
        t = time.monotonic()
        path = write_diagnostics(cl, diag, reason="exit")
        out["bundle_s"] = time.monotonic() - t
        out["bundle_bytes"] = os.path.getsize(path)
        run = subprocess.run(
            [sys.executable, str(here / "tools" /
                                 "validate_diag_bundle_torch.py"), diag],
            capture_output=True, text=True, timeout=120)
        check(run.returncode == 0, "J: the diagnostics bundle is refused: "
              f"{run.stdout}{run.stderr}")
    finally:
        shutil.rmtree(diag, ignore_errors=True)
    # every library was built before phase A, so J's watch counted no
    # build and this holds whatever the rows: phase K's K4 builds in a
    # serving region, and there the check can fail
    missing = missing_cost_regions(watch)
    check(missing == [], f"J: building regions without a cost row {missing}")
    claim = verify_kernel_claim(
        watch, str(here / "artifacts" / "BENCH_kernel_scale.json"))
    out.update(cost_rows=watch.costs.stats()["n_rows"],
               kernel_claim=claim)
    progress(f"J diagnostics: {out}")
    return out


def j_serve_batch(cl, queries, lo, stream) -> list:
    return [f.result(timeout=600) for f in
            [cl.submit(q, stream=stream) for q in queries[lo:lo + BATCH]]]


def j_write_history(cl, s42, store, reg, queries, src, launches,
                    errs) -> dict:
    """The body of :func:`j_writes` on its cluster and store."""
    import threading

    from repro_torch.cluster import MaintenanceDaemon, TieredMergePolicy
    from repro_torch.core import TrimFilter
    from repro_torch.core.rerank import normalize
    from repro_torch.store import latest_commit

    n = s42.n_docs
    out = {}
    g = torch.Generator(device="cuda").manual_seed(9)
    new = normalize(torch.randn((J_ADDS * F_BATCH, N_FEATURES),
                                generator=g, device="cuda"))
    rng = np.random.default_rng(9)
    victims = np.concatenate([
        rng.choice(np.setdiff1d(np.arange(n), src), J_DELETE_BASE,
                   replace=False),
        n + 2 * F_BATCH + rng.choice(F_BATCH, J_DELETE_SEALED,
                                     replace=False)])
    add_s = []
    for b in range(J_ADDS):
        j_serve_batch(cl, queries, (b % 4) * BATCH, b % 2)
        t = time.monotonic()
        first = cl.add_documents(new[b * F_BATCH:(b + 1) * F_BATCH])
        torch.cuda.synchronize()
        add_s.append(time.monotonic() - t)
        check(first == n + b * F_BATCH, f"J: add {b} first id {first}")
    j_serve_batch(cl, queries, 0, 0)
    t = time.monotonic()
    cl.delete(victims)
    torch.cuda.synchronize()
    out["delete_s"] = time.monotonic() - t
    out.update(add_s=add_s, add_s_median=median_after_first(add_s))
    groups = [cl.group_index(0).inner, cl.group_index(1)]
    for gi, idx in enumerate(groups):
        check(idx.n_segments == J_ADDS and idx.n_tombstones == len(victims)
              and idx.segments[2].deleted_ratio == J_DELETE_SEALED / F_BATCH,
              f"J: group {gi} has {idx.n_segments} segments, "
              f"{idx.n_tombstones} tombstones")
    out["group_own_bytes"] = [own_bytes(idx, s42) for idx in groups]
    want = j_own_bytes_expected(n, s42.codes.shape[-1])
    check(out["group_own_bytes"] == [want, want],
          f"J: groups own {out['group_own_bytes']} bytes, {want} expected")
    out["peak_before_restore"] = torch.cuda.max_memory_allocated()
    progress(f"J: 8 adds (median {out['add_s_median']:.4f} s), deletes in "
             f"{out['delete_s']:.3f} s; groups own "
             f"{out['group_own_bytes']} bytes, peak "
             f"{out['peak_before_restore']}")
    take_launches(launches)

    # the kernels on group 1's shard 1 after the deletes: the tombstoned
    # base slice and the slice of the generation the deletes hit
    g1 = groups[1]
    q, qcodes, w = served_weights(g1, queries[:BATCH])
    b8, bsc, bzp = g1._quant_base()
    hold_table(g1.codes[1], g1.live[1], (b8[1], bsc[1], bzp[1]), q, qcodes,
               w, "J group 1 shard 1 base", errs,
               ("fused_phase1", "code_match"))
    seg = g1.segments[2]
    hold_table(seg.codes[1], seg.live[1], [t[1] for t in seg.quantized()],
               q, qcodes, w, "J group 1 shard 1 generation 2", errs,
               ("code_match",))
    del q, qcodes, w, g1, groups

    # restore group 1 from disk while the cluster serves on group 0
    qs = torch.from_numpy(queries[:BATCH])
    cl.inject_failure(1)
    cl.mark_down(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    seq = cl.restore_group(1)
    torch.cuda.synchronize()
    out["restore_s"] = time.monotonic() - t
    out["peak_during_restore"] = torch.cuda.max_memory_allocated()
    check(seq == J_ADDS + 1 and cl.health.is_up(1),
          f"J: restored at seq {seq}")
    check(cl.cluster_health()["restores_completed"] == 1,
          "J: restores_completed is not 1")
    g0, g1 = cl.group_index(0).inner, cl.group_index(1)
    check(g1.vectors.data_ptr() != g0.vectors.data_ptr(),
          "J: the restored group shares group 0's vectors")
    h_same_leaves(g0, g1, "J restore_group(1)")
    for name in F_ENGINES:
        kw = dict(k=K, page=PAGE, trim=TrimFilter(0.05), engine=name)
        a, b = g0.search(qs, **kw), g1.search(qs, **kw)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"J {name}: restored group 1 and group 0 answers differ")
    del g0, g1
    progress(f"J: restore_group(1) in {out['restore_s']:.2f} s, peak "
             f"{out['peak_during_restore']}")
    take_launches(launches)

    # the merge daemon under 4-stream traffic
    pre = {}
    for lo in range(0, len(queries), BATCH):
        for i, r in enumerate(j_serve_batch(cl, queries, lo, lo % 2)):
            pre[lo + i] = r
    daemon = MaintenanceDaemon(cl.batchers, threshold=0.2, health=cl.health,
                               store=store, metrics=reg,
                               merge_policy=TieredMergePolicy(merge_factor=4))
    stop = threading.Event()
    errors, served = [], [0]

    def client(sid):
        try:
            while not stop.is_set():
                lo = (served[0] % 4) * BATCH
                for i, r in enumerate(j_serve_batch(cl, queries, lo,
                                                    f"m{sid}")):
                    check(np.array_equal(r[0], pre[lo + i][0])
                          and np.array_equal(r[1], pre[lo + i][1]),
                          f"J merge traffic: row {lo + i} changed")
                served[0] += 1
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t_ in threads:
        t_.start()
    polls = []
    try:
        while True:
            snaps = [b.index for b in cl.batchers]
            n_ev = len(daemon.merge_events)
            commits = daemon.commits
            gen = latest_commit(store.path, validate=False).generation
            t = time.monotonic()
            applied = daemon.poll_once()
            dt = time.monotonic() - t
            if not applied:
                break
            evs = daemon.merge_events[n_ev:]
            for ev in evs:
                gi = ev["group"]
                explicit = snaps[gi].merge_segments(ev["start"], ev["count"])
                cur = cl.batchers[gi].index
                for name in ("fused_int8", "fused"):
                    kw = dict(k=K, page=PAGE, trim=TrimFilter(0.05),
                              engine=name)
                    a, b = explicit.search(qs, **kw), cur.search(qs, **kw)
                    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                          f"J merge {ev}: {name} answers differ from an "
                          "explicit merge_segments")
            if any(ev["group"] == 0 for ev in evs):
                check(daemon.commits == commits + 1,
                      f"J: {daemon.commits - commits} commits after a merge")
                last = latest_commit(store.path, validate=False)
                check(last.generation == gen + 1 and last.seq
                      == cl.batchers[0].index.translog_seq,
                      "J: the commit after the merge did not land")
            polls.append({"s": dt, "events": [
                {k: ev[k] for k in ("group", "start", "count", "reason",
                                    "reclaimed", "n_segments",
                                    "duration_s")} for ev in evs]})
            progress(f"J: maintenance pass in {dt:.2f} s: {polls[-1]}")
    finally:
        stop.set()
        for t_ in threads:
            t_.join()
    if errors:
        raise errors[0]
    check(not daemon.failures, f"J: maintenance failures {daemon.failures}")
    reasons = [ev["reason"] for ev in daemon.merge_events]
    check(len(polls) == 3 and reasons.count("deletes") == 2
          and reasons.count("tier") == 4 and daemon.commits == 3,
          f"J: merges {reasons}, {daemon.commits} commits")
    for gi in range(2):
        idx = cl.group_index(gi)
        check(idx.n_segments == 2 and idx.segment_rows
              == J_ADDS * F_BATCH - J_DELETE_SEALED,
              f"J: group {gi} left {idx.n_segments} segments")
    take_launches(launches)
    st = store.stats()
    out.update(merge_passes=polls, merge_traffic_batches=served[0],
               commits=st["commits"], commit_s=reg.histogram(
                   "store.commit.duration_s").snapshot()["sum"],
               commit_bytes_written=st["commit_bytes"]["written_total"],
               store_seq=st["commit"]["seq"],
               peak_after_restore=torch.cuda.max_memory_allocated())
    return out


def j_compact(index, queries) -> dict:
    """Phase J step 4 on phase I's depth cut (the first 65,536 rows) at 4
    x 2: 1,024 rows added, a quarter of the base deleted, the daemon
    compacting every group in the background under traffic; each group
    then holds no appended rows and no tombstones, and answers as an
    explicit compact of the same history; -> the step's numbers."""
    from repro_torch.core import TrimFilter, VectorIndex
    from repro_torch.core.postings import build_postings
    from repro_torch.core.rerank import normalize
    from repro_torch.launch import make_shard_mesh
    from repro_torch.obs import MetricsRegistry

    small = VectorIndex(index.vectors[:I_DEPTH], index.codes[:I_DEPTH],
                        build_postings(index.codes[:I_DEPTH]),
                        index.encoder, index.index_best)
    s = small.shard(make_shard_mesh(4, 2), seal_threshold=F_SEAL)
    g = torch.Generator(device="cuda").manual_seed(10)
    new = normalize(torch.randn((4 * F_SEAL, N_FEATURES), generator=g,
                                device="cuda"))
    victims = np.random.default_rng(10).choice(I_DEPTH, J_COMPACT_DELETES,
                                               replace=False)
    explicit = s
    for b in range(4):
        explicit = explicit.add_documents(new[b * F_SEAL:(b + 1) * F_SEAL])
    explicit = explicit.delete(victims).compact()
    qs = queries[:BATCH]
    reg = MetricsRegistry()
    t0 = time.monotonic()
    cl = j_cluster(s, "fused_int8", reg, auto_compact=0.2,
                   compact_interval_s=0.01)
    try:
        for b in range(4):
            cl.add_documents(new[b * F_SEAL:(b + 1) * F_SEAL])
        cl.delete(victims)
        deadline = time.monotonic() + 300
        batches = 0
        while cl.maintenance.compactions < 2:
            check(time.monotonic() < deadline, "J: the daemon never "
                  "compacted")
            for ids, _ in [f.result(timeout=600) for f in
                           [cl.submit(q, stream=batches % 2) for q in qs]]:
                check(not np.isin(ids, victims).any(),
                      "J compact: a deleted id was served")
            batches += 1
        kw = dict(k=K, page=PAGE, trim=TrimFilter(0.05), engine="fused_int8")
        want = explicit.search(torch.from_numpy(qs), **kw)
        for gi in range(2):
            idx = cl.group_index(gi)
            check(idx.n_appended == 0 and idx.tombstone_ratio == 0.0
                  and idx.n_segments == 0 and idx.seg_capacity == 0,
                  f"J compact: group {gi} holds {idx.n_appended} appended "
                  f"rows, tombstone ratio {idx.tombstone_ratio}")
            got = idx.search(torch.from_numpy(qs), **kw)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"J compact: group {gi} answers differ from an explicit "
                  "compact")
        ev = cl.maintenance.events
        out = {"n_docs": I_DEPTH, "appended": 4 * F_SEAL,
               "deleted": J_COMPACT_DELETES,
               "tombstone_ratio_at_trigger": [e["tombstone_ratio"]
                                              for e in ev],
               "compact_s": [e["duration_s"] for e in ev],
               "merges_first": cl.maintenance.merges,
               "batches_served": batches, "s": time.monotonic() - t0}
    finally:
        cl.close()
    return out


def phase_j(index, queries, src, smi, i_answers, i_medians) -> tuple:
    """The cluster control plane on phase C's index at 4 x 2 (run after
    I): serving by streams and layouts, failover, writes, restore and
    merges at full width, the demoted compact at I's depth; -> (the
    phase line, the kernels' launches in its main-path runs)."""
    import gc

    from repro_torch.dist import ShardedVectorIndex
    from repro_torch.launch import make_shard_mesh

    t_phase = time.monotonic()
    src = np.asarray(src)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    s42 = ShardedVectorIndex.from_index(index, mesh=make_shard_mesh(4, 2),
                                        seal_threshold=F_SEAL)
    s41 = s42.replica_group(0)
    launches = {}
    reset_launches()
    serving = j_serve(s42, s41, queries, src, i_answers, launches)
    trace = j_trace(s42, queries)
    take_launches(launches)
    progress(f"J trace: {trace}")
    failover = j_failover(s42, queries, i_answers, launches)
    # the failed searches' tracebacks tie that closed cluster in reference
    # cycles: collect them before the writes need the memory
    gc.collect()
    errs = {"fused_phase1": 0.0, "fused_phase1_quant": 0.0,
            "code_match": 0.0}
    writes = j_writes(s42, queries, src, launches, errs)
    del s41, s42
    torch.cuda.empty_cache()
    compact = j_compact(index, queries)
    take_launches(launches)
    line = {"phase": "J", "device": smi, "n_docs": index.n_docs,
            "layout": "4x2", "held_bytes_at_start": held,
            "serving": serving,
            "phase_i_batch_latency_s_median": i_medians,
            "trace_fused_int8_two_groups": trace, "failover": failover,
            "writes": writes, "compact_depth": compact,
            "kernels_vs_plain_group_1_shard_1": errs,
            "kernels_max_abs_err": errs, "launches": launches,
            "max_memory_allocated": max(
                torch.cuda.max_memory_allocated(),
                writes["peak_before_restore"],
                writes["peak_during_restore"]),
            "phase_s": time.monotonic() - t_phase}
    return line, launches


# phase K: the launcher runs, each (name, arguments, the kernel its engine
# launches, whether it builds the kernels into a directory of its own);
# K1 takes the corpus cut of phase E, K2-K4 a quarter of it, one corpus
K_RUNS = (
    ("K1", ["--docs", str(E_DOCS), "--features", str(N_FEATURES),
            "--queries", "256", "--batch-size", "32", "--engine",
            "fused_int8", "--shards", "4", "--replicas", "2", "--ingest",
            "4096", "--cluster", "--fail-shard", "0", "--store",
            "build/k_store", "--kill-and-recover", "--stats-interval", "1",
            "--profile", "--slow-threshold", "0", "--metrics-file",
            "build/k_metrics.jsonl", "--diagnostics-on-exit",
            "build/k_diag"], "fused_phase1_quant", False),
    ("K2", ["--docs", str(E_DOCS // 4), "--features", str(N_FEATURES),
            "--engine", "fused", "--shards", "4", "--replicas", "2",
            "--merge", "stream", "--cluster", "--auto-compact", "0.2"],
     "fused_phase1", False),
    ("K3", ["--docs", str(E_DOCS // 4), "--features", str(N_FEATURES),
            "--shards", "4", "--cluster", "--fail-on-recompile",
            "--profile", "--slow-threshold", "0"], "page_select", False),
    ("K4", ["--docs", str(E_DOCS // 4), "--features", str(N_FEATURES),
            "--engine", "codes_pallas", "--shards", "4", "--cluster",
            "--fail-on-recompile", "--diagnostics-on-exit", "build/k4_diag"],
     "code_match", True),
)
K_DELETES = 19_660        # what K2's --auto-compact 0.2 deletes of 65,536


def k_number(pattern: str, text: str):
    """The number ``pattern``'s group captures in a run's output, or None
    where the run printed no such line."""
    m = re.search(pattern, text, re.M)
    return None if m is None else float(m.group(1))


def k_result(name, argv, kernel, out: str, rc: int, seconds: float) -> dict:
    """One launcher run's checks and numbers from its output ``out``."""
    check(rc == 0, f"{name}: the launcher exited {rc}; its last lines:\n"
          + "\n".join(out.splitlines()[-30:]))
    got = json.loads(re.search(r"^kernel launches: (\{.*\})$", out,
                               re.M).group(1))
    check(kernel is None or got[kernel] > 0,
          f"{name}: {kernel} was not launched: {got}")
    return {"args": " ".join(argv), "s": seconds,
            "p10": k_number(r"P@10 vs brute force: ([0-9.]+)", out),
            "ids_sha256": re.search(r"^served ids sha256: ([0-9a-f]{64})$",
                                    out, re.M).group(1),
            "ms_per_query": k_number(r"\(([0-9.]+) ms/query effective",
                                     out),
            "kill_and_recover_s": k_number(
                r"^kill-and-recover: .* in ([0-9.]+)s", out),
            "recovered_p10": k_number(r"\(P@10 ([0-9.]+)\)$", out),
            "post_compact_p10": k_number(
                r"post-compact P@10 vs live gold: ([0-9.]+)", out),
            "warmup_builds": k_number(
                r"^compile watch: ([0-9]+) compile\(s\) during warmup", out),
            "no_steady_builds": ("recompile watch: zero steady-state "
                                 "recompiles") in out,
            "launches": got}


def k_validate(directory, n_bundles: int, ctx) -> list:
    """``tools/validate_diag_bundle_torch.py`` on ``directory``, which
    must hold ``n_bundles`` bundles; -> the bundles, parsed."""
    here = pathlib.Path(__file__).resolve().parent
    bundles = sorted(directory.glob("diagnostics-*.json"))
    run = subprocess.run(
        [sys.executable, str(here / "tools" / "validate_diag_bundle_torch.py"),
         str(directory)], capture_output=True, text=True, timeout=120)
    check(run.returncode == 0 and len(bundles) == n_bundles,
          f"{ctx}: {len(bundles)} bundles, validator: "
          f"{run.stdout}{run.stderr}")
    return [json.loads(b.read_text()) for b in bundles]


def k_built_regions(bundle, ctx) -> dict:
    """The build and cost sections of K4's exit bundle, whose first pass
    built ``code_match`` into an empty directory: at least one build
    counted in a serving region, none after steady state, and every
    region that built owns a cost row (``missing_cost_regions`` on the
    bundle's sections); -> {region: builds}."""
    built = dict(bundle["compile"]["by_function"])
    built.pop("<unattributed>", None)
    rows = {r["region"] for r in bundle["cost"]["rows"]}
    check(sum(built.values()) >= 1, f"{ctx}: no build counted in a region "
          f"{bundle['compile']}")
    check(bundle["compile"]["compiles_steady_state"] == 0,
          f"{ctx}: steady-state builds {bundle['compile']}")
    missing = sorted(set(built) - rows)
    check(missing == [], f"{ctx}: building regions without a cost row "
          f"{missing}")
    return built


def k_holds() -> dict:
    """The kernels of phase K held to their plain versions on shard 1 of
    indexes at the launcher runs' shapes, from seeded random vectors of
    400 features under the launcher's encoder, at Q 32 (the first 32
    vectors, as the launcher draws its queries from the corpus) and page
    320 with the live masks served (``hold_table``): K1's 4 x 2 layout of 258,048
    rows (64,512 a shard) and its 4,096 ingested rows (1,024 a shard),
    ``fused_phase1_quant``; K2 and K4's 4 x 2 layout of 65,536 rows
    (16,384 a shard), ``fused_phase1``, ``code_match`` and
    ``fused_phase1_quant`` before and after K2's 19,660 deletes, then
    ``fused_phase1`` on the compacted base; -> the tables held and the
    largest |error| of each kernel."""
    from repro_torch.core import (CombinedEncoder, IntervalEncoder,
                                  RoundingEncoder)
    from repro_torch.dist import ShardedVectorIndex
    from repro_torch.launch import make_shard_mesh

    gen = torch.Generator(device="cuda").manual_seed(26)
    enc = CombinedEncoder(RoundingEncoder(1), IntervalEncoder(0.1))
    errs = {"fused_phase1": 0.0, "fused_phase1_quant": 0.0,
            "code_match": 0.0}
    held = []

    def hold(idx, name, table, scorers, queries):
        if table == "base":
            codes, live = idx.codes[1], idx.live[1]
            quant = [t[1] for t in idx._quant_base()]
        else:
            seg = idx.segments[0]
            codes, live, quant = (seg.codes[1], seg.live[1],
                                  [t[1] for t in seg.quantized()])
        where = (f"K {name} shard 1 {table} ({codes.shape[0]} rows, "
                 f"{int((~live).sum())} dead)")
        q, qcodes, w = served_weights(idx, queries)
        hold_table(codes, live, quant, q, qcodes, w, where, errs, scorers)
        held.append(where)

    n1 = E_DOCS - 4096
    vecs = torch.randn((E_DOCS, N_FEATURES), generator=gen, device="cuda")
    idx = ShardedVectorIndex.build_sharded(vecs[:n1], encoder=enc,
                                           mesh=make_shard_mesh(4, 2))
    idx = idx.add_documents(vecs[n1:])
    check(idx.docs_per_shard == n1 // 4 and idx.n_segments == 1,
          f"K1 shape: {idx.docs_per_shard} a shard, {idx.n_segments} "
          "segments")
    queries = vecs[:BATCH].cpu().numpy()
    hold(idx, "K1", "base", (), queries)
    hold(idx, "K1", "generation 0", (), queries)
    del idx, vecs
    vecs = torch.randn((E_DOCS // 4, N_FEATURES), generator=gen,
                       device="cuda")
    idx = ShardedVectorIndex.build_sharded(vecs, encoder=enc,
                                           mesh=make_shard_mesh(4, 2))
    queries = vecs[:BATCH].cpu().numpy()
    hold(idx, "K2/K4", "base", ("fused_phase1", "code_match"), queries)
    victims = BATCH + torch.randperm(E_DOCS // 4 - BATCH, generator=gen,
                                     device="cuda")[:K_DELETES]
    idx = idx.delete(victims.cpu().numpy())
    hold(idx, "K2 deleted", "base", ("fused_phase1", "code_match"), queries)
    idx = idx.compact()
    hold(idx, "K2 compacted", "base", ("fused_phase1",), queries)
    del idx, vecs
    torch.cuda.empty_cache()
    return {"tables": held, "max_abs_err": errs}


def phase_k(smi) -> tuple:
    """The port's launcher on the card: ``python -m
    repro_torch.launch.serve`` run as the four K_RUNS, each a process of
    its own that must exit 0 (its own assertions: failover and recovery
    bit-identical, counters, trees and slow log reconciled, no
    steady-state build), K1's and K4's diagnostics bundles accepted by
    ``tools/validate_diag_bundle_torch.py``.  K2 (``fused``), K3
    (``codes``, plain torch) and K4 (``codes_pallas``) serve one corpus
    and its queries: their first passes' served ids must be the same,
    bit for bit.  K4 builds its kernels into an empty directory, so its
    first pass builds ``code_match`` inside a serving region: the build
    watch must count it, no build may follow the steady state, and the
    region must own a cost row.  K1 starts first and the others run one
    after the other while its corpus (a host loop on one core) is
    generated; meanwhile :func:`k_holds` holds each kernel to its plain
    version at the runs' shapes; -> (the phase line, the kernels'
    launches the runs printed, summed)."""
    import shutil

    here = pathlib.Path(__file__).resolve().parent
    build = here / "build"
    build.mkdir(exist_ok=True)
    for stale in ("k_store", "k_diag", "k4_diag", "k4_kernels"):
        shutil.rmtree(build / stale, ignore_errors=True)
    (build / "k_metrics.jsonl").unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(here / "src"))
    t_phase = time.monotonic()
    runs, launches, started = {}, {}, {}

    def start(name, argv, kernel, own_build):
        log = open(build / f"phase_{name}.log", "w")
        run_env = (dict(env, REPRO_TORCH_BUILD_DIR=str(build / "k4_kernels"))
                   if own_build else env)
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            cwd=here, env=run_env, stdout=log, stderr=subprocess.STDOUT,
            text=True)
        started[name] = (proc, log, time.monotonic())

    def finish(name, argv, kernel, own_build):
        proc, log, t = started[name]
        try:
            rc = proc.wait(timeout=max(1.0, K_TIMEOUT_S
                                       - (time.monotonic() - t)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        finally:
            log.close()
        runs[name] = k_result(name, argv, kernel,
                              (build / f"phase_{name}.log").read_text(), rc,
                              time.monotonic() - t)
        for k, v in runs[name]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        progress(f"{name}: {runs[name]}")

    try:
        start(*K_RUNS[0])
        start(*K_RUNS[1])
        t = time.monotonic()
        holds = k_holds()
        holds["s"] = time.monotonic() - t
        progress(f"K holds: {holds}")
        finish(*K_RUNS[1])
        for run in K_RUNS[2:]:
            start(*run)
            finish(*run)
        finish(*K_RUNS[0])
        runs["K1"]["bundles"] = len(k_validate(build / "k_diag", 3, "K1"))
        k4_bundle, = k_validate(build / "k4_diag", 1, "K4")
        runs["K4"]["built_regions"] = k_built_regions(k4_bundle, "K4")
    finally:
        for proc, log, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(build / "k_store", ignore_errors=True)
        shutil.rmtree(build / "k4_kernels", ignore_errors=True)
    # one corpus, one set of queries: the kernels' engines serve what the
    # plain composed engine serves, at either layout and transport
    same = {name: runs[name]["ids_sha256"] for name in ("K2", "K3", "K4")}
    check(len(set(same.values())) == 1,
          f"K: the first passes' served ids differ: {same}")
    check(runs["K2"]["p10"] == runs["K3"]["p10"] == runs["K4"]["p10"],
          "K: P@10 differ at one set of served ids")
    check(runs["K1"]["recovered_p10"] == runs["K1"]["p10"],
          f"K1: P@10 {runs['K1']['p10']}, recovered "
          f"{runs['K1']['recovered_p10']}")
    check(runs["K4"]["warmup_builds"] >= 1 and runs["K4"]["no_steady_builds"],
          f"K4: {runs['K4']['warmup_builds']} builds during warm-up")
    line = {"phase": "K", "device": smi,
            "cut": (f"K1 {E_DOCS:,} of 4,181,352 docs, K2-K4 "
                    f"{E_DOCS // 4:,}, width {N_FEATURES} features: the "
                    "corpus generator is a host loop"),
            "runs": {name: runs[name] for name, *_ in K_RUNS},
            "holds": holds, "kernels_max_abs_err": holds["max_abs_err"],
            "launches": launches, "phase_s": time.monotonic() - t_phase}
    return line, launches


def quality(ids, sims, gold_ids, gold_sims) -> dict:
    from repro_torch.core import avg_diff, ndcg_k, precision_at_k

    return {"p_at_10": float(precision_at_k(ids, gold_ids).mean()),
            "ndcg": float(ndcg_k(sims, gold_sims).mean()),
            "avg_diff": float(avg_diff(sims, gold_sims).mean())}


def phase_e() -> tuple:
    """The paper's quality path on the card; -> (the phase line, the
    bucketize and rerank_topk launches of its run)."""
    from repro_torch.core import (CombinedEncoder, IntervalEncoder, MLTIndex,
                                  RoundingEncoder, TrimFilter, VectorIndex,
                                  avg_diff, precision_at_k)
    from repro_torch.data import make_corpus
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.fused_phase1 import ops as fp_ops
    from repro_torch.lsa import build_lsa

    torch.cuda.reset_peak_memory_stats()
    t = t_phase = time.monotonic()
    corpus = make_corpus(n_docs=E_DOCS, vocab_size=E_VOCAB,
                         n_topics=E_TOPICS, seed=0)
    corpus_s = time.monotonic() - t
    progress(f"corpus of {E_DOCS} docs made in {corpus_s:.1f} s")
    reset_launches()
    lsa_s, vecs = [], []
    for _ in range(2):             # built twice: the same bits each time
        t = time.monotonic()
        vecs.append(build_lsa(corpus, n_features=N_FEATURES,
                              device="cuda").doc_vectors)
        torch.cuda.synchronize()
        lsa_s.append(time.monotonic() - t)
        progress(f"LSA built in {lsa_s[-1]:.1f} s")
    lsa_equal = torch.equal(vecs[0], vecs[1])
    check(lsa_equal, "two LSA builds differ")
    vecs = vecs[0]
    check(vecs.shape == (E_DOCS, N_FEATURES)
          and bool(torch.isfinite(vecs).all()), "LSA vectors not finite")
    encoder = CombinedEncoder(RoundingEncoder(1), IntervalEncoder(0.1))
    t = time.monotonic()
    index = VectorIndex.build(vecs, encoder=encoder, device="cuda")
    torch.cuda.synchronize()
    build_s = time.monotonic() - t
    codes = bk_ops.encode(vecs, encoder)
    codes_shape = list(codes.shape)
    n = N_FEATURES
    code_err = max(assert_codes(codes[:, :n], index.codes[:, :n],
                                "LSA rounding codes"),
                   assert_codes(codes[:, n:], index.codes[:, n:],
                                "LSA interval codes"))
    code_differ = int((codes != index.codes).sum())
    del codes

    Q = vecs[:E_QUERIES]
    gold_ids, gold_sims = index.gold_topk(Q, K)
    trim = TrimFilter(0.05)
    out = {}
    for engine in ("codes", "fused"):
        ids, sims = index.search(Q, k=K, page=PAGE, trim=trim, engine=engine)
        out[engine] = quality(ids, sims, gold_ids, gold_sims)
    t = time.monotonic()
    mlt = MLTIndex.build(corpus.doc_terms, corpus.doc_tf, corpus.vocab_size,
                         device="cuda")
    torch.cuda.synchronize()
    mlt_build_s = time.monotonic() - t
    ids_m, s_m = mlt.more_like_this(corpus.doc_terms[:E_QUERIES],
                                    corpus.doc_tf[:E_QUERIES],
                                    max_query_terms=25, k=K)
    mlt_runs = [mlt.scores(corpus.doc_terms[:E_QUERIES],
                           corpus.doc_tf[:E_QUERIES], max_query_terms=25)
                for _ in range(2)]
    mlt_equal = (torch.equal(mlt_runs[0], mlt_runs[1])
                 and torch.equal(s_m, torch.gather(mlt_runs[0], 1,
                                                   ids_m.long())))
    check(mlt_equal, "two runs of the MLT scores differ")
    del mlt_runs
    sims_m = torch.gather(Q @ index.vectors.T, 1, ids_m.long())
    out["mlt"] = quality(ids_m, sims_m, gold_ids, gold_sims)
    del mlt
    progress(f"quality {out}")

    # C1: avg.diff does not rise with page
    c1 = []
    for page in (20, 80, 320, 640):
        _, sims = index.search(Q, k=K, page=page, trim=trim, engine="codes")
        c1.append(float(avg_diff(sims, gold_sims).mean()))
    check(all(a >= b - 1e-6 for a, b in zip(c1, c1[1:])) and c1[0] > c1[-1],
          f"C1: avg.diff over pages 20, 80, 320, 640 is {c1}")
    # C2: trim 0.05 within 0.08 P@10 of unfiltered
    ids_u, sims_u = index.search(Q, k=K, page=PAGE, engine="codes")
    unfiltered = quality(ids_u, sims_u, gold_ids, gold_sims)
    check(out["codes"]["p_at_10"] >= unfiltered["p_at_10"] - 0.08,
          f"C2: P@10 trim 0.05 {out['codes']['p_at_10']} vs unfiltered "
          f"{unfiltered['p_at_10']}")
    # C3: the method beats MLT on all three metrics
    for engine in ("codes", "fused"):
        o, m = out[engine], out["mlt"]
        check(o["p_at_10"] > m["p_at_10"] and o["ndcg"] > m["ndcg"]
              and o["avg_diff"] < m["avg_diff"],
              f"C3: {engine} {o} does not beat MLT {m}")
    # C4: page = n_docs is brute force
    ids4, _ = index.search(Q[:E_EXACT_QUERIES], k=K, page=index.n_docs,
                           engine="codes")
    check(torch.equal(ids4, gold_ids[:E_EXACT_QUERIES]),
          "C4: page = n_docs differs from brute force")
    # C5: query-side filtering leaves the index's codes as they were
    before = index.codes.clone()
    p5 = []
    for f in (None, TrimFilter(0.05), TrimFilter(0.2)):
        ids, _ = index.search(Q, k=K, page=160, trim=f, engine="codes")
        p5.append(float(precision_at_k(ids, gold_ids).mean()))
    check(torch.equal(index.codes, before) and p5[0] >= p5[2] - 1e-6,
          f"C5: codes changed or P@10 {p5}")
    del before

    # rerank_topk on the fused candidates, held to the core path
    q, qcodes, w = index.encode_queries(Q, trim, None, "idf")
    _, cand = fp_ops.fused_phase1(index.codes, qcodes, w, PAGE)
    rerank = rerank_case(index, q, cand, "phase E rerank")
    got = launch_counts()
    check(got["bucketize"] == 2 and got["rerank_topk"] >= 1
          and got["fused_phase1"] >= 4,
          f"phase E launches {got}")
    line = {"phase": "E", "n_docs": E_DOCS, "vocab_size": E_VOCAB,
            "n_topics": E_TOPICS, "n_features": N_FEATURES,
            "queries": E_QUERIES,
            "cut": f"{E_DOCS} docs of English Wikipedia's 4,181,352: the "
                   f"corpus generator's per-doc host loop",
            "encoder": encoder.scheme_id, "page": PAGE, "trim": 0.05,
            "quality": out, "unfiltered_codes": unfiltered,
            "c1_avg_diff_by_page": dict(zip((20, 80, 320, 640), c1)),
            "c5_p_at_10_none_t005_t02": p5,
            "bucketize": {"codes": codes_shape,
                          "codes_differing": code_differ,
                          "max_abs_err": code_err},
            "rerank_topk": rerank, "launches": got,
            "runs_bit_equal": {"lsa_doc_vectors": lsa_equal,
                               "mlt_scores": mlt_equal},
            "corpus_s": corpus_s, "lsa_s": lsa_s[0],
            "lsa_s_second": lsa_s[1], "index_build_s": build_s,
            "mlt_build_s": mlt_build_s,
            "phase_s": time.monotonic() - t_phase,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    return line, got


# ----------------------------------------------------------------- phase L
def l_batch(seed, batch, seq, vocab, dev) -> dict:
    from repro_torch.data import lm_batch

    b = lm_batch(np.random.default_rng(seed), batch, seq, vocab)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def l_rel(got, want) -> float:
    """max |got - want| / max |want|, on the host in f32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def l_sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def l0_parity(cfg, dev) -> dict:
    """The model at ``cfg`` (qwen2-0.5b's widths, 2 of its layers) on
    ``dev`` against the CPU, params carried from one seeded CPU tree:
    logits, ``lm_loss``, gradients, and one AdamW step fed the CPU's
    gradients, within the CPU parity tests' bounds."""
    from repro_torch.models.transformer import model as lm
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.tree import tree_leaves, tree_map

    t0 = time.monotonic()
    cpu = lm.init_params(cfg, device="cpu", seed=1)
    card = lm.LM(cfg, device=dev).load_tree(cpu.tree())
    batch = {"cpu": l_batch(0, L0_BATCH, L0_SEQ, cfg.vocab, "cpu")}
    batch["card"] = {k: v.to(dev) for k, v in batch["cpu"].items()}
    models = {"cpu": cpu, "card": card}
    with torch.no_grad():
        logits = {n: m(batch[n]["tokens"])[0] for n, m in models.items()}
    out = {"logits_rel": l_rel(logits["card"], logits["cpu"])}
    del logits
    loss, grads = {}, {}
    for name, m in models.items():
        l = lm.lm_loss(m, batch[name])
        l.backward()
        loss[name] = float(l.detach())
        grads[name] = m.tree(grads=True)
        m.zero_grad(set_to_none=True)
    out["loss"] = loss
    out["loss_rel"] = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    flat = {n: torch.cat([g.double().reshape(-1).cpu() for g in tree_leaves(t)])
            for n, t in grads.items()}
    na, nb = float(flat["cpu"].norm()), float(flat["card"].norm())
    out["grad_norm"] = {"cpu": na, "card": nb}
    out["grad_norm_rel"] = abs(na - nb) / na
    out["grad_cos"] = float(flat["cpu"] @ flat["card"]) / (na * nb)
    del flat
    new = {}
    for name, m in models.items():             # the CPU's gradients on both
        d = next(m.parameters()).device
        g = tree_map(lambda t: t.to(d), grads["cpu"])
        tree = m.tree()
        new[name] = adamw_update(g, adamw_init(tree), tree, AdamWConfig(),
                                 lr_scale=0.5)
    pairs = list(zip(tree_leaves(new["card"]), tree_leaves(new["cpu"])))
    out["adamw_rel"] = max(l_rel(a, b) for a, b in pairs if b.abs().max() > 0)
    out["s"] = time.monotonic() - t0
    check(out["logits_rel"] <= 2e-2, f"L0 logits {out['logits_rel']}")
    check(out["loss_rel"] <= 2e-3, f"L0 loss {loss}")
    check(out["grad_norm_rel"] <= 1e-2 and out["grad_cos"] >= 0.999,
          f"L0 gradients {out}")
    check(out["adamw_rel"] <= 1e-6, f"L0 AdamW step {out['adamw_rel']}")
    return out


def l1_train(cfg, dev) -> dict:
    """``L_STEPS`` steps of ``make_train_step`` at the full config: global
    batch ``L_BATCH`` x ``L_SEQ`` at accum ``L_ACCUM``, the arch's AdamW and
    a cosine schedule, from ``init_params`` seeded on ``dev``."""
    from repro_torch.models.transformer import model as lm
    from repro_torch.train import (AdamWConfig, adamw_init, cosine_schedule,
                                   make_train_step)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = lm.init_params(cfg, device=dev, seed=0)
    opt = adamw_init(model)
    init_s = time.monotonic() - t0
    step = make_train_step(lambda m, b: lm.lm_loss(m, b), AdamWConfig(),
                           accum=L_ACCUM, lr_schedule=cosine_schedule(1, L_STEPS))
    times, losses, norms = [], [], []
    for i in range(L_STEPS):
        batch = l_batch(100 + i, L_BATCH, L_SEQ, cfg.vocab, dev)
        l_sync(dev)
        t = time.monotonic()
        model, opt, m = step(model, opt, batch)
        l_sync(dev)
        times.append(time.monotonic() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ln_v = math.log(cfg.vocab)
    check(abs(losses[0] - ln_v) <= 0.5,
          f"L1 step-0 loss {losses[0]}, ln V = {ln_v}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"L1 losses {losses}, grad norms {norms}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    return {"params": sum(p.numel() for p in model.parameters()),
            "tokens_a_step": L_BATCH * L_SEQ, "init_s": init_s,
            "step_s": times, "step_s_median_after_first": steady,
            "tokens_per_s": L_BATCH * L_SEQ / steady, "loss": losses,
            "ln_vocab": ln_v, "grad_norm": norms,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def l2_resume(cfg, dev, root) -> tuple:
    """The reference's ``test_resume_is_bit_exact`` at full widths: global
    batch ``L2_BATCH`` x ``L_SEQ`` at accum ``L2_ACCUM``; ``L2_STEPS`` steps
    straight against half of them, a checkpoint, and a resume to the end,
    under ``torch.use_deterministic_algorithms``; every parameter and
    AdamW moment equal bit for bit.  -> (the line, the resumed model)."""
    from repro_torch.models.transformer import model as lm
    from repro_torch.train import (AdamWConfig, TrainLoopConfig, adamw_init,
                                   cosine_schedule, make_train_step,
                                   run_train_loop)
    from repro_torch.train.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    base = make_train_step(lambda m, b: lm.lm_loss(m, b), AdamWConfig(),
                           accum=L2_ACCUM,
                           lr_schedule=cosine_schedule(1, L2_STEPS))
    step_s = []

    def step(m, o, b):
        t = time.monotonic()
        out = base(m, o, b)
        l_sync(dev)
        step_s.append(time.monotonic() - t)
        return out

    def fresh():
        m = lm.init_params(cfg, device=dev, seed=0)
        return m, adamw_init(m)

    def make_batch(i):
        return l_batch(200 + i, L2_BATCH, L_SEQ, cfg.vocab, dev)

    def run(steps, name, every):
        n = len(step_s)
        t = time.monotonic()
        model, opt, _ = run_train_loop(step, *fresh(), make_batch,
                                       TrainLoopConfig(steps, str(root / name),
                                                       ckpt_every=every))
        state = {"params": model, "opt": opt}
        return state, time.monotonic() - t - sum(step_s[n:]), len(step_s) - n

    half = L2_STEPS // 2
    torch.use_deterministic_algorithms(True)
    try:
        straight, save_s, n_a = run(L2_STEPS, "a", L2_STEPS)
        straight["params"] = straight["params"].tree()
        run(half, "b", half)
        resumed, resume_s, n_b = run(L2_STEPS, "b", half)
    finally:
        torch.use_deterministic_algorithms(False)
    model = resumed["params"]
    resumed["params"] = model.tree()
    leaves = list(zip(tree_leaves(straight), tree_leaves(resumed)))
    differ = [k for k, (a, b) in enumerate(leaves) if not torch.equal(a, b)]
    check(n_a == L2_STEPS and n_b == L2_STEPS - half,
          f"L2 ran {n_a} and {n_b} steps: the resume did not start at {half}")
    check(not differ, f"L2: {len(differ)} of {len(leaves)} leaves (params, "
          "then AdamW's) differ after the resume")
    ckpt = root / "b" / f"step_{half:08d}"
    size = sum(f.stat().st_size for f in ckpt.iterdir())
    fs, _ = filesystem(root)
    return {"steps": L2_STEPS, "resumed_at": half, "leaves": len(leaves),
            "bit_equal": True, "checkpoint_bytes": size,
            "checkpoint_files": len(list(ckpt.iterdir())),
            "save_s": save_s, "restore_and_save_s": resume_s,
            "step_s_median": sorted(step_s)[len(step_s) // 2],
            "filesystem": fs,
            "peak_bytes": torch.cuda.max_memory_allocated()}, model


def l3_serve(model, dev) -> dict:
    """Prefill of ``L_PREFILL`` tokens; ``serve_step`` against forward at 4 x
    ``L_SEQ`` (the reference's 0.05 bound); ``L_DECODE_STEPS`` greedy decode
    steps at batch ``L_DECODE_BATCH`` over an ``L_DECODE_CACHE``-slot cache
    filled by a ``L_DECODE_PROMPT``-token prefill, each reading every slot."""
    from repro_torch.models.transformer import model as lm

    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    out = {}
    toks = l_batch(300, 1, L_PREFILL, cfg.vocab, dev)["tokens"]
    l_sync(dev)
    t = time.monotonic()
    logits, cache = lm.prefill(model, toks, L_PREFILL)
    l_sync(dev)
    out["prefill_s"] = time.monotonic() - t
    out["prefill_tokens"] = L_PREFILL
    check(logits.shape == (1, 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()), "L3 prefill logits")
    del cache, logits

    toks = l_batch(301, 4, L_SEQ, cfg.vocab, dev)["tokens"]
    want, cache = lm.prefill(model, toks, L_SEQ)
    got, _ = lm.serve_step(model, cache, toks[:, -1:], L_SEQ - 1)
    out["serve_step_vs_forward_rel"] = l_rel(got, want)
    check(out["serve_step_vs_forward_rel"] < 0.05,
          f"L3 serve_step vs forward {out['serve_step_vs_forward_rel']}")
    del cache, got, want

    toks = l_batch(302, L_DECODE_BATCH, L_DECODE_PROMPT, cfg.vocab, dev)["tokens"]
    l_sync(dev)
    t = time.monotonic()
    logits, cache = lm.prefill(model, toks, L_DECODE_CACHE)
    l_sync(dev)
    out["decode_prefill_s"] = time.monotonic() - t
    kv = [c[k] for c in cache.values() for k in ("k", "v")]
    out["cache_bytes"] = sum(t.numel() * t.element_size() for t in kv)
    want_bytes = (L_DECODE_BATCH * L_DECODE_CACHE * cfg.n_layers
                  * cfg.n_kv_heads * cfg.d_head * 2 * 2)
    check(out["cache_bytes"] == want_bytes,
          f"L3 cache {out['cache_bytes']} B, want {want_bytes}")
    nxt = logits.argmax(-1)
    ms = []
    for i in range(L_DECODE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = lm.serve_step(model, cache, nxt, L_DECODE_PROMPT + i)
        nxt = logits.argmax(-1)
        end.record()
        ms.append((start, end))
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ms]
    filled = int((cache["sub0"]["pos"] >= 0).sum())
    check(filled == cfg.n_super * (L_DECODE_PROMPT + L_DECODE_STEPS),
          f"L3 decode filled {filled} slots")
    check(bool(torch.isfinite(logits.float()).all()), "L3 decode logits")
    out.update(decode_batch=L_DECODE_BATCH, decode_cache_slots=L_DECODE_CACHE,
               decode_ms=ms, decode_ms_median=sorted(ms)[len(ms) // 2],
               decode_tokens_per_s=L_DECODE_BATCH * 1e3 / sorted(ms)[len(ms) // 2],
               peak_bytes=torch.cuda.max_memory_allocated())
    return out


def l4_launcher(root, arch=L_ARCH, tag="L4") -> dict:
    """``python -m repro_torch.launch.train --arch <arch>`` on the card,
    then again on the same checkpoint directory with more steps: the
    second run must resume at the first's last step."""
    here = pathlib.Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(here / "src"))
    runs = []
    for steps in L_LAUNCHER_STEPS:
        argv = ["--arch", arch, "--smoke", "--steps", str(steps),
                "--ckpt-every", "10", "--ckpt-dir", str(root / "ck")]
        t = time.monotonic()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                            *argv], cwd=here, env=env, capture_output=True,
                           text=True, timeout=300)
        lines = r.stdout.splitlines()
        runs.append({"argv": argv, "rc": r.returncode,
                     "s": time.monotonic() - t,
                     "steps_printed": [int(ln.split()[1]) for ln in lines
                                       if ln.startswith("step ")],
                     "resumed": [ln for ln in lines if ln.startswith("resuming")],
                     "last": lines[-2:], "stderr": r.stderr[-2000:]})
    first, second = runs
    check(first["rc"] == 0 and second["rc"] == 0, f"{tag} runs {runs}")
    check(not first["resumed"] and first["steps_printed"][0] == 0
          and first["last"][-1] == "done", f"{tag} first run {first}")
    resume = L_LAUNCHER_STEPS[0]
    check(second["resumed"] and second["resumed"][0].startswith(
        f"resuming at step {resume} ")
          and second["steps_printed"][0] == resume
          and second["last"][-1] == "done", f"{tag} second run {second}")
    return {"runs": runs, "resumed_at": resume}


def phase_l(smi) -> tuple:
    """The dense LM and its training substrate on the card (see the module
    doc); every check raises.  -> (the phase line, the six kernels'
    launches: all 0, the LM path reaches none of them)."""
    import dataclasses
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts

    torch.cuda.empty_cache()
    reset_launches()
    held = torch.cuda.memory_allocated()
    cfg = get_arch(L_ARCH).cfg
    t_phase = time.monotonic()
    root = pathlib.Path(tempfile.mkdtemp(prefix="phase_l_"))
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # bf16 products accumulate in f32 end to end, as the reference's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    pool = ThreadPoolExecutor(1)
    try:
        l4 = pool.submit(l4_launcher, root / "l4")
        line = {"phase": "L", "device": smi, "arch": L_ARCH,
                "held_bytes_at_start": held}
        line["L0"] = l0_parity(dataclasses.replace(cfg, n_layers=L0_LAYERS),
                               "cuda")
        progress(f"L0: {line['L0']}")
        line["L1"] = l1_train(cfg, "cuda")
        progress(f"L1: {line['L1']}")
        line["L2"], model = l2_resume(cfg, "cuda", root)
        progress(f"L2: {line['L2']}")
        line["L3"] = l3_serve(model, "cuda")
        progress(f"L3: {line['L3']}")
        del model
        line["L4"] = l4.result()
    finally:
        pool.shutdown(wait=True)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = launch_counts()
    check(not any(launches.values()),
          f"L: the LM path launched a search kernel: {launches}")
    line.update(launches=launches, phase_s=time.monotonic() - t_phase,
                cuts={"train_4k": f"batch {L_BATCH} at accum {L_ACCUM} "
                                  "(256 at accum 8 in the reference)",
                      "prefill_32k": "batch 1 (32)",
                      "decode_32k": f"batch {L_DECODE_BATCH} (128)"})
    return line, launches


# ----------------------------------------------------------------- phase M
M_RECSYS = ("xdeepfm", "autoint", "din", "bst")
M_STEPS = 4                        # train_batch steps a model
M_ACCUM = {"xdeepfm": 2}           # CIN's (B, D, H*m) product: 65,536 rows
                                   # at accum 2, the smallest under ~60 GB
                                   # (51.2 GB; 29.3 at accum 4; accum 1
                                   # would hold about 95)
M_RESUME = "din"                   # 2 + 2 steps and a resume against 4
M_SERVE_REPS = 5
M_BULK_CHUNK = {"xdeepfm": 16_384}  # serve_bulk in row chunks (CIN again)
M_PAGE, M_K, M_TRIM = 512, 100, 0.05
M0_BATCH, M0_GIN_LAYERS = 256, 2
M_GIN_STEPS = 3
M_GRAPHS = {                       # the raw graphs, padded to SHAPES' sizes
    "full_graph_sm": (2_708, 10_556),        # Cora
    "ogb_products": (2_449_029, 61_859_140),  # ogbn-products, in full
}
M_REDDIT = (232_965, 11_606_919)   # Reddit as Cluster-GCN tabulates it
M_FANOUTS, M_SEEDS = (15, 10), 1_024
# the CPU parity tests' bounds (tests/test_torch_recsys.py, test_torch_gnn.py)
M0_FWD, M0_LOSS, M0_GRAD_NORM, M0_GRAD_COS, M0_ADAMW = 2e-6, 1e-6, 1e-6, 0.99999, 1e-6


def m_peak_reset(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def m_peak(dev):
    return (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else None)


def m_ms(fn, dev) -> float:
    """Host milliseconds of one call of ``fn``, synchronised before and
    after (what a caller waits)."""
    l_sync(dev)
    t = time.monotonic()
    fn()
    l_sync(dev)
    return (time.monotonic() - t) * 1e3


def m_median(xs):
    return sorted(xs)[len(xs) // 2]


def m_batch(arch, cfg, batch, seed, dev) -> dict:
    from repro_torch.data import recsys_batch

    rng = np.random.default_rng(seed)
    if arch.seq:
        b = recsys_batch(rng, batch, 1, [cfg.item_vocab], seq_len=cfg.seq_len)
    else:
        b = recsys_batch(rng, batch, cfg.n_sparse, cfg.vocab_sizes)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def m_pad_graph(g, nodes, edges) -> dict:
    """A ``random_graph`` padded to ``nodes`` x ``edges``: zero rows,
    label_mask 0, -1 edges (the reference's x512 pads)."""
    n, e = g["x"].shape[0], g["edge_src"].shape[0]
    x = np.zeros((nodes, g["x"].shape[1]), np.float32)
    x[:n] = g["x"]
    out = {"x": x}
    for k in ("edge_src", "edge_dst"):
        out[k] = np.full(edges, -1, np.int32)
        out[k][:e] = g[k]
    out["labels"] = np.zeros(nodes, np.int32)
    out["labels"][:n] = g["labels"]
    out["label_mask"] = np.zeros(nodes, np.float32)
    out["label_mask"][:n] = g["label_mask"]
    return out


def m_molecule(rng, info) -> dict:
    """``molecule``: B graphs of up to N nodes (10 to N live, the rest
    masked) and E edges among the live nodes, the last few -1."""
    B, N, E = info["batch"], info["nodes"], info["edges"]
    live = rng.integers(10, N + 1, size=B)
    src = (rng.random((B, E)) * live[:, None]).astype(np.int32)
    dst = (rng.random((B, E)) * live[:, None]).astype(np.int32)
    pad = np.arange(E)[None, :] >= E - rng.integers(0, 8, size=B)[:, None]
    src[pad] = dst[pad] = -1
    return {"x": rng.normal(size=(B, N, info["d_in"])).astype(np.float32),
            "edge_src": src, "edge_dst": dst,
            "node_mask": (np.arange(N)[None, :] < live[:, None]).astype(np.float32),
            "labels": rng.integers(0, info["classes"], size=B).astype(np.int32)}


def m_to(b, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in b.items()}


class MChecks:
    """A phase's checks (M's, O's): each failure is kept, and the phase
    raises them all at its end (one run reports every bound it broke)."""

    def __init__(self, phase: str = "M"):
        self.phase = phase
        self.failed = []

    def __call__(self, cond: bool, what: str) -> None:
        if not cond:
            self.failed.append(what)
            progress(f"{self.phase} check failed: {what}")

    def raise_any(self) -> None:
        check(not self.failed, f"phase {self.phase}: {len(self.failed)} "
              f"checks failed: {self.failed}")


def m0_compare(models, batches, loss_fn, outputs, mcheck, ctx) -> dict:
    """``models`` on the CPU and the card (the same weights): each of
    ``outputs`` (name -> fn(model, batch)), the loss, the gradients and
    one AdamW step fed the CPU's gradients, against the CPU."""
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.tree import tree_leaves, tree_map

    out = {}
    with torch.no_grad():
        for name, fn in outputs.items():
            got = {d: fn(m, batches[d]) for d, m in models.items()}
            out[f"{name}_rel"] = l_rel(got["card"], got["cpu"])
            mcheck(out[f"{name}_rel"] <= M0_FWD, f"M0 {ctx} {name} {out}")
    loss, grads = {}, {}
    for d, m in models.items():
        l = loss_fn(m, batches[d])
        l.backward()
        loss[d] = float(l.detach())
        grads[d] = m.tree(grads=True)
        m.zero_grad(set_to_none=True)
    out["loss_rel"] = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    flat = {d: torch.cat([g.double().reshape(-1).cpu() for g in tree_leaves(t)])
            for d, t in grads.items()}
    na, nb = float(flat["cpu"].norm()), float(flat["card"].norm())
    out["grad_norm_rel"] = abs(na - nb) / na
    out["grad_cos"] = float(flat["cpu"] @ flat["card"]) / (na * nb)
    new = {}
    for d, m in models.items():
        dev = next(m.parameters()).device
        tree = m.tree()
        new[d] = adamw_update(tree_map(lambda t: t.to(dev), grads["cpu"]),
                              adamw_init(tree), tree, AdamWConfig(), 0.5)
    out["adamw_rel"] = max(l_rel(a, b) for a, b in zip(tree_leaves(new["card"]),
                                                       tree_leaves(new["cpu"]))
                           if b.abs().max() > 0)
    mcheck(out["loss_rel"] <= M0_LOSS, f"M0 {ctx} loss {loss}")
    mcheck(out["grad_norm_rel"] <= M0_GRAD_NORM and out["grad_cos"] >= M0_GRAD_COS,
           f"M0 {ctx} gradients {out}")
    mcheck(out["adamw_rel"] <= M0_ADAMW, f"M0 {ctx} AdamW step {out['adamw_rel']}")
    return out


def m0_repeat(make_model, loss_fn, batch, mcheck, ctx) -> int:
    """Two training steps from one seeded model, run twice on the card:
    every parameter and AdamW moment bit-equal.  -> leaves compared."""
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.tree import tree_leaves

    runs = []
    for _ in range(2):
        m = make_model()
        o = adamw_init(m)
        step = make_train_step(loss_fn, AdamWConfig(lr=1e-2))
        for _ in range(2):
            m, o, _ = step(m, o, batch)
        runs.append(tree_leaves({"p": m.tree(), "o": o}))
    differ = [i for i, (a, b) in enumerate(zip(*runs)) if not torch.equal(a, b)]
    mcheck(not differ, f"M0 {ctx}: {len(differ)} of {len(runs[0])} leaves differ "
           "between two identical runs")
    return len(runs[0])


def m0_parity(dev, mcheck) -> dict:
    """The four recsys models at their smoke configs and GIN at 2 layers of
    full_graph_sm's widths, on ``dev`` against the CPU, and each trained
    twice on ``dev`` for two steps, bit-equal."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data import random_graph
    from repro_torch.models.gnn import gin
    from repro_torch.models.recsys.models import bce_loss

    t0 = time.monotonic()
    out = {}
    for arch_id in M_RECSYS:
        arch = get_arch(arch_id)
        cfg = arch.smoke_cfg
        cpu = arch.init_fn(cfg, device="cpu", seed=1)
        models = {"cpu": cpu,
                  "card": arch.init_fn(cfg, device=dev, seed=1).load_tree(cpu.tree())}
        batches = {"cpu": m_batch(arch, cfg, M0_BATCH, 7, "cpu")}
        batches["card"] = {k: v.to(dev) for k, v in batches["cpu"].items()}
        loss_fn = lambda m, b, a=arch, c=cfg: bce_loss(a.forward_fn, m, b, c)
        out[arch_id] = m0_compare(
            models, batches, loss_fn,
            {"logits": lambda m, b, a=arch, c=cfg: a.forward_fn(m, b, c),
             "user": lambda m, b, a=arch, c=cfg: a.user_fn(m, b, c)},
            mcheck, arch_id)
        out[arch_id]["repeat_leaves"] = m0_repeat(
            lambda a=arch, c=cfg: a.init_fn(c, device=dev, seed=1), loss_fn,
            batches["card"], mcheck, arch_id)
    arch = get_arch("gin-tu")
    cfg = dataclasses.replace(arch.cfg_for("full_graph_sm"), n_layers=M0_GIN_LAYERS)
    info = arch.SHAPES["full_graph_sm"]
    g = random_graph(np.random.default_rng(8), *M_GRAPHS["full_graph_sm"],
                     info["d_in"], info["classes"])
    batches = {"cpu": m_to(m_pad_graph(g, info["nodes"], info["edges"]), "cpu")}
    batches["card"] = {k: v.to(dev) for k, v in batches["cpu"].items()}
    cpu = gin.init_params(cfg, device="cpu", seed=1)
    models = {"cpu": cpu,
              "card": gin.init_params(cfg, device=dev, seed=1).load_tree(cpu.tree())}
    loss_fn = lambda m, b: gin.node_loss(m, b, cfg)
    out["gin-tu"] = m0_compare(
        models, batches, loss_fn,
        {"logits": lambda m, b: gin.node_forward(m, b["x"], b["edge_src"],
                                                 b["edge_dst"], cfg)},
        mcheck, "gin-tu")
    out["gin-tu"]["repeat_leaves"] = m0_repeat(
        lambda: gin.init_params(cfg, device=dev, seed=1), loss_fn,
        batches["card"], mcheck, "gin-tu")
    out["s"] = time.monotonic() - t0
    return out


def m1_train(arch_id, dev, mcheck) -> tuple:
    """``M_STEPS`` steps of ``make_train_step`` at the full config and
    ``train_batch``'s 65,536 rows (at ``M_ACCUM``), AdamW and a cosine
    schedule, from ``init_fn`` seeded on ``dev``.  -> (line, model)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.recsys.models import bce_loss
    from repro_torch.train import (AdamWConfig, adamw_init, cosine_schedule,
                                   make_train_step)

    arch = get_arch(arch_id)
    cfg = arch.cfg
    B = arch.SHAPES["train_batch"]["batch"]
    accum = M_ACCUM.get(arch_id, 1)
    m_peak_reset(dev)
    t0 = time.monotonic()
    model = arch.init_fn(cfg, device=dev, seed=0)
    opt = adamw_init(model)
    l_sync(dev)
    init_s = time.monotonic() - t0
    step = make_train_step(lambda m, b: bce_loss(arch.forward_fn, m, b, cfg),
                           AdamWConfig(), accum=accum,
                           lr_schedule=cosine_schedule(1, M_STEPS))
    times, losses, norms = [], [], []
    for i in range(M_STEPS):
        batch = m_batch(arch, cfg, B, 100 + i, dev)
        l_sync(dev)
        t = time.monotonic()
        model, opt, m = step(model, opt, batch)
        l_sync(dev)
        times.append(time.monotonic() - t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del opt
    mcheck(abs(losses[0] - math.log(2)) <= 0.1,
           f"M1 {arch_id} step-0 loss {losses[0]}, ln 2 = {math.log(2)}")
    mcheck(all(math.isfinite(x) for x in losses + norms),
           f"M1 {arch_id} losses {losses}, grad norms {norms}")
    steady = m_median(times[1:])
    return {"params": sum(p.numel() for p in model.parameters()),
            "batch": B, "accum": accum, "init_s": init_s, "step_s": times,
            "step_s_median_after_first": steady,
            "examples_per_s": B / steady, "loss": losses,
            "grad_norm": norms, "peak_bytes": m_peak(dev)}, model


def m1_resume(dev, root, mcheck) -> dict:
    """``M_RESUME`` at its full config: ``M_STEPS`` steps straight against
    half of them, a checkpoint, and a resume to ``M_STEPS`` through
    ``run_train_loop``; every parameter and AdamW moment bit-equal."""
    from repro_torch.configs import get_arch
    from repro_torch.models.recsys.models import bce_loss
    from repro_torch.train import (AdamWConfig, TrainLoopConfig, adamw_init,
                                   cosine_schedule, make_train_step,
                                   run_train_loop)
    from repro_torch.train.tree import tree_leaves

    arch = get_arch(M_RESUME)
    cfg = arch.cfg
    B = arch.SHAPES["train_batch"]["batch"]
    m_peak_reset(dev)
    step = make_train_step(lambda m, b: bce_loss(arch.forward_fn, m, b, cfg),
                           AdamWConfig(), lr_schedule=cosine_schedule(1, M_STEPS))
    ran = []

    def counted(m, o, b):
        ran.append(1)
        return step(m, o, b)

    def fresh():
        m = arch.init_fn(cfg, device=dev, seed=0)
        return m, adamw_init(m)

    def run(steps, name, every):
        n = len(ran)
        t = time.monotonic()
        model, opt, _ = run_train_loop(
            counted, *fresh(), lambda i: m_batch(arch, cfg, B, 100 + i, dev),
            TrainLoopConfig(steps, str(root / name), ckpt_every=every))
        return {"params": model.tree(), "opt": opt}, time.monotonic() - t, len(ran) - n

    half = M_STEPS // 2
    straight, straight_s, n_a = run(M_STEPS, "a", M_STEPS)
    _, half_s, _ = run(half, "b", half)
    resumed, resume_s, n_b = run(M_STEPS, "b", half)
    leaves = list(zip(tree_leaves(straight), tree_leaves(resumed)))
    differ = [k for k, (a, b) in enumerate(leaves) if not torch.equal(a, b)]
    mcheck(n_a == M_STEPS and n_b == M_STEPS - half,
           f"M1 resume ran {n_a} and {n_b} steps: not resumed at {half}")
    mcheck(not differ, f"M1 resume: {len(differ)} of {len(leaves)} leaves "
           "(params, then AdamW's) differ from the straight run")
    ckpt = root / "b" / f"step_{half:08d}"
    size = sum(f.stat().st_size for f in ckpt.iterdir())
    return {"arch": M_RESUME, "steps": M_STEPS, "resumed_at": half,
            "leaves": len(leaves), "bit_equal": not differ,
            "checkpoint_bytes": size, "straight_s": straight_s,
            "half_and_save_s": half_s, "restore_and_finish_s": resume_s,
            "peak_bytes": m_peak(dev)}


def m2_serve(arch_id, arch, model, dev, mcheck) -> dict:
    """``serve_p99`` (the first 512 rows of the bulk batch) and
    ``serve_bulk`` forward under no_grad: median ms of ``M_SERVE_REPS``
    calls after a warm-up; the p99 logits the bulk's first rows."""
    cfg = arch.cfg
    B = arch.SHAPES["serve_bulk"]["batch"]
    bulk = m_batch(arch, cfg, B, 200, dev)
    small = {k: v[:arch.SHAPES["serve_p99"]["batch"]] for k, v in bulk.items()}
    chunk = M_BULK_CHUNK.get(arch_id, B)

    @torch.no_grad()
    def fwd(b):
        n = b["dense"].shape[0]
        return torch.cat([arch.forward_fn(model, {k: v[i:i + chunk]
                                                  for k, v in b.items()}, cfg)
                          for i in range(0, n, chunk)])

    m_peak_reset(dev)
    out = {}
    logits = {}
    for name, b in (("serve_p99", small), ("serve_bulk", bulk)):
        logits[name] = fwd(b)
        ms = [m_ms(lambda: fwd(b), dev) for _ in range(M_SERVE_REPS)]
        out[name] = {"batch": b["dense"].shape[0], "ms": ms,
                     "ms_median": m_median(ms),
                     "rows_per_s": b["dense"].shape[0] * 1e3 / m_median(ms)}
        mcheck(logits[name].shape == (b["dense"].shape[0],)
               and bool(torch.isfinite(logits[name]).all()),
               f"M2 {arch_id} {name} logits")
    n = small["dense"].shape[0]
    out["p99_vs_bulk_rows_rel"] = l_rel(logits["serve_p99"], logits["serve_bulk"][:n])
    mcheck(out["p99_vs_bulk_rows_rel"] <= 1e-5,
           f"M2 {arch_id}: a row's logit depends on its batch "
           f"({out['p99_vs_bulk_rows_rel']})")
    out["bulk_chunk_rows"] = chunk
    out["peak_bytes"] = m_peak(dev)
    return out


def m_same_up_to_near_ties(ids, scores, want_ids, want_scores, tol) -> tuple:
    """``retrieval_step``'s top-k at page = N against the brute force's
    top-(k + 1), rank by rank.  A run of ranks whose neighbouring
    brute-force scores lie within ``tol`` of each other may hold its ids
    in another order, and one that reaches rank k + 1 may lend that rank's
    id to the top-k; elsewhere the ids are equal.  Every score is within
    ``tol`` plus its run's span of the brute force's.  -> (ok, ranks in
    such runs)."""
    k = ids.shape[1]
    ok, tied = True, 0
    for q in range(ids.shape[0]):
        s, a, b = want_scores[q].tolist(), ids[q].tolist(), want_ids[q].tolist()
        got = scores[q].tolist()
        i = 0
        while i < k:
            j = i
            while j + 1 < len(s) and s[j] - s[j + 1] <= tol:
                j += 1
            hi = min(j, k - 1)
            ok &= set(a[i:hi + 1]) <= set(b[i:j + 1])
            ok &= all(abs(got[r] - s[r]) <= tol + s[i] - s[j]
                      for r in range(i, hi + 1))
            tied += hi + 1 - i if j > i else 0
            i = j + 1
    return ok, tied


def m3_retrieval(arch, model, dev, gen, mcheck) -> dict:
    """``retrieval_cand``: the user tower on one request, then
    ``retrieval_step`` over ``n_cand`` seeded Gaussian candidates of the
    model's embed_dim (page ``M_PAGE``, k ``M_K``, trim ``M_TRIM``):
    at page = N the ids of ``brute_force_retrieval`` but where two
    candidates' scores lie within ``4 * D * 2**-24`` of each other (each
    product's float32 dot of unit vectors is within D * 2**-24 of the
    exact one, so the two can order two candidates differently only
    there), the page's ids those of the same phase 1 on the CPU,
    recall@k at ``M_PAGE``, ms of both, phase 1's counts of the exact
    top-k beside the page's lowest; and the side check, ``code_match``
    through its wrapper on the same (1 x N x D) problem against
    ``score_codes``, its launches read as the wrapper's count after less
    before (the phase takes them off the path's count)."""
    from repro_torch.core.codes import score_codes
    from repro_torch.core.encoding import RoundingEncoder
    from repro_torch.core.filtering import TrimFilter, expand_mask, feature_mask
    from repro_torch.core.rerank import normalize
    from repro_torch.kernels.code_match import ops as cm_ops
    from repro_torch.obs import cost
    from repro_torch.serve.retrieval import (brute_force_retrieval,
                                             encode_candidates, retrieval_page,
                                             retrieval_step)

    cfg = arch.cfg
    N = arch.SHAPES["retrieval_cand"]["n_cand"]
    D = cfg.embed_dim
    with torch.no_grad():
        u = arch.user_fn(model, m_batch(arch, cfg, 1, 300, dev), cfg)
    cand = torch.randn((N, D), generator=gen, device=dev)
    t = time.monotonic()
    vecs, codes = encode_candidates(cand)
    l_sync(dev)
    out = {"embed_dim": D, "n_cand": N, "encode_s": time.monotonic() - t}
    step = lambda page: retrieval_step(u, vecs, codes, page=page, k=M_K,
                                       trim_threshold=M_TRIM)
    ids, scores = step(M_PAGE)
    wids, wscores = brute_force_retrieval(u, vecs, k=M_K + 1)
    bids = wids[:, :M_K]
    ms = [m_ms(lambda: step(M_PAGE), dev) for _ in range(M_SERVE_REPS)]
    bms = [m_ms(lambda: brute_force_retrieval(u, vecs, k=M_K), dev)
           for _ in range(M_SERVE_REPS)]
    hits = len(set(ids[0].tolist()) & set(bids[0].tolist()))
    out.update(retrieval_ms=ms, retrieval_ms_median=m_median(ms),
               brute_force_ms=bms, brute_force_ms_median=m_median(bms),
               recall_at_k=hits / M_K, k=M_K, page=M_PAGE)
    nids, nscores = step(N)
    tol = 4 * D * 2.0 ** -24
    same, tied = m_same_up_to_near_ties(nids, nscores, wids, wscores, tol)
    out["page_n_exact"], out["page_n_tied_ranks"] = same, tied
    out["page_n_tie_tol"] = tol
    mcheck(same, f"M3 {cfg.name}: page = N is not the brute force "
           f"({nids[0, :10].tolist()} vs {bids[0, :10].tolist()})")
    _, page = retrieval_page(u, codes, page=M_PAGE, trim_threshold=M_TRIM)
    _, cpu_page = retrieval_page(u.cpu(), codes.cpu(), page=M_PAGE,
                                 trim_threshold=M_TRIM)
    out["page_equals_cpu"] = torch.equal(page.cpu(), cpu_page)
    mcheck(out["page_equals_cpu"], f"M3 {cfg.name}: the card's page is not "
           "the CPU's")
    # side check: the code-match kernel on the same problem
    q = normalize(u.float())
    enc = RoundingEncoder(2)
    qcodes = enc.encode(q)
    w = torch.where(expand_mask(feature_mask(q, trim=TrimFilter(M_TRIM)), D),
                    1.0, 0.0)
    plain = score_codes(codes, qcodes, w)
    # why recall is what it is: phase 1's counts of the exact top-k
    # against the page's lowest count, and how many candidates tie there
    top = plain[0, bids[0].long()]
    cut = plain[0, page[0, -1]]
    out["phase1"] = {"query_tokens": int(w.sum()),
                     "top_k_counts_mean": float(top.mean()),
                     "top_k_counts_max": float(top.max()),
                     "page_lowest_count": float(cut),
                     "candidates_at_or_above_it": int((plain[0] >= cut).sum())}
    before = cm_ops.launches
    got = cm_ops.code_match(codes, qcodes, w)
    if torch.device(dev).type == "cuda":
        kernel_ms = cuda_ms(lambda: cm_ops.code_match(codes, qcodes, w), 20)
        plain_ms = cuda_ms(lambda: score_codes(codes, qcodes, w), 20)
    else:                          # a rehearsal on the CPU: no kernel
        kernel_ms = plain_ms = None
    side = cm_ops.launches - before
    mcheck(side > 0 or torch.device(dev).type != "cuda",
           f"M3 {cfg.name}: the code_match side check launched no kernel")
    err = float((got - plain).abs().max())
    mcheck(err <= 1e-5, f"M3 {cfg.name}: code_match vs score_codes {err}")
    bound, by = cost.bound_ms(cost.code_match_work(N, 1, D, codes.element_size()))
    out["code_match_side_check"] = {
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by,
        "launches": side}
    return out


def m4_gin(shape, dev, rng, mcheck) -> dict:
    """gin-tu at ``shape`` (``GNNArch.SHAPES``): ``M_GIN_STEPS`` AdamW steps
    of ``make_train_step``, seconds a step and peak memory.  Graphs are
    ``random_graph``s of the named datasets' sizes padded to the shape's;
    ``minibatch_lg`` samples a fresh block a step from Reddit's size."""
    from repro_torch.configs import get_arch
    from repro_torch.data import random_graph
    from repro_torch.models.gnn import gin, sampler
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    arch = get_arch("gin-tu")
    info = arch.SHAPES[shape]
    cfg = arch.cfg_for(shape)
    out = {"shape": shape}
    t = time.monotonic()
    if shape == "molecule":
        batches = [m_to(m_molecule(rng, info), dev)] * M_GIN_STEPS
        loss = lambda m, b: gin.graph_loss(m, b, cfg)
    elif shape == "minibatch_lg":
        g = random_graph(rng, *M_REDDIT, info["d_in"], info["classes"])
        csr = sampler.build_csr(M_REDDIT[0], g["edge_src"], g["edge_dst"],
                                g["x"], g["labels"])
        del g
        out["graph"] = {"nodes": M_REDDIT[0], "edges": M_REDDIT[1]}
        batches, sample_s = [], []
        for _ in range(M_GIN_STEPS):
            ts = time.monotonic()
            seeds = rng.choice(M_REDDIT[0], size=M_SEEDS, replace=False)
            blk = sampler.sample_block(csr, seeds, M_FANOUTS, rng)
            sample_s.append(time.monotonic() - ts)
            batches.append(m_to(blk, dev))
        out["sample_s"] = sample_s
        out["block"] = {"nodes": int(batches[0]["x"].shape[0]),
                        "edges": int(batches[0]["edge_src"].shape[0]),
                        "live_edges": int((batches[0]["edge_src"] >= 0).sum())}
        loss = lambda m, b: gin.node_loss(m, b, cfg)
    else:
        n, e = M_GRAPHS[shape]
        g = m_pad_graph(random_graph(rng, n, e, info["d_in"], info["classes"]),
                        info["nodes"], info["edges"])
        batches = [m_to(g, dev)] * M_GIN_STEPS
        del g
        out["graph"] = {"nodes": n, "edges": e, "padded_nodes": info["nodes"],
                        "padded_edges": info["edges"]}
        loss = lambda m, b: gin.node_loss(m, b, cfg)
    out["data_s"] = time.monotonic() - t
    m_peak_reset(dev)
    model = gin.init_params(cfg, device=dev, seed=0)
    opt = adamw_init(model)
    step = make_train_step(loss, AdamWConfig())
    times, losses = [], []
    for b in batches:
        l_sync(dev)
        t = time.monotonic()
        model, opt, m = step(model, opt, b)
        l_sync(dev)
        times.append(time.monotonic() - t)
        losses.append(float(m["loss"]))
    mcheck(all(math.isfinite(x) for x in losses), f"M4 {shape} losses {losses}")
    out.update(d_in=cfg.d_in, classes=cfg.n_classes, step_s=times,
               step_s_median=m_median(times), loss=losses,
               peak_bytes=m_peak(dev))
    return out


def phase_m(smi, dev="cuda") -> tuple:
    """The recsys and GIN families on the card (see the module doc).
    -> (the phase line, the five search kernels' launches on its path: all
    0, checked; the code_match side check's launches are in the line)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts

    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(0)
    else:
        gen = torch.Generator().manual_seed(0)
    reset_launches()
    mcheck = MChecks()
    t_phase = time.monotonic()
    line = {"phase": "M", "device": smi}
    line["M0"] = m0_parity(dev, mcheck)
    progress(f"M0: {line['M0']}")
    line["M1"], line["M2"], line["M3"] = {}, {}, {}
    side = 0
    for arch_id in M_RECSYS:
        line["M1"][arch_id], model = m1_train(arch_id, dev, mcheck)
        progress(f"M1 {arch_id}: {line['M1'][arch_id]}")
        arch = get_arch(arch_id)
        line["M2"][arch_id] = m2_serve(arch_id, arch, model, dev, mcheck)
        progress(f"M2 {arch_id}: {line['M2'][arch_id]}")
        line["M3"][arch_id] = m3_retrieval(arch, model, dev, gen, mcheck)
        side += line["M3"][arch_id]["code_match_side_check"]["launches"]
        progress(f"M3 {arch_id}: {line['M3'][arch_id]}")
        del model
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    root = pathlib.Path(tempfile.mkdtemp(prefix="phase_m_"))
    try:
        line["M1"]["resume"] = m1_resume(dev, root, mcheck)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    progress(f"M1 resume: {line['M1']['resume']}")
    rng = np.random.default_rng(0)
    line["M4"] = {}
    for shape in get_arch("gin-tu").SHAPES:
        line["M4"][shape] = m4_gin(shape, dev, rng, mcheck)
        progress(f"M4 {shape}: {line['M4'][shape]}")
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
    launches = launch_counts()
    launches["code_match"] -= side      # the side checks' own, measured
    mcheck(not any(launches.values()),
           f"M: the recsys and GIN path launched a search kernel: {launches}")
    line.update(launches=launches, side_check_launches={"code_match": side},
                phase_s=time.monotonic() - t_phase,
                cuts={"xdeepfm train_batch": f"65,536 rows at accum "
                                             f"{M_ACCUM['xdeepfm']}",
                      "xdeepfm serve_bulk": f"row chunks of "
                                            f"{M_BULK_CHUNK['xdeepfm']:,}"})
    mcheck.raise_any()
    return line, launches


# ----------------------------------------------------------------- phase N
N_MIXTRAL, N_LLAMA4 = "mixtral-8x22b", "llama4-maverick-400b-a17b"
N_ARCHS = (N_MIXTRAL, N_LLAMA4)
N_TRAIN_CUT = {N_MIXTRAL: dict(n_layers=1),          # 1 of its 56 layers
               N_LLAMA4: dict(n_layers=4,            # one super-block of 12,
                              moe_experts=16)}       # 16 of its 128 experts
N_PARAMS = {N_MIXTRAL: 2_906_714_112, N_LLAMA4: 6_850_682_880}
N_SEQ, N_BATCH, N_STEPS = 4_096, 16, 4     # train_4k's length, batch 16
N_ACCUM = {N_MIXTRAL: 8, N_LLAMA4: 16}     # the smallest in {4, 8, 16} whose
                                           # step stays under ~75 GB
N2_BATCH, N2_ACCUM, N2_STEPS = 2, 2, 6     # llama4's cut: 6 against 3 + 3
N_SERVE_LAYERS = 8                         # mixtral serves 8 of 56, in bf16
N_SERVE_PARAMS = 20_435_140_608
N_PREFILL = 32_768                         # prefill_32k's length, batch 1
N_LONG = 65_536                            # two moe_token_chunk chunks
N_CHECK_SEQ, N_CHECK_BATCH = 4_096, 4      # serve_step against forward
N_CHECK_CHUNK = 4_096                      # its moe_token_chunk (memory)
N_SERVE_KV_CHUNK = 256                     # serving's kv_chunk (1,024 in the
                                           # configs): attention holds (S, H,
                                           # kv_chunk) f32 scores of every
                                           # query chunk at once, 5.4-6.4 GB
                                           # a tensor at 32,768 x 40-48 heads
N_DECODE_BATCH = 64                        # decode_32k at batch 64 (128)
N_DECODE_CACHE, N_DECODE_PROMPT, N_DECODE_STEPS = 32_768, 512, 16
N0_BATCH, N0_SEQ = 4, 64                   # the smoke models card vs CPU
N0_MOE_TOKENS, N0_MOE_CF = 256, 8.0        # one moe_ffn at mixtral's widths
N_GAP = 1e-5                               # routing held equal above it
# the CPU parity tests' bounds (tests/test_torch_moe.py): logits, aux,
# loss, gradient norm and cosine, one optimizer step fed the same
# gradients; y and aux of the one moe_ffn
N0_LOGITS, N0_AUX, N0_LOSS = 2e-2, 1e-4, 2e-3
N0_GRAD_NORM, N0_GRAD_COS, N0_STEP = 1e-2, 0.999, 1e-6
N0_MOE_Y = 1e-2


class NRoutes:
    """Taps ``repro_torch.models.transformer.moe.route`` while entered:
    each call's MoE layer (its index in ``model.layers``), token count,
    top-k and the expert counts of its (token, choice) pairs, and with
    ``keep`` its probabilities and choices.  ``force`` ({layer: choices})
    replaces a layer's choices by the given ones, gates recomputed from
    the call's own probabilities (``moe.gate_values``): how the card runs
    the CPU's routing, which bf16 noise could otherwise flip at near
    ties."""

    def __init__(self, model=None, keep=False, force=None):
        from repro_torch.models.transformer import moe

        self.moe, self.keep, self.force = moe, keep, force
        self.layer = {} if model is None else {
            id(layer.moe["router"]): i for i, layer in enumerate(model.layers)
            if layer.kind.moe}
        self.calls = []

    def __enter__(self):
        real = self.real = self.moe.route

        def route(p, x, top_k):
            probs, idx, gates = real(p, x, top_k)
            i = self.layer.get(id(p["router"]))
            if self.force is not None:
                idx = self.force[i].to(x.device)
                gates = self.moe.gate_values(probs, idx)
            E = probs.shape[1]
            counts = (idx.reshape(-1, 1)
                      == torch.arange(E, device=x.device)).sum(0)
            call = {"layer": i, "T": x.shape[0], "k": top_k, "counts": counts}
            if self.keep:
                call.update(probs=probs.detach(), idx=idx)
            self.calls.append(call)
            return probs, idx, gates

        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real

    def first(self) -> dict:
        """{layer: the choices of its first call}."""
        out = {}
        for c in self.calls:
            out.setdefault(c["layer"], c["idx"])
        return out

    def dropped(self, cf: float) -> tuple:
        """-> (pairs dropped, pairs) over the calls at capacity factor cf."""
        dropped = pairs = 0
        for c in self.calls:
            E = c["counts"].numel()
            cap = max(1, math.ceil(c["T"] * c["k"] / E * cf))
            dropped += int(torch.clamp(c["counts"] - cap, min=0).sum())
            pairs += c["T"] * c["k"]
        return dropped, pairs


def n_gaps(probs, k: int):
    """Each token's gap between its k-th and (k+1)-th probability."""
    s = torch.sort(probs.float(), dim=-1, descending=True).values
    return s[:, k - 1] - s[:, k]


def n_flips(got: dict, want: dict, want_probs: dict, k: int) -> dict:
    """Tokens whose choices differ, by layer, with the smallest and largest
    of their gaps in ``want_probs``."""
    out = {}
    for i, w in want.items():
        diff = (got[i].cpu() != w.cpu()).any(-1)
        gaps = n_gaps(want_probs[i].cpu(), k)[diff]
        out[str(i)] = {"tokens": int(diff.sum()),
                       "gaps": [float(gaps.min()), float(gaps.max())]
                       if len(gaps) else []}
    return out


def n_cfg(model, cfg):
    """Give ``model`` and each of its layers ``cfg`` (a field change that
    keeps the parameters' shapes) -> the previous one."""
    was = model.cfg
    model.cfg = cfg
    for layer in model.layers:
        layer.cfg = cfg
    return was


def n0_smoke(arch_id, dev) -> dict:
    """The arch's smoke model on ``dev`` against the CPU, params carried
    from one seeded CPU tree, the card running the CPU's routing: logits,
    aux, lm_loss, gradients, and one step of the arch's optimizer fed the
    CPU's gradients, within the CPU tests' bounds; the routing the card
    picks on its own counted against the CPU's; two identical training
    steps run twice on the card, every leaf bit-equal."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as lm
    from repro_torch.train import (AdamWConfig, adafactor_init,
                                   adafactor_update, adamw_init, adamw_update,
                                   make_train_step)
    from repro_torch.train.tree import tree_leaves, tree_map

    arch = get_arch(arch_id)
    cfg = arch.smoke()
    init, update = {"adamw": (adamw_init, adamw_update),
                    "adafactor": (adafactor_init, adafactor_update)}[arch.optimizer]
    cpu = lm.init_params(cfg, device="cpu", seed=1)
    card = lm.LM(cfg, device=dev).load_tree(cpu.tree())
    batch = {"cpu": l_batch(5, N0_BATCH, N0_SEQ, cfg.vocab, "cpu")}
    batch["card"] = {k: v.to(dev) for k, v in batch["cpu"].items()}
    models = {"cpu": cpu, "card": card}
    with NRoutes(cpu, keep=True) as tap, torch.no_grad():
        lg_cpu, aux_cpu = cpu(batch["cpu"]["tokens"])
    want, want_p = tap.first(), {c["layer"]: c["probs"] for c in tap.calls}
    with NRoutes(card, keep=True) as tap, torch.no_grad():
        card(batch["card"]["tokens"])
    flips = n_flips(tap.first(), want, want_p, cfg.moe_top_k)
    with NRoutes(card, force=want), torch.no_grad():
        lg_card, aux_card = card(batch["card"]["tokens"])
    out = {"logits_rel": l_rel(lg_card, lg_cpu),
           "aux": {"cpu": float(aux_cpu), "card": float(aux_card)},
           "unforced_flips": flips}
    loss, grads = {}, {}
    for name, m in models.items():
        with NRoutes(m, force=None if name == "cpu" else want):
            l = lm.lm_loss(m, batch[name])
            l.backward()
        loss[name] = float(l.detach())
        grads[name] = m.tree(grads=True)
        m.zero_grad(set_to_none=True)
    out["loss"] = loss
    out["loss_rel"] = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    flat = {n: torch.cat([g.double().reshape(-1).cpu() for g in tree_leaves(t)])
            for n, t in grads.items()}
    na, nb = float(flat["cpu"].norm()), float(flat["card"].norm())
    out["grad_norm_rel"] = abs(na - nb) / na
    out["grad_cos"] = float(flat["cpu"] @ flat["card"]) / (na * nb)
    new = {}
    for name, m in models.items():             # the CPU's gradients on both
        d = next(m.parameters()).device
        tree = m.tree()
        new[name] = update(tree_map(lambda t: t.to(d), grads["cpu"]),
                           init(tree), tree, AdamWConfig(), 0.5)
    pairs = list(zip(tree_leaves(new["card"]), tree_leaves(new["cpu"])))
    out[f"{arch.optimizer}_rel"] = max(l_rel(a, b) for a, b in pairs
                                       if b.abs().max() > 0)
    check(out["logits_rel"] <= N0_LOGITS, f"N0 {arch_id} logits {out}")
    check(abs(out["aux"]["card"] - out["aux"]["cpu"])
          <= N0_AUX * abs(out["aux"]["cpu"]), f"N0 {arch_id} aux {out}")
    check(out["loss_rel"] <= N0_LOSS, f"N0 {arch_id} loss {loss}")
    check(out["grad_norm_rel"] <= N0_GRAD_NORM and out["grad_cos"] >= N0_GRAD_COS,
          f"N0 {arch_id} gradients {out}")
    check(out[f"{arch.optimizer}_rel"] <= N0_STEP, f"N0 {arch_id} step {out}")
    runs = []
    for _ in range(2):
        m = lm.init_params(cfg, device=dev, seed=2)
        step = make_train_step(lambda mm, b: lm.lm_loss(mm, b),
                               AdamWConfig(lr=1e-2), accum=2,
                               optimizer=arch.optimizer)
        o = init(m)
        for i in range(2):
            m, o, _ = step(m, o, l_batch(10 + i, N0_BATCH, N0_SEQ, cfg.vocab, dev))
        runs.append(tree_leaves({"p": m.tree(), "o": o}))
    out["repeat_leaves"] = len(runs[0])
    out["repeat_bit_equal"] = all(torch.equal(a, b) for a, b in zip(*runs))
    check(out["repeat_bit_equal"], f"N0 {arch_id}: two identical runs differ")
    return out


def n0_moe(dev, gen) -> dict:
    """One moe_ffn at mixtral's layer widths (D 6,144, F 16,384, 8 experts,
    top-2, ``N0_MOE_TOKENS`` bf16 tokens, cf 8.0: nothing drops) on the
    card against the CPU: routing equal on every token whose top-2 gap
    exceeds ``N_GAP`` (those under it counted), y on the tokens routed
    alike within ``N0_MOE_Y`` of the largest, aux within ``N0_AUX`` where
    no first choice differs."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer.moe import moe_ffn, moe_init

    cfg = get_arch(N_MIXTRAL).cfg
    p = moe_init(cfg.d_model, cfg.d_ff, cfg.moe_experts, 0, gen, device=dev)
    x = torch.randn((N0_MOE_TOKENS, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    t = time.monotonic()
    with NRoutes(keep=True) as tap_cpu:
        y_cpu, aux_cpu = moe_ffn({k: v.cpu() for k, v in p.items()}, x.cpu(),
                                 cfg.moe_top_k, N0_MOE_CF)
    cpu_s = time.monotonic() - t
    with NRoutes(keep=True) as tap:
        y, aux = moe_ffn(p, x, cfg.moe_top_k, N0_MOE_CF)
    ms = cuda_ms(lambda: moe_ffn(p, x, cfg.moe_top_k, N0_MOE_CF), 5)
    want, got = tap_cpu.calls[0], tap.calls[0]
    gaps = n_gaps(want["probs"], cfg.moe_top_k)
    same = (got["idx"].cpu() == want["idx"]).all(-1)
    above = gaps > N_GAP
    first_same = bool((got["idx"][:, 0].cpu() == want["idx"][:, 0]).all())
    out = {"tokens": N0_MOE_TOKENS, "capacity_factor": N0_MOE_CF,
           "tokens_under_gap": int((~above).sum()),
           "tokens_routed_apart": int((~same).sum()),
           "min_gap": float(gaps.min()),
           "y_rel": l_rel(y.cpu()[same], y_cpu[same]),
           "aux": {"cpu": float(aux_cpu), "card": float(aux)},
           "card_ms": ms, "cpu_s": cpu_s}
    check(bool(same[above].all()),
          f"N0 moe_ffn: routing differs above the gap {N_GAP}: {out}")
    check(out["y_rel"] <= N0_MOE_Y, f"N0 moe_ffn y {out}")
    check(not first_same or abs(float(aux) - float(aux_cpu))
          <= N0_AUX * abs(float(aux_cpu)), f"N0 moe_ffn aux {out}")
    return out


def n_train_cfg(arch_id):
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch_id).cfg, **N_TRAIN_CUT[arch_id])


def n1_train(arch_id, dev) -> dict:
    """``N_STEPS`` steps of the arch's cut at train_4k's length, global
    batch ``N_BATCH`` at accum ``N_ACCUM``, the arch's optimizer (donated)
    and a cosine schedule, from init_params seeded on ``dev``: step-0 loss
    within 0.5 of ln V + 0.01 (uniform routing gives aux about 1),
    seconds a step, tokens a second, peak memory, the share of (token,
    choice) pairs dropped at the arch's capacity factor."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as lm
    from repro_torch.train import (AdamWConfig, adafactor_init, adamw_init,
                                   cosine_schedule, make_train_step)

    arch = get_arch(arch_id)
    cfg = n_train_cfg(arch_id)
    check(cfg.param_count() == N_PARAMS[arch_id],
          f"N1 {arch_id}: {cfg.param_count()} parameters")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model = lm.init_params(cfg, device=dev, seed=0)
    opt = (adamw_init if arch.optimizer == "adamw" else adafactor_init)(model)
    init_s = time.monotonic() - t0
    accum = N_ACCUM[arch_id]
    step = make_train_step(lambda m, b: lm.lm_loss(m, b), AdamWConfig(),
                           accum=accum, optimizer=arch.optimizer,
                           lr_schedule=cosine_schedule(1, N_STEPS), donate=True)
    times, losses, norms = [], [], []
    with NRoutes(model) as tap:
        for i in range(N_STEPS):
            batch = l_batch(400 + i, N_BATCH, N_SEQ, cfg.vocab, dev)
            l_sync(dev)
            t = time.monotonic()
            model, opt, m = step(model, opt, batch)
            l_sync(dev)
            times.append(time.monotonic() - t)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    dropped, pairs = tap.dropped(cfg.capacity_factor)
    want = math.log(cfg.vocab) + 0.01
    check(abs(losses[0] - want) <= 0.5,
          f"N1 {arch_id} step-0 loss {losses[0]}, ln V + 0.01 = {want}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"N1 {arch_id} losses {losses}, grad norms {norms}")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    out = {"params": sum(p.numel() for p in model.parameters()),
           "param_dtype": cfg.param_dtype, "optimizer": arch.optimizer,
           "accum": accum, "tokens_a_step": N_BATCH * N_SEQ, "init_s": init_s,
           "step_s": times, "step_s_median_after_first": steady,
           "tokens_per_s": N_BATCH * N_SEQ / steady, "loss": losses,
           "ln_vocab_plus_aux": want, "grad_norm": norms,
           "dropped_pair_share": dropped / pairs,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def n_mem_available() -> int:
    """The host's available memory, bytes (/proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def n2_resume(dev) -> tuple:
    """llama4's cut, the reference's test_resume_is_bit_exact with L2's
    protocol under torch.use_deterministic_algorithms: batch ``N2_BATCH`` x
    ``N_SEQ`` at accum ``N2_ACCUM``, Adafactor (donated), ``N2_STEPS``
    steps straight (the same step function, outside the loop) against
    half through run_train_loop, a checkpoint and a resume to the end;
    every parameter and Adafactor leaf equal bit for bit.  The two
    checkpoints (27.4 GB each: bf16 stored widened to f32) go to a
    temporary directory in /dev/shm (host memory), removed at the end,
    so the script's disk writes stay small.  -> (the line, the resumed
    model)."""
    import shutil
    import tempfile

    from repro_torch.models.transformer import model as lm
    from repro_torch.train import (AdamWConfig, TrainLoopConfig,
                                   adafactor_init, cosine_schedule,
                                   make_train_step, run_train_loop)
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = n_train_cfg(N_LLAMA4)
    root = pathlib.Path(tempfile.mkdtemp(prefix="phase_n2_", dir="/dev/shm"))
    fs, free = filesystem(root)
    need = 2 * 4 * cfg.param_count()       # two steps kept, bf16 stored as f32
    avail = n_mem_available()
    check(min(free, avail) >= need + 24 * 2**30,
          f"N2 needs {need} B and room to copy a model under {root}, {fs}: "
          f"{free} B free, {avail} B of host memory available")
    torch.cuda.reset_peak_memory_stats()
    base = make_train_step(lambda m, b: lm.lm_loss(m, b), AdamWConfig(),
                           accum=N2_ACCUM, optimizer="adafactor",
                           lr_schedule=cosine_schedule(1, N2_STEPS), donate=True)
    step_s = []

    def step(m, o, b):
        t = time.monotonic()
        out = base(m, o, b)
        l_sync(dev)
        step_s.append(time.monotonic() - t)
        return out

    def fresh():
        m = lm.init_params(cfg, device=dev, seed=0)
        return m, adafactor_init(m)

    def make_batch(i):
        return l_batch(500 + i, N2_BATCH, N_SEQ, cfg.vocab, dev)

    def run(steps, name, every):
        n = len(step_s)
        t = time.monotonic()
        model, opt, _ = run_train_loop(step, *fresh(), make_batch,
                                       TrainLoopConfig(steps, str(root / name),
                                                       ckpt_every=every))
        return ({"params": model, "opt": opt},
                time.monotonic() - t - sum(step_s[n:]), len(step_s) - n)

    half = N2_STEPS // 2
    torch.use_deterministic_algorithms(True)
    try:
        # the straight run steps outside the loop: its checkpoint would
        # only be written and thrown away (27.4 GB, about 30 s)
        model, opt = fresh()
        for i in range(N2_STEPS):
            model, opt, _ = step(model, opt, make_batch(i))
        # on the host: two cuts do not fit the card beside the runs' state
        straight = tree_map(lambda t: t.to("cpu", copy=True),
                            {"params": model.tree(), "opt": opt})
        del model, opt
        n_a = len(step_s)
        _, save_s, _ = run(half, "b", half)
        ckpt = root / "b" / f"step_{half:08d}"
        ckpt_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
        ckpt_files = len(list(ckpt.iterdir()))
        resumed, resume_s, n_b = run(N2_STEPS, "b", half)
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    model = resumed["params"]
    resumed["params"] = model.tree()
    leaves = list(zip(tree_leaves(straight), tree_leaves(resumed)))
    differ = [k for k, (a, b) in enumerate(leaves)
              if not torch.equal(a, b.cpu())]
    check(n_a == N2_STEPS and n_b == N2_STEPS - half,
          f"N2 ran {n_a} and {n_b} steps: the resume did not start at {half}")
    check(not differ, f"N2: {len(differ)} of {len(leaves)} leaves (params, "
          "then Adafactor's) differ after the resume")
    return {"params": cfg.param_count(), "steps": N2_STEPS, "resumed_at": half,
            "leaves": len(leaves), "bit_equal": True,
            "checkpoint_bytes": ckpt_bytes, "checkpoint_files": ckpt_files,
            "save_s": save_s, "restore_and_save_s": resume_s,
            "step_s_median": sorted(step_s)[len(step_s) // 2],
            "filesystem": fs, "host_bytes_available_before": avail,
            "peak_bytes": torch.cuda.max_memory_allocated()}, model


def n_kv_bytes(cfg, batch: int, max_seq: int) -> int:
    """Bytes of an init_cache's k and v (bf16), from the config."""
    return sum(2 * cfg.n_super * batch * cfg.cache_len(kind, max_seq)
               * cfg.n_kv_heads * cfg.d_head * 2 for kind in cfg.sub_kinds())


def n3_prefill(model, dev, tag) -> dict:
    """A ``N_PREFILL``-token prefill at batch 1: seconds, finite logits."""
    from repro_torch.models.transformer import model as lm

    toks = l_batch(600, 1, N_PREFILL, model.cfg.vocab, dev)["tokens"]
    l_sync(dev)
    t = time.monotonic()
    logits, cache = lm.prefill(model, toks, N_PREFILL)
    l_sync(dev)
    out = {"prefill_tokens": N_PREFILL, "prefill_s": time.monotonic() - t}
    check(logits.shape == (1, 1, model.cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()), f"N3 {tag} prefill")
    return out


def n3_decode(model, dev, tag) -> dict:
    """A ``N_DECODE_PROMPT``-token prefill at batch ``N_DECODE_BATCH`` into
    an ``N_DECODE_CACHE``-slot cache (its bytes predicted from the config
    and checked), then ``N_DECODE_STEPS`` greedy steps at the model's
    capacity factor: ms a step, (token, choice) pairs dropped a step."""
    from repro_torch.models.transformer import model as lm

    cfg = model.cfg
    toks = l_batch(602, N_DECODE_BATCH, N_DECODE_PROMPT, cfg.vocab, dev)["tokens"]
    l_sync(dev)
    t = time.monotonic()
    logits, cache = lm.prefill(model, toks, N_DECODE_CACHE)
    l_sync(dev)
    out = {"decode_prefill_s": time.monotonic() - t}
    kv = [c[k] for c in cache.values() for k in ("k", "v")]
    out["cache_bytes"] = sum(x.numel() * x.element_size() for x in kv)
    want = n_kv_bytes(cfg, N_DECODE_BATCH, N_DECODE_CACHE)
    check(out["cache_bytes"] == want,
          f"N3 {tag} cache {out['cache_bytes']} B, want {want}")
    nxt = logits.argmax(-1)
    ms, taps = [], []
    for i in range(N_DECODE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with NRoutes(model) as tap:
            start.record()
            logits, cache = lm.serve_step(model, cache, nxt, N_DECODE_PROMPT + i)
            nxt = logits.argmax(-1)
            end.record()
        ms.append((start, end))
        taps.append(tap)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ms]
    check(bool(torch.isfinite(logits.float()).all()), f"N3 {tag} decode logits")
    med = sorted(ms)[len(ms) // 2]
    out.update(decode_batch=N_DECODE_BATCH, decode_cache_slots=N_DECODE_CACHE,
               decode_ms=ms, decode_ms_median=med,
               decode_tokens_per_s=N_DECODE_BATCH * 1e3 / med,
               dropped_pairs_a_step=[tap.dropped(cfg.capacity_factor)[0]
                                     for tap in taps])
    return out


def n3_mixtral(dev) -> dict:
    """mixtral at ``N_SERVE_LAYERS`` layers in bf16: the prefill; one
    forward at ``N_LONG`` tokens (two moe_token_chunk chunks a layer,
    counted); serve_step against forward at N_CHECK_BATCH x N_CHECK_SEQ at
    capacity factor E / top_k, so nothing drops, on the routing the
    prefill gave each token (relative error < 0.05, the reference's
    bound; the decode's own routing and its error reported beside it: at
    these widths one expert flipped at a near tie moves a logit by tens
    of percent); the decode."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import model as lm

    cfg = dataclasses.replace(get_arch(N_MIXTRAL).cfg, n_layers=N_SERVE_LAYERS,
                              param_dtype="bfloat16", kv_chunk=N_SERVE_KV_CHUNK)
    check(cfg.param_count() == N_SERVE_PARAMS, f"N3 {cfg.param_count()}")
    torch.cuda.reset_peak_memory_stats()
    t = time.monotonic()
    model = lm.init_params(cfg, device=dev, seed=0)
    out = {"params": sum(p.numel() for p in model.parameters()),
           "init_s": time.monotonic() - t}
    out.update(n3_prefill(model, dev, "mixtral"))
    toks = l_batch(601, 1, N_LONG, cfg.vocab, dev)["tokens"]
    with NRoutes(model) as tap, torch.inference_mode():
        l_sync(dev)
        t = time.monotonic()
        logits, _ = model(toks, last_only=True)
        l_sync(dev)
    out["long_forward_s"] = time.monotonic() - t
    chunks = [c["T"] for c in tap.calls]
    check(chunks == [cfg.moe_token_chunk] * (2 * N_SERVE_LAYERS)
          and bool(torch.isfinite(logits.float()).all()),
          f"N3 mixtral {N_LONG}-token forward: MoE calls of {chunks} tokens")
    out["long_forward_moe_calls"] = len(chunks)
    del logits
    was = n_cfg(model, dataclasses.replace(
        cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k,
        moe_token_chunk=N_CHECK_CHUNK))
    try:
        toks = l_batch(603, N_CHECK_BATCH, N_CHECK_SEQ, cfg.vocab, dev)["tokens"]
        with NRoutes(model, keep=True) as tap:
            want, cache = lm.prefill(model, toks, N_CHECK_SEQ)
        # a layer's chunks are the batch's sequences, in order: the last
        # row of each is the token serve_step takes again
        last = {}
        for c in tap.calls:
            last.setdefault(c["layer"], []).append(c["idx"][-1])
        check(all(len(v) == N_CHECK_BATCH for v in last.values()),
              f"N3 mixtral: prefill's MoE calls {[c['T'] for c in tap.calls]}")
        force = {i: torch.stack(v) for i, v in last.items()}
        with NRoutes(model, keep=True) as own:
            got_own, _ = lm.serve_step(model, cache, toks[:, -1:],
                                       N_CHECK_SEQ - 1)
        with NRoutes(model, force=force) as forced:
            got, _ = lm.serve_step(model, cache, toks[:, -1:], N_CHECK_SEQ - 1)
        cf = model.cfg.capacity_factor
        out.update(serve_step_vs_forward_rel=l_rel(got, want),
                   serve_step_unforced_rel=l_rel(got_own, want),
                   serve_step_tokens_routed_apart={
                       str(i): int((own.first()[i] != force[i]).any(-1).sum())
                       for i in force},
                   serve_step_check_dropped=tap.dropped(cf)[0]
                   + forced.dropped(cf)[0] + own.dropped(cf)[0])
        del cache
    finally:
        n_cfg(model, was)
    check(out["serve_step_vs_forward_rel"] < 0.05
          and out["serve_step_check_dropped"] == 0,
          f"N3 mixtral serve_step vs forward {out}")
    out.update(n3_decode(model, dev, "mixtral"))
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def phase_n(smi, dev="cuda") -> tuple:
    """The two MoE LMs on the card (see the module doc); every check
    raises.  -> (the phase line, the six kernels' launches: all 0, the
    MoE path reaches none of them)."""
    import dataclasses
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import launch_counts

    torch.cuda.empty_cache()
    # the cuts' steps hold 60-75 GB in blocks of a few GB: grow segments
    # rather than strand freed blocks (restored at the end)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    reset_launches()
    t_phase = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(29)
    root = pathlib.Path(tempfile.mkdtemp(prefix="phase_n_"))
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    # bf16 products accumulate in f32 end to end, as the reference's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    pool = ThreadPoolExecutor(1)
    line = {"phase": "N", "device": smi}
    try:
        n4 = pool.submit(lambda: {a: l4_launcher(root / f"n4_{a}", a, "N4")
                                  for a in N_ARCHS})
        t = time.monotonic()
        line["N0"] = {a: n0_smoke(a, dev) for a in N_ARCHS}
        line["N0"]["moe_ffn_mixtral_widths"] = n0_moe(dev, gen)
        line["N0"]["s"] = time.monotonic() - t
        progress(f"N0: {line['N0']}")
        line["N1"] = {}
        for a in N_ARCHS:
            line["N1"][a] = n1_train(a, dev)
            progress(f"N1 {a}: {line['N1'][a]}")
        line["N2"], model = n2_resume(dev)
        progress(f"N2: {line['N2']}")
        torch.cuda.reset_peak_memory_stats()
        n_cfg(model, dataclasses.replace(model.cfg, kv_chunk=N_SERVE_KV_CHUNK))
        line["N3"] = {N_LLAMA4: n3_prefill(model, dev, "llama4")}
        line["N3"][N_LLAMA4].update(n3_decode(model, dev, "llama4"))
        line["N3"][N_LLAMA4]["peak_bytes"] = torch.cuda.max_memory_allocated()
        del model
        torch.cuda.empty_cache()
        line["N3"][N_MIXTRAL] = n3_mixtral(dev)
        progress(f"N3: {line['N3']}")
        torch.cuda.empty_cache()
        line["N4"] = n4.result()
    finally:
        pool.shutdown(wait=True)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    launches = launch_counts()
    check(not any(launches.values()),
          f"N: the MoE path launched a search kernel: {launches}")
    line.update(launches=launches, phase_s=time.monotonic() - t_phase,
                cuts={N_MIXTRAL: f"trains {N_TRAIN_CUT[N_MIXTRAL]['n_layers']} "
                                 f"of 56 layers, serves {N_SERVE_LAYERS} in bf16",
                      N_LLAMA4: "one super-block of 12 (4 of 48 layers), 16 "
                                "of 128 experts",
                      "train_4k": f"batch {N_BATCH}, not 256 (accum "
                                  f"{N_ACCUM[N_MIXTRAL]} / {N_ACCUM[N_LLAMA4]})",
                      "prefill_32k": "batch 1 (32)",
                      "decode_32k": f"batch {N_DECODE_BATCH} (128)",
                      "serving kv_chunk": f"{N_SERVE_KV_CHUNK} (1,024; memory "
                                          "only, the same attention)"})
    return line, launches



# ----------------------------------------------------------------- phase O
O_PREFIX = 65_536                  # O1's parity rows, the card against the CPU
O_REPS = 3                         # timed calls of a search cell, after a warm-up
O_TIE_TOL = 2e-5                   # the codes tolerance (rtol = atol = 1e-5) at |s| <= 1
O_INPUT_BYTES = {"search_b128": 8_363_212_800, "search_b1": 8_363_009_600,
                 "encode_4m": 6_690_406_400}
O_MESH_BYTES = {                   # input_bytes_per_device on the pods
    "single_16x16": {"search_b128": 522_892_800, "search_b1": 522_689_600,
                     "encode_4m": 418_150_400},
    "multi_2x16x16": {"search_b128": 261_548_800, "search_b1": 261_345_600,
                      "encode_4m": 209_075_200}}
O_LM_SHAPES = ("prefill_32k", "decode_32k")   # qwen2-0.5b's meta traces in O2
O_BATCH = 2                        # O3: qwen2-0.5b, 2 x 4,096 at accum 1,
O_STEPS = 4                        # resized between steps 2 and 3


def o_census(fn, *args):
    """``fn(*args)`` on the card under the op census -> (out, census)."""
    from repro_torch.launch.op_analysis import analyze

    out, census = analyze(fn, *args)
    torch.cuda.synchronize()
    return out, census


def o_cells(wiki, vecs, codes, queries) -> dict:
    """The three cells' functions and real arguments, as their cells
    hold them."""
    import functools

    search = functools.partial(wiki._search, page=PAGE, k=K, trim=0.05)
    return {"search_b128": (search, (vecs, codes, queries)),
            "search_b1": (search, (vecs, codes, queries[:1])),
            "encode_4m": (wiki._encode, (vecs,))}


def o1_parity(wiki, vecs, queries, ocheck) -> dict:
    """Each cell's fn on the first O_PREFIX rows, on the card and on the
    CPU: codes (the kernel against its plain version) under the bucketize
    contract, the search cells' pages equal, their ids equal but in runs
    of near-tied scores, and their scores within the codes tolerance."""
    from repro_torch.core.rerank import rerank_topk

    pre = vecs[:O_PREFIX]
    codes = wiki._encode(pre)                       # the kernel
    want = wiki._encode(pre.cpu())                  # its plain version
    diff = (codes.cpu().long() - want.long()).abs()
    share, worst = float((diff == 0).float().mean()), int(diff.max())
    ocheck(share >= 0.9999 and worst <= 1,
           f"O1 encode prefix: {share} of codes equal, worst {worst}")
    out = {"rows": O_PREFIX, "encode": {
        "codes_equal_share": share, "codes_differing": int((diff != 0).sum()),
        "max_abs_err": worst}}
    pre_cpu, codes_cpu = pre.cpu(), codes.cpu()
    for name, Q in (("search_b128", N_QUERIES), ("search_b1", 1)):
        qs = queries[:Q]
        ids, scores = wiki._search(pre, codes, qs, PAGE, K, 0.05)
        _, cand = wiki._page(codes, qs, PAGE, 0.05)
        q_cpu, cand_cpu = wiki._page(codes_cpu, qs.cpu(), PAGE, 0.05)
        page_equal = torch.equal(cand.cpu(), cand_cpu)
        ocheck(page_equal, f"O1 {name}: the card's page differs from the CPU's")
        want_ids, want_s = rerank_topk(pre_cpu, cand_cpu, q_cpu, K + 1)
        ok, tied = m_same_up_to_near_ties(ids.cpu(), scores.cpu(), want_ids,
                                          want_s, O_TIE_TOL)
        ocheck(ok, f"O1 {name}: ids or scores differ from the CPU's")
        err = float((scores.cpu() - want_s[:, :K]).abs().max())
        out[name] = {"page_equal": page_equal, "ids_equal_but_near_ties": ok,
                     "ranks_in_near_ties": tied, "max_abs_err": err,
                     "ids_equal": torch.equal(ids.cpu(), want_ids[:, :K])}
    return out


def o1_full(wiki, vecs, src, queries, ocheck) -> tuple:
    """The three cells at full size: the main path once (launches counted),
    then each cell under the op census (its warm-up), timed, its peak
    memory.  -> (the O1 line's cells, codes, launches, census by cell,
    real argument bytes by cell)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.bucketize import kernel as bk_kernel
    from repro_torch.kernels.bucketize import ref as bk_ref
    from repro_torch.obs import cost

    reset_launches()
    codes = wiki._encode(vecs)                                  # encode_4m
    ids128, _ = wiki._search(vecs, codes, queries, PAGE, K, 0.05)
    ids1, _ = wiki._search(vecs, codes, queries[:1], PAGE, K, 0.05)
    torch.cuda.synchronize()
    launches = launch_counts()
    ocheck(launches == {**dict.fromkeys(launches, 0),
                        "bucketize": bk_kernel.KERNELS_PER_CALL},
           f"O1: the cells launched {launches}, want one bucketize")
    hits = (ids128[:, 0].cpu() == src).float().mean().item()
    ocheck(hits == 1.0 and int(ids1[0, 0]) == int(src[0]),
           f"O1: source row at rank 1 for {hits} of the queries")
    cells, census, nbytes = {}, {}, {}
    for name, (fn, args) in o_cells(wiki, vecs, codes, queries).items():
        nbytes[name] = sum(t.numel() * t.element_size() for t in args)
        ocheck(nbytes[name] == O_INPUT_BYTES[name],
               f"O1 {name}: arguments hold {nbytes[name]} B")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, census[name] = o_census(fn, *args)
        peak = torch.cuda.max_memory_allocated()
        ms = [m_ms(lambda: fn(*args), "cuda") for _ in range(O_REPS)]
        cells[name] = {"ms_median": m_median(ms), "ms": ms,
                       "peak_bytes": peak, "peak_over_args_bytes": peak - base,
                       "argument_bytes": nbytes[name],
                       "flops": census[name]["flops"],
                       "dot_flops": census[name]["dot_flops"]}
    scale, dt = float(wiki.ENCODER.scale), wiki.ENCODER.code_dtype
    bk_ms = cuda_ms(lambda: bk_kernel.bucketize_cuda(vecs, "round", scale,
                                                     dt), O_REPS)

    def bk_plain():
        for lo in range(0, vecs.shape[0], 1 << 18):
            bk_ref.bucketize_ref(vecs[lo:lo + (1 << 18)], "round", scale, dt)

    bound, by = cost.bound_ms(cost.bucketize_work(vecs.shape[0],
                                                  vecs.shape[1], 1))
    cells["encode_4m"]["kernel"] = {
        "B": vecs.shape[0], "n": vecs.shape[1],
        "launches": launches["bucketize"], "ms": bk_ms,
        "plain_ms": cuda_ms(bk_plain, 1), "bound_ms": bound, "bound_by": by,
        "library_ms": None}
    cells["rank1_share"] = hits
    return cells, codes, launches, census, nbytes


def o2_dryrun(census, nbytes, ocheck) -> dict:
    """``launch/dryrun.run_cell`` for the three cells on a (1, 1) mesh on
    the card (meta traces), held to O1's real bytes and card census; the
    records on the production meshes from the same traces; qwen2-0.5b's
    serving cells traced beside them."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    out = str(pathlib.Path(__file__).resolve().parent / "build" / "dryrun_O")
    local = make_local_mesh(1, 1)
    arch = get_arch("vectordb-wiki")
    line = {}
    for shape in type(arch).SHAPES:
        meta = {}
        rec = dryrun.run_cell(arch.cell(shape, local), local, "local_1x1",
                              out, force=True, census=meta)
        got = {"input_bytes_per_device": rec["input_bytes_per_device"],
               "flops": rec["flops_per_device"],
               "dot_flops": rec["dot_flops_per_device"],
               "trace_s": rec["trace_s"]}
        ocheck(got["input_bytes_per_device"] == nbytes[shape],
               f"O2 {shape}: {got['input_bytes_per_device']} B on (1, 1), "
               f"the card's arguments {nbytes[shape]} B")
        ocheck((got["flops"], got["dot_flops"]) == (
            census[shape]["flops"], census[shape]["dot_flops"]),
            f"O2 {shape}: meta census {got} against the card's "
            f"{census[shape]}")
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            name = "multi_2x16x16" if multi else "single_16x16"
            prod = dryrun.run_cell(arch.cell(shape, mesh), mesh, name, out,
                                   force=True, census=meta)
            got[name] = prod["input_bytes_per_device"]
            ocheck(got[name] == O_MESH_BYTES[name][shape],
                   f"O2 {shape} on {name}: {got[name]} B a device")
        line[shape] = got
    qwen = get_arch(L_ARCH)
    for shape in O_LM_SHAPES:
        rec = dryrun.run_cell(qwen.cell(shape, local), local, "local_1x1",
                              out, force=True)
        line[f"{L_ARCH} {shape}"] = {
            k: rec[k] for k in ("flops_per_device", "dot_flops_per_device",
                                "bytes_per_device", "input_bytes_per_device",
                                "trace_s")}
    return line


def o3_elastic(ocheck) -> dict:
    """qwen2-0.5b at its published widths, AdamW, batch O_BATCH x L_SEQ at
    accum 1: O_STEPS steps straight, against half of them, the parameters
    and AdamW state moved to a (1, 1) mesh on the CPU and back through
    ``train/elastic.resize_data_axis`` (the card's copies freed between),
    and the rest; under ``torch.use_deterministic_algorithms`` the losses,
    parameters and moments bit-equal."""
    from repro_torch.configs import get_arch
    from repro_torch.dist import lm_param_spec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import model as lm
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.elastic import resize_data_axis
    from repro_torch.train.tree import tree_leaves

    cfg = get_arch(L_ARCH).cfg
    step = make_train_step(lm.lm_loss, AdamWConfig())
    batches = [l_batch(300 + i, O_BATCH, L_SEQ, cfg.vocab, "cuda")
               for i in range(O_STEPS)]
    card, host = make_local_mesh(1, 1), make_local_mesh(1, 1, device="cpu")
    moved = {}

    def rule(mesh):
        return lambda path, leaf: lm_param_spec(path, leaf, mesh)

    def resize(model, state):
        t = time.monotonic()
        tree = resize_data_axis(model.tree(), card, host, rule(host))
        state = resize_data_axis(state, card, host, rule(host))
        del model
        torch.cuda.synchronize()
        moved["to_host_s"] = time.monotonic() - t
        leaves = tree_leaves((tree, state))
        moved["leaves"] = len(leaves)
        moved["bytes"] = sum(x.numel() * x.element_size() for x in leaves)
        ocheck(all(x.device.type == "cpu" for x in leaves),
               "O3: a leaf stayed on the card")
        moved["card_bytes_while_on_host"] = torch.cuda.memory_allocated()
        t = time.monotonic()
        tree = resize_data_axis(tree, host, card, rule(card))
        state = resize_data_axis(state, host, card, rule(card))
        model = lm.LM(cfg, None, device="cuda").load_tree(tree)
        torch.cuda.synchronize()
        moved["to_card_s"] = time.monotonic() - t
        return model, state

    def run(elastic):
        model = lm.init_params(cfg, device="cuda", seed=0)
        state, losses, step_s = adamw_init(model), [], []
        for i, b in enumerate(batches):
            if elastic and i == O_STEPS // 2:
                model, state = resize(model, state)
            t = time.monotonic()
            model, state, metrics = step(model, state, b)
            torch.cuda.synchronize()
            step_s.append(time.monotonic() - t)
            losses.append(metrics["loss"])
        return losses, (model.tree(), state), step_s

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True)
    try:
        l_a, s_a, step_s = run(False)
        l_b, s_b, _ = run(True)
    finally:
        torch.use_deterministic_algorithms(False)
    pairs = list(zip(tree_leaves(s_a), tree_leaves(s_b)))
    differ = [k for k, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
    same_loss = all(torch.equal(a, b) for a, b in zip(l_a, l_b))
    ocheck(same_loss and not differ,
           f"O3: losses equal {same_loss}, {len(differ)} of {len(pairs)} "
           "leaves differ after the resize")
    return {"steps": O_STEPS, "resized_after": O_STEPS // 2,
            "batch": [O_BATCH, L_SEQ], "losses": [float(x) for x in l_a],
            "bit_equal": same_loss and not differ, "leaves": len(pairs),
            "step_s_median": m_median(step_s), **moved,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def phase_o(smi) -> tuple:
    """The dry-run slice on the card (see the module doc); checks are
    gathered and raised at the phase's end.  -> (the phase line, the five
    kernels' launches on its main path: one bucketize)."""
    from repro_torch.configs import vectordb_wiki as wiki
    from repro_torch.core.rerank import normalize

    torch.cuda.empty_cache()
    ocheck = MChecks("O")
    t_phase = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(30)
    t = time.monotonic()
    vecs = normalize(torch.randn((wiki.N_DOCS, wiki.N_FEATURES),
                                 generator=gen, device="cuda"))
    src = torch.randint(0, O_PREFIX, (N_QUERIES,), generator=gen,
                        device="cuda")
    queries = vecs[src] + torch.randn((N_QUERIES, N_FEATURES), generator=gen,
                                      device="cuda") * NOISE
    torch.cuda.synchronize()
    line = {"phase": "O", "device": smi, "rows_s": time.monotonic() - t}
    t = time.monotonic()
    line["O1"] = {"parity": o1_parity(wiki, vecs, queries, ocheck)}
    line["O1"]["parity"]["s"] = time.monotonic() - t
    progress(f"O1 parity: {line['O1']['parity']}")
    t = time.monotonic()
    cells, codes, launches, census, nbytes = o1_full(wiki, vecs, src.cpu(),
                                                     queries, ocheck)
    line["O1"].update(cells, s=time.monotonic() - t)
    progress(f"O1: {cells}")
    del vecs, codes, queries
    torch.cuda.empty_cache()
    t = time.monotonic()
    line["O2"] = o2_dryrun(census, nbytes, ocheck)
    line["O2"]["s"] = time.monotonic() - t
    progress(f"O2: {line['O2']}")
    t = time.monotonic()
    line["O3"] = o3_elastic(ocheck)
    line["O3"]["s"] = time.monotonic() - t
    progress(f"O3: {line['O3']}")
    torch.cuda.empty_cache()
    line.update(launches=launches, phase_s=time.monotonic() - t_phase)
    ocheck.raise_any()
    return line, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="ABCDEFGHIJKLMNO",
                    help="letters of the phases to run, each described in "
                         "the module doc: A kernels against their plain "
                         "versions, B encoders, C-D engines, E quality, F "
                         "segments, G observability, H durability, I shards "
                         "and replicas, J cluster (with C and I), K the "
                         "serving launcher, L the dense LM trained, resumed "
                         "bit-exactly, prefilled and decoded at qwen2-0.5b's "
                         "widths, M the recsys models and GIN trained and "
                         "served at their published widths, with the "
                         "paper's retrieval over 1,000,000 candidates, N "
                         "the MoE LMs mixtral-8x22b and llama4-maverick "
                         "trained, resumed, prefilled and decoded at their "
                         "published widths, O the dry run: vectordb-wiki's "
                         "three cells at full width, their meta traces "
                         "against the card, and an elastic continue")
    args = ap.parse_args(argv)
    if "J" in args.phases and not {"C", "I"} <= set(args.phases):
        ap.error("phase J serves phase C's index and holds its answers to "
                 "phase I's: run it as --phases CIJ")

    src = pathlib.Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.bucketize import kernel as bk_kernel
    from repro_torch.kernels.code_match import kernel as cm_kernel
    from repro_torch.kernels.fused_phase1 import kernel as fp_kernel
    from repro_torch.kernels.page_select import kernel as ps_kernel
    from repro_torch.kernels.postings_walk import kernel as pw_kernel
    from repro_torch.kernels.rerank_topk import kernel as rk_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t = time.monotonic()
    builds = {"fused_phase1": fp_kernel.library,
              "fused_phase1_quant": fp_kernel.quant_library,
              "code_match": cm_kernel.library,
              "bucketize": bk_kernel.library,
              "rerank_topk": rk_kernel.library,
              "postings_walk": pw_kernel.library,
              "page_select": ps_kernel.library}
    with ThreadPoolExecutor(len(builds)) as pool:   # one nvcc each, at once
        for f in [pool.submit(fn) for fn in builds.values()]:
            f.result()
    build_s = time.monotonic() - t
    ptxas = {}
    frames = {}
    spills = {}
    regs = {}
    for name in builds:
        log = _build.build_dir() / f"{name}.log"
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln for ln in lines
                       if "registers" in ln or "spill" in ln]
        frames[name] = stack_frames(lines)
        spills[name] = spill_bytes(lines)
        regs[name] = registers(lines)
    rk_bodies = {}                      # both rerank bodies, by body
    for body, kernel in (("bulk", "rerank_bulk_kernel"),
                         ("simple", "rerank_scores_kernel")):
        fn = next((f for f in regs["rerank_topk"] if kernel in f), None)
        rk_bodies[body] = {"registers": regs["rerank_topk"].get(fn),
                           "spill_bytes": spills["rerank_topk"].get(fn)}
    check(rk_bodies["bulk"]["spill_bytes"] == 0,
          f"rerank_topk bulk body spills: {rk_bodies['bulk']}")
    emit({"device": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "ptxas": ptxas,
          "stack_frames": frames, "spill_bytes": spills})
    for name, kernel, count in (("fused_phase1", "score_fold_kernel", 3),
                                ("code_match", "code_match_kernel", 3),
                                ("fused_phase1_quant", "score_fold_kernel",
                                 1)):
        scorers = {fn: (b, spills[name].get(fn))
                   for fn, b in frames[name].items() if kernel in fn}
        check(len(scorers) == count
              and all(v == (0, 0) for v in scorers.values()),
              f"{name}: scorer kernels' (stack frame, spill) bytes "
              f"{scorers}, want 0")

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = c = d_summary = None
    a_err = {}
    kd = {}
    by_phase = {}
    if "A" in args.phases:
        a = phase_a(gen)
        emit(a)
        for line in (phase_a_code_match(gen), phase_a_quant(gen),
                     phase_a_rerank(gen), phase_a_bucketize(gen)):
            emit(line)
            a_err[line["kernel"]] = line["max_abs_err"]
        walk_line, walk_scores = phase_a_postings_walk(gen)
        for line in (walk_line, phase_a_page_select(walk_scores)):
            emit(line)
            a_err[line["kernel"]] = line["max_abs_err"]
        del walk_scores
    if "B" in args.phases:
        emit(phase_b())
    if "C" in args.phases:
        c, index, queries, src, raw_state = phase_c(gen)
        emit(c)
        by_phase["C"] = {"fused_phase1": c["launches"]}
        if "D" in args.phases:
            summary, kd = phase_d(gen, index, queries, src, raw_state)
            emit(summary)
            d_summary = summary
            by_phase["D"] = {name: k["launches"] for name, k in kd.items()}
        if "G" in args.phases:
            line, by_phase["G"] = phase_g(index, queries, src)
            emit(line)
        f_add_s = None
        if "F" in args.phases:
            line, by_phase["F"] = phase_f(index)
            emit(line)
            f_add_s = line["add_s_median"]
            for name, err in line["kernels_max_abs_err"].items():
                a_err[name] = max(a_err.get(name, 0.0), err)
        if "H" in args.phases:
            line, by_phase["H"] = phase_h(index, f_add_s)
            emit(line)
        if "I" in args.phases:
            one_shard = {"fused": c["batch_latency_s_median"]}
            if d_summary is not None:
                one_shard.update(d_summary["batch_latency_s_median"])
            line, by_phase["I"], i_answers = phase_i(index, queries, src,
                                                     smi, one_shard)
            emit(line)
            for name, err in line["kernels_max_abs_err"].items():
                a_err[name] = max(a_err.get(name, 0.0), err)
            if "J" in args.phases:
                # no phase after J reads C's flat posting tables (8.36 GB)
                index.postings = None
                torch.cuda.empty_cache()
                line, by_phase["J"] = phase_j(
                    index, queries, src, smi, i_answers,
                    line["batch_latency_s_median"])
                emit(line)
                for name, err in line["kernels_max_abs_err"].items():
                    a_err[name] = max(a_err.get(name, 0.0), err)
        del index
        torch.cuda.empty_cache()
    if "E" in args.phases:
        line, by_phase["E"] = phase_e()
        emit(line)
        for name in ("bucketize", "rerank_topk"):
            a_err[name] = max(a_err.get(name, 0.0),
                              line[name]["max_abs_err"])
    if "K" in args.phases:
        line, by_phase["K"] = phase_k(smi)
        emit(line)
        for name, err in line["kernels_max_abs_err"].items():
            a_err[name] = max(a_err.get(name, 0.0), err)
    if "L" in args.phases:
        line, by_phase["L"] = phase_l(smi)
        emit(line)
    m_side = None
    if "M" in args.phases:
        line, by_phase["M"] = phase_m(smi)
        emit(line)
        m_side = line["side_check_launches"]["code_match"]
        a_err["code_match"] = max(
            a_err.get("code_match", 0.0),
            *(r["code_match_side_check"]["max_abs_err"]
              for r in line["M3"].values()))
    if "N" in args.phases:
        line, by_phase["N"] = phase_n(smi)
        emit(line)
    if "O" in args.phases:
        line, by_phase["O"] = phase_o(smi)
        emit(line)
        a_err["bucketize"] = max(a_err.get("bucketize", 0.0),
                                 line["O1"]["parity"]["encode"]["max_abs_err"])
        # the encode_4m cell's kernel numbers stand in where phase D did
        # not run
        kd.setdefault("bucketize", line["O1"]["encode_4m"]["kernel"])
    ck = c["kernel"] if c else (a["first_shape"] if a else {})
    entries = [{
        "name": "fused_phase1", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_phase1/csrc/fused_phase1.cu",
        "replaces": "src/repro/kernels/fused_phase1/kernel.py:133",
        "launches": sum(p.get("fused_phase1", 0) for p in by_phase.values()),
        "launches_by_phase": {ph: p.get("fused_phase1", 0)
                              for ph, p in by_phase.items()},
        "max_abs_err": max(a["max_abs_err"] if a else 0.0,
                           ck.get("max_abs_err", 0.0),
                           a_err.get("fused_phase1", 0.0)),
        "ms": ck.get("ms", ck.get("kernel_ms")),
        "plain_ms": ck.get("plain_ms"), "bound_ms": ck.get("bound_ms"),
        "bound_by": ck.get("bound_by"), "library_ms": None}]
    entries[0]["stack_frame_bytes"] = max(frames["fused_phase1"].values(),
                                          default=None)
    for name, source, replaces in (
            ("code_match",
             "src/repro_torch/kernels/code_match/csrc/code_match.cu",
             "src/repro/kernels/code_match/kernel.py:49"),
            ("fused_phase1_quant",
             "src/repro_torch/kernels/fused_phase1/csrc/"
             "fused_phase1_quant.cu",
             "src/repro/kernels/fused_phase1/kernel.py:154"),
            ("rerank_topk",
             "src/repro_torch/kernels/rerank_topk/csrc/rerank_topk.cu",
             "src/repro/kernels/rerank_topk/kernel.py:31"),
            ("bucketize",
             "src/repro_torch/kernels/bucketize/csrc/bucketize.cu",
             "src/repro/kernels/bucketize/kernel.py:38")):
        k = kd.get(name, {})
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p.get(name, 0) for p in by_phase.values()),
            "launches_by_phase": {ph: p.get(name, 0)
                                  for ph, p in by_phase.items()},
            "max_abs_err": max(a_err.get(name, 0.0),
                               k.get("max_abs_err", 0.0)),
            "ms": k.get("ms"), "plain_ms": k.get("plain_ms"),
            "bound_ms": k.get("bound_ms"), "bound_by": k.get("bound_by"),
            "library_ms": k.get("library_ms"),
            "stack_frame_bytes": max(frames[name].values(), default=None)})
        if name == "code_match" and m_side is not None:
            # phase M's side checks, counted by the wrapper apart from
            # the path's
            entries[-1]["side_check_launches"] = {"M": m_side}
        if name == "rerank_topk":
            entries[-1]["bodies"] = rk_bodies
            entries[-1]["launches_by_body"] = k.get("launches_by_body")
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
