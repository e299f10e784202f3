#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; exits non-zero, printing no result, without them.
Four phases, each of which fails the run:

1. build — compile the port's eight CUDA sources (``fused_groupby``,
   ``ticket_hash``, ``segment_agg``, ``hybrid_registers``, ``preagg``,
   ``grouped_matmul`` (B3 and its backward B6), ``segment_rows``,
   ``table_ops``), one ``nvcc`` each, all started together, and print
   the commands, the seconds and ``-Xptxas -v``.
2. kernel vs plain — each kernel and its plain version on the same CUDA
   tensors.  ``fused_consume`` (its grid printed: CTAs, CTAs per
   program): 2^20 rows of uniform, zipf and heavy-hitter keys at P = 1
   and 4 under an exact bound; a forced pause under a GROW bound (the
   committed morsels' rows counted once, no ticket past the bound) and the
   replay of each version's todo morsels after ``grow_fused_state``; an
   unchecked, saturated table (1024 slots, 4096 distinct keys), which
   must end.
   ``ticket_hash``: 2^20 rows of uniform, zipf and heavy-hitter keys, a
   bound below the distinct count (count > G, key_by_ticket truncated), a
   full 1024-slot table (-1 rows, count = 1024), 2^20 unique keys against
   2^24 slots (the kernel's region mode) and 3·1024 rows (a ragged tile),
   each held by ``ticket_map_discrepancies``.  ``segment_agg``: every
   kind × scatter / onehot over 2^20 rows with tickets of -1 and >= G, and
   every kind (scatter) on a hot key (55% of 2^20 rows, G = 2^14, values
   with -0.0 and, for min/max, ±inf).  ``scan_ticket``
   (``scan_ticket_kernel`` of ``csrc/fused_groupby.cu``, the scan route's
   ticket stage: the fused kernel's morsel dispatch, then tiles through a
   per-CTA key cache with one count atomic per tile): 2^20 rows of
   uniform, zipf and heavy-hitter keys in 4096-row morsels, held by
   ``scan_ticket_discrepancies``; a forced GROW pause (the committed
   morsels whole, no ticket past the bound) and its replay after growing
   the bound; an unchecked, saturated table, which must end.  The
   serialized update's kernel (one thread folds every row) against its
   row loop bit for bit, every kind: G = 3000, G at the shared-memory
   plane's cap and just past it, the unique class's G = 2^24, a ragged
   row count and columns 4 bytes off a 16-byte boundary, with tickets
   repeated one and two rows apart, -1 and >= G, and -0.0 and ±inf.
   ``hybrid_registers`` (the hybrid route's register fold): 2^20 rows of
   the low, high, unique, heavy-hitter and heavy-unique classes (keys
   spread over all 32 bits, EMPTY rows) in each size path of the kernel
   (R = 8 at S = 4 and 8: per-thread copies, keys compared in registers;
   R = 16 and 64 at S = 4 and R = 8 at S = 16: per-warp copies), the planes
   cycling over every kind: tail keys equal, COUNT / MIN / MAX exact, SUM
   within 1e-4·Σ|v|.  ``preagg`` (the partitioned route's pre-aggregation): 2^20
   rows of the uniform-1000, zipf, unique and heavy-hitter classes (keys
   over all 32 bits, EMPTY rows), W = 8 and 132 workers, C = 1024 and 64,
   morsel None and 1024, every kind: table keys, spill mask and cnts
   equal, COUNT / MIN / MAX exact, SUM within 1e-4·Σ|v|; the spilled share
   printed (unique at W = 8, C = 1024 spills at least 99%).
   ``scan_ticket_batched`` (the serving layer's round for N lanes in one
   launch, ``scan_ticket_batched_kernel`` of ``csrc/fused_groupby.cu``):
   one launch over 8 lanes of 2^18 rows (3 uniform over 1000 keys, 3 zipf
   over 2^15, 2 unique), each against its own table, one of them migrated
   to 2C; then a RAISE round in which one lane alone overflows its G;
   every lane held by ``scan_ticket_discrepancies``, its info row and its
   overflow flag.  Both rounds again in fold mode (count, sum, min and max
   of each lane's values folded in the launch, the scatter round): each
   lane of both versions held to the oracle (gap-free tickets, COUNT /
   MIN / MAX exact, SUM within 1e-4·Σ|v|), and the two to each other.
   ``grouped_matmul`` (kernel B3, the MoE layer's expert FFNs) against
   its plain version (float32 ``torch.matmul`` per group, TF32 off) at
   granite-moe-1b-a400m's decode shapes (64 rows over 32 experts, K × N =
   1024 × 512 and 512 × 1024), a 4096-row prefill shape, 8 empty groups
   with 37 rows past the last, N = 70 (the plain-load paths), one group of
   300 rows (row tiles of 128, 128 and 44), 4096 rows in Zipf-skewed
   groups (one of about half the rows), K = 1000 and N = 200 (partial K
   blocks and N tiles), M = 1, all groups empty with rows past them, and
   lhs and rhs 4 bytes off a 16-byte boundary: |Δ| <= 1e-5 · max|plain|,
   rows past the groups exactly 0; the segment kernel's COUNT histogram of
   a decode routing equal to the one-hot sum.  At qwen2-moe-a2.7b's shapes
   (60 experts top-4 in 64 groups, the last 4 empty: 32 decode rows and
   1536 prefill rows, K 2048 → N 1408 and K 1408 → N 2048) B3 the same
   way and through its launcher into a NaN-filled output, and the
   histogram of both routings against the one-hot sum and the plain
   version.
   ``segment_rows`` (kernel B5, the ticketed embedding's row segment sum)
   against its plain version (one ``index_add_``): 1024 rows of d = 1024
   at the tickets the ticket kernel gives 1024 Zipf token ids, R = G =
   16384 (several ticket ranges), 3000 rows with tickets of -1 and >= G
   and a hot ticket on half of them, every row on one ticket, every
   ticket dropped, d = 70 (the scalar path) and rows 4 bytes off a
   16-byte boundary: each sum within 1e-5 · Σ|row| of its ticket; and
   the launcher into an output filled with NaN: every element written,
   every ticket with no row exactly 0.
   ``grouped_matmul_backward`` (kernel B6, B3's backward: d_lhs and d_rhs
   on ``wgmma`` in 3xTF32) against its plain version (float32
   ``torch.matmul`` per group) on B3's eleven cases with a random
   cotangent, at granite's training shapes (8192 rows, gate / up and
   down), with a Zipf hot expert (half the 8192 rows on one group), and
   at K 1000, N 520 (off every tile) with rows past the groups: each
   product within 1e-5 · its max|plain|, d_lhs rows past the groups and
   d_rhs of empty groups exactly 0, two launches a call, and the
   launchers into outputs filled with NaN equal to the wrapper's (every
   element written); then
   ``grouped_matmul`` on CUDA inputs that require grad: its backward
   launches B6 twice and holds to the plain gradients.
   The table ops (``kernels/table_ops.py``: GET_OR_INSERT into a carried
   table through ``scan_ticket_kernel`` unchecked, ``lookup`` and
   ``migrate`` of ``csrc/table_ops.cu``), each wrapper called under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside; a
   host read under that mode must raise first) against its plain version (``core.ticketing`` / ``core.resize``): a
   2^21-row chunk of the low, high and unique classes (3% EMPTY rows) into
   the class stream's table holding the chunk's first half; low at G =
   512 (tickets past G); a full 1024-slot table (absent keys end after C
   probes) and a saturated one (4096 distinct keys into 1024 slots, -1
   rows): ``get_or_insert`` and ``migrate`` (into 2C) with 0
   ``table_map_discrepancies`` and equal counts and flags, ``lookup`` of
   the chunk with absent and EMPTY keys equal, and GET_OR_INSERT on the
   migrated table finding every key it holds.
3. main path — ``GroupByPlan(...).stream(...)`` over N = 2^24 rows in 8
   chunks with aggs count(*), sum(v), mean(v), max(v), each stream held
   against a sort-based oracle (``torch.unique`` + float64 ``index_add_``
   + ``scatter_reduce_``).  The fused route (``kernel="fused"``): the
   paper's §4.1 classes (low, high, unique), a grow stream and a
   132-program stream; a RAISE stream must not pause (one launch per
   chunk), and the grow stream may not grow more often than the one-CTA
   rule did (3 bound grows, 3 migrations).  The split route
   (``kernel="split"``): the same three classes, a grow stream and low
   with ``update="onehot"``, with the host-side merge timed apart from the
   kernels.  The scan route (``kernel="off"``: ``scan_ticket`` + the
   update strategies of ``core/updates.py``; ``kernel="scan_body"``:
   ``scan_ticket`` + the segment kernel): low, high, unique and a grow
   stream off; low, high and unique scan_body (a RAISE stream makes one
   ticket launch per chunk and, scan_body, one segment launch per plane
   and chunk); ``update="onehot"`` on low, ``"sort_segment"`` on high, an
   unchecked stream on low; hybrid_high (``strategy="hybrid"`` on the
   high class, bound N / 10, RAISE, a scan_body tail: one register launch
   per chunk); and on 2^16 rows only, ``pipeline="host"``
   (scan_body) and ``update="serialized"``.  The default plan
   (``GroupByPlan(keys, aggs)``: strategy auto, max_groups None,
   saturation GROW, hashed keys) on low (twice: auto_low_again shows the
   first pass's share), high and unique, each resolved route printed
   beside the class's body_* wall, with the time of the resolver's
   per-chunk sampling and of the operator's host-side grows; the heavy-unique class
   (a third of the rows on one key, the rest distinct) under auto (it
   must end as hybrid), ``strategy="hybrid"`` and scan_body; auto_escalate
   (two chunks uniform over 2^22 keys, then half the rows on one key: a
   scan executor after two chunks, an escalated hybrid at the end); and
   direct ticketing over a declared domain of 1000 keys (direct_low), then
   with a last chunk over 2000 keys (direct_low_grow, the domain grows).
   The partitioned route (``strategy="partitioned"``, one aggregate, the
   preagg kernel once per chunk and once per rerun): part_low (count(*)),
   part_low_sum, part_high and part_unique (sum(v), RAISE) and
   part_high_grow (uniform over N / 10 keys from a bound of 2^16, GROW),
   each with its pre-aggregation + exchange + partition-wise sort timed
   apart from the host merge.  Sort ticketing (scan_body updates, every
   chunk buffered): sort_low, sort_high, sort_unique.  Spill
   (``saturation="spill"``, scan_body): spill_low (budget 2048 over 1000
   keys: nothing spills and the map equals scan_low's), spill_high (4096),
   spill_unique (2^20 over 2^24 keys) and spill_auto_high (strategy
   auto, 128 partitions), each with ``stats()["spill"]``, peak device table bytes at most
   twice the residency, a hot table that never migrates, and the host
   seconds of routing and of finalize.
   The serving layer (``serve.AggregationServer``): serve_small
   (bench_serve's shape: 8 queries of 16 chunks × 128 rows) and serve_low
   (16 queries of 2^20 rows in chunks of 2^16, uniform over 1000 keys,
   RAISE), each batched (every round ⌈N / 32⌉ folding launches and no
   ``update_planes`` call), solo and as N sequential ``plan.collect``, every
   query held to the oracle and the batched results to the sequential
   ones; the batched rounds must launch ``scan_ticket_batched`` and fewer
   ``scan_ticket``; serve_budget: a tenant budget of 64 groups fails only
   its own query.
   Every stream sets the launch counts to 0 just before it and reads them
   just after, and must launch exactly the kernels of its route, and of the
   table ops (``table_ops_of``) only those its executor reaches: each
   merge of the split, partitioned and P > 1 fused routes, each migration,
   a hybrid's adoption and finalize and a spill's routing must launch its
   kernel (``hold_table_ops``); every record prints the three table ops'
   launches, ``grow_s`` (host seconds of the grows, synchronized) and,
   where the route merges, ``merge_s``.
   Phase 3 checkpoints (``engine/elastic.py``): 2^24 rows in 8 chunks,
   integer-valued values, count(*), sum(v), min(v), max(v); body_low,
   body_unique, scan_high_grow (restored after bound grows), auto_low,
   auto_escalate (saved on the scan route, hybrid by escalation after the
   restore), hybrid_high, direct_low, sort_low, split_low, part_low and
   spill_high each pumped 4 chunks, saved, finished, and restored into a
   fresh executor and finished: the uninterrupted, saved and restored
   results held to the oracle (COUNT / MIN / MAX exact, SUM exact below
   2^24 and within 1e-4·Σ|v| past it), the restored route equal to the
   saved one, and every kernel of it, and no other, launched after the
   restore; the commit's bytes, the save (device → host copy, npz write),
   the restore (read + import, fast-forward), the finish and the whole
   stream's collect printed in seconds.  Commits across devices at 2^20
   rows (a card commit restored on the CPU, a CPU commit on the card, a
   scan_body and a default plan), and serve_low's 16 queries, solo, each
   checkpointed every 4 chunks and failing once at chunk 9: every query
   restored once and held to the oracle.
   Phase 3 sharded (``core/distributed.py``, ``_ShardedExecutor``): the
   card as an 8-member mesh (``virtual_devices(8, "cuda")``), 8 chunks,
   integer-valued values, sum(v), count(*) and mean(v): low, high and
   unique at 2^24 rows under RAISE with the dense_psum and all_to_all
   merges; GROW from max_groups=64 on low and high; at 2^22 rows, a
   re-mesh after 2 of 8 members fail, a commit saved on 8 members and
   restored on 4, and the server with a sharded tenant beside a flat one
   while a member fails.  Every map held to the oracle; every stream
   launches ``scan_ticket`` per member and chunk, the segment kernel per
   member, chunk and plane, the ticket kernel in each dense_psum merge,
   and never the fused kernel; the wall, merge, re-mesh and save / restore
   seconds and the commit bytes printed with the card's name and power
   limit.
   Phase 3 lm (``serve/engine.py`` over ``models/``): granite-moe-1b-a400m
   at full width (24 layers, 1.33 B float32 parameters from a seeded card
   generator, bfloat16 compute) served by ``ServeLoop(slots=8,
   max_len=128)`` on a one-member mesh of the card: 8 requests of 4 + 3·i
   prompt tokens, 32 new tokens each, every request done with ids in
   [0, 49155); B3 launched exactly 72 and the segment kernel 24 times a
   decode step (over the run and on one step alone) and no GROUP BY
   kernel; full-width ``forward`` against the token-by-token
   ``decode_step`` over 16 tokens (rel < 0.05, the reference's rule);
   layer 0's MoE block through the kernels against the plain versions
   (1e-4 · max|plain|).  Prints the prefill seconds, the decode
   milliseconds a step and tokens/s.
   Phase 3 train (lm_train; ``train/loop.py`` over ``models/`` and
   ``optim/``): qwen3-0.6b at full width (28 layers, d 1024, vocab
   151,936, tied, bf16 compute over 596 M float32 parameters and AdamW
   moments, random weights from a seeded card generator) trained by
   ``train_loop`` on a one-member mesh for 30 steps of
   ``SyntheticLM(batch=8, seq=128, track_stats=True)`` with
   ``examples/train_lm.py``'s hyperparameters (peak lr 1e-3, warmup 20,
   ticketed embedding): every loss finite, the last 5 below the first 5;
   exactly one ticket and one B5 launch a step (the embedding's
   backward), no B3 launch, and per batch pulled the launches of the
   stats plan's route (scan_body: one ``scan_ticket``, one segment
   launch); the ``token_stats()`` total equal to the tracked rows; the
   backward's table gradient on the card against its plain three-step
   version on the same tensors (the same rows, sums within 1e-4 · Σ|g|);
   a resume at the tiny preset (reduced, float32: 4 steps against 2, a
   commit, 2 more) within 1e-4 of each leaf.  Prints ms a step, tokens/s,
   peak memory, the backward's three stages and the plain gather's
   autograd backward beside them.
   Phase 3 train_moe (lm_train_moe): granite-moe-1b-a400m at full width
   (24 layers, 32 experts top-8, 1.33 B float32 parameters and AdamW
   moments, bf16 compute) trained the same way (30 steps of 8 × 128
   tokens, the same hyperparameters, ticketed embedding): losses finite
   and falling, aux finite and > 0 every step; exactly 144 B3, 144 B6 and
   48 segment launches (``route``; each layer's forward runs again in its
   recompute under remat), one ticket and one B5 launch a step,
   and the stats plan's per batch; layer 0's MoE gradients (input, router,
   the three expert tensors) at the last batch's activations, through the
   kernels against the plain versions, within 1e-5 of each leaf's
   max|grad|.  Prints ms a step, tokens/s, peak memory, and B6's and B3's
   device time in a step (one step's launches replayed from a CUDA graph).
   Phase 3 train_dp (lm_train_dp): ``make_manual_dp_step`` on a (pod 2,
   data 2) mesh of four virtual members of the card, qwen3-0.6b's widths
   at 4 of its 28 layers, int8 compression over pod, 30 steps of 8 × 128
   tokens, and the uncompressed step beside it from the same parameters
   and batches, then both from a second seed: every loss curve finite and
   falling, one ticket and one B5 launch a member and step; one uncompressed float32 step against the
   one-member step on the whole batch (grad_norm within 1e-5, parameters
   within lr).  Prints ms a step, the curves and the last-loss gaps.
   Phase 3 train_placed (lm_train_placed): ``train_loop`` of qwen3-0.6b at
   full width and depth on a (data 2, model 2) mesh of four virtual
   members, parameters and AdamW state placed by ``param_specs``
   (``jit_train_step``), 10 steps of 8 × 128 tokens: losses finite and
   falling, one ticket and one B5 launch a data-parallel member and step
   and no other kernel, one copy of each part on the card; a float32
   placed step (4 layers) and two placed granite-moe-1b-a400m steps (4 of
   24 layers, (data 2, model 2), B3 and B6 on the path) against the
   one-member step from the same state (the train_dp gate).  Prints ms a
   step and peak MiB beside the one-member step's, and the memory held
   and peaked in the last step's gradient and update stages.
   Phase 3 lm_ep: expert parallelism at granite-moe-1b-a400m's full width
   and depth on virtual members: a ``make_train_step(moe_impl="ep")`` step
   on (data 1, model 4) at a capacity that drops nothing against the dense
   step from the same state (loss and grad_norm), three more timed beside
   train_moe's dense step; 30 steps of the reference's ``moe_ts2`` setting
   on (data 2, model 2) (token slice, int8 dispatch, capacity factor 1.0),
   losses falling, the rows dropped per layer printed; EP ``forward`` and
   ``decode_step`` against dense; the members' expert stacks views of the
   layer stacks; the segment kernel once a member and layer (twice in a
   training step: the forward and the recompute), ticket and B5 once a
   step, no B3 / B6.  Phase 3 serve_members: ``ServeLoop`` on a
   (data 2, model 2) mesh against the one-member loop for qwen3-0.6b and
   granite-moe-1b-a400m at full width (tokens equal or a near-tied top-2
   where they first differ, one copy a cache part, B3 and segment
   launches a data member and step, a ``jit_serve_step(seq_shard=True)``
   step), the decode ms beside one member's.  Phase 3 launch:
   ``launch.serve.main`` and ``launch.train.main`` through their
   ``main(argv)`` on four virtual members.
   Phase 3 remat (lm_remat): qwen3-0.6b at full width and depth, 3
   ``make_train_step`` steps of 4 × 4096 tokens (train_4k's sequence) on
   one member, which fit the card only because every block is
   rematerialised (``transformer._remat``): losses finite, ticket and B5
   once a step, the card's peak within DRYRUN_PEAK_RANGE of the dry run's
   prediction for the same step, the prediction with the blocks called
   directly (over 80 GB) printed beside it, with the step ms.  Phase 3
   remat_families (lm_remat_families): all ten configs at published
   widths and cut depth (2 layers; zamba2 one super-block; seamless 2 + 2),
   2 × 256 text tokens: float32 gradients with remat against the blocks
   called directly (each leaf within FAMILY_RTOL of its max|g|), then one
   training step, its loss finite; B3 6, B6 6 and segment 2 launches a
   MoE layer under remat.
   Phase 3 serve_families (lm_serve_families): every config's serving path
   at published widths and cut depth (``serve_config``: 2 layers; zamba2
   ``attn_every + 2``, one super-block and a two-block Mamba2 tail;
   seamless 2 + 2), bf16 compute over float32 parameters: (a) 2 × 48 tokens
   decoded one at a time against ``forward`` (internvl2 after its 256
   vision positions in one cached prefill with ``frontend_embeds``;
   seamless with ``encoder_memory`` at every step), rel < 0.05 at every
   position, the positions a MoE layer routed otherwise printed; (b) gemma2
   and zamba2 prefill 4160 tokens through the cache (past their 4096-token
   window, ``last_only``) and step 8 more, rwkv6 and zamba2 prefill 300
   tokens on (a)'s caches (the chunked path seeded from the cache, a
   ragged last chunk), each against ``forward`` within 0.05; (c)
   ``ServeLoop(slots=8, max_len=128)`` on the lm phase's 8 prompts, 16 new
   tokens: every request done, tokens equal to a greedy loop over
   ``decode_step`` or a top-2 margin under 0.25 where they first differ;
   (d) B3 3 and segment 1 a MoE layer and step, nothing else; (e) decode ms
   a step, tokens/s and peak MiB beside the card.  ``decode_step_twobuf``
   for qwen3-0.6b and qwen2-moe-a2.7b from a 64-token prefill's K/V, 8 tail
   steps: the bf16 prefix against ``decode_step`` within 0.05, the int8
   prefix (round(x / KV_Q8_SCALE), ±127) finite and within
   ``int8_prefix_bound`` of it at the steps routed alike.  qwen2-moe's (a)
   and two-buffer gates run at float32 (ROADMAP §3 fault 15: a bf16 router
   near a tie picks another expert; the bf16 figures are printed).  Then
   ``launch.serve.main`` for rwkv6-1.6b and zamba2-1.2b at full depth (8
   requests, 16 new tokens, one member): every request done, the
   reference's closing line.
   Phase dryrun: ``launch.dryrun.run_cell`` (a trace of one member's step
   on meta tensors) for qwen3-0.6b and granite-moe-1b-a400m at train_4k,
   qwen3-0.6b at decode_32k and granite-moe-1b-a400m at prefill_32k on
   16×16, each cell's per-member peak, FLOPs, bytes, collective bytes,
   roofline terms (an H100 SXM's datasheet constants) and bottleneck
   printed; then the dry run of train's and train_moe's one-member steps
   (8 × 128 tokens) against the same step on the card, run once under the
   same counting mode: predicted FLOPs within DRYRUN_FLOPS_RTOL of the
   card step's count, predicted peak within DRYRUN_PEAK_RANGE of the
   card's ``max_memory_allocated`` over what was held; the largest
   roofline term beside phase 3's median step ms, the HBM constant beside
   the card's total memory.
4. timing — CUDA events, median of 5 after 50 ms of warm-up calls, on
   one 2^21-row main-path chunk of each class, beside its bound, its plain
   version and one library call: the fused kernel (low, high, unique at
   P = 1, low at P = 132; library ``torch.unique`` + ``index_add_``), held
   against its plain version on each of those chunks, and swept over CTA
   sizes; the ticket kernel (library
   ``torch.unique(return_inverse=True)``) and the segment kernel per plane
   and strategy (library ``index_add_`` / ``scatter_reduce_``, printed per
   class and kind), each timed beside its plain version and held against
   it on every class's chunk.  The ticket call is also split: allocation
   and fill alone, the launch alone, and ``torch.profiler``'s device time
   per kernel, and its choice of mode
   is timed on the zipf and unique chunks against a 2^25-slot table (the
   mode the sample chooses beside tile mode, forced by one morsel of EMPTY
   rows).  Both
   routes run on the same chunks, and the fused time is printed beside the
   ticket kernel's.  ``scan_ticket`` is timed on the same chunks (4096-row
   morsels, the bound of the class's stream), beside its plain version,
   its bytes bound and ``torch.unique(return_inverse=True)``, and held
   against its plain version on each; its call is split on an idle card
   (the whole call, the wrapper's host work before the launch on the host
   clock, the launch alone) and swept over CTA sizes (256, 512, 1024).
   One ``torch.profiler`` session (a second one records nothing) gives the
   device time of every kernel of one ticket call, one ``scan_ticket``
   call, one ``hybrid_registers`` call and three ``preagg`` calls per
   class and worker count, and the serialized kernel.  The serialized
   kernel on one chunk of its stream (8192 rows), beside ``index_add_``.
   ``hybrid_registers`` on the low, high, unique and heavy-unique chunks
   with the main path's planes and the heavy keys ``detect_heavy_hitters``
   names, beside its plain version (held against it) and its bytes bound
   (no library call computes it), its event-timed call less its device
   time printed per class.
   ``preagg`` on the low, high and unique chunks at W = 8 and 132, C =
   1024, kind sum, beside its plain version (held against it) and its
   bytes bound, its device time from CUDA-graph replays, and from the
   same profiler session split into the scratch fill, pass 1 and pass 2,
   and each pass's flush as the difference of its device time with and
   without it; swept over tile sizes (2048–16384 rows beside the
   automatic tile); and one partitioned chunk of the high class split
   into pre-aggregation, exchange, partition-wise sort and the host
   merge.  The register fold also at R = 64 and 256 on the high chunk,
   beside its bytes bound; ``index_add_`` into the unique class's G =
   2^24 beside the serialized kernel's row.  ``scan_ticket_batched``'s
   folding launch at N = 8 and 16 lanes × one 2^16-row chunk of
   serve_low's shape and planes (CUDA events, and CUDA-graph replays)
   beside the two-stage round it replaces (the ticket launch and N × S
   scatter updates) timed the same two ways, the ticket launch alone,
   N × (``torch.unique(return_inverse=True)`` + one ``index_add_`` /
   ``scatter_reduce_`` a plane), its plain version (held against it) and
   its bytes bound.  B3 at the decode shapes (64 rows, gate / up and down),
   the 4096-row prefill shape and qwen2-moe's decode shapes, warm (events), cold (events, the L2
   flushed before each call, as the served path meets it) and by CUDA-graph
   replay, beside its bound (the larger of the bytes of lhs, out and the
   touched experts' weights and the 3 × 2·rows·K·N TF32 tensor operations;
   the float32-FMA count is printed too), its plain version, the
   per-expert ``torch.matmul`` loop and ``torch._grouped_mm`` (bfloat16
   operands, where it runs).  B5 at the training shape (1024 ×
   1024 rows at Zipf tickets) and at R = G = 16384, by events and by
   CUDA-graph replay (their difference is the host's µs a call), beside
   the training rows at distinct tickets (what the hot tickets'
   contention costs), its bytes bound, its plain version and
   ``torch.zeros`` + ``index_add_`` by events and by graph.  B6 at the
   training shapes (8192 rows, gate / up and down; gate / up with a Zipf
   hot expert) and the decode gate / up shape, by events and by
   CUDA-graph replay (each product's launch alone too), beside its bound
   (the larger of its bytes and two products of 3 × 2·rows·K·N TF32
   tensor operations; the float32-FMA count and this design's own floor
   printed too), its plain version, the
   per-expert float32 ``torch.matmul`` loop and the backward of
   ``torch._grouped_mm`` at bf16.  The table ops by events and by a CUDA
   graph's replay, beside their bytes bounds and their plain loops (once):
   ``get_or_insert`` at split_unique's merge shape (2^24 key_by_ticket
   lanes, 2^21 live, into 2^25 slots holding 2^21 keys; reset between
   calls, untimed), ``migrate`` of 2^21 keys from 2^22 into 2^23 slots and
   ``lookup`` of each class's chunk in a table holding it; no library call
   computes them.

The line before the last two is ``{"kernels": [...]}``, then the card's
name and power limit from ``nvidia-smi``, and the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

M = 1024                        # morsel rows, the fused route's default
SPECS4 = ((-1, "count"), (0, "sum"), (0, "min"), (0, "max"))
KINDS4 = ("sum", "count", "min", "max")
KERNELS = ("fused_groupby", "ticket_hash", "segment_agg", "hybrid_registers",
           "preagg", "grouped_matmul", "segment_rows", "table_ops")  # CUDA sources
SCAN_M = 4096                   # the scan route's morsel rows (ExecutionPolicy default)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor float32/int32 peak
TF32_OPS_PER_S = 495e12         # H100 SXM tensor-core TF32 peak, dense
SUM_RTOL = 1e-4                 # |Δsum| ≤ SUM_RTOL · Σ|v| over the group
DRYRUN_CELLS = (("qwen3_0_6b", "train_4k"), ("granite_moe_1b_a400m", "train_4k"),
                ("qwen3_0_6b", "decode_32k"), ("granite_moe_1b_a400m", "prefill_32k"))
DRYRUN_FLOPS_RTOL = 0.01        # dry run vs the card step's count, FLOPs
DRYRUN_PEAK_RANGE = (0.8, 1.25)  # dry run's peak over the card's, one-member step


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# -- data (benchmarks/common.py gen_keys, on the card) ------------------------


def zipf(n, a, gen, device):
    """Zipf(a) samples by numpy's rejection method, drawn on ``device``."""
    import torch

    am1, b = a - 1.0, 2.0 ** (a - 1.0)
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        v = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x >= 1) & (x < 2.0 ** 62) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out


def gen_keys(n, cardinality, dist, gen, device):
    """The paper's §4.1 key classes as ``benchmarks/common.py`` encodes
    them: cardinality low (1000) / high (n // 10) / unique (n); uniform,
    zipf (s = 1.8) or heavy hitter (half the rows on key 7).  int64."""
    import torch

    k = {"low": 1000, "high": max(n // 10, 1), "unique": n}[cardinality]
    if dist == "uniform":
        if cardinality == "unique":
            return torch.randperm(n, generator=gen, device=device)
        return torch.randint(0, k, (n,), generator=gen, device=device)
    if dist == "zipf":
        return torch.remainder(zipf(n, 1.8, gen, device) - 1.0, k).to(torch.int64)
    if dist == "heavy":
        keys = torch.randint(0, k, (n,), generator=gen, device=device)
        hh = torch.rand(n, generator=gen, device=device) < 0.5
        return torch.where(hh, torch.full_like(keys, 7), keys)
    raise ValueError(dist)


def heavy_unique_keys(n, gen, device):
    """Paper Table 2's worst corner: distinct keys (a permutation of n)
    with a third of the rows, shuffled, on one key (7).  int64."""
    import torch

    keys = torch.randperm(n, generator=gen, device=device)
    hot = torch.rand(n, generator=gen, device=device) < 1 / 3
    return torch.where(hot, torch.full_like(keys, 7), keys)


def oracle(keys, vals):
    """Sort-based GROUP BY, independent of the port: sorted unique keys,
    counts, float64 sums and |v| sums, max."""
    import torch

    uk, inv, cnt = torch.unique(keys, return_inverse=True, return_counts=True)
    g = uk.numel()
    v64 = vals.double()
    s = torch.zeros(g, dtype=torch.float64, device=keys.device).index_add_(0, inv, v64)
    a = torch.zeros(g, dtype=torch.float64, device=keys.device).index_add_(0, inv, v64.abs())
    mx = torch.full((g,), float("-inf"), device=keys.device).scatter_reduce_(
        0, inv, vals, "amax")
    mn = torch.full((g,), float("inf"), device=keys.device).scatter_reduce_(
        0, inv, vals, "amin")
    return {"keys": uk, "count": cnt, "sum": s, "abs": a, "max": mx, "min": mn}


# -- phase 2: kernel vs plain ---------------------------------------------------


def _by_key(state, p):
    """Program p's groups sorted by key: (keys int64, order into kbt)."""
    import torch

    n = int(state.count[p])
    kb = state.kbt[p, :n].to(torch.int64) & 0xFFFFFFFF
    order = torch.argsort(kb)
    return kb[order], order


def check_tickets(fk, state, label):
    """Gap-free tickets 1..count, each slot's ticket naming its key in
    key_by_ticket."""
    import torch

    for p in range(state.programs):
        n = int(state.count[p])
        occ = state.ttks[p] > 0
        t = state.ttks[p][occ]
        check(torch.equal(torch.sort(t).values.cpu(), torch.arange(1, n + 1, dtype=torch.int32)),
              f"{label}: tickets of program {p} are not 1..{n}")
        inb = t <= state.max_groups
        check(torch.equal(state.kbt[p][(t[inb] - 1).long()], state.tkeys[p][occ][inb]),
              f"{label}: key_by_ticket disagrees with the table in program {p}")


def compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_sum_of, label, *,
                         same_keys=True):
    """The kernel's state vs the plain version's, by the port's rules, for
    launches that leave no morsel todo: info equal, events equal (probe
    steps aside; saturated morsels only by the flag when the table
    saturated, since which morsels saturate depends on the CTAs' order),
    gap-free tickets, and the key → aggregate map.  Returns the largest
    |Δ| seen on any accumulator."""
    import torch

    check(torch.equal(ks.count, ps.count), f"{label}: group counts differ")
    check(not bool(kinfo[:, fk.INFO_HALTED].any()) and not bool(pinfo[:, fk.INFO_HALTED].any()),
          f"{label}: a launch left morsels todo {kinfo.tolist()} vs {pinfo.tolist()}")
    check(torch.equal(kinfo, pinfo), f"{label}: info differs {kinfo.tolist()} vs {pinfo.tolist()}")
    ev_k, ev_p = ks.events.cpu(), ps.events.cpu()
    exact = [0, 1, 2, 5]   # morsels, rows, masked rows, pauses
    if not bool(pinfo[:, fk.INFO_SAT].any()):
        exact.append(4)    # saturated morsels
    check(torch.equal(ev_k[:, exact], ev_p[:, exact]),
          f"{label}: events differ {ev_k.tolist()} vs {ev_p.tolist()}")
    check(torch.equal(ev_k[:, 6:].sum(dim=1), ev_k[:, 1]),
          f"{label}: probe histogram does not sum to the committed rows")
    check_tickets(fk, ks, label + " kernel")
    err = 0.0
    for p in range(ks.programs):
        kk, ko = _by_key(ks, p)
        pk, po = _by_key(ps, p)
        if not same_keys:
            continue
        check(torch.equal(kk, pk), f"{label}: key sets differ in program {p}")
        tol = SUM_RTOL * abs_sum_of(kk)
        for s, (_, kind) in enumerate(SPECS4):
            a, b = ks.accs[s, p][ko], ps.accs[s, p][po]
            d = (a - b).abs()
            err = max(err, float(d.max()) if d.numel() else 0.0)
            if kind == "sum":
                check(bool((d.double() <= tol).all()), f"{label}: SUM outside tolerance")
            else:
                check(torch.equal(a, b), f"{label}: {kind.upper()} differs")
    return err


def grid_of(fk) -> str:
    ctas, per_program = fk.fused_consume.grid
    return f"grid {ctas} CTAs, {per_program} per program"


def abs_sum_lookup(keys, vals):
    """key → Σ|v| over all rows of the key (the SUM tolerance's scale)."""
    import torch

    o = oracle(keys, vals)

    def of(k):
        idx = torch.searchsorted(o["keys"], k)
        return o["abs"][idx]

    return of


def sync(device=None) -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def timed(fn, *args, **kw):
    """(result, seconds) of one call on the host clock, synchronized."""
    sync()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync()
    return out, time.perf_counter() - t0


def phase2(fk, gen, device, n=1 << 20, sat_rows=1 << 13):
    import torch

    from repro_torch.core.hashing import table_capacity

    def ones(k):
        return torch.ones(k, dtype=torch.int32, device=device)

    kinds = tuple(k for _, k in SPECS4)
    max_err = 0.0
    for dist in ("uniform", "zipf", "heavy"):
        keys = gen_keys(n, "high", dist, gen, device)
        vals = torch.randn(n, generator=gen, device=device)
        g = int(torch.unique(keys).numel())
        c = table_capacity(g)
        abs_of = abs_sum_lookup(keys, vals)
        for P in (1, 4):
            km = keys.to(torch.int32).reshape(-1, M).contiguous()
            vm = vals.reshape(1, -1, M).contiguous()
            kw = dict(specs=SPECS4, checked=True, grow_bound=False,
                      threshold=int(0.5 * c), bound_slack=g - M, collect_events=True)
            ks = fk.init_fused_state(capacity=c, max_groups=g, kinds=kinds, programs=P,
                                     device=device)
            ps = fk.init_fused_state(capacity=c, max_groups=g, kinds=kinds, programs=P,
                                     device=device)
            (ks, kinfo), k_s = timed(fk.fused_consume, ks, km, vm, ones(km.shape[0]), **kw)
            (ps, pinfo), p_s = timed(fk.fused_consume_plain, ps, km, vm, ones(km.shape[0]),
                                     **kw)
            label = f"phase2 {dist} P={P}"
            check(fk.fused_consume.grid[1] > 1, f"{label}: one CTA per program")
            err = compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_of, label)
            max_err = max(max_err, err)
            log(f"{label}: rows={n} groups={g} capacity={c} counts={ks.count.tolist()} "
                f"{grid_of(fk)} max|Δacc|={err:.3g} kernel {k_s * 1e3:.2f} ms plain "
                f"{p_s * 1e3:.0f} ms (host clock, first call) ok")

    # forced pause partway through the chunk (GROW bound of half the
    # groups), grow, replay each version's own todo morsels
    keys = gen_keys(n, "high", "uniform", gen, device)
    vals = torch.randn(n, generator=gen, device=device)
    d = int(torch.unique(keys).numel())
    g1 = d // 2
    c1 = table_capacity(g1)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    npm = km.shape[0]
    ktodo, ptodo = ones(npm), ones(npm)
    kw1 = dict(specs=SPECS4, checked=True, grow_bound=True, threshold=int(0.5 * c1),
               bound_slack=g1 - M, collect_events=True)
    ks = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=kinds, device=device)
    ps = fk.init_fused_state(capacity=c1, max_groups=g1, kinds=kinds, device=device)
    ks, kinfo = fk.fused_consume(ks, km, vm, ktodo, **kw1)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, ptodo, **kw1)
    grid = grid_of(fk)
    abs_of = abs_sum_lookup(keys, vals)
    left = int(ktodo.sum())
    check(int(kinfo[0, fk.INFO_HALTED]) == 1 and int(pinfo[0, fk.INFO_HALTED]) == 1
          and 0 < left < npm, f"phase2 pause: expected a halt partway, info {kinfo.tolist()}")
    check(int(kinfo[0, fk.INFO_FIRST_HALT]) == int(torch.nonzero(ktodo)[0]),
          "phase2 pause: info's lowest todo morsel is not the mask's")
    check(int(ks.count[0]) <= g1, f"phase2 pause: {int(ks.count[0])} tickets past G={g1}")
    check_tickets(fk, ks, "phase2 pause kernel")
    count1, p_first = int(ks.count[0]), int(pinfo[0, fk.INFO_FIRST_HALT])
    committed_rows = int((km[ktodo == 0] != -1).sum())
    check(float(ks.accs[0].sum()) == float(committed_rows),
          "phase2 pause: committed morsels' rows not counted exactly once")
    g2 = 4 * g1
    c2 = table_capacity(g2)
    ks = fk.grow_fused_state(ks, kinds, new_max_groups=g2, new_capacity=c2)
    ps = fk.grow_fused_state(ps, kinds, new_max_groups=g2, new_capacity=c2)
    kw2 = dict(kw1, threshold=int(0.5 * c2), bound_slack=g2 - M)
    ks, kinfo = fk.fused_consume(ks, km, vm, ktodo, **kw2)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, ptodo, **kw2)
    err = compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_of, "phase2 resume")
    max_err = max(max_err, err)
    check(int(ks.count[0]) == d, "phase2 resume: group count is not the distinct count")
    check(float(ks.accs[0].sum()) == float(n), "phase2 resume: rows counted twice or lost")
    log(f"phase2 pause: {grid}; {npm - left}/{npm} morsels committed, count {count1} "
        f"with {g1} of {d} groups allowed (plain: halted at morsel {p_first}); replayed "
        f"the todo morsels after growing to {g2}: {grid_of(fk)}, "
        f"counts={ks.count.tolist()} max|Δacc|={err:.3g} ok")

    # unchecked against a saturated table: must end; admitted keys exact
    keys = torch.randint(0, 4096, (sat_rows,), generator=gen, device=device)
    vals = torch.randn(sat_rows, generator=gen, device=device)
    km = keys.to(torch.int32).reshape(-1, M).contiguous()
    vm = vals.reshape(1, -1, M).contiguous()
    kw3 = dict(specs=SPECS4, checked=False, grow_bound=False, collect_events=True)
    ks = fk.init_fused_state(capacity=1024, max_groups=4096, kinds=kinds, device=device)
    ps = fk.init_fused_state(capacity=1024, max_groups=4096, kinds=kinds, device=device)
    (ks, kinfo), t_kernel = timed(fk.fused_consume, ks, km, vm, ones(km.shape[0]), **kw3)
    ps, pinfo = fk.fused_consume_plain(ps, km, vm, ones(km.shape[0]), **kw3)
    compare_kernel_plain(fk, ks, kinfo, ps, pinfo, None, "phase2 saturated",
                         same_keys=False)
    check(int(ks.count[0]) == 1024 and int(kinfo[0, fk.INFO_SAT]) == 1,
          f"phase2 saturated: expected a full, saturated table, info {kinfo.tolist()}")
    o = oracle(keys, vals)
    for label, st in (("kernel", ks), ("plain", ps)):
        kk, ko = _by_key(st, 0)
        idx = torch.searchsorted(o["keys"], kk)
        check(torch.equal(o["keys"][idx], kk), f"phase2 saturated {label}: unknown key")
        check(torch.equal(st.accs[0, 0][ko].double(), o["count"][idx].double()),
              f"phase2 saturated {label}: admitted keys' COUNT is not exact")
        check(torch.equal(st.accs[2, 0][ko], o["min"][idx]) and
              torch.equal(st.accs[3, 0][ko], o["max"][idx]),
              f"phase2 saturated {label}: admitted keys' MIN/MAX are not exact")
        d_sum = (st.accs[1, 0][ko].double() - o["sum"][idx]).abs()
        check(bool((d_sum <= SUM_RTOL * o["abs"][idx]).all()),
              f"phase2 saturated {label}: admitted keys' SUM outside tolerance")
    check(int(ks.events[0, 4]) >= 1 and int(ps.events[0, 4]) >= 1,
          "phase2 saturated: no saturated morsel counted")
    log(f"phase2 saturated: rows={sat_rows} distinct≈4096 capacity=1024 -> count=1024, "
        f"saturated morsels {int(ks.events[0, 4])} (plain {int(ps.events[0, 4])}), "
        f"{grid_of(fk)}, kernel ended in {t_kernel:.3f} s ok")
    return max_err


def check_ticket_maps(th, keys, kout, pout, label, *, full=False):
    """The ticket kernel's outputs vs the plain version's by the port's
    contract (``ticket_map_discrepancies``: the same count; one gap-free
    ticket per key, consistent with the kernel's own table and
    key_by_ticket; the same key set and the same -1 rows unless the table
    is full, then a row is -1 iff its key is not in the kernel's table).
    A full table must leave some row unresolved.  Returns the
    discrepancies counted (0 when the check passes)."""
    bad = th.ticket_map_discrepancies(keys, kout, pout, full=full)
    check(bad == 0, f"{label}: {bad} discrepancies from the plain version's ticket map")
    if full:
        check(bool(((keys != -1) & (kout[0] < 0)).any()),
              f"{label}: a full table left no row unresolved")
    return bad


def check_segment(sa, t, v, got, want, kind, label, num_groups):
    """COUNT/MIN/MAX exact, SUM within SUM_RTOL · Σ|v| of the group.
    Returns the largest |Δ|."""
    import torch

    d = (got - want).abs()
    d = d[torch.isfinite(d)]
    err = float(d.max()) if d.numel() else 0.0
    if kind == "sum":
        tol = SUM_RTOL * sa.segment_agg_plain(t, v.abs(), num_groups=num_groups, kind="sum")
        check(bool(((got - want).abs() <= tol).all()), f"{label}: SUM outside tolerance")
    else:
        check(torch.equal(got, want), f"{label}: {kind.upper()} differs")
    return err


def phase2_split(th, sa, gen, device, n=1 << 20, sat_rows=1 << 13):
    """The split route's two kernels vs their plain versions on the card.
    Returns the largest discrepancy of each (check_ticket_maps' count for
    the ticket kernel, |Δacc| for the segment kernel)."""
    import torch

    from repro_torch.core.hashing import table_capacity

    max_err = {"ticket_hash": 0, "segment_agg": 0.0}
    cases = []
    for dist in ("uniform", "zipf", "heavy"):
        keys = gen_keys(n, "high", dist, gen, device).to(torch.int32)
        g = int(torch.unique(keys).numel())
        cases.append((dist, keys, table_capacity(g), g, False))
    keys = gen_keys(n, "high", "uniform", gen, device).to(torch.int32)
    keys[:1000] = -1  # EMPTY padding rows
    g = int(torch.unique(keys[keys != -1]).numel())
    cases.append(("over_bound", keys, table_capacity(g), g // 3, False))
    keys = torch.randint(0, 4096, (sat_rows,), generator=gen, device=device).to(torch.int32)
    cases.append(("full", keys, 1024, 4096, True))
    # every row inserts, 16 slots a row: the kernel builds the table by regions
    keys = torch.randperm(1 << 24, generator=gen, device=device)[:n].to(torch.int32)
    cases.append(("unique_regions", keys, 16 * n, n, False))
    keys = torch.randint(0, 1500, (3 * M,), generator=gen, device=device).to(torch.int32)
    cases.append(("ragged_tile", keys, 4096, 2048, False))
    for label, keys, cap, g, full in cases:
        kout, k_s = timed(th.ticket_hash, keys, capacity=cap, max_groups=g, morsel_size=M)
        pout, p_s = timed(th.ticket_hash_plain, keys, capacity=cap, max_groups=g,
                          morsel_size=M)
        err = check_ticket_maps(th, keys, kout, pout, f"phase2 ticket {label}", full=full)
        max_err["ticket_hash"] = max(max_err["ticket_hash"], err)
        count = int(kout[4])
        if label == "over_bound":
            check(count > g, f"phase2 ticket over_bound: count {count} <= G {g}")
        if full:
            check(count == cap, f"phase2 ticket full: count {count} != {cap}")
        log(f"phase2 ticket {label}: rows={keys.numel()} capacity={cap} G={g} count={count} "
            f"unresolved={int((kout[0] < 0).sum())} kernel {k_s * 1e3:.2f} ms plain "
            f"{p_s * 1e3:.0f} ms (host clock, first call) ok")

    g = 3000
    t = torch.randint(-1, g + 200, (n,), generator=gen, device=device, dtype=torch.int32)
    v = torch.randn(n, generator=gen, device=device)
    for strategy in ("scatter", "onehot"):
        for kind in KINDS4:
            got = sa.segment_agg(t, v, num_groups=g, kind=kind, strategy=strategy,
                                 morsel_size=M)
            want = sa.segment_agg_plain(t, v, num_groups=g, kind=kind, strategy=strategy,
                                        morsel_size=M)
            label = f"phase2 segment {kind}/{strategy}"
            err = check_segment(sa, t, v, got, want, kind, label, g)
            max_err["segment_agg"] = max(max_err["segment_agg"], err)
            log(f"{label}: rows={n} G={g} (tickets -1..{g + 199}) max|Δ|={err:.3g} ok")
    # a hot key: 55% of the rows on one ticket, the rest over G = 2^14
    g = 1 << 14
    t = torch.randint(-1, g + 100, (n,), generator=gen, device=device, dtype=torch.int32)
    t[torch.rand(n, generator=gen, device=device) < 0.55] = 5
    for kind in KINDS4:
        v = torch.randn(n, generator=gen, device=device)
        v[::97] = -0.0
        if kind in ("min", "max"):
            v[2::1013] = float("inf")
            v[3::1009] = float("-inf")
        got = sa.segment_agg(t, v, num_groups=g, kind=kind, morsel_size=M)
        want = sa.segment_agg_plain(t, v, num_groups=g, kind=kind, morsel_size=M)
        label = f"phase2 segment hot key {kind}/scatter"
        err = check_segment(sa, t, v, got, want, kind, label, g)
        max_err["segment_agg"] = max(max_err["segment_agg"], err)
        log(f"{label}: rows={n} G={g} hot ticket on {int((t == 5).sum())} rows "
            f"max|Δ|={err:.3g} ok")
    return max_err


def scan_pair(fk, tk, keys, rows, cap, g, **kw):
    """One ``scan_ticket`` launch and its plain version, each from a fresh
    table of ``cap`` slots and bound ``g``, over ``keys`` in morsels of
    ``rows``: (km, [(tickets, table, todo, info, events), ...], seconds
    of each on the host clock), kernel first."""
    import torch

    km = keys.to(torch.int32).reshape(-1, rows).contiguous()
    out, secs = [], []
    for fn in (fk.scan_ticket, fk.scan_ticket_plain):
        t = tk.make_table(cap, g, device=km.device)
        todo = torch.ones(km.shape[0], dtype=torch.int32, device=km.device)
        ev = torch.zeros(14, dtype=torch.int32, device=km.device)
        (tickets, info), sec = timed(fn, t, km, todo, events=ev, **kw)
        secs.append(sec)
        out.append((tickets, t, todo, info, ev))
    return km, out, secs


def check_scan_events(kev, pev, sat, label):
    """Committed-morsel events of two launches that commit every morsel:
    morsels, rows, masked rows and pauses exact, saturations unless the
    table saturated, the histogram summing to the rows."""
    import torch

    exact = [0, 1, 2, 5] + ([] if sat else [4])
    check(torch.equal(kev[exact].cpu(), pev[exact].cpu()),
          f"{label}: events differ {kev.tolist()} vs {pev.tolist()}")
    check(int(kev[6:].sum()) == int(kev[1]), f"{label}: histogram does not sum to the rows")


def phase2_scan(fk, sa, gen, device, n=1 << 20):
    """The scan route's kernels vs their plain versions on the card: the
    ticket stage (``scan_ticket``, its ``scan_ticket_kernel``)
    and the serialized update's one-thread kernel.  Returns the largest
    discrepancy of each."""
    import torch

    from repro_torch.core import resize
    from repro_torch.core import ticketing as tk
    from repro_torch.core.hashing import table_capacity

    worst = {"scan_ticket": 0, "segment_agg_serialized": 0.0}
    for dist in ("uniform", "zipf", "heavy"):
        keys = gen_keys(n, "high", dist, gen, device).to(torch.int32)
        keys[:777] = -1  # EMPTY rows
        g = int(torch.unique(keys[keys != -1]).numel())
        c = table_capacity(g)
        km, (k, p), (k_s, _) = scan_pair(fk, tk, keys, SCAN_M, c, g, checked=True,
                                    threshold=c // 2, collect_events=True)
        label = f"phase2 scan_ticket {dist}"
        check(torch.equal(k[3], p[3]), f"{label}: info differs {k[3].tolist()} vs {p[3].tolist()}")
        check(not bool(k[2].any()) and fk.scan_ticket.grid[1] > 1,
              f"{label}: morsels left todo or one CTA")
        check_scan_events(k[4], p[4], False, label)
        bad = fk.scan_ticket_discrepancies(km, k[:2], p[:2])
        check(bad == 0, f"{label}: {bad} discrepancies from the plain version's ticket map")
        log(f"{label}: rows={n} groups={g} capacity={c} grid {fk.scan_ticket.grid} "
            f"kernel {k_s * 1e3:.2f} ms (host clock, first call), 0 discrepancies ok")

    # a GROW bound of half the keys: pause partway, replay after the grow
    keys = gen_keys(n, "high", "uniform", gen, device)
    d = int(torch.unique(keys).numel())
    g1 = d // 2
    c = table_capacity(4 * g1)
    kw = dict(checked=True, grow_bound=True, threshold=c // 2, collect_events=True)
    km, (k, p), _ = scan_pair(fk, tk, keys, SCAN_M, c, g1, bound_slack=g1 - SCAN_M, **kw)
    ends = []
    for label, fn, (tickets, t, todo, info, ev) in (("kernel", fk.scan_ticket, k),
                                                   ("plain", fk.scan_ticket_plain, p)):
        left = todo.bool()
        check(int(info[0, fk.INFO_HALTED]) == 1 and 0 < int(left.sum()) < km.shape[0],
              f"phase2 scan pause {label}: no halt partway, info {info.tolist()}")
        check(int(t.count) <= g1, f"phase2 scan pause {label}: tickets past G={g1}")
        check(bool((tickets[left] == -1).all()) and bool((tickets[~left] >= 0).all()),
              f"phase2 scan pause {label}: a morsel committed in part")
        committed = int((~left).sum())
        t2 = resize.grow_bound(t, 4 * g1)
        t2b, info2 = fn(t2, km, todo, bound_slack=4 * g1 - SCAN_M, events=ev, **kw)
        check(int(info2[0, fk.INFO_HALTED]) == 0 and int(t2.count) == d,
              f"phase2 scan resume {label}: info {info2.tolist()}, {d} keys")
        check(int(ev[1]) == n, f"phase2 scan resume {label}: rows counted {int(ev[1])} != {n}")
        ends.append((torch.where(t2b >= 0, t2b, tickets), t2))
        log(f"phase2 scan pause {label}: {committed}/{km.shape[0]} morsels committed with "
            f"{g1} of {d} groups allowed, replayed after growing to {4 * g1} ok")
    bad = fk.scan_ticket_discrepancies(km, ends[0], ends[1])
    check(bad == 0, f"phase2 scan resume: {bad} discrepancies")

    # unchecked against a saturated table: must end
    keys = torch.randint(0, 4096, (1 << 13,), generator=gen, device=device)
    km, (k, p), (k_s, _) = scan_pair(fk, tk, keys, 1024, 1024, 4096, checked=False,
                                collect_events=True)
    check(int(k[1].count) == 1024 and int(k[3][0, fk.INFO_SAT]) == 1 and not bool(k[2].any()),
          f"phase2 scan saturated: expected a full table, every morsel committed, "
          f"info {k[3].tolist()}")
    check_scan_events(k[4], p[4], True, "phase2 scan saturated")
    bad = fk.scan_ticket_discrepancies(km, k[:2], p[:2], full=True)
    check(bad == 0, f"phase2 scan saturated: {bad} discrepancies")
    log(f"phase2 scan saturated: 8192 rows, ≈4096 keys, 1024 slots -> count 1024, "
        f"unresolved {int((k[0] < 0).sum())}, kernel ended in {k_s:.3f} s ok")

    # the serialized update: one thread, rows in order, against its row loop
    # bit for bit: the accumulator plane in shared memory (G = 3000, G at
    # the cap) and in device memory (just past it, and the unique class's
    # 2^24); tickets repeated one and two rows apart (the register forward),
    # -1 and >= G; a ragged row count; columns 4 bytes off a 16-byte
    # boundary; -0.0 and ±inf for min / max
    cap = sa.MAX_SERIALIZED_SHARED_GROUPS
    for case, rows, g in (("random", 1 << 14, 3000), ("shared_cap", 1 << 13, cap),
                          ("past_cap", 1 << 13, cap + 1), ("unique_g", 1 << 13, 1 << 24),
                          ("ragged", 3 * 1024 + 5, 700), ("misaligned", 2 * 1024 + 3, 300)):
        t = torch.randint(-1, g + 100, (rows + 1,), generator=gen, device=device,
                          dtype=torch.int32)
        t[1::5] = t[0::5][: t[1::5].numel()]
        t[2::7] = t[0::7][: t[2::7].numel()]
        v = torch.randn(rows + 1, generator=gen, device=device)
        # one row in: both columns 4 bytes past a 16-byte boundary
        rows_of = slice(1, None) if case == "misaligned" else slice(0, rows)
        for kind in KINDS4:
            vk = v.clone()
            if kind in ("min", "max"):
                vk[::17], vk[5::19], vk[6::23], vk[7::29] = -0.0, 0.0, float("inf"), float("-inf")
            tk_, vk = t[rows_of], vk[rows_of]
            acc = torch.full((g,), float("inf") if kind == "min" else
                             float("-inf") if kind == "max" else 0.0, device=device)
            want = sa.serialized_agg_plain(acc.cpu().clone(), tk_.cpu(), vk.cpu(), kind=kind)
            before = sa.serialized_agg.launches
            got = sa.serialized_agg(acc, tk_, vk, kind=kind).cpu()
            check(sa.serialized_agg.launches == before + 1,
                  f"phase2 serialized {case} {kind}: the kernel was not launched")
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"phase2 serialized {case} {kind}: differs from the row loop "
                  f"({int((got.view(torch.int32) != want.view(torch.int32)).sum())} groups)")
        log(f"phase2 serialized {case}: {rows} rows, G={g} "
            f"({'shared' if g <= cap else 'device'} memory plane), every kind bit for bit ok")
    return worst


def batched_pair(fk, km, tables, **kw):
    """``scan_ticket_batched`` and its plain version, each on its own
    copy of ``tables`` (the room checks of the scan executor: a load
    threshold of C / 2 and a slack of G - 4096): [(tickets, tables, todo,
    info), ...] kernel first, and the plain version's host seconds."""
    import torch

    from repro_torch.core import ticketing as tk

    out, secs = [], []
    for fn in (fk.scan_ticket_batched, fk.scan_ticket_batched_plain):
        copies = [tk.TicketTable(*(x.clone() for x in t)) for t in tables]
        todo = torch.ones(km.shape[:2], dtype=torch.int32, device=km.device)
        (tickets, info), sec = timed(
            fn, copies, km, todo, thresholds=[t.capacity // 2 for t in tables],
            bound_slacks=[t.max_groups - SCAN_M for t in tables], **kw)
        out.append((tickets, copies, todo, info))
        secs.append(sec)
    return out, secs[1]


def check_batched(fk, km, pair, label):
    """Every lane of a batched launch against the plain version's: the
    same info row and overflow flag, every morsel committed, 0
    discrepancies (``scan_ticket_discrepancies``).  Returns the largest."""
    import torch

    (kt, ktab, ktodo, kinfo), (pt, ptab, _, pinfo) = pair
    check(torch.equal(kinfo, pinfo), f"{label}: info differs {kinfo.tolist()} vs "
          f"{pinfo.tolist()}")
    check(not bool(ktodo.any()), f"{label}: morsels left todo")
    worst = 0
    for i in range(km.shape[0]):
        bad = fk.scan_ticket_discrepancies(km[i], (kt[i], ktab[i]), (pt[i], ptab[i]))
        check(bad == 0, f"{label} lane {i}: {bad} discrepancies")
        check(bool(ktab[i].overflowed) == bool(ptab[i].overflowed),
              f"{label} lane {i}: overflow flag differs")
        worst = max(worst, bad)
    return worst


FOLD_SPECS = ((None, "count"), ("v", "sum"), ("v", "min"), ("v", "max"))


def fold_pair(fk, km, vals, tables, specs=FOLD_SPECS, **kw):
    """``scan_ticket_batched`` in fold mode and its plain version, each on
    its own copy of ``tables`` and fresh accumulators (the room checks of
    :func:`batched_pair`), lane ``i`` folding value plane ``vals[i]``:
    [(tables, states, todo, info), ...] kernel first, and the plain
    version's host seconds."""
    import torch

    from repro_torch.core import ticketing as tk
    from repro_torch.core import updates as up

    out, secs = [], []
    for fn in (fk.scan_ticket_batched, fk.scan_ticket_batched_plain):
        copies = [tk.TicketTable(*(x.clone() for x in t)) for t in tables]
        states = [up.init_agg_state(specs, t.max_groups, device=km.device) for t in tables]
        todo = torch.ones(km.shape[:2], dtype=torch.int32, device=km.device)
        (tickets, info), sec = timed(
            fn, copies, list(km), todo, thresholds=[t.capacity // 2 for t in tables],
            bound_slacks=[t.max_groups - SCAN_M for t in tables], states=states,
            values=[{"v": vals[i]} for i in range(km.shape[0])], specs=specs, **kw)
        check(tickets is None, "fold mode returned tickets")
        out.append((copies, states, todo, info))
        secs.append(sec)
    return out, secs[1]


def check_fold_lane(keys, vals, table, state, specs, label):
    """One lane's table and planes against the oracle over its rows:
    gap-free tickets naming their slots' keys, every key ticketed, and per
    ticket below G its key's COUNT / MIN / MAX exactly and SUM within
    SUM_RTOL · Σ|v|; the planes past the count neutral."""
    import torch

    keys, vals = keys.reshape(-1), vals.reshape(-1)
    live = keys != -1
    o = oracle(keys[live].long(), vals[live])
    n, G = int(table.count), table.max_groups
    g = min(n, G)
    occ = table.tickets > 0
    t = table.tickets[occ]
    check(torch.equal(torch.sort(t).values.cpu(), torch.arange(1, n + 1, dtype=torch.int32)),
          f"{label}: tickets are not 1..{n}")
    inb = t <= G
    check(torch.equal(table.key_by_ticket[(t[inb] - 1).long()], table.keys[occ][inb]),
          f"{label}: key_by_ticket disagrees with the table")
    check(o["keys"].numel() == n, f"{label}: {n} groups, the oracle has {o['keys'].numel()}")
    kb = table.key_by_ticket[:g].long()
    idx = torch.searchsorted(o["keys"], kb)
    for s, (_, kind) in enumerate(specs):
        a = state.accs[s]
        if kind == "sum":
            check(bool(((a[:g].double() - o["sum"][idx]).abs()
                        <= SUM_RTOL * o["abs"][idx]).all()), f"{label}: SUM outside tolerance")
        else:
            want = o["count"][idx].float() if kind == "count" else o[kind][idx]
            check(torch.equal(a[:g], want), f"{label}: {kind.upper()} differs")
        neutral = {"sum": 0.0, "count": 0.0, "min": float("inf"), "max": float("-inf")}[kind]
        check(bool((a[g:] == neutral).all()), f"{label}: {kind} folded past the count")


def check_fold(fk, km, vals, pair, specs, label):
    """Every lane of a folding launch against the plain version's: the same
    info rows and overflow flags, every morsel committed, each version's
    lane held to the oracle (:func:`check_fold_lane`), the same key set
    where the count is within G, and the planes of the keys both ticket
    below G equal by key (COUNT / MIN / MAX exact, SUM within SUM_RTOL ·
    Σ|v|).  Returns the largest |Δ| of any plane between the two."""
    import torch

    (ktab, kst, ktodo, kinfo), (ptab, pst, _, pinfo) = pair
    check(torch.equal(kinfo, pinfo), f"{label}: info differs {kinfo.tolist()} vs "
          f"{pinfo.tolist()}")
    check(not bool(ktodo.any()), f"{label}: morsels left todo")
    err = 0.0
    for i in range(km.shape[0]):
        kt, pt = ktab[i], ptab[i]
        check(bool(kt.overflowed) == bool(pt.overflowed), f"{label} lane {i}: overflow differs")
        for side, t, st in (("kernel", kt, kst[i]), ("plain", pt, pst[i])):
            check_fold_lane(km[i], vals[i], t, st, specs, f"{label} lane {i} {side}")
        g = min(int(kt.count), kt.max_groups)
        kk, ko = torch.sort(kt.key_by_ticket[:g].long())
        pk, po = torch.sort(pt.key_by_ticket[:g].long())
        if int(kt.count) <= kt.max_groups:
            check(torch.equal(kk, pk), f"{label} lane {i}: key sets differ")
        mk, mp = torch.isin(kk, pk), torch.isin(pk, kk)
        for a, b in zip(kst[i].accs, pst[i].accs):
            d = (a[:g][ko][mk] - b[:g][po][mp]).abs()
            err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def phase2_batched(fk, gen, device, rows=1 << 18):
    """``scan_ticket_batched`` (the serving layer's multi-table ticket
    launch) against its plain version on the card: one launch over 8 lanes
    of 2^18 rows (3 uniform over 1000 keys, 3 zipf s = 1.8 over 2^15, 2
    unique), each lane against its own table (bounds and capacities of its
    class; lane 1 migrated to 2C after a first launch on 4 of its morsels);
    then a RAISE round of 8 lanes of 2^16 rows in which lane 5 alone issues
    more tickets than its G.  Both rounds again in fold mode (the scatter
    round: count, sum, min and max of each lane's values folded in the
    launch; the first round past the shared plane's cap, the second
    through it), each version's lanes held to the oracle and to each
    other (:func:`check_fold`).  Returns the largest discrepancy or plane
    |Δ|."""
    import torch

    from repro_torch.core import ticketing as tk
    from repro_torch.core.hashing import table_capacity
    from repro_torch.kernels import table_ops as tops

    classes = [("low", 1000)] * 3 + [("zipf", 1 << 15)] * 3 + [("unique", rows)] * 2
    keys = []
    for i, (cls, k) in enumerate(classes):
        if cls == "low":
            x = torch.randint(0, k, (rows,), generator=gen, device=device)
        elif cls == "zipf":
            x = torch.remainder(zipf(rows, 1.8, gen, device) - 1.0, k).to(torch.int64)
        else:
            x = torch.randperm(rows, generator=gen, device=device) + i * rows
        keys.append(x.to(torch.int32).reshape(-1, SCAN_M))
    km = torch.stack(keys).contiguous()
    km[:, 0, :333] = -1  # EMPTY rows
    tables = []
    for i, (cls, k) in enumerate(classes):
        g = rows if cls == "unique" else k + 64
        t = tk.make_table(table_capacity(g), g, device=device)
        if i == 1:
            fk.scan_ticket(t, km[i, :4].contiguous(),
                           torch.ones(4, dtype=torch.int32, device=device),
                           threshold=t.capacity // 2)
            t = tops.migrate(t, 2 * t.capacity)  # the card's migration kernel
        tables.append(t)
    km8, tables8 = km, tables
    before = fk.scan_ticket_batched.launches
    pair, p_s = batched_pair(fk, km, tables)
    check(fk.scan_ticket_batched.launches == before + 1,
          "phase2 scan_ticket_batched: not one launch for 8 lanes")
    worst = check_batched(fk, km, pair, "phase2 scan_ticket_batched")
    log(f"phase2 scan_ticket_batched: 8 lanes x {rows} rows, capacities "
        f"{[t.capacity for t in tables]}, grid {fk.scan_ticket_batched.grid}, counts "
        f"{pair[0][3][:, 0].tolist()}; plain {p_s:.2f} s; 0 discrepancies, info equal ok")

    # RAISE: lane 5 takes 3000 keys against G = 1024 (8192 slots: no pause)
    r2 = 1 << 16
    km = torch.randint(0, 1000, (8, r2 // SCAN_M, SCAN_M), generator=gen, device=device,
                       dtype=torch.int32)
    km[5] = torch.randperm(r2, generator=gen, device=device).to(torch.int32).reshape(
        -1, SCAN_M) % 3000
    tables = [tk.make_table(8192 if i == 5 else table_capacity(1024), 1024, device=device)
              for i in range(8)]
    pair, _ = batched_pair(fk, km, tables)
    worst = max(worst, check_batched(fk, km, pair, "phase2 scan_ticket_batched raise"))
    over = (pair[0][3][:, fk.INFO_COUNT] > 1024).tolist()
    check(over == [i == 5 for i in range(8)]
          and [bool(t.overflowed) for t in pair[0][1]] == over,
          f"phase2 scan_ticket_batched raise: overflow on lanes {over}, expected lane 5 only")
    log(f"phase2 scan_ticket_batched raise: counts {pair[0][3][:, 0].tolist()} against "
        f"G=1024, overflow on lane 5 only ok")

    # fold mode (the scatter round): the same two rounds, each lane folding
    # count, sum, min and max of its own values
    for label, fkm, ftables in (("", km8, tables8), (" raise", km, tables)):
        fvals = torch.randn(fkm.shape, generator=gen, device=device)
        before = fk.scan_ticket_batched.launches
        fpair, fp_s = fold_pair(fk, fkm, fvals, ftables)
        check(fk.scan_ticket_batched.launches == before + 1,
              f"phase2 scan_ticket_batched fold{label}: not one launch for 8 lanes")
        worst = max(worst, check_fold(fk, fkm, fvals, fpair, FOLD_SPECS,
                                      f"phase2 scan_ticket_batched fold{label}"))
        log(f"phase2 scan_ticket_batched fold{label}: 8 lanes, counts "
            f"{fpair[0][3][:, 0].tolist()}, grid {fk.scan_ticket_batched.grid}, planes "
            f"{[k for _, k in FOLD_SPECS]}; plain {fp_s:.2f} s; every lane held to the oracle "
            f"and the plain version ok (largest |d| {worst:.3g})")
    return worst


HR_KINDS = ("count", "sum", "min", "max")


def top_keys(k32, r):
    """The r - 1 most frequent live keys of an int32 key column, and one
    EMPTY pad: r heavy keys."""
    import torch

    live = k32[k32 != -1]
    uk, cnt = torch.unique(live, return_counts=True)
    heavy = torch.full((r,), -1, dtype=torch.int32, device=k32.device)
    top = uk[torch.argsort(cnt, descending=True)][: r - 1]
    heavy[: top.numel()] = top
    return heavy


def check_registers(keys, heavy, vals, got, want, tail_k, tail_p, kinds, label):
    """The register kernel vs its plain version: tail keys equal; COUNT,
    MIN and MAX exact; SUM within SUM_RTOL · Σ|v| of the register's rows.
    Returns the largest |Δ| of any register."""
    import torch

    check(torch.equal(tail_k, tail_p), f"{label}: tail keys differ in "
          f"{int((tail_k != tail_p).sum())} rows")
    hit = keys[None, :] == heavy[:, None]
    absum = torch.where(hit, vals.abs()[None, :], 0.0).double().sum(dim=1)
    err = 0.0
    for s, kind in enumerate(kinds):
        d = (got[s] - want[s]).abs()
        d = torch.where(torch.isinf(want[s]) & (got[s] == want[s]), torch.zeros_like(d), d)
        err = max(err, float(d.max()))
        if kind == "sum":
            check(bool((d.double() <= SUM_RTOL * absum + 1e-6).all()),
                  f"{label}: SUM outside {SUM_RTOL}·Σ|v|")
        else:
            check(torch.equal(got[s], want[s]), f"{label}: {kind.upper()} differs")
    return err


def phase2_hybrid(hr, gen, device, n=1 << 20):
    """The register kernel vs its plain version on a 2^20-row chunk of
    every class, in each of its size paths: R = 8, S = 4 and 8 (per-thread
    copies, keys compared in registers, the second at their S x R limit of
    64), R = 16 and 64, S = 4 and R = 8, S = 16 (per-warp copies, keys
    probed in a shared table); the planes cycle over every kind; keys spread
    over all 32 bits (an odd multiplier, so the classes keep their shape)
    with EMPTY rows.  Returns the largest |Δ| of any register."""
    import torch

    classes = {"low": gen_keys(n, "low", "uniform", gen, device),
               "high": gen_keys(n, "high", "zipf", gen, device),
               "unique": gen_keys(n, "unique", "uniform", gen, device),
               "heavy": gen_keys(n, "high", "heavy", gen, device),
               "heavy_unique": heavy_unique_keys(n, gen, device)}
    vals = torch.randn(n, generator=gen, device=device)
    vals[::97] = -0.0
    planes = [None, vals, vals, vals]
    err = 0.0
    for name, keys in classes.items():
        u = (keys * 0x9E3779B1) & 0xFFFFFFFF
        k32 = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
        k32[:7] = -1
        for r, s in ((8, 4), (8, 8), (16, 4), (64, 4), (8, 16)):
            heavy = top_keys(k32, r)
            kinds = HR_KINDS * (s // 4)
            fresh = torch.stack([torch.full((r,), v, device=device)
                                 for v in (0.0, 0.0, float("inf"), float("-inf"))] * (s // 4))
            got, want = fresh.clone(), fresh.clone()
            tail_k = hr.hybrid_registers(k32, heavy, planes * (s // 4), got, kinds=kinds)
            tail_p = hr.hybrid_registers_plain(k32, heavy, planes * (s // 4), want, kinds=kinds)
            sync(device)
            label = f"phase2 hybrid_registers {name} R={r} S={s}"
            e = check_registers(k32, heavy, vals, got, want, tail_k, tail_p, kinds, label)
            err = max(err, e)
            log(f"{label}: {int((tail_k == -1).sum()) - 7} rows on registers, "
                f"max|Δreg|={e:.3g}, tail equal, count/min/max exact ok")
    return err


PA_KINDS = ("sum", "count", "min", "max")
PA_C = 1024                     # the pre-aggregation table (ExecutionPolicy default)


def to_i32(keys):
    """int64 key values (any 32-bit pattern) → int32 bit patterns."""
    import torch

    u = keys & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def preagg_layout(k32, vals, w, multiple):
    """A chunk as the executor lays it out: EMPTY / zero padded to a
    multiple of ``multiple`` rows, then (W, R)."""
    import torch

    pad = (-k32.numel()) % multiple
    if pad:
        k32 = torch.cat([k32, k32.new_full((pad,), -1)])
        vals = torch.cat([vals, vals.new_zeros(pad)])
    return k32.reshape(w, -1).contiguous(), vals.reshape(w, -1).contiguous()


def check_preagg(got, want, kw, vw, kind, capacity, label):
    """The pre-aggregation kernel vs its plain version: table keys, spill
    mask and cnts equal; COUNT / MIN / MAX vals exact; SUM within
    SUM_RTOL · Σ|v| of the rows each slot folded.  Returns the largest
    |Δ| of any slot."""
    import torch

    from repro_torch.core.hashing import slot_hash

    for what, a, b in zip(("table keys", "cnts", "spill mask"), got[:1] + got[2:],
                          want[:1] + want[2:]):
        check(torch.equal(a, b), f"{label}: {what} differ in {int((a != b).sum())} places")
    d = (got[1] - want[1]).abs()
    d = torch.where(torch.isinf(want[1]) & (got[1] == want[1]), torch.zeros_like(d), d)
    err = float(d.max())
    if kind != "sum":
        check(torch.equal(got[1], want[1]), f"{label}: {kind.upper()} differs")
        return err
    fold = (kw != -1) & ~want[3]
    w = torch.arange(kw.shape[0], device=kw.device)[:, None].expand_as(kw)
    absum = torch.zeros(kw.shape[0] * capacity, dtype=torch.float64, device=kw.device)
    absum.index_add_(0, (w * capacity + slot_hash(kw, capacity))[fold], vw[fold].double().abs())
    check(bool((d.reshape(-1).double() <= SUM_RTOL * absum + 1e-6).all()),
          f"{label}: SUM outside {SUM_RTOL}·Σ|v|")
    return err


def phase2_preagg(pa, gen, device, n=1 << 20):
    """The pre-aggregation kernel vs its plain version on 2^20 rows of the
    uniform-1000, zipf, unique and heavy-hitter classes (keys spread over
    all 32 bits, 1% EMPTY rows), W = 8 and 132 workers × C = 1024 and 64 ×
    morsel None and 1024, and W = 131 (R = 8005, odd), one kind each in
    turn (every kind at least twice a class).  Prints each class's spilled share of
    the live rows; unique at W = 8, C = 1024 must spill at least 99%.
    Returns the largest |Δ| of any slot."""
    import torch

    classes = {"uniform": gen_keys(n, "low", "uniform", gen, device),
               "zipf": gen_keys(n, "high", "zipf", gen, device),
               "unique": gen_keys(n, "unique", "uniform", gen, device),
               "heavy": gen_keys(n, "low", "heavy", gen, device)}
    vals = torch.randn(n, generator=gen, device=device)
    vals[::97] = -0.0
    err = 0.0
    # (workers, C, morsel, rows padded to a multiple of)
    configs = [(w, c, m, w * 1024) for w in (8, 132) for c in (PA_C, 64) for m in (None, 1024)]
    configs.append((131, PA_C, None, 131))  # R = 8005: worker bases off 16 bytes
    for name, keys in classes.items():
        k32 = to_i32(keys * 0x9E3779B1)
        k32[torch.rand(n, generator=gen, device=device) < 0.01] = -1
        live = int((k32 != -1).sum())
        for i, (w, c, morsel, multiple) in enumerate(configs):
            # each configuration one kind, in turn: every kind twice a class
            kind = PA_KINDS[i % len(PA_KINDS)]
            kw, vw = preagg_layout(k32, vals, w, multiple)
            label = f"phase2 preagg {name} W={w} C={c} morsel={morsel} {kind}"
            got = pa.preagg(kw, vw, kind=kind, capacity=c, morsel=morsel)
            want = pa.preagg_plain(kw, vw, kind=kind, capacity=c, morsel=morsel)
            sync(device)
            err = max(err, check_preagg(got, want, kw, vw, kind, c, label))
            share = int(got[3].sum()) / live
            log(f"{label}: spilled {share:.4f} of {live} live rows; keys, spill, cnts "
                f"equal, {'SUM within tolerance' if kind == 'sum' else kind.upper() + ' exact'} ok")
            if name == "unique" and w == 8 and c == PA_C:
                check(share >= 0.99, f"phase2 preagg unique: spilled {share:.4f} < 0.99 "
                      f"at W=8, C={PA_C}")
    return err


# -- phase 3: the main path -----------------------------------------------------


AGGS_SPEC = (("count", None), ("sum", "v"), ("mean", "v"), ("max", "v"))


def reset_launches(kmods) -> None:
    for mod, fn in kmods.values():
        getattr(mod, fn).launches = 0


def read_launches(kmods) -> dict:
    return {name: getattr(mod, fn).launches for name, (mod, fn) in kmods.items()}


SCAN_KERNELS = (None, "off", "scan_body")


def stream_path(kernel, update, pipeline):
    """The kernels a stream must launch (each at least once)."""
    if kernel == "fused":
        return ("fused_groupby",)
    if kernel == "split":
        return ("ticket_hash", "segment_agg")
    path = () if pipeline == "host" else ("scan_ticket",)
    if kernel == "scan_body":
        path += ("segment_agg",)
    elif update == "serialized":
        path += ("segment_agg_serialized",)
    return path


def executor_path(ex):
    """The kernels the executor's route launches (each at least once): a
    resolved or escalated plan is read off the executor that ran it."""
    name = type(ex).__name__
    if name == "_ResolvingExecutor":
        return executor_path(ex._inner)
    if name == "_PartitionedExecutor":
        return ("preagg",)
    if name == "_SortExecutor":
        return ("segment_agg",) if ex._plan.execution.kernel == "scan_body" else ()
    if name == "SpillExecutor":
        return ("scan_ticket",) + (("segment_agg",) if ex._op.use_kernel else ())
    if name == "_HybridExecutor":
        return ("hybrid_registers", "scan_ticket") + (
            ("segment_agg",) if ex._op.use_kernel else ())
    if name == "_ShardedExecutor":
        return ("scan_ticket", "segment_agg") + (
            ("ticket_hash",) if ex._plan.execution.shard_merge == "dense_psum" else ())
    if name == "_DirectExecutor":
        return ("segment_agg",) if ex._plan.execution.kernel == "scan_body" else ()
    e = ex._plan.execution
    return stream_path(e.kernel, e.update, e.pipeline)


def run_stream(kmods, api, name, keys, vals, *, max_groups=None, saturation=None,
               programs=1, kernel="fused", update=None, chunks=8, pipeline="scan",
               plan=None, hashed=False, probe=None, strategy="concurrent",
               aggs_spec=AGGS_SPEC, keep=False, **execution):
    """One stream of the main path through the plan API, held to the
    oracle.  ``plan`` replaces the plan built from the keyword arguments
    (``strategy``, ``aggs_spec`` and ``execution``, the extra
    ExecutionPolicy fields; the default-plan streams); ``hashed``: the
    plan hashes the key column, so the oracle groups the hashed keys;
    ``probe(handle)`` runs after the first two chunks; ``keep`` keeps the
    result table under ``"_out"``.  The launch counts are set to 0 just
    before the stream and read just after; the host-side merge of the
    split and partitioned routes is timed apart from the chunk pipeline
    (synchronized on both sides, so those times include the device work
    they wait for), and so are the spill executor's routing and
    finalize."""
    import torch

    from repro_torch.core.hashing import table_capacity
    from repro_torch.engine import spill as tsp

    device = keys.device
    aggs = tuple(api.AggSpec(k, c) for k, c in aggs_spec)
    default_plan = plan is not None
    if plan is None:
        plan = api.GroupByPlan(
            keys=("k",), aggs=aggs, strategy=strategy, max_groups=max_groups,
            saturation=saturation, raw_keys=True,
            execution=api.ExecutionPolicy(kernel=kernel, morsel_size=M,
                                          kernel_programs=programs, instrument=True,
                                          update=update, device=device.type,
                                          pipeline=pipeline, **execution),
        )
    n = keys.shape[0]
    step = n // chunks

    def source():
        for lo in range(0, n, step):
            yield api.Table({"k": keys[lo:lo + step], "v": vals[lo:lo + step]})

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    merge = {"s": 0.0, "calls": 0, "chunk_s": 0.0}
    reset_launches(kmods)
    t0 = time.perf_counter()
    handle = plan.stream(source())
    ex = handle.executor

    def synced(fn, key, count=None, table=merge, wait_after=True):
        def run(*a):
            sync(device)
            m0 = time.perf_counter()
            r = fn(*a)
            if wait_after:
                sync(device)
            table[key] += time.perf_counter() - m0
            if count:
                table[count] += 1
            return r
        return run

    if hasattr(ex, "_merge"):
        ex._merge = synced(ex._merge, "s", "calls")
        ex._chunk_partial = synced(ex._chunk_partial, "chunk_s")
    if hasattr(ex, "_merged"):  # the fused route's second-level merge
        ex._merged = synced(ex._merged, "s", "calls")
    carried_cap = ex._table.capacity if hasattr(ex, "_merge") else None
    # the spill executor's host routing (consume_async: the lookup's one
    # blocking read, admission, partitioning, staging; not synchronized at
    # its end, so the hot operator's launches are not counted) and finalize
    spill_host = {"route_s": 0.0, "admit_s": 0.0, "finalize_s": 0.0, "finalizes": 0}
    spill_methods = {m: getattr(tsp.SpillExecutor, m)
                     for m in ("consume_async", "_admit", "finalize")}
    tsp.SpillExecutor.consume_async = lambda se, c: synced(
        lambda: spill_methods["consume_async"](se, c), "route_s", table=spill_host,
        wait_after=False)()
    tsp.SpillExecutor._admit = lambda se, *a: synced(
        lambda: spill_methods["_admit"](se, *a), "admit_s", table=spill_host,
        wait_after=False)()
    tsp.SpillExecutor.finalize = lambda se: synced(
        lambda: spill_methods["finalize"](se), "finalize_s", "finalizes",
        table=spill_host)()
    host = {"observe_s": 0.0, "grow_s": 0.0, "grows": 0}
    # the resolver's per-chunk sample and statistics, and the host-side
    # grows (bound and migration: the operator's, the fused state's, the
    # split and partitioned routes' carried table), each synchronized on
    # both sides: all already wait for the device (the sample's read, the
    # count's read)
    from repro_torch.engine.groupby import GroupByOperator

    def timed(hook, key, count=None):
        def run(*a):
            sync(device)
            h0 = time.perf_counter()
            r = hook(*a)
            sync(device)
            host[key] += time.perf_counter() - h0
            if count:
                host[count] += 1
            return r
        return run

    if hasattr(ex, "_observe"):
        ex._observe = timed(ex._observe, "observe_s")
    for grow_hook in ("_grow_state", "_grow_carried"):
        if hasattr(ex, grow_hook):
            setattr(ex, grow_hook, timed(getattr(ex, grow_hook), "grow_s", "grows"))
    grow = restore = GroupByOperator._grow
    GroupByOperator._grow = lambda op, m: timed(lambda: grow(op, m), "grow_s", "grows")()
    try:
        if probe is not None:
            handle.pump(2)
            probe(handle)
        out = handle.result()
    finally:
        GroupByOperator._grow = restore
        for m, fn in spill_methods.items():
            setattr(tsp.SpillExecutor, m, fn)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    dev = handle.stats()["device"]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    if hashed:
        from repro_torch.engine.columns import combine_keys

        keys = combine_keys(keys).to(torch.int64) & 0xFFFFFFFF
    o = oracle(keys, vals)
    g = o["keys"].numel()
    ng = int(out["__num_groups__"][0])
    rows = torch.arange(ng, device=device)
    if type(getattr(ex, "_inner", ex)).__name__ == "_DirectExecutor":
        # direct ticketing's groups are its whole domain: keys that no row
        # holds come back with count 0
        inner = getattr(ex, "_inner", ex)
        check(ng == min(inner._domain, inner._bound), f"{name}: {ng} groups for domain "
              f"{inner._domain}")
        rows = rows[out["count(*)"][:ng] > 0]
    check(rows.numel() == g, f"{name}: {rows.numel()} groups, oracle {g}")
    rk = out["key"][rows]
    order = rows[torch.argsort(rk)]
    check(torch.equal(out["key"][order], o["keys"]), f"{name}: key set differs from the oracle")
    err_sum = check_against_oracle(out, order, o, name)
    path = executor_path(ex)
    for k in path:
        check(launches[k] > 0, f"{name}: the {k} kernel was never launched")
    for k in set(kmods) - set(path) - table_ops_of(ex):
        check(launches[k] == 0, f"{name}: the {k} kernel ran on the {kernel} route")
    rec = {
        "stream": name, "kernel": kernel, "update": update, "pipeline": pipeline,
        "rows": n, "chunks": chunks,
        "groups": g, "max_groups": max_groups, "saturation": saturation,
        "programs": programs, "wall_s": wall, "rows_per_s": n / wall,
        "max_memory_allocated": peak, "launches": launches,
        "table_ops": {k: launches[k] for k in TABLE_OPS},
        "max_sum_err_over_abs": err_sum, "aggs": [a.name for a in plan.aggs],
        "grow_s": host["grow_s"], "grows": host["grows"],
    }
    inner = getattr(ex, "_inner", ex)
    iname = type(inner).__name__
    if default_plan:
        inner = getattr(ex, "_inner", ex)
        res = getattr(ex, "_resolved", plan)
        rec.update(strategy=plan.strategy, resolved_strategy=res.strategy,
                   kernel=res.execution.kernel, update=res.execution.update,
                   ticketing=res.execution.ticketing, max_groups=res.max_groups,
                   saturation=res.saturation, executor=type(inner).__name__,
                   escalated=bool(getattr(ex, "_escalated", False)),
                   pauses=dev.get("pauses"), bound_grows=dev.get("bound_grows"),
                   migrations=dev.get("migrations"), table_capacity=dev.get("table_capacity"),
                   observe_s=host["observe_s"])
        if type(inner).__name__ == "_HybridExecutor":
            rec["heavy_keys"] = int((inner._heavy != -1).sum())
        if type(inner).__name__ == "_DirectExecutor":
            rec.update(domain=inner._domain, final_bound=inner._bound)
    elif kernel == "fused":
        fk = kmods["fused_groupby"][0]
        rec.update(migrations=dev["migrations"], bound_grows=dev["bound_grows"],
                   table_capacity=dev["table_capacity"], pauses=dev["pauses"],
                   grid=list(fk.fused_consume.grid), merge_s=merge["s"])
        check(programs > 1 or fk.fused_consume.grid[1] > 1, f"{name}: one CTA per program")
        if saturation == "raise":
            # a RAISE stream whose groups fit its bound never halts: one
            # launch per chunk, no replay
            check(launches["fused_groupby"] == chunks and dev["pauses"] == 0,
                  f"{name}: a RAISE stream paused ({launches['fused_groupby']} launches "
                  f"for {chunks} chunks, {dev['pauses']} pauses)")
    elif iname == "_PartitionedExecutor":
        rec.update(strategy="partitioned", kernel=None, preagg_exchange_final_s=merge["chunk_s"],
                   merge_s=merge["s"], merges=merge["calls"], reruns=inner.reruns,
                   chunk_bound=inner._chunk_bound, carried_bound=inner._max_groups,
                   table_capacity=inner._table.capacity)
        # one pre-aggregation launch per chunk, and one per rerun
        check(launches["preagg"] == chunks + inner.reruns,
              f"{name}: {launches['preagg']} preagg launches for {chunks} chunks and "
              f"{inner.reruns} reruns")
    elif iname == "_SortExecutor":
        rec.update(ticketing="sort", peak_buffered_chunks=handle.peak_buffered_chunks)
        check(handle.peak_buffered_chunks == chunks,
              f"{name}: peak_buffered_chunks {handle.peak_buffered_chunks}, not {chunks}")
    elif iname == "SpillExecutor":
        spill = handle.stats()["spill"]
        op = inner._op
        rec.update(saturation="spill", spill=spill, device_groups=inner._host_count,
                   hot_capacity=op._table.capacity, hot_migrations=op.migrations,
                   **spill_host)
        check(spill["peak_device_table_bytes"] <= 2 * spill["residency_bytes"],
              f"{name}: peak device table bytes {spill['peak_device_table_bytes']} > 2 x "
              f"residency {spill['residency_bytes']}")
        check(op.migrations == 0
              and op._table.capacity == table_capacity(spill["residency_budget"]),
              f"{name}: the hot table migrated ({op.migrations} migrations, capacity "
              f"{op._table.capacity})")
        check(inner._host_count <= spill["residency_budget"],
              f"{name}: {inner._host_count} device groups past the budget")
        if default_plan or strategy == "auto":
            rec.update(resolved_strategy=ex._resolved.strategy,
                       kernel=ex._resolved.execution.kernel,
                       max_groups=ex._resolved.max_groups)
    elif kernel in SCAN_KERNELS:
        planes = len(ex._op._state.specs)
        rec.update(migrations=dev["migrations"], bound_grows=dev["bound_grows"],
                   table_capacity=dev["table_capacity"], pauses=dev["pauses"],
                   planes=planes, grid=list(kmods["scan_ticket"][0].scan_ticket.grid or ()))
        if saturation == "raise" and pipeline == "scan":
            # no pause: one ticket launch per chunk, one update per plane
            check(launches["scan_ticket"] == chunks and dev["pauses"] == 0,
                  f"{name}: {launches['scan_ticket']} ticket launches for {chunks} chunks, "
                  f"{dev['pauses']} pauses")
            if kernel == "scan_body":
                check(launches["segment_agg"] == planes * chunks,
                      f"{name}: {launches['segment_agg']} segment launches for {planes} "
                      f"planes x {chunks} chunks")
    else:
        rec.update(merge_s=merge["s"], merges=merge["calls"], relaunches=ex.relaunches,
                   bound_grows=ex.bound_grows, capacity_grows=ex.capacity_grows,
                   chunk_bound=ex._chunk_bound, chunk_capacity=ex._capacity,
                   carried_bound=ex._max_groups,
                   table_capacity=ex._table.capacity)
    hold_table_ops(name, iname, rec, launches, programs, merge["calls"],
                   carried_cap is not None and ex._table.capacity > carried_cap)
    log("phase3 " + json.dumps(rec))
    if keep:
        rec["_out"] = out
    return rec


TABLE_OPS = ("table_get_or_insert", "table_lookup", "table_migrate")


def table_ops_of(ex):
    """The table ops an executor may launch: its merges and hybrid
    adoption (``get_or_insert``), its lookups (hybrid finalize, spill
    routing) and its migrations (``migrate``, every grow)."""
    name = type(ex).__name__
    if name == "_ResolvingExecutor":  # may escalate to hybrid
        return table_ops_of(ex._inner) | set(TABLE_OPS)
    if name in ("_PallasExecutor", "_PartitionedExecutor", "_FusedExecutor"):
        return {"table_get_or_insert", "table_migrate"}
    if name == "_ScanExecutor":
        return {"table_migrate"} | (
            {"table_get_or_insert"} if ex._plan.execution.pipeline == "host" else set())
    if name == "_HybridExecutor":
        return set(TABLE_OPS)
    if name == "SpillExecutor":
        return {"table_lookup", "table_migrate"}
    if name == "_ShardedExecutor":
        return {"table_migrate"}
    return set()


def hold_table_ops(name, iname, rec, launches, programs, merges, carried_grew):
    """Each table op a stream's executor reached ran as its kernel: a
    merge (split, partitioned, fused at P > 1), a migration, a hybrid's
    adoption and finalize, a spill's routing."""
    must = set()
    if merges and (iname != "_FusedExecutor" or programs > 1):
        must.add("table_get_or_insert")
    if (rec.get("migrations") or 0) > 0 or carried_grew:
        must.add("table_migrate")
    if iname == "_HybridExecutor":
        must |= {"table_get_or_insert", "table_lookup"}
    if iname == "SpillExecutor":
        must.add("table_lookup")
    for k in must:
        check(launches[k] > 0, f"{name}: the {k} kernel was never launched")


def check_against_oracle(out, order, o, name):
    """Every aggregate column of ``out`` (rows in ``order``, sorted by key)
    against the oracle: COUNT and MAX exact, SUM within SUM_RTOL · Σ|v|,
    MEAN within that over the count.  Returns the largest SUM error over
    Σ|v| (None without a SUM column)."""
    import torch

    cols = out.columns
    if "count(*)" in cols:
        check(torch.equal(out["count(*)"][order].double(), o["count"].double()),
              f"{name}: COUNT not exact")
    if "max(v)" in cols:
        check(torch.equal(out["max(v)"][order], o["max"]), f"{name}: MAX not exact")
    tol = SUM_RTOL * o["abs"]
    err = None
    if "sum(v)" in cols:
        d_sum = (out["sum(v)"][order].double() - o["sum"]).abs()
        check(bool((d_sum <= tol).all()), f"{name}: SUM outside {SUM_RTOL}·Σ|v|")
        err = float((d_sum / o["abs"].clamp_min(1e-30)).max())
    if "mean(v)" in cols:
        c64 = o["count"].double()
        d_mean = (out["mean(v)"][order].double() - o["sum"] / c64).abs()
        check(bool((d_mean <= tol / c64).all()), f"{name}: MEAN outside tolerance")
    return err


def phase3(kmods, api, gen, device, n=1 << 24):
    import torch

    vals = torch.randn(n, generator=gen, device=device)
    recs = []
    low = gen_keys(n, "low", "uniform", gen, device)
    high = gen_keys(n, "high", "zipf", gen, device)
    for kernel, prefix in (("fused", ""), ("split", "split_")):
        recs.append(run_stream(kmods, api, prefix + "low", low, vals, max_groups=1024,
                               saturation="raise", kernel=kernel))
        recs.append(run_stream(kmods, api, prefix + "high", high, vals, max_groups=n // 10,
                               saturation="raise", kernel=kernel))
    del high
    uniq = gen_keys(n, "unique", "uniform", gen, device)
    for kernel, prefix in (("fused", ""), ("split", "split_")):
        recs.append(run_stream(kmods, api, prefix + "unique", uniq, vals, max_groups=n,
                               saturation="raise", kernel=kernel))
    del uniq
    # zipf high keys hold ~1.4e4 groups at this N, under 2^16: the grow
    # streams take the high class's key domain uniformly (~1.68e6 groups)
    high_u = gen_keys(n, "high", "uniform", gen, device)
    for kernel, prefix in (("fused", ""), ("split", "split_")):
        rec = run_stream(kmods, api, prefix + "high_grow", high_u, vals,
                         max_groups=n >> 8, saturation="grow", kernel=kernel)  # 2^16
        check(rec["bound_grows"] >= 1, f"{rec['stream']}: expected a bound grow")
        recs.append(rec)
    check(recs[-2]["bound_grows"] >= 2, "high_grow: expected several bound grows")
    # per-morsel commit flags: a pause with room left relaunches without a
    # grow, so racing CTAs add no growth over the sequential rule's
    check(recs[-2]["bound_grows"] <= 3 and recs[-2]["migrations"] <= 3,
          f"high_grow: {recs[-2]['bound_grows']} bound grows, "
          f"{recs[-2]['migrations']} migrations (3 and 3 with one CTA per program)")
    del high_u
    recs.append(run_stream(kmods, api, "low_p132", low, vals, max_groups=1024,
                           saturation="raise", programs=132))
    recs.append(run_stream(kmods, api, "split_low_onehot", low, vals, max_groups=1024,
                           saturation="raise", kernel="split", update="onehot"))
    recs += phase3_scan(kmods, api, gen, device, low, vals, n)
    recs += phase3_default(kmods, api, gen, device, low, vals, n, recs)
    recs += phase3_more(kmods, api, gen, device, low, vals, n, recs)
    return recs


def same_map(out, ref, o, name):
    """Two result tables hold the same map: the same keys, COUNT and MAX
    equal, SUM and MEAN within SUM_RTOL · Σ|v| (the oracle's) of each
    other."""
    import torch

    def rows(t):
        n = int(t["__num_groups__"][0])
        return torch.argsort(t["key"][:n])

    a, b = rows(out), rows(ref)
    check(torch.equal(out["key"][a], ref["key"][b]), f"{name}: key set differs")
    for col in ("count(*)", "max(v)"):
        if col in out.columns:
            check(torch.equal(out[col][a], ref[col][b]), f"{name}: {col} differs")
    tol = SUM_RTOL * o["abs"]
    for col, scale in (("sum(v)", 1.0), ("mean(v)", o["count"].double())):
        if col not in out.columns:
            continue
        d = (out[col][a].double() - ref[col][b].double()).abs()
        check(bool((d <= tol / scale).all()), f"{name}: {col} outside tolerance")


def phase3_more(kmods, api, gen, device, low, vals, n, recs):
    """The plans of the last single-device slice.  Partitioned
    (``strategy="partitioned"``: the preagg kernel per chunk, one
    aggregate): part_low (count(*)), part_low_sum, part_high and
    part_unique (sum(v), the class's bound, RAISE) and part_high_grow
    (uniform over N / 10 keys from a bound of 2^16, GROW: chunk reruns).
    Sort ticketing (one-shot, scan_body updates): sort_low, sort_high,
    sort_unique.  Spill (``saturation="spill"``, scan_body): spill_low (a
    budget of 2048 over 1000 keys: nothing spills, the map equals
    scan_low's), spill_high (4096 over ~1.4e4 groups), spill_unique (2^20
    over 2^24 keys), spill_auto_high (strategy auto)."""
    import torch

    out = []
    sum_v = (("sum", "v"),)
    part = dict(strategy="partitioned", kernel=None)
    out.append(run_stream(kmods, api, "part_low", low, vals, max_groups=1024,
                          saturation="raise", aggs_spec=(("count", None),), **part))
    out.append(run_stream(kmods, api, "part_low_sum", low, vals, max_groups=1024,
                          saturation="raise", aggs_spec=sum_v, **part))
    out.append(run_stream(kmods, api, "sort_low", low, vals, max_groups=1024,
                          saturation="raise", kernel="scan_body", ticketing="sort"))
    rec = run_stream(kmods, api, "spill_low", low, vals, max_groups=2048, saturation="spill",
                     kernel="scan_body", keep=True)
    check(rec["spill"]["spilled_rows"] == 0, f"spill_low: {rec['spill']['spilled_rows']} "
          "rows spilled under a budget above the key count")
    scan_low = next(r for r in recs if r["stream"] == "scan_low")
    same_map(rec.pop("_out"), scan_low.pop("_out"), oracle(low, vals), "spill_low vs scan_low")
    log("phase3 spill_low: no row spilled; the map equals scan_low's ok")
    out.append(rec)
    high = gen_keys(n, "high", "zipf", gen, device)
    out.append(run_stream(kmods, api, "part_high", high, vals, max_groups=n // 10,
                          saturation="raise", aggs_spec=sum_v, **part))
    out.append(run_stream(kmods, api, "sort_high", high, vals, max_groups=n // 10,
                          saturation="raise", kernel="scan_body", ticketing="sort"))
    out.append(run_stream(kmods, api, "spill_high", high, vals, max_groups=4096,
                          saturation="spill", kernel="scan_body"))
    # the planner's budget (a few hundred groups from the first chunk's
    # sample) is far below the default 32 partitions' share of ~1.4e4
    # groups; 128 partitions keep each partition's cardinality within the
    # budget, the premise of the ≤ 2x residency invariant
    out.append(run_stream(kmods, api, "spill_auto_high", high, vals, saturation="spill",
                          strategy="auto", kernel=None, spill_partitions=128))
    check(out[-1]["kernel"] == "scan_body", f"spill_auto_high: resolved kernel "
          f"{out[-1]['kernel']}, not scan_body")
    del high
    uniq = gen_keys(n, "unique", "uniform", gen, device)
    out.append(run_stream(kmods, api, "part_unique", uniq, vals, max_groups=n,
                          saturation="raise", aggs_spec=sum_v, **part))
    out.append(run_stream(kmods, api, "sort_unique", uniq, vals, max_groups=n,
                          saturation="raise", kernel="scan_body", ticketing="sort"))
    out.append(run_stream(kmods, api, "spill_unique", uniq, vals, max_groups=1 << 20,
                          saturation="spill", kernel="scan_body"))
    del uniq
    high_u = gen_keys(n, "high", "uniform", gen, device)
    rec = run_stream(kmods, api, "part_high_grow", high_u, vals, max_groups=1 << 16,
                     saturation="grow", aggs_spec=sum_v, **part)
    check(rec["reruns"] >= 1, "part_high_grow: expected a chunk rerun")
    out.append(rec)
    del high_u
    for r in out:
        if r["stream"].startswith("part_"):
            log(f"phase3 {r['stream']}: wall {r['wall_s']:.4f} s = preagg + exchange + final "
                f"sort {r['preagg_exchange_final_s']:.4f} s and host merge {r['merge_s']:.4f} s "
                f"({r['merges']} merges, {r['reruns']} reruns)")
        elif r["stream"].startswith("spill_"):
            log(f"phase3 {r['stream']}: wall {r['wall_s']:.4f} s; host routing "
                f"{r['route_s']:.4f} s (admission {r['admit_s']:.4f} s), finalize "
                f"{r['finalize_s']:.4f} s; stats()['spill'] {json.dumps(r['spill'])}")
    return out


def phase3_scan(kmods, api, gen, device, low, vals, n):
    """The scan route's streams (kernel "off" and "scan_body")."""
    recs = []
    for kernel, prefix in (("off", "scan_"), ("scan_body", "body_")):
        recs.append(run_stream(kmods, api, prefix + "low", low, vals, max_groups=1024,
                               saturation="raise", kernel=kernel, keep=prefix == "scan_"))
    recs.append(run_stream(kmods, api, "scan_low_onehot", low, vals, max_groups=1024,
                           saturation="raise", kernel="off", update="onehot"))
    recs.append(run_stream(kmods, api, "scan_low_unchecked", low, vals, max_groups=1024,
                           saturation="unchecked", kernel="off"))
    small = 1 << 16
    recs.append(run_stream(kmods, api, "body_low_host", low[:small], vals[:small],
                           max_groups=1024, saturation="raise", kernel="scan_body",
                           pipeline="host"))
    recs.append(run_stream(kmods, api, "scan_low_serialized", low[:small], vals[:small],
                           max_groups=1024, saturation="raise", kernel="off",
                           update="serialized"))
    high = gen_keys(n, "high", "zipf", gen, device)
    for kernel, prefix in (("off", "scan_"), ("scan_body", "body_")):
        recs.append(run_stream(kmods, api, prefix + "high", high, vals, max_groups=n // 10,
                               saturation="raise", kernel=kernel))
    recs.append(run_stream(kmods, api, "scan_high_sort", high, vals, max_groups=n // 10,
                           saturation="raise", kernel="off", update="sort_segment"))
    # the register fold on many heavy keys (8 registers take ≈88% of the
    # rows) beside body_high, with no grow in the wall
    rec = run_stream(kmods, api, "hybrid_high", high, vals, max_groups=n // 10,
                     saturation="raise", kernel="scan_body", strategy="hybrid")
    check(rec["launches"]["hybrid_registers"] == rec["chunks"],
          f"hybrid_high: {rec['launches']['hybrid_registers']} register launches for "
          f"{rec['chunks']} chunks")
    recs.append(rec)
    del high
    uniq = gen_keys(n, "unique", "uniform", gen, device)
    for kernel, prefix in (("off", "scan_"), ("scan_body", "body_")):
        recs.append(run_stream(kmods, api, prefix + "unique", uniq, vals, max_groups=n,
                               saturation="raise", kernel=kernel))
    del uniq
    high_u = gen_keys(n, "high", "uniform", gen, device)
    rec = run_stream(kmods, api, "scan_high_grow", high_u, vals, max_groups=n >> 8,
                     saturation="grow", kernel="off")
    check(rec["bound_grows"] >= 2, f"scan_high_grow: {rec['bound_grows']} bound grows")
    recs.append(rec)
    return recs


# name, queries, rows a query, chunk rows, key cardinality, max_groups,
# saturation, aggregates, morsel rows
SERVE_STREAMS = (
    ("serve_small", 8, 16 * 128, 128, 128, 256, "unchecked", (("sum", "v"), ("count", None)),
     128),
    ("serve_low", 16, 1 << 20, 1 << 16, 1000, 1024, "raise", AGGS_SPEC, 4096),
)


def phase3_serve(kmods, api, gen, device):
    """The serving layer: N concurrent queries through ``AggregationServer``
    (``serve/query_server.py``), each stream run three ways — batched
    (``batch_queries=True``: one ``scan_ticket_batched`` launch a round),
    solo (``batch_queries=False``) and N sequential ``plan.collect`` — with
    the launch counts set to 0 just before each and read just after, the
    wall on the host clock ending in a synchronize, and the peak device
    memory.  serve_small is bench_serve's shape (8 queries of 16 chunks ×
    128 rows, keys uniform over 128, max_groups 256, unchecked, morsel
    128); serve_low 16 queries of 2^20 rows in 16 chunks of 2^16 (uniform
    over 1000, max_groups 1024, raise, morsel 4096; 128 MiB of input on the
    card).  Every query is held to the oracle, and the batched and
    sequential results to each other as maps.  Both streams use the
    scatter update, so a batched round tickets and folds in its launch:
    it must make ⌈N / 32⌉ ``scan_ticket_batched`` launches, no
    ``scan_ticket`` launch and no ``GroupByOperator.update_planes`` call
    (counted in every mode).  Then serve_budget: a
    tenant with ``max_groups=64`` fails its own query with
    ``GroupByOverflowError`` while another tenant's completes."""
    import importlib

    import torch

    from repro_torch.engine.groupby import GroupByOverflowError
    from repro_torch.serve import AggregationServer

    gb = importlib.import_module("repro_torch.engine.groupby")
    real_update = gb.GroupByOperator.update_planes
    plane_updates = [0]

    def counted_update(self, *a, **kw):  # the update stage's calls outside the round's launch
        plane_updates[0] += 1
        return real_update(self, *a, **kw)

    def chunks(k, v, rows):
        return [api.Table({"k": k[i:i + rows], "v": v[i:i + rows]})
                for i in range(0, k.shape[0], rows)]

    def held(out, o, label):
        n = int(out["__num_groups__"][0])
        check(n == o["keys"].numel(), f"{label}: {n} groups, the oracle has {o['keys'].numel()}")
        order = torch.argsort(out["key"][:n])
        check(torch.equal(out["key"][:n][order], o["keys"]), f"{label}: key set differs")
        sub = api.Table({c: t[:n] for c, t in out.columns.items()})
        return check_against_oracle(sub, order, o, label)

    fk_lanes = kmods["scan_ticket_batched"][0].MAX_BATCH_LANES
    recs, data = [], None
    for name, nq, rows, chunk, card, bound, sat, spec, morsel in SERVE_STREAMS:
        data = [(torch.randint(0, card, (rows,), generator=gen, device=device,
                               dtype=torch.int32),
                 torch.randn(rows, generator=gen, device=device)) for _ in range(nq)]
        oracles = [oracle(k.long(), v) for k, v in data]
        plan = api.GroupByPlan(
            keys=("k",), aggs=tuple(api.AggSpec(a, c) for a, c in spec),
            strategy="concurrent", max_groups=bound, saturation=sat, raw_keys=True,
            execution=api.ExecutionPolicy(update="scatter", morsel_rows=morsel))
        results = {}
        for mode in ("batched", "solo", "sequential"):
            sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)  # the queries' input among it
            reset_launches(kmods)
            plane_updates[0] = 0
            gb.GroupByOperator.update_planes = counted_update
            t0 = time.perf_counter()
            try:
                if mode == "sequential":
                    outs = [plan.collect(chunks(k, v, chunk)) for k, v in data]
                else:
                    server = AggregationServer(slots=nq, batch_queries=mode == "batched")
                    handles = [server.submit(plan, chunks(k, v, chunk)) for k, v in data]
                    server.run_until_idle()
                    outs = [h.result() for h in handles]
                sync(device)
            finally:
                gb.GroupByOperator.update_planes = real_update
            wall = time.perf_counter() - t0
            launches = read_launches(kmods)
            errs = [held(out, o, f"{name}_{mode} query {q}")
                    for q, (out, o) in enumerate(zip(outs, oracles))]
            rec = {"stream": f"{name}_{mode}", "wall_s": wall, "queries": nq,
                   "rows": nq * rows, "chunk_rows": chunk, "launches": launches,
                   "peak_mib": torch.cuda.max_memory_allocated(device) / 2**20,
                   "peak_added_mib": (torch.cuda.max_memory_allocated(device) - base) / 2**20,
                   "update_planes_calls": plane_updates[0],
                   "max_sum_err": max(e for e in errs if e is not None)}
            log("phase3 " + json.dumps(rec))
            recs.append(rec)
            results[mode] = outs
        for q, (a, b, o) in enumerate(zip(results["batched"], results["sequential"], oracles)):
            same_map(a, b, o, f"{name} query {q}: batched vs sequential")
        b, s = recs[-3]["launches"], recs[-2]["launches"]
        check(b["scan_ticket_batched"] > 0 and b["scan_ticket"] < s["scan_ticket"]
              and s["scan_ticket_batched"] == 0,
              f"{name}: batched rounds launched {b['scan_ticket_batched']} batched and "
              f"{b['scan_ticket']} solo ticket kernels (solo stepping {s['scan_ticket']})")
        # scatter rounds fold in their launch: ceil(N / 32) launches a round
        # (every round batched, none pauses) and no update call
        rounds, per_round = rows // chunk, -(-nq // fk_lanes)
        ups = recs[-3]["update_planes_calls"]
        check(b["scan_ticket_batched"] == rounds * per_round and b["scan_ticket"] == 0
              and ups == 0,
              f"{name}: batched rounds made {b['scan_ticket_batched']} batched launches "
              f"({rounds} rounds x {per_round} expected), {b['scan_ticket']} solo ticket "
              f"launches and {ups} update_planes calls (0 expected)")
        log(f"phase3 {name}: walls batched {recs[-3]['wall_s']:.4f} s, solo "
            f"{recs[-2]['wall_s']:.4f} s, sequential {recs[-1]['wall_s']:.4f} s; "
            f"scan_ticket_batched {b['scan_ticket_batched']} ({rounds} rounds), update_planes "
            f"calls {ups} batched vs {recs[-2]['update_planes_calls']} solo, scan_ticket "
            f"{b['scan_ticket']} vs {s['scan_ticket']}; every query held to the oracle ok")

    # a tenant budget of 64 groups fails only that tenant's query
    k, v = data[0]
    plan = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("count"),), strategy="concurrent",
                           max_groups=1024, raw_keys=True)
    reset_launches(kmods)
    t0 = time.perf_counter()
    server = AggregationServer(slots=2)
    server.set_budget("small", max_groups=64)
    over = server.submit(plan, chunks(k, v, 1 << 16), tenant="small")
    fine = server.submit(plan, chunks(k, v, 1 << 16), tenant="other")
    server.run_until_idle()
    sync(device)
    check(over.status == "failed" and isinstance(over.error, GroupByOverflowError)
          and fine.status == "done", f"serve_budget: {over.status} ({over.error!r}), "
          f"{fine.status}")
    held(fine.result(), oracle(k.long(), v), "serve_budget other tenant")
    rec = {"stream": "serve_budget", "wall_s": time.perf_counter() - t0,
           "launches": read_launches(kmods)}
    log("phase3 " + json.dumps(rec) + "; the budgeted query failed with "
        "GroupByOverflowError, the other completed ok")
    recs.append(rec)
    return recs


def phase3_default(kmods, api, gen, device, low, vals, n, recs):
    """The default plan's streams: ``GroupByPlan(keys, aggs)`` with every
    default (strategy auto, max_groups None, saturation GROW; the key
    column hashed) on each class; the heavy-unique class under auto,
    ``strategy="hybrid"`` and scan_body; a stream whose heavy hitter
    appears at its third chunk (auto escalates to hybrid); direct
    ticketing over a declared domain of 1000 keys, then with a last chunk
    past it.  Each default-plan stream prints its resolved route beside
    the scan_body wall of its class."""
    import torch

    aggs = tuple(api.AggSpec(k, c) for k, c in AGGS_SPEC)
    walls = {r["stream"]: r["wall_s"] for r in recs}
    # every default but the event counters (pauses, grows) of stats()
    auto = api.GroupByPlan(keys=("k",), aggs=aggs,
                           execution=api.ExecutionPolicy(instrument=True))
    out = []

    def show(rec, beside):
        log(f"phase3 {rec['stream']}: resolved {rec['resolved_strategy']} "
            f"kernel={rec['kernel']} update={rec['update']} "
            f"max_groups={rec['max_groups']} -> {rec['executor']}"
            f"{' (escalated)' if rec['escalated'] else ''}; launches "
            f"{json.dumps(rec['launches'])}; observe {rec['observe_s']:.4f} s, "
            f"{rec['grows']} grow calls {rec['grow_s']:.4f} s; wall {rec['wall_s']:.4f} s beside "
            + ", ".join(f"{b} {walls[b]:.4f} s" for b in beside if b in walls))

    for cls, make in (("low", lambda: low),
                      ("high", lambda: gen_keys(n, "high", "zipf", gen, device)),
                      ("unique", lambda: gen_keys(n, "unique", "uniform", gen, device))):
        keys = make()
        # low runs twice: the first default-plan stream of the process pays
        # first-use costs (hashed keys' temporaries, allocator growth)
        for name in ["auto_" + cls] + (["auto_low_again"] if cls == "low" else []):
            rec = run_stream(kmods, api, name, keys, vals, plan=auto, hashed=True)
            check(rec["kernel"] == "scan_body" and rec["update"] == "scatter",
                  f"{name}: resolved kernel={rec['kernel']} update={rec['update']}, not "
                  "the CUDA route (scan_body, scatter)")
            show(rec, ["body_" + cls, "auto_low"])
            out.append(rec)
            walls[rec["stream"]] = rec["wall_s"]
        del keys
    hu = heavy_unique_keys(n, gen, device)
    rec = run_stream(kmods, api, "auto_heavy_unique", hu, vals, plan=auto, hashed=True)
    check(rec["executor"] == "_HybridExecutor",
          f"auto_heavy_unique: ended as {rec['executor']}, not _HybridExecutor")
    out.append(rec)
    hybrid = api.GroupByPlan(keys=("k",), aggs=aggs, strategy="hybrid", raw_keys=True,
                             execution=api.ExecutionPolicy(instrument=True))
    rec_h = run_stream(kmods, api, "hybrid_heavy_unique", hu, vals, plan=hybrid)
    check(rec_h["executor"] == "_HybridExecutor", "hybrid_heavy_unique: not hybrid")
    out.append(rec_h)
    rec_b = run_stream(kmods, api, "body_heavy_unique", hu, vals, max_groups=n,
                       saturation="raise", kernel="scan_body")
    out.append(rec_b)
    walls.update({r["stream"]: r["wall_s"] for r in out})
    show(rec, ["hybrid_heavy_unique", "body_heavy_unique"])
    show(rec_h, ["auto_heavy_unique", "body_heavy_unique"])
    del hu
    # uniform over 2^22 keys for two chunks, then half the rows on key 7
    step = n // 8
    esc = torch.randint(0, 1 << 22, (n,), generator=gen, device=device)
    hot = torch.rand(n, generator=gen, device=device) < 0.5
    hot[: 2 * step] = False
    esc = torch.where(hot, torch.full_like(esc, 7), esc)
    seen = {}

    def after_two(handle):
        seen["inner"] = type(handle.executor._inner).__name__

    rec = run_stream(kmods, api, "auto_escalate", esc, vals, plan=auto, hashed=True,
                     probe=after_two)
    rec["inner_after_2_chunks"] = seen["inner"]
    check(seen["inner"] == "_ScanExecutor",
          f"auto_escalate: {seen['inner']} after two chunks, not _ScanExecutor")
    check(rec["executor"] == "_HybridExecutor" and rec["escalated"],
          f"auto_escalate: ended as {rec['executor']}, not an escalated _HybridExecutor")
    show(rec, ["auto_high"])
    out.append(rec)
    del esc, hot
    direct = api.GroupByPlan(keys=("k",), aggs=aggs, strategy="concurrent", raw_keys=True,
                             execution=api.ExecutionPolicy(ticketing="direct", key_domain=1000,
                                                           instrument=True))
    rec = run_stream(kmods, api, "direct_low", low, vals, plan=direct)
    check(rec["executor"] == "_DirectExecutor" and rec["domain"] == 1000,
          f"direct_low: {rec['executor']} with domain {rec.get('domain')}")
    show(rec, ["body_low", "auto_low"])
    out.append(rec)
    past = low.clone()
    past[-step:] = torch.randint(0, 2000, (step,), generator=gen, device=device)
    rec = run_stream(kmods, api, "direct_low_grow", past, vals, plan=direct)
    want = int(past.max()) + 1
    check(rec["executor"] == "_DirectExecutor" and rec["domain"] == want,
          f"direct_low_grow: {rec['executor']} with domain {rec.get('domain')}, not {want}")
    show(rec, ["direct_low"])
    out.append(rec)
    return out


# -- phase 3 checkpoints: save mid-stream, restore, finish -----------------------

CKPT_AGGS = (("count", None), ("sum", "v"), ("min", "v"), ("max", "v"))
EXACT_SUM = float(1 << 24)      # f32 sums of integers are exact below 2^24


def hold_exact(out, o, name, *, domain=False):
    """A result table against the oracle ``o`` (integer-valued values):
    the same key set, COUNT / MIN / MAX exact, SUM exact wherever the
    group's sum stays below 2^24 and within SUM_RTOL · Σ|v| past it (the
    high class's hot key).  ``domain``: direct ticketing's rows cover its
    whole domain, keys no row holds with count 0."""
    import torch

    cols = {c: t.to(o["keys"].device) for c, t in out.columns.items()}  # a CPU result too
    ng = int(cols["__num_groups__"][0])
    rows = torch.arange(ng, device=o["keys"].device)
    if domain:
        rows = rows[cols["count(*)"][:ng] > 0]
    check(rows.numel() == o["keys"].numel(),
          f"{name}: {rows.numel()} groups, the oracle has {o['keys'].numel()}")
    order = rows[torch.argsort(cols["key"][rows])]
    check(torch.equal(cols["key"][order], o["keys"]), f"{name}: key set differs")
    if "count(*)" in cols:
        check(torch.equal(cols["count(*)"][order].long(), o["count"]), f"{name}: COUNT not exact")
    for col, want in (("min(v)", o["min"]), ("max(v)", o["max"])):
        if col in cols:
            check(torch.equal(cols[col][order], want), f"{name}: {col} not exact")
    got = cols["sum(v)"][order].double()
    small = o["sum"] < EXACT_SUM
    check(torch.equal(got[small], o["sum"][small]), f"{name}: SUM not exact below 2^24")
    check(bool(((got - o["sum"]).abs()[~small] <= SUM_RTOL * o["abs"][~small]).all()),
          f"{name}: SUM past 2^24 outside {SUM_RTOL}·Σ|v|")
    return int((~small).sum())


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def ckpt_stream(kmods, api, tel, ckpt, name, plan, keys, vals, root, *, chunks=8, snap=4,
                hashed=False):
    """One executor through a checkpoint: the whole stream collected from
    scratch; the same stream pumped ``snap`` chunks, saved (the device →
    host copy and the npz write timed apart), and finished; the commit
    restored into a fresh executor (read + import and the fast-forward
    timed apart) and finished.  All three results are held to the oracle
    and the restored one to the uninterrupted one; the restored executor
    must run the saved route (``executor_path`` equal at save and right
    after restore) and launch every kernel of its route, and no other,
    over the remaining chunks."""
    import shutil

    import torch

    n = keys.shape[0]
    step = n // chunks

    def source():
        return [api.Table({"k": keys[lo:lo + step], "v": vals[lo:lo + step]})
                for lo in range(0, n, step)]

    ok = keys
    if hashed:
        from repro_torch.engine.columns import combine_keys

        ok = combine_keys(keys).to(torch.int64) & 0xFFFFFFFF
    o = oracle(ok, vals)
    domain = name.startswith("direct")
    path = os.path.join(root, name)
    shutil.rmtree(path, ignore_errors=True)

    sync()
    t0 = time.perf_counter()
    straight = plan.collect(source())
    sync()
    collect_s = time.perf_counter() - t0
    hold_exact(straight, o, f"{name} uninterrupted", domain=domain)

    t = {"npz_write_s": 0.0, "fast_forward_s": 0.0}
    commit, forward = ckpt.commit_payload, tel.fast_forward

    def timed_commit(*a, **kw):
        c0 = time.perf_counter()
        r = commit(*a, **kw)
        t["npz_write_s"] += time.perf_counter() - c0
        return r

    def timed_forward(*a, **kw):
        f0 = time.perf_counter()
        r = forward(*a, **kw)
        sync()
        t["fast_forward_s"] += time.perf_counter() - f0
        return r

    h = plan.stream(source())
    h.pump(snap)
    saved_path = executor_path(h.executor)
    ckpt.commit_payload, tel.fast_forward = timed_commit, timed_forward
    try:
        sync()
        s0 = time.perf_counter()
        committed = h.save(path)
        save_s = time.perf_counter() - s0
        nbytes = _dir_bytes(committed)
        out_saved = h.result()
        sync()
        final_path = executor_path(h.executor)
        r0 = time.perf_counter()
        restored = plan.restore(path, source())
        sync()
        restore_s = time.perf_counter() - r0
    finally:
        ckpt.commit_payload, tel.fast_forward = commit, forward
    check(restored.chunks_consumed == snap, f"{name}: restored at chunk "
          f"{restored.chunks_consumed}, not {snap}")
    check(executor_path(restored.executor) == saved_path,
          f"{name}: restored route {executor_path(restored.executor)}, saved {saved_path}")
    reset_launches(kmods)
    f0 = time.perf_counter()
    out = restored.result()
    sync()
    finish_s = time.perf_counter() - f0
    launches = read_launches(kmods)
    after = executor_path(restored.executor)
    check(after == final_path, f"{name}: the restored stream ended on {after}, the saved "
          f"one on {final_path}")
    for k in after:
        check(launches[k] > 0, f"{name}: the {k} kernel was not launched after the restore")
    for k in set(kmods) - set(after) - table_ops_of(restored.executor):
        check(launches[k] == 0, f"{name}: the {k} kernel ran after the restore off its route")
    hold_exact(out_saved, o, f"{name} saved stream", domain=domain)
    big = hold_exact(out, o, f"{name} restored", domain=domain)
    if not domain:
        same_map(out, straight, o, f"{name}: restored vs uninterrupted")
    shutil.rmtree(path, ignore_errors=True)
    inner = getattr(restored.executor, "_inner", None) or restored.executor
    rec = {"stream": f"ckpt_{name}", "executor": type(inner).__name__,
           "route": list(saved_path), "final_route": list(after), "commit_bytes": nbytes,
           "save_s": save_s, "save_copy_s": save_s - t["npz_write_s"],
           "save_npz_write_s": t["npz_write_s"], "restore_s": restore_s,
           "restore_read_import_s": restore_s - t["fast_forward_s"],
           "restore_fast_forward_s": t["fast_forward_s"], "finish_s": finish_s,
           "collect_s": collect_s, "groups": int(o["keys"].numel()),
           "groups_sum_past_2^24": big, "launches": launches}
    log("phase3 " + json.dumps(rec))
    return rec


class FlakyChunks:
    """A re-iterable chunk source whose first pass raises ``WorkerFailure``
    at chunk ``fail_at`` (a lost worker, as the server sees it)."""

    def __init__(self, tables, fail_at, failure):
        self.tables, self.fail_at, self.failure = tables, fail_at, failure
        self.failed = False

    def chunks(self):
        for i, t in enumerate(self.tables):
            if i == self.fail_at and not self.failed:
                self.failed = True
                raise self.failure([0])
            yield t


def phase3_checkpoints(kmods, api, gen, device, n=1 << 24, small=1 << 20,
                       serve_rows=1 << 20):
    """Stream checkpoints on the card (``engine/elastic.py``): 2^24 rows in
    8 chunks, integer-valued values, each executor saved after 4 chunks,
    restored into a fresh executor and finished (``ckpt_stream``):
    body_low, body_unique (scan_body, raise), scan_high_grow (from 2^16,
    grow: restored after bound grows), auto_low and auto_escalate (the
    default plan; auto_escalate is saved on the scan route and escalates
    to hybrid after the restore, as the uninterrupted stream does),
    hybrid_high, direct_low, sort_low, split_low, part_low (sum(v)) and
    spill_high.  Then commits across devices at 2^20 rows (a card commit
    restored into a ``device="cpu"`` plan and a CPU commit onto the card,
    a scan_body and a default plan each), and the server's recovery:
    serve_low's 16 queries, solo, each checkpointed every 4 chunks and
    failing once at chunk 9, every one restored once and held to the
    oracle."""
    import shutil

    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.engine import elastic as tel

    root = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    vals = torch.randint(0, 100, (n,), generator=gen, device=device).float()
    aggs = tuple(api.AggSpec(k, c) for k, c in CKPT_AGGS)

    def plan(**kw):
        ex = kw.pop("execution", {})
        return api.GroupByPlan(keys=("k",), aggs=kw.pop("aggs", aggs), raw_keys=True,
                               execution=api.ExecutionPolicy(**ex), **kw)

    auto = api.GroupByPlan(keys=("k",), aggs=aggs)
    body = dict(strategy="concurrent", execution=dict(kernel="scan_body"))
    recs = []

    def run(name, p, keys, **kw):
        recs.append(ckpt_stream(kmods, api, tel, ckpt, name, p, keys, vals, root, **kw))

    low = gen_keys(n, "low", "uniform", gen, device)
    run("body_low", plan(max_groups=1024, saturation="raise", **body), low)
    run("auto_low", auto, low, hashed=True)
    run("direct_low", plan(strategy="concurrent",
                           execution=dict(ticketing="direct", key_domain=1000)), low)
    run("sort_low", plan(strategy="concurrent", max_groups=1024, saturation="raise",
                         execution=dict(kernel="scan_body", ticketing="sort")), low)
    run("split_low", plan(strategy="concurrent", max_groups=1024, saturation="raise",
                          execution=dict(kernel="split", morsel_size=M)), low)
    run("part_low", plan(strategy="partitioned", max_groups=1024, saturation="raise",
                         aggs=(api.AggSpec("sum", "v"),)), low)
    high = gen_keys(n, "high", "zipf", gen, device)
    run("hybrid_high", plan(strategy="hybrid", max_groups=n // 10, saturation="raise",
                            execution=dict(kernel="scan_body")), high)
    run("spill_high", plan(strategy="concurrent", max_groups=4096, saturation="spill",
                           execution=dict(kernel="scan_body")), high)
    del high
    high_u = gen_keys(n, "high", "uniform", gen, device)
    run("scan_high_grow", plan(strategy="concurrent", max_groups=n >> 8, saturation="grow",
                               execution=dict(kernel="off")), high_u)
    check(recs[-1]["launches"]["scan_ticket"] > 0, "scan_high_grow: no ticket launch")
    del high_u
    step = n // 8
    esc = torch.randint(0, 1 << 22, (n,), generator=gen, device=device)
    hot = torch.rand(n, generator=gen, device=device) < 0.5
    hot[: 2 * step] = False
    esc = torch.where(hot, torch.full_like(esc, 7), esc)
    del hot
    run("auto_escalate", auto, esc, hashed=True)
    check(recs[-1]["executor"] == "_HybridExecutor" and "hybrid_registers" in
          recs[-1]["final_route"], f"auto_escalate: ended as {recs[-1]['executor']} after "
          "the restore, not an escalated hybrid")
    del esc
    uniq = gen_keys(n, "unique", "uniform", gen, device)
    run("body_unique", plan(max_groups=n, saturation="raise", **body), uniq)
    del uniq
    sg = {r["stream"]: r for r in recs}
    check(sg["ckpt_scan_high_grow"]["groups"] > n >> 8, "scan_high_grow: no grow needed")
    recs += ckpt_devices(kmods, api, plan, aggs, root, low[:small], vals[:small])
    del low
    recs += ckpt_serve(kmods, api, gen, device, root, serve_rows)
    shutil.rmtree(root, ignore_errors=True)
    return recs


def ckpt_devices(kmods, api, plan, aggs, root, k_s, v_s):
    """Commits across devices: a scan_body plan and a default plan, each
    saved after 4 of 8 chunks on the card and restored into a
    ``device="cpu"`` plan (the plain versions: no launch), and saved on
    the CPU and restored onto the card (the route's kernels launch); every
    result held to the oracle."""
    import shutil

    import torch

    from repro_torch.engine.columns import combine_keys

    recs, small = [], k_s.shape[0]
    o = oracle(k_s, v_s)
    o_h = oracle(combine_keys(k_s).to(torch.int64) & 0xFFFFFFFF, v_s)
    for label, make, oo in (
            ("body", lambda dev: plan(max_groups=1024, saturation="raise", strategy="concurrent",
                                      execution=dict(kernel="scan_body", device=dev)), o),
            ("auto", lambda dev: api.GroupByPlan(keys=("k",), aggs=aggs,
                                                 execution=api.ExecutionPolicy(device=dev)),
             o_h)):
        for saver, loader in (("cuda", "cpu"), ("cpu", "cuda")):
            name = f"ckpt_{label}_{saver}_to_{loader}"

            def src(dev):
                step_s = small // 8
                return [api.Table({"k": k_s[i:i + step_s].to(dev), "v": v_s[i:i + step_s].to(dev)})
                        for i in range(0, small, step_s)]

            path = os.path.join(root, name)
            t0 = time.perf_counter()
            h = make(saver).stream(src(saver))
            h.pump(4)
            h.save(path)
            hold_exact(h.result(), oo, f"{name} saved stream")
            reset_launches(kmods)
            restored = make(loader).restore(path, src(loader))
            out = restored.result()
            sync()
            launches = read_launches(kmods)
            hold_exact(out, oo, f"{name} restored")
            ex = restored.executor
            inner = getattr(ex, "_inner", None) or ex
            table = inner._op._table
            check(table.keys.device.type == loader, f"{name}: restored on {table.keys.device}")
            if loader == "cuda":
                for k in executor_path(ex):
                    check(launches[k] > 0, f"{name}: the {k} kernel was not launched")
            else:
                check(sum(launches.values()) == 0, f"{name}: a kernel ran on the CPU restore")
            rec = {"stream": name, "executor": type(inner).__name__,
                   "resolved": (None if label == "body" else
                                [ex._resolved.execution.kernel, ex._resolved.execution.update]),
                   "wall_s": time.perf_counter() - t0, "launches": launches}
            log("phase3 " + json.dumps(rec))
            recs.append(rec)
            shutil.rmtree(path, ignore_errors=True)
    return recs


def ckpt_serve(kmods, api, gen, device, root, rows, nq=16):
    """The server's recovery: serve_low's 16 queries, solo
    (``batch_queries=False``), each checkpointed every 4 chunks and failing
    once at its tenth chunk (index 9), so each restores from its chunk-8
    commit; every query held to the oracle (SUM exact) with one restore."""
    import torch

    from repro_torch.serve import AggregationServer
    from repro_torch.train.elastic import WorkerFailure

    chunk = rows // 16
    data = [(torch.randint(0, 1000, (rows,), generator=gen, device=device, dtype=torch.int32),
             torch.randint(0, 100, (rows,), generator=gen, device=device).float())
            for _ in range(nq)]
    serve_plan = api.GroupByPlan(
        keys=("k",), aggs=tuple(api.AggSpec(a, c) for a, c in AGGS_SPEC),
        strategy="concurrent", max_groups=1024, saturation="raise", raw_keys=True,
        execution=api.ExecutionPolicy(update="scatter", morsel_rows=4096))
    sources = [FlakyChunks([api.Table({"k": k[i:i + chunk], "v": v[i:i + chunk]})
                            for i in range(0, rows, chunk)], 9, WorkerFailure)
               for k, v in data]
    reset_launches(kmods)
    sync()
    t0 = time.perf_counter()
    server = AggregationServer(slots=nq, batch_queries=False)
    handles = [server.submit(serve_plan, s, checkpoint_dir=os.path.join(root, f"serve_q{q}"),
                             checkpoint_every=4) for q, s in enumerate(sources)]
    server.run_until_idle()
    outs = [h.result() for h in handles]
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    for q, (out, h, s, (k, v)) in enumerate(zip(outs, handles, sources, data)):
        o = oracle(k.long(), v)
        n_q = int(out["__num_groups__"][0])
        sub = api.Table({c: t[:n_q] for c, t in out.columns.items()})
        check(n_q == o["keys"].numel(), f"serve_ckpt query {q}: {n_q} groups")
        order = torch.argsort(sub["key"])
        check(torch.equal(sub["key"][order], o["keys"]), f"serve_ckpt query {q}: key set")
        check(torch.equal(sub["sum(v)"][order].double(), o["sum"]),
              f"serve_ckpt query {q}: SUM not exact")
        check_against_oracle(sub, order, o, f"serve_ckpt query {q}")
        rec_q = h.profile()["recoveries"]
        check(s.failed and rec_q["restores"] == 1 and h.status == "done",
              f"serve_ckpt query {q}: {h.status}, recoveries {rec_q}")
    check(launches["scan_ticket"] > 0, "serve_ckpt: no scan_ticket launch")
    rec = {"stream": "serve_ckpt", "queries": nq, "rows": nq * rows, "wall_s": wall,
           "restores": sum(h.profile()["recoveries"]["restores"] for h in handles),
           "launches": launches}
    log("phase3 " + json.dumps(rec) + "; every query restored once and held to the oracle ok")
    return [rec]


# -- phase 3 sharded: one card as an 8-member mesh -------------------------------

SHARD_AGGS = (("sum", "v"), ("count", None), ("mean", "v"))
SHARD_PLANES = 3                # (v, sum), (None, count), (v, count)
SHARD_MEMBERS = 8
SHARD_OTHERS = ("fused_groupby", "scan_ticket_batched", "segment_agg_serialized",
                "hybrid_registers", "preagg")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def hold_sharded(out, o, name):
    """A sharded result against the oracle (integer-valued values): key
    set, COUNT exact, SUM exact below 2^24 (``hold_exact``), MEAN within
    SUM_RTOL · Σ|v| over the count.  Returns the groups whose SUM passes
    2^24."""
    import torch

    big = hold_exact(out, o, name)
    n = int(out["__num_groups__"][0])
    sub = type(out)({c: t[:n] for c, t in out.columns.items()})
    check_against_oracle(sub, torch.argsort(sub["key"]), o, name)
    return big


def shard_launches_ok(name, launches, *, members, chunks, psum_merges, exact=True):
    """The launch counts of a sharded stream on the card: ``scan_ticket``
    once per member per chunk, the segment kernel once per member, chunk
    and plane (and once per member and plane in each dense_psum merge), the
    ticket kernel once per dense_psum merge, and no other kernel (the
    fused kernel never).  ``exact=False`` (GROW, re-mesh) asks for at least
    those counts."""
    want = {"scan_ticket": members * chunks,
            "segment_agg": members * chunks * SHARD_PLANES
            + psum_merges * members * SHARD_PLANES,
            "ticket_hash": psum_merges}
    for k, w in want.items():
        ok = launches[k] == w if exact else launches[k] >= w
        check(ok, f"{name}: {launches[k]} {k} launches, expected {'' if exact else '>= '}{w}")
    for k in SHARD_OTHERS:
        check(launches[k] == 0, f"{name}: the {k} kernel ran on the sharded route")


def phase3_sharded(kmods, api, gen, device, n=1 << 24, small=1 << 22):
    """Multi-device sharding on one card (``parallel/sharding.py``,
    ``core/distributed.py``, ``_ShardedExecutor``): ``virtual_devices(8,
    "cuda")`` makes the card an 8-member mesh, each member with its own
    tables.  Streams of 8 chunks, integer-valued values, sum(v), count(*)
    and mean(v), each held to the oracle (COUNT exact, SUM exact below
    2^24, MEAN within SUM_RTOL): the low, high and unique classes at 2^24
    rows under RAISE with both merges (bounds 1024 / N / 10 / N, local
    bounds 1024 / 2^18 / 2^22); GROW from max_groups=64 on low and high
    (2^24 rows, dense_psum); at 2^22 rows on low: a re-mesh (2 of 8 members
    marked failed after 4 chunks, ``remesh_stream``, every survivor's
    re-bucketed table probed back to its tickets), a commit saved on 8
    members and restored on 4, and the server with a sharded tenant beside
    a flat one while one member fails (both exact, ``remeshes == 1`` for
    the sharded tenant only).  Each stream's launch counts are read around
    it (``shard_launches_ok``).  Prints the wall, the consume, merge,
    re-mesh and save / restore seconds and the commit bytes on ``phase3
    {"stream": "shard_*", ...}`` lines, with the card's name and power
    limit."""
    import shutil

    import torch

    from repro_torch.core import ticketing as tk
    from repro_torch.engine import elastic as tel
    from repro_torch.parallel import sharding
    from repro_torch.serve import AggregationServer
    from repro_torch.train import elastic as telastic

    card = card_line()
    root = os.path.join(HERE, "build", "chip_smoke_shard")
    shutil.rmtree(root, ignore_errors=True)
    sharding.virtual_devices(SHARD_MEMBERS, device)
    mesh8 = sharding.make_mesh((SHARD_MEMBERS,), ("data",))
    aggs = tuple(api.AggSpec(k, c) for k, c in SHARD_AGGS)
    vals = torch.randint(0, 100, (n,), generator=gen, device=device).float()
    recs = []

    def plan(merge, sat, max_groups, mesh=mesh8, **ex):
        return api.GroupByPlan(keys=("k",), aggs=aggs, strategy="sharded",
                               max_groups=max_groups, saturation=sat, raw_keys=True,
                               execution=api.ExecutionPolicy(mesh=mesh, shard_merge=merge,
                                                             **ex))

    def source(keys, v, chunks=8):
        step = keys.shape[0] // chunks
        return [api.Table({"k": keys[lo:lo + step], "v": v[lo:lo + step]})
                for lo in range(0, keys.shape[0], step)]

    def emit(rec):
        rec["card"] = card
        log("phase3 " + json.dumps(rec))
        recs.append(rec)

    def stream(name, p, keys, v):
        o = oracle(keys, v)
        sync()
        reset_launches(kmods)
        t0 = time.perf_counter()
        h = p.stream(source(keys, v))
        h.pump(8)
        h._drain_inflight()
        sync()
        t1 = time.perf_counter()
        out = h.result()
        sync()
        t2 = time.perf_counter()
        launches = read_launches(kmods)
        big = hold_sharded(out, o, f"shard_{name}")
        ex, e = h.executor, p.execution
        grow = p.saturation == "grow"
        shard_launches_ok(f"shard_{name}", launches, members=SHARD_MEMBERS, chunks=8,
                          psum_merges=int(e.shard_merge == "dense_psum"), exact=not grow)
        if grow:
            check(ex.bound_grows >= 1, f"shard_{name}: no bound grow from max_groups=64")
        emit({"stream": f"shard_{name}", "members": SHARD_MEMBERS, "rows": int(keys.numel()),
              "merge": e.shard_merge, "saturation": p.saturation, "wall_s": t2 - t0,
              "consume_s": t1 - t0, "merge_s": t2 - t1, "groups": int(o["keys"].numel()),
              "groups_sum_past_2^24": big, "max_groups": ex._max_groups,
              "max_local": ex._max_local, "bound_grows": ex.bound_grows,
              "migrations": ex.migrations, "launches": launches})

    low = gen_keys(n, "low", "uniform", gen, device)
    high = gen_keys(n, "high", "zipf", gen, device)
    uniq = gen_keys(n, "unique", "uniform", gen, device)
    for merge in ("dense_psum", "all_to_all"):
        stream(f"low_{merge}", plan(merge, "raise", 1024), low, vals)
        stream(f"high_{merge}", plan(merge, "raise", n // 10, max_local_groups=n >> 6),
               high, vals)
        stream(f"unique_{merge}", plan(merge, "raise", n, max_local_groups=n >> 2),
               uniq, vals)
    del uniq
    stream("low_grow", plan("dense_psum", "grow", 64), low, vals)
    stream("high_grow", plan("dense_psum", "grow", 64), high, vals)
    del high

    k_s, v_s = low[:small], vals[:small]
    o = oracle(k_s, v_s)

    # a re-mesh: 2 of 8 members fail after 4 chunks
    sync()
    reset_launches(kmods)
    t0 = time.perf_counter()
    h = plan("dense_psum", "raise", 1024).stream(source(k_s, v_s))
    h.pump(4)
    h._drain_inflight()
    sync()
    before = read_launches(kmods)
    lost = [d.id for d in mesh8.devices.reshape(-1)[-2:]]
    telastic.mark_failed(lost)
    r0 = time.perf_counter()
    check(tel.remesh_stream(h), "shard_remesh: the loss was not seen")
    sync()
    remesh_s = time.perf_counter() - r0
    check(not tel.remesh_stream(h), "shard_remesh: re-meshed twice")
    ex = h.executor
    for i, t in enumerate(ex._carry.tables):  # the ticket kernel built valid probe tables
        c = int(t.count)
        check(torch.equal(tk.lookup(t, t.key_by_ticket[:c]),
                          torch.arange(c, dtype=torch.int32, device=device)),
              f"shard_remesh: member {i}'s re-bucketed table does not probe to its tickets")
    out = h.result()
    sync()
    wall = time.perf_counter() - t0
    telastic.reset_failures()
    launches = read_launches(kmods)
    hold_sharded(out, o, "shard_remesh")
    check(ex.remeshes == 1 and ex._ndev == 6, f"shard_remesh: {ex.remeshes} re-meshes onto "
          f"{ex._ndev} members")
    shard_launches_ok("shard_remesh (first 4 chunks)", before, members=8, chunks=4,
                      psum_merges=0)
    after = {k: launches[k] - before[k] for k in launches}
    check(after["scan_ticket"] == 6 * 4, f"shard_remesh: {after['scan_ticket']} scan_ticket "
          "launches after the re-mesh, expected 6 members x 4 chunks")
    check(after["ticket_hash"] == 6 + 1, f"shard_remesh: {after['ticket_hash']} ticket "
          "launches after the re-mesh, expected 6 tables + 1 union")
    emit({"stream": "shard_remesh", "members": [8, 6], "rows": small, "wall_s": wall,
          "remesh_s": remesh_s, "groups": int(o["keys"].numel()), "launches": launches})

    # a commit saved on 8 members, restored on 4
    mesh4 = sharding.make_mesh((4,), ("data",))
    path = os.path.join(root, "restore_8_to_4")
    reset_launches(kmods)
    t0 = time.perf_counter()
    h = plan("dense_psum", "raise", 1024).stream(source(k_s, v_s))
    h.pump(4)
    sync()
    s0 = time.perf_counter()
    committed = h.save(path)
    save_s = time.perf_counter() - s0
    nbytes = _dir_bytes(committed)
    h.cancel()
    r0 = time.perf_counter()
    restored = plan("dense_psum", "raise", 1024, mesh=mesh4).restore(path, source(k_s, v_s))
    sync()
    restore_s = time.perf_counter() - r0
    check(restored.executor._ndev == 4 and restored.chunks_consumed == 4,
          "shard_restore_8_to_4: not restored onto 4 members at chunk 4")
    out = restored.result()
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    hold_sharded(out, o, "shard_restore_8_to_4")
    check(launches["fused_groupby"] == 0, "shard_restore_8_to_4: the fused kernel ran")
    emit({"stream": "shard_restore_8_to_4", "members": [8, 4], "rows": small, "wall_s": wall,
          "save_s": save_s, "restore_s": restore_s, "commit_bytes": nbytes,
          "launches": launches})

    # the server: a sharded tenant beside a flat one; one member fails
    flat = api.GroupByPlan(keys=("k",), aggs=aggs, strategy="concurrent", max_groups=1024,
                           saturation="raise", raw_keys=True,
                           execution=api.ExecutionPolicy(kernel="scan_body",
                                                         device=device.type))
    reset_launches(kmods)
    sync()
    t0 = time.perf_counter()
    server = AggregationServer(slots=4)
    q_sh = server.submit(plan("dense_psum", "raise", 1024), source(k_s, v_s), tenant="meshy")
    q_fl = server.submit(flat, source(k_s, v_s), tenant="flat")
    server.step(3)
    telastic.mark_failed([lost[0]])
    outs = [q.result() for q in (q_sh, q_fl)]
    sync()
    wall = time.perf_counter() - t0
    telastic.reset_failures()
    launches = read_launches(kmods)
    for q, out, label in zip((q_sh, q_fl), outs, ("sharded", "flat")):
        hold_sharded(out, o, f"shard_serve {label}")
    rm = [q.profile()["recoveries"]["remeshes"] for q in (q_sh, q_fl)]
    check(rm == [1, 0], f"shard_serve: re-meshes {rm}, expected [1, 0]")
    check(launches["fused_groupby"] == 0, "shard_serve: the fused kernel ran")
    emit({"stream": "shard_serve", "rows": 2 * small, "wall_s": wall, "remeshes": rm,
          "launches": launches})
    sharding.reset_virtual_devices()
    shutil.rmtree(root, ignore_errors=True)
    return recs


# -- the LM serving path: kernel B3, phase 3 lm ------------------------------------

LM_ARCH = "granite_moe_1b_a400m"   # 24 layers, d 1024, 32 experts top-8, d_ff 512
LM_SLOTS, LM_MAX_LEN, LM_NEW = 8, 128, 32
LM_PROMPTS = [4 + 3 * i for i in range(LM_SLOTS)]
LM_REL = 0.05                   # forward vs token-by-token decode (the reference's rule)
GMM_RTOL = 1e-5                 # B3 vs plain: |Δ| <= GMM_RTOL · max|plain| (float32 sums reordered)
MOE_RTOL = 1e-4                 # one MoE layer, kernels vs plain (+ index_add_'s atomic order)


def routed_ids(tokens, experts, top_k, gen, device):
    """Expert ids of ``tokens`` routed top-``top_k`` over ``experts`` by
    random router logits (each token to distinct experts, as ``route``)."""
    import torch

    logits = torch.randn(tokens, experts, generator=gen, device=device)
    return torch.topk(logits, top_k, dim=-1).indices.reshape(-1)


def gmm_arrays(gen, device, sizes, k, n, *, tail=0, offset=0):
    """lhs (Σ sizes + ``tail`` rows, ``k``) and rhs (G, ``k``, ``n``) for
    ``sizes``, random; with ``offset`` > 0 both are contiguous views that
    start ``offset`` floats past a 16-byte boundary."""
    import torch

    m = int(sizes.clamp(min=0).sum()) + tail

    def draw(*shape, scale=1.0):
        numel = 1
        for d in shape:
            numel *= d
        flat = torch.randn(numel + offset, generator=gen, device=device) * scale
        return flat[offset:].view(*shape)

    return draw(m, k), draw(sizes.numel(), k, n, scale=k ** -0.5), sizes


def gmm_case(gen, device, tokens, k, n, *, experts=32, top_k=8, empty=0, tail=0):
    """lhs, rhs, sizes of one grouped matmul: ``tokens`` tokens routed
    top-``top_k`` (the first ``empty`` experts get no rows), ``tail`` rows
    past the last group."""
    import torch

    ids = routed_ids(tokens, experts - empty, top_k, gen, device) + empty
    sizes = torch.bincount(ids, minlength=experts).to(torch.int32)
    return gmm_arrays(gen, device, sizes, k, n, tail=tail)


def zipf_sizes(rows, groups, gen, device, a=1.7):
    """``rows`` rows over ``groups`` groups with sizes ∝ 1 / rank^a (at a =
    1.7 and 32 groups the largest takes about half), ranks shuffled."""
    import torch

    w = 1.0 / torch.arange(1, groups + 1, dtype=torch.float64) ** a
    sizes = torch.floor(rows * w / w.sum()).to(torch.int32)
    sizes[0] += rows - int(sizes.sum())
    perm = torch.randperm(groups, generator=gen, device=device).cpu()
    return sizes[perm].to(device)


def gmm_cases(gen, device):
    """name → (lhs, rhs, sizes): the B3 cases of phase 2 and the card
    tests (see :func:`phase2_grouped_matmul`)."""
    import torch

    def sizes_of(*v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return {
        "decode_gate_up": gmm_case(gen, device, 8, 1024, 512),
        "decode_down": gmm_case(gen, device, 8, 512, 1024),
        "prefill": gmm_case(gen, device, 512, 1024, 512),
        "empty_groups": gmm_case(gen, device, 40, 1024, 512, empty=8, tail=37),
        "ragged_n": gmm_case(gen, device, 40, 96, 70, empty=3, tail=5),
        "group_300": gmm_arrays(gen, device, sizes_of(3, 300, 0, 9), 1024, 512),
        "prefill_zipf": gmm_arrays(gen, device, zipf_sizes(4096, 32, gen, device), 1024, 512),
        "odd_k_n": gmm_case(gen, device, 40, 1000, 200, tail=3),
        "m1": gmm_arrays(gen, device, sizes_of(0, 0, 1, 0), 512, 1024),
        "all_empty": gmm_arrays(gen, device, sizes_of(0, 0, 0, 0), 256, 192, tail=37),
        "unaligned": gmm_arrays(gen, device, sizes_of(5, 0, 17, 42), 1024, 512, tail=6,
                                offset=1),
    }


def check_gmm(gm, lhs, rhs, sizes, label):
    """B3 against ``grouped_matmul_plain`` on the same tensors: |Δ| <=
    GMM_RTOL · max|plain|, one launch, rows past Σ sizes exactly 0.
    Returns (|Δ|, max|plain|)."""
    import torch

    before = gm.grouped_matmul.launches
    got = gm.grouped_matmul(lhs, rhs, sizes)
    sync()
    check(gm.grouped_matmul.launches == before + 1, f"{label}: not one launch")
    want = gm.grouped_matmul_plain(lhs, rhs, sizes)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    check(bool(torch.isfinite(got).all()) and err <= GMM_RTOL * scale,
          f"{label}: max|Δ|={err} > {GMM_RTOL} · {scale}")
    total = min(int(sizes.clamp(min=0).sum()), lhs.shape[0])
    check(not bool(got[total:].any()), f"{label}: rows past Σ sizes not 0")
    return err, scale


def phase2_grouped_matmul(gm, sa, gen, device):
    """B3 against ``grouped_matmul_plain`` (a loop of float32
    ``torch.matmul`` with TF32 off) on :func:`gmm_cases`: granite's decode
    shapes (8 tokens × top-8 = 64 rows over 32 experts: gate / up K = 1024,
    N = 512; down K = 512, N = 1024), a prefill-sized shape (512 tokens,
    4096 rows), 8 empty groups and 37 rows past the last group, N % 4 != 0
    (the plain-load paths), a 300-row group (more than one 128-row tile, not
    a multiple of it), 4096 rows in Zipf-skewed groups, K and N off the
    32-row K block and 64-column N tile, M = 1, every group empty with rows
    past them, and lhs and rhs 4 bytes off a 16-byte boundary: |Δ| <=
    GMM_RTOL · max|plain|, rows past the groups exactly 0.  The segment
    kernel's COUNT histogram of a decode routing (kind count, onehot, 32
    groups) must equal the one-hot sum exactly.  Returns the worst |Δ| of
    B3."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    worst = 0.0
    for name, (lhs, rhs, sizes) in gmm_cases(gen, device).items():
        err, scale = check_gmm(gm, lhs, rhs, sizes, f"phase2 grouped_matmul {name}")
        total = int(sizes.sum())
        worst = max(worst, err)
        log(f"phase2 grouped_matmul {name}: M={lhs.shape[0]} K={lhs.shape[1]} "
            f"N={rhs.shape[2]}, groups {int((sizes > 0).sum())}/{sizes.numel()} non-empty "
            f"(largest {int(sizes.max())} rows), {lhs.shape[0] - total} rows past them; "
            f"max|Δ|={err:.3g} (scale {scale:.3g}) ok")
    ids = routed_ids(LM_SLOTS, 32, 8, gen, device)
    hist = sa.segment_agg(ids.to(torch.int32), torch.ones(ids.numel(), device=device),
                          num_groups=32, kind="count", strategy="onehot", morsel_size=1)
    onehot = torch.nn.functional.one_hot(ids, 32).sum(0).float()
    check(torch.equal(hist, onehot), "phase2 segment_agg count histogram != one-hot sum")
    log("phase2 segment_agg route histogram: 64 expert ids into 32 groups equal the one-hot "
        "sum ok")
    return max(worst, phase2_qwen2moe(gm, sa, gen, device))


QWEN2MOE_SHAPES = {"qwen2moe_decode_gate_up": (LM_SLOTS, 2048, 1408),
                   "qwen2moe_decode_down": (LM_SLOTS, 1408, 2048),
                   "qwen2moe_prefill_gate_up": (LM_SLOTS * 48, 2048, 1408),
                   "qwen2moe_prefill_down": (LM_SLOTS * 48, 1408, 2048)}  # tokens, K, N


def qwen2moe_ids(tokens, gen, device):
    """Expert ids of ``tokens`` tokens routed top-4 over qwen2-moe-a2.7b's
    60 experts."""
    return routed_ids(tokens, 60, 4, gen, device)


def qwen2moe_case(gen, device, tokens, k, n):
    """lhs, rhs, sizes of one grouped matmul at qwen2-moe-a2.7b's routing:
    ``tokens`` tokens top-4 over its 60 experts in 64 groups
    (``moe_experts_padded``: the last 4 empty)."""
    import torch

    sizes = torch.bincount(qwen2moe_ids(tokens, gen, device), minlength=64).to(torch.int32)
    return gmm_arrays(gen, device, sizes, k, n)


def phase2_qwen2moe(gm, sa, gen, device):
    """B3 and the segment kernel at qwen2-moe-a2.7b's shapes (QWEN2MOE_SHAPES:
    a decode step of 8 slots × top-4 = 32 rows and a prefill of 8 × 48 × 4
    = 1536 rows over 64 groups, the last 4 empty; gate / up K 2048 → N
    1408, down K 1408 → N 2048): B3 held by :func:`check_gmm`, and its
    launcher into an output filled with NaN equal to the wrapper's (every
    element written); the segment kernel's COUNT histogram (onehot, 64
    groups) of both routings equal to the one-hot sum and to its plain
    version, the 4 padded groups 0.  The segment kernel folds into its
    accumulator, so it gets no NaN-filled output.  Returns the worst |Δ| of
    B3."""
    import torch

    worst = 0.0
    for name, (tokens, k, n) in QWEN2MOE_SHAPES.items():
        lhs, rhs, sizes = qwen2moe_case(gen, device, tokens, k, n)
        label = f"phase2 grouped_matmul {name}"
        err, scale = check_gmm(gm, lhs, rhs, sizes, label)
        got = gm.grouped_matmul(lhs, rhs, sizes)
        out = torch.full_like(got, float("nan"))
        lib = gm._kernel_library()
        gm._raise_on(lib, lib.grouped_matmul_launch(
            lhs.data_ptr(), rhs.data_ptr(), sizes.data_ptr(), out.data_ptr(), lhs.shape[0], k, n,
            sizes.numel(), gm._stream(device)), label)
        sync()
        check(torch.equal(out, got), f"{label}: the launcher into a NaN-filled output differs "
              f"from the wrapper's ({int(out.isnan().sum())} NaN left)")
        worst = max(worst, err)
        log(f"{label}: M={lhs.shape[0]} K={k} N={n}, groups {int((sizes > 0).sum())}/"
            f"{sizes.numel()} non-empty (the last 4 padded: {sizes[-4:].tolist()}); "
            f"max|Δ|={err:.3g} (scale {scale:.3g}); NaN-filled output written whole ok")
    for tokens in (LM_SLOTS, LM_SLOTS * 48):
        ids = qwen2moe_ids(tokens, gen, device).to(torch.int32)
        ones = torch.ones(ids.numel(), device=device)
        kw = dict(num_groups=64, kind="count", strategy="onehot", morsel_size=1)
        hist = sa.segment_agg(ids, ones, **kw)
        onehot = torch.nn.functional.one_hot(ids.long(), 64).sum(0).float()
        plain = sa.segment_agg_plain(ids, ones, **kw)
        check(torch.equal(hist, onehot) and torch.equal(hist, plain) and not bool(hist[60:].any()),
              f"phase2 segment_agg qwen2-moe histogram of {ids.numel()} ids != one-hot sum / "
              f"plain, or a padded group counted")
        log(f"phase2 segment_agg qwen2-moe route histogram: {ids.numel()} expert ids into 64 "
            f"groups equal the one-hot sum and the plain version, the 4 padded groups 0 ok")
    return worst


def lm_moe_layer_check(tf, moe, gm, sa, params, cfg, tokens):
    """Layer 0's MoE block on the serving batch's activations (its
    ``ln_mlp`` applied to the tokens' embeddings, in float32) through the
    kernels and through the plain versions (``moe``'s two kernel names
    pointed at ``grouped_matmul_plain`` / ``segment_agg_plain``):
    |Δ| <= MOE_RTOL · max|plain|.  Returns (|Δ|, max|plain|)."""
    import dataclasses

    from repro_torch.models.layers import apply_norm

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p0 = tf.tree_map(lambda a: a[0], params["layers"])
    x = tf._embed_tokens(params, cfg32, tokens, ticketed=False, max_unique=1)
    h = apply_norm(cfg.norm_kind, p0["ln_mlp"], x)
    got, _ = moe.moe_mlp_dense(p0["moe"], cfg32, h)
    kernels = moe.grouped_matmul, moe.segment_agg
    moe.grouped_matmul, moe.segment_agg = gm.grouped_matmul_plain, sa.segment_agg_plain
    try:
        want, _ = moe.moe_mlp_dense(p0["moe"], cfg32, h)
    finally:
        moe.grouped_matmul, moe.segment_agg = kernels
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= MOE_RTOL * scale, f"phase3 lm: MoE layer kernels vs plain max|Δ|={err} > "
          f"{MOE_RTOL} · {scale}")
    return err, scale


def phase3_lm(kmods, device, seed):
    """The LM serving path (``configs.get_config`` → ``transformer.init_params``
    → ``serve.engine.ServeLoop`` → ``run_batch``) at granite-moe-1b-a400m's
    full width (24 layers, its config's bfloat16 compute over float32
    parameters, random weights from a seeded card generator) on a
    one-member mesh of the card: 8 requests of 4 + 3·i prompt tokens and
    32 new tokens each, slots 8, max_len 128.  The launch counts are set
    to 0 just before ``run_batch`` and read just after: B3 must launch 72
    times and the segment kernel 24 times a decode step (3 and 1 per MoE
    layer), over every step of the run and on one step alone, and no
    GROUP BY kernel.  Every request done with 32 ids in [0, vocab).  Then
    full-width ``forward`` against the token-by-token ``decode_step`` over
    16 tokens (2 rows; max|Δ| / max|logit| < 0.05, the reference's rule)
    and layer 0's MoE block through the kernels against the plain versions
    (:func:`lm_moe_layer_check`).  Prints the init, prefill and decode
    times (events around the steps; one token read a tick) and tokens/s.
    Returns the record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding
    from repro_torch.serve.engine import Request, ServeLoop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = timed(tf.init_params, gen, cfg, device)
    n_params = sum(t.numel() for t in tf._leaves(params))
    mesh = sharding.make_mesh((1, 1), ("data", "model"),
                              devices=[sharding.MeshDevice(0, device)])
    loop = ServeLoop(mesh, cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    requests = [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                                                   device=device), max_new=LM_NEW)
                for i, n in enumerate(LM_PROMPTS)]
    events = []
    step = loop.step_fn

    def counted_step(*args):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)
        return step(*args)

    loop.step_fn = counted_step
    sync()
    reset_launches(kmods)
    t0 = time.perf_counter()
    loop.run_batch(requests)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    loop.step_fn = step
    steps = len(events)
    plen = max(LM_PROMPTS)
    check(steps == plen + LM_NEW - 1, f"phase3 lm: {steps} steps, expected {plen + LM_NEW - 1}")
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    check(launches["grouped_matmul"] == 3 * moe_layers * steps,
          f"phase3 lm: {launches['grouped_matmul']} B3 launches over {steps} steps, expected "
          f"{3 * moe_layers} a step")
    check(launches["segment_agg"] == moe_layers * steps,
          f"phase3 lm: {launches['segment_agg']} segment launches over {steps} steps, expected "
          f"{moe_layers} a step")
    for k in set(kmods) - {"grouped_matmul", "segment_agg"}:
        check(launches[k] == 0, f"phase3 lm: the {k} kernel ran on the LM path")
    for r in requests:
        check(r.done and len(r.generated) == LM_NEW, f"phase3 lm: request {r.uid} not done")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"phase3 lm: request {r.uid} has an id outside [0, {cfg.vocab_size})")
    prefill_ms = events[0].elapsed_time(events[plen])
    decode_ms = events[plen].elapsed_time(end) / (steps - plen)
    # one decode step alone
    tokens = torch.tensor([[r.generated[-1]] for r in requests], dtype=torch.int32, device=device)
    caches = tf.init_caches(cfg, LM_SLOTS, LM_MAX_LEN, cfg.dtype, device=device)
    before = read_launches(kmods)
    step(params, tokens, caches)
    one = {k: v - before[k] for k, v in read_launches(kmods).items()}
    check(one["grouped_matmul"] == 3 * moe_layers and one["segment_agg"] == moe_layers,
          f"phase3 lm: one step launched {one['grouped_matmul']} B3 and "
          f"{one['segment_agg']} segment kernels, expected {3 * moe_layers} and {moe_layers}")
    # full-width forward against token-by-token decode over 16 tokens
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=device)
    full = tf.forward(params, cfg, {"tokens": toks}, ticketed_embedding=False).logits
    caches = tf.init_caches(cfg, 2, 20, cfg.dtype, device=device)
    outs = []
    for i in range(16):
        lg, caches = tf.decode_step(params, cfg, toks[:, i:i + 1], caches)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-6)
    check(bool(torch.isfinite(full).all()) and full.shape == (2, 16, cfg.vocab_size),
          "phase3 lm: forward logits not finite or of the wrong shape")
    check(rel < LM_REL, f"phase3 lm: forward vs decode rel {rel} >= {LM_REL}")
    moe_err, moe_scale = lm_moe_layer_check(tf, moe, gm, sa, params, cfg, tokens)
    gen_tokens = LM_SLOTS * LM_NEW
    rec = {"stream": "lm_serve", "arch": cfg.name, "params": n_params, "dtype": cfg.dtype,
           "slots": LM_SLOTS, "prompts": LM_PROMPTS, "max_new": LM_NEW, "steps": steps,
           "init_s": init_s, "wall_s": wall, "prefill_s": prefill_ms / 1e3,
           "decode_ms_per_step": decode_ms,
           "decode_tokens_per_s": LM_SLOTS / decode_ms * 1e3,
           "tokens_per_s": gen_tokens / wall,
           "launches_per_step": {"grouped_matmul": one["grouped_matmul"],
                                 "segment_agg": one["segment_agg"]},
           "forward_vs_decode_rel": rel, "moe_layer_max_abs_err": moe_err,
           "moe_layer_scale": moe_scale,
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "launches": launches, "card": card_line()}
    log("phase3 " + json.dumps(rec))
    log(f"phase3 lm: {cfg.name} at full width ({n_params} parameters, {cfg.dtype} compute), "
        f"{LM_SLOTS} requests × {LM_NEW} tokens: prefill {prefill_ms / 1e3:.3f} s "
        f"({plen} steps), decode {decode_ms:.2f} ms a step, {LM_SLOTS / decode_ms * 1e3:.1f} "
        f"tokens/s decoding, {gen_tokens / wall:.1f} tokens/s end to end ({wall:.2f} s); "
        f"launches a step: B3 {one['grouped_matmul']}, segment {one['segment_agg']}; "
        f"forward vs decode rel {rel:.4g} < {LM_REL}; MoE layer kernels vs plain "
        f"max|Δ|={moe_err:.3g} (scale {moe_scale:.3g}) ok")
    del params, loop, caches
    torch.cuda.empty_cache()
    return rec


def gmm_bound(lhs, rhs, sizes):
    """The least time of one grouped matmul: a dict of ``bytes_ms`` (lhs,
    out and sizes once plus each non-empty group's K × N weights once, over
    3.35 TB/s), ``tf32x3_ms`` (3 × 2·rows·K·N TF32 tensor operations, the
    kernel's error-compensated products, over 495 TFLOP/s), ``fp32_ms``
    (2·rows·K·N float32 FMA operations over 67 TFLOP/s, the CUDA-core
    count), and the headline ``bound_ms`` / ``bound_by``: the larger of
    bytes and the tensor-core count."""
    m, k = lhs.shape
    g, _, n = rhs.shape
    touched = int((sizes > 0).sum())
    nbytes = 4 * (m * k + touched * k * n + g + m * n)
    ops = 2 * int(sizes.sum()) * k * n
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    t_ms = 3 * ops / TF32_OPS_PER_S * 1e3
    by = "bytes" if b_ms >= t_ms else "operations"
    return {"bound_ms": max(b_ms, t_ms), "bound_by": by, "bytes_ms": b_ms, "tf32x3_ms": t_ms,
            "fp32_ms": ops / FP32_OPS_PER_S * 1e3}


GMM_SHAPES = {"decode_gate_up": (8, 1024, 512), "decode_down": (8, 512, 1024),
              "prefill": (512, 1024, 512)}   # tokens, K, N (32 experts, top-8)


def time_cold(fn, flush, reps):
    """Median event ms of ``fn`` with ``flush`` (a 64 MiB buffer) zeroed
    before each call, untimed: the call as it finds its operands evicted
    from the 50 MB L2."""
    return time_cuda(fn, reps, flush.zero_)


def grouped_mm_library(lhs, rhs, sizes):
    """``torch._grouped_mm`` on the same rows, where this torch has it and
    it takes the shape: it needs bfloat16 operands and gives a bfloat16
    output (the yardstick runs at bf16, B3 at float32), and the offsets as
    an int32 prefix sum.  Returns (fn, note); fn is None where it does not
    run."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm absent"
    a = lhs.bfloat16()
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    errors = []
    for layout, b in (("(G, K, N) row-major", rhs.bfloat16()),
                      ("(G, K, N) column-major", rhs.bfloat16().transpose(1, 2).contiguous()
                       .transpose(1, 2))):
        def fn(a=a, b=b):
            return torch._grouped_mm(a, b, offs=offs)
        try:
            fn()
            sync()
            return fn, f"torch._grouped_mm, bf16 operands, rhs {layout}"
        except (RuntimeError, TypeError, ValueError) as e:
            errors.append(f"{layout}: {str(e).splitlines()[0][:160]}")
    return None, "torch._grouped_mm refused: " + "; ".join(errors)


def phase4_grouped_matmul(gm, gen, device, reps=5):
    """B3 at the decode shapes (64 rows; gate / up and down), the
    prefill shape (4096 rows) and qwen2-moe-a2.7b's decode shapes (32 rows
    over 64 groups, the last 4 empty; K 2048 → N 1408 and K 1408 → N
    2048): warm (CUDA events, median of ``reps``), cold
    (the same with the L2 flushed before each call: a decode step's 72
    calls touch 4.5 GiB of weights, so the served path finds them cold)
    and by CUDA-graph replay (device time without the wrapper's host
    work), beside its bound (:func:`gmm_bound`), its plain version (held
    against it), the per-expert ``torch.matmul`` loop with the sizes
    already on the host, and ``torch._grouped_mm`` (bf16) where it runs.
    The decode gate / up shape is the kernel's line.  Returns the record."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    per_shape = {}
    worst = 0.0
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    cases = {name: gmm_case(gen, device, *shape) for name, shape in GMM_SHAPES.items()}
    cases.update({name: qwen2moe_case(gen, device, *QWEN2MOE_SHAPES[name])
                  for name in ("qwen2moe_decode_gate_up", "qwen2moe_decode_down")})
    for name, (lhs, rhs, sizes) in cases.items():
        k, n = lhs.shape[1], rhs.shape[2]

        def call():
            return gm.grouped_matmul(lhs, rhs, sizes)

        ms = time_cuda(call, reps)
        cold_ms = time_cold(call, flush, reps)
        graph_ms = time_graph(call)
        plain_ms = time_cuda(lambda: gm.grouped_matmul_plain(lhs, rhs, sizes), reps)
        host_sizes = sizes.tolist()
        out = torch.empty(lhs.shape[0], n, device=device)

        def matmul_loop():
            s = 0
            for g, c in enumerate(host_sizes):
                if c:
                    torch.matmul(lhs[s:s + c], rhs[g], out=out[s:s + c])
                s += c

        loop_ms = time_cuda(matmul_loop, reps)
        lib, note = grouped_mm_library(lhs, rhs, sizes)
        lib_ms = time_cuda(lib, reps) if lib is not None else None
        got = gm.grouped_matmul(lhs, rhs, sizes)
        want = gm.grouped_matmul_plain(lhs, rhs, sizes)
        err = float((got - want).abs().max())
        check(err <= GMM_RTOL * float(want.abs().max()),
              f"phase4 grouped_matmul {name}: max|Δ|={err}")
        worst = max(worst, err)
        bound = gmm_bound(lhs, rhs, sizes)
        per_shape[name] = {"rows": lhs.shape[0], "k": k, "n": n,
                           "groups": int((sizes > 0).sum()), "kernel_ms": ms,
                           "cold_ms": cold_ms, "graph_ms": graph_ms,
                           "plain_ms": plain_ms, **bound,
                           "matmul_loop_ms": loop_ms, "library_ms": lib_ms, "library": note,
                           "max_abs_err": err}
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        log(f"phase4 grouped_matmul {name}: kernel {ms:.4f} ms warm, {cold_ms:.4f} cold, "
            f"{graph_ms:.4f} graph (M={lhs.shape[0]} K={k} N={n}, "
            f"{per_shape[name]['groups']} groups), bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}; bytes {bound['bytes_ms']:.4f}, 3xTF32 "
            f"{bound['tf32x3_ms']:.4f}, f32 FMA {bound['fp32_ms']:.4f}), plain "
            f"{plain_ms:.4f} ms, per-expert matmul loop {loop_ms:.4f} ms, library {lib_txt} "
            f"({note}); max|Δ|={err:.3g} ok")
    log("phase4 grouped_matmul " + json.dumps(per_shape))
    head = per_shape["decode_gate_up"]
    return {"ms": head["kernel_ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "max_abs_err": worst, "per_shape": per_shape}


# -- LM training: kernel B5, phase 3 lm_train ----------------------------------------

TRAIN_ARCH = "qwen3_0_6b"       # 28 layers, d 1024, vocab 151,936, d_ff 3072, tied
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 30
TRAIN_HP = {"peak_lr": 1e-3, "warmup": 20}   # examples/train_lm.py's
FWD_RUNS = 2                    # under autograd a block runs twice: forward, then its recompute
ROWS_RTOL = 1e-5                # B5 vs plain: |Δ| <= ROWS_RTOL · Σ|row| of the ticket (atomic order)


def zipf_tokens(rows, vocab, seed, a=1.2):
    """``rows`` token ids drawn as ``SyntheticLM`` draws them: numpy's
    Zipf(a) minus one, modulo the vocabulary (token 0 ≈ 18% of the rows at
    a = 1.2)."""
    import numpy as np

    z = np.random.default_rng(seed).zipf(a, size=rows).astype(np.int64)
    return ((z - 1) % vocab).astype(np.int32)


def embed_tickets(th, device, rows=TRAIN_BATCH * TRAIN_SEQ, vocab=151_936, seed=0):
    """B5's tickets on the training path: ``rows`` Zipf token ids ticketed
    by the ticket kernel as the ticketed embedding's backward tickets them
    (``max_unique`` = rows).  Returns (ids, tickets, key_by_ticket, count,
    max_unique, capacity)."""
    import torch

    from repro_torch.core.hashing import table_capacity
    from repro_torch.models import layers

    ids = torch.from_numpy(zipf_tokens(rows, vocab, seed)).to(device)
    mu = min(vocab, rows)
    cap = table_capacity(mu)
    tickets, kbt, count = layers._ticket_ids(ids, mu, cap, th.ticket_hash)
    return ids, tickets, kbt, count, mu, cap


def check_rows(sr, got, rows, tickets, groups, label):
    """B5's output against its plain version on the same tensors: every
    sum within ROWS_RTOL · Σ|row| of its ticket (dropped rows add
    nothing).  Returns max|Δ|."""
    want = sr.segment_rows_plain(rows, tickets, groups)
    scale = sr.segment_rows_plain(rows.abs(), tickets, groups)
    err = (got - want).abs()
    check(bool((err <= ROWS_RTOL * scale).all()),
          f"{label}: max|Δ|={float(err.max())} past {ROWS_RTOL} · Σ|row|")
    return float(err.max())


def phase2_segment_rows(sr, th, gen, device):
    """B5 (``csrc/segment_rows.cu``) against ``segment_rows_plain`` (one
    ``index_add_``): the training path's shape (1024 rows of d = 1024 at
    the tickets the ticket kernel gives 1024 Zipf token ids, G = 1024),
    R = G = 16384 (a batch of 8 × 2048 ids: several ticket ranges), tickets
    of -1 and >= G with a hot ticket on half the rows, every row on one
    ticket, every ticket dropped, d = 70 (the scalar path) and rows 4 bytes
    off a 16-byte boundary.  Each output is allocated without zeroing, so
    an element the kernel missed shows.  Returns the worst |Δ|."""
    import torch

    worst = 0.0
    _, tickets, _, count, mu, _ = embed_tickets(th, device)
    cases = {"train": (torch.randn(mu, 1024, generator=gen, device=device), tickets, mu)}
    _, big_t, _, big_count, big_mu, _ = embed_tickets(th, device, rows=8 * 2048)
    cases["batch_16384"] = (torch.randn(big_mu, 1024, generator=gen, device=device), big_t,
                            big_mu)
    t = torch.randint(-1, 514, (3000,), generator=gen, device=device, dtype=torch.int32)
    t[torch.rand(3000, generator=gen, device=device) < 0.5] = 7
    x = torch.randn(3000, 1024, generator=gen, device=device)
    cases["dropped_hot"] = (x, t, 512)
    cases["one_ticket"] = (x, torch.full_like(t, 7), 512)
    cases["all_dropped"] = (x, torch.where(t < 256, -1, 512 + (t & 3)), 512)
    cases["scalar_d70"] = (torch.randn(3000, 70, generator=gen, device=device), t, 512)
    off = torch.randn(3000 * 1024 + 1, generator=gen, device=device)[1:].reshape(3000, 1024)
    cases["misaligned"] = (off, t, 512)
    for name, (rows, tk, g) in cases.items():
        before = sr.segment_rows.launches
        got = sr.segment_rows(rows, tk, g)
        sync()
        check(sr.segment_rows.launches == before + 1, f"phase2 segment_rows {name}: not launched")
        err = check_rows(sr, got, rows, tk, g, f"phase2 segment_rows {name}")
        worst = max(worst, err)
        log(f"phase2 segment_rows {name}: R={rows.shape[0]} d={rows.shape[1]} G={g}, "
            f"{int(((tk >= 0) & (tk < g)).sum())} rows kept; max|Δ|={err:.3g} ok")
    # the launcher the wrapper uses, into an output full of NaN: every element written
    rows, tk, g = cases["batch_16384"]
    out = torch.full((g, rows.shape[1]), float("nan"), device=device)
    sr._launch(rows, tk, out, g)
    sync()
    empty = sr.segment_rows_plain(torch.ones_like(rows[:, :1]), tk, g)[:, 0] == 0
    check(not bool(out.isnan().any()) and not bool(out[empty].any()),
          "phase2 segment_rows: a NaN-filled output kept a NaN or a ticket with no rows "
          "is not 0")
    check_rows(sr, out, rows, tk, g, "phase2 segment_rows nan_prefilled")
    log(f"phase2 segment_rows nan_prefilled: every element written, {int(empty.sum())} "
        f"tickets with no row exactly 0")
    log(f"phase2 segment_rows: the training tickets hold {int(count)} distinct ids of {mu}, "
        f"the 16384-id batch's {int(big_count)} of {big_mu}")
    return worst


def lm_train_resume(device, seed):
    """``train_loop`` with a ``CheckpointManager`` at the tiny preset
    (reduced qwen3-0.6b, float32 so that bf16 rounding does not magnify
    the atomic order of B5's sums): 4 steps uninterrupted; 2 steps with a
    commit at step 2; a resume from it to step 4.  The resumed parameters
    and moments equal the uninterrupted run's within SUM_RTOL of each
    leaf's largest value.  Returns (worst relative |Δ|, seconds)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding
    from repro_torch.train import loop as tloop

    t0 = time.perf_counter()
    tiny = dataclasses.replace(get_config(TRAIN_ARCH, reduced=True), dtype="float32")
    hp = tloop.TrainHParams(total_steps=4, ticketed_embedding=True, **TRAIN_HP)
    mesh = sharding.make_mesh((1, 1), ("data", "model"), devices=[sharding.MeshDevice(0, device)])
    root = os.path.join(HERE, "build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)

    def data(start=0):
        d = SyntheticLM(tiny, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed, track_stats=False,
                        device=device)
        d.state.step = start
        return iter(d)

    def fresh():
        return tf.init_params(torch.Generator(device=device).manual_seed(seed), tiny, device)

    whole, wopt, _ = tloop.train_loop(mesh, tiny, hp, data(), steps=4, params=fresh(),
                                      log_every=100)
    mgr = CheckpointManager(root, async_save=False)
    tloop.train_loop(mesh, tiny, hp, data(), steps=2, params=fresh(), checkpoint_manager=mgr,
                     checkpoint_every=2, log_every=100)
    check(mgr.latest_step() == 2, f"lm_train resume: latest commit {mgr.latest_step()}, not 2")
    res, ropt, _ = tloop.train_loop(mesh, tiny, hp, data(2), steps=4, params=fresh(),
                                    checkpoint_manager=mgr, checkpoint_every=2, log_every=100)
    check(int(ropt.step) == int(wopt.step) == 4, "lm_train resume: the step counters differ")
    worst = 0.0
    for got, want in ((res, whole), (ropt.m, wopt.m), (ropt.v, wopt.v)):
        for a, b in zip(tf._leaves(got), tf._leaves(want)):
            rel = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
            worst = max(worst, rel)
    check(worst <= SUM_RTOL, f"lm_train resume: resumed vs uninterrupted rel {worst} > {SUM_RTOL}")
    shutil.rmtree(root, ignore_errors=True)
    return worst, time.perf_counter() - t0


def run_train_loop(kmods, cfg, device, seed, name):
    """``train_loop`` of ``cfg`` at full width on a one-member mesh of the
    card (``transformer.init_params`` from a seeded card generator →
    ``SyntheticLM(batch=8, seq=128, track_stats=True)`` → TRAIN_STEPS steps
    with TRAIN_HP and ``ticketed_embedding``), the launch counts set to 0
    just before ``train_loop`` and read just after, a CUDA event at each
    step's start.  Gates shared by the training phases: TRAIN_STEPS steps
    logged; the stats plan on ``cuda_route``'s scan_body + scatter; every
    loss finite and the mean of the last 5 below the mean of the first 5;
    the ``token_stats()`` total equal to the tracked rows.  Returns a dict
    of the run (``rec`` its record, without kernel-specific fields)."""
    import math

    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding
    from repro_torch.train import loop as tloop

    hp = tloop.TrainHParams(total_steps=TRAIN_STEPS, ticketed_embedding=True, **TRAIN_HP)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_mib = torch.cuda.memory_allocated() / 2 ** 20  # live tensors of earlier phases
    params, init_s = timed(tf.init_params, gen, cfg, device)
    n_params = sum(t.numel() for t in tf._leaves(params))
    mesh = sharding.make_mesh((1, 1), ("data", "model"), devices=[sharding.MeshDevice(0, device)])
    data = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed, track_stats=True,
                       device=device)
    route = data._stats._plan.execution
    pulled = []

    def feed():
        for batch in data:
            pulled.append(batch["tokens"])
            yield batch

    events = []
    make_step = tloop.make_train_step

    def timed_steps(*args, **kw):
        step = make_step(*args, **kw)

        def run(*a):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append(e)
            return step(*a)

        return run

    tloop.make_train_step = timed_steps
    sync()
    reset_launches(kmods)
    t0 = time.perf_counter()
    try:
        params, opt, hist = tloop.train_loop(mesh, cfg, hp, feed(), steps=TRAIN_STEPS,
                                             params=params, log_every=1)
    finally:
        tloop.make_train_step = make_step
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    steps, batches = len(events), len(pulled)
    check(steps == TRAIN_STEPS and len(hist) == TRAIN_STEPS,
          f"phase3 {name}: {steps} steps, {len(hist)} logged, expected {TRAIN_STEPS}")
    check(route.kernel == "scan_body" and route.update == "scatter",
          f"phase3 {name}: the stats plan resolved to kernel={route.kernel!r} "
          f"update={route.update!r}, not the CUDA route rule's scan_body + scatter")
    losses = [h["loss"] for h in hist]
    check(all(math.isfinite(x) for x in losses), f"phase3 {name}: a loss is not finite {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"phase3 {name}: loss did not fall (first 5 {first}, last 5 {last})")
    keys, counts = data.token_stats()
    tracked = sum(int((t < data.stat_groups // 2).sum()) for t in pulled)
    check(int(counts.astype("float64").sum()) == tracked,
          f"phase3 {name}: token_stats total {counts.sum()} != {tracked} tracked rows")
    step_ms = sorted(events[i].elapsed_time(events[i + 1]) for i in range(1, steps - 1))
    ms = step_ms[len(step_ms) // 2]
    first_ms = events[0].elapsed_time(events[1])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec = {"stream": name, "arch": cfg.name, "params": n_params, "dtype": cfg.dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps, "batches": batches,
           "init_s": init_s, "wall_s": wall, "step_ms": ms, "first_step_ms": first_ms,
           "step_ms_range": [step_ms[0], step_ms[-1]], "tokens_per_s": tokens / ms * 1e3,
           "peak_mib": peak_mib, "held_before_mib": held_mib,
           "peak_over_held_mib": peak_mib - held_mib, "losses": losses, "first5": first,
           "last5": last, "stats_route": {"kernel": route.kernel, "update": route.update},
           "stats_groups": int(keys.size), "stats_total": tracked,
           "launches": launches, "card": card_line()}
    return {"params": params, "opt": opt, "hist": hist, "hp": hp, "launches": launches,
            "steps": steps, "batches": batches, "data": data, "pulled": pulled, "route": route,
            "losses": losses, "first5": first, "last5": last, "step_ms": ms,
            "first_step_ms": first_ms, "stats_keys": keys, "stats_total": tracked, "rec": rec}


def phase3_lm_train(kmods, device, seed, reps=5):
    """LM training on one member at qwen3-0.6b's full width
    (``configs.get_config`` → ``transformer.init_params`` →
    ``data.pipeline.SyntheticLM(batch=8, seq=128, track_stats=True)`` →
    ``train.loop.train_loop`` on a one-member mesh of the card, with
    ``examples/train_lm.py``'s hyperparameters and ``ticketed_embedding``):
    TRAIN_STEPS steps of 1024 tokens, bf16 compute over float32 parameters
    and AdamW moments, random weights from a seeded card generator.  The
    launch counts are set to 0 just before ``train_loop`` and read just
    after: each step makes exactly one ticket and one B5 launch (the
    embedding's backward) and no B3 launch; each batch pulled makes the
    launches of the stats plan's route (scan_body: one ``scan_ticket`` and
    one segment launch); no other kernel.  Gates: every loss finite; the
    mean of the last 5 losses below the mean of the first 5; the
    ``token_stats()`` total equal to the tracked rows; the backward's table
    gradient on the card against the plain three-step version on the same
    CUDA tensors (the same rows touched, each sum within SUM_RTOL · Σ|g|);
    the tiny-preset resume (:func:`lm_train_resume`).  Prints ms a step
    (CUDA events between step starts), tokens/s, peak memory, the
    backward's three stages timed apart and the autograd backward of the
    plain ``embed`` gather beside them.  Returns the record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.hashing import table_capacity
    from repro_torch.kernels import segment_rows as sr
    from repro_torch.kernels import ticket_hash as th
    from repro_torch.models import layers

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device=device).manual_seed(seed)
    run = run_train_loop(kmods, cfg, device, seed, "lm_train")
    params, launches, steps, batches = run["params"], run["launches"], run["steps"], run["batches"]
    pulled, losses = run["pulled"], run["losses"]
    want = {k: 0 for k in kmods}
    want.update(ticket_hash=steps, segment_rows=steps, scan_ticket=batches, segment_agg=batches)
    check(launches == want, f"phase3 lm_train: launches {launches}, expected {want} "
          f"({steps} steps, {batches} batches pulled)")
    first, last, ms, first_ms = run["first5"], run["last5"], run["step_ms"], run["first_step_ms"]
    keys, tracked = run["stats_keys"], run["stats_total"]

    # the backward on the card against its plain three-step version
    ids = pulled[-1]
    vocab, d = params["embed"]["table"].shape
    mu = min(cfg.vocab_size, ids.numel())
    cap = table_capacity(mu)
    g = torch.randn(*ids.shape, d, generator=gen, device=device)
    got = layers.ticketed_embed_grad(ids, g, vocab, mu, cap)
    want_g = layers.ticketed_embed_grad_plain(ids, g, vocab, mu, cap)
    absum = torch.zeros(vocab, d, device=device).index_add_(0, ids.reshape(-1).long(),
                                                            g.reshape(-1, d).abs())
    uniq = torch.unique(ids).long()
    check(torch.equal(torch.nonzero(got.abs().sum(1)).reshape(-1), uniq)
          and torch.equal(torch.nonzero(want_g.abs().sum(1)).reshape(-1), uniq),
          "phase3 lm_train: the card backward touches other rows than the batch's ids")
    grad_err = float((got - want_g).abs().max())
    check(bool(((got - want_g).abs() <= SUM_RTOL * absum).all()),
          f"phase3 lm_train: card backward vs plain max|Δ|={grad_err} past SUM_RTOL · Σ|g|")
    del got, want_g, absum

    # the backward's three stages apart, and the dense scatter-add it replaces
    g2 = g.reshape(-1, d)
    tickets, kbt, count = layers._ticket_ids(ids, mu, cap, th.ticket_hash)
    seg = sr.segment_rows(g2, tickets, mu)
    stages = {
        "ticket": time_cuda(lambda: layers._ticket_ids(ids, mu, cap, th.ticket_hash), reps),
        "segment_rows": time_cuda(lambda: sr.segment_rows(g2, tickets, mu), reps),
        "index_add": time_cuda(lambda: layers._scatter_rows(seg, kbt, count, vocab), reps),
        "whole": time_cuda(lambda: layers.ticketed_embed_grad(ids, g, vocab, mu, cap), reps),
    }
    table = params["embed"]["table"].detach().requires_grad_(True)
    dense = layers.embed({"table": table}, ids, torch.float32)
    stages["dense_embed_backward"] = time_cuda(
        lambda: torch.autograd.grad(dense, table, g, retain_graph=True), reps)
    del dense, table, seg
    distinct = int(count)
    hot = float((ids == 0).float().mean())
    resume_rel, resume_s = lm_train_resume(device, seed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rec = {**run["rec"], "distinct_ids_last_batch": distinct, "token0_share_last_batch": hot,
           "backward_stage_ms": stages, "backward_max_abs_err": grad_err,
           "resume_rel": resume_rel, "resume_s": resume_s}
    n_params, peak_mib, held_mib = rec["params"], rec["peak_mib"], rec["held_before_mib"]
    log("phase3 " + json.dumps(rec))
    log(f"phase3 lm_train: {cfg.name} at full width ({n_params} parameters, {cfg.dtype} compute "
        f"over float32), {steps} steps of {tokens} tokens: {ms:.2f} ms a step (median; first "
        f"{first_ms:.1f} ms), {tokens / ms * 1e3:.0f} tokens/s, peak {peak_mib:.0f} MiB ({peak_mib - held_mib:.0f} "
        f"over the {held_mib:.0f} MiB earlier phases hold); loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f} (first 5 {first:.3f}, last 5 {last:.3f}); "
        f"launches a step: ticket 1, B5 1, B3 0, stats route scan_ticket 1 + segment 1 a "
        f"batch; backward stages ticket {stages['ticket']:.4f} + B5 "
        f"{stages['segment_rows']:.4f} + index_add_ {stages['index_add']:.4f} ms (whole "
        f"{stages['whole']:.4f} ms) beside the dense embed backward "
        f"{stages['dense_embed_backward']:.4f} ms; card vs plain backward max|Δ|={grad_err:.3g}; "
        f"token_stats {int(keys.size)} groups, {tracked} rows ok; resume (tiny, float32) rel "
        f"{resume_rel:.3g} in {resume_s:.1f} s ok")
    del params, run
    torch.cuda.empty_cache()
    return rec


def phase4_segment_rows(sr, th, gen, device, reps=5):
    """B5 at the training path's shape (R = 1024 rows of d = 1024 at the
    tickets of 1024 Zipf token ids, G = 1024) and at R = G = 16384 (8 ×
    2048 ids), CUDA events (median of ``reps``) and CUDA-graph replay
    (device time without the host's launch work; events minus graph is the
    host's µs a call), beside its bound (rows and tickets read once, the
    G × d sums written once, over 3.35 TB/s), its plain version (held
    against it) and the library call, ``torch.zeros`` + ``index_add_`` of
    the same rows, by events and by graph.  The training rows at distinct
    tickets (a permutation: no two rows share a ticket) show what the hot
    tickets' contention costs.  Returns the training shape's record."""
    import torch

    recs = {}
    for name, rows_n in (("train", TRAIN_BATCH * TRAIN_SEQ), ("batch_16384", 8 * 2048)):
        _, tickets, _, count, mu, _ = embed_tickets(th, device, rows=rows_n, seed=1)
        d = 1024
        rows = torch.randn(mu, d, generator=gen, device=device)
        idx = tickets.long()

        def lib():
            return torch.zeros(mu, d, device=device).index_add_(0, idx, rows)

        ms = time_cuda(lambda: sr.segment_rows(rows, tickets, mu), reps)
        graph_ms = time_graph(lambda: sr.segment_rows(rows, tickets, mu))
        lib_ms = time_cuda(lib, reps)
        lib_graph_ms = time_graph(lib)
        plain_ms = time_cuda(lambda: sr.segment_rows_plain(rows, tickets, mu), reps)
        err = check_rows(sr, sr.segment_rows(rows, tickets, mu), rows, tickets, mu,
                         f"phase4 segment_rows {name}")
        hot = float(torch.bincount(idx).max()) / mu
        nbytes = 4 * (mu * d + mu + mu * d)
        rec = {"rows": mu, "d": d, "groups": mu, "distinct": int(count), "hot_share": hot,
               "kernel_ms": ms, "graph_ms": graph_ms, "host_us": (ms - graph_ms) * 1e3,
               "plain_ms": plain_ms, "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
               "bound_bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "max_abs_err": err}
        if name == "train":
            perm = torch.randperm(mu, generator=gen, device=device).to(torch.int32)
            rec["distinct_tickets_ms"] = time_cuda(lambda: sr.segment_rows(rows, perm, mu), reps)
            rec["distinct_tickets_graph_ms"] = time_graph(lambda: sr.segment_rows(rows, perm, mu))
            rec["hot_vs_distinct_graph"] = graph_ms / rec["distinct_tickets_graph_ms"] - 1
        recs[name] = rec
        log(f"phase4 segment_rows {name} " + json.dumps(rec))
        log(f"phase4 segment_rows {name}: kernel {ms:.4f} ms (graph {graph_ms:.4f}, host "
            f"{rec['host_us']:.1f} us a call) for {mu} rows of {d} into {int(count)} live "
            f"tickets, the hottest {hot:.1%} of the rows; bound {rec['bound_ms']:.4f} ms "
            f"(bytes); torch.zeros + index_add_ {lib_ms:.4f} ms (graph {lib_graph_ms:.4f}); "
            f"plain {plain_ms:.4f} ms; max|Δ|={err:.3g} ok")
    rec = recs["train"]
    log(f"phase4 segment_rows: distinct tickets graph {rec['distinct_tickets_graph_ms']:.4f} ms, "
        f"the hot tickets cost {rec['hot_vs_distinct_graph']:+.1%}")
    return {"ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": rec["library_ms"],
            "max_abs_err": max(r["max_abs_err"] for r in recs.values()), "detail": recs}


# -- MoE training: kernel B6, phase 3 lm_train_moe; the data-parallel step -------------

MOE_TRAIN_ARCH = "granite_moe_1b_a400m"  # 24 layers, d 1024, 32 experts top-8, moe_d_ff 512
B6_SHAPES = {"train_gate_up": (1024, 1024, 512), "train_down": (1024, 512, 1024),
             "decode_gate_up": (8, 1024, 512)}   # tokens (top-8 of 32 experts), K, N
B6_ZIPF = {"train_zipf_gate_up": (8192, 1024, 512)}  # rows in Zipf groups (zipf_sizes), K, N
DP_LAYERS, DP_STEPS = 4, 30     # lm_train_dp: qwen3-0.6b's widths at 4 of its 28 layers
DP_SEEDS = 2                    # lm_train_dp: int8 against uncompressed from this many seeds
PLACED_STEPS = 10               # lm_train_placed: qwen3-0.6b at full width and depth
PLACED_MOE_LAYERS = 4           # lm_train_placed: granite-moe-1b-a400m at 4 of its 24 layers
DP_RTOL = 1e-5                  # DP step vs one-member step: grad_norm (tests/test_torch_dp.py)


def b6_shape_cases(gen, device):
    """name → (lhs, rhs, sizes) at B6's timed shapes: ``B6_SHAPES`` (tokens
    routed top-8 over 32 experts) and ``B6_ZIPF`` (rows in Zipf groups, the
    largest about half of them)."""
    cases = {name: gmm_case(gen, device, tokens, k, n)
             for name, (tokens, k, n) in B6_SHAPES.items()}
    for name, (rows, k, n) in B6_ZIPF.items():
        cases[name] = gmm_arrays(gen, device, zipf_sizes(rows, 32, gen, device), k, n)
    return cases


def gmm_bwd_cases(gen, device):
    """name → (lhs, rhs, sizes, g): B3's cases (:func:`gmm_cases`), the
    training shapes of granite's backward (8192 rows: gate / up K 1024, N
    512; down K 512, N 1024), gate / up with a Zipf hot expert (half the
    rows on one group) and K 1000, N 520 (off the 128-wide tiles) with 29
    rows past the groups, each with a random cotangent g (M, N); the
    unaligned case's g is 4 bytes off a 16-byte boundary too."""
    import torch

    cases = dict(gmm_cases(gen, device))
    for name in ("train_gate_up", "train_down"):
        tokens, k, n = B6_SHAPES[name]
        cases[name] = gmm_case(gen, device, tokens, k, n)
    rows, k, n = B6_ZIPF["train_zipf_gate_up"]
    cases["train_zipf"] = gmm_arrays(gen, device, zipf_sizes(rows, 32, gen, device), k, n)
    cases["odd_tiles"] = gmm_case(gen, device, 300, 1000, 520, tail=29)
    out = {}
    for name, (lhs, rhs, sizes) in cases.items():
        m, n = lhs.shape[0], rhs.shape[2]
        off = 1 if name == "unaligned" else 0
        g = torch.randn(m * n + off, generator=gen, device=device)[off:].view(m, n)
        out[name] = (lhs, rhs, sizes, g)
    return out


def check_gmm_bwd(gm, lhs, rhs, sizes, g, label):
    """B6 against ``grouped_matmul_backward_plain`` on the same tensors:
    the wrapper (two launches) and the two launchers into outputs filled
    with NaN (every element written: they must equal the wrapper's
    outputs), each product within GMM_RTOL · its max|plain|, ``d_lhs``
    rows past Σ sizes and ``d_rhs`` of empty groups exactly 0.  Returns
    (|Δ| d_lhs, |Δ| d_rhs, max|plain| of each)."""
    import torch

    before = gm.grouped_matmul_backward.launches
    d_lhs, d_rhs = gm.grouped_matmul_backward(lhs, rhs, sizes, g)
    sync()
    check(gm.grouped_matmul_backward.launches == before + 2, f"{label}: not two launches")
    n_lhs = torch.full_like(lhs, float("nan"))
    n_rhs = torch.full_like(rhs, float("nan"))
    gm._launch_dlhs(g.contiguous(), rhs.contiguous(), sizes, n_lhs)
    gm._launch_drhs(lhs.contiguous(), g.contiguous(), sizes, n_rhs)
    sync()
    check(torch.equal(n_lhs, d_lhs) and torch.equal(n_rhs, d_rhs),
          f"{label}: a NaN-filled output kept a NaN or differs from the wrapper's")
    w_lhs, w_rhs = gm.grouped_matmul_backward_plain(lhs, rhs, sizes, g)
    out = []
    for what, got, want in (("d_lhs", d_lhs, w_lhs), ("d_rhs", d_rhs, w_rhs)):
        err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 0.0
        check(bool(torch.isfinite(got).all()) and err <= GMM_RTOL * scale,
              f"{label} {what}: max|Δ|={err} > {GMM_RTOL} · {scale}")
        out.append((err, scale))
    total = min(int(sizes.clamp(min=0).sum()), lhs.shape[0])
    check(not bool(d_lhs[total:].any()), f"{label}: d_lhs rows past Σ sizes not 0")
    check(not bool(d_rhs[sizes <= 0].any()), f"{label}: d_rhs of an empty group not 0")
    return out[0][0], out[1][0], out[0][1], out[1][1]


def phase2_grouped_matmul_backward(gm, gen, device):
    """B6 (``grouped_matmul_backward``: d_lhs and d_rhs on ``wgmma`` in
    3xTF32) against its plain version (a loop of float32 ``torch.matmul``
    per group, TF32 off) on :func:`gmm_bwd_cases` (:func:`check_gmm_bwd`);
    then ``grouped_matmul`` on CUDA tensors that require grad: its
    backward launches B6 twice and gives the plain gradients.  Returns the
    worst |Δ|."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    for name, (lhs, rhs, sizes, g) in gmm_bwd_cases(gen, device).items():
        e_l, e_r, s_l, s_r = check_gmm_bwd(gm, lhs, rhs, sizes, g,
                                           f"phase2 grouped_matmul_backward {name}")
        worst = max(worst, e_l, e_r)
        total = int(sizes.clamp(min=0).sum())
        log(f"phase2 grouped_matmul_backward {name}: M={lhs.shape[0]} K={lhs.shape[1]} "
            f"N={rhs.shape[2]}, groups {int((sizes > 0).sum())}/{sizes.numel()} non-empty, "
            f"{lhs.shape[0] - total} rows past them; d_lhs max|Δ|={e_l:.3g} (scale {s_l:.3g}), "
            f"d_rhs max|Δ|={e_r:.3g} (scale {s_r:.3g}); NaN-filled outputs written whole ok")
    lhs, rhs, sizes, g = gmm_bwd_cases(gen, device)["empty_groups"]
    a, b = lhs.clone().requires_grad_(True), rhs.clone().requires_grad_(True)
    before = gm.grouped_matmul_backward.launches
    got = torch.autograd.grad(gm.grouped_matmul(a, b, sizes), [a, b], g)
    sync()
    check(gm.grouped_matmul_backward.launches == before + 2,
          "phase2 grouped_matmul autograd: the backward did not launch B6 twice")
    for x, y in zip(got, gm.grouped_matmul_backward_plain(lhs, rhs, sizes, g)):
        check(float((x - y).abs().max()) <= GMM_RTOL * float(y.abs().max()),
              "phase2 grouped_matmul autograd: B6's gradient differs from the plain one")
    log("phase2 grouped_matmul autograd: CUDA inputs that require grad, backward on B6 "
        "(2 launches) within GMM_RTOL of the plain gradients ok")
    return worst


def moe_grad_check(moe, gm, sa, cfg, p_moe, h, gen):
    """Layer 0's MoE block differentiated at its own input in a training
    step (``h``, the step's ``ln_mlp`` of the post-attention residual, and
    ``p_moe``, the block's parameters, both captured by
    :func:`b6_step_device_ms`; 8192 routed rows for 8 × 128 tokens) at a
    fixed random cotangent of the output and of the aux loss, through the
    kernels (B3 forward, B6 backward, the segment kernel's histogram) and
    through the plain versions (``moe``'s two kernel names pointed at
    ``grouped_matmul_plain`` and ``segment_agg_plain``; the autograd node's
    backward is then autograd through the plain loop): every leaf (the
    input, the router, the three expert tensors) within GMM_RTOL · its
    max|grad|.  The block runs in float32 here (the captured bf16 input is
    exact in float32): under the step's bf16 casts, float32 rounding
    differences of 1e-7 between kernel and plain would flip bf16 roundings
    and hide a 1e-5 comparison.  Returns leaf → (|Δ|, max|grad|) and the
    B6 launches of the kernel pass."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tf

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    h = h.float()

    def grads():
        pm = tf.tree_map(lambda t: t.detach().to(torch.float32, copy=True).requires_grad_(True),
                         p_moe)
        hh = h.detach().clone().requires_grad_(True)
        out, aux = moe.moe_mlp_dense(pm, cfg32, hh)
        leaves = {"h": hh, "router": pm["router"]["w"], "w_gate": pm["w_gate"],
                  "w_up": pm["w_up"], "w_down": pm["w_down"]}
        gen.manual_seed(7)
        ct = torch.randn(out.shape, generator=gen, device=out.device)
        got = torch.autograd.grad((out, aux), list(leaves.values()), (ct, torch.ones_like(aux)))
        return dict(zip(leaves, got))

    before = gm.grouped_matmul_backward.launches
    got = grads()
    sync()
    b6 = gm.grouped_matmul_backward.launches - before
    kernels = moe.grouped_matmul, moe.segment_agg
    moe.grouped_matmul, moe.segment_agg = gm.grouped_matmul_plain, sa.segment_agg_plain
    try:
        want = grads()
    finally:
        moe.grouped_matmul, moe.segment_agg = kernels
    res = {}
    for k in want:
        err = float((got[k] - want[k]).abs().max())
        scale = float(want[k].abs().max())
        check(scale > 0 and err <= GMM_RTOL * scale,
              f"phase3 lm_train_moe: layer 0 gradient of {k} max|Δ|={err} > {GMM_RTOL} · {scale}")
        res[k] = (err, scale)
    return res, b6


def b6_step_device_ms(gm, moe, tloop, cfg, hp, params, opt, batch):
    """B6's device time in one training step: a step whose kernel launches
    are recorded (B6's two launchers and B3's, their operands and outputs
    kept), then each kernel's launches replayed from one CUDA graph into
    the same outputs, timed by events (the launches back to back, without
    the host work between them).  The step's first MoE block call (layer
    0's) is recorded too: its parameters and input, cloned before the
    step's update.  Returns (B6 ms, B6 launches, B3 ms, (layer 0's MoE
    parameters, its input))."""
    import torch

    from repro_torch.models import transformer as tf

    names = ("_launch_dlhs", "_launch_drhs", "_launch")
    real = {n: getattr(gm, n) for n in names}
    calls = {n: [] for n in names}
    real_block, layer0 = moe.moe_mlp_dense, []

    def recorder(n):
        def rec(*args):
            calls[n].append(args)
            return real[n](*args)
        return rec

    def block(p, c, h):
        if not layer0:
            layer0.append((tf.tree_map(lambda t: t.detach().clone(), p), h.detach().clone()))
        return real_block(p, c, h)

    for n in names:
        setattr(gm, n, recorder(n))
    moe.moe_mlp_dense = block
    try:
        tloop.make_train_step(cfg, hp)(params, opt, batch)
    finally:
        for n in names:
            setattr(gm, n, real[n])
        moe.moe_mlp_dense = real_block
    sync()

    def replay_b6():
        for n in ("_launch_dlhs", "_launch_drhs"):
            for args in calls[n]:
                real[n](*args)

    def replay_b3():
        for lhs, rhs, sizes in calls["_launch"]:
            real["_launch"](lhs.detach(), rhs.detach(), sizes)

    with torch.no_grad():
        ms = time_graph(replay_b6, calls=1, reps=3)
        b3_ms = time_graph(replay_b3, calls=1, reps=3)
    n = len(calls["_launch_dlhs"]) + len(calls["_launch_drhs"])
    del calls
    torch.cuda.empty_cache()
    return ms, n, b3_ms, layer0[0]


def phase3_lm_train_moe(kmods, device, seed):
    """MoE training on one member at granite-moe-1b-a400m's full width (24
    layers, d 1024, 32 experts top-8, vocab 49,155: 1.33 B float32
    parameters with AdamW moments, bf16 compute, random weights from a
    seeded card generator) through :func:`run_train_loop` (``train_loop``,
    ``SyntheticLM(batch=8, seq=128)``, TRAIN_STEPS steps, TRAIN_HP,
    ``ticketed_embedding``).  Gates: the shared ones (losses finite and
    falling, the stats plan, ``token_stats``); ``aux`` finite and > 0 every
    step; launches exactly, a step: B3 144 (3 a layer, forward and
    recompute), B6 144 (one a product, two a B3 call), the segment kernel
    48 (``route``'s histogram, forward and recompute),
    ticket 1 and B5 1 (the embedding's backward), and a batch the stats
    plan's ``scan_ticket`` 1 and segment 1; no other kernel; layer 0's MoE
    gradients through the kernels against the plain versions
    (:func:`moe_grad_check`).  Prints ms a step, tokens/s, peak MiB, and
    B6's and B3's device time in a step (:func:`b6_step_device_ms`).
    Returns the record."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.models import moe
    from repro_torch.train import loop as tloop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(MOE_TRAIN_ARCH)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    run = run_train_loop(kmods, cfg, device, seed, "lm_train_moe")
    params, launches, steps, batches = run["params"], run["launches"], run["steps"], run["batches"]
    layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    want = {k: 0 for k in kmods}
    want.update(grouped_matmul=FWD_RUNS * 3 * layers * steps,
                grouped_matmul_backward=6 * layers * steps,
                segment_agg=FWD_RUNS * layers * steps + batches, ticket_hash=steps,
                segment_rows=steps, scan_ticket=batches)
    check(launches == want, f"phase3 lm_train_moe: launches {launches}, expected {want} "
          f"({steps} steps, {batches} batches pulled)")
    aux = [h["aux"] for h in run["hist"]]
    check(all(math.isfinite(a) and a > 0 for a in aux),
          f"phase3 lm_train_moe: aux not finite and > 0 every step {aux}")
    tokens = run["pulled"][-1]
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    b6_ms, b6_launches, b3_ms, (p_moe, h) = b6_step_device_ms(gm, moe, tloop, cfg, run["hp"],
                                                              params, run["opt"], batch)
    check(b6_launches == 6 * layers,
          f"phase3 lm_train_moe: {b6_launches} B6 launches in the timed step")
    grad_res, b6_check = moe_grad_check(moe, gm, sa, cfg, p_moe, h, gen)
    check(b6_check == 6, f"phase3 lm_train_moe: the layer check launched B6 {b6_check} times, "
          "not 6")
    del p_moe, h
    ms = run["step_ms"]
    ntok = TRAIN_BATCH * TRAIN_SEQ
    rec = {**run["rec"], "aux": aux,
           "launches_per_step": {"grouped_matmul": FWD_RUNS * 3 * layers,
                                 "grouped_matmul_backward": 6 * layers,
                                 "segment_agg": FWD_RUNS * layers, "ticket_hash": 1,
                                 "segment_rows": 1},
           "b6_device_ms_per_step": b6_ms, "b3_device_ms_per_step": b3_ms,
           "b6_share_of_step": b6_ms / ms,
           "layer0_grad": {k: {"max_abs_err": e, "scale": sc} for k, (e, sc) in grad_res.items()}}
    log("phase3 " + json.dumps(rec))
    worst = max(e / sc for e, sc in grad_res.values())
    log(f"phase3 lm_train_moe: {cfg.name} at full width ({rec['params']} parameters, "
        f"{cfg.dtype} compute over float32), {steps} steps of {ntok} tokens: {ms:.2f} ms a step "
        f"(median; first {run['first_step_ms']:.1f} ms), {ntok / ms * 1e3:.0f} tokens/s, peak "
        f"{rec['peak_mib']:.0f} MiB ({rec['peak_over_held_mib']:.0f} over the "
        f"{rec['held_before_mib']:.0f} MiB earlier phases hold); loss {run['losses'][0]:.3f} -> "
        f"{run['losses'][-1]:.3f} (first 5 {run['first5']:.3f}, last 5 {run['last5']:.3f}); aux "
        f"{aux[0]:.4f} -> {aux[-1]:.4f}; launches a step: B3 {FWD_RUNS * 3 * layers} (forward "
        f"and recompute), B6 {6 * layers}, segment {FWD_RUNS * layers} (+1 a batch, stats), "
        f"ticket 1, B5 1; device time a step (graph replay): B6 {b6_ms:.2f} ms "
        f"({b6_ms / ms:.1%} of the step), B3 {b3_ms:.2f} ms; layer 0 "
        f"gradients kernels vs plain worst max|Δ|/max|g| {worst:.3g} ok; {card_line()}")
    del params, run
    torch.cuda.empty_cache()
    return rec


def run_steps(kmods, step, params, opt, batches):
    """``step`` over ``batches`` from ``(params, opt)``, a CUDA event at
    each step's start and one after the last, the launch counts set to 0
    just before and read just after.  Returns ``(params, opt, losses,
    step_ms sorted (the first step's left out), launches, wall s)``."""
    import torch

    events, hist = [], []
    sync()
    reset_launches(kmods)
    t0 = time.perf_counter()
    for b in batches:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)
        params, opt, m = step(params, opt, b)
        hist.append(m)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    events.append(end)
    losses = [float(m["loss"]) for m in hist]
    step_ms = sorted(events[i].elapsed_time(events[i + 1]) for i in range(1, len(batches)))
    return params, opt, losses, step_ms, launches, wall


def falling(losses, k=5) -> bool:
    """Every loss finite and the mean of the last ``k`` below the mean of
    the first ``k``."""
    import math

    return (all(math.isfinite(x) for x in losses)
            and sum(losses[-k:]) / k < sum(losses[:k]) / k)


def one_member_gate(tf, m_x, m_one, p_x, p_one, label):
    """The train_dp gate of a step against the one-member step: grad_norm
    within DP_RTOL, lr equal and > 0, the parameters within lr and a median
    1e-3 of it (the CPU tests' rule).  Returns the numbers compared."""
    import torch

    lr = float(m_one["lr"])
    gn_x, gn_one = float(m_x["grad_norm"]), float(m_one["grad_norm"])
    diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(tf._leaves(p_x),
                                                                tf._leaves(p_one))])
    dmax, dmed = float(diffs.max()), float(diffs.median())
    check(abs(gn_x - gn_one) <= DP_RTOL * gn_one and float(m_x["lr"]) == lr and lr > 0
          and dmax <= lr and dmed <= 1e-3 * lr,
          f"{label}: vs one-member step: grad_norm {gn_x} / {gn_one}, lr "
          f"{float(m_x['lr'])} / {lr}, params max|Δ| {dmax}, median {dmed}")
    return {"grad_norm": gn_x, "grad_norm_one": gn_one, "lr": lr,
            "params_max_abs_diff": dmax, "params_median_abs_diff": dmed}


def phase3_lm_train_dp(kmods, device, seed):
    """``make_manual_dp_step`` on the card as a (pod 2, data 2) mesh of four
    virtual members (``virtual_devices(4)``): qwen3-0.6b at its published
    widths (d 1024, vocab 151,936, tied) and DP_LAYERS of its 28 layers,
    bf16 compute over float32 parameters, ticketed embedding, int8
    gradient compression over the pod axis, DP_STEPS steps of
    ``SyntheticLM(batch=8, seq=128)`` (2 rows a member), peak lr 1e-3,
    warmup 2; then the uncompressed step over the same batches from the
    same parameters; then both again from a second seed's parameters and
    batches (DP_SEEDS), for the gap between their last losses.  The launch
    counts are set to 0 just before each run and read just after: one
    ticket and one B5 launch a member and step, no other kernel.  Gates:
    each loss curve finite and falling (the mean of its last 5 below the
    mean of its first 5).  Then, without
    compression and in float32, one step of the DP step against the
    one-member ``make_train_step`` on the whole batch (lr 1e-3 at step 0:
    warmup 0) under :func:`one_member_gate`.  Prints ms a step (CUDA
    events, median) and both loss curves.  Returns the record."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.train import loop as tloop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=DP_LAYERS)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    with sharding.virtual_devices(4) as members:
        mesh = sharding.make_mesh((2, 2), ("pod", "data"), devices=members)
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=DP_STEPS,
                            ticketed_embedding=True, grad_compression="int8")
    hp_f = dataclasses.replace(hp, grad_compression=None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_params(gen, cfg, device)
    p_f = tf.tree_map(lambda t: t.clone(), params)
    n_params = sum(t.numel() for t in tf._leaves(params))
    data = iter(SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed, track_stats=False,
                            device=device))
    batches = [next(data) for _ in range(DP_STEPS)]
    members_n = 4
    want = {k: 0 for k in kmods}
    want.update(ticket_hash=members_n * DP_STEPS, segment_rows=members_n * DP_STEPS)
    params, _, losses, step_ms, launches, wall = run_steps(
        kmods, tloop.make_manual_dp_step(mesh, cfg, hp), params, adamw.init(params), batches)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    check(launches == want, f"phase3 lm_train_dp: launches {launches}, expected {want}")
    check(falling(losses), f"phase3 lm_train_dp: int8 losses not finite and falling {losses}")
    ms = step_ms[len(step_ms) // 2]
    del params
    p_f, _, losses_f, step_ms_f, launches_f, _ = run_steps(
        kmods, tloop.make_manual_dp_step(mesh, cfg, hp_f), p_f, adamw.init(p_f), batches)
    check(launches_f == want, f"phase3 lm_train_dp: uncompressed launches {launches_f}, "
          f"expected {want}")
    check(falling(losses_f), f"phase3 lm_train_dp: uncompressed losses not finite and falling "
          f"{losses_f}")
    ms_f = step_ms_f[len(step_ms_f) // 2]
    del p_f
    gaps = [losses[-1] - losses_f[-1]]
    curves = [(losses, losses_f)]
    for s2 in range(1, DP_SEEDS):  # int8 against uncompressed from another seed
        g2 = torch.Generator(device=device).manual_seed(seed + 2 + 100 * s2)
        p8 = tf.init_params(g2, cfg, device)
        pf = tf.tree_map(lambda t: t.clone(), p8)
        d2 = iter(SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed + 100 * s2,
                              track_stats=False, device=device))
        b2 = [next(d2) for _ in range(DP_STEPS)]
        pair = []
        for hp_x, px in ((hp, p8), (hp_f, pf)):
            px, _, lx, _, lnx, _ = run_steps(kmods, tloop.make_manual_dp_step(mesh, cfg, hp_x),
                                             px, adamw.init(px), b2)
            check(lnx == want, f"phase3 lm_train_dp seed {s2}: launches {lnx}, expected {want}")
            check(falling(lx), f"phase3 lm_train_dp seed {s2} ({hp_x.grad_compression}): "
                  f"losses not finite and falling {lx}")
            pair.append(lx)
            del px
        curves.append(tuple(pair))
        gaps.append(pair[0][-1] - pair[1][-1])
        del p8, pf, b2

    # one uncompressed float32 step against the one-member step on the whole batch
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    hp32 = tloop.TrainHParams(peak_lr=1e-3, warmup=0, total_steps=DP_STEPS,
                              ticketed_embedding=True)
    p_dp = tf.init_params(gen, cfg32, device)
    p_one = tf.tree_map(lambda t: t.clone(), p_dp)
    o_dp, o_one = adamw.init(p_dp), adamw.init(p_one)
    p_dp, o_dp, m_dp = tloop.make_manual_dp_step(mesh, cfg32, hp32)(p_dp, o_dp, batches[0])
    p_one, o_one, m_one = tloop.make_train_step(cfg32, hp32)(p_one, o_one, batches[0])
    vs_one = one_member_gate(tf, m_dp, m_one, p_dp, p_one, "phase3 lm_train_dp: DP step")
    del p_dp, p_one, o_dp, o_one
    torch.cuda.empty_cache()
    ntok = TRAIN_BATCH * TRAIN_SEQ
    gap = gaps[0]
    rec = {"stream": "lm_train_dp", "arch": cfg.name, "layers": DP_LAYERS, "params": n_params,
           "mesh": {"pod": 2, "data": 2}, "grad_compression": "int8", "dtype": cfg.dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": DP_STEPS, "wall_s": wall,
           "step_ms": ms, "step_ms_range": [step_ms[0], step_ms[-1]],
           "tokens_per_s": ntok / ms * 1e3, "peak_mib": peak_mib, "losses": losses,
           "uncompressed": {"losses": losses_f, "step_ms": ms_f,
                            "step_ms_range": [step_ms_f[0], step_ms_f[-1]],
                            "launches": launches_f},
           "last_loss_gap_int8_minus_f32": gap, "last_loss_gaps_by_seed": gaps,
           "more_seeds": [{"losses": a, "uncompressed_losses": b} for a, b in curves[1:]],
           "vs_one_member": vs_one, "launches": launches, "card": card_line()}
    log("phase3 " + json.dumps(rec))
    log(f"phase3 lm_train_dp: {cfg.name} widths at {DP_LAYERS} layers ({n_params} parameters) "
        f"on a (pod 2, data 2) "
        f"mesh of 4 virtual members, int8 over pod: {DP_STEPS} steps of {ntok} tokens, "
        f"{ms:.2f} ms a step (median; uncompressed {ms_f:.2f} ms), {ntok / ms * 1e3:.0f} "
        f"tokens/s, peak {peak_mib:.0f} MiB; loss int8 {losses[0]:.3f} -> {losses[-1]:.3f}, "
        f"uncompressed {losses_f[0]:.3f} -> {losses_f[-1]:.3f} (last gap {gap:+.4f}); launches "
        f"a step: ticket 4, B5 4 (one a member); uncompressed float32 step vs one member on the "
        f"whole batch: grad_norm {vs_one['grad_norm']:.6g} / {vs_one['grad_norm_one']:.6g}, "
        f"params max|Δ| {vs_one['params_max_abs_diff']:.3g} (lr {vs_one['lr']:g}), median "
        f"{vs_one['params_median_abs_diff']:.3g} ok; {rec['card']}")
    for i, (a, b) in enumerate(curves):
        log(f"phase3 lm_train_dp seed {i} losses int8 " + " ".join(f"{x:.4f}" for x in a))
        log(f"phase3 lm_train_dp seed {i} losses f32  " + " ".join(f"{x:.4f}" for x in b))
    log("phase3 lm_train_dp last-loss gaps int8 - uncompressed by seed: "
        + " ".join(f"{g:+.4f}" for g in gaps))
    return rec


def placed_steps_vs_one(kmods, tf, sharding, tloop, cfg, hp, mesh, params, batches, label):
    """Placed steps (``jit_train_step`` on ``mesh``) from ``params``, each
    against the one-member ``make_train_step`` from the same state (the
    placed state gathered whole) under :func:`one_member_gate`.  The launch
    counts of the placed steps alone are summed.  Returns (the gate's
    numbers a step, the placed steps' launches)."""
    from repro_torch.optim import adamw

    opt = adamw.init(params)
    step = tloop.jit_train_step(mesh, cfg, hp, params, opt)(batches[0])
    one = tloop.make_train_step(cfg, hp)
    out, launches = [], {k: 0 for k in kmods}
    for i, b in enumerate(batches):
        p_one = tf.tree_map(lambda t: t.clone(), sharding.unplace(params))
        o_one = tf.tree_map(lambda t: t.clone(), sharding.unplace(opt))
        p_one, o_one, m_one = one(p_one, o_one, b)
        sync()
        reset_launches(kmods)
        params, opt, m = step(params, opt, b)
        sync()
        for k, v in read_launches(kmods).items():
            launches[k] += v
        out.append(one_member_gate(tf, m, m_one, sharding.unplace(params), p_one,
                                   f"{label} step {i + 1}"))
        del p_one, o_one
    return out, launches


def phase3_lm_train_placed(kmods, device, seed, one_member):
    """The placed training path on the card, three parts.

    1. ``train_loop`` of qwen3-0.6b at full width and depth (28 layers,
       bf16 compute over float32 parameters, random weights from a seeded
       card generator) on a (data 2, model 2) mesh of ``virtual_devices(4)``:
       the parameters placed by ``param_shardings``, the AdamW state as
       ``jit_train_step`` places it, PLACED_STEPS steps of
       ``SyntheticLM(batch=8, seq=128, track_stats=False)``, ticketed
       embedding, peak lr 1e-3, warmup 2.  The launch counts are set to 0
       just before ``train_loop`` and read just after: one ticket and one
       B5 launch a data-parallel member and step, no other kernel.  Gates:
       every loss finite, the mean of the last 5 below the mean of the
       first 5; the card holds one copy of each part (the placed elements
       equal the parameter count).
    2. In float32 with TF32 off, qwen3-0.6b's widths at DP_LAYERS layers on
       (data 2, model 2): one placed step against the one-member step on
       the whole batch (:func:`one_member_gate`, warmup 0).
    3. granite-moe-1b-a400m at its published widths, PLACED_MOE_LAYERS of
       its 24 layers, float32, on (data 2, model 2) (``moe/w_*`` placed
       ``("model", None, None)``): two placed steps, each against the
       one-member step from the same state under the same gate (so the
       load-balance loss of the two members is the whole batch's, as the
       one-member step's); B3 and B6 launched by the placed steps.

    Prints ms a step (CUDA events between step starts, median) and the
    peak MiB over what was held before, beside the one-member step's
    (``one_member``, phase 3 train's record), and the launch counts.  Each
    step's memory is read at its start, at the stage boundary
    (``_apply_update``'s entry: the gathered copies freed, the gradient sum
    held) and after the update, the card's peak counter reset at each:
    held and peak MiB of the gradient stage (gather, both members' forward
    and backward, the sum) and of the update stage (clip, AdamW); the last
    step's are printed.  Returns the record."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding
    from repro_torch.train import loop as tloop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    with sharding.virtual_devices(4) as members:
        mesh = sharding.make_mesh((2, 2), ("data", "model"), devices=members)
    hp = tloop.TrainHParams(peak_lr=1e-3, warmup=2, total_steps=PLACED_STEPS,
                            ticketed_embedding=True)
    data = SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed, track_stats=False,
                       device=device)
    events, stages = [], []
    jit_step = tloop.jit_train_step
    apply_update = tloop._apply_update

    def restart_peak():  # the peak so far kept in overall[0], the card's counter reset
        overall[0] = max(overall[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def staged_update(*a, **kw):
        mib = lambda b: b / 2 ** 20  # noqa: E731
        grads_peak, grads_held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        restart_peak()
        out = apply_update(*a, **kw)
        stages.append({"before_step_mib": mib(stages_start[0]),
                       "gradient_stage_peak_mib": mib(grads_peak),
                       "gradient_sum_held_mib": mib(grads_held),
                       "update_stage_peak_mib": mib(torch.cuda.max_memory_allocated()),
                       "after_update_mib": mib(torch.cuda.memory_allocated())})
        return out

    def timed_jit(*args, **kw):
        compile_step = jit_step(*args, **kw)

        def compiled(batch_tree):
            step = compile_step(batch_tree)

            def run(*a):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                events.append(e)
                restart_peak()
                stages_start[0] = torch.cuda.memory_allocated()
                return step(*a)

            return run

        return compiled

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_mib = torch.cuda.memory_allocated() / 2 ** 20
    stages_start, overall = [0], [0]
    tloop.jit_train_step = timed_jit
    tloop._apply_update = staged_update
    sync()
    reset_launches(kmods)
    t0 = time.perf_counter()
    try:
        params, opt, hist = tloop.train_loop(mesh, cfg, hp, iter(data), steps=PLACED_STEPS,
                                             params=tf.init_params(gen, cfg, device),
                                             log_every=1)
    finally:
        tloop.jit_train_step = jit_step
        tloop._apply_update = apply_update
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    peak_mib = max(overall[0], torch.cuda.max_memory_allocated()) / 2 ** 20
    events.append(end)
    steps = len(events) - 1
    check(steps == PLACED_STEPS and len(hist) == PLACED_STEPS,
          f"phase3 lm_train_placed: {steps} steps, {len(hist)} logged, expected {PLACED_STEPS}")
    losses = [h["loss"] for h in hist]
    check(falling(losses), f"phase3 lm_train_placed: losses not finite and falling {losses}")
    ndp = mesh.shape["data"]
    want = {k: 0 for k in kmods}
    want.update(ticket_hash=ndp * steps, segment_rows=ndp * steps)
    check(launches == want, f"phase3 lm_train_placed: launches {launches}, expected {want}")
    leaves = list(tf._leaves(params))
    n_params = sum(p.shape.numel() for p in leaves)
    held = sum(t.numel() for p in leaves for t in p.copies.values())
    table = params["embed"]["table"]
    check(held == n_params and len(table.copies) == mesh.shape["model"]
          and table.shard((0, 0)).data_ptr() == table.shard((1, 0)).data_ptr(),
          f"phase3 lm_train_placed: {held} elements placed for {n_params} parameters, "
          f"{len(table.copies)} copies of the table")
    step_ms = sorted(events[i].elapsed_time(events[i + 1]) for i in range(1, steps))
    ms = step_ms[len(step_ms) // 2]
    first_ms = events[0].elapsed_time(events[1])
    del params, opt, leaves, table
    torch.cuda.empty_cache()

    # 2. one float32 placed step against the one-member step (4 layers)
    cfg32 = dataclasses.replace(cfg, n_layers=DP_LAYERS, dtype="float32")
    hp32 = tloop.TrainHParams(peak_lr=1e-3, warmup=0, total_steps=PLACED_STEPS,
                              ticketed_embedding=True)
    batches = [next(iter(SyntheticLM(cfg32, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed + 1,
                                     track_stats=False, device=device)))]
    f32, _ = placed_steps_vs_one(kmods, tf, sharding, tloop, cfg32, hp32, mesh,
                                 tf.init_params(gen, cfg32, device), batches,
                                 "phase3 lm_train_placed float32")
    torch.cuda.empty_cache()

    # 3. granite-moe at 4 of 24 layers on (data 2, model 2): two placed steps
    mcfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH), n_layers=PLACED_MOE_LAYERS,
                               dtype="float32")
    moe_layers = sum(mcfg.is_moe_layer(i) for i in range(mcfg.n_layers))
    mdata = iter(SyntheticLM(mcfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed + 2,
                             track_stats=False, device=device))
    moe, moe_launches = placed_steps_vs_one(kmods, tf, sharding, tloop, mcfg, hp32, mesh,
                                            tf.init_params(gen, mcfg, device),
                                            [next(mdata), next(mdata)],
                                            "phase3 lm_train_placed granite")
    check(moe_launches["grouped_matmul"] == 2 * ndp * FWD_RUNS * 3 * moe_layers
          and moe_launches["grouped_matmul_backward"] == 2 * ndp * 6 * moe_layers
          and moe_launches["ticket_hash"] == 2 * ndp and moe_launches["segment_rows"] == 2 * ndp,
          f"phase3 lm_train_placed granite: launches {moe_launches} in two steps")
    torch.cuda.empty_cache()
    ntok = TRAIN_BATCH * TRAIN_SEQ
    rec = {"stream": "lm_train_placed", "arch": cfg.name, "params": n_params,
           "mesh": {"data": 2, "model": 2}, "dtype": cfg.dtype, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": steps, "wall_s": wall, "step_ms": ms,
           "first_step_ms": first_ms, "step_ms_range": [step_ms[0], step_ms[-1]],
           "tokens_per_s": ntok / ms * 1e3, "peak_mib": peak_mib, "held_before_mib": held_mib,
           "peak_over_held_mib": peak_mib - held_mib, "last_step_memory": stages[-1],
           "one_member_step_ms": one_member["step_ms"],
           "one_member_peak_over_held_mib": one_member["peak_over_held_mib"], "losses": losses,
           "float32_vs_one_member": f32, "granite_vs_one_member": moe,
           "granite_launches": moe_launches, "launches": launches, "card": card_line()}
    log("phase3 " + json.dumps(rec))
    log(f"phase3 lm_train_placed: {cfg.name} at full width ({n_params} parameters, {cfg.dtype} "
        f"compute over float32) on a (data 2, model 2) mesh of 4 virtual members, placed by "
        f"param_specs: {steps} steps of {ntok} tokens, {ms:.2f} ms a step (median; first "
        f"{first_ms:.1f} ms; one member {one_member['step_ms']:.2f} ms), {ntok / ms * 1e3:.0f} "
        f"tokens/s, peak {peak_mib - held_mib:.0f} MiB over the {held_mib:.0f} MiB held before "
        f"(one member {one_member['peak_over_held_mib']:.0f} MiB over its own); loss {losses[0]:.3f} -> {losses[-1]:.3f}; launches "
        f"a step: ticket {ndp}, B5 {ndp} (one a data member), no other kernel; float32 placed "
        f"step vs one member: grad_norm {f32[0]['grad_norm']:.6g} / "
        f"{f32[0]['grad_norm_one']:.6g}, params max|Δ| {f32[0]['params_max_abs_diff']:.3g} ok; "
        f"granite ({PLACED_MOE_LAYERS} layers, (data 2, model 2)) two steps vs one member: "
        f"max|Δ| {max(r['params_max_abs_diff'] for r in moe):.3g} (lr {moe[0]['lr']:g}), B3 "
        f"{moe_launches['grouped_matmul']}, B6 {moe_launches['grouped_matmul_backward']} ok; "
        f"{rec['card']}")
    st = stages[-1]
    log(f"phase3 lm_train_placed memory, last step: {st['before_step_mib']:.0f} MiB held before "
        f"it; gradient stage (gather, two members' forward and backward, the float32 sum) peak "
        f"{st['gradient_stage_peak_mib']:.0f} MiB, {st['gradient_sum_held_mib']:.0f} MiB held at "
        f"its end (gathered copy freed, gradient sum held); update stage peak "
        f"{st['update_stage_peak_mib']:.0f} MiB, {st['after_update_mib']:.0f} MiB after it; "
        f"{rec['card']}")
    return rec


# -- expert parallelism, serving over members and the launch CLIs: lm_ep,
# serve_members, launch ------------------------------------------------------------

EP_ARCH = "granite_moe_1b_a400m"  # 24 layers, d 1024, 32 experts top-8, moe_d_ff 512
EP_TS2_STEPS = 30               # lm_ep: moe_ts2 steps on (data 2, model 2)
EP_TIMED_STEPS = 3              # lm_ep: EP steps timed on (data 1, model 4)
EP_SLACK = 1.25                 # lm_ep: no-drop capacity over the dense step's largest group
EP_LOSS_RTOL = 5e-3             # lm_ep: EP vs dense step, loss (bf16 experts vs B3's float32)
EP_GNORM_RTOL = 5e-2            # lm_ep: EP vs dense step, grad_norm
SERVE_ARCHS = ("qwen3_0_6b", "granite_moe_1b_a400m")
SERVE_NEW = 16                  # serve_members: new tokens a request
SERVE_MARGIN = 0.25             # serve_members: top-2 logit margin under which a token may differ
LAUNCH_TRAIN_STEPS = 10         # launch: launch.train.main at qwen3-0.6b full width


def ep_mesh(shape, axes=("data", "model")):
    from repro_torch.parallel import sharding

    with sharding.virtual_devices(int(math.prod(shape))) as members:
        return sharding.make_mesh(shape, axes, devices=members)


def dropped_per_layer(records, layers, cap):
    """Rows past ``cap`` per layer from a step's ``router_stats`` records
    (each member's route, layer by layer): Σ over members and experts of
    max(0, count − cap)."""
    per = len(records) // layers
    return [int(sum(float((hist - cap).clamp(min=0).sum()) for hist, _ in
                    records[i * per:(i + 1) * per])) for i in range(layers)]


def phase3_lm_ep(kmods, device, seed, moe_rec):
    """Expert parallelism at granite-moe-1b-a400m's full width and depth (24
    layers, d 1024, 32 experts top-8, moe_d_ff 512, bf16 compute over
    float32 parameters, random weights from a seeded card generator) on
    virtual members of the card, five parts.

    1. ``make_train_step(moe_impl="ep")`` on (data 1, model 4), train_moe's
       batch (``SyntheticLM(batch=8, seq=128)``: 1024 tokens, 8192 routed
       rows), at a capacity that drops nothing: EP_SLACK × the largest
       expert group of the dense forward at that batch (printed), rounded
       up to 8, checked against every member's routed counts in the EP
       step.  From the same state, the EP step's loss within EP_LOSS_RTOL
       and grad_norm within EP_GNORM_RTOL of the dense step's (EP computes
       the experts in bf16, B3 in float32).  Then EP_TIMED_STEPS EP steps
       timed by CUDA events beside train_moe's dense step (``moe_rec``),
       with the card's peak MiB over what was held.
    2. The reference's ``moe_ts2`` setting on (data 2, model 2): token
       slice, int8 dispatch, the capacity of its ``_ep_info`` rule
       (``launch/dryrun.py`` ``_ep_info``), EP_TS2_STEPS steps from fresh weights:
       losses finite and the mean of the last 5 below the mean of the
       first 5; the rows dropped per layer of the first and last step.
    3. ``forward`` (2 × 64 tokens, (data 1, model 4)) and a cached prefill
       of 8 tokens plus 4 ``decode_step`` calls (batch 2, (data 2, model
       2), token slice) with EP against the dense path: logits max|Δ| /
       max|logit| < LM_REL.
    4. Launches, set to 0 just before each run and read just after: an EP
       step or forward launches the segment kernel once a member and
       layer (``route``; a training step twice, its recompute routes
       again), an EP training step ticket 1 and B5 1 (the ticketed
       embedding's backward), and nothing else; the dense step B3 144,
       B6 144, segment 48, ticket 1, B5 1.
    5. The members' expert stacks are views: each member's ``w_gate`` in
       an EP call lies in its layer stack's storage at rows r·E_local.
    Returns the record."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.dryrun import _ep_info
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.train import loop as tloop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(EP_ARCH)
    layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    hp = tloop.TrainHParams(total_steps=EP_TS2_STEPS, ticketed_embedding=True, **TRAIN_HP)
    data = iter(SyntheticLM(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed, track_stats=False,
                            device=device))
    batch = next(data)
    ntok = TRAIN_BATCH * TRAIN_SEQ
    none = {k: 0 for k in kmods}

    def launched(fn, *args, **kw):
        sync()
        reset_launches(kmods)
        out = fn(*args, **kw)
        sync()
        return out, read_launches(kmods)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_mib = torch.cuda.memory_allocated() / 2 ** 20
    params = tf.init_params(gen, cfg, device)
    # 1. capacity from the dense forward's largest expert group
    with torch.no_grad(), moe.router_stats() as recs:
        _, fl = launched(tf.forward, params, cfg, batch, ticketed_embedding=False)
    largest = max(int(h.max()) for h, _ in recs)
    del recs
    cap = int(math.ceil(largest * EP_SLACK / 8) * 8)
    check(fl == {**none, "grouped_matmul": 3 * layers, "segment_agg": layers},
          f"phase3 lm_ep: dense forward launches {fl}")
    mesh14 = ep_mesh((1, 4))
    info14 = {"mesh": mesh14, "dp": ("data",), "capacity_per_expert": cap}
    # the dense step and the EP step from the same state
    p_d = tf.tree_map(lambda t: t.clone(), params)
    (p_d, _, m_dense), ld = launched(tloop.make_train_step(cfg, hp), p_d, adamw.init(p_d), batch)
    m_dense = {k: float(v) for k, v in m_dense.items()}
    del p_d
    torch.cuda.empty_cache()
    check(ld == {**none, "grouped_matmul": FWD_RUNS * 3 * layers,
                 "grouped_matmul_backward": 6 * layers, "segment_agg": FWD_RUNS * layers,
                 "ticket_hash": 1, "segment_rows": 1},
          f"phase3 lm_ep: dense step launches {ld}")
    ep_step = tloop.make_train_step(cfg, hp, moe_impl="ep", ep_info=info14)
    opt = adamw.init(params)
    want_ep = {**none, "segment_agg": FWD_RUNS * 4 * layers, "ticket_hash": 1,
               "segment_rows": 1}
    with moe.router_stats() as recs:
        (params, opt, m_ep), le = launched(ep_step, params, opt, batch)
        ep_largest = max(int(h.max()) for h, _ in recs)
        n_recs = len(recs)
    del recs
    m_ep = {k: float(v) for k, v in m_ep.items()}
    check(n_recs == FWD_RUNS * 4 * layers and ep_largest <= cap,
          f"phase3 lm_ep: {n_recs} routes, largest EP group {ep_largest} > capacity {cap}")
    check(le == want_ep, f"phase3 lm_ep: EP step launches {le}, expected {want_ep}")
    d_loss = abs(m_ep["loss"] - m_dense["loss"]) / abs(m_dense["loss"])
    d_gn = abs(m_ep["grad_norm"] - m_dense["grad_norm"]) / m_dense["grad_norm"]
    check(math.isfinite(m_ep["loss"]) and d_loss <= EP_LOSS_RTOL and d_gn <= EP_GNORM_RTOL,
          f"phase3 lm_ep: EP step vs dense from the same state: loss {m_ep['loss']} / "
          f"{m_dense['loss']} (rel {d_loss:.3g} > {EP_LOSS_RTOL}?), grad_norm "
          f"{m_ep['grad_norm']} / {m_dense['grad_norm']} (rel {d_gn:.3g} > {EP_GNORM_RTOL}?)")
    batches = [next(data) for _ in range(EP_TIMED_STEPS)]
    params, opt, t_losses, t_ms, t_launches, _ = run_steps(kmods, ep_step, params, opt, batches)
    check(t_launches == {k: v * EP_TIMED_STEPS for k, v in want_ep.items()}
          and all(math.isfinite(x) for x in t_losses),
          f"phase3 lm_ep: timed EP steps launches {t_launches}, losses {t_losses}")
    ep_ms = t_ms[len(t_ms) // 2]
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    held_state_mib = torch.cuda.memory_allocated() / 2 ** 20
    # 5. the members' expert stacks are views of the layer stacks
    stack = params["layers"]["moe"]["w_gate"]
    seen = []
    real_ep = moe.moe_mlp_ep

    def spy(p_locals, *a, **kw):
        if not seen:
            seen.append([p["w_gate"] for p in p_locals])
        return real_ep(p_locals, *a, **kw)

    moe.moe_mlp_ep = spy
    try:
        toks = batches[0]["tokens"][:2, :64]
        with torch.no_grad():
            (ep_out, lf) = launched(tf.forward, params, cfg, {"tokens": toks},
                                    ticketed_embedding=False, moe_impl="ep", ep_info=info14)
    finally:
        moe.moe_mlp_ep = real_ep
    e_local = cfg.moe_experts_padded // 4
    views = [w.untyped_storage().data_ptr() == stack.untyped_storage().data_ptr()
             and w.data_ptr() == stack[0, r * e_local].data_ptr() for r, w in enumerate(seen[0])]
    check(all(views), f"phase3 lm_ep: member expert stacks not views of the layer stack {views}")
    check(lf == {**none, "segment_agg": 4 * layers}, f"phase3 lm_ep: EP forward launches {lf}")
    # 3. forward and decode with EP against dense
    with torch.no_grad():
        dense_out = tf.forward(params, cfg, {"tokens": toks}, ticketed_embedding=False)
        fwd_rel = float((ep_out.logits - dense_out.logits).abs().max()) / (
            float(dense_out.logits.abs().max()) + 1e-6)
        mesh22 = ep_mesh((2, 2))
        info_ts = {"mesh": mesh22, "dp": ("data",), "capacity_per_expert": cap,
                   "token_slice": True}
        c_ep = tf.init_caches(cfg, 2, 16, cfg.dtype, device=device)
        c_d = tf.init_caches(cfg, 2, 16, cfg.dtype, device=device)
        dec_rel, ld_ep = 0.0, dict(none)
        for a, b in ((0, 8), (8, 9), (9, 10), (10, 11), (11, 12)):
            (lg_ep, c_ep), l1 = launched(tf.decode_step, params, cfg, toks[:, a:b], c_ep,
                                         moe_impl="ep", ep_info=info_ts)
            lg_d, c_d = tf.decode_step(params, cfg, toks[:, a:b], c_d)
            dec_rel = max(dec_rel, float((lg_ep - lg_d).abs().max()) / (
                float(lg_d.abs().max()) + 1e-6))
            ld_ep = {k: ld_ep[k] + v for k, v in l1.items()}
    check(fwd_rel < LM_REL and dec_rel < LM_REL and bool(torch.isfinite(ep_out.logits).all()),
          f"phase3 lm_ep: EP vs dense logits: forward rel {fwd_rel}, decode rel {dec_rel}")
    check(ld_ep == {**none, "segment_agg": 5 * 4 * layers},
          f"phase3 lm_ep: EP decode launches {ld_ep}")
    n_params = sum(t.numel() for t in tf._leaves(params))
    del params, opt, batches, c_ep, c_d, ep_out, dense_out, seen, stack
    torch.cuda.empty_cache()
    # 2. moe_ts2 on (data 2, model 2): 30 steps from fresh weights
    # the dry run's moe_ts2 cell on (data 2, model 2): token slice, int8 dispatch,
    # capacity factor 1.0
    cell2 = ShapeCell("lm_ep", TRAIN_SEQ, TRAIN_BATCH, "train")
    info2 = _ep_info(mesh22, cfg, cell2, "moe_ts2")[0]
    cap2 = info2["capacity_per_expert"]
    params = tf.init_params(gen, cfg, device)
    ts2 = tloop.make_train_step(cfg, hp, moe_impl="ep", ep_info=info2)
    steps2 = [next(data) for _ in range(EP_TS2_STEPS)]
    drops = []

    def recorded(p, o, b):
        with moe.router_stats() as recs:
            out = ts2(p, o, b)
            drops.append(dropped_per_layer(recs[:len(recs) // FWD_RUNS], layers, cap2))
        return out

    params, opt, losses, ms2, l2, wall2 = run_steps(kmods, recorded, params, adamw.init(params),
                                                    steps2)
    want2 = {**none, "segment_agg": FWD_RUNS * 4 * layers * EP_TS2_STEPS,
             "ticket_hash": EP_TS2_STEPS,
             "segment_rows": EP_TS2_STEPS}
    check(l2 == want2, f"phase3 lm_ep moe_ts2: launches {l2}, expected {want2}")
    check(falling(losses), f"phase3 lm_ep moe_ts2: losses not finite and falling {losses}")
    ts2_ms = ms2[len(ms2) // 2]
    del params, opt, steps2
    torch.cuda.empty_cache()
    rec = {"stream": "lm_ep", "arch": cfg.name, "params": n_params, "dtype": cfg.dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "routed_rows": ntok * cfg.moe_top_k,
           "largest_dense_group": largest, "largest_ep_group": ep_largest, "capacity": cap,
           "dense_step": m_dense, "ep_step": m_ep, "loss_rel": d_loss, "grad_norm_rel": d_gn,
           "ep_step_ms": ep_ms, "ep_step_ms_range": [t_ms[0], t_ms[-1]],
           "dense_step_ms_train_moe": moe_rec["step_ms"], "peak_mib": peak_mib,
           "held_before_mib": held_mib, "peak_over_held_mib": peak_mib - held_mib,
           "held_with_state_mib": held_state_mib,
           "forward_rel": fwd_rel, "decode_rel": dec_rel, "stack_views": views,
           "moe_ts2": {"mesh": {"data": 2, "model": 2}, "capacity": cap2, "steps": EP_TS2_STEPS,
                       "losses": losses, "step_ms": ts2_ms, "step_ms_range": [ms2[0], ms2[-1]],
                       "wall_s": wall2, "dropped_first_step": drops[0],
                       "dropped_last_step": drops[-1], "launches": l2},
           "launches": {k: le[k] + t_launches[k] + lf[k] + ld_ep[k] + l2[k] + fl[k] + ld[k]
                        for k in kmods},
           "card": card_line()}
    log("phase3 " + json.dumps(rec))
    log(f"phase3 lm_ep: {cfg.name} at full width and depth ({n_params} parameters, {cfg.dtype} "
        f"compute over float32), EP on (data 1, model 4) virtual members, {ntok} tokens "
        f"({ntok * cfg.moe_top_k} routed rows), largest expert group {largest} (dense) / "
        f"{ep_largest} (EP), capacity {cap}: EP step vs dense from the same state loss "
        f"{m_ep['loss']:.5f} / {m_dense['loss']:.5f} (rel {d_loss:.3g}), grad_norm "
        f"{m_ep['grad_norm']:.5f} / {m_dense['grad_norm']:.5f} (rel {d_gn:.3g}); EP step "
        f"{ep_ms:.2f} ms (median of {EP_TIMED_STEPS}) beside train_moe's dense step "
        f"{moe_rec['step_ms']:.2f} ms; peak {peak_mib - held_mib:.0f} MiB over the "
        f"{held_mib:.0f} MiB held before; forward rel {fwd_rel:.4g}, decode rel {dec_rel:.4g} "
        f"< {LM_REL}; launches an EP step: segment {FWD_RUNS * 4 * layers} (one a member and "
        f"layer, forward and recompute), "
        f"ticket 1, B5 1, no B3 / B6; expert stacks are views ok; {rec['card']}")
    log(f"phase3 lm_ep moe_ts2: (data 2, model 2), token slice, int8 dispatch, capacity {cap2}, "
        f"{EP_TS2_STEPS} steps: loss {losses[0]:.3f} -> {losses[-1]:.3f}, {ts2_ms:.2f} ms a step "
        f"(median); rows dropped per layer, first step {drops[0]}, last step {drops[-1]} (of "
        f"{ntok * cfg.moe_top_k} routed rows); {rec['card']}")
    return rec


def phase3_serve_members(kmods, device, seed):
    """``ServeLoop`` over a (data 2, model 2) mesh of ``virtual_devices(4)``
    against the one-member loop, for qwen3-0.6b and granite-moe-1b-a400m
    at full width (their configs' bf16 compute over float32 parameters,
    random weights from a seeded card generator, the same for both
    loops): 8 requests of 4 + 3·i prompt tokens and SERVE_NEW new tokens,
    slots 8, max_len 128.  Gates: every request done; its tokens equal,
    or, at the first token where they differ, the one-member step's top-2
    logit margin for that row under SERVE_MARGIN (splitting the batch
    changes the GEMMs' shapes, and bf16 sums may round another way); the
    placed cache holds one copy a part (held elements = the cache's
    element count; ``length`` one tensor the four members share); launches
    a decode step over members: B3 72 and segment 24 a data member for
    granite, none for qwen3.  Then one ``jit_serve_step(seq_shard=True)``
    step at batch 1 against the one-member step: logits rel < LM_REL.
    Prints the decode step's ms (events, after the prefill) beside the
    one-member step's.  Returns the records."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding
    from repro_torch.serve.engine import Request, ServeLoop, jit_serve_step, make_serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh1 = sharding.make_mesh((1, 1), ("data", "model"), devices=[sharding.MeshDevice(0, device)])
    mesh22 = ep_mesh((2, 2))
    plen = max(LM_PROMPTS)
    recs = []
    for arch in SERVE_ARCHS:
        cfg = get_config(arch)
        moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)) \
            if cfg.moe_num_experts else 0
        gen = torch.Generator(device=device).manual_seed(seed + 6)
        torch.cuda.empty_cache()
        params = tf.init_params(gen, cfg, device)
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=device)
                   for n in LM_PROMPTS]
        runs = {}
        for name, mesh in (("one", mesh1), ("members", mesh22)):
            loop = ServeLoop(mesh, cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN)
            step, events, margins = loop.step_fn, [], []

            def counted(*args, step=step, events=events, margins=margins):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                events.append(e)
                out = step(*args)
                top = torch.topk(out[1][:, -1].float(), 2, dim=-1).values
                margins.append(top[:, 0] - top[:, 1])
                return out

            loop.step_fn = counted
            reqs = [Request(uid=i, prompt=p, max_new=SERVE_NEW) for i, p in enumerate(prompts)]
            sync()
            reset_launches(kmods)
            loop.run_batch(reqs)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            sync()
            launches = read_launches(kmods)
            steps = len(events)
            check(steps == plen + SERVE_NEW - 1 and all(r.done for r in reqs),
                  f"phase3 serve_members {arch} {name}: {steps} steps")
            per = 1 if name == "one" else 2
            want = {k: 0 for k in kmods}
            want.update(grouped_matmul=3 * moe_layers * steps * per,
                        segment_agg=moe_layers * steps * per)
            check(launches == want, f"phase3 serve_members {arch} {name}: launches {launches}, "
                  f"expected {want}")
            runs[name] = {"tokens": [r.generated for r in reqs], "launches": launches,
                          "decode_ms": events[plen].elapsed_time(end) / (steps - plen),
                          "margins": torch.stack(margins).cpu(), "loop": loop}
        one, mem = runs["one"], runs["members"]
        diffs = []
        for i, (a, b) in enumerate(zip(one["tokens"], mem["tokens"])):
            j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
            if j is not None:
                m = float(one["margins"][plen - 1 + j, i])
                diffs.append({"request": i, "first_diff": j, "margin": m})
                check(m < SERVE_MARGIN, f"phase3 serve_members {arch}: request {i} differs at "
                      f"token {j} where the one-member margin is {m} >= {SERVE_MARGIN}")
        caches = mem["loop"].caches
        leaves = []
        sharding._map_with_path(lambda path, leaf: leaves.append(leaf), caches)
        held = sum(t.numel() for leaf in leaves for t in leaf.copies.values())
        count = sum(leaf.shape.numel() for leaf in leaves)
        length = caches.length
        check(held == count and len(length.copies) == 1
              and length.shard((0, 0)).data_ptr() == length.shard((1, 1)).data_ptr(),
              f"phase3 serve_members {arch}: {held} cache elements held for {count}")
        # one seq_shard step at batch 1
        one_c = tf.init_caches(cfg, 1, LM_MAX_LEN, cfg.dtype, device=device)
        seq_step = jit_serve_step(mesh22, cfg, mem["loop"].params, one_c, seq_shard=True)
        tok = prompts[0][:1].reshape(1, 1).to(torch.int32)
        nxt, lg, placed = seq_step(mem["loop"].params, tok, one_c)
        o_nxt, o_lg, _ = make_serve_step(cfg)(params, tok, tf.init_caches(
            cfg, 1, LM_MAX_LEN, cfg.dtype, device=device))
        seq_rel = float((lg - o_lg).abs().max()) / (float(o_lg.abs().max()) + 1e-6)
        check(seq_rel < LM_REL and placed.k.sharding.spec[2] == ("data", "model"),
              f"phase3 serve_members {arch}: seq_shard step rel {seq_rel}")
        rec = {"stream": f"serve_members_{arch}", "arch": cfg.name, "mesh": {"data": 2,
               "model": 2}, "slots": LM_SLOTS, "prompts": LM_PROMPTS, "max_new": SERVE_NEW,
               "decode_ms_one": one["decode_ms"], "decode_ms_members": mem["decode_ms"],
               "token_diffs": diffs, "cache_elements": count, "cache_held": held,
               "seq_shard_rel": seq_rel, "seq_shard_next_equal": bool(torch.equal(nxt, o_nxt)),
               "launches_one": one["launches"], "launches_members": mem["launches"],
               "launches": {k: one["launches"][k] + mem["launches"][k] for k in kmods},
               "card": card_line()}
        recs.append(rec)
        log("phase3 " + json.dumps(rec))
        log(f"phase3 serve_members: {cfg.name} at full width, {LM_SLOTS} requests × {SERVE_NEW} "
            f"tokens on (data 2, model 2) virtual members: decode {mem['decode_ms']:.2f} ms a "
            f"step beside one member's {one['decode_ms']:.2f} ms; tokens equal in "
            f"{LM_SLOTS - len(diffs)} of {LM_SLOTS} requests, the rest under a {SERVE_MARGIN} "
            f"margin {diffs}; cache {held} elements held for {count}; seq_shard step at batch "
            f"1 rel {seq_rel:.4g}; launches a step over members: B3 {6 * moe_layers}, "
            f"segment {2 * moe_layers}; {rec['card']}")
        del params, runs, one, mem, caches, leaves, length, placed, seq_step
        torch.cuda.empty_cache()
    return recs


def phase3_launch(kmods, device, seed):
    """The launch CLIs through their ``main(argv)`` on ``virtual_devices(4)``:
    ``launch.serve.main`` with qwen3-0.6b at full width (8 requests, 16 new
    tokens, slots 4: a (data 4, model 1) mesh), its closing line printed
    and every request done; ``launch.train.main`` with qwen3-0.6b at full
    width for LAUNCH_TRAIN_STEPS steps (the placed step over 4 data
    members; the loss logged at the last step finite; launches ticket and
    B5 one a data member and step, scan_ticket and segment one a batch
    for ``SyntheticLM``'s stats plan), then with the reduced config for 4
    steps committing every 2 and again with ``--elastic`` to step 6 from
    that commit (the manager's latest commit 6).  Returns the record."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.parallel import sharding

    recs = {}
    with sharding.virtual_devices(4), tempfile.TemporaryDirectory() as d:
        out = io.StringIO()
        sync()
        reset_launches(kmods)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            served = lserve.main(["--arch", "qwen3_0_6b", "--requests", "8", "--max-new", "16"])
        serve_s = time.perf_counter() - t0
        ls = read_launches(kmods)
        line = out.getvalue().strip().splitlines()[-1]
        check(len(served) == 8 and all(r.done and len(r.generated) == 16 for r in served)
              and line.startswith("served 8 requests, 128 tokens in ")
              and ls == {k: 0 for k in kmods},
              f"phase3 launch serve: {len(served)} served, line {line!r}, launches {ls}")
        log(f"phase3 launch serve: {line}")
        del served
        torch.cuda.empty_cache()
        out = io.StringIO()
        sync()
        reset_launches(kmods)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            params, opt, hist = ltrain.main(["--arch", "qwen3_0_6b", "--steps",
                                             str(LAUNCH_TRAIN_STEPS), "--ckpt-dir", d + "/full",
                                             "--ckpt-every", "1000"])
        train_s = time.perf_counter() - t0
        lt = read_launches(kmods)
        n = LAUNCH_TRAIN_STEPS
        want = {k: 0 for k in kmods}
        want.update(ticket_hash=4 * n, segment_rows=4 * n, scan_ticket=n + 1,
                    segment_agg=n + 1)
        check(len(hist) == 1 and math.isfinite(hist[0]["loss"]) and lt == want,
              f"phase3 launch train: logged {hist}, launches {lt}, expected {want}")
        log("phase3 launch train: " + out.getvalue().strip().splitlines()[-1])
        del params, opt
        torch.cuda.empty_cache()
        small = ["--arch", "qwen3_0_6b", "--reduced", "--ckpt-dir", d + "/small",
                 "--ckpt-every", "2"]
        with contextlib.redirect_stdout(io.StringIO()):
            ltrain.main(small + ["--steps", "4"])
            _, opt_e, _ = ltrain.main(small + ["--steps", "6", "--elastic"])
        latest = CheckpointManager(d + "/small").latest_step()
        check(latest == 6 and int(opt_e.step.full("cpu")) == 6,
              f"phase3 launch train --elastic: latest commit {latest}")
        recs = {"stream": "launch", "serve_line": line, "serve_s": serve_s,
                "train_loss": hist[0]["loss"], "train_sec_per_step": hist[0]["sec_per_step"],
                "train_s": train_s, "train_launches": lt, "elastic_latest_commit": latest,
                "launches": {k: ls[k] + lt[k] for k in kmods}, "card": card_line()}
    log("phase3 " + json.dumps(recs))
    log(f"phase3 launch: serve.main qwen3-0.6b on 4 virtual members in {serve_s:.1f} s; "
        f"train.main {LAUNCH_TRAIN_STEPS} steps at full width in {train_s:.1f} s (loss "
        f"{hist[0]['loss']:.3f} at step {n}, {hist[0]['sec_per_step']:.3f} s a step); reduced "
        f"--elastic resumed to commit {latest}; {recs['card']}")
    return recs


# -- per-layer remat: lm_remat, lm_remat_families --------------------------------------

REMAT_BATCH, REMAT_SEQ, REMAT_STEPS = 4, 4096, 3   # train_4k's sequence; 4 of a member's 16 rows
FAMILY_BATCH, FAMILY_TEXT = 2, 256  # remat_families: rows, text tokens (after a vision prefix)
FAMILY_RTOL = 1e-5              # remat vs direct-call gradients: max|Δ| <= FAMILY_RTOL · max|g| a leaf


@contextlib.contextmanager
def direct_blocks(tf):
    """A context in which ``transformer._remat`` returns the block itself:
    the stacks call their blocks directly, as before remat (this script's
    comparison only; the package has no such switch)."""
    real = tf._remat
    tf._remat = lambda block, policy=None: block
    try:
        yield
    finally:
        tf._remat = real


def predicted_step(kmods, cfg, hp, batch, seq, *, direct=False):
    """The dry run of ``make_train_step(cfg, hp)`` on one member at
    ``batch`` × ``seq`` tokens (meta tensors under ``CostMode``), with the
    blocks rematerialised or, with ``direct``, called directly.  No kernel
    may launch.  Returns the trace's dict and its seconds."""
    import torch

    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import specs as sp
    from repro_torch.models import transformer as tf
    from repro_torch.train import loop as tloop

    meta = torch.device("meta")
    params = sp.abstract_params(cfg)
    toks = {k: torch.empty((batch, seq), dtype=torch.int32, device=meta)
            for k in ("tokens", "targets")}
    args = (params, sp.abstract_opt(params), toks)
    reset_launches(kmods)
    t0 = time.perf_counter()
    with direct_blocks(tf) if direct else contextlib.nullcontext():
        pred = dr.trace(dr.CellStep(tloop.make_train_step(cfg, hp), args, dr._tensors(args), [],
                                    1, 0, 0))
    secs = time.perf_counter() - t0
    check(read_launches(kmods) == {k: 0 for k in kmods},
          f"dryrun {cfg.name}: the meta trace launched kernels {read_launches(kmods)}")
    return pred, secs


def phase3_lm_remat(kmods, device, seed):
    """qwen3-0.6b at published widths and depth (28 layers) on one member,
    TRAIN_HP, ticketed embedding, bf16 compute over float32 parameters and
    AdamW moments: REMAT_STEPS ``make_train_step`` steps of REMAT_BATCH ×
    REMAT_SEQ tokens (``SyntheticLM`` batches; train_4k's sequence, 4 of a
    16 × 16 member's 16 rows), which fit one card only because each block
    is rematerialised.  The dry run of the same step predicts the peak
    first, with remat and with the blocks called directly.  Launches, set
    to 0 just before the steps and read just after: ticket 1 and B5 1 a
    step, nothing else.  Gates: every loss finite; the card's
    ``max_memory_allocated`` over what was held before the parameters
    within DRYRUN_PEAK_RANGE of the prediction; the direct-call prediction
    over the card's 80 GB (H100_HBM_BYTES).  Prints both predictions, the
    card's peak, the steps' ms (the first left out), the roofline terms of
    the predicted work and the card's name and power limit.  Returns the
    record."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import roofline
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train import loop as tloop

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    hp = tloop.TrainHParams(total_steps=TRAIN_STEPS, ticketed_embedding=True, **TRAIN_HP)
    pred, trace_s = predicted_step(kmods, cfg, hp, REMAT_BATCH, REMAT_SEQ)
    pred_direct, _ = predicted_step(kmods, cfg, hp, REMAT_BATCH, REMAT_SEQ, direct=True)
    peak, peak_direct = pred["memory"]["peak_bytes"], pred_direct["memory"]["peak_bytes"]
    check(peak_direct > roofline.H100_HBM_BYTES,
          f"phase3 lm_remat: without remat the step predicts {peak_direct / 2 ** 30:.1f} GiB, "
          f"which fits the card: the phase would not need remat")

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tf.init_params(gen, cfg, device)
    opt = adamw.init(params)
    data = iter(SyntheticLM(cfg, batch=REMAT_BATCH, seq=REMAT_SEQ, seed=seed, track_stats=False,
                            device=device))
    batches = [next(data) for _ in range(REMAT_STEPS)]
    step = tloop.make_train_step(cfg, hp)
    sync()
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, step_ms, launches, wall = run_steps(kmods, step, params, opt, batches)
    card_peak = torch.cuda.max_memory_allocated() - held
    del params, opt, batches, step, data
    torch.cuda.empty_cache()
    want = {k: 0 for k in kmods}
    want.update(ticket_hash=REMAT_STEPS, segment_rows=REMAT_STEPS)
    check(launches == want, f"phase3 lm_remat: launches {launches}, expected {want}")
    check(all(math.isfinite(x) for x in losses), f"phase3 lm_remat: a loss is not finite {losses}")
    lo, hi = DRYRUN_PEAK_RANGE
    check(lo <= peak / card_peak <= hi,
          f"phase3 lm_remat: predicted peak {peak / 2 ** 30:.2f} GiB vs the card's "
          f"{card_peak / 2 ** 30:.2f} GiB over what was held")
    ms = step_ms[len(step_ms) // 2]
    flops, nbytes = pred["cost"]["flops"], pred["cost"]["bytes accessed"]
    terms = {"compute": flops / roofline.H100_PEAK_FLOPS_BF16 * 1e3,
             "memory": nbytes / roofline.H100_HBM_BW * 1e3}
    tokens = REMAT_BATCH * REMAT_SEQ
    rec = {"stream": "lm_remat", "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "batch": REMAT_BATCH, "seq": REMAT_SEQ, "steps": REMAT_STEPS, "losses": losses,
           "step_ms": ms, "step_ms_sorted": step_ms, "wall_s": wall,
           "tokens_per_s": tokens / ms * 1e3, "predicted_peak_gib": peak / 2 ** 30,
           "predicted_peak_direct_gib": peak_direct / 2 ** 30,
           "card_peak_gib": card_peak / 2 ** 30, "peak_ratio": peak / card_peak,
           "held_before_gib": held / 2 ** 30, "predicted_flops": flops,
           "predicted_flops_direct": pred_direct["cost"]["flops"], "terms_ms": terms,
           "trace_s": trace_s, "launches": launches, "card": card_line()}
    log("phase3 " + json.dumps(rec))
    log(f"phase3 lm_remat: {cfg.name} at full width and depth ({cfg.n_layers} layers, {cfg.dtype} "
        f"compute over float32), {REMAT_STEPS} steps of {REMAT_BATCH} x {REMAT_SEQ} tokens: "
        f"{ms:.2f} ms a step (median of steps 2-{REMAT_STEPS}; {step_ms}), "
        f"{tokens / ms * 1e3:.0f} tokens/s; loss {losses[0]:.3f} -> {losses[-1]:.3f}; peak "
        f"{card_peak / 2 ** 30:.2f} GiB max_memory_allocated over the {held / 2 ** 30:.2f} GiB "
        f"held before, predicted {peak / 2 ** 30:.2f} GiB with remat (x{peak / card_peak:.3f}) "
        f"and {peak_direct / 2 ** 30:.2f} GiB with the blocks called directly (over the card's "
        f"{roofline.H100_HBM_BYTES / 1e9:.0f} GB); predicted FLOPs {flops:.4e} (direct "
        f"{pred_direct['cost']['flops']:.4e}, x{flops / pred_direct['cost']['flops']:.3f}), "
        f"roofline compute {terms['compute']:.1f} ms, memory {terms['memory']:.1f} ms; "
        f"launches a step: ticket 1, B5 1; trace {trace_s:.1f} s; {card_line()}")
    return rec


def family_config(arch):
    """``arch`` at its published widths with the depth cut for
    remat_families: 2 layers; zamba2 one super-block (``attn_every``
    layers: the Mamba2 blocks and the shared attention block); seamless 2
    encoder and 2 decoder layers."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.attn_every)
    if cfg.encoder_layers:
        return dataclasses.replace(cfg, n_layers=2, encoder_layers=2)
    return dataclasses.replace(cfg, n_layers=2)


def phase3_lm_remat_families(kmods, device, seed):
    """Every config's training path on the card at published widths and
    cut depth (:func:`family_config`), one ``SyntheticLM`` batch of
    FAMILY_BATCH rows × FAMILY_TEXT tokens (a vision config's
    ``frontend_tokens`` patch positions before them; ``frontend_embeds``
    and ``encoder_frames`` from its extras): the float32 gradients of
    ``lm_loss`` with the blocks rematerialised and called directly, in the
    same process, every leaf within FAMILY_RTOL of its max|g|; then one
    ``make_train_step`` step in the config's dtype (TRAIN_HP, ticketed
    embedding), its loss and gradient norm finite.  Launches, set to 0
    just before each run and read just after: ticket 1 and B5 1 a run; a
    MoE layer B3 6, B6 6 and the segment kernel 2 under remat (3, 6 and 1
    called directly).
    Prints the family, the layers, the step ms and, for the MoE configs,
    B3's and B6's launches.  Returns the record."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import ARCH_IDS
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train import loop as tloop

    torch.backends.cuda.matmul.allow_tf32 = False
    none = {k: 0 for k in kmods}
    total = dict(none)
    rows = []
    hp = tloop.TrainHParams(total_steps=TRAIN_STEPS, ticketed_embedding=True, **TRAIN_HP)

    def launched(fn, *args):
        sync()
        reset_launches(kmods)
        out = fn(*args)
        sync()
        return out, read_launches(kmods)

    for i, arch in enumerate(ARCH_IDS):
        cfg = family_config(arch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        seq = FAMILY_TEXT + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
        gen = torch.Generator(device=device).manual_seed(seed + i)
        params = tf.init_params(gen, cfg, device)
        batch = next(iter(SyntheticLM(cfg, batch=FAMILY_BATCH, seq=seq, seed=seed + i,
                                      track_stats=False, device=device)))

        def grads():
            tree = tf.tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss, _ = tf.lm_loss(tree, cfg32, batch, ticketed_embedding=True)
            return float(loss.detach()), torch.autograd.grad(loss, list(tf._leaves(tree)))

        (loss_r, g_r), l_r = launched(grads)
        with direct_blocks(tf):
            (loss_d, g_d), l_d = launched(grads)
        worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(g_r, g_d))
        del g_r, g_d
        torch.cuda.empty_cache()
        step = tloop.make_train_step(cfg, hp)
        opt = adamw.init(params)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        (params, opt, m), l_s = launched(step, params, opt, batch)
        e1.record()
        sync()
        step_ms, step_loss, step_gn = e0.elapsed_time(e1), float(m["loss"]), float(m["grad_norm"])
        del params, opt, m, step, batch
        torch.cuda.empty_cache()
        moe = sum(cfg.is_moe_layer(j) for j in range(cfg.n_layers)) if cfg.moe_num_experts else 0
        want_r = dict(none, ticket_hash=1, segment_rows=1)
        want_d = dict(want_r)
        if moe:
            want_r.update(grouped_matmul=FWD_RUNS * 3 * moe, grouped_matmul_backward=6 * moe,
                          segment_agg=FWD_RUNS * moe)
            want_d.update(grouped_matmul=3 * moe, grouped_matmul_backward=6 * moe,
                          segment_agg=moe)
        check(l_r == want_r and l_s == want_r and l_d == want_d,
              f"phase3 lm_remat_families {arch}: launches remat {l_r}, direct {l_d}, step "
              f"{l_s}; expected {want_r} (remat, step) and {want_d} (direct)")
        check(math.isfinite(loss_r) and math.isfinite(step_loss) and math.isfinite(step_gn)
              and worst <= FAMILY_RTOL,
              f"phase3 lm_remat_families {arch}: loss {loss_r} / direct {loss_d}, step loss "
              f"{step_loss}, grad_norm {step_gn}; remat vs direct gradients rel max|d| "
              f"{worst:.3g} > {FAMILY_RTOL}?")
        for k in kmods:
            total[k] += l_r[k] + l_s[k]
        row = {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
               "encoder_layers": cfg.encoder_layers, "batch": FAMILY_BATCH, "seq": seq,
               "loss_remat": loss_r, "loss_direct": loss_d, "grad_rel": worst,
               "step_loss": step_loss, "step_grad_norm": step_gn, "step_ms": step_ms}
        if moe:
            row["b3_b6"] = {"remat": [l_r["grouped_matmul"], l_r["grouped_matmul_backward"]],
                            "direct": [l_d["grouped_matmul"], l_d["grouped_matmul_backward"]]}
        rows.append(row)
        log(f"phase3 lm_remat_families {arch}: family {cfg.family}, {cfg.n_layers} layers"
            + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
            + f", {FAMILY_BATCH} x {seq} tokens: remat vs direct float32 gradients rel max|d| "
            f"{worst:.3g} (loss {loss_r:.6f} / {loss_d:.6f}); one {cfg.dtype} step {step_ms:.2f} "
            f"ms, loss {step_loss:.4f}, grad_norm {step_gn:.4f}"
            + (f"; B3 / B6 launches {l_r['grouped_matmul']} / {l_r['grouped_matmul_backward']} "
               f"under remat, {l_d['grouped_matmul']} / {l_d['grouped_matmul_backward']} direct"
               if moe else ""))
    rec = {"stream": "lm_remat_families", "configs": rows, "launches": total,
           "card": card_line()}
    log("phase3 " + json.dumps(rec))
    log(f"phase3 lm_remat_families: {len(rows)} configs, worst remat vs direct rel max|d| "
        f"{max(r['grad_rel'] for r in rows):.3g} <= {FAMILY_RTOL}; {card_line()}")
    return rec


# -- every config's serving path: lm_serve_families -------------------------------------

SERVE_ROWS, SERVE_DECODE = 2, 48   # serve_families (a): rows, tokens decoded one at a time
WINDOW_ARCHS = ("gemma2_2b", "zamba2_1_2b")  # (b): one cached prefill past the sliding window
WINDOW_PAST, WINDOW_STEPS = 64, 8  # (b): window + 64 prefilled tokens (4160), then 8 decode steps
RAGGED_ARCHS = ("rwkv6_1_6b", "zamba2_1_2b")  # (b): a cached prefill seeded from the cache
RAGGED_PREFILL = 300            # (b): not a multiple of the 128-step chunk (ROADMAP §3 fault 14)
TWOBUF_ARCHS = ("qwen3_0_6b", "qwen2_moe_a2_7b")  # the dense and moe families the two-buffer path takes
TWOBUF_PREFIX, TWOBUF_STEPS = 64, 8
FLOAT32_GATED_ARCHS = ("qwen2_moe_a2_7b",)  # (a) and two-buffer gates at float32 (fault 15)
FULL_DEPTH_ARCHS = ("rwkv6_1_6b", "zamba2_1_2b")  # launch.serve.main at published depth


def serve_config(arch):
    """``arch`` at its published widths with the depth cut for
    serve_families: 2 layers; zamba2 ``attn_every + 2`` (one super-block of
    Mamba2 blocks and the shared attention block, then a two-block Mamba2
    tail, so ``tail_ssm`` runs); seamless 2 encoder and 2 decoder layers."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.attn_every + 2)
    if cfg.encoder_layers:
        return dataclasses.replace(cfg, n_layers=2, encoder_layers=2)
    return dataclasses.replace(cfg, n_layers=2)


def int8_prefix_bound(layers, sigma):
    """The int8 two-buffer gate, from KV_Q8_SCALE's rounding (PERF.md §6):
    an int8 prefix element is s·round(x / s), an error uniform on
    ±s/2 of RMS e = s / √12 (none clamped while |x| <= 127.5·s).  In the
    first-order model the K and V roundings each move an attention layer's
    output by at most e / σ of its RMS, σ the smaller RMS of the prefix's K
    and V, and q's per-head rounding to 127 levels of its max by at most e
    (its step over its RMS is under s while that max is under 6.35 RMS);
    over ``layers`` layers they add up undamped, and the ratio of two maxima
    over the logits takes a factor 2: 6 · layers · e / min(σ, 1)."""
    from repro_torch.models.attention import KV_Q8_SCALE

    return 6 * layers * (KV_Q8_SCALE / math.sqrt(12)) / min(sigma, 1.0)


def rel_by_position(dec, full):
    """max|dec − full| / max|full| over rows and vocabulary, a value per
    position (the reference's rule, ``tests/test_models.py:95-97``, at every
    position)."""
    return ((dec.float() - full.float()).abs().amax(dim=(0, 2))
            / (full.float().abs().amax(dim=(0, 2)) + 1e-6))


def serve_inputs(cfg, rows, text, gen, device):
    """Tokens (rows, F + text) and the extras ``forward`` takes: a vision
    config's ``frontend_embeds`` for its F = ``frontend_tokens`` patch
    positions, an enc-dec config's ``encoder_frames`` over ``text`` frames
    (0.02 · N(0, 1), as ``SyntheticLM``)."""
    import torch

    f = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, f + text), generator=gen,
                                     device=device, dtype=torch.int32)}
    if f:
        batch["frontend_embeds"] = 0.02 * torch.randn(rows, f, cfg.d_model, generator=gen,
                                                      device=device)
    if cfg.encoder_layers:
        batch["encoder_frames"] = 0.02 * torch.randn(rows, text, cfg.d_model, generator=gen,
                                                     device=device)
    return batch, f


@contextlib.contextmanager
def recorded_routes(moe):
    """A context in which every ``moe.route`` call also appends its expert
    ids, sorted along top-k, to the yielded list (this script's diagnostic:
    where two runs route a token otherwise)."""
    real, seen = moe.route, []

    def route(p, cfg, x2d):
        out = real(p, cfg, x2d)
        seen.append(out.experts.sort(dim=-1).values)
        return out

    moe.route = route
    try:
        yield seen
    finally:
        moe.route = real


def rerouted_positions(fwd, dec, rows, layers):
    """The positions at which the token-by-token decode's routes (``dec``:
    a step's layers in order, each (rows, k)) differ from ``forward``'s
    (``fwd``: a (rows · S, k) list a layer) in some layer and row."""
    import torch

    if not fwd:
        return []
    full = torch.stack([f.reshape(rows, -1, f.shape[-1]) for f in fwd])  # (L, rows, S, k)
    steps = len(dec) // layers
    got = torch.stack([torch.stack(dec[i * layers:(i + 1) * layers]) for i in range(steps)], 2)
    off = full.shape[2] - steps
    differ = (got != full[:, :, off:]).any(dim=-1).any(dim=0).any(dim=0)
    return [off + int(i) for i in differ.nonzero().flatten()]


def serve_decode_vs_forward(tf, params, cfg, gen, device, extra, batch=None):
    """(a): SERVE_DECODE tokens decoded one at a time after a vision
    config's frontend positions (one cached prefill with ``frontend_embeds``)
    and with an enc-dec config's ``memory`` (``transformer.encoder_memory``
    over the frames, as ``forward`` computes it) at every step, against
    ``forward`` over the same tokens (``batch``, or new inputs): rel per
    position, and the positions at which a MoE layer routed a token of the
    decode otherwise than ``forward`` did.  The caches hold ``extra`` more
    positions.  Returns (rel per position, the positions routed otherwise,
    the caches, the batch, F, decode ms a step by events)."""
    import torch

    from repro_torch.models import moe

    if batch is None:
        batch, f = serve_inputs(cfg, SERVE_ROWS, SERVE_DECODE, gen, device)
    else:
        f = batch["frontend_embeds"].shape[1] if "frontend_embeds" in batch else 0
    with recorded_routes(moe) as fwd_routes:
        full = tf.forward(params, cfg, batch, ticketed_embedding=False).logits
    memory = (tf.encoder_memory(params, cfg, batch["encoder_frames"]) if cfg.encoder_layers
              else None)
    caches = tf.init_caches(cfg, SERVE_ROWS, f + SERVE_DECODE + extra, cfg.dtype, device=device)
    toks = batch["tokens"]
    outs = []
    if f:
        lg, caches = tf.decode_step(params, cfg, toks[:, :f], caches,
                                    frontend_embeds=batch["frontend_embeds"])
        outs.append(lg)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    with recorded_routes(moe) as dec_routes:
        for i in range(SERVE_DECODE):
            lg, caches = tf.decode_step(params, cfg, toks[:, f + i:f + i + 1], caches,
                                        memory=memory)
            outs.append(lg)
    e1.record()
    sync()
    dec = torch.cat(outs, dim=1)
    check(dec.shape == full.shape and bool(torch.isfinite(full).all())
          and bool(torch.isfinite(dec).all()),
          f"serve_families {cfg.name} (a): logits {tuple(dec.shape)} vs {tuple(full.shape)}, or "
          f"not finite")
    rel = rel_by_position(dec, full)
    rerouted = rerouted_positions(fwd_routes, dec_routes, SERVE_ROWS, len(fwd_routes))
    del full, dec, outs
    return rel, rerouted, caches, batch, f, e0.elapsed_time(e1) / SERVE_DECODE


def serve_window(tf, params, cfg, gen, device):
    """(b) past the window: one cached prefill of ``sliding_window`` +
    WINDOW_PAST tokens (``last_only``), then WINDOW_STEPS decode steps,
    against ``forward`` over the same tokens at those positions (one row).
    Returns rel per position (the prefill's last, then each step's)."""
    import torch

    n = cfg.sliding_window + WINDOW_PAST
    toks = torch.randint(0, cfg.vocab_size, (1, n + WINDOW_STEPS), generator=gen, device=device,
                         dtype=torch.int32)
    full = tf.forward(params, cfg, {"tokens": toks}, ticketed_embedding=False).logits[:, n - 1:]
    caches = tf.init_caches(cfg, 1, n + WINDOW_STEPS, cfg.dtype, device=device)
    lg, caches = tf.decode_step(params, cfg, toks[:, :n], caches, last_only=True)
    outs = [lg]
    for i in range(WINDOW_STEPS):
        lg, caches = tf.decode_step(params, cfg, toks[:, n + i:n + i + 1], caches)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    check(dec.shape == full.shape and bool(torch.isfinite(dec).all()),
          f"serve_families {cfg.name} (b): window logits {tuple(dec.shape)} or not finite")
    rel = rel_by_position(dec, full)
    del full, dec, caches
    return rel


def serve_ragged(tf, params, cfg, caches, batch, device, gen):
    """(b) seeded from the cache: one cached prefill of RAGGED_PREFILL
    tokens on the caches (a) left after its SERVE_DECODE tokens (the
    chunked path from the carried state, a last chunk of 300 mod 128 = 44
    steps), against ``forward`` over all SERVE_DECODE + RAGGED_PREFILL
    tokens at the prefilled positions.  Returns rel per position."""
    import torch

    more = torch.randint(0, cfg.vocab_size, (SERVE_ROWS, RAGGED_PREFILL), generator=gen,
                         device=device, dtype=torch.int32)
    toks = torch.cat([batch["tokens"], more], dim=1)
    full = tf.forward(params, cfg, {"tokens": toks}, ticketed_embedding=False).logits
    dec, _ = tf.decode_step(params, cfg, more, caches)
    full = full[:, -RAGGED_PREFILL:]
    check(dec.shape == full.shape and bool(torch.isfinite(dec).all()),
          f"serve_families {cfg.name} (b): the {RAGGED_PREFILL}-token prefill's logits "
          f"{tuple(dec.shape)} or not finite")
    rel = rel_by_position(dec, full)
    del full, dec
    return rel


def greedy_loop(tf, kmods, params, cfg, prompts, max_new, max_len, device):
    """The lock-step greedy decode that ``ServeLoop`` runs, written over
    ``decode_step`` alone: prompts right-padded with 0 to the longest and
    prefilled a token a step, then ``max_new`` greedy tokens a row.  The
    launches of its first step after the prefill are read around that step.
    Returns (tokens a row, top-2 margins (rows, max_new), that step's
    launches)."""
    import torch

    plen = max(int(p.numel()) for p in prompts)
    toks = torch.zeros((len(prompts), plen), dtype=torch.int32, device=device)
    for i, p in enumerate(prompts):
        toks[i, :p.numel()] = p
    caches = tf.init_caches(cfg, len(prompts), max_len, cfg.dtype, device=device)
    out, margins, one = [], [], None
    cur = toks[:, :1]
    for t in range(plen + max_new - 1):
        inp = toks[:, t:t + 1] if t < plen else cur
        if t == plen:
            sync()
            reset_launches(kmods)
        lg, caches = tf.decode_step(params, cfg, inp, caches)
        if t == plen:
            sync()
            one = read_launches(kmods)
        top = torch.topk(lg[:, -1].float(), 2, dim=-1).values
        cur = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
        if t >= plen - 1:
            out.append(cur[:, 0])
            margins.append(top[:, 0] - top[:, 1])
    return torch.stack(out, 1).tolist(), torch.stack(margins, 1).cpu(), one


def serve_loop_check(tf, kmods, params, cfg, gen, device, moe_layers):
    """(c) and (d): ``ServeLoop(slots=8, max_len=128)`` on a one-member mesh
    serves LM_PROMPTS with SERVE_NEW new tokens each; the launch counts are
    set to 0 just before ``run_batch`` and read just after.  Every request
    done; its tokens equal :func:`greedy_loop`'s over ``decode_step`` on the
    same weights or, at the first token where they differ, that loop's
    top-2 margin under SERVE_MARGIN; B3 3 and the segment kernel 1 a MoE
    layer and step over the run and in one step alone, no other kernel.
    Returns the loop's record (decode ms a step by events after the
    prefill)."""
    import torch

    from repro_torch.parallel import sharding
    from repro_torch.serve.engine import Request, ServeLoop

    mesh = sharding.make_mesh((1, 1), ("data", "model"), devices=[sharding.MeshDevice(0, device)])
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen, device=device,
                             dtype=torch.int32) for n in LM_PROMPTS]
    loop = ServeLoop(mesh, cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    step, events = loop.step_fn, []

    def counted(*args):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)
        return step(*args)

    loop.step_fn = counted
    reqs = [Request(uid=i, prompt=p, max_new=SERVE_NEW) for i, p in enumerate(prompts)]
    sync()
    reset_launches(kmods)
    t0 = time.perf_counter()
    loop.run_batch(reqs)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    sync()
    wall = time.perf_counter() - t0
    launches = read_launches(kmods)
    plen = max(LM_PROMPTS)
    steps = len(events)
    per_step = dict({k: 0 for k in kmods}, grouped_matmul=3 * moe_layers, segment_agg=moe_layers)
    check(steps == plen + SERVE_NEW - 1 and all(r.done and len(r.generated) == SERVE_NEW
                                                for r in reqs),
          f"serve_families {cfg.name} (c): {steps} steps, requests done "
          f"{[r.done for r in reqs]}")
    check(launches == {k: v * steps for k, v in per_step.items()},
          f"serve_families {cfg.name} (d): launches {launches} over {steps} steps, expected "
          f"{per_step} a step")
    want, margins, one = greedy_loop(tf, kmods, params, cfg, prompts, SERVE_NEW, LM_MAX_LEN,
                                     device)
    check(one == per_step, f"serve_families {cfg.name} (d): one step launched {one}, expected "
          f"{per_step}")
    diffs = []
    for i, (r, w) in enumerate(zip(reqs, want)):
        j = next((j for j, (a, b) in enumerate(zip(r.generated, w)) if a != b), None)
        if j is not None:
            m = float(margins[i, j])
            diffs.append({"request": i, "first_diff": j, "margin": m})
            check(m < SERVE_MARGIN, f"serve_families {cfg.name} (c): request {i} differs from "
                  f"the greedy decode_step loop at token {j}, margin {m} >= {SERVE_MARGIN}")
    decode_ms = events[plen].elapsed_time(end) / (steps - plen)
    rec = {"steps": steps, "wall_s": wall, "prefill_ms": events[0].elapsed_time(events[plen]),
           "decode_ms_per_step": decode_ms, "decode_tokens_per_s": LM_SLOTS / decode_ms * 1e3,
           "tokens_per_s": LM_SLOTS * SERVE_NEW / wall, "token_diffs": diffs,
           "launches_per_step": {k: v for k, v in one.items() if v}, "launches": launches}
    del loop
    return rec


def twobuf_runs(tf, kmods, params, cfg, toks, device, moe_layers):
    """One config's two-buffer runs on ``toks`` (rows, TWOBUF_PREFIX +
    TWOBUF_STEPS): ``decode_step`` over a cached prefill of the prefix and
    the steps; then ``decode_step_twobuf`` from that prefill's K/V as they
    are and as round(x / KV_Q8_SCALE) clamped to ±127, each run's launches
    read around its steps (B3 3 and the segment kernel 1 a MoE layer and
    step) and its routing recorded (``moe.router_stats``).  Returns the
    logits (one-buffer, prefix as is, int8 prefix), the routing histograms
    of the two prefixes, the prefix K / V's smaller RMS and the count of
    clamped elements."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.attention import KV_Q8_SCALE

    n, rows = TWOBUF_PREFIX, toks.shape[0]
    caches = tf.init_caches(cfg, rows, n + TWOBUF_STEPS, cfg.dtype, device=device)
    _, caches = tf.decode_step(params, cfg, toks[:, :n], caches)
    pk, pv = caches.k[:, :, :n].clone(), caches.v[:, :, :n].clone()
    one = []
    for i in range(TWOBUF_STEPS):
        lg, caches = tf.decode_step(params, cfg, toks[:, n + i:n + i + 1], caches)
        one.append(lg)
    qk, qv = (torch.clamp(torch.round(t.float() / KV_Q8_SCALE), -127, 127).to(torch.int8)
              for t in (pk, pv))
    sigma = min(float(pk.float().pow(2).mean().sqrt()), float(pv.float().pow(2).mean().sqrt()))
    clamped = int(sum(int((t.float().abs() > 127.5 * KV_Q8_SCALE).sum()) for t in (pk, pv)))
    got, routing = {}, {}
    for name, (k, v) in (("prefix", (pk, pv)), ("int8", (qk, qv))):
        prefix, tail = tf.init_twobuf_caches(cfg, rows, n, TWOBUF_STEPS, cfg.dtype, device=device)
        prefix = prefix._replace(k=k, v=v)
        outs = []
        sync()
        reset_launches(kmods)
        with moe.router_stats() as records:
            for i in range(TWOBUF_STEPS):
                lg, tail = tf.decode_step_twobuf(params, cfg, toks[:, n + i:n + i + 1], prefix,
                                                 tail)
                outs.append(lg)
        sync()
        launches = read_launches(kmods)
        expect = dict({k_: 0 for k_ in kmods}, grouped_matmul=3 * moe_layers * TWOBUF_STEPS,
                      segment_agg=moe_layers * TWOBUF_STEPS)
        check(launches == expect, f"serve_families {cfg.name} two-buffer {name} ({cfg.dtype}): "
              f"launches {launches}, expected {expect}")
        got[name] = torch.cat(outs, dim=1)
        routing[name] = [h.clone() for h, _ in records]
        check(bool(torch.isfinite(got[name]).all()),
              f"serve_families {cfg.name} two-buffer {name} ({cfg.dtype}): logits not finite")
    return torch.cat(one, dim=1), got, routing, sigma, clamped


def serve_twobuf(tf, kmods, params, cfg, arch, gen, device, moe_layers):
    """``decode_step_twobuf`` for a dense or moe config (:func:`twobuf_runs`,
    TWOBUF_PREFIX prefilled tokens, TWOBUF_STEPS tail steps).  Gates: the
    bf16 prefix's logits against ``decode_step`` on the same tokens within
    LM_REL; the int8 prefix's logits finite and within
    :func:`int8_prefix_bound` of the bf16 prefix's.  For
    FLOAT32_GATED_ARCHS (ROADMAP §3 fault 15: in bf16 the reference's own
    two-buffer MoE decode misses its 0.05 rule, a near-tied router picking
    another expert) the same runs at float32 compute carry both gates, and
    the bf16 figures are printed beside them, ungated.  Prints how many
    steps the int8 run routed as its comparator did.  Returns the record."""
    import dataclasses

    import torch

    toks = torch.randint(0, cfg.vocab_size, (SERVE_ROWS, TWOBUF_PREFIX + TWOBUF_STEPS),
                         generator=gen, device=device, dtype=torch.int32)
    runs = {"bfloat16": cfg}
    if arch in FLOAT32_GATED_ARCHS:
        runs["float32"] = dataclasses.replace(cfg, dtype="float32")
    rec = {"prefix": TWOBUF_PREFIX, "steps": TWOBUF_STEPS}
    for dtype, c in runs.items():
        one, got, routing, sigma, clamped = twobuf_runs(tf, kmods, params, c, toks, device,
                                                        moe_layers)
        # the steps whose every MoE layer routed the int8 run's rows as the
        # comparator's: the rounding model holds there only (a router that
        # picks another expert is a discrete jump; fault 15)
        per = [routing[k][i * moe_layers:(i + 1) * moe_layers] for k in ("prefix", "int8")
               for i in range(TWOBUF_STEPS)]
        alike = [i for i in range(TWOBUF_STEPS)
                 if all(torch.equal(a, b) for a, b in zip(per[i], per[TWOBUF_STEPS + i]))]
        rel_int8 = rel_by_position(got["int8"], got["prefix"])
        rec[dtype] = {"rel_prefix_vs_decode": float(rel_by_position(got["prefix"], one).max()),
                      "rel_int8_vs_prefix": float(rel_int8.max()),
                      "rel_int8_routed_alike": float(rel_int8[alike].max()) if alike else None,
                      "steps_routed_alike": len(alike),
                      "int8_bound": int8_prefix_bound(cfg.n_layers, sigma), "kv_rms": sigma,
                      "kv_clamped": clamped}
    gated = "float32" if "float32" in runs else "bfloat16"
    r = rec[gated]
    rec["gated"] = gated
    check(r["rel_prefix_vs_decode"] < LM_REL,
          f"serve_families {cfg.name} two-buffer ({gated}) vs decode_step rel "
          f"{r['rel_prefix_vs_decode']} >= {LM_REL}")
    check(r["steps_routed_alike"] > 0 and r["rel_int8_routed_alike"] < r["int8_bound"],
          f"serve_families {cfg.name} two-buffer int8 vs {gated} prefix rel "
          f"{r['rel_int8_routed_alike']} over the {r['steps_routed_alike']} steps routed alike, "
          f"bound {r['int8_bound']} (KV RMS {r['kv_rms']}, {r['kv_clamped']} clamped)")
    return rec


def serve_full_depth(kmods, device):
    """``launch.serve.main(["--arch", a, "--requests", "8", "--max-new",
    "16"])`` for each of FULL_DEPTH_ARCHS at published widths and depth
    (rwkv6-1.6b's 24 layers, zamba2-1.2b's 38: six super-blocks and a
    two-block tail) on one member, the CLI's own seeds: every request done
    with 16 tokens, the closing line the reference's, no kernel launched
    (neither family has a MoE layer).  Returns a record an arch."""
    import contextlib
    import io
    import re

    import torch

    from repro_torch.launch import serve as lserve
    from repro_torch.parallel import sharding

    line_re = re.compile(r"served 8 requests, 128 tokens in \d+\.\ds \(\d+\.\d tok/s\)$")
    recs = []
    for arch in FULL_DEPTH_ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        sync()
        reset_launches(kmods)
        t0 = time.perf_counter()
        with sharding.virtual_devices(1, device), contextlib.redirect_stdout(out):
            served = lserve.main(["--arch", arch, "--requests", "8", "--max-new", "16"])
        secs = time.perf_counter() - t0
        launches = read_launches(kmods)
        line = out.getvalue().strip().splitlines()[-1]
        check(len(served) == 8 and all(r.done and len(r.generated) == 16 for r in served)
              and line_re.match(line) is not None and launches == {k: 0 for k in kmods},
              f"serve_families full depth {arch}: {len(served)} served, line {line!r}, "
              f"launches {launches}")
        rec = {"arch": arch, "line": line, "s": secs,
               "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20, "launches": launches}
        recs.append(rec)
        log(f"phase3 serve_families full depth {arch}: launch.serve.main: {line} ({secs:.1f} s "
            f"with init; peak {rec['peak_mib']:.0f} MiB); {card_line()}")
        del served
    torch.cuda.empty_cache()
    return recs


def phase3_serve_families(kmods, device, seed):
    """Every config's serving path on the card at published widths and cut
    depth (:func:`serve_config`), bf16 compute over float32 parameters from
    a seeded card generator.  For each arch: (a) :func:`serve_decode_vs_forward`;
    (b) :func:`serve_window` for WINDOW_ARCHS and :func:`serve_ragged` for
    RAGGED_ARCHS; (c, d) :func:`serve_loop_check`; :func:`serve_twobuf` for
    TWOBUF_ARCHS; (e) the decode ms a step (``ServeLoop``, events after the
    prefill), tokens/s and peak MiB printed beside the card's name and power
    limit.  Every (a) and (b) position within LM_REL.  Then
    :func:`serve_full_depth`.  Returns the record."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCH_IDS
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    total = {k: 0 for k in kmods}
    rows = []
    for i, arch in enumerate(ARCH_IDS):
        t0 = time.perf_counter()
        cfg = serve_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=device).manual_seed(seed + 40 + i)
        params = tf.init_params(gen, cfg, device)
        moe_layers = (sum(cfg.is_moe_layer(j) for j in range(cfg.n_layers))
                      if cfg.moe_num_experts else 0)
        extra = RAGGED_PREFILL if arch in RAGGED_ARCHS else 0
        rel_a, rerouted, caches, batch, f, step_ms = serve_decode_vs_forward(
            tf, params, cfg, gen, device, extra)
        row = {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
               "encoder_layers": cfg.encoder_layers, "frontend_positions": f,
               "decoded": SERVE_DECODE, "rel_decode": float(rel_a.max()),
               "rel_decode_at": int(rel_a.argmax()), "rerouted_positions": rerouted,
               "decode_ms_rows2": step_ms, "gated": cfg.dtype}
        if arch in FLOAT32_GATED_ARCHS:  # fault 15: the same tokens at float32 carry the gate
            rel_a, rerouted32, *_ = serve_decode_vs_forward(
                tf, params, dataclasses.replace(cfg, dtype="float32"), gen, device, 0, batch)
            row.update(gated="float32", rel_decode_float32=float(rel_a.max()),
                       rerouted_positions_float32=rerouted32)
        check(float(rel_a.max()) < LM_REL,
              f"serve_families {arch} (a): decode vs forward ({row['gated']}) rel "
              f"{float(rel_a.max())} >= {LM_REL} at position {int(rel_a.argmax())}; routed "
              f"otherwise at {rerouted}")
        if arch in RAGGED_ARCHS:
            rel = serve_ragged(tf, params, cfg, caches, batch, device, gen)
            row["rel_ragged_prefill"] = float(rel.max())
            check(float(rel.max()) < LM_REL,
                  f"serve_families {arch} (b): the {RAGGED_PREFILL}-token prefill vs forward rel "
                  f"{float(rel.max())} >= {LM_REL} at position {int(rel.argmax())}")
        del caches, batch
        if arch in WINDOW_ARCHS:
            rel = serve_window(tf, params, cfg, gen, device)
            row["rel_window"] = float(rel.max())
            row["window_prefill"] = cfg.sliding_window + WINDOW_PAST
            check(float(rel.max()) < LM_REL,
                  f"serve_families {arch} (b): prefill past the window vs forward rel "
                  f"{float(rel.max())} >= {LM_REL} at position {int(rel.argmax())}")
        torch.cuda.empty_cache()
        loop = serve_loop_check(tf, kmods, params, cfg, gen, device, moe_layers)
        for k in kmods:
            total[k] += loop["launches"][k]
        row.update(serve_loop=loop)
        if arch in TWOBUF_ARCHS:
            row["twobuf"] = serve_twobuf(tf, kmods, params, cfg, arch, gen, device, moe_layers)
        row["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        row["s"] = time.perf_counter() - t0
        rows.append(row)
        del params
        log(f"phase3 serve_families {arch}: {cfg.family}, {cfg.n_layers} layers"
            + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
            + (f", {f} vision positions prefilled" if f else "")
            + f"; decode vs forward rel {row['rel_decode']:.4g} (worst at position "
            f"{row['rel_decode_at']}; routed otherwise at {row['rerouted_positions']})"
            + (f", at float32 {row['rel_decode_float32']:.4g} (routed otherwise at "
               f"{row['rerouted_positions_float32']}) [float32 gated, fault 15]"
               if "rel_decode_float32" in row else "")
            + (f"; {RAGGED_PREFILL}-token prefill rel {row['rel_ragged_prefill']:.4g}"
               if "rel_ragged_prefill" in row else "")
            + (f"; {row['window_prefill']}-token prefill past the window + {WINDOW_STEPS} steps "
               f"rel {row['rel_window']:.4g}" if "rel_window" in row else "")
            + f"; ServeLoop {LM_SLOTS} x {SERVE_NEW} tokens: decode {loop['decode_ms_per_step']:.2f} "
            f"ms a step, {loop['decode_tokens_per_s']:.1f} tokens/s decoding, "
            f"{loop['tokens_per_s']:.1f} end to end, tokens vs the greedy decode_step loop: "
            f"{LM_SLOTS - len(loop['token_diffs'])} of {LM_SLOTS} equal {loop['token_diffs']}; "
            f"launches a step {loop['launches_per_step']}"
            + "".join(f"; two-buffer {d} vs decode_step rel {v['rel_prefix_vs_decode']:.4g}, "
                      f"int8 prefix vs {d} {v['rel_int8_vs_prefix']:.4g}, over the "
                      f"{v['steps_routed_alike']} of {TWOBUF_STEPS} steps routed alike "
                      f"{v['rel_int8_routed_alike'] or 0:.4g} (bound {v['int8_bound']:.4g}, KV RMS "
                      f"{v['kv_rms']:.3f}, {v['kv_clamped']} clamped)"
                      + (" [gated]" if d == row["twobuf"]["gated"] else " [not gated]")
                      for d, v in row.get("twobuf", {}).items()
                      if d in ("bfloat16", "float32"))
            + f"; peak {row['peak_mib']:.0f} MiB; {row['s']:.1f} s; {card_line()}")
    full_depth = serve_full_depth(kmods, device)
    rec = {"stream": "lm_serve_families", "configs": rows, "full_depth": full_depth,
           "launches": total, "card": card_line()}
    log("phase3 " + json.dumps(rec))
    return rec


def b6_bound(lhs, rhs, sizes):
    """The least time of one B6 call (both products): a dict of
    ``bytes_ms`` (lhs, g, the touched experts' weights and sizes read once;
    d_lhs and d_rhs written once, 3.35 TB/s), ``tf32x3_ms`` (two products
    of 3 × 2·rows·K·N TF32 tensor operations, the float32-accurate tensor
    path, 495 TFLOP/s), ``fp32_ms`` (the two products' 2·rows·K·N float32
    FMA operations, 67 TFLOP/s), ``kernels_ms`` (what this design needs at
    best: both products in 3×TF32 on the tensor cores, or its bytes, the
    larger), and the headline ``bound_ms`` / ``bound_by``, the larger of
    bytes and the tensor count (this design reads and writes nothing else,
    so the two agree)."""
    m, k = lhs.shape
    g, _, n = rhs.shape
    touched = int((sizes > 0).sum())
    nbytes = 4 * (m * k + m * n + touched * k * n + g + m * k + g * k * n)
    ops = 2 * int(sizes.clamp(min=0).sum()) * k * n   # one product
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    t_ms = 2 * 3 * ops / TF32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, t_ms), "bound_by": "bytes" if b_ms >= t_ms else "operations",
            "bytes_ms": b_ms, "tf32x3_ms": t_ms, "fp32_ms": 2 * ops / FP32_OPS_PER_S * 1e3,
            "kernels_ms": max(b_ms, t_ms)}


def grouped_mm_backward_library(lhs, rhs, sizes, g):
    """The backward of ``torch._grouped_mm`` (bfloat16 operands, as it
    takes them: not B6's float32) on the same rows, where this torch has
    it and differentiates it.  Returns (fn, note); fn is None where it
    does not run."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, "torch._grouped_mm absent"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    gb = g.bfloat16()
    errors = []
    for layout, b in (("(G, K, N) row-major", rhs.bfloat16()),
                      ("(G, K, N) column-major", rhs.bfloat16().transpose(1, 2).contiguous()
                       .transpose(1, 2))):
        a = lhs.bfloat16().requires_grad_(True)
        b = b.requires_grad_(True)
        try:
            out = torch._grouped_mm(a, b, offs=offs)
            torch.autograd.grad(out, [a, b], gb, retain_graph=True)
            sync()
        except (RuntimeError, TypeError, ValueError) as e:
            errors.append(f"{layout}: {str(e).splitlines()[0][:160]}")
            continue

        def fn(out=out, a=a, b=b):
            return torch.autograd.grad(out, [a, b], gb, retain_graph=True)

        return fn, f"backward of torch._grouped_mm, bf16 operands, rhs {layout}"
    return None, "torch._grouped_mm backward refused: " + "; ".join(errors)


def phase4_grouped_matmul_backward(gm, gen, device, reps=5):
    """B6 at the training shapes (8192 rows: gate / up K 1024, N 512; down
    K 512, N 1024; gate / up with a Zipf hot expert) and the decode gate /
    up shape (64 rows) (:func:`b6_shape_cases`): the wrapper by
    CUDA events (median of ``reps``), by CUDA-graph replay, and each
    product's launch alone by graph replay; beside :func:`b6_bound`, its
    plain version (held against it), the per-expert float32
    ``torch.matmul`` loop of both products with the sizes already on the
    host, and the backward of ``torch._grouped_mm`` at bf16 where it runs.
    The training gate / up shape is the kernel's line.  Returns the
    record."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    per_shape, worst = {}, 0.0
    for name, (lhs, rhs, sizes) in b6_shape_cases(gen, device).items():
        k, n = lhs.shape[1], rhs.shape[2]
        g = torch.randn(lhs.shape[0], n, generator=gen, device=device)
        d_lhs, d_rhs = torch.empty_like(lhs), torch.empty_like(rhs)

        def call():
            return gm.grouped_matmul_backward(lhs, rhs, sizes, g)

        ms = time_cuda(call, reps)
        graph_ms = time_graph(call)
        dlhs_ms = time_graph(lambda: gm._launch_dlhs(g, rhs, sizes, d_lhs))
        drhs_ms = time_graph(lambda: gm._launch_drhs(lhs, g, sizes, d_rhs))
        plain_ms = time_cuda(lambda: gm.grouped_matmul_backward_plain(lhs, rhs, sizes, g), reps)
        host_sizes = sizes.tolist()
        o_lhs, o_rhs = torch.empty_like(lhs), torch.empty_like(rhs)

        def matmul_loop():
            s = 0
            for e, c in enumerate(host_sizes):
                if c:
                    torch.matmul(g[s:s + c], rhs[e].T, out=o_lhs[s:s + c])
                    torch.matmul(lhs[s:s + c].T, g[s:s + c], out=o_rhs[e])
                s += c

        loop_ms = time_cuda(matmul_loop, reps)
        lib, note = grouped_mm_backward_library(lhs, rhs, sizes, g)
        lib_ms = time_cuda(lib, reps) if lib is not None else None
        err_l, err_r, _, _ = check_gmm_bwd(gm, lhs, rhs, sizes, g,
                                           f"phase4 grouped_matmul_backward {name}")
        worst = max(worst, err_l, err_r)
        bound = b6_bound(lhs, rhs, sizes)
        per_shape[name] = {"rows": lhs.shape[0], "k": k, "n": n,
                           "groups": int((sizes > 0).sum()), "largest_group": int(sizes.max()),
                           "kernel_ms": ms, "graph_ms": graph_ms, "d_lhs_graph_ms": dlhs_ms,
                           "d_rhs_graph_ms": drhs_ms, "plain_ms": plain_ms, **bound,
                           "matmul_loop_ms": loop_ms, "library_ms": lib_ms, "library": note,
                           "max_abs_err": max(err_l, err_r)}
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        log(f"phase4 grouped_matmul_backward {name}: kernel {ms:.4f} ms (events), graph "
            f"{graph_ms:.4f} (d_lhs {dlhs_ms:.4f} + d_rhs {drhs_ms:.4f}) for M={lhs.shape[0]} "
            f"K={k} N={n}, {per_shape[name]['groups']} groups (largest "
            f"{per_shape[name]['largest_group']} rows); bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}; bytes {bound['bytes_ms']:.4f}, 3xTF32 "
            f"{bound['tf32x3_ms']:.4f}, f32 FMA {bound['fp32_ms']:.4f}, this design's "
            f"{bound['kernels_ms']:.4f}), plain {plain_ms:.4f} ms, per-expert matmul loop "
            f"{loop_ms:.4f} ms, library {lib_txt} ({note}); max|Δ| d_lhs {err_l:.3g}, d_rhs "
            f"{err_r:.3g} ok")
    log("phase4 grouped_matmul_backward " + json.dumps(per_shape))
    head = per_shape["train_gate_up"]
    return {"ms": head["kernel_ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "max_abs_err": worst, "per_shape": per_shape}


# -- phase dryrun: the production cells and the one-member steps -----------------------


def dryrun_calibrate(kmods, device, seed, arch, step_ms):
    """The dry run of ``make_train_step``'s one-member step (8 × 128 tokens,
    TRAIN_HP, ``ticketed_embedding``, as phase 3's) on meta tensors, and
    the same step once on the card under the same ``CostMode``: FLOPs
    against FLOPs (DRYRUN_FLOPS_RTOL), the predicted peak against the
    card's ``max_memory_allocated`` over what was held before the
    parameters (DRYRUN_PEAK_RANGE).  Launches, set to 0 just before each
    run and read just after: none in the meta trace (the wrappers' meta
    branches); in the card step phase 3's a step (ticket 1, B5 1; MoE
    also B3 6, B6 6 and the segment kernel 2 a layer: the forward and its
    recompute).  Returns the record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.train import loop as tloop

    cfg = get_config(arch)
    hp = tloop.TrainHParams(total_steps=TRAIN_STEPS, ticketed_embedding=True, **TRAIN_HP)
    pred, trace_s = predicted_step(kmods, cfg, hp, TRAIN_BATCH, TRAIN_SEQ)
    none = {k: 0 for k in kmods}

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tf.init_params(gen, cfg, device)
    opt = adamw.init(params)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=gen,
                         device=device, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}
    step = tloop.make_train_step(cfg, hp)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kmods)
    with dr.CostMode() as mode:
        _, _, metrics = step(params, opt, batch)
    sync()
    launches = read_launches(kmods)
    layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)) if cfg.moe_num_experts else 0
    want = dict(none, ticket_hash=1, segment_rows=1)
    if layers:
        want.update(grouped_matmul=FWD_RUNS * 3 * layers, grouped_matmul_backward=6 * layers,
                    segment_agg=FWD_RUNS * layers)
    check(launches == want, f"dryrun {arch}: the card step launched {launches}, expected {want}")
    card_peak = torch.cuda.max_memory_allocated() - held
    loss = float(metrics["loss"])
    del params, opt, batch, metrics, step
    torch.cuda.empty_cache()

    flops, flops_card = pred["cost"]["flops"], mode.flops
    peak = pred["memory"]["peak_bytes"]
    terms = {"compute": flops / roofline.H100_PEAK_FLOPS_BF16,
             "memory": pred["cost"]["bytes accessed"] / roofline.H100_HBM_BW}
    top = max(terms, key=terms.get)
    rec = {"arch": arch, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "flops": flops,
           "flops_card": flops_card, "flops_ratio": flops / flops_card,
           "bytes": pred["cost"]["bytes accessed"], "bytes_card": mode.bytes,
           "peak_mib": peak / 2 ** 20, "card_peak_mib": card_peak / 2 ** 20,
           "peak_ratio": peak / card_peak, "terms_ms": {k: v * 1e3 for k, v in terms.items()},
           "bound_by": top, "step_ms": step_ms, "trace_s": trace_s, "loss": loss,
           "launches": launches}
    check(math.isfinite(loss), f"dryrun {arch}: the card step's loss {loss} is not finite")
    check(abs(flops / flops_card - 1) <= DRYRUN_FLOPS_RTOL,
          f"dryrun {arch}: predicted FLOPs {flops:.6e} vs the card step's {flops_card:.6e}")
    lo, hi = DRYRUN_PEAK_RANGE
    check(lo <= peak / card_peak <= hi,
          f"dryrun {arch}: predicted peak {peak / 2 ** 20:.0f} MiB vs the card's "
          f"{card_peak / 2 ** 20:.0f} MiB over what was held")
    log(f"dryrun calibrate {arch} (8 x 128, one member): FLOPs {flops:.6e} predicted vs "
        f"{flops_card:.6e} counted on the card step (x{flops / flops_card:.5f}); bytes "
        f"{rec['bytes']:.4e} vs {mode.bytes:.4e}; peak {peak / 2 ** 20:.0f} MiB predicted vs "
        f"{card_peak / 2 ** 20:.0f} MiB max_memory_allocated over what was held "
        f"(x{peak / card_peak:.3f}); largest roofline term {top} {terms[top] * 1e3:.3f} ms "
        f"beside phase 3's median step {step_ms:.2f} ms ({step_ms / (terms[top] * 1e3):.1f}x); "
        f"trace {trace_s:.1f} s; {card_line()}")
    return rec


def phase_dryrun(kmods, device, seed, train_rec, moe_rec):
    """The dry run's production cells, then its calibration against the
    card (:func:`dryrun_calibrate`).  Returns the records."""
    import torch

    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline

    cells = []
    reset_launches(kmods)
    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = dr.run_cell(arch, shape, with_cost=False, verbose=False)
        rf, mem = r["roofline"], r["memory"]
        check(rf["hlo_flops"] > 0 and mem["peak_bytes"] > 0 and math.isfinite(rf["hlo_bytes"]),
              f"dryrun {arch} {shape}: no work counted ({rf})")
        cell = {"arch": arch, "shape": shape, "mesh": r["mesh"], "mode": r["mode"],
                "peak_gib": mem["peak_bytes"] / 2 ** 30,
                "argument_gib": mem["argument_bytes"] / 2 ** 30,
                "fits_80gb": mem["peak_bytes"] <= roofline.H100_HBM_BYTES,
                "flops": rf["hlo_flops"], "bytes": rf["hlo_bytes"], "coll_bytes": rf["coll_bytes"],
                "compute_s": rf["compute_s"], "memory_s": rf["memory_s"],
                "collective_s": rf["collective_s"], "bottleneck": rf["bottleneck"],
                "useful_flops_frac": rf["useful_flops_frac"], "s": time.perf_counter() - t0}
        cells.append(cell)
        check(read_launches(kmods) == {k: 0 for k in kmods},
              f"dryrun {arch} {shape}: a meta trace launched kernels {read_launches(kmods)}")
        log(f"dryrun {arch} x {shape} x {r['mesh']}: per member peak {cell['peak_gib']:.2f} GiB "
            f"({'fits' if cell['fits_80gb'] else 'exceeds'} 80 GB; arguments "
            f"{cell['argument_gib']:.2f} GiB), FLOPs {cell['flops']:.4e}, bytes "
            f"{cell['bytes']:.4e}, collective bytes {cell['coll_bytes']:.4e}; compute "
            f"{cell['compute_s']:.4f} s, memory {cell['memory_s']:.4f} s, collective "
            f"{cell['collective_s']:.4f} s (H100 SXM datasheet constants) -> {cell['bottleneck']}; "
            f"{cell['s']:.1f} s")
    calib = [dryrun_calibrate(kmods, device, seed, TRAIN_ARCH, train_rec["step_ms"]),
             dryrun_calibrate(kmods, device, seed, MOE_TRAIN_ARCH, moe_rec["step_ms"])]
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"dryrun HBM constant {roofline.H100_HBM_BYTES:.4e} B (datasheet) beside the card's "
        f"total_memory {total} B; {card_line()}")
    rec = {"cells": cells, "calibration": calib, "hbm_constant": roofline.H100_HBM_BYTES,
           "total_memory": total, "card": card_line()}
    log("dryrun " + json.dumps(rec))
    return rec


# -- phase 4: timing --------------------------------------------------------------


def time_cuda(fn, reps, setup=None, warm_s=0.05):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events
    around each call only (``setup`` runs before each, untimed).  Calls
    first run back to back for ``warm_s`` seconds, so that a timing does
    not start on a card that sat idle through a host-bound plain
    version."""
    import torch

    t_end = time.perf_counter() + warm_s
    while True:
        if setup is not None:
            setup()
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() >= t_end:
            break
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def time_graph(fn, calls=20, reps=5):
    """Median milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``calls`` calls (CUDA events around each replay): the device time of a
    call with the gaps between its kernels, without the host's launch
    work.  ``fn`` must have run once before (first-use set-up is not
    captured)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    times.sort()
    return times[len(times) // 2]


def kernel_timing(fk, keys, vals, *, max_groups, programs, device, reps=5):
    """The kernel over one main-path chunk from a fresh state, as the
    executor launches it (RAISE, events on).  Returns (ms, launch args)."""
    import torch

    from repro_torch.core.hashing import table_capacity

    kinds = tuple(k for _, k in SPECS4)
    rows = keys.shape[0]
    pad = (-rows) % (M * programs)
    k32 = keys.to(torch.int32)
    v = vals
    if pad:
        k32 = torch.cat([k32, k32.new_full((pad,), -1)])
        v = torch.cat([v, v.new_zeros(pad)])
    km = k32.reshape(-1, M).contiguous()
    vm = v.reshape(1, -1, M).contiguous()
    c = table_capacity(max_groups)
    fresh = fk.init_fused_state(capacity=c, max_groups=max_groups, kinds=kinds,
                                programs=programs, device=device)
    work = fk.FusedState(*(t.clone() for t in fresh))
    todo = torch.ones(km.shape[0], dtype=torch.int32, device=device)
    kw = dict(specs=SPECS4, checked=True, grow_bound=False, threshold=int(0.5 * c),
              bound_slack=max_groups - M, collect_events=True)

    def reset():
        for w, f in zip(work, fresh):
            w.copy_(f)
        todo.fill_(1)

    ms = time_cuda(lambda: fk.fused_consume(work, km, vm, todo, **kw), reps, reset)
    return ms, (fresh, km, vm, kw)


def bound_ms_of(keys, n_value_planes=1, n_specs=4):
    """Least time for one fused pass over ``keys``: every key and value
    row read once, and for each distinct key its table slot (key + ticket)
    read and written, its key_by_ticket entry written and its accumulators
    read and written — over the HBM rate; operations (~12 integer ops per
    row for the hash and probe) over the non-tensor peak.  The larger wins."""
    import torch

    rows = keys.numel()
    d = int(torch.unique(keys).numel())
    nbytes = rows * 4 * (1 + n_value_planes) + d * (16 + 4 + 8 * n_specs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = rows * 12 / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_vs_plain(fk, keys, vals, launch, label):
    """The kernel and its plain version, each launched once from the same
    fresh state on the same main-path chunk, compared by the port's rules.
    Returns (max |Δacc|, plain ms on the host clock)."""
    import torch

    fresh, km, vm, kw = launch
    ks = fk.FusedState(*(t.clone() for t in fresh))
    ps = fk.FusedState(*(t.clone() for t in fresh))
    todo = torch.ones(km.shape[0], dtype=torch.int32, device=km.device)
    ks, kinfo = fk.fused_consume(ks, km, vm, todo, **kw)
    (ps, pinfo), p_s = timed(fk.fused_consume_plain, ps, km, vm, todo.clone().fill_(1), **kw)
    err = compare_kernel_plain(fk, ks, kinfo, ps, pinfo, abs_sum_lookup(keys, vals), label)
    return err, p_s * 1e3


def phase4_chunks(gen, device, n=1 << 24, chunks=8):
    """One main-path chunk of each class (the first n / chunks rows of the
    class's keys, with their stream's bound) and one value plane: the
    fused and the split kernels are timed on the same chunks."""
    import torch

    rows = n // chunks
    vals = torch.randn(rows, generator=gen, device=device)
    classes = {
        "low": (gen_keys(n, "low", "uniform", gen, device)[:rows], 1024),
        "high": (gen_keys(n, "high", "zipf", gen, device)[:rows], n // 10),
        "unique": (gen_keys(n, "unique", "uniform", gen, device)[:rows], n),
    }
    return classes, vals


def phase4(fk, chunk_classes, vals, device):
    import torch

    from repro_torch.core.hashing import table_capacity

    rows = vals.numel()
    classes = {name: (keys, g, 1) for name, (keys, g) in chunk_classes.items()}
    classes["low_p132"] = (chunk_classes["low"][0], 1024, 132)
    per_class = {}
    max_err = 0.0
    for name, (keys, g, P) in classes.items():
        ms, launch = kernel_timing(fk, keys, vals, max_groups=g, programs=P, device=device)
        grid = list(fk.fused_consume.grid)
        b_ms, b_by = bound_ms_of(keys)
        err, plain_ms = kernel_vs_plain(fk, keys, vals, launch, f"phase4 {name}")
        del launch
        max_err = max(max_err, err)

        def library(keys=keys):
            uk, inv = torch.unique(keys, return_inverse=True)
            torch.zeros(uk.numel(), device=device).index_add_(0, inv, vals)

        lib_ms = time_cuda(library, 5)
        per_class[name] = {"kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "library_ms": lib_ms, "max_abs_err": err,
                           "rows": rows, "programs": P, "max_groups": g,
                           "capacity": table_capacity(g), "grid": grid}
        log(f"phase4 {name}: kernel {ms:.3f} ms for {rows} rows (P={P}, "
            f"capacity {table_capacity(g)}, grid {grid[0]} CTAs, {grid[1]} per program), "
            f"bound {b_ms:.4f} ms ({b_by}), torch.unique+index_add_ {lib_ms:.3f} ms; "
            f"vs plain ({plain_ms:.1f} ms): max|Δacc|={err:.3g} ok")
    log("phase4 " + json.dumps(per_class))
    high = per_class["high"]
    return {"ms": high["kernel_ms"], "plain_ms": high["plain_ms"],
            "bound_ms": high["bound_ms"], "bound_by": high["bound_by"],
            "library_ms": high["library_ms"], "max_abs_err": max_err,
            "per_class": per_class}


def block_sweep(fk, classes, vals, device, sizes=(128, 256, 512, 1024)):
    """The fused kernel's time per P = 1 chunk at each CTA size (the
    kernel's block size is chosen from these), each launch's group count
    checked against the chunk's distinct count."""
    import torch

    out = {}
    default = fk.BLOCK_THREADS
    try:
        for threads in sizes:
            fk.BLOCK_THREADS = threads
            row = {}
            for name, (keys, g) in classes.items():
                ms, (fresh, km, vm, kw) = kernel_timing(fk, keys, vals, max_groups=g,
                                                        programs=1, device=device)
                ks = fk.FusedState(*(t.clone() for t in fresh))
                todo = torch.ones(km.shape[0], dtype=torch.int32, device=device)
                fk.fused_consume(ks, km, vm, todo, **kw)
                check(int(ks.count[0]) == int(torch.unique(keys).numel())
                      and not bool(todo.any()),
                      f"block sweep {threads} threads {name}: wrong count or morsels left")
                row[name] = {"ms": ms, "grid": list(fk.fused_consume.grid)}
            out[threads] = row
    finally:
        fk.BLOCK_THREADS = default
    log("phase4 block sweep " + json.dumps(out))
    return out


def device_profiles(calls, first_kernels):
    """``torch.profiler``'s device time per kernel over one call of each
    function in ``calls`` (label → fn; each called once untraced first),
    in one profiler session (a second session in the same process recorded
    no device time with torch 2.11 on an H100): label → [(kernel, device
    ms)].  The calls run one after another with a synchronize between, so
    their kernels are told apart by order: each call's first kernel has a
    name in ``first_kernels``, and a call's kernels from that list come
    first and together (matching CPU and device clocks proved unreliable).  Empty lists when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in calls.values():
        fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for label, fn in calls.items():
            with record_function("smoke:" + label):
                fn()
                sync()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not e.name.startswith("smoke:")),
                     key=lambda e: e.time_range.start)
    groups = []
    prev_first = False
    for e in kernels:
        first = any(k in e.name for k in first_kernels)
        if (first and not prev_first) or not groups:
            groups.append([])
        prev_first = first
        groups[-1].append((e.name[:48], e.time_range.elapsed_us() / 1e3))
    out = {label: [] for label in calls}
    if len(groups) == len(calls):
        out.update(zip(calls, groups))
    return out


def ticket_breakdown(th, k32, cap, g, reps):
    """Where one ticket call's time goes, CUDA events each: the wrapper's
    allocation and fill alone, and the kernel launch alone on outputs
    allocated and filled beforehand (untimed).  Where the shapes allow the
    kernel's region mode (the unique chunk) the fill runs with the launch,
    after the sample, and the first part is the allocation alone."""
    n, dev = k32.numel(), k32.device
    okw = dict(capacity=cap, max_groups=g, device=dev)
    fill_ms = time_cuda(lambda: th.fresh_outputs(n, **okw), reps)
    held = {}

    def setup():
        held["state"] = th.fresh_outputs(n, **okw)

    launch_ms = time_cuda(lambda: th.launch(k32, held["state"]), reps, setup)
    held.clear()
    return {"fill_ms": fill_ms, "launch_ms": launch_ms}


def region_selection(th, classes, reps=5):
    """The ticket kernel's choice of mode on one table past the L2 (C =
    2^25, G = 2^24, as the unique stream's) for the zipf and the unique
    chunk: the chunk as it is (one row per 16 slots: the shapes allow region
    mode and a sample of the keys decides on the card) beside tile mode
    alone (the same chunk and one morsel of EMPTY rows, past one row per
    16 slots, which the shapes rule out).  The zipf chunk, whose keys
    repeat, should cost what tile mode costs; the unique chunk less.  Both
    calls are held against the plain version on the zipf chunk.  Returns
    (record, largest discrepancy)."""
    import torch

    cap, g = 1 << 25, 1 << 24
    out, max_err = {}, 0
    for name in ("high", "unique"):
        k32 = classes[name][0].to(torch.int32)
        n = k32.numel()
        check(16 * n == cap, f"region selection: {n} rows are not C/16")
        padded = torch.cat([k32, k32.new_full((M,), -1)])
        kw = dict(capacity=cap, max_groups=g, morsel_size=M)
        chosen_ms = time_cuda(lambda: th.ticket_hash(k32, **kw), reps)
        tile_ms = time_cuda(lambda: th.ticket_hash(padded, **kw), reps)
        rec = {"rows": n, "groups": int(torch.unique(k32).numel()), "capacity": cap,
               "max_groups": g, "chosen_ms": chosen_ms, "tile_ms": tile_ms,
               "bound_ms": (8 * n + 8 * cap + 4 * g) / HBM_BYTES_PER_S * 1e3}
        if name == "high":
            pout = th.ticket_hash_plain(padded, **kw)
            label = "phase4 region selection zipf"
            err = check_ticket_maps(th, padded, th.ticket_hash(padded, **kw), pout,
                                    label + " tile mode")
            head = (pout[0][:n],) + tuple(pout[1:])
            err = max(err, check_ticket_maps(th, k32, th.ticket_hash(k32, **kw), head,
                                             label + " chosen mode"))
            rec["discrepancies"] = err
            max_err = max(max_err, err)
            del pout, head
        out[name] = rec
        log(f"phase4 region selection {name}: {rec['groups']} keys in {n} rows at C={cap}: "
            f"as chosen {chosen_ms:.4f} ms, tile mode (+{M} EMPTY rows) {tile_ms:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms")
    return out, max_err


def phase4_split(th, sa, classes, vals, device, reps=5):
    """The split route's kernels on one main-path chunk of each class (its
    bound and capacity), CUDA events, beside their bounds, one library
    call each and their plain versions, each held against its plain
    version on that chunk.  Returns (the ticket calls that
    :func:`phase4_profiles` traces, label → fn; the record)."""
    import torch

    from repro_torch.core.hashing import table_capacity

    rows = vals.numel()
    out = {}
    max_err = {"ticket_hash": 0, "segment_agg": 0.0}
    profile_calls = {}
    for name, (keys, g) in classes.items():
        k32 = keys.to(torch.int32)
        cap = table_capacity(g)
        d = int(torch.unique(k32).numel())
        kw = dict(capacity=cap, max_groups=g, morsel_size=M)
        t_ms = time_cuda(lambda: th.ticket_hash(k32, **kw), reps)
        lib_ms = time_cuda(lambda: torch.unique(k32, return_inverse=True), reps)
        breakdown = ticket_breakdown(th, k32, cap, g, reps)
        breakdown.update(call_ms=t_ms, torch_unique_ms=lib_ms)
        log(f"phase4 ticket breakdown {name}: " + json.dumps(breakdown))
        profile_calls[name] = lambda k32=k32, kw=kw: th.ticket_hash(k32, **kw)
        # each input read once, each output written once: keys in, tickets
        # out, the fresh table (keys + tickets) and key_by_ticket out
        t_bytes = 8 * rows + 8 * cap + 4 * g
        rec = {"rows": rows, "groups": d, "max_groups": g, "capacity": cap,
               "ticket": {"kernel_ms": t_ms, "library_ms": lib_ms,
                          "bound_ms": t_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                          "breakdown": breakdown}}
        kout = th.ticket_hash(k32, **kw)
        tickets = kout[0]
        pout, tp_s = timed(th.ticket_hash_plain, k32, **kw)
        t_err = check_ticket_maps(th, k32, kout, pout, f"phase4 ticket {name}")
        max_err["ticket_hash"] = max(max_err["ticket_hash"], t_err)
        rec["ticket"].update(plain_ms=tp_s * 1e3, discrepancies=t_err)
        del pout
        idx = tickets.long()
        check(bool(((idx >= 0) & (idx < g)).all()), f"phase4 {name}: tickets out of range")
        ones = torch.ones(rows, device=device)
        seg = {}
        for kind in KINDS4:
            v = ones if kind == "count" else vals
            if kind in ("sum", "count"):
                def library(v=v):
                    torch.zeros(g, device=device).index_add_(0, idx, v)
            else:
                def library(v=v, kind=kind):
                    torch.full((g,), float("inf") if kind == "min" else float("-inf"),
                               device=device).scatter_reduce_(
                        0, idx, v, "amin" if kind == "min" else "amax")
            lib_seg = time_cuda(library, reps)
            s_bytes = rows * (4 if kind == "count" else 8) + 4 * g + 4 * d
            for strategy in ("scatter", "onehot"):
                if strategy == "onehot" and g > sa.MAX_ONEHOT_GROUPS:
                    continue
                skw = dict(num_groups=g, kind=kind, strategy=strategy, morsel_size=M)
                s_ms = time_cuda(lambda: sa.segment_agg(tickets, vals, **skw), reps)
                got = sa.segment_agg(tickets, vals, **skw)
                want, p_s = timed(sa.segment_agg_plain, tickets, vals, **skw)
                err = check_segment(sa, tickets, vals, got, want, kind,
                                    f"phase4 segment {name} {kind}/{strategy}", g)
                max_err["segment_agg"] = max(max_err["segment_agg"], err)
                seg[f"{kind}/{strategy}"] = {
                    "kernel_ms": s_ms, "plain_ms": p_s * 1e3, "library_ms": lib_seg,
                    "bound_ms": s_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                    "max_abs_err": err}
        rec["segment"] = seg
        out[name] = rec
        for key, r in seg.items():
            log(f"phase4 segment {name} {key}: kernel {r['kernel_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms ({'index_add_' if key[:3] in ('sum', 'cou') else 'scatter_reduce_'}), "
                f"bound {r['bound_ms']:.4f} ms, kernel/library {r['kernel_ms'] / r['library_ms']:.3f}")
        log(f"phase4 split {name}: ticket {t_ms:.3f} ms (torch.unique {lib_ms:.3f} ms, "
            f"bound {rec['ticket']['bound_ms']:.4f} ms; vs plain ({tp_s * 1e3:.1f} ms): "
            f"{t_err} discrepancies); segment sum/scatter "
            f"{seg['sum/scatter']['kernel_ms']:.3f} ms (index_add_ "
            f"{seg['sum/scatter']['library_ms']:.3f} ms, bound "
            f"{seg['sum/scatter']['bound_ms']:.4f} ms) ok")
    selection, sel_err = region_selection(th, classes, reps)
    max_err["ticket_hash"] = max(max_err["ticket_hash"], sel_err)
    # the zipf chunk against the 2^25-slot table too: the sample's cost
    k_high = classes["high"][0].to(torch.int32)
    profile_calls["high_c25"] = lambda: th.ticket_hash(k_high, capacity=1 << 25,
                                                       max_groups=1 << 24, morsel_size=M)
    high = out["high"]
    return profile_calls, {
        "ticket_hash": {"ms": high["ticket"]["kernel_ms"],
                        "plain_ms": high["ticket"]["plain_ms"],
                        "bound_ms": high["ticket"]["bound_ms"], "bound_by": "bytes",
                        "library_ms": high["ticket"]["library_ms"],
                        "max_abs_err": max_err["ticket_hash"]},
        "segment_agg": {"ms": high["segment"]["sum/scatter"]["kernel_ms"],
                        "plain_ms": high["segment"]["sum/scatter"]["plain_ms"],
                        "bound_ms": high["segment"]["sum/scatter"]["bound_ms"],
                        "bound_by": "bytes",
                        "library_ms": high["segment"]["sum/scatter"]["library_ms"],
                        "max_abs_err": max_err["segment_agg"]},
        "per_class": out,
        "region_selection": selection,
    }


def scan_launch(fk, tk, k32, g, device):
    """What one ``scan_ticket`` launch of the scan executor takes on a
    main-path chunk (4096-row morsels, the bound and capacity of the
    class's stream, RAISE, events on): (km, a fresh table, a work table,
    todo, kwargs, reset), where ``reset()`` puts the work table and todo
    back to fresh."""
    import torch

    from repro_torch.core.hashing import table_capacity

    km = k32.reshape(-1, SCAN_M).contiguous()
    cap = table_capacity(g)
    fresh = tk.make_table(cap, g, device=device)
    work = tk.TicketTable(*(t.clone() for t in fresh))
    todo = torch.ones(km.shape[0], dtype=torch.int32, device=device)
    ev = torch.zeros(14, dtype=torch.int32, device=device)
    kw = dict(checked=True, grow_bound=False, threshold=cap // 2,
              bound_slack=g - SCAN_M, collect_events=True, events=ev)

    def reset():
        for w, f in zip(work, fresh):
            w.copy_(f)
        todo.fill_(1)

    return km, fresh, work, todo, kw, reset


def scan_ticket_breakdown(fk, launch, reps):
    """Where one ``scan_ticket`` call's time goes on an idle card (every
    setup ends in a synchronize): the whole call (CUDA events), the
    wrapper's host work before the launch alone (``prepare_scan_ticket``,
    host clock), and the launch alone on a call prepared beforehand
    (``launch_scan_ticket``, CUDA events).  ``phase4_profiles`` adds
    ``torch.profiler``'s device time per kernel of the call."""
    km, _, work, todo, kw, reset = launch
    held = {}

    def idle():
        reset()
        sync()

    def prepared():
        idle()
        held["call"] = fk.prepare_scan_ticket(work, km, todo, **kw)
        sync()

    call_ms = time_cuda(lambda: fk.scan_ticket(work, km, todo, **kw), reps, idle)
    launch_ms = time_cuda(lambda: fk.launch_scan_ticket(held["call"]), reps, prepared)
    host = []
    for _ in range(reps):
        idle()
        t0 = time.perf_counter()
        fk.prepare_scan_ticket(work, km, todo, **kw)
        host.append((time.perf_counter() - t0) * 1e3)
        sync()
    host.sort()
    held.clear()
    return {"call_idle_ms": call_ms, "host_ms": host[len(host) // 2], "launch_ms": launch_ms}


def scan_block_sweep(fk, tk, classes, device, sizes=(256, 512, 1024), reps=5):
    """``scan_ticket``'s time per main-path chunk at each CTA size (its
    block size is chosen from these), each launch's group count checked
    against the chunk's distinct count and every morsel committed."""
    import torch

    out = {}
    default = fk.SCAN_BLOCK_THREADS
    try:
        for threads in sizes:
            fk.SCAN_BLOCK_THREADS = threads
            row = {}
            for name, (keys, g) in classes.items():
                k32 = keys.to(torch.int32)
                km, _, work, todo, kw, reset = scan_launch(fk, tk, k32, g, device)
                ms = time_cuda(lambda: fk.scan_ticket(work, km, todo, **kw), reps, reset)
                reset()
                fk.scan_ticket(work, km, todo, **kw)
                check(int(work.count) == int(torch.unique(k32).numel()) and not bool(todo.any()),
                      f"scan block sweep {threads} threads {name}: wrong count or morsels left")
                row[name] = {"ms": ms, "grid": list(fk.scan_ticket.grid)}
                del work
            out[threads] = row
    finally:
        fk.SCAN_BLOCK_THREADS = default
    log("phase4 scan block sweep " + json.dumps(out))
    return out


def phase4_scan(fk, sa, classes, vals, device, fused_per_class, split_per_class, reps=5):
    """``scan_ticket`` on one main-path chunk of each class (4096-row
    morsels, the bound and capacity of the class's stream, RAISE, events
    on, as the scan executor launches it), CUDA events from a fresh table
    each time, beside its plain version, its bytes bound,
    ``torch.unique(return_inverse=True)``, and the fused and ticket
    kernels on the same chunk; held against its plain version on each,
    its call split by :func:`scan_ticket_breakdown`.  Then the serialized
    kernel on one chunk of its stream (8192 rows).  Returns (the calls
    that :func:`phase4_profiles` traces, label → fn; the record)."""
    import torch

    from repro_torch.core import ticketing as tk

    out, worst, profile_calls = {}, 0, {}
    for name, (keys, g) in classes.items():
        k32 = keys.to(torch.int32)
        rows = k32.numel()
        launch = scan_launch(fk, tk, k32, g, device)
        km, fresh, work, todo, kw, reset = launch
        cap = fresh.capacity
        d = int(torch.unique(k32).numel())
        ms = time_cuda(lambda: fk.scan_ticket(work, km, todo, **kw), reps, reset)
        grid = list(fk.scan_ticket.grid)
        breakdown = scan_ticket_breakdown(fk, launch, reps)
        log(f"phase4 scan_ticket breakdown {name}: " + json.dumps(breakdown))
        # the traced call and its untraced first call each on a fresh table
        # and todo mask, made beforehand
        fresh_pairs = [(tk.TicketTable(*(t.clone() for t in fresh)), torch.ones_like(todo))
                       for _ in range(2)]

        def profiled(km=km, kw=kw, pairs=fresh_pairs):
            table, todo_ = pairs.pop()
            return fk.scan_ticket(table, km, todo_, **kw)

        profile_calls[name] = profiled
        lib_ms = time_cuda(lambda: torch.unique(k32, return_inverse=True), reps)
        km_, (k, p), (_, p_s) = scan_pair(fk, tk, k32, SCAN_M, cap, g, checked=True,
                                          threshold=cap // 2, bound_slack=g - SCAN_M,
                                          collect_events=True)
        bad = fk.scan_ticket_discrepancies(km_, k[:2], p[:2])
        check(bad == 0 and not bool(k[2].any()),
              f"phase4 scan_ticket {name}: {bad} discrepancies")
        worst = max(worst, bad)
        del k, p, work, launch
        # keys read once, tickets written once, and per distinct key its
        # slot (key + ticket) and key_by_ticket entry written once
        b_ms = (8 * rows + 12 * d) / HBM_BYTES_PER_S * 1e3
        out[name] = {"kernel_ms": ms, "plain_ms": p_s * 1e3, "bound_ms": b_ms,
                     "bound_by": "bytes", "library_ms": lib_ms, "discrepancies": bad,
                     "rows": rows, "groups": d, "max_groups": g, "capacity": cap,
                     "grid": grid, "breakdown": breakdown,
                     "fused_ms": fused_per_class[name]["kernel_ms"],
                     "ticket_hash_ms": split_per_class[name]["ticket"]["kernel_ms"]}
        log(f"phase4 scan_ticket {name}: kernel {ms:.4f} ms for {rows} rows in {km.shape[0]} "
            f"morsels (grid {grid[0]} CTAs), bound {b_ms:.4f} ms, torch.unique "
            f"{lib_ms:.4f} ms, plain {p_s * 1e3:.1f} ms; same chunk: fused "
            f"{out[name]['fused_ms']:.4f} ms, ticket_hash {out[name]['ticket_hash_ms']:.4f} ms; "
            f"0 discrepancies ok")
    # the serialized update on one chunk of its stream: 8192 rows, G = 1024
    rows = 8192
    t = classes["low"][0][:rows].to(torch.int32)
    v = vals[:rows].contiguous()
    acc = torch.zeros(1024, device=device)
    s_ms = time_cuda(lambda: sa.serialized_agg(acc, t, v, kind="sum"), reps,
                     lambda: acc.zero_())
    acc.zero_()
    want, p_s = timed(sa.serialized_agg_plain, acc.cpu().clone(), t.cpu(), v.cpu(), kind="sum")
    got = sa.serialized_agg(acc, t, v, kind="sum").cpu()
    check(torch.equal(got, want), "phase4 serialized: differs from the row loop")
    idx = t.long()
    lib = time_cuda(lambda: torch.zeros(1024, device=device).index_add_(0, idx, v), reps)
    # one dependent read-modify-write a row, ~0.5 µs of L2 latency each:
    # the bytes bound (tickets and values read, accumulator written) is printed
    ser = {"ms": s_ms, "plain_ms": p_s * 1e3, "library_ms": lib,
           "bound_ms": (8 * rows + 4 * 1024) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "max_abs_err": 0.0, "rows": rows}
    log(f"phase4 serialized: {s_ms:.4f} ms for {rows} rows (one thread), index_add_ "
        f"{lib:.4f} ms, plain {p_s * 1e3:.1f} ms, bound {ser['bound_ms']:.5f} ms, exact ok")
    # the unique class's G = 2^24 (a device-memory plane): index_add_ into
    # a plane allocated beforehand and zeroed before each call, untimed
    t24 = classes["unique"][0][:rows].to(torch.int32)
    acc24 = torch.zeros(classes["unique"][1], device=device)
    ser["library_ms_g2e24"] = time_cuda(lambda: acc24.index_add_(0, t24.long(), v), reps,
                                        acc24.zero_)
    del acc24
    log(f"phase4 serialized G=2^24: index_add_ {ser['library_ms_g2e24']:.4f} ms for {rows} "
        "rows")

    def serialized_call():
        # the reset runs after the kernel, so the profile can tell the
        # calls apart by their first kernel
        sa.serialized_agg(acc, t, v, kind="sum")
        acc.zero_()

    profile_calls["serialized"] = serialized_call
    high = out["high"]
    return profile_calls, {
        "scan_ticket": {"ms": high["kernel_ms"], "plain_ms": high["plain_ms"],
                        "bound_ms": high["bound_ms"], "bound_by": "bytes",
                        "library_ms": high["library_ms"], "max_abs_err": worst},
        "segment_agg_serialized": ser,
        "scan_per_class": out,
    }


def phase4_hybrid(hr, thy, chunk_classes, vals, gen, device, reps=5):
    """The register kernel on one 2^21-row main-path chunk of each class
    (and of the heavy-unique class), with the main path's planes (the §4
    aggs: count, sum, count, max) and the eight heavy keys
    ``detect_heavy_hitters`` names on the chunk: CUDA events, median of
    ``reps``, beside its plain version (held against it) and its bytes
    bound: the keys read, the tail keys written and the value column read
    for the rows that hit a register.  No single PyTorch call computes
    this function, so it has no library time.  Returns (the calls that
    :func:`phase4_profiles` traces, label → fn; the record)."""
    import torch

    rows = vals.numel()
    classes = {name: keys for name, (keys, _) in chunk_classes.items()}
    classes["heavy_unique"] = heavy_unique_keys(rows, gen, device)
    kinds = ("count", "sum", "count", "max")
    planes = [None, vals, None, vals]
    per_class, calls = {}, {}
    worst = 0.0
    for name, keys in classes.items():
        k32 = keys.to(torch.int32)
        heavy = torch.from_numpy(thy.detect_heavy_hitters(k32, 8).view("int32")).to(device)
        fresh = torch.stack([torch.full((8,), v, device=device)
                             for v in (0.0, 0.0, 0.0, float("-inf"))])
        regs = fresh.clone()
        ms = time_cuda(lambda: hr.hybrid_registers(k32, heavy, planes, regs, kinds=kinds),
                       reps, lambda: regs.copy_(fresh))
        got, want = fresh.clone(), fresh.clone()
        tail_k = hr.hybrid_registers(k32, heavy, planes, got, kinds=kinds)
        tail_p, p_s = timed(hr.hybrid_registers_plain, k32, heavy, planes, want, kinds=kinds)
        err = check_registers(k32, heavy, vals, got, want, tail_k, tail_p, kinds,
                              f"phase4 hybrid_registers {name}")
        worst = max(worst, err)
        hits = int((tail_k == -1).sum())
        nbytes = 8 * rows + 4 * hits
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        per_class[name] = {"kernel_ms": ms, "plain_ms": p_s * 1e3, "bound_ms": b_ms,
                           "bound_by": "bytes", "library_ms": None, "max_abs_err": err,
                           "rows": rows, "registers": int((heavy != -1).sum()),
                           "rows_on_registers": hits}

        def call(k32=k32, heavy=heavy, regs=regs, fresh=fresh):
            # the register reset runs after the kernel, so the profile can
            # tell the calls apart by their first kernel
            hr.hybrid_registers(k32, heavy, planes, regs, kinds=kinds)
            regs.copy_(fresh)

        calls["hybrid_" + name] = call
        log(f"phase4 hybrid_registers {name}: kernel {ms:.4f} ms for {rows} rows "
            f"({hits} on {per_class[name]['registers']} registers), bound {b_ms:.4f} ms "
            f"(bytes), plain {p_s * 1e3:.2f} ms, no library call; max|Δreg|={err:.3g} ok")
    # R = 64 and 256 on the high chunk (the per-warp copies), timed and
    # bounded as above
    k32 = chunk_classes["high"][0].to(torch.int32)
    for r in (64, 256):
        heavy = torch.from_numpy(thy.detect_heavy_hitters(k32, r).view("int32")).to(device)
        fresh = torch.stack([torch.full((r,), x, device=device)
                             for x in (0.0, 0.0, 0.0, float("-inf"))])
        regs = fresh.clone()
        ms = time_cuda(lambda: hr.hybrid_registers(k32, heavy, planes, regs, kinds=kinds),
                       reps, lambda: regs.copy_(fresh))
        hits = int((hr.hybrid_registers(k32, heavy, planes, fresh.clone(), kinds=kinds)
                    == -1).sum())
        b_ms = (8 * rows + 4 * hits) / HBM_BYTES_PER_S * 1e3
        per_class[f"high_r{r}"] = {"kernel_ms": ms, "bound_ms": b_ms, "bound_by": "bytes",
                                   "rows": rows, "registers": int((heavy != -1).sum()),
                                   "rows_on_registers": hits}
        log(f"phase4 hybrid_registers high R={r}: kernel {ms:.4f} ms ({hits} rows on "
            f"{per_class[f'high_r{r}']['registers']} registers), bound {b_ms:.4f} ms (bytes)")
    log("phase4 hybrid " + json.dumps(per_class))
    hu = per_class["heavy_unique"]
    return calls, {"ms": hu["kernel_ms"], "plain_ms": hu["plain_ms"],
                   "bound_ms": hu["bound_ms"], "bound_by": "bytes", "library_ms": None,
                   "max_abs_err": worst, "per_class": per_class}


def phase4_preagg(pa, api, chunk_classes, vals, device, reps=5):
    """The pre-aggregation kernel on one 2^21-row main-path chunk of each
    class at W = 8 and 132 workers, C = 1024, the whole worker slice as one
    morsel, kind sum (the part_* streams' shape): CUDA events, median of
    ``reps``, and the device time of a call from CUDA-graph replays
    (:func:`time_graph`), beside its plain version (held against it) and
    its bytes bound (keys and values read once, the spill mask and the W·C
    tables written once).  No PyTorch call computes this function.  Three calls
    per class and W for the profile (whole, and without pass 1's or pass
    2's flush), and the tile sweep (:func:`preagg_tile_sweep`).  Then one
    chunk of the high class through the whole partitioned pipeline at W =
    8: pre-aggregation, exchange and partition-wise sort (CUDA events
    each), and the merge into a fresh carried table (host clock,
    synchronized).  Returns (the calls that :func:`phase4_profiles`
    traces, label → fn; the record)."""
    import torch

    from repro_torch.core import partitioned as tp
    from repro_torch.engine import executors as tex

    rows = vals.numel()
    per_class, calls = {}, {}
    worst = 0.0
    for name, (keys, _) in chunk_classes.items():
        k32 = to_i32(keys)
        for w in (8, 132):
            kw, vw = preagg_layout(k32, vals, w, w)
            ms = time_cuda(lambda: pa.preagg(kw, vw, kind="sum", capacity=PA_C), reps)
            graph_ms = time_graph(lambda: pa.preagg(kw, vw, kind="sum", capacity=PA_C))
            got = pa.preagg(kw, vw, kind="sum", capacity=PA_C)
            want, p_s = timed(pa.preagg_plain, kw, vw, kind="sum", capacity=PA_C)
            label = f"preagg_{name}_w{w}"
            err = check_preagg(got, want, kw, vw, "sum", PA_C, "phase4 " + label)
            worst = max(worst, err)
            nbytes = kw.numel() * (4 + 4 + 1) + w * PA_C * 12
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            spilled = int(got[3].sum()) / kw.numel()
            per_class[label] = {"kernel_ms": ms, "graph_ms": graph_ms, "plain_ms": p_s * 1e3,
                                "bound_ms": b_ms,
                                "bound_by": "bytes", "library_ms": None, "max_abs_err": err,
                                "rows": kw.numel(), "workers": w, "capacity": PA_C,
                                "spilled_share": spilled, "grid": list(pa.launch.grid)}
            for variant, skip in (("", None), (":noflush_first", "first"),
                                  (":noflush_fold", "fold")):
                def call(kw=kw, vw=vw, skip=skip):
                    # the result is dropped; the next call's scratch fill
                    # starts its group in the profile
                    pa.launch(kw, vw, "sum", PA_C, skip_flush=skip)

                calls[label + variant] = call
            log(f"phase4 preagg {name} W={w}: kernel {ms:.4f} ms (graph replay "
                f"{graph_ms:.4f} ms) for {kw.numel()} rows (spilled {spilled:.4f}; grid "
                f"{pa.launch.grid[0]} CTAs of {pa.launch.grid[1]} rows), bound {b_ms:.4f} ms "
                f"(bytes), plain "
                f"{p_s * 1e3:.2f} ms, no library call; max|Δ|={err:.3g} ok")
    # one partitioned chunk, stage by stage (the part_high stream's shape)
    keys, bound = chunk_classes["high"]
    k32 = to_i32(keys)
    kw, vw = preagg_layout(k32, vals, 8, 8)
    tkeys, tvals, _, spill = pa.preagg(kw, vw, kind="sum", capacity=PA_C)
    allk, allv = tp.exchange(kw.reshape(-1), vw.reshape(-1), tkeys, tvals, spill, "sum")
    split = {
        "preagg_ms": per_class["preagg_high_w8"]["kernel_ms"],
        "exchange_ms": time_cuda(lambda: tp.exchange(kw.reshape(-1), vw.reshape(-1), tkeys,
                                                     tvals, spill, "sum"), reps),
        "partition_wise_ms": time_cuda(lambda: tp.partition_wise(allk, allv, "sum", bound),
                                       reps),
    }
    res = tp.partition_wise(allk, allv, "sum", bound)
    plan = api.GroupByPlan(keys=("k",), aggs=(api.AggSpec("sum", "v"),),
                           strategy="partitioned", max_groups=bound, saturation="raise",
                           raw_keys=True, execution=api.ExecutionPolicy(device=device.type))
    ex = tex.make_executor(plan)
    partial = (res.keys, {("v", "sum"): res.values}, res.num_groups,
               res.num_groups > bound)
    _, merge_s = timed(ex._merge, partial)
    split["merge_ms"] = merge_s * 1e3
    split["groups"] = int(res.num_groups)
    log("phase4 partitioned chunk (high, W=8, 2^21 rows): " + json.dumps(split))
    preagg_tile_sweep(pa, chunk_classes, vals, reps)
    log("phase4 preagg " + json.dumps(per_class))
    hi = per_class["preagg_high_w8"]
    return calls, {"ms": hi["kernel_ms"], "plain_ms": hi["plain_ms"],
                   "bound_ms": hi["bound_ms"], "bound_by": "bytes", "library_ms": None,
                   "max_abs_err": worst, "per_class": per_class, "partitioned_chunk": split}


def phase4_batched(fk, gen, device, reps=5, rows=1 << 16):
    """``scan_ticket_batched`` at N = 8 and 16 lanes × one 2^16-row chunk
    of serve_low's shape (uniform over 1000 keys, G = 1024, 4096-row
    morsels, RAISE, its four planes: count(*), sum(v), mean(v)'s count,
    max(v)), each call from fresh tables and accumulators.  The folding
    launch (the scatter round) by CUDA events and by CUDA-graph replay (a
    graph of reset + call less a graph of the reset alone), beside the
    two-stage round it replaces (the ticket launch, then N × S
    ``update_agg_state`` scatter updates, as ``update_planes`` runs them)
    timed the same two ways, the ticket launch alone by graph replay, the
    library (N × ``torch.unique(return_inverse=True)`` and one
    ``index_add_`` / ``scatter_reduce_`` per plane), its plain version and
    its bytes bound (each lane's keys and value plane read once, per
    distinct key its slot, key_by_ticket entry and S accumulators written
    once).  The folding call is also split into the wrapper's host work
    before the launch (``prepare_scan_ticket_batched``, host clock) and
    the launch alone (``launch_scan_ticket_batched``, events).  Each N is
    also held against its plain version (:func:`check_fold`).  Returns the
    record."""
    import torch

    from repro_torch.core import ticketing as tk
    from repro_torch.core import updates as up
    from repro_torch.core.hashing import table_capacity
    from repro_torch.engine import plan_api as api
    from repro_torch.engine.groupby import expand_agg_specs

    g = 1024
    cap = table_capacity(g)
    specs = expand_agg_specs(tuple(api.AggSpec(a, c) for a, c in AGGS_SPEC))
    per_n, worst = {}, 0.0
    for n in (8, 16):
        km = torch.randint(0, 1000, (n, rows // SCAN_M, SCAN_M), generator=gen,
                           device=device, dtype=torch.int32)
        vals = torch.randn(km.shape, generator=gen, device=device)
        fresh = [tk.make_table(cap, g, device=device) for _ in range(n)]
        work = [tk.TicketTable(*(t.clone() for t in f)) for f in fresh]
        neutral = up.init_agg_state(specs, g, device=device)
        states = [up.init_agg_state(specs, g, device=device) for _ in range(n)]
        lanes, values = list(km), [{"v": vals[i]} for i in range(n)]
        todo = torch.ones(km.shape[:2], dtype=torch.int32, device=device)
        kw = dict(thresholds=[cap // 2] * n, bound_slacks=[g - SCAN_M] * n)
        fold_kw = dict(kw, states=states, values=values, specs=specs)

        def reset():
            for w, f in zip(work, fresh):
                for a, b in zip(w, f):
                    a.copy_(b)
            for st in states:
                for a, b in zip(st.accs, neutral.accs):
                    a.copy_(b)
            todo.fill_(1)

        def fold():
            return fk.scan_ticket_batched(work, lanes, todo, **fold_kw)

        def ticket():
            return fk.scan_ticket_batched(work, km, todo, **kw)

        def two_stage():
            tickets, info = ticket()
            for i in range(n):
                up.update_agg_state(states[i], tickets[i].reshape(-1),
                                    {"v": vals[i].reshape(-1)}, up.scatter_update)
            return info

        def library():
            for i in range(n):
                uk, inv = torch.unique(km[i], return_inverse=True)
                v = vals[i].reshape(-1)
                for _, kind in specs:
                    if kind in ("sum", "count"):
                        torch.zeros(uk.numel(), device=device).index_add_(0, inv.reshape(-1), v)
                    else:
                        torch.full((uk.numel(),), float("-inf"), device=device).scatter_reduce_(
                            0, inv.reshape(-1), v, "amax")

        f_ms = time_cuda(fold, reps, reset)
        grid = list(fk.scan_ticket_batched.grid)
        # the call split: the wrapper's host work before the launch (host
        # clock) and the launch alone on a call prepared beforehand (events)
        held, host = {}, []

        def prepared():
            reset()
            sync()
            held["call"] = fk.prepare_scan_ticket_batched(work, lanes, todo, **fold_kw)
            sync()

        launch_ms = time_cuda(lambda: fk.launch_scan_ticket_batched(held["call"]), reps,
                              prepared)
        for _ in range(reps):
            reset()
            sync()
            t0 = time.perf_counter()
            fk.prepare_scan_ticket_batched(work, lanes, todo, **fold_kw)
            host.append((time.perf_counter() - t0) * 1e3)
            sync()
        held.clear()
        host_ms = sorted(host)[len(host) // 2]
        two_ms = time_cuda(two_stage, reps, reset)
        reset_ms = time_graph(reset, reps=reps)
        f_graph = time_graph(lambda: (reset(), fold()), reps=reps) - reset_ms
        two_graph = time_graph(lambda: (reset(), two_stage()), reps=reps) - reset_ms
        t_graph = time_graph(lambda: (reset(), ticket()), reps=reps) - reset_ms
        lib_ms = time_cuda(library, reps)
        pair, p_s = fold_pair(fk, km, vals, fresh, specs)
        worst = max(worst, check_fold(fk, km, vals, pair, specs,
                                      f"phase4 scan_ticket_batched fold N={n}"))
        d = [int(torch.unique(km[i]).numel()) for i in range(n)]
        bound_ms = (8 * n * rows + (12 + 4 * len(specs)) * sum(d)) / HBM_BYTES_PER_S * 1e3
        per_n[n] = {"kernel_ms": f_ms, "graph_ms": f_graph, "prepare_host_ms": host_ms,
                    "launch_ms": launch_ms, "two_stage_ms": two_ms,
                    "two_stage_graph_ms": two_graph, "ticket_graph_ms": t_graph,
                    "library_ms": lib_ms, "plain_ms": p_s * 1e3, "bound_ms": bound_ms,
                    "bound_by": "bytes", "rows": n * rows, "groups": sum(d), "planes": len(specs),
                    "grid": grid}
        log(f"phase4 scan_ticket_batched fold N={n}: kernel {f_ms:.4f} ms (graph "
            f"{f_graph:.4f}; host work before the launch {host_ms:.4f} ms, launch alone "
            f"{launch_ms:.4f} ms) beside the two-stage round {two_ms:.4f} ms (graph "
            f"{two_graph:.4f}; its ticket launch alone graph {t_graph:.4f}), library "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), plain {p_s * 1e3:.1f} ms; "
            f"grid {grid}; held to the plain version ok")
        del work, fresh, pair, states
    log("phase4 scan_ticket_batched " + json.dumps(per_n))
    head = per_n[16]
    return {"ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"], "max_abs_err": worst, "per_n": per_n}


def preagg_tile_sweep(pa, chunk_classes, vals, reps, sizes=(2048, 4096, 8192, 16384)):
    """``preagg``'s device time per main-path chunk (:func:`time_graph`)
    at W = 8 and 132, C = 1024, kind sum, at each fixed tile size beside
    the launcher's automatic one, each result held to the automatic
    tile's (keys, spill, cnts equal, SUM within SUM_RTOL · Σ|v|)."""
    out = {}
    default = pa.TILE_ROWS
    try:
        for name, (keys, _) in chunk_classes.items():
            k32 = to_i32(keys)
            for w in (8, 132):
                kw, vw = preagg_layout(k32, vals, w, w)
                row = {}
                for tile in (None,) + sizes:
                    pa.TILE_ROWS = tile
                    got = pa.preagg(kw, vw, kind="sum", capacity=PA_C)
                    if tile is None:
                        ref = got
                    check_preagg(got, ref, kw, vw, "sum", PA_C,
                                 f"preagg tile sweep {name} W={w} tile={tile}")
                    row[tile or "auto"] = {
                        "graph_ms": time_graph(
                            lambda: pa.preagg(kw, vw, kind="sum", capacity=PA_C), reps=reps),
                        "grid": list(pa.launch.grid)}
                out[f"{name}_w{w}"] = row
    finally:
        pa.TILE_ROWS = default
    log("phase4 preagg tile sweep " + json.dumps(out))
    return out


def preagg_profile_split(per_class):
    """Pass 1, pass 2 and the scratch fill as device time from the profile
    of one call, and each pass's flush as the difference of that pass's
    device time with and without its flush (one profiled call each)."""
    def ms_of(rows, part):
        return sum(ms for name, ms in rows if part in name)

    for label, rec in per_class.items():
        full = rec.get("profile_ms") or []
        nf1 = rec.get("profile_ms_noflush_first") or []
        nf2 = rec.get("profile_ms_noflush_fold") or []
        if not (full and nf1 and nf2):
            continue
        p1, p2 = ms_of(full, "preagg_first"), ms_of(full, "preagg_fold")
        rec["device_split_ms"] = {
            "fill": ms_of(full, "Memset"), "pass1_first": p1, "pass2_fold": p2,
            "device_total": ms_of(full, "Memset") + p1 + p2,
            "pass1_flush": p1 - ms_of(nf1, "preagg_first"),
            "pass2_flush": p2 - ms_of(nf2, "preagg_fold")}
        log(f"phase4 preagg device split {label[7:]}: " + json.dumps(rec["device_split_ms"]))


def phase4_profiles(timing, ticket_calls, scan_calls, hybrid_calls, preagg_calls):
    """``torch.profiler``'s device time per kernel of one ticket call per
    class (and the zipf chunk at C = 2^25), one ``scan_ticket`` call per
    class and one ``hybrid_registers`` call per class, in the process's one
    profiler session, attached to each call's record in ``timing``."""
    calls = dict(ticket_calls)
    calls.update({"scan_" + name: fn for name, fn in scan_calls.items()})
    calls.update(hybrid_calls)
    calls.update(preagg_calls)
    # a ticket call starts with the sample or the fill; a scan_ticket call
    # with its scratch fill; a register call with its kernel; a
    # pre-aggregation call with its scratch memset (or, should the profiler
    # not list memsets, its first pass)
    profiles = device_profiles(calls, ("ticket_sample_kernel", "ticket_fill_kernel",
                                       "scan_fill_kernel", "hybrid_thread_copies_kernel",
                                       "hybrid_warp_copies_kernel", "segment_serialized_kernel",
                                       "Memset", "preagg_first_kernel"))
    for label, rows_ms in profiles.items():
        if label.startswith("preagg_"):
            base, _, variant = label.partition(":")
            key = "profile_ms_" + variant if variant else "profile_ms"
            timing["preagg"]["per_class"][base][key] = rows_ms
            log(f"phase4 preagg profile {label[7:]}: " + json.dumps(rows_ms))
            continue
        if label.startswith("hybrid_"):
            rec = timing["hybrid_registers"]["per_class"][label[7:]]
            rec["profile_ms"] = rows_ms
            # the event-timed call less its kernel's device time: the host
            # work before the launch
            dev_ms = sum(ms for k, ms in rows_ms if "hybrid_" in k)
            rec["device_ms"] = dev_ms if rows_ms else None
            rec["event_minus_device_ms"] = rec["kernel_ms"] - dev_ms if rows_ms else None
            log(f"phase4 hybrid_registers profile {label[7:]}: " + json.dumps(rows_ms)
                + (f"; event {rec['kernel_ms']:.4f} ms - device {dev_ms:.4f} ms = "
                   f"{rec['kernel_ms'] - dev_ms:.4f} ms" if rows_ms else ""))
            continue
        if label == "scan_serialized":
            timing["segment_agg_serialized"]["profile_ms"] = rows_ms
            log("phase4 serialized profile (8192 rows, G=1024): " + json.dumps(rows_ms))
            continue
        if label.startswith("scan_"):
            timing["scan_per_class"][label[5:]]["breakdown"]["profile_ms"] = rows_ms
            log(f"phase4 scan_ticket profile {label[5:]}: " + json.dumps(rows_ms))
            continue
        per_class = timing["per_class"]
        rec = (per_class[label]["ticket"]["breakdown"] if label in per_class
               else timing["region_selection"]["high"])
        rec["profile_ms"] = rows_ms
        log(f"phase4 ticket profile {label}: " + json.dumps(rows_ms))
    preagg_profile_split(timing["preagg"]["per_class"])
    log("phase4 split " + json.dumps(timing["per_class"]))
    log("phase4 scan " + json.dumps(timing["scan_per_class"]))


# -- the table ops: GET_OR_INSERT into a carried table, lookup, migrate --------

TABLE_REPLACES = {"table_get_or_insert": "src/repro/core/ticketing.py:82",
                  "table_lookup": "src/repro/core/ticketing.py:213",
                  "table_migrate": "src/repro/core/resize.py:34"}


def no_sync(fn, *a):
    """``fn(*a)`` with any host sync on the card an error."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*a)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def table_ops_case(tops, label, keys, cap, g, device, *, first=None, full=False):
    """One carried table (``first`` inserted by the plain version), then
    each wrapper under ``no_sync`` against its plain version: the chunk's
    GET_OR_INSERT (map, count and flag), a lookup of the chunk with absent
    and EMPTY keys (equal) and the migration into 2C (map).  Returns the
    largest discrepancy count and the plain seconds."""
    import torch

    from repro_torch.core import resize
    from repro_torch.core import ticketing as tk

    base = tk.make_table(cap, g, device=device)
    if first is not None:
        _, base = tk.get_or_insert(base, first)
    known = int(base.count)
    ktab = tk.TicketTable(*(x.clone() for x in base))
    kt, _ = no_sync(tops.get_or_insert, ktab, keys)
    (pt, ptab), p_s = timed(tk.get_or_insert, base, keys)
    bad = tops.table_map_discrepancies(ktab, ptab, known=known, keys=keys, tickets=(kt, pt),
                                       full=full)
    check(bad == 0 and int(ktab.count) == int(ptab.count)
          and bool(ktab.overflowed) == bool(ptab.overflowed),
          f"phase2 table {label}: get_or_insert {bad} discrepancies, counts "
          f"{int(ktab.count)} / {int(ptab.count)}")
    absent = torch.tensor([-1, 0x7EADBEEF, 12345, -5], dtype=torch.int32, device=device)
    probe = torch.cat([keys, absent])
    for table in (ptab, ktab):
        check(torch.equal(no_sync(tops.lookup, table, probe), tk.lookup(table, probe)),
              f"phase2 table {label}: lookup differs from its plain version")
    km = no_sync(tops.migrate, ptab, 2 * cap)
    pm = resize.migrate(ptab, 2 * cap)
    bad_m = tops.table_map_discrepancies(km, pm)
    check(bad_m == 0, f"phase2 table {label}: migrate {bad_m} discrepancies")
    held = torch.where(tk.lookup(pm, keys) >= 0, keys, -1)
    again, _ = no_sync(tops.get_or_insert, km, held)  # scan_ticket reads what migrate wrote
    check(torch.equal(again, tk.lookup(pm, held)) and int(km.count) == int(ptab.count),
          f"phase2 table {label}: GET_OR_INSERT on the migrated table found other tickets")
    log(f"phase2 table {label}: {keys.numel()} rows into C={cap}, G={g} holding {known} "
        f"keys: count {int(ptab.count)} (overflowed {bool(ptab.overflowed)}, -1 rows "
        f"{int(((pt < 0) & (keys != -1)).sum())}); get_or_insert and migrate 0 "
        f"discrepancies, lookup equal, no host sync in the wrappers; plain {p_s:.2f} s ok")
    return max(bad, bad_m), p_s


def phase2_table_ops(tops, gen, device, rows=1 << 21, n=1 << 24):
    """The table ops against their plain versions on the card
    (``table_ops_case``, each wrapper under ``torch.cuda.set_sync_debug_mode
    ("error")``): a 2^21-row chunk of each §4.1 class (3% EMPTY rows) into
    the class stream's table (C, G as its split stream) holding the chunk's
    first half; low at G = 512 (tickets past G, the sticky flag); a full
    table of 1024 slots (absent keys end after C probes) and a saturated
    one (4096 distinct keys into it: -1 rows).  Returns the largest
    discrepancy count."""
    import torch

    from repro_torch.core.hashing import table_capacity

    probe = torch.ones(4, device=device)
    try:
        no_sync(lambda: int(probe.sum()))
        refused = False
    except RuntimeError:
        refused = True
    check(refused, "phase2 table: the sync debug mode let a host read through")
    worst = 0
    for cls, dist, g in (("low", "uniform", 1024), ("high", "zipf", n // 10),
                         ("unique", "uniform", n)):
        keys = to_i32(gen_keys(n, cls, dist, gen, device)[:rows])
        keys[torch.rand(rows, generator=gen, device=device) < 0.03] = -1
        worst = max(worst, table_ops_case(tops, cls, keys, table_capacity(g), g, device,
                                          first=keys[:rows // 2])[0])
        del keys
    low = to_i32(gen_keys(rows, "low", "uniform", gen, device))
    worst = max(worst, table_ops_case(tops, "low past G", low, 2048, 512, device,
                                      first=low[:1000])[0])
    wide = torch.randint(0, 4096, (1 << 16,), generator=gen, device=device,
                         dtype=torch.int32) * 7919
    worst = max(worst, table_ops_case(tops, "full", wide[:1 << 12], 1024, 4096, device,
                                      first=torch.arange(1024, dtype=torch.int32,
                                                         device=device) * 7919, full=True)[0])
    worst = max(worst, table_ops_case(tops, "saturated", wide, 1024, 4096, device,
                                      full=True)[0])
    return worst


def table_bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_graph_reset(fn, reset, reps=5):
    """Median milliseconds of ``fn`` replayed from a CUDA graph of one call,
    ``reset`` (untimed, outside the graph) before each replay: for a call
    that updates its inputs in place."""
    import torch

    reset()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    reset()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps):
        reset()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def phase4_table_ops(tops, chunk_classes, gen, device, reps=5, n=1 << 24):
    """The table ops timed by CUDA events (median of ``reps``) and by a
    CUDA graph's replay, beside their bytes bounds and their plain loops
    (once, host clock, synchronized):
      * get_or_insert at split_unique's merge shape: 2^24 key_by_ticket
        lanes, 2^21 of them live and new, into a 2^25-slot table (G 2^24)
        holding the previous chunk's 2^21 keys (the table reset between
        calls, untimed), and the rest of that merge, the partial's
        ``scatter_update`` (sum, max) over all lanes and over the live ones;
      * migrate of 2^21 keys from 2^22 slots into 2^23;
      * lookup of each class's 2^21-row chunk in a table holding it.
    No library call computes these functions."""
    import torch

    from repro_torch.core import resize
    from repro_torch.core import ticketing as tk
    from repro_torch.core import updates as up
    from repro_torch.core.hashing import table_capacity

    out = {}
    live = 1 << 21
    perm = torch.randperm(n, generator=gen, device=device).to(torch.int32)
    prev, new = perm[:live], perm[live:2 * live]
    fresh = tk.make_table(1 << 25, n, device=device)
    tops.get_or_insert(fresh, prev)
    kbt = torch.full((n,), -1, dtype=torch.int32, device=device)
    kbt[:live] = new
    work = tk.TicketTable(*(x.clone() for x in fresh))

    def reset():
        for w, f in zip(work, fresh):
            w.copy_(f)

    g_ms = time_cuda(lambda: tops.get_or_insert(work, kbt), reps, reset)
    g_graph = time_graph_reset(lambda: tops.get_or_insert(work, kbt), reset, reps)
    reset()
    (_, ptab), p_s = timed(tk.get_or_insert, fresh, kbt)
    tickets, _ = tops.get_or_insert(work, kbt)
    bad = tops.table_map_discrepancies(work, ptab, known=live)
    check(bad == 0, f"phase4 table get_or_insert: {bad} discrepancies at the merge shape")
    g_bound = table_bound_ms(8 * n + 12 * live)  # lanes in, tickets out; a new key's slot, kbt
    # the rest of a split merge at this shape: the partial's scatter into
    # the carried plane (``core.updates.scatter_update``, sum and max), over
    # all lanes (the -1 lanes fold their neutral into slot 0) and over the
    # live lanes alone
    acc = torch.zeros(n, device=device)
    part = torch.rand(n, generator=gen, device=device)
    scatter = {f"{kind}_{lanes}": time_cuda(
        lambda kind=kind, m=m: up.scatter_update(acc, tickets[:m], part[:m], kind=kind), reps)
        for kind in ("sum", "max") for lanes, m in (("all", n), ("live", live))}
    out["table_get_or_insert"] = {
        "ms": g_ms, "graph_ms": g_graph, "plain_ms": p_s * 1e3, "bound_ms": g_bound,
        "bound_by": "bytes", "library_ms": None, "max_abs_err": float(bad),
        "shape": f"{n} lanes, {live} live, into 2^25 slots holding {live}",
        "merge_scatter_ms": scatter}
    del fresh, work, ptab, kbt, tickets, acc, part

    src = tk.make_table(1 << 22, 1 << 21, device=device)
    tops.get_or_insert(src, perm[:live])
    m_ms = time_cuda(lambda: tops.migrate(src, 1 << 23), reps)
    m_graph = time_graph(lambda: tops.migrate(src, 1 << 23), calls=5, reps=reps)
    pm, pm_s = timed(resize.migrate, src, 1 << 23)
    bad_m = tops.table_map_discrepancies(tops.migrate(src, 1 << 23), pm)
    check(bad_m == 0, f"phase4 table migrate: {bad_m} discrepancies")
    out["table_migrate"] = {
        "ms": m_ms, "graph_ms": m_graph, "plain_ms": pm_s * 1e3,
        "bound_ms": table_bound_ms(8 * (1 << 22) + 8 * (1 << 23)), "bound_by": "bytes",
        "library_ms": None, "max_abs_err": float(bad_m),
        "shape": f"{live} keys, 2^22 -> 2^23 slots"}
    del src, pm, perm

    per_class = {}
    for name, (keys, g) in chunk_classes.items():
        k32 = to_i32(keys)
        table = tk.make_table(table_capacity(g), g, device=device)
        tops.get_or_insert(table, k32)
        ms = time_cuda(lambda: tops.lookup(table, k32), reps)
        graph = time_graph(lambda: tops.lookup(table, k32), calls=5, reps=reps)
        want, l_s = timed(tk.lookup, table, k32)
        check(torch.equal(tops.lookup(table, k32), want), f"phase4 table lookup {name}: differs")
        d = int(torch.unique(k32).numel())
        per_class[name] = {"ms": ms, "graph_ms": graph, "plain_ms": l_s * 1e3,
                           "bound_ms": table_bound_ms(8 * k32.numel() + 8 * d)}
        del table, want
    u = per_class["unique"]
    out["table_lookup"] = {"ms": u["ms"], "graph_ms": u["graph_ms"], "plain_ms": u["plain_ms"],
                           "bound_ms": u["bound_ms"], "bound_by": "bytes", "library_ms": None,
                           "max_abs_err": 0.0, "per_class": per_class}
    for name, rec in out.items():
        log(f"phase4 {name}: events {rec['ms']:.4f} ms, graph {rec['graph_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms (bytes), plain {rec['plain_ms']:.1f} ms, "
            f"library none; {json.dumps({k: v for k, v in rec.items() if k != 'ms'})}")
    return out


def toolchain(build):
    import torch

    nvcc = build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "nvcc": ver[-1] if ver else "?"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import ticketing as tk
    from repro_torch.engine import plan_api as api
    from repro_torch.kernels import build
    from repro_torch.core import hybrid as thy
    from repro_torch.kernels import fused_groupby as fk
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import hybrid_registers as hr
    from repro_torch.kernels import preagg as pa
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import segment_rows as sr
    from repro_torch.kernels import table_ops as tops
    from repro_torch.kernels import ticket_hash as th

    # name → (module, wrapper) whose ``launches`` counts that kernel
    kmods = {"fused_groupby": (fk, "fused_consume"), "ticket_hash": (th, "ticket_hash"),
             "segment_agg": (sa, "segment_agg"), "scan_ticket": (fk, "scan_ticket"),
             "scan_ticket_batched": (fk, "scan_ticket_batched"),
             "segment_agg_serialized": (sa, "serialized_agg"),
             "hybrid_registers": (hr, "hybrid_registers"), "preagg": (pa, "preagg"),
             "grouped_matmul": (gm, "grouped_matmul"),
             "grouped_matmul_backward": (gm, "grouped_matmul_backward"),
             "segment_rows": (sr, "segment_rows"),
             "table_get_or_insert": (tops, "get_or_insert"), "table_lookup": (tops, "lookup"),
             "table_migrate": (tops, "migrate")}
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    t_all = time.perf_counter()

    log("== phase 1: build")
    log("toolchain " + json.dumps(toolchain(build)))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, together
        list(pool.map(build.build, KERNELS))
    for name in KERNELS:
        info = build.BUILD_INFO[name]
        log(f"build {name}: {info['cmd']}")
        log(f"build {name}: {info['seconds']:.2f} s -> {info['path']}")
        for ln in info["ptxas"]:
            log(f"build {name}: ptxas {ln}")
    log(f"phase1 done in {time.perf_counter() - t0:.1f} s")

    log("== phase 2: kernel vs plain on the card")
    t0 = time.perf_counter()
    max_err = phase2(fk, gen, device)
    split_err = phase2_split(th, sa, gen, device)
    split_err.update(phase2_scan(fk, sa, gen, device))
    split_err["hybrid_registers"] = phase2_hybrid(hr, gen, device)
    split_err["preagg"] = phase2_preagg(pa, gen, device)
    split_err["scan_ticket_batched"] = phase2_batched(fk, gen, device)
    split_err["grouped_matmul"] = phase2_grouped_matmul(gm, sa, gen, device)
    split_err["segment_rows"] = phase2_segment_rows(sr, th, gen, device)
    split_err["grouped_matmul_backward"] = phase2_grouped_matmul_backward(gm, gen, device)
    table_err = phase2_table_ops(tops, gen, device)
    log(f"phase2 done in {time.perf_counter() - t0:.1f} s")

    log("== phase 3: the main path")
    t0 = time.perf_counter()
    recs = phase3(kmods, api, gen, device)
    t_serve = time.perf_counter()
    recs += phase3_serve(kmods, api, gen, device)
    log(f"phase3 serving streams in {time.perf_counter() - t_serve:.1f} s")
    log("== phase 3 checkpoints: save mid-stream, restore, finish")
    t_ckpt = time.perf_counter()
    ckpt_recs = phase3_checkpoints(kmods, api, gen, device)
    recs += ckpt_recs
    log(f"phase3 checkpoints in {time.perf_counter() - t_ckpt:.1f} s")
    log("== phase 3 sharded: one card as an 8-member mesh")
    t_shard = time.perf_counter()
    recs += phase3_sharded(kmods, api, gen, device)
    log(f"phase3 sharded in {time.perf_counter() - t_shard:.1f} s")
    log("== phase 3 lm: granite-moe-1b-a400m served at full width")
    t_lm = time.perf_counter()
    recs.append(phase3_lm(kmods, device, args.seed))
    log(f"phase3 lm in {time.perf_counter() - t_lm:.1f} s")
    log("== phase 3 train: qwen3-0.6b at full width (lm_train)")
    t_train = time.perf_counter()
    train_rec = phase3_lm_train(kmods, device, args.seed)
    recs.append(train_rec)
    log(f"phase3 lm_train in {time.perf_counter() - t_train:.1f} s")
    log("== phase 3 train_moe: granite-moe-1b-a400m at full width (lm_train_moe)")
    t_moe = time.perf_counter()
    moe_rec = phase3_lm_train_moe(kmods, device, args.seed)
    recs.append(moe_rec)
    log(f"phase3 lm_train_moe in {time.perf_counter() - t_moe:.1f} s")
    log("== phase 3 train_dp: make_manual_dp_step on a (pod 2, data 2) mesh (lm_train_dp)")
    t_dp = time.perf_counter()
    recs.append(phase3_lm_train_dp(kmods, device, args.seed))
    log(f"phase3 lm_train_dp in {time.perf_counter() - t_dp:.1f} s")
    log("== phase 3 train_placed: train_loop over a (data 2, model 2) mesh (lm_train_placed)")
    t_placed = time.perf_counter()
    recs.append(phase3_lm_train_placed(kmods, device, args.seed, train_rec))
    log(f"phase3 lm_train_placed in {time.perf_counter() - t_placed:.1f} s")
    log("== phase 3 lm_ep: granite-moe-1b-a400m with expert parallelism over members (lm_ep)")
    t_ep = time.perf_counter()
    recs.append(phase3_lm_ep(kmods, device, args.seed, moe_rec))
    log(f"phase3 lm_ep in {time.perf_counter() - t_ep:.1f} s")
    log("== phase 3 serve_members: ServeLoop over a (data 2, model 2) mesh (serve_members)")
    t_sm = time.perf_counter()
    recs += phase3_serve_members(kmods, device, args.seed)
    log(f"phase3 serve_members in {time.perf_counter() - t_sm:.1f} s")
    log("== phase 3 launch: the serve and train CLIs on 4 virtual members (launch)")
    t_launch = time.perf_counter()
    recs.append(phase3_launch(kmods, device, args.seed))
    log(f"phase3 launch in {time.perf_counter() - t_launch:.1f} s")
    log("== phase 3 remat: qwen3-0.6b at full depth, 4 x 4096 tokens a step (lm_remat)")
    t_remat = time.perf_counter()
    recs.append(phase3_lm_remat(kmods, device, args.seed))
    log(f"phase3 lm_remat in {time.perf_counter() - t_remat:.1f} s")
    log("== phase 3 remat_families: every config's training path, remat vs direct "
        "(lm_remat_families)")
    t_fam = time.perf_counter()
    recs.append(phase3_lm_remat_families(kmods, device, args.seed))
    log(f"phase3 lm_remat_families in {time.perf_counter() - t_fam:.1f} s")
    log("== phase 3 serve_families: every config's serving path, and rwkv6 / zamba2 at full "
        "depth (lm_serve_families)")
    t_sf = time.perf_counter()
    recs.append(phase3_serve_families(kmods, device, args.seed))
    log(f"phase3 lm_serve_families in {time.perf_counter() - t_sf:.1f} s")
    launches = {k: sum(r["launches"][k] for r in recs) for k in kmods}
    log(f"phase3 done in {time.perf_counter() - t0:.1f} s; launches {json.dumps(launches)}")

    log("== phase dryrun: production cells on meta tensors, and the one-member steps")
    t_dry = time.perf_counter()
    phase_dryrun(kmods, device, args.seed, train_rec, moe_rec)
    log(f"phase dryrun in {time.perf_counter() - t_dry:.1f} s")

    log("== phase 4: timing")
    t0 = time.perf_counter()
    chunk_classes, chunk_vals = phase4_chunks(gen, device)
    timing = {"fused_groupby": phase4(fk, chunk_classes, chunk_vals, device)}
    block_sweep(fk, chunk_classes, chunk_vals, device)
    ticket_calls, split_timing = phase4_split(th, sa, chunk_classes, chunk_vals, device)
    timing.update(split_timing)
    scan_calls, scan_timing = phase4_scan(fk, sa, chunk_classes, chunk_vals, device,
                                          timing["fused_groupby"]["per_class"],
                                          timing["per_class"])
    timing.update(scan_timing)
    scan_block_sweep(fk, tk, chunk_classes, device)
    hybrid_calls, timing["hybrid_registers"] = phase4_hybrid(hr, thy, chunk_classes,
                                                             chunk_vals, gen, device)
    preagg_calls, timing["preagg"] = phase4_preagg(pa, api, chunk_classes, chunk_vals, device)
    timing["scan_ticket_batched"] = phase4_batched(fk, gen, device)
    timing["grouped_matmul"] = phase4_grouped_matmul(gm, gen, device)
    timing["segment_rows"] = phase4_segment_rows(sr, th, gen, device)
    timing["grouped_matmul_backward"] = phase4_grouped_matmul_backward(gm, gen, device)
    timing.update(phase4_table_ops(tops, chunk_classes, gen, device))
    phase4_profiles(timing, ticket_calls, scan_calls, hybrid_calls, preagg_calls)
    log("phase4 hybrid " + json.dumps(timing["hybrid_registers"]["per_class"]))
    for name in chunk_classes:
        f_ms = timing["fused_groupby"]["per_class"][name]["kernel_ms"]
        t_ms = timing["per_class"][name]["ticket"]["kernel_ms"]
        log(f"phase4 {name} chunk: fused {f_ms:.3f} ms beside the ticket kernel's "
            f"{t_ms:.3f} ms on the same keys (fused minus ticket {f_ms - t_ms:.3f} ms)")
    timing["fused_groupby"]["max_abs_err"] = max(max_err, timing["fused_groupby"]["max_abs_err"])
    for name, err in split_err.items():
        timing[name]["max_abs_err"] = max(err, timing[name]["max_abs_err"])
    for name in TABLE_OPS:  # map discrepancies (lookup: equal or not), phase 2 and 4
        timing[name]["max_abs_err"] = max(float(table_err), timing[name]["max_abs_err"])
    log(f"phase4 done in {time.perf_counter() - t0:.1f} s; "
        f"total {time.perf_counter() - t_all:.1f} s")

    # the scan route's two kernels, the register fold, the
    # pre-aggregation and the batched ticket launch replace plain jnp, the
    # grouped matmul jax.lax.ragged_dot, its backward ragged_dot's VJP and
    # the row segment sum jax.ops.segment_sum, not a Pallas kernel
    replaces = {"fused_groupby": "src/repro/kernels/fused_groupby.py:480",
                "ticket_hash": "src/repro/kernels/ticket_hash.py:193",
                "segment_agg": "src/repro/kernels/segment_agg.py:103",
                "scan_ticket": "src/repro/engine/groupby.py:144",
                "segment_agg_serialized": "src/repro/core/updates.py:219",
                "hybrid_registers": "src/repro/engine/executors.py:884",
                "preagg": "src/repro/core/partitioned.py:48",
                "scan_ticket_batched": "src/repro/engine/executors.py:613",
                "grouped_matmul": "src/repro/models/moe.py:109",
                "grouped_matmul_backward": "src/repro/models/moe.py:109",
                "segment_rows": "src/repro/models/layers.py:150", **TABLE_REPLACES}
    source = {"scan_ticket": "fused_groupby", "scan_ticket_batched": "fused_groupby",
              "segment_agg_serialized": "segment_agg",
              "grouped_matmul_backward": "grouped_matmul",
              "table_get_or_insert": "fused_groupby", "table_lookup": "table_ops",
              "table_migrate": "table_ops"}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{source.get(name, name)}.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": timing[name]["max_abs_err"],
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name in kmods]
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
