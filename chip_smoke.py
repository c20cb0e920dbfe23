"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100 (Hopper).
It imports the port (``src/repro_torch``), never JAX or the JAX package,
and exits non-zero — printing no result line — when no CUDA device is
available or when the package is missing.

Phases (every failed check raises; nothing is caught):

1. build — compile the hand-written CUDA kernels (``src/repro_torch/csrc``,
   ``nvcc`` for ``sm_90a``; ``ptxas -v`` for each) and print the seconds
   it took and the count of ``HGMMA`` (wgmma) instructions in each kernel's
   SASS (``cuobjdump -sass``), which must be non-zero for the tensor-core
   flash kernel;
2. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it: exact for hash_partition, probe and
   min/max (bit for bit, ``-0.0`` below ``+0.0`` on mixed signed zeros, on
   both segment paths), counts exact, float sums to ``1e-5 * sum|v|`` per
   group; times with CUDA events beside the bytes bound and a library
   yardstick.  The segment kernels also run at the sort groupby's shape
   (sorted ids, ``S`` = 2^25, one lane: the ``direct`` path), one
   ``segment_kernel`` line a shape and op with the path it took.  The
   probe walks the packed slot records (``slot_records``, timed as
   ``pack_ms``) and is held against the reference's walk over its three
   slot arrays; its row also counts the slot visits of the walk.
   ``windowed_scan`` runs on ``(2^25 - 3, 2)`` float32 values (a few NaN)
   with random segment starts, for windows 1, 7, 32, 512, 4096 and 8192
   (no multiple of ``n`` but 1) and sum/min/max: min/max exact with NaN
   propagating, sums bit-exact up to the kernel's 4096-row tile and within
   ``1e-5 * sum|v|`` over each window beyond it; then at ``rows=32`` on
   column views of an ``(n, 4)`` table, as the window engine calls it
   (``strided_ms``).  ``flash_attention``
   runs the serving path's prefill shapes — phi3-mini q/k/v (8, 32, 1024,
   96) in bfloat16 and float32, smollm's GQA (8, 15/5, 1024, 64), a
   mixtral-like (1, 32/8, 8192, 128) with ``window=4096``, a decode-like
   query at ``q_offset`` over a right-padded cache (``kv_len``) in float32
   and bfloat16, a ragged length of 1000, qwen2-moe's (8, 16, 1024, 128),
   internvl2's patch-prefixed (8, 64/8, 1280, 128), a non-causal
   whisper-encoder case (8, 16, 1500, 64), deepseek-67b's GQA (8,
   64/8, 1024, 128) and one rank's heads of it on a 1x4 mesh (8, 16/2,
   1024, 128; phase 31) — against its plain version
   to 2e-4 (float32, the SIMT kernel) and 2e-2 (bfloat16, the tensor-core
   kernel), each case naming the instance that ran (``impl``), timed
   beside ``scaled_dot_product_attention``;
3. main path, 1 shard, full size — ``DataFrame.from_dict`` of left = 2^25
   rows ``{k, g, v}`` and right = 2^23 rows ``{k, w}`` (the order of TPC-H
   SF10 ``lineitem`` against ``orders``), inner join on ``k``, a groupby on
   ``g`` (hash path, both segment kernels) and one on ``k`` (sort path),
   checked against a numpy oracle; the exchange counter must read 0; the
   segment kernels' launches by path (``segment_paths``): the hash
   groupby's on ``smem``, the sort groupby's sum ``direct``;
4. the same data on 4 virtual shards (launches hash_partition): the same
   rows, zero overflow, 3 exchanges, and the segment launches by path;
5. set ops on 4 shards, 2^22 rows a side: union and difference against
   ``np.union1d`` / ``np.setdiff1d``;
6. ordered analytics, 1 shard, full size — ``events`` = 2^25 rows ``{g:
   int32 over 2^16 partitions (~512 rows each), t: int32 over [0, 2^12)
   (ties inside a partition), v: float32 normal, q: float32 uniform [0,
   100)}``, the shape of a TPC-DS ``store_sales`` window query (TPC-DS
   v3 queries 47, 51 and 57: ``rank()``/``avg()`` and a cumulative
   ``sum()`` over ``partition by`` an item, ``order by`` a date) at one
   partition per item.  ``sort_values(["g", "t"])``, a rolling window
   (``rows=32``: sum, mean, min, max, count, lag, lead, rank,
   row_number), a cumulative window (sum, max), ``topk("v", 1000)`` and
   an exact ``quantile`` of ``v`` after ``sort_values("v")``, checked
   against a numpy oracle (order exact; counts, ranks, lag/lead, min/max
   exact; sums and means within ``1e-5 * sum|v|`` of each window); the
   exchange counter must read 0;
7. the same chain on 4 virtual shards: exactly 2 exchanges (the two
   sorts), no sort and no exchange inside the windows or the exact
   quantile, zero overflow, every exact lane equal to phase 6's;
8. serving, phi3-mini-3.8b at its full published width and depth (32
   layers, d_model 3072, 32 heads of 96, vocab 32064, bfloat16), random
   weights drawn on the card from ``--seed``: ``Engine.generate`` on 8
   prompts of 1024 tokens, greedy, 64 new tokens (``max_len`` = 1096, the
   launcher's rule).  The flash kernel must launch once per layer in the
   prefill, every launch on the tensor-core instance and within 2e-2 of
   the plain ``attend`` on its own q, k and v; the prefill's
   last-position logits must agree with the plain attention path
   (``use_flash=False``) to 2e-2 of the largest logit, and a float32
   copy of the model must give identical greedy tokens on both paths
   (batch 2, prompt 256, 16 tokens);
9. the same for smollm-360m (GQA 15/5, tied embeddings), full size;
10. the sort-merge join — phases 3 and 4's main path with
   ``join(method="sort")``, on 1 shard and on 4: the same numpy oracle,
   the join rows equal to phase 3's hash-join rows as a multiset, 0 and 3
   exchanges, no probe launch (segment kernels, and on 4 shards
   hash_partition, do launch); prints ``array_ops.SORTS``;
11. the cartesian product of two 2^12-row tables ``{k, v}`` x ``{k, w}``
   on 1 and 4 shards: 2^24 rows, equal as a multiset to numpy's product,
   no exchange;
12. storage, native ``.hpt`` in a temporary directory removed at the end.
   On 4 shards the left frame is written with ``to_hpt(partition_by=
   ["k"])`` and read back with ``DataFrame.read_dataset``: it re-enters
   partitioned on ``k``, so the join with the in-memory right frame and
   the two groupbys make 2 exchanges (phase 4: 3) with phase 4's oracle
   answers, and a join of two re-entered sides makes none; the same
   dataset read on 1 shard carries no partitioning.  On 1 shard the
   left frame sorted by ``k`` is written in row groups of 2^20 and read
   with ``columns=["k", "v"]`` and ``pred("k", "<", 2^22)``: the rows
   equal the numpy filter, and ``ScanStats`` skips exactly the fragments
   whose min/max prove them empty and reads 2 columns.  Prints the write
   and read seconds and rates (medians of 3 of the 4-shard dataset; the
   writer does not fsync and the reads follow the writes, so both go
   through the host's page cache and are not a disk's rate), the bytes
   on disk and the re-entry path's wall time;
13. out of core (``spill=True``), on 1 and on 4 virtual shards, at a
   quarter of phase 3's rows and phase 6's events under a quarter of the
   budget (``SPILL_SIZES``: left 2^23, right 2^21 rows, 2^23 events,
   ``budget_rows`` = 2^19 rows a shard; the partition counts of phase 3's
   sizes under 2^21, which ``scripts/group_services.py`` runs), each leg
   one checked, timed run whose
   ``spill_workdir`` (in a ``tempfile`` directory) already holds a file:
   the store's run directory, made inside it, holds no ``.tmp`` file when
   the operator returns and is gone after, and the file is left as it
   was.  The left and right frames
   through ``join(["k"], spill=True)`` (40 partitions on 1 shard, 10 on
   4), whose rows equal the unspilled hash join's rows as a multiset
   (that join held as phase 3 holds its own); that join
   output through ``groupby(["k"], sum/count/min/max, spill=True)``, keys,
   counts, min and max bit for bit against the card's exact per-key
   answers and sums within ``1e-5 * sum|v|`` of the float64 oracle;
   the events through ``window(["g"], ["t"]).agg(..., rows=32,
   spill=True)``, every exact lane equal to :func:`ordered_oracle` and
   sums within its tolerance.  0 exchanges in every leg, 0 sorts in the window
   legs (the host orders each partition), the probe, the segment kernels
   and ``windowed_scan`` launched on every shard of every pair.  After
   each leg, each kernel it ran is held against its plain version on the
   inputs of its first launch in the leg (one pair's shapes, copied as
   the leg ran; the tolerances of phase 2; ``pair_kernels``, timed).
   Before the legs, the
   spill partitioner's host hash (``spill.hashing.np_hash_columns``) is
   held against the ``hash_partition`` kernel over all 2^25 left keys:
   ``h1`` and ``h1 % 4`` against the kernel's hash and destination, bit
   for bit.  Prints per leg the seconds, ``SpillStats``, the run files'
   write and read GB/s (bytes over the seconds inside ``write_hpt`` /
   ``read_hpt``, CRC included, through the page cache) and peak GiB;
14. the lazy planner, on 4 virtual shards then 1: the left frame written
   as a ``.hpt`` dataset in a ``tempfile`` directory, then
   ``LazyFrame.read_parquet`` → ``filter(v > 0)`` → ``join(right, k)`` →
   ``groupby(k)`` → ``window(k, v_sum).agg(..., rows=32)`` against the
   same chain run eagerly through ``DataFrame``: the planned run's
   exchanges equal ``predicted_collectives`` and are fewer than the eager
   chain's on 4 shards (2 against 3; 0 on 1), the rows equal the eager
   chain's (sums within ``1e-5`` of each, every other lane bit for bit),
   zero overflow, ``explain()`` deterministic, and hash_partition (4
   shards), the probe, both segment kernels and ``windowed_scan``
   launched.  Prints planned and eager wall times (medians of 2 after
   the checked run) and the scan's alone, with and without the
   pushed-down filter (medians of 2);
15. the TSet dataflow, on 1 and 4 virtual shards: phases 3 and 6's
   frames as ``TSet.from_table`` in 8 chunks (2^22 rows a chunk on 1
   shard; 2^21 a shard on 4, phase 4's head-room of 2), through
   ``select(v > 0)`` and the combiner ``groupby`` by ``k`` (~7.3 M groups)
   and by ``g``, ``join(right, k)`` then ``groupby(g)``, ``reduce("v",
   "sum")``, ``window(["g"], ["t"], rows=32)`` and ``topk("v", 1000)`` of
   the events: each against the eager ``DataFrame`` chain of the same
   operators in the same run (keys, counts, min and max bit for bit,
   sums and means within ``1e-5 * sum|v|``) and, where phases 3 and 6 ran
   it, their oracles; zero overflow; exchanges 8 / 8 / 3 / 0 / 1 / 0 on 4
   shards (the combiner groupby one a chunk, none at the merge), 0 on 1;
   the kernels launched; the first chunk's segment-kernel inputs held
   against the plain versions (``chunk_kernels``);
16. telemetry: phases 3-4's main path under ``telemetry.trace()``, its
   ``table.join`` / ``table.groupby`` spans with their rows in and out,
   the 1-shard join span no shorter than that call's probe kernel (CUDA
   events: ``Span.block`` waits for the card), the exported Chrome trace
   and metrics files parsed, medians of 3 with telemetry on and off
   (interleaved); phase 14's 4-shard chain through ``collect(telemetry=,
   ledger=)``: the audit consistent (planner 2 == counted 2), a q-error a
   step, one ledger line read back, and ``explain(analyze=True)``
   annotating every step;
17. recovery and workflow.  Phase 14's 4-shard chain followed by a sort
   on ``v_sum`` (a second exchange stage; the chain alone has one) runs
   in a child process (``--crash-child``, the same ``--seed``) under
   ``collect(policy=FaultPolicy(checkpoint_dir=..., keep_checkpoints=
   True))`` with ``HPTMT_FAULTS=checkpoint.commit:crash:2``, which dies by
   SIGKILL between the second stage's snapshot and its rename; this
   process resumes: one stage restored, 1 exchange (the suffix), the
   committed join stage equal to an uncrashed run's as a bitwise row
   multiset, the rows' exact lanes bit for bit and their float sums
   within ``1e-5`` (the card's float atomics add in varying order); a
   rerun with every stage committed makes 0 exchanges and gives the same
   rows bit for bit; no ``.tmp`` is left.  ``CheckpointManager(
   async_save=True)`` saves and restores smollm-360m's bf16 parameters
   (random from the seed, ~0.72 GB) onto the card, bit for bit; a
   flipped byte raises ``CheckpointIntegrityError``; save and restore
   GB/s are printed.  A 3-task ``WorkflowEngine`` (scan → join + groupby
   → check against phase 3's oracle) retries one injected ``scan.read``
   fault through its policy, and a second engine resumes from the
   journal without running a task;
18.-24. serving every other family of the reference through the same
   ``Engine.generate`` traffic as phases 8-9 (8 prompts of 1024 tokens,
   greedy, 64 new tokens; random bf16 weights from ``--seed``; stub
   ``0.02 * normal`` frontend embeddings): qwen2-moe-a2.7b (12 of its 24
   layers, 60 experts padded to 64, 4 shared), minicpm3-4b (16 of its 62
   layers of MLA; both cut in depth to keep the script inside its time
   limit), xlstm-125m (12 layers), whisper-medium (24 + 24 layers over
   1500 frames), then cut in depth where bf16 would not fit 80 GB whole:
   mixtral-8x7b (8 of 32 layers), jamba-v0.1-52b (one 8-layer group: 7
   Mamba, 1 attention, 4 MoE) and internvl2-76b (8 of 80 layers, 256
   patches prefixing the prompt), every width as published.  Flash
   launches once per GQA self-attention layer of the decoder in the
   prefill, all on the tensor-core kernel (12 / 0 / 0 / 24 / 8 / 1 / 8);
   where it launches, each launch's output agrees with the plain
   ``attend`` on the same q, k and v to 2e-2 (phase 2's bf16 tolerance),
   the prefill logits of a dense model with the plain path's to 2e-2 of
   the largest logit (a MoE model's are printed: bf16 rounding flips a
   random router's near-ties), and a float32 copy gives identical greedy
   tokens on both (batch 2, prompt 256, 16 tokens; on a mismatch the
   smallest MoE gate margin is printed before the check fails);
   minicpm3, jamba (MoE capacity 8, the S-token prefill's expert ids
   replayed) and xlstm decode after a prefill of 1023 tokens agrees with
   a prefill of 1024 to 3e-2, minicpm3's absorbed decode with the naive
   one to 2e-2 in float32;
   the MoE dropped fraction is printed for a prefill and a decode step.
   Prefill ms, decode ms a token, tokens/s and peak GiB: one timed run
   (the time limit);
25. training, smollm-360m at its full published width and depth (32
   layers, d_model 960, GQA 15/5, vocab 49152, tied embeddings): float32
   masters drawn on the card from ``--seed``, bf16 compute, each layer
   rematerialized, batch 8 x 1024 random tokens.  The step launches no
   kernel (training runs the plain ``attend``: the flash kernel has no
   backward, as in the reference); its loss and grad norm are finite.
   Its gradients are held leaf by leaf against a float32-compute step's
   from the same masters and batch, with its loss and grad norm
   (``BF16_VS_F32``: about 3x the readings).  Prints step ms (host clock ending in a synchronize,
   median of 3 after a warm-up), tokens/s, peak GiB, the same with
   ``micro_batches=4`` (one timed run after a warm-up), the peak with remat on and off at batch 2 x 1024
   (on must be lower) and the model-FLOPs share (8 N a token, over the
   bf16 peak); ``use_flash=True`` in train mode must raise and launch
   nothing;
26. the pipeline → train → serve workflow (the reference's
   ``tests/test_system.py`` case) as three tasks of a journaled
   ``WorkflowEngine``: ``make_training_data`` on 4 virtual shards over
   ``CorpusConfig(n_docs=2^13, mean_doc_len=512, vocab_size=49152)``
   (~2^22 token rows: the probe and hash_partition launch); the curated
   stream bit for bit the plain path's (the same pipeline on the CPU) and
   the numpy oracle's but for the rows the reference's join drops on 4
   shards (printed); ``train_loop`` for 8 steps (checkpoint at 8 in a
   temporary directory, removed at the end), then a second loop to step
   10 that resumes from step 8; the loss falls; an ``Engine`` over a bf16
   model loaded from the trained masters generates 16 greedy tokens for
   8 prompts of 64, every flash launch held against ``attend`` on its
   inputs (2e-2) and the prefill's last logits against a train-mode
   forward of the same model (2e-2 of the largest).  Prints the
   preprocess seconds, exchanges, launches, losses, checkpoint GB/s and
   restore seconds, and the seconds of phases 25-26
   (``train_seconds``);
27. paper Table I and the MDS composition: (a) each global-view
   collective of ``core/array_ops.py`` (allreduce sum/max/mean,
   allgather, alltoall, reduce_scatter, broadcast, gather, scatter,
   reduce) on a 256 MB float32 input (``(4, 2^24)``; alltoall ``(16,
   2^22)``, so that each shard's block splits into one chunk a shard) on
   4 virtual shards and on 1, against a numpy oracle (exact, float sums
   and means to ``1e-6 * sum|x|``), alltoall one exchange on 4 shards and
   every other call none; ms (CUDA events) beside the bytes bound.  (b)
   ``apps/mds.py`` at 2^15 points, 3 dimensions, 100 SMACOF iterations
   (δ is 32768^2 float32, 4.3 GB) on 1 and 4 virtual shards: the curated
   ids and points equal the numpy oracle's, the table side makes 0 / 1
   exchanges (``sort_values``'s range exchange) and launches no kernel; δ
   on 4 shards against 1 and both against a float64 δ on 64 sampled rows;
   the stress path finite, its last value below 0.8 of its first, never
   rising beyond rounding, the float64 stress of the returned embedding
   not above its last value, the 1- and 4-shard paths alike
   (``MDS_LIMITS``); prints δ ms, ms a SMACOF iteration beside one read
   of δ, the 4-shard pipeline's seconds (median of 3 after a warm-up
   checked against the pieces' path) and peak GiB;
28. deepseek-67b served as phases 18-24 serve the families cut in depth:
   10 of its 95 layers (two of its nineteen 5-layer groups: 17.2 GB of
   bf16 weights), every width as published; 10 flash launches in the
   prefill, all on the tensor-core kernel, each held against ``attend``;
   the prefill logits against the plain path's (2e-2 of the largest);
   float32 greedy tokens equal on the SIMT kernel (10 launches) and the
   plain path.  Prints the seconds of phases 27-28 (``array_seconds``);
29. the table path on a ``torch.distributed`` process group
   (``repro_torch.launch.mesh``), 4 shards, two legs: (A) a 1-rank NCCL
   group in this process that holds all 4 shards; (B) 4 ranks, one
   spawned process each (NCCL with a card a rank where 4 cards exist,
   else ``gloo`` with every rank on card 0).  Each rank rebuilds phases
   3-7's data from ``--seed``, keeps its own rows and runs phase 4's main
   path, phase 5's set ops, phase 7's ordered chain, phase 27a's Table I
   operators on their 256 MB inputs and MDS at 2^13 points, once checked,
   then ``GROUP_RUNS`` times timed (MDS: the pipeline, its first run
   checked against its pieces).  Every result is held against the
   virtual run of its phase shard by shard: each shard's column blocks
   bit for bit (128-bit prints of their bits, :func:`digest`, made on
   the card, so no shard moves for the check), its
   counts, partitioning and overflow — but for the main path's float sums
   of the segment kernels' atomics (their order of addition varies run to
   run), which are held against phase 3's float64 oracle as phase 4 holds
   them, with the share of their blocks bit-equal printed; Table I against
   the operators rerun on 4 virtual shards, MDS's curated table, points
   and δ bit for bit and its stress path within ``MDS_LIMITS`` against a
   virtual run at 2^13 points.  Each rank's exchanges equal the virtual
   run's (3, 4, 2, 1) and each rank launches hash_partition, the probe,
   both segment kernels and ``windowed_scan``; the legs' launches join
   the ``kernels`` line.  Then the storage legs on the group, in a
   ``tempfile`` directory: the ranks write phase 12's left frame
   partitioned on ``k`` (one exchange; each rank its shards' files, rank
   0 the manifest; every file's blake2b equal to phase 12's virtual
   write's), re-enter it into phase 12's join → groupbys (2 exchanges, as
   phase 12; blocks by digest, the atomic sums against the oracle), run
   phase 15's ``groupby_k`` and ``join_groupby`` TSet pipelines (8 and 3
   exchanges; each shard's valid rows of the exact lanes against phase
   15's by digest, the sums against float64 oracles — ``groupby_k``'s
   on each rank's own shards, every present key held once over the
   ranks), and write phase 26's corpus to disk as ``.hpt`` and
   curate it there with ``make_training_data(data_root=...)`` (3
   exchanges; the stream's digest equal to phase 26's).  Then the
   services legs (``GROUP_SPILL``), held against one virtual 4-shard run
   of them made after leg A (``services_ref``): phase 13's spilled join →
   groupby and window cut to 2^23 x 2^21 rows and 2^23 events under
   ``budget_rows = 2^19`` (10 partitions), each in a workdir holding a
   file of its own (0 exchanges, 0 window sorts, ``SpillStats`` the
   virtual run's, no ``.tmp``, the run dir gone, the file kept, the probe,
   both segment kernels and ``windowed_scan`` launched on every rank),
   phase 14's planned chain over the ranks' partitioned dataset (counted
   == predicted exchanges, ``explain()`` the virtual run's, hash_partition
   launched), phase 17's workflow with a scan fault armed on the last rank
   only (every rank retries it once, the journal the virtual run's, a
   resume replays 3 tasks, a changed DAG refused on every rank) — the
   rows bit for bit but the atomic sums, held on each rank's own shards
   against float64 oracles; leg A runs the join and the chain.  Leg B's
   ranks then die by SIGKILL at phase 17's second stage commit (their
   results reach this process in files) — the committed stage byte for
   byte the virtual run's — and 2 new ranks of the same 4 shards resume
   with 1 exchange, the rows against the virtual run's.  Prints one
   ``group`` line a leg: backend, world, cards, medians and runs, the
   ``all_to_all`` ms of one packed shuffle frame of the join (with its
   bytes), each rank's peak GiB and seconds, ``storage``: the write's
   seconds a rank and GB/s, the re-entry read against phase 12's, the
   TSet pipelines against phase 15's, the corpus legs against phase 26's
   preprocess; ``services``: each leg's seconds, peak GiB, run-file
   bytes and GB/s a rank against the virtual run's seconds; ``resume``:
   the crash's and the resume's seconds and the stage's bytes;
30. training across ranks: the training launcher's mesh path
   (``launch.train.mesh_setup``: a 2x2 ``data x model`` mesh of
   sub-groups, ``make_training_data`` on the data axis's group, the
   rank's blocks of the masters drawn from ``--seed``, the FSDP x TP
   ``make_sharded_train_step``) on 4 spawned ranks — NCCL with a card a
   rank where 4 cards exist, else gloo with every rank on card 0 (NCCL
   refuses two ranks on a device).  (a) smollm-360m at published widths,
   4 of its 32 layers (whole in ``scripts/mesh_train.py``), float32
   masters, bf16 compute, batch 8 x 1024 on phase 26's corpus (2^15
   documents in the script): the
   curated stream on every rank bit for bit the same pipeline's on 2
   virtual shards on one card (digests), every rank launching
   hash_partition and the probe; the first step's grad norm and every
   gathered gradient against phase 25's one-card step on the same state
   and global batch, within ``BF16_VS_F32`` (about 3x phase 25's
   bf16-vs-float32 reading), its loss in float32 compute (the same
   blocks) to ``MESH_LOSS_F32_REL`` and in bf16 within 3x the larger of
   the two steps' own bf16-vs-float32 gaps (the checked step's model
   collectives timed, each synchronized); then 1 timed step.  (b)
   qwen2-moe-a2.7b at published widths, 2 of its 24 layers (~1.8 B
   parameters), expert parallel over ``model`` (64 padded experts), in
   float32 compute, batch 2 x 1024: one checked step against the
   one-card step with micro-batches = the data axis (the EP metrics'
   semantics), within ``MOE_MESH_LIMITS``.  Every rank's loss and grad
   norm the same.  Then (a)'s elastic checkpoint: after the timed step
   every rank saves its ``TrainState`` blocks (~1.0 GB of float32 leaves
   at 4 layers, 4.34 GB whole)
   with ``CheckpointManager.save(..., shardings=)`` in a ``tempfile``
   directory, and a second spawn of 2 ranks restores them on a
   ``RESTORE_DIMS`` (2x1) mesh: every restored block's digest equals
   that of ``shard_tensor`` of the leaf gathered on 2x2, and one
   float32-compute step there gives the 2x2 mesh's float32 loss on the
   same state and global batch to ``MESH_LOSS_F32_REL``.  One ``mesh_train`` line a config: backend, world,
   cards, step ms (one timed step: the time limit), tokens/s, peak GiB a
   rank, the checked step's model collectives by kind and axis and
   their ms a rank, the phase's seconds, and (a)'s ``checkpoint``: the
   files' bytes, save seconds a rank and GB/s, restore seconds and GB/s
   a rank, the float32 losses; the ranks' launches join the ``kernels``
   line;
31. serving across ranks: the reference's prefill and decode cells
   (``launch/cells.py:serve_cell``: each rank's parameter blocks by
   ``param_specs`` drawn from ``--seed``, its cache blocks by
   ``cache_specs``; the engine on the mesh) on 4 spawned ranks — NCCL
   with a card a rank where 4 cards exist, else gloo on card 0.  (a)
   deepseek-67b at full width, 10 of 95 layers as phase 28, on a 1x4
   mesh (16/2 heads, d_ff 5504, vocab 25,600 a rank), bf16, phase 28's
   serve shape: 10 tensor-core flash launches a rank on its local heads,
   each held against ``attend`` on its own q, k, v (``FlashTap``, 2e-2),
   the gathered last logits within 2e-2 of the largest of phase 28's;
   (b) smollm-360m whole on 2x2 (replicated attention, the
   sequence-sharded cache and its softmax merge, FSDP gathers over
   ``data``, the tied vocab-split head): bf16 logits within 2e-2 of phase
   9's, 2 tokens; then float32 at ``SERVE_F32`` on the SIMT kernel:
   greedy tokens equal to the one-card float32 run's, every gathered
   cache leaf after the prefill and the last step against its
   (``pos`` and ``cursor`` exactly, K/V to ``MESH_CACHE_F32``); (c)
   qwen2-moe-a2.7b at published widths, 2 of 24 layers, EP over model on
   2x2, float32 at ``SERVE_F32``: greedy tokens and caches against one
   card, the MoE dropped fractions printed.  One ``mesh_serve`` line a
   config: backend, world, cards, mesh, prefill ms, decode ms a token,
   tokens/s, peak GiB a rank, one decode step's model collectives by
   kind and axis with their ms (each synchronized) beside the step's ms
   untimed, the phase's seconds; the ranks' flash launches join the
   ``kernels`` line;
32. summary — the script's seconds so far, the ``kernels`` JSON line, the
   card's name and power limit, and as the last line ``{"ok": true,
   "device": {...}}``.

Wall times of phases 3-7 and 10-12 are medians of 3 runs after one
checked warm-up run; kernel launch counts are those of the checked runs.
``--profile`` adds one ``torch.profiler`` run of each of phases 3-10,
of phase 12's re-entry path, of phase 14's 4-shard planned chain, of
phase 15's 4-shard ``groupby_k`` and ``join_groupby`` pipelines, of
phase 16's traced
4-shard main path, of one generate of qwen2-moe and of jamba and of one
phase-25 train step (device busy share, top kernels; a table of each in
the output directory that ``profile_run`` writes to).
Float32 matrix products run in full float32 (TF32 off, PyTorch's
default, set here).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import hashlib
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate

T_START = time.perf_counter()
LEFT_ROWS, RIGHT_ROWS = 1 << 25, 1 << 23
GROUPS, G_OUT_CAP = 1024, 2048
SET_ROWS = 1 << 22
G_AGGS = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
          ("w", "sum"), ("v", "count")]
EVENTS, ITEMS, DAYS = 1 << 25, 1 << 16, 1 << 12
ROLL = 32
W_AGGS = [("v", "sum"), ("v", "mean"), ("q", "sum"), ("v", "min"),
          ("v", "max"), (None, "count"), ("v", "lag"), ("v", "lead"),
          (None, "rank"), (None, "row_number")]
CUM_AGGS = [("v", "sum"), ("v", "max")]
TOPK = 1000
QS = (0.01, 0.5, 0.99)
WINDOWS = (1, 7, 32, 512, 4096, 8192)
SERVE = {"batch": 8, "prompt": 1024, "gen": 64}
SERVE_F32 = {"batch": 2, "prompt": 256, "gen": 16}
# phases 18-24: config, depth on the card (None: all its layers), timed
# runs; a cut config is one that does not fit 80 GB whole in bf16
#: qwen2-moe and minicpm3 cut in depth too (PR 24): the script stays
#: inside its time limit with phase 30 added
FAMILIES = [("qwen2-moe-a2.7b", 12, 1), ("minicpm3-4b", 16, 1),
            ("xlstm-125m", None, 1), ("whisper-medium", None, 1),
            ("mixtral-8x7b", 8, 1), ("jamba-v0.1-52b", 8, 1),
            ("internvl2-76b", 8, 1)]
# phase 28: deepseek-67b, 10 of its 95 layers (two of its nineteen 5-layer
# groups): 17.2 GB of bf16 weights, where whole it would take ~134 GB
DEEPSEEK = ("deepseek-67b", 10, 1)
DECODE_VS_PREFILL = ("minicpm3-4b", "jamba-v0.1-52b", "xlstm-125m")
PROFILED = ("phi3-mini-3.8b", "smollm-360m", "qwen2-moe-a2.7b",
            "jamba-v0.1-52b")
CART_ROWS = 1 << 12
ROWS_PER_GROUP, K_BELOW = 1 << 20, 1 << 22


def check(cond, what: str) -> None:
    if not bool(cond):
        raise AssertionError(f"check failed: {what}")


def emit(tag: str, **fields) -> None:
    """One JSON line; ``t`` is the seconds since the script started."""
    print(json.dumps({"phase": tag, "t": time.perf_counter() - T_START,
                      **fields}), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, nops: float = 0.0, ops_per_s=FP32_OPS_PER_S):
    """Least time for the work on this card: ``(ms, "bytes"|"operations")``."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bit_key(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def canonical(rows: dict, names) -> torch.Tensor:
    """Rows as an ``(n, len(names))`` int64 matrix, lexsorted — a bitwise
    multiset fingerprint computed on the card."""
    cols = [bit_key(rows[n]).to(torch.int64) for n in names]
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols):
        order = order[torch.argsort(c[order], stable=True)]
    return torch.stack([c[order] for c in cols], dim=1)


# ---------------------------------------------------------------------------
# data and oracles
# ---------------------------------------------------------------------------
def make_data(seed: int, left_rows: int = LEFT_ROWS,
              right_rows: int = RIGHT_ROWS):
    rng = np.random.default_rng(seed)
    left = {"k": rng.integers(0, right_rows, left_rows, dtype=np.int32),
            "g": rng.integers(0, GROUPS, left_rows, dtype=np.int32),
            "v": rng.standard_normal(left_rows, dtype=np.float32)}
    right = {"k": rng.permutation(right_rows).astype(np.int32),
             "w": rng.standard_normal(right_rows, dtype=np.float32)}
    sets = {"a": rng.integers(0, 1 << 23, SET_ROWS, dtype=np.int32),
            "b": rng.integers(0, 1 << 23, SET_ROWS, dtype=np.int32)}
    return left, right, sets


def make_oracle(left, right):
    """float64 numpy answers of the main path."""
    n_left, n_right = left["k"].shape[0], right["k"].shape[0]
    w_of_key = np.empty(n_right, np.float32)
    w_of_key[right["k"]] = right["w"]
    w = w_of_key[left["k"]]  # every left row matches exactly one right row
    order = np.argsort(left["g"], kind="stable")
    gs = left["g"][order]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    vs, ws = left["v"][order], w[order]
    g = {"g": gs[starts],
         "v_count": np.diff(np.r_[starts, n_left]),
         "v_min": np.minimum.reduceat(vs, starts),
         "v_max": np.maximum.reduceat(vs, starts),
         "v_sum": np.add.reduceat(vs.astype(np.float64), starts),
         "v_abs": np.add.reduceat(np.abs(vs).astype(np.float64), starts),
         "w_sum": np.add.reduceat(ws.astype(np.float64), starts),
         "w_abs": np.add.reduceat(np.abs(ws).astype(np.float64), starts)}
    cnt = np.bincount(left["k"], minlength=n_right)
    present = np.flatnonzero(cnt)
    k = {"k": present.astype(np.int32),
         "v_sum": np.bincount(left["k"], left["v"].astype(np.float64),
                              n_right)[present],
         "v_abs": np.bincount(left["k"], np.abs(left["v"]).astype(np.float64),
                              n_right)[present]}
    return {"w_of_key": w_of_key, "g": g, "k": k}


def check_close(got, ref, scale, what):
    err = np.abs(np.asarray(got, np.float64) - ref)
    check((err <= 1e-5 * scale).all(),
          f"{what}: max |err|/sum|v| = {float((err / scale).max())}")


def check_join(jdf, left_dev, oracle, tag: str):
    """The main path's join: one row a left row, each matched, with the
    ``w`` of its key; returns the rows."""
    j = jdf.table.valid_rows()
    check(j["k"].shape[0] == left_dev["k"].shape[0], f"{tag}: join rows")
    check(bool(j["_matched"].all()), f"{tag}: every join row matched")
    wk = torch.from_numpy(oracle["w_of_key"]).to(j["k"].device)
    check(torch.equal(j["w"], wk[j["k"].long()]), f"{tag}: join payload w")
    check(torch.equal(canonical(j, ["k", "g", "v"]),
                      canonical(left_dev, ["k", "g", "v"])),
          f"{tag}: join rows are the left rows")
    return j


def check_groupby_g(g, oracle, tag):
    """A ``G_AGGS`` groupby on ``g`` of the main path's join against the
    float64 oracle (rows in any order): keys, counts, min and max exact,
    sums and means within ``1e-5 * sum|v|``; returns the rows by key."""
    order = np.argsort(g["g"])
    g = {k: v[order] for k, v in g.items()}
    o = oracle["g"]
    check(np.array_equal(g["g"], o["g"]), f"{tag}: groupby g keys")
    check(np.array_equal(g["v_count"], o["v_count"]), f"{tag}: g counts")
    check(np.array_equal(g["v_min"], o["v_min"]), f"{tag}: g min")
    check(np.array_equal(g["v_max"], o["v_max"]), f"{tag}: g max")
    check_close(g["v_sum"], o["v_sum"], o["v_abs"], f"{tag}: g v_sum")
    check_close(g["w_sum"], o["w_sum"], o["w_abs"], f"{tag}: g w_sum")
    check_close(g["v_mean"], o["v_sum"] / o["v_count"],
                o["v_abs"] / o["v_count"], f"{tag}: g v_mean")
    return g


def check_main_path(res, left_dev, oracle, tag: str):
    """Exact row counts, keys, counts and min/max; sums within
    ``1e-5 * sum|v|`` per group of the float64 oracle."""
    j = check_join(res["j"], left_dev, oracle, tag)
    g = check_groupby_g(res["g"].to_numpy(), oracle, tag)

    k = res["k"].to_numpy()
    order = np.argsort(k["k"], kind="stable")
    o = oracle["k"]
    check(np.array_equal(k["k"][order], o["k"]), f"{tag}: groupby k keys")
    check_close(k["v_sum"][order], o["v_sum"], o["v_abs"], f"{tag}: k v_sum")
    return j, g


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def main_path(DataFrame, ctx, left, right, bucket_factor, method="auto"):
    """The slice's main path through the user entry points."""
    ldf = DataFrame.from_dict(left, ctx, bucket_factor=bucket_factor)
    rdf = DataFrame.from_dict(right, ctx, bucket_factor=bucket_factor)
    return join_groupbys(ldf, rdf, method)


def join_groupbys(ldf, rdf, method="auto"):
    """Join on ``k``, then group by ``g`` and by ``k``."""
    j = ldf.join(rdf, ["k"], method=method)
    g = j.groupby(["g"], G_AGGS, out_capacity=G_OUT_CAP)
    k = j.groupby(["k"], [("v", "sum")])
    torch.cuda.synchronize()
    return {"j": j, "g": g, "k": k}


def make_cart(seed: int):
    rng = np.random.default_rng(seed + 2)
    return ({"k": rng.integers(0, 1 << 20, CART_ROWS, dtype=np.int32),
             "v": rng.standard_normal(CART_ROWS, dtype=np.float32)},
            {"k": rng.integers(0, 1 << 20, CART_ROWS, dtype=np.int32),
             "w": rng.standard_normal(CART_ROWS, dtype=np.float32)})


def cartesian_path(DataFrame, table_ops, ctx, a, b):
    adf, bdf = DataFrame.from_dict(a, ctx), DataFrame.from_dict(b, ctx)
    out = table_ops.cartesian(adf.table, bdf.table, ctx=ctx)
    torch.cuda.synchronize()
    return out


def set_ops(DataFrame, ctx, sets):
    a = DataFrame.from_dict({"k": sets["a"]}, ctx, bucket_factor=2.0)
    b = DataFrame.from_dict({"k": sets["b"]}, ctx, bucket_factor=2.0)
    u, d = a.union(b), a.difference(b)
    torch.cuda.synchronize()
    return {"union": u, "difference": d}


class Launches:
    """Reset every kernel's launch counter, then read them."""

    def __init__(self):
        from repro_torch.core import array_ops
        from repro_torch.kernels.hash_join import kernel as hjk
        from repro_torch.kernels.hash_partition import kernel as hpk
        from repro_torch.kernels.segment_reduce import kernel as srk
        from repro_torch.kernels.flash_attention import kernel as fak
        from repro_torch.kernels.window_scan import kernel as wsk
        self.counters = {"hash_partition": hpk.LAUNCHES, "probe": hjk.LAUNCHES,
                         "segment_reduce_fused": srk.FUSED_LAUNCHES,
                         "segment_reduce": srk.LAUNCHES,
                         "windowed_scan": wsk.LAUNCHES,
                         "flash_attention": fak.LAUNCHES}
        self.flash_instances = fak.INSTANCE_LAUNCHES
        self.segment_paths = {"segment_reduce_fused": srk.FUSED_PATH_LAUNCHES,
                              "segment_reduce": srk.PATH_LAUNCHES}
        self.exchanges = array_ops.EXCHANGES
        self.sorts = array_ops.SORTS
        self.total = dict.fromkeys(self.counters, 0)

    def reset(self):
        paths = [c for p in self.segment_paths.values() for c in p.values()]
        for c in (*self.counters.values(), *self.flash_instances.values(),
                  *paths):
            c.reset()
        self.exchanges.reset()
        self.sorts.reset()

    def paths(self):
        """Segment-kernel launches by the path each took (smem/direct)."""
        return {k: {p: c.n for p, c in v.items()}
                for k, v in self.segment_paths.items()}

    def read(self):
        got = {k: c.n for k, c in self.counters.items()}
        for k, n in got.items():
            self.total[k] += n
        return got, self.exchanges.n


def profile_run(tag: str, fn) -> None:
    """One run of ``fn`` under ``torch.profiler``: device busy share and
    the top kernels by device time, written to ``chiprun_out/``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device work only: kernels and copies (operator rows repeat their
    # kernels' time; the profiler's own buffer request is not work)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.key != "Activity Buffer Request"]
    busy_us = sum(getattr(e, key) for e in device)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", f"profile_{tag}.txt")
    with open(path, "w") as f:
        f.write(events.table(sort_by=key, row_limit=40))
    top = sorted(device, key=lambda e: getattr(e, key), reverse=True)[:8]
    emit("profile", run=tag, wall_s=wall, device_busy_s=busy_us / 1e6,
         busy_share=busy_us / 1e6 / wall,
         top=[(e.key, getattr(e, key) / 1e3) for e in top])


def timed_runs(fn, runs: int = 3):
    """Wall seconds of ``runs`` calls (each ends synchronized)."""
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def visited_slots(table_row, ph1, ph2, pvalid, max_probes):
    """``(distinct, total)`` slots the probe walk visits: the distinct ones
    price the bytes bound, the total is the slot reads a walk makes (one
    sector each with the packed records)."""
    slots = table_row.shape[0]
    h1 = ph1.to(torch.int64) & 0xFFFFFFFF
    step = (ph2.to(torch.int64) & 0xFFFFFFFF) | 1
    seen = torch.zeros(slots, dtype=torch.bool, device=table_row.device)
    active = pvalid.clone()
    total, j = 0, 0
    while j < max_probes and bool(active.any()):
        slot = (h1 + j * step) & (slots - 1)
        seen[slot[active]] = True
        total += int(active.sum())
        active &= table_row[slot] >= 0
        j += 1
    return int(seen.sum()), total


def kernel_phase(left, right, dev):
    """Every kernel against its plain version at the main path's shapes."""
    from repro_torch.core import HPTMTContext
    from repro_torch.core.exchange import key_compare_u32
    from repro_torch.core.table import _as_u32, hash_columns
    from repro_torch.core.table_ops import _hash_slots
    from repro_torch.dataframe import DataFrame
    from repro_torch.kernels.hash_join import kernel as hjk
    from repro_torch.kernels.hash_join import ref as hjr
    from repro_torch.kernels.hash_partition import kernel as hpk
    from repro_torch.kernels.hash_partition import ref as hpr
    from repro_torch.kernels.segment_reduce import kernel as srk
    from repro_torch.kernels.segment_reduce import ref as srr

    rows = []

    # 1. hash_partition: one shard of the 4-shard left table (phase 4)
    t4 = DataFrame.from_dict({"k": left["k"]}, HPTMTContext(4, dev),
                             bucket_factor=2.0).table
    keys = _as_u32(t4.columns["k"][0])[:, None].contiguous()
    cap = keys.shape[0]
    valid = torch.arange(cap, device=dev) < t4.counts[0]
    for hashes in (False, True):
        got = hpk.hash_partition_cuda(keys, valid, 4, return_hashes=hashes)
        exp = hpr.hash_partition_lanes(keys, valid, 4, return_hashes=hashes)
        for a, b in zip(got, exp):
            check(torch.equal(a, b), f"hash_partition (hashes={hashes})")
    ms = cuda_ms(lambda: hpk.hash_partition_cuda(keys, valid, 4, True))
    plain = cuda_ms(lambda: hpr.hash_partition_lanes(keys, valid, 4, True))
    b_ms, b_by = bound(cap * (4 + 1) + cap * 12 + 4 * 4, cap * 40)
    rows.append(dict(name="hash_partition", shape=f"keys ({cap}, 1), P=4",
                     max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None))
    del t4, keys, valid, got, exp

    # 2. probe: the 1-shard join (build 2^23 rows into 2^25 slots)
    rk = torch.from_numpy(right["k"]).to(dev)
    lk = torch.from_numpy(left["k"]).to(dev)
    rh1, rh2 = hash_columns([rk])
    lh1, lh2 = hash_columns([lk])
    slots = _hash_slots(RIGHT_ROWS)
    table, unplaced = hjr.build_table(rh1, rh2,
                                      torch.ones_like(rk, dtype=torch.bool),
                                      slots, 64)
    check(int(unplaced) == 0, "build table placed every row")
    rlanes = key_compare_u32({"k": rk}, ["k"])
    llanes = key_compare_u32({"k": lk}, ["k"])
    pvalid = torch.ones_like(lk, dtype=torch.bool)
    records, side = hjr.slot_records(table, rh2, rlanes)
    args = (records, side, lh1, lh2, llanes, pvalid, 1, 64)
    got = hjk.probe_cuda(*args)
    # the yardstick: the reference's walk over its three slot arrays
    sh2, skeys = hjr.slot_payload(table, rh2, rlanes)
    exp = hjr.probe(table, sh2, skeys, lh1, lh2, llanes, pvalid, 1, 64)
    for a, b in zip(got, exp):
        check(torch.equal(a, b), "probe bit-identical")
    check(bool((got[0] == 1).all()), "every probe row matched once")
    del sh2, skeys, exp
    ms = cuda_ms(lambda: hjk.probe_cuda(*args))
    pack = cuda_ms(lambda: hjr.slot_records(table, rh2, rlanes))
    plain = cuda_ms(lambda: hjr.probe_records(*args), reps=2)
    n = LEFT_ROWS
    seen, visits = visited_slots(table, lh1, lh2, pvalid, 64)
    b_ms, b_by = bound(n * (4 + 4 + 4 + 1) + n * (4 + 4 + 1) + seen * 12)
    rows.append(dict(name="probe", shape=f"N={n}, S={slots}, L=1, M=1",
                     max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, pack_ms=pack,
                     slots_read=seen, visits=visits,
                     visits_per_row=visits / n))
    del got, args, table, records, side

    # 3./4. segment reductions: the 1-shard hash groupby on g
    g = torch.from_numpy(left["g"]).to(dev)
    v = torch.from_numpy(left["v"]).to(dev)
    w_of_key = torch.empty(RIGHT_ROWS, dtype=torch.float32, device=dev)
    w_of_key[rk.long()] = torch.from_numpy(right["w"]).to(dev)
    w = w_of_key[lk.long()]
    gslots = _hash_slots(G_OUT_CAP)
    gh1, gh2 = hash_columns([g])
    _, seg, unres = hjr.build_table_unique(
        gh1, gh2, key_compare_u32({"g": g}, ["g"]),
        torch.ones_like(g, dtype=torch.bool), gslots, 64)
    check(not bool(unres.any()), "every group resolved")
    S = gslots  # the sentinel slot of unresolved rows is dropped
    vals = torch.stack([torch.ones_like(v), v, w], dim=1)
    got = srk.segment_reduce_fused_cuda(vals, seg, S)
    exp = srr.segment_reduce_fused(vals, seg, S)
    scale = srr.segment_reduce_fused(vals.abs(), seg, S)
    err = (got - exp).abs()
    check(torch.equal(got[:, 0], exp[:, 0]), "fused count lane exact")
    check(bool((err <= 1e-5 * scale).all()), "fused sums within 1e-5 sum|v|")
    ms = cuda_ms(lambda: srk.segment_reduce_fused_cuda(vals, seg, S))
    plain = cuda_ms(lambda: srr.segment_reduce_fused(vals, seg, S), reps=2)
    seg64 = seg.long()
    lib = cuda_ms(lambda: torch.zeros(S, 3, device=dev).index_add_(
        0, seg64, vals))
    L = vals.shape[1]
    b_ms, b_by = bound(n * L * 4 + n * 4 + S * L * 4, n * L)
    rows.append(dict(name="segment_reduce_fused", shape=f"N={n}, L={L}, S={S}",
                     max_abs_err=float(err.max()), ms=ms, plain_ms=plain,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    cases = [dict(rows[-1], path=srk.path(S, L))]
    check(cases[-1]["path"] == "smem", "the hash groupby's sum is privatized")

    # the sort groupby on k: ids of the sorted join rows, S = its capacity
    order = torch.argsort(lk, stable=True)
    sk = lk[order]
    new = torch.ones_like(sk, dtype=torch.bool)
    new[1:] = sk[1:] != sk[:-1]
    kseg = (torch.cumsum(new, 0, dtype=torch.int32) - 1).contiguous()
    kvals = v[order][:, None].contiguous()
    KS = LEFT_ROWS
    got = srk.segment_reduce_fused_cuda(kvals, kseg, KS)
    exp = srr.segment_reduce_fused(kvals, kseg, KS)
    scale = srr.segment_reduce_fused(kvals.abs(), kseg, KS)
    err = (got - exp).abs()
    check(bool((err <= 1e-5 * scale).all()), "sorted-id sums within 1e-5 "
          "sum|v|")
    kseg64 = kseg.long()
    b_ms, b_by = bound(n * 4 + n * 4 + KS * 4, n)
    cases.append(dict(
        name="segment_reduce_fused", path=srk.path(KS, 1),
        shape=f"N={n}, L=1, S={KS}, sorted ids ({int(new.sum())} runs)",
        max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: srk.segment_reduce_fused_cuda(kvals, kseg, KS)),
        plain_ms=cuda_ms(lambda: srr.segment_reduce_fused(kvals, kseg, KS),
                         reps=2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.zeros(KS, 1, device=dev).index_add_(
            0, kseg64, kvals))))
    check(cases[-1]["path"] == "direct", "the sort groupby's sum is direct")
    del got, exp, scale, err, kseg64

    worst, ms_ops, plain_ops, lib_ops = 0.0, [], [], []
    b_ms, b_by = bound(n * 4 + n * 4 + S * 4, n)
    for op in ("min", "max"):
        got = srk.segment_reduce_cuda(v, seg, S, op)
        exp = srr.segment_reduce(v, seg, S, op)
        check(torch.equal(bit_key(got), bit_key(exp)), f"segment {op} exact")
        ms_ops.append(cuda_ms(lambda: srk.segment_reduce_cuda(v, seg, S, op)))
        plain_ops.append(cuda_ms(lambda: srr.segment_reduce(v, seg, S, op),
                                 reps=2))
        init = float("inf") if op == "min" else float("-inf")
        lib_ops.append(cuda_ms(lambda: torch.full((S,), init, device=dev)
                               .scatter_reduce_(0, seg64, v, "a" + op,
                                                include_self=True)))
        cases.append(dict(name="segment_reduce", path=srk.path(S, 1),
                          shape=f"N={n}, S={S}, op={op}", max_abs_err=0.0,
                          ms=ms_ops[-1], plain_ms=plain_ops[-1],
                          bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ops[-1]))
    # mixed +-0.0 on both paths, bit for bit: -0.0 is the min, +0.0 the max
    # (a zero takes the sign of the row's v; groups with id % 7 == 0 hold
    # only +0.0, == 3 only -0.0)
    for ids, segs, sign in ((seg, S, v), (kseg, KS, kvals[:, 0])):
        pos = torch.zeros(n, device=dev)
        z = torch.where(sign < 0, -pos, pos)
        z = torch.where(ids % 7 == 0, pos, torch.where(ids % 7 == 3, -pos, z))
        for op in ("min", "max"):
            got = srk.segment_reduce_cuda(z, ids, segs, op)
            exp = srr.segment_reduce(z, ids, segs, op)
            zero = exp == 0
            check(bool(exp[zero].signbit().any())
                  and not bool(exp[zero].signbit().all()),
                  "both signs of zero among the results")
            check(torch.equal(bit_key(got), bit_key(exp)),
                  f"segment {op} on +-0.0, {srk.path(segs, 1)} path, "
                  "bit for bit")
    del kseg, kvals, order, sk, new
    # NaN propagates through min and max as in the reference
    nv = torch.tensor([1.0, float("nan"), 3.0, 2.0], device=dev)
    ns = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev)
    lo = srk.segment_reduce_cuda(nv, ns, 3, "min").cpu().numpy()
    hi = srk.segment_reduce_cuda(nv, ns, 3, "max").cpu().numpy()
    check(np.array_equal(lo, [np.nan, 2, np.inf], equal_nan=True), "min NaN")
    check(np.array_equal(hi, [np.nan, 3, -np.inf], equal_nan=True), "max NaN")
    rows.append(dict(name="segment_reduce", shape=f"N={n}, S={S}, op=min/max",
                     max_abs_err=worst, ms=statistics.mean(ms_ops),
                     plain_ms=statistics.mean(plain_ops), bound_ms=b_ms,
                     bound_by=b_by, library_ms=statistics.mean(lib_ops)))
    return rows, cases


def window_kernel_phase(dev):
    """``windowed_scan`` against its plain version for every window and
    op; returns the kernels-line row at the main path's shape (the
    rolling window's fused sum lanes) and the per-case rows."""
    from repro_torch.kernels.window_scan import kernel as wsk
    from repro_torch.kernels.window_scan import ref as wsr

    n, lanes = EVENTS - 3, 2  # no multiple of any window but 1
    gen = torch.Generator(device=dev).manual_seed(7)
    v = torch.randn((n, lanes), generator=gen, device=dev)
    v[torch.randint(0, n, (64,), generator=gen, device=dev), 0] = float("nan")
    flags = torch.rand(n, generator=gen, device=dev) < 1 / 512
    flags[0] = True
    seg = torch.cummax(torch.where(flags, torch.arange(n, device=dev), 0),
                       0).values.to(torch.int32)
    absv = v.abs().nan_to_num()
    worst, cases = 0.0, []
    for w in WINDOWS:
        for op in ("sum", "min", "max"):
            got = wsk.windowed_scan_cuda(v, seg, w, op)
            exp = wsr.windowed_scan(v, seg, w, op)
            what = f"windowed_scan w={w} {op}"
            check(torch.equal(got.isnan(), exp.isnan()), f"{what}: NaN rows")
            ok = ~exp.isnan()
            if op != "sum" or w <= wsk.TILE:
                check(torch.equal(got.view(torch.int32)[ok],
                                  exp.view(torch.int32)[ok]),
                      f"{what}: bit-exact")
                err = 0.0
            else:
                scale = wsr.windowed_scan(absv, seg, w, "sum")
                diff = (got - exp).abs()[ok]
                check(bool((diff <= 1e-5 * scale[ok]).all()),
                      f"{what}: within 1e-5 sum|v|")
                err = float(diff.max())
            worst = max(worst, err)
            del got, exp
            ms = cuda_ms(lambda: wsk.windowed_scan_cuda(v, seg, w, op))
            plain = cuda_ms(lambda: wsr.windowed_scan(v, seg, w, op), reps=2)
            cases.append(dict(window=w, op=op, ms=ms, plain_ms=plain,
                              max_abs_err=err))
    # NaN in a window gives NaN under min and max (and sum)
    nv = torch.tensor([[1.0], [float("nan")], [3.0], [2.0], [5.0]],
                      device=dev)
    ns = torch.tensor([0, 0, 0, 3, 3], dtype=torch.int32, device=dev)
    nan = float("nan")
    for op, want in (("min", [1, nan, nan, 2, 2]),
                     ("max", [1, nan, nan, 2, 5]),
                     ("sum", [1, nan, nan, 2, 7])):
        got = wsk.windowed_scan_cuda(nv, ns, 2, op)[:, 0].cpu().numpy()
        check(np.array_equal(got, np.array(want, np.float32), equal_nan=True),
              f"windowed_scan {op} NaN propagation: {got}")
    # the window engine's call: sum lanes and a min/max column sliced out of
    # one (n, 4) table, read through their row stride without a copy
    table = torch.cat([v, torch.randn((n, 2), generator=gen, device=dev)], 1)
    strided = {}
    for op, view in (("sum", table[:, :lanes]), ("min", table[:, 2:3]),
                     ("max", table[:, 3:4])):
        got = wsk.windowed_scan_cuda(view, seg, ROLL, op)
        exp = wsr.windowed_scan(view.contiguous(), seg, ROLL, op)
        check(torch.equal(got.view(torch.int32), exp.view(torch.int32)),
              f"windowed_scan strided {op}: bit-exact")
        strided[op] = cuda_ms(lambda: wsk.windowed_scan_cuda(view, seg, ROLL,
                                                             op))
    del table, got, exp
    head = next(c for c in cases if c["window"] == ROLL and c["op"] == "sum")
    b_ms, b_by = bound(n * lanes * 4 * 2 + n * 4, 3 * n * lanes)
    row = dict(name="windowed_scan",
               shape=f"({n}, {lanes}) f32, w={ROLL}, sum",
               max_abs_err=worst, ms=head["ms"], plain_ms=head["plain_ms"],
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               strided_ms=strided,
               one_lane_bound_ms=bound(n * 4 * 2 + n * 4, 3 * n)[0])
    return row, cases


# b, hq, hkv, sq, sk, d, dtype, causal, window, kv_len, q_offset: the
# serving path's prefill shapes (the first is the kernels-line row)
FLASH_CASES = [
    ("phi3 prefill", 8, 32, 32, 1024, 1024, 96, "bfloat16", True, None,
     None, 0),
    ("phi3 prefill f32", 8, 32, 32, 1024, 1024, 96, "float32", True, None,
     None, 0),
    ("smollm prefill", 8, 15, 5, 1024, 1024, 64, "bfloat16", True, None,
     None, 0),
    ("mixtral-like window", 1, 32, 8, 8192, 8192, 128, "bfloat16", True,
     4096, None, 0),
    ("decode-like", 8, 32, 32, 1, 1096, 96, "float32", True, None, 1024,
     1023),
    ("decode-like bf16", 8, 32, 32, 1, 1096, 96, "bfloat16", True, None,
     1024, 1023),
    ("ragged", 2, 8, 8, 1000, 1000, 96, "float32", True, None, None, 0),
    ("qwen2-moe prefill", 8, 16, 16, 1024, 1024, 128, "bfloat16", True,
     None, None, 0),
    ("internvl2 prefill", 8, 64, 8, 1280, 1280, 128, "bfloat16", True, None,
     None, 0),
    ("whisper encoder", 8, 16, 16, 1500, 1500, 64, "bfloat16", False, None,
     None, 0),
    ("deepseek-67b prefill", 8, 64, 8, 1024, 1024, 128, "bfloat16", True,
     None, None, 0),
    ("deepseek-67b rank prefill", 8, 16, 2, 1024, 1024, 128, "bfloat16",
     True, None, None, 0),
]


def attn_pairs(sq, sk, causal, window, kv_len, q_offset) -> int:
    """(query, key) pairs the masks allow, per batch-head: the work this
    run's inputs need."""
    p = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.full(sq, min(sk, sk if kv_len is None else kv_len) - 1)
    if causal:
        hi = np.minimum(hi, p)
    lo = np.zeros(sq, np.int64) if window is None else p - window + 1
    return int(np.clip(hi - np.maximum(lo, 0) + 1, 0, None).sum())


def flash_kernel_phase(dev):
    """``flash_attention`` against its plain version on the serving
    shapes; returns the kernels-line row (phi3 prefill, bf16) and the
    per-case rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention import ref as far

    gen = torch.Generator(device=dev).manual_seed(11)
    cases, row = [], None
    for (name, b, hq, hkv, sq, sk, d, dtype, causal, window, kv_len,
         q_offset) in FLASH_CASES:
        dt = getattr(torch, dtype)
        # q/k/v as the model hands them over: (B, S, H, D) transposed
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(dt)
        kv = torch.randn((b, sk, 2 * hkv, d), generator=gen, device=dev
                         ).to(dt)
        q, k, v = (q.transpose(1, 2), kv[:, :, :hkv].transpose(1, 2),
                   kv[:, :, hkv:].transpose(1, 2))
        kw = dict(causal=causal, window=window, kv_len=kv_len,
                  q_offset=q_offset)
        impl = fak.INSTANCES[dt]
        before = fak.INSTANCE_LAUNCHES[impl].n
        got = fak.flash_attention_cuda(q, k, v, **kw)
        check(fak.INSTANCE_LAUNCHES[impl].n == before + 1,
              f"flash_attention {name}: ran the {impl} kernel")
        exp = far.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = 2e-4 if dtype == "float32" else 2e-2
        err = (got.float() - exp.float()).abs()
        check(bool((err <= tol + tol * exp.float().abs()).all()),
              f"flash_attention {name}: max |err| {float(err.max())}")
        check(got.dtype == dt and got.shape == exp.shape,
              f"flash_attention {name}: dtype/shape")
        del got, exp
        ms = cuda_ms(lambda: fak.flash_attention_cuda(q, k, v, **kw))
        plain = cuda_ms(lambda: far.flash_attention(q, k, v, **kw), reps=2)
        pairs = b * hq * attn_pairs(sq, sk, causal, window, kv_len, q_offset)
        nbytes = (2 * b * hq * sq + 2 * b * hkv * sk) * d * q.element_size()
        # each type at its own peak: bf16 on the tensor cores, float32 on
        # the FMA units
        b_ms, b_by = bound(nbytes, 4 * pairs * d, BF16_OPS_PER_S
                           if dtype == "bfloat16" else FP32_OPS_PER_S)
        lib = None
        if window is None and kv_len is None and q_offset == 0:
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hq != hkv))
        case = dict(case=name, impl=impl, shape=f"q {tuple(q.shape)} k "
                    f"{tuple(k.shape)} {dtype}", max_abs_err=float(err.max()),
                    ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib)
        cases.append(case)
        if row is None:
            row = dict(name="flash_attention", **{
                k: case[k] for k in ("impl", "shape", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")})
        del q, k, v, kv, err
    torch.cuda.empty_cache()
    return row, cases


def set_cfg(model, **changes) -> None:
    """Set fields of the config every module of ``model`` reads: the flash
    switch (``use_flash=None`` is the default, the kernel on the card in
    prefill), MLA's absorbed decode, the MoE capacity factor."""
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = dataclasses.replace(m.cfg, **changes)


def flash_layers(cfg) -> int:
    """Self-attention layers that run the flash kernel in prefill: every
    GQA ``attn`` layer of the decoder (MLA and the other mixers attend
    without it; an encoder runs ``train`` mode, the plain path)."""
    if cfg.attention == "mla":
        return 0
    return cfg.block_pattern.count("attn") * cfg.n_groups


def router_gates(xn, router, cfg):
    """A MoE layer's softmax gates over every expert (``routing``'s)."""
    from repro_torch.models import moe
    return torch.softmax(moe.router_logits(xn, router, cfg), -1)


class RouteTape:
    """Records the expert ids of every MoE routing call of a run, then
    replays them in another run, so that both route every token alike.
    Gates are the replaying run's own, taken at the replayed ids;
    ``rerouted`` counts the tokens whose own top-k differed from the
    replayed one.  A recording also keeps the smallest gap between a
    token's k-th and (k+1)-th gate (``min_margin``)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe.routing
        self.tape, self.rerouted, self.min_margin = [], 0, None

    @contextlib.contextmanager
    def _patched(self, fn):
        self.moe.routing = fn
        try:
            yield self
        finally:
            self.moe.routing = self.real

    def recording(self):
        self.tape, self.min_margin = [], None

        def record(xn, router, cfg):
            out = self.real(xn, router, cfg)
            self.tape.append(out[1])
            top = torch.topk(router_gates(xn, router, cfg),
                             cfg.experts_per_token + 1).values
            gap = float((top[..., -2] - top[..., -1]).min())
            self.min_margin = (gap if self.min_margin is None
                               else min(gap, self.min_margin))
            return out

        return self._patched(record)

    def replaying(self, positions=slice(None)):
        """Replay the tape, each call's ids cut to ``positions``."""
        queue = list(self.tape)

        def replay(xn, router, cfg):
            _, own, aux, z = self.real(xn, router, cfg)
            ids = queue.pop(0)[:, positions]
            self.rerouted += int((own.sort(-1).values
                                  != ids.sort(-1).values).any(-1).sum())
            g = router_gates(xn, router, cfg).gather(-1, ids)
            return (g / torch.clamp(g.sum(-1, keepdim=True), min=1e-9),
                    ids, aux, z)

        self.rerouted = 0
        return self._patched(replay)


class FlashTap:
    """Holds every flash launch of a run against the plain ``attend`` on
    the same q, k and v (the model's own activations), with phase 2's
    bf16 tolerance: a check of the kernel in place that no rounding
    upstream of the layer can move."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops
        self.ops, self.real = ops, ops.flash_attention
        self.layers, self.max_abs_err, self.bad = 0, 0.0, []
        self.shape = None       # the first launch's (q, k) shapes

    def __enter__(self):
        from repro_torch.models.layers import attend

        def tapped(q, k, v, *, causal=True, window=None):
            o = self.real(q, k, v, causal=causal, window=window)
            self.shape = self.shape or (tuple(q.shape), tuple(k.shape))
            pos = torch.arange(q.shape[2], device=q.device)
            exp = attend(q, k, v, q_pos=pos, kv_pos=pos, causal=causal,
                         window=window).float()
            err = (o.float() - exp).abs()
            self.max_abs_err = max(self.max_abs_err, float(err.max()))
            if not bool((err <= 2e-2 + 2e-2 * exp.abs()).all()):
                self.bad.append((self.layers, float(err.max())))
            self.layers += 1
            return o

        self.ops.flash_attention = tapped
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.real


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def serve_phase(arch: str, dev, seed: int, launches, profile: bool,
                depth=None, runs: int = 3):
    """Serve ``arch`` at its full published width (``depth`` layers when
    given, else all) on the card: tokens, flash launches, the plain path,
    float32 greedy tokens, and for the families that have them the MoE
    drops, decode against prefill and MLA's absorbed decode.  Returns the
    prefill's last logits and the greedy tokens, on the host (phase 31's
    one-card yardsticks)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Engine, ServeConfig

    marks = {"start": time.perf_counter()}
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    b, s, n = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    rng = np.random.default_rng(seed + 2)
    prompts = rng.integers(1, cfg.vocab_size, (b, s), dtype=np.int32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = LM(cfg, gen, dev)
    fe = None
    if cfg.frontend is not None or cfg.is_encoder_decoder:
        # stub audio frames / image patches, as the launchers make them
        fe = 0.02 * torch.randn((b, cfg.frontend_seq, cfg.d_model),
                                generator=gen, device=dev)
    prefix = cfg.frontend_seq if cfg.frontend == "vision" else 0
    max_len = prefix + s + n + 8
    engine = Engine(model, ServeConfig(max_len=max_len))
    n_flash = flash_layers(cfg)

    marks["build"] = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    out = engine.generate(prompts, n, frontend_embeds=fe)
    counts, _ = launches.read()
    instances = {k: c.n for k, c in launches.flash_instances.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(out.shape == (b, n) and out.dtype == np.int32, f"{arch}: tokens")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), f"{arch}: token ids")
    check(counts["flash_attention"] == n_flash,
          f"{arch}: flash launches {counts['flash_attention']} per prefill, "
          f"expected {n_flash}")
    check(instances == {"wgmma": n_flash, "simt": 0},
          f"{arch}: bf16 prefill launches by instance {instances}, expected "
          f"all {n_flash} on the tensor-core kernel")

    def prefill():
        logits, _ = engine.prefill(prompts, fe)
        torch.cuda.synchronize()
        return logits

    fields = {}
    with FlashTap() as tap:
        flash_logits = prefill()
    check(bool(flash_logits.isfinite().all()), f"{arch}: finite logits")
    kept = {"logits": flash_logits.float().cpu(), "tokens": out}
    if n_flash:
        # each layer's flash output against the plain attend on its own
        # inputs, then the logits against the plain path's (2e-2 of the
        # largest logit); a MoE model's logits are reported, not held: a
        # random router's top-k near-ties flip under bf16 rounding, and a
        # flipped token's later layers go elsewhere
        check(tap.layers == n_flash and not tap.bad,
              f"{arch}: flash against plain attend in {tap.layers} layers, "
              f"outside 2e-2: {tap.bad}")
        fields["flash_vs_plain_attention_max_abs_err"] = tap.max_abs_err
        set_cfg(model, use_flash=False)
        plain_logits = prefill()
        set_cfg(model, use_flash=None)
        rel = rel_err(flash_logits, plain_logits)
        fields["flash_vs_plain_rel"] = rel
        if not cfg.is_moe:
            check(rel < 2e-2, f"{arch}: flash vs plain prefill logits rel "
                  f"{rel}")
        del plain_logits
    del flash_logits

    tape = RouteTape()
    toks = torch.as_tensor(prompts, device=dev)
    last = torch.tensor([prefix + s - 1], dtype=torch.int32, device=dev)
    if cfg.is_moe:
        # the reference's drops: prefill groups of one row (capacity
        # 1.25x a row's share), decode one group of the batch (capacity 4)
        with torch.inference_mode():
            _, cache, aux_p = model(toks, mode="prefill",
                                    cache_len=max_len, frontend_embeds=fe,
                                    last_logit_only=True)
            _, _, aux_d = model(toks[:, -1:], mode="decode", cache=cache,
                                positions=last + 1)
        n_moe = sum(type(ly.ffn).__name__ == "MoE" for ly in model.layers)
        fields["moe_dropped_frac"] = {
            "prefill": float(aux_p["moe_dropped_frac"]) / n_moe,
            "decode": float(aux_d["moe_dropped_frac"]) / n_moe,
            "moe_layers": n_moe}
        del cache
    if arch in DECODE_VS_PREFILL:
        # the reference's own check: decode after a prefill of S-1 tokens
        # against a prefill of S, 3e-2 of the largest logit (MoE capacity
        # 8: the two groupings drop nothing).  A MoE model's two runs
        # replay the S-token prefill's expert ids, since bf16 rounding
        # flips a random router's near-ties; the replay cannot see a fault
        # in decode's own choice of experts, which the CPU tests hold bit
        # for bit against the reference
        if cfg.is_moe:
            set_cfg(model, capacity_factor=8.0)

        def split(first=contextlib.nullcontext, then=contextlib.nullcontext,
                  absorb=False):
            with torch.inference_mode():
                with first():
                    _, cache, _ = model(
                        toks[:, :-1], mode="prefill", cache_len=max_len,
                        frontend_embeds=fe, last_logit_only=True)
                with then():
                    dec, _, _ = model(toks[:, -1:], mode="decode",
                                      cache=cache, positions=last)
                if absorb:
                    set_cfg(model, mla_absorb=True)
                    absorbed, _, _ = model(toks[:, -1:], mode="decode",
                                           cache=cache, positions=last)
                    set_cfg(model, mla_absorb=False)
                    return dec[:, 0], absorbed[:, 0]
            return dec[:, 0], None

        with torch.inference_mode(), tape.recording():
            full, _, _ = model(toks, mode="prefill", cache_len=max_len,
                               frontend_embeds=fe, last_logit_only=True)
        full = full[:, -1]
        if cfg.is_moe:
            fields["decode_vs_prefill_free_routing_rel"] = rel_err(
                split()[0], full)
            dec, _ = split(lambda: tape.replaying(slice(None, -1)),
                           lambda: tape.replaying(slice(-1, None)))
            fields["decode_vs_prefill_rerouted_tokens"] = tape.rerouted
        else:
            dec, absorbed = split(absorb=cfg.attention == "mla")
        set_cfg(model, capacity_factor=cfg.capacity_factor)
        rel = rel_err(dec, full)
        fields["decode_vs_prefill_rel"] = rel
        check(rel < 3e-2, f"{arch}: decode vs prefill logits rel {rel} "
              f"({fields})")
        if cfg.attention == "mla":
            # bf16 here: the absorbed path rounds its latent scores to
            # bf16 (the reference's formulation); held in float32 below
            fields["absorbed_vs_naive_bf16_rel"] = rel_err(absorbed, dec)
            del absorbed
        del full, dec

    marks["checks"] = time.perf_counter()
    pre = timed_runs(prefill, runs)
    gen_runs = timed_runs(lambda: engine.generate(prompts, n,
                                                  frontend_embeds=fe), runs)
    marks["timed"] = time.perf_counter()
    if profile and arch in PROFILED:
        profile_run(f"serve_{arch}", lambda: engine.generate(
            prompts, n, frontend_embeds=fe))
    del engine, model
    torch.cuda.empty_cache()

    if n_flash or cfg.attention == "mla":
        f = SERVE_F32
        model = LM(dataclasses.replace(cfg, dtype="float32"),
                   torch.Generator(device=dev).manual_seed(seed), dev)
        engine = Engine(model, ServeConfig(
            max_len=prefix + f["prompt"] + f["gen"] + 8))
        small = prompts[:f["batch"], :f["prompt"]]
        fe_small = None if fe is None else fe[:f["batch"]]
    if n_flash:
        # float32: identical greedy tokens on the kernel and the plain path
        launches.reset()
        toks32 = engine.generate(small, f["gen"], frontend_embeds=fe_small)
        simt = launches.flash_instances["simt"].n
        check(simt == n_flash, f"{arch}: float32 prefill ran {simt} SIMT "
              f"flash launches, expected {n_flash}")
        set_cfg(model, use_flash=False)
        with tape.recording():
            plain_toks = engine.generate(small, f["gen"],
                                         frontend_embeds=fe_small)
        if not np.array_equal(toks32, plain_toks):
            emit(f"serve_{arch}_f32_mismatch", flash=toks32.tolist(),
                 plain=plain_toks.tolist(), min_gate_margin=tape.min_margin)
        check(np.array_equal(toks32, plain_toks),
              f"{arch}: float32 greedy tokens differ between flash and plain")
        fields["f32_tokens_equal"] = True
        if cfg.is_moe:
            fields["f32_min_gate_margin"] = tape.min_margin
    if cfg.attention == "mla":
        # the reference's check (tests/test_models.py): absorbed MLA decode
        # against the naive expansion, 2e-2 of the largest logit, here in
        # float32 at full width
        toks32 = torch.as_tensor(small, device=dev)
        pos = torch.tensor([f["prompt"] - 1], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            _, cache, _ = model(toks32[:, :-1], mode="prefill",
                                cache_len=f["prompt"], last_logit_only=True)
            naive, _, _ = model(toks32[:, -1:], mode="decode", cache=cache,
                                positions=pos)
            set_cfg(model, mla_absorb=True)
            absorbed, _, _ = model(toks32[:, -1:], mode="decode",
                                   cache=cache, positions=pos)
        rel = rel_err(absorbed, naive)
        check(rel < 2e-2, f"{arch}: float32 absorbed vs naive decode rel "
              f"{rel}")
        fields["absorbed_vs_naive_f32_rel"] = rel
        del cache, naive, absorbed
    if n_flash or cfg.attention == "mla":
        del engine, model
        torch.cuda.empty_cache()

    marks["float32"] = time.perf_counter()
    pre_s, gen_s = statistics.median(pre), statistics.median(gen_runs)
    steps = list(marks)
    fields["phase_seconds"] = {b: marks[b] - marks[a]
                               for a, b in zip(steps, steps[1:])}
    emit(f"serve_{arch}", launches=counts, flash_instances=instances,
         layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers or None,
         frontend_seq=cfg.frontend_seq or None,
         batch=b, prompt=s, new_tokens=n,
         prefill_ms=pre_s * 1e3, decode_ms_per_token=(gen_s - pre_s)
         / (n - 1) * 1e3, generate_s=gen_s, tokens_per_s=b * n / gen_s,
         prefill_runs_s=pre, generate_runs_s=gen_runs, peak_gib=peak,
         **fields)
    return kept


def make_events(seed: int, n: int = EVENTS):
    rng = np.random.default_rng(seed + 1)
    return {"g": rng.integers(0, ITEMS, n, dtype=np.int32),
            "t": rng.integers(0, DAYS, n, dtype=np.int32),
            "v": rng.standard_normal(n, dtype=np.float32),
            "q": rng.uniform(0, 100, n).astype(np.float32)}


def window_reduce(x, a, op: str):
    """Exact ``op(x[a[i] .. i])`` for every ``i``: a sparse table of
    power-of-two spans, each window covered by two overlapping spans."""
    n = x.shape[0]
    i = torch.arange(n, device=x.device)
    k = torch.frexp((i - a + 1).double())[1] - 1  # floor(log2(len))
    f = torch.minimum if op == "min" else torch.maximum
    out = torch.empty_like(x)
    level = x
    for j in range(int(k.max()) + 1):
        sel = k == j
        out[sel] = f(level[a[sel]], level[i[sel] - (1 << j) + 1])
        span = 1 << j
        level = torch.cat([f(level[:n - span], level[span:]),
                           level[n - span:]])
    return out


def ordered_oracle(ev):
    """Answers of the ordered chain (float64 sums, exact the rest),
    computed with plain torch on the card (on the host where there is
    none) and returned as numpy arrays.

    Sums never come from differences of one running sum over the whole
    table: against its magnitude a short window's float64 rounding would
    exceed the ``1e-5 * sum|v|`` the check allows."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    e = {k: torch.from_numpy(v).to(dev) for k, v in ev.items()}
    order = torch.argsort(e["t"], stable=True)
    order = order[torch.argsort(e["g"][order], stable=True)]
    o = {k: v[order] for k, v in e.items()}
    n = order.shape[0]
    i = torch.arange(n, device=dev)
    g, t, v, q = o["g"], o["t"], o["v"], o["q"]
    zero = torch.zeros(1, dtype=torch.bool, device=dev)
    new_g = torch.cat([~zero, g[1:] != g[:-1]])
    seg = torch.cummax(torch.where(new_g, i, 0), 0).values
    runs = torch.cat([~zero, (g[1:] != g[:-1]) | (t[1:] != t[:-1])])
    run_start = torch.cummax(torch.where(runs, i, 0), 0).values
    a = torch.maximum(i - (ROLL - 1), seg)

    def rolling(x):
        """float64 window sums and sums of |x|, one shifted add a row."""
        tot = torch.zeros(n, dtype=torch.float64, device=dev)
        mag = torch.zeros_like(tot)
        for j in range(ROLL):
            xj = torch.where(i - j >= a, torch.roll(x, j), 0).double()
            tot += xj
            mag += xj.abs()
        return tot, mag

    def cumulative(x):
        """float64 running sums inside each partition, on a (partitions,
        longest partition) matrix, so no sum cancels against another
        partition's."""
        sid = torch.cumsum((seg == i).long(), 0) - 1
        pos = i - seg
        m = torch.zeros((int(sid[-1]) + 1, int(pos.max()) + 1),
                        dtype=torch.float64, device=dev)
        m[sid, pos] = x.double()
        tot = torch.cumsum(m, 1)[sid, pos]
        m[sid, pos] = x.abs().double()
        return tot, torch.cumsum(m, 1)[sid, pos]

    count = i - a + 1
    v_sum, v_abs = rolling(v)
    q_sum, q_abs = rolling(q)
    same_next = torch.cat([seg[1:] == seg[:-1], zero])
    roll = {"count": count, "row_number": i - seg + 1,
            "rank": run_start - seg + 1,
            "v_lag": torch.where(i - 1 >= seg, torch.roll(v, 1), 0),
            "v_lead": torch.where(same_next, torch.roll(v, -1), 0),
            "v_min": window_reduce(v, a, "min"),
            "v_max": window_reduce(v, a, "max")}
    close = {"v_sum": (v_sum, v_abs), "q_sum": (q_sum, q_abs),
             "v_mean": (v_sum / count, v_abs / count)}
    cum = {"v_max": window_reduce(v, seg, "max")}
    cum_close = {"v_sum": cumulative(v)}
    sv = torch.sort(e["v"]).values
    tq = np.asarray(QS, np.float32) * np.float32(n - 1)
    lo, hi = np.floor(tq).astype(np.int64), np.ceil(tq).astype(np.int64)
    svl, svh = sv[lo].cpu().numpy(), sv[hi].cpu().numpy()
    q_exact = svl + (tq - lo.astype(np.float32)) * (svh - svl)
    host = lambda d: {k: (tuple(x.cpu().numpy() for x in c)
                          if isinstance(c, tuple) else c.cpu().numpy())
                      for k, c in d.items()}
    return {"sorted": host(o), "roll": host(roll), "close": host(close),
            "cum": host(cum), "cum_close": host(cum_close),
            "top": sv.flip(0)[:TOPK].cpu().numpy(),
            "q": q_exact, "q_np": np.quantile(ev["v"], QS)}


def ordered_path(DataFrame, ctx, ev, bucket_factor, sorts):
    """The ordered chain through the user entry points; ``sorts`` (the
    sort counter) is read around the windows and the exact quantile."""
    df = DataFrame.from_dict(ev, ctx, bucket_factor=bucket_factor)
    s = df.sort_values(["g", "t"])
    before = sorts.n
    roll = s.window(["g"], ["t"]).agg(W_AGGS, rows=ROLL)
    cum = s.window(["g"], ["t"]).agg(CUM_AGGS, rows=None)
    win_sorts = sorts.n - before
    top = s.topk("v", TOPK)
    sv = s.sort_values("v")
    before = sorts.n
    q = sv.quantile("v", QS, method="exact")
    torch.cuda.synchronize()
    return {"sorted": s, "roll": roll, "cum": cum, "top": top, "sv": sv,
            "q": q, "win_sorts": win_sorts, "q_sorts": sorts.n - before}


def check_ordered(res, oracle, tag: str):
    """Order exact, exact lanes exact, sums within ``1e-5 * sum|v|`` of
    each window; returns the windows' columns."""
    got = res["sorted"].to_numpy()
    for k, want in oracle["sorted"].items():
        check(np.array_equal(got[k], want), f"{tag}: sorted column {k}")
    out = {}
    for name, exact, close in (("roll", oracle["roll"], oracle["close"]),
                               ("cum", oracle["cum"], oracle["cum_close"])):
        w = res[name].to_numpy()
        for k, want in exact.items():
            check(np.array_equal(w[k], want), f"{tag}: {name} {k}")
        for k, (want, scale) in close.items():
            check_close(w[k], want, scale, f"{tag}: {name} {k}")
        check(res[name].overflow_report.is_exact(), f"{tag}: {name} exact")
        out[name] = w
    check(np.array_equal(res["top"].to_numpy()["v"], oracle["top"]),
          f"{tag}: topk values")
    check(np.array_equal(res["q"], oracle["q"]), f"{tag}: exact quantile "
          f"{res['q']} vs {oracle['q']}")
    check(np.allclose(res["q"], oracle["q_np"], rtol=1e-5, atol=1e-6),
          f"{tag}: quantile vs np.quantile")
    check(res["win_sorts"] == 0, f"{tag}: windows sorted {res['win_sorts']}x")
    check(res["q_sorts"] == 0, f"{tag}: exact quantile sorted")
    return out


SOURCES = {
    "hash_partition": ("src/repro_torch/csrc/hash_partition.cu",
                       "src/repro/kernels/hash_partition/kernel.py:75"),
    "probe": ("src/repro_torch/csrc/probe.cu",
              "src/repro/kernels/hash_join/kernel.py:70"),
    "segment_reduce_fused": ("src/repro_torch/csrc/segment_reduce.cu",
                             "src/repro/kernels/segment_reduce/kernel.py:111"),
    "segment_reduce": ("src/repro_torch/csrc/segment_reduce.cu",
                       "src/repro/kernels/segment_reduce/kernel.py:80"),
    "windowed_scan": ("src/repro_torch/csrc/window_scan.cu",
                      "src/repro/kernels/window_scan/kernel.py:75"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/flash_attention/kernel.py:104"),
}


def sort_join_phase(DataFrame, ctx1, ctx4, left, right, left_dev, oracle,
                    launches, j1, profile: bool):
    """Phases 3-4's main path with ``join(method="sort")`` (phase 10)."""
    names = sorted(j1)
    for tag, ctx, bf, want in (("sort_join_1shard", ctx1, 1.0, 0),
                               ("sort_join_4shards", ctx4, 2.0, 3)):
        launches.reset()
        res = main_path(DataFrame, ctx, left, right, bf, method="sort")
        counts, ex = launches.read()
        sorts = launches.sorts.n
        check(ex == want, f"{tag}: exchanges {ex}, want {want}")
        check(counts["probe"] == 0, f"{tag}: the sort join launches no probe")
        check(counts["segment_reduce_fused"] > 0
              and counts["segment_reduce"] > 0, f"{tag}: segment kernels")
        check(ctx.n_shards == 1 or counts["hash_partition"] > 0,
              f"{tag}: hash_partition")
        check(res["j"].overflow_report.is_exact(), f"{tag}: exact")
        js, _ = check_main_path(res, left_dev, oracle, tag)
        check(torch.equal(canonical(js, names), canonical(j1, names)),
              f"{tag}: the rows of phase 3's hash join")
        del res, js
        runs = timed_runs(lambda: main_path(DataFrame, ctx, left, right, bf,
                                            method="sort"))
        if profile:
            profile_run(tag, lambda: main_path(DataFrame, ctx, left, right,
                                               bf, method="sort"))
        emit(tag, launches=counts, exchanges=ex, sorts=sorts,
             median_s=statistics.median(runs), runs_s=runs)


def cartesian_phase(DataFrame, ctx1, ctx4, seed, dev, launches):
    """``cartesian`` of two 2^12-row tables against numpy's product
    (phase 11)."""
    from repro_torch.core import table_ops

    ca, cb = make_cart(seed)
    ca_dev = {k: torch.from_numpy(v).to(dev) for k, v in ca.items()}
    cb_dev = {k: torch.from_numpy(v).to(dev) for k, v in cb.items()}
    names = ["a_k", "a_v", "b_k", "b_w"]
    want = canonical({"a_k": ca_dev["k"].repeat_interleave(CART_ROWS),
                      "a_v": ca_dev["v"].repeat_interleave(CART_ROWS),
                      "b_k": cb_dev["k"].repeat(CART_ROWS),
                      "b_w": cb_dev["w"].repeat(CART_ROWS)}, names)
    for tag, ctx in (("cartesian_1shard", ctx1), ("cartesian_4shards", ctx4)):
        launches.reset()
        out = cartesian_path(DataFrame, table_ops, ctx, ca, cb)
        _, ex = launches.read()
        check(ex == 0, f"{tag}: exchanges {ex}")
        check(torch.equal(canonical(out.valid_rows(), names), want),
              f"{tag}: the rows of numpy's product")
        del out
        runs = timed_runs(lambda: cartesian_path(DataFrame, table_ops, ctx,
                                                 ca, cb))
        emit(tag, rows=CART_ROWS * CART_ROWS, exchanges=ex,
             median_s=statistics.median(runs), runs_s=runs)


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for f in os.listdir(root))


def file_digests(root: str, keep=lambda name: True) -> dict:
    """``name → blake2b`` of the files in ``root`` that ``keep`` names."""
    out = {}
    for name in sorted(os.listdir(root)):
        if keep(name):
            with open(os.path.join(root, name), "rb") as f:
                out[name] = hashlib.blake2b(f.read(),
                                            digest_size=16).hexdigest()
    return out


def storage_phase(DataFrame, ctx1, ctx4, left, right, left_dev, oracle,
                  launches, profile: bool):
    """Native ``.hpt`` storage on the card: partitioned re-entry on 4
    shards, projection and predicate pushdown on 1 (phase 12)."""
    from repro_torch.io import open_dataset, pred, read_dataset

    out = {}
    with tempfile.TemporaryDirectory(prefix="hptmt_smoke_") as tmp:
        lroot, rroot, sroot = (os.path.join(tmp, n)
                               for n in ("left", "right", "sorted"))
        ldf = DataFrame.from_dict(left, ctx4, bucket_factor=2.0)
        rdf = DataFrame.from_dict(right, ctx4, bucket_factor=2.0)
        launches.reset()
        t0 = time.perf_counter()
        ldf.to_hpt(lroot, partition_by=["k"])
        writes = [time.perf_counter() - t0]
        counts_w, ex_w = launches.read()
        check(ex_w == 1 and counts_w["hash_partition"] > 0,
              f"the partitioned write shuffles once: {ex_w}, {counts_w}")
        nbytes = dir_bytes(lroot)
        files = file_digests(lroot)  # phase 29's groups write the same
        for i in (1, 2):  # two more writes for the median, then removed
            again = f"{lroot}_{i}"
            writes += timed_runs(
                lambda: ldf.to_hpt(again, partition_by=["k"]), runs=1)
            check(dir_bytes(again) == nbytes, "rewrites are the same size")
            shutil.rmtree(again)
        del ldf

        def read_left():
            lp = DataFrame.read_dataset(lroot, ctx4)
            torch.cuda.synchronize()
            return lp

        def reentry():
            lp = DataFrame.read_dataset(lroot, ctx4)
            return dict(join_groupbys(lp, rdf), lp=lp)

        launches.reset()
        t0 = time.perf_counter()
        lp = read_left()
        reads = [time.perf_counter() - t0]
        res = dict(join_groupbys(lp, rdf), lp=lp)
        counts_r, ex_r = launches.read()
        check(lp.partitioning == (("k",), 4),
              f"re-entry partitioning: {lp.partitioning}")
        check(ex_r == 2, f"re-entry exchanges: {ex_r} (right side 1, "
              f"groupby g 1; phase 4 makes 3)")
        check(counts_r["probe"] > 0 and counts_r["hash_partition"] > 0,
              f"re-entry launches: {counts_r}")
        check_main_path(res, left_dev, oracle, "re-entry, 4 shards")
        out["group_ref"] = {"files": files, "reentry": shard_prints(res, 0),
                            "exchanges": ex_r}
        del res
        reads += timed_runs(read_left, runs=2)
        runs = timed_runs(reentry)
        if profile:
            profile_run("reentry_4shards", reentry)

        rdf.to_hpt(rroot, partition_by=["k"])
        rp = DataFrame.read_dataset(rroot, ctx4)
        check(rp.partitioning == (("k",), 4), "right side re-enters")
        launches.reset()
        j0 = lp.join(rp, ["k"])
        counts_0, ex_0 = launches.read()
        check(ex_0 == 0, f"a join of two re-entered sides: {ex_0} exchanges")
        check_join(j0, left_dev, oracle, "join of re-entered sides")
        del j0, rp, rdf, lp
        lp1 = DataFrame.read_dataset(lroot, ctx1)
        check(lp1.partitioning is None and len(lp1) == LEFT_ROWS,
              "a 1-shard read of the 4-shard dataset carries no layout")
        del lp1
        write_s, read_s = statistics.median(writes), statistics.median(reads)
        out["group_ref"].update(write_s=write_s, read_s=read_s)
        out["reentry_4shards"] = dict(
            write_s=write_s, read_s=read_s, writes_s=writes, reads_s=reads,
            bytes_on_disk=nbytes, write_gb_s=nbytes / write_s / 1e9,
            read_gb_s=nbytes / read_s / 1e9, launches=counts_r,
            exchanges=ex_r, write_launches=counts_w,
            both_reentered_exchanges=ex_0, both_reentered_launches=counts_0,
            median_s=statistics.median(runs), runs_s=runs)

        # pushdown: the left frame sorted by k, in row groups of 2^20
        sdf = DataFrame.from_dict(left, ctx1).sort_values("k")
        t0 = time.perf_counter()
        sdf.to_hpt(sroot, rows_per_group=ROWS_PER_GROUP)
        swrite_s = time.perf_counter() - t0
        del sdf
        frags = open_dataset(sroot).fragments
        proven = sum(f.stats["k"][0] >= K_BELOW for f in frags)
        t0 = time.perf_counter()
        dt, ov, st = read_dataset(sroot, ctx=ctx1, columns=["k", "v"],
                                  predicate=pred("k", "<", K_BELOW))
        torch.cuda.synchronize()
        sread_s = time.perf_counter() - t0
        check(ov == 0, "pushdown scan overflow")
        check(st.row_groups_total == LEFT_ROWS // ROWS_PER_GROUP
              and st.row_groups_skipped == proven > 0,
              f"pushdown skipped {st.row_groups_skipped} of "
              f"{st.row_groups_total} fragments; the stats prove {proven}")
        check(st.columns_read == 2, f"columns read: {st.columns_read}")
        got = dt.valid_rows()
        check(sorted(got) == ["k", "v"], f"projected columns: {sorted(got)}")
        order = torch.argsort(left_dev["k"], stable=True)
        sk = left_dev["k"][order]
        sel = sk < K_BELOW
        check(torch.equal(got["k"], sk[sel])
              and torch.equal(bit_key(got["v"]),
                              bit_key(left_dev["v"][order][sel])),
              "pushdown rows equal the numpy filter of the sorted rows")
        out["pushdown_1shard"] = dict(
            write_s=swrite_s, read_s=sread_s,
            bytes_on_disk=dir_bytes(sroot), rows_selected=st.rows_selected,
            rows_scanned=st.rows_scanned,
            row_groups=[st.row_groups_skipped, st.row_groups_total],
            columns=[st.columns_read, st.columns_total])
        del dt, got
    return out


# ---------------------------------------------------------------------------
# phase 13: out-of-core spill; phase 14: the planned chain
# ---------------------------------------------------------------------------
BUDGET_ROWS = 1 << 21
#: phase 13's sizes: left 2^23 and right 2^21 rows by phase 3's recipe,
#: 2^23 events by phase 6's, under a quarter of ``BUDGET_ROWS``, so the
#: 4-shard join keeps the 10 partitions it has at phase 3's sizes
#: (``scripts/group_services.py`` runs them there, ``FULL_SPILL``)
SPILL_SIZES = {"left": 1 << 23, "right": 1 << 21, "events": 1 << 23,
               "budget": 1 << 19}
SPILL_G_AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")]
PLAN_G_AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("w", "max")]
PLAN_W_AGGS = [("v_sum", "sum"), ("v_count", "sum"), ("v_min", "min")]


class SpillSpy:
    """Records each spilled operator's ``SpillStats`` and whether its
    store held a ``.tmp`` file when the operator returned, and meters the
    run files' writes and reads (bytes and seconds inside ``write_hpt`` /
    ``read_hpt``, CRC included) — by wrapping the spill package's entry
    points and its store's file calls for the duration of a ``with``."""

    def __init__(self):
        self.results, self.io = [], {}

    def __enter__(self):
        from repro_torch import spill
        from repro_torch.spill import store

        self._saved = [(spill, n, getattr(spill, n)) for n in
                       ("spill_join", "spill_groupby", "spill_window")]
        self._saved += [(store, n, getattr(store, n))
                        for n in ("write_hpt", "read_hpt")]
        self.io = {"write_bytes": 0, "write_s": 0.0, "read_bytes": 0,
                   "read_s": 0.0}
        for mod, name, fn in self._saved[:3]:
            setattr(mod, name, self._op(fn))
        write_hpt, read_hpt = (fn for _, _, fn in self._saved[3:])

        def metered_write(path, cols, n):
            t0 = time.perf_counter()
            header = write_hpt(path, cols, n)
            self.io["write_s"] += time.perf_counter() - t0
            self.io["write_bytes"] += sum(b for _, b in
                                          header["offsets"].values())
            return header

        def metered_read(path):
            t0 = time.perf_counter()
            cols, n = read_hpt(path)
            self.io["read_s"] += time.perf_counter() - t0
            self.io["read_bytes"] += sum(v.nbytes for v in cols.values())
            return cols, n

        store.write_hpt, store.read_hpt = metered_write, metered_read
        return self

    def _op(self, fn):
        def spied(*args, **kw):
            res = fn(*args, **kw)
            self.results.append(
                {"stats": dataclasses.asdict(res.stats),
                 "tmp_files": res.store.leftover_temp_files(),
                 "root": res.store.root})
            return res
        return spied

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class PairTap:
    """Keeps a copy of the inputs of the first launch of each table kernel
    (and op) that a spilled operator makes — one pair's shapes — by
    wrapping the kernel modules' launchers for the duration of a
    ``with``; :meth:`compare` then holds each kernel against its plain
    version on those inputs (launches made after the leg's counts were
    read, so they do not count)."""

    def __init__(self):
        from repro_torch.kernels.hash_join import kernel as hjk
        from repro_torch.kernels.segment_reduce import kernel as srk
        from repro_torch.kernels.window_scan import kernel as wsk

        self._sites = [(hjk, "probe_cuda"), (srk, "segment_reduce_fused_cuda"),
                       (srk, "segment_reduce_cuda"),
                       (wsk, "windowed_scan_cuda")]
        self.inputs = {}

    def __enter__(self):
        self._saved = [(mod, name, getattr(mod, name))
                       for mod, name in self._sites]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._tap(name, fn))
        return self

    def _tap(self, name, fn):
        def tapped(*args):
            op = args[3] if name in ("segment_reduce_cuda",
                                     "windowed_scan_cuda") else None
            if (name, op) not in self.inputs:
                self.inputs[(name, op)] = tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args)
            return fn(*args)
        return tapped

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def compare(self, tag: str):
        from repro_torch.kernels.hash_join import kernel as hjk
        from repro_torch.kernels.hash_join import ref as hjr
        from repro_torch.kernels.segment_reduce import kernel as srk
        from repro_torch.kernels.segment_reduce import ref as srr
        from repro_torch.kernels.window_scan import kernel as wsk
        from repro_torch.kernels.window_scan import ref as wsr

        cases = []
        for (name, op), a in sorted(self.inputs.items(),
                                    key=lambda kv: kv[0][0] + str(kv[0][1])):
            what = f"{tag}: {name}" + (f" {op}" if op else "") + " at a pair"
            if name == "probe_cuda":
                kern = lambda: hjk.probe_cuda(*a)  # noqa: E731
                plain = lambda: hjr.probe_records(*a)  # noqa: E731
                shape = (f"N={a[2].shape[0]}, S={a[0].shape[0]}, "
                         f"L={a[4].shape[1]}, M={a[6]}")
                for x, y in zip(kern(), plain()):
                    check(torch.equal(x, y), f"{what}: bit-identical")
                err = 0.0
            elif name == "windowed_scan_cuda":
                v, seg, w, _ = a
                kern = lambda: wsk.windowed_scan_cuda(v, seg, w, op)  # noqa: E731
                plain = lambda: wsr.windowed_scan(  # noqa: E731
                    v.contiguous(), seg, w, op)
                shape = f"({v.shape[0]}, {v.shape[1]}) f32, w={w}"
                got, exp = kern(), plain()
                check(torch.equal(got.isnan(), exp.isnan()), f"{what}: NaN")
                ok = ~exp.isnan()
                err = 0.0
                if op != "sum" or w <= wsk.TILE:
                    check(torch.equal(got.view(torch.int32)[ok],
                                      exp.view(torch.int32)[ok]),
                          f"{what}: bit-exact")
                else:
                    scale = wsr.windowed_scan(v.abs().nan_to_num()
                                              .contiguous(), seg, w, "sum")
                    diff = (got - exp).abs()[ok]
                    check(bool((diff <= 1e-5 * scale[ok]).all()),
                          f"{what}: within 1e-5 sum|v|")
                    err = float(diff.max()) if diff.numel() else 0.0
            else:
                v, seg, S = a[:3]
                fused = name == "segment_reduce_fused_cuda"
                kern = ((lambda: srk.segment_reduce_fused_cuda(v, seg, S))
                        if fused else
                        (lambda: srk.segment_reduce_cuda(v, seg, S, op)))
                plain = ((lambda: srr.segment_reduce_fused(v, seg, S))
                         if fused else
                         (lambda: srr.segment_reduce(v, seg, S, op)))
                shape = f"N={v.shape[0]}, L={v.shape[1] if fused else 1}, S={S}"
                got, exp = kern(), plain()
                if op in ("min", "max"):
                    check(torch.equal(bit_key(got), bit_key(exp)),
                          f"{what}: bit for bit")
                    err = 0.0
                else:
                    scale = (srr.segment_reduce_fused(v.abs(), seg, S)
                             if fused else
                             srr.segment_reduce(v.abs(), seg, S, "sum"))
                    diff = (got - exp).abs()
                    check(bool((diff <= 1e-5 * scale).all()),
                          f"{what}: within 1e-5 sum|v|")
                    err = float(diff.max()) if diff.numel() else 0.0
            cases.append(dict(name=name[:-len("_cuda")], op=op, shape=shape,
                              max_abs_err=err, ms=cuda_ms(kern),
                              plain_ms=cuda_ms(plain, reps=2)))
        self.inputs.clear()
        return cases


KEEP_FILE = "kept.txt"  # a file the caller had in the spill workdir


def spill_leg(tag: str, run, launches, workdir: str, ctx=None,
              tap: bool = True):
    """One checked, timed run of a spilled operator: returns its result
    and the fields to print.  The workdir holds a file before the run;
    the store's run directory, made inside it, must hold no ``.tmp`` file
    when the operator returns and be gone once the frame is built, and
    the file must be the workdir's only entry, unchanged.  Then, with
    ``tap``, each kernel the leg ran is held against its plain version on
    one pair's inputs (``pair_kernels``).  On ``ctx``'s group every rank
    calls it (rank 0 makes the workdir), and the run-file figures are
    this rank's."""
    from repro_torch.core.array_ops import barrier

    rank, group = (0, None) if ctx is None else (ctx.rank, ctx.group)
    if rank == 0:
        os.makedirs(workdir)
        with open(os.path.join(workdir, KEEP_FILE), "w") as f:
            f.write(tag)
    barrier(group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    sorts0 = launches.sorts.n
    with SpillSpy() as spy, \
            (PairTap() if tap else contextlib.nullcontext()) as pairs:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts, ex = launches.read()
    sorts = launches.sorts.n - sorts0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(spy.results) == 1, f"{tag}: one spilled operator ran")
    rec = spy.results[0]
    check(os.path.dirname(rec["root"]) == workdir and rec["tmp_files"] == [],
          f"{tag}: run files in {rec['root']}, tmp {rec['tmp_files']}")
    check(not os.path.exists(rec["root"]), f"{tag}: the run dir is removed")
    with open(os.path.join(workdir, KEEP_FILE)) as f:
        check(os.listdir(workdir) == [KEEP_FILE] and f.read() == tag,
              f"{tag}: the workdir keeps what it held")
    check(out.overflow_report.is_exact(), f"{tag}: exact")
    io = spy.io
    return out, counts, ex, sorts, dict(
        seconds=seconds, stats=rec["stats"], launches=counts,
        exchanges=ex, sorts=sorts, peak_gib=peak,
        recovered=out.overflow_report.recovered,
        write_gb_s=io["write_bytes"] / max(io["write_s"], 1e-9) / 1e9,
        read_gb_s=io["read_bytes"] / max(io["read_s"], 1e-9) / 1e9, **io,
        pair_kernels=pairs.compare(tag) if tap else None)


def k_exact_oracle(left_dev, n_keys: int):
    """Counts, min and max of ``v`` per present ``k`` of ``n_keys``, on
    the card (exact: a count and an order statistic do not depend on the
    order of adds)."""
    k, v = left_dev["k"].long(), left_dev["v"]
    cnt = torch.bincount(k, minlength=n_keys)
    present = cnt > 0
    inf = torch.full((n_keys,), float("inf"), device=v.device)
    mn = inf.scatter_reduce(0, k, v, "amin")
    mx = (-inf).scatter_reduce(0, k, v, "amax")
    return {"v_count": cnt[present].cpu().numpy(),
            "v_min": mn[present].cpu().numpy(),
            "v_max": mx[present].cpu().numpy()}


def sort_rows_on_card(dt, keys):
    """Valid rows of ``dt`` stably sorted by ``keys`` (most significant
    first) on the card, then copied to the host."""
    rows = dt.valid_rows()
    order = torch.arange(rows[keys[0]].shape[0], device=rows[keys[0]].device)
    for k in reversed(keys):
        order = order[torch.argsort(rows[k][order], stable=True)]
    return {k: v[order].cpu().numpy() for k, v in rows.items()}


def host_hash_phase(left, dev):
    """The spill partitioner's host hash against the ``hash_partition``
    kernel over all left keys: ``h1`` bit for bit, ``h1 % 4`` equal to the
    kernel's destination."""
    from repro_torch.kernels.hash_partition import ops as hpops
    from repro_torch.spill.hashing import np_hash_columns

    t0 = time.perf_counter()
    h1, _ = np_hash_columns([left["k"]])
    host_s = time.perf_counter() - t0
    keys = torch.from_numpy(left["k"]).to(dev)
    valid = torch.ones(LEFT_ROWS, dtype=torch.bool, device=dev)
    dest, _, kh1, _ = hpops.hash_partition([keys], 4, valid,
                                           return_hashes=True)
    h1_dev = torch.from_numpy(h1.view(np.int32)).to(dev)
    check(torch.equal(kh1, h1_dev), "host h1 equals the kernel's h1")
    check(torch.equal(dest.long(),
                      torch.from_numpy((h1 % 4).astype(np.int64)).to(dev)),
          "host h1 % 4 equals the kernel's destination")
    return {"rows": LEFT_ROWS, "host_hash_s": host_s}


def spill_phase(DataFrame, ctx1, ctx4, left, seed: int, launches):
    """Join, groupby and window out of core at :data:`SPILL_SIZES` on 1
    and 4 virtual shards (phase 13): the join against the unspilled hash
    join of the same rows and the float64 oracle, the groupby against
    the oracles, the window against :func:`ordered_oracle`; the host
    hash over phase 3's left keys."""
    dev = torch.device("cuda")
    out = {"host_hash": host_hash_phase(left, dev)}
    budget = SPILL_SIZES["budget"]
    left, right, _ = make_data(seed, SPILL_SIZES["left"],
                               SPILL_SIZES["right"])
    events = make_events(seed, SPILL_SIZES["events"])
    left_dev = {k: torch.from_numpy(v).to(dev) for k, v in left.items()}
    oracle, ord_oracle = make_oracle(left, right), ordered_oracle(events)
    ko = oracle["k"]
    kx = k_exact_oracle(left_dev, SPILL_SIZES["right"])
    j1 = check_join(DataFrame.from_dict(left, ctx1).join(
        DataFrame.from_dict(right, ctx1), ["k"]), left_dev, oracle,
        "spill: the unspilled hash join")
    names = sorted(j1)
    with tempfile.TemporaryDirectory(prefix="hptmt_spill_") as tmp:
        for ctx, bf in ((ctx1, 1.0), (ctx4, 2.0)):
            ns = ctx.n_shards
            sfx = f"{ns}shard" + ("s" if ns > 1 else "")
            ldf = DataFrame.from_dict(left, ctx, bucket_factor=bf)
            rdf = DataFrame.from_dict(right, ctx, bucket_factor=bf)
            wd = os.path.join(tmp, f"join{ns}")
            js, counts, ex, _, fields = spill_leg(
                f"spill_join_{sfx}", lambda: ldf.join(
                    rdf, ["k"], spill=True, budget_rows=budget,
                    spill_workdir=wd), launches, wd)
            del ldf, rdf
            pairs = fields["stats"]["pairs"]
            check(ex == 0, f"spill join {sfx}: {ex} exchanges")
            check(counts["probe"] >= pairs * ns,
                  f"spill join {sfx}: probe on every shard of every pair "
                  f"({counts})")
            rows = js.table.valid_rows()
            check(torch.equal(canonical(rows, names), canonical(j1, names)),
                  f"spill join {sfx}: the rows of the unspilled hash join")
            del rows
            out[f"spill_join_{sfx}"] = fields

            wd = os.path.join(tmp, f"groupby{ns}")
            g, counts, ex, _, fields = spill_leg(
                f"spill_groupby_{sfx}", lambda: js.groupby(
                    ["k"], SPILL_G_AGGS, spill=True,
                    budget_rows=budget, spill_workdir=wd),
                launches, wd)
            del js
            check(ex == 0, f"spill groupby {sfx}: {ex} exchanges")
            pairs = fields["stats"]["pairs"]
            check(counts["segment_reduce_fused"] >= pairs * ns
                  and counts["segment_reduce"] >= 2 * pairs * ns,
                  f"spill groupby {sfx}: segment kernels (sums, min and "
                  f"max) on every shard of every pair ({counts})")
            got = sort_rows_on_card(g.table, ["k"])
            del g
            check(np.array_equal(got["k"], ko["k"]),
                  f"spill groupby {sfx}: keys")
            for key in ("v_count", "v_min", "v_max"):
                check(np.array_equal(got[key], kx[key]),
                      f"spill groupby {sfx}: {key}")
            check_close(got["v_sum"], ko["v_sum"], ko["v_abs"],
                        f"spill groupby {sfx}: v_sum")
            fields["groups"] = int(got["k"].shape[0])
            del got
            out[f"spill_groupby_{sfx}"] = fields

            edf = DataFrame.from_dict(events, ctx, bucket_factor=bf)
            wd = os.path.join(tmp, f"window{ns}")
            w, counts, ex, sorts, fields = spill_leg(
                f"spill_window_{sfx}", lambda: edf.window(["g"], ["t"]).agg(
                    W_AGGS, rows=ROLL, spill=True, budget_rows=budget,
                    spill_workdir=wd), launches, wd)
            del edf
            check(ex == 0 and sorts == 0,
                  f"spill window {sfx}: {ex} exchanges, {sorts} sorts")
            check(counts["windowed_scan"] >= fields["stats"]["pairs"] * ns,
                  f"spill window {sfx}: windowed_scan on every shard of "
                  f"every pair ({counts})")
            got = sort_rows_on_card(w.table, ["g", "t"])
            del w
            for k, want in ord_oracle["sorted"].items():
                check(np.array_equal(got[k], want),
                      f"spill window {sfx}: column {k}")
            for k, want in ord_oracle["roll"].items():
                check(np.array_equal(got[k], want),
                      f"spill window {sfx}: {k}")
            for k, (want, scale) in ord_oracle["close"].items():
                check_close(got[k], want, scale, f"spill window {sfx}: {k}")
            fields["sorts"] = sorts
            del got
            out[f"spill_window_{sfx}"] = fields
    return out


def planned_chain(DataFrame, LazyFrame, pred, ctx, root, rdf, lazy: bool):
    """scan → filter(v > 0) → join(right, k) → groupby(k) →
    window(k, v_sum, rows=32), planned or eager."""
    if lazy:
        out = planned_chain_lazy(LazyFrame, pred, ctx, root, rdf).collect()
    else:
        out = (DataFrame.read_dataset(root, ctx, bucket_factor=2.0)
               .select(pred("v", ">", 0.0).mask).join(rdf, ["k"])
               .groupby(["k"], PLAN_G_AGGS)
               .window(["k"], ["v_sum"]).agg(PLAN_W_AGGS, rows=ROLL))
    torch.cuda.synchronize()
    return out


def plan_phase(DataFrame, ctx1, ctx4, left, right, launches, profile: bool):
    """The lazy planner's chain against the same chain run eagerly, on 4
    virtual shards then 1 (phase 14)."""
    from repro_torch.io import pred, read_dataset
    from repro_torch.plan import LazyFrame

    out = {}
    with tempfile.TemporaryDirectory(prefix="hptmt_plan_") as tmp:
        root = os.path.join(tmp, "left")
        DataFrame.from_dict(left, ctx4).to_hpt(root)
        for ctx, bf in ((ctx4, 2.0), (ctx1, 1.0)):
            ns = ctx.n_shards
            tag = f"planned_{ns}shard" + ("s" if ns > 1 else "")
            rdf = DataFrame.from_dict(right, ctx, bucket_factor=bf)
            lf = planned_chain_lazy(LazyFrame, pred, ctx, root, rdf)
            text = lf.explain()
            check(text == lf.explain(), f"{tag}: explain() is deterministic")
            predicted = lf.physical_plan().predicted_collectives

            def run(lazy):
                return planned_chain(DataFrame, LazyFrame, pred, ctx, root,
                                     rdf, lazy)

            launches.reset()
            planned = run(True)
            counts, ex_p = launches.read()
            launches.reset()
            eager = run(False)
            _, ex_e = launches.read()
            check(ex_p == predicted, f"{tag}: {ex_p} exchanges, predicted "
                  f"{predicted}")
            check(ex_p < ex_e if ns > 1 else ex_p == ex_e == 0,
                  f"{tag}: planned {ex_p} against eager {ex_e} exchanges")
            check(planned.overflow_report.is_exact()
                  and eager.overflow_report.is_exact(), f"{tag}: exact")
            need = ["probe", "segment_reduce_fused", "segment_reduce",
                    "windowed_scan"] + (["hash_partition"] if ns > 1 else [])
            check(all(counts[k] > 0 for k in need),
                  f"{tag}: kernels launched {counts}")
            p = sort_rows_on_card(planned.table, ["k"])
            e = sort_rows_on_card(eager.table, ["k"])
            check(sorted(p) == sorted(e), f"{tag}: columns {sorted(p)}")
            for k in p:
                if k in ("v_sum", "v_sum_sum"):  # v > 0: |sum| = sum|v|
                    check_close(p[k], e[k].astype(np.float64),
                                np.abs(e[k]).astype(np.float64),
                                f"{tag}: {k}")
                else:
                    check(np.array_equal(bits_np(p[k]), bits_np(e[k])),
                          f"{tag}: {k} equals the eager chain's")
            rows = int(p["k"].shape[0])
            del planned, eager, p, e
            runs_p = timed_runs(lambda: run(True), 2)
            runs_e = timed_runs(lambda: run(False), 2)
            # the planned scan evaluates the pushed-down filter on the
            # host while reading; the eager chain filters on the card
            def scan(pr):
                read_dataset(root, ctx=ctx, bucket_factor=2.0, predicate=pr)
                torch.cuda.synchronize()

            scans = {f"scan_{name}_s": statistics.median(
                timed_runs(lambda: scan(pr), 2))
                for name, pr in (("all", None),
                                 ("filtered", pred("v", ">", 0.0)))}
            if profile and ns > 1:
                profile_run(tag, lambda: run(True))
            out[tag] = dict(
                exchanges=ex_p, predicted=predicted, eager_exchanges=ex_e,
                launches=counts, rows=rows,
                steps=[f"{s.op}:{s.strategy}:{s.a2a}"
                       for s in lf.physical_plan().steps],
                planned_median_s=statistics.median(runs_p),
                eager_median_s=statistics.median(runs_e),
                planned_runs_s=runs_p, eager_runs_s=runs_e, **scans)
            del rdf, lf
    return out


TSET_CHUNKS = 8
TSET_AGGS = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
             ("v", "count")]
#: phase 15's exchanges on 4 shards: the combiner groupby one a chunk
#: and none at the merge, the join 2 + its groupby's one chunk 1, the
#: window's range exchange 1, top-k and reduce none
TSET_EXCHANGES = {"groupby_k": TSET_CHUNKS, "groupby_g": TSET_CHUNKS,
                  "join_groupby": 3, "reduce": 0, "window": 1, "topk": 0}


#: phase 15's pipelines that phase 29's groups run again
GROUP_TSET = ("groupby_k", "join_groupby")


def positive_groupby_close(got, want, tag):
    """Two groupbys of ``v > 0`` rows sorted by key: keys, counts, min and
    max bit for bit, sums and means within ``1e-5`` of the other's (every
    summand is positive, so ``|sum| = sum|v|``)."""
    check(sorted(got) == sorted(want), f"{tag}: columns {sorted(got)}")
    for k in got:
        if k in ("v_sum", "v_mean"):
            check_close(got[k], want[k].astype(np.float64),
                        np.abs(want[k]).astype(np.float64), f"{tag}: {k}")
        else:
            check(np.array_equal(bits_np(got[k]), bits_np(want[k])),
                  f"{tag}: {k} bit for bit")


def tset_pipelines(TSet, ctx, lt, rt, et):
    """Phase 15's four pipelines over chunked phase 3-7 frames (8 chunks a
    table): name -> thunk returning ``(tset, result)``."""
    def chunks(dt):
        return TSet.from_table(dt, ctx, chunk_rows=dt.capacity // TSET_CHUNKS)

    def positive():
        return chunks(lt).select(lambda c: c["v"] > 0)

    def run(ts, sink=None):
        out = ts.collect() if sink is None else getattr(ts, sink[0])(*sink[1])
        torch.cuda.synchronize()
        return ts, out

    return {
        "groupby_k": lambda: run(positive().groupby(["k"], TSET_AGGS)),
        "groupby_g": lambda: run(positive().groupby(["g"], TSET_AGGS)),
        "join_groupby": lambda: run(chunks(lt).join(chunks(rt), ["k"])
                                    .groupby(["g"], G_AGGS)),
        "reduce": lambda: run(chunks(lt), ("reduce", ("v", "sum"))),
        "window": lambda: run(chunks(et).window(["g"], ["t"],
                                                [("v", "sum")], rows=ROLL)),
        "topk": lambda: run(chunks(et).topk("v", TOPK)),
    }


def tset_phase(DataFrame, ctx1, ctx4, left, right, events, oracle,
               ord_oracle, launches, profile: bool):
    """Phase 15: the TSet dataflow over the main and ordered cells'
    frames, on 1 and 4 virtual shards, against the eager chains of the
    same operators in the same run and phases 3-7's oracles."""
    from repro_torch.core.dataflow import TSet

    out = {}
    v_total = float(left["v"].astype(np.float64).sum())
    v_abs = float(np.abs(left["v"]).astype(np.float64).sum())
    for ctx, bf in ((ctx1, 1.0), (ctx4, 2.0)):
        ns = ctx.n_shards
        tag = f"tset_{ns}shard" + ("s" if ns > 1 else "")
        ldf = DataFrame.from_dict(left, ctx, bucket_factor=bf)
        rdf = DataFrame.from_dict(right, ctx, bucket_factor=bf)
        edf = DataFrame.from_dict(events, ctx, bucket_factor=bf)
        pipes = tset_pipelines(TSet, ctx, ldf.table, rdf.table, edf.table)
        res, counts, secs, exchanges = {}, {}, {}, {}
        for name, thunk in pipes.items():
            torch.cuda.synchronize()
            launches.reset()
            # the first groupby keeps its first chunk's kernel inputs
            with (PairTap() if name == "groupby_k"
                  else contextlib.nullcontext()) as tap:
                t0 = time.perf_counter()
                ts, got = thunk()
                secs[name] = time.perf_counter() - t0
            counts[name], exchanges[name] = launches.read()
            check(ts.overflow_report.is_exact(), f"{tag}: {name} exact")
            want_ex = TSET_EXCHANGES[name] if ns > 1 else 0
            check(exchanges[name] == want_ex, f"{tag}: {name} made "
                  f"{exchanges[name]} exchanges, expected {want_ex}")
            res[name] = got
            if tap is not None:
                chunk_kernels = tap.compare(f"{tag} chunk")
            if profile and ns > 1 and name in ("groupby_k", "join_groupby"):
                profile_run(f"{tag}_{name}", thunk)
        # the same operators run eagerly, same frames, same run
        pos = ldf.select(lambda c: c["v"] > 0)
        t0 = time.perf_counter()
        eager = {"groupby_k": pos.groupby(["k"], TSET_AGGS),
                 "groupby_g": pos.groupby(["g"], TSET_AGGS),
                 "join_groupby": ldf.join(rdf, ["k"]).groupby(
                     ["g"], G_AGGS, out_capacity=G_OUT_CAP),
                 "window": edf.window(["g"], ["t"]).agg([("v", "sum")],
                                                        rows=ROLL),
                 "topk": edf.topk("v", TOPK)}
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        for name in ("groupby_k", "groupby_g"):
            key = name[-1]
            positive_groupby_close(sort_rows_on_card(res[name], [key]),
                                   sort_rows_on_card(eager[name].table,
                                                     [key]),
                                   f"{tag}: {name} vs eager")
        jg = sort_rows_on_card(res["join_groupby"], ["g"])
        ejg = sort_rows_on_card(eager["join_groupby"].table, ["g"])
        check(all(np.array_equal(bits_np(jg[k]), bits_np(ejg[k]))
                  for k in jg if not k.endswith(("_sum", "_mean"))),
              f"{tag}: join_groupby exact lanes equal the eager chain's")
        check_groupby_g(jg, oracle, f"{tag}: join_groupby (phase 3 oracle)")
        red = float(res["reduce"])
        check(abs(red - v_total) <= 1e-5 * v_abs,
              f"{tag}: reduce sum {red} vs {v_total}")
        w = res["window"].to_numpy()
        ew = eager["window"].to_numpy()
        srt = ord_oracle["sorted"]
        for k in ("g", "t", "v"):
            check(np.array_equal(w[k], srt[k]) and np.array_equal(ew[k], w[k]),
                  f"{tag}: window {k} in phase 6's order")
        want, scale = ord_oracle["close"]["v_sum"]
        check_close(w["v_sum"], want, scale, f"{tag}: window v_sum (phase 6)")
        check_close(w["v_sum"], ew["v_sum"].astype(np.float64), scale,
                    f"{tag}: window v_sum vs eager")
        top = res["topk"].to_numpy()["v"]
        check(np.array_equal(top, ord_oracle["top"])
              and np.array_equal(top, eager["topk"].to_numpy()["v"]),
              f"{tag}: topk equals phase 6's and the eager chain's")
        need = {"groupby_k": ["segment_reduce_fused", "segment_reduce"],
                "join_groupby": ["probe", "segment_reduce_fused"],
                "window": ["windowed_scan"]}
        for name, kernels in need.items():
            kernels = kernels + (["hash_partition"] if ns > 1 and
                                 name != "window" else [])
            check(all(counts[name][k] > 0 for k in kernels),
                  f"{tag}: {name} launched {counts[name]}")
        if ns > 1:  # phase 29's groups run two of the pipelines
            out["group_ref"] = {
                "prints": {name: shard_prints({"t": res[name]}, 0,
                                              valid_only=True)
                           for name in GROUP_TSET},
                "exchanges": {name: exchanges[name] for name in GROUP_TSET},
                "seconds": {name: secs[name] for name in GROUP_TSET}}
        out[tag] = dict(seconds=secs, eager_s=eager_s, exchanges=exchanges,
                        launches=counts, chunks=TSET_CHUNKS,
                        groups_k=int(res["groupby_k"].counts.sum()),
                        chunk_kernels=chunk_kernels)
        del ldf, rdf, edf, pipes, res, eager, pos, w, ew
        torch.cuda.empty_cache()
    return out


def planned_chain_lazy(LazyFrame, pred, ctx, root, rdf):
    """Phase 14's chain as a LazyFrame (not collected)."""
    return (LazyFrame.read_parquet(root, ctx, bucket_factor=2.0)
            .filter([pred("v", ">", 0.0)]).join(rdf.lazy(), ["k"])
            .groupby(["k"], PLAN_G_AGGS)
            .window(["k"], ["v_sum"]).agg(PLAN_W_AGGS, rows=ROLL))


class ProbeTimer:
    """CUDA events around every probe launch made inside the ``with``."""

    def __enter__(self):
        from repro_torch.kernels.hash_join import kernel as hjk

        self._mod, self._real, self.events = hjk, hjk.probe_cuda, []

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._real(*args)
            end.record()
            self.events.append((start, end))
            return out

        hjk.probe_cuda = timed
        return self

    def __exit__(self, *exc):
        self._mod.probe_cuda = self._real

    def ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def telemetry_phase(DataFrame, ctx1, ctx4, left, right, oracle, root,
                    launches, profile: bool):
    """Phase 16: phases 3-4's main path under ``telemetry.trace()`` and
    phase 14's 4-shard planned chain collected with telemetry and a
    ledger."""
    from repro_torch import telemetry
    from repro_torch.io import pred
    from repro_torch.plan import LazyFrame

    out = {}
    rows_k = int(oracle["k"]["k"].shape[0])
    want = [("table.join", LEFT_ROWS, LEFT_ROWS),
            ("table.groupby", LEFT_ROWS, GROUPS),
            ("table.groupby", LEFT_ROWS, rows_k)]
    with tempfile.TemporaryDirectory(prefix="hptmt_tele_") as tmp:
        for ctx, bf in ((ctx1, 1.0), (ctx4, 2.0)):
            ns = ctx.n_shards
            tag = f"telemetry_{ns}shard" + ("s" if ns > 1 else "")
            with telemetry.trace(tag) as rec, ProbeTimer() as probe:
                main_path(DataFrame, ctx, left, right, bf)
            probe_ms = probe.ms()
            roots = [(s.name, s.attrs.get("rows_in"), s.attrs.get("rows_out"))
                     for s in rec.spans if s.name.startswith("table.")]
            check(roots == want, f"{tag}: operator spans {roots}")
            join = next(s for s in rec.spans if s.name == "table.join")
            join_ms = join.dur_us / 1e3
            if ns == 1:
                check(len(probe.events) == 1 and join_ms >= probe_ms,
                      f"{tag}: the join span ({join_ms} ms) waits for its "
                      f"probe kernel ({probe_ms} ms)")
            paths = (os.path.join(tmp, f"{tag}.trace.json"),
                     os.path.join(tmp, f"{tag}.metrics.json"))
            telemetry.export_chrome_trace(rec, paths[0])
            telemetry.export_metrics(rec, paths[1])
            with open(paths[0]) as f:
                events = json.load(f)["traceEvents"]
            with open(paths[1]) as f:
                snap = json.load(f)
            check(sum(e["ph"] == "X" for e in events) == snap["n_spans"]
                  >= len(want), f"{tag}: exported trace and metrics parse")
            on, off = [], []
            for _ in range(3):  # interleaved: off, on, off, on, ...
                off += timed_runs(lambda: main_path(DataFrame, ctx, left,
                                                    right, bf), runs=1)

                def traced():
                    with telemetry.trace("timed"):
                        main_path(DataFrame, ctx, left, right, bf)
                on += timed_runs(traced, runs=1)
            if profile and ns > 1:
                profile_run(tag, traced)
            out[tag] = dict(
                spans=roots, join_span_ms=join_ms, probe_kernel_ms=probe_ms,
                n_spans=snap["n_spans"],
                on_median_s=statistics.median(on),
                off_median_s=statistics.median(off), on_runs_s=on,
                off_runs_s=off, overhead=statistics.median(on)
                / statistics.median(off) - 1.0)

        # phase 14's 4-shard chain with telemetry, a ledger, and analyze
        rdf = DataFrame.from_dict(right, ctx4, bucket_factor=2.0)
        lf = planned_chain_lazy(LazyFrame, pred, ctx4, root, rdf)
        plan = lf.physical_plan()
        ledger = os.path.join(tmp, "runs.jsonl")
        rec = telemetry.Collector("planned")
        launches.reset()
        t0 = time.perf_counter()
        lf.collect(telemetry=rec, ledger=ledger)
        collect_s = time.perf_counter() - t0
        counts, ex = launches.read()
        audit = rec.audits[-1]
        check(audit["consistent"] and audit["predicted_a2a"]
              == audit["observed_a2a"] == ex == 2,
              f"planned chain audit {audit['predicted_a2a']} predicted, "
              f"{audit['observed_a2a']} counted, counter {ex}")
        qerr = {i: f.get("qerr") for i, f in rec.plan_steps.items()}
        check(all(q is not None for q in qerr.values())
              and "cardinality.max_qerror" in rec.metrics.gauges,
              f"planned chain q-errors {qerr}")
        lines = telemetry.ledger_read(ledger)
        check(len(lines) == 1 and lines[0]["audit_consistent"] is True
              and lines[0]["observed_a2a"] == 2, f"ledger {lines}")
        text = lf.explain(analyze=True)
        phys = text.split("== physical plan ==")[1].splitlines()
        for s in plan.steps:
            line = next(ln for ln in phys
                        if ln.strip().startswith(f"{s.index}. "))
            check("time=" in line and "rows=" in line,
                  f"explain(analyze=True) annotates step {s.index}: {line}")
        check("audit: predicted=2 counted=2" in text, "explain audit line")
        out["telemetry_planned_4shards"] = dict(
            collect_s=collect_s, exchanges=ex, launches=counts,
            qerrors=qerr, max_qerror=rec.metrics.gauges[
                "cardinality.max_qerror"],
            exchange_bytes=audit["observed_bytes"],
            steps={i: {k: f[k] for k in ("op", "time_us", "rows_out",
                                         "est_rows", "qerr")}
                   for i, f in sorted(rec.plan_steps.items())})
    return out


def resume_chain(LazyFrame, pred, ctx, root, rdf):
    """Phase 17's chain: phase 14's, then a sort by ``v_sum`` — a second
    exchange stage after the join's, so a kill at the second commit
    leaves one stage committed."""
    return planned_chain_lazy(LazyFrame, pred, ctx, root, rdf) \
        .sort_values("v_sum")


CRASH_FAULT = "checkpoint.commit:crash:2"


def crash_child(seed: int, root: str, ckdir: str) -> int:
    """The child of phase 17: the resume chain on 4 shards under stage
    checkpoints, armed (``HPTMT_FAULTS``) to die by SIGKILL at the second
    commit.  Returning at all is a failure."""
    from repro_torch.core import HPTMTContext
    from repro_torch.dataframe import DataFrame
    from repro_torch.io import pred
    from repro_torch.plan import LazyFrame
    from repro_torch.resilience import FaultPolicy

    check(os.environ.get("HPTMT_FAULTS") == CRASH_FAULT, "child is armed")
    ctx4 = HPTMTContext(n_shards=4, device="cuda")
    _, right, _ = make_data(seed)
    rdf = DataFrame.from_dict(right, ctx4, bucket_factor=2.0)
    resume_chain(LazyFrame, pred, ctx4, root, rdf).collect(
        policy=FaultPolicy(checkpoint_dir=ckdir, keep_checkpoints=True))
    print("chip_smoke: the crash child was not killed", file=sys.stderr)
    return 1


def recovery_phase(DataFrame, ctx4, left, right, oracle, root, seed, dev,
                   launches):
    """Phase 17: kill-and-resume of a planned chain, a model checkpoint of
    smollm-360m's bf16 parameters, and a journaled workflow."""
    import collections

    from repro_torch import telemetry
    from repro_torch.checkpoint import (CheckpointIntegrityError,
                                        CheckpointManager)
    from repro_torch.configs import get_config
    from repro_torch.io import pred
    from repro_torch.models.transformer import LM
    from repro_torch.plan import LazyFrame, optimize
    from repro_torch.resilience import (FaultPolicy, StageCheckpointer, arm,
                                        fires, plan_fingerprint, reset)
    from repro_torch.workflow import Task, WorkflowEngine

    out = {}
    rdf = DataFrame.from_dict(right, ctx4, bucket_factor=2.0)
    with tempfile.TemporaryDirectory(prefix="hptmt_rec_") as tmp:
        # --- crash and resume -------------------------------------------
        ckdir = os.path.join(tmp, "stages")
        lf = resume_chain(LazyFrame, pred, ctx4, root, rdf)
        plan = lf.physical_plan()
        stages = [s.index for s in plan.steps if s.stage]
        check(len(stages) == 2, f"resume chain stages {stages}")
        captured = {}

        def capture(step, layout, thunk):
            captured[step.index] = thunk()
            return captured[step.index]

        plan.stage_hook = capture  # the uncrashed run, its stages kept
        t0 = time.perf_counter()
        full, _ = plan.fn(*plan.inputs())
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        env = dict(os.environ, HPTMT_FAULTS=CRASH_FAULT)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
             "--crash-child", root, ckdir], env=env, capture_output=True,
            text=True, timeout=600)
        child_s = time.perf_counter() - t0
        check(child.returncode == -9, f"the child died by SIGKILL "
              f"(rc {child.returncode}): {child.stderr[-2000:]}")
        fp = plan_fingerprint(optimize(lf.logical_plan)[0], ctx4)
        names = sorted(os.listdir(os.path.join(ckdir, fp)))
        check(names == [f"stage_{stages[0]}", f"stage_{stages[1]}.tmp"],
              f"after the kill: {names}")
        pol = FaultPolicy(checkpoint_dir=ckdir, keep_checkpoints=True)
        rec = telemetry.Collector("resume")
        launches.reset()
        t0 = time.perf_counter()
        resumed = lf.collect(policy=pol, telemetry=rec)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        counts, ex = launches.read()
        restored = rec.metrics.counters.get("recovery.stages_restored", 0)
        check(restored >= 1, f"resume restored {restored} stages")
        suffix = plan.predicted_collectives - sum(
            s.a2a for s in plan.steps if s.index <= stages[0])
        check(ex == suffix == 1, f"resume counted {ex} exchanges, the "
              f"suffix predicts {suffix}")
        t0 = time.perf_counter()
        stage_dt, _ = StageCheckpointer(ckdir, fp).restore(stages[0], ctx4)
        torch.cuda.synchronize()
        stage_restore_s = time.perf_counter() - t0
        join_rows = captured[stages[0]][0].valid_rows()
        check(torch.equal(canonical(stage_dt.valid_rows(), sorted(join_rows)),
                          canonical(join_rows, sorted(join_rows))),
              "the committed join stage equals the uncrashed run's, bit "
              "for bit")
        got = sort_rows_on_card(resumed.table, ["k"])
        want = sort_rows_on_card(full, ["k"])
        check(sorted(got) == sorted(want), f"resumed columns {sorted(got)}")
        # float sums come from the card's float atomics, whose order of
        # adds varies from run to run: exact lanes bit for bit, sums close
        sums_bitwise = True
        for k in got:
            same = np.array_equal(bits_np(got[k]), bits_np(want[k]))
            if k in ("v_sum", "v_sum_sum"):
                check_close(got[k], want[k].astype(np.float64),
                            np.abs(want[k]).astype(np.float64),
                            f"resumed {k}")
                sums_bitwise &= same
            else:
                check(same, f"resumed {k} bit for bit")
        launches.reset()
        t0 = time.perf_counter()
        again = lf.collect(policy=pol)
        torch.cuda.synchronize()
        rerun_s = time.perf_counter() - t0
        _, ex2 = launches.read()
        check(ex2 == 0, f"a fully committed rerun made {ex2} exchanges")
        a, b = again.to_numpy(), resumed.to_numpy()
        check(all(np.array_equal(bits_np(a[k]), bits_np(b[k])) for k in b),
              "the fully committed rerun is bit-exact")
        tmp_left = [n for _, dirs, files in os.walk(ckdir)
                    for n in dirs + files if n.endswith(".tmp")]
        check(tmp_left == [], f"no .tmp left: {tmp_left}")
        out["recovery_resume_4shards"] = dict(
            full_s=full_s, child_s=child_s, resume_s=resume_s,
            rerun_s=rerun_s, stage_restore_s=stage_restore_s,
            stage_bytes={i: dir_bytes(os.path.join(ckdir, fp, f"stage_{i}"))
                         for i in stages},
            stages=stages, restored=restored,
            resume_exchanges=ex, rerun_exchanges=ex2, launches=counts,
            rows=int(resumed.table.counts.sum()),
            sums_bitwise_vs_uncrashed=sums_bitwise)
        del full, resumed, again, captured, stage_dt, join_rows

        # --- model checkpoint: smollm-360m's bf16 parameters ------------
        cfg = get_config("smollm-360m")
        model = LM(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        sd = model.state_dict()
        nbytes = sum(t.numel() * t.element_size() for t in sd.values())
        check(all(t.dtype == torch.bfloat16 for t in sd.values()
                  if t.is_floating_point()), "smollm parameters are bf16")
        mgr = CheckpointManager(os.path.join(tmp, "ckpt"), async_save=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(1, sd)
        handed_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = mgr.restore(sd, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(all(back[k].device == v.device and back[k].dtype == v.dtype
                  and torch.equal(bit_view(back[k]), bit_view(v))
                  for k, v in sd.items()), "bf16 restore is bit-exact")
        step_dir = os.path.join(tmp, "ckpt", "step_1")
        leaf = os.path.join(step_dir, next(
            n for n in sorted(os.listdir(step_dir)) if n.endswith(".npy")))
        with open(leaf, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
        try:
            mgr.restore(sd, device="cuda")
            flipped = "restored"
        except CheckpointIntegrityError as e:
            flipped = str(e)
        check("CRC mismatch" in flipped, f"a flipped byte: {flipped}")
        out["recovery_checkpoint"] = dict(
            arch="smollm-360m", leaves=len(sd), bytes=nbytes,
            save_handed_s=handed_s, save_s=save_s, restore_s=restore_s,
            save_gb_s=nbytes / save_s / 1e9,
            restore_gb_s=nbytes / restore_s / 1e9)
        del model, sd, back
        torch.cuda.empty_cache()

        # --- a journaled workflow with one transient fault --------------
        calls = collections.Counter()

        def scan():
            calls["scan"] += 1
            return DataFrame.read_dataset(root, ctx4, bucket_factor=2.0)

        def join_groupby(scan):
            calls["join_groupby"] += 1
            return scan.join(rdf, ["k"]).groupby(["g"], G_AGGS,
                                                 out_capacity=G_OUT_CAP)

        def verify(join_groupby):
            calls["check"] += 1
            check_groupby_g(join_groupby.to_numpy(), oracle, "workflow")
            return True

        def engine(journal):
            pol = FaultPolicy(max_retries=2, backoff_base=0.01)
            return (WorkflowEngine(journal, policy=pol)
                    .add(Task("scan", scan))
                    .add(Task("join_groupby", join_groupby, deps=("scan",)))
                    .add(Task("check", verify, deps=("join_groupby",))))

        journal = os.path.join(tmp, "journal.json")
        reset()
        arm("scan.read", "io_error")  # the first fragment read fails once
        with telemetry.trace("workflow") as rec:
            t0 = time.perf_counter()
            results = engine(journal).run()
            torch.cuda.synchronize()
            wf_s = time.perf_counter() - t0
        check(results["check"] is True and fires("scan.read") == 1,
              "workflow ran through one injected fault")
        check(dict(calls) == {"scan": 2, "join_groupby": 1, "check": 1}
              and rec.metrics.counters.get("retry.workflow.scan") == 1,
              f"workflow retried the scan once through the policy: {calls}")
        with telemetry.trace("workflow-resume") as rec2:
            engine(journal).run()
        check(dict(calls) == {"scan": 2, "join_groupby": 1, "check": 1}
              and rec2.metrics.counters.get("workflow.replayed") == 3,
              f"a second engine resumed from the journal: {calls}")
        reset()
        out["recovery_workflow"] = dict(
            seconds=wf_s, calls=dict(calls),
            spans=[(s.name, s.attrs.get("attempts"))
                   for s in rec.all_spans() if s.name.startswith("workflow")])
    return out


def bit_view(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as an integer tensor of its width."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def bits_np(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


def sass_hgmma(lib) -> dict:
    """Count of ``HGMMA`` (wgmma) instructions in the SASS of each kernel
    of the built library that has any."""
    from repro_torch.kernels import native

    r = subprocess.run([native.cuda_tool("cuobjdump"), "-sass", str(lib)],
                       capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"cuobjdump reads the kernels: {r.stderr}")
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "HGMMA" in line and fn is not None:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


TRAIN_ARCH = "smollm-360m"
TRAIN = {"batch": 8, "seq": 1024, "remat_batch": 2}
WORKFLOW = {"n_docs": 1 << 13, "mean_doc_len": 512, "steps": 8,
            "resume_to": 10, "prompts": 8, "prompt": 64, "gen": 16}
#: phase 25: the bf16 step against a float32-compute step from the same
#: masters and batch (``grad_agreement``; the loss relative; the step's
#: grad norm against its own gradients' norm), about 3x the readings at
#: seed 0 on an H100 (4.41e-2, 5.22e-2, 3.41e-4, 8.43e-7, 0)
BF16_VS_F32 = {"leaf_rel_l2": 0.13, "leaf_of_max": 0.16, "norm_rel": 1e-3,
               "loss_rel": 3e-6, "step_vs_grads_norm_rel": 1e-6}


def train_batch(cfg, seed: int, b: int, s: int, dev):
    """Random next-token batch: ``(b, s)`` tokens and their successors."""
    rng = np.random.default_rng(seed + 5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1),
                                         dtype=np.int32)).to(dev)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def grad_agreement(got, ref) -> dict:
    """How far gradients ``got`` are from ``ref`` (dicts of leaves):
    the worst leaf's ``|got - ref|`` over ``|ref|`` (2-norms,
    ``leaf_rel_l2``) and its largest element error over the leaf's
    largest magnitude (``leaf_of_max``), and the global norms' gap."""
    from repro_torch.train.optimizer import global_norm

    l2, of_max = {}, {}
    for k, r in ref.items():
        d = (got[k] - r).float()
        l2[k] = float(d.norm() / r.norm().clamp_min(1e-30))
        of_max[k] = float(d.abs().max() / r.abs().max().clamp_min(1e-30))
    n_got = float(global_norm(got.values()))
    n_ref = float(global_norm(ref.values()))
    worst = max(l2, key=l2.get)
    return {"leaf_rel_l2": l2[worst], "leaf_rel_l2_at": worst,
            "leaf_of_max": max(of_max.values()),
            "leaf_of_max_at": max(of_max, key=of_max.get),
            "norm_rel": abs(n_got - n_ref) / n_ref}


def train_phase(dev, seed: int, launches, profile: bool) -> dict:
    """Phase 25: train steps of smollm-360m at full width on the card."""
    from repro_torch.configs import get_config
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptimizerConfig, global_norm

    cfg = get_config(TRAIN_ARCH)
    check(cfg.remat and cfg.param_dtype == "float32"
          and cfg.dtype == "bfloat16", f"{TRAIN_ARCH}: remat, float32 "
          f"masters, bf16 compute")
    tcfg = TS.TrainConfig(optimizer=OptimizerConfig(warmup_steps=2,
                                                    total_steps=100))
    b, s = TRAIN["batch"], TRAIN["seq"]
    state = TS.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    check(all(p.dtype == torch.float32 and p.requires_grad
              for p in state.params.values()), "float32 trainable masters")
    batch = train_batch(cfg, seed, b, s, dev)

    # the step's gradients (bf16 compute) against a float32-compute
    # step's, from the same masters and batch: the bf16 casts under
    # autograd, leaf by leaf
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g32, m32 = TS.compute_grads(TS.bind(TS.skeleton(cfg32), state.params),
                                cfg32, tcfg, batch, state.params)
    g16, m16 = TS.compute_grads(TS.bind(TS.skeleton(cfg), state.params),
                                cfg, tcfg, batch, state.params)
    vs32 = grad_agreement(g16, g32)
    norm16 = float(global_norm(g16.values()))
    del g16, g32
    loss32 = float(m32["loss"])

    step = TS.make_train_step(cfg, tcfg)
    launches.reset()
    state, m = step(state, batch)                     # warm-up, checked
    torch.cuda.synchronize()
    counts, _ = launches.read()
    check(sum(counts.values()) == 0, f"the train step launches no kernel "
          f"(attention is the plain attend): {counts}")
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    check(np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0,
          f"finite loss {loss} and grad norm {gnorm}")
    vs32.update(loss_rel=abs(loss - loss32) / abs(loss32),
                step_vs_grads_norm_rel=abs(gnorm - norm16) / norm16)
    print(f"  bf16 step vs float32 compute: {vs32}", flush=True)
    for key, limit in BF16_VS_F32.items():
        check(vs32[key] <= limit, f"bf16 step vs float32 compute: {key} "
              f"{vs32[key]} within {limit}")

    def one(fn, st, bt):
        """A no-argument call of one synchronized step that carries the
        state it returns to the next call."""
        def run():
            nonlocal st
            st, mm = fn(st, bt)
            torch.cuda.synchronize()
            return mm
        return run

    torch.cuda.reset_peak_memory_stats()
    runs = timed_runs(one(step, state, batch))
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = statistics.median(runs)
    step4 = TS.make_train_step(cfg, dataclasses.replace(tcfg,
                                                        micro_batches=4))
    one(step4, state, batch)()                        # warm-up
    torch.cuda.reset_peak_memory_stats()
    runs4 = timed_runs(one(step4, state, batch), 1)
    peak4 = torch.cuda.max_memory_allocated() / 2**30

    # remat on and off at batch 2 (off at batch 8 would keep every
    # layer's activations)
    small = train_batch(cfg, seed + 1, TRAIN["remat_batch"], s, dev)
    remat_peak = {}
    for on in (True, False):
        c = dataclasses.replace(cfg, remat=on)
        st_fn = TS.make_train_step(c, tcfg)
        one(st_fn, state, small)()                    # warm-up
        torch.cuda.reset_peak_memory_stats()
        one(st_fn, state, small)()
        remat_peak["on" if on else "off"] = \
            torch.cuda.max_memory_allocated() / 2**30
    check(remat_peak["on"] < remat_peak["off"],
          f"remat lowers the peak: {remat_peak}")

    # the flash kernel is forward only: training with it raises
    flash_cfg = dataclasses.replace(cfg, use_flash=True)
    launches.reset()
    try:
        TS.make_train_step(flash_cfg, tcfg)(state, small)
    except RuntimeError as e:
        check("forward only" in str(e), f"flash under grad: {e}")
    else:
        check(False, "use_flash=True in train mode must raise")
    check(launches.read()[0]["flash_attention"] == 0,
          "the refused flash call launched nothing")
    if profile:
        profile_run("train_step", one(step, state, batch))

    n_params = cfg.param_count()
    tokens = b * s
    flops = 8 * n_params * tokens      # 6N a token, plus 2N to recompute
    return {"arch": TRAIN_ARCH, "batch": b, "seq": s, "params": n_params,
            "loss_first": loss, "loss_f32_compute": loss32,
            "bf16_vs_f32": vs32,
            "grad_norm": gnorm, "step_ms": step_s * 1e3,
            "runs_ms": [r * 1e3 for r in runs],
            "tokens_per_s": tokens / step_s, "peak_gib": peak,
            "micro4_step_ms": statistics.median(runs4) * 1e3,
            "micro4_runs_ms": [r * 1e3 for r in runs4],
            "micro4_peak_gib": peak4,
            "remat_peak_gib_batch2": remat_peak,
            "model_flops": flops,
            "model_flops_share_bf16": flops / step_s / BF16_OPS_PER_S}


class CkptSpy:
    """Times ``CheckpointManager``'s file writes (the background thread's
    ``_write``) and restores, and sums their bytes."""

    def __init__(self):
        from repro_torch.checkpoint.manager import CheckpointManager
        self.cls = CheckpointManager
        self.real_write, self.real_restore = (CheckpointManager._write,
                                              CheckpointManager.restore)
        self.writes, self.restores = [], []

    def __enter__(self):
        spy = self

        def write(mgr, step, leaves):
            t0 = time.perf_counter()
            spy.real_write(mgr, step, leaves)
            spy.writes.append((sum(t.numel() * t.element_size()
                                   for _, _, t in leaves),
                               time.perf_counter() - t0))

        def restore(mgr, template, step=None, shardings=None, device=None):
            t0 = time.perf_counter()
            out = spy.real_restore(mgr, template, step, shardings, device)
            torch.cuda.synchronize()
            spy.restores.append(time.perf_counter() - t0)
            return out

        self.cls._write, self.cls.restore = write, restore
        return self

    def __exit__(self, *exc):
        self.cls._write, self.cls.restore = self.real_write, self.real_restore


def workflow_corpus(cfg, seed: int):
    """Phase 26's corpus config (phase 29 writes it to disk)."""
    from repro_torch.data import pipeline as TP

    return TP.CorpusConfig(n_docs=WORKFLOW["n_docs"],
                           mean_doc_len=WORKFLOW["mean_doc_len"],
                           vocab_size=cfg.vocab_size, seed=seed)


def workflow_phase(dev, seed: int, launches) -> dict:
    """Phase 26: the table pipeline prepares smollm-360m's batches on 4
    virtual shards, ``train_loop`` trains and resumes, and the engine
    serves the trained weights, as three journaled workflow tasks."""
    from repro_torch.configs import get_config
    from repro_torch.core import HPTMTContext
    from repro_torch.data import pipeline as TP
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import LoopConfig, train_loop
    from repro_torch.workflow.engine import Task, WorkflowEngine

    cfg = get_config(TRAIN_ARCH)
    ctx4 = HPTMTContext(n_shards=4, device="cuda")
    ccfg = workflow_corpus(cfg, seed)
    tcfg = TrainConfig(optimizer=OptimizerConfig(
        learning_rate=1e-3, warmup_steps=2,
        total_steps=WORKFLOW["resume_to"]))
    out, logs = {}, []

    def prepare():
        real = TP.preprocess

        def timed(corpus, c, ctx):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream = real(corpus, c, ctx)
            out["preprocess_s"] = time.perf_counter() - t0
            out["stream"] = stream
            return stream

        launches.reset()
        TP.preprocess = timed
        try:
            data = TP.make_training_data(cfg, ctx4, TRAIN["batch"],
                                         TRAIN["seq"], ccfg)
        finally:
            TP.preprocess = real
        out["prepare_launches"], out["exchanges"] = launches.read()
        return data

    def train(prepare):
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed)
        loop = LoopConfig(total_steps=WORKFLOW["steps"], log_every=1,
                          checkpoint_every=WORKFLOW["steps"],
                          checkpoint_dir=ckdir)
        train_loop(cfg, tcfg, loop, prepare, gen, log_fn=logs.append,
                   device=dev)
        out["history"] = list(train_loop.last_history)
        # a restart: the loop resumes from the last snapshot
        loop = dataclasses.replace(loop, total_steps=WORKFLOW["resume_to"])
        state = train_loop(cfg, tcfg, loop, prepare, gen,
                           log_fn=logs.append, device=dev)
        out["resumed_history"] = list(train_loop.last_history)
        out["train_s"] = time.perf_counter() - t0
        return state

    def serve(train):
        model = LM.from_state_dict(cfg, train.params, dev)
        check(model.embed.dtype == torch.bfloat16, "served in bf16")
        b, s, n = WORKFLOW["prompts"], WORKFLOW["prompt"], WORKFLOW["gen"]
        prompts = np.random.default_rng(seed + 6).integers(
            1, cfg.vocab_size, (b, s), dtype=np.int32)
        engine = Engine(model, ServeConfig(max_len=s + n + 8))
        launches.reset()
        with FlashTap() as tap:
            tokens = engine.generate(prompts, n)
        counts, _ = launches.read()
        check(counts["flash_attention"] == cfg.n_layers == tap.layers
              and not tap.bad, f"serve: {counts['flash_attention']} flash "
              f"launches, {tap.layers} tapped, outside 2e-2: {tap.bad}")
        out["flash_vs_plain_attention_max_abs_err"] = tap.max_abs_err
        last, _ = engine.prefill(prompts)
        with torch.inference_mode():
            logits, _, _ = model(torch.from_numpy(prompts).to(dev),
                                 mode="train")
        out["prefill_vs_train_forward_logits"] = rel_err(
            last.float(), logits[:, -1].float())
        check(out["prefill_vs_train_forward_logits"] <= 2e-2,
              f"serving prefill vs a train-mode forward: "
              f"{out['prefill_vs_train_forward_logits']}")
        out["serve_launches"] = counts
        return tokens

    with tempfile.TemporaryDirectory(prefix="hptmt_train_") as tmp, \
            CkptSpy() as spy:
        ckdir = os.path.join(tmp, "ckpt")
        wf = WorkflowEngine(os.path.join(tmp, "journal.json"))
        wf.add(Task("prepare", prepare))
        wf.add(Task("train", train, deps=("prepare",)))
        wf.add(Task("serve", serve, deps=("train",)))
        res = wf.run()

    # the curated stream: bit for bit the plain path's (the same 4-shard
    # pipeline on the CPU, held to the JAX package's in the tests), and
    # the numpy oracle's (the good documents' tokens in (doc, position)
    # order) but for the rows the reference's join drops on 4 shards —
    # its token table is full a shard and the doc-id shuffle sends a
    # heavy shard more (ROADMAP Queue 3)
    stream = out.pop("stream")
    cpu4 = HPTMTContext(n_shards=4, device="cpu")
    t0 = time.perf_counter()
    plain = TP.preprocess(TP.synthetic_corpus(ccfg, cpu4), ccfg, cpu4)
    out["plain_preprocess_s"] = time.perf_counter() - t0
    check(np.array_equal(stream, plain),
          "the card's curated stream equals the plain path's")
    arrays = TP.synthetic_corpus_arrays(ccfg)
    good = arrays["docs"]["quality"] >= ccfg.quality_threshold
    toks = arrays["tokens"]
    n_good = int(good[toks["doc_id"]].sum())
    out["rows_dropped_by_join"] = n_good - int(stream.shape[0])
    out["good_token_rows"] = n_good
    check(out["rows_dropped_by_join"] >= 0, "no row made up")
    pl = out["prepare_launches"]
    check(pl["probe"] > 0 and pl["hash_partition"] > 0,
          f"prepare launches the probe and hash_partition: {pl}")
    hist, hist2 = out["history"], out["resumed_history"]
    check(len(hist) == WORKFLOW["steps"] and len(hist2) ==
          WORKFLOW["resume_to"] - WORKFLOW["steps"], "steps run")
    check(all(np.isfinite(hist + hist2)), "finite losses")
    check(hist[-1] < hist[0], f"the loss fell: {hist[0]} → {hist[-1]}")
    check(any(f"resumed from checkpoint step {WORKFLOW['steps']}" in line
              for line in logs), "the second loop resumed from step 8")
    tokens = res["serve"]
    check(tokens.shape == (WORKFLOW["prompts"], WORKFLOW["gen"])
          and tokens.dtype == np.int32
          and ((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
          "served tokens in range")
    check(not os.path.exists(ckdir), "the checkpoint directory is gone")
    wbytes = sum(bb for bb, _ in spy.writes)
    return {**out, "stream_tokens": int(stream.shape[0]),
            "stream_digest": digest(torch.from_numpy(stream)),
            "token_rows": int(toks["token"].shape[0]),
            "checkpoint_saves": len(spy.writes),
            "checkpoint_gb": [bb / 1e9 for bb, _ in spy.writes],
            "checkpoint_write_gb_per_s": [bb / 1e9 / t
                                          for bb, t in spy.writes],
            "checkpoint_write_s": sum(t for _, t in spy.writes),
            "restore_s": spy.restores,
            "restore_gb_per_s": [spy.writes[0][0] / 1e9 / t
                                 for t in spy.restores],
            "log_tail": logs[-3:], "bytes_written": wbytes}


# ---------------------------------------------------------------------------
# phase 27: Table I collectives and the MDS composition
# ---------------------------------------------------------------------------
#: phase 27a: one 256 MB float32 input a collective, on 1 and 4 virtual
#: shards; alltoall splits each shard's block into one chunk a shard, so
#: it takes the same bytes as 16 rows (4 rows a block)
COLL_SHAPE, COLL_A2A_SHAPE = (4, 1 << 24), (16, 1 << 22)
COLLECTIVES = [("allreduce", {"op": "sum"}), ("allreduce", {"op": "max"}),
               ("allreduce", {"op": "mean"}), ("allgather", {}),
               ("alltoall", {}), ("reduce_scatter", {}),
               ("broadcast", {"root": 2}), ("gather", {"root": 3}),
               ("scatter", {"root": 1}), ("reduce", {"root": 1, "op": "sum"})]
#: phase 27b: MDS at 2^15 points (δ is 32768^2 float32, 4.3 GB)
MDS = {"n": 1 << 15, "dim": 3, "iters": 100, "sample_rows": 64}
#: phase 27b's limits (readings: NVIDIA H100 80GB HBM3, 700 W; PERF.md §6,
#: the array-side entry): δ on 4 shards against 1 shard (max |err| over
#: max δ; read 0, bit for bit: limit one float32 ulp) and against a
#: float64 δ on sampled rows (read 4.8e-7: about 3x); a stress step's rise
#: over the stress and the float64 stress of the returned embedding over
#: ``path[-1]`` (read -5.0e-4 and -3.4e-3, both fell: limit a float32
#: sum's rounding); the 1- against the 4-shard stress paths over the first
#: stress (read 0)
MDS_LIMITS = {"delta_4v1": 1.2e-7, "delta_vs_f64": 1.5e-6,
              "stress_rise": 1e-6, "final_f64_over_last": 1e-6,
              "paths_1v4": 1.2e-7}


def collective_oracle(name, kw, x, s):
    """``(expected, scale, bytes the operator must read)``: ``scale`` is
    ``None`` for an exact result, else the ``sum|x|`` of each float sum
    or mean (float64 numpy)."""
    n, c = x.shape
    heads = x.reshape(s, n // s, c)[:, 0] if s > 1 else x
    read = heads.nbytes if name in ("allreduce", "broadcast", "reduce") \
        else x.nbytes
    op = kw.get("op", "sum")
    if name in ("allreduce", "reduce"):
        if op == "max":
            exp, scale = heads.max(0), None
        else:
            h = heads.astype(np.float64)
            exp, scale = h.sum(0), np.abs(h).sum(0)
            if op == "mean":
                exp, scale = exp / len(h), scale / len(h)
        if name == "reduce":
            full = np.zeros((s, c), exp.dtype)
            full[kw["root"] if s > 1 else 0] = exp
            exp = full
            if scale is not None:
                scale = np.broadcast_to(scale, full.shape)
        return exp, scale, read
    if name == "alltoall" and s > 1:
        return (x.reshape(s, s, n // s // s, c).transpose(1, 0, 2, 3)
                .reshape(n, c)), None, read
    if name == "reduce_scatter" and s > 1:
        return s * x.astype(np.float64), s * np.abs(x.astype(np.float64)), \
            read
    if name == "broadcast":
        return (heads if s > 1 else x)[kw["root"]], None, read
    if name == "gather":
        if s == 1:
            return x[None], None, read
        full = np.zeros((s, n, c), x.dtype)
        full[kw["root"]] = x
        return full, None, read
    return x, None, read  # allgather, scatter; alltoall/reduce_scatter on 1


def collectives_phase(dev, seed: int) -> dict:
    """Phase 27a: each Table I operator on 4 virtual shards and on 1,
    against a numpy oracle; exchanges, ms and the bytes bound."""
    from repro_torch.core import HPTMTContext, array_ops

    rng = np.random.default_rng(seed + 27)
    inputs = {shape: rng.standard_normal(shape, dtype=np.float32)
              for shape in (COLL_SHAPE, COLL_A2A_SHAPE)}
    out = {}
    for s in (4, 1):
        ctx = HPTMTContext(n_shards=s, device="cuda")
        for name, kw in COLLECTIVES:
            x = inputs[COLL_A2A_SHAPE if name == "alltoall" else COLL_SHAPE]
            xd = torch.from_numpy(x).to(dev)
            fn = getattr(array_ops, name)
            array_ops.EXCHANGES.reset()
            got = fn(xd, ctx=ctx, **kw)
            torch.cuda.synchronize()
            ex = array_ops.EXCHANGES.n
            wrote = got.numel() * got.element_size()
            check(ex == int(name == "alltoall" and s > 1),
                  f"{name} on {s} shards: {ex} exchanges")
            exp, scale, read = collective_oracle(name, kw, x, s)
            g = got.cpu().numpy()
            check(g.shape == exp.shape and g.dtype == np.float32,
                  f"{name} on {s} shards: shape {g.shape} / {exp.shape}")
            if scale is None:
                check(np.array_equal(g, exp), f"{name} on {s} shards: exact")
                err = 0.0
            else:
                diff = np.abs(g - exp)
                check(bool((diff <= 1e-6 * scale).all()),
                      f"{name} on {s} shards: within 1e-6 sum|x|")
                err = float(diff.max())
            del g, exp, scale
            # an operator that returns (a view of) its input moves nothing
            same = (got.untyped_storage().data_ptr()
                    == xd.untyped_storage().data_ptr())
            del got
            nbytes = 0 if same else read + wrote
            ms = cuda_ms(lambda: fn(xd, ctx=ctx, **kw))
            tag = name + "".join(f" {k}={v}" for k, v in kw.items())
            out[f"{tag}/{s}"] = {"ms": ms, "bound_ms": bound(nbytes)[0],
                                 "bytes": nbytes, "max_abs_err": err,
                                 "exchanges": ex}
            del xd
    torch.cuda.empty_cache()
    return out


def mds_oracle(n: int, seed: int):
    """The curated ids and points of the reference's point table, by numpy
    alone (its draws, its quality clamp, ``quality >= 0.5``, by id)."""
    rng = np.random.default_rng(seed)
    n_raw = n + n // 3 + 1
    feats = rng.normal(size=(n_raw, 4)).astype(np.float32)
    quality = rng.uniform(size=n_raw).astype(np.float32)
    order = np.argsort(-quality)
    quality[order[:n]] = np.clip(quality[order[:n]], 0.5, None)
    quality[order[n:]] = np.clip(quality[order[n:]], None, 0.49)
    keep = quality >= 0.5
    return np.arange(n_raw, dtype=np.int32)[keep], feats[keep]


def stress_f64(delta, x, chunk: int = 1024) -> float:
    """SMACOF's stress of ``x`` in float64 against the float32 δ (the
    diagonal left out), in row chunks."""
    x64 = x.double()
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for lo in range(0, x.shape[0], chunk):
        d = torch.cdist(x64[lo:lo + chunk], x64,
                        compute_mode="donot_use_mm_for_euclid_dist")
        sq = (delta[lo:lo + chunk].double() - d) ** 2
        i = torch.arange(sq.shape[0], device=x.device)
        sq[i, i + lo] = 0
        total += sq.sum()
    return float(total) / 2


def mds_phase(dev, seed: int, launches) -> dict:
    """Phase 27b: ``mds_pipeline``'s pieces at 2^15 points on 1 and 4
    virtual shards: the curated ids, δ, SMACOF, the stress path."""
    from repro_torch.apps import mds
    from repro_torch.core import HPTMTContext

    n, dim, iters = MDS["n"], MDS["dim"], MDS["iters"]
    ids, pts = mds_oracle(n, seed)
    rows = torch.as_tensor(np.random.default_rng(seed + 28).choice(
        n, MDS["sample_rows"], replace=False), device=dev)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    out, delta, paths, xs = {}, {}, {}, {}
    for s in (1, 4):
        ctx = HPTMTContext(n_shards=s, device="cuda")
        launches.reset()
        curated = mds.curated_table(n, ctx, seed)
        counts, ex = launches.read()
        check(ex == (0 if s == 1 else 1), f"mds {s} shards: table side made "
              f"{ex} exchanges (sort_values: 1 on 4 shards)")
        check(not any(counts.values()), f"mds {s} shards: launches {counts}")
        check(np.array_equal(curated.to_numpy()["id"], ids),
              f"mds {s} shards: curated ids equal the numpy oracle's")
        points = curated.to_torch(mds.FEATURES)
        check(np.array_equal(points.cpu().numpy(), pts),
              f"mds {s} shards: curated points equal the numpy oracle's")
        delta[s] = mds.distance_matrix(points, ctx)
        check(delta[s].shape == (n, n), f"mds {s} shards: δ shape")
        ms = cuda_ms(lambda: mds.distance_matrix(points, ctx), reps=3)
        # the float64 oracle on sampled rows, the diagonal left out
        p64 = points.double()
        d64 = torch.cdist(p64[rows], p64,
                          compute_mode="donot_use_mm_for_euclid_dist")
        d64[torch.arange(len(rows), device=dev), rows] = float("nan")
        err = float(torch.nan_to_num((delta[s][rows].double() - d64).abs())
                    .max() / d64.nan_to_num().max())
        check(err <= MDS_LIMITS["delta_vs_f64"],
              f"mds {s} shards: δ against float64 {err}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths[s], xs[s] = mds.smacof(delta[s], dim, iters, seed)
        smacof_s = time.perf_counter() - t0
        out[f"mds_{s}"] = {"exchanges": ex, "delta_ms": ms,
                           "delta_vs_f64": err, "smacof_s": smacof_s,
                           "ms_per_iteration": smacof_s / iters * 1e3}
        del curated, points, p64, d64
    scale = float(delta[1].abs().max())
    out["delta_4v1"] = float((delta[4] - delta[1]).abs().max()) / scale
    check(out["delta_4v1"] <= MDS_LIMITS["delta_4v1"],
          f"mds: δ on 4 shards against 1: {out['delta_4v1']}")
    for s in (1, 4):
        path = np.asarray(paths[s])
        check(np.isfinite(path).all() and path[-1] < 0.8 * path[0],
              f"mds {s} shards: stress path {path[[0, -1]]}")
        rise = float((np.diff(path) / path[:-1]).max())
        check(rise <= MDS_LIMITS["stress_rise"],
              f"mds {s} shards: the stress rose by {rise}")
        final = stress_f64(delta[s], xs[s])
        over = final / path[-1] - 1
        check(over <= MDS_LIMITS["final_f64_over_last"],
              f"mds {s} shards: float64 stress {final} of the embedding "
              f"against path[-1] {path[-1]}")
        out[f"mds_{s}"].update(stress_first=path[0], stress_last=path[-1],
                               stress_max_rise=rise, final_stress_f64=final,
                               final_f64_over_last=over)
    out["paths_1v4"] = float(np.abs(np.asarray(paths[4]) - paths[1]).max()
                             / paths[1][0])
    check(out["paths_1v4"] <= MDS_LIMITS["paths_1v4"],
          f"mds: 1- against 4-shard stress paths {out['paths_1v4']}")
    del delta, xs
    torch.cuda.empty_cache()
    # the whole pipeline on 4 shards: a warm-up checked against the pieces'
    # path, then 3 timed runs
    ctx4 = HPTMTContext(n_shards=4, device="cuda")
    path, _ = mds.mds_pipeline(n, dim, iters, ctx4, seed)
    check(path == paths[4], "mds pipeline on 4 shards: the pieces' path")
    runs = timed_runs(lambda: mds.mds_pipeline(n, dim, iters, ctx4, seed))
    out["pipeline_4"] = {"median_s": statistics.median(runs), "runs_s": runs}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["bound_ms_per_iteration"] = bound(n * n * 4)[0]
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 29: the table path on a process group
# ---------------------------------------------------------------------------
GROUP_WORLD = 4
#: timed runs of each chain a leg (one: the time limit)
GROUP_RUNS = 1
GROUP_TIMEOUT_S = 900
#: MDS on the group legs: 2^13 points keep 4 ranks' δ (256 MB each) and
#: SMACOF buffers small on one card
MDS_GROUP = {"n": 1 << 13, "dim": 3, "iters": 100}
#: float lanes of the main path made by the segment kernels' float
#: atomics, whose order of addition varies from run to run (phase 17):
#: held against the float64 oracle as phase 4 holds them; every other
#: lane, count, layout and overflow bit for bit
ATOMIC_SUMS = {"g": ("v_sum", "v_mean", "w_sum"), "k": ("v_sum",)}
#: the Table I operators whose results are row-sharded
SHARDED_OUT = ("alltoall", "reduce_scatter", "scatter", "gather", "reduce")


#: splitmix64's finalizer constants and two seeds, as int64
MIX64 = (-4658895280553007687, -7723592293110705685)
DIGEST_SEEDS = (-7046029254386353131, -2960836687051489901)
DIGEST_WORDS = 1 << 24


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 lanes (a bijection of 64 bits;
    ``>>`` is arithmetic on int64, so each shift is masked to a logical
    one)."""
    for shift, mul in ((30, MIX64[0]), (27, MIX64[1]), (31, None)):
        x = x ^ ((x >> shift) & ((1 << (64 - shift)) - 1))
        if mul is not None:
            x = x * mul
    return x


def digest(t: torch.Tensor) -> str:
    """A tensor's bits, fingerprinted on the card (a host tensor is
    copied there; on a machine with no card, on the host): the bytes as
    8-byte words, zero-padded, each word plus its position times a seed
    mixed by :func:`mix64` and the results summed mod 2^64, under two
    seeds (128 bits), then the byte count.  One changed word changes
    each sum, as the mix is a bijection; a word's position enters its
    term, so reordered words change the sums but for a 2^-64 chance."""
    flat = t.detach().reshape(-1)
    if flat.device.type != "cuda" and torch.cuda.is_available():
        flat = flat.to("cuda")
    b = flat.view(torch.uint8)
    nbytes = b.numel()
    if nbytes % 8 or b.storage_offset() % 8:
        b = torch.cat([b, b.new_zeros(-nbytes % 8)])
    w = b.view(torch.int64)
    sums = []
    for seed in DIGEST_SEEDS:
        total = torch.zeros((), dtype=torch.int64, device=w.device)
        for lo in range(0, w.numel(), DIGEST_WORDS):
            part = w[lo:lo + DIGEST_WORDS]
            pos = torch.arange(lo + 1, lo + 1 + part.numel(),
                               dtype=torch.int64, device=w.device)
            total = total + mix64(part + pos * seed).sum()
        sums.append(int(total) & ((1 << 64) - 1))
    return f"{sums[0]:016x}{sums[1]:016x}-{nbytes}"


def shard_prints(res: dict, first: int, valid_only: bool = False) -> dict:
    """A chain's results as per-shard prints: each DataFrame's column
    blocks hashed shard by shard (global shard ids from ``first``), its
    counts, partitioning and overflow; each array whole.  Nothing moves
    between ranks: the shards are compared where they are.
    ``valid_only`` hashes each block's valid rows alone (the TSet
    results: 2^24-row blocks holding a few thousand to a few million
    rows each)."""
    out = {}
    for name, v in res.items():
        if hasattr(v, "table") or hasattr(v, "counts"):
            dt = getattr(v, "table", v)     # a DataFrame or a DistTable
            report = getattr(v, "overflow_report", None)
            n = (dt.counts.tolist() if valid_only
                 else [dt.capacity] * dt.n_local)
            out[name] = {
                "cols": {k: {first + i: digest(b[:n[i]])
                             for i, b in enumerate(c.unbind(0))}
                         for k, c in dt.columns.items()},
                "counts": {first + i: n
                           for i, n in enumerate(dt.counts.tolist())},
                "part": repr(dt.partitioning),
                "report": sorted(dict(report or {}).items())}
        elif isinstance(v, np.ndarray):
            out[name] = v
    return out


def merge_prints(per_rank: list) -> dict:
    """One chain's prints of every rank, merged by shard; arrays must be
    the same on every rank."""
    out = {}
    for p in per_rank:
        for name, v in p.items():
            if isinstance(v, np.ndarray):
                if name in out:
                    check(np.array_equal(bits_np(out[name]), bits_np(v)),
                          f"{name}: the same on every rank")
                out[name] = v
                continue
            m = out.setdefault(name, {"cols": {}, "counts": {},
                                      "part": v["part"],
                                      "report": v["report"]})
            check((m["part"], m["report"]) == (v["part"], v["report"]),
                  f"{name}: layout and overflow the same on every rank")
            m["counts"].update(v["counts"])
            for k, d in v["cols"].items():
                m["cols"].setdefault(k, {}).update(d)
    return out


def compare_prints(got: dict, want: dict, tag: str, atomic=None) -> dict:
    """Bit for bit: every shard's blocks, counts, layout and overflow;
    ``atomic[name]`` columns only reported — the share of their shard
    blocks whose bits equal the virtual run's."""
    check(sorted(got) == sorted(want),
          f"{tag}: results {sorted(got)} / {sorted(want)}")
    same = {}
    for name, w in want.items():
        g, what = got[name], f"{tag} {name}"
        if isinstance(w, np.ndarray):
            check(g.dtype == w.dtype and np.array_equal(bits_np(g),
                                                         bits_np(w)), what)
            continue
        for key in ("counts", "part", "report"):
            check(g[key] == w[key], f"{what} {key}: {g[key]} / {w[key]}")
        check(sorted(g["cols"]) == sorted(w["cols"]), f"{what} columns")
        for k, wd in w["cols"].items():
            if k in (atomic or {}).get(name, ()):
                same[f"{name}.{k}"] = float(np.mean(
                    [g["cols"][k][s] == d for s, d in wd.items()]))
            else:
                check(g["cols"][k] == wd, f"{what} {k}: bit for bit")
    return same


def whole_rows(df) -> dict:
    """A DataFrame's valid rows on the host (a collective on a group)."""
    return {k: v.cpu().numpy() for k, v in df.table.valid_rows().items()}


def collective_prints(ctx, dev, seed: int) -> dict:
    """Phase 27a's operators on ``ctx``: this process's rows of the 256 MB
    inputs in; a replicated result hashed whole, a row-sharded one shard
    block by shard block."""
    from repro_torch.core import array_ops

    rng = np.random.default_rng(seed + 27)
    inputs = {shape: rng.standard_normal(shape, dtype=np.float32)
              for shape in (COLL_SHAPE, COLL_A2A_SHAPE)}
    out = {}
    for name, kw in COLLECTIVES:
        x = inputs[COLL_A2A_SHAPE if name == "alltoall" else COLL_SHAPE]
        b = x.shape[0] // ctx.n_shards
        lo = ctx.local_shards.start * b
        mine = x if name in ("reduce_scatter", "scatter") \
            else x[lo:lo + ctx.n_local * b]
        got = getattr(array_ops, name)(torch.from_numpy(mine).to(dev),
                                       ctx=ctx, **kw)
        key = name + "".join(f" {k}={v}" for k, v in kw.items())
        if name in SHARDED_OUT:
            out[key] = {ctx.local_shards.start + i: digest(blk) for i, blk
                        in enumerate(got.tensor_split(ctx.n_local))}
        else:
            out[key] = {"whole": digest(got)}
        del got
    return out


def wall_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mds_prints(ctx, seed: int) -> tuple:
    """MDS at :data:`MDS_GROUP`'s size on ``ctx``, in pieces: the curated
    table's prints, δ's digest, the points, stress path and embedding."""
    from repro_torch.apps import mds

    n, dim, iters = MDS_GROUP["n"], MDS_GROUP["dim"], MDS_GROUP["iters"]
    curated = mds.curated_table(n, ctx, seed)
    points = curated.to_torch(mds.FEATURES)
    delta = mds.distance_matrix(points, ctx)
    path, x = mds.smacof(delta, dim, iters, seed)
    out = shard_prints({"curated": curated}, ctx.local_shards.start)
    out.update(points=points.cpu().numpy(), path=np.asarray(path),
               x=x.cpu().numpy())
    return out, digest(delta)


def group_storage(ctx, root: str, seed: int, left, right, checked,
                  prints) -> dict:
    """Phase 29's storage legs on ``ctx``'s group, under ``root`` (one
    directory every rank sees): phase 12's partitioned write of the left
    frame by the ranks and its re-entry into the join and groupbys, phase
    15's ``groupby_k`` and ``join_groupby`` TSet pipelines, and phase
    26's corpus written to disk by the ranks and curated from there by
    ``make_training_data``.  Fills ``prints``; returns the legs' times
    and this rank's file prints."""
    from repro_torch.configs import get_config
    from repro_torch.core.dataflow import TSet
    from repro_torch.data import pipeline as TP
    from repro_torch.dataframe import DataFrame
    from repro_torch.io.dataset import write_dist_table

    out = {}
    lroot = os.path.join(root, "left")
    ldf = DataFrame.from_dict(left, ctx, bucket_factor=2.0)
    rdf = DataFrame.from_dict(right, ctx, bucket_factor=2.0)
    t0 = time.perf_counter()
    checked("write", lambda: ldf.to_hpt(lroot, partition_by=["k"]))
    out["write_s"] = time.perf_counter() - t0
    mine = tuple(f"part-{s:05d}-" for s in ctx.local_shards)
    out["files"] = file_digests(lroot, lambda n: n.startswith(mine) or (
        ctx.rank == 0 and n == "_hptmt_manifest.json"))
    out["write_bytes"] = sum(os.path.getsize(os.path.join(lroot, n))
                             for n in out["files"] if n.startswith(mine))

    def reentry():
        t0 = time.perf_counter()
        lp = DataFrame.read_dataset(lroot, ctx)
        torch.cuda.synchronize()
        out["read_s"] = time.perf_counter() - t0
        return dict(join_groupbys(lp, rdf), lp=lp)

    t0 = time.perf_counter()
    res = checked("reentry", reentry)
    out["reentry_s"] = time.perf_counter() - t0
    check(res["lp"].partitioning == (("k",), 4),
          f"rank {ctx.rank}: re-entry partitioning {res['lp'].partitioning}")
    prints["reentry"] = shard_prints(res, ctx.local_shards.start)
    g = whole_rows(res["g"])            # 1024 groups: whole on every rank
    prints["reentry_g"] = g if ctx.rank == 0 else None
    pos = np.ones(left["v"].shape, bool)
    out["reentry_k_groups"] = check_local_groups(
        res["k"].table, left["k"], left["v"], pos, ("v_sum",), ctx.device,
        f"rank {ctx.rank} re-entry groupby k")
    del res, g

    pipes = tset_pipelines(TSet, ctx, ldf.table, rdf.table, None)
    for name in GROUP_TSET:
        t0 = time.perf_counter()
        ts, got = checked(f"tset_{name}", pipes[name])
        out[f"tset_{name}_s"] = time.perf_counter() - t0
        check(ts.overflow_report.is_exact(), f"rank {ctx.rank}: TSet "
              f"{name} exact")
        prints[f"tset_{name}"] = shard_prints({"t": got},
                                              ctx.local_shards.start,
                                              valid_only=True)
        if name == "join_groupby":      # 1024 groups: whole on every rank
            rows = sort_rows_on_card(got, ["g"])
            prints["tset_join_groupby_rows"] = (rows if ctx.rank == 0
                                                else None)
        else:
            out["tset_k_groups"] = check_local_groups(
                got, left["k"], left["v"], left["v"] > 0,
                ("v_sum", "v_mean", "v_min", "v_max", "v_count"),
                ctx.device, f"rank {ctx.rank} TSet {name}")
        del ts, got
    del ldf, rdf, pipes

    cfg = get_config(TRAIN_ARCH)
    ccfg = workflow_corpus(cfg, seed)
    croot = os.path.join(root, "corpus")
    t0 = time.perf_counter()
    for name, dt in TP.synthetic_corpus(ccfg, ctx).items():
        # one .hpt file a shard: the scan puts each back on its shard, so
        # the curated stream is phase 26's (parquet's row groups would
        # spread a shard's rows over the shards and change which rows the
        # reference's join drops)
        write_dist_table(dt, os.path.join(croot, name), ctx=ctx,
                         format="hpt")
    out["corpus_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = checked("corpus", lambda: TP.make_training_data(
        cfg, ctx, TRAIN["batch"], TRAIN["seq"], ccfg, data_root=croot))
    out["corpus_s"] = time.perf_counter() - t0
    out["stream"] = digest(torch.from_numpy(data.stream))
    return out


def check_local_groups(dt, k, v, keep, lanes, dev, tag: str,
                       n_keys: int = RIGHT_ROWS) -> tuple:
    """A groupby on ``k`` of the rows ``keep`` selects, held shard by shard
    where the shards are (no rank gathers them) against dense per-key
    oracles of ``v``: every key present and held once here, counts, min
    and max exact (taken on the card), sums and means within ``1e-5`` of
    the key's ``sum|v|``.  Returns ``(groups held here, keys present)``:
    summed over the ranks, the two must agree."""
    k, v = k[keep], v[keep]
    cnt = np.bincount(k, minlength=n_keys)
    total = np.bincount(k, v.astype(np.float64), n_keys)
    scale = np.bincount(k, np.abs(v).astype(np.float64), n_keys)
    kd, vd = torch.from_numpy(k).to(dev).long(), torch.from_numpy(v).to(dev)
    inf = torch.full((n_keys,), float("inf"), device=dev)
    dense = {"v_count": cnt, "v_sum": total, "v_mean": total / np.maximum(
        cnt, 1), "v_min": inf.scatter_reduce(0, kd, vd, "amin").cpu().numpy(),
        "v_max": (-inf).scatter_reduce(0, kd, vd, "amax").cpu().numpy()}
    rows = {c: torch.cat([dt.columns[c][i, :n] for i, n in
                          enumerate(dt.counts.tolist())]).cpu().numpy()
            for c in ("k",) + tuple(lanes)}
    keys = rows["k"].astype(np.int64)
    check(bool((cnt[keys] > 0).all()) and np.unique(keys).size == keys.size,
          f"{tag}: keys present and held once")
    n = np.maximum(cnt[keys], 1)
    for lane in lanes:
        want = dense[lane][keys]
        if lane in ("v_count", "v_min", "v_max"):
            check(np.array_equal(rows[lane], want), f"{tag}: {lane}")
        else:
            check_close(rows[lane], want,
                        scale[keys] / (n if lane == "v_mean" else 1),
                        f"{tag}: {lane}")
    return int(keys.size), int((cnt > 0).sum())


def group_rank(ctx, seed: int, want_ex: dict, store_root: str,
               svc: dict) -> dict:
    """One rank of phase 29: phases 4, 5, 7 and 27a's chains at full size
    and MDS at 2^13 points on ``ctx``'s group, then the storage legs
    (:func:`group_storage`) under ``store_root`` and the services legs
    (:func:`group_services`; ``svc`` without the paths, which are put
    under ``store_root`` here).  Each chain runs once checked, then timed;
    returns the rank's prints of the checked results, launches, exchanges
    and times — or, when ``svc`` names a ``crash``, writes them to its
    file and dies by SIGKILL in phase 17's crashed chain
    (:func:`group_crash`)."""
    from repro_torch.apps import mds
    from repro_torch.core import array_ops, table_ops
    from repro_torch.dataframe import DataFrame

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = ctx.device
    first = ctx.local_shards.start
    torch.cuda.reset_peak_memory_stats()
    left, right, sets = make_data(seed)
    events = make_events(seed)
    launches = Launches()
    prints, exchanges, runs, marks = {}, {}, {}, {"data": 0.0}

    def mark(name):
        marks[name] = time.perf_counter() - t_start - sum(marks.values())

    mark("data")

    def checked(tag, fn):
        launches.reset()
        res = fn()
        _, exchanges[tag] = launches.read()
        check(exchanges[tag] == want_ex[tag],
              f"rank {ctx.rank} {tag}: {exchanges[tag]} exchanges, the "
              f"virtual run made {want_ex[tag]}")
        return res

    res = checked("main", lambda: main_path(DataFrame, ctx, left, right,
                                            2.0))
    prints["main"] = shard_prints(res, first)
    # the atomic sums' tables whole, for the float64 oracle
    prints["main_sums"] = {"g": whole_rows(res["g"]),
                           "k": whole_rows(res["k"])}
    del res
    runs["main"] = timed_runs(lambda: main_path(DataFrame, ctx, left, right,
                                                2.0), GROUP_RUNS)
    mark("main")
    res = checked("setops", lambda: set_ops(DataFrame, ctx, sets))
    prints["setops"] = shard_prints(res, first)
    del res
    runs["setops"] = timed_runs(lambda: set_ops(DataFrame, ctx, sets),
                                GROUP_RUNS)
    mark("setops")
    res = checked("ordered", lambda: ordered_path(DataFrame, ctx, events,
                                                  2.0, launches.sorts))
    check(res["win_sorts"] == 0 and res["q_sorts"] == 0,
          f"rank {ctx.rank}: the windows and the exact quantile sorted")
    prints["ordered"] = shard_prints(res, first)
    del res
    runs["ordered"] = timed_runs(lambda: ordered_path(
        DataFrame, ctx, events, 2.0, launches.sorts), GROUP_RUNS)
    mark("ordered")
    prints["collectives"] = collective_prints(ctx, dev, seed)
    mark("collectives")

    n, dim, iters = MDS_GROUP["n"], MDS_GROUP["dim"], MDS_GROUP["iters"]
    prints["mds"], prints["mds_delta"] = checked(
        "mds", lambda: mds_prints(ctx, seed))
    pipe, _ = mds.mds_pipeline(n, dim, iters, ctx, seed)
    check(np.array_equal(pipe, prints["mds"]["path"]),
          f"rank {ctx.rank}: the mds pipeline's path is its pieces'")
    runs["mds"] = timed_runs(lambda: mds.mds_pipeline(n, dim, iters, ctx,
                                                      seed), GROUP_RUNS)
    mark("mds")
    storage = group_storage(ctx, store_root, seed, left, right, checked,
                            prints)
    mark("storage")
    svc = dict(svc, lroot=os.path.join(store_root, "left"),
               root=os.path.join(store_root, "services"))
    services = group_services(ctx, seed, svc, left, right, launches, prints)
    mark("services")

    # one packed shuffle frame of the main path's join (the left side:
    # k, g, v and the carried h1, h2 lanes; 2x head-room buckets)
    cap = 2 * LEFT_ROWS // ctx.n_shards
    bucket = table_ops._bucket_capacity(cap, ctx.n_shards, 2.0)
    frames = [torch.ones((ctx.n_shards, bucket + 1, 5), dtype=torch.int32,
                         device=dev) for _ in range(ctx.n_local)]
    a2a = [wall_s(lambda: array_ops.all_to_all(frames, ctx.group))
           for _ in range(4)][1:]
    del frames
    out = {"rank": ctx.rank, "prints": prints, "launches": launches.total,
           "exchanges": exchanges,
           "median_s": {k: statistics.median(v) for k, v in runs.items()},
           "runs_s": runs, "storage": storage, "services": services,
           "a2a_ms": statistics.median(a2a) * 1e3,
           "a2a_bytes": ctx.n_local * ctx.n_shards * (bucket + 1) * 5 * 4,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "marks": marks, "seconds": time.perf_counter() - t_start}
    if "crash" not in svc:
        return out
    del left, right, events, sets
    crash = svc["crash"]
    out["crash_started"] = time.time()
    with open(crash["results"].format(rank=ctx.rank), "wb") as f:
        pickle.dump(out, f)
    group_crash(ctx, seed, svc["sizes"], crash["root"], crash["ckdir"])


def check_group_sums(sums: dict, oracle, tag: str) -> None:
    """The group's atomic sums against the float64 oracle, as phase 4
    holds the virtual run's."""
    check_groupby_g(sums["g"], oracle, tag)
    k = sums["k"]
    order = np.argsort(k["k"], kind="stable")
    o = oracle["k"]
    check(np.array_equal(k["k"][order], o["k"]), f"{tag}: groupby k keys")
    check_close(k["v_sum"][order], o["v_sum"], o["v_abs"], f"{tag}: k v_sum")


def virtual_reruns(dev, seed: int) -> dict:
    """Phase 27a's operators and MDS at :data:`MDS_GROUP`'s size on 4
    virtual shards: what both legs are held against."""
    from repro_torch.core import HPTMTContext

    ctx4 = HPTMTContext(n_shards=4, device="cuda")
    mds, delta = mds_prints(ctx4, seed)
    return {"collectives": collective_prints(ctx4, dev, seed), "mds": mds,
            "mds_delta": delta}


def check_group_leg(tag: str, ranks: list, ref: dict, oracle,
                    virtual: dict) -> dict:
    """Hold a leg's prints against the virtual phases': phases 4, 5, 7, 12,
    15 and 26's kept prints, and phase 27a's operators and MDS rerun on 4
    virtual shards (:func:`virtual_reruns`)."""
    same = {}
    for chain in ("main", "setops", "ordered"):
        got = merge_prints([r["prints"][chain] for r in ranks])
        same.update(compare_prints(got, ref[chain], f"{tag} {chain}",
                                   ATOMIC_SUMS if chain == "main" else None))
    check_group_sums(ranks[0]["prints"]["main_sums"], oracle,
                     f"{tag} main path")
    want = virtual["collectives"]
    got = {}
    for r in ranks:
        for key, d in r["prints"]["collectives"].items():
            if "whole" in d:
                check(got.setdefault(key, d) == d, f"{tag} {key}: "
                      f"replicated, the same on every rank")
            else:
                got.setdefault(key, {}).update(d)
    for key, w in want.items():
        check(got[key] == w, f"{tag} {key}: bit for bit against 4 virtual "
              f"shards")
    want, want_delta = dict(virtual["mds"]), virtual["mds_delta"]
    got = merge_prints([r["prints"]["mds"] for r in ranks])
    for r in ranks:
        check(r["prints"]["mds_delta"] == want_delta,
              f"{tag} mds rank {r['rank']}: δ bit for bit")
    path, x = got.pop("path"), got.pop("x")
    wpath, wx = want.pop("path"), want.pop("x")
    compare_prints(got, want, f"{tag} mds")
    same["mds_path"] = float(np.mean(bits_np(path) == bits_np(wpath)))
    same["mds_x"] = float(np.mean(bits_np(x) == bits_np(wx)))
    dpath = float(np.abs(path - wpath).max() / wpath[0])
    check(dpath <= MDS_LIMITS["paths_1v4"],
          f"{tag} mds: stress path against 4 virtual shards {dpath}")
    same["mds_path_max_rel"] = dpath

    # the storage legs against phases 12, 15 and 26
    st = ref["storage"]
    files = {}
    for r in ranks:
        files.update(r["storage"]["files"])
    check(files == st["files"], f"{tag}: the ranks' partitioned files are "
          f"phase 12's, byte for byte")
    got = merge_prints([r["prints"]["reentry"] for r in ranks])
    same.update({f"reentry.{k}": v for k, v in compare_prints(
        got, st["reentry"], f"{tag} re-entry", ATOMIC_SUMS).items()})
    check_groupby_g(ranks[0]["prints"]["reentry_g"], oracle,
                    f"{tag} re-entry")
    for key in ("reentry_k_groups", "tset_k_groups"):
        held = sum(r["storage"][key][0] for r in ranks)
        check(held == ranks[0]["storage"][key][1], f"{tag} {key}: the "
              f"ranks hold {held} groups, one for each present key")
    for name in GROUP_TSET:
        got = merge_prints([r["prints"][f"tset_{name}"] for r in ranks])
        atomic = {"t": ATOMIC_SUMS["g"] if name == "join_groupby"
                  else ("v_sum", "v_mean")}
        same.update({f"tset_{name}.{k}": v for k, v in compare_prints(
            got, ref["tset"]["prints"][name], f"{tag} TSet {name}",
            atomic).items()})
    check_groupby_g(ranks[0]["prints"]["tset_join_groupby_rows"], oracle,
                    f"{tag} TSet join_groupby")
    for r in ranks:
        check(r["storage"]["stream"] == ref["corpus"]["stream_digest"],
              f"{tag} rank {r['rank']}: the disk corpus's curated stream "
              f"is phase 26's, bit for bit")
    return same


def storage_line(ranks: list, ref: dict) -> dict:
    """A leg's storage figures beside phases 12, 15 and 26's."""
    st = [r["storage"] for r in ranks]
    slowest = max(s["write_s"] for s in st)
    return {
        "write_s": [s["write_s"] for s in st],
        "write_gb_s": sum(s["write_bytes"] for s in st) / slowest / 1e9,
        "write_gb_s_rank": [s["write_bytes"] / s["write_s"] / 1e9
                            for s in st],
        "phase12_write_s": ref["storage"]["write_s"],
        "reentry_read_s": [s["read_s"] for s in st],
        "phase12_read_s": ref["storage"]["read_s"],
        "reentry_join_groupbys_s": [s["reentry_s"] for s in st],
        "tset_s": {n: [s[f"tset_{n}_s"] for s in st] for n in GROUP_TSET},
        "phase15_s": ref["tset"]["seconds"],
        "corpus_write_s": [s["corpus_write_s"] for s in st],
        "corpus_prepare_s": [s["corpus_s"] for s in st],
        "phase26_preprocess_s": ref["corpus"]["preprocess_s"]}


# ---------------------------------------------------------------------------
# phase 29's services legs: spill, the lazy planner, stage checkpoints and
# the workflow engine on the group
# ---------------------------------------------------------------------------
#: phase 13's spill legs on the group at phase 13's sizes; the
#: kill-and-resume chain reads the cut left frame
GROUP_SPILL = SPILL_SIZES
#: the same legs at phase 3's sizes (``scripts/group_services.py``)
FULL_SPILL = {"left": LEFT_ROWS, "right": RIGHT_ROWS, "events": EVENTS,
              "budget": BUDGET_ROWS}
#: every services leg; leg A (one NCCL rank) runs the first two
SERVICES = ("spill_join", "planned", "spill_groupby", "spill_window",
            "workflow")
#: the kernels each leg must launch on every rank
SERVICE_KERNELS = {
    "spill_join": ("probe",),
    "spill_groupby": ("segment_reduce_fused", "segment_reduce"),
    "spill_window": ("windowed_scan",),
    "planned": ("hash_partition", "probe", "segment_reduce_fused",
                "segment_reduce", "windowed_scan")}
#: float lanes the segment kernels' atomics add up: held against float64
#: oracles on each rank's own shards, the rest bit for bit
SERVICE_ATOMIC = {"spill_groupby": {"g": ("v_sum",)},
                  "planned": {"p": ("v_sum", "v_sum_sum")}}
#: phase 17's workflow: each task and its dependencies
WORKFLOW_DAG = (("scan", ()), ("join_groupby", ("scan",)),
                ("check", ("join_groupby",)))


def spill_services(DataFrame, ctx, seed: int, sizes: dict, legs, launches,
                   root: str, prints: dict) -> dict:
    """Phase 13's spilled join → groupby and window at ``sizes`` on
    ``ctx`` (every workdir under ``root``): fills ``prints`` with each
    result's shard prints and returns each leg's fields; the groupby's
    groups are checked on this process's shards against float64
    oracles."""
    left, right, _ = make_data(seed, sizes["left"], sizes["right"])
    budget, first, out = sizes["budget"], ctx.local_shards.start, {}
    ldf = DataFrame.from_dict(left, ctx, bucket_factor=2.0)
    rdf = DataFrame.from_dict(right, ctx, bucket_factor=2.0)
    wd = os.path.join(root, "spill_join")
    js, *_, out["spill_join"] = spill_leg(
        "spill_join", lambda: ldf.join(rdf, ["k"], spill=True,
                                       budget_rows=budget, spill_workdir=wd),
        launches, wd, ctx, tap=False)
    del ldf, rdf
    prints["spill_join"] = shard_prints({"j": js}, first, valid_only=True)
    if "spill_groupby" in legs:
        wd = os.path.join(root, "spill_groupby")
        g, *_, out["spill_groupby"] = spill_leg(
            "spill_groupby", lambda: js.groupby(
                ["k"], SPILL_G_AGGS, spill=True, budget_rows=budget,
                spill_workdir=wd), launches, wd, ctx, tap=False)
        prints["spill_groupby"] = shard_prints({"g": g}, first,
                                               valid_only=True)
        out["spill_groupby"]["groups"] = check_local_groups(
            g.table, left["k"], left["v"], np.ones(left["k"].shape, bool),
            ("v_sum", "v_count", "v_min", "v_max"), ctx.device,
            f"rank {ctx.rank} spill groupby", n_keys=sizes["right"])
        del g
    del js
    if "spill_window" in legs:
        edf = DataFrame.from_dict(make_events(seed, sizes["events"]), ctx,
                                  bucket_factor=2.0)
        wd = os.path.join(root, "spill_window")
        w, *_, out["spill_window"] = spill_leg(
            "spill_window", lambda: edf.window(["g"], ["t"]).agg(
                W_AGGS, rows=ROLL, spill=True, budget_rows=budget,
                spill_workdir=wd), launches, wd, ctx, tap=False)
        del edf
        prints["spill_window"] = shard_prints({"w": w}, first,
                                              valid_only=True)
        del w
    return out


def planned_service(DataFrame, ctx, lroot: str, left, right, launches,
                    prints: dict) -> dict:
    """Phase 14's planned chain over the dataset under ``lroot`` (the left
    frame partitioned on ``k``): its explain text, exchanges (predicted ==
    counted), launches, seconds and the result's shard prints; with
    ``left``, its groups checked on this process's shards."""
    from repro_torch.io import pred
    from repro_torch.plan import LazyFrame

    rdf = DataFrame.from_dict(right, ctx, bucket_factor=2.0)
    lf = planned_chain_lazy(LazyFrame, pred, ctx, lroot, rdf)
    text = lf.explain()
    predicted = lf.physical_plan().predicted_collectives
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    p = lf.collect()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, ex = launches.read()
    check(ex == predicted, f"rank {ctx.rank} planned: {ex} exchanges, "
          f"predicted {predicted}")
    check(p.overflow_report.is_exact(), f"rank {ctx.rank} planned: exact")
    prints["planned"] = shard_prints({"p": p}, ctx.local_shards.start,
                                     valid_only=True)
    out = dict(seconds=seconds, exchanges=ex, predicted=predicted,
               launches=counts, explain=text,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if left is not None:
        out["groups"] = check_local_groups(
            p.table, left["k"], left["v"], left["v"] > 0,
            ("v_sum", "v_count", "v_min"), ctx.device,
            f"rank {ctx.rank} planned")
    return out


def workflow_service(DataFrame, ctx, lroot: str, right, root: str) -> dict:
    """Phase 17's 3-task workflow on the group over ``lroot``, a transient
    scan fault armed on the last rank only; then a resume from its
    journal and a changed DAG against it.  Returns the calls, retries,
    the journal, and the groupby's rows (rank 0)."""
    from repro_torch import telemetry
    from repro_torch.resilience import FaultPolicy, arm, fires, reset
    from repro_torch.workflow import Task, WorkflowEngine, WorkflowError

    calls = dict.fromkeys([name for name, _ in WORKFLOW_DAG], 0)
    rdf = DataFrame.from_dict(right, ctx, bucket_factor=2.0)

    def scan():
        calls["scan"] += 1
        return DataFrame.read_dataset(lroot, ctx, bucket_factor=2.0)

    def join_groupby(scan):
        calls["join_groupby"] += 1
        return scan.join(rdf, ["k"]).groupby(["g"], G_AGGS,
                                             out_capacity=G_OUT_CAP)

    def verify(join_groupby):
        calls["check"] += 1
        return whole_rows(join_groupby)

    fns = {"scan": scan, "join_groupby": join_groupby, "check": verify}
    journal = os.path.join(root, "journal.json")
    out = {}
    reset()
    if ctx.rank == ctx.world - 1:
        arm("scan.read", "io_error")   # the first fragment read fails once
    with telemetry.trace("workflow") as rec:
        t0 = time.perf_counter()
        got = workflow_engine(WorkflowEngine, Task, FaultPolicy, journal,
                              fns).run()
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
    out.update(calls=dict(calls), fired=fires("scan.read"),
               retries=rec.metrics.counters.get("retry.workflow.scan", 0))
    reset()
    with open(journal) as f:
        out["journal"] = f.read()
    with telemetry.trace("workflow-resume") as rec:
        workflow_engine(WorkflowEngine, Task, FaultPolicy, journal,
                        fns).run()
    out.update(resumed_calls=dict(calls),
               replayed=rec.metrics.counters.get("workflow.replayed", 0))
    try:
        workflow_engine(WorkflowEngine, Task, FaultPolicy, journal, fns,
                        changed=True).run()
        out["stale"] = "ran"
    except WorkflowError as e:
        out["stale"] = "stale journal" in str(e)
    out["rows"] = got["check"] if ctx.rank == 0 else None
    return out


def workflow_engine(WorkflowEngine, Task, FaultPolicy, journal, fns,
                    changed: bool = False):
    """:data:`WORKFLOW_DAG` as an engine over ``journal`` (``changed``:
    the middle task loses its dependency, a different DAG)."""
    pol = FaultPolicy(max_retries=2, backoff_base=0.01)
    eng = WorkflowEngine(journal, policy=pol)
    for name, deps in WORKFLOW_DAG:
        eng.add(Task(name, fns[name], deps=() if changed and
                     name == "join_groupby" else deps))
    return eng


def group_services(ctx, seed: int, svc: dict, left, right, launches,
                   prints: dict) -> dict:
    """Phase 29's services legs on ``ctx``'s group (``svc``: the sizes,
    the legs, the dataset the storage leg wrote and a directory every
    rank sees): returns each leg's fields, its prints in ``prints``."""
    from repro_torch.dataframe import DataFrame

    legs, out = svc["legs"], {}
    t0 = time.perf_counter()
    out.update(spill_services(DataFrame, ctx, seed, svc["sizes"], legs,
                              launches, os.path.join(svc["root"], "spill"),
                              prints))
    out["planned"] = planned_service(DataFrame, ctx, svc["lroot"], left,
                                     right, launches, prints)
    if "workflow" in legs:
        out["workflow"] = workflow_service(DataFrame, ctx, svc["lroot"],
                                           right, svc["root"])
    out["seconds"] = time.perf_counter() - t0
    return out


def services_rank(ctx, seed: int, svc: dict) -> dict:
    """One rank of the services legs alone (``scripts/group_services.py``):
    :func:`group_services` over the dataset ``svc["lroot"]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    left, right, _ = make_data(seed)
    prints = {}
    services = group_services(ctx, seed, svc, left, right, Launches(),
                              prints)
    return {"rank": ctx.rank, "prints": prints, "services": services}


def group_crash(ctx, seed: int, sizes: dict, root: str, ckdir: str) -> None:
    """Phase 17's resume chain over the cut left frame under ``root`` on
    the group, stage checkpoints in ``ckdir``, every rank armed to die by
    SIGKILL at the second commit: returning at all is a failure."""
    from repro_torch.dataframe import DataFrame
    from repro_torch.io import pred
    from repro_torch.plan import LazyFrame
    from repro_torch.resilience import FaultPolicy, arm

    _, right, _ = make_data(seed, sizes["left"], sizes["right"])
    rdf = DataFrame.from_dict(right, ctx, bucket_factor=2.0)
    site, kind, nth = CRASH_FAULT.split(":")
    arm(site, kind, int(nth))
    resume_chain(LazyFrame, pred, ctx, root, rdf).collect(
        policy=FaultPolicy(checkpoint_dir=ckdir, keep_checkpoints=True))
    raise RuntimeError(f"rank {ctx.rank} outlived its armed crash")


def group_resume_rank(ctx, seed: int, sizes: dict, root: str,
                      ckdir: str) -> dict:
    """The crashed chain resumed from ``ckdir`` on the group: exchanges,
    stages restored, launches, seconds, peak GiB; the rows sorted by
    ``k`` on rank 0."""
    from repro_torch import telemetry
    from repro_torch.dataframe import DataFrame
    from repro_torch.io import pred
    from repro_torch.plan import LazyFrame
    from repro_torch.resilience import FaultPolicy

    t_start = time.perf_counter()
    _, right, _ = make_data(seed, sizes["left"], sizes["right"])
    rdf = DataFrame.from_dict(right, ctx, bucket_factor=2.0)
    launches, rec = Launches(), telemetry.Collector("resume")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    t0 = time.perf_counter()
    out = resume_chain(LazyFrame, pred, ctx, root, rdf).collect(
        policy=FaultPolicy(checkpoint_dir=ckdir, keep_checkpoints=True),
        telemetry=rec)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, ex = launches.read()
    rows = sort_rows_on_card(out.table, ["k"])
    return {"rank": ctx.rank, "exchanges": ex, "launches": counts,
            "restored": rec.metrics.counters.get(
                "recovery.stages_restored", 0),
            "resume_s": seconds, "rows": rows if ctx.rank == 0 else None,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_start}


def stage_files(ckdir: str, fp: str, stage: str) -> dict:
    """``{file: digest}`` of one stage's directory under ``ckdir/fp``."""
    return file_digests(os.path.join(ckdir, fp, stage))


def services_ref(ctx4, seed: int, sizes: dict, lroot: str, root: str,
                 right, launches) -> dict:
    """The services legs on 4 virtual shards: the prints, stats and
    counts every rank is held to; the cut left frame written under
    ``root`` for the kill-and-resume, its resume chain committed in full
    (the stage files, the rows), and :data:`WORKFLOW_DAG`'s journal."""
    from repro_torch.dataframe import DataFrame
    from repro_torch.io import pred
    from repro_torch.plan import LazyFrame, optimize
    from repro_torch.resilience import FaultPolicy, plan_fingerprint
    from repro_torch.workflow import Task, WorkflowEngine

    t0 = time.perf_counter()
    prints = {}
    fields = spill_services(DataFrame, ctx4, seed, sizes, SERVICES,
                            launches, os.path.join(root, "spill"), prints)
    fields["planned"] = planned_service(DataFrame, ctx4, lroot, None, right,
                                        launches, prints)
    # the kill-and-resume: the cut left frame, unpartitioned (phase 17's)
    left, right, _ = make_data(seed, sizes["left"], sizes["right"])
    resume_root = os.path.join(root, "resume_left")
    DataFrame.from_dict(left, ctx4).to_hpt(resume_root)
    rdf = DataFrame.from_dict(right, ctx4, bucket_factor=2.0)
    del left, right
    lf = resume_chain(LazyFrame, pred, ctx4, resume_root, rdf)
    plan = lf.physical_plan()
    stages = [s.index for s in plan.steps if s.stage]
    check(len(stages) == 2, f"resume chain stages {stages}")
    suffix = plan.predicted_collectives - sum(
        s.a2a for s in plan.steps if s.index <= stages[0])
    ckdir = os.path.join(root, "stages_ref")
    launches.reset()
    full = lf.collect(policy=FaultPolicy(checkpoint_dir=ckdir,
                                         keep_checkpoints=True))
    _, ex = launches.read()
    fp = plan_fingerprint(optimize(lf.logical_plan)[0], ctx4)
    journal = os.path.join(root, "journal_ref.json")
    noop = {name: (lambda **kw: None) for name, _ in WORKFLOW_DAG}
    workflow_engine(WorkflowEngine, Task, FaultPolicy, journal, noop).run()
    with open(journal) as f:
        journal_text = f.read()
    return {"prints": prints, "fields": fields, "resume_root": resume_root,
            "stages": stages, "suffix": suffix, "full_exchanges": ex,
            "fingerprint": fp,
            "stage_files": stage_files(ckdir, fp, f"stage_{stages[0]}"),
            "rows": sort_rows_on_card(full.table, ["k"]),
            "journal": journal_text, "seconds": time.perf_counter() - t0}


def crash_leg(backend: str, seed: int, sizes: dict, sref: dict,
              ckdir: str) -> float:
    """Phase 17's crash on its own spawn of 4 ranks
    (``scripts/group_services.py``; phase 29's leg B ranks end in it
    instead): checks they died by SIGKILL; returns the seconds."""
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    try:
        run_ranks(group_crash, GROUP_WORLD, backend, "cuda", n_shards=4,
                  args=(seed, sizes, sref["resume_root"], ckdir),
                  timeout_s=GROUP_TIMEOUT_S)
        died = "returned"
    except RuntimeError as e:
        died = str(e)
    check_killed(died)
    return time.perf_counter() - t0


def check_killed(died: str) -> None:
    check("died with exit code -9" in died, f"the crash ranks died by "
          f"SIGKILL: {died[-3000:]}")


def resume_leg(backend: str, seed: int, sizes: dict, sref: dict,
               ckdir: str) -> dict:
    """Phase 17's resume across ranks: 2 ranks of the same 4 shards resume
    what 4 ranks left in ``ckdir`` when they died at the second stage
    commit.  Checks the snapshot the kill left (the first stage, byte for
    byte the virtual run's), the resume's exchanges (the suffix's), its
    rows against the virtual run's and that no ``.tmp`` is left; returns
    its figures."""
    from repro_torch.launch.mesh import run_ranks

    args = (seed, sizes, sref["resume_root"], ckdir)
    first, second = sref["stages"]
    names = sorted(os.listdir(os.path.join(ckdir, sref["fingerprint"])))
    check(names == [f"stage_{first}", f"stage_{second}.tmp"],
          f"after the kill: {names}")
    got = stage_files(ckdir, sref["fingerprint"], f"stage_{first}")
    check(got == sref["stage_files"], "the 4 ranks' committed stage is the "
          "virtual run's, byte for byte")
    t0 = time.perf_counter()
    ranks = run_ranks(group_resume_rank, 2, backend, "cuda", n_shards=4,
                      args=args, timeout_s=GROUP_TIMEOUT_S)
    resume_s = time.perf_counter() - t0
    for r in ranks:
        check(r["exchanges"] == sref["suffix"] == 1 and r["restored"] == 1,
              f"resume rank {r['rank']}: {r['exchanges']} exchanges (the "
              f"suffix {sref['suffix']}), {r['restored']} stages restored")
    rows, ref = ranks[0]["rows"], sref["rows"]
    check(sorted(rows) == sorted(ref), f"resumed columns {sorted(rows)}")
    for k in ref:
        if k in ("v_sum", "v_sum_sum"):     # float atomics; v > 0
            check_close(rows[k], ref[k].astype(np.float64),
                        np.abs(ref[k]).astype(np.float64), f"resumed {k}")
        else:
            check(np.array_equal(bits_np(rows[k]), bits_np(ref[k])),
                  f"resumed {k} bit for bit")
    names = sorted(os.listdir(os.path.join(ckdir, sref["fingerprint"])))
    check(names == [f"stage_{first}", f"stage_{second}"],
          f"after the resume: {names}")
    return {"resume_spawn_s": resume_s,
            "resume_s": [r["resume_s"] for r in ranks],
            "rank_seconds": [r["seconds"] for r in ranks],
            "exchanges": [r["exchanges"] for r in ranks],
            "launches": [r["launches"] for r in ranks],
            "peak_gib": [r["peak_gib"] for r in ranks],
            "stage_bytes": dir_bytes(os.path.join(
                ckdir, sref["fingerprint"], f"stage_{first}"))}


def check_services(tag: str, ranks: list, sref: dict, oracle) -> dict:
    """Hold a leg's services against the virtual run (:func:`services_ref`):
    prints bit for bit (atomic sums reported, and checked on each rank's
    shards), ``SpillStats``, exchanges, sorts, launches, the explain text,
    the groups held, the workflow's calls, retries and journal; returns
    the leg's ``group_services`` line."""
    want, same = sref["fields"], {}
    svc = [r["services"] for r in ranks]
    for area, wp in sref["prints"].items():
        if area not in ranks[0]["prints"]:
            continue
        got = merge_prints([r["prints"][area] for r in ranks])
        same.update({f"{area}.{k}": v for k, v in compare_prints(
            got, wp, f"{tag} {area}", SERVICE_ATOMIC.get(area)).items()})
    line = {"leg": tag, "same_atomic_bits": same,
            "rank_seconds": [s["seconds"] for s in svc]}
    for leg, kernels in SERVICE_KERNELS.items():
        if leg not in svc[0]:
            continue
        w = want[leg]
        for r, s in zip(ranks, svc):
            f = s[leg]
            what = f"{tag} rank {r['rank']} {leg}"
            check(f["exchanges"] == w["exchanges"],
                  f"{what}: {f['exchanges']} exchanges, the virtual run "
                  f"made {w['exchanges']}")
            if leg != "planned":
                check(f["stats"] == w["stats"], f"{what}: SpillStats "
                      f"{f['stats']} / {w['stats']}")
                check(f["exchanges"] == 0, f"{what}: no exchange")
            if leg == "spill_window":
                check(f["sorts"] == 0, f"{what}: {f['sorts']} sorts")
            for k in kernels:
                check(f["launches"][k] > 0, f"{what}: launched {k}")
        if leg == "planned":
            for s in svc:
                check(s[leg]["explain"] == w["explain"],
                      f"{tag} planned: explain() is the virtual run's")
        if "groups" in svc[0][leg]:
            held = sum(s[leg]["groups"][0] for s in svc)
            check(held == svc[0][leg]["groups"][1], f"{tag} {leg}: the "
                  f"ranks hold {held} groups, one for each present key")
        line[leg] = {
            "seconds": [s[leg]["seconds"] for s in svc],
            "virtual_s": w["seconds"],
            "peak_gib": [s[leg]["peak_gib"] for s in svc],
            "exchanges": svc[0][leg]["exchanges"],
            "launches": [s[leg]["launches"] for s in svc]}
        if leg != "planned":
            line[leg].update(
                stats=svc[0][leg]["stats"],
                write_bytes=[s[leg]["write_bytes"] for s in svc],
                write_gb_s=[s[leg]["write_gb_s"] for s in svc],
                read_bytes=[s[leg]["read_bytes"] for s in svc],
                read_gb_s=[s[leg]["read_gb_s"] for s in svc])
    if "workflow" in svc[0]:
        wf = [s["workflow"] for s in svc]
        calls = {"scan": 2, "join_groupby": 1, "check": 1}
        for r, w in zip(ranks, wf):
            what = f"{tag} rank {r['rank']} workflow"
            check(w["calls"] == calls == w["resumed_calls"]
                  and w["retries"] == 1 and w["replayed"] == 3,
                  f"{what}: calls {w['calls']} / {w['resumed_calls']}, "
                  f"retries {w['retries']}, replayed {w['replayed']}")
            check(w["journal"] == sref["journal"],
                  f"{what}: the journal is the virtual run's")
            check(w["stale"] is True, f"{what}: a changed DAG is refused")
        check([w["fired"] for w in wf] == [0] * (len(wf) - 1) + [1],
              f"{tag} workflow: the fault fired on the last rank alone")
        check_groupby_g(wf[0]["rows"], oracle, f"{tag} workflow")
        line["workflow"] = {"seconds": [w["seconds"] for w in wf]}
    return line


def group_phase(ref, oracle, dev, seed: int, launches,
                sizes: dict = GROUP_SPILL) -> list:
    """Phase 29: leg A on a 1-rank NCCL group in this process, leg B on
    4 ranks (NCCL with a card a rank where 4 exist, else gloo, every rank
    on card 0), each with the services legs (leg A: the spilled join and
    the planned chain; spill at ``sizes``), held against one virtual run
    of them made after leg A; leg B's ranks then die mid-commit and 2
    new ranks resume; returns the legs' ``group`` lines.  ``ref["right"]``
    is phase 3's right frame."""
    import torch.distributed as dist

    from repro_torch.core import HPTMTContext
    from repro_torch.launch.mesh import run_ranks

    want_ex = dict(ref["exchanges"], mds=1, write=1,
                   reentry=ref["storage"]["exchanges"],
                   corpus=ref["corpus"]["exchanges"],
                   **{f"tset_{n}": ref["tset"]["exchanges"][n]
                      for n in GROUP_TSET})
    n_cards = torch.cuda.device_count()
    lines, virtual, sref = [], None, None
    svc_tmp = tempfile.TemporaryDirectory(prefix="hptmt_services_")
    for tag, backend, world in (
            ("A", "nccl", 1),
            ("B", "nccl" if n_cards >= GROUP_WORLD else "gloo",
             GROUP_WORLD)):
        svc = {"sizes": sizes, "legs": SERVICES[:2] if world == 1
               else SERVICES}
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="hptmt_group_") as tmp:
            store = os.path.join(tmp, "data")
            if world == 1:
                dist.init_process_group(
                    backend, rank=0, world_size=1,
                    store=dist.FileStore(os.path.join(tmp, "store"), 1),
                    timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
                try:
                    ranks = [group_rank(HPTMTContext(
                        n_shards=4, device="cuda:0", group=dist.group.WORLD),
                        seed, want_ex, store, svc)]
                finally:
                    dist.destroy_process_group()
            else:
                # the ranks end in phase 17's crash: their results come
                # back in files, and the run fails with their SIGKILL
                ckdir = os.path.join(tmp, "stages")
                crash = {"root": sref["resume_root"], "ckdir": ckdir,
                         "results": os.path.join(tmp, "rank{rank}.pkl")}
                try:
                    run_ranks(group_rank, world, backend, "cuda",
                              n_shards=4,
                              args=(seed, want_ex, store,
                                    dict(svc, crash=crash)),
                              timeout_s=GROUP_TIMEOUT_S)
                    died = "returned"
                except RuntimeError as e:
                    died = str(e)
                killed = time.time()
                check_killed(died)
                ranks = []
                for r in range(world):
                    with open(crash["results"].format(rank=r), "rb") as f:
                        ranks.append(pickle.load(f))
            leg_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            if sref is None:    # over the dataset this leg's ranks wrote
                sref = services_ref(HPTMTContext(n_shards=4, device="cuda"),
                                    seed, sizes, os.path.join(store, "left"),
                                    svc_tmp.name, ref["right"], launches)
                torch.cuda.empty_cache()
            resume = None
            if world > 1:
                resume = dict(resume_leg(backend, seed, sizes, sref, ckdir),
                              crash_s=killed - max(r["crash_started"]
                                                   for r in ranks))
                for counts in resume["launches"]:
                    for k, n in counts.items():
                        launches.total[k] += n
        if virtual is None:
            virtual = virtual_reruns(dev, seed)
        same = check_group_leg(f"group leg {tag}", ranks, ref, oracle,
                               virtual)
        for r in ranks:
            for k in ("hash_partition", "probe", "segment_reduce_fused",
                      "segment_reduce", "windowed_scan"):
                check(r["launches"][k] > 0,
                      f"leg {tag} rank {r['rank']} launched {k}")
            for k, n in r["launches"].items():
                launches.total[k] += n
        lines.append({
            "leg": tag, "backend": backend, "world": world,
            "cards": min(world, n_cards), "n_shards": 4,
            "median_s": ranks[0]["median_s"], "runs_s": ranks[0]["runs_s"],
            "rank_median_s": [r["median_s"] for r in ranks],
            "exchanges": ranks[0]["exchanges"],
            "launches": [r["launches"] for r in ranks],
            "a2a_ms": [r["a2a_ms"] for r in ranks],
            "a2a_bytes": ranks[0]["a2a_bytes"],
            "peak_gib": [r["peak_gib"] for r in ranks],
            "rank_seconds": [r["seconds"] for r in ranks],
            "rank_marks": ranks[0]["marks"],
            "storage": storage_line(ranks, ref),
            "services": check_services(f"group leg {tag}", ranks, sref,
                                       oracle),
            "services_virtual_s": sref["seconds"], "resume": resume,
            "seconds": leg_s,
            "check_seconds": time.perf_counter() - t0 - leg_s,
            "atomic_sums_bit_equal": same})
        torch.cuda.empty_cache()
    svc_tmp.cleanup()
    return lines


# ---------------------------------------------------------------------------
# phase 30: training across ranks — the launcher's mesh path
# ---------------------------------------------------------------------------
MESH_WORLD = 4
MESH_DIMS, MESH_NAMES = (2, 2), ("data", "model")
MESH_TIMEOUT_S = 900
#: (a) smollm-360m at published widths (bf16 compute) on phase 26's
#: corpus (2^13 documents; 2^15 in the script), 1 checked
#: step and 1 timed, then its elastic checkpoint (2x2 → 2x1); cut to 4 of
#: its 32 layers here for the time limit (~1.0 GB of state), whole in
#: ``scripts/mesh_train.py`` (4.34 GB); (b)
#: qwen2-moe-a2.7b at published widths, 2 of its 24 layers (~1.8 B
#: parameters: ~29 GB of float32 masters and Adam state over the ranks),
#: one checked step on the pipeline's default corpus, in float32 compute:
#: in bf16 a random MoE's routing flips on rounding and swamps the check
#: (my first chip calls: 0.84 of a leaf's largest element, where the
#: float32 CPU parity holds to 1e-6)
MESH_TRAIN = {
    "smollm": {"arch": "smollm-360m", "layers": 4, "batch": 8,
               "seq": 1024, "timed": 1, "dtype": None,
               "corpus": {"n_docs": 1 << 13, "mean_doc_len": 512},
               "checkpoint": True},
    "qwen2_moe": {"arch": "qwen2-moe-a2.7b", "layers": 2, "batch": 2,
                  "seq": 1024, "timed": 0, "dtype": "float32",
                  "corpus": {}, "checkpoint": False},
}
#: (a): the gradients and their norm within ``BF16_VS_F32`` (about 3x
#: phase 25's bf16-vs-float32 readings); the loss in float32 compute
#: (a forward of the same blocks) to float32 reordering, and the bf16
#: losses within 3x the larger of the two steps' own bf16-vs-float32 gaps
MESH_LOSS_F32_REL = 1e-6
#: (a)'s checkpoint leg: the 2x2 state restored on this mesh of ranks
RESTORE_DIMS = (2, 1)
#: (b), float32 compute, against the one-card step with micro-batches =
#: the data axis (the EP metrics' semantics: each shard's own, meaned);
#: the leaf gap leaves room for one routing near-tie rounded the other way
MOE_MESH_LIMITS = {"leaf_rel_l2": 1e-2, "norm_rel": 1e-4, "loss_rel": 1e-5}


def mesh_cfg(conf):
    from repro_torch.configs import get_config

    cfg = get_config(conf["arch"])
    if conf["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=conf["layers"])
    if conf["dtype"]:
        cfg = dataclasses.replace(cfg, dtype=conf["dtype"])
    return cfg


def mesh_corpus(cfg, conf):
    from repro_torch.data import pipeline as TP

    return TP.CorpusConfig(vocab_size=cfg.vocab_size, **conf["corpus"])


def one_card_grads(cfg, tcfg, batch, seed: int, dev):
    """Phase 25's step function on the one-card state drawn from ``seed``
    (the sharded init's draws) → (float32 gradients averaged over the
    micro-batches, loss, the same loss with float32 compute: this
    batch's bf16-vs-float32 reading)."""
    from repro_torch.train import train_step as TS

    state = TS.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    m = tcfg.micro_batches
    micros = [{k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
               for k, v in batch.items()} for i in range(m)]
    model = TS.bind(TS.skeleton(cfg), state.params)
    grads, loss = None, 0.0
    for micro in micros:
        g, met = TS.compute_grads(model, cfg, tcfg, micro, state.params)
        if grads is None:
            grads = g
        else:
            for k in grads:
                grads[k] += g[k]
        loss += float(met["loss"]) / m
        del g
    loss32 = loss
    if cfg.dtype != "float32":
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model = TS.bind(TS.skeleton(cfg32), state.params)
        loss32 = 0.0
        with torch.no_grad():
            for micro in micros:
                loss32 += float(TS.loss_fn(model, cfg32, tcfg,
                                           micro)[1]["loss"]) / m
    del state, model
    for g in grads.values():
        g /= m
    return grads, loss, loss32


def leaf_gap(block: torch.Tensor, full, spec, mesh) -> tuple:
    """A sharded leaf against rank 0's whole reference ``full`` →
    ``(|d| / |ref|`` in 2-norm, ``max|d| / max|ref|)`` on every rank.
    Rank 0 sends each rank the reference block it holds (one uneven
    ``all_to_all_single``: a quarter of an all-gather's bytes); each rank
    sums its own block's squares, counted once where the leaf is
    replicated, and the small sums are all-gathered."""
    import torch.distributed as dist

    from repro_torch.core import array_ops
    from repro_torch.sharding import partition
    from repro_torch.sharding.axes import GroupMesh

    world, rank = dist.get_world_size(), dist.get_rank()
    names, dims = list(mesh), [mesh[a] for a in mesh]
    nbytes = block.numel() * block.element_size()
    send = torch.empty(0, dtype=torch.uint8, device=block.device)
    if full is not None:
        blocks = []
        for r in range(world):
            at = GroupMesh(mesh.sizes, {}, dict(zip(names, (
                int(c) for c in np.unravel_index(r, dims)))))
            blocks.append(partition.shard_tensor(full, spec, at)
                          .contiguous().reshape(-1).view(torch.uint8))
        send = torch.cat(blocks)
    recv = torch.empty(nbytes, dtype=torch.uint8, device=block.device)
    dist.all_to_all_single(recv, send, [nbytes] + [0] * (world - 1),
                           [nbytes if full is not None else 0] * world)
    ref = recv.view(block.dtype).reshape(block.shape)
    d = (block - ref).float()
    owner = all(mesh.coords[a] == 0 for a in names
                if a not in partition.sharded_axes(spec))
    mine = torch.stack([d.square().sum() * owner,
                        ref.float().square().sum() * owner,
                        d.abs().max(), ref.abs().max().float()])
    every = array_ops.spmd_allgather([mine], tiled=False,
                                     group=dist.group.WORLD)[0]
    sums, maxes = every[:, :2].sum(0), every[:, 2:].amax(0)
    return (float(sums[0].sqrt() / sums[1].sqrt().clamp_min(1e-30)),
            float(maxes[0] / maxes[1].clamp_min(1e-30)))


def flat_tree(tree, prefix: str = "") -> dict:
    """A checkpoint tree of dicts by the manager's leaf names (path parts
    joined by ``__``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}__{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def restore_meshes() -> list:
    """Each rank's :data:`RESTORE_DIMS` mesh coordinates, as meshes of
    sizes alone (enough to cut a block)."""
    from repro_torch.sharding.axes import GroupMesh

    n = int(np.prod(RESTORE_DIMS))
    return [GroupMesh(dict(zip(MESH_NAMES, RESTORE_DIMS)), {},
                      {a: int(c) for a, c in
                       zip(MESH_NAMES, np.unravel_index(r, RESTORE_DIMS))})
            for r in range(n)]


def f32_step_loss(cfg, tcfg, mesh, state, batch) -> float:
    """One sharded step of this rank's ``state`` in float32 compute on
    the global ``batch`` → its loss (the state is updated in place)."""
    from repro_torch.sharding import axes as am
    from repro_torch.train import train_step as TS

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with am.logical_binding(mesh):
        step, _, _ = TS.make_sharded_train_step(cfg32, tcfg, mesh,
                                                TS.meta_state(cfg32))
        _, m = step(state, TS.local_batch(batch, mesh))
    return float(m["loss"])


def f32_loss(cfg, tcfg, mesh, specs, params, batch) -> float:
    """The loss that :func:`f32_step_loss` reports, by the step's forward
    alone (no backward, no update: a third of the step's collectives)."""
    from repro_torch.sharding import axes as am
    from repro_torch.train import train_step as TS

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with am.logical_binding(mesh), torch.no_grad():
        return float(TS.sharded_loss_fn(
            TS.bind(TS.sharded_model(cfg32, specs), params), cfg32, tcfg,
            TS.local_batch(batch, mesh), mesh)[1]["loss"])


def mesh_checkpoint_save(ctx, run, cfg, tcfg, state, ckdir: str) -> dict:
    """Phase 30 (a)'s save: this rank's ``TrainState`` blocks through
    ``CheckpointManager.save(..., shardings=)``; then the digest of every
    :data:`RESTORE_DIMS` rank's block of each leaf, cut from the leaf
    gathered anew (leaf ``i`` hashed by rank ``i % world``), and the
    float32-compute loss of the next step on the next global batch (kept
    beside the checkpoint for the restore leg)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import state_tree

    mesh, specs = run.mesh, run.specs
    tree = state_tree(state)
    sspecs = state_tree(TS.TrainState(specs, TS.OptState(specs, specs, ())))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CheckpointManager(ckdir).save(1, tree, shardings=(sspecs, mesh))
    save_s = time.perf_counter() - t0
    flat, fspecs = flat_tree(tree), flat_tree(sspecs)
    targets = restore_meshes()
    want = [{} for _ in targets]
    for i, (name, leaf) in enumerate(flat.items()):
        whole = partition.gather_tensor(leaf, fspecs[name], mesh)
        if i % ctx.world == ctx.rank:
            for j, m in enumerate(targets):
                want[j][name] = digest(partition.shard_tensor(
                    whole, fspecs[name], m))
        del whole
    batch = next(run.data)
    if ctx.rank == 0:
        np.savez(os.path.join(ckdir, "batch.npz"),
                 **{k: v.cpu().numpy() for k, v in batch.items()})
    t0 = time.perf_counter()
    loss = f32_loss(cfg, tcfg, mesh, specs, state.params, batch)
    return {"save_s": save_s, "f32_loss_s": time.perf_counter() - t0,
            "bytes": (dir_bytes(os.path.join(ckdir, "step_1"))
                      if ctx.rank == 0 else None),
            "want": want, "loss_f32": loss}


def mesh_restore_rank(ctx, ckdir: str, conf: dict) -> dict:
    """One rank of phase 30 (a)'s restore leg on :data:`RESTORE_DIMS`:
    the 2x2 checkpoint restored into this rank's blocks, each hashed, and
    the float32-compute step on the kept global batch."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.sharding import axes as am
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.trainer import state_tree, tree_state

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = ctx.device
    cfg = mesh_cfg(conf)
    tcfg = TS.TrainConfig(optimizer=OptimizerConfig(warmup_steps=2,
                                                    total_steps=100))
    mesh = mesh_context(RESTORE_DIMS, MESH_NAMES)
    with am.logical_binding(mesh):
        _, sspec, _ = TS.make_sharded_train_step(cfg, tcfg, mesh,
                                                 TS.meta_state(cfg))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = CheckpointManager(ckdir).restore(
        state_tree(TS.meta_state(cfg)), shardings=(state_tree(sspec), mesh),
        device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = {k: digest(v) for k, v in flat_tree(tree).items()}
    nbytes = sum(v.numel() * v.element_size()
                 for v in flat_tree(tree).values())
    with np.load(os.path.join(ckdir, "batch.npz")) as f:
        batch = {k: torch.from_numpy(f[k]).to(dev) for k in f.files}
    state = TS.place_state(tree_state(tree), dev)
    del tree
    t0 = time.perf_counter()
    loss = f32_step_loss(cfg, tcfg, mesh, state, batch)
    return {"rank": ctx.rank, "coords": dict(mesh.coords), "got": got,
            "restore_s": restore_s, "block_bytes": nbytes,
            "f32_step_s": time.perf_counter() - t0, "loss_f32": loss,
            "seconds": time.perf_counter() - t_start}


def mesh_train_rank(ctx, seed: int, name: str, conf: dict,
                    ckdir: str = None) -> dict:
    """One rank of phase 30: the launcher's mesh set-up
    (``launch.train.mesh_setup``), a checked first step against the
    one-card step (on rank 0), then timed steps and one step with the
    model collectives timed."""
    from repro_torch.core import array_ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.sharding import axes as am
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptimizerConfig, global_norm

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = ctx.device
    cfg = mesh_cfg(conf)
    tcfg = TS.TrainConfig(optimizer=OptimizerConfig(warmup_steps=2,
                                                    total_steps=100))
    torch.cuda.reset_peak_memory_stats()
    launches = Launches()
    launches.reset()
    t0 = time.perf_counter()
    run = tlaunch.mesh_setup(cfg, tcfg, mesh_corpus(cfg, conf), MESH_DIMS,
                             MESH_NAMES, conf["batch"], conf["seq"], dev,
                             seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prep, exchanges = launches.read()
    launches.reset()
    mesh, specs = run.mesh, run.specs
    split = {k: partition.sharded_axes(v) for k, v in specs.items()}
    batch = next(run.data)
    local = TS.local_batch(batch, mesh)
    rank0 = ctx.rank == 0

    # the checked first step: its gradients against the one-card step's
    ref = None
    if rank0:
        ref_tcfg = tcfg
        if cfg.is_moe:     # the EP metrics: each data shard's own, meaned
            ref_tcfg = dataclasses.replace(tcfg, micro_batches=mesh["data"])
        ref = one_card_grads(cfg, ref_tcfg, batch, seed, dev)
        ref_norm = float(global_norm(ref[0].values()))
        ref_loss, ref_loss32 = ref[1], ref[2]
        torch.cuda.empty_cache()
    with am.logical_binding(mesh):
        model = TS.sharded_model(cfg, specs)
        # the checked step's collectives are the ones timed (each
        # synchronized); the timed steps below run untimed collectives
        array_ops.MODEL_COLLECTIVES.reset()
        array_ops.MODEL_COLLECTIVES.timed = True
        t0 = time.perf_counter()
        try:
            grads, metrics = TS.compute_sharded_grads(
                model, cfg, tcfg, local, run.state.params, mesh, specs)
        finally:
            array_ops.MODEL_COLLECTIVES.timed = False
        torch.cuda.synchronize()
        grads_s = time.perf_counter() - t0
        step_counts = dict(array_ops.MODEL_COLLECTIVES.counts)
        coll_s = dict(array_ops.MODEL_COLLECTIVES.seconds)
        names = list(grads)
        gnorm = float(global_norm([grads[k] for k in names],
                                  [split[k] for k in names], mesh))
        l2, of_max = {}, {}
        for k in names:
            l2[k], of_max[k] = leaf_gap(
                grads[k], ref[0].pop(k) if rank0 else None, specs[k], mesh)
        loss32 = None
        if cfg.dtype != "float32":
            # the same blocks and rows, float32 compute: the function
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            with torch.no_grad():
                loss32 = float(TS.sharded_loss_fn(
                    TS.bind(TS.sharded_model(cfg32, specs),
                            run.state.params), cfg32, tcfg, local,
                    mesh)[1]["loss"])
        state = TS.TrainState(*TS.adamw_update(
            tcfg.optimizer, run.state.params, grads, run.state.opt,
            split, mesh)[:2])
    del grads, ref
    loss = float(metrics["loss"])
    check(np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0,
          f"rank {ctx.rank}: finite loss {loss} and grad norm {gnorm}")
    agree = None
    if rank0:
        worst = max(l2, key=l2.get)
        agree = {"leaf_rel_l2": l2[worst], "leaf_rel_l2_at": worst,
                 "leaf_of_max": max(of_max.values()),
                 "leaf_of_max_at": max(of_max, key=of_max.get),
                 "norm_rel": abs(gnorm - ref_norm) / ref_norm,
                 "loss_rel": abs(loss - ref_loss) / abs(ref_loss),
                 "loss": loss, "loss_one_card": ref_loss,
                 "loss_one_card_f32": ref_loss32}
        if loss32 is not None:
            agree.update(
                loss_f32=loss32,
                loss_f32_rel=abs(loss32 - ref_loss32) / abs(ref_loss32),
                bf16_loss_gap=3 * max(abs(loss - loss32) / abs(loss32),
                                      abs(ref_loss - ref_loss32)
                                      / abs(ref_loss32)))

    def one():
        nonlocal state
        b = TS.local_batch(next(run.data), mesh)
        state, m = run.step(state, b)
        return float(m["loss"])             # waits for the step

    runs = timed_runs(one, conf["timed"]) if conf["timed"] else []
    ckpt = (mesh_checkpoint_save(ctx, run, cfg, tcfg, state, ckdir)
            if ckdir is not None else None)
    coll_ms = {k: v * 1e3 for k, v in coll_s.items()}
    launches.read()
    return {"rank": ctx.rank, "stream": digest(
                torch.from_numpy(run.data.stream)),
            "stream_tokens": int(run.data.stream.shape[0]),
            "prepare_launches": prep, "exchanges": exchanges,
            "launches": launches.total, "loss": loss, "grad_norm": gnorm,
            "agree": agree, "step_counts": step_counts,
            "collective_ms": coll_ms,
            "runs_s": runs, "setup_s": setup_s, "grads_s": grads_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "checkpoint": ckpt, "seconds": time.perf_counter() - t_start}


def mesh_restore_leg(ranks: list, ckdir: str, name: str, conf: dict,
                     n_cards: int) -> dict:
    """Phase 30 (a)'s restore: a second spawn of ranks on
    :data:`RESTORE_DIMS` restores the 2x2 checkpoint (NCCL with a card a
    rank where enough cards exist, else gloo on card 0); every block
    must hash as ``shard_tensor`` of the saved leaf, and the float32
    step's loss must be the 2x2 step's on the same state and batch."""
    from repro_torch.launch.mesh import run_ranks

    world = int(np.prod(RESTORE_DIMS))
    backend = "nccl" if n_cards >= world else "gloo"
    t0 = time.perf_counter()
    got = run_ranks(mesh_restore_rank, world, backend, "cuda",
                    args=(ckdir, conf), timeout_s=MESH_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    saved = [r["checkpoint"] for r in ranks]
    loss = saved[0]["loss_f32"]
    want = [{k: v for r in saved for k, v in r["want"][j].items()}
            for j in range(world)]
    check(all(r["loss_f32"] == loss for r in saved),
          f"{name}: the 2x2 float32 step's loss is the same on every rank")
    rels = []
    for r, m in zip(got, restore_meshes()):
        check(r["coords"] == m.coords, f"{name} restore rank {r['rank']}: "
              f"coordinates {r['coords']}")
        check(r["got"] == want[r["rank"]], f"{name} restore rank "
              f"{r['rank']}: every restored block's digest is that of "
              f"shard_tensor of the gathered leaf")
        rels.append(abs(r["loss_f32"] - loss) / abs(loss))
        check(rels[-1] <= MESH_LOSS_F32_REL, f"{name} restore rank "
              f"{r['rank']}: float32 step loss {r['loss_f32']} against the "
              f"2x2 step's {loss} (rel {rels[-1]})")
    nbytes, save_s = saved[0]["bytes"], [r["save_s"] for r in saved]
    return {"mesh": "x".join(map(str, RESTORE_DIMS)), "backend": backend,
            "bytes": nbytes, "leaves": len(want[0]), "save_s": save_s,
            "save_gb_s": nbytes / max(save_s) / 1e9,
            "restore_s": [r["restore_s"] for r in got],
            "restore_gb_s": [r["block_bytes"] / r["restore_s"] / 1e9
                             for r in got],
            "loss_f32_2x2": loss,
            "loss_f32_restored": [r["loss_f32"] for r in got],
            "loss_f32_rel": max(rels),
            "f32_s": {"2x2_forward": [r["f32_loss_s"] for r in saved],
                      "restored_step": [r["f32_step_s"] for r in got]},
            "restore_rank_seconds": [r["seconds"] for r in got],
            "seconds": seconds}


def mesh_train_phase(seed: int, launches) -> None:
    """Phase 30: the launcher's mesh path on 4 ranks (NCCL with a card a
    rank where 4 cards exist, else gloo with every rank on card 0) for
    each of :data:`MESH_TRAIN`: prints a ``mesh_train`` line a config,
    then holds each step against the one-card step."""
    from repro_torch.core import HPTMTContext
    from repro_torch.data import pipeline as TP
    from repro_torch.launch.mesh import run_ranks

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= MESH_WORLD else "gloo"
    lines, checks = [], []
    for name, conf in MESH_TRAIN.items():
        t0 = time.perf_counter()
        cfg = mesh_cfg(conf)
        ccfg = mesh_corpus(cfg, conf)
        # the same pipeline on the data axis's shard count, one card
        ctx2 = HPTMTContext(n_shards=MESH_DIMS[0], device="cuda")
        want = TP.preprocess(TP.synthetic_corpus(ccfg, ctx2), ccfg, ctx2)
        want = digest(torch.from_numpy(want))
        torch.cuda.empty_cache()
        restored = None
        with tempfile.TemporaryDirectory(prefix="hptmt_ckpt_") as ckdir:
            ranks = run_ranks(
                mesh_train_rank, MESH_WORLD, backend, "cuda",
                args=(seed, name, conf,
                      ckdir if conf["checkpoint"] else None),
                timeout_s=MESH_TIMEOUT_S)
            if conf["checkpoint"]:
                torch.cuda.empty_cache()
                restored = mesh_restore_leg(ranks, ckdir, name, conf,
                                            n_cards)
        seconds = time.perf_counter() - t0
        agree = ranks[0]["agree"]
        print(f"  {name} sharded step vs one card: {agree}", flush=True)
        checks.append((name, cfg, agree))
        for r in ranks:
            check(r["stream"] == want, f"{name} rank {r['rank']}: the "
                  f"curated stream is the 2-shard pipeline's, bit for bit")
            check(r["loss"] == ranks[0]["loss"]
                  and r["grad_norm"] == ranks[0]["grad_norm"],
                  f"{name} rank {r['rank']}: the same loss and grad norm")
            for k in ("hash_partition", "probe"):
                check(r["prepare_launches"][k] > 0,
                      f"{name} rank {r['rank']} launched {k}")
            for k, n in r["launches"].items():
                launches.total[k] += n
        check(ranks[0]["step_counts"].get("all_reduce/model", 0) > 0
              and ranks[0]["step_counts"].get("all_gather/data", 0) > 0,
              f"{name}: the step ran tensor parallel and FSDP: "
              f"{ranks[0]['step_counts']}")
        runs = ranks[0]["runs_s"]
        step_s = statistics.median(runs) if runs else None
        tokens = conf["batch"] * conf["seq"]
        lines.append({
            "config": name, "arch": conf["arch"], "layers": cfg.n_layers,
            "params": cfg.param_count(), "backend": backend,
            "world": MESH_WORLD, "cards": min(MESH_WORLD, n_cards),
            "mesh": "x".join(map(str, MESH_DIMS)), "batch": conf["batch"],
            "seq": conf["seq"], "loss": ranks[0]["loss"],
            "grad_norm": ranks[0]["grad_norm"], "vs_one_card": agree,
            "step_ms": None if step_s is None else step_s * 1e3,
            "runs_ms": [r * 1e3 for r in runs],
            "tokens_per_s": None if step_s is None else tokens / step_s,
            "peak_gib": [r["peak_gib"] for r in ranks],
            "step_collectives": ranks[0]["step_counts"],
            "collective_ms": [r["collective_ms"] for r in ranks],
            "stream_tokens": ranks[0]["stream_tokens"],
            "prepare_launches": [r["prepare_launches"] for r in ranks],
            "exchanges": ranks[0]["exchanges"],
            "setup_s": [r["setup_s"] for r in ranks],
            "checked_grads_s": [r["grads_s"] for r in ranks],
            "rank_seconds": [r["seconds"] for r in ranks],
            "checkpoint": restored, "seconds": seconds})
        torch.cuda.empty_cache()
    for line in lines:
        emit("mesh_train", **line)
    for name, cfg, agree in checks:
        if cfg.dtype == "float32":
            limits = MOE_MESH_LIMITS
        else:
            limits = {k: BF16_VS_F32[k] for k in
                      ("leaf_rel_l2", "leaf_of_max", "norm_rel")}
            limits.update(loss_f32_rel=MESH_LOSS_F32_REL,
                          loss_rel=agree["bf16_loss_gap"])
        for key, limit in limits.items():
            check(agree[key] <= limit, f"{name}: sharded step vs one "
                  f"card {key} {agree[key]} within {limit}")


# ---------------------------------------------------------------------------
# phase 31: serving across ranks — the reference's prefill and decode cells
# ---------------------------------------------------------------------------
SERVE_WORLD = 4
SERVE_TIMEOUT_S = 900
#: (a) deepseek-67b at full width, 10 of 95 layers as phase 28, heads
#: split over a 1x4 mesh (16/2 heads, d_ff 5504 and vocab 25,600 a rank),
#: bf16 at phase 28's serve shape, held against phase 28's logits, its
#: generation cut to 8 tokens; (b) smollm-360m whole on 2x2 (15/5 heads
#: do not split: replicated attention, the sequence-sharded cache), bf16
#: logits against phase 9's, its generation cut to 2 tokens (~420 gloo
#: calls, 1.6-6 s, a token on one card), then float32 at ``SERVE_F32``'s
#: prompts; (c) qwen2-moe-a2.7b at published widths, 2 of 24 layers as
#: phase 30, EP over model on 2x2, float32 only.  In float32 the greedy
#: tokens (``MESH_F32_GEN`` of them: the time limit) and every cache leaf
#: are held against the one-card run of the same seed.
MESH_SERVE = {
    "deepseek": {"arch": "deepseek-67b", "layers": 10, "dims": (1, 4),
                 "gen": 8, "f32": False},
    "smollm": {"arch": "smollm-360m", "layers": None, "dims": (2, 2),
               "gen": 2, "f32": True},
    "qwen2_moe": {"arch": "qwen2-moe-a2.7b", "layers": 2, "dims": (2, 2),
                  "gen": None, "f32": True},
}
MESH_F32_GEN = 4
#: a float32 cache leaf, and (b)'s float32 last logits at phase 9's
#: serve shape, on the mesh against one card's, of the largest magnitude
#: (the TP all-reduces add partials in another order)
MESH_CACHE_F32 = 1e-5
#: bf16 last logits on the mesh against one card's, of the largest: (a)
#: has no float32 yardstick (its float32 weights alone are 34 GB), so it
#: is held to phase 2's bf16 tolerance; (b)'s bf16 logits are held within
#: this multiple of the larger of the two runs' own bf16-vs-float32 gaps
#: on the same prompts (phase 30's rule for its bf16 loss): on an H100
#: (700 W) they read 0.0214 against phase 9's where one card's own
#: bf16-vs-float32 gap was 0.0267 — the MLP's TP all-reduce adds rounded
#: bf16 partials, as the reference's psum does
MESH_LOGITS_BF16 = 2e-2
MESH_BF16_GAPS = 3.0


def mesh_serve_cfg(conf):
    from repro_torch.configs import get_config

    cfg = get_config(conf["arch"])
    if conf["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=conf["layers"])
    return cfg


def serve_prompts(cfg, seed: int):
    """Phases 8-9's prompts (``serve_phase`` draws them so)."""
    rng = np.random.default_rng(seed + 2)
    return rng.integers(1, cfg.vocab_size, (SERVE["batch"], SERVE["prompt"]),
                        dtype=np.int32)


def host_cache(cache) -> list:
    """Host copies of a cache's leaves (the cache is updated in place)."""
    return [{k: v.to("cpu", copy=True).numpy() if torch.is_tensor(v) else v
             for k, v in layer.items()} for layer in cache]


def greedy_run(model, toks, cache_len: int, steps: int, keep) -> dict:
    """A prefill of ``toks`` and ``steps`` greedy decode steps of
    ``model`` (under the caller's binding): the prefill's last logits,
    the tokens, ``keep`` of the cache after the prefill and after the
    last step, the MoE metrics of the prefill and the first step."""
    from repro_torch.serve.engine import sample

    s, v = toks.shape[1], model.cfg.vocab_size
    with torch.inference_mode():
        logits, cache, aux_p = model(toks, mode="prefill",
                                     cache_len=cache_len,
                                     last_logit_only=True)
        first = keep(cache)
        out, aux_d = [sample(logits[:, -1], vocab_size=v)], None
        for t in range(steps):
            lg, cache, aux = model(out[-1], mode="decode", cache=cache,
                                   positions=torch.tensor(
                                       [s + t], dtype=torch.int32,
                                       device=toks.device))
            aux_d = aux if aux_d is None else aux_d
            out.append(sample(lg[:, -1], vocab_size=v))
    return {"logits": logits[:, -1], "tokens": torch.cat(out, 1),
            "caches": (first, keep(cache)), "aux": (aux_p, aux_d)}


def serve_logits(model, prompts) -> torch.Tensor:
    """A prefill's last logits at phase 8-9's serve shape (under the
    caller's binding: this rank's rows and vocab block)."""
    with torch.inference_mode():
        logits, _, _ = model(prompts, mode="prefill",
                             cache_len=prompts.shape[1],
                             last_logit_only=True)
    return logits[:, -1]


def one_card_f32(conf, seed: int, dev) -> dict:
    """Phase 31's float32 yardstick: the one-card model of the same seed
    at ``SERVE_F32`` (tokens and caches on the host), and where the config
    also serves in bf16 its last logits at the serve shape."""
    from repro_torch.models.transformer import LM

    f = SERVE_F32
    cfg = dataclasses.replace(mesh_serve_cfg(conf), dtype="float32")
    model = LM(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    prompts = serve_prompts(cfg, seed)
    run = greedy_run(model, torch.as_tensor(
        prompts[:f["batch"], :f["prompt"]], device=dev),
        f["prompt"] + MESH_F32_GEN + 8, MESH_F32_GEN - 1, host_cache)
    out = {"tokens": run["tokens"].cpu().numpy(), "caches": run["caches"]}
    if conf["gen"]:
        out["logits"] = serve_logits(model, torch.as_tensor(
            prompts, device=dev)).cpu()
    del model, run
    torch.cuda.empty_cache()
    return out


def whole_logits(cell, logits) -> np.ndarray:
    """Every rank's rows and vocab blocks of ``logits``, on the host."""
    from repro_torch.core import array_ops
    from repro_torch.sharding import partition

    with cell.binding():
        if logits.shape[-1] != cell.cfg.vocab_size:
            logits = array_ops.axis_all_gather(logits, cell.mesh, "model",
                                               -1)
        return partition.gather_rows(logits, cell.mesh).float().cpu().numpy()


def mesh_serve_bf16(cfg, conf, mesh, dev, seed: int, launches) -> dict:
    """(a), (b): bf16 at phase 28's serve shape on this rank's blocks —
    the checked prefill (every flash launch held against ``attend``), one
    decode step with its collectives timed (each synchronized) and one
    without, then a timed prefill and a generate of ``conf["gen"]``."""
    from repro_torch.configs import ShapeCell
    from repro_torch.core import array_ops
    from repro_torch.launch.cells import serve_cell
    from repro_torch.serve.engine import Engine, ServeConfig, sample

    b, s, n = SERVE["batch"], SERVE["prompt"], conf["gen"]
    prompts = serve_prompts(cfg, seed)
    cell = serve_cell(cfg, ShapeCell("serve", s + n + 8, b, "prefill"), mesh,
                      seed, dev)
    with cell.binding():
        engine = Engine(cell.model, ServeConfig(max_len=s + n + 8))
    n_flash = flash_layers(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    with FlashTap() as tap:
        logits, cache = engine.prefill(prompts)
        torch.cuda.synchronize()
    counts, _ = launches.read()
    instances = {k: c.n for k, c in launches.flash_instances.items()}
    check(counts["flash_attention"] == n_flash
          and instances == {"wgmma": n_flash, "simt": 0},
          f"{cfg.name}: {counts['flash_attention']} flash launches a rank "
          f"({instances}), expected {n_flash} on the tensor-core kernel")
    check(tap.layers == n_flash and not tap.bad,
          f"{cfg.name}: flash against plain attend in {tap.layers} layers, "
          f"outside 2e-2: {tap.bad}")
    out = {"logits": whole_logits(cell, logits), "launches": counts,
           "flash_instances": instances,
           "flash_shape": tap.shape,
           "flash_vs_attend_max_abs_err": tap.max_abs_err}
    with cell.binding(), torch.inference_mode():
        tok = sample(logits, vocab_size=cfg.vocab_size)
    pos = torch.tensor([s], dtype=torch.int32, device=dev)
    coll = array_ops.MODEL_COLLECTIVES
    coll.reset()
    coll.timed = True
    try:
        t0 = time.perf_counter()
        cell.decode(cache, tok, pos)
        torch.cuda.synchronize()
        out["decode_step_timed_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        coll.timed = False
    out["step_collectives"] = dict(coll.counts)
    out["collective_ms"] = {k: v * 1e3 for k, v in coll.seconds.items()}
    t0 = time.perf_counter()
    cell.decode(cache, tok, pos)        # the same slot again, untimed
    torch.cuda.synchronize()
    out["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
    del cache, logits, tok

    def prefill():
        engine.prefill(prompts)
        torch.cuda.synchronize()

    launches.reset()
    pre = timed_runs(prefill, 1)[0]
    t0 = time.perf_counter()
    out["tokens"] = engine.generate(prompts, n)
    gen = time.perf_counter() - t0
    launches.read()
    out.update(prefill_ms=pre * 1e3, generate_s=gen,
               decode_ms_per_token=(gen - pre) / (n - 1) * 1e3,
               tokens_per_s=b * n / gen,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del engine, cell
    torch.cuda.empty_cache()
    return out


def mesh_serve_f32(cfg, conf, mesh, dev, seed: int, launches) -> dict:
    """(b), (c): float32 at ``SERVE_F32`` on this rank's blocks: greedy
    tokens, the gathered caches after the prefill and the last step, the
    MoE dropped fractions; where the config also serves in bf16, the
    last logits at the serve shape."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch.cells import serve_cell
    from repro_torch.sharding import partition

    f = SERVE_F32
    cfg = dataclasses.replace(cfg, dtype="float32")
    small = serve_prompts(cfg, seed)[:f["batch"], :f["prompt"]]
    cache_len = f["prompt"] + MESH_F32_GEN + 8
    cell = serve_cell(cfg, ShapeCell("serve_f32", cache_len, f["batch"],
                                     "prefill"), mesh, seed, dev)
    launches.reset()
    with cell.binding():
        run = greedy_run(cell.model, cell.rows(torch.as_tensor(
            small, device=dev)), cache_len, MESH_F32_GEN - 1,
            lambda c: host_cache(cell.gather_cache(c)))
        tokens = partition.gather_rows(run["tokens"], mesh).cpu().numpy()
    counts, _ = launches.read()
    simt = launches.flash_instances["simt"].n
    check(simt == flash_layers(cfg) == counts["flash_attention"],
          f"{cfg.name}: the float32 prefill ran {simt} SIMT flash launches "
          f"a rank, expected {flash_layers(cfg)}")
    out = {"tokens": tokens, "caches": run["caches"], "flash_launches": simt}
    if conf["gen"]:
        launches.reset()
        with cell.binding():
            out["logits"] = whole_logits(cell, serve_logits(
                cell.model, cell.rows(torch.as_tensor(
                    serve_prompts(cfg, seed), device=dev))))
        launches.read()
    if cfg.is_moe:
        n_moe = sum(type(ly.ffn).__name__ == "MoE" for ly in cell.model.layers)
        out["moe_dropped_frac"] = {
            k: float(aux["moe_dropped_frac"]) / n_moe
            for k, aux in zip(("prefill", "decode"), run["aux"])}
    del cell, run
    torch.cuda.empty_cache()
    return out


def mesh_serve_rank(ctx, seed: int) -> dict:
    """One rank of phase 31: each config of :data:`MESH_SERVE` on its
    mesh of the world's ranks (``launch/mesh.py:mesh_context``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import mesh_context

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, rank = ctx.device, dist.get_rank()
    launches = Launches()
    meshes, out = {}, {"rank": rank}
    for name, conf in MESH_SERVE.items():
        t0 = time.perf_counter()
        dims = conf["dims"]
        if dims not in meshes:
            meshes[dims] = mesh_context(dims, ("data", "model"))
        cfg = mesh_serve_cfg(conf)
        res = {}
        if conf["gen"]:
            res["bf16"] = mesh_serve_bf16(cfg, conf, meshes[dims], dev, seed,
                                          launches)
        if conf["f32"]:
            res["f32"] = mesh_serve_f32(cfg, conf, meshes[dims], dev, seed,
                                        launches)
        res["seconds"] = time.perf_counter() - t0
        if rank:        # the gathered arrays come back from rank 0 only
            for part in ("bf16", "f32"):
                for key in ("logits", "caches"):
                    res.get(part, {}).pop(key, None)
        out[name] = res
    out["launches"] = launches.total
    return out


def check_caches_f32(got, want, tag: str) -> float:
    """The mesh's gathered float32 cache against one card's: ``pos`` and
    ``cursor`` exactly, K/V to :data:`MESH_CACHE_F32` of the largest;
    returns the largest such ratio."""
    worst = 0.0
    check(len(got) == len(want), f"{tag}: layers")
    for j, (g, w) in enumerate(zip(got, want)):
        check(g["cursor"] == w["cursor"]
              and np.array_equal(g["pos"], w["pos"]),
              f"{tag} layer {j}: cursor and pos")
        for name in ("k", "v"):
            check(g[name].shape == w[name].shape, f"{tag} layer {j} {name}")
            rel = float(np.abs(g[name] - w[name]).max()
                        / max(np.abs(w[name]).max(), 1e-30))
            worst = max(worst, rel)
    check(worst <= MESH_CACHE_F32, f"{tag}: cache K/V {worst} of the "
          f"largest, limit {MESH_CACHE_F32}")
    return worst


def mesh_serve_phase(dev, seed: int, launches, yard: dict) -> None:
    """Phase 31: :data:`MESH_SERVE` on 4 ranks (NCCL with a card a rank
    where 4 cards exist, else gloo with every rank on card 0), held
    against the one-card runs: ``yard`` holds phases 9 and 28's last
    logits by config; the float32 runs are made here first."""
    from repro_torch.launch.mesh import run_ranks

    t_start = time.perf_counter()
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= SERVE_WORLD else "gloo"
    ref32 = {name: one_card_f32(conf, seed, dev)
             for name, conf in MESH_SERVE.items() if conf["f32"]}
    torch.cuda.empty_cache()
    ranks = run_ranks(mesh_serve_rank, SERVE_WORLD, backend, "cuda",
                      args=(seed,), timeout_s=SERVE_TIMEOUT_S)
    for r in ranks:
        for k, n in r["launches"].items():
            launches.total[k] += n
    for name, conf in MESH_SERVE.items():
        r0 = ranks[0][name]
        line = {"config": name, "arch": conf["arch"],
                "layers": mesh_serve_cfg(conf).n_layers, "backend": backend,
                "world": SERVE_WORLD, "cards": min(SERVE_WORLD, n_cards),
                "mesh": "x".join(map(str, conf["dims"])),
                "rank_seconds": [r[name]["seconds"] for r in ranks]}
        if "bf16" in r0:
            bf = r0["bf16"]
            rel = rel_err(torch.from_numpy(bf["logits"]),
                          yard[name]["logits"])
            limit = MESH_LOGITS_BF16
            if "f32" in r0:
                one32 = ref32[name]["logits"]
                mesh32 = torch.from_numpy(r0["f32"]["logits"])
                gaps = (rel_err(yard[name]["logits"], one32),
                        rel_err(torch.from_numpy(bf["logits"]), mesh32))
                rel32 = rel_err(mesh32, one32)
                check(rel32 <= MESH_CACHE_F32, f"{name}: the mesh's float32 "
                      f"last logits {rel32} of the largest from one card's")
                limit = MESH_BF16_GAPS * max(gaps)
                line.update(logits_f32_rel_vs_one_card=rel32,
                            bf16_vs_f32_gaps=gaps)
            check(rel <= limit, f"{name}: the mesh's last logits {rel} of "
                  f"the largest from the one-card run's, limit {limit}")
            for r in ranks:
                check(np.array_equal(r[name]["bf16"]["tokens"], bf["tokens"]),
                      f"{name} rank {r['rank']}: the global tokens")
            line["bf16_tokens_equal_one_card"] = int(
                (bf["tokens"] == yard[name]["tokens"][:, :conf["gen"]]).sum())
            line.update(
                batch=SERVE["batch"], prompt=SERVE["prompt"],
                new_tokens=conf["gen"],
                logits_rel_vs_one_card=rel, logits_limit=limit,
                **{k: bf[k] for k in (
                    "prefill_ms", "decode_ms_per_token", "tokens_per_s",
                    "generate_s", "launches", "flash_instances",
                    "flash_vs_attend_max_abs_err", "flash_shape",
                    "decode_step_ms",
                    "decode_step_timed_ms", "step_collectives")},
                peak_gib=[r[name]["bf16"]["peak_gib"] for r in ranks],
                collective_ms=[r[name]["bf16"]["collective_ms"]
                               for r in ranks])
        if "f32" in r0:
            f32, want = r0["f32"], ref32[name]
            for r in ranks:
                check(np.array_equal(r[name]["f32"]["tokens"], want["tokens"]),
                      f"{name} rank {r['rank']}: float32 greedy tokens equal "
                      f"to the one-card run's")
            line["f32_tokens_equal"] = True
            line["f32_cache_rel"] = [
                check_caches_f32(g, w, f"{name} float32 {when}")
                for when, g, w in zip(("prefill", "last step"),
                                      f32["caches"], want["caches"])]
            line["f32_flash_launches"] = f32["flash_launches"]
            if "moe_dropped_frac" in f32:
                line["moe_dropped_frac"] = [r[name]["f32"]["moe_dropped_frac"]
                                            for r in ranks]
        emit("mesh_serve", **line)
    emit("mesh_serve_seconds", total=time.perf_counter() - t_start)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, "nvidia-smi reads the card")
    return r.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one run of each of phases 3-10, "
                    "of the re-entry path and of a train step")
    ap.add_argument("--crash-child", nargs=2, metavar=("DATASET", "STAGES"),
                    help="run as phase 17's child: the resume chain over "
                    "DATASET with stage checkpoints in STAGES, killed by its "
                    "armed fault")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    if args.crash_child:
        return crash_child(args.seed, *args.crash_child)
    from repro_torch.core import HPTMTContext
    from repro_torch.dataframe import DataFrame
    from repro_torch.kernels import native

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    # 1. build
    t0 = time.perf_counter()
    native.library(verbose=True)
    build_s, nvcc_s = time.perf_counter() - t0, native.build_seconds
    hgmma = sass_hgmma(native.build())
    sm90 = [f for f in hgmma if "flash_fwd_sm90" in f]
    check(len(sm90) == 3, f"HGMMA in every tensor-core flash instance: "
          f"{hgmma}")
    emit("build", seconds=build_s, nvcc_seconds=nvcc_s, hgmma=hgmma)

    left, right, sets = make_data(args.seed)
    oracle = make_oracle(left, right)

    # 2. kernels vs plain
    krows, scases = kernel_phase(left, right, dev)
    wrow, wcases = window_kernel_phase(dev)
    frow, fcases = flash_kernel_phase(dev)
    krows += [wrow, frow]
    for r in krows:
        emit("kernel", **r)
    for c in scases:
        emit("segment_kernel", **c)
    for c in wcases:
        emit("window_kernel", **c)
    for c in fcases:
        emit("flash_kernel", **c)

    launches = Launches()
    left_dev = {k: torch.from_numpy(v).to(dev) for k, v in left.items()}

    # 3. main path, 1 shard
    ctx1 = HPTMTContext(n_shards=1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res1 = main_path(DataFrame, ctx1, left, right, 1.0)
    counts3, ex3 = launches.read()
    paths3 = launches.paths()
    check(ex3 == 0, f"1 shard exchanges: {ex3}")
    check(paths3 == {"segment_reduce_fused": {"smem": 1, "direct": 1},
                     "segment_reduce": {"smem": 2, "direct": 0}},
          f"1 shard: the hash groupby on the smem path, the sort groupby's "
          f"sum direct: {paths3}")
    j1, g1 = check_main_path(res1, left_dev, oracle, "1 shard")
    peak3 = torch.cuda.max_memory_allocated() / 2**30
    del res1
    runs3 = timed_runs(lambda: main_path(DataFrame, ctx1, left, right, 1.0))
    if args.profile:
        profile_run("main_1shard",
                    lambda: main_path(DataFrame, ctx1, left, right, 1.0))
    emit("main_1shard", launches=counts3, segment_paths=paths3, exchanges=ex3,
         median_s=statistics.median(runs3), runs_s=runs3, peak_gib=peak3)

    # 4. the same data on 4 virtual shards
    ctx4 = HPTMTContext(n_shards=4, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res4 = main_path(DataFrame, ctx4, left, right, 2.0)
    counts4, ex4 = launches.read()
    paths4 = launches.paths()
    check(ex4 == 3, f"4 shard exchanges: {ex4} (join 2, groupby g 1, k 0)")
    # groupby g: a partial pass a shard (32768 slots x 3 lanes: two lane
    # chunks) and a merge a shard (8192 slots); groupby k: sort, direct
    check(paths4 == {"segment_reduce_fused": {"smem": 8, "direct": 4},
                     "segment_reduce": {"smem": 16, "direct": 0}},
          f"4 shards: segment paths {paths4}")
    check(counts4["hash_partition"] > 0, "4 shards launch hash_partition")
    j4, g4 = check_main_path(res4, left_dev, oracle, "4 shards")
    check(torch.equal(canonical(j1, sorted(j1)), canonical(j4, sorted(j4))),
          "4-shard join rows equal the 1-shard rows")
    for key in ("g", "v_count", "v_min", "v_max"):
        check(np.array_equal(g1[key], g4[key]), f"4-shard groupby {key}")
    peak4 = torch.cuda.max_memory_allocated() / 2**30
    ref_main = shard_prints(res4, 0)  # held against phase 29's groups
    del res4, j4
    runs4 = timed_runs(lambda: main_path(DataFrame, ctx4, left, right, 2.0))
    if args.profile:
        profile_run("main_4shards",
                    lambda: main_path(DataFrame, ctx4, left, right, 2.0))
    emit("main_4shards", launches=counts4, segment_paths=paths4,
         exchanges=ex4,
         median_s=statistics.median(runs4), runs_s=runs4, peak_gib=peak4)

    # 5. set ops, 4 shards
    launches.reset()
    res5 = set_ops(DataFrame, ctx4, sets)
    counts5, ex5 = launches.read()
    u = np.sort(res5["union"].to_numpy()["k"])
    check(np.array_equal(u, np.union1d(sets["a"], sets["b"])), "union")
    d = np.sort(res5["difference"].to_numpy()["k"])
    keep = sets["a"][~np.isin(sets["a"], sets["b"])]
    check(np.array_equal(d, np.sort(keep)), "difference rows")
    check(np.array_equal(np.unique(d), np.setdiff1d(sets["a"], sets["b"])),
          "difference vs setdiff1d")
    ref_setops = shard_prints(res5, 0)
    del res5
    runs5 = timed_runs(lambda: set_ops(DataFrame, ctx4, sets))
    if args.profile:
        profile_run("setops_4shards", lambda: set_ops(DataFrame, ctx4, sets))
    emit("setops_4shards", launches=counts5, exchanges=ex5,
         median_s=statistics.median(runs5), runs_s=runs5,
         union_rows=int(u.shape[0]), difference_rows=int(d.shape[0]))

    # 6. ordered analytics, 1 shard
    events = make_events(args.seed)
    ord_oracle = ordered_oracle(events)
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res6 = ordered_path(DataFrame, ctx1, events, 1.0, launches.sorts)
    counts6, ex6 = launches.read()
    check(ex6 == 0, f"ordered 1 shard exchanges: {ex6}")
    check(counts6["windowed_scan"] > 0, "ordered 1 shard launches "
          "windowed_scan")
    w1 = check_ordered(res6, ord_oracle, "ordered 1 shard")
    peak6 = torch.cuda.max_memory_allocated() / 2**30
    del res6
    runs6 = timed_runs(lambda: ordered_path(DataFrame, ctx1, events, 1.0,
                                            launches.sorts))
    if args.profile:
        profile_run("ordered_1shard", lambda: ordered_path(
            DataFrame, ctx1, events, 1.0, launches.sorts))
    emit("ordered_1shard", launches=counts6, exchanges=ex6,
         median_s=statistics.median(runs6), runs_s=runs6, peak_gib=peak6)

    # 7. the ordered chain on 4 virtual shards
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res7 = ordered_path(DataFrame, ctx4, events, 2.0, launches.sorts)
    counts7, ex7 = launches.read()
    check(ex7 == 2, f"ordered 4 shard exchanges: {ex7} (the two sorts)")
    check(counts7["windowed_scan"] > 0, "ordered 4 shards launch "
          "windowed_scan")
    check(res7["sv"].overflow_report.is_exact(), "4 shards sort exact")
    w4 = check_ordered(res7, ord_oracle, "ordered 4 shards")
    for name in ("roll", "cum"):
        for k, v in w1[name].items():
            if not k.endswith(("_sum", "_mean")):
                check(np.array_equal(v, w4[name][k]),
                      f"4-shard {name} {k} equals 1 shard")
    peak7 = torch.cuda.max_memory_allocated() / 2**30
    group_ref = {"main": ref_main, "setops": ref_setops, "right": right,
                 "ordered": shard_prints(res7, 0),
                 "exchanges": {"main": ex4, "setops": ex5, "ordered": ex7}}
    del res7, w1, w4, ref_main, ref_setops
    runs7 = timed_runs(lambda: ordered_path(DataFrame, ctx4, events, 2.0,
                                            launches.sorts))
    if args.profile:
        profile_run("ordered_4shards", lambda: ordered_path(
            DataFrame, ctx4, events, 2.0, launches.sorts))
    emit("ordered_4shards", launches=counts7, exchanges=ex7,
         median_s=statistics.median(runs7), runs_s=runs7, peak_gib=peak7)

    # 8./9. serving: phi3-mini-3.8b, then smollm-360m (phase 31's
    # yardstick)
    yard = {}
    for arch in ("phi3-mini-3.8b", "smollm-360m"):
        yard[arch.split("-")[0]] = serve_phase(arch, dev, args.seed, launches,
                                               args.profile, None, 1)

    # 10. the sort-merge join on the main path, 1 and 4 shards
    sort_join_phase(DataFrame, ctx1, ctx4, left, right, left_dev, oracle,
                    launches, j1, args.profile)

    # 11. cartesian product, 1 and 4 shards
    cartesian_phase(DataFrame, ctx1, ctx4, args.seed, dev, launches)

    # 12. storage: partitioned re-entry and pushdown, native .hpt
    storage = storage_phase(DataFrame, ctx1, ctx4, left, right, left_dev,
                            oracle, launches, args.profile)
    group_ref["storage"] = storage.pop("group_ref")
    for tag, fields in storage.items():
        emit(tag, **fields)
    del storage

    # 13. out of core: spilled join, groupby and window, 1 and 4 shards
    for tag, fields in spill_phase(DataFrame, ctx1, ctx4, left, args.seed,
                                   launches).items():
        emit(tag, **fields)
    del j1

    # 14. the lazy planner's chain against the eager chain, 4 then 1 shard
    for tag, fields in plan_phase(DataFrame, ctx1, ctx4, left, right,
                                  launches, args.profile).items():
        emit(tag, **fields)

    # 15. the TSet dataflow over the main and ordered cells, 1 and 4 shards
    t0 = time.perf_counter()
    tset = tset_phase(DataFrame, ctx1, ctx4, left, right, events, oracle,
                      ord_oracle, launches, args.profile)
    group_ref["tset"] = tset.pop("group_ref")
    for tag, fields in tset.items():
        emit(tag, **fields)
    del tset
    del ord_oracle, events
    new_s = {"tset": time.perf_counter() - t0}

    # 16./17. telemetry, then recovery and workflow, over one dataset
    with tempfile.TemporaryDirectory(prefix="hptmt_services_") as tmp:
        root = os.path.join(tmp, "left")
        DataFrame.from_dict(left, ctx4).to_hpt(root)
        t0 = time.perf_counter()
        for tag, fields in telemetry_phase(DataFrame, ctx1, ctx4, left,
                                           right, oracle, root, launches,
                                           args.profile).items():
            emit(tag, **fields)
        new_s["telemetry"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for tag, fields in recovery_phase(DataFrame, ctx4, left, right,
                                          oracle, root, args.seed, dev,
                                          launches).items():
            emit(tag, **fields)
        new_s["recovery"] = time.perf_counter() - t0
    emit("services_seconds", **new_s)

    # 18.-24. serving every other family: MoE, MLA, xLSTM, encoder-decoder,
    # then the configs cut in depth (MoE with a window, hybrid, VLM)
    family_s = {}
    for arch, depth, runs in FAMILIES:
        t0 = time.perf_counter()
        serve_phase(arch, dev, args.seed, launches, args.profile, depth,
                    runs)
        family_s[arch] = time.perf_counter() - t0
    emit("families_seconds", total=sum(family_s.values()), **family_s)

    # 25./26. training: train steps at full width, then the pipeline →
    # train → serve workflow
    train_s = {}
    t0 = time.perf_counter()
    emit("train_step", **train_phase(dev, args.seed, launches, args.profile))
    train_s["train_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    workflow = workflow_phase(dev, args.seed, launches)
    group_ref["corpus"] = {k: workflow[k] for k in
                           ("stream_digest", "exchanges", "preprocess_s")}
    emit("train_workflow", **workflow)
    del workflow
    train_s["workflow"] = time.perf_counter() - t0
    emit("train_seconds", total=sum(train_s.values()), **train_s)

    # 27. Table I collectives and the MDS composition, 1 and 4 shards
    array_s = {}
    t0 = time.perf_counter()
    for tag, fields in collectives_phase(dev, args.seed).items():
        emit("collective", case=tag, **fields)
    array_s["collectives"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    emit("mds", **mds_phase(dev, args.seed, launches))
    array_s["mds"] = time.perf_counter() - t0

    # 28. deepseek-67b served, cut in depth
    t0 = time.perf_counter()
    arch, depth, runs = DEEPSEEK
    yard["deepseek"] = serve_phase(arch, dev, args.seed, launches,
                                   args.profile, depth, runs)
    array_s["deepseek"] = time.perf_counter() - t0
    emit("array_seconds", total=sum(array_s.values()), **array_s)

    # 29. the table path on a process group: 1 rank (NCCL), then 4 ranks
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    for line in group_phase(group_ref, oracle, dev, args.seed, launches):
        emit("group", **line)
    del group_ref
    emit("group_seconds", total=time.perf_counter() - t0)

    # 30. training across ranks: the launcher's mesh path, 2x2 on 4 ranks
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh_train_phase(args.seed, launches)
    emit("mesh_train_seconds", total=time.perf_counter() - t0)

    # 31. serving across ranks: the prefill and decode cells on 4 ranks
    torch.cuda.empty_cache()
    mesh_serve_phase(dev, args.seed, launches, yard)
    del yard

    # 32. summary
    kernels = []
    for r in krows:
        name = r["name"]
        check(launches.total[name] > 0, f"main path launched {name}")
        src, replaces = SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches.total[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    emit("summary", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
